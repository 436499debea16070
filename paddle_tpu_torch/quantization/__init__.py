"""Quantization of the port (counterpart of the reference's
``quantization/``): the serving-side weight-only PTQ of ``ptq_llm.py``.
QAT, PTQ and the observers are not ported yet."""
from .ptq_llm import (  # noqa: F401
    DEFAULT_SKIP_PATTERNS,
    WeightOnlyLinear,
    quantize_for_serving,
)

__all__ = ["WeightOnlyLinear", "quantize_for_serving",
           "DEFAULT_SKIP_PATTERNS"]
