"""Optimizers of the port (counterpart of the reference's
``optimizer/``): ``AdamW`` with float32 master weights, and the LR
schedulers of ``optimizer.lr``. The other optimizers are not ported
yet."""
from . import lr  # noqa: F401
from .adamw import AdamW  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
