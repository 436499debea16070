"""Weight-only quantization helpers of the port (counterpart of the
reference's ``nn/quant/__init__.py``): the functional surface over the
layouts of ``ops/kernels/quant.py`` (int8 per out channel, int4 packed
two nibbles a byte per group along IN)."""
from __future__ import annotations

import torch

from ...ops.kernels import quant as _Q

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear"]


def _algo_dtype(algo):
    if algo in ("weight_only_int8", "int8"):
        return "int8"
    if algo in ("weight_only_int4", "int4"):
        return "int4"
    raise ValueError(
        f"unsupported weight-only algo {algo!r} "
        "(weight_only_int8 | weight_only_int4)")


def weight_quantize(x, algo="weight_only_int8", arch=None, group_size=-1):
    """Symmetric abs-max quantization of ``x`` [in, out]. int8: returns
    (int8 [in, out], float32 [out]); int4: (uint8 packed [in // 2, out],
    float32 [in // group_size, out]), ``group_size=-1`` one group."""
    if _algo_dtype(algo) == "int8":
        return _Q.quantize_int8(x)
    return _Q.quantize_int4(x, group_size)


def weight_dequantize(x, scale, algo="weight_only_int8", group_size=-1):
    """The float32 [in, out] weight of a :func:`weight_quantize` pair."""
    if _algo_dtype(algo) == "int8":
        return _Q.dequantize_int8(x, scale)
    return _Q.dequantize_int4(x, scale, group_size)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1):
    """``x @ dequant(weight) + bias`` with the weight kept as int8/int4
    (``ops.kernels.quant.weight_only_matmul``). An int8 weight without a
    scale is taken as its values (scale 1); int4 needs its scale."""
    if weight_scale is None:
        if weight_dtype != "int8":
            # the int4 scale's shape depends on group_size and sits on
            # the contraction axis: there is no identity to assume
            raise ValueError(
                "weight_only_linear: weight_scale is required for "
                f"weight_dtype={weight_dtype!r}")
        weight_scale = torch.ones(weight.shape[-1], dtype=torch.float32,
                                  device=weight.device)
    return _Q.weight_only_matmul(x, weight, weight_scale, bias=bias,
                                 weight_dtype=weight_dtype,
                                 group_size=group_size)
