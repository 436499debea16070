"""Post-training weight-only quantization for serving (counterpart of
the reference's ``quantization/ptq_llm.py``).

* :class:`WeightOnlyLinear` replaces a ``ColumnParallelLinear`` or
  ``RowParallelLinear`` for serving: it holds the quantized payload and
  its scales as buffers and runs ``nn.quant.weight_only_linear``;
* :func:`quantize_for_serving` abs-max-calibrates every matching linear
  of a model and swaps it in place, returning a byte-accounting report;
* ``models.convert.from_hf(..., weight_dtype="int8")`` loads the float
  checkpoint and then calls :func:`quantize_for_serving`.

Single replica only: a tensor-parallel linear (mp degree above 1) is
refused, as the reference refuses under an mp mesh.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.quant import weight_only_linear
from ..ops.kernels import quant as Q

__all__ = ["WeightOnlyLinear", "quantize_for_serving",
           "DEFAULT_SKIP_PATTERNS"]

# embeddings and the LM head stay in float: the embedding gather reads
# one row a token, and the head's error lands on the sampled distribution
DEFAULT_SKIP_PATTERNS = ("embed", "lm_head", "wte", "wpe", "shared")


class WeightOnlyLinear(nn.Module):
    """Serving linear with the weight kept as int8/int4. Buffers (they
    ride ``state_dict``): ``qweight``, int8 [in, out] or packed uint8
    [in // 2, out] for int4; ``weight_scale``, float32 [out] (int8) or
    [in // group_size, out] (int4); ``bias``, optional [out]."""

    def __init__(self, in_features, out_features, qweight, scale,
                 bias=None, weight_dtype="int8", group_size=-1):
        super().__init__()
        if weight_dtype not in ("int8", "int4"):
            raise ValueError(
                f"weight_dtype must be int8|int4, got {weight_dtype!r}")
        self._in_features = int(in_features)
        self._out_features = int(out_features)
        self.weight_dtype = weight_dtype
        self.group_size = int(group_size)
        self.register_buffer("qweight", qweight)
        self.register_buffer("weight_scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, layer, weight_dtype="int8", group_size=64):
        """Abs-max-quantizes ``layer.weight`` ([in, out]) into the
        serving replacement. An odd ``in_features`` cannot pack two rows
        a byte, so int4 falls back to int8 for that layer; a group that
        does not divide ``in_features`` becomes the whole axis."""
        w = layer.weight.detach()
        din, dout = int(w.shape[0]), int(w.shape[1])
        if weight_dtype == "int4" and din % 2:
            weight_dtype = "int8"
        if weight_dtype == "int8":
            q, s = Q.quantize_int8(w)
            group_size = -1
        else:
            if din % max(group_size, 1):
                group_size = din
            q, s = Q.quantize_int4(w, group_size)
        bias = getattr(layer, "bias", None)
        return cls(din, dout, q, s,
                   bias=None if bias is None else bias.detach(),
                   weight_dtype=weight_dtype, group_size=group_size)

    def forward(self, x):
        return weight_only_linear(
            x, self.qweight, bias=self.bias, weight_scale=self.weight_scale,
            weight_dtype=self.weight_dtype, group_size=self.group_size)

    def weight_nbytes(self) -> int:
        """Device bytes of the quantized payload and its scales."""
        return int(self.qweight.numel() * self.qweight.element_size()
                   + self.weight_scale.numel()
                   * self.weight_scale.element_size())

    def extra_repr(self):
        g = f", group_size={self.group_size}" \
            if self.weight_dtype == "int4" else ""
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}, "
                f"weight_dtype={self.weight_dtype}{g}")


def _linear_types():
    from ..distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear,
        RowParallelLinear,
    )

    return (ColumnParallelLinear, RowParallelLinear)


@torch.no_grad()
def quantize_for_serving(model, weight_dtype="int8", group_size=64,
                         skip_patterns=DEFAULT_SKIP_PATTERNS):
    """Swaps every linear whose path holds none of ``skip_patterns`` for
    a :class:`WeightOnlyLinear`, in place (the float weights go). Layers
    already swapped are left as they are. Returns ``{"layers",
    "fp_bytes", "quant_bytes", "weight_dtype", "group_size", "paths"}``;
    raises ``ValueError`` when nothing matches."""
    lin_types = _linear_types()
    report = {"layers": 0, "fp_bytes": 0, "quant_bytes": 0,
              "weight_dtype": weight_dtype, "group_size": group_size,
              "paths": []}

    def visit(layer, prefix=""):
        for name, child in list(layer.named_children()):
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(child, lin_types):
                if any(pat in path for pat in skip_patterns):
                    continue
                if getattr(child, "mp_degree", 1) > 1:
                    raise NotImplementedError(
                        "quantize_for_serving: tensor-parallel (mp>1) "
                        "linears carry collective semantics the "
                        "weight-only swap drops; serve mp=1")
                wol = WeightOnlyLinear.from_linear(
                    child, weight_dtype=weight_dtype,
                    group_size=group_size)
                w = child.weight
                report["fp_bytes"] += int(w.numel() * w.element_size())
                report["quant_bytes"] += wol.weight_nbytes()
                report["layers"] += 1
                report["paths"].append(path)
                setattr(layer, name, wol)
            elif not isinstance(child, WeightOnlyLinear):
                visit(child, path)

    visit(model)
    if not report["layers"]:
        raise ValueError(
            "quantize_for_serving: no quantizable linears found "
            f"(skip_patterns={skip_patterns!r})")
    return report
