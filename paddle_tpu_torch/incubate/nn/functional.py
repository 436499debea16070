"""Incubating fused functionals of the port (counterpart of the
reference's ``incubate/nn/functional.py``); the fused linear
cross-entropy head and paged decode attention are ported."""
from __future__ import annotations

from ...ops.kernels.fused_loss import fused_linear_cross_entropy as _core
from .paged_cache import paged_attention  # noqa: F401


def fused_linear_cross_entropy(h, w, labels, ignore_index=-100,
                               chunk=4096, reduction="mean",
                               transpose_w=False, name=None):
    """Fused linear head + softmax cross-entropy, chunked over the vocab
    so the [tokens, vocab] logits never exist whole.

    h: [T, H] or [B, S, H]; w: [V, H] ([H, V] with transpose_w=True, the
    ColumnParallelLinear layout); labels: int [T] / [B, S]. This is the
    reference's single-replica branch; the vocab-parallel one (mp > 1)
    belongs to the distributed slice."""
    if transpose_w:
        w = w.t()
    return _core(h, w, labels, ignore_index=ignore_index, chunk=chunk,
                 reduction=reduction)
