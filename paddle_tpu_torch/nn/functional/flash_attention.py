"""Attention functionals of the port (counterpart of the reference's
``nn/functional/flash_attention.py``), backed by the flash-attention
CUDA kernels (the plain versions for CPU tensors)."""
from __future__ import annotations

from ...ops.kernels.flash_attention import flash_attention as _flash


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, window=0, name=None):
    """q/k/v: [batch, seq, num_heads, head_dim] (the reference layout).
    ``window`` > 0 (with causal): the sliding band, out-of-band tiles
    skipped. Returns ``(out, None)``. Attention dropout is not ported
    and raises."""
    if dropout and training:
        raise NotImplementedError(
            "flash_attention: attention dropout is not ported")
    return _flash(query, key, value, causal=causal, window=window), None
