"""Attention functionals of the port (counterpart of the reference's
``nn/functional/flash_attention.py``), backed by the flash-attention
CUDA kernels, dense and packed varlen (the plain versions for CPU
tensors)."""
from __future__ import annotations

from ...ops.kernels.flash_attention import flash_attention as _flash
from ...ops.kernels.flash_varlen import varlen_attention as _varlen


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


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen (packed) attention. query: [total_q, num_heads, head_dim],
    sequences packed along dim 0 with boundaries ``cu_seqlens_q`` (int,
    [batch + 1]); key/value likewise with ``cu_seqlens_k``. Tokens never
    attend across sequence boundaries; ``causal`` masks within each
    sequence, top-left aligned. One route: the varlen kernels (whose
    tiles skip what no segment reaches) for CUDA tensors, the plain
    segment-by-segment version for CPU tensors; any total is taken.
    ``max_seqlen_*`` are accepted and not needed. Returns ``(out,
    None)``. Attention dropout is not ported and raises."""
    if dropout and training:
        raise NotImplementedError(
            "flash_attn_unpadded: attention dropout is not ported")
    return _varlen(query, key, value, cu_seqlens_q, cu_seqlens_k, causal,
                   scale), None


# the reference's alias (upstream exposes both names)
flash_attn_varlen_func = flash_attn_unpadded
