"""Int8 KV-page helpers of the port (the KV half of the reference's
``ops/kernels/quant.py``; its weight-only helpers come with weight-only
serving).

Layout: pages store int8 codes, symmetric and zero-point-free, with a
per-page, per-head float32 scale sidecar ``(num_pages, kv_heads)`` beside
the pool (``incubate/nn/paged_cache.py``): a value is ``code * scale``.
The paged attention kernels dequantize right after they load a page.

The arithmetic is the reference's, in float32, so the same tokens give
the same codes bit for bit: the scale is ``absmax / 127``; a value
quantizes to ``round(kv / max(scale, 1e-20))`` rounded half to even
(``torch.round``, as ``jnp.round``), clipped to +-127.
"""
from __future__ import annotations

import torch

INT8_QMAX = 127.0


def quantize_kv(kv, scale):
    """Quantize token K/V slabs against a fixed per-head scale.

    kv: (..., KVH, D) float; scale: (..., KVH) float32 broadcastable over
    the leading axes. Returns int8 of kv's shape. The scale is floored
    at 1e-20, so a zero slab quantizes to zeros."""
    s = torch.clamp_min(scale, 1e-20)[..., None]
    q = torch.round(kv.float() / s)
    return torch.clamp(q, -INT8_QMAX, INT8_QMAX).to(torch.int8)


def dequantize_kv(q, scale):
    """int8 (..., KVH, D) + per-head scale (..., KVH) -> float32."""
    return q.float() * scale[..., None]


def kv_head_scale(kv, keep_leading=0):
    """Per-head abs-max scale of a K/V slab: the max of |kv| over every
    axis except the KVH axis (-2) and the first ``keep_leading`` batch
    axes, over 127.

    (P, KVH, D) -> (KVH,); with keep_leading=1, (B, KVH, D) -> (B, KVH)
    (one scale per written token per head)."""
    red = tuple(range(keep_leading, kv.dim() - 2)) + (kv.dim() - 1,)
    return torch.amax(kv.float().abs(), dim=red) / INT8_QMAX
