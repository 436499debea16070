"""Quantization helpers of the port (the counterpart of the
reference's ``ops/kernels/quant.py``): weight-only int8/int4 weights and
int8 KV pages. All layouts are symmetric and zero-point-free (abs-max).

* int8 weights: ``q[in, out] int8`` and ``scale[out] float32`` per OUT
  channel (``w ~ q * scale``). The scale applies after the contraction:
  ``(x @ q) * scale``.
* int4 weights: two nibbles a byte along the IN axis, ``packed[in // 2,
  out] uint8`` whose row ``i`` holds logical rows ``2i`` (low nibble) and
  ``2i + 1`` (high nibble), and per-GROUP scales ``scale[in //
  group_size, out] float32`` (groups along IN). The scale varies along
  the contraction axis, so int4 dequantizes to float32 first.
* int8 KV pages: int8 codes with a per-page, per-head float32 scale
  sidecar ``(num_pages, kv_heads)`` beside the pool
  (``incubate/nn/paged_cache.py``): a value is ``code * scale``. The
  paged attention kernels dequantize right after they load a page.

The arithmetic is the reference's, in float32, so the same inputs give
the same codes and scales bit for bit: a scale is ``absmax / qmax``
(floored at 1e-9 for weights); a value quantizes to ``round(w / scale)``
rounded half to even (``torch.round``, as ``jnp.round``), clipped to
+-qmax. ``weight_only_matmul`` is plain torch (``torch.matmul``), as the
reference's is XLA outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib

import torch

INT8_QMAX = 127.0
INT4_QMAX = 7.0


def _abs_max_scale(wf, dim, qmax):
    """``max(|wf|, dim) / qmax`` floored at 1e-9, by a true float32
    division on every device (over a Python number, a CUDA division
    multiplies by its reciprocal instead, which moves some scales, and
    then some codes, off the reference's)."""
    amax = torch.amax(wf.abs(), dim=dim)
    qmax = torch.tensor(qmax, dtype=amax.dtype, device=amax.device)
    return torch.clamp_min(amax / qmax, 1e-9)


# -- int8 per-channel weights --------------------------------------------

def quantize_int8(w):
    """Symmetric per-out-channel int8: w[in, out] -> (q int8, scale[out]
    float32), scale = absmax / 127 floored at 1e-9, q = round(w / scale)
    clipped to +-127."""
    wf = w.float()
    scale = _abs_max_scale(wf, 0, INT8_QMAX)
    q = torch.clamp(torch.round(wf / scale[None, :]), -INT8_QMAX,
                    INT8_QMAX)
    return q.to(torch.int8), scale


def dequantize_int8(q, scale):
    return q.float() * scale[None, :]


# -- int4 per-group weights (two nibbles a byte) -------------------------

def pack_int4(q):
    """Packs int8 values in [-8, 7] two a byte along axis 0: q[in, out]
    (in even) -> packed[in // 2, out] uint8, row i holding logical rows
    2i (low nibble) and 2i + 1 (high nibble)."""
    qu = q.to(torch.uint8)  # two's complement wrap keeps the nibble
    lo = qu[0::2] & 0xF
    hi = (qu[1::2] & 0xF) << 4
    return hi | lo


def unpack_int4(packed):
    """Inverse of :func:`pack_int4`: uint8[n, out] -> int8[2n, out] with
    each nibble sign-extended."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    n, out = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * n, out)


def quantize_int4(w, group_size=64):
    """Symmetric per-group int4: w[in, out] -> (packed[in // 2, out]
    uint8, scale[in // group_size, out] float32). Groups run along IN;
    ``in`` must divide by ``group_size``, and ``group_size`` by 2 (a
    ``group_size`` <= 0 is the whole axis)."""
    din, dout = w.shape
    if group_size <= 0:
        group_size = din
    if din % group_size or group_size % 2:
        raise ValueError(
            f"int4 group quant: in-features {din} must divide by an "
            f"even group_size (got {group_size})")
    wf = w.float().reshape(din // group_size, group_size, dout)
    scale = _abs_max_scale(wf, 1, INT4_QMAX)
    q = torch.clamp(torch.round(wf / scale[:, None, :]), -INT4_QMAX,
                    INT4_QMAX)
    return pack_int4(q.reshape(din, dout).to(torch.int8)), scale


def dequantize_int4(packed, scale, group_size=64):
    """packed[in // 2, out] + scale[G, out] -> float32[in, out]."""
    q = unpack_int4(packed)
    din, dout = q.shape
    if group_size <= 0:
        group_size = din
    wf = q.float().reshape(din // group_size, group_size, dout)
    return (wf * scale[:, None, :]).reshape(din, dout)


# -- the weight-only contraction -----------------------------------------

# the profiler ranges weight_only_matmul opens while the profiler records:
# the weight's float32 copy and the input's cast; the float32 GEMM; the
# int8 scale, the bias and the cast back
WEIGHT_ONLY_RANGES = ("weight_only.dequantize", "weight_only.gemm",
                      "weight_only.epilogue")


def _profiler_range(name):
    """A ``record_function`` range named ``name`` while the profiler
    records, else nothing (a range costs a dispatcher call even when no
    profiler listens)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def weight_only_matmul(x, qweight, scale, bias=None, weight_dtype="int8",
                       group_size=-1):
    """``x @ dequant(qweight) + bias`` in float32, cast back to
    ``x.dtype``. int8 applies the per-out-channel scale after the
    contraction (``(x @ q) * scale``); int4 dequantizes per group first
    (its scale varies along the contraction axis). Under the profiler its
    three steps are the WEIGHT_ONLY_RANGES ranges."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(
            f"weight_only_matmul: weight_dtype must be int8|int4, "
            f"got {weight_dtype!r}")
    dequantize, gemm, epilogue = WEIGHT_ONLY_RANGES
    with _profiler_range(dequantize):
        xf2 = x.float().reshape(-1, x.shape[-1])
        w = qweight.float() if weight_dtype == "int8" else \
            dequantize_int4(qweight, scale, group_size)
    with _profiler_range(gemm):
        out = torch.matmul(xf2, w)
    with _profiler_range(epilogue):
        if weight_dtype == "int8":
            out = out * scale[None, :]
        if bias is not None:
            out = out + bias
        return out.reshape(*x.shape[:-1], out.shape[-1]).to(x.dtype)


def weight_only_matmul_reference(x, w, weight_dtype="int8", group_size=-1):
    """numpy oracle: quantizes ``w`` on the fly and runs the float32
    contraction over the dequantized weight."""
    import numpy as np

    xf = np.asarray(x, np.float32)
    wf = np.asarray(w, np.float32)
    if weight_dtype == "int8":
        scale = np.maximum(np.abs(wf).max(axis=0) / INT8_QMAX, 1e-9)
        q = np.clip(np.round(wf / scale[None, :]), -127, 127)
        return xf @ (q * scale[None, :])
    din, dout = wf.shape
    gs = din if group_size <= 0 else group_size
    wg = wf.reshape(din // gs, gs, dout)
    scale = np.maximum(np.abs(wg).max(axis=1) / INT4_QMAX, 1e-9)
    q = np.clip(np.round(wg / scale[:, None, :]), -7, 7)
    return xf @ (q * scale[:, None, :]).reshape(din, dout)


# -- int8 KV pages -------------------------------------------------------


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
