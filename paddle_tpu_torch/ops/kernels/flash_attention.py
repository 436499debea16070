"""Flash attention forward and backward: CUDA kernels for Hopper and
their plain PyTorch versions (the counterpart of the reference's
``ops/kernels/flash_attention.py``; the kernels in
``csrc/flash_attention.cu`` replace its Pallas ``_flash_fwd_kernel``,
``_flash_bwd_dkdv_kernel`` and ``_flash_bwd_dq_kernel``).

Layout is the reference's public one: q ``[B, Sq, H, D]``, k/v
``[B, Sk, KVH, D]``, q head h reading kv head ``h // (H // KVH)``; lse
is ``[B, H, Sq]`` float32. With ``causal`` the key k is kept for the row
q iff ``0 <= q + Sk - Sq - k`` (and ``< window`` when ``window > 0``).
A row that sees no key returns ``out = 0`` and ``lse = -1e30``, in the
kernel and the plain version alike (the Pallas kernel's result there
depends on its block size), and its gradients are 0.

:func:`flash_attention_fwd`, :func:`flash_attention_bwd_dkdv` and
:func:`flash_attention_bwd_dq` (one per kernel) dispatch on the tensors'
device: CPU tensors take the plain versions, CUDA tensors launch the
kernels or raise. :func:`flash_attention_bwd` computes ``delta`` in
torch (XLA in the reference) and runs both backward parts.
``_FlashCore`` is the ``torch.autograd.Function`` in place of the
reference's ``jax.custom_vjp`` pair ``_flash_core`` /
``_flash_core_lse``.
"""
from __future__ import annotations

import math

import torch

from . import _build, program_op, record_launch

NO_KEY_LSE = -1e30  # lse of a row that sees no key


def _keep_mask(sq, sk, causal, window, device):
    """[Sq, Sk] bool of kept (q, k) pairs, or None without a mask."""
    if not causal:
        return None
    diff = (torch.arange(sq, device=device)[:, None] + (sk - sq)
            - torch.arange(sk, device=device)[None, :])
    keep = diff >= 0
    if window:
        keep = keep & (diff < window)
    return keep


def _grouped(q, kvh):
    """[B, S, H, D] -> [B, KVH, G, S, D] (q head h = kvh * G + g)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)


def _ungrouped(x):
    """[B, KVH, G, S, D] -> [B, S, H, D]."""
    b, kvh, g, s, d = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, d)


def _probs(q, k, keep, scale, lse=None):
    """float32 (p, lse): p [B, KVH, G, Sq, Sk] = exp(s - lse) with pairs
    outside ``keep`` ([Sq, Sk] bool, or None for no mask) exactly 0; lse
    [B, KVH, G, Sq] (NO_KEY_LSE on rows that see no key). Given ``lse``,
    p is recomputed against it."""
    kvh = k.shape[2]
    qg = _grouped(q.float(), kvh)                       # B KVH G Sq D
    kf = k.float().permute(0, 2, 1, 3)                  # B KVH Sk D
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
        lse = torch.where(torch.isinf(lse), torch.full_like(lse, NO_KEY_LSE),
                          lse)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    return p, lse


def _fwd_plain(q, k, v, keep, scale):
    """float32 forward under the mask ``keep``: (out in q's dtype, lse
    float32 [B, H, Sq])."""
    b, sq, h, _ = q.shape
    p, lse = _probs(q, k, keep, scale)
    vf = v.float().permute(0, 2, 1, 3)                  # B KVH Sk D
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return (_ungrouped(out).to(q.dtype),
            lse.reshape(b, h, sq).contiguous())


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None, window=0):
    """Plain forward in float32 (the arithmetic of the reference's
    ``_flash_fwd_ref``): returns (out in q's dtype, lse float32
    [B, H, Sq])."""
    keep = _keep_mask(q.shape[1], k.shape[1], causal, window, q.device)
    return _fwd_plain(q, k, v, keep, _scale(q, scale))


def _bwd_plain(q, k, v, do, lse, delta, keep, scale):
    """float32 (p, ds) [B, KVH, G, Sq, Sk] of the backward under the mask
    ``keep``, the arithmetic of the reference's ``_flash_bwd_chunked``."""
    b, sq, h, _ = q.shape
    kvh = k.shape[2]
    shape = (b, kvh, h // kvh, sq)
    p, _ = _probs(q, k, keep, scale, lse=lse.float().reshape(shape))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(do.float(), kvh),
                      v.float().permute(0, 2, 1, 3))
    ds = p * (dp - delta.float().reshape(shape)[..., None]) * scale
    return p, ds


def _dkdv_plain(q, k, v, do, p, ds):
    """(dk, dv) from the backward's p and ds, cast to k's and v's
    dtypes."""
    kvh = k.shape[2]
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, _grouped(do.float(), kvh))
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, _grouped(q.float(), kvh))
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _dq_plain(q, k, ds):
    """dq from the backward's ds, cast to q's dtype."""
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds,
                      k.float().permute(0, 2, 1, 3))
    return _ungrouped(dq).to(q.dtype)


def flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal=False,
                                   scale=None, window=0):
    """Plain (dk, dv) in float32, cast to k's and v's dtypes. ``delta``
    is float32 [B, H, Sq] (:func:`_delta`)."""
    keep = _keep_mask(q.shape[1], k.shape[1], causal, window, q.device)
    p, ds = _bwd_plain(q, k, v, do, lse, delta, keep, _scale(q, scale))
    return _dkdv_plain(q, k, v, do, p, ds)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=False,
                                 scale=None, window=0):
    """Plain dq in float32, cast to q's dtype."""
    keep = _keep_mask(q.shape[1], k.shape[1], causal, window, q.device)
    _, ds = _bwd_plain(q, k, v, do, lse, delta, keep, _scale(q, scale))
    return _dq_plain(q, k, ds)


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False,
                              scale=None, window=0, dlse=None):
    """Plain backward (``dlse`` [B, H, Sq] the optional cotangent of
    lse): returns (dq, dk, dv) in the inputs' dtypes."""
    delta = _delta(do, out, dlse)
    dk, dv = flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                            causal, scale, window)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                      scale, window)
    return dq, dk, dv


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])


def _delta(do, out, dlse):
    """float32 [B, H, Sq]: rowsum(do * out), minus dlse when given (since
    d(lse)/ds = p, dlse folds into ds as delta -= dlse)."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


# ------------------------------------------------------------ CUDA side
def _check_cuda(name, q, k, v, *more):
    b, sq, h, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{name}: {h} q heads do not divide over "
                         f"{k.shape[2]} kv heads")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    if d not in (64, 128):
        raise NotImplementedError(
            f"{name}: the CUDA kernels take head_dim 64 or 128, got {d}")
    for t in (k, v) + more:
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name}: every input must be {q.dtype} on "
                            f"{q.device}, got {t.dtype} on {t.device}")


def _aligned(t):
    """Contiguous, with a 16-byte-aligned start (the kernels read 16
    bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _flash_fwd_cuda(q, k, v, causal, scale, window):
    _check_cuda("flash_attention_fwd", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    status = _build.library().ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, kvh, sq, sk, d, scale, int(bool(causal)),
        int(window), _build.DTYPE_CODES[q.dtype], _stream(q))
    _build.check(status, "flash_attention_fwd")
    record_launch("flash_attention_fwd", (q, k, v), (out, lse))
    return out, lse


def _bwd_cuda_args(name, q, k, v, do, lse, delta, causal, scale, window):
    """Checked, aligned inputs (q, k, v, do, lse, delta) and the scalar
    arguments of a backward kernel. The caller holds the inputs until
    the launch: a copy freed early could be reused for an output."""
    _check_cuda(name, q, k, v, do)
    b, sq, h, d = q.shape
    if tuple(do.shape) != tuple(q.shape) or \
            tuple(lse.shape) != (b, h, sq) or \
            tuple(delta.shape) != (b, h, sq):
        raise ValueError(
            f"{name}: do {tuple(do.shape)} / lse {tuple(lse.shape)} / "
            f"delta {tuple(delta.shape)} do not match q {tuple(q.shape)}")
    for t in (lse, delta):
        if t.dtype != torch.float32 or t.device != q.device:
            raise TypeError(f"{name}: lse and delta must be float32 on "
                            f"{q.device}")
    ins = [_aligned(t) for t in (q, k, v, do, lse, delta)]
    args = (b, h, k.shape[2], sq, k.shape[1], d, _scale(q, scale),
            int(bool(causal)), int(window), _build.DTYPE_CODES[q.dtype],
            _stream(q))
    return ins, args


def _dkdv_plain_of(q, k, v, do, lse, delta, causal=False, scale=None,
                   window=0):
    window = int(window or 0) if causal else 0
    return flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal,
                                          scale, window)


def _dq_plain_of(q, k, v, do, lse, delta, causal=False, scale=None,
                 window=0):
    window = int(window or 0) if causal else 0
    return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                        scale, window)


def _fwd_plain_of(q, k, v, causal=False, scale=None, window=0):
    window = int(window or 0) if causal else 0
    return flash_attention_fwd_plain(q, k, v, causal, scale, window)


@program_op("flash_attention_bwd_dkdv", _dkdv_plain_of)
def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=False,
                             scale=None, window=0):
    """(dk, dv): the dK/dV CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``delta`` is float32 [B, H, Sq]."""
    window = int(window or 0) if causal else 0
    if _device_of("flash_attention_bwd_dkdv", q) == "cpu":
        return flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                              causal, scale, window)
    ins, args = _bwd_cuda_args("flash_attention_bwd_dkdv", q, k, v, do,
                               lse, delta, causal, scale, window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    status = _build.library().ptt_flash_bwd_dkdv(
        *[t.data_ptr() for t in ins], dk.data_ptr(), dv.data_ptr(), *args)
    _build.check(status, "flash_attention_bwd_dkdv")
    record_launch("flash_attention_bwd_dkdv", ins, (dk, dv))
    return dk, dv


@program_op("flash_attention_bwd_dq", _dq_plain_of)
def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None, window=0):
    """dq: the dQ CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    window = int(window or 0) if causal else 0
    if _device_of("flash_attention_bwd_dq", q) == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                            causal, scale, window)
    ins, args = _bwd_cuda_args("flash_attention_bwd_dq", q, k, v, do,
                               lse, delta, causal, scale, window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    status = _build.library().ptt_flash_bwd_dq(
        *[t.data_ptr() for t in ins], dq.data_ptr(), *args)
    _build.check(status, "flash_attention_bwd_dq")
    record_launch("flash_attention_bwd_dq", ins, (dq,))
    return dq


def _device_of(name, q):
    """'cuda' or 'cpu'; any other device raises."""
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{name}: unsupported device {q.device}")
    return q.device.type


@program_op("flash_attention_fwd", _fwd_plain_of)
def flash_attention_fwd(q, k, v, causal=False, scale=None, window=0):
    """(out, lse): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    window = int(window or 0) if causal else 0
    if _device_of("flash_attention_fwd", q) == "cuda":
        return _flash_fwd_cuda(q, k, v, causal, _scale(q, scale), window)
    return flash_attention_fwd_plain(q, k, v, causal, scale, window)


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None,
                        window=0, dlse=None):
    """(dq, dk, dv): ``delta = rowsum(do * out) - dlse`` in torch, then
    the dK/dV and dQ parts (kernels for CUDA tensors, plain versions for
    CPU tensors)."""
    delta = _delta(do, out, dlse)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal,
                                      scale, window)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                                window)
    return dq, dk, dv


class _FlashCore(torch.autograd.Function):
    """(out, lse) with the flash backward. Saves q, k, v, out and lse, as
    the reference's ``_flash_core_fwd`` does; lse's cotangent, when lse
    is used, reaches the kernels as ``dlse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, window)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, window = ctx.args
        if dout is None:
            dout = torch.zeros_like(out)
        elif dout.dtype != out.dtype or dout.device != out.device or \
                dout.shape != out.shape:
            raise TypeError(
                f"flash attention backward: dout {dout.dtype} "
                f"{tuple(dout.shape)} on {dout.device} does not match out "
                f"{out.dtype} {tuple(out.shape)} on {out.device}")
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), causal, scale,
                                         window, dlse)
        return dq, dk, dv, None, None, None


def _public_args(q, causal, sm_scale, window):
    if window and not causal:
        raise ValueError("flash_attention: window requires causal=True")
    return bool(causal), _scale(q, sm_scale), int(window or 0)


def flash_attention(q, k, v, causal=False, sm_scale=None, window=0):
    """q [B, Sq, H, D], k/v [B, Sk, KVH, D] -> [B, Sq, H, D]. ``window``
    > 0 (requires causal): the sliding band ``0 <= q_pos - k_pos <
    window``, with out-of-band tiles skipped."""
    causal, scale, window = _public_args(q, causal, sm_scale, window)
    out, _ = _FlashCore.apply(q, k, v, causal, scale, window)
    return out


def flash_attention_with_lse(q, k, v, causal=False, sm_scale=None,
                             window=0):
    """Like :func:`flash_attention`, and also the logsumexp [B, H, Sq]
    (float32), differentiable: its cotangent reaches the backward as
    ``dlse``."""
    causal, scale, window = _public_args(q, causal, sm_scale, window)
    return _FlashCore.apply(q, k, v, causal, scale, window)
