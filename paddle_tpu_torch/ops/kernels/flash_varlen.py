"""Packed (varlen) flash attention forward and backward: CUDA kernels for
Hopper and their plain PyTorch versions (the counterpart of the
reference's ``ops/kernels/flash_varlen.py``; the kernels in
``csrc/flash_varlen.cu`` replace its Pallas ``_varlen_fwd_kernel``,
``_varlen_bwd_dkdv_kernel`` and ``_varlen_bwd_dq_kernel``).

Sequences are packed along one token axis: q ``[Tq, H, D]``, k/v
``[Tk, KVH, D]``, with boundaries ``cu_seqlens_q`` / ``cu_seqlens_k``
(int ``[B + 1]``, nondecreasing), q head h reading kv head
``h // (H // KVH)``; lse is ``[H, Tq]`` float32. Token t lies in segment
``searchsorted(cu[1:], t, right=True)`` at local position ``t - cu[seg]``
(:func:`segments`, the reference's ``_segments``); tokens past ``cu[-1]``
form one more segment. The key k is kept for the row q iff both lie in
the same segment and, with ``causal``, ``loc_q >= loc_k`` (top-left
aligned inside each segment). A row that sees no key (an empty k
segment) returns ``out = 0`` and ``lse = -1e30`` with zero gradients,
as the Pallas kernel does.

:func:`flash_varlen_fwd`, :func:`flash_varlen_bwd_dkdv` and
:func:`flash_varlen_bwd_dq` (one per kernel) dispatch on the tensors'
device: CPU tensors take the plain versions, which work segment by
segment (never a [H, T, T] score matrix), CUDA tensors launch the
kernels or raise. Unlike the reference, whose kernel only tiles totals
that divide its block, the kernels take any total. ``_VarlenCore`` is
the ``torch.autograd.Function`` in place of the reference's
``jax.custom_vjp`` ``_varlen_core``.
"""
from __future__ import annotations

import torch

from . import _build, program_op, record_launch
from . import flash_attention as fa

NO_KEY_LSE = fa.NO_KEY_LSE


def segments(cu, total):
    """(seg, loc) int32 ``[total]``: each token's segment and its position
    inside it (the reference's ``_segments``)."""
    cu = cu.to(torch.int32)
    pos = torch.arange(total, dtype=torch.int32, device=cu.device)
    seg = torch.searchsorted(cu[1:].contiguous(), pos, right=True)
    return seg.to(torch.int32), pos - cu[seg]


def _boundaries(cu):
    """``cu`` as a list of ints, checked: one dimension, at least one
    entry, none negative, never decreasing."""
    cu = torch.as_tensor(cu)
    if cu.dim() != 1 or cu.numel() < 1:
        raise ValueError(f"cu_seqlens must be [B + 1], got "
                         f"{tuple(cu.shape)}")
    cu = [int(c) for c in cu.tolist()]
    if cu[0] < 0 or any(b < a for a, b in zip(cu, cu[1:])):
        raise ValueError(f"cu_seqlens must be non-negative and "
                         f"nondecreasing, got {cu}")
    return cu


def _ranges(cu, total):
    """[(first, end, base)] per segment 0..B: its tokens [first, end) of
    ``total`` and the position ``base`` its local positions count
    from."""
    cu = _boundaries(cu)
    b = len(cu) - 1
    out = []
    for s in range(b + 1):
        first = 0 if s == 0 else min(cu[s], total)
        end = total if s == b else min(cu[s + 1], total)
        out.append((first, max(end, first), cu[s]))
    return out


def _segment_pairs(q, k, cu_q, cu_k, causal):
    """(rows, keys, keep) per segment with rows and keys: slices of the
    packed axes and the [rows, keys] mask (None without causal)."""
    for (qb, qe, qbase), (kb, ke, kbase) in zip(
            _ranges(cu_q, q.shape[0]), _ranges(cu_k, k.shape[0])):
        if qe == qb or ke == kb:
            continue  # no row, or rows that see no key
        keep = None
        if causal:
            lq = torch.arange(qb, qe, device=q.device) - qbase
            lk = torch.arange(kb, ke, device=q.device) - kbase
            keep = lq[:, None] >= lk[None, :]
        yield slice(qb, qe), slice(kb, ke), keep


def flash_varlen_fwd_plain(q, k, v, cu_q, cu_k, causal=False, scale=None):
    """Plain forward in float32, segment by segment: (out in q's dtype,
    lse float32 [H, Tq])."""
    scale = fa._scale(q, scale)
    out = torch.zeros_like(q)
    lse = torch.full((q.shape[1], q.shape[0]), NO_KEY_LSE,
                     dtype=torch.float32, device=q.device)
    for rows, keys, keep in _segment_pairs(q, k, cu_q, cu_k, causal):
        o, l = fa._fwd_plain(q[None, rows], k[None, keys], v[None, keys],
                             keep, scale)
        out[rows] = o[0]
        lse[:, rows] = l[0]
    return out, lse


def _bwd_segments(q, k, v, do, lse, delta, cu_q, cu_k, causal, scale):
    """(rows, keys, p, ds) per segment, float32 [1, KVH, G, rows, keys]."""
    scale = fa._scale(q, scale)
    for rows, keys, keep in _segment_pairs(q, k, cu_q, cu_k, causal):
        p, ds = fa._bwd_plain(q[None, rows], k[None, keys], v[None, keys],
                              do[None, rows], lse[None, :, rows],
                              delta[None, :, rows], keep, scale)
        yield rows, keys, p, ds


def flash_varlen_bwd_dkdv_plain(q, k, v, do, lse, delta, cu_q, cu_k,
                                causal=False, scale=None):
    """Plain (dk, dv) in float32, cast to k's and v's dtypes. ``delta``
    is float32 [H, Tq] (:func:`_delta`)."""
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for rows, keys, p, ds in _bwd_segments(q, k, v, do, lse, delta, cu_q,
                                           cu_k, causal, scale):
        dks, dvs = fa._dkdv_plain(q[None, rows], k[None, keys],
                                  v[None, keys], do[None, rows], p, ds)
        dk[keys], dv[keys] = dks[0], dvs[0]
    return dk, dv


def flash_varlen_bwd_dq_plain(q, k, v, do, lse, delta, cu_q, cu_k,
                              causal=False, scale=None):
    """Plain dq in float32, cast to q's dtype."""
    dq = torch.zeros_like(q)
    for rows, keys, _, ds in _bwd_segments(q, k, v, do, lse, delta, cu_q,
                                           cu_k, causal, scale):
        dq[rows] = fa._dq_plain(q[None, rows], k[None, keys], ds)[0]
    return dq


def _delta(do, out):
    """float32 [H, Tq]: rowsum(do * out)."""
    return (do.float() * out.float()).sum(-1).t().contiguous()


# ------------------------------------------------------------ CUDA side
def _check_cuda(name, q, k, v, cu_q, cu_k, *more):
    """Checked, aligned (q, k, v, more..., cu_q, cu_k), cu as int32 on
    q's device, and the number of sequences B."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or \
            k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} / {tuple(v.shape)} are not "
                         "[T, H, D] / [T, KVH, D]")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{name}: {q.shape[1]} q heads do not divide "
                         f"over {k.shape[1]} kv heads")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    if q.shape[2] not in (64, 128):
        raise NotImplementedError(
            f"{name}: the CUDA kernels take head_dim 64 or 128, got "
            f"{q.shape[2]}")
    for t in (k, v) + more:
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name}: every input must be {q.dtype} on "
                            f"{q.device}, got {t.dtype} on {t.device}")
    if cu_q.dim() != 1 or cu_q.shape != cu_k.shape or cu_q.numel() < 1:
        raise ValueError(f"{name}: cu_seqlens_q {tuple(cu_q.shape)} and "
                         f"cu_seqlens_k {tuple(cu_k.shape)} must both be "
                         "[B + 1]")
    cus = [c.to(device=q.device, dtype=torch.int32).contiguous()
           for c in (cu_q, cu_k)]
    return ([fa._aligned(t) for t in (q, k, v) + more] + cus,
            cu_q.numel() - 1)


def _fwd_plain_of(q, k, v, cu_q, cu_k, causal=False, scale=None):
    return flash_varlen_fwd_plain(q, k, v, cu_q, cu_k, causal,
                                  fa._scale(q, scale))


@program_op("flash_varlen_fwd", _fwd_plain_of)
def flash_varlen_fwd(q, k, v, cu_q, cu_k, causal=False, scale=None):
    """(out, lse): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    scale = fa._scale(q, scale)
    if fa._device_of("flash_varlen_fwd", q) == "cpu":
        return flash_varlen_fwd_plain(q, k, v, cu_q, cu_k, causal, scale)
    ins, b = _check_cuda("flash_varlen_fwd", q, k, v, cu_q, cu_k)
    tq, h, d = q.shape
    tk, kvh = k.shape[0], k.shape[1]
    if not (tq and tk):  # no row, or every row sees no key
        return torch.zeros_like(q), torch.full(
            (h, tq), NO_KEY_LSE, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty(h, tq, dtype=torch.float32, device=q.device)
    status = _build.library().ptt_flash_varlen_fwd(
        *[t.data_ptr() for t in ins], out.data_ptr(), lse.data_ptr(), b, h,
        kvh, tq, tk, d, scale, int(bool(causal)),
        _build.DTYPE_CODES[q.dtype], fa._stream(q))
    _build.check(status, "flash_varlen_fwd")
    record_launch("flash_varlen_fwd", ins, (out, lse))
    return out, lse


def _bwd_cuda(name, q, k, v, do, lse, delta, cu_q, cu_k, causal, scale):
    """Checked, aligned inputs (q, k, v, do, lse, delta, cu_q, cu_k) and
    the scalar arguments of a backward kernel. The caller holds the
    inputs until the launch: a copy freed early could be reused for an
    output."""
    if tuple(do.shape) != tuple(q.shape) or \
            tuple(lse.shape) != (q.shape[1], q.shape[0]) or \
            tuple(delta.shape) != tuple(lse.shape):
        raise ValueError(
            f"{name}: do {tuple(do.shape)} / lse {tuple(lse.shape)} / "
            f"delta {tuple(delta.shape)} do not match q {tuple(q.shape)}")
    for t in (lse, delta):
        if t.dtype != torch.float32 or t.device != q.device:
            raise TypeError(f"{name}: lse and delta must be float32 on "
                            f"{q.device}")
    ins, b = _check_cuda(name, q, k, v, cu_q, cu_k, do)
    q, k, v, do, cu_q, cu_k = ins
    ins = [q, k, v, do, fa._aligned(lse), fa._aligned(delta), cu_q, cu_k]
    args = (b, q.shape[1], k.shape[1], q.shape[0], k.shape[0], q.shape[2],
            fa._scale(q, scale), int(bool(causal)),
            _build.DTYPE_CODES[q.dtype], fa._stream(q))
    return ins, args


@program_op("flash_varlen_bwd_dkdv", flash_varlen_bwd_dkdv_plain)
def flash_varlen_bwd_dkdv(q, k, v, do, lse, delta, cu_q, cu_k,
                          causal=False, scale=None):
    """(dk, dv): the dK/dV CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. ``delta`` is float32 [H, Tq]."""
    if fa._device_of("flash_varlen_bwd_dkdv", q) == "cpu":
        return flash_varlen_bwd_dkdv_plain(q, k, v, do, lse, delta, cu_q,
                                           cu_k, causal, scale)
    ins, args = _bwd_cuda("flash_varlen_bwd_dkdv", q, k, v, do, lse, delta,
                          cu_q, cu_k, causal, scale)
    if not (q.shape[0] and k.shape[0]):
        return torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    status = _build.library().ptt_flash_varlen_bwd_dkdv(
        *[t.data_ptr() for t in ins], dk.data_ptr(), dv.data_ptr(), *args)
    _build.check(status, "flash_varlen_bwd_dkdv")
    record_launch("flash_varlen_bwd_dkdv", ins, (dk, dv))
    return dk, dv


@program_op("flash_varlen_bwd_dq", flash_varlen_bwd_dq_plain)
def flash_varlen_bwd_dq(q, k, v, do, lse, delta, cu_q, cu_k, causal=False,
                        scale=None):
    """dq: the dQ CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if fa._device_of("flash_varlen_bwd_dq", q) == "cpu":
        return flash_varlen_bwd_dq_plain(q, k, v, do, lse, delta, cu_q,
                                         cu_k, causal, scale)
    ins, args = _bwd_cuda("flash_varlen_bwd_dq", q, k, v, do, lse, delta,
                          cu_q, cu_k, causal, scale)
    if q.dtype == torch.bfloat16 and q.shape[1] // k.shape[1] > 64:
        raise NotImplementedError(
            "flash_varlen_bwd_dq: the bf16 kernel packs a kv head's group "
            f"into 64-pair M tiles; group {q.shape[1] // k.shape[1]} > 64")
    if not (q.shape[0] and k.shape[0]):
        return torch.zeros_like(q)
    dq = torch.empty_like(q)
    status = _build.library().ptt_flash_varlen_bwd_dq(
        *[t.data_ptr() for t in ins], dq.data_ptr(), *args)
    _build.check(status, "flash_varlen_bwd_dq")
    record_launch("flash_varlen_bwd_dq", ins, (dq,))
    return dq


def flash_varlen_bwd(q, k, v, out, lse, do, cu_q, cu_k, causal=False,
                     scale=None):
    """(dq, dk, dv): ``delta = rowsum(do * out)`` in torch (XLA in the
    reference), then the dK/dV and dQ parts."""
    delta = _delta(do, out)
    dk, dv = flash_varlen_bwd_dkdv(q, k, v, do, lse, delta, cu_q, cu_k,
                                   causal, scale)
    dq = flash_varlen_bwd_dq(q, k, v, do, lse, delta, cu_q, cu_k, causal,
                             scale)
    return dq, dk, dv


class _VarlenCore(torch.autograd.Function):
    """out with the varlen backward. Saves q, k, v, out, lse and the
    boundaries, as the reference's ``_varlen_core_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, causal, scale):
        out, lse = flash_varlen_fwd(q, k, v, cu_q, cu_k, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse, cu_q, cu_k)
        ctx.args = (causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, cu_q, cu_k = ctx.saved_tensors
        if dout.dtype != out.dtype or dout.device != out.device or \
                dout.shape != out.shape:
            raise TypeError(
                f"varlen attention backward: dout {dout.dtype} "
                f"{tuple(dout.shape)} on {dout.device} does not match out "
                f"{out.dtype} {tuple(out.shape)} on {out.device}")
        dq, dk, dv = flash_varlen_bwd(q, k, v, out, lse, dout.contiguous(),
                                      cu_q, cu_k, *ctx.args)
        return dq, dk, dv, None, None, None, None


def varlen_attention(q, k, v, cu_seqlens_q, cu_seqlens_k, causal,
                     scale=None):
    """Packed varlen attention: q ``[Tq, H, D]``, k/v ``[Tk, KVH, D]``,
    ``cu_seqlens_*`` int ``[B + 1]`` -> ``[Tq, H, D]``, differentiable in
    q, k and v. Boundaries handed over on the host are checked there
    (:func:`_boundaries`; on the card the kernels clamp them to the
    tokens) and move to q's device once, for the forward and both
    backward kernels."""
    cus = []
    for c in (cu_seqlens_q, cu_seqlens_k):
        c = torch.as_tensor(c)
        if c.device.type == "cpu":
            _boundaries(c)
        cus.append(c.to(device=q.device, dtype=torch.int32))
    cu_q, cu_k = cus
    return _VarlenCore.apply(q, k, v, cu_q, cu_k, bool(causal),
                             fa._scale(q, scale))
