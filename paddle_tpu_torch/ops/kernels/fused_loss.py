"""Fused linear + softmax cross-entropy over vocab chunks (the
counterpart of the reference's ``ops/kernels/fused_loss.py``, which is
plain XLA there too, not a Pallas kernel: the chunk products are torch
matmuls here).

The forward scans the vocab in chunks with a running (max, sum-exp)
online logsumexp and the label's logit, so the [T, V] logits never exist
whole; the backward recomputes each chunk's logits from the saved
(h, lse), forms ``dlogits = (p - onehot) * g`` cast to h's dtype,
accumulates dh in float32 and writes each chunk's dw, cast to w's dtype,
into one [V, H] buffer (with tied embeddings autograd adds it to the
lookup's gradient). A vocab that the chunk does not divide ends in one
shorter chunk. Chunk products accumulate in float32, as the reference's
``preferred_element_type=float32`` does.

The vocab-parallel head (:func:`fused_linear_cross_entropy_vocab_parallel`,
a vocab shard per mp rank) runs the same chunk loops over the rank's
rows and combines the shard statistics over the mp group.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _pick_chunk(v: int, target: int) -> int:
    """Chunk size for vocab ``v``: the largest divisor <= target when it
    keeps chunks near the target, else ``target`` itself with a shorter
    last chunk (divisor-only picking would collapse to 1 for a prime
    vocab)."""
    c = min(target, v)
    while v % c:
        c -= 1
    if c >= max(1, min(target, v) // 2):
        return c
    return min(target, v)


def _mm_f32(a, b):
    """``a @ b`` as float32, accumulated in float32. bf16 products are
    exact in float32, so on the CPU widening first is the same sum."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(v, chunk):
    c = _pick_chunk(v, chunk)
    return [(off, min(c, v - off)) for off in range(0, v, c)]


def _scan(h, w, lab, chunk, base=0):
    """The running (max, sum-exp) of ``h @ w.T`` over w's vocab chunks
    and each label's logit (0 where the label is outside rows
    [base, base + V) of the vocab that w holds), float32 [T] each."""
    t = h.shape[0]
    m = torch.full((t,), NEG_INF, dtype=torch.float32, device=h.device)
    s = torch.zeros(t, dtype=torch.float32, device=h.device)
    ll = torch.zeros(t, dtype=torch.float32, device=h.device)
    for off, n in _chunks(w.shape[0], chunk):
        logits = _mm_f32(h, w[off:off + n].t())           # [T, n]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        rel = lab - base - off
        in_chunk = (rel >= 0) & (rel < n)
        picked = logits.gather(1, rel.clamp(0, n - 1)[:, None])[:, 0]
        ll = torch.where(in_chunk, picked, ll)
        m = m_new
    return m, s, ll


def _grads(h, w, lab, g, lse, chunk, base=0):
    """(dh float32 [T, H], dw [V, H] in w's dtype) of the per-token CE
    scaled by ``g`` [T, 1], recomputing each chunk's logits from the
    saved ``lse``; dh is w's vocab rows' share only."""
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dw = torch.empty_like(w)
    for off, n in _chunks(w.shape[0], chunk):
        wc = w[off:off + n]
        p = torch.exp(_mm_f32(h, wc.t()) - lse[:, None])  # recompute
        rel = lab - base - off
        hit = ((rel >= 0) & (rel < n)).float()[:, None]
        p.scatter_add_(1, rel.clamp(0, n - 1)[:, None], -hit)  # - onehot
        dlogits = (p * g).to(h.dtype)
        dh += _mm_f32(dlogits, wc)
        dw[off:off + n] = _mm_f32(dlogits.t(), h).to(w.dtype)
    return dh, dw


class _FusedLinearCE(torch.autograd.Function):
    """(per-token CE [T] float32, 0 where ignored; count of non-ignored
    tokens, float32) of ``h @ w.T`` against ``labels``.

    With an mp ``group`` of more than one rank, w holds rows
    [base, base + V/n) of the vocab and the shard statistics are
    combined over the group: the max by a MAX all-reduce, the sum-exp
    (rescaled to the global max) and the label's logit (which one rank
    holds) by SUM all-reduces. The backward gives w's rows their
    gradient and sums the ranks' shares of dh over the group in float32
    before rounding it to h's dtype, as the reference's ``psum_scatter``
    does: rounded first, the smaller share of a row is lost against the
    label holder's, and the final norm's gradient came out 1.65% short
    at Qwen2-0.5B's size."""

    @staticmethod
    def forward(ctx, h, w, labels, ignore_index, chunk, base=0, group=None):
        valid = labels != ignore_index
        lab = torch.where(valid, labels, 0)
        m, s, ll = _scan(h, w, lab, chunk, base)
        if group is not None:
            from ...distributed.collective import ReduceOp, all_reduce

            m_local = m
            m = m_local.clone()
            all_reduce(m, ReduceOp.MAX, group=group)
            s = s * torch.exp(m_local - m)
            all_reduce(s, ReduceOp.SUM, group=group)
            all_reduce(ll, ReduceOp.SUM, group=group)
        lse = torch.log(s) + m
        per_tok = torch.where(valid, lse - ll, torch.zeros_like(lse))
        count = valid.sum().float()
        ctx.save_for_backward(h, w, labels, lse)
        ctx.args = (ignore_index, chunk, base, group)
        ctx.mark_non_differentiable(count)
        return per_tok, count

    @staticmethod
    def backward(ctx, dper_tok, _dcount):
        h, w, labels, lse = ctx.saved_tensors
        ignore_index, chunk, base, group = ctx.args
        valid = labels != ignore_index
        lab = torch.where(valid, labels, 0)
        g = torch.where(valid, dper_tok.float(),
                        torch.zeros_like(lse))[:, None]
        dh, dw = _grads(h, w, lab, g, lse, chunk, base)
        if group is not None:
            from ...distributed.collective import ReduceOp, all_reduce

            all_reduce(dh, ReduceOp.SUM, group=group)
        return dh.to(h.dtype), dw, None, None, None, None, None


def fused_linear_cross_entropy_per_token(h, w, labels, ignore_index,
                                         chunk):
    """(per_tok float32 [T], count float32) for h [T, H], w [V, H],
    labels [T]."""
    return _FusedLinearCE.apply(h, w, labels, int(ignore_index), int(chunk),
                                0, None)


def fused_linear_cross_entropy(h, w, labels, ignore_index=-100,
                               chunk=4096, reduction="mean"):
    """CE of the linear head ``h @ w.T`` without materializing logits.
    h: [T, H] (or [B, S, H]), w: [V, H], labels: [T] / [B, S].
    reduction: "mean" (over non-ignored tokens; 0 when all are ignored),
    "sum", or "none" (per-token losses in the labels' shape, 0 at
    ignored positions)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(
            f"fused_linear_cross_entropy: unknown reduction "
            f"{reduction!r} (expected 'mean', 'sum' or 'none')")
    shape = labels.shape
    h = h.reshape(-1, h.shape[-1])
    per_tok, count = fused_linear_cross_entropy_per_token(
        h, w, labels.reshape(-1), ignore_index, chunk)
    if reduction == "none":
        return per_tok.reshape(shape)
    if reduction == "sum":
        return per_tok.sum()
    return per_tok.sum() / count.clamp_min(1.0)


def fused_linear_cross_entropy_vocab_parallel(h, w, labels, ignore_index=-100,
                                              chunk=4096, reduction="mean",
                                              group=None):
    """The vocab-parallel head: CE of ``h @ w_full.T`` where this rank's
    w [V/n, H] holds rows [rank * V/n, (rank + 1) * V/n) of the vocab
    of the mp ``group`` (n ranks). h: [B, S, H], the same on every rank
    (its gradient is summed over the group inside the backward, in
    float32); labels: [B, S] global ids. Chunks run over the rank's rows
    as the single-replica head's do; the log-sum-exp and the label's
    logit are combined over the group. S and the vocab must divide by n
    (``ValueError``, as the reference's). reduction as in
    :func:`fused_linear_cross_entropy` ("mean": over the non-ignored
    labels)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(
            f"fused_linear_cross_entropy_vocab_parallel: unknown "
            f"reduction {reduction!r}")
    n = 1 if group is None else group.nranks
    b, s = labels.shape
    if n > 1 and s % n:
        raise ValueError(f"vocab-parallel CE needs seq ({s}) and vocab "
                         f"({w.shape[0] * n}) divisible by the mp degree "
                         f"{n}")
    shape = labels.shape
    per_tok, count = _FusedLinearCE.apply(
        h.reshape(-1, h.shape[-1]), w, labels.reshape(-1), int(ignore_index),
        int(chunk), group.rank * w.shape[0] if n > 1 else 0,
        group if n > 1 else None)
    if reduction == "none":
        return per_tok.reshape(shape)
    if reduction == "sum":
        return per_tok.sum()
    return per_tok.sum() / count.clamp_min(1.0)
