"""Unified ragged paged attention: a CUDA kernel for Hopper and its
plain PyTorch version (the counterpart of the reference's
``ops/kernels/paged_attention.py``; the kernel replaces its Pallas
``_ragged_kernel``).

* The KV cache lives in device memory as fixed-size pages
  ``(num_pages, page_size, kv_heads, head_dim)``;
* ``page_table (B, max_pages)`` maps each sequence's logical pages to
  physical ones, ``seq_lens (B,)`` bounds the ragged KV lengths and
  ``q_lens (B,)`` the ragged query lengths: 1 for decode rows, n for
  prefill chunks, so one kernel serves a mixed packed batch;
* query rows are right-aligned: row r of sequence b sits at position
  ``seq_lens[b] - T + r``; padded leading rows return exact zeros.

GQA maps q head h to kv head h // (H // KVH); K/V are never repeated.
:func:`paged_ragged_attention` dispatches on the tensor's device: a CPU
tensor takes :func:`paged_ragged_attention_plain`, a CUDA tensor
launches ``csrc/paged_attention.cu`` or raises. Int8 pages (the
reference's ``k_scales``/``v_scales``) and the legacy ``_decode_kernel``
are not ported yet.

:func:`paged_ragged_fused_step` is one packed attention layer step:
qkv projection + RoPE + the K/V page scatter, the ragged kernel, then
the scatter back and o_proj. The reference compiles it into one XLA
program; here the projections are ``torch.matmul`` (plain matmuls
outside the Pallas body in the reference too), RoPE and the scatter are
torch ops, and the attention is the kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import _build, record_launch
from .rope import apply_rotary_emb

NEG_INF = -1e30
_MAX_GROUP = 32  # q heads per kv head one kernel block serves


def _scale(sm_scale, d):
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)


def paged_ragged_attention_plain(q, k_pages, v_pages, page_table,
                                 seq_lens, q_lens=None, sm_scale=None,
                                 window=0):
    """Gather each sequence's pages, then one dense masked softmax in
    float32. Same contract as :func:`paged_ragged_attention`; returns
    (B, T, H, D) in q's dtype."""
    b, t, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    group = h // kvh
    mp = page_table.shape[1]
    scale = _scale(sm_scale, d)
    tbl = page_table.long()
    lens = seq_lens.long()
    kd = k_pages[tbl].reshape(b, mp * page_size, kvh, d).float()
    vd = v_pages[tbl].reshape(b, mp * page_size, kvh, d).float()
    qf = q.float().reshape(b, t, kvh, group, d)
    s = torch.einsum("btkgd,bskd->bkgts", qf, kd) * scale
    kpos = torch.arange(mp * page_size, device=q.device)
    rows = torch.arange(t, device=q.device)
    qpos = lens[:, None] - t + rows[None, :]                    # (B, T)
    keep = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < lens[:, None, None]))
    # the slots of the pages the TPU kernel visits: below seq_len, and
    # not wholly below every row's window
    page_lo = kpos // page_size * page_size                     # (S,)
    visited = page_lo[None, :] < lens[:, None]                  # (B, S)
    if window:
        keep = keep & (qpos[:, :, None] - kpos[None, None, :] < window)
        visited = visited & (page_lo[None, :] + page_size
                             > lens[:, None] - t - window + 1)
    if q_lens is not None:
        real = rows[None, :] >= t - q_lens.long()[:, None]      # (B, T)
    else:
        real = torch.ones((b, t), dtype=torch.bool, device=q.device)
    keep = (keep & real[:, :, None])[:, None, None]     # (B,1,1,T,S)
    s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    # a masked key weighs exp(NEG_INF - m) = 0 beside a kept one; a row
    # that sees no key weighs every visited slot alike, as the TPU
    # kernel's online softmax over all-NEG_INF scores does
    p = torch.exp(s - m) * visited[:, None, None, None, :]
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgts,bskd->btkgd", p / l, vd)
    out = out * real[:, :, None, None, None]
    return out.reshape(b, t, h, d).to(q.dtype)


def _check_cuda_operands(q, k_pages, v_pages, page_table, seq_lens,
                         q_lens):
    b, t, h, d = q.shape
    np_, page_size, kvh, d2 = k_pages.shape
    dev = q.device
    for name, a in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)) + (
                        (("q_lens", q_lens),) if q_lens is not None else ()):
        if a.device != dev:
            raise ValueError(f"paged_ragged_attention: {name} is on "
                             f"{a.device}, q on {dev}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"paged_ragged_attention: unsupported dtype "
                        f"{q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            "paged_ragged_attention: q and the pages must share one "
            f"dtype, got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if tuple(v_pages.shape) != tuple(k_pages.shape) or d2 != d:
        raise ValueError(
            f"paged_ragged_attention: pages {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"paged_ragged_attention: head_dim {d} not in "
                         "(64, 128)")
    if h % kvh or h // kvh > _MAX_GROUP:
        raise ValueError(f"paged_ragged_attention: {h} q heads over {kvh} "
                         f"kv heads (group <= {_MAX_GROUP})")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"paged_ragged_attention: page_table "
                         f"{tuple(page_table.shape)} for {b} rows")
    for name, a in (("page_table", page_table), ("seq_lens", seq_lens)) + (
            (("q_lens", q_lens),) if q_lens is not None else ()):
        if a.dtype != torch.int32:
            raise TypeError(f"paged_ragged_attention: {name} must be "
                            f"int32, got {a.dtype}")
    if tuple(seq_lens.shape) != (b,) or (
            q_lens is not None and tuple(q_lens.shape) != (b,)):
        raise ValueError("paged_ragged_attention: seq_lens/q_lens must "
                         f"be ({b},)")
    for name, a in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if a.data_ptr() % 16:
            raise ValueError(f"paged_ragged_attention: {name} is not "
                             "16-byte aligned")


def _paged_ragged_attention_cuda(q, k_pages, v_pages, page_table,
                                 seq_lens, q_lens, sm_scale, window):
    q = q.contiguous()
    k_pages = k_pages.contiguous()
    v_pages = v_pages.contiguous()
    page_table = page_table.contiguous()
    seq_lens = seq_lens.contiguous()
    if q_lens is not None:
        q_lens = q_lens.contiguous()
    _check_cuda_operands(q, k_pages, v_pages, page_table, seq_lens,
                         q_lens)
    b, t, h, d = q.shape
    np_, page_size, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    status = lib.ptt_paged_ragged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(),
        q_lens.data_ptr() if q_lens is not None else None,
        out.data_ptr(), b, t, h, kvh, d, np_, page_size,
        page_table.shape[1], _scale(sm_scale, d), int(window or 0),
        _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "paged_ragged_attention")
    record_launch("paged_ragged_attention")
    return out


def paged_ragged_attention(q, k_pages, v_pages, page_table, seq_lens,
                           q_lens=None, sm_scale=None, window=0,
                           k_scales=None, v_scales=None):
    """The unified ragged paged-attention entry: ONE kernel for decode
    rows and prefill chunks.

    q: (B, T, H, D), each row's newest tokens right-aligned, whose K/V
    are already in the pages (``seq_lens`` counts them). ``q_lens``
    (B,) marks how many trailing rows of each sequence are real; the
    padded leading rows return exact zeros; ``q_lens[b] <= seq_lens[b]``.
    Without ``q_lens`` every row is real, and a row that then sees no
    key (``qpos < 0``) returns the mean of V over the slots of the pages
    below ``seq_len``, as the reference's kernel does. ``window`` > 0
    keeps only keys with ``qpos - kpos < window``. Returns
    (B, T, H, D)."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "paged_ragged_attention: int8 pages (k_scales/v_scales) are "
            "not ported yet")
    if q.device.type == "cuda":
        return _paged_ragged_attention_cuda(
            q, k_pages, v_pages, page_table, seq_lens, q_lens, sm_scale,
            window)
    if q.device.type != "cpu":
        raise RuntimeError(
            f"paged_ragged_attention: unsupported device {q.device}")
    return paged_ragged_attention_plain(
        q, k_pages, v_pages, page_table, seq_lens, q_lens=q_lens,
        sm_scale=sm_scale, window=window)


def pad_plan_i32(a, n, fill):
    """Pad a 1-D int32 plan operand to ``n`` entries with ``fill`` (host
    numpy): the reference's out-of-bounds drop entries, which keep its
    compiled step's operands bucket-shaped (``fill`` is the packed length
    for the scatter-back plan and ``num_pages`` for the page plan). The
    port compiles nothing, so its own callers pass real-length plans;
    :func:`paged_ragged_fused_step` reads only the leading real entries
    of a padded one."""
    a = np.asarray(a, np.int32)
    short = n - a.shape[0]
    if short <= 0:
        return a
    return np.concatenate([a, np.full((short,), fill, np.int32)])


def packed_position_index(starts, counts, rows):
    """Flat packed-axis indices of every position of the listed rows,
    in row order (host numpy int64) — the gather plan of the multi-row
    logits epilogue."""
    idx = [np.arange(int(starts[i]), int(starts[i]) + int(counts[i]),
                     dtype=np.int64) for i in rows]
    return np.concatenate(idx)


def _on_device(a, dev):
    """An index operand (tensor, numpy or list) as an int64 tensor on
    ``dev``: no copy for an int64 tensor already there, one
    host-to-device copy for a host array."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.int64)
    return torch.as_tensor(np.asarray(a, np.int64)).to(
        dev, non_blocking=True)


def paged_ragged_fused_step(x, wq, wk, wv, wo, biases, cos, sin, pos,
                            pg, of, gm, mr, mc, mflat, k_pages, v_pages,
                            page_table, seq_lens, q_lens, sm_scale=None,
                            window=0, n_real=None):
    """One packed attention layer step over the bucketed packed axis.

    ``x`` (n_pad, E) normed packed hidden states; ``wq/wk/wv/wo`` the
    [in, out] projection weights; ``biases`` None or (bq, bk, bv);
    ``cos/sin`` (S, hd) RoPE tables; ``pos`` (n_pad,) absolute
    positions. The plans, as in the reference: ``pg/of`` the physical
    page / slot of each packed token; ``gm`` (b_pad, t_pad) the gather
    map right-aligning each row; ``mr/mc/mflat`` the inverse scatter
    (kernel row, column -> packed token). Index operands are tensors
    (no copy when already int64 on ``x``'s device) or host arrays.

    Only the leading ``n_real`` entries of ``pg/of/mr/mc/mflat`` are
    read (all of them when ``n_real`` is None). The reference pads them
    to n_pad with out-of-bounds entries that its ``mode="drop"``
    scatters skip (:func:`pad_plan_i32`); torch would fault on those,
    and they are always the trailing ones, so a padded plan is cut to
    its real length instead.

    The K/V pages are written IN PLACE (the reference rebuilds the
    arrays; at Llama-3-8B shapes they are 33.5 MB per layer). Returns
    ``(y, k_pages, v_pages)`` with the same page tensors it was given.
    """
    n_pad = x.shape[0]
    hd = cos.shape[1]
    nh = wq.shape[1] // hd
    kvh = wk.shape[1] // hd
    dev = x.device
    n = len(pg) if n_real is None else int(n_real)
    xq = torch.matmul(x, wq)
    xk = torch.matmul(x, wk)
    xv = torch.matmul(x, wv)
    if biases is not None:
        bq, bk, bv = biases
        xq, xk, xv = xq + bq, xk + bk, xv + bv
    pos_t = _on_device(pos, dev)
    qh = apply_rotary_emb(xq.reshape(1, n_pad, nh, hd), cos, sin,
                          position_ids=pos_t)[0]
    kh = apply_rotary_emb(xk.reshape(1, n_pad, kvh, hd), cos, sin,
                          position_ids=pos_t)[0]
    vh = xv.reshape(n_pad, kvh, hd)

    # this chunk's K/V land in the pages in place: packed token i at
    # page pg[i], slot of[i]
    if n:
        pg_t, of_t = _on_device(pg, dev)[:n], _on_device(of, dev)[:n]
        k_pages.index_put_((pg_t, of_t), kh[:n].to(k_pages.dtype))
        v_pages.index_put_((pg_t, of_t), vh[:n].to(v_pages.dtype))

    qm = qh[_on_device(gm, dev)]                # (b_pad, t_pad, nh, hd)
    out = paged_ragged_attention(qm, k_pages, v_pages, page_table,
                                 seq_lens, q_lens=q_lens,
                                 sm_scale=sm_scale, window=window)

    # scatter the kernel rows back to the packed axis, then o_proj
    attn = torch.zeros((n_pad, nh, hd), dtype=qh.dtype, device=dev)
    if n:
        attn[_on_device(mflat, dev)[:n]] = out[_on_device(mr, dev)[:n],
                                               _on_device(mc, dev)[:n]]
    y = torch.matmul(attn.reshape(n_pad, nh * hd), wo)
    return y, k_pages, v_pages
