"""Paged attention: CUDA kernels for Hopper and their plain PyTorch
versions (the counterpart of the reference's
``ops/kernels/paged_attention.py``): the unified ragged kernel replaces
its Pallas ``_ragged_kernel``, the decode kernel its ``_decode_kernel``.

* The KV cache lives in device memory as fixed-size pages
  ``(num_pages, page_size, kv_heads, head_dim)``;
* ``page_table (B, max_pages)`` maps each sequence's logical pages to
  physical ones, ``seq_lens (B,)`` bounds the ragged KV lengths and
  ``q_lens (B,)`` the ragged query lengths: 1 for decode rows, n for
  prefill chunks, so one kernel serves a mixed packed batch;
* query rows are right-aligned: row r of sequence b sits at position
  ``seq_lens[b] - T + r``; padded leading rows return exact zeros.

GQA maps q head h to kv head h // (H // KVH); K/V are never repeated.
Int8 pages carry per-page, per-kv-head float32 scales ``k_scales`` /
``v_scales`` (NP, KVH) (``quant.py``); each key's codes count with its
physical page's scales. Each entry dispatches on the tensor's device: a
CPU tensor takes the plain version, a CUDA tensor launches
``csrc/paged_attention.cu`` or raises.

The ragged entry takes one of three routes on the card, chosen from the
shapes: T = 1 (every decode-only serving step) runs the decode kernel's
split over pages and its merge (``decode_split_plan``); T > 1 with bf16
q runs the tensor-core kernel, its keys split over chunks of pages
(``ragged_split_plan``); T > 1 with float32 q runs the CUDA-core kernel.
One call counts one launch whichever route it takes.

:func:`paged_attention` is the decode entry, one token per sequence.
Under ``FLAGS_ragged_attention=auto|on`` it is the ragged entry at T=1;
under ``off`` it is the dedicated decode entry (the historical
two-kernel routing, kept for A/B against the unified path).

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

from ...framework.flags import ragged_attention_mode
from . import _build, program_op, record_launch
from .rope import apply_rotary_emb

NEG_INF = -1e30
_MAX_GROUP = 32  # q heads per kv head one kernel block serves
# keys a block of the decode kernel's split pass takes: whole pages, at
# most 128 of them (csrc/paged_attention.cu, kDecMaxChunkPages)
DECODE_CHUNK_KEYS = 128
# The ragged kernel's tensor-core route (T > 1, bf16 q): an M tile of 64
# (row, q head) pairs a block; each block takes the keys of one chunk of
# whole pages, at least RAGGED_MIN_CHUNK_KEYS of them and a whole number
# of 64-key tiles. The split aims at RAGGED_SPLIT_BLOCKS blocks (one a
# streaming multiprocessor of the H100's 132: more waves of shorter
# blocks measured slower, PERF.md), and stops where the float32
# partials would take more than RAGGED_WORKSPACE_BYTES.
RAGGED_TILE_PAIRS = 64
RAGGED_MIN_CHUNK_KEYS = 256
# pages a block takes at most: its slice of the page table is staged in
# shared memory (csrc/paged_attention.cu, kRagMaxChunkPages)
RAGGED_MAX_CHUNK_PAGES = 1024
RAGGED_SPLIT_BLOCKS = 132
RAGGED_WORKSPACE_BYTES = 16 << 20


def _scale(sm_scale, d):
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)


def _check_scales(name, k_pages, k_scales, v_scales):
    """The reference's pairing rule, and int8 pages exactly when scales
    are given (raw int8 codes attended without them are meaningless)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: pass both k_scales and v_scales or "
                         "neither")
    if (k_pages.dtype == torch.int8) != (k_scales is not None):
        raise ValueError(
            f"{name}: int8 pages need k_scales/v_scales and float pages "
            f"take none (pages {k_pages.dtype}, scales "
            f"{'given' if k_scales is not None else 'absent'})")


def _gather_kv(pages, scales, tbl):
    """(B, MP * P, KVH, D) float32 keys or values of each row's pages,
    int8 codes multiplied by their page's scales."""
    b, mp = tbl.shape
    _, page_size, kvh, d = pages.shape
    out = pages[tbl].float()                           # (B, MP, P, KVH, D)
    if scales is not None:
        out = out * scales.float()[tbl][:, :, None, :, None]
    return out.reshape(b, mp * page_size, kvh, d)


def paged_ragged_attention_plain(q, k_pages, v_pages, page_table,
                                 seq_lens, q_lens=None, sm_scale=None,
                                 window=0, k_scales=None, v_scales=None):
    """Gather each sequence's pages (dequantized when scales are given),
    then one dense masked softmax in float32. Same contract as
    :func:`paged_ragged_attention`; returns (B, T, H, D) in q's
    dtype."""
    _check_scales("paged_ragged_attention", k_pages, k_scales, v_scales)
    b, t, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    group = h // kvh
    mp = page_table.shape[1]
    scale = _scale(sm_scale, d)
    tbl = page_table.long()
    lens = seq_lens.long()
    kd = _gather_kv(k_pages, k_scales, tbl)
    vd = _gather_kv(v_pages, v_scales, tbl)
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


def ragged_split_plan(batch, t, heads, kv_heads, head_dim, max_pages,
                      page_size):
    """``(rows_per_tile, tiles, chunk_pages, splits, workspace_shape)``
    of the ragged kernel's tensor-core route (T > 1), from shapes the host
    knows (never from ``seq_lens`` or ``q_lens``, which live on the
    device). An M tile packs ``rows_per_tile = 64 // group`` consecutive
    rows with all ``group`` q heads of one kv head; ``tiles`` of them
    cover T. Each block takes the keys of ``chunk_pages`` whole pages
    (a multiple of a 64-key tile's pages, at most
    ``RAGGED_MAX_CHUNK_PAGES``); ``splits`` chunks cover the page
    table's width. With one split there is no workspace (``None``)
    and the blocks write the output; with more, the float32 partials
    ``(acc[D], m, l)`` of every (row, kv head, tile, split, pair) go to a
    workspace that the merge reads in split order."""
    group = heads // kv_heads
    rows = RAGGED_TILE_PAIRS // group
    tiles = -(-t // rows)
    blocks = batch * kv_heads * tiles
    split_bytes = blocks * RAGGED_TILE_PAIRS * (head_dim + 2) * 4
    unit = max(1, 64 // page_size)  # pages of one 64-key tile
    min_chunk = -(-max(unit, -(-RAGGED_MIN_CHUNK_KEYS // page_size))
                  // unit) * unit
    splits = max(1, min(-(-max_pages // min_chunk),
                        -(-RAGGED_SPLIT_BLOCKS // blocks),
                        RAGGED_WORKSPACE_BYTES // split_bytes),
                 -(-max_pages // RAGGED_MAX_CHUNK_PAGES))
    chunk_pages = -(-(-(-max_pages // splits)) // unit) * unit
    splits = -(-max_pages // chunk_pages)
    if splits == 1:
        return rows, tiles, max_pages, 1, None
    return rows, tiles, chunk_pages, splits, (
        batch, kv_heads, tiles, splits, RAGGED_TILE_PAIRS, head_dim + 2)


def paged_ragged_attention_split_plain(q, k_pages, v_pages, page_table,
                                       seq_lens, q_lens=None,
                                       chunk_pages=1, sm_scale=None,
                                       window=0, k_scales=None,
                                       v_scales=None):
    """The CUDA kernels' split arithmetic in plain float32 PyTorch (used
    by the tests): per chunk of ``chunk_pages`` whole pages of each row's
    keys, the partial ``(m_i, l_i, acc_i)`` of its kept keys, with int8
    codes entering as codes and each key's K scale (of its physical page)
    applied to its column of S, its V scale to its column of P; then the
    merge of a row's chunks in order, ``m = max m_i``, ``l = sum l_i
    exp(m_i - m)``, ``acc = sum acc_i exp(m_i - m)``, ``out = acc /
    max(l, 1e-30)``. Padded rows and rows of seq_len 0 are exactly 0; a
    real row that sees no key (``q_lens`` absent) takes the mean of V as
    in :func:`paged_ragged_attention_plain`, which a second kernel writes
    on the card. T = 1 is the decode split (``decode_split_plan``'s
    chunks), T > 1 the tensor-core route (``ragged_split_plan``'s)."""
    _check_scales("paged_ragged_attention", k_pages, k_scales, v_scales)
    b, t, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    group = h // kvh
    mp = page_table.shape[1]
    splits = -(-mp // chunk_pages)
    chunk = chunk_pages * page_size
    n_keys = splits * chunk
    tbl = page_table.long()
    lens = seq_lens.long()
    pad = n_keys - mp * page_size  # keys past the table: masked

    def keys(pages, scales):
        x = pages[tbl].float().reshape(b, mp * page_size, kvh, d)
        sc = (scales.float()[tbl] if scales is not None
              else torch.ones(b, mp, kvh))            # (B, MP, KVH)
        sc = sc.repeat_interleave(page_size, dim=1)   # (B, S, KVH)
        return (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)),
                torch.nn.functional.pad(sc, (0, 0, 0, pad)))

    kd, ksc = keys(k_pages, k_scales)
    vd, vsc = keys(v_pages, v_scales)
    qf = q.float().reshape(b, t, kvh, group, d)
    s = torch.einsum("btkgd,bskd->bkgts", qf, kd) * _scale(sm_scale, d)
    s = s * ksc.permute(0, 2, 1)[:, :, None, None, :]
    kpos = torch.arange(n_keys)
    rows = torch.arange(t)
    qpos = lens[:, None] - t + rows[None, :]                    # (B, T)
    keep = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos[None, None, :] < lens[:, None, None])
            & (kpos < mp * page_size)[None, None, :])
    if window:
        keep = keep & (qpos[:, :, None] - kpos[None, None, :] < window)
    if q_lens is not None:
        real = rows[None, :] >= t - q_lens.long()[:, None]      # (B, T)
    else:
        real = torch.ones((b, t), dtype=torch.bool)
    keep = (keep & real[:, :, None])[:, None, None]     # (B,1,1,T,S)
    # chunks: (B, KVH, G, T, splits, chunk)
    shape = (b, kvh, group, t, splits, chunk)
    s = s.masked_fill(~keep, NEG_INF).reshape(shape)
    keep = keep.reshape(b, 1, 1, t, splits, chunk)
    m_i = s.amax(dim=-1)
    p = torch.exp(s - m_i[..., None]) * keep
    l_i = p.sum(dim=-1)
    pv = p * vsc.permute(0, 2, 1).reshape(b, kvh, 1, 1, splits, chunk)
    acc_i = torch.einsum("bkgtnc,bnckd->bkgtnd", pv,
                         vd.reshape(b, splits, chunk, kvh, d))
    full = keep.any(dim=-1)                            # (B,1,1,T,splits)
    m = m_i.masked_fill(~full, NEG_INF).amax(dim=-1, keepdim=True)
    w = torch.exp(m_i - m) * full
    l = (l_i * w).sum(dim=-1)
    acc = (acc_i * w[..., None]).sum(dim=-2)
    out = acc / l.clamp_min(1e-30)[..., None]          # (B,KVH,G,T,D)
    out = out.permute(0, 3, 1, 2, 4) * real[:, :, None, None, None]
    out = out.reshape(b, t, h, d)
    if q_lens is None:
        # real rows that see no key: the second kernel's mean of V
        no_key = (qpos < 0) & (lens[:, None] > 0)               # (B, T)
        if bool(no_key.any()):
            mean = paged_ragged_attention_plain(
                q.float(), k_pages, v_pages, page_table, seq_lens,
                sm_scale=sm_scale, window=window, k_scales=k_scales,
                v_scales=v_scales)
            out = torch.where(no_key[:, :, None, None], mean, out)
    return out.to(q.dtype)


def _check_cuda_operands(name, q, k_pages, v_pages, page_table, seq_lens,
                         q_lens, k_scales, v_scales):
    """What the C entries take: q (B, T, H, D), contiguous operands on
    q's device, pages of q's dtype or int8 codes with contiguous float32
    (NP, KVH) scales, int32 index operands."""
    b, t, h, d = q.shape
    np_, page_size, kvh, d2 = k_pages.shape
    dev = q.device
    opt = tuple((n, a) for n, a in (("q_lens", q_lens),
                                    ("k_scales", k_scales),
                                    ("v_scales", v_scales))
                if a is not None)
    for n, a in (("k_pages", k_pages), ("v_pages", v_pages),
                 ("page_table", page_table), ("seq_lens", seq_lens)) + opt:
        if a.device != dev:
            raise ValueError(f"{name}: {n} is on {a.device}, q on {dev}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    if v_pages.dtype != k_pages.dtype or k_pages.dtype not in (
            q.dtype, torch.int8):
        raise TypeError(
            f"{name}: the pages must be of q's dtype or int8, got "
            f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    _check_scales(name, k_pages, k_scales, v_scales)
    for n, a in (("k_scales", k_scales), ("v_scales", v_scales)):
        if a is not None and (a.dtype != torch.float32
                              or tuple(a.shape) != (np_, kvh)
                              or not a.is_contiguous()):
            raise ValueError(
                f"{name}: {n} must be contiguous float32 ({np_}, {kvh}), "
                f"got {a.dtype} {tuple(a.shape)}")
    if tuple(v_pages.shape) != tuple(k_pages.shape) or d2 != d:
        raise ValueError(
            f"{name}: pages {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if d not in (64, 128):
        raise ValueError(f"{name}: head_dim {d} not in (64, 128)")
    if h % kvh or h // kvh > _MAX_GROUP:
        raise ValueError(f"{name}: {h} q heads over {kvh} kv heads "
                         f"(group <= {_MAX_GROUP})")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"{name}: page_table "
                         f"{tuple(page_table.shape)} for {b} rows")
    for n, a in (("page_table", page_table), ("seq_lens", seq_lens)) + (
            (("q_lens", q_lens),) if q_lens is not None else ()):
        if a.dtype != torch.int32:
            raise TypeError(f"{name}: {n} must be int32, got {a.dtype}")
    if tuple(seq_lens.shape) != (b,) or (
            q_lens is not None and tuple(q_lens.shape) != (b,)):
        raise ValueError(f"{name}: seq_lens/q_lens must be ({b},)")
    for n, a in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if a.data_ptr() % 16:
            raise ValueError(f"{name}: {n} is not 16-byte aligned")


def _contiguous(*tensors):
    return [None if a is None else a.contiguous() for a in tensors]


def _ptr(a):
    return None if a is None else a.data_ptr()


def _paged_ragged_attention_cuda(q, k_pages, v_pages, page_table,
                                 seq_lens, q_lens, sm_scale, window,
                                 k_scales, v_scales):
    (q, k_pages, v_pages, page_table, seq_lens, q_lens, k_scales,
     v_scales) = _contiguous(q, k_pages, v_pages, page_table, seq_lens,
                             q_lens, k_scales, v_scales)
    _check_cuda_operands("paged_ragged_attention", q, k_pages, v_pages,
                         page_table, seq_lens, q_lens, k_scales, v_scales)
    b, t, h, d = q.shape
    np_, page_size, kvh, _ = k_pages.shape
    mp = page_table.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # the route: T = 1, the decode kernel's split over pages; T > 1 with
    # bf16 q, the tensor cores; T > 1 with float32 q, the CUDA cores
    chunk_pages, ws_shape = 0, None
    if t == 1:
        chunk_pages, _, ws_shape = decode_split_plan(b, kvh, h // kvh, d, mp,
                                                     page_size)
    elif q.dtype == torch.bfloat16:
        _, _, chunk_pages, _, ws_shape = ragged_split_plan(
            b, t, h, kvh, d, mp, page_size)
    workspace = None if ws_shape is None else torch.empty(
        ws_shape, dtype=torch.float32, device=q.device)
    lib = _build.library()
    status = lib.ptt_paged_ragged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        _ptr(k_scales), _ptr(v_scales), page_table.data_ptr(),
        seq_lens.data_ptr(), _ptr(q_lens), out.data_ptr(), _ptr(workspace),
        b, t, h, kvh, d, np_, page_size, mp, chunk_pages,
        _scale(sm_scale, d), int(window or 0), _build.DTYPE_CODES[q.dtype],
        _build.KV_DTYPE_CODES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "paged_ragged_attention")
    record_launch("paged_ragged_attention", (q, k_pages, v_pages, page_table,
                                            seq_lens), (out,))
    return out


@program_op("paged_ragged_attention", paged_ragged_attention_plain)
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
    keeps only keys with ``qpos - kpos < window``. Int8 pages: pass
    ``k_scales``/``v_scales`` (NP, KVH) float32. Returns (B, T, H, D)."""
    if q.device.type == "cuda":
        return _paged_ragged_attention_cuda(
            q, k_pages, v_pages, page_table, seq_lens, q_lens, sm_scale,
            window, k_scales, v_scales)
    if q.device.type != "cpu":
        raise RuntimeError(
            f"paged_ragged_attention: unsupported device {q.device}")
    return paged_ragged_attention_plain(
        q, k_pages, v_pages, page_table, seq_lens, q_lens=q_lens,
        sm_scale=sm_scale, window=window, k_scales=k_scales,
        v_scales=v_scales)


def paged_prefill_attention(q, k_pages, v_pages, page_table, seq_lens,
                            sm_scale=None, window=0, k_scales=None,
                            v_scales=None, q_lens=None):
    """Ragged chunked prefill over a paged KV cache: an alias of
    :func:`paged_ragged_attention`, as in the reference (its q_lens-masked
    prefill kernel was the unified ragged kernel all along, so ``off``
    has no separate prefill lowering)."""
    return paged_ragged_attention(
        q, k_pages, v_pages, page_table, seq_lens, q_lens=q_lens,
        sm_scale=sm_scale, window=window, k_scales=k_scales,
        v_scales=v_scales)


def paged_attention_plain(q, k_pages, v_pages, page_table, seq_lens,
                          sm_scale=None, window=0, k_scales=None,
                          v_scales=None):
    """The decode kernel's plain version: gather each sequence's pages
    (dequantized when scales are given), then one masked softmax over
    its keys in float32. Same contract as :func:`paged_attention`;
    returns (B, H, D) in q's dtype."""
    _check_scales("paged_attention", k_pages, k_scales, v_scales)
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    group = h // kvh
    mp = page_table.shape[1]
    tbl = page_table.long()
    lens = seq_lens.long()
    kd = _gather_kv(k_pages, k_scales, tbl)
    vd = _gather_kv(v_pages, v_scales, tbl)
    qf = q.float().reshape(b, kvh, group, d)
    s = torch.einsum("bkgd,bskd->bkgs", qf, kd) * _scale(sm_scale, d)
    kpos = torch.arange(mp * page_size, device=q.device)
    keep = kpos[None, :] < lens[:, None]                       # (B, S)
    if window:
        keep = keep & (kpos[None, :] >= lens[:, None] - window)
    keep = keep[:, None, None, :]
    s = s.masked_fill(~keep, NEG_INF)
    # a row with seq_len 0 keeps no key: p is all 0 and so is its output
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * keep
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p / l, vd)
    return out.reshape(b, h, d).to(q.dtype)


def decode_split_plan(batch, kv_heads, group, head_dim, max_pages,
                      page_size):
    """``(chunk_pages, splits, workspace_shape)`` of the decode kernel's
    split pass, from shapes the host knows (never from ``seq_lens``,
    which live on the device): each block takes ``chunk_pages`` whole
    pages (``DECODE_CHUNK_KEYS`` keys, at least one page) of a row's
    keys, ``splits = ceil(max_pages / chunk_pages)`` blocks cover the
    page table's width, and the float32 workspace holds one partial
    ``(acc[D], m, l)`` per (row, kv head, split, q head of the group)."""
    chunk_pages = max(1, DECODE_CHUNK_KEYS // page_size)
    splits = -(-max_pages // chunk_pages)
    return chunk_pages, splits, (batch, kv_heads, splits, group,
                                 head_dim + 2)


def paged_attention_split_plain(q, k_pages, v_pages, page_table, seq_lens,
                                chunk_pages, sm_scale=None, window=0,
                                k_scales=None, v_scales=None):
    """The decode kernel's two-pass arithmetic in plain PyTorch (used by
    the tests): per chunk of ``chunk_pages`` pages of each row's keys, the
    float32 partial ``(m, l, acc)`` of its kept keys, then the merge of a
    row's non-empty chunks, ``m = max m_i``, ``l = sum l_i exp(m_i - m)``,
    ``acc = sum acc_i exp(m_i - m)``, ``out = acc / max(l, 1e-30)``. Same
    contract and result as :func:`paged_attention_plain`."""
    _check_scales("paged_attention", k_pages, k_scales, v_scales)
    b, h, d = q.shape
    _, page_size, kvh, _ = k_pages.shape
    group = h // kvh
    mp = page_table.shape[1]
    splits = -(-mp // chunk_pages)
    chunk = chunk_pages * page_size
    tbl = page_table.long()
    lens = seq_lens.long()
    kd = _gather_kv(k_pages, k_scales, tbl)
    vd = _gather_kv(v_pages, v_scales, tbl)
    pad = splits * chunk - mp * page_size  # keys past the table: masked
    kd, vd = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
              for x in (kd, vd))
    qf = q.float().reshape(b, kvh, group, d)
    s = torch.einsum("bkgd,bskd->bkgs", qf, kd) * _scale(sm_scale, d)
    kpos = torch.arange(splits * chunk, device=q.device)
    keep = (kpos[None, :] < lens[:, None]) & (kpos[None, :] < mp * page_size)
    if window:
        keep = keep & (kpos[None, :] >= lens[:, None] - window)
    # (B, KVH, G, splits, chunk)
    s = s.reshape(b, kvh, group, splits, chunk)
    keep = keep.reshape(b, 1, 1, splits, chunk)
    s = s.masked_fill(~keep, NEG_INF)
    m_i = s.amax(dim=-1)
    p = torch.exp(s - m_i[..., None]) * keep
    l_i = p.sum(dim=-1)
    acc_i = torch.einsum("bkgnc,bnckd->bkgnd", p,
                         vd.reshape(b, splits, chunk, kvh, d))
    # the merge: only the chunks holding a kept key
    full = keep.any(dim=-1)                               # (B, 1, 1, splits)
    m = m_i.masked_fill(~full, NEG_INF).amax(dim=-1, keepdim=True)
    w = torch.exp(m_i - m) * full
    l = (l_i * w).sum(dim=-1)
    acc = (acc_i * w[..., None]).sum(dim=-2)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def _paged_decode_attention_cuda(q, k_pages, v_pages, page_table,
                                 seq_lens, sm_scale, window, k_scales,
                                 v_scales):
    (q, k_pages, v_pages, page_table, seq_lens, k_scales,
     v_scales) = _contiguous(q, k_pages, v_pages, page_table, seq_lens,
                             k_scales, v_scales)
    if q.dim() != 3:
        raise ValueError(f"paged_attention: q must be (B, H, D), got "
                         f"{tuple(q.shape)}")
    _check_cuda_operands("paged_attention", q[:, None], k_pages, v_pages,
                         page_table, seq_lens, None, k_scales, v_scales)
    b, h, d = q.shape
    np_, page_size, kvh, _ = k_pages.shape
    mp = page_table.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    chunk_pages, _, ws_shape = decode_split_plan(b, kvh, h // kvh, d, mp,
                                                 page_size)
    workspace = torch.empty(ws_shape, dtype=torch.float32, device=q.device)
    lib = _build.library()
    status = lib.ptt_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        _ptr(k_scales), _ptr(v_scales), page_table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), workspace.data_ptr(), b, h,
        kvh, d, np_, page_size, mp, chunk_pages, _scale(sm_scale, d),
        int(window or 0),
        _build.DTYPE_CODES[q.dtype], _build.KV_DTYPE_CODES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "paged_attention")
    record_launch("paged_decode_attention", (q, k_pages, v_pages,
                                             page_table, seq_lens), (out,))
    return out


@program_op("paged_decode_attention", paged_attention_plain)
def paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                    sm_scale=None, window=0, k_scales=None, v_scales=None):
    """Decode attention over a paged KV cache, one token per sequence.

    q: (B, H, D); k_pages/v_pages: (NP, P, KVH, D); page_table
    (B, max_pages) int32 physical page ids; seq_lens (B,) int32.
    ``window`` > 0 keeps only the last ``window`` keys (pages wholly
    outside are never read). Int8 pages: pass ``k_scales``/``v_scales``
    (NP, KVH) float32. Returns (B, H, D); a row with seq_len 0 returns
    zeros.

    Under ``FLAGS_ragged_attention=auto|on`` this is the ragged kernel at
    T=1 with every q_len 1; under ``off``, the dedicated decode kernel
    (for a CPU tensor, :func:`paged_attention_plain`)."""
    _check_scales("paged_attention", k_pages, k_scales, v_scales)
    if ragged_attention_mode() != "off":
        ones = torch.ones((q.shape[0],), dtype=torch.int32, device=q.device)
        return paged_ragged_attention(
            q[:, None], k_pages, v_pages, page_table, seq_lens,
            q_lens=ones, sm_scale=sm_scale, window=window,
            k_scales=k_scales, v_scales=v_scales)[:, 0]
    if q.device.type == "cuda":
        return _paged_decode_attention_cuda(
            q, k_pages, v_pages, page_table, seq_lens, sm_scale, window,
            k_scales, v_scales)
    if q.device.type != "cpu":
        raise RuntimeError(f"paged_attention: unsupported device {q.device}")
    return paged_attention_plain(
        q, k_pages, v_pages, page_table, seq_lens, sm_scale=sm_scale,
        window=window, k_scales=k_scales, v_scales=v_scales)


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
