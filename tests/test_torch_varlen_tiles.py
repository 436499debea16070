"""The tiling of the CUDA varlen kernels, on the CPU.

``csrc/flash_varlen.cu`` runs only on the card, so this file keeps a
line-for-line model of the parts of it that decide which (row, key)
pairs a block computes: the segment helpers (``seg_of``, ``row_keys``,
``key_rows``, ``row_interval``, ``key_interval``), the walks
(``KeyTiles``, ``QueryTiles<64>`` and their ``count``), the hull that
makes a tile live or full (``Intervals``), the order of the dK/dV key
tiles, and the M tiles of the dQ and forward kernels. A change to one of
those in the CUDA source changes the model here.

Against a brute-force enumeration of the kept pairs from the port's own
plain definition (``flash_varlen.segments``: same segment and, with
causal, loc_q >= loc_k), every kept pair is computed by exactly one step
of one warpgroup, and a tile that runs unmasked (full) holds only kept
pairs: for random boundaries with empty segments, tails past cu[-1] and
cu_q != cu_k.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_varlen as pfv

TILE = 64  # keys a K/V tile and rows a Q tile; keys a dK/dV warpgroup


class Segs:
    """The segment helpers of flash_varlen.cu over one set of
    boundaries."""

    def __init__(self, cu_q, cu_k, tq, tk, causal):
        self.cu_q, self.cu_k = list(cu_q), list(cu_k)
        self.b = len(cu_q) - 1
        self.tq, self.tk, self.causal = tq, tk, causal

    def seg_of(self, cu, t):
        return sum(1 for j in range(1, self.b + 1) if cu[j] <= t)

    def seg_beg(self, cu, s, t):
        return 0 if s == 0 else min(max(cu[s], 0), t)

    def seg_end(self, cu, s, t):
        return t if s == self.b else min(max(cu[s + 1], 0), t)

    def row_keys(self, s, q):
        lo = self.seg_beg(self.cu_k, s, self.tk)
        hi = self.seg_end(self.cu_k, s, self.tk) - 1
        if self.causal:
            hi = min(hi, self.cu_k[s] + q - self.cu_q[s])
        return lo, hi

    def key_rows(self, s, k):
        lo = self.seg_beg(self.cu_q, s, self.tq)
        hi = self.seg_end(self.cu_q, s, self.tq) - 1
        if self.causal:
            lo = max(lo, self.cu_q[s] + k - self.cu_k[s])
        return lo, hi

    def row_interval(self, q):
        if q >= self.tq:
            return 0, -1
        return self.row_keys(self.seg_of(self.cu_q, q), q)

    def key_interval(self, k):
        if k >= self.tk:
            return 0, -1
        return self.key_rows(self.seg_of(self.cu_k, k), k)

    def key_tiles(self, q0, q1):
        """KeyTiles(p, q0, q1): its tiles, and its count()."""
        return _walked(lambda: KeyTiles(self, q0, q1))

    def query_tiles(self, k0, k1):
        """QueryTiles<64>(p, k0, k1): its tiles, and its count()."""
        return _walked(lambda: QueryTiles(self, k0, k1))

    def hull(self, first, last, n, interval):
        """Intervals::hull: (l_lo, l_hi, f_lo, f_hi)."""
        if first >= n:
            return 1, -1, 1, -1
        l_lo, f_hi = interval(first)
        f_lo, l_hi = interval(min(last, n - 1))
        return min(l_lo, f_hi + 1), l_hi, min(f_lo, l_hi + 1), f_hi


class KeyTiles:
    """KeyTiles: the key tiles that rows [q0, q1] keep, in order."""

    def __init__(self, sg, q0, q1):
        self.sg, self.q0, self.q1 = sg, q0, q1
        self.s = sg.seg_of(sg.cu_q, q0) - 1
        self.s_last = sg.seg_of(sg.cu_q, q1)
        self.kt = self.t_hi = -1

    def next(self):
        sg, nk = self.sg, self.kt + 1
        while nk > self.t_hi:
            if self.s >= self.s_last:
                return -1
            self.s += 1
            r_last = min(self.q1, sg.seg_end(sg.cu_q, self.s, sg.tq) - 1)
            if r_last < max(self.q0, sg.seg_beg(sg.cu_q, self.s, sg.tq)):
                continue
            lo, hi = sg.row_keys(self.s, r_last)
            if hi < lo:
                continue
            self.t_hi = hi // TILE
            nk = max(nk, lo // TILE)
        self.kt = nk
        return nk

    def count(self):
        n = 0
        while self.next() >= 0:
            n += self.t_hi - self.kt + 1
            self.kt = self.t_hi
        return n


class QueryTiles:
    """QueryTiles<64>: the q tiles that keep some key of [k0, k1], in
    order."""

    def __init__(self, sg, k0, k1):
        self.sg, self.k0, self.k1 = sg, k0, k1
        self.s = sg.seg_of(sg.cu_k, k0) - 1
        self.s_last = sg.seg_of(sg.cu_k, k1)
        self.qt = self.t_hi = -1

    def next(self):
        sg, nq = self.sg, self.qt + 1
        while nq > self.t_hi:
            if self.s >= self.s_last:
                return -1
            self.s += 1
            k_first = max(self.k0, sg.seg_beg(sg.cu_k, self.s, sg.tk))
            if min(self.k1, sg.seg_end(sg.cu_k, self.s, sg.tk) - 1) < \
                    k_first:
                continue
            lo, hi = sg.key_rows(self.s, k_first)
            if hi < lo:
                continue
            self.t_hi = hi // TILE
            nq = max(nq, lo // TILE)
        self.qt = nq
        return nq

    def count(self):
        n = 0
        while self.next() >= 0:
            n += self.t_hi - self.qt + 1
            self.qt = self.t_hi
        return n


def _walked(make):
    """(the tiles of a fresh walk one next() at a time, the count() of
    another): the producer's and the consumers' views."""
    walk, tiles = make(), []
    while (t := walk.next()) >= 0:
        tiles.append(t)
    return tiles, make().count()


def _kept(cu_q, cu_k, tq, tk, causal):
    """[tq, tk] bool: the pairs the plain version keeps."""
    seg_q, loc_q = pfv.segments(torch.tensor(cu_q), tq)
    seg_k, loc_k = pfv.segments(torch.tensor(cu_k), tk)
    keep = seg_q[:, None] == seg_k[None, :]
    if causal:
        keep &= loc_q[:, None] >= loc_k[None, :]
    return keep.numpy()


def _step(cover, bad, keep, rows, keys, live, full, kept):
    """Adds one step of one warpgroup: its rows x keys (clipped to the
    tensors), computed where live and (full or kept by the thread's
    interval)."""
    if not live:
        return
    if full:
        cover[rows, keys] += 1
        bad[rows, keys] |= ~keep[rows, keys]
    else:
        cover[rows, keys] += kept


def _boundaries(rng):
    """(cu_q, cu_k, tq, tk): random segments, some empty, and tails."""
    b = int(rng.randint(1, 7))
    lens_q = rng.randint(0, 160, size=b)
    if rng.rand() < 0.5:
        lens_k = lens_q.copy()
    else:
        lens_k = rng.randint(0, 160, size=b)
    lens_q[rng.rand(b) < 0.15] = 0
    lens_k[rng.rand(b) < 0.15] = 0
    cu_q = [0] + np.cumsum(lens_q).tolist()
    cu_k = [0] + np.cumsum(lens_k).tolist()
    tail = int(rng.randint(0, 40)) if rng.rand() < 0.5 else 0
    tq = max(cu_q[-1] + tail, 1)
    tk = max(cu_k[-1] + tail, 1)
    return cu_q, cu_k, tq, tk


def _cases():
    rng = np.random.RandomState(7)
    cases = [_boundaries(rng) + (bool(i % 3),) for i in range(16)]
    # the CUDA cases' shapes, cut to size: cu_q != cu_k, an empty k
    # segment, tiny documents, tiles on the documents' edges
    cases += [([0, 300, 800, 1024], [0, 600, 700, 1024], 1024, 1024, True),
              ([0, 200, 500, 600], [0, 400, 400, 600], 600, 600, True),
              ([0] + list(range(8, 520, 8)), [0] + list(range(8, 520, 8)),
               512, 512, True),
              ([0, 64, 192, 256, 448], [0, 64, 192, 256, 448], 448, 448,
               True)]
    return cases


CASES = _cases()


@pytest.mark.parametrize("nwg", [1, 2])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dkdv_steps_cover_each_kept_pair_once(case, nwg):
    """varlen_bwd_dkdv_wgmma: blocks of 64 * nwg keys, each warpgroup's
    64 keys against the q tiles of the block's walk."""
    cu_q, cu_k, tq, tk, causal = CASES[case]
    sg = Segs(cu_q, cu_k, tq, tk, causal)
    keep = _kept(cu_q, cu_k, tq, tk, causal)
    cover = np.zeros((tq, tk), np.int32)
    bad = np.zeros((tq, tk), bool)
    bk = TILE * nwg
    for k0 in range(0, tk, bk):
        tiles, count = sg.query_tiles(k0, min(k0 + bk, tk) - 1)
        assert count == len(tiles) and tiles == sorted(set(tiles))
        for wg in range(nwg):
            kw0 = k0 + TILE * wg
            l_lo, l_hi, f_lo, f_hi = sg.hull(kw0, kw0 + TILE - 1, tk,
                                             sg.key_interval)
            keys = slice(kw0, min(kw0 + TILE, tk))
            if keys.stop <= keys.start:  # a warpgroup past the keys
                continue
            iv = [sg.key_interval(k) for k in range(keys.start, keys.stop)]
            for qt in tiles:
                q0 = qt * TILE
                rows = slice(q0, min(q0 + TILE, tq))
                q = np.arange(rows.start, rows.stop)[:, None]
                kept = np.stack([(q[:, 0] >= lo) & (q[:, 0] <= hi)
                                 for lo, hi in iv], axis=1)
                _step(cover, bad, keep, rows, keys,
                      q0 <= l_hi and q0 + TILE - 1 >= l_lo,
                      f_lo <= q0 and q0 + TILE - 1 <= f_hi, kept)
    assert not bad.any(), "a full tile holds a pair that is not kept"
    assert np.array_equal(cover, keep.astype(np.int32))


def _m_tile_pairs(sg, w0, rows_m, group):
    """One warpgroup's M tile: (row, head, lo, hi, real) per pair. Pair p
    is row w0 + p // group, q head p % group of the kv head's group; a
    pair past the tile's rows x heads or a row past Tq is not real: its
    interval is empty and it is never written."""
    pair = np.arange(TILE)
    row, head = w0 + pair // group, pair % group
    real = (pair < rows_m * group) & (row < sg.tq)
    iv = [sg.row_interval(int(r)) if ok else (0, -1)
          for r, ok in zip(row, real)]
    lo, hi = (np.array(x) for x in zip(*iv))
    return row, head, lo, hi, real


@pytest.mark.parametrize("kernel", ["dq", "fwd"])
@pytest.mark.parametrize("group,nwg", [(7, 3), (4, 2), (1, 1)])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dq_steps_cover_each_kept_pair_once(case, group, nwg, kernel):
    """The M-tile kernels, varlen_bwd_dq_wgmma ("dq") and varlen_fwd_wgmma
    ("fwd"): M tiles of 64 (row, q head) pairs, 64 // group rows x the
    group's heads, nwg of them a block, against the key tiles of the block
    rows' walk. The dQ warpgroups skip a tile that is not live; the
    forward's run every tile of the walk. Both score a tile unmasked where
    the warpgroup's hull encloses it (full) and else only each pair's own
    interval (the forward sets the rest to -inf). Every kept (row, head,
    key) triple is scored by exactly one step, and no other triple."""
    cu_q, cu_k, tq, tk, causal = CASES[case]
    sg = Segs(cu_q, cu_k, tq, tk, causal)
    keep = _kept(cu_q, cu_k, tq, tk, causal)
    cover = np.zeros((tq, group, tk), np.int32)
    rows_m = TILE // group
    for r0 in range(0, tq, nwg * rows_m):
        tiles, count = sg.key_tiles(r0, min(r0 + nwg * rows_m, tq) - 1)
        assert count == len(tiles) and tiles == sorted(set(tiles))
        for wg in range(nwg):
            w0 = r0 + wg * rows_m
            l_lo, l_hi, f_lo, f_hi = sg.hull(w0, w0 + rows_m - 1, tq,
                                             sg.row_interval)
            row, head, lo, hi, real = _m_tile_pairs(sg, w0, rows_m, group)
            for kt in tiles:
                k0 = kt * TILE
                live = k0 <= l_hi and k0 + TILE - 1 >= l_lo
                if kernel == "dq" and not live:
                    continue
                keys = np.arange(k0, k0 + TILE)
                if f_lo <= k0 and k0 + TILE - 1 <= f_hi:  # full
                    scored = np.ones((TILE, TILE), bool)
                else:
                    scored = (keys >= lo[:, None]) & (keys <= hi[:, None])
                scored = scored[real]
                assert not scored[:, keys >= tk].any(), "a key past Tk"
                inside = keys < tk
                cover[row[real][:, None], head[real][:, None],
                      keys[inside]] += scored[:, inside]
    want = np.broadcast_to(keep[:, None, :], cover.shape).astype(np.int32)
    assert not (cover[~want.astype(bool)]).any(), \
        "a triple that is not kept is scored"
    assert np.array_equal(cover, want)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_dkdv_tile_order_is_a_permutation_by_work(case):
    """The dK/dV blocks' order: block r takes the tile of rank r, more
    work (q tiles of its walk) first, then the lower index."""
    cu_q, cu_k, tq, tk, causal = CASES[case]
    sg = Segs(cu_q, cu_k, tq, tk, causal)
    bk = 2 * TILE
    work = [sg.query_tiles(k0, min(k0 + bk, tk) - 1)[1]
            for k0 in range(0, tk, bk)]
    rank = [sum(1 for j, wj in enumerate(work)
                if wj > wi or (wj == wi and j < i))
            for i, wi in enumerate(work)]
    order = [rank.index(r) for r in range(len(work))]
    assert sorted(order) == list(range(len(work)))
    assert all(work[a] >= work[b] for a, b in zip(order, order[1:]))
