"""The tiling of the CUDA dense flash kernels' M tiles, on the CPU.

``csrc/flash_attention.cu`` runs only on the card, so this file keeps a
line-for-line model of the parts of it that decide which (row, q head,
key) triples the dQ kernel (``flash_bwd_dq_wgmma``) and the forward
(``flash_fwd_wgmma``) compute: the band helpers (``key_band``, ``keep``,
``tile_full``), the blocks of NWG M tiles of 64 (row, q head) pairs (64
// group rows x the kv head's group of q heads) with the band of key
tiles each block walks, and the hooks (``DqBand``: live, full, kept; the
forward's ``FwdHook``: full, else -inf outside the band). A change to one
of those in the CUDA source changes the model here.

Against a brute-force enumeration of the kept pairs from the port's own
plain definition (``flash_attention._keep_mask``), every kept triple is
scored by exactly one step of one warpgroup and no other triple is: for
random Sq != Sk, windows, groups 1, 4 and 7 and Sq a multiple of no M
tile's rows.
"""
import numpy as np
import pytest

from paddle_tpu_torch.ops.kernels import flash_attention as pfa

TILE = 64  # keys a K/V tile; (row, q head) pairs an M tile


class Band:
    """The band helpers of flash_attention.cu for one shape."""

    def __init__(self, sq, sk, causal, window):
        self.sq, self.sk, self.causal = sq, sk, causal
        self.window = window if causal else 0

    def key_band(self, q_first, q_last):
        """keys [lo, hi] that some row of [q_first, q_last] keeps."""
        off = self.sk - self.sq
        lo, hi = 0, self.sk - 1
        if self.causal:
            hi = min(hi, q_last + off)
            if self.window > 0:
                lo = max(lo, q_first + off - self.window + 1)
        return lo, hi

    def keep(self, qi, ki):
        if not self.causal:
            return True
        d = qi + self.sk - self.sq - ki
        return d >= 0 and (self.window <= 0 or d < self.window)

    def tile_full(self, q0, q1, k0, k1):
        return self.keep(q0, k1) and self.keep(q1, k0)


def _kept(sq, sk, causal, window):
    """[sq, sk] bool: the pairs the plain version keeps."""
    keep = pfa._keep_mask(sq, sk, causal, window, "cpu")
    return np.ones((sq, sk), bool) if keep is None else keep.numpy()


def _blocks(bd, group, nwg):
    """Each block of flash_bwd_dq_wgmma / flash_fwd_wgmma: (its
    warpgroups' first rows, the key tiles of its band)."""
    rows = TILE // group
    for r0 in range(0, bd.sq, nwg * rows):
        klo, khi = bd.key_band(r0, min(r0 + nwg * rows, bd.sq) - 1)
        t_lo = klo // TILE
        n_tiles = khi // TILE - t_lo + 1 if khi >= klo else 0
        yield ([r0 + wg * rows for wg in range(nwg)],
               list(range(t_lo, t_lo + n_tiles)))


def _scored(bd, kernel, w0, rows, k0, row):
    """[64 pairs, 64 keys] bool: what one warpgroup's step on the key tile
    from k0 scores (None: the step is skipped). ``row``: each pair's row
    (Sq for a pair past the tile's rows x heads, as DqBand keeps it)."""
    w1 = min(w0 + rows, bd.sq) - 1
    keys = np.arange(k0, k0 + TILE)
    if kernel == "dq":  # DqBand
        lo, hi = bd.key_band(w0, w1)
        if not (w0 <= w1 and max(lo, k0) <= min(hi, k0 + TILE - 1)):
            return None  # not live
        if bd.tile_full(w0, w1, k0, k0 + TILE - 1) and k0 + TILE <= bd.sk:
            return np.ones((TILE, TILE), bool)
        return np.array([[r < bd.sq and c < bd.sk and bd.keep(r, c)
                          for c in keys] for r in row])
    # FwdHook: every tile of the band, -inf outside it unless full
    if bd.tile_full(w0, w1, k0, k0 + TILE - 1) and k0 + TILE <= bd.sk:
        return np.ones((TILE, TILE), bool)
    return np.array([[c < bd.sk and bd.keep(r, c) for c in keys]
                     for r in row])


def _cover(bd, group, nwg, kernel):
    """[Sq, group, Sk] int: the steps that score each (row, q head, key)
    triple, over the pairs that are written (the others are never)."""
    cover = np.zeros((bd.sq, group, bd.sk), np.int32)
    rows = TILE // group
    pair = np.arange(TILE)
    for w0s, tiles in _blocks(bd, group, nwg):
        for w0 in w0s:
            row = w0 + pair // group
            real = (pair < rows * group) & (row < bd.sq)
            row_of = np.where(real, row, bd.sq)
            for kt in tiles:
                k0 = kt * TILE
                scored = _scored(bd, kernel, w0, rows, k0, row_of)
                if scored is None:
                    continue
                keys = np.arange(k0, k0 + TILE)
                scored = scored[real]
                assert not scored[:, keys >= bd.sk].any(), "a key past Sk"
                inside = keys < bd.sk
                cover[row[real][:, None], (pair % group)[real][:, None],
                      keys[inside]] += scored[:, inside]
    return cover


def _cases():
    """(Sq, Sk, causal, window, group): random shapes with Sq != Sk,
    windows and groups 1/4/7, Sq a multiple of no M tile's rows where
    the group has more than one head, and the chip cases cut to size."""
    rng = np.random.RandomState(11)
    cases = []
    for i in range(12):
        group = (1, 4, 7)[i % 3]
        sq = int(rng.randint(1, 400))
        if group > 1 and sq % (TILE // group) == 0:
            sq += 1
        sk = sq if i % 4 == 0 else int(rng.randint(1, 400))
        causal = i % 5 != 4
        window = int(rng.randint(1, 200)) if causal and rng.rand() < 0.5 \
            else 0
        cases.append((sq, sk, causal, window, group))
    # group7_d128_window cut to size, rect_q256_k2048 and rect_q512_k128
    # (rows that see no key) cut to size, odd_rows
    cases += [(301, 301, True, 70, 7), (64, 500, True, 0, 7),
              (200, 50, True, 0, 4), (333, 333, True, 0, 4)]
    return cases


CASES = _cases()


@pytest.mark.parametrize("kernel", ["dq", "fwd"])
@pytest.mark.parametrize("nwg", [1, 2, 3])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_m_tiles_score_each_kept_triple_once(case, nwg, kernel):
    """flash_bwd_dq_wgmma ("dq") and flash_fwd_wgmma ("fwd"): every kept
    (row, q head, key) triple is scored by exactly one step, no other
    triple is, and no key past Sk is scored."""
    sq, sk, causal, window, group = CASES[case]
    bd = Band(sq, sk, causal, window)
    cover = _cover(bd, group, nwg, kernel)
    want = np.broadcast_to(_kept(sq, sk, causal, window)[:, None, :],
                           cover.shape).astype(np.int32)
    assert not cover[want == 0].any(), "a triple that is not kept is scored"
    assert np.array_equal(cover, want)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_band_helpers_match_the_plain_mask(case):
    """key_band is the hull of the kept keys of a run of rows (their
    union has no gap), and tile_full holds exactly when every pair of the
    tile is kept."""
    sq, sk, causal, window, _ = CASES[case]
    bd = Band(sq, sk, causal, window)
    keep = _kept(sq, sk, causal, window)
    rng = np.random.RandomState(case)
    for _ in range(40):
        q0 = int(rng.randint(0, sq))
        q1 = min(sq - 1, q0 + int(rng.randint(0, 80)))
        lo, hi = bd.key_band(q0, q1)
        seen = np.flatnonzero(keep[q0:q1 + 1].any(axis=0))
        if seen.size:
            assert (lo, hi) == (seen[0], seen[-1])
            assert seen.size == hi - lo + 1
        else:
            assert hi < lo
        k0 = int(rng.randint(0, sk))
        k1 = min(sk - 1, k0 + TILE - 1)
        assert bd.tile_full(q0, q1, k0, k1) == \
            bool(keep[q0:q1 + 1, k0:k1 + 1].all())
