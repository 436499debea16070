"""The port's PagedKVCacheManager against the JAX package's, float32 on
the CPU.

The same appends give the same bookkeeping (page tables, lengths, free
list, peak) and the same pages bit for bit; the same attends give the
same outputs within 1e-5 absolute (float32 softmax in another order).
Each port call runs both ways: booking and planning inside the pool, and
with a step the caller booked and planned (``book_ragged`` +
``ragged_step_inputs``, what the adapter does once per step for all its
layers). Inputs come from numpy with a seed.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.incubate.nn.paged_cache import PagedKVCacheManager as JaxPool
from paddle_tpu_torch.incubate.nn import PagedKVCacheManager

PAGE, NUM_PAGES, KVH, HD, NH, E = 4, 16, 2, 8, 4, 16
SEQS = ["a", "b", "c"]
# (sequences, tokens appended to each), a mix of chunks, decode rows and
# idle rows, crossing page boundaries
APPENDS = [(SEQS, [5, 1, 3]), (SEQS, [1, 4, 0]), (["b", "c"], [3, 6]),
           (["a", "c"], [1, 1])]
ATOL = 1e-5


def _pools(num_pages=NUM_PAGES):
    j = JaxPool(num_pages, PAGE, KVH, HD, dtype=jnp.float32)
    t = PagedKVCacheManager(num_pages, PAGE, KVH, HD, dtype=torch.float32,
                            device="cpu")
    for s in SEQS:
        j.alloc(s)
        t.alloc(s)
    return j, t


def _same_pool(j, t):
    assert t._tables == j._tables
    assert t._lens == j._lens
    assert t._free == j._free
    assert t.peak_used_pages == j.peak_used_pages
    np.testing.assert_array_equal(t.k_pages.numpy(), np.asarray(j.k_pages))
    np.testing.assert_array_equal(t.v_pages.numpy(), np.asarray(j.v_pages))


def _step(t, seqs, counts, caller_books, **kw):
    if not caller_books:
        return None
    t.book_ragged(seqs, counts)
    return t.ragged_step_inputs(seqs, counts, **kw)


def _append_all(j, t, caller_books, rng):
    for seqs, counts in APPENDS:
        k = rng.randn(sum(counts), KVH, HD).astype(np.float32)
        v = rng.randn(sum(counts), KVH, HD).astype(np.float32)
        j.append_ragged(seqs, counts, jnp.asarray(k), jnp.asarray(v))
        t.append_ragged(seqs, counts, torch.from_numpy(k),
                        torch.from_numpy(v),
                        step=_step(t, seqs, counts, caller_books))
        _same_pool(j, t)


@pytest.mark.parametrize("caller_books", [False, True])
def test_ragged_appends_match_reference(caller_books):
    j, t = _pools()
    _append_all(j, t, caller_books, np.random.RandomState(0))
    for s in ("b", "a"):
        j.free(s)
        t.free(s)
    _same_pool(j, t)


def test_append_batch_matches_reference():
    j, t = _pools()
    rng = np.random.RandomState(1)
    for _ in range(6):
        k = rng.randn(3, KVH, HD).astype(np.float32)
        v = rng.randn(3, KVH, HD).astype(np.float32)
        j.append_batch(SEQS, jnp.asarray(k), jnp.asarray(v))
        t.append_batch(SEQS, torch.from_numpy(k), torch.from_numpy(v))
        _same_pool(j, t)


def test_short_pool_books_nothing():
    """The capacity precheck runs before any bookkeeping changes, as in
    the reference: a short pool raises and stays as it was."""
    j, t = _pools(num_pages=3)
    kv = np.zeros((10, KVH, HD), np.float32)
    with pytest.raises(RuntimeError, match="exhausted"):
        j.append_ragged(SEQS, [5, 4, 1], jnp.asarray(kv), jnp.asarray(kv))
    with pytest.raises(RuntimeError, match="exhausted"):
        t.append_ragged(SEQS, [5, 4, 1], torch.from_numpy(kv),
                        torch.from_numpy(kv))
    with pytest.raises(RuntimeError, match="exhausted"):
        t.book_ragged(SEQS, [5, 4, 1])
    _same_pool(j, t)
    assert t.num_free_pages == 3 and t._lens == {s: 0 for s in SEQS}


@pytest.mark.parametrize("caller_books", [False, True])
@pytest.mark.parametrize("window", [0, 3])
def test_attend_ragged_matches_reference(window, caller_books):
    j, t = _pools()
    rng = np.random.RandomState(2)
    _append_all(j, t, False, rng)
    # the last append's rows, right-aligned in a (4, 4) block
    seqs, q_lens = SEQS, [2, 1, 4]
    q = rng.randn(4, 4, NH, HD).astype(np.float32)
    want = np.asarray(j.attend_ragged(
        jnp.asarray(q), seqs, q_lens, rows_pad=4, max_pages=8,
        window=window)._data)
    step = None
    if caller_books:
        step = t.ragged_step_inputs(seqs, q_lens, rows_pad=4, max_pages=8)
    got = t.attend_ragged(torch.from_numpy(q), seqs, q_lens, rows_pad=4,
                          max_pages=8, window=window, step=step).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_attend_matches_reference():
    j, t = _pools()
    rng = np.random.RandomState(3)
    _append_all(j, t, False, rng)
    q = rng.randn(3, NH, HD).astype(np.float32)
    want = np.asarray(j.attend(jnp.asarray(q), SEQS)._data)
    got = t.attend(torch.from_numpy(q), SEQS).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _fused_inputs(counts, lens0, n_pad, rng):
    """Small-integer activations and weights and quarter-integer RoPE
    tables, so every product is exact and pages compare bit for bit
    (XLA may fuse RoPE's multiply-add)."""
    x = rng.randint(-3, 4, (n_pad, E)).astype(np.float32)
    w = [rng.randint(-2, 3, (E, n * HD)).astype(np.float32)
         for n in (NH, KVH, KVH)]
    w.append(rng.randint(-2, 3, (NH * HD, E)).astype(np.float32))
    cos = (rng.randint(-4, 5, (64, HD)) / 4).astype(np.float32)
    sin = (rng.randint(-4, 5, (64, HD)) / 4).astype(np.float32)
    n_real = sum(counts)
    pos = np.zeros(n_pad, np.int32)
    gm = np.zeros((4, 4), np.int32)
    mr, mc, mf = [], [], []
    st = 0
    for r, (n, c) in enumerate(zip(lens0, counts)):
        pos[st:st + c] = np.arange(n, n + c)
        gm[r, 4 - c:] = np.arange(st, st + c)
        mr += [r] * c
        mc += list(range(4 - c, 4))
        mf += list(range(st, st + c))
        st += c
    assert st == n_real
    plan = tuple(np.asarray(a, np.int32) for a in (mr, mc, mf))
    return x, w, (cos, sin), pos, gm, plan


@pytest.mark.parametrize("caller_books", [False, True])
def test_fused_ragged_step_matches_reference(caller_books):
    j, t = _pools()
    rng = np.random.RandomState(4)
    _append_all(j, t, False, rng)
    counts = [2, 1, 3]
    lens0 = [t.seq_len(s) for s in SEQS]
    x, w, rope, pos, gm, plan = _fused_inputs(counts, lens0, 8, rng)
    want = j.fused_ragged_step(
        jnp.asarray(x), (*(jnp.asarray(a) for a in w), None),
        tuple(jnp.asarray(a) for a in rope), jnp.asarray(pos), SEQS,
        counts, jnp.asarray(gm), tuple(jnp.asarray(a) for a in plan),
        rows_pad=4, max_pages=8)
    tt = torch.from_numpy
    got = t.fused_ragged_step(
        tt(x), (*(tt(a) for a in w), None), tuple(tt(a) for a in rope),
        tt(pos.astype(np.int64)), SEQS, counts, tt(gm.astype(np.int64)),
        tuple(tt(a.astype(np.int64)) for a in plan), rows_pad=4,
        max_pages=8, step=_step(t, SEQS, counts, caller_books,
                                rows_pad=4, max_pages=8))
    _same_pool(j, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                               rtol=1e-5, atol=1e-3)
