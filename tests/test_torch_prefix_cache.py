"""The port's refcounted page pool and radix prefix tree against the JAX
package's, on the CPU.

Bookkeeping runs in lockstep: a seeded 1,000-operation fuzz (alloc,
attach, append, free, incref, decref, truncate, insert, match, pin,
evict) drives a port pool + tree and a JAX pool + tree alike, and after
every operation the pools' ``_tables``, ``_lens``, ``_free``,
``_refcnt``, ``_ext_refs`` and ``cow_forks`` must be identical. The JAX
side's pool elides its device copies, as the reference's own
``tests/test_prefix_cache.py`` ``HostPool`` does; the port's pool is
real (tiny float32 pages on the CPU). The tree cases repeat the
reference's tree tests on the port.

Bytes: after a copy-on-write fork and further appends, float32 pages
match the JAX pool's within 1e-6 and int8 pages and scale rows bit for
bit (the same K/V fed to both). The same-step case: sequence A forks a
page that B, its only other holder, writes in place in the same call;
the fork's copy must be issued before B's write, in the pool and
through the adapter's fused step.
"""
import collections
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.incubate.nn import PagedKVCacheManager as JaxPool
from paddle_tpu.inference import PagedLlamaAdapter as JaxAdapter
from paddle_tpu.inference import RadixPrefixCache as JaxTree

from paddle_tpu_torch.incubate.nn import PagedKVCacheManager
from paddle_tpu_torch.inference import PagedLlamaAdapter, RadixPrefixCache
from paddle_tpu_torch.inference.prefix_cache import PrefixMatch

from test_torch_llama_serving import _pair, ragged_mode

PAGE = 4
HEADS, HDIM = 2, 8


class HostPool(JaxPool):
    """The reference pool with its device writes elided, as the
    reference's ``tests/test_prefix_cache.py`` ``HostPool``."""

    def __init__(self, num_pages=32, page_size=PAGE, kv_dtype="float32"):
        super().__init__(num_pages, page_size, kv_heads=1, head_dim=2,
                         dtype=jnp.float32, kv_dtype=kv_dtype)

    def _copy_page(self, dst, src):
        pass

    def append_host(self, seq_id, n=1):
        for _ in range(n):
            self._next_slot(seq_id)
            self._lens[seq_id] += 1


def _port_pool(num_pages=32, page_size=PAGE, kv_dtype="float32",
               heads=1, hdim=2):
    return PagedKVCacheManager(num_pages, page_size, heads, hdim,
                               kv_dtype=kv_dtype, device="cpu")


def _book(pool, sid, n):
    """The port's booking of ``n`` tokens (no device write)."""
    pool.book_ragged([sid], [n])


def _same_books(jp, tp):
    assert tp._tables == jp._tables
    assert tp._lens == jp._lens
    assert tp._free == jp._free
    assert tp._refcnt == jp._refcnt
    assert tp._ext_refs == jp._ext_refs
    assert tp.cow_forks == jp.cow_forks


# ---------------------------------------------------------------- fuzz
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_bookkeeping_lockstep_over_1000_random_ops(kv):
    jp, tp = HostPool(48, kv_dtype=kv), _port_pool(48, kv_dtype=kv)
    jt, tt = JaxTree([jp]), RadixPrefixCache([tp])
    rng = random.Random(0)
    # a library of shared prefixes forces splits, shared boundary pages
    # and deep chains
    prefixes = [[1, 2, 3, 4], [1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 9, 9],
                [7], [1, 2, 3, 4, 5, 6]]
    active = {}   # sid -> [tokens, pinned paths (jax, port)]
    held = []     # pages incref'd by a holder outside the tree
    next_id = 0
    counts = collections.Counter()

    def check():
        _same_books(jp, tp)
        tp.assert_ref_invariants()
        assert tt.summary() == jt.summary()

    for _ in range(1000):
        op = rng.random()
        if op < 0.25 and len(active) < 8:  # admit through the tree
            toks = (list(rng.choice(prefixes))
                    + [rng.randrange(2, 30)
                       for _ in range(rng.randrange(0, 6))])
            align = rng.choice([1, 1, PAGE])
            jm = jt.match(toks, limit=len(toks) - 1, align=align)
            tm = tt.match(toks, limit=len(toks) - 1, align=align)
            assert (tm.length, tm.chains) == (jm.length, jm.chains)
            need = (-(-len(toks) // PAGE)) - tm.length // PAGE + 1
            if tp.num_free_pages < need:
                freed = tt.evict(need - tp.num_free_pages)
                assert jt.evict(need - jp.num_free_pages) == freed
            if tp.num_free_pages < need:
                continue
            jt.pin(jm.path)
            tt.pin(tm.path)
            sid = f"s{next_id}"
            next_id += 1
            if tm.length:
                jp.attach(sid, jm.chains[0], jm.length)
                tp.attach(sid, tm.chains[0], tm.length)
            else:
                jp.alloc(sid)
                tp.alloc(sid)
            n = len(toks) - tm.length
            jp.append_host(sid, n)
            _book(tp, sid, n)
            active[sid] = [toks, (jm.path, tm.path)]
            counts["attach" if tm.length else "alloc"] += 1
        elif op < 0.40 and active:  # append (decode-like growth)
            sid = rng.choice(sorted(active))
            n = rng.randrange(1, 4)
            need = tp.ragged_pages_needed([sid], [n])
            assert jp.ragged_pages_needed([sid], [n]) == need
            if need > tp.num_free_pages:
                continue
            jp.append_host(sid, n)
            _book(tp, sid, n)
            active[sid][0] += [rng.randrange(2, 30) for _ in range(n)]
            counts["append"] += 1
        elif op < 0.48 and active:  # truncate (a rolled-back window)
            sid = rng.choice(sorted(active))
            n = rng.randrange(0, tp.seq_len(sid) + 1)
            jp.truncate(sid, n)
            tp.truncate(sid, n)
            active[sid][0] = active[sid][0][:n]
            counts["truncate"] += 1
        elif op < 0.70 and active:  # retire: insert, unpin, free
            sid = rng.choice(sorted(active))
            toks, (jpath, tpath) = active.pop(sid)
            if rng.random() < 0.8:
                got = tt.insert(toks, [tp.seq_pages(sid)])
                assert jt.insert(toks, [jp.seq_pages(sid)]) == got
                counts["insert"] += 1
            jt.unpin(jpath)
            tt.unpin(tpath)
            jp.free(sid)
            tp.free(sid)
            counts["free"] += 1
        elif op < 0.78:  # an outside holder takes or drops a page
            live = [p for p in range(tp.num_pages) if tp._refcnt[p]]
            if held and (rng.random() < 0.5 or not live):
                p = held.pop(rng.randrange(len(held)))
                assert tp.decref([p]) == jp.decref([p])
                counts["decref"] += 1
            elif live:
                p = rng.choice(live)
                jp.incref([p])
                tp.incref([p])
                held.append(p)
                counts["incref"] += 1
        elif op < 0.88:  # a lookup alone (LRU touch)
            toks = list(rng.choice(prefixes)) + [rng.randrange(2, 30)]
            jm, tm = jt.match(toks), tt.match(toks)
            assert (tm.length, tm.chains) == (jm.length, jm.chains)
            counts["match"] += 1
        else:  # eviction pressure
            k = rng.randrange(1, 8)
            assert tt.evict(k) == jt.evict(k)
            counts["evict"] += 1
        check()

    assert min(counts.values()) > 10, counts
    assert tp.cow_forks > 10
    for sid in sorted(active):
        _, (jpath, tpath) = active.pop(sid)
        jt.unpin(jpath)
        tt.unpin(tpath)
        jp.free(sid)
        tp.free(sid)
    assert tp.decref(held) == jp.decref(held)
    assert tt.clear() == jt.clear()
    check()
    assert tp.num_free_pages == tp.num_pages


# ---------------------------------------------------------- radix tree
def _cache_seq(pool, tree, tokens, sid="src"):
    """One sequence through the pool, published in the tree (what the
    scheduler does at retire)."""
    pool.alloc(sid)
    _book(pool, sid, len(tokens))
    tree.insert(list(tokens), [pool.seq_pages(sid)])
    pool.free(sid)


def test_match_longest_prefix_and_limit():
    pool = _port_pool()
    tree = RadixPrefixCache([pool])
    _cache_seq(pool, tree, [1, 2, 3, 4, 5, 6])
    m = tree.match([1, 2, 3, 4, 5, 6, 7, 8])
    assert isinstance(m, PrefixMatch)
    assert m.length == 6 and len(m.chains[0]) == 2
    assert tree.match([1, 2, 9]).length == 2
    assert tree.match([9, 9]).length == 0
    assert tree.match([1, 2, 3, 4, 5, 6], limit=5).length == 5
    aligned = tree.match([1, 2, 3, 4, 5, 6, 7], align=PAGE)
    assert aligned.length == 4 and len(aligned.chains[0]) == 1


def test_mid_page_split_shares_boundary_page():
    pool = _port_pool()
    tree = RadixPrefixCache([pool])
    _cache_seq(pool, tree, [1, 2, 3, 4, 5, 6], "s0")
    chain0 = tree.match([1, 2, 3, 4, 5, 6]).chains[0]
    m = tree.match([1, 2, 3, 9, 9], limit=4)
    assert m.length == 3
    tree.pin(m.path)
    pool.attach("s1", m.chains[0], 3)
    _book(pool, "s1", 2)
    assert pool.cow_forks == 1
    tree.insert([1, 2, 3, 9, 9], [pool.seq_pages("s1")])
    tree.unpin(m.path)
    pool.free("s1")
    a = tree.match([1, 2, 3, 4, 5, 6])
    b = tree.match([1, 2, 3, 9, 9])
    assert a.length == 6 and b.length == 5
    assert a.chains[0] == chain0
    assert b.chains[0][0] != a.chains[0][0]  # the forked copy
    # the upper node keeps chain0's first page, now also referenced by
    # the split's lower half
    assert pool._refcnt[chain0[0]] == 2
    pool.assert_ref_invariants()


def test_insert_existing_prefix_is_noop():
    pool = _port_pool()
    tree = RadixPrefixCache([pool])
    _cache_seq(pool, tree, [1, 2, 3, 4], "s0")
    before = tree.cached_pages
    pool.alloc("s1")
    _book(pool, "s1", 3)
    assert tree.insert([1, 2, 3], [pool.seq_pages("s1")]) == 0
    pool.free("s1")
    assert tree.cached_pages == before
    pool.assert_ref_invariants()


def test_mismatched_page_sizes_rejected():
    with pytest.raises(ValueError, match="page sizes differ"):
        RadixPrefixCache([_port_pool(page_size=4), _port_pool(page_size=8)])


def _two_branches():
    pool = _port_pool()
    tree = RadixPrefixCache([pool])
    _cache_seq(pool, tree, [0, 1, 2, 3, 4, 5, 6, 7], "a")
    _cache_seq(pool, tree, [0, 1, 2, 3, 8, 9, 10, 11], "b")
    return pool, tree


def test_lru_leaf_eviction_frees_pages():
    pool, tree = _two_branches()
    assert pool.num_free_pages == pool.num_pages - tree.cached_pages
    tree.match([0, 1, 2, 3, 8, 9, 10, 11])  # the other leaf is LRU now
    assert tree.evict(1) >= 1
    assert tree.match([0, 1, 2, 3, 4, 5, 6, 7]).length == 4
    assert tree.match([0, 1, 2, 3, 8, 9, 10, 11]).length == 8
    pool.assert_ref_invariants()


def test_pinned_chain_never_reclaimed():
    pool, tree = _two_branches()
    m = tree.match([0, 1, 2, 3, 4, 5, 6, 7])
    tree.pin(m.path)
    tree.evict(10 ** 6)
    assert tree.match([0, 1, 2, 3, 4, 5, 6, 7]).length == 8
    assert tree.match([0, 1, 2, 3, 8, 9, 10, 11]).length == 4
    assert all(pool._refcnt[p] > 0 for p in m.chains[0])
    tree.unpin(m.path)
    with pytest.raises(AssertionError, match="unpinned"):
        tree.unpin(m.path)
    tree.evict(10 ** 6)
    assert tree.num_nodes == 0
    assert pool.num_free_pages == pool.num_pages
    pool.assert_ref_invariants()


def test_clear_flushes_everything_unpinned():
    pool, tree = _two_branches()
    assert tree.mutations == 2
    tree.clear()
    # two leaves, then their parent (the split's upper half)
    assert tree.num_nodes == 0 and tree.mutations == 5
    assert pool.num_free_pages == pool.num_pages
    s = tree.summary()
    assert (s["inserted_nodes"], s["evicted_nodes"], s["nodes"]) == (2, 3, 0)
    pool.assert_ref_invariants()


def test_pool_refusals_match_reference():
    pool = _port_pool()
    pool.alloc("a")
    _book(pool, "a", 4)
    chain = pool.seq_pages("a")
    pool.free("a")
    with pytest.raises(KeyError, match="double-free"):
        pool.free("a")
    with pytest.raises(ValueError, match="free list"):
        pool.attach("b", chain, 4)
    with pytest.raises(ValueError, match="span"):
        pool.attach("b", [], 4)
    with pytest.raises(ValueError, match="resurrect"):
        pool.incref(chain)
    with pytest.raises(ValueError, match="no external reference"):
        pool.decref([0])


# --------------------------------------------------------------- bytes
def _pools(kv, num_pages=16):
    jpool = JaxPool(num_pages, PAGE, HEADS, HDIM, dtype=jnp.float32,
                    kv_dtype=kv)
    tpool = PagedKVCacheManager(num_pages, PAGE, HEADS, HDIM,
                                dtype=torch.float32, kv_dtype=kv,
                                device="cpu")
    return jpool, tpool


def _append_both(jpool, tpool, sids, counts, rng):
    n = sum(counts)
    k = rng.randn(n, HEADS, HDIM).astype(np.float32)
    v = rng.randn(n, HEADS, HDIM).astype(np.float32)
    jpool.append_ragged(sids, counts, jnp.asarray(k), jnp.asarray(v))
    tpool.append_ragged(sids, counts, torch.from_numpy(k),
                        torch.from_numpy(v))


def _same_bytes(jpool, tpool):
    _same_books(jpool, tpool)
    pairs = [(jpool.k_pages, tpool.k_pages), (jpool.v_pages, tpool.v_pages)]
    if tpool.quantized:
        pairs += [(jpool.k_scales, tpool.k_scales),
                  (jpool.v_scales, tpool.v_scales)]
        for j, t in pairs:
            assert np.array_equal(np.asarray(j), t.numpy())
    else:
        for j, t in pairs:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_fork_bytes_match_reference(kv):
    """A shares its 6-token chain with B; B's write forks the partial
    page (the int8 scale row goes with it), then both grow apart."""
    jpool, tpool = _pools(kv)
    rng = np.random.RandomState(3)
    for p in (jpool, tpool):
        p.alloc("a")
    _append_both(jpool, tpool, ["a"], [6], rng)
    for p in (jpool, tpool):
        p.attach("b", p.seq_pages("a"), 6)
    assert tpool.pending_cow("b") and tpool.num_shared_pages == 2
    _append_both(jpool, tpool, ["b"], [3], rng)
    assert tpool.cow_forks == 1 and not tpool.pending_cow("a")
    _append_both(jpool, tpool, ["a", "b"], [2, 5], rng)
    _same_bytes(jpool, tpool)
    tpool.assert_ref_invariants()


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_same_step_fork_then_in_place_write(kv):
    """A and B share a partial page p; in ONE append, A forks p and B,
    then p's only holder, writes p in place. A's copy must hold p's
    bytes from BEFORE B's write."""
    jpool, tpool = _pools(kv)
    rng = np.random.RandomState(4)
    for p in (jpool, tpool):
        p.alloc("src")
    _append_both(jpool, tpool, ["src"], [6], rng)
    before = tpool.k_pages[tpool.seq_pages("src")[1]].clone()
    for p in (jpool, tpool):
        chain = p.seq_pages("src")
        p.attach("a", chain, 6)
        p.attach("b", chain, 6)
        p.free("src")
    shared = tpool.seq_pages("a")[1]
    _append_both(jpool, tpool, ["a", "b"], [2, 2], rng)
    assert tpool.cow_forks == 1
    assert tpool.seq_pages("b")[1] == shared      # written in place
    fork = tpool.seq_pages("a")[1]
    assert fork != shared
    if not tpool.quantized:  # int8 codes may be requantized by the write
        assert torch.equal(tpool.k_pages[fork, :2], before[:2])
    _same_bytes(jpool, tpool)
    tpool.assert_ref_invariants()


@pytest.mark.parametrize("mode,kv", [("auto", None), ("on", "int8"),
                                     ("off", None)])
def test_same_step_fork_through_the_adapter(mode, kv):
    """The same case one level up: two sequences on one cached 6-token
    chain advance in one ``prefill_chunk`` call (under ``auto`` the
    fused step's page scatter must land on the fork). Logits within
    1e-4 of the JAX adapter's; pools identical."""
    jm, tm = _pair("base")
    kw = dict(num_pages=24, page_size=PAGE, max_length=64,
              kv_cache_dtype=kv)
    ja, ta = JaxAdapter(jm, **kw), PagedLlamaAdapter(tm, **kw)
    rng = np.random.RandomState(9)
    with ragged_mode(mode):
        src = rng.randint(1, 500, 6).tolist()
        for ad in (ja, ta):
            ad.alloc("src")
            ad.prefill_chunk([src], ["src"], [0])
            chains = ad.seq_page_chains("src")
            ad.attach_prefix("a", chains, 6)
            ad.attach_prefix("b", chains, 6)
            ad.free("src")
        for counts in ([3, 1], [1, 1], [5, 1]):
            toks = [rng.randint(1, 500, c).tolist() for c in counts]
            starts = [ta.caches[0].seq_len(s) for s in ("a", "b")]
            j = ja.prefill_chunk(toks, ["a", "b"], starts, pad_to=8)
            t = ta.prefill_chunk(toks, ["a", "b"], starts, pad_to=8)
            np.testing.assert_allclose(t.numpy(), np.asarray(j._data),
                                       atol=1e-4, rtol=0)
            for jc, tc in zip(ja.caches, ta.caches):
                _same_books(jc, tc)
                tc.assert_ref_invariants()
    assert all(c.cow_forks == 1 for c in ta.caches)
