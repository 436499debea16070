"""Preemption with a host swap tier, priority / deadline / tenant
admission and the prefix cache in the port's scheduler, against the
JAX package's, on the CPU.

Pool level: swap round trips restore a sequence's pages bit for bit
(float32 and int8 pools, payload and scale rows), keep shared pages on
the device under a hold, reserve what ``swap_in_pages_needed`` says,
refuse a full space atomically (``SwapSpaceFull``), release holds on
``swap_discard``, and share one space between layer pools; every step
is held against the JAX pool fed the same K/V (books identical, bytes
bit for bit).

Scheduler level: ``BatchScheduler`` over ``PagedLlamaAdapter`` steps in
lockstep with the JAX one on ``llama_tiny``-shaped models whose weights
come through ``load_reference_state`` (``_pair`` of
``tests/test_torch_llama_serving.py``), both given the same
``swap_bytes``: every step's event dict is equal (``prefix_hit_tokens``,
``preempted``, ``resumed``, ``aborted`` included), the pools' books are
equal after every step, the logits of every model call agree within
1e-4 (float32 through two layers), the greedy streams and terminal
states are identical, and ``assert_ref_invariants()`` holds on every
pool. Deadlines run on a fake clock patched into both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.framework import telemetry
from paddle_tpu.incubate.nn import PagedKVCacheManager as JaxPool
from paddle_tpu.incubate.nn.paged_cache import \
    HostKVSwapSpace as JaxSpace
from paddle_tpu.inference import BatchScheduler as JaxScheduler
from paddle_tpu.inference import PagedLlamaAdapter as JaxAdapter
from paddle_tpu.inference import QueueFullError as JaxQueueFull
from paddle_tpu.inference import Request as JaxRequest

from paddle_tpu_torch.incubate.nn import PagedKVCacheManager
from paddle_tpu_torch.incubate.nn.paged_cache import (HostKVSwapSpace,
                                                      SwapSpaceFull)
from paddle_tpu_torch.inference import (BatchScheduler, PagedLlamaAdapter,
                                        QueueFullError, Request,
                                        RequestState)
from paddle_tpu_torch.inference import serving

from test_torch_llama_serving import _pair, ragged_mode

PAGE = 4
HEADS, HDIM = 2, 8
ATOL = 1e-4
SWAP = 64 << 20


# ----------------------------------------------------------- pool level
class Both:
    """A port pool and a JAX pool driven alike, with one swap space
    each; ``fill`` feeds both the same K/V."""

    def __init__(self, kv=None, num_pages=24):
        self.j = JaxPool(num_pages, PAGE, HEADS, HDIM, dtype=jnp.float32,
                         kv_dtype=kv)
        self.t = PagedKVCacheManager(num_pages, PAGE, HEADS, HDIM,
                                     dtype=torch.float32, kv_dtype=kv,
                                     device="cpu")
        self.js, self.ts = JaxSpace(SWAP), HostKVSwapSpace(SWAP)
        self.rng = np.random.RandomState(0)

    def fill(self, sid, n, alloc=True):
        k = self.rng.randn(n, HEADS, HDIM).astype(np.float32)
        v = self.rng.randn(n, HEADS, HDIM).astype(np.float32)
        if alloc:
            self.j.alloc(sid)
            self.t.alloc(sid)
        self.j.append_ragged([sid], [n], jnp.asarray(k), jnp.asarray(v))
        self.t.append_ragged([sid], [n], torch.from_numpy(k),
                             torch.from_numpy(v))

    def both(self, name, *args):
        """Call pool method ``name`` on both (swap methods get their own
        space after the sequence id); returns the port's result, checked
        equal."""
        if name.startswith("swap"):
            jr = getattr(self.j, name)(args[0], self.js, *args[1:])
            tr = getattr(self.t, name)(args[0], self.ts, *args[1:])
        else:
            jr = getattr(self.j, name)(*args)
            tr = getattr(self.t, name)(*args)
        assert tr == jr, (name, tr, jr)
        return tr

    def check(self):
        j, t = self.j, self.t
        assert (t._tables, t._lens, t._free, t._refcnt, t._ext_refs,
                t.cow_forks) == (j._tables, j._lens, j._free, j._refcnt,
                                 j._ext_refs, j.cow_forks)
        pairs = [(j.k_pages, t.k_pages), (j.v_pages, t.v_pages)]
        if t.quantized:
            pairs += [(j.k_scales, t.k_scales), (j.v_scales, t.v_scales)]
        for a, b in pairs:
            assert np.array_equal(np.asarray(a), b.numpy())
        for key in ("used_bytes", "records", "swapped_out_records",
                    "swapped_in_records", "peak_used_bytes"):
            assert self.ts.summary()[key] == self.js.summary()[key], key
        t.assert_ref_invariants()


def _chain(pool, sid):
    """The sequence's page bytes (and scale rows) in chain order:
    comparable across a round trip though private page ids change."""
    pg = torch.tensor(pool.seq_pages(sid))
    out = [pool.k_pages[pg].clone(), pool.v_pages[pg].clone()]
    if pool.quantized:
        out += [pool.k_scales[pg].clone(), pool.v_scales[pg].clone()]
    return out


def _bitwise(a, b):
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_private_chain_roundtrip_bitwise(kv):
    b = Both(kv)
    b.fill("s", 9)  # 3 pages, the last partial
    before = _chain(b.t, "s")
    est = b.t.swap_out_nbytes("s")
    freed, nbytes = b.both("swap_out", "s")
    assert freed == 3 and nbytes == est == 3 * b.t.page_nbytes
    b.check()
    with pytest.raises(KeyError):
        b.t.seq_pages("s")
    assert b.both("swap_in", "s") == 3
    _bitwise(before, _chain(b.t, "s"))
    b.check()
    b.fill("s", 1, alloc=False)  # decoding resumes at the old length
    b.check()


@pytest.mark.parametrize("kv", [None, "int8"])
def test_shared_pages_stay_on_device(kv):
    b = Both(kv)
    b.fill("a", 8)
    chain_a = b.t.seq_pages("a")
    b.both("attach", "b", chain_a, 8)
    b.fill("b", 3, alloc=False)  # one private page past the shared two
    before = _chain(b.t, "b")
    assert b.both("swap_out", "b") == (1, b.t.page_nbytes)
    assert b.t.seq_pages("a") == chain_a
    assert all(b.t._ext_refs[p] == 1 for p in chain_a)  # the swap holds
    b.check()
    b.both("swap_in", "b")
    _bitwise(before, _chain(b.t, "b"))
    assert b.t.seq_pages("b")[:2] == chain_a
    b.check()


@pytest.mark.parametrize("kv", [None, "int8"])
def test_midpage_cow_resume_roundtrip(kv):
    b = Both(kv)
    b.fill("a", 6)
    a_before = _chain(b.t, "a")
    b.both("attach", "b", b.t.seq_pages("a"), 6)
    b.fill("b", 1, alloc=False)  # forks a's partial page
    assert b.t.cow_forks == 1
    b_before = _chain(b.t, "b")
    assert b.both("swap_out", "b")[0] == 1
    b.both("swap_in", "b")
    _bitwise(b_before, _chain(b.t, "b"))
    _bitwise(a_before, _chain(b.t, "a"))
    b.check()


def test_swap_in_pages_needed_accounting():
    b = Both()
    b.fill("a", 6)
    b.both("attach", "b", b.t.seq_pages("a"), 6)
    b.both("swap_out", "b")
    # no private page, but the resume's first append forks the tail
    assert b.both("swap_in_pages_needed", "b") == 1
    assert b.both("swap_in_pages_needed", "b", 14) == 3
    b.both("swap_in", "b")
    b.both("free", "a")
    b.both("free", "b")
    b.fill("c", 9)
    b.both("swap_out", "c")
    assert b.both("swap_in_pages_needed", "c") == 3
    assert b.both("swap_in_pages_needed", "c", 17) == 5
    b.both("swap_in", "c")
    b.check()


def test_swap_space_full_is_atomic():
    b = Both()
    b.fill("s", 9)
    chain, free0 = b.t.seq_pages("s"), b.t.num_free_pages
    with pytest.raises(SwapSpaceFull):
        b.t.swap_out("s", HostKVSwapSpace(1))
    assert b.t.seq_pages("s") == chain and b.t.num_free_pages == free0
    b.check()
    b.fill("s", 1, alloc=False)
    b.check()


def test_swap_discard_releases_holds():
    b = Both()
    b.fill("a", 8)
    b.both("attach", "b", b.t.seq_pages("a"), 8)
    b.fill("b", 3, alloc=False)
    b.both("swap_out", "b")
    assert b.both("swap_discard", "b") == 0  # a still holds the chain
    assert b.ts.num_records == 0 and not b.t._ext_refs
    b.both("free", "a")
    b.check()
    assert b.t.num_free_pages == b.t.num_pages


def test_swap_refusals():
    b = Both()
    b.fill("s", 4)
    b.both("swap_out", "s")
    with pytest.raises(KeyError):
        b.t.swap_out("s", b.ts)
    b.both("swap_in", "s")
    with pytest.raises(ValueError, match="already allocated"):
        b.t.swap_in("s", b.ts)
    b.both("free", "s")
    with pytest.raises(KeyError):
        b.t.swap_in("s", b.ts)


def test_space_is_shared_across_layer_pools():
    p1, p2 = Both(), Both()
    space = HostKVSwapSpace(SWAP)
    p1.fill("s", 5)
    p2.rng = np.random.RandomState(9)
    p2.fill("s", 5)
    b1, b2 = _chain(p1.t, "s"), _chain(p2.t, "s")
    p1.t.swap_out("s", space)
    p2.t.swap_out("s", space)
    assert space.num_records == 2 and space.holds("s")
    assert space.used_bytes == 4 * p1.t.page_nbytes
    p1.t.swap_in("s", space)
    assert space.holds("s")
    p2.t.swap_in("s", space)
    _bitwise(b1, _chain(p1.t, "s"))
    _bitwise(b2, _chain(p2.t, "s"))
    assert not space.holds("s")
    assert space.summary()["swapped_in_records"] == 2


# ------------------------------------------------------ scheduler level
def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, 500, n).tolist()


def _req(cls, spec):
    rid, prompt, new = spec[:3]
    kw = spec[3] if len(spec) > 3 else {}
    return cls(rid, list(prompt), max_new_tokens=new, **kw)


def _record(adapter, out):
    """Wrap ``adapter.prefill_chunk`` to append each call's logits."""
    fn = adapter.prefill_chunk

    def rec(*a, **kw):
        y = fn(*a, **kw)
        out.append(np.asarray(y.numpy() if hasattr(y, "numpy")
                              else y._data, np.float32))
        return y

    adapter.prefill_chunk = rec


def _lockstep(plan, monkeypatch, mode="auto", kv=None, num_pages=24,
              **sched_kw):
    """Steps a JAX and a port scheduler over one plan: ``{step: [action,
    ...]}``, actions ``("submit", (rid, prompt, max_new[, request
    kwargs]))``, ``("cancel", rid)``, ``("time", seconds)``; returns
    (port scheduler, JAX scheduler, port adapter, events)."""
    now = [100.0]
    monkeypatch.setattr(telemetry, "_clock", lambda: now[0])
    monkeypatch.setattr(serving, "clock", lambda: now[0])
    jm, tm = _pair("base")
    kw = dict(num_pages=num_pages, page_size=PAGE, max_length=128,
              kv_cache_dtype=kv)
    ja, ta = JaxAdapter(jm, **kw), PagedLlamaAdapter(tm, **kw)
    jl, tl = [], []
    _record(ja, jl)
    _record(ta, tl)
    sched_kw.setdefault("prefill_chunk_tokens", 8)
    # one bucket keeps the JAX side's compiled program count low
    sched_kw.setdefault("serving_buckets", "16")
    sched_kw.setdefault("swap_bytes", SWAP)
    js, ts = JaxScheduler(ja, **sched_kw), BatchScheduler(ta, **sched_kw)
    events = []
    step = 0
    with ragged_mode(mode):
        while step <= max(plan) or ts.num_active or ts.num_queued \
                or ts.num_swapped:
            for act, arg in plan.get(step, ()):
                if act == "time":
                    now[0] = float(arg)
                elif act == "cancel":
                    assert ts.cancel(arg) == js.cancel(arg)
                else:
                    try:
                        js.submit(_req(JaxRequest, arg))
                    except JaxQueueFull:
                        with pytest.raises(QueueFullError):
                            ts.submit(_req(Request, arg))
                    else:
                        ts.submit(_req(Request, arg))
            jev, tev = js.step(), ts.step()
            assert tev == jev, (step, tev, jev)
            assert len(tl) == len(jl)
            for t, j in zip(tl, jl):
                np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)
            tl.clear()
            jl.clear()
            for jc, tc in zip(ja.caches, ta.caches):
                assert (tc._tables, tc._lens, tc._free, tc._refcnt,
                        tc._ext_refs, tc.cow_forks) == (
                    jc._tables, jc._lens, jc._free, jc._refcnt,
                    jc._ext_refs, jc.cow_forks), step
                tc.assert_ref_invariants()
            assert (ts.num_active, ts.num_queued, ts.num_swapped) == (
                js.num_active, js.num_queued, js.num_swapped)
            events.append(tev)
            step += 1
            assert step < 400
    for rid, r in js._finished.items():
        t = ts.result(rid)
        assert (t.state, t.generated_ids, t._preemptions, t._prefix_hit) \
            == (r.state, r.generated_ids, r._preemptions, r._prefix_hit)
    assert set(ts._finished) == set(js._finished)
    return ts, js, ta, events


def _total(events, key):
    return sum(e.get(key, 0) for e in events)


P = _prompt(1, 13)  # the shared prefix: 13 tokens, ends mid-page


def _prefix_plan():
    r0 = P + _prompt(2, 3)
    plan = {0: [("submit", ("r0", r0, 4))]}
    plan[8] = [("submit", (f"r{i}", P + [480 + i] + _prompt(10 + i, i),
                           2 + i)) for i in (1, 2)]
    plan[8] += [("submit", ("r3", r0, 3))]
    # a long request that fits only after the evictor reclaims pages
    plan[10] = [("submit", ("r4", _prompt(6, 56), 3))]
    plan[11] = [("submit", ("r5", P + [490] + _prompt(7, 2), 3))]
    return plan


@pytest.mark.parametrize("mode,kv,align", [
    ("auto", None, 1), ("off", "int8", 1), ("auto", None, PAGE),
    ("off", "int8", PAGE)])
def test_prefix_cache_lockstep(monkeypatch, mode, kv, align):
    ts, js, ta, ev = _lockstep(_prefix_plan(), monkeypatch, mode, kv,
                               num_pages=24, max_batch_size=3,
                               prefix_cache=True, prefix_align=align)
    hits = _total(ev, "prefix_hit_tokens")
    assert hits >= 4 * 12
    if align > 1:
        assert all(r._prefix_hit % align == 0
                   for r in ts._finished.values())
    stats = ts.page_pool_stats()
    assert stats["prefix_cache"]["hit_tokens"] == hits
    tree = stats["prefix_cache"]["tree"]
    assert tree["evicted_nodes"] > 0
    assert (stats["cow_forks"] > 0) == (align == 1)
    assert all(r.finished for r in ts._finished.values())
    ts.prefix_cache.clear()
    for c in ta.caches:
        c.assert_ref_invariants()
        assert c.num_free_pages == c.num_pages


def _preempt_plan(prefix):
    """Three priority-0 requests fill a 16-page pool; priority-2 and
    priority-1 arrivals preempt them. With ``prefix`` they share a
    cached prefix first (shared pages stay on the device)."""
    base = 0
    plan = {}
    head = P if prefix else []
    if prefix:
        plan[0] = [("submit", ("seed", P + [9], 2))]
        base = 6
    plan[base] = [("submit", (f"lo{i}", head + _prompt(20 + i, 9 - i),
                              6, {"priority": 0})) for i in range(3)]
    plan[base + 3] = [("submit", ("hi", _prompt(30, 14), 6,
                                  {"priority": 2}))]
    plan[base + 5] = [("submit", ("mid", _prompt(31, 10), 5,
                                  {"priority": 1}))]
    return plan


@pytest.mark.parametrize("mode,kv,prefix", [
    ("auto", None, False), ("off", "int8", False), ("auto", "int8", True),
    ("auto", None, True)])
def test_preemption_lockstep(monkeypatch, mode, kv, prefix):
    pages = 20 if prefix else 16
    ts, js, ta, ev = _lockstep(_preempt_plan(prefix), monkeypatch, mode,
                               kv, num_pages=pages, max_batch_size=4,
                               prefix_cache=prefix)
    assert _total(ev, "preempted") >= 2
    assert _total(ev, "resumed") == _total(ev, "preempted")
    done = ts._finished
    assert all(r.finished and len(r.generated_ids) == r.max_new_tokens
               for r in done.values())
    assert any(r._preemptions for r in done.values())
    assert all(r.priority == 0 for r in done.values() if r._preemptions)
    swap = ts.page_pool_stats()["swap"]
    assert swap["used_bytes"] == 0 and swap["records"] == 0
    assert swap["swapped_in_records"] == swap["swapped_out_records"] > 0
    if prefix:
        assert _total(ev, "prefix_hit_tokens") >= 3 * 12
        ts.prefix_cache.clear()
    for c in ta.caches:
        assert c.num_free_pages == c.num_pages


def test_swapped_request_yields_to_higher_priority(monkeypatch):
    """While lo (priority 0) is swapped out, a queued top (priority 3)
    takes the room first; lo resumes after."""
    plan = {0: [("submit", ("lo", _prompt(40, 10), 10)),
                ("submit", ("a", _prompt(41, 10), 14, {"priority": 1}))],
            2: [("submit", ("b", _prompt(42, 14), 6, {"priority": 2}))],
            4: [("submit", ("top", _prompt(43, 6), 6, {"priority": 3})),
                ("submit", ("top2", _prompt(44, 6), 6, {"priority": 3}))]}
    seen = []
    orig = BatchScheduler._admit_swapped

    def spy(self, queued_priority=None):
        before = dict(self._swapped)
        orig(self, queued_priority)
        seen.append((queued_priority,
                     [r.priority for r in before.values()
                      if r.req_id in self._swapped]))

    monkeypatch.setattr(BatchScheduler, "_admit_swapped", spy)
    ts, js, ta, ev = _lockstep(plan, monkeypatch, num_pages=16,
                               max_batch_size=3)
    # some step left a lower-priority request swapped out because a
    # queued one outranked it
    assert any(q is not None and any(p < q for p in left)
               for q, left in seen)
    assert ts.result("lo")._preemptions >= 1
    assert all(r.finished for r in ts._finished.values())


def test_futile_preemption_skipped(monkeypatch):
    """A candidate blocked by a same-priority peer does not swap out a
    lower-priority victim whose pages cannot close the deficit."""
    plan = {0: [("submit", ("big", [1] * 8, 8, {"priority": 1})),
                ("submit", ("lo", [2, 3], 6))],
            3: [("submit", ("cand", [4] * 8, 8, {"priority": 1}))]}
    ts, js, ta, ev = _lockstep(plan, monkeypatch, num_pages=8,
                               max_batch_size=4)
    assert _total(ev, "preempted") == 0
    assert ts.page_pool_stats()["swap"]["swapped_out_records"] == 0
    assert all(r.finished for r in ts._finished.values())


def test_tenant_cap_and_bounded_queue(monkeypatch):
    plan = {0: [("submit", (f"a{i}", _prompt(50 + i, 5), 3,
                            {"tenant": "acme"})) for i in range(3)]
            + [("submit", ("b0", _prompt(53, 6), 3, {"tenant": "beta"})),
               ("submit", ("c0", _prompt(54, 4), 2, {"tenant": "beta"}))],
            1: [("submit", ("c1", _prompt(55, 4), 2))]}
    ts, js, ta, ev = _lockstep(plan, monkeypatch, max_batch_size=4,
                               max_queue=4, max_inflight_per_tenant=1)
    assert "c0" not in ts._finished  # the queue was full at submit
    assert {"a0", "a1", "a2", "b0", "c1"} == set(ts._finished)
    with pytest.raises(QueueFullError):
        s = BatchScheduler(ta, max_queue=1)
        s.submit(Request("x", [1, 2], max_new_tokens=1))
        s.submit(Request("y", [1, 2], max_new_tokens=1))


@pytest.mark.parametrize("mode,kv", [("auto", None), ("off", "int8")])
def test_deadlines_and_cancel(monkeypatch, mode, kv):
    """Deadlines expire a request while queued, active and swapped out;
    cancel() ends requests queued, active and swapped out."""
    plan = {0: [("submit", ("s1", _prompt(60, 10), 10,
                            {"deadline_s": 40.0})),
                ("submit", ("a1", _prompt(61, 10), 6,
                            {"deadline_s": 25.0})),
                ("submit", ("q1", _prompt(62, 20), 8,
                            {"deadline_s": 10.0}))],
            1: [("time", 105.0)],
            2: [("time", 112.0),
                ("submit", ("hi", _prompt(63, 18), 10, {"priority": 2}))],
            3: [("time", 126.0)],
            4: [("time", 141.0)],
            6: [("submit", ("c1", _prompt(64, 6), 12)),
                ("submit", ("c2", _prompt(65, 12), 6)),
                ("submit", ("c3", _prompt(66, 12), 6))],
            8: [("submit", ("top", _prompt(67, 16), 6, {"priority": 5}))],
            9: [("cancel", "c3")],
            10: [("cancel", "c1"), ("cancel", "nope")],
            12: [("cancel", "c2"), ("cancel", "hi")]}
    where = {}
    abort = BatchScheduler._abort_deadline

    def spy(self, req, at):
        where[req.req_id] = at
        abort(self, req, at)

    monkeypatch.setattr(BatchScheduler, "_abort_deadline", spy)
    ts, js, ta, ev = _lockstep(plan, monkeypatch, mode, kv, num_pages=16,
                               max_batch_size=3)
    assert where == {"q1": "queued", "a1": "swapped", "s1": "active",
                     "c3": "queued", "hi": "active", "c1": "swapped",
                     "c2": "queued"}
    assert all(ts.result(r).state == RequestState.ABORTED_DEADLINE
               for r in where)
    assert all(ts.result(r).terminal for r in ts._finished)
    assert ts.result("top").finished
    # the step events count the step's own deadline aborts; a cancel()
    # between steps is not a step's event (as in the reference)
    assert _total(ev, "aborted") == 3
    assert ts.page_pool_stats()["swap"]["used_bytes"] == 0
    for c in ta.caches:
        assert c.num_free_pages == c.num_pages
    assert ts.cancel("s1") is False


def test_deadline_validation():
    _, tm = _pair("base")
    s = BatchScheduler(PagedLlamaAdapter(tm, num_pages=8, page_size=PAGE))
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="deadline_s"):
            s.submit(Request("d", [1, 2], max_new_tokens=1,
                             deadline_s=bad))
    assert s.num_queued == 0


def test_expire_queued_deadlines_between_steps(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(serving, "clock", lambda: now[0])
    _, tm = _pair("base")
    s = BatchScheduler(PagedLlamaAdapter(tm, num_pages=8, page_size=PAGE))
    s.submit(Request("late", [1, 2], max_new_tokens=1, deadline_s=5.0))
    s.submit(Request("fine", [1, 2], max_new_tokens=1, deadline_s=50.0))
    now[0] = 106.0
    assert s.expire_queued_deadlines() == 1
    assert s.result("late").state == RequestState.ABORTED_DEADLINE
    assert s.num_queued == 1
    assert s.run_until_complete()["fine"].finished
