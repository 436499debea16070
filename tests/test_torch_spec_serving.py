"""Speculative decoding in the port's paged serving scheduler, against the
JAX package's, on the CPU.

``BatchScheduler(target, draft_model=draft, spec_decode=...)`` steps in
lockstep with the JAX scheduler on tiny models whose weights cross over
through ``load_reference_state``: a target of hidden 64 and 2 layers
(``_pair("base")`` of ``tests/test_torch_llama_serving.py``) and a
1-layer draft made from seed 1, pages of 4 tokens, chunks of 8. After
every step the event dicts are equal, ``spec_stats`` are equal, and the
books of every target AND draft pool (``_tables``, ``_lens``, ``_free``,
``_refcnt``, ``_ext_refs``) are equal, with ``assert_ref_invariants()``
holding; every model call's logits (target and draft: ``prefill_chunk``,
its ``logits_rows`` output, ``decode_token``, ``decode_window``) agree
within 1e-4 (float32 through two layers, products summed in another
order) on float pools and within 2e-3 on int8 pools (``INT8_ATOL``);
the greedy streams and terminal states are identical, and equal the
port's own non-speculative scheduler's.

Both lowerings (``ragged``, ``legacy``) run over float32 and int8 pools
under ``FLAGS_ragged_attention=auto``, and ``ragged`` once under
``off``; ``ragged`` also with the prefix cache (rollback over shared and
copy-on-write pages, the draft refilled after each hit) and with
preemption (forced by a tight pool and priority arrivals: the draft is
discarded at swap-out and refilled after swap-in). ``dense_kv`` is held
to the JAX pool's (page table and float pages bit for bit, int8 pages
dequantized within 1e-6), ``decode_window`` logits within 1e-4.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import PagedKVCacheManager as JaxPool
from paddle_tpu.inference import BatchScheduler as JaxScheduler
from paddle_tpu.inference import PagedLlamaAdapter as JaxAdapter
from paddle_tpu.inference import Request as JaxRequest
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny

import paddle_tpu_torch as pt
from paddle_tpu_torch.incubate.nn import PagedKVCacheManager
from paddle_tpu_torch.inference import (BatchScheduler, PagedLlamaAdapter,
                                        Request)
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

from test_torch_llama_serving import _pair, ragged_mode

PAGE = 4
ATOL = 1e-4
# int8 pools: the two packages' K/V differ by float32 rounding, so a
# value within that of a code boundary quantizes one code apart (fed the
# same K/V the pools agree bit for bit, tests/test_torch_quant_kv.py).
# One V code of a page whose scale is ~0.02 moved a logit by 7.0e-4 in
# the legacy int8 lockstep; tokens and books stay identical.
INT8_ATOL = 2e-3
K = 3  # draft_k
SWAP = 64 << 20

_DRAFT = {}


def _draft_pair():
    """(jax_draft, port_draft): a 1-layer model of the target's widths
    made from seed 1, weights copied over."""
    if not _DRAFT:
        kw = dict(hidden_size=64, intermediate_size=128,
                  num_hidden_layers=1, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128)
        paddle.seed(1)
        jm = JaxLlama(jax_tiny(**kw))
        state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
        tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
        tm.load_reference_state(state)
        _DRAFT["pair"] = (jm, tm)
    return _DRAFT["pair"]


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(1, 500, n).tolist()


def _host(y):
    if isinstance(y, tuple):
        return [a for part in y for a in _host(part)]
    return [np.asarray(y.numpy() if hasattr(y, "numpy") else y._data,
                       np.float32)]


def _record(adapter, out, calls=None):
    """Wrap the adapter's model calls to append their logits to ``out``
    (and, with ``calls``, each call's kind and arguments)."""
    for name in ("prefill_chunk", "decode_token", "decode_window"):
        fn = getattr(adapter, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            y = _fn(*a, **kw)
            out.extend(_host(y))
            if calls is not None:
                calls.append((_name, a, kw))
            return y

        # keep prefill_chunk's logits_rows= in the signature the
        # scheduler inspects
        if name == "prefill_chunk":
            def rec_pc(token_ids, seq_ids, start_positions=None,
                       pad_to=None, logits_rows=None, _rec=rec):
                return _rec(token_ids, seq_ids, start_positions,
                            pad_to=pad_to, logits_rows=logits_rows)
            setattr(adapter, name, rec_pc)
        else:
            setattr(adapter, name, rec)


def _books(c):
    return (c._tables, c._lens, c._free, c._refcnt, c._ext_refs)


def _req(cls, spec):
    rid, prompt, new = spec[:3]
    kw = spec[3] if len(spec) > 3 else {}
    return cls(rid, list(prompt), max_new_tokens=new, **kw)


def _plain_streams(plan, kv=None, num_pages=64, mode="auto", **sched_kw):
    """The port's non-speculative scheduler over the same plan."""
    _, tm = _pair("base")
    ta = PagedLlamaAdapter(tm, num_pages=num_pages, page_size=PAGE,
                           max_length=128, kv_cache_dtype=kv)
    sched_kw.setdefault("prefill_chunk_tokens", 8)
    s = BatchScheduler(ta, **sched_kw)
    step = 0
    with ragged_mode(mode):
        while step <= max(plan) or s.num_active or s.num_queued \
                or s.num_swapped:
            for _, arg in plan.get(step, ()):
                s.submit(_req(Request, arg))
            s.step()
            step += 1
    return {rid: r.generated_ids for rid, r in s._finished.items()}


def _lockstep(plan, spec="ragged", mode="auto", kv=None, num_pages=64,
              draft_pages=64, same_weights=False, check_plain=True,
              check=None, **sched_kw):
    """Steps a JAX and a port speculative scheduler over ``plan``
    (``{step: [("submit", (rid, prompt, max_new[, request kwargs])),
    ...]}``), checking events, spec_stats, both pools' books and every
    call's logits after each step. Returns (port scheduler, JAX
    scheduler, port target adapter, port draft adapter, events, port
    target calls). ``check(step, js, ts, [(ja, ta), (jda, tda)])``, when
    given, runs after every step's own checks."""
    jm, tm = _pair("base")
    jd, td = (jm, tm) if same_weights else _draft_pair()
    kw = dict(page_size=PAGE, max_length=128)
    ja = JaxAdapter(jm, num_pages=num_pages, kv_cache_dtype=kv, **kw)
    ta = PagedLlamaAdapter(tm, num_pages=num_pages, kv_cache_dtype=kv, **kw)
    jda = JaxAdapter(jd, num_pages=draft_pages, **kw)
    tda = PagedLlamaAdapter(td, num_pages=draft_pages, **kw)
    jl, tl, jdl, tdl, calls = [], [], [], [], []
    _record(ja, jl)
    _record(ta, tl, calls)
    _record(jda, jdl)
    _record(tda, tdl)
    sched_kw.setdefault("prefill_chunk_tokens", 8)
    sched_kw.setdefault("serving_buckets", "16")
    sched_kw.setdefault("max_batch_size", 2)
    js = JaxScheduler(ja, draft_model=jda, draft_k=K, spec_decode=spec,
                      **sched_kw)
    ts = BatchScheduler(ta, draft_model=tda, draft_k=K, spec_decode=spec,
                        **sched_kw)
    assert ts._spec_ragged == js._spec_ragged == (spec == "ragged")
    atol = ATOL if kv is None else INT8_ATOL
    events = []
    step = 0
    with ragged_mode(mode):
        while step <= max(plan) or ts.num_active or ts.num_queued \
                or ts.num_swapped:
            for _, arg in plan.get(step, ()):
                js.submit(_req(JaxRequest, arg))
                ts.submit(_req(Request, arg))
            jev, tev = js.step(), ts.step()
            assert tev == jev, (step, tev, jev)
            assert ts.spec_stats == js.spec_stats, step
            for got, want, tol in ((tl, jl, atol), (tdl, jdl, ATOL)):
                assert len(got) == len(want), step
                for t, j in zip(got, want):
                    np.testing.assert_allclose(t, j, atol=tol, rtol=0)
                got.clear()
                want.clear()
            for jad, tad in ((ja, ta), (jda, tda)):
                for jc, tc in zip(jad.caches, tad.caches):
                    assert _books(tc) == _books(jc), step
                    tc.assert_ref_invariants()
            assert (ts.num_active, ts.num_queued, ts.num_swapped) == (
                js.num_active, js.num_queued, js.num_swapped)
            if check is not None:
                check(step, js, ts, [(ja, ta), (jda, tda)])
            events.append(tev)
            step += 1
            assert step < 300
    assert set(ts._finished) == set(js._finished)
    for rid, r in js._finished.items():
        t = ts.result(rid)
        assert (t.state, t.generated_ids, t._preemptions, t._prefix_hit) \
            == (r.state, r.generated_ids, r._preemptions, r._prefix_hit)
    if check_plain:
        plain = _plain_streams(
            plan, kv=kv, num_pages=num_pages, mode=mode,
            **{k: v for k, v in sched_kw.items()
               if k in ("prefill_chunk_tokens", "max_batch_size")})
        assert {rid: r.generated_ids for rid, r in ts._finished.items()} \
            == plain
    return ts, js, ta, tda, events, calls


def _total(events, key):
    return sum(e.get(key, 0) for e in events)


BASE_PLAN = {0: [("submit", ("a", _prompt(1, 9), 6)),
                 ("submit", ("b", _prompt(2, 3), 4))],
             2: [("submit", ("c", _prompt(3, 6), 5)),
                 ("submit", ("d", _prompt(4, 12), 4))]}


# --------------------------------------------------------------- lockstep
@pytest.mark.parametrize("spec,kv", [("ragged", None), ("ragged", "int8"),
                                     ("legacy", None), ("legacy", "int8")])
def test_spec_lockstep(spec, kv):
    ts, js, ta, tda, ev, calls = _lockstep(BASE_PLAN, spec=spec, kv=kv)
    st = ts.spec_stats
    assert st["rounds"] > 0 and st["committed_tokens"] == sum(
        len(r.generated_ids) - 1 for r in ts._finished.values())
    assert ts.page_pool_stats()["spec"] == js._statusz_info()["spec"]
    for ad in (ta, tda):
        for c in ad.caches:
            assert c.num_free_pages == c.num_pages


def test_spec_lockstep_ragged_attention_off():
    _, _, ta, tda, _, _ = _lockstep(BASE_PLAN, spec="ragged", mode="off",
                                    kv="int8")
    # the target's rows are verify windows and prompt chunks; the
    # draft's propose rows go through the decode kernel
    assert "prefill" in {k for k, *_ in ta._kernel_shapes}
    assert {k for k, *_ in tda._kernel_shapes} == {"decode", "prefill"}


def test_same_weights_draft_accepts_everything():
    plan = {0: [("submit", (r, _prompt(10 + i, 5 + 3 * i), 9))
                for i, r in enumerate("abc")]}
    ts, *_ = _lockstep(plan, same_weights=True)
    st = ts.spec_stats
    assert st["accepted_draft_tokens"] == st["proposed_tokens"] > 0
    # the first token of each stream comes from the prefill, every
    # other one from a fully accepted window of K + 1
    assert st["committed_tokens"] == 3 * (9 - 1)
    assert ts.page_pool_stats()["spec"]["accept_rate"] == 1.0


def test_ragged_makes_one_target_call_a_round():
    ts, _, _, _, ev, calls = _lockstep(BASE_PLAN, spec="ragged",
                                       check_plain=False)
    kinds = {name for name, _, _ in calls}
    assert kinds == {"prefill_chunk"}  # no decode_token / decode_window
    target_steps = [e for e in ev if e.get("spec_verify_rows")
                    or e["prefill_tokens"]]
    assert len(calls) == len(target_steps)
    rounds = 0
    for (_, (token_ids, seq_ids, starts), kw), e in zip(calls,
                                                        target_steps):
        n = e["spec_verify_rows"]
        if not n:
            assert kw["logits_rows"] is None
            continue
        rounds += 1
        # the verify rows come first, each K + 1 tokens, and their
        # per-position logits are the epilogue's
        assert kw["logits_rows"] == list(range(n))
        assert [len(t) for t in token_ids[:n]] == [K + 1] * n
    assert rounds == ts.spec_stats["rounds"] == ts.spec_stats["target_calls"]


# ------------------------------------------------ prefix cache, preemption
P = _prompt(1, 13)  # a shared prefix of 13 tokens, ending mid-page


@pytest.mark.parametrize("kv", [None, "int8"])
def test_rollback_over_shared_prefix_pages(kv):
    plan = {0: [("submit", ("r0", P + _prompt(2, 3), 5))],
            8: [("submit", ("r1", P + [480] + _prompt(11, 2), 6)),
                ("submit", ("r2", P + _prompt(2, 3), 4))],
            16: [("submit", ("r3", P + [490] + _prompt(7, 2), 5))]}
    ts, js, ta, tda, ev, _ = _lockstep(plan, kv=kv, num_pages=40,
                                       prefix_cache=True)
    assert _total(ev, "prefix_hit_tokens") >= 3 * 12
    assert ts.spec_stats["refill_tokens"] > 0  # the draft never attaches
    assert ts.page_pool_stats()["cow_forks"] > 0
    # cached K/V is the committed tokens' only: the tree holds no
    # unverified window tail
    tree = ts.prefix_cache.summary()
    assert tree == js.prefix_cache.summary()
    ts.prefix_cache.clear()
    for ad in (ta, tda):
        for c in ad.caches:
            c.assert_ref_invariants()
            assert c.num_free_pages == c.num_pages


def test_preemption_with_a_draft():
    """Priority-0 requests fill a tight pool; priority-2 and -1 arrivals
    preempt them. The victims' draft chains are discarded and refilled
    after swap-in; tokens stay those of the non-speculative run."""
    plan = {0: [("submit", (f"lo{i}", _prompt(20 + i, 9 - i), 6,
                            {"priority": 0})) for i in range(3)],
            3: [("submit", ("hi", _prompt(30, 14), 6, {"priority": 2}))],
            5: [("submit", ("mid", _prompt(31, 10), 5, {"priority": 1}))]}
    ts, js, ta, tda, ev, _ = _lockstep(plan, num_pages=18, max_batch_size=4,
                                       swap_bytes=SWAP)
    assert _total(ev, "preempted") >= 2
    assert _total(ev, "resumed") == _total(ev, "preempted")
    st = ts.spec_stats
    assert st["draft_discards"] == _total(ev, "preempted")
    assert st["refill_tokens"] > 0
    assert any(r._preemptions for r in ts._finished.values())
    swap = ts.page_pool_stats()["swap"]
    assert swap["used_bytes"] == 0 and swap["records"] == 0
    for ad in (ta, tda):
        for c in ad.caches:
            assert c.num_free_pages == c.num_pages


def _pins(tree):
    out, stack = [], list(tree.root.children.values())
    while stack:
        node = stack.pop()
        out.append(node.pin)
        stack += node.children.values()
    return out


def test_draft_pool_refusal_releases_the_prefix_pin():
    """A request whose prefix hit pins its match but whose draft pool
    cannot take it is refused with the pin released (the reference keeps
    the pin there, so every refused step would add one)."""
    _, tm = _pair("base")
    _, td = _draft_pair()
    ad = PagedLlamaAdapter(tm, num_pages=64, page_size=PAGE)
    da = PagedLlamaAdapter(td, num_pages=12, page_size=PAGE)
    s = BatchScheduler(ad, draft_model=da, draft_k=K, prefix_cache=True,
                       prefill_chunk_tokens=8)
    s.submit(Request("r0", P + [5], max_new_tokens=2))
    s.run_until_complete()
    # 13 + 30 + 8 + K + 1 tokens: 14 draft pages, above 0.95 x 12
    s.submit(Request("r1", P + _prompt(9, 30), max_new_tokens=8))
    for _ in range(3):
        assert s.step()["admitted"] == 0
        assert s.num_queued == 1 and set(_pins(s.prefix_cache)) == {0}
    assert s.prefix_cache.match(P + [1], limit=13).length >= 12


def test_legacy_refuses_prefix_cache_and_preemption():
    _, tm = _pair("base")
    _, td = _draft_pair()

    def adapters(pages=32):
        return (PagedLlamaAdapter(tm, num_pages=pages, page_size=PAGE),
                PagedLlamaAdapter(td, num_pages=pages, page_size=PAGE))

    ad, da = adapters()
    with pytest.raises(ValueError, match="LEGACY"):
        BatchScheduler(ad, draft_model=da, prefix_cache=True,
                       spec_decode="legacy")
    s = BatchScheduler(ad, draft_model=da, spec_decode="legacy",
                       preempt=True, swap_bytes=1 << 20)
    assert s.swap_space is None
    ad, da = adapters()
    assert BatchScheduler(ad, draft_model=da, spec_decode="ragged",
                          preempt=True,
                          swap_bytes=1 << 20).swap_space is not None
    # legacy: a priority arrival on a full pool waits in the queue until
    # the priority-0 requests retire
    ad, da = adapters(pages=18)
    s = BatchScheduler(ad, draft_model=da, draft_k=K, spec_decode="legacy",
                       max_batch_size=4, prefill_chunk_tokens=8,
                       swap_bytes=SWAP)
    for i in range(3):
        s.submit(Request(f"lo{i}", _prompt(20 + i, 9 - i), 6))
    for _ in range(3):
        s.step()
    s.submit(Request("hi", _prompt(30, 14), 6, priority=2))
    waited = 0
    while s.num_active or s.num_queued:
        ev = s.step()
        assert "preempted" not in ev and s.num_swapped == 0
        waited += s.num_queued
    assert waited > 0
    assert all(r.finished and r._preemptions == 0
               for r in s._finished.values())


def test_bad_spec_decode_and_sampler_rejected():
    _, tm = _pair("base")
    _, td = _draft_pair()
    ad = PagedLlamaAdapter(tm, num_pages=16, page_size=PAGE)
    da = PagedLlamaAdapter(td, num_pages=16, page_size=PAGE)
    with pytest.raises(ValueError, match="spec_decode"):
        BatchScheduler(ad, spec_decode="bogus")
    with pytest.raises(ValueError, match="greedy-only"):
        BatchScheduler(ad, draft_model=da, sampler=lambda x: 0)
    off = BatchScheduler(ad, draft_model=da, spec_decode="off")
    assert off.draft is None and "spec" not in off.page_pool_stats()


def test_flag_default_and_off():
    _, tm = _pair("base")
    _, td = _draft_pair()
    ad = PagedLlamaAdapter(tm, num_pages=16, page_size=PAGE)
    da = PagedLlamaAdapter(td, num_pages=16, page_size=PAGE)
    assert pt.get_flags("FLAGS_spec_decode")["FLAGS_spec_decode"] \
        == paddle.get_flags("FLAGS_spec_decode")["FLAGS_spec_decode"] \
        == "ragged"
    assert BatchScheduler(ad, draft_model=da)._spec_ragged
    pt.set_flags({"FLAGS_spec_decode": "legacy"})
    try:
        s = BatchScheduler(ad, draft_model=da)
        assert s.draft is da and not s._spec_ragged
    finally:
        pt.set_flags({"FLAGS_spec_decode": "ragged"})


def test_spec_slack_matches_reference():
    """The draft's draft_k + 1 token slack in _pages_needed, submit's
    length limit and _growth_pages equals the reference's."""
    jm, tm = _pair("base")
    jd, td = _draft_pair()
    kw = dict(page_size=PAGE, max_length=40)
    ja, ta = JaxAdapter(jm, num_pages=48, **kw), \
        PagedLlamaAdapter(tm, num_pages=48, **kw)
    jda, tda = JaxAdapter(jd, num_pages=24, **kw), \
        PagedLlamaAdapter(td, num_pages=24, **kw)
    js = JaxScheduler(ja, draft_model=jda, draft_k=K)
    ts = BatchScheduler(ta, draft_model=tda, draft_k=K)
    for n, new in ((3, 4), (10, 9), (16, 8), (7, 1)):
        jr, tr = JaxRequest("x", [1] * n, max_new_tokens=new), \
            Request("x", [1] * n, max_new_tokens=new)
        assert ts._pages_needed(tr) == js._pages_needed(jr)
        assert ts._pages_needed(tr, tda) == js._pages_needed(jr, jda)
        assert ts._pages_needed(tr, hit_tokens=8) \
            == js._pages_needed(jr, hit_tokens=8)
    # submit's limit: 40 - (K + 1) positions
    ok, over = _prompt(5, 30), _prompt(5, 31)
    for sched, cls in ((js, JaxRequest), (ts, Request)):
        sched.submit(cls("ok", ok, max_new_tokens=6))
        with pytest.raises(ValueError, match="positions"):
            sched.submit(cls("over", over, max_new_tokens=6))
    # _growth_pages over a live request, step by step
    for _ in range(4):
        js.step()
        ts.step()
        jr, tr = js._active["ok"], ts._active["ok"]
        for jc, tc in zip(ja.caches, ta.caches):
            assert ts._growth_pages(tr, tc) == js._growth_pages(jr, jc)
        assert ts._reserved_pages_outstanding() \
            == js._reserved_pages_outstanding()


# ------------------------------------------------ dense_kv, decode_window
@pytest.mark.parametrize("kv", [None, "int8"])
def test_dense_kv_matches_reference(kv):
    heads, hd = 2, 8
    j = JaxPool(16, PAGE, heads, hd, dtype=jnp.float32, kv_dtype=kv)
    t = PagedKVCacheManager(16, PAGE, heads, hd, dtype=torch.float32,
                            kv_dtype=kv, device="cpu")
    rng = np.random.RandomState(0)
    for sid, n in (("a", 9), ("b", 3), ("c", 14)):
        k = rng.randn(n, heads, hd).astype(np.float32)
        v = rng.randn(n, heads, hd).astype(np.float32)
        j.alloc(sid)
        t.alloc(sid)
        j.append_ragged([sid], [n], jnp.asarray(k), jnp.asarray(v))
        t.append_ragged([sid], [n], torch.from_numpy(k),
                        torch.from_numpy(v))
    seqs = ["c", "a", "b"]
    jt, jk, jv = j.dense_kv(seqs)
    tt, tk, tv = t.dense_kv(seqs)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert tk.shape == tuple(jk.shape) == (3, 4, PAGE, heads, hd)
    if kv is None:
        # float pages as stored, bit for bit
        assert tk.dtype == torch.float32
        assert np.array_equal(np.asarray(jk), tk.numpy())
        assert np.array_equal(np.asarray(jv), tv.numpy())
    else:
        # int8 codes (bit for bit in the pools) times their scale rows
        assert tk.dtype == torch.float32
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6,
                                   rtol=0)


def test_int8_rollback_keeps_grown_scale():
    """A rejected window token that grew a page's int8 scale: truncate
    drops the token but keeps the grown scale and the requantized codes,
    bit for bit as the JAX pool (fed the same K/V, one token at a time as
    ``decode_window`` appends)."""
    heads, hd = 2, 8
    j = JaxPool(8, PAGE, heads, hd, dtype=jnp.float32, kv_dtype="int8")
    t = PagedKVCacheManager(8, PAGE, heads, hd, dtype=torch.float32,
                            kv_dtype="int8", device="cpu")
    rng = np.random.RandomState(3)
    for pool in (j, t):
        pool.alloc("s")
    for i in range(6):
        # the fifth token is large: it grows its page's scales
        x = rng.randn(2, 1, heads, hd).astype(np.float32) * (
            8.0 if i == 4 else 1.0)
        j.append_batch(["s"], jnp.asarray(x[0]), jnp.asarray(x[1]))
        t.append_batch(["s"], torch.from_numpy(x[0]),
                       torch.from_numpy(x[1]))
    grown = t.k_scales.clone()
    j.truncate("s", 4)
    t.truncate("s", 4)
    assert _books(t) == _books(j)
    assert torch.equal(t.k_scales, grown)
    for a, b in ((j.k_pages, t.k_pages), (j.v_pages, t.v_pages),
                 (j.k_scales, t.k_scales), (j.v_scales, t.v_scales)):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("variant,kv", [("base", None), ("base", "int8"),
                                        ("window6", None)])
def test_decode_window_matches_reference(variant, kv):
    jm, tm = _pair(variant)
    kw = dict(num_pages=32, page_size=PAGE, max_length=32,
              kv_cache_dtype=kv)
    ja, ta = JaxAdapter(jm, **kw), PagedLlamaAdapter(tm, **kw)
    seqs = ["a", "b"]
    for ad in (ja, ta):
        for s in seqs:
            ad.alloc(s)
    prompts = [_prompt(40, 9), _prompt(41, 5)]
    ja.prefill_chunk(prompts, seqs, [0, 0])
    ta.prefill_chunk(prompts, seqs, [0, 0])
    win = np.asarray([_prompt(42, K + 1), _prompt(43, K + 1)])
    jl = np.asarray(ja.decode_window(win, seqs)._data)
    tl = ta.decode_window(win, seqs).numpy()
    assert tl.shape == jl.shape == (2, K + 1, tm.config.vocab_size)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    for jc, tc in zip(ja.caches, ta.caches):
        assert _books(tc) == _books(jc)
        jc.truncate("a", 10)
        tc.truncate("a", 10)
        assert _books(tc) == _books(jc)
    # past max_length: refused before any write
    with pytest.raises(ValueError, match="max_length"):
        ta.decode_window(np.ones((2, 30), np.int64), seqs)
    assert [c.seq_len("b") for c in ta.caches] == [9, 9]
