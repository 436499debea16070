"""Disaggregated serving in the port (``inference/disagg.py``, the
scheduler's ``export_request`` / ``adopt_swapped``), on the CPU.

The reference's ``TestSchedulerHandoff``, ``TestTraceHandoff``,
``TestRouterAndEngine`` and ``TestRoleConfig`` cases
(``tests/test_disagg.py``) run against the port, over the 1-layer torch
paged decoder of ``tests/test_torch_fault_injection.py``.

Then a prefill-to-decode handoff runs in lockstep with the JAX package's
on twin ``llama_tiny``-shaped adapters (weights through
``load_reference_state``; float32 and int8 pools; 1 and 2 shards):
the envelopes' request metadata (trace ids counted alike in both
packages) and the payloads' headers are equal, the
payloads' K/V within 1e-4 (int8 codes equal but for at most one code in
a thousand, scale rows within 1e-4 relative), the handoff counters equal,
the decode-side pool books equal after every step, every model call's
logits within 1e-4 (2e-3 on int8 pools: one int8 code may round apart
between the packages), and the tokens equal to the port's single-box
run.
"""
import asyncio
import itertools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from paddle_tpu.framework import telemetry as jax_telemetry
from paddle_tpu.framework.flags import set_flags as jax_set_flags
from paddle_tpu.incubate.nn.paged_cache import \
    HostKVSwapSpace as JaxSpace
from paddle_tpu.inference import BatchScheduler as JaxScheduler
from paddle_tpu.inference import DecodeWorker as JaxDecodeWorker
from paddle_tpu.inference import PagedLlamaAdapter as JaxAdapter
from paddle_tpu.inference import PrefillWorker as JaxPrefillWorker
from paddle_tpu.inference import Request as JaxRequest

from paddle_tpu_torch.framework import concurrency as conc
from paddle_tpu_torch.framework import telemetry
from paddle_tpu_torch.framework.flags import flag, set_flags
from paddle_tpu_torch.incubate.nn.paged_cache import HostKVSwapSpace
from paddle_tpu_torch.inference import (
    BatchScheduler,
    DecodeWorker,
    DisaggReplica,
    PagedLlamaAdapter,
    PrefillWorker,
    Request,
    RequestState,
    ServingEngine,
    SessionRouter,
    apply_role_budgets,
    role_scheduler_kwargs,
)

from test_torch_fault_injection import N_NEW, PROMPTS, TinyPagedDecoder
from test_torch_llama_serving import _pair

PROMPT = [3, 17, 5, 9, 2, 11, 7, 1]


@pytest.fixture
def tel_trace():
    set_flags({"telemetry": "trace"})
    telemetry.reset()
    conc.reset()
    yield telemetry.tracer()
    set_flags({"telemetry": "off"})
    telemetry.reset()
    conc.reset()


@pytest.fixture
def tel_metrics():
    set_flags({"telemetry": "metrics"})
    telemetry.reset()
    conc.reset()
    yield telemetry.registry()
    set_flags({"telemetry": "off"})
    telemetry.reset()
    conc.reset()


def _sched(num_pages=32, **kw):
    torch.manual_seed(11)
    model = TinyPagedDecoder(num_pages=num_pages)
    kw.setdefault("preempt", True)
    kw.setdefault("swap_bytes", 64 << 20)
    return model, BatchScheduler(model, **kw)


def _single_box_tokens(rid="h0", prompt=PROMPT, n=N_NEW):
    _, ref = _sched()
    ref.submit(Request(rid, list(prompt), max_new_tokens=n))
    return list(ref.run_until_complete()[rid].generated_ids)


# ------------------------------------------------ the reference's cases
class TestSchedulerHandoff:
    def test_export_adopt_greedy_identical(self):
        ref = _single_box_tokens()
        _, sp = _sched()
        req = Request("h0", list(PROMPT), max_new_tokens=N_NEW)
        kind, env = PrefillWorker(sp, mp_shards=1).run(req)
        assert kind == "handoff"
        assert req.state == RequestState.MIGRATED
        assert sp.num_active == 0
        # prefill committed exactly the first token
        assert env["req"]["generated_ids"] == ref[:1]
        for c in sp.model.caches:
            assert c.num_free_pages == c.num_pages

        _, sd = _sched()
        req2 = DecodeWorker.request_from_envelope(env)
        sd.adopt_swapped(req2, env["payloads"])
        assert sd.num_swapped == 1
        done = sd.run_until_complete()
        assert list(done["h0"].generated_ids) == ref

    def test_export_requires_prefill_complete(self):
        _, sp = _sched()
        sp.submit(Request("h0", list(PROMPT), max_new_tokens=N_NEW))
        sp.step()  # admitted; prompt barely started
        with pytest.raises(ValueError, match="prefill incomplete"):
            sp.export_request("h0")

    def test_export_unknown_request(self):
        _, sp = _sched()
        with pytest.raises(KeyError):
            sp.export_request("ghost")

    def test_export_needs_swap_tier(self):
        _, sp = _sched(preempt=False, swap_bytes=0)
        req = Request("h0", list(PROMPT), max_new_tokens=N_NEW)
        sp.submit(req)
        while not req.generated_ids:
            sp.step()
        with pytest.raises(RuntimeError, match="swap"):
            sp.export_request("h0")

    def test_adopt_rejects_duplicate_id(self):
        _, sp = _sched()
        req = Request("h0", list(PROMPT), max_new_tokens=N_NEW)
        kind, env = PrefillWorker(sp).run(req)
        assert kind == "handoff"
        _, sd = _sched()
        sd.submit(Request("h0", list(PROMPT), max_new_tokens=2))
        req2 = DecodeWorker.request_from_envelope(env)
        with pytest.raises(ValueError, match="already"):
            sd.adopt_swapped(req2, env["payloads"])

    def test_adopt_requires_committed_token(self):
        _, sd = _sched()
        bare = Request("h0", list(PROMPT), max_new_tokens=N_NEW)
        with pytest.raises(ValueError, match="prefill-complete"):
            sd.adopt_swapped(bare, [])

    def test_tiny_budget_finishes_on_prefill_box(self):
        _, sp = _sched()
        req = Request("h0", list(PROMPT), max_new_tokens=1)
        kind, val = PrefillWorker(sp).run(req)
        assert kind == "finished"
        assert val.state == RequestState.FINISHED
        assert list(val.generated_ids) == _single_box_tokens(n=1)

    def test_handoff_metrics(self, tel_metrics):
        reg = tel_metrics
        _, sp = _sched()
        req = Request("h0", list(PROMPT), max_new_tokens=N_NEW)
        _, env = PrefillWorker(sp).run(req)
        snap = reg.snapshot()
        assert snap["serving"]["handoff_out_requests"] == 1
        wire = sum(len(p) for p in env["payloads"])
        assert snap["serving"]["handoff_out_bytes"] == wire
        assert snap["pool"]["transfer_out_records"] == 1
        _, sd = _sched()
        sd.adopt_swapped(DecodeWorker.request_from_envelope(env),
                         env["payloads"])
        snap = reg.snapshot()
        assert snap["serving"]["handoff_in_requests"] == 1
        assert snap["serving"]["handoff_in_bytes"] == wire
        assert snap["pool"]["transfer_in_records"] == 1


class TestTraceHandoff:
    def test_one_trace_id_across_workers(self, tel_trace):
        """A chain serialized in one telemetry world and restored in a
        fresh one keeps ONE trace id, with the decode-side swap-in span
        parented under the request root carried by the swap records."""
        ref = _single_box_tokens()
        telemetry.reset()  # the ref run polluted the trace book
        _, sp = _sched()
        req = Request("h0", list(PROMPT), max_new_tokens=N_NEW)
        kind, env = PrefillWorker(sp).run(req)
        assert kind == "handoff"
        root = req.trace_ctx
        assert root is not None
        assert env["req"]["trace_ctx"] == root.to_wire()

        set_flags({"telemetry": "trace"})
        telemetry.reset()
        _, sd = _sched()
        req2 = DecodeWorker.request_from_envelope(env)
        # drop the envelope's context: the swap-record ingress
        # (space.trace_context) must re-derive the identity
        req2.trace_ctx = None
        sd.adopt_swapped(req2, env["payloads"])
        assert req2.trace_ctx is not None
        assert req2.trace_ctx.trace_id == root.trace_id
        done = sd.run_until_complete()
        assert list(done["h0"].generated_ids) == ref

        spans = [s for s in telemetry.tracer().spans()
                 if s.trace_id == root.trace_id]
        assert spans, "no decode-side span adopted the wire trace id"
        swapin = [s for s in spans if s.name == "serving.swap_in"]
        assert swapin
        assert all(s.parent_id == root.span_id for s in swapin)
        tr = telemetry.request_traces().get("h0")
        assert tr is not None and tr.done
        first = tr.first("submit")
        assert first["adopted"] is True
        assert first["trace_id"] == root.trace_id

    def test_prefill_side_emits_terminal_handoff(self, tel_trace):
        _, sp = _sched()
        req = Request("h0", list(PROMPT), max_new_tokens=N_NEW)
        PrefillWorker(sp).run(req)
        tr = telemetry.request_traces().get("h0")
        assert tr is not None and tr.done
        assert tr.kinds()[-1] == "handoff"
        names = {s.name for s in telemetry.tracer().spans()}
        assert "serving.handoff_out" in names


def _mk_replica(name):
    _, sp = _sched()
    _, sd = _sched()
    return sp, sd, name


class TestRouterAndEngine:
    def _run_fleet(self, policy, reqs):
        async def main():
            sp0, sd0, _ = _mk_replica("rep0")
            sp1, sd1, _ = _mk_replica("rep1")
            outs, adopted = {}, {}
            async with ServingEngine(sd0) as e0, \
                    ServingEngine(sd1) as e1:
                router = SessionRouter(
                    [DisaggReplica("rep0", sp0, e0),
                     DisaggReplica("rep1", sp1, e1)],
                    policy=policy)
                for req in reqs:
                    sess = await router.submit(req)
                    outs[req.req_id] = await sess.tokens()
                adopted["rep0"] = e0._adopted
                adopted["rep1"] = e1._adopted
                info = router._routerz_info()
            return outs, adopted, info
        return asyncio.run(main())

    def test_rr_greedy_identical_across_replicas(self):
        ref = {rid: _single_box_tokens(rid, p)
               for rid, p in PROMPTS.items()}
        reqs = [Request(rid, list(p), max_new_tokens=N_NEW)
                for rid, p in PROMPTS.items()]
        outs, adopted, info = self._run_fleet("rr", reqs)
        assert outs == ref
        assert adopted == {"rep0": 2, "rep1": 2}
        assert info["policy"] == "rr"
        assert info["submitted"] == 4
        assert [r["name"] for r in info["replicas"]] == ["rep0", "rep1"]

    def test_cancel_forwards_to_owning_replica(self):
        async def main():
            sp, sd, _ = _mk_replica("rep0")
            async with ServingEngine(sd) as eng:
                router = SessionRouter(
                    [DisaggReplica("rep0", sp, eng)], policy="rr")
                req = Request("c0", list(PROMPT), max_new_tokens=64)
                sess = await router.submit(req)
                ok = await router.cancel("c0")
                toks = await sess.tokens()
                missing = await router.cancel("ghost")
            return ok, missing, toks, sess.req.state
        ok, missing, toks, state = asyncio.run(main())
        assert ok is True
        assert missing is False
        assert state == RequestState.ABORTED_DEADLINE
        assert len(toks) < 64

    def test_least_policy_picks_unloaded_replica(self):
        set_flags({"telemetry": "off"})
        telemetry.reset()
        rep0 = DisaggReplica("rep0", SimpleNamespace(), SimpleNamespace())
        rep1 = DisaggReplica("rep1", SimpleNamespace(), SimpleNamespace())
        router = SessionRouter([rep0, rep1], policy="least")
        live = SimpleNamespace(req=SimpleNamespace(terminal=False))
        router._live["a"] = (rep0, live)
        router._live["b"] = (rep0, live)
        assert router._pick() is rep1
        assert router.num_sessions == 2

    def test_bad_policy_rejected(self):
        with pytest.raises(ValueError, match="policy"):
            SessionRouter([DisaggReplica("r", SimpleNamespace(),
                                         SimpleNamespace())],
                          policy="hash")
        with pytest.raises(ValueError, match="replica"):
            SessionRouter([])

    def test_router_gauges(self, tel_metrics):
        reg = tel_metrics

        async def main():
            sp, sd, _ = _mk_replica("rep0")
            async with ServingEngine(sd) as eng:
                router = SessionRouter([DisaggReplica("rep0", sp, eng)])
                sess = await router.submit(Request(
                    "g0", list(PROMPT), max_new_tokens=N_NEW))
                mid = reg.snapshot()
                await sess.tokens()
            return mid
        mid = asyncio.run(main())
        snap = reg.snapshot()
        assert snap["router"]["replicas"] == 1
        assert snap["router"]["submitted"] == 1
        assert snap["router"]["backpressure_state"] == 0
        assert snap["engine"]["adopted"] == 1
        assert mid["router"]["sessions"] >= 0


class TestRoleConfig:
    def test_apply_role_budgets(self):
        old = {"jit_budget_hbm": int(flag("jit_budget_hbm")),
               "jit_budget_comm": int(flag("jit_budget_comm"))}
        try:
            set_flags({"disagg_prefill_budget_hbm": 123456,
                       "disagg_prefill_budget_comm": 0})
            applied = apply_role_budgets("prefill")
            assert applied == {"jit_budget_hbm": 123456}
            assert int(flag("jit_budget_hbm")) == 123456
            assert int(flag("jit_budget_comm")) == old["jit_budget_comm"]
            assert apply_role_budgets("decode") == {}
            with pytest.raises(ValueError):
                apply_role_budgets("router")
        finally:
            set_flags(dict(old, disagg_prefill_budget_hbm=0,
                           disagg_prefill_budget_comm=0))

    def test_role_scheduler_kwargs(self):
        try:
            set_flags({"disagg_prefill_chunk_tokens": 96})
            assert role_scheduler_kwargs("prefill") == \
                {"prefill_chunk_tokens": 96}
            assert role_scheduler_kwargs("decode") == {}
            with pytest.raises(ValueError):
                role_scheduler_kwargs("frontend")
        finally:
            set_flags({"disagg_prefill_chunk_tokens": 0})
        assert role_scheduler_kwargs("prefill") == {}


# --------------------------------- lockstep with the JAX package's handoff
PAGE = 4
SWAP = 64 << 20
_RNG = np.random.RandomState(5)
LS_PROMPTS = {"a": _RNG.randint(1, 500, 13).tolist(),
              "b": _RNG.randint(1, 500, 6).tolist()}
LS_NEW = {"a": 5, "b": 4}


def _record(adapter, out):
    fn = adapter.prefill_chunk

    def rec(*a, **kw):
        y = fn(*a, **kw)
        out.append(np.asarray(y.numpy() if hasattr(y, "numpy")
                              else y._data, np.float32))
        return y

    adapter.prefill_chunk = rec


def _split(payload):
    header, buf = HostKVSwapSpace._parse_wire(payload)
    return header, buf


def _buffers(header, buf):
    """The payload's K/V (and scale) buffers as numpy arrays."""
    dt = {"float32": np.float32, "int8": np.int8}[
        header["geometry"]["kv_dtype"]]
    ps, hd = header["geometry"]["page_size"], header["geometry"]["head_dim"]
    heads = header["shard"]["heads"]
    out, off = [], 0
    for meta in header["records"]:
        n = meta["npriv"] * ps * heads * hd
        for _ in range(2):
            out.append(np.frombuffer(buf, dt, n, off))
            off += n * np.dtype(dt).itemsize
        if meta["quantized"]:
            for _ in range(2):
                out.append(np.frombuffer(buf, np.float32,
                                         meta["npriv"] * heads, off))
                off += meta["npriv"] * heads * 4
    assert off == len(buf)
    return out


def _books(jad, tad, where):
    for jc, tc in zip(jad.caches, tad.caches):
        assert (tc._tables, tc._lens, tc._free, tc._refcnt,
                tc._ext_refs) == (jc._tables, jc._lens, jc._free,
                                  jc._refcnt, jc._ext_refs), where
        tc.assert_ref_invariants()


@pytest.fixture
def both_metrics(monkeypatch):
    """Metrics on in both packages, with trace and span ids counted
    from 1 in both (the ids ride the envelope and the payload headers)."""
    for tel, flags in ((telemetry, set_flags),
                       (jax_telemetry, jax_set_flags)):
        flags({"telemetry": "metrics"})
        tel.reset()
        monkeypatch.setattr(tel, "_TRACE_SEQ", itertools.count(1))
        monkeypatch.setattr(tel, "_SPAN_SEQ", itertools.count(1))
    yield
    for tel, flags in ((telemetry, set_flags),
                       (jax_telemetry, jax_set_flags)):
        flags({"telemetry": "off"})
        tel.reset()


def _single_box_port(kv):
    _, tm = _pair("base")
    ta = PagedLlamaAdapter(tm, num_pages=32, page_size=PAGE,
                           max_length=128, kv_cache_dtype=kv)
    s = BatchScheduler(ta, prefill_chunk_tokens=8, serving_buckets="16")
    for rid, p in LS_PROMPTS.items():
        s.submit(Request(rid, list(p), max_new_tokens=LS_NEW[rid]))
    return {k: list(v.generated_ids)
            for k, v in s.run_until_complete().items()}


@pytest.mark.parametrize("kv,shards", [(None, 1), (None, 2),
                                       ("int8", 2)])
def test_handoff_lockstep_with_jax(both_metrics, kv, shards):
    atol = 2e-3 if kv == "int8" else 1e-4
    jm, tm = _pair("base")
    kw = dict(num_pages=32, page_size=PAGE, max_length=128,
              kv_cache_dtype=kv)
    skw = dict(prefill_chunk_tokens=8, serving_buckets="16",
               preempt=True, swap_bytes=SWAP)
    jpa, tpa = JaxAdapter(jm, **kw), PagedLlamaAdapter(tm, **kw)
    jda, tda = JaxAdapter(jm, **kw), PagedLlamaAdapter(tm, **kw)
    jl, tl = [], []
    for ad, out in ((jpa, jl), (tpa, tl), (jda, jl), (tda, tl)):
        _record(ad, out)
    jps, tps = JaxScheduler(jpa, **skw), BatchScheduler(tpa, **skw)
    jds, tds = JaxScheduler(jda, **skw), BatchScheduler(tda, **skw)

    def logits_agree():
        assert len(tl) == len(jl)
        for t, j in zip(tl, jl):
            np.testing.assert_allclose(t, j, atol=atol, rtol=0)
        tl.clear()
        jl.clear()

    envs = {}
    for rid, p in LS_PROMPTS.items():
        jk, jenv = JaxPrefillWorker(jps, mp_shards=shards).run(
            JaxRequest(rid, list(p), max_new_tokens=LS_NEW[rid]))
        tk, tenv = PrefillWorker(tps, mp_shards=shards).run(
            Request(rid, list(p), max_new_tokens=LS_NEW[rid]))
        assert tk == jk == "handoff"
        logits_agree()
        _books(jpa, tpa, rid)
        assert tenv["req"] == jenv["req"]
        assert tenv["req"]["trace_ctx"]
        assert len(tenv["payloads"]) == len(jenv["payloads"]) == shards
        for tp, jp in zip(tenv["payloads"], jenv["payloads"]):
            assert len(tp) == len(jp)
            (th, tb), (jh, jb) = _split(tp), _split(jp)
            assert th == jh
            for tbuf, jbuf in zip(_buffers(th, tb), _buffers(jh, jb)):
                if tbuf.dtype == np.int8:
                    diff = np.abs(tbuf.astype(int) - jbuf.astype(int))
                    assert diff.max() <= 1
                    assert (diff > 0).mean() <= 1e-3
                elif kv == "int8":
                    np.testing.assert_allclose(tbuf, jbuf, rtol=1e-4,
                                               atol=0)
                else:
                    np.testing.assert_allclose(tbuf, jbuf, atol=1e-4,
                                               rtol=0)
        envs[rid] = (jenv, tenv)
    for c in tpa.caches:
        assert c.num_free_pages == c.num_pages
    for rid, (jenv, tenv) in envs.items():
        jds.adopt_swapped(JaxDecodeWorker.request_from_envelope(jenv),
                          jenv["payloads"])
        tds.adopt_swapped(DecodeWorker.request_from_envelope(tenv),
                          tenv["payloads"])
    assert tds.num_swapped == jds.num_swapped == len(LS_PROMPTS)
    step = 0
    while tds.num_active or tds.num_swapped or tds.num_queued:
        jev, tev = jds.step(), tds.step()
        assert tev == jev, step
        logits_agree()
        _books(jda, tda, step)
        step += 1
        assert step < 100
    assert not jds.num_active and not jds.num_swapped
    ref = _single_box_port(kv)
    for rid in LS_PROMPTS:
        t, j = tds.result(rid), jds.result(rid)
        assert t.state == j.state == RequestState.FINISHED
        assert t.generated_ids == j.generated_ids == ref[rid]
    for c in tda.caches:
        assert c.num_free_pages == c.num_pages
    assert tds.swap_space.summary() == jds.swap_space.summary()
    tsnap = telemetry.registry().snapshot()
    jsnap = jax_telemetry.registry().snapshot()
    for ns, keys in (("serving", ("handoff_out_requests",
                                  "handoff_out_bytes",
                                  "handoff_in_requests",
                                  "handoff_in_bytes")),
                     ("pool", ("transfer_out_records",
                               "transfer_out_bytes",
                               "transfer_in_records",
                               "transfer_in_bytes"))):
        assert {k: tsnap[ns][k] for k in keys} == \
            {k: jsnap[ns][k] for k in keys}, ns
    assert tsnap["pool"]["transfer_out_bytes"] == \
        tsnap["pool"]["transfer_in_bytes"]


def test_port_payloads_adopt_into_the_jax_scheduler():
    """A chain the port's prefill worker exported decodes on the JAX
    package's decode scheduler to the tokens of the JAX single box."""
    jm, tm = _pair("base")
    kw = dict(num_pages=32, page_size=PAGE, max_length=128)
    skw = dict(prefill_chunk_tokens=8, serving_buckets="16",
               preempt=True, swap_bytes=SWAP)
    tps = BatchScheduler(PagedLlamaAdapter(tm, **kw), **skw)
    jds = JaxScheduler(JaxAdapter(jm, **kw), **skw)
    jref = JaxScheduler(JaxAdapter(jm, **kw), **skw)
    rid, p = "a", LS_PROMPTS["a"]
    _, env = PrefillWorker(tps, mp_shards=2).run(
        Request(rid, list(p), max_new_tokens=LS_NEW[rid]))
    # the envelope is plain data: it crosses as JSON and bytes
    env = {"req": json.loads(json.dumps(env["req"])),
           "payloads": [bytes(b) for b in env["payloads"]]}
    jds.adopt_swapped(JaxDecodeWorker.request_from_envelope(env),
                      env["payloads"])
    jref.submit(JaxRequest(rid, list(p), max_new_tokens=LS_NEW[rid]))
    got = jds.run_until_complete()[rid].generated_ids
    assert got == jref.run_until_complete()[rid].generated_ids
    assert isinstance(jds.swap_space, JaxSpace)
