"""The port's async serving engine (``inference/engine.py``), on the CPU.

The reference's ``tests/test_engine.py`` cases run against the port, over
the 1-layer torch paged decoder of ``tests/test_torch_fault_injection.py``:
one sanctioned pump thread owns every scheduler mutation, callers stream
tokens through asyncio ``TokenStream`` iterators (one loop hop a stream
and step), queued requests with lapsed deadlines abort before a prefill,
cancellation and consumer disconnect abort with deadline semantics, and
admission is gated on live goodput and watchdog signals with streak
hysteresis. Streamed output equals the synchronous loop's, under the
fault injector too, and the strict concurrency sanitizer sees no
violation with the pump, the consumers and an ops-server scraper live.

Against the JAX package: the two engines stream equal tokens over twin
``llama_tiny``-shaped adapters (weights through ``load_reference_state``,
float32 and int8 pools), and the two gates make the same transitions
for the same goodput and watchdog sequences (the reference's
``_StubSched``/``_StubWatchdog`` pattern, in both packages).

Port-only: a pump-thread error reaches every open stream, every queued
op and ``drain``/``shutdown`` as ``EngineClosedError``.
"""
import asyncio
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.framework import telemetry as jax_telemetry
from paddle_tpu.framework.flags import set_flags as jax_set_flags
from paddle_tpu.inference import BatchScheduler as JaxScheduler
from paddle_tpu.inference import PagedLlamaAdapter as JaxAdapter
from paddle_tpu.inference import Request as JaxRequest
from paddle_tpu.inference import ServingEngine as JaxEngine

from paddle_tpu_torch.framework import concurrency as conc
from paddle_tpu_torch.framework import ops_server, telemetry
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.incubate.nn.fault_injection import FaultInjector
from paddle_tpu_torch.inference import (
    BatchScheduler,
    EngineClosedError,
    EngineOverloadError,
    PagedLlamaAdapter,
    Request,
    RequestState,
    ServingEngine,
)
from paddle_tpu_torch.inference.engine import BP_CLAMP, BP_OPEN, BP_SHED

from test_torch_fault_injection import (HI_PROMPT, N_NEW, PROMPTS,
                                        TinyPagedDecoder)
from test_torch_llama_serving import _pair


@pytest.fixture
def tel_metrics():
    set_flags({"telemetry": "metrics"})
    telemetry.reset()
    conc.reset()
    yield telemetry.registry()
    set_flags({"telemetry": "off"})
    telemetry.reset()
    conc.reset()


@pytest.fixture
def tel_trace():
    set_flags({"telemetry": "trace"})
    telemetry.reset()
    conc.reset()
    yield telemetry.tracer()
    set_flags({"telemetry": "off"})
    telemetry.reset()
    conc.reset()


def _sched(faults=None, num_pages=24, **kw):
    torch.manual_seed(11)
    model = TinyPagedDecoder(num_pages=num_pages)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("preempt", True)
    kw.setdefault("swap_bytes", 64 << 20)
    inj = FaultInjector(faults) if faults is not None else None
    return model, BatchScheduler(model, fault_injector=inj, **kw)


def _reqs(priorities=None):
    pr = priorities or {}
    out = [Request(rid, list(p), max_new_tokens=N_NEW,
                   priority=pr.get(rid, 0))
           for rid, p in PROMPTS.items()]
    out.append(Request("hi", list(HI_PROMPT), max_new_tokens=N_NEW,
                       priority=pr.get("hi", 0)))
    return out


def _engine_run(sched, reqs):
    """Submit all requests through a live engine and drain every
    stream; returns {req_id: streamed token ids}."""

    async def main():
        async with ServingEngine(sched) as eng:
            streams = [await eng.submit(r) for r in reqs]
            return {s.req_id: await s.tokens() for s in streams}

    return asyncio.run(main())


_CLEAN = None


def _clean_run():
    """Synchronous hand-cranked reference (computed once)."""
    global _CLEAN
    if _CLEAN is None:
        _, sched = _sched(None)
        for r in _reqs():
            sched.submit(r)
        done = sched.run_until_complete(max_steps=4000)
        _CLEAN = {k: list(v.generated_ids) for k, v in done.items()}
    return _CLEAN


class TestStreaming:
    def test_streamed_output_greedy_identical(self, tel_metrics):
        _, sched = _sched(None)
        outs = _engine_run(sched, _reqs())
        assert outs == _clean_run()
        # the streamed view and the authoritative generated_ids agree
        for rid, toks in outs.items():
            assert toks == list(sched.result(rid).generated_ids)
            assert sched.result(rid).state == RequestState.FINISHED

    def test_engine_counters_and_gauges(self, tel_metrics):
        _, sched = _sched(None)
        _engine_run(sched, _reqs())
        reg = tel_metrics
        assert reg.gauge_value("engine.inflight_streams") == 0
        eng = reg.snapshot().get("engine", {})
        assert eng.get("submitted") == 5
        assert "step_lag_s" in eng  # pump step-lag histogram fed

    def test_submit_validation_errors_propagate(self, tel_metrics):
        _, sched = _sched(None)

        async def main():
            async with ServingEngine(sched) as eng:
                with pytest.raises(ValueError):
                    await eng.submit(Request("bad", []))

        asyncio.run(main())

    def test_not_started_and_closed_reject(self, tel_metrics):
        _, sched = _sched(None)
        eng = ServingEngine(sched)

        async def before():
            with pytest.raises(EngineClosedError):
                await eng.submit(Request("r", [1, 2]))

        asyncio.run(before())

        async def after():
            e2 = ServingEngine(sched)
            await e2.start()
            await e2.shutdown()
            with pytest.raises(EngineClosedError):
                await e2.submit(Request("r", [1, 2]))

        asyncio.run(after())


class TestFaultAdversity:
    @pytest.mark.parametrize("plan", [
        "exhaust@2+3",
        "preempt_storm@4:2",
        "preempt_storm@3:2,delay_swap_in@4+4",
        "fail_step@2+2",
        "exhaust@2+2,preempt_storm@5:2,delay_swap_in@8+3,"
        "fail_step@12+2",
    ])
    def test_streamed_output_identical_under_faults(
            self, tel_metrics, plan):
        _, sched = _sched(plan)
        outs = _engine_run(sched, _reqs())
        assert outs == _clean_run()
        assert sched._faults.summary()["fired"]  # plan consulted


class TestDeadlines:
    def test_expire_queued_deadlines_without_step(self, tel_metrics):
        """The satellite fix, unit level: a queued request whose
        deadline lapsed aborts via the public sweep with ZERO model
        work — no prefill burnt, counted under
        serving.aborted_deadline."""
        _, sched = _sched(None, max_batch_size=1)
        sched.submit(Request("keep", [1, 2, 3], max_new_tokens=2))
        sched.submit(Request("late", [4, 5, 6], max_new_tokens=2,
                             deadline_s=1e-6))
        assert sched.expire_queued_deadlines() == 1
        req = sched.result("late")
        assert req.state == RequestState.ABORTED_DEADLINE
        assert list(req.generated_ids) == []
        assert req._pos == 0  # never prefilled a single token
        assert tel_metrics.snapshot()["serving"][
            "aborted_deadline"] == 1
        assert sched.num_queued == 1  # "keep" untouched

    def test_pump_aborts_expired_queued_before_prefill(
            self, tel_metrics):
        """End to end: with one slot busy, a queued request whose
        deadline expires while waiting streams zero tokens and never
        reaches the model."""
        _, sched = _sched(None, max_batch_size=1)

        async def main():
            async with ServingEngine(sched) as eng:
                first = await eng.submit(
                    Request("r0", list(PROMPTS["r0"]),
                            max_new_tokens=N_NEW))
                late = await eng.submit(
                    Request("late", list(PROMPTS["r1"]),
                            max_new_tokens=N_NEW, deadline_s=1e-4))
                return await first.tokens(), await late.tokens(), late

        first_toks, late_toks, late_stream = asyncio.run(main())
        assert late_toks == []
        assert late_stream.aborted
        req = sched.result("late")
        assert req._pos == 0  # aborted from the queue, not mid-run
        assert first_toks == list(
            sched.result("r0").generated_ids)
        assert tel_metrics.snapshot()["serving"][
            "aborted_deadline"] == 1

    def test_scheduler_cancel_releases_everything(self, tel_metrics):
        _, sched = _sched(None)
        free0 = sched.model.caches[0].num_free_pages
        sched.submit(Request("a", [1, 2, 3, 4], max_new_tokens=8))
        sched.step()  # admitted + prefilling
        assert sched.cancel("a") is True
        assert sched.result("a").state == \
            RequestState.ABORTED_DEADLINE
        assert sched.model.caches[0].num_free_pages == free0
        assert sched.cancel("a") is False      # already terminal
        assert sched.cancel("ghost") is False  # unknown


class TestCancellation:
    def test_stream_cancel_mid_generation(self, tel_metrics):
        _, sched = _sched(None)

        async def main():
            async with ServingEngine(sched) as eng:
                keep = await eng.submit(
                    Request("keep", list(PROMPTS["r0"]),
                            max_new_tokens=N_NEW))
                gone = await eng.submit(
                    Request("gone", list(PROMPTS["r1"]),
                            max_new_tokens=64))
                first = await gone.__anext__()  # streaming works
                assert await gone.cancel() is True
                rest = await gone.tokens()
                return await keep.tokens(), [first] + rest

        keep_toks, gone_toks = asyncio.run(main())
        assert keep_toks == _clean_run()["r0"]
        req = sched.result("gone")
        assert req.state == RequestState.ABORTED_DEADLINE
        # the stream saw exactly what was committed before the abort
        assert gone_toks == list(req.generated_ids)
        eng_ns = tel_metrics.snapshot().get("engine", {})
        assert eng_ns.get("cancelled") == 1

    def test_consumer_disconnect_propagates_abort(self, tel_metrics):
        _, sched = _sched(None)

        async def main():
            async with ServingEngine(sched) as eng:
                stream = await eng.submit(
                    Request("d", list(PROMPTS["r2"]),
                            max_new_tokens=64))

                async def consume():
                    async for _ in stream:
                        pass

                task = asyncio.ensure_future(consume())
                # let some tokens arrive, then disconnect the client
                await asyncio.sleep(0.05)
                task.cancel()
                with pytest.raises(asyncio.CancelledError):
                    await task
                await eng.drain()

        asyncio.run(main())
        req = sched.result("d")
        assert req.state == RequestState.ABORTED_DEADLINE
        assert len(req.generated_ids) < 64


class _StubWatchdog:
    def __init__(self):
        self.counts = {}

    def summary(self):
        return {"by_class": dict(self.counts)}


class _StubSched:
    """Just enough scheduler surface for gate unit tests."""
    num_queued = num_active = num_swapped = 0

    def __init__(self, wd=None):
        self.watchdog = wd


@pytest.fixture
def gate_flags():
    set_flags({"engine_trip_steps": 2, "engine_recover_steps": 3,
               "engine_min_window": 4, "engine_gate_stride": 1})
    yield
    set_flags({"engine_trip_steps": 2, "engine_recover_steps": 4,
               "engine_min_window": 4, "engine_gate_stride": 2})


class TestBackpressureGate:
    """Unit tests drive _gate_eval directly (no pump; sanitizer off
    in this world, so there is no writer-thread constraint)."""

    def _eng(self, reg, goodput=None, window=10, wd=None):
        if goodput is not None:
            reg.gauge("serving.goodput", goodput)
            reg.gauge("serving.slo_window_requests", window)
        return ServingEngine(_StubSched(wd))

    def test_trip_requires_streak(self, tel_metrics, gate_flags):
        eng = self._eng(tel_metrics, goodput=0.2)
        eng._gate_eval()
        assert eng._bp_state == BP_OPEN  # one bad eval is not enough
        eng._gate_eval()
        assert eng._bp_state == BP_SHED
        assert "goodput" in eng._bp_reason
        assert tel_metrics.gauge_value(
            "engine.backpressure_state") == BP_SHED

    def test_escalates_shed_then_clamp(self, tel_metrics,
                                       gate_flags):
        eng = self._eng(tel_metrics, goodput=0.1)
        for _ in range(4):
            eng._gate_eval()
        assert eng._bp_state == BP_CLAMP
        assert eng._trips == 2
        # shed rejects only below the keep priority; clamp rejects all
        assert eng._gate_admit(Request("hi", [1], priority=5)) \
            is not None

    def test_shed_keeps_high_priority(self, tel_metrics, gate_flags):
        eng = self._eng(tel_metrics, goodput=0.1)
        eng._gate_eval()
        eng._gate_eval()
        assert eng._bp_state == BP_SHED
        assert eng._gate_admit(Request("lo", [1], priority=0)) \
            is not None
        assert eng._gate_admit(Request("hi", [1], priority=1)) \
            is None

    def test_hysteresis_band_freezes_both_streaks(self, tel_metrics,
                                                  gate_flags):
        eng = self._eng(tel_metrics, goodput=0.2)
        eng._gate_eval()
        eng._gate_eval()
        assert eng._bp_state == BP_SHED
        # in-band goodput: neither further trips nor recovery
        tel_metrics.gauge("serving.goodput", 0.8)
        for _ in range(10):
            eng._gate_eval()
        assert eng._bp_state == BP_SHED
        assert eng._good_streak == 0 and eng._bad_streak == 0

    def test_recovery_streak_de_escalates(self, tel_metrics,
                                          gate_flags):
        eng = self._eng(tel_metrics, goodput=0.2)
        for _ in range(4):
            eng._gate_eval()
        assert eng._bp_state == BP_CLAMP
        tel_metrics.gauge("serving.goodput", 0.95)
        for _ in range(3):
            eng._gate_eval()
        assert eng._bp_state == BP_SHED  # one level per streak
        for _ in range(3):
            eng._gate_eval()
        assert eng._bp_state == BP_OPEN
        assert eng._recoveries == 2
        assert tel_metrics.gauge_value(
            "engine.backpressure_state") == BP_OPEN

    def test_small_slo_window_is_ignored(self, tel_metrics,
                                         gate_flags):
        eng = self._eng(tel_metrics, goodput=0.0, window=2)
        for _ in range(6):
            eng._gate_eval()
        assert eng._bp_state == BP_OPEN  # 2 < engine_min_window

    def test_watchdog_events_trip_gate(self, tel_metrics,
                                       gate_flags):
        wd = _StubWatchdog()
        eng = self._eng(tel_metrics, wd=wd)
        wd.counts["decode-stall"] = 1
        eng._gate_eval()   # fresh event: bad
        wd.counts["decode-stall"] = 2
        eng._gate_eval()   # another fresh event: streak of 2
        assert eng._bp_state == BP_SHED
        assert "decode-stall" in eng._bp_reason
        # a stable count is NOT a fresh event: recovery proceeds
        for _ in range(3):
            eng._gate_eval()
        assert eng._bp_state == BP_OPEN

    def test_prefix_collapse_does_not_trip(self, tel_metrics,
                                           gate_flags):
        wd = _StubWatchdog()
        eng = self._eng(tel_metrics, wd=wd)
        for i in range(6):
            wd.counts["prefix-collapse"] = i + 1
            eng._gate_eval()
        assert eng._bp_state == BP_OPEN

    def test_transitions_visible_on_enginez_info(self, tel_metrics,
                                                 gate_flags):
        eng = self._eng(tel_metrics, goodput=0.2)
        eng._gate_eval()
        eng._gate_eval()
        info = eng._enginez_info()
        assert info["backpressure"]["state"] == "shed"
        assert info["backpressure"]["trips"] == 1
        assert info["backpressure"]["transitions"][0]["state"] == \
            "shed"
        assert "goodput" in info["backpressure"]["reason"]


class TestLiveShed:
    def test_live_trip_shed_and_recover(self, tel_metrics):
        """Live pump: preset bad goodput trips backpressure off the
        real gate-eval path during r0's steps, a low-priority
        submission is shed with EngineOverloadError, and restoring
        healthy goodput recovers the gate (idle evals) until the
        same submission is admitted again — trip AND recovery on
        live signals, visible on /enginez state."""
        set_flags({"engine_trip_steps": 1, "engine_gate_stride": 1,
                   "engine_recover_steps": 2})
        try:
            _, sched = _sched(None)
            # no SLO config on this scheduler, so these preset
            # gauges are never republished by _publish_slo_gauges
            tel_metrics.gauge("serving.goodput", 0.1)
            tel_metrics.gauge("serving.slo_window_requests", 16)

            async def main():
                async with ServingEngine(sched) as eng:
                    s0 = await eng.submit(
                        Request("r0", list(PROMPTS["r0"]),
                                max_new_tokens=N_NEW))
                    await s0.tokens()  # steps ran -> gate tripped
                    tripped = eng._enginez_info()["backpressure"]
                    with pytest.raises(EngineOverloadError):
                        await eng.submit(
                            Request("lo", list(PROMPTS["r1"]),
                                    max_new_tokens=2, priority=0))
                    shed = eng._enginez_info()["last_shed"]
                    # live recovery: healthy goodput + idle pump
                    tel_metrics.gauge("serving.goodput", 0.97)
                    stream = None
                    for _ in range(400):
                        try:
                            stream = await eng.submit(
                                Request("lo2", list(PROMPTS["r1"]),
                                        max_new_tokens=2,
                                        priority=0))
                            break
                        except EngineOverloadError:
                            await asyncio.sleep(0.01)
                    assert stream is not None, "never recovered"
                    await stream.tokens()
                    return tripped, shed, eng._enginez_info()

            tripped, shed, final = asyncio.run(main())
            assert tripped["state"] in ("shed", "clamp")
            assert tripped["trips"] >= 1
            assert shed[0]["req_id"] == "lo"
            assert final["backpressure"]["recoveries"] >= 1
            eng_ns = tel_metrics.snapshot().get("engine", {})
            assert eng_ns.get("shed_total", 0) >= 1
            assert sched.result("lo2").state == RequestState.FINISHED
        finally:
            set_flags({"engine_trip_steps": 2,
                       "engine_gate_stride": 2,
                       "engine_recover_steps": 4})


class TestTraceStitching:
    def test_one_trace_id_per_request(self, tel_trace):
        _, sched = _sched(None)
        reqs = [Request(rid, list(PROMPTS[rid]), max_new_tokens=4)
                for rid in ("r0", "r1")]
        outs = _engine_run(sched, reqs)
        book = telemetry.request_traces()
        for rid in ("r0", "r1"):
            tr = book.get(rid)
            assert tr is not None and tr.done
            kinds = tr.kinds()
            assert kinds[0] == "submit"
            assert kinds[-1] == "retire"
            # streamed tokens match the trace's token timeline
            assert kinds.count("token") == len(outs[rid])
            # ONE stitched trace id: the id stamped at submit is the
            # id the retired request still carries
            req = sched.result(rid)
            assert req.trace_ctx is not None
            assert tr.first("submit")["trace_id"] == \
                req.trace_ctx.trace_id


class TestStrictSanitizer:
    def test_pump_streams_and_scraper_all_clean(self):
        """Acceptance (d): pump thread + stream consumers + a live
        ops-server scraper thread under
        FLAGS_concurrency_sanitizer=strict — zero violations, and
        /enginez served the engine section while it was live."""
        set_flags({"telemetry": "metrics",
                   "concurrency_sanitizer": "strict"})
        telemetry.reset()
        conc.reset()
        srv = ops_server.maybe_start(port=0)
        set_flags({"ops_server_port": srv.port})
        pages = []
        stop = [False]

        def scrape():
            base = srv.url
            while not stop[0]:
                for ep in ("/enginez", "/metrics"):
                    with urllib.request.urlopen(base + ep,
                                                timeout=5) as r:
                        pages.append((ep, r.read().decode()))
        try:
            _, sched = _sched(None)
            t = conc.spawn_thread("test-enginez-scraper", scrape)
            outs = _engine_run(sched, _reqs())
            stop[0] = True
            t.join(timeout=10)
            assert outs == _clean_run()
            san = conc.sanitizer()
            st = san.stats()
            assert st.get("violations", 0) == 0, san.tail(16)
            engz = [b for ep, b in pages if ep == "/enginez"]
            assert engz, "scraper never reached /enginez"
            assert any("engine.e" in b for b in engz), \
                "no live engine section ever rendered"
        finally:
            stop[0] = True
            ops_server.stop()
            set_flags({"ops_server_port": 0,
                       "concurrency_sanitizer": "off",
                       "telemetry": "off"})
            telemetry.reset()
            conc.reset()


class TestDrainShutdown:
    def test_drain_completes_inflight_then_rejects(self, tel_metrics):
        _, sched = _sched(None)

        async def main():
            eng = await ServingEngine(sched).start()
            s = await eng.submit(Request("a", list(PROMPTS["r0"]),
                                         max_new_tokens=4))
            await eng.drain()
            assert sched.result("a").state == RequestState.FINISHED
            with pytest.raises(EngineClosedError):
                await eng.submit(Request("b", [1, 2]))
            toks = await s.tokens()
            assert toks == list(sched.result("a").generated_ids)
            await eng.shutdown(drain=False)

        asyncio.run(main())

    def test_context_manager_drains_on_clean_exit(self, tel_metrics):
        _, sched = _sched(None)

        async def main():
            async with ServingEngine(sched) as eng:
                await eng.submit(Request("a", list(PROMPTS["r1"]),
                                         max_new_tokens=3))
            # __aexit__ drained before stopping
            assert sched.result("a").state == RequestState.FINISHED

        asyncio.run(main())


# ------------------------------------------------ against the JAX package
_RNG = np.random.RandomState(3)
TWIN_PROMPTS = {"a": _RNG.randint(1, 500, 11).tolist(),
                "b": _RNG.randint(1, 500, 5).tolist(),
                "c": _RNG.randint(1, 500, 17).tolist()}
TWIN_NEW = {"a": 5, "b": 7, "c": 3}


def _engine_tokens(engine_cls, sched, req_cls):
    async def main():
        async with engine_cls(sched) as eng:
            streams = [await eng.submit(req_cls(
                rid, list(p), max_new_tokens=TWIN_NEW[rid]))
                for rid, p in TWIN_PROMPTS.items()]
            return {s.req_id: await s.tokens() for s in streams}

    return asyncio.run(main())


@pytest.mark.parametrize("kv", [None, "int8"])
def test_streams_equal_the_jax_engine(kv):
    jm, tm = _pair("base")
    kw = dict(num_pages=32, page_size=4, max_length=128,
              kv_cache_dtype=kv)
    skw = dict(prefill_chunk_tokens=8, serving_buckets="16")
    js = JaxScheduler(JaxAdapter(jm, **kw), **skw)
    ts = BatchScheduler(PagedLlamaAdapter(tm, **kw), **skw)
    jt = _engine_tokens(JaxEngine, js, JaxRequest)
    tt = _engine_tokens(ServingEngine, ts, Request)
    assert tt == jt
    for rid, toks in tt.items():
        assert toks == ts.result(rid).generated_ids
        assert len(toks) == TWIN_NEW[rid]


def _gate_pair():
    """A JAX and a port engine over stub schedulers, each with its own
    stub watchdog, and both registries."""
    wds = (_StubWatchdog(), _StubWatchdog())
    return (JaxEngine(_StubSched(wds[0])), ServingEngine(
        _StubSched(wds[1]))), wds


GATE_SEQ = [
    # (goodput, window, {watchdog class: count})
    (0.2, 10, {}), (0.2, 10, {}), (0.3, 10, {}), (0.1, 10, {}),
    (0.8, 10, {}), (0.8, 10, {}), (0.95, 10, {}), (0.95, 10, {}),
    (0.95, 10, {"decode-stall": 1}), (0.95, 10, {"decode-stall": 2}),
    (0.95, 10, {"decode-stall": 2}), (0.95, 2, {}), (0.0, 2, {}),
    (0.0, 10, {"prefix-collapse": 3}), (0.97, 10, {"pool-pressure": 1}),
    (0.97, 10, {"pool-pressure": 1}), (0.97, 10, {}), (0.97, 10, {}),
    (0.97, 10, {}), (0.97, 10, {}), (0.97, 10, {}), (0.97, 10, {}),
]


@pytest.fixture
def both_gate_flags():
    fl = {"telemetry": "metrics", "engine_trip_steps": 2,
          "engine_recover_steps": 3, "engine_min_window": 4,
          "engine_gate_stride": 1}
    for tel, flags in ((telemetry, set_flags),
                       (jax_telemetry, jax_set_flags)):
        flags(fl)
        tel.reset()
    yield
    for tel, flags in ((telemetry, set_flags),
                       (jax_telemetry, jax_set_flags)):
        flags({"telemetry": "off", "engine_trip_steps": 2,
               "engine_recover_steps": 4, "engine_min_window": 4,
               "engine_gate_stride": 2})
        tel.reset()


def test_gate_transitions_equal_the_jax_engine(both_gate_flags):
    (je, te), (jwd, twd) = _gate_pair()
    regs = (jax_telemetry.registry(), telemetry.registry())
    seen = []
    for gp, win, wd in GATE_SEQ:
        for reg, w in zip(regs, (jwd, twd)):
            reg.gauge("serving.goodput", gp)
            reg.gauge("serving.slo_window_requests", win)
            w.counts.update(wd)
        je._gate_eval()
        te._gate_eval()
        state = (te._bp_state, te._bp_reason, te._bad_streak,
                 te._good_streak, te._trips, te._recoveries)
        assert state == (je._bp_state, je._bp_reason, je._bad_streak,
                         je._good_streak, je._trips, je._recoveries)
        for prio in (0, 1, 5):
            assert te._gate_admit(Request("x", [1], priority=prio)) == \
                je._gate_admit(JaxRequest("x", [1], priority=prio))
        seen.append(te._bp_state)
    assert te._enginez_info()["backpressure"] == \
        je._enginez_info()["backpressure"]
    assert regs[1].gauge_value("engine.backpressure_state") == \
        regs[0].gauge_value("engine.backpressure_state")
    # the sequence visits every level and comes back
    assert {BP_OPEN, BP_SHED, BP_CLAMP} <= set(seen)
    assert seen[-1] == BP_OPEN


# ------------------------------------------------------- pump errors
class _Boom(RuntimeError):
    pass


def test_pump_error_reaches_streams_ops_and_shutdown(tel_metrics):
    model, sched = _sched(None)
    inner = model.decode_token

    def failing(token_ids, seq_ids):
        # the first step that batches every request fails
        if len(seq_ids) == len(PROMPTS):
            raise _Boom("device fault with the batch full")
        return inner(token_ids, seq_ids)

    model.decode_token = failing

    async def main():
        eng = await ServingEngine(sched).start()
        streams = [await eng.submit(Request(rid, list(p),
                                            max_new_tokens=N_NEW))
                   for rid, p in PROMPTS.items()]
        errors = []
        for s in streams:
            with pytest.raises(EngineClosedError, match="_Boom") as e:
                await s.tokens()
            errors.append(str(e.value))
        with pytest.raises(EngineClosedError):
            await eng.submit(Request("late", [1, 2]))
        with pytest.raises(EngineClosedError, match="device fault"):
            await eng.shutdown()
        return errors, eng

    errors, eng = asyncio.run(main())
    assert len(errors) == len(PROMPTS)
    assert "device fault with the batch full" in \
        eng._enginez_info()["pump"]["error"]
    assert eng._thread is None
