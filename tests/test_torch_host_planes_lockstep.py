"""The host planes of the port's serving scheduler in lockstep with the
JAX package's, on the CPU.

Both schedulers run with ``FLAGS_telemetry=trace``, an SLO
(``FLAGS_telemetry_slo``), the watchdog (``warn``, stride 4), a strict
page sanitizer on every pool (target and draft) and the same fault plan
(``FLAGS_serving_faults``: every kind), on a fake clock patched into
both ``telemetry`` modules that advances 0.125 s between steps. The
lockstep harnesses of ``tests/test_torch_spec_serving.py`` (speculative
serving, ragged and legacy, with a draft) and
``tests/test_torch_overload.py`` (the prefix cache with copy-on-write
forks; preemption to the host swap tier) already hold the event dicts,
the pools' books and every model call's logits (within 1e-4 on float32
pools; 2e-3 on the speculative int8 pools, where a K/V value within
float32 rounding of a code boundary quantizes one code apart). On top,
after every step:

* the two ``metrics()`` snapshots are equal: counters and gauges
  exactly, histograms exactly (the fake clock makes every duration a
  multiple of the step); OpenMetrics exemplars are compared without
  their labels, which are per-process trace ids;
* the request traces are equal event by event (trace ids aside);
* the span ring is equal: names, nesting (depth, path), attributes and
  times;
* each pool's sanitizer journal is equal event by event, with no
  violation, for target and draft pools alike;
* the fault injectors' event logs are equal.

Each case runs on float32 and int8 pools.
"""
import pytest

from paddle_tpu.framework import flags as jax_flags
from paddle_tpu.framework import telemetry as jax_telemetry
from paddle_tpu.framework.telemetry import SLOConfig as JaxSLO
from paddle_tpu.framework.watchdog import Watchdog as JaxWatchdog
from paddle_tpu.incubate.nn.fault_injection import \
    FaultInjector as JaxInjector
from paddle_tpu.inference import serving as jax_serving

from paddle_tpu_torch.framework import flags as port_flags
from paddle_tpu_torch.framework import telemetry as port_telemetry
from paddle_tpu_torch.framework.telemetry import SLOConfig
from paddle_tpu_torch.framework.watchdog import Watchdog
from paddle_tpu_torch.incubate.nn.fault_injection import FaultInjector
from paddle_tpu_torch.inference import serving as port_serving

import test_torch_overload as overload
import test_torch_spec_serving as spec

FAULTS = "exhaust@3+2,preempt_storm@6:1,delay_swap_in@7+2,fail_step@11+2"
SLO = "ttft_p99_s=1.5,tpot_p99_s=0.25,queue_wait_p99_s=0.5"
FLAGS = {"telemetry": "trace", "telemetry_slo": SLO,
         "telemetry_watchdog": "warn", "telemetry_watchdog_stride": 4,
         "telemetry_window": 16, "page_sanitizer": "strict",
         "page_sanitizer_stride": 3, "serving_faults": FAULTS}
STEP_S = 0.125  # the fake clock's step: exact in binary


@pytest.fixture
def planes(monkeypatch):
    """Every plane on in both packages, fresh registries, scheduler uids
    counted from 1 in both, and a shared fake clock (a one-element
    list the checks advance)."""
    old_j = {k: jax_flags.flag(k) for k in FLAGS}
    old_t = {k: port_flags.flag(k) for k in FLAGS}
    jax_flags.set_flags(FLAGS)
    port_flags.set_flags(FLAGS)
    jax_telemetry.reset()
    port_telemetry.reset()
    monkeypatch.setattr(jax_serving, "_SCHED_SEQ", [0])
    monkeypatch.setattr(port_serving, "_SCHED_SEQ", [0])
    now = [1000.0]
    monkeypatch.setattr(jax_telemetry, "_clock", lambda: now[0])
    monkeypatch.setattr(port_telemetry, "_clock", lambda: now[0])
    yield now
    jax_flags.set_flags(old_j)
    port_flags.set_flags(old_t)
    jax_telemetry.reset()
    port_telemetry.reset()


def _strip_exemplars(tree):
    """The snapshot with each exemplar's label (a per-process trace id)
    dropped; its bucket and value stay."""
    if isinstance(tree, dict):
        return {k: ([[b, v] for b, _, v in val] if k == "exemplars"
                    else _strip_exemplars(val))
                for k, val in tree.items()}
    if isinstance(tree, list):
        return [_strip_exemplars(v) for v in tree]
    return tree


def _traces(book):
    return [(t.req_id, t.lane, t.done,
             [{k: v for k, v in ev.items() if k != "trace_id"}
              for ev in t.events])
            for t in book.traces()]


def _spans(tracer):
    return [(s.name, s.depth, s.path, dict(s.attrs), s.t0, s.dur)
            for s in tracer.spans()]


class Checker:
    """The per-step comparison of every plane; counts what it saw."""

    def __init__(self, now):
        self.now = now
        self.steps = 0
        self.metrics = self.kinds = None

    def __call__(self, step, js, ts, pairs, now=None):
        jm, tm = js.metrics(), ts.metrics()
        assert _strip_exemplars(tm) == _strip_exemplars(jm), step
        traces = _traces(port_telemetry.request_traces())
        assert traces == _traces(jax_telemetry.request_traces()), step
        assert _spans(port_telemetry.tracer()) == _spans(
            jax_telemetry.tracer()), step
        for jad, tad in pairs:
            for jc, tc in zip(jad.caches, tad.caches):
                assert tc.sanitizer._events == jc.sanitizer._events, step
                assert tc.sanitizer.counts == jc.sanitizer.counts, step
                assert tc.sanitizer.violations == 0
        assert ts._faults.events() == js._faults.events(), step
        self.steps += 1
        self.now[0] += STEP_S
        # the last step's readings (a harness may serve more after the
        # lockstep, into the same registry)
        self.metrics = tm
        self.kinds = [[ev["kind"] for ev in t[3]] for t in traces]


def _check_end(ts, checker, programs=("prefill_chunk",)):
    """What the lockstep run must have exercised, by its last readings
    (``programs``: the ledger's rows, the model calls stamped)."""
    m = checker.metrics
    assert checker.steps == m["serving"]["steps"] > 0
    assert m["serving"]["ttft_s"]["count"] == len(ts._finished)
    assert m["slo"] and "goodput" in m["serving"]
    assert m["sanitizer"]["events"] > 0
    assert m["sanitizer"]["violations"] == 0
    assert m["sanitizer"]["crosschecks"] > 0
    assert m["watchdog"]["checks"] > 0
    assert set(m["ledger"]) == set(programs)
    kinds = {e["kind"] for e in ts._faults.events()}
    assert {"exhaust", "preempt_storm", "fail_step"} <= kinds
    assert len(checker.kinds) == len(ts._finished)
    for k in checker.kinds:
        assert k[0] == "submit" and k[-1] == "retire" and "admit" in k
        assert "token" in k


@pytest.mark.parametrize("mode,kv", [("ragged", None), ("ragged", "int8"),
                                     ("legacy", None), ("legacy", "int8")])
def test_spec_serving_planes_lockstep(planes, mode, kv):
    checker = Checker(planes)
    ts, js, ta, tda, ev, _ = spec._lockstep(spec.BASE_PLAN, spec=mode,
                                            kv=kv, check=checker)
    # the legacy lowering stamps no model call, as the reference's
    _check_end(ts, checker, ("draft_propose", "prefill_chunk")
               if mode == "ragged" else ())
    m = checker.metrics
    assert m["serving"]["spec_rounds"] > 0
    assert m["serving"]["spec_accept_rate"]["count"] > 0
    if mode == "ragged":
        names = {s.name for s in port_telemetry.tracer().spans()}
        assert "serving.draft_propose" in names


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefix_cache_planes_lockstep(planes, monkeypatch, kv):
    checker = Checker(planes)
    ts, js, ta, ev = overload._lockstep(
        overload._prefix_plan(), monkeypatch, "auto", kv, num_pages=24,
        max_batch_size=3, prefix_cache=True, check=checker)
    _check_end(ts, checker)
    m = checker.metrics
    assert m["prefix"]["hits"] > 0 and m["pool"]["cow_forks"] > 0
    ops = ta.caches[0].sanitizer.counts
    assert ops["fork"] > 0 and ops["chain-check"] > 0
    assert ops["note:prefix-insert"] > 0


@pytest.mark.parametrize("kv", [None, "int8"])
def test_preemption_planes_lockstep(planes, monkeypatch, kv):
    checker = Checker(planes)
    ts, js, ta, ev = overload._lockstep(
        overload._preempt_plan(True), monkeypatch, "auto", kv,
        num_pages=20, max_batch_size=4, prefix_cache=True, check=checker)
    _check_end(ts, checker)
    m = checker.metrics
    assert m["serving"]["preempt_victims"] >= 2
    assert m["serving"]["swap_in_requests"] == \
        m["serving"]["preempt_victims"]
    ops = ta.caches[0].sanitizer.counts
    assert ops["swap_out"] > 0 and ops["swap_in"] > 0
    names = {s.name for s in port_telemetry.tracer().spans()}
    assert {"serving.preempt", "serving.swap_in"} <= names


def test_explicit_planes_lockstep(planes, monkeypatch):
    """``slo=``, ``watchdog=`` and ``fault_injector=`` passed to the
    constructor, in place of the flags, give the same lockstep."""
    for flg in (jax_flags, port_flags):
        flg.set_flags({"telemetry_slo": "", "serving_faults": "",
                       "telemetry_watchdog": "off"})
    own = []
    for tel, slo, wd, inj in (
            (jax_telemetry, JaxSLO, JaxWatchdog, JaxInjector),
            (port_telemetry, SLOConfig, Watchdog, FaultInjector)):
        own.append((
            ("slo", slo(ttft_p99_s=1.5, tpot_p99_s=0.25)),
            ("watchdog", wd(tel.registry(), mode="warn", window=16)),
            ("fault_injector", inj(FAULTS))))
    checker = Checker(planes)
    ts, js, ta, ev = overload._lockstep(
        overload._preempt_plan(False), monkeypatch, "auto", None,
        num_pages=16, max_batch_size=4, check=checker, own_kw=own)
    _check_end(ts, checker)
    assert ts._slo is own[1][0][1] and ts.watchdog is own[1][1][1]
    assert ts._faults is own[1][2][1]
    assert ts.metrics()["slo"] == js.metrics()["slo"] == {
        "ttft_p99_s": 1.5, "tpot_p99_s": 0.25, "queue_wait_p99_s": None}
