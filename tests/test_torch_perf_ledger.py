"""The port's per-program performance ledger (paddle_tpu_torch/framework/
perf_ledger.py) and incident flight recorder (framework/
flight_recorder.py), by the reference's own unit tests:
fake-clock exactness of the ledger math (planned flops / measured
wall -> exact MFU), the plan-vs-actual join through a live scheduler,
the seeded plan-drift watchdog class with hysteresis, off-mode
zero-allocation gates, the incident-bundle round trip
(trip -> bundle -> --summarize-incident reconstructs the story),
truncated-bundle tolerance matching the telemetry CLI's
truncated-JSONL contract, and the namespaced per-scheduler
serving.compile_count gauges.

Left out: the rule inventory of ``framework.analysis`` (the jaxpr lint)
and the autotuner's measurement over partial rows (the autotuner drives
a ``ServingEngine``, which comes with the engine)."""
import json
import math
import os
import tracemalloc
import warnings

import numpy as np
import pytest

from paddle_tpu_torch.framework import flight_recorder as _fr_mod
from paddle_tpu_torch.framework import perf_ledger, telemetry
from paddle_tpu_torch.framework.flags import flag, set_flags
from paddle_tpu_torch.framework.perf_ledger import PerfLedger
from paddle_tpu_torch.framework.watchdog import WATCHDOG_CLASSES, Watchdog
from paddle_tpu_torch.inference import BatchScheduler, Request


@pytest.fixture
def tel_off():
    set_flags({"telemetry": "off"})
    telemetry.reset()
    yield
    set_flags({"telemetry": "off"})
    telemetry.reset()


@pytest.fixture
def tel_metrics():
    set_flags({"telemetry": "metrics"})
    telemetry.reset()
    yield telemetry.registry()
    set_flags({"telemetry": "off", "telemetry_incident_dir": ""})
    telemetry.reset()


# -- host-only fakes (the test_telemetry.py scheduler protocol) -------------


class _FakeCache:
    def __init__(self, num_pages=1024, page_size=4):
        self.num_pages = num_pages
        self.page_size = page_size
        self.lens = {}

    @property
    def num_free_pages(self):
        used = sum(-(-n // self.page_size) if n else 0
                   for n in self.lens.values())
        return self.num_pages - used

    def seq_len(self, s):
        return self.lens[s]

    def truncate(self, s, n):
        self.lens[s] = n

    def attach(self, s, pages, length):
        self.lens[s] = int(length)

    def seq_pages(self, s):
        return []

    def pending_cow(self, s):
        return False


class _FakeChunkModel:
    """Ragged chunked-prefill fake emitting token 1; optionally
    advances a fake clock by ``call_wall`` inside every
    prefill_chunk call (so exec.wall_s samples are EXACT)."""

    def __init__(self, vocab=16, num_pages=1024, clock_box=None,
                 call_wall=0.0):
        self.vocab = vocab
        self.caches = [_FakeCache(num_pages=num_pages)]
        self.clock_box = clock_box
        self.call_wall = call_wall
        self.compile_count = 0

    def alloc(self, sid):
        self.caches[0].lens[sid] = 0

    def free(self, sid):
        del self.caches[0].lens[sid]

    def attach_prefix(self, sid, chains, length):
        for c, chain in zip(self.caches, chains):
            c.attach(sid, chain, length)

    def seq_page_chains(self, sid):
        return [c.seq_pages(sid) for c in self.caches]

    def prefill_chunk(self, feeds, rows, starts, pad_to=None):
        if self.clock_box is not None:
            self.clock_box[0] += self.call_wall
        c = self.caches[0]
        for s, f in zip(rows, feeds):
            c.lens[s] += len(f)
        logits = np.zeros((len(rows), self.vocab), np.float32)
        logits[:, 1] = 1.0
        return logits


_PLAN = {
    "flops_total": 2e9, "hbm_peak_bytes": 3e6,
    "input_bytes": 3e6, "donated_bytes": 1e6, "const_bytes": 2e6,
    "output_bytes": 2e6, "transient_peak_bytes": 5e5,
    "comm_bytes_total": 4e5,
}  # hbm_bytes_per_call = 8e6


class _PlanObj:
    """Duck-typed ResourcePlan stand-in (attribute access only)."""

    def __init__(self, **kw):
        for k, v in _PLAN.items():
            setattr(self, k, v)
        for k, v in kw.items():
            setattr(self, k, v)


# -- ledger math -------------------------------------------------------------


class TestLedgerMath:
    def test_plan_summary_duck_types_and_derives_bytes(self, tel_off):
        for plan in (_PlanObj(), dict(_PLAN)):
            s = perf_ledger.plan_summary(plan)
            assert s["flops_total"] == 2e9
            assert s["hbm_bytes_per_call"] == 8e6  # in+don+const+out

    def test_exact_mfu_from_known_walls(self, tel_metrics):
        reg = tel_metrics
        led = PerfLedger(reg, peak_flops=1e10, peak_hbm_gbs=1.0,
                         drift_ratio=4.0, window=64)
        led.register_plan("p", dict(_PLAN))
        for _ in range(4):
            led.record("p", 0.5)  # 4 invocations of exactly 500ms
        row = led.report()["p"]
        assert row["count"] == 4
        assert row["total_wall_s"] == pytest.approx(2.0)
        assert row["mean_wall_s"] == pytest.approx(0.5)
        # planned flops / measured wall -> EXACT attained + MFU
        assert row["attained_flops_per_s"] == pytest.approx(4e9)
        assert row["mfu"] == pytest.approx(0.4)
        assert row["hbm_bytes_per_s"] == pytest.approx(8e6 / 0.5)
        assert row["wire_bytes_per_s"] == pytest.approx(4e5 / 0.5)
        assert row["ai_planned"] == pytest.approx(2e9 / 8e6)
        # predicted wall: max(2e9/1e10, 8e6/1e9) = 0.2s; sustained
        # measured 0.5s -> drift ratio 0.4 (plan is conservative, ok)
        assert row["predicted_wall_s"] == pytest.approx(0.2)
        assert row["drift_ratio"] == pytest.approx(0.4)
        assert row["drifting"] is False

    def test_walls_without_plan_and_plan_without_walls(self,
                                                      tel_metrics):
        reg = tel_metrics
        led = PerfLedger(reg, peak_flops=1e10, peak_hbm_gbs=1.0)
        led.record("unplanned", 0.1)
        led.register_plan("unexecuted", dict(_PLAN))
        rows = led.report()
        assert rows["unplanned"]["count"] == 1
        assert not rows["unplanned"]["has_plan"]
        assert "mfu" not in rows["unplanned"]
        assert rows["unexecuted"]["count"] == 0
        assert rows["unexecuted"]["has_plan"]
        assert "total_wall_s" not in rows["unexecuted"]

    def test_share_of_total_wall(self, tel_metrics):
        reg = tel_metrics
        led = PerfLedger(reg, peak_flops=0.0, peak_hbm_gbs=0.0)
        led.record("a", 0.3)
        led.record("b", 0.1)
        # no serving steps ran: shares are against the exec total
        rows = led.report()
        assert rows["a"]["share_of_step_wall"] == pytest.approx(0.75)
        assert rows["b"]["share_of_step_wall"] == pytest.approx(0.25)
        # with a step-wall histogram the denominator switches to it
        reg.observe("serving.step_wall_s", 0.8)
        rows = led.report()
        assert rows["a"]["share_of_step_wall"] == pytest.approx(
            0.3 / 0.8)

    def test_zero_peaks_drop_mfu_and_prediction(self, tel_metrics):
        led = PerfLedger(tel_metrics, peak_flops=0.0,
                         peak_hbm_gbs=0.0)
        led.register_plan("p", dict(_PLAN))
        led.record("p", 0.5)
        row = led.report()["p"]
        assert "mfu" not in row
        assert "predicted_wall_s" not in row
        assert "drift_ratio" not in row
        # rates that need no peak still report
        assert row["attained_flops_per_s"] == pytest.approx(4e9)

    def test_top_bounds_report(self, tel_metrics):
        led = PerfLedger(tel_metrics, peak_flops=0.0,
                         peak_hbm_gbs=0.0)
        for i in range(8):
            led.record("p%d" % i, 0.01 * (i + 1))
        rows = led.report(top=3)
        assert len(rows) == 3
        assert set(rows) == {"p5", "p6", "p7"}  # largest total walls


class TestPublishAndSnapshot:
    def test_publish_gauges_and_snapshot_round_trip(self,
                                                    tel_metrics):
        reg = tel_metrics
        led = PerfLedger(reg, peak_flops=1e10, peak_hbm_gbs=1.0,
                         drift_ratio=4.0)
        led.register_plan("p", dict(_PLAN))
        for _ in range(4):
            led.record("p", 0.5)
        led.publish()
        snap = reg.snapshot()
        assert snap["ledger"]["mfu.p"] == pytest.approx(0.4)
        assert snap["ledger"]["drift_ratio.p"] == pytest.approx(0.4)
        assert snap["ledger"]["programs"] == 1.0
        rows = perf_ledger.rows_from_snapshot(snap)
        assert rows["p"]["count"] == 4
        assert rows["p"]["mfu"] == pytest.approx(0.4)
        assert rows["p"]["drifting"] is False  # 0.4 < flag threshold
        table = perf_ledger.format_rows(rows)
        assert "p" in table and "total_ms" in table

    def test_prometheus_carries_ledger_series(self, tel_metrics):
        led = PerfLedger(tel_metrics, peak_flops=1e10,
                         peak_hbm_gbs=1.0)
        led.register_plan("p", dict(_PLAN))
        led.record("p", 0.5)
        led.publish()
        text = telemetry.prometheus_text(registry=tel_metrics)
        assert "paddle_ledger_mfu_p" in text
        assert "paddle_exec_wall_s_p" in text


# -- the seeded plan-drift watchdog class ------------------------------------


class TestPlanDrift:
    def _drifting_world(self, reg, flops=1e12, walls=6, wall_s=0.1):
        """A ledger whose plan predicts a 1s-at-peak program measured
        at 100ms sustained: drift ratio 10x."""
        led = PerfLedger(reg, peak_flops=1e12, peak_hbm_gbs=0.0,
                         drift_ratio=2.0, window=64,
                         drift_min_samples=4)
        plan = dict(_PLAN, flops_total=flops)
        led.register_plan("p", plan)
        for _ in range(walls):
            led.record("p", wall_s)
        return led

    def test_seeded_trigger_and_hysteresis(self, tel_metrics):
        reg = tel_metrics
        led = PerfLedger(reg, peak_flops=1e12, peak_hbm_gbs=0.0,
                         drift_ratio=2.0, window=8,
                         drift_min_samples=4)
        led.register_plan("p", dict(_PLAN, flops_total=1e12))
        reg.set_epoch(10)
        for _ in range(6):
            led.record("p", 0.1)  # predicted 1.0s, measured 100ms
        led.publish()
        wd = Watchdog(reg, mode="warn", window=8, warmup=0,
                      drift_ratio=2.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fired = wd.check(10)
            assert [e["class"] for e in fired] == ["plan-drift"]
            ev = fired[0]
            assert ev["detail"]["program"] == "p"
            assert ev["detail"]["drift_ratio"] == pytest.approx(10.0)
            # hysteresis latch: the excursion persists, no re-fire
            assert wd.check(11) == []
            assert wd.counts["plan-drift"] == 1
            # recovery: honest walls fill a FRESH window (measured
            # slower than the roofline bound again) and re-arm
            reg.set_epoch(30)
            for _ in range(6):
                led.record("p", 2.0)
            rows = led.publish()
            assert rows["p"]["drift_ratio"] == pytest.approx(0.5)
            assert wd.check(30) == []
            assert wd._latched["plan-drift"] is False
            # second excursion (impossibly fast again) fires again
            reg.set_epoch(50)
            for _ in range(6):
                led.record("p", 0.1)
            led.publish()
            fired = wd.check(50)
            assert [e["class"] for e in fired] == ["plan-drift"]
            assert wd.counts["plan-drift"] == 2

    def test_min_samples_guard(self, tel_metrics):
        reg = tel_metrics
        led = self._drifting_world(reg, walls=2)  # < min samples
        rows = led.publish()
        assert "drift_ratio" not in rows["p"]
        wd = Watchdog(reg, mode="warn", window=64, warmup=0,
                      drift_ratio=2.0)
        assert wd.check(10) == []

    def test_warmup_silences(self, tel_metrics):
        reg = tel_metrics
        self._drifting_world(reg).publish()
        wd = Watchdog(reg, mode="warn", window=64, warmup=8,
                      drift_ratio=2.0)
        assert wd.check(100) == []  # first check anchors warmup
        assert wd.check(104) == []  # still inside
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fired = wd.check(120)
        assert [e["class"] for e in fired] == ["plan-drift"]

    def test_sane_plan_stays_silent(self, tel_metrics):
        reg = tel_metrics
        led = PerfLedger(reg, peak_flops=1e12, peak_hbm_gbs=0.0,
                         drift_ratio=2.0, window=64,
                         drift_min_samples=4)
        led.register_plan("p", dict(_PLAN))  # 2e9 flops -> 2ms pred
        for _ in range(6):
            led.record("p", 0.1)  # measured 100ms >> predicted
        led.publish()
        wd = Watchdog(reg, mode="warn", window=64, warmup=0,
                      drift_ratio=2.0)
        assert wd.check(50) == []

    def test_variant_floor_prevents_spurious_drift(self,
                                                   tel_metrics):
        # review fix: one program traced at two shapes registers two
        # plans under one name while BOTH variants' walls merge into
        # one exec histogram — drift must judge against the SMALLEST
        # variant's predicted wall (a valid lower bound for any
        # invocation), not whichever plan registered last
        reg = tel_metrics
        led = PerfLedger(reg, peak_flops=1e12, peak_hbm_gbs=0.0,
                         drift_ratio=2.0, window=64,
                         drift_min_samples=4)
        led.register_plan("p", dict(_PLAN, flops_total=1e9))   # 1ms
        led.register_plan("p", dict(_PLAN, flops_total=1e12))  # 1s
        for _ in range(6):
            led.record("p", 0.1)  # the small variant's honest walls
        row = led.report()["p"]
        # floor = 1ms predicted vs 100ms measured -> ratio 0.01, ok
        assert row["drift_ratio"] == pytest.approx(0.01)
        assert row["drifting"] is False
        # the REPORTED plan stays the latest registration
        assert row["plan"]["flops_total"] == 1e12

    def test_stale_gauges_release_the_latch(self, tel_metrics):
        # review fix: a drifted program that STOPS running must not
        # pin the latch forever via its frozen drift_ratio gauge —
        # publish() writes drift_samples=0 once its window empties,
        # the detector's min-samples guard skips it, the latch
        # re-arms, and a NEW drifting program fires
        reg = tel_metrics
        led = PerfLedger(reg, peak_flops=1e12, peak_hbm_gbs=0.0,
                         drift_ratio=2.0, window=16,
                         drift_min_samples=4)
        led.register_plan("a", dict(_PLAN, flops_total=1e12))
        reg.set_epoch(10)
        for _ in range(6):
            led.record("a", 0.1)
        led.publish()
        wd = Watchdog(reg, mode="warn", window=16, warmup=0,
                      drift_ratio=2.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert [e["detail"]["program"]
                    for e in wd.check(10)] == ["a"]
            # 'a' stops running: epochs advance past its window
            reg.set_epoch(100)
            rows = led.publish()
            assert rows["a"]["drift_samples"] == 0
            assert "drift_ratio" not in rows["a"]
            assert wd.check(100) == []          # latch released
            assert wd._latched["plan-drift"] is False
            # a NEW drifting program must now fire
            led.register_plan("b", dict(_PLAN, flops_total=1e12))
            for _ in range(6):
                led.record("b", 0.1)
            led.publish()
            fired = wd.check(101)
            assert [e["detail"]["program"] for e in fired] == ["b"]

    def test_snapshot_verdict_wins_over_local_flag(self,
                                                   tel_metrics):
        # review fix: a bundle written under drift_ratio=1.5 (ratio
        # 2.0 -> DRIFT) must replay as DRIFT even on a host whose
        # flag default (4.0) would call it healthy
        reg = tel_metrics
        led = PerfLedger(reg, peak_flops=1e12, peak_hbm_gbs=0.0,
                         drift_ratio=1.5, window=64,
                         drift_min_samples=4)
        led.register_plan("p", dict(_PLAN, flops_total=2e11))
        for _ in range(6):
            led.record("p", 0.1)  # predicted 0.2s / 0.1s = 2.0
        led.publish()
        snap = reg.snapshot()
        assert float(flag("telemetry_drift_ratio")) > 2.0
        rows = perf_ledger.rows_from_snapshot(snap)
        assert rows["p"]["drift_ratio"] == pytest.approx(2.0)
        assert rows["p"]["drifting"] is True  # the recorded verdict

    def test_class_inventoried(self, tel_off):
        assert "plan-drift" in [c for c, _ in WATCHDOG_CLASSES]


# -- the scheduler join (fake clock exactness end to end) --------------------


class TestSchedulerLedger:
    def test_exec_stamps_and_ledger_block(self, tel_metrics,
                                          monkeypatch):
        now = [100.0]
        monkeypatch.setattr(telemetry, "_clock", lambda: now[0])
        set_flags({"telemetry_peak_flops": 1e10,
                   "telemetry_peak_hbm_gbs": 1.0})
        try:
            model = _FakeChunkModel(clock_box=now, call_wall=0.5)
            perf_ledger.register_plan("prefill_chunk", dict(_PLAN))
            sched = BatchScheduler(model, max_batch_size=4,
                                   chunked_prefill=True)
            for i in range(2):
                sched.submit(Request("r%d" % i, [1, 2, 3],
                                     max_new_tokens=2))
            steps = 0
            while sched.num_active or sched.num_queued:
                sched.step()
                now[0] += 0.01
                steps += 1
            reg = tel_metrics
            h = reg.histogram("exec.wall_s.prefill_chunk")
            assert h is not None and h.count == steps
            # every model call advanced the fake clock by EXACTLY
            # 0.5s -> the ledger's MFU is exact: (2e9/0.5)/1e10
            assert h.min == pytest.approx(0.5)
            assert h.max == pytest.approx(0.5)
            led = sched.metrics()["ledger"]
            row = led["prefill_chunk"]
            assert row["count"] == steps
            assert row["mfu"] == pytest.approx(0.4)
            assert row["attained_flops_per_s"] == pytest.approx(4e9)
            assert math.isfinite(row["hbm_bytes_per_s"])
        finally:
            set_flags({"telemetry_peak_flops": 1.97e14,
                       "telemetry_peak_hbm_gbs": 819.0})

    def test_compile_count_gauges_are_per_scheduler(self,
                                                    tel_metrics):
        # two schedulers used to overwrite the
        # shared serving.compile_count gauge (last-writer-wins); the
        # namespaced gauges keep both series truthful, the old key
        # stays as an alias
        m1 = _FakeChunkModel()
        m2 = _FakeChunkModel()
        s1 = BatchScheduler(m1, max_batch_size=2,
                            chunked_prefill=True)
        s2 = BatchScheduler(m2, max_batch_size=2,
                            chunked_prefill=True)
        s1.submit(Request("a", [1, 2], max_new_tokens=1))
        s2.submit(Request("b", [1, 2], max_new_tokens=1))
        m1.compile_count = 3
        m2.compile_count = 7
        s1.step()
        s2.step()
        reg = tel_metrics
        uid1, uid2 = s1._sched_uid, s2._sched_uid
        assert uid1 != uid2
        assert reg.gauge_value(
            "serving.compile_count." + uid1) == 3.0
        assert reg.gauge_value(
            "serving.compile_count." + uid2) == 7.0
        # the alias survives (last writer)
        assert reg.gauge_value("serving.compile_count") == 7.0


# -- off-mode zero allocation ------------------------------------------------


class TestOffModeZeroAlloc:
    def test_serving_loop_allocates_nothing_in_ledger_or_recorder(
            self, tel_off):
        sched = BatchScheduler(_FakeChunkModel(), max_batch_size=4,
                               chunked_prefill=True)
        for i in range(4):
            sched.submit(Request("r%d" % i, [1, 2, 3, 4],
                                 max_new_tokens=3))
        tracemalloc.start()
        snap0 = tracemalloc.take_snapshot()
        while sched.num_active or sched.num_queued:
            sched.step()
        snap1 = tracemalloc.take_snapshot()
        tracemalloc.stop()
        for mod in (perf_ledger, _fr_mod):
            filt = [tracemalloc.Filter(True, mod.__file__)]
            diff = snap1.filter_traces(filt).compare_to(
                snap0.filter_traces(filt), "filename")
            blocks = sum(max(d.count_diff, 0) for d in diff)
            assert blocks == 0, (mod.__name__, diff)
        assert sched.metrics() == {"telemetry": "off"}
        assert sched.dump_incident() is None


# -- incident bundles --------------------------------------------------------


def _storm_registry(reg):
    """Seed a recompile-storm signature into the registry."""
    for _ in range(8):
        reg.inc("compile.count")


class TestFlightRecorder:
    def _recorder_world(self, reg, tmp_path, with_watchdog=True):
        led = PerfLedger(reg, peak_flops=1e10, peak_hbm_gbs=1.0)
        led.register_plan("p", dict(_PLAN))
        led.record("p", 0.5)
        led.publish()
        wd = None
        if with_watchdog:
            wd = Watchdog(reg, mode="warn", window=8, warmup=0,
                          storm_compiles=3)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                wd.check(1)
                _storm_registry(reg)
                assert wd.check(2), "storm must have fired"
        rec = telemetry.FlightRecorder(
            registry=reg, watchdog=wd, ledger=led,
            out_dir=str(tmp_path))
        return rec, wd, led

    def test_bundle_round_trip(self, tel_metrics, tmp_path, capsys):
        rec, wd, _ = self._recorder_world(tel_metrics, tmp_path)
        path = rec.record(list(wd.events))
        assert os.path.isdir(path)
        manifest = json.loads(
            open(os.path.join(path, "manifest.json")).read())
        assert manifest["classes"] == ["recompile-storm"]
        # every manifest entry exists on disk
        for key, fname in manifest["entries"].items():
            assert os.path.isfile(os.path.join(path, fname)), key
        for key in ("watchdog_events", "metrics", "prometheus",
                    "ledger", "plans", "flags"):
            assert key in manifest["entries"], key
        # metrics + ledger members parse and are non-empty
        led = json.loads(
            open(os.path.join(path, "ledger.json")).read())
        assert led["p"]["mfu"] == pytest.approx(0.4)
        # the CLI reconstructs the story
        rc = telemetry.main(["--summarize-incident", path])
        assert rc == 0
        out = capsys.readouterr().out
        assert "recompile-storm" in out
        assert "ledger: top programs" in out
        assert "MISSING" not in out

    def test_two_recorders_never_collide(self, tel_metrics,
                                         tmp_path):
        # review fix: two recorders in ONE process (the
        # multi-scheduler setup) tripping the same class must land
        # two distinct bundles — a name collision used to fail the
        # staging rename and silently disable a recorder
        reg = tel_metrics
        r1 = telemetry.FlightRecorder(registry=reg,
                                      out_dir=str(tmp_path))
        r2 = telemetry.FlightRecorder(registry=reg,
                                      out_dir=str(tmp_path))
        ev = [{"class": "decode-stall", "epoch": 1}]
        p1 = r1.record(ev)
        p2 = r2.record(ev)
        assert p1 != p2
        assert os.path.isdir(p1) and os.path.isdir(p2)

    def test_prune_spares_sibling_inflight_staging(self, tel_metrics,
                                                   tmp_path):
        # a same-pid .tmp dir may be a sibling recorder mid-write:
        # prune must only sweep staging dirs from OTHER pids
        reg = tel_metrics
        rec = telemetry.FlightRecorder(registry=reg,
                                       out_dir=str(tmp_path))
        mine = tmp_path / ("incident-%d-9999-x.tmp" % os.getpid())
        theirs = tmp_path / "incident-999999999-0001-x.tmp"
        mine.mkdir()
        theirs.mkdir()
        rec.dump_incident()
        assert mine.is_dir()          # in-flight sibling untouched
        assert not theirs.is_dir()    # crashed foreign staging swept

    def test_dump_incident_without_watchdog(self, tel_metrics,
                                            tmp_path):
        rec, _, _ = self._recorder_world(tel_metrics, tmp_path,
                                         with_watchdog=False)
        path = rec.dump_incident(reason="manual-probe")
        manifest = json.loads(
            open(os.path.join(path, "manifest.json")).read())
        assert manifest["reason"] == "manual-probe"
        assert manifest["classes"] == []

    def test_bundle_count_is_bounded(self, tel_metrics, tmp_path):
        rec, _, _ = self._recorder_world(tel_metrics, tmp_path,
                                         with_watchdog=False)
        rec.keep = 3
        for _ in range(6):
            rec.dump_incident()
        bundles = [n for n in os.listdir(tmp_path)
                   if n.startswith("incident-")]
        assert len(bundles) == 3

    def test_truncated_jsonl_member_tolerated(self, tel_metrics,
                                              tmp_path, capsys):
        rec, wd, _ = self._recorder_world(tel_metrics, tmp_path)
        path = rec.record(list(wd.events))
        wj = os.path.join(path, "watchdog_events.jsonl")
        text = open(wj).read()
        # a killed writer leaves a torn final line (no newline)
        with open(wj, "w") as f:
            f.write(text + text.splitlines()[0][: len(text) // 4])
        rc = telemetry.main(["--summarize-incident", path])
        assert rc == 0
        out = capsys.readouterr().out
        assert "truncated" in out
        assert "recompile-storm" in out  # intact records survive

    def test_terminated_garbage_still_raises(self, tel_metrics,
                                             tmp_path):
        rec, wd, _ = self._recorder_world(tel_metrics, tmp_path)
        path = rec.record(list(wd.events))
        wj = os.path.join(path, "watchdog_events.jsonl")
        with open(wj, "a") as f:
            f.write("NOT JSON\n")  # newline-terminated = corruption
        with pytest.raises(ValueError):
            telemetry.summarize_incident(path)

    def test_truncated_json_member_noted_not_fatal(self, tel_metrics,
                                                   tmp_path, capsys):
        rec, wd, _ = self._recorder_world(tel_metrics, tmp_path)
        path = rec.record(list(wd.events))
        mj = os.path.join(path, "metrics.json")
        text = open(mj).read()
        with open(mj, "w") as f:
            f.write(text[: len(text) // 2])  # torn mid-write
        rc = telemetry.main(["--summarize-incident", path])
        assert rc == 0
        out = capsys.readouterr().out
        assert "unreadable" in out

    def test_not_a_bundle_raises(self, tel_off, tmp_path):
        with pytest.raises(ValueError):
            telemetry.summarize_incident(str(tmp_path))

    def test_scheduler_trip_writes_bundle(self, tel_metrics,
                                          tmp_path):
        # end to end: a deliberately tripped watchdog inside the
        # scheduler's observability epoch lands one bundle
        set_flags({"telemetry_incident_dir": str(tmp_path),
                   "telemetry_watchdog_stride": 1})
        try:
            reg = tel_metrics
            wd = Watchdog(reg, mode="warn", window=8, warmup=0,
                          storm_compiles=3)
            sched = BatchScheduler(_FakeChunkModel(),
                                   max_batch_size=2,
                                   chunked_prefill=True,
                                   watchdog=wd)
            sched.submit(Request("r0", [1, 2, 3],
                                 max_new_tokens=8))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                while sched.num_active or sched.num_queued:
                    _storm_registry(reg)
                    sched.step()
            bundles = [n for n in os.listdir(tmp_path)
                       if n.startswith("incident-")
                       and not n.endswith(".tmp")]
            assert bundles, "watchdog fired but no bundle landed"
            # under ambient load a wall-clock detector (decode-stall)
            # can fire first and land its own bundle; the storm trip
            # must be named by SOME bundle, in no particular
            # listdir order
            classes = set()
            storm_bundle = None
            for b in bundles:
                manifest = json.loads(open(os.path.join(
                    tmp_path, b, "manifest.json")).read())
                classes.update(manifest["classes"])
                if "recompile-storm" in manifest["classes"]:
                    storm_bundle = b
            assert "recompile-storm" in classes, classes
            # the scheduler's exec stamps made the ledger non-empty
            # (read from the STORM bundle — an earlier wall-clock
            # trip's bundle may predate the first exec stamp)
            led = json.loads(open(os.path.join(
                tmp_path, storm_bundle, "ledger.json")).read())
            assert "prefill_chunk" in led
        finally:
            set_flags({"telemetry_incident_dir": "",
                       "telemetry_watchdog_stride": 32})


# -- CLI ---------------------------------------------------------------------


class TestCLI:
    def _dump(self, reg, tmp_path):
        led = PerfLedger(reg, peak_flops=1e10, peak_hbm_gbs=1.0)
        led.register_plan("p", dict(_PLAN))
        for _ in range(4):
            led.record("p", 0.5)
        led.publish()
        tr = telemetry.Tracer()
        path = str(tmp_path / "trace.jsonl")
        tr.dump_jsonl(path, registry=reg)
        return path

    def test_ledger_mode(self, tel_metrics, tmp_path, capsys):
        path = self._dump(tel_metrics, tmp_path)
        assert telemetry.main(["--ledger", path]) == 0
        out = capsys.readouterr().out
        assert "ledger: top programs" in out
        assert "p" in out

    def test_summarize_gains_ledger_table(self, tel_metrics,
                                          tmp_path, capsys):
        path = self._dump(tel_metrics, tmp_path)
        assert telemetry.main(["--summarize", path]) == 0
        out = capsys.readouterr().out
        assert "ledger: top programs" in out
        assert "drift" in out


class TestRowsFromPartialSnapshots:
    """The capacity autotuner hill-climbs on
    rows_from_snapshot over dumped/merged FLEET snapshots, so a
    partial or malformed snapshot — missing plan keys, zero-wall
    programs, None/garbage gauges from a lossy merge — must degrade
    to 'no signal' rows, never crash."""

    def test_missing_plan_keys_degrade_to_no_signal(self):
        # wall histograms only: no ledger namespace was ever
        # published (e.g. a worker dumped before the first
        # publish()), so plan-derived fields are simply absent
        snap = {"exec": {"wall_s.attend": {"count": 3, "sum": 0.3,
                                           "p50": 0.1, "p99": 0.1},
                         "count.attend": 3}}
        rows = perf_ledger.rows_from_snapshot(snap)
        assert rows["attend"]["count"] == 3
        assert "mfu" not in rows["attend"]
        assert "drifting" not in rows["attend"]
        table = perf_ledger.format_rows(rows)
        assert "attend" in table and "-" in table

    def test_zero_wall_programs_do_not_crash(self):
        snap = {"exec": {"wall_s.idle": {"count": 0, "sum": 0,
                                         "p50": None, "p99": None},
                         "count.idle": 0},
                "ledger": {"share_of_step_wall.idle": 0.0}}
        rows = perf_ledger.rows_from_snapshot(snap)
        assert rows["idle"]["count"] == 0
        assert rows["idle"]["total_wall_s"] == 0.0
        assert rows["idle"]["p50_wall_s"] is None
        assert "idle" in perf_ledger.format_rows(rows)

    def test_none_and_garbage_leaves_degrade_not_crash(self):
        snap = {"exec": {"wall_s.p": {"count": None, "sum": None,
                                      "p50": None, "p99": None},
                         "count.p": None,
                         "count.q": "garbage"},
                "ledger": {"drift_ratio.p": None,
                           "drift_ratio.q": "bogus",
                           "mfu.p": None,
                           "programs": 2.0}}
        rows = perf_ledger.rows_from_snapshot(snap)
        assert rows["p"]["count"] == 0
        assert rows["p"]["drifting"] is False
        assert rows["p"]["drift_ratio"] is None
        assert rows["q"]["drifting"] is False
        assert "programs" not in rows
        perf_ledger.format_rows(rows)   # renders, no crash

    def test_empty_and_none_namespaces(self):
        assert perf_ledger.rows_from_snapshot({}) == {}
        assert perf_ledger.rows_from_snapshot(
            {"exec": None, "ledger": None}) == {}

    def test_merged_fleet_snapshot_with_partial_worker(
            self, tel_metrics):
        # worker A published ledger gauges; worker B died before its
        # first publish (exec stamps only, no ledger namespace) —
        # the merged rows must still build, with B-only programs
        # carrying no plan signal
        led = perf_ledger.PerfLedger(tel_metrics, peak_flops=1e10,
                                     peak_hbm_gbs=1.0)
        led.register_plan("p", dict(_PLAN))
        for _ in range(4):
            led.record("p", 0.5)
        led.publish()
        snap_a = tel_metrics.snapshot()
        snap_b = {"exec": {"wall_s.q": {"count": 2, "sum": 0.2,
                                        "min": 0.1, "max": 0.1,
                                        "p50": 0.1, "p99": 0.1,
                                        "buckets": {}},
                           "count.q": 2}}
        merged = telemetry.merge_snapshots(
            {"a": snap_a, "b": snap_b})
        rows = perf_ledger.rows_from_snapshot(merged)
        assert rows["p"]["count"] == 4
        assert rows["q"]["count"] == 2
        assert "mfu" not in rows["q"]
        table = perf_ledger.format_rows(rows)
        assert "p" in table and "q" in table
