"""The port's runtime telemetry (paddle_tpu_torch/framework/
telemetry.py), by the reference's own unit tests: histogram/percentile
math, span nesting + ring rollover + Chrome export validity, off-mode
zero allocation, scheduler TTFT/TPOT correctness against a hand-stepped
fake clock, the module CLI round trip, the request-lifecycle layer
(epoch-windowed views, SLO/goodput exactness under the fake clock,
per-request trace completeness across the chunked-prefill / prefix-hit
/ spec-decode paths), one seeded trigger per watchdog class
(framework/watchdog.py), the Prometheus export surface,
truncated-JSONL tolerance, trace contexts and fleet merges.

The fake models implement the model protocol the port's scheduler
calls (``attach_prefix``, ``seq_page_chains``, ``swap_out``/``swap_in``,
``pending_cow``) and return host arrays. Left out: the legacy profiler
bridge (the port has no ``profiler`` module) and the rule inventory of
``framework.analysis`` (the jaxpr lint)."""
import json
import random
import tracemalloc
import warnings

import numpy as np
import pytest

from paddle_tpu_torch.framework import telemetry
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.framework.watchdog import (
    WATCHDOG_CLASSES,
    Watchdog,
    WatchdogError,
)
from paddle_tpu_torch.inference import BatchScheduler, Request


@pytest.fixture
def tel_off():
    """Guarantee a pristine off-mode telemetry world."""
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
    set_flags({"telemetry": "off"})
    telemetry.reset()


@pytest.fixture
def tel_trace():
    set_flags({"telemetry": "trace"})
    telemetry.reset()
    yield telemetry.tracer()
    set_flags({"telemetry": "off"})
    telemetry.reset()


# -- a host-only fake model implementing the scheduler protocol --------------


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


class _FakeModel:
    """Deterministic token-per-step decoder: always emits token 1."""

    def __init__(self, vocab=16, num_pages=1024):
        self.vocab = vocab
        self.caches = [_FakeCache(num_pages=num_pages)]

    def alloc(self, sid):
        self.caches[0].lens[sid] = 0

    def free(self, sid):
        del self.caches[0].lens[sid]

    def attach_prefix(self, sid, chains, length):
        for c, chain in zip(self.caches, chains):
            c.attach(sid, chain, length)

    def seq_page_chains(self, sid):
        return [c.seq_pages(sid) for c in self.caches]

    def decode_token(self, feed, sids):
        c = self.caches[0]
        for s in sids:
            c.lens[s] += 1
        logits = np.zeros((len(sids), self.vocab), np.float32)
        logits[:, 1] = 1.0
        return logits


class _FakeChunkModel(_FakeModel):
    """Ragged chunked-prefill + spec-decode fake: implements
    prefill_chunk (with the per-position ``logits_rows`` epilogue the
    unified ragged spec step samples verify windows from) and the
    legacy decode_window, on host arrays, always emitting token 1
    (so draft and target agree and every proposal is accepted)."""

    def prefill_chunk(self, feeds, rows, starts, pad_to=None,
                      logits_rows=None):
        c = self.caches[0]
        for s, f in zip(rows, feeds):
            c.lens[s] += len(f)
        logits = np.zeros((len(rows), self.vocab), np.float32)
        logits[:, 1] = 1.0
        if logits_rows is None:
            return logits
        n_full = sum(len(feeds[i]) for i in logits_rows)
        full = np.zeros((n_full, self.vocab), np.float32)
        full[:, 1] = 1.0
        return logits, full

    def decode_window(self, windows, sids):
        c = self.caches[0]
        w = windows.shape[1]
        for s in sids:
            c.lens[s] += w
        logits = np.zeros((len(sids), w, self.vocab), np.float32)
        logits[:, :, 1] = 1.0
        return logits


class _StubPrefixCache:
    """Minimal prefix-cache stand-in (host-only): a fixed-length hit
    for every prompt, optional evict-to-make-room behaviour against
    a planted 'cached' sequence in the pool."""

    def __init__(self, caches, hit_len=4, evictable_seq=None):
        self.caches = caches
        self.hit_len = hit_len
        self.evictable_seq = evictable_seq
        self.mutations = 0
        self.evictions = 0

    def match(self, tokens, limit=None, align=1):
        from paddle_tpu_torch.inference.prefix_cache import PrefixMatch

        n = min(self.hit_len,
                limit if limit is not None else len(tokens))
        n = max(n, 0)
        pages = -(-n // self.caches[0].page_size) if n else 0
        return PrefixMatch(
            length=n, chains=[[0] * pages for _ in self.caches],
            path=("stub",) if n else ())

    def pin(self, path):
        pass

    def unpin(self, path):
        pass

    def insert(self, toks, chains):
        return 0

    def evict(self, deficit):
        if self.evictable_seq is not None \
                and self.evictable_seq in self.caches[0].lens:
            del self.caches[0].lens[self.evictable_seq]
            self.evictions += 1
            self.mutations += 1
            return deficit
        return 0

    def summary(self):
        return {"cached_tokens": 0, "cached_pages": 0, "nodes": 0}


# -- histograms --------------------------------------------------------------


class TestHistogram:
    def test_log_bucket_math(self, tel_off):
        h = telemetry.Histogram(samples=64)
        for v in (0.75, 1.0, 1.5, 2.0, 3.0, 0.0, -1.0):
            h.observe(v)
        assert dict(h.buckets()) == {
            0.0: 2,   # 0.0 and -1.0
            1.0: 2,   # 0.75, 1.0
            2.0: 2,   # 1.5, 2.0
            4.0: 1,   # 3.0
        }
        assert h.count == 7
        assert h.min == -1.0 and h.max == 3.0

    def test_exact_percentiles_nearest_rank(self, tel_off):
        h = telemetry.Histogram(samples=256)
        vals = list(range(1, 101))
        random.Random(7).shuffle(vals)
        for v in vals:
            h.observe(v)
        assert h.percentile(50) == 50
        assert h.percentile(90) == 90
        assert h.percentile(99) == 99
        assert h.percentile(100) == 100
        s = h.summary()
        assert s["exact"] is True
        assert s["p50"] == 50 and s["p99"] == 99
        assert s["count"] == 100 and s["sum"] == sum(range(1, 101))

    def test_reservoir_rollover_stays_windowed_exact(self, tel_off):
        h = telemetry.Histogram(samples=10)
        for v in range(100):
            h.observe(float(v))
        # bucket counts cover everything; the percentile window is
        # the newest 10 samples (90..99) and says so
        assert h.count == 100
        assert h.summary()["exact"] is False
        assert h.percentile(50) == 94.0

    def test_registry_namespacing(self, tel_off):
        r = telemetry.MetricsRegistry()
        r.inc("serving.steps", 3)
        r.gauge("pool.free_pages", 7)
        r.observe("serving.ttft_s", 0.5)
        snap = r.snapshot()
        assert snap["serving"]["steps"] == 3
        assert snap["pool"]["free_pages"] == 7.0
        assert snap["serving"]["ttft_s"]["count"] == 1
        assert snap["serving"]["ttft_s"]["p50"] == 0.5


# -- tracer ------------------------------------------------------------------


class TestTracer:
    def test_span_nesting_and_attributes(self, tel_off):
        tr = telemetry.Tracer(ring=64)
        with tr.span("outer", kind="step"):
            with tr.span("inner", rows=3):
                pass
            with tr.span("inner2"):
                pass
        spans = {s.name: s for s in tr.spans()}
        assert spans["outer"].depth == 0
        assert spans["inner"].depth == 1
        assert spans["inner"].path == "outer/inner"
        assert spans["inner2"].path == "outer/inner2"
        assert spans["outer"].attrs == {"kind": "step"}
        assert spans["inner"].attrs == {"rows": 3}
        # children commit before the parent, with contained walls
        assert spans["inner"].t0 >= spans["outer"].t0
        assert spans["inner"].dur <= spans["outer"].dur

    def test_ring_rollover_chrome_export_stays_valid(self, tel_off):
        tr = telemetry.Tracer(ring=16)
        for i in range(100):
            tr.add_complete(f"e{i}", float(i), 0.5)
        assert tr.dropped == 84
        data = json.loads(json.dumps(tr.to_chrome()))
        ev = data["traceEvents"]
        assert len(ev) == 16
        assert all(e["ph"] == "X" for e in ev)
        # the newest 16 survive, ts normalized to the window base
        assert ev[0]["name"] == "e84" and ev[0]["ts"] == 0.0
        assert ev[-1]["name"] == "e99"
        assert data["displayTimeUnit"] == "ms"

    def test_mode_gating(self, tel_off):
        assert telemetry.registry() is None
        assert telemetry.tracer() is None
        set_flags({"telemetry": "metrics"})
        assert telemetry.registry() is not None
        assert telemetry.tracer() is None
        set_flags({"telemetry": "trace"})
        assert telemetry.tracer() is not None
        set_flags({"telemetry": "bogus-value"})
        assert telemetry.telemetry_mode() == "off"
        assert telemetry.registry() is None


# -- scheduler latency accounting -------------------------------------------


class TestSchedulerLatency:
    def test_ttft_tpot_queue_wait_hand_stepped(self, tel_metrics,
                                               monkeypatch):
        """Drive the scheduler against a manually advanced clock and
        check every latency histogram against hand-computed values."""
        now = [100.0]
        monkeypatch.setattr(telemetry, "_clock", lambda: now[0])
        sched = BatchScheduler(_FakeModel(), max_batch_size=4)
        sched.submit(Request("r0", [5, 6], max_new_tokens=2))

        now[0] = 103.0
        sched.step()   # admit (queue_wait=3) + prompt token 0
        now[0] = 105.0
        sched.step()   # prompt done -> first token   (TTFT=5)
        now[0] = 106.0
        sched.step()   # second token (TPOT=1) -> retire

        m = sched.metrics()
        assert m["telemetry"] == "metrics"
        assert m["serving"]["queue_wait_s"]["p50"] == 3.0
        assert m["serving"]["ttft_s"]["p50"] == 5.0
        assert m["serving"]["ttft_s"]["count"] == 1
        assert m["serving"]["tpot_s"]["p50"] == 1.0
        assert m["serving"]["tpot_s"]["count"] == 1
        assert m["serving"]["steps"] == 3
        assert m["serving"]["requests_admitted"] == 1
        assert m["serving"]["requests_finished"] == 1
        assert m["serving"]["decode_tokens"] == 1  # step-3 decode row
        assert m["serving"]["retire_s"]["count"] == 1
        assert sched.result("r0").generated_ids == [1, 1]

    def test_metrics_namespaces_and_pool_gauges(self, tel_metrics):
        sched = BatchScheduler(_FakeModel(), max_batch_size=2)
        sched.submit(Request("a", [3, 4, 5], max_new_tokens=1))
        sched.run_until_complete()
        m = sched.metrics()
        assert set(m) >= {"serving", "pool", "telemetry"}
        assert m["pool"]["total_pages"] == 1024.0
        assert m["pool"]["free_pages"] == 1024.0  # all retired
        assert m["pool"]["utilization"] == 0.0
        # the legacy shapes stay available as aliases
        stats = sched.page_pool_stats()
        assert stats["total_pages"] == 1024
        assert "utilization" in stats

    def test_off_mode_metrics_shape(self, tel_off):
        sched = BatchScheduler(_FakeModel())
        assert sched.metrics() == {"telemetry": "off"}

    def test_trace_mode_step_spans(self, tel_trace):
        sched = BatchScheduler(_FakeModel(), max_batch_size=2)
        sched.submit(Request("a", [3, 4], max_new_tokens=1))
        sched.run_until_complete()
        names = {s.name for s in tel_trace.spans()}
        assert {"serving.step", "serving.admit", "serving.decode",
                "serving.retire"} <= names
        steps = [s for s in tel_trace.spans()
                 if s.name == "serving.admit"]
        assert all(s.path == "serving.step/serving.admit"
                   for s in steps)


# -- off-mode zero allocation ------------------------------------------------


class TestOffModeZeroAlloc:
    def test_serving_loop_allocates_nothing_in_telemetry(self,
                                                         tel_off):
        sched = BatchScheduler(_FakeModel(), max_batch_size=4)
        reqs = []
        for i in range(3):
            reqs.append(Request(f"r{i}", [2, 3, 4],
                                max_new_tokens=4))
            sched.submit(reqs[-1])
        tracemalloc.start()
        snap0 = tracemalloc.take_snapshot()
        # the TraceContext extension of the off contract (trace contexts):
        # requests submitted while the loop runs must not grow trace
        # identity either — TraceContext lives in telemetry.py, so
        # the filter below catches any construction
        late = Request("late", [2, 3], max_new_tokens=2)
        sched.submit(late)
        sched.run_until_complete()
        snap1 = tracemalloc.take_snapshot()
        tracemalloc.stop()
        filt = [tracemalloc.Filter(True, telemetry.__file__)]
        diff = snap1.filter_traces(filt).compare_to(
            snap0.filter_traces(filt), "filename")
        new_blocks = sum(max(d.count_diff, 0) for d in diff)
        assert new_blocks == 0, (
            f"FLAGS_telemetry=off allocated {new_blocks} blocks in "
            "telemetry.py — the off-is-free contract is broken")
        # off mode never builds trace identity
        assert all(r.trace_ctx is None for r in reqs + [late])


# -- CLI ---------------------------------------------------------------------


class TestCLI:
    def _dump(self, tmp_path):
        tr = telemetry.Tracer(ring=64)
        reg = telemetry.MetricsRegistry()
        with tr.span("serving.step"):
            with tr.span("serving.admit", admitted=1):
                pass
        reg.inc("serving.steps", 4)
        reg.observe("serving.ttft_s", 0.25)
        path = str(tmp_path / "trace.jsonl")
        tr.dump_jsonl(path, reg)
        return path

    def test_summarize_round_trip(self, tmp_path, capsys, tel_off):
        path = self._dump(tmp_path)
        assert telemetry.main(["--summarize", path]) == 0
        out = capsys.readouterr().out
        assert "serving.step" in out
        assert "serving.admit" in out
        assert "ttft_s" in out
        assert "counters / gauges" in out
        assert "serving.steps" in out

    def test_export_chrome_round_trip(self, tmp_path, tel_off):
        path = self._dump(tmp_path)
        out = str(tmp_path / "trace.chrome.json")
        assert telemetry.main(
            ["--export-chrome", path, "-o", out]) == 0
        data = json.load(open(out))
        names = [e["name"] for e in data["traceEvents"]]
        assert "serving.step" in names and "serving.admit" in names
        admit = [e for e in data["traceEvents"]
                 if e["name"] == "serving.admit"][0]
        assert admit["args"] == {"admitted": 1}

    def test_summarize_rejects_garbage(self, tmp_path, tel_off):
        bad = tmp_path / "bad.jsonl"
        bad.write_text("not json at all\n")
        with pytest.raises(ValueError):
            telemetry.summarize_jsonl(str(bad))


# -- profiler bridge ---------------------------------------------------------


class TestWindowedViews:
    def test_histogram_windowed_by_epoch(self, tel_off):
        h = telemetry.Histogram(samples=256)
        for e in range(1, 11):
            h.observe(float(e), epoch=e)
        # full-history vs window [6, 10]
        assert h.percentile(50) == 5.0
        assert h.percentile(50, min_epoch=6) == 8.0
        w = h.windowed(6)
        assert w["count"] == 5
        assert w["min"] == 6.0 and w["max"] == 10.0
        assert w["p99"] == 10.0 and w["from_epoch"] == 6
        assert h.windowed(99)["count"] == 0
        assert h.windowed(99)["p50"] is None

    def test_registry_stamps_current_epoch(self, tel_off):
        r = telemetry.MetricsRegistry()
        r.observe("serving.x", 1.0)
        r.set_epoch(7)
        r.observe("serving.x", 2.0)
        assert r.hist_samples("serving.x") == [(0, 1.0), (7, 2.0)]
        assert r.hist_samples("serving.x", min_epoch=7) == [(7, 2.0)]
        assert r.hist_samples("nope") == []


# -- SLO config + goodput -----------------------------------------------------


class TestSLOConfig:
    def test_from_flag_parse_and_disabled(self, tel_off):
        cfg = telemetry.SLOConfig.from_flag(
            "ttft_p99_s=0.5, tpot_p99_s=0.05")
        assert cfg.ttft_p99_s == 0.5
        assert cfg.tpot_p99_s == 0.05
        assert cfg.queue_wait_p99_s is None
        assert cfg.enabled()
        assert not telemetry.SLOConfig.from_flag("").enabled()
        with pytest.raises(ValueError):
            telemetry.SLOConfig.from_flag("bogus_field=1")

    def test_request_meets_partial_config(self, tel_off):
        cfg = telemetry.SLOConfig(ttft_p99_s=1.0)
        assert cfg.request_meets(0.5, None, None) == {"ttft": True}
        assert cfg.request_meets(2.0, 99., 99.) == {"ttft": False}
        # a missing measurement counts as met
        assert cfg.request_meets(None, None, None) == {"ttft": True}
        assert telemetry.SLOConfig.p99([3.0, 1.0, 2.0]) == 3.0
        assert telemetry.SLOConfig.p99([]) is None


class TestGoodput:
    def test_goodput_exact_three_of_four(self, tel_metrics,
                                         monkeypatch):
        """Hand-stepped fake clock: four staggered submits, TTFTs of
        11/9/7/5s against a 10s SLO -> exactly 3 of 4 requests meet
        it -> goodput 0.75, and the per-SLO attainment gauges agree
        with hand-computed fractions."""
        now = [100.0]
        monkeypatch.setattr(telemetry, "_clock", lambda: now[0])
        slo = telemetry.SLOConfig(ttft_p99_s=10.0,
                                  queue_wait_p99_s=7.0)
        sched = BatchScheduler(_FakeModel(), max_batch_size=8,
                               slo=slo)
        for i, t in enumerate((100.0, 102.0, 104.0, 106.0)):
            now[0] = t
            sched.submit(Request(f"r{i}", [5, 6], max_new_tokens=1))
        now[0] = 110.0
        sched.step()   # admit all (queue waits 10/8/6/4), prompt 0
        now[0] = 111.0
        sched.step()   # prompt done -> first+only token, retire all
        m = sched.metrics()
        # TTFTs: 11, 9, 7, 5 vs 10.0 -> 3/4 meet
        assert m["serving"]["slo_attain_ttft"] == 0.75
        # queue waits: 10, 8, 6, 4 vs 7.0 -> 2/4 meet
        assert m["serving"]["slo_attain_queue_wait"] == 0.5
        # goodput = all-SLOs-met = requests {r2, r3} -> 0.5
        assert m["serving"]["goodput"] == 0.5
        assert m["serving"]["slo_window_requests"] == 4
        assert m["slo"] == {"ttft_p99_s": 10.0, "tpot_p99_s": None,
                            "queue_wait_p99_s": 7.0}

    def test_goodput_window_slides_by_epoch(self, tel_metrics,
                                            monkeypatch):
        """Requests retired more than FLAGS_telemetry_window step
        epochs ago fall out of the goodput window."""
        now = [0.0]
        monkeypatch.setattr(telemetry, "_clock", lambda: now[0])
        set_flags({"telemetry_window": 4})
        try:
            slo = telemetry.SLOConfig(ttft_p99_s=5.0)
            sched = BatchScheduler(_FakeModel(), max_batch_size=2,
                                   slo=slo)
            # r0 misses the SLO (slow first token)
            sched.submit(Request("r0", [5], max_new_tokens=1))
            now[0] = 10.0
            sched.step()
            m = sched.metrics()
            assert m["serving"]["goodput"] == 0.0
            # 6 empty epochs later, r0 is out of the window; a fresh
            # fast request is the only occupant -> goodput 1.0
            for _ in range(6):
                sched.step()
            sched.submit(Request("r1", [5], max_new_tokens=1))
            now[0] = 10.5
            sched.step()
            m = sched.metrics()
            assert m["serving"]["goodput"] == 1.0
            assert m["serving"]["slo_window_requests"] == 1
        finally:
            set_flags({"telemetry_window": 128})

    def test_empty_window_clears_stale_miss(self, tel_metrics,
                                            monkeypatch):
        """A miss must not outlive its window: once the goodput
        window empties, the gauges republish 1.0 with population 0
        instead of freezing at the stale value."""
        now = [0.0]
        monkeypatch.setattr(telemetry, "_clock", lambda: now[0])
        set_flags({"telemetry_window": 4})
        try:
            slo = telemetry.SLOConfig(ttft_p99_s=5.0)
            sched = BatchScheduler(_FakeModel(), max_batch_size=2,
                                   slo=slo)
            sched.submit(Request("r0", [5], max_new_tokens=1))
            now[0] = 10.0
            sched.step()  # TTFT 10 > 5 -> miss
            assert sched.metrics()["serving"]["goodput"] == 0.0
            for _ in range(6):  # idle past the window
                sched.step()
            m = sched.metrics()
            assert m["serving"]["goodput"] == 1.0
            assert m["serving"]["slo_attain_ttft"] == 1.0
            assert m["serving"]["slo_window_requests"] == 0
        finally:
            set_flags({"telemetry_window": 128})

    def test_windowed_latency_views_in_metrics(self, tel_metrics,
                                               monkeypatch):
        now = [0.0]
        monkeypatch.setattr(telemetry, "_clock", lambda: now[0])
        sched = BatchScheduler(_FakeModel(), max_batch_size=2)
        sched.submit(Request("r0", [5], max_new_tokens=2))
        for t in (1.0, 2.0, 3.0):
            now[0] = t
            sched.step()
        m = sched.metrics()
        w = m["serving"]["ttft_s"]["window"]
        assert w["count"] == 1 and w["p50"] == 1.0
        assert "window" in m["serving"]["step_wall_s"]


# -- self-describing metrics + admission counters ----------------------------


class TestSelfDescribingMetrics:
    def test_uptime_steps_population_gauges(self, tel_metrics,
                                            monkeypatch):
        now = [50.0]
        monkeypatch.setattr(telemetry, "_clock", lambda: now[0])
        sched = BatchScheduler(_FakeModel(), max_batch_size=1)
        sched.submit(Request("a", [3, 4], max_new_tokens=8))
        sched.submit(Request("b", [3], max_new_tokens=1))
        now[0] = 52.0
        sched.step()  # a admitted (batch=1), b queued
        m = sched.metrics()
        assert m["serving"]["uptime_s"] == 2.0
        assert m["serving"]["steps_per_s"] == 0.5
        assert m["serving"]["step_epoch"] == 1.0
        assert m["serving"]["active_requests"] == 1.0
        assert m["serving"]["queued_requests"] == 1.0
        assert m["serving"]["retired_requests"] == 0.0
        # the legacy shapes stay as aliases
        assert m["serving"]["steps"] == 1
        assert "total_pages" in sched.page_pool_stats()

    def test_admit_reject_pool_counted(self, tel_metrics):
        # 4-page pool: r0 reserves 2 pages; r1's worst case cannot
        # fit under the watermark until r0 retires
        sched = BatchScheduler(_FakeModel(num_pages=4),
                               max_batch_size=4)
        sched.submit(Request("r0", [1, 2, 3], max_new_tokens=5))
        sched.submit(Request("r1", [1, 2, 3], max_new_tokens=5))
        sched.run_until_complete()
        m = sched.metrics()
        assert m["serving"]["admit_reject_pool"] > 0
        assert m["serving"]["requests_finished"] == 2
        assert "admit_evict_then_admit" not in m["serving"]

    def test_admit_evict_then_admit_counted(self, tel_metrics):
        model = _FakeModel(num_pages=4)
        # plant a 'cached' sequence holding 2 pages that only the
        # stub evictor can reclaim
        model.caches[0].lens["cached"] = 8
        stub = _StubPrefixCache(model.caches, hit_len=0,
                                evictable_seq="cached")
        sched = BatchScheduler(model, max_batch_size=2,
                               prefix_cache=stub)
        sched.submit(Request("r0", [1, 2, 3], max_new_tokens=5))
        sched.step()
        m = sched.metrics()
        assert stub.evictions == 1
        assert m["serving"]["admit_evict_then_admit"] == 1
        assert "admit_reject_pool" not in m["serving"]

    def test_pool_peak_utilization_gauge(self, tel_metrics):
        from paddle_tpu_torch.incubate.nn import PagedKVCacheManager

        pool = PagedKVCacheManager(8, 4, 1, 4, device="cpu")
        pool.alloc("s")
        for _ in range(9):
            pool.append("s", np.zeros((1, 4), np.float32),
                        np.zeros((1, 4), np.float32))
        assert pool.peak_used_pages == 3
        pool.free("s")
        assert pool.peak_used_pages == 3  # a high watermark


# -- per-request traces -------------------------------------------------------


class TestRequestTraces:
    def test_token_per_step_trace_complete(self, tel_trace):
        sched = BatchScheduler(_FakeModel(), max_batch_size=2)
        sched.submit(Request("a", [3, 4, 5], max_new_tokens=2))
        sched.run_until_complete()
        book = telemetry.request_traces()
        tr = book.get("a")
        assert tr.done
        kinds = tr.kinds()
        assert kinds[0] == "submit" and kinds[1] == "admit"
        assert kinds[-1] == "retire"
        assert kinds.count("prefill_chunk") == 3  # 1-token chunks
        assert kinds.count("token") == 2
        assert tr.first("retire")["generated_tokens"] == 2
        assert tr.first("submit")["prompt_tokens"] == 3

    def test_chunked_prefill_trace_has_chunk_counts(self, tel_trace):
        sched = BatchScheduler(_FakeChunkModel(), max_batch_size=2,
                               chunked_prefill=True,
                               prefill_chunk_tokens=4)
        sched.submit(Request("a", list(range(1, 11)),
                             max_new_tokens=2))
        sched.run_until_complete()
        tr = telemetry.request_traces().get("a")
        chunks = [e for e in tr.events
                  if e["kind"] == "prefill_chunk"]
        # 10 prompt tokens at budget 4 -> chunks of 4, 4, 2
        assert [c["tokens"] for c in chunks] == [4, 4, 2]
        assert chunks[-1]["pos"] == 10
        assert tr.kinds()[-1] == "retire"

    def test_prefix_hit_trace_records_hit_tokens(self, tel_trace):
        model = _FakeModel()
        stub = _StubPrefixCache(model.caches, hit_len=4)
        sched = BatchScheduler(model, max_batch_size=2,
                               prefix_cache=stub)
        sched.submit(Request("a", [1, 2, 3, 4, 5, 6],
                             max_new_tokens=1))
        sched.run_until_complete()
        tr = telemetry.request_traces().get("a")
        assert tr.first("admit")["prefix_hit_tokens"] == 4
        assert tr.first("retire")["prefix_hit_tokens"] == 4
        # only the 2 uncached prompt tokens were prefilled
        chunks = [e for e in tr.events
                  if e["kind"] == "prefill_chunk"]
        assert sum(c["tokens"] for c in chunks) == 2

    def test_spec_decode_trace_complete(self, tel_trace):
        target = _FakeChunkModel()
        draft = _FakeChunkModel()
        sched = BatchScheduler(target, max_batch_size=2,
                               draft_model=draft, draft_k=2,
                               prefill_chunk_tokens=8)
        sched.submit(Request("a", [3, 4, 5], max_new_tokens=3))
        sched.run_until_complete()
        tr = telemetry.request_traces().get("a")
        assert tr.done and tr.kinds()[-1] == "retire"
        # one spec round commits draft_k+1 = 3 tokens
        assert tr.kinds().count("token") == 3
        assert tr.first("retire")["generated_tokens"] == 3

    def test_completed_lru_is_bounded(self, tel_off):
        set_flags({"telemetry": "trace",
                   "telemetry_request_traces": 3})
        telemetry.reset()
        try:
            book = telemetry.request_traces()
            for i in range(6):
                book.begin(f"r{i}", float(i), i)
                book.complete(f"r{i}", "retire", float(i) + 1, i)
            assert book.completed_count == 3
            assert book.dropped == 3
            assert book.get("r0") is None
            assert book.get("r5") is not None
            assert book.summary()["capacity"] == 3
        finally:
            set_flags({"telemetry": "off",
                       "telemetry_request_traces": 256})
            telemetry.reset()

    def test_chrome_lanes_round_trip(self, tel_trace):
        sched = BatchScheduler(_FakeModel(), max_batch_size=4)
        for i in range(3):
            sched.submit(Request(f"r{i}", [3, 4], max_new_tokens=2))
        sched.run_until_complete()
        payload = json.loads(json.dumps(telemetry.chrome_payload()))
        events = payload["traceEvents"]
        lanes = {e["args"]["name"]: e["tid"] for e in events
                 if e.get("ph") == "M"
                 and e["name"] == "thread_name"}
        assert set(lanes) == {"req r0", "req r1", "req r2"}
        # each lane carries the queued/prefill/decode phase spans and
        # instant chunk/token events
        for tid in lanes.values():
            mine = [e for e in events if e.get("tid") == tid]
            spans = {e["name"] for e in mine if e.get("ph") == "X"}
            assert {"queued", "prefill", "decode"} <= spans
            assert any(e.get("ph") == "i" and e["name"] == "token"
                       for e in mine)
        # span stream still present alongside the lanes
        assert any(e["name"] == "serving.step" for e in events)

    def test_jsonl_dump_and_summarize_with_requests(self, tmp_path,
                                                    tel_trace,
                                                    capsys):
        sched = BatchScheduler(_FakeModel(), max_batch_size=2)
        sched.submit(Request("reqX", [3, 4], max_new_tokens=1))
        sched.run_until_complete()
        path = str(tmp_path / "t.jsonl")
        tel_trace.dump_jsonl(path, telemetry.registry(),
                             traces=telemetry.request_traces())
        loaded = telemetry._load_jsonl(path)
        assert len(loaded["requests"]) == 1
        assert loaded["requests"][0]["req_id"] == "reqX"
        assert telemetry.main(["--summarize", path]) == 0
        out = capsys.readouterr().out
        assert "request traces (1)" in out
        assert "reqX" in out and "retire" in out
        # chrome conversion renders the request lane too
        outp = str(tmp_path / "t.chrome.json")
        telemetry.chrome_from_jsonl(path, outp)
        data = json.load(open(outp))
        assert any(e.get("ph") == "M"
                   and e["args"]["name"] == "req reqX"
                   for e in data["traceEvents"])


# -- watchdogs ---------------------------------------------------------------


def _mk_registry():
    return telemetry.MetricsRegistry()


class TestWatchdogs:
    def test_recompile_storm_seeded(self, tel_off):
        reg = _mk_registry()
        wd = Watchdog(reg, mode="warn", window=8, warmup=2,
                      storm_compiles=3)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for e in range(1, 8):
                reg.inc("compile.count")
                wd.check(e)
        assert wd.counts.get("recompile-storm", 0) >= 1
        assert any("recompile-storm" in str(x.message) for x in w)
        ev = next(e for e in wd.events
                  if e["class"] == "recompile-storm")
        assert ev["detail"]["compiles_in_window"] >= 3
        assert "count" in ev["snapshot"]  # compile-ns evidence

    def test_storm_respects_warmup(self, tel_off):
        reg = _mk_registry()
        wd = Watchdog(reg, mode="strict", window=8, warmup=100,
                      storm_compiles=2)
        for e in range(1, 20):
            reg.inc("compile.count")
            wd.check(e)  # would raise without the warmup grace
        assert len(wd.events) == 0

    def test_warmup_compiles_never_leak_into_live_window(self,
                                                         tel_off):
        """Compiles that land DURING warmup must not count toward
        the first post-warmup window (the detector re-baselines at
        the warmup boundary)."""
        reg = _mk_registry()
        wd = Watchdog(reg, mode="strict", window=8, warmup=6,
                      storm_compiles=2)
        reg.inc("compile.count", 10)   # the startup burst
        for e in range(1, 4):
            wd.check(e)                # observed inside warmup
        for e in range(6, 15):
            wd.check(e)                # no NEW compiles: must stay
        assert len(wd.events) == 0     # silent
        # a genuine post-warmup storm still fires
        reg.inc("compile.count", 5)
        with pytest.raises(WatchdogError):
            wd.check(15)

    def test_pool_pressure_high_watermark_and_churn(self, tel_off):
        reg = _mk_registry()
        reg.gauge("pool.utilization", 0.99)
        reg.gauge("pool.total_pages", 100)
        wd = Watchdog(reg, mode="warn", window=8, warmup=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            wd.check(1)
        assert wd.counts["pool-pressure"] == 1
        assert wd.events[-1]["detail"]["kind"] == "high-watermark"
        # hysteresis: still high on the next check -> no second event
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            wd.check(2)
        assert wd.counts["pool-pressure"] == 1
        # churn thrash: allocs+frees > churn_factor x pool size
        reg2 = _mk_registry()
        reg2.gauge("pool.utilization", 0.1)
        reg2.gauge("pool.total_pages", 10)
        wd2 = Watchdog(reg2, mode="warn", window=8, warmup=0,
                       churn_factor=2.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            wd2.check(1)
            reg2.inc("pool.page_allocs", 15)
            reg2.inc("pool.page_frees", 15)
            wd2.check(2)
        assert wd2.events[-1]["detail"]["kind"] == "churn"

    def test_prefix_collapse_vs_trailing_baseline(self, tel_off):
        reg = _mk_registry()
        # healthy baseline (epochs 1-16 at 0.8), then collapse
        # (epochs 17-33 at 0.1); the check at 33 windows [17, 33]
        for e in range(1, 17):
            reg.set_epoch(e)
            reg.observe("prefix.hit_frac", 0.8)
        for e in range(17, 34):
            reg.set_epoch(e)
            reg.observe("prefix.hit_frac", 0.1)
        wd = Watchdog(reg, mode="warn", window=16, warmup=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            wd.check(33)
        assert wd.counts["prefix-collapse"] == 1
        d = wd.events[-1]["detail"]
        assert d["baseline_hit_frac"] == 0.8
        assert d["window_hit_frac"] == 0.1

    def test_decode_stall_outlier_vs_window_median(self, tel_off):
        reg = _mk_registry()
        for e in range(1, 10):
            reg.set_epoch(e)
            reg.observe("serving.step_wall_s", 0.01)
        reg.set_epoch(10)
        reg.observe("serving.step_wall_s", 0.5)
        wd = Watchdog(reg, mode="strict", window=16, warmup=0)
        with pytest.raises(WatchdogError) as ei:
            wd.check(10)
        assert ei.value.events[0]["class"] == "decode-stall"
        assert ei.value.events[0]["detail"]["step_wall_s"] == 0.5

    def test_sanitizer_spike_carries_journal_tail(self, tel_off):
        reg = _mk_registry()
        reg.gauge("sanitizer.violations", 0)
        wd = Watchdog(reg, mode="warn", window=8, warmup=0)
        wd.check(1)
        reg.gauge("sanitizer.violations", 2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fired = wd.check(
                2, context={"sanitizer_journal_tail":
                            [{"op": "free", "seq": "s0"}]})
        assert fired[0]["class"] == "sanitizer-spike"
        assert fired[0]["detail"]["new_violations"] == 2
        assert fired[0]["sanitizer_journal_tail"][0]["op"] == "free"

    def test_preemption_thrash_rate_and_hysteresis(self, tel_off):
        """Swap-outs per trailing window above the
        threshold fire once (latched); healthy one-off preemptions
        below it never do; recovery re-arms the latch."""
        reg = _mk_registry()
        reg.inc("serving.preempt_victims", 0)
        reg.gauge("serving.swapped_requests", 0)
        wd = Watchdog(reg, mode="warn", window=8, warmup=0,
                      thrash_preempts=4)
        wd.check(1)  # baseline observation
        reg.inc("serving.preempt_victims", 2)  # healthy burst
        assert wd.check(2) == []
        reg.inc("serving.preempt_victims", 5)  # thrash: 5 > 4/window
        reg.gauge("serving.swapped_requests", 3)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fired = wd.check(3)
        assert [e["class"] for e in fired] == ["preemption-thrash"]
        # the trailing window still holds the healthy +2: 2 + 5
        assert fired[0]["detail"]["preemptions_in_window"] == 7.0
        assert fired[0]["detail"]["swapped_now"] == 3.0
        # latched: still elevated next check -> no second event
        reg.inc("serving.preempt_victims", 5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert wd.counts["preemption-thrash"] == 1
            wd.check(4)
        assert wd.counts["preemption-thrash"] == 1
        # recovery re-arms, a fresh excursion fires again
        assert wd.check(5) == []
        reg.inc("serving.preempt_victims", 6)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fired = wd.check(6)
        assert [e["class"] for e in fired] == ["preemption-thrash"]

    def test_event_log_bounded_and_dumpable(self, tel_off, tmp_path):
        reg = _mk_registry()
        reg.gauge("sanitizer.violations", 0)
        wd = Watchdog(reg, mode="warn", window=2, warmup=0,
                      log_capacity=8)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for e in range(1, 30):
                reg.gauge("sanitizer.violations", float(e))
                wd.check(e)
        assert len(wd.events) == 8
        assert wd.dropped > 0
        path = wd.dump_jsonl(str(tmp_path / "wd.jsonl"))
        recs = [json.loads(ln) for ln in open(path)]
        assert all(r["type"] == "watchdog_event" for r in recs)
        assert telemetry._load_jsonl(path)["watchdog"] == recs

    def test_scheduler_runs_watchdog_at_stride(self, tel_off):
        set_flags({"telemetry": "metrics",
                   "telemetry_watchdog": "warn",
                   "telemetry_watchdog_stride": 2})
        telemetry.reset()
        try:
            # plant a ghost occupant filling the whole 2-page pool:
            # utilization 1.0 >= the high watermark -> pool-pressure
            # at the first stride check
            model = _FakeModel(num_pages=2)
            model.caches[0].lens["ghost"] = 8
            sched = BatchScheduler(model, max_batch_size=1)
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                sched.step()   # epoch 1: not a stride multiple
                assert sched._watchdog.checks == 0
                sched.step()   # epoch 2: detectors run
            assert sched._watchdog.checks == 1
            assert sched._watchdog.counts.get("pool-pressure") == 1
            assert any("pool-pressure" in str(x.message) for x in w)
            m = sched.metrics()
            assert m["watchdog"]["events"] == 1
            assert m["watchdog"]["by_class"] == {"pool-pressure": 1}
        finally:
            set_flags({"telemetry": "off",
                       "telemetry_watchdog": "off",
                       "telemetry_watchdog_stride": 32})
            telemetry.reset()

    def test_mode_validation(self, tel_off):
        reg = _mk_registry()
        with pytest.raises(ValueError):
            Watchdog(reg, mode="off")
        with pytest.raises(ValueError):
            Watchdog(None, mode="warn")


# -- shared-epoch ownership, warmup relativity, locking ----------------------


class TestSharedEpochAndWarmup:
    def test_advance_epoch_monotonic_set_epoch_never_rewinds(
            self, tel_off):
        r = telemetry.MetricsRegistry()
        assert r.advance_epoch() == 1
        assert r.advance_epoch() == 2
        r.set_epoch(9)
        assert r.epoch == 9
        r.set_epoch(3)   # a stale setter must not rewind the stamp
        assert r.epoch == 9

    def test_second_scheduler_does_not_rewind_windows(
            self, tel_metrics, monkeypatch):
        """The registry owns the epoch: a scheduler built after
        another has stepped must join the shared stamp, not restart
        it — or the first scheduler's fresh samples would fall
        outside its own trailing window."""
        now = [0.0]
        monkeypatch.setattr(telemetry, "_clock", lambda: now[0])
        a = BatchScheduler(_FakeModel(), max_batch_size=2)
        a.submit(Request("a0", [5], max_new_tokens=1))
        now[0] = 1.0
        a.step()                     # shared epoch 1, first TTFT
        b = BatchScheduler(_FakeModel(), max_batch_size=2)
        b.step()                     # late joiner: epoch 2, no rewind
        assert telemetry.registry().epoch == 2
        a.submit(Request("a1", [5], max_new_tokens=1))
        now[0] = 2.0
        a.step()                     # epoch 3, second TTFT
        w = a.metrics()["serving"]["ttft_s"]["window"]
        assert w["count"] == 2       # both samples inside a's window

    def test_storm_counts_max_of_redundant_signals_not_sum(
            self, tel_off):
        """compile.count and serving.compile_count are redundant
        views of the same recompiles: 3 real recompiles mirrored in
        both must read as 3 (max), never 6 (sum)."""
        reg = _mk_registry()
        wd = Watchdog(reg, mode="strict", window=8, warmup=0,
                      storm_compiles=4)
        wd.check(1)
        for e in range(2, 5):
            reg.inc("compile.count")
            reg.gauge("serving.compile_count", e - 1.0)
            wd.check(e)   # sum semantics would see 6 >= 4 and raise
        assert len(wd.events) == 0
        reg.inc("compile.count", 2)   # now 5 real recompiles
        reg.gauge("serving.compile_count", 5.0)
        with pytest.raises(WatchdogError):
            wd.check(5)

    def test_late_built_watchdog_gets_full_warmup(self, tel_off):
        """Warmup counts from the watchdog's FIRST check epoch, not
        the absolute shared registry epoch — a watchdog built at
        epoch 5000 still gets its startup grace."""
        reg = _mk_registry()
        wd = Watchdog(reg, mode="strict", window=8, warmup=4,
                      storm_compiles=2)
        for e in range(5000, 5004):
            reg.inc("compile.count", 3)  # burst on every check
            wd.check(e)                  # inside RELATIVE warmup
        assert len(wd.events) == 0
        reg.inc("compile.count", 2)
        wd.check(5004)                   # post-warmup re-baseline
        reg.inc("compile.count", 2)
        with pytest.raises(WatchdogError):
            wd.check(5005)               # a genuine storm still fires

    def test_decode_stall_respects_warmup(self, tel_off):
        """Startup steps that trace new bucket programs are
        legitimate wall outliers — stall must honor warmup too."""
        reg = _mk_registry()
        for e in range(1, 10):
            reg.set_epoch(e)
            reg.observe("serving.step_wall_s", 0.01)
        reg.set_epoch(10)
        reg.observe("serving.step_wall_s", 0.5)   # compile-step spike
        wd = Watchdog(reg, mode="strict", window=16, warmup=4)
        wd.check(10)           # first check: inside relative warmup
        assert len(wd.events) == 0
        for e in range(11, 14):
            reg.set_epoch(e)
            reg.observe("serving.step_wall_s", 0.01)
        reg.set_epoch(14)
        reg.observe("serving.step_wall_s", 0.5)
        with pytest.raises(WatchdogError) as ei:
            wd.check(14)       # identical outlier AFTER warmup fires
        assert ei.value.events[0]["class"] == "decode-stall"

    def test_hist_windowed_locked_read(self, tel_off):
        r = telemetry.MetricsRegistry()
        r.set_epoch(5)
        r.observe("serving.x", 2.0)
        w = r.hist_windowed("serving.x", 4)
        assert w["count"] == 1 and w["p50"] == 2.0
        assert r.hist_windowed("nope", 0) is None

    def test_explicit_slo_with_telemetry_off_warns(self, tel_off):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            BatchScheduler(_FakeModel(), max_batch_size=1,
                           slo=telemetry.SLOConfig(ttft_p99_s=1.0))
        assert any("FLAGS_telemetry is off" in str(x.message)
                   for x in w)

    def test_armed_profiler_trace_epochs_advance(self, tel_off):
        """A profiler window with the flag off still collects request
        traces — their epoch field must advance per step instead of
        stamping 0 everywhere."""
        telemetry.arm_tracer()
        try:
            sched = BatchScheduler(_FakeModel(), max_batch_size=1)
            sched.submit(Request("r0", [5], max_new_tokens=2))
            for _ in range(4):
                sched.step()
            tr = telemetry.request_traces().get("r0")
            epochs = [ev["epoch"] for ev in tr.events]
            assert max(epochs) > 0
            assert epochs == sorted(epochs)
        finally:
            telemetry.disarm_tracer()


# -- Prometheus export --------------------------------------------------------


class TestPrometheusExport:
    def _seed(self):
        r = telemetry.MetricsRegistry()
        r.inc("serving.steps", 42)
        r.gauge("pool.utilization", 0.25)
        for v in (0.5, 1.5, 3.0):
            r.observe("serving.ttft_s", v)
        return r

    def test_text_format_shapes(self, tel_off):
        text = telemetry.prometheus_text(registry=self._seed())
        assert "# TYPE paddle_serving_steps counter" in text
        assert "paddle_serving_steps 42" in text
        assert "# TYPE paddle_pool_utilization gauge" in text
        assert "paddle_pool_utilization 0.25" in text
        assert "# TYPE paddle_serving_ttft_s histogram" in text
        # cumulative buckets: 0.5 -> le=0.5; 1.5 -> le=2; 3.0 -> le=4
        assert 'paddle_serving_ttft_s_bucket{le="0.5"} 1' in text
        assert 'paddle_serving_ttft_s_bucket{le="2"} 2' in text
        assert 'paddle_serving_ttft_s_bucket{le="4"} 3' in text
        assert 'paddle_serving_ttft_s_bucket{le="+Inf"} 3' in text
        assert "paddle_serving_ttft_s_sum 5" in text
        assert "paddle_serving_ttft_s_count 3" in text
        assert ('paddle_serving_ttft_s_quantile{quantile="0.5",'
                'exactness="exact"} 1.5') in text

    def test_no_registry_and_nonnumeric_skipped(self, tel_off):
        assert "off" in telemetry.prometheus_text()
        snap = {"serving": {"steps": 1, "mode": "trace",
                            "list": [1, 2]},
                "telemetry": "trace"}
        text = telemetry.prometheus_text(snapshot=snap)
        assert "paddle_serving_steps 1" in text
        assert "mode" not in text and "list" not in text

    def test_write_prometheus_atomic(self, tel_off, tmp_path):
        path = str(tmp_path / "metrics.prom")
        telemetry.write_prometheus(path, registry=self._seed())
        text = open(path).read()
        assert "paddle_serving_steps 42" in text
        assert not (tmp_path / "metrics.prom.tmp").exists()

    def test_cli_export_prom(self, tel_off, tmp_path, capsys):
        tr = telemetry.Tracer(ring=16)
        with tr.span("serving.step"):
            pass
        path = str(tmp_path / "t.jsonl")
        tr.dump_jsonl(path, self._seed())
        assert telemetry.main(["--export-prom", path]) == 0
        out = capsys.readouterr().out
        assert "paddle_serving_steps 42" in out
        outp = str(tmp_path / "m.prom")
        assert telemetry.main(
            ["--export-prom", path, "--prom-out", outp]) == 0
        assert "paddle_serving_steps 42" in open(outp).read()

    def test_scheduler_periodic_export(self, tel_off, tmp_path):
        path = str(tmp_path / "serve.prom")
        set_flags({"telemetry": "metrics",
                   "telemetry_export_path": path,
                   "telemetry_watchdog_stride": 2})
        telemetry.reset()
        try:
            sched = BatchScheduler(_FakeModel(), max_batch_size=2)
            sched.submit(Request("a", [3, 4], max_new_tokens=3))
            sched.step()
            assert not (tmp_path / "serve.prom").exists()
            sched.step()  # stride hit -> snapshot written
            text = open(path).read()
            assert "paddle_serving_steps 2" in text
            assert "paddle_pool_total_pages" in text
        finally:
            set_flags({"telemetry": "off",
                       "telemetry_export_path": "",
                       "telemetry_watchdog_stride": 32})
            telemetry.reset()


# -- truncated-JSONL tolerance ------------------------------------------------


class TestTruncatedJsonl:
    def _dump(self, tmp_path):
        tr = telemetry.Tracer(ring=16)
        reg = telemetry.MetricsRegistry()
        with tr.span("serving.step"):
            pass
        reg.inc("serving.steps", 2)
        path = str(tmp_path / "t.jsonl")
        tr.dump_jsonl(path, reg)
        return path

    def test_truncated_final_line_tolerated(self, tmp_path, capsys,
                                            tel_off):
        path = self._dump(tmp_path)
        # a process killed mid-write leaves a partial record with NO
        # newline terminator
        with open(path, "a") as f:
            f.write('{"type": "span", "name": "cut-off", "ts"')
        loaded = telemetry._load_jsonl(path)
        assert loaded["truncated"] is True
        assert loaded["metrics"]["serving"]["steps"] == 2
        assert telemetry.main(["--summarize", path]) == 0
        out = capsys.readouterr().out
        assert "final JSONL line was truncated" in out
        assert "killed mid-write" in out

    def test_newline_terminated_garbage_still_raises(self, tmp_path,
                                                     tel_off):
        path = self._dump(tmp_path)
        with open(path, "a") as f:
            f.write("not json at all\n")  # complete line: corruption
        with pytest.raises(ValueError):
            telemetry.summarize_jsonl(path)

    def test_mid_file_garbage_still_raises(self, tmp_path, tel_off):
        path = self._dump(tmp_path)
        lines = open(path).read().splitlines()
        lines.insert(0, "garbage mid-file")
        with open(path, "w") as f:
            f.write("\n".join(lines))  # garbage is NOT final now
        with pytest.raises(ValueError):
            telemetry.summarize_jsonl(path)


# -- live ops plane — trace context, contextvars tracer, ----------
# -- fleet aggregation, exemplars, quantized-wire export --------------------


class TestTraceContext:
    def test_wire_round_trip(self, tel_off):
        ctx = telemetry.TraceContext(tenant="acme", deadline_s=2.5)
        back = telemetry.TraceContext.from_wire(ctx.to_wire())
        assert back == ctx
        assert back.trace_id == ctx.trace_id
        assert back.span_id == ctx.span_id
        assert back.tenant == "acme"
        assert back.deadline_s == 2.5

    def test_ids_are_process_unique(self, tel_off):
        a = telemetry.TraceContext()
        b = telemetry.TraceContext()
        assert a.trace_id != b.trace_id
        assert a.span_id != b.span_id

    def test_inject_extract_carrier(self, tel_off):
        ctx = telemetry.TraceContext(tenant="t9")
        carrier = {}
        ctx.inject(carrier)
        assert telemetry.TraceContext.WIRE_KEY in carrier
        assert telemetry.TraceContext.extract(carrier) == ctx
        assert telemetry.TraceContext.extract({}) is None
        assert telemetry.TraceContext.extract(None) is None

    def test_child_keeps_trace_moves_parent(self, tel_off):
        ctx = telemetry.TraceContext()
        kid = ctx.child(777)
        assert kid.trace_id == ctx.trace_id
        assert kid.span_id == 777

    def test_from_wire_rejects_garbage(self, tel_off):
        with pytest.raises(ValueError):
            telemetry.TraceContext.from_wire('{"nope": 1}')

    def test_off_mode_wire_string_ctx_still_serves(self, tel_off):
        """Review regression: a Request carrying an ingress wire
        STRING under FLAGS_telemetry=off must serve normally (no
        local context is built — the raw wire propagates to the
        pool untouched, so the cross-worker handoff survives a box
        with telemetry disabled)."""
        ctx = telemetry.TraceContext(tenant="edge")
        sched = BatchScheduler(_FakeSwapModel(), max_batch_size=2)
        req = Request("w0", [2, 3], max_new_tokens=2,
                      trace_ctx=ctx.to_wire())
        sched.submit(req)
        sched.run_until_complete()
        assert req.finished
        # off built nothing: still the raw string
        assert req.trace_ctx == ctx.to_wire()

    def test_ambient_context_manager(self, tel_off):
        assert telemetry.current_trace_context() is None
        ctx = telemetry.TraceContext()
        with telemetry.use_trace_context(ctx):
            assert telemetry.current_trace_context() is ctx
            inner = telemetry.TraceContext()
            with telemetry.use_trace_context(inner):
                assert telemetry.current_trace_context() is inner
            assert telemetry.current_trace_context() is ctx
        assert telemetry.current_trace_context() is None


class TestContextvarsTracer:
    """The Tracer's contextvars migration: per-task isolation, the
    executor-handoff tid fix, and trace-id stamping."""

    def test_cross_thread_close_attributes_opening_thread(self,
                                                          tel_off):
        import threading as _threading

        tr = telemetry.Tracer(ring=64)
        cm = tr.span("handoff")
        opener_tid = []

        def opener():
            cm.__enter__()
            opener_tid.append(_threading.get_ident())

        th = _threading.Thread(target=opener)
        th.start()
        th.join()
        # the executor handoff: the span is CLOSED on this thread
        cm.__exit__(None, None, None)
        s = tr.spans()[-1]
        assert s.name == "handoff"
        # the regression: tid must be the thread that DID the work,
        # not whoever happened to close (or construct) the span
        assert s.tid == opener_tid[0]
        assert s.tid != _threading.get_ident()
        # and this thread's nesting state is not corrupted
        with tr.span("after") as s2:
            assert s2.depth == 0
        assert tr.spans()[-1].path == "after"

    def test_asyncio_tasks_keep_isolated_stacks(self, tel_off):
        """Two tasks interleaving awaits on ONE loop thread: under
        the old threading.local stack their spans would nest into
        each other; under contextvars each task sees only its own
        ancestry."""
        import asyncio

        tr = telemetry.Tracer(ring=128)

        async def worker(i):
            with tr.span(f"outer{i}") as outer:
                await asyncio.sleep(0.01 * (2 - i))
                with tr.span(f"inner{i}") as inner:
                    await asyncio.sleep(0.01 * i)
                    assert inner.depth == 1
                return outer, inner

        async def main():
            return await asyncio.gather(worker(0), worker(1))

        (o0, i0), (o1, i1) = asyncio.run(main())
        assert i0.path == "outer0/inner0"
        assert i1.path == "outer1/inner1"
        assert i0.parent_id == o0.span_id
        assert i1.parent_id == o1.span_id
        assert o0.depth == 0 and o1.depth == 0

    def test_span_ids_and_parent_links(self, tel_off):
        tr = telemetry.Tracer(ring=16)
        with tr.span("a") as a:
            with tr.span("b") as b:
                pass
        assert b.parent_id == a.span_id
        assert a.parent_id is None
        assert a.trace_id is None  # no ambient context

    def test_ambient_context_stamps_spans(self, tel_off):
        tr = telemetry.Tracer(ring=16)
        ctx = telemetry.TraceContext()
        with telemetry.span_in(tr, ctx, "root") as root:
            assert root.trace_id == ctx.trace_id
            assert root.parent_id == ctx.span_id
            with tr.span("kid") as kid:
                pass
        # the nested span inherits the trace and parents to the
        # enclosing span (same trace)
        assert kid.trace_id == ctx.trace_id
        assert kid.parent_id == root.span_id

    def test_add_complete_stamps_ambient_context(self, tel_off):
        tr = telemetry.Tracer(ring=16)
        ctx = telemetry.TraceContext()
        with telemetry.use_trace_context(ctx):
            s = tr.add_complete("bridged", 1.0, 0.5)
        assert s.trace_id == ctx.trace_id
        assert s.parent_id == ctx.span_id

    def test_executor_hop_keeps_request_trace(self, tel_off):
        """A span opened under a request context, with the actual
        work hopped to an executor thread that opens its own child
        spans under the SAME context — one trace id throughout."""
        import asyncio
        from concurrent.futures import ThreadPoolExecutor

        tr = telemetry.Tracer(ring=64)
        ctx = telemetry.TraceContext()

        def blocking_work():
            with telemetry.span_in(tr, ctx, "work.inner"):
                pass

        async def main():
            loop = asyncio.get_event_loop()
            with ThreadPoolExecutor(max_workers=1) as pool:
                with telemetry.span_in(tr, ctx, "work.outer"):
                    await loop.run_in_executor(pool, blocking_work)

        asyncio.run(main())
        spans = {s.name: s for s in tr.spans()}
        assert spans["work.inner"].trace_id == ctx.trace_id
        assert spans["work.outer"].trace_id == ctx.trace_id
        # the inner span ran on a DIFFERENT thread yet still parents
        # to the request's root span
        assert spans["work.inner"].tid != spans["work.outer"].tid
        assert spans["work.inner"].parent_id == ctx.span_id

    def test_chrome_export_carries_trace_ids(self, tel_off):
        tr = telemetry.Tracer(ring=16)
        ctx = telemetry.TraceContext()
        with telemetry.span_in(tr, ctx, "traced", req="r1"):
            pass
        with tr.span("plain"):
            pass
        doc = tr.to_chrome()
        by_name = {e["name"]: e for e in doc["traceEvents"]}
        assert by_name["traced"]["args"]["trace_id"] == ctx.trace_id
        assert by_name["traced"]["args"]["parent_span"] == ctx.span_id
        assert by_name["traced"]["args"]["req"] == "r1"
        assert "trace_id" not in by_name["plain"]["args"]


# -- a swap-capable fake for the stitched-trace scenario ---------------------


class _FakeSwapCache(_FakeCache):
    """Host-only cache fake implementing the pool swap + trace-
    context protocol the scheduler drives (records live in the REAL
    HostKVSwapSpace via its pool-only entry points)."""

    PAGE_NBYTES = 64

    def __init__(self, num_pages=1024, page_size=4):
        super().__init__(num_pages=num_pages, page_size=page_size)
        self._uid = id(self)
        self._trace_ctxs = {}

    def _pages(self, s):
        n = self.lens[s]
        return -(-n // self.page_size) if n else 0

    def seq_page_count(self, s):
        return self._pages(s)

    def swap_out_pages(self, s):
        return self._pages(s)

    def swap_out_nbytes(self, s):
        return self._pages(s) * self.PAGE_NBYTES

    def swap_out(self, s, space):
        import types as _types

        rec = _types.SimpleNamespace(
            nbytes=self.swap_out_nbytes(s), length=self.lens[s],
            trace_ctx=self._trace_ctxs.pop(s, None))
        space._swap_put((self._uid, s), rec)
        pages = self._pages(s)
        del self.lens[s]
        return pages, rec.nbytes

    def swap_in_pages_needed(self, s, space, worst_tokens=None):
        rec = space._swap_get((self._uid, s))
        return -(-rec.length // self.page_size) if rec.length else 0

    def swap_in(self, s, space):
        rec = space._swap_pop((self._uid, s))
        space.swapped_in_records += 1
        self.lens[s] = rec.length
        if rec.trace_ctx is not None:
            self._trace_ctxs[s] = rec.trace_ctx
        return -(-rec.length // self.page_size) if rec.length else 0

    def swap_discard(self, s, space):
        space._swap_pop((self._uid, s))

    def set_trace_context(self, s, wire):
        self._trace_ctxs[s] = wire

    def seq_trace_context(self, s):
        return self._trace_ctxs.get(s)


class _FakeSwapModel(_FakeModel):
    def __init__(self, vocab=16, num_pages=1024):
        self.vocab = vocab
        self.caches = [_FakeSwapCache(num_pages=num_pages)]

    def swap_out(self, sid, space):
        freed = nbytes = 0
        for c in self.caches:
            fp, nb = c.swap_out(sid, space)
            freed += fp
            nbytes += nb
        return freed, nbytes

    def swap_in(self, sid, space):
        return sum(c.swap_in(sid, space) for c in self.caches)


class TestStitchedTrace:
    """One request traced through admission ->
    preemption/swap-out -> swap-in -> completion yields ONE stitched
    trace (single trace id, correct parent links) in the chrome
    export — including when the steps hop across asyncio executor
    threads."""

    def _run(self, step_driver):
        from paddle_tpu_torch.incubate.nn.fault_injection import (
            FaultInjector,
        )

        sched = BatchScheduler(
            _FakeSwapModel(), max_batch_size=4,
            swap_bytes=1 << 20,
            fault_injector=FaultInjector("preempt_storm@3:1"))
        reqs = [Request(f"r{i}", [2, 3, 4, 5], max_new_tokens=3)
                for i in range(2)]
        for r in reqs:
            sched.submit(r)
        step_driver(sched)
        assert all(r.finished for r in reqs)
        victims = [r for r in reqs if r._preemptions]
        assert victims, "the storm must have preempted someone"
        return sched, victims[0]

    def _assert_stitched(self, sched, victim):
        ctx = victim.trace_ctx
        assert ctx is not None
        tr = telemetry.tracer()
        book = telemetry.request_traces()
        mine = [s for s in tr.spans() if s.trace_id == ctx.trace_id]
        names = {s.name for s in mine}
        assert {"serving.preempt", "serving.swap_in",
                "serving.retire"} <= names
        # correct parent links: every request-scoped span parents to
        # the request's root span, under ONE trace id
        assert all(s.parent_id == ctx.span_id for s in mine)
        # no other trace bleeds in: spans of the OTHER request carry
        # a different trace id
        others = [s for s in tr.spans()
                  if s.trace_id not in (None, ctx.trace_id)]
        assert others, "the non-victim request must trace too"
        # the request-trace lane stitches: submit -> evict ->
        # admit(swapped_in) -> retire, opened with the trace id
        rec = book.get(victim.req_id).to_dict()
        kinds = [e["kind"] for e in rec["events"]]
        assert kinds[0] == "submit"
        assert "evict" in kinds and "retire" in kinds
        assert rec["events"][0]["trace_id"] == ctx.trace_id
        resumed = [e for e in rec["events"] if e["kind"] == "admit"
                   and e.get("swapped_in")]
        assert resumed, "the swap-in re-admission must be on the lane"
        # and the chrome export carries the stitched trace
        chrome = telemetry.chrome_payload(tr, book)
        traced = [e for e in chrome["traceEvents"]
                  if e.get("args", {}).get("trace_id")
                  == ctx.trace_id and e.get("ph") == "X"]
        assert {e["name"] for e in traced} >= {
            "serving.preempt", "serving.swap_in", "serving.retire"}
        assert all(e["args"]["parent_span"] == ctx.span_id
                   for e in traced)

    def test_preempt_swap_in_complete_single_trace(self, tel_trace):
        def drive(sched):
            for _ in range(50):
                if not (sched.num_active or sched.num_queued
                        or sched.num_swapped):
                    break
                sched.step()

        sched, victim = self._run(drive)
        self._assert_stitched(sched, victim)

    def test_stitches_across_asyncio_executor_hop(self, tel_trace):
        """The same scenario with every scheduler step dispatched
        through loop.run_in_executor over TWO alternating single-
        thread executors — consecutive steps run on different
        threads, the trace must not care."""
        import asyncio
        from concurrent.futures import ThreadPoolExecutor

        step_tids = []

        def drive(sched):
            async def main():
                loop = asyncio.get_event_loop()
                pools = [ThreadPoolExecutor(max_workers=1)
                         for _ in range(2)]
                try:
                    for i in range(50):
                        if not (sched.num_active or sched.num_queued
                                or sched.num_swapped):
                            break

                        def one_step():
                            import threading as _t

                            step_tids.append(_t.get_ident())
                            sched.step()

                        await loop.run_in_executor(
                            pools[i % 2], one_step)
                finally:
                    for p in pools:
                        p.shutdown()

            asyncio.run(main())

        sched, victim = self._run(drive)
        assert len(set(step_tids)) >= 2, \
            "the driver must actually hop threads"
        self._assert_stitched(sched, victim)

    def test_swap_record_carries_context_wire(self, tel_trace):
        """The fake-pool contract mirrored by the REAL pool: the
        serialized context rides the swap record through the host
        tier (HostKVSwapSpace) and comes back at swap-in."""
        sched, victim = self._run(lambda s: [s.step()
                                             for _ in range(40)])
        # after completion the cache-side wire survived the round
        # trip and still parses to the victim's context
        cache = sched.model.caches[0]
        # the sequence is freed at retire; what we assert is the
        # space is drained and nothing leaked
        assert sched.swap_space.num_records == 0
        assert sched.swap_space.swapped_in_records >= 1


class TestPoolTraceContextRoundTrip:
    """The REAL PagedKVCacheManager + HostKVSwapSpace: a serialized
    TraceContext pinned at admission rides the swap record bitwise
    through the host tier, is readable off the space (the future
    decode-worker ingress), and restores at swap-in; free() drops
    it; attach() hands it over with the chain."""

    def test_round_trip(self, tel_off):
        from paddle_tpu_torch.incubate.nn.paged_cache import (
            HostKVSwapSpace,
            PagedKVCacheManager,
        )

        pool = PagedKVCacheManager(num_pages=8, page_size=2,
                                   kv_heads=1, head_dim=4, device="cpu")
        space = HostKVSwapSpace(1 << 20)
        tok = np.ones((1, 4), np.float32)
        pool.alloc("s")
        for _ in range(3):
            pool.append("s", tok, tok)
        ctx = telemetry.TraceContext(tenant="t1")
        pool.set_trace_context("s", ctx.to_wire())
        assert pool.seq_trace_context("s") == ctx.to_wire()
        pool.swap_out("s", space)
        # the record carries it; the pool forgot it
        assert pool.seq_trace_context("s") is None
        assert space.trace_context("s") == ctx.to_wire()
        back = telemetry.TraceContext.from_wire(
            space.trace_context("s"))
        assert back == ctx
        pool.swap_in("s", space)
        assert space.trace_context("s") is None
        assert pool.seq_trace_context("s") == ctx.to_wire()
        pool.free("s")
        assert pool.seq_trace_context("s") is None

    def test_attach_hands_over_context(self, tel_off):
        from paddle_tpu_torch.incubate.nn.paged_cache import (
            PagedKVCacheManager,
        )

        pool = PagedKVCacheManager(num_pages=8, page_size=2,
                                   kv_heads=1, head_dim=4, device="cpu")
        tok = np.ones((1, 4), np.float32)
        pool.alloc("a")
        for _ in range(4):
            pool.append("a", tok, tok)
        chain = list(pool.seq_pages("a"))
        pool.incref(chain)
        pool.free("a")
        ctx = telemetry.TraceContext()
        pool.attach("b", chain, 4, trace_ctx=ctx.to_wire())
        assert pool.seq_trace_context("b") == ctx.to_wire()
        assert pool.set_trace_context  # public surface exists
        with pytest.raises(KeyError):
            pool.set_trace_context("nope", ctx.to_wire())


class TestMergeSnapshots:
    """Fleet aggregation: counter sums and histogram totals EXACT,
    gauges by declared semantics, merged quantiles bounded by the
    per-worker maxima, worker labels in the exposition."""

    def _worlds(self):
        regs = {}
        for w in ("w0", "w1", "w2"):
            reg = telemetry.MetricsRegistry()
            regs[w] = reg
        regs["w0"].inc("serving.steps", 10)
        regs["w1"].inc("serving.steps", 12)
        regs["w2"].inc("serving.steps", 5)
        regs["w0"].gauge("pool.free_pages", 10.0)
        regs["w1"].gauge("pool.free_pages", 20.0)
        regs["w2"].gauge("pool.free_pages", 30.0)
        regs["w0"].gauge("pool.utilization", 0.5)
        regs["w1"].gauge("pool.utilization", 0.9)
        regs["w2"].gauge("pool.utilization", 0.7)
        regs["w0"].gauge("serving.goodput", 1.0)
        regs["w1"].gauge("serving.goodput", 0.6)
        regs["w2"].gauge("serving.goodput", 0.8)
        for w, vals in (("w0", [0.1, 0.2]), ("w1", [0.4]),
                        ("w2", [0.05, 0.3, 0.6])):
            for v in vals:
                regs[w].observe("serving.ttft_s", v)
        return {w: r.snapshot() for w, r in regs.items()}

    def test_counters_sum_exactly(self, tel_off):
        merged = telemetry.merge_snapshots(self._worlds())
        assert merged["serving"]["steps"] == 27

    def test_histogram_totals_sum_exactly(self, tel_off):
        snaps = self._worlds()
        merged = telemetry.merge_snapshots(snaps)
        h = merged["serving"]["ttft_s"]
        assert h["count"] == 6
        assert h["sum"] == pytest.approx(0.1 + 0.2 + 0.4 + 0.05
                                         + 0.3 + 0.6)
        assert h["min"] == 0.05 and h["max"] == 0.6
        assert h["exactness"] == "bucket-upper-bound"
        # bucket counts add across workers
        total_bucketed = sum(n for _, n in h["buckets"])
        assert total_bucketed == 6

    def test_gauge_semantics(self, tel_off):
        merged = telemetry.merge_snapshots(self._worlds())
        assert merged["pool"]["free_pages"] == 60.0        # sum
        assert merged["pool"]["utilization"] == 0.9        # max
        assert merged["serving"]["goodput"] == 0.6         # min
        assert telemetry.gauge_merge_kind(
            "pool.free_pages") == "sum"
        assert telemetry.gauge_merge_kind(
            "serving.slo_attain_ttft") == "min"
        assert telemetry.gauge_merge_kind(
            "serving.uptime_s") == "max"

    def test_merged_p99_bounded_by_worker_maxima(self, tel_off):
        """Property over random worker
        histograms, the merged p99 estimate never exceeds the max of
        the per-worker maxima."""
        rng = random.Random(7)
        for trial in range(25):
            snaps = {}
            maxima = []
            for w in range(3):
                reg = telemetry.MetricsRegistry()
                vals = [rng.uniform(1e-4, 10.0) ** 2
                        for _ in range(rng.randint(1, 40))]
                for v in vals:
                    reg.observe("serving.tpot_s", v)
                maxima.append(max(vals))
                snaps[f"w{w}"] = reg.snapshot()
            merged = telemetry.merge_snapshots(snaps)
            h = merged["serving"]["tpot_s"]
            for q in ("p50", "p90", "p99"):
                assert h[q] is not None
                assert h[q] <= max(maxima) + 1e-12, (
                    trial, q, h[q], maxima)

    def test_exposition_worker_labels_and_exact_sums(self, tel_off):
        import re

        snaps = self._worlds()
        text = telemetry.merged_prometheus_text(snaps)
        # aggregate == sum of the labelled per-worker series, parsed
        # back OUT of the exposition
        agg = int(re.search(
            r"^paddle_serving_steps (\d+)$", text, re.M).group(1))
        per = [int(v) for v in re.findall(
            r'^paddle_serving_steps\{worker="w\d"\} (\d+)$',
            text, re.M)]
        assert len(per) == 3 and agg == sum(per) == 27
        # histogram totals: the same exactness, from the text
        hagg = int(re.search(
            r"^paddle_serving_ttft_s_count (\d+)$", text,
            re.M).group(1))
        hper = [int(v) for v in re.findall(
            r'^paddle_serving_ttft_s_count\{worker="w\d"\} (\d+)$',
            text, re.M)]
        assert len(hper) == 3 and hagg == sum(hper) == 6
        sums = [float(v) for v in re.findall(
            r'^paddle_serving_ttft_s_sum\{worker="w\d"\} (\S+)$',
            text, re.M)]
        total = float(re.search(
            r"^paddle_serving_ttft_s_sum (\S+)$", text,
            re.M).group(1))
        assert total == pytest.approx(sum(sums))
        # merged quantiles are labelled as estimates
        assert 'exactness="bucket-upper-bound"' in text

    def test_list_input_auto_names(self, tel_off):
        reg = telemetry.MetricsRegistry()
        reg.inc("serving.steps", 1)
        text = telemetry.merged_prometheus_text(
            [reg.snapshot(), reg.snapshot()])
        assert 'worker="w0"' in text and 'worker="w1"' in text


class TestDisaggMergeKinds:
    """The engine/router gauges declare their
    fleet-merge semantics — populations SUM (sessions, replicas,
    inflight streams), health floors MIN (goodput), backpressure
    states MAX (the fleet is as backpressured as its worst member) —
    and a mixed prefill/decode fleet merges accordingly with
    role-labelled series in the exposition."""

    def test_declared_kinds(self, tel_off):
        assert telemetry.gauge_merge_kind(
            "engine.inflight_streams") == "sum"
        assert telemetry.gauge_merge_kind(
            "router.sessions") == "sum"
        assert telemetry.gauge_merge_kind(
            "router.replicas") == "sum"
        assert telemetry.gauge_merge_kind(
            "engine.backpressure_state") == "max"
        assert telemetry.gauge_merge_kind(
            "router.backpressure_state") == "max"
        assert telemetry.gauge_merge_kind("serving.goodput") == "min"

    def _fleet(self):
        """One prefill-role worker, two decode-role workers."""
        pre = telemetry.MetricsRegistry()
        pre.inc("serving.handoff_out_requests", 4)
        pre.gauge("engine.backpressure_state", 0.0)
        d0 = telemetry.MetricsRegistry()
        d0.inc("serving.handoff_in_requests", 3)
        d0.inc("engine.adopted", 3)
        d0.gauge("engine.backpressure_state", 2.0)
        d0.gauge("engine.inflight_streams", 3.0)
        d0.gauge("router.sessions", 3.0)
        d0.gauge("serving.goodput", 0.5)
        d1 = telemetry.MetricsRegistry()
        d1.inc("serving.handoff_in_requests", 1)
        d1.inc("engine.adopted", 1)
        d1.gauge("engine.backpressure_state", 1.0)
        d1.gauge("engine.inflight_streams", 1.0)
        d1.gauge("router.sessions", 1.0)
        d1.gauge("serving.goodput", 0.9)
        return {"prefill0": pre.snapshot(), "decode0": d0.snapshot(),
                "decode1": d1.snapshot()}

    def test_mixed_role_fleet_merge(self, tel_off):
        merged = telemetry.merge_snapshots(self._fleet())
        # counters: exact sums across roles
        assert merged["serving"]["handoff_out_requests"] == 4
        assert merged["serving"]["handoff_in_requests"] == 4
        assert merged["engine"]["adopted"] == 4
        # populations sum, backpressure takes the worst member,
        # goodput the weakest
        assert merged["engine"]["inflight_streams"] == 4.0
        assert merged["router"]["sessions"] == 4.0
        assert merged["engine"]["backpressure_state"] == 2.0
        assert merged["serving"]["goodput"] == 0.5

    def test_role_labelled_exposition(self, tel_off):
        text = telemetry.merged_prometheus_text(self._fleet())
        assert 'worker="prefill0"' in text
        assert 'worker="decode0"' in text
        assert ('paddle_engine_backpressure_state'
                '{worker="decode0"} 2') in text
        # the unlabelled aggregate is the declared-max merge
        import re

        agg = re.search(
            r"^paddle_engine_backpressure_state (\S+)$", text, re.M)
        assert agg is not None and float(agg.group(1)) == 2.0


class TestAggregateCLI:
    def _snap_files(self, tmp_path):
        reg = telemetry.MetricsRegistry()
        reg.inc("serving.steps", 4)
        reg.observe("serving.ttft_s", 0.2)
        raw = tmp_path / "worker_a.json"
        raw.write_text(json.dumps(reg.snapshot()))
        # the TELEMETRY_LAST.json bench-artifact shape
        art = tmp_path / "worker_b.json"
        art.write_text(json.dumps(
            {"config": "serving_telemetry",
             "snapshot": reg.snapshot(), "slo_window": {}}))
        # a JSONL dump with a metrics record
        tr = telemetry.Tracer(ring=8)
        with tr.span("serving.step"):
            pass
        dump = tmp_path / "worker_c.jsonl"
        tr.dump_jsonl(str(dump), reg)
        return [str(raw), str(art), str(dump)]

    def test_aggregate_round_trip(self, tmp_path, capsys, tel_off):
        files = self._snap_files(tmp_path)
        assert telemetry.main(["aggregate"] + files) == 0
        out = capsys.readouterr().out
        assert "paddle_serving_steps 12" in out  # 3 x 4, exact
        assert 'paddle_serving_steps{worker="worker_a"} 4' in out
        assert 'worker="worker_c"' in out

    def test_aggregate_to_file_and_json(self, tmp_path, capsys,
                                        tel_off):
        files = self._snap_files(tmp_path)
        out_prom = tmp_path / "fleet.prom"
        out_json = tmp_path / "fleet.json"
        assert telemetry.main(
            ["aggregate"] + files
            + ["-o", str(out_prom), "--merged-json",
               str(out_json)]) == 0
        text = out_prom.read_text()
        assert "paddle_serving_steps 12" in text
        merged = json.loads(out_json.read_text())
        assert merged["serving"]["steps"] == 12

    def test_aggregate_explicit_worker_names(self, tmp_path, capsys,
                                             tel_off):
        files = self._snap_files(tmp_path)
        assert telemetry.main(
            ["aggregate", "--worker", "east=" + files[0],
             "--worker", "west=" + files[1]]) == 0
        out = capsys.readouterr().out
        assert 'worker="east"' in out and 'worker="west"' in out


class TestExemplars:
    def test_observe_with_exemplar_renders_openmetrics(self,
                                                       tel_off):
        reg = telemetry.MetricsRegistry()
        reg.observe("serving.ttft_s", 0.25, exemplar="pid-7")
        reg.observe("serving.ttft_s", 0.26)  # no exemplar: kept
        text = telemetry.prometheus_text(registry=reg)
        assert '# {trace_id="pid-7"} 0.25' in text
        summ = reg.histogram("serving.ttft_s").summary()
        assert summ["exemplars"] == [[0.25, "pid-7", 0.25]]

    def test_no_exemplar_means_no_key(self, tel_off):
        reg = telemetry.MetricsRegistry()
        reg.observe("serving.ttft_s", 0.25)
        assert "exemplars" not in reg.histogram(
            "serving.ttft_s").summary()

    def test_merged_exposition_keeps_exemplars(self, tel_off):
        """Review regression: the fleet exposition must render the
        exemplars merge_snapshots carries, not just collect them."""
        reg = telemetry.MetricsRegistry()
        reg.observe("serving.ttft_s", 0.25, exemplar="tr-9")
        text = telemetry.merged_prometheus_text(
            {"w0": reg.snapshot(), "w1": reg.snapshot()})
        assert '# {trace_id="tr-9"} 0.25' in text

    def test_scheduler_links_ttft_to_trace_id(self, tel_metrics):
        sched = BatchScheduler(_FakeModel(), max_batch_size=2)
        req = Request("rx", [3, 4], max_new_tokens=2)
        sched.submit(req)
        sched.run_until_complete()
        assert req.trace_ctx is not None
        text = telemetry.prometheus_text(registry=tel_metrics)
        assert ('trace_id="%s"' % req.trace_ctx.trace_id) in text


class TestQuantizedWireExport:
    """The quantized-wire counters and the
    perf-ledger quantized-bytes plan field reach the Prometheus
    exposition (and therefore /metrics and the aggregation CLI)."""

    def test_collective_counters_render(self, tel_metrics):
        reg = tel_metrics
        reg.inc("collective.quantized.ag_mm", 3)
        reg.inc("collective.wire_bytes_quantized", 1024)
        reg.inc("collective.wire_bytes_saved", 2048)
        text = telemetry.prometheus_text(registry=reg)
        assert "paddle_collective_quantized_ag_mm 3" in text
        assert "paddle_collective_wire_bytes_quantized 1024" in text
        assert "paddle_collective_wire_bytes_saved 2048" in text
        # and they survive fleet aggregation with exact sums
        merged = telemetry.merged_prometheus_text(
            {"a": reg.snapshot(), "b": reg.snapshot()})
        assert "paddle_collective_wire_bytes_saved 4096" in merged

    def test_ledger_quantized_bytes_field(self, tel_metrics):
        from paddle_tpu_torch.framework import perf_ledger

        led = perf_ledger.PerfLedger(tel_metrics)
        led.register_plan("ring_prog", {
            "flops_total": 1e9, "hbm_peak_bytes": 1e6,
            "input_bytes": 1e5, "donated_bytes": 0,
            "const_bytes": 0, "output_bytes": 1e5,
            "comm_bytes_total": 8e4, "comm_bytes_quantized": 2e4,
        })
        led.record("ring_prog", 0.25)
        row = led.report()["ring_prog"]
        assert row["wire_bytes_quantized_per_s"] == pytest.approx(
            2e4 / 0.25)
        led.publish()
        assert tel_metrics.gauge_value(
            "ledger.wire_bytes_quantized_per_s.ring_prog") \
            == pytest.approx(2e4 / 0.25)
        text = telemetry.prometheus_text(registry=tel_metrics)
        assert ("paddle_ledger_wire_bytes_quantized_per_s_ring_prog"
                in text)

    def test_unquantized_plan_has_no_column(self, tel_metrics):
        from paddle_tpu_torch.framework import perf_ledger

        led = perf_ledger.PerfLedger(tel_metrics)
        led.register_plan("fp_prog", {
            "flops_total": 1e9, "hbm_peak_bytes": 1e6,
            "input_bytes": 1e5, "donated_bytes": 0,
            "const_bytes": 0, "output_bytes": 1e5,
            "comm_bytes_total": 8e4, "comm_bytes_quantized": 0,
        })
        led.record("fp_prog", 0.25)
        assert "wire_bytes_quantized_per_s" not in \
            led.report()["fp_prog"]
