"""Runtime telemetry of the port: a process-wide metrics registry and a
nestable span tracer for the serving path (counterpart of the
reference's ``framework/telemetry.py``, which imports no JAX; the port
keeps its own copy).

Two surfaces, both behind ``FLAGS_telemetry=off|metrics|trace``:

* :class:`MetricsRegistry`: named counters, gauges and log2-bucketed
  histograms with EXACT p50/p90/p99 readout (a bounded raw-sample
  reservoir rides next to the bucket counts; percentiles are exact
  while a histogram has seen at most ``FLAGS_telemetry_samples``
  values, and exact over the newest window after that). Metric names
  are ``namespace.metric`` (``serving.ttft_s``, ``pool.cow_forks``;
  the inventory is :data:`SURFACE`).
* :class:`Tracer`: nestable wall-clock spans (monotonic clock, never
  ``time.time``) with attributes, kept in a bounded ring buffer
  (``FLAGS_telemetry_ring``); dumps to JSONL and exports Chrome trace
  JSON (the ``chrome://tracing`` / Perfetto "traceEvents" format).

Zero-cost off mode: ``registry()``/``tracer()`` return ``None`` when
the flag is off and this module allocates NOTHING; instrumented call
sites cache the handle at construction and pay one ``is None`` check
per event.

Request-lifecycle layer:

* :class:`RequestTraceBook`: per-request trace assembly keyed by
  request id (submit -> admit -> prefill chunks -> tokens -> retire),
  a bounded LRU of completed traces, JSONL records, and per-request
  LANES in the Chrome export (one named track per request).
* :class:`SLOConfig` + windowed histogram views: declarative latency
  SLOs and ``serving.goodput`` attainment, windowed by scheduler STEP
  EPOCH (not wall clock), so the accounting is deterministic under a
  fake clock.
* :func:`prometheus_text` / :func:`write_prometheus`: a Prometheus
  text-format renderer over the registry, periodically snapshotted to
  ``FLAGS_telemetry_export_path``.
* the anomaly watchdogs live in the sibling
  :mod:`paddle_tpu_torch.framework.watchdog` (they only read the
  registry).

Performance-ledger layer (siblings
:mod:`paddle_tpu_torch.framework.perf_ledger` /
:mod:`paddle_tpu_torch.framework.flight_recorder`): the serving
scheduler stamps per-invocation walls into ``exec.wall_s.<program>``
histograms, the ledger joins them with registered resource plans into
live plan-vs-actual attribution (MFU, bytes/s, plan drift: the
``--ledger`` CLI mode and the top-programs table in ``--summarize``),
and :class:`FlightRecorder` (re-exported here) turns every watchdog
trip into an atomic incident bundle readable with
``--summarize-incident``.

Trace identity and fleet aggregation:

* :class:`TraceContext`: serializable per-request trace identity
  (trace id, root span, tenant, deadline) with ``inject``/``extract``
  carrier helpers; the span stack and the ambient context live in
  :mod:`contextvars`, so nesting survives asyncio tasks and executor
  hops (``tid`` is stamped by the thread doing the work).
* :func:`merge_snapshots` / :func:`merged_prometheus_text`: N worker
  snapshots into one ``worker``-labelled exposition (exact
  counter/histogram sums, declared gauge semantics), plus OpenMetrics
  exemplars linking TTFT/TPOT buckets to trace ids.

CLI::

    python -m paddle_tpu_torch.framework.telemetry --summarize trace.jsonl
    python -m paddle_tpu_torch.framework.telemetry --export-chrome trace.jsonl -o trace.json
    python -m paddle_tpu_torch.framework.telemetry --export-prom trace.jsonl
    python -m paddle_tpu_torch.framework.telemetry --ledger trace.jsonl
    python -m paddle_tpu_torch.framework.telemetry --summarize-incident <bundle-dir>
    python -m paddle_tpu_torch.framework.telemetry aggregate w0.json w1.jsonl -o fleet.prom

``--summarize`` prints the aggregated span tree, the per-request
trace and watchdog-event digests, plus the counter/gauge/histogram
table from the snapshot record (a truncated final line, from a process
killed mid-write, is tolerated and noted in the footer);
``--export-chrome`` converts the JSONL stream to a Chrome-trace JSON
file loadable in ``chrome://tracing`` or https://ui.perfetto.dev;
``--export-prom`` renders the snapshot record in the Prometheus text
exposition format.

This module is host-only: it imports neither torch nor device code,
and :func:`clock` is the one clock of the serving stack
(``inference/serving.py``, ``paged_cache.py`` and ``prefix_cache.py``
read time through it, so a test can patch it in one place).
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import json
import math
import os
import threading
from typing import Dict, List, Optional, Tuple

import time as _time

from .flags import flag
from . import concurrency as _concurrency

__all__ = [
    "MetricsRegistry", "Histogram", "Tracer", "Span",
    "SLOConfig", "RequestTrace", "RequestTraceBook",
    "FlightRecorder", "TraceContext",
    "telemetry_mode", "metrics_on", "tracing_on", "registry", "tracer",
    "request_traces", "clock", "reset", "arm_tracer", "disarm_tracer",
    "current_trace_context", "use_trace_context", "span_in",
    "export_chrome", "chrome_payload", "prometheus_text",
    "write_prometheus", "atomic_write_text", "summarize_jsonl",
    "chrome_from_jsonl", "summarize_incident",
    "merge_snapshots", "merged_prometheus_text",
    "SURFACE", "NULL_SPAN",
]

# the sanctioned wall clock (monotonic; tests substitute a fake):
# every timestamp this module (and, transitively, the serving stack)
# records comes from here
_clock = _time.perf_counter


def clock() -> float:
    """Monotonic wall clock (seconds) — the single timing source of
    the instrumented serving/compile paths."""
    return _clock()


_MODES = ("off", "metrics", "trace")


def _nearest_rank(sorted_vals, p: float):
    """Nearest-rank percentile over an ALREADY-SORTED list — exact
    (an actually-observed value, never an interpolation). The single
    rank convention shared by Histogram readouts and per-request SLO
    verdicts, so the two can never silently diverge."""
    n = len(sorted_vals)
    if not n:
        return None
    rank = max(1, math.ceil(p / 100.0 * n))
    return sorted_vals[min(rank, n) - 1]


def telemetry_mode() -> str:
    """FLAGS_telemetry, normalized; unknown values read 'off' (a
    typo'd deployment flag must not silently allocate telemetry
    state)."""
    mode = str(flag("telemetry")).lower()
    return mode if mode in _MODES else "off"


def metrics_on() -> bool:
    return telemetry_mode() in ("metrics", "trace")


def tracing_on() -> bool:
    return telemetry_mode() == "trace" or _ARMED > 0


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


def _bucket_exp(v: float) -> Optional[int]:
    """Log2 bucket of ``v``: the exponent ``e`` with
    ``2**(e-1) < v <= 2**e`` (None for v <= 0 — the zero bucket)."""
    if v <= 0.0:
        return None
    m, e = math.frexp(v)  # v = m * 2**e, 0.5 <= m < 1
    return e if m > 0.5 else e - 1


class Histogram:
    """Log2-bucketed histogram with an exact-percentile reservoir.

    ``observe`` is O(1): one bucket increment plus an append into a
    bounded deque of raw samples. ``percentile`` sorts the reservoir
    on read (readout is rare) and applies the nearest-rank method —
    EXACT while ``count <= capacity``, exact over the newest
    ``capacity`` samples after rollover (``summary()["exact"]`` says
    which). Bucket counts always cover every observation.

    Samples are EPOCH-stamped (the registry stamps its current step
    epoch at observe time): :meth:`windowed` reads back an exact
    summary over only the samples recorded at or after a given epoch
    — the sliding-window percentile views the SLO/goodput layer and
    the watchdogs consume. Windowing by step epoch rather than wall
    clock keeps every windowed readout deterministic under a fake
    clock."""

    __slots__ = ("count", "total", "min", "max", "_buckets",
                 "_samples", "_exemplars")

    def __init__(self, samples: Optional[int] = None):
        cap = int(flag("telemetry_samples")) if samples is None \
            else int(samples)
        # reservoir of (epoch, value) pairs, newest last
        self._samples = collections.deque(maxlen=max(1, cap))
        self._buckets: Dict[Optional[int], int] = {}
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # OpenMetrics-style exemplars: newest (label, value) per
        # bucket — the TTFT/TPOT -> trace-id link the fleet
        # aggregation story documents. None until the first exemplar
        # lands (most histograms never carry any)
        self._exemplars: Optional[Dict[Optional[int], tuple]] = None

    def observe(self, value, epoch: int = 0, exemplar=None) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        e = _bucket_exp(v)
        self._buckets[e] = self._buckets.get(e, 0) + 1
        self._samples.append((int(epoch), v))
        if exemplar is not None:
            # one exemplar per bucket, newest wins (bounded by the
            # bucket count, which log2 bounds by value range)
            if self._exemplars is None:
                self._exemplars = {}
            self._exemplars[e] = (str(exemplar), v)

    def samples(self) -> List[Tuple[int, float]]:
        """The retained ``(epoch, value)`` reservoir, oldest first —
        the read-only surface the watchdog detectors window over.
        Prefer :meth:`MetricsRegistry.hist_samples`, which copies
        under the registry lock."""
        return list(self._samples)

    def percentile(self, p: float,
                   min_epoch: Optional[int] = None) -> Optional[float]:
        """Nearest-rank percentile over the retained samples (exact —
        an actually-observed value, never an interpolation).
        ``min_epoch`` restricts to samples stamped at or after that
        step epoch (the sliding-window view)."""
        if min_epoch is None:
            s = sorted(v for _, v in self._samples)
        else:
            s = sorted(v for e, v in self._samples if e >= min_epoch)
        return _nearest_rank(s, p)

    def windowed(self, min_epoch: int) -> dict:
        """Exact summary over only the samples stamped at or after
        ``min_epoch`` — deterministic under the fake clock because
        the window is keyed by step epoch, never wall time. One
        filter + one sort; the three quantiles index the same sorted
        list (a periodic scrape calls this per histogram per pass)."""
        s = sorted(v for e, v in self._samples if e >= min_epoch)
        n = len(s)

        return {
            "count": n,
            "min": s[0] if n else None,
            "max": s[-1] if n else None,
            "avg": (sum(s) / n) if n else None,
            "p50": _nearest_rank(s, 50),
            "p90": _nearest_rank(s, 90),
            "p99": _nearest_rank(s, 99),
            "from_epoch": int(min_epoch),
        }

    def buckets(self) -> List[Tuple[float, int]]:
        """Sorted (upper_bound, count) pairs; bound 0.0 holds the
        non-positive observations."""
        out = []
        for e, n in self._buckets.items():
            out.append((0.0 if e is None else float(2.0 ** e), n))
        return sorted(out)

    def exemplars(self) -> List[Tuple[float, str, float]]:
        """Sorted (bucket_upper_bound, label, value) triples — one
        exemplar per bucket that ever received one (empty for the
        common no-exemplar histogram)."""
        if not self._exemplars:
            return []
        out = []
        for e, (label, v) in self._exemplars.items():
            out.append((0.0 if e is None else float(2.0 ** e),
                        label, v))
        return sorted(out)

    def summary(self) -> dict:
        cap = self._samples.maxlen
        out = {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "avg": (self.total / self.count) if self.count else None,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "exact": self.count <= cap,
            "buckets": self.buckets(),
        }
        ex = self.exemplars()
        if ex:
            out["exemplars"] = [list(t) for t in ex]
        return out


class MetricsRegistry:
    """Named counters / gauges / histograms, namespaced by the first
    dot of the metric name (``serving.ttft_s`` lands under
    ``snapshot()["serving"]["ttft_s"]``). All access through the
    registry is serialized on one lock — a bare :class:`Histogram`
    held outside the registry is NOT thread-safe on its own."""

    def __init__(self):
        self._lock = _concurrency.guarded("telemetry.registry")
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        # the current scheduler step epoch: stamped onto every
        # histogram sample so windowed views (SLO attainment,
        # watchdog rates) are keyed by step count, not wall clock
        self.epoch = 0
        # concurrency-sanitizer shadow handle (None when off): every
        # metric table access below reports through it
        _csan = _concurrency.sanitizer()
        self._cv = None if _csan is None else _csan.shared(
            "telemetry.registry.metrics", owner=self,
            guard="telemetry.registry")

    # -- writes ------------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def gauge(self, name: str, value) -> None:
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            self._gauges[name] = float(value)

    def observe(self, name: str, value, exemplar=None) -> None:
        """Record one histogram sample. ``exemplar`` (optional, e.g.
        a trace id) attaches an OpenMetrics exemplar to the sample's
        bucket — the link between a latency bucket and the request
        trace that landed in it."""
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            h = self._hists.get(name)
            if h is None:
                h = self._hists.setdefault(name, Histogram())
            h.observe(value, self.epoch, exemplar)

    def advance_epoch(self) -> int:
        """Advance the REGISTRY-OWNED monotonic epoch stamp by one
        and return it — the scheduler calls this once per step,
        BEFORE the step's observations land. The registry owns the
        counter (not the scheduler) so two live schedulers sharing
        the process-wide registry advance ONE monotonic stamp
        instead of rewinding each other's windowed views."""
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            self.epoch += 1
            return self.epoch

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch stamp to an explicit value (test/bench
        fixtures hand-stepping a fake clock). Never rewinds: the
        epoch is the monotonic window key of every windowed view, so
        a stale setter (an older scheduler, a replayed fixture) must
        not invalidate samples already stamped ahead of it."""
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            self.epoch = max(self.epoch, int(epoch))

    # -- reads -------------------------------------------------------------
    # counter/gauge_value/histogram used to read the metric tables
    # WITHOUT the lock — the same scrape-vs-mutate class as
    # hist_windowed (a /statusz provider reading a counter while
    # the serving thread rehashes the dict under it). All reads now
    # take the registry lock; the concurrency sanitizer audits them.
    def counter(self, name: str) -> int:
        with self._lock:
            if self._cv is not None:
                self._cv.read()
            return self._counters.get(name, 0)

    def gauge_value(self, name: str) -> Optional[float]:
        with self._lock:
            if self._cv is not None:
                self._cv.read()
            return self._gauges.get(name)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            if self._cv is not None:
                self._cv.read()
            return self._hists.get(name)

    def hist_windowed(self, name: str,
                      min_epoch: int) -> Optional[dict]:
        """A histogram's :meth:`Histogram.windowed` summary computed
        under the registry lock — the sanctioned windowed read (a
        scrape thread sorting the reservoir while the serving thread
        observes into it would hit "deque mutated during
        iteration")."""
        with self._lock:
            if self._cv is not None:
                self._cv.read()
            h = self._hists.get(name)
            return None if h is None else h.windowed(min_epoch)

    def hist_samples(self, name: str,
                     min_epoch: Optional[int] = None
                     ) -> List[Tuple[int, float]]:
        """Copy of a histogram's (epoch, value) reservoir, taken
        under the registry lock — the sanctioned read for watchdog
        detectors (no mutation surface)."""
        with self._lock:
            if self._cv is not None:
                self._cv.read()
            h = self._hists.get(name)
            if h is None:
                return []
            s = h.samples()
        if min_epoch is not None:
            s = [(e, v) for e, v in s if e >= min_epoch]
        return s

    def snapshot(self) -> dict:
        """One nested dict: {namespace: {metric: value}} — counters as
        ints, gauges as floats, histograms as their summary dicts."""
        out: Dict[str, dict] = {}

        def put(name, value):
            ns, _, key = name.partition(".")
            out.setdefault(ns, {})[key or ns] = value

        with self._lock:
            if self._cv is not None:
                self._cv.read()
            for name, v in sorted(self._counters.items()):
                put(name, v)
            for name, v in sorted(self._gauges.items()):
                put(name, v)
            # summaries sort the sample reservoirs — build them under
            # the lock so a concurrent observe cannot mutate a deque
            # mid-sort
            for name, h in sorted(self._hists.items()):
                put(name, h.summary())
        return out


# ---------------------------------------------------------------------------
# SLO config (the declarative half of goodput accounting)
# ---------------------------------------------------------------------------


class SLOConfig:
    """Declarative serving SLOs, all in seconds: ``ttft_p99_s`` (time
    to first token), ``tpot_p99_s`` (bound on a request's p99
    inter-token gap), ``queue_wait_p99_s`` (submit -> admission).
    ``None`` disables a bound. A retired request *meets* the config
    when every configured bound holds for it; the scheduler's
    ``serving.goodput`` gauge is the fraction of requests retired in
    the trailing ``FLAGS_telemetry_window`` step epochs that met ALL
    bounds — the signal the future admission controller gates on."""

    __slots__ = ("ttft_p99_s", "tpot_p99_s", "queue_wait_p99_s")
    FIELDS = ("ttft_p99_s", "tpot_p99_s", "queue_wait_p99_s")

    def __init__(self, ttft_p99_s=None, tpot_p99_s=None,
                 queue_wait_p99_s=None):
        self.ttft_p99_s = None if ttft_p99_s is None \
            else float(ttft_p99_s)
        self.tpot_p99_s = None if tpot_p99_s is None \
            else float(tpot_p99_s)
        self.queue_wait_p99_s = None if queue_wait_p99_s is None \
            else float(queue_wait_p99_s)

    def enabled(self) -> bool:
        return any(getattr(self, f) is not None for f in self.FIELDS)

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    @classmethod
    def from_flag(cls, spec: Optional[str] = None) -> "SLOConfig":
        """Parse ``FLAGS_telemetry_slo`` (or an explicit spec):
        ``'ttft_p99_s=0.5,tpot_p99_s=0.05'`` — any subset of the
        fields; empty spec -> an all-None (disabled) config."""
        spec = flag("telemetry_slo") if spec is None else spec
        kw = {}
        for part in str(spec).replace(" ", "").split(","):
            if not part:
                continue
            key, _, val = part.partition("=")
            if key not in cls.FIELDS or not val:
                raise ValueError(
                    f"bad FLAGS_telemetry_slo entry {part!r} "
                    f"(expected <field>=<seconds> with field in "
                    f"{cls.FIELDS})")
            kw[key] = float(val)
        return cls(**kw)

    @staticmethod
    def p99(values) -> Optional[float]:
        """Nearest-rank p99 over one request's own samples (its
        inter-token gaps) — exact, matching the histogram method."""
        return _nearest_rank(sorted(values), 99)

    def request_meets(self, ttft, tpot_p99, queue_wait) -> dict:
        """Per-SLO verdicts for one retired request (only configured
        bounds appear; a missing measurement counts as met — e.g. a
        single-token request has no inter-token gap)."""
        out = {}
        if self.ttft_p99_s is not None:
            out["ttft"] = ttft is None or ttft <= self.ttft_p99_s
        if self.tpot_p99_s is not None:
            out["tpot"] = tpot_p99 is None \
                or tpot_p99 <= self.tpot_p99_s
        if self.queue_wait_p99_s is not None:
            out["queue_wait"] = queue_wait is None \
                or queue_wait <= self.queue_wait_p99_s
        return out


# ---------------------------------------------------------------------------
# per-request traces
# ---------------------------------------------------------------------------


class RequestTrace:
    """One request's lifecycle timeline: an ordered list of
    ``{"t": wall, "epoch": step, "kind": ..., **payload}`` events
    from ``submit`` through ``admit`` / ``prefill_chunk`` (token
    counts + prefix-hit tokens) / ``token`` / ``evict`` (preemption:
    KV swapped to host; NON-terminal — a later ``admit`` with
    ``swapped_in=True`` marks the resume) to the terminal ``retire``
    or ``abort`` (deadline expiry). ``lane`` is the stable integer
    track id the Chrome export renders the request under."""

    __slots__ = ("req_id", "lane", "events", "done")

    def __init__(self, req_id: str, lane: int):
        self.req_id = str(req_id)
        self.lane = int(lane)
        self.events: List[dict] = []
        self.done = False

    def event(self, kind: str, t: float, epoch: int,
              **payload) -> dict:
        ev = {"t": float(t), "epoch": int(epoch), "kind": str(kind)}
        ev.update(payload)
        self.events.append(ev)
        return ev

    def first(self, kind: str) -> Optional[dict]:
        for ev in self.events:
            if ev["kind"] == kind:
                return ev
        return None

    def kinds(self) -> List[str]:
        return [ev["kind"] for ev in self.events]

    def to_dict(self) -> dict:
        return {"type": "request", "req_id": self.req_id,
                "lane": self.lane, "done": self.done,
                "events": list(self.events)}


class RequestTraceBook:
    """Per-request trace accumulator keyed by request id. Active
    traces live until their terminal event; completed traces sit in
    a bounded LRU (``FLAGS_telemetry_request_traces``) so memory is
    fixed no matter how many requests retire. Unknown request ids
    are ignored on :meth:`event`/:meth:`complete` — a scheduler
    built before the book existed must not crash it."""

    def __init__(self, capacity: Optional[int] = None):
        cap = int(flag("telemetry_request_traces")) \
            if capacity is None else int(capacity)
        self.capacity = max(1, cap)
        self._lock = _concurrency.guarded("telemetry.tracebook")
        self._active: Dict[str, RequestTrace] = {}
        self._done = collections.OrderedDict()
        self._lane_seq = 0
        self.dropped = 0  # completed traces evicted by the LRU
        _csan = _concurrency.sanitizer()
        self._cv = None if _csan is None else _csan.shared(
            "telemetry.tracebook.traces", owner=self,
            guard="telemetry.tracebook")

    def begin(self, req_id: str, t: float, epoch: int,
              **payload) -> RequestTrace:
        # the submit event is appended UNDER the lock: begin() used
        # to drop the lock first, racing a scrape thread iterating
        # the trace's event list via traces()/to_jsonl_records()
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            tr = self._active.get(req_id)
            if tr is None:
                self._lane_seq += 1
                tr = RequestTrace(req_id, self._lane_seq)
                self._active[req_id] = tr
            tr.event("submit", t, epoch, **payload)
        return tr

    def event(self, req_id: str, kind: str, t: float, epoch: int,
              **payload) -> None:
        # mutates the trace's event list: same lock as the readers
        # (was an unlocked dict read + list append)
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            tr = self._active.get(req_id)
            if tr is not None:
                tr.event(kind, t, epoch, **payload)

    def complete(self, req_id: str, kind: str, t: float, epoch: int,
                 **payload) -> None:
        """Record the terminal event (``retire``, or ``abort`` for a
        deadline expiry — preemption's ``evict`` is NOT terminal and
        goes through :meth:`event`) and move the trace to the LRU."""
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            tr = self._active.pop(req_id, None)
            if tr is None:
                return
            tr.event(kind, t, epoch, **payload)
            tr.done = True
            self._done[req_id] = tr
            while len(self._done) > self.capacity:
                self._done.popitem(last=False)
                self.dropped += 1

    # -- readout -----------------------------------------------------------
    def get(self, req_id: str) -> Optional[RequestTrace]:
        with self._lock:
            if self._cv is not None:
                self._cv.read()
            return self._active.get(req_id) or self._done.get(req_id)

    def traces(self) -> List[RequestTrace]:
        with self._lock:
            if self._cv is not None:
                self._cv.read()
            return list(self._active.values()) + list(
                self._done.values())

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def completed_count(self) -> int:
        return len(self._done)

    def clear(self) -> None:
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            self._active.clear()
            self._done.clear()
            self.dropped = 0

    def summary(self) -> dict:
        return {"active": self.active_count,
                "completed": self.completed_count,
                "dropped": self.dropped,
                "capacity": self.capacity}

    def to_jsonl_records(self) -> List[dict]:
        return [tr.to_dict() for tr in self.traces()]

    def chrome_events(self, base: float, pid: int) -> List[dict]:
        """Per-request LANES for the Chrome export: each request is
        one track (tid = its lane, named via thread_name metadata),
        carrying phase spans derived from the lifecycle timestamps —
        ``queued`` (submit -> admit), ``prefill`` (admit -> first
        token), ``decode`` (first token -> retire) — plus an instant
        event per recorded chunk/token and per preemption
        ``evict``/``abort`` marker."""
        return _request_lane_events(
            self.to_jsonl_records(), base, pid)

    def min_ts(self) -> Optional[float]:
        ts = [tr.events[0]["t"] for tr in self.traces() if tr.events]
        return min(ts) if ts else None


_LANE_TID_BASE = 1 << 20  # keep request lanes clear of thread ids


def _request_lane_events(records, base, pid) -> List[dict]:
    """Chrome lane events from dumped request records (shared by the
    live book and JSONL post-processing). One metadata thread_name
    event names the lane after the request id; lifecycle phases
    become "X" spans, chunk/token events become instants."""
    out = []
    phases = (("submit", "queued"), ("admit", "prefill"),
              ("first_token", "decode"))
    for rec in records:
        events = rec.get("events") or []
        if not events:
            continue
        tid = _LANE_TID_BASE + int(rec.get("lane", 0))
        rid = rec.get("req_id", "?")
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": f"req {rid}"}})
        marks = {}
        for ev in events:
            k = ev["kind"]
            if k == "token" and "first_token" not in marks:
                marks["first_token"] = ev["t"]
            marks.setdefault(k, ev["t"])
        end = events[-1]["t"]
        bounds = [marks.get(k) for k, _ in phases] + [end]
        for i, (key, phase) in enumerate(phases):
            t0 = bounds[i]
            if t0 is None:
                continue
            t1 = next((b for b in bounds[i + 1:] if b is not None),
                      t0)
            out.append(_chrome_event(
                phase, "request", tid, t0, max(t1 - t0, 0.0),
                {"req_id": rid}, base, pid))
        for ev in events:
            if ev["kind"] not in ("prefill_chunk", "token", "evict",
                                  "abort"):
                continue
            args = {k: v for k, v in ev.items()
                    if k not in ("t", "kind")}
            out.append({
                "name": ev["kind"], "cat": "request", "ph": "i",
                "s": "t", "pid": pid, "tid": tid,
                "ts": round((ev["t"] - base) * 1e6, 3),
                "args": args,
            })
    return out


# ---------------------------------------------------------------------------
# trace context — async- and cross-worker-safe trace identity
# ---------------------------------------------------------------------------

# process-unique id sequences (no wall clock, no randomness: ids are
# deterministic within a process and namespaced by pid across a fleet)
_TRACE_SEQ = itertools.count(1)
_SPAN_SEQ = itertools.count(1)


def _new_trace_id() -> str:
    return "%x-%x" % (os.getpid(), next(_TRACE_SEQ))


class TraceContext:
    """Serializable trace identity for ONE request: the trace id
    every span and request-trace event of that request stamps, the
    root span id children parent to, plus the tenant and deadline
    that must survive a cross-worker hop.

    This is the Dapper-style propagation contract of the ops plane:
    the scheduler creates one context at ``submit`` (or adopts one a
    front-end injected), request-scoped spans record under it
    (:func:`use_trace_context` / :func:`span_in`), the KV pool pins
    it to the sequence's page chains (``set_trace_context``) so a
    swap record or a COW chain handoff carries it, and a future
    prefill/decode worker split re-extracts it on the receiving side
    — one request, ONE stitched trace, no matter how many hosts or
    asyncio tasks touched it.

    Wire format (:meth:`to_wire`/:meth:`from_wire`) is a compact JSON
    object; :meth:`inject`/:meth:`extract` move it through a dict
    carrier (HTTP headers, a swap-record sidecar, an RPC metadata
    map) under :data:`WIRE_KEY`."""

    __slots__ = ("trace_id", "span_id", "tenant", "deadline_s")
    WIRE_KEY = "x-paddle-trace"

    def __init__(self, trace_id: Optional[str] = None,
                 span_id: Optional[int] = None,
                 tenant: str = "default",
                 deadline_s: Optional[float] = None):
        self.trace_id = str(trace_id) if trace_id else _new_trace_id()
        self.span_id = int(span_id) if span_id is not None \
            else next(_SPAN_SEQ)
        self.tenant = str(tenant)
        self.deadline_s = None if deadline_s is None \
            else float(deadline_s)

    def child(self, span_id: int) -> "TraceContext":
        """The context a child scope propagates onward: same trace,
        ``span_id`` becomes the new parent link."""
        return TraceContext(self.trace_id, span_id, self.tenant,
                            self.deadline_s)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "tenant": self.tenant, "deadline_s": self.deadline_s}

    def to_wire(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_wire(cls, wire: str) -> "TraceContext":
        d = json.loads(wire)
        if not isinstance(d, dict) or "trace_id" not in d:
            raise ValueError(
                "not a TraceContext wire payload: %r" % (wire,))
        return cls(trace_id=d["trace_id"],
                   span_id=d.get("span_id", 0),
                   tenant=d.get("tenant", "default"),
                   deadline_s=d.get("deadline_s"))

    def inject(self, carrier: dict) -> dict:
        """Write the wire form into a dict carrier (headers/metadata)
        under :data:`WIRE_KEY`; returns the carrier."""
        carrier[self.WIRE_KEY] = self.to_wire()
        return carrier

    @classmethod
    def extract(cls, carrier) -> Optional["TraceContext"]:
        """Read a context back out of a dict carrier; None when the
        carrier holds none (the caller then starts a fresh trace)."""
        wire = (carrier or {}).get(cls.WIRE_KEY)
        return None if wire is None else cls.from_wire(wire)

    def __repr__(self):
        return ("TraceContext(trace_id=%r, span_id=%d, tenant=%r, "
                "deadline_s=%r)" % (self.trace_id, self.span_id,
                                    self.tenant, self.deadline_s))

    def __eq__(self, other):
        return isinstance(other, TraceContext) and \
            self.to_dict() == other.to_dict()


# the ambient trace context: a ContextVar, so it follows asyncio tasks
# (each task branches its own copy) and threads (each thread starts
# empty) — exactly the propagation threading.local() could not give
# the future async step pump
_TRACE_CTX: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("paddle_tpu_torch_trace_ctx", default=None)


def current_trace_context() -> Optional[TraceContext]:
    """The ambient :class:`TraceContext` of the calling task/thread
    (None outside any :func:`use_trace_context` scope)."""
    return _TRACE_CTX.get()


class use_trace_context:
    """``with use_trace_context(ctx): ...`` — every span opened (and
    every ``add_complete`` recorded) inside the scope stamps ``ctx``'s
    trace id and parents to its span id. Reentrant; exiting restores
    the previous ambient context, tolerating an exit on a different
    thread than the enter (the executor-handoff case)."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._token = None

    def __enter__(self) -> Optional[TraceContext]:
        self._token = _TRACE_CTX.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        try:
            _TRACE_CTX.reset(self._token)
        except ValueError:
            # exited in a different context than it entered (an
            # executor hop): clear rather than corrupt the hopping
            # thread's ambient state
            _TRACE_CTX.set(None)
        return False


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


class Span:
    """One finished (or in-flight) wall span. ``path`` is the
    slash-joined ancestor chain captured at begin ("serving.step/"
    "serving.admit"), which keeps the tree reconstructible after
    ring rollover drops parents.

    Trace identity (``span_id``/``parent_id``/``trace_id``) is
    stamped at ``__enter__``: the parent is the enclosing open span,
    or — when an explicit :class:`TraceContext` is ambient — that
    context's root span, which is what stitches one request's spans
    across steps, threads, asyncio tasks, and (via the serialized
    context) workers. ``tid`` is ALSO stamped at enter: the thread
    actually doing the work owns the span, even when an executor
    handoff closes it somewhere else (the historical
    ``threading.get_ident()``-at-construction stamp silently
    mis-attributed exactly that case)."""

    __slots__ = ("name", "cat", "t0", "dur", "tid", "depth", "path",
                 "attrs", "span_id", "parent_id", "trace_id")

    def __init__(self, name, cat="app", attrs=None):
        self.name = str(name)
        self.cat = cat
        self.attrs = attrs or {}
        self.t0 = 0.0
        self.dur = 0.0
        self.tid = threading.get_ident()
        self.depth = 0
        self.path = self.name
        self.span_id = 0
        self.parent_id: Optional[int] = None
        self.trace_id: Optional[str] = None

    def _stamp_identity(self, parent: Optional["Span"]) -> None:
        """Assign the span id and the trace linkage: the enclosing
        open span wins for BOTH when no explicit context is ambient;
        an ambient TraceContext pins the trace id and (when the
        enclosing span belongs to a different trace, or there is
        none) the parent link to its root span."""
        self.span_id = next(_SPAN_SEQ)
        ctx = _TRACE_CTX.get()
        if ctx is not None:
            self.trace_id = ctx.trace_id
            if parent is not None and parent.trace_id == ctx.trace_id:
                self.parent_id = parent.span_id
            else:
                self.parent_id = ctx.span_id or None
        elif parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id

    def to_dict(self) -> dict:
        d = {"type": "span", "name": self.name, "cat": self.cat,
             "ts": self.t0, "dur": self.dur, "tid": self.tid,
             "depth": self.depth, "path": self.path,
             "args": dict(self.attrs)}
        if self.span_id:
            d["id"] = self.span_id
        if self.parent_id is not None:
            d["parent"] = self.parent_id
        if self.trace_id is not None:
            d["trace"] = self.trace_id
        return d


class _NullSpan:
    """Reentrant, stateless no-op context manager — module singleton
    (:data:`NULL_SPAN`) so an off-mode call site enters a span-shaped
    ``with`` without allocating anything."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def _chrome_event(name, cat, tid, ts, dur, args, base, pid):
    """One Chrome "traceEvents" complete event (µs, rebased to the
    stream's earliest timestamp) — the single place the event shape
    lives, shared by live exports (Tracer.to_chrome) and JSONL
    post-processing (chrome_from_jsonl)."""
    return {
        "name": name, "cat": cat, "ph": "X", "pid": pid, "tid": tid,
        "ts": round((ts - base) * 1e6, 3),
        "dur": round(dur * 1e6, 3), "args": dict(args),
    }


def _chrome_doc(span_recs, request_recs) -> dict:
    """The full Chrome-trace dict from span RECORDS (Span.to_dict
    shapes) plus request-trace records — the ONE render path behind
    Tracer.to_chrome, chrome_payload, and chrome_from_jsonl, so the
    event shape and the shared time origin can never diverge between
    the live exports and JSONL post-processing. The origin is the
    earliest span start or request timestamp across BOTH streams
    (request lanes must line up against the spans in Perfetto)."""
    spans = sorted(span_recs, key=lambda s: s.get("ts", 0.0))
    bases = [s.get("ts", 0.0) for s in spans[:1]]
    bases += [r["events"][0]["t"] for r in request_recs
              if r.get("events")]
    base = min(bases) if bases else 0.0
    pid = os.getpid()
    events = []
    for s in spans:
        args = dict(s.get("args") or {})
        # trace identity rides the args so a stitched request reads
        # back out of the chrome/perfetto payload directly
        if s.get("trace") is not None:
            args["trace_id"] = s["trace"]
            if s.get("parent") is not None:
                args["parent_span"] = s["parent"]
            if s.get("id"):
                args["span_id"] = s["id"]
        events.append(_chrome_event(
            s.get("name", "?"), s.get("cat", "app"),
            s.get("tid", 0), s.get("ts", 0.0),
            s.get("dur", 0.0), args, base, pid))
    events.extend(_request_lane_events(request_recs, base, pid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class _SpanCtx:
    __slots__ = ("_tr", "_span")

    def __init__(self, tr, span):
        self._tr = tr
        self._span = span

    def __enter__(self) -> Span:
        s = self._span
        var = self._tr._stack_var
        stack = var.get()
        # the thread DOING the work owns the span — an executor
        # handoff that closes it elsewhere must not re-attribute it
        s.tid = threading.get_ident()
        s.depth = len(stack)
        parent = stack[-1] if stack else None
        if parent is not None:
            s.path = parent.path + "/" + s.name
        s._stamp_identity(parent)
        var.set(stack + (s,))
        s.t0 = clock()
        return s

    def __exit__(self, *exc):
        s = self._span
        s.dur = clock() - s.t0
        var = self._tr._stack_var
        stack = var.get()
        if stack and stack[-1] is s:
            var.set(stack[:-1])
        elif s in stack:  # mis-nested exit: drop up to and incl. s
            var.set(stack[:stack.index(s)])
        # else: closed in a different context/thread than it opened
        # in (executor handoff) — the stacks are immutable per-context
        # snapshots, so there is nothing to repair HERE; the opening
        # context prunes the stale entry via the mis-nest branch
        # above, exactly like the old per-thread model did
        self._tr._commit(s)
        return False


class Tracer:
    """Bounded ring of finished spans + a per-CONTEXT open-span stack
    for nesting. ``span()`` is the context-manager entry point;
    ``add_complete()`` records an externally timed range.

    The open-span stack lives in a :mod:`contextvars` ContextVar as
    an immutable tuple: every thread still gets its own stack (each
    thread starts from an empty context — the old ``threading.local``
    behavior, preserved), and every asyncio task additionally gets a
    copy-on-write branch of its parent's stack, so two tasks
    interleaving awaits on ONE loop thread can no longer corrupt each
    other's nesting (the failure mode an asynchronous scheduler
    would hit)."""

    def __init__(self, ring: Optional[int] = None):
        cap = int(flag("telemetry_ring")) if ring is None \
            else int(ring)
        self._ring = collections.deque(maxlen=max(16, cap))
        # async-safe nesting state: an immutable tuple per context
        # (tracers are process singletons, so the per-instance
        # ContextVar does not churn)
        self._stack_var: "contextvars.ContextVar[tuple]" = \
            contextvars.ContextVar("paddle_tpu_torch_span_stack",
                                   default=())
        # serializes commits against ring reads: exporting from one
        # thread while another finishes a span must not hit "deque
        # mutated during iteration"
        self._lock = _concurrency.guarded("telemetry.tracer")
        self.dropped = 0  # spans evicted by ring rollover
        _csan = _concurrency.sanitizer()
        self._cv = None if _csan is None else _csan.shared(
            "telemetry.tracer.ring", owner=self,
            guard="telemetry.tracer")

    def open_depth(self) -> int:
        """Open-span nesting depth of the CALLING context (test and
        debug surface for the contextvars stack)."""
        return len(self._stack_var.get())

    def _commit(self, span: Span) -> None:
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)

    def span(self, name: str, cat: str = "app", **attrs) -> _SpanCtx:
        """``with tracer.span("serving.admit", admitted=2): ...`` —
        nestable; attributes land in the Chrome export's ``args``."""
        return _SpanCtx(self, Span(name, cat, attrs))

    def add_complete(self, name, t0, dur, cat="event",
                     attrs=None) -> Span:
        """Record an already-timed range (t0 from :func:`clock`).
        Stamps the ambient trace context (if any), so bridged
        profiler ranges stitch into the surrounding trace too."""
        s = Span(name, cat, attrs)
        s.t0 = float(t0)
        s.dur = float(dur)
        stack = self._stack_var.get()
        s._stamp_identity(stack[-1] if stack else None)
        self._commit(s)
        return s

    # -- readout -----------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            if self._cv is not None:
                self._cv.read()
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            if self._cv is not None:
                self._cv.write()
            self._ring.clear()
            self.dropped = 0

    def to_chrome(self) -> dict:
        """Chrome trace JSON ("traceEvents" complete events, µs) —
        loadable in chrome://tracing and Perfetto. Valid regardless
        of rollover: "X" events carry their own duration and need no
        parent."""
        return _chrome_doc([s.to_dict() for s in self.spans()], [])

    def dump_jsonl(self, path: str, registry=None, traces=None,
                   watchdog=None) -> str:
        """Write the ring as JSONL span records plus, when given, the
        per-request trace records (``{"type": "request"}``), the
        watchdog event log (``{"type": "watchdog_event"}``), and one
        trailing ``{"type": "metrics"}`` registry snapshot — the
        stream the module CLI summarizes."""
        with open(path, "w") as f:
            for s in sorted(self.spans(), key=lambda sp: sp.t0):
                f.write(json.dumps(s.to_dict(), default=str) + "\n")
            if traces is not None:
                for rec in traces.to_jsonl_records():
                    f.write(json.dumps(rec, default=str) + "\n")
            if watchdog is not None:
                for rec in watchdog.to_records():
                    f.write(json.dumps(rec, default=str) + "\n")
            if registry is not None:
                f.write(json.dumps(
                    {"type": "metrics", "data": registry.snapshot()},
                    default=str) + "\n")
        return path


class _CtxSpan:
    """A span recorded under an EXPLICIT TraceContext (the combined
    context manager :func:`span_in` returns): enters the context,
    then the span, and unwinds both."""

    __slots__ = ("_use", "_span")

    def __init__(self, tracer_obj, ctx, name, cat, attrs):
        self._use = use_trace_context(ctx)
        self._span = _SpanCtx(tracer_obj, Span(name, cat, attrs))

    def __enter__(self) -> Span:
        self._use.__enter__()
        return self._span.__enter__()

    def __exit__(self, *exc):
        r = self._span.__exit__(*exc)
        self._use.__exit__(*exc)
        return r


def span_in(tracer_obj: "Tracer", ctx: Optional[TraceContext],
            name: str, cat: str = "app", **attrs) -> _CtxSpan:
    """``with span_in(tracer, req_ctx, "serving.preempt", ...):`` —
    a span stamped with ``ctx``'s trace id and parented to its root
    span, regardless of which thread/task/step it runs on. THE
    request-scoped span entry point of the serving scheduler."""
    return _CtxSpan(tracer_obj, ctx, name, cat, attrs)


# ---------------------------------------------------------------------------
# process-wide singletons (lazily built; nothing exists while off)
# ---------------------------------------------------------------------------

_REGISTRY: Optional[MetricsRegistry] = None  # guarded-by: telemetry.state
_TRACER: Optional[Tracer] = None  # guarded-by: telemetry.state
_TRACES: Optional[RequestTraceBook] = None  # guarded-by: telemetry.state
# explicit tracing windows (arm_tracer / disarm_tracer)
_ARMED = 0  # guarded-by: telemetry.state
# guards singleton creation and the arm counter: two threads building
# schedulers concurrently must cache the SAME registry, or the
# loser's metrics silently vanish from every snapshot
_STATE_LOCK = threading.Lock()


def registry() -> Optional[MetricsRegistry]:
    """The process-wide registry, or None when FLAGS_telemetry=off.
    Instrumented sites cache this at construction and guard with one
    ``is None`` check per event (the zero-cost-off contract)."""
    global _REGISTRY
    if not metrics_on():
        return None
    if _REGISTRY is None:
        with _STATE_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


def tracer() -> Optional[Tracer]:
    """The process-wide tracer — present in trace mode or while a
    legacy profiler RECORD window is armed; None otherwise."""
    global _TRACER
    if not tracing_on():
        return None
    if _TRACER is None:
        with _STATE_LOCK:
            if _TRACER is None:
                _TRACER = Tracer()
    return _TRACER


def request_traces() -> Optional[RequestTraceBook]:
    """The process-wide per-request trace book — present in trace
    mode (or while a profiler window is armed), None otherwise.
    Cached by the scheduler at construction, same zero-cost-off
    contract as :func:`registry`/:func:`tracer`."""
    global _TRACES
    if not tracing_on():
        return None
    if _TRACES is None:
        with _STATE_LOCK:
            if _TRACES is None:
                _TRACES = RequestTraceBook()
    return _TRACES


def arm_tracer() -> Tracer:
    """Force-enable span collection regardless of FLAGS_telemetry, so
    an explicit tracing window always collects (and only such windows
    do, when the flag is off). Balanced by :func:`disarm_tracer`."""
    global _ARMED
    with _STATE_LOCK:
        _ARMED += 1
    return tracer()


def disarm_tracer() -> None:
    global _ARMED
    with _STATE_LOCK:
        _ARMED = max(0, _ARMED - 1)


def reset() -> None:
    """Drop the process-wide registry, tracer, and request-trace book
    (bench/test arm isolation). Handles cached by live
    schedulers/pools keep working against the detached objects. The
    performance ledger rides along: its singleton wraps the registry
    being dropped, so the two must never skew."""
    global _REGISTRY, _TRACER, _TRACES, _ARMED
    with _STATE_LOCK:
        _REGISTRY = None
        _TRACER = None
        _TRACES = None
        _ARMED = 0
    from . import perf_ledger

    perf_ledger.reset()


def chrome_payload(tracer_obj: Optional[Tracer] = None,
                   traces: Optional[RequestTraceBook] = None
                   ) -> Optional[dict]:
    """The unified Chrome-trace dict: the span ring PLUS one lane per
    request from the trace book (tid = lane id, named "req <id>" via
    thread_name metadata). Either side may be absent; None when
    neither ever existed."""
    tr = tracer_obj if tracer_obj is not None else _TRACER
    book = traces if traces is not None else _TRACES
    if tr is None and book is None:
        return None
    return _chrome_doc(
        [s.to_dict() for s in tr.spans()] if tr is not None else [],
        book.to_jsonl_records() if book is not None else [])


def export_chrome(path: str, tracer_obj: Optional[Tracer] = None,
                  traces: Optional[RequestTraceBook] = None):
    """Write the unified Chrome-trace JSON (span ring + per-request
    lanes when a trace book exists) to ``path``; returns the path, or
    None when neither a tracer nor a book ever existed. Reads the
    module singletons directly (not :func:`tracer`) so a just-closed
    profiler window can still export its spans."""
    payload = chrome_payload(tracer_obj, traces)
    if payload is None:
        return None
    with open(path, "w") as f:
        json.dump(payload, f, default=str)
    return path


# ---------------------------------------------------------------------------
# metric/span inventory
# ---------------------------------------------------------------------------

SURFACE: Tuple[Tuple[str, str, str], ...] = (
    # serving (inference/serving.py — BatchScheduler.metrics())
    ("serving.ttft_s", "histogram",
     "request submit -> first generated token (time-to-first-token)"),
    ("serving.tpot_s", "histogram",
     "interval between consecutive generated tokens (per request)"),
    ("serving.queue_wait_s", "histogram",
     "request submit -> admission into the active batch"),
    ("serving.retire_s", "histogram",
     "retire latency: prefix insert + page free per finished request"),
    ("serving.steps", "counter", "scheduler iterations"),
    ("serving.prefill_tokens", "counter",
     "prompt tokens advanced (chunked or token-per-step)"),
    ("serving.decode_tokens", "counter",
     "decode-ROW tokens advanced per step (a request's FIRST "
     "generated token commits on a prefill row and lands only in "
     "generated_tokens)"),
    ("serving.generated_tokens", "counter",
     "generated tokens committed (every TTFT/TPOT event; the "
     "throughput numerator)"),
    ("serving.prefix_hit_tokens", "counter",
     "prompt tokens served from the prefix cache at admission"),
    ("serving.requests_admitted", "counter", "requests admitted"),
    ("serving.requests_finished", "counter", "requests retired"),
    ("serving.step_wall_s", "histogram",
     "wall time of one scheduler step (epoch-stamped; the decode-"
     "stall watchdog windows over it)"),
    ("serving.step_epoch", "gauge",
     "current scheduler step epoch (the window key of every "
     "windowed view)"),
    ("serving.uptime_s", "gauge",
     "wall seconds since scheduler construction"),
    ("serving.steps_per_s", "gauge", "steps / uptime"),
    ("serving.active_requests", "gauge", "requests mid-generation"),
    ("serving.queued_requests", "gauge", "requests awaiting admission"),
    ("serving.retired_requests", "gauge", "requests finished so far"),
    ("serving.compile_count", "gauge",
     "the model's distinct compiled ragged programs "
     "(adapter.compile_count; the recompile-storm watchdog's "
     "serving-side signal). Shared across schedulers and therefore "
     "LAST-WRITER-WINS — kept as an alias; per-scheduler truth lives "
     "in serving.compile_count.<scheduler>"),
    ("serving.compile_count.<scheduler>", "gauge",
     "per-scheduler compiled ragged program count, namespaced by the "
     "scheduler's uid (s1, s2, ...) so two live schedulers never "
     "overwrite each other's counts"),
    ("serving.attend_programs", "gauge",
     "distinct paged-attention kernel programs the packed step has "
     "compiled (adapter.attend_program_count): ONE per packed config "
     "under FLAGS_ragged_attention=auto|on, a decode/prefill pair "
     "per mixed config under off. Shared alias, last-writer-wins"),
    ("serving.attend_programs.<scheduler>", "gauge",
     "per-scheduler attend kernel program count (uid-namespaced, "
     "same contract as serving.compile_count.<scheduler>)"),
    ("serving.admit_reject_pool", "counter",
     "admission refusals on page-pool capacity (head-of-queue "
     "blocked after any eviction attempt)"),
    ("serving.admit_reject_draft_pool", "counter",
     "admission refusals on the DRAFT adapter's pool capacity"),
    ("serving.admit_evict_then_admit", "counter",
     "admissions that succeeded only after evicting unpinned "
     "prefix-cache chains"),
    ("serving.goodput", "gauge",
     "fraction of requests retired in the trailing "
     "FLAGS_telemetry_window epochs meeting ALL configured SLOs "
     "(SLOConfig; the admission-control signal)"),
    ("serving.slo_attain_ttft", "gauge",
     "windowed fraction of retired requests meeting the TTFT SLO"),
    ("serving.slo_attain_tpot", "gauge",
     "windowed fraction meeting the per-request p99 TPOT SLO"),
    ("serving.slo_attain_queue_wait", "gauge",
     "windowed fraction meeting the queue-wait SLO"),
    ("serving.slo_window_requests", "gauge",
     "retired requests inside the SLO window right now"),
    # overload survival (docs/SERVING.md "Overload behavior")
    ("serving.admit_reject_queue_full", "counter",
     "submit() rejections on the bounded queue "
     "(FLAGS_serving_max_queue backpressure)"),
    ("serving.admit_preempt_then_admit", "counter",
     "admissions that succeeded only after preempting lower-"
     "priority victims to the host swap tier"),
    ("serving.aborted_deadline", "counter",
     "requests aborted at a step boundary because their deadline_s "
     "expired (the distinct terminal state; an SLO miss by "
     "definition)"),
    ("serving.preempt_victims", "counter",
     "sequences swapped out to the host tier (the preemption-"
     "thrash watchdog's signal)"),
    ("serving.preempt_pages", "counter",
     "device pages released by preemption swap-outs"),
    ("serving.preempt_swap_full", "counter",
     "preemption attempts declined because the host swap space "
     "could not hold the victim (FLAGS_serving_swap_bytes)"),
    ("serving.swap_out_bytes", "counter",
     "bytes copied to the host swap tier at preemption"),
    ("serving.swap_in_requests", "counter",
     "swapped-out sequences restored and re-admitted"),
    ("serving.swap_in_pages", "counter",
     "device pages redrawn and bitwise-restored at swap-in"),
    ("serving.swapped_requests", "gauge",
     "sequences currently paged out to the host tier"),
    ("serving.swap_used_bytes", "gauge",
     "host swap-space bytes in use right now"),
    ("serving.step_retries", "counter",
     "step attempts abandoned by an injected fail_step fault"),
    # unified speculative decoding (FLAGS_spec_decode)
    ("serving.spec_accept_rate", "histogram",
     "per-row draft acceptance per verify round: accepted draft "
     "tokens / draft_k (both spec lowerings observe it through the "
     "shared commit helper)"),
    ("serving.spec_rounds", "counter",
     "draft-propose / target-verify rounds executed (one per step "
     "with any spec-active decode row)"),
    ("serving.spec_committed_tokens", "counter",
     "tokens committed by speculative verify rounds (accepted draft "
     "prefix + the target's bonus token)"),
    ("serving.spec_rollback_tokens", "counter",
     "window tokens rolled back by cache.truncate after a verify "
     "round (draft_k+1 minus committed, per non-retiring row)"),
    ("serving.step_backoff_steps", "counter",
     "no-op steps spent in post-failure exponential backoff"),
    # KV page pool (incubate/nn/paged_cache.py)
    ("pool.cow_forks", "counter",
     "copy-on-write page forks (summed across layer pools)"),
    ("pool.page_allocs", "counter", "pages drawn from the free list"),
    ("pool.page_frees", "counter",
     "pages returned to the free list (last reference dropped)"),
    ("pool.total_pages", "gauge", "pool capacity (all layer caches)"),
    ("pool.free_pages", "gauge", "free pages right now"),
    ("pool.utilization", "gauge", "1 - free/total"),
    ("pool.shared_pages", "gauge", "pages with refcount > 1"),
    ("pool.used_bytes", "gauge", "HBM bytes of in-use pages"),
    ("pool.peak_utilization", "gauge",
     "high watermark: max fraction of pages ever simultaneously in "
     "use (peak_used_pages summed across layer pools)"),
    ("pool.swap_out_pages", "counter",
     "pages released to the free list by host-tier swap-outs"),
    ("pool.swap_in_pages", "counter",
     "pages redrawn and bitwise-restored by host-tier swap-ins"),
    # prefix cache (inference/prefix_cache.py)
    ("prefix.hits", "counter", "prompt lookups that matched"),
    ("prefix.misses", "counter", "prompt lookups that missed"),
    ("prefix.hit_tokens", "counter", "tokens covered by matches"),
    ("prefix.lookup_tokens", "counter", "tokens looked up"),
    ("prefix.inserted_tokens", "counter", "tokens inserted at retire"),
    ("prefix.inserted_nodes", "counter", "radix nodes created"),
    ("prefix.evicted_pages", "counter", "pages reclaimed by eviction"),
    ("prefix.evicted_nodes", "counter", "radix leaves evicted"),
    ("prefix.cached_tokens", "gauge", "tokens reachable in the tree"),
    ("prefix.cached_pages", "gauge",
     "tree-held page references (summed across layers)"),
    ("prefix.nodes", "gauge", "radix nodes in the tree"),
    ("prefix.hit_frac", "histogram",
     "per-lookup hit fraction (matched/looked-up tokens, epoch-"
     "stamped — the prefix-collapse watchdog windows over it)"),
    # compile path (jit/api.py)
    ("compile.count", "counter",
     "to_static trace/lower events (recompile-storm visibility)"),
    ("compile.wall_s", "histogram",
     "wall time per to_static trace+lower (lint included)"),
    ("compile.by_program.<name>", "counter",
     "to_static trace/lower events per program (storm attribution)"),
    ("compile.hbm_peak_bytes", "histogram",
     "planned peak live HBM per compiled program (static resource "
     "planner, framework/planner.py; FLAGS_jit_plan)"),
    ("compile.comm_bytes.<axis>", "counter",
     "planned per-device collective wire bytes per mesh axis, summed "
     "over compiled programs (static resource planner)"),
    # execution stamps + performance ledger (framework/perf_ledger.py)
    ("exec.wall_s.<program>", "histogram",
     "per-invocation wall of a compiled entry point (stamped by "
     "jit/api.py around every StaticFunction call) or of the "
     "scheduler's ragged model calls (prefill_chunk/decode_token; "
     "inference/serving.py) — the measured half of the performance "
     "ledger's plan-vs-actual join"),
    ("exec.count.<program>", "counter",
     "invocations of a compiled program (rides next to "
     "exec.wall_s.<program>)"),
    ("ledger.mfu.<program>", "gauge",
     "live model-flops utilization: planned flops over measured mean "
     "wall, against FLAGS_telemetry_peak_flops (performance ledger)"),
    ("ledger.attained_flops_per_s.<program>", "gauge",
     "planned per-invocation flops over measured mean wall"),
    ("ledger.hbm_bytes_per_s.<program>", "gauge",
     "achieved HBM traffic rate: the plan's per-invocation byte "
     "floor over measured mean wall"),
    ("ledger.wire_bytes_per_s.<program>", "gauge",
     "achieved collective wire rate: planned comm bytes over "
     "measured mean wall (the live check of quantized "
     "collectives)"),
    ("ledger.share_of_step_wall.<program>", "gauge",
     "the program's total measured wall as a fraction of the total "
     "serving step wall (exec-wall total when no scheduler ran)"),
    ("ledger.predicted_wall_s.<program>", "gauge",
     "the planner's roofline-predicted lower-bound wall per "
     "invocation (max of compute at peak flops and HBM at peak "
     "bandwidth)"),
    ("ledger.drift_ratio.<program>", "gauge",
     "predicted lower-bound wall over the SUSTAINED (windowed) "
     "measured wall — above FLAGS_telemetry_drift_ratio the plan "
     "claims more work than the wall can explain (the plan-drift "
     "watchdog's signal)"),
    ("ledger.drift_samples.<program>", "gauge",
     "windowed exec.wall_s samples behind the drift ratio (the "
     "watchdog's min-samples guard reads it)"),
    ("ledger.drifting.<program>", "gauge",
     "the recorded plan-drift VERDICT (0/1) at publish time, so a "
     "dumped snapshot replays the threshold in effect when it fired"),
    ("ledger.wire_bytes_quantized_per_s.<program>", "gauge",
     "achieved QUANTIZED collective wire rate: the plan's "
     "comm_bytes_quantized (the quantized-bytes plan field) over "
     "measured mean wall — the Prometheus-visible live check of the "
     "quantize-on-the-wire savings"),
    ("ledger.programs", "gauge",
     "programs currently in the ledger report"),
    # sanitizer mirror (published by the scheduler's watchdog stride)
    ("sanitizer.events", "gauge",
     "page-sanitizer events recorded (summed across pools)"),
    ("sanitizer.violations", "gauge",
     "page-sanitizer violations recorded (the sanitizer-spike "
     "watchdog's signal)"),
    # collective-matmul dispatch (ops/kernels/collective_matmul.py)
    ("collective.decomposed.<kind>", "counter",
     "ring decompositions taken, by dispatch kind "
     "(ag_mm/mm_rs/mm_ar/mm_ag, dp_ar for the DP grad-sync ring, "
     "moe_a2a for the expert all-to-all overlap)"),
    ("collective.declined.<reason>", "counter",
     "dispatch declines, by reason (off/degree/indivisible/"
     "below_threshold/shape/no_mesh/legacy_multi_axis)"),
    ("collective.ring_chunks", "counter",
     "total ring hops dispatched (overlap coverage)"),
    ("collective.quantized.<kind>", "counter",
     "quantize-on-the-wire rings taken, by dispatch kind "
     "(FLAGS_collective_dtype; recorded at the same dispatch "
     "decision points as collective.decomposed.<kind>)"),
    ("collective.wire_bytes_quantized", "counter",
     "bytes quantized rings actually ship per dispatch decision "
     "(int8/fp8 payload + f32 scale sidecars — the planner-exact "
     "chunk accounting of wire_chunk_bytes)"),
    ("collective.wire_bytes_saved", "counter",
     "fp wire bytes avoided by quantize-on-the-wire (fp payload "
     "minus quantized payload+sidecars; the live side of the "
     "planner's wire-savings assertion)"),
    # async serving engine (inference/engine.py)
    ("engine.backpressure_state", "gauge",
     "ServingEngine admission-gate level: 0 open, 1 shed "
     "(rejecting below FLAGS_engine_shed_keep_priority), 2 clamp "
     "(rejecting all) — driven by live goodput + watchdog signals "
     "with streak hysteresis"),
    ("engine.inflight_streams", "gauge",
     "TokenStreams currently open on the engine (submitted and not "
     "yet retired/cancelled)"),
    ("engine.shed_total", "counter",
     "submissions rejected by the backpressure gate "
     "(EngineOverloadError; shed + clamp states combined)"),
    ("engine.submitted", "counter",
     "requests admitted through the engine into the scheduler"),
    ("engine.cancelled", "counter",
     "engine-side cancellations (explicit stream.cancel() or "
     "consumer disconnect) that reached the scheduler"),
    ("engine.step_lag_s", "histogram",
     "pump scheduling lag: host seconds between the end of one "
     "scheduler.step() and the start of the next while work was "
     "pending — the engine's 'no stall longer than one step wall' "
     "acceptance signal"),
    ("engine.adopted", "counter",
     "handed-off requests adopted from prefill workers "
     "(ServingEngine.adopt; registered swapped-out, restored on "
     "the next step's swap-in path)"),
    # capacity autotuner (framework/autotuner.py)
    ("autotune.state", "gauge",
     "capacity-autotuner controller state: 0 seeded (static table "
     "built), 1 measuring (frontier head deployed), 2 probing "
     "(challenger under live evaluation), 3 converged"),
    ("autotune.frontier", "gauge",
     "statically feasible, non-quarantined candidates remaining on "
     "the autotuner's frontier"),
    ("autotune.best_score", "gauge",
     "score of the current winner (live median when measured, else "
     "its planner-seeded static score; lower is better)"),
    ("autotune.applies", "counter",
     "capacity configs applied through the autotuner.apply_config "
     "seam (flag writes + step-boundary scheduler applies)"),
    ("autotune.windows", "counter",
     "live goodput windows with signal consumed by "
     "Autotuner.observe (no-signal windows are skipped, not "
     "counted)"),
    ("autotune.quarantines", "counter",
     "candidates quarantined on watchdog trips (recompile-storm / "
     "plan-drift are hard negative signal) or via the /tunez "
     "escape hatch"),
    # disaggregated serving (inference/disagg.py + the page-chain
    # wire transfer in incubate/nn/paged_cache.py)
    ("serving.handoff_out_requests", "counter",
     "prefill-complete requests exported off this box "
     "(BatchScheduler.export_request; state -> migrated)"),
    ("serving.handoff_out_bytes", "counter",
     "wire payload bytes shipped by export_request (headers + "
     "bitwise KV + int8 scale sidecars, all mp shards)"),
    ("serving.handoff_in_requests", "counter",
     "handed-off requests adopted by this box's scheduler "
     "(adopt_swapped; decode resumes via the swap-in path)"),
    ("serving.handoff_in_bytes", "counter",
     "wire payload bytes received by adopt_swapped"),
    ("pool.transfer_out_records", "counter",
     "per-pool page-chain swap records serialized onto the wire "
     "by HostKVSwapSpace.export_seq"),
    ("pool.transfer_out_bytes", "counter",
     "per-pool host bytes serialized onto the wire by export_seq"),
    ("pool.transfer_in_records", "counter",
     "per-pool page-chain swap records restored from wire "
     "payloads by HostKVSwapSpace.import_seq"),
    ("pool.transfer_in_bytes", "counter",
     "per-pool host bytes restored from wire payloads by "
     "import_seq"),
    ("router.backpressure_state", "gauge",
     "fleet-wide max of the replica engines' admission-gate "
     "levels, republished by the SessionRouter (0 open, 1 shed, "
     "2 clamp; merges as max — the fleet is as backpressured as "
     "its worst worker)"),
    ("router.sessions", "gauge",
     "live routed sessions (decode legs not yet retired); merges "
     "as sum across a fleet of routers"),
    ("router.replicas", "gauge",
     "DP replicas behind this router; merges as sum"),
    ("router.submitted", "counter",
     "sessions routed through SessionRouter.submit"),
    ("router.cancelled", "counter",
     "session cancels forwarded to a replica engine that still "
     "knew the request"),
    # spans (trace mode)
    ("span:serving.step", "span", "one scheduler iteration"),
    ("span:serving.admit", "span", "admission pass of a step"),
    ("span:serving.prefill_chunk", "span",
     "the ragged model call (packed/pad_to/prefill/decode attrs)"),
    ("span:serving.decode", "span",
     "logits -> token commit (sampling + bookkeeping)"),
    ("span:serving.draft_propose", "span",
     "the DRAFT adapter's packed chunked calls of one unified-spec "
     "round: propose + prompt mirror + lag refill "
     "(rows/refill/draft_k attrs; exec.wall_s.draft_propose stamps "
     "the same wall for the ledger)"),
    ("span:serving.retire", "span", "one request's retirement"),
    ("span:serving.preempt", "span",
     "one victim's swap-out to the host tier (req/reason attrs)"),
    ("span:serving.swap_in", "span",
     "one sequence's bitwise restore from the host tier"),
    ("span:serving.handoff_out", "span",
     "one request's export off the box: swap-out + wire "
     "serialization (req/shards attrs)"),
    ("span:jit.compile", "span",
     "one to_static trace (program/variant/n_eqns/lint attrs)"),
)


# ---------------------------------------------------------------------------
# Prometheus text-format export
# ---------------------------------------------------------------------------


def _prom_name(raw: str) -> str:
    """Sanitize a dotted metric name into a Prometheus identifier."""
    s = "".join(ch if (ch.isalnum() or ch == "_") else "_"
                for ch in raw)
    return "_" + s if s[:1].isdigit() else s


def _prom_val(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(snapshot: Optional[dict] = None,
                    registry: Optional[MetricsRegistry] = None,
                    prefix: str = "paddle") -> str:
    """Render a registry snapshot in the Prometheus text exposition
    format: counters (ints) as ``counter``, gauges (floats) as
    ``gauge``, histograms as cumulative ``_bucket{le=...}`` series
    (log2 upper bounds; bound 0 holds the non-positive observations)
    plus ``_sum``/``_count`` and EXACT nearest-rank quantiles as a
    sibling ``_quantile{quantile=...}`` gauge series (labelled
    ``exactness="exact"`` while the reservoir has seen everything,
    ``"windowed-exact"`` after rollover). Non-numeric leaves are
    skipped. Jax-free by the module's host-only contract, so a
    scraper-facing sidecar can render a box's state without touching
    device runtime."""
    if snapshot is None:
        reg = registry if registry is not None else _REGISTRY
        if reg is None:
            return "# no telemetry registry (FLAGS_telemetry=off)\n"
        snapshot = reg.snapshot()
    lines = []
    for ns in sorted(snapshot):
        group = snapshot[ns]
        if not isinstance(group, dict):
            continue  # e.g. the "telemetry": "<mode>" marker
        for key in sorted(group):
            v = group[key]
            name = _prom_name(f"{prefix}_{ns}_{key}")
            if isinstance(v, dict) and "buckets" in v:
                lines.append(f"# TYPE {name} histogram")
                # OpenMetrics exemplars (Histogram.exemplars): the
                # trace id that landed in a bucket rides its bucket
                # line — the TTFT/TPOT -> trace link
                exemplars = {float(ub): (lab, val) for ub, lab, val
                             in (v.get("exemplars") or [])}
                cum = 0
                for ub, n in v.get("buckets") or []:
                    cum += int(n)
                    line = f'{name}_bucket{{le="{float(ub):g}"}} {cum}'
                    ex = exemplars.get(float(ub))
                    if ex is not None:
                        line += (f' # {{trace_id="{ex[0]}"}} '
                                 f'{_prom_val(ex[1])}')
                    lines.append(line)
                lines.append(f'{name}_bucket{{le="+Inf"}} '
                             f'{int(v.get("count") or 0)}')
                lines.append(f"{name}_sum {_prom_val(v.get('sum'))}")
                lines.append(f"{name}_count "
                             f"{int(v.get('count') or 0)}")
                exact = v.get("exactness") or (
                    "exact" if v.get("exact", True)
                    else "windowed-exact")
                for q, k in ((0.5, "p50"), (0.9, "p90"),
                             (0.99, "p99")):
                    if v.get(k) is not None:
                        lines.append(
                            f'{name}_quantile{{quantile="{q}",'
                            f'exactness="{exact}"}} '
                            f'{_prom_val(v[k])}')
            elif isinstance(v, bool):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {int(v)}")
            elif isinstance(v, int):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {v}")
            elif isinstance(v, float):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_prom_val(v)}")
            # anything else (strings, lists, nested summaries) is
            # not a scrapeable sample — skipped by design
    return "\n".join(lines) + "\n"


def atomic_write_text(path: str, text: str) -> str:
    """Write ``text`` to ``path`` atomically (tmp + rename): a
    concurrent reader never observes a torn file. The SINGLE write
    path of every telemetry artifact a live consumer may race — the
    periodic Prometheus snapshot and every incident-bundle member
    (the FlightRecorder writes through this helper only)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def write_prometheus(path: str,
                     registry: Optional[MetricsRegistry] = None,
                     snapshot: Optional[dict] = None,
                     prefix: str = "paddle") -> str:
    """Atomically (:func:`atomic_write_text`) write
    :func:`prometheus_text` to ``path`` — the
    FLAGS_telemetry_export_path periodic snapshot the scheduler
    refreshes every watchdog stride."""
    return atomic_write_text(
        path, prometheus_text(snapshot=snapshot, registry=registry,
                              prefix=prefix))


# ---------------------------------------------------------------------------
# fleet aggregation: merge N worker snapshots into one exposition
# ---------------------------------------------------------------------------

# gauge merge semantics for merge_snapshots: counters always SUM and
# histograms always merge their buckets; gauges must DECLARE how a
# fleet combines them. Pool sizes and populations add across workers
# (a mixed prefill/decode fleet's router.sessions is the total, not
# any one worker's); attainment fractions take the WORST worker (the
# conservative fleet signal an admission controller should gate on);
# backpressure states take the max EXPLICITLY — the fleet is as
# backpressured as its most backpressured worker, and a sum of enum
# levels would be meaningless; everything else — utilizations,
# watermarks, epochs, uptimes — takes the max by default.
_GAUGE_MERGE_SUM = frozenset({
    "pool.total_pages", "pool.free_pages", "pool.shared_pages",
    "pool.used_bytes",
    "serving.active_requests", "serving.queued_requests",
    "serving.retired_requests", "serving.swapped_requests",
    "serving.swap_used_bytes", "serving.slo_window_requests",
    "serving.steps_per_s",
    "sanitizer.events", "sanitizer.violations",
    "ledger.programs",
    "engine.inflight_streams",
    "router.sessions", "router.replicas",
})
_GAUGE_MERGE_MIN_PREFIXES = ("serving.goodput",
                             "serving.slo_attain_")
_GAUGE_MERGE_MAX = frozenset({
    "engine.backpressure_state",
    "router.backpressure_state",
})


def gauge_merge_kind(name: str) -> str:
    """'sum' | 'min' | 'max' — how :func:`merge_snapshots` combines
    the gauge ``name`` across workers (see the declaration tables
    above; 'max' is the default). Membership in the explicit
    ``_GAUGE_MERGE_MAX`` table distinguishes a DECLARED max (the
    backpressure enums) from the fallthrough default."""
    if name in _GAUGE_MERGE_SUM:
        return "sum"
    if name.startswith(_GAUGE_MERGE_MIN_PREFIXES):
        return "min"
    if name in _GAUGE_MERGE_MAX:
        return "max"
    return "max"


def _norm_snapshots(snapshots) -> "collections.OrderedDict":
    """Normalize a worker->snapshot mapping (or a plain sequence of
    snapshots, named w0..wN) into an ordered dict."""
    if isinstance(snapshots, dict):
        return collections.OrderedDict(
            (str(k), v) for k, v in snapshots.items())
    return collections.OrderedDict(
        ("w%d" % i, s) for i, s in enumerate(snapshots))


def _bucket_quantile(buckets, count, p, vmax):
    """Nearest-rank quantile ESTIMATE from merged bucket counts: the
    upper bound of the bucket the rank falls in, clamped to the
    merged max — therefore always bounded by the per-worker maxima
    (raw reservoirs do not cross the wire, only bucket counts do)."""
    if not count:
        return None
    rank = max(1, math.ceil(p / 100.0 * count))
    cum = 0
    for ub, n in buckets:
        cum += int(n)
        if cum >= rank:
            est = float(ub)
            return min(est, vmax) if vmax is not None else est
    return vmax


def _merge_hists(summaries) -> dict:
    """Merge histogram SUMMARY dicts: counts/sums add exactly,
    min/max combine, bucket counts add by upper bound, quantiles are
    re-estimated from the merged buckets (``exactness:
    "bucket-upper-bound"`` — the renderer labels them so)."""
    count = sum(int(s.get("count") or 0) for s in summaries)
    total = sum(float(s.get("sum") or 0.0) for s in summaries)
    mins = [s.get("min") for s in summaries if s.get("min") is not None]
    maxs = [s.get("max") for s in summaries if s.get("max") is not None]
    buckets: Dict[float, int] = {}
    for s in summaries:
        for ub, n in s.get("buckets") or []:
            buckets[float(ub)] = buckets.get(float(ub), 0) + int(n)
    merged_buckets = sorted(buckets.items())
    vmax = max(maxs) if maxs else None
    out = {
        "count": count,
        "sum": total,
        "min": min(mins) if mins else None,
        "max": vmax,
        "avg": (total / count) if count else None,
        "p50": _bucket_quantile(merged_buckets, count, 50, vmax),
        "p90": _bucket_quantile(merged_buckets, count, 90, vmax),
        "p99": _bucket_quantile(merged_buckets, count, 99, vmax),
        "exact": False,
        "exactness": "bucket-upper-bound",
        "buckets": merged_buckets,
        "workers": len(summaries),
    }
    ex = [e for s in summaries for e in (s.get("exemplars") or [])]
    if ex:
        # newest-wins per bucket is meaningless across workers; keep
        # one exemplar per bucket (first worker listed wins)
        seen = {}
        for ub, lab, val in ex:
            seen.setdefault(float(ub), [float(ub), lab, val])
        out["exemplars"] = [seen[k] for k in sorted(seen)]
    return out


def merge_snapshots(snapshots) -> dict:
    """Combine N registry snapshots (``MetricsRegistry.snapshot()``
    shapes, keyed by worker name — or a plain list, auto-named
    w0..wN) into ONE snapshot of the same shape: counters sum
    EXACTLY, histogram bucket counts / ``count`` / ``sum`` add
    exactly (quantiles become bucket-upper-bound estimates clamped
    to the merged max), gauges combine by their declared semantics
    (:func:`gauge_merge_kind`). Non-numeric leaves (mode markers,
    nested digests) are dropped — the merged snapshot is a pure
    metrics surface, renderable by :func:`prometheus_text` and by
    :func:`merged_prometheus_text` (which adds per-worker
    ``worker``-labelled series)."""
    snaps = _norm_snapshots(snapshots)
    merged: Dict[str, dict] = {}
    # union of (ns, key) across workers, with each leaf classified
    leaves: Dict[Tuple[str, str], list] = {}
    for snap in snaps.values():
        for ns, group in (snap or {}).items():
            if not isinstance(group, dict):
                continue
            for key, v in group.items():
                leaves.setdefault((ns, key), []).append(v)
    for (ns, key), vals in sorted(leaves.items()):
        hists = [v for v in vals
                 if isinstance(v, dict) and "buckets" in v]
        if hists:
            merged.setdefault(ns, {})[key] = _merge_hists(hists)
            continue
        nums = [v for v in vals
                if isinstance(v, (int, float))
                and not isinstance(v, bool)]
        if not nums:
            continue  # strings / digests / markers: not mergeable
        if all(isinstance(v, int) for v in nums):
            merged.setdefault(ns, {})[key] = sum(nums)  # counter
            continue
        kind = gauge_merge_kind(f"{ns}.{key}")
        fn = {"sum": sum, "min": min, "max": max}[kind]
        merged.setdefault(ns, {})[key] = float(fn(
            float(v) for v in nums))
    return merged


def merged_prometheus_text(snapshots, prefix: str = "paddle") -> str:
    """ONE Prometheus exposition for a fleet: the merged aggregate
    series (unlabelled — counter sums, merged histograms, semantic
    gauge merges) plus one ``worker``-labelled series per worker for
    every counter and gauge, and per-worker ``_count``/``_sum``
    series for every histogram. The aggregate numbers are EXACT sums
    of the per-worker series by construction (the acceptance gate of
    the fleet-aggregation CLI)."""
    snaps = _norm_snapshots(snapshots)
    merged = merge_snapshots(snaps)
    lines = []
    for ns in sorted(merged):
        group = merged[ns]
        for key in sorted(group):
            v = group[key]
            name = _prom_name(f"{prefix}_{ns}_{key}")

            def worker_vals():
                for w, snap in snaps.items():
                    wv = (snap or {}).get(ns, {}).get(key)
                    if wv is not None:
                        yield w, wv

            if isinstance(v, dict) and "buckets" in v:
                lines.append(f"# TYPE {name} histogram")
                exemplars = {float(ub): (lab, val) for ub, lab, val
                             in (v.get("exemplars") or [])}
                cum = 0
                for ub, n in v["buckets"]:
                    cum += int(n)
                    line = f'{name}_bucket{{le="{float(ub):g}"}} {cum}'
                    ex = exemplars.get(float(ub))
                    if ex is not None:
                        line += (f' # {{trace_id="{ex[0]}"}} '
                                 f'{_prom_val(ex[1])}')
                    lines.append(line)
                lines.append(f'{name}_bucket{{le="+Inf"}} '
                             f'{int(v["count"])}')
                lines.append(f"{name}_sum {_prom_val(v['sum'])}")
                lines.append(f"{name}_count {int(v['count'])}")
                for q, k in ((0.5, "p50"), (0.9, "p90"),
                             (0.99, "p99")):
                    if v.get(k) is not None:
                        lines.append(
                            f'{name}_quantile{{quantile="{q}",'
                            f'exactness="bucket-upper-bound"}} '
                            f'{_prom_val(v[k])}')
                for w, wv in worker_vals():
                    if isinstance(wv, dict) and "buckets" in wv:
                        lines.append(
                            f'{name}_count{{worker="{w}"}} '
                            f'{int(wv.get("count") or 0)}')
                        lines.append(
                            f'{name}_sum{{worker="{w}"}} '
                            f'{_prom_val(wv.get("sum"))}')
            elif isinstance(v, int):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {v}")
                for w, wv in worker_vals():
                    if isinstance(wv, int) \
                            and not isinstance(wv, bool):
                        lines.append(
                            f'{name}{{worker="{w}"}} {wv}')
            elif isinstance(v, float):
                lines.append(f"# TYPE {name} gauge")
                lines.append(
                    f'# HELP {name} merged: '
                    f'{gauge_merge_kind(f"{ns}.{key}")} over workers')
                lines.append(f"{name} {_prom_val(v)}")
                for w, wv in worker_vals():
                    if isinstance(wv, (int, float)) \
                            and not isinstance(wv, bool):
                        lines.append(
                            f'{name}{{worker="{w}"}} '
                            f'{_prom_val(float(wv))}')
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# JSONL post-processing + CLI
# ---------------------------------------------------------------------------


def _load_jsonl(path: str) -> dict:
    """Parse a telemetry JSONL dump into its record streams. A
    malformed FINAL line that is missing its newline terminator is
    tolerated (a killed process mid-write leaves exactly that) and
    reported via ``"truncated"``; malformed content anywhere else —
    including a garbage final line that IS newline-terminated —
    still raises."""
    out = {"spans": [], "metrics": None, "requests": [],
           "watchdog": [], "truncated": False}
    # streamed one line at a time (dumps can be tens of MB, never
    # buffered whole). A malformed line missing its newline
    # terminator can only be the file's LAST line — the torn
    # mid-write cut that is tolerated; a newline-terminated
    # malformed line is corruption and raises wherever it sits.
    with open(path) as f:
        for ln, raw in enumerate(f, 1):
            line = raw.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                if not raw.endswith("\n"):
                    out["truncated"] = True
                    continue
                raise ValueError(
                    f"{path}:{ln}: not a telemetry JSONL record "
                    f"({e})")
            kind = rec.get("type")
            if kind == "span":
                out["spans"].append(rec)
            elif kind == "metrics":
                out["metrics"] = rec.get("data") or {}
            elif kind == "request":
                out["requests"].append(rec)
            elif kind == "watchdog_event":
                out["watchdog"].append(rec)
    return out


def chrome_from_jsonl(path: str, out: str) -> str:
    """Convert a dumped JSONL stream into a Chrome-trace JSON file
    (span events plus one lane per dumped request record)."""
    loaded = _load_jsonl(path)
    with open(out, "w") as f:
        json.dump(_chrome_doc(loaded["spans"], loaded["requests"]),
                  f, default=str)
    return out


def _fmt_val(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def summarize_jsonl(path: str) -> str:
    """Aggregated span tree (count/total/avg/max, indented by nest
    depth), the per-request trace and watchdog-event digests, plus
    the metrics table from the snapshot record."""
    loaded = _load_jsonl(path)
    spans, metrics = loaded["spans"], loaded["metrics"]
    lines = []
    agg: Dict[str, list] = {}  # path -> [count, total, max]
    for s in spans:
        a = agg.setdefault(s.get("path", s.get("name", "?")),
                           [0, 0.0, 0.0])
        a[0] += 1
        a[1] += s.get("dur", 0.0)
        a[2] = max(a[2], s.get("dur", 0.0))
    lines.append(f"spans ({len(spans)} records, "
                 f"{len(agg)} distinct paths)")
    lines.append(f"{'span':<44}{'calls':>7}{'total_ms':>11}"
                 f"{'avg_ms':>9}{'max_ms':>9}")
    for p in sorted(agg):
        n, tot, mx = agg[p]
        depth = p.count("/")
        name = ("  " * depth) + p.rsplit("/", 1)[-1]
        lines.append(f"{name[:43]:<44}{n:>7}{tot * 1e3:>11.3f}"
                     f"{tot / n * 1e3:>9.3f}{mx * 1e3:>9.3f}")
    if metrics:
        lines.append("")
        lines.append("histograms")
        lines.append(f"{'metric':<28}{'count':>7}{'p50':>11}{'p90':>11}"
                     f"{'p99':>11}{'max':>11}")
        plain = []
        for ns in sorted(metrics):
            group = metrics[ns]
            if not isinstance(group, dict):
                plain.append((ns, group))
                continue
            for key in sorted(group):
                v = group[key]
                name = f"{ns}.{key}"
                if isinstance(v, dict) and "p50" in v:
                    lines.append(
                        f"{name[:27]:<28}{v.get('count', 0):>7}"
                        f"{_fmt_val(v.get('p50')):>11}"
                        f"{_fmt_val(v.get('p90')):>11}"
                        f"{_fmt_val(v.get('p99')):>11}"
                        f"{_fmt_val(v.get('max')):>11}")
                else:
                    plain.append((name, v))
        if plain:
            lines.append("")
            lines.append("counters / gauges")
            for name, v in plain:
                lines.append(f"{name[:43]:<44}{_fmt_val(v):>12}")
        # the performance-ledger digest (framework/perf_ledger.py):
        # top programs by total wall, with count/p50/p99/MFU and the
        # plan-drift verdict, reconstructed from the snapshot's
        # exec.* histograms + ledger.* gauges
        from . import perf_ledger

        ledger_rows = perf_ledger.rows_from_snapshot(metrics)
        if ledger_rows:
            lines.append("")
            lines.append(perf_ledger.format_rows(ledger_rows))
    if loaded["requests"]:
        lines.append("")
        lines.append(f"request traces ({len(loaded['requests'])})")
        lines.append(f"{'request':<20}{'events':>8}{'tokens':>8}"
                     f"{'wall_ms':>10}  terminal")
        for rec in loaded["requests"]:
            evs = rec.get("events") or []
            toks = sum(1 for e in evs if e.get("kind") == "token")
            wall = (evs[-1]["t"] - evs[0]["t"]) * 1e3 if evs else 0.0
            term = evs[-1]["kind"] if (
                evs and rec.get("done")) else "(active)"
            lines.append(
                f"{str(rec.get('req_id', '?'))[:19]:<20}"
                f"{len(evs):>8}{toks:>8}{wall:>10.3f}  {term}")
    if loaded["watchdog"]:
        lines.append("")
        lines.append(f"watchdog events ({len(loaded['watchdog'])})")
        for rec in loaded["watchdog"]:
            lines.append(
                f"  epoch {rec.get('epoch', '?'):>6}  "
                f"{rec.get('class', '?'):<18}"
                f"{json.dumps(rec.get('detail', {}), default=str)[:60]}")
    if loaded["truncated"]:
        lines.append("")
        lines.append("note: final JSONL line was truncated "
                     "(no newline terminator — the writing process "
                     "was likely killed mid-write); it was ignored")
    return "\n".join(lines)


def _load_snapshot_file(path: str) -> dict:
    """A registry snapshot from any of the artifact shapes the repo
    writes: a JSONL dump (its ``{"type": "metrics"}`` record), a
    ``TELEMETRY_LAST.json`` bench artifact (its ``"snapshot"``
    member), an incident bundle's ``metrics.json`` (a raw snapshot),
    or a bare snapshot dict."""
    if path.endswith(".jsonl"):
        snap = _load_jsonl(path)["metrics"]
        if snap is None:
            raise ValueError(
                f"{path} carries no metrics snapshot record")
        return snap
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: not a snapshot JSON object")
    if isinstance(data.get("snapshot"), dict):
        return data["snapshot"]
    if data.get("type") == "metrics":
        return data.get("data") or {}
    return data


def _aggregate_main(argv) -> int:
    """``python -m paddle_tpu_torch.framework.telemetry aggregate`` — the
    fleet-aggregation CLI: merge N per-worker snapshot files into one
    Prometheus exposition with ``worker`` labels
    (:func:`merged_prometheus_text`)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.framework.telemetry aggregate",
        description="Merge N worker registry snapshots (JSONL dumps, "
        "TELEMETRY_LAST.json artifacts, incident metrics.json, or "
        "bare snapshot JSON) into one Prometheus exposition with "
        "worker labels: counters sum exactly, histogram buckets "
        "merge, gauges combine by declared semantics.")
    ap.add_argument("files", nargs="*", metavar="SNAPSHOT",
                    help="snapshot files; worker names default to "
                    "the file basenames (use --worker to override)")
    ap.add_argument("--worker", action="append", default=[],
                    metavar="NAME=PATH",
                    help="explicit worker-name/file pair "
                    "(repeatable; combines with positional files, "
                    "which keep their basename-derived names)")
    ap.add_argument("-o", "--out", default=None,
                    help="write the merged exposition here "
                    "(atomic tmp+rename; default: stdout)")
    ap.add_argument("--merged-json", default=None, metavar="PATH",
                    help="additionally write the merged snapshot "
                    "(merge_snapshots dict) as JSON")
    args = ap.parse_args(argv)

    if not args.files and not args.worker:
        ap.error("pass snapshot files (positional) and/or "
                 "--worker NAME=PATH pairs")
    pairs = []
    for spec in args.worker:
        name, _, path = spec.partition("=")
        if not name or not path:
            ap.error(f"--worker expects NAME=PATH, got {spec!r}")
        pairs.append((name, path))
    for path in args.files:
        stem = os.path.splitext(os.path.basename(path))[0]
        name = stem
        i = 1
        while any(name == n for n, _ in pairs):
            i += 1
            name = f"{stem}#{i}"
        pairs.append((name, path))
    snaps = collections.OrderedDict(
        (name, _load_snapshot_file(path)) for name, path in pairs)
    text = merged_prometheus_text(snaps)
    if args.out:
        atomic_write_text(args.out, text)
        print(f"wrote {args.out} ({len(snaps)} worker(s))")
    else:
        print(text, end="")
    if args.merged_json:
        atomic_write_text(
            args.merged_json,
            json.dumps(merge_snapshots(snaps), indent=1,
                       default=str))
        print(f"wrote {args.merged_json}")
    return 0


def main(argv=None) -> int:
    import argparse
    import sys as _sys

    argv = list(_sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "aggregate":
        return _aggregate_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.framework.telemetry",
        description="Post-process a telemetry JSONL dump "
        "(Tracer.dump_jsonl): print an aggregated span tree + metric "
        "table, or convert to Chrome trace JSON. The `aggregate` "
        "subcommand merges N worker snapshots into one Prometheus "
        "exposition with worker labels (fleet aggregation).")
    ap.add_argument("--summarize", metavar="TRACE_JSONL", default=None,
                    help="print the span tree and histogram table")
    ap.add_argument("--export-chrome", metavar="TRACE_JSONL",
                    default=None,
                    help="convert the JSONL stream to Chrome trace "
                    "JSON (chrome://tracing / Perfetto)")
    ap.add_argument("--export-prom", metavar="TRACE_JSONL",
                    default=None,
                    help="render the dump's metrics snapshot in the "
                    "Prometheus text exposition format (stdout, or "
                    "--prom-out FILE)")
    ap.add_argument("--ledger", metavar="TRACE_JSONL", default=None,
                    help="print the performance-ledger table (top "
                    "programs by total wall: count, p50/p99 wall, "
                    "MFU, plan-drift) from the dump's metrics "
                    "snapshot (framework/perf_ledger.py)")
    ap.add_argument("--summarize-incident", metavar="BUNDLE_DIR",
                    default=None,
                    help="reconstruct an incident bundle written by "
                    "telemetry.FlightRecorder "
                    "(FLAGS_telemetry_incident_dir): watchdog "
                    "events, ledger top-N, registry digest")
    ap.add_argument("-o", "--out", default=None,
                    help="output path for --export-chrome "
                    "(default: <input>.chrome.json)")
    ap.add_argument("--prom-out", default=None,
                    help="output path for --export-prom "
                    "(default: print to stdout)")
    args = ap.parse_args(argv)

    if args.summarize is None and args.export_chrome is None \
            and args.export_prom is None and args.ledger is None \
            and args.summarize_incident is None:
        ap.error("pass --summarize, --export-chrome, --export-prom, "
                 "--ledger and/or --summarize-incident")
    if args.summarize is not None:
        print(summarize_jsonl(args.summarize))
    if args.summarize_incident is not None:
        print(summarize_incident(args.summarize_incident))
    if args.ledger is not None:
        from . import perf_ledger

        snap = _load_jsonl(args.ledger)["metrics"]
        if snap is None:
            ap.error(f"{args.ledger} carries no metrics snapshot "
                     "record (dump_jsonl with a registry)")
        rows = perf_ledger.rows_from_snapshot(snap)
        if rows:
            print(perf_ledger.format_rows(rows))
        else:
            print("no exec.* stamps in the snapshot — nothing ran "
                  "through the performance ledger")
    if args.export_chrome is not None:
        out = args.out or (args.export_chrome + ".chrome.json")
        chrome_from_jsonl(args.export_chrome, out)
        print(f"wrote {out}")
    if args.export_prom is not None:
        snap = _load_jsonl(args.export_prom)["metrics"]
        if snap is None:
            ap.error(f"{args.export_prom} carries no metrics "
                     "snapshot record (dump_jsonl with a registry)")
        text = prometheus_text(snapshot=snap)
        if args.prom_out:
            with open(args.prom_out, "w") as f:
                f.write(text)
            print(f"wrote {args.prom_out}")
        else:
            print(text, end="")
    return 0


# the incident flight recorder (its own module) is part of this
# module's public surface: telemetry.FlightRecorder
from .flight_recorder import (  # noqa: E402  (intentional tail import)
    FlightRecorder,
    summarize_incident,
)

if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
