"""Anomaly watchdogs over the telemetry registry of the port
(counterpart of the reference's ``framework/watchdog.py``, which
imports no JAX; the port keeps its own copy): the "is something going
wrong RIGHT NOW" layer of the observability stack.

A :class:`Watchdog` is a set of detectors the serving scheduler runs
every ``FLAGS_telemetry_watchdog_stride`` steps. Each detector reads
ONLY the metrics registry (counters, gauges, epoch-stamped histogram
reservoirs) plus a caller-provided context dict, computes rates over
a trailing ``FLAGS_telemetry_window`` of step epochs, and appends a
structured event to a bounded log when its signature fires:

* ``recompile-storm`` — compile events climbing faster than
  ``storm_compiles`` per window after warmup; ``compile.count`` and
  the serving-side ``serving.compile_count`` program gauge are
  redundant views of the same recompiles, so the rate is the LARGER
  of the two increases, never their sum.
* ``pool-pressure`` — page-pool occupancy at/above the high
  watermark, or alloc+free churn exceeding ``churn_factor`` x the
  pool size per window (thrash).
* ``prefix-collapse`` — the windowed mean of ``prefix.hit_frac``
  dropping below ``collapse_frac`` x its trailing baseline window.
* ``decode-stall`` — the newest ``serving.step_wall_s`` sample an
  outlier (``stall_factor`` x) against the window median.
* ``sanitizer-spike`` — ``sanitizer.violations`` increasing inside
  the window; the event carries the journal tail the caller passed
  in via ``context`` (the detector itself never touches a pool).
* ``preemption-thrash`` — ``serving.preempt_victims`` climbing
  faster than ``thrash_preempts`` per window after warmup: victims
  are bouncing between the device pool and the host swap tier
  without retiring, so steps go to KV copies instead of decode
  (docs/SERVING.md "Overload behavior").
* ``plan-drift`` — a program whose SUSTAINED measured throughput
  implies the static planner's cost model is off: the performance
  ledger (framework/perf_ledger.py) publishes, per program, the
  ratio of the roofline-predicted lower-bound wall to the windowed
  measured wall as ``ledger.drift_ratio.<program>`` gauges; a ratio
  at/above ``drift_ratio`` (``FLAGS_telemetry_drift_ratio``) with
  enough windowed samples means the plan claims more work than the
  wall can explain (falsified/stale plan, or the plan's byte/flop
  model diverged).

Events are plain dicts (``{"type": "watchdog_event", "class": ...,
"epoch": ..., "detail": ..., "snapshot": ...}``), JSONL-dumpable via
:meth:`Watchdog.dump_jsonl` or ``Tracer.dump_jsonl(watchdog=...)``.
``mode="warn"`` raises a ``RuntimeWarning`` per event; ``"strict"``
raises :class:`WatchdogError` at the detecting step.

DISCIPLINE: this module must never mutate registry state (no ``inc`` /
``gauge`` / ``observe`` / ``set_epoch`` / ``advance_epoch`` calls)
and must never call
pool-private methods or write pool state — a detector that perturbs
what it is watching is useless as evidence. It is also host-only (no
torch, no device code): detectors run inside the scheduler's host loop.
All rate math is keyed by step epoch, never wall clock, so every
detector is deterministic under a fake clock.
"""
from __future__ import annotations

import collections
import json
import warnings
from typing import Dict, List, Optional

from . import telemetry
from .flags import flag

__all__ = ["Watchdog", "WatchdogError", "WATCHDOG_CLASSES"]

# (class id, one-line summary) — merged into
# `python -m paddle_tpu_torch.framework.analysis --rules`
WATCHDOG_CLASSES = (
    ("recompile-storm",
     "compile events per trailing window above threshold (the "
     "larger of the compile.count / serving.compile_count "
     "increases)"),
    ("pool-pressure",
     "page-pool occupancy at the high watermark, or alloc/free "
     "churn above churn_factor x pool size per window"),
    ("prefix-collapse",
     "windowed prefix-cache hit fraction below collapse_frac x its "
     "trailing baseline window"),
    ("decode-stall",
     "newest step wall time a stall_factor-x outlier vs the window "
     "median"),
    ("sanitizer-spike",
     "page-sanitizer violation count increased inside the window"),
    ("preemption-thrash",
     "preemption swap-outs per trailing window above "
     "thrash_preempts: victims are being swapped out/in faster "
     "than they make progress (capacity is oversubscribed beyond "
     "what graceful degradation can absorb)"),
    ("plan-drift",
     "a program's sustained measured wall beats the planner's "
     "roofline-predicted lower bound by more than "
     "FLAGS_telemetry_drift_ratio (ledger.drift_ratio.<program> "
     "gauges, framework/perf_ledger.py): the static cost model is "
     "off and must not be trusted to gate decisions"),
)


class WatchdogError(RuntimeError):
    """Raised in strict mode at the step a detector fires; carries
    the triggering event(s)."""

    def __init__(self, events: List[dict]):
        self.events = list(events)
        lines = ["%d watchdog event(s):" % len(self.events)]
        for ev in self.events:
            lines.append("  [%s] epoch %s: %s" % (
                ev.get("class"), ev.get("epoch"),
                json.dumps(ev.get("detail", {}), default=str)))
        super().__init__("\n".join(lines))


class Watchdog:
    """Registry-read-only anomaly detectors with a bounded event log.

    ``registry`` is the :class:`telemetry.MetricsRegistry` to watch;
    ``mode`` is ``warn``/``strict`` (``FLAGS_telemetry_watchdog`` by
    default — the caller handles ``off`` by never constructing one);
    ``window`` is the trailing step-epoch window every rate is
    computed over (``FLAGS_telemetry_window``); ``warmup`` exempts
    the natural startup burst (first compiles, cold caches) and
    defaults to one window. Warmup is counted from the epoch of THIS
    watchdog's first ``check()`` — the registry epoch is shared and
    monotonic across schedulers, so a late-built watchdog still gets
    its full warmup grace."""

    def __init__(self, registry, mode: Optional[str] = None,
                 window: Optional[int] = None,
                 warmup: Optional[int] = None,
                 log_capacity: int = 256,
                 storm_compiles: int = 4,
                 pool_high: float = 0.97,
                 churn_factor: float = 2.0,
                 collapse_frac: float = 0.5,
                 collapse_min_baseline: float = 0.2,
                 collapse_min_samples: int = 8,
                 stall_factor: float = 8.0,
                 stall_min_samples: int = 8,
                 thrash_preempts: int = 6,
                 drift_ratio: Optional[float] = None,
                 drift_min_samples: int = 4):
        if registry is None:
            raise ValueError(
                "Watchdog needs a live MetricsRegistry "
                "(FLAGS_telemetry=metrics|trace)")
        self.registry = registry
        mode = str(flag("telemetry_watchdog")
                   if mode is None else mode).lower()
        if mode not in ("warn", "strict"):
            raise ValueError(
                f"watchdog mode must be 'warn' or 'strict', got "
                f"{mode!r} (off means: do not build one)")
        self.mode = mode
        self.window = max(1, int(flag("telemetry_window")
                                 if window is None else window))
        self.warmup = self.window if warmup is None else max(
            0, int(warmup))
        self.storm_compiles = int(storm_compiles)
        self.pool_high = float(pool_high)
        self.churn_factor = float(churn_factor)
        self.collapse_frac = float(collapse_frac)
        self.collapse_min_baseline = float(collapse_min_baseline)
        self.collapse_min_samples = int(collapse_min_samples)
        self.stall_factor = float(stall_factor)
        self.stall_min_samples = int(stall_min_samples)
        self.thrash_preempts = int(thrash_preempts)
        self.drift_ratio = float(flag("telemetry_drift_ratio")
                                 if drift_ratio is None
                                 else drift_ratio)
        self.drift_min_samples = int(drift_min_samples)
        self.events = collections.deque(maxlen=max(8, log_capacity))
        self.dropped = 0
        self.checks = 0
        self.counts: Dict[str, int] = {}
        # detector-internal rate state: (epoch, cumulative value)
        # observations, pruned to the window
        self._compile_obs = collections.deque()
        self._churn_obs = collections.deque()
        self._san_obs = collections.deque()
        self._preempt_obs = collections.deque()
        # hysteresis latches: fire once per excursion, re-arm on
        # recovery instead of re-firing every stride
        self._latched = {cls: False for cls, _ in WATCHDOG_CLASSES}
        # warmup re-baselining: cumulative-rate detectors restart
        # their observation window at the first post-warmup check,
        # so compiles/churn that landed DURING warmup never count
        # toward the first live window
        self._baselined = {"storm": False, "churn": False,
                           "preempt": False}
        # the registry epoch at the first check(): warmup is RELATIVE
        # to it (the shared epoch never restarts per watchdog)
        self._first_epoch: Optional[int] = None

    # -- event plumbing ----------------------------------------------------
    def _ns_snapshot(self, ns: str) -> dict:
        """The one namespace of the registry snapshot a class's
        evidence lives in (kept small: events ride JSONL dumps)."""
        return dict(self.registry.snapshot().get(ns, {}))

    def _emit(self, cls: str, epoch: int, detail: dict,
              snapshot: dict, fired: List[dict],
              context: Optional[dict] = None) -> dict:
        ev = {"type": "watchdog_event", "class": cls,
              "epoch": int(epoch), "wall": telemetry.clock(),
              "mode": self.mode, "detail": detail,
              "snapshot": snapshot}
        if context:
            ev.update(context)
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)
        self.counts[cls] = self.counts.get(cls, 0) + 1
        fired.append(ev)
        return ev

    @staticmethod
    def _prune(obs: collections.deque, epoch: int, window: int):
        while obs and obs[0][0] < epoch - window:
            obs.popleft()

    def _rate(self, obs: collections.deque, epoch: int,
              value: float) -> float:
        """Append (epoch, cumulative value), prune to the window, and
        return the increase across the retained observations."""
        obs.append((int(epoch), float(value)))
        self._prune(obs, epoch, self.window)
        return obs[-1][1] - obs[0][1]

    def _in_warmup(self, epoch: int) -> bool:
        """True while the startup grace holds — counted from the
        epoch of this watchdog's FIRST check, never the absolute
        shared registry epoch (a watchdog built at epoch 5000 still
        deserves its warmup)."""
        first = self._first_epoch if self._first_epoch is not None \
            else epoch
        return epoch - first < self.warmup

    def _warming(self, obs: collections.deque, epoch: int,
                 entry: tuple, key: str) -> bool:
        """True while a cumulative-rate detector must stay silent:
        during warmup, and at the FIRST post-warmup check, where the
        observation window restarts (re-seeded with ``entry``, the
        detector's newest observation tuple) so activity that landed
        during warmup (the startup compile burst, cold-cache churn)
        never counts toward a live window."""
        if self._in_warmup(epoch):
            return True
        if not self._baselined[key]:
            self._baselined[key] = True
            obs.clear()
            obs.append(entry)
            return True
        return False

    # -- detectors ---------------------------------------------------------
    def _check_recompile_storm(self, epoch, fired, context=None):
        reg = self.registry
        c = float(reg.counter("compile.count"))
        # the serving-side program count: prefer the CALLER's own
        # adapter count (context["compile_count"], per-scheduler
        # correct — the shared serving.compile_count gauge is
        # last-writer-wins, so two interleaved schedulers with
        # different counts would fake a storm-sized delta); the gauge
        # is the fallback for standalone single-scheduler use
        ctx_cc = (context or {}).get("compile_count")
        g = float(ctx_cc) if ctx_cc is not None else float(
            reg.gauge_value("serving.compile_count") or 0.0)
        obs = self._compile_obs
        obs.append((int(epoch), c, g))
        self._prune(obs, epoch, self.window)
        if self._warming(obs, epoch, (int(epoch), c, g), "storm"):
            return
        # the two signals are REDUNDANT views of the same recompiles
        # (the process-wide jit counter vs the adapter's program-count
        # gauge): take the LARGER increase, never the sum — summing
        # would count every real recompile twice and fire at half the
        # documented storm_compiles threshold
        delta = max(obs[-1][1] - obs[0][1], obs[-1][2] - obs[0][2])
        if delta >= self.storm_compiles:
            if not self._latched["recompile-storm"]:
                self._latched["recompile-storm"] = True
                self._emit(
                    "recompile-storm", epoch,
                    {"compiles_in_window": delta,
                     "window": self.window,
                     "threshold": self.storm_compiles},
                    self._ns_snapshot("compile"), fired)
            # hold the latch while the storm persists; restart the
            # rate window so recovery is judged on fresh data
            obs.clear()
            obs.append((int(epoch), c, g))
        else:
            self._latched["recompile-storm"] = False

    def _check_pool_pressure(self, epoch, fired):
        reg = self.registry
        util = reg.gauge_value("pool.utilization")
        total = reg.gauge_value("pool.total_pages") or 0.0
        high = util is not None and util >= self.pool_high
        churn = reg.counter("pool.page_allocs") \
            + reg.counter("pool.page_frees")
        churn_delta = self._rate(self._churn_obs, epoch, churn)
        thrash = (not self._warming(self._churn_obs, epoch,
                                    (int(epoch), float(churn)),
                                    "churn")
                  and total > 0
                  and churn_delta >= self.churn_factor * total)
        if high or thrash:
            if not self._latched["pool-pressure"]:
                self._latched["pool-pressure"] = True
                self._emit(
                    "pool-pressure", epoch,
                    {"kind": "high-watermark" if high else "churn",
                     "utilization": util,
                     "churn_in_window": churn_delta,
                     "total_pages": total,
                     "high_watermark": self.pool_high,
                     "churn_factor": self.churn_factor},
                    self._ns_snapshot("pool"), fired)
            if thrash:
                self._churn_obs.clear()
                self._churn_obs.append((int(epoch), float(churn)))
        else:
            self._latched["pool-pressure"] = False

    def _check_prefix_collapse(self, epoch, fired):
        lo_cur = epoch - self.window
        samples = self.registry.hist_samples(
            "prefix.hit_frac", min_epoch=lo_cur - 2 * self.window)
        cur = [v for e, v in samples if e >= lo_cur]
        base = [v for e, v in samples if e < lo_cur]
        if len(cur) < self.collapse_min_samples \
                or len(base) < self.collapse_min_samples:
            return
        cur_rate = sum(cur) / len(cur)
        base_rate = sum(base) / len(base)
        if base_rate < self.collapse_min_baseline:
            return
        if cur_rate < self.collapse_frac * base_rate:
            if not self._latched["prefix-collapse"]:
                self._latched["prefix-collapse"] = True
                self._emit(
                    "prefix-collapse", epoch,
                    {"window_hit_frac": round(cur_rate, 4),
                     "baseline_hit_frac": round(base_rate, 4),
                     "collapse_frac": self.collapse_frac,
                     "window": self.window},
                    self._ns_snapshot("prefix"), fired)
        else:
            self._latched["prefix-collapse"] = False

    def _check_decode_stall(self, epoch, fired):
        # warmup applies here too: the startup steps that trace+lower
        # new bucket programs are legitimate 10-100x wall outliers
        # (the exact burst the warmup grace documents)
        if self._in_warmup(epoch):
            return
        samples = self.registry.hist_samples(
            "serving.step_wall_s", min_epoch=epoch - self.window)
        if len(samples) < self.stall_min_samples:
            return
        newest = samples[-1][1]
        rest = sorted(v for _, v in samples[:-1])
        median = rest[len(rest) // 2]
        if median > 0.0 and newest >= self.stall_factor * median:
            if not self._latched["decode-stall"]:
                self._latched["decode-stall"] = True
                self._emit(
                    "decode-stall", epoch,
                    {"step_wall_s": newest,
                     "window_median_s": median,
                     "stall_factor": self.stall_factor,
                     "window_samples": len(samples)},
                    self._ns_snapshot("serving"), fired)
        else:
            self._latched["decode-stall"] = False

    def _check_sanitizer_spike(self, epoch, fired, context):
        viol = self.registry.gauge_value("sanitizer.violations")
        if viol is None:
            return
        delta = self._rate(self._san_obs, epoch, viol)
        if delta > 0:
            tail = (context or {}).get("sanitizer_journal_tail")
            self._emit(
                "sanitizer-spike", epoch,
                {"new_violations": delta,
                 "total_violations": viol,
                 "window": self.window},
                self._ns_snapshot("sanitizer"), fired,
                context={"sanitizer_journal_tail": tail}
                if tail is not None else None)
            self._san_obs.clear()
            self._san_obs.append((int(epoch), float(viol)))

    def _check_preemption_thrash(self, epoch, fired):
        # serving.preempt_victims is cumulative across the process
        # (like compile.count); rate it over the window. A burst that
        # preempts once and moves on is healthy degradation — the
        # thrash signature is REPEATED swap-outs inside one window,
        # i.e. victims bouncing between device and host without
        # retiring (each bounce re-copies whole page chains, so the
        # scheduler spends its steps moving KV instead of decoding)
        viol = self.registry.counter("serving.preempt_victims")
        delta = self._rate(self._preempt_obs, epoch, viol)
        if self._warming(self._preempt_obs, epoch,
                         (int(epoch), float(viol)), "preempt"):
            return
        if delta >= self.thrash_preempts:
            if not self._latched["preemption-thrash"]:
                self._latched["preemption-thrash"] = True
                self._emit(
                    "preemption-thrash", epoch,
                    {"preemptions_in_window": delta,
                     "swapped_now": self.registry.gauge_value(
                         "serving.swapped_requests"),
                     "swap_declines": self.registry.counter(
                         "serving.preempt_swap_full"),
                     "window": self.window,
                     "threshold": self.thrash_preempts},
                    self._ns_snapshot("serving"), fired)
            # judge recovery on fresh data, like the storm detector
            self._preempt_obs.clear()
            self._preempt_obs.append((int(epoch), float(viol)))
        else:
            self._latched["preemption-thrash"] = False

    def _check_plan_drift(self, epoch, fired):
        """The seventh class (registry-read-only like the rest): the
        performance ledger publishes per-program drift ratios as
        ``ledger.drift_ratio.<program>`` gauges (predicted lower-
        bound wall over the windowed measured wall) plus the windowed
        sample counts; this detector only READS them. It fires on
        the worst program at/above the threshold — once per
        excursion (hysteresis latch), and never during warmup (the
        first windows measure compile-laden steps)."""
        if self.drift_ratio <= 0 or self._in_warmup(epoch):
            return
        led = self._ns_snapshot("ledger")
        worst = None
        for key, val in led.items():
            if not key.startswith("drift_ratio."):
                continue
            prog = key[len("drift_ratio."):]
            n = led.get("drift_samples." + prog, 0)
            if n is None or n < self.drift_min_samples:
                continue
            if val >= self.drift_ratio \
                    and (worst is None or val > worst[1]):
                worst = (prog, float(val), int(n))
        if worst is not None:
            if not self._latched["plan-drift"]:
                self._latched["plan-drift"] = True
                prog, ratio, n = worst
                self._emit(
                    "plan-drift", epoch,
                    {"program": prog,
                     "drift_ratio": round(ratio, 3),
                     "threshold": self.drift_ratio,
                     "windowed_samples": n,
                     "predicted_wall_s": led.get(
                         "predicted_wall_s." + prog),
                     "mfu": led.get("mfu." + prog)},
                    led, fired)
        else:
            self._latched["plan-drift"] = False

    # -- the pass ----------------------------------------------------------
    def check(self, epoch: int,
              context: Optional[dict] = None) -> List[dict]:
        """Run every detector against the registry at ``epoch``.
        Returns the events fired THIS pass (the full log stays in
        ``self.events``). ``context`` carries caller-gathered
        evidence a detector may use but must not fetch itself —
        today ``sanitizer_journal_tail`` (attached to sanitizer-spike
        events) and ``compile_count`` (the calling scheduler's own
        adapter program count, the multi-scheduler-correct serving
        signal of the storm detector). Warn mode raises one
        RuntimeWarning per event; strict raises WatchdogError."""
        epoch = int(epoch)
        if self._first_epoch is None:
            self._first_epoch = epoch
        self.checks += 1
        fired: List[dict] = []
        self._check_recompile_storm(epoch, fired, context)
        self._check_pool_pressure(epoch, fired)
        self._check_prefix_collapse(epoch, fired)
        self._check_decode_stall(epoch, fired)
        self._check_sanitizer_spike(epoch, fired, context)
        self._check_preemption_thrash(epoch, fired)
        self._check_plan_drift(epoch, fired)
        if fired and self.mode == "strict":
            raise WatchdogError(fired)
        for ev in fired:
            warnings.warn(
                "[telemetry watchdog] %s at epoch %d: %s" % (
                    ev["class"], epoch,
                    json.dumps(ev["detail"], default=str)),
                RuntimeWarning, stacklevel=3)
        return fired

    # -- readout -----------------------------------------------------------
    def summary(self) -> dict:
        return {"mode": self.mode, "window": self.window,
                "checks": self.checks, "events": len(self.events),
                "dropped": self.dropped,
                "by_class": dict(sorted(self.counts.items())),
                "last": self.events[-1] if self.events else None}

    def to_records(self) -> List[dict]:
        """The bounded event log as JSONL-ready dicts (the shape
        ``Tracer.dump_jsonl(watchdog=...)`` writes)."""
        return [dict(ev) for ev in self.events]

    def dump_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for ev in self.to_records():
                f.write(json.dumps(ev, default=str) + "\n")
        return path
