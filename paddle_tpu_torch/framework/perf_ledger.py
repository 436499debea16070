"""Per-program performance ledger of the port (counterpart of the
reference's ``framework/perf_ledger.py``, which imports no JAX; the
port keeps its own copy): the join between registered resource plans
and the live telemetry plane (framework/telemetry.py).

A resource plan states, per program, its flops, peak live device
bytes and collective wire bytes; the telemetry plane measures live
walls and SLOs at run time. Neither half alone answers *which program*
is eating the step budget, and whether it runs where its plan says it
would on the roofline. This module is that join:

* the serving scheduler (inference/serving.py) stamps its model calls
  into ``exec.wall_s.<program>`` histograms and ``exec.count.<program>``
  counters (``prefill_chunk``, ``decode_token``, ``draft_propose``);
  each stamp closes after the logits reach the host, so it times the
  device work, not the launch queue. A plan registered under the same
  name (:func:`register_plan`, any object with the plan fields, read
  by ``getattr``) joins it;
* :class:`PerfLedger` reads both back from the metrics registry and
  reports, per program: attained flops/s, live MFU against the
  configurable ``FLAGS_telemetry_peak_flops``, achieved memory and
  wire bytes/s, arithmetic intensity attained vs planned, share of the
  total step wall, and the **plan-drift ratio**: the plan's
  roofline-predicted lower-bound wall over the sustained (windowed)
  measured wall. A ratio above ``FLAGS_telemetry_drift_ratio`` means
  the plan claims more work than the measured wall can explain (a
  falsified or stale plan); the ``plan-drift`` watchdog class
  (framework/watchdog.py) fires on it, read-only, from the
  ``ledger.*`` gauges :meth:`PerfLedger.publish` refreshes every
  watchdog stride.

Readout surfaces: ``BatchScheduler.metrics()["ledger"]``, the
``ledger.*`` gauge namespace (Prometheus series via
``telemetry.prometheus_text``), and ``python -m
paddle_tpu_torch.framework.telemetry --ledger trace.jsonl`` (and the
top-programs table in ``--summarize``).

Zero-cost off mode: this module is imported only by metrics-on
construction paths, :func:`ledger` returns ``None`` when
FLAGS_telemetry is off, and the instrumented call sites pay one
``is None`` check per invocation. Host-only: it imports neither torch
nor device code.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional

from .flags import flag

__all__ = [
    "PerfLedger", "ledger", "register_plan", "reset",
    "plan_summary", "rows_from_snapshot", "format_rows",
    "EXEC_WALL_PREFIX", "EXEC_COUNT_PREFIX",
]

# registry metric-name prefixes of the execution stamps
# (inference/serving.py writes them; the ledger only reads)
EXEC_WALL_PREFIX = "exec.wall_s."
EXEC_COUNT_PREFIX = "exec.count."

# plan-summary fields copied off a resource plan (duck-typed)
_PLAN_FIELDS = (
    "flops_total", "hbm_peak_bytes", "input_bytes", "donated_bytes",
    "const_bytes", "output_bytes", "transient_peak_bytes",
    "comm_bytes_total", "comm_bytes_quantized",
)


def plan_summary(plan) -> dict:
    """A plain-dict summary of a ResourcePlan (or an already-plain
    dict): exactly the numbers the ledger's rate math needs. The
    derived ``hbm_bytes_per_call`` is the program's planned HBM
    traffic floor per invocation — every input/donated/const buffer
    read once plus every fresh output written once (transients that
    stay in cache are excluded on purpose: this is the *minimum* the
    program must move, the denominator of the planned arithmetic
    intensity)."""
    if isinstance(plan, dict):
        out = {k: float(plan.get(k, 0) or 0) for k in _PLAN_FIELDS}
    else:
        out = {k: float(getattr(plan, k, 0) or 0)
               for k in _PLAN_FIELDS}
    out["hbm_bytes_per_call"] = (
        out["input_bytes"] + out["donated_bytes"]
        + out["const_bytes"] + out["output_bytes"])
    return out


class PerfLedger:
    """Plan-vs-actual attribution over the metrics registry.

    ``registry`` is the live :class:`telemetry.MetricsRegistry` the
    execution stamps land in. Peaks default from flags:
    ``FLAGS_telemetry_peak_flops`` (device flops/s the MFU column is
    judged against), ``FLAGS_telemetry_peak_hbm_gbs`` (HBM GB/s for
    the roofline-predicted wall), ``FLAGS_telemetry_drift_ratio``
    (the sustained predicted/measured wall ratio above which a plan
    counts as drifted), ``FLAGS_telemetry_window`` (the step-epoch
    window the "sustained" mean is computed over). A peak of 0
    disables the column that needs it (MFU / predicted wall)."""

    def __init__(self, registry, peak_flops: Optional[float] = None,
                 peak_hbm_gbs: Optional[float] = None,
                 drift_ratio: Optional[float] = None,
                 window: Optional[int] = None,
                 drift_min_samples: int = 4):
        if registry is None:
            raise ValueError(
                "PerfLedger needs a live MetricsRegistry "
                "(FLAGS_telemetry=metrics|trace)")
        self.registry = registry
        self.peak_flops = float(flag("telemetry_peak_flops")
                                if peak_flops is None else peak_flops)
        self.peak_hbm_bps = 1e9 * float(
            flag("telemetry_peak_hbm_gbs")
            if peak_hbm_gbs is None else peak_hbm_gbs)
        self.drift_ratio = float(flag("telemetry_drift_ratio")
                                 if drift_ratio is None
                                 else drift_ratio)
        self.window = max(1, int(flag("telemetry_window")
                                 if window is None else window))
        self.drift_min_samples = max(1, int(drift_min_samples))
        self._lock = threading.Lock()
        self._plans: Dict[str, dict] = {}
        # every plan ever registered per program (bounded): one
        # StaticFunction traced at several shapes registers one plan
        # per VARIANT under the same name, while every variant's
        # walls merge into one exec histogram — the drift check must
        # therefore use the SMALLEST variant's predicted wall (a
        # valid lower bound for any invocation in the merged
        # histogram; judging the mixed walls against the largest
        # variant's bound would fire plan-drift on a healthy program)
        self._plan_variants: Dict[str, list] = {}
        self._max_variants = 32

    # -- plan registration --------------------------------------------------
    def register_plan(self, program: str, plan) -> dict:
        """Attach a resource plan (ResourcePlan or plain summary
        dict) to ``program`` — the join key is the same ``<program>``
        the execution stamps use. Re-registration overwrites the
        REPORTED plan (a retrace carries the fresh one) but every
        variant is remembered for the drift floor (see
        ``_plan_variants``)."""
        summ = plan_summary(plan)
        with self._lock:
            self._plans[str(program)] = summ
            var = self._plan_variants.setdefault(str(program), [])
            var.append(summ)
            del var[:-self._max_variants]
        return summ

    def plans(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._plans)

    # -- external execution stamps ------------------------------------------
    def record(self, program: str, wall_s: float) -> None:
        """Stamp one invocation of ``program`` (an external driver —
        bench harness, a custom runner — measuring walls the compiled
        paths do not stamp themselves)."""
        self.registry.observe(EXEC_WALL_PREFIX + str(program),
                              float(wall_s))
        self.registry.inc(EXEC_COUNT_PREFIX + str(program))

    # -- the join -----------------------------------------------------------
    def _predicted_wall_s(self, plan: dict) -> Optional[float]:
        """The roofline-predicted lower-bound wall of one invocation:
        max of the compute time at peak flops and the HBM time at
        peak bandwidth (whichever peaks are configured). None when no
        peak is configured or the plan predicts no work."""
        bounds = []
        if self.peak_flops > 0 and plan["flops_total"] > 0:
            bounds.append(plan["flops_total"] / self.peak_flops)
        if self.peak_hbm_bps > 0 and plan["hbm_bytes_per_call"] > 0:
            bounds.append(plan["hbm_bytes_per_call"]
                          / self.peak_hbm_bps)
        return max(bounds) if bounds else None

    def report(self, top: Optional[int] = None) -> Dict[str, dict]:
        """Per-program plan-vs-actual rows, keyed by program name.

        Every program with either an execution stamp or a registered
        plan gets a row; rate columns need both (a plan with no walls
        reports ``count`` 0, walls with no plan report timing only).
        ``top`` keeps only the N largest rows by total wall (the
        bounded slice incident bundles embed)."""
        snap = self.registry.snapshot()
        exec_ns = snap.get("exec", {})
        walls = {k[len("wall_s."):]: v for k, v in exec_ns.items()
                 if k.startswith("wall_s.")
                 and isinstance(v, dict)}
        counts = {k[len("count."):]: v for k, v in exec_ns.items()
                  if k.startswith("count.")}
        step_hist = (snap.get("serving", {}) or {}).get("step_wall_s")
        step_total = float(step_hist.get("sum") or 0.0) \
            if isinstance(step_hist, dict) else 0.0
        exec_total = sum(float(h.get("sum") or 0.0)
                         for h in walls.values())
        plans = self.plans()
        min_epoch = self.registry.epoch - self.window
        rows: Dict[str, dict] = {}
        for prog in sorted(set(walls) | set(plans)):
            h = walls.get(prog)
            plan = plans.get(prog)
            row: Dict[str, object] = {
                "program": prog,
                "count": int(counts.get(prog)
                             or (h or {}).get("count") or 0),
                "has_plan": plan is not None,
            }
            total = mean = None
            if h is not None and h.get("count"):
                total = float(h.get("sum") or 0.0)
                mean = total / float(h["count"])
                row.update(
                    total_wall_s=total,
                    mean_wall_s=mean,
                    p50_wall_s=h.get("p50"),
                    p99_wall_s=h.get("p99"),
                    max_wall_s=h.get("max"),
                )
                denom = step_total if step_total > 0 else exec_total
                if denom > 0:
                    row["share_of_step_wall"] = total / denom
            if plan is not None:
                row["plan"] = dict(plan)
                row["ai_planned"] = (
                    plan["flops_total"] / plan["hbm_bytes_per_call"]
                    if plan["hbm_bytes_per_call"] > 0 else None)
                pred = self._predicted_wall_s(plan)
                if pred is not None:
                    row["predicted_wall_s"] = pred
            if plan is not None and mean is not None and mean > 0:
                fps = plan["flops_total"] / mean
                row["attained_flops_per_s"] = fps
                if self.peak_flops > 0:
                    row["mfu"] = fps / self.peak_flops
                row["hbm_bytes_per_s"] = (
                    plan["hbm_bytes_per_call"] / mean)
                row["wire_bytes_per_s"] = (
                    plan["comm_bytes_total"] / mean)
                if plan["comm_bytes_quantized"] > 0:
                    # the quantized-bytes plan field, live: the
                    # achieved quantize-on-the-wire rate — published
                    # as a ledger gauge so it reaches Prometheus
                    # instead of living only in plans.json
                    row["wire_bytes_quantized_per_s"] = (
                        plan["comm_bytes_quantized"] / mean)
                # where the measured throughput puts the program on
                # the roofline: the arithmetic intensity it would
                # NEED at peak HBM bandwidth to sustain the attained
                # flops rate — compare against ai_planned to see
                # whether it runs at its planned roofline position
                if self.peak_hbm_bps > 0:
                    row["ai_attained"] = fps / self.peak_hbm_bps
            # plan drift: the SUSTAINED (windowed) measured wall vs
            # the roofline-predicted lower bound — a plan claiming
            # more work than the wall can explain is off. The bound
            # is the MIN over every registered variant (the merged
            # exec histogram carries all variants' walls), and
            # drift_samples is published even at 0 so a program that
            # stops running releases the watchdog latch instead of
            # pinning it with a stale ratio gauge.
            if plan is not None:
                with self._lock:
                    variants = list(
                        self._plan_variants.get(prog) or (plan,))
                preds = [self._predicted_wall_s(v) for v in variants]
                preds = [p for p in preds if p is not None]
                pred_floor = min(preds) if preds else None
                if pred_floor is not None:
                    w = self.registry.hist_windowed(
                        EXEC_WALL_PREFIX + prog, min_epoch)
                    n = int(w["count"]) if w is not None else 0
                    row["drift_samples"] = n
                    if n >= self.drift_min_samples \
                            and (w["avg"] or 0) > 0:
                        ratio = pred_floor / w["avg"]
                        row["drift_ratio"] = ratio
                        row["drifting"] = ratio >= self.drift_ratio
            rows[prog] = row
        if top is not None and len(rows) > top:
            keep = sorted(
                rows.values(),
                key=lambda r: -float(r.get("total_wall_s") or 0.0)
            )[:top]
            rows = {r["program"]: r for r in keep}
        return rows

    # -- registry publication -----------------------------------------------
    # the gauge fields publish() mirrors per program (the plan-drift
    # watchdog reads drift_ratio/drift_samples; Prometheus gets all)
    _GAUGE_FIELDS = (
        "mfu", "attained_flops_per_s", "hbm_bytes_per_s",
        "wire_bytes_per_s", "wire_bytes_quantized_per_s",
        "share_of_step_wall", "predicted_wall_s",
        "drift_ratio", "drift_samples",
    )

    def publish(self) -> Dict[str, dict]:
        """Refresh the ``ledger.<field>.<program>`` gauges from a
        fresh :meth:`report` — the scheduler calls this every
        watchdog stride, BEFORE the detectors run, so the plan-drift
        class judges current numbers. Returns the report."""
        rows = self.report()
        reg = self.registry
        for prog, row in rows.items():
            for field in self._GAUGE_FIELDS:
                v = row.get(field)
                if v is not None and math.isfinite(float(v)):
                    reg.gauge("ledger.%s.%s" % (field, prog),
                              float(v))
            if row.get("drift_ratio") is not None:
                # the verdict rides the snapshot (0/1) so a dumped
                # bundle replays the threshold in effect WHEN IT
                # FIRED, not whatever the replaying host configures
                reg.gauge("ledger.drifting." + prog,
                          1.0 if row.get("drifting") else 0.0)
        reg.gauge("ledger.programs", len(rows))
        return rows


# ---------------------------------------------------------------------------
# process-wide singleton (the registry()/tracer() discipline)
# ---------------------------------------------------------------------------

_LEDGER: Optional[PerfLedger] = None
_LOCK = threading.Lock()


def ledger() -> Optional[PerfLedger]:
    """The process-wide ledger, or None when FLAGS_telemetry=off.
    Built lazily over the telemetry registry; instrumented sites
    cache the handle at construction (the zero-cost-off contract)."""
    global _LEDGER
    from . import telemetry  # lazy: telemetry imports this module

    reg = telemetry.registry()
    if reg is None:
        return None
    if _LEDGER is None or _LEDGER.registry is not reg:
        with _LOCK:
            if _LEDGER is None or _LEDGER.registry is not reg:
                _LEDGER = PerfLedger(reg)
    return _LEDGER


def register_plan(program: str, plan) -> None:
    """Register a compiled program's resource plan with the process
    ledger — a silent no-op when telemetry is off (the compile path
    calls this unconditionally once it holds a live registry)."""
    led = ledger()
    if led is not None:
        led.register_plan(program, plan)


def reset() -> None:
    """Drop the process-wide ledger (bench/test arm isolation);
    telemetry.reset() calls this so the two singletons never skew."""
    global _LEDGER
    with _LOCK:
        _LEDGER = None


# ---------------------------------------------------------------------------
# snapshot post-processing (CLI tables work off dumped snapshots)
# ---------------------------------------------------------------------------


def rows_from_snapshot(snapshot: dict) -> Dict[str, dict]:
    """Ledger rows reconstructed from a registry SNAPSHOT dict (the
    ``{"type": "metrics"}`` record of a JSONL dump): the ``exec.*``
    histograms plus whatever ``ledger.<field>.<program>`` gauges
    :meth:`PerfLedger.publish` refreshed before the dump. This is
    what the telemetry CLI's ``--ledger`` / ``--summarize`` table and
    ``--summarize-incident`` render — no live registry needed."""
    exec_ns = snapshot.get("exec", {}) or {}
    rows: Dict[str, dict] = {}
    for key, v in exec_ns.items():
        if key.startswith("wall_s.") and isinstance(v, dict):
            prog = key[len("wall_s."):]
            rows[prog] = {
                "program": prog,
                "count": int(v.get("count") or 0),
                "total_wall_s": float(v.get("sum") or 0.0),
                "p50_wall_s": v.get("p50"),
                "p99_wall_s": v.get("p99"),
            }
    for key, v in exec_ns.items():
        if key.startswith("count."):
            prog = key[len("count."):]
            try:
                rows.setdefault(prog, {"program": prog})["count"] = \
                    int(v or 0)
            except (TypeError, ValueError):
                # a malformed/partial fleet snapshot degrades to "no
                # signal" for this field, never a crash — the
                # autotuner hill-climbs on these rows
                rows.setdefault(prog, {"program": prog})["count"] = 0
    for key, v in (snapshot.get("ledger", {}) or {}).items():
        field, _, prog = key.partition(".")
        if not prog or field == "programs":
            continue
        rows.setdefault(prog, {"program": prog})[field] = v
    for row in rows.values():
        if "drifting" in row:
            # the publisher's recorded verdict (the threshold in
            # effect when the snapshot was written) always wins over
            # whatever the replaying host's flag happens to be
            row["drifting"] = bool(row["drifting"])
        elif "drift_ratio" in row:
            # older snapshots without the verdict gauge: fall back
            # to the local threshold; a None/garbage gauge from a
            # partial merge is "no signal", not a crash
            try:
                row["drifting"] = (
                    float(row["drift_ratio"])
                    >= float(flag("telemetry_drift_ratio")))
            except (TypeError, ValueError):
                row["drift_ratio"] = None
                row["drifting"] = False
    return rows


def _fmt(v, scale=1.0, digits=3):
    if v is None:
        return "-"
    return "%.*g" % (digits, float(v) * scale)


def format_rows(rows: Dict[str, dict],
                title: str = "ledger: top programs by total wall"
                ) -> str:
    """The fixed-width ledger table (count, total/p50/p99 wall, MFU,
    plan-drift flag) shared by ``--ledger``, ``--summarize``, and
    ``--summarize-incident``."""
    lines = [title]
    lines.append(
        "%-28s%7s%11s%11s%11s%8s%8s  %s"
        % ("program", "calls", "total_ms", "p50_ms", "p99_ms",
           "mfu", "share", "drift"))
    order = sorted(rows.values(),
                   key=lambda r: -float(r.get("total_wall_s") or 0.0))
    for r in order:
        if r.get("drift_ratio") is None:
            drift = "-"
        else:
            drift = "%s(%.2f)" % (
                "DRIFT" if r.get("drifting") else "ok",
                float(r["drift_ratio"]))
        lines.append(
            "%-28s%7d%11s%11s%11s%8s%8s  %s"
            % (str(r.get("program", "?"))[:27],
               int(r.get("count") or 0),
               _fmt(r.get("total_wall_s"), 1e3),
               _fmt(r.get("p50_wall_s"), 1e3),
               _fmt(r.get("p99_wall_s"), 1e3),
               _fmt(r.get("mfu"), 1.0, 2),
               _fmt(r.get("share_of_step_wall"), 1.0, 2),
               drift))
    return "\n".join(lines)
