"""Closed-loop capacity autotuner of the port (counterpart of the
reference's ``framework/autotuner.py``): statically scored search, live
climb.

The capacity knobs of the serving stack (``FLAGS_prefill_chunk_tokens``,
``FLAGS_serving_buckets``, ``FLAGS_serving_swap_bytes``,
``FLAGS_collective_dtype``, the engine goodput band) are otherwise picked
by hand. The :class:`Autotuner` closes the loop:

1. **enumerate** candidates over the knob space
   (:func:`enumerate_candidates`, grammar in :func:`parse_space`);
2. **score statically** against a :class:`WorkloadProfile` of per-token
   cost coefficients and discard candidates that breach the device-memory
   and wire budgets *before ever running them*;
3. **hill-climb live**: deploy the static frontier, measure each
   candidate over ``FLAGS_autotune_eval_windows`` goodput windows, and
   adopt a challenger only when its median score beats the incumbent by
   ``FLAGS_autotune_min_improve`` (the dead band and the median are the
   hysteresis that keeps one noisy window from thrashing configs);
4. **quarantine** on watchdog trips: a recompile-storm or plan-drift
   event while a candidate is deployed quarantines it (never revisited)
   and the tuner reverts to the best non-quarantined config.

The profile's coefficients come from a plan
(:meth:`WorkloadProfile.from_plan` reads ``hbm_peak_bytes`` and
``comm_bytes_total`` off a dict or an object): the ``ResourcePlan`` the
static planner (``framework/planner.py``) makes of a ``jit.to_static``
program, or a dict a caller builds from measured bytes (the weights
plus the KV pools, and the activation bytes a packed token), since the
serving steps are not compiled yet.

The chosen config is emitted as a reproducible JSON artifact
(:meth:`Autotuner.write_artifact` / :func:`load_artifact` /
:func:`apply_artifact`) whose ``flags`` dict re-applies it verbatim, and
whose layout is the reference's (``kind: paddle_tpu.tuned_config``), so
either package reads the other's.

Knob changes land **only at step boundaries**: :func:`apply_config` is
the one seam. It sets the process flags and, given a live scheduler,
calls its ``apply_capacity_config``, which refuses to run mid-step. The
async engine marshals the same call onto its pump thread between
``step()``s (``ServingEngine.apply_config``).

Host-only: numbers and dicts, no tensor.
"""
import itertools
import json

from . import telemetry
from .flags import flag, set_flags

__all__ = [
    "CAPACITY_KNOBS", "DEFAULT_SPACE", "QUARANTINE_CLASSES",
    "CandidateConfig", "WorkloadProfile", "Measurement", "Autotuner",
    "parse_space", "enumerate_candidates", "static_score",
    "check_feasible", "live_score", "measure_from_snapshot",
    "apply_config", "load_artifact", "apply_artifact",
]

# the capacity knobs the tuner owns: every mutation of them in the
# serving layers funnels through apply_config
CAPACITY_KNOBS = (
    "prefill_chunk_tokens",
    "serving_buckets",
    "serving_swap_bytes",
    "collective_dtype",
    "engine_goodput_low",
    "engine_goodput_high",
)

# watchdog classes treated as hard negative signal for the deployed
# candidate (framework/watchdog.py WATCHDOG_CLASSES ids): a compile
# storm means the bucket ladder thrashes the shape cache, plan drift
# means the static score that promoted the candidate can no longer be
# trusted
QUARANTINE_CLASSES = ("recompile-storm", "plan-drift")

# quantize-on-the-wire payload ratio vs fp32 (1 byte/elt payload + one
# f32 scale per 128-element block = 1/4 + 4/(128*4))
_WIRE_RATIO = {"off": 1.0, "int8": 0.2578125, "fp8": 0.2578125}

DEFAULT_SPACE = {
    "chunk": (16, 32, 64, 128),
    "buckets": ("8,16,32,64", "8,16,32,64,128,256", "16,64,256"),
    "swap": (0, 256 << 20),
    "dtype": ("off",),
    "band": ("0.75:0.9",),
}

_STATE_IDS = {"seeded": 0, "measuring": 1, "probing": 2,
              "converged": 3}


def _parse_bucket_ladder(spec):
    """'8,16,32' -> (8, 16, 32) — ascending unique positive ints
    (the bucket-ladder rule of serving._parse_buckets)."""
    out = sorted({int(tok) for tok in str(spec).split(",")
                  if str(tok).strip()})
    if not out or out[0] <= 0:
        raise ValueError("bucket ladder must be positive ints: %r"
                         % (spec,))
    return tuple(out)


def _parse_band(spec):
    """'0.75:0.9' -> (0.75, 0.9)."""
    lo, _, hi = str(spec).partition(":")
    lo, hi = float(lo), float(hi)
    if not (0.0 <= lo < hi <= 1.0):
        raise ValueError("goodput band must be 0 <= low < high <= 1: "
                         "%r" % (spec,))
    return lo, hi


class CandidateConfig:
    """One point in the capacity knob space.

    ``key()`` is the canonical identity (quarantine/table key);
    ``flags()`` is the re-applicable ``set_flags`` dict the artifact
    carries."""

    def __init__(self, prefill_chunk_tokens, serving_buckets,
                 serving_swap_bytes=0, collective_dtype="off",
                 goodput_band=(0.75, 0.9)):
        self.prefill_chunk_tokens = max(1, int(prefill_chunk_tokens))
        if isinstance(serving_buckets, str):
            serving_buckets = _parse_bucket_ladder(serving_buckets)
        self.serving_buckets = tuple(int(b) for b in serving_buckets)
        self.serving_swap_bytes = max(0, int(serving_swap_bytes))
        self.collective_dtype = str(collective_dtype)
        if self.collective_dtype not in _WIRE_RATIO:
            raise ValueError("unknown collective dtype %r"
                             % (collective_dtype,))
        if isinstance(goodput_band, str):
            goodput_band = _parse_band(goodput_band)
        self.goodput_band = (float(goodput_band[0]),
                             float(goodput_band[1]))

    def key(self):
        return ("chunk=%d|buckets=%s|swap=%d|dtype=%s|band=%g:%g"
                % (self.prefill_chunk_tokens,
                   ",".join(str(b) for b in self.serving_buckets),
                   self.serving_swap_bytes, self.collective_dtype,
                   self.goodput_band[0], self.goodput_band[1]))

    def flags(self):
        """The re-applicable flags dict (exactly the CAPACITY_KNOBS)."""
        return {
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "serving_buckets": ",".join(
                str(b) for b in self.serving_buckets),
            "serving_swap_bytes": self.serving_swap_bytes,
            "collective_dtype": self.collective_dtype,
            "engine_goodput_low": self.goodput_band[0],
            "engine_goodput_high": self.goodput_band[1],
        }

    def to_dict(self):
        return {
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "serving_buckets": list(self.serving_buckets),
            "serving_swap_bytes": self.serving_swap_bytes,
            "collective_dtype": self.collective_dtype,
            "goodput_band": list(self.goodput_band),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(d["prefill_chunk_tokens"], d["serving_buckets"],
                   d.get("serving_swap_bytes", 0),
                   d.get("collective_dtype", "off"),
                   tuple(d.get("goodput_band", (0.75, 0.9))))

    @classmethod
    def from_flags(cls):
        """The currently-flagged config (the tuner's 'plan' column —
        what a human hand-picked before the search ran)."""
        return cls(flag("prefill_chunk_tokens"),
                   _parse_bucket_ladder(flag("serving_buckets")),
                   flag("serving_swap_bytes"),
                   flag("collective_dtype"),
                   (float(flag("engine_goodput_low")),
                    float(flag("engine_goodput_high"))))

    def __repr__(self):
        return "CandidateConfig(%s)" % self.key()

    def __eq__(self, other):
        return isinstance(other, CandidateConfig) \
            and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())


def parse_space(spec=None):
    """Parse ``FLAGS_autotune_space`` into a knob->alternatives dict.

    Grammar: ``;``-separated ``knob=alt|alt`` clauses; ``,`` stays
    inside a bucket-ladder alternative, so alternatives are
    ``|``-separated. Knobs absent from the spec keep their
    DEFAULT_SPACE alternatives. Empty/None spec returns the default
    space."""
    space = {k: tuple(v) for k, v in DEFAULT_SPACE.items()}
    spec = (flag("autotune_space") if spec is None else spec) or ""
    for clause in str(spec).split(";"):
        clause = clause.strip()
        if not clause:
            continue
        knob, eq, alts = clause.partition("=")
        knob = knob.strip()
        if not eq or knob not in space:
            raise ValueError(
                "bad autotune space clause %r (knobs: %s)"
                % (clause, ", ".join(sorted(space))))
        vals = tuple(a.strip() for a in alts.split("|") if a.strip())
        if not vals:
            raise ValueError("empty alternatives in %r" % (clause,))
        if knob in ("chunk", "swap"):
            vals = tuple(int(v) for v in vals)
        space[knob] = vals
    return space


def enumerate_candidates(space=None):
    """The cartesian product of the knob space as CandidateConfigs."""
    if space is None or isinstance(space, str):
        space = parse_space(space)
    out = []
    for chunk, buckets, swap, dtype, band in itertools.product(
            space["chunk"], space["buckets"], space["swap"],
            space["dtype"], space["band"]):
        out.append(CandidateConfig(chunk, buckets, swap, dtype, band))
    return out


def _plan_field(plan, field, default=0.0):
    if plan is None:
        return default
    if isinstance(plan, dict):
        v = plan.get(field, default)
    else:
        v = getattr(plan, field, default)
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


class WorkloadProfile:
    """Per-token cost coefficients plus the expected packed-token
    demand the tuner prices candidates against.

    ``packed_tokens`` is a list of per-step token demands (observed
    or synthetic — e.g. the prompt-length mix divided into arrival
    waves). The per-token coefficients come from a plan made at a
    known packed size (:meth:`from_plan`)."""

    def __init__(self, packed_tokens, hbm_fixed_bytes=0.0,
                 hbm_per_token=0.0, comm_per_token=0.0,
                 wall_per_token_s=1.0, comm_s_per_byte=0.0,
                 compile_cost_s=0.0, amortize_steps=200):
        self.packed_tokens = [max(0, int(n)) for n in packed_tokens]
        if not self.packed_tokens:
            raise ValueError("packed_tokens must be non-empty")
        self.hbm_fixed_bytes = float(hbm_fixed_bytes)
        self.hbm_per_token = float(hbm_per_token)
        self.comm_per_token = float(comm_per_token)
        self.wall_per_token_s = float(wall_per_token_s)
        self.comm_s_per_byte = float(comm_s_per_byte)
        self.compile_cost_s = float(compile_cost_s)
        self.amortize_steps = max(1, int(amortize_steps))

    @classmethod
    def from_plan(cls, plan, planned_tokens, packed_tokens, **kw):
        """Derive per-token coefficients from one plan (a dict or an
        object with ``hbm_peak_bytes`` / ``comm_bytes_total``,
        duck-typed like the perf ledger) made at packed size
        ``planned_tokens``. The plan's
        peak HBM is split into a fixed part (weights/pool, taken as
        the whole peak here — conservative) plus a linear per-token
        part; comm bytes scale linearly with packed tokens, which is
        exact for the ragged attend's ring collectives."""
        planned_tokens = max(1, int(planned_tokens))
        hbm = _plan_field(plan, "hbm_peak_bytes")
        comm = _plan_field(plan, "comm_bytes_total")
        kw.setdefault("hbm_per_token", hbm / planned_tokens)
        kw.setdefault("comm_per_token", comm / planned_tokens)
        return cls(packed_tokens, **kw)

    def to_dict(self):
        return {
            "packed_tokens": list(self.packed_tokens),
            "hbm_fixed_bytes": self.hbm_fixed_bytes,
            "hbm_per_token": self.hbm_per_token,
            "comm_per_token": self.comm_per_token,
            "wall_per_token_s": self.wall_per_token_s,
            "comm_s_per_byte": self.comm_s_per_byte,
            "compile_cost_s": self.compile_cost_s,
            "amortize_steps": self.amortize_steps,
        }


def _bucket_pad(n, buckets):
    """Smallest bucket >= n (the serving bucket_packed_tokens rule);
    n above the ladder pads to the top bucket (the feed is capped at
    the chunk budget anyway)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _padded_feed(total, chunk, buckets):
    """(steps, padded_tokens) to push ``total`` demanded tokens
    through chunked prefill at ``chunk`` budget over ``buckets``."""
    cap = max(1, min(chunk, buckets[-1]))
    steps = padded = 0
    n = int(total)
    while n > 0:
        f = min(n, cap)
        padded += _bucket_pad(f, buckets)
        n -= f
        steps += 1
    return steps, padded


def static_score(candidate, profile):
    """Predicted host-seconds per useful token (lower is better).

    Three priced taxes: *padding* (bucket rounding inflates
    every packed step), *wire* (comm bytes scaled by the
    quantize-on-the-wire ratio of the candidate dtype), and
    *recompile* (one ragged program per reachable bucket, amortized
    over ``amortize_steps``)."""
    w = profile
    useful = steps = padded = 0
    reachable = set()
    for n in w.packed_tokens:
        if n <= 0:
            continue
        useful += n
        s, p = _padded_feed(n, candidate.prefill_chunk_tokens,
                            candidate.serving_buckets)
        steps += s
        padded += p
        m = n
        cap = max(1, min(candidate.prefill_chunk_tokens,
                         candidate.serving_buckets[-1]))
        while m > 0:
            reachable.add(_bucket_pad(min(m, cap),
                                      candidate.serving_buckets))
            m -= min(m, cap)
    if useful <= 0:
        return float("inf")
    work_s = padded * w.wall_per_token_s
    wire_s = (padded * w.comm_per_token
              * _WIRE_RATIO[candidate.collective_dtype]
              * w.comm_s_per_byte)
    compile_s = (len(reachable) * w.compile_cost_s
                 * max(1.0, steps / float(w.amortize_steps)))
    return (work_s + wire_s + compile_s) / useful


def check_feasible(candidate, profile, hbm_budget=None,
                   comm_budget=None):
    """(ok, why) against the device-memory and wire budgets — the gate
    that discards a candidate before it is ever deployed. Budgets
    default to ``FLAGS_jit_budget_hbm``/``_comm`` (0 = unbounded)."""
    if hbm_budget is None:
        hbm_budget = int(flag("jit_budget_hbm"))
    if comm_budget is None:
        comm_budget = int(flag("jit_budget_comm"))
    cap = max(1, min(candidate.prefill_chunk_tokens,
                     candidate.serving_buckets[-1]))
    max_padded = _bucket_pad(cap, candidate.serving_buckets)
    if hbm_budget > 0:
        peak = (profile.hbm_fixed_bytes
                + max_padded * profile.hbm_per_token)
        if peak > hbm_budget:
            return False, ("hbm-over-budget: peak %.0f > budget %d "
                           "at bucket %d" % (peak, hbm_budget,
                                             max_padded))
    if comm_budget > 0:
        wire = (max_padded * profile.comm_per_token
                * _WIRE_RATIO[candidate.collective_dtype])
        if wire > comm_budget:
            return False, ("comm-over-budget: wire %.0f > budget %d "
                           "at bucket %d" % (wire, comm_budget,
                                             max_padded))
    return True, None


class Measurement:
    """One live goodput window: what the tuner hill-climbs on.
    Missing fields mean 'no signal' — a malformed or partial fleet
    snapshot degrades to an ignored window, never a crash."""

    def __init__(self, goodput=None, step_p50_s=None,
                 drift_ratio=None, decode_tok_s=None,
                 watchdog_events=()):
        self.goodput = None if goodput is None else float(goodput)
        self.step_p50_s = (None if step_p50_s is None
                           else float(step_p50_s))
        self.drift_ratio = (None if drift_ratio is None
                            else float(drift_ratio))
        self.decode_tok_s = (None if decode_tok_s is None
                             else float(decode_tok_s))
        self.watchdog_events = tuple(watchdog_events)

    def has_signal(self):
        return any(v is not None for v in
                   (self.goodput, self.step_p50_s,
                    self.decode_tok_s))

    def to_dict(self):
        return {"goodput": self.goodput,
                "step_p50_s": self.step_p50_s,
                "drift_ratio": self.drift_ratio,
                "decode_tok_s": self.decode_tok_s,
                "watchdog_events": list(self.watchdog_events)}


def live_score(m):
    """Scalar cost of one window (lower is better), or None on no
    signal. Prefers throughput signals when present: step p50 per
    unit goodput, inflated by plan drift (a drifting config is worth
    less than its raw numbers claim)."""
    if m is None or not m.has_signal():
        return None
    drift = 1.0 + max(0.0, m.drift_ratio or 0.0)
    if m.step_p50_s is not None:
        good = m.goodput if m.goodput is not None else 1.0
        return m.step_p50_s * drift / max(good, 0.05)
    if m.decode_tok_s is not None and m.decode_tok_s > 0:
        good = m.goodput if m.goodput is not None else 1.0
        return drift / (m.decode_tok_s * max(good, 0.05))
    # goodput alone: higher goodput -> lower cost
    return drift / max(m.goodput, 0.05)


def measure_from_snapshot(snapshot, watchdog_events=()):
    """Build a Measurement from a registry snapshot (local
    ``registry.snapshot()`` or a merged fleet snapshot). Partial or
    malformed snapshots — missing namespaces, zero-wall programs,
    None histograms — degrade to no-signal fields, mirroring
    perf_ledger.rows_from_snapshot's tolerance."""
    snapshot = snapshot or {}
    serving = snapshot.get("serving", {}) or {}
    goodput = serving.get("goodput")
    try:
        goodput = None if goodput is None else float(goodput)
    except (TypeError, ValueError):
        goodput = None
    p50 = None
    hist = serving.get("step_wall_s")
    if isinstance(hist, dict):
        v = hist.get("p50")
        try:
            p50 = None if v is None else float(v)
        except (TypeError, ValueError):
            p50 = None
        if p50 is not None and p50 <= 0:
            p50 = None
    drift = None
    ledger = snapshot.get("ledger", {}) or {}
    for key, val in (ledger.items()
                     if isinstance(ledger, dict) else ()):
        if not str(key).startswith("drift_ratio."):
            continue
        try:
            v = float(val)
        except (TypeError, ValueError):
            continue
        drift = v if drift is None else max(drift, v)
    return Measurement(goodput=goodput, step_p50_s=p50,
                       drift_ratio=drift,
                       watchdog_events=watchdog_events)


def apply_config(config, scheduler=None):
    """THE capacity apply seam: set the process flags for the given
    capacity knobs and (when a live scheduler is passed) apply the
    scheduler-owned knobs to it between steps. Returns the applied
    dict. Every capacity-flag mutation in the serving layers goes
    through this function; the scheduler side (``BatchScheduler.apply_capacity_config``)
    refuses to run mid-step, so changes only ever land at step
    boundaries."""
    cfg = {k: v for k, v in dict(config).items()
           if k in CAPACITY_KNOBS}
    if not cfg:
        return {}
    set_flags(dict(cfg))
    applied = dict(cfg)
    if scheduler is not None:
        applied.update(scheduler.apply_capacity_config(cfg))
    reg = telemetry.registry()
    if reg is not None:
        reg.inc("autotune.applies")
    return applied


class Autotuner:
    """The controller. Construct with candidates and a profile, then
    either take ``best_static()`` (the static answer) or drive the
    live loop: ``start()`` deploys the static
    frontier head, each ``observe(measurement)`` accumulates one
    goodput window, and the tuner probes the frontier in static-score
    order, adopting a challenger only on a sustained
    ``min_improve`` win (hysteresis) and quarantining any candidate
    that trips a QUARANTINE_CLASSES watchdog."""

    def __init__(self, candidates=None, profile=None, apply_fn=None,
                 hbm_budget=None, comm_budget=None,
                 eval_windows=None, min_improve=None,
                 max_probes=None):
        if candidates is None:
            candidates = enumerate_candidates()
        if profile is None:
            raise ValueError("Autotuner needs a WorkloadProfile "
                             "(per-token cost coefficients)")
        self.profile = profile
        self._apply_fn = apply_fn
        self.eval_windows = max(1, int(
            flag("autotune_eval_windows") if eval_windows is None
            else eval_windows))
        self.min_improve = float(
            flag("autotune_min_improve") if min_improve is None
            else min_improve)
        self.seeded = CandidateConfig.from_flags()
        # static phase: score everything, discard infeasible points
        # before they can ever be deployed
        self.table = {}
        self.rejected = []
        frontier = []
        for c in candidates:
            ok, why = check_feasible(c, profile, hbm_budget,
                                     comm_budget)
            entry = {"candidate": c,
                     "static_score": static_score(c, profile),
                     "feasible": ok, "why_infeasible": why,
                     "live_scores": [], "live_score": None,
                     "quarantined": False, "quarantine_reason": None}
            self.table[c.key()] = entry
            if ok:
                frontier.append(entry)
            else:
                self.rejected.append(entry)
        if not frontier:
            raise ValueError("no statically feasible candidate in "
                             "the search space (budgets too tight?)")
        frontier.sort(key=lambda e: e["static_score"])
        self.frontier = frontier
        self.max_probes = (len(frontier) if max_probes is None
                           else max(1, int(max_probes)))
        self.state = "seeded"
        self.current = None          # entry under measurement
        self.incumbent = None        # best live-confirmed entry
        self._window = []
        self._probe_idx = 0
        self.switches = 0
        self.quarantined = 0
        self._publish()

    # -- static result ---------------------------------------------

    def best_static(self):
        """The static frontier head (the static answer)."""
        return self.frontier[0]["candidate"]

    # -- live loop -------------------------------------------------

    def start(self):
        """Deploy the static frontier head and enter the measuring
        state; returns the applied flags dict."""
        self.current = self.frontier[0]
        self._probe_idx = 1
        self.state = "measuring"
        applied = self._deploy(self.current["candidate"])
        self._publish()
        return applied

    def _deploy(self, candidate):
        if self._apply_fn is not None:
            return self._apply_fn(candidate.flags())
        return apply_config(candidate.flags())

    def observe(self, measurement):
        """Feed one live goodput window. Returns the (possibly
        changed) deployed candidate."""
        if self.current is None:
            raise RuntimeError("observe() before start()")
        bad = [c for c in measurement.watchdog_events
               if c in QUARANTINE_CLASSES]
        if bad:
            self._quarantine(self.current,
                             "watchdog:" + ",".join(sorted(set(bad))))
            return self.current["candidate"]
        s = live_score(measurement)
        if s is None:
            # no signal — never crash, never count the window
            return self.current["candidate"]
        self._window.append(s)
        self.current["live_scores"].append(s)
        reg = telemetry.registry()
        if reg is not None:
            reg.inc("autotune.windows")
        if len(self._window) < self.eval_windows:
            return self.current["candidate"]
        # median of the window: one outlier window cannot steer the
        # adopt/revert decision (hysteresis half 1)
        w = sorted(self._window)
        self.current["live_score"] = w[len(w) // 2]
        self._window = []
        self._decide()
        self._publish()
        return self.current["candidate"]

    def _decide(self):
        cur = self.current
        if self.incumbent is None:
            self.incumbent = cur
        elif cur is not self.incumbent:
            # challenger must beat the incumbent by the dead band to
            # be adopted (hysteresis half 2); ties/losses revert
            need = self.incumbent["live_score"] * \
                (1.0 - self.min_improve)
            if cur["live_score"] < need:
                self.incumbent = cur
                self.switches += 1
            else:
                self._redeploy(self.incumbent)
        nxt = self._next_probe()
        if nxt is None:
            self.state = "converged"
            self._redeploy(self.incumbent)
        else:
            self.state = "probing"
            self.current = nxt
            self._deploy(nxt["candidate"])

    def _redeploy(self, entry):
        if self.current is not entry:
            self.current = entry
            self._deploy(entry["candidate"])

    def _next_probe(self):
        while self._probe_idx < min(self.max_probes,
                                    len(self.frontier)):
            e = self.frontier[self._probe_idx]
            self._probe_idx += 1
            if not e["quarantined"] and e["live_score"] is None:
                return e
        return None

    def _quarantine(self, entry, reason):
        entry["quarantined"] = True
        entry["quarantine_reason"] = reason
        entry["live_score"] = None
        self.quarantined += 1
        self._window = []
        reg = telemetry.registry()
        if reg is not None:
            reg.inc("autotune.quarantines")
        if self.incumbent is entry:
            self.incumbent = None
        # revert to the best non-quarantined config we know: the
        # live incumbent if any, else the best remaining static point
        fallback = self.incumbent
        if fallback is None:
            for e in self.frontier:
                if not e["quarantined"]:
                    fallback = e
                    break
        if fallback is None:
            raise RuntimeError(
                "every candidate quarantined — watchdog storm; "
                "revert to hand-picked flags and investigate")
        self.incumbent = fallback
        self.current = fallback
        self._deploy(fallback["candidate"])
        nxt = self._next_probe()
        if nxt is None:
            self.state = "converged"
        else:
            self.state = "probing"
            self.current = nxt
            self._deploy(nxt["candidate"])
        self._publish()

    def quarantine(self, key, reason="manual"):
        """Quarantine by candidate key (ops escape hatch)."""
        entry = self.table[key]
        if not entry["quarantined"]:
            self._quarantine(entry, reason)

    # -- readout ---------------------------------------------------

    def best(self):
        """The winning entry: the live incumbent once one exists,
        else the static frontier head."""
        if self.incumbent is not None:
            return self.incumbent
        return self.frontier[0]

    def _publish(self):
        reg = telemetry.registry()
        if reg is None:
            return
        reg.gauge("autotune.state",
                  _STATE_IDS.get(self.state, -1))
        reg.gauge("autotune.frontier",
                  sum(1 for e in self.frontier
                      if not e["quarantined"]))
        best = self.best()
        score = best["live_score"]
        if score is None:
            score = best["static_score"]
        reg.gauge("autotune.best_score", float(score))

    def plan_vs_chosen(self):
        """Knob-by-knob rows: the hand-picked (seeded) flags value vs
        the tuner's chosen value — the /planz column."""
        chosen = self.best()["candidate"]
        seeded_f = self.seeded.flags()
        chosen_f = chosen.flags()
        return [{"knob": k, "plan": seeded_f[k],
                 "chosen": chosen_f[k],
                 "changed": seeded_f[k] != chosen_f[k]}
                for k in CAPACITY_KNOBS]

    def _tunez_info(self):
        """The /tunez (and /planz plan-vs-chosen) provider payload —
        plain JSON-able state, read-only."""
        best = self.best()
        rows = []
        for e in sorted(self.table.values(),
                        key=lambda e: e["static_score"]):
            rows.append({
                "key": e["candidate"].key(),
                "static_score": e["static_score"],
                "feasible": e["feasible"],
                "why_infeasible": e["why_infeasible"],
                "live_score": e["live_score"],
                "live_windows": len(e["live_scores"]),
                "quarantined": e["quarantined"],
                "quarantine_reason": e["quarantine_reason"],
                "winner": e is best,
            })
        return {
            "state": self.state,
            "eval_windows": self.eval_windows,
            "min_improve": self.min_improve,
            "switches": self.switches,
            "quarantined": self.quarantined,
            "seeded": self.seeded.to_dict(),
            "chosen": best["candidate"].to_dict(),
            "plan_vs_chosen": self.plan_vs_chosen(),
            "candidates": rows,
        }

    # -- artifact --------------------------------------------------

    def artifact(self):
        """The reproducible tuned-config JSON payload: chosen config
        + its re-applicable flags, the full scored table, rejects and
        quarantines — everything needed to audit or replay the
        decision."""
        best = self.best()
        return {
            "version": 1,
            "kind": "paddle_tpu.tuned_config",
            "state": self.state,
            "chosen": best["candidate"].to_dict(),
            "flags": best["candidate"].flags(),
            "static_score": best["static_score"],
            "live_score": best["live_score"],
            "seeded_flags": self.seeded.flags(),
            "profile": self.profile.to_dict(),
            "plan_vs_chosen": self.plan_vs_chosen(),
            "table": self._tunez_info()["candidates"],
        }

    def write_artifact(self, path=None):
        """Atomically write the artifact JSON (tmp + rename, the
        incident-bundle discipline); returns the path, or None when
        no path is configured."""
        if path is None:
            path = str(flag("autotune_artifact") or "")
        if not path:
            return None
        payload = json.dumps(self.artifact(), indent=1,
                             sort_keys=True, default=str)
        telemetry.atomic_write_text(path, payload)
        return path


def load_artifact(path):
    """Read a tuned-config artifact back; validates the envelope."""
    with open(path) as f:
        art = json.load(f)
    if art.get("kind") != "paddle_tpu.tuned_config":
        raise ValueError("%s is not a tuned-config artifact" % path)
    # round-trip the chosen config through CandidateConfig so a
    # hand-edited artifact with bad knob values fails here, not at
    # serve time
    CandidateConfig.from_dict(art["chosen"])
    return art


def apply_artifact(artifact, scheduler=None):
    """Re-apply a tuned-config artifact (dict or path) via the one
    sanctioned seam; returns the applied flags dict."""
    if isinstance(artifact, str):
        artifact = load_artifact(artifact)
    cfg = CandidateConfig.from_dict(artifact["chosen"])
    return apply_config(cfg.flags(), scheduler=scheduler)
