"""Deterministic fault-injection harness for the serving scheduler of
the port (counterpart of the reference's
``incubate/nn/fault_injection.py``, which imports no JAX; the port keeps
its own copy).

Overload survival (docs/SERVING.md "Overload behavior") is only as
good as its worst untested path. This module perturbs the
BatchScheduler at STEP BOUNDARIES only — never mid-model-call, never
inside the page pool — so every injected fault exercises exactly the
recovery machinery production overload would: preemption + tiered KV
swap, admission backpressure, and step retry/backoff. Because faults
land between steps, the greedy token streams of every surviving
request must be BIT-identical to an uninjected run (the page
sanitizer and the watchdogs referee the pool and the metrics while it
happens); tests/test_torch_fault_injection.py asserts exactly that.

Fault classes (:data:`FAULT_KINDS`):

* ``exhaust`` — the page pool reads as fully exhausted to ADMISSION
  (and swap-in) for a window of steps: queued work must wait, active
  work must keep decoding untouched.
* ``preempt_storm`` — N forced preemptions at one step regardless of
  pressure: victims swap out to host and must restore bitwise.
* ``delay_swap_in`` — swapped-out requests may not re-admit during a
  window: the scheduler must neither stall-crash nor starve them
  forever once the window lifts.
* ``fail_step`` — step attempts inside a window "fail" before the
  model call; the scheduler retries with exponential backoff — the
  first failure retries the very next step, then 1, 3, 7 skipped
  steps, capped at 8 — and resumes exactly where it stopped.

Plans are DETERMINISTIC: an explicit spec string
(``FLAGS_serving_faults``, e.g.
``"exhaust@10+5,preempt_storm@20:2,fail_step@30+3"``) or a seeded
random plan (:meth:`FaultInjector.random`,
``FLAGS_serving_fault_seed``) — same input, same schedule, always.
The injector never touches pool or scheduler state itself; the
scheduler CONSULTS it (one ``is None`` check per step when no plan is
configured) and applies the perturbation through its own public
paths. Every consultation that fires is appended to a bounded event
log (:meth:`events`) so a run is auditable after the fact.

This module is host-only (no torch, no device code).
"""
from __future__ import annotations

import collections
import random as _random
from typing import Dict, List, Optional, Tuple

from ...framework.flags import flag

__all__ = ["FaultInjector", "FAULT_KINDS", "parse_fault_plan"]

# (kind, one-line summary) — the injectable fault classes
FAULT_KINDS: Tuple[Tuple[str, str], ...] = (
    ("exhaust",
     "admission (and swap-in) sees a fully exhausted page pool for a "
     "window of steps; active decode continues untouched"),
    ("preempt_storm",
     "N forced preemptions at one step regardless of pool pressure; "
     "victims must swap out and restore bitwise"),
    ("delay_swap_in",
     "swapped-out requests may not re-admit during a window of "
     "steps"),
    ("fail_step",
     "step attempts inside a window fail before the model call; the "
     "scheduler retries with exponential backoff"),
)

_KIND_NAMES = tuple(k for k, _ in FAULT_KINDS)


def parse_fault_plan(spec: str) -> List[dict]:
    """Parse a plan spec into fault dicts
    ``{"kind", "start", "duration", "param"}``.

    Grammar (comma-separated entries)::

        kind@start            one-step fault at ``start``
        kind@start+duration   fault active for steps
                              [start, start+duration)
        kind@start:param      one-step fault with an integer param
                              (preempt_storm victim count)

    Steps count SCHEDULER ITERATIONS from 1 (the first ``step()``
    call is step 1), independent of telemetry epochs — a plan replays
    identically with telemetry off."""
    plan = []
    for entry in str(spec).replace(" ", "").split(","):
        if not entry:
            continue
        if "@" not in entry:
            raise ValueError(
                f"fault entry {entry!r} needs 'kind@step' "
                f"(kinds: {', '.join(_KIND_NAMES)})")
        kind, _, rest = entry.partition("@")
        if kind not in _KIND_NAMES:
            raise ValueError(
                f"unknown fault kind {kind!r} "
                f"(kinds: {', '.join(_KIND_NAMES)})")
        param = None
        duration = 1
        if ":" in rest:
            rest, _, p = rest.partition(":")
            param = int(p)
        if "+" in rest:
            rest, _, d = rest.partition("+")
            duration = int(d)
        start = int(rest)
        if start < 1 or duration < 1 or (param is not None
                                         and param < 1):
            raise ValueError(
                f"fault entry {entry!r}: start/duration/param must "
                "be >= 1")
        plan.append({"kind": kind, "start": start,
                     "duration": duration, "param": param})
    plan.sort(key=lambda f: (f["start"], f["kind"]))
    return plan


class FaultInjector:
    """A parsed, deterministic fault plan plus the consultation log.

    The scheduler asks one question per injection point per step;
    every answer that perturbs anything lands in the bounded event
    log. ``preempt_storm`` entries are consumed (fire once);
    window faults answer True for every step inside their window."""

    def __init__(self, plan=None, log_capacity: int = 256):
        if plan is None:
            plan = flag("serving_faults")
        if isinstance(plan, str):
            plan = parse_fault_plan(plan)
        self.plan: List[dict] = [dict(f) for f in plan]
        for f in self.plan:
            if f["kind"] not in _KIND_NAMES:
                raise ValueError(f"unknown fault kind {f['kind']!r}")
        self._consumed = [False] * len(self.plan)
        self._log = collections.deque(maxlen=max(8, log_capacity))
        self.counts: Dict[str, int] = collections.Counter()

    @classmethod
    def from_flag(cls) -> Optional["FaultInjector"]:
        """An injector for FLAGS_serving_faults, or None when the
        flag is empty (the zero-cost off mode: the scheduler holds no
        injector at all)."""
        spec = str(flag("serving_faults"))
        return cls(spec) if spec.strip() else None

    @classmethod
    def random(cls, seed: Optional[int] = None, steps: int = 200,
               n_faults: int = 8, kinds=None) -> "FaultInjector":
        """A seeded random plan over ``steps`` scheduler steps — the
        same (seed, steps, n_faults, kinds) always builds the
        IDENTICAL schedule (replayability is the whole point)."""
        rng = _random.Random(flag("serving_fault_seed")
                             if seed is None else seed)
        kinds = tuple(kinds) if kinds else _KIND_NAMES
        plan = []
        for _ in range(int(n_faults)):
            kind = rng.choice(kinds)
            start = rng.randrange(1, max(steps, 2))
            f = {"kind": kind, "start": start, "duration": 1,
                 "param": None}
            if kind in ("exhaust", "delay_swap_in", "fail_step"):
                f["duration"] = rng.randrange(1, 6)
            if kind == "preempt_storm":
                f["param"] = rng.randrange(1, 4)
            plan.append(f)
        return cls(plan)

    # -- consultation ------------------------------------------------------
    def _note(self, kind: str, step: int, **detail):
        self.counts[kind] += 1
        self._log.append({"kind": kind, "step": int(step), **detail})

    def _active(self, kind: str, step: int):
        for i, f in enumerate(self.plan):
            if f["kind"] != kind or self._consumed[i]:
                continue
            if f["start"] <= step < f["start"] + f["duration"]:
                yield i, f

    def pool_exhausted(self, step: int) -> bool:
        """True while an ``exhaust`` window covers ``step``:
        admission and swap-in must treat the pool as full."""
        for _i, f in self._active("exhaust", step):
            self._note("exhaust", step, start=f["start"],
                       duration=f["duration"])
            return True
        return False

    def forced_preemptions(self, step: int) -> int:
        """Victims to force-preempt at ``step`` (0 almost always).
        Each ``preempt_storm`` entry fires exactly once."""
        n = 0
        for i, f in self._active("preempt_storm", step):
            self._consumed[i] = True
            n += f["param"] or 1
        if n:
            self._note("preempt_storm", step, victims=n)
        return n

    def swap_in_delayed(self, step: int) -> bool:
        """True while a ``delay_swap_in`` window covers ``step``."""
        for _i, f in self._active("delay_swap_in", step):
            self._note("delay_swap_in", step, start=f["start"],
                       duration=f["duration"])
            return True
        return False

    def fail_step(self, step: int) -> bool:
        """True when a ``fail_step`` window covers ``step``: the
        scheduler must abandon the attempt BEFORE the model call and
        retry with backoff."""
        for _i, f in self._active("fail_step", step):
            self._note("fail_step", step, start=f["start"],
                       duration=f["duration"])
            return True
        return False

    # -- readout -----------------------------------------------------------
    def events(self) -> List[dict]:
        """The consultation log: every fault that actually fired, in
        order (bounded)."""
        return [dict(ev) for ev in self._log]

    def summary(self) -> dict:
        return {
            "plan": [dict(f) for f in self.plan],
            "fired": dict(sorted(self.counts.items())),
            "events": len(self._log),
        }
