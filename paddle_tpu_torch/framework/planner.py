"""Static resource planner of the port (counterpart of the reference's
``framework/planner.py``): the device-memory footprint and the flops of
every compiled program, from the program a compiled step records
(``jit/program.py``).

* **Peak live memory**: a linear-scan lifetime pass over the program's
  storages. The arguments' and the state's storages are resident, and so
  are the tensors the function closed over (consts). Each op allocates
  the new storages among its results. A view allocates nothing, and
  neither does an in-place op: that is the reference's donation alias
  (a donated state input aliased into its own output slot), which the
  port always has, since torch updates the state in place.
  Intermediates free at their last use (an operand or a result of a
  later op, a kernel op's operands included); a result no op reads
  frees at once. What the program returns, and what it leaves on the
  state (gradients), never frees.
* **Output-vs-transient breakdown**: bytes that leave the program (new
  storages it returns or leaves on the state) apart from activation
  transients that live only inside it.
* **Flops**: the matmul-class and convolution aten ops, ``2 M N K`` as
  the reference's ``_eqn_flops`` counts ``dot_general``. A kernel op
  counts 0, as a ``pallas_call`` does there.

Modes (``FLAGS_jit_plan``): ``off`` never plans; ``report`` (default)
attaches the plan to the compiled entry, emits
``compile.hbm_peak_bytes`` and hands the plan to the performance ledger;
``strict`` raises :class:`JitPlanError` at compile (before the first call
runs) on a blocking finding. Finding: ``hbm-over-budget`` (critical,
``FLAGS_jit_budget_hbm``), suppressed through the linter's three scopes.

The reference's collective fields stay empty on one card
(``comm_bytes_total == 0``); its comm rules, ``dead-collective`` and
``verify_wire_savings`` wait for the distributed slice.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from typing import Dict, List, Optional, Sequence, Tuple

from .analysis import (
    HBM_OVER_BUDGET,
    AnalysisReport,
    JitLintError,
    _flag,
    _RuleLimiter,
    resolve_suppressions,
)

_LOG = logging.getLogger("paddle_tpu_torch.jit")


class JitPlanError(JitLintError):
    """Raised under FLAGS_jit_plan=strict when a compiled program's plan
    has blocking findings (at compile, before the first call runs)."""

    def __init__(self, report: AnalysisReport):
        self.report = report
        RuntimeError.__init__(
            self,
            "jit plan (strict): %d blocking finding(s) in '%s'\n%s\n"
            "Raise the budget (FLAGS_jit_budget_hbm), suppress individual "
            "rules with FLAGS_jit_lint_suppress='<rule-id>,...' or "
            "@to_static(lint_suppress=(...)), or set FLAGS_jit_plan=report."
            % (len(report.blocking()), report.name, report.format()))


@dataclasses.dataclass
class BufferUse:
    """One program-level storage in the footprint accounting."""

    kind: str            # input | donated-input | const | output
    nbytes: int
    shape: Tuple[int, ...]
    dtype: str

    def to_dict(self) -> dict:
        return {"kind": self.kind, "nbytes": self.nbytes,
                "shape": list(self.shape), "dtype": self.dtype}


class ResourcePlan:
    """Structured result of one planner pass over a compiled program,
    with the reference's fields. ``hbm_peak_bytes`` is the linear-scan
    peak (resident storages plus live intermediates); ``input_bytes``
    the arguments and the state the program only reads;
    ``donated_bytes`` the state it writes in place (the reference's
    donated inputs); ``const_bytes`` what it closed over;
    ``output_bytes`` the new storages that leave it;
    ``transient_peak_bytes`` the peak of intermediates that do not."""

    def __init__(self, name: str, n_eqns: int = 0):
        self.name = name
        self.n_eqns = n_eqns
        self.hbm_peak_bytes = 0
        self.peak_at = ""
        self.input_bytes = 0
        self.donated_bytes = 0
        self.const_bytes = 0
        self.output_bytes = 0
        self.transient_peak_bytes = 0
        self.weak_consts_excluded = 0
        self.buffers: List[BufferUse] = []
        self.flops_total = 0.0
        # the reference's collective fields: one card moves no bytes
        self.collectives: list = []
        self.dead_collectives: list = []
        self.comm_bytes_by_axis: Dict[str, int] = {}
        self.ring_chunks_by_axis: Dict[str, int] = {}
        self.comm_bytes_total = 0
        self.comm_bytes_quantized = 0
        self.flops_per_comm_byte: Optional[float] = None

    def to_dict(self, max_buffers: int = 16) -> dict:
        bufs = sorted(self.buffers, key=lambda b: -b.nbytes)
        return {
            "program": self.name,
            "n_eqns": self.n_eqns,
            "hbm_peak_bytes": int(self.hbm_peak_bytes),
            "peak_at": self.peak_at,
            "input_bytes": int(self.input_bytes),
            "donated_bytes": int(self.donated_bytes),
            "const_bytes": int(self.const_bytes),
            "output_bytes": int(self.output_bytes),
            "transient_peak_bytes": int(self.transient_peak_bytes),
            "weak_consts_excluded": int(self.weak_consts_excluded),
            "flops_total": float(self.flops_total),
            "comm_bytes_total": int(self.comm_bytes_total),
            "comm_bytes_quantized": int(self.comm_bytes_quantized),
            "comm_bytes_by_axis": dict(self.comm_bytes_by_axis),
            "ring_chunks_by_axis": dict(self.ring_chunks_by_axis),
            "flops_per_comm_byte": self.flops_per_comm_byte,
            "collectives": list(self.collectives),
            "dead_collectives": list(self.dead_collectives),
            "largest_buffers": [b.to_dict() for b in bufs[:max_buffers]],
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def format(self) -> str:
        return "\n".join([
            "  hbm peak     %s  (at %s)" % (
                _fmt_bytes(self.hbm_peak_bytes), self.peak_at or "<entry>"),
            "  inputs       %s  (+ %s written in place)" % (
                _fmt_bytes(self.input_bytes),
                _fmt_bytes(self.donated_bytes)),
            "  consts       %s  (%d 0-d scalar(s) excluded)" % (
                _fmt_bytes(self.const_bytes), self.weak_consts_excluded),
            "  outputs      %s" % _fmt_bytes(self.output_bytes),
            "  transients   %s peak" % _fmt_bytes(
                self.transient_peak_bytes),
            "  flops        %.3g" % self.flops_total,
            "  comm         none",
        ])

    def __str__(self) -> str:
        return "ResourcePlan('%s', %d ops)\n%s" % (
            self.name, self.n_eqns, self.format())

    __repr__ = __str__


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return ("%.1f %s" if unit != "B" else "%.0f %s") % (n, unit)
        n /= 1024.0
    return "%.1f GiB" % n  # pragma: no cover


# ---------------------------------------------------------------------------
# flops (the table of the reference's _eqn_flops)
# ---------------------------------------------------------------------------

def _prod(xs) -> float:
    out = 1.0
    for x in xs:
        out *= float(x)
    return out


def op_flops(op) -> float:
    """Flops of one recorded op: ``2 M N K`` for the matmul class
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``_scaled_mm``), ``2 *
    |out| * Cin / groups * |kernel window|`` for a convolution, 0 for
    every other op and for a kernel op."""
    if op.kernel:
        return 0.0
    name = op.packet
    if name in ("mm", "_scaled_mm", "addmm", "bmm", "baddbmm"):
        a, b = ((op.operands[1], op.operands[2])
                if name in ("addmm", "baddbmm") else
                (op.operands[0], op.operands[1]))
        if len(a.shape) < 2 or len(b.shape) < 2:
            return 0.0
        batch = _prod(a.shape[:-2])
        return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]
    if name == "convolution":
        out, w = op.results[0].shape, op.operands[1].shape
        if not out or len(w) < 3:
            return 0.0
        groups = next((s for s in reversed(op.scalars)), 1) or 1
        return 2.0 * _prod(out) * float(w[1]) * _prod(w[2:]) \
            / max(int(groups), 1)
    return 0.0


# ---------------------------------------------------------------------------
# the lifetime pass (linear scan)
# ---------------------------------------------------------------------------

def _lifetime_scan(program, plan: ResourcePlan):
    nbytes = program.storage_bytes
    resident = []
    for uid in program.input_uids + program.state_uids:
        if uid not in resident:
            resident.append(uid)
    written = set()
    for op in program.ops:
        written.update(op.writes)
    refs = {}
    for op in program.ops:
        for t in op.operands + op.results:
            refs.setdefault(t.uid, t)
    state = set(program.state_uids)
    live = 0
    for uid in resident:
        nb = nbytes.get(uid, 0)
        live += nb
        t = refs.get(uid)
        shape, dtype = (t.shape, t.dtype) if t else ((), "")
        if uid in state and uid in written:
            plan.donated_bytes += nb
            plan.buffers.append(BufferUse("donated-input", nb, shape, dtype))
        else:
            plan.input_bytes += nb
            plan.buffers.append(BufferUse("input", nb, shape, dtype))
    for t in program.const_refs():
        if t.shape == ():
            plan.weak_consts_excluded += 1
            continue
        nb = nbytes.get(t.uid, t.nbytes)
        live += nb
        plan.const_bytes += nb
        plan.buffers.append(BufferUse("const", nb, t.shape, t.dtype))
        resident.append(t.uid)

    keep = set(program.output_uids) | set(program.left_uids)
    known = set(resident)
    last: Dict[int, int] = {}
    for i, op in enumerate(program.ops):
        for t in op.operands + op.results:
            last[t.uid] = i
    for uid in keep:
        if uid not in known:
            plan.output_bytes += nbytes.get(uid, 0)
            t = refs.get(uid)
            if t is not None:
                plan.buffers.append(BufferUse(
                    "output", nbytes.get(uid, 0), t.shape, t.dtype))

    peak, peak_at = live, ""
    transient = 0
    held: Dict[int, int] = {}  # allocated and not yet freed
    for i, op in enumerate(program.ops):
        for t in op.results:
            if t.uid in known:
                continue
            known.add(t.uid)
            nb = nbytes.get(t.uid, t.nbytes)
            live += nb
            held[t.uid] = nb
            if t.uid not in keep:
                transient += nb
        if live > peak:
            peak, peak_at = live, "ops[%d]:%s" % (i, op.name)
        plan.transient_peak_bytes = max(plan.transient_peak_bytes,
                                        transient)
        for t in op.operands + op.results:
            uid = t.uid
            if uid in held and last.get(uid) == i and uid not in keep:
                nb = held.pop(uid)
                live -= nb
                transient -= nb
    plan.hbm_peak_bytes = int(peak)
    plan.peak_at = peak_at


# ---------------------------------------------------------------------------
# findings and entry points
# ---------------------------------------------------------------------------

def check_plan(plan: ResourcePlan, out: _RuleLimiter):
    """The single-card planner rule, judged from a finished plan."""
    budget = int(_flag("jit_budget_hbm", 0) or 0)
    if budget and plan.hbm_peak_bytes > budget:
        out.add(
            HBM_OVER_BUDGET,
            "planned peak live device memory %s exceeds "
            "FLAGS_jit_budget_hbm %s (inputs %s + consts %s + transients "
            "%s peak)" % (
                _fmt_bytes(plan.hbm_peak_bytes), _fmt_bytes(budget),
                _fmt_bytes(plan.input_bytes + plan.donated_bytes),
                _fmt_bytes(plan.const_bytes),
                _fmt_bytes(plan.transient_peak_bytes)),
            where=plan.peak_at,
            suggestion="lower the batch or sequence, recompute the "
            "layers (LlamaConfig.recompute), or raise "
            "FLAGS_jit_budget_hbm")


def plan_program(program, *, name: str = "<program>",
                 suppress: Sequence[str] = ()
                 ) -> Tuple[ResourcePlan, AnalysisReport]:
    """Plan a recorded program: ``(ResourcePlan, AnalysisReport of the
    planner's findings)``."""
    plan = ResourcePlan(name, n_eqns=len(program.ops))
    _lifetime_scan(program, plan)
    plan.flops_total = float(sum(op_flops(op) for op in program.ops))
    report = AnalysisReport(name, n_eqns=len(program.ops))
    out = _RuleLimiter(report, resolve_suppressions(suppress))
    check_plan(plan, out)
    out.finish()
    return plan, report


def plan_static_entry(static_fn, entry, suppress: Sequence[str] = ()
                      ) -> Tuple[ResourcePlan, AnalysisReport]:
    """Plan one compiled entry of a StaticFunction (``jit/api.py``)."""
    extra = tuple(suppress) + tuple(static_fn._lint_suppress)
    return plan_program(entry.program, name=static_fn.program_name,
                        suppress=extra)


def emit_plan_report(report: AnalysisReport, mode: str):
    """Route planner findings per FLAGS_jit_plan: a debug log always, a
    warning log for criticals under 'report', JitPlanError under
    'strict' when any blocking finding survived suppression."""
    for f in report.findings:
        _LOG.debug("jit_plan[%s] %s %s: %s", report.name, f.severity,
                   f.rule, f.message)
    if mode == "strict" and report.blocking():
        raise JitPlanError(report)
    crits = report.critical()
    if crits:
        _LOG.warning(
            "jit_plan: %d CRITICAL finding(s) in compiled program '%s' "
            "(FLAGS_jit_plan=strict to fail the compile):\n%s",
            len(crits), report.name,
            "\n".join("  %s: %s" % (f.rule, f.message) for f in crits))


def live_plan_summaries() -> List[dict]:
    """Compact per-program plan summaries for every compiled
    StaticFunction alive in the process. Honors FLAGS_jit_plan=off."""
    out: List[dict] = []
    if _flag("jit_plan", "report") == "off":
        return out
    from ..jit.api import live_static_functions

    for sf in live_static_functions():
        for entry in sf._finalized_entries():
            plan = entry.resource_plan
            if plan is None:
                plan = entry.resource_plan = plan_static_entry(sf,
                                                               entry)[0]
            out.append({
                "program": plan.name,
                "hbm_peak_bytes": int(plan.hbm_peak_bytes),
                "output_bytes": int(plan.output_bytes),
                "transient_peak_bytes": int(plan.transient_peak_bytes),
                "flops_total": float(plan.flops_total),
            })
    return out
