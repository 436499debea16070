"""Trace-time program linter of the port (counterpart of the reference's
``framework/analysis.py``): hazard analysis over the program a compiled
step records (``jit/program.py``), run at every compile of
``jit.to_static`` and on demand by ``jit.analyze``.

The rules that read a single-card program, with the reference's ids and
severities:

  rule id                    severity  hazard
  -------------------------  --------  --------------------------------
  dtype-drift                warning   bf16/fp16 operand promoted to
                                       float32/float64 outside the
                                       accumulation allowlist (silent
                                       upcast)
  recompile-static-scalar    warning   python int/float argument in the
                                       cache key (a record and a capture
                                       per distinct value)
  recompile-weak-scalar      info      scalar the function closed over,
                                       baked into the program (on the
                                       card: into the captured graph)
  recompile-cache-pressure   warning   one StaticFunction holding many
                                       cache entries (spec churn)
  recompile-serving-shape    warning   cache entries whose token dim
                                       grows monotonically call to call
                                       (unbucketed-prefill signature)

and the planner's rule (``framework/planner.py``), registered here so
that the three suppression scopes cover it:

  hbm-over-budget            critical  planned peak live device memory
                                       exceeds FLAGS_jit_budget_hbm

The reference's ``donation-miss`` has no counterpart: torch updates the
state in place, and a rebound state tensor keys a new entry. Its mesh
rules (``collective-axis``, ``collective-branch``, ``unsharded-compute``,
``overlap-miss``) and its CLI wait for the distributed slice.

Modes (``FLAGS_jit_lint``): ``off`` never lints; ``warn`` (default)
logs findings (criticals as warnings, the rest at debug level);
``strict`` raises :class:`JitLintError` at compile, before the first
call runs, on any warning or critical finding.

Suppression: ``FLAGS_jit_lint_suppress="dtype-drift,..."`` globally,
``@to_static(lint_suppress=("dtype-drift",))`` per function, or
``jit.analyze(fn, suppress=(...))`` per call.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import logging
from typing import Dict, List, Sequence

SEVERITIES = ("info", "warning", "critical")

_LOG = logging.getLogger("paddle_tpu_torch.jit")


@dataclasses.dataclass(frozen=True)
class RuleDef:
    rule_id: str
    severity: str
    summary: str


RULES: Dict[str, RuleDef] = {}


def _rule(rule_id: str, severity: str, summary: str) -> str:
    RULES[rule_id] = RuleDef(rule_id, severity, summary)
    return rule_id


DTYPE_DRIFT = _rule(
    "dtype-drift", "warning",
    "bf16/fp16 operand promoted to float32/float64 outside the "
    "accumulation allowlist")
RECOMPILE_STATIC_SCALAR = _rule(
    "recompile-static-scalar", "warning",
    "python scalar argument keys the compiled-entry cache: every "
    "distinct value pays a new record and capture")
RECOMPILE_WEAK_SCALAR = _rule(
    "recompile-weak-scalar", "info",
    "scalar closed over and baked into the program (on the card, into "
    "the captured graph)")
RECOMPILE_CACHE_PRESSURE = _rule(
    "recompile-cache-pressure", "warning",
    "one compiled function holds many cache entries (input-spec churn)")
RECOMPILE_SERVING_SHAPE = _rule(
    "recompile-serving-shape", "warning",
    "a traced argument dimension grows monotonically across the "
    "function's compiled entries — the unbucketed ragged-prefill "
    "signature (every longer feed pays a fresh compile)")
HBM_OVER_BUDGET = _rule(
    "hbm-over-budget", "critical",
    "planned peak live device memory of the compiled program exceeds "
    "FLAGS_jit_budget_hbm (a planned OOM, caught at compile time)")

PLANNER_RULE_IDS = ("hbm-over-budget",)

# ops allowed to consume low precision and produce wide floats:
# accumulation (matmuls with a float32 output, reductions), as the
# reference's dot_general / reduce_* allowlist
DTYPE_ACCUM_ALLOWLIST = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "convolution", "_scaled_mm", "sum",
    "mean", "amax", "amin", "prod", "cumsum", "cumprod", "logcumsumexp",
    "norm", "linalg_vector_norm",
})

_LOW_DTYPES = ("bfloat16", "float16")
_WIDE_DTYPES = ("float32", "float64")

_MAX_PER_RULE = 8
_CACHE_PRESSURE_N = 8
_SERVING_SHAPE_N = 4


class JitLintError(RuntimeError):
    """Raised under FLAGS_jit_lint=strict when a compiled program has
    warning/critical findings (at compile, before the first call
    runs)."""

    def __init__(self, report: "AnalysisReport"):
        self.report = report
        super().__init__(
            "jit lint (strict): %d blocking finding(s) in '%s'\n%s\n"
            "Suppress individual rules with "
            "FLAGS_jit_lint_suppress='<rule-id>,...' or "
            "@to_static(lint_suppress=(...)), or set FLAGS_jit_lint=warn."
            % (len(report.blocking()), report.name, report.format()))


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str
    message: str
    where: str = ""
    suggestion: str = ""

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "severity": self.severity,
             "message": self.message}
        if self.where:
            d["where"] = self.where
        if self.suggestion:
            d["suggestion"] = self.suggestion
        return d


class AnalysisReport:
    """Structured result of one lint pass over a compiled program."""

    def __init__(self, name: str, n_eqns: int = 0):
        self.name = name
        self.n_eqns = n_eqns
        self.findings: List[Finding] = []
        self.suppressed: Dict[str, int] = {}

    def add(self, rule: str, message: str, where: str = "",
            suggestion: str = "", severity: str = ""):
        self.findings.append(Finding(
            rule, severity or RULES[rule].severity, message, where,
            suggestion))

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    def critical(self) -> List[Finding]:
        return self.by_severity("critical")

    def warnings(self) -> List[Finding]:
        return self.by_severity("warning")

    def blocking(self) -> List[Finding]:
        """Findings that fail the program under FLAGS_jit_lint=strict."""
        return [f for f in self.findings
                if f.severity in ("warning", "critical")]

    def counts(self) -> Dict[str, int]:
        c = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            c[f.severity] += 1
        return c

    def to_dict(self) -> dict:
        return {
            "program": self.name,
            "n_eqns": self.n_eqns,
            "counts": self.counts(),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": dict(self.suppressed),
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def format(self) -> str:
        if not self.findings and not self.suppressed:
            return "  (clean)"
        lines = []
        for f in self.findings:
            lines.append("  [%s] %s: %s" % (f.severity, f.rule, f.message))
            if f.where:
                lines.append("      at %s" % f.where)
            if f.suggestion:
                lines.append("      fix: %s" % f.suggestion)
        for rid, n in sorted(self.suppressed.items()):
            lines.append("  [suppressed] %s: %d finding(s)" % (rid, n))
        return "\n".join(lines)

    def __str__(self) -> str:
        c = self.counts()
        return "AnalysisReport('%s', %d ops, %d critical / %d warning " \
            "/ %d info)\n%s" % (self.name, self.n_eqns, c["critical"],
                                c["warning"], c["info"], self.format())

    __repr__ = __str__

    @classmethod
    def merge(cls, reports: Sequence["AnalysisReport"],
              name: str = "") -> "AnalysisReport":
        merged = cls(name or (reports[0].name if reports else "<empty>"))
        for r in reports:
            merged.n_eqns += r.n_eqns
            merged.findings.extend(r.findings)
            for k, v in r.suppressed.items():
                merged.suppressed[k] = merged.suppressed.get(k, 0) + v
        return merged


# ---------------------------------------------------------------------------
# suppression plumbing
# ---------------------------------------------------------------------------

def _flag(name, default=None):
    from .flags import _REGISTRY

    return _REGISTRY.get(name, default)


def resolve_suppressions(extra: Sequence[str] = ()) -> set:
    """Union of FLAGS_jit_lint_suppress and per-call suppressions.
    Unknown ids passed explicitly raise (typo guard); unknown ids in
    the flag are ignored with a debug log (env-set, can't raise)."""
    sup = set()
    for rid in (s.strip() for s in str(
            _flag("jit_lint_suppress", "") or "").split(",")):
        if not rid:
            continue
        if rid in RULES:
            sup.add(rid)
        else:
            _LOG.debug("jit_lint: unknown rule id %r in "
                       "FLAGS_jit_lint_suppress (known: %s)", rid,
                       ", ".join(sorted(RULES)))
    for rid in extra:
        if rid not in RULES:
            raise ValueError(
                "unknown lint rule id %r (known: %s)"
                % (rid, ", ".join(sorted(RULES))))
        sup.add(rid)
    return sup


class _RuleLimiter:
    """Caps per-rule findings at _MAX_PER_RULE, folding the overflow
    into one aggregate entry."""

    def __init__(self, report: AnalysisReport, suppress: set):
        self.report = report
        self.suppress = suppress
        self.counts: Dict[str, int] = {}
        self.overflow: Dict[str, int] = {}

    def add(self, rule, message, where="", suggestion="", severity=""):
        if rule in self.suppress:
            self.report.suppressed[rule] = \
                self.report.suppressed.get(rule, 0) + 1
            return
        n = self.counts.get(rule, 0)
        self.counts[rule] = n + 1
        if n < _MAX_PER_RULE:
            self.report.add(rule, message, where, suggestion, severity)
        else:
            self.overflow[rule] = self.overflow.get(rule, 0) + 1

    def finish(self):
        for rule, n in sorted(self.overflow.items()):
            self.report.add(rule, "... and %d more %s finding(s) "
                            "(first %d shown)" % (n, rule, _MAX_PER_RULE))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _where(i, op) -> str:
    return "ops[%d]:%s" % (i, op.name)


def _check_dtype_drift(program, out: _RuleLimiter):
    for i, op in enumerate(program.ops):
        if op.kernel or op.packet in DTYPE_ACCUM_ALLOWLIST:
            continue
        in_dts = {t.dtype for t in op.operands}
        if not in_dts.intersection(_LOW_DTYPES):
            continue
        out_wide = [t.dtype for t in op.results if t.dtype in _WIDE_DTYPES]
        if not out_wide:
            continue
        low = sorted(in_dts.intersection(_LOW_DTYPES))[0]
        out.add(
            DTYPE_DRIFT,
            "%s promotes %s -> %s outside the accumulation allowlist "
            "(silent upcast: 2x memory traffic on its operands)"
            % (op.name, low, out_wide[0]),
            where=_where(i, op),
            suggestion="keep the op in the low dtype, or make the "
            "widening an explicit accumulation (a reduction or matmul "
            "with a float32 output), or suppress 'dtype-drift' if "
            "intended")


_CAPTURE_NOTE = (
    "on the card the captured CUDA graph replays the value (a CPU "
    "scalar) or the address (a device tensor) the capture saw, so "
    "changing it will NOT change the compiled step; on the CPU every "
    "call reads it anew")


def _check_weak_consts(program, closed_numbers, out: _RuleLimiter):
    for t in program.const_refs():
        if t.shape != ():
            continue
        out.add(
            RECOMPILE_WEAK_SCALAR,
            "0-d %s tensor closed over and read by the program: %s"
            % (t.dtype, _CAPTURE_NOTE),
            suggestion="pass the scalar as a Tensor argument, or keep it "
            "in a tensor the step owns and update it in place")
    used = set()
    for op in program.ops:
        used.update(op.scalars)
    for name, value in closed_numbers:
        if value in used:
            out.add(
                RECOMPILE_WEAK_SCALAR,
                "python %s %r closed over as %r reached an op of the "
                "program: %s" % (type(value).__name__, value, name,
                                 _CAPTURE_NOTE),
                suggestion="pass the scalar as a Tensor argument (read on "
                "the device at every replay)")


def _check_static_scalars(static_meta, t_shapes, out: _RuleLimiter):
    dims = set()
    for shp in t_shapes or ():
        dims.update(int(d) for d in shp)
    for pos, typename, value in static_meta or ():
        if typename not in ("int", "float"):
            continue
        shape_leak = typename == "int" and value is not None \
            and int(value) in dims and int(value) > 1
        extra = (" — the value matches a traced input dimension, a "
                 "likely python-int shape leak") if shape_leak else ""
        out.add(
            RECOMPILE_STATIC_SCALAR,
            "argument leaf %d is a python %s (%r): it keys the "
            "compiled-entry cache, so every distinct value pays a new "
            "record and capture%s" % (pos, typename, value, extra),
            suggestion="pass it as a Tensor (one compile) or derive it "
            "from tensor shapes inside the function")


def _serving_shape_growth(shape_lists):
    """The unbucketed-prefill signature across a compiled function's
    entries (``shape_lists``: each entry's argument shapes, in compile
    order): ``(leaf, dim, values)`` where one dimension grew strictly
    and sub-geometrically across at least _SERVING_SHAPE_N
    structurally alike entries (a bucket ladder grows geometrically, or
    steps through ``FLAGS_serving_buckets``)."""
    try:
        sanctioned = set(int(s) for s in str(
            _flag("serving_buckets", "") or "").replace(
                " ", "").split(",") if s)
    except ValueError:
        sanctioned = set()
    groups: Dict[tuple, list] = {}
    for shapes in shape_lists:
        key = tuple(len(s) for s in shapes)
        groups.setdefault(key, []).append(shapes)
    out = []
    for rows in groups.values():
        if len(rows) < _SERVING_SHAPE_N:
            continue
        for leaf in range(len(rows[0])):
            for dim in range(len(rows[0][leaf])):
                vals = [int(r[leaf][dim]) for r in rows]
                monotone = all(a < b for a, b in zip(vals, vals[1:]))
                sub_geo = any(b < 2 * a for a, b in zip(vals, vals[1:]))
                bucketed = sanctioned and all(v in sanctioned for v in vals)
                if monotone and sub_geo and not bucketed:
                    out.append((leaf, dim, vals))
    return out


def _check_serving_shapes(static_fn, entry, out: _RuleLimiter):
    entries = static_fn._finalized_entries()
    # a function-level signature: reported on the newest entry only
    if not entries or entry is not entries[-1]:
        return
    shape_lists = [e.t_shapes for e in entries if e.t_shapes]
    for leaf, dim, vals in _serving_shape_growth(shape_lists):
        out.add(
            RECOMPILE_SERVING_SHAPE,
            "traced argument leaf %d dim %d grew monotonically across "
            "%d compiled entries (%d -> %d): the unbucketed-prefill "
            "signature — every longer token feed keys a new cache entry "
            "and pays a new record and capture"
            % (leaf, dim, len(vals), vals[0], vals[-1]),
            suggestion="pad the growing axis up to a fixed bucket set "
            "before the call (FLAGS_serving_buckets) and mask the tail")


def closed_numbers(fn) -> list:
    """``(name, value)`` of the Python ints and floats ``fn`` closes
    over (its nonlocals)."""
    target = fn.__func__ if inspect.ismethod(fn) else fn
    target = inspect.unwrap(target)
    if not inspect.isfunction(target):
        return []
    cv = inspect.getclosurevars(target)
    return [(k, v) for k, v in cv.nonlocals.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)]


def analyze_program(program, *, name: str = "<program>",
                    suppress: Sequence[str] = (), static_meta=None,
                    t_shapes=None, closed=()) -> AnalysisReport:
    """Lint a recorded program (``jit/program.Program``)."""
    report = AnalysisReport(name, n_eqns=len(program.ops))
    out = _RuleLimiter(report, resolve_suppressions(suppress))
    _check_dtype_drift(program, out)
    _check_weak_consts(program, closed, out)
    _check_static_scalars(static_meta, t_shapes, out)
    out.finish()
    return report


def lint_static_entry(static_fn, entry,
                      suppress: Sequence[str] = ()) -> AnalysisReport:
    """Lint one compiled entry of a StaticFunction (``jit/api.py``): its
    program plus the cache context only the StaticFunction knows."""
    name = static_fn.program_name
    extra = tuple(suppress) + tuple(static_fn._lint_suppress)
    report = analyze_program(
        entry.program, name=name, suppress=extra,
        static_meta=entry.static_meta, t_shapes=entry.t_shapes,
        closed=closed_numbers(static_fn._fn))
    n_entries = len(static_fn._cache)
    limiter = _RuleLimiter(report, resolve_suppressions(extra))
    if n_entries >= _CACHE_PRESSURE_N:
        limiter.add(
            RECOMPILE_CACHE_PRESSURE,
            "'%s' holds %d compiled cache entries: the cache is churning "
            "(varying shapes, python scalars, or mode flips)"
            % (name, n_entries),
            suggestion="pad inputs to bucketed shapes and pass python "
            "scalars as Tensors")
    _check_serving_shapes(static_fn, entry, limiter)
    limiter.finish()
    return report


def emit_report(report: AnalysisReport, mode: str):
    """Route a report per FLAGS_jit_lint: a debug log for everything, a
    warning log for criticals under 'warn', JitLintError under 'strict'
    when any warning/critical finding survived."""
    for f in report.findings:
        _LOG.debug("jit_lint[%s] %s %s: %s", report.name, f.severity,
                   f.rule, f.message)
    if mode == "strict" and report.blocking():
        raise JitLintError(report)
    crits = report.critical()
    if crits:
        _LOG.warning(
            "jit_lint: %d CRITICAL finding(s) in compiled program '%s' "
            "(FLAGS_jit_lint=strict to fail the compile):\n%s",
            len(crits), report.name,
            "\n".join("  %s: %s" % (f.rule, f.message) for f in crits))


def live_lint_summaries() -> List[dict]:
    """Compact per-program lint summaries for every compiled
    StaticFunction alive in the process. Honors FLAGS_jit_lint=off: no
    rows and no late lint passes."""
    out = []
    if _flag("jit_lint", "warn") == "off":
        return out
    from ..jit.api import live_static_functions

    for sf in live_static_functions():
        for entry in sf._finalized_entries():
            rep = entry.lint_report
            if rep is None:
                rep = entry.lint_report = lint_static_entry(sf, entry)
            row = {"program": rep.name, "n_eqns": rep.n_eqns}
            row.update(rep.counts())
            rules = {}
            for f in rep.findings:
                rules[f.rule] = rules.get(f.rule, 0) + 1
            if rules:
                row["rules"] = rules
            out.append(row)
    return out
