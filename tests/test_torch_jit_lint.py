"""The port's trace-time linter (``framework/analysis.py``) against the
reference's, on the CPU: the single-card hazards of
``tests/test_jit_lint.py`` (``TestDtypeDrift``, ``TestRecompileHazards``,
``TestModes``) fire with the same rule ids and severities in both
packages, and the three suppression scopes (``FLAGS_jit_lint_suppress``,
``@to_static(lint_suppress=...)``, ``analyze(..., suppress=...)``)
behave the same. Each hazard is seeded as the reference's test seeds it,
written in torch; the reference's report comes from its
``paddle.jit.analyze`` (a trace, no compile) where one is built.
"""
import contextlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle

from paddle_tpu_torch import jit
from paddle_tpu_torch.framework import analysis
from paddle_tpu_torch.framework.flags import _REGISTRY as _FLAGS
from paddle_tpu_torch.framework.flags import set_flags


@contextlib.contextmanager
def flags(**kw):
    saved = {k: _FLAGS[k] for k in kw}
    set_flags(kw)
    try:
        yield
    finally:
        set_flags(saved)


def _rules(report):
    return {f.rule for f in report.findings}


def _severities(report):
    return {(f.rule, f.severity) for f in report.findings}


def _x32(shape=(8, 8)):
    return torch.ones(shape)


def _j32(shape=(8, 8)):
    return paddle.to_tensor(np.ones(shape, np.float32))


def _same_hazards(port, ref, rules):
    """Both reports carry ``rules`` with the same severities."""
    for rule in rules:
        got = {s for r, s in _severities(port) if r == rule}
        want = {s for r, s in _severities(ref) if r == rule}
        assert got and got == want, (rule, got, want)


def _drift(x):
    return (x.float() * 2.0).sum()


def _jdrift(x):
    return (x.astype("float32") * 2.0).sum()


class TestDtypeDrift:
    def test_forced_upcast_fires(self):
        rep = jit.analyze(_drift, _x32().bfloat16())
        ref = paddle.jit.analyze(_jdrift, _j32().astype("bfloat16"))
        _same_hazards(rep, ref, ["dtype-drift"])
        f = next(f for f in rep.findings if f.rule == "dtype-drift")
        assert f.severity == "warning"
        assert "bfloat16" in f.message and "float32" in f.message

    def test_fp32_program_clean(self):
        assert "dtype-drift" not in _rules(
            jit.analyze(lambda x: (x * 2.0).sum(), _x32()))

    def test_accumulation_allowlist(self):
        # a bf16 reduction accumulating into float32 is the allowlisted
        # pattern (the reference's reduce_sum / dot_general)
        rep = jit.analyze(lambda x: x.sum(dtype=torch.float32),
                          _x32().bfloat16())
        assert "dtype-drift" not in _rules(rep)

    def test_suppression(self):
        rep = jit.analyze(_drift, _x32().bfloat16(),
                          suppress=("dtype-drift",))
        assert "dtype-drift" not in _rules(rep)
        assert rep.suppressed.get("dtype-drift", 0) >= 1

    def test_unknown_suppression_id_raises(self):
        with pytest.raises(ValueError, match="unknown lint rule"):
            jit.analyze(lambda x: x, _x32(), suppress=("not-a-rule",))


class TestRecompileHazards:
    def test_python_scalar_arg_fires(self):
        rep = jit.analyze(lambda x, k: x * k, _x32(), 3.5)
        ref = paddle.jit.analyze(lambda x, k: x * k, _j32(), 3.5)
        _same_hazards(rep, ref, ["recompile-static-scalar"])

    def test_python_int_shape_leak_flagged(self):
        rep = jit.analyze(lambda x, n: x.reshape([n, -1]), _x32((8, 4)), 8)
        f = next(f for f in rep.findings
                 if f.rule == "recompile-static-scalar")
        assert "shape leak" in f.message

    def test_weak_scalar_closure_fires(self):
        c, jc = torch.tensor(2.5), jnp.asarray(2.5)
        rep = jit.analyze(lambda x: x * c, _x32())
        ref = paddle.jit.analyze(lambda x: x * paddle.to_tensor(jc),
                                 _j32())
        _same_hazards(rep, ref, ["recompile-weak-scalar"])
        f = next(f for f in rep.findings
                 if f.rule == "recompile-weak-scalar")
        assert "CUDA graph" in f.message and "NOT change" in f.message

    def test_closed_over_python_number_fires(self):
        k = 0.375
        rep = jit.analyze(lambda x: x * k, _x32())
        f = next(f for f in rep.findings
                 if f.rule == "recompile-weak-scalar")
        assert f.severity == "info" and "'k'" in f.message

    def test_tensor_args_clean(self):
        rep = jit.analyze(lambda x, y: x * y, _x32(), _x32())
        assert "recompile-static-scalar" not in _rules(rep)
        assert "recompile-weak-scalar" not in _rules(rep)

    @staticmethod
    def _grown(lengths, **kw):
        sf = jit.to_static(lambda x: (x * 2.0).sum(), **kw)
        jsf = paddle.jit.to_static(lambda x: (x * 2.0).sum())
        for n in lengths:
            sf(_x32((1, n)))
            jsf(_j32((1, n)))
        return jit.analyze(sf), paddle.jit.analyze(jsf)

    def test_monotone_token_growth_fires_serving_shape(self):
        rep, ref = self._grown((8, 12, 16, 20))
        _same_hazards(rep, ref, ["recompile-serving-shape"])
        f = next(f for f in rep.findings
                 if f.rule == "recompile-serving-shape")
        assert "8 -> 20" in f.message and "bucket" in f.suggestion

    def test_bucketed_shapes_clean(self):
        rep, ref = self._grown((8, 16, 32, 64, 16, 8))
        assert "recompile-serving-shape" not in _rules(rep) | _rules(ref)

    def test_configured_bucket_ladder_clean_even_non_geometric(self):
        with flags(serving_buckets="8,12,16,20"):
            sf = jit.to_static(lambda x: (x * 2.0).sum())
            for n in (8, 12, 16, 20):
                sf(_x32((1, n)))
            assert "recompile-serving-shape" not in _rules(jit.analyze(sf))

    def test_few_growing_entries_clean(self):
        sf = jit.to_static(lambda x: (x * 2.0).sum())
        for n in (8, 12, 16):
            sf(_x32((1, n)))
        assert "recompile-serving-shape" not in _rules(jit.analyze(sf))

    def test_serving_shape_suppression(self):
        sf = jit.to_static(lambda x: (x * 2.0).sum(),
                           lint_suppress=("recompile-serving-shape",))
        for n in (8, 12, 16, 20):
            sf(_x32((1, n)))
        rep = jit.analyze(sf)
        assert "recompile-serving-shape" not in _rules(rep)
        assert rep.suppressed.get("recompile-serving-shape", 0) >= 1

    def test_cache_pressure(self):
        sf = jit.to_static(lambda x: (x * 2.0).sum())
        for n in range(1, 9):
            sf(_x32((n, 3)))
        f = next(f for f in jit.analyze(sf).findings
                 if f.rule == "recompile-cache-pressure")
        assert f.severity == "warning" and "8 compiled" in f.message


class TestModes:
    def test_strict_raises_at_compile_before_the_call_runs(self):
        xb = _x32().bfloat16()
        ran = []

        def step(x):
            ran.append(1)
            return _drift(x)

        with flags(jit_lint="strict"):
            sf = jit.to_static(step)
            with pytest.raises(analysis.JitLintError) as ei:
                sf(xb)
        assert "dtype-drift" in str(ei.value)
        assert ran == [1]  # the fake-tensor trace only
        assert sf._finalized_entries() == []

    def test_strict_clean_program_compiles(self):
        with flags(jit_lint="strict"):
            out = jit.to_static(lambda x: (x * 2.0).sum())(_x32())
        assert float(out) == 128.0

    def test_off_is_inert(self):
        xb = _x32().bfloat16()
        with flags(jit_lint="off"):
            sf_off = jit.to_static(_drift)
            out_off = sf_off(xb)
            entries = sf_off._finalized_entries()
            assert entries and all(e.lint_report is None for e in entries)
        with flags(jit_lint="warn"):
            sf_warn = jit.to_static(_drift)
            out_warn = sf_warn(xb)
            entries_w = sf_warn._finalized_entries()
            assert entries_w and all(e.lint_report is not None
                                     for e in entries_w)
        # the same program either way: the linter only observes
        assert [op.name for op in entries[0].program.ops] \
            == [op.name for op in entries_w[0].program.ops]
        assert torch.equal(out_off, out_warn)

    def test_warn_attaches_report_and_runs(self):
        with flags(jit_lint="warn"):
            sf = jit.to_static(_drift)
            out = sf(_x32().bfloat16())
        assert torch.isfinite(out)
        assert "dtype-drift" in _rules(jit.analyze(sf))

    def test_flag_suppression(self):
        with flags(jit_lint_suppress="dtype-drift"):
            rep = jit.analyze(_drift, _x32().bfloat16())
        assert "dtype-drift" not in _rules(rep)
        assert rep.suppressed.get("dtype-drift", 0) >= 1

    def test_three_scopes_union(self):
        sf = jit.to_static(lambda x, k: _drift(x) * k,
                           lint_suppress=("dtype-drift",))
        with flags(jit_lint_suppress="recompile-static-scalar"):
            rep = jit.analyze(sf, _x32().bfloat16(), 2.0,
                              suppress=("recompile-weak-scalar",))
        assert not _rules(rep) & {"dtype-drift", "recompile-static-scalar"}
        assert rep.suppressed.keys() >= {"dtype-drift",
                                         "recompile-static-scalar"}

    def test_report_json_roundtrip(self):
        d = json.loads(jit.analyze(_drift, _x32().bfloat16()).to_json())
        assert d["program"] and d["n_eqns"] > 0
        assert d["counts"]["warning"] >= 1
        assert any(f["rule"] == "dtype-drift" for f in d["findings"])

    def test_analyze_without_args_needs_compiled(self):
        with pytest.raises(ValueError, match="example"):
            jit.analyze(jit.to_static(lambda x: x + 1.0))

    def test_analyze_returns_report_under_strict(self):
        with flags(jit_lint="strict"):
            rep = jit.analyze(_drift, _x32().bfloat16())
        assert "dtype-drift" in _rules(rep)

    def test_strict_lints_entries_compiled_under_off(self):
        xb = _x32().bfloat16()
        sf = jit.to_static(_drift)
        with flags(jit_lint="off"):
            sf(xb)
        with flags(jit_lint="strict"):
            with pytest.raises(analysis.JitLintError):
                sf(xb)

    def test_live_summaries_inert_under_off(self):
        sf = jit.to_static(lambda x: (x * 3.0).sum())
        with flags(jit_lint="off"):
            sf(_x32())
            assert analysis.live_lint_summaries() == []

    def test_rule_table_ids_and_severities_are_the_reference_s(self):
        from paddle_tpu.framework import analysis as jax_analysis

        for rid, rule in analysis.RULES.items():
            assert jax_analysis.RULES[rid].severity == rule.severity, rid
