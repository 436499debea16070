"""The port's static resource planner (``framework/planner.py``) against
the reference's, on the CPU.

The golden programs of ``tests/test_jit_plan.py::TestLifetimeGolden``
are replayed in torch: each is planned by the port through ``jit.plan``
(recorded on fake tensors: nothing runs) and by the reference through
``planner.plan_jaxpr`` over ``jax.make_jaxpr`` of the same program, and
the numbers must be equal. Where the reference donates an input, the
port writes state in place (its only kind of donation); where the
reference keeps an undonated input, so does the port, which never frees
an argument (the caller holds it).

The ``llama_tiny`` train step's ``flops_total`` is held to the
reference's, exactly, once the terms the port's program does not hold
are added (each stated at its test). The modes and the
``hbm-over-budget`` rule follow ``TestModes`` and ``TestPlannerRules``.
"""
import contextlib
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import analysis as jax_analysis
from paddle_tpu.framework import planner as jax_planner

from paddle_tpu_torch import jit
from paddle_tpu_torch.framework import planner
from paddle_tpu_torch.framework.flags import _REGISTRY as _FLAGS
from paddle_tpu_torch.framework.flags import set_flags

U = 256 * 256 * 4  # bytes of one (256, 256) float32 buffer
FIELDS = ("hbm_peak_bytes", "input_bytes", "donated_bytes", "const_bytes",
          "output_bytes", "transient_peak_bytes", "weak_consts_excluded",
          "flops_total", "comm_bytes_total")


@contextlib.contextmanager
def flags(**kw):
    saved = {k: _FLAGS[k] for k in kw}
    set_flags(kw)
    try:
        yield
    finally:
        set_flags(saved)


def _ones(shape=(256, 256)):
    return torch.ones(shape)


def _jones(shape=(256, 256)):
    return jnp.ones(shape, jnp.float32)


def _equal_fields(port, ref, fields=FIELDS):
    for f in fields:
        assert getattr(port, f) == getattr(ref, f), \
            (f, getattr(port, f), getattr(ref, f))


def _rules(report):
    return {f.rule for f in report.findings}


# ---------------------------------------------------------------------------
# golden values: the lifetime pass, equal to the reference's plans
# ---------------------------------------------------------------------------

class TestLifetimeGolden:
    def test_matmul_add_peak(self):
        port = jit.plan(lambda a, b: (a @ b) + a, _ones(), _ones())
        ref, _ = jax_planner.plan_jaxpr(
            jax.make_jaxpr(lambda a, b: (a @ b) + a)(_jones(), _jones()),
            name="golden")
        _equal_fields(port, ref)
        assert port.hbm_peak_bytes == 4 * U
        assert port.input_bytes == 2 * U
        assert port.output_bytes == U
        assert port.transient_peak_bytes == U
        assert port.flops_total == 2.0 * 256 ** 3
        assert port.comm_bytes_total == 0
        assert port.flops_per_comm_byte is None is ref.flops_per_comm_byte

    def test_in_place_state_update_is_the_donation_alias(self):
        # the reference's s' = s + g with s donated and aliased into its
        # own output slot; the port's s.add_(g) on a state tensor: the
        # update allocates nothing, peak 2 buffers
        closed = jax.make_jaxpr(lambda s, g: s + g)(_jones(), _jones())
        ref, _ = jax_planner.plan_jaxpr(closed, name="donated",
                                        donated_invars=(0,),
                                        alias_out_to_in={0: 0})
        holder = torch.nn.Module()
        holder.register_buffer("s", _ones())

        def update(g):
            holder.s.add_(g)

        port = jit.plan(update, _ones())
        _equal_fields(port, ref)
        assert port.hbm_peak_bytes == 2 * U
        assert port.donated_bytes == U and port.output_bytes == 0

    def test_arguments_stay_resident(self):
        # the reference frees a DONATED input at its last use (3 U); the
        # port never frees an argument, as the reference's undonated plan
        # (4 U)
        def f(a, b):
            t = a * 2.0
            return t + b

        closed = jax.make_jaxpr(f)(_jones(), _jones())
        plain, _ = jax_planner.plan_jaxpr(closed, name="plain")
        port = jit.plan(f, _ones(), _ones())
        _equal_fields(port, plain)
        assert port.hbm_peak_bytes == 4 * U

    def test_alias_dedup_and_passthrough(self):
        ref, _ = jax_planner.plan_jaxpr(
            jax.make_jaxpr(lambda x: (x, x * 2.0, x))(_jones()), name="d")
        port = jit.plan(lambda x: (x, x * 2.0, x), _ones())
        _equal_fields(port, ref)
        assert port.output_bytes == U and port.hbm_peak_bytes == 2 * U

    def test_weak_const_excluded(self):
        weak, wide = jnp.asarray(2.5), jnp.ones((16, 16), jnp.float32)
        ref, _ = jax_planner.plan_jaxpr(jax.make_jaxpr(
            lambda x: x * weak + wide)(jnp.ones((16, 16), jnp.float32)),
            name="consts")
        c, twide = torch.tensor(2.5), torch.ones(16, 16)
        port = jit.plan(lambda x: x * c + twide, torch.ones(16, 16))
        # the reference converts its weak scalar to a strong f32[] first,
        # a 4-byte intermediate that torch's wrapped scalar never makes
        _equal_fields(port, ref, [f for f in FIELDS
                                  if f != "transient_peak_bytes"])
        assert port.transient_peak_bytes == ref.transient_peak_bytes - 4
        assert port.weak_consts_excluded == 1
        assert port.const_bytes == 16 * 16 * 4

    def test_intermediate_freed_at_last_use(self):
        def f(x):
            for _ in range(8):
                x = x * 1.5
            return x

        ref, _ = jax_planner.plan_jaxpr(jax.make_jaxpr(f)(_jones()),
                                        name="chain")
        port = jit.plan(f, _ones())
        _equal_fields(port, ref)
        assert port.hbm_peak_bytes == 3 * U

    def test_to_dict_roundtrip(self):
        port = jit.plan(lambda a, b: (a @ b) + a, _ones(), _ones())
        d = json.loads(port.to_json())
        assert d["hbm_peak_bytes"] == 4 * U
        assert d["program"] == "<lambda>"
        assert {b["kind"] for b in d["largest_buffers"]} >= {"input",
                                                            "output"}
        ref, _ = jax_planner.plan_jaxpr(
            jax.make_jaxpr(lambda a, b: (a @ b) + a)(_jones(), _jones()))
        assert set(d) == set(ref.to_dict())


# ---------------------------------------------------------------------------
# the llama_tiny train step's flops against the reference's
# ---------------------------------------------------------------------------

def _ref_train_step(cfg_kw, b, s):
    import paddle_tpu as paddle
    import paddle_tpu.optimizer as jax_optim
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models import llama_tiny as jax_tiny

    paddle.seed(0)
    model = JaxLlama(jax_tiny(**cfg_kw))
    opt = jax_optim.AdamW(1e-3, parameters=model.parameters())

    @paddle.jit.to_static
    def step(x, y):
        _, loss = model(x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    rng = np.random.RandomState(0)
    x = rng.randint(0, model.config.vocab_size, (b, s)).astype("int32")
    y = rng.randint(0, model.config.vocab_size, (b, s)).astype("int64")
    plan = paddle.jit.plan(step, paddle.to_tensor(x), paddle.to_tensor(y))
    return plan, step._finalized_entries()[0]["pruned_jaxpr"], x, y


def test_llama_tiny_train_step_flops_match_the_reference():
    """The reference's jaxpr holds three matmul terms the port's program
    does not: (1) attention, which its CPU route expands into
    ``dot_general``s, where the port's flash kernels are kernel ops
    (counting 0, as ``pallas_call`` does); (2) every linear's forward
    matmul once more, re-traced by its tape's vjp (XLA CSEs it away);
    (3) the fused CE head's forward chunk once more, re-run by its
    ``custom_vjp`` for the residuals. (1) is summed from the
    reference's own attention-shaped ``dot_general``s ([B * heads, S,
    .]); (2) and (3) are closed forms of the config."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.optimizer import AdamW

    b, s = 2, 16
    cfg_kw = dict(fused_head_loss=True)
    ref, jaxpr, x, y = _ref_train_step(cfg_kw, b, s)
    model = LlamaForCausalLM(llama_tiny(**cfg_kw), device="cpu")
    opt = AdamW(1e-3, parameters=model.parameters())

    def step(x, y):
        _, loss = model(x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    port = jit.plan(step, torch.from_numpy(x), torch.from_numpy(y))
    cfg = model.config
    heads = b * cfg.num_attention_heads
    attention = sum(
        jax_analysis._eqn_flops(eqn)
        for eqn, _, _ in jax_analysis._walk(jaxpr.jaxpr)
        if eqn.primitive.name == "dot_general"
        and jax_analysis._aval_shape(eqn.invars[0])[:1] == (heads,))
    t, h, i = b * s, cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    linears = cfg.num_hidden_layers * 2.0 * t * (
        2 * h * h + 2 * h * kv + 3 * h * i)
    ce_chunk = 2.0 * (t - b) * h * cfg.vocab_size
    assert attention > 0
    assert port.flops_total + attention + linears + ce_chunk \
        == ref.flops_total


# ---------------------------------------------------------------------------
# modes and the hbm-over-budget rule
# ---------------------------------------------------------------------------

def _x(shape=(64, 64)):
    return torch.ones(shape)


class TestPlannerRules:
    def test_hbm_over_budget_strict_raises_at_compile(self):
        with flags(jit_plan="strict", jit_budget_hbm=64):
            x = _x()
            ran = []
            sf = jit.to_static(lambda x: ran.append(1) or (x * 2.0).sum())
            with pytest.raises(planner.JitPlanError) as ei:
                sf(x)
        assert "hbm-over-budget" in str(ei.value)
        assert "FLAGS_jit_budget_hbm" in str(ei.value)
        f = ei.value.report.findings[0]
        assert f.severity == "critical"
        assert ran == [1]  # traced on fake tensors only: no real call

    def test_report_mode_never_raises(self):
        with flags(jit_plan="report", jit_budget_hbm=64):
            sf = jit.to_static(lambda x: (x * 2.0).sum())
            out = sf(_x())
        assert torch.isfinite(out)
        rep = sf._finalized_entries()[0].plan_report
        assert "hbm-over-budget" in _rules(rep)

    def test_budget_zero_disables(self):
        with flags(jit_plan="strict", jit_budget_hbm=0):
            jit.to_static(lambda x: (x * 2.0).sum())(_x())

    def test_global_flag_suppression(self):
        with flags(jit_plan="strict", jit_budget_hbm=64,
                   jit_lint_suppress="hbm-over-budget"):
            sf = jit.to_static(lambda x: (x * 3.0).sum())
            sf(_x())
        rep = sf._finalized_entries()[0].plan_report
        assert rep.suppressed.get("hbm-over-budget", 0) >= 1

    def test_per_function_suppression(self):
        with flags(jit_plan="strict", jit_budget_hbm=64):
            jit.to_static(lambda x: (x * 4.0).sum(),
                          lint_suppress=("hbm-over-budget",))(_x())

    def test_single_card_plans_no_wire(self):
        port = jit.plan(lambda x: (x * 2.0).sum(), _x())
        assert port.collectives == [] and port.comm_bytes_by_axis == {}
        assert port.comm_bytes_total == 0 and port.dead_collectives == []


class TestModes:
    def test_off_mode_attaches_nothing(self):
        with flags(jit_plan="off"):
            sf = jit.to_static(lambda x: (x * 2.0).sum())
            sf(_x())
            entries = sf._finalized_entries()
            assert entries and all(e.resource_plan is None
                                   for e in entries)
            assert planner.live_plan_summaries() == []

    def test_report_mode_attaches_plan(self):
        with flags(jit_plan="report"):
            sf = jit.to_static(lambda x: (x * 2.0).sum())
            sf(_x())
        plan = sf._finalized_entries()[0].resource_plan
        assert plan.hbm_peak_bytes > 0
        assert any(r["program"] == "<lambda>"
                   and r["hbm_peak_bytes"] == plan.hbm_peak_bytes
                   for r in planner.live_plan_summaries())

    def test_plan_api_on_compiled_variants(self):
        sf = jit.to_static(lambda x: (x * 2.0).sum())
        sf(_x((4, 4)))
        sf(_x((8, 8)))
        plans = jit.plan(sf)
        assert isinstance(plans, list) and len(plans) == 2
        assert {p.input_bytes for p in plans} == {64, 256}

    def test_plan_api_without_args_needs_compiled(self):
        with pytest.raises(ValueError, match="example"):
            jit.plan(jit.to_static(lambda x: x + 1.0))

    def test_plan_runs_even_under_flag_off(self):
        with flags(jit_plan="off"):
            assert jit.plan(lambda x: (x * 2.0).sum(), _x()) \
                .hbm_peak_bytes > 0

    def test_state_step_plan(self):
        # the SGD-free counterpart of the reference's donated-state step:
        # a Linear trained by AdamW, its state written in place
        from paddle_tpu_torch.optimizer import AdamW

        model = torch.nn.Linear(32, 32)
        opt = AdamW(0.1, parameters=model.parameters())

        def step(x):
            loss = (model(x) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        plan = jit.plan(step, _x((4, 32)))
        param_bytes = sum(p.numel() * 4 for p in model.parameters())
        # parameters and both moments are written in place
        assert plan.donated_bytes >= 3 * param_bytes
        assert plan.hbm_peak_bytes >= plan.donated_bytes + plan.input_bytes
        assert plan.output_bytes == 4  # the loss
        # the forward and the weight gradient (x needs no gradient)
        assert plan.flops_total == 2 * 2.0 * 4 * 32 * 32


def test_the_autotuner_profile_reads_a_port_plan():
    from paddle_tpu_torch.framework.autotuner import WorkloadProfile

    plan = jit.plan(lambda a, b: (a @ b) + a, _ones(), _ones())
    prof = WorkloadProfile.from_plan(plan, planned_tokens=256,
                                     packed_tokens=[256])
    assert prof.hbm_per_token == 4 * U / 256
    assert prof.comm_per_token == 0.0
