"""The port's LR schedulers, gradient clips, regularizers, parameter
groups and ParamAttr rates against the JAX package's, on the CPU.

Schedulers are host Python in both packages: each of the fifteen steps
12 times beside the reference's, and the learning rates are equal to
1e-12 (relative), through a ``state_dict`` round trip too. The clips get
the same numpy gradients (seeded): clipped gradients within 1e-6
relative (float32 norms summed in another order). AdamW with a
scheduler, a global-norm clip, ``L2Decay``, two parameter groups and a
``ParamAttr`` rate on the final norm takes four steps on ``llama_tiny``
beside the reference's, both fed the JAX model's gradients: parameters
and moments within 1e-6 relative + 1e-7 (as tests/test_torch_optimizer.py).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.clip as jclip
import paddle_tpu.optimizer as jax_optim
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu.nn import RMSNorm as JaxRMSNorm
from paddle_tpu.nn.param_attr import ParamAttr as JaxParamAttr
from paddle_tpu.regularizer import L1Decay as JaxL1
from paddle_tpu.regularizer import L2Decay as JaxL2

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.clip as tclip
import paddle_tpu_torch.optimizer.lr as tlr
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import ParamAttr
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

STEPS = 12


def _lam(e):
    return 0.95 ** e


# (name, constructor arguments, step() arguments of each step or None)
SCHEDULERS = [
    ("NoamDecay", dict(d_model=64, warmup_steps=4, learning_rate=2.0)),
    ("PiecewiseDecay", dict(boundaries=[3, 7], values=[0.1, 0.05, 0.01])),
    ("NaturalExpDecay", dict(learning_rate=0.5, gamma=0.1)),
    ("InverseTimeDecay", dict(learning_rate=0.5, gamma=0.2)),
    ("PolynomialDecay", dict(learning_rate=0.5, decay_steps=5,
                             end_lr=0.01, power=2.0)),
    ("PolynomialDecay", dict(learning_rate=0.5, decay_steps=5,
                             end_lr=0.01, power=1.0, cycle=True)),
    ("LinearWarmup", dict(learning_rate=0.3, warmup_steps=4, start_lr=0.0,
                          end_lr=0.3)),
    ("LinearWarmup", dict(learning_rate="cosine", warmup_steps=3,
                          start_lr=0.01, end_lr=0.1)),
    ("ExponentialDecay", dict(learning_rate=0.5, gamma=0.9)),
    ("MultiStepDecay", dict(learning_rate=0.5, milestones=[2, 5, 9],
                            gamma=0.5)),
    ("StepDecay", dict(learning_rate=0.5, step_size=3, gamma=0.7)),
    ("LambdaDecay", dict(learning_rate=0.5, lr_lambda=_lam)),
    ("CosineAnnealingDecay", dict(learning_rate=0.5, T_max=7,
                                  eta_min=0.01)),
    ("CosineAnnealingWarmRestarts", dict(learning_rate=0.5, T_0=3,
                                         T_mult=2, eta_min=0.01)),
    ("ReduceOnPlateau", dict(learning_rate=0.5, factor=0.5, patience=1,
                             cooldown=1)),
    ("ReduceOnPlateau", dict(learning_rate=0.5, mode="max", patience=0,
                             threshold_mode="abs", min_lr=0.1)),
    ("OneCycleLR", dict(max_learning_rate=0.5, total_steps=10)),
    ("OneCycleLR", dict(max_learning_rate=0.5, total_steps=10,
                        anneal_strategy="linear", phase_pct=0.4)),
    ("CyclicLR", dict(base_learning_rate=0.1, max_learning_rate=0.5,
                      step_size_up=3)),
    ("CyclicLR", dict(base_learning_rate=0.1, max_learning_rate=0.5,
                      step_size_up=2, step_size_down=3, mode="triangular2")),
    ("CyclicLR", dict(base_learning_rate=0.1, max_learning_rate=0.5,
                      step_size_up=2, mode="exp_range", exp_gamma=0.9)),
]
IDS = [f"{n}{i}" for i, (n, _) in enumerate(SCHEDULERS)]
METRICS = [5.0, 4.0, 4.0, 4.5, 3.0, 3.0, 3.0, 3.2, 2.0, 2.5, 2.5, 2.5]


def _make(mod, name, kw):
    kw = dict(kw)
    if kw.get("learning_rate") == "cosine":
        kw["learning_rate"] = mod.CosineAnnealingDecay(0.1, T_max=4)
    return getattr(mod, name)(**kw)


def _step(s, name, e):
    if name == "ReduceOnPlateau":
        s.step(METRICS[e] if e % 4 != 3 else None)
    else:
        s.step()


def _close(a, b):
    assert a == pytest.approx(b, rel=1e-12, abs=1e-15)


def test_every_scheduler_is_covered():
    names = {n for n, _ in SCHEDULERS}
    assert len(names) == 15
    assert names == {n for n in dir(tlr) if n[0].isupper()} - {"LRScheduler"}


@pytest.mark.parametrize("name,kw", SCHEDULERS, ids=IDS)
def test_scheduler_follows_the_reference(name, kw):
    js, ts = _make(jlr, name, kw), _make(tlr, name, kw)
    assert ts.last_epoch == js.last_epoch == (
        -1 if name == "ReduceOnPlateau" else 0) + (
        1 if name == "ReduceOnPlateau" else 0)
    _close(ts(), js())
    for e in range(STEPS):
        _step(js, name, e)
        _step(ts, name, e)
        _close(ts(), js())
        _close(ts.last_lr, js.last_lr)
        assert ts.last_epoch == js.last_epoch


@pytest.mark.parametrize("name,kw", SCHEDULERS, ids=IDS)
def test_scheduler_state_dict_round_trip(name, kw):
    js, ts = _make(jlr, name, kw), _make(tlr, name, kw)
    for e in range(5):
        _step(js, name, e)
        _step(ts, name, e)
    sd = ts.state_dict()
    assert sd == js.state_dict()
    assert "_bound" not in sd and "lr_lambda" not in sd
    fresh, jfresh = _make(tlr, name, kw), _make(jlr, name, kw)
    fresh.set_state_dict(sd)
    jfresh.set_dict(js.state_dict())
    _close(fresh(), jfresh())
    for e in range(5, STEPS):
        _step(fresh, name, e)
        _step(jfresh, name, e)
        _close(fresh(), jfresh())


def test_scheduler_steps_to_an_epoch():
    js, ts = jlr.StepDecay(0.5, 2), tlr.StepDecay(0.5, 2)
    js.step(epoch=7)
    ts.step(epoch=7)
    assert ts.last_epoch == 7
    _close(ts(), js())
    js.step(torch.tensor(1.0).item())
    ts.step(1.0)
    _close(ts(), js())


def test_plateau_reads_a_tensor_metric():
    js, ts = jlr.ReduceOnPlateau(0.5, patience=0), \
        tlr.ReduceOnPlateau(0.5, patience=0)
    for m in (3.0, 3.0, 3.0):
        js.step(paddle.to_tensor(np.float32(m)))
        ts.step(torch.tensor(m))
    _close(ts(), js())
    assert ts() < 0.5


def test_optimizer_reads_its_scheduler():
    p = torch.nn.Parameter(torch.ones(3))
    sched = tlr.StepDecay(0.5, step_size=2, gamma=0.1)
    o = AdamW(sched, parameters=[p], weight_decay=0.0)
    assert o.get_lr() == 0.5
    for want in (0.5, 0.5, 0.05):
        p.grad = torch.ones(3)
        before = p.detach().clone()
        o.step()
        # (constant gradients: m_hat = 1 and v_hat = 1, up to float32
        # rounding of the bias corrections)
        assert torch.allclose(before - p.detach(), torch.full((3,), want),
                              rtol=1e-4)
        sched.step()
        assert o._learning_rate == sched()
    o2 = AdamW(0.1, parameters=[torch.nn.Parameter(torch.ones(3))])
    o2.set_lr_scheduler(tlr.ExponentialDecay(0.3, 0.5))
    assert o2.get_lr() == 0.3 and o2._learning_rate == 0.3


# -- clips ---------------------------------------------------------------

SHAPES = [(4, 3), (5,), (2, 2, 3), (6,)]


def _grads(seed, dtype="float32", scale=1.0):
    rng = np.random.RandomState(seed)
    gs = [rng.randn(*s).astype(np.float32) * scale for s in SHAPES]
    jp = []
    for g in gs:
        p = paddle.create_parameter(list(g.shape), "float32")
        p._data = jnp.zeros(g.shape, jnp.float32)
        jp.append(p)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jpairs = [(p, paddle.Tensor(jnp.asarray(g).astype(jdt)))
              for p, g in zip(jp, gs)]
    tp = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    tpairs = [(p, torch.from_numpy(g).to(getattr(torch, dtype)))
              for p, g in zip(tp, gs)]
    return jpairs, tpairs


def _grads_close(tpairs, jpairs, rtol=1e-6):
    for (_, tg), (_, jg) in zip(tpairs, jpairs):
        want = np.asarray(jg._data.astype(jnp.float32))
        got = tg.float().numpy()
        assert str(tg.dtype) == f"torch.{jg._data.dtype}"
        assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(),
                                                      1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [0.5, 1e3])
@pytest.mark.parametrize("skip", [False, True])
def test_global_norm_clip_matches(clip_norm, skip, dtype):
    jpairs, tpairs = _grads(0, dtype)
    if skip:  # the third gradient takes no part: not summed, not scaled
        jpairs[2][0].need_clip = False
        tpairs[2][0].need_clip = False
    jout = jclip.ClipGradByGlobalNorm(clip_norm)(jpairs)
    tout = tclip.ClipGradByGlobalNorm(clip_norm)(tpairs)
    # bf16: the scaled float32 values round to bf16, where one ulp of the
    # scale can move a value one bf16 ulp
    _grads_close(tout, jout, rtol=1e-6 if dtype == "float32" else 2 ** -7)
    if skip:
        assert tout[2][1] is tpairs[2][1]
    sq = tclip.ClipGradByGlobalNorm(clip_norm)._global_norm_sq(tpairs)
    jsq = jclip.ClipGradByGlobalNorm(clip_norm)._global_norm_sq(jpairs)
    assert float(sq) == pytest.approx(float(jsq), rel=1e-6)
    # the inputs are left as they were
    np.testing.assert_array_equal(
        tpairs[0][1].float().numpy(),
        np.asarray(jpairs[0][1]._data.astype(jnp.float32)))


@pytest.mark.parametrize("chunk", [1, 7, 40])
def test_global_norm_clip_in_chunks_matches(chunk, monkeypatch):
    # the scaling runs a chunk of gradients at a time (SCALE_CHUNK
    # elements): each chunking gives the unchunked clip's values exactly
    jpairs, tpairs = _grads(2)
    whole = tclip.ClipGradByGlobalNorm(0.5)(tpairs)
    monkeypatch.setattr(tclip, "SCALE_CHUNK", chunk)
    parts = tclip.ClipGradByGlobalNorm(0.5)(tpairs)
    for (_, a), (_, b) in zip(whole, parts):
        assert torch.equal(a, b)
    _grads_close(parts, jclip.ClipGradByGlobalNorm(0.5)(jpairs))


def test_global_norm_clip_without_grads_is_a_no_op():
    p = torch.nn.Parameter(torch.zeros(2))
    pairs = [(p, None)]
    assert tclip.ClipGradByGlobalNorm(1.0)(pairs) == pairs


@pytest.mark.parametrize("clip", [
    lambda m: m.ClipGradByNorm(0.8), lambda m: m.ClipGradByNorm(1e3),
    lambda m: m.ClipGradByValue(0.3), lambda m: m.ClipGradByValue(0.5, -0.1),
], ids=["norm", "norm_wide", "value", "value_asym"])
def test_per_tensor_clips_match(clip):
    jpairs, tpairs = _grads(1)
    _grads_close(clip(tclip)(tpairs), clip(jclip)(jpairs))


@pytest.mark.parametrize("clip", [
    lambda m: m.ClipGradByNorm(0.1), lambda m: m.ClipGradByValue(0.1),
], ids=["norm", "value"])
def test_per_tensor_clips_honour_need_clip(clip):
    # upstream Paddle's behaviour; the reference clips these anyway
    # (ROADMAP queue 3)
    jpairs, tpairs = _grads(2)
    tpairs[1][0].need_clip = False
    tout = clip(tclip)(tpairs)
    assert tout[1][1] is tpairs[1][1]
    rest = [i for i in range(len(SHAPES)) if i != 1]
    jout = clip(jclip)(jpairs)
    _grads_close([tout[i] for i in rest], [jout[i] for i in rest])


@pytest.mark.parametrize("norm_type", [2.0, 1.0, 3.0, float("inf")])
@pytest.mark.parametrize("max_norm", [0.7, 1e3])
def test_clip_grad_norm_matches(norm_type, max_norm):
    jpairs, tpairs = _grads(3)
    jp, tp = [p for p, _ in jpairs], [p for p, _ in tpairs]
    for (p, g), (q, h) in zip(jpairs, tpairs):
        p.grad = g
        q.grad = h.clone()
    jt = jclip.clip_grad_norm_(jp, max_norm, norm_type)
    tt = tclip.clip_grad_norm_(tp, max_norm, norm_type)
    assert float(tt) == pytest.approx(float(np.asarray(jt._data)), rel=1e-6)
    _grads_close([(q, q.grad) for q in tp], [(p, p.grad) for p in jp])
    single = torch.nn.Parameter(torch.zeros(2))
    assert float(tclip.clip_grad_norm_(single, 1.0)) == 0.0
    # bf16 gradients: the norm in float32, the scaled gradients rounded
    # back to bf16 once; at norm types 2 and inf the reference's bits
    jpairs, tpairs = _grads(3, "bfloat16")
    jp = [p for p, _ in jpairs]
    tp = [torch.nn.Parameter(torch.zeros(h.shape, dtype=torch.bfloat16))
          for _, h in tpairs]
    for (p, g), q, (_, h) in zip(jpairs, tp, tpairs):
        p.grad = g
        q.grad = h.clone()
    jt = jclip.clip_grad_norm_(jp, max_norm, norm_type)
    tt = tclip.clip_grad_norm_(tp, max_norm, norm_type)
    assert float(tt) == pytest.approx(float(np.asarray(jt._data)), rel=1e-6)
    for p, q in zip(jp, tp):
        assert q.grad.dtype == torch.bfloat16
        want = np.asarray(p.grad._data.astype(jnp.float32))
        if norm_type in (2.0, float("inf")):
            np.testing.assert_array_equal(q.grad.float().numpy(), want)
        else:   # a float32 norm an ulp apart may round a value apart
            np.testing.assert_allclose(q.grad.float().numpy(), want,
                                       rtol=2.0 ** -8, atol=0)


# -- regularizers and ParamAttr --------------------------------------------

def test_regularizers_carry_their_coefficient():
    for mine, ref in ((L2Decay(0.01), JaxL2(0.01)),
                      (L1Decay(0.2), JaxL1(0.2))):
        assert mine._coeff == ref._coeff and float(mine) == float(ref)
    assert L2Decay()._coeff == 0.0
    o = AdamW(0.1, parameters=[torch.nn.Parameter(torch.ones(1))],
              weight_decay=L2Decay(0.03))
    assert o._decay_coeff() == 0.03


def test_param_attr_stamps_what_create_parameter_stamps():
    reg = L2Decay(0.1)
    attr = ParamAttr(learning_rate=0.25, regularizer=reg, trainable=False)
    n = pt.nn.RMSNorm(8, weight_attr=attr, device="cpu")
    ref = JaxRMSNorm(8, weight_attr=JaxParamAttr(learning_rate=0.25,
                                                  regularizer=reg,
                                                  trainable=False))
    assert n.weight.optimize_attr == ref.weight.optimize_attr
    assert n.weight.regularizer is ref.weight.regularizer is reg
    assert n.weight.requires_grad is False and ref.weight.stop_gradient
    assert torch.equal(n.weight.detach(), torch.ones(8))
    assert pt.nn.RMSNorm(8, weight_attr=False, device="cpu").weight is None
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    for layer in (ColumnParallelLinear(4, 6, weight_attr=attr, device="cpu"),
                  RowParallelLinear(4, 6, weight_attr=attr, device="cpu"),
                  VocabParallelEmbedding(9, 4, weight_attr=attr,
                                         device="cpu")):
        assert layer.weight.optimize_attr == {"learning_rate": 0.25}
        assert not layer.weight.requires_grad
        assert not hasattr(layer.weight, "need_clip")
    assert ParamAttr._to_attr(None).learning_rate == 1.0
    assert ParamAttr._to_attr(attr) is attr
    with pytest.raises(TypeError):
        ParamAttr._to_attr(3)


@pytest.mark.parametrize("coeff", [0.3, 0.01])
def test_l1_decay_is_a_decoupled_coefficient_as_in_the_reference(coeff):
    # kept on purpose: AdamW takes an L1Decay's coefficient as its
    # decoupled decay, p *= 1 - lr * coeff, with no sign term, as the
    # reference does; so L1Decay(c) steps as L2Decay(c), bit for bit
    rng = np.random.RandomState(5)
    w = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) * 0.1 for _ in range(3)]
    jp = paddle.create_parameter([4, 3], "float32")
    jp._data = jnp.asarray(w)
    t1 = torch.nn.Parameter(torch.from_numpy(w.copy()))
    t2 = torch.nn.Parameter(torch.from_numpy(w.copy()))
    jo = jax_optim.AdamW(0.05, parameters=[jp], weight_decay=JaxL1(coeff))
    o1 = AdamW(0.05, parameters=[t1], weight_decay=L1Decay(coeff))
    o2 = AdamW(0.05, parameters=[t2], weight_decay=L2Decay(coeff))
    for g in grads:
        jp._grad = paddle.to_tensor(jnp.asarray(g))
        t1.grad = torch.from_numpy(g.copy())
        t2.grad = torch.from_numpy(g.copy())
        for o in (jo, o1, o2):
            o.step()
            o.clear_grad()
        want = np.asarray(jp._data)
        got = t1.detach().numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max() + 1e-7
        assert torch.equal(t1, t2)
    # the decay moved the weight: a step without it lands elsewhere
    t3 = torch.nn.Parameter(torch.from_numpy(w.copy()))
    o3 = AdamW(0.05, parameters=[t3], weight_decay=None)
    for g in grads:
        t3.grad = torch.from_numpy(g.copy())
        o3.step()
    assert not torch.equal(t1, t3)


# -- AdamW with every option, on llama_tiny --------------------------------

_KW = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64, attention_bias=True)


def _pair():
    """(jax_model, port_model), each final norm built with a ParamAttr
    rate of 0.5, the port's weights from the JAX model's state."""
    paddle.seed(4)
    cfg = jax_tiny(**_KW)
    jm = JaxLlama(cfg)
    jm.model.norm = JaxRMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                               weight_attr=JaxParamAttr(learning_rate=0.5))
    tcfg = llama_tiny(**_KW)
    tm = LlamaForCausalLM(tcfg, device="cpu")
    tm.model.norm = pt.nn.RMSNorm(tcfg.hidden_size, tcfg.rms_norm_eps,
                                  weight_attr=ParamAttr(learning_rate=0.5),
                                  device="cpu")
    tm.load_reference_state({k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _groups(named):
    """Two dict groups: the matrices, then the vectors (norms, biases)."""
    return [{"params": [p for n, p in named if p.ndim == 2]},
            {"params": [p for n, p in named if p.ndim != 2]}]


def _schedule(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-2, T_max=3),
                            warmup_steps=2, start_lr=1e-3, end_lr=1e-2)


def test_adamw_with_schedule_clip_decay_groups_and_param_attr():
    jm, tm = _pair()
    jnamed, tnamed = list(jm.named_parameters()), list(tm.named_parameters())
    assert [n for n, _ in jnamed] == [n for n, _ in tnamed]
    # one bias stays out of the clip in both packages
    bias = "model.layers.0.self_attn.k_proj.bias"
    dict(jnamed)[bias].need_clip = False
    dict(tnamed)[bias].need_clip = False
    jsched, tsched = _schedule(jlr), _schedule(tlr)
    clip = 0.05
    jo = jax_optim.AdamW(jsched, parameters=_groups(jnamed),
                         weight_decay=JaxL2(0.01),
                         grad_clip=jclip.ClipGradByGlobalNorm(clip))
    to = AdamW(tsched, parameters=_groups(tnamed), weight_decay=L2Decay(0.01),
               grad_clip=tclip.ClipGradByGlobalNorm(clip))
    rng = np.random.RandomState(0)
    x = paddle.to_tensor(rng.randint(0, 512, (2, 16)))
    y = paddle.to_tensor(rng.randint(0, 512, (2, 16)))
    tparams = dict(tnamed)
    norms = []
    for step in range(4):
        _, loss = jm(x, y)
        loss.backward()
        for n, p in jnamed:
            tparams[n].grad = torch.from_numpy(np.array(p.grad._data))
        norms.append(float(tclip.ClipGradByGlobalNorm(clip)._global_norm_sq(
            [(p, p.grad) for _, p in tnamed])) ** 0.5)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        assert to.get_lr() == jo.get_lr()
        jsched.step()
        tsched.step()
        for n, p in jnamed:
            want = np.asarray(p._data)
            got = tparams[n].detach().numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max() \
                + 1e-7, (step, n)
    assert min(norms) > clip  # every step clipped
    assert tparams["model.norm.weight"].optimize_attr == {
        "learning_rate": 0.5}
    # the groups flatten in order: matrices, then vectors
    flat = [p for g in _groups(tnamed) for p in g["params"]]
    assert all(a is b for a, b in zip(to._parameter_list, flat))
    jsd = jo.state_dict()
    order = {id(p): i for i, p in enumerate(to._parameter_list)}
    for n, p in tnamed:
        i, jp = order[id(p)], dict(jnamed)[n]
        for k, mine in (("moment1", to._moment1[i]),
                        ("moment2", to._moment2[i])):
            want = np.asarray(jsd[f"{jp.name}_{k}_0"]._data)
            got = mine.numpy()
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max() \
                + 1e-12, (k, n)
    sd = to.state_dict()
    assert sd["LR_Scheduler"] == jsd["LR_Scheduler"]


def test_adamw_state_dict_round_trip():
    _, tm = _pair()
    named = list(tm.named_parameters())
    sched = _schedule(tlr)
    o = AdamW(sched, parameters=named, weight_decay=L2Decay(0.01),
              grad_clip=tclip.ClipGradByGlobalNorm(1.0))
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        for _, p in named:
            p.grad = torch.randn(p.shape, generator=g)
        o.step()
        sched.step()
    sd = o.state_dict()
    assert f"{named[0][0]}_moment1_0" in sd
    assert f"{named[0][0]}_beta2_pow_acc_0" in sd
    sched2 = _schedule(tlr)
    o2 = AdamW(sched2, parameters=named, weight_decay=L2Decay(0.01))
    o2.set_state_dict(sd)
    assert sched2.last_epoch == sched.last_epoch
    assert o2.get_lr() == o.get_lr() and o2._learning_rate == o.get_lr()
    for a, b in zip(o._moment2, o2._moment2):
        assert torch.equal(a, b)
    assert o2._beta1_pow == o._beta1_pow
    with pytest.raises(KeyError, match="no state named"):
        o2.set_state_dict({"nope_moment1_0": torch.zeros(1)})


def test_bf16_masters_ride_the_state_dict():
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    o = AdamW(0.1, parameters=[("w", p)])
    p.grad = torch.ones(3, dtype=torch.bfloat16)
    o.step()
    sd = o.state_dict()
    assert set(sd["master_weights"]) == {"w_fp32_master_0"}
    q = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    o2 = AdamW(0.1, parameters=[("w", q)])
    o2.set_state_dict(sd)
    assert torch.equal(o2._master[0], o._master[0])
    assert math.isclose(float(o2._beta1_pow[0]), 0.81, rel_tol=1e-6)
