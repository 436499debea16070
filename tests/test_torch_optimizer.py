"""Parity of the PyTorch port's AdamW with the JAX package's.

The same float32 and bf16 parameters and the same gradients (numpy,
seeded) go through three steps of each optimizer, with float32 master
weights for the bf16 parameters, decoupled weight decay, a parameter
excluded from the decay by ``apply_decay_param_fun`` and a per-parameter
``lr_ratio``. The port gets ``(name, tensor)`` pairs so that its decay
function sees the same names as the JAX one.

Tolerances: float32 parameters within 1e-6 relative + 1e-7 (the same
float32 update, its terms multiplied in another order); bf16 parameters
exactly equal as bf16 after each step (both round the same float32
master once), and their masters within 1e-6 relative + 1e-7.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jax_optim

from paddle_tpu_torch.optimizer import AdamW

SHAPES = [(4, 3), (5,), (2, 2, 3)]


def _inputs(seed):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * 0.1 for s in SHAPES]
             for _ in range(3)]
    return params, grads


def _jax_params(params, dtype):
    out = []
    for a in params:
        p = paddle.create_parameter(list(a.shape), dtype)
        p._data = jnp.asarray(a).astype(dtype)
        out.append(p)
    return out


def _run(dtype, seed=0, **kw):
    params, grads = _inputs(seed)
    jp = _jax_params(params, jnp.bfloat16 if dtype == "bfloat16"
                     else jnp.float32)
    names = [p.name for p in jp]
    tdt = getattr(torch, dtype)
    tp = [torch.nn.Parameter(torch.from_numpy(a).to(tdt)) for a in params]
    decay_fun = kw.pop("apply_decay_param_fun", None)
    if decay_fun == "not_second":  # the second parameter takes no decay
        decay_fun = lambda n: n != names[1]  # noqa: E731
    lr_ratio = kw.pop("lr_ratio", None)
    jo = jax_optim.AdamW(
        0.05, parameters=jp,
        apply_decay_param_fun=decay_fun,
        lr_ratio=None if lr_ratio is None else
        (lambda p: lr_ratio[names.index(p.name)]), **kw)
    to = AdamW(
        0.05, parameters=list(zip(names, tp)),
        apply_decay_param_fun=decay_fun,
        lr_ratio=None if lr_ratio is None else
        (lambda p: lr_ratio[[id(x) for x in tp].index(id(p))]), **kw)
    for step in grads:
        for p, g in zip(jp, step):
            p._grad = paddle.to_tensor(jnp.asarray(g).astype(p._data.dtype))
        for p, g in zip(tp, step):
            p.grad = torch.from_numpy(g).to(tdt)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        yield jp, tp, jo, to


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("kw", [
    {},
    {"weight_decay": 0.1},
    {"weight_decay": 0.1, "beta1": 0.8, "beta2": 0.95, "epsilon": 1e-6},
    {"weight_decay": 0.1, "apply_decay_param_fun": "not_second"},
    {"lr_ratio": [1.0, 0.5, 2.0]},
], ids=["default", "decay", "betas", "decay_fun", "lr_ratio"])
def test_float32_three_steps(kw):
    for jp, tp, _, _ in _run("float32", **kw):
        for j, t in zip(jp, tp):
            np.testing.assert_allclose(t.detach().numpy(), _f32(j._data),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.1}],
                         ids=["default", "decay"])
def test_bf16_masters_three_steps(kw):
    for jp, tp, jo, to in _run("bfloat16", seed=1, **kw):
        for i, (j, t) in enumerate(zip(jp, tp)):
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.detach().float().numpy(),
                                          _f32(j._data))
            master = to._master[i]
            assert master is not None and master.dtype == torch.float32
            np.testing.assert_allclose(
                master.numpy(), _f32(jo._get_master(j)._data),
                rtol=1e-6, atol=1e-7)
            assert to._moment1[i].dtype == torch.float32


def test_moments_and_beta_pows_follow_the_reference():
    for jp, tp, jo, to in _run("float32", seed=2, weight_decay=0.05):
        pass
    for i, j in enumerate(jp):
        np.testing.assert_allclose(
            to._moment1[i].numpy(), _f32(jo._param_accum("moment1", j)._data),
            rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(
            to._moment2[i].numpy(), _f32(jo._param_accum("moment2", j)._data),
            rtol=1e-6, atol=1e-10)
        assert to._beta1_pow[i] == np.float32(
            jo._aux_state[f"{j.name}_beta1_pow_acc_0"]._data)


def test_without_multi_precision_bf16_state_stays_bf16():
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    o = AdamW(0.1, parameters=[p], multi_precision=False)
    p.grad = torch.full((3,), 0.5, dtype=torch.bfloat16)
    o.step()
    assert o._master[0] is None
    assert o._moment1[0].dtype == torch.bfloat16
    assert float(p.detach()[0]) < 1.0


def test_parameter_without_grad_is_skipped():
    a = torch.nn.Parameter(torch.ones(2))
    b = torch.nn.Parameter(torch.ones(2))
    o = AdamW(0.1, parameters=[a, b])
    a.grad = torch.ones(2)
    o.step()
    assert torch.equal(b.detach(), torch.ones(2))
    assert o._beta1_pow[1] == np.float32(0.9)
    assert o._beta1_pow[0] == np.float32(0.9) * np.float32(0.9)


def test_lr_and_clear_grad():
    a = torch.nn.Parameter(torch.ones(2))
    o = AdamW(0.1, parameters=[a])
    assert o.get_lr() == pytest.approx(0.1)
    o.set_lr(0.01)
    assert o.get_lr() == pytest.approx(0.01)
    a.grad = torch.ones(2)
    o.clear_grad(set_to_zero=True)
    assert torch.equal(a.grad, torch.zeros(2))
    o.clear_grad()
    assert a.grad is None


@pytest.mark.parametrize("kw", [{"lazy_mode": True}], ids=["lazy_mode"])
def test_unported_options_raise(kw):
    kw.setdefault("parameters", [torch.nn.Parameter(torch.ones(1))])
    with pytest.raises(NotImplementedError):
        AdamW(**kw)
