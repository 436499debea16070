"""The port's in-place optimizer update rules (``optimizer/functional.py``)
against the JAX package's, on the same seeded numpy inputs.

Each rule takes float32 state and a float32 or bf16 parameter, updates
every tensor in place (the returned tensors are the ones passed in) and
computes in float32 before casting back. Tolerance: 1e-6 relative +
1e-7 for float32 results (the same float32 operations, a few grouped in
another order), and a bf16 parameter equal as bf16 (one rounding of the
same float32 value).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer.functional as jf

import paddle_tpu_torch.optimizer.functional as tf

SHAPE = (3, 5)


def _arrays(seed, names):
    rng = np.random.RandomState(seed)
    out = {}
    for n in names:
        a = rng.randn(*SHAPE).astype(np.float32)
        if n in ("mean_square", "avg_squared_grad", "avg_squared_update",
                 "moment2", "inf_norm", "lrs"):
            a = np.abs(a) * 0.1
            if n == "lrs":
                a = a + 0.01
        if n == "grad":
            a = a * 0.1
        out[n] = a
    return out


def _pow(v):
    return np.asarray([v], np.float32)


# rule, tensor arguments, scalar arguments (after the tensors)
RULES = {
    "sgd_": (lambda m, t, lr: m.sgd_(t["param"], lr, t["grad"]),
             ("param", "grad")),
    "momentum_": (lambda m, t, lr: m.momentum_(
        t["param"], t["grad"], t["velocity"], lr, mu=0.8),
        ("param", "grad", "velocity")),
    "momentum_nesterov": (lambda m, t, lr: m.momentum_(
        t["param"], t["grad"], t["velocity"], lr, use_nesterov=True),
        ("param", "grad", "velocity")),
    "adam_": (lambda m, t, lr: m.adam_(
        t["param"], t["grad"], t["moment1"], t["moment2"], t["b1p"],
        t["b2p"], lr, beta1=0.8), ("param", "grad", "moment1", "moment2",
                                   "b1p", "b2p")),
    "adamw_": (lambda m, t, lr: m.adamw_(
        t["param"], t["grad"], t["moment1"], t["moment2"], t["b1p"],
        t["b2p"], lr, weight_decay=0.1, lr_ratio=0.5),
        ("param", "grad", "moment1", "moment2", "b1p", "b2p")),
    "adagrad_": (lambda m, t, lr: m.adagrad_(
        t["param"], t["grad"], t["moment2"], lr, epsilon=1e-5),
        ("param", "grad", "moment2")),
    "adadelta_": (lambda m, t, lr: m.adadelta_(
        t["param"], t["grad"], t["avg_squared_grad"],
        t["avg_squared_update"], lr, rho=0.9),
        ("param", "grad", "avg_squared_grad", "avg_squared_update")),
    "adamax_": (lambda m, t, lr: m.adamax_(
        t["param"], t["grad"], t["moment1"], t["inf_norm"], t["b1p"], lr),
        ("param", "grad", "moment1", "inf_norm", "b1p")),
    "rmsprop_": (lambda m, t, lr: m.rmsprop_(
        t["param"], t["grad"], t["mean_square"], t["velocity"], lr,
        momentum=0.5), ("param", "grad", "mean_square", "velocity")),
    "rmsprop_centered": (lambda m, t, lr: m.rmsprop_(
        t["param"], t["grad"], t["mean_square"], t["velocity"], lr,
        mean_grad=t["mean_grad"], centered=True, rho=0.9),
        ("param", "grad", "mean_square", "velocity", "mean_grad")),
    "lamb_": (lambda m, t, lr: m.lamb_(
        t["param"], t["grad"], t["moment1"], t["moment2"], t["b1p"],
        t["b2p"], lr, weight_decay=0.05),
        ("param", "grad", "moment1", "moment2", "b1p", "b2p")),
    "asgd_": (lambda m, t, lr: m.asgd_(
        t["param"], t["grad"], t["d"], t["y"], 2, lr),
        ("param", "grad", "d", "y")),
    "lars_momentum_": (lambda m, t, lr: m.lars_momentum_(
        t["param"], t["grad"], t["velocity"], lr, lars_coeff=0.01),
        ("param", "grad", "velocity")),
    "rprop_": (lambda m, t, lr: m.rprop_(
        t["param"], t["grad"], t["prev"], t["lrs"],
        learning_rate_range=(1e-3, 0.2)),
        ("param", "grad", "prev", "lrs")),
}


def _both(rule, param_dtype, seed):
    fn, names = RULES[rule]
    arrays = _arrays(seed, [n for n in names if n not in ("b1p", "b2p")])
    if "b1p" in names:
        arrays["b1p"] = _pow(0.9 ** 2)
    if "b2p" in names:
        arrays["b2p"] = _pow(0.999 ** 2)
    if rule == "rprop_":   # some signs agree, some flip, some vanish
        arrays["prev"][0] = arrays["grad"][0]
        arrays["prev"][1] = -arrays["grad"][1]
        arrays["prev"][2, ::2] = 0.0
    jt = {n: paddle.to_tensor(jnp.asarray(a)) for n, a in arrays.items()}
    tt = {n: torch.from_numpy(a.copy()) for n, a in arrays.items()}
    if param_dtype == "bfloat16":
        jt["param"] = paddle.to_tensor(
            jnp.asarray(arrays["param"]).astype(jnp.bfloat16))
        tt["param"] = tt["param"].to(torch.bfloat16)
    before = {n: t for n, t in tt.items()}
    jout = fn(jf, jt, 0.05)
    tout = fn(tf, tt, 0.05)
    return jt, tt, before, jout, tout


def _f32(t):
    return np.asarray(jnp.asarray(t._data).astype(jnp.float32))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_the_reference_in_place(rule, param_dtype):
    jt, tt, before, jout, tout = _both(rule, param_dtype, seed=len(rule))
    for n, t in tt.items():
        assert t is before[n]   # updated in place
        want = _f32(jt[n])
        got = t.float().numpy()
        if n == "param" and param_dtype == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=n)
    jlist = jout if isinstance(jout, (tuple, list)) else (jout,)
    tlist = tout if isinstance(tout, (tuple, list)) else (tout,)
    assert len(jlist) == len(tlist)
    for j, t in zip(jlist, tlist):
        np.testing.assert_allclose(t.float().numpy(), _f32(j), rtol=1e-6,
                                   atol=1e-7)


def test_merged_rules_are_the_single_rules_over_lists():
    rng = np.random.RandomState(3)
    make = lambda: [torch.from_numpy(  # noqa: E731
        rng.randn(*SHAPE).astype(np.float32)) for _ in range(2)]
    p, g, m1, m2, v = make(), make(), make(), make(), make()
    m2 = [x.abs() for x in m2]
    b1 = [torch.tensor([0.81]), torch.tensor([0.9])]
    b2 = [torch.tensor([0.998]), torch.tensor([0.999])]
    clones = [[x.clone() for x in lst] for lst in (p, m1, m2, b1, b2, v)]
    out = tf.merged_adam_(p, g, m1, m2, b1, b2, 0.01)
    assert out is p
    cp, cm1, cm2, cb1, cb2, cv = clones
    for i in range(2):
        tf.adam_(cp[i], g[i], cm1[i], cm2[i], cb1[i], cb2[i], 0.01)
        for a, b in ((p, cp), (m1, cm1), (m2, cm2), (b1, cb1), (b2, cb2)):
            assert torch.equal(a[i], b[i])
    q = [x.clone() for x in cp]
    tf.merged_momentum_(cp, g, cv, 0.1, mu=0.7, use_nesterov=True)
    for i in range(2):
        vv = v[i]
        tf.momentum_(q[i], g[i], vv, 0.1, mu=0.7, use_nesterov=True)
        assert torch.equal(q[i], cp[i]) and torch.equal(vv, cv[i])


def test_asgd_takes_a_tensor_count():
    rng = np.random.RandomState(4)
    a = [torch.from_numpy(rng.randn(4).astype(np.float32))
         for _ in range(4)]
    b = [x.clone() for x in a]
    tf.asgd_(*a, torch.tensor(3.0), 0.1)
    tf.asgd_(*b, 3, 0.1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
