"""Parity of the PyTorch port's other optimizers (Adam, Momentum, SGD,
Adagrad, RMSProp, Lamb, Adamax, Adadelta, NAdam, RAdam, Rprop, ASGD and
LBFGS) with the JAX package's.

The same float32 and bf16 parameters and the same gradients (numpy,
seeded) go through three steps of each optimizer (seven for RAdam, whose
adaptive branch starts at step 6), with float32 masters for the bf16
parameters, a weight decay given as a float and as an ``L2Decay`` where
the class reads one, and ``ParamAttr`` rates where the class reads them
(Momentum and Adam; the others refuse a rate other than 1, as they
refuse the options the reference accepts and never reads). The port
gets ``(name, tensor)`` pairs so its ``state_dict`` keys carry the JAX
parameters' names.

Tolerances, as ``tests/test_torch_optimizer.py``: float32 parameters,
masters and state within 1e-6 relative + 1e-7 (the same float32
update, some terms grouped in another order); bf16 parameters exactly
equal as bf16 after each step (both round the same float32 value once).
LBFGS (float32, a quadratic) within 1e-5 relative + 1e-6 over its
iterations: its two-loop recursion sums float32 dot products of whole
vectors, whose order differs between the packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as jax_optim
from paddle_tpu.regularizer import L2Decay as JaxL2

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.regularizer import L2Decay

SHAPES = [(4, 3), (5,), (2, 2, 3)]
RTOL, ATOL = 1e-6, 1e-7

# (class name, constructor arguments, case id); "L2" stands for
# weight_decay=L2Decay(0.1) in each package
CASES = [
    ("Adam", {}, "default"),
    ("Adam", {"weight_decay": 0.1}, "decay"),
    ("Adam", {"weight_decay": "L2", "beta1": 0.8, "beta2": 0.95},
     "l2_betas"),
    ("Momentum", {}, "default"),
    ("Momentum", {"use_nesterov": True}, "nesterov"),
    ("Momentum", {"weight_decay": 0.1, "momentum": 0.8}, "decay"),
    ("Momentum", {"weight_decay": "L2", "use_nesterov": True}, "l2"),
    ("SGD", {}, "default"),
    ("SGD", {"weight_decay": "L2"}, "l2"),
    ("Adagrad", {}, "default"),
    ("Adagrad", {"epsilon": 1e-3}, "epsilon"),
    ("RMSProp", {}, "default"),
    ("RMSProp", {"centered": True}, "centered"),
    ("RMSProp", {"momentum": 0.9}, "momentum"),
    ("RMSProp", {"centered": True, "momentum": 0.5, "rho": 0.9},
     "centered_momentum"),
    ("Lamb", {}, "default"),
    ("Lamb", {"lamb_weight_decay": 0.0, "beta1": 0.8}, "no_decay"),
    ("Lamb", {"exclude": True}, "exclude_fn"),
    ("Adamax", {}, "default"),
    ("Adamax", {"weight_decay": "L2", "beta2": 0.9}, "l2"),
    ("Adadelta", {}, "default"),
    ("Adadelta", {"weight_decay": 0.1, "rho": 0.9}, "decay"),
    ("NAdam", {}, "default"),
    ("NAdam", {"weight_decay": "L2", "momentum_decay": 0.01}, "l2"),
    ("RAdam", {}, "default"),
    ("RAdam", {"weight_decay": 0.1, "beta2": 0.99}, "decay"),
    ("Rprop", {}, "default"),
    ("Rprop", {"etas": (0.3, 1.5), "learning_rate_range": (1e-3, 0.07)},
     "etas"),
    ("ASGD", {}, "default"),
    ("ASGD", {"batch_num": 2, "weight_decay": "L2"}, "batch2_l2"),
]
IDS = [f"{c}-{i}" for c, _, i in CASES]


def _steps(cls):
    return 7 if cls == "RAdam" else 3


def _inputs(seed, steps):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * 0.1 for s in SHAPES]
             for _ in range(steps)]
    # gradients that keep their sign, flip it and vanish, for Rprop
    for k in range(1, steps):
        grads[k][0] = grads[k - 1][0] * (0.5 if k % 2 else -1.0)
        grads[k][1][::2] = 0.0
    return params, grads


def _jax_params(params, dtype):
    out = []
    for a in params:
        p = paddle.create_parameter(list(a.shape), dtype)
        p._data = jnp.asarray(a).astype(dtype)
        out.append(p)
    return out


def _kwargs(kw, package, names):
    kw = dict(kw)
    if kw.get("weight_decay") == "L2":
        kw["weight_decay"] = (JaxL2 if package == "jax" else L2Decay)(0.1)
    if kw.pop("exclude", False):
        kw["exclude_from_weight_decay_fn"] = names
    return kw


def _pair(cls, kw, dtype, seed=0, rate=None):
    """Yields after every step ``(jax params, port params, jax opt, port
    opt)``; ``rate``: a ParamAttr learning rate stamped on the second
    parameter."""
    steps = _steps(cls)
    params, grads = _inputs(seed, steps)
    jp = _jax_params(params, jnp.bfloat16 if dtype == "bfloat16"
                     else jnp.float32)
    names = [p.name for p in jp]
    tdt = getattr(torch, dtype)
    tp = [torch.nn.Parameter(torch.from_numpy(a).to(tdt)) for a in params]
    if rate is not None:
        jp[1].optimize_attr["learning_rate"] = rate
        tp[1].optimize_attr = {"learning_rate": rate}
    lr = 0.05
    jo = getattr(jax_optim, cls)(
        lr, parameters=jp,
        **_kwargs(kw, "jax", lambda p: p.name == names[1]))
    to = getattr(topt, cls)(
        lr, parameters=list(zip(names, tp)),
        **_kwargs(kw, "port", lambda p: p is tp[1]))
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


def _np(t):
    return t.detach().float().cpu().numpy()


def _state_close(jo, to):
    """The port's state_dict against the reference's: the same keys, the
    same values (tensors within the float32 tolerance, the host scalars
    too)."""
    js, ts = jo.state_dict(), to.state_dict()
    assert set(ts) == set(js)
    for k, v in ts.items():
        if k == "master_weights":
            assert set(v) == set(js[k])
            for mk, mv in v.items():
                assert mv.dtype == torch.float32
                np.testing.assert_allclose(_np(mv), _f32(js[k][mk]._data),
                                           rtol=RTOL, atol=ATOL, err_msg=mk)
            continue
        np.testing.assert_allclose(_np(v), _f32(js[k]._data), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("cls,kw", [c[:2] for c in CASES], ids=IDS)
def test_float32_steps_and_state(cls, kw):
    for jp, tp, jo, to in _pair(cls, kw, "float32"):
        for j, t in zip(jp, tp):
            np.testing.assert_allclose(_np(t), _f32(j._data), rtol=RTOL,
                                       atol=ATOL)
        _state_close(jo, to)


@pytest.mark.parametrize("cls,kw", [c[:2] for c in CASES], ids=IDS)
def test_bf16_masters_and_state(cls, kw):
    for jp, tp, jo, to in _pair(cls, kw, "bfloat16", seed=1):
        for j, t in zip(jp, tp):
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(t), _f32(j._data))
        _state_close(jo, to)
    for i in range(len(SHAPES)):
        assert to._master[i] is not None
        for acc in to._accums.values():
            assert acc[i].dtype == torch.float32


@pytest.mark.parametrize("cls,kw", [
    ("Momentum", {}), ("Momentum", {"use_nesterov": True,
                                     "weight_decay": 0.1}),
    ("Adam", {"weight_decay": 0.1})], ids=["momentum", "nesterov", "adam"])
def test_param_attr_rates(cls, kw):
    for dtype, seed in (("float32", 2), ("bfloat16", 3)):
        for jp, tp, jo, to in _pair(cls, kw, dtype, seed=seed, rate=0.5):
            for j, t in zip(jp, tp):
                np.testing.assert_allclose(_np(t), _f32(j._data),
                                           rtol=RTOL, atol=ATOL)
            _state_close(jo, to)


@pytest.mark.parametrize("cls,kw", [c[:2] for c in CASES], ids=IDS)
def test_set_state_dict_round_trip(cls, kw):
    """A fresh optimizer loaded with a state_dict holds the same state
    and takes the same next step, bit for bit."""
    *_, (jp, tp, jo, to) = _pair(cls, kw, "bfloat16", seed=4)
    names = [p.name for p in jp]
    copies = [torch.nn.Parameter(p.detach().clone()) for p in tp]
    fresh = getattr(topt, cls)(0.05, parameters=list(zip(names, copies)),
                               **_kwargs(kw, "port",
                                         lambda p: p is copies[1]))
    fresh.set_state_dict(to.state_dict())
    a, b = to.state_dict(), fresh.state_dict()
    assert set(a) == set(b)
    for k in a:
        if k == "master_weights":
            for mk in a[k]:
                assert torch.equal(a[k][mk], b[k][mk])
        else:
            assert torch.equal(a[k], b[k]), k
    if cls == "ASGD":   # its step count is not state, as in the reference
        fresh._t = to._t
    g = np.random.RandomState(9)
    for p, q in zip(tp, copies):
        p.grad = torch.from_numpy(
            g.randn(*p.shape).astype(np.float32)).to(p.dtype)
        q.grad = p.grad.clone()
    to.step()
    fresh.step()
    for p, q in zip(tp, copies):
        assert torch.equal(p.detach(), q.detach())


def test_asgd_averaged_params():
    for jp, tp, jo, to in _pair("ASGD", {"batch_num": 2}, "float32",
                                seed=5):
        avg = to.averaged_params()
        javg = jo.averaged_params()
        assert list(avg) == [p.name for p in jp] == list(javg)
        for k in avg:
            np.testing.assert_allclose(_np(avg[k]), _f32(javg[k]._data),
                                       rtol=RTOL, atol=ATOL)


def _quadratic():
    rng = np.random.RandomState(1)
    a = rng.randn(6, 6).astype("float32")
    return (a @ a.T + 6 * np.eye(6)).astype("float32"), \
        rng.randn(6).astype("float32")


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"],
                         ids=["fixed", "strong_wolfe"])
def test_lbfgs_follows_the_reference(line_search):
    a, b = _quadratic()
    w0 = np.random.RandomState(0).randn(6).astype("float32")
    lr = 1.0 if line_search else 0.1
    jw = paddle.to_tensor(w0.copy(), stop_gradient=False)
    jo = jax_optim.LBFGS(parameters=[jw], line_search_fn=line_search,
                         learning_rate=lr, max_iter=4)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    to = topt.LBFGS(parameters=[tw], line_search_fn=line_search,
                    learning_rate=lr, max_iter=4)
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def jclosure():
        jo.clear_grad()
        loss = 0.5 * (jw * (ja @ jw)).sum() - (jb * jw).sum()
        loss.backward()
        return loss

    def tclosure():
        to.clear_grad()
        loss = 0.5 * (tw * (ta @ tw)).sum() - (tb * tw).sum()
        loss.backward()
        return loss

    losses = []
    for _ in range(3):
        jl = jo.step(jclosure)
        tl = to.step(tclosure)
        assert float(tl.detach()) == pytest.approx(float(np.asarray(jl._data)),
                                          rel=1e-5, abs=1e-6)
        np.testing.assert_allclose(tw.detach().numpy(), _f32(jw._data),
                                   rtol=1e-5, atol=1e-6)
        losses.append(float(tl.detach()))
    assert losses[-1] < losses[0]
    assert len(to._s) == len(jo._s)
    if line_search:
        np.testing.assert_allclose(tw.detach().numpy(),
                                   np.linalg.solve(a, b), atol=1e-3)


def test_lbfgs_requires_a_closure():
    opt = topt.LBFGS(parameters=[torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(ValueError):
        opt.step()


def _one():
    return torch.nn.Parameter(torch.ones(2))


@pytest.mark.parametrize("make", [
    lambda p: topt.Adagrad(0.1, parameters=[p], weight_decay=0.1),
    lambda p: topt.Adagrad(0.1, parameters=[p],
                           initial_accumulator_value=0.1),
    lambda p: topt.RMSProp(0.1, parameters=[p], weight_decay=L2Decay(0.1)),
    lambda p: topt.LBFGS(parameters=[p], weight_decay=0.1),
    lambda p: topt.LBFGS(parameters=[p], grad_clip=object()),
    lambda p: topt.Adam(0.1, parameters=[p], lazy_mode=True),
], ids=["adagrad_decay", "adagrad_initial", "rmsprop_decay", "lbfgs_decay",
        "lbfgs_clip", "adam_lazy"])
def test_options_the_reference_never_reads_raise(make):
    with pytest.raises(NotImplementedError):
        make(_one())


@pytest.mark.parametrize("cls", ["SGD", "Adagrad", "RMSProp", "Lamb",
                                 "Adamax", "Adadelta", "NAdam", "RAdam",
                                 "Rprop", "ASGD", "LBFGS"])
def test_a_param_attr_rate_raises_where_the_reference_ignores_it(cls):
    p = _one()
    getattr(topt, cls)(0.1, parameters=[p])
    p.optimize_attr = {"learning_rate": 0.5}
    with pytest.raises(NotImplementedError, match="learning rate"):
        getattr(topt, cls)(0.1, parameters=[p])


def test_every_reference_class_is_exported():
    import paddle_tpu.optimizer as ref

    names = [n for n in dir(ref) if isinstance(getattr(ref, n), type)
             and issubclass(getattr(ref, n), ref.Optimizer)]
    assert len(names) >= 14
    for n in names:
        assert issubclass(getattr(topt, n), topt.Optimizer), n
