"""``paddle_tpu_torch.save`` / ``load`` on the CPU: round trips, the
reference's saved contents, and a resumed run.

Round trips of nested structures (dicts, lists, tuples) holding
float32, bf16, fp16, int32 and int64 tensors, ``nn.Parameter``s, Python
scalars and strings give back every tensor bit for bit, with its dtype.
The two packages' saved ``llama_tiny`` state dicts and AdamW +
``LinearWarmup(CosineAnnealingDecay)`` optimizer states (weights carried
by ``load_reference_state``, two steps, both optimizers fed the JAX
model's gradients) hold the same keys, and equal values as numpy (bf16
read as float32): weights, masters and moments within 1e-6 relative +
1e-7 (``tests/test_torch_optimizer.py``'s), the scheduler's state
exactly.
A run that saves after 3 steps and resumes in a fresh model and
optimizer for 2 more equals 5 straight steps bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jax_optim
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny

import paddle_tpu_torch as pt
import paddle_tpu_torch.optimizer.lr as tlr
from paddle_tpu_torch.framework.io import _TensorPayload
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW

KW = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, vocab_size=256)


def _structure():
    rng = np.random.RandomState(0)
    f32 = torch.from_numpy(rng.randn(3, 4).astype(np.float32))
    bf16 = torch.from_numpy(rng.randn(5).astype(np.float32)).to(
        torch.bfloat16)
    bf16[0] = float("nan")
    bf16[1] = -0.0
    return {
        "f32": f32,
        "bf16": bf16,
        "f16": torch.from_numpy(rng.randn(2, 2).astype(np.float16)),
        "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "i64": torch.tensor([-(2 ** 40), 7]),
        "param": torch.nn.Parameter(f32.clone()),
        "grad": f32.clone().requires_grad_(),
        "scalar0d": torch.tensor(0.25),
        "nested": [{"t": bf16.clone(), "n": 3}, (f32[0].clone(), "s", 1.5)],
        "plain": {"lr": 0.001, "epoch": 4, "name": "x", "none": None,
                  "flag": True, "milestones": [2, 5]},
    }


def _same(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.detach().view(-1).view(torch.uint8)
                           if a.dtype.is_floating_point else a,
                           b.detach().view(-1).view(torch.uint8)
                           if b.dtype.is_floating_point else b)
        return
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def test_round_trip_keeps_every_bit_and_dtype(tmp_path):
    obj = _structure()
    path = tmp_path / "sub" / "dir" / "state.pdparams"
    pt.save(obj, str(path))
    assert path.exists()
    back = pt.load(str(path), device="cpu")
    _same(obj, back)
    assert isinstance(back["param"], torch.nn.Parameter)
    assert back["param"].requires_grad
    assert back["grad"].requires_grad and not back["f32"].requires_grad
    assert back["scalar0d"].dim() == 0


def test_payloads_are_numpy(tmp_path):
    """The pickle holds numpy arrays: a bf16 tensor's bits as uint16 with
    its dtype tag."""
    import pickle

    path = tmp_path / "s.pdopt"
    obj = _structure()
    pt.save({"bf16": obj["bf16"], "p": obj["param"]}, str(path),
            protocol=2)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert isinstance(raw["bf16"], _TensorPayload)
    assert raw["bf16"].array.dtype == np.uint16
    assert raw["bf16"].dtype == "bfloat16"
    np.testing.assert_array_equal(
        raw["bf16"].array, obj["bf16"].view(torch.int16).numpy()
        .view(np.uint16))
    assert raw["p"].is_param and not raw["p"].stop_gradient


def test_return_numpy(tmp_path):
    obj = _structure()
    path = str(tmp_path / "s")
    pt.save(obj, path)
    back = pt.load(path, return_numpy=True)
    assert isinstance(back["f32"], np.ndarray)
    np.testing.assert_array_equal(back["f32"], obj["f32"].numpy())
    assert back["bf16"].dtype == np.float32   # an exact widening
    np.testing.assert_array_equal(back["bf16"], obj["bf16"].float().numpy())
    assert back["i64"].dtype == np.int64 and back["i32"].dtype == np.int32
    assert back["f16"].dtype == np.float16
    assert isinstance(back["nested"][1], tuple)
    assert back["plain"] == obj["plain"]


def test_load_follows_the_device_rule(tmp_path, monkeypatch):
    path = str(tmp_path / "s")
    pt.save({"a": torch.ones(2)}, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.load(path)
    assert pt.load(path, device="cpu")["a"].is_cpu
    assert isinstance(pt.load(path, return_numpy=True)["a"], np.ndarray)


# -- the two packages' saved states ------------------------------------------

def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, KW["vocab_size"], size=(2, 16)),
            rng.randint(0, KW["vocab_size"], size=(2, 16)))


def _jax_sched():
    return jlr.LinearWarmup(jlr.CosineAnnealingDecay(0.01, T_max=4),
                            warmup_steps=2, start_lr=0.0, end_lr=0.01)


def _port_sched():
    return tlr.LinearWarmup(tlr.CosineAnnealingDecay(0.01, T_max=4),
                            warmup_steps=2, start_lr=0.0, end_lr=0.01)


def test_saved_states_match_the_references(tmp_path):
    paddle.seed(3)
    jm = JaxLlama(jax_tiny(fused_head_loss=True, **KW))
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(fused_head_loss=True, **KW),
                          device="cpu")
    tm.load_reference_state(state)
    jnames = {n: p.name for n, p in jm.named_parameters()}
    js, ts = _jax_sched(), _port_sched()
    jo = jax_optim.AdamW(js, parameters=jm.parameters())
    to = AdamW(ts, parameters=[(jnames[n], p)
                               for n, p in tm.named_parameters()])
    for step in range(2):
        x, y = _batch(step)
        _, jl = jm(paddle.to_tensor(x.astype("int32")),
                   paddle.to_tensor(y.astype("int64")))
        jl.backward()
        jgrads = {n: p.grad._data for n, p in jm.named_parameters()}
        jo.step()
        jo.clear_grad()
        js.step()
        for n, p in tm.named_parameters():   # the reference's gradients
            p.grad = torch.from_numpy(np.array(jgrads[n]))
        to.step()
        to.clear_grad()
        ts.step()
    for what, jobj, tobj in (("model", jm.state_dict(), tm.state_dict()),
                             ("opt", jo.state_dict(), to.state_dict())):
        paddle.save(jobj, str(tmp_path / f"jax.{what}"))
        pt.save(tobj, str(tmp_path / f"port.{what}"))
        jback = paddle.load(str(tmp_path / f"jax.{what}"),
                            return_numpy=True)
        tback = pt.load(str(tmp_path / f"port.{what}"), return_numpy=True)
        assert set(tback) == set(jback), what
        for k, v in tback.items():
            if k == "LR_Scheduler":
                assert v == jback[k]
            elif k == "master_weights":
                assert not v and not jback[k]
            else:
                np.testing.assert_allclose(
                    np.asarray(v, np.float32),
                    np.asarray(jback[k], np.float32), rtol=1e-6, atol=1e-7,
                    err_msg=k)


def test_saved_bf16_parameters_and_masters_match_the_references(tmp_path):
    """bf16 parameters (read back as float32 in the port, as ml_dtypes
    bf16 in the reference) equal bit for bit, their masters too."""
    import jax.numpy as jnp

    rng = np.random.RandomState(6)
    arrays = [rng.randn(4, 3).astype(np.float32), rng.randn(5)
              .astype(np.float32)]
    jp = []
    for a in arrays:
        p = paddle.create_parameter(list(a.shape), jnp.bfloat16)
        p._data = jnp.asarray(a).astype(jnp.bfloat16)
        jp.append(p)
    tp = [torch.nn.Parameter(torch.from_numpy(a).to(torch.bfloat16))
          for a in arrays]
    jo = jax_optim.AdamW(0.05, parameters=jp)
    to = AdamW(0.05, parameters=[(p.name, q) for p, q in zip(jp, tp)])
    grads = [rng.randn(*a.shape).astype(np.float32) * 0.1 for a in arrays]
    for p, q, g in zip(jp, tp, grads):
        p._grad = paddle.to_tensor(jnp.asarray(g).astype(jnp.bfloat16))
        q.grad = torch.from_numpy(g).to(torch.bfloat16)
    jo.step()
    to.step()
    paddle.save({"params": jp, "opt": jo.state_dict()},
                str(tmp_path / "j"))
    pt.save({"params": tp, "opt": to.state_dict()}, str(tmp_path / "t"))
    jb = paddle.load(str(tmp_path / "j"), return_numpy=True)
    tb = pt.load(str(tmp_path / "t"), return_numpy=True)
    for a, b in zip(tb["params"], jb["params"]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert set(tb["opt"]["master_weights"]) == set(jb["opt"]["master_weights"])
    for k, v in tb["opt"]["master_weights"].items():
        np.testing.assert_allclose(v, jb["opt"]["master_weights"][k],
                                   rtol=1e-6, atol=1e-7)


# -- resume --------------------------------------------------------------------

def _trainer(seed=0):
    m = LlamaForCausalLM(llama_tiny(fused_head_loss=True, **KW),
                         device="cpu", dtype="bfloat16", seed=seed)
    sched = _port_sched()
    opt = AdamW(sched, parameters=m.parameters(),
                grad_clip=ClipGradByGlobalNorm(0.5), weight_decay=0.01)
    return m, opt, sched


def _steps(m, opt, sched, first, n):
    losses = []
    for step in range(first, first + n):
        x, y = _batch(10 + step)
        _, loss = m(torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(loss.detach())
    return losses


def test_resumed_run_equals_the_uninterrupted_run(tmp_path):
    m, opt, sched = _trainer()
    straight = _steps(m, opt, sched, 0, 5)

    m1, opt1, sched1 = _trainer()
    first = _steps(m1, opt1, sched1, 0, 3)
    pt.save(m1.state_dict(), str(tmp_path / "ckpt" / "model.pdparams"))
    pt.save(opt1.state_dict(), str(tmp_path / "ckpt" / "model.pdopt"))
    del m1, opt1, sched1

    m2, opt2, sched2 = _trainer(seed=1)   # other weights until loaded
    m2.load_state_dict(pt.load(str(tmp_path / "ckpt" / "model.pdparams"),
                               device="cpu"))
    opt2.set_state_dict(pt.load(str(tmp_path / "ckpt" / "model.pdopt"),
                                device="cpu"))
    assert sched2.last_epoch == 3
    resumed = first + _steps(m2, opt2, sched2, 3, 2)
    for a, b in zip(straight, resumed):
        assert torch.equal(a, b)
    for (n, p), q in zip(m.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), n
    a, b = opt.state_dict(), opt2.state_dict()
    assert set(a) == set(b)
    for k in a:
        if k == "LR_Scheduler":
            assert a[k] == b[k]
        elif k == "master_weights":
            for mk in a[k]:
                assert torch.equal(a[k][mk], b[k][mk]), mk
        else:
            assert torch.equal(a[k], b[k]), k
