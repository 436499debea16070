"""Activation recompute in the PyTorch port against the port without it
and against the JAX package's, on the CPU.

Every granularity of ``paddle_tpu_torch.distributed.fleet.recompute``
replays the same float32 operations on the same inputs as the plain
forward, so the recomputed Llama step's loss and every gradient equal
the plain step's bit for bit. Against the JAX package's
``llama_tiny(recompute=True, recompute_granularity=g)``, with weights
carried by ``load_reference_state``, the tolerances are
``tests/test_torch_llama_training.py``'s: loss within 1e-5 relative,
every gradient within 1e-4 of its largest entry. The small regions
mirror ``tests/test_recompute_sp.py``: a region's loss and gradients
equal the plain run's bit for bit (the same operations, replayed).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny

from paddle_tpu_torch.distributed.fleet.recompute import (
    recompute, recompute_hybrid, recompute_sequential)
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny

GRANULARITIES = ["full", "selective", "core_attn", "dots",
                 "dots_with_no_batch_dims", None]
KW = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, vocab_size=256)
B, S = 2, 16


def _batch(vocab, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, vocab, size=(B, S))
    y = rng.randint(0, vocab, size=(B, S))
    y[1, 5] = -100
    return x, y


def _port_step(state, fused, **cfg):
    m = LlamaForCausalLM(llama_tiny(fused_head_loss=fused, **KW, **cfg),
                         device="cpu")
    m.load_reference_state(state)
    x, y = _batch(KW["vocab_size"])
    _, loss = m(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in m.named_parameters()}


_STATE = {}


def _reference_state():
    if "w" not in _STATE:
        paddle.seed(11)
        jm = JaxLlama(jax_tiny(**KW))
        _STATE["w"] = {k: np.asarray(v._data)
                       for k, v in jm.state_dict().items()}
    return _STATE["w"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("granularity", GRANULARITIES,
                         ids=[str(g) for g in GRANULARITIES])
def test_recomputed_step_equals_the_plain_step_bit_for_bit(granularity,
                                                           fused):
    state = _reference_state()
    loss0, g0 = _port_step(state, fused)
    loss1, g1 = _port_step(state, fused, recompute=True,
                           recompute_granularity=granularity)
    assert torch.equal(loss0, loss1)
    assert set(g0) == set(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("granularity", GRANULARITIES[:5])
def test_recomputed_step_matches_jax(granularity):
    state = _reference_state()
    jm = JaxLlama(jax_tiny(recompute=True,
                           recompute_granularity=granularity,
                           fused_head_loss=True, **KW))
    for name, p in jm.named_parameters():
        p.set_value(state[name])
    x, y = _batch(KW["vocab_size"])
    _, jloss = jm(paddle.to_tensor(x.astype("int32")),
                  paddle.to_tensor(y.astype("int64")))
    jloss.backward()
    loss, grads = _port_step(state, True, recompute=True,
                             recompute_granularity=granularity)
    assert float(loss) == pytest.approx(float(np.asarray(jloss._data)),
                                        rel=1e-5)
    jgrads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    assert set(jgrads) == set(grads)
    for name, g in grads.items():
        w = jgrads[name]
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(granularity):
    m = LlamaForCausalLM(llama_tiny(recompute=True, fused_head_loss=True,
                                    recompute_granularity=granularity,
                                    **KW), device="cpu")
    x, y = _batch(KW["vocab_size"], seed=1)
    _, loss = m(torch.from_numpy(x), torch.from_numpy(y))
    with _CountOps() as ops:
        loss.backward()
    return ops.counts


def test_policies_save_what_they_name():
    """In the backward, "full" replays 6 of each layer's 7 projections (mm,
    or addmm with a bias: the replay stops once the last tensor the
    backward needs is back, and nothing saves down_proj's output); a
    selective granularity replays none of them;
    the plain flash version's batched products (bmm) are replayed under
    "dots_with_no_batch_dims" and not under "selective"."""
    full = _backward_ops("full")
    sel = _backward_ops("selective")
    nobatch = _backward_ops("dots_with_no_batch_dims")
    layers = KW["num_hidden_layers"]

    def mms(c):
        return c.get("mm", 0) + c.get("addmm", 0)

    assert mms(full) - mms(sel) == 6 * layers
    assert mms(nobatch) == mms(sel)
    assert full.get("bmm", 0) == nobatch.get("bmm", 0) > sel.get("bmm", 0)


def _block(seed=77):
    g = torch.Generator().manual_seed(seed)
    lin1 = torch.nn.Linear(8, 16)
    lin2 = torch.nn.Linear(16, 8)
    with torch.no_grad():
        for p in (*lin1.parameters(), *lin2.parameters()):
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return lin1, lin2


def _x():
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 8)
                         .astype("float32"))
    return x.requires_grad_()


@pytest.mark.parametrize("granularity", ["full", "selective"])
def test_a_region_that_draws_replays_the_same_draws(granularity):
    """Dropout inside the region draws from torch's default generator:
    the replay restores it, so the gradients equal the plain run's with
    the same seed; the generator ends where the plain run leaves it."""
    lin1, lin2 = _block()

    def region(x):
        return lin2(torch.nn.functional.dropout(lin1(x), 0.5))

    out = []
    for use in (False, True):
        x = _x()
        for p in (*lin1.parameters(), *lin2.parameters()):
            p.grad = None
        torch.manual_seed(5)
        y = recompute(region, x, granularity=granularity) if use \
            else region(x)
        (y * y).mean().backward()
        after = torch.rand(3)
        out.append((x.grad.clone(), lin1.weight.grad.clone(), after))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_multi_argument_region():
    lin1, _ = _block()

    def region(a, b):
        return lin1(a) * b.sum()

    a, b = _x(), torch.ones(3, requires_grad=True)
    recompute(region, a, b).pow(2).mean().backward()
    a2, b2 = _x(), torch.ones(3, requires_grad=True)
    grads = (a.grad.clone(), b.grad.clone(), lin1.weight.grad.clone())
    lin1.weight.grad = None
    region(a2, b2).pow(2).mean().backward()
    assert torch.equal(grads[0], a2.grad)
    assert torch.equal(grads[1], b2.grad)
    assert torch.equal(grads[2], lin1.weight.grad)


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_recompute_sequential_segments(segments):
    torch.manual_seed(0)
    layers = [torch.nn.Linear(8, 8) for _ in range(4)]
    grads = []
    for use in (False, True):
        x = _x()
        for layer in layers:
            layer.weight.grad = None
        if use:
            y = recompute_sequential({"segments": segments}, layers, x)
        else:
            y = x
            for layer in layers:
                y = layer(y)
        y.pow(2).sum().backward()
        grads.append([x.grad.clone()] + [layer.weight.grad.clone()
                                          for layer in layers])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_recompute_hybrid_is_recompute():
    lin1, _ = _block()
    x = _x()
    y = recompute_hybrid({}, lin1, x, granularity="dots")
    assert torch.equal(y, lin1(x))


def test_unknown_granularity_and_offload_raise():
    lin1, _ = _block()
    with pytest.raises(ValueError, match="granularity"):
        recompute(lin1, _x(), granularity="bogus")
    with pytest.raises(NotImplementedError):
        recompute(lin1, _x(), offload_indices=[0])
    m = LlamaForCausalLM(llama_tiny(recompute=True,
                                    recompute_granularity="bogus", **KW),
                         device="cpu")
    with pytest.raises(ValueError, match="granularity"):
        m(torch.zeros(1, 4, dtype=torch.long))


def test_use_reentrant_is_accepted_and_runs_the_same_region():
    lin1, _ = _block()
    x = _x()
    y = recompute(lin1, x, use_reentrant=True)
    y.sum().backward()
    g = lin1.weight.grad.clone()
    lin1.weight.grad = None
    lin1(_x()).sum().backward()
    assert torch.equal(g, lin1.weight.grad)


def test_decode_step_never_recomputes():
    """The dense decode path runs the layers directly: under recompute
    its logits equal the plain model's."""
    state = _reference_state()
    outs = []
    for rc in (False, True):
        m = LlamaForCausalLM(llama_tiny(recompute=rc, **KW), device="cpu")
        m.load_reference_state(state)
        caches = m.init_cache(1, 8)
        logits, _ = m.decode_step(torch.tensor([[3, 4, 5]]), caches, 0)
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("granularity", [None] + GRANULARITIES[:5],
                         ids=["plain"] + GRANULARITIES[:5])
def test_kernel_wrappers_replay_in_the_backward(granularity, monkeypatch):
    """What ``chip_smoke.py``'s train_recompute launch gates expect, on
    the wrappers' CPU route: a step runs the RMSNorm forward 2 L + 1
    times and the flash forward L times, and under every granularity
    the backward replays each layer's two norms and its flash forward
    (2 L + 1 + 2 L and 2 L); the flash backward parts run L times
    each."""
    import importlib

    fa = importlib.import_module("paddle_tpu_torch.ops.kernels."
                                 "flash_attention")
    rn = importlib.import_module("paddle_tpu_torch.ops.kernels.rms_norm")

    calls = {"rms": 0, "fwd": 0, "dkdv": 0, "dq": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(rn, "_rms_norm_fwd",
                        counted("rms", rn._rms_norm_fwd))
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        counted("fwd", fa.flash_attention_fwd))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkdv",
                        counted("dkdv", fa.flash_attention_bwd_dkdv))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq",
                        counted("dq", fa.flash_attention_bwd_dq))
    cfg = dict(recompute=granularity is not None,
               recompute_granularity=granularity or "full")
    m = LlamaForCausalLM(llama_tiny(fused_head_loss=True, **KW, **cfg),
                         device="cpu")
    x, y = _batch(KW["vocab_size"], seed=2)
    _, loss = m(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    n = KW["num_hidden_layers"]
    replay = n if granularity is not None else 0
    assert calls == {"rms": 2 * n + 1 + 2 * replay, "fwd": n + replay,
                     "dkdv": n, "dq": n}
