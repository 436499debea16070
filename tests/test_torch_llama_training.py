"""The PyTorch port's Llama training step against the JAX package's, on
small float32 models on the CPU.

Weights are copied from the JAX model with ``load_reference_state``
(``{k: np.asarray(v._data)}`` of its state dict), so no test relies on
the two packages seeding alike. Both sides run the reference's step:
``model(x, y) -> loss``, ``loss.backward()``, ``AdamW.step()``,
``clear_grad()``. The JAX model's attention takes its XLA path off the
TPU; the port's wrappers, handed CPU tensors, run their plain versions.
Models: ``llama_tiny`` (GQA 4:2, untied head) and a Qwen2-shaped tiny
config (q/k/v bias, tied embeddings, GQA 3:1, head_dim 64), each with
the fused CE head and the unfused criterion, and one sliding window
narrower than the sequence.

Tolerances (float32 through two layers, products summed in another
order): loss within 1e-5 relative; every gradient within 1e-4 of its
largest entry; the three-step loss trajectory within 1e-5 relative.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.optimizer as jax_optim
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu.models import qwen2_0_5b as jax_qwen

import torch

from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny, qwen2_0_5b
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.testing import dense_reference_loss_and_grads

B, S = 2, 16
SHAPES = {
    "llama": (jax_tiny, llama_tiny,
              dict(hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, vocab_size=256)),
    "qwen2": (jax_qwen, qwen2_0_5b,
              dict(hidden_size=192, intermediate_size=256,
                   num_hidden_layers=2, num_attention_heads=3,
                   num_key_value_heads=1, vocab_size=384,
                   max_position_embeddings=64)),
    "window": (jax_tiny, llama_tiny,
               dict(hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, vocab_size=256,
                    sliding_window=6)),
}


_MODELS = {}


def _pair(shape, fused):
    """(jax_model, port_model) with identical weights. One pair per shape
    is built (the JAX model compiles on its first call) and handed out
    with its first weights restored and the head chosen by ``fused``."""
    if shape not in _MODELS:
        jax_cfg_fn, port_cfg_fn, kw = SHAPES[shape]
        paddle.seed(5)
        jm = JaxLlama(jax_cfg_fn(**kw))
        state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
        tm = LlamaForCausalLM(port_cfg_fn(**kw), device="cpu")
        _MODELS[shape] = (jm, tm, state)
    jm, tm, state = _MODELS[shape]
    for name, p in jm.named_parameters():
        p.set_value(state[name])
        p.clear_grad()
    tm.load_reference_state(state)
    tm.zero_grad(set_to_none=True)
    jm.config.fused_head_loss = tm.config.fused_head_loss = fused
    return jm, tm


def _batch(vocab, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, vocab, size=(B, S))
    y = rng.randint(0, vocab, size=(B, S))
    y[0, 3] = -100  # an ignored label
    return x, y


def _jax_loss(jm, x, y):
    out = jm(paddle.to_tensor(x.astype("int32")),
             paddle.to_tensor(y.astype("int64")))
    return out[1]


def _port_loss(tm, x, y):
    logits, loss = tm(torch.from_numpy(x), torch.from_numpy(y))
    return logits, loss


CASES = [(s, f) for s in ("llama", "qwen2") for f in (True, False)] + [
    ("window", True)]


@pytest.mark.parametrize("shape,fused", CASES,
                         ids=[f"{s}-{'fused' if f else 'unfused'}"
                              for s, f in CASES])
def test_loss_and_every_gradient_match_jax(shape, fused):
    jm, tm = _pair(shape, fused)
    x, y = _batch(tm.config.vocab_size)
    jloss = _jax_loss(jm, x, y)
    jloss.backward()
    logits, loss = _port_loss(tm, x, y)
    assert (logits is None) == fused
    loss.backward()
    want = float(np.asarray(jloss._data))
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    jgrads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    tgrads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(tgrads) == set(jgrads)
    for name, g in tgrads.items():
        w = jgrads[name]
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("shape,fused", [("llama", True), ("qwen2", False)])
def test_three_adamw_steps_follow_jax(shape, fused):
    jm, tm = _pair(shape, fused)
    x, y = _batch(tm.config.vocab_size, seed=1)
    jo = jax_optim.AdamW(1e-2, parameters=jm.parameters(),
                         multi_precision=True)
    to = AdamW(1e-2, parameters=tm.parameters(), multi_precision=True)
    jl, tl = [], []
    for _ in range(3):
        loss = _jax_loss(jm, x, y)
        loss.backward()
        jo.step()
        jo.clear_grad()
        jl.append(float(np.asarray(loss._data)))
        _, loss = _port_loss(tm, x, y)
        loss.backward()
        to.step()
        to.clear_grad()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("shape", ["qwen2", "window"])
def test_float32_oracle_matches_the_step(shape):
    """``testing.dense_reference_loss_and_grads`` (plain functions only)
    agrees with the step through the port's modules."""
    _, tm = _pair(shape, True)
    x, y = _batch(tm.config.vocab_size, seed=2)
    _, loss = _port_loss(tm, x, y)
    loss.backward()
    ref_loss, ref = dense_reference_loss_and_grads(tm, x, y)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    for name, p in tm.named_parameters():
        w = ref[name].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_logits_without_labels_and_recompute_raises():
    """Logits without labels; recompute now runs, and what it refuses
    raises: an unknown granularity, as in the reference."""
    _, tm = _pair("llama", False)
    x, _ = _batch(tm.config.vocab_size)
    assert tuple(tm(torch.from_numpy(x)).shape) == (B, S, 256)
    m = LlamaForCausalLM(llama_tiny(recompute=True,
                                    recompute_granularity="offload"),
                         device="cpu")
    with pytest.raises(ValueError, match="granularity"):
        m(torch.from_numpy(x))


def test_num_params_matches_the_reference_and_the_model():
    for shape in ("llama", "qwen2"):
        jax_cfg_fn, port_cfg_fn, kw = SHAPES[shape]
        cfg = port_cfg_fn(**kw)
        assert cfg.num_params() == jax_cfg_fn(**kw).num_params()
        tm = LlamaForCausalLM(cfg, device="cpu")
        assert cfg.num_params() == sum(p.numel() for p in tm.parameters())
    assert qwen2_0_5b().num_params() == 494_032_768
