"""The port's speculative decoding against its own greedy ``generate``
and the JAX package's ``speculative_generate``, on ``llama_tiny``-shaped
models in float32 on the CPU, and its sampled acceptance rule against
the reference's given the same uniforms.

Weights are drawn by the JAX models and carried across as numpy arrays.
Greedy speculative outputs must equal greedy decoding token for token,
with the reference's target-call counts. The sampled rule's
deterministic core (``_spec_accept_core``) is fed the uniforms the
reference draws from its key: the accepted count must be equal and the
final distribution within 1e-6, and the reference's own categorical draw
from the port's distribution must give its final token. Its output
distribution is checked with a torch generator as the reference's test
checks its own (total variation < 0.02 at slot 0 over 20,000 rounds).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu.models import generation as jax_generation

from paddle_tpu_torch.models import (LlamaForCausalLM, generate, llama_tiny,
                                     speculative_generate)
from paddle_tpu_torch.models import generation

_MODELS = {}


def _pair(name):
    """(jax_model, port_model): ``target`` (llama_tiny) or ``draft`` (one
    layer, other weights), built once."""
    if name not in _MODELS:
        kw = {} if name == "target" else {"num_hidden_layers": 1}
        paddle.seed(21 if name == "target" else 22)
        jm = JaxLlama(jax_tiny(**kw)).eval()
        tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
        tm.load_reference_state({k: np.asarray(v._data)
                                 for k, v in jm.state_dict().items()})
        _MODELS[name] = (jm, tm)
    return _MODELS[name]


def _prompt(seed=2, s=6):
    return np.random.RandomState(seed).randint(4, 512, (1, s)).astype(
        np.int32)


@pytest.mark.parametrize("draft", ["separate", "self"])
@pytest.mark.parametrize("draft_k", [1, 3, 4])
def test_greedy_speculative_matches_greedy_and_reference(draft, draft_k):
    jt, tt = _pair("target")
    jd, td = _pair("draft") if draft == "separate" else (jt, tt)
    ids = _prompt()
    got, stats = speculative_generate(tt, td, torch.from_numpy(ids),
                                      max_new_tokens=14, draft_k=draft_k,
                                      return_stats=True)
    want = generate(tt, torch.from_numpy(ids), max_new_tokens=14)
    assert torch.equal(got, want)
    ref, ref_stats = jax_generation.speculative_generate(
        jt, jd, paddle.to_tensor(ids), max_new_tokens=14, draft_k=draft_k,
        return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref._data))
    assert stats == ref_stats
    if draft == "self":
        # the target drafts for itself: every proposal is accepted
        assert stats["target_calls"] == 1 + -(-13 // (draft_k + 1))


@pytest.mark.parametrize("draft", ["separate", "self"])
def test_eos_inside_an_accepted_prefix(draft):
    """eos is the third greedy token: the output stops right after it,
    as the reference's does."""
    jt, tt = _pair("target")
    jd, td = _pair("draft") if draft == "separate" else (jt, tt)
    ids = _prompt()
    greedy = generate(tt, torch.from_numpy(ids), max_new_tokens=8)
    eos = int(greedy[0, ids.shape[1] + 2])
    got = speculative_generate(tt, td, torch.from_numpy(ids),
                               max_new_tokens=12, draft_k=4,
                               eos_token_id=eos)
    first = int(np.argmax(greedy[0, ids.shape[1]:].numpy() == eos))
    assert torch.equal(got, greedy[:, :ids.shape[1] + first + 1])
    ref = jax_generation.speculative_generate(
        jt, jd, paddle.to_tensor(ids), max_new_tokens=12, draft_k=4,
        eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref._data))


@pytest.mark.parametrize("kw,match", [
    ({"input_ids": np.zeros((2, 4), np.int32)}, "batch_size=1"),
    ({"draft_k": 0}, "draft_k"),
    ({"do_sample": True, "temperature": 0.0}, "temperature"),
])
def test_refusals(kw, match):
    _, tt = _pair("target")
    kw = {"input_ids": _prompt(), **kw}
    ids = torch.from_numpy(kw.pop("input_ids"))
    with pytest.raises(ValueError, match=match):
        speculative_generate(tt, tt, ids, **kw)


def test_no_new_tokens():
    _, tt = _pair("target")
    ids = torch.from_numpy(_prompt())
    out, stats = speculative_generate(tt, tt, ids, max_new_tokens=0,
                                      return_stats=True)
    assert torch.equal(out, ids) and stats["target_calls"] == 0


def _accept_case(seed, k, v, temperature):
    rng = np.random.RandomState(seed)
    p_logits = (rng.randn(k + 1, v) * 1.5).astype(np.float32)
    ql = rng.randn(k, v) * 1.5
    q = (np.exp(ql) / np.exp(ql).sum(-1, keepdims=True)).astype(np.float32)
    if seed % 3 == 0:  # a draft that agrees with the target: long accepts
        pl = p_logits[:k].astype(np.float64) / temperature
        q = (np.exp(pl) / np.exp(pl).sum(-1, keepdims=True)).astype(
            np.float32)
    props = np.array([rng.choice(v, p=q[j] / q[j].sum()) for j in range(k)],
                     np.int32)
    return p_logits, props, q


@pytest.mark.parametrize("seed", range(12))
def test_accept_core_matches_reference_given_u(seed):
    k, v = 1 + seed % 5, 16
    temperature = (1.0, 0.7, 1.6)[seed % 3]
    p_logits, props, q = _accept_case(seed, k, v, temperature)
    key = jax.random.PRNGKey(100 + seed)
    n_ref, toks_ref = jax_generation._spec_accept_sampled(
        jnp.asarray(p_logits), jnp.asarray(props), jnp.asarray(q), key,
        temperature)
    ku, kr = jax.random.split(key)
    u = np.array(jax.random.uniform(ku, (k,), jnp.float32))
    n_acc, dist = generation._spec_accept_core(
        torch.from_numpy(p_logits), torch.from_numpy(props),
        torch.from_numpy(q), torch.from_numpy(u), temperature)
    assert int(n_acc) == int(n_ref)
    # the final distribution from the reference's own building blocks
    p = np.asarray(jax.nn.softmax(jnp.asarray(p_logits) / temperature,
                                  axis=-1))
    n = int(n_ref)
    q_at = q[n] if n < k else np.zeros(v, np.float32)
    resid = np.maximum(p[n] - q_at, 0.0)
    want = resid / resid.sum() if resid.sum() > 0 else p[n]
    np.testing.assert_allclose(dist.numpy(), want, atol=1e-6, rtol=0)
    final = jax.random.categorical(kr, jnp.log(jnp.maximum(
        jnp.asarray(dist.numpy()), 1e-38)))
    assert int(final) == int(toks_ref[n])
    np.testing.assert_array_equal(np.asarray(toks_ref[:n]), props[:n])


def test_sampled_acceptance_distribution_is_the_target():
    """The reference's distribution test with a torch generator: slot 0's
    marginal is p_0, slot 1's given an acceptance is p_1."""
    v, k, n = 8, 3, 20000
    rng = np.random.RandomState(0)
    p_logits = torch.from_numpy((rng.randn(k + 1, v) * 1.5)
                                .astype(np.float32))
    ql = rng.randn(k, v) * 1.5
    q = torch.from_numpy((np.exp(ql) / np.exp(ql).sum(-1, keepdims=True))
                         .astype(np.float32))
    p = torch.softmax(p_logits, dim=-1)
    gen = torch.Generator().manual_seed(42)
    slot0, slot1 = [], []
    for _ in range(n):
        props = torch.multinomial(q, 1, generator=gen)[:, 0]
        n_acc, toks = generation._spec_accept_sampled(p_logits, props, q,
                                                      gen, 1.0)
        slot0.append(int(toks[0]))
        if int(n_acc) >= 1:
            slot1.append(int(toks[1]))
    freq0 = np.bincount(slot0, minlength=v) / n
    assert 0.5 * np.abs(freq0 - p[0].numpy()).sum() < 0.02
    freq1 = np.bincount(slot1, minlength=v) / len(slot1)
    assert 0.5 * np.abs(freq1 - p[1].numpy()).sum() < 0.03


def test_self_draft_sampled_accepts_all():
    """q = p: every proposal is accepted (u < 1 always)."""
    v, k = 6, 4
    p_logits = torch.from_numpy(np.random.RandomState(1).randn(k + 1, v)
                                .astype(np.float32))
    q = torch.softmax(p_logits[:k], dim=-1)
    gen = torch.Generator().manual_seed(7)
    for _ in range(200):
        props = torch.multinomial(q, 1, generator=gen)[:, 0]
        n_acc, toks = generation._spec_accept_sampled(p_logits, props, q,
                                                      gen, 1.0)
        assert int(n_acc) == k
        assert torch.equal(toks[:k], props)


@pytest.mark.parametrize("draft", ["separate", "self"])
def test_sampled_speculative_is_seeded(draft):
    _, tt = _pair("target")
    td = _pair("draft")[1] if draft == "separate" else tt
    ids = torch.from_numpy(_prompt())
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        runs.append(speculative_generate(
            tt, td, ids, max_new_tokens=12, draft_k=3, do_sample=True,
            temperature=0.9, generator=gen, return_stats=True))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    out, stats = runs[0]
    assert out.shape == (1, ids.shape[1] + 12)
    assert torch.equal(out[:, :ids.shape[1]], ids)
    assert ((out >= 0) & (out < 512)).all()
    assert stats["tokens"] == 12
    if draft == "self":
        # q = p at every proposal: each round accepts all three
        assert stats["target_calls"] == 1 + -(-11 // 4)
