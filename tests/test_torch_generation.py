"""The port's dense-KV decode step and its decoding strategies (greedy,
sampling, beam search) against the JAX package's, on ``llama_tiny``-
shaped models in float32 on the CPU.

Weights are drawn by the JAX model and carried across as numpy arrays
(``load_reference_state``); prompts come from numpy with a seed. The
variants: GQA 4:2; Qwen2-style q/k/v bias (random, so the bias path is
exercised) with a tied head; a Mistral-style sliding window narrower
than the sequence.

Tolerances: decode-step logits and both caches within 1e-5 absolute
(float32 through two layers, sums in another order); filtered logits
within 1e-6 with equal -inf masks; greedy and beam outputs token for
token. Draws come from a ``torch.Generator``, so sampled runs are held
to the filtered support of their own step's logits, not to the
reference's draws.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu.models import generation as jax_generation

from paddle_tpu_torch.models import LlamaForCausalLM, generate, llama_tiny
from paddle_tpu_torch.models import generation

ATOL = 1e-5
VARIANTS = {
    "gqa": {},
    "qwen2_bias_tied": {"attention_bias": True, "tie_word_embeddings": True},
    "window4": {"sliding_window": 4},
}
_MODELS = {}


def _pair(variant):
    """(jax_model, port_model) with identical weights, built once."""
    if variant not in _MODELS:
        paddle.seed(5)
        jm = JaxLlama(jax_tiny(**VARIANTS[variant])).eval()
        rng = np.random.RandomState(9)
        for name, p in jm.named_parameters():
            if name.endswith(".bias"):
                p.set_value(rng.uniform(-0.1, 0.1, p.shape)
                            .astype(np.float32))
        state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
        tm = LlamaForCausalLM(llama_tiny(**VARIANTS[variant]),
                              device="cpu")
        tm.load_reference_state(state)
        _MODELS[variant] = (jm, tm)
    return _MODELS[variant]


def _prompt(b=2, s=7, seed=1):
    return np.random.RandomState(seed).randint(4, 512, (b, s)).astype(
        np.int32)


def _jax_ids(ids):
    return paddle.to_tensor(ids)


def _np(t):
    return np.asarray(t._data)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_matches_reference(variant):
    """A 7-token prompt, then 6 one-token steps (the last position passed
    as a 0-dim tensor): logits and both caches of every layer."""
    jm, tm = _pair(variant)
    ids = _prompt()
    jc = jm.init_cache(2, 16)
    tc = tm.init_cache(2, 16)
    steps = [(ids, 0)] + [
        (np.random.RandomState(20 + i).randint(4, 512, (2, 1))
         .astype(np.int32), 7 + i) for i in range(6)]
    for i, (x, pos) in enumerate(steps):
        jl, jc = jm.decode_step(_jax_ids(x), jc,
                                paddle.to_tensor(np.int32(pos)))
        tpos = torch.tensor(pos) if i == len(steps) - 1 else pos
        caches_before = tc
        tl, tc = tm.decode_step(torch.from_numpy(x), tc, tpos)
        assert tc is caches_before  # written in place, same list
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL, rtol=0)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), _np(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), _np(jv), atol=ATOL, rtol=0)


def test_decode_step_chunked_equals_one_call():
    """A 7-token prompt through one call and through chunks of 3, 3, 1
    gives the same last logits and caches (a step's tokens see the
    earlier ones through the cache)."""
    _, tm = _pair("window4")
    ids = torch.from_numpy(_prompt(b=1))
    one = tm.init_cache(1, 10)
    lo, one = tm.decode_step(ids, one, 0)
    parts = tm.init_cache(1, 10)
    for a, b in ((0, 3), (3, 6), (6, 7)):
        lp, parts = tm.decode_step(ids[:, a:b], parts, a)
    torch.testing.assert_close(lp[:, -1], lo[:, -1], atol=ATOL, rtol=0)
    for (k1, v1), (k2, v2) in zip(one, parts):
        torch.testing.assert_close(k1, k2, atol=ATOL, rtol=0)
        torch.testing.assert_close(v1, v2, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype,want", [
    (None, torch.float32), ("bfloat16", torch.bfloat16),
    (torch.float16, torch.float16)])
def test_init_cache_shapes_and_dtypes(dtype, want):
    jm, tm = _pair("gqa")
    caches = tm.init_cache(3, 11, dtype=dtype)
    ref = jm.init_cache(3, 11)
    assert len(caches) == len(ref) == tm.config.num_hidden_layers
    for (k, v), (rk, _) in zip(caches, ref):
        assert tuple(k.shape) == tuple(v.shape) == tuple(rk.shape) \
            == (3, 11, 2, 32)
        assert k.dtype == v.dtype == want
        assert not k.any() and not v.any()


def test_decode_step_in_a_narrower_cache_dtype():
    """A float32 model writes into a bf16 cache: the first layer's slots
    hold its rounded K/V (later layers read the rounded ones)."""
    _, tm = _pair("gqa")
    ids = torch.from_numpy(_prompt())
    full = tm.init_cache(2, 8)
    half = tm.init_cache(2, 8, dtype=torch.bfloat16)
    tm.decode_step(ids, full, 0)
    tm.decode_step(ids, half, 0)
    for a, b in zip(full[0], half[0]):
        assert torch.equal(b, a.to(torch.bfloat16))


@pytest.mark.parametrize("pos,s", [(5, 4), (8, 1), (-1, 1)])
def test_decode_step_outside_the_slots_raises(pos, s):
    """The reference clamps such writes; the port refuses them."""
    _, tm = _pair("gqa")
    caches = tm.init_cache(1, 8)
    with pytest.raises(ValueError, match="slots"):
        tm.decode_step(torch.zeros(1, s, dtype=torch.long), caches, pos)


def test_decode_step_checks_the_cache_count():
    _, tm = _pair("gqa")
    with pytest.raises(ValueError, match="cache pairs"):
        tm.decode_step(torch.zeros(1, 1, dtype=torch.long),
                       tm.init_cache(1, 4)[:1], 0)


@pytest.mark.parametrize("top_k,top_p", [
    (0, 1.0), (5, 1.0), (1, 1.0), (600, 1.0), (0, 0.9), (0, 0.3),
    (0, 0.0), (7, 0.8), (40, 0.5)])
def test_filters_match_reference(top_k, top_p):
    logits = np.random.RandomState(top_k + int(top_p * 10)).randn(
        4, 512).astype(np.float32) * 3
    logits[0, :6] = logits[0].max()      # ties at the top
    logits[1, 10:20] = np.sort(logits[1])[-5]  # ties around the k-th
    ref = np.asarray(jax_generation._filter_top_k_top_p(
        jnp.asarray(logits), top_k, top_p))
    got = generation._filter_top_k_top_p(torch.from_numpy(logits), top_k,
                                         top_p).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    keep = ~np.isneginf(ref)
    np.testing.assert_allclose(got[keep], ref[keep], atol=1e-6, rtol=0)


@pytest.mark.parametrize("penalty", [1.3, 0.7])
def test_repetition_penalty_matches_reference(penalty):
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 64).astype(np.float32)
    seen = rng.rand(3, 64) < 0.3
    ref = np.asarray(jax_generation._apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(seen), penalty))
    got = generation._apply_repetition_penalty(
        torch.from_numpy(logits), torch.from_numpy(seen), penalty).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _greedy_eos(jm, ids):
    """A token the reference's greedy output emits early in row 0, so an
    eos run stops there."""
    out = _np(jax_generation.generate(jm, _jax_ids(ids), max_new_tokens=4))
    return int(out[0, ids.shape[1] + 1])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("opts", ["plain", "eos", "penalty", "eos_penalty"])
def test_greedy_matches_reference(variant, opts):
    jm, tm = _pair(variant)
    ids = _prompt()
    kw = {}
    if "eos" in opts:
        kw["eos_token_id"] = _greedy_eos(jm, ids)
    if "penalty" in opts:
        kw["repetition_penalty"] = 1.4
    ref = _np(jax_generation.generate(jm, _jax_ids(ids), max_new_tokens=9,
                                      **kw))
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=9, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if "eos" in opts:
        tail = got.numpy()[0, ids.shape[1] + 1:]
        assert (tail == kw["eos_token_id"]).all()


def test_top_k1_sampling_and_one_beam_equal_greedy():
    _, tm = _pair("gqa")
    ids = torch.from_numpy(_prompt())
    greedy = generate(tm, ids, max_new_tokens=8)
    gen = torch.Generator().manual_seed(0)
    sampled = generate(tm, ids, max_new_tokens=8, do_sample=True, top_k=1,
                       temperature=0.7, generator=gen)
    beam1 = generate(tm, ids, max_new_tokens=8, num_beams=1)
    assert torch.equal(sampled, greedy)
    assert torch.equal(beam1, greedy)


def _record_logits(model):
    """Wraps ``model.decode_step`` (an instance attribute) to keep every
    step's last logits; ``del model.decode_step`` restores it."""
    seen = []
    step = model.decode_step

    def recording(input_ids, caches, pos):
        logits, caches = step(input_ids, caches, pos)
        seen.append(logits[:, -1].clone())
        return logits, caches

    model.decode_step = recording
    return seen


@pytest.mark.parametrize("opts", [
    {"temperature": 0.8, "top_k": 50, "top_p": 0.9,
     "repetition_penalty": 1.1},
    {"temperature": 1.5, "top_k": 0, "top_p": 0.5},
    {"temperature": 1.0, "top_k": 3, "top_p": 1.0}])
def test_seeded_sampling_reproduces_within_the_support(opts):
    _, tm = _pair("qwen2_bias_tied")
    ids = torch.from_numpy(_prompt(b=3))
    runs, logits = [], []
    for _ in range(2):
        seen = _record_logits(tm)
        try:
            gen = torch.Generator().manual_seed(123)
            runs.append(generate(tm, ids, max_new_tokens=10, do_sample=True,
                                 generator=gen, **opts))
        finally:
            del tm.decode_step
        logits.append(seen)
    assert torch.equal(runs[0], runs[1])
    other = generate(tm, ids, max_new_tokens=10, do_sample=True,
                     generator=torch.Generator().manual_seed(124), **opts)
    assert not torch.equal(other, runs[0])
    out, s0 = runs[0], ids.shape[1]
    pen = opts.get("repetition_penalty", 1.0)
    for i, lg in enumerate(logits[0]):
        seen_mask = torch.zeros(3, 512, dtype=torch.bool)
        seen_mask.scatter_(1, out[:, :s0 + i].long(), True)
        lg = lg.float()
        if pen != 1.0:
            lg = generation._apply_repetition_penalty(lg, seen_mask, pen)
        lg = generation._filter_top_k_top_p(lg / opts["temperature"],
                                            opts["top_k"], opts["top_p"])
        drawn = out[:, s0 + i].long()
        assert torch.isfinite(lg.gather(1, drawn[:, None])).all(), i


@pytest.mark.parametrize("variant", ["gqa", "window4"])
@pytest.mark.parametrize("num_beams", [2, 3])
@pytest.mark.parametrize("opts", ["plain", "eos_lp_penalty"])
def test_beam_search_matches_reference(variant, num_beams, opts):
    jm, tm = _pair(variant)
    ids = _prompt()
    kw = {}
    if opts != "plain":
        kw = {"eos_token_id": _greedy_eos(jm, ids), "length_penalty": 0.6,
              "repetition_penalty": 1.3}
    ref = _np(jax_generation._beam_search(jm, _jax_ids(ids), 9, num_beams,
                                          **kw))
    got = generate(tm, torch.from_numpy(ids), max_new_tokens=9,
                   num_beams=num_beams, **kw)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_beam_search_ties_break_to_the_lowest_index():
    """Frozen beams score only eos, at zero cost, so every frozen beam's
    candidates tie at -1e30 beside it: the pick must take the lowest
    flat index first, as ``jax.lax.top_k`` does. A tiny vocab makes
    beams freeze early."""
    paddle.seed(8)
    kw = {"vocab_size": 6}
    jm = JaxLlama(jax_tiny(**kw)).eval()
    tm = LlamaForCausalLM(llama_tiny(**kw), device="cpu")
    tm.load_reference_state({k: np.asarray(v._data)
                             for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(3).randint(0, 6, (2, 5)).astype(np.int32)
    for eos in range(6):
        ref = _np(jax_generation._beam_search(jm, _jax_ids(ids), 7, 4,
                                              eos_token_id=eos))
        got = generate(tm, torch.from_numpy(ids), max_new_tokens=7,
                       num_beams=4, eos_token_id=eos)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_best_beam_reports_the_kept_score():
    scores = torch.tensor([-3.0, -2.0, -9.0, -1.0])
    lengths = torch.tensor([3, 3, 2, 1])
    gen = torch.arange(8).reshape(4, 2)
    toks, kept = generation._best_beam(gen, scores, lengths, 2, 2, 1.0)
    assert toks.tolist() == [[2, 3], [6, 7]]
    assert kept.tolist() == [-2.0, -1.0]


@pytest.mark.parametrize("call,exc", [
    # the compiled decode step is ported: its own refusals remain
    (lambda m, ids: generate(m, ids, use_jit=True, num_beams=2,
                             do_sample=True), ValueError),
    (lambda m, ids: m.generate(ids.float(), use_jit=True), ValueError),
    (lambda m, ids: generate(m, ids, num_beams=2, do_sample=True),
     ValueError),
    (lambda m, ids: generate(m, ids.float()), ValueError),
], ids=["use_jit", "method_use_jit", "beams_with_sampling", "float_ids"])
def test_generate_refuses(call, exc):
    _, tm = _pair("gqa")
    with pytest.raises(exc):
        call(tm, torch.from_numpy(_prompt()))
