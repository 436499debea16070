"""The port's HF Llama-family loader (``models.convert.from_hf``) against
transformers and against the JAX package's ``load_hf_llama``, in
float32 on the CPU.

Tiny random HF models (Llama, Qwen2 with random q/k/v biases, Mistral
with a sliding window narrower and wider than the sequence) are built
from configs written here, as ``tests/test_hf_convert.py`` builds them;
no checkpoint is downloaded. Tolerances: logits within 2e-4 of
transformers' and of the reference's (float32 through two layers, the
same bound as the reference's own HF test); greedy generation token for
token against ``hf.generate(do_sample=False)``; loaded parameters bit
for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.models as jax_models
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.convert import from_hf as jax_from_hf

import paddle_tpu_torch.models as port_models
from paddle_tpu_torch.models import LlamaForCausalLM, from_hf, llama_tiny

transformers = pytest.importorskip("transformers")

TOL = 2e-4
_BASE = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256,
             rope_theta=10000.0, attn_implementation="eager")
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              {"rms_norm_eps": 1e-5, "tie_word_embeddings": False}, {}),
    "llama_tied": ("LlamaConfig", "LlamaForCausalLM",
                   {"rms_norm_eps": 1e-5, "tie_word_embeddings": True},
                   {"tie_word_embeddings": True}),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM",
              {"rms_norm_eps": 1e-6, "tie_word_embeddings": False},
              {"attention_bias": True, "rms_norm_eps": 1e-6}),
    "qwen2_tied": ("Qwen2Config", "Qwen2ForCausalLM",
                   {"rms_norm_eps": 1e-6, "tie_word_embeddings": True},
                   {"attention_bias": True, "rms_norm_eps": 1e-6,
                    "tie_word_embeddings": True}),
    "mistral_w8": ("MistralConfig", "MistralForCausalLM",
                   {"rms_norm_eps": 1e-5, "sliding_window": 8},
                   {"sliding_window": 8}),
    "mistral_w64": ("MistralConfig", "MistralForCausalLM",
                    {"rms_norm_eps": 1e-5, "sliding_window": 64},
                    {"sliding_window": 64}),
}
_HF = {}


def _hf(family):
    """A random tiny HF model of ``family`` (biases randomised: HF zeroes
    them) and the port config of the same shape."""
    cfg_cls, model_cls, hf_kw, port_kw = FAMILIES[family]
    if family not in _HF:
        cfg = getattr(transformers, cfg_cls)(**_BASE, **hf_kw)
        torch.manual_seed(len(_HF) + 3)
        hf = getattr(transformers, model_cls)(cfg).eval()
        with torch.no_grad():
            for n, p in hf.named_parameters():
                if n.endswith("bias"):
                    p.uniform_(-0.1, 0.1)
        _HF[family] = hf
    return _HF[family], llama_tiny(**port_kw)


def _ids(seed=0, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, 512, shape)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_transformers_and_reference(family):
    hf, cfg = _hf(family)
    port = from_hf(LlamaForCausalLM(cfg, device="cpu", seed=1),
                   hf.state_dict())
    ids = _ids(shape=(2, 16))
    with torch.no_grad():
        ref_hf = hf(torch.tensor(ids)).logits.numpy()
        got = port(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, ref_hf, rtol=TOL, atol=TOL)
    paddle.seed(0)
    jm = JaxLlama(getattr(jax_models, "llama_tiny")(
        **dataclasses.asdict(cfg))).eval()
    jax_from_hf(jm, hf.state_dict())
    ref_jax = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32)))._data)
    np.testing.assert_allclose(got, ref_jax, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("family", ["llama", "qwen2_tied", "mistral_w8"])
def test_greedy_generation_matches_transformers(family):
    hf, cfg = _hf(family)
    port = from_hf(LlamaForCausalLM(cfg, device="cpu"), hf.state_dict())
    ids = np.random.RandomState(1).randint(4, 512, (2, 10))
    with torch.no_grad():
        ref = hf.generate(torch.tensor(ids), max_new_tokens=8,
                          do_sample=False, pad_token_id=0).numpy()
    got = port.generate(torch.tensor(ids), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), ref)


def _loaded_equal(model, state, dtype=torch.float32):
    for name, p in model.state_dict().items():
        src = torch.as_tensor(np.asarray(state[name]) if not isinstance(
            state[name], torch.Tensor) else state[name])
        if src.dim() == 2 and "embed_tokens" not in name:
            src = src.t()
        assert torch.equal(p, src.to(dtype)), name


def test_parameters_are_copied_bit_for_bit_in_place():
    hf, cfg = _hf("qwen2")
    port = LlamaForCausalLM(cfg, device="cpu", seed=4)
    before = {n: p.data_ptr() for n, p in port.named_parameters()}
    assert from_hf(port, hf.state_dict()) is port
    assert {n: p.data_ptr() for n, p in port.named_parameters()} == before
    _loaded_equal(port, hf.state_dict())


def test_bf16_tensors_and_numpy_arrays_load():
    hf, cfg = _hf("llama")
    bf16 = {k: v.to(torch.bfloat16) for k, v in hf.state_dict().items()}
    port = from_hf(LlamaForCausalLM(cfg, device="cpu"), bf16)
    _loaded_equal(port, bf16)
    as_np = {k: v.numpy() for k, v in hf.state_dict().items()}
    port_np = from_hf(LlamaForCausalLM(cfg, device="cpu"), as_np)
    _loaded_equal(port_np, as_np)
    port_bf16 = from_hf(LlamaForCausalLM(cfg, device="cpu",
                                         dtype=torch.bfloat16), as_np)
    _loaded_equal(port_bf16, as_np, dtype=torch.bfloat16)


def test_tied_head_ignores_lm_head_and_rotary_buffers():
    hf, cfg = _hf("llama_tied")
    state = dict(hf.state_dict())
    state["lm_head.weight"] = torch.zeros(512, 128)
    state["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(16)
    port = from_hf(LlamaForCausalLM(cfg, device="cpu"), state)
    assert port.lm_head is None
    assert torch.equal(port.model.embed_tokens.weight,
                       hf.model.embed_tokens.weight)


def _strict_cases():
    def missing(s):
        del s["model.layers.1.mlp.up_proj.weight"]

    def unused(s):
        s["model.layers.9.mlp.up_proj.weight"] = torch.zeros(256, 128)

    def shape(s):
        s["model.layers.0.self_attn.k_proj.weight"] = torch.zeros(32, 128)

    return {"missing": (missing, KeyError, "no weights for"),
            "unused": (unused, KeyError, "unused HF keys"),
            "shape": (shape, ValueError, "shape mismatch")}


@pytest.mark.parametrize("case", list(_strict_cases()))
def test_strict_mode_errors(case):
    """A missing or unused key raises before any parameter changes."""
    edit, exc, match = _strict_cases()[case]
    hf, cfg = _hf("llama")
    state = dict(hf.state_dict())
    edit(state)
    port = LlamaForCausalLM(cfg, device="cpu", seed=2)
    before = {n: p.clone() for n, p in port.state_dict().items()}
    with pytest.raises(exc, match=match):
        from_hf(port, state)
    if exc is KeyError:
        assert all(torch.equal(p, before[n])
                   for n, p in port.state_dict().items())


def test_not_strict_skips_missing_and_unused_keys():
    hf, cfg = _hf("llama")
    state = dict(hf.state_dict())
    cases = _strict_cases()
    cases["missing"][0](state)
    cases["unused"][0](state)
    port = LlamaForCausalLM(cfg, device="cpu", seed=6)
    kept = port.model.layers[1].mlp.up_proj.weight.clone()
    from_hf(port, state, strict=False)
    assert torch.equal(port.model.layers[1].mlp.up_proj.weight, kept)
    assert torch.equal(port.model.layers[0].mlp.up_proj.weight,
                       hf.model.layers[0].mlp.up_proj.weight.t())
    cases["shape"][0](state)
    with pytest.raises(ValueError, match="shape mismatch"):
        from_hf(port, state, strict=False)


PRESETS = ["llama2_7b", "llama2_13b", "llama3_8b", "llama3_70b",
           "qwen2_7b", "qwen2_0_5b", "mistral_7b", "llama_headline",
           "llama_tiny"]


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal_the_reference(name):
    port = getattr(port_models, name)()
    ref = getattr(jax_models, name)() if hasattr(jax_models, name) else \
        getattr(jax_models.llama, name)()
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.num_params() == ref.num_params()
    # the fields the port leaves out stay at the reference's defaults
    ref_default = type(ref)()
    port_fields = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        if f.name not in port_fields:
            assert getattr(ref, f.name) == getattr(ref_default, f.name), \
                f.name
