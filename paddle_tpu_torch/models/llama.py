"""Llama model family of the port (counterpart of the reference's
``models/llama.py``): ``LlamaConfig`` and its presets, and the modules
the paged serving path drives — embedding, per layer RMSNorm -> q/k/v
projections -> (paged attention in the serving adapter) -> o_proj ->
SwiGLU MLP, final norm, LM head (untied or tied).

Module and parameter names mirror the reference, so its state dict maps
1:1 (:meth:`LlamaForCausalLM.load_reference_state`). Parameters are
built directly on their device in the model dtype, with the reference's
XavierNormal scale, from a seeded ``torch.Generator`` on that device.

The dense whole-sequence ``forward`` needs the flash-attention kernel,
which comes with the training slice; it raises until then. The dense
float32 oracle the tests and ``chip_smoke.py`` compare against is
``paddle_tpu_torch.testing.dense_reference_logits``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.fleet.layers.mpu.mp_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..nn.layer.norm import RMSNorm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # Qwen2-style bias on q/k/v projections (o_proj stays bias-free)
    attention_bias: bool = False
    # Mistral-style sliding-window attention: 0 = full causal; w > 0
    # keeps keys j with 0 <= i - j < w
    sliding_window: int = 0
    # Mixtral-style sparse MoE: not ported yet (must stay 0)
    num_local_experts: int = 0
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama3_8b(**kw) -> LlamaConfig:
    """Llama-3-8B (Meta-Llama-3-8B config.json): GQA 32:8, 128k vocab,
    rope theta 500k."""
    kw.setdefault("vocab_size", 128256)
    kw.setdefault("hidden_size", 4096)
    kw.setdefault("intermediate_size", 14336)
    kw.setdefault("num_hidden_layers", 32)
    kw.setdefault("num_attention_heads", 32)
    kw.setdefault("num_key_value_heads", 8)
    kw.setdefault("max_position_embeddings", 8192)
    kw.setdefault("rope_theta", 500000.0)
    return LlamaConfig(**kw)


def qwen2_0_5b(**kw) -> LlamaConfig:
    """Qwen2-0.5B (tied embeddings, GQA 14:2, q/k/v bias)."""
    kw.setdefault("vocab_size", 151936)
    kw.setdefault("hidden_size", 896)
    kw.setdefault("intermediate_size", 4864)
    kw.setdefault("num_hidden_layers", 24)
    kw.setdefault("num_attention_heads", 14)
    kw.setdefault("num_key_value_heads", 2)
    kw.setdefault("max_position_embeddings", 32768)
    kw.setdefault("rope_theta", 1000000.0)
    kw.setdefault("attention_bias", True)
    kw.setdefault("tie_word_embeddings", True)
    kw.setdefault("rms_norm_eps", 1e-6)
    return LlamaConfig(**kw)


def mistral_7b(**kw) -> LlamaConfig:
    """Mistral-7B-v0.1: llama trunk + 4096-token sliding window,
    GQA 32:8."""
    kw.setdefault("vocab_size", 32000)
    kw.setdefault("hidden_size", 4096)
    kw.setdefault("intermediate_size", 14336)
    kw.setdefault("num_hidden_layers", 32)
    kw.setdefault("num_attention_heads", 32)
    kw.setdefault("num_key_value_heads", 8)
    kw.setdefault("max_position_embeddings", 32768)
    kw.setdefault("sliding_window", 4096)
    return LlamaConfig(**kw)


def llama_tiny(**kw) -> LlamaConfig:
    """Small config for tests (GQA 4:2 exercised)."""
    kw.setdefault("vocab_size", 512)
    kw.setdefault("hidden_size", 128)
    kw.setdefault("intermediate_size", 256)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("num_key_value_heads", 2)
    kw.setdefault("max_position_embeddings", 256)
    return LlamaConfig(**kw)


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = ColumnParallelLinear(
            h, i, has_bias=False, gather_output=False, **factory)
        self.up_proj = ColumnParallelLinear(
            h, i, has_bias=False, gather_output=False, **factory)
        self.down_proj = RowParallelLinear(
            i, h, has_bias=False, input_is_parallel=True, **factory)

    def forward(self, x):
        return self.down_proj(
            nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(nn.Module):
    """GQA attention projections. The attention itself runs in the paged
    serving adapter (``inference/paged_llama.py``) through the ragged
    paged-attention kernel; the dense ``forward`` waits for the flash
    kernel of the training slice."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        kv_out = self.num_kv_heads * self.head_dim
        qkv_bias = config.attention_bias
        h = config.hidden_size
        self.q_proj = ColumnParallelLinear(
            h, h, has_bias=qkv_bias, gather_output=False, **factory)
        self.k_proj = ColumnParallelLinear(
            h, kv_out, has_bias=qkv_bias, gather_output=False, **factory)
        self.v_proj = ColumnParallelLinear(
            h, kv_out, has_bias=qkv_bias, gather_output=False, **factory)
        self.o_proj = RowParallelLinear(
            h, h, has_bias=False, input_is_parallel=True, **factory)

    def forward(self, x):
        raise NotImplementedError(
            "dense LlamaAttention.forward needs the flash-attention "
            "kernel (training slice); serve through PagedLlamaAdapter")


class LlamaDecoderLayer(nn.Module):
    """Pre-norm block."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        device, dtype = factory.get("device"), factory.get("dtype")
        self.input_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps,
            device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config, **factory)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps,
            device=device, dtype=dtype)
        self.mlp = LlamaMLP(config, **factory)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **factory)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **factory)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size,
                            epsilon=config.rms_norm_eps,
                            device=factory.get("device"),
                            dtype=factory.get("dtype"))


class LlamaForCausalLM(nn.Module):
    """Llama causal LM. ``device`` defaults to the card (``cuda``) and
    raises without CUDA unless ``device="cpu"`` is passed; ``dtype``
    defaults to ``config.dtype``; ``seed`` seeds the generator the
    random weights are drawn from."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 seed=0):
        super().__init__()
        if config.num_local_experts:
            raise NotImplementedError(
                "Mixtral MoE layers are not ported yet")
        device = resolve_device(device)
        if dtype is None:
            dtype = _DTYPES[config.dtype or "float32"]
        elif isinstance(dtype, str):
            dtype = _DTYPES[dtype]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        factory = {"device": device, "dtype": dtype, "generator": gen}
        self.config = config
        self.model = LlamaModel(config, **factory)
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                gather_output=False, **factory)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.embed_tokens.weight.dtype

    def forward(self, input_ids, labels=None):
        raise NotImplementedError(
            "the dense LlamaForCausalLM.forward needs the flash-attention "
            "kernel (training slice); serve through "
            "inference.PagedLlamaAdapter, or use "
            "paddle_tpu_torch.testing.dense_reference_logits as the "
            "float32 oracle")

    def _head(self, h):
        if self.lm_head is not None:
            return self.lm_head(h)
        return torch.matmul(h, self.model.embed_tokens.weight.t())

    def load_reference_state(self, np_state):
        """Load the reference package's state dict given as numpy arrays
        (``{name: array}``, [in, out] linears) onto this model's device
        and dtype."""
        from .convert import from_reference_state

        state = from_reference_state(np_state, self.device, self.dtype)
        self.load_state_dict(state, strict=True)
        return self
