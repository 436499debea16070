"""Llama model family of the port (counterpart of the reference's
``models/llama.py``): ``LlamaConfig`` and its presets, and the modules
of both paths — embedding, per layer RMSNorm -> q/k/v projections ->
attention -> o_proj -> SwiGLU MLP, final norm, LM head (untied or tied).

The dense whole-sequence ``forward`` is the training path: RoPE, the
flash-attention kernels (each decoder layer a recomputed region when
``config.recompute``), and with ``labels`` the next-token loss, either
through the chunked fused CE head (``fused_head_loss``, no logits) or
through ``LlamaPretrainingCriterion`` over full logits. The paged
serving adapter (``inference/paged_llama.py``) drives the same modules'
projections around its own attention kernel. ``decode_step`` is the
dense-KV generation path (``models/generation.py``): the new tokens'
K/V are written in place into preallocated cache slots
(``init_cache``), and attention over all slots runs in float32.

Module and parameter names mirror the reference, so its state dict maps
1:1 (:meth:`LlamaForCausalLM.load_reference_state`).

Under tensor parallelism (``fleet.init`` with ``mp_degree`` n > 1 before
the model is built) each rank holds its shard, as Megatron lays it out:
``num_heads / n`` query and ``num_kv_heads / n`` KV heads (q/k/v column
split, o_proj row split), the MLP's intermediate width split the same
way, and the vocabulary (embedding and head) split by rows.
The training forward then runs the same kernels on the rank's heads;
the vocab-parallel CE head combines the ranks' statistics. Serving and
decoding at n > 1 raise ``NotImplementedError``. Parameters are
built directly on their device in the model dtype, with the reference's
XavierNormal scale, from a seeded ``torch.Generator`` on that device.
The float32 oracles the tests and ``chip_smoke.py`` compare against are
in ``paddle_tpu_torch.testing``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.fleet.recompute import recompute
from ..distributed.fleet.layers.mpu.mp_layers import (
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    mp_group_of,
    mp_shard,
)
from ..distributed.fleet.layers.mpu.mp_ops import _c_concat, _c_identity
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..ops.kernels.fused_loss import fused_linear_cross_entropy_vocab_parallel
from ..nn.functional import cross_entropy, flash_attention
from ..nn.layer.norm import RMSNorm
from ..ops.kernels.rope import apply_rotary_emb, build_rope_cache
from .generation import generate as _generate

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
    recompute: bool = False
    # "full" replays the whole layer in backward; "selective"/
    # "core_attn"/"dots" keep matmul outputs and replay only the glue
    # (and the kernels); "dots_with_no_batch_dims" keeps mm/addmm only
    # (upstream recompute_granularity — fleet/recompute)
    recompute_granularity: str = "full"
    # chunked fused linear+CE loss head: never materializes the [T, V]
    # logits (ops/kernels/fused_loss.py); forward returns (None, loss)
    fused_head_loss: bool = False
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

    def num_params(self) -> int:
        """Total parameter count (for the MFU arithmetic)."""
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        kvh = self.num_key_value_heads * self.head_dim
        per_layer = 2 * h * h + 2 * h * kvh + 3 * h * i + 2 * h
        if self.attention_bias:
            per_layer += h + 2 * kvh
        emb = v * h * (1 if self.tie_word_embeddings else 2)
        return per_layer * self.num_hidden_layers + emb + h


def llama2_7b(**kw) -> LlamaConfig:
    """Llama-2-7B: the config's defaults (MHA 32:32, 32k vocab)."""
    return LlamaConfig(**kw)


def llama2_13b(**kw) -> LlamaConfig:
    """Llama-2-13B: hidden 5120, 40 layers, MHA 40:40."""
    return LlamaConfig(
        hidden_size=5120, intermediate_size=13824, num_hidden_layers=40,
        num_attention_heads=40, num_key_value_heads=40, **kw,
    )


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


def llama3_70b(**kw) -> LlamaConfig:
    """Llama-3-70B: hidden 8192, 80 layers, GQA 64:8 (a config only: its
    bf16 weights do not fit one card)."""
    kw.setdefault("vocab_size", 128256)
    kw.setdefault("hidden_size", 8192)
    kw.setdefault("intermediate_size", 28672)
    kw.setdefault("num_hidden_layers", 80)
    kw.setdefault("num_attention_heads", 64)
    kw.setdefault("num_key_value_heads", 8)
    kw.setdefault("max_position_embeddings", 8192)
    kw.setdefault("rope_theta", 500000.0)
    return LlamaConfig(**kw)


def qwen2_7b(**kw) -> LlamaConfig:
    """Qwen2-7B: llama trunk + q/k/v bias, GQA 28:4, 152k vocab."""
    kw.setdefault("vocab_size", 152064)
    kw.setdefault("hidden_size", 3584)
    kw.setdefault("intermediate_size", 18944)
    kw.setdefault("num_hidden_layers", 28)
    kw.setdefault("num_attention_heads", 28)
    kw.setdefault("num_key_value_heads", 4)
    kw.setdefault("max_position_embeddings", 32768)
    kw.setdefault("rope_theta", 1000000.0)
    kw.setdefault("attention_bias", True)
    kw.setdefault("rms_norm_eps", 1e-6)
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


def llama_headline(**kw) -> LlamaConfig:
    """``bench.py``'s single-card headline shape (~470M parameters, tied
    head, fused CE head): the repository's own shape, not a published
    model."""
    kw.setdefault("vocab_size", 32000)
    kw.setdefault("hidden_size", 1536)
    kw.setdefault("intermediate_size", 4224)
    kw.setdefault("num_hidden_layers", 14)
    kw.setdefault("num_attention_heads", 12)
    kw.setdefault("num_key_value_heads", 12)
    kw.setdefault("max_position_embeddings", 2048)
    kw.setdefault("tie_word_embeddings", True)
    kw.setdefault("fused_head_loss", True)
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


class DecodeStep(NamedTuple):
    """What every layer of one decode step shares: the new tokens' first
    slot ``pos``, their RoPE rows ``cos``/``sin`` ([S, D]) and ``keep``
    ([S, S_max], the slots each new token attends to). With a device
    position, ``pos`` is None and ``slots`` holds the new tokens' slots
    ([S], on the device)."""
    pos: object
    cos: torch.Tensor
    sin: torch.Tensor
    keep: torch.Tensor
    slots: object = None


def decode_step_inputs(config, pos, s, tables):
    """The :class:`DecodeStep` of ``s`` new tokens at positions
    [pos, pos + s) of a cache whose ``tables`` are ``(cos, sin, kpos)``
    (:meth:`LlamaModel.decode_tables`).

    An int ``pos`` slices the tables on the host, and raises
    ``ValueError`` when the tokens do not fit the slots: the reference's
    ``dynamic_update_slice`` and ``jnp.take`` clamp instead. A 0-d
    device tensor ``pos`` is never read on the host, so a captured
    decode step (``jit.to_static``) reads it at every replay: the RoPE
    rows and the mask come from device index ops, and the bounds check
    is the caller's, which knows the positions as ints
    (``models/generation.py``)."""
    cos, sin, kpos = tables
    smax = kpos.shape[0]
    if isinstance(pos, torch.Tensor):
        slots = pos.to(kpos.dtype) + torch.arange(s, device=kpos.device)
        keep = kpos[None, :] <= slots[:, None]
        w = int(config.sliding_window or 0)
        if w:
            keep = keep & (kpos[None, :] > slots[:, None] - w)
        return DecodeStep(None, cos.index_select(0, slots),
                          sin.index_select(0, slots), keep, slots)
    pos = int(pos)
    if pos < 0 or pos + s > smax:
        raise ValueError(f"decode_step: positions [{pos}, {pos + s}) do "
                         f"not fit the cache's {smax} slots")
    positions = kpos[pos:pos + s]
    keep = kpos[None, :] <= positions[:, None]
    w = int(config.sliding_window or 0)
    if w:
        keep = keep & (kpos[None, :] > positions[:, None] - w)
    return DecodeStep(pos, cos[pos:pos + s], sin[pos:pos + s], keep)


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
    """GQA attention. The dense ``forward`` runs the flash-attention
    kernels (causal, K/V never repeated); the paged serving adapter uses
    the projections around its ragged paged-attention kernel."""

    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        kv_out = self.num_kv_heads * self.head_dim
        qkv_bias = config.attention_bias
        h = config.hidden_size
        mp = mp_group_of(factory.get("mp_group")).nranks
        if self.num_kv_heads % mp or self.num_heads % mp:
            raise NotImplementedError(
                f"{self.num_heads}:{self.num_kv_heads} heads over {mp} mp "
                "ranks: a column shard would split a head (the "
                "reference repeats the KV heads on global arrays)")
        self.q_proj = ColumnParallelLinear(
            h, h, has_bias=qkv_bias, gather_output=False, **factory)
        self.k_proj = ColumnParallelLinear(
            h, kv_out, has_bias=qkv_bias, gather_output=False, **factory)
        self.v_proj = ColumnParallelLinear(
            h, kv_out, has_bias=qkv_bias, gather_output=False, **factory)
        self.o_proj = RowParallelLinear(
            h, h, has_bias=False, input_is_parallel=True, **factory)
        # this rank's heads
        self.num_heads //= mp
        self.num_kv_heads //= mp

    def forward(self, x, cos, sin):
        """``cos``/``sin``: the RoPE tables of positions 0..s-1
        (``build_rope_cache``), built once per forward by ``LlamaModel``."""
        b, s = x.shape[0], x.shape[1]
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q = apply_rotary_emb(self.q_proj(x).reshape(b, s, nh, hd), cos, sin)
        k = apply_rotary_emb(self.k_proj(x).reshape(b, s, nkv, hd), cos,
                             sin)
        v = self.v_proj(x).reshape(b, s, nkv, hd)
        # w >= s makes the band inert (plain causal)
        w = int(self.config.sliding_window or 0)
        out, _ = flash_attention(q, k, v, causal=True,
                                 window=w if (w and w < s) else 0)
        return self.o_proj(out.reshape(b, s, nh * hd))

    def decode_step(self, x, cache_k, cache_v, step):
        """KV-cache attention for ``x`` [B, S, H], new tokens at the
        positions of ``step`` (:func:`decode_step_inputs`): RoPE at those
        positions, their K/V written in place into ``cache_k``/``cache_v``
        [B, S_max, KVH, D], then float32 attention over every slot,
        masked to the slots at or before each token's position (and
        inside the sliding window). Returns the attention's output."""
        b, s = x.shape[0], x.shape[1]
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        # step.cos/sin hold the rows of the new positions only
        q = apply_rotary_emb(self.q_proj(x).reshape(b, s, nh, hd), step.cos,
                             step.sin)
        k = apply_rotary_emb(self.k_proj(x).reshape(b, s, nkv, hd),
                             step.cos, step.sin)
        v = self.v_proj(x).reshape(b, s, nkv, hd)
        if step.slots is not None:  # a device position
            cache_k.index_copy_(1, step.slots, k)
            cache_v.index_copy_(1, step.slots, v)
        else:
            cache_k[:, step.pos:step.pos + s] = k
            cache_v[:, step.pos:step.pos + s] = v
        # q heads grouped over their kv head: the reference's repeated
        # K/V give the same sums
        qg = q.float().reshape(b, s, nkv, nh // nkv, hd)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                              cache_k.float()) * (1.0 / hd ** 0.5)
        scores.masked_fill_(~step.keep, -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs, cache_v.float())
        out = out.to(q.dtype).reshape(b, s, nh * hd)
        return self.o_proj(out)


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

    def forward(self, x, cos, sin):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))

    def decode_step(self, x, cache_k, cache_v, step):
        h = x + self.self_attn.decode_step(self.input_layernorm(x), cache_k,
                                           cache_v, step)
        return h + self.mlp(self.post_attention_layernorm(h))


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

    def forward(self, input_ids):
        h = self.embed_tokens(input_ids)
        cfg = self.config
        cos, sin = build_rope_cache(h.shape[1], cfg.head_dim,
                                    base=cfg.rope_theta, dtype=torch.float32,
                                    device=h.device)
        if cfg.recompute:
            for layer in self.layers:
                h = recompute(layer, h, cos, sin,
                              granularity=cfg.recompute_granularity)
        else:
            for layer in self.layers:
                h = layer(h, cos, sin)
        return self.norm(h)

    def decode_step(self, input_ids, caches, pos):
        """The final norm's output for the new tokens ``input_ids``
        [B, S] at positions [pos, pos + S), and ``caches`` (one
        ``(k, v)`` pair a layer, written in place)."""
        if len(caches) != len(self.layers):
            raise ValueError(f"decode_step: {len(caches)} cache pairs for "
                             f"{len(self.layers)} layers")
        h = self.embed_tokens(input_ids)
        step = decode_step_inputs(self.config, pos, h.shape[1],
                                  self.decode_tables(caches[0][0].shape[1],
                                                     h.device))
        for layer, (ck, cv) in zip(self.layers, caches):
            h = layer.decode_step(h, ck, cv, step)
        return self.norm(h), caches

    def decode_tables(self, smax, device):
        """``(cos, sin, kpos)`` of a cache of ``smax`` slots: the RoPE
        tables ([smax, D], float32) and the slot positions ([smax]),
        built on the first decode step over such a cache and kept for
        the steps after it."""
        key = (smax, torch.device(device))
        kept = getattr(self, "_decode_tables", None)
        if kept is None or kept[0] != key:
            cfg = self.config
            cos, sin = build_rope_cache(smax, cfg.head_dim,
                                        base=cfg.rope_theta,
                                        dtype=torch.float32, device=device)
            kept = (key, (cos, sin, torch.arange(smax, device=device)))
            self._decode_tables = kept
        return kept[1]


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
        self.mp_group = mp_group_of()
        factory = {"device": device, "dtype": dtype, "generator": gen,
                   "mp_group": self.mp_group}
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
        """Logits [B, S, V] without labels. With labels [B, S]
        (next-token targets, shifted here): ``(None, loss)`` through the
        fused CE head when ``config.fused_head_loss``, else
        ``(logits, loss)``.

        At mp > 1 the logits are gathered whole; the fused head is the
        vocab-parallel one, over the whole sequence with the labels
        shifted by padding the last with -100 (as the reference's), and
        falls back to the unfused criterion (``ParallelCrossEntropy``)
        when the sequence does not divide by the degree."""
        h = self.model(input_ids)
        g = self.mp_group
        if labels is not None and self._fused_loss_active(labels):
            tied = self.lm_head is None
            w = (self.model.embed_tokens.weight if tied
                 else self.lm_head.weight)  # [V, H] tied / [H, V] linear
            if g.nranks > 1:
                shifted = torch.cat([labels[:, 1:], labels.new_full(
                    (labels.shape[0], 1), -100)], dim=1)
                return None, fused_linear_cross_entropy_vocab_parallel(
                    h, w if tied else w.t(), shifted, group=g)
            # h[:, :-1] predicts labels[:, 1:]; the chunked head never
            # builds the logits, so there are none to return
            return None, fused_linear_cross_entropy(
                h[:, :-1], w, labels[:, 1:], transpose_w=not tied)
        logits = self._head(h)
        if g.nranks == 1:
            if labels is None:
                return logits
            return logits, LlamaPretrainingCriterion()(logits, labels)
        if labels is None:
            return _c_concat(logits, group=g)
        tgt = labels[:, 1:]
        per_tok = ParallelCrossEntropy(mp_group=g)(logits[:, :-1], tgt)
        loss = per_tok.sum() / (tgt != -100).sum().clamp_min(1)
        return _c_concat(logits, group=g), loss

    def _fused_loss_active(self, labels):
        """The fused head runs at mp 1, and at mp n > 1 when the
        sequence divides by n (the vocabulary does: its rows are split)."""
        if not self.config.fused_head_loss:
            return False
        return labels.shape[-1] % self.mp_group.nranks == 0

    def _head(self, h):
        """This rank's logits (its vocab slice at mp > 1, where the
        hidden state's gradient is summed over mp, by ``lm_head``'s own
        ``_c_identity`` or the tied head's)."""
        if self.lm_head is not None:
            return self.lm_head(h)
        h = _c_identity(h, group=self.mp_group)
        return torch.matmul(h, self.model.embed_tokens.weight.t())

    def _refuse_mp(self, what):
        if self.mp_group.nranks > 1:
            raise NotImplementedError(
                f"{what} at mp degree {self.mp_group.nranks}: "
                "model-parallel serving and decoding are not ported yet")

    # -- decode ----------------------------------------------------------

    def init_cache(self, batch_size, max_length, dtype=None):
        """Zeroed KV cache slots, one ``(k, v)`` pair a layer, each
        [batch_size, max_length, KVH, D] on the model's device, in the
        model's dtype unless ``dtype`` is given."""
        self._refuse_mp("init_cache")
        cfg = self.config
        if dtype is None:
            dtype = self.dtype
        elif isinstance(dtype, str):
            dtype = _DTYPES[dtype]
        shape = (batch_size, max_length, cfg.num_key_value_heads,
                 cfg.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(cfg.num_hidden_layers)]

    @torch.no_grad()
    def decode_step(self, input_ids, caches, pos):
        """One incremental step: ``(logits [B, S, V], caches)`` for the
        new tokens ``input_ids`` [B, S] at positions [pos, pos + S).
        Their K/V are written into ``caches`` in place, and the same list
        is returned. ``pos`` is an int, or a 0-d tensor on the model's
        device that is never read on the host (what a compiled step
        takes; the caller then checks ``pos + S <= S_max``). Runs without
        autograd."""
        self._refuse_mp("decode_step")
        h, caches = self.model.decode_step(input_ids, caches, pos)
        return self._head(h), caches

    def generate(self, input_ids, max_new_tokens=32, use_jit=False,
                 **kwargs):
        """Decode over the dense KV cache: greedy by default; sampling
        (``do_sample``, ``temperature``, ``top_k``, ``top_p``,
        ``repetition_penalty``, ``generator``), ``eos_token_id`` and beam
        search (``num_beams``) as :func:`models.generation.generate`.
        Returns [B, S0 + max_new_tokens]."""
        self._refuse_mp("generate")
        return _generate(self, input_ids, max_new_tokens=max_new_tokens,
                         use_jit=use_jit, **kwargs)

    def load_reference_state(self, np_state):
        """Load the reference package's state dict given as numpy arrays
        (``{name: array}``, [in, out] linears, whole) onto this model's
        device and dtype; at mp > 1 each parameter keeps this rank's
        slice."""
        from .convert import from_reference_state

        splits = {n: getattr(p, "mp_split", None)
                  for n, p in self.named_parameters()}
        state = from_reference_state(np_state, self.device, self.dtype,
                                     splits)
        self.load_state_dict(state, strict=True)
        return self


class LlamaPretrainingCriterion(nn.Module):
    """Next-token mean CE: logits[:, t] predicts labels[:, t + 1]; the
    mean runs over the labels that are not ``ignore_index``."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        return cross_entropy(logits[:, :-1], labels[:, 1:],
                             reduction="mean",
                             ignore_index=self.ignore_index)
