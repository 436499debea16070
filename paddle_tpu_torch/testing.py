"""Test oracles of the port.

:func:`dense_reference_logits` is a dense, teacher-forced float32
forward of a port ``LlamaForCausalLM``, built only from the model's
weights and the plain PyTorch versions (``rms_norm_plain``, RoPE, a
dense masked softmax). No kernel and no paged cache is involved, so it
is the independent yardstick the served logits are held against, on the
CPU in the tests and on the card in ``chip_smoke.py``. Weights are cast
to float32 one at a time, so the float32 copy of a large model never
exists whole. Float32 matrix products run at full float32 precision on
the card (``torch.backends.cuda.matmul.allow_tf32`` is False by
default; this function refuses to run with it on).
"""
from __future__ import annotations

import torch

from .ops.kernels.rms_norm import rms_norm_plain
from .ops.kernels.rope import apply_rotary_emb, build_rope_cache


def _linear(x, proj):
    y = torch.matmul(x, proj.weight.float())
    if proj.bias is not None:
        y = y + proj.bias.float()
    return y


@torch.inference_mode()
def dense_reference_logits(model, input_ids, positions=None):
    """float32 logits of ``model`` over ``input_ids`` ([S] or [B, S]),
    every position attending causally (and within
    ``config.sliding_window`` when set) to the ones before it. Returns
    [B, S, vocab], or [B, len(positions), vocab] for the listed
    positions only."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dense_reference_logits needs full float32 "
                           "matmuls; torch.backends.cuda.matmul."
                           "allow_tf32 is on")
    cfg = model.config
    dev = model.device
    ids = torch.as_tensor(input_ids, dtype=torch.long, device=dev)
    if ids.dim() == 1:
        ids = ids[None]
    b, s = ids.shape
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    group = nh // nkv
    eps = cfg.rms_norm_eps
    cos, sin = build_rope_cache(s, hd, base=cfg.rope_theta,
                                dtype=torch.float32, device=dev)
    pos = torch.arange(s, device=dev)
    keep = pos[None, :] <= pos[:, None]                     # (q, k)
    if cfg.sliding_window:
        keep = keep & (pos[:, None] - pos[None, :] < cfg.sliding_window)
    x = model.model.embed_tokens.weight[ids].float()        # (B, S, E)
    for layer in model.model.layers:
        att = layer.self_attn
        xi = rms_norm_plain(x, layer.input_layernorm.weight.float(), eps)
        q = apply_rotary_emb(_linear(xi, att.q_proj).reshape(b, s, nh, hd),
                             cos, sin)
        k = apply_rotary_emb(_linear(xi, att.k_proj).reshape(b, s, nkv, hd),
                             cos, sin)
        v = _linear(xi, att.v_proj).reshape(b, s, nkv, hd)
        qg = q.reshape(b, s, nkv, group, hd)
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / hd ** 0.5
        sc = sc.masked_fill(~keep, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, s, nh * hd)
        x = x + _linear(o, att.o_proj)
        h = rms_norm_plain(x, layer.post_attention_layernorm.weight.float(),
                           eps)
        mlp = layer.mlp
        x = x + _linear(torch.nn.functional.silu(_linear(h, mlp.gate_proj))
                        * _linear(h, mlp.up_proj), mlp.down_proj)
    if positions is not None:
        x = x[:, torch.as_tensor(positions, dtype=torch.long, device=dev)]
    h = rms_norm_plain(x, model.model.norm.weight.float(), eps)
    if model.lm_head is not None:
        return _linear(h, model.lm_head)
    return torch.matmul(h, model.model.embed_tokens.weight.float().t())
