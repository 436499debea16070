"""Test oracles of the port.

:func:`dense_reference_logits` is a dense, teacher-forced float32
forward of a port ``LlamaForCausalLM``, built only from the model's
weights and the plain PyTorch versions (``rms_norm_plain``, RoPE, a
dense masked softmax). No kernel and no paged cache is involved, so it
is the independent yardstick the served logits are held against, on the
CPU in the tests and on the card in ``chip_smoke.py``. Weights are cast
to float32 one at a time, so the float32 copy of a large model never
exists whole; a weight-only quantized linear (``WeightOnlyLinear``)
counts as its dequantized float32 weight, so a quantized model is held to
its own weights. :func:`dense_reference_loss_and_grads` is the training
counterpart: the same forward on float32 copies of the weights, a plain
cross-entropy over full logits, and autograd for every parameter's
gradient. Float32 matrix products run at full float32 precision on the
card (``torch.backends.cuda.matmul.allow_tf32`` is False by default;
both functions refuse to run with it on).
"""
from __future__ import annotations

import torch

from .ops.kernels.quant import dequantize_int4, dequantize_int8
from .ops.kernels.rms_norm import rms_norm_plain
from .ops.kernels.rope import apply_rotary_emb, build_rope_cache
from .quantization import WeightOnlyLinear


def _f32(t):
    return t.float()


def _weight(proj, f32):
    """The float32 [in, out] weight ``proj`` computes with: a
    ``WeightOnlyLinear``'s dequantized payload, else ``f32(weight)``."""
    if isinstance(proj, WeightOnlyLinear):
        if proj.weight_dtype == "int8":
            return dequantize_int8(proj.qweight, proj.weight_scale)
        return dequantize_int4(proj.qweight, proj.weight_scale,
                               proj.group_size)
    return f32(proj.weight)


def _linear(x, proj, f32=_f32):
    y = torch.matmul(x, _weight(proj, f32))
    if proj.bias is not None:
        y = y + f32(proj.bias)
    return y


def _refuse_tf32(name):
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{name} needs full float32 matmuls; "
                           "torch.backends.cuda.matmul.allow_tf32 is on")


def _ids(model, input_ids):
    ids = torch.as_tensor(input_ids, dtype=torch.long, device=model.device)
    return ids[None] if ids.dim() == 1 else ids


def _dense_hidden(model, ids, f32=_f32):
    """float32 hidden states after the last layer, before the final
    norm; ``f32`` maps a parameter to the float32 tensor used for it."""
    cfg = model.config
    dev = model.device
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
    x = f32(model.model.embed_tokens.weight)[ids]           # (B, S, E)
    for layer in model.model.layers:
        att = layer.self_attn
        xi = rms_norm_plain(x, f32(layer.input_layernorm.weight), eps)
        q = apply_rotary_emb(
            _linear(xi, att.q_proj, f32).reshape(b, s, nh, hd), cos, sin)
        k = apply_rotary_emb(
            _linear(xi, att.k_proj, f32).reshape(b, s, nkv, hd), cos, sin)
        v = _linear(xi, att.v_proj, f32).reshape(b, s, nkv, hd)
        qg = q.reshape(b, s, nkv, group, hd)
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / hd ** 0.5
        sc = sc.masked_fill(~keep, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, s, nh * hd)
        x = x + _linear(o, att.o_proj, f32)
        h = rms_norm_plain(x, f32(layer.post_attention_layernorm.weight),
                           eps)
        mlp = layer.mlp
        x = x + _linear(
            torch.nn.functional.silu(_linear(h, mlp.gate_proj, f32))
            * _linear(h, mlp.up_proj, f32), mlp.down_proj, f32)
    return x


def _dense_head(model, x, f32=_f32):
    h = rms_norm_plain(x, f32(model.model.norm.weight),
                       model.config.rms_norm_eps)
    if model.lm_head is not None:
        return _linear(h, model.lm_head, f32)
    return torch.matmul(h, f32(model.model.embed_tokens.weight).t())


@torch.inference_mode()
def dense_reference_logits(model, input_ids, positions=None):
    """float32 logits of ``model`` over ``input_ids`` ([S] or [B, S]),
    every position attending causally (and within
    ``config.sliding_window`` when set) to the ones before it. Returns
    [B, S, vocab], or [B, len(positions), vocab] for the listed
    positions only."""
    _refuse_tf32("dense_reference_logits")
    x = _dense_hidden(model, _ids(model, input_ids))
    if positions is not None:
        x = x[:, torch.as_tensor(positions, dtype=torch.long,
                                 device=model.device)]
    return _dense_head(model, x)


def dense_reference_loss_and_grads(model, input_ids, labels,
                                   ignore_index=-100):
    """(loss, {name: grad}) of ``model``'s next-token loss in float32:
    logits[:, t] against labels[:, t + 1], mean over the labels that are
    not ``ignore_index``, through a plain cross-entropy over the full
    logits. Every parameter is copied to a float32 leaf one at a time
    (a tied embedding is one leaf, so its two uses add up); the grads
    are float32, keyed by ``named_parameters()`` names."""
    _refuse_tf32("dense_reference_loss_and_grads")
    leaves = {name: p.detach().float().requires_grad_()
              for name, p in model.named_parameters()}
    by_id = {id(p): leaves[name] for name, p in model.named_parameters()}

    def f32(p):
        return by_id[id(p)]

    ids = _ids(model, input_ids)
    lab = _ids(model, labels)
    with torch.enable_grad():
        logits = _dense_head(model, _dense_hidden(model, ids, f32), f32)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        tgt = lab[:, 1:]
        valid = tgt != ignore_index
        picked = logp.gather(-1, torch.where(valid, tgt, 0)[..., None])
        loss = -(picked[..., 0] * valid).sum() / valid.sum().clamp_min(1)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))
