"""Rotary position embedding in plain PyTorch (the counterpart of the
reference's ``ops/kernels/rope.py``, which is plain jnp there too, not
a Pallas kernel). NeoX/Llama "rotate_half" convention."""
from __future__ import annotations

import torch


def build_rope_cache(seq_len, head_dim, base=10000.0, dtype=torch.float32,
                     device=None):
    """(cos, sin), each [seq_len, head_dim]."""
    inv_freq = 1.0 / (base ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                  # (S, D/2)
    emb = torch.cat([freqs, freqs], dim=-1)           # (S, D)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_emb(x, cos, sin, position_ids=None):
    """x: [B, S, H, D]; cos/sin: [S_max, D]; ``position_ids`` [S] or
    [B, S]. Positions must lie inside the table: torch indexing faults
    where the reference's ``jnp.take`` clamps, so callers bound them
    (the serving adapter checks ``max_length`` on the host)."""
    s = x.shape[1]
    if position_ids is not None:
        c = cos[position_ids]
        sn = sin[position_ids]
        if c.dim() == 2:
            c, sn = c[None], sn[None]
        c, sn = c[:, :, None, :], sn[:, :, None, :]
    else:
        c = cos[:s][None, :, None, :]
        sn = sin[:s][None, :, None, :]
    xf = x.float()
    out = xf * c.float() + _rotate_half(xf) * sn.float()
    return out.to(x.dtype)
