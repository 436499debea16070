"""Tensor-parallel layers of the port at degree 1 (counterpart of the
reference's ``distributed/fleet/layers/mpu/mp_layers.py``).

Weights keep the reference's [in, out] layout and parameter names, so
state dicts map 1:1. Random initialisation follows the reference's
``XavierNormal`` scale, std = sqrt(2 / (fan_in + fan_out)), drawn on the
parameter's own device from the given ``torch.Generator``. Model
parallelism (an ``mp_group`` of more than one rank) is the distributed
slice's work and raises here.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _mp_degree(mp_group) -> int:
    n = 1 if mp_group is None else int(mp_group.size())
    if n > 1:
        raise NotImplementedError(
            f"model-parallel degree {n}: the port's mp layers run at "
            "degree 1 only")
    return n


def xavier_normal(shape, device=None, dtype=None, generator=None):
    """A new [fan_in, fan_out] parameter tensor drawn with the
    reference's XavierNormal scale."""
    fan_in, fan_out = shape[0], shape[1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.normal_(0.0, std, generator=generator)


class VocabParallelEmbedding(nn.Module):
    """Embedding table [vocab, hidden]."""

    def __init__(self, num_embeddings, embedding_dim, mp_group=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        _mp_degree(mp_group)
        self.weight = nn.Parameter(xavier_normal(
            (num_embeddings, embedding_dim), device, dtype, generator))

    def forward(self, x):
        return nn.functional.embedding(x, self.weight)


class ColumnParallelLinear(nn.Module):
    """``y = x @ W (+ b)`` with W [in, out] (output split over mp in the
    reference; whole here)."""

    def __init__(self, in_features, out_features, has_bias=None,
                 gather_output=True, mp_group=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        _mp_degree(mp_group)
        self.weight = nn.Parameter(xavier_normal(
            (in_features, out_features), device, dtype, generator))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias in (True, None) else None)

    def forward(self, x):
        out = torch.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out


class RowParallelLinear(nn.Module):
    """``y = x @ W (+ b)`` with W [in, out] (input split over mp in the
    reference; whole here)."""

    def __init__(self, in_features, out_features, has_bias=True,
                 input_is_parallel=False, mp_group=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        _mp_degree(mp_group)
        self.weight = nn.Parameter(xavier_normal(
            (in_features, out_features), device, dtype, generator))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x):
        out = torch.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out
