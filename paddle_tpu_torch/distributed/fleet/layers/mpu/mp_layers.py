"""Tensor-parallel layers of the port (counterpart of the reference's
``distributed/fleet/layers/mpu/mp_layers.py``): ``VocabParallelEmbedding``,
``ColumnParallelLinear``, ``RowParallelLinear`` and
``ParallelCrossEntropy``, Megatron's layers over an mp group.

The mp group is ``mp_group`` when given, else the active hybrid
topology's (``fleet.init``), else a group of one rank. Weights keep the
reference's [in, out] layout and parameter names, so state dicts map
1:1. Every weight is drawn whole, with the reference's ``XavierNormal``
scale, std = sqrt(2 / (fan_in + fan_out)) of the whole shape, on the
parameter's own device from the given ``torch.Generator``, and the rank
keeps its slice: a model built at mp = n holds the same global weights
as one built at mp = 1 from the same seed. A sliced parameter carries
``is_distributed = True`` (at mp > 1, as the reference sets it) and
``mp_split = (dim, nranks, rank)``, which :func:`mp_shard` reads to cut
a whole tensor the same way. ``weight_attr`` (a ``ParamAttr``) stamps
the weight as the reference's ``create_parameter`` does
(``nn/param_attr.py``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .....nn.param_attr import make_parameter
from ....collective import Group, ReduceOp, all_reduce
from ....env import get_rank
from ...base.topology import get_hybrid_communicate_group
from .mp_ops import _c_concat, _c_identity, _c_split, _mp_allreduce, \
    collective_matmul_dispatch


def mp_group_of(mp_group=None):
    """``mp_group``, else the active hybrid topology's mp group, else a
    group of this rank alone."""
    if mp_group is not None:
        return mp_group
    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.get_model_parallel_group()
    return Group([get_rank()], gid=-1, name="mp")


def mp_shard(t, split):
    """The slice of the whole tensor ``t`` that a parameter with
    ``mp_split`` ``split`` = (dim, nranks, rank) holds (``t`` itself for
    None)."""
    if split is None:
        return t
    dim, n, r = split
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size)


def _split_param(whole, dim, g, weight_attr=None, weight=True):
    """A parameter holding this rank's slice of ``whole`` along ``dim``
    over the mp group ``g`` (a weight is stamped from ``weight_attr``)."""
    n = g.nranks
    if whole.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(whole.shape)} does not "
                         f"divide over {n} mp ranks")
    split = (dim, n, g.rank) if n > 1 else None
    data = mp_shard(whole, split).clone() if n > 1 else whole
    if weight:
        p = make_parameter(data, weight_attr)
        if p is None:
            raise NotImplementedError("weight_attr=False: an mp layer "
                                      "without its weight is not ported")
    else:
        p = nn.Parameter(data)
    p.is_distributed = n > 1
    p.mp_split = split
    return p


def is_distributed(p):
    """Whether parameter ``p`` holds an mp slice (its ``is_distributed``
    attribute is True; a plain tensor's ``is_distributed`` is a
    method)."""
    return getattr(p, "is_distributed", False) is True


def xavier_normal(shape, device=None, dtype=None, generator=None):
    """A new [fan_in, fan_out] parameter tensor drawn with the
    reference's XavierNormal scale."""
    fan_in, fan_out = shape[0], shape[1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.normal_(0.0, std, generator=generator)


class VocabParallelEmbedding(nn.Module):
    """Embedding table [vocab, hidden], its rows split over mp: a rank
    looks up the ids of its rows (zeros for the others) and the lookups
    are summed over mp (``_mp_allreduce``)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, device=None, dtype=None, generator=None):
        super().__init__()
        self.mp_group = mp_group_of(mp_group)
        self.mp_degree = self.mp_group.nranks
        self.weight = _split_param(xavier_normal(
            (num_embeddings, embedding_dim), device, dtype, generator),
            0, self.mp_group, weight_attr)
        self.vocab_start = self.mp_group.rank * self.weight.shape[0]

    def forward(self, x):
        if self.mp_group.nranks == 1:
            return nn.functional.embedding(x, self.weight)
        local = x - self.vocab_start
        mine = (local >= 0) & (local < self.weight.shape[0])
        out = nn.functional.embedding(torch.where(mine, local, 0),
                                      self.weight)
        out = out * mine.unsqueeze(-1).to(out.dtype)
        return _mp_allreduce(out, group=self.mp_group)


class ColumnParallelLinear(nn.Module):
    """``y = x @ W (+ b)`` with W [in, out]: the output dim (and the
    bias) split over mp, the input's gradient summed over mp
    (``_c_identity``); ``gather_output`` gathers the rank outputs
    (``_c_concat``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, mp_group=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.mp_group = mp_group_of(mp_group)
        self.mp_degree = self.mp_group.nranks
        self.gather_output = gather_output
        self.weight = _split_param(xavier_normal(
            (in_features, out_features), device, dtype, generator),
            1, self.mp_group, weight_attr)
        self.bias = (_split_param(torch.zeros(out_features, device=device,
                                              dtype=dtype), 0, self.mp_group,
                                  weight=False)
                     if has_bias in (True, None) else None)

    def forward(self, x):
        g = self.mp_group
        collective_matmul_dispatch("mm_ag", x, self.weight, self.bias, g)
        out = torch.matmul(_c_identity(x, group=g), self.weight)
        if self.bias is not None:
            out = out + self.bias
        if self.gather_output:
            out = _c_concat(out, group=g)
        return out


class RowParallelLinear(nn.Module):
    """``y = x @ W (+ b)`` with W [in, out]: the input dim split over mp
    (``input_is_parallel=False`` slices the input, ``_c_split``), the
    partial products summed over mp (``_mp_allreduce``), the bias, whole
    on every rank, added after the sum."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, mp_group=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.mp_group = mp_group_of(mp_group)
        self.mp_degree = self.mp_group.nranks
        self.input_is_parallel = input_is_parallel
        self.weight = _split_param(xavier_normal(
            (in_features, out_features), device, dtype, generator),
            0, self.mp_group, weight_attr)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x):
        g = self.mp_group
        if not self.input_is_parallel:
            x = _c_split(x, group=g)
        collective_matmul_dispatch("mm_ar", x, self.weight, self.bias, g)
        out = _mp_allreduce(torch.matmul(x, self.weight), group=g)
        if self.bias is not None:
            out = out + self.bias
        return out


class _VocabParallelCE(torch.autograd.Function):
    """Per-token softmax CE of logits whose last dim is this rank's
    slice [start, start + V/n) of the vocab: the max, the sum of
    exponentials and the label's logit are combined over mp (MAX, then
    SUM all-reduces). Backward: softmax - one-hot on the rank's slice,
    with no collective (the gradient of the hidden state that made the
    logits is summed over mp by the ``_c_identity`` before the head)."""

    @staticmethod
    def forward(ctx, logits, labels, start, ignore_index, group):
        x = logits.float()
        valid = labels != ignore_index
        local = torch.where(valid, labels, 0) - start
        mine = (local >= 0) & (local < x.shape[-1])
        m = x.amax(dim=-1)
        all_reduce(m, ReduceOp.MAX, group=group)
        e = torch.exp(x - m.unsqueeze(-1))
        s = e.sum(dim=-1)
        all_reduce(s, ReduceOp.SUM, group=group)
        picked = x.gather(-1, local.clamp(0, x.shape[-1] - 1).unsqueeze(-1))
        target = torch.where(mine, picked.squeeze(-1), 0.0)
        all_reduce(target, ReduceOp.SUM, group=group)
        loss = torch.where(valid, torch.log(s) + m - target, 0.0)
        ctx.save_for_backward(e, s, local, mine, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, grad):
        e, s, local, mine, valid = ctx.saved_tensors
        p = e / s.unsqueeze(-1)
        hit = mine.unsqueeze(-1) & (
            torch.arange(p.shape[-1], device=p.device) == local.unsqueeze(-1))
        g = torch.where(valid, grad.float(), 0.0).unsqueeze(-1)
        return ((p - hit.float()) * g).to(ctx.dtype), None, None, None, None


class ParallelCrossEntropy(nn.Module):
    """Vocab-parallel softmax cross-entropy (upstream's
    ``c_softmax_with_cross_entropy``): ``input`` [..., V/n] holds this
    rank's slice of the logits, ``label`` [...] global vocab ids;
    returns the per-token loss [...] in float32, 0 where the label is
    ``ignore_index`` (the reference's ``reduction="none"``)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = mp_group_of(mp_group)
        self.mp_degree = self.mp_group.nranks
        self.ignore_index = ignore_index

    def forward(self, input, label):
        g = self.mp_group
        start = g.rank * input.shape[-1]
        return _VocabParallelCE.apply(input, label, start,
                                      int(self.ignore_index), g)
