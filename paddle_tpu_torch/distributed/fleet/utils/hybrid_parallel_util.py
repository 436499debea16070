"""Hybrid-parallel helpers (counterpart of the reference's
``fleet/utils/hybrid_parallel_util.py``): the dp gradient average and
the parameter and input broadcasts over the topology's groups. The
reference's single controller holds one copy of every array, so its
broadcasts do nothing and its gradients arrive summed; here each rank
holds its own, and these move them."""
from __future__ import annotations

import torch

from ...collective import broadcast
from ...parallel import average_gradients
from ..layers.mpu.mp_layers import is_distributed
from ..layers.mpu.mp_ops import grad_allreduce_dispatch

__all__ = [
    "fused_allreduce_gradients",
    "broadcast_input_data",
    "broadcast_mp_parameters",
    "broadcast_dp_parameters",
    "broadcast_sharding_parameters",
]


def fused_allreduce_gradients(parameter_list, hcg=None):
    """Every gradient averaged over the dp group (the world without
    ``hcg``): a SUM all-reduce in buckets, then a division by the dp
    world, as the reference's (``parallel.average_gradients``)."""
    group = hcg.get_data_parallel_group() if hcg is not None else None
    grad_allreduce_dispatch(None, group)
    average_gradients(list(parameter_list), group)


def _broadcast(tensors, group):
    if group is None or group.nranks <= 1:
        return
    with torch.no_grad():
        for t in tensors:
            broadcast(t.data if isinstance(t, torch.nn.Parameter) else t,
                      group.ranks[0], group=group)


def broadcast_input_data(hcg, *inputs, **kwargs):
    """The mp group's first rank's inputs on every mp rank (tensors are
    broadcast in place; the rest passes through). Returns
    ``(inputs, kwargs)``, as upstream."""
    group = hcg.get_model_parallel_group()
    _broadcast([t for t in list(inputs) + list(kwargs.values())
                if isinstance(t, torch.Tensor)], group)
    return inputs, kwargs


def broadcast_mp_parameters(model, hcg):
    """The parameters that are not split over mp (``is_distributed``
    False), from the mp group's first rank."""
    _broadcast([p for p in model.parameters()
                if not is_distributed(p)],
               hcg.get_model_parallel_group())


def broadcast_dp_parameters(model, hcg):
    _broadcast(list(model.parameters()), hcg.get_data_parallel_group())


def broadcast_sharding_parameters(model, hcg):
    _broadcast(list(model.parameters()), hcg.get_sharding_parallel_group())
