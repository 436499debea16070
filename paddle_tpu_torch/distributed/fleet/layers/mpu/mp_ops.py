"""Tensor-parallel communication as autograd functions (counterpart of
the reference's ``distributed/fleet/layers/mpu/mp_ops.py``), with the
reference's forward/backward pairs over the mp group:

- ``_c_identity``: identity forward, SUM all-reduce backward;
- ``_mp_allreduce``: SUM all-reduce forward, identity backward;
- ``_c_split``: the rank's slice of the last dim forward, all-gather
  backward;
- ``_c_concat``: all-gather of the last dim forward, the rank's slice
  backward.

Each is the identity on a group of one rank. The backward collectives
run in autograd's backward, on the stream the forward ran on; every
rank runs the same graph, so they run in the same order on every rank.

``collective_matmul_dispatch`` and ``grad_allreduce_dispatch`` are
where the reference routes a matmul and its collective, or the dp
gradient sync, through its ring kernels (``FLAGS_collective_matmul``,
``FLAGS_collective_dtype``). The port has no ring kernels yet: they
always decline, so the plain chain runs, and at an mp or dp degree
above 1 a flag that asks for a ring (``on``, ``auto``, or a wire dtype
other than ``off``) raises ``NotImplementedError``. The port's
``FLAGS_collective_matmul`` defaults to ``off`` (the reference's to
``auto``); the rings compute the same function as the plain chain.
"""
from __future__ import annotations

import torch

from .....framework.flags import flag
from ....collective import ReduceOp, _resolve, all_gather, all_reduce


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        all_reduce(grad, ReduceOp.SUM, group=ctx.group)
        return grad, None


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        out = x.contiguous().clone()
        all_reduce(out, op, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _last_dim_slice(x, group):
    n, r = group.nranks, group.rank
    size = x.shape[-1] // n
    return x[..., r * size:(r + 1) * size].contiguous()


def _last_dim_gather(x, group):
    parts = all_gather([], x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _last_dim_slice(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _last_dim_gather(grad, ctx.group), None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _last_dim_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _last_dim_slice(grad, ctx.group), None


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    """Identity forward / SUM all-reduce of the gradient over ``group``."""
    g = _resolve(group)
    return tensor if g.nranks == 1 else _CIdentity.apply(tensor, g)


def _mp_allreduce(tensor, op=ReduceOp.SUM, group=None,
                  use_calc_stream=True, use_model_parallel=True):
    """All-reduce forward / identity backward over ``group``."""
    g = _resolve(group)
    return tensor if g.nranks == 1 else _MpAllreduce.apply(tensor, g, op)


def _check_divides(tensor, g, what):
    if tensor.shape[-1] % g.nranks:
        raise ValueError(f"{what}: last dim {tensor.shape[-1]} does not "
                         f"divide over {g.nranks} ranks")


def _c_split(tensor, group=None):
    """The rank's slice of the last dim forward / all-gather backward."""
    g = _resolve(group)
    if g.nranks == 1:
        return tensor
    _check_divides(tensor, g, "_c_split")
    return _CSplit.apply(tensor, g)


def _c_concat(tensor, group=None):
    """All-gather of the last dim forward / the rank's slice backward."""
    g = _resolve(group)
    return tensor if g.nranks == 1 else _CConcat.apply(tensor, g)


_MODES = ("off", "on", "auto")


def _refuse_rings(group, what):
    """Raise when a flag asks for a ring at a degree above 1."""
    mode = str(flag("collective_matmul"))
    if mode not in _MODES:
        raise ValueError(f"FLAGS_collective_matmul must be off|on|auto, "
                         f"got {mode!r}")
    wire = str(flag("collective_dtype"))
    if _resolve(group).nranks > 1 and (mode != "off" or wire != "off"):
        raise NotImplementedError(
            f"{what}: FLAGS_collective_matmul={mode!r}, "
            f"FLAGS_collective_dtype={wire!r}: the ring-decomposed "
            "collectives are not ported yet; set both to 'off'")


def collective_matmul_dispatch(kind, x, w, bias=None, group=None,
                               axis=None, seq_axis=0):
    """The ring route of a matmul and its collective: always None (the
    caller runs its plain chain); raises as :func:`_refuse_rings`."""
    _refuse_rings(group, f"collective_matmul_dispatch({kind!r})")
    return None


def grad_allreduce_dispatch(tensor, group=None):
    """The ring route of the dp gradient sync: always None; raises as
    :func:`_refuse_rings`."""
    _refuse_rings(group, "grad_allreduce_dispatch")
    return None


def split(x, size, operation="linear", axis=0, num_partitions=1,
          gather_out=True, weight_attr=None, bias_attr=None, name=None):
    raise NotImplementedError(
        "paddle.distributed.split: use ColumnParallelLinear / "
        "RowParallelLinear directly")
