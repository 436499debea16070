"""``paddle.distributed.stream.*`` (counterpart of the reference's
``distributed/stream.py``).

Upstream's stream variants choose between the communication stream and
the calculation stream. torch runs NCCL collectives on the process
group's own stream and orders the caller's current stream after them
when their task is waited on (which the synchronous form does at once),
so ``use_calc_stream`` is accepted and the semantics are those of the
plain collectives, which these delegate to.
"""
from __future__ import annotations

from . import collective as _c

__all__ = [
    "all_reduce", "all_gather", "reduce_scatter", "broadcast",
    "reduce", "scatter", "alltoall", "alltoall_single", "send", "recv",
]


def all_reduce(tensor, op=_c.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_reduce(tensor, op, group=group, sync_op=sync_op)


def all_gather(tensor_or_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_gather(tensor_or_list, tensor, group=group,
                         sync_op=sync_op)


def reduce_scatter(tensor, tensor_or_list, op=_c.ReduceOp.SUM, group=None,
                   sync_op=True, use_calc_stream=False):
    return _c.reduce_scatter(tensor, tensor_or_list, op, group=group,
                             sync_op=sync_op)


def broadcast(tensor, src, group=None, sync_op=True,
              use_calc_stream=False):
    return _c.broadcast(tensor, src, group=group, sync_op=sync_op)


def reduce(tensor, dst, op=_c.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _c.reduce(tensor, dst, op, group=group, sync_op=sync_op)


def scatter(tensor, tensor_or_list=None, src=0, group=None,
            sync_op=True, use_calc_stream=False):
    return _c.scatter(tensor, tensor_or_list, src=src, group=group,
                      sync_op=sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    return _c.alltoall(out_tensor_list, in_tensor_list, group=group,
                       sync_op=sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    return _c.alltoall_single(out_tensor, in_tensor, in_split_sizes,
                              out_split_sizes, group=group, sync_op=sync_op)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.send(tensor, dst=dst, group=group, sync_op=sync_op)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.recv(tensor, src=src, group=group, sync_op=sync_op)
