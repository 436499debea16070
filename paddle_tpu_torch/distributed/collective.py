"""Communication groups and collectives over ``torch.distributed``
(counterpart of the reference's ``distributed/collective.py``).

The reference is single-controller SPMD: a group names mesh axes and a
collective is a ``lax`` collective inside a ``shard_map``. Here each
rank is a process, a :class:`Group` wraps a torch ``ProcessGroup``, and
a collective moves real data between the processes: NCCL on the card,
gloo on the host.

Each collective keeps the reference's signature and its per-rank
result inside a ``shard_map``, with these differences, which are
upstream Paddle's semantics:

- ranks are real: ``src``, ``dst`` and a point-to-point ``peer`` are
  global ranks (the reference's ``P2POp`` peer is an offset, every rank
  sending to ``rank + peer``); ``ppermute``'s pairs are group ranks, as
  the reference's axis positions are;
- ``broadcast`` copies ``src``'s tensor to every rank (the reference,
  holding one copy of every array, returns the tensor unchanged);
- ``ReduceOp.PROD`` multiplies (the reference's manual path sums).

As in the reference, ``reduce`` leaves its result on every rank, and
``gather`` fills the list on every rank. With ``sync_op=True`` a
collective returns its output (a tensor written in place, or the list
it extended); with ``sync_op=False`` it returns a :class:`Task` whose
``wait()`` orders the caller's current CUDA stream after the collective
(NCCL) or blocks until it is done (gloo), and then finishes what the
collective computes on the host side (``AVG``'s division). A group of
one rank with no process group behind it (before
``init_parallel_env``, or an axis of degree 1 of the hybrid topology)
computes its one-rank result locally. A rank that is not in the group
does nothing, as upstream.
"""
from __future__ import annotations

import datetime
import itertools
import time

import torch
import torch.distributed as dist

from . import env as _env


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


def _torch_op(op):
    """The torch reduction of ``op``: AVG is a SUM divided afterwards
    (the reference's ``pmean`` is ``psum / n``)."""
    ops = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
           ReduceOp.MIN: dist.ReduceOp.MIN,
           ReduceOp.PROD: dist.ReduceOp.PRODUCT,
           ReduceOp.AVG: dist.ReduceOp.SUM}
    if op not in ops:
        raise ValueError(f"unknown ReduceOp {op!r}")
    return ops[op]


class Group:
    """A communication group: its members' global ``ranks`` (ascending,
    as torch orders them), this process's ``rank`` in it (-1 when not a
    member), its ``id`` and the torch ``process_group`` behind it (None
    for a one-rank group computed locally)."""

    def __init__(self, ranks, gid, process_group=None, name=None):
        self._ranks = list(ranks)
        self.id = gid
        self.process_group = process_group
        self._name = name or f"group_{gid}"

    @property
    def ranks(self):
        return list(self._ranks)

    @property
    def nranks(self):
        return len(self._ranks)

    world_size = nranks

    @property
    def rank(self):
        return self.get_group_rank(_env.get_rank())

    @property
    def name(self):
        return self._name

    def get_group_rank(self, rank):
        """The group rank of global ``rank`` (-1 when not a member)."""
        return self._ranks.index(rank) if rank in self._ranks else -1

    def __repr__(self):
        return (f"Group(id={self.id}, name={self._name}, "
                f"ranks={self._ranks})")


_GROUPS = {}
_WORLD = []
_GIDS = itertools.count(1)


def _world_group():
    if not _WORLD:
        if _env.is_initialized():
            _WORLD.append(Group(range(dist.get_world_size()), 0,
                                dist.group.WORLD, name="world"))
        else:
            _WORLD.append(Group([0], 0, None, name="world"))
    return _WORLD[0]


def _register(ranks, process_group, name=None):
    gid = next(_GIDS)
    g = Group(ranks, gid, process_group, name)
    _GROUPS[gid] = g
    return g


def new_group(ranks=None, backend=None, timeout=None):
    """A group over the global ``ranks`` (all by default). Like torch's
    ``new_group``, every rank of the job must call it, members or not,
    in the same order."""
    world = _env.get_world_size()
    ranks = sorted(range(world) if ranks is None else set(ranks))
    if any(r < 0 or r >= world for r in ranks):
        raise ValueError(f"new_group: ranks {ranks} outside the world of "
                         f"{world}")
    if not _env.is_initialized():
        if ranks != [0]:
            raise RuntimeError("new_group over several ranks needs "
                               "init_parallel_env() first")
        return _register(ranks, None)
    if isinstance(timeout, (int, float)):
        timeout = datetime.timedelta(seconds=timeout)
    pg = dist.new_group(ranks, timeout=timeout, backend=backend)
    return _register(ranks, pg)


def _local_group(name=None):
    """A one-rank group of this process, with no process group behind it
    (an axis of degree 1): collectives on it compute locally."""
    return _register([_env.get_rank()], None, name)


def get_group(gid=0):
    if gid == 0:
        return _world_group()
    return _GROUPS.get(gid)


def _resolve(group):
    return _world_group() if group is None else group


def is_available():
    return dist.is_available()


def destroy_process_group(group=None):
    """Destroy ``group``'s process group, or (``None``) every group and
    the default process group."""
    if group is not None:
        _GROUPS.pop(group.id, None)
        if group.process_group is not None and _env.is_initialized():
            dist.destroy_process_group(group.process_group)
        return
    _GROUPS.clear()
    _WORLD.clear()
    if _env.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# tasks
# --------------------------------------------------------------------------


class Task:
    """Handle of an asynchronous collective (upstream
    ``ProcessGroup::Task``): ``wait()`` waits for its works and then
    runs what finishes the result."""

    def __init__(self, works=(), then=None, result=None):
        self._works = list(works)
        self._then = then
        self.result = result

    def wait(self, timeout=None):
        for w in self._works:
            w.wait()
        if self._then is not None:
            then, self._then = self._then, None
            then()
        return True

    def is_completed(self):
        return self._then is None and all(w.is_completed()
                                          for w in self._works)

    def synchronize(self):
        self.wait()


def _finish(works, result, sync_op, then=None):
    task = Task(works, then, result)
    if sync_op:
        task.wait()
        return result
    return task


def _active(g):
    """Whether ``g`` runs a real collective: False for a rank outside
    the group (nothing to do) and for a local one-rank group."""
    return g.process_group is not None and g.rank >= 0


def _check_rank(g, rank, what):
    if rank not in g.ranks:
        raise ValueError(f"{what}: rank {rank} is not in {g}")


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group, in place on every rank."""
    g = _resolve(group)
    top = _torch_op(op)
    if not _active(g):
        return _finish([], tensor, sync_op)
    work = dist.all_reduce(tensor, op=top, group=g.process_group,
                           async_op=True)
    then = (lambda: tensor.div_(g.nranks)) if op == ReduceOp.AVG else None
    return _finish([work], tensor, sync_op, then)


def _gather_into(out, tensor, g):
    """Work of an all-gather of ``tensor`` into the rows of ``out``
    ([nranks, *tensor.shape]); a local one-rank group copies."""
    if not _active(g):
        out[0].copy_(tensor)
        return []
    return [dist.all_gather(list(out.unbind(0)), tensor.contiguous(),
                            group=g.process_group, async_op=True)]


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's ``tensor``: appended to ``tensor_list`` (in group
    rank order) when it is a list, else returned stacked along a new
    ``axis`` (the reference's ``tiled=False`` gather at axis 0)."""
    g = _resolve(group)
    stacked = tensor.new_empty((max(g.nranks, 1),) + tuple(tensor.shape))
    works = _gather_into(stacked, tensor, g)
    if isinstance(tensor_list, list):
        tensor_list.extend(stacked.unbind(0))
        return _finish(works, tensor_list, sync_op)
    return _finish(works, stacked.movedim(0, axis), sync_op)


def all_gather_into_tensor(out_tensor, tensor, group=None, sync_op=True):
    """Every rank's ``tensor`` written into ``out_tensor``
    (``nranks * tensor.numel()`` elements, filled rank after rank)."""
    g = _resolve(group)
    if not out_tensor.is_contiguous() or \
            out_tensor.numel() != g.nranks * tensor.numel():
        raise ValueError(
            f"all_gather_into_tensor: output of shape "
            f"{tuple(out_tensor.shape)} cannot hold {g.nranks} x "
            f"{tuple(tensor.shape)} contiguously")
    works = _gather_into(out_tensor.view((g.nranks,) + tuple(tensor.shape)),
                         tensor, g)
    return _finish(works, out_tensor, sync_op)


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Reduce the concatenation of ``tensor_or_tensor_list`` (a list of
    one tensor a rank, or a tensor split along dim 0) over the group;
    group rank i gets chunk i in ``tensor``."""
    g = _resolve(group)
    top = _torch_op(op)
    src = tensor_or_tensor_list
    chunks = list(src) if isinstance(src, (list, tuple)) \
        else list(src.chunk(max(g.nranks, 1), 0))
    if not _active(g):
        tensor.copy_(torch.cat(chunks, 0).reshape(tensor.shape))
        return _finish([], tensor, sync_op)
    if len(chunks) != g.nranks:
        raise ValueError(f"reduce_scatter: {len(chunks)} chunks for "
                         f"{g.nranks} ranks")
    work = dist.reduce_scatter(tensor, [c.contiguous() for c in chunks],
                               op=top, group=g.process_group, async_op=True)
    then = (lambda: tensor.div_(g.nranks)) if op == ReduceOp.AVG else None
    return _finish([work], tensor, sync_op, then)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Global rank ``src``'s ``tensor`` copied into every rank's."""
    g = _resolve(group)
    if not _active(g):
        return _finish([], tensor, sync_op)
    _check_rank(g, src, "broadcast")
    work = dist.broadcast(tensor, src, group=g.process_group, async_op=True)
    return _finish([work], tensor, sync_op)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's ``tensor``, on every rank (the reference's delivery,
    a superset of upstream's ``dst`` only): appended to ``gather_list``,
    or returned stacked along a new axis 0."""
    g = _resolve(group)
    if _active(g):
        _check_rank(g, dst, "gather")
    return all_gather(gather_list, tensor, group=g, sync_op=sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Group rank i receives ``tensor_list[i]`` as global rank ``src``
    holds it, into ``tensor``."""
    g = _resolve(group)
    if not _active(g):
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return _finish([], tensor, sync_op)
    _check_rank(g, src, "scatter")
    chunks = None
    if _env.get_rank() == src:
        if tensor_list is None or len(tensor_list) != g.nranks:
            raise ValueError(f"scatter: the source needs {g.nranks} "
                             "tensors")
        chunks = [t.contiguous() for t in tensor_list]
    work = dist.scatter(tensor, chunks, src=src, group=g.process_group,
                        async_op=True)
    return _finish([work], tensor, sync_op)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """``all_reduce``: the result lands on every rank, ``dst`` included
    (the reference's semantics)."""
    g = _resolve(group)
    if _active(g):
        _check_rank(g, dst, "reduce")
    return all_reduce(tensor, op, g, sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Group rank j's ``in_tensor_list[i]`` lands in group rank i's
    ``out_tensor_list`` at position j."""
    g = _resolve(group)
    if not _active(g):
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return _finish([], out_tensor_list, sync_op)
    if len(in_tensor_list) != g.nranks:
        raise ValueError(f"alltoall: {len(in_tensor_list)} tensors for "
                         f"{g.nranks} ranks")
    outs = [torch.empty_like(t) for t in in_tensor_list]
    work = dist.all_to_all(outs, [t.contiguous() for t in in_tensor_list],
                           group=g.process_group, async_op=True)
    out_tensor_list.extend(outs)
    return _finish([work], out_tensor_list, sync_op)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """``in_tensor`` split along dim 0 (equally, or by
    ``in_split_sizes``), chunk i to group rank i; what arrives is
    concatenated into ``out_tensor``."""
    g = _resolve(group)
    if not _active(g):
        out_tensor.copy_(in_tensor)
        return _finish([], out_tensor, sync_op)
    work = dist.all_to_all_single(out_tensor, in_tensor.contiguous(),
                                  out_split_sizes, in_split_sizes,
                                  group=g.process_group, async_op=True)
    return _finish([work], out_tensor, sync_op)


def send(tensor, dst=0, group=None, sync_op=True):
    """Send ``tensor`` to global rank ``dst``."""
    g = _resolve(group)
    _check_rank(g, dst, "send")
    work = dist.isend(tensor.contiguous(), dst, group=g.process_group)
    return _finish([work], None, sync_op)


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor`` from global rank ``src``."""
    g = _resolve(group)
    _check_rank(g, src, "recv")
    work = dist.irecv(tensor, src, group=g.process_group)
    return _finish([work], None, sync_op)


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


class P2POp:
    """One point-to-point operation of :func:`batch_isend_irecv`:
    ``op`` is :func:`isend` or :func:`irecv`, ``peer`` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("op must be paddle.distributed.isend/irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """Start every operation of the list together; returns their tasks.
    A one-rank group sends to itself: each receive gets the send at its
    position."""
    if not p2p_op_list:
        return []
    g = _resolve(p2p_op_list[0].group)
    if g.process_group is None:
        sends = [o for o in p2p_op_list if o.op is isend]
        recvs = [o for o in p2p_op_list if o.op is irecv]
        for s, r in zip(sends, recvs):
            r.tensor.copy_(s.tensor)
        return [Task()]
    ops = [dist.P2POp(dist.isend if o.op is isend else dist.irecv,
                      o.tensor if o.op is irecv else o.tensor.contiguous(),
                      o.peer, group=_resolve(o.group).process_group)
           for o in p2p_op_list]
    return [Task([w]) for w in dist.batch_isend_irecv(ops)]


def ppermute(tensor, perm, group=None):
    """A new tensor: group rank ``d`` receives group rank ``s``'s
    ``tensor`` for each pair ``(s, d)`` of ``perm``; a rank that receives
    nothing gets zeros (``lax.ppermute``'s semantics)."""
    g = _resolve(group)
    me = g.rank
    out = torch.zeros_like(tensor)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(tensor)
        elif s == me:
            ops.append(P2POp(isend, tensor, g.ranks[d], g))
        elif d == me:
            ops.append(P2POp(irecv, out, g.ranks[s], g))
    for task in batch_isend_irecv(ops):
        task.wait()
    return out


def barrier(group=None):
    g = _resolve(group)
    if _active(g):
        dist.barrier(group=g.process_group)


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until the work that writes ``tensor`` on its card
    is done (upstream ``paddle.distributed.wait``)."""
    if tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    return tensor


_MONITORED_SEQ = {}


def monitored_barrier(group=None, timeout=None, wait_all_ranks=False):
    """A barrier that raises ``RuntimeError`` when the group's ranks do
    not all arrive within ``timeout`` seconds (300 by default). Arrival
    is counted in the job's rendezvous store, so it works over NCCL as
    over gloo (torch's own ``monitored_barrier`` is gloo's only)."""
    g = _resolve(group)
    if not _active(g):
        return
    seq = _MONITORED_SEQ.get(g.id, 0)
    _MONITORED_SEQ[g.id] = seq + 1
    store = dist.distributed_c10d._get_default_store()
    key = f"paddle_tpu_torch/monitored_barrier/{g.id}/{seq}"
    store.add(key, 1)
    limit = 300.0 if timeout is None else float(
        timeout.total_seconds() if isinstance(timeout, datetime.timedelta)
        else timeout)
    deadline = time.monotonic() + limit
    while True:
        arrived = store.add(key, 0)
        if arrived >= g.nranks:
            return
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"monitored_barrier: rank {_env.get_rank()} waited "
                f"{limit} s and {arrived} of {g.nranks} ranks of {g} "
                "arrived")
        time.sleep(0.01)
