"""``init_parallel_env`` and ``DataParallel`` over ``torch.distributed``
(counterpart of the reference's ``distributed/parallel.py``).

The reference builds one mesh over every device of its one process; the
port joins this process to the job's process group as one rank, bound
to one device. ``DataParallel`` takes each rank's own local batch, as
upstream Paddle's does (the reference's takes the global batch and
shards it): the average of the ranks' mean losses is the mean over the
global batch when every rank counts the same tokens.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device, set_device
from . import env as _env
from .collective import ReduceOp, _active, _resolve, all_reduce, broadcast
from .env import ParallelEnv

_BACKENDS = ("nccl", "gloo")


def _rank_device(device):
    """The device this rank runs on: ``device`` when given, else the card
    the launcher named (``FLAGS_selected_gpus``), else
    ``cuda:<local rank>``."""
    if device is None:
        idx = _env.env_device_id()
        device = f"cuda:{_env.env_local_rank() if idx is None else idx}"
    return resolve_device(device)


def init_parallel_env(strategy=None, device=None):
    """Join this process to the job as the rank its launcher gave it
    (``PADDLE_TRAINER_ID``/``RANK`` of ``PADDLE_TRAINERS_NUM``/
    ``WORLD_SIZE``; rank 0 of 1 without a launcher).

    The backend is ``PADDLE_DISTRI_BACKEND`` when set (as upstream
    Paddle reads it), else ``nccl`` on the card and ``gloo`` when the
    caller passes ``device="cpu"``; the device is :func:`_rank_device`'s,
    and becomes the port's default device (and the current CUDA device).
    Neither is ever changed on the process's own: NCCL on the CPU
    raises, and so does a card without CUDA. The rendezvous is the store
    at ``PADDLE_MASTER`` (or ``MASTER_ADDR``:``MASTER_PORT``), which the
    port's launcher hosts; a world of one needs none. Calling it again
    returns at once."""
    if _env.is_initialized():
        return ParallelEnv()
    dev = _rank_device(device)
    backend = os.environ.get("PADDLE_DISTRI_BACKEND") or (
        "gloo" if dev.type == "cpu" else "nccl")
    if backend not in _BACKENDS:
        raise ValueError(f"PADDLE_DISTRI_BACKEND={backend!r}: the port "
                         f"runs {_BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device; pass "
                         "device='cpu' for gloo on the host")
    rank, world = _env.env_rank(), _env.env_world_size()
    master = _env.env_master()
    if master is None and world != 1:
        raise RuntimeError(
            f"init_parallel_env: rank {rank} of {world} has no "
            "rendezvous (PADDLE_MASTER or MASTER_ADDR/MASTER_PORT); "
            "start the job with paddle_tpu_torch.distributed.launch "
            "or spawn")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    set_device(dev)
    if master is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        host, port = master
        dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                                rank=rank, world_size=world)
    return ParallelEnv()


def average_gradients(parameters, group, bucket_bytes=25 << 20):
    """Every gradient of ``parameters`` replaced by its mean over
    ``group``: a SUM all-reduce of buckets of up to ``bucket_bytes``
    (gradients of one dtype and device, flattened in order), then a
    division by the group's size, as the reference's
    ``fused_allreduce_gradients`` does. Parameters without a gradient
    are skipped; every rank must hold gradients for the same ones."""
    g = _resolve(group)
    if g.nranks <= 1 or not _active(g):
        return
    grads = [p.grad for p in parameters if p.grad is not None]
    buckets, current, size = [], [], 0
    for grad in grads:
        if current and (grad.dtype != current[0].dtype
                        or grad.device != current[0].device
                        or size + grad.numel() * grad.element_size()
                        > bucket_bytes):
            buckets.append(current)
            current, size = [], 0
        current.append(grad)
        size += grad.numel() * grad.element_size()
    if current:
        buckets.append(current)
    with torch.no_grad():
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            all_reduce(flat, ReduceOp.SUM, group=g)
            flat.div_(g.nranks)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


class DataParallel(nn.Module):
    """Data parallelism over ``group`` (the world by default): the
    parameters and buffers are broadcast from the group's first rank at
    construction, and every backward pass ends by averaging the
    gradients over the group (:func:`average_gradients`, in buckets of
    ``comm_buffer_size`` MB), queued on the autograd engine when the
    first gradient of the pass lands. ``no_sync()`` skips the average,
    so gradients accumulate locally until a pass outside it."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._group = _resolve(group)
        self._bucket_bytes = int(comm_buffer_size) << 20
        self._sync = True
        self._queued = False
        g = self._group
        if _active(g) and g.nranks > 1:
            with torch.no_grad():
                for t in list(layers.parameters()) + list(layers.buffers()):
                    broadcast(t.data, g.ranks[0], group=g)
            for p in layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._grad_ready)

    def _grad_ready(self, _param):
        if self._sync and not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._average)

    def _average(self):
        self._queued = False
        average_gradients(self._layers.parameters(), self._group,
                          self._bucket_bytes)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        prev, self._sync = self._sync, False
        try:
            yield
        finally:
            self._sync = prev

    def scale_loss(self, loss):
        return loss

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict):
        return self._layers.load_state_dict(state_dict)
