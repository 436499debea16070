"""The process's place in a distributed job (counterpart of the
reference's ``distributed/env.py``).

The reference is single-controller SPMD: one process drives every
device, so its rank is always 0. The port runs one process per rank,
as upstream Paddle and ``torch.distributed`` do, so ``get_rank()`` is
this process's rank in the default process group (or, before
``init_parallel_env``, the rank its launcher gave it).

The launcher's environment is read in both contracts: the reference's
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINER_ENDPOINTS`` and
``PADDLE_MASTER``, and torch's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. Where both are set
the reference's names win.
"""
from __future__ import annotations

import os

import torch.distributed as dist


def _env_int(names, default):
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return default


def env_rank() -> int:
    """The rank the launcher gave this process (0 without one)."""
    return _env_int(("PADDLE_TRAINER_ID", "RANK"), 0)


def env_world_size() -> int:
    """The world size the launcher gave (1 without one)."""
    return _env_int(("PADDLE_TRAINERS_NUM", "WORLD_SIZE"), 1)


def env_local_rank() -> int:
    """This process's rank on its node (its rank without one)."""
    return _env_int(("PADDLE_LOCAL_RANK", "LOCAL_RANK"), env_rank())


def env_master():
    """``(host, port)`` of the rendezvous store, or None: from
    ``PADDLE_MASTER`` (``host:port``), else ``MASTER_ADDR`` and
    ``MASTER_PORT``."""
    master = os.environ.get("PADDLE_MASTER")
    if master:
        host, _, port = master.rpartition(":")
        return host, int(port)
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
    return None


def env_device_id():
    """The card the launcher named for this process
    (``FLAGS_selected_gpus``, as upstream Paddle's launcher sets it), or
    None."""
    value = os.environ.get("FLAGS_selected_gpus")
    return int(value.split(",")[0]) if value else None


class ParallelEnv:
    """The reference's view of the process: rank, world size, local
    rank, the card it is bound to and its endpoints."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size

    @property
    def local_rank(self):
        return env_local_rank()

    @property
    def dev_id(self):
        dev = env_device_id()
        return env_local_rank() if dev is None else dev

    device_id = dev_id

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None) -> int:
    """This process's rank: in ``group`` (-1 when it is not a member),
    else in the default process group, else the launcher's."""
    if group is not None:
        return group.rank
    if is_initialized():
        return dist.get_rank()
    return env_rank()


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if is_initialized():
        return dist.get_world_size()
    return env_world_size()
