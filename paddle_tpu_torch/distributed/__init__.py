"""``paddle_tpu_torch.distributed`` — the counterpart of the reference's
``paddle.distributed`` namespace over ``torch.distributed``: one
process a rank (NCCL on the card, gloo on the host), the collectives,
``init_parallel_env``, ``DataParallel``, ``spawn``, the launcher
(``python -m paddle_tpu_torch.distributed.launch``) and ``fleet``'s
data and tensor parallelism."""
from __future__ import annotations

from . import fleet, stream  # noqa: F401
from .collective import (  # noqa: F401
    Group,
    P2POp,
    ReduceOp,
    Task,
    all_gather,
    all_gather_into_tensor,
    all_reduce,
    alltoall,
    alltoall_single,
    barrier,
    batch_isend_irecv,
    broadcast,
    destroy_process_group,
    gather,
    get_group,
    irecv,
    is_available,
    isend,
    monitored_barrier,
    new_group,
    ppermute,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    wait,
)
from .env import (  # noqa: F401
    ParallelEnv,
    get_rank,
    get_world_size,
    is_initialized,
)
from .object_collectives import (  # noqa: F401
    all_gather_object,
    broadcast_object_list,
    scatter_object_list,
)
from .parallel import DataParallel, init_parallel_env  # noqa: F401
from .spawn import spawn  # noqa: F401
