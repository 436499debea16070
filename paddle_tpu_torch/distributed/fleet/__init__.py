"""``paddle_tpu_torch.distributed.fleet`` — the hybrid-parallel training
facade (counterpart of the reference's ``distributed/fleet``)."""
from __future__ import annotations

from . import meta_parallel  # noqa: F401
from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.topology import (  # noqa: F401
    CommunicateTopology,
    HybridCommunicateGroup,
    ParallelMode,
    get_hybrid_communicate_group,
)
from .fleet import (  # noqa: F401
    Fleet,
    distributed_model,
    distributed_optimizer,
    fleet,
    init,
    reset,
    worker_index,
    worker_num,
)
from .meta_parallel.parallel_layers.random import (  # noqa: F401
    get_rng_state_tracker,
)
from .recompute import recompute  # noqa: F401

__all__ = [
    "Fleet", "fleet", "init", "reset", "DistributedStrategy",
    "HybridCommunicateGroup", "CommunicateTopology", "ParallelMode",
    "get_hybrid_communicate_group", "distributed_model",
    "distributed_optimizer", "worker_index", "worker_num", "meta_parallel",
    "get_rng_state_tracker", "recompute",
]
