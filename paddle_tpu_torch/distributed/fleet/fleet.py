"""The fleet facade (counterpart of the reference's
``distributed/fleet/fleet.py``): ``fleet.init`` builds the hybrid
topology's process groups, ``distributed_model`` and
``distributed_optimizer`` wrap a model and its optimizer for the
parallel mode, with the reference's dispatch.

The port runs data and tensor parallelism. A sharding, pipeline,
sequence or expert degree above 1 raises ``NotImplementedError``
naming the slice that ports it (ROADMAP queue 1 item 18). The
reference's ``comm_flags.apply_in_process`` (XLA's collective flags)
has no counterpart: NCCL needs none.
"""
from __future__ import annotations

import numpy as np

from .. import env as _env
from ..collective import barrier
from ..parallel import DataParallel, init_parallel_env
from .base.distributed_strategy import DistributedStrategy
from .base.topology import (HybridCommunicateGroup, ParallelMode, _set_hcg,
                            get_hybrid_communicate_group)

_LATER = {
    "sharding_degree": "sharding stages 1-3 (group_sharded_parallel)",
    "pp_degree": "pipeline parallelism (PipelineLayer, 1F1B, VPP)",
    "sep_degree": "sequence parallelism",
    "ep_degree": "expert parallelism (the MoE layers)",
}


class Fleet:
    def __init__(self):
        self._strategy = None
        self._hcg = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        """Build the hybrid topology of ``strategy.hybrid_configs``. The
        degrees must multiply to the job's world size; a job of several
        ranks joins its process group first (``init_parallel_env``, if
        the caller has not)."""
        strategy = strategy or DistributedStrategy()
        cfg = strategy.hybrid_configs
        for key, slice_ in _LATER.items():
            if int(cfg.get(key, 1)) > 1:
                raise NotImplementedError(
                    f"fleet.init: {key}={cfg[key]}: {slice_} is not "
                    "ported yet (ROADMAP queue 1 item 18)")
        world = int(np.prod([int(cfg.get(k, 1)) for k in
                             ("dp_degree", "mp_degree")]))
        if world > 1 and not _env.is_initialized():
            init_parallel_env()
        self._strategy = strategy
        self._hcg = HybridCommunicateGroup(hybrid_configs=cfg)
        _set_hcg(self._hcg)
        self._is_initialized = True
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def worker_num(self):
        return _env.get_world_size()

    def worker_index(self):
        return _env.get_rank()

    def is_first_worker(self):
        return _env.get_rank() == 0

    def barrier_worker(self):
        barrier()

    def distributed_model(self, model):
        """``TensorParallel`` at mp > 1, ``DataParallel`` over the dp
        group at dp > 1, else the model itself."""
        if self._hcg is None:
            return DataParallel(model)
        from .meta_parallel import TensorParallel

        if self._hcg.get_parallel_mode() == ParallelMode.TENSOR_PARALLEL:
            return TensorParallel(model, self._hcg, self._strategy)
        if self._hcg.get_data_parallel_world_size() > 1:
            return DataParallel(
                model, group=self._hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        from .meta_optimizers import HybridParallelOptimizer

        return HybridParallelOptimizer(
            optimizer, self._hcg, self._strategy or DistributedStrategy())

    def minimize(self, *args, **kwargs):
        raise NotImplementedError(
            "static-graph fleet.minimize is not ported; use "
            "distributed_optimizer")


fleet = Fleet()

init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
worker_index = fleet.worker_index


def worker_num():
    return fleet.worker_num


def reset():
    """Drop the active topology (``fleet.init`` may then run again)."""
    _set_hcg(None)
    fleet._hcg = None
    fleet._strategy = None
    fleet._is_initialized = False


__all__ = ["Fleet", "fleet", "init", "distributed_model",
           "distributed_optimizer", "worker_index", "worker_num",
           "get_hybrid_communicate_group", "reset"]
