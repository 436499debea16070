"""HybridParallelOptimizer (counterpart of the reference's
``fleet/meta_optimizers/dygraph_optimizer/hybrid_parallel_optimizer.py``).

The reference's single controller gets two things for free that the
port does by hand, since each rank holds its shard of the model:

1. the global-norm clip over mp: the squared norms of the parameters
   split over mp (``is_distributed``) are summed over the check group
   (every axis but dp), and those of the replicated parameters, the
   same on every rank, are counted once (``HybridParallelClipGrad``);
2. the dp gradient average (``fused_allreduce_gradients``, divided by
   the dp world), in ``step()`` when dp > 1 and the model is not a
   ``DataParallel``, whose own hooks average its gradients (the pure
   data-parallel mode, as upstream).

Sharding (``DygraphShardingOptimizer``) is not ported and raises.
"""
from __future__ import annotations

import torch

from .....nn.clip import ClipGradByGlobalNorm, _clipped
from ....collective import ReduceOp, all_reduce
from ...base.topology import ParallelMode
from ...layers.mpu.mp_layers import is_distributed
from ...utils.hybrid_parallel_util import fused_allreduce_gradients


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """``clip``'s global-norm clip with the norm taken over the whole
    model when its parameters are split over the ``hcg``'s check
    group."""

    def __init__(self, clip, hcg):
        super().__init__(clip.clip_norm)
        self._hcg = hcg

    def _global_norm_sq(self, params_grads):
        dist_sq = rep_sq = None
        for p, g in params_grads:
            if not _clipped(p, g):
                continue
            s = torch.sum(torch.square(g.float()))
            if is_distributed(p):
                dist_sq = s if dist_sq is None else dist_sq + s
            else:
                rep_sq = s if rep_sq is None else rep_sq + s
        if dist_sq is None and rep_sq is None:
            return None
        device = next(g for p, g in params_grads if g is not None).device
        if dist_sq is None:
            dist_sq = torch.zeros((), dtype=torch.float32, device=device)
        all_reduce(dist_sq, ReduceOp.SUM,
                   group=self._hcg.get_check_parallel_group())
        return dist_sq if rep_sq is None else dist_sq + rep_sq


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy):
        if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
            raise NotImplementedError(
                "DygraphShardingOptimizer (sharding_degree > 1) is not "
                "ported yet")
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._dp_enable = (
            hcg is not None and hcg.get_data_parallel_world_size() > 1
            and hcg.get_parallel_mode() != ParallelMode.DATA_PARALLEL)
        clip = getattr(optimizer, "_grad_clip", None)
        if (hcg is not None and isinstance(clip, ClipGradByGlobalNorm)
                and hcg.get_check_parallel_group().nranks > 1):
            optimizer._grad_clip = HybridParallelClipGrad(clip, hcg)

    @torch.no_grad()
    def step(self):
        if self._dp_enable:
            fused_allreduce_gradients(self._inner_opt._parameter_list,
                                      self._hcg)
        return self._inner_opt.step()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero=False):
        return self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state_dict):
        return self._inner_opt.set_state_dict(state_dict)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)
