"""TensorParallel (counterpart of the reference's
``fleet/meta_parallel/tensor_parallel.py``): at construction, the
parameters that are not split over mp are broadcast over the mp group
and every parameter over the dp group, from each group's first rank (as
upstream's ``hybrid_parallel_util`` does), and the mp RNG state is
registered when it is missing. The dp gradient average is the
optimizer's (``HybridParallelOptimizer``)."""
from __future__ import annotations

from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                          broadcast_mp_parameters)
from .meta_parallel_base import MetaParallelBase
from .parallel_layers.random import MODEL_PARALLEL_RNG, get_rng_state_tracker


class TensorParallel(MetaParallelBase):
    def _prepare_for_model(self):
        broadcast_mp_parameters(self._layers, self._hcg)
        broadcast_dp_parameters(self._layers, self._hcg)
        tracker = get_rng_state_tracker()
        if MODEL_PARALLEL_RNG not in tracker.states_:
            device = next(self._layers.parameters()).device
            tracker.add(MODEL_PARALLEL_RNG,
                        2048 + 1 + self._hcg.get_model_parallel_rank(),
                        device)
