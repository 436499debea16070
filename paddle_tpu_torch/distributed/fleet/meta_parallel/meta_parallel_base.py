"""Base of the hybrid-parallel model wrappers (counterpart of the
reference's ``fleet/meta_parallel/meta_parallel_base.py``): prepares
the model at construction (``_prepare_for_model``), then delegates the
forward and the parameter and state surface to it."""
from __future__ import annotations

from torch import nn


class MetaParallelBase(nn.Module):
    def __init__(self, layers, hcg, strategy):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict):
        return self._layers.load_state_dict(state_dict)
