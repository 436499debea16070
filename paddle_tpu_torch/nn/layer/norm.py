"""Norm layers of the port (counterpart of the reference's
``nn/layer/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import rms_norm
from ..param_attr import make_parameter


class RMSNorm(nn.Module):
    """RMSNorm with a learned [hidden] weight (initialised to ones;
    ``weight_attr``: a ``ParamAttr``, or False for no weight)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = make_parameter(
            torch.ones(hidden_size, device=device, dtype=dtype), weight_attr)

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)
