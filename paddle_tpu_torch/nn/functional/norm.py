"""Functional norms of the port (counterpart of the reference's
``nn/functional/norm.py``)."""
from __future__ import annotations

from ...ops.kernels.rms_norm import rms_norm as _rms_impl


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis through the port's kernel (the plain
    version for CPU tensors)."""
    return _rms_impl(x, weight, epsilon)
