"""Weight carry-over from the reference package.

The port keeps the reference's parameter names and its [in, out] linear
layout, so a reference state dict maps 1:1; only the array type
changes. Arrays arrive as numpy (bfloat16 arrays of the ``ml_dtypes``
kind are read through their 16-bit pattern, so no extra package is
needed).
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_reference_state(np_state, device, dtype):
    """``{name: np.ndarray}`` -> ``{name: torch.Tensor}`` on ``device``
    in ``dtype`` (floating arrays only are cast)."""
    out = {}
    for name, arr in np_state.items():
        t = _to_tensor(np.asarray(arr))
        if t.is_floating_point():
            t = t.to(dtype)
        out[name] = t.to(device)
    return out
