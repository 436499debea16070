"""Device API of the PyTorch/CUDA port (the counterpart of the
reference's ``device/__init__.py``).

The port runs on the card: the default device is ``cuda:0``. The CPU is
used only when a caller asks for it by name (the tests do). Without
CUDA, resolving a CUDA device raises; nothing silently falls back to
the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

_current = None


def _parse(device) -> torch.device:
    """``'gpu'``/``'gpu:1'`` (aliases of ``cuda``), ``'cuda:0'``,
    ``'cpu'`` or a ``torch.device``, checked: a CUDA device needs CUDA."""
    if isinstance(device, str) and device.startswith("gpu"):
        device = "cuda" + device[3:]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device, and this "
                "process sees none; pass device='cpu' explicitly to run "
                "the plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_device(device) -> torch.device:
    """Make ``device`` the default of every entry point; returns the
    resolved ``torch.device``."""
    global _current
    _current = _parse(device)
    return _current


def get_device() -> str:
    """The default device as a string (``cuda:0`` unless set)."""
    return str(resolve_device(None))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    the one :func:`set_device` chose, else ``cuda:0``. Raises when the
    result is a CUDA device and CUDA is missing."""
    if device is not None:
        return _parse(device)
    if _current is not None:
        return _current
    return _parse("cuda:0")


_INDEX_DTYPES = {torch.int32: np.int32, torch.int64: np.int64}


def copy_to_device(arrays, device, dtype):
    """Host index arrays (numpy or lists) as ``dtype`` (int32 or int64)
    tensors on ``device``, moved in ONE host-to-device copy: the arrays
    are packed into one buffer and come back as views of it, shaped like
    the inputs."""
    host = [np.asarray(a, _INDEX_DTYPES[dtype]) for a in arrays]
    flat = np.concatenate([a.ravel() for a in host])
    buf = torch.from_numpy(flat).to(device, non_blocking=True)
    out, off = [], 0
    for a in host:
        out.append(buf[off:off + a.size].view(a.shape))
        off += a.size
    return out
