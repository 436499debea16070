"""``save`` / ``load`` of the port (counterpart of the reference's
``framework/io.py``): a pickle of nested dicts, lists and tuples in
which every tensor becomes a ``_TensorPayload`` holding a numpy array.

Numpy has no bfloat16 (and the card's machine has no ``ml_dtypes``), so
a bf16 tensor's payload holds its bits as ``uint16`` with the dtype tag
``"bfloat16"``, and :func:`load` gives back the same bits. Scalars,
strings and everything else pass through, so an ``LRScheduler``'s
``state_dict`` survives. The reference's files cannot be read here:
unpickling them needs the reference's own payload class.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..device import resolve_device


class _TensorPayload:
    """One tensor of a saved structure: ``array`` (numpy; a bf16
    tensor's bits as ``uint16``), ``stop_gradient`` (``not
    requires_grad``), ``name`` (the tensor's ``name`` attribute, if it
    has one), ``is_param`` (an ``nn.Parameter``) and ``dtype`` (the
    ``torch`` dtype's name when the array's own dtype is not it)."""

    __slots__ = ("array", "stop_gradient", "name", "is_param", "dtype")

    def __init__(self, array, stop_gradient, name, is_param, dtype=None):
        self.array = array
        self.stop_gradient = stop_gradient
        self.name = name
        self.is_param = is_param
        self.dtype = dtype


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        array, dtype = _to_numpy(obj)
        return _TensorPayload(array, not obj.requires_grad,
                              getattr(obj, "name", None),
                              isinstance(obj, torch.nn.Parameter), dtype)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        array = obj.array
        if obj.dtype == "bfloat16":
            bits = torch.from_numpy(array.view(np.int16).copy())
            t = bits.view(torch.bfloat16)
            if return_numpy:
                # exact widening: numpy has no bf16
                return t.float().numpy()
        elif return_numpy:
            return array
        else:
            t = torch.from_numpy(np.array(array))
        t = t.to(device)
        if obj.is_param:
            return torch.nn.Parameter(t)
        if t.is_floating_point() or t.is_complex():
            t.requires_grad_(not obj.stop_gradient)
        return t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, device) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` (nested dicts, lists and tuples of tensors and
    plain values) to ``path``, creating its directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, device=None, **configs):
    """The structure :func:`save` wrote. Tensors come back on
    ``device`` (the port's rule: the card by default, raising without
    one unless ``device="cpu"``); a saved ``nn.Parameter`` comes back as
    a trainable ``nn.Parameter`` (as the reference's), another tensor
    with its ``requires_grad``. With ``return_numpy`` every tensor is a
    numpy array instead, and a bf16 tensor a float32 array (an exact
    widening, where the reference returns an ``ml_dtypes`` bf16 array).
    """
    with open(path, "rb") as f:
        obj = pickle.load(f)
    dev = None if return_numpy else resolve_device(device)
    return _unpack(obj, return_numpy, dev)
