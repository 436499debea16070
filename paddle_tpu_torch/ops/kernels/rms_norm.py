"""RMSNorm forward: a CUDA kernel for Hopper and its plain PyTorch
version (the counterpart of the reference's ``ops/kernels/rms_norm.py``;
the kernel replaces its Pallas ``_rms_kernel``).

``rms_norm`` dispatches on the tensor's device: a CPU tensor takes
:func:`rms_norm_plain`, a CUDA tensor launches ``csrc/rms_norm.cu`` or
raises. Unlike the reference, which takes its Pallas path only when the
width is a multiple of 128, the kernel takes any width. The backward
(the reference's XLA custom VJP) waits for the training slice;
``layer_norm_fused`` waits too.
"""
from __future__ import annotations

import torch

from . import _build, record_launch


def rms_norm_plain(x, weight=None, eps=1e-6):
    """Reference arithmetic in float32: ``x * rsqrt(mean(x^2) + eps)``,
    times the weight, then one cast back to ``x``'s dtype (the weight
    multiply happens before the cast, as in the reference)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def _rms_norm_cuda(x, weight, eps):
    h = x.shape[-1]
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rms_norm: unsupported dtype {x.dtype}")
    if weight is not None:
        if weight.device != x.device or weight.dtype != x.dtype:
            raise TypeError(
                f"rms_norm: weight must be {x.dtype} on {x.device}, got "
                f"{weight.dtype} on {weight.device}")
        if tuple(weight.shape) != (h,):
            raise ValueError(
                f"rms_norm: weight shape {tuple(weight.shape)} != ({h},)")
        weight = weight.contiguous()
    x2 = x.reshape(-1, h).contiguous()
    y = torch.empty_like(x2)
    if x2.numel():
        lib = _build.library()
        status = lib.ptt_rms_norm(
            x2.data_ptr(),
            weight.data_ptr() if weight is not None else None,
            y.data_ptr(), x2.shape[0], h, float(eps),
            _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(status, "rms_norm")
        record_launch("rms_norm")
    return y.reshape(x.shape)


def rms_norm(x, weight=None, eps=1e-6):
    """RMSNorm over the last axis. x: [..., H], weight: [H] or None."""
    if x.device.type == "cuda":
        return _rms_norm_cuda(x, weight, eps)
    if x.device.type != "cpu":
        raise RuntimeError(f"rms_norm: unsupported device {x.device}")
    return rms_norm_plain(x, weight, eps)
