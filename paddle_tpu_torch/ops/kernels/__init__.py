"""Hand-written CUDA kernels of the PyTorch/CUDA port (the counterpart
of the reference's ``ops/kernels`` Pallas library).

Each kernel module ships two implementations of one function:

* a CUDA C++ kernel for Hopper (``csrc/*.cu``, built by ``_build.py`` at
  first use and called through ``ctypes``), launched for CUDA tensors;
* a plain PyTorch version with the same semantics, used for CPU tensors
  (the tests) and as the yardstick the kernel is held against on the
  card.

The wrapper chooses by the tensor's device alone: a CUDA tensor
launches the kernel or raises. Every launch is counted; read the counts
with :func:`kernel_launch_stats` (the counterpart of the reference's
``kernel_dispatch_stats``).
"""
from __future__ import annotations

import collections as _collections

_LAUNCHES = _collections.Counter()


def record_launch(kernel: str) -> None:
    """Count one launch of ``kernel``'s CUDA kernel (called by the
    wrapper right where it launches, and nowhere else)."""
    _LAUNCHES[kernel] += 1


def kernel_launch_stats(reset: bool = False) -> dict:
    """``{'rms_norm': n, 'paged_ragged_attention': m}`` — CUDA kernel
    launches since the last reset."""
    out = dict(_LAUNCHES)
    if reset:
        _LAUNCHES.clear()
    return out


from .rms_norm import rms_norm, rms_norm_plain  # noqa: E402,F401
from .rope import apply_rotary_emb, build_rope_cache  # noqa: E402,F401
from .paged_attention import (  # noqa: E402,F401
    packed_position_index,
    pad_plan_i32,
    paged_ragged_attention,
    paged_ragged_attention_plain,
    paged_ragged_fused_step,
)
