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
import functools as _functools
import threading as _threading

_LAUNCHES = _collections.Counter()
# launches come from more than one thread (an engine's pump thread beside
# the caller's): the read-modify-write of a count must not interleave
_LAUNCH_LOCK = _threading.Lock()
# the program recorder of a compiled step's first call (jit/program.py),
# None outside one. Module-wide, not thread-local: autograd runs the
# backward of CUDA tensors on its own device thread.
_RECORDER = None
# nonzero while jit.to_static captures a CUDA graph (jit/program.py
# ``capture_scope``): a capture launches nothing, so it counts nothing
_CAPTURING = 0


def record_launch(kernel: str, operands=(), results=()) -> None:
    """Count one launch of ``kernel``'s CUDA kernel (called by the
    wrapper right where it launches, and nowhere else). ``operands`` and
    ``results`` are the tensors the launch reads and writes: a program
    being recorded (``jit/program.py``) attaches them to the kernel op
    that made the launch."""
    if _CAPTURING:
        return
    with _LAUNCH_LOCK:
        _LAUNCHES[kernel] += 1
    rec = _RECORDER
    if rec is not None:
        rec.launch(kernel, operands, results)


def add_launches(counts: dict) -> None:
    """Add ``counts`` (``{kernel: n}``) to the launch counts: a compiled
    step's replay launches what its recorded call launched, without
    running its wrappers."""
    with _LAUNCH_LOCK:
        for kernel, n in counts.items():
            _LAUNCHES[kernel] += n


def _is_fake(t) -> bool:
    return type(t).__name__ == "FakeTensor"


def program_op(kernel: str, plain):
    """Decorator of a kernel wrapper's dispatch ``fn``: inside a program
    being recorded the call is one op named ``kernel``, which reads the
    call's tensor arguments and writes its tensor results, on either
    device. The ops inside it (the plain version's, the CUDA route's
    allocations) are not recorded, as the reference's jaxpr holds one
    ``pallas_call``. ``plain`` (same arguments) runs for fake tensors,
    which ``jit.plan``/``jit.analyze`` trace with: they record, they
    never launch."""
    def deco(fn):
        @_functools.wraps(fn)
        def wrapped(*args, **kwargs):
            rec = _RECORDER
            if rec is None:
                return fn(*args, **kwargs)
            run = plain if any(_is_fake(a) for a in args) else fn
            return rec.kernel_op(kernel, run, args, kwargs)
        return wrapped
    return deco


def kernel_launch_stats(reset: bool = False) -> dict:
    """``{'rms_norm': n, 'paged_ragged_attention': m,
    'flash_attention_fwd': ..., 'flash_attention_bwd_dkdv': ...,
    'flash_attention_bwd_dq': ..., 'flash_varlen_fwd': ...,
    'flash_varlen_bwd_dkdv': ..., 'flash_varlen_bwd_dq': ...,
    'layer_norm_fused': ..., 'paged_decode_attention': ...}`` — CUDA
    kernel launches since the last reset."""
    with _LAUNCH_LOCK:
        out = dict(_LAUNCHES)
        if reset:
            _LAUNCHES.clear()
    return out


from .rms_norm import (  # noqa: E402,F401
    layer_norm_fused,
    layer_norm_plain,
    rms_norm,
    rms_norm_plain,
)
from .rope import apply_rotary_emb, build_rope_cache  # noqa: E402,F401
from .paged_attention import (  # noqa: E402,F401
    packed_position_index,
    pad_plan_i32,
    paged_attention,
    paged_attention_plain,
    paged_prefill_attention,
    paged_ragged_attention,
    paged_ragged_attention_plain,
    paged_ragged_fused_step,
)
from .quant import (  # noqa: E402,F401
    INT4_QMAX,
    INT8_QMAX,
    dequantize_int4,
    dequantize_int8,
    dequantize_kv,
    kv_head_scale,
    pack_int4,
    quantize_int4,
    quantize_int8,
    quantize_kv,
    unpack_int4,
    weight_only_matmul,
)
