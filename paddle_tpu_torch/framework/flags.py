"""FLAGS registry of the PyTorch/CUDA port — its own copy of the
reference's ``framework/flags.py`` registry (``define_flag`` / ``flag`` /
``set_flags`` / ``get_flags``), holding only the flags the serving slice
reads.

Flags are registered with a type and a default, overridable by
``FLAGS_*`` environment variables at import and by :func:`set_flags` at
runtime.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}
_META: Dict[str, tuple] = {}  # name -> (type, help)


def _parse(value: str, typ):
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    return typ(value)


def define_flag(name: str, default, help_str: str = ""):
    typ = type(default)
    env = os.environ.get("FLAGS_" + name)
    _META[name] = (typ, help_str)
    _REGISTRY[name] = _parse(env, typ) if env is not None else default


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for f in flags:
        key = f[6:] if f.startswith("FLAGS_") else f
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {f}")
        out[f] = _REGISTRY[key]
    return out


def set_flags(flags: Dict[str, Any]):
    for f, v in flags.items():
        key = f[6:] if f.startswith("FLAGS_") else f
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {f}")
        typ = _META[key][0]
        _REGISTRY[key] = _parse(v, typ) if isinstance(v, str) else typ(v)


def flag(name: str):
    return _REGISTRY[name]


def ragged_attention_mode() -> str:
    """``FLAGS_ragged_attention`` as the port serves it: ``auto`` or
    ``on``. ``off`` selects the legacy dedicated decode kernel, which is
    not ported yet, so it raises instead of silently serving another
    lowering."""
    mode = str(flag("ragged_attention"))
    if mode == "off":
        raise NotImplementedError(
            "FLAGS_ragged_attention=off selects the legacy paged decode "
            "kernel, which the PyTorch port does not have yet; use "
            "'auto' or 'on'")
    if mode not in ("auto", "on"):
        raise ValueError(
            f"FLAGS_ragged_attention must be auto|on|off, got {mode!r}")
    return mode


define_flag("prefill_chunk_tokens", 64,
            "chunked-prefill token budget for the paged serving "
            "scheduler (inference/serving.py): each BatchScheduler step "
            "packs every active decode row plus up to this many pending "
            "prompt tokens into ONE ragged model call")
define_flag("ragged_attention", "auto",
            "unified ragged paged-attention dispatch for the chunked "
            "serving step: 'auto' (default) routes every packed row "
            "through one ragged kernel call per layer and, where "
            "eligible (float KV pages, plain projection weights), runs "
            "the fused step (qkv + RoPE + page scatter, the kernel, "
            "o_proj); 'on' forces the unified kernel without the fused "
            "step; 'off' (the legacy decode kernel) is not ported")
define_flag("serving_buckets", "8,16,32,64,128,256",
            "comma-separated packed-token buckets for the chunked-"
            "prefill ragged dispatch: the per-step packed token count is "
            "padded up to the smallest bucket >= count; counts beyond "
            "the largest bucket round up to the next power of two")
