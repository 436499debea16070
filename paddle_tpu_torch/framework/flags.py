"""FLAGS registry of the PyTorch/CUDA port — its own copy of the
reference's ``framework/flags.py`` registry (``define_flag`` / ``flag`` /
``set_flags`` / ``get_flags``), holding only the flags the port reads.

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
    """``FLAGS_ragged_attention``, checked: ``auto``, ``on`` or ``off``
    (the legacy two-kernel routing through the dedicated decode
    kernel)."""
    mode = str(flag("ragged_attention"))
    if mode not in ("auto", "on", "off"):
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
            "step; 'off' restores the historical two-kernel routing: "
            "decode rows through the dedicated paged decode kernel, "
            "prefill rows through the q_lens-masked ragged kernel")
define_flag("serving_buckets", "8,16,32,64,128,256",
            "comma-separated packed-token buckets for the chunked-"
            "prefill ragged dispatch: the per-step packed token count is "
            "padded up to the smallest bucket >= count; counts beyond "
            "the largest bucket round up to the next power of two")
define_flag("serving_max_queue", 0,
            "bound on the BatchScheduler submit queue (inference/"
            "serving.py): submit() past this many waiting requests "
            "raises QueueFullError instead of growing the backlog "
            "without limit. 0 (default) keeps the queue unbounded")
define_flag("serving_swap_bytes", 256 << 20,
            "host-memory budget for the KV swap space (incubate/nn/"
            "paged_cache.py HostKVSwapSpace): preempted sequences page "
            "their PRIVATE KV pages (payload + int8 scale rows) out to "
            "host tensors under this byte cap and restore them bit for "
            "bit on re-admission; shared (prefix) pages stay on the "
            "device under an external reference. 0 disables the swap "
            "tier (preemption then declines and admission blocks)")
define_flag("serving_preempt", True,
            "sequence preemption for the serving scheduler "
            "(inference/serving.py): when admission cannot reserve "
            "pages for a request, victims with STRICTLY lower priority "
            "(lowest priority first, then most pages held, then least "
            "progress) are swapped out to the host tier "
            "(FLAGS_serving_swap_bytes) instead of the request being "
            "blocked behind them. Off restores wait-in-queue admission")
define_flag("spec_decode", "ragged",
            "speculative-decoding lowering for the paged serving "
            "scheduler (inference/serving.py, draft_model= set): "
            "'ragged' (default) packs each spec-active sequence's "
            "draft-k verify window as ONE right-aligned (k+1)-token row "
            "of the ordinary prefill_chunk ragged step (per-position "
            "logits out of the epilogue; the draft proposes through its "
            "own chunked step); 'legacy' runs k sequential "
            "draft.decode_token proposals and one dense-gather "
            "decode_window verify; 'off' ignores the draft model and "
            "serves plain greedy decode. Ragged mode also composes with "
            "prefix caching and host-swap preemption (the draft KV is "
            "discarded at swap-out and refilled from the committed "
            "prefix after a swap-in or a prefix hit)")
