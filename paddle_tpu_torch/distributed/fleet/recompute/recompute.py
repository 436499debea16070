"""Activation recompute of the port (counterpart of the reference's
``distributed/fleet/recompute/recompute.py``).

A recomputed region keeps only its inputs (and, under a selective
granularity, its matmul outputs) for the backward, and replays the rest
of its forward there. The reference makes the region one taped op whose
payload is ``jax.checkpoint`` of the region's pure function; the port's
counterpart is ``torch.utils.checkpoint`` in its non-reentrant form,
with a selective-checkpoint policy for the granularities that keep the
matmul outputs.

The flash-attention and RMSNorm kernels are ``torch.autograd.Function``s
that launch through ctypes: no policy can save what they compute, so
under every granularity they run again in the replay (the reference's
Pallas ``custom_vjp`` is replayed the same way, which is its
``core_attn`` behaviour). Their outputs are written into tensors that
``torch.empty`` allocates, which no policy here saves.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)
_UNBATCHED_MATMULS = (torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default)

# The reference's table (upstream recompute_granularity): "full" replays
# the whole region; "selective" / "core_attn" / "dots" save every matmul
# output and replay only the glue; "dots_with_no_batch_dims" saves only
# the matmuls without a batch dimension.
_GRANULARITY_POLICIES = {
    "full": None,
    "selective": _MATMULS,
    "core_attn": _MATMULS,
    "dots": _MATMULS,
    "dots_with_no_batch_dims": _UNBATCHED_MATMULS,
}


def _resolve_policy(granularity):
    """The ops whose outputs a region saves (None: save nothing)."""
    if granularity is None:
        granularity = "full"
    try:
        return _GRANULARITY_POLICIES[granularity]
    except KeyError:
        raise ValueError(
            f"recompute: unknown granularity {granularity!r} "
            f"(expected one of {sorted(_GRANULARITY_POLICIES)})"
        ) from None


def _selective_context(saved_ops):
    def policy(ctx, op, *args, **kwargs):
        if op in saved_ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` keeping only what its
    granularity saves; the rest is recomputed in the backward.

    ``granularity``: "full" (the default, also ``None``: replay
    everything), "selective" / "core_attn" / "dots" (save every
    ``mm``/``addmm``/``bmm`` output), "dots_with_no_batch_dims" (save
    ``mm``/``addmm`` only); another name raises ``ValueError``.
    ``offload_indices`` raises ``NotImplementedError``, as in the
    reference. ``use_reentrant`` is accepted and the non-reentrant form
    always runs (the reference runs ``jax.checkpoint`` whatever it
    says).

    ``preserve_rng_state`` (default True) restores torch's default CPU
    and CUDA generators for the replay, so a region that draws from them
    replays the same draws (the reference threads its default generator
    through the region). A ``torch.Generator`` that the region is handed
    explicitly is not restored: its draws in the replay differ.
    """
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    saved_ops = _resolve_policy(kwargs.pop("granularity", None))
    if kwargs.pop("offload_indices", None):
        raise NotImplementedError(
            "recompute offload: moving saved activations to the host is "
            "not ported")
    extra = {}
    if saved_ops is not None:
        extra["context_fn"] = functools.partial(_selective_context,
                                                saved_ops)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=bool(preserve), **extra,
                      **kwargs)


def _run_chunk(chunk, x):
    for layer in chunk:
        x = layer(x)
    return x


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Apply ``functions`` (a sequence of layers) in order, recomputing
    each of ``ctx["segments"]`` chunks as one region (upstream
    recompute_sequential)."""
    segments = (ctx or {}).get("segments", 1)
    layers = list(functions)
    if segments <= 1:
        chunks = [layers]
    else:
        per = max(1, len(layers) // segments)
        chunks = [layers[i:i + per] for i in range(0, len(layers), per)]
    out = args[0] if len(args) == 1 else args
    for chunk in chunks:
        out = recompute(functools.partial(_run_chunk, chunk), out, **kwargs)
    return out


def recompute_hybrid(ctx, function, *args, **kwargs):
    """The mp/pp-aware variant (upstream recompute_hybrid.py). At model-
    parallel degree 1, the port's only degree, it is :func:`recompute`."""
    return recompute(function, *args, **kwargs)
