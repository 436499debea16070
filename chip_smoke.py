#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py [--seed N] [--layers N]

It prints one JSON line per phase:

1. ``env``: torch / CUDA versions and the card (``nvidia-smi`` name and
   power limit);
2. ``build``: builds the hand-written CUDA kernels from
   ``paddle_tpu_torch/ops/kernels/csrc`` and reports the seconds taken
   and, from ``cuobjdump``, the wgmma and norm kernels' registers and
   stack;
3. ``kernels``: calls each kernel's wrapper at the shapes of the serving,
   training, packed-attention and LayerNorm paths and holds the result
   against its plain PyTorch version on the same inputs (tolerances
   below), with the kernel, plain and library
   (``torch.nn.functional.rms_norm`` and ``layer_norm``,
   ``scaled_dot_product_attention`` forward and its autograd backward,
   ``torch.nn.attention.varlen.varlen_attn`` where it imports; timed
   only, never used by the port) times and the kernel's bound; the paged
   attention cases (``ATTN_CASES``) cover the ragged kernel's three
   routes (T = 1 through the decode kernel's split; T > 1 on the tensor
   cores with bf16 or int8 pages; float32) and the decode kernel; also
   the serving path's fused layer step (``paged_ragged_fused_step``)
   against the same function built from ``torch.matmul`` and SDPA;
4. ``varlen``: the public ``flash_attn_unpadded`` forward and backward
   through autograd at Qwen2-0.5B's attention width (14 q and 2 kv
   heads of 64, bf16, causal) on one 16384-token pack of documents,
   with the launch counters reset just before one call and read just
   after, out and the gradients held against the plain version, and
   PR 2's dense kernels timed on the same documents padded to the
   longest;
5. ``layer_norm``: ``layer_norm_fused`` forward and backward at
   [16384, 768] bf16, with launch counts;
6. ``serve``, ``serve_int8``, ``serve_off``, ``serve_off_int8``
   (``SERVE_RUNS``): serve 8 requests on Llama-3-8B's published shape
   (random bf16 weights from the seed) through ``BatchScheduler`` ->
   ``PagedLlamaAdapter`` -> the paged KV pool, with bf16 or int8 pages
   (the int8 pool sized by ``serve``'s pool bytes) under
   ``FLAGS_ragged_attention=auto`` or ``off``; each with the kernel
   launch counters reset just before and read just after, exact launch
   counts, and the served logits of two requests held against the dense
   float32 oracle (``paddle_tpu_torch.testing.dense_reference_logits``);
   then ``serve_prefix`` and ``serve_prefix_int8`` (``PREFIX_RUNS``): 16
   requests sharing one 1,000-token prefix, ``r0`` served alone first,
   then the other 15 together through ``prefix_cache=True`` from bf16 or
   int8 pages, with the hit and copy-on-write fork counts, every fork's
   bytes against its source, the cached prefix chain's bytes across the
   run and the drained pools gated (``serve_prefix`` also serves the
   same traffic without the cache beside it); and ``serve_preempt``:
   six priority-0 requests fill a small pool, two priority-1 requests
   preempt them to the host swap tier, the first victim is cancelled,
   and every restored chain is held against its swapped-out bytes;
   then speculative serving, draft_k 4, with drafts made of the target's
   own first layers (``SPEC_SERVE_RUNS``): ``serve_spec`` (a
   self-draft), ``serve_spec_skip2`` (2 layers), ``serve_spec_spoiled``
   (the self-draft proposing its second choice at a seeded quarter of
   the positions) under ``FLAGS_spec_decode=ragged``,
   ``serve_spec_legacy`` under ``legacy``, and ``serve_spec_preempt``
   (``serve_preempt``'s traffic with the 2-layer draft): every committed
   token the target's argmax at its position, two requests' verified
   logits against the oracle, the target pool holding the committed
   prefix after every step, one target call a round, exact launches;
   then the host planes (``PLANE_RUNS``): ``serve_observed`` (``serve``
   with telemetry in trace mode, an SLO, the watchdog, both sanitizers
   strict, the incident recorder and the Prometheus export on: the same
   launches and tokens as ``serve``, the serving counters equal to the
   step events, a complete request trace each, one ``serving.step`` span
   a step with the model call inside, the exports readable, no sanitizer
   violation, an incident bundle read back and one a watchdog fire, the
   ledger's ``prefill_chunk`` and ``decode_token`` rows),
   ``serve_faults`` (``serve_preempt``'s traffic under
   ``SERVE_FAULT_PLAN``, every fault kind: the injector's log equal to
   the plan's, the storm's victims restored bit for bit, every committed
   token its logits' argmax, a resumed victim against the oracle) and
   ``sanitizer_fuzz`` (the page sanitizer's pool fuzzer on the card:
   clean over float32 and int8 pools with and without the prefix cache,
   each injected bug class caught);
7. ``profile``, ``profile_int8``, ``profile_off`` and
   ``profile_off_int8``: the four serving runs served again under
   ``torch.profiler``: device time by kernel class and the device's
   busy share of the wall;
8. the dense-KV generation runs (``GEN_RUN_NAMES``) on the served
   model's shape: ``hf_load`` exports the served weights as an HF
   state dict (HF names, [out, in], CPU tensors) and loads them with
   ``from_hf`` into a fresh model from another seed (every parameter
   bit for bit; device memory rising by at most twice the largest
   tensor); then, on the loaded model, ``generate`` (greedy, 4 prompts
   of 512 tokens, 64 new: each token the argmax of its step's logits,
   two rows against the float32 oracle, 2 L + 1 RMSNorm launches a
   step), ``generate_sample`` (temperature, top-k, top-p, repetition
   penalty from a seeded generator, twice: equal tokens, each inside
   its step's filtered support), ``generate_beam`` (2 prompts, 4
   beams, 32 new: the best beam's kept score against its float32
   re-score) and ``spec_generate`` (1 prompt, 64 new, draft_k 4, with
   a 2-layer layer-skip draft, a self-draft and a self-draft spoiled at
   a seeded quarter of the positions: every committed token the
   target's argmax, the self-draft accepting >= 80%, the spoiled one
   rejected in mid-window at least once and at its first spoiled
   position in >= 80% of its windows);
9. ``train_check``: Qwen2-0.5B at its published shape (random bf16
   weights from the seed, fused CE head): the loss and every
   parameter's gradient on one 2048-token sequence against the float32
   oracle (``paddle_tpu_torch.testing.dense_reference_loss_and_grads``);
10. ``train``: ``bench.py``'s training loop at batch 8 x 2048 (forward,
   fused CE head, backward, ``AdamW(3e-4, multi_precision=True)``):
   2 warm-up and 5 timed steps on the same batch, with the launch
   counters reset around the timed steps; step time, tokens/s, MFU,
   peak memory, and the loss of every step;
11. ``train_profile``: one training step under ``torch.profiler``.

Then ``wall``: each phase line's wall seconds from the line before it.
Then, on lines of their own: the ``nvidia-smi`` name and power limit,
the per-kernel summary ``{"kernels": [...]}``, and last
``{"ok": true, "device": {...}}``. Any failed phase raises, and the
script exits non-zero without the last line. Without CUDA it exits 2
before doing anything.

Narrower runs: ``--flash-cases NAMES`` builds the kernels and holds
only those flash and varlen cases (names of ``FLASH_CASES`` and
``VARLEN_CASES``) against their plain versions, ``--attn-cases NAMES``
those paged attention cases (names of ``ATTN_CASES``),
``--norm-cases NAMES`` those rms_norm and layer_norm_fused cases (names
of ``NORM_CASES``); ``--fault-check`` plants each fault of
``FLASH_FAULTS``, ``PAGED_FAULTS`` and ``NORM_FAULTS`` in a copy of the
repository and fails unless the gates catch every one (a paged fault
only in the cases of the kernel it broke, a norm fault only in the
cases of the kernels and launch classes it broke); ``--ablations
NAMES`` times the cases of design choices (``ABLATIONS``) undone in a
copy, beside an unchanged copy. ``--serve-runs NAMES`` builds the
kernels and serves only those runs (names of ``SERVE_RUN_NAMES``),
unprofiled, at ``--layers`` depth, listing each failed run in a
``serve_runs`` line; ``--fault-check`` also plants ``SERVE_FAULTS`` in
the page pool and runs ``--serve-runs`` on them at two layers.
``--fault-check`` also plants ``SPEC_FAULTS`` in the scheduler and runs
``--serve-runs`` on them at four layers, and ``PLANE_FAULTS`` (a fork the
pool does not journal, a dropped counter increment, a lost fault-plan
entry) on ``_PLANE_FAULT_RUNS`` at two layers, where each must fail its
named run at its named gate.
``--gen-runs NAMES`` builds the kernels and runs only those generation
runs (names of ``GEN_RUN_NAMES``) at ``--layers`` depth, listing each
failed run in a ``gen_runs`` line; ``--fault-check`` also plants
``GEN_FAULTS`` in the model, generation and loader modules and runs
``--gen-runs`` on them at two layers. ``--serve-ab DIR`` serves the
``serve`` run from another checkout (an unpacked earlier tree) and from
this one in turns (DIR, this, this, DIR), each in a child process, on
one ``serve_ab`` line.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM dense peaks by operand type: bf16 on the tensor cores,
# float32 outside them
PEAK_FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
BF16_ULP = 2.0 ** -7           # bf16 spacing relative to the value (max)

# bench.py's traffic: batch 8 x 2048; 2 warm-up and 5 timed steps (the
# step count is what to cut first if the run outgrows its time limit)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 5

# the port's kernels: name -> (CUDA source, the TPU kernel it replaces)
_FLASH_CU = "paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu"
_VARLEN_CU = "paddle_tpu_torch/ops/kernels/csrc/flash_varlen.cu"
_NORM_CU = "paddle_tpu_torch/ops/kernels/csrc/rms_norm.cu"
_PAGED_CU = "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu"
_ATTN_CORE = "paddle_tpu_torch/ops/kernels/csrc/attn_fwd_tiles.cuh"
_ATTN_BWD = "paddle_tpu_torch/ops/kernels/csrc/attn_bwd_tiles.cuh"
KERNELS = {
    "rms_norm": (_NORM_CU, "paddle_tpu/ops/kernels/rms_norm.py:32"),
    "layer_norm_fused": (_NORM_CU, "paddle_tpu/ops/kernels/rms_norm.py:120"),
    "paged_ragged_attention": (
        _PAGED_CU, "paddle_tpu/ops/kernels/paged_attention.py:351"),
    "paged_decode_attention": (
        _PAGED_CU, "paddle_tpu/ops/kernels/paged_attention.py:66"),
    # torch around paged_ragged_attention: no kernel of its own
    "paged_ragged_fused_step": (
        "paddle_tpu_torch/ops/kernels/paged_attention.py",
        "paddle_tpu/ops/kernels/paged_attention.py:582"),
    "flash_attention_fwd": (
        _FLASH_CU, "paddle_tpu/ops/kernels/flash_attention.py:50"),
    "flash_attention_bwd_dkdv": (
        _FLASH_CU, "paddle_tpu/ops/kernels/flash_attention.py:199"),
    "flash_attention_bwd_dq": (
        _FLASH_CU, "paddle_tpu/ops/kernels/flash_attention.py:276"),
    "flash_varlen_fwd": (
        _VARLEN_CU, "paddle_tpu/ops/kernels/flash_varlen.py:63"),
    "flash_varlen_bwd_dkdv": (
        _VARLEN_CU, "paddle_tpu/ops/kernels/flash_varlen.py:126"),
    "flash_varlen_bwd_dq": (
        _VARLEN_CU, "paddle_tpu/ops/kernels/flash_varlen.py:188"),
}
FLASH = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
         "flash_attention_bwd_dq")
VARLEN = ("flash_varlen_fwd", "flash_varlen_bwd_dkdv", "flash_varlen_bwd_dq")


_EMITTED = []  # (phase, time.perf_counter() at its line)


def emit(phase, **fields):
    _EMITTED.append((phase, time.perf_counter()))
    print(json.dumps({"phase": phase, **fields}), flush=True)


def wall_seconds(t0):
    """{phase: wall seconds from the line before it (from t0 for the
    first)}: where the script's time went, a phase line at a time."""
    out, prev = {}, t0
    for phase, t in _EMITTED:
        out[phase] = round(t - prev, 3)
        prev = t
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=20, warmup=3, flush=None):
    """Mean device time of ``fn()`` over ``iters`` launches, each timed
    with its own CUDA event pair; ``flush`` (a large tensor) is
    rewritten before each launch so the inputs come from HBM, as on the
    serving path, where every layer's pages and weights are distinct. A
    short device-side spin before the start event lets the host enqueue
    ``fn``'s launches ahead of the device, so the pair measures device
    time, not the wrapper's host time."""
    import torch

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# the norm kernels of csrc/rms_norm.cu whose registers the build line
# reports beside the wgmma kernels'
_NORM_KERNELS = ("rms_norm_kernel", "layer_norm_kernel",
                 "rms_norm_kernel_scalar", "layer_norm_kernel_scalar")


def _sass_kernel(mangled):
    """``name<template arguments>`` of a mangled *_wgmma or norm kernel,
    or None for any other function."""
    import re

    i = 3 if mangled.startswith("_ZN") else 2
    while True:  # the nested name's length-prefixed parts
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            return None
        i += m.end()
        part = mangled[i:i + int(m.group())]
        i += len(part)
        if part.endswith("_wgmma") or part in _NORM_KERNELS:
            break
    m = re.match(r"I(.*?)EEv", mangled[i:])
    args = re.sub(r"L[ib](\d+)E", r"\1,", m.group(1) if m else "")
    args = args.replace("13__nv_bfloat16", "bf16,")
    if args.startswith("a"):  # signed char: int8 pages
        args = "int8," + args[1:]
    elif args.startswith("f"):
        args = "float," + args[1:]
    return f"{part}<{args.rstrip(',')}>"


def sass_summary(lib):
    """{kernel: {"hgmma": HGMMA instructions in its SASS, "registers": a
    thread's, "stack": bytes of local stack (spills)}} for the built
    library's wgmma and norm kernels, from the toolkit's cuobjdump; None
    where it has none. A wgmma kernel without HGMMA fails the build
    phase."""
    import re

    from paddle_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = {}
    kernel = None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = _sass_kernel(line.split("Function :")[1].strip())
            if kernel is not None:
                out[kernel] = {"hgmma": 0}
        elif kernel is not None and "HGMMA" in line:
            out[kernel]["hgmma"] += 1
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    for fn, regs, stack in re.findall(
            r"Function (\S+?):\s*REG:(\d+) STACK:(\d+)", res):
        kernel = _sass_kernel(fn)
        if kernel in out:
            out[kernel].update(registers=int(regs), stack=int(stack))
    return out


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def within_tolerance(got, ref, atol=1e-5):
    """|got - ref| <= ref's spacing + ``atol``: one bf16 spacing at ref
    for bfloat16 (the kernel and the plain version do the same float32
    arithmetic in another order, so they may differ only where the final
    bf16 cast rounds a float32 difference of ~1e-6 across a boundary),
    and 1e-5 relative for float32 (that reordering alone)."""
    rel = BF16_ULP if ref.dtype == torch_dtype("bfloat16") else 1e-5
    d = (got.float() - ref.float()).abs()
    return bool((d <= ref.float().abs() * rel + atol).all())


def torch_dtype(name):
    import torch

    return getattr(torch, name)


def tolerance_text(dtype):
    return ("one bf16 spacing at the value + 1e-5" if dtype == "bfloat16"
            else "1e-5 relative + 1e-5")


# ---------------------------------------------------------------- kernels
def _norm_plan(h, dtype):
    """The launch plan ``rms_norm.norm_launch_plan`` gives a case's
    (fresh, 16-byte aligned) tensors, as a dict."""
    from paddle_tpu_torch.ops.kernels.rms_norm import norm_launch_plan

    return norm_launch_plan(h, torch_dtype(dtype), True)._asdict()


def copy_ms(x, flush):
    """Device time of torch's copy of x into a tensor of its shape,
    timed as the kernels are: the same bytes as a norm without its
    weight (x read once, y written once) and the same launch. What the
    card reaches for those bytes under this timing, beside the bound."""
    import torch

    y = torch.empty_like(x)
    return cuda_time_ms(lambda: y.copy_(x), flush=flush)


def rms_case(name, n, h, flush, dtype="bfloat16"):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm, \
        rms_norm_plain

    g = torch.Generator(device="cuda").manual_seed(n * 7 + h)
    dt = torch_dtype(dtype)
    x = torch.randn(n, h, generator=g, device="cuda").to(dt)
    w = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(dt)
    eps = 1e-5
    got = rms_norm(x, w, eps)
    torch.cuda.synchronize()
    ref = rms_norm_plain(x, w, eps)
    d = (got.float() - ref.float()).abs()
    ok = within_tolerance(got, ref)
    nbytes = (2 * x.numel() + w.numel()) * x.element_size()
    b_ms, b_by = bound_ms(nbytes, 4 * x.numel(), dtype)
    return {
        "case": name, "shape": [n, h], "dtype": dtype,
        "plan": _norm_plan(h, dtype),
        "max_abs_err": float(d.max()),
        "max_rel_err": float((d / ref.float().abs().clamp_min(1e-6)).max()),
        "tolerance": tolerance_text(dtype),
        "ok": ok,
        "kernel_ms": cuda_time_ms(lambda: rms_norm(x, w, eps),
                                  flush=flush),
        "plain_ms": cuda_time_ms(lambda: rms_norm_plain(x, w, eps),
                                 flush=flush),
        "library_ms": cuda_time_ms(
            lambda: F.rms_norm(x, (h,), w, eps), flush=flush),
        "copy_ms": copy_ms(x, flush),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def ln_case(name, n, h, flush, dtype="bfloat16", affine=True):
    """layer_norm_fused's kernel against its plain version at [n, h]
    (weight and bias, or neither), held like rms_norm."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.rms_norm import layer_norm_fused, \
        layer_norm_plain

    g = torch.Generator(device="cuda").manual_seed(n * 5 + h)
    dt = torch_dtype(dtype)
    x = (0.3 + 1.5 * torch.randn(n, h, generator=g, device="cuda")).to(dt)
    w = b = None
    if affine:
        w = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(dt)
        b = (0.1 * torch.randn(h, generator=g, device="cuda")).to(dt)
    eps = 1e-5
    got = layer_norm_fused(x, w, b, eps)
    torch.cuda.synchronize()
    ref = layer_norm_plain(x, w, b, eps)
    d = (got.float() - ref.float()).abs()
    nbytes = (2 * x.numel() + (2 * h if affine else 0)) * x.element_size()
    b_ms, b_by = bound_ms(nbytes, 8 * x.numel(), dtype)
    return {
        "case": name, "shape": [n, h], "dtype": dtype,
        "weight_and_bias": affine, "plan": _norm_plan(h, dtype),
        "max_abs_err": float(d.max()),
        "max_rel_err": float((d / ref.float().abs().clamp_min(1e-6)).max()),
        "tolerance": tolerance_text(dtype),
        "ok": within_tolerance(got, ref),
        "kernel_ms": cuda_time_ms(lambda: layer_norm_fused(x, w, b, eps),
                                  flush=flush),
        "plain_ms": cuda_time_ms(lambda: layer_norm_plain(x, w, b, eps),
                                 flush=flush),
        "library_ms": cuda_time_ms(
            lambda: F.layer_norm(x, (h,), w, b, eps), flush=flush),
        "copy_ms": copy_ms(x, flush),
        "bound_ms": b_ms, "bound_by": b_by,
    }


_RMS, _LN = "rms_norm", "layer_norm_fused"
# (kernel, case name, shape and options) of rms_norm and layer_norm_fused
NORM_CASES = [
    # serving: a chunk call's 256 rows and a decode call's 8 (one per
    # sequence), bf16 and float32
    (_RMS, "rows256", dict(n=256, h=4096)),
    (_RMS, "rows8", dict(n=8, h=4096)),
    (_RMS, "rows8_float32", dict(n=8, h=4096, dtype="float32")),
    # the training path: Qwen2-0.5B at batch 8 x 2048, and the gradient
    # check's one sequence
    (_RMS, "rows16384", dict(n=16384, h=896)),
    (_RMS, "rows2048", dict(n=2048, h=896)),
    # a chunk call's real rows (7 decode rows and a 248-token chunk); the
    # warp class's masked tail (125 vectors); the scalar path (a width of
    # no whole number of 16-byte vectors)
    (_RMS, "rows255", dict(n=255, h=4096)),
    (_RMS, "rows64_h1000", dict(n=64, h=1000)),
    (_RMS, "rows64_h100", dict(n=64, h=100)),
    # LayerNorm at GPT-2 / BERT-base and BERT-large widths, a wide short
    # block, a width the TPU kernel cannot take, no affine, float32
    (_LN, "rows16384_h768", dict(n=16384, h=768)),
    (_LN, "rows16384_h1024", dict(n=16384, h=1024)),
    (_LN, "rows8_h4096", dict(n=8, h=4096)),
    (_LN, "rows2048_h1000", dict(n=2048, h=1000)),
    (_LN, "rows2048_h768_no_affine", dict(n=2048, h=768, affine=False)),
    (_LN, "rows2048_h768_float32", dict(n=2048, h=768, dtype="float32")),
]


def norm_cases(flush, names=None):
    """{kernel name: [case results]} over NORM_CASES (those in ``names``
    only, when given)."""
    out = {_RMS: [], _LN: []}
    for kernel, name, kw in NORM_CASES:
        if names is None or name in names:
            case = rms_case if kernel == _RMS else ln_case
            out[kernel].append(case(name, flush=flush, **kw))
    return out


def attn_work(seq_lens, q_lens, t, h, kvh, d, window, page, itemsize,
              kv_itemsize=None, scales=False):
    """Bytes the paged attention must move and operations it must do,
    for THESE inputs: the real rows' q read once, the whole output
    written once (padded rows too: they are written as zeros), each K/V
    row some real row needs read once (``kv_itemsize`` bytes an element,
    q's by default), with ``scales`` the float32 K and V scale of every
    page and kv head those rows lie in, and QK^T and PV over the kept
    keys. A real row that sees no key (qpos < 0) averages V over the
    slots of the pages below seq_len. The decode kernel is the case
    T = 1, every q_len 1."""
    b = len(seq_lens)
    if q_lens is None:
        q_lens = [t] * b
    kv_itemsize = kv_itemsize or itemsize
    nbytes = b * t * h * d * itemsize
    flops = 0
    for s, ql in zip(seq_lens, q_lens):
        if s == 0 or ql == 0:
            continue
        nbytes += ql * h * d * itemsize
        qlo = s - ql
        lo = max(0, qlo - window + 1) if window else 0
        nbytes += (s - lo) * kvh * d * kv_itemsize * 2
        if scales:
            nbytes += ((s - 1) // page - lo // page + 1) * kvh * 4 * 2
        if qlo < 0:
            slots = -(-s // page) * page
            nbytes += (slots - s) * kvh * d * kv_itemsize
            flops += -qlo * h * d * slots
        for qpos in range(max(qlo, 0), s):
            keys = qpos + 1 - (max(0, qpos - window + 1) if window else 0)
            flops += 4 * d * keys * h
    return nbytes, flops


@contextlib.contextmanager
def ragged_mode(mode):
    """``FLAGS_ragged_attention`` set for a block, restored after."""
    from paddle_tpu_torch.framework.flags import flag, set_flags

    prev = flag("ragged_attention")
    set_flags({"FLAGS_ragged_attention": mode})
    try:
        yield
    finally:
        set_flags({"FLAGS_ragged_attention": prev})


def attn_case(name, seq_lens, q_lens, t, window, flush, num_pages=600,
              h=32, kvh=8, d=128, page=16, seed=0, dtype="bfloat16",
              kv_dtype=None, decode=False):
    """One paged attention kernel against its plain version: the ragged
    kernel, or with ``decode`` the decode kernel (``paged_attention``
    under ``FLAGS_ragged_attention=off``: q (B, H, D), one token a row;
    ``q_lens`` and ``t`` are then [1] * B and 1). ``kv_dtype="int8"``:
    random int8 codes with random per-page, per-head scales in [0.005,
    0.03), the serving path's bf16 q beside them."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        paged_attention, paged_attention_plain, paged_ragged_attention,
        paged_ragged_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(seed)
    b = len(seq_lens)
    dt = torch_dtype(dtype)
    quant = kv_dtype == "int8"
    q = torch.randn(b, t, h, d, generator=g, device="cuda").to(dt)
    shape = (num_pages, page, kvh, d)
    if quant:
        kp, vp = (torch.randint(-127, 128, shape, generator=g,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.empty(num_pages, kvh, device="cuda").uniform_(
            0.005, 0.03, generator=g) for _ in range(2))
        scales = {"k_scales": ks, "v_scales": vs}
    else:
        kp = torch.randn(*shape, generator=g, device="cuda").to(dt)
        vp = torch.randn(*shape, generator=g, device="cuda").to(dt)
        scales = {}
    mp = 1 << (max(1, max(-(-s // page) for s in seq_lens)) - 1).bit_length()
    perm = torch.randperm(num_pages, generator=g, device="cuda")
    tbl = torch.zeros(b, mp, dtype=torch.int32, device="cuda")
    used = 0
    for i, s in enumerate(seq_lens):
        n = -(-s // page)
        tbl[i, :n] = perm[used:used + n].int()
        used += n
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    ql = None if q_lens is None else torch.tensor(
        q_lens, dtype=torch.int32, device="cuda")

    if decode:
        qd1 = q[:, 0]

        def kernel():
            with ragged_mode("off"):
                return paged_attention(qd1, kp, vp, tbl, lens,
                                       window=window, **scales)[:, None]

        def plain():
            return paged_attention_plain(qd1, kp, vp, tbl, lens,
                                         window=window, **scales)[:, None]
    else:
        def kernel():
            return paged_ragged_attention(q, kp, vp, tbl, lens, ql,
                                          window=window, **scales)

        def plain():
            return paged_ragged_attention_plain(q, kp, vp, tbl, lens, ql,
                                                window=window, **scales)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    d_err = (got.float() - ref.float()).abs()
    # the ragged kernel's tensor-core route (T > 1, bf16 q) rounds p to
    # bf16 before P V, as the TPU kernel's float branch does, where the
    # plain version keeps it in float32: it takes the flash kernels'
    # relative L2 gates; every other case keeps one bf16 spacing + 1e-5
    tensor_cores = not decode and t > 1 and dtype == "bfloat16"
    rel = rel_l2_errors(got, ref) if tensor_cores else None
    if tensor_cores:
        tol = FLASH_TOL["bfloat16"]
        ok = rel[0] <= tol["tensor"] and rel[1] <= tol["row"]
        tol_text = (f"||err|| <= {tol['tensor']:g} ||ref|| over the tensor "
                    f"and <= {tol['row']:g} ||ref row|| over each row of D "
                    "values (p rounded to bf16 before P V)")
    else:
        ok = within_tolerance(got, ref)
        tol_text = tolerance_text(dtype)
    pad_zero = True
    for i, (s, n) in enumerate(zip(seq_lens, q_lens or [t] * b)):
        pad = t if s == 0 else t - n
        if pad > 0 and bool((got[i, :pad] != 0).any()):
            pad_zero = False
    # the library yardstick: SDPA over the already-gathered dense K/V of
    # the same rows (int8 pages dequantized to q's type beforehand) with
    # the same boolean mask; gathering and dequantizing are not timed
    kd, vd = (pages[tbl.long()] for pages in (kp, vp))
    if quant:
        kd = kd.float() * ks[tbl.long()][:, :, None, :, None]
        vd = vd.float() * vs[tbl.long()][:, :, None, :, None]
    kd = kd.to(dt).reshape(b, mp * page, kvh, d).transpose(1, 2)
    vd = vd.to(dt).reshape(b, mp * page, kvh, d).transpose(1, 2)
    qd = q.transpose(1, 2)
    kpos = torch.arange(mp * page, device="cuda")
    rows = torch.arange(t, device="cuda")
    qpos = lens.long()[:, None] - t + rows[None, :]
    keep = (kpos[None, None] <= qpos[:, :, None]) & \
        (kpos[None, None] < lens.long()[:, None, None])
    if window:
        keep = keep & (qpos[:, :, None] - kpos[None, None] < window)
    keep = keep[:, None]
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=keep, enable_gqa=True), flush=flush)
    nbytes, flops = attn_work(seq_lens, q_lens, t, h, kvh, d, window,
                              page, q.element_size(), kp.element_size(),
                              scales=quant)
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    return {
        "case": name, "B": b, "T": t, "H": h, "KVH": kvh, "D": d,
        "page_size": page, "max_pages": mp, "window": window,
        "seq_lens": seq_lens, "q_lens": q_lens, "dtype": dtype,
        "kv_dtype": kv_dtype or dtype,
        "max_abs_err": float(d_err.max()),
        "max_rel_err": float(
            (d_err / ref.float().abs().clamp_min(1e-6)).max()),
        "rel_l2_err": rel,
        "tolerance": tol_text + "; padded rows exactly 0",
        "padded_rows_zero": pad_zero, "ok": ok and pad_zero,
        "kernel_ms": cuda_time_ms(kernel, flush=flush),
        "plain_ms": cuda_time_ms(plain, flush=flush),
        "library_ms": library_ms,
        "library": "SDPA over the gathered pages"
        + (", dequantized beforehand (not timed)" if quant else ""),
        "bound_ms": b_ms, "bound_by": b_by,
    }


# the paged attention cases: (kernel, case name, attn_case arguments).
# DECODE_LENS is the serving batch's decode rows; the decode kernel's
# cases call paged_attention under FLAGS_ragged_attention=off.
DECODE_LENS = [1056, 64, 300, 777, 1000, 129, 512, 16]
# build_server's prompt lengths (seed 0) + 32 generated tokens
VERIFY_LENS = [780, 655, 725, 288, 931, 859, 803, 455]
_RAGGED = "paged_ragged_attention"
_DECODE = "paged_decode_attention"
_D1 = dict(q_lens=[1] * 8, t=1, window=0)
ATTN_CASES = [
    (_RAGGED, "decode", dict(seq_lens=DECODE_LENS, seed=1, **_D1)),
    (_RAGGED, "decode_float32", dict(seq_lens=DECODE_LENS, seed=1,
                                     dtype="float32", **_D1)),
    (_RAGGED, "prefill_chunk", dict(seq_lens=[1000], q_lens=[248], t=256,
                                    window=0, seed=2)),
    # the serving path's largest bucket: 7 decode rows + one 248-token
    # prefill chunk in one (8, 256) right-aligned block
    (_RAGGED, "mixed", dict(seq_lens=[900, 640, 333, 1056, 71, 512, 1001,
                                      496],
                            q_lens=[1, 1, 1, 1, 1, 1, 1, 248], t=256,
                            window=0, seed=3)),
    (_RAGGED, "seq_len0_rows", dict(seq_lens=[300, 17, 0, 0],
                                    q_lens=[1, 1, 0, 0], t=1, window=0,
                                    seed=4)),
    (_RAGGED, "window", dict(seq_lens=[900, 300, 64, 1000],
                             q_lens=[64, 1, 64, 30], t=64, window=128,
                             seed=5)),
    # q_lens absent and seq_len < T: the leading rows see no key and
    # average V over the visited pages' slots, as the TPU kernel does
    (_RAGGED, "no_key_rows", dict(seq_lens=[5, 40, 12, 1], q_lens=None,
                                  t=16, window=0, seed=6)),
    # the int8 branch, bf16 q beside int8 pages as on the serving path
    (_RAGGED, "mixed_int8", dict(seq_lens=[900, 640, 333, 1056, 71, 512,
                                           1001, 496],
                                 q_lens=[1, 1, 1, 1, 1, 1, 1, 248], t=256,
                                 window=0, seed=3, kv_dtype="int8")),
    # Qwen2-0.5B's heads (14 q and 2 kv heads of 64, group 7: M tiles of
    # 9 rows x 7 heads) at the mixed bucket's lengths
    (_RAGGED, "mixed_group7_d64", dict(seq_lens=[900, 640, 333, 1056, 71,
                                                 512, 1001, 496],
                                       q_lens=[1, 1, 1, 1, 1, 1, 1, 248],
                                       t=256, window=0, seed=9, h=14, kvh=2,
                                       d=64)),
    # a long prompt's last chunk: 248 rows over 8,192 keys (512 pages of
    # the 600-page pool), where the split over keys shows
    (_RAGGED, "prefill_chunk_8k", dict(seq_lens=[8192], q_lens=[248],
                                       t=256, window=0, seed=10)),
    (_RAGGED, "prefill_chunk_int8", dict(seq_lens=[1000], q_lens=[248],
                                         t=256, window=0, seed=2,
                                         kv_dtype="int8")),
    (_RAGGED, "window_int8", dict(seq_lens=[900, 300, 64, 1000],
                                  q_lens=[64, 1, 64, 30], t=64, window=128,
                                  seed=5, kv_dtype="int8")),
    (_RAGGED, "no_key_rows_int8", dict(seq_lens=[5, 40, 12, 1],
                                       q_lens=None, t=16, window=0, seed=6,
                                       kv_dtype="int8")),
    # the speculative verify rows: serve's 8 requests at their last window
    # (VERIFY_LENS), draft_k + 1 = 5 query rows each, right-aligned in the
    # adapter's block of 8
    (_RAGGED, "verify", dict(seq_lens=VERIFY_LENS, q_lens=[5] * 8, t=8,
                             window=0, seed=11)),
    (_RAGGED, "verify_int8", dict(seq_lens=VERIFY_LENS, q_lens=[5] * 8, t=8,
                                  window=0, seed=11, kv_dtype="int8")),
    # the decode kernel
    (_DECODE, "decode", dict(seq_lens=DECODE_LENS, seed=1, **_D1)),
    (_DECODE, "decode_int8", dict(seq_lens=DECODE_LENS, seed=1,
                                  kv_dtype="int8", **_D1)),
    (_DECODE, "decode_float32", dict(seq_lens=DECODE_LENS, seed=1,
                                     dtype="float32", **_D1)),
    (_DECODE, "decode_seq_len0_rows", dict(seq_lens=[300, 17, 0, 0],
                                           q_lens=[1] * 4, t=1, window=0,
                                           seed=4)),
    # windows of 128 that start mid-page (872, 172, 1, 649, 392) and on
    # a page edge (928), and rows shorter than the window
    (_DECODE, "decode_window", dict(seq_lens=[1000, 300, 129, 777, 64, 16,
                                              520, 1056],
                                    q_lens=[1] * 8, t=1, window=128,
                                    seed=5)),
    # Qwen2-0.5B's heads: 14 q and 2 kv heads of 64 (group 7)
    (_DECODE, "decode_group7_d64", dict(seq_lens=DECODE_LENS, seed=7, h=14,
                                        kvh=2, d=64, **_D1)),
    # group 16: two blocks of 8 q heads a kv head and chunk (int8 pages)
    (_DECODE, "decode_group16_int8", dict(seq_lens=DECODE_LENS, seed=8,
                                          h=32, kvh=2, kv_dtype="int8",
                                          **_D1)),
]


def attn_cases(flush, names=None):
    """{kernel name: [case results]} over ATTN_CASES (those in ``names``
    only, when given)."""
    out = {_RAGGED: [], _DECODE: []}
    for kernel, name, kw in ATTN_CASES:
        if names is None or name in names:
            out[kernel].append(attn_case(name, flush=flush,
                                         decode=kernel == _DECODE, **kw))
    return out


def fused_step_case(flush, seq_lens=(900, 640, 333, 1056, 71, 512, 1001,
                                     496),
                    q_lens=(1, 1, 1, 1, 1, 1, 1, 248), pad_to=256, seed=3):
    """``paged_ragged_fused_step`` (the port of #11: qkv projection, RoPE
    and the chunk's page writes in torch around the ragged kernel, then
    o_proj) for one Llama-3-8B layer at the serving path's mixed bucket,
    against the same function built from ``torch.matmul`` and SDPA over
    the gathered pages (the library yardstick): its device time per
    layer call and its bound. Repeated calls write the same slots, so
    every call does the same work."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.nn import PagedKVCacheManager
    from paddle_tpu_torch.inference.paged_llama import _right_align_plan
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_ragged_fused_step
    from paddle_tpu_torch.ops.kernels.rope import (apply_rotary_emb,
                                                   build_rope_cache)

    e, nh, kvh, hd, page = 4096, 32, 8, 128, 16
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(
            torch.bfloat16)

    pool = PagedKVCacheManager(600, page, kvh, hd, device="cuda")
    pool.k_pages.copy_(rnd(*pool.k_pages.shape))
    pool.v_pages.copy_(rnd(*pool.v_pages.shape))
    ids = [f"s{i}" for i in range(len(seq_lens))]
    for i, s, c in zip(ids, seq_lens, q_lens):
        pool.alloc(i)
        pool.book_ragged([i], [s - c])
    pool.book_ragged(ids, q_lens)
    b, t = len(ids), max(q_lens)
    mp = 1 << (max(-(-s // page) for s in seq_lens) - 1).bit_length()
    step = pool.ragged_step_inputs(ids, q_lens, rows_pad=b, max_pages=mp)
    starts = [sum(q_lens[:i]) for i in range(b)]
    n_real = sum(q_lens)
    gm, mr, mc, mflat = (torch.from_numpy(a).long().cuda() for a in
                         _right_align_plan(range(b), starts, q_lens, t, b))
    pos = torch.zeros(pad_to, dtype=torch.long, device="cuda")
    pos[:n_real] = torch.cat([torch.arange(s - c, s, device="cuda")
                              for s, c in zip(seq_lens, q_lens)])
    cos, sin = build_rope_cache(2048, hd, base=500000.0, device="cuda")
    x = rnd(pad_to, e)
    w = [rnd(e, n, scale=e ** -0.5) for n in (nh * hd, kvh * hd, kvh * hd)]
    wo = rnd(nh * hd, e, scale=e ** -0.5)

    def kernel():
        return paged_ragged_fused_step(
            x, *w, wo, None, cos, sin, pos, step.slots[0], step.slots[1], gm,
            mr, mc, mflat, pool.k_pages, pool.v_pages, step.page_table,
            step.seq_lens, step.q_lens, n_real=n_real)[0]

    tbl = step.page_table.long()
    kpos = torch.arange(mp * page, device="cuda")
    qpos = step.seq_lens.long()[:, None] - t + torch.arange(t, device="cuda")
    keep = ((kpos[None, None] <= qpos[:, :, None])
            & (kpos[None, None] < step.seq_lens.long()[:, None, None]))[:, None]

    def library():
        q = apply_rotary_emb(torch.matmul(x, w[0]).reshape(1, pad_to, nh, hd),
                             cos, sin, position_ids=pos)[0]
        k = apply_rotary_emb(torch.matmul(x, w[1]).reshape(1, pad_to, kvh,
                                                           hd),
                             cos, sin, position_ids=pos)[0]
        v = torch.matmul(x, w[2]).reshape(pad_to, kvh, hd)
        pool.k_pages.index_put_((step.slots[0], step.slots[1]), k[:n_real])
        pool.v_pages.index_put_((step.slots[0], step.slots[1]), v[:n_real])
        kd = pool.k_pages[tbl].reshape(b, mp * page, kvh, hd).transpose(1, 2)
        vd = pool.v_pages[tbl].reshape(b, mp * page, kvh, hd).transpose(1, 2)
        o = F.scaled_dot_product_attention(
            q[gm].transpose(1, 2), kd, vd, attn_mask=keep, enable_gqa=True)
        attn = torch.zeros(pad_to, nh, hd, dtype=x.dtype, device="cuda")
        attn[mflat] = o.transpose(1, 2)[mr, mc]
        return torch.matmul(attn.reshape(pad_to, nh * hd), wo)

    got = kernel()
    ref = library()
    torch.cuda.synchronize()
    cos_sim = float(F.cosine_similarity(got[:n_real].float().flatten(),
                                        ref[:n_real].float().flatten(),
                                        dim=0))
    attn_bytes, attn_flops = attn_work(list(seq_lens), list(q_lens), t, nh,
                                       kvh, hd, 0, page, 2)
    nbytes = 2 * (sum(t.numel() for t in w) + wo.numel()
                  + 2 * x.numel() + 2 * n_real * kvh * hd) + attn_bytes
    flops = 2 * pad_to * e * (2 * nh * hd + 2 * kvh * hd) + attn_flops
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    return {"case": "mixed", "seq_lens": list(seq_lens),
            "q_lens": list(q_lens), "packed_tokens": n_real,
            "pad_to": pad_to, "hidden": e, "heads": nh, "kv_heads": kvh,
            "head_dim": hd, "cosine_vs_library": cos_sim,
            "max_abs_err": float((got[:n_real] - ref[:n_real]).abs().max()),
            "tolerance": f"cosine with the library version >= {COSINE_GATE}",
            "ok": cos_sim >= COSINE_GATE,
            "kernel_ms": cuda_time_ms(kernel, flush=flush),
            "library": "torch.matmul + SDPA over the gathered pages",
            "library_ms": cuda_time_ms(library, flush=flush),
            "bound_ms": b_ms, "bound_by": b_by}


# Flash kernels against their plain float32 versions on the same inputs,
# each tensor (out, dq, dk, dv) held by two relative L2 errors: over the
# whole tensor, and over each row of D values (a q row of out or dq, a
# key row of dk or dv) against that row's own norm, so that a fault in
# the late rows of a causal band, whose values are small, shows as
# plainly as one in the first rows. bfloat16: the kernels round p (and
# ds) to bf16 before their products, as the TPU kernel does, while the
# plain versions keep them in float32, and the outputs are cast to bf16
# (2^-9 relative) at the end. On an H100 (700 W) the eight cases below
# measured at most 2.65e-3 over a tensor and 5.4e-3 over a row in bf16:
# the gates leave 2.9x headroom. In float32, 4.2e-7 over a tensor, and
# over a row 1.1e-6, but 2.1e-5 on dq's one-key rows (see
# rel_l2_errors). The faults that --fault-check plants fail the gates
# by far over the rows: 0.49 to 1.14, each in the kernel it broke
# alone. lse is float32 in both: within 1e-4 + 1e-5|lse|. Rows that
# see no key must be exactly 0, with lse exactly -1e30, and are left
# out of the comparison of out and lse.
FLASH_TOL = {"bfloat16": {"tensor": 2.0 ** -7, "row": 2.0 ** -6},
             "float32": {"tensor": 1e-5, "row": 1e-4}}


def rel_l2_errors(got, ref):
    """(||got - ref|| / ||ref|| over the tensor, the largest of the same
    ratio over its rows of D values) in float32. A row's reference norm
    is floored at 1/8 of the median norm of the rows that are not zero:
    a causal dq row that sees one key has p = 1 and so ds = 0 exactly,
    which leaves its reference at rounding noise."""
    err = got.float() - ref.float()
    ref = ref.float()
    ref_rows = ref.norm(dim=-1)
    nonzero = ref_rows[ref_rows > 0]
    floor = nonzero.median() / 8 if nonzero.numel() else 1e-30
    rows = err.norm(dim=-1) / ref_rows.clamp_min(floor)
    return (float(err.norm() / ref.norm().clamp_min(1e-30)),
            float(rows.max()))


def hold_flash(fwd, kern, plain, ref_out, ref_lse, tol, flush):
    """Runs one flash or varlen kernel and holds it against its plain
    version: the forward's out over the rows that see a key, its lse,
    and the rows that see none (exactly 0, lse -1e30); a backward's
    tensors whole. ``plain`` is the plain version (for a backward, also
    the reference; a forward's is ``ref_out``, ``ref_lse``, whose last
    axis is the rows). Returns the result fields every case shares."""
    import torch

    got = kern()
    torch.cuda.synchronize()
    if fwd:
        seen = ref_lse > -1e29
        seen_rows = seen.transpose(-1, -2)  # out's row layout
        got, lse = got
        lse_err = float(((lse - ref_lse).abs() * seen).max())
        nokey_zero = bool((got[~seen_rows] == 0).all()) and \
            bool((lse[~seen] == -1e30).all())
        lse_ok = bool((((lse - ref_lse).abs()
                        <= 1e-4 + 1e-5 * ref_lse.abs()) | ~seen).all())
        got, ref = (got,), (ref_out,)
        pairs_cmp = [(got[0][seen_rows], ref_out[seen_rows])]
    else:
        ref = plain()
        lse_err, nokey_zero, lse_ok = None, True, True
        pairs_cmp = list(zip(got, ref))
    errs = [float((a.float() - r.float()).abs().max()) for a, r in
            zip(got, ref)]
    rel = [rel_l2_errors(a, r) for a, r in pairs_cmp]
    ok = all(t <= tol["tensor"] and r <= tol["row"] for t, r in rel)
    return {
        "max_abs_err": max(errs),
        # per output tensor: [||err|| / ||ref||, max over rows of it]
        "rel_l2_err": rel,
        "lse_max_abs_err": lse_err,
        "tolerance": (f"||err|| <= {tol['tensor']:g} ||ref|| over each "
                      f"tensor and <= {tol['row']:g} ||ref row|| over "
                      "each row of D values"
                      + ("; lse within 1e-4 + 1e-5|lse|; rows that "
                         "see no key exactly 0, lse -1e30" if fwd else "")),
        "no_key_rows_exact": nokey_zero,
        "ok": ok and lse_ok and nokey_zero,
        "kernel_ms": cuda_time_ms(kern, flush=flush),
        "plain_ms": cuda_time_ms(plain, iters=5, flush=flush),
    }


def flash_work(b, sq, sk, h, kvh, d, causal, window, itemsize):
    """(kept (q, k) pairs over every head, {kernel: bytes}): each input
    read once and each output written once. The kernels do 2 products
    over the kept pairs in the forward (q k^T, p v), 4 in dK/dV (q k^T,
    p^T do, do v^T, ds^T q) and 3 in dQ (q k^T, do v^T, ds k)."""
    import numpy as np

    if causal:
        qpos = np.arange(sq) + (sk - sq)
        hi = np.minimum(sk - 1, qpos)
        lo = np.maximum(0, qpos - window + 1) if window else 0
        per_head = int(np.maximum(hi - lo + 1, 0).sum())
    else:
        per_head = sq * sk
    qb = b * sq * h * d * itemsize
    kvb = b * sk * kvh * d * itemsize
    rows = b * h * sq * 4
    return b * h * per_head, {
        "flash_attention_fwd": 2 * qb + 2 * kvb + rows,
        "flash_attention_bwd_dkdv": 2 * qb + 4 * kvb + 2 * rows,
        "flash_attention_bwd_dq": 3 * qb + 2 * kvb + 2 * rows,
    }


FLASH_PRODUCTS = {"flash_attention_fwd": 2, "flash_attention_bwd_dkdv": 4,
                  "flash_attention_bwd_dq": 3}

# (name, B, Sq, Sk, H, KVH, D, causal, keyword arguments of flash_case)
FLASH_CASES = [
    # the training path: Qwen2-0.5B, batch 8 x 2048
    ("train", 8, 2048, 2048, 14, 2, 64, True, {}),
    # Llama-3-8B's heads
    ("gqa_d128", 2, 2048, 2048, 32, 8, 128, True, {"seed": 1}),
    ("window", 1, 2048, 2048, 32, 8, 128, True, {"window": 512, "seed": 2}),
    ("rect_q256_k2048", 1, 256, 2048, 14, 2, 64, True, {"seed": 3}),
    # Sq > Sk: the first 384 rows see no key
    ("rect_q512_k128", 1, 512, 128, 8, 2, 128, True, {"seed": 4}),
    ("noncausal", 2, 1024, 1024, 16, 4, 128, False, {"seed": 5}),
    ("float32", 1, 256, 256, 4, 2, 64, True,
     {"dtype": "float32", "seed": 6}),
    ("dlse", 1, 512, 512, 8, 2, 64, True, {"dlse": True, "seed": 7}),
    # rows a multiple of no 4: the dK/dV kernel's lse and delta boxes
    # start below the tile's first row
    ("odd_rows", 2, 333, 333, 8, 2, 64, True, {"seed": 8}),
    # Qwen2's group 7 at D = 128: Sq a multiple of no M tile's 9 rows,
    # under a window
    ("group7_d128_window", 2, 1001, 1001, 14, 2, 128, True,
     {"window": 300, "seed": 9}),
]


def flash_case(name, b, sq, sk, h, kvh, d, causal, flush, window=0,
               dtype="bfloat16", dlse=False, seed=0):
    """{kernel name: case result} for the forward (unless ``dlse``: the
    backward-only case) and both backward kernels."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch_dtype(dtype)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    q, k, v, do = rnd(b, sq, h, d), rnd(b, sk, kvh, d), rnd(b, sk, kvh, d), \
        rnd(b, sq, h, d)
    dl = 0.1 * torch.randn(b, h, sq, generator=g, device="cuda") \
        if dlse else None
    scale = d ** -0.5
    tol = FLASH_TOL[dtype]
    # the backward of both versions starts from the plain forward
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                    window)
    delta = fa._delta(do, ref_out, dl)
    bwd_args = (q, k, v, do, ref_lse, delta, causal, scale, window)
    runs = {
        "flash_attention_bwd_dkdv": (
            lambda: fa.flash_attention_bwd_dkdv(*bwd_args),
            lambda: fa.flash_attention_bwd_dkdv_plain(*bwd_args)),
        "flash_attention_bwd_dq": (
            lambda: (fa.flash_attention_bwd_dq(*bwd_args),),
            lambda: (fa.flash_attention_bwd_dq_plain(*bwd_args),)),
    }
    if not dlse:
        runs["flash_attention_fwd"] = (
            lambda: fa.flash_attention_fwd(q, k, v, causal, scale, window),
            lambda: fa.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                 window))

    # the library yardstick: SDPA on [B, H, S, D] views (an explicit
    # band mask where is_causal's top-left alignment or the window
    # differ from the port's), forward, and its autograd backward for
    # both backward kernels (it computes dq, dk and dv at once)
    keep = fa._keep_mask(sq, sk, causal, window, "cuda")
    mask = {"attn_mask": keep} if causal and (sq != sk or window) else \
        {"is_causal": causal}
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa_fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **mask), flush=flush)
    o = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **mask)
    dot = do.transpose(1, 2)
    sdpa_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True), flush=flush)
    del o

    pairs, nbytes = flash_work(b, sq, sk, h, kvh, d, causal, window,
                               q.element_size())
    out = {}
    for kname, (kern, plain) in runs.items():
        b_ms, b_by = bound_ms(
            nbytes[kname], 2 * d * FLASH_PRODUCTS[kname] * pairs, dtype)
        out[kname] = {
            "case": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "KVH": kvh,
            "D": d, "causal": causal, "window": window, "dtype": dtype,
            "dlse": dlse, "kept_pairs": pairs,
            "rows_without_key": int((ref_lse <= -1e29).sum()),
            **hold_flash(kname == "flash_attention_fwd", kern, plain,
                         ref_out, ref_lse, tol, flush),
            "library_ms": sdpa_fwd_ms if kname == "flash_attention_fwd"
            else sdpa_bwd_ms,
            "bound_ms": b_ms, "bound_by": b_by,
        }
    return out


def flash_cases(flush, names=None):
    """{kernel name: [case results]} over FLASH_CASES (those in ``names``
    when given)."""
    flash = {name: [] for name in FLASH}
    for name, *shape, kw in FLASH_CASES:
        if names is None or name in names:
            for kname, result in flash_case(name, *shape, flush,
                                            **kw).items():
                flash[kname].append(result)
    return flash


# ------------------------------------------------------- varlen flash
def pack_lengths(seed, budget=None):
    """Document lengths of one packed batch: RandomState(seed).randint(64,
    2049) until the budget (the train cell's 8 x 2048 tokens) is full,
    the last one cut to fill it."""
    import numpy as np

    budget = budget or TRAIN_BATCH * TRAIN_SEQ
    rng, lens = np.random.RandomState(seed), []
    while sum(lens) < budget:
        lens.append(int(rng.randint(64, 2049)))
    lens[-1] -= sum(lens) - budget
    return lens


def _cu(lens):
    import numpy as np

    return [0] + np.cumsum(lens).tolist()


# bench.py's flash_varlen_8k documents (bench.py:545-547): 8192 tokens
VARLEN_8K_LENS = [2048, 1536, 1024, 512, 512, 512, 512, 256, 256, 64, 32,
                  16, 8, 8, 8] + [8] * 111

# (name, q lengths, k lengths (None: the q lengths), tokens past cu[-1]
# on both sides, H, KVH, D, causal, keyword arguments of varlen_case)
VARLEN_CASES = [
    # the varlen path: Qwen2-0.5B's attention on one 16384-token pack
    ("varlen_train", pack_lengths(0), None, 0, 14, 2, 64, True, {}),
    ("varlen_8k", VARLEN_8K_LENS, None, 0, 16, 16, 128, True, {"seed": 1}),
    ("varlen_noncausal", [700, 1500, 300, 1596], None, 0, 16, 4, 128, False,
     {"seed": 2}),
    ("varlen_gqa_d128", [1000, 2000, 1096], None, 0, 8, 2, 128, True,
     {"seed": 3}),
    ("varlen_tile_edges", [64, 128, 64, 192, 576], None, 0, 8, 2, 64, True,
     {"seed": 4}),
    ("varlen_tiny_docs", [8] * 256, None, 0, 8, 2, 64, True, {"seed": 5}),
    ("varlen_cu_q_ne_k", [300, 500, 224], [600, 100, 324], 0, 8, 2, 64, True,
     {"seed": 6}),
    ("varlen_tail", [700, 900], None, 400, 8, 2, 64, True, {"seed": 7}),
    # the middle q segment's 300 rows see no key
    ("varlen_empty_k", [200, 300, 100], [400, 0, 200], 0, 8, 2, 64, True,
     {"seed": 8}),
    ("varlen_float32", [100, 60, 96], None, 0, 4, 2, 64, True,
     {"dtype": "float32", "seed": 9}),
    # totals a multiple of no 4 (the dK/dV kernel's lse and delta boxes
    # start below a tile's first row), D = 128 at group 4, noncausal
    ("varlen_odd_total", [301, 500, 222], None, 9, 8, 2, 128, False,
     {"seed": 10}),
]


def varlen_work(cu_q, cu_k, tq, tk, h, kvh, d, causal, itemsize):
    """(kept (q, k) pairs over every head, {kernel: bytes}), as
    flash_work counts them, over the segments of THESE boundaries:
    causal keeps min(i + 1, keys) keys for a segment's row i."""
    import torch
    from paddle_tpu_torch.ops.kernels.flash_varlen import _ranges

    per_head = 0
    for (qb, qe, _), (kb, ke, _) in zip(_ranges(torch.tensor(cu_q), tq),
                                        _ranges(torch.tensor(cu_k), tk)):
        nq, nk = qe - qb, ke - kb
        if not causal:
            per_head += nq * nk
        elif nq <= nk:
            per_head += nq * (nq + 1) // 2
        else:
            per_head += nk * (nk + 1) // 2 + (nq - nk) * nk
    qb, kvb = tq * h * d * itemsize, tk * kvh * d * itemsize
    rows, cu = h * tq * 4, 2 * len(cu_q) * 4
    return h * per_head, {
        "flash_varlen_fwd": 2 * qb + 2 * kvb + rows + cu,
        "flash_varlen_bwd_dkdv": 2 * qb + 4 * kvb + 2 * rows + cu,
        "flash_varlen_bwd_dq": 3 * qb + 2 * kvb + 2 * rows + cu,
    }


def _varlen_library(q, k, v, do, cu_q, cu_k, causal, scale, flush):
    """Times of PyTorch calls that compute the same function, forward and
    autograd backward (dq, dk and dv at once); timed only, never used by
    the port: SDPA summed over one call per document, SDPA over the pack
    with the block-diagonal boolean mask, and
    ``torch.nn.attention.varlen.varlen_attn`` where that module imports
    (the ``env`` line says whether it does), the inputs are bf16 and the
    q and k boundaries agree."""
    import inspect

    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_varlen as fv

    tq, tk = q.shape[0], k.shape[0]
    out = {}
    pairs = [(slice(a, b), slice(c, e)) for (a, b, _), (c, e, _) in zip(
        fv._ranges(cu_q, tq), fv._ranges(cu_k, tk)) if b > a and e > c]

    def leaf(t, s):
        return t[s].transpose(0, 1)[None].contiguous().requires_grad_()

    docs = [(leaf(q, a), leaf(k, b), leaf(v, b), do[a].transpose(0, 1)[None])
            for a, b in pairs]

    def docs_fwd():
        return [F.scaled_dot_product_attention(
            dq_, dk_, dv_, is_causal=causal, scale=scale, enable_gqa=True)
            for dq_, dk_, dv_, _ in docs]

    outs = docs_fwd()
    leaves = [t for doc in docs for t in doc[:3]]
    out["sdpa_per_document"] = (cuda_time_ms(docs_fwd, flush=flush),
                                cuda_time_ms(lambda: torch.autograd.grad(
                                    outs, leaves, [d[3] for d in docs],
                                    retain_graph=True), flush=flush))
    del outs

    seg_q, loc_q = fv.segments(cu_q, tq)
    seg_k, loc_k = fv.segments(cu_k, tk)
    keep = seg_q[:, None] == seg_k[None, :]
    if causal:
        keep &= loc_q[:, None] >= loc_k[None, :]
    qt, kt, vt = (t.transpose(0, 1)[None].detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(0, 1)[None]

    def masked():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep, scale=scale, enable_gqa=True)

    o = masked()
    out["sdpa_block_diagonal_mask"] = (
        cuda_time_ms(masked, flush=flush),
        cuda_time_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True), flush=flush))
    del o, keep

    try:
        import torch.nn.attention.varlen as tv
    except ImportError:
        tv = None
    # it runs FlashAttention's kernel: bf16 and fp16 only
    if tv is not None and q.dtype == torch.bfloat16 and \
            bool((cu_q == cu_k).all()) and tq == tk:
        cu = cu_q.tolist()
        if cu[-1] < tq:
            cu.append(tq)  # the tokens past cu[-1]: one more sequence
        cu = torch.tensor(cu, dtype=torch.int32, device=q.device)
        mx = int((cu[1:] - cu[:-1]).max())
        params = inspect.signature(tv.varlen_attn).parameters
        kw = {"scale": scale}
        if "window_size" in params:
            kw["window_size"] = (-1, 0) if causal else (-1, -1)
        else:
            kw["is_causal"] = causal
        kh, vh = k, v
        if "enable_gqa" in params:
            kw["enable_gqa"] = True
        else:
            g = q.shape[1] // k.shape[1]
            kh, vh = (t.repeat_interleave(g, dim=1) for t in (k, v))
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, kh, vh))

        def library():
            return tv.varlen_attn(ql, kl, vl, cu, cu, mx, mx, **kw)

        o = library()
        out["varlen_attn"] = (
            cuda_time_ms(library, flush=flush),
            cuda_time_ms(lambda: torch.autograd.grad(
                o, (ql, kl, vl), do, retain_graph=True), flush=flush))
    return out


def varlen_case(name, lens_q, lens_k, tail, h, kvh, d, causal, flush,
                dtype="bfloat16", seed=0):
    """{kernel name: case result} for the three varlen kernels against
    their plain versions, held like the flash cases (FLASH_TOL, relative
    L2 over each tensor and each row of D values)."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_varlen as fv

    lens_k = lens_q if lens_k is None else lens_k
    tq, tk = sum(lens_q) + tail, sum(lens_k) + tail
    g = torch.Generator(device="cuda").manual_seed(100 + seed)
    dt = torch_dtype(dtype)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    q, k, v, do = rnd(tq, h, d), rnd(tk, kvh, d), rnd(tk, kvh, d), \
        rnd(tq, h, d)
    cu_q = torch.tensor(_cu(lens_q), dtype=torch.int32, device="cuda")
    cu_k = torch.tensor(_cu(lens_k), dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    tol = FLASH_TOL[dtype]
    # the backward of both versions starts from the plain forward
    ref_out, ref_lse = fv.flash_varlen_fwd_plain(q, k, v, cu_q, cu_k, causal,
                                                 scale)
    delta = fv._delta(do, ref_out)
    bwd_args = (q, k, v, do, ref_lse, delta, cu_q, cu_k, causal, scale)
    runs = {
        "flash_varlen_fwd": (
            lambda: fv.flash_varlen_fwd(q, k, v, cu_q, cu_k, causal, scale),
            lambda: fv.flash_varlen_fwd_plain(q, k, v, cu_q, cu_k, causal,
                                              scale)),
        "flash_varlen_bwd_dkdv": (
            lambda: fv.flash_varlen_bwd_dkdv(*bwd_args),
            lambda: fv.flash_varlen_bwd_dkdv_plain(*bwd_args)),
        "flash_varlen_bwd_dq": (
            lambda: (fv.flash_varlen_bwd_dq(*bwd_args),),
            lambda: (fv.flash_varlen_bwd_dq_plain(*bwd_args),)),
    }
    lib = _varlen_library(q, k, v, do, cu_q, cu_k, causal, scale, flush)
    lib_name = "varlen_attn" if "varlen_attn" in lib else \
        "sdpa_block_diagonal_mask"
    pairs, nbytes = varlen_work(_cu(lens_q), _cu(lens_k), tq, tk, h, kvh, d,
                                causal, q.element_size())
    out = {}
    for kname, (kern, plain) in runs.items():
        b_ms, b_by = bound_ms(nbytes[kname], 2 * d * VARLEN_PRODUCTS[kname]
                              * pairs, dtype)
        out[kname] = {
            "case": name, "Tq": tq, "Tk": tk, "H": h, "KVH": kvh, "D": d,
            "causal": causal, "dtype": dtype, "docs": len(lens_q),
            "longest": max(max(lens_q), max(lens_k)), "tail": tail,
            "cu_q_equals_cu_k": lens_k == lens_q,
            "kept_pairs": pairs,
            "rows_without_key": int((ref_lse <= -1e29).sum()),
            **hold_flash(kname == "flash_varlen_fwd", kern, plain, ref_out,
                         ref_lse, tol, flush),
            "library": lib_name,
            "library_ms": lib[lib_name][kname != "flash_varlen_fwd"],
            "library_ms_all": lib,
            "bound_ms": b_ms, "bound_by": b_by,
        }
    return out


VARLEN_PRODUCTS = {"flash_varlen_fwd": 2, "flash_varlen_bwd_dkdv": 4,
                   "flash_varlen_bwd_dq": 3}


def varlen_cases(flush, names=None):
    """{kernel name: [case results]} over VARLEN_CASES (those in
    ``names`` when given)."""
    out = {name: [] for name in VARLEN}
    for name, *shape, kw in VARLEN_CASES:
        if names is None or name in names:
            for kname, result in varlen_case(name, *shape, flush,
                                             **kw).items():
                out[kname].append(result)
    return out


# Faults that --fault-check plants, one at a time, in a copy of the
# repository, each of which the flash gates must catch: (name, the CUDA
# source, its text, the replacement, the flash and varlen cases to run).
FLASH_FAULTS = [
    # dQ's band walk stops one key tile short (producer and consumers)
    ("dq_drops_last_k_tile", _FLASH_CU,
     "n_tiles = khi >= klo ? khi / 64 - t_lo + 1 : 0;",
     "n_tiles = khi >= klo ? khi / 64 - t_lo : 0;", ("train", "gqa_d128")),
    ("dkdv_drops_one_q_head", _FLASH_CU, "const int n_steps = group * nqt;",
     "const int n_steps = (group - 1) * nqt;", ("train", "gqa_d128")),
    ("dkdv_drops_last_q_tile", _FLASH_CU,
     "const int nqt = qhi >= qlo ? qhi / BQ - t_lo + 1 : 0;",
     "const int nqt = qhi >= qlo ? qhi / BQ - t_lo : 0;", ("train",)),
    # the diagonal key of the late half of the rows (keys) only
    ("dq_late_rows_drop_own_key", _FLASH_CU,
     "return row[r] < p.Sq && k0 + c < p.Sk && keep(p, row[r], k0 + c);",
     "return row[r] < p.Sq && k0 + c < p.Sk && keep(p, row[r], k0 + c) && "
     "!(row[r] >= p.Sq / 2 && k0 + c == row[r] + p.Sk - p.Sq);",
     ("train", "gqa_d128")),
    ("dkdv_late_keys_drop_own_row", _FLASH_CU,
     "return q0 + c < p.Sq && keep(p, q0 + c, kr0 + 8 * r);",
     "return q0 + c < p.Sq && keep(p, q0 + c, kr0 + 8 * r) && "
     "!(kr0 + 8 * r >= p.Sk / 2 && q0 + c == kr0 + 8 * r + p.Sq - p.Sk);",
     ("train", "gqa_d128")),
    # the consumers skip the products of the last staged Q/dO tile
    ("dkdv_skips_last_pipeline_stage", _FLASH_CU,
     "ptt::attn::dkdv_step<D>(sK",
     "if (it + 1 < n_steps) ptt::attn::dkdv_step<D>(sK",
     ("train", "gqa_d128")),
    ("fwd_late_rows_drop_own_key", _FLASH_CU,
     "if (c >= p.Sk || !keep(p, r, c)) x = -INFINITY;",
     "if (c >= p.Sk || !keep(p, r, c) || "
     "(r >= p.Sq / 2 && c == r + p.Sk - p.Sq)) x = -INFINITY;",
     ("train",)),
    # the forward's consumers skip the P V product of the last staged K/V
    # tile (the forward-attention core, shared with the varlen forward and
    # the ragged kernel)
    ("fwd_skips_last_pipeline_stage", _ATTN_CORE,
     "issue_pv<D>(o, cur, h.v(last));",
     "if (n < 0) issue_pv<D>(o, cur, h.v(last));",
     ("train", "gqa_d128", "varlen_train")),
    # varlen: the forward and dQ walk skip each segment's first key tile
    # unless the segment before already walked it
    ("varlen_drops_key_tile_at_segment_start", _VARLEN_CU,
     "nk = max(nk, lo / kBK);", "nk = max(nk, lo / kBK + 1);",
     ("varlen_train", "varlen_tile_edges")),
    # every row also keeps the last key of the segment before its own
    ("varlen_segment_test_off_by_one", _VARLEN_CU,
     "lo = seg_beg(p.cu_k, s, p.Tk);",
     "lo = seg_beg(p.cu_k, s, p.Tk) - (s > 0 ? 1 : 0);",
     ("varlen_train", "varlen_noncausal")),
    # dK/dV's walk stops one q tile short of each segment's last row
    ("varlen_dkdv_drops_last_q_tile", _VARLEN_CU,
     "t_hi = hi / BQ;", "t_hi = hi / BQ - 1;",
     ("varlen_train", "varlen_tile_edges")),
    # dK/dV's consumers skip the products of the last staged Q/dO tile
    ("varlen_dkdv_skips_last_pipeline_stage", _VARLEN_CU,
     "ptt::attn::dkdv_step<D>(sK",
     "if (it + 1 < n_steps) ptt::attn::dkdv_step<D>(sK",
     ("varlen_train", "varlen_gqa_d128")),
    # dQ's M tile takes its last (row, q head) pair for one that sees no
    # key, with lse and delta 0
    ("varlen_dq_drops_last_group_head", _VARLEN_CU,
     "const bool real = pair < rows * group && row < p.Tq;",
     "const bool real = pair < rows * group - 1 && row < p.Tq;",
     ("varlen_train", "varlen_gqa_d128")),
    # dQ's consumers skip the products of the last staged K/V tile (the
    # dQ loop of the backward steps, shared by the varlen and dense dQ
    # kernels)
    ("varlen_dq_skips_last_key_stage", _ATTN_BWD,
     "if (!h.live(k0)) {", "if (j + 1 == n || !h.live(k0)) {",
     ("varlen_train", "varlen_gqa_d128", "train", "gqa_d128")),
    # the forward's hook keeps the key after each pair's interval for the
    # rows past the first document (its tiles that the hull does not
    # enclose)
    ("varlen_fwd_late_rows_keep_next_key", _VARLEN_CU,
     "if (!keys.kept(k0, r, c)) x = -INFINITY;",
     "if (!keys.kept(k0, r, c) && !(keys.lo[r] > 0 && "
     "k0 + c == keys.hi[r] + 1)) x = -INFINITY;",
     ("varlen_train", "varlen_gqa_d128")),
    # the forward's M tile takes its last (row, q head) pair for one that
    # sees no key
    ("varlen_fwd_drops_last_group_head", _VARLEN_CU,
     "if (pair < rows * group && row < p.Tq)",
     "if (pair < rows * group - 1 && row < p.Tq)",
     ("varlen_train", "varlen_gqa_d128")),
]
# faults of the paged attention kernels, each run against the cases of
# _PAGED_FAULT_CASES (``--attn-cases``): (name, source, text, replacement,
# what it may fail). The ragged entry's T = 1 cases run the decode
# kernel's split and merge, so a fault there fails them beside the decode
# entry's; a fault of the tensor-core route fails only ragged T > 1 cases.
_PAGED_FAULT_CASES = ("decode", "decode_int8", "decode_float32",
                      "decode_seq_len0_rows", "decode_window",
                      "decode_group7_d64", "decode_group16_int8",
                      "mixed", "prefill_chunk", "mixed_group7_d64",
                      "mixed_int8", "prefill_chunk_int8", "window_int8",
                      "no_key_rows_int8")
_RAGGED_T1 = tuple(f"{_RAGGED}:{name}" for kernel, name, kw in ATTN_CASES
                   if kernel == _RAGGED and kw["t"] == 1)
_DECODE_SPLIT = (_DECODE,) + _RAGGED_T1
_RAGGED_TC = tuple(f"{_RAGGED}:{name}" for kernel, name, kw in ATTN_CASES
                   if kernel == _RAGGED and kw["t"] > 1)
PAGED_FAULTS = [
    ("decode_drops_last_page", _PAGED_CU,
     "kend = min(seq_len, mp * page);",
     "kend = min((seq_len - 1) / page * page, mp * page);", _DECODE_SPLIT),
    ("decode_int8_scales_v_by_k_scale", _PAGED_CU,
     "vsc[i] = ok ? vscale[srow] : 1.f;",
     "vsc[i] = ok ? kscale[srow] : 1.f;", _DECODE_SPLIT),
    # the merge pass skips each row's last non-empty split partial
    ("decode_merge_drops_last_split", _PAGED_CU,
     "const int s_hi = kstart < kend ? (kend + chunk - 1) / chunk : s_lo;",
     "const int s_hi = kstart < kend ? (kend + chunk - 1) / chunk - 1 "
     ": s_lo;", _DECODE_SPLIT),
    # the tensor-core route's producer takes the scales of the logical page
    ("ragged_int8_scale_of_logical_page", _PAGED_CU,
     "const int64_t scale_row = (int64_t)page_id * kvh_total + kvh;",
     "const int64_t scale_row = (int64_t)((k0 + key) / page) * kvh_total "
     "+ kvh;",
     _RAGGED_TC),
    # its merge skips each row's last non-empty split partial
    ("ragged_merge_drops_last_split", _PAGED_CU,
     "const int last = kstart < kend ? (kend - 1) / chunk : first - 1;",
     "const int last = kstart < kend ? (kend - 1) / chunk - 1 : first - 1;",
     _RAGGED_TC),
    # an M tile leaves out its last (row, q head) pair's q
    ("ragged_tile_drops_last_group_head", _PAGED_CU,
     "if (pair < rows_t * group && row < t)",
     "if (pair < rows_t * group - 1 && row < t)", _RAGGED_TC),
]


# faults of the norm kernels, each run against every case of NORM_CASES
# (``--norm-cases``): (name, source, text, replacement, the "kernel:plan
# kind" whose cases it may fail). The vector classes share one body
# (norm_rows), and the block class and the scalar path one reduction.
_NORM_VECTOR = tuple(f"{k}:{c}" for k in (_RMS, _LN) for c in ("warp",
                                                               "block"))
NORM_FAULTS = [
    # the warp class's rows lose their last 16-byte vector (not read, not
    # written)
    ("norm_warp_drops_last_vector", _NORM_CU,
     "const int nv = a.hidden / N;",
     "const int nv = a.hidden / N - (kBlock ? 0 : 1);",
     (f"{_RMS}:warp", f"{_LN}:warp")),
    # the weight (and bias) vectors are read one vector off
    ("norm_weight_one_vector_off", _NORM_CU,
     "if (has_w) load_vectors<VPL>(a.w, t, lanes, nv, w);",
     "if (has_w) load_vectors<VPL>(static_cast<const uint4*>(a.w) + 1, t, "
     "lanes, nv, w);", _NORM_VECTOR),
    # LayerNorm's variance taken about 0 instead of the mean
    ("layer_norm_variance_without_mean", _NORM_CU,
     "const float c = elem<T>(x[j], k) - mean;",
     "const float c = elem<T>(x[j], k);", (f"{_LN}:warp", f"{_LN}:block")),
    # the block reduction leaves out its last warp's partial sum
    ("norm_block_sum_drops_a_warp", _NORM_CU,
     "v = lane < nw ? red[lane] : 0.f;", "v = lane < nw - 1 ? red[lane] : 0.f;",
     tuple(f"{k}:{c}" for k in (_RMS, _LN) for c in ("block", "scalar"))),
]


# faults of the serving path's page pool, each run against the runs of
# _SERVE_FAULT_RUNS at two layers (``--serve-runs``): (name, source, text,
# replacement, the runs it may fail)
_POOL_PY = "paddle_tpu_torch/incubate/nn/paged_cache.py"
_SERVE_FAULT_RUNS = ("serve_prefix", "serve_prefix_int8", "serve_preempt")
SERVE_FAULTS = [
    # a copy-on-write fork hands the writer a page without its source's
    # bytes (and, in an int8 pool, with zeroed scale rows)
    ("fork_skips_copy", _POOL_PY, "        self._copy_page(dst, src)\n",
     "", ("serve_prefix", "serve_prefix_int8")),
    # swap_in writes the host copies of the private pages in reverse order
    ("swap_in_restores_reversed", _POOL_PY,
     "pg = torch.tensor(new_priv, dtype=torch.int64,",
     "pg = torch.tensor(new_priv[::-1], dtype=torch.int64,",
     ("serve_preempt",)),
]


# Faults in the generation path and the HF loader, each run through every
# run of GEN_RUN_NAMES at two layers (``--gen-runs``): (name, source,
# text, replacement, the runs it may fail)
_LLAMA_PY = "paddle_tpu_torch/models/llama.py"
_GENERATION_PY = "paddle_tpu_torch/models/generation.py"
_CONVERT_PY = "paddle_tpu_torch/models/convert.py"
GEN_FAULTS = [
    # the decode step writes the new tokens' K/V one slot late: each
    # token misses its own key and reads an empty slot
    ("decode_kv_one_slot_late", _LLAMA_PY,
     "        cache_k[:, step.pos:step.pos + s] = k\n"
     "        cache_v[:, step.pos:step.pos + s] = v\n",
     "        cache_k[:, step.pos + 1:step.pos + 1 + s] = k\n"
     "        cache_v[:, step.pos + 1:step.pos + 1 + s] = v\n",
     ("generate", "generate_beam", "spec_generate")),
    # beam search keeps the caches on their old lanes after a re-index
    ("beam_skips_cache_reindex", _GENERATION_PY,
     "            caches = [(ck.index_select(0, lane), cv.index_select(0, lane))"
     "\n                      for ck, cv in caches]\n", "",
     ("generate_beam",)),
    # after a full acceptance the draft never consumes its last proposal:
    # a hole in the draft cache every such round
    ("spec_draft_cache_hole", _GENERATION_PY,
     "d_next = base + min(draft_k - 1, n_acc) + 1",
     "d_next = base + min(draft_k, n_acc) + 1", ("spec_generate",)),
    # greedy acceptance counts every proposal that matches, not the
    # matching prefix: after a rejection in mid-window the rejected
    # proposal is committed (only a draft rejected in mid-window shows it)
    ("spec_accepts_past_a_rejection", _GENERATION_PY,
     "                n_acc = 0\n"
     "                while (n_acc < draft_k\n"
     "                       and proposal[n_acc] == preds[n_acc]):\n"
     "                    n_acc += 1\n"
     "                    if proposal[n_acc - 1] == eos_token_id:\n"
     "                        break\n",
     "                n_acc = sum(p == t for p, t in zip(proposal, preds))\n",
     ("spec_generate",)),
    # the loader leaves square 2-D weights (q_proj, o_proj) in HF's
    # [out, in] orientation
    ("hf_load_square_untransposed", _CONVERT_PY,
     'and "embed_tokens" not in name)',
     'and "embed_tokens" not in name\n'
     "                     and src.shape[0] != src.shape[1])",
     ("hf_load",)),
]


# faults of speculative serving in the scheduler, each run through the
# runs of _SPEC_FAULT_RUNS at four layers (``--serve-runs``; at four layers
# serve_spec_skip2's draft skips half the target's): (name, source, text,
# replacement, the runs it may fail, the run that must fail and the text of
# the gate that must fail it there)
_SERVING_PY = "paddle_tpu_torch/inference/serving.py"
_SPEC_FAULT_RUNS = ("serve_spec", "serve_spec_skip2", "serve_spec_spoiled")
SPEC_FAULTS = [
    # the rollback after a rejection keeps one token too many in both
    # pools: the stale K/V of the first rejected proposal stays, and every
    # later token of the row is written (and rotated) one position late
    # (a fully accepted window has no such token: truncate raises there)
    ("spec_rollback_one_token_long", _SERVING_PY,
     "            c.truncate(s, base_t + committed)\n"
     "        for c in self.draft.caches:\n"
     "            c.truncate(s, base_d + committed)\n",
     "            c.truncate(s, base_t + committed + 1)\n"
     "        for c in self.draft.caches:\n"
     "            c.truncate(s, base_d + committed + 1)\n",
     _SPEC_FAULT_RUNS, "serve_spec_skip2", "min cosine"),
    # acceptance counts every proposal that matches the target's argmax,
    # not the matching prefix: a rejected proposal commits
    ("spec_accepts_past_a_mismatch", _SERVING_PY,
     "        n_acc = 0\n"
     "        while n_acc < k and props_i[n_acc] == int(preds_i[n_acc]):\n"
     "            n_acc += 1\n"
     "            if req.eos_id is not None and props_i[n_acc - 1] == "
     "req.eos_id:\n"
     "                break\n",
     "        n_acc = sum(p == int(t) for p, t in zip(props_i, preds_i))\n",
     _SPEC_FAULT_RUNS, "serve_spec_spoiled", "not the target's argmax"),
]


# faults of the host planes, each run through _PLANE_FAULT_RUNS (the plane
# runs and the two runs they read) at two layers (``--serve-runs``):
# (name, source, text, replacement, the runs it may fail, the run that
# must fail and the text of the gate that must fail it there)
_FAULT_INJECTION_PY = "paddle_tpu_torch/incubate/nn/fault_injection.py"
_PLANE_FAULT_RUNS = ("serve", "serve_preempt", "serve_observed",
                     "serve_faults", "sanitizer_fuzz")
PLANE_FAULTS = [
    # the pool forks a shared page without journaling the fork: the
    # sanitizer sees a write land mid-page on a page that is not the
    # sequence's tail
    ("pool_fork_unjournaled", _POOL_PY,
     "                if self._san is not None:\n"
     "                    self._san.event(\"fork\", seq=s, src=int(src),\n"
     "                                    dst=int(tbl[-1]), pool=self)\n",
     "", ("sanitizer_fuzz",), "sanitizer_fuzz",
     "raised PageSanitizerError"),
    # the scheduler drops one counter increment: the decode tokens
    ("scheduler_drops_decode_counter", _SERVING_PY,
     '            m.inc("serving.decode_tokens", ev.get("decode_tokens", 0))'
     "\n", "", ("serve_observed",), "serve_observed",
     "counter serving.decode_tokens"),
    # the injector loses the last entry of its plan (a fail_step window)
    ("injector_skips_a_planned_fault", _FAULT_INJECTION_PY,
     "    plan.sort(key=lambda f: (f[\"start\"], f[\"kind\"]))\n"
     "    return plan\n",
     "    plan.sort(key=lambda f: (f[\"start\"], f[\"kind\"]))\n"
     "    return plan[:-1]\n", ("serve_faults",), "serve_faults",
     "fault log"),
]


def _run_with_fault(name, source, old, new, option, cases, phase,
                    extra=()):
    """Plants one fault in a copy of the repository in a temporary
    directory, runs the named cases there (a child process that builds
    the faulty kernels; ``extra``: more arguments) and returns the
    child's ``phase`` line. With ``source`` None the copy is left as it
    is."""
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="kernel_fault_")
    try:
        tree = os.path.join(tmp, "repo")
        shutil.copytree(root, tree, ignore=shutil.ignore_patterns(
            ".git", "_build", "__pycache__"))
        if source is not None:
            src = os.path.join(tree, source)
            with open(src) as f:
                text = f.read()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace occurs "
                                   f"{text.count(old)} times")
            with open(src, "w") as f:
                f.write(text.replace(old, new))
        child = subprocess.run(
            [sys.executable, os.path.join(tree, "chip_smoke.py"), option,
             ",".join(cases), *extra],
            cwd=tree, capture_output=True, text=True, timeout=900)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = next((json.loads(s) for s in child.stdout.splitlines()
                 if s.startswith(f'{{"phase": "{phase}"')), None)
    if line is None:
        raise RuntimeError(f"{name}: the child printed no result "
                           f"(exit {child.returncode}):\n"
                           f"{child.stderr[-2000:]}")
    return line


def fault_check_phase():
    """Plants each fault of FLASH_FAULTS, PAGED_FAULTS, NORM_FAULTS,
    SERVE_FAULTS, SPEC_FAULTS, PLANE_FAULTS and GEN_FAULTS in a copy of
    the repository and runs its cases there; fails unless every fault
    fails a gate, a paged, norm, serving or generation fault only in the
    cases it may fail, and a speculative serving or host-plane fault in
    its named run at its named gate."""
    results, missed = [], []
    for name, source, old, new, cases in FLASH_FAULTS:
        line = _run_with_fault(name, source, old, new, "--flash-cases",
                               cases, "flash_cases")
        results.append({"fault": name, "failed": line["failed"],
                        "rel_l2_err": {
                            f"{k['name']}:{c['case']}": c["rel_l2_err"]
                            for k in line["kernels"] for c in k["cases"]}})
        if not line["failed"]:
            missed.append(name)
    for name, source, old, new, broken in PAGED_FAULTS:
        line = _run_with_fault(name, source, old, new, "--attn-cases",
                               _PAGED_FAULT_CASES, "attn_cases")
        results.append({"fault": name, "may_fail": list(broken),
                        "failed": line["failed"],
                        "max_abs_err": {
                            f"{k['name']}:{c['case']}": c["max_abs_err"]
                            for k in line["kernels"] for c in k["cases"]}})
        if not line["failed"] or any(
                f not in broken and f.split(":")[0] not in broken
                for f in line["failed"]):
            missed.append(name)
    norm_names = [name for _, name, _ in NORM_CASES]
    for name, source, old, new, broken in NORM_FAULTS:
        line = _run_with_fault(name, source, old, new, "--norm-cases",
                               norm_names, "norm_cases")
        kind = {f"{k['name']}:{c['case']}": f"{k['name']}:{c['plan']['kind']}"
                for k in line["kernels"] for c in k["cases"]}
        results.append({"fault": name, "may_fail": list(broken),
                        "failed": line["failed"],
                        "max_abs_err": {
                            f"{k['name']}:{c['case']}": c["max_abs_err"]
                            for k in line["kernels"] for c in k["cases"]}})
        if not line["failed"] or any(kind[f] not in broken
                                     for f in line["failed"]):
            missed.append(name)
    for name, source, old, new, broken in SERVE_FAULTS:
        line = _run_with_fault(name, source, old, new, "--serve-runs",
                               _SERVE_FAULT_RUNS, "serve_runs",
                               extra=("--layers", "2"))
        results.append({"fault": name, "may_fail": list(broken),
                        "failed": line["failed"], "errors": line["errors"]})
        if not line["failed"] or set(line["failed"]) - set(broken):
            missed.append(name)
    for name, source, old, new, broken, must, gate, runs, depth in (
            [(*f, _SPEC_FAULT_RUNS, "4") for f in SPEC_FAULTS]
            + [(*f, _PLANE_FAULT_RUNS, "2") for f in PLANE_FAULTS]):
        line = _run_with_fault(name, source, old, new, "--serve-runs",
                               runs, "serve_runs",
                               extra=("--layers", depth))
        results.append({"fault": name, "may_fail": list(broken),
                        "must_fail": must, "gate": gate,
                        "failed": line["failed"], "errors": line["errors"]})
        caught = any(e["run"] == must and gate in e["error"]
                     for e in line["errors"])
        if not caught or set(line["failed"]) - set(broken):
            missed.append(name)
    for name, source, old, new, broken in GEN_FAULTS:
        line = _run_with_fault(name, source, old, new, "--gen-runs",
                               GEN_RUN_NAMES, "gen_runs",
                               extra=("--layers", "2"))
        results.append({"fault": name, "may_fail": list(broken),
                        "failed": line["failed"], "errors": line["errors"]})
        if not line["failed"] or set(line["failed"]) - set(broken):
            missed.append(name)
    emit("fault_check", tolerance=FLASH_TOL, faults=results, missed=missed)
    if missed:
        raise RuntimeError(f"planted faults pass the gates, or fail a "
                           f"kernel they did not break: {missed}")


# Design choices that --ablations undoes, one at a time, in a copy of the
# repository, timing the named cases there beside an unchanged copy run
# the same way: (name, the CUDA source, its text, the replacement, the
# flash and varlen cases to time).
ABLATIONS = [
    # the varlen dK/dV blocks take their key tiles in pack order instead
    # of ranked by work
    ("varlen_dkdv_tiles_in_pack_order", _VARLEN_CU,
     "const int rank_tiles = ntiles <= kOrderMax && ntiles * p.KVH > sms;",
     "const int rank_tiles = 0;", ("varlen_train", "varlen_noncausal")),
    # the varlen dQ kernel with at most two consumer warpgroups a block
    ("varlen_dq_two_warpgroups", _VARLEN_CU,
     "if (nwg == 3) return launch_dq_wgmma<D, 3>(",
     "if (nwg == 3) return launch_dq_wgmma<D, 2>(",
     ("varlen_train", "varlen_tile_edges")),
    # the dense dQ kernel the same way (only `train` fills 132 SMs with
    # three)
    ("dq_two_warpgroups", _FLASH_CU,
     "if (nwg == 3) return launch_dq_wgmma<D, 3>(",
     "if (nwg == 3) return launch_dq_wgmma<D, 2>(", ("train",)),
    # the varlen forward's M tiles in pack order instead of last to first
    ("varlen_fwd_m_tiles_in_pack_order", _VARLEN_CU,
     "const int mt = gridDim.y - 1 - blockIdx.y;", "const int mt = blockIdx.y;",
     ("varlen_train", "varlen_8k")),
    # bf16 rows widened once and kept in float32 (the compiler's choice)
    # instead of widened at each use from the packed vectors
    ("norm_rows_kept_in_float32", _NORM_CU,
     "constexpr bool kWidenAtUse = true;", "constexpr bool kWidenAtUse = false;",
     ("rows16384", "rows256", "rows16384_h768", "rows16384_h1024")),
    # the norms' weight and bias loaded after the reductions (per row)
    # instead of beside x
    ("norm_weight_after_reduction", _NORM_CU,
     "constexpr bool kWeightFirst = true;",
     "constexpr bool kWeightFirst = false;",
     ("rows16384", "rows256", "rows8", "rows16384_h768")),
    # the warp class on a grid of 528 blocks (4 resident a SM of the H100
    # at 56-71 registers a thread) walking rows grid-stride, each warp
    # keeping the weight in registers across its rows, instead of one row
    # a warp
    ("norm_warp_rows_grid_stride", _NORM_CU,
     "const unsigned grid = (unsigned)blocks;",
     "const unsigned grid = (unsigned)(blocks < 528 ? blocks : 528);",
     ("rows16384", "rows2048", "rows16384_h768", "rows2048_h1000")),
]


def _cases_option(cases):
    """The option and phase line of the narrow run that holds ``cases``:
    the norm cases', or the flash and varlen cases'."""
    if set(cases) <= {name for _, name, _ in NORM_CASES}:
        return "--norm-cases", "norm_cases"
    return "--flash-cases", "flash_cases"


def ablations_phase(names=None):
    """Runs the cases of each ablation of ABLATIONS (those in ``names``
    when given) in a copy with the change and in an unchanged copy, in
    turns (unchanged, ablated, ablated, unchanged), and emits every
    kernel's times in both."""
    results = []
    for name, source, old, new, cases in ABLATIONS:
        if names is not None and name not in names:
            continue
        option, phase = _cases_option(cases)
        runs = [_run_with_fault(name, src, old, new, option, cases, phase)
                for src in (None, source, source, None)]
        times = {}
        for which, line in zip(("base", "ablated", "ablated", "base"),
                               runs):
            for k in line["kernels"]:
                for c in k["cases"]:
                    times.setdefault(f"{k['name']}:{c['case']}", {}) \
                        .setdefault(which, []).append(c["kernel_ms"])
        results.append({"ablation": name, "kernel_ms": times,
                        "failed": sorted({f for line in runs
                                          for f in line["failed"]})})
    emit("ablations", ablations=results)


def kernels_phase():
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    # bring the card out of idle clocks before the first timed case
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
    del a
    norm = norm_cases(flush)
    attn = attn_cases(flush)
    fused = [fused_step_case(flush)]
    flash = flash_cases(flush)
    varlen = varlen_cases(flush)
    del flush
    cases = {**norm, **attn,
             "paged_ragged_fused_step": fused, **flash, **varlen}
    bad = [f"{name}:{c['case']}" for name, cs in cases.items() for c in cs
           if not c["ok"]]
    emit("kernels", failed=bad, kernels=[
        {"name": name, "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "cases": cs}
        for name, cs in cases.items()])
    if bad:
        raise RuntimeError(f"kernel cases disagree with their plain "
                           f"versions: {bad}")
    return cases


# ----------------------------------------------------------------- varlen
def varlen_phase(seed):
    """The packed-attention path: the public ``flash_attn_unpadded`` at
    Qwen2-0.5B's attention width (14 q and 2 kv heads of 64, bf16,
    causal) on one pack of the train cell's 8 x 2048 token budget
    (``pack_lengths(seed)``), forward and backward through autograd. The
    launch counters are reset just before one forward + backward and read
    just after; out, dq, dk and dv are held against the plain
    segment-by-segment version. Also times PR 2's dense kernels on the
    same documents padded to the longest, as a reference point."""
    import torch
    from paddle_tpu_torch.nn.functional import (flash_attention,
                                                flash_attn_unpadded)
    from paddle_tpu_torch.ops.kernels import flash_varlen as fv
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats

    h, kvh, d = 14, 2, 64
    lens = pack_lengths(seed)
    t = sum(lens)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = rnd(t, h, d), rnd(t, kvh, d), rnd(t, kvh, d), rnd(t, h, d)
    cu = torch.tensor(_cu(lens), dtype=torch.int32, device="cuda")
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def fwd_bwd():
        out, _ = flash_attn_unpadded(*leaves, cu, cu, max(lens), max(lens),
                                     causal=True)
        return (out,) + torch.autograd.grad(out, leaves, do)

    torch.cuda.synchronize()
    kernel_launch_stats(reset=True)
    got = [x.detach() for x in fwd_bwd()]
    torch.cuda.synchronize()
    launches = kernel_launch_stats(reset=True)
    # out against the plain forward; the gradients against the plain
    # backward from the path's own forward (its out, and its lse from one
    # more forward launch after the counters were read), as the kernels
    # phase feeds both versions the same forward: a bf16 out enters delta,
    # and on a row with few keys dp - delta cancels, so gradients from two
    # forwards differ there by that rounding, not by the kernels
    scale = d ** -0.5
    ref_out, _ = fv.flash_varlen_fwd_plain(q, k, v, cu, cu, True, scale)
    _, lse = fv.flash_varlen_fwd(q, k, v, cu, cu, True, scale)
    bwd = (q, k, v, do, lse, fv._delta(do, got[0]), cu, cu, True, scale)
    ref = (ref_out, fv.flash_varlen_bwd_dq_plain(*bwd),
           *fv.flash_varlen_bwd_dkdv_plain(*bwd))
    tol = FLASH_TOL["bfloat16"]
    rel = {n: rel_l2_errors(a, r) for n, a, r in
           zip(("out", "dq", "dk", "dv"), got, ref)}
    problems = [f"{n}: relative L2 {e} over the {w} above {tol[w]}"
                for n, e2 in rel.items()
                for e, w in zip(e2, ("tensor", "row")) if e > tol[w]]
    problems += [f"{n} launches {launches.get(n, 0)} != 1" for n in VARLEN
                 if launches.get(n, 0) != 1]
    problems += [f"{n} launched on the varlen path" for n in launches
                 if n not in VARLEN]
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: flash_attn_unpadded(
            q, k, v, cu, cu, causal=True))
    fwd_bwd_ms = cuda_time_ms(fwd_bwd)

    # PR 2's dense kernels on the same documents padded to the longest
    s_max = max(lens)
    pad = [torch.zeros(len(lens), s_max, x.shape[1], d, dtype=x.dtype,
                       device="cuda") for x in (q, k, v, do)]
    for i, (a, b) in enumerate(zip(_cu(lens), _cu(lens)[1:])):
        for dst, src in zip(pad, (q, k, v, do)):
            dst[i, :b - a] = src[a:b]
    dense = [x.requires_grad_() for x in pad[:3]]

    def dense_fwd_bwd():
        out, _ = flash_attention(*dense, causal=True)
        return torch.autograd.grad(out, dense, pad[3])

    with torch.no_grad():
        dense_fwd_ms = cuda_time_ms(lambda: flash_attention(
            *pad[:3], causal=True))
    dense_fwd_bwd_ms = cuda_time_ms(dense_fwd_bwd)
    pairs, _ = varlen_work(_cu(lens), _cu(lens), t, t, h, kvh, d, True, 2)
    emit("varlen", api="paddle_tpu_torch.nn.functional.flash_attn_unpadded",
         heads=h, kv_heads=kvh, head_dim=d, dtype="bfloat16", causal=True,
         tokens=t, documents=lens, kept_pairs=pairs,
         dense_padded_pairs=len(lens) * h * s_max * (s_max + 1) // 2,
         fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms,
         dense_padded_shape=[len(lens), s_max, h, d],
         dense_padded_fwd_ms=dense_fwd_ms,
         dense_padded_fwd_bwd_ms=dense_fwd_bwd_ms,
         rel_l2_err=rel, tolerance=tol, launches=launches,
         problems=problems)
    if problems:
        raise RuntimeError("varlen phase failed: " + "; ".join(problems))
    return launches


def layer_norm_phase():
    """The LayerNorm path: ``layer_norm_fused`` forward and backward
    through autograd at [16384, 768] bf16 (GPT-2 / BERT-base width) with
    weight and bias, the launch counters reset just before and read just
    after one forward + backward."""
    import torch
    from paddle_tpu_torch.ops.kernels import (kernel_launch_stats,
                                              layer_norm_fused,
                                              layer_norm_plain)
    from paddle_tpu_torch.ops.kernels.rms_norm import layer_norm_bwd

    n, h = 16384, 768
    g = torch.Generator(device="cuda").manual_seed(11)
    x = (0.3 + 1.5 * torch.randn(n, h, generator=g, device="cuda")).to(
        torch.bfloat16).requires_grad_()
    w = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(
        torch.bfloat16).requires_grad_()
    b = (0.1 * torch.randn(h, generator=g, device="cuda")).to(
        torch.bfloat16).requires_grad_()
    dy = torch.randn(n, h, generator=g, device="cuda").to(torch.bfloat16)

    def fwd_bwd():
        y = layer_norm_fused(x, w, b)
        return (y,) + torch.autograd.grad(y, (x, w, b), dy)

    torch.cuda.synchronize()
    kernel_launch_stats(reset=True)
    y, dx, dw, db = fwd_bwd()
    torch.cuda.synchronize()
    launches = kernel_launch_stats(reset=True)
    problems = []
    if not within_tolerance(y, layer_norm_plain(x, w, b)):
        problems.append("the output is outside the tolerance")
    want = layer_norm_bwd(x, w, b, dy, 1e-5)
    if not all(torch.equal(a, r) for a, r in zip((dx, dw, db), want)):
        problems.append("the gradients differ from layer_norm_bwd")
    if launches != {"layer_norm_fused": 1}:
        problems.append(f"launches {launches} != one layer_norm_fused")
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: layer_norm_fused(x, w, b))
    emit("layer_norm", shape=[n, h], dtype="bfloat16",
         fwd_ms=fwd_ms, fwd_bwd_ms=cuda_time_ms(fwd_bwd),
         launches=launches, problems=problems)
    if problems:
        raise RuntimeError("layer_norm phase failed: " + "; ".join(problems))
    return launches


# ------------------------------------------------------------------ serve
# the serving runs, all on one model and one traffic: (run, KV pages,
# FLAGS_ragged_attention). serve_int8 and serve_off_int8 size their int8
# pool by serve's pool bytes; serve_off keeps serve's 512 bf16 pages.
SERVE_RUNS = [("serve", None, "auto"), ("serve_int8", "int8", "auto"),
              ("serve_off", None, "off"), ("serve_off_int8", "int8", "off")]
SERVE_PAGES = 512
# serving runs served again under the profiler: run -> its phase name
# (serve_off: the decode kernel's device time on its path)
PROFILED_RUNS = {"serve": "profile", "serve_int8": "profile_int8",
                 "serve_off": "profile_off",
                 "serve_off_int8": "profile_off_int8"}


def build_server(seed, layers):
    """Llama-3-8B's published shape (random bf16 weights from ``seed``;
    ``layers`` cuts its depth, never its width) and the serve traffic's
    8 prompts: lengths uniform in 64-1024 from ``seed``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b

    cfg = llama3_8b() if layers is None else llama3_8b(
        num_hidden_layers=layers)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    prompt_lens = rng.randint(64, 1025, size=8).tolist()
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in prompt_lens]
    return model, prompts, init_s


def record_prefill_chunk(adapter, watch, preds=None):
    """Wraps ``adapter.prefill_chunk`` (an instance attribute: ``del
    adapter.prefill_chunk`` restores the method) to keep the served
    logits of the ``watch`` requests by absolute position, and to count
    the model calls that carry a single-token (decode) row, a
    multi-token (prefill) row and ``logits_rows`` (speculative verify
    rows, whose logits are kept at every position of the row). A later
    call's logits at a position replace an earlier one's (a verify window
    starts at the last committed token). ``preds``: a dict that gets
    every row's argmax, ``preds[request][position]``. Returns
    ``(captured, row_kinds)``."""
    captured = {w: {} for w in watch}
    row_kinds = {"calls": 0, "single": 0, "multi": 0, "logits_rows": 0}
    serve_fn = adapter.prefill_chunk

    def recording_prefill_chunk(token_ids, seq_ids, start_positions=None,
                                pad_to=None, logits_rows=None):
        out = serve_fn(token_ids, seq_ids, start_positions,
                       pad_to=pad_to, logits_rows=logits_rows)
        row_kinds["calls"] += 1
        row_kinds["single"] += any(len(t) == 1 for t in token_ids)
        row_kinds["multi"] += any(len(t) > 1 for t in token_ids)
        last, full = (out, None) if logits_rows is None else out
        row_kinds["logits_rows"] += logits_rows is not None
        # row -> (the position of its first kept logits row, the rows)
        rows, off = {}, 0
        for i in logits_rows or ():
            n = len(token_ids[i])
            rows[i] = (int(start_positions[i]), full[off:off + n])
            off += n
        for i, s in enumerate(seq_ids):
            p0, lg = rows.get(i, (int(start_positions[i])
                                  + len(token_ids[i]) - 1, last[i:i + 1]))
            if s in captured:
                for j in range(lg.shape[0]):
                    captured[s][p0 + j] = lg[j].float()
            if preds is not None:
                got = preds.setdefault(s, {})
                for j, t in enumerate(lg.float().argmax(-1).tolist()):
                    got[p0 + j] = t
        return out

    adapter.prefill_chunk = recording_prefill_chunk
    return captured, row_kinds


def launch_problems(launches, adapter, calls, row_kinds, mode):
    """Exact launch counts of a serving run of ``calls`` model calls:
    one RMSNorm per layer norm and the final one per call; under
    auto/on one ragged launch per layer and call; under off one decode
    launch per layer and call with a decode row, one ragged launch per
    layer and call with a multi-token row. Also the attention kinds the
    adapter ran. Returns ``(problems, kinds)``."""
    n_layers = len(adapter.caches)
    want = {"rms_norm": (2 * n_layers + 1) * calls}
    if mode == "off":
        want["paged_decode_attention"] = n_layers * row_kinds["single"]
        want["paged_ragged_attention"] = n_layers * row_kinds["multi"]
    else:
        want["paged_ragged_attention"] = n_layers * calls
        want["paged_decode_attention"] = 0
    problems = [f"{k} launches {launches.get(k, 0)} != {v}"
                for k, v in want.items() if launches.get(k, 0) != v]
    kinds = sorted(set().union(*map(set, adapter.attend_kinds_by_bucket
                                    .values())))
    want_kinds = {"off": ["decode", "prefill"], "on": ["ragged"],
                  "auto": ["ragged"] if adapter.caches[0].quantized
                  else ["ragged_fused"]}[mode]
    if kinds != want_kinds:
        problems.append(f"attention kinds {kinds} != {want_kinds}")
    return problems, kinds


def oracle_check(model, done, captured, watch, gate, problems):
    """Teacher-forced dense float32 forward over each watched request's
    prompt + the generated tokens that were fed back; its logits at each
    sampled position against the served ones, cosine >= ``gate``.
    Appends to ``problems``; returns the per-request readings."""
    import torch
    from paddle_tpu_torch.testing import dense_reference_logits

    oracle = {}
    for rid in sorted(watch):
        r = done[rid]
        seq = r.prompt_ids + r.generated_ids[:-1]
        # positions whose logits sampled a token: the prompt's last one
        # and every decode row (mid-prompt chunk ends sample nothing)
        positions = sorted(p for p in captured[rid]
                           if p >= len(r.prompt_ids) - 1)
        want_pos = list(range(len(r.prompt_ids) - 1, len(seq)))
        if positions != want_pos:
            problems.append(f"{rid}: captured positions {positions[:3]}.. "
                            f"!= sampled positions {want_pos[:3]}..")
            continue
        ref = dense_reference_logits(model, seq, positions=positions)[0]
        served = torch.stack([captured[rid][p] for p in positions])
        cos = torch.nn.functional.cosine_similarity(served, ref, dim=-1)
        s_top, r_top = served.argmax(-1), ref.argmax(-1)
        top1 = (s_top == r_top).float().mean()
        # for each top-1 miss: how far the oracle ranks the served token
        # below its own top-1 (a near-tie when small)
        miss = (s_top != r_top).nonzero().flatten()
        margins = (ref[miss, r_top[miss]] - ref[miss, s_top[miss]]
                   if miss.numel() else torch.zeros(1, device=ref.device))
        oracle[rid] = {"positions": len(positions),
                       "min_cosine": float(cos.min()),
                       "mean_cosine": float(cos.mean()),
                       "top1_agreement": float(top1),
                       "top1_miss_max_oracle_margin": float(margins.max()),
                       "max_abs_logit_err": float(
                           (served - ref).abs().max()),
                       "max_abs_logit": float(ref.abs().max())}
        if float(cos.min()) < gate:
            problems.append(f"{rid}: min cosine {float(cos.min()):.6f} "
                            f"< {gate}")
    return oracle


def serve_run(run, model, prompts, init_s, layers, kv_cache_dtype, mode,
              pool_bytes=None, base=None, observe=None):
    """Serves the 8 prompts (32 new tokens each, greedy,
    ``max_batch_size=8``, ``prefill_chunk_tokens=248``) through
    ``BatchScheduler`` -> ``PagedLlamaAdapter`` -> the paged KV pool
    under ``FLAGS_ragged_attention=mode``, with the kernel launch
    counters reset just before and read just after; checks the launch
    counts and holds the served logits of two requests against the dense
    float32 oracle (``paddle_tpu_torch.testing.dense_reference_logits``).
    ``pool_bytes`` sizes the pool by bytes (else 512 pages); ``base``,
    the ``serve`` run's result, is what top-1 agreement and the pool
    ratio are read against. ``observe`` (:class:`ObservedPlanes`) reads
    the host planes: its ``start(sched)`` runs just before the measured
    steps, its ``finish(...)`` just after, returning more fields of the
    run's line and more problems. Emits the run's line; returns
    ``(launches, adapter, result)``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import (BatchScheduler,
                                            PagedLlamaAdapter, Request)
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats

    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    if pool_bytes is None:
        adapter = PagedLlamaAdapter(model, num_pages=SERVE_PAGES,
                                    page_size=16,
                                    kv_cache_dtype=kv_cache_dtype)
    else:
        adapter = PagedLlamaAdapter(model, page_size=16,
                                    kv_cache_dtype=kv_cache_dtype,
                                    page_pool_bytes=pool_bytes)
    prompt_lens = [len(p) for p in prompts]
    watch = {"r0", "r1"}
    captured, row_kinds = record_prefill_chunk(adapter, watch)
    with ragged_mode(mode):
        # warm-up: one short request (cuBLAS handles, GEMM heuristics)
        warm = BatchScheduler(adapter, max_batch_size=8,
                              prefill_chunk_tokens=248)
        warm.submit(Request("warm", prompts[0][:16], max_new_tokens=2))
        warm.run_until_complete()

        sched = BatchScheduler(adapter, max_batch_size=8,
                               prefill_chunk_tokens=248)
        # host clock of every generated token (the scheduler reads each
        # step's logits back to the host before it commits a token, so
        # this is when the token existed for a client)
        tok_times = {}

        def on_token(req, tok, is_prompt):
            if not is_prompt:
                tok_times.setdefault(req.req_id, []).append(
                    time.perf_counter())

        for i, p in enumerate(prompts):
            sched.submit(Request(f"r{i}", p, max_new_tokens=32,
                                 on_token=on_token))
        calls0 = adapter.chunk_stats["calls"]
        for k in row_kinds:
            row_kinds[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps, events = [], []
        if observe is not None:
            observe.start(sched)
        kernel_launch_stats(reset=True)
        t0 = time.perf_counter()
        while sched.num_active or sched.num_queued:
            ts = time.perf_counter()
            ev = sched.step()
            steps.append({"ms": (time.perf_counter() - ts) * 1e3,
                          "prefill": ev["prefill_tokens"],
                          "decode": ev["decode_tokens"]})
            events.append(ev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launch_stats(reset=True)
        # the measured run's calls, before an observer serves more
        calls = adapter.chunk_stats["calls"] - calls0
        row_kinds = dict(row_kinds)
        observed, obs_problems = ({}, []) if observe is None else \
            observe.finish(sched, adapter, events, prompts)
    # back to the class's method: an instance attribute holding the
    # adapter's own bound method is a reference cycle that would keep a
    # finished run's pool alive until the next garbage collection
    del adapter.prefill_chunk
    done = {r: sched.result(r) for r in (f"r{i}" for i in range(8))}
    ttft = sorted((v[0] - t0) * 1e3 for v in tok_times.values())
    tpot = sorted((b - a) * 1e3 for v in tok_times.values()
                  for a, b in zip(v, v[1:]))
    gen = sum(len(r.generated_ids) for r in done.values())
    total = gen + sum(prompt_lens)
    peak = torch.cuda.max_memory_allocated()
    n_layers = cfg.num_hidden_layers
    pool = adapter.caches[0]
    problems, kinds = launch_problems(launches, adapter, calls, row_kinds,
                                      mode)
    if kv_cache_dtype == "int8" and pool.k_pages.dtype != torch.int8:
        problems.append(f"pool pages are {pool.k_pages.dtype}, not int8")
    if any(len(r.generated_ids) != 32 for r in done.values()):
        problems.append("a request did not generate 32 tokens")
    gate = COSINE_GATE if kv_cache_dtype is None else INT8_COSINE_GATE
    oracle = oracle_check(model, done, captured, watch, gate, problems)
    streams = {r: d.generated_ids for r, d in done.items()}
    vs_serve = None
    step_ms_mean = float(np.mean([s["ms"] for s in steps]))
    if base is not None:
        same = [a == b for r in streams
                for a, b in zip(streams[r], base["streams"][r])]
        vs_serve = {"same_token_share": sum(same) / len(same),
                    "identical_requests": sum(
                        streams[r] == base["streams"][r] for r in streams),
                    "pool_pages_ratio": pool.num_pages / base["num_pages"],
                    "total_tok_per_s_ratio": (total / wall)
                    / base["total_tok_per_s"],
                    "step_ms_mean_added": step_ms_mean
                    - base["step_ms_mean"]}
    if observe is not None:
        problems += obs_problems
        if launches != base["launches"]:
            problems.append(f"launches {launches} != serve's "
                            f"{base['launches']}")
        if streams != base["streams"]:
            problems.append("generated tokens differ from serve's")
    emit(run, model="llama3_8b", layers=n_layers,
         depth_cut=None if layers is None else
         f"{layers} of 32 layers (--layers)",
         hidden=cfg.hidden_size, intermediate=cfg.intermediate_size,
         heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
         vocab=cfg.vocab_size, params=n_params, dtype="bfloat16",
         kv_cache_dtype=kv_cache_dtype or "bfloat16",
         ragged_attention=mode, init_s=init_s, num_pages=pool.num_pages,
         page_size=16, page_pool_bytes=pool_bytes,
         kv_pool_bytes=sum(c.pool_nbytes for c in adapter.caches),
         max_batch_size=8, prefill_chunk_tokens=248,
         prompt_lens=prompt_lens, new_tokens=32, steps=len(steps),
         model_calls=calls, calls_with_decode_rows=row_kinds["single"],
         calls_with_prefill_rows=row_kinds["multi"], wall_s=wall,
         generated_tok_per_s=gen / wall, total_tok_per_s=total / wall,
         generated_tokens=gen, prompt_tokens=sum(prompt_lens),
         max_memory_allocated=peak, launches=launches,
         attention_kinds=kinds,
         ttft_ms={"median": float(np.median(ttft)), "max": ttft[-1],
                  "n": len(ttft)},
         tpot_ms={"median": float(np.median(tpot)),
                  "p90": float(np.percentile(tpot, 90)), "n": len(tpot)},
         packed_tokens=sched.chunk_stats["packed_tokens"],
         padded_tokens=sched.chunk_stats["padded_tokens"],
         step_ms=[round(s["ms"], 3) for s in steps],
         step_tokens=[[s["prefill"], s["decode"]] for s in steps],
         oracle=oracle, cosine_gate=gate, versus_serve=vs_serve,
         step_ms_mean=step_ms_mean, **observed, problems=problems)
    if problems:
        raise RuntimeError(f"{run} phase failed: " + "; ".join(problems))
    return launches, adapter, {"streams": streams,
                               "num_pages": pool.num_pages,
                               "kv_pool_bytes": sum(
                                   c.pool_nbytes for c in adapter.caches),
                               "launches": launches,
                               "total_tok_per_s": total / wall,
                               "step_ms_mean": step_ms_mean}


def serve_pool_bytes(model):
    """The bytes of ``serve``'s pool (SERVE_PAGES bf16 pages of 16 a
    layer): what the int8 runs size their pools by."""
    import torch
    from paddle_tpu_torch.incubate.nn import PagedKVCacheManager

    cfg = model.config
    return SERVE_PAGES * cfg.num_hidden_layers * PagedKVCacheManager \
        .page_bytes(16, cfg.num_key_value_heads, cfg.head_dim,
                    dtype=torch.bfloat16)


# ------------------------------------------------------------ host planes

# every host plane on: the flags serve_observed sets (the incident and
# export paths go into a temporary directory)
OBSERVED_FLAGS = {
    "telemetry": "trace",
    "telemetry_slo": "ttft_p99_s=2,tpot_p99_s=0.2",
    "telemetry_watchdog": "warn", "telemetry_watchdog_stride": 8,
    "page_sanitizer": "strict", "concurrency_sanitizer": "strict"}
# serve_faults: every fault kind over serve_preempt's traffic. The delay
# window covers the storm's step, so the victims stay out (the storm's
# own admission pass would restore them at once)
SERVE_FAULT_PLAN = ("exhaust@4+3,preempt_storm@8:2,delay_swap_in@8+4,"
                    "fail_step@14+3")
# what the injector must log over that traffic, in order: (kind, step).
# exhaust consults admission every step of its window; the storm fires
# once; delay_swap_in is consulted while victims are swapped out; the
# third step of the fail window is a back-off step (0, then 1 skipped)
SERVE_FAULT_LOG = ([("exhaust", s) for s in (4, 5, 6)]
                   + [("preempt_storm", 8)]
                   + [("delay_swap_in", s) for s in (8, 9, 10, 11)]
                   + [("fail_step", s) for s in (14, 15)])
FAULT_RUN_FLAGS = {"telemetry": "metrics", "telemetry_watchdog": "warn",
                   "telemetry_watchdog_stride": 8,
                   "page_sanitizer": "strict",
                   "serving_faults": SERVE_FAULT_PLAN}


@contextlib.contextmanager
def port_flags(values):
    """The port's flags set for a block (fresh telemetry registry and
    concurrency sanitizer on entry and exit), restored after."""
    from paddle_tpu_torch.framework import concurrency, telemetry
    from paddle_tpu_torch.framework.flags import flag, set_flags

    old = {k: flag(k) for k in values}
    set_flags(values)
    telemetry.reset()
    concurrency.reset()
    try:
        yield
    finally:
        set_flags(old)
        telemetry.reset()
        concurrency.reset()


def _prometheus_problems(path):
    """The Prometheus text file parses: every line a comment or
    ``name[{labels}] value`` with a float value, optionally followed by
    an OpenMetrics exemplar ``# {labels} value``."""
    import re

    pat = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (\S+)'
                     r'( # \{[^}]*\} \S+)?$')
    try:
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln]
    except OSError as e:
        return [f"Prometheus export unreadable: {e}"], 0
    bad = 0
    for ln in lines:
        if ln.startswith("#"):
            continue
        m = pat.match(ln)
        try:
            float(m.group(2)) if m else float("x")
        except ValueError:
            bad += 1
    samples = sum(1 for ln in lines if not ln.startswith("#"))
    problems = [f"{bad} Prometheus lines do not parse"] if bad else []
    if not any(ln.startswith("paddle_serving_steps") for ln in lines):
        problems.append("Prometheus export has no serving_steps series")
    return problems, samples


class PlaneTimer:
    """Exclusive host seconds spent in each host plane's code during a
    run: the listed methods are wrapped (``install``) and restored
    (``remove``); a plane's call inside another's (a registry write
    journaled by the concurrency sanitizer) counts for the inner one."""

    # (plane, module, class, methods)
    SITES = (
        ("page_sanitizer", "paddle_tpu_torch.incubate.nn.page_sanitizer",
         "PageSanitizer", ("event", "verify_pages")),
        ("concurrency_sanitizer", "paddle_tpu_torch.framework.concurrency",
         "ConcurrencySanitizer", ("_event_locked",)),
        ("concurrency_sanitizer", "paddle_tpu_torch.framework.concurrency",
         "GuardedLock", ("acquire", "release")),
        ("concurrency_sanitizer", "paddle_tpu_torch.framework.concurrency",
         "SharedVar", ("read", "write")),
        ("telemetry", "paddle_tpu_torch.framework.telemetry",
         "MetricsRegistry", ("inc", "gauge", "observe", "advance_epoch",
                             "snapshot", "hist_windowed")),
        ("telemetry", "paddle_tpu_torch.framework.telemetry", "_SpanCtx",
         ("__enter__", "__exit__")),
        ("telemetry", "paddle_tpu_torch.framework.telemetry", "_CtxSpan",
         ("__enter__", "__exit__")),
        ("telemetry", "paddle_tpu_torch.framework.telemetry",
         "RequestTraceBook", ("begin", "event", "complete")),
        ("telemetry", "paddle_tpu_torch.inference.serving",
         "BatchScheduler", ("_observability_epoch", "_sanitizer_epoch",
                            "_note_gen_token", "_tag_pool_trace")),
    )

    def __init__(self):
        import collections

        self.seconds = collections.Counter()
        self._stack = []
        self._saved = []

    def _wrap(self, plane, fn):
        timer = self

        def timed(*a, **kw):
            now = time.perf_counter()
            if timer._stack:
                outer = timer._stack[-1]
                timer.seconds[outer[0]] += now - outer[1]
            timer._stack.append([plane, now])
            try:
                return fn(*a, **kw)
            finally:
                end = time.perf_counter()
                p, t0 = timer._stack.pop()
                timer.seconds[p] += end - t0
                if timer._stack:
                    timer._stack[-1][1] = end
        return timed

    def install(self):
        import importlib

        for plane, mod, cls, methods in self.SITES:
            owner = getattr(importlib.import_module(mod), cls)
            for m in methods:
                fn = owner.__dict__[m]
                self._saved.append((owner, m, fn))
                setattr(owner, m, self._wrap(plane, fn))

    def remove(self):
        for owner, m, fn in reversed(self._saved):
            setattr(owner, m, fn)
        self._saved = []


class ObservedPlanes:
    """The host planes' reading of one ``serve_run`` (``serve_observed``):
    every plane on (``OBSERVED_FLAGS``, incident and export paths in
    ``tmp``). ``start`` takes the registry's counters just before the
    measured steps; ``finish`` reads the planes just after: the serving
    counters against the step events (deltas over the measured steps:
    the warm-up scheduler shares the registry), the request traces, the
    span ring and its Chrome export, the Prometheus export, both
    sanitizers, an explicit incident bundle read back, one bundle per
    watchdog fire, and the performance ledger's rows (after a short
    token-per-step tail run, which stamps ``decode_token``)."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.flags = dict(OBSERVED_FLAGS,
                          telemetry_incident_dir=os.path.join(tmp, "inc"),
                          telemetry_export_path=os.path.join(tmp, "m.prom"))

    def start(self, sched):
        from paddle_tpu_torch.framework import telemetry

        self.c0 = telemetry.registry().snapshot()
        self.t_run = telemetry.clock()

    def finish(self, sched, adapter, events, prompts):
        from paddle_tpu_torch.framework import concurrency, telemetry
        from paddle_tpu_torch.inference import BatchScheduler, Request

        problems = []
        t_end = telemetry.clock()
        snap = telemetry.registry().snapshot()
        srv, srv0 = snap.get("serving", {}), self.c0.get("serving", {})

        def delta(key):
            return srv.get(key, 0) - srv0.get(key, 0)

        def hist_delta(key):
            return (srv.get(key, {}) or {}).get("count", 0) - (
                srv0.get(key, {}) or {}).get("count", 0)

        want = {"steps": len(events),
                "prefill_tokens": sum(e["prefill_tokens"] for e in events),
                "decode_tokens": sum(e["decode_tokens"] for e in events),
                "prefix_hit_tokens": sum(e["prefix_hit_tokens"]
                                         for e in events),
                "requests_finished": 8}
        counters = {k: delta(k) for k in want}
        for k, v in want.items():
            if counters[k] != v:
                problems.append(f"counter serving.{k} rose by "
                                f"{counters[k]}, the steps say {v}")
        ttft_n = hist_delta("ttft_s")
        if ttft_n != 8:
            problems.append(f"{ttft_n} TTFT samples, not 8")
        # request traces: submit -> admit -> tokens -> retire
        book = telemetry.request_traces()
        traces = {}
        for i in range(8):
            t = book.get(f"r{i}")
            kinds = t.kinds() if t is not None else []
            traces[f"r{i}"] = {k: kinds.count(k) for k in set(kinds)}
            ok = (len(kinds) > 3 and kinds[0] == "submit"
                  and kinds[1] == "admit" and kinds[-1] == "retire"
                  and kinds.count("token") == 32
                  and kinds.index("token") > kinds.index("admit"))
            if not ok:
                problems.append(f"r{i}: request trace {kinds[:4]}.."
                                f"{kinds[-2:]} is not submit -> admit -> "
                                "32 tokens -> retire")
        # spans: one serving.step a step, the model call nested inside
        spans = [s for s in telemetry.tracer().spans()
                 if self.t_run <= s.t0 <= t_end]
        steps_n = sum(s.name == "serving.step" for s in spans)
        calls = [s for s in spans if s.name == "serving.prefill_chunk"]
        if steps_n != len(events):
            problems.append(f"{steps_n} serving.step spans for "
                            f"{len(events)} steps")
        if len(calls) != len(events) or any(
                s.path != "serving.step/serving.prefill_chunk"
                for s in calls):
            problems.append("model-call spans not one a step inside "
                            "serving.step")
        chrome = os.path.join(self.tmp, "trace.json")
        telemetry.export_chrome(chrome)
        with open(chrome) as f:
            doc = json.load(f)
        chrome_steps = sum(e.get("name") == "serving.step"
                           for e in doc["traceEvents"])
        if chrome_steps < len(events):
            problems.append(f"the Chrome trace holds {chrome_steps} "
                            "serving.step spans")
        prom_problems, prom_samples = _prometheus_problems(
            self.flags["telemetry_export_path"])
        problems += prom_problems
        san = sched.page_pool_stats().get("sanitizer") or {}
        if not san.get("events") or san.get("violations"):
            problems.append(f"page sanitizer {san}")
        csan = concurrency.sanitizer().stats()
        if csan["violations"]:
            problems.append(f"concurrency sanitizer {csan}")
        # where the added host time goes: the same traffic once more,
        # with each plane's methods timed (the timers' own cost kept out
        # of the measured run)
        import torch

        timer = PlaneTimer()
        timer.install()
        try:
            again = BatchScheduler(adapter, max_batch_size=8,
                                   prefill_chunk_tokens=248)
            for i, p in enumerate(prompts):
                again.submit(Request(f"again{i}", p, max_new_tokens=32))
            n_again, t_again = 0, time.perf_counter()
            while again.num_active or again.num_queued:
                again.step()
                n_again += 1
            torch.cuda.synchronize()
            t_again = time.perf_counter() - t_again
        finally:
            timer.remove()
        # the ledger's decode_token row: a short token-per-step tail
        tail = BatchScheduler(adapter, max_batch_size=2,
                              chunked_prefill=False)
        for i in range(2):
            tail.submit(Request(f"tail{i}", prompts[i][:8],
                                max_new_tokens=4))
        tail.run_until_complete()
        metrics = sched.metrics()
        ledger = metrics.get("ledger", {})
        for prog in ("prefill_chunk", "decode_token"):
            if not ledger.get(prog, {}).get("count"):
                problems.append(f"no ledger row for {prog}")
        wd = sched.watchdog.summary()
        fired_checks = len({ev["epoch"]
                            for ev in sched.watchdog.to_records()})
        bundle = sched.dump_incident("chip_smoke")
        text = telemetry.summarize_incident(bundle) if bundle else ""
        if not bundle or "chip_smoke" not in text:
            problems.append(f"incident bundle {bundle} not read back")
        bundles = sched._recorder.bundles_written if sched._recorder \
            else 0
        if bundles != fired_checks + 1:
            problems.append(f"{bundles} incident bundles for "
                            f"{fired_checks} watchdog fires + 1")
        hist = {k: {f: (srv.get(k) or {}).get(f)
                    for f in ("count", "p50", "p99")}
                for k in ("ttft_s", "tpot_s", "queue_wait_s",
                          "step_wall_s", "retire_s")}
        return {"telemetry": {
            "flags": self.flags, "counters_measured": counters,
            "ttft_samples": ttft_n, "histograms_s": hist,
            "goodput": srv.get("goodput"),
            "slo_attain": {k: v for k, v in srv.items()
                           if k.startswith("slo_attain_")},
            "request_traces": traces, "spans_in_run": len(spans),
            "serving_step_spans": steps_n, "chrome_events": len(
                doc["traceEvents"]), "prometheus_samples": prom_samples,
            "page_sanitizer": san, "concurrency_sanitizer": csan,
            "watchdog": wd, "watchdog_events": [
                {"class": ev["class"], "epoch": ev["epoch"],
                 "detail": ev.get("detail")}
                for ev in sched.watchdog.to_records()],
            "incident_bundles": bundles, "ledger": ledger,
            "timed_pass": {
                "steps": n_again, "step_ms_mean": t_again * 1e3 / n_again,
                "host_ms_per_step_by_plane": {
                    k: v * 1e3 / n_again
                    for k, v in sorted(timer.seconds.items())}}}}, problems


def serve_observed_run(model, prompts, init_s, layers, base):
    """``serve_observed``: the ``serve`` run (its 8 prompts, its pool of
    SERVE_PAGES bf16 pages, ``auto``) with every host plane on
    (:class:`ObservedPlanes`); its launches and generated tokens must
    equal ``serve``'s (``base``), the planes change no batch. Returns the
    launches."""
    import tempfile

    if base is None:
        raise RuntimeError("serve_observed needs the serve run beside it")
    with tempfile.TemporaryDirectory(prefix="serve_observed_") as tmp:
        obs = ObservedPlanes(tmp)
        with port_flags(obs.flags):
            launches, _, _ = serve_run(
                "serve_observed", model, prompts, init_s, layers, None,
                "auto", base=base, observe=obs)
    return launches


def sanitizer_fuzz_run(seed):
    """``sanitizer_fuzz``: the page sanitizer's seeded pool fuzzer on the
    card, strict: clean over float32 and int8 pools with the prefix
    cache on and off (copy-on-write forks and int8 scale rows on the
    device), then each of the six injected bug classes, each of which
    must be caught with its own rule. Returns no launches (the fuzzer
    runs no attention kernel)."""
    import torch
    from paddle_tpu_torch.incubate.nn.page_sanitizer import (
        INJECTIONS, PageSanitizerError, fuzz_pool)

    problems, clean, caught = [], [], {}
    t0 = time.perf_counter()
    for kv in ("float32", "int8"):
        for prefix in (True, False):
            try:
                st = fuzz_pool(seed=seed, steps=300, kv_dtype=kv,
                               prefix_cache=prefix, device="cuda")
            except PageSanitizerError as e:
                problems.append(f"clean fuzz {kv} prefix={prefix} raised "
                                f"PageSanitizerError [{e.rule}]")
                continue
            clean.append({"kv_dtype": kv, "prefix_cache": prefix,
                          "events": st["events"], "by_op": st["by_op"],
                          "sequences": st["sequences"]})
            if st["violations"] or not st["events"]:
                problems.append(f"clean fuzz {kv} prefix={prefix}: {st}")
            if prefix and not st["by_op"].get("fork"):
                problems.append(f"fuzz {kv} with the prefix cache forked "
                                "no page")
    for inject in sorted(INJECTIONS):
        try:
            fuzz_pool(seed=3, steps=300, inject=inject, device="cuda")
            caught[inject] = None
        except PageSanitizerError as e:
            caught[inject] = e.rule
        if caught[inject] != inject:
            problems.append(f"injected {inject}: caught as "
                            f"{caught[inject]}")
    torch.cuda.synchronize()
    emit("sanitizer_fuzz", device=torch.cuda.get_device_name(0),
         steps=300, seed=seed, clean=clean, injected_caught=caught,
         wall_s=time.perf_counter() - t0, problems=problems)
    if problems:
        raise RuntimeError("sanitizer_fuzz phase failed: "
                           + "; ".join(problems))
    return {}


# the prefix and preemption runs: (run, KV pages)
PREFIX_RUNS = [("serve_prefix", None), ("serve_prefix_int8", "int8")]
# The speculative serving runs: Llama-3-8B's shape, serve's 8 prompts, 32
# new tokens each, greedy, draft_k SPEC_K, target and draft pools of
# SERVE_PAGES pages of 16. Each draft shares the target's tensors
# (layer_skip_draft). (run, draft layers or None for a self-draft,
# FLAGS_spec_decode, proposals spoiled)
SPEC_SERVE_RUNS = [("serve_spec", None, "ragged", False),
                   ("serve_spec_skip2", 2, "ragged", False),
                   ("serve_spec_spoiled", None, "ragged", True),
                   ("serve_spec_legacy", None, "legacy", False)]
SPEC_SERVE_NEW = 32
# the host planes' runs, after the others (serve_observed reads serve's
# result, serve_faults serve_preempt's tokens)
PLANE_RUNS = ["serve_observed", "serve_faults", "sanitizer_fuzz"]
SERVE_RUN_NAMES = [r for r, _, _ in SERVE_RUNS] + [
    r for r, _ in PREFIX_RUNS] + ["serve_preempt"] + [
    r for r, *_ in SPEC_SERVE_RUNS] + ["serve_spec_preempt"] + PLANE_RUNS


def serve_phase(model, prompts, init_s, seed, layers, names=None):
    """The serving runs on one model (``build_server``'s): the four of
    SERVE_RUNS (each followed by nothing but its release; those of
    PROFILED_RUNS served again under the profiler), then PREFIX_RUNS,
    ``serve_preempt``, SPEC_SERVE_RUNS, ``serve_spec_preempt`` and
    PLANE_RUNS. Returns ``({run: launches}, failed)``. With
    ``names`` only those runs go, unprofiled, and a run that fails is
    listed in ``failed`` while the others go on (``--serve-runs``);
    without it the first failure raises."""
    import torch

    pool_bytes = serve_pool_bytes(model)
    out, failed = {}, []

    def attempt(run, fn):
        if names is not None and run not in names:
            return None
        try:
            got = fn()
        except Exception as e:  # noqa: BLE001 (recorded, not swallowed)
            if names is None:
                raise
            failed.append({"run": run, "error": repr(e)[-2000:]})
            return None
        torch.cuda.empty_cache()
        return got

    base = None
    for run, kv, mode in SERVE_RUNS:
        def one(run=run, kv=kv, mode=mode):
            launches, adapter, result = serve_run(
                run, model, prompts, init_s, layers, kv, mode,
                pool_bytes=None if kv is None else pool_bytes, base=base)
            if run in PROFILED_RUNS and names is None:
                with ragged_mode(mode):
                    profile_phase(adapter, prompts, PROFILED_RUNS[run])
            return launches, result

        got = attempt(run, one)
        if got is not None:
            out[run] = got[0]
            if run == "serve":
                base = got[1]
    vocab = model.config.vocab_size
    traffic = prefix_traffic(seed, vocab)
    for run, kv in PREFIX_RUNS:
        got = attempt(run, lambda run=run, kv=kv: serve_prefix_run(
            run, model, traffic, layers, kv,
            None if kv is None else pool_bytes))
        if got is not None:
            out[run] = got
    pre_streams = {}
    got = attempt("serve_preempt", lambda: serve_preempt_run(
        model, preempt_traffic(seed, vocab), layers,
        streams=pre_streams))
    if got is not None:
        out["serve_preempt"] = got
    for run, n_draft, spec, spoil in SPEC_SERVE_RUNS:
        got = attempt(run, lambda run=run, n_draft=n_draft, spec=spec,
                      spoil=spoil: serve_spec_run(
                          run, model, prompts, layers, n_draft, spec, spoil,
                          seed, base))
        if got is not None:
            out[run] = got
    got = attempt("serve_spec_preempt", lambda: serve_preempt_run(
        model, preempt_traffic(seed, vocab), layers, "serve_spec_preempt",
        SPEC_DRAFT_LAYERS))
    if got is not None:
        out["serve_spec_preempt"] = got

    def faults_run():
        with port_flags(FAULT_RUN_FLAGS):
            return serve_preempt_run(
                model, preempt_traffic(seed, vocab), layers, "serve_faults",
                faults=True, base_streams=pre_streams or None)

    for run, fn in (("serve_observed", lambda: serve_observed_run(
            model, prompts, init_s, layers, base)),
                    ("serve_faults", faults_run),
                    ("sanitizer_fuzz", lambda: sanitizer_fuzz_run(seed))):
        got = attempt(run, fn)
        if got is not None:
            out[run] = got
    return out, failed


# one `serve` run in a child process whose working directory is a
# checkout: it imports that checkout's chip_smoke.py, builds its kernels
# and serves (argv: seed, layers or "None")
_SERVE_AB_CHILD = """
import os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from paddle_tpu_torch.ops.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.library()
layers = None if sys.argv[2] == "None" else int(sys.argv[2])
model, prompts, init_s = cs.build_server(int(sys.argv[1]), layers)
cs.serve_run("serve", model, prompts, init_s, layers, None, "auto")
"""


def serve_ab_phase(other, seed, layers):
    """Serves the `serve` run from the checkout ``other`` (an unpacked
    earlier tree) and from this one in turns (other, this, this, other),
    each in a child process of its own, and emits their tokens/s, TTFT
    and TPOT on one line. Fails if a child fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    runs = []
    for tree, path in (("other", other), ("this", root), ("this", root),
                       ("other", other)):
        child = subprocess.run(
            [sys.executable, "-c", _SERVE_AB_CHILD, str(seed), str(layers)],
            cwd=path, capture_output=True, text=True, timeout=900)
        line = next((json.loads(s) for s in child.stdout.splitlines()
                     if s.startswith('{"phase": "serve"')), None)
        if child.returncode or line is None:
            raise RuntimeError(f"serve from {path} failed (exit "
                               f"{child.returncode}):\n"
                               f"{child.stderr[-2000:]}")
        runs.append({"tree": tree, "path": path,
                     "total_tok_per_s": line["total_tok_per_s"],
                     "generated_tok_per_s": line["generated_tok_per_s"],
                     "ttft_ms_median": line["ttft_ms"]["median"],
                     "tpot_ms_median": line["tpot_ms"]["median"],
                     "wall_s": line["wall_s"], "launches": line["launches"]})
    emit("serve_ab", runs=runs)


# serve_prefix's traffic: PREFIX_REQUESTS prompts of one shared prefix
# of PREFIX_TOKENS tokens (1,000 % 16 = 8: the prefix ends mid-page, so
# every hit forks its tail page) and a distinct suffix each
PREFIX_TOKENS, PREFIX_REQUESTS = 1000, 16


def prefix_traffic(seed, vocab):
    """The shared prefix (from ``seed``) plus a suffix of 24-200 tokens
    per request, each suffix's first token distinct from the others'."""
    import numpy as np

    rng = np.random.RandomState(seed + 1)
    prefix = rng.randint(0, vocab, PREFIX_TOKENS).tolist()
    firsts = rng.choice(vocab, PREFIX_REQUESTS, replace=False)
    lens = rng.randint(24, 201, PREFIX_REQUESTS)
    return [prefix + [int(f)] + rng.randint(0, vocab, n - 1).tolist()
            for f, n in zip(firsts, lens)]


def watch_forks(adapter, layers):
    """Wraps ``adapter._book_step`` (an instance attribute: ``del``
    restores it) so that every copy-on-write fork a booking makes is
    held, right after the booking and before any layer writes, against
    its source page in the listed layers: payload and, for an int8
    pool, the scale rows, bit for bit. Returns the list of readings
    (True: the fork equals its source)."""
    import torch

    book = adapter._book_step
    seen = []

    def booking(seq_ids, counts, **kw):
        c0 = adapter.caches[0]
        pending = [(s, len(c0._tables[s]) - 1, c0._tables[s][-1])
                   for s in seq_ids if c0.pending_cow(s)]
        step = book(seq_ids, counts, **kw)
        for s, i, src in pending:
            for li in layers:
                c = adapter.caches[li]
                dst = c._tables[s][i]
                parts = [c.k_pages, c.v_pages] + (
                    [c.k_scales, c.v_scales] if c.quantized else [])
                seen.append(dst != src and all(
                    torch.equal(t[dst], t[src]) for t in parts))
        return step

    adapter._book_step = booking
    return seen


def _page_bytes_of(cache, pages):
    """Clones of the listed pages' payload (and scale rows), in order."""
    import torch

    pg = torch.tensor(pages, dtype=torch.int64,
                      device=cache.k_pages.device)
    parts = [cache.k_pages, cache.v_pages] + (
        [cache.k_scales, cache.v_scales] if cache.quantized else [])
    return [t[pg].clone() for t in parts]


def _same_bytes(a, b):
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def prefix_traffic_run(model, prompts, kv_cache_dtype, pool_bytes,
                       prefix_cache, watch):
    """``r0`` served alone to completion (filling the tree when
    ``prefix_cache``), then ``r1``-``r15`` submitted together, greedy, 32
    new tokens each, ``max_batch_size=8``, ``prefill_chunk_tokens=248``,
    under ``FLAGS_ragged_attention=auto``, the launch counters reset
    just before ``r1`` and read after the last token. Checks every
    fork's bytes, the cached prefix chain's bytes across the run (first
    and last layer), the hit and fork counts, the launch counts and the
    watched requests' logits against the oracle; then clears the tree
    and checks that every pool drained. Returns ``(readings,
    problems, launches, streams)``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import (BatchScheduler,
                                            PagedLlamaAdapter, Request)
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats

    if pool_bytes is None:
        adapter = PagedLlamaAdapter(model, num_pages=SERVE_PAGES,
                                    page_size=16)
    else:
        adapter = PagedLlamaAdapter(model, page_size=16,
                                    kv_cache_dtype=kv_cache_dtype,
                                    page_pool_bytes=pool_bytes)
    n_layers = len(adapter.caches)
    ends = sorted({0, n_layers - 1})
    captured, row_kinds = record_prefill_chunk(adapter, watch)
    forks = watch_forks(adapter, ends)
    tok_times = {}

    def on_token(req, tok, is_prompt):
        if not is_prompt:
            tok_times.setdefault(req.req_id, []).append(time.perf_counter())

    problems = []
    with ragged_mode("auto"):
        sched = BatchScheduler(adapter, max_batch_size=8,
                               prefill_chunk_tokens=248,
                               prefix_cache=prefix_cache)
        sched.submit(Request("r0", prompts[0], max_new_tokens=32))
        sched.run_until_complete()
        chains = None
        if prefix_cache:
            chains = sched.prefix_cache.match(
                prompts[1][:PREFIX_TOKENS]).chains
            before = [_page_bytes_of(adapter.caches[li], chains[li])
                      for li in ends]
        forks0 = [c.cow_forks for c in adapter.caches]
        calls0 = adapter.chunk_stats["calls"]
        for k in row_kinds:
            row_kinds[k] = 0
        torch.cuda.synchronize()
        kernel_launch_stats(reset=True)
        t0 = time.perf_counter()
        for i, p in enumerate(prompts[1:], 1):
            sched.submit(Request(f"r{i}", p, max_new_tokens=32,
                                 on_token=on_token))
        hits = prefill = steps = 0
        while sched.num_active or sched.num_queued:
            ev = sched.step()
            hits += ev["prefix_hit_tokens"]
            prefill += ev["prefill_tokens"]
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launch_stats(reset=True)
    del adapter.prefill_chunk, adapter._book_step
    calls = adapter.chunk_stats["calls"] - calls0
    done = {f"r{i}": sched.result(f"r{i}") for i in range(len(prompts))}
    cows = [c.cow_forks - f for c, f in zip(adapter.caches, forks0)]
    prompt_tokens = sum(len(p) for p in prompts[1:])
    n_hit = len(prompts) - 1 if prefix_cache else 0
    if hits != n_hit * PREFIX_TOKENS:
        problems.append(f"prefix hit tokens {hits} != "
                        f"{n_hit * PREFIX_TOKENS}")
    if prefill != prompt_tokens - hits:
        problems.append(f"prefill tokens {prefill} != prompt tokens "
                        f"{prompt_tokens} - hits {hits}")
    if any(n != n_hit for n in cows):
        problems.append(f"copy-on-write forks per layer {sorted(set(cows))}"
                        f" != {n_hit}")
    if len(forks) != n_hit * len(ends) or not all(forks):
        problems.append(f"forks equal to their source page: {sum(forks)} "
                        f"of {len(forks)} ({n_hit * len(ends)} expected)")
    if chains is not None:
        after = [_page_bytes_of(adapter.caches[li], chains[li])
                 for li in ends]
        if not all(_same_bytes(a, b) for a, b in zip(before, after)):
            problems.append("the cached prefix chain's bytes changed")
    if any(len(r.generated_ids) != 32 for r in done.values()):
        problems.append("a request did not generate 32 tokens")
    lp, kinds = launch_problems(launches, adapter, calls, row_kinds, "auto")
    problems += lp
    gate = COSINE_GATE if kv_cache_dtype is None else INT8_COSINE_GATE
    oracle = oracle_check(model, done, captured, watch, gate, problems)
    stats = sched.page_pool_stats()
    if prefix_cache:
        sched.prefix_cache.clear()
    for c in adapter.caches:
        c.assert_ref_invariants()
    if any(c.num_free_pages != c.num_pages for c in adapter.caches):
        problems.append("a pool did not drain after prefix_cache.clear()")
    ttft = sorted((v[0] - t0) * 1e3 for v in tok_times.values())
    gen = sum(len(done[f"r{i}"].generated_ids)
              for i in range(1, len(prompts)))
    readings = {
        "kv_cache_dtype": kv_cache_dtype or "bfloat16",
        "prefix_cache": bool(prefix_cache),
        "num_pages": adapter.caches[0].num_pages,
        "kv_pool_bytes": sum(c.pool_nbytes for c in adapter.caches),
        "steps": steps, "model_calls": calls, "wall_s": wall,
        "prefix_hit_tokens": hits, "prompt_tokens": prompt_tokens,
        "prefill_tokens": prefill, "generated_tokens": gen,
        "cow_forks_per_layer": sorted(set(cows)),
        "forks_checked": len(forks), "forks_equal_to_source": sum(forks),
        "shared_pages_at_end": stats["shared_pages"],
        "total_tok_per_s": (prompt_tokens + gen) / wall,
        "generated_tok_per_s": gen / wall,
        "ttft_ms": {"median": float(np.median(ttft)), "max": ttft[-1],
                    "n": len(ttft)},
        "launches": launches, "attention_kinds": kinds,
        "oracle": oracle, "cosine_gate": gate}
    streams = {r: d.generated_ids for r, d in done.items()}
    return readings, problems, launches, streams


def serve_prefix_run(run, model, prompts, layers, kv_cache_dtype,
                     pool_bytes):
    """``serve_prefix`` (bf16 pages, 512 of 16) or ``serve_prefix_int8``
    (int8 pages in serve's pool bytes): the prefix traffic through
    ``prefix_cache=True`` (:func:`prefix_traffic_run`), the served logits
    of two hit requests held against the oracle; ``serve_prefix`` also
    serves the same traffic with ``prefix_cache=False`` beside it
    (reported, its launch counts gated). Emits the run's line; returns
    the cache run's launches."""
    readings, problems, launches, streams = prefix_traffic_run(
        model, prompts, kv_cache_dtype, pool_bytes, True, {"r1", "r2"})
    off = None
    if kv_cache_dtype is None:
        off, off_problems, _, off_streams = prefix_traffic_run(
            model, prompts, None, None, False, set())
        problems += [f"prefix_cache=False: {p}" for p in off_problems]
        same = [a == b for r in streams
                for a, b in zip(streams[r], off_streams[r])]
        off["same_token_share"] = sum(same) / len(same)
        off["identical_requests"] = sum(
            streams[r] == off_streams[r] for r in streams)
    cfg = model.config
    emit(run, model="llama3_8b", layers=cfg.num_hidden_layers,
         depth_cut=None if layers is None else
         f"{layers} of 32 layers (--layers)", ragged_attention="auto",
         page_size=16, max_batch_size=8, prefill_chunk_tokens=248,
         new_tokens=32, prefix_tokens=PREFIX_TOKENS,
         prompt_lens=[len(p) for p in prompts], cache=readings,
         no_cache=off, problems=problems)
    if problems:
        raise RuntimeError(f"{run} phase failed: " + "; ".join(problems))
    return launches


# serve_preempt's traffic: PREEMPT_LOW priority-0 prompts of 300-400
# tokens that fill the pool, then after PREEMPT_AFTER steps two
# priority-1 prompts of ~600; 64 new tokens each
PREEMPT_LOW, PREEMPT_AFTER, PREEMPT_NEW = 6, 4, 64


def preempt_traffic(seed, vocab):
    import numpy as np

    rng = np.random.RandomState(seed + 2)
    low = [rng.randint(0, vocab, n).tolist()
           for n in rng.randint(300, 401, PREEMPT_LOW)]
    high = [rng.randint(0, vocab, n).tolist()
            for n in rng.randint(580, 621, 2)]
    return low, high


def serve_preempt_run(model, traffic, layers, run="serve_preempt",
                      draft_layers=None, faults=False, streams=None,
                      base_streams=None):
    """``serve_preempt``: bf16 pages, a pool sized so that the
    priority-0 requests fill it and admitting the first priority-1
    request alone needs two victims, ``swap_bytes=1 << 30``,
    ``max_batch_size=8``. The first request swapped out is cancelled
    right after; every victim's pages in every layer, read just before
    ``swap_out``, must equal its restored pages after ``swap_in`` bit
    for bit. Gates: >= 2 preemptions, every other victim resumed, the
    cancelled request ``aborted_deadline`` with its swap record gone,
    64 tokens for every other request, one resumed victim's logits
    against the oracle, the swap space empty and every pool drained at
    the end, exact launch counts.

    With ``draft_layers`` (``serve_spec_preempt``) the same traffic runs
    speculative under ragged, draft_k SPEC_K, with the target's first
    ``draft_layers`` layers as the draft (its pool sized to hold every
    request at once, so that only the target pool preempts), the
    target pool sized with the draft's SPEC_K + 1 token slack. Further
    gates: >= 1 draft discard, refill tokens > 0, every committed token
    the target's argmax at its position, the target pool holding the
    committed prefix after every step, the draft pool drained.

    With ``faults`` (``serve_faults``, run under ``FAULT_RUN_FLAGS``:
    ``SERVE_FAULT_PLAN``, strict page sanitizer, metrics, watchdog
    ``warn``) nothing is cancelled, and the gates are: the injector's
    event log equal to ``SERVE_FAULT_LOG``, the storm preempting >= 2
    victims, every victim restored bit for bit, no sanitizer violation,
    every committed token the argmax of the logits that produced it,
    one resumed victim against the oracle, the pools drained and the
    swap space empty. ``base_streams`` (``serve_preempt``'s tokens) is
    what the share of equal tokens is read against (reported, not
    gated). ``streams``: a dict that gets the run's tokens. Emits the
    run's line; returns the launches."""
    import torch
    from paddle_tpu_torch.inference import (BatchScheduler,
                                            PagedLlamaAdapter, Request,
                                            RequestState)
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats

    low, high = traffic
    page = 16
    slack = 0 if draft_layers is None else SPEC_K + 1
    worst = [-(-(len(p) + PREEMPT_NEW + slack) // page) for p in low + high]
    # every priority-0 request fits with two pages to spare (per layer)
    num_pages = -(-(sum(worst[:PREEMPT_LOW]) + 2) * 100 // 95)
    adapter = PagedLlamaAdapter(model, num_pages=num_pages, page_size=page)
    lows = [f"lo{i}" for i in range(len(low))]
    preds = {} if draft_layers is not None or faults else None
    captured, row_kinds = record_prefill_chunk(adapter, set(lows), preds)
    spec_kw, dadapter, n_draft = {}, None, 0
    if draft_layers is not None:
        n_draft = min(draft_layers, model.config.num_hidden_layers)
        dadapter = PagedLlamaAdapter(
            layer_skip_draft(model, n_draft), page_size=page,
            num_pages=-(-sum(worst) * 100 // 95) + 1)
        t_calls, d_calls = record_spec_calls(adapter, dadapter, preds,
                                             captured)
        spec_kw = dict(draft_model=dadapter, draft_k=SPEC_K)
    windows = []
    snaps, swaps, restored_equal = {}, [], []
    swap_out, swap_in = adapter.swap_out, adapter.swap_in

    def chain_bytes(sid):
        return [_page_bytes_of(c, c.seq_pages(sid)) for c in adapter.caches]

    def timed_swap_out(seq_id, space):
        snaps[seq_id] = chain_bytes(seq_id)
        torch.cuda.synchronize()
        t = time.perf_counter()
        freed, nbytes = swap_out(seq_id, space)
        swaps.append({"op": "swap_out", "req": seq_id, "bytes": nbytes,
                      "pages": freed,
                      "ms": (time.perf_counter() - t) * 1e3})
        return freed, nbytes

    def timed_swap_in(seq_id, space):
        nbytes = space.used_bytes
        torch.cuda.synchronize()
        t = time.perf_counter()
        pages = swap_in(seq_id, space)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        swaps.append({"op": "swap_in", "req": seq_id, "pages": pages,
                      "bytes": nbytes - space.used_bytes, "ms": ms})
        restored_equal.append(all(
            _same_bytes(a, b) for a, b in zip(snaps.pop(seq_id),
                                              chain_bytes(seq_id))))
        return pages

    adapter.swap_out, adapter.swap_in = timed_swap_out, timed_swap_in
    tok_times = {}

    def on_token(req, tok, is_prompt):
        if not is_prompt:
            tok_times.setdefault(req.req_id, []).append(time.perf_counter())

    problems, cancelled, preempted, resumed, forced = [], None, 0, 0, 0
    with ragged_mode("auto"), spec_decode_mode("ragged"):
        sched = BatchScheduler(adapter, max_batch_size=8,
                               prefill_chunk_tokens=248, preempt=True,
                               swap_bytes=1 << 30, **spec_kw)
        if dadapter is not None:
            windows = record_windows(sched)
        calls0 = adapter.chunk_stats["calls"]
        torch.cuda.synchronize()
        kernel_launch_stats(reset=True)
        t0 = time.perf_counter()
        for rid, p in zip(lows, low):
            sched.submit(Request(rid, p, max_new_tokens=PREEMPT_NEW))
        steps = 0
        t_high = None
        while sched.num_active or sched.num_queued or sched.num_swapped:
            if steps == PREEMPT_AFTER:
                t_high = time.perf_counter()
                for i, p in enumerate(high):
                    sched.submit(Request(f"hi{i}", p, priority=1,
                                         max_new_tokens=PREEMPT_NEW,
                                         on_token=on_token))
            ev = sched.step()
            steps += 1
            bad = dadapter and committed_prefix_problem(sched, adapter)
            if bad and not any("committed prefix" in p for p in problems):
                problems.append(f"after step {steps}, {bad}")
            preempted += ev.get("preempted", 0)
            resumed += ev.get("resumed", 0)
            if "preempt_storm" in ev.get("faulted", ""):
                forced += ev.get("preempted", 0)
            if not faults and cancelled is None and sched.num_swapped:
                cancelled = next(iter(sched._swapped))
                sched.cancel(cancelled)
                if sched.swap_space.holds(cancelled):
                    problems.append(f"{cancelled}: swap record kept")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launch_stats(reset=True)
    del adapter.prefill_chunk, adapter.swap_out, adapter.swap_in
    if dadapter is not None:
        del adapter.decode_window, adapter.decode_token
        del dadapter.prefill_chunk, dadapter.decode_token
        del sched._commit_spec_row
    calls = adapter.chunk_stats["calls"] - calls0
    done = {r: sched.result(r) for r in lows + ["hi0", "hi1"]}
    victims = sorted(r for r, d in done.items() if d._preemptions)
    if preempted < 2:
        problems.append(f"{preempted} preemptions (>= 2 expected)")
    if not faults and (cancelled is None or done[cancelled].state
                       != RequestState.ABORTED_DEADLINE):
        problems.append(f"cancelled {cancelled} did not end aborted")
    others = [r for r in done if r != cancelled]
    if any(not done[r].finished or len(done[r].generated_ids)
           != PREEMPT_NEW for r in others):
        problems.append(f"a request other than {cancelled} did not "
                        f"generate {PREEMPT_NEW} tokens")
    if resumed != len(restored_equal) or resumed < len(victims) - (
            0 if faults else 1):
        problems.append(f"{resumed} resumes for victims {victims}")
    if not all(restored_equal):
        problems.append(f"restored pages differ from the swapped-out ones: "
                        f"{restored_equal}")
    resumed_victims = [r for r in victims if r != cancelled]
    oracle = {}
    if resumed_victims:
        oracle = oracle_check(model, done,
                              committed_captures(done, captured),
                              resumed_victims[:1], COSINE_GATE, problems)
    else:
        problems.append("no victim resumed")
    spec = None
    if dadapter is None:
        lp, kinds = launch_problems(launches, adapter, calls, row_kinds,
                                    "auto")
    else:
        t_calls["prefill_chunk"] = calls
        lp = spec_launch_problems(launches, row_kinds, t_calls, d_calls,
                                  model.config.num_hidden_layers, n_draft)
        kinds = sorted(set().union(*map(
            set, adapter.attend_kinds_by_bucket.values())))
        st = dict(sched.spec_stats)
        spec = {"draft_layers": n_draft, "draft_k": SPEC_K,
                "draft_num_pages": dadapter.caches[0].num_pages,
                "spec_stats": st, "target_calls": t_calls,
                "draft_calls": d_calls,
                "acceptance": st["accepted_draft_tokens"]
                / max(1, st["proposed_tokens"]),
                "windows": spec_window_stats(windows, ())}
        wrong, _ = argmax_problems(
            {r: d for r, d in done.items() if d.finished}, preds)
        problems += wrong
        if st["draft_discards"] < 1 or st["refill_tokens"] < 1:
            problems.append(f"draft discards {st['draft_discards']}, "
                            f"refill tokens {st['refill_tokens']}")
        if t_calls["decode_token"] or t_calls["decode_window"]:
            problems.append(f"target calls besides prefill_chunk: {t_calls}")
        if any(c.num_free_pages != c.num_pages for c in dadapter.caches):
            problems.append("a draft pool did not drain")
    problems += lp
    fault_run = None
    if faults:
        log = sched._faults.events()
        got = [(e["kind"], e["step"]) for e in log]
        if got != SERVE_FAULT_LOG:
            problems.append(f"fault log {got} != the plan's "
                            f"{SERVE_FAULT_LOG}")
        if forced < 2:
            problems.append(f"the storm preempted {forced} (>= 2)")
        san = sched.page_pool_stats().get("sanitizer") or {}
        if not san.get("events") or san.get("violations"):
            problems.append(f"page sanitizer {san}")
        wrong, n_tok = argmax_problems(
            {r: d for r, d in done.items() if d.finished}, preds)
        problems += wrong
        share = None
        if base_streams:
            same = [a == b for r, d in done.items() if r in base_streams
                    for a, b in zip(d.generated_ids, base_streams[r])]
            share = sum(same) / max(1, len(same))
        fault_run = {"plan": SERVE_FAULT_PLAN, "log": log,
                     "forced_preemptions": forced, "page_sanitizer": san,
                     "argmax_checked_tokens": n_tok,
                     "same_token_share_vs_serve_preempt": share,
                     "watchdog": sched.watchdog.summary()
                     if sched.watchdog else None,
                     "metrics_serving": {
                         k: v for k, v in sched.metrics()["serving"]
                         .items() if not isinstance(v, dict)}}
    if streams is not None:
        streams.update({r: d.generated_ids for r, d in done.items()})
    if sched.swap_space.used_bytes:
        problems.append(f"swap space holds {sched.swap_space.used_bytes} "
                        "bytes at the end")
    for c in adapter.caches:
        c.assert_ref_invariants()
    if any(c.num_free_pages != c.num_pages for c in adapter.caches):
        problems.append("a pool did not drain")
    cfg = model.config
    outs = [s for s in swaps if s["op"] == "swap_out"]
    ins = [s for s in swaps if s["op"] == "swap_in"]
    ttft_high = {r: (tok_times[r][0] - t_high) * 1e3 for r in ("hi0", "hi1")
                 if tok_times.get(r)}
    emit(run, model="llama3_8b", layers=cfg.num_hidden_layers,
         depth_cut=None if layers is None else
         f"{layers} of 32 layers (--layers)", ragged_attention="auto",
         kv_cache_dtype="bfloat16", page_size=page, num_pages=num_pages,
         watermark_pages=0.95 * num_pages, worst_case_pages=worst,
         prompt_lens=[len(p) for p in low + high], priorities=[0] * len(
             low) + [1, 1], new_tokens=PREEMPT_NEW, max_batch_size=8,
         prefill_chunk_tokens=248, swap_bytes=1 << 30,
         high_submitted_at_step=PREEMPT_AFTER, steps=steps,
         model_calls=calls, wall_s=wall, preemptions=preempted,
         resumes=resumed, victims=victims, cancelled=cancelled,
         restored_bitwise=restored_equal, swaps=swaps,
         swap_out_ms_total=sum(s["ms"] for s in outs),
         swap_out_bytes_total=sum(s["bytes"] for s in outs),
         swap_in_ms_total=sum(s["ms"] for s in ins),
         swap_in_bytes_total=sum(s["bytes"] for s in ins),
         swap_peak_bytes=sched.swap_space.peak_used_bytes,
         ttft_high_ms=ttft_high,
         generated_tokens=sum(len(d.generated_ids) for d in done.values()),
         launches=launches, attention_kinds=kinds, oracle=oracle,
         cosine_gate=COSINE_GATE, spec=spec, faults=fault_run,
         problems=problems)
    if problems:
        raise RuntimeError(f"{run} phase failed: " + "; ".join(problems))
    return launches


# ---------------------------------------------------- speculative serving


@contextlib.contextmanager
def spec_decode_mode(mode):
    """``FLAGS_spec_decode`` set for a block, restored after."""
    from paddle_tpu_torch.framework.flags import flag, set_flags

    prev = flag("spec_decode")
    set_flags({"FLAGS_spec_decode": mode})
    try:
        yield
    finally:
        set_flags({"FLAGS_spec_decode": prev})


def record_spec_calls(adapter, draft, preds, captured, spoiled=()):
    """Counts the target's and the draft's model calls by kind (wrapping
    the target's ``decode_token`` and ``decode_window`` and the draft's
    ``prefill_chunk`` and ``decode_token`` as instance attributes; the
    target's ``prefill_chunk`` is :func:`record_prefill_chunk`'s). The
    target's ``decode_window`` logits go into ``preds`` (argmax) and
    ``captured`` (the watched requests) by position, as
    ``record_prefill_chunk`` keeps them. Where ``(request, position)`` is
    in ``spoiled``, the draft's logits row that predicts that position
    has its argmax masked to -inf, so that the draft proposes its second
    choice there. Returns ``(target_calls, draft_calls)``."""
    t_calls = {"decode_token": 0, "decode_window": 0}
    d_calls = {"prefill_chunk": 0, "decode_token": 0}
    window_fn, token_fn = adapter.decode_window, adapter.decode_token
    d_chunk, d_token = draft.prefill_chunk, draft.decode_token

    def decode_window(token_windows, seq_ids):
        base = [adapter.caches[0].seq_len(s) for s in seq_ids]
        out = window_fn(token_windows, seq_ids)
        t_calls["decode_window"] += 1
        am = out.float().argmax(-1).tolist()
        for i, s in enumerate(seq_ids):
            got = preds.setdefault(s, {})
            for j, t in enumerate(am[i]):
                got[base[i] + j] = t
                if s in captured:
                    captured[s][base[i] + j] = out[i, j].float()
        return out

    def decode_token(token_ids, seq_ids):
        t_calls["decode_token"] += 1
        return token_fn(token_ids, seq_ids)

    def spoil(out, seq_ids, predicted):
        rows = [i for i, (s, p) in enumerate(zip(seq_ids, predicted))
                if (s, p) in spoiled]
        if rows:
            out = out.clone()  # the adapter's is an inference tensor
            for i in rows:
                out[i, out[i].argmax()] = float("-inf")
        return out

    def draft_prefill_chunk(token_ids, seq_ids, start_positions=None,
                            pad_to=None, logits_rows=None):
        d_calls["prefill_chunk"] += 1
        out = d_chunk(token_ids, seq_ids, start_positions, pad_to=pad_to,
                      logits_rows=logits_rows)
        return spoil(out, seq_ids, [int(p) + len(t) for p, t in
                                    zip(start_positions, token_ids)])

    def draft_decode_token(token_ids, seq_ids):
        d_calls["decode_token"] += 1
        lens = [draft.caches[0].seq_len(s) for s in seq_ids]
        return spoil(d_token(token_ids, seq_ids), seq_ids,
                     [n + 1 for n in lens])

    adapter.decode_window, adapter.decode_token = decode_window, decode_token
    draft.prefill_chunk, draft.decode_token = (draft_prefill_chunk,
                                               draft_decode_token)
    return t_calls, d_calls


def record_windows(sched):
    """Wraps ``sched._commit_spec_row`` (an instance attribute: ``del
    sched._commit_spec_row`` restores the method) to list every verify
    window: its request, its first position, the draft's proposals and
    what the scheduler committed."""
    windows = []
    commit = sched._commit_spec_row

    def recording(s, props_i, preds_i, base_t, base_d):
        committed, retired = commit(s, props_i, preds_i, base_t, base_d)
        windows.append({"req": s, "base": base_t, "props": list(props_i),
                        "committed": committed, "retired": retired})
        return committed, retired

    sched._commit_spec_row = recording
    return windows


def committed_prefix_problem(sched, adapter):
    """After a step: the target pool holds exactly each decoding
    request's committed prefix (the prompt and every generated token
    but the newest, which the next round feeds), and no draft chain is
    ahead of it. Returns the first request that breaks this, or None."""
    for r in sched._active.values():
        if not r.generated_ids:
            continue
        n = adapter.caches[0].seq_len(r.req_id)
        want = len(r.prompt_ids) + len(r.generated_ids) - 1
        d = sched.draft.caches[0].seq_len(r.req_id)
        if n != want or d > n:
            return (f"{r.req_id}: target pool {n} tokens, draft {d}, "
                    f"committed prefix {want}")
    return None


def spec_launch_problems(launches, t_rows, t_calls, d_calls, n_layers,
                         n_draft):
    """Exact launch counts of a speculative run: one RMSNorm per layer
    norm and the final one per target and draft call, one more per
    target call with ``logits_rows`` (the verify rows' final norm); one
    ragged attention launch per layer of each ``prefill_chunk`` and
    ``decode_token`` call (``decode_window`` is plain torch); no decode
    kernel launch."""
    want = {
        "rms_norm": (2 * n_layers + 1) * (t_calls["prefill_chunk"]
                                          + t_calls["decode_token"]
                                          + t_calls["decode_window"])
        + t_rows["logits_rows"]
        + (2 * n_draft + 1) * (d_calls["prefill_chunk"]
                               + d_calls["decode_token"]),
        "paged_ragged_attention": n_layers * (t_calls["prefill_chunk"]
                                              + t_calls["decode_token"])
        + n_draft * (d_calls["prefill_chunk"] + d_calls["decode_token"]),
        "paged_decode_attention": 0}
    return [f"{k} launches {launches.get(k, 0)} != {v}"
            for k, v in want.items() if launches.get(k, 0) != v]


def spec_window_stats(windows, spoiled):
    """Over the windows that did not retire their request (a retire may
    stop a window short): the n_acc histogram (n_acc = the committed
    tokens less the target's own), the accepted share, the rollbacks
    (n_acc < draft_k) and, with ``spoiled``, the share of windows whose
    n_acc is the index of their first spoiled proposal (draft_k where
    none is)."""
    hist = [0] * (SPEC_K + 1)
    as_spoiled = 0
    for w in windows:
        if w["retired"]:
            continue
        n_acc = w["committed"] - 1
        hist[n_acc] += 1
        first = next((j for j in range(SPEC_K)
                      if (w["req"], w["base"] + 1 + j) in spoiled), SPEC_K)
        as_spoiled += n_acc == first
    n = sum(hist)
    return {"windows": len(windows), "full_windows": n, "n_acc_hist": hist,
            "rollbacks": n - hist[SPEC_K],
            "n_acc_as_spoiled_share": as_spoiled / max(1, n) if spoiled
            else None}


def argmax_problems(done, preds):
    """Every committed token must be the argmax of the target's own
    logits at the position before it (the latest logits there: a window
    that committed tokens is never recomputed below its last one)."""
    wrong = total = 0
    for rid, r in done.items():
        p0 = len(r.prompt_ids)
        for j, t in enumerate(r.generated_ids):
            total += 1
            wrong += preds.get(rid, {}).get(p0 + j - 1) != t
    return ([f"{wrong} of {total} committed tokens are not the target's "
             "argmax"] if wrong else []), total


def committed_captures(done, captured):
    """The watched requests' captured logits at the positions that sampled
    a committed token only (a retiring window leaves logits of positions
    past the last committed token)."""
    out = {}
    for rid, by_pos in captured.items():
        r = done[rid]
        end = len(r.prompt_ids) + len(r.generated_ids) - 1
        out[rid] = {p: v for p, v in by_pos.items() if p < end}
    return out


def serve_spec_run(run, model, prompts, layers, draft_layers, spec, spoil,
                   seed, base=None):
    """Serves the 8 prompts (SPEC_SERVE_NEW new tokens each, greedy,
    ``max_batch_size=8``, ``prefill_chunk_tokens=248``) through
    ``BatchScheduler(adapter, draft_model=draft_adapter,
    draft_k=SPEC_K)`` under ``FLAGS_spec_decode=spec`` and
    ``FLAGS_ragged_attention=auto``, target and draft pools of
    SERVE_PAGES bf16 pages of 16; the draft is the target's first
    ``draft_layers`` layers (every layer: a self-draft). With ``spoil``
    the draft's proposals for a seeded SPEC_SPOIL_SHARE of the positions
    are its second choice. Gates: every committed token the target's
    argmax at its position; two requests' logits against the float32
    oracle; after every step the target pool holds the committed prefix;
    exact launch counts; ``spec_stats["committed_tokens"]`` plus the
    first tokens (the prefill's) equal to the generated tokens; ragged:
    one target ``prefill_chunk`` a round and no other target call;
    legacy: one ``decode_window`` a round; the self-draft accepting
    >= SPEC_SELF_ACCEPT_GATE of its proposals; ``serve_spec_skip2`` and
    the spoiled run rolling back at least once, the spoiled one's n_acc
    at its first spoiled proposal in >= SPEC_SELF_ACCEPT_GATE of its
    windows; every pool free at the end. ``base``: the ``serve`` run's
    result, whose tokens the run's are compared with (a share, not a
    gate: the T = 1 and T > 1 attention routes round differently, so a
    near-tie can differ). Emits the run's line; returns the launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import (BatchScheduler,
                                            PagedLlamaAdapter, Request)
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats

    cfg = model.config
    n_layers = cfg.num_hidden_layers
    n_draft = n_layers if draft_layers is None else min(draft_layers,
                                                        n_layers)
    adapter = PagedLlamaAdapter(model, num_pages=SERVE_PAGES, page_size=16)
    dadapter = PagedLlamaAdapter(layer_skip_draft(model, n_draft),
                                 num_pages=SERVE_PAGES, page_size=16)
    rids = [f"r{i}" for i in range(len(prompts))]
    spoiled = set()
    if spoil:
        rng = np.random.RandomState(seed + 13)
        spoiled = {(r, q) for r, p in zip(rids, prompts)
                   for q in range(len(p) + 1,
                                  len(p) + SPEC_SERVE_NEW + SPEC_K + 1)
                   if rng.rand() < SPEC_SPOIL_SHARE}
    watch = {"r0", "r1"}
    preds = {}
    captured, t_rows = record_prefill_chunk(adapter, watch, preds)
    t_calls, d_calls = record_spec_calls(adapter, dadapter, preds, captured,
                                         spoiled)
    tok_times = {}

    def on_token(req, tok, is_prompt):
        if not is_prompt:
            tok_times.setdefault(req.req_id, []).append(time.perf_counter())

    problems = []
    with ragged_mode("auto"), spec_decode_mode(spec):
        # warm-up: one short request (cuBLAS handles, GEMM heuristics)
        warm = BatchScheduler(adapter, draft_model=dadapter,
                              draft_k=SPEC_K, max_batch_size=8,
                              prefill_chunk_tokens=248)
        warm.submit(Request("warm", prompts[0][:16], max_new_tokens=6))
        warm.run_until_complete()
        sched = BatchScheduler(adapter, draft_model=dadapter,
                               draft_k=SPEC_K, max_batch_size=8,
                               prefill_chunk_tokens=248)
        windows = record_windows(sched)
        for rid, p in zip(rids, prompts):
            sched.submit(Request(rid, p, max_new_tokens=SPEC_SERVE_NEW,
                                 on_token=on_token))
        for d in (t_rows, t_calls, d_calls):
            for k in d:
                d[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step, steps = [], 0
        kernel_launch_stats(reset=True)
        t0 = time.perf_counter()
        while sched.num_active or sched.num_queued:
            before = (t_rows["calls"] + t_calls["decode_token"]
                      + t_calls["decode_window"])
            ev = sched.step()
            steps += 1
            after = (t_rows["calls"] + t_calls["decode_token"]
                     + t_calls["decode_window"])
            per_step.append((after - before, ev.get("spec_verify_rows", 0)))
            bad = committed_prefix_problem(sched, adapter)
            if bad and not any("committed prefix" in p for p in problems):
                problems.append(f"after step {steps}, {bad}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launch_stats(reset=True)
    # back to the methods: the wrappers close over their objects, and the
    # reference cycles would keep the pools alive into the next run
    del adapter.prefill_chunk, adapter.decode_window, adapter.decode_token
    del dadapter.prefill_chunk, dadapter.decode_token
    del sched._commit_spec_row
    t_calls["prefill_chunk"] = t_rows["calls"]
    done = {r: sched.result(r) for r in rids}
    gen = sum(len(r.generated_ids) for r in done.values())
    prompt_lens = [len(p) for p in prompts]
    st = dict(sched.spec_stats)
    if any(len(r.generated_ids) != SPEC_SERVE_NEW for r in done.values()):
        problems.append(f"a request did not generate {SPEC_SERVE_NEW} "
                        "tokens")
    wrong, _ = argmax_problems(done, preds)
    problems += wrong
    oracle = oracle_check(model, done, committed_captures(done, captured),
                          watch, COSINE_GATE, problems)
    problems += spec_launch_problems(launches, t_rows, t_calls, d_calls,
                                     n_layers, n_draft)
    if st["committed_tokens"] + len(done) != gen:
        problems.append(f"spec_stats committed {st['committed_tokens']} + "
                        f"{len(done)} first tokens != {gen} generated")
    ws = spec_window_stats(windows, spoiled)
    accept = st["accepted_draft_tokens"] / max(1, st["proposed_tokens"])
    if spec == "ragged":
        if t_calls["decode_token"] or t_calls["decode_window"]:
            problems.append(f"target calls besides prefill_chunk: {t_calls}")
        if any(n > 1 or (v and n != 1) for n, v in per_step):
            problems.append("a step made more than one target call, or a "
                            "verify round none")
        if t_rows["logits_rows"] != st["rounds"]:
            problems.append(f"{t_rows['logits_rows']} verify calls for "
                            f"{st['rounds']} rounds")
    elif t_calls["decode_window"] != st["rounds"]:
        problems.append(f"{t_calls['decode_window']} decode_window calls "
                        f"for {st['rounds']} rounds")
    if draft_layers is None and not spoil and accept < SPEC_SELF_ACCEPT_GATE:
        problems.append(f"self-draft accepted {accept:.3f} of its "
                        f"proposals < {SPEC_SELF_ACCEPT_GATE}")
    if (draft_layers is not None or spoil) and not ws["rollbacks"]:
        problems.append("no window was rolled back")
    if spoil and ws["n_acc_as_spoiled_share"] < SPEC_SELF_ACCEPT_GATE:
        problems.append(f"n_acc met the first spoiled position in "
                        f"{ws['n_acc_as_spoiled_share']:.3f} of the "
                        f"windows < {SPEC_SELF_ACCEPT_GATE}")
    for ad in (adapter, dadapter):
        for c in ad.caches:
            c.assert_ref_invariants()
        if any(c.num_free_pages != c.num_pages for c in ad.caches):
            problems.append("a pool did not drain")
    streams = {r: d.generated_ids for r, d in done.items()}
    vs_serve = None
    if base is not None:
        same = [a == b for r in streams
                for a, b in zip(streams[r], base["streams"][r])]
        vs_serve = {"same_token_share": sum(same) / len(same),
                    "identical_requests": sum(
                        streams[r] == base["streams"][r] for r in streams)}
    ttft = sorted((v[0] - t0) * 1e3 for v in tok_times.values())
    tpot = sorted((b - a) * 1e3 for v in tok_times.values()
                  for a, b in zip(v, v[1:]))
    target_calls = sum(t_calls.values())
    emit(run, model="llama3_8b", layers=n_layers,
         depth_cut=None if layers is None else
         f"{layers} of 32 layers (--layers)", draft_layers=n_draft,
         spec_decode=spec, draft_k=SPEC_K, spoiled_positions=len(spoiled),
         ragged_attention="auto", kv_cache_dtype="bfloat16",
         num_pages=SERVE_PAGES, draft_num_pages=SERVE_PAGES, page_size=16,
         max_batch_size=8, prefill_chunk_tokens=248,
         prompt_lens=prompt_lens, new_tokens=SPEC_SERVE_NEW, steps=steps,
         wall_s=wall, generated_tok_per_s=gen / wall,
         total_tok_per_s=(gen + sum(prompt_lens)) / wall,
         generated_tokens=gen, prompt_tokens=sum(prompt_lens),
         ttft_ms={"median": float(np.median(ttft)), "max": ttft[-1]},
         tpot_ms={"median": float(np.median(tpot)),
                  "p90": float(np.percentile(tpot, 90)), "n": len(tpot)},
         target_calls=t_calls, draft_calls=d_calls,
         generated_per_target_call=gen / max(1, target_calls),
         committed_per_round=st["committed_tokens"] / max(1, st["rounds"]),
         acceptance=accept, spec_stats=st, windows=ws,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches, oracle=oracle, cosine_gate=COSINE_GATE,
         acceptance_gate=SPEC_SELF_ACCEPT_GATE, versus_serve=vs_serve,
         problems=problems)
    if problems:
        raise RuntimeError(f"{run} phase failed: " + "; ".join(problems))
    return launches


def _kernel_class(name):
    n = name.lower()
    for key, cls in (("ragged_kernel", "paged_ragged_attention"),
                     ("decode_kernel", "paged_decode_attention"),
                     ("rms_norm_kernel", "rms_norm"),
                     ("flash_fwd", "flash_attention_fwd"),
                     ("flash_bwd_dkdv", "flash_attention_bwd_dkdv"),
                     ("flash_bwd_dq", "flash_attention_bwd_dq")):
        if key in n:
            return cls
    if "nvjet" in n or "gemm" in n or "cutlass" in n or "xmma" in n:
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    if "index" in n or "gather" in n or "scatter" in n or \
            "embedding" in n:
        return "index/gather/scatter"
    return "elementwise/other"


def device_summary(prof, wall_us):
    """Device time by kernel class (GPU kernel events only, so no time is
    counted twice under the op that launched it) and the busy share of
    ``wall_us``."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    device_us = sum(r[0] for r in rows)
    by_class = {}
    for us, key, _ in rows:
        c = _kernel_class(key)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": device_us / 1e3 if rows else "not measured",
        "device_busy_share": device_us / wall_us if rows else
        "not measured",
        "device_ms_by_class": by_class,
        "device_events": sum(n for _, _, n in rows),
        "htod_copies": sum(n for _, k, n in rows if "HtoD" in k),
        "top_device_ms": [[k[:90], round(us / 1e3, 4), n]
                          for us, k, n in rows[:15]]}


def profile_phase(adapter, prompts, phase="profile"):
    """Where a serving run's time goes: the same 8 requests served
    again under ``torch.profiler``; reports device time by kernel (GPU
    kernel events only, so no time is counted twice under the op that
    launched it) and the device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference import BatchScheduler, Request

    sched = BatchScheduler(adapter, max_batch_size=8,
                           prefill_chunk_tokens=248)
    for i, p in enumerate(prompts):
        sched.submit(Request(f"p{i}", p, max_new_tokens=32))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = 0
        while sched.num_active or sched.num_queued:
            sched.step()
            steps += 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit(phase, steps=steps, **device_summary(prof, wall_us))


# ------------------------------------------------------------- generation
# The dense-KV generation phases, on the served model's shape: hf_load
# (its weights through an HF-layout state dict into a fresh model), then
# greedy, sampled, beam and speculative decoding with the loaded model.
GEN_RUN_NAMES = ["hf_load", "generate", "generate_sample", "generate_beam",
                 "spec_generate"]
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 512, 64
SAMPLE_OPTS = {"do_sample": True, "temperature": 0.8, "top_k": 50,
               "top_p": 0.9, "repetition_penalty": 1.1}
BEAM_BATCH, BEAM_WIDTH, BEAM_NEW = 2, 4, 32
SPEC_NEW, SPEC_K, SPEC_DRAFT_LAYERS = 64, 4, 2
# The self-draft's acceptance gate: a draft that is the target itself
# proposes the target's own greedy tokens, so a proposal is rejected only
# where a bf16 near-tie flips between the 1-token draft step and the
# 5-token verify step (serve_prefix's same-token share across chunkings
# was 0.961 on an H100 80GB HBM3 at 700 W).
SPEC_SELF_ACCEPT_GATE = 0.8
# The share of positions whose proposal the spoiled self-draft replaces
# by its second choice: with draft_k 4 about a third of the windows hold
# no spoiled position and the rest are rejected at 0, 1, 2 or 3.
SPEC_SPOIL_SHARE = 0.25


def hf_state_of(model):
    """``model``'s weights as a HuggingFace checkpoint holds them: HF
    names, 2-D weights other than the embedding as [out, in], contiguous
    CPU tensors in the model's dtype."""
    out = {}
    for name, p in model.state_dict().items():
        t = p.t() if p.dim() == 2 and "embed_tokens" not in name else p
        out[name] = t.contiguous().cpu()
    return out


def hf_load_phase(served, seed):
    """Exports the served model's weights as an HF state dict, loads it
    with ``from_hf`` into a fresh ``LlamaForCausalLM`` drawn from another
    seed, and gates: every parameter equal to the served one bit for
    bit, and the rise of ``torch.cuda.max_memory_allocated`` during the
    load within twice the largest tensor. Returns the loaded model."""
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, from_hf

    t0 = time.perf_counter()
    state = hf_state_of(served)
    export_s = time.perf_counter() - t0
    fresh = LlamaForCausalLM(served.config, device=served.device,
                             dtype=served.dtype, seed=seed + 1)
    differed = not torch.equal(fresh.model.embed_tokens.weight,
                               served.model.embed_tokens.weight)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    from_hf(fresh, state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rise = torch.cuda.max_memory_allocated() - before
    largest = max(t.numel() * t.element_size() for t in state.values())
    served_params = served.state_dict()
    unequal = [n for n, p in fresh.state_dict().items()
               if not torch.equal(p, served_params[n])]
    problems = []
    if not differed:
        problems.append("the fresh model's embedding equals the served one "
                        "before the load")
    if unequal:
        problems.append(f"{len(unequal)} parameters differ after the load: "
                        f"{unequal[:4]}")
    if rise > 2 * largest:
        problems.append(f"device memory rose {rise} bytes during the load, "
                        f"> twice the largest tensor ({largest})")
    emit("hf_load", tensors=len(state),
         bytes=sum(t.numel() * t.element_size() for t in state.values()),
         export_s=export_s, load_s=load_s, memory_rise_bytes=rise,
         largest_tensor_bytes=largest, unequal=len(unequal),
         problems=problems)
    if problems:
        raise RuntimeError("hf_load phase failed: " + "; ".join(problems))
    return fresh


def record_decode_steps(model, window_argmax=False):
    """Wraps ``model.decode_step`` (an instance attribute: ``del
    model.decode_step`` restores the method) to keep, per call, its
    position, its input ids, the float32 logits of the last position,
    with ``window_argmax`` the argmax of every position (taken on the
    model's own logits: the first maximum either way) and CUDA events
    around the call."""
    import torch

    calls = []
    step = model.decode_step

    def recording(input_ids, caches, pos):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, caches = step(input_ids, caches, pos)
        end.record()
        calls.append({"pos": int(pos), "ids": input_ids,
                      "last": logits[:, -1].float(),
                      "argmax": (logits.argmax(-1) if window_argmax
                                 else None),
                      "events": (start, end)})
        return logits, caches

    model.decode_step = recording
    return calls


def gen_prompts(seed, vocab, device):
    """GEN_BATCH prompts of GEN_PROMPT tokens uniform over the vocab."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed + 7)
    return torch.from_numpy(rng.randint(0, vocab, size=(
        GEN_BATCH, GEN_PROMPT))).to(device)


def rms_launch_problems(launches, want):
    """The RMSNorm launch count against ``want``; any other kernel's
    launches are a problem too (the dense path runs only #1)."""
    problems = [f"{k} launches {v}" for k, v in launches.items()
                if k != "rms_norm" and v]
    if launches.get("rms_norm", 0) != want:
        problems.append(f"rms_norm launches {launches.get('rms_norm', 0)} "
                        f"!= {want}")
    return problems


def oracle_rows(model, out, rows, s0, n):
    """The float32 oracle's logits at the n positions that produced the
    generated tokens out[r, s0:s0 + n] of each row r: [len(rows), n, V]."""
    import torch
    from paddle_tpu_torch.testing import dense_reference_logits

    positions = list(range(s0 - 1, s0 + n - 1))
    return torch.stack([dense_reference_logits(
        model, out[r, :s0 + n - 1], positions=positions)[0] for r in rows])


def oracle_scores(ref, tokens):
    """Teacher-forced sums of log-probabilities: ref [R, n, V] float32
    oracle logits, tokens [R, n]."""
    import torch

    lp = torch.log_softmax(ref, dim=-1)
    return lp.gather(-1, tokens.long()[..., None])[..., 0].sum(-1)


def generate_run(model, prompts):
    """Greedy generate: GEN_BATCH prompts, GEN_NEW new tokens, each
    step's logits recorded. Gates: every token the argmax of its own
    step's logits; at every generated position of rows 0 and 1 the
    served logits against the float32 oracle, cosine >= COSINE_GATE;
    exactly 2 L + 1 RMSNorm launches a step. Returns the output, the
    oracle's logits of rows 0 and 1 and the launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import generate
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats

    n_layers = model.config.num_hidden_layers
    generate(model, prompts[:, :16], max_new_tokens=2)  # warm-up
    calls = record_decode_steps(model)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel_launch_stats(reset=True)
        t0 = time.perf_counter()
        out = generate(model, prompts, max_new_tokens=GEN_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launch_stats(reset=True)
    finally:
        del model.decode_step
    peak = torch.cuda.max_memory_allocated()
    s0 = prompts.shape[1]
    new = out[:, s0:]
    step_ms = [c["events"][0].elapsed_time(c["events"][1]) for c in calls]
    problems = rms_launch_problems(launches, (2 * n_layers + 1) * GEN_NEW)
    picks = torch.stack([c["last"].argmax(-1) for c in calls], dim=1)
    if not torch.equal(picks, new.long()):
        problems.append(f"{int((picks != new).sum())} tokens are not the "
                        "argmax of their step's logits")
    ref = oracle_rows(model, out, (0, 1), s0, GEN_NEW)
    served = torch.stack([c["last"][:2] for c in calls], dim=1)
    cos = torch.nn.functional.cosine_similarity(served, ref, dim=-1)
    if float(cos.min()) < COSINE_GATE:
        problems.append(f"min cosine {float(cos.min()):.6f} < {COSINE_GATE}")
    emit("generate", batch=GEN_BATCH, prompt=s0, new_tokens=GEN_NEW,
         layers=n_layers, wall_s=wall,
         generated_tok_per_s=GEN_BATCH * GEN_NEW / wall,
         prefill_step_ms=step_ms[0],
         decode_step_ms={"median": float(np.median(step_ms[1:])),
                         "p90": float(np.percentile(step_ms[1:], 90)),
                         "max": max(step_ms[1:])},
         max_memory_allocated=peak, launches=launches,
         min_cosine=float(cos.min()), mean_cosine=float(cos.mean()),
         cosine_gate=COSINE_GATE,
         oracle_argmax_share=float((served.argmax(-1) == ref.argmax(-1))
                                   .float().mean()),
         problems=problems)
    if problems:
        raise RuntimeError("generate phase failed: " + "; ".join(problems))
    return out, ref, launches


def generate_profile_phase(model, prompts, new_tokens=16):
    """Where a greedy decode step's time goes: one ``generate`` of
    ``new_tokens`` on the GEN_BATCH prompts under ``torch.profiler``
    from its first decode step on (the prefill step runs before the
    profiler starts); device time by kernel class, the busy share and
    the device events a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.models import generate

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    step = model.decode_step
    started = []

    def profiled(input_ids, caches, pos):
        if not started and int(pos) > 0:
            torch.cuda.synchronize()
            prof.start()
            started.append(time.perf_counter())
        return step(input_ids, caches, pos)

    model.decode_step = profiled
    try:
        generate(model, prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - started[0]) * 1e6
        prof.stop()
    finally:
        del model.decode_step
    steps = new_tokens - 1
    summary = device_summary(prof, wall_us)
    emit("generate_profile", decode_steps=steps,
         step_ms=wall_us / 1e3 / steps,
         device_events_per_step=summary["device_events"] / steps, **summary)


def generate_sample_run(model, prompts, seed):
    """Sampled generate (SAMPLE_OPTS) twice from one seeded generator.
    Gates: equal tokens; every drawn token inside the support of the
    filters applied to its own step's penalised, tempered logits."""
    import torch
    from paddle_tpu_torch.models import generate
    from paddle_tpu_torch.models.generation import (
        _apply_repetition_penalty, _filter_top_k_top_p)
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats

    n_layers = model.config.num_hidden_layers
    outs, walls = [], []
    calls = record_decode_steps(model)
    try:
        for _ in range(2):
            calls.clear()
            gen = torch.Generator(device=model.device).manual_seed(seed)
            torch.cuda.synchronize()
            kernel_launch_stats(reset=True)
            t0 = time.perf_counter()
            outs.append(generate(model, prompts, max_new_tokens=GEN_NEW,
                                 generator=gen, **SAMPLE_OPTS))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = kernel_launch_stats(reset=True)
    finally:
        del model.decode_step
    out, s0 = outs[1], prompts.shape[1]
    problems = rms_launch_problems(launches, (2 * n_layers + 1) * GEN_NEW)
    if not torch.equal(outs[0], outs[1]):
        problems.append("two runs from one seed differ")
    outside, support = 0, []
    for i, c in enumerate(calls):
        seen = torch.zeros_like(c["last"], dtype=torch.bool)
        seen.scatter_(1, out[:, :s0 + i].long(), True)
        lg = _apply_repetition_penalty(c["last"], seen,
                                       SAMPLE_OPTS["repetition_penalty"])
        lg = _filter_top_k_top_p(lg / SAMPLE_OPTS["temperature"],
                                 SAMPLE_OPTS["top_k"], SAMPLE_OPTS["top_p"])
        outside += int((~torch.isfinite(
            lg.gather(1, out[:, s0 + i].long()[:, None]))).sum())
        support.append(torch.isfinite(lg).sum(-1).float())
    support = torch.stack(support)
    if outside:
        problems.append(f"{outside} drawn tokens lie outside their step's "
                        "filtered support")
    emit("generate_sample", batch=GEN_BATCH, prompt=s0, new_tokens=GEN_NEW,
         options=SAMPLE_OPTS, wall_s=walls,
         generated_tok_per_s=[GEN_BATCH * GEN_NEW / w for w in walls],
         support_size={"min": float(support.min()),
                       "mean": float(support.mean()),
                       "max": float(support.max())},
         distinct_tokens=int(out[:, s0:].unique().numel()),
         launches=launches, problems=problems)
    if problems:
        raise RuntimeError("generate_sample phase failed: "
                           + "; ".join(problems))
    return launches


# The generate_beam gate, derived from bf16 spacing alone: the best
# beam's kept score is a float32 sum of BEAM_NEW log-probabilities taken
# from bf16 logits. Each term's logit and its log-sum-exp may each be off
# by up to one bf16 spacing of the logits' scale (BF16_ULP times the RMS
# of the oracle's logits at those positions), so the kept score may
# differ from the float32 oracle's re-score of the same tokens by up to
# 2 * BF16_ULP * rms per token, summed over the beam's tokens.
BEAM_SCORE_SPACINGS_PER_TOKEN = 2


def generate_beam_run(model, prompts, greedy_ref, greedy_out):
    """Beam search (BEAM_BATCH prompts, BEAM_WIDTH beams, BEAM_NEW
    tokens). Gate: each row's best beam's kept score (read from
    ``generation._best_beam``) against its float32-oracle re-score
    within the tolerance above. Reports greedy's oracle score of the
    same prompts beside it (from the generate run)."""
    import torch
    from paddle_tpu_torch.models import generate, generation
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats

    n_layers = model.config.num_hidden_layers
    p2 = prompts[:BEAM_BATCH]
    s0 = p2.shape[1]
    kept = {}
    best_beam = generation._best_beam

    def recording_best_beam(*args, **kwargs):
        toks, scores = best_beam(*args, **kwargs)
        kept["tokens"], kept["scores"] = toks, scores
        return toks, scores

    generation._best_beam = recording_best_beam
    try:
        torch.cuda.synchronize()
        kernel_launch_stats(reset=True)
        t0 = time.perf_counter()
        out = generate(model, p2, max_new_tokens=BEAM_NEW,
                       num_beams=BEAM_WIDTH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launch_stats(reset=True)
    finally:
        generation._best_beam = best_beam
    problems = rms_launch_problems(launches, (2 * n_layers + 1) * BEAM_NEW)
    if not torch.equal(kept["tokens"], out[:, s0:]):
        problems.append("the returned beams are not the kept ones")
    ref = oracle_rows(model, out, range(BEAM_BATCH), s0, BEAM_NEW)
    oracle = oracle_scores(ref, out[:, s0:])
    rms = ref.pow(2).mean(dim=(1, 2)).sqrt()
    tol = BEAM_SCORE_SPACINGS_PER_TOKEN * BF16_ULP * rms * BEAM_NEW
    err = (kept["scores"].float() - oracle).abs()
    if not bool((err <= tol).all()):
        problems.append(f"kept scores {kept['scores'].tolist()} against the "
                        f"oracle's {oracle.tolist()}: error {err.tolist()} > "
                        f"{tol.tolist()}")
    greedy = oracle_scores(greedy_ref[:BEAM_BATCH, :BEAM_NEW],
                           greedy_out[:BEAM_BATCH, s0:s0 + BEAM_NEW])
    emit("generate_beam", batch=BEAM_BATCH, beams=BEAM_WIDTH, prompt=s0,
         new_tokens=BEAM_NEW, wall_s=wall,
         generated_tok_per_s=BEAM_BATCH * BEAM_NEW / wall,
         kept_score=kept["scores"].tolist(), oracle_score=oracle.tolist(),
         score_err=err.tolist(), score_tol=tol.tolist(),
         oracle_logit_rms=rms.tolist(),
         greedy_oracle_score=greedy.tolist(),
         same_as_greedy_share=float((out[:, s0:] == greedy_out[
             :BEAM_BATCH, s0:s0 + BEAM_NEW]).float().mean()),
         launches=launches, problems=problems)
    if problems:
        raise RuntimeError("generate_beam phase failed: "
                           + "; ".join(problems))
    return launches


def layer_skip_draft(target, n_layers):
    """A draft model made of the target's own modules: its embedding, its
    first ``n_layers`` decoder layers, its final norm and head (no weight
    is copied). With every layer it is the target itself."""
    import dataclasses

    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, LlamaModel

    cfg = dataclasses.replace(target.config, num_hidden_layers=n_layers)
    trunk = LlamaModel.__new__(LlamaModel)
    torch.nn.Module.__init__(trunk)
    trunk.config = cfg
    trunk.embed_tokens = target.model.embed_tokens
    trunk.layers = torch.nn.ModuleList(list(target.model.layers)[:n_layers])
    trunk.norm = target.model.norm
    draft = LlamaForCausalLM.__new__(LlamaForCausalLM)
    torch.nn.Module.__init__(draft)
    draft.config = cfg
    draft.model = trunk
    draft.lm_head = target.lm_head
    return draft


def spoil_proposals(draft, spoiled):
    """Wraps ``draft.decode_step`` so that its proposal for each position
    in ``spoiled`` is its second choice: the row that predicts such a
    position has its own argmax masked to -inf."""
    step = draft.decode_step

    def spoiling(input_ids, caches, pos):
        logits, caches = step(input_ids, caches, pos)
        if int(pos) + input_ids.shape[1] in spoiled:
            last = logits[:, -1]
            last.scatter_(1, last.argmax(-1, keepdim=True), float("-inf"))
        return logits, caches

    draft.decode_step = spoiling


def spec_generate_run(model, prompts, greedy_out, seed):
    """Greedy speculative decoding of prompt 0 (SPEC_NEW tokens, draft_k
    SPEC_K) with three drafts: a layer-skip draft of SPEC_DRAFT_LAYERS
    layers, a self-draft, and a spoiled self-draft whose proposals for a
    seeded SPEC_SPOIL_SHARE of the positions are its second choice, so
    that windows are rejected in mid-window. Gates: every committed
    token the argmax of the target logits row that committed it; the
    self-draft accepting at least SPEC_SELF_ACCEPT_GATE of its
    proposals; the spoiled self-draft with at least one window of
    0 < n_acc < draft_k and, in at least SPEC_SELF_ACCEPT_GATE of its
    windows, n_acc equal to the index of the window's first spoiled
    position (draft_k where none is); RMSNorm launches 2 L + 1 a target
    call and 2 L_draft + 1 a draft call. Returns the launches of all
    runs."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import speculative_generate
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats

    cfg = model.config
    p1 = prompts[:1]
    s0 = p1.shape[1]
    drafts = {"layer_skip": min(SPEC_DRAFT_LAYERS, cfg.num_hidden_layers),
              "self": cfg.num_hidden_layers,
              "self_spoiled": cfg.num_hidden_layers}
    rng = np.random.RandomState(seed + 11)
    spoiled = {p for p in range(s0 + 1, s0 + SPEC_NEW + SPEC_K + 1)
               if rng.rand() < SPEC_SPOIL_SHARE}
    results, problems, total = {}, [], {}
    for name, n_draft in drafts.items():
        draft = layer_skip_draft(model, n_draft)
        if name == "self_spoiled":
            spoil_proposals(draft, spoiled)
        draft_calls = []
        draft_step = draft.decode_step

        def counting(input_ids, caches, pos, draft_step=draft_step,
                     draft_calls=draft_calls):
            draft_calls.append(input_ids.shape[1])
            return draft_step(input_ids, caches, pos)

        draft.decode_step = counting
        calls = record_decode_steps(model, window_argmax=True)
        try:
            torch.cuda.synchronize()
            kernel_launch_stats(reset=True)
            t0 = time.perf_counter()
            out, stats = speculative_generate(
                model, draft, p1, max_new_tokens=SPEC_NEW, draft_k=SPEC_K,
                return_stats=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_launch_stats(reset=True)
        finally:
            del model.decode_step
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        want = (2 * cfg.num_hidden_layers + 1) * len(calls) \
            + (2 * n_draft + 1) * len(draft_calls)
        problems += [f"{name}: {p}" for p in rms_launch_problems(launches,
                                                                 want)]
        # the target's argmax for each position, from the row that
        # predicted it (a later window starts at the last committed token)
        pred = {}
        accepted = proposed = as_spoiled = 0
        n_acc_hist = [0] * (SPEC_K + 1)
        for c in calls:
            am = c["argmax"][0].tolist()
            for j, t in enumerate(am):
                pred[c["pos"] + j + 1] = t
            if c["pos"] > 0:
                props = c["ids"][0, 1:].tolist()
                n_acc = 0
                while n_acc < len(props) and props[n_acc] == am[n_acc]:
                    n_acc += 1
                accepted += n_acc
                proposed += len(props)
                n_acc_hist[n_acc] += 1
                first = next((j for j in range(len(props))
                              if c["pos"] + 1 + j in spoiled), len(props))
                as_spoiled += n_acc == first
        windows = sum(n_acc_hist)
        toks = out[0, s0:].tolist()
        wrong = sum(t != pred.get(s0 + i) for i, t in enumerate(toks))
        if wrong or len(toks) != SPEC_NEW:
            problems.append(f"{name}: {wrong} of {len(toks)} committed "
                            "tokens are not the target's argmax")
        accept = accepted / max(1, proposed)
        if name == "self" and accept < SPEC_SELF_ACCEPT_GATE:
            problems.append(f"self-draft accepted {accept:.3f} of its "
                            f"proposals < {SPEC_SELF_ACCEPT_GATE}")
        results[name] = {
            "draft_layers": n_draft, "wall_s": wall,
            "generated_tok_per_s": len(toks) / wall,
            "target_calls": stats["target_calls"],
            "tokens_per_target_call": stats["tokens_per_target_call"],
            "draft_calls": len(draft_calls), "acceptance": accept,
            "n_acc_hist": n_acc_hist,
            "same_as_greedy_share": float((out[0, s0:] == greedy_out[
                0, s0:s0 + SPEC_NEW]).float().mean()),
            "launches": launches}
        if name == "self_spoiled":
            share = as_spoiled / max(1, windows)
            results[name].update(spoiled_positions=len(spoiled),
                                 n_acc_as_spoiled_share=share)
            if not any(n_acc_hist[1:SPEC_K]):
                problems.append("self_spoiled: no window was rejected in "
                                f"mid-window (n_acc histogram {n_acc_hist})")
            if share < SPEC_SELF_ACCEPT_GATE:
                problems.append(f"self_spoiled: n_acc met the first spoiled "
                                f"position in {share:.3f} of the windows < "
                                f"{SPEC_SELF_ACCEPT_GATE}")
    emit("spec_generate", prompt=s0, new_tokens=SPEC_NEW, draft_k=SPEC_K,
         acceptance_gate=SPEC_SELF_ACCEPT_GATE, spoil_share=SPEC_SPOIL_SHARE,
         drafts=results, problems=problems)
    if problems:
        raise RuntimeError("spec_generate phase failed: "
                           + "; ".join(problems))
    return total


def gen_phase(served, seed, names=None):
    """hf_load, then the generation runs on the loaded model (and,
    without ``names``, ``generate_profile`` after ``generate``). Returns
    ``({run: launches}, failed)``. With ``names`` only those runs go, a
    failed run is listed in ``failed`` and the others go on
    (``--gen-runs``; after a failed hf_load they run on the served
    model, after a failed generate the runs that read its output are
    skipped); without it the first failure raises."""
    out, failed = {}, []

    def attempt(run, fn):
        if names is not None and run not in names:
            return None
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 (recorded, not swallowed)
            if names is None:
                raise
            failed.append({"run": run, "error": repr(e)[-600:]})
            return None

    model = attempt("hf_load", lambda: hf_load_phase(served, seed))
    if model is None:
        model = served
    prompts = gen_prompts(seed, model.config.vocab_size, model.device)
    greedy = attempt("generate", lambda: generate_run(model, prompts))
    if names is None:
        generate_profile_phase(model, prompts)
    out["generate_sample"] = attempt(
        "generate_sample", lambda: generate_sample_run(model, prompts, seed))
    if greedy is not None:
        greedy_out, greedy_ref, out["generate"] = greedy
        out["generate_beam"] = attempt("generate_beam", lambda:
                                       generate_beam_run(model, prompts,
                                                         greedy_ref,
                                                         greedy_out))
        out["spec_generate"] = attempt("spec_generate", lambda:
                                       spec_generate_run(model, prompts,
                                                         greedy_out, seed))
    return {k: v for k, v in out.items() if v is not None}, failed


# ------------------------------------------------------------------ train
PEAK_BF16_TFLOPS = PEAK_FLOPS_PER_S["bfloat16"] / 1e12


def build_trainer(seed):
    """Qwen2-0.5B at full width and depth (fused CE head) in bf16 on the
    card and its AdamW, as ``bench.py``'s headline trains
    ``llama_headline``."""
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, qwen2_0_5b
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(qwen2_0_5b(fused_head_loss=True),
                             device="cuda", dtype=torch.bfloat16, seed=seed)
    opt = AdamW(3e-4, parameters=model.parameters(), multi_precision=True)
    return model, opt


def train_batch(cfg):
    """bench.py's data: random ids from RandomState(0), one batch reused
    on every step."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    x = rng.randint(0, cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ))
    y = rng.randint(0, cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ))
    return (torch.from_numpy(x.astype("int32")).cuda(),
            torch.from_numpy(y.astype("int64")).cuda())


def train_step(model, opt, x, y):
    """bench.py's step: forward with labels, backward, AdamW, clear."""
    _, loss = model(x, y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def train_check_phase(model, opt, x, y):
    """The loss and every parameter's gradient of one 2048-token sequence
    of the batch, bf16 on the kernels, against the float32 oracle."""
    import torch
    from paddle_tpu_torch.testing import dense_reference_loss_and_grads

    x1, y1 = x[:1], y[:1]
    _, loss = model(x1, y1)
    loss.backward()
    loss = loss.detach()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_loss, ref_grads = dense_reference_loss_and_grads(model, x1, y1)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    per_param = {}
    for name, p in model.named_parameters():
        g, r = p.grad.float().flatten(), ref_grads.pop(name).flatten()
        per_param[name] = (
            float(torch.nn.functional.cosine_similarity(g, r, dim=0)),
            float((g - r).norm() / r.norm().clamp_min(1e-30)))
    opt.clear_grad()
    del ref_grads
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst = min(per_param, key=lambda n: per_param[n][0])
    problems = []
    if not loss_rel <= TRAIN_LOSS_REL_GATE:
        problems.append(f"loss relative error {loss_rel:.3e} > "
                        f"{TRAIN_LOSS_REL_GATE}")
    if not per_param[worst][0] >= TRAIN_GRAD_COS_GATE:
        problems.append(f"{worst}: gradient cosine "
                        f"{per_param[worst][0]:.6f} < {TRAIN_GRAD_COS_GATE}")
    by_cos = sorted(per_param.items(), key=lambda kv: kv[1][0])
    emit("train_check", tokens=int(x1.numel()), loss=float(loss),
         oracle_loss=float(ref_loss), loss_rel_err=loss_rel,
         loss_rel_gate=TRAIN_LOSS_REL_GATE, params=len(per_param),
         worst_param=worst, worst_cosine=per_param[worst][0],
         worst_rel_err=per_param[worst][1],
         max_rel_err=max(v[1] for v in per_param.values()),
         cosine_gate=TRAIN_GRAD_COS_GATE,
         lowest_cosines=[[n, c, r] for n, (c, r) in by_cos[:6]],
         oracle_s=oracle_s, problems=problems)
    if problems:
        raise RuntimeError("train_check phase failed: "
                           + "; ".join(problems))


def train_phase(model, opt, x, y):
    """bench.py's loop: 2 warm-up steps, then TRAIN_STEPS timed ones with
    the launch counters reset just before and read just after."""
    import torch
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats

    cfg = model.config
    steps = TRAIN_STEPS
    for _ in range(2):
        train_step(model, opt, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(steps + 1)]
    losses = []
    kernel_launch_stats(reset=True)
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        losses.append(train_step(model, opt, x, y))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launch_stats(reset=True)
    losses = [float(v) for v in losses]
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_per_s = tokens * steps / wall
    n_params = cfg.num_params()
    # bench.py's FLOP count: 6 N per token plus attention's 6 L H S
    flops_per_token = 6.0 * n_params + 6.0 * cfg.num_hidden_layers \
        * cfg.hidden_size * TRAIN_SEQ
    model_tflops = tok_per_s * flops_per_token / 1e12
    n_layers = cfg.num_hidden_layers
    want = {name: n_layers * steps for name in FLASH}
    want["rms_norm"] = (2 * n_layers + 1) * steps
    problems = [f"{name} launches {launches.get(name, 0)} != {n}"
                for name, n in want.items() if launches.get(name, 0) != n]
    if not all(v == v and abs(v) != float("inf") for v in losses):
        problems.append(f"a loss is not finite: {losses}")
    elif not losses[-1] < losses[0]:
        problems.append(f"the loss did not fall: {losses}")
    emit("train", model="qwen2_0_5b", layers=n_layers,
         hidden=cfg.hidden_size, intermediate=cfg.intermediate_size,
         heads=cfg.num_attention_heads,
         kv_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
         vocab=cfg.vocab_size, params=n_params,
         params_counted=sum(p.numel() for p in model.parameters()),
         dtype="bfloat16", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         optimizer="AdamW(3e-4, multi_precision=True)",
         fused_head_loss=True, steps=steps, wall_s=wall,
         step_ms_host=wall * 1e3 / steps, step_ms_device=step_ms,
         tokens_per_s=tok_per_s, flops_per_step=flops_per_token * tokens,
         model_tflops=model_tflops,
         mfu_pct=100.0 * model_tflops / PEAK_BF16_TFLOPS,
         peak_tflops=PEAK_BF16_TFLOPS,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         losses=losses, launches=launches, launches_wanted=want,
         problems=problems)
    if problems:
        raise RuntimeError("train phase failed: " + "; ".join(problems))
    return launches


def train_profile_phase(model, opt, x, y):
    """One training step under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit("train_profile", steps=1, **device_summary(prof, wall_us))


# Gates of the train_check phase, the bf16 step on the kernels against
# the float32 oracle on one 2048-token sequence of Qwen2-0.5B. bf16
# rounds every activation and the kernels round p and ds, so the loss
# and the gradients differ from float32 by rounding alone. On an H100
# (700 W) the first run measured a loss error of 1.9e-6 relative and a
# lowest gradient cosine of 0.99931 (a k_proj bias, whose gradient sums
# dK over all 2048 positions) over the 290 parameters: the gates leave
# 50x headroom on the loss and 7x on 1 - cosine.
TRAIN_LOSS_REL_GATE = 1e-4
TRAIN_GRAD_COS_GATE = 0.995

# Served bf16 logits against the float32 oracle, per sampled position.
# The served path rounds every activation to bf16 (2^-9 relative) through
# 32 layers; on an H100 (700 W) the lowest cosine measured over 64
# positions was 0.99993, so 0.999 leaves 10x headroom in 1 - cosine for
# rounding alone. Top-1 agreement is reported, not gated: random
# weights give near-ties.
COSINE_GATE = 0.999
# The int8 runs' gate: int8 K/V codes add each page's quantization error
# (up to half a code, 1/254 of the page's absmax per head) to the bf16
# rounding. On an H100 (700 W) the lowest cosine of the first reading
# was 0.999724 (serve_int8 and serve_off_int8, 64 positions each), so
# 0.997 leaves 10x headroom in 1 - cosine, as COSINE_GATE does.
INT8_COSINE_GATE = 0.997


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the served model's depth (never its width)")
    ap.add_argument("--flash-cases", default=None, metavar="NAMES",
                    help="only build and hold these flash cases "
                    "(comma-separated names of FLASH_CASES and "
                    "VARLEN_CASES) against their plain versions")
    ap.add_argument("--attn-cases", default=None, metavar="NAMES",
                    help="only build and hold these paged attention "
                    "cases (comma-separated names of ATTN_CASES, in "
                    "whichever kernel has them) against their plain "
                    "versions")
    ap.add_argument("--norm-cases", default=None, metavar="NAMES",
                    help="only build and hold these rms_norm and "
                    "layer_norm_fused cases (comma-separated names of "
                    "NORM_CASES) against their plain versions")
    ap.add_argument("--fault-check", action="store_true",
                    help="only show that the gates fail each fault of "
                    "FLASH_FAULTS, PAGED_FAULTS, NORM_FAULTS, SERVE_FAULTS, "
                    "SPEC_FAULTS, PLANE_FAULTS and GEN_FAULTS, planted in "
                    "a copy")
    ap.add_argument("--serve-runs", default=None, metavar="NAMES",
                    help="only build the kernels and serve these runs "
                    "(comma-separated names of SERVE_RUN_NAMES), "
                    "unprofiled, each failure listed")
    ap.add_argument("--gen-runs", default=None, metavar="NAMES",
                    help="only build the kernels and run these generation "
                    "runs (comma-separated names of GEN_RUN_NAMES) on the "
                    "served model, each failure listed")
    ap.add_argument("--serve-ab", default=None, metavar="DIR",
                    help="only serve the `serve` run from the checkout "
                    "DIR and from this one in turns (DIR, this, this, "
                    "DIR), each in a child process")
    ap.add_argument("--ablations", default=None, metavar="NAMES",
                    help="only time the cases of these ABLATIONS "
                    "(comma-separated names, or 'all') in a changed "
                    "and an unchanged copy")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "check runs on a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside the repository)
    from paddle_tpu_torch.ops.kernels import _build

    smi = nvidia_smi_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         varlen_attn=importlib.util.find_spec(
             "torch.nn.attention.varlen") is not None)
    if args.fault_check:
        fault_check_phase()
        return 0
    if args.ablations:
        ablations_phase(None if args.ablations == "all"
                        else args.ablations.split(","))
        return 0
    if args.serve_ab:
        serve_ab_phase(args.serve_ab, args.seed, args.layers)
        return 0

    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    sass = sass_summary(_build.library_path)
    emit("build", seconds=seconds, compiled=_build.build_seconds is not None,
         nvcc_flags=" ".join(_build.NVCC_FLAGS),
         sources=list(_build.SOURCES), warnings=_build.build_warnings,
         wgmma_sass={k: v for k, v in (sass or {}).items()
                     if "_wgmma<" in k},
         norm_sass={k: {"registers": v.get("registers"),
                        "stack": v.get("stack")}
                    for k, v in (sass or {}).items() if "_wgmma<" not in k})
    scalar = [k for k, v in (sass or {}).items()
              if "_wgmma<" in k and not v["hgmma"]]
    if scalar:
        raise RuntimeError(f"wgmma kernels without HGMMA: {scalar}")
    if args.flash_cases:
        names = args.flash_cases.split(",")
        known = {c[0] for c in FLASH_CASES + VARLEN_CASES}
        if set(names) - known:
            raise ValueError(f"unknown flash cases {set(names) - known}")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        flash = {**flash_cases(flush, names), **varlen_cases(flush, names)}
        bad = [f"{k}:{c['case']}" for k, cs in flash.items() for c in cs
               if not c["ok"]]
        emit("flash_cases", failed=bad, kernels=[
            {"name": k, "cases": v} for k, v in flash.items() if v])
        return 1 if bad else 0
    if args.attn_cases:
        names = args.attn_cases.split(",")
        known = {c[1] for c in ATTN_CASES}
        if set(names) - known:
            raise ValueError(f"unknown attention cases {set(names) - known}")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        attn = attn_cases(flush, names)
        bad = [f"{k}:{c['case']}" for k, cs in attn.items() for c in cs
               if not c["ok"]]
        emit("attn_cases", failed=bad, kernels=[
            {"name": k, "cases": v} for k, v in attn.items() if v])
        return 1 if bad else 0
    if args.norm_cases:
        names = args.norm_cases.split(",")
        known = {c[1] for c in NORM_CASES}
        if set(names) - known:
            raise ValueError(f"unknown norm cases {set(names) - known}")
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        norm = norm_cases(flush, names)
        bad = [f"{k}:{c['case']}" for k, cs in norm.items() for c in cs
               if not c["ok"]]
        emit("norm_cases", failed=bad, kernels=[
            {"name": k, "cases": v} for k, v in norm.items() if v])
        return 1 if bad else 0

    if args.serve_runs:
        names = args.serve_runs.split(",")
        if set(names) - set(SERVE_RUN_NAMES):
            raise ValueError(f"unknown serve runs "
                             f"{set(names) - set(SERVE_RUN_NAMES)}")
        model, prompts, init_s = build_server(args.seed, args.layers)
        _, failed = serve_phase(model, prompts, init_s, args.seed,
                                args.layers, names)
        emit("serve_runs", runs=names, failed=[f["run"] for f in failed],
             errors=failed)
        return 1 if failed else 0
    if args.gen_runs:
        names = args.gen_runs.split(",")
        if set(names) - set(GEN_RUN_NAMES):
            raise ValueError(f"unknown generation runs "
                             f"{set(names) - set(GEN_RUN_NAMES)}")
        model, _, _ = build_server(args.seed, args.layers)
        _, failed = gen_phase(model, args.seed, names)
        emit("gen_runs", runs=names, failed=[f["run"] for f in failed],
             errors=failed)
        return 1 if failed else 0

    cases = kernels_phase()
    varlen_launches = varlen_phase(args.seed)
    ln_launches = layer_norm_phase()
    torch.cuda.empty_cache()
    model, prompts, init_s = build_server(args.seed, args.layers)
    serve_launches, _ = serve_phase(model, prompts, init_s, args.seed,
                                    args.layers)
    torch.cuda.empty_cache()
    gen_launches, _ = gen_phase(model, args.seed)
    del model
    torch.cuda.empty_cache()

    model, opt = build_trainer(args.seed)
    x, y = train_batch(model.config)
    train_check_phase(model, opt, x, y)
    train_launches = train_phase(model, opt, x, y)
    train_profile_phase(model, opt, x, y)

    def case_times(c):
        return {"case": c["case"], "ms": c["kernel_ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"]}

    def summary(name, main_case, beside=()):
        c = next(x for x in cases[name] if x["case"] == main_case)
        by_path = {path: launches[name] for path, launches in
                   (*serve_launches.items(), *gen_launches.items(),
                    ("train", train_launches),
                    ("varlen", varlen_launches),
                    ("layer_norm", ln_launches))
                   if launches.get(name)}
        return {"name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1],
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": max(x["max_abs_err"] for x in cases[name]),
                "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"], "case": main_case,
                **({"beside": [case_times(x) for x in cases[name]
                               if x["case"] in beside]} if beside else {})}

    # rms_norm: the serving chunk's case, and the training width's beside
    kernels = [summary("rms_norm", "rows256", beside=("rows16384",)),
               summary("layer_norm_fused", "rows16384_h768"),
               summary("paged_ragged_attention", "mixed",
                       beside=("verify", "verify_int8")),
               summary("paged_decode_attention", "decode")] + [
        summary(name, "train") for name in FLASH] + [
        summary(name, "varlen_train") for name in VARLEN]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise RuntimeError(f"kernels never launched on their path: {idle}")
    emit("wall", seconds=wall_seconds(t_start),
         total_s=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
