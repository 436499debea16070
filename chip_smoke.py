#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py [--seed N] [--layers N]

It prints one JSON line per phase:

1. ``env``: torch / CUDA versions and the card (``nvidia-smi`` name and
   power limit);
2. ``build``: builds the hand-written CUDA kernels from
   ``paddle_tpu_torch/ops/kernels/csrc`` and reports the seconds taken;
3. ``kernels``: calls each kernel's wrapper at the serving path's shapes
   and holds the result against its plain PyTorch version on the same
   inputs (tolerances below), with the kernel, plain and library
   (``torch.nn.functional.rms_norm``, ``scaled_dot_product_attention``;
   timed only, never used by the port) times and the kernel's bound;
4. ``serve``: serves 8 requests on Llama-3-8B's published shape (random
   bf16 weights from the seed) through ``BatchScheduler`` ->
   ``PagedLlamaAdapter`` -> the paged KV pool, with the kernel launch
   counters reset just before and read just after, and holds the served
   logits of two requests against the dense float32 oracle
   (``paddle_tpu_torch.testing.dense_reference_logits``);
5. ``profile``: a short serve under ``torch.profiler``: device time by
   kernel and the device's busy share of the wall.

Then, on lines of their own: the ``nvidia-smi`` name and power limit,
the per-kernel summary ``{"kernels": [...]}``, and last
``{"ok": true, "device": {...}}``. Any failed phase raises, and the
script exits non-zero without the last line. Without CUDA it exits 2
before doing anything.
"""
from __future__ import annotations

import argparse
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

# the port's kernels: name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "rms_norm": ("paddle_tpu_torch/ops/kernels/csrc/rms_norm.cu",
                 "paddle_tpu/ops/kernels/rms_norm.py:32"),
    "paged_ragged_attention": (
        "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
        "paddle_tpu/ops/kernels/paged_attention.py:351"),
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
def rms_case(n, h, flush, dtype="bfloat16"):
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
        "case": f"rows{n}" + ("" if dtype == "bfloat16" else f"_{dtype}"),
        "shape": [n, h], "dtype": dtype,
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
        "bound_ms": b_ms, "bound_by": b_by,
    }


def attn_work(seq_lens, q_lens, t, h, kvh, d, window, page, itemsize):
    """Bytes the ragged attention must move and operations it must do,
    for THESE inputs: the real rows' q read once, the whole output
    written once (padded rows too: they are written as zeros), each K/V
    row some real row needs read once, and QK^T and PV over the kept
    keys. A real row that sees no key (qpos < 0) averages V over the
    slots of the pages below seq_len."""
    b = len(seq_lens)
    if q_lens is None:
        q_lens = [t] * b
    nbytes = b * t * h * d * itemsize
    flops = 0
    for s, ql in zip(seq_lens, q_lens):
        if s == 0 or ql == 0:
            continue
        nbytes += ql * h * d * itemsize
        qlo = s - ql
        lo = max(0, qlo - window + 1) if window else 0
        nbytes += (s - lo) * kvh * d * itemsize * 2
        if qlo < 0:
            slots = -(-s // page) * page
            nbytes += (slots - s) * kvh * d * itemsize
            flops += -qlo * h * d * slots
        for qpos in range(max(qlo, 0), s):
            keys = qpos + 1 - (max(0, qpos - window + 1) if window else 0)
            flops += 4 * d * keys * h
    return nbytes, flops


def attn_case(name, seq_lens, q_lens, t, window, flush, num_pages=600,
              h=32, kvh=8, d=128, page=16, seed=0, dtype="bfloat16"):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels.paged_attention import (
        paged_ragged_attention, paged_ragged_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(seed)
    b = len(seq_lens)
    dt = torch_dtype(dtype)
    q = torch.randn(b, t, h, d, generator=g, device="cuda").to(dt)
    kp = torch.randn(num_pages, page, kvh, d, generator=g,
                     device="cuda").to(dt)
    vp = torch.randn(num_pages, page, kvh, d, generator=g,
                     device="cuda").to(dt)
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

    def kernel():
        return paged_ragged_attention(q, kp, vp, tbl, lens, ql,
                                      window=window)

    def plain():
        return paged_ragged_attention_plain(q, kp, vp, tbl, lens, ql,
                                            window=window)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    d_err = (got.float() - ref.float()).abs()
    ok = within_tolerance(got, ref)
    pad_zero = True
    for i, (s, n) in enumerate(zip(seq_lens, q_lens or [t] * b)):
        pad = t if s == 0 else t - n
        if pad > 0 and bool((got[i, :pad] != 0).any()):
            pad_zero = False
    # the library yardstick: SDPA over the already-gathered dense K/V of
    # the same rows with the same boolean mask (gathering not timed)
    kd = kp[tbl.long()].reshape(b, mp * page, kvh, d).transpose(1, 2)
    vd = vp[tbl.long()].reshape(b, mp * page, kvh, d).transpose(1, 2)
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
                              page, q.element_size())
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    return {
        "case": name, "B": b, "T": t, "H": h, "KVH": kvh, "D": d,
        "page_size": page, "max_pages": mp, "window": window,
        "seq_lens": seq_lens, "q_lens": q_lens, "dtype": dtype,
        "max_abs_err": float(d_err.max()),
        "max_rel_err": float(
            (d_err / ref.float().abs().clamp_min(1e-6)).max()),
        "tolerance": tolerance_text(dtype) + "; padded rows exactly 0",
        "padded_rows_zero": pad_zero, "ok": ok and pad_zero,
        "kernel_ms": cuda_time_ms(kernel, flush=flush),
        "plain_ms": cuda_time_ms(plain, flush=flush),
        "library_ms": library_ms,
        "bound_ms": b_ms, "bound_by": b_by,
    }


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
    rms = [rms_case(256, 4096, flush), rms_case(8, 4096, flush),
           rms_case(8, 4096, flush, dtype="float32")]
    decode_lens = [1056, 64, 300, 777, 1000, 129, 512, 16]
    attn = [
        attn_case("decode", decode_lens, [1] * 8, 1, 0, flush, seed=1),
        attn_case("decode_float32", decode_lens, [1] * 8, 1, 0, flush,
                  seed=1, dtype="float32"),
        attn_case("prefill_chunk", [1000], [248], 256, 0, flush, seed=2),
        # the serving path's largest bucket: 7 decode rows + one
        # 248-token prefill chunk in one (8, 256) right-aligned block
        attn_case("mixed", [900, 640, 333, 1056, 71, 512, 1001, 496],
                  [1, 1, 1, 1, 1, 1, 1, 248], 256, 0, flush, seed=3),
        attn_case("seq_len0_rows", [300, 17, 0, 0], [1, 1, 0, 0], 1, 0,
                  flush, seed=4),
        attn_case("window", [900, 300, 64, 1000], [64, 1, 64, 30], 64,
                  128, flush, seed=5),
        # q_lens absent and seq_len < T: the leading rows see no key and
        # average V over the visited pages' slots, as the TPU kernel does
        attn_case("no_key_rows", [5, 40, 12, 1], None, 16, 0, flush,
                  seed=6),
    ]
    del flush
    bad = [c["case"] for c in rms + attn if not c["ok"]]
    emit("kernels", failed=bad, kernels=[
        {"name": name, "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "cases": cases}
        for name, cases in (("rms_norm", rms),
                            ("paged_ragged_attention", attn))])
    if bad:
        raise RuntimeError(f"kernel cases disagree with their plain "
                           f"versions: {bad}")
    return rms, attn


# ------------------------------------------------------------------ serve
def serve_phase(seed, layers):
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import (BatchScheduler,
                                            PagedLlamaAdapter, Request)
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b
    from paddle_tpu_torch.ops.kernels import kernel_launch_stats
    from paddle_tpu_torch.testing import dense_reference_logits

    cfg = llama3_8b() if layers is None else llama3_8b(
        num_hidden_layers=layers)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    adapter = PagedLlamaAdapter(model, num_pages=512, page_size=16)

    # served logits of the watched requests, by absolute position
    rng = np.random.RandomState(seed)
    prompt_lens = rng.randint(64, 1025, size=8).tolist()
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in prompt_lens]
    watch = {"r0", "r1"}
    captured = {w: {} for w in watch}
    serve_fn = adapter.prefill_chunk

    def recording_prefill_chunk(token_ids, seq_ids, start_positions=None,
                                pad_to=None, logits_rows=None):
        out = serve_fn(token_ids, seq_ids, start_positions,
                       pad_to=pad_to, logits_rows=logits_rows)
        for i, s in enumerate(seq_ids):
            if s in watch:
                p = int(start_positions[i]) + len(token_ids[i]) - 1
                captured[s][p] = out[i].float()
        return out

    adapter.prefill_chunk = recording_prefill_chunk

    # warm-up: one short request (cuBLAS handles and GEMM heuristics)
    warm = BatchScheduler(adapter, max_batch_size=8,
                          prefill_chunk_tokens=248)
    warm.submit(Request("warm", prompts[0][:16], max_new_tokens=2))
    warm.run_until_complete()

    sched = BatchScheduler(adapter, max_batch_size=8,
                           prefill_chunk_tokens=248)
    # host clock of every generated token (the scheduler reads each
    # step's logits back to the host before it commits a token, so this
    # is when the token existed for a client)
    tok_times = {}

    def on_token(req, tok, is_prompt):
        if not is_prompt:
            tok_times.setdefault(req.req_id, []).append(time.perf_counter())

    for i, p in enumerate(prompts):
        sched.submit(Request(f"r{i}", p, max_new_tokens=32,
                             on_token=on_token))
    calls0 = adapter.chunk_stats["calls"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    kernel_launch_stats(reset=True)
    t0 = time.perf_counter()
    while sched.num_active or sched.num_queued:
        ts = time.perf_counter()
        ev = sched.step()
        steps.append({"ms": (time.perf_counter() - ts) * 1e3,
                      "prefill": ev["prefill_tokens"],
                      "decode": ev["decode_tokens"],
                      "util": ev.get("chunk_utilization")})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launch_stats(reset=True)
    calls = adapter.chunk_stats["calls"] - calls0
    done = {r: sched.result(r) for r in (f"r{i}" for i in range(8))}
    ttft = sorted((v[0] - t0) * 1e3 for v in tok_times.values())
    tpot = sorted((b - a) * 1e3 for v in tok_times.values()
                  for a, b in zip(v, v[1:]))
    gen = sum(len(r.generated_ids) for r in done.values())
    total = gen + sum(prompt_lens)
    peak = torch.cuda.max_memory_allocated()
    n_layers = cfg.num_hidden_layers
    want_attn = n_layers * calls
    want_rms = (2 * n_layers + 1) * calls
    problems = []
    if launches.get("paged_ragged_attention", 0) != want_attn:
        problems.append(f"ragged attention launches "
                        f"{launches.get('paged_ragged_attention', 0)} != "
                        f"{n_layers} x {calls} model calls")
    if launches.get("rms_norm", 0) != want_rms:
        problems.append(f"rms_norm launches {launches.get('rms_norm', 0)}"
                        f" != {2 * n_layers + 1} x {calls} model calls")
    if any(len(r.generated_ids) != 32 for r in done.values()):
        problems.append("a request did not generate 32 tokens")

    # oracle: teacher-forced dense float32 forward over prompt + the
    # generated tokens that were fed back; its logits at each sampled
    # position against the served ones
    oracle = {}
    for rid in sorted(watch):
        r = done[rid]
        seq = r.prompt_ids + r.generated_ids[:-1]
        # positions whose logits sampled a token: the prompt's last one
        # and every decode row (mid-prompt chunk ends sample nothing)
        positions = sorted(p for p in captured[rid]
                           if p >= len(r.prompt_ids) - 1)
        want = list(range(len(r.prompt_ids) - 1, len(seq)))
        if positions != want:
            problems.append(f"{rid}: captured positions {positions[:3]}.. "
                            f"!= sampled positions {want[:3]}..")
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
        if float(cos.min()) < COSINE_GATE:
            problems.append(f"{rid}: min cosine {float(cos.min()):.6f} "
                            f"< {COSINE_GATE}")
    emit("serve", model="llama3_8b", layers=n_layers,
         depth_cut=None if layers is None else
         f"{layers} of 32 layers (--layers)",
         hidden=cfg.hidden_size, intermediate=cfg.intermediate_size,
         heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
         vocab=cfg.vocab_size, params=n_params, dtype="bfloat16",
         init_s=init_s, num_pages=512, page_size=16,
         kv_pool_bytes=sum(c.pool_nbytes for c in adapter.caches),
         max_batch_size=8, prefill_chunk_tokens=248,
         prompt_lens=prompt_lens, new_tokens=32, steps=len(steps),
         model_calls=calls, wall_s=wall,
         generated_tok_per_s=gen / wall, total_tok_per_s=total / wall,
         generated_tokens=gen, prompt_tokens=sum(prompt_lens),
         max_memory_allocated=peak, launches=launches,
         ttft_ms={"median": float(np.median(ttft)), "max": ttft[-1],
                  "n": len(ttft)},
         tpot_ms={"median": float(np.median(tpot)),
                  "p90": float(np.percentile(tpot, 90)), "n": len(tpot)},
         packed_tokens=sched.chunk_stats["packed_tokens"],
         padded_tokens=sched.chunk_stats["padded_tokens"],
         step_ms=[round(s["ms"], 3) for s in steps],
         step_tokens=[[s["prefill"], s["decode"]] for s in steps],
         oracle=oracle, cosine_gate=COSINE_GATE, problems=problems)
    if problems:
        raise RuntimeError("serve phase failed: " + "; ".join(problems))
    adapter.prefill_chunk = serve_fn
    return launches, adapter, prompts


def _kernel_class(name):
    n = name.lower()
    if "ragged_kernel" in n:
        return "paged_ragged_attention"
    if "rms_norm_kernel" in n:
        return "rms_norm"
    if "nvjet" in n or "gemm" in n or "cutlass" in n or "xmma" in n:
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    if "index" in n or "gather" in n or "scatter" in n:
        return "index/gather/scatter"
    return "elementwise/other"


def profile_phase(adapter, prompts):
    """Where the serve phase's time goes: the same 8 requests served
    again under ``torch.profiler``; reports device time by kernel (GPU
    kernel events only, so no time is counted twice under the op that
    launched it) and the device's busy share of the wall."""
    import torch
    from torch.autograd import DeviceType
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
    emit("profile", steps=steps, wall_ms=wall_us / 1e3,
         device_busy_ms=device_us / 1e3 if rows else "not measured",
         device_busy_share=device_us / wall_us if rows else
         "not measured",
         device_ms_by_class=by_class,
         device_events=sum(n for _, _, n in rows),
         htod_copies=sum(n for _, k, n in rows if "HtoD" in k),
         top_device_ms=[[k[:90], round(us / 1e3, 4), n]
                        for us, k, n in rows[:15]])


# Served bf16 logits against the float32 oracle, per sampled position.
# The served path rounds every activation to bf16 (2^-9 relative) through
# 32 layers; on an H100 (700 W) the lowest cosine measured over 64
# positions was 0.99993, so 0.999 leaves 10x headroom in 1 - cosine for
# rounding alone. Top-1 agreement is reported, not gated: random
# weights give near-ties.
COSINE_GATE = 0.999


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth (never its width)")
    args = ap.parse_args(argv)

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
         device_count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0,
         compiled=_build.build_seconds is not None,
         nvcc_flags=" ".join(_build.NVCC_FLAGS),
         sources=list(_build.SOURCES))

    rms, attn = kernels_phase()
    launches, adapter, prompts = serve_phase(args.seed, args.layers)
    profile_phase(adapter, prompts)

    def summary(name, cases, main_case):
        c = next(x for x in cases if x["case"] == main_case)
        return {"name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1],
                "launches": launches.get(name, 0),
                "max_abs_err": max(x["max_abs_err"] for x in cases),
                "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"], "case": main_case}

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        summary("rms_norm", rms, "rows256"),
        summary("paged_ragged_attention", attn, "mixed"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
