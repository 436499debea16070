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

# -- the host planes: sanitizers, telemetry, fault injection ----------------
define_flag("page_sanitizer", "off",
            "KV page-pool sanitizer for the paged serving stack "
            "(incubate/nn/page_sanitizer.py): 'off' (default) allocates "
            "nothing and every instrumented pool mutation pays one "
            "attribute check; 'warn' mirrors every PagedKVCacheManager "
            "mutation into a shadow heap, validates it (use-after-free "
            "via page generations, double-free, refcount leaks, "
            "copy-on-write violations, stale page-table rows, capacity "
            "drift) and reports violations as RuntimeWarning; 'strict' "
            "raises PageSanitizerError carrying the journal tail, and "
            "BatchScheduler also runs assert_ref_invariants() at the "
            "epoch stride")
define_flag("page_sanitizer_journal", 512,
            "bounded event-journal chunk size for the page sanitizer: the "
            "journal keeps a shadow-heap snapshot plus up to this many "
            "typed events, so a dumped journal always replays (python -m "
            "paddle_tpu_torch.incubate.nn.page_sanitizer --replay <file>)")
define_flag("page_sanitizer_stride", 16,
            "epoch cross-check stride for the page sanitizer: every this "
            "many BatchScheduler steps the shadow heap is compared with "
            "the real pool (refcounts, free list, sequence lengths, "
            "num_free_pages) and, in strict mode, assert_ref_invariants() "
            "runs on every cache")
define_flag("concurrency_sanitizer", "off",
            "host-plane concurrency sanitizer (framework/concurrency.py): "
            "'off' (default) allocates nothing, guarded() hands back a "
            "plain threading.Lock and every instrumented site pays one "
            "attribute check; 'warn' runs the lockset + vector-clock "
            "happens-before race detector over the instrumented serving "
            "and telemetry modules (unguarded shared writes, read-write "
            "races, lock-order inversions, blocking acquires on a running "
            "event loop, unsanctioned writer threads) and reports "
            "violations as RuntimeWarning; 'strict' raises "
            "ConcurrencyError carrying the journal tail. The mode is read "
            "when the instrumented object is constructed")
define_flag("concurrency_journal", 512,
            "bounded event-journal chunk size for the concurrency "
            "sanitizer: a state snapshot plus up to this many typed "
            "events (acquire/release/read/write/spawn), re-snapshotting "
            "on overflow, so a dumped journal always replays (python -m "
            "paddle_tpu_torch.framework.concurrency --replay <file>)")
define_flag("telemetry", "off",
            "runtime telemetry (framework/telemetry.py): 'off' (default) "
            "allocates nothing (no registry, no tracer; every "
            "instrumented site pays one attribute check); 'metrics' "
            "activates the process-wide MetricsRegistry (counters, "
            "gauges and histograms: serving TTFT/TPOT/queue wait, pool "
            "occupancy and copy-on-write, prefix hits); 'trace' also "
            "records nested wall-clock spans (admit, prefill chunk, "
            "decode, retire) into a bounded ring exportable as Chrome "
            "trace JSON. The mode is read when a scheduler, pool or "
            "cache is constructed")
define_flag("telemetry_ring", 8192,
            "span ring capacity of the telemetry tracer: the newest "
            "this-many finished spans are kept")
define_flag("telemetry_samples", 4096,
            "per-histogram raw-sample reservoir of the telemetry "
            "registry: percentiles are exact while a histogram has seen "
            "at most this many values, and exact over the newest "
            "this-many after that (the log2 bucket counts cover "
            "everything)")
define_flag("telemetry_request_traces", 256,
            "bounded LRU of COMPLETED per-request traces (submit -> "
            "admit -> prefill chunk -> token -> retire) kept by the "
            "request-trace book in trace mode; in-flight traces are "
            "never dropped")
define_flag("telemetry_window", 128,
            "sliding-window size in SCHEDULER STEP EPOCHS (not wall "
            "clock, so windowed views stay deterministic under a fake "
            "clock): windowed percentile views, the SLO/goodput window "
            "over retired requests, and the window every watchdog "
            "detector computes deltas over")
define_flag("telemetry_slo", "",
            "serving SLO spec read by BatchScheduler when FLAGS_telemetry "
            "is on: comma-separated 'ttft_p99_s=<s>,tpot_p99_s=<s>,"
            "queue_wait_p99_s=<s>' (any subset; empty disables SLO "
            "accounting). A retired request meets the SLO set when its "
            "TTFT, its p99 inter-token gap and its queue wait are each "
            "within bounds; serving.goodput is the fraction of requests "
            "retired inside FLAGS_telemetry_window that met all of them")
define_flag("telemetry_watchdog", "off",
            "anomaly watchdogs over the telemetry registry "
            "(framework/watchdog.py): 'off' (default) builds nothing; "
            "'warn' runs the registry-read-only detector pass every "
            "FLAGS_telemetry_watchdog_stride scheduler steps (recompile "
            "storm, pool pressure and churn, prefix hit-rate collapse, "
            "decode stall, sanitizer-violation spike, preemption thrash, "
            "plan drift), appends structured events to a bounded log and "
            "raises RuntimeWarning; 'strict' raises WatchdogError at the "
            "detecting step. Needs FLAGS_telemetry=metrics|trace")
define_flag("telemetry_watchdog_stride", 32,
            "scheduler-step stride of the watchdog pass and of the "
            "periodic FLAGS_telemetry_export_path write: every this many "
            "BatchScheduler.step() calls the gauges refresh, every "
            "watchdog detector runs and the Prometheus snapshot is "
            "rewritten")
define_flag("telemetry_export_path", "",
            "when non-empty and FLAGS_telemetry is on, the scheduler "
            "rewrites this file with a Prometheus text-format snapshot "
            "of the registry every FLAGS_telemetry_watchdog_stride steps "
            "(atomic tmp + rename write)")
define_flag("telemetry_peak_flops", 989e12,
            "device peak FLOP/s the performance ledger "
            "(framework/perf_ledger.py) judges live MFU against, and the "
            "compute leg of its roofline-predicted wall. Default: the "
            "NVIDIA H100 SXM's dense bf16 tensor-core peak (989 TFLOP/s); "
            "set it to the deployed card's peak, or 0 to drop the MFU "
            "column and the compute bound")
define_flag("telemetry_peak_hbm_gbs", 3350.0,
            "device memory bandwidth in GB/s for the performance "
            "ledger's roofline math (the memory leg of the predicted "
            "wall and the attained arithmetic intensity). Default: the "
            "NVIDIA H100 SXM's HBM3 rate (3,350 GB/s); 0 drops the "
            "memory bound")
define_flag("telemetry_drift_ratio", 4.0,
            "plan-drift threshold of the performance ledger and the "
            "plan-drift watchdog class: a program whose roofline-"
            "predicted lower-bound wall exceeds its sustained measured "
            "wall by at least this ratio runs faster than its plan says "
            "is possible (the cost model is off). 0 disables the check")
define_flag("telemetry_incident_dir", "",
            "when non-empty and FLAGS_telemetry is on, the serving "
            "scheduler attaches a telemetry.FlightRecorder: every "
            "watchdog fire (and every explicit dump_incident()) writes "
            "one atomic, bounded incident bundle here (chrome trace with "
            "request lanes, registry snapshot, Prometheus text, "
            "sanitizer journal tail, ledger top-N, flags, watchdog "
            "events), readable with python -m "
            "paddle_tpu_torch.framework.telemetry --summarize-incident "
            "<bundle>")
define_flag("telemetry_incident_keep", 8,
            "bound on the incident bundles kept in "
            "FLAGS_telemetry_incident_dir: the oldest are pruned first")
define_flag("serving_faults", "",
            "deterministic fault-injection plan for the serving scheduler "
            "(incubate/nn/fault_injection.py): comma-separated "
            "'kind@step', 'kind@step+duration' or 'kind@step:param' "
            "entries over the kinds exhaust / preempt_storm / "
            "delay_swap_in / fail_step, e.g. 'exhaust@10+5,"
            "preempt_storm@20:2,fail_step@30+3'. Faults act at step "
            "boundaries only; empty (default) builds no injector and "
            "costs one is-None check a step")
define_flag("serving_fault_seed", 0,
            "seed of FaultInjector.random() plans: the same seed and step "
            "count give the same fault schedule")

# -- jit.to_static's compile-time hooks (framework/analysis.py,
# framework/planner.py)
define_flag("jit_lint", "warn",
            "trace-time linter over to_static programs "
            "(framework/analysis.py): 'off' skips analysis entirely, "
            "'warn' logs findings (criticals as warnings), 'strict' "
            "raises JitLintError at compile, before the first call runs, "
            "on any warning/critical finding")
define_flag("jit_lint_suppress", "",
            "comma-separated lint rule ids to suppress globally (e.g. "
            "'dtype-drift,recompile-weak-scalar'; see "
            "framework/analysis.RULES for the id list)")
define_flag("jit_plan", "report",
            "static resource planner over to_static programs "
            "(framework/planner.py): 'off' skips planning, 'report' "
            "(default) attaches each compiled program's peak-live "
            "device-memory plan to its entry, emits "
            "compile.hbm_peak_bytes and logs planner findings, 'strict' "
            "raises JitPlanError at compile on an hbm-over-budget "
            "finding (suppression shares the linter's three scopes)")

# -- the async engine, disaggregated serving, the ops server and the
# capacity autotuner (inference/engine.py, inference/disagg.py,
# framework/ops_server.py, framework/autotuner.py)
define_flag("jit_budget_hbm", 0,
            "peak-live device-memory budget in bytes: a to_static "
            "program whose planned peak (framework/planner.py) exceeds "
            "it fires hbm-over-budget, and the capacity autotuner's "
            "check_feasible (framework/autotuner.py) discards a "
            "candidate whose priced peak (fixed bytes plus its largest "
            "padded step's activation bytes) exceeds it. 0 (default) "
            "disables the gate")
define_flag("jit_budget_comm", 0,
            "per-device collective-traffic budget in bytes: the "
            "capacity autotuner's check_feasible discards a candidate "
            "whose priced wire bytes at its largest padded step "
            "exceed it as comm-over-budget. 0 (default) disables the "
            "gate")
define_flag("collective_matmul", "off",
            "ring-decomposed collective+matmul for the tensor-parallel "
            "layers and the dp gradient sync: 'off' (default) runs the "
            "plain all-reduce / all-gather chains; 'on' and 'auto' ask "
            "for the rings, which the port has not ported yet, and "
            "raise at an mp or dp degree above 1 "
            "(distributed/fleet/layers/mpu/mp_ops.py). The reference "
            "defaults to 'auto'; the rings compute the same function")
define_flag("collective_dtype", "off",
            "quantize-on-the-wire dtype for the chunked ring "
            "collectives: 'off' (default) ships full-precision "
            "chunks; 'int8' (and 'fp8') ship block-scaled "
            "payloads, one float32 scale per 128 elements of the "
            "trailing dim. The port has no ring collectives yet "
            "(a value other than 'off' raises at an mp or dp degree "
            "above 1); the capacity autotuner "
            "(framework/autotuner.py) reads it as one of its knobs "
            "and prices its wire ratio")
define_flag("ops_server_port", 0,
            "embedded live-ops debug HTTP server "
            "(framework/ops_server.py): 0 (default) builds nothing — "
            "the serving scheduler pays one integer check at "
            "construction; a positive port starts ONE process-wide, "
            "read-only, stdlib-only server on 127.0.0.1:<port> "
            "serving /metrics (byte-identical to "
            "telemetry.prometheus_text), /statusz (build/flags/"
            "uptime + SLO-window and watchdog state), /tracez "
            "(recent spans + chrome/perfetto payload), /planz "
            "(resource plans + perf-ledger plan-vs-actual), /flagz, "
            "and /incidentz (flight-recorder bundle index + "
            "summarize view). Requires FLAGS_telemetry=metrics|trace "
            "— with telemetry off the server refuses to start")
define_flag("engine_goodput_low", 0.75,
            "trip threshold for the ServingEngine admission gate "
            "(inference/engine.py): when the live serving.goodput "
            "windowed gauge falls below this fraction (and the SLO "
            "window holds at least FLAGS_engine_min_window "
            "requests), the gate counts a bad signal toward "
            "escalating backpressure (open -> shed -> clamp). Must "
            "be < FLAGS_engine_goodput_high — the gap is the "
            "hysteresis band in which the gate holds state")
define_flag("engine_goodput_high", 0.9,
            "recovery threshold for the ServingEngine admission "
            "gate: goodput at or above this fraction (with no fresh "
            "watchdog events) counts a good signal toward de-"
            "escalating backpressure one level. Goodput between "
            "FLAGS_engine_goodput_low and this value is the "
            "hysteresis band: both trip and recovery streaks freeze "
            "so the gate doesn't flap at a single threshold")
define_flag("engine_min_window", 4,
            "minimum serving.slo_window_requests before the "
            "ServingEngine admission gate trusts the goodput gauge: "
            "with fewer retired requests in the SLO window the "
            "goodput signal is noise (one slow request swings it to "
            "0.0) and the gate ignores it. Watchdog-event signals "
            "are not window-gated")
define_flag("engine_trip_steps", 2,
            "consecutive bad gate evaluations (goodput below "
            "FLAGS_engine_goodput_low, or fresh watchdog events in "
            "the six overload classes) required before the "
            "ServingEngine escalates backpressure one level — the "
            "trip half of the gate's hysteresis")
define_flag("engine_recover_steps", 4,
            "consecutive good gate evaluations (goodput at or above "
            "FLAGS_engine_goodput_high or no SLO signal, and no "
            "fresh watchdog events) required before the "
            "ServingEngine de-escalates backpressure one level — "
            "deliberately larger than FLAGS_engine_trip_steps so "
            "recovery is slower than tripping")
define_flag("engine_gate_stride", 2,
            "the ServingEngine re-evaluates its admission gate "
            "every this-many pump steps: the SLO gauges it reads "
            "are themselves windowed per scheduler step, so "
            "per-step evaluation buys nothing and doubles the "
            "gauge-read overhead on the pump thread")
define_flag("engine_shed_keep_priority", 1,
            "priority floor while the ServingEngine gate is in the "
            "shed state: submissions with request.priority below "
            "this value are rejected with EngineOverloadError "
            "(lowest-priority admissions shed first); at or above "
            "it they are still admitted. The clamp state rejects "
            "all new admissions regardless of priority")
define_flag("engine_idle_wait_s", 0.002,
            "how long the ServingEngine pump thread parks on its "
            "wake event when the scheduler has no queued, active, "
            "or swapped work: long enough to avoid a busy spin, "
            "short enough that a submit landing between the inbox "
            "drain and the wait (which also sets the event) is "
            "picked up immediately")
define_flag("disagg_router_policy", "rr",
            "replica-selection policy for the disaggregated "
            "SessionRouter (inference/disagg.py): 'rr' round-robins "
            "new sessions over the DP replicas; 'least' picks the "
            "replica with the fewest live sessions (better under "
            "skewed session lifetimes, one extra scan per submit)")
define_flag("disagg_mp_shards", 1,
            "KV-head shard count for the disaggregated page-chain "
            "transfer (incubate/nn/paged_cache.py export_seq): a "
            "handed-off chain is split into this many wire payloads "
            "along the KV-head axis — one per mp-mesh shard on the "
            "decode side — so each decode shard imports only the "
            "heads it owns; must divide the pool's KV head count")
define_flag("disagg_prefill_chunk_tokens", 0,
            "chunked-prefill token budget override for PREFILL-role "
            "schedulers in the disaggregated split (inference/"
            "disagg.py): prefill workers run chunk-budget-heavy "
            "steps, so this (when > 0) replaces the single-box "
            "FLAGS_prefill_chunk_tokens on the prefill side only; "
            "0 keeps the single-box value")
define_flag("disagg_prefill_budget_hbm", 0,
            "per-role override of FLAGS_jit_budget_hbm applied by "
            "disagg.apply_role_budgets('prefill'): prefill workers "
            "hold full prompt activations so their peak-live-HBM "
            "budget differs from decode's; 0 leaves the global "
            "budget untouched")
define_flag("disagg_prefill_budget_comm", 0,
            "per-role override of FLAGS_jit_budget_comm applied by "
            "disagg.apply_role_budgets('prefill'): the prefill "
            "role's per-device collective-traffic budget in bytes; "
            "0 leaves the global budget untouched")
define_flag("disagg_decode_budget_hbm", 0,
            "per-role override of FLAGS_jit_budget_hbm applied by "
            "disagg.apply_role_budgets('decode'): decode workers "
            "are KV-pool-dominated, so their peak-live-HBM budget "
            "differs from prefill's; 0 leaves the global budget "
            "untouched")
define_flag("disagg_decode_budget_comm", 0,
            "per-role override of FLAGS_jit_budget_comm applied by "
            "disagg.apply_role_budgets('decode'): the decode role's "
            "per-device collective-traffic budget in bytes; 0 "
            "leaves the global budget untouched")
define_flag("autotune_space", "",
            "capacity-autotuner search-space override, a "
            "';'-separated list of knob=alt|alt clauses — e.g. "
            "'chunk=16|32|64;buckets=8,16,32|8,16,32,64,128;"
            "swap=0|268435456;dtype=off|int8;band=0.75:0.9' — "
            "knobs omitted from the spec keep their built-in "
            "alternatives (autotuner.DEFAULT_SPACE); empty uses "
            "the built-in space for every knob")
define_flag("autotune_eval_windows", 3,
            "live goodput windows the capacity autotuner averages "
            "per candidate before scoring it (one window = one "
            "Autotuner.observe() with signal): the hysteresis "
            "half-width — a single noisy window can never adopt or "
            "reject a candidate because the decision waits for the "
            "median of this many")
define_flag("autotune_min_improve", 0.05,
            "relative live-score improvement a challenger "
            "candidate must sustain over the incumbent before the "
            "capacity autotuner adopts it (0.05 = 5% better on the "
            "goodput-window score); challengers inside the dead "
            "band are reverted, so config churn needs a real win")
define_flag("autotune_artifact", "",
            "path the capacity autotuner writes its reproducible "
            "tuned-config JSON artifact to "
            "(TUNED_CONFIG_LAST.json-style: chosen config, the "
            "scored candidate table, quarantine list, and the "
            "flags dict to re-apply it); empty disables the write")
