"""Continuous-batching scheduler over the paged KV cache (counterpart of
the core of the reference's ``inference/serving.py``).

Token-level continuous batching: every step advances each active
sequence, so arrivals and completions interleave freely. Chunked
prefill (default when the model implements ``prefill_chunk``): each
step packs EVERY active decode row plus up to ``prefill_chunk_tokens``
pending prompt tokens into ONE ragged model call, padded up to a bucket
of ``FLAGS_serving_buckets`` (:func:`bucket_packed_tokens`).

Admission control: a request is admitted only while the active batch
is below ``max_batch_size`` and the page pool stays under the watermark
after reserving the request's worst-case page need (prompt +
max_new_tokens, across every layer's cache).

Prefix caching (``prefix_cache=True``): a radix tree over token ids
(``inference/prefix_cache.py``) remembers retired sequences' KV pages.
On admission the prompt is matched against the tree, the matched page
chains are pinned and ATTACHED (shared, refcounted:
``incubate/nn/paged_cache.py``), and prefill starts at the first
uncached token; the worst-case reservation shrinks by the full pages the
hit covers. On retire the sequence's cached tokens are inserted into the
tree, and an LRU-by-leaf evictor reclaims unpinned cached pages whenever
admission would otherwise cross the watermark.

Overload: the submit queue can be bounded (``FLAGS_serving_max_queue``
-> :class:`QueueFullError`) and is ordered by per-request ``priority``
(FIFO within a priority; ``max_inflight_per_tenant`` caps any one
tenant's active share). When admission cannot reserve pages for a
request even after prefix-cache eviction, the scheduler PREEMPTS
strictly-lower-priority victims (lowest priority, then most pages held,
then least progress): a victim's private KV pages swap out bit for bit
to the host tier (``HostKVSwapSpace``, ``FLAGS_serving_swap_bytes``;
shared prefix pages stay on the device under swap holds) and come back
on re-admission, which is one more packed prompt or decode row.
Per-request deadlines (``deadline_s``) abort expired work at step
boundaries into the terminal ``aborted_deadline`` state, releasing every
reservation (queued, active or swapped out alike); :meth:`BatchScheduler.
cancel` does the same for one request on demand. With every priority 0
no victim qualifies, so the default behaviour is FIFO admission that
waits for pages.

Speculative decoding (``draft_model=``, greedy only): a draft adapter
with its own page pools proposes ``draft_k`` tokens a decode row and
round, the target verifies the window, and the longest proposal prefix
that matches the target's argmax commits together with the target's
next token (:meth:`BatchScheduler._commit_spec_row`); ``truncate`` rolls
both pools back past the first mismatch. Two lowerings
(``FLAGS_spec_decode`` / ``spec_decode=``): ``ragged`` packs each verify
window as one right-aligned ``draft_k + 1``-token row of the ordinary
``prefill_chunk`` step (one target call a round, per-position logits
through ``logits_rows=``), and composes with the prefix cache and
preemption: a draft chain behind the target's, after a prefix hit or a
swap-in, is refilled from the committed tokens under the chunk budget;
``legacy`` runs ``draft_k + 1`` draft ``decode_token`` calls and one
target ``decode_window`` a round, and refuses the prefix cache and
preemption. ``off`` ignores the draft. Either way the output is the
non-speculative greedy scheduler's, token for token.

Disaggregated prefill/decode (``inference/disagg.py``): :meth:`BatchScheduler.
export_request` swaps a prefill-complete request's chains out bit for bit
and serializes them over the pool's page-chain wire format (one payload a
KV-head shard), leaving the request ``migrated``; :meth:`BatchScheduler.
adopt_swapped` on another scheduler imports the payloads into its swap
tier and registers the request swapped out, so the ordinary swap-in
resumes its decode. :meth:`BatchScheduler.apply_capacity_config` retargets
the chunk budget, the bucket ladder and the swap budget between steps
(``framework/autotuner.py``); with ``FLAGS_ops_server_port`` set, the
scheduler registers its ``/statusz`` section on the embedded ops server
at construction (``framework/ops_server.py``).

The host planes, all off by default (one ``is None`` check a site):

* fault injection (``fault_injector=`` or ``FLAGS_serving_faults``,
  ``incubate/nn/fault_injection.py``) perturbs the scheduler at step
  boundaries only: forced pool exhaustion, preemption storms, delayed
  swap-in, and step failures retried with exponential back-off;
* the page sanitizer (``FLAGS_page_sanitizer``, or the adapter's
  ``sanitizer=``) journals every pool mutation, and the scheduler
  cross-checks every pool's shadow heap (draft pools included) every
  ``FLAGS_page_sanitizer_stride`` steps;
* telemetry (``FLAGS_telemetry=metrics|trace``, ``framework/
  telemetry.py``): per-request TTFT / TPOT / queue-wait / retire
  histograms and token and request counters under ``serving.*``,
  surfaced by :meth:`BatchScheduler.metrics` with the pool, prefix and
  sanitizer counters; in trace mode nested spans (``serving.step`` >
  ``serving.admit`` / ``serving.draft_propose`` /
  ``serving.prefill_chunk`` / ``serving.decode`` > ``serving.retire``)
  and per-request traces (submit -> admit -> token ... -> retire), each
  request carrying a :class:`telemetry.TraceContext` through its swap
  records; SLO accounting (``slo=`` or ``FLAGS_telemetry_slo``) with
  goodput over a window of step epochs; the watchdog (``watchdog=`` or
  ``FLAGS_telemetry_watchdog``) every ``FLAGS_telemetry_watchdog_stride``
  steps; the performance ledger (``exec.wall_s.<program>`` stamps of
  each model call, closed once its logits reached the host); and the
  flight recorder (``FLAGS_telemetry_incident_dir``), which writes an
  incident bundle at each watchdog fire and on :meth:`BatchScheduler.
  dump_incident`;
* the concurrency sanitizer (``FLAGS_concurrency_sanitizer``) holds the
  queue and the request maps to one writer thread.

Every time the scheduler reads comes from ``telemetry.clock()``.
"""
from __future__ import annotations

import collections
import inspect
import warnings
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..framework import concurrency as _concurrency
from ..framework import telemetry
from ..framework.flags import flag
from ..framework.telemetry import NULL_SPAN as _NULL
from ..incubate.nn.paged_cache import HostKVSwapSpace, SwapSpaceFull
from .prefix_cache import RadixPrefixCache

__all__ = ["Request", "BatchScheduler", "RequestState",
           "bucket_packed_tokens", "QueueFullError"]

# scheduler uid sequence: the per-scheduler serving.compile_count.<uid>
# and serving.attend_programs.<uid> gauges
_SCHED_SEQ = [0]  # concurrency: single-writer


class QueueFullError(RuntimeError):
    """submit() backpressure: the bounded queue
    (``FLAGS_serving_max_queue`` / ``max_queue=``) is at capacity; the
    caller should shed load or retry later."""


def _parse_buckets(spec) -> tuple:
    """Normalize a bucket spec ('8,16,64' / iterable of ints) into a
    sorted tuple of positive ints."""
    if isinstance(spec, str):
        vals = [int(s) for s in spec.replace(" ", "").split(",") if s]
    else:
        vals = [int(v) for v in spec]
    if not vals or min(vals) < 1:
        raise ValueError(f"invalid serving bucket spec {spec!r}")
    return tuple(sorted(set(vals)))


def bucket_packed_tokens(n: int, buckets=None) -> int:
    """Round a packed ragged token count up to the smallest configured
    bucket (FLAGS_serving_buckets by default); counts beyond the largest
    bucket round up to the next power of two."""
    buckets = _parse_buckets(
        flag("serving_buckets") if buckets is None else buckets)
    n = int(n)
    if n < 1:
        raise ValueError(f"cannot bucket a packed count of {n}")
    for b in buckets:
        if n <= b:
            return b
    return 1 << (n - 1).bit_length()


class RequestState:
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    # preempted: KV paged out to the host tier, awaiting re-admission
    SWAPPED = "swapped"
    FINISHED = "finished"
    # terminal, DISTINCT from finished: the deadline expired (or the
    # request was cancelled) before completion and every reservation
    # was released
    ABORTED_DEADLINE = "aborted_deadline"
    # handed off to a decode worker (export_request): gone from THIS
    # scheduler, not terminal (the request lives on elsewhere)
    MIGRATED = "migrated"


@dataclass
class Request:
    """One generation request. ``on_token(request, token_id,
    is_prompt)`` fires for every token the scheduler commits."""

    req_id: str
    prompt_ids: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    on_token: Optional[Callable] = None
    # admission orders by priority (higher wins; FIFO within), and
    # preemption only ever evicts STRICTLY lower-priority victims;
    # tenant feeds max_inflight_per_tenant; deadline_s (seconds from
    # submit) aborts expired work at step boundaries
    priority: int = 0
    tenant: str = "default"
    deadline_s: Optional[float] = None
    # trace identity (telemetry.TraceContext, or its to_wire() string):
    # None under FLAGS_telemetry=off, else made at submit (or adopted)
    trace_ctx: Optional[object] = None
    state: str = RequestState.QUEUED
    generated_ids: List[int] = field(default_factory=list)
    _pos: int = 0  # prompt tokens consumed so far
    _prefix_hit: int = 0  # prompt tokens served from the prefix cache
    _prefix_path: tuple = ()  # pinned radix nodes (unpinned at retire)
    _order: int = 0  # submit sequence number (FIFO within priority)
    _t_deadline: float = 0.0  # absolute clock() deadline (0 = none)
    _preemptions: int = 0  # times this request was swapped out
    # telemetry stamps (telemetry.clock(); written under live metrics
    # only) and the request's SLO inputs: TTFT, queue wait and every
    # inter-token gap
    _t_submit: float = 0.0
    _t_last_tok: float = 0.0
    _ttft: Optional[float] = None
    _qwait: Optional[float] = None
    _gaps: Optional[List[float]] = None

    @property
    def finished(self) -> bool:
        return self.state == RequestState.FINISHED

    @property
    def terminal(self) -> bool:
        """Finished OR deadline-aborted: the request left the scheduler
        either way (both land in ``result()``)."""
        return self.state in (RequestState.FINISHED,
                              RequestState.ABORTED_DEADLINE)

    def total_tokens(self) -> int:
        return len(self.prompt_ids) + self.max_new_tokens


def _accepts_logits_rows(model) -> bool:
    """True when ``model.prefill_chunk`` takes the per-position logits
    epilogue (``logits_rows=``) the ragged speculative step verifies
    windows through."""
    fn = getattr(model, "prefill_chunk", None)
    if fn is None:
        return False
    try:
        return "logits_rows" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _logits_to_host(logits) -> np.ndarray:
    if isinstance(logits, torch.Tensor):
        return logits.float().cpu().numpy()
    return np.asarray(logits)


def _argmax_rows(logits, n) -> list:
    """The greedy token of each of the first ``n`` logits rows."""
    return np.argmax(_logits_to_host(logits)[:n], axis=-1).tolist()


class BatchScheduler:
    """Drives a paged decoder model with continuous batching.

    ``model`` must provide the paged-serving protocol:
      * ``alloc(seq_id)`` / ``free(seq_id)`` — per-sequence cache slots
      * ``decode_token(token_ids, seq_ids) -> logits (B, vocab)``
      * optionally ``prefill_chunk(token_ids, seq_ids, start_positions,
        pad_to=) -> logits (B, vocab)`` for chunked prefill
      * ``caches`` — the per-layer page pools (admission watermark)
      * ``attach_prefix`` / ``seq_page_chains`` (prefix cache) and
        ``swap_out`` / ``swap_in`` (preemption); ``attach_prefix`` and
        ``swap_in`` check every layer's page table against the first's
    """

    def __init__(self, model, max_batch_size=32, page_watermark=0.95,
                 sampler=None, draft_model=None, draft_k=4,
                 prefix_cache=None, chunked_prefill=None,
                 prefill_chunk_tokens=None, serving_buckets=None,
                 prefix_align=1, slo=None, watchdog=None,
                 max_queue=None, max_inflight_per_tenant=None,
                 preempt=None, swap_bytes=None, fault_injector=None,
                 spec_decode=None):
        self.model = model
        self.max_batch_size = int(max_batch_size)
        self.page_watermark = float(page_watermark)
        self.sampler = sampler or (lambda logits: int(np.argmax(logits)))
        self._queue = collections.deque()
        self._active = {}
        self._finished = {}
        # the speculative lowering: 'ragged' packs verify windows as rows
        # of the ordinary prefill_chunk step, 'legacy' verifies through
        # decode_window, 'off' ignores the draft
        self.spec_mode = str(flag("spec_decode") if spec_decode is None
                             else spec_decode).lower()
        if self.spec_mode not in ("off", "legacy", "ragged"):
            raise ValueError(
                "spec_decode must be 'off', 'legacy' or 'ragged', "
                f"got {self.spec_mode!r} (FLAGS_spec_decode)")
        if self.spec_mode == "off":
            draft_model = None
        if chunked_prefill is None:
            chunked_prefill = hasattr(model, "prefill_chunk")
        if chunked_prefill and not hasattr(model, "prefill_chunk"):
            raise ValueError(
                "chunked_prefill=True but the model has no "
                "prefill_chunk(token_ids, seq_ids, start_positions) entry "
                "(see PagedLlamaAdapter)")
        self.chunked_prefill = bool(chunked_prefill)
        self.prefill_chunk_tokens = max(1, int(
            flag("prefill_chunk_tokens")
            if prefill_chunk_tokens is None else prefill_chunk_tokens))
        self.serving_buckets = _parse_buckets(
            serving_buckets if serving_buckets is not None
            else flag("serving_buckets"))
        # the speculative prompt phase rides chunked prefill only when
        # the draft adapter can mirror the chunks too
        self._spec_chunked = self.chunked_prefill and (
            draft_model is None or hasattr(draft_model, "prefill_chunk"))
        # ragged spec needs chunked prefill on both adapters and the
        # target's per-position logits epilogue
        self._spec_ragged = bool(
            draft_model is not None and self.spec_mode == "ragged"
            and self._spec_chunked and _accepts_logits_rows(model))
        self.chunk_stats = {
            "steps": 0, "chunk_calls": 0, "prefill_tokens": 0,
            "decode_tokens": 0, "packed_tokens": 0, "padded_tokens": 0,
        }
        # cross-request prefix KV cache: True builds a RadixPrefixCache
        # over the model's own caches; or pass a built one
        if prefix_cache and draft_model is not None \
                and not self._spec_ragged:
            raise ValueError(
                "prefix caching is not supported with LEGACY speculative "
                "decoding: the draft adapter keeps its OWN KV pool, so a "
                "cached (skipped) target prefill would leave the draft "
                "cache without the prompt; spec_decode='ragged' lifts "
                "this (the ragged spec step refills a lagging draft cache "
                "from the committed prefix)")
        if prefix_cache is True:
            prefix_cache = RadixPrefixCache(list(model.caches))
        self.prefix_cache = prefix_cache or None
        # chunk-aligned prefix lookups (prefix_cache.match(align=)):
        # align=page_size makes every cached-prefill resume start at a
        # page boundary, trading <= align-1 hit tokens for never paying
        # the shared-tail copy-on-write draw
        self.prefix_align = max(1, int(prefix_align))
        # (req_id, tree mutation count) -> PrefixMatch: a head-of-queue
        # request blocked on admission does not re-walk the tree every
        # step (see _try_admit)
        self._match_memo = None
        self.prefix_stats = {
            "requests": 0, "request_hits": 0,
            "prompt_tokens": 0, "hit_tokens": 0,
            "inserted_tokens": 0,
        }
        # speculative decoding: the draft proposes draft_k tokens a row
        # and round; greedy acceptance keeps the output token-identical
        # to the non-speculative scheduler
        self.draft = draft_model
        self.draft_k = int(draft_k)
        if draft_model is not None and sampler is not None:
            raise ValueError(
                "speculative scheduling is greedy-only (a custom sampler "
                "would break the token-identity guarantee); use "
                "models.speculative_generate for sampled speculative "
                "decoding")
        self.spec_stats = {"rounds": 0, "target_calls": 0,
                           "draft_calls": 0, "committed_tokens": 0,
                           "proposed_tokens": 0,
                           "accepted_draft_tokens": 0,
                           "refill_tokens": 0, "draft_discards": 0}
        # overload: bounded submit queue, per-tenant in-flight cap,
        # preemption onto the host swap tier, deadline aborts
        self.max_queue = int(flag("serving_max_queue")
                             if max_queue is None else max_queue)
        self.max_inflight_per_tenant = (
            None if max_inflight_per_tenant is None
            else max(1, int(max_inflight_per_tenant)))
        self._submit_seq = 0
        self._swapped = {}  # req_id -> Request (insertion = FIFO)
        preempt = bool(flag("serving_preempt")
                       if preempt is None else preempt)
        swap_bytes = int(flag("serving_swap_bytes")
                         if swap_bytes is None else swap_bytes)
        # legacy spec keeps wait-in-queue admission: swapping the target
        # out without its draft pool would desynchronize them. Under
        # ragged spec the draft KV is discarded at swap-out and refilled
        # after swap-in (the draft pool itself never swaps)
        self.swap_space = (HostKVSwapSpace(swap_bytes)
                           if preempt and swap_bytes > 0
                           and (draft_model is None or self._spec_ragged)
                           else None)
        # deterministic fault injection: None (the default, empty
        # FLAGS_serving_faults) costs one is-None check a step
        if fault_injector is None:
            spec = str(flag("serving_faults"))
            if spec.strip():
                from ..incubate.nn.fault_injection import FaultInjector

                fault_injector = FaultInjector(spec)
        self._faults = fault_injector
        self._fault_step = 0
        self._consec_fails = 0
        self._resume_at = 0
        # per-step overload annotations (preempted / resumed / aborted /
        # faulted)
        self._step_extras = {}
        self._admitted_step = 0
        # True while step() runs: apply_capacity_config refuses then
        self._in_step = False
        # the page sanitizer's epoch cross-check: every stride steps,
        # shadow against real on every cache (draft pools included)
        self._san_stride = max(1, int(flag("page_sanitizer_stride")))
        self._san_steps = 0
        # telemetry handles, read HERE: off holds None and every site
        # below pays one `is None` check
        self._metrics = telemetry.registry()
        self._tracer = telemetry.tracer()
        self._traces = telemetry.request_traces()
        # the step epoch mirrors the registry's shared monotonic epoch;
        # _steps counts THIS scheduler's iterations (stride accounting)
        self._step_epoch = 0
        self._steps = 0
        self._slo = None
        self._slo_window = None
        self._watchdog = None
        self._export_path = None
        self._t_start = 0.0
        self._ledger = None
        self._recorder = None
        _SCHED_SEQ[0] += 1
        self._sched_uid = "s%d" % _SCHED_SEQ[0]
        # the concurrency sanitizer: the queue and the request maps are
        # single-writer by contract (the thread that steps also submits)
        self._csan = _concurrency.sanitizer()
        if self._csan is None:
            self._cv_queue = None
            self._cv_state = None
        else:
            self._cv_queue = self._csan.shared(
                "serving.%s.queue" % self._sched_uid, owner=self,
                single_writer=True)
            self._cv_state = self._csan.shared(
                "serving.%s.state" % self._sched_uid, owner=self,
                single_writer=True)
        if self._metrics is None:
            if slo is not None or watchdog is not None:
                warnings.warn(
                    "BatchScheduler got an explicit "
                    + " and ".join(
                        n for n, v in (("slo=", slo),
                                       ("watchdog=", watchdog))
                        if v is not None)
                    + " but FLAGS_telemetry is off: no SLO accounting "
                    "or watchdog checks will run (set "
                    "FLAGS_telemetry=metrics|trace)",
                    RuntimeWarning, stacklevel=2)
        else:
            self._t_start = telemetry.clock()
            # join the shared epoch where it stands
            self._step_epoch = self._metrics.epoch
            self._win = max(1, int(flag("telemetry_window")))
            cfg = slo if slo is not None \
                else telemetry.SLOConfig.from_flag()
            self._slo = cfg if cfg.enabled() else None
            # (epoch, met_all, {slo: met}) per retired request, pruned
            # to the trailing window at publish time, with running
            # met-counts kept on append and prune
            self._slo_window = collections.deque()
            self._slo_met_all = 0
            self._slo_met = collections.Counter()
            wd_mode = str(flag("telemetry_watchdog")).lower()
            if watchdog is not None:
                self._watchdog = watchdog
            elif wd_mode in ("warn", "strict"):
                from ..framework.watchdog import Watchdog

                self._watchdog = Watchdog(self._metrics, mode=wd_mode,
                                          window=self._win)
            self._wd_stride = max(
                1, int(flag("telemetry_watchdog_stride")))
            self._export_path = \
                str(flag("telemetry_export_path")) or None
            # the performance ledger joins registered plans with the
            # exec.wall_s.<program> stamps of the model calls
            from ..framework import perf_ledger as _perf_ledger

            self._ledger = _perf_ledger.ledger()
            if str(flag("telemetry_incident_dir")):
                self._recorder = telemetry.FlightRecorder(
                    registry=self._metrics, tracer=self._tracer,
                    traces=self._traces, watchdog=self._watchdog,
                    ledger=self._ledger)
            if int(flag("ops_server_port")) > 0:
                # the embedded read-only ops server (framework/
                # ops_server.py): one a process, first caller wins; this
                # scheduler registers its /statusz section. Port 0 (the
                # default) never imports the module
                from ..framework import ops_server as _ops_server

                srv = _ops_server.maybe_start()
                if srv is not None:
                    srv.add_status_provider(
                        "scheduler." + self._sched_uid,
                        self._statusz_info)

    # -- pool accounting ---------------------------------------------------
    def _pool(self, model=None):
        caches = list((model or self.model).caches)
        total = sum(c.num_pages for c in caches)
        free = sum(c.num_free_pages for c in caches)
        return total, free

    def _spec_slack(self) -> int:
        """Tokens a verify window appends past the committed prefix
        before its rollback: ``draft_k + 1`` with a draft, else 0."""
        return self.draft_k + 1 if self.draft is not None else 0

    def _pages_needed(self, req: Request, model=None, hit_tokens=0) -> int:
        need = 0
        worst = req.total_tokens() + self._spec_slack()
        for c in (model or self.model).caches:
            n = -(-worst // c.page_size)
            # a prefix hit shares its FULL pages; the hit's partial tail
            # page still costs one draw (the COW fork on the first
            # divergent write), so only full pages reduce the worst case
            need += max(n - hit_tokens // c.page_size, 0)
        return need

    def _growth_pages(self, req: Request, c) -> int:
        """Worst-case free-list draws still ahead of ``req`` on cache
        ``c``: pages to reach the worst-case table size, measured from
        the cache's actual state (an attached prefix chain was shared,
        not drawn), plus one draw while the partial tail page is still
        shared (the pending copy-on-write fork). ONE definition, shared
        by the admission reservation and the preemption relief
        guard."""
        n = c.seq_len(req.req_id)
        have = -(-n // c.page_size) if n else 0
        rem = -(-(req.total_tokens() + self._spec_slack()) // c.page_size) \
            - have
        if c.pending_cow(req.req_id):
            rem += 1
        return max(rem, 0)

    def _reserved_pages_outstanding(self) -> int:
        return sum(self._growth_pages(req, c)
                   for req in self._active.values()
                   for c in self.model.caches)

    def page_pool_stats(self):
        total, free = self._pool()
        caches = list(self.model.caches)
        stats = {
            "total_pages": total,
            "free_pages": free,
            "reserved_pages": self._reserved_pages_outstanding(),
            "utilization": 1.0 - free / max(total, 1),
            "shared_pages": sum(getattr(c, "num_shared_pages", 0)
                                for c in caches),
            "cow_forks": sum(getattr(c, "cow_forks", 0) for c in caches),
            "peak_used_pages": sum(getattr(c, "peak_used_pages", 0)
                                   for c in caches),
            "kv_dtype": sorted({getattr(c, "kv_dtype", "unknown")
                                for c in caches}),
            "pool_bytes": sum(getattr(c, "pool_nbytes", 0) for c in caches),
            "used_bytes": sum(getattr(c, "page_nbytes", 0)
                              * (c.num_pages - c.num_free_pages)
                              for c in caches),
        }
        if self.prefix_cache is not None:
            # admission-level counters and the tree's lookup-level ones
            # share names like hit_tokens but mean different things
            stats["prefix_cache"] = dict(self.prefix_stats)
            stats["prefix_cache"]["tree"] = self.prefix_cache.summary()
        if self.swap_space is not None:
            stats["swap"] = self.swap_space.summary()
            stats["swap"]["swapped_requests"] = len(self._swapped)
        all_caches = caches + (list(self.draft.caches)
                               if self.draft is not None else [])
        san = [s for s in (getattr(c, "sanitizer_stats", None)
                           for c in all_caches) if s]
        if san:
            stats["sanitizer"] = {
                "mode": san[0]["mode"],
                "events": sum(s["events"] for s in san),
                "violations": sum(s["violations"] for s in san),
                "crosschecks": sum(
                    s["by_op"].get("crosscheck", 0) for s in san),
            }
        if self.draft is not None:
            d_total, d_free = self._pool(self.draft)
            stats["draft"] = {"total_pages": d_total, "free_pages": d_free}
            # committed / proposed over the scheduler's lifetime
            ss = self.spec_stats
            proposed, rounds = ss["proposed_tokens"], ss["rounds"]
            stats["spec"] = {
                "mode": "ragged" if self._spec_ragged else "legacy",
                "rounds": rounds,
                "committed_tokens": ss["committed_tokens"],
                "accept_rate": (round(ss["accepted_draft_tokens"]
                                      / proposed, 4) if proposed else None),
                "tokens_per_round": (round(ss["committed_tokens"] / rounds,
                                           3) if rounds else None),
            }
        return stats

    def metrics(self) -> dict:
        """ONE namespaced telemetry snapshot of the serving stack:

        * ``serving``: TTFT / TPOT / queue-wait / retire / step-wall
          histograms (exact p50/p90/p99, each latency with a ``window``
          view over the last ``FLAGS_telemetry_window`` step epochs),
          token and request counters, and self-describing gauges
          (uptime, steps/s, active/queued/retired/swapped requests,
          goodput and per-SLO attainment under an SLO);
        * ``pool``: occupancy gauges (refreshed here) and lifetime
          draw/free/fork/swap counters;
        * ``prefix``: hit, insert and evict counters and tree gauges;
        * ``sanitizer``: event and violation counts of live sanitizers;
        * ``exec`` and ``ledger``: the model calls' wall stamps and the
          performance ledger's per-program rows;
        * ``slo``, ``watchdog``, ``request_traces``: when live.

        Returns ``{"telemetry": "off"}`` when FLAGS_telemetry was off at
        construction (nothing was recorded)."""
        if self._metrics is None:
            return {"telemetry": "off"}
        m = self._metrics
        stats = self._publish_gauges()
        snap = m.snapshot()
        snap["telemetry"] = ("trace" if self._tracer is not None
                             else "metrics")
        if "sanitizer" in stats:
            snap["sanitizer"] = stats["sanitizer"]
        lo = self._step_epoch - self._win
        for name in ("ttft_s", "tpot_s", "queue_wait_s", "step_wall_s"):
            w = m.hist_windowed("serving." + name, lo)
            if w is not None and name in snap.get("serving", {}):
                snap["serving"][name]["window"] = w
        if self._slo is not None:
            snap["slo"] = self._slo.to_dict()
        if self._watchdog is not None:
            snap["watchdog"] = self._watchdog.summary()
        if self._traces is not None:
            snap["request_traces"] = self._traces.summary()
        if self._ledger is not None:
            snap["ledger"] = self._ledger.report()
        return snap

    def _statusz_info(self) -> dict:
        """This scheduler's status section (a plain dict: population
        counts, speculative acceptance, SLO window and watchdog
        state)."""
        info = {
            "steps": self._steps,
            "active": len(self._active),
            "queued": len(self._queue),
            "swapped": len(self._swapped),
            "retired": len(self._finished),
            "chunked_prefill": self.chunked_prefill,
        }
        if self.draft is not None:
            info["spec"] = self.page_pool_stats()["spec"]
        if self._slo is not None:
            info["slo"] = self._slo.to_dict()
            m = self._metrics
            info["slo_window"] = {
                "goodput": m.gauge_value("serving.goodput"),
                "requests": m.gauge_value("serving.slo_window_requests"),
            }
        if self._watchdog is not None:
            info["watchdog"] = self._watchdog.summary()
        return info

    def _publish_gauges(self) -> dict:
        """Publish every derived gauge into the registry and return the
        ``page_pool_stats()`` dict they were computed from (one source
        for both shapes)."""
        m = self._metrics
        stats = self.page_pool_stats()
        for key in ("total_pages", "free_pages", "utilization",
                    "shared_pages", "used_bytes"):
            m.gauge("pool." + key, stats[key])
        m.gauge("pool.peak_utilization",
                stats["peak_used_pages"] / max(stats["total_pages"], 1))
        tree = stats.get("prefix_cache", {}).get("tree")
        if tree is not None:
            m.gauge("prefix.cached_tokens", tree["cached_tokens"])
            m.gauge("prefix.cached_pages", tree["cached_pages"])
            m.gauge("prefix.nodes", tree["nodes"])
        san = stats.get("sanitizer")
        if san is not None:
            m.gauge("sanitizer.events", san["events"])
            m.gauge("sanitizer.violations", san["violations"])
        uptime = telemetry.clock() - self._t_start
        m.gauge("serving.uptime_s", uptime)
        m.gauge("serving.steps_per_s",
                self._steps / uptime if uptime > 0 else 0.0)
        m.gauge("serving.step_epoch", self._step_epoch)
        m.gauge("serving.active_requests", len(self._active))
        m.gauge("serving.queued_requests", len(self._queue))
        m.gauge("serving.retired_requests", len(self._finished))
        m.gauge("serving.swapped_requests", len(self._swapped))
        if self.swap_space is not None:
            m.gauge("serving.swap_used_bytes", self.swap_space.used_bytes)
        self._publish_slo_gauges()
        return stats

    def _sanitizer_epoch(self):
        """Every ``FLAGS_page_sanitizer_stride`` steps: cross-check each
        cache's shadow heap against the real pool (and, on strict pools,
        run ``assert_ref_invariants``). A counter bump when off."""
        self._san_steps += 1
        if self._san_steps % self._san_stride:
            return
        models = [self.model] + (
            [self.draft] if self.draft is not None else [])
        for m in models:
            for c in m.caches:
                chk = getattr(c, "sanitizer_crosscheck", None)
                if chk is not None:
                    chk()

    # -- request lifecycle -------------------------------------------------
    def submit(self, req: Request) -> str:
        if not req.prompt_ids:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        # context-length bound: rejecting at submit beats a mid-batch
        # crash for every co-batched request
        limit = getattr(self.model, "max_length", None)
        if limit is not None:
            # leave room for a verify window's overshoot
            limit -= self._spec_slack()
        if limit is not None and req.total_tokens() > limit:
            raise ValueError(
                f"request {req.req_id!r} needs {req.total_tokens()} "
                f"positions but the model serves at most {limit}")
        # reject requests that could NEVER be admitted instead of letting
        # them block the queue forever
        need = self._pages_needed(req)
        total, _ = self._pool()
        if need > self.page_watermark * total:
            raise ValueError(
                f"request {req.req_id!r} needs {need} pages worst-case but "
                f"the pool watermark admits at most "
                f"{int(self.page_watermark * total)} of {total}")
        # bounded-queue backpressure: shedding load at submit beats an
        # unbounded backlog
        if self.max_queue and len(self._queue) >= self.max_queue:
            if self._metrics is not None:
                self._metrics.inc("serving.admit_reject_queue_full")
            raise QueueFullError(
                f"request {req.req_id!r} rejected: submit queue at "
                f"capacity ({self.max_queue}); shed load or retry "
                "(FLAGS_serving_max_queue)")
        if req.deadline_s is not None:
            if req.deadline_s <= 0:
                raise ValueError(
                    f"request {req.req_id!r}: deadline_s must be "
                    f"positive, got {req.deadline_s}")
            req._t_deadline = telemetry.clock() + float(req.deadline_s)
        self._submit_seq += 1
        req._order = self._submit_seq
        if self._metrics is not None:
            req._t_submit = telemetry.clock()
        if self._metrics is not None or self._traces is not None \
                or self._tracer is not None:
            # trace identity: adopt an injected context (object or wire
            # string), else start a fresh trace. Never under off: the
            # off path allocates nothing
            ctx = req.trace_ctx
            if isinstance(ctx, str):
                ctx = telemetry.TraceContext.from_wire(ctx)
            if ctx is None:
                ctx = telemetry.TraceContext(
                    tenant=req.tenant, deadline_s=req.deadline_s)
            req.trace_ctx = ctx
        if self._traces is not None:
            payload = {"prompt_tokens": len(req.prompt_ids),
                       "max_new_tokens": req.max_new_tokens}
            if req.trace_ctx is not None:
                payload["trace_id"] = req.trace_ctx.trace_id
            self._traces.begin(req.req_id, telemetry.clock(),
                               self._step_epoch, **payload)
        if self._cv_queue is not None:
            self._cv_queue.write()
        self._queue.append(req)
        return req.req_id

    def _tenant_full(self, tenant) -> bool:
        """True when the tenant already holds its max in-flight share of
        the active batch (None = no cap)."""
        if self.max_inflight_per_tenant is None:
            return False
        n = sum(1 for r in self._active.values() if r.tenant == tenant)
        return n >= self.max_inflight_per_tenant

    def _pick_queued(self):
        """The admission candidate: highest priority first, FIFO within a
        priority, skipping tenant-capped requests."""
        cap = self.max_inflight_per_tenant
        counts = (collections.Counter(r.tenant
                                      for r in self._active.values())
                  if cap is not None else None)
        best, bk = None, None
        for req in self._queue:
            if counts is not None and counts[req.tenant] >= cap:
                continue
            k = (-req.priority, req._order)
            if best is None or k < bk:
                best, bk = req, k
        return best

    def _pop_queued(self, req):
        """Remove an admitted candidate from the queue (O(1) for the
        head)."""
        if self._cv_queue is not None:
            self._cv_queue.write()
        if self._queue and self._queue[0] is req:
            self._queue.popleft()
        else:
            self._queue.remove(req)

    def _try_admit(self) -> int:
        """Admit queued requests while they fit (swapped-out requests
        first, by :meth:`_admit_swapped`); returns the prompt tokens the
        admitted requests take from the prefix cache."""
        hit_tokens_admitted = 0
        if self._faults is not None \
                and self._faults.pool_exhausted(self._fault_step):
            # injected pool exhaustion: admission (and swap-in) sees a
            # full pool; active decode continues untouched
            self._note_fault("exhaust")
            return 0
        head = self._pick_queued()
        self._admit_swapped(None if head is None else head.priority)
        while self._queue and len(self._active) < self.max_batch_size:
            # the head pick stays the candidate unless the swap-ins
            # above filled its tenant's in-flight share
            if head is not None and not self._tenant_full(head.tenant):
                req = head
            else:
                req = self._pick_queued()
            head = None
            if req is None:
                break  # every queued request is tenant-capped
            hit = None
            if self.prefix_cache is not None:
                # a blocked head-of-queue request reuses its previous
                # match while the tree is unchanged (no re-walk, no
                # inflated lookup stats, no LRU bump)
                key = (req.req_id, self.prefix_cache.mutations)
                if self._match_memo is not None \
                        and self._match_memo[0] == key:
                    hit = self._match_memo[1]
                else:
                    # cap the match one token short of the prompt: the
                    # LAST prompt position must run through the model
                    # to give the logits of the first new token
                    hit = self.prefix_cache.match(
                        req.prompt_ids, limit=len(req.prompt_ids) - 1,
                        align=self.prefix_align)
                    self._match_memo = (key, hit)
                if hit.length:
                    # protect the matched chain from the evictor until
                    # the request retires
                    self.prefix_cache.pin(hit.path)
            hit_len = hit.length if hit is not None else 0
            need = self._pages_needed(req, hit_tokens=hit_len)
            total, free = self._pool()
            # admit only if the worst-case reservation keeps the pool
            # under the watermark (already-used pages are no longer
            # free, so active reservations count only their growth)
            projected = (total - free) + self._reserved_pages_outstanding() \
                + need
            evicted = False
            if (projected > self.page_watermark * total
                    and self.prefix_cache is not None):
                # cached pages count as used: reclaim unpinned cached
                # chains (LRU leaf first) before refusing
                deficit = int(np.ceil(
                    projected - self.page_watermark * total))
                if self.prefix_cache.evict(deficit):
                    evicted = True
                    total, free = self._pool()
                    projected = ((total - free)
                                 + self._reserved_pages_outstanding()
                                 + need)
            preempted = False
            if (projected > self.page_watermark * total
                    and self.swap_space is not None):
                # preempt instead of refusing: swap strictly-lower-
                # priority victims out until the candidate fits, but
                # only when the victims' reachable relief covers the
                # deficit: a victim swapped out for a candidate that
                # still does not fit would be swapped in by the next
                # step's idle capacity and out again, a host-copy
                # ping-pong until the blocking peer retires
                relief, space_blocked = self._releasable_pages(
                    req.priority)
                if relief >= projected - self.page_watermark * total:
                    while projected > self.page_watermark * total:
                        victim = self._pick_victim(
                            max_priority=req.priority)
                        if victim is None or not self._preempt(
                                victim, reason="admit"):
                            break
                        preempted = True
                        total, free = self._pool()
                        projected = ((total - free)
                                     + self._reserved_pages_outstanding()
                                     + need)
                elif space_blocked and self._metrics is not None:
                    # declined because the HOST TIER cannot hold the
                    # victims, not because the pool math falls short
                    self._metrics.inc("serving.preempt_swap_full")
            if projected > self.page_watermark * total:
                if hit_len:
                    self.prefix_cache.unpin(hit.path)
                if self._metrics is not None:
                    self._metrics.inc("serving.admit_reject_pool")
                return hit_tokens_admitted
            if self.draft is not None:
                # the draft pool is budgeted too (it may be sized
                # differently), conservatively: the full worst-case draft
                # need of every active request (used pages count toward
                # it) and this one's must fit under the watermark
                need_d = self._pages_needed(req, self.draft)
                total_d, free_d = self._pool(self.draft)
                out_d = sum(self._pages_needed(r, self.draft)
                            for r in self._active.values())
                if max(out_d, total_d - free_d) + need_d > \
                        self.page_watermark * total_d:
                    # (the reference returns here with the match still
                    # pinned; the port releases it as the pool refusal
                    # above does)
                    if hit_len:
                        self.prefix_cache.unpin(hit.path)
                    if self._metrics is not None:
                        self._metrics.inc(
                            "serving.admit_reject_draft_pool")
                    return hit_tokens_admitted
            self._pop_queued(req)
            self._match_memo = None
            if hit_len:
                # cached prefill: share the matched chain and start
                # prefill at the first uncached token
                self.model.attach_prefix(req.req_id, hit.chains, hit_len)
                req._prefix_hit = hit_len
                req._prefix_path = hit.path
                req._pos = hit_len
                hit_tokens_admitted += hit_len
                if req.on_token is not None:
                    # the skipped prompt tokens still stream in order
                    for t in req.prompt_ids[:hit_len]:
                        req.on_token(req, t, True)
            else:
                self.model.alloc(req.req_id)
            if self.prefix_cache is not None:
                self.prefix_stats["requests"] += 1
                self.prefix_stats["prompt_tokens"] += len(req.prompt_ids)
                self.prefix_stats["hit_tokens"] += hit_len
                if hit_len:
                    self.prefix_stats["request_hits"] += 1
            if self.draft is not None:
                self.draft.alloc(req.req_id)
            # the admitted chains carry the request's trace context from
            # here on (swap records inherit it)
            self._tag_pool_trace(req)
            req.state = RequestState.PREFILL
            if self._cv_state is not None:
                self._cv_state.write()
            self._active[req.req_id] = req
            self._admitted_step += 1
            if self._metrics is not None:
                req._qwait = telemetry.clock() - req._t_submit
                self._metrics.observe("serving.queue_wait_s", req._qwait)
                self._metrics.inc("serving.requests_admitted")
                if evicted:
                    self._metrics.inc("serving.admit_evict_then_admit")
                if preempted:
                    self._metrics.inc("serving.admit_preempt_then_admit")
            if self._traces is not None:
                self._traces.event(
                    req.req_id, "admit", telemetry.clock(),
                    self._step_epoch, prefix_hit_tokens=hit_len,
                    evicted_for_room=evicted)
        return hit_tokens_admitted

    # -- preemption and the host swap tier ---------------------------------
    def _admit_swapped(self, queued_priority=None):
        """Re-admit swapped-out requests (highest priority first, FIFO
        within) while their restore and worst-case growth fit under the
        watermark. A blocked request blocks the ones behind it, so late
        small arrivals never starve a swapped one. ``queued_priority``
        is the best queued candidate's priority: a swapped request of
        STRICTLY lower priority yields to it (restoring first would take
        the last batch slot from the arrival or be preempted again right
        after); equal priority resumes first (it was admitted once and
        its submit order is older)."""
        if not self._swapped:
            return
        if self._faults is not None \
                and self._faults.swap_in_delayed(self._fault_step):
            self._note_fault("delay_swap_in")
            return
        order = sorted(self._swapped.values(),
                       key=lambda r: (-r.priority, r._order))
        for req in order:
            if queued_priority is not None \
                    and req.priority < queued_priority:
                break  # the queue's best outranks the rest of the set
            if len(self._active) >= self.max_batch_size:
                break
            if self._tenant_full(req.tenant):
                continue
            worst = req.total_tokens() + self._spec_slack()
            need = sum(c.swap_in_pages_needed(req.req_id, self.swap_space,
                                              worst)
                       for c in self.model.caches)
            total, free = self._pool()
            projected = (total - free) + self._reserved_pages_outstanding() \
                + need
            if (projected > self.page_watermark * total
                    and self.prefix_cache is not None):
                deficit = int(np.ceil(
                    projected - self.page_watermark * total))
                if self.prefix_cache.evict(deficit):
                    total, free = self._pool()
                    projected = ((total - free)
                                 + self._reserved_pages_outstanding()
                                 + need)
            if projected > self.page_watermark * total:
                break
            self._swap_in(req)

    def _swap_in(self, req: Request):
        """Restore a swapped-out request bit for bit through the pools'
        swap tier and put it back in the active set: resuming is one more
        packed prompt or decode row next step."""
        rid = req.req_id
        with self._req_span("serving.swap_in", req, req=rid):
            restored = self.model.swap_in(rid, self.swap_space)
        # the restored chains re-carry the context
        self._tag_pool_trace(req)
        if self._cv_state is not None:
            self._cv_state.write()
        del self._swapped[rid]
        if self.draft is not None:
            # a fresh (empty) draft chain: the ragged step's refill rows
            # rebuild it from the committed prefix over the next steps,
            # and the row verifies again once the draft has caught up
            self.draft.alloc(rid)
        req.state = (RequestState.DECODE if req.generated_ids
                     else RequestState.PREFILL)
        self._active[rid] = req
        self._admitted_step += 1
        self._step_extras["resumed"] = \
            self._step_extras.get("resumed", 0) + 1
        if self._metrics is not None:
            self._metrics.inc("serving.swap_in_requests")
            self._metrics.inc("serving.swap_in_pages", restored)
        if self._traces is not None:
            self._traces.event(
                req.req_id, "admit", telemetry.clock(),
                self._step_epoch, swapped_in=True, pages=restored)

    def _victim_key(self, r):
        """Victim order: lowest priority first, then most pages held
        (frees the most room), then least progress (throws away the
        least work), then submit order. ONE definition, shared by the
        preempt loop's pick and the relief guard's walk."""
        held = sum(c.seq_page_count(r.req_id) for c in self.model.caches)
        return (r.priority, -held, len(r.generated_ids), r._order)

    def _pick_victim(self, max_priority=None):
        """The preemption victim by :meth:`_victim_key`; ``max_priority``
        restricts to STRICTLY lower priorities (a candidate never
        preempts its own class)."""
        cands = [r for r in self._active.values()
                 if max_priority is None or r.priority < max_priority]
        return min(cands, key=self._victim_key) if cands else None

    def _releasable_pages(self, max_priority):
        """``(pages, space_blocked)``: the relief, in pages, that
        preempting the strictly-lower-priority active victims would buy.
        Each victim frees its private pages (shared pages stay under swap
        holds) and its remaining worst-case reservation leaves the
        projection with it. Victims are walked in the preempt loop's
        order and stop counting at the first whose host copy no longer
        fits the swap space: the loop would stop there too, and
        ``space_blocked`` reports that cut."""
        space = self.swap_space
        victims = sorted((r for r in self._active.values()
                          if r.priority < max_priority),
                         key=self._victim_key)
        budget = space.free_bytes
        pages = 0
        for r in victims:
            nbytes = sum(c.swap_out_nbytes(r.req_id)
                         for c in self.model.caches)
            if nbytes > budget:
                return pages, True
            budget -= nbytes
            for c in self.model.caches:
                pages += (c.swap_out_pages(r.req_id)
                          + self._growth_pages(r, c))
        return pages, False

    def _preempt(self, req: Request, reason: str) -> bool:
        """Swap one active request out to the host tier (``reason``:
        ``"admit"`` or ``"fault"``, for the trace). Returns False (and
        changes nothing) when the swap space cannot hold the victim's
        private pages."""
        rid = req.req_id
        space = self.swap_space
        if space is None:
            return False
        est = sum(c.swap_out_nbytes(rid) for c in self.model.caches)
        if not space.would_fit(est):
            if self._metrics is not None:
                self._metrics.inc("serving.preempt_swap_full")
            return False
        with self._req_span("serving.preempt", req, req=rid,
                            reason=reason):
            freed, nbytes = self.model.swap_out(rid, space)
            if self.draft is not None:
                # ragged spec only (legacy builds no swap space with a
                # draft): the draft KV is disposable, discarded here and
                # refilled after the swap-in; the draft pool never swaps
                self.draft.free(rid)
                self.spec_stats["draft_discards"] += 1
        req.state = RequestState.SWAPPED
        req._preemptions += 1
        if self._cv_state is not None:
            self._cv_state.write()
        self._active.pop(rid)
        self._swapped[rid] = req
        self._step_extras["preempted"] = \
            self._step_extras.get("preempted", 0) + 1
        if self._metrics is not None:
            self._metrics.inc("serving.preempt_victims")
            self._metrics.inc("serving.preempt_pages", freed)
            self._metrics.inc("serving.swap_out_bytes", nbytes)
        if self._traces is not None:
            # non-terminal: the request resumes
            self._traces.event(
                rid, "evict", telemetry.clock(), self._step_epoch,
                reason=reason, pages=freed, bytes=nbytes)
        return True


    # -- disaggregated prefill/decode handoff (inference/disagg.py) --------
    def export_request(self, req_id, mp_shards=1):
        """Hand one prefill-complete active request off to a decode worker:
        swap its page chains out to the host tier bit for bit (payload and
        int8 scale rows), serialize them over the versioned
        ``HostKVSwapSpace`` wire format (one payload per ``mp`` shard,
        split on the KV-head axis) and return the handoff envelope:
        request metadata (prompt, committed tokens, budget, priority,
        tenant, remaining deadline, trace wire) plus the payloads. The
        request leaves THIS scheduler in state ``migrated`` with a
        terminal ``handoff`` trace event; the receiving scheduler's
        :meth:`adopt_swapped` re-registers it and resumes decode through
        the ordinary swap-in path, so the streamed output is the one it
        would have had without moving. Needs the host swap tier
        (``FLAGS_serving_swap_bytes``); a chain still sharing pages with
        the prefix cache cannot travel (``SwapWireError``). Runs on the
        stepping thread."""
        req = self._active.get(req_id)
        if req is None:
            raise KeyError(
                f"export_request({req_id!r}): not an active request")
        space = self.swap_space
        if space is None:
            raise RuntimeError(
                "export_request needs the host swap tier — construct "
                "the scheduler with preempt=True and swap_bytes>0 "
                "(FLAGS_serving_preempt / FLAGS_serving_swap_bytes)")
        if self.draft is not None:
            raise RuntimeError(
                "export_request: speculative scheduling keeps a "
                "draft-model KV pool that cannot travel — hand off "
                "from non-speculative schedulers only")
        if req._pos < len(req.prompt_ids) or not req.generated_ids:
            raise ValueError(
                f"export_request({req_id!r}): prefill incomplete "
                f"({req._pos}/{len(req.prompt_ids)} prompt tokens, "
                f"{len(req.generated_ids)} committed) — decode "
                "workers adopt only prefill-complete chains")
        if self.prefix_cache is not None and req._prefix_path:
            # drop the radix pins; pages STILL shared with the tree after
            # this stay on the device and export_seq refuses them
            self.prefix_cache.unpin(req._prefix_path)
            req._prefix_path = ()
        est = sum(c.swap_out_nbytes(req_id) for c in self.model.caches)
        if not space.would_fit(est):
            raise SwapSpaceFull(
                f"export_request({req_id!r}): the handoff staging "
                f"needs {est} bytes, {space.free_bytes} of "
                f"{space.capacity_bytes} free")
        self._tag_pool_trace(req)
        with self._req_span("serving.handoff_out", req, req=req_id,
                            shards=int(mp_shards)):
            self.model.swap_out(req_id, space)
            payloads = space.export_seq(
                req_id, list(self.model.caches), mp_shards=mp_shards)
        deadline_left = None
        if req._t_deadline:
            deadline_left = max(req._t_deadline - telemetry.clock(), 1e-3)
        elif req.deadline_s is not None:
            deadline_left = float(req.deadline_s)
        ctx = req.trace_ctx
        wire = None
        if ctx is not None:
            wire = ctx if isinstance(ctx, str) else ctx.to_wire()
        req.state = RequestState.MIGRATED
        if self._cv_state is not None:
            self._cv_state.write()
        self._active.pop(req_id)
        self._step_extras["migrated"] = \
            self._step_extras.get("migrated", 0) + 1
        wire_bytes = sum(len(p) for p in payloads)
        if self._metrics is not None:
            self._metrics.inc("serving.handoff_out_requests")
            self._metrics.inc("serving.handoff_out_bytes", wire_bytes)
        if self._traces is not None:
            # terminal ON THIS WORKER only: the decode worker's
            # adopt_swapped continues the same trace id
            self._traces.complete(
                req_id, "handoff", telemetry.clock(), self._step_epoch,
                shards=int(mp_shards), wire_bytes=wire_bytes,
                generated_tokens=len(req.generated_ids))
        return {
            "req": {
                "req_id": req.req_id,
                "prompt_ids": list(req.prompt_ids),
                "generated_ids": list(req.generated_ids),
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id,
                "priority": req.priority,
                "tenant": req.tenant,
                "deadline_s": deadline_left,
                "trace_ctx": wire,
            },
            "payloads": payloads,
        }

    def adopt_swapped(self, req, payloads):
        """Adopt a handed-off request from a prefill worker: restore its
        page-chain payloads into THIS scheduler's host swap tier (magic,
        version, shard set and geometry validated loudly) and register
        the request as swapped out: the next step's ``_admit_swapped`` /
        ``_swap_in`` restore the chains bit for bit and decode resumes
        where the prefill worker stopped. The trace identity rides the
        swap records (``swap_space.trace_context(req_id)`` is the
        decode-side ingress), so the request's spans on both workers
        share ONE trace id. Runs on the stepping thread (the async engine
        marshals it through ``ServingEngine.adopt``)."""
        rid = req.req_id
        if (rid in self._active or rid in self._swapped
                or rid in self._finished
                or any(r.req_id == rid for r in self._queue)):
            raise ValueError(
                f"adopt_swapped({rid!r}): this scheduler already "
                "knows the request id")
        space = self.swap_space
        if space is None:
            raise RuntimeError(
                "adopt_swapped needs the host swap tier — construct "
                "the scheduler with preempt=True and swap_bytes>0 "
                "(FLAGS_serving_preempt / FLAGS_serving_swap_bytes)")
        if self.draft is not None:
            raise RuntimeError(
                "adopt_swapped: speculative scheduling cannot adopt "
                "a foreign chain (the draft pool never saw the "
                "prompt)")
        if not req.generated_ids:
            raise ValueError(
                f"adopt_swapped({rid!r}): no committed token rides "
                "the envelope — only prefill-complete requests hand "
                "off")
        space.import_seq(rid, payloads, list(self.model.caches))
        req._pos = len(req.prompt_ids)
        req.state = RequestState.SWAPPED
        self._submit_seq += 1
        req._order = self._submit_seq
        if req.deadline_s is not None:
            req._t_deadline = telemetry.clock() + float(req.deadline_s)
        if req.trace_ctx is None:
            # the decode-side trace ingress: the identity the swap
            # records carried over the wire
            req.trace_ctx = space.trace_context(rid)
        if self._metrics is not None or self._traces is not None \
                or self._tracer is not None:
            ctx = req.trace_ctx
            if isinstance(ctx, str):
                ctx = telemetry.TraceContext.from_wire(ctx)
            if ctx is None:
                ctx = telemetry.TraceContext(
                    tenant=req.tenant, deadline_s=req.deadline_s)
            req.trace_ctx = ctx
        if self._metrics is not None:
            req._t_submit = telemetry.clock()
            # the NEXT token's inter-token gap starts at adoption
            req._t_last_tok = req._t_submit
            self._metrics.inc("serving.handoff_in_requests")
            self._metrics.inc("serving.handoff_in_bytes",
                              sum(len(p) for p in payloads))
        if self._traces is not None:
            payload = {"adopted": True,
                       "prompt_tokens": len(req.prompt_ids),
                       "generated_tokens": len(req.generated_ids),
                       "max_new_tokens": req.max_new_tokens}
            if req.trace_ctx is not None:
                payload["trace_id"] = req.trace_ctx.trace_id
            self._traces.begin(rid, telemetry.clock(), self._step_epoch,
                               **payload)
        if self._cv_state is not None:
            self._cv_state.write()
        self._swapped[rid] = req
        return rid

    def apply_capacity_config(self, config: dict) -> dict:
        """Step-boundary capacity seam (the scheduler half of
        ``framework.autotuner.apply_config``): retarget the
        scheduler-owned capacity knobs (chunk budget, bucket ladder, host
        swap budget) on a LIVE scheduler. Runs on the thread that drives
        :meth:`step` and only between steps: a call from inside a step
        raises, because a chunk budget that changes under
        ``_step_impl`` would desynchronize the packed feed being built.
        Unknown keys are ignored; returns the knobs actually changed."""
        if self._in_step:
            raise RuntimeError(
                "apply_capacity_config called mid-step — capacity "
                "knobs may only change at step boundaries (post it "
                "through ServingEngine.apply_config, or call "
                "between step()s)")
        applied = {}
        if "prefill_chunk_tokens" in config:
            v = max(1, int(config["prefill_chunk_tokens"]))
            if v != self.prefill_chunk_tokens:
                self.prefill_chunk_tokens = v
                applied["prefill_chunk_tokens"] = v
        if "serving_buckets" in config:
            bl = _parse_buckets(config["serving_buckets"])
            if bl != self.serving_buckets:
                self.serving_buckets = bl
                applied["serving_buckets"] = ",".join(str(b) for b in bl)
        if "serving_swap_bytes" in config and self.swap_space is not None:
            # never shrink below what is already resident: swapped chains
            # stay valid, the tier just stops admitting more
            v = max(int(config["serving_swap_bytes"]),
                    self.swap_space.used_bytes)
            if v != self.swap_space.capacity_bytes:
                self.swap_space.capacity_bytes = v
                applied["serving_swap_bytes"] = v
        return applied

    # -- deadlines and cancel ----------------------------------------------
    def _expire_deadlines(self):
        """Abort every request whose deadline passed, queued, active or
        swapped out alike, at the step boundary (never mid-model-call)."""
        now = telemetry.clock()

        def gone(req):
            return req._t_deadline and now >= req._t_deadline

        for req in [r for r in self._queue if gone(r)]:
            if self._cv_queue is not None:
                self._cv_queue.write()
            self._queue.remove(req)
            self._abort_deadline(req, "queued")
        for req in [r for r in self._active.values() if gone(r)]:
            self._abort_deadline(req, "active")
        for req in [r for r in self._swapped.values() if gone(r)]:
            self._abort_deadline(req, "swapped")

    def _abort_deadline(self, req: Request, where: str,
                        reason: str = "deadline"):
        """Terminal abort: release EVERY reservation the request holds
        (pins, pages, swap records), count it and close its trace. Lands
        in ``result()`` with state ``aborted_deadline``. ``reason`` only
        labels the trace event (a cancel is an abort)."""
        rid = req.req_id
        if self.prefix_cache is not None and req._prefix_path:
            self.prefix_cache.unpin(req._prefix_path)
            req._prefix_path = ()
        if self._cv_state is not None:
            self._cv_state.write()
        if where == "active":
            self.model.free(rid)
            if self.draft is not None:
                self.draft.free(rid)
            self._active.pop(rid)
        elif where == "swapped":
            for c in self.model.caches:
                c.swap_discard(rid, self.swap_space)
            del self._swapped[rid]
        req.state = RequestState.ABORTED_DEADLINE
        self._finished[rid] = req
        self._step_extras["aborted"] = \
            self._step_extras.get("aborted", 0) + 1
        if self._metrics is not None:
            self._metrics.inc("serving.aborted_deadline")
            self._slo_note_abort(req)
        if self._traces is not None:
            self._traces.complete(
                rid, "abort", telemetry.clock(), self._step_epoch,
                reason=reason, where=where,
                generated_tokens=len(req.generated_ids))

    def expire_queued_deadlines(self) -> int:
        """Abort *queued* requests whose deadline already passed without
        waiting for the next step boundary. Returns how many were
        aborted."""
        if not self._queue:
            return 0
        now = telemetry.clock()
        expired = [r for r in self._queue
                   if r._t_deadline and now >= r._t_deadline]
        for req in expired:
            if self._cv_queue is not None:
                self._cv_queue.write()
            self._queue.remove(req)
            self._abort_deadline(req, "queued")
        return len(expired)

    def cancel(self, req_id: str, reason: str = "cancelled") -> bool:
        """Abort one request by id wherever it lives (queued, active or
        swapped out), releasing every reservation it holds, exactly like
        a deadline abort (the same counter, SLO miss and terminal
        ``aborted_deadline`` state; the trace event carries ``reason``).
        Returns False when the id is unknown or already terminal."""
        for req in self._queue:
            if req.req_id == req_id:
                if self._cv_queue is not None:
                    self._cv_queue.write()
                self._queue.remove(req)
                self._abort_deadline(req, "queued", reason=reason)
                return True
        if req_id in self._active:
            self._abort_deadline(self._active[req_id], "active",
                                 reason=reason)
            return True
        if req_id in self._swapped:
            self._abort_deadline(self._swapped[req_id], "swapped",
                                 reason=reason)
            return True
        return False

    def _slo_note_abort(self, req: Request):
        """A deadline abort is an SLO MISS: it enters the goodput window
        with every configured SLO unmet, so attainment stays truthful
        under overload."""
        if self._slo is None:
            return
        met = {key: False
               for key in self._slo.request_meets(None, None, None)}
        self._slo_window.append((self._step_epoch, False, met))
        self._publish_slo_gauges()

    # -- telemetry helpers ---------------------------------------------------
    def _span(self, name, **attrs):
        """Span context of a step phase; NULL_SPAN when no tracer is
        live."""
        tr = self._tracer
        return tr.span(name, **attrs) if tr is not None else _NULL

    def _req_span(self, name, request, **attrs):
        """Request-scoped span, recorded under the request's
        :class:`telemetry.TraceContext`, so one request's spans stitch
        across steps and preemption round trips. NULL_SPAN when no
        tracer is live."""
        tr = self._tracer
        if tr is None:
            return _NULL
        ctx = request.trace_ctx
        if not isinstance(ctx, telemetry.TraceContext):
            return tr.span(name, **attrs)
        return telemetry.span_in(tr, ctx, name, **attrs)

    def _tag_pool_trace(self, req):
        """Stamp the request's serialized TraceContext onto its page
        chains (the pools' ``set_trace_context``): the swap records then
        carry the trace across preemption."""
        ctx = req.trace_ctx
        if ctx is None:
            return
        # an ingress-provided context under FLAGS_telemetry=off stays
        # the raw wire string: propagate it as is
        wire = ctx if isinstance(ctx, str) else ctx.to_wire()
        for c in self.model.caches:
            fn = getattr(c, "set_trace_context", None)
            if fn is not None:
                fn(req.req_id, wire)

    def _note_gen_token(self, req: Request):
        """TTFT/TPOT accounting, right after a GENERATED token was
        appended (prompt tokens never count): the first token closes the
        submit-to-first-token span (TTFT), later tokens record the
        inter-token gap (TPOT). A speculative round commits a burst, so
        its intra-round gaps are near zero: that is what the client
        sees."""
        if self._traces is not None:
            self._traces.event(
                req.req_id, "token", telemetry.clock(), self._step_epoch,
                token=req.generated_ids[-1], n=len(req.generated_ids))
        if self._metrics is None:
            return
        self._metrics.inc("serving.generated_tokens")
        now = telemetry.clock()
        # the OpenMetrics exemplar: the trace id behind the bucket
        ex = req.trace_ctx.trace_id if req.trace_ctx is not None else None
        if len(req.generated_ids) == 1:
            req._ttft = now - req._t_submit
            self._metrics.observe("serving.ttft_s", req._ttft,
                                  exemplar=ex)
        else:
            gap = now - req._t_last_tok
            self._metrics.observe("serving.tpot_s", gap, exemplar=ex)
            if req._gaps is None:
                req._gaps = []
            req._gaps.append(gap)
        req._t_last_tok = now

    def _slo_note_retire(self, req: Request):
        """Per-request SLO verdicts at retire: record the request in the
        goodput window (keyed by epoch) and republish the attainment
        gauges. Returns the per-SLO verdicts (None without an SLO)."""
        if self._slo is None:
            return None
        met = self._slo.request_meets(
            req._ttft, telemetry.SLOConfig.p99(req._gaps or []),
            req._qwait)
        ok = all(met.values())
        self._slo_window.append((self._step_epoch, ok, met))
        self._slo_met_all += ok
        for key, v in met.items():
            self._slo_met[key] += v
        self._publish_slo_gauges()
        return met

    def _publish_slo_gauges(self):
        """Prune the goodput window to the trailing step epochs and
        publish serving.goodput and the per-SLO attainment. An EMPTY
        window republishes goodput 1.0 with slo_window_requests 0, so a
        stale miss never outlives its window."""
        if self._slo is None:
            return
        lo = self._step_epoch - self._win
        win = self._slo_window
        while win and win[0][0] < lo:
            _, ok, met = win.popleft()
            self._slo_met_all -= ok
            for key, v in met.items():
                self._slo_met[key] -= v
        m = self._metrics
        n = len(win)
        m.gauge("serving.slo_window_requests", n)
        if not win:
            if m.gauge_value("serving.goodput") is not None:
                m.gauge("serving.goodput", 1.0)
                for key in self._slo.request_meets(None, None, None):
                    m.gauge("serving.slo_attain_" + key, 1.0)
            return
        m.gauge("serving.goodput", self._slo_met_all / n)
        for key in win[0][2]:
            m.gauge("serving.slo_attain_" + key, self._slo_met[key] / n)

    def _retire(self, req: Request):
        # span and histogram gate independently: an armed tracer with
        # metrics off still gets its retire spans
        t0 = telemetry.clock() if self._metrics is not None else 0.0
        with self._req_span("serving.retire", req, req=req.req_id):
            self._retire_impl(req)
        met = None
        if self._metrics is not None:
            self._metrics.observe("serving.retire_s",
                                  telemetry.clock() - t0)
            self._metrics.inc("serving.requests_finished")
            met = self._slo_note_retire(req)
        if self._traces is not None:
            self._traces.complete(
                req.req_id, "retire", telemetry.clock(), self._step_epoch,
                generated_tokens=len(req.generated_ids),
                prefix_hit_tokens=req._prefix_hit, slo_met=met)
        req.state = RequestState.FINISHED
        if self._cv_state is not None:
            self._cv_state.write()
        del self._active[req.req_id]
        self._finished[req.req_id] = req

    def _retire_impl(self, req: Request):
        rid = req.req_id
        if self.prefix_cache is not None:
            # keep the sequence's prefix: insert the cached tokens
            # (everything appended; the newest sampled token never was)
            # into the tree, which increfs the pages, so the free()
            # below drops only THIS sequence's references
            n = self.model.caches[0].seq_len(rid)
            toks = (req.prompt_ids + req.generated_ids)[:n]
            self.prefix_stats["inserted_tokens"] += \
                self.prefix_cache.insert(toks,
                                         self.model.seq_page_chains(rid))
            if req._prefix_path:
                self.prefix_cache.unpin(req._prefix_path)
                req._prefix_path = ()
        self.model.free(rid)
        if self.draft is not None:
            self.draft.free(rid)

    def _commit_token(self, req: Request, tok: int) -> int:
        """Append a generated token; returns 1 if the request retired."""
        req.generated_ids.append(tok)
        self._note_gen_token(req)
        if req.on_token is not None:
            req.on_token(req, tok, False)
        if self._done(req, tok):
            self._retire(req)
            return 1
        return 0

    # -- the step ----------------------------------------------------------
    def step(self) -> dict:
        """One scheduler iteration: expire deadlines, admit (swapped-out
        requests first), advance the active set, retire completions.
        Returns event counters (admitted/advanced/finished, the prompt
        tokens taken from the prefix cache, the prefill/decode token
        split and, under chunked prefill, chunk_utilization and the
        adapter's packed-shape count) plus, on steps that had them, the
        ``preempted``/``resumed``/``aborted`` counts and the ``faulted``
        kinds.

        Under telemetry the iteration is a ``serving.step`` span and its
        counters land in the ``serving.*`` registry namespace
        (:meth:`metrics`); every ``FLAGS_telemetry_watchdog_stride``
        steps the gauges refresh, the watchdog runs and the Prometheus
        export (``FLAGS_telemetry_export_path``) is rewritten."""
        t0 = 0.0
        if self._metrics is not None:
            # advance the epoch FIRST: every observation of this step is
            # stamped with it (the deterministic window key)
            self._step_epoch = self._metrics.advance_epoch()
            self._steps += 1
            t0 = telemetry.clock()
        elif self._traces is not None:
            # an armed tracing window with metrics off still collects
            # request traces: the epoch must advance for them
            self._step_epoch += 1
        self._in_step = True
        try:
            with self._span("serving.step"):
                ev = self._step_impl()
        finally:
            self._in_step = False
        if self._step_extras:
            ev.update(self._step_extras)
        if self._metrics is not None:
            m = self._metrics
            m.inc("serving.steps")
            m.inc("serving.prefill_tokens", ev.get("prefill_tokens", 0))
            m.inc("serving.decode_tokens", ev.get("decode_tokens", 0))
            m.inc("serving.prefix_hit_tokens",
                  ev.get("prefix_hit_tokens", 0))
            m.observe("serving.step_wall_s", telemetry.clock() - t0)
            cc = getattr(self.model, "compile_count", None)
            if cc is not None:
                # the shared gauge is last-writer-wins across
                # schedulers; the per-scheduler one is the truthful one
                m.gauge("serving.compile_count", cc)
                m.gauge("serving.compile_count." + self._sched_uid, cc)
            apc = getattr(self.model, "attend_program_count", None)
            if apc is not None:
                m.gauge("serving.attend_programs", apc)
                m.gauge("serving.attend_programs." + self._sched_uid, apc)
            # stride on THIS scheduler's step count (the shared epoch
            # advances once per step of every scheduler)
            if self._steps % self._wd_stride == 0:
                self._observability_epoch()
        return ev

    def _observability_epoch(self):
        """The watchdog-stride pass: refresh the gauges, republish the
        ledger, run the watchdog (read-only; evidence such as the
        sanitizer journal tail is gathered here and handed in) and
        rewrite the Prometheus export. Any fire, warn or strict, writes
        an incident bundle before a strict error propagates."""
        self._publish_gauges()
        if self._ledger is not None:
            self._ledger.publish()
        context = None
        if self._watchdog is not None:
            context = {}
            cc = getattr(self.model, "compile_count", None)
            if cc is not None:
                context["compile_count"] = cc
            # the journal tail of the pool with the most violations,
            # draft pools included
            caches = list(self.model.caches) + (
                list(self.draft.caches) if self.draft is not None else [])
            worst, worst_n = None, 0
            for c in caches:
                san = getattr(c, "sanitizer", None)
                if san is None:
                    continue
                n = san.stats().get("violations", 0)
                if n > worst_n:
                    worst, worst_n = san, n
            if worst is not None:
                context["sanitizer_journal_tail"] = worst.tail(16)
            if self._csan is not None and self._csan.has_events():
                context["concurrency_journal_tail"] = self._csan.tail(16)
            try:
                fired = self._watchdog.check(self._step_epoch,
                                             context=context or None)
            except Exception as e:
                # strict mode raises at the detecting step: write the
                # bundle first, then let the error propagate
                evs = getattr(e, "events", None)
                if evs is not None:
                    self._record_incident(evs, context)
                raise
            if fired:
                self._record_incident(fired, context)
        if self._export_path is not None:
            # a scrape-file failure must never take serving down: warn
            # once and stop trying
            try:
                telemetry.write_prometheus(self._export_path,
                                           registry=self._metrics)
            except OSError as e:
                warnings.warn(
                    "FLAGS_telemetry_export_path "
                    f"({self._export_path!r}) is unwritable: {e}; "
                    "disabling the periodic Prometheus export",
                    RuntimeWarning)
                self._export_path = None

    def _record_incident(self, events, context):
        """Write one incident bundle for a watchdog trip (no-op without
        a recorder); a write failure warns once and stops recording."""
        if self._recorder is None:
            return
        try:
            self._recorder.record(events, context=context)
        except OSError as e:
            warnings.warn(
                "FLAGS_telemetry_incident_dir is unwritable "
                f"({e}); disabling the incident flight recorder",
                RuntimeWarning)
            self._recorder = None

    def dump_incident(self, reason: str = "manual"):
        """Write an incident bundle NOW (gauges and ledger republished
        first) under ``FLAGS_telemetry_incident_dir``. Returns the bundle
        path, or None when no recorder is configured."""
        if self._recorder is None:
            return None
        self._publish_gauges()
        if self._ledger is not None:
            self._ledger.publish()
        return self._recorder.dump_incident(reason=reason)

    def _noop_event(self) -> dict:
        return {"admitted": 0, "advanced": 0, "finished": 0,
                "prefix_hit_tokens": 0, "prefill_tokens": 0,
                "decode_tokens": 0}

    def _note_fault(self, kind: str):
        """Annotate the step event with an active fault kind; two kinds
        on one step are joined with "+"."""
        cur = self._step_extras.get("faulted")
        if cur is None:
            self._step_extras["faulted"] = kind
        elif kind not in cur.split("+"):
            self._step_extras["faulted"] = cur + "+" + kind

    def _fault_gate(self):
        """Simulated step failure with retry and back-off: a
        ``fail_step`` fault abandons the attempt BEFORE the model call
        (nothing was mutated, so the retry is safe); consecutive failures
        back off exponentially (0, 1, 3, 7, at most 8 skipped steps).
        Returns a no-op event while failing or backing off, None to run
        the step."""
        if self._faults is None:
            return None
        step = self._fault_step
        if step < self._resume_at:
            self._note_fault("backoff")
            if self._metrics is not None:
                self._metrics.inc("serving.step_backoff_steps")
            return self._noop_event()
        if self._faults.fail_step(step):
            self._consec_fails += 1
            skip = min(2 ** (self._consec_fails - 1) - 1, 8)
            self._resume_at = step + 1 + skip
            self._note_fault("fail_step")
            if self._metrics is not None:
                self._metrics.inc("serving.step_retries")
            return self._noop_event()
        self._consec_fails = 0
        return None

    def _step_impl(self) -> dict:
        self._step_extras = {}
        self._fault_step += 1
        noop = self._fault_gate()
        if noop is not None:
            return noop
        self._expire_deadlines()
        if self._faults is not None:
            # forced preemption storm: swap out N victims regardless of
            # pool pressure (they must restore bit for bit later)
            n = self._faults.forced_preemptions(self._fault_step)
            if n:
                self._note_fault("preempt_storm")
                for _ in range(n):
                    victim = self._pick_victim()
                    if victim is None or not self._preempt(
                            victim, reason="fault"):
                        break
        self._sanitizer_epoch()
        self._admitted_step = 0
        with self._span("serving.admit"):
            hit_tokens = self._try_admit()
            if (self._swapped and self._admitted_step == 0
                    and len(self._active) < self.max_batch_size
                    and not self._step_extras.get("faulted")):
                # the queue's best candidate (which swapped requests of
                # lower priority yielded to) turned out to be blocked
                # this step: hand the idle capacity to the swapped set
                # after all. Not on faulted steps: an exhaust or delay
                # window keeps swap-in blocked
                self._admit_swapped(None)
        # admissions and swap-in resumes, not the active-set delta (a
        # preempt-then-reject step would report a negative count)
        admitted = self._admitted_step
        if not self._active:
            return {"admitted": admitted, "advanced": 0, "finished": 0,
                    "prefix_hit_tokens": hit_tokens,
                    "prefill_tokens": 0, "decode_tokens": 0}
        if self.draft is not None:
            if self._spec_ragged:
                return self._step_spec_ragged(admitted, hit_tokens)
            return self._step_spec(admitted)
        if self.chunked_prefill:
            return self._step_chunked(admitted, hit_tokens)

        sids = sorted(self._active)
        feed = []
        n_pre = 0
        for s in sids:
            req = self._active[s]
            if req.state == RequestState.PREFILL:
                feed.append(req.prompt_ids[req._pos])
                n_pre += 1
            else:
                feed.append(req.generated_ids[-1])
        # one serving.decode span covers the model call AND the commit
        # loop, as on the chunked path (retire spans nest inside)
        with self._span("serving.decode", rows=len(sids), prefill=n_pre):
            # the ledger's stamp: the model call and its device-to-host
            # copy (which waits for the device) are the program's wall
            t_exec = telemetry.clock() if self._metrics is not None \
                else 0.0
            logits_np = _logits_to_host(self.model.decode_token(feed, sids))
            if self._metrics is not None:
                self._metrics.observe("exec.wall_s.decode_token",
                                      telemetry.clock() - t_exec)
                self._metrics.inc("exec.count.decode_token")
            finished = 0
            for bi, s in enumerate(sids):
                req = self._active[s]
                if req.state == RequestState.PREFILL:
                    tok = req.prompt_ids[req._pos]
                    req._pos += 1
                    if self._traces is not None:
                        # token-per-step prefill is a 1-token chunk
                        self._traces.event(
                            req.req_id, "prefill_chunk", telemetry.clock(),
                            self._step_epoch, tokens=1, pos=req._pos)
                    if req.on_token is not None:
                        req.on_token(req, tok, True)
                    if req._pos == len(req.prompt_ids):
                        if req.max_new_tokens == 0:
                            # prefill-only (scoring): no sampling
                            self._retire(req)
                            finished += 1
                            continue
                        req.state = RequestState.DECODE
                        # the last prompt position's logits sample the
                        # first generated token
                        finished += self._commit_token(
                            req, self.sampler(logits_np[bi]))
                    continue
                finished += self._commit_token(
                    req, self.sampler(logits_np[bi]))
        return {
            "admitted": admitted,
            "advanced": len(sids),
            "finished": finished,
            "prefix_hit_tokens": hit_tokens,
            "prefill_tokens": n_pre,
            "decode_tokens": len(sids) - n_pre,
        }

    def _chunk_feeds(self, sids):
        """Pack one ragged step: EVERY decode row (one token each) plus up
        to ``prefill_chunk_tokens`` pending prompt tokens, split across
        prefilling sequences in id order and resuming mid-prompt. Returns
        (rows, feeds, starts, prefill_tokens, decode_rows)."""
        budget = self.prefill_chunk_tokens
        rows, feeds, starts = [], [], []
        n_pre = n_dec = 0
        for s in sids:
            req = self._active[s]
            if req.state == RequestState.DECODE:
                rows.append(s)
                feeds.append([req.generated_ids[-1]])
                starts.append(self.model.caches[0].seq_len(s))
                n_dec += 1
            elif budget > 0:
                take = min(len(req.prompt_ids) - req._pos, budget)
                budget -= take
                rows.append(s)
                feeds.append(req.prompt_ids[req._pos:req._pos + take])
                starts.append(req._pos)
                n_pre += take
        return rows, feeds, starts, n_pre, n_dec

    def _advance_prefill_row(self, req, toks, logits_row) -> int:
        """Commit one chunk of prompt tokens for a PREFILL row; when the
        chunk finishes the prompt, retire (prefill-only) or sample the
        first generated token. Returns 1 if the request retired."""
        req._pos += len(toks)
        if self._traces is not None:
            self._traces.event(
                req.req_id, "prefill_chunk", telemetry.clock(),
                self._step_epoch, tokens=len(toks), pos=req._pos)
        if req.on_token is not None:
            for t in toks:
                req.on_token(req, t, True)
        if req._pos < len(req.prompt_ids):
            return 0
        if req.max_new_tokens == 0:
            self._retire(req)
            return 1
        req.state = RequestState.DECODE
        return self._commit_token(req, self.sampler(logits_row))

    def _step_chunked(self, admitted, hit_tokens) -> dict:
        """Chunked-prefill step: one ragged ``prefill_chunk`` call
        advances every decode row by one token and every budget-reached
        prefill row by its whole chunk."""
        sids = sorted(self._active)
        rows, feeds, starts, n_pre, n_dec = self._chunk_feeds(sids)
        packed = sum(len(f) for f in feeds)
        pad_to = bucket_packed_tokens(packed, self.serving_buckets)
        t_exec = telemetry.clock() if self._metrics is not None else 0.0
        with self._span("serving.prefill_chunk", rows=len(rows),
                        packed=packed, pad_to=pad_to, prefill=n_pre,
                        decode=n_dec):
            logits_np = _logits_to_host(self.model.prefill_chunk(
                feeds, rows, starts, pad_to=pad_to))
        if self._metrics is not None:
            # the ledger's stamp closes after the logits reached the
            # host: the wall of the device work, not of the launches
            self._metrics.observe("exec.wall_s.prefill_chunk",
                                  telemetry.clock() - t_exec)
            self._metrics.inc("exec.count.prefill_chunk")
        finished = 0
        with self._span("serving.decode", rows=len(rows)):
            for bi, s in enumerate(rows):
                req = self._active[s]
                if req.state == RequestState.PREFILL:
                    finished += self._advance_prefill_row(
                        req, feeds[bi], logits_np[bi])
                    continue
                finished += self._commit_token(
                    req, self.sampler(logits_np[bi]))

        cs = self.chunk_stats
        cs["steps"] += 1
        cs["chunk_calls"] += 1
        cs["prefill_tokens"] += n_pre
        cs["decode_tokens"] += n_dec
        cs["packed_tokens"] += packed
        cs["padded_tokens"] += pad_to - packed
        return {
            "admitted": admitted,
            "advanced": len(rows),
            "finished": finished,
            "prefix_hit_tokens": hit_tokens,
            "prefill_tokens": n_pre,
            "decode_tokens": n_dec,
            "chunk_utilization": round(packed / pad_to, 4),
            "compile_count": getattr(self.model, "compile_count", None),
            "attend_programs": getattr(
                self.model, "attend_program_count", None),
        }

    # -- speculative decoding ----------------------------------------------
    def _step_spec(self, admitted) -> dict:
        """Legacy speculative step: prefill rows advance on BOTH adapters
        (one ``prefill_chunk`` call each under the shared token budget
        when both implement it, else one prompt token a step through
        ``decode_token``); decode rows run one round each: ``draft_k``
        draft ``decode_token`` proposals, one more feed of the last
        proposal, and one target ``decode_window`` over the
        ``draft_k + 1``-token windows."""
        sids = sorted(self._active)
        pre = [s for s in sids
               if self._active[s].state == RequestState.PREFILL]
        dec = [s for s in sids
               if self._active[s].state == RequestState.DECODE]
        finished = advanced = pre_tokens = dec_tokens = 0

        if pre and self._spec_chunked:
            rows, feeds, starts, n_pre, _ = self._chunk_feeds(pre)
            packed = sum(len(f) for f in feeds)
            pad_to = bucket_packed_tokens(packed, self.serving_buckets)
            with self._span("serving.prefill_chunk", rows=len(rows),
                            packed=packed, pad_to=pad_to, prefill=n_pre,
                            decode=0):
                logits = self.model.prefill_chunk(
                    feeds, rows, starts, pad_to=pad_to)
                # mirror the prompt chunks into the draft's own pool
                self.draft.prefill_chunk(feeds, rows, starts,
                                         pad_to=pad_to)
                # the device-to-host copy belongs to the calls' span
                logits_np = _logits_to_host(logits)
            cs = self.chunk_stats
            cs["steps"] += 1
            cs["chunk_calls"] += 2
            cs["prefill_tokens"] += n_pre
            cs["packed_tokens"] += packed
            cs["padded_tokens"] += pad_to - packed
            pre_tokens = n_pre
            for bi, s in enumerate(rows):
                finished += self._advance_prefill_row(
                    self._active[s], feeds[bi], logits_np[bi])
            advanced += len(rows)
        elif pre:
            feed = [self._active[s].prompt_ids[self._active[s]._pos]
                    for s in pre]
            logits_np = _logits_to_host(self.model.decode_token(feed, pre))
            self.draft.decode_token(feed, pre)  # mirror the prompt
            for bi, s in enumerate(pre):
                finished += self._advance_prefill_row(
                    self._active[s], [feed[bi]], logits_np[bi])
            advanced += len(pre)
            pre_tokens = len(pre)

        if dec:
            k = self.draft_k
            base_t = {s: self.model.caches[0].seq_len(s) for s in dec}
            base_d = {s: self.draft.caches[0].seq_len(s) for s in dec}
            cur = [self._active[s].generated_ids[-1] for s in dec]
            with self._span("serving.decode", rows=len(dec), draft_k=k):
                props = []
                for _ in range(k):
                    cur = _argmax_rows(self.draft.decode_token(cur, dec),
                                       len(dec))
                    props.append(cur)
                # feed the k-th proposal too, so that the draft cache
                # never lags the committed prefix (rejections roll back
                # by truncate)
                self.draft.decode_token(cur, dec)
                windows = np.asarray(
                    [[self._active[s].generated_ids[-1]]
                     + [props[j][i] for j in range(k)]
                     for i, s in enumerate(dec)], np.int64)
                preds = np.argmax(_logits_to_host(
                    self.model.decode_window(windows, dec)), axis=-1)
                self.spec_stats["rounds"] += 1
                self.spec_stats["target_calls"] += 1
                self.spec_stats["draft_calls"] += k + 1
                if self._metrics is not None:
                    self._metrics.inc("serving.spec_rounds")
                # accept, commit, retire and roll back inside the decode
                # span, as on every other path
                for i, s in enumerate(dec):
                    committed, retired = self._commit_spec_row(
                        s, [props[j][i] for j in range(k)], preds[i],
                        base_t[s], base_d[s])
                    dec_tokens += committed
                    finished += int(retired)
            advanced += len(dec)

        # the legacy lowering refuses the prefix cache (see __init__)
        return {"admitted": admitted, "advanced": advanced,
                "finished": finished, "prefix_hit_tokens": 0,
                "prefill_tokens": pre_tokens, "decode_tokens": dec_tokens}

    def _commit_spec_row(self, s, props_i, preds_i, base_t, base_d):
        """Greedy acceptance for ONE decode row, the one rule of both
        lowerings: commit the longest prefix of the draft's proposals
        ``props_i`` that matches the target's argmax ``preds_i`` at each
        of the ``draft_k + 1`` window positions, then the target's token
        after it, and roll both pools back to the committed prefix
        (everything but the newest token, which the next round feeds).
        ``base_t``/``base_d``: the target and draft cache lengths before
        the round. Returns ``(committed, retired)``."""
        req = self._active[s]
        k = len(props_i)
        n_acc = 0
        while n_acc < k and props_i[n_acc] == int(preds_i[n_acc]):
            n_acc += 1
            if req.eos_id is not None and props_i[n_acc - 1] == req.eos_id:
                break
        accepted = list(props_i[:n_acc])
        if req.eos_id is None or not accepted or accepted[-1] != req.eos_id:
            accepted.append(int(preds_i[n_acc]))
        done = False
        committed = 0
        for t in accepted:
            req.generated_ids.append(t)
            self._note_gen_token(req)
            committed += 1
            self.spec_stats["committed_tokens"] += 1
            if req.on_token is not None:
                req.on_token(req, t, False)
            if self._done(req, t):
                done = True
                break
        self.spec_stats["proposed_tokens"] += k
        self.spec_stats["accepted_draft_tokens"] += n_acc
        if self._metrics is not None:
            self._metrics.observe("serving.spec_accept_rate",
                                  (n_acc / k) if k else 0.0)
            self._metrics.inc("serving.spec_committed_tokens", committed)
        if done:
            if self.prefix_cache is not None:
                # retire inserts the chain into the radix tree keyed by
                # the COMMITTED tokens: drop the unverified window tail
                # first, so that cached K/V == committed tokens
                for c in self.model.caches:
                    c.truncate(s, base_t + committed)
            self._retire(req)
            return committed, True
        if self._metrics is not None:
            self._metrics.inc("serving.spec_rollback_tokens",
                              (k + 1) - committed)
        for c in self.model.caches:
            c.truncate(s, base_t + committed)
        for c in self.draft.caches:
            c.truncate(s, base_d + committed)
        return committed, False

    def _step_spec_ragged(self, admitted, hit_tokens) -> dict:
        """Ragged speculative step (``FLAGS_spec_decode=ragged``). The
        draft proposes through its OWN chunked step: call 0 packs every
        propose row (a decode row's newest token) with the draft-refill
        rows and the prompt-mirror chunks, calls 1..k feed the successive
        proposals (the k-th keeps the draft pool at the committed prefix
        plus the window). Then ONE target ``prefill_chunk`` verifies
        every window: each decode row is a right-aligned
        ``draft_k + 1``-token row, listed first, beside the ordinary
        prefill-chunk rows, and ``logits_rows=`` returns the windows'
        per-position logits for :meth:`_commit_spec_row`. No other target
        forward runs.

        Draft-lag rows: after a prefix hit or a swap-in the draft pool is
        behind the committed prefix. Such a decode row does not verify;
        its draft chain is refilled from the committed tokens under the
        chunk budget until it catches up (lag rows first, then prefill
        rows whose draft chain is behind), and it counts as advanced."""
        sids = sorted(self._active)
        t_cache = self.model.caches[0]
        d_cache = self.draft.caches[0]
        k = self.draft_k
        pre, dec, lag = [], [], []
        for s in sids:
            req = self._active[s]
            if req.state == RequestState.PREFILL:
                pre.append(s)
            elif d_cache.seq_len(s) == t_cache.seq_len(s):
                dec.append(s)
            else:
                lag.append(s)
        base_t = {s: t_cache.seq_len(s) for s in dec}
        base_d = {s: d_cache.seq_len(s) for s in dec}
        if pre:
            rows, feeds, starts, n_pre, _ = self._chunk_feeds(pre)
        else:
            rows, feeds, starts, n_pre = [], [], [], 0

        # ---- the draft: propose, refill, mirror
        props = []  # props[j][i]: the (j+1)-th proposal for dec[i]
        lag_refilled = refill_tokens = 0
        t_draft = telemetry.clock() if self._metrics is not None else 0.0
        with self._span("serving.draft_propose", rows=len(dec),
                        refill=len(lag), draft_k=k):
            d_rows = list(dec)
            d_feeds = [[self._active[s].generated_ids[-1]] for s in dec]
            d_starts = [base_d[s] for s in dec]
            d_budget = self.prefill_chunk_tokens
            for s in lag + [r for r in pre
                            if d_cache.seq_len(r) < t_cache.seq_len(r)]:
                if d_budget <= 0:
                    break
                req = self._active[s]
                d_len = d_cache.seq_len(s)
                take = min(t_cache.seq_len(s) - d_len, d_budget)
                if take <= 0:
                    continue
                d_budget -= take
                allt = req.prompt_ids + req.generated_ids
                d_rows.append(s)
                d_feeds.append(allt[d_len:d_len + take])
                d_starts.append(d_len)
                refill_tokens += take
                if req.state == RequestState.DECODE:
                    lag_refilled += 1
            # this step's prompt chunks for draft-synced prefill rows
            for bi, r in enumerate(rows):
                if d_cache.seq_len(r) == starts[bi]:
                    d_rows.append(r)
                    d_feeds.append(feeds[bi])
                    d_starts.append(starts[bi])
            if d_rows:
                pad0 = bucket_packed_tokens(sum(len(f) for f in d_feeds),
                                            self.serving_buckets)
                dl = self.draft.prefill_chunk(d_feeds, d_rows, d_starts,
                                              pad_to=pad0)
            if dec:
                cur = _argmax_rows(dl, len(dec))
                props.append(cur)
                pad_j = bucket_packed_tokens(len(dec), self.serving_buckets)
                for j in range(1, k + 1):
                    dl = self.draft.prefill_chunk(
                        [[c] for c in cur], dec,
                        [base_d[s] + j for s in dec], pad_to=pad_j)
                    # the k-th proposal is fed for the pools' symmetry
                    # with the window; its logits are never sampled
                    if j < k:
                        cur = _argmax_rows(dl, len(dec))
                        props.append(cur)
        if self._metrics is not None:
            # the ledger's stamp of the DRAFT program: its share of the
            # step wall is the overhead the acceptance rate pays for
            self._metrics.observe("exec.wall_s.draft_propose",
                                  telemetry.clock() - t_draft)
            self._metrics.inc("exec.count.draft_propose")
        self.spec_stats["refill_tokens"] += refill_tokens

        # ---- the target: ONE packed ragged step, verify rows first
        t_rows = list(dec) + rows
        t_feeds = [[self._active[s].generated_ids[-1]]
                   + [props[j][i] for j in range(k)]
                   for i, s in enumerate(dec)] + feeds
        t_starts = [base_t[s] for s in dec] + starts
        finished = dec_tokens = 0
        if t_rows:
            packed = sum(len(f) for f in t_feeds)
            pad_to = bucket_packed_tokens(packed, self.serving_buckets)
            t_exec = telemetry.clock() if self._metrics is not None \
                else 0.0
            with self._span("serving.prefill_chunk", rows=len(t_rows),
                            packed=packed, pad_to=pad_to, prefill=n_pre,
                            decode=0, verify=len(dec)):
                out = self.model.prefill_chunk(
                    t_feeds, t_rows, t_starts, pad_to=pad_to,
                    logits_rows=list(range(len(dec))) if dec else None)
                if dec:
                    last, full = out
                    preds = np.argmax(_logits_to_host(full).reshape(
                        len(dec), k + 1, -1), axis=-1)
                else:
                    last = out
                last_np = _logits_to_host(last)
            if self._metrics is not None:
                self._metrics.observe("exec.wall_s.prefill_chunk",
                                      telemetry.clock() - t_exec)
                self._metrics.inc("exec.count.prefill_chunk")
            cs = self.chunk_stats
            cs["steps"] += 1
            cs["chunk_calls"] += 1
            cs["prefill_tokens"] += n_pre
            cs["packed_tokens"] += packed
            cs["padded_tokens"] += pad_to - packed
            if dec:
                self.spec_stats["rounds"] += 1
                self.spec_stats["target_calls"] += 1
                self.spec_stats["draft_calls"] += k + 1
                if self._metrics is not None:
                    self._metrics.inc("serving.spec_rounds")
            with self._span("serving.decode", rows=len(t_rows), draft_k=k):
                for i, s in enumerate(dec):
                    committed, retired = self._commit_spec_row(
                        s, [props[j][i] for j in range(k)], preds[i],
                        base_t[s], base_d[s])
                    dec_tokens += committed
                    finished += int(retired)
                for bi, r in enumerate(rows):
                    finished += self._advance_prefill_row(
                        self._active[r], feeds[bi],
                        last_np[len(dec) + bi])

        ev = {
            "admitted": admitted,
            "advanced": len(t_rows) + lag_refilled,
            "finished": finished,
            "prefix_hit_tokens": hit_tokens,
            "prefill_tokens": n_pre,
            "decode_tokens": dec_tokens,
            "spec_verify_rows": len(dec),
            "compile_count": getattr(self.model, "compile_count", None),
            "attend_programs": getattr(
                self.model, "attend_program_count", None),
        }
        if t_rows:
            ev["chunk_utilization"] = round(packed / pad_to, 4)
        return ev

    def _done(self, req: Request, last_tok: int) -> bool:
        if req.eos_id is not None and last_tok == req.eos_id:
            return True
        return len(req.generated_ids) >= req.max_new_tokens

    def run_until_complete(self, max_steps=10_000) -> dict:
        """Drain the queue and the active and swapped sets; returns the
        terminal requests by id (finished AND aborted: check
        ``req.state``)."""
        for _ in range(max_steps):
            if not self._queue and not self._active and not self._swapped:
                break
            ev = self.step()
            if (ev["advanced"] == 0 and ev["admitted"] == 0
                    and (self._queue or self._swapped)
                    and not ev.get("faulted")
                    and not ev.get("aborted")
                    and not ev.get("preempted")):
                # submit() rejects never-admissible requests and active
                # requests always finish, so this fires only on an
                # accounting bug or external pool interference
                raise RuntimeError(
                    "scheduler stalled: nothing active yet the queue head "
                    f"cannot be admitted; {self.page_pool_stats()}")
        else:
            raise RuntimeError(f"not drained after {max_steps} steps")
        return dict(self._finished)

    # -- introspection -----------------------------------------------------
    @property
    def num_active(self):
        return len(self._active)

    @property
    def num_queued(self):
        return len(self._queue)

    @property
    def num_swapped(self):
        return len(self._swapped)

    @property
    def watchdog(self):
        """The scheduler's Watchdog, or None when telemetry or the
        watchdog is off (read-only)."""
        return self._watchdog

    def result(self, req_id: str) -> Request:
        return self._finished[req_id]
