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

The scheduler is host-side bookkeeping only. Not ported yet, and
refused at construction rather than ignored: fault injection, SLO
accounting and the watchdog.
"""
from __future__ import annotations

import collections
import inspect
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..framework.flags import flag
from ..incubate.nn.paged_cache import HostKVSwapSpace
from .prefix_cache import RadixPrefixCache

__all__ = ["Request", "BatchScheduler", "RequestState",
           "bucket_packed_tokens", "QueueFullError"]

# the deadline clock (seconds); a module attribute so that tests can
# patch it, as the reference's tests patch its telemetry clock
clock = time.monotonic


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
    state: str = RequestState.QUEUED
    generated_ids: List[int] = field(default_factory=list)
    _pos: int = 0  # prompt tokens consumed so far
    _prefix_hit: int = 0  # prompt tokens served from the prefix cache
    _prefix_path: tuple = ()  # pinned radix nodes (unpinned at retire)
    _order: int = 0  # submit sequence number (FIFO within priority)
    _t_deadline: float = 0.0  # absolute clock() deadline (0 = none)
    _preemptions: int = 0  # times this request was swapped out

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


def _not_ported(what):
    raise NotImplementedError(
        f"BatchScheduler: {what} is not ported to paddle_tpu_torch yet")


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
        for what, val in (("fault injection (fault_injector)",
                           fault_injector),
                          ("SLO accounting (slo)", slo),
                          ("the watchdog", watchdog)):
            if val:
                _not_ported(what)
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
        # per-step overload annotations (preempted / resumed / aborted)
        self._step_extras = {}
        self._admitted_step = 0

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
            "shared_pages": sum(c.num_shared_pages for c in caches),
            "cow_forks": sum(c.cow_forks for c in caches),
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
            raise QueueFullError(
                f"request {req.req_id!r} rejected: submit queue at "
                f"capacity ({self.max_queue}); shed load or retry "
                "(FLAGS_serving_max_queue)")
        if req.deadline_s is not None:
            if req.deadline_s <= 0:
                raise ValueError(
                    f"request {req.req_id!r}: deadline_s must be "
                    f"positive, got {req.deadline_s}")
            req._t_deadline = clock() + float(req.deadline_s)
        self._submit_seq += 1
        req._order = self._submit_seq
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
        if self._queue and self._queue[0] is req:
            self._queue.popleft()
        else:
            self._queue.remove(req)

    def _try_admit(self) -> int:
        """Admit queued requests while they fit (swapped-out requests
        first, by :meth:`_admit_swapped`); returns the prompt tokens the
        admitted requests take from the prefix cache."""
        hit_tokens_admitted = 0
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
            if (projected > self.page_watermark * total
                    and self.prefix_cache is not None):
                # cached pages count as used: reclaim unpinned cached
                # chains (LRU leaf first) before refusing
                deficit = int(np.ceil(
                    projected - self.page_watermark * total))
                if self.prefix_cache.evict(deficit):
                    total, free = self._pool()
                    projected = ((total - free)
                                 + self._reserved_pages_outstanding()
                                 + need)
            if (projected > self.page_watermark * total
                    and self.swap_space is not None):
                # preempt instead of refusing: swap strictly-lower-
                # priority victims out until the candidate fits, but
                # only when the victims' reachable relief covers the
                # deficit: a victim swapped out for a candidate that
                # still does not fit would be swapped in by the next
                # step's idle capacity and out again, a host-copy
                # ping-pong until the blocking peer retires
                relief = self._releasable_pages(req.priority)
                if relief >= projected - self.page_watermark * total:
                    while projected > self.page_watermark * total:
                        victim = self._pick_victim(
                            max_priority=req.priority)
                        if victim is None or not self._preempt(victim):
                            break
                        total, free = self._pool()
                        projected = ((total - free)
                                     + self._reserved_pages_outstanding()
                                     + need)
            if projected > self.page_watermark * total:
                if hit_len:
                    self.prefix_cache.unpin(hit.path)
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
            req.state = RequestState.PREFILL
            self._active[req.req_id] = req
            self._admitted_step += 1
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
        self.model.swap_in(rid, self.swap_space)
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

    def _releasable_pages(self, max_priority) -> int:
        """The relief, in pages, that preempting the strictly-lower-
        priority active victims would buy. Each victim frees its private
        pages (shared pages stay under swap holds) and its remaining
        worst-case reservation leaves the projection with it. Victims
        are walked in the preempt loop's order and stop counting at the
        first whose host copy no longer fits the swap space: the loop
        would stop there too."""
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
                break
            budget -= nbytes
            for c in self.model.caches:
                pages += (c.swap_out_pages(r.req_id)
                          + self._growth_pages(r, c))
        return pages

    def _preempt(self, req: Request) -> bool:
        """Swap one active request out to the host tier. Returns False
        (and changes nothing) when the swap space cannot hold the
        victim's private pages."""
        rid = req.req_id
        space = self.swap_space
        est = sum(c.swap_out_nbytes(rid) for c in self.model.caches)
        if not space.would_fit(est):
            return False
        self.model.swap_out(rid, space)
        if self.draft is not None:
            # ragged spec only (legacy builds no swap space with a
            # draft): the draft KV is disposable, discarded here and
            # refilled after the swap-in; the draft pool never swaps
            self.draft.free(rid)
            self.spec_stats["draft_discards"] += 1
        req.state = RequestState.SWAPPED
        req._preemptions += 1
        self._active.pop(rid)
        self._swapped[rid] = req
        self._step_extras["preempted"] = \
            self._step_extras.get("preempted", 0) + 1
        return True

    # -- deadlines and cancel ----------------------------------------------
    def _expire_deadlines(self):
        """Abort every request whose deadline passed, queued, active or
        swapped out alike, at the step boundary (never mid-model-call)."""
        now = clock()

        def gone(req):
            return req._t_deadline and now >= req._t_deadline

        for req in [r for r in self._queue if gone(r)]:
            self._queue.remove(req)
            self._abort_deadline(req, "queued")
        for req in [r for r in self._active.values() if gone(r)]:
            self._abort_deadline(req, "active")
        for req in [r for r in self._swapped.values() if gone(r)]:
            self._abort_deadline(req, "swapped")

    def _abort_deadline(self, req: Request, where: str):
        """Terminal abort: release EVERY reservation the request holds
        (pins, pages, swap records). Lands in ``result()`` with state
        ``aborted_deadline``."""
        rid = req.req_id
        if self.prefix_cache is not None and req._prefix_path:
            self.prefix_cache.unpin(req._prefix_path)
            req._prefix_path = ()
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

    def expire_queued_deadlines(self) -> int:
        """Abort *queued* requests whose deadline already passed without
        waiting for the next step boundary. Returns how many were
        aborted."""
        if not self._queue:
            return 0
        now = clock()
        expired = [r for r in self._queue
                   if r._t_deadline and now >= r._t_deadline]
        for req in expired:
            self._queue.remove(req)
            self._abort_deadline(req, "queued")
        return len(expired)

    def cancel(self, req_id: str) -> bool:
        """Abort one request by id wherever it lives (queued, active or
        swapped out), releasing every reservation it holds, exactly like
        a deadline abort (the same terminal ``aborted_deadline``
        state). Returns False when the id is unknown or already
        terminal."""
        for req in self._queue:
            if req.req_id == req_id:
                self._queue.remove(req)
                self._abort_deadline(req, "queued")
                return True
        if req_id in self._active:
            self._abort_deadline(self._active[req_id], "active")
            return True
        if req_id in self._swapped:
            self._abort_deadline(self._swapped[req_id], "swapped")
            return True
        return False

    def _retire(self, req: Request):
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
        req.state = RequestState.FINISHED
        del self._active[rid]
        self._finished[rid] = req

    def _commit_token(self, req: Request, tok: int) -> int:
        """Append a generated token; returns 1 if the request retired."""
        req.generated_ids.append(tok)
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
        ``preempted``/``resumed``/``aborted`` counts."""
        ev = self._step_impl()
        if self._step_extras:
            ev.update(self._step_extras)
        return ev

    def _step_impl(self) -> dict:
        self._step_extras = {}
        self._expire_deadlines()
        self._admitted_step = 0
        hit_tokens = self._try_admit()
        if (self._swapped and self._admitted_step == 0
                and len(self._active) < self.max_batch_size):
            # the queue's best candidate (which swapped requests of lower
            # priority yielded to) turned out to be blocked this step:
            # hand the idle capacity to the swapped set after all
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
        logits_np = _logits_to_host(self.model.decode_token(feed, sids))
        finished = 0
        for bi, s in enumerate(sids):
            req = self._active[s]
            if req.state == RequestState.PREFILL:
                tok = req.prompt_ids[req._pos]
                req._pos += 1
                if req.on_token is not None:
                    req.on_token(req, tok, True)
                if req._pos == len(req.prompt_ids):
                    if req.max_new_tokens == 0:
                        # prefill-only (scoring): no sampling
                        self._retire(req)
                        finished += 1
                        continue
                    req.state = RequestState.DECODE
                    # the last prompt position's logits sample the first
                    # generated token
                    finished += self._commit_token(
                        req, self.sampler(logits_np[bi]))
                continue
            finished += self._commit_token(req, self.sampler(logits_np[bi]))
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
        logits_np = _logits_to_host(self.model.prefill_chunk(
            feeds, rows, starts, pad_to=pad_to))
        finished = 0
        for bi, s in enumerate(rows):
            req = self._active[s]
            if req.state == RequestState.PREFILL:
                finished += self._advance_prefill_row(
                    req, feeds[bi], logits_np[bi])
                continue
            finished += self._commit_token(req, self.sampler(logits_np[bi]))

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
            logits_np = _logits_to_host(self.model.prefill_chunk(
                feeds, rows, starts, pad_to=pad_to))
            # mirror the prompt chunks into the draft's own pool
            self.draft.prefill_chunk(feeds, rows, starts, pad_to=pad_to)
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
            props = []
            for _ in range(k):
                cur = _argmax_rows(self.draft.decode_token(cur, dec),
                                   len(dec))
                props.append(cur)
            # feed the k-th proposal too, so that the draft cache never
            # lags the committed prefix (rejections roll back by truncate)
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
            committed += 1
            self.spec_stats["committed_tokens"] += 1
            if req.on_token is not None:
                req.on_token(req, t, False)
            if self._done(req, t):
                done = True
                break
        self.spec_stats["proposed_tokens"] += k
        self.spec_stats["accepted_draft_tokens"] += n_acc
        if done:
            if self.prefix_cache is not None:
                # retire inserts the chain into the radix tree keyed by
                # the COMMITTED tokens: drop the unverified window tail
                # first, so that cached K/V == committed tokens
                for c in self.model.caches:
                    c.truncate(s, base_t + committed)
            self._retire(req)
            return committed, True
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
                    [[c] for c in cur], dec, [base_d[s] + j for s in dec],
                    pad_to=pad_j)
                # the k-th proposal is fed for the pools' symmetry with
                # the window; its logits are never sampled
                if j < k:
                    cur = _argmax_rows(dl, len(dec))
                    props.append(cur)
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
            for i, s in enumerate(dec):
                committed, retired = self._commit_spec_row(
                    s, [props[j][i] for j in range(k)], preds[i],
                    base_t[s], base_d[s])
                dec_tokens += committed
                finished += int(retired)
            for bi, r in enumerate(rows):
                finished += self._advance_prefill_row(
                    self._active[r], feeds[bi], last_np[len(dec) + bi])

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

    def result(self, req_id: str) -> Request:
        return self._finished[req_id]
