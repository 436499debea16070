"""Continuous-batching scheduler over the paged KV cache (counterpart of
the core of the reference's ``inference/serving.py``).

Token-level continuous batching: every step advances each active
sequence, so arrivals and completions interleave freely. Chunked
prefill (default when the model implements ``prefill_chunk``): each
step packs EVERY active decode row plus up to ``prefill_chunk_tokens``
pending prompt tokens into ONE ragged model call, padded up to a bucket
of ``FLAGS_serving_buckets`` (:func:`bucket_packed_tokens`).

Admission control (FIFO): a request is admitted only while the active
batch is below ``max_batch_size`` and the page pool stays under the
watermark after reserving the request's worst-case page need (prompt +
max_new_tokens, across every layer's cache).

The scheduler is host-side bookkeeping only. Not ported yet, and
refused at construction or submit rather than ignored: the prefix
cache, speculative decoding, preemption and host swap, fault injection,
SLO/watchdog telemetry, deadlines, priorities and tenant caps, the
bounded queue.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..framework.flags import flag

__all__ = ["Request", "BatchScheduler", "RequestState",
           "bucket_packed_tokens"]


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
    FINISHED = "finished"


@dataclass
class Request:
    """One generation request. ``on_token(request, token_id,
    is_prompt)`` fires for every token the scheduler commits."""

    req_id: str
    prompt_ids: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    on_token: Optional[Callable] = None
    # not ported yet: submit refuses a nonzero priority or a deadline
    priority: int = 0
    deadline_s: Optional[float] = None
    state: str = RequestState.QUEUED
    generated_ids: List[int] = field(default_factory=list)
    _pos: int = 0  # prompt tokens consumed so far

    @property
    def finished(self) -> bool:
        return self.state == RequestState.FINISHED

    def total_tokens(self) -> int:
        return len(self.prompt_ids) + self.max_new_tokens


def _not_ported(what):
    raise NotImplementedError(
        f"BatchScheduler: {what} is not ported to paddle_tpu_torch yet")


def _logits_to_host(logits) -> np.ndarray:
    if isinstance(logits, torch.Tensor):
        return logits.float().cpu().numpy()
    return np.asarray(logits)


class BatchScheduler:
    """Drives a paged decoder model with continuous batching.

    ``model`` must provide the paged-serving protocol:
      * ``alloc(seq_id)`` / ``free(seq_id)`` — per-sequence cache slots
      * ``decode_token(token_ids, seq_ids) -> logits (B, vocab)``
      * optionally ``prefill_chunk(token_ids, seq_ids, start_positions,
        pad_to=) -> logits (B, vocab)`` for chunked prefill
      * ``caches`` — the per-layer page pools (admission watermark)
    """

    def __init__(self, model, max_batch_size=32, page_watermark=0.95,
                 sampler=None, draft_model=None, draft_k=4,
                 prefix_cache=None, chunked_prefill=None,
                 prefill_chunk_tokens=None, serving_buckets=None,
                 prefix_align=1, slo=None, watchdog=None,
                 max_queue=None, max_inflight_per_tenant=None,
                 preempt=None, swap_bytes=None, fault_injector=None,
                 spec_decode=None):
        for what, val in (("prefix_cache", prefix_cache),
                          ("speculative decoding (draft_model)",
                           draft_model),
                          ("spec_decode", spec_decode),
                          ("preemption (preempt)", preempt),
                          ("host swap (swap_bytes)", swap_bytes),
                          ("fault injection (fault_injector)",
                           fault_injector),
                          ("SLO accounting (slo)", slo),
                          ("the watchdog", watchdog),
                          ("the bounded queue (max_queue)", max_queue),
                          ("tenant caps (max_inflight_per_tenant)",
                           max_inflight_per_tenant)):
            if val:
                _not_ported(what)
        if int(prefix_align) != 1:
            _not_ported("prefix_align")
        self.model = model
        self.max_batch_size = int(max_batch_size)
        self.page_watermark = float(page_watermark)
        self.sampler = sampler or (lambda logits: int(np.argmax(logits)))
        self._queue = collections.deque()
        self._active = {}
        self._finished = {}
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
        self.chunk_stats = {
            "steps": 0, "chunk_calls": 0, "prefill_tokens": 0,
            "decode_tokens": 0, "packed_tokens": 0, "padded_tokens": 0,
        }

    # -- pool accounting ---------------------------------------------------
    def _pool(self):
        caches = list(self.model.caches)
        total = sum(c.num_pages for c in caches)
        free = sum(c.num_free_pages for c in caches)
        return total, free

    def _pages_needed(self, req: Request) -> int:
        return sum(-(-req.total_tokens() // c.page_size)
                   for c in self.model.caches)

    def _growth_pages(self, req: Request, c) -> int:
        """Worst-case free-list draws still ahead of ``req`` on cache
        ``c``: pages to reach the worst-case table size, measured from
        the cache's actual state."""
        n = c.seq_len(req.req_id)
        have = -(-n // c.page_size) if n else 0
        return max(-(-req.total_tokens() // c.page_size) - have, 0)

    def _reserved_pages_outstanding(self) -> int:
        return sum(self._growth_pages(req, c)
                   for req in self._active.values()
                   for c in self.model.caches)

    def page_pool_stats(self):
        total, free = self._pool()
        caches = list(self.model.caches)
        return {
            "total_pages": total,
            "free_pages": free,
            "reserved_pages": self._reserved_pages_outstanding(),
            "utilization": 1.0 - free / max(total, 1),
            "peak_used_pages": sum(getattr(c, "peak_used_pages", 0)
                                   for c in caches),
            "kv_dtype": sorted({getattr(c, "kv_dtype", "unknown")
                                for c in caches}),
            "pool_bytes": sum(getattr(c, "pool_nbytes", 0) for c in caches),
            "used_bytes": sum(getattr(c, "page_nbytes", 0)
                              * (c.num_pages - c.num_free_pages)
                              for c in caches),
        }

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> str:
        if not req.prompt_ids:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if req.deadline_s is not None:
            _not_ported("per-request deadlines (deadline_s)")
        if req.priority:
            _not_ported("request priorities")
        # context-length bound: rejecting at submit beats a mid-batch
        # crash for every co-batched request
        limit = getattr(self.model, "max_length", None)
        if limit is not None and req.total_tokens() > limit:
            raise ValueError(
                f"request {req.req_id!r} needs {req.total_tokens()} "
                f"positions but the model serves at most {limit}")
        # reject requests that could NEVER be admitted instead of letting
        # them block the FIFO queue forever
        need = self._pages_needed(req)
        total, _ = self._pool()
        if need > self.page_watermark * total:
            raise ValueError(
                f"request {req.req_id!r} needs {need} pages worst-case but "
                f"the pool watermark admits at most "
                f"{int(self.page_watermark * total)} of {total}")
        self._queue.append(req)
        return req.req_id

    def _try_admit(self) -> int:
        admitted = 0
        while self._queue and len(self._active) < self.max_batch_size:
            req = self._queue[0]
            need = self._pages_needed(req)
            total, free = self._pool()
            # admit only if the worst-case reservation keeps the pool
            # under the watermark (already-used pages are no longer free,
            # so active reservations count only their remaining growth)
            projected = (total - free) + self._reserved_pages_outstanding() \
                + need
            if projected > self.page_watermark * total:
                break
            self._queue.popleft()
            self.model.alloc(req.req_id)
            req.state = RequestState.PREFILL
            self._active[req.req_id] = req
            admitted += 1
        return admitted

    def _retire(self, req: Request):
        self.model.free(req.req_id)
        req.state = RequestState.FINISHED
        del self._active[req.req_id]
        self._finished[req.req_id] = req

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
        """One scheduler iteration: admit, advance the active set, retire
        completions. Returns event counters (admitted/advanced/finished
        plus the prefill/decode token split and, under chunked prefill,
        chunk_utilization and the adapter's packed-shape count)."""
        return self._step_impl()

    def _step_impl(self) -> dict:
        admitted = self._try_admit()
        if not self._active:
            return {"admitted": admitted, "advanced": 0, "finished": 0,
                    "prefill_tokens": 0, "decode_tokens": 0}
        if self.chunked_prefill:
            return self._step_chunked(admitted)

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

    def _step_chunked(self, admitted) -> dict:
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
            "prefill_tokens": n_pre,
            "decode_tokens": n_dec,
            "chunk_utilization": round(packed / pad_to, 4),
            "compile_count": getattr(self.model, "compile_count", None),
            "attend_programs": getattr(
                self.model, "attend_program_count", None),
        }

    def _done(self, req: Request, last_tok: int) -> bool:
        if req.eos_id is not None and last_tok == req.eos_id:
            return True
        return len(req.generated_ids) >= req.max_new_tokens

    def run_until_complete(self, max_steps=10_000) -> dict:
        """Drain the queue and the active set; returns finished requests
        by id."""
        for _ in range(max_steps):
            if not self._queue and not self._active:
                break
            ev = self.step()
            if ev["advanced"] == 0 and ev["admitted"] == 0 and self._queue:
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

    def result(self, req_id: str) -> Request:
        return self._finished[req_id]
