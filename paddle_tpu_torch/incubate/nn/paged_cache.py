"""Paged KV-cache manager of the port (counterpart of the reference's
``incubate/nn/paged_cache.py``).

The manager is host-side bookkeeping (a page free list, reference
counts and per-sequence page tables); the pages are two device tensors
``(num_pages, page_size, kv_heads, head_dim)``. Unlike the reference,
whose arrays are immutable and rebuilt on every write, the port writes
the pages IN PLACE (``index_put_``): at Llama-3-8B shapes one layer's K
and V pages are 33.5 MB.

Int8 pools (``kv_dtype="int8"``) store int8 codes with per-page,
per-head float32 scale sidecars ``k_scales``/``v_scales``
``(num_pages, kv_heads)`` (``ops/kernels/quant.py``); the attention
kernels dequantize after the load. A write grows each written page's
scale to cover the token, requantizes the page's stored codes by
``round(q * old/new)`` and stores the token against the new scale, in
the reference's per-token order, so the pages and scales are the
reference's bit for bit (:meth:`PagedKVCacheManager._quant_write`).

Not ported yet: ``attach``/copy-on-write and the prefix-cache hooks,
``HostKVSwapSpace`` and swap, ``dense_kv``, the page sanitizer and
telemetry. Without ``attach`` no page is ever shared, so every write
lands on a page its sequence owns alone.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...device import copy_to_device, resolve_device
from ...ops.kernels.paged_attention import (  # noqa: F401 (re-exported)
    paged_attention,
    paged_prefill_attention as _prefill_kernel,
    paged_ragged_attention as _ragged_kernel_fn,
    paged_ragged_fused_step as _fused_step_fn,
)
from ...ops.kernels.quant import kv_head_scale, quantize_kv

_KV_DTYPES = {"int8": torch.int8,
              "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
              "fp32": torch.float32, "float32": torch.float32,
              "fp16": torch.float16, "float16": torch.float16}


class RaggedStepInputs(NamedTuple):
    """Device inputs of one packed step (:meth:`PagedKVCacheManager.
    ragged_step_inputs`): ``slots`` (2, n) int64, the page and slot of
    each of the step's n new tokens in packed order; ``page_table``
    (rows, max_pages), ``seq_lens`` and ``q_lens`` (rows,) int32, the
    attention kernel's operands; for an int8 pool, ``passes``, the
    write's pass plan (:meth:`PagedKVCacheManager._pass_plan`)."""
    slots: torch.Tensor
    page_table: torch.Tensor
    seq_lens: torch.Tensor
    q_lens: torch.Tensor
    passes: tuple = None


class PagedKVCacheManager:
    """Fixed pool of KV pages shared by many sequences.

    * ``alloc(seq_id)`` registers a sequence;
    * the append methods book the next slots (:meth:`book_ragged`),
      growing each sequence's page list from the free list, and write
      K/V in place;
    * ``page_table(seq_ids, max_pages)`` / ``seq_lens`` build the
      device-side inputs of the paged attention kernel, and
      :meth:`ragged_step_inputs` all of a packed step's at once;
    * ``free(seq_id)`` drops the sequence's references; pages return to
      the pool when their refcount hits zero.

    ``kv_dtype="int8"`` (or ``dtype=torch.int8``) makes an int8 pool
    with scale sidecars ``k_scales``/``v_scales`` (``quantized``).
    ``device`` defaults to the card and raises without CUDA unless
    ``device="cpu"`` is passed.
    """

    def __init__(self, num_pages, page_size, kv_heads, head_dim,
                 dtype=torch.bfloat16, kv_dtype=None, device=None):
        if kv_dtype is not None:
            if kv_dtype not in _KV_DTYPES:
                raise ValueError(
                    f"kv_dtype must be one of {sorted(_KV_DTYPES)}, got "
                    f"{kv_dtype!r}")
            dtype = _KV_DTYPES[kv_dtype]
        if not (dtype.is_floating_point or dtype == torch.int8):
            raise ValueError(f"KV pages must be float or int8, got {dtype}")
        self.device = resolve_device(device)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.kv_dtype = str(dtype).replace("torch.", "")
        self.quantized = dtype == torch.int8
        shape = (self.num_pages, self.page_size, int(kv_heads),
                 int(head_dim))
        if self.quantized:
            # K and V (and their scales) as the two halves of one tensor,
            # so that each write pass updates both with one op each
            self._kv = torch.zeros((2,) + shape, dtype=dtype,
                                   device=self.device)
            self.k_pages, self.v_pages = self._kv[0], self._kv[1]
            self._scales = torch.zeros((2, self.num_pages, int(kv_heads)),
                                       dtype=torch.float32,
                                       device=self.device)
            self.k_scales, self.v_scales = self._scales[0], self._scales[1]
        else:
            self.k_pages = torch.zeros(shape, dtype=dtype,
                                       device=self.device)
            self.v_pages = torch.zeros_like(self.k_pages)
        self._free = list(range(self.num_pages))[::-1]
        self._tables = {}   # seq_id -> [page ids]
        self._lens = {}     # seq_id -> token count
        self._refcnt = [0] * self.num_pages
        # high watermark: most pages ever simultaneously in use
        self.peak_used_pages = 0

    # -- bookkeeping -------------------------------------------------------
    def alloc(self, seq_id):
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        self._tables[seq_id] = []
        self._lens[seq_id] = 0

    def free(self, seq_id):
        tbl = self._tables.get(seq_id)
        if tbl is None:
            raise KeyError(
                f"free({seq_id!r}): unknown or already-freed sequence "
                "(double-free would corrupt the page free list)")
        del self._tables[seq_id]
        for p in reversed(tbl):
            self._release_page(p)
        self._lens.pop(seq_id)

    def _release_page(self, p):
        c = self._refcnt[p] - 1
        if c < 0:
            raise AssertionError(f"page {p} refcount underflow")
        self._refcnt[p] = c
        if c == 0:
            self._free.append(p)

    def _alloc_page(self):
        if not self._free:
            raise RuntimeError("KV page pool exhausted")
        p = self._free.pop()
        self._refcnt[p] = 1
        used = self.num_pages - len(self._free)
        if used > self.peak_used_pages:
            self.peak_used_pages = used
        if self.quantized:
            # a drawn page restarts its calibration: the first write
            # must not inherit a dead page's scales
            self._scales[:, p] = 0.0
        return p

    def seq_len(self, seq_id):
        return self._lens[seq_id]

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    # -- appends -----------------------------------------------------------
    def ragged_pages_needed(self, seq_ids, counts) -> int:
        """Free-list draws a ragged append of ``counts[i]`` tokens per
        sequence would make: new pages opened past each tail."""
        need = 0
        for s, c in zip(seq_ids, counts):
            if not c:
                continue
            n = self._lens[s]
            have = -(-n // self.page_size) if n else 0
            need += -(-(n + c) // self.page_size) - have
        return need

    def book_ragged(self, seq_ids, counts):
        """Bookkeeping half of a ragged append of ``counts[i]`` tokens to
        sequence ``seq_ids[i]``: an atomic capacity precheck (a short
        pool changes nothing), then the page draws, in the order the
        reference's token-by-token ``_next_slot`` makes them, and the
        length advance. The device write belongs to the caller. Returns
        the page ids drawn, in order."""
        counts = [int(c) for c in counts]
        need = self.ragged_pages_needed(seq_ids, counts)
        if need > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: ragged append needs {need} "
                f"new pages, {len(self._free)} free")
        drawn = []
        for s, c in zip(seq_ids, counts):
            tbl = self._tables[s]
            n = self._lens[s] + c
            while len(tbl) * self.page_size < n:
                tbl.append(self._alloc_page())
                drawn.append(tbl[-1])
            self._lens[s] = n
        return drawn

    def _slot_plan(self, seq_ids, counts):
        """(2, sum(counts)) host int64 array: page and slot of each
        listed sequence's last ``counts[i]`` tokens, sequence-major (the
        order of the packed token axis)."""
        parts = [np.zeros((2, 0), np.int64)]
        for s, c in zip(seq_ids, counts):
            n = self._lens[s]
            pos = np.arange(n - int(c), n)
            pages = np.asarray(self._tables[s], np.int64)
            parts.append(np.stack([pages[pos // self.page_size],
                                   pos % self.page_size]))
        return np.concatenate(parts, axis=1)

    @staticmethod
    def _pass_plan(slot_plan):
        """The int8 write's pass plan, host int64 (3, n): the token row,
        page and slot of each write, ordered by pass, and the passes'
        (start, end) column bounds. Pass k holds the k-th write of this
        call to every page it touches. Without ``attach`` a page has one
        writer, whose tokens are consecutive in the packed order, and
        pages do not interact, so these passes give each page the writes
        of the reference's waves (the j-th token of every chunk) in the
        same order: at most ``page_size`` passes instead of
        ``max(counts)``."""
        n = slot_plan.shape[1]
        pages = slot_plan[0]
        idx = np.arange(n)
        opens = np.ones(n, bool)
        opens[1:] = pages[1:] != pages[:-1]
        k = idx - np.maximum.accumulate(np.where(opens, idx, 0))
        order = np.argsort(k, kind="stable")
        ends = np.cumsum(np.bincount(k)) if n else np.zeros(0, np.int64)
        bounds = tuple(zip([0, *ends[:-1].tolist()], ends.tolist()))
        return np.stack([order, slot_plan[0][order], slot_plan[1][order]]), \
            bounds

    def _write_inputs(self, seq_ids, counts):
        """Device write plan of booked tokens, in one copy: the (2, n)
        slots and, for an int8 pool, the pass plan."""
        plan = self._slot_plan(seq_ids, counts)
        if not self.quantized:
            slots, = copy_to_device([plan], self.device, torch.int64)
            return slots, None
        passes, bounds = self._pass_plan(plan)
        slots, passes = copy_to_device([plan, passes], self.device,
                                       torch.int64)
        return slots, (passes, bounds)

    def _write(self, slots, k_toks, v_toks):
        """In-place page write; ``slots`` (2, n) int64 (page, slot) on
        the pool's device."""
        self.k_pages.index_put_((slots[0], slots[1]),
                                k_toks.to(self.k_pages.dtype))
        self.v_pages.index_put_((slots[0], slots[1]),
                                v_toks.to(self.v_pages.dtype))

    def _quant_write(self, passes, k_toks, v_toks):
        """Quantized write of (n, KVH, D) tokens by the pass plan
        :meth:`_pass_plan` gives (device (3, n) int64 and host bounds).

        Each pass updates pages it touches once, K and V together: each
        page's per-head scale grows to cover its token, ``max(old,
        absmax / 127)``, the page's stored codes are requantized by
        ``round(q * old/new)``, and the token is quantized against the
        new scale, the reference's calibration (``_quant_write`` there).
        The reference requantizes only when some scale of the wave grew,
        a host sync per wave; here the requantize always runs, with a
        ratio of exactly 1.0 where a scale did not grow, and
        ``round(q * 1.0)`` is ``q``, so no host sync is needed and the
        bits are the same."""
        plan, bounds = passes
        toks = torch.stack([k_toks, v_toks]).float()[:, plan[0]]
        for a, b in bounds:
            pg, of = plan[1, a:b], plan[2, a:b]
            x = toks[:, a:b]                             # (2, m, KVH, D)
            old = self._scales[:, pg]                    # (2, m, KVH)
            new = torch.maximum(old, kv_head_scale(x, keep_leading=2))
            ratio = torch.where(new > old, old / new.clamp_min(1e-20), 1.0)
            body = torch.round(self._kv[:, pg].float()
                               * ratio[:, :, None, :, None]).to(torch.int8)
            body[:, torch.arange(b - a, device=self.device), of] = \
                quantize_kv(x, new)
            self._kv[:, pg] = body
            self._scales[:, pg] = new

    def append_batch(self, seq_ids, k_toks, v_toks):
        """Write one token's K/V for EVERY listed sequence in one scatter
        per pages tensor. k_toks/v_toks: (B, KVH, D)."""
        self.append_ragged(seq_ids, [1] * len(seq_ids), k_toks, v_toks)

    def append_ragged(self, seq_ids, counts, k_toks, v_toks, step=None):
        """Write ``counts[i]`` consecutive tokens' K/V for every listed
        sequence in one scatter per pages tensor. k_toks/v_toks:
        (sum(counts), KVH, D), rows ordered sequence-major.

        ``step``: the :class:`RaggedStepInputs` of a caller that booked
        the slots itself (:meth:`book_ragged`); without it the pool books
        them and plans the write here."""
        counts = [int(c) for c in counts]
        if sum(counts) != k_toks.shape[0]:
            raise ValueError(
                f"append_ragged: counts sum to {sum(counts)} but "
                f"{k_toks.shape[0]} token rows were passed")
        if step is None:
            self.book_ragged(seq_ids, counts)
            slots, passes = self._write_inputs(seq_ids, counts)
        else:
            slots, passes = step.slots, step.passes
            if slots.shape[1] != k_toks.shape[0]:
                raise ValueError(
                    f"append_ragged: the step books {slots.shape[1]} "
                    f"slots for {k_toks.shape[0]} token rows")
        if not slots.shape[1]:
            return
        if self.quantized:
            self._quant_write(passes, k_toks, v_toks)
        else:
            self._write(slots, k_toks, v_toks)

    # -- kernel inputs -----------------------------------------------------
    def _padded_kernel_inputs(self, seq_ids, rows_pad, max_pages):
        """Host int32 page table (rows_pad, max_pages) and seq_lens
        (rows_pad,). Padding rows carry page id 0 and seq_len 0, which
        the kernel treats as inert (no key is read, output exact
        zeros)."""
        rows_pad = max(int(rows_pad or len(seq_ids)), len(seq_ids))
        mp = max((len(self._tables[s]) for s in seq_ids), default=1)
        mp = max(int(max_pages or mp), mp, 1)
        tbl = np.zeros((rows_pad, mp), np.int32)
        lens = np.zeros((rows_pad,), np.int32)
        for i, s in enumerate(seq_ids):
            pages = self._tables[s]
            tbl[i, :len(pages)] = pages
            lens[i] = self._lens[s]
        return tbl, lens

    def _attend_inputs(self, seq_ids, q_lens, rows_pad, max_pages):
        """Page table, seq_lens and q_lens of the ragged kernel, int32 on
        the pool's device, in one copy."""
        tbl, lens = self._padded_kernel_inputs(seq_ids, rows_pad, max_pages)
        ql = np.zeros(lens.shape, np.int32)
        ql[:len(q_lens)] = [int(c) for c in q_lens]
        return copy_to_device([tbl, lens, ql], self.device, torch.int32)

    def ragged_step_inputs(self, seq_ids, counts, rows_pad=None,
                           max_pages=None, groups=None):
        """The device inputs of one packed step over the listed
        sequences, whose ``counts[i]`` new tokens are booked already
        (:meth:`book_ragged`): their write plan and the attention
        kernel's padded page table, seq_lens and q_lens. Every layer's
        pool of an adapter goes through the same bookkeeping calls, so
        one pool's inputs serve all the layers of a step.

        ``groups``: ``[(row indices into seq_ids, rows_pad), ...]`` gives
        a list, one :class:`RaggedStepInputs` per group with the kernel
        inputs of the group's rows alone (the two-kernel routing of
        ``FLAGS_ragged_attention=off``), all sharing the write plan of
        every row and built in the same two copies."""
        slots, passes = self._write_inputs(seq_ids, counts)
        if groups is None:
            return RaggedStepInputs(slots, *self._attend_inputs(
                seq_ids, counts, rows_pad, max_pages), passes)
        host = []
        for rows, pad in groups:
            tbl, lens = self._padded_kernel_inputs(
                [seq_ids[i] for i in rows], pad, max_pages)
            ql = np.zeros(lens.shape, np.int32)
            ql[:len(rows)] = [int(counts[i]) for i in rows]
            host += [tbl, lens, ql]
        dev = copy_to_device(host, self.device, torch.int32)
        return [RaggedStepInputs(slots, *dev[3 * g:3 * g + 3], passes)
                for g in range(len(groups))]

    def page_table(self, seq_ids, max_pages=None):
        tbl, _ = self._padded_kernel_inputs(seq_ids, len(seq_ids), max_pages)
        return torch.from_numpy(tbl).to(self.device)

    def seq_lens(self, seq_ids):
        return torch.tensor([self._lens[s] for s in seq_ids],
                            dtype=torch.int32, device=self.device)

    @property
    def _scale_args(self):
        """The attention kernels' ``k_scales``/``v_scales`` keywords."""
        if self.quantized:
            return {"k_scales": self.k_scales, "v_scales": self.v_scales}
        return {}

    def attend(self, q, seq_ids, sm_scale=None, window=0, step=None):
        """q: (B, H, D), one decode token per listed sequence.
        ``window`` > 0: sliding-window attention over the last
        ``window`` cached tokens. Through :func:`paged_attention`: the
        ragged kernel at T=1, or under ``FLAGS_ragged_attention=off`` the
        decode kernel; ``step`` carries the kernel's inputs when the
        caller built them."""
        return self.attend_padded(q, seq_ids, sm_scale=sm_scale,
                                  window=window, step=step)

    def attend_padded(self, q, seq_ids, rows_pad=None, max_pages=None,
                      sm_scale=None, window=0, step=None):
        """Decode attend over a row/column-padded batch: ``q`` is
        (rows_pad, H, D) whose first ``len(seq_ids)`` rows are real
        decode tokens; padding rows return exact zeros. ``max_pages``
        pads the page-table width. ``step`` carries the page table and
        seq_lens when the caller built them (:meth:`ragged_step_inputs`).
        """
        if step is None:
            tbl, lens = copy_to_device(
                self._padded_kernel_inputs(seq_ids, rows_pad, max_pages),
                self.device, torch.int32)
        else:
            tbl, lens = step.page_table, step.seq_lens
        return paged_attention(q, self.k_pages, self.v_pages, tbl, lens,
                               sm_scale=sm_scale, window=window,
                               **self._scale_args)

    def attend_prefill(self, q, seq_ids, q_lens, rows_pad=None,
                       max_pages=None, sm_scale=None, window=0, step=None):
        """Chunked-prefill attend over a padded ragged batch: ``q`` is
        (rows_pad, T, H, D); row i's last ``q_lens[i]`` rows are the
        newest tokens of seq_ids[i] (K/V already appended); earlier rows
        and batch-padding rows return exact zeros. The ragged kernel,
        as the reference's alias of :meth:`attend_ragged`."""
        if step is None:
            tbl, lens, ql = self._attend_inputs(seq_ids, q_lens, rows_pad,
                                                max_pages)
        else:
            tbl, lens, ql = step.page_table, step.seq_lens, step.q_lens
        return _prefill_kernel(q, self.k_pages, self.v_pages, tbl, lens,
                               sm_scale=sm_scale, window=window, q_lens=ql,
                               **self._scale_args)

    def attend_ragged(self, q, seq_ids, q_lens, rows_pad=None,
                      max_pages=None, sm_scale=None, window=0, step=None):
        """The unified packed-step attend: ``q`` is (rows_pad, T, H, D)
        with row i's last ``q_lens[i]`` rows the newest tokens of
        seq_ids[i] (K/V already appended). Earlier rows and batch-padding
        rows return exact zeros. One kernel call for the mixed batch;
        ``step`` carries the kernel's inputs when the caller built them
        (:meth:`ragged_step_inputs`)."""
        if step is None:
            tbl, lens, ql = self._attend_inputs(seq_ids, q_lens, rows_pad,
                                                max_pages)
        else:
            tbl, lens, ql = step.page_table, step.seq_lens, step.q_lens
        return _ragged_kernel_fn(q, self.k_pages, self.v_pages, tbl, lens,
                                 q_lens=ql, sm_scale=sm_scale, window=window,
                                 **self._scale_args)

    def fused_ragged_step(self, x, weights, rope, positions, seq_ids,
                          counts, gather_map, scatter_plan,
                          rows_pad=None, max_pages=None, sm_scale=None,
                          window=0, step=None):
        """The fused packed attention layer step: qkv projection + RoPE
        + THIS chunk's K/V page writes, the ragged kernel, then o_proj
        (``ops/kernels/paged_attention.paged_ragged_fused_step``).
        Without ``step`` the pool books the slots here (capacity precheck
        first, so a failure mutates nothing) and builds the kernel's
        inputs; with it, the caller did both (:meth:`book_ragged`,
        :meth:`ragged_step_inputs`). The step writes the pages in place.

        ``x``: (n_pad, E) normed packed hidden states; ``weights`` =
        (wq, wk, wv, wo, biases) [in, out] tensors (biases None or
        (bq, bk, bv)); ``rope`` = (cos, sin); ``positions`` (n_pad,);
        ``gather_map`` (rows_pad, T) flat packed indices right-aligning
        each row; ``scatter_plan`` = (rows, cols, flat) of the real-token
        length, or the reference's plans padded to n_pad (only their
        real leading entries are read). Returns the o_proj output
        (n_pad, E). Float pools only: an int8 pool calibrates each page
        per token, which the fused step does not express (use
        :meth:`append_ragged` + :meth:`attend_ragged`)."""
        if self.quantized:
            raise ValueError(
                "fused_ragged_step: int8 KV pools calibrate per token; "
                "use append_ragged + attend_ragged")
        counts = [int(c) for c in counts]
        n_pad = x.shape[0]
        n_real = sum(counts)
        mr, mc, mflat = scatter_plan
        if n_real > n_pad:
            raise ValueError(
                f"fused_ragged_step: counts sum to {n_real} but the "
                f"packed operand carries {n_pad} rows")
        plan_lens = {len(a) for a in (mr, mc, mflat)}
        if len(plan_lens) != 1 or next(iter(plan_lens)) not in (
                n_real, n_pad):
            raise ValueError(
                f"fused_ragged_step: scatter plan lengths "
                f"{[len(a) for a in (mr, mc, mflat)]} match neither the "
                f"{n_real} real packed tokens nor the padded {n_pad}")
        if step is None:
            self.book_ragged(seq_ids, counts)
            step = self.ragged_step_inputs(seq_ids, counts, rows_pad,
                                           max_pages)
        elif step.slots.shape[1] != n_real:
            raise ValueError(
                f"fused_ragged_step: the step books {step.slots.shape[1]} "
                f"slots for {n_real} packed tokens")
        wq, wk, wv, wo, biases = weights
        cos, sin = rope
        y, _, _ = _fused_step_fn(
            x, wq, wk, wv, wo, biases, cos, sin, positions, step.slots[0],
            step.slots[1], gather_map, mr, mc, mflat, self.k_pages,
            self.v_pages, step.page_table, step.seq_lens, step.q_lens,
            sm_scale=sm_scale, window=window, n_real=n_real)
        return y

    @staticmethod
    def page_bytes(page_size, kv_heads, head_dim, dtype=torch.bfloat16,
                   kv_dtype=None) -> int:
        """Device bytes one page costs (K + V payload plus, when
        quantized, its two float32 scale rows) — pure arithmetic, usable
        for pool sizing before allocating."""
        if kv_dtype is not None:
            dtype = _KV_DTYPES[kv_dtype]
        itemsize = torch.empty((), dtype=dtype).element_size()
        per = page_size * kv_heads * head_dim * itemsize * 2
        if dtype == torch.int8:
            per += kv_heads * 4 * 2
        return per

    @property
    def page_nbytes(self) -> int:
        return self.page_bytes(self.page_size, self.k_pages.shape[2],
                               self.k_pages.shape[3],
                               dtype=self.k_pages.dtype)

    @property
    def pool_nbytes(self) -> int:
        return self.page_nbytes * self.num_pages

