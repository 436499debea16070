"""Paged KV-cache manager of the port (counterpart of the reference's
``incubate/nn/paged_cache.py``).

The manager is host-side bookkeeping (a page free list, reference
counts and per-sequence page tables); the pages are two device tensors
``(num_pages, page_size, kv_heads, head_dim)``. Unlike the reference,
whose arrays are immutable and rebuilt on every write, the port writes
the pages IN PLACE (``index_put_``): at Llama-3-8B shapes one layer's K
and V pages are 33.5 MB.

Pages are reference-counted so they can be shared across owners, the
enabler of the prefix cache (``inference/prefix_cache.py``):

* ``attach(seq_id, pages, length)`` registers a sequence on an existing
  (shared) page chain; each chain page gains a reference;
* a write into a shared page (refcount > 1) forks it first
  (copy-on-write): the booking (:meth:`PagedKVCacheManager.book_ragged`)
  draws a private page and copies the shared one into it on the device
  before any layer writes, so the other owners keep the original bytes;
* ``free``/``truncate`` only drop references; a page returns to the pool
  when its last reference dies;
* ``incref``/``decref`` let a non-sequence owner (the radix prefix tree)
  hold pages alive after the sequence that wrote them retires.

Int8 pools (``kv_dtype="int8"``) store int8 codes with per-page,
per-head float32 scale sidecars ``k_scales``/``v_scales``
``(num_pages, kv_heads)`` (``ops/kernels/quant.py``); the attention
kernels dequantize after the load. A write grows each written page's
scale to cover the token, requantizes the page's stored codes by
``round(q * old/new)`` and stores the token against the new scale, in
the reference's per-token order, so the pages and scales are the
reference's bit for bit (:meth:`PagedKVCacheManager._quant_write`). The
scale rows ride the page ids: a fork copies its source's scale row.

Host swap (:class:`HostKVSwapSpace`): preemption pages a victim's KV out
to host tensors and back. ``swap_out`` copies the sequence's PRIVATE
pages (refcount 1: payload and, when quantized, the scale rows) to the
host bit for bit and releases them; SHARED pages stay on the device
under an external "swap hold" reference. ``swap_in`` draws fresh pages,
restores the private bytes and drops the holds, so greedy decode
resumes where it stopped.

Not ported yet: the page-chain wire format (``export_seq`` /
``import_seq``), ``dense_kv``, the page sanitizer and telemetry.
"""
from __future__ import annotations

import collections
import itertools
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

__all__ = ["PagedKVCacheManager", "paged_attention", "HostKVSwapSpace",
           "SwapSpaceFull"]

_pool_uids = itertools.count()

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


class SwapSpaceFull(RuntimeError):
    """The host swap space cannot hold another record under its byte
    budget (FLAGS_serving_swap_bytes): the caller should pick a different
    victim or fall back to blocking admission."""


class _SwapRecord:
    """One swapped-out sequence for ONE layer pool: the page chain as it
    stood (``pages``/``kept``/``length``) and host copies of the private
    pages' payload (+ int8 scale rows)."""

    __slots__ = ("pages", "kept", "length", "k_host", "v_host",
                 "k_scales_host", "v_scales_host", "nbytes")

    def __init__(self, pages, kept, length, k_host, v_host,
                 k_scales_host, v_scales_host, nbytes):
        self.pages = pages
        self.kept = kept
        self.length = length
        self.k_host = k_host
        self.v_host = v_host
        self.k_scales_host = k_scales_host
        self.v_scales_host = v_scales_host
        self.nbytes = nbytes


class HostKVSwapSpace:
    """Byte-budgeted host tier for swapped-out KV page chains.

    One space is shared by every layer pool of a model (and budgets them
    jointly); records are keyed by (pool uid, seq id). The store
    (``_swap_store``/``_swap_used``) is written only through the pool's
    ``swap_out`` / ``swap_in`` / ``swap_discard``; serving code reads the
    public byte and record accessors."""

    def __init__(self, capacity_bytes):
        self.capacity_bytes = int(capacity_bytes)
        self._swap_store = {}
        self._swap_used = 0
        # lifetime counters
        self.swapped_out_records = 0
        self.swapped_in_records = 0
        self.peak_used_bytes = 0

    @property
    def used_bytes(self) -> int:
        return self._swap_used

    @property
    def free_bytes(self) -> int:
        return max(self.capacity_bytes - self._swap_used, 0)

    @property
    def num_records(self) -> int:
        return len(self._swap_store)

    def would_fit(self, nbytes: int) -> bool:
        return self._swap_used + int(nbytes) <= self.capacity_bytes

    def holds(self, seq_id) -> bool:
        """True if ANY pool holds a swap record for ``seq_id``."""
        return any(k[1] == seq_id for k in self._swap_store)

    def summary(self) -> dict:
        return {
            "capacity_bytes": self.capacity_bytes,
            "used_bytes": self._swap_used,
            "peak_used_bytes": self.peak_used_bytes,
            "records": len(self._swap_store),
            "swapped_out_records": self.swapped_out_records,
            "swapped_in_records": self.swapped_in_records,
        }

    # -- pool-only entry points --------------------------------------------
    def _swap_put(self, key, rec):
        if key in self._swap_store:
            raise ValueError(
                f"swap space already holds a record for {key!r}")
        if self._swap_used + rec.nbytes > self.capacity_bytes:
            raise SwapSpaceFull(
                f"swap space full: record needs {rec.nbytes} bytes, "
                f"{self.free_bytes} of {self.capacity_bytes} free")
        self._swap_store[key] = rec
        self._swap_used += rec.nbytes
        self.swapped_out_records += 1
        if self._swap_used > self.peak_used_bytes:
            self.peak_used_bytes = self._swap_used

    def _swap_get(self, key):
        rec = self._swap_store.get(key)
        if rec is None:
            raise KeyError(f"no swap record for {key!r}")
        return rec

    def _swap_pop(self, key):
        """Remove and return a record (a swap-in restore or an abort's
        discard; the caller counts which)."""
        rec = self._swap_get(key)
        del self._swap_store[key]
        self._swap_used -= rec.nbytes
        return rec


class PagedKVCacheManager:
    """Fixed pool of KV pages shared by many sequences.

    * ``alloc(seq_id)`` registers a sequence;
    * ``attach(seq_id, pages, length)`` registers a sequence on a SHARED
      page chain (prefix-cache hit); its first write past ``length``
      into a shared tail page forks that page (copy-on-write);
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
        # stable identity for swap-space keys (the layer pools of one
        # model share ONE HostKVSwapSpace; records key on (uid, seq))
        self._uid = next(_pool_uids)
        self._refcnt = [0] * self.num_pages
        # references held by non-sequence owners (the prefix tree and
        # swap holds), tracked apart so the invariants are checkable
        self._ext_refs = collections.Counter()
        self.cow_forks = 0  # lifetime count of copy-on-write forks
        # high watermark: most pages ever simultaneously in use
        self.peak_used_pages = 0

    # -- bookkeeping -------------------------------------------------------
    def alloc(self, seq_id):
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        self._tables[seq_id] = []
        self._lens[seq_id] = 0

    def attach(self, seq_id, pages, length):
        """Register ``seq_id`` on an existing page chain covering its
        first ``length`` tokens (a prefix-cache hit). Every chain page
        gains a reference; the content is shared until this sequence
        writes into the (partial) last page, which forks it."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        need = -(-int(length) // self.page_size) if length else 0
        if len(pages) != need:
            raise ValueError(
                f"attach({seq_id!r}): {length} tokens span {need} "
                f"pages, got a chain of {len(pages)}")
        for p in pages:
            if self._refcnt[p] == 0:
                raise ValueError(
                    f"attach({seq_id!r}): page {p} is on the free "
                    "list (dangling chain)")
        for p in pages:
            self._refcnt[p] += 1
        self._tables[seq_id] = list(pages)
        self._lens[seq_id] = int(length)

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

    # -- reference counting ------------------------------------------------
    def incref(self, pages):
        """Add an external (non-sequence) reference to each page: the
        prefix tree keeps a retired sequence's prefix alive past
        ``free``."""
        pages = list(pages)
        for p in pages:
            if self._refcnt[p] == 0:
                raise ValueError(
                    f"incref: page {p} is free (cannot resurrect)")
            self._refcnt[p] += 1
            self._ext_refs[p] += 1

    def decref(self, pages):
        """Drop external references; returns how many pages that
        released back to the pool."""
        freed = 0
        for p in pages:
            if self._ext_refs[p] <= 0:
                raise ValueError(
                    f"decref: page {p} holds no external reference")
            self._ext_refs[p] -= 1
            if self._ext_refs[p] == 0:
                del self._ext_refs[p]
            freed += self._release_page(p)
        return freed

    def _release_page(self, p):
        c = self._refcnt[p] - 1
        if c < 0:
            raise AssertionError(f"page {p} refcount underflow")
        self._refcnt[p] = c
        if c == 0:
            self._free.append(p)
            return 1
        return 0

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

    def _fork_page(self, src):
        """Copy-on-write: give the writer a private copy of ``src``
        (which stays intact for its other owners)."""
        dst = self._alloc_page()
        self._copy_page(dst, src)
        self._refcnt[src] -= 1  # src was shared: cannot hit zero here
        self.cow_forks += 1
        return dst

    def _copy_page(self, dst, src):
        """In-place device copy of page ``src`` into ``dst``, issued on
        the pool's stream at booking, so it runs before any layer of the
        step writes either page. An int8 pool copies both halves of its
        codes and the scale rows (over the zeros ``_alloc_page`` left);
        from here the two pages recalibrate independently."""
        if self.quantized:
            self._kv[:, dst] = self._kv[:, src]
            self._scales[:, dst] = self._scales[:, src]
        else:
            self.k_pages[dst] = self.k_pages[src]
            self.v_pages[dst] = self.v_pages[src]

    def _needs_fork(self, page) -> bool:
        """A mid-page write must fork when the page is shared."""
        return self._refcnt[page] > 1

    def seq_len(self, seq_id):
        return self._lens[seq_id]

    def seq_pages(self, seq_id):
        """The sequence's physical page chain (copy)."""
        return list(self._tables[seq_id])

    def seq_page_count(self, seq_id) -> int:
        """Pages the sequence holds, without copying the chain."""
        return len(self._tables[seq_id])

    def pending_cow(self, seq_id) -> bool:
        """True if the sequence's next append must fork a shared page
        (admission accounting: that fork draws one page from the
        pool)."""
        tbl = self._tables[seq_id]
        return (bool(tbl) and self._lens[seq_id] % self.page_size != 0
                and self._needs_fork(tbl[-1]))

    def truncate(self, seq_id, n):
        """Roll a sequence back to ``n`` tokens: K/V beyond ``n`` is
        never attended (the kernels mask by seq_len), and pages past
        ceil(n / page_size) drop this sequence's reference."""
        cur = self._lens[seq_id]
        if n > cur:
            raise ValueError(
                f"truncate({seq_id!r}, {n}): sequence has only {cur}")
        keep = -(-n // self.page_size) if n else 0
        tbl = self._tables[seq_id]
        while len(tbl) > keep:
            self._release_page(tbl.pop())
        self._lens[seq_id] = n

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    @property
    def num_shared_pages(self) -> int:
        """Pages currently owned by more than one reference."""
        return sum(1 for c in self._refcnt if c > 1)

    def assert_ref_invariants(self):
        """Crash loudly if the refcount state is inconsistent: each
        page's refcount equals its occurrences across sequence tables
        plus its external references, and the free list is exactly the
        refcount-zero set (no duplicates)."""
        expect = collections.Counter()
        for tbl in self._tables.values():
            expect.update(tbl)
        expect.update(self._ext_refs)
        for p in range(self.num_pages):
            if self._refcnt[p] != expect.get(p, 0):
                raise AssertionError(
                    f"page {p}: refcount {self._refcnt[p]} != "
                    f"{expect.get(p, 0)} tracked references")
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        zero = {p for p in range(self.num_pages) if self._refcnt[p] == 0}
        if free_set != zero:
            raise AssertionError(
                f"free list {sorted(free_set)} != refcount-zero set "
                f"{sorted(zero)}")
        return True

    # -- host swap (preemption; HostKVSwapSpace) -----------------------------
    def swap_out_pages(self, seq_id) -> int:
        """Device pages a ``swap_out`` of this sequence would FREE (its
        PRIVATE pages only: shared pages stay on the device under a
        hold). Read-only."""
        tbl = self._tables.get(seq_id)
        if tbl is None:
            raise KeyError(f"swap_out_pages({seq_id!r}): unknown "
                           "sequence")
        return sum(1 for p in tbl if self._refcnt[p] == 1)

    def swap_out_nbytes(self, seq_id) -> int:
        """Host bytes a ``swap_out`` of this sequence would store (its
        PRIVATE pages only). Read-only."""
        return self.swap_out_pages(seq_id) * self.page_nbytes

    def _gather_host(self, pages):
        """Host copies (synchronous) of the listed pages' K and V and,
        for an int8 pool, their scale rows: ``(k, v, k_scales,
        v_scales)``, the scales None for a float pool."""
        pg = torch.tensor(pages, dtype=torch.int64, device=self.device)
        if self.quantized:
            kv = self._kv[:, pg].cpu()
            sc = self._scales[:, pg].cpu()
            return kv[0], kv[1], sc[0], sc[1]
        return self.k_pages[pg].cpu(), self.v_pages[pg].cpu(), None, None

    def swap_out(self, seq_id, space):
        """Page the sequence out to the host tier: private pages
        (refcount 1) are copied to host tensors bit for bit (payload and
        int8 scale rows) and released to the pool; shared pages (prefix
        chains, still-shared COW tails) stay on the device under an
        external "swap hold" reference, so they can be neither freed nor
        recycled while the sequence is out. Atomic: the host copy and the
        swap-space reservation both happen before any bookkeeping
        changes, so a full space (:class:`SwapSpaceFull`) leaves the
        pool untouched. The host copy is synchronous, so a released page
        is never rewritten while its bytes are still in flight. Returns
        ``(pages_freed, nbytes_swapped)``."""
        tbl = self._tables.get(seq_id)
        if tbl is None:
            raise KeyError(f"swap_out({seq_id!r}): unknown sequence")
        kept = [self._refcnt[p] > 1 for p in tbl]
        priv = [p for p, k in zip(tbl, kept) if not k]
        shared = [p for p, k in zip(tbl, kept) if k]
        host = self._gather_host(priv) if priv else (None,) * 4
        rec = _SwapRecord(list(tbl), kept, self._lens[seq_id], *host,
                          nbytes=len(priv) * self.page_nbytes)
        space._swap_put((self._uid, seq_id), rec)
        # the swap hold: each shared page gains an external reference
        # BEFORE the sequence's own references drop, so its refcount
        # never transits zero
        for p in shared:
            self._refcnt[p] += 1
            self._ext_refs[p] += 1
        del self._tables[seq_id]
        self._lens.pop(seq_id)
        freed = 0
        for p in reversed(tbl):
            freed += self._release_page(p)
        return freed, rec.nbytes

    def swap_in_pages_needed(self, seq_id, space,
                             worst_tokens=None) -> int:
        """Free-list draws a ``swap_in`` (plus, with ``worst_tokens``,
        growing to that worst-case length afterwards) would make: one per
        private page to restore, the growth pages past the restored
        length, and the pending COW fork when the restored tail page is
        shared and mid-page."""
        rec = space._swap_get((self._uid, seq_id))
        need = sum(1 for k in rec.kept if not k)
        have = -(-rec.length // self.page_size) if rec.length else 0
        if worst_tokens is not None:
            need += max(-(-int(worst_tokens) // self.page_size) - have, 0)
        if rec.kept and rec.kept[-1] and rec.length % self.page_size:
            need += 1
        return need

    def swap_in(self, seq_id, space):
        """Restore a swapped-out sequence: draw fresh pages for the
        private positions and write their host bytes back bit for bit,
        re-take the sequence's references on the kept (shared) pages and
        drop their swap holds. The restored chain holds the swapped-out
        bytes in the same order (the ids of private positions change).
        Atomic: capacity is checked before any change. Returns the
        number of pages restored from the host."""
        if seq_id in self._tables:
            raise ValueError(
                f"swap_in({seq_id!r}): sequence already allocated")
        key = (self._uid, seq_id)
        rec = space._swap_get(key)
        priv_n = sum(1 for k in rec.kept if not k)
        if priv_n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: swap_in needs {priv_n} "
                f"pages, {len(self._free)} free")
        chain = []
        new_priv = []
        for p, k in zip(rec.pages, rec.kept):
            if k:
                chain.append(p)
            else:
                chain.append(self._alloc_page())
                new_priv.append(chain[-1])
        if new_priv:
            pg = torch.tensor(new_priv, dtype=torch.int64,
                              device=self.device)
            if self.quantized:
                self._kv[:, pg] = torch.stack(
                    [rec.k_host, rec.v_host]).to(self.device)
                self._scales[:, pg] = torch.stack(
                    [rec.k_scales_host, rec.v_scales_host]).to(self.device)
            else:
                self.k_pages[pg] = rec.k_host.to(self.device)
                self.v_pages[pg] = rec.v_host.to(self.device)
        for p, k in zip(rec.pages, rec.kept):
            if k:
                # the sequence reference replaces the swap hold: net
                # refcount unchanged, ownership moves back
                self._ext_refs[p] -= 1
                if self._ext_refs[p] == 0:
                    del self._ext_refs[p]
        self._tables[seq_id] = chain
        self._lens[seq_id] = rec.length
        space._swap_pop(key)
        space.swapped_in_records += 1
        return len(new_priv)

    def swap_discard(self, seq_id, space):
        """Drop a swap record without restoring it (the abort of a
        swapped-out request): releases the swap holds on the kept pages
        and frees the host bytes. Returns the pages released back to
        the pool."""
        rec = space._swap_pop((self._uid, seq_id))
        shared = [p for p, k in zip(rec.pages, rec.kept) if k]
        return self.decref(shared) if shared else 0

    # -- appends -----------------------------------------------------------
    def ragged_pages_needed(self, seq_ids, counts) -> int:
        """Free-list draws a ragged append of ``counts[i]`` tokens per
        sequence would make: new pages opened past each tail, plus one
        per sequence whose first write lands mid-page on a SHARED page
        (the copy-on-write fork)."""
        need = 0
        for s, c in zip(seq_ids, counts):
            if not c:
                continue
            n = self._lens[s]
            have = -(-n // self.page_size) if n else 0
            need += -(-(n + c) // self.page_size) - have
            if self.pending_cow(s):
                need += 1
        return need

    def book_ragged(self, seq_ids, counts):
        """Bookkeeping half of a ragged append of ``counts[i]`` tokens to
        sequence ``seq_ids[i]``: an atomic capacity precheck (a short
        pool changes nothing), then the page draws, in the order the
        reference's token-by-token ``_next_slot`` makes them, and the
        length advance. A sequence whose first write lands mid-page on a
        shared tail page forks it first (:meth:`_fork_page`: the device
        copy is issued here, before any layer writes). The device write
        belongs to the caller. Returns the page ids drawn, fork
        destinations included, in order."""
        counts = [int(c) for c in counts]
        need = self.ragged_pages_needed(seq_ids, counts)
        if need > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: ragged append needs {need} "
                f"new pages, {len(self._free)} free")
        drawn = []
        for s, c in zip(seq_ids, counts):
            tbl = self._tables[s]
            if c and self.pending_cow(s):
                tbl[-1] = self._fork_page(tbl[-1])
                drawn.append(tbl[-1])
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
        call to every page it touches. A page has one writer, whose
        tokens are consecutive in the packed order: a shared page is
        forked at booking (:meth:`book_ragged`), before any write, so
        the writer holds a private copy. Pages do not interact, so these
        passes give each page the writes of the reference's waves (the
        j-th token of every chunk) in the same order: at most
        ``page_size`` passes instead of ``max(counts)``."""
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

    def dense_kv(self, seq_ids):
        """Dense gather of the listed sequences' pages: ``(page_table (B,
        MP) int32, k (B, MP, P, KVH, D), v (...))``. Float pools return
        their pages as stored; int8 pages come back dequantized to
        float32 against their scale rows, so a reader never touches the
        scales itself (the legacy speculative verify reads the pool this
        way)."""
        tbl = self.page_table(seq_ids)
        idx = tbl.long()
        kd, vd = self.k_pages[idx], self.v_pages[idx]
        if self.quantized:
            kd = kd.float() * self.k_scales[idx][:, :, None, :, None]
            vd = vd.float() * self.v_scales[idx][:, :, None, :, None]
        return tbl, kd, vd

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

