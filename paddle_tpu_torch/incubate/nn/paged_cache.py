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

Sanitizer (``FLAGS_page_sanitizer`` or the ``sanitizer=`` argument;
``incubate/nn/page_sanitizer.py``): in ``warn``/``strict`` mode every
mutation here (alloc, attach, incref, decref, free, truncate, the
copy-on-write fork, each append flavour, swap out and in) and every
page table handed to a kernel is journaled as a typed event and checked
against a shadow heap with per-page generations. Each call journals the
events the reference's pool journals for the same call, with the same
fields, in the same order: :meth:`PagedKVCacheManager.book_ragged`
emits the forks and the append event, and each attend call checks the
page table its kernel gets (for a step built once, :class:`
RaggedStepInputs` carries the host copy of that table). ``off`` (the
default) builds nothing: each instrumented method pays one ``is None``
check. Under ``FLAGS_telemetry`` the pool counts page draws, frees,
forks and swapped pages (``pool.*``), and carries each sequence's
serialized trace context (``set_trace_context``) through the swap
records.

Page-chain wire format (disaggregated serving): :meth:`HostKVSwapSpace.
export_seq` serializes a swapped-out sequence's records into one
self-describing payload a KV-head shard (``SWAP_WIRE_MAGIC``,
``SWAP_WIRE_VERSION``, a JSON header with ``sort_keys``, then the
buffers), and :meth:`HostKVSwapSpace.import_seq` stores a complete shard
set as swap records of the destination pools, which ``swap_in`` then
restores. The payloads are byte for byte the reference package's for the
same chain: bfloat16 travels as its raw 2-byte words. A pool may be one
``mp`` shard of the KV heads (``mp_size``/``mp_rank``): it stores only
its contiguous head slice ``[head_start, head_start + kv_heads_local)``.
"""
from __future__ import annotations

import collections
import itertools
import json
import struct
from typing import NamedTuple

import numpy as np
import torch

from ...device import copy_to_device, resolve_device
from ...framework import concurrency as _concurrency
from ...framework import telemetry
from ...framework.flags import flag
from ...ops.kernels.paged_attention import (  # noqa: F401 (re-exported)
    paged_attention,
    paged_prefill_attention as _prefill_kernel,
    paged_ragged_attention as _ragged_kernel_fn,
    paged_ragged_fused_step as _fused_step_fn,
)
from ...ops.kernels.quant import kv_head_scale, quantize_kv

__all__ = ["PagedKVCacheManager", "paged_attention", "HostKVSwapSpace",
           "SwapSpaceFull", "SwapWireError", "SWAP_WIRE_MAGIC",
           "SWAP_WIRE_VERSION"]

_pool_uids = itertools.count()

# page-chain wire format (export_seq/import_seq): every payload leads
# with this magic and a version word, so a worker running drifted code
# REFUSES the bytes loudly instead of restoring corrupt KV. Bump
# SWAP_WIRE_VERSION on ANY layout change (header fields, buffer order,
# shard tagging): mixed-version fleets must fail at ingress.
SWAP_WIRE_MAGIC = b"PKVC"
SWAP_WIRE_VERSION = 1
_WIRE_HEAD = struct.Struct("<4sII")  # magic, version, header length

# wire kv_dtype name -> (torch dtype, the numpy dtype its bytes are read
# as); bfloat16 has no numpy dtype, so it travels as raw int16 words
_WIRE_DTYPES = {"float32": (torch.float32, np.float32),
                "float16": (torch.float16, np.float16),
                "bfloat16": (torch.bfloat16, np.int16),
                "int8": (torch.int8, np.int8)}

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
    write's pass plan (:meth:`PagedKVCacheManager._pass_plan`);
    ``host_table``, the host (page table, seq_lens) the device ones
    were copied from, which a sanitized pool checks at each attend."""
    slots: torch.Tensor
    page_table: torch.Tensor
    seq_lens: torch.Tensor
    q_lens: torch.Tensor
    passes: tuple = None
    host_table: tuple = None


class SwapSpaceFull(RuntimeError):
    """The host swap space cannot hold another record under its byte
    budget (FLAGS_serving_swap_bytes): the caller should pick a different
    victim or fall back to blocking admission."""


class SwapWireError(RuntimeError):
    """A page-chain wire payload failed validation at (de)serialize: bad
    magic, a version mismatch between workers, an incomplete or
    overlapping shard set, or geometry that does not match the
    destination pool. Raised LOUDLY: a silent fallback would restore
    corrupt KV bytes and decode garbage."""


def _wire_bytes(t) -> bytes:
    """Raw bytes of a contiguous host tensor (bfloat16 as its 2-byte
    words, which numpy has no dtype for)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _wire_tensor(buf, dtype, count, offset, shape):
    """A writable host tensor of ``count`` elements of wire dtype name
    ``dtype`` read from ``buf`` at byte ``offset``."""
    tdt, ndt = _WIRE_DTYPES[dtype]
    a = np.frombuffer(buf, ndt, count, offset).reshape(shape).copy()
    return torch.from_numpy(a).view(tdt)


class _SwapRecord:
    """One swapped-out sequence for ONE layer pool: the page chain as it
    stood (``pages``/``kept``/``length``), host copies of the private
    pages' payload (+ int8 scale rows), the sanitizer generations of the
    kept pages at swap-out and the sequence's serialized trace
    context."""

    __slots__ = ("pages", "kept", "length", "k_host", "v_host",
                 "k_scales_host", "v_scales_host", "gens", "nbytes",
                 "trace_ctx")

    def __init__(self, pages, kept, length, k_host, v_host,
                 k_scales_host, v_scales_host, gens, nbytes,
                 trace_ctx=None):
        self.pages = pages
        self.kept = kept
        self.length = length
        self.k_host = k_host
        self.v_host = v_host
        self.k_scales_host = k_scales_host
        self.v_scales_host = v_scales_host
        self.gens = gens
        self.nbytes = nbytes
        self.trace_ctx = trace_ctx


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
        self.exported_records = 0
        self.imported_records = 0
        self.peak_used_bytes = 0
        # transfer counters (pool.transfer_*); None when FLAGS_telemetry
        # is off: each site pays one check
        self._reg = telemetry.registry()
        # concurrency-sanitizer handle: the store is single-writer by
        # contract (the thread driving the pools' swap calls)
        _csan = _concurrency.sanitizer()
        self._cv = None if _csan is None else _csan.shared(
            "paged_cache.swap.store", owner=self, single_writer=True)

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

    def trace_context(self, seq_id):
        """The swapped-out sequence's serialized trace context
        (``telemetry.TraceContext.to_wire()``), read off its swap
        records; None when it is not swapped here or was never
        stamped."""
        for k, rec in self._swap_store.items():
            if k[1] == seq_id and rec.trace_ctx is not None:
                return rec.trace_ctx
        return None

    def summary(self) -> dict:
        return {
            "capacity_bytes": self.capacity_bytes,
            "used_bytes": self._swap_used,
            "peak_used_bytes": self.peak_used_bytes,
            "records": len(self._swap_store),
            "swapped_out_records": self.swapped_out_records,
            "swapped_in_records": self.swapped_in_records,
            "exported_records": self.exported_records,
            "imported_records": self.imported_records,
        }

    # -- page-chain wire transfer (disaggregated serving) ------------------
    def export_seq(self, seq_id, pools, mp_shards=1):
        """Serialize a swapped-out sequence's page chains (one swap record
        per layer pool, in ``pools`` order) into ``mp_shards``
        self-describing byte payloads and DROP the source records: the
        bytes leave this worker. Shard ``r`` carries the contiguous
        KV-head slice ``[r*H/N, (r+1)*H/N)`` of every record (payload and
        int8 scale rows, bit for bit), so each payload lands on exactly
        the ``mp`` shard owning those heads. Only fully PRIVATE chains can
        travel: a kept (shared) page is a prefix-cache/COW reference into
        THIS worker's pool and raises :class:`SwapWireError`. Atomic:
        validation happens before any record is popped."""
        mp_shards = int(mp_shards)
        if mp_shards < 1:
            raise ValueError("export_seq: mp_shards must be >= 1")
        if not pools:
            raise ValueError("export_seq: no pools given")
        recs = []
        for pool in pools:
            rec = self._swap_get((pool._uid, seq_id))
            if any(rec.kept):
                raise SwapWireError(
                    f"export_seq({seq_id!r}): the chain holds "
                    f"{sum(rec.kept)} shared (kept) page(s) — "
                    "prefix-cache/COW references cannot cross "
                    "workers; hand off only fully-private chains")
            recs.append(rec)
        g = pools[0]
        heads = g.k_pages.shape[2]
        head_dim = g.k_pages.shape[3]
        if heads % mp_shards:
            raise SwapWireError(
                f"export_seq({seq_id!r}): {heads} KV heads do not "
                f"split into {mp_shards} mp shards")
        per = heads // mp_shards
        payloads = []
        for r in range(mp_shards):
            h0, h1 = r * per, (r + 1) * per
            metas, bufs = [], []
            for pool, rec in zip(pools, recs):
                npriv = 0 if rec.k_host is None else len(rec.k_host)
                metas.append({
                    "pages": [int(p) for p in rec.pages],
                    "length": int(rec.length),
                    "npriv": int(npriv),
                    "trace_ctx": rec.trace_ctx,
                    "quantized": bool(pool.quantized),
                })
                if npriv:
                    bufs.append(_wire_bytes(rec.k_host[:, :, h0:h1, :]))
                    bufs.append(_wire_bytes(rec.v_host[:, :, h0:h1, :]))
                    if pool.quantized:
                        bufs.append(_wire_bytes(
                            rec.k_scales_host[:, h0:h1]))
                        bufs.append(_wire_bytes(
                            rec.v_scales_host[:, h0:h1]))
            header = json.dumps({
                "seq_id": str(seq_id),
                "shard": {"rank": r, "size": mp_shards,
                          "head_start": int(g.head_start + h0),
                          "heads": int(per)},
                "geometry": {
                    "page_size": int(g.page_size),
                    "head_dim": int(head_dim),
                    "kv_dtype": str(g.kv_dtype),
                    "kv_heads_global": int(g.kv_heads_global),
                    "layers": len(pools),
                },
                "records": metas,
            }, sort_keys=True).encode("utf-8")
            payloads.append(
                _WIRE_HEAD.pack(SWAP_WIRE_MAGIC, SWAP_WIRE_VERSION,
                                len(header))
                + header + b"".join(bufs))
        # validation passed for every layer: the records leave now
        for pool in pools:
            self._swap_pop((pool._uid, seq_id))
        self.exported_records += len(recs)
        if self._reg is not None:
            self._reg.inc("pool.transfer_out_records", len(recs))
            self._reg.inc("pool.transfer_out_bytes",
                          sum(len(p) for p in payloads))
        return payloads

    @staticmethod
    def _parse_wire(payload):
        """Split one wire payload into (header dict, buffer bytes),
        refusing bad magic or version drift LOUDLY."""
        if len(payload) < _WIRE_HEAD.size:
            raise SwapWireError(
                "page-chain payload truncated: %d bytes is shorter "
                "than the %d-byte wire header"
                % (len(payload), _WIRE_HEAD.size))
        magic, version, hlen = _WIRE_HEAD.unpack_from(payload)
        if magic != SWAP_WIRE_MAGIC:
            raise SwapWireError(
                "not a KV page-chain payload: magic %r != %r — "
                "refusing to deserialize (bitwise KV corruption)"
                % (magic, SWAP_WIRE_MAGIC))
        if version != SWAP_WIRE_VERSION:
            raise SwapWireError(
                "page-chain wire version mismatch: payload v%d, this "
                "worker speaks v%d — upgrade the drifted worker; a "
                "silent fallback would restore corrupt KV bytes"
                % (version, SWAP_WIRE_VERSION))
        head_end = _WIRE_HEAD.size + hlen
        try:
            header = json.loads(payload[_WIRE_HEAD.size:head_end])
        except ValueError as e:
            raise SwapWireError(
                "page-chain header is not valid JSON: %s" % e)
        return header, payload[head_end:]

    def import_seq(self, seq_id, payloads, pools):
        """Deserialize a complete mp shard set of page-chain payloads
        (from :meth:`export_seq` on the prefill worker) into THIS space,
        keyed to the destination ``pools``: afterwards the pools'
        ``swap_in`` (and :meth:`trace_context`, the decode-worker trace
        ingress) see the sequence exactly as if it had been swapped out
        here. Each destination pool takes the KV-head range it owns
        (``head_start .. head_start + kv_heads_local``), so full-width and
        mp-sharded decode pools both reassemble from the same shard set.
        Atomic: shard-set completeness, geometry, duplicate keys and the
        byte budget are all validated before any record is stored.
        Returns the host bytes stored."""
        parsed = sorted((self._parse_wire(p) for p in payloads),
                        key=lambda hp: hp[0]["shard"]["rank"])
        if not parsed:
            raise SwapWireError("import_seq: no payloads given")
        first = parsed[0][0]
        size = int(first["shard"]["size"])
        ranks = [h["shard"]["rank"] for h, _ in parsed]
        if ranks != list(range(size)):
            raise SwapWireError(
                f"import_seq({seq_id!r}): incomplete shard set — got "
                f"ranks {ranks} of a {size}-shard export")
        geo = first["geometry"]
        for h, _ in parsed[1:]:
            if h["geometry"] != geo or h["seq_id"] != first["seq_id"]:
                raise SwapWireError(
                    f"import_seq({seq_id!r}): shard headers disagree "
                    "on sequence/geometry — mixed exports?")
        if len(pools) != int(geo["layers"]):
            raise SwapWireError(
                f"import_seq({seq_id!r}): export carries "
                f"{geo['layers']} layer record(s), destination has "
                f"{len(pools)} pool(s)")
        if geo["kv_dtype"] not in _WIRE_DTYPES:
            raise SwapWireError(
                f"import_seq({seq_id!r}): unknown kv_dtype "
                f"{geo['kv_dtype']!r} on the wire")
        dname = geo["kv_dtype"]
        itemsize = np.dtype(_WIRE_DTYPES[dname][1]).itemsize
        ps, hd = int(geo["page_size"]), int(geo["head_dim"])
        quant = dname == "int8"
        # slice each payload's buffers per record, then reassemble the
        # head axis per destination pool
        shards = []  # [(head_start, heads, [record buffers])]
        for h, buf in parsed:
            sh = h["shard"]
            heads = int(sh["heads"])
            off, per_rec = 0, []
            for meta in h["records"]:
                npriv = int(meta["npriv"])
                n = npriv * ps * heads * hd
                nk = n * itemsize
                ns = npriv * heads * 4
                need = 2 * nk + (2 * ns if quant else 0)
                if off + need > len(buf):
                    raise SwapWireError(
                        f"import_seq({seq_id!r}): payload truncated "
                        f"mid-record ({len(buf)} bytes, need "
                        f"{off + need})")
                shape = (npriv, ps, heads, hd)
                k = _wire_tensor(buf, dname, n, off, shape)
                v = _wire_tensor(buf, dname, n, off + nk, shape)
                off += 2 * nk
                ks = vs = None
                if quant:
                    ks = _wire_tensor(buf, "float32", npriv * heads, off,
                                      (npriv, heads))
                    vs = _wire_tensor(buf, "float32", npriv * heads,
                                      off + ns, (npriv, heads))
                    off += 2 * ns
                per_rec.append((k, v, ks, vs))
            shards.append((int(sh["head_start"]), heads, per_rec))
        pend = []
        total = 0
        for li, pool in enumerate(pools):
            if (pool.page_size != ps
                    or pool.k_pages.shape[3] != hd
                    or pool.kv_dtype != dname
                    or pool.kv_heads_global
                    != int(geo["kv_heads_global"])):
                raise SwapWireError(
                    f"import_seq({seq_id!r}): destination pool "
                    f"{li} geometry (page_size={pool.page_size}, "
                    f"head_dim={pool.k_pages.shape[3]}, "
                    f"kv_dtype={pool.kv_dtype}, kv_heads_global="
                    f"{pool.kv_heads_global}) does not match the "
                    f"export's {geo}")
            key = (pool._uid, seq_id)
            if key in self._swap_store:
                raise SwapWireError(
                    f"import_seq({seq_id!r}): this space already "
                    f"holds a record for pool {li}")
            p0 = pool.head_start
            p1 = p0 + pool.k_pages.shape[2]
            meta = first["records"][li]
            npriv = int(meta["npriv"])
            kparts, vparts, ksparts, vsparts = [], [], [], []
            covered = 0
            for h0, heads, per_rec in shards:
                lo, hi = max(h0, p0), min(h0 + heads, p1)
                if lo >= hi:
                    continue
                k, v, ks, vs = per_rec[li]
                kparts.append(k[:, :, lo - h0:hi - h0, :])
                vparts.append(v[:, :, lo - h0:hi - h0, :])
                if quant:
                    ksparts.append(ks[:, lo - h0:hi - h0])
                    vsparts.append(vs[:, lo - h0:hi - h0])
                covered += hi - lo
            if covered != p1 - p0:
                raise SwapWireError(
                    f"import_seq({seq_id!r}): shard set covers "
                    f"{covered} of the {p1 - p0} KV heads pool {li} "
                    f"owns ([{p0}, {p1}))")
            k_host = v_host = ks_host = vs_host = None
            if npriv:
                k_host = torch.cat(kparts, dim=2).contiguous()
                v_host = torch.cat(vparts, dim=2).contiguous()
                if quant:
                    ks_host = torch.cat(ksparts, dim=1).contiguous()
                    vs_host = torch.cat(vsparts, dim=1).contiguous()
            rec = _SwapRecord(
                pages=[int(p) for p in meta["pages"]],
                kept=[False] * len(meta["pages"]),
                length=int(meta["length"]), k_host=k_host,
                v_host=v_host, k_scales_host=ks_host,
                v_scales_host=vs_host, gens=None,
                nbytes=npriv * pool.page_nbytes,
                trace_ctx=meta.get("trace_ctx"))
            pend.append((key, rec))
            total += rec.nbytes
        if not self.would_fit(total):
            raise SwapSpaceFull(
                f"import_seq({seq_id!r}): shard set needs {total} "
                f"bytes, {self.free_bytes} of {self.capacity_bytes} "
                "free")
        for key, rec in pend:
            self._swap_put(key, rec)
        self.imported_records += len(pend)
        if self._reg is not None:
            self._reg.inc("pool.transfer_in_records", len(pend))
            self._reg.inc("pool.transfer_in_bytes",
                          sum(len(p) for p in payloads))
        return total

    # -- pool-only entry points --------------------------------------------
    def _swap_put(self, key, rec):
        if key in self._swap_store:
            raise ValueError(
                f"swap space already holds a record for {key!r}")
        if self._swap_used + rec.nbytes > self.capacity_bytes:
            raise SwapSpaceFull(
                f"swap space full: record needs {rec.nbytes} bytes, "
                f"{self.free_bytes} of {self.capacity_bytes} free")
        if self._cv is not None:
            self._cv.write()
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
        if self._cv is not None:
            self._cv.write()
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
    ``sanitizer`` (``"off"``/``"warn"``/``"strict"``) overrides
    ``FLAGS_page_sanitizer`` for this pool. ``device`` defaults to the
    card and raises without CUDA unless ``device="cpu"`` is passed.
    """

    def __init__(self, num_pages, page_size, kv_heads, head_dim,
                 dtype=torch.bfloat16, kv_dtype=None, sanitizer=None,
                 device=None, mp_size=1, mp_rank=0):
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
        # mp KV-head sharding: ``kv_heads`` is the GLOBAL head count; a
        # sharded pool stores only the contiguous slice its mp rank owns,
        # so a page-chain wire shard lands on exactly the pool owning
        # those heads (export_seq/import_seq)
        self.mp_size = int(mp_size)
        self.mp_rank = int(mp_rank)
        if self.mp_size < 1 or not 0 <= self.mp_rank < self.mp_size:
            raise ValueError(
                f"mp_rank {mp_rank} out of range for mp_size "
                f"{mp_size}")
        if int(kv_heads) % self.mp_size:
            raise ValueError(
                f"{kv_heads} KV heads do not shard across an mp "
                f"mesh of {mp_size}")
        self.kv_heads_global = int(kv_heads)
        kv_heads = self.kv_heads_global // self.mp_size
        self.head_start = self.mp_rank * kv_heads
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
        # lifecycle sanitizer: 'off' builds nothing, and every
        # instrumented method below checks `self._san is not None` only
        mode = sanitizer if sanitizer is not None \
            else flag("page_sanitizer")
        if mode and mode != "off":
            from .page_sanitizer import PageSanitizer

            self._san = PageSanitizer(self.num_pages, self.page_size,
                                      mode=mode)
        else:
            self._san = None
        # lifetime pool counters under "pool." (None when
        # FLAGS_telemetry is off: one check per site)
        self._reg = telemetry.registry()
        # per-sequence serialized trace contexts (host strings): set by
        # the scheduler at admission, carried on the swap records
        self._trace_ctxs = {}

    # -- bookkeeping -------------------------------------------------------
    def alloc(self, seq_id):
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        if self._san is not None:
            self._san.event("alloc", seq=seq_id)
        self._tables[seq_id] = []
        self._lens[seq_id] = 0

    def attach(self, seq_id, pages, length, trace_ctx=None):
        """Register ``seq_id`` on an existing page chain covering its
        first ``length`` tokens (a prefix-cache hit). Every chain page
        gains a reference; the content is shared until this sequence
        writes into the (partial) last page, which forks it.
        ``trace_ctx`` (a serialized trace context) rides along."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        need = -(-int(length) // self.page_size) if length else 0
        if len(pages) != need:
            raise ValueError(
                f"attach({seq_id!r}): {length} tokens span {need} "
                f"pages, got a chain of {len(pages)}")
        if self._san is not None:
            # strict mode raises here, with the journal, on a dangling
            # chain, before the pool's own ValueError below
            self._san.event("attach", seq=seq_id,
                            pages=[int(p) for p in pages],
                            length=int(length))
        for p in pages:
            if self._refcnt[p] == 0:
                raise ValueError(
                    f"attach({seq_id!r}): page {p} is on the free "
                    "list (dangling chain)" + self._san_tail())
        self._ref_pages(pages)
        self._tables[seq_id] = list(pages)
        self._lens[seq_id] = int(length)
        if trace_ctx is not None:
            self._trace_ctxs[seq_id] = str(trace_ctx)
        if self._san is not None:
            self._san.verify_pages(pages, self)

    def _ref_pages(self, pages):
        """Take one reference per chain page (attach)."""
        for p in pages:
            self._refcnt[p] += 1

    # -- trace-context propagation (framework/telemetry.py) ----------------
    def set_trace_context(self, seq_id, wire) -> None:
        """Pin a serialized trace context (``TraceContext.to_wire()``)
        to a live sequence: it rides the sequence's swap records
        through the host tier. Host-only metadata."""
        if seq_id not in self._tables:
            raise KeyError(
                f"set_trace_context({seq_id!r}): unknown sequence")
        self._trace_ctxs[seq_id] = str(wire)

    def seq_trace_context(self, seq_id):
        """The sequence's serialized trace context (None when never
        stamped)."""
        return self._trace_ctxs.get(seq_id)

    def free(self, seq_id):
        tbl = self._tables.get(seq_id)
        if self._san is not None:
            # emitted BEFORE the lookup raise: a double-free lands in
            # the journal, strict mode raises with the event tail
            self._san.event(
                "free", seq=seq_id,
                pages=None if tbl is None else [int(p) for p in tbl])
        if tbl is None:
            raise KeyError(
                f"free({seq_id!r}): unknown or already-freed sequence "
                "(double-free would corrupt the page free list)"
                + self._san_tail())
        del self._tables[seq_id]
        self._drop_refs(tbl)
        self._lens.pop(seq_id)
        self._trace_ctxs.pop(seq_id, None)
        if self._san is not None:
            self._san.verify_pages(tbl, self)

    def _drop_refs(self, pages):
        """Release a retiring sequence's references (free)."""
        for p in reversed(pages):
            self._release_page(p)

    def _san_tail(self) -> str:
        return ("\n" + self._san.format_tail()
                if self._san is not None else "")

    # -- reference counting ------------------------------------------------
    def incref(self, pages):
        """Add an external (non-sequence) reference to each page: the
        prefix tree keeps a retired sequence's prefix alive past
        ``free``."""
        pages = list(pages)
        if self._san is not None:
            self._san.event("incref", pages=[int(p) for p in pages])
        for p in pages:
            if self._refcnt[p] == 0:
                raise ValueError(
                    f"incref: page {p} is free (cannot resurrect)"
                    + self._san_tail())
            self._refcnt[p] += 1
            self._ext_refs[p] += 1
        if self._san is not None:
            self._san.verify_pages(pages, self)

    def decref(self, pages):
        """Drop external references; returns how many pages that
        released back to the pool."""
        pages = list(pages)
        if self._san is not None:
            self._san.event("decref", pages=[int(p) for p in pages])
        freed = 0
        for p in pages:
            if self._ext_refs[p] <= 0:
                raise ValueError(
                    f"decref: page {p} holds no external reference"
                    + self._san_tail())
            self._ext_refs[p] -= 1
            if self._ext_refs[p] == 0:
                del self._ext_refs[p]
            freed += self._release_page(p)
        if self._san is not None:
            self._san.verify_pages(pages, self)
        return freed

    def _release_page(self, p):
        c = self._refcnt[p] - 1
        if c < 0:
            raise AssertionError(f"page {p} refcount underflow")
        self._refcnt[p] = c
        if c == 0:
            self._free.append(p)
            if self._reg is not None:
                self._reg.inc("pool.page_frees")
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
        if self._reg is not None:
            self._reg.inc("pool.page_allocs")
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
        if self._reg is not None:
            self._reg.inc("pool.cow_forks")
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
        dropped = tbl[keep:]
        if self._san is not None:
            self._san.event("truncate", seq=seq_id, n=int(n),
                            dropped=[int(p) for p in dropped])
        while len(tbl) > keep:
            self._release_page(tbl.pop())
        self._lens[seq_id] = n
        if self._san is not None and dropped:
            self._san.verify_pages(dropped, self)

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

    # -- lifecycle sanitizer surface (page_sanitizer.py) -------------------
    @property
    def sanitizer(self):
        """The pool's PageSanitizer, or None when off."""
        return self._san

    @property
    def sanitizer_stats(self):
        """Event/violation counters, or None when off."""
        return None if self._san is None else self._san.stats()

    def sanitizer_page_gens(self, pages):
        """Current shadow generation of each listed page (None when the
        sanitizer is off): captured next to a held chain, a later
        :meth:`sanitizer_check_chain` proves no page was recycled under
        the holder."""
        return (None if self._san is None
                else self._san.page_gens(pages))

    def sanitizer_check_chain(self, pages, gens, what="chain"):
        """Validate a generation-tagged chain captured earlier (the
        radix prefix tree checks its node chains on every match)."""
        if self._san is not None and gens is not None:
            self._san.check_chain(pages, gens, what=what)

    def sanitizer_note(self, op, **fields):
        """Journal a context-only event (prefix-cache pin / unpin /
        evict / insert): breadcrumbs, no shadow semantics."""
        if self._san is not None:
            self._san.note(op, **fields)

    def sanitizer_crosscheck(self):
        """Epoch cross-check: the shadow heap against the real pool
        (refcounts, free list, lengths, ``num_free_pages``) and, in
        strict mode, :meth:`assert_ref_invariants` too; the scheduler
        calls it every ``FLAGS_page_sanitizer_stride`` steps. Returns
        the sanitizer stats, or None when off."""
        if self._san is None:
            return None
        self._san.crosscheck(self)
        if self._san.mode == "strict":
            try:
                self.assert_ref_invariants()
            except AssertionError as e:
                raise AssertionError(
                    str(e) + "\n" + self._san.format_tail()) from None
        return self._san.stats()

    def _san_check_table(self, seq_ids, tbl, lens):
        self._san.check_table(seq_ids, np.asarray(tbl), np.asarray(lens))

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
        length = self._lens[seq_id]
        kept = [self._refcnt[p] > 1 for p in tbl]
        priv = [p for p, k in zip(tbl, kept) if not k]
        shared = [p for p, k in zip(tbl, kept) if k]
        host = self._gather_host(priv) if priv else (None,) * 4
        gens = (self._san.page_gens(shared)
                if self._san is not None else None)
        rec = _SwapRecord(list(tbl), kept, length, *host, gens=gens,
                          nbytes=len(priv) * self.page_nbytes,
                          trace_ctx=self._trace_ctxs.get(seq_id))
        space._swap_put((self._uid, seq_id), rec)
        self._trace_ctxs.pop(seq_id, None)
        if self._san is not None:
            self._san.event("swap_out", seq=seq_id,
                            pages=[int(p) for p in tbl],
                            kept=[bool(k) for k in kept],
                            length=int(length))
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
        if self._san is not None and tbl:
            self._san.verify_pages(tbl, self)
        if self._reg is not None:
            self._reg.inc("pool.swap_out_pages", freed)
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
        if self._san is not None:
            self._san.event(
                "swap_in", seq=seq_id,
                pages=[int(p) for p in chain],
                kept=[bool(k) for k in rec.kept],
                length=int(rec.length),
                gens=None if rec.gens is None
                else [int(g) for g in rec.gens],
                pool=self)
        space._swap_pop(key)
        space.swapped_in_records += 1
        if rec.trace_ctx is not None:
            # the restored sequence resumes its own trace
            self._trace_ctxs[seq_id] = rec.trace_ctx
        if self._reg is not None:
            self._reg.inc("pool.swap_in_pages", len(new_priv))
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

    def book_ragged(self, seq_ids, counts, op="append_ragged"):
        """Bookkeeping half of a ragged append of ``counts[i]`` tokens to
        sequence ``seq_ids[i]``: an atomic capacity precheck (a short
        pool changes nothing), then the page draws, in the order the
        reference's token-by-token ``_next_slot`` makes them, and the
        length advance. A sequence whose first write lands mid-page on a
        shared tail page forks it first (:meth:`_fork_page`: the device
        copy is issued here, before any layer writes). The device write
        belongs to the caller. Returns the page ids drawn, fork
        destinations included, in order.

        ``op``: the sanitizer event of the call, as the reference's pool
        names it: ``"append_ragged"`` (journaled when the call books a
        token), ``"append_batch"`` (one token a sequence, always
        journaled) or ``"append"`` (one token of one sequence)."""
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
                src = tbl[-1]
                tbl[-1] = self._fork_page(src)
                drawn.append(tbl[-1])
                if self._san is not None:
                    self._san.event("fork", seq=s, src=int(src),
                                    dst=int(tbl[-1]), pool=self)
            n = self._lens[s] + c
            while len(tbl) * self.page_size < n:
                tbl.append(self._alloc_page())
                drawn.append(tbl[-1])
            self._lens[s] = n
        if self._san is not None and (sum(counts)
                                      or op == "append_batch"):
            plan = self._slot_plan(seq_ids, counts)
            self._san.event(op, seq_ids=list(seq_ids), counts=counts,
                            pages=plan[0].tolist(), offs=plan[1].tolist(),
                            pool=self)
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

    def append(self, seq_id, k_tok, v_tok):
        """Write one token's K/V ((KVH, D) tensors or arrays) into the
        sequence's next slot; returns its (page, offset)."""
        k_tok, v_tok = (torch.as_tensor(t, device=self.device)
                        for t in (k_tok, v_tok))
        self.append_ragged([seq_id], [1], k_tok[None], v_tok[None],
                           op="append")
        n = self._lens[seq_id] - 1
        return self._tables[seq_id][n // self.page_size], n % self.page_size

    def append_batch(self, seq_ids, k_toks, v_toks):
        """Write one token's K/V for EVERY listed sequence in one scatter
        per pages tensor. k_toks/v_toks: (B, KVH, D)."""
        self.append_ragged(seq_ids, [1] * len(seq_ids), k_toks, v_toks,
                           op="append_batch")

    def append_ragged(self, seq_ids, counts, k_toks, v_toks, step=None,
                      op="append_ragged"):
        """Write ``counts[i]`` consecutive tokens' K/V for every listed
        sequence in one scatter per pages tensor. k_toks/v_toks:
        (sum(counts), KVH, D), rows ordered sequence-major.

        ``step``: the :class:`RaggedStepInputs` of a caller that booked
        the slots itself (:meth:`book_ragged`); without it the pool books
        them (journaled as ``op``) and plans the write here."""
        counts = [int(c) for c in counts]
        if sum(counts) != k_toks.shape[0]:
            raise ValueError(
                f"append_ragged: counts sum to {sum(counts)} but "
                f"{k_toks.shape[0]} token rows were passed")
        if step is None:
            self.book_ragged(seq_ids, counts, op=op)
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
        the pool's device, in one copy, and the host (page table,
        seq_lens)."""
        tbl, lens = self._padded_kernel_inputs(seq_ids, rows_pad, max_pages)
        ql = np.zeros(lens.shape, np.int32)
        ql[:len(q_lens)] = [int(c) for c in q_lens]
        return (*copy_to_device([tbl, lens, ql], self.device, torch.int32),
                (tbl, lens))

    def _attend_step(self, seq_ids, q_lens, rows_pad, max_pages):
        """The kernel inputs of an attend call without a booked step
        (no write plan)."""
        tbl, lens, ql, host = self._attend_inputs(seq_ids, q_lens,
                                                  rows_pad, max_pages)
        return RaggedStepInputs(None, tbl, lens, ql, None, host)

    def _check_step_table(self, seq_ids, step):
        """Sanitizer check of the page table a kernel gets from
        ``step`` (one pool built it for every layer: each pool checks it
        against its own shadow chains)."""
        if self._san is not None:
            self._san_check_table(seq_ids, *step.host_table)

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
            tbl, lens, ql, host_table = self._attend_inputs(
                seq_ids, counts, rows_pad, max_pages)
            return RaggedStepInputs(slots, tbl, lens, ql, passes,
                                    host_table)
        host = []
        for rows, pad in groups:
            tbl, lens = self._padded_kernel_inputs(
                [seq_ids[i] for i in rows], pad, max_pages)
            ql = np.zeros(lens.shape, np.int32)
            ql[:len(rows)] = [int(counts[i]) for i in rows]
            host += [tbl, lens, ql]
        dev = copy_to_device(host, self.device, torch.int32)
        return [RaggedStepInputs(slots, *dev[3 * g:3 * g + 3], passes,
                                 (host[3 * g], host[3 * g + 1]))
                for g in range(len(groups))]

    def page_table(self, seq_ids, max_pages=None):
        tbl, lens = self._padded_kernel_inputs(seq_ids, len(seq_ids),
                                               max_pages)
        if self._san is not None:
            self._san_check_table(seq_ids, tbl, lens)
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
            host = self._padded_kernel_inputs(seq_ids, rows_pad, max_pages)
            if self._san is not None:
                self._san_check_table(seq_ids, *host)
            tbl, lens = copy_to_device(host, self.device, torch.int32)
        else:
            self._check_step_table(seq_ids, step)
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
            step = self._attend_step(seq_ids, q_lens, rows_pad, max_pages)
        self._check_step_table(seq_ids, step)
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
            step = self._attend_step(seq_ids, q_lens, rows_pad, max_pages)
        self._check_step_table(seq_ids, step)
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
        self._check_step_table(seq_ids, step)
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
    def kv_heads_local(self) -> int:
        """KV heads THIS shard stores (``kv_heads_global // mp_size``)."""
        return self.k_pages.shape[2]

    @property
    def page_nbytes(self) -> int:
        return self.page_bytes(self.page_size, self.k_pages.shape[2],
                               self.k_pages.shape[3],
                               dtype=self.k_pages.dtype)

    @property
    def pool_nbytes(self) -> int:
        return self.page_nbytes * self.num_pages

