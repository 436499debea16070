"""The page-chain wire format of the port's pool (``HostKVSwapSpace.
export_seq`` / ``import_seq``) and the pool's mp shard geometry, against
the JAX package's, on the CPU.

The reference's ``TestWireFormat`` and ``TestShardedPool`` cases
(``tests/test_disagg.py``) run against the port. On top, the same chain,
filled from the same numpy K/V in both packages, exports to EQUAL payload
bytes (float32, bfloat16 and int8 pools; 1, 2 and 4 shards), and the
payloads of either package import into the other with pages and int8
scale rows bit for bit after ``swap_in``. Every comparison here is exact.
"""
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.framework import telemetry as jax_telemetry
from paddle_tpu.framework.flags import set_flags as jax_set_flags
from paddle_tpu.incubate.nn import PagedKVCacheManager as JaxPool
from paddle_tpu.incubate.nn.paged_cache import HostKVSwapSpace as JaxSpace

from paddle_tpu_torch.framework import telemetry
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.incubate.nn import PagedKVCacheManager
from paddle_tpu_torch.incubate.nn.paged_cache import (
    SWAP_WIRE_MAGIC,
    SWAP_WIRE_VERSION,
    HostKVSwapSpace,
    SwapSpaceFull,
    SwapWireError,
)

PAGE = 4
HEADS, HDIM = 4, 8


def _pool(kv=None, num_pages=32, heads=HEADS, mp_size=1, mp_rank=0,
          dtype=torch.float32):
    return PagedKVCacheManager(num_pages, PAGE, heads, HDIM, dtype=dtype,
                               kv_dtype=kv, mp_size=mp_size,
                               mp_rank=mp_rank, device="cpu")


def _fill(pool, sid, n, seed=0):
    rng = np.random.RandomState(seed)
    pool.alloc(sid)
    h = pool.kv_heads_local
    for _ in range(n):
        pool.append(sid, torch.from_numpy(rng.randn(h, HDIM).astype(
            np.float32)), torch.from_numpy(rng.randn(h, HDIM).astype(
                np.float32)))


def _chain_snapshot(pool, sid):
    pg = torch.tensor(pool.seq_pages(sid))
    out = [pool.k_pages[pg].clone(), pool.v_pages[pg].clone()]
    if pool.quantized:
        out += [pool.k_scales[pg].clone(), pool.v_scales[pg].clone()]
    return out


def _export(pool, sid, mp_shards=1, cap=1 << 20):
    """Swap one chain out and serialize it; returns (space, payloads)."""
    space = HostKVSwapSpace(cap)
    pool.swap_out(sid, space)
    return space, space.export_seq(sid, [pool], mp_shards=mp_shards)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------ the reference's cases
class TestWireFormat:
    @pytest.mark.parametrize("kv", [None, "int8"])
    def test_roundtrip_bitwise(self, kv):
        src = _pool(kv)
        _fill(src, "s", 9, seed=3)
        before = _chain_snapshot(src, "s")
        _, payloads = _export(src, "s")
        assert len(payloads) == 1
        assert payloads[0][:4] == SWAP_WIRE_MAGIC

        dst = _pool(kv)
        space2 = HostKVSwapSpace(1 << 20)
        n = space2.import_seq("s", payloads, [dst])
        assert n > 0 and space2.holds("s")
        dst.swap_in("s", space2)
        assert dst.seq_len("s") == 9
        _equal(before, _chain_snapshot(dst, "s"))

    def test_magic_mismatch_is_loud(self):
        src = _pool()
        _fill(src, "s", 5)
        _, payloads = _export(src, "s")
        bad = b"NOPE" + payloads[0][4:]
        with pytest.raises(SwapWireError, match="magic"):
            HostKVSwapSpace(1 << 20).import_seq("s", [bad], [_pool()])

    def test_version_mismatch_is_loud(self):
        src = _pool()
        _fill(src, "s", 5)
        _, payloads = _export(src, "s")
        drifted = (payloads[0][:4]
                   + struct.pack("<I", SWAP_WIRE_VERSION + 1)
                   + payloads[0][8:])
        with pytest.raises(SwapWireError, match="version mismatch"):
            HostKVSwapSpace(1 << 20).import_seq("s", [drifted],
                                                [_pool()])

    def test_truncated_payload_is_loud(self):
        src = _pool()
        _fill(src, "s", 5)
        _, payloads = _export(src, "s")
        with pytest.raises(SwapWireError):
            HostKVSwapSpace(1 << 20).import_seq(
                "s", [payloads[0][:-16]], [_pool()])
        with pytest.raises(SwapWireError, match="truncated"):
            HostKVSwapSpace(1 << 20).import_seq(
                "s", [payloads[0][:6]], [_pool()])

    def test_incomplete_shard_set_is_loud(self):
        src = _pool()
        _fill(src, "s", 6)
        _, payloads = _export(src, "s", mp_shards=2)
        assert len(payloads) == 2
        with pytest.raises(SwapWireError, match="shard"):
            HostKVSwapSpace(1 << 20).import_seq("s", payloads[:1],
                                                [_pool()])

    def test_geometry_mismatch_is_loud(self):
        src = _pool()
        _fill(src, "s", 6)
        _, payloads = _export(src, "s")
        wrong = PagedKVCacheManager(32, PAGE, HEADS, HDIM * 2,
                                    dtype=torch.float32, device="cpu")
        with pytest.raises(SwapWireError):
            HostKVSwapSpace(1 << 20).import_seq("s", payloads, [wrong])
        with pytest.raises(SwapWireError, match="layer record"):
            HostKVSwapSpace(1 << 20).import_seq("s", payloads,
                                                [_pool(), _pool()])

    def test_import_respects_capacity(self):
        src = _pool()
        _fill(src, "s", 6)
        _, payloads = _export(src, "s")
        space = HostKVSwapSpace(8)
        with pytest.raises(SwapSpaceFull):
            space.import_seq("s", payloads, [_pool()])
        assert space.num_records == 0  # atomic

    def test_export_pops_source_records(self):
        src = _pool()
        _fill(src, "s", 6)
        space, _ = _export(src, "s")
        assert not space.holds("s")
        assert space.used_bytes == 0
        assert space.exported_records == 1

    def test_kept_pages_cannot_travel(self):
        src = _pool()
        _fill(src, "a", 8)
        src.attach("b", src.seq_pages("a"), 8)
        space = HostKVSwapSpace(1 << 20)
        src.swap_out("b", space)
        with pytest.raises(SwapWireError, match="shared"):
            space.export_seq("b", [src])
        assert space.holds("b")  # atomic: nothing popped

    @pytest.mark.parametrize("kv", [None, "int8"])
    def test_shard_split_reassembles_on_sharded_pools(self, kv):
        """A 4-head chain exported as 2 shards lands bit for bit on two
        mp-sharded destination pools, each holding only its own heads."""
        src = _pool(kv)
        _fill(src, "s", 7, seed=5)
        full = _chain_snapshot(src, "s")
        _, payloads = _export(src, "s", mp_shards=2)
        assert len(payloads) == 2
        for rank in (0, 1):
            dst = _pool(kv, mp_size=2, mp_rank=rank)
            assert dst.kv_heads_local == HEADS // 2
            space = HostKVSwapSpace(1 << 20)
            space.import_seq("s", payloads, [dst])
            dst.swap_in("s", space)
            got = _chain_snapshot(dst, "s")
            lo = rank * (HEADS // 2)
            assert torch.equal(got[0], full[0][:, :, lo:lo + 2, :])
            assert torch.equal(got[1], full[1][:, :, lo:lo + 2, :])
            if kv == "int8":
                assert torch.equal(got[2], full[2][:, lo:lo + 2])
                assert torch.equal(got[3], full[3][:, lo:lo + 2])


class TestShardedPool:
    def test_geometry_attrs(self):
        p = _pool(mp_size=2, mp_rank=1)
        assert p.kv_heads_global == HEADS
        assert p.kv_heads_local == HEADS // 2
        assert p.head_start == HEADS // 2
        assert p.mp_size == 2 and p.mp_rank == 1
        assert p.k_pages.shape[2] == HEADS // 2

    def test_default_is_unsharded(self):
        p = _pool()
        assert p.mp_size == 1 and p.mp_rank == 0
        assert p.head_start == 0
        assert p.kv_heads_local == p.kv_heads_global == HEADS

    def test_heads_must_divide(self):
        with pytest.raises(ValueError, match="shard"):
            PagedKVCacheManager(16, PAGE, 3, HDIM, dtype=torch.float32,
                                mp_size=2, device="cpu")

    def test_rank_bounds(self):
        with pytest.raises(ValueError):
            _pool(mp_size=2, mp_rank=5)

    def test_error_texts_match_the_reference(self):
        for kw in ({"mp_size": 2, "mp_rank": 5}, {"mp_size": 3}):
            with pytest.raises(ValueError) as je:
                JaxPool(16, PAGE, HEADS, HDIM, dtype=jnp.float32, **kw)
            with pytest.raises(ValueError) as te:
                _pool(**kw)
            assert str(te.value) == str(je.value)


# ------------------------------------------------ across the packages
_DTYPES = {"float32": (None, jnp.float32, torch.float32),
           "bfloat16": (None, jnp.bfloat16, torch.bfloat16),
           "int8": ("int8", jnp.float32, torch.float32)}


class Twin:
    """The same chains in a JAX pool and a port pool, filled from the
    same numpy K/V (mixed ragged and single-token appends), with one
    swap space each."""

    def __init__(self, dtype, mp_size=1, mp_rank=0, num_pages=24):
        kv, jdt, tdt = _DTYPES[dtype]
        self.tdt = tdt
        self.jdt = jdt
        self.j = JaxPool(num_pages, PAGE, HEADS, HDIM, dtype=jdt,
                         kv_dtype=kv, mp_size=mp_size, mp_rank=mp_rank)
        self.t = PagedKVCacheManager(num_pages, PAGE, HEADS, HDIM,
                                     dtype=tdt, kv_dtype=kv,
                                     mp_size=mp_size, mp_rank=mp_rank,
                                     device="cpu")
        self.js, self.ts = JaxSpace(1 << 22), HostKVSwapSpace(1 << 22)

    def fill(self, sid, n, seed):
        rng = np.random.RandomState(seed)
        h = self.t.kv_heads_local
        k = rng.randn(n, h, HDIM).astype(np.float32)
        v = rng.randn(n, h, HDIM).astype(np.float32)
        self.j.alloc(sid)
        self.t.alloc(sid)
        m = n - 1
        self.j.append_ragged([sid], [m], jnp.asarray(k[:m]).astype(
            self.jdt), jnp.asarray(v[:m]).astype(self.jdt))
        self.t.append_ragged([sid], [m], torch.from_numpy(k[:m]).to(
            self.tdt), torch.from_numpy(v[:m]).to(self.tdt))
        self.j.append(sid, jnp.asarray(k[m]).astype(self.jdt),
                      jnp.asarray(v[m]).astype(self.jdt))
        self.t.append(sid, torch.from_numpy(k[m]).to(self.tdt),
                      torch.from_numpy(v[m]).to(self.tdt))


def _np(x):
    """Array bits as a comparable numpy array (bfloat16 as int16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return a


def _snap(pool, sid):
    pg = list(pool.seq_pages(sid))
    out = [_np(pool.k_pages)[pg], _np(pool.v_pages)[pg]]
    if pool.quantized:
        out += [_np(pool.k_scales)[pg], _np(pool.v_scales)[pg]]
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_payloads_byte_identical_across_packages(dtype, shards):
    tw = Twin(dtype)
    tw.fill("s", 11, seed=7)
    _same(_snap(tw.t, "s"), _snap(tw.j, "s"))
    tw.j.swap_out("s", tw.js)
    tw.t.swap_out("s", tw.ts)
    jp = tw.js.export_seq("s", [tw.j], mp_shards=shards)
    tp = tw.ts.export_seq("s", [tw.t], mp_shards=shards)
    assert len(tp) == len(jp) == shards
    for a, b in zip(tp, jp):
        assert a == b
    assert tw.ts.summary() == tw.js.summary()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_payloads_import_across_packages_bitwise(dtype, shards):
    """JAX payloads restore in the port, port payloads in the JAX
    package, each bit for bit against the source chain."""
    tw = Twin(dtype)
    tw.fill("s", 10, seed=2)
    before = _snap(tw.t, "s")
    tw.j.swap_out("s", tw.js)
    tw.t.swap_out("s", tw.ts)
    jp = tw.js.export_seq("s", [tw.j], mp_shards=shards)
    tp = tw.ts.export_seq("s", [tw.t], mp_shards=shards)
    into = Twin(dtype)
    into.ts.import_seq("s", jp, [into.t])
    into.js.import_seq("s", tp, [into.j])
    assert into.t.swap_in("s", into.ts) == into.j.swap_in("s", into.js)
    _same(before, _snap(into.t, "s"))
    _same(before, _snap(into.j, "s"))
    assert (into.t._tables, into.t._lens, into.t._free) == (
        into.j._tables, into.j._lens, into.j._free)
    assert into.ts.summary() == into.js.summary()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_jax_shards_land_on_sharded_port_pools(dtype):
    """A JAX export in 4 shards reassembles on port pools sharded 2
    ways, each holding its own head slice bit for bit."""
    tw = Twin(dtype)
    tw.fill("s", 9, seed=4)
    full = _snap(tw.j, "s")
    tw.j.swap_out("s", tw.js)
    jp = tw.js.export_seq("s", [tw.j], mp_shards=4)
    for rank in (0, 1):
        d = Twin(dtype, mp_size=2, mp_rank=rank)
        d.ts.import_seq("s", jp, [d.t])
        d.t.swap_in("s", d.ts)
        got = _snap(d.t, "s")
        lo, hi = 2 * rank, 2 * rank + 2
        _same(got[:2], [a[:, :, lo:hi] for a in full[:2]])
        if dtype == "int8":
            _same(got[2:], [a[:, lo:hi] for a in full[2:]])


def test_multi_layer_export_and_transfer_counters():
    """Two layer pools sharing one space: one payload carries both
    records in pool order; the ``pool.transfer_*`` counters are the
    reference's."""
    for tel, flags in ((telemetry, set_flags),
                       (jax_telemetry, jax_set_flags)):
        flags({"telemetry": "metrics"})
        tel.reset()
    try:
        a, b = Twin("int8"), Twin("int8")
        a.fill("s", 6, seed=1)
        b.fill("s", 6, seed=8)
        a.t.swap_out("s", a.ts)
        b.t.swap_out("s", a.ts)
        a.j.swap_out("s", a.js)
        b.j.swap_out("s", a.js)
        tp = a.ts.export_seq("s", [a.t, b.t], mp_shards=2)
        jp = a.js.export_seq("s", [a.j, b.j], mp_shards=2)
        assert tp == jp
        c, d = Twin("int8"), Twin("int8")
        c.ts.import_seq("s", tp, [c.t, d.t])
        c.js.import_seq("s", jp, [c.j, d.j])
        tsnap = telemetry.registry().snapshot()["pool"]
        jsnap = jax_telemetry.registry().snapshot()["pool"]
        keys = ("transfer_out_records", "transfer_out_bytes",
                "transfer_in_records", "transfer_in_bytes")
        assert {k: tsnap[k] for k in keys} == {k: jsnap[k] for k in keys}
        assert tsnap["transfer_out_bytes"] == sum(len(p) for p in tp)
        assert tsnap["transfer_in_bytes"] == tsnap["transfer_out_bytes"]
        assert tsnap["transfer_out_records"] == 2
        assert c.ts.summary()["imported_records"] == 2
    finally:
        for tel, flags in ((telemetry, set_flags),
                           (jax_telemetry, jax_set_flags)):
            flags({"telemetry": "off"})
            tel.reset()
