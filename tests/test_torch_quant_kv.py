"""The port's int8 KV pages against the JAX package's, on the CPU.

* ``ops/kernels/quant.py``: ``quantize_kv``, ``dequantize_kv`` and
  ``kv_head_scale`` give the reference's float32 bits.
* The int8 ``PagedKVCacheManager``: the same appends give the same
  bookkeeping and the same pages and scales BIT FOR BIT, after mixed
  ``append_batch`` / ``append_ragged`` traffic whose chunks start
  mid-page and grow a page's scale inside a chunk, booked by the pool or
  by the caller (``book_ragged`` + ``ragged_step_inputs``). The port
  replays the reference's per-token calibration by in-page position,
  the reference by wave; the bits decide whether the two agree.
* The int8 ragged kernel's plain version against the JAX int8 ragged
  kernel in Pallas interpret mode, and the pool's attends against the
  JAX pool's, within 1e-5 absolute (float32 softmax and products in
  another order, outputs of size ~1).

Inputs come from numpy with a seed, in float32.
"""
import importlib
import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import paddle_tpu as paddle
import torch

import paddle_tpu_torch as pt
from paddle_tpu.incubate.nn.paged_cache import PagedKVCacheManager as JaxPool
from paddle_tpu_torch.incubate.nn import PagedKVCacheManager
from paddle_tpu_torch.ops.kernels import quant
from paddle_tpu_torch.ops.kernels.paged_attention import (
    paged_ragged_attention,
    paged_ragged_attention_plain,
)

jq = importlib.import_module("paddle_tpu.ops.kernels.quant")
jpa = importlib.import_module("paddle_tpu.ops.kernels.paged_attention")

PAGE, NUM_PAGES, KVH, HD = 4, 32, 2, 8
SEQS = ["a", "b", "c"]
ATOL = 1e-5


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint32)


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    bad = np.argwhere(_bits(got) != _bits(want))
    assert bad.size == 0, f"{len(bad)} entries differ, first at {bad[:3]}"


# ------------------------------------------------------------ quant.py
@pytest.mark.parametrize("seed", range(4))
def test_quantize_dequantize_and_scale_are_bitwise(seed):
    rng = np.random.RandomState(seed)
    mag = rng.choice([1e-4, 1.0, 37.0], size=(24, 1, 1))
    kv = (rng.randn(24, 3, 16) * mag).astype(np.float32)
    for lead, x in ((1, kv), (0, kv[:4]), (2, kv.reshape(4, 6, 3, 16))):
        _same_bits(quant.kv_head_scale(torch.from_numpy(x), lead).numpy(),
                   jq.kv_head_scale(jnp.asarray(x), lead))
    scale = (np.abs(rng.randn(24, 3)) * 0.05).astype(np.float32)
    scale[0] = 0.0  # floored at 1e-20: the codes saturate
    kv[1] = 0.0     # a zero slab quantizes to zeros
    codes = quant.quantize_kv(torch.from_numpy(kv), torch.from_numpy(scale))
    _same_bits(codes.numpy(), jq.quantize_kv(jnp.asarray(kv),
                                             jnp.asarray(scale)))
    assert not codes[1].any()
    _same_bits(quant.dequantize_kv(codes, torch.from_numpy(scale)).numpy(),
               jq.dequantize_kv(jnp.asarray(codes.numpy()),
                                jnp.asarray(scale)))


def test_quantize_rounds_half_to_even_and_clips():
    kv = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 127.5, 300.0, -300.0],
                  np.float32)[None, None, :]
    one = np.ones((1, 1), np.float32)
    got = quant.quantize_kv(torch.from_numpy(kv), torch.from_numpy(one))
    _same_bits(got.numpy(), jq.quantize_kv(jnp.asarray(kv),
                                           jnp.asarray(one)))
    assert got.flatten().tolist() == [0, 2, 2, 0, -2, 126, 127, 127, -127]


# ------------------------------------------------------------ the pool
def _pools(num_pages=NUM_PAGES):
    j = JaxPool(num_pages, PAGE, KVH, HD, kv_dtype="int8")
    t = PagedKVCacheManager(num_pages, PAGE, KVH, HD, kv_dtype="int8",
                            device="cpu")
    for s in SEQS:
        j.alloc(s)
        t.alloc(s)
    return j, t


def _same_pool(j, t):
    assert t._tables == j._tables
    assert t._lens == j._lens
    assert t._free == j._free
    assert t.peak_used_pages == j.peak_used_pages
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        _same_bits(getattr(t, name).numpy(), getattr(j, name))


def _tokens(rng, n, grow=False):
    """(n, KVH, D) K and V; with ``grow`` each token is larger than the
    one before, so every write inside a chunk grows its page's scale."""
    mag = (np.geomspace(0.05, 20.0, n) if grow
           else rng.choice([0.01, 0.3, 4.0], size=n))[:, None, None]
    k = (rng.randn(n, KVH, HD) * mag).astype(np.float32)
    v = (rng.randn(n, KVH, HD) * mag * 0.5).astype(np.float32)
    return k, v


# (kind, sequences, tokens each): chunks that start mid-page, idle rows,
# decode rows, a chunk spanning four pages
TRAFFIC = [
    ("ragged", SEQS, [5, 1, 3]),
    ("batch", SEQS, None),
    ("ragged", SEQS, [6, 3, 0]),
    ("batch", ["a", "c"], None),
    ("ragged", ["b", "c"], [13, 2]),
    ("batch", SEQS, None),
    ("ragged", SEQS, [1, 1, 7]),
]


def _run_traffic(j, t, caller_books, rng, grow):
    for i, (kind, seqs, counts) in enumerate(TRAFFIC):
        if kind == "batch":
            k, v = _tokens(rng, len(seqs))
            j.append_batch(seqs, jnp.asarray(k), jnp.asarray(v))
            t.append_batch(seqs, torch.from_numpy(k), torch.from_numpy(v))
        else:
            k, v = _tokens(rng, sum(counts), grow=grow and i % 2 == 0)
            j.append_ragged(seqs, counts, jnp.asarray(k), jnp.asarray(v))
            step = None
            if caller_books:
                t.book_ragged(seqs, counts)
                step = t.ragged_step_inputs(seqs, counts)
            t.append_ragged(seqs, counts, torch.from_numpy(k),
                            torch.from_numpy(v), step=step)
        _same_pool(j, t)


@pytest.mark.parametrize("grow", [False, True], ids=["mixed", "growing"])
@pytest.mark.parametrize("caller_books", [False, True],
                         ids=["pool_books", "caller_books"])
def test_int8_appends_match_reference_bitwise(caller_books, grow):
    j, t = _pools()
    _run_traffic(j, t, caller_books, np.random.RandomState(1), grow)


def test_scale_growth_inside_a_chunk_requantizes_earlier_slots():
    """A chunk whose tokens grow: every later token widens the page's
    scales, so the earlier codes are requantized several times within
    one call — the case where replay order matters."""
    j, t = _pools()
    rng = np.random.RandomState(2)
    k, v = _tokens(rng, 11, grow=True)
    j.append_ragged(["a", "b"], [3, 8], jnp.asarray(k), jnp.asarray(v))
    t.append_ragged(["a", "b"], [3, 8], torch.from_numpy(k),
                    torch.from_numpy(v))
    _same_pool(j, t)
    first = t._tables["b"][0]
    assert t.k_scales[first].min() > 0


def test_freed_page_scale_resets_on_reuse():
    j, t = _pools(num_pages=6)
    rng = np.random.RandomState(3)
    k, v = _tokens(rng, 9)
    for pool, conv in ((j, jnp.asarray), (t, torch.from_numpy)):
        pool.append_ragged(["a"], [9], conv(k), conv(v))
        pool.free("a")
    reused = t._free[-1]
    assert float(t.k_scales[reused].abs().max()) > 0
    t.alloc("d")
    j.alloc("d")
    t.book_ragged(["d"], [1])  # draws the freed page again
    assert t._tables["d"] == [reused]
    assert not t.k_scales[reused].any() and not t.v_scales[reused].any()
    small = (np.ones((1, KVH, HD)) * 1e-3).astype(np.float32)
    j.append_ragged(["d"], [1], jnp.asarray(small), jnp.asarray(small))
    t.append_ragged(["d"], [1], torch.from_numpy(small),
                    torch.from_numpy(small),
                    step=t.ragged_step_inputs(["d"], [1]))
    _same_pool(j, t)


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16", "float32"])
def test_page_bytes_match_reference(kv_dtype):
    args = (16, 8, 128)
    assert PagedKVCacheManager.page_bytes(*args, kv_dtype=kv_dtype) == \
        JaxPool.page_bytes(*args, kv_dtype=kv_dtype)
    j = JaxPool(10, *args, kv_dtype=kv_dtype)
    t = PagedKVCacheManager(10, *args, kv_dtype=kv_dtype, device="cpu")
    assert (t.page_nbytes, t.pool_nbytes) == (j.page_nbytes, j.pool_nbytes)
    assert t.quantized == j.quantized == (kv_dtype == "int8")
    assert t.kv_dtype == j.kv_dtype


def test_bad_kv_dtype_is_rejected():
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedKVCacheManager(4, 4, 2, 8, kv_dtype="int4", device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        JaxPool(4, 4, 2, 8, kv_dtype="int4")
    with pytest.raises(ValueError, match="float or int8"):
        PagedKVCacheManager(4, 4, 2, 8, dtype=torch.int32, device="cpu")


def test_fused_ragged_step_refuses_an_int8_pool():
    _, t = _pools()
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="int8"):
        t.fused_ragged_step(x, (None,) * 5, (None, None), None, ["a"], [4],
                            None, ([0] * 4, [0] * 4, [0] * 4))
    assert t.seq_len("a") == 0  # refused before booking anything


# ------------------------------------------------- the int8 ragged kernel
def _int8_inputs(seq_lens, t, h, kvh, d=32, page=4, num_pages=48, seed=0):
    rng = np.random.RandomState(seed)
    b = len(seq_lens)
    q = rng.randn(b, t, h, d).astype(np.float32)
    shape = (num_pages, page, kvh, d)
    kp = rng.randint(-127, 128, shape).astype(np.int8)
    vp = rng.randint(-127, 128, shape).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, (num_pages, kvh)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (num_pages, kvh)).astype(np.float32)
    mp = max(1, max(-(-s // page) for s in seq_lens))
    perm = rng.permutation(num_pages)
    tbl = np.zeros((b, mp), np.int32)
    used = 0
    for i, s in enumerate(seq_lens):
        n = -(-s // page)
        tbl[i, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, tbl, np.asarray(seq_lens, np.int32), ks, vs


RAGGED_CASES = {
    # name: (seq_lens, q_lens, T, H, KVH, window)
    "mixed": ([13, 7, 30, 5], [1, 7, 1, 4], 8, 4, 2, 0),
    "prefill_chunk": ([20], [12], 12, 4, 2, 0),
    "window": ([25, 14, 9], [6, 1, 3], 6, 4, 2, 5),
    "seq_len0_rows": ([15, 0, 6, 0], [2, 0, 1, 0], 2, 8, 2, 0),
    # rows that see no key average the dequantized V of the visited pages
    "no_key_rows": ([3, 6, 9], None, 8, 4, 2, 0),
}


@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_int8_ragged_plain_matches_pallas_interpret(name):
    seq_lens, q_lens, t, h, kvh, window = RAGGED_CASES[name]
    q, kp, vp, tbl, lens, ks, vs = _int8_inputs(
        seq_lens, t, h, kvh, seed=zlib.crc32(name.encode()) % 1000)
    ql = None if q_lens is None else np.asarray(q_lens, np.int32)
    tt = torch.from_numpy
    got = paged_ragged_attention_plain(
        tt(q), tt(kp), tt(vp), tt(tbl), tt(lens),
        None if ql is None else tt(ql), window=window, k_scales=tt(ks),
        v_scales=tt(vs)).numpy()
    want = np.asarray(jpa.paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(lens), q_lens=None if ql is None else jnp.asarray(ql),
        window=window, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if q_lens is not None:
        ref = jpa.paged_ragged_attention_reference(
            q, kp, vp, tbl, lens, q_lens=ql, window=window, k_scales=ks,
            v_scales=vs)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    else:
        assert np.abs(got[0, :t - seq_lens[0]]).max() > 1e-3
    # the public entry takes the plain version for CPU tensors
    pub = paged_ragged_attention(
        tt(q), tt(kp), tt(vp), tt(tbl), tt(lens),
        None if ql is None else tt(ql), window=window, k_scales=tt(ks),
        v_scales=tt(vs)).numpy()
    np.testing.assert_array_equal(pub, got)


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_int8_pool_attends_match_reference(mode):
    """After the same traffic, the int8 pools' decode, prefill and ragged
    attends agree (decode through the decode kernel under ``off``)."""
    j, t = _pools()
    rng = np.random.RandomState(4)
    _run_traffic(j, t, True, rng, grow=False)
    seqs, h = SEQS, 4
    q1 = rng.randn(3, h, HD).astype(np.float32)
    qr = rng.randn(4, 4, h, HD).astype(np.float32)
    pt.set_flags({"FLAGS_ragged_attention": mode})
    paddle.set_flags({"FLAGS_ragged_attention": mode})
    try:
        pairs = [
            (t.attend(torch.from_numpy(q1), seqs, window=5),
             j.attend(jnp.asarray(q1), seqs, window=5)),
            (t.attend_padded(torch.from_numpy(qr[:, 0]), seqs, rows_pad=4,
                             max_pages=8),
             j.attend_padded(jnp.asarray(qr[:, 0]), seqs, rows_pad=4,
                             max_pages=8)),
            (t.attend_prefill(torch.from_numpy(qr), seqs, [3, 1, 4],
                              rows_pad=4, max_pages=8),
             j.attend_prefill(jnp.asarray(qr), seqs, [3, 1, 4], rows_pad=4,
                              max_pages=8)),
            (t.attend_ragged(torch.from_numpy(qr), seqs, [3, 1, 4],
                             rows_pad=4, max_pages=8),
             j.attend_ragged(jnp.asarray(qr), seqs, [3, 1, 4], rows_pad=4,
                             max_pages=8)),
        ]
    finally:
        pt.set_flags({"FLAGS_ragged_attention": "auto"})
        paddle.set_flags({"FLAGS_ragged_attention": "auto"})
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want._data),
                                   atol=ATOL, rtol=0)
