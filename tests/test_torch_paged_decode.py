"""Parity of the port's paged decode attention (``paged_attention``) with
the JAX package's, under each ``FLAGS_ragged_attention`` mode.

Under ``off`` the JAX side runs its Pallas ``_decode_kernel`` in
interpret mode (the default off-TPU) and is itself checked against the
numpy oracle ``paged_attention_reference``; the port's wrapper, handed
CPU tensors, runs ``paged_attention_plain`` (the CUDA decode kernel is
held against the same plain version on the card by chip_smoke.py).
Under ``auto``/``on`` both packages route through their ragged kernel at
T=1. Inputs come from numpy with a seed; int8 pages are random codes
with random positive per-page, per-head scales.

Tolerances: float32, 1e-5 absolute (float32 softmax and products in
another order; outputs are convex combinations of V entries of size
~1). bfloat16 q and pages, 2e-2 absolute: the Pallas float branch rounds
p to bf16 before PV (2^-9 relative per weight) where the port keeps it
in float32, and both round the output to bf16, whose spacing is 2^-7 at
outputs in [1, 2); the cases here differ by at most one such spacing.
Rows with seq_len 0 return exactly 0.
"""
import contextlib
import importlib
import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import paddle_tpu as paddle
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.framework.flags import ragged_attention_mode
from paddle_tpu_torch.incubate.nn import functional as port_functional
from paddle_tpu_torch.ops.kernels import kernel_launch_stats
from paddle_tpu_torch.ops.kernels.paged_attention import (
    paged_attention,
    paged_attention_plain,
    paged_prefill_attention,
    paged_ragged_attention,
    paged_ragged_attention_plain,
)

jpa = importlib.import_module("paddle_tpu.ops.kernels.paged_attention")

ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


@contextlib.contextmanager
def ragged_mode(mode):
    """FLAGS_ragged_attention set in both packages, restored after."""
    pt.set_flags({"FLAGS_ragged_attention": mode})
    paddle.set_flags({"FLAGS_ragged_attention": mode})
    try:
        yield
    finally:
        pt.set_flags({"FLAGS_ragged_attention": "auto"})
        paddle.set_flags({"FLAGS_ragged_attention": "auto"})


def _inputs(seq_lens, h, kvh, d=32, page=4, num_pages=48, seed=0,
            quant=False):
    """q (B, H, D), pages, scales (or None) and a page table giving each
    sequence its own shuffled pages (padding rows keep page 0 and
    seq_len 0)."""
    rng = np.random.RandomState(seed)
    b = len(seq_lens)
    q = rng.randn(b, h, d).astype(np.float32)
    shape = (num_pages, page, kvh, d)
    if quant:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, (num_pages, kvh)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, (num_pages, kvh)).astype(np.float32)
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    mp = max(1, max(-(-s // page) for s in seq_lens))
    perm = rng.permutation(num_pages)
    tbl = np.zeros((b, mp), np.int32)
    used = 0
    for i, s in enumerate(seq_lens):
        n = -(-s // page)
        tbl[i, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, tbl, np.asarray(seq_lens, np.int32), ks, vs


def _port(q, kp, vp, tbl, lens, ks, vs, window=0, dtype="float32"):
    dt = getattr(torch, dtype)
    t = torch.from_numpy
    qt = t(q).to(dt)
    kt, vt = ((t(kp), t(vp)) if kp.dtype == np.int8
              else (t(kp).to(dt), t(vp).to(dt)))
    out = paged_attention(qt, kt, vt, t(tbl), t(lens), window=window,
                          k_scales=None if ks is None else t(ks),
                          v_scales=None if vs is None else t(vs))
    assert out.dtype == dt
    return out.float().numpy()


def _jax(q, kp, vp, tbl, lens, ks, vs, window=0, dtype="float32"):
    dt = getattr(jnp, dtype)
    kj, vj = ((jnp.asarray(kp), jnp.asarray(vp)) if kp.dtype == np.int8
              else (jnp.asarray(kp, dt), jnp.asarray(vp, dt)))
    out = jpa.paged_attention(
        jnp.asarray(q, dt), kj, vj, jnp.asarray(tbl), jnp.asarray(lens),
        window=window, k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs))
    return np.asarray(out.astype(jnp.float32))


CASES = {
    # name: (seq_lens, H, KVH, window, int8 pages, dtype)
    "mha": ([9, 1, 16, 23], 2, 2, 0, False, "float32"),
    "gqa2": ([13, 7, 30, 5], 4, 2, 0, False, "float32"),
    "gqa4": ([17, 11, 4], 8, 2, 0, False, "float32"),
    "window": ([25, 14, 9, 3], 4, 2, 5, False, "float32"),
    "seq_len0_rows": ([15, 0, 6, 0], 4, 2, 0, False, "float32"),
    "int8": ([13, 7, 30, 5], 4, 2, 0, True, "float32"),
    "int8_gqa4_window": ([25, 14, 9, 0], 8, 2, 6, True, "float32"),
    "bf16_gqa2": ([13, 7, 30, 5], 4, 2, 0, False, "bfloat16"),
    "bf16_int8_window": ([21, 3, 12], 4, 1, 7, True, "bfloat16"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_off_matches_pallas_decode_kernel(name):
    seq_lens, h, kvh, window, quant, dtype = CASES[name]
    args = _inputs(seq_lens, h, kvh, quant=quant,
                   seed=zlib.crc32(name.encode()) % 1000)
    with ragged_mode("off"):
        want = _jax(*args, window=window, dtype=dtype)
        got = _port(*args, window=window, dtype=dtype)
    np.testing.assert_allclose(got, want, atol=ATOL[dtype], rtol=0)
    if dtype == "float32":
        ref = jpa.paged_attention_reference(
            *args[:5], window=window, k_scales=args[5], v_scales=args[6])
        np.testing.assert_allclose(want, ref, atol=ATOL[dtype], rtol=0)
        np.testing.assert_allclose(got, ref, atol=ATOL[dtype], rtol=0)
    for i, s in enumerate(seq_lens):
        if s == 0:
            assert np.all(got[i] == 0.0)


@pytest.mark.parametrize("mode", ["auto", "on"])
@pytest.mark.parametrize("name", ["gqa2", "window", "seq_len0_rows",
                                  "int8_gqa4_window"])
def test_unified_modes_are_the_ragged_kernel_at_t1(name, mode):
    seq_lens, h, kvh, window, quant, dtype = CASES[name]
    q, kp, vp, tbl, lens, ks, vs = _inputs(seq_lens, h, kvh, quant=quant,
                                           seed=5)
    t = torch.from_numpy
    scales = {} if ks is None else {"k_scales": t(ks), "v_scales": t(vs)}
    with ragged_mode(mode):
        got = _port(q, kp, vp, tbl, lens, ks, vs, window=window)
        want = _jax(q, kp, vp, tbl, lens, ks, vs, window=window)
        ragged = paged_ragged_attention(
            t(q)[:, None], t(kp), t(vp), t(tbl), t(lens),
            q_lens=torch.ones(len(seq_lens), dtype=torch.int32),
            window=window, **scales)[:, 0].numpy()
    np.testing.assert_array_equal(got, ragged)
    np.testing.assert_allclose(got, want, atol=ATOL["float32"], rtol=0)


def test_modes_agree_with_each_other():
    """The decode kernel and the ragged kernel at T=1 compute one
    function: the port's plain versions agree within float32 rounding."""
    args = _inputs([25, 14, 9, 3], 4, 2, quant=True, seed=9)
    outs = {}
    for mode in ("auto", "off"):
        with ragged_mode(mode):
            outs[mode] = _port(*args, window=5)
    np.testing.assert_allclose(outs["off"], outs["auto"],
                               atol=ATOL["float32"], rtol=0)


def test_functional_export_is_the_decode_entry():
    args = _inputs([13, 7, 30, 5], 4, 2, seed=3)
    t = torch.from_numpy
    with ragged_mode("off"):
        got = port_functional.paged_attention(*(t(a) for a in args[:5]))
        want = paged_attention(*(t(a) for a in args[:5]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_prefill_alias_is_the_ragged_kernel():
    rng = np.random.RandomState(4)
    _, kp, vp, tbl, lens, ks, vs = _inputs([12, 20], 4, 2, quant=True,
                                           seed=4)
    q = torch.from_numpy(rng.randn(2, 8, 4, 32).astype(np.float32))
    t = torch.from_numpy
    ql = torch.tensor([8, 3], dtype=torch.int32)
    a = paged_prefill_attention(q, t(kp), t(vp), t(tbl), t(lens),
                                k_scales=t(ks), v_scales=t(vs), q_lens=ql)
    b = paged_ragged_attention(q, t(kp), t(vp), t(tbl), t(lens), q_lens=ql,
                               k_scales=t(ks), v_scales=t(vs))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("fn", [paged_attention, paged_attention_plain,
                                paged_ragged_attention,
                                paged_ragged_attention_plain],
                         ids=lambda f: f.__name__)
def test_scale_pairing_errors(fn):
    q, kp, vp, tbl, lens, ks, vs = (
        None if a is None else torch.from_numpy(a)
        for a in _inputs([5, 3], 4, 2, quant=True, seed=1))
    if "ragged" in fn.__name__:
        q = q[:, None]
    with ragged_mode("off"):
        with pytest.raises(ValueError, match="both k_scales and v_scales"):
            fn(q, kp, vp, tbl, lens, k_scales=ks)
        with pytest.raises(ValueError, match="both k_scales and v_scales"):
            fn(q, kp, vp, tbl, lens, v_scales=vs)
        with pytest.raises(ValueError, match="int8 pages need"):
            fn(q, kp, vp, tbl, lens)
        with pytest.raises(ValueError, match="int8 pages need"):
            fn(q, kp.float(), vp.float(), tbl, lens, k_scales=ks,
               v_scales=vs)


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_cpu_tensors_launch_no_kernel(mode):
    args = _inputs([13, 7], 4, 2, quant=True, seed=2)
    kernel_launch_stats(reset=True)
    with ragged_mode(mode):
        _port(*args)
    assert kernel_launch_stats() == {}


def test_flag_rejects_unknown_modes_and_is_restored():
    with pytest.raises(ValueError, match="auto|on|off"):
        with ragged_mode("sometimes"):
            ragged_attention_mode()
    assert ragged_attention_mode() == "auto"
    assert str(paddle.get_flags(["FLAGS_ragged_attention"])[
        "FLAGS_ragged_attention"]) == "auto"
