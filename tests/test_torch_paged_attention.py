"""Parity of the PyTorch port's ragged paged attention with the JAX
package's.

The JAX side runs its Pallas ``_ragged_kernel`` in interpret mode (the
default off-TPU, paged_attention.py:474) and the numpy oracle
``paged_ragged_attention_reference``; the port's wrapper, handed CPU
tensors, runs its plain version (the CUDA kernel is held against the
same plain version on the card by chip_smoke.py). Inputs come from
numpy with a seed, in float32.

Tolerance: 1e-5 absolute (float32 softmax and products in another
order; outputs are convex combinations of V entries of size ~1), and
padded rows exactly 0.
"""
import importlib
import zlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops.kernels import kernel_launch_stats
from paddle_tpu_torch.ops.kernels.paged_attention import (
    pad_plan_i32,
    packed_position_index,
    paged_ragged_attention,
    paged_ragged_fused_step,
)

jpa = importlib.import_module("paddle_tpu.ops.kernels.paged_attention")

ATOL = 1e-5


def _inputs(seq_lens, q_lens, t, h, kvh, d=32, page=4, num_pages=48,
            seed=0):
    """Random q/pages and a page table giving each sequence its own
    shuffled pages (padding rows keep page id 0 and seq_len 0)."""
    rng = np.random.RandomState(seed)
    b = len(seq_lens)
    q = rng.randn(b, t, h, d).astype(np.float32)
    kp = rng.randn(num_pages, page, kvh, d).astype(np.float32)
    vp = rng.randn(num_pages, page, kvh, d).astype(np.float32)
    mp = max(1, max(-(-s // page) for s in seq_lens))
    perm = rng.permutation(num_pages)
    tbl = np.zeros((b, mp), np.int32)
    used = 0
    for i, s in enumerate(seq_lens):
        n = -(-s // page)
        tbl[i, :n] = perm[used:used + n]
        used += n
    lens = np.asarray(seq_lens, np.int32)
    ql = None if q_lens is None else np.asarray(q_lens, np.int32)
    return q, kp, vp, tbl, lens, ql


def _port(q, kp, vp, tbl, lens, ql, window=0):
    t = torch.from_numpy
    return paged_ragged_attention(
        t(q), t(kp), t(vp), t(tbl), t(lens),
        None if ql is None else t(ql), window=window).numpy()


def _jax(q, kp, vp, tbl, lens, ql, window=0):
    return np.asarray(jpa.paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tbl), jnp.asarray(lens),
        q_lens=None if ql is None else jnp.asarray(ql), window=window))


CASES = {
    # name: (seq_lens, q_lens, T, H, KVH, window)
    "decode": ([9, 1, 16, 23], [1, 1, 1, 1], 1, 4, 2, 0),
    "prefill": ([12, 20], [12, 8], 12, 4, 2, 0),
    "mixed": ([13, 7, 30, 5], [1, 7, 1, 4], 8, 4, 2, 0),
    "window": ([25, 14, 9], [6, 1, 3], 6, 4, 2, 5),
    "gqa_4_2": ([17, 11], [3, 2], 4, 4, 2, 0),
    "mha": ([10, 6], [2, 6], 6, 2, 2, 0),
    "seq_len0_rows": ([15, 0, 6, 0], [2, 0, 1, 0], 2, 4, 2, 0),
    "q_lens_none": ([10, 5, 8], None, 4, 4, 2, 0),
}
# rows the numpy oracle cannot take: with q_lens absent and seq_len < T
# the leading real rows see no key, and the Pallas kernel averages V over
# the slots of the pages it visits
JAX_ONLY_CASES = {
    "q_lens_none_short": ([3, 6, 9], None, 8, 4, 2, 0),
    "q_lens_none_short_window": ([2, 13], None, 4, 4, 2, 3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_pallas_interpret_and_numpy_reference(name):
    seq_lens, q_lens, t, h, kvh, window = CASES[name]
    args = _inputs(seq_lens, q_lens, t, h, kvh,
                   seed=zlib.crc32(name.encode()) % 1000)
    got = _port(*args, window=window)
    np.testing.assert_allclose(got, _jax(*args, window=window),
                               atol=ATOL, rtol=0)
    ref = jpa.paged_ragged_attention_reference(*args[:5], q_lens=args[5],
                                               window=window)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(JAX_ONLY_CASES))
def test_rows_seeing_no_key_match_pallas_interpret(name):
    seq_lens, q_lens, t, h, kvh, window = JAX_ONLY_CASES[name]
    args = _inputs(seq_lens, q_lens, t, h, kvh, seed=7)
    got = _port(*args, window=window)
    np.testing.assert_allclose(got, _jax(*args, window=window),
                               atol=ATOL, rtol=0)
    # such rows are not zero: they average the visited slots
    assert np.abs(got[0, :t - seq_lens[0]]).max() > 0.01


@pytest.mark.parametrize("name", ["mixed", "seq_len0_rows", "window"])
def test_padded_rows_are_exactly_zero(name):
    seq_lens, q_lens, t, h, kvh, window = CASES[name]
    got = _port(*_inputs(seq_lens, q_lens, t, h, kvh, seed=3),
                window=window)
    for i, (s, n) in enumerate(zip(seq_lens, q_lens)):
        pad = t if s == 0 else t - n
        assert np.all(got[i, :pad] == 0.0), (i, pad)


def test_cpu_path_launches_no_kernel():
    kernel_launch_stats(reset=True)
    _port(*_inputs([5], [2], 2, 4, 2))
    assert kernel_launch_stats() == {}


def test_plan_helpers_match_reference():
    a = np.asarray([3, 1, 2], np.int32)
    np.testing.assert_array_equal(pad_plan_i32(a, 6, 9),
                                  np.asarray(jpa.pad_plan_i32(a, 6, 9)))
    starts, counts = [0, 3, 4], [3, 1, 5]
    np.testing.assert_array_equal(
        packed_position_index(starts, counts, [2, 0]),
        np.asarray(jpa.packed_position_index(starts, counts, [2, 0])))


def _fused_operands(has_bias, seed=0):
    """Operands of one packed fused step: 3 rows (a 4-token chunk, a
    decode row, a 2-token chunk) padded to a bucket of 10 with
    out-of-bounds drop entries. Values are small integers and the RoPE
    tables quarter-integers, so every product and sum is exact and the
    written pages can be compared bit for bit."""
    rng = np.random.RandomState(seed)
    e, nh, kvh, hd, page, npg = 16, 4, 2, 8, 4, 12
    counts, lens0 = [4, 1, 2], [3, 6, 0]
    n_real, n_pad = sum(counts), 10
    x = rng.randint(-3, 4, (n_pad, e)).astype(np.float32)
    w = {k: rng.randint(-2, 3, (e, n * hd)).astype(np.float32)
         for k, n in (("q", nh), ("k", kvh), ("v", kvh))}
    w["o"] = rng.randint(-2, 3, (nh * hd, e)).astype(np.float32)
    biases = tuple(rng.randint(-2, 3, (n * hd,)).astype(np.float32)
                   for n in (nh, kvh, kvh)) if has_bias else None
    pos = np.concatenate([np.arange(n, n + c) for n, c in
                          zip(lens0, counts)] + [np.zeros(n_pad - n_real)]
                         ).astype(np.int32)
    # RoPE tables of quarter-integers: every rotated value is exact, so
    # whether a backend fuses the rotation's multiply-add (XLA may) does
    # not change a bit of the pages
    cos = (rng.randint(-4, 5, (16, hd)) / 4).astype(np.float32)
    sin = (rng.randint(-4, 5, (16, hd)) / 4).astype(np.float32)
    # page plan: row 0 owns pages [5, 2], row 1 [7, 9], row 2 [0]
    chains = [[5, 2], [7, 9], [0]]
    pg, of = [], []
    for ch, n, c in zip(chains, lens0, counts):
        for j in range(n, n + c):
            pg.append(ch[j // page])
            of.append(j % page)
    seq_lens = [n + c for n, c in zip(lens0, counts)]
    b_pad, t_pad, mp = 4, 4, 2
    tbl = np.zeros((b_pad, mp), np.int32)
    for i, ch in enumerate(chains):
        tbl[i, :len(ch)] = ch
    lens = np.zeros(b_pad, np.int32)
    lens[:3] = seq_lens
    ql = np.zeros(b_pad, np.int32)
    ql[:3] = counts
    gm = np.zeros((b_pad, t_pad), np.int32)
    mr, mc, mf = [], [], []
    st = 0
    for r, c in enumerate(counts):
        gm[r, t_pad - c:] = np.arange(st, st + c)
        for j in range(c):
            mr.append(r)
            mc.append(t_pad - c + j)
            mf.append(st + j)
        st += c
    kp0 = rng.randint(-2, 3, (npg, page, kvh, hd)).astype(np.float32)
    vp0 = rng.randint(-2, 3, (npg, page, kvh, hd)).astype(np.float32)
    plans = dict(
        pg=pad_plan_i32(pg, n_pad, npg), of=pad_plan_i32(of, n_pad, 0),
        gm=gm, mr=pad_plan_i32(mr, n_pad, 0), mc=pad_plan_i32(mc, n_pad, 0),
        mflat=pad_plan_i32(mf, n_pad, n_pad))
    return (x, w, biases, cos, sin, pos, plans, kp0, vp0, tbl, lens, ql)


@pytest.mark.parametrize("plans", ["padded", "real_length"])
@pytest.mark.parametrize("has_bias", [False, True])
def test_fused_step_matches_jax_with_drop_entries(has_bias, plans):
    """The JAX step takes plans padded with out-of-bounds drop entries;
    the port takes the same padded plans cut at ``n_real``, or the
    real-length plans its own callers pass (device tensors)."""
    (x, w, biases, cos, sin, pos, plan, kp0, vp0, tbl, lens,
     ql) = _fused_operands(has_bias)
    j = jnp.asarray
    jy, jk, jv = jpa.paged_ragged_fused_step(
        j(x), j(w["q"]), j(w["k"]), j(w["v"]), j(w["o"]),
        None if biases is None else tuple(j(b) for b in biases),
        j(cos), j(sin), j(pos), j(plan["pg"]), j(plan["of"]),
        j(plan["gm"]), j(plan["mr"]), j(plan["mc"]),
        j(plan["mflat"]), j(kp0), j(vp0), j(tbl), j(lens), j(ql))
    t = torch.from_numpy
    n_real = int(ql.sum())
    names = ("pg", "of", "mr", "mc", "mflat")
    if plans == "padded":
        ops = [plan[k] for k in names]
    else:
        ops = [torch.from_numpy(plan[k][:n_real].astype(np.int64))
               for k in names]
    kp, vp = t(kp0.copy()), t(vp0.copy())
    y, kp_out, vp_out = paged_ragged_fused_step(
        t(x), t(w["q"]), t(w["k"]), t(w["v"]), t(w["o"]),
        None if biases is None else tuple(t(b) for b in biases),
        t(cos), t(sin), pos, ops[0], ops[1], plan["gm"], *ops[2:], kp, vp,
        t(tbl), t(lens), t(ql), n_real=n_real)
    # pages are written in place and returned
    assert kp_out is kp and vp_out is vp
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jv))
    # the pad entries wrote nothing: every untouched slot is unchanged
    touched = set(zip(plan["pg"][:n_real].tolist(),
                      plan["of"][:n_real].tolist()))
    for p_ in range(kp0.shape[0]):
        for o_ in range(kp0.shape[1]):
            if (p_, o_) not in touched:
                assert np.array_equal(kp.numpy()[p_, o_], kp0[p_, o_])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-3)
    # rows past the real tokens scatter nothing: zero attention, y = 0
    assert np.all(y.numpy()[n_real:] == 0.0)
