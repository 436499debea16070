"""The ragged kernel's split arithmetic on the card (split each row's keys
into chunks of whole pages, merge the chunks' float32 partials in order)
and the host-side plan that sizes its tensor-core route.

``paged_ragged_attention_split_plain`` repeats, in plain PyTorch, what the
CUDA routes of ``paged_ragged_attention`` compute
(``csrc/paged_attention.cu``): at T = 1 the decode kernel's split over
pages with q_lens, at T > 1 ``ragged_kernel_wgmma`` then
``ragged_kernel_merge``: per chunk of ``chunk_pages`` pages the partial
(m, l, acc) of its kept keys, int8 codes entering as codes with each key's
K scale on its column of S and V scale on its column of P, then the merge
in chunk order. It is held against the JAX package's numpy oracle
``paged_ragged_attention_reference`` and its Pallas ``_ragged_kernel`` in
interpret mode (the default off-TPU), on the same numpy inputs.

Tolerance: float32, 1e-5 absolute. Outputs are convex combinations of V
entries of size ~1 (int8: codes times scales below 0.02 * 127), and the
split only reorders float32 sums. Padded rows and rows of seq_len 0 are
exactly 0.
"""
import functools
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops.kernels.paged_attention import (
    RAGGED_MAX_CHUNK_PAGES,
    RAGGED_TILE_PAIRS,
    RAGGED_WORKSPACE_BYTES,
    decode_split_plan,
    paged_ragged_attention_plain,
    paged_ragged_attention_split_plain,
    ragged_split_plan,
)

jpa = importlib.import_module("paddle_tpu.ops.kernels.paged_attention")

ATOL = 1e-5
PAGE = 4
WIDTH = 16  # the page table's width: a chunk of 16 pages is the whole table

# name: (seq_lens, q_lens, T, H, KVH, window, int8 pages). Pages of 4
# keys; a window of 7 at qpos 28 starts at key 22, inside the chunks
# [20, 24) of 1 page, [16, 24) of 2 and [16, 32) of 4.
CASES = {
    "t1_group4_q_len0_rows": ([25, 14, 9, 3], [1, 1, 0, 0], 1, 8, 2, 0,
                              False),
    "t1_group7_int8": ([30, 1, 17, 0], [1, 1, 1, 0], 1, 14, 2, 0, True),
    "chunk_beside_decode_group4": ([25, 14, 40, 3], [1, 1, 12, 1], 12, 8,
                                   2, 0, False),
    "chunk_beside_decode_group7": ([30, 9, 17, 22], [10, 1, 1, 10], 10, 14,
                                   2, 0, False),
    "window_mid_chunk_group4": ([40, 14, 33, 9], [12, 1, 5, 1], 12, 8, 2, 7,
                                False),
    "int8_group4": ([37, 7, 30, 5], [9, 1, 4, 5], 9, 8, 2, 0, True),
    "int8_group7_window": ([41, 22, 0, 9], [8, 1, 0, 3], 8, 14, 2, 6, True),
    "seq_len0_rows": ([15, 0, 6, 0], [3, 0, 2, 0], 3, 8, 2, 0, False),
}
# q_lens absent and seq_len < T: the leading rows see no key and take the
# mean of V over the visited pages' slots (the numpy oracle has no such
# rows, the Pallas kernel does)
NO_KEY_CASES = {
    "no_key_rows_group4": ([3, 6, 9, 26], None, 8, 8, 2, 0, False),
    "no_key_rows_int8_group7": ([2, 13, 5, 30], None, 6, 14, 2, 0, True),
}


def _inputs(name, seq_lens, t, h, kvh, quant, d=32, num_pages=64):
    """q (B, T, H, D), pages, scales (or None) and a page table of width
    16 giving each sequence its own shuffled pages; the table's tail
    points at other rows' pages."""
    rng = np.random.RandomState(sum(map(ord, name)))
    b = len(seq_lens)
    q = rng.randn(b, t, h, d).astype(np.float32)
    shape = (num_pages, PAGE, kvh, d)
    if quant:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, (num_pages, kvh)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, (num_pages, kvh)).astype(np.float32)
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    tbl = rng.permutation(num_pages)[:b * WIDTH].reshape(b, WIDTH)
    return (q, kp, vp, tbl.astype(np.int32),
            np.asarray(seq_lens, np.int32), ks, vs)


def _case(name):
    return {**CASES, **NO_KEY_CASES}[name]


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """The Pallas kernel in interpret mode (once per case)."""
    seq_lens, q_lens, t, h, kvh, window, quant = _case(name)
    q, kp, vp, tbl, lens, ks, vs = _inputs(name, seq_lens, t, h, kvh, quant)
    j = jnp.asarray
    return np.asarray(jpa.paged_ragged_attention(
        j(q), j(kp), j(vp), j(tbl), j(lens),
        q_lens=None if q_lens is None else j(np.asarray(q_lens, np.int32)),
        window=window, k_scales=None if ks is None else j(ks),
        v_scales=None if vs is None else j(vs)))


def _split(name, chunk_pages):
    seq_lens, q_lens, t, h, kvh, window, quant = _case(name)
    q, kp, vp, tbl, lens, ks, vs = _inputs(name, seq_lens, t, h, kvh, quant)
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    ql = None if q_lens is None else tt(np.asarray(q_lens, np.int32))
    return paged_ragged_attention_split_plain(
        tt(q), tt(kp), tt(vp), tt(tbl), tt(lens), ql, chunk_pages,
        window=window, k_scales=tt(ks), v_scales=tt(vs)).numpy()


@pytest.mark.parametrize("chunk_pages", [1, 2, 4, 16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_merge_matches_reference_and_pallas(name, chunk_pages):
    seq_lens, q_lens, t, h, kvh, window, quant = CASES[name]
    got = _split(name, chunk_pages)
    q, kp, vp, tbl, lens, ks, vs = _inputs(name, seq_lens, t, h, kvh, quant)
    ref = jpa.paged_ragged_attention_reference(
        q, kp, vp, tbl, lens, q_lens=np.asarray(q_lens), window=window,
        k_scales=ks, v_scales=vs)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _pallas(name), atol=ATOL, rtol=0)
    for i, (s, n) in enumerate(zip(seq_lens, q_lens)):
        pad = t if s == 0 else t - n
        assert np.all(got[i, :pad] == 0.0), (i, pad)


@pytest.mark.parametrize("chunk_pages", [1, 4, 16])
@pytest.mark.parametrize("name", sorted(NO_KEY_CASES))
def test_rows_seeing_no_key_match_pallas(name, chunk_pages):
    seq_lens, _, t, *_ = NO_KEY_CASES[name]
    got = _split(name, chunk_pages)
    np.testing.assert_allclose(got, _pallas(name), atol=ATOL, rtol=0)
    # such rows are not zero: they average the visited slots
    assert np.abs(got[0, :t - seq_lens[0]]).max() > 0.001


@pytest.mark.parametrize("name", sorted(CASES) + sorted(NO_KEY_CASES))
def test_split_at_the_plans_chunks_matches_the_one_pass_version(name):
    """The chunks the card uses (the decode plan at T = 1, the
    tensor-core plan at T > 1) against the plain one-pass version."""
    seq_lens, q_lens, t, h, kvh, window, quant = _case(name)
    b, d = len(seq_lens), 32
    if t == 1:
        chunk_pages = decode_split_plan(b, kvh, h // kvh, d, WIDTH, PAGE)[0]
    else:
        chunk_pages = ragged_split_plan(b, t, h, kvh, d, WIDTH, PAGE)[2]
    got = _split(name, chunk_pages)
    q, kp, vp, tbl, lens, ks, vs = _inputs(name, seq_lens, t, h, kvh, quant)
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    one_pass = paged_ragged_attention_plain(
        tt(q), tt(kp), tt(vp), tt(tbl), tt(lens),
        None if q_lens is None else tt(np.asarray(q_lens, np.int32)),
        window=window, k_scales=tt(ks), v_scales=tt(vs)).numpy()
    np.testing.assert_allclose(got, one_pass, atol=ATOL, rtol=0)


@pytest.mark.parametrize("page_size", [16, 4, 64, 256])
@pytest.mark.parametrize("max_pages", [1, 8, 64, 66, 128, 512, 2048])
@pytest.mark.parametrize("shape", [(1, 256, 32, 8, 128), (8, 256, 32, 8, 128),
                                   (8, 256, 14, 2, 64), (4, 64, 32, 8, 128),
                                   (1, 2, 4, 4, 64)],
                         ids=lambda s: "b{}_t{}_h{}_kvh{}_d{}".format(*s))
def test_ragged_plan_invariants(shape, max_pages, page_size):
    """M tiles of at most 64 (row, head) pairs cover T; chunks are whole
    pages and whole 64-key tiles, at most RAGGED_MAX_CHUNK_PAGES, and
    cover the table; the workspace stays within its budget where one
    chunk may take the table, and there is none for one split."""
    b, t, h, kvh, d = shape
    rows, tiles, chunk_pages, splits, ws = ragged_split_plan(
        b, t, h, kvh, d, max_pages, page_size)
    group = h // kvh
    assert rows == RAGGED_TILE_PAIRS // group and rows * group <= 64
    assert (tiles - 1) * rows < t <= tiles * rows
    assert (splits - 1) * chunk_pages < max_pages <= splits * chunk_pages
    assert chunk_pages <= RAGGED_MAX_CHUNK_PAGES
    if splits == 1:
        assert ws is None and chunk_pages == max_pages
    else:
        assert chunk_pages * page_size % 64 == 0 or page_size > 64
        assert ws == (b, kvh, tiles, splits, 64, d + 2)
        # within the budget, unless the table is too wide for one chunk
        assert (np.prod(ws) * 4 <= RAGGED_WORKSPACE_BYTES
                or max_pages > RAGGED_MAX_CHUNK_PAGES)


def test_ragged_plan_at_the_chip_cases():
    # chip_smoke.py's prefill_chunk (1,000 keys) and prefill_chunk_8k:
    # one sequence, Llama-3-8B's heads, tables of 64 and 512 pages of 16:
    # 128 blocks a split, so two splits
    assert ragged_split_plan(1, 256, 32, 8, 128, 64, 16) == (
        16, 16, 32, 2, (1, 8, 16, 2, 64, 130))
    assert ragged_split_plan(1, 256, 32, 8, 128, 512, 16) == (
        16, 16, 256, 2, (1, 8, 16, 2, 64, 130))
    # the serving path's mixed bucket (8 x 256): one split, no workspace
    assert ragged_split_plan(8, 256, 32, 8, 128, 128, 16) == (
        16, 16, 128, 1, None)
    # Qwen2-0.5B's heads (group 7): 9 rows x 7 heads a tile, 464 blocks
    assert ragged_split_plan(8, 256, 14, 2, 64, 128, 16) == (
        9, 29, 128, 1, None)
