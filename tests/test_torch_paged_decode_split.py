"""The decode kernel's two-pass arithmetic (split the keys of each row
into chunks of whole pages, merge the chunks' float32 partials) and the
host-side plan that sizes it.

``paged_attention_split_plain`` repeats, in plain PyTorch, what the CUDA
decode kernel computes on the card (``csrc/paged_attention.cu``,
``decode_kernel_split`` then ``decode_kernel_merge``): per chunk of
``chunk_pages`` pages the partial (m, l, acc) of its kept keys, then
``m = max m_i``, ``l = sum l_i exp(m_i - m)``, ``acc = sum acc_i
exp(m_i - m)``, ``out = acc / max(l, 1e-30)``. It is held against the
JAX package's numpy oracle ``paged_attention_reference`` and its Pallas
``_decode_kernel`` in interpret mode, on the same numpy inputs.

Tolerance: float32, 1e-5 absolute. Outputs are convex combinations of V
entries of size ~1 (int8: codes times scales below 0.02 * 127), and the
split only reorders float32 sums. Rows with seq_len 0 are exactly 0.
"""
import importlib
import importlib.util
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import paddle_tpu as paddle
import torch

from paddle_tpu_torch.ops.kernels.paged_attention import (
    DECODE_CHUNK_KEYS,
    decode_split_plan,
    paged_attention_plain,
    paged_attention_split_plain,
)

jpa = importlib.import_module("paddle_tpu.ops.kernels.paged_attention")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-5
PAGE = 4

# name: (seq_lens, H, KVH, window, int8 pages); pages of 4 keys, so a
# window of 7 at seq_len 25 starts at key 18, inside the chunk [16, 24)
# of 2 pages and the chunk [16, 32) of 4
CASES = {
    "group4": ([25, 14, 9, 3], 8, 2, 0, False),
    "group7": ([30, 1, 17, 8], 14, 2, 0, False),
    "group4_window_mid_chunk": ([25, 14, 9, 3], 8, 2, 7, False),
    "seq_len0_rows": ([15, 0, 6, 0], 8, 2, 0, False),
    "int8_group4": ([13, 7, 30, 5], 8, 2, 0, True),
    "int8_group7_window_mid_chunk": ([25, 22, 0, 9], 14, 2, 7, True),
}


def _inputs(seq_lens, h, kvh, d=32, num_pages=64, seed=0, quant=False):
    """q (B, H, D), pages, scales (or None) and a page table of width 16
    (so a chunk of 16 pages is the whole table) giving each sequence its
    own shuffled pages; the table's tail points at other rows' pages."""
    rng = np.random.RandomState(seed)
    b = len(seq_lens)
    q = rng.randn(b, h, d).astype(np.float32)
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
    tbl = rng.permutation(num_pages)[:b * 16].reshape(b, 16).astype(np.int32)
    return q, kp, vp, tbl, np.asarray(seq_lens, np.int32), ks, vs


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("chunk_pages", [1, 2, 4, 16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_merge_matches_reference_and_pallas(name, chunk_pages):
    seq_lens, h, kvh, window, quant = CASES[name]
    q, kp, vp, tbl, lens, ks, vs = _inputs(seq_lens, h, kvh, quant=quant,
                                           seed=len(name) + chunk_pages)
    got = paged_attention_split_plain(
        *(_torch(a) for a in (q, kp, vp, tbl, lens)), chunk_pages,
        window=window, k_scales=_torch(ks), v_scales=_torch(vs)).numpy()
    ref = jpa.paged_attention_reference(q, kp, vp, tbl, lens, window=window,
                                        k_scales=ks, v_scales=vs)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    paddle.set_flags({"FLAGS_ragged_attention": "off"})
    try:
        pallas = np.asarray(jpa.paged_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tbl), jnp.asarray(lens), window=window,
            k_scales=None if ks is None else jnp.asarray(ks),
            v_scales=None if vs is None else jnp.asarray(vs)))
    finally:
        paddle.set_flags({"FLAGS_ragged_attention": "auto"})
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    one_pass = paged_attention_plain(
        *(_torch(a) for a in (q, kp, vp, tbl, lens)), window=window,
        k_scales=_torch(ks), v_scales=_torch(vs)).numpy()
    np.testing.assert_allclose(got, one_pass, atol=ATOL, rtol=0)
    for i, s in enumerate(seq_lens):
        if s == 0:
            assert np.all(got[i] == 0.0)


@pytest.mark.parametrize("page_size", [16, 1, 32, 256])
@pytest.mark.parametrize("max_pages", [1, 8, 64, 66, 128, 512])
def test_split_plan_at_serving_widths(max_pages, page_size):
    """Llama-3-8B serving (batch 8, 8 kv heads, group 4, D 128) at the
    page table widths the adapter and chip_smoke.py pass: whole pages of
    DECODE_CHUNK_KEYS keys a chunk, as few splits as cover the table,
    and a workspace of one float32 (acc[D], m, l) per (row, kv head,
    split, q head)."""
    chunk_pages, splits, shape = decode_split_plan(8, 8, 4, 128, max_pages,
                                                   page_size)
    assert chunk_pages == max(1, DECODE_CHUNK_KEYS // page_size)
    assert 1 <= chunk_pages <= 128  # the kernel's table slice
    assert (splits - 1) * chunk_pages < max_pages <= splits * chunk_pages
    assert shape == (8, 8, splits, 4, 130)


def test_split_plan_at_the_decode_case():
    # chip_smoke.py's `decode` case: a table of 128 pages of 16
    assert decode_split_plan(8, 8, 4, 128, 128, 16) == (
        8, 16, (8, 8, 16, 4, 130))
    # Qwen2-0.5B's heads, group 7 of D 64
    assert decode_split_plan(8, 2, 7, 64, 128, 16)[2] == (8, 2, 16, 7, 66)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_faults", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # imports no torch at module level
    return mod


CHIP_SMOKE = _chip_smoke()


@pytest.mark.parametrize(
    "fault", CHIP_SMOKE.FLASH_FAULTS + CHIP_SMOKE.PAGED_FAULTS
    + CHIP_SMOKE.NORM_FAULTS + CHIP_SMOKE.SERVE_FAULTS
    + CHIP_SMOKE.SPEC_FAULTS + CHIP_SMOKE.GEN_FAULTS
    + CHIP_SMOKE.PLANE_FAULTS + CHIP_SMOKE.FRONT_FAULTS
    + CHIP_SMOKE.QUANT_FAULTS + CHIP_SMOKE.TRAIN_FAULTS
    + CHIP_SMOKE.DIST_FAULTS,
    ids=lambda f: f[0])
def test_every_planted_fault_names_live_kernel_text(fault):
    """--fault-check replaces each fault's text in its source (CUDA; the
    page pool's Python for the serving faults; the scheduler for the
    speculative serving faults; the model, generation and
    loader modules for the generation faults; the pool, the scheduler
    and the fault injector for the host planes' faults; the pool's wire
    format, the engine and the scheduler's adoption for the serving
    fronts' faults; the quantizer, the fused-step gate, the clip and the
    warm-up schedule for the quantized serving and training-option
    faults) and refuses a text that
    does not occur exactly once; an edit that orphans a fault fails
    here, on the CPU."""
    name, source, old, new = fault[:4]
    text = (ROOT / source).read_text()
    assert text.count(old) == 1, f"{name}: {text.count(old)} occurrences"
    assert old != new


@pytest.mark.parametrize("ablation", CHIP_SMOKE.ABLATIONS,
                         ids=lambda a: a[0])
def test_every_ablation_names_live_kernel_text(ablation):
    """--ablations replaces each ablation's text in its CUDA source, as
    --fault-check does a fault's."""
    name, source, old, new = ablation[:4]
    text = (ROOT / source).read_text()
    assert text.count(old) == 1, f"{name}: {text.count(old)} occurrences"
    assert old != new
