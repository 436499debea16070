"""Parity of the PyTorch port's chunked fused linear cross-entropy with
the JAX package's (``ops/kernels/fused_loss.py``, plain XLA there too).

The same h, w and labels (numpy, seeded) go through both; gradients of
the JAX side come from ``jax.vjp`` of its custom-VJP function, those of
the port from torch autograd through its ``autograd.Function``.

Tolerances: float32 loss within 1e-6 relative and gradients within
1e-5 relative + 1e-7 (the same chunked float32 arithmetic, matrix
products summed in another order). bf16 inputs: both sides take exact
bf16 products summed in float32 and round dlogits, dh and dw to bf16 at
the same points, so the loss agrees to 1e-5 relative and the gradients
to one bf16 spacing of the largest entry (a float32 difference of ~1e-7
can flip one rounding).
"""
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.kernels import fused_loss as jfl

from paddle_tpu_torch.incubate.nn.functional import \
    fused_linear_cross_entropy as port_incubate
from paddle_tpu_torch.ops.kernels import fused_loss as tfl

BF16_ULP = 2.0 ** -7


def _data(t, hidden, vocab, seed, ignore=()):
    rng = np.random.RandomState(seed)
    h = (rng.randn(t, hidden) * 0.5).astype(np.float32)
    w = (rng.randn(vocab, hidden) * 0.3).astype(np.float32)
    lab = rng.randint(0, vocab, size=t).astype(np.int64)
    lab[list(ignore)] = -100
    return h, w, lab


def _jax(h, w, lab, chunk, reduction, dtype=jnp.float32, transpose=False):
    hj = jnp.asarray(h).astype(dtype)
    wj = jnp.asarray(w.T if transpose else w).astype(dtype)

    def f(hh, ww):
        return jfl.fused_linear_cross_entropy(
            hh, ww.T if transpose else ww, jnp.asarray(lab), chunk=chunk,
            reduction=reduction)

    out, vjp = jax.vjp(f, hj, wj)
    dh, dw = vjp(jnp.ones_like(out))
    return [np.asarray(jnp.asarray(a).astype(jnp.float32))
            for a in (out, dh, dw)]


def _port(h, w, lab, chunk, reduction, dtype=torch.float32,
          transpose=False):
    ht = torch.from_numpy(h).to(dtype).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.T if transpose else w)) \
        .to(dtype).requires_grad_()
    if transpose:
        out = port_incubate(ht, wt, torch.from_numpy(lab), chunk=chunk,
                            reduction=reduction, transpose_w=True)
    else:
        out = tfl.fused_linear_cross_entropy(
            ht, wt, torch.from_numpy(lab), chunk=chunk, reduction=reduction)
    out.backward(torch.ones_like(out))
    return [a.detach().float().numpy() for a in (out, ht.grad, wt.grad)]


def _close(got, want, dtype):
    out_g, dh_g, dw_g = got
    out_w, dh_w, dw_w = want
    if dtype == "float32":
        np.testing.assert_allclose(out_g, out_w, rtol=1e-6, atol=1e-6)
        for g, w in ((dh_g, dh_w), (dw_g, dw_w)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(out_g, out_w, rtol=1e-5, atol=1e-5)
        for g, w in ((dh_g, dh_w), (dw_g, dw_w)):
            assert np.abs(g - w).max() <= BF16_ULP * np.abs(w).max()


@pytest.mark.parametrize("t,hidden,vocab,chunk", [
    (24, 16, 96, 32),      # divisible: 3 chunks
    (24, 16, 262, 128),    # ragged: 128 + 128 + a 6-row tail
    (17, 8, 257, 64),      # prime vocab: 4 x 64 + a 1-row tail
    (10, 8, 40, 4096),     # one chunk
], ids=["divisible", "ragged", "prime", "one_chunk"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_float32_matches_reference(t, hidden, vocab, chunk, reduction):
    h, w, lab = _data(t, hidden, vocab, seed=vocab, ignore=(1, 5))
    _close(_port(h, w, lab, chunk, reduction),
           _jax(h, w, lab, chunk, reduction), "float32")


@pytest.mark.parametrize("vocab,chunk", [(96, 32), (262, 128)])
def test_bf16_matches_reference(vocab, chunk):
    h, w, lab = _data(32, 16, vocab, seed=3, ignore=(0,))
    _close(_port(h, w, lab, chunk, "mean", dtype=torch.bfloat16),
           _jax(h, w, lab, chunk, "mean", dtype=jnp.bfloat16), "bfloat16")


def test_transpose_w_matches_reference():
    """``transpose_w=True``: w arrives [H, V], the ColumnParallelLinear
    layout of an untied head."""
    h, w, lab = _data(12, 8, 100, seed=4, ignore=(2,))
    _close(_port(h, w, lab, 48, "mean", transpose=True),
           _jax(h, w, lab, 48, "mean", transpose=True), "float32")


def test_all_ignored_is_zero_not_nan():
    h, w, lab = _data(6, 8, 50, seed=5, ignore=range(6))
    out, dh, dw = _port(h, w, lab, 16, "mean")
    assert out == 0.0
    assert not np.any(dh) and not np.any(dw)
    np.testing.assert_array_equal(
        out, _jax(h, w, lab, 16, "mean")[0])


def test_three_dim_input_and_none_keeps_label_shape():
    rng = np.random.RandomState(6)
    h = rng.randn(2, 5, 8).astype(np.float32)
    w = rng.randn(30, 8).astype(np.float32)
    lab = rng.randint(0, 30, size=(2, 5))
    got = tfl.fused_linear_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(lab),
        chunk=16, reduction="none")
    want = jfl.fused_linear_cross_entropy(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab), chunk=16,
        reduction="none")
    assert tuple(got.shape) == (2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("v,target", [
    (151936, 4096), (32000, 4096), (50304, 4096), (7, 4096), (257, 64),
    (262, 128), (4096, 4096)])
def test_pick_chunk_matches_reference(v, target):
    assert tfl._pick_chunk(v, target) == jfl._pick_chunk(v, target)


def test_qwen2_vocab_takes_64_chunks_of_2374():
    assert tfl._pick_chunk(151936, 4096) == 2374
    assert len(tfl._chunks(151936, 4096)) == 64


def test_bad_reduction_and_vocab_parallel_raise():
    h = torch.zeros(2, 4)
    w = torch.zeros(5, 4)
    lab = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError):
        tfl.fused_linear_cross_entropy(h, w, lab, reduction="max")
    # the vocab-parallel head: an unknown reduction, and a sequence the
    # mp degree does not divide (the reference's ValueError)
    with pytest.raises(ValueError):
        tfl.fused_linear_cross_entropy_vocab_parallel(
            h[None], w, lab[None], reduction="max")
    two_ranks = types.SimpleNamespace(nranks=2, rank=0)
    with pytest.raises(ValueError, match="divisible"):
        tfl.fused_linear_cross_entropy_vocab_parallel(
            h[None, :1], w, lab[None, :1], group=two_ranks)
