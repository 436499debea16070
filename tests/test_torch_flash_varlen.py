"""Parity of the PyTorch port's packed (varlen) flash attention with the
JAX package's.

Two JAX routes serve as the reference, as tests/test_flash_varlen.py
uses them:

* the blocked-ragged Pallas kernel ``flash_varlen.varlen_attention`` in
  interpret mode (``FLAGS_pallas_interpret=True``, block 64, so every
  total is a multiple of 64): forward and, through its custom VJP,
  dq/dk/dv. It alone defines the rows that see no key (out = 0, zero
  gradients), so the cases with an empty k segment compare only here;
* the public ``F.flash_attn_unpadded`` off the TPU (its segment-masked
  XLA path), forward and dq/dk/dv through autograd.

The port's wrappers, handed CPU tensors, run their plain segment-by-
segment versions (the CUDA kernels are held against the same plain
versions on the card by chip_smoke.py). Inputs come from numpy with a
seed, in float32. Tolerances are the JAX tests' own: out within 5e-5
and gradients within 1e-4 (absolute and relative; the same float32
arithmetic, blocked differently).
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as F
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.kernels import kernel_launch_stats

jfv = importlib.import_module("paddle_tpu.ops.kernels.flash_varlen")
pfv = importlib.import_module("paddle_tpu_torch.ops.kernels.flash_varlen")

OUT_TOL, GRAD_TOL = 5e-5, 1e-4
BLOCK = 64


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype("int32")


def _case(tq, tk, h, hkv, d, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(tq, h, d) * 0.5).astype("float32")
    k = (rng.randn(tk, hkv, d) * 0.5).astype("float32")
    v = (rng.randn(tk, hkv, d) * 0.5).astype("float32")
    do = (rng.randn(tq, h, d) * 0.5).astype("float32")
    return q, k, v, do


# name: (q lengths, k lengths (None: the q lengths), total q, total k,
#        H, KVH, D, causal); totals past sum(lengths) are the tail
CASES = {
    "causal": ([60, 130, 66], None, 256, 256, 4, 4, 64, True),
    "noncausal": ([60, 130, 66], None, 256, 256, 4, 4, 64, False),
    "gqa": ([130, 126], None, 256, 256, 8, 2, 64, True),
    "tile_edges": ([64, 128, 64], None, 256, 256, 4, 2, 64, True),
    "tiny_docs": ([8] * 32, None, 256, 256, 2, 1, 64, True),
    "cu_q_ne_k": ([40, 88], [100, 28], 128, 128, 4, 2, 64, True),
    "tail": ([100, 100], None, 256, 256, 4, 2, 64, True),
    "d128": ([70, 58], None, 128, 128, 2, 1, 128, False),
    # Qwen2-0.5B's heads (group 7), lengths a multiple of neither 9 (the
    # CUDA dQ kernel's rows an M tile) nor 64, and a tail of 0
    "group7": ([61, 140, 55], None, 256, 256, 14, 2, 64, True),
}
# q segment 1 sees an empty k segment (its rows see no key); the k tail
# of 28 tokens is its own segment
NO_KEY = ([40, 88], [100, 0], 128, 128, 4, 2, 64, True)


def _inputs(spec, seed):
    lq, lk, tq, tk, h, hkv, d, causal = spec
    lk = lq if lk is None else lk
    return _case(tq, tk, h, hkv, d, seed), _cu(lq), _cu(lk), causal


def _pallas(q, k, v, cq, ck, causal):
    d = q.shape[-1]
    paddle.set_flags({"FLAGS_pallas_interpret": True})
    try:
        return jfv.varlen_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cq),
            jnp.asarray(ck), causal, 1.0 / np.sqrt(d), block_q=BLOCK,
            block_k=BLOCK)
    finally:
        paddle.set_flags({"FLAGS_pallas_interpret": False})


def _pallas_grads(q, k, v, do, cq, ck, causal):
    d = q.shape[-1]

    def loss(a, b, c):
        o = jfv.varlen_attention(a, b, c, jnp.asarray(cq), jnp.asarray(ck),
                                 causal, 1.0 / np.sqrt(d), block_q=BLOCK,
                                 block_k=BLOCK)
        return jnp.vdot(o, jnp.asarray(do))

    paddle.set_flags({"FLAGS_pallas_interpret": True})
    try:
        return jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    finally:
        paddle.set_flags({"FLAGS_pallas_interpret": False})


def _port(q, k, v, do, cq, ck, causal):
    """(out, dq, dk, dv) of the port's public API through autograd."""
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, none = PF.flash_attn_unpadded(*ts, torch.from_numpy(cq),
                                       torch.from_numpy(ck), causal=causal)
    assert none is None
    (out * torch.from_numpy(do)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _close(got, want, tol):
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_fwd_matches_pallas_interpret(name):
    (q, k, v, _), cq, ck, causal = _inputs(CASES[name], len(name))
    ref = _pallas(q, k, v, cq, ck, causal)
    out, lse = pfv.flash_varlen_fwd(*(torch.from_numpy(a) for a in
                                      (q, k, v, cq, ck)), causal)
    assert out.dtype == torch.float32 and tuple(lse.shape) == \
        (q.shape[1], q.shape[0])
    _close(out.numpy(), ref, OUT_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_pallas_interpret(name):
    (q, k, v, do), cq, ck, causal = _inputs(CASES[name], 3 + len(name))
    want = _pallas_grads(q, k, v, do, cq, ck, causal)
    got = _port(q, k, v, do, cq, ck, causal)
    for g, w in zip(got[1:], want):
        _close(g, w, GRAD_TOL)


def test_rows_that_see_no_key_match_pallas_interpret():
    """The rows of an empty k segment read exactly 0 with lse -1e30 and
    zero gradients, as in the Pallas kernel; every other row and every
    gradient matches it."""
    (q, k, v, do), cq, ck, causal = _inputs(NO_KEY, 5)
    ref = np.asarray(_pallas(q, k, v, cq, ck, causal))
    want = _pallas_grads(q, k, v, do, cq, ck, causal)
    got = _port(q, k, v, do, cq, ck, causal)
    rows = slice(40, 128)  # q segment 1
    assert np.all(got[0][rows] == 0) and np.all(got[1][rows] == 0)
    _, lse = pfv.flash_varlen_fwd(*(torch.from_numpy(a) for a in
                                    (q, k, v, cq, ck)), causal)
    assert torch.all(lse[:, rows] == pfv.NO_KEY_LSE)
    assert torch.all(lse[:, :40] > -1e29)
    _close(got[0], ref, OUT_TOL)
    for g, w in zip(got[1:], want):
        _close(g, w, GRAD_TOL)


def test_no_key_gradients_are_zero():
    """NO_KEY's gradients through the public API are exactly 0 where no
    pair is kept: dq on the rows of q segment 1, whose k segment is
    empty; dk and dv on the keys that no row sees (causal keys 40-99 of
    k segment 0, past its 40 rows, and the k tail, a segment of its own
    with no q rows). The rows and keys that do see each other have
    gradients."""
    (q, k, v, do), cq, ck, causal = _inputs(NO_KEY, 19)
    _, dq, dk, dv = _port(q, k, v, do, cq, ck, causal)
    assert np.all(dq[40:] == 0) and np.abs(dq[:40]).sum() > 0
    for g in (dk, dv):
        assert np.all(g[40:] == 0) and np.abs(g[:40]).sum() > 0


@pytest.mark.parametrize("name", ["noncausal", "gqa", "cu_q_ne_k", "tail",
                                  "tiny_docs"])
def test_public_api_matches_jax_public_api(name):
    """Forward and dq/dk/dv against the JAX package's public
    ``flash_attn_unpadded`` (its segment-masked XLA path off the TPU)."""
    (q, k, v, do), cq, ck, causal = _inputs(CASES[name], 7 + len(name))
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    out, _ = F.flash_attn_unpadded(*ts, paddle.to_tensor(cq),
                                   paddle.to_tensor(ck), causal=causal)
    (out * paddle.to_tensor(do)).sum().backward()
    want = [out.numpy()] + [t.grad.numpy() for t in ts]
    got = _port(q, k, v, do, cq, ck, causal)
    _close(got[0], want[0], OUT_TOL)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, GRAD_TOL)


def test_bf16_matches_pallas_interpret():
    """bf16: the Pallas kernel rounds p to bf16 before p v while the
    plain version stays in float32, and both cast the output to bf16, so
    out is held within 2^-6 of max|out| (the dense flash test's bound)."""
    (q, k, v, _), cq, ck, causal = _inputs(CASES["gqa"], 11)
    ref = _pallas(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                  cq, ck, causal)
    out, _ = pfv.flash_varlen_fwd(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        torch.from_numpy(cq), torch.from_numpy(ck), causal)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 2.0 ** -6 * np.abs(ref).max(), err


@pytest.mark.parametrize("lens,total", [([5, 9, 3], 17), ([4, 0, 6], 12),
                                        ([3, 3], 9), ([], 4)])
def test_segments_match_the_reference(lens, total):
    cu = _cu(lens)
    seg, loc = pfv.segments(torch.from_numpy(cu), total)
    jseg, jloc = jfv._segments(jnp.asarray(cu), total)
    assert seg.tolist() == np.asarray(jseg).tolist()
    assert loc.tolist() == np.asarray(jloc).tolist()


def test_each_document_is_dense_causal_attention():
    """Packed documents equal the port's dense flash attention run on
    each document alone (top-left causal is bottom-right for a square
    document)."""
    lens = [30, 1, 64, 17]
    (q, k, v, _), cq, ck, _ = _inputs((lens, None, 112, 112, 4, 2, 64,
                                       True), 13)
    out, _ = PF.flash_attn_unpadded(*(torch.from_numpy(a) for a in
                                      (q, k, v, cq, ck)), causal=True)
    for a, b in zip(cq[:-1], cq[1:]):
        want, _ = PF.flash_attention(*(torch.from_numpy(x[a:b])[None]
                                       for x in (q, k, v)), causal=True)
        _close(out[a:b].numpy(), want[0].numpy(), 1e-6)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    from paddle_tpu_torch.ops.kernels import _build

    (q, k, v, do), cq, ck, causal = _inputs(CASES["cu_q_ne_k"], 17)
    q, k, v, do, cq, ck = (torch.from_numpy(a) for a in (q, k, v, do, cq,
                                                         ck))
    kernel_launch_stats(reset=True)
    out, lse = pfv.flash_varlen_fwd(q, k, v, cq, ck, causal)
    ref_out, ref_lse = pfv.flash_varlen_fwd_plain(q, k, v, cq, ck, causal)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    got = pfv.flash_varlen_bwd(q, k, v, out, lse, do, cq, ck, causal)
    delta = pfv._delta(do, out)
    want = (pfv.flash_varlen_bwd_dq_plain(q, k, v, do, lse, delta, cq, ck,
                                          causal),
            *pfv.flash_varlen_bwd_dkdv_plain(q, k, v, do, lse, delta, cq,
                                             ck, causal))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel_launch_stats() == {}
    assert _build._lib is None


def test_dropout_raises_and_the_alias_is_the_same_function():
    x = torch.zeros(8, 2, 64)
    cu = torch.tensor([0, 8], dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        PF.flash_attn_unpadded(x, x, x, cu, cu, dropout=0.1)
    assert PF.flash_attn_varlen_func is PF.flash_attn_unpadded
    out, _ = PF.flash_attn_unpadded(x, x, x, cu, cu, dropout=0.1,
                                    training=False)
    assert tuple(out.shape) == (8, 2, 64)


@pytest.mark.parametrize("cu", [[0, 5, 3], [-1, 8], [[0, 8]]],
                         ids=["decreasing", "negative", "two_dims"])
def test_host_boundaries_are_checked(cu):
    x = torch.zeros(8, 2, 64)
    with pytest.raises(ValueError, match="cu_seqlens"):
        PF.flash_attn_unpadded(x, x, x, torch.tensor(cu),
                               torch.tensor([0, 8]))
