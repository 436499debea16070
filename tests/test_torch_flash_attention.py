"""Parity of the PyTorch port's flash attention with the JAX package's.

The JAX side runs its Pallas kernels in interpret mode
(``_flash_fwd_pallas`` / ``_flash_bwd_pallas`` with ``interpret=True``,
as tests/test_flash_pallas.py runs them) on (B*H, S, D) arrays, and its
public ``flash_attention`` through ``jax.vjp`` (off the TPU that takes
its XLA reference path). The port's wrappers, handed CPU tensors, run
their plain versions in the public [B, S, H, D] layout (the CUDA kernels
are held against the same plain versions on the card by chip_smoke.py).
Inputs come from numpy with a seed.

Tolerances, each a fraction of the largest |value| of the tensor
compared: float32 out and lse within 2e-5, gradients within 5e-5 (the
same float32 arithmetic blocked differently; the bounds of
tests/test_flash_pallas.py). bf16: the Pallas kernel rounds p (and ds)
to bf16 before its products while the plain versions stay in float32,
so out is held within 2^-6 of max|out| and each gradient within 2^-5 of
its max (one bf16 rounding of p is 2^-9 relative; the sums and the
final bf16 cast add a few spacings). Rows that see no key are left out
of the comparison, as tests/test_flash_pallas.py does: the port defines
them as out = 0 and lse = -1e30.
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu_torch.nn.functional import flash_attention as port_functional
from paddle_tpu_torch.ops.kernels import kernel_launch_stats

fa = importlib.import_module("paddle_tpu.ops.kernels.flash_attention")
pf = importlib.import_module("paddle_tpu_torch.ops.kernels.flash_attention")

BLOCK = 128
TOL = {"float32": {"out": 2e-5, "lse": 2e-5, "grad": 5e-5},
       "bfloat16": {"out": 2.0 ** -6, "lse": 2e-5, "grad": 2.0 ** -5}}


def _np(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(
        np.float32)


def _case(b, sq, sk, h, kvh, d, seed=0):
    return (_np((b, sq, h, d), seed), _np((b, sk, kvh, d), seed + 1),
            _np((b, sk, kvh, d), seed + 2), _np((b, sq, h, d), seed + 3))


def _to3(a):
    """[B, S, H, D] -> (B*H, S, D), the reference kernels' layout."""
    b, s, h, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _from3(a, b):
    bh, s, d = a.shape
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).reshape(
        b, bh // b, s, d).transpose(0, 2, 1, 3)


def _jd(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _td(dtype):
    return getattr(torch, dtype)


def _t(a, dtype):
    return torch.from_numpy(a).to(_td(dtype))


def _f(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel, mask=None):
    got, want = _f(got), _f(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * max(top, 1e-6), \
        (np.abs(got - want).max(), top)


CASES = {
    # name: (B, Sq, Sk, H, KVH, D, causal, window)
    "causal": (1, 256, 256, 2, 2, 64, True, 0),
    "noncausal": (1, 128, 256, 2, 2, 128, False, 0),
    "gqa2_d128": (1, 128, 128, 4, 2, 128, True, 0),
    "gqa3_odd": (1, 128, 128, 6, 2, 64, True, 0),
    "rect_offset": (1, 128, 256, 2, 1, 64, True, 0),
    "window": (1, 256, 256, 2, 1, 64, True, 96),
}


def _fwd_pair(name, dtype):
    b, sq, sk, h, kvh, d, causal, window = CASES[name]
    q, k, v, do = _case(b, sq, sk, h, kvh, d, seed=len(name))
    jd = _jd(dtype)
    scale = d ** -0.5
    ref_out, ref_lse = fa._flash_fwd_pallas(
        jnp.asarray(_to3(q)).astype(jd), jnp.asarray(_to3(k)).astype(jd),
        jnp.asarray(_to3(v)).astype(jd), causal, scale, BLOCK, BLOCK,
        interpret=True, window=window)
    out, lse = pf.flash_attention_fwd(_t(q, dtype), _t(k, dtype),
                                      _t(v, dtype), causal, scale, window)
    return (q, k, v, do), (ref_out, ref_lse), (out, lse), CASES[name]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_fwd_matches_pallas_interpret(name, dtype):
    _, (ref_out, ref_lse), (out, lse), (b, *_) = _fwd_pair(name, dtype)
    assert out.dtype == _td(dtype) and lse.dtype == torch.float32
    _close(out, _from3(ref_out, b), TOL[dtype]["out"])
    _close(lse, np.asarray(ref_lse).reshape(lse.shape), TOL[dtype]["lse"])


def _bwd_pair(name, dtype, dlse=False):
    b, sq, sk, h, kvh, d, causal, window = CASES[name]
    q, k, v, do = _case(b, sq, sk, h, kvh, d, seed=len(name) + 10)
    jd = _jd(dtype)
    scale = d ** -0.5
    j = [jnp.asarray(_to3(a)).astype(jd) for a in (q, k, v, do)]
    # both backward versions start from the reference forward
    out3, lse3 = fa._flash_fwd_ref(j[0], j[1], j[2], causal, scale,
                                   window=window)
    dl = _np((b, h, sq), 99) * 0.1 if dlse else None
    rq, rk, rv = fa._flash_bwd_pallas(
        j[0], j[1], j[2], out3, lse3, j[3], causal, scale, BLOCK, BLOCK,
        dlse=None if dl is None else jnp.asarray(dl.reshape(b * h, sq)),
        interpret=True, window=window)
    out = _t(_from3(out3, b), dtype)
    lse = torch.from_numpy(np.asarray(lse3).reshape(b, h, sq))
    got = pf.flash_attention_bwd(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), out, lse, _t(do, dtype),
        causal, scale, window,
        dlse=None if dl is None else torch.from_numpy(dl))
    return got, (_from3(rq, b), _from3(rk, b), _from3(rv, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_bwd_matches_pallas_interpret(name, dtype):
    got, want = _bwd_pair(name, dtype)
    for g, w in zip(got, want):
        assert g.dtype == _td(dtype)
        _close(g, w, TOL[dtype]["grad"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_with_dlse_matches_pallas_interpret(dtype):
    got, want = _bwd_pair("gqa3_odd", dtype, dlse=True)
    for g, w in zip(got, want):
        _close(g, w, TOL[dtype]["grad"])


def test_rows_that_see_no_key_are_zero():
    """Causal with Sq > Sk: rows q < Sq - Sk see no key. The port
    returns out = 0, lse = -1e30 and zero gradients there; the other rows
    match the Pallas kernel."""
    b, sq, sk, h, d = 1, 256, 128, 2, 64
    q, k, v, do = _case(b, sq, sk, h, h, d, seed=7)
    ref_out, _ = fa._flash_fwd_pallas(
        jnp.asarray(_to3(q)), jnp.asarray(_to3(k)), jnp.asarray(_to3(v)),
        True, 0.125, BLOCK, BLOCK, interpret=True)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = pf.flash_attention_with_lse(qt, kt, vt, causal=True,
                                           sm_scale=0.125)
    cut = sq - sk
    assert torch.all(out[:, :cut] == 0)
    assert torch.all(lse[:, :, :cut] == pf.NO_KEY_LSE)
    _close(out[:, cut:], _from3(ref_out, b)[:, cut:], 2e-5)
    (out * torch.from_numpy(do)).sum().backward()
    assert torch.all(qt.grad[:, :cut] == 0)
    assert torch.isfinite(kt.grad).all() and torch.isfinite(vt.grad).all()


@pytest.mark.parametrize("window", [0, 48])
def test_autograd_matches_jax_vjp_of_public_api(window):
    """The port's autograd Function against jax.vjp of the reference's
    public flash_attention (custom_vjp), GQA 3:1, D 64."""
    b, s, h, kvh, d = 2, 64, 3, 1, 64
    q, k, v, do = _case(b, s, s, h, kvh, d, seed=window)
    out, vjp = jax.vjp(
        lambda a, b_, c: fa.flash_attention(a, b_, c, causal=True,
                                            window=window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got, _ = port_functional(*ts, causal=True, window=window)
    _close(got, out, 2e-5)
    got.backward(torch.from_numpy(do))
    for t, w in zip(ts, want):
        _close(t.grad, w, 5e-5)


def test_with_lse_backward_takes_dlse_like_jax():
    b, s, h, d = 1, 64, 2, 64
    q, k, v, _ = _case(b, s, s, h, h, d, seed=3)

    def jloss(a, b_, c):
        o, lse = fa.flash_attention_with_lse(a, b_, c, causal=True)
        return jnp.sum(o ** 2) + jnp.sum(lse * 0.1)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = pf.flash_attention_with_lse(*ts, causal=True)
    ((o ** 2).sum() + (lse * 0.1).sum()).backward()
    for t, w in zip(ts, want):
        _close(t.grad, w, 5e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    from paddle_tpu_torch.ops.kernels import _build

    kernel_launch_stats(reset=True)
    q, k, v, do = (torch.from_numpy(a) for a in _case(1, 32, 32, 2, 1, 64))
    out, lse = pf.flash_attention_fwd(q, k, v, True)
    ref_out, ref_lse = pf.flash_attention_fwd_plain(q, k, v, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    got = pf.flash_attention_bwd(q, k, v, out, lse, do, True)
    want = pf.flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel_launch_stats() == {}
    assert _build._lib is None


def test_window_needs_causal_and_dropout_raises():
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="causal"):
        pf.flash_attention(x, x, x, causal=False, window=4)
    with pytest.raises(NotImplementedError):
        port_functional(x, x, x, dropout=0.1)
