"""Parity of the PyTorch port's ``layer_norm_fused`` with the JAX
package's, forward and gradients.

The JAX side runs its Pallas ``_ln_kernel`` in interpret mode
(``FLAGS_pallas_interpret=True``, as tests/test_norm_kernels_pallas.py
sets it) where the width is a multiple of 128, and its ``_ln_ref`` path
at another width; its gradients come through the ``custom_vjp`` (the
XLA vjp of ``_ln_ref``). The port, handed CPU tensors, runs the plain
version forward and ``_LayerNormFn``'s closed-form backward (the CUDA
kernel is held against the same plain version on the card by
chip_smoke.py). Inputs come from numpy with a seed.

Tolerances: float32 output within 1e-5 and gradients within 1e-4
(absolute and relative; the same float32 arithmetic, reduced in another
order, and the closed-form backward against autodiff's). bf16 output
within one bf16 spacing of the reference (2^-7 relative, both round one
float32 value to bf16, which may land on either side of a tie).
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.ops.kernels import (kernel_launch_stats,
                                          layer_norm_fused,
                                          layer_norm_plain)

rn = importlib.import_module("paddle_tpu.ops.kernels.rms_norm")

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture()
def interpret():
    from paddle_tpu.ops.kernels import kernel_dispatch_stats

    paddle.set_flags({"FLAGS_pallas_interpret": True})
    kernel_dispatch_stats(reset=True)
    yield kernel_dispatch_stats
    paddle.set_flags({"FLAGS_pallas_interpret": False})


def _np(shape, seed, scale=1.5, shift=0.3):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale + shift).astype("float32")


def _inputs(h, has_w, has_b, rows=(3, 8)):
    x = _np(rows + (h,), 0)
    w = _np((h,), 1, 0.2, 1.0) if has_w else None
    b = _np((h,), 2, 0.2, 0.0) if has_b else None
    g = _np(rows + (h,), 3, 1.0, 0.0)
    return x, w, b, g


def _jax_fwd_vjp(x, w, b, g):
    """The JAX output and (dx, dw, db) through its custom VJP."""
    args = [jnp.asarray(a) for a in (x, w, b) if a is not None]

    def f(*aa):
        it = iter(aa)
        xx = next(it)
        ww = next(it) if w is not None else None
        bb = next(it) if b is not None else None
        return rn.layer_norm_fused(xx, ww, bb)

    y, vjp = jax.vjp(f, *args)
    grads = iter(vjp(jnp.asarray(g)))
    return np.asarray(y), [np.asarray(next(grads)) if a is not None
                           else None for a in (x, w, b)]


def _port_fwd_grads(x, w, b, g):
    ts = [torch.from_numpy(a).requires_grad_() if a is not None else None
          for a in (x, w, b)]
    y = layer_norm_fused(*ts)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), [t.grad.numpy() if t is not None else None
                                for t in ts]


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


AFFINE = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("has_w,has_b", AFFINE)
def test_matches_pallas_interpret(interpret, has_w, has_b):
    x, w, b, g = _inputs(256, has_w, has_b)
    want_y, want_g = _jax_fwd_vjp(x, w, b, g)
    assert interpret(reset=True).get("layer_norm_fused:pallas", 0) >= 1
    got_y, got_g = _port_fwd_grads(x, w, b, g)
    _close(got_y, want_y, FWD_TOL)
    for a, r in zip(got_g, want_g):
        assert (a is None) == (r is None)
        if a is not None:
            _close(a, r, GRAD_TOL)


@pytest.mark.parametrize("has_w,has_b", AFFINE)
def test_matches_reference_path_at_a_width_off_the_tiling(has_w, has_b):
    from paddle_tpu.ops.kernels import kernel_dispatch_stats

    x, w, b, g = _inputs(200, has_w, has_b, rows=(5, 4))
    kernel_dispatch_stats(reset=True)
    want_y, want_g = _jax_fwd_vjp(x, w, b, g)
    assert kernel_dispatch_stats(reset=True).get(
        "layer_norm_fused:xla_fallback", 0) >= 1
    got_y, got_g = _port_fwd_grads(x, w, b, g)
    _close(got_y, want_y, FWD_TOL)
    for a, r in zip(got_g, want_g):
        if a is not None:
            _close(a, r, GRAD_TOL)


def test_bf16_matches_pallas_interpret(interpret):
    x, w, b, _ = _inputs(128, True, True, rows=(16,))
    want = np.asarray(rn.layer_norm_fused(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b))
    ).astype(jnp.float32))
    got = layer_norm_fused(*(torch.from_numpy(a).to(torch.bfloat16)
                             for a in (x, w, b)))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= np.abs(want) * 2.0 ** -7 + 1e-5), err.max()


def test_eps_default_and_cpu_dispatch_launch_nothing():
    from paddle_tpu_torch.ops.kernels import _build

    x = torch.from_numpy(_np((4, 96), 5, 1e-3, 0.0))
    kernel_launch_stats(reset=True)
    y = layer_norm_fused(x)
    assert torch.equal(y, layer_norm_plain(x, eps=1e-5))
    assert not torch.equal(y, layer_norm_plain(x, eps=1e-6))
    assert kernel_launch_stats() == {}
    assert _build._lib is None


def test_no_grad_path_skips_autograd():
    x = torch.from_numpy(_np((2, 64), 6)).requires_grad_()
    with torch.no_grad():
        y = layer_norm_fused(x)
    assert y.grad_fn is None
    assert layer_norm_fused(x).grad_fn is not None


# the widths the port's kernel takes on the main path: GPT-2's 768 (the
# warp class), Qwen2-0.5B's 896 (warp, tail masked), 4096 (the block
# class) and 1000 (125 vectors: the warp class's masked tail)
@pytest.mark.parametrize("width", [768, 896, 4096, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_main_path_widths_match_jax(interpret, width, dtype):
    """At 768, 896 and 4096 the JAX side runs its Pallas ``_ln_kernel``
    in interpret mode. 1000 is not a multiple of 128, so there the JAX
    package itself takes ``_ln_ref`` (its width test at
    ``rms_norm.py:163``); the port takes any width. float32 within
    FWD_TOL, bf16 within one bf16 spacing, as above."""
    x, w, b, _ = _inputs(width, True, True, rows=(5,))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    interpret(reset=True)
    want = np.asarray(rn.layer_norm_fused(
        *(jnp.asarray(a).astype(jd) for a in (x, w, b))).astype(jnp.float32))
    route = "pallas" if width % 128 == 0 else "xla_fallback"
    assert interpret(reset=True).get(f"layer_norm_fused:{route}", 0) >= 1
    got = layer_norm_fused(*(torch.from_numpy(a).to(td) for a in (x, w, b)))
    assert got.dtype == td
    if dtype == "float32":
        _close(got.numpy(), want, FWD_TOL)
    else:
        err = np.abs(got.float().numpy() - want)
        assert np.all(err <= np.abs(want) * 2.0 ** -7 + 1e-5), err.max()
