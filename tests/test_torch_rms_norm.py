"""Parity of the PyTorch port's rms_norm with the JAX package's.

The JAX side runs its Pallas kernel in interpret mode
(FLAGS_pallas_interpret, as tests/test_norm_kernels_pallas.py does) and
its plain ``_rms_ref``; the port's wrapper, handed CPU tensors, runs its
plain version (the CUDA kernel is held against the same plain version on
the card by chip_smoke.py). Inputs come from numpy with a seed.

Tolerances: float32 at 1e-6 (same float32 arithmetic, another summation
order); bfloat16 at one bf16 spacing of the value (both compute in
float32 and cast once, so they may differ only where the cast rounds a
float32 difference across a boundary).
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn.functional import rms_norm as port_functional
from paddle_tpu_torch.ops.kernels import kernel_launch_stats
from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm, rms_norm_plain

rn = importlib.import_module("paddle_tpu.ops.kernels.rms_norm")

BF16_ULP = 2.0 ** -7


@pytest.fixture()
def interp_flag():
    paddle.set_flags({"FLAGS_pallas_interpret": True})
    yield
    paddle.set_flags({"FLAGS_pallas_interpret": False})


def _np(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 1.5 + 0.3).astype(np.float32)


def _jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _close_bf16(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.all(np.abs(got - want) <= np.abs(want) * BF16_ULP + 1e-6), \
        np.abs(got - want).max()


@pytest.mark.parametrize("shape", [(4, 6, 256), (8, 128), (1, 512)])
@pytest.mark.parametrize("with_weight", [True, False])
def test_fp32_matches_pallas_interpret(interp_flag, shape, with_weight):
    x = _np(shape, 0)
    w = _np(shape[-1:], 1) if with_weight else None
    want = rn.rms_norm(_jax(x, jnp.float32),
                       None if w is None else _jax(w, jnp.float32), 1e-5)
    got = rms_norm(_torch(x, torch.float32),
                   None if w is None else _torch(w, torch.float32), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


def test_fp32_matches_reference_formula():
    x, w = _np((3, 5, 256), 2), _np((256,), 3)
    want = rn._rms_ref(_jax(x, jnp.float32), _jax(w, jnp.float32), 1e-6)
    got = rms_norm(_torch(x, torch.float32), _torch(w, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 6, 256), (16, 4096)])
def test_bf16_within_one_ulp(interp_flag, shape):
    x, w = _np(shape, 4), _np(shape[-1:], 5)
    want = rn.rms_norm(_jax(x, jnp.bfloat16), _jax(w, jnp.bfloat16), 1e-5)
    got = rms_norm(_torch(x, torch.bfloat16), _torch(w, torch.bfloat16),
                   1e-5)
    assert got.dtype == torch.bfloat16
    _close_bf16(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("width", [100, 200, 4098])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_width_not_multiple_of_128(width, dtype):
    """The reference leaves its Pallas path below 128-multiples; the port
    takes any width. Held against the reference formula."""
    x, w = _np((5, width), 6), _np((width,), 7)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(rn._rms_ref(_jax(x, jd), _jax(w, jd), 1e-6),
                      np.float32)
    got = rms_norm(_torch(x, td), _torch(w, td)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        _close_bf16(got, want)


def test_weight_multiplies_before_the_cast():
    """The reference multiplies by the weight in float32 and casts once;
    casting the normalized row first and multiplying in bf16 rounds
    twice. These inputs tell the two orders apart."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(1, 8), dtype=torch.bfloat16)
    w = torch.tensor(1 + 0.05 * rng.randn(8), dtype=torch.bfloat16)
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    once = (normed * w.float()).to(torch.bfloat16)
    twice = normed.to(torch.bfloat16) * w
    assert not torch.equal(once, twice)
    assert torch.equal(rms_norm(x, w), once)


def test_layer_and_functional_match_jax_layer():
    from paddle_tpu.nn import RMSNorm as JaxRMSNorm

    x, w = _np((2, 3, 64), 8), _np((64,), 9)
    jl = JaxRMSNorm(64, epsilon=1e-5)
    jl.weight.set_value(w)
    want = np.asarray(jl(paddle.to_tensor(x))._data)
    tl = RMSNorm(64, epsilon=1e-5, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        port_functional(torch.from_numpy(x), torch.from_numpy(w),
                        1e-5).numpy(), want, atol=1e-6, rtol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    from paddle_tpu_torch.ops.kernels import _build

    kernel_launch_stats(reset=True)
    x = torch.from_numpy(_np((4, 96), 10))
    assert torch.equal(rms_norm(x), rms_norm_plain(x))
    assert kernel_launch_stats() == {}
    assert _build._lib is None  # nothing was built or loaded
