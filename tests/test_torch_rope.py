"""The gradient of the port's RoPE against ``jax.vjp`` of the reference's
``apply_rotary_emb``. The rotation is linear in x and plain tensor code
on both sides, so torch autograd through the forward is the whole
backward; these tests pin that it matches.

Tolerances: float32 within 1e-6 absolute (the same two products and one
add per element, which XLA may fuse into one multiply-add); bfloat16
within one bf16 spacing (2^-7) of the largest gradient entry, since both
sides round the float32 result to bf16 once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.ops.kernels import rope as jax_rope

import torch

from paddle_tpu_torch.ops.kernels import rope

B, S, H, D = 2, 12, 3, 16


def _position_ids(kind, rng):
    if kind == "none":
        return None
    if kind == "1d":
        return rng.permutation(S + 4)[:S].astype(np.int64)
    return rng.randint(0, S + 4, size=(B, S)).astype(np.int64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positions", ["none", "1d", "2d"])
def test_rope_grad_matches_jax_vjp(positions, dtype):
    rng = np.random.RandomState(11)
    x = rng.randn(B, S, H, D).astype(np.float32)
    g = rng.randn(B, S, H, D).astype(np.float32)
    pos = _position_ids(positions, rng)
    theta = 1e6

    jdt = jnp.dtype(dtype)
    jcos, jsin = jax_rope.build_rope_cache(S + 4, D, base=theta)
    jpos = None if pos is None else jnp.asarray(pos)
    out_j, vjp = jax.vjp(
        lambda a: jax_rope.apply_rotary_emb(a, jcos, jsin, jpos),
        jnp.asarray(x, dtype=jdt))
    (dx_j,) = vjp(jnp.asarray(g, dtype=jdt))

    tdt = getattr(torch, dtype)
    cos, sin = rope.build_rope_cache(S + 4, D, base=theta)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out_t = rope.apply_rotary_emb(
        xt, cos, sin, None if pos is None else torch.from_numpy(pos))
    out_t.backward(torch.from_numpy(g).to(tdt))

    dx_t = xt.grad.float().numpy()
    dx_ref = np.asarray(dx_j.astype(jnp.float32))
    out_ref = np.asarray(out_j.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out_t.detach().numpy(), out_ref,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(dx_t, dx_ref, rtol=0, atol=1e-6)
    else:
        top = np.abs(dx_ref).max()
        assert np.abs(dx_t - dx_ref).max() <= 2.0 ** -7 * top
        top = np.abs(out_ref).max()
        assert np.abs(out_t.detach().float().numpy() - out_ref).max() \
            <= 2.0 ** -7 * top
