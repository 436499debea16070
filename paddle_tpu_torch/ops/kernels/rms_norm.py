"""RMSNorm and LayerNorm forward: CUDA kernels for Hopper and their plain
PyTorch versions (the counterpart of the reference's
``ops/kernels/rms_norm.py``; the kernels replace its Pallas
``_rms_kernel`` and ``_ln_kernel``).

``rms_norm`` dispatches on the tensor's device: a CPU tensor takes
:func:`rms_norm_plain`, a CUDA tensor launches ``csrc/rms_norm.cu`` or
raises. Unlike the reference, which takes its Pallas path only when the
width is a multiple of 128, the kernel takes any width: the wrapper
hands it the launch plan of :func:`norm_launch_plan` (a warp or a block
per row holding the row in registers, or the scalar path).

The gradient is ``_RMSNormFn``: its forward is the same dispatch, its
backward the closed form of the reference's ``_rms_bwd`` (the XLA vjp of
``_rms_ref``, not a Pallas kernel) in float32 torch code, with one cast
each for dx and dw. ``layer_norm_fused`` is built the same way: its
forward dispatches between ``csrc/rms_norm.cu``'s LayerNorm kernel and
:func:`layer_norm_plain` (the reference's ``_ln_ref``; any width, where
the reference's Pallas path needs a multiple of 128), and
``_LayerNormFn``'s backward is the closed form of the reference's
``_ln_bwd`` (an XLA vjp of ``_ln_ref``) in float32 torch code.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build, program_op, record_launch

# csrc/rms_norm.cu's instantiations: VPL (16-byte vectors a lane holds)
# of each class, the rows (warps) of a warp-class block, the widest
# block class and the scalar path's threads
WARP_VPL = (1, 2, 3, 4)
BLOCK_VPL = (3, 4)
WARP_ROWS = 8
BLOCK_MAX_THREADS = 512
SCALAR_THREADS = 256
_KIND_CODES = {"scalar": 0, "warp": 1, "block": 2}


class NormPlan(NamedTuple):
    """How ``csrc/rms_norm.cu`` lays a row on its threads. ``kind``:
    ``"warp"`` (a warp per row, ``rows_per_block`` rows a block),
    ``"block"`` (a block of ``threads`` per row) or ``"scalar"``
    (``threads`` per row, element loads strided by ``threads``). In the
    two vector classes lane t of ``threads`` holds the row's 16-byte
    vectors j * threads + t for j < ``vpl``; ``vpl`` is 0 for scalar."""
    kind: str
    vpl: int
    threads: int
    rows_per_block: int


@functools.lru_cache(maxsize=256)
def norm_launch_plan(hidden, dtype, aligned):
    """The plan for rows of ``hidden`` elements of ``dtype``
    (``torch.float32`` or ``torch.bfloat16``); ``aligned``: x, y and the
    weight and bias all start on 16 bytes. A row of up to 128 vectors
    takes a warp, a wider one up to 4 x 512 vectors a block; the rest
    (a width that is not a whole number of vectors, a pointer off 16
    bytes, a wider row) the scalar path."""
    per_vec = 16 // dtype.itemsize
    nv = hidden // per_vec
    if (not aligned or hidden % per_vec or hidden <= 0
            or nv > 4 * BLOCK_MAX_THREADS):
        return NormPlan("scalar", 0, SCALAR_THREADS, 1)
    if nv <= 4 * 32:
        return NormPlan("warp", _cdiv(nv, 32), 32, WARP_ROWS)
    threads = 32 * _cdiv(_cdiv(nv, 4), 32)
    return NormPlan("block", _cdiv(nv, threads), threads, 1)


def _cdiv(a, b):
    return -(-a // b)


def _plan_args(x2, *params):
    """The C entries' plan arguments for the contiguous [rows, hidden]
    x2 and its row parameters (None or tensors); y is a fresh tensor,
    16-byte aligned."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, *params)
                  if t is not None)
    plan = norm_launch_plan(x2.shape[1], x2.dtype, aligned)
    return (_KIND_CODES[plan.kind], plan.vpl, plan.threads,
            plan.rows_per_block)


def rms_norm_plain(x, weight=None, eps=1e-6):
    """Reference arithmetic in float32: ``x * rsqrt(mean(x^2) + eps)``,
    times the weight, then one cast back to ``x``'s dtype (the weight
    multiply happens before the cast, as in the reference)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def _row_param(name, what, t, x):
    """``t`` checked against x's dtype, device and width, contiguous (or
    None)."""
    if t is None:
        return None
    h = x.shape[-1]
    if t.device != x.device or t.dtype != x.dtype:
        raise TypeError(f"{name}: {what} must be {x.dtype} on {x.device}, "
                        f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != (h,):
        raise ValueError(
            f"{name}: {what} shape {tuple(t.shape)} != ({h},)")
    return t.contiguous()


def _rms_norm_cuda(x, weight, eps):
    h = x.shape[-1]
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rms_norm: unsupported dtype {x.dtype}")
    weight = _row_param("rms_norm", "weight", weight, x)
    x2 = x.reshape(-1, h).contiguous()
    y = torch.empty_like(x2)
    if x2.numel():
        lib = _build.library()
        status = lib.ptt_rms_norm(
            x2.data_ptr(),
            weight.data_ptr() if weight is not None else None,
            y.data_ptr(), x2.shape[0], h, float(eps),
            _build.DTYPE_CODES[x.dtype], *_plan_args(x2, weight),
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(status, "rms_norm")
        record_launch("rms_norm", (x2, weight), (y,))
    return y.reshape(x.shape)


@program_op("rms_norm", rms_norm_plain)
def _rms_norm_fwd(x, weight, eps):
    if x.device.type == "cuda":
        return _rms_norm_cuda(x, weight, eps)
    if x.device.type != "cpu":
        raise RuntimeError(f"rms_norm: unsupported device {x.device}")
    return rms_norm_plain(x, weight, eps)


def rms_norm_bwd(x, weight, g, eps):
    """(dx, dw) of ``rms_norm`` at x for the cotangent g, in float32 and
    cast once each: with xhat = x * r, r = rsqrt(mean(x^2) + eps) and
    gw = g * w, dx = r * (gw - xhat * mean(gw * xhat)) and
    dw = sum over rows of g * xhat. dw is None without a weight."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gf = g.float()
    gw = gf * weight.float() if weight is not None else gf
    dx = r * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = None
    if weight is not None:
        dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(0).to(weight.dtype)
    return dx.to(x.dtype), dw


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, g, ctx.eps)
        return dx, dw, None


def rms_norm(x, weight=None, eps=1e-6):
    """RMSNorm over the last axis. x: [..., H], weight: [H] or None.
    Differentiable in x and weight when autograd records."""
    if torch.is_grad_enabled() and (
            x.requires_grad or (weight is not None and weight.requires_grad)):
        return _RMSNormFn.apply(x, weight, eps)
    return _rms_norm_fwd(x, weight, eps)


# ----------------------------------------------------------- LayerNorm
def layer_norm_plain(x, weight=None, bias=None, eps=1e-5):
    """Reference arithmetic in float32 (``_ln_ref``): ``(x - mean) *
    rsqrt(var + eps)``, times the weight, plus the bias, then one cast
    back to ``x``'s dtype."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _layer_norm_cuda(x, weight, bias, eps):
    h = x.shape[-1]
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"layer_norm_fused: unsupported dtype {x.dtype}")
    weight = _row_param("layer_norm_fused", "weight", weight, x)
    bias = _row_param("layer_norm_fused", "bias", bias, x)
    x2 = x.reshape(-1, h).contiguous()
    y = torch.empty_like(x2)
    if x2.numel():
        status = _build.library().ptt_layer_norm(
            x2.data_ptr(),
            weight.data_ptr() if weight is not None else None,
            bias.data_ptr() if bias is not None else None,
            y.data_ptr(), x2.shape[0], h, float(eps),
            _build.DTYPE_CODES[x.dtype], *_plan_args(x2, weight, bias),
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(status, "layer_norm_fused")
        record_launch("layer_norm_fused", (x2, weight, bias), (y,))
    return y.reshape(x.shape)


@program_op("layer_norm_fused", layer_norm_plain)
def _layer_norm_fwd(x, weight, bias, eps):
    if x.device.type == "cuda":
        return _layer_norm_cuda(x, weight, bias, eps)
    if x.device.type != "cpu":
        raise RuntimeError(
            f"layer_norm_fused: unsupported device {x.device}")
    return layer_norm_plain(x, weight, bias, eps)


def layer_norm_bwd(x, weight, bias, g, eps):
    """(dx, dw, db) of ``layer_norm_fused`` at x for the cotangent g, in
    float32 and cast once each: with xhat = (x - mean) * r, r =
    rsqrt(var + eps) and gw = g * w, dx = r * (gw - mean(gw) - xhat *
    mean(gw * xhat)), dw = sum over rows of g * xhat, db = sum over rows
    of g. dw (db) is None without a weight (bias)."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    r = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * r
    gf = g.float()
    gw = gf * weight.float() if weight is not None else gf
    dx = r * (gw - gw.mean(dim=-1, keepdim=True)
              - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    h = x.shape[-1]
    dw = db = None
    if weight is not None:
        dw = (gf * xhat).reshape(-1, h).sum(0).to(weight.dtype)
    if bias is not None:
        db = gf.reshape(-1, h).sum(0).to(bias.dtype)
    return dx.to(x.dtype), dw, db


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _layer_norm_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x, weight, bias, g, ctx.eps)
        return dx, dw, db, None


def layer_norm_fused(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the last axis. x: [..., H], weight and bias: [H] or
    None. Differentiable in x, weight and bias when autograd records."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _LayerNormFn.apply(x, weight, bias, eps)
    return _layer_norm_fwd(x, weight, bias, eps)
