"""Gradient clipping of the port (counterpart of the reference's
``nn/clip.py``), with its arithmetic: norms are summed in float32, the
scale is ``min(clip_norm / max(norm, 1e-12), 1)`` in float32, and a
clipped gradient is ``(g.float() * scale)`` cast back to ``g.dtype``.

A clip takes ``[(param, grad)]`` and returns new pairs; the gradients
it was given are left as they are. A parameter whose ``need_clip``
attribute is False is passed through untouched by every clip (the
reference's ``ClipGradByNorm`` and ``ClipGradByValue`` clip it anyway;
upstream Paddle's do not). ``clip_grad_norm_`` scales ``p.grad`` in
place, as the reference's does.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        with torch.no_grad():
            return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


def _clip_scale(clip, norm, floor):
    """``min(clip / max(norm, floor), 1)`` in ``norm``'s dtype (a true
    division: a Python number over a tensor would take a reciprocal).
    The numerator is filled on the device, not copied from the host, so
    a captured step (``jit.to_static``) can hold it."""
    num = torch.full((), clip, dtype=norm.dtype, device=norm.device)
    return torch.clamp_max(num / torch.clamp_min(norm, floor), 1.0)


# _scaled's chunk: it closes at the gradient that brings it to this many
# elements (256 MiB of float32 copies)
SCALE_CHUNK = 1 << 26


def _scaled(grads, scale):
    """``(g.float() * scale).to(g.dtype)`` for each g (float32 scale),
    one ``_foreach_mul`` per chunk of about SCALE_CHUNK elements, so the
    float32 copies never span every gradient at once."""
    out, chunk, n = [], [], 0
    for i, g in enumerate(grads):
        chunk.append(g)
        n += g.numel()
        if n >= SCALE_CHUNK or i == len(grads) - 1:
            f = torch._foreach_mul([c.float() for c in chunk], scale)
            out += [o.to(c.dtype) for o, c in zip(f, chunk)]
            chunk, n = [], 0
    return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _global_norm_sq(self, params_grads):
        """The float32 sum of every clipped gradient's squares (None
        when no gradient takes part), summed gradient by gradient."""
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return None
        sq = None
        for g in grads:
            s = torch.sum(torch.square(g.float()))
            sq = s if sq is None else sq + s
        return sq

    def _dygraph_clip(self, params_grads):
        sq = self._global_norm_sq(params_grads)
        if sq is None:
            return params_grads
        global_norm = torch.sqrt(sq)
        scale = _clip_scale(self.clip_norm, global_norm, 1e-12)
        idx = [i for i, (p, g) in enumerate(params_grads) if _clipped(p, g)]
        new = _scaled([params_grads[i][1] for i in idx], scale)
        out = list(params_grads)
        for i, g in zip(idx, new):
            out[i] = (out[i][0], g)
        return out


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            n = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = _clip_scale(self.clip_norm, n, 1e-12)
            out.append((p, (g.float() * scale).to(g.dtype)))
        return out


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max)
                 if _clipped(p, g) else g) for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scales every ``p.grad`` in place so that their total
    ``norm_type``-norm is at most ``max_norm``; returns the total norm
    (float32, before scaling)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(g))
                                       for g in grads]))
    else:
        total = sum(torch.sum(torch.pow(torch.abs(g.float()), norm_type))
                    for g in grads) ** (1.0 / norm_type)
    scale = _clip_scale(max_norm, total, 1e-6)
    for g in grads:
        g.copy_(g * scale)
    return total
