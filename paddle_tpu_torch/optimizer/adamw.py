"""AdamW and Adam of the port (counterpart of the reference's
``optimizer/adamw.py``), with the reference's semantics:

* with ``multi_precision`` (the default), bf16/fp16 parameters keep a
  float32 master copy and float32 moments; the parameter is the master
  cast back after each step;
* per-parameter ``beta1_pow`` / ``beta2_pow``, float32 like the
  reference's accumulators (kept as numpy float32 scalars on the host:
  they take part only as scalars of the update);
* the rate ``lr * lr_ratio(p) * p.optimize_attr["learning_rate"]``
  (the last stamped by a ``ParamAttr``, 1 without one), in float32;
* decoupled decay ``p32 *= 1 - lr * coeff`` (0 where
  ``apply_decay_param_fun(name)`` is false), then
  ``p32 -= lr * m_hat / (sqrt(v_hat) + eps)``; ``Adam`` folds the decay
  into the gradient instead (``g32 += coeff * p32``).

The update is torch code: ``torch._foreach_*`` over the parameters that
share the same scalars (normally all of them), where the reference lets
XLA fuse it. ``torch.optim.AdamW`` is not used: it keeps bf16 state and
has no master weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer


class AdamW(Optimizer):
    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None):
        if lazy_mode:
            raise NotImplementedError("AdamW lazy_mode is not ported yet")
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio
        super().__init__(learning_rate, parameters,
                         weight_decay if weight_decay is not None else 0.0,
                         grad_clip, name, multi_precision)
        self._moment1 = self._accums["moment1"]
        self._moment2 = self._accums["moment2"]
        self._beta1_pow = self._aux_scalars("beta1_pow_acc_0", self._beta1)
        self._beta2_pow = self._aux_scalars("beta2_pow_acc_0", self._beta2)

    def _decoupled(self):
        return True

    def _scalars(self, i):
        """(lr_eff, decay coeff, beta1_pow, beta2_pow) of parameter i."""
        coeff = self._decay_coeff()
        if self._apply_decay_param_fun is not None and not \
                self._apply_decay_param_fun(self._names[i]):
            coeff = 0.0
        p = self._parameter_list[i]
        lr = np.float32(self._learning_rate)
        if self._lr_ratio is not None:
            lr = lr * np.float32(self._lr_ratio(p))
        attr = getattr(p, "optimize_attr", None)
        if attr is not None:
            lr = lr * np.float32(attr.get("learning_rate", 1.0))
        return (float(lr), coeff, float(self._beta1_pow[i]),
                float(self._beta2_pow[i]))

    def _apply(self, indices, grads):
        buckets = {}
        for i, g in zip(indices, grads):
            buckets.setdefault(self._scalars(i), []).append((i, g))
        for (lr, coeff, b1p, b2p), pairs in buckets.items():
            self._update([i for i, _ in pairs], [g for _, g in pairs], lr,
                         coeff, b1p, b2p)
        for i in indices:
            self._beta1_pow[i] = self._beta1_pow[i] * np.float32(self._beta1)
            self._beta2_pow[i] = self._beta2_pow[i] * np.float32(self._beta2)

    def _update(self, idx, grads, lr, coeff, b1p, b2p):
        b1, b2 = self._beta1, self._beta2
        params = [self._parameter_list[i] for i in idx]
        # float32 views of the state: the master, or the parameter (and
        # moments) themselves when they are float32, else a widened copy
        # that is written back below
        p32 = [self._master[i] if self._master[i] is not None
               else p.float() for i, p in zip(idx, params)]
        m32 = [self._moment1[i].float() for i in idx]
        v32 = [self._moment2[i].float() for i in idx]
        g32 = [g.float() for g in grads]
        if coeff and self._decoupled():
            torch._foreach_mul_(p32, 1.0 - lr * coeff)
        elif coeff:  # Adam's L2: the decay folded into the gradient
            g32 = torch._foreach_add(g32, torch._foreach_mul(p32, coeff))
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, g32, alpha=1.0 - b1)
        torch._foreach_mul_(v32, b2)
        torch._foreach_addcmul_(v32, g32, g32, value=1.0 - b2)
        m_hat = torch._foreach_div(m32, float(np.float32(1.0) - b1p))
        denom = torch._foreach_div(v32, float(np.float32(1.0) - b2p))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_addcdiv_(p32, m_hat, denom, value=-lr)
        cast = [(p, a) for p, a in zip(params, p32) if a is not p]
        if cast:
            torch._foreach_copy_([p for p, _ in cast], [a for _, a in cast])
        for i, m, v in zip(idx, m32, v32):
            if m is not self._moment1[i]:
                self._moment1[i].copy_(m)
                self._moment2[i].copy_(v)


class Adam(AdamW):
    """Adam with the classic (coupled) L2 decay: ``g += coeff * p`` (the
    master) before the moments, as the reference's ``Adam``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay if weight_decay is not None else 0.0,
                         None, None, grad_clip, lazy_mode, multi_precision,
                         name)

    def _decoupled(self):
        return False
