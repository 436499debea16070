"""AdamW and Adam of the port (counterpart of the reference's
``optimizer/adamw.py``), with the reference's semantics:

* with ``multi_precision`` (the default), bf16/fp16 parameters keep a
  float32 master copy and float32 moments; the parameter is the master
  cast back after each step;
* per-parameter ``beta1_pow`` / ``beta2_pow``, float32 like the
  reference's accumulators, as 0-d tensors on the parameter's device,
  stepped there;
* the rate ``lr * lr_ratio(p) * p.optimize_attr["learning_rate"]``
  (the last stamped by a ``ParamAttr``, 1 without one), in float32,
  from the learning rate's float32 0-d device tensor (``_lr_tensor``);
* decoupled decay ``p32 *= 1 - lr * coeff`` (0 where
  ``apply_decay_param_fun(name)`` is false), then
  ``p32 -= lr * m_hat / (sqrt(v_hat) + eps)``; ``Adam`` folds the decay
  into the gradient instead (``g32 += coeff * p32``).

The update is torch code: ``torch._foreach_*`` over the parameters that
share the same rate multipliers and decay (normally all of them), where
the reference lets XLA fuse it. Every step-varying scalar (the rate, the
beta powers, the bias corrections) is a device tensor and nothing is
read on the host, so the class is capturable: a CUDA graph of a step
(``jit.to_static``) replays the right rate and bias corrections. The
rate is folded into the first bias correction, one 0-d factor a
parameter (``-lr / (1 - beta1_pow)``), so the update makes as many
passes over the state as it did with host scalars:
``p32 += (m * s1) / (sqrt(v / (1 - beta2_pow)) + eps)``. The decay
factor is computed in float64 and rounded once, as the Python number it
was. ``torch.optim.AdamW`` is
not used: it keeps bf16 state and has no master weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer


class AdamW(Optimizer):
    _accum_names = ("moment1", "moment2")
    _capturable = True

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
        self._beta1_pow = self._aux_tensors("beta1_pow_acc_0", self._beta1)
        self._beta2_pow = self._aux_tensors("beta2_pow_acc_0", self._beta2)

    def _decoupled(self):
        return True

    def _bucket(self, i):
        """(float32 rate multipliers, decay coeff) of parameter i: the
        host constants the update is grouped by."""
        coeff = self._decay_coeff()
        if self._apply_decay_param_fun is not None and not \
                self._apply_decay_param_fun(self._names[i]):
            coeff = 0.0
        p = self._parameter_list[i]
        mults = []
        if self._lr_ratio is not None:
            mults.append(float(np.float32(self._lr_ratio(p))))
        attr = getattr(p, "optimize_attr", None)
        if attr is not None:
            mults.append(float(np.float32(attr.get("learning_rate", 1.0))))
        return tuple(mults), coeff

    def _apply(self, indices, grads):
        buckets = {}
        for i, g in zip(indices, grads):
            buckets.setdefault(self._bucket(i), []).append((i, g))
        for (mults, coeff), pairs in buckets.items():
            lr = self._lr_tensor
            for r in mults:  # float32 products, in the reference's order
                lr = lr * r
            self._update([i for i, _ in pairs], [g for _, g in pairs], lr,
                         coeff)
        if indices:
            torch._foreach_mul_([self._beta1_pow[i] for i in indices],
                                self._beta1)
            torch._foreach_mul_([self._beta2_pow[i] for i in indices],
                                self._beta2)

    def _update(self, idx, grads, lr, coeff):
        """One step of the parameters ``idx`` at the float32 0-d device
        rate ``lr``."""
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
            # 1 - lr * coeff in float64, rounded once to float32
            torch._foreach_mul_(p32, (1.0 - lr.double() * coeff).float())
        elif coeff:  # Adam's L2: the decay folded into the gradient
            g32 = torch._foreach_add(g32, torch._foreach_mul(p32, coeff))
        torch._foreach_mul_(m32, b1)
        torch._foreach_add_(m32, g32, alpha=1.0 - b1)
        torch._foreach_mul_(v32, b2)
        torch._foreach_addcmul_(v32, g32, g32, value=1.0 - b2)
        # the bias corrections 1 - beta_pow, on the device, with the
        # rate folded into the first: s1 = -lr / (1 - beta1_pow), 0-d
        c1 = torch._foreach_neg([self._beta1_pow[i] for i in idx])
        torch._foreach_add_(c1, 1.0)
        c2 = torch._foreach_neg([self._beta2_pow[i] for i in idx])
        torch._foreach_add_(c2, 1.0)
        s1 = torch._foreach_div([torch.neg(lr)] * len(idx), c1)
        upd = torch._foreach_mul(m32, s1)
        denom = torch._foreach_div(v32, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_addcdiv_(p32, upd, denom)
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
