"""Momentum, SGD, Adagrad, RMSProp and Lamb of the port (counterpart of
the reference's ``optimizer/momentum.py``), each the reference's update
in per-parameter float32 torch code.

As in the reference, Momentum and SGD step the float32 master and fold a
weight decay into the gradient (``g += coeff * p``), and only Momentum
reads a ``ParamAttr`` learning rate. Adagrad, RMSProp and Lamb step the
parameter itself (widened to float32): with ``multi_precision`` their
state is float32 and a bf16/fp16 parameter's master is kept, but never
read or written. The options those three accept and never read (a
weight decay, a ``ParamAttr`` rate, Adagrad's
``initial_accumulator_value``) raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer


class Momentum(Optimizer):
    _accum_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=True, name=None):
        self._momentum = float(momentum)
        self._nesterov = use_nesterov
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _apply_one(self, i, grad, lr):
        p32 = self._p32(i)
        g32 = grad.float()
        coeff = self._decay_coeff()
        if coeff:
            g32 = g32 + coeff * p32
        mu = self._momentum
        rate = getattr(self._parameter_list[i], "optimize_attr",
                       {}).get("learning_rate", 1.0)
        lr_eff = float(lr * np.float32(rate))
        v_new = mu * self._acc32("velocity", i) + g32
        if self._nesterov:
            p_new = p32 - lr_eff * (g32 + mu * v_new)
        else:
            p_new = p32 - lr_eff * v_new
        self._put("velocity", i, v_new)
        self._commit(i, p_new)


class SGD(Optimizer):
    _accum_names = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._refuse_ignored("SGD", rate=True)

    def _apply_one(self, i, grad, lr):
        p32 = self._p32(i)
        g32 = grad.float()
        coeff = self._decay_coeff()
        if coeff:
            g32 = g32 + coeff * p32
        self._commit(i, p32 - float(lr) * g32)


class Adagrad(Optimizer):
    _accum_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=True,
                 name=None):
        if initial_accumulator_value:
            raise NotImplementedError(
                "Adagrad: initial_accumulator_value is accepted and never "
                "read by the reference (its moments start at 0)")
        self._epsilon = float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._refuse_ignored("Adagrad", rate=True, decay=True)

    def _apply_one(self, i, grad, lr):
        g32 = grad.float()
        m_new = self._acc32("moment", i) + g32 * g32
        p32 = self._parameter_list[i].float()
        p_new = p32 - float(lr) * g32 / (torch.sqrt(m_new) + self._epsilon)
        self._put("moment", i, m_new)
        self._commit(i, p_new, master=False)


class RMSProp(Optimizer):
    _accum_names = ("mean_square", "mean_grad", "momentum_acc")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=True, name=None):
        self._rho = float(rho)
        self._epsilon = float(epsilon)
        self._momentum = float(momentum)
        self._centered = centered
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._refuse_ignored("RMSProp", rate=True, decay=True)

    def _apply_one(self, i, grad, lr):
        g32 = grad.float()
        rho = self._rho
        ms_new = rho * self._acc32("mean_square", i) + (1 - rho) * g32 * g32
        if self._centered:
            mg_new = rho * self._acc32("mean_grad", i) + (1 - rho) * g32
            denom = torch.sqrt(ms_new - mg_new * mg_new + self._epsilon)
            self._put("mean_grad", i, mg_new)
        else:
            denom = torch.sqrt(ms_new + self._epsilon)
        update = float(lr) * g32 / denom
        if self._momentum:
            mom_new = self._momentum * self._acc32("momentum_acc", i) + update
            self._put("momentum_acc", i, mom_new)
            update = mom_new
        self._put("mean_square", i, ms_new)
        p32 = self._parameter_list[i].float()
        self._commit(i, p32 - update, master=False)


class Lamb(Optimizer):
    _accum_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True, name=None):
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._lamb_wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._refuse_ignored("Lamb", rate=True)

    def _apply_one(self, i, grad, lr):
        """``exclude_from_weight_decay_fn`` receives the parameter
        tensor, as the reference's receives its parameter."""
        param = self._parameter_list[i]
        g32 = grad.float()
        p32 = param.float()
        b1, b2 = self._beta1, self._beta2
        m_new = b1 * self._acc32("moment1", i) + (1 - b1) * g32
        v_new = b2 * self._acc32("moment2", i) + (1 - b2) * g32 * g32
        r = m_new / (torch.sqrt(v_new) + self._epsilon)
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(param):
            wd = 0.0
        update = r + wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        u_norm = torch.linalg.vector_norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        p_new = p32 - (float(lr) * trust) * update
        self._put("moment1", i, m_new)
        self._put("moment2", i, v_new)
        self._commit(i, p_new, master=False)
