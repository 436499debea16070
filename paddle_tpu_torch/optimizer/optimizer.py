"""Optimizer base of the port (counterpart of the reference's
``optimizer/optimizer.py``).

Parameters are the torch tensors a model hands out (``parameters()``),
or ``(name, tensor)`` pairs (``named_parameters()``): the name is what
``apply_decay_param_fun`` receives (``param_<i>`` when none is given).
The learning rate is a float; LR schedulers, gradient clipping and
parameter groups are not ported yet and raise.
"""
from __future__ import annotations

import torch


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        if parameters is None:
            raise ValueError("paddle_tpu_torch optimizers need explicit "
                             "`parameters` (as the reference in dygraph)")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "LR schedulers are not ported yet: pass a float")
        self._names, self._parameter_list = [], []
        for i, p in enumerate(parameters):
            if isinstance(p, dict):
                raise NotImplementedError(
                    "parameter groups are not ported yet")
            name, p = p if isinstance(p, tuple) else (f"param_{i}", p)
            self._names.append(name)
            self._parameter_list.append(p)
        self._learning_rate = float(learning_rate)
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision

    def _use_master(self, param):
        return self._multi_precision and param.dtype in (torch.bfloat16,
                                                         torch.float16)

    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    def clear_grad(self, set_to_zero=False):
        """Drop every gradient (``set_to_zero``: zero it in place)."""
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def _decay_coeff(self):
        wd = self._weight_decay
        if wd is None:
            return 0.0
        return float(getattr(wd, "_coeff", wd))

    @torch.no_grad()
    def step(self):
        live = [i for i, p in enumerate(self._parameter_list)
                if p.requires_grad and p.grad is not None]
        self._apply(live)

    def _apply(self, indices):
        raise NotImplementedError
