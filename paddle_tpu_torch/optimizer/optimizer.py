"""Optimizer base of the port (counterpart of the reference's
``optimizer/optimizer.py``).

Parameters are the torch tensors a model hands out (``parameters()``),
``(name, tensor)`` pairs (``named_parameters()``), or dict groups
``{"params": [...]}`` flattened in order. The name is what
``apply_decay_param_fun`` receives (``param_<i>`` when none is given) and
what the ``state_dict`` keys carry. A group key other than ``params``
raises: the reference reads nothing else of a group. So does a parameter
that carries its own ``regularizer`` (``ParamAttr(regularizer=...)``),
which the reference's optimizers never read.

``learning_rate`` is a float or an ``LRScheduler`` (``optimizer/lr.py``),
which then pushes its rate into the optimizer at each of its steps.
``grad_clip`` (``nn/clip.py``) clips the gradients in ``step()`` before
the update; ``weight_decay`` is a float or a regularizer
(``regularizer.py``), read through its ``_coeff``: an ``L1Decay`` is a
coefficient like an ``L2Decay``'s, as in the reference (AdamW's decay is
decoupled, ``p *= 1 - lr * coeff``, whichever class carries it).

State is created at construction, as in the reference: with
``multi_precision`` a float32 master of every bf16/fp16 parameter, and
one zero accumulator of each of the class's ``_accum_names`` a
parameter (float32 beside a master, else in the parameter's dtype).
Per-parameter scalars (beta powers, step counts) are numpy float32
values on the host (:meth:`_aux_scalars`), except in a *capturable*
class (``_capturable``: AdamW and Adam), which keeps them as float32 0-d
tensors on the parameters' device, stepped there (:meth:`_aux_tensors`),
so that a captured step (``jit.to_static`` on the card) reads and steps
them at every replay. The learning rate is a float32 0-d device tensor
too (``_lr_tensor``, the reference's ``learning_rate_0`` state tensor),
which an LR scheduler's step writes in place; ``_learning_rate`` keeps
the same value as a float. A class that is not capturable raises
``NotImplementedError`` from ``step()`` while a CUDA graph is being
captured: its host scalars would be baked into the graph.
``state_dict`` keys are the reference's: ``<name>_<accum>_0``,
``<name>_<aux>``, and the masters ``<name>_fp32_master_0`` under
``master_weights``; every per-parameter scalar is a float32 0-d CPU
tensor there.
"""
from __future__ import annotations

import numpy as np
import torch

from .lr import LRScheduler


class Optimizer:
    _accum_names: tuple = ()
    # whether step() keeps every step-varying scalar on the device, so
    # that a CUDA graph of the step is right at every replay
    _capturable = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        if parameters is None:
            raise ValueError("paddle_tpu_torch optimizers need explicit "
                             "`parameters` (as the reference in dygraph)")
        self._names, self._parameter_list = [], []
        for i, entry in enumerate(_flatten_groups(list(parameters))):
            name, p = entry if isinstance(entry, tuple) \
                else (f"param_{i}", entry)
            if getattr(p, "regularizer", None) is not None:
                raise NotImplementedError(
                    f"parameter {name} carries a regularizer "
                    "(ParamAttr(regularizer=...)): no optimizer of the "
                    "port reads it (the reference ignores it); use the "
                    "optimizer's weight_decay and apply_decay_param_fun")
            self._names.append(name)
            self._parameter_list.append(p)
        self._lr_scheduler = None
        device = self._parameter_list[0].device if self._parameter_list \
            else torch.device("cpu")
        self._lr_tensor = torch.zeros((), dtype=torch.float32,
                                      device=device)
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
            self._set_lr_value(learning_rate())
            learning_rate._bind(self)
        else:
            self._set_lr_value(learning_rate)
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision
        self._create_accumulators()

    def _create_accumulators(self):
        self._master = [p.detach().float() if self._use_master(p) else None
                        for p in self._parameter_list]
        self._accums = {
            name: [torch.zeros_like(p, dtype=torch.float32 if m is not None
                                    else p.dtype)
                   for p, m in zip(self._parameter_list, self._master)]
            for name in self._accum_names}
        self._aux = {}

    def _aux_scalars(self, key, init):
        """A host float32 scalar ``<name>_<key>`` for every parameter,
        starting at ``init``: the list, indexed like the parameters."""
        lst = [np.float32(init)] * len(self._parameter_list)
        self._aux[key] = lst
        return lst

    def _aux_tensors(self, key, init):
        """As :meth:`_aux_scalars`, a float32 0-d tensor on each
        parameter's device (a capturable class's scalars)."""
        lst = [torch.full((), float(np.float32(init)), dtype=torch.float32,
                          device=p.device) for p in self._parameter_list]
        self._aux[key] = lst
        return lst

    def _state_tensors(self):
        """Every tensor of this optimizer's state (the learning rate,
        the masters, the accumulators and the device scalars), each
        once: what a compiled step reads and writes
        (``framework/state.py``)."""
        out = [self._lr_tensor]
        out += [m for m in self._master if m is not None]
        for lst in self._accums.values():
            out += lst
        for lst in self._aux.values():
            out += [t for t in lst if isinstance(t, torch.Tensor)]
        return out

    def _refuse_ignored(self, what, rate=False, decay=False, clip=False):
        """``NotImplementedError`` for the options the reference's
        ``what`` accepts and never reads: a ``ParamAttr`` learning rate
        other than 1, a weight decay, a gradient clip."""
        if rate:
            for name, p in zip(self._names, self._parameter_list):
                r = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
                if r != 1.0:
                    raise NotImplementedError(
                        f"{what}: parameter {name} has a ParamAttr "
                        f"learning rate {r}, which the reference's {what} "
                        "never reads")
        if decay and self._decay_coeff():
            raise NotImplementedError(
                f"{what}: weight_decay is accepted and never read by the "
                f"reference's {what}")
        if clip and self._grad_clip is not None:
            raise NotImplementedError(
                f"{what}: grad_clip is accepted and never read by the "
                f"reference's {what}")

    def _p32(self, i):
        """Parameter i in float32: its master, or the parameter itself
        (widened when it is not float32)."""
        if self._master[i] is not None:
            return self._master[i]
        return self._parameter_list[i].float()

    def _commit(self, i, p_new, master=True):
        """Parameter i (and its master, unless ``master`` is False) set
        to the float32 ``p_new``."""
        if master and self._master[i] is not None:
            self._master[i].copy_(p_new)
        self._parameter_list[i].copy_(p_new)

    def _put(self, name, i, new):
        """Accumulator ``name`` of parameter i set to ``new`` (cast to
        its dtype)."""
        self._accums[name][i].copy_(new)

    def _acc32(self, name, i):
        return self._accums[name][i].float()

    def _use_master(self, param):
        return self._multi_precision and param.dtype in (torch.bfloat16,
                                                         torch.float16)

    def get_lr(self):
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return self._learning_rate

    def set_lr(self, value):
        self._set_lr_value(value)

    def _set_lr_value(self, value):
        """The rate as a float and, in place, in ``_lr_tensor`` (a
        captured step reads the tensor at every replay)."""
        self._learning_rate = float(value)
        with torch.no_grad():
            self._lr_tensor.fill_(self._learning_rate)

    def set_lr_scheduler(self, scheduler):
        self._lr_scheduler = scheduler
        scheduler._bind(self)

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
        if not self._capturable and _capturing():
            raise NotImplementedError(
                f"{type(self).__name__}.step() keeps its step-varying "
                "scalars on the host, which a CUDA graph would bake in: it "
                "cannot run inside jit.to_static on the card yet (only "
                "AdamW and Adam are capturable)")
        live = [i for i, p in enumerate(self._parameter_list)
                if p.requires_grad and p.grad is not None]
        grads = [self._parameter_list[i].grad for i in live]
        if self._grad_clip is not None:
            clipped = self._grad_clip(
                [(self._parameter_list[i], g) for i, g in zip(live, grads)])
            grads = [g for _, g in clipped]
        self._apply(live, grads)

    def _apply(self, indices, grads):
        lr = np.float32(self._learning_rate)
        for i, g in zip(indices, grads):
            self._apply_one(i, g, lr)

    def _apply_one(self, i, grad, lr):
        raise NotImplementedError

    # -- state dict --------------------------------------------------------
    def _state_items(self):
        """``(tensors, masters, scalars)``: the per-parameter state
        tensors and the float32 masters, ``{key: tensor}`` under the
        reference's key names, and the host scalars, ``{key: (list,
        index)}``."""
        tensors, masters, scalars = {}, {}, {}
        for i, name in enumerate(self._names):
            for acc in self._accum_names:
                tensors[f"{name}_{acc}_0"] = self._accums[acc][i]
            for key, lst in self._aux.items():
                scalars[f"{name}_{key}"] = (lst, i)
            if self._master[i] is not None:
                masters[f"{name}_fp32_master_0"] = self._master[i]
        return tensors, masters, scalars

    def state_dict(self):
        """The per-parameter state under the reference's key names
        (``<name>_moment1_0``, ``<name>_beta1_pow_acc_0``, ...; the
        masters under ``master_weights``), and the scheduler's state
        under ``LR_Scheduler``."""
        tensors, masters, scalars = self._state_items()
        sd = dict(tensors)
        sd.update({k: _scalar_tensor(lst[i]) for k, (lst, i) in
                   scalars.items()})
        if masters:
            sd["master_weights"] = dict(masters)
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        """Loads a :meth:`state_dict` in place. An entry that matches no
        state of this optimizer raises ``KeyError`` (the reference warns
        and drops it)."""
        tensors, masters, scalars = self._state_items()
        extra = {"LR_Scheduler", "master_weights"}
        unknown = [k for k in state_dict if k not in tensors
                   and k not in scalars and k not in extra]
        unknown += [k for k in state_dict.get("master_weights", {})
                    if k not in masters]
        if unknown:
            raise KeyError(f"optimizer.set_state_dict: no state named "
                           f"{unknown[:3]}")
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        with torch.no_grad():
            for k, v in state_dict.items():
                if k in tensors:
                    tensors[k].copy_(torch.as_tensor(v))
                elif k in scalars:
                    lst, i = scalars[k]
                    if isinstance(lst[i], torch.Tensor):
                        lst[i].fill_(float(v))
                    else:
                        lst[i] = type(lst[i])(float(v))
            for k, v in state_dict.get("master_weights", {}).items():
                masters[k].copy_(torch.as_tensor(v))


def _scalar_tensor(v):
    """A per-parameter scalar as the ``state_dict`` holds it: a float32
    0-d CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    return torch.tensor(v)


def _capturing() -> bool:
    """Whether a CUDA graph is being captured on this thread's stream
    (by ``jit.to_static`` or by the caller)."""
    from ..jit import program

    if program.capturing():
        return True
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _flatten_groups(entries):
    """Parameters given as dict groups (``{"params": [...]}``, when the
    first entry is one) flattened in order; a group key other than
    ``params`` raises ``NotImplementedError``."""
    if not entries or not isinstance(entries[0], dict):
        return entries
    out = []
    for g in entries:
        other = sorted(set(g) - {"params"})
        if other:
            raise NotImplementedError(
                f"parameter group keys {other}: the port reads only "
                "'params' of a group (the reference ignores the rest)")
        out.extend(g["params"])
    return out
