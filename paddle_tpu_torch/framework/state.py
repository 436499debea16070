"""The state a compiled step reaches (counterpart of the reference's
``framework/state.py``).

The reference keeps weak registries of every live Layer and Optimizer
and snapshots them all. The port's ``nn.Module``s and optimizers do not
register themselves, so the state of a function is found the way its
code reaches it: the ``self`` of a bound method, its closure cells and
the globals its code names (as ``inspect.getclosurevars`` reads them),
and one level into the lists, tuples and dicts found there, and into the
attributes of a ``self`` that is neither a module nor an optimizer. The
modules, optimizers and LR schedulers found are the function's
*objects*; their parameters, buffers, float32 masters and optimizer
state tensors are its *state tensors*.

Gradients are not state here: a compiled call starts with every
reachable parameter's gradient dropped and leaves what the step leaves,
as the reference's compiled step does (``jit/api.py``).
"""
from __future__ import annotations

import inspect

import torch
from torch import nn


def _is_optimizer(obj) -> bool:
    from ..optimizer.optimizer import Optimizer

    return isinstance(obj, Optimizer)


def _is_scheduler(obj) -> bool:
    from ..optimizer.lr import LRScheduler

    return isinstance(obj, LRScheduler)


def _stateful(obj) -> bool:
    return isinstance(obj, nn.Module) or _is_optimizer(obj) \
        or _is_scheduler(obj)


def _candidates(fn):
    """The values ``fn``'s code reaches: ``self`` of a bound method, the
    closure's cells, the globals it names, and the defaults."""
    out = []
    target = fn
    if inspect.ismethod(fn):
        out.append(fn.__self__)
        target = fn.__func__
    target = inspect.unwrap(target)
    if not inspect.isfunction(target):
        # a callable object (a module, say): itself and its attributes
        out.append(target)
        return out
    cv = inspect.getclosurevars(target)
    out += list(cv.nonlocals.values()) + list(cv.globals.values())
    out += list(target.__defaults__ or ())
    return out


def _expand(value, depth=1):
    """``value`` and, ``depth`` levels down, what its containers (and a
    plain object's attributes) hold."""
    yield value
    if depth <= 0 or _stateful(value) or isinstance(value, torch.Tensor):
        return
    if isinstance(value, (list, tuple, set, frozenset)):
        items = list(value)
    elif isinstance(value, dict):
        items = list(value.values())
    elif hasattr(value, "__dict__") and not inspect.ismodule(value) \
            and not inspect.isclass(value) and not callable(value):
        items = list(vars(value).values())
    else:
        return
    for item in items:
        yield from _expand(item, depth - 1)


def reachable_objects(fn):
    """``(modules, optimizers, schedulers)`` that ``fn`` reaches, each in
    the order first found, without duplicates."""
    seen = set()
    modules, optimizers, schedulers = [], [], []
    for cand in _candidates(fn):
        for obj in _expand(cand):
            if id(obj) in seen or not _stateful(obj):
                continue
            seen.add(id(obj))
            if isinstance(obj, nn.Module):
                modules.append(obj)
            elif _is_optimizer(obj):
                optimizers.append(obj)
            else:
                schedulers.append(obj)
    return modules, optimizers, schedulers


def live_layers(fn):
    """Every module ``fn`` reaches, submodules included (the modules
    whose ``training`` flag keys a compiled entry)."""
    out, seen = [], set()
    for m in reachable_objects(fn)[0]:
        for sub in m.modules():
            if id(sub) not in seen:
                seen.add(id(sub))
                out.append(sub)
    return out


def reachable_parameters(fn):
    """The parameters of the modules and optimizers ``fn`` reaches, each
    once (the tensors whose gradients a compiled call starts without)."""
    out, seen = [], set()
    modules, optimizers, _ = reachable_objects(fn)
    params = [p for m in modules for p in m.parameters()]
    params += [p for o in optimizers for p in o._parameter_list]
    for p in params:
        if id(p) not in seen:
            seen.add(id(p))
            out.append(p)
    return out


def snapshot_state_tensors(fn):
    """The state tensors ``fn`` reaches, in a stable order: each module's
    parameters and buffers, then each optimizer's state
    (:meth:`Optimizer._state_tensors`), each tensor once."""
    out, seen = [], set()
    modules, optimizers, _ = reachable_objects(fn)

    def add(t):
        if t is not None and id(t) not in seen:
            seen.add(id(t))
            out.append(t)

    for m in modules:
        for t in m.parameters():
            add(t)
        for t in m.buffers():
            add(t)
    for o in optimizers:
        for t in o._state_tensors():
            add(t)
    return out
