"""``paddle_tpu_torch.jit`` (counterpart of the reference's ``jit``):
``to_static`` records a step once, captures it into a CUDA graph on the
card and replays it (``api.py``, ``program.py``); ``analyze`` and
``plan`` lint and plan a step without executing it.

``save``, ``load`` and ``TranslatedLayer`` (the reference's StableHLO
export) are not ported yet: they raise ``NotImplementedError`` (ROADMAP
queue 1, the last item, with ``inference.create_predictor``).
"""
from __future__ import annotations

from .api import (  # noqa: F401
    StaticFunction,
    analyze,
    enable_to_static,
    ignore_module,
    live_static_functions,
    not_to_static,
    plan,
    to_static,
)
from .program import HostReadError  # noqa: F401

_EXPORT = ("jit.{}: exporting a compiled program is not ported yet "
           "(ROADMAP queue 1: jit.save / inference.create_predictor)")


def save(layer, path, input_spec=None, **configs):
    raise NotImplementedError(_EXPORT.format("save"))


def load(path, **configs):
    raise NotImplementedError(_EXPORT.format("load"))


class TranslatedLayer:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_EXPORT.format("TranslatedLayer"))
