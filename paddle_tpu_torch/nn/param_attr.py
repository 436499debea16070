"""ParamAttr of the port (counterpart of the reference's
``nn/param_attr.py``).

The layers that take ``weight_attr=`` (the mp layers and ``RMSNorm``)
stamp on the parameter what the reference's ``create_parameter`` does:
``optimize_attr["learning_rate"]`` (the optimizers multiply their rate
by it), ``regularizer``, and ``trainable`` as ``requires_grad``. The
port's optimizers refuse a parameter that carries a regularizer (the
reference's never read it).
``need_clip`` is not stamped (nor is it by the reference); set
``param.need_clip = False`` to keep a gradient out of clipping. An
initializer and a parameter name are not ported: the port draws its
layers' weights itself, and names come from ``named_parameters()``.
"""
from __future__ import annotations

from torch import nn

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if attr is False:
            return False
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr "
                        "(nn.initializer is not ported yet)")


def make_parameter(data, attr=None):
    """``data`` as an ``nn.Parameter`` stamped from ``attr`` (anything
    :meth:`ParamAttr._to_attr` takes), or None for ``attr=False``."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    if attr.initializer is not None:
        raise NotImplementedError(
            "ParamAttr(initializer=...) is not ported yet (it waits for "
            "nn.initializer)")
    if attr.name is not None:
        raise NotImplementedError(
            "ParamAttr(name=...): the port names parameters by their "
            "module path (named_parameters())")
    p = nn.Parameter(data, requires_grad=bool(attr.trainable))
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    p.regularizer = attr.regularizer
    return p
