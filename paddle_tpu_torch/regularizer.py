"""Regularizers of the port (counterpart of the reference's
``regularizer.py``). An optimizer's ``weight_decay`` reads ``_coeff``:
AdamW takes it as its decoupled decay coefficient, for ``L1Decay`` as for
``L2Decay`` (the reference's arithmetic: no sign term for L1). A
parameter's own ``regularizer`` is refused by the port's optimizers."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __float__(self):
        return self._coeff


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    def __float__(self):
        return self._coeff
