"""Optimizers of the port (counterpart of the reference's
``optimizer/``): ``AdamW`` and ``Adam``, ``Momentum``, ``SGD``,
``Adagrad``, ``RMSProp``, ``Lamb``, ``Adamax``, ``Adadelta``, ``NAdam``,
``RAdam``, ``Rprop``, ``ASGD`` and ``LBFGS``, each with float32 master
weights for bf16/fp16 parameters under ``multi_precision``; the LR
schedulers of ``optimizer.lr``; and the in-place update rules of
``optimizer.functional``."""
from . import functional, lr  # noqa: F401
from .adamw import Adam, AdamW  # noqa: F401
from .extra import (ASGD, LBFGS, Adadelta, Adamax, NAdam, RAdam,  # noqa: F401
                    Rprop)
from .momentum import SGD, Adagrad, Lamb, Momentum, RMSProp  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
