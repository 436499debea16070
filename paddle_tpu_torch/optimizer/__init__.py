"""Optimizers of the port (counterpart of the reference's
``optimizer/``): ``AdamW`` with float32 master weights. The other
optimizers and ``optimizer.lr`` are not ported yet."""
from .adamw import AdamW  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
