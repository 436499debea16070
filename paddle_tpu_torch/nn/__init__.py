from . import functional  # noqa: F401
from .layer import RMSNorm  # noqa: F401
