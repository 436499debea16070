from .norm import RMSNorm  # noqa: F401
