from .norm import rms_norm  # noqa: F401
