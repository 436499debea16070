from .flash_attention import flash_attention  # noqa: F401
from .loss import cross_entropy  # noqa: F401
from .norm import rms_norm  # noqa: F401
