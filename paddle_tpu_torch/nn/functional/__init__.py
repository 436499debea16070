from .flash_attention import (  # noqa: F401
    flash_attention,
    flash_attn_unpadded,
    flash_attn_varlen_func,
)
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .norm import rms_norm  # noqa: F401
