from . import functional  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    clip_grad_norm_,
)
from .layer import RMSNorm  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
