"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

It sits beside the JAX package and imports neither JAX nor anything of
``paddle_tpu``. Entry points run on the card (``cuda``) unless the
caller passes ``device="cpu"``. The first slice is paged Llama serving:
``inference.BatchScheduler`` -> ``inference.PagedLlamaAdapter`` -> the
paged KV pool (``incubate.nn.PagedKVCacheManager``), with the RMSNorm
and ragged paged-attention kernels written by hand in CUDA C++
(``ops/kernels/csrc``).
"""
__version__ = "0.1.0"

from . import device, inference, jit, models, nn, regularizer  # noqa: F401
from .device import get_device, set_device  # noqa: F401
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.io import load, save  # noqa: F401
from .ops.kernels import kernel_launch_stats  # noqa: F401
