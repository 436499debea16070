from ..layers.mpu.mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from .meta_parallel_base import MetaParallelBase  # noqa: F401
from .parallel_layers.random import (  # noqa: F401
    RNGStatesTracker,
    get_rng_state_tracker,
    model_parallel_random_seed,
)
from .tensor_parallel import TensorParallel  # noqa: F401

__all__ = [
    "MetaParallelBase", "TensorParallel", "RNGStatesTracker",
    "get_rng_state_tracker", "model_parallel_random_seed",
    "ColumnParallelLinear", "RowParallelLinear",
    "VocabParallelEmbedding", "ParallelCrossEntropy",
]
