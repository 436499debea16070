from .hybrid_parallel_optimizer import (  # noqa: F401
    HybridParallelClipGrad,
    HybridParallelOptimizer,
)

__all__ = ["HybridParallelClipGrad", "HybridParallelOptimizer"]
