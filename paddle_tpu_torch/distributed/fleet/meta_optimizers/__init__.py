from .dygraph_optimizer import HybridParallelOptimizer  # noqa: F401

__all__ = ["HybridParallelOptimizer"]
