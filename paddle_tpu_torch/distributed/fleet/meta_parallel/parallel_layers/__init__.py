from .random import RNGStatesTracker, get_rng_state_tracker  # noqa: F401

__all__ = ["RNGStatesTracker", "get_rng_state_tracker"]
