from .hybrid_parallel_util import (  # noqa: F401
    broadcast_dp_parameters,
    broadcast_input_data,
    broadcast_mp_parameters,
    broadcast_sharding_parameters,
    fused_allreduce_gradients,
)
