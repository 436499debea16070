"""DistributedStrategy (counterpart of the reference's
``distributed/fleet/base/distributed_strategy.py``): upstream's
protobuf-backed strategy as a plain attribute bag with the same keys.
``fleet.init`` reads its ``hybrid_configs``."""
from __future__ import annotations

import copy

_DEFAULT_HYBRID = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "ep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
    "mp_configs": {},
    "pp_configs": {},
}


class DistributedStrategy:
    def __init__(self):
        self._hybrid_configs = copy.deepcopy(_DEFAULT_HYBRID)
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"micro_batch_size": 1,
                                 "accumulate_steps": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.last_comm_group_size_MB = 1
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.hybrid_parallel_order = list(_DEFAULT_HYBRID["order"])

    @property
    def hybrid_configs(self):
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, configs):
        for k, v in configs.items():
            if k == "order":
                self._hybrid_configs["order"] = list(v)
            elif k in ("mp_configs", "pp_configs"):
                self._hybrid_configs[k].update(v)
            else:
                self._hybrid_configs[k] = v

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self._hybrid_configs})"
