"""Hybrid topology (counterpart of the reference's
``distributed/fleet/base/topology.py``): ``CommunicateTopology``, the
rank grid, and ``HybridCommunicateGroup``, one process group per slice
of each axis.

Axes keep the reference's order ``["dp", "pp", "sharding", "sep",
"mp"]`` and aliases. A rank is the row-major index of its coordinate
over the axes, as the reference's mesh lays ``jax.devices()`` out
(``mesh.py``): with ``dp`` 2 and ``mp`` 2, the mp groups are {0, 1} and
{2, 3}, the dp groups {0, 2} and {1, 3}. Every rank creates every
group, in the same order (torch's ``new_group`` is collective), and
keeps the ones it is in. An axis of degree 1 gets a one-rank group
computed locally, with no process group behind it.
"""
from __future__ import annotations

import itertools

import numpy as np

from ... import env as _env
from ...collective import _local_group, new_group

_AXIS_CANON = {
    "dp": "dp", "data": "dp",
    "pp": "pp", "pipe": "pp",
    "sharding": "sharding",
    "sep": "sep",
    "mp": "mp", "model": "mp",
    "ep": "ep", "expert": "ep",
}
_LONG = {"dp": "data", "pp": "pipe", "sharding": "sharding", "sep": "sep",
         "mp": "model", "ep": "ep"}
_ORDER = ["dp", "pp", "sharding", "sep", "mp"]


class CommunicateTopology:
    """The rank grid: ``dims[i]`` ranks along axis
    ``hybrid_group_names[i]``, rank = row-major index of the
    coordinate."""

    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = list(
            hybrid_group_names or ["data", "pipe", "sharding", "sep",
                                   "model"])
        self._dims = list(dims or [1] * len(self._parallel_names))
        self._canon = [_AXIS_CANON.get(n, n) for n in self._parallel_names]

    def _axis(self, axis_name):
        return self._canon.index(_AXIS_CANON.get(axis_name, axis_name))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._axis(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return int(np.prod(self._dims))

    def get_rank(self, **coord):
        """The rank at the coordinate given by axis name."""
        return self.get_rank_from_coord(
            [coord[n] for n in self._parallel_names])

    def get_coord(self, rank):
        """The coordinate (one index an axis, in axis order) of
        ``rank``."""
        return tuple(int(i) for i in np.unravel_index(rank, self._dims))

    def get_rank_from_coord(self, coord):
        return int(np.ravel_multi_index(tuple(coord), self._dims))

    def get_axis_list(self, axis_name, index):
        """The ranks whose coordinate along ``axis_name`` is ``index``."""
        a = self._axis(axis_name)
        return [r for r in range(self.world_size())
                if self.get_coord(r)[a] == index]

    def get_comm_list(self, axis_name):
        """The groups along ``axis_name``: for every coordinate of the
        other axes (row-major), the ranks that differ only along it."""
        return self._comm_list([self._axis(axis_name)])

    def _comm_list(self, axes):
        """The groups spanning ``axes`` (indices): one list of ranks a
        coordinate of the other axes, ranks ascending."""
        others = [i for i in range(len(self._dims)) if i not in axes]
        out = []
        for fixed in itertools.product(*[range(self._dims[i])
                                         for i in others]):
            ranks = []
            for free in itertools.product(*[range(self._dims[i])
                                            for i in axes]):
                coord = [0] * len(self._dims)
                for i, v in zip(others, fixed):
                    coord[i] = v
                for i, v in zip(axes, free):
                    coord[i] = v
                ranks.append(self.get_rank_from_coord(coord))
            out.append(sorted(ranks))
        return out


class HybridCommunicateGroup:
    """The process's groups of the hybrid topology: one a axis (dp, pp,
    sharding, sep, mp) and the check group over every axis but dp (the
    global-norm clip's), with this process's rank and the group's first
    rank (``*_src_rank``) on each. Built from ``topology`` or, as the
    reference builds it, from ``hybrid_configs`` (degrees and
    ``order``)."""

    def __init__(self, topology=None, hybrid_configs=None):
        if topology is None:
            cfg = hybrid_configs or {}
            order = [_AXIS_CANON[a] for a in cfg.get("order", _ORDER)]
            degrees = {a: int(cfg.get(f"{a}_degree", 1)) for a in _ORDER}
            topology = CommunicateTopology([_LONG[a] for a in order],
                                           [degrees[a] for a in order])
        self._topo = topology
        names = [_AXIS_CANON[n] for n in topology.get_hybrid_group_names()]
        self._degrees = {a: 1 for a in _ORDER}
        self._degrees.update({a: topology.get_dim(a) for a in names})
        world = topology.world_size()
        if world != _env.get_world_size():
            raise ValueError(
                f"the hybrid degrees {self._degrees} make {world} ranks; "
                f"the job has {_env.get_world_size()}")
        self.global_rank = _env.get_rank()
        self._coord = dict(zip(names, topology.get_coord(self.global_rank)))
        self._groups = {}
        for a in names:
            self._groups[a] = self._build(
                [names.index(a)], self._degrees[a], a)
        for a in _ORDER:
            if a not in self._groups:
                self._groups[a] = _local_group(a)
        check = [i for i, a in enumerate(names) if a != "dp"]
        self._groups["check"] = self._build(
            check, world // self._degrees["dp"], "check")

    def _build(self, axes, size, name):
        """This rank's group spanning ``axes``: every group of the grid
        is created, in order, on every rank."""
        if size == 1:
            return _local_group(name)
        mine = None
        for ranks in self._topo._comm_list(axes):
            g = new_group(ranks)
            g._name = name
            if self.global_rank in ranks:
                mine = g
        return mine

    def topology(self):
        return self._topo

    @property
    def nranks(self):
        return self._topo.world_size()

    def get_global_rank(self):
        return self.global_rank

    # -- degrees -------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._degrees["dp"]

    def get_model_parallel_world_size(self):
        return self._degrees["mp"]

    get_num_of_all_model_parallel = get_model_parallel_world_size

    def get_pipe_parallel_world_size(self):
        return self._degrees["pp"]

    def get_sharding_parallel_world_size(self):
        return self._degrees["sharding"]

    def get_sep_parallel_world_size(self):
        return self._degrees["sep"]

    # -- this process's rank along each axis ---------------------------
    def get_data_parallel_rank(self):
        return self._coord.get("dp", 0)

    def get_model_parallel_rank(self):
        return self._coord.get("mp", 0)

    def get_pipe_parallel_rank(self):
        return self._coord.get("pp", 0)

    get_stage_id = get_pipe_parallel_rank

    def get_sharding_parallel_rank(self):
        return self._coord.get("sharding", 0)

    def get_sep_parallel_rank(self):
        return self._coord.get("sep", 0)

    # -- groups --------------------------------------------------------
    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sep_parallel_group(self):
        return self._groups["sep"]

    def get_check_parallel_group(self, sharding=False):
        return self._groups["check"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0]

    def get_sharding_parallel_group_src_rank(self):
        return self._groups["sharding"].ranks[0]

    def get_parallel_mode(self):
        """The reference's resolution order: pipeline, sharding, tensor,
        else data parallel."""
        if self._degrees["pp"] > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._degrees["sharding"] > 1:
            return ParallelMode.SHARDING_PARALLEL
        if self._degrees["mp"] > 1:
            return ParallelMode.TENSOR_PARALLEL
        return ParallelMode.DATA_PARALLEL


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


_HCG = []


def _set_hcg(hcg):
    _HCG[:] = [] if hcg is None else [hcg]


def get_hybrid_communicate_group():
    return _HCG[0] if _HCG else None
