"""The port's hybrid topology (``fleet/base/topology.py``) against the
reference's mesh: a rank is the row-major index of its coordinate, as
``build_global_mesh(order, dims)`` lays ``jax.devices()`` out, so the
rank at every coordinate is the id of the mesh's device there, and the
members of every axis group are the ids of the devices along that axis.

``CommunicateTopology`` is checked in this process for every order and
degree grid below. ``HybridCommunicateGroup`` builds real gloo groups:
one ``spawn`` of 4 ranks builds it for every grid of 4 ranks and
reports each rank's groups, which must be the mesh's, and its rank
along each axis, which must be its coordinate. Tolerance: exact.
"""
import numpy as np
import pytest

from paddle_tpu.distributed.mesh import build_global_mesh, reset_mesh

from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.fleet import (CommunicateTopology,
                                                HybridCommunicateGroup,
                                                ParallelMode)
from paddle_tpu_torch.testing import topology_rank_program

DEFAULT = ["dp", "pp", "sharding", "sep", "mp"]
ORDERS = [DEFAULT, ["mp", "dp", "pp", "sharding", "sep"],
          ["pp", "sep", "mp", "sharding", "dp"]]
DEGREES = [{"dp": 2, "mp": 2}, {"dp": 2, "pp": 2, "mp": 2},
           {"sharding": 2, "sep": 2}, {"dp": 4}, {"mp": 4, "dp": 2},
           {"pp": 2, "mp": 2}, {"mp": 4}]
GRIDS = [(o, d) for o in ORDERS for d in DEGREES]
LONG = {"dp": "data", "pp": "pipe", "sharding": "sharding", "sep": "sep",
        "mp": "model"}


def _mesh_ids(order, degrees):
    """The reference mesh's device ids, [degree of each axis of order]."""
    reset_mesh()
    try:
        mesh = build_global_mesh(order, [degrees.get(a, 1) for a in order])
        return np.vectorize(lambda d: d.id)(mesh.devices)
    finally:
        reset_mesh()


def _mesh_groups(ids, order, axis):
    """The reference's groups along ``axis``: the device ids along it,
    one list a coordinate of the other axes (row-major)."""
    a = order.index(axis)
    return np.moveaxis(ids, a, -1).reshape(-1, ids.shape[a]).tolist()


def _topology(order, degrees):
    return CommunicateTopology([LONG[a] for a in order],
                               [degrees.get(a, 1) for a in order])


@pytest.mark.parametrize("order,degrees", GRIDS,
                         ids=[f"{'-'.join(o)}:{d}" for o, d in GRIDS])
def test_rank_at_every_coordinate_and_every_axis_group(order, degrees):
    ids = _mesh_ids(order, degrees)
    topo = _topology(order, degrees)
    assert topo.world_size() == ids.size
    for coord in np.ndindex(ids.shape):
        rank = topo.get_rank_from_coord(coord)
        assert rank == ids[coord]
        assert topo.get_coord(rank) == coord
        assert topo.get_rank(**{LONG[a]: c for a, c in zip(order, coord)}) \
            == rank
    for axis in order:
        want = _mesh_groups(ids, order, axis)
        assert topo.get_comm_list(axis) == want
        assert topo.get_comm_list(LONG[axis]) == want
        for i in range(degrees.get(axis, 1)):
            assert topo.get_axis_list(axis, i) == sorted(
                np.take(ids, i, axis=order.index(axis)).ravel().tolist())


def test_world_of_one_without_a_process_group():
    hcg = HybridCommunicateGroup(hybrid_configs={})
    assert hcg.nranks == 1 and hcg.get_parallel_mode() == \
        ParallelMode.DATA_PARALLEL
    for g in (hcg.get_data_parallel_group(), hcg.get_model_parallel_group(),
              hcg.get_check_parallel_group()):
        assert g.ranks == [0] and g.rank == 0 and g.process_group is None
    with pytest.raises(ValueError, match="ranks"):
        HybridCommunicateGroup(hybrid_configs={"mp_degree": 2})


FOUR = [(o, d) for o, d in GRIDS if int(np.prod(list(d.values()))) == 4]


@pytest.fixture(scope="module")
def four_ranks():
    return spawn(topology_rank_program, args=(FOUR,), nprocs=4)


@pytest.mark.parametrize("index", range(len(FOUR)),
                         ids=[f"{'-'.join(o)}:{d}" for o, d in FOUR])
def test_hybrid_groups_are_the_mesh_axes(four_ranks, index):
    order, degrees = FOUR[index]
    ids = _mesh_ids(order, degrees)
    mode = (ParallelMode.PIPELINE_PARALLEL if degrees.get("pp", 1) > 1 else
            ParallelMode.SHARDING_PARALLEL if degrees.get("sharding", 1) > 1
            else ParallelMode.TENSOR_PARALLEL if degrees.get("mp", 1) > 1
            else ParallelMode.DATA_PARALLEL)
    for rank in range(4):
        got = four_ranks[rank][index]
        coord = dict(zip(order, np.argwhere(ids == rank)[0]))
        assert got["ranks"] == {a: int(coord[a]) for a in DEFAULT}
        for axis in DEFAULT:
            mine = [g for g in _mesh_groups(ids, order, axis) if rank in g]
            assert got["groups"][axis] == mine[0]
        # check group: every axis but dp, the ranks sharing rank's dp index
        dp = order.index("dp")
        check = np.take(ids, coord["dp"], axis=dp).ravel().tolist()
        assert got["groups"]["check"] == sorted(check)
        assert got["src"] == (got["groups"]["dp"][0],
                              got["groups"]["mp"][0])
        assert got["mode"] == mode
