"""The port's collectives (``paddle_tpu_torch.distributed``, over
torch.distributed and gloo on the host) against the JAX package's, run
per rank inside a ``shard_map`` on its CPU mesh, as
``tests/test_collective_semantics.py`` runs them.

One ``spawn`` a world size (2 and 4 ranks) runs every case inside it
(``paddle_tpu_torch.testing.collective_rank_program``): every collective
on the world group, on ``new_group`` subgroups and on the hybrid
topology's axis groups, synchronously and asynchronously
(``sync_op=False`` and the task's ``wait()``), plus point-to-point and
object collectives on the world group. The reference runs the same
cases on the same per-rank inputs (integers as float32, so every
reduction is exact) on a mesh laid out as the port's ranks are: a
1-D ``x`` axis for the world group (and the 2-rank subgroups), and
(dp 2, mp 2) for the 4-rank subgroups ({0, 2} and {1, 3}, the dp axis)
and the topology's dp and mp groups.

Tolerance: exact equality. Where the reference is not per-rank
semantics, the port is held to numpy instead: ``broadcast`` (the
reference's single controller returns the tensor unchanged), a
``ReduceOp.PROD`` all-reduce and a MAX ``reduce_scatter`` (its manual
path sums for both), ``all_gather(axis=1)`` (the reference stacks at 0
only), the point-to-point and object collectives (the reference has no
per-rank ``send``/``recv``).
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.distributed as pdist
from paddle_tpu.distributed.mesh import (build_global_mesh, manual_axes,
                                         reset_mesh, shard_map)
from paddle_tpu.framework.core import Tensor

from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.testing import (COLLECTIVE_OPS, collective_input,
                                      collective_rank_program)

WORLDS = (2, 4)
# group label -> the reference mesh axis it is (by world size)
AXES = {2: {"world": "x", "sub": "x", "mp": "x"},
        4: {"world": "x", "sub": "dp", "dp": "dp", "mp": "mp"}}
NUMPY_ONLY = ("all_reduce_PROD", "stream_all_reduce_PROD", "broadcast",
              "reduce_scatter_MAX", "all_gather_axis1")


@pytest.fixture(scope="module")
def port():
    """{world: [each rank's results]}: one spawn a world size."""
    return {w: spawn(collective_rank_program, nprocs=w) for w in WORLDS}


def _reference_cases(x, g, n):
    """The reference's per-rank results of the cases the port names
    (those not in NUMPY_ONLY), inside a manual region over g's axis."""
    P2POp, isend, irecv = pdist.P2POp, pdist.isend, pdist.irecv
    out = {}
    for name in COLLECTIVE_OPS:
        if name == "PROD":
            continue
        a = Tensor(x)
        pdist.all_reduce(a, getattr(pdist.ReduceOp, name), group=g)
        out[f"all_reduce_{name}"] = out[f"stream_all_reduce_{name}"] = \
            a._data
    a = Tensor(x)
    pdist.reduce(a, 0, pdist.ReduceOp.SUM, group=g)
    out["reduce_SUM"] = a._data
    lst = []
    pdist.all_gather(lst, Tensor(x), group=g)
    out["all_gather_list"] = jnp.stack([t._data for t in lst])
    out["all_gather_axis0"] = pdist.all_gather(None, Tensor(x), group=g)._data
    out["all_gather_into_tensor"] = out["all_gather_axis0"].reshape(
        (n * x.shape[0],) + x.shape[1:])
    lst = []
    pdist.gather(Tensor(x), lst, dst=0, group=g)
    out["gather"] = jnp.stack([t._data for t in lst])
    pieces = [Tensor(x * (i + 1)) for i in range(n)]
    o = Tensor(jnp.zeros(x.shape))
    pdist.reduce_scatter(o, pieces, group=g)
    out["reduce_scatter_SUM"] = o._data
    o = Tensor(jnp.zeros(x.shape))
    pdist.reduce_scatter(o, Tensor(jnp.concatenate([p._data for p in pieces])),
                         group=g)
    out["reduce_scatter_tensor_SUM"] = o._data
    o = Tensor(jnp.zeros(x.shape))
    pdist.scatter(o, pieces, src=n - 1, group=g)
    out["scatter"] = o._data
    lst = []
    pdist.alltoall(lst, pieces, group=g)
    out["alltoall"] = jnp.stack([t._data for t in lst])
    o = Tensor(jnp.zeros((n * x.shape[0],) + x.shape[1:]))
    pdist.alltoall_single(o, Tensor(jnp.concatenate([p._data
                                                     for p in pieces])),
                          group=g)
    out["alltoall_single"] = o._data
    ring = [(i, (i + 1) % n) for i in range(n)]
    out["ppermute_ring"] = pdist.collective.ppermute(Tensor(x), ring,
                                                     group=g)._data
    buf = Tensor(jnp.zeros(x.shape))
    pdist.batch_isend_irecv([P2POp(isend, Tensor(x), 1, g),
                             P2POp(irecv, buf, 1, g)])
    out["batch_isend_irecv_ring"] = buf._data
    out["wait"] = x
    return out


def _run_reference(world):
    """{group label: {case: [per-rank array]}} of the reference."""
    xs = np.stack([collective_input(r) for r in range(world)])
    labels = AXES[world]
    if world == 2:
        names, dims, groups = ("x",), (2,), {"x": ("x",)}
    else:
        names, dims = ("dp", "mp"), (2, 2)
        groups = {"dp": ("dp",), "mp": ("mp",)}
    results = {}
    for mesh_names, mesh_dims, axes in (
            [(("x",), (world,), {"x": ("x",)})]
            + ([] if world == 2 else [(names, dims, groups)])):
        reset_mesh()
        mesh = build_global_mesh(mesh_names, mesh_dims)
        keys = []

        def body(xl):
            with manual_axes(mesh_names):
                outs = {}
                for ax, axis_names in axes.items():
                    g = pdist.new_group(axis_names=axis_names)
                    size = mesh.shape[ax]
                    for k, v in _reference_cases(xl[0], g, size).items():
                        outs[(ax, k)] = v
                keys[:] = sorted(outs)
                return tuple(outs[k][None] for k in keys)

        spec = jax.sharding.PartitionSpec(mesh_names)
        fn = shard_map(body, mesh=mesh, in_specs=(spec,),
                       out_specs=spec)
        outs = fn(jnp.asarray(xs))
        for (ax, case), arr in zip(keys, outs):
            results.setdefault(ax, {})[case] = np.asarray(arr)
        reset_mesh()
    return {label: results[ax] for label, ax in labels.items()}


@pytest.fixture(scope="module")
def reference():
    return {w: _run_reference(w) for w in WORLDS}


def _members(world, label, rank):
    """The global ranks of ``rank``'s group ``label``."""
    if label == "world" or (world == 2):
        return list(range(world))
    if label in ("sub", "dp"):
        return [rank % 2, rank % 2 + 2]
    return [rank - rank % 2, rank - rank % 2 + 1]


def _numpy_expected(world, label, rank, case):
    members = _members(world, label, rank)
    xs = [collective_input(r) for r in members]
    me = members.index(rank)
    if case.endswith("PROD"):
        return np.prod(xs, axis=0)
    if case == "broadcast":
        return xs[-1]
    if case == "reduce_scatter_MAX":
        return np.max([x * (me + 1) for x in xs], axis=0)
    if case == "all_gather_axis1":
        return np.stack(xs, axis=1)
    raise KeyError(case)


@pytest.mark.parametrize("world", WORLDS)
def test_every_collective_matches_the_reference_per_rank(port, reference,
                                                         world):
    checked = 0
    for rank, res in enumerate(port[world]):
        for label in AXES[world]:
            cases = res[label]
            for case, got in cases.items():
                base = case.rsplit("_", 1)[0] if case.endswith(
                    ("_sync", "_async")) else case
                if base in NUMPY_ONLY:
                    want = _numpy_expected(world, label, rank, base)
                else:
                    want = reference[world][label][base][rank]
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{world}:{rank}:{label}:{case}")
                checked += 1
    # 23 collectives (each sync and async) and 3 more a group, every rank
    assert checked == world * len(AXES[world]) * (2 * 23 + 3)


@pytest.mark.parametrize("world", WORLDS)
def test_point_to_point_and_objects(port, world):
    res = port[world]
    np.testing.assert_array_equal(res[0]["p2p"], collective_input(1))
    np.testing.assert_array_equal(res[1]["p2p"], collective_input(0))
    want = [{"rank": r, "x": float(collective_input(r).sum())}
            for r in range(world)]
    for rank, r in enumerate(res):
        objs = r["objects"]
        assert objs["all_gather"] == want
        assert objs["broadcast"] == [1, "r1"]
        assert objs["scatter"] == [{"to": rank}]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_and_hybrid_groups_are_the_processes_own(port, world):
    """``get_rank`` is the process's rank (the reference's is always 0),
    and the topology's groups and axis ranks are its real ones."""
    for rank, r in enumerate(port[world]):
        env = r["env"]
        assert (env["rank"], env["env_rank"], env["local_rank"]) == \
            (rank, rank, rank)
        assert env["world"] == env["nranks"] == world
        assert env["mode"] == 1  # ParallelMode.TENSOR_PARALLEL
        if world == 2:
            want = {"data_parallel": [rank], "model_parallel": [0, 1],
                    "check_parallel": [0, 1]}
            assert (env["dp_rank"], env["mp_rank"]) == (0, rank)
        else:
            mp = [rank - rank % 2, rank - rank % 2 + 1]
            want = {"data_parallel": [rank % 2, rank % 2 + 2],
                    "model_parallel": mp, "check_parallel": mp}
            assert (env["dp_rank"], env["mp_rank"]) == (rank // 2, rank % 2)
        assert env["groups"] == want


# -- the launcher, the environment contract, init_parallel_env -------------

ROOT = pathlib.Path(__file__).resolve().parents[1]
_JOB = """
import os, sys
import torch
from paddle_tpu_torch import distributed as D

env = D.ParallelEnv()
D.init_parallel_env(device="cpu")
if sys.argv[1] == "fail" and D.get_rank() == 1:
    sys.exit(3)
x = torch.full((2,), float(D.get_rank() + 1))
D.all_reduce(x)
port = os.environ["PADDLE_MASTER"].rpartition(":")[2]
jax = [m for m in sys.modules if m in ("jax", "paddle_tpu")
       or m.startswith(("jax.", "paddle_tpu."))]
print("RESULT", D.get_rank(), D.get_world_size(), env.local_rank,
      env.current_endpoint, port == os.environ["MASTER_PORT"], x.tolist(),
      jax, flush=True)
"""


def _launch(tmp_path, mode):
    script = tmp_path / "job.py"
    script.write_text(_JOB)
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--log_dir", str(tmp_path / mode),
         str(script), mode], cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    return out, time.monotonic() - t0


def test_launcher_starts_a_process_a_rank_in_both_env_contracts(tmp_path):
    out, _ = _launch(tmp_path, "ok")
    assert out.returncode == 0, out.stderr
    for rank in range(2):
        log = (tmp_path / "ok" / f"workerlog.{rank}").read_text()
        got = [line for line in log.splitlines()
               if line.startswith("RESULT")]
        assert got == [f"RESULT {rank} 2 {rank} 127.0.0.1:{6070 + rank} "
                       "True [3.0, 3.0] []"], log


def test_launcher_stops_the_others_when_a_rank_fails(tmp_path):
    """Rank 1 exits with 3; rank 0 waits in an all-reduce that never
    completes. The launcher stops it and exits with 3."""
    out, took = _launch(tmp_path, "fail")
    assert out.returncode == 3, out.stderr
    assert "workerlog.1" in out.stderr
    assert took < 120


_ENV_NAMES = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
              "PADDLE_CURRENT_ENDPOINT", "PADDLE_TRAINER_ENDPOINTS",
              "PADDLE_MASTER", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "MASTER_ADDR", "MASTER_PORT", "FLAGS_selected_gpus",
              "PADDLE_DISTRI_BACKEND")


@pytest.fixture()
def clean_env(monkeypatch):
    for name in _ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_env_contract_reads_both_launchers(clean_env):
    """Without a launcher: rank 0 of 1, no store. torch's names are
    read, and the reference's win where both are set."""
    from paddle_tpu_torch.distributed import ParallelEnv
    from paddle_tpu_torch.distributed import env as E

    assert (E.env_rank(), E.env_world_size(), E.env_local_rank(),
            E.env_master()) == (0, 1, 0, None)
    for name, value in (("RANK", "3"), ("WORLD_SIZE", "4"),
                        ("LOCAL_RANK", "1"), ("MASTER_ADDR", "h"),
                        ("MASTER_PORT", "29500")):
        clean_env.setenv(name, value)
    assert (E.env_rank(), E.env_world_size(), E.env_local_rank(),
            E.env_master()) == (3, 4, 1, ("h", 29500))
    for name, value in (("PADDLE_TRAINER_ID", "2"),
                        ("PADDLE_TRAINERS_NUM", "8"),
                        ("PADDLE_MASTER", "10.0.0.1:6170"),
                        ("PADDLE_CURRENT_ENDPOINT", "10.0.0.2:6072"),
                        ("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2"),
                        ("FLAGS_selected_gpus", "5")):
        clean_env.setenv(name, value)
    env = ParallelEnv()
    assert (env.rank, env.world_size, env.nranks, env.local_rank,
            env.dev_id) == (2, 8, 8, 1, 5)
    assert env.current_endpoint == "10.0.0.2:6072"
    assert env.trainer_endpoints == ["a:1", "b:2"]
    assert E.env_master() == ("10.0.0.1", 6170)


def test_init_parallel_env_never_switches_backend_or_device(clean_env):
    """The card by default: without CUDA it raises, never falling back to
    gloo on the host; NCCL on the CPU and an unknown backend raise before
    anything is bound. ``device="cpu"`` joins a world of one over gloo."""
    import torch.distributed as dist

    import paddle_tpu_torch.device as device
    from paddle_tpu_torch import distributed as D

    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    clean_env.setattr(device, "_current", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.init_parallel_env()
    clean_env.setenv("PADDLE_DISTRI_BACKEND", "nccl")
    with pytest.raises(ValueError, match="nccl"):
        D.init_parallel_env(device="cpu")
    clean_env.setenv("PADDLE_DISTRI_BACKEND", "mpi")
    with pytest.raises(ValueError, match="mpi"):
        D.init_parallel_env(device="cpu")
    assert not dist.is_initialized() and device._current is None
    clean_env.delenv("PADDLE_DISTRI_BACKEND")
    try:
        env = D.init_parallel_env(device="cpu")
        assert dist.get_backend() == "gloo"
        assert (env.rank, env.world_size) == (0, 1)
        assert device._current == torch.device("cpu")
        x = torch.full((2,), 3.0)
        D.all_reduce(x, D.ReduceOp.AVG)
        assert x.tolist() == [3.0, 3.0]
    finally:
        D.destroy_process_group()
    assert not dist.is_initialized()
