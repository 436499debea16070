"""The launch plan of the port's RMSNorm and LayerNorm kernels
(``paddle_tpu_torch.ops.kernels.rms_norm.norm_launch_plan``), held on
the CPU without a card.

A Python model of ``csrc/rms_norm.cu``'s lane map (lane t of a row's
``threads`` holds the 16-byte vectors j * threads + t for j < vpl, and
masks those past the row; the scalar path strides elements by
``threads``) must cover every element of a row exactly once and read
nothing past it; the warp class's grid-stride walk must take every row
once. The class, VPL and threads per row are the ones the source's note
names, and VPL stays within the instantiations that the source's
launch switch has.
"""
import importlib
import re
from pathlib import Path

import pytest
import torch

# the module (the package's ``rms_norm`` is the function)
rn = importlib.import_module("paddle_tpu_torch.ops.kernels.rms_norm")
norm_launch_plan = rn.norm_launch_plan

SOURCE = (Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "ops"
          / "kernels" / "csrc" / "rms_norm.cu").read_text()

WIDTHS = [64, 100, 128, 768, 896, 1000, 1024, 2048, 4096, 4000, 8192, 13]
DTYPES = [torch.bfloat16, torch.float32]


def _per_vec(dtype):
    return 16 // dtype.itemsize


def _element_reads(plan, hidden, dtype):
    """{element: times read} of one row under ``plan``, as the kernels
    index it (norm_rows' load_vectors; the scalar kernels' loops)."""
    reads = {}
    if plan.kind == "scalar":
        for t in range(plan.threads):
            for i in range(t, hidden, plan.threads):
                reads[i] = reads.get(i, 0) + 1
        return reads
    n = _per_vec(dtype)
    nv = hidden // n
    for t in range(plan.threads):
        for j in range(plan.vpl):
            i = j * plan.threads + t
            if i < nv:  # masked past the row
                for e in range(i * n, i * n + n):
                    reads[e] = reads.get(e, 0) + 1
    return reads


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_lane_map_covers_each_element_once(hidden, dtype, aligned):
    plan = norm_launch_plan(hidden, dtype, aligned)
    reads = _element_reads(plan, hidden, dtype)
    assert sorted(reads) == list(range(hidden))  # nothing past the row
    assert set(reads.values()) == {1}
    if not aligned:
        assert plan.kind == "scalar"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_vpl_is_instantiated_and_needed(hidden, dtype):
    plan = norm_launch_plan(hidden, dtype, True)
    if plan.kind == "scalar":
        assert (plan.vpl, plan.threads, plan.rows_per_block) == (
            0, rn.SCALAR_THREADS, 1)
        return
    allowed = rn.WARP_VPL if plan.kind == "warp" else rn.BLOCK_VPL
    assert plan.vpl in allowed
    nv = hidden // _per_vec(dtype)
    # the row fits the lanes, and the last of a lane's vectors is used
    assert plan.vpl * plan.threads >= nv > (plan.vpl - 1) * plan.threads
    if plan.kind == "warp":
        assert (plan.threads, plan.rows_per_block) == (32, rn.WARP_ROWS)
    else:
        assert plan.threads % 32 == 0
        assert plan.threads <= rn.BLOCK_MAX_THREADS
        assert plan.rows_per_block == 1


# (hidden, dtype) -> (kind, vpl, threads): the classes of the source's
# note at the main path's widths and at the edges of each class
EXPECTED = [
    (896, torch.bfloat16, ("warp", 4, 32)),     # Qwen2-0.5B, tail masked
    (768, torch.bfloat16, ("warp", 3, 32)),     # GPT-2 / BERT-base
    (1000, torch.bfloat16, ("warp", 4, 32)),    # 125 vectors, tail masked
    (1024, torch.bfloat16, ("warp", 4, 32)),
    (64, torch.bfloat16, ("warp", 1, 32)),
    (4096, torch.bfloat16, ("block", 4, 128)),  # Llama-3-8B
    (4000, torch.bfloat16, ("block", 4, 128)),
    (2048, torch.bfloat16, ("block", 4, 64)),
    (8192, torch.bfloat16, ("block", 4, 256)),
    (16384, torch.bfloat16, ("block", 4, 512)),
    (100, torch.bfloat16, ("scalar", 0, 256)),  # 12.5 vectors
    (13, torch.bfloat16, ("scalar", 0, 256)),
    (16392, torch.bfloat16, ("scalar", 0, 256)),  # wider than 4 x 512
    (512, torch.float32, ("warp", 4, 32)),
    (100, torch.float32, ("warp", 1, 32)),
    (768, torch.float32, ("block", 3, 64)),
    (4096, torch.float32, ("block", 4, 256)),
    (13, torch.float32, ("scalar", 0, 256)),
]


@pytest.mark.parametrize("hidden,dtype,want", EXPECTED,
                         ids=[f"{h}-{d}" for h, d, _ in EXPECTED])
def test_class_vpl_and_threads(hidden, dtype, want):
    plan = norm_launch_plan(hidden, dtype, True)
    assert (plan.kind, plan.vpl, plan.threads) == want


def _source_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)
               .group(1))


def test_python_constants_match_the_source():
    """The plan's constants and VPL sets are the source's: the launch
    switch has a case for each VPL the plan can return, and no other."""
    assert _source_int("kWarpRows") == rn.WARP_ROWS
    assert _source_int("kBlockMaxThreads") == rn.BLOCK_MAX_THREADS
    assert _source_int("kScalarThreads") == rn.SCALAR_THREADS
    warp = {int(v) for v in re.findall(
        r"case (\d+): return launch_warp<kNorm, T, \1>", SOURCE)}
    block = {int(v) for v in re.findall(
        r"launch_vector<kNorm, T, (\d+), true>", SOURCE)}
    assert warp == set(rn.WARP_VPL)
    assert block == set(rn.BLOCK_VPL)
    kinds = dict(re.findall(r"k(Scalar|Warp|Block)Plan = (\d)", SOURCE))
    assert {k.lower(): int(v) for k, v in kinds.items()} == rn._KIND_CODES


@pytest.mark.parametrize("rows", [1, 7, 8, 9, 255, 2048, 16384])
@pytest.mark.parametrize("grid_cap", [None, 1, 3, 528])
def test_warp_class_walks_every_row_once(rows, grid_cap):
    """norm_rows' grid-stride walk takes every row once on launch_warp's
    grid (a block of 8 warps per 8 rows, one row a warp) and on any
    smaller grid (``grid_cap``, as the grid-stride ablation launches)."""
    blocks = -(-rows // rn.WARP_ROWS)
    grid = blocks if grid_cap is None else min(blocks, grid_cap)
    taken = []
    for block in range(grid):
        for warp in range(rn.WARP_ROWS):
            taken += range(block * rn.WARP_ROWS + warp, rows,
                           grid * rn.WARP_ROWS)
    assert sorted(taken) == list(range(rows))


def test_plan_args_send_an_unaligned_weight_to_the_scalar_path():
    x = torch.zeros(4, 896, dtype=torch.bfloat16)
    store = torch.zeros(897, dtype=torch.bfloat16)
    w = store[1:]  # starts 2 bytes past a 16-byte boundary
    assert w.data_ptr() % 16 != 0
    assert rn._plan_args(x, w) == (0, 0, rn.SCALAR_THREADS, 1)
    assert rn._plan_args(x, store[:896]) == (1, 4, 32, rn.WARP_ROWS)
    assert rn._plan_args(x, None, None) == (1, 4, 32, rn.WARP_ROWS)
