"""Tensor and data parallelism of the port (``fleet``, the mp layers,
the vocab-parallel CE head, ``LlamaForCausalLM`` at mp > 1,
``DataParallel``, ``HybridParallelOptimizer``) against the JAX package
on its 8-device CPU mesh, and against the port's own single-rank run.

The port's ranks run over gloo on the host, one ``spawn`` a world size
(2 and 4), every case inside it
(``paddle_tpu_torch.testing.tensor_parallel_rank_program``):

- each mp layer at mp 2 (``VocabParallelEmbedding``,
  ``ColumnParallelLinear`` with and without ``gather_output``,
  ``RowParallelLinear`` with a parallel and a whole input,
  ``ParallelCrossEntropy``) from the same whole weights as the
  reference's layer on a mesh with ``mp_degree=2``: each rank's output
  and gradients against the matching slices of the reference's;
- the vocab-parallel fused head against the reference's
  ``fused_linear_cross_entropy_vocab_parallel`` (mean and sum, ignored
  labels, a chunk that does not divide the rank's rows);
- 3 AdamW steps of ``llama_tiny`` (head_dim 32; untied without
  ``attention_bias``, tied with it) under mp2 (with a
  ``ClipGradByGlobalNorm`` that clips, through
  ``distributed_optimizer``), dp2 and dp2 x mp2, the unfused criterion
  (``ParallelCrossEntropy``) and recompute at mp2: each rank's losses,
  step-1 gradients and gathered parameters against the reference's run
  of the same grid and against the port's single-rank run, the clip's
  norms against the reference's global norm, and the replicated
  parameters bit for bit equal over mp;
- each unported option raising ``NotImplementedError``.

The dp runs take each rank's rows of the global batch, with one ignored
label a rank: the average of the ranks' means is then the reference's
global mean (with unequal counts it is not; ROADMAP queue 3).

Tolerances (float32; products and all-reduces sum in another order):
layer outputs and gradients within 1e-5 of the largest entry; the head's
loss within 1e-6 relative, its gradients within 1e-5 of the largest
entry; losses within 1e-5 relative and norms within 1e-5 relative on
every step; step-1 gradients within 1e-5 of each one's largest entry
(against the single-rank run); each parameter's update over the 3 steps
within 1e-3 relative L2 (Adam divides by the root of the second moment,
so an entry whose gradient is ~0 can move by up to the rate on a
rounding difference: an entry-wise bound would be the rate itself).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.optimizer as jax_optim
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.layers import mpu as jmpu
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_tiny as jax_tiny
from paddle_tpu.ops.kernels.fused_loss import \
    fused_linear_cross_entropy_vocab_parallel as jax_vp_head

from conftest import reset_dist_state

from paddle_tpu_torch.distributed import fleet, spawn
from paddle_tpu_torch.distributed.launch.main import launch
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.testing import tensor_parallel_rank_program

B, S, STEPS, LR, CLIP = 4, 16, 3, 1e-3, 0.5
UPDATE_RTOL = 1e-3
CONFIGS = {
    "untied": dict(fused_head_loss=True),
    "tied_bias": dict(fused_head_loss=True, tie_word_embeddings=True,
                      attention_bias=True),
    "unfused": dict(fused_head_loss=False),
    "recompute": dict(fused_head_loss=True, recompute=True),
}
# (config, grid (dp, mp), clip) of each training run, by world size
RUNS = {2: [("untied", (1, 2), CLIP), ("tied_bias", (1, 2), CLIP),
            ("unfused", (1, 2), CLIP), ("recompute", (1, 2), CLIP),
            ("untied", (2, 1), None), ("tied_bias", (2, 1), None)],
        4: [("untied", (2, 2), CLIP), ("tied_bias", (2, 2), None)]}


def _rng(seed):
    return np.random.RandomState(seed)


# -- mp layer cases --------------------------------------------------------

def _layer_cases():
    r = _rng(0)
    f = np.float32
    cases = []
    v, h, i = 64, 16, 24
    ids = r.randint(0, v, size=(3, 5))
    cases.append({"layer": "embedding", "shape": (v, h),
                  "weights": {"weight": r.randn(v, h).astype(f)},
                  "x": ids, "cot": r.randn(3, 5, h).astype(f)})
    for gather in (True, False):
        cases.append({"layer": "column", "shape": (h, i),
                      "kwargs": {"gather_output": gather, "has_bias": True},
                      "weights": {"weight": r.randn(h, i).astype(f),
                                  "bias": r.randn(i).astype(f)},
                      "x": r.randn(3, 5, h).astype(f),
                      "cot": r.randn(3, 5, i).astype(f)})
    for parallel in (True, False):
        cases.append({"layer": "row", "shape": (i, h),
                      "kwargs": {"input_is_parallel": parallel,
                                 "has_bias": True},
                      "weights": {"weight": r.randn(i, h).astype(f),
                                  "bias": r.randn(h).astype(f)},
                      "x": r.randn(3, 5, i).astype(f),
                      "cot": r.randn(3, 5, h).astype(f)})
    labels = r.randint(0, v, size=(3, 5))
    labels[0, 1] = -100
    cases.append({"layer": "ce", "x": (r.randn(3, 5, v) * 2).astype(f),
                  "labels": labels, "cot": r.randn(3, 5).astype(f)})
    return cases


def _head_cases():
    r = _rng(1)
    out = []
    for reduction, chunk in (("mean", 12), ("sum", 32)):
        labels = r.randint(0, 96, size=(2, 8))
        labels[1, 2] = labels[0, 7] = -100
        out.append({"h": (r.randn(2, 8, 16) * 0.5).astype(np.float32),
                    "w": (r.randn(96, 16) * 0.3).astype(np.float32),
                    "labels": labels, "chunk": chunk,
                    "reduction": reduction,
                    "cot": np.float32(r.rand() + 0.5)})
    return out


# -- training runs ---------------------------------------------------------

def _batch():
    r = _rng(2)
    x = r.randint(0, 512, size=(B, S))
    y = r.randint(0, 512, size=(B, S))
    y[0, 5] = y[2, 9] = -100  # one ignored label a dp rank's rows
    return x, y


_STATES = {}


def _state(name):
    """The reference model's whole weights (numpy) for config ``name``."""
    if name not in _STATES:
        paddle.seed(11)
        jm = JaxLlama(jax_tiny(**CONFIGS[name]))
        _STATES[name] = {k: np.asarray(v._data)
                         for k, v in jm.state_dict().items()}
    return _STATES[name]


def _run_spec(name, grid, clip):
    return {"config": CONFIGS[name], "grid": grid, "clip": clip,
            "state": _state(name), "batch": _batch(), "steps": STEPS,
            "lr": LR}


_REFERENCE_RUNS = {}


def _reference_run(name, grid, clip):
    """The reference's run of the same grid, its step under
    ``jit.to_static`` (as ``tests/test_hybrid_equivalence.py`` runs
    it): the losses, each step's global gradient norm and the final
    parameters (one run a grid, kept)."""
    key = (name, grid, clip)
    if key not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[key] = _reference_grid_run(name, grid, clip)
    return _REFERENCE_RUNS[key]


def _reference_grid_run(name, grid, clip):
    reset_dist_state()
    dp, mp = grid
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        jm = JaxLlama(jax_tiny(**CONFIGS[name]))
        state = _state(name)
        for n, p in jm.named_parameters():
            p.set_value(state[n])
        opt = jax_optim.AdamW(
            LR, parameters=jm.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(clip) if clip else None)
        model = jfleet.distributed_model(jm)
        opt = jfleet.distributed_optimizer(opt)
        params = list(jm.parameters())

        @paddle.jit.to_static
        def step(x, y):
            _, loss = model(x, y)
            loss.backward()
            norm_sq = (params[0].grad * params[0].grad).sum()
            for p in params[1:]:
                norm_sq = norm_sq + (p.grad * p.grad).sum()
            opt.step()
            opt.clear_grad()
            return loss, norm_sq

        x, y = _batch()
        losses, norms = [], []
        for _ in range(STEPS):
            loss, norm_sq = step(paddle.to_tensor(x.astype("int32")),
                                 paddle.to_tensor(y.astype("int64")))
            losses.append(float(np.asarray(loss._data)))
            norms.append(float(np.sqrt(np.asarray(norm_sq._data))))
        final = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    finally:
        reset_dist_state()
    return {"losses": losses, "norms": norms, "params": final}


def _single_run(name, clip):
    """The port's single-rank run (no process group) from the same
    weights."""
    model = LlamaForCausalLM(llama_tiny(**CONFIGS[name]), device="cpu")
    model.load_reference_state(_state(name))
    opt = AdamW(LR, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    x, y = (torch.from_numpy(a) for a in _batch())
    losses, grads = [], None
    for _ in range(STEPS):
        _, loss = model(x, y)
        loss.backward()
        grads = grads or {n: p.grad.numpy().copy()
                          for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": grads,
            "params": {n: p.detach().numpy() for n, p in
                       model.named_parameters()}}


@pytest.fixture(scope="module")
def port():
    """{world: [each rank's results]}: one spawn a world size."""
    out = {}
    for world, runs in RUNS.items():
        specs = [_run_spec(*r) for r in runs]
        two = world == 2
        out[world] = spawn(tensor_parallel_rank_program, nprocs=world,
                           args=(_layer_cases() if two else (),
                                 _head_cases() if two else (), specs, two))
    return out


# -- the mp layers ---------------------------------------------------------

def _slice(a, split):
    """The slice ``split`` = (dim, n, r) of the whole array ``a``."""
    if split is None:
        return a
    dim, n, r = split
    size = a.shape[dim] // n
    return np.take(a, range(r * size, (r + 1) * size), axis=dim)


def _reference_layer(case):
    """(out, {grad name: whole gradient}) of the reference's layer at mp 2
    from the case's whole weights."""
    kind, kw = case["layer"], dict(case.get("kwargs", {}))
    x = paddle.to_tensor(case["x"], stop_gradient=not np.issubdtype(
        case["x"].dtype, np.floating))
    if kind == "ce":
        layer = jmpu.ParallelCrossEntropy()
        out = layer(x, paddle.to_tensor(case["labels"]))
    else:
        cls = {"embedding": jmpu.VocabParallelEmbedding,
               "column": jmpu.ColumnParallelLinear,
               "row": jmpu.RowParallelLinear}[kind]
        layer = cls(*case["shape"], **kw)
        for n, p in layer.named_parameters():
            p.set_value(case["weights"][n])
        out = layer(x)
    cot = case["cot"].reshape(out.shape)
    (out * paddle.to_tensor(cot)).sum().backward()
    grads = {"x": x.grad}
    if kind != "ce":
        grads.update({n: p.grad for n, p in layer.named_parameters()})
    return np.asarray(out._data), {k: np.asarray(v._data)
                                   for k, v in grads.items()
                                   if v is not None}


def test_mp_layers_match_the_reference_slice_by_slice(port):
    cases = _layer_cases()
    reset_dist_state()
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        refs = [_reference_layer(c) for c in cases]
    finally:
        reset_dist_state()
    for rank in range(2):
        last = (-1, 2, rank)
        for case, (out, grads), got in zip(cases, refs,
                                           port[2][rank]["layers"]):
            kind, kw = case["layer"], case.get("kwargs", {})
            local_out = kind == "column" and not kw.get("gather_output",
                                                        True)
            local_in = kind == "ce" or (kind == "row"
                                        and kw.get("input_is_parallel"))
            want = _slice(out, last if local_out else None)
            tol = 1e-5 * np.abs(want).max()
            np.testing.assert_allclose(got["out"].reshape(want.shape), want,
                                       atol=tol, err_msg=kind)
            splits = {"x": last if local_in else None,
                      "weight": {"embedding": (0, 2, rank),
                                 "column": (1, 2, rank),
                                 "row": (0, 2, rank)}.get(kind),
                      "bias": (0, 2, rank) if kind == "column" else None}
            assert set(got["grads"]) == set(grads), kind
            for name, g in grads.items():
                want = _slice(g, splits[name])
                np.testing.assert_allclose(
                    got["grads"][name], want,
                    atol=1e-5 * np.abs(want).max(), err_msg=f"{kind} {name}")


def test_vocab_parallel_head_matches_the_reference(port):
    reset_dist_state()
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        for i, case in enumerate(_head_cases()):
            def f(h, w, case=case):
                return jax_vp_head(h, w, jnp.asarray(case["labels"]),
                                   chunk=case["chunk"],
                                   reduction=case["reduction"])
            loss, vjp = jax.vjp(f, jnp.asarray(case["h"]),
                                jnp.asarray(case["w"]))
            dh, dw = (np.asarray(a) for a in vjp(jnp.float32(case["cot"])))
            for rank in range(2):
                got = port[2][rank]["heads"][i]
                assert float(got["loss"]) == pytest.approx(
                    float(loss), rel=1e-6)
                np.testing.assert_allclose(got["dh"], dh,
                                           atol=1e-5 * np.abs(dh).max())
                want = _slice(dw, (0, 2, rank))
                np.testing.assert_allclose(got["dw"], want,
                                           atol=1e-5 * np.abs(want).max())
    finally:
        reset_dist_state()


# -- training --------------------------------------------------------------

ALL_RUNS = [(w, i) for w, runs in RUNS.items() for i in range(len(runs))]


def _ids(w, i):
    name, grid, clip = RUNS[w][i]
    return f"{name}-dp{grid[0]}mp{grid[1]}{'-clip' if clip else ''}"


@pytest.mark.parametrize("world,index", ALL_RUNS,
                         ids=[_ids(w, i) for w, i in ALL_RUNS])
def test_training_matches_the_reference_grid_and_the_single_rank(
        port, world, index):
    name, grid, clip = RUNS[world][index]
    # the unfused criterion and recompute compute the untied step's
    # function: held to its reference run
    ref = _reference_run("untied" if name in ("unfused", "recompute")
                         else name, grid, clip)
    single = _single_run(name, clip)
    init = _state(name)
    for rank in range(world):
        got = port[world][rank]["runs"][index]
        for want in (ref, single):
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=1e-5)
            for n, p in want["params"].items():
                # the update of 3 steps, relative L2
                step, want_step = got["params"][n] - init[n], p - init[n]
                err = np.linalg.norm(step - want_step) / np.linalg.norm(
                    want_step)
                assert err <= UPDATE_RTOL, (n, err)
        assert got["losses"][-1] < got["losses"][0]
        if clip:
            # the whole model's norm, and the clip acts
            np.testing.assert_allclose(got["norms"], ref["norms"],
                                       rtol=1e-5)
            assert min(got["norms"]) > clip
        for n, g in single["grads"].items():
            np.testing.assert_allclose(got["grads"][n], g,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=n)
        assert got["replicated_equal"]
        assert (got["dp_rank"], got["mp_rank"]) == (rank // grid[1],
                                                    rank % grid[1])


# -- what is not ported ----------------------------------------------------

def test_unported_options_raise(port):
    refused = port[2][0]["refusals"]
    assert refused == port[2][1]["refusals"]
    missing = [k for k, v in refused.items() if v is None]
    assert not missing, missing
    assert "heads over 2 mp ranks" in refused["num_kv_heads_mod_mp"]
    assert "not ported" in refused["collective_matmul_on"]
    for key in ("sharding_degree", "pp_degree", "sep_degree", "ep_degree"):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {key: 2}
        with pytest.raises(NotImplementedError, match=key):
            fleet.init(is_collective=True, strategy=strategy)
    for argv in (["--nnodes", "2", "x.py"], ["--max_restart", "1", "x.py"],
                 ["--master", "10.0.0.1:1234", "x.py"]):
        with pytest.raises(NotImplementedError):
            launch(argv)


# -- DataParallel, broadcast_input_data, the RNG tracker --------------------

def test_data_parallel_broadcasts_then_averages_unless_no_sync(port):
    """Rank r's Linear is seeded with r: after ``DataParallel`` both hold
    rank 0's parameters. Passes on all-(r + 1 + i) inputs give dW = 4 x a
    pass (4 rows) and db = 4: two under ``no_sync`` stay this rank's
    sums, the third ends in the average over the ranks of the
    accumulated sums. Exact (small integers in float32)."""
    torch.manual_seed(0)
    want = {n: p.detach().numpy() for n, p in
            torch.nn.Linear(3, 2).named_parameters()}
    for rank in range(2):
        got = port[2][rank]["data_parallel"]
        for n, w in want.items():
            np.testing.assert_array_equal(got["weights"][n], w)
        local = 4.0 * ((rank + 1) + (rank + 2))
        np.testing.assert_array_equal(got["local"]["weight"],
                                      np.full((2, 3), local, np.float32))
        np.testing.assert_array_equal(got["local"]["bias"],
                                      np.full(2, 8.0, np.float32))
        summed = [4.0 * ((r + 1) + (r + 2) + (r + 3)) for r in range(2)]
        np.testing.assert_array_equal(
            got["synced"]["weight"],
            np.full((2, 3), sum(summed) / 2, np.float32))
        np.testing.assert_array_equal(got["synced"]["bias"],
                                      np.full(2, 12.0, np.float32))
        # broadcast_input_data: tensors are rank 0's, the rest passes
        np.testing.assert_array_equal(got["inputs"][0], np.zeros(2))
        assert got["inputs"][1] == rank
        np.testing.assert_array_equal(got["key"], [10.0])


def test_rng_tracker_draws_from_its_named_states():
    """A named state is a ``torch.Generator`` of its seed: inside
    ``rng_state`` the default generator draws from it, and outside it the
    default generator is as it was. ``model_parallel_random_seed(s)``
    seeds the default generator with s and ``model_parallel_rng`` with
    s + 1024 + the mp rank (0 without a topology)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed)

    saved_default = torch.get_rng_state()
    tracker = RNGStatesTracker()
    tracker.add("a", 7, "cpu")
    with pytest.raises(ValueError):
        tracker.add("b", 7, "cpu")
    with pytest.raises(ValueError):
        tracker.add("a", 8, "cpu")
    with pytest.raises(ValueError):
        with tracker.rng_state("missing"):
            pass
    snapshot = tracker.get_states_tracker()
    outside = torch.get_rng_state()
    with tracker.rng_state("a"):
        first = torch.rand(4)
    assert torch.equal(torch.get_rng_state(), outside)
    np.testing.assert_array_equal(
        first, torch.rand(4, generator=torch.Generator().manual_seed(7)))
    with tracker.rng_state("a"):
        second = torch.rand(4)
    assert not torch.equal(first, second)
    tracker.set_states_tracker(snapshot)
    with tracker.rng_state("a"):
        assert torch.equal(torch.rand(4), first)
    try:
        model_parallel_random_seed(100, device="cpu")
        np.testing.assert_array_equal(
            torch.rand(3),
            torch.rand(3, generator=torch.Generator().manual_seed(100)))
        with get_rng_state_tracker().rng_state():
            np.testing.assert_array_equal(
                torch.rand(3),
                torch.rand(3, generator=torch.Generator().manual_seed(1124)))
    finally:
        get_rng_state_tracker().reset()
        torch.set_rng_state(saved_default)
