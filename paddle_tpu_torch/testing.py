"""Test oracles of the port.

:func:`dense_reference_logits` is a dense, teacher-forced float32
forward of a port ``LlamaForCausalLM``, built only from the model's
weights and the plain PyTorch versions (``rms_norm_plain``, RoPE, a
dense masked softmax). No kernel and no paged cache is involved, so it
is the independent yardstick the served logits are held against, on the
CPU in the tests and on the card in ``chip_smoke.py``. Weights are cast
to float32 one at a time, so the float32 copy of a large model never
exists whole; a weight-only quantized linear (``WeightOnlyLinear``)
counts as its dequantized float32 weight, so a quantized model is held to
its own weights. :func:`dense_reference_loss_and_grads` is the training
counterpart: the same forward on float32 copies of the weights, a plain
cross-entropy over full logits, and autograd for every parameter's
gradient. Float32 matrix products run at full float32 precision on the
card (``torch.backends.cuda.matmul.allow_tf32`` is False by default;
both functions refuse to run with it on).
"""
from __future__ import annotations

import torch

from .ops.kernels.quant import dequantize_int4, dequantize_int8
from .ops.kernels.rms_norm import rms_norm_plain
from .ops.kernels.rope import apply_rotary_emb, build_rope_cache
from .quantization import WeightOnlyLinear


def _f32(t):
    return t.float()


def _weight(proj, f32):
    """The float32 [in, out] weight ``proj`` computes with: a
    ``WeightOnlyLinear``'s dequantized payload, else ``f32(weight)``."""
    if isinstance(proj, WeightOnlyLinear):
        if proj.weight_dtype == "int8":
            return dequantize_int8(proj.qweight, proj.weight_scale)
        return dequantize_int4(proj.qweight, proj.weight_scale,
                               proj.group_size)
    return f32(proj.weight)


def _linear(x, proj, f32=_f32):
    y = torch.matmul(x, _weight(proj, f32))
    if proj.bias is not None:
        y = y + f32(proj.bias)
    return y


def _refuse_tf32(name):
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{name} needs full float32 matmuls; "
                           "torch.backends.cuda.matmul.allow_tf32 is on")


def _ids(model, input_ids):
    ids = torch.as_tensor(input_ids, dtype=torch.long, device=model.device)
    return ids[None] if ids.dim() == 1 else ids


def _dense_hidden(model, ids, f32=_f32):
    """float32 hidden states after the last layer, before the final
    norm; ``f32`` maps a parameter to the float32 tensor used for it."""
    cfg = model.config
    dev = model.device
    b, s = ids.shape
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    group = nh // nkv
    eps = cfg.rms_norm_eps
    cos, sin = build_rope_cache(s, hd, base=cfg.rope_theta,
                                dtype=torch.float32, device=dev)
    pos = torch.arange(s, device=dev)
    keep = pos[None, :] <= pos[:, None]                     # (q, k)
    if cfg.sliding_window:
        keep = keep & (pos[:, None] - pos[None, :] < cfg.sliding_window)
    x = f32(model.model.embed_tokens.weight)[ids]           # (B, S, E)
    for layer in model.model.layers:
        att = layer.self_attn
        xi = rms_norm_plain(x, f32(layer.input_layernorm.weight), eps)
        q = apply_rotary_emb(
            _linear(xi, att.q_proj, f32).reshape(b, s, nh, hd), cos, sin)
        k = apply_rotary_emb(
            _linear(xi, att.k_proj, f32).reshape(b, s, nkv, hd), cos, sin)
        v = _linear(xi, att.v_proj, f32).reshape(b, s, nkv, hd)
        qg = q.reshape(b, s, nkv, group, hd)
        sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / hd ** 0.5
        sc = sc.masked_fill(~keep, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, s, nh * hd)
        x = x + _linear(o, att.o_proj, f32)
        h = rms_norm_plain(x, f32(layer.post_attention_layernorm.weight),
                           eps)
        mlp = layer.mlp
        x = x + _linear(
            torch.nn.functional.silu(_linear(h, mlp.gate_proj, f32))
            * _linear(h, mlp.up_proj, f32), mlp.down_proj, f32)
    return x


def _dense_head(model, x, f32=_f32):
    h = rms_norm_plain(x, f32(model.model.norm.weight),
                       model.config.rms_norm_eps)
    if model.lm_head is not None:
        return _linear(h, model.lm_head, f32)
    return torch.matmul(h, f32(model.model.embed_tokens.weight).t())


@torch.inference_mode()
def dense_reference_logits(model, input_ids, positions=None):
    """float32 logits of ``model`` over ``input_ids`` ([S] or [B, S]),
    every position attending causally (and within
    ``config.sliding_window`` when set) to the ones before it. Returns
    [B, S, vocab], or [B, len(positions), vocab] for the listed
    positions only."""
    _refuse_tf32("dense_reference_logits")
    x = _dense_hidden(model, _ids(model, input_ids))
    if positions is not None:
        x = x[:, torch.as_tensor(positions, dtype=torch.long,
                                 device=model.device)]
    return _dense_head(model, x)


def dense_reference_loss_and_grads(model, input_ids, labels,
                                   ignore_index=-100):
    """(loss, {name: grad}) of ``model``'s next-token loss in float32:
    logits[:, t] against labels[:, t + 1], mean over the labels that are
    not ``ignore_index``, through a plain cross-entropy over the full
    logits. Every parameter is copied to a float32 leaf one at a time
    (a tied embedding is one leaf, so its two uses add up); the grads
    are float32, keyed by ``named_parameters()`` names."""
    _refuse_tf32("dense_reference_loss_and_grads")
    leaves = {name: p.detach().float().requires_grad_()
              for name, p in model.named_parameters()}
    by_id = {id(p): leaves[name] for name, p in model.named_parameters()}

    def f32(p):
        return by_id[id(p)]

    ids = _ids(model, input_ids)
    lab = _ids(model, labels)
    with torch.enable_grad():
        logits = _dense_head(model, _dense_hidden(model, ids, f32), f32)
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        tgt = lab[:, 1:]
        valid = tgt != ignore_index
        picked = logp.gather(-1, torch.where(valid, tgt, 0)[..., None])
        loss = -(picked[..., 0] * valid).sum() / valid.sum().clamp_min(1)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


# --------------------------------------------------------------------------
# rank programs of the distributed CPU tests
# --------------------------------------------------------------------------
# ``distributed.spawn`` sends a function to its ranks by import path, and a
# test module imports the JAX package, which the ranks must not: the tests
# start these programs, which import only the port. Each joins the job over
# gloo on the host and returns numpy arrays.


def _join_cpu_job():
    import sys

    from .distributed import init_parallel_env

    jax = [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "paddle_tpu.")) or m == "paddle_tpu"]
    if jax:
        raise RuntimeError(f"a rank imported {jax[:3]}: rank programs run "
                           "the port alone")
    torch.set_num_threads(1)
    init_parallel_env(device="cpu")


def _np(t):
    return t.detach().float().numpy().copy()


def gather_mp(t, split, group):
    """The whole float32 CPU tensor of which ``t`` is the mp slice
    ``split`` (a parameter's ``mp_split``): the slices gathered over
    ``group`` along their dim (``t`` itself for None)."""
    from .distributed import all_gather

    t = t.detach().float()
    if split is None:
        return t
    return torch.cat(all_gather([], t.contiguous(), group=group),
                     dim=split[0])


def replicated_params_equal(model, group):
    """Whether every parameter that is not split over mp is bit for bit
    the mp group's first rank's (a broadcast of its copy, compared)."""
    from .distributed import broadcast

    same = True
    for p in model.parameters():
        if getattr(p, "mp_split", None) is not None or group.nranks == 1:
            continue
        theirs = p.detach().clone()
        broadcast(theirs, group.ranks[0], group=group)
        same = same and torch.equal(theirs, p.detach())
    return same


def _train_run(run):
    """One run of :func:`tensor_parallel_rank_program` (see there)."""
    from .distributed import ReduceOp, all_reduce, fleet
    from .models import LlamaForCausalLM, llama_tiny
    from .nn import ClipGradByGlobalNorm
    from .optimizer import AdamW

    dp, mp = run["grid"]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    model = LlamaForCausalLM(llama_tiny(**run["config"]), device="cpu")
    model.load_reference_state(run["state"])
    clip = ClipGradByGlobalNorm(run["clip"]) if run.get("clip") else None
    opt = AdamW(run["lr"], parameters=model.parameters(), grad_clip=clip)
    wrapped = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    norms = []
    if clip is not None:
        record = opt._grad_clip._global_norm_sq

        def recording(params_grads):
            sq = record(params_grads)
            norms.append(float(torch.sqrt(sq)))
            return sq

        opt._grad_clip._global_norm_sq = recording
    x, y = run["batch"]
    rows = x.shape[0] // dp
    r0 = hcg.get_data_parallel_rank() * rows
    xb = torch.from_numpy(x[r0:r0 + rows])
    yb = torch.from_numpy(y[r0:r0 + rows])
    mp_group = hcg.get_model_parallel_group()
    losses, grads = [], None
    for step in range(run["steps"]):
        _, loss = wrapped(xb, yb)
        loss.backward()
        opt.step()
        if step == 0:  # what the step used: averaged over dp
            grads = {n: _np(gather_mp(p.grad, getattr(p, "mp_split", None),
                                      mp_group))
                     for n, p in model.named_parameters()}
        opt.clear_grad()
        lv = loss.detach().float().clone()
        all_reduce(lv, ReduceOp.AVG, group=hcg.get_data_parallel_group())
        losses.append(float(lv))
    result = {
        "losses": losses, "norms": norms, "grads": grads,
        "params": {n: _np(gather_mp(p, getattr(p, "mp_split", None),
                                    mp_group))
                   for n, p in model.named_parameters()},
        "replicated_equal": replicated_params_equal(model, mp_group),
        "mp_rank": hcg.get_model_parallel_rank(),
        "dp_rank": hcg.get_data_parallel_rank()}
    fleet.reset()
    return result


def _mp_layer_case(case):
    """One mp layer (``case["layer"]``) at the hybrid topology's mp
    degree, from the whole weights ``case["weights"]``, on input
    ``case["x"]`` (the rank's last-dim slice where the layer takes a
    parallel input) and cotangent ``case["cot"]`` (sliced likewise where
    the output is the rank's slice): the output, and the gradients of
    the input and of each parameter, each as this rank holds it."""
    from .distributed.fleet import get_hybrid_communicate_group
    from .distributed.fleet.layers import mpu
    from .distributed.fleet.layers.mpu.mp_layers import mp_shard

    g = get_hybrid_communicate_group().get_model_parallel_group()
    kind, kw = case["layer"], dict(case.get("kwargs", {}))
    split_last = (-1, g.nranks, g.rank)
    x = torch.from_numpy(case["x"])
    local_in = kind == "ce" or (kind == "row"
                                and kw.get("input_is_parallel"))
    local_out = kind == "column" and not kw.get("gather_output", True)
    if local_in:
        x = mp_shard(x, split_last).contiguous()
    x.requires_grad_(x.is_floating_point())
    layer = {"embedding": mpu.VocabParallelEmbedding,
             "column": mpu.ColumnParallelLinear,
             "row": mpu.RowParallelLinear}.get(kind)
    if kind == "ce":
        layer = mpu.ParallelCrossEntropy()
        out = layer(x, torch.from_numpy(case["labels"]))
    else:
        layer = layer(*case["shape"], device="cpu", **kw)
        with torch.no_grad():
            for name, p in layer.named_parameters():
                p.copy_(mp_shard(torch.from_numpy(case["weights"][name]),
                                 getattr(p, "mp_split", None)))
        out = layer(x)
    cot = torch.from_numpy(case["cot"])
    if local_out:
        cot = mp_shard(cot, split_last)
    (out * cot).sum().backward()
    grads = {"x": x.grad}
    if kind != "ce":
        grads.update({n: p.grad for n, p in layer.named_parameters()})
    return {"out": _np(out), "grads": {k: _np(v) for k, v in grads.items()
                                       if v is not None}}


def _head_case(case):
    """The vocab-parallel fused head on this rank's vocab rows of
    ``case["w"]`` (whole [V, H]): the loss, and the gradients of h (whole,
    summed over mp by the head) and of the rank's rows of w."""
    from .distributed.fleet import get_hybrid_communicate_group
    from .distributed.fleet.layers.mpu.mp_layers import mp_shard
    from .ops.kernels.fused_loss import \
        fused_linear_cross_entropy_vocab_parallel

    g = get_hybrid_communicate_group().get_model_parallel_group()
    h = torch.from_numpy(case["h"]).requires_grad_()
    w = mp_shard(torch.from_numpy(case["w"]), (0, g.nranks, g.rank))
    w = w.contiguous().requires_grad_()
    loss = fused_linear_cross_entropy_vocab_parallel(
        h, w, torch.from_numpy(case["labels"]),
        chunk=case["chunk"], reduction=case["reduction"], group=g)
    loss.backward(torch.tensor(float(case["cot"])))
    return {"loss": _np(loss), "dh": _np(h.grad), "dw": _np(w.grad)}


def _refusals():
    """{option: the error it raised} for each unported option at mp 2
    (None where nothing raised)."""
    import paddle_tpu_torch as pt
    from .distributed import fleet
    from .inference import PagedLlamaAdapter
    from .models import LlamaForCausalLM, llama_tiny
    from .quantization import quantize_for_serving

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1), device="cpu")
    ids = torch.zeros((1, 8), dtype=torch.long)

    def kv_heads():
        LlamaForCausalLM(llama_tiny(num_hidden_layers=1,
                                    num_key_value_heads=1), device="cpu")

    def flags(values):
        def run():
            pt.set_flags(values)
            try:
                model(ids, ids)
            finally:
                pt.set_flags({"FLAGS_collective_matmul": "off",
                              "FLAGS_collective_dtype": "off"})
        return run

    def to_static():
        pt.jit.to_static(lambda a: model(a))(ids)

    cases = {
        "num_kv_heads_mod_mp": kv_heads,
        "collective_matmul_on": flags({"FLAGS_collective_matmul": "on"}),
        "collective_matmul_auto": flags({"FLAGS_collective_matmul": "auto"}),
        "collective_dtype_int8": flags({"FLAGS_collective_dtype": "int8"}),
        "generate": lambda: model.generate(ids, max_new_tokens=1),
        "decode_step": lambda: model.decode_step(ids, [], 0),
        "init_cache": lambda: model.init_cache(1, 8),
        "paged_adapter": lambda: PagedLlamaAdapter(model),
        "quantize_for_serving": lambda: quantize_for_serving(model),
        "to_static": to_static,
    }
    out = {}
    for name, run in cases.items():
        try:
            run()
            out[name] = None
        except NotImplementedError as e:
            out[name] = f"NotImplementedError: {e}"
    fleet.reset()
    return out


def _data_parallel_cases():
    """``DataParallel`` over the world on a ``Linear`` seeded by rank:
    its parameters after construction (rank 0's, broadcast), its
    gradients after two backward passes under ``no_sync`` (this rank's
    sums) and after a third outside it (the sums averaged over the
    ranks); then ``broadcast_input_data`` at mp = world: a tensor, a
    number and a keyword tensor as rank 0 gave them."""
    from .distributed import DataParallel, fleet, get_rank, get_world_size
    from .distributed.fleet.utils import broadcast_input_data

    rank = get_rank()
    torch.manual_seed(rank)
    lin = torch.nn.Linear(3, 2)
    model = DataParallel(lin)
    weights = {n: _np(p) for n, p in lin.named_parameters()}
    xs = [torch.full((4, 3), float(rank + 1 + i)) for i in range(3)]
    with model.no_sync():
        for x in xs[:2]:
            model(x).sum().backward()
    local = {n: _np(p.grad) for n, p in lin.named_parameters()}
    model(xs[2]).sum().backward()
    synced = {n: _np(p.grad) for n, p in lin.named_parameters()}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": get_world_size()}
    fleet.init(is_collective=True, strategy=strategy)
    inputs, kwargs = broadcast_input_data(
        fleet.get_hybrid_communicate_group(), torch.full((2,), float(rank)),
        rank, key=torch.full((1,), rank + 10.0))
    fleet.reset()
    return {"weights": weights, "local": local, "synced": synced,
            "inputs": [_np(inputs[0]), inputs[1]], "key": _np(kwargs["key"])}


def tensor_parallel_rank_program(layer_cases=(), head_cases=(), runs=(),
                                 refusals=False):
    """Everything of the tensor-parallel tests that runs on this rank
    over gloo: each mp layer case (:func:`_mp_layer_case`) and
    vocab-parallel head case (:func:`_head_case`) at mp = world, each
    training run, and (``refusals``) the unported options at mp 2 and
    the data-parallel cases (:func:`_data_parallel_cases`).

    A run (a dict): ``fleet.init`` at ``grid`` = (dp, mp),
    ``LlamaForCausalLM(llama_tiny(**config))`` on the CPU loaded with the
    whole reference ``state``, ``AdamW(lr)`` (``clip``: a
    ``ClipGradByGlobalNorm``) through ``distributed_model`` and
    ``distributed_optimizer``, ``steps`` steps on the dp rank's rows of
    the global batch ``(x, y)``; it returns the losses averaged over dp,
    the clip's global norms, the step-1 gradients and every parameter
    gathered whole, and whether the replicated parameters agree bit for
    bit over mp."""
    from .distributed import fleet, get_world_size

    _join_cpu_job()
    out = {"layers": [], "heads": [], "runs": [], "refusals": None}
    if layer_cases or head_cases:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"mp_degree": get_world_size()}
        fleet.init(is_collective=True, strategy=strategy)
        out["layers"] = [_mp_layer_case(c) for c in layer_cases]
        out["heads"] = [_head_case(c) for c in head_cases]
        fleet.reset()
    out["runs"] = [_train_run(run) for run in runs]
    if refusals:
        out["refusals"] = _refusals()
        out["data_parallel"] = _data_parallel_cases()
    return out


COLLECTIVE_SHAPE = (4, 3)
COLLECTIVE_OPS = ("SUM", "MAX", "MIN", "PROD", "AVG")


def collective_input(rank, seed=0):
    """Rank ``rank``'s input of the collective tests: integers in
    [-3, 3] as float32 (SUM, MAX, MIN, PROD and AVG of them are
    exact)."""
    import numpy as np

    rng = np.random.RandomState(seed + rank)
    return rng.randint(-3, 4, size=COLLECTIVE_SHAPE).astype(np.float32)


def _collective_cases(g, x):
    """{case: numpy} of every collective over group ``g`` from this
    rank's input ``x``, each run synchronously and asynchronously
    (``_sync``/``_async``)."""
    from . import distributed as D

    n, me = g.nranks, g.rank
    out = {}

    def t():
        return torch.from_numpy(x.copy())

    def both(name, run):
        for sync in (True, False):
            ret, read = run(sync)
            if not sync:
                assert isinstance(ret, D.Task), name
                ret.wait()
            out[f"{name}_{'sync' if sync else 'async'}"] = read()

    def reduce_case(fn, op):
        def run(sync):
            a = t()
            return fn(a, op, sync), lambda: a.numpy()
        return run

    for name in COLLECTIVE_OPS:
        op = getattr(D.ReduceOp, name)
        both(f"all_reduce_{name}", reduce_case(
            lambda a, o, s: D.all_reduce(a, o, group=g, sync_op=s), op))
        both(f"stream_all_reduce_{name}", reduce_case(
            lambda a, o, s: D.stream.all_reduce(a, o, group=g, sync_op=s),
            op))
    both("reduce_SUM", reduce_case(
        lambda a, o, s: D.reduce(a, g.ranks[-1], o, group=g, sync_op=s),
        D.ReduceOp.SUM))

    def gather_list(sync):
        lst = []
        return D.all_gather(lst, t(), group=g, sync_op=sync), \
            lambda: torch.stack(lst).numpy()
    both("all_gather_list", gather_list)

    def gather_stacked(axis):
        def run(sync):
            ret = D.all_gather(None, t(), group=g, sync_op=sync, axis=axis)
            res = ret if sync else ret.result
            return ret, lambda: res.numpy()
        return run
    both("all_gather_axis0", gather_stacked(0))
    both("all_gather_axis1", gather_stacked(1))

    def into_tensor(sync):
        o = torch.zeros((n * x.shape[0],) + x.shape[1:])
        return D.all_gather_into_tensor(o, t(), group=g, sync_op=sync), \
            lambda: o.numpy()
    both("all_gather_into_tensor", into_tensor)

    def gather(sync):
        lst = []
        return D.gather(t(), lst, dst=g.ranks[0], group=g, sync_op=sync), \
            lambda: torch.stack(lst).numpy()
    both("gather", gather)

    pieces = [torch.from_numpy(x * (i + 1)) for i in range(n)]

    def reduce_scatter(name, op, as_list):
        def run(sync):
            o = torch.zeros(x.shape)
            src = list(pieces) if as_list else torch.cat(pieces)
            return D.reduce_scatter(o, src, op, group=g, sync_op=sync), \
                lambda: o.numpy()
        both(name, run)
    reduce_scatter("reduce_scatter_SUM", D.ReduceOp.SUM, True)
    reduce_scatter("reduce_scatter_tensor_SUM", D.ReduceOp.SUM, False)
    reduce_scatter("reduce_scatter_MAX", D.ReduceOp.MAX, True)

    def broadcast(sync):
        a = t()
        return D.broadcast(a, g.ranks[-1], group=g, sync_op=sync), \
            lambda: a.numpy()
    both("broadcast", broadcast)

    def scatter(sync):
        o = torch.zeros(x.shape)
        return D.scatter(o, list(pieces), src=g.ranks[n - 1], group=g,
                         sync_op=sync), lambda: o.numpy()
    both("scatter", scatter)

    def alltoall(sync):
        lst = []
        return D.alltoall(lst, list(pieces), group=g, sync_op=sync), \
            lambda: torch.stack(lst).numpy()
    both("alltoall", alltoall)

    def alltoall_single(sync):
        o = torch.zeros((n * x.shape[0],) + x.shape[1:])
        return D.alltoall_single(o, torch.cat(pieces), group=g,
                                 sync_op=sync), lambda: o.numpy()
    both("alltoall_single", alltoall_single)

    ring = [(i, (i + 1) % n) for i in range(n)]
    out["ppermute_ring"] = D.ppermute(t(), ring, group=g).numpy()
    buf = torch.zeros(x.shape)
    for task in D.batch_isend_irecv([
            D.P2POp(D.isend, t(), g.ranks[(me + 1) % n], g),
            D.P2POp(D.irecv, buf, g.ranks[(me - 1) % n], g)]):
        task.wait()
    out["batch_isend_irecv_ring"] = buf.numpy()
    D.barrier(group=g)
    D.monitored_barrier(group=g, timeout=60)
    out["wait"] = D.wait(t(), group=g).numpy()
    return out


def collective_rank_program(seed=0):
    """Every collective on every group of a world of 2 or 4 ranks over
    gloo: the world group, ``new_group`` subgroups and the hybrid
    topology's axis groups ({0, 1} at 2 ranks; dp 2 x mp 2 at 4), and
    point-to-point and object collectives on the world group. Returns
    ``{group label: {case: numpy}}`` plus ``"p2p"``, ``"objects"`` and
    ``"env"``."""
    import numpy as np

    from . import distributed as D

    _join_cpu_job()
    rank, world = D.get_rank(), D.get_world_size()
    x = collective_input(rank, seed)
    res = {"world": _collective_cases(D.get_group(0), x)}
    if world == 2:
        res["sub"] = _collective_cases(D.new_group([0, 1]), x)
        hybrid = {"mp_degree": 2}
    else:
        subs = [D.new_group([0, 2]), D.new_group([1, 3])]
        res["sub"] = _collective_cases(subs[rank % 2], x)
        hybrid = {"dp_degree": 2, "mp_degree": 2}
    strategy = D.fleet.DistributedStrategy()
    strategy.hybrid_configs = hybrid
    D.fleet.init(is_collective=True, strategy=strategy)
    hcg = D.fleet.get_hybrid_communicate_group()
    res["mp"] = _collective_cases(hcg.get_model_parallel_group(), x)
    if world == 4:
        res["dp"] = _collective_cases(hcg.get_data_parallel_group(), x)
    # point-to-point on the world group: 0 sends to 1, 1 sends to 0
    got = torch.zeros(x.shape)
    if rank == 0:
        D.send(torch.from_numpy(x), dst=1)
        D.recv(got, src=1)
    elif rank == 1:
        D.recv(got, src=0)
        task = D.isend(torch.from_numpy(x), dst=0)
        task.wait()
    res["p2p"] = got.numpy()
    objs = []
    D.all_gather_object(objs, {"rank": rank, "x": float(x.sum())})
    bc = [rank, "r%d" % rank] if rank == 1 else [None, None]
    D.broadcast_object_list(bc, src=1)
    sc = []
    D.scatter_object_list(sc, [{"to": r} for r in range(world)]
                          if rank == 0 else None, src=0)
    res["objects"] = {"all_gather": objs, "broadcast": bc, "scatter": sc}
    env = D.ParallelEnv()
    res["env"] = {"rank": rank, "world": world, "env_rank": env.rank,
                  "nranks": env.nranks, "local_rank": env.local_rank,
                  "mp_rank": hcg.get_model_parallel_rank(),
                  "dp_rank": hcg.get_data_parallel_rank(),
                  "groups": {a: getattr(hcg, f"get_{a}_group")().ranks
                             for a in ("data_parallel", "model_parallel",
                                       "check_parallel")},
                  "mode": hcg.get_parallel_mode()}
    D.fleet.reset()
    D.destroy_process_group()
    res["x"] = np.asarray(x)
    return res


def topology_rank_program(grids):
    """For each ``(order, {axis: degree})`` of ``grids``: this rank's
    ``HybridCommunicateGroup`` groups (members by axis, and the check
    group's), its rank along each axis and each group's first rank."""
    from .distributed.fleet import HybridCommunicateGroup

    _join_cpu_job()
    out = []
    for order, degrees in grids:
        cfg = {"order": order, **{f"{a}_degree": d
                                  for a, d in degrees.items()}}
        hcg = HybridCommunicateGroup(hybrid_configs=cfg)
        out.append({
            "groups": {a: getattr(hcg, f"get_{n}_group")().ranks
                       for a, n in (("dp", "data_parallel"),
                                    ("pp", "pipe_parallel"),
                                    ("sharding", "sharding_parallel"),
                                    ("sep", "sep_parallel"),
                                    ("mp", "model_parallel"),
                                    ("check", "check_parallel"))},
            "ranks": {"dp": hcg.get_data_parallel_rank(),
                      "pp": hcg.get_stage_id(),
                      "sharding": hcg.get_sharding_parallel_rank(),
                      "sep": hcg.get_sep_parallel_rank(),
                      "mp": hcg.get_model_parallel_rank()},
            "src": (hcg.get_data_parallel_group_src_rank(),
                    hcg.get_model_parallel_group_src_rank()),
            "mode": hcg.get_parallel_mode()})
    return out
