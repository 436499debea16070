"""How far bf16 training at mp 2 lies from one rank, beside how far both
lie from float32: a CPU study of the PyTorch port (gloo ranks through
``paddle_tpu_torch.distributed.spawn``; imports no JAX).

    PYTHONPATH=. python tools/torch_mp_precision.py

Qwen2-0.5B's widths (hidden 896, 14:2 heads of 64, vocab 151,936) at a
cut depth, weights from one seed, the fused CE head:

1. one step's gradients (1 layer, 2 x 1024 tokens): each parameter's
   gradient norm at one bf16 rank and at mp 2, over the float32 run's
   from the same weights;
2. three steps of AdamW(3e-4, multi_precision=True) with
   ``ClipGradByGlobalNorm(0.25)`` (2 layers, 4 x 512 tokens): the clip's
   global norm of each step in each run, and after step 1 the share of
   elements where the mp 2 run's weights differ from the one rank's, and
   by more than half the rate.

Takes ~6 minutes on a 6-core host.
"""
from __future__ import annotations

import numpy as np
import torch

WIDTHS = dict(hidden_size=896, intermediate_size=4864,
              num_attention_heads=14, num_key_value_heads=2,
              vocab_size=151936, fused_head_loss=True)
STUDIES = {"grads": (1, 2, 1024, 1), "steps": (2, 4, 512, 3)}
LR, CLIP, SEED = 3e-4, 0.25, 3


def _batch(b, s):
    r = np.random.RandomState(0)
    v = WIDTHS["vocab_size"]
    return (torch.from_numpy(r.randint(0, v, (b, s))),
            torch.from_numpy(r.randint(0, v, (b, s))))


def _model(layers, dtype):
    from paddle_tpu_torch.models import LlamaForCausalLM, qwen2_0_5b

    bf16 = LlamaForCausalLM(qwen2_0_5b(num_hidden_layers=layers, **WIDTHS),
                            device="cpu", dtype=torch.bfloat16, seed=SEED)
    if dtype == torch.bfloat16:
        return bf16
    model = LlamaForCausalLM(qwen2_0_5b(num_hidden_layers=layers, **WIDTHS),
                             device="cpu", dtype=dtype, seed=SEED)
    with torch.no_grad():
        for p, q in zip(model.parameters(), bf16.parameters()):
            p.copy_(q.float())
    return model


def _run(study, model, opt=None, gather=lambda p, t: t):
    """(global norms a step, {name: gradient of step 1}, {name: weights
    after step 1}), all whole, float32 numpy."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    layers, b, s, steps = STUDIES[study]
    x, y = _batch(b, s)
    inner = getattr(model, "_layers", model)
    if opt is None:
        opt = AdamW(LR, parameters=inner.parameters(),
                    multi_precision=True,
                    grad_clip=ClipGradByGlobalNorm(CLIP))
    clip = getattr(opt, "_inner_opt", opt)._grad_clip
    norm_sq, norms = clip._global_norm_sq, []

    def recording(params_grads):
        sq = norm_sq(params_grads)
        norms.append(float(torch.sqrt(sq)))
        return sq

    clip._global_norm_sq = recording
    grads = after = None
    for step in range(steps):
        _, loss = model(x, y)
        loss.backward()
        if step == 0:
            grads = {n: gather(p, p.grad).float().numpy().copy()
                     for n, p in inner.named_parameters()}
        if steps == 1:
            break
        opt.step()
        if step == 0:
            after = {n: gather(p, p.detach()).float().numpy().copy()
                     for n, p in inner.named_parameters()}
        opt.clear_grad()
    return norms, grads, after


def mp2_rank(study):
    """One rank of the mp 2 run (a ``spawn`` target)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing import _join_cpu_job, gather_mp

    torch.set_num_threads(3)
    _join_cpu_job()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    group = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    model = _model(STUDIES[study][0], torch.bfloat16)
    opt = fleet.distributed_optimizer(AdamW(
        LR, parameters=model.parameters(), multi_precision=True,
        grad_clip=ClipGradByGlobalNorm(CLIP)))

    def gather(p, t):
        return gather_mp(t, getattr(p, "mp_split", None), group)

    out = _run(study, fleet.distributed_model(model), opt, gather)
    fleet.reset()
    return out


def main():
    from paddle_tpu_torch.distributed import spawn

    torch.set_num_threads(6)
    runs = {}
    for study in STUDIES:
        layers = STUDIES[study][0]
        runs[study] = {
            "bf16": _run(study, _model(layers, torch.bfloat16)),
            "fp32": _run(study, _model(layers, torch.float32)),
            "mp2": spawn(mp2_rank, args=(study,), nprocs=2)[0]}
    g = runs["grads"]
    print("one step, 1 layer: gradient norm over the float32 run's "
          "(one bf16 rank, bf16 mp 2, mp 2 over one rank)")
    rows = []
    for name, ref in g["fp32"][1].items():
        one, two = g["bf16"][1][name], g["mp2"][1][name]
        n = np.linalg.norm
        rows.append((abs(n(two) / n(one) - 1), name, n(one) / n(ref),
                     n(two) / n(ref), n(two) / n(one)))
    for _, name, a, b, c in sorted(rows, reverse=True)[:6]:
        print(f"  {name:46s} {a:.4f} {b:.4f} {c:.4f}")
    s = runs["steps"]
    print("three steps, 2 layers: global norm a step")
    for arm in ("fp32", "bf16", "mp2"):
        print(f"  {arm:5s}", [f"{v:.6f}" for v in s[arm][0]])
    for arm in ("bf16", "mp2"):
        dev = [abs(a - b) / b for a, b in zip(s[arm][0], s["fp32"][0])]
        print(f"  {arm} from fp32, relative:", [f"{v:.2e}" for v in dev])
    dev = [abs(a - b) / b for a, b in zip(s["mp2"][0], s["bf16"][0])]
    print("  mp2 from bf16, relative:", [f"{v:.2e}" for v in dev])
    total = moved = far = 0
    for name, w in s["bf16"][2].items():
        d = np.abs(s["mp2"][2][name] - w)
        total, moved, far = (total + d.size, moved + (d > 0).sum(),
                             far + (d > LR / 2).sum())
    print(f"  after step 1, mp2 against bf16: {moved / total:.4%} of the "
          f"elements differ, {far / total:.4%} by more than half the rate")


if __name__ == "__main__":
    main()
