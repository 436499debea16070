"""The port's ``jit.to_static`` against the JAX package's, on the CPU.

On the CPU the port records a step's first call and runs every later
call eagerly (a CUDA graph is captured only for CUDA tensors, on the
card: ``chip_smoke.py``'s ``train_static`` and ``generate_jit``). These
tests hold what the CPU can show:

* a ``llama_tiny`` train step (forward with the fused CE head,
  backward, AdamW, ``clear_grad``) under the reference's
  ``paddle.jit.to_static`` and the port's, for 3 steps on 3 seeded
  batches, from the same weights (``load_reference_state``): losses
  within 1e-5 relative, every parameter within 3e-5 absolute (float32;
  the reference's XLA program and the port's eager ops sum in other
  orders, and AdamW normalizes each gradient, so the noise of a
  near-zero gradient moves its update most: 3e-5 is 1% of the 3e-3 that
  three steps at rate 1e-3 can move a weight), and the port's compiled
  step bit for bit its own eager step;
* the compiled-entry cache in lockstep with the reference's over one
  call sequence (the same signature, a new shape, a changing Python
  scalar, ``eval()``): equal entry counts and ``compile.count`` after
  every call;
* outputs a later call does not overwrite, a host read refused (the
  varlen path's ``cu_seqlens`` read included), ``plan``/``analyze``
  leaving every state tensor, gradient and argument bit for bit, the
  refused keywords and state created inside a compiled function;
* ``generate(use_jit=True)`` and beam search with ``use_jit=True``:
  token for token the reference's tokens and the port's eager ones.

The reference's program is built once per file (a module-scoped
fixture): its first compile is the slow part.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jax_optim
from paddle_tpu.framework import telemetry as jax_telemetry
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import generation as jax_generation
from paddle_tpu.models import llama_tiny as jax_tiny

from paddle_tpu_torch import jit
from paddle_tpu_torch.framework import telemetry
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.optimizer import AdamW, Momentum

LOSS_RTOL = 1e-5
PARAM_ATOL = 3e-5
B, S, STEPS = 2, 16, 3


def _batches(vocab):
    rng = np.random.RandomState(3)
    return [(rng.randint(0, vocab, (B, S)).astype(np.int32),
             rng.randint(0, vocab, (B, S)).astype(np.int64))
            for _ in range(STEPS)]


def _train_step(model, opt):
    def train_step(x, y):
        _, loss = model(x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return train_step


def _port_trainer(state, cfg):
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_reference_state(state)
    return model, AdamW(1e-3, parameters=model.parameters())


@pytest.fixture(scope="module")
def trained():
    """The reference's compiled step and the port's compiled and eager
    steps, 3 steps each from the same weights."""
    cfg_kw = dict(fused_head_loss=True)
    paddle.seed(5)
    jm = JaxLlama(jax_tiny(**cfg_kw))
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    jo = jax_optim.AdamW(1e-3, parameters=jm.parameters())
    jstep = paddle.jit.to_static(_train_step(jm, jo))
    tm, to = _port_trainer(state, llama_tiny(**cfg_kw))
    tstep = jit.to_static(_train_step(tm, to))
    em, eo = _port_trainer(state, llama_tiny(**cfg_kw))
    estep = _train_step(em, eo)
    losses = {"ref": [], "port": [], "eager": []}
    for x, y in _batches(jm.config.vocab_size):
        losses["ref"].append(float(np.asarray(
            jstep(paddle.to_tensor(x), paddle.to_tensor(y))._data)))
        losses["port"].append(float(tstep(torch.from_numpy(x),
                                          torch.from_numpy(y)).detach()))
        losses["eager"].append(float(estep(torch.from_numpy(x),
                                           torch.from_numpy(y)).detach()))
    return {"jm": jm, "tm": tm, "em": em, "tstep": tstep, "to": to,
            "losses": losses, "state": state}


def test_train_step_matches_the_reference(trained):
    got, ref = trained["losses"]["port"], trained["losses"]["ref"]
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    ref_params = dict(trained["jm"].named_parameters())
    for name, p in trained["tm"].named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(ref_params[name]._data),
            rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_train_step_is_its_eager_step_bit_for_bit(trained):
    assert trained["losses"]["port"] == trained["losses"]["eager"]
    for (n, p), q in zip(trained["tm"].named_parameters(),
                         trained["em"].parameters()):
        assert torch.equal(p, q), n
    entries = trained["tstep"].entries()
    assert len(entries) == 1 and entries[0]["calls"] == STEPS
    assert not entries[0]["captured"]  # CPU tensors run eagerly


def test_program_holds_one_op_a_kernel_and_no_plain_op(trained):
    """Each hand kernel is one op named after it; the plain versions'
    ops (the flash softmax's exp, say) are not in the program."""
    entry = trained["tstep"]._finalized_entries()[0]
    kernel_ops = [op.name for op in entry.program.ops if op.kernel]
    layers = trained["tm"].config.num_hidden_layers
    assert kernel_ops.count("flash_attention_fwd") == layers
    assert kernel_ops.count("flash_attention_bwd_dkdv") == layers
    assert kernel_ops.count("flash_attention_bwd_dq") == layers
    assert kernel_ops.count("rms_norm") == 2 * layers + 1
    assert entry.program.launches() == {}  # the CPU launches nothing

    def norm_only(x, w):
        from paddle_tpu_torch.ops.kernels import rms_norm
        return rms_norm(x, w)

    sf = jit.to_static(norm_only)
    sf(torch.randn(4, 8), torch.ones(8))
    assert [op.name for op in sf._finalized_entries()[0].program.ops] \
        == ["rms_norm"]


def _metrics_on():
    set_flags({"telemetry": "metrics"})
    telemetry.reset()
    paddle.set_flags({"FLAGS_telemetry": "metrics"})
    jax_telemetry.reset()


def _metrics_off():
    set_flags({"telemetry": "off"})
    telemetry.reset()
    paddle.set_flags({"FLAGS_telemetry": "off"})
    jax_telemetry.reset()


def test_cache_in_lockstep_with_the_reference():
    """The same call sequence through both packages: equal compiled
    entries and compile.count after every call."""
    import paddle_tpu.nn as jax_nn

    _metrics_on()
    try:
        paddle.seed(0)
        jlin = jax_nn.Linear(8, 4)
        tlin = torch.nn.Linear(8, 4)

        def jfn(x, k):
            return jlin(x) * k

        def tfn(x, k):
            return tlin(x) * k

        js, ts = paddle.jit.to_static(jfn), jit.to_static(tfn)
        rng = np.random.RandomState(0)
        x8 = rng.randn(8, 8).astype(np.float32)
        x12 = rng.randn(12, 8).astype(np.float32)
        calls = [(x8, 2.0, None), (x8, 2.0, None), (x12, 2.0, None),
                 (x8, 3.0, None), (x8, 2.0, "eval"), (x8, 2.0, None),
                 (x8, 2.0, "train")]
        counts = []
        for x, k, mode in calls:
            if mode is not None:
                getattr(jlin, mode)()
                getattr(tlin, mode)()
            js(paddle.to_tensor(x), k)
            ts(torch.from_numpy(x), k)
            counts.append((
                (len(js._finalized_entries()),
                 int(jax_telemetry.registry().counter("compile.count"))),
                (len(ts._finalized_entries()),
                 int(telemetry.registry().counter("compile.count")))))
        assert [c[1] for c in counts] == [c[0] for c in counts]
        assert counts[-1][1] == (4, 4)
        exec_count = telemetry.registry().counter("exec.count.tfn")
        assert exec_count == len(calls)
    finally:
        _metrics_off()


def test_outputs_are_not_overwritten_by_a_later_call():
    lin = torch.nn.Linear(4, 4)
    sf = jit.to_static(lambda x: lin(x) * 2.0)
    a = sf(torch.ones(2, 4))
    kept = a.clone()
    sf(torch.full((2, 4), 3.0))
    sf(torch.full((2, 4), 5.0))
    assert torch.equal(a, kept)


def test_a_host_read_raises():
    sf = jit.to_static(lambda x: x * float(x.sum()))
    with pytest.raises(jit.HostReadError, match="dy2static"):
        sf(torch.ones(3))
    assert sf._finalized_entries() == []
    with pytest.raises(jit.HostReadError):
        jit.analyze(lambda x: x[: int(x.sum())], torch.ones(3))


def test_the_varlen_path_is_refused_not_captured():
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded

    q = torch.randn(8, 2, 64)
    cu = torch.tensor([0, 3, 8], dtype=torch.int32)

    def f(q):
        return flash_attn_unpadded(q, q, q, cu, cu, 5, 5, causal=True)[0]

    with pytest.raises(jit.HostReadError):
        jit.to_static(f)(q)


def _state_of(model, opt):
    out = [t.detach().clone() for t in model.parameters()]
    out += [t.detach().clone() for t in opt._state_tensors()]
    return out


def test_plan_and_analyze_leave_the_state_bit_for_bit(trained):
    tm, to = trained["tm"], trained["to"]
    step = _train_step(tm, to)
    for p in tm.parameters():
        p.grad = torch.full_like(p, 0.25)
    grads = [p.grad for p in tm.parameters()]
    before = _state_of(tm, to)
    x, y = (torch.from_numpy(a) for a in _batches(tm.config.vocab_size)[0])
    xs, ys = x.clone(), y.clone()
    plan = jit.plan(step, x, y)
    report = jit.analyze(step, x, y)
    assert plan.hbm_peak_bytes > plan.input_bytes + plan.donated_bytes > 0
    assert report.counts()["critical"] == 0
    after = _state_of(tm, to)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert all(p.grad is g for p, g in zip(tm.parameters(), grads))
    assert torch.equal(x, xs) and torch.equal(y, ys)
    for p in tm.parameters():
        p.grad = None


def test_refused_keywords_and_exports():
    for kw in ({"input_spec": [1]}, {"build_strategy": object()},
               {"backend": "CINN"}, {"full_graph": False},
               {"property": True}, {"donate_state": False}):
        with pytest.raises(NotImplementedError):
            jit.to_static(lambda x: x, **kw)
    with pytest.raises(NotImplementedError, match="jit.save"):
        jit.save(torch.nn.Linear(2, 2), "unused")
    with pytest.raises(NotImplementedError):
        jit.load("unused")


def test_state_created_inside_is_refused():
    holder = torch.nn.Module()

    def grows(x):
        holder.register_buffer("late", x * 2.0)
        return x + 1.0

    with pytest.raises(RuntimeError, match="new persistent state"):
        jit.to_static(grows)(torch.ones(2))


def test_enable_to_static_false_runs_eagerly():
    sf = jit.to_static(lambda x: x + 1.0)
    jit.enable_to_static(False)
    try:
        assert torch.equal(sf(torch.ones(2)), torch.full((2,), 2.0))
        assert sf._finalized_entries() == []
    finally:
        jit.enable_to_static(True)


def test_an_optimizer_with_host_scalars_refuses_a_capture():
    from paddle_tpu_torch.jit import program

    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.ones(3)
    with program.capture_scope():
        with pytest.raises(NotImplementedError, match="capturable"):
            Momentum(0.1, parameters=[p]).step()
        AdamW(0.1, parameters=[p]).step()  # capturable


@pytest.fixture(scope="module")
def gen_pair():
    paddle.seed(5)
    jm = JaxLlama(jax_tiny()).eval()
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    tm.load_reference_state(state)
    ids = np.random.RandomState(1).randint(4, 512, (2, 7)).astype(np.int32)
    return jm, tm, ids


@pytest.mark.parametrize("beams", [1, 3])
def test_generate_use_jit_matches_the_reference(gen_pair, beams):
    jm, tm, ids = gen_pair
    ref = np.asarray(jax_generation.generate(
        jm, paddle.to_tensor(ids), max_new_tokens=6, num_beams=beams)._data)
    eager = tm.generate(torch.from_numpy(ids), max_new_tokens=6,
                        num_beams=beams)
    compiled = tm.generate(torch.from_numpy(ids), max_new_tokens=6,
                           num_beams=beams, use_jit=True)
    np.testing.assert_array_equal(compiled.numpy(), ref)
    assert torch.equal(compiled, eager)


def test_compiled_decode_step_takes_a_device_position(gen_pair):
    """The decode step compiled with a 0-d position tensor reads it on
    the device only (a host read would raise) and writes the same
    caches and logits as the int position."""
    _, tm, ids = gen_pair
    t_ids = torch.from_numpy(ids).long()
    a, b = tm.init_cache(2, 12), tm.init_cache(2, 12)
    step = jit.to_static(tm.decode_step)
    pos = torch.zeros((), dtype=torch.int32)
    la, _ = tm.decode_step(t_ids, a, 0)
    lb, _ = step(t_ids, b, pos)
    nxt = la[:, -1:].argmax(-1)
    pos.fill_(7)
    la2, _ = tm.decode_step(nxt, a, 7)
    lb2, out_caches = step(nxt, b, pos)
    assert out_caches[0][0] is b[0][0]
    assert torch.equal(la, lb) and torch.equal(la2, lb2)
    for (ka, va), (kb, vb) in zip(a, b):
        assert torch.equal(ka, kb) and torch.equal(va, vb)


def test_the_capture_guard_keeps_what_a_graph_reads_from_outside():
    """A capture's dispatch mode collects the storages its ops read that
    it did not allocate (the entry keeps them alive for the replays: a
    model's cached RoPE tables may be replaced while a graph still reads
    them) and refuses host reads."""
    from paddle_tpu_torch.jit import program

    table, x = torch.arange(6.0), torch.ones(3)
    with program.capture_guard() as guard:
        y = x * 2.0
        (y + table[:3]).sum()
    held = {st.data_ptr() for st in guard.external.values()}
    assert table.untyped_storage().data_ptr() in held
    assert x.untyped_storage().data_ptr() in held
    assert y.untyped_storage().data_ptr() not in held
    with program.capture_guard():
        with pytest.raises(jit.HostReadError):
            float(x.sum())
        with pytest.raises(jit.HostReadError):
            x.tolist()


# -- the capture path, forced on the CPU ---------------------------------
# A CUDA graph exists only on the card. To hold the entry's buffer,
# output and gradient logic here, ``cpu_capture`` makes CPU tensors
# capture and stands a replayer in for the graph: its capture runs the
# function once (the capturing call's step, which the real capture's
# first replay runs), and each later replay runs it again on the same
# buffers and writes what it returns and the gradients it leaves into the
# tensors the capture returned, as a graph's replay writes its pool.


class _CPUGraph:
    def __init__(self, run, got):
        self.run, self.got, self.first = run, got, True

    def replay(self):
        if self.first:  # the capture already ran this call's step
            self.first = False
            return
        from torch.utils._pytree import tree_leaves

        out, grads = self.run()
        kept_out, kept_grads = self.got
        for a, b in zip(tree_leaves(kept_out), tree_leaves(out)):
            if isinstance(a, torch.Tensor) and a is not b:
                a.detach().copy_(b)
        by_param = {id(p): g for p, g in grads}
        for p, g in kept_grads:
            g.copy_(by_param[id(p)])


def _cpu_graph(run, device):
    got = run()
    return _CPUGraph(run, got), got, 0


@pytest.fixture
def cpu_capture(monkeypatch):
    from paddle_tpu_torch.jit import api

    monkeypatch.setattr(api, "_captures", lambda device: True)
    monkeypatch.setattr(api, "_cuda_graph", _cpu_graph)


def _linear_trainer(seed=0):
    torch.manual_seed(seed)
    lin = torch.nn.Linear(4, 3)
    return lin, AdamW(0.1, parameters=lin.parameters())


def test_a_replay_never_writes_the_callers_arguments(cpu_capture):
    """Each call's batch is a slice of one dataset: the first calls'
    slices stay as they were (the graph reads buffers its entry owns),
    the steps equal the eager ones bit for bit, and the entry copies x
    and y in on each call from its second."""
    data = torch.randn(5, 8, 4)
    targets = torch.randn(5, 8, 3)
    kept = data.clone(), targets.clone()
    runs = {}
    for mode in ("static", "eager"):
        lin, opt = _linear_trainer()

        def step(x, y):
            loss = ((lin(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        fn = jit.to_static(step) if mode == "static" else step
        runs[mode] = ([fn(data[i], targets[i]).detach() for i in range(5)],
                      [p.detach().clone() for p in lin.parameters()])
        if mode == "static":
            entry = fn.entries()[0]
    assert torch.equal(data, kept[0]) and torch.equal(targets, kept[1])
    assert all(torch.equal(a, b) for a, b in zip(runs["static"][0],
                                                 runs["eager"][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs["static"][1],
                                                 runs["eager"][1]))
    assert entry["captured"] and entry["replays"] == 4
    assert entry["arg_copies"] == 2 * 4


def test_a_written_argument_is_its_own_buffer(cpu_capture):
    """An argument the program writes is the buffer itself: the same
    tensor again copies nothing; another one is written (copied in and
    back), and the capturing call's tensor is left as that call left
    it."""
    def bump(cache, x):
        cache.add_(x)
        return cache.sum()

    sf = jit.to_static(bump)
    a, b, x = torch.zeros(3), torch.full((3,), 10.0), torch.ones(3)
    sf(a, x)
    sf(a, x)  # captures on a
    assert torch.equal(a, torch.full((3,), 2.0))
    assert sf.entries()[0]["arg_copies"] == 1  # x into its buffer
    out = sf(b, x)
    assert torch.equal(b, torch.full((3,), 11.0)) and float(out) == 33.0
    assert torch.equal(a, torch.full((3,), 2.0))
    sf(a, x)
    assert torch.equal(a, torch.full((3,), 3.0))
    assert sf.entries()[0]["arg_copies"] == 1 + 2 + 1


@pytest.mark.parametrize("clear_outside", [False, True])
def test_a_replay_leaves_the_steps_gradients(cpu_capture, clear_outside):
    """A step that runs backward and leaves the optimizer to its caller:
    after every call each gradient is the eager step's bit for bit, also
    after a clear_grad between the calls."""
    runs = {}
    batches = [torch.randn(8, 4, generator=torch.Generator().manual_seed(i))
               for i in range(4)]
    for mode in ("static", "eager"):
        lin, opt = _linear_trainer(1)

        def grad_step(x):
            loss = lin(x).square().mean()
            loss.backward()
            return loss

        fn = jit.to_static(grad_step) if mode == "static" else grad_step
        grads = []
        for x in batches:
            if mode == "eager":
                opt.clear_grad()  # a compiled call starts without them
            fn(x)
            grads.append([p.grad.clone() for p in lin.parameters()])
            opt.step()
            if clear_outside:
                opt.clear_grad()
        runs[mode] = grads
    for got, want in zip(runs["static"], runs["eager"]):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_an_uncapturable_optimizer_is_refused_before_the_step(cpu_capture):
    lin = torch.nn.Linear(4, 3)
    opt = Momentum(0.1, parameters=lin.parameters())
    before = [p.detach().clone() for p in lin.parameters()]

    def step(x):
        lin(x).sum().backward()
        opt.step()

    with pytest.raises(NotImplementedError, match="Momentum"):
        jit.to_static(step)(torch.ones(2, 4))
    assert all(torch.equal(a, p) for a, p in zip(before, lin.parameters()))
    assert all(p.grad is None for p in lin.parameters())


@pytest.mark.parametrize("beams", [1, 3])
def test_generate_use_jit_with_the_capture_path(gen_pair, cpu_capture,
                                                 monkeypatch, beams):
    """``generate(use_jit=True)`` through the capture path: the eager
    tokens; the prefill recorded and never captured; the decode step
    captured at its second call and replayed after it, copying the ids
    and the position in on each of those calls and never a cache."""
    _, tm, ids = gen_pair
    made = []
    to_static = jit.to_static

    def spy(fn, **kw):
        made.append(to_static(fn, **kw))
        return made[-1]

    monkeypatch.setattr(jit, "to_static", spy)
    new = 6
    eager = tm.generate(torch.from_numpy(ids), max_new_tokens=new,
                        num_beams=beams)
    compiled = tm.generate(torch.from_numpy(ids), max_new_tokens=new,
                           num_beams=beams, use_jit=True)
    assert torch.equal(compiled, eager)
    (sf,) = made
    prefill, decode = sf.entries()
    assert prefill["calls"] == 1 and not prefill["captured"]
    assert decode["captured"] and decode["replays"] == new - 2
    assert decode["arg_copies"] == 2 * (new - 2)
