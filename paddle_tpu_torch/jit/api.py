"""``@to_static`` of the port: a step recorded once, captured into a CUDA
graph on the card and replayed (counterpart of the reference's
``jit/api.py``, which traces a step into one XLA program).

* **Cache key** (the reference's ``_prepare``): the argument tree, each
  tensor's shape, dtype and device, the ``repr`` of each non-tensor
  leaf, the identity of the state tensors the function reaches
  (``framework/state.py``: the tensor object and its storage, so a state
  tensor rebound by ``p.data = ...`` keys a new entry, and a replay
  never writes a storage that is no longer the state's), and
  ``_mode_sig``: the ``training`` flag of every reachable module.
* **The first call of a signature** runs the function eagerly under the
  program recorder (``jit/program.py``), with every reachable
  parameter's gradient dropped first (a compiled call starts without
  gradients, as the reference's does). That call is a real step. The
  recorded program is linted (``framework/analysis.py``) and planned
  (``framework/planner.py``). State created inside the function is
  refused, as the reference refuses it. On the card an optimizer the
  function reaches that cannot be captured (``_capturable``) is refused
  before that call runs, so the refusal changes nothing.
* **Capture (CUDA tensors).** The second call of a signature captures
  the function into a ``torch.cuda.CUDAGraph`` (the recorded call, on
  the same side stream, was the warm-up a capture needs) and replays it
  once: that replay is the call's step. Every later call replays it. A
  signature called once (a prefill) is never captured. A capture that
  fails raises: nothing runs eagerly on the card in its place. CPU
  tensors never capture: each later call runs the function eagerly,
  which is the port's dispatch on the tensor's device, not a fallback.
  ``enable_to_static(False)`` runs every call eagerly.
* **Arguments.** The graph reads buffers its entry owns: a clone of
  each argument the recorded call did not write, into which every call
  copies its argument (``arg_copies`` counts those copies), so no
  tensor the caller holds is ever written by a later call. An argument
  the program writes (a KV cache) is its own buffer, the tensor the
  capturing call passed: a later call that passes that tensor copies
  nothing; one that passes another has it copied in and back after the
  replay, and the capturing call's tensor restored.
* **Outputs.** An output that is an argument or a state tensor is
  returned as that tensor; every other output is a clone, so that the
  next replay does not overwrite what the caller holds. The gradients
  the step leaves are outputs too: each replay binds every reachable
  parameter's ``grad`` to a clone of the gradient the capture left, or
  to None.
* **Host side effects run once, at capture**, as the reference's Python
  runs at trace time only: what varies from step to step must live on
  the device (AdamW's rate and beta powers do). A host read of a tensor
  raises (``program.HostReadError``). A capture counts no kernel
  launch; each replay adds those of the recorded call's program to
  ``kernel_launch_stats``.

Telemetry follows the reference: one compile event a signature, at its
recorded call (``compile.count``, ``compile.by_program.<name>``,
``compile.hbm_peak_bytes``, the ``jit.compile`` span, and
``compile.wall_s`` of the recorded call, lint and plan; the capture at
the second call observes ``compile.wall_s`` once more), ``exec.wall_s.<program>`` and
``exec.count.<program>`` a call, and the plan registered with the
performance ledger.
"""
from __future__ import annotations

import contextlib
import functools
import time
import weakref

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..framework import state as _state
from ..framework import telemetry as _telemetry
from ..framework.flags import flag
from ..ops import kernels as _kernels
from . import program as _program

_LIVE_STATICS: "weakref.WeakSet[StaticFunction]" = weakref.WeakSet()
_TO_STATIC_ENABLED = True
# the side stream of the recorded call and the capture, per device
_SIDE_STREAMS = {}


def live_static_functions():
    return list(_LIVE_STATICS)


def _refuse(name, value, default):
    if value != default:
        raise NotImplementedError(
            f"to_static({name}={value!r}): the reference accepts "
            f"{name} and never reads it; the port refuses it (ROADMAP "
            "queue 3)")


class _Entry:
    """One compiled signature: its program, lint report and plan, and on
    the card its graph with the buffers it reads and writes."""

    def __init__(self, static_meta):
        self.static_meta = static_meta
        self.program = None
        self.recorded = False      # a real recorded call ran
        self.compiled_event = False
        self.t_shapes = None
        self.lint_report = None
        self.resource_plan = None
        self.plan_report = None
        self.device = None
        self.graph = None
        self.static_args = ()  # the graph's argument buffers
        self.external = ()  # the storages the graph reads from outside
        self.written = ()
        self.grads = ()  # (parameter, the gradient the capture left)
        self.out_slots = None
        self.out_spec = None
        self.launches = {}
        self.params = ()
        self.exec_keys = None
        self.calls = 0
        self.replays = 0
        self.arg_copies = 0
        self.record_s = None
        self.capture_s = None
        self.pool_bytes = None
        self.record_peak_bytes = None

    def stats(self) -> dict:
        return {"calls": self.calls, "replays": self.replays,
                "arg_copies": self.arg_copies,
                "captured": self.graph is not None,
                "record_s": self.record_s, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes,
                "record_peak_bytes": self.record_peak_bytes,
                "n_ops": len(self.program) if self.program else 0,
                "launches_per_replay": dict(self.launches)}


def _identity(t):
    return (id(t), t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), tuple(t.stride()))


def _same_buffer(a, b) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr()
                      and a.stride() == b.stride())


def _side_stream(device):
    s = _SIDE_STREAMS.get(device)
    if s is None:
        s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return s


def _captures(device) -> bool:
    """Whether a signature whose tensors lie on ``device`` is captured
    (CUDA tensors are)."""
    return device.type == "cuda"


def _cuda_graph(run, device):
    """``run()`` captured into a CUDA graph on the side stream of
    ``device``, where the recorded call ran. Returns ``(graph, what run
    returned, the bytes the graph's pool reserved)``."""
    stream = _side_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        reserved = torch.cuda.memory_reserved(device)
        got = run()
    torch.cuda.synchronize(device)
    return graph, got, torch.cuda.memory_reserved(device) - reserved


class StaticFunction:
    def __init__(self, fn, input_spec=None, build_strategy=None,
                 backend=None, full_graph=True, property=False,
                 donate_state=True, lint_suppress=()):
        _refuse("input_spec", input_spec, None)
        _refuse("build_strategy", build_strategy, None)
        _refuse("backend", backend, None)
        _refuse("full_graph", full_graph, True)
        _refuse("property", property, False)
        if not donate_state:
            raise NotImplementedError(
                "to_static(donate_state=False): torch updates the state "
                "in place, so the port always has what donation gives "
                "the reference (ROADMAP queue 3)")
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._cache = {}
        self._lint_suppress = tuple(lint_suppress)
        _LIVE_STATICS.add(self)

    @property
    def program_name(self) -> str:
        return getattr(self._fn, "__name__", None) or "<to_static>"

    # -- the cache ------------------------------------------------------
    def _mode_sig(self):
        return tuple((id(m), m.training)
                     for m in _state.live_layers(self._fn))

    def _prepare(self, args, kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        tensors = [l for l in leaves if isinstance(l, torch.Tensor)]
        statics = [l for l in leaves if not isinstance(l, torch.Tensor)]
        state = _state.snapshot_state_tensors(self._fn)
        key = (str(spec),
               tuple((tuple(t.shape), t.dtype, t.device.type,
                      t.requires_grad) for t in tensors),
               tuple(repr(s) for s in statics),
               tuple(_identity(t) for t in state),
               self._mode_sig())
        entry = self._cache.get(key)
        if entry is None:
            entry = _Entry([
                (i, type(l).__name__,
                 l if isinstance(l, (int, float, bool)) else None)
                for i, l in enumerate(leaves)
                if not isinstance(l, (torch.Tensor, str, type(None)))])
            self._cache[key] = entry
        return entry, state, tensors

    def _finalized_entries(self):
        return [e for e in self._cache.values() if e.program is not None]

    def entries(self):
        """Every compiled entry's counters (:meth:`_Entry.stats`)."""
        return [e.stats() for e in self._finalized_entries()]

    # -- calls ----------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if not _TO_STATIC_ENABLED:
            return self._fn(*args, **kwargs)
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise NotImplementedError(
                "to_static in a job of several ranks: capturing "
                "collectives into a CUDA graph is not ported yet")
        entry, state, tensors = self._prepare(args, kwargs)
        if not entry.recorded:
            return self._compile(entry, state, tensors, args, kwargs)
        if flag("jit_lint") == "strict":
            self._lint_strict(entry)
        t0 = time.perf_counter()
        entry.calls += 1
        if entry.graph is not None:
            out = self._replay(entry, tensors)
        elif _captures(entry.device):
            out = self._capture(entry, state, tensors, args, kwargs)
        else:
            for p in entry.params:
                p.grad = None
            out = self._fn(*args, **kwargs)
        self._stamp(entry, time.perf_counter() - t0)
        return out

    def _lint_strict(self, entry):
        # an entry compiled under warn/off (or traced by analyze) must
        # keep failing under strict, linting now if it never ran
        from ..framework import analysis

        if entry.lint_report is None:
            entry.lint_report = analysis.lint_static_entry(self, entry)
        if entry.lint_report.blocking():
            raise analysis.JitLintError(entry.lint_report)

    def _stamp(self, entry, wall):
        if entry.exec_keys is not None:
            reg, wall_key, count_key = entry.exec_keys
            reg.observe(wall_key, wall)
            reg.inc(count_key)

    def _replay(self, entry, tensors):
        back = []
        with torch.no_grad():
            for t, buf, written in zip(tensors, entry.static_args,
                                       entry.written):
                if _same_buffer(t, buf):
                    continue
                if written:  # buf is the capturing caller's tensor
                    back.append((t, buf, buf.clone()))
                buf.copy_(t)
                entry.arg_copies += 1
        self._launch(entry)
        with torch.no_grad():
            for t, buf, kept in back:
                t.copy_(buf)
                buf.copy_(kept)
        return self._outputs(entry, tensors)

    def _launch(self, entry):
        """One replay of the graph, its launches counted and the
        gradients it left bound."""
        for p in entry.params:
            p.grad = None
        entry.graph.replay()
        _kernels.add_launches(entry.launches)
        entry.replays += 1
        for p, g in entry.grads:
            p.grad = g.clone()

    def _outputs(self, entry, tensors):
        leaves = []
        for kind, val in entry.out_slots:
            if kind == "arg":
                leaves.append(tensors[val])
            elif kind == "new":
                leaves.append(val.detach().clone())
            else:  # a state tensor or a non-tensor leaf
                leaves.append(val)
        return pytree.tree_unflatten(leaves, entry.out_spec)

    # -- compile: record, lint, plan, capture --------------------------
    def _device(self, tensors, state):
        for t in list(tensors) + list(state):
            if t.device.type == "cuda":
                return t.device
        return torch.device("cpu")

    def _compile(self, entry, state, tensors, args, kwargs):
        t_start = time.perf_counter()
        lint_mode, plan_mode = flag("jit_lint"), flag("jit_plan")
        if "strict" in (lint_mode, plan_mode):
            # strict modes fail before the step runs: judge a program
            # traced on fake tensors first
            try:
                if entry.program is None:
                    self._trace(entry, state, tensors, args, kwargs)
                self._judge(entry, lint_mode, plan_mode)
            except Exception:
                self._drop(entry)
                raise
        device = self._device(tensors, state)
        if _captures(device):
            self._refuse_uncapturable()
        params = _state.reachable_parameters(self._fn)
        for p in params:
            p.grad = None
        versions = [t._version for t in tensors]
        n_state = len(state)
        stream = None
        if device.type == "cuda":
            stream = _side_stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        try:
            with _program.recording() as rec, (
                    torch.cuda.stream(stream) if stream is not None
                    else contextlib.nullcontext()):
                inputs, held = rec.register(tensors), rec.register(state)
                out = self._fn(*args, **kwargs)
                left = [p.grad for p in params if p.grad is not None]
                prog = rec.program(inputs, held, out, left, device.type)
        except Exception:
            self._drop(entry)
            raise
        finally:
            if stream is not None:
                torch.cuda.current_stream(device).wait_stream(stream)
        entry.record_s = time.perf_counter() - t0
        if stream is not None:
            # what the caller keeps was allocated on the side stream:
            # its memory must not go back to that stream's pool while
            # the caller's stream may still use it
            for t in _program._tensors(out) + left:
                t.record_stream(torch.cuda.current_stream(device))
            # the allocator's peak since the caller last reset it, read
            # before the capture adds its pool
            entry.record_peak_bytes = torch.cuda.max_memory_allocated(
                device)
        if len(_state.snapshot_state_tensors(self._fn)) != n_state:
            self._drop(entry)
            raise RuntimeError(
                "to_static: new persistent state was created inside the "
                "compiled function (a lazily built module or optimizer "
                "state). Build every module and optimizer before the "
                "first compiled call.")
        entry.program, entry.recorded, entry.params = prog, True, params
        entry.device = device
        entry.t_shapes = [tuple(t.shape) for t in tensors]
        entry.written = [t._version != v for t, v in zip(tensors, versions)]
        entry.lint_report = entry.resource_plan = None
        self._judge(entry, lint_mode, plan_mode)
        entry.calls += 1
        self._compile_event(entry, time.perf_counter() - t_start)
        reg = _telemetry.registry()
        if reg is not None:  # the execution stamps, armed at compile
            prog = self.program_name
            entry.exec_keys = (reg, "exec.wall_s." + prog,
                               "exec.count." + prog)
        self._stamp(entry, entry.record_s)
        return out

    def _drop(self, entry):
        for k, v in list(self._cache.items()):
            if v is entry:
                del self._cache[k]

    def _judge(self, entry, lint_mode, plan_mode):
        """Lint and plan ``entry.program`` per the flags (raising under a
        strict mode with a blocking finding)."""
        from ..framework import analysis, planner

        if lint_mode != "off":
            entry.lint_report = analysis.lint_static_entry(self, entry)
            analysis.emit_report(entry.lint_report, lint_mode)
        if plan_mode != "off":
            entry.resource_plan, entry.plan_report = \
                planner.plan_static_entry(self, entry)
            planner.emit_plan_report(entry.plan_report, plan_mode)

    def _refuse_uncapturable(self):
        _, optimizers, _ = _state.reachable_objects(self._fn)
        bad = sorted({type(o).__name__ for o in optimizers
                      if not o._capturable})
        if bad:
            raise NotImplementedError(
                f"jit.to_static on the card: {', '.join(bad)} keeps its "
                "step-varying scalars on the host, which a CUDA graph "
                "would bake in, so a compiled step cannot use it yet "
                "(only AdamW and Adam are capturable)")

    def _capture(self, entry, state, tensors, args, kwargs):
        """The signature's second call: capture its graph on the entry's
        buffers and replay it once, which is this call's step."""
        t0 = time.perf_counter()
        with torch.no_grad():
            bufs = [t if w else t.detach().clone().requires_grad_(
                t.requires_grad) for t, w in zip(tensors, entry.written)]
        entry.arg_copies += sum(1 for w in entry.written if not w)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        it = iter(bufs)
        cargs, ckwargs = pytree.tree_unflatten(
            [next(it) if isinstance(l, torch.Tensor) else l
             for l in leaves], spec)
        saved = [p.grad for p in entry.params]
        for p in entry.params:
            p.grad = None

        def run():
            out = self._fn(*cargs, **ckwargs)
            return out, [(p, p.grad) for p in entry.params
                         if p.grad is not None]

        try:
            with _program.capture_scope(), \
                    _program.capture_guard() as guard:
                graph, (out, grads), entry.pool_bytes = _cuda_graph(
                    run, entry.device)
        except Exception:
            for p, g in zip(entry.params, saved):
                p.grad = g
            self._drop(entry)
            raise
        arg_pos = {id(b): i for i, b in enumerate(bufs)}
        state_ids = {id(t) for t in state}
        leaves, entry.out_spec = pytree.tree_flatten(out)
        slots = []
        for leaf in leaves:
            if not isinstance(leaf, torch.Tensor):
                slots.append(("static", leaf))
            elif id(leaf) in arg_pos:
                slots.append(("arg", arg_pos[id(leaf)]))
            elif id(leaf) in state_ids:
                slots.append(("state", leaf))
            else:
                slots.append(("new", leaf))
        entry.out_slots = slots
        entry.static_args, entry.grads = bufs, grads
        entry.external = list(guard.external.values())
        entry.launches = entry.program.launches()
        entry.graph = graph
        entry.capture_s = time.perf_counter() - t0
        reg = _telemetry.registry()
        if reg is not None:
            reg.observe("compile.wall_s", entry.capture_s)
        self._launch(entry)
        return self._outputs(entry, tensors)

    def _compile_event(self, entry, wall):
        if entry.compiled_event:
            return
        entry.compiled_event = True
        reg, tr = _telemetry.registry(), _telemetry.tracer()
        prog = self.program_name
        plan = entry.resource_plan
        if reg is not None:
            if plan is not None:
                from ..framework import perf_ledger

                perf_ledger.register_plan(prog, plan)
            reg.inc("compile.count")
            reg.inc("compile.by_program." + prog)
            reg.observe("compile.wall_s", wall)
            if plan is not None:
                reg.observe("compile.hbm_peak_bytes",
                            float(plan.hbm_peak_bytes))
        if tr is not None:
            lint = entry.lint_report.counts() \
                if entry.lint_report is not None else {}
            tr.add_complete(
                "jit.compile", _telemetry.clock() - wall, wall,
                cat="compile",
                attrs={"program": prog,
                       "variant": len(self._finalized_entries()),
                       "n_eqns": len(entry.program), "lint": lint})

    # -- tracing without executing (jit.analyze / jit.plan) -------------
    def _trace(self, entry, state, tensors, args, kwargs):
        """Record ``entry.program`` from a run on fake tensors: every
        state tensor and argument stays as it was (the kernel wrappers
        run their plain versions on fake tensors, launching nothing), and
        the gradients, optimizer host scalars and scheduler fields the
        run rebinds are put back."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        params = _state.reachable_parameters(self._fn)
        grads = [p.grad for p in params]
        _, optimizers, schedulers = _state.reachable_objects(self._fn)
        aux = [(lst, list(lst)) for o in optimizers
               for lst in o._aux.values()]
        fields = [(s, dict(vars(s))) for s in schedulers]
        for p in params:
            p.grad = None
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                with _program.recording() as rec:
                    inputs, held = rec.register(tensors), rec.register(state)
                    out = self._fn(*args, **kwargs)
                    left = [p.grad for p in params if p.grad is not None]
                    device = self._device(tensors, state).type
                    entry.program = rec.program(inputs, held, out, left,
                                                device)
        finally:
            for p, g in zip(params, grads):
                p.grad = g
            for lst, saved in aux:
                lst[:] = saved
            for s, saved in fields:
                vars(s).clear()
                vars(s).update(saved)
        entry.t_shapes = [tuple(t.shape) for t in tensors]
        return entry

    def trace_for_analysis(self, *args, **kwargs):
        """The cache entry of the example arguments, its program traced
        without executing when it has none. Lint and plan are the
        caller's (``jit.analyze`` / ``jit.plan``)."""
        entry, state, tensors = self._prepare(args, kwargs)
        if entry.program is None:
            t0 = time.perf_counter()
            self._trace(entry, state, tensors, args, kwargs)
            self._compile_event(entry, time.perf_counter() - t0)
        return entry


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    def decorate(fn):
        if isinstance(fn, StaticFunction):
            return fn
        return StaticFunction(fn, input_spec=input_spec,
                              build_strategy=build_strategy,
                              backend=backend, **kwargs)

    if function is not None:
        return decorate(function)
    return decorate


def _entries_for(function, example_args, example_kwargs, what):
    sf = function if isinstance(function, StaticFunction) \
        else StaticFunction(function)
    if example_args or example_kwargs:
        args = tuple(_as_tensor(a) for a in example_args)
        kwargs = {k: _as_tensor(v) for k, v in example_kwargs.items()}
        return sf, [sf.trace_for_analysis(*args, **kwargs)]
    entries = sf._finalized_entries()
    if not entries:
        raise ValueError(
            f"{what}(fn) without example args needs an already-compiled "
            f"@to_static function (call it once, or pass example inputs: "
            f"{what}(fn, x, y))")
    return sf, entries


def _as_tensor(x):
    import numpy as np

    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def analyze(function, *example_args, suppress=(), **example_kwargs):
    """Run the trace-time linter (``framework/analysis.py``) on a
    compiled function and return an ``AnalysisReport``, without
    executing it: ``analyze(static_fn)`` lints every entry it compiled;
    ``analyze(fn, *example_args)`` traces the function on the examples
    (on fake tensors: nothing runs, nothing changes) and lints that.
    Runs whatever FLAGS_jit_lint says; ``suppress`` silences rule ids
    for this call."""
    from ..framework import analysis

    sf, entries = _entries_for(function, example_args, example_kwargs,
                               "analyze")
    reports = [analysis.lint_static_entry(sf, e, suppress=suppress)
               for e in entries]
    if len(reports) == 1:
        return reports[0]
    return analysis.AnalysisReport.merge(
        reports, name=reports[0].name + " (%d variants)" % len(reports))


def plan(function, *example_args, **example_kwargs):
    """Run the static resource planner (``framework/planner.py``) on a
    compiled function and return its ``ResourcePlan`` (a list when it
    compiled several entries), without executing it, as :func:`analyze`
    does. Never raises on findings."""
    from ..framework import planner

    sf, entries = _entries_for(function, example_args, example_kwargs,
                               "plan")
    plans = [planner.plan_static_entry(sf, e)[0] for e in entries]
    return plans[0] if len(plans) == 1 else plans


def not_to_static(fn=None):
    return fn


def enable_to_static(flag: bool):
    """``False``: every ``to_static`` function runs eagerly (on the card
    too) until it is enabled again."""
    global _TO_STATIC_ENABLED
    _TO_STATIC_ENABLED = bool(flag)


class ignore_module:
    """Accepted for the reference's API; it reads nothing either."""

    def __init__(self, modules):
        pass
