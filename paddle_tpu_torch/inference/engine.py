"""Async serving engine of the port (counterpart of the reference's
``inference/engine.py``): a background step pump, per-caller token
streams and goodput-gated admission over a ``BatchScheduler``.

The scheduler (serving.py) is a synchronous object a caller cranks with
``step()``; it registers its queue and state as single-writer shared
variables with the concurrency sanitizer. ``ServingEngine`` turns it into
a server without breaking that contract:

- **One pump thread.** ``start()`` spawns a single sanctioned thread
  (``concurrency.spawn_thread``) that runs ``scheduler.step()``
  continuously. Every scheduler mutation (submit, adopt, cancel, the
  queued-deadline sweep, the capacity apply, step) happens on that
  thread. Every CUDA launch and the step's device-to-host logits copy
  run there too: the event loop never touches a device tensor, and
  nothing in an ``async def`` here sleeps, acquires a lock, opens a file
  or synchronizes the card.
- **Lock-free marshalling.** Callers talk to the pump through an op
  inbox (``collections.deque``): the event-loop thread is the only
  producer (``append``) and the pump the only consumer (``popleft``);
  both are atomic under the GIL. Results flow back as
  ``loop.call_soon_threadsafe`` completions of per-op futures.
- **Per-token streaming.** ``await engine.submit(req)`` resolves to a
  ``TokenStream``, an async iterator fed from the pump through the
  request's ``on_token`` hook. The hook only queues; after each step
  ``_flush_tokens`` ships each stream's tokens of that step in ONE loop
  hop. Cancelling the consuming task propagates to the scheduler as an
  abort with deadline semantics; ``await stream.cancel()`` does the same
  explicitly.
- **Deadline granularity.** Between steps the pump runs
  ``scheduler.expire_queued_deadlines()``, so a request whose deadline
  lapsed while queued is aborted before it burns a prefill.
- **Goodput-gated admission.** The gate reads the live ``serving.goodput``
  and ``serving.slo_window_requests`` gauges and watches six watchdog
  classes (recompile-storm, decode-stall, preemption-thrash, plan-drift,
  pool-pressure, sanitizer-spike) for fresh events. Sustained bad signal
  escalates OPEN -> SHED (reject admissions below
  ``FLAGS_engine_shed_keep_priority``) -> CLAMP (reject all); sustained
  good signal de-escalates one level at a time, with trip and recovery
  streaks (``FLAGS_engine_trip_steps`` / ``FLAGS_engine_recover_steps``)
  and a goodput band between ``FLAGS_engine_goodput_low`` and
  ``FLAGS_engine_goodput_high`` that freezes both.
- **Pump errors.** An exception on the pump thread (a kernel or device
  error inside ``step()``) is recorded, every stream still open ends by
  raising :class:`EngineClosedError` carrying it, every op still queued
  is refused with it, and ``drain()``/``shutdown()`` raise it. No caller
  sees a truncated stream end as if it had finished.
- **Ops front door.** With ``FLAGS_ops_server_port`` set, the pump's first
  act arms the embedded ops server and registers an ``/enginez`` section:
  pump state, inflight streams, backpressure state and reason, recent
  transitions and the last shed decisions.

One engine per scheduler: a second engine (or a manual ``step()`` from
another thread) would bring back the multi-writer hazard the scheduler's
sanitizer registration exists to catch.
"""
from __future__ import annotations

import asyncio
import collections
import threading

from ..framework import concurrency as _concurrency
from ..framework import telemetry
from ..framework.flags import flag
from .serving import QueueFullError, RequestState

__all__ = [
    "ServingEngine",
    "TokenStream",
    "EngineClosedError",
    "EngineOverloadError",
    "BP_OPEN",
    "BP_SHED",
    "BP_CLAMP",
]

# backpressure gate levels (published as engine.backpressure_state)
BP_OPEN = 0    # admit everything
BP_SHED = 1    # reject admissions below the keep-priority floor
BP_CLAMP = 2   # reject all new admissions

_BP_NAMES = ("open", "shed", "clamp")

# the six watchdog classes that drive the gate (prefix-collapse is
# informational — a cache regression, not an overload symptom)
_GATE_WD_CLASSES = (
    "recompile-storm",
    "decode-stall",
    "preemption-thrash",
    "plan-drift",
    "pool-pressure",
    "sanitizer-spike",
)

_ENGINE_SEQ = [0]  # concurrency: single-writer (engine ctor thread)

_EOS = object()    # stream terminator sentinel


class _PumpFailed:
    """Stream terminator after a pump error: the consumer raises."""

    __slots__ = ("error",)

    def __init__(self, error):
        self.error = error


class EngineClosedError(RuntimeError):
    """Raised by submit() when the engine is not started, draining,
    or stopped."""


class EngineOverloadError(QueueFullError):
    """Raised by submit() when the live-SLO admission gate sheds or
    clamps the request. Subclasses QueueFullError so callers with
    existing overload handling keep working."""


class TokenStream:
    """Async iterator over one request's generated tokens.

    Created by ``ServingEngine.submit``; tokens arrive as the pump
    commits them (``async for tok in stream``). Iteration ends when
    the request retires — check ``stream.state`` /
    ``stream.aborted`` afterwards to distinguish FINISHED from
    ABORTED_DEADLINE. Cancelling the consuming task while it awaits
    the next token propagates a cancel to the engine (client
    disconnect == deadline-abort semantics); ``await cancel()`` does
    so explicitly.
    """

    def __init__(self, engine, req):
        self._engine = engine
        self.req = req
        self._q = asyncio.Queue()
        self._ended = False

    @property
    def req_id(self):
        return self.req.req_id

    @property
    def state(self):
        """Live request state (GIL-atomic snapshot of the pump's
        writes)."""
        return self.req.state

    @property
    def aborted(self):
        return self.req.state == RequestState.ABORTED_DEADLINE

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._ended:
            raise StopAsyncIteration
        try:
            item = await self._q.get()
        except asyncio.CancelledError:
            # consumer disconnected mid-stream: tell the pump to
            # abort the request (lock-free post; never blocks)
            self._engine._post(("cancel", self.req.req_id, None, None))
            raise
        if item is _EOS:
            self._ended = True
            raise StopAsyncIteration
        if isinstance(item, _PumpFailed):
            self._ended = True
            raise EngineClosedError(
                "engine pump failed before request %r retired: %s"
                % (self.req.req_id, item.error))
        return item

    async def tokens(self):
        """Drain the stream to completion; returns the streamed
        token ids (``req.generated_ids`` stays authoritative)."""
        out = []
        async for tok in self:
            out.append(tok)
        return out

    async def cancel(self):
        """Abort the request (deadline-abort semantics). Returns
        True if the scheduler still knew the request."""
        if self._ended:
            return False
        return await self._engine.cancel(self.req.req_id)

    # -- pump side (always via loop.call_soon_threadsafe) ----------

    def _deliver(self, tok):
        if not self._ended:
            self._q.put_nowait(tok)

    def _deliver_many(self, toks):
        # one loop hop delivers a whole step's committed tokens —
        # speculative rounds commit up to draft_k+1 per stream per
        # step (see ServingEngine._flush_tokens)
        if not self._ended:
            for tok in toks:
                self._q.put_nowait(tok)

    def _finish(self):
        self._q.put_nowait(_EOS)

    def _fail(self, error):
        self._q.put_nowait(_PumpFailed(error))


class ServingEngine:
    """Asyncio front-end that owns a ``BatchScheduler`` and pumps it
    continuously on one sanctioned background thread.

    Usage::

        async with ServingEngine(scheduler) as eng:
            stream = await eng.submit(Request("r1", ids))
            async for tok in stream:
                ...

    or explicitly: ``await eng.start()`` ... ``await
    eng.shutdown()``. See the module docstring for the pump /
    marshalling / backpressure model.
    """

    def __init__(self, scheduler):
        self.scheduler = scheduler
        _ENGINE_SEQ[0] += 1
        self._uid = "e%d" % _ENGINE_SEQ[0]
        self._metrics = telemetry.registry() \
            if telemetry.metrics_on() else None

        # loop <-> pump marshalling: the event-loop thread is the
        # only producer (append), the pump the only consumer
        # (popleft); both deque ops are GIL-atomic, so this channel
        # is deliberately NOT a sanitizer shared var — it has two
        # touching threads by design and no lock by design.
        self._inbox = collections.deque()
        self._wake = threading.Event()
        self._loop = None
        self._thread = None
        self._closing = False  # loop-side: set before the stop op

        # pump-owned state (single writer: the pump thread); other
        # threads (/enginez handler, stream properties) take
        # GIL-atomic snapshots only. _cv_pump is the sanitizer's
        # witness for that contract.
        self._streams = {}
        # per-step token coalescing: the on_token hook
        # only QUEUES committed tokens here (pump thread, inside
        # scheduler.step()); _flush_tokens marshals each stream's
        # whole batch with ONE call_soon_threadsafe after the step —
        # a speculative round commits up to draft_k+1 tokens per
        # stream per step, and one loop hop per token would multiply
        # the marshalling cost by the acceptance rate
        self._pending_toks = {}
        self._bp_state = BP_OPEN
        self._bp_reason = ""
        self._bp_since = 0
        self._bad_streak = 0
        self._good_streak = 0
        self._trips = 0
        self._recoveries = 0
        self._transitions = ()   # newest-first (state, reason, step)
        self._last_shed = ()     # newest-first shed decisions
        self._wd_counts = None
        self._pump_steps = 0
        self._idle_waits = 0
        self._last_step_wall = 0.0
        self._pump_error = None
        # set by the pump just before its final inbox sweep: an op
        # posted after that is refused by the poster (see _post)
        self._pump_done = False
        self._submitted = 0
        self._adopted = 0
        self._completed = 0
        self._cancelled = 0
        self._shed = 0
        self._draining = False
        self._drain_futs = []
        self._stop = False
        self._stop_futs = []

        csan = _concurrency.sanitizer()
        self._cv_pump = None
        if csan is not None:
            self._cv_pump = csan.shared(
                "engine.%s.pump" % self._uid, owner=self,
                single_writer=True)

        # gate thresholds are read once at construction, like the
        # scheduler's own flags
        self._gp_low = float(flag("engine_goodput_low"))
        self._gp_high = float(flag("engine_goodput_high"))
        self._min_window = int(flag("engine_min_window"))
        self._trip_steps = max(1, int(flag("engine_trip_steps")))
        self._recover_steps = max(1, int(flag("engine_recover_steps")))
        self._gate_stride = max(1, int(flag("engine_gate_stride")))
        self._keep_priority = int(flag("engine_shed_keep_priority"))
        self._idle_wait = float(flag("engine_idle_wait_s"))

    @property
    def backpressure_state(self):
        """Live admission-gate level (``BP_OPEN``/``BP_SHED``/
        ``BP_CLAMP``) — a GIL-atomic snapshot of pump-owned state,
        safe from any thread. The disaggregated ``SessionRouter``
        republishes the fleet-wide max of this as
        ``router.backpressure_state``."""
        return self._bp_state

    # -- lifecycle (event-loop side) -------------------------------

    async def start(self):
        """Spawn the pump thread and (if armed) register /enginez on
        the embedded ops server. Idempotent; returns self."""
        if self._thread is not None:
            return self
        self._loop = asyncio.get_running_loop()
        # NOTE: nothing lock-taking happens here — the registry and
        # ops-server provider guards are blocking locks and this
        # coroutine runs on the event loop (the sanitizer's
        # blocking-acquire-on-loop class); the pump thread publishes
        # the initial gauges and registers /enginez instead
        self._thread = _concurrency.spawn_thread(
            "paddle-engine-pump-" + self._uid, self._pump_main)
        return self

    async def __aenter__(self):
        return await self.start()

    async def __aexit__(self, exc_type, exc, tb):
        await self.shutdown(drain=exc_type is None)
        return False

    async def submit(self, req):
        """Admit ``req`` and return its ``TokenStream``.

        Raises ``EngineOverloadError`` when the backpressure gate
        sheds/clamps it, ``EngineClosedError`` when the engine is
        not running, and re-raises scheduler validation errors
        (``QueueFullError``, ``ValueError``) unchanged.
        """
        self._require_running()
        stream = TokenStream(self, req)
        fut = self._loop.create_future()
        self._post(("submit", req, stream, fut))
        return await fut

    async def adopt(self, req, payloads):
        """Adopt a handed-off request from a prefill worker (see
        ``BatchScheduler.adopt_swapped``) and return its
        ``TokenStream`` — decode-side tokens stream exactly like a
        locally submitted request's.

        The backpressure gate applies only its CLAMP level here: a
        shedding decode worker still adopts, because the prefill
        worker already spent the FLOPs and shipped the bytes —
        dropping the chain now would waste both, whereas a clamped
        engine is past the point where finishing foreign work is
        safe. Raises ``EngineOverloadError`` on clamp,
        ``EngineClosedError`` when not running, and re-raises
        scheduler validation errors unchanged.
        """
        self._require_running()
        stream = TokenStream(self, req)
        fut = self._loop.create_future()
        self._post(("adopt", (req, payloads), stream, fut))
        return await fut

    async def cancel(self, req_id):
        """Abort a request by id (deadline-abort semantics); True if
        the scheduler still knew it."""
        self._require_running()
        fut = self._loop.create_future()
        self._post(("cancel", req_id, None, fut))
        return await fut

    async def apply_config(self, config):
        """Apply a capacity config (framework/autotuner.py knobs) at
        the next step boundary: the dict is marshalled onto the pump
        thread and applied between ``scheduler.step()`` calls through
        ``autotuner.apply_config`` — the one sanctioned seam — so
        the single-writer contract and the scheduler's
        boundary-only rule both hold by construction. Engine-owned
        knobs (the goodput band) retarget the live gate thresholds
        too. Returns the dict of knobs actually applied."""
        self._require_running()
        fut = self._loop.create_future()
        self._post(("tune", dict(config), None, fut))
        return await fut

    async def drain(self):
        """Stop admitting, then wait until every inflight stream has
        retired."""
        if self._thread is None:
            return
        fut = self._loop.create_future()
        self._post(("drain", None, None, fut))
        await fut
        self._raise_pump_error()

    async def shutdown(self, drain=True):
        """Drain (optional) and stop the pump. After this the engine
        rejects submissions."""
        if self._thread is None:
            return
        if drain:
            try:
                await self.drain()
            except EngineClosedError:
                pass  # the pump failed: stop it below, then raise
        self._closing = True
        fut = self._loop.create_future()
        self._post(("stop", None, None, fut))
        await fut
        # the pump resolved `fut` as its last act; the thread is at
        # (or microseconds from) exit, so this join cannot stall the
        # loop in any meaningful way
        self._thread.join(timeout=5.0)
        self._thread = None
        self._raise_pump_error()

    def close(self):
        """Synchronous emergency stop (no drain): for non-async
        teardown paths. Inflight streams are finished truncated."""
        if self._thread is None:
            return
        self._closing = True
        self._post(("stop", None, None, None))
        self._thread.join(timeout=5.0)
        self._thread = None

    def _require_running(self):
        if self._thread is None or self._closing \
                or not self._thread.is_alive():
            raise EngineClosedError(
                "engine is not running — `await engine.start()` "
                "first (or use `async with ServingEngine(...)`)")

    def _raise_pump_error(self):
        if self._pump_error is not None:
            raise EngineClosedError(
                "engine pump failed: %s" % self._pump_error)

    def _post(self, op):
        """Loop-side producer: enqueue an op for the pump and wake
        it. Lock-free (see module docstring). An op posted after the
        pump exited is refused here, so no caller awaits a dead pump."""
        self._inbox.append(op)
        self._wake.set()
        if self._pump_done:
            self._reject_inbox()

    # -- cross-thread helpers --------------------------------------

    def _call_loop(self, cb, *args):
        try:
            self._loop.call_soon_threadsafe(cb, *args)
        except RuntimeError:
            # loop already closed (teardown race); nothing to notify
            pass

    def _resolve(self, fut, result=None, exc=None):
        if fut is None:
            return

        def _set():
            if not fut.cancelled():
                if exc is not None:
                    fut.set_exception(exc)
                else:
                    fut.set_result(result)

        self._call_loop(_set)

    # -- pump thread -----------------------------------------------

    def _pump_main(self):
        sched = self.scheduler
        last_end = None
        try:
            self._pump_arm()
            while True:
                self._wake.clear()
                if not self._pump_ops():
                    break
                # satellite: queued requests whose deadline lapsed
                # while waiting are aborted BEFORE burning a prefill
                if sched.expire_queued_deadlines():
                    self._note_write()
                self._pump_retire()
                if self._draining:
                    self._pump_check_drained()
                if sched.num_queued or sched.num_active \
                        or sched.num_swapped:
                    now = telemetry.clock()
                    if last_end is not None \
                            and self._metrics is not None:
                        # pump scheduling lag: host time between the
                        # end of one step and the start of the next
                        self._metrics.observe(
                            "engine.step_lag_s", now - last_end)
                    sched.step()
                    last_end = telemetry.clock()
                    self._note_write()
                    self._pump_steps += 1
                    self._last_step_wall = last_end - now
                    self._pump_retire()
                    if self._pump_steps % self._gate_stride == 0:
                        self._gate_eval()
                else:
                    last_end = None
                    self._note_write()
                    self._idle_waits += 1
                    if self._bp_state != BP_OPEN:
                        # liveness: a clamped engine with an empty
                        # scheduler never steps, so the gate must
                        # keep evaluating while idle or it could
                        # never recover and admit work again
                        self._gate_eval()
                    self._wake.wait(self._idle_wait)
        except BaseException as e:
            # recorded for every stream, op and drain (_pump_shutdown),
            # then re-raised on this thread
            self._pump_error = repr(e)
            raise
        finally:
            self._pump_shutdown()

    def _pump_arm(self):
        """First pump act: publish the initial gauges and register
        /enginez. Runs here, not in start(), because both take
        blocking guarded locks that must never be acquired on the
        event loop."""
        self._note_write()
        if self._metrics is None:
            return
        self._metrics.gauge("engine.backpressure_state", BP_OPEN)
        self._metrics.gauge("engine.inflight_streams", 0)
        if int(flag("ops_server_port")) > 0:
            from ..framework import ops_server as _ops_server
            srv = _ops_server.maybe_start()
            if srv is not None:
                srv.add_engine_provider(
                    "engine." + self._uid, self._enginez_info)

    def _note_write(self):
        # manual single-writer instrumentation: witness that this
        # pump-state mutation happened on the pump thread
        if self._cv_pump is not None:
            self._cv_pump.write()

    def _pump_ops(self):
        """Drain the inbox, applying each marshalled op on the pump
        thread. Returns False once a stop was requested."""
        while True:
            try:
                op = self._inbox.popleft()
            except IndexError:
                break
            kind, arg, stream, fut = op
            if kind == "submit":
                self._pump_submit(arg, stream, fut)
            elif kind == "adopt":
                self._pump_adopt(arg[0], arg[1], stream, fut)
            elif kind == "cancel":
                self._pump_cancel(arg, fut)
            elif kind == "tune":
                self._pump_tune(arg, fut)
            elif kind == "drain":
                self._note_write()
                self._draining = True
                self._drain_futs.append(fut)
            elif kind == "stop":
                self._note_write()
                self._stop = True
                if fut is not None:
                    self._stop_futs.append(fut)
        return not self._stop

    def _pump_submit(self, req, stream, fut):
        if self._draining or self._stop:
            self._resolve(fut, exc=EngineClosedError(
                "engine is draining/stopping; submission rejected"))
            return
        why = self._gate_admit(req)
        if why is not None:
            self._note_write()
            self._shed += 1
            self._last_shed = ((req.req_id, req.priority, why),
                               ) + self._last_shed[:7]
            if self._metrics is not None:
                self._metrics.inc("engine.shed_total")
            self._resolve(fut, exc=EngineOverloadError(why))
            return
        inner = req.on_token
        req.on_token = self._make_on_token(stream, inner)
        try:
            self.scheduler.submit(req)
        except Exception as e:
            req.on_token = inner
            self._resolve(fut, exc=e)
            return
        self._note_write()
        self._streams[req.req_id] = stream
        self._submitted += 1
        if self._metrics is not None:
            self._metrics.inc("engine.submitted")
            self._metrics.gauge(
                "engine.inflight_streams", len(self._streams))
        self._resolve(fut, result=stream)

    def _pump_adopt(self, req, payloads, stream, fut):
        if self._draining or self._stop:
            self._resolve(fut, exc=EngineClosedError(
                "engine is draining/stopping; adoption rejected"))
            return
        if self._bp_state == BP_CLAMP:
            # SHED still adopts (the prefill FLOPs and wire bytes
            # are already spent); only a clamped engine refuses
            self._note_write()
            self._shed += 1
            self._last_shed = ((req.req_id, req.priority,
                                "adopt-clamp"),) + self._last_shed[:7]
            if self._metrics is not None:
                self._metrics.inc("engine.shed_total")
            self._resolve(fut, exc=EngineOverloadError(
                "queue-clamp (%s)" % self._bp_reason))
            return
        inner = req.on_token
        req.on_token = self._make_on_token(stream, inner)
        try:
            self.scheduler.adopt_swapped(req, payloads)
        except Exception as e:
            req.on_token = inner
            self._resolve(fut, exc=e)
            return
        self._note_write()
        self._streams[req.req_id] = stream
        self._adopted += 1
        if self._metrics is not None:
            self._metrics.inc("engine.adopted")
            self._metrics.gauge(
                "engine.inflight_streams", len(self._streams))
        self._resolve(fut, result=stream)

    def _make_on_token(self, stream, inner):
        pending = self._pending_toks

        def hook(req, tok, is_prompt):
            if inner is not None:
                inner(req, tok, is_prompt)
            if not is_prompt:
                # pump thread (inside scheduler.step()): queue only;
                # _flush_tokens ships the step's batch in one hop
                ent = pending.get(req.req_id)
                if ent is None:
                    pending[req.req_id] = ent = (stream, [])
                ent[1].append(int(tok))

        return hook

    def _flush_tokens(self):
        """Deliver every token queued by the on_token hooks since the
        last flush — one ``call_soon_threadsafe`` per STREAM, not per
        token. Runs before any ``_finish`` marshalling (same FIFO
        loop queue), so a retiring stream's last tokens always
        precede its EOS."""
        if not self._pending_toks:
            return
        self._note_write()
        # drain IN PLACE: the on_token hooks hold a reference to this
        # dict, so swapping in a fresh one would orphan them
        pending = list(self._pending_toks.values())
        self._pending_toks.clear()
        for stream, toks in pending:
            self._call_loop(stream._deliver_many, toks)

    def _pump_cancel(self, req_id, fut):
        ok = False
        if req_id in self._streams:
            ok = self.scheduler.cancel(req_id, reason="cancelled")
        if ok:
            self._note_write()
            self._cancelled += 1
            if self._metrics is not None:
                self._metrics.inc("engine.cancelled")
        self._pump_retire()
        self._resolve(fut, result=ok)

    def _pump_tune(self, cfg, fut):
        # runs between step()s on the pump thread: the autotuner
        # seam mutates the flags + scheduler knobs, then the
        # engine-owned goodput band retargets the live gate
        self._note_write()
        try:
            from ..framework import autotuner as _autotuner

            applied = _autotuner.apply_config(
                cfg, scheduler=self.scheduler)
            if "engine_goodput_low" in cfg:
                self._gp_low = float(cfg["engine_goodput_low"])
                applied["engine_goodput_low"] = self._gp_low
            if "engine_goodput_high" in cfg:
                self._gp_high = float(cfg["engine_goodput_high"])
                applied["engine_goodput_high"] = self._gp_high
        except Exception as e:
            self._resolve(fut, exc=e)
            return
        self._resolve(fut, result=applied)

    def _pump_retire(self):
        self._flush_tokens()
        if not self._streams:
            return
        done = [rid for rid, s in self._streams.items()
                if s.req.terminal]
        if not done:
            return
        self._note_write()
        for rid in done:
            stream = self._streams.pop(rid)
            self._completed += 1
            self._call_loop(stream._finish)
        if self._metrics is not None:
            self._metrics.gauge(
                "engine.inflight_streams", len(self._streams))

    def _pump_check_drained(self):
        # _draining stays True once set: drain is terminal — the
        # engine keeps rejecting submissions after the quiesce (the
        # normal next step is shutdown)
        if not self._drain_futs:
            return
        sched = self.scheduler
        if self._streams or sched.num_queued or sched.num_active \
                or sched.num_swapped:
            return
        self._note_write()
        futs, self._drain_futs = self._drain_futs, []
        for f in futs:
            self._resolve(f, result=True)

    def _pump_shutdown(self):
        self._flush_tokens()
        self._note_write()
        self._stop = True
        self._reject_inbox()
        streams, self._streams = self._streams, {}
        for stream in streams.values():
            if self._pump_error is not None:
                self._call_loop(stream._fail, self._pump_error)
            else:
                self._call_loop(stream._finish)
        if self._metrics is not None:
            self._metrics.gauge("engine.inflight_streams", 0)
        for f in self._drain_futs:
            self._resolve(f, result=False)
        self._drain_futs = []
        for f in self._stop_futs:
            self._resolve(f, result=True)
        self._stop_futs = []
        # a second sweep after the futures above: an op posted while
        # this shutdown was mid-flight must still get an answer; one
        # posted after this flag is set is refused by _post itself
        self._pump_done = True
        self._reject_inbox()

    def _reject_inbox(self):
        """Resolve every op still marshalled but never processed so
        no caller is left awaiting a dead pump."""
        while True:
            try:
                kind, arg, stream, fut = self._inbox.popleft()
            except IndexError:
                return
            if kind == "cancel":
                self._resolve(fut, result=False)
            elif kind == "drain":
                self._resolve(fut, result=False)
            elif kind == "stop":
                self._resolve(fut, result=True)
            else:
                why = "engine pump exited before processing this " \
                    "submission"
                if self._pump_error:
                    why += " (pump error: %s)" % self._pump_error
                self._resolve(fut, exc=EngineClosedError(why))

    # -- backpressure gate (pump thread) ---------------------------

    def _gate_admit(self, req):
        """Admission decision for one request; returns a rejection
        reason or None."""
        if self._bp_state == BP_OPEN:
            return None
        if self._bp_state == BP_CLAMP:
            return "queue-clamp (%s)" % self._bp_reason
        if req.priority < self._keep_priority:
            return ("shedding priority<%d admissions (%s)"
                    % (self._keep_priority, self._bp_reason))
        return None

    def _gate_eval(self):
        """Re-evaluate the gate off live SLO gauges + fresh watchdog
        events. Escalates/de-escalates one level per streak, with a
        goodput hysteresis band that freezes both streaks."""
        bad_why = None
        in_band = False
        if self._metrics is not None:
            gp = self._metrics.gauge_value("serving.goodput")
            nwin = self._metrics.gauge_value(
                "serving.slo_window_requests") or 0
            if gp is not None and nwin >= self._min_window:
                if gp < self._gp_low:
                    bad_why = ("goodput %.2f < %.2f over %d requests"
                               % (gp, self._gp_low, int(nwin)))
                elif gp < self._gp_high:
                    in_band = True
        wd = getattr(self.scheduler, "watchdog", None)
        if wd is not None:
            counts = dict(
                (wd.summary().get("by_class") or {}))
            prev = self._wd_counts or {}
            fresh = [c for c in _GATE_WD_CLASSES
                     if counts.get(c, 0) > prev.get(c, 0)]
            self._note_write()
            self._wd_counts = counts
            if fresh:
                wd_why = "watchdog " + "+".join(fresh)
                bad_why = (bad_why + "; " + wd_why) if bad_why \
                    else wd_why
        self._note_write()
        if bad_why is not None:
            self._good_streak = 0
            self._bad_streak += 1
            if self._bad_streak >= self._trip_steps \
                    and self._bp_state < BP_CLAMP:
                self._bp_set(self._bp_state + 1, bad_why)
                self._bad_streak = 0
        elif in_band:
            # hysteresis: recovered past `low` but not past `high`
            # (and no fresh watchdog events) — hold state, freeze
            # streaks so the gate neither trips nor recovers here
            pass
        else:
            self._bad_streak = 0
            self._good_streak += 1
            if self._good_streak >= self._recover_steps \
                    and self._bp_state > BP_OPEN:
                self._bp_set(self._bp_state - 1,
                             "recovered: goodput healthy for %d "
                             "gate evals" % self._good_streak)
                self._good_streak = 0

    def _bp_set(self, state, why):
        prev = self._bp_state
        self._note_write()
        self._bp_state = state
        self._bp_reason = why
        self._bp_since = self._pump_steps
        if state > prev:
            self._trips += 1
        else:
            self._recoveries += 1
        self._transitions = (
            (_BP_NAMES[state], why, self._pump_steps),
        ) + self._transitions[:7]
        if self._metrics is not None:
            self._metrics.gauge("engine.backpressure_state", state)

    # -- /enginez provider (ops-server handler thread; all reads
    # are GIL-atomic snapshots of pump-owned state) ----------------

    def _enginez_info(self):
        t = self._thread
        return {
            "pump": {
                "running": bool(t is not None and t.is_alive()),
                "steps": self._pump_steps,
                "idle_waits": self._idle_waits,
                "last_step_wall_s": round(self._last_step_wall, 6),
                "draining": self._draining,
                "stopping": self._stop,
                "error": self._pump_error,
            },
            "streams": {
                "inflight": len(self._streams),
                "submitted": self._submitted,
                "adopted": self._adopted,
                "completed": self._completed,
                "cancelled": self._cancelled,
                "shed": self._shed,
            },
            "backpressure": {
                "state": _BP_NAMES[self._bp_state],
                "reason": self._bp_reason or None,
                "since_pump_step": self._bp_since,
                "trips": self._trips,
                "recoveries": self._recoveries,
                "transitions": [
                    {"state": s, "reason": r, "pump_step": n}
                    for s, r, n in self._transitions],
            },
            "last_shed": [
                {"req_id": rid, "priority": pr, "reason": why}
                for rid, pr, why in self._last_shed],
        }
