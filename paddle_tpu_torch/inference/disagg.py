"""Disaggregated serving of the port (counterpart of the reference's
``inference/disagg.py``): a prefill/decode role split over the page-chain
wire format, fronted by a session router.

- **PrefillWorker** drives a synchronous ``BatchScheduler`` through a
  request's prompt to its FIRST committed token, then ships the finished
  page chains off the box with ``BatchScheduler.export_request``: bit
  for bit payloads (and int8 scale rows) over the versioned
  ``HostKVSwapSpace`` wire format, split along the KV-head axis into one
  payload per destination ``mp`` shard (``FLAGS_disagg_mp_shards``).
- **DecodeWorker** wraps a ``ServingEngine`` on the decode box:
  ``adopt()`` rebuilds the ``Request`` from the handoff envelope and
  marshals it to the engine pump, which registers it swapped out; the
  next step's swap-in restores the chains bit for bit and decode resumes
  where prefill stopped, so the streamed output is the one a single box
  gives. The trace identity rides the swap records
  (``space.trace_context(seq)`` is the decode-side ingress).
- **SessionRouter** is the front door: it spreads sessions over the
  replicas (``FLAGS_disagg_router_policy``: round-robin or least
  loaded), forwards submit and cancel through each replica's engine, and
  republishes the fleet-wide max of the engines' backpressure gates as
  ``router.backpressure_state``. With ``FLAGS_ops_server_port`` set it
  registers a ``/routerz`` section on the embedded ops server.

Role asymmetry is configuration, not code: ``apply_role_budgets`` maps
``FLAGS_disagg_<role>_budget_hbm/_comm`` onto the global budgets the
capacity autotuner's feasibility check reads, and
``role_scheduler_kwargs`` gives prefill-role schedulers their own chunk
budget (``FLAGS_disagg_prefill_chunk_tokens``).

This is host-side orchestration: all device work happens inside the
schedulers it drives. The prefill leg runs synchronously inside
``SessionRouter.submit`` (the prefill scheduler is a local object); a
network transport would carry the same envelope bytes instead.
"""
from __future__ import annotations

import collections

from ..framework import telemetry
from ..framework.flags import flag, set_flags
from .engine import _BP_NAMES
from .serving import Request

__all__ = [
    "PrefillWorker",
    "DecodeWorker",
    "DisaggReplica",
    "SessionRouter",
    "SessionStream",
    "apply_role_budgets",
    "role_scheduler_kwargs",
]

_ROUTER_SEQ = [0]  # concurrency: single-writer (router ctor thread)


def apply_role_budgets(role):
    """Apply the per-role budgets for this worker: maps
    ``FLAGS_disagg_<role>_budget_hbm`` / ``_comm`` (when > 0) onto the
    global ``FLAGS_jit_budget_hbm`` / ``_comm``, which the capacity
    autotuner's ``check_feasible`` holds candidates to: prefill boxes
    are activation-heavy, decode boxes KV-pool-heavy, and one global
    budget cannot be tight for both. Returns the dict of budgets
    applied (empty when both role budgets are unset)."""
    if role not in ("prefill", "decode"):
        raise ValueError(
            f"apply_role_budgets: unknown role {role!r} "
            "(expected 'prefill' or 'decode')")
    updates = {}
    hbm = int(flag("disagg_%s_budget_hbm" % role))
    comm = int(flag("disagg_%s_budget_comm" % role))
    if hbm > 0:
        updates["jit_budget_hbm"] = hbm
    if comm > 0:
        updates["jit_budget_comm"] = comm
    if updates:
        set_flags(updates)
    return updates


def role_scheduler_kwargs(role):
    """Scheduler-construction overrides for a role: prefill-role
    schedulers get ``FLAGS_disagg_prefill_chunk_tokens`` (when > 0)
    as their chunk budget — prefill workers run chunk-budget-heavy
    steps, so the single-box ``FLAGS_prefill_chunk_tokens`` is
    usually too small for them. Decode-role schedulers take no
    overrides (their steps are one token per row by construction)."""
    if role not in ("prefill", "decode"):
        raise ValueError(
            f"role_scheduler_kwargs: unknown role {role!r} "
            "(expected 'prefill' or 'decode')")
    kw = {}
    if role == "prefill":
        chunk = int(flag("disagg_prefill_chunk_tokens"))
        if chunk > 0:
            kw["prefill_chunk_tokens"] = chunk
    return kw


class PrefillWorker:
    """Prefill-role driver over a synchronous ``BatchScheduler``:
    runs one request's prompt (chunk-budget-heavy steps) to its
    first committed token, then hands the page chains off the box.

    Role discipline: this class touches only the prefill half of the
    pool API — it exports; it never calls the decode-only restore
    surface (``swap_in`` / ``import_seq`` / ``adopt_swapped``)."""

    def __init__(self, scheduler, mp_shards=None):
        self.scheduler = scheduler
        self.mp_shards = int(mp_shards) if mp_shards \
            else int(flag("disagg_mp_shards"))
        if self.mp_shards < 1:
            raise ValueError(
                f"mp_shards must be >= 1, got {self.mp_shards}")

    def run(self, req):
        """Drive ``req`` through prefill to its first committed
        token. Returns ``("handoff", envelope)`` — request metadata
        plus one wire payload per ``mp`` shard, ready for
        ``DecodeWorker.adopt`` — or ``("finished", req)`` when the
        request retired on this box (a 0/1-token budget or an
        immediate EOS leaves nothing to hand off)."""
        self.scheduler.submit(req)
        while not req.terminal and not req.generated_ids:
            self.scheduler.step()
        if req.terminal:
            return ("finished", req)
        env = self.scheduler.export_request(
            req.req_id, mp_shards=self.mp_shards)
        return ("handoff", env)


class DecodeWorker:
    """Decode-role front over a ``ServingEngine``: rebuilds the
    ``Request`` from a prefill worker's handoff envelope and adopts
    it — the engine pump registers it swapped-out and the standard
    swap-in path restores the chains bitwise on the next step."""

    def __init__(self, engine):
        self.engine = engine

    @staticmethod
    def request_from_envelope(envelope, on_token=None):
        """Reconstruct the ``Request`` a prefill worker exported:
        identity, budget, priority/tenant, the REMAINING deadline
        (re-armed at adoption), the trace wire context, and the
        already-committed tokens."""
        e = envelope["req"]
        req = Request(
            e["req_id"], list(e["prompt_ids"]),
            max_new_tokens=e["max_new_tokens"], eos_id=e["eos_id"],
            on_token=on_token, priority=e["priority"],
            tenant=e["tenant"], deadline_s=e["deadline_s"],
            trace_ctx=e["trace_ctx"])
        req.generated_ids = list(e["generated_ids"])
        return req

    async def adopt(self, envelope, on_token=None):
        """Adopt one handoff envelope; returns the engine's
        ``TokenStream`` for the decode leg."""
        req = self.request_from_envelope(envelope, on_token)
        return await self.engine.adopt(req, envelope["payloads"])


class DisaggReplica:
    """One DP replica of the disaggregated pair: a prefill worker
    and a decode worker that share model weights (the greedy-
    identity contract) but own separate schedulers and pools.
    Accepts raw ``BatchScheduler`` / ``ServingEngine`` objects and
    wraps them in their role fronts."""

    def __init__(self, name, prefill, decode):
        self.name = str(name)
        if not isinstance(prefill, PrefillWorker):
            prefill = PrefillWorker(prefill)
        if not isinstance(decode, DecodeWorker):
            decode = DecodeWorker(decode)
        self.prefill = prefill
        self.decode = decode

    @property
    def engine(self):
        return self.decode.engine


class SessionStream:
    """Async iterator over one routed session's generated tokens:
    first the tokens the prefill worker committed before the handoff
    (carried in the envelope — typically one), then the decode
    worker's live ``TokenStream``. The union is the request's full
    generated sequence, greedy-identical to a single-box run."""

    def __init__(self, head, stream, req):
        self._head = collections.deque(head)
        self._stream = stream  # None: request retired on prefill box
        self.req = req

    @property
    def req_id(self):
        return self.req.req_id

    @property
    def state(self):
        return self.req.state

    def __aiter__(self):
        return self

    async def __anext__(self):
        if self._head:
            return self._head.popleft()
        if self._stream is None:
            raise StopAsyncIteration
        return await self._stream.__anext__()

    async def tokens(self):
        """Drain to completion; returns every generated token id
        (prefill-committed head + decode stream)."""
        out = []
        async for tok in self:
            out.append(tok)
        return out

    async def cancel(self):
        """Abort the decode leg (deadline-abort semantics); False
        when the request already retired on the prefill box."""
        if self._stream is None:
            return False
        return await self._stream.cancel()


class SessionRouter:
    """Front-end for a fleet of ``DisaggReplica``s: spreads sessions
    over the DP replicas, forwards submit/cancel through each
    replica's engine, and republishes fleet backpressure.

    Policies (``FLAGS_disagg_router_policy``): ``"rr"`` round-robins
    new sessions; ``"least"`` picks the replica with the fewest live
    sessions. Telemetry: ``router.sessions`` / ``router.replicas``
    (population gauges, sum-merged across a fleet),
    ``router.backpressure_state`` (max over the replica engines'
    gates, max-merged), ``router.submitted`` / ``router.cancelled``
    (counters). With ``FLAGS_ops_server_port`` set the constructor
    registers a ``/routerz`` section on the embedded ops server."""

    def __init__(self, replicas, policy=None):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("SessionRouter needs >= 1 replica")
        self.policy = str(policy if policy is not None
                          else flag("disagg_router_policy"))
        if self.policy not in ("rr", "least"):
            raise ValueError(
                f"unknown router policy {self.policy!r} "
                "(FLAGS_disagg_router_policy: 'rr' or 'least')")
        _ROUTER_SEQ[0] += 1
        self._uid = "r%d" % _ROUTER_SEQ[0]
        self._rr = 0
        self._live = {}  # req_id -> (replica, SessionStream)
        self._submitted = 0
        self._cancelled = 0
        self._metrics = telemetry.registry() \
            if telemetry.metrics_on() else None
        self._publish()
        if int(flag("ops_server_port")) > 0:
            from ..framework import ops_server as _ops_server
            srv = _ops_server.maybe_start()
            if srv is not None:
                srv.add_router_provider(
                    "router." + self._uid, self._routerz_info)

    # -- routing ---------------------------------------------------

    def _reap(self):
        done = [rid for rid, (_, sess) in self._live.items()
                if sess.req.terminal]
        for rid in done:
            del self._live[rid]

    def _pick(self):
        if self.policy == "least":
            counts = dict.fromkeys(range(len(self.replicas)), 0)
            index = {id(rep): i
                     for i, rep in enumerate(self.replicas)}
            for rep, _ in self._live.values():
                counts[index[id(rep)]] += 1
            return min(self.replicas,
                       key=lambda rep: counts[index[id(rep)]])
        rep = self.replicas[self._rr % len(self.replicas)]
        self._rr += 1
        return rep

    async def submit(self, req):
        """Route one session: pick a replica, run its prefill leg,
        hand the chain to the same replica's decode engine, and
        return the stitched ``SessionStream``. Engine rejections
        (``EngineOverloadError`` / ``EngineClosedError``) and
        scheduler validation errors propagate unchanged — the caller
        owns retry-on-another-replica policy."""
        rep = self._pick()
        self._submitted += 1
        if self._metrics is not None:
            self._metrics.inc("router.submitted")
        kind, val = rep.prefill.run(req)
        if kind == "finished":
            self._publish()
            return SessionStream(list(val.generated_ids), None, val)
        envelope = val
        stream = await rep.decode.adopt(
            envelope, on_token=req.on_token)
        sess = SessionStream(
            list(envelope["req"]["generated_ids"]), stream,
            stream.req)
        self._live[stream.req_id] = (rep, sess)
        self._publish()
        return sess

    async def cancel(self, req_id):
        """Forward a cancel to the replica decoding ``req_id``;
        True if that engine's scheduler still knew the request."""
        entry = self._live.get(req_id)
        if entry is None:
            return False
        rep, _ = entry
        ok = await rep.engine.cancel(req_id)
        if ok:
            self._cancelled += 1
            if self._metrics is not None:
                self._metrics.inc("router.cancelled")
        self._live.pop(req_id, None)
        self._publish()
        return ok

    @property
    def num_sessions(self):
        self._reap()
        return len(self._live)

    # -- telemetry / ops -------------------------------------------

    def _publish(self):
        self._reap()
        if self._metrics is None:
            return
        self._metrics.gauge("router.sessions", len(self._live))
        self._metrics.gauge("router.replicas", len(self.replicas))
        self._metrics.gauge(
            "router.backpressure_state",
            max(rep.engine.backpressure_state
                for rep in self.replicas))

    def _routerz_info(self):
        self._reap()
        per = []
        for rep in self.replicas:
            per.append({
                "name": rep.name,
                "sessions": sum(
                    1 for r, _ in self._live.values() if r is rep),
                "backpressure":
                    _BP_NAMES[rep.engine.backpressure_state],
            })
        return {
            "policy": self.policy,
            "replicas": per,
            "sessions": len(self._live),
            "submitted": self._submitted,
            "cancelled": self._cancelled,
        }
