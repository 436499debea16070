"""Host-plane concurrency sanitizer of the port: TSan for the serving
stack (counterpart of the reference's ``framework/concurrency.py``,
which imports no JAX; the port keeps its own copy).

The scheduler, page pool, metrics registry and tracer are single-writer
by contract today, and an asynchronous serving engine with a background
step pump would make them concurrent. Nothing else enforces which
attribute is guarded by which lock. This
module is the dynamic half of that enforcement — a lockset race
detector with a lightweight vector-clock happens-before layer over
Python threads AND asyncio tasks:

* :func:`guarded` hands out named lock wrappers
  (:class:`GuardedLock`) whose acquire/release feed the detector:
  per-actor locksets, a global acquisition-order graph (a cycle is a
  potential deadlock), and release->acquire happens-before edges;
* :func:`ConcurrencySanitizer.shared` registers a shared attribute
  with its ``GuardedBy`` declaration (a lock name) or a
  ``single_writer`` waiver; instrumented sites call
  :meth:`SharedVar.read` / :meth:`SharedVar.write` and the detector
  validates every access;
* the **happens-before model**: each actor (thread or asyncio task)
  carries a vector clock. Lock releases publish into the lock's
  clock, acquires join from it; a cooperative task switch is an HB
  edge (every event from a task syncs through its event loop's
  clock — the loop is single-threaded, so consecutive task steps ARE
  ordered), but an executor hop is NOT (an executor worker is a
  plain thread that never syncs through the loop clock);
* the **violation classes** are in :data:`VIOLATIONS` —

  ==========================  =============================================
  rule id                     hazard
  ==========================  =============================================
  unguarded-shared-write      a write to a GuardedBy-declared attribute
                              without its guard held, or a second writer
                              thread on a single-writer attribute
  lockset-race                a read-write (or write-write) pair on the
                              same shared attribute, unordered by
                              happens-before, with disjoint locksets
  lock-order-inversion        two locks acquired in opposite orders by
                              different code paths (a cycle in the
                              acquisition-order graph: potential deadlock)
  blocking-acquire-on-loop    a blocking ``acquire()`` issued from inside
                              a running asyncio task (stalls every other
                              task on the loop)
  unsanctioned-thread         a write to registered shared state from a
                              thread that was not created through
                              :func:`spawn_thread` (or adopted)
  ==========================  =============================================

* events land in a **bounded journal** matching the page-sanitizer
  contract: a state snapshot plus up to
  ``FLAGS_concurrency_journal`` events (re-snapshot on overflow), a
  raised :class:`ConcurrencyError` carries the journal tail, and
  ``san.dump(path)`` writes JSONL that

      python -m paddle_tpu_torch.framework.concurrency --replay j.jsonl

  reconstructs event by event up to the first violation;
* a **deterministic seeded fuzzer** (:func:`fuzz_interleavings`,
  also behind ``--fuzz``) drives a cooperative scheduler over
  virtual actors through scrape-vs-step, submit-vs-retire and
  swap-vs-scrape workloads; ``--inject <class>`` swaps in a
  deliberately buggy actor per :data:`INJECTIONS` class and the
  sanitizer must CATCH it — the proof the checker has teeth.

Modes (``FLAGS_concurrency_sanitizer``): ``off`` (default) —
zero-cost, :func:`sanitizer` returns None, :func:`guarded` returns a
plain ``threading.Lock`` and every instrumented site pays a single
``is None`` check; ``warn`` — violations are reported as
``RuntimeWarning`` and execution continues; ``strict`` — violations
raise :class:`ConcurrencyError`.

Threads that write registered shared state are created through
:func:`spawn_thread` (or adopted), and module-level shared state
declares its guard (``GuardedBy``); this module checks both at run
time. It imports neither torch nor any device code.
"""
from __future__ import annotations

import collections
import json
import threading
import warnings
from typing import Dict, List, Optional, Sequence

from .flags import flag

__all__ = [
    "VIOLATIONS", "INJECTIONS", "ConcurrencySanitizer",
    "ConcurrencyError", "GuardedLock", "SharedVar", "sanitizer",
    "reset", "guarded", "spawn_thread", "replay_journal",
    "fuzz_interleavings",
]

MODES = ("off", "warn", "strict")

# rule id -> one-line hazard summary (the sanitizer half of the
# "concurrency" static-check inventory group; framework/analysis.py
# --rules merges this with the lock-discipline AST rules)
VIOLATIONS: Dict[str, str] = {
    "unguarded-shared-write":
        "a write to a GuardedBy-declared shared attribute without "
        "its guard held, or a second writer thread on a "
        "single-writer attribute",
    "lockset-race":
        "a read-write or write-write pair on the same shared "
        "attribute, unordered by happens-before, with disjoint "
        "locksets (a torn or stale read the GIL does not prevent)",
    "lock-order-inversion":
        "two locks acquired in opposite orders on different code "
        "paths — a cycle in the acquisition-order graph, i.e. a "
        "potential deadlock",
    "blocking-acquire-on-loop":
        "a blocking lock acquire issued from inside a running "
        "asyncio task (stalls every other task on the event loop)",
    "unsanctioned-thread":
        "a write to registered shared state from a thread that was "
        "not created through the sanctioned spawn_thread helper "
        "(nor adopted)",
}

# injectable bug classes fuzz_interleavings(inject=...) understands;
# each maps to the violation class strict mode must raise for it
INJECTIONS = tuple(VIOLATIONS)

_TAIL_N = 20   # events carried on a raised ConcurrencyError
_MAX_WARNINGS = 20  # warn mode: report this many, count the rest

# per-attr access history bound: the last write plus up to this many
# reads-since-last-write are kept per shared attribute
_MAX_READS = 8

# virtual-actor override: the fuzzer's cooperative scheduler (and the
# replayer) runs many actors on one real thread; setting .actor makes
# every sanitizer entry attribute its events to the virtual actor
_virtual = threading.local()


def _format_events(events: Sequence[dict]) -> str:
    lines = []
    for ev in events:
        parts = ["#%s %s" % (ev.get("i", "?"), ev.get("op", "?"))]
        for k, v in ev.items():
            if k in ("i", "op", "violations"):
                continue
            s = repr(v)
            if len(s) > 64:
                s = s[:61] + "..."
            parts.append("%s=%s" % (k, s))
        for vio in ev.get("violations", ()):
            parts.append("!! %s: %s" % (vio["rule"], vio["msg"]))
        lines.append("  " + " ".join(parts))
    return "\n".join(lines) if lines else "  (empty)"


class ConcurrencyError(RuntimeError):
    """A concurrency-discipline violation, with the journal tail
    attached. ``rule`` is the :data:`VIOLATIONS` class; ``events``
    the last journal events up to and including the violating one."""

    def __init__(self, rule: str, message: str, events: Sequence[dict]):
        self.rule = rule
        self.events = [dict(ev) for ev in events]
        super().__init__(
            "concurrency sanitizer [%s]: %s\n"
            "--- journal tail (%d events; dump the full journal with "
            "sanitizer.dump(path) and replay with python -m "
            "paddle_tpu_torch.framework.concurrency --replay) ---\n%s"
            % (rule, message, len(self.events),
               _format_events(self.events)))


class SharedVar:
    """Handle for one registered shared attribute. Instrumented
    owners hold it (or None when the sanitizer is off) and call
    :meth:`read` / :meth:`write` at access sites — one attribute
    check plus one method call per site, nothing else."""

    __slots__ = ("name", "_san")

    def __init__(self, name: str, san: "ConcurrencySanitizer"):
        self.name = name
        self._san = san

    def read(self) -> None:
        self._san._access(self.name, "read")

    def write(self) -> None:
        self._san._access(self.name, "write")


class GuardedLock:
    """A named lock whose acquire/release feed the sanitizer (lock
    order, locksets, happens-before edges). Supports the
    ``threading.Lock`` protocol, so it drops in for one."""

    __slots__ = ("name", "_san", "_lock")

    def __init__(self, name: str, san: "ConcurrencySanitizer",
                 reentrant: bool = False):
        self.name = name
        self._san = san
        self._lock = threading.RLock() if reentrant \
            else threading.Lock()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        self._san._acquire(self.name, blocking)
        got = self._lock.acquire(blocking, timeout)
        if not got:
            self._san._acquire_failed(self.name)
        return got

    def release(self) -> None:
        self._san._release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class ConcurrencySanitizer:
    """Lockset + vector-clock happens-before detector with a bounded
    replayable event journal (the page-sanitizer contract).

    One per process when ``FLAGS_concurrency_sanitizer`` is
    ``warn``/``strict`` (:func:`sanitizer`); the fuzzer and tests
    construct their own. All internal state is guarded by one plain
    mutex — sanitizer entry points are safe from any thread."""

    def __init__(self, mode: str = "strict",
                 journal_max: Optional[int] = None):
        if mode not in ("warn", "strict"):
            raise ValueError(
                "concurrency sanitizer mode must be 'warn' or "
                "'strict' (got %r; 'off' means: do not construct "
                "one)" % (mode,))
        self.mode = mode
        self.journal_max = max(8, int(
            journal_max if journal_max is not None
            else flag("concurrency_journal")))
        self._mu = threading.Lock()
        # shadow state -------------------------------------------------
        # actor id -> {"vc": {actor: int}, "held": [lock names],
        #              "kind": "thread"|"task", "sanctioned": bool,
        #              "loop": loop id or None}
        self._actors: Dict[str, dict] = {}
        # lock name -> published vector clock (set at release)
        self._lock_vcs: Dict[str, dict] = {}
        # event-loop id -> vector clock (the cooperative HB carrier)
        self._loop_vcs: Dict[str, dict] = {}
        # acquisition-order graph: lock -> set of locks acquired
        # while it was held
        self._order: Dict[str, set] = {}
        # attr name -> {"guard": lock name or None,
        #               "single_writer": bool, "writer": actor,
        #               "last_write": access or None,
        #               "reads": [access, ...]}
        # where access = {"actor": id, "ep": int, "locks": [names]}
        self._attrs: Dict[str, dict] = {}
        # the constructing thread is the sanctioned main actor
        # (before the snapshot, so replays know it too)
        self._ensure_actor(self._cur()[0], sanctioned=True)
        # journal ------------------------------------------------------
        self._next_i = 0
        self._events: List[dict] = []
        self._snapshot = self._snapshot_state()
        self._prev_tail: List[dict] = []
        # accounting ---------------------------------------------------
        self.counts = collections.Counter()
        self.violations = 0
        self.violations_by_rule = collections.Counter()
        self._warned = 0

    # -- actor identity ----------------------------------------------------
    @staticmethod
    def _cur():
        """(actor id, kind, loop id) for the calling context: a
        virtual fuzz/replay actor if one is pinned, else the running
        asyncio task, else the OS thread."""
        v = getattr(_virtual, "actor", None)
        if v is not None:
            return v  # (actor, kind, loop)
        try:
            import asyncio

            task = asyncio.current_task()
        except RuntimeError:
            task = None
        if task is not None:
            loop = task.get_loop()
            return ("task:%x" % id(task), "task", "loop:%x" % id(loop))
        return ("thread:%d" % threading.get_ident(), "thread", None)

    def _ensure_actor(self, actor: str, kind: str = "thread",
                      loop: Optional[str] = None,
                      sanctioned: bool = False) -> dict:
        st = self._actors.get(actor)
        if st is None:
            st = {"vc": {actor: 1}, "held": [], "kind": kind,
                  "loop": loop, "sanctioned": bool(sanctioned)}
            self._actors[actor] = st
        return st

    # -- vector clocks -----------------------------------------------------
    @staticmethod
    def _vc_join(dst: dict, src: Optional[dict]) -> None:
        if src:
            for a, t in src.items():
                if dst.get(a, 0) < t:
                    dst[a] = t

    def _tick(self, st: dict, actor: str) -> int:
        st["vc"][actor] = st["vc"].get(actor, 0) + 1
        return st["vc"][actor]

    def _sync_task(self, st: dict, actor: str) -> None:
        """Cooperative HB: every event from a task joins the loop
        clock and publishes back — consecutive task steps on one
        loop are ordered. Plain threads (executor workers included)
        never touch a loop clock: an executor hop is NOT an edge."""
        loop = st.get("loop")
        if st.get("kind") == "task" and loop is not None:
            lvc = self._loop_vcs.setdefault(loop, {})
            self._vc_join(st["vc"], lvc)
            self._vc_join(lvc, st["vc"])

    # -- journal -----------------------------------------------------------
    def _snapshot_state(self) -> dict:
        return {
            "i": self._next_i if hasattr(self, "_next_i") else 0,
            "actors": [[a, {"vc": dict(st["vc"]),
                            "held": list(st["held"]),
                            "kind": st["kind"], "loop": st["loop"],
                            "sanctioned": st["sanctioned"]}]
                       for a, st in self._actors.items()],
            "lock_vcs": [[n, dict(vc)]
                         for n, vc in self._lock_vcs.items()],
            "loop_vcs": [[n, dict(vc)]
                         for n, vc in self._loop_vcs.items()],
            "order": [[n, sorted(s)] for n, s in self._order.items()],
            "attrs": [[n, {"guard": a["guard"],
                           "single_writer": a["single_writer"],
                           "writer": a["writer"],
                           "last_write": a["last_write"],
                           "reads": list(a["reads"])}]
                      for n, a in self._attrs.items()],
        }

    def _restore_state(self, snap: dict) -> None:
        self._next_i = int(snap.get("i", 0))
        self._actors = {
            a: {"vc": {k: int(v) for k, v in st["vc"].items()},
                "held": list(st["held"]), "kind": st["kind"],
                "loop": st["loop"],
                "sanctioned": bool(st["sanctioned"])}
            for a, st in snap.get("actors", ())}
        self._lock_vcs = {n: dict(vc)
                          for n, vc in snap.get("lock_vcs", ())}
        self._loop_vcs = {n: dict(vc)
                          for n, vc in snap.get("loop_vcs", ())}
        self._order = {n: set(s) for n, s in snap.get("order", ())}
        self._attrs = {
            n: {"guard": a["guard"],
                "single_writer": bool(a["single_writer"]),
                "writer": a["writer"],
                "last_write": a["last_write"],
                "reads": list(a["reads"])}
            for n, a in snap.get("attrs", ())}

    def _maybe_rollover(self) -> None:
        if len(self._events) >= self.journal_max:
            self._prev_tail = self._events[-_TAIL_N:]
            self._snapshot = self._snapshot_state()
            self._events = []

    def tail(self, n: int = _TAIL_N) -> List[dict]:
        evs = self._events[-n:]
        if len(evs) < n:
            evs = self._prev_tail[-(n - len(evs)):] + evs
        return evs

    def format_tail(self, n: int = _TAIL_N) -> str:
        return ("--- concurrency sanitizer journal tail ---\n"
                + _format_events(self.tail(n)))

    def dump(self, path: str) -> str:
        """Write header + snapshot + events as JSONL; the file
        replays standalone (``--replay``). Returns ``path``."""
        with self._mu:
            header = {"type": "header", "kind": "concurrency",
                      "mode": self.mode,
                      "events": len(self._events),
                      "violations": self.violations}
            snap = {"type": "snapshot", **self._snapshot}
            events = [dict(ev) for ev in self._events]
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(header) + "\n")
            f.write(json.dumps(snap) + "\n")
            for ev in events:
                f.write(json.dumps({"type": "event", **ev}) + "\n")
        return path

    def stats(self) -> dict:
        with self._mu:
            return {"mode": self.mode,
                    "events": int(sum(self.counts.values())),
                    "violations": int(self.violations),
                    "by_rule": dict(self.violations_by_rule),
                    "by_op": dict(self.counts),
                    "attrs": len(self._attrs),
                    "actors": len(self._actors)}

    def has_events(self) -> bool:
        return bool(self._events or self._prev_tail)

    # -- violation plumbing ------------------------------------------------
    def _violate(self, rule: str, msg: str,
                 ev: Optional[dict] = None):
        # caller holds self._mu
        assert rule in VIOLATIONS, rule
        self.violations += 1
        self.violations_by_rule[rule] += 1
        if ev is not None:
            rec = {"rule": rule, "msg": msg}
            vs = ev.setdefault("violations", [])
            if rec not in vs:  # replays re-find recorded violations
                vs.append(rec)
        if self.mode == "strict":
            raise ConcurrencyError(rule, msg, self.tail())
        self._warned += 1
        if self._warned <= _MAX_WARNINGS:
            warnings.warn("concurrency sanitizer [%s]: %s"
                          % (rule, msg), RuntimeWarning, stacklevel=5)

    # -- public registration ----------------------------------------------
    def shared(self, name: str, owner=None,
               guard: Optional[str] = None,
               single_writer: bool = False) -> SharedVar:
        """Register one shared attribute under ``name``. ``guard``
        declares the GuardedBy lock (by :func:`guarded` name):
        writes without it held are unguarded-shared-write.
        ``single_writer`` waives the guard for attributes mutated by
        exactly one actor (the scheduler's own state): the first
        writer claims it, a second distinct writer violates. Reads
        are always lockset/HB-checked against the last write unless
        the attribute is single-writer (readers of single-writer
        state take GIL-atomic snapshots by contract). ``owner`` is
        accepted for API symmetry; the registry is keyed by name, so
        two owners sharing one name share one discipline record."""
        with self._mu:
            ev = self._event_locked(
                "reg", attr=name, guard=guard,
                single_writer=bool(single_writer))
            self._apply(ev)
        return SharedVar(name, self)

    def guarded(self, name: str,
                reentrant: bool = False) -> GuardedLock:
        return GuardedLock(name, self, reentrant=reentrant)

    def adopt(self, label: str = "adopted") -> None:
        """Sanction the CURRENT thread (idempotent): stdlib-spawned
        threads the helper cannot wrap — e.g. ThreadingHTTPServer
        request handlers — declare themselves here."""
        actor, kind, loop = self._cur()
        self.sanction(actor, kind, loop, label)

    def sanction(self, actor: str, kind: str = "thread",
                 loop: Optional[str] = None,
                 label: str = "adopted") -> None:
        """Journaled sanctioning of a named actor (replays must see
        it too, so this is an event rather than a state poke)."""
        with self._mu:
            st = self._actors.get(actor)
            if st is not None and st["sanctioned"]:
                return
            ev = self._event_locked("adopt", actor=actor, kind=kind,
                                    loop=loop, label=label)
            self._apply(ev)

    def fork(self) -> dict:
        """Parent half of the thread-creation HB edge: snapshot the
        parent's clock for :meth:`begin_thread` to join."""
        actor, kind, loop = self._cur()
        with self._mu:
            st = self._ensure_actor(actor, kind, loop)
            self._tick(st, actor)
            return dict(st["vc"])

    def begin_thread(self, name: str,
                     parent_vc: Optional[dict] = None) -> None:
        """Child half: sanction the current thread and join the
        parent clock (everything before the spawn happens-before
        everything in the child)."""
        actor, kind, loop = self._cur()
        with self._mu:
            ev = self._event_locked("spawn", actor=actor, name=name,
                                    parent_vc=parent_vc or {})
            self._apply(ev)

    # -- event plumbing ----------------------------------------------------
    def _event_locked(self, op: str, **fields) -> dict:
        ev = {"i": self._next_i, "op": op}
        ev.update(fields)
        self._next_i += 1
        self.counts[op] += 1
        self._maybe_rollover()
        self._events.append(ev)
        return ev

    # entry points from GuardedLock / SharedVar ----------------------------
    def _acquire(self, lock: str, blocking: bool) -> None:
        actor, kind, loop = self._cur()
        with self._mu:
            ev = self._event_locked("acquire", actor=actor, kind=kind,
                                    loop=loop, lock=lock,
                                    blocking=bool(blocking))
            self._apply(ev)

    def _acquire_failed(self, lock: str) -> None:
        actor, _, _ = self._cur()
        with self._mu:
            ev = self._event_locked("acquire-failed", actor=actor,
                                    lock=lock)
            self._apply(ev)

    def _release(self, lock: str) -> None:
        actor, kind, loop = self._cur()
        with self._mu:
            ev = self._event_locked("release", actor=actor, kind=kind,
                                    loop=loop, lock=lock)
            self._apply(ev)

    def _access(self, attr: str, rw: str) -> None:
        actor, kind, loop = self._cur()
        with self._mu:
            st = self._actors.get(actor)
            held = list(st["held"]) if st is not None else []
            ev = self._event_locked(rw, actor=actor, kind=kind,
                                    loop=loop, attr=attr, held=held)
            self._apply(ev)

    # -- shadow semantics (shared by live runs and replay) -----------------
    def _apply(self, ev: dict) -> None:
        fn = getattr(self, "_ev_" + ev["op"].replace("-", "_"), None)
        if fn is not None:
            fn(ev)

    def _ev_reg(self, ev: dict) -> None:
        name = ev["attr"]
        rec = self._attrs.get(name)
        if rec is None:
            self._attrs[name] = {
                "guard": ev.get("guard"),
                "single_writer": bool(ev.get("single_writer")),
                "writer": None, "last_write": None, "reads": []}
        else:
            # re-registration (a second registry instance): keep the
            # strictest declaration
            if ev.get("guard"):
                rec["guard"] = ev["guard"]
            if not ev.get("single_writer"):
                rec["single_writer"] = False

    def _ev_adopt(self, ev: dict) -> None:
        st = self._ensure_actor(ev["actor"], ev.get("kind", "thread"),
                                ev.get("loop"))
        st["sanctioned"] = True

    def _ev_spawn(self, ev: dict) -> None:
        st = self._ensure_actor(ev["actor"], sanctioned=True)
        st["sanctioned"] = True
        self._vc_join(st["vc"], ev.get("parent_vc"))
        self._tick(st, ev["actor"])

    def _ev_acquire(self, ev: dict) -> None:
        actor, lock = ev["actor"], ev["lock"]
        st = self._ensure_actor(actor, ev.get("kind", "thread"),
                                ev.get("loop"))
        self._sync_task(st, actor)
        self._tick(st, actor)
        # blocking acquire on a running event loop: the whole loop
        # stalls behind one lock holder
        if ev.get("blocking", True) and st.get("kind") == "task":
            self._violate(
                "blocking-acquire-on-loop",
                "actor %s issued a blocking acquire of %r from "
                "inside a running asyncio task (use a non-blocking "
                "acquire or hop to an executor)" % (actor, lock), ev)
        # lock-order: an edge held -> lock that closes a cycle is an
        # inversion (some other path acquires them the other way)
        for h in st["held"]:
            if h == lock:
                continue
            edges = self._order.setdefault(h, set())
            if lock not in edges:
                if self._reaches(lock, h):
                    self._violate(
                        "lock-order-inversion",
                        "actor %s acquired %r while holding %r, but "
                        "another path acquires %r before %r — the "
                        "acquisition-order graph has a cycle "
                        "(potential deadlock)"
                        % (actor, lock, h, lock, h), ev)
                edges.add(lock)
        # HB: join the lock's published clock
        self._vc_join(st["vc"], self._lock_vcs.get(lock))
        st["held"].append(lock)

    def _reaches(self, src: str, dst: str) -> bool:
        seen = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._order.get(n, ()))
        return False

    def _ev_acquire_failed(self, ev: dict) -> None:
        # a failed non-blocking acquire: undo the held push
        st = self._actors.get(ev["actor"])
        if st is not None and ev["lock"] in st["held"]:
            st["held"].remove(ev["lock"])

    def _ev_release(self, ev: dict) -> None:
        actor, lock = ev["actor"], ev["lock"]
        st = self._ensure_actor(actor, ev.get("kind", "thread"),
                                ev.get("loop"))
        if lock in st["held"]:
            st["held"].remove(lock)
        # HB: publish into the lock clock for the next acquirer
        self._tick(st, actor)
        vc = self._lock_vcs.setdefault(lock, {})
        self._vc_join(vc, st["vc"])
        self._sync_task(st, actor)

    def _hb(self, access: dict, st: dict) -> bool:
        """Did the recorded access happen-before the current actor's
        state? (its epoch is covered by our clock)"""
        return access["ep"] <= st["vc"].get(access["actor"], 0)

    def _ev_read(self, ev: dict) -> None:
        self._ev_rw(ev, "read")

    def _ev_write(self, ev: dict) -> None:
        self._ev_rw(ev, "write")

    def _ev_rw(self, ev: dict, rw: str) -> None:
        actor, attr = ev["actor"], ev["attr"]
        st = self._ensure_actor(actor, ev.get("kind", "thread"),
                                ev.get("loop"))
        # tick BEFORE the loop sync so the access epoch itself is
        # published into the loop clock — the next task step joins
        # it and the pair is ordered
        ep = self._tick(st, actor)
        self._sync_task(st, actor)
        rec = self._attrs.get(attr)
        if rec is None:  # access to an unregistered name: journal only
            return
        held = list(ev.get("held", ()))
        access = {"actor": actor, "ep": ep, "locks": held}
        if rw == "write":
            if rec["single_writer"]:
                if rec["writer"] is None:
                    rec["writer"] = actor
                elif rec["writer"] != actor:
                    self._violate(
                        "unguarded-shared-write",
                        "attribute %r is declared single-writer "
                        "(claimed by %s) but %s wrote it — the "
                        "waiver no longer holds, guard it with a "
                        "lock" % (attr, rec["writer"], actor), ev)
            elif rec["guard"] is not None \
                    and rec["guard"] not in held:
                self._violate(
                    "unguarded-shared-write",
                    "write to %r without its declared guard %r held "
                    "(actor %s holds %s)"
                    % (attr, rec["guard"], actor, held or "no locks"),
                    ev)
            if not st["sanctioned"] and st.get("kind") != "task":
                self._violate(
                    "unsanctioned-thread",
                    "thread %s wrote shared attribute %r but was not "
                    "created through concurrency.spawn_thread (nor "
                    "adopted) — undisciplined writer threads are "
                    "invisible to shutdown and the sanitizer"
                    % (actor, attr), ev)
            if not rec["single_writer"]:
                # race check vs reads since the last write
                for rd in rec["reads"]:
                    self._check_pair(rec, rd, access, "read", "write",
                                     attr, ev, st)
                lw = rec["last_write"]
                if lw is not None:
                    self._check_pair(rec, lw, access, "write",
                                     "write", attr, ev, st)
            rec["last_write"] = access
            rec["reads"] = []
        else:
            if not rec["single_writer"]:
                lw = rec["last_write"]
                if lw is not None:
                    self._check_pair(rec, lw, access, "write", "read",
                                     attr, ev, st)
                rec["reads"].append(access)
                if len(rec["reads"]) > _MAX_READS:
                    rec["reads"] = rec["reads"][-_MAX_READS:]

    def _check_pair(self, rec: dict, prev: dict, cur: dict,
                    prev_kind: str, cur_kind: str, attr: str,
                    ev: dict, st: dict) -> None:
        if prev["actor"] == cur["actor"]:
            return
        if self._hb(prev, st):
            return
        if set(prev["locks"]) & set(cur["locks"]):
            return
        self._violate(
            "lockset-race",
            "%s of %r by %s (holding %s) races a %s by %s (holding "
            "%s): no common lock and no happens-before edge orders "
            "them" % (cur_kind, attr, cur["actor"],
                      cur["locks"] or "no locks", prev_kind,
                      prev["actor"], prev["locks"] or "no locks"),
            ev)


# ---------------------------------------------------------------------------
# process singleton + zero-cost-off entry points
# ---------------------------------------------------------------------------

_STATE_LOCK = threading.Lock()
_SANITIZER: Optional[ConcurrencySanitizer] = None  # guarded-by: concurrency.state
_MODE_READ = False  # guarded-by: concurrency.state


def sanitizer() -> Optional[ConcurrencySanitizer]:
    """The process-wide sanitizer, or None when
    ``FLAGS_concurrency_sanitizer=off`` (the zero-cost contract:
    instrumented modules cache this handle at construction and pay
    one ``is None`` check per site)."""
    global _SANITIZER, _MODE_READ
    if _MODE_READ:
        return _SANITIZER
    with _STATE_LOCK:
        if not _MODE_READ:
            mode = str(flag("concurrency_sanitizer")).lower()
            if mode not in MODES:
                raise ValueError(
                    "FLAGS_concurrency_sanitizer must be one of %s, "
                    "got %r" % (MODES, mode))
            if mode != "off":
                _SANITIZER = ConcurrencySanitizer(mode=mode)
            _MODE_READ = True
    return _SANITIZER


def reset() -> None:
    """Drop the process singleton so the next :func:`sanitizer` call
    re-reads the flag (test/bench arm isolation)."""
    global _SANITIZER, _MODE_READ
    with _STATE_LOCK:
        _SANITIZER = None
        _MODE_READ = False


def guarded(name: str, reentrant: bool = False):
    """A named sanitized lock when the sanitizer is live, a plain
    ``threading.Lock`` (or RLock) when off — so instrumented modules
    replace ``threading.Lock()`` with ``guarded("module.purpose")``
    unconditionally and off mode allocates no shadow objects."""
    san = sanitizer()
    if san is None:
        return threading.RLock() if reentrant else threading.Lock()
    return san.guarded(name, reentrant=reentrant)


def spawn_thread(name: str, target, args=(), kwargs=None,
                 daemon: bool = True) -> threading.Thread:
    """THE sanctioned thread constructor of the host plane (enforced
    by the thread-discipline lint rule): every thread is named, a
    daemon by default, and — when the sanitizer is live — registered
    as sanctioned with a parent->child happens-before edge."""
    kwargs = kwargs or {}
    san = sanitizer()
    if san is None:
        t = threading.Thread(target=target, name=name, args=args,
                             kwargs=kwargs, daemon=daemon)
        t.start()
        return t
    parent_vc = san.fork()

    def _run():
        san.begin_thread(name, parent_vc)
        target(*args, **kwargs)

    t = threading.Thread(target=_run, name=name, daemon=daemon)
    t.start()
    return t


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


class ReplayResult:
    """Outcome of replaying a journal: the reconstructed detector
    state, the first violation (or None), and how far it got."""

    def __init__(self, sanitizer, error, applied, total):
        self.sanitizer = sanitizer
        self.error = error
        self.applied = applied
        self.total = total

    @property
    def clean(self) -> bool:
        return self.error is None

    def summary(self) -> str:
        san = self.sanitizer
        head = ("replayed %d/%d events (%d actors, %d locks, %d "
                "shared attrs)"
                % (self.applied, self.total, len(san._actors),
                   len(san._lock_vcs) + len(san._order),
                   len(san._attrs)))
        if self.error is None:
            return "%s\njournal replays clean" % head
        return ("%s\nfirst violation [%s] at event #%d:\n%s"
                % (head, self.error.rule, self.applied - 1,
                   str(self.error)))


def replay_journal(path: str) -> ReplayResult:
    """Reconstruct the detector from a dumped journal, stopping at
    the first violation (strict semantics regardless of the recorded
    mode)."""
    header = snapshot = None
    events = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.pop("type", "event")
            if kind == "header":
                header = rec
            elif kind == "snapshot":
                snapshot = rec
            else:
                events.append(rec)
    if header is None:
        raise ValueError("%s: no journal header line" % path)
    san = ConcurrencySanitizer(
        mode="strict", journal_max=max(8, len(events) + 8))
    if snapshot is not None:
        san._restore_state(snapshot)
    applied = 0
    for ev in events:
        applied += 1
        san.counts[ev.get("op", "?")] += 1
        san._events.append(ev)
        try:
            san._apply(ev)
        except ConcurrencyError as e:
            return ReplayResult(san, e, applied, len(events))
    return ReplayResult(san, None, applied, len(events))


# ---------------------------------------------------------------------------
# deterministic seeded interleaving fuzzer (+ injected bug classes)
# ---------------------------------------------------------------------------


class _Actor:
    """One virtual actor: a generator that yields between shared-
    memory operations, so the cooperative scheduler controls every
    interleaving point. ``identity`` is the (actor, kind, loop)
    triple pinned into the sanitizer's thread-local while this
    actor's step runs."""

    def __init__(self, name: str, kind: str, loop: Optional[str],
                 gen):
        self.identity = (name, kind, loop)
        self.gen = gen


def _fuzz_world(san: ConcurrencySanitizer, inject: Optional[str],
                rng) -> List[_Actor]:
    """The three serving-shaped workloads over one shared world:

    * scrape-vs-step — a stepper mutating registry metrics under the
      registry lock vs scraper actors snapshotting them;
    * submit-vs-retire — submitters appending to the scheduler queue
      (queue lock) while the scheduler admits and retires
      (single-writer active/finished maps);
    * swap-vs-scrape — the scheduler swapping sequences in and out
      of the host tier (swap lock) vs a scraper summarising it.

    ``inject`` swaps one disciplined actor for a deliberately buggy
    one per :data:`INJECTIONS` class."""
    # the world: plain dicts standing in for the real structures
    reg_lock = san.guarded("fuzz.registry")
    queue_lock = san.guarded("fuzz.queue")
    swap_lock = san.guarded("fuzz.swap")
    wrong_lock = san.guarded("fuzz.wrong")
    metrics = san.shared("fuzz.registry.metrics",
                         guard="fuzz.registry")
    queue = san.shared("fuzz.sched.queue", guard="fuzz.queue")
    active = san.shared("fuzz.sched.active", single_writer=True)
    swap = san.shared("fuzz.swap.store", guard="fuzz.swap")
    # guardless, no-waiver attribute only the rogue-thread injection
    # touches: the sanction check is the only rule that can fire
    rogue_var = san.shared("fuzz.recorder.events")
    world = {"metrics": {}, "queue": collections.deque(),
             "active": {}, "swapped": {}, "done": 0, "seq": 0}

    def stepper(n):
        # the scheduler thread: admit, advance metrics, retire, swap
        for i in range(n):
            with queue_lock:
                queue.read()
                req = world["queue"].popleft() \
                    if world["queue"] else None
                if req is not None:
                    queue.write()
            yield
            if req is not None:
                active.write()
                world["active"][req] = 0
            yield
            with reg_lock:
                metrics.write()
                world["metrics"]["serving.steps"] = \
                    world["metrics"].get("serving.steps", 0) + 1
            yield
            if world["active"] and rng.random() < 0.3:
                victim = sorted(world["active"])[0]
                with swap_lock:
                    swap.write()
                    world["swapped"][victim] = \
                        world["active"].pop(victim)
                    active.write()
                yield
            if world["swapped"] and rng.random() < 0.5:
                with swap_lock:
                    swap.write()
                    rid, st = world["swapped"].popitem()
                    active.write()
                    world["active"][rid] = st
                yield
            if world["active"] and rng.random() < 0.4:
                rid = sorted(world["active"])[-1]
                active.write()
                del world["active"][rid]
                world["done"] += 1
            yield

    def submitter(n):
        for i in range(n):
            with queue_lock:
                queue.write()
                world["seq"] += 1
                world["queue"].append("r%d" % world["seq"])
            yield

    def scraper(n, lock=reg_lock, var=metrics):
        # the ops-server scrape: locked registry reads + GIL-atomic
        # single-writer population reads
        for i in range(n):
            with lock:
                var.read()
                dict(world["metrics"])
            yield
            with swap_lock:
                swap.read()
                len(world["swapped"])
            yield

    def bad_unguarded_writer(n):
        # BUG: bumps a guarded metric without the registry lock
        for i in range(n):
            metrics.write()
            world["metrics"]["serving.steps"] = \
                world["metrics"].get("serving.steps", 0) + 1
            yield

    def bad_lockset_scraper(n):
        # BUG: scrapes the queue under the WRONG lock — disjoint
        # locksets, no HB edge vs the submitter
        for i in range(n):
            with wrong_lock:
                queue.read()
                len(world["queue"])
            yield

    def bad_inverted(n, a, b):
        # BUG: acquires (a, b) while the partner acquires (b, a) —
        # the order graph is global, so the nested pairs close a
        # cycle no matter how the steps interleave. NB: never yield
        # while holding (all virtual actors share one real thread)
        for i in range(n):
            with a:
                with b:
                    metrics.read()
            yield

    def bad_rogue_writer(n):
        # BUG: a thread nobody sanctioned writing shared state
        for i in range(n):
            rogue_var.write()
            world["done"] += 0
            yield

    def bad_blocking_task(n):
        # BUG: a coroutine doing a blocking acquire on the loop
        for i in range(n):
            with reg_lock:
                metrics.read()
            yield

    actors = [
        _Actor("v:sched", "thread", None, stepper(40)),
        _Actor("v:submit0", "thread", None, submitter(24)),
        _Actor("v:submit1", "thread", None, submitter(24)),
        _Actor("v:scrape0", "thread", None, scraper(30)),
        _Actor("v:scrape1", "thread", None, scraper(30)),
    ]
    for a in actors:
        san.sanction(a.identity[0], a.identity[1], a.identity[2],
                     label="fuzz")
    if inject == "unguarded-shared-write":
        bad = _Actor("v:bug-writer", "thread", None,
                     bad_unguarded_writer(10))
    elif inject == "lockset-race":
        bad = _Actor("v:bug-scraper", "thread", None,
                     bad_lockset_scraper(10))
    elif inject == "lock-order-inversion":
        bad = _Actor("v:bug-invert", "thread", None,
                     bad_inverted(10, swap_lock, reg_lock))
        actors.append(_Actor("v:bug-invert2", "thread", None,
                             bad_inverted(10, reg_lock, swap_lock)))
        san.sanction("v:bug-invert2", label="fuzz")
    elif inject == "blocking-acquire-on-loop":
        bad = _Actor("v:bug-task", "task", "v-loop",
                     bad_blocking_task(4))
    elif inject == "unsanctioned-thread":
        bad = _Actor("v:bug-rogue", "thread", None,
                     bad_rogue_writer(10))
    elif inject is None:
        return actors
    else:
        raise ValueError("inject must be one of %s, got %r"
                         % (sorted(INJECTIONS), inject))
    if inject not in ("unsanctioned-thread",):
        san.sanction(bad.identity[0], bad.identity[1],
                     bad.identity[2], label="fuzz")
    actors.append(bad)
    return actors


def fuzz_interleavings(seed: int = 0, steps: int = 400,
                       inject: Optional[str] = None,
                       mode: str = "strict",
                       journal_max: Optional[int] = None) -> dict:
    """Deterministic seeded interleaving fuzz: a cooperative
    scheduler resumes one virtual actor at a time (seeded choice),
    so every interleaving is a pure function of ``seed`` — two runs
    with the same seed produce byte-identical journals.

    ``inject`` swaps in a buggy actor (see :data:`INJECTIONS`); in
    strict mode the sanitizer must then raise
    :class:`ConcurrencyError` — the proof the checker has teeth.
    Returns the run's stats dict (clean runs only)."""
    import random as _random

    rng = _random.Random(seed)
    san = ConcurrencySanitizer(mode=mode, journal_max=journal_max)
    actors = _fuzz_world(san, inject, _random.Random(seed + 1))
    live = list(actors)
    try:
        for _ in range(steps):
            if not live:
                break
            a = live[rng.randrange(len(live))]
            _virtual.actor = a.identity
            try:
                next(a.gen)
            except StopIteration:
                live.remove(a)
            finally:
                _virtual.actor = None
    except ConcurrencyError as e:
        e.sanitizer = san
        raise
    finally:
        _virtual.actor = None
    out = san.stats()
    out.update({"seed": seed, "steps": steps, "inject": inject,
                "actors_finished": len(actors) - len(live)})
    return out


# ---------------------------------------------------------------------------
# CLI: --replay a dumped journal / --fuzz the interleaving fuzzer
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.framework.concurrency",
        description="Replay a concurrency-sanitizer journal "
        "(reconstructs the detector up to the first violation) or "
        "run the deterministic interleaving fuzzer. Host-only: no "
        "device needed.")
    ap.add_argument("--replay", metavar="JOURNAL",
                    help="JSONL journal written by sanitizer.dump()")
    ap.add_argument("--fuzz", action="store_true",
                    help="run the seeded interleaving fuzzer in "
                    "strict mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--inject", default=None,
                    choices=sorted(INJECTIONS),
                    help="swap in this bug class; the fuzz run must "
                    "catch it (exit 0 = caught)")
    args = ap.parse_args(argv)

    if args.replay:
        res = replay_journal(args.replay)
        print(res.summary())
        return 0 if res.clean else 1
    if args.fuzz:
        try:
            stats = fuzz_interleavings(seed=args.seed,
                                       steps=args.steps,
                                       inject=args.inject)
        except ConcurrencyError as e:
            print(str(e))
            if args.inject:
                print("\ninjected bug %r CAUGHT (rule %s)"
                      % (args.inject, e.rule))
                return 0
            return 1
        print(json.dumps(stats, indent=1))
        if args.inject:
            print("injected bug %r was NOT caught" % args.inject)
            return 1
        return 0
    print("nothing to do: pass --replay <journal> or --fuzz")
    return 2


if __name__ == "__main__":  # pragma: no cover
    import sys

    # under `python -m` this file executes as the __main__ module,
    # whose ConcurrencyError is a DIFFERENT class object from the
    # package copy instrumented modules raise — dispatch to the
    # canonical module so `except ConcurrencyError` in main()
    # actually matches
    from paddle_tpu_torch.framework import concurrency as _canonical

    sys.exit(_canonical.main())
