"""KV page-pool sanitizer of the port: ASan-for-pages over the paged
serving stack (counterpart of the reference's
``incubate/nn/page_sanitizer.py``, which imports no JAX; the port keeps
its own copy).

The refcounted/COW ``PagedKVCacheManager`` (paged_cache.py) is pure
host-side bookkeeping, which makes its failure modes silent: a page
freed while a sequence still references it, a skipped incref, a write
into a shared page without a copy-on-write fork — none of these crash;
they corrupt another request's KV bytes and surface (maybe) as garbage
tokens much later. With host swap-out preemption in the scheduler
(and a page-chain transfer between workers to come), those invariants
need a checker with teeth.

This module is that checker:

* a **shadow heap** mirrors every pool mutation as a typed event:
  per-page refcounts, *generation counters* (bumped each time a page
  is drawn from the free list — a recycled page is a new incarnation),
  and owner chains per sequence plus external (prefix-tree) refs;
* every event is validated against the shadow state; the **violation
  classes** are in :data:`VIOLATIONS` —

  ============================  ============================================
  rule id                       hazard
  ============================  ============================================
  use-after-free                a freed/recycled page is referenced: stale
                                generation in a chain, attach to a free
                                page, a fresh draw of a still-live page,
                                or a real refcount below the tracked one
  double-free                   free of an unknown/retired sequence, or a
                                decref with no external reference held
  refcount-leak                 real refcount above the tracked one after
                                a retire/decref (references dropped on the
                                floor keep pages allocated forever)
  cow-write-shared              a write lands in a page with refcount > 1
                                without a copy-on-write fork event first
  stale-page-table              a page table / seq_lens row handed to a
                                kernel disagrees with the shadow chain
  capacity-drift                num_free_pages / free-list / sequence-len
                                accounting diverges between pool and shadow
  ============================  ============================================

* events land in a **bounded journal**: a shadow-heap snapshot plus up
  to ``FLAGS_page_sanitizer_journal`` events (on overflow the journal
  re-snapshots and starts a new chunk, so a dump always replays from a
  sound state). On violation the raised :class:`PageSanitizerError`
  carries the journal tail, and ``san.dump(path)`` writes the whole
  chunk as JSONL for offline replay:

      python -m paddle_tpu_torch.incubate.nn.page_sanitizer --replay j.jsonl

  reconstructs the heap event by event up to the first violation.

* a **deterministic seeded fuzzer** (:func:`fuzz_pool`, also behind
  ``--fuzz``) drives randomized interleavings of alloc / append /
  append_ragged / fork / truncate / prefix pin / evict / retire across
  ``kv_dtype={float32,int8}`` and prefix-cache on/off in strict mode —
  and, with ``inject=<class>``, swaps in a deliberately buggy pool
  (a skipped incref, a dropped fork, ...) and must CATCH it, proving
  the checker has teeth.

Modes (``FLAGS_page_sanitizer``): ``off`` (default) — zero-cost, no
shadow objects are allocated and each instrumented pool method pays a
single ``is None`` check; ``warn`` — violations are reported as
``RuntimeWarning`` and execution continues; ``strict`` — violations
raise :class:`PageSanitizerError`, and ``BatchScheduler`` additionally
runs ``assert_ref_invariants()`` at the epoch cross-check stride
(``FLAGS_page_sanitizer_stride``).

Serving code mutates the pool only through its instrumented entry
points (pool state and pool-private methods are not touched from
outside ``PagedKVCacheManager``), so the events cover every mutation.
The port's pool books a step's slots in every layer pool before any
layer runs (``book_ragged``) and hands one pool's page table to every
layer's kernel; each pool still journals the same events, in the same
order, as the reference's pool does for the same call.

``fuzz_pool`` builds its pool on ``device`` (the card by default, as
every entry point of the port; tests pass ``"cpu"``).
"""
from __future__ import annotations

import collections
import itertools
import json
import warnings
from typing import Dict, List, Optional, Sequence

from ...framework.flags import flag

__all__ = [
    "VIOLATIONS", "PageSanitizer", "PageSanitizerError",
    "replay_journal", "fuzz_pool", "INJECTIONS",
]

MODES = ("off", "warn", "strict")

# rule id -> one-line hazard summary
VIOLATIONS: Dict[str, str] = {
    "use-after-free":
        "a freed or recycled page is referenced (stale generation, "
        "attach to a free page, fresh draw of a live page, or real "
        "refcount below the tracked one)",
    "double-free":
        "free of an unknown/retired sequence, decref without an "
        "external reference, or a refcount pushed below zero",
    "refcount-leak":
        "real refcount above the tracked one after retire/decref — "
        "dropped references keep pages allocated forever",
    "cow-write-shared":
        "a write lands in a page shared by >1 owner without a "
        "copy-on-write fork first (silent corruption of every other "
        "reader)",
    "stale-page-table":
        "a page-table or seq-lens row handed to a kernel disagrees "
        "with the sequence's tracked page chain",
    "capacity-drift":
        "free-list / num_free_pages / sequence-length accounting "
        "diverges between the real pool and the shadow heap",
}

# injectable bug classes fuzz_pool(inject=...) understands; each maps
# to the violation class strict mode must raise for it
INJECTIONS = tuple(VIOLATIONS)

_TAIL_N = 20  # events carried on a raised PageSanitizerError
_MAX_WARNINGS = 20  # warn mode: report this many, count the rest

_pool_ids = itertools.count()


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


class PageSanitizerError(RuntimeError):
    """A page-pool lifecycle violation, with the journal tail attached.

    ``rule`` is the :data:`VIOLATIONS` class; ``events`` the last
    journal events up to and including the violating one."""

    def __init__(self, rule: str, message: str, events: Sequence[dict]):
        self.rule = rule
        self.events = [dict(ev) for ev in events]
        super().__init__(
            "page sanitizer [%s]: %s\n"
            "--- journal tail (%d events; dump the full journal with "
            "sanitizer.dump(path) and replay with python -m "
            "paddle_tpu_torch.incubate.nn.page_sanitizer --replay) ---\n%s"
            % (rule, message, len(self.events),
               _format_events(self.events)))


class PageSanitizer:
    """Shadow heap + bounded event journal for ONE page pool.

    Pools construct one per instance when ``FLAGS_page_sanitizer`` (or
    the pool's ``sanitizer=`` kwarg) is ``warn``/``strict``; the pool
    emits events through :meth:`event` / :meth:`verify_pages` /
    :meth:`crosscheck` and this object does the rest. Replay builds
    one directly from a journal header (no pool involved)."""

    def __init__(self, num_pages: int, page_size: int,
                 mode: str = "strict", pool_id: Optional[str] = None,
                 journal_max: Optional[int] = None):
        if mode not in ("warn", "strict"):
            raise ValueError(
                "page sanitizer mode must be 'warn' or 'strict' "
                "(got %r; 'off' means: do not construct one)" % (mode,))
        self.mode = mode
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.pool_id = (pool_id if pool_id is not None
                        else "pool%d" % next(_pool_ids))
        self.journal_max = max(8, int(
            journal_max if journal_max is not None
            else flag("page_sanitizer_journal")))
        # shadow heap -------------------------------------------------
        self.ref = [0] * self.num_pages      # tracked refcount
        self.gen = [0] * self.num_pages      # incarnation counter
        self.free = set(range(self.num_pages))
        self.chains = {}   # seq -> [[page, gen], ...]
        self.lens = {}     # seq -> tokens
        self.ext = collections.Counter()     # page -> external refs
        # journal -----------------------------------------------------
        self._next_i = 0
        self._events: List[dict] = []
        self._snapshot = self._snapshot_state()
        self._prev_tail: List[dict] = []
        # accounting --------------------------------------------------
        self.counts = collections.Counter()  # events by op
        self.violations = 0
        self._warned = 0

    # -- journal -----------------------------------------------------------
    def _snapshot_state(self) -> dict:
        return {
            "i": self._next_i if hasattr(self, "_next_i") else 0,
            "ref": list(self.ref),
            "gen": list(self.gen),
            "free": sorted(self.free),
            "ext": sorted([int(p), int(c)] for p, c in self.ext.items()),
            "chains": [[s, [list(pg) for pg in ch]]
                       for s, ch in self.chains.items()],
            "lens": [[s, n] for s, n in self.lens.items()],
        }

    def _restore_state(self, snap: dict):
        self._next_i = int(snap.get("i", 0))
        self.ref = [int(r) for r in snap["ref"]]
        self.gen = [int(g) for g in snap["gen"]]
        self.free = set(int(p) for p in snap["free"])
        self.ext = collections.Counter(
            {int(p): int(c) for p, c in snap.get("ext", ())})
        self.chains = {s: [[int(p), int(g)] for p, g in ch]
                       for s, ch in snap.get("chains", ())}
        self.lens = {s: int(n) for s, n in snap.get("lens", ())}

    def _maybe_rollover(self):
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
        return ("--- page sanitizer journal tail ---\n"
                + _format_events(self.tail(n)))

    def dump(self, path: str) -> str:
        """Write header + snapshot + events as JSONL; the file replays
        standalone (``--replay``). Returns ``path``."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({
                "type": "header", "pool": self.pool_id,
                "num_pages": self.num_pages,
                "page_size": self.page_size, "mode": self.mode,
                "events": len(self._events),
                "violations": self.violations,
            }) + "\n")
            f.write(json.dumps(
                {"type": "snapshot", **self._snapshot}) + "\n")
            for ev in self._events:
                f.write(json.dumps({"type": "event", **ev}) + "\n")
        return path

    def stats(self) -> dict:
        return {"mode": self.mode, "pool": self.pool_id,
                "events": int(sum(self.counts.values())),
                "violations": int(self.violations),
                "by_op": dict(self.counts)}

    # -- violation plumbing ------------------------------------------------
    def _violate(self, rule: str, msg: str, ev: Optional[dict] = None):
        assert rule in VIOLATIONS, rule
        self.violations += 1
        if ev is not None:
            rec = {"rule": rule, "msg": msg}
            vs = ev.setdefault("violations", [])
            if rec not in vs:  # replays re-find recorded violations
                vs.append(rec)
        if self.mode == "strict":
            raise PageSanitizerError(rule, msg, self.tail())
        self._warned += 1
        if self._warned <= _MAX_WARNINGS:
            warnings.warn(
                "page sanitizer [%s] (%s): %s" % (rule, self.pool_id,
                                                  msg),
                RuntimeWarning, stacklevel=4)

    # -- event entry points ------------------------------------------------
    def event(self, op: str, pool=None, **fields) -> dict:
        """Record one typed event and apply/validate it against the
        shadow heap. ``pool`` is passed for events that verify real
        state inline (fork, append*, crosscheck)."""
        ev = {"i": self._next_i, "op": op}
        ev.update(fields)
        self._next_i += 1
        self.counts[op] += 1
        self._maybe_rollover()
        self._events.append(ev)
        self._apply(ev, pool)
        return ev

    def note(self, op: str, **fields) -> dict:
        """Context-only event (prefix-cache pin/unpin/evict/insert):
        journaled for diagnosis, no shadow semantics."""
        return self.event("note:" + op, **fields)

    def page_gens(self, pages) -> List[int]:
        """Current generation of each page — capture alongside a chain
        so a later :meth:`check_chain` can prove it unrecycled."""
        return [self.gen[int(p)] for p in pages]

    def check_chain(self, pages, gens, what: str = "chain"):
        """Validate a generation-tagged page chain captured earlier
        (prefix-tree node pages at insert time): every page must still
        be live and in the same incarnation."""
        self.event("chain-check", pages=[int(p) for p in pages],
                   gens=[int(g) for g in gens], what=what)

    def check_table(self, seq_ids, table, lens):
        """Validate kernel inputs: row i of ``table``/``lens`` must
        agree with seq_ids[i]'s shadow chain (rows are recorded
        trimmed to chain length + 1 so the journal stays bounded)."""
        rows, lns = [], []
        for i, s in enumerate(seq_ids):
            keep = len(self.chains.get(s, ())) + 1
            rows.append([int(p) for p in list(table[i])[:keep]])
            lns.append(int(lens[i]))
        self.event("page-table", seqs=list(seq_ids), rows=rows,
                   lens=lns)

    def verify_pages(self, pages, pool):
        """Post-mutation spot check: compare the real refcount of the
        touched pages against the shadow (records the real values into
        the last event so a replay re-checks them)."""
        ev = self._events[-1] if self._events else None
        real = {}
        for p in pages:
            p = int(p)
            if p not in real:
                real[p] = int(pool._refcnt[p])
        if ev is not None:
            ev["real_ref"] = real
        self._compare_refs(real, ev)

    def crosscheck(self, pool) -> dict:
        """Epoch cross-check: full shadow-vs-real comparison
        (refcounts, free list, sequence lens, capacity). The emitted
        event carries digests of the real state so a replay re-runs
        the same comparison."""
        return self.event("crosscheck", pool=pool)

    # -- shadow semantics --------------------------------------------------
    def _apply(self, ev: dict, pool=None):
        fn = getattr(self, "_ev_" + ev["op"].replace("-", "_"), None)
        if fn is not None:
            fn(ev, pool)
        # replayed events carry the real refcounts their live run saw
        if pool is None and "real_ref" in ev:
            self._compare_refs(ev["real_ref"], ev)

    def _compare_refs(self, real: dict, ev: Optional[dict]):
        for p, r in sorted((int(p), int(r)) for p, r in real.items()):
            s = self.ref[p]
            if r > s:
                self._violate(
                    "refcount-leak",
                    "page %d: real refcount %d above tracked %d "
                    "(a reference was dropped without release)"
                    % (p, r, s), ev)
            elif r < s:
                self._violate(
                    "use-after-free",
                    "page %d: real refcount %d below tracked %d "
                    "(premature release — the page can be recycled "
                    "under a live owner)" % (p, r, s), ev)

    def _draw(self, p: int, ev: dict, what: str) -> int:
        """A fresh page leaves the free list: bump its generation."""
        if p in self.free:
            self.free.discard(p)
            self.gen[p] += 1
            self.ref[p] = 1
            return self.gen[p]
        if self.ref[p] > 0:
            self._violate(
                "use-after-free",
                "%s drew page %d which is still live (refcount %d) — "
                "the pool recycled a referenced page" % (what, p,
                                                         self.ref[p]),
                ev)
        else:
            self._violate(
                "capacity-drift",
                "%s drew page %d which is neither free nor referenced "
                "in the shadow heap" % (what, p), ev)
        # keep going in warn mode: treat as a (re)draw
        self.gen[p] += 1
        self.ref[p] = max(self.ref[p], 1)
        return self.gen[p]

    def _release(self, p: int, g: int, ev: dict, what: str):
        if self.gen[p] != g:
            self._violate(
                "use-after-free",
                "%s released page %d at generation %d but the page is "
                "at generation %d (recycled under this owner)"
                % (what, p, g, self.gen[p]), ev)
        self.ref[p] -= 1
        if self.ref[p] < 0:
            self._violate(
                "double-free",
                "%s pushed page %d refcount below zero" % (what, p),
                ev)
            self.ref[p] = 0
        if self.ref[p] == 0:
            self.free.add(p)

    # individual event handlers -------------------------------------------
    def _ev_alloc(self, ev, pool):
        s = ev["seq"]
        if s in self.chains:  # pool raises its own ValueError
            return
        self.chains[s] = []
        self.lens[s] = 0

    def _ev_attach(self, ev, pool):
        s, pages, length = ev["seq"], ev["pages"], ev["length"]
        if s in self.chains:
            return
        bad = [int(p) for p in pages
               if int(p) in self.free or self.ref[int(p)] == 0]
        if bad:
            self._violate(
                "use-after-free",
                "attach(%r) references free page(s) %s (dangling "
                "chain)" % (s, bad), ev)
            return  # pool raises too; do not mutate the shadow
        chain = []
        for p in pages:
            p = int(p)
            self.ref[p] += 1
            chain.append([p, self.gen[p]])
        self.chains[s] = chain
        self.lens[s] = int(length)

    def _ev_free(self, ev, pool):
        s = ev["seq"]
        chain = self.chains.get(s)
        if chain is None:
            self._violate(
                "double-free",
                "free(%r): unknown or already-freed sequence" % (s,),
                ev)
            return
        for p, g in reversed(chain):
            self._release(p, g, ev, "free(%r)" % (s,))
        del self.chains[s]
        del self.lens[s]

    def _ev_incref(self, ev, pool):
        for p in ev["pages"]:
            p = int(p)
            if p in self.free or self.ref[p] == 0:
                self._violate(
                    "use-after-free",
                    "incref of free page %d (cannot resurrect)" % p,
                    ev)
                continue
            self.ref[p] += 1
            self.ext[p] += 1

    def _ev_decref(self, ev, pool):
        for p in ev["pages"]:
            p = int(p)
            if self.ext[p] <= 0:
                self._violate(
                    "double-free",
                    "decref of page %d with no external reference "
                    "held" % p, ev)
                continue
            self.ext[p] -= 1
            if self.ext[p] == 0:
                del self.ext[p]
            self._release(p, self.gen[p], ev, "decref")

    def _ev_truncate(self, ev, pool):
        s, n = ev["seq"], int(ev["n"])
        chain = self.chains.get(s)
        if chain is None:
            self._violate(
                "use-after-free",
                "truncate(%r): unknown or freed sequence" % (s,), ev)
            return
        keep = -(-n // self.page_size) if n else 0
        while len(chain) > keep:
            p, g = chain.pop()
            self._release(p, g, ev, "truncate(%r)" % (s,))
        self.lens[s] = n

    def _ev_fork(self, ev, pool):
        s, src, dst = ev["seq"], int(ev["src"]), int(ev["dst"])
        chain = self.chains.get(s)
        if not chain or chain[-1][0] != src:
            self._violate(
                "use-after-free",
                "fork(%r): source page %d is not the sequence's tail"
                % (s, src), ev)
            return
        g = self._draw(dst, ev, "fork(%r)" % (s,))
        chain[-1] = [dst, g]
        self.ref[src] -= 1
        if self.ref[src] < 0:
            self._violate("double-free",
                          "fork dropped page %d below zero" % src, ev)
            self.ref[src] = 0
        if self.ref[src] == 0:
            self.free.add(src)
        if pool is not None:
            self.verify_pages([src, dst], pool)

    def _ev_swap_out(self, ev, pool):
        """Host-tier swap-out: shared (kept) pages gain an external
        swap-hold reference before the sequence's own references
        drop; private pages return to the free list (their bytes
        live on host now)."""
        s = ev["seq"]
        chain = self.chains.get(s)
        if chain is None:
            self._violate(
                "double-free",
                "swap_out(%r): unknown or already-freed sequence"
                % (s,), ev)
            return
        kept = list(ev.get("kept") or [])
        for (p, g), keep in zip(chain, kept):
            if keep:
                self.ref[p] += 1
                self.ext[p] += 1
        for p, g in reversed(chain):
            self._release(p, g, ev, "swap_out(%r)" % (s,))
        del self.chains[s]
        del self.lens[s]

    def _ev_swap_in(self, ev, pool):
        """Host-tier swap-in: private positions are fresh draws
        (restored bytes), kept positions must still be live, in the
        SAME incarnation captured at swap-out, and carrying a swap
        hold — a hold lost while the sequence was out is a
        use-after-free here, not silent KV aliasing later."""
        s = ev["seq"]
        if s in self.chains:  # pool raises its own ValueError
            return
        gens = list(ev.get("gens") or [])
        gi = 0
        chain = []
        for p, keep in zip(ev["pages"], ev["kept"]):
            p = int(p)
            if keep:
                g = int(gens[gi]) if gi < len(gens) else self.gen[p]
                gi += 1
                if p in self.free or self.ref[p] == 0:
                    self._violate(
                        "use-after-free",
                        "swap_in(%r): kept page %d was freed while "
                        "the sequence was swapped out (the swap hold "
                        "was lost)" % (s, p), ev)
                elif self.gen[p] != g:
                    self._violate(
                        "use-after-free",
                        "swap_in(%r): kept page %d was recycled while "
                        "swapped out (captured generation %d, page at "
                        "%d)" % (s, p, g, self.gen[p]), ev)
                if self.ext[p] > 0:
                    self.ext[p] -= 1
                    if self.ext[p] == 0:
                        del self.ext[p]
                else:
                    self._violate(
                        "double-free",
                        "swap_in(%r): no swap hold (external "
                        "reference) on kept page %d" % (s, p), ev)
                # the sequence reference replaces the hold: refcount
                # net-unchanged
                chain.append([p, self.gen[p]])
            else:
                g = self._draw(p, ev, "swap_in(%r)" % (s,))
                chain.append([p, g])
        self.chains[s] = chain
        self.lens[s] = int(ev["length"])
        if pool is not None and ev["pages"]:
            self.verify_pages([int(p) for p in ev["pages"]], pool)

    def _ev_append(self, ev, pool):
        pages, offs = ev["pages"], ev["offs"]
        i = 0
        for s, c in zip(ev["seq_ids"], ev["counts"]):
            chain = self.chains.get(s)
            if chain is None:
                self._violate(
                    "use-after-free",
                    "append to unknown or freed sequence %r" % (s,),
                    ev)
                i += int(c)
                continue
            for _ in range(int(c)):
                p, off = int(pages[i]), int(offs[i])
                i += 1
                n = self.lens[s]
                if off != n % self.page_size:
                    self._violate(
                        "capacity-drift",
                        "append(%r): token %d landed at page offset "
                        "%d, tracked length expects %d"
                        % (s, n, off, n % self.page_size), ev)
                if off == 0:
                    g = self._draw(p, ev, "append(%r)" % (s,))
                    chain.append([p, g])
                else:
                    tp, tg = chain[-1] if chain else (None, None)
                    if p != tp:
                        self._violate(
                            "use-after-free",
                            "append(%r): mid-page write to page %d "
                            "but the tracked chain tail is %s"
                            % (s, p, tp), ev)
                    elif tg != self.gen[p]:
                        self._violate(
                            "use-after-free",
                            "append(%r): page %d recycled under this "
                            "sequence (chain generation %d, page at "
                            "%d)" % (s, p, tg, self.gen[p]), ev)
                    elif self.ref[p] > 1:
                        self._violate(
                            "cow-write-shared",
                            "append(%r): write into page %d shared by "
                            "%d owners without a copy-on-write fork"
                            % (s, p, self.ref[p]), ev)
                self.lens[s] = n + 1
        if pool is not None and pages:
            self.verify_pages(pages, pool)

    _ev_append_batch = _ev_append
    _ev_append_ragged = _ev_append

    def _ev_chain_check(self, ev, pool):
        for p, g in zip(ev["pages"], ev["gens"]):
            p, g = int(p), int(g)
            if p in self.free or self.ref[p] == 0:
                self._violate(
                    "use-after-free",
                    "%s: page %d was freed while the chain still "
                    "references it" % (ev.get("what", "chain"), p), ev)
            elif self.gen[p] != g:
                self._violate(
                    "use-after-free",
                    "%s: page %d was recycled (captured generation "
                    "%d, page now at %d) — a reference was skipped"
                    % (ev.get("what", "chain"), p, g, self.gen[p]),
                    ev)

    def _ev_page_table(self, ev, pool):
        for s, row, ln in zip(ev["seqs"], ev["rows"], ev["lens"]):
            chain = self.chains.get(s)
            if chain is None:
                self._violate(
                    "stale-page-table",
                    "page table built for unknown or freed sequence "
                    "%r" % (s,), ev)
                continue
            want = [p for p, _ in chain]
            got = [int(p) for p in row[:len(want)]]
            if got != want:
                self._violate(
                    "stale-page-table",
                    "page-table row for %r is %s but the tracked "
                    "chain is %s" % (s, got, want), ev)
            elif int(ln) != self.lens[s]:
                self._violate(
                    "stale-page-table",
                    "seq_lens row for %r is %d but the tracked "
                    "length is %d" % (s, int(ln), self.lens[s]), ev)

    def _ev_crosscheck(self, ev, pool):
        if pool is not None:
            ev["real_free"] = len(pool._free)
            ev["real_ref_sum"] = int(sum(pool._refcnt))
            ev["real_ref_nonzero"] = int(
                sum(1 for c in pool._refcnt if c > 0))
            ev["real_lens_sum"] = int(sum(pool._lens.values()))
            ev["real_seqs"] = len(pool._tables)
            # full-resolution live comparison
            for p in range(self.num_pages):
                r, s = pool._refcnt[p], self.ref[p]
                if r != s:
                    self._compare_refs({p: r}, ev)
            real_free = set(pool._free)
            if len(real_free) != len(pool._free):
                self._violate("capacity-drift",
                              "duplicate pages on the free list", ev)
            if real_free != self.free:
                self._violate(
                    "capacity-drift",
                    "free list diverged: %d real vs %d tracked free "
                    "pages (pool num_free_pages=%d)"
                    % (len(real_free), len(self.free),
                       pool.num_free_pages), ev)
            for s, n in self.lens.items():
                rn = pool._lens.get(s)
                if rn != n:
                    self._violate(
                        "capacity-drift",
                        "sequence %r length diverged: real %s vs "
                        "tracked %d" % (s, rn, n), ev)
            return
        # replay: digest comparison against the recorded real state
        if ev.get("real_ref_sum") is not None and \
                ev["real_ref_sum"] != sum(self.ref):
            delta = ev["real_ref_sum"] - sum(self.ref)
            self._violate(
                "refcount-leak" if delta > 0 else "use-after-free",
                "crosscheck: recorded real refcount sum %d vs tracked "
                "%d" % (ev["real_ref_sum"], sum(self.ref)), ev)
        if ev.get("real_free") is not None and \
                ev["real_free"] != len(self.free):
            self._violate(
                "capacity-drift",
                "crosscheck: recorded %d real free pages vs %d "
                "tracked" % (ev["real_free"], len(self.free)), ev)
        if ev.get("real_lens_sum") is not None and \
                ev["real_lens_sum"] != sum(self.lens.values()):
            self._violate(
                "capacity-drift",
                "crosscheck: recorded sequence-length sum %d vs "
                "tracked %d" % (ev["real_lens_sum"],
                                sum(self.lens.values())), ev)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


class ReplayResult:
    """Outcome of replaying a journal: the reconstructed shadow heap,
    the first violation (or None), and how far the replay got."""

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
        head = ("replayed %d/%d events on pool %r (%d pages x %d)"
                % (self.applied, self.total, san.pool_id,
                   san.num_pages, san.page_size))
        heap = ("heap: %d free, %d live, %d sequences, %d external "
                "refs" % (len(san.free),
                          sum(1 for r in san.ref if r > 0),
                          len(san.chains), sum(san.ext.values())))
        if self.error is None:
            return "%s\n%s\njournal replays clean" % (head, heap)
        return ("%s\n%s\nfirst violation [%s] at event #%d:\n%s"
                % (head, heap, self.error.rule, self.applied - 1,
                   str(self.error)))


def replay_journal(path: str) -> ReplayResult:
    """Reconstruct the shadow heap from a dumped journal, stopping at
    the first violation (strict-mode semantics regardless of the mode
    the journal was recorded under)."""
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
    san = PageSanitizer(header["num_pages"], header["page_size"],
                        mode="strict",
                        pool_id=header.get("pool", "replay"),
                        journal_max=max(8, len(events) + 8))
    if snapshot is not None:
        san._restore_state(snapshot)
    applied = 0
    for ev in events:
        applied += 1
        san.counts[ev.get("op", "?")] += 1
        san._events.append(ev)
        try:
            san._apply(ev, None)
        except PageSanitizerError as e:
            return ReplayResult(san, e, applied, len(events))
    return ReplayResult(san, None, applied, len(events))


# ---------------------------------------------------------------------------
# deterministic seeded fuzzer (+ injected bugs that prove the teeth)
# ---------------------------------------------------------------------------


def _injection_pools():
    """Deliberately buggy pool subclasses, one per injectable class.
    Each overrides an INTERNAL hook so the public (instrumented) entry
    points still emit their events — exactly the situation the
    sanitizer exists for: the mutation happened, the bookkeeping
    lied."""
    from .paged_cache import PagedKVCacheManager as _P

    class _SkipFork(_P):
        """BUG: never copy-on-write forks — writes land in shared
        pages (cow-write-shared)."""

        def _needs_fork(self, page):
            return False

    class _LeakyFree(_P):
        """BUG: free/retire drops the page references on the floor —
        refcounts never return to zero (refcount-leak)."""

        def _drop_refs(self, pages):
            pass

    class _SkipIncref(_P):
        """BUG: external references (the prefix tree's) are never
        taken — cached chains dangle once the writer retires and their
        pages get recycled under the tree (use-after-free)."""

        def incref(self, pages):
            pass

    class _StaleTable(_P):
        """BUG: kernel inputs are memoized per seq-id set — after a
        COW fork / truncate / append the kernel reads yesterday's
        rows (stale-page-table)."""

        def _padded_kernel_inputs(self, seq_ids, rows_pad, max_pages):
            memo = self.__dict__.setdefault("_memo_tables", {})
            key = tuple(seq_ids)
            if key not in memo:
                memo[key] = super()._padded_kernel_inputs(
                    seq_ids, rows_pad, max_pages)
            return memo[key]

    return {
        "cow-write-shared": _SkipFork,
        "refcount-leak": _LeakyFree,
        "use-after-free": _SkipIncref,
        "stale-page-table": _StaleTable,
    }


def fuzz_pool(seed: int = 0, steps: int = 300,
              kv_dtype: str = "float32", prefix_cache: bool = True,
              inject: Optional[str] = None, num_pages: int = 48,
              page_size: int = 4, kv_heads: int = 2, head_dim: int = 4,
              crosscheck_every: int = 20, mode: str = "strict",
              max_active: int = 6, device=None) -> dict:
    """Deterministic seeded fuzz of the instrumented pool: randomized
    interleavings of admit (alloc/attach after a prefix match),
    append / append_batch / append_ragged (mid-page COW resumes
    included), truncate, prefix pin/unpin, LRU evict, retire
    (insert + free), and kernel-input builds, with an epoch
    cross-check every ``crosscheck_every`` steps.

    ``inject`` swaps in a buggy pool (see :data:`INJECTIONS`) or
    schedules a buggy action (double-free, out-of-band free-list
    theft); in strict mode the sanitizer must then raise
    :class:`PageSanitizerError` — the proof the checker has teeth.
    ``device``: where the pool's pages live (default: the card, as
    every entry point of the port; pass ``"cpu"`` without one).
    Returns the run's stats dict (clean runs only)."""
    import random as _random

    import numpy as np
    import torch

    from ...inference.prefix_cache import RadixPrefixCache
    from .paged_cache import PagedKVCacheManager

    if inject is not None and inject not in INJECTIONS:
        raise ValueError("inject must be one of %s, got %r"
                         % (sorted(INJECTIONS), inject))
    pool_cls = _injection_pools().get(inject, PagedKVCacheManager)
    pool = pool_cls(num_pages, page_size, kv_heads, head_dim,
                    kv_dtype=kv_dtype, sanitizer=mode, device=device)
    tree = RadixPrefixCache([pool]) if prefix_cache else None
    rng = _random.Random(seed)
    arr = np.random.RandomState(seed)

    def kv(n):
        return torch.from_numpy(arr.uniform(
            -1.0, 1.0, (n, kv_heads, head_dim)).astype("float32")).to(
                pool.device)

    prefixes = [[1, 2, 3, 4], [1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 9, 9],
                [7, 7, 7]]
    drift_step = steps // 2 if inject == "capacity-drift" else None
    dfree_armed = inject == "double-free"

    try:
        return _fuzz_body(
            pool, tree, rng, kv, prefixes, steps, page_size,
            crosscheck_every, max_active, drift_step, dfree_armed,
            seed=seed, kv_dtype=kv_dtype, prefix_cache=prefix_cache,
            inject=inject)
    except PageSanitizerError as e:
        # expose the sanitizer so callers can dump + replay the
        # journal of the caught injection
        e.sanitizer = pool.sanitizer
        raise


def _fuzz_body(pool, tree, rng, kv, prefixes, steps, page_size,
               crosscheck_every, max_active, drift_step, dfree_armed,
               *, seed, kv_dtype, prefix_cache, inject):
    """Loop body of :func:`fuzz_pool` (split out so the caller can
    attach the journal to a caught violation)."""
    active = {}    # sid -> (tokens, pinned path)
    retired = []   # for the double-free action
    next_id = 0
    for step in range(steps):
        if drift_step is not None and step == drift_step and pool._free:
            # the capacity-drift INJECTION is by definition an
            # out-of-band mutation the audit exists to forbid
            pool._free.pop()  # trace-lint: ok(deliberate injected bug)
            drift_step = None
        op = rng.random()
        sids = sorted(active)
        if op < 0.32 and len(active) < max_active:
            # admit: match the prefix tree, attach or alloc, then
            # prefill the rest through append_ragged (mid-page COW
            # resume whenever the hit has a partial tail page)
            toks = (list(rng.choice(prefixes))
                    + [rng.randrange(2, 30)
                       for _ in range(rng.randrange(0, 6))])
            m = (tree.match(toks, limit=len(toks) - 1)
                 if tree is not None else None)
            hit = m.length if m is not None else 0
            if tree is not None:
                tree.pin(m.path)
            rest = len(toks) - hit
            need = (-(-len(toks) // page_size)
                    - hit // page_size + 1)
            if pool.num_free_pages < need and tree is not None:
                tree.evict(need - pool.num_free_pages)
            if pool.num_free_pages < need:
                if tree is not None:
                    tree.unpin(m.path)
                continue
            sid = "s%d" % next_id
            next_id += 1
            if hit:
                pool.attach(sid, m.chains[0], hit)
            else:
                pool.alloc(sid)
            if rest:
                pool.append_ragged([sid], [rest], kv(rest), kv(rest))
            active[sid] = (toks, m.path if m is not None else ())
        elif op < 0.52 and sids:
            # one decode step for a random batch slice
            batch = [s for s in sids if rng.random() < 0.7] or sids[:1]
            need = sum(1 for s in batch
                       if pool.seq_len(s) % page_size == 0
                       or pool.pending_cow(s))
            if need <= pool.num_free_pages:
                pool.append_batch(batch, kv(len(batch)),
                                  kv(len(batch)))
                for s in batch:
                    toks, path = active[s]
                    toks.append(rng.randrange(2, 30))
        elif op < 0.62 and sids:
            # ragged mixed chunk (0..3 tokens per sequence)
            counts = [rng.randrange(0, 4) for _ in sids]
            if sum(counts) and (pool.ragged_pages_needed(sids, counts)
                                <= pool.num_free_pages):
                pool.append_ragged(sids, counts, kv(sum(counts)),
                                   kv(sum(counts)))
                for s, c in zip(sids, counts):
                    active[s][0].extend(
                        rng.randrange(2, 30) for _ in range(c))
        elif op < 0.70 and sids:
            # speculative-style rollback
            s = rng.choice(sids)
            n = pool.seq_len(s)
            if n:
                cut = rng.randrange(0, n)
                pool.truncate(s, cut)
                del active[s][0][cut:]
        elif op < 0.82 and sids:
            # retire: publish the prefix, unpin, free
            s = rng.choice(sids)
            toks, path = active.pop(s)
            n = pool.seq_len(s)
            if tree is not None:
                tree.insert(toks[:n], [pool.seq_pages(s)])
                tree.unpin(path)
            pool.free(s)
            retired.append(s)
            if dfree_armed and rng.random() < 0.5:
                dfree_armed = False
                pool.free(s)  # the injected double-free
        elif op < 0.92 and sids:
            # kernel-input build (page-table staleness check)
            pool.page_table(sids)
            pool.seq_lens(sids)
        elif tree is not None:
            tree.evict(rng.randrange(1, 6))
        if crosscheck_every and (step + 1) % crosscheck_every == 0:
            pool.sanitizer_crosscheck()

    if dfree_armed and retired:
        pool.free(retired[-1])  # guarantee the injected double-free
    for s in sorted(active):
        toks, path = active.pop(s)
        if tree is not None:
            tree.insert(toks[:pool.seq_len(s)], [pool.seq_pages(s)])
            tree.unpin(path)
        pool.free(s)
    if tree is not None:
        tree.clear()
    pool.sanitizer_crosscheck()
    san = pool.sanitizer
    return {
        "steps": steps, "seed": seed, "kv_dtype": kv_dtype,
        "prefix_cache": bool(prefix_cache), "inject": inject,
        "sequences": next_id,
        "free_pages": pool.num_free_pages,
        "events": int(sum(san.counts.values())) if san else 0,
        "violations": int(san.violations) if san else 0,
        "by_op": dict(san.counts) if san else {},
    }


# ---------------------------------------------------------------------------
# CLI: --replay a dumped journal / --fuzz the instrumented pool
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.incubate.nn.page_sanitizer",
        description="Replay a page-sanitizer journal (reconstructs "
        "the shadow heap up to the first violation) or run the "
        "deterministic pool fuzzer (--device cpu runs it without a "
        "card).")
    ap.add_argument("--replay", metavar="JOURNAL",
                    help="JSONL journal written by sanitizer.dump()")
    ap.add_argument("--fuzz", action="store_true",
                    help="run the seeded fuzzer in strict mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--kv-dtype", default="float32",
                    choices=["float32", "int8"])
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the pool's device (default: the card)")
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
            stats = fuzz_pool(seed=args.seed, steps=args.steps,
                              kv_dtype=args.kv_dtype,
                              prefix_cache=not args.no_prefix_cache,
                              inject=args.inject, device=args.device)
        except PageSanitizerError as e:
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
    # whose PageSanitizerError is a DIFFERENT class object from the
    # package copy that paged_cache raises — dispatch to the canonical
    # module so `except PageSanitizerError` in main()/fuzz_pool
    # actually matches
    from paddle_tpu_torch.incubate.nn import page_sanitizer as _canonical

    sys.exit(_canonical.main())
