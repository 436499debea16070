"""Incident flight recorder of the port (counterpart of the reference's
``framework/flight_recorder.py``, which imports no JAX; the port keeps
its own copy): every watchdog trip captures its own evidence.

A watchdog event (framework/watchdog.py) used to be a dict in a
bounded log: by the time a human looked, the registry had moved on,
the span ring had rolled over, and the sanitizer journal was gone.
:class:`FlightRecorder` makes every trip self-documenting: on any
watchdog fire (or an explicit :meth:`dump_incident`) it writes ONE
atomic, bounded **incident bundle** directory under
``FLAGS_telemetry_incident_dir``:

======================  ====================  =========================
manifest entry          file                  contents
======================  ====================  =========================
``manifest``            manifest.json         reason/classes/epoch + the
                                              entry table below
``watchdog_events``     watchdog_events.jsonl the triggering events plus
                                              the full bounded event log
``metrics``             metrics.json          full registry snapshot
``prometheus``          prometheus.txt        Prometheus text rendering
``chrome_trace``        chrome_trace.json     span ring + per-request
                                              lanes (trace mode only)
``ledger``              ledger.json           performance-ledger top-N
                                              (plan-vs-actual rows)
``plans``               plans.json            registered resource-plan
                                              summaries
``flags``               flags.json            FLAGS registry snapshot
``sanitizer_journal``   sanitizer_journal     page-sanitizer journal
                        .jsonl                tail (when handed in)
``concurrency_journal`` concurrency_journal   concurrency-sanitizer
                        .jsonl                race-journal tail (when
                                              handed in)
======================  ====================  =========================

Atomicity: every member is written through telemetry's atomic-write
helper into a ``<bundle>.tmp`` staging directory, which is renamed to
the final bundle name as the LAST step — a reader never sees a
half-written bundle. Bounded:
``FLAGS_telemetry_incident_keep`` caps retained bundles (oldest
pruned), the ledger slice is top-N, and the watchdog log / span ring
are already bounded.

Replay: ``python -m paddle_tpu_torch.framework.telemetry
--summarize-incident <bundle>`` reconstructs the story — what fired,
at which epoch, which programs were eating the step wall, what the
registry said. A torn FINAL line in a ``.jsonl`` member (the process
died mid-write) is tolerated and noted, matching the telemetry CLI's
truncated-JSONL behavior; newline-terminated garbage still raises.

DISCIPLINE: this module is host-only (no torch, no device code) and
registry-READ-ONLY like the watchdog — it
snapshots evidence, it never mutates the metrics it records, never
calls pool-private methods, and pool-adjacent evidence (the
sanitizer journal tail) is handed in by the scheduler through
``context``.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
from typing import Dict, List, Optional

from . import concurrency as _concurrency
from . import telemetry as _telemetry
from .flags import flag

__all__ = ["FlightRecorder", "summarize_incident"]

_MANIFEST = "manifest.json"

# process-wide bundle sequence: two recorders in one process (the
# multi-scheduler setup the serving.compile_count.<uid> gauges exist
# for) must never stage the same bundle name — a colliding
# os.rename(tmp, final) would fail and silently disable a recorder
_BUNDLE_SEQ = itertools.count(1)


def _slug(s: str, limit: int = 40) -> str:
    out = "".join(ch if (ch.isalnum() or ch in "-_") else "-"
                  for ch in str(s))
    return (out or "incident")[:limit]


class FlightRecorder:
    """Atomic incident-bundle writer over the live telemetry objects.

    All handles are optional — a metrics-only scheduler has no tracer
    or trace book, a watchdog-less caller still gets metrics/ledger
    evidence. ``out_dir`` defaults to ``FLAGS_telemetry_incident_dir``
    and must be non-empty; ``keep`` to
    ``FLAGS_telemetry_incident_keep``."""

    LEDGER_TOP_N = 16

    def __init__(self, registry=None, tracer=None, traces=None,
                 watchdog=None, ledger=None,
                 out_dir: Optional[str] = None,
                 keep: Optional[int] = None):
        out_dir = str(flag("telemetry_incident_dir")
                      if out_dir is None else out_dir)
        if not out_dir:
            raise ValueError(
                "FlightRecorder needs an incident directory "
                "(FLAGS_telemetry_incident_dir or out_dir=)")
        self.out_dir = out_dir
        self.keep = max(1, int(flag("telemetry_incident_keep")
                               if keep is None else keep))
        self.registry = registry
        self.tracer = tracer
        self.traces = traces
        self.watchdog = watchdog
        self.ledger = ledger
        self._seq = 0
        self.bundles_written = 0
        # concurrency-sanitizer handle: bundle staging is single-
        # writer by contract (the scheduler's step loop is the only
        # caller of record()/dump_incident()); a watchdog firing from
        # a second thread becomes a journaled violation instead of a
        # torn bundle
        _csan = _concurrency.sanitizer()
        self._cv = None if _csan is None else _csan.shared(
            "flight_recorder.bundles", owner=self,
            single_writer=True)

    # -- public entry points ------------------------------------------------
    def record(self, events: List[dict],
               context: Optional[dict] = None) -> str:
        """Write one bundle for a watchdog trip: ``events`` are the
        events fired THIS check pass (they lead the
        watchdog_events.jsonl member, ahead of the historical log).
        Returns the final bundle path."""
        classes = sorted({str(ev.get("class", "?"))
                          for ev in (events or [])})
        reason = "+".join(classes) if classes else "watchdog"
        return self._write_bundle(reason, classes, list(events or ()),
                                  context)

    def dump_incident(self, reason: str = "manual",
                      context: Optional[dict] = None) -> str:
        """Explicit capture — same bundle, no triggering events."""
        return self._write_bundle(str(reason), [], [], context)

    # -- bundle assembly ----------------------------------------------------
    def _write_bundle(self, reason, classes, events, context) -> str:
        if self._cv is not None:
            self._cv.write()
        os.makedirs(self.out_dir, exist_ok=True)
        self._seq = next(_BUNDLE_SEQ)  # process-unique, not per-
        # instance: sibling recorders must never collide on a name
        name = "incident-%d-%04d-%s" % (
            os.getpid(), self._seq, _slug(reason))
        final = os.path.join(self.out_dir, name)
        tmp = final + ".tmp"
        if os.path.isdir(tmp):  # a crashed earlier attempt
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries: Dict[str, str] = {}

        def put(key, fname, text):
            _telemetry.atomic_write_text(
                os.path.join(tmp, fname), text)
            entries[key] = fname

        def put_json(key, fname, obj):
            put(key, fname, json.dumps(obj, indent=1, default=str))

        def put_jsonl(key, fname, records):
            put(key, fname, "".join(
                json.dumps(r, default=str) + "\n" for r in records))

        # watchdog evidence: the triggering events first, then the
        # full bounded log (duplicates are fine — the trigger is the
        # headline, the log is the history)
        log = self.watchdog.to_records() \
            if self.watchdog is not None else []
        put_jsonl("watchdog_events", "watchdog_events.jsonl",
                  list(events) + log)
        snapshot = self.registry.snapshot() \
            if self.registry is not None else {}
        put_json("metrics", "metrics.json", snapshot)
        put("prometheus", "prometheus.txt",
            _telemetry.prometheus_text(snapshot=snapshot))
        chrome = _telemetry.chrome_payload(self.tracer, self.traces)
        if chrome is not None:
            put_json("chrome_trace", "chrome_trace.json", chrome)
        if self.ledger is not None:
            put_json("ledger", "ledger.json",
                     self.ledger.report(top=self.LEDGER_TOP_N))
            put_json("plans", "plans.json", self.ledger.plans())
        from .flags import _REGISTRY as _flags_registry

        put_json("flags", "flags.json", dict(_flags_registry))
        tail = (context or {}).get("sanitizer_journal_tail")
        if tail:
            put_jsonl("sanitizer_journal", "sanitizer_journal.jsonl",
                      list(tail))
        ctail = (context or {}).get("concurrency_journal_tail")
        if ctail:
            put_jsonl("concurrency_journal",
                      "concurrency_journal.jsonl", list(ctail))
        epoch = getattr(self.registry, "epoch", 0) \
            if self.registry is not None else 0
        manifest = {
            "version": 1,
            "reason": str(reason),
            "classes": list(classes),
            "epoch": int(epoch),
            "wall": _telemetry.clock(),
            "n_trigger_events": len(events),
            "entries": dict(entries),
        }
        _telemetry.atomic_write_text(
            os.path.join(tmp, _MANIFEST),
            json.dumps(manifest, indent=1, default=str))
        # the atomicity point: the fully-written staging dir becomes
        # the bundle in one rename — no reader ever sees a partial
        os.rename(tmp, final)
        self.bundles_written += 1
        self._prune()
        return final

    def _prune(self) -> None:
        """Keep at most ``self.keep`` bundles, oldest removed first
        (crashed ``.tmp`` staging dirs are swept too)."""
        try:
            names = os.listdir(self.out_dir)
        except OSError:
            return
        bundles = []
        for n in names:
            p = os.path.join(self.out_dir, n)
            if not n.startswith("incident-") or not os.path.isdir(p):
                continue
            if n.endswith(".tmp"):
                # sweep only staging dirs left by OTHER (crashed)
                # processes — a same-pid .tmp may be a sibling
                # recorder's bundle mid-write on another thread
                try:
                    tmp_pid = int(n.split("-")[1])
                except (IndexError, ValueError):
                    tmp_pid = -1
                if tmp_pid != os.getpid():
                    shutil.rmtree(p, ignore_errors=True)
                continue
            try:
                bundles.append((os.stat(p).st_mtime, p))
            except OSError:
                continue
        bundles.sort()
        for _, p in bundles[:max(0, len(bundles) - self.keep)]:
            shutil.rmtree(p, ignore_errors=True)


# ---------------------------------------------------------------------------
# replay: --summarize-incident
# ---------------------------------------------------------------------------


def _read_text(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def summarize_incident(bundle_dir: str) -> str:
    """Reconstruct one incident bundle's story as text — the
    ``--summarize-incident`` CLI body. Missing optional members are
    reported, torn-final-line ``.jsonl`` members are tolerated and
    noted (telemetry's truncated-JSONL contract); a ``.json`` member
    that fails to parse is flagged as unreadable rather than
    aborting the whole replay."""
    manifest_path = os.path.join(bundle_dir, _MANIFEST)
    if not os.path.isfile(manifest_path):
        raise ValueError(
            "%s is not an incident bundle (no %s)"
            % (bundle_dir, _MANIFEST))
    manifest = json.loads(_read_text(manifest_path))
    entries = manifest.get("entries", {})
    lines = []
    lines.append("incident bundle %s" % os.path.basename(
        os.path.abspath(bundle_dir)))
    lines.append("  reason   %s" % manifest.get("reason", "?"))
    lines.append("  classes  %s" % (
        ", ".join(manifest.get("classes") or []) or "(none)"))
    lines.append("  epoch    %s" % manifest.get("epoch", "?"))
    lines.append("  entries  (%d)" % len(entries))
    missing = []
    for key in sorted(entries):
        fname = entries[key]
        present = os.path.isfile(os.path.join(bundle_dir, fname))
        if not present:
            missing.append(key)
        lines.append("    %-20s %-26s %s"
                     % (key, fname, "ok" if present else "MISSING"))
    notes = []

    def load_json(key):
        fname = entries.get(key)
        if fname is None:
            return None
        path = os.path.join(bundle_dir, fname)
        if not os.path.isfile(path):
            return None
        try:
            return json.loads(_read_text(path))
        except json.JSONDecodeError:
            notes.append("%s (%s) is unreadable — truncated "
                         "mid-write?" % (key, fname))
            return None

    # watchdog events (jsonl: torn final line tolerated, terminated
    # garbage raises — the shared _load_jsonl contract)
    wd_name = entries.get("watchdog_events")
    if wd_name and os.path.isfile(os.path.join(bundle_dir, wd_name)):
        loaded = _telemetry._load_jsonl(
            os.path.join(bundle_dir, wd_name))
        evs = loaded["watchdog"]
        if loaded["truncated"]:
            notes.append("watchdog_events.jsonl final line was "
                         "truncated (torn mid-write); ignored")
        lines.append("")
        lines.append("watchdog events (%d)" % len(evs))
        for ev in evs[:16]:
            lines.append(
                "  epoch %-6s %-20s %s"
                % (ev.get("epoch", "?"), ev.get("class", "?"),
                   json.dumps(ev.get("detail", {}),
                              default=str)[:70]))
        if len(evs) > 16:
            lines.append("  ... %d more" % (len(evs) - 16))

    ledger_rows = load_json("ledger")
    if ledger_rows:
        from . import perf_ledger

        lines.append("")
        lines.append(perf_ledger.format_rows(ledger_rows))

    metrics = load_json("metrics")
    if metrics is not None:
        serving = metrics.get("serving", {}) or {}
        lines.append("")
        lines.append("registry snapshot: %d namespace(s)"
                     % sum(1 for v in metrics.values()
                           if isinstance(v, dict)))
        for key in ("steps", "goodput", "compile_count",
                    "requests_admitted", "requests_finished",
                    "aborted_deadline", "preempt_victims"):
            if key in serving:
                lines.append("  serving.%-18s %s"
                             % (key, serving[key]))

    chrome = load_json("chrome_trace")
    if chrome is not None:
        lines.append("")
        lines.append("chrome trace: %d event(s) (load in "
                     "chrome://tracing or Perfetto)"
                     % len(chrome.get("traceEvents") or []))

    san_name = entries.get("sanitizer_journal")
    if san_name and os.path.isfile(
            os.path.join(bundle_dir, san_name)):
        n = sum(1 for ln in _read_text(
            os.path.join(bundle_dir, san_name)).splitlines() if ln)
        lines.append("")
        lines.append("sanitizer journal tail: %d event(s)" % n)

    conc_name = entries.get("concurrency_journal")
    if conc_name and os.path.isfile(
            os.path.join(bundle_dir, conc_name)):
        n = sum(1 for ln in _read_text(
            os.path.join(bundle_dir, conc_name)).splitlines() if ln)
        lines.append("")
        lines.append("concurrency race-journal tail: %d event(s)" % n)

    if missing:
        lines.append("")
        lines.append("WARNING: %d manifest entr%s missing: %s"
                     % (len(missing),
                        "y is" if len(missing) == 1 else "ies are",
                        ", ".join(missing)))
    for note in notes:
        lines.append("")
        lines.append("note: %s" % note)
    return "\n".join(lines)
