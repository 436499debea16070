"""Embedded live-ops debug server of the port (counterpart of the
reference's ``framework/ops_server.py``): the read-only HTTP surface a
human or a scraper hits while the box serves.

:class:`OpsServer` is stdlib only (``http.server``), registry read-only
like the watchdog, one daemon thread, bound to 127.0.0.1:

==============  ==========================================================
endpoint        contents
==============  ==========================================================
``/``           plain-text index of every endpoint
``/metrics``    the Prometheus exposition, byte for byte
                ``telemetry.prometheus_text()`` over the same registry
                (one renderer, two transports)
``/statusz``    build, pid, server uptime, telemetry mode, registry
                epoch, key serving gauges, the SLO window (goodput and
                attainment) and every registered status provider (each
                live scheduler registers its ``_statusz_info``)
``/enginez``    async serving engines: pump, streams, backpressure
``/routerz``    disaggregated session routers: policy, replicas, sessions
``/tunez``      the capacity autotuner: candidate table, scores, winner
``/tracez``     the newest spans as a text table; ``?format=chrome``
                downloads the full chrome://tracing / Perfetto payload
``/planz``      the performance ledger's plan-vs-actual table;
                ``?format=json`` for the raw rows
``/flagz``      the FLAGS registry as JSON
``/incidentz``  index of flight-recorder bundles under
                ``FLAGS_telemetry_incident_dir``; ``?bundle=<name>``
                renders one bundle's ``summarize_incident`` replay
==============  ==========================================================

Arming: the server REFUSES to construct while ``FLAGS_telemetry=off``
(a debug surface over a registry that does not exist would serve empty
data, and the off path builds nothing). With telemetry on,
``FLAGS_ops_server_port=<port>`` makes every ``BatchScheduler``,
``ServingEngine`` and ``SessionRouter`` call :func:`maybe_start` at
construction (the engine on its pump thread): one process-wide server,
first caller wins, each registers its section. An explicit
``maybe_start(port=0)`` or ``OpsServer(port=0)`` binds an ephemeral
port. GET only: any other method gets 405.
"""
from __future__ import annotations

import json
import os
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from . import concurrency as _concurrency
from . import telemetry
from .flags import flag

__all__ = ["OpsServer", "maybe_start", "server", "stop"]

_INDEX = (
    ("/metrics", "Prometheus exposition (= telemetry.prometheus_text)"),
    ("/statusz", "build, flags, uptime, SLO window, watchdog state"),
    ("/tracez", "recent spans; ?format=chrome for the full payload"),
    ("/planz", "resource plans + perf-ledger plan-vs-actual"),
    ("/flagz", "FLAGS registry snapshot"),
    ("/incidentz", "incident bundles; ?bundle=<name> to replay one"),
    ("/enginez", "async serving engines: pump, streams, backpressure"),
    ("/routerz", "disagg session routers: policy, replicas, sessions"),
    ("/tunez", "capacity autotuner: candidate table, scores, winner"),
)


class OpsServer:
    """One read-only debug HTTP server over the live telemetry
    objects. ``registry``/``tracer``/``traces``/``ledger`` default to
    the process singletons, re-read PER REQUEST so a
    ``telemetry.reset()`` (bench arm isolation) never leaves the
    server scraping a detached registry."""

    def __init__(self, port: Optional[int] = None,
                 host: str = "127.0.0.1",
                 registry=None, tracer=None, traces=None,
                 ledger=None):
        if not telemetry.metrics_on():
            raise RuntimeError(
                "ops server refuses to start: FLAGS_telemetry is off "
                "— there is no registry to serve and the zero-cost "
                "off contract forbids building one (set "
                "FLAGS_telemetry=metrics|trace)")
        self._registry = registry
        self._tracer = tracer
        self._traces = traces
        self._ledger = ledger
        self._providers: Dict[str, Callable[[], Optional[dict]]] = {}
        self._eproviders: Dict[str, Callable[[], Optional[dict]]] = {}
        self._rproviders: Dict[str, Callable[[], Optional[dict]]] = {}
        self._tproviders: Dict[str, Callable[[], Optional[dict]]] = {}
        self._plock = _concurrency.guarded("ops_server.providers")
        _csan = _concurrency.sanitizer()
        self._cv = None if _csan is None else _csan.shared(
            "ops_server.providers", owner=self,
            guard="ops_server.providers")
        self._t_start = telemetry.clock()
        port = int(flag("ops_server_port") if port is None else port)
        ops = self

        class _Handler(BaseHTTPRequestHandler):
            # the ops plane must never write to the serving stderr
            def log_message(self, fmt, *args):  # noqa: D401
                pass

            def do_GET(self):
                ops._handle(self)

            def _refuse(self):
                ops._send(self, 405, "text/plain",
                          "the ops server is read-only: GET only\n")

            do_POST = do_PUT = do_DELETE = do_PATCH = _refuse
            do_HEAD = do_OPTIONS = _refuse

        self._httpd = ThreadingHTTPServer((host, max(port, 0)),
                                          _Handler)
        self._httpd.daemon_threads = True
        # the sanctioned thread helper: named, daemon, and (when the
        # concurrency sanitizer is live) registered with a
        # parent->child happens-before edge
        self._thread = _concurrency.spawn_thread(
            "paddle-ops-server", self._httpd.serve_forever)

    # -- lifecycle ----------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return "http://%s:%d" % (self._httpd.server_address[0],
                                 self.port)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    # -- status providers ---------------------------------------------------
    def add_status_provider(self, key: str,
                            fn: Callable[[], Optional[dict]]) -> None:
        """Register a ``/statusz`` section: ``fn()`` returns a JSON-
        able dict (or None to drop the section). Bound methods are
        held by weakref — a garbage-collected scheduler silently
        leaves the page instead of being pinned alive by it."""
        self._add_provider(self._providers, key, fn)

    def add_engine_provider(self, key: str,
                            fn: Callable[[], Optional[dict]]) -> None:
        """Register a ``/enginez`` section (one per ServingEngine):
        same contract and weakref semantics as
        ``add_status_provider`` — a garbage-collected engine drops
        off the page instead of being pinned alive by it."""
        self._add_provider(self._eproviders, key, fn)

    def add_router_provider(self, key: str,
                            fn: Callable[[], Optional[dict]]) -> None:
        """Register a ``/routerz`` section (one per disaggregated
        SessionRouter): same contract and weakref semantics as
        ``add_status_provider`` — a garbage-collected router drops
        off the page instead of being pinned alive by it."""
        self._add_provider(self._rproviders, key, fn)

    def add_tuner_provider(self, key: str,
                           fn: Callable[[], Optional[dict]]) -> None:
        """Register a ``/tunez`` section (one per capacity
        Autotuner; also feeds the /planz plan-vs-chosen column):
        same contract and weakref semantics as
        ``add_status_provider`` — a garbage-collected tuner drops
        off the page instead of being pinned alive by it."""
        self._add_provider(self._tproviders, key, fn)

    def _add_provider(self, store, key, fn) -> None:
        try:
            wm = weakref.WeakMethod(fn)

            def wrapped(wm=wm):
                m = wm()  # deref ONCE: a GC between two derefs would
                return None if m is None else m()  # fake an error
        except TypeError:
            wrapped = fn
        with self._plock:
            if self._cv is not None:
                self._cv.write()
            store[str(key)] = wrapped

    def _status_sections(self) -> Dict[str, dict]:
        return self._sections(self._providers)

    def _engine_sections(self) -> Dict[str, dict]:
        return self._sections(self._eproviders)

    def _router_sections(self) -> Dict[str, dict]:
        return self._sections(self._rproviders)

    def _tuner_sections(self) -> Dict[str, dict]:
        return self._sections(self._tproviders)

    def _sections(self, store) -> Dict[str, dict]:
        out = {}
        with self._plock:
            if self._cv is not None:
                self._cv.read()
            items = list(store.items())
        dead = []
        for key, fn in items:
            try:
                info = fn()
            except Exception as e:  # a provider bug must not 500 /statusz
                info = {"error": repr(e)}
            if info is None:
                dead.append(key)
                continue
            out[key] = info
        if dead:
            with self._plock:
                if self._cv is not None:
                    self._cv.write()
                for key in dead:
                    store.pop(key, None)
        return out

    # -- live handles (re-read per request) ---------------------------------
    def _reg(self):
        return self._registry if self._registry is not None \
            else telemetry.registry()

    def _trc(self):
        return self._tracer if self._tracer is not None \
            else telemetry.tracer()

    def _book(self):
        return self._traces if self._traces is not None \
            else telemetry.request_traces()

    def _led(self):
        if self._ledger is not None:
            return self._ledger
        from . import perf_ledger

        return perf_ledger.ledger()

    # -- request routing ----------------------------------------------------
    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        if self._cv is not None:
            # ThreadingHTTPServer spawns a stdlib thread per request
            # that spawn_thread cannot wrap — sanction it here
            _concurrency.sanitizer().adopt("ops-server-handler")
        parsed = urlparse(h.path)
        q = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
        route = {
            "/": self._page_index,
            "/metrics": self._page_metrics,
            "/statusz": self._page_statusz,
            "/tracez": self._page_tracez,
            "/planz": self._page_planz,
            "/flagz": self._page_flagz,
            "/incidentz": self._page_incidentz,
            "/enginez": self._page_enginez,
            "/routerz": self._page_routerz,
            "/tunez": self._page_tunez,
        }.get(parsed.path)
        if route is None:
            self._send(h, 404, "text/plain",
                       "unknown endpoint %s\n\n%s"
                       % (parsed.path, self._index_text()))
            return
        try:
            status, ctype, body = route(q)
        except Exception as e:  # debug surface: report, never crash
            status, ctype, body = 500, "text/plain", (
                "ops server error on %s: %r" % (parsed.path, e))
        self._send(h, status, ctype, body)

    @staticmethod
    def _send(h, status, ctype, body) -> None:
        data = body if isinstance(body, bytes) \
            else str(body).encode("utf-8")
        h.send_response(status)
        h.send_header("Content-Type",
                      ctype + "; charset=utf-8"
                      if ctype.startswith("text/") else ctype)
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)

    # -- pages --------------------------------------------------------------
    def _index_text(self) -> str:
        lines = ["paddle-tpu-torch live ops server", ""]
        for path, desc in _INDEX:
            lines.append("  %-12s %s" % (path, desc))
        return "\n".join(lines) + "\n"

    def _page_index(self, q):
        return 200, "text/plain", self._index_text()

    def _page_metrics(self, q):
        # ONE renderer for the scrape file and the live endpoint: the
        # byte-identity acceptance of the ops plane
        return 200, "text/plain", telemetry.prometheus_text(
            registry=self._reg())

    def _page_statusz(self, q):
        from .. import __version__ as _version

        reg = self._reg()
        lines = ["paddle-tpu-torch statusz", ""]
        lines.append("build        paddle_tpu_torch %s" % _version)
        lines.append("pid          %d" % os.getpid())
        lines.append("uptime_s     %.3f"
                     % (telemetry.clock() - self._t_start))
        lines.append("telemetry    %s" % telemetry.telemetry_mode())
        lines.append("flags        %d defined"
                     % len(self._flags_snapshot()))
        if reg is not None:
            snap = reg.snapshot()
            lines.append("epoch        %d" % reg.epoch)
            serving = snap.get("serving", {}) or {}
            keys = ("steps", "requests_admitted",
                    "requests_finished", "active_requests",
                    "queued_requests", "swapped_requests",
                    "aborted_deadline", "compile_count")
            if any(k in serving for k in keys):
                lines.append("")
                lines.append("serving")
                for k in keys:
                    if k in serving:
                        lines.append("  %-24s %s" % (k, serving[k]))
            slo_keys = ("goodput", "slo_window_requests",
                        "slo_attain_ttft", "slo_attain_tpot",
                        "slo_attain_queue_wait")
            if any(k in serving for k in slo_keys):
                lines.append("")
                lines.append("slo window")
                for k in slo_keys:
                    if k in serving:
                        lines.append("  %-24s %s" % (k, serving[k]))
        sections = self._status_sections()
        for key in sorted(sections):
            lines.append("")
            lines.append(key)
            lines.append(json.dumps(sections[key], indent=1,
                                    default=str, sort_keys=True))
        return 200, "text/plain", "\n".join(lines) + "\n"

    def _page_enginez(self, q):
        reg = self._reg()
        lines = ["paddle-tpu-torch enginez", ""]
        if reg is not None:
            eng = reg.snapshot().get("engine", {}) or {}
            keys = ("backpressure_state", "inflight_streams",
                    "submitted", "shed_total", "cancelled")
            if any(k in eng for k in keys):
                lines.append("engine metrics")
                for k in keys:
                    if k in eng:
                        lines.append("  %-24s %s" % (k, eng[k]))
        sections = self._engine_sections()
        if not sections:
            lines.append("")
            lines.append("(no live engines registered)")
        for key in sorted(sections):
            lines.append("")
            lines.append(key)
            lines.append(json.dumps(sections[key], indent=1,
                                    default=str, sort_keys=True))
        return 200, "text/plain", "\n".join(lines) + "\n"

    def _page_routerz(self, q):
        reg = self._reg()
        lines = ["paddle-tpu-torch routerz", ""]
        if reg is not None:
            rt = reg.snapshot().get("router", {}) or {}
            keys = ("backpressure_state", "sessions", "replicas",
                    "submitted", "cancelled")
            if any(k in rt for k in keys):
                lines.append("router metrics")
                for k in keys:
                    if k in rt:
                        lines.append("  %-24s %s" % (k, rt[k]))
        sections = self._router_sections()
        if not sections:
            lines.append("")
            lines.append("(no live routers registered)")
        for key in sorted(sections):
            lines.append("")
            lines.append(key)
            lines.append(json.dumps(sections[key], indent=1,
                                    default=str, sort_keys=True))
        return 200, "text/plain", "\n".join(lines) + "\n"

    def _page_tunez(self, q):
        reg = self._reg()
        lines = ["paddle-tpu-torch tunez", ""]
        if reg is not None:
            at = reg.snapshot().get("autotune", {}) or {}
            keys = ("state", "frontier", "best_score", "applies",
                    "windows", "quarantines")
            if any(k in at for k in keys):
                lines.append("autotune metrics")
                for k in keys:
                    if k in at:
                        lines.append("  %-24s %s" % (k, at[k]))
        sections = self._tuner_sections()
        if not sections:
            lines.append("")
            lines.append("(no live capacity autotuner registered)")
        for key in sorted(sections):
            info = sections[key]
            lines.append("")
            lines.append("%s  state=%s  switches=%s  quarantined=%s"
                         % (key, info.get("state"),
                            info.get("switches"),
                            info.get("quarantined")))
            rows = info.get("candidates") or []
            if rows:
                lines.append(
                    "  %-44s %12s %12s %4s %s"
                    % ("candidate", "static", "live", "win",
                       "status"))
                for r in rows:
                    live = r.get("live_score")
                    status = "quarantined:%s" % r.get(
                        "quarantine_reason") if r.get("quarantined") \
                        else ("infeasible:%s" % r.get(
                            "why_infeasible")
                            if not r.get("feasible") else "ok")
                    lines.append(
                        "  %-44s %12.4g %12s %4s %s"
                        % (str(r.get("key")),
                           r.get("static_score", float("nan")),
                           ("%.4g" % live) if live is not None
                           else "-",
                           "*" if r.get("winner") else "",
                           status))
            pvc = info.get("plan_vs_chosen") or []
            if pvc:
                lines.append("  plan-vs-chosen")
                for row in pvc:
                    lines.append(
                        "    %-24s %-22s -> %-22s%s"
                        % (row.get("knob"), row.get("plan"),
                           row.get("chosen"),
                           "  (changed)" if row.get("changed")
                           else ""))
        return 200, "text/plain", "\n".join(lines) + "\n"

    def _page_tracez(self, q):
        tr = self._trc()
        if q.get("format") in ("chrome", "perfetto"):
            payload = telemetry.chrome_payload(tr, self._book())
            if payload is None:
                return 404, "text/plain", \
                    "no tracer is live (FLAGS_telemetry=trace)\n"
            return 200, "application/json", json.dumps(
                payload, default=str)
        if tr is None:
            return 200, "text/plain", (
                "no tracer is live (FLAGS_telemetry=trace enables "
                "span collection)\n")
        spans = tr.spans()
        try:
            limit = max(1, int(q.get("limit", 64)))
        except ValueError:
            limit = 64
        lines = ["tracez: newest %d of %d retained span(s) "
                 "(?format=chrome for the full payload)"
                 % (min(limit, len(spans)), len(spans)), ""]
        lines.append("%-36s%12s%12s  %-14s %s"
                     % ("span", "wall_ms", "tid", "trace", "args"))
        for s in spans[-limit:][::-1]:
            lines.append(
                "%-36s%12.3f%12d  %-14s %s"
                % (s.path[:35], s.dur * 1e3, s.tid,
                   (s.trace_id or "-")[:13],
                   json.dumps(s.attrs, default=str)[:40]))
        return 200, "text/plain", "\n".join(lines) + "\n"

    def _page_planz(self, q):
        led = self._led()
        if led is None:
            return 200, "text/plain", (
                "no performance ledger is live "
                "(FLAGS_telemetry=metrics|trace)\n")
        from . import perf_ledger

        rows = led.report()
        if q.get("format") == "json":
            return 200, "application/json", json.dumps(
                {"plans": led.plans(), "rows": rows}, default=str)
        lines = [perf_ledger.format_rows(rows)
                 if rows else "no exec.* stamps yet"]
        plans = led.plans()
        lines.append("")
        lines.append("registered plans (%d)" % len(plans))
        for prog in sorted(plans):
            p = plans[prog]
            lines.append(
                "  %-28s flops=%g hbm_peak=%g wire=%g quantized=%g"
                % (prog[:27], p.get("flops_total", 0),
                   p.get("hbm_peak_bytes", 0),
                   p.get("comm_bytes_total", 0),
                   p.get("comm_bytes_quantized", 0)))
        # plan-vs-chosen: what the capacity autotuner picked against
        # the hand-seeded flags (full table on /tunez)
        tuners = self._tuner_sections()
        for key in sorted(tuners):
            pvc = tuners[key].get("plan_vs_chosen") or []
            if not pvc:
                continue
            lines.append("")
            lines.append("capacity autotuner plan-vs-chosen (%s)"
                         % key)
            lines.append("  %-24s %-22s %-22s" % ("knob", "plan",
                                                  "chosen"))
            for row in pvc:
                lines.append(
                    "  %-24s %-22s %-22s%s"
                    % (row.get("knob"), row.get("plan"),
                       row.get("chosen"),
                       "  (changed)" if row.get("changed") else ""))
        return 200, "text/plain", "\n".join(lines) + "\n"

    @staticmethod
    def _flags_snapshot() -> dict:
        from .flags import _REGISTRY as _flags_registry

        return dict(_flags_registry)

    def _page_flagz(self, q):
        return 200, "application/json", json.dumps(
            self._flags_snapshot(), indent=1, default=str,
            sort_keys=True)

    def _page_incidentz(self, q):
        inc_dir = str(flag("telemetry_incident_dir"))
        if not inc_dir:
            return 200, "text/plain", (
                "no incident directory configured "
                "(FLAGS_telemetry_incident_dir)\n")
        bundle = q.get("bundle")
        if bundle:
            # basename-only: the ops surface must not become a
            # directory-traversal oracle
            if os.path.basename(bundle) != bundle \
                    or not bundle.startswith("incident-"):
                return 400, "text/plain", \
                    "bundle must be a bare incident-* name\n"
            path = os.path.join(inc_dir, bundle)
            if not os.path.isdir(path):
                return 404, "text/plain", \
                    "no such bundle %s\n" % bundle
            from .flight_recorder import summarize_incident

            return 200, "text/plain", \
                summarize_incident(path) + "\n"
        try:
            names = sorted(
                n for n in os.listdir(inc_dir)
                if n.startswith("incident-")
                and not n.endswith(".tmp")
                and os.path.isdir(os.path.join(inc_dir, n)))
        except OSError as e:
            return 200, "text/plain", (
                "incident directory %s unreadable: %s\n"
                % (inc_dir, e))
        lines = ["incident bundles under %s (%d)"
                 % (inc_dir, len(names)), ""]
        for n in names:
            reason = epoch = "?"
            mpath = os.path.join(inc_dir, n, "manifest.json")
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
                reason = manifest.get("reason", "?")
                epoch = manifest.get("epoch", "?")
            except (OSError, ValueError):
                reason = "(manifest unreadable)"
            lines.append("  %-44s epoch=%-8s %s  "
                         "(/incidentz?bundle=%s)"
                         % (n, epoch, reason, n))
        return 200, "text/plain", "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# process-wide singleton (the registry()/tracer() discipline)
# ---------------------------------------------------------------------------

_SERVER: Optional[OpsServer] = None  # guarded-by: ops_server.state
_LOCK = threading.Lock()


def server() -> Optional[OpsServer]:
    """The process-wide ops server, or None when none was started."""
    return _SERVER


def maybe_start(port: Optional[int] = None) -> Optional[OpsServer]:
    """Start the ONE process-wide ops server if (and only if) the
    plane is armed: ``FLAGS_ops_server_port`` (or an explicit
    ``port``) is positive AND telemetry is on. Returns the running
    server (first caller wins; later callers get the same instance),
    or None when disarmed. A bind failure (port in use) warns and
    returns None — the debug surface must never take down serving."""
    global _SERVER
    if port is None:
        p = int(flag("ops_server_port"))
        if p <= 0:  # flag default: 0 disables the plane entirely
            return None
    else:
        p = int(port)  # explicit 0 = ephemeral OS-assigned (tests)
    if not telemetry.metrics_on():
        return None
    with _LOCK:
        if _SERVER is not None:
            return _SERVER
        try:
            _SERVER = OpsServer(port=p)
        except OSError as e:
            import warnings

            warnings.warn(
                "FLAGS_ops_server_port=%d: could not bind the ops "
                "server (%s); continuing without it" % (p, e),
                RuntimeWarning)
            return None
        return _SERVER


def stop() -> None:
    """Shut the process-wide server down (bench/test isolation)."""
    global _SERVER
    with _LOCK:
        if _SERVER is not None:
            _SERVER.close()
            _SERVER = None
