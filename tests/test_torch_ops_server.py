"""The port's embedded live-ops debug server
(``framework/ops_server.py``), on the CPU.

The reference's ``tests/test_ops_server.py`` cases run against the port:
arming (it refuses to start with telemetry off; ``FLAGS_ops_server_port``
0 builds nothing), ``/metrics`` byte for byte ``prometheus_text``, the
``/statusz`` provider surface (weakly held sections), ``/tracez`` text
and chrome payload, ``/planz`` over the performance ledger, ``/flagz``,
``/incidentz`` (index, replay view, traversal guard) and the routing.
Any method but GET gets 405 (the reference's server answers 501).

Against the JAX package: after the same lockstep serving run (the
overload harness of ``tests/test_torch_overload.py``, preemption to the
swap tier, metrics on, on a fake clock) the two servers' ``/metrics``
bodies are equal, with each exemplar's label (a per-process trace id)
dropped; a scheduler built with ``FLAGS_ops_server_port`` set registers
its ``/statusz`` section in both packages.
"""
import gc
import json
import re
import urllib.error
import urllib.request

import pytest

from paddle_tpu.framework import ops_server as jax_ops_server
from paddle_tpu.framework import telemetry as jax_telemetry
from paddle_tpu.framework.flags import set_flags as jax_set_flags
from paddle_tpu.inference import serving as jax_serving

from paddle_tpu_torch.framework import ops_server, telemetry
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.inference import serving as port_serving

import test_torch_overload as overload


@pytest.fixture
def tel_off():
    set_flags({"telemetry": "off"})
    telemetry.reset()
    ops_server.stop()
    yield
    ops_server.stop()
    set_flags({"telemetry": "off"})
    telemetry.reset()


@pytest.fixture
def armed():
    """A metrics-armed world with one ephemeral-port server."""
    set_flags({"telemetry": "metrics"})
    telemetry.reset()
    srv = ops_server.OpsServer(port=0)
    yield srv, telemetry.registry()
    srv.close()
    ops_server.stop()
    set_flags({"telemetry": "off"})
    telemetry.reset()


def _get(srv, path):
    return urllib.request.urlopen(srv.url + path, timeout=10)


def _body(srv, path) -> bytes:
    with _get(srv, path) as resp:
        return resp.read()


class TestArming:
    def test_refuses_to_start_when_telemetry_off(self, tel_off):
        with pytest.raises(RuntimeError, match="refuses to start"):
            ops_server.OpsServer(port=0)

    def test_maybe_start_disabled_by_default_flag(self, tel_off):
        set_flags({"telemetry": "metrics"})
        # FLAGS_ops_server_port defaults to 0: nothing starts
        assert ops_server.maybe_start() is None
        assert ops_server.server() is None

    def test_maybe_start_none_when_telemetry_off(self, tel_off):
        # even with a port, a disarmed plane gets no server
        assert ops_server.maybe_start(port=18123) is None

    def test_maybe_start_is_a_singleton(self, tel_off):
        set_flags({"telemetry": "metrics"})
        telemetry.reset()
        srv = ops_server.maybe_start(port=0)
        # port=0 explicit means ephemeral: a server exists
        assert srv is not None and srv.port > 0
        assert ops_server.maybe_start(port=0) is srv
        assert ops_server.server() is srv
        ops_server.stop()
        assert ops_server.server() is None


class TestMetricsEndpoint:
    def test_byte_identical_to_prometheus_text(self, armed):
        srv, reg = armed
        reg.inc("serving.steps", 7)
        reg.inc("serving.generated_tokens", 31)
        reg.gauge("pool.utilization", 0.25)
        for i in range(10):
            reg.observe("serving.ttft_s", 0.01 * (i + 1))
        body = _body(srv, "/metrics")
        assert body == telemetry.prometheus_text(
            registry=reg).encode("utf-8")
        assert b"paddle_serving_steps 7" in body

    def test_exemplars_ride_the_scrape(self, armed):
        srv, reg = armed
        reg.observe("serving.ttft_s", 0.25, exemplar="t-1f")
        body = _body(srv, "/metrics").decode()
        assert '# {trace_id="t-1f"} 0.25' in body
        # still byte-identical: one renderer, two transports
        assert body == telemetry.prometheus_text(registry=reg)


class TestStatusz:
    def test_basics(self, armed):
        srv, reg = armed
        reg.inc("serving.steps", 3)
        reg.gauge("serving.goodput", 0.75)
        text = _body(srv, "/statusz").decode()
        assert "paddle-tpu-torch statusz" in text
        assert "build        paddle_tpu_torch" in text
        assert "telemetry    metrics" in text
        assert "uptime_s" in text
        assert "goodput" in text

    def test_scheduler_provider_is_weakref(self, armed):
        srv, reg = armed

        class _Sched:
            def info(self):
                return {"steps": 5, "active": 1}

        sched = _Sched()
        srv.add_status_provider("scheduler.s1", sched.info)
        text = _body(srv, "/statusz").decode()
        assert "scheduler.s1" in text and '"steps": 5' in text
        del sched
        gc.collect()
        text = _body(srv, "/statusz").decode()
        # a dead scheduler silently leaves the page
        assert "scheduler.s1" not in text

    def test_broken_provider_never_500s(self, armed):
        srv, _ = armed
        srv.add_status_provider("bad", lambda: 1 / 0)
        with _get(srv, "/statusz") as resp:
            assert resp.status == 200
        assert "error" in _body(srv, "/statusz").decode()


class TestTracez:
    def test_table_and_chrome_payload(self, tel_off):
        set_flags({"telemetry": "trace"})
        telemetry.reset()
        tr = telemetry.tracer()
        ctx = telemetry.TraceContext()
        with telemetry.span_in(tr, ctx, "serving.step"):
            with telemetry.span_in(tr, ctx, "serving.admit",
                                   admitted=1):
                pass
        srv = ops_server.OpsServer(port=0)
        try:
            text = _body(srv, "/tracez").decode()
            assert "serving.step/serving.admit" in text
            assert ctx.trace_id[:13] in text
            chrome = json.loads(_body(srv, "/tracez?format=chrome"))
            names = {e["name"] for e in chrome["traceEvents"]}
            assert {"serving.step", "serving.admit"} <= names
            admit = [e for e in chrome["traceEvents"]
                     if e["name"] == "serving.admit"][0]
            assert admit["args"]["trace_id"] == ctx.trace_id
        finally:
            srv.close()

    def test_no_tracer_message_in_metrics_mode(self, armed):
        srv, _ = armed
        assert b"no tracer is live" in _body(srv, "/tracez")


class TestPlanz:
    def test_ledger_rows_and_plans(self, armed):
        srv, reg = armed
        from paddle_tpu_torch.framework import perf_ledger

        led = perf_ledger.ledger()
        led.register_plan("prog_a", {
            "flops_total": 2.0e9, "hbm_peak_bytes": 1e6,
            "input_bytes": 4e5, "donated_bytes": 0.0,
            "const_bytes": 0.0, "output_bytes": 1e5,
            "comm_bytes_total": 3e4, "comm_bytes_quantized": 1e4,
        })
        led.record("prog_a", 0.5)
        led.record("prog_a", 0.5)
        text = _body(srv, "/planz").decode()
        assert "prog_a" in text
        assert "registered plans (1)" in text
        assert "quantized=10000" in text
        data = json.loads(_body(srv, "/planz?format=json"))
        assert "prog_a" in data["plans"]
        row = data["rows"]["prog_a"]
        assert row["count"] == 2
        assert row["wire_bytes_quantized_per_s"] == pytest.approx(
            1e4 / 0.5)


class TestFlagz:
    def test_json_snapshot(self, armed):
        srv, _ = armed
        flags = json.loads(_body(srv, "/flagz"))
        assert flags["telemetry"] == "metrics"
        assert "ops_server_port" in flags


class TestIncidentz:
    @pytest.fixture
    def bundle_world(self, tmp_path, armed):
        srv, reg = armed
        set_flags({"telemetry_incident_dir": str(tmp_path)})
        try:
            rec = telemetry.FlightRecorder(registry=reg)
            path = rec.dump_incident(reason="manual-test")
            yield srv, path
        finally:
            set_flags({"telemetry_incident_dir": ""})

    def test_index_lists_bundles(self, bundle_world):
        srv, path = bundle_world
        text = _body(srv, "/incidentz").decode()
        name = path.rsplit("/", 1)[-1]
        assert name in text
        assert "manual-test" in text

    def test_bundle_replay_view(self, bundle_world):
        srv, path = bundle_world
        name = path.rsplit("/", 1)[-1]
        text = _body(srv, "/incidentz?bundle=" + name).decode()
        assert "incident bundle" in text
        assert "manual-test" in text
        assert "MISSING" not in text

    def test_traversal_guarded(self, bundle_world):
        srv, _ = bundle_world
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv, "/incidentz?bundle=..%2F..%2Fetc")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv, "/incidentz?bundle=incident-nope")
        assert e.value.code == 404

    def test_unconfigured_dir_message(self, armed):
        srv, _ = armed
        assert b"no incident directory" in _body(srv, "/incidentz")


class TestRouting:
    def test_unknown_endpoint_404_with_index(self, armed):
        srv, _ = armed
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv, "/nope")
        assert e.value.code == 404
        body = e.value.read().decode()
        assert "/metrics" in body and "/statusz" in body

    def test_index_page(self, armed):
        srv, _ = armed
        text = _body(srv, "/").decode()
        for ep in ("/metrics", "/statusz", "/tracez", "/planz",
                   "/flagz", "/incidentz"):
            assert ep in text

    @pytest.mark.parametrize("method", ["POST", "PUT", "DELETE",
                                        "PATCH"])
    def test_write_methods_rejected(self, armed, method):
        srv, _ = armed
        req = urllib.request.Request(srv.url + "/metrics",
                                     data=b"x", method=method)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        # read-only surface: GET only (the reference answers 501, the
        # http.server default for a method without a handler)
        assert e.value.code == 405



# ------------------------------------------------ against the JAX package
_EXEMPLAR = re.compile(r' # \{trace_id="[^"]*"\}')


@pytest.fixture
def both_armed(monkeypatch):
    for tel, flags, srv in ((telemetry, set_flags, ops_server),
                            (jax_telemetry, jax_set_flags,
                             jax_ops_server)):
        flags({"telemetry": "metrics"})
        tel.reset()
        srv.stop()
    monkeypatch.setattr(jax_serving, "_SCHED_SEQ", [0])
    monkeypatch.setattr(port_serving, "_SCHED_SEQ", [0])
    yield
    for tel, flags, srv in ((telemetry, set_flags, ops_server),
                            (jax_telemetry, jax_set_flags,
                             jax_ops_server)):
        srv.stop()
        flags({"telemetry": "off", "ops_server_port": 0})
        tel.reset()


def test_metrics_bodies_equal_after_lockstep(both_armed, monkeypatch):
    ts, js, ta, ev = overload._lockstep(
        overload._preempt_plan(False), monkeypatch, "auto", None,
        num_pages=16, max_batch_size=4)
    assert sum(e.get("preempted", 0) for e in ev) >= 2
    # one scrape of each package's registry through its own server
    bodies = []
    for mod in (ops_server, jax_ops_server):
        srv = mod.maybe_start(port=0)
        with urllib.request.urlopen(srv.url + "/metrics",
                                    timeout=10) as r:
            bodies.append(r.read().decode())
    tb, jb = bodies
    assert "paddle_serving_steps" in tb and "paddle_pool_" in tb
    assert _EXEMPLAR.sub("", tb) == _EXEMPLAR.sub("", jb)
    assert tb == telemetry.prometheus_text()


def test_scheduler_registers_statusz_in_both_packages(both_armed,
                                                      monkeypatch):
    for mod, flags in ((ops_server, set_flags),
                       (jax_ops_server, jax_set_flags)):
        srv = mod.maybe_start(port=0)
        flags({"ops_server_port": srv.port})
    ts, js, ta, ev = overload._lockstep(
        {0: [("submit", ("r0", overload._prompt(3, 9), 3))]},
        monkeypatch, "auto", None, num_pages=16)
    pages = []
    for mod in (ops_server, jax_ops_server):
        with urllib.request.urlopen(mod.server().url + "/statusz",
                                    timeout=10) as r:
            pages.append(r.read().decode())
    tp, jp = pages
    for page, sched in ((tp, ts), (jp, js)):
        assert "scheduler." + sched._sched_uid in page
    # the sections are the same dict in both packages
    sect = re.compile(r"scheduler\.s1\n(\{.*?\n\})", re.S)
    assert json.loads(sect.search(tp).group(1)) == \
        json.loads(sect.search(jp).group(1))
