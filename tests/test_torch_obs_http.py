"""The port's telemetry endpoints (quantum_resistant_p2p_tpu_torch.obs.http)
against the JAX package's ``obs/http.py``, on the CPU.

The same route table served by both servers answers with the same status,
content type and body bytes (200, 404, 405, 500, 503); the port engine's
documents have the reference engine's keys; and the reference's endpoint
suite (``tests/test_obs_http.py``: the goldens, the 404 and 405 answers,
bounded requests and responses, readiness on a breaker trip and during the
warm-up, scrapes advancing the SLO engine, off by default, an unbindable
port) runs against a port engine ("cpu" providers, batching on, no warm-up
thread).  Tolerance: exact.  Stdlib HTTP on 127.0.0.1, ephemeral ports; no
JAX program is compiled.
"""

from __future__ import annotations

import json
import socket
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from quantum_resistant_p2p_tpu.app import messaging as ref_msg
from quantum_resistant_p2p_tpu.net import p2p_node as ref_net
from quantum_resistant_p2p_tpu.obs import http as ref_http
from quantum_resistant_p2p_tpu_torch.app.messaging import SecureMessaging
from quantum_resistant_p2p_tpu_torch.net.p2p_node import P2PNode
from quantum_resistant_p2p_tpu_torch.obs import http
from quantum_resistant_p2p_tpu_torch.obs.http import (MAX_RESPONSE_BYTES, TelemetryServer,
                                                      env_port, json_route)
from quantum_resistant_p2p_tpu_torch.obs.metrics import PROMETHEUS_CONTENT_TYPE, prometheus_text


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mk_engine(monkeypatch, **kw):
    monkeypatch.setattr(SecureMessaging, "_spawn_warmup", lambda self, **k: None)
    node = P2PNode(node_id="httppeer", host="127.0.0.1", port=0)
    return SecureMessaging(node, backend="cpu", use_batching=True, sig_keypair=(b"p", b"s"),
                           symmetric=type("A", (), {"name": "X"})(), **kw)


@pytest.fixture
def engine(monkeypatch):
    m = _mk_engine(monkeypatch, telemetry_port=0)
    yield m
    m.close()


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _answer(port: int, path: str, method: str = "GET"):
    """(status, content type, body) of one request, errors included."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=b"x=1" if method != "GET" else None)
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


# -- the port against the reference ---------------------------------------------


def test_same_routes_answer_the_same_bytes_as_the_reference():
    doc = {"b": [1, 2.5, None], "a": "é", "n": {"z": True}}
    answers = {}
    for side, mod in (("port", http), ("ref", ref_http)):
        srv = mod.TelemetryServer({
            "/doc": mod.json_route(lambda: doc),
            "/ready": mod.json_route(lambda: {"ready": False},
                                     status_fn=lambda d: 200 if d["ready"] else 503),
            "/text": lambda: (200, "text/plain", b"plain\n"),
            "/big": lambda: (200, "application/json", b"x" * (MAX_RESPONSE_BYTES + 1)),
            "/boom": mod.json_route(lambda: 1 / 0),
        }).start()
        try:
            answers[side] = [_answer(srv.port, p) for p in
                             ("/doc", "/doc?x=1", "/ready", "/text", "/big", "/boom", "/nope")]
            answers[side].append(_answer(srv.port, "/doc", "POST"))
            answers[side].append(_answer(srv.port, "/doc", "DELETE"))
        finally:
            srv.stop()
    assert answers["port"] == answers["ref"]
    assert [a[0] for a in answers["port"]] == [200, 200, 503, 200, 503, 500, 404, 405, 405]
    assert (http.MAX_RESPONSE_BYTES, http.TELEMETRY_PORT_ENV, http.JSON_TYPE) == (
        ref_http.MAX_RESPONSE_BYTES, ref_http.TELEMETRY_PORT_ENV, ref_http.JSON_TYPE)


@pytest.mark.parametrize("raw, want", [(None, None), ("", None), ("0", 0), ("9100", 9100),
                                       (" 77 ", 77), ("nope", None)])
def test_env_port_parsing_matches(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("QRP2P_HTTP_PORT", raising=False)
    else:
        monkeypatch.setenv("QRP2P_HTTP_PORT", raw)
    assert env_port() == ref_http.env_port() == want


def test_engine_documents_have_the_reference_keys(monkeypatch, engine):
    """The port engine's /healthz, /readyz, /slo, /cost and metrics()
    documents carry the reference engine's keys (the port's "cpu" engine
    also fuses and its "cpu" providers keep operand caches, so it adds
    ``fused_queue``, ``kem_opcache`` and ``sig_opcache``)."""
    monkeypatch.setattr(ref_msg.SecureMessaging, "_spawn_warmup", lambda self, **k: None)
    ref = ref_msg.SecureMessaging(ref_net.P2PNode(node_id="httppeer", host="127.0.0.1", port=0),
                                  backend="cpu", use_batching=True, sig_keypair=(b"p", b"s"),
                                  symmetric=type("A", (), {"name": "X"})())
    assert set(engine.health_doc()) == set(ref.health_doc())
    assert engine.ready_status() == ref.ready_status()
    assert engine.slo.names() == ref.slo.names()
    assert set(engine.cost.snapshot()) == set(ref.cost.snapshot())
    assert set(engine.metrics()) - {"fused_queue", "kem_opcache", "sig_opcache"} == set(
        ref.metrics())
    assert set(engine.metrics()["gateway"]) == set(ref.metrics()["gateway"])
    assert set(engine.metrics()["resumption"]) == set(ref.metrics()["resumption"])
    assert set(engine.slo_report()) == set(ref.slo_report())


# -- mirrors of tests/test_obs_http.py -------------------------------------------


def test_endpoint_goldens(engine):
    port = engine.telemetry_port
    assert port and port > 0

    status, ctype, body = _get(port, "/healthz")
    doc = json.loads(body)
    assert status == 200 and ctype == "application/json"
    assert doc["ok"] is True and doc["node"] == "httppeer"
    assert doc["uptime_s"] >= 0

    status, ctype, body = _get(port, "/metrics")
    text = body.decode()
    assert status == 200 and ctype == PROMETHEUS_CONTENT_TYPE
    assert text.startswith("# HELP")
    for name in ("qrp2p_padding_waste_fraction", "qrp2p_cost_compile_events_total",
                 "qrp2p_device_seconds_per_1k_handshakes", "qrp2p_handshake_trips"):
        assert name in text

    snap = json.loads(_get(port, "/metrics.json")[2])
    assert snap["registry"].startswith("messaging:")
    assert "queues" in snap["collected"]

    slo = json.loads(_get(port, "/slo")[2])
    assert {s["name"] for s in slo["specs"]} >= {"handshake_p99"}
    assert slo["alerting"] == []

    cost = json.loads(_get(port, "/cost")[2])
    assert {"padding_waste_fraction", "occupancy", "compiles", "device_seconds_by_op",
            "opcaches", "tuner_journal_tail"} <= set(cost)

    assert "traceEvents" in json.loads(_get(port, "/trace")[2])


def test_http_metrics_shares_the_cli_serializer_path(engine):
    _, _, body = _get(engine.telemetry_port, "/metrics")
    schema_http = {line for line in body.decode().splitlines() if line.startswith("# ")}
    schema_cli = {line for line in prometheus_text(engine.registry).splitlines()
                  if line.startswith("# ")}
    assert schema_http == schema_cli


def test_unknown_path_is_404(engine):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(engine.telemetry_port, "/secrets")
    assert e.value.code == 404
    assert json.loads(e.value.read())["error"] == "unknown path"


@pytest.mark.parametrize("method", ["POST", "PUT", "DELETE", "PATCH"])
def test_write_verbs_rejected(engine, method):
    status, _, body = _answer(engine.telemetry_port, "/metrics", method)
    assert status == 405
    assert "read-only" in json.loads(body)["error"]


def test_oversized_request_line_bounded(engine):
    with socket.create_connection(("127.0.0.1", engine.telemetry_port), timeout=5) as s:
        s.sendall(b"GET /" + b"a" * 70_000 + b" HTTP/1.0\r\n\r\n")
        status_line = s.recv(4096).split(b"\r\n", 1)[0]
    assert b"414" in status_line
    assert _get(engine.telemetry_port, "/healthz")[0] == 200


def test_concurrent_scrapes(engine):
    port = engine.telemetry_port

    def scrape(_):
        status, _, body = _get(port, "/metrics")
        return status, b"qrp2p_padding_waste_fraction" in body

    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(scrape, range(16)))
    assert all(status == 200 and found for status, found in results)


def test_oversized_response_bounded():
    srv = TelemetryServer({
        "/big": lambda: (200, "application/json", b"x" * (MAX_RESPONSE_BYTES + 1)),
        "/boom": json_route(lambda: 1 / 0),
    }).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.port, "/big")
        assert e.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.port, "/boom")
        assert e.value.code == 500
        assert json.loads(e.value.read())["error"] == "handler failed"
    finally:
        srv.stop()


def test_readiness_flips_on_breaker_open(engine):
    port = engine.telemetry_port
    status, _, body = _get(port, "/readyz")
    assert status == 200 and json.loads(body)["ready"] is True
    engine._queue_breaker.trip()
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/readyz")
    assert e.value.code == 503
    doc = json.loads(e.value.read())
    assert doc["ready"] is False and doc["degraded"] == ["shard0"]
    assert _get(port, "/healthz")[0] == 200


def test_readiness_waits_for_warmup(monkeypatch):
    release = threading.Event()

    def slow_warm(self, **kw):
        t = threading.Thread(target=release.wait, daemon=True)
        t.start()
        self._warmup_thread = t

    monkeypatch.setattr(SecureMessaging, "_spawn_warmup", slow_warm)
    node = P2PNode(node_id="warmpeer", host="127.0.0.1", port=0)
    m = SecureMessaging(node, backend="cpu", use_batching=True, sig_keypair=(b"p", b"s"),
                        symmetric=type("A", (), {"name": "X"})(), telemetry_port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(m.telemetry_port, "/readyz")
        assert e.value.code == 503
        assert json.loads(e.value.read())["warm"] is False
        release.set()
        m._warmup_thread.join(timeout=5)
        status, _, body = _get(m.telemetry_port, "/readyz")
        assert status == 200 and json.loads(body)["ready"] is True
    finally:
        release.set()
        m.close()


def test_readiness_answers_503_while_draining(engine):
    engine.draining, engine.drain_reason = True, "roll"
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(engine.telemetry_port, "/readyz")
    assert e.value.code == 503
    doc = json.loads(e.value.read())
    assert (doc["draining"], doc["drain_reason"], doc["degraded"]) == (True, "roll", [])


def test_http_scrape_advances_slo_engine(engine):
    n0 = len(engine.slo._states["handshake_p99"].samples)
    text = _get(engine.telemetry_port, "/metrics")[2].decode()
    assert "qrp2p_slo_health_alerts_total" in text
    assert 'slo="handshake_p99"' in text
    assert len(engine.slo._states["handshake_p99"].samples) > n0
    snap = json.loads(_get(engine.telemetry_port, "/metrics.json")[2])
    assert snap["collected"]["slo_health"]["alerting_count"] == 0


def test_disabled_by_default_no_listener(monkeypatch):
    monkeypatch.delenv("QRP2P_HTTP_PORT", raising=False)
    m = _mk_engine(monkeypatch)
    assert m.telemetry is None and m.telemetry_port is None
    assert not [t for t in threading.enumerate() if t.name == "qrp2p-telemetry"]
    m2 = _mk_engine(monkeypatch, telemetry_port=0)
    try:
        assert set(m.metrics()) == set(m2.metrics())
        assert m.slo.names() == m2.slo.names()
        assert set(m.cost.snapshot()) == set(m2.cost.snapshot())
    finally:
        m2.close()
    m.stop_telemetry()  # idempotent no-op when disabled
    m.close()


def test_env_port_starts_the_listener(monkeypatch):
    monkeypatch.setenv("QRP2P_HTTP_PORT", "0")
    m = _mk_engine(monkeypatch)
    try:
        assert m.telemetry_port and _get(m.telemetry_port, "/healthz")[0] == 200
    finally:
        m.close()


def test_unbindable_port_degrades_instead_of_crashing(monkeypatch, caplog):
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    port = taken.getsockname()[1]
    try:
        with caplog.at_level("WARNING"):
            m = _mk_engine(monkeypatch, telemetry_port=port)
        assert m.telemetry is None and m.telemetry_port is None
        assert any("telemetry endpoints disabled" in r.message for r in caplog.records)
        m.close()
    finally:
        taken.close()


def test_stop_telemetry_closes_the_listener(monkeypatch):
    m = _mk_engine(monkeypatch, telemetry_port=0)
    port = m.telemetry_port
    m.stop_telemetry()
    assert m.telemetry is None
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
    m.close()
