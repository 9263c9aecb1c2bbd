"""The port's tooling (quantum_resistant_p2p_tpu_torch.utils.benchmarking and
quantum_resistant_p2p_tpu_torch.tools) against the JAX package's
``utils/benchmarking.py`` and the repo's ``tools/``, on the CPU.

* Mirrors over the port's modules: ``test_slo_merge_cli_merges_a_report_dir``
  (``tests/test_fleet.py``), ``test_merged_two_node_trace_has_process_lanes_
  and_flow_edges``, ``test_trace_merge_aligns_multi_process_dumps`` and
  ``test_storm_snapshot_digest_folds_per_peer_registries``
  (``tests/test_obs.py``), and ``test_storm_lite_chaos_zero_failures_and_
  reproducible`` (``tests/test_gateway.py``), with the same arguments and
  assertions.
* Parity on the same inputs: both ``slo_merge`` CLIs write the same JSON;
  both ``trace_merge`` tools give the same document; both
  ``snapshot_digest`` give the same digest; both ``qrtop`` scrapes of one
  port engine's telemetry server give the same row (but the two clock
  readings) and both renders the same frame; ``run_swarm`` reports the
  reference's keys; ``make_report`` gives the reference's report; the
  seeded storm-lite injects the same chaos in both packages.
* ``utils.benchmarking``: ``timeit`` leaves out the warm call and grows
  ``reps`` to ``min_time_s``; ``sync`` walks a nested tree.
* The settled divergences: "cuda" by default, "cpu" or "cuda" only;
  ``emulate`` raises; artifacts go under ``torch_results/``, never
  ``bench_results/``.

Tolerance: exact.  PyTorch runs on one thread; JAX's caches are cleared at
the module's end if JAX was loaded (ROADMAP C1).  Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import hashlib
import hmac
import itertools
import json
import os
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.app import messaging as ref_messaging
from quantum_resistant_p2p_tpu.faults import FaultRule as RefFaultRule
from quantum_resistant_p2p_tpu.fleet import stormlib as ref_stormlib
from quantum_resistant_p2p_tpu.provider import registry as ref_registry
from quantum_resistant_p2p_tpu_torch.app import messaging as messaging_mod
from quantum_resistant_p2p_tpu_torch.app.messaging import SecureMessaging
from quantum_resistant_p2p_tpu_torch.faults import FaultRule
from quantum_resistant_p2p_tpu_torch.fleet import stormlib
from quantum_resistant_p2p_tpu_torch.net.p2p_node import P2PNode
from quantum_resistant_p2p_tpu_torch.obs import trace as obs_trace
from quantum_resistant_p2p_tpu_torch.obs.trace import Tracer
from quantum_resistant_p2p_tpu_torch.provider.base import (KeyExchangeAlgorithm,
                                                           SignatureAlgorithm,
                                                           SymmetricAlgorithm)
from quantum_resistant_p2p_tpu_torch.tools import (compat_matrix, qrtop, slo_merge,
                                                   swarm_bench, trace_merge)
from quantum_resistant_p2p_tpu_torch.utils import benchmarking
from tools import compat_matrix as ref_compat_matrix
from tools import qrtop as ref_qrtop
from tools import slo_merge as ref_slo_merge
from tools import swarm_bench as ref_swarm_bench
from tools import trace_merge as ref_trace_merge

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_release():
    """One PyTorch CPU thread (xdist workers share the cores); JAX's caches
    cleared at the end if anything loaded JAX (ROADMAP C1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _health_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("QRP2P_HEALTH_CACHE", str(tmp_path / "health"))


@pytest.fixture(autouse=True)
def _registries(monkeypatch):
    """The storm toys a storm registers leave both registries as they were:
    other test modules of the same process list them."""
    from quantum_resistant_p2p_tpu_torch.provider import registry

    for mod in (registry, ref_registry):
        for table in ("_KEMS", "_SIGS"):
            monkeypatch.setattr(mod, table, dict(getattr(mod, table)))
    for mod in (stormlib, ref_stormlib):
        monkeypatch.setattr(mod, "_STORM_REGISTERED", False)


@pytest.fixture
def run():
    loop = asyncio.new_event_loop()
    yield lambda coro, limit=120.0: loop.run_until_complete(asyncio.wait_for(coro, limit))
    loop.run_until_complete(loop.shutdown_asyncgens())
    loop.close()


# -- toys for the two-node trace (the reference suite's toy pair) -------------


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    out, ctr = b"", 0
    while len(out) < n:
        out += hashlib.sha256(key + nonce + ctr.to_bytes(8, "big")).digest()
        ctr += 1
    return out[:n]


def _rows(items) -> np.ndarray:
    return np.stack([np.frombuffer(b, np.uint8) for b in items])


class ToyAEAD(SymmetricAlgorithm):
    name = "PT-TOY-AEAD"
    display_name = "PT-TOY-AEAD"
    key_size = 32
    nonce_size = 16

    def encrypt(self, key, plaintext, associated_data=None):
        nonce = os.urandom(self.nonce_size)
        ct = bytes(a ^ b for a, b in zip(plaintext, _keystream(key, nonce, len(plaintext))))
        tag = hmac.new(key, nonce + ct + (associated_data or b""), hashlib.sha256).digest()
        return nonce + ct + tag

    def decrypt(self, key, data, associated_data=None):
        nonce, ct, tag = data[: self.nonce_size], data[self.nonce_size:-32], data[-32:]
        want = hmac.new(key, nonce + ct + (associated_data or b""), hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise ValueError("authentication failed")
        return bytes(a ^ b for a, b in zip(ct, _keystream(key, nonce, len(ct))))


class ToyKEM(KeyExchangeAlgorithm):
    name = "PT-TOY-KEM"
    public_key_len = secret_key_len = ciphertext_len = shared_secret_len = 32
    backend = "cpu"

    def generate_keypair_batch(self, n):
        sks = [os.urandom(32) for _ in range(n)]
        return _rows(hashlib.sha256(b"pk" + sk).digest() for sk in sks), _rows(sks)

    def encapsulate_batch(self, public_keys):
        cts = [os.urandom(32) for _ in public_keys]
        return _rows(cts), _rows(hashlib.sha256(bytes(pk) + ct).digest()
                                 for pk, ct in zip(public_keys, cts))

    def decapsulate_batch(self, secret_keys, ciphertexts):
        return _rows(hashlib.sha256(hashlib.sha256(b"pk" + bytes(sk)).digest() + bytes(ct))
                     .digest() for sk, ct in zip(secret_keys, ciphertexts))


class ToySig(SignatureAlgorithm):
    name = "PT-TOY-SIG"
    public_key_len = secret_key_len = signature_len = 32
    backend = "cpu"

    def generate_keypair(self):
        sk = os.urandom(32)
        return hashlib.sha256(b"pk" + sk).digest(), sk

    def sign(self, secret_key, message):
        pk = hashlib.sha256(b"pk" + secret_key).digest()
        return hashlib.sha256(b"sig" + pk + message).digest()

    def verify(self, public_key, message, signature):
        return hmac.compare_digest(signature,
                                   hashlib.sha256(b"sig" + public_key + message).digest())


async def _toy_pair(b_kw=None):
    a_node = P2PNode(node_id="alice", host="127.0.0.1", port=0)
    b_node = P2PNode(node_id="bob", host="127.0.0.1", port=0)
    await a_node.start()
    await b_node.start()
    kw = dict(kem=ToyKEM(), signature=ToySig(), symmetric=ToyAEAD(), backend="cpu")
    a = SecureMessaging(a_node, **kw)
    b = SecureMessaging(b_node, **kw, **(b_kw or {}))
    assert await a_node.connect_to_peer("127.0.0.1", b_node.port) == "bob"
    for _ in range(100):
        if b_node.is_connected("alice"):
            break
        await asyncio.sleep(0.01)
    return a, b


async def _handshake_spans(a, b, *needed):
    """Run one a->b handshake and snapshot spans once ``needed`` names
    have all been recorded (the responder's tail work is async)."""
    obs_trace.TRACER.reset()
    assert await a.initiate_key_exchange("bob")
    spans = []
    for _ in range(200):
        spans = obs_trace.TRACER.snapshot()
        if all(any(s["name"] == n for s in spans) for n in needed):
            break
        await asyncio.sleep(0.01)
    await a.node.stop()
    await b.node.stop()
    a.close()
    b.close()
    return spans


def _fake_clock(step: float = 1.0):
    counter = itertools.count()
    return lambda: next(counter) * step


# -- slo_merge ------------------------------------------------------------------


def _node_report(node, good, bad, burn_fast, alerting=False):
    return {
        "node": node,
        "slo": {"specs": [{
            "name": "handshake_p99", "objective": 0.99,
            "good_total": good, "bad_total": bad,
            "burn_fast": burn_fast, "alerting": alerting,
        }]},
    }


def test_slo_merge_cli_merges_a_report_dir(tmp_path, capsys):
    for i in range(2):
        (tmp_path / f"gw{i}_slo_report.json").write_text(
            json.dumps(_node_report(f"gw{i}", 10.0 * (i + 1), float(i), 0.1)))
    out = tmp_path / "fleet.json"
    assert slo_merge.main([str(tmp_path), "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["nodes"] == ["gw0", "gw1"]
    assert doc["slos"]["handshake_p99"]["good_total"] == 30.0
    assert "2 node report(s)" in capsys.readouterr().out


def test_slo_merge_cli_writes_the_references_json(tmp_path, capsys):
    """Both CLIs over one report directory (made with numpy from a seed):
    the same merged JSON, byte for byte, and the same summary line."""
    rng = np.random.default_rng(20)
    reports = tmp_path / "reports"
    reports.mkdir()
    for i in range(4):
        good, bad = (float(x) for x in rng.integers(0, 500, 2))
        (reports / f"gw{i}_slo_report.json").write_text(json.dumps(_node_report(
            f"gw{i}", good, bad, float(rng.uniform(0, 30)), alerting=bool(i % 2))))
    lines = []
    for name, mod in (("mine", slo_merge), ("ref", ref_slo_merge)):
        assert mod.main([str(reports), "--out", str(tmp_path / f"{name}.json")]) == 0
        lines.append(capsys.readouterr().out.replace(str(tmp_path / name), "OUT"))
    assert (tmp_path / "mine.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert lines[0] == lines[1]
    (tmp_path / "empty").mkdir()
    for mod in (slo_merge, ref_slo_merge):
        assert mod.main([str(tmp_path / "empty"), "--out", str(tmp_path / "x.json")]) == 2


# -- trace_merge ----------------------------------------------------------------


def test_merged_two_node_trace_has_process_lanes_and_flow_edges(run, monkeypatch):
    """The merged chrome document shows both nodes as separate process lanes
    under a single trace id, with cross-node flow arrows on the propagated
    parent edges; the reference's tool merges the same dump identically."""
    monkeypatch.setattr(messaging_mod, "KEY_EXCHANGE_TIMEOUT", 10.0)

    async def main():
        a, b = await _toy_pair()
        return await _handshake_spans(
            a, b, "handshake.initiate", "handshake.respond",
            "handshake.confirm")

    spans = run(main())
    dump = obs_trace.span_dump(records=spans)
    doc = trace_merge.merge([dump])
    other = doc["otherData"]
    assert {"alice", "bob"} <= set(other["merged_nodes"])
    assert other["cross_node_edges"] >= 2  # ke_init + at least one reply
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    procs = {e["name"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert procs  # process_name metadata present
    pid_by_node = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "M" and e["name"] == "process_name":
            pid_by_node[e["args"]["name"]] = e["pid"]
    hs = {e["name"]: e for e in xs if e["name"].startswith("handshake.")}
    assert hs["handshake.initiate"]["pid"] == pid_by_node["alice"]
    assert hs["handshake.respond"]["pid"] == pid_by_node["bob"]
    assert (hs["handshake.respond"]["args"]["trace_id"]
            == hs["handshake.initiate"]["args"]["trace_id"])
    flows = [e for e in doc["traceEvents"] if e.get("ph") in ("s", "f")]
    assert flows and len(flows) == 2 * other["cross_node_edges"]
    # loadable JSON round-trip
    json.loads(json.dumps(doc))
    assert ref_trace_merge.merge([dump]) == doc


def _two_process_dumps(tmp_path) -> list[Path]:
    ta = Tracer(clock=_fake_clock(0.5), tag="aaaa")
    with obs_trace.node_scope("alice"), ta.span("net.send"):
        wire = obs_trace.wire_context()
    da = obs_trace.span_dump(node="alice", tracer=ta)
    da["wall_anchor"], da["mono_anchor"] = 1000.0, da["mono_anchor"]

    tb = Tracer(clock=_fake_clock(0.5), tag="bbbb")
    parent = obs_trace.adopt_wire_context(wire)
    with obs_trace.node_scope("bob"), tb.span("net.recv", parent=parent):
        pass
    db = obs_trace.span_dump(node="bob", tracer=tb)
    db["wall_anchor"], db["mono_anchor"] = 1002.0, db["mono_anchor"]

    (tmp_path / "a.json").write_text(json.dumps(da))
    (tmp_path / "b.json").write_text(json.dumps(db))
    return [tmp_path / "a.json", tmp_path / "b.json"]


def test_trace_merge_aligns_multi_process_dumps(tmp_path):
    """Dumps from different processes (distinct clock epochs, distinct
    tracer tags) merge onto one timeline with parent edges intact."""
    doc = trace_merge.merge_files(_two_process_dumps(tmp_path))
    assert doc["otherData"]["merged_nodes"] == ["alice", "bob"]
    assert doc["otherData"]["cross_node_edges"] == 1
    xs = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    # bob's dump anchors 2 wall-seconds later: its span lands later on the
    # merged timeline even though both tracers' raw clocks started at ~0
    assert xs["net.recv"]["ts"] > xs["net.send"]["ts"]
    assert xs["net.recv"]["pid"] != xs["net.send"]["pid"]


def test_trace_merge_cli_gives_the_references_document(tmp_path, capsys):
    """Both CLIs over the same two-process dumps: the same document and the
    same summary line."""
    paths = [str(p) for p in _two_process_dumps(tmp_path)]
    lines = []
    for name, mod in (("mine", trace_merge), ("ref", ref_trace_merge)):
        assert mod.main(paths + ["--out", str(tmp_path / f"{name}.json")]) == 0
        lines.append(capsys.readouterr().out.replace(str(tmp_path / name), "OUT"))
    assert (json.loads((tmp_path / "mine.json").read_text())
            == json.loads((tmp_path / "ref.json").read_text()))
    assert lines[0] == lines[1]
    assert trace_merge.merge_files(paths) == ref_trace_merge.merge_files(paths)


# -- snapshot_digest ------------------------------------------------------------


def _reg(counters, gauges, hists):
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def test_storm_snapshot_digest_folds_per_peer_registries():
    """Registries group by class key, counters sum, gauges fold to
    min/mean/max, histograms merge to bucketless count/sum/p-ranges."""
    snap = {
        "messaging:peer00001": _reg(
            {"sent": 2}, {"outbox": 1.0},
            {"rtt": {"count": 4, "sum": 2.0, "p50": 0.4, "p99": 0.9}}),
        "messaging:peer00002#1": _reg(
            {"sent": 3}, {"outbox": 3.0},
            {"rtt": {"count": 6, "sum": 4.0, "p50": 0.6, "p99": 1.1}}),
        "router": _reg({"frames": 7}, {}, {}),
    }
    d = swarm_bench.snapshot_digest(snap)
    assert d["_digest"] == {"registries": 3,
                            "groups": {"messaging": 2, "router": 1}}
    m = d["messaging"]
    assert m["instances"] == 2
    assert m["counters"] == {"sent": 5}
    assert m["gauges"]["outbox"] == {"min": 1.0, "max": 3.0, "mean": 2.0}
    assert m["histograms"]["rtt"] == {"count": 10, "sum": 6.0,
                                      "p50_range": [0.4, 0.6],
                                      "p99_range": [0.9, 1.1]}
    assert d["router"]["counters"] == {"frames": 7}


def test_snapshot_digest_matches_the_reference():
    """One snapshot made with numpy from a seed (registries of three
    classes, null and non-numeric values among them): equal digests."""
    rng = np.random.default_rng(21)
    snap = {}
    for i in range(40):
        cls = ("messaging", "router", "gateway")[int(rng.integers(0, 3))]
        name = f"{cls}:peer{i:05d}" + (f"#{i}" if i % 7 == 0 else "")
        hists = {f"h{j}": {"count": int(rng.integers(0, 50)), "sum": float(rng.uniform(0, 9)),
                           "p50": (None if j == 1 else float(rng.uniform(0, 1))),
                           "p99": float(rng.uniform(1, 2))} for j in range(3)}
        snap[name] = _reg({"c0": int(rng.integers(0, 100)), "c1": float(rng.uniform(0, 5)),
                           "s": "text"},
                          {"g0": float(rng.uniform(-1, 1)), "g1": None}, hists)
    assert swarm_bench.snapshot_digest(snap) == ref_swarm_bench.snapshot_digest(snap)


# -- qrtop ----------------------------------------------------------------------


def test_qrtop_scrape_and_render_match_the_reference(run):
    """Both packages' ``scrape_gateway`` over one "cpu" port engine's
    telemetry server: the same row but the two clock readings (uptime, and
    the rate over it), and ``render`` gives the same frame for it."""

    async def main():
        a, b = await _toy_pair({"telemetry_port": 0})
        assert await a.initiate_key_exchange("bob")
        loop = asyncio.get_running_loop()
        base = f"127.0.0.1:{b.telemetry_port}"
        mine = await loop.run_in_executor(None, qrtop.scrape_gateway, "gw0", base)
        ref = await loop.run_in_executor(None, ref_qrtop.scrape_gateway, "gw0", base)
        dead = await loop.run_in_executor(None, qrtop.scrape_gateway, "gw9", "127.0.0.1:9")
        await a.node.stop()
        await b.node.stop()
        a.close()
        b.close()
        return mine, ref, dead

    mine, ref, dead = run(main())
    assert mine["reachable"] and mine["node"] == "bob" and mine["handshakes"] >= 1
    clocks = ("uptime_s", "hs_per_s")
    assert {k: v for k, v in mine.items() if k not in clocks} == \
        {k: v for k, v in ref.items() if k not in clocks}
    assert sorted(mine) == sorted(ref)
    assert dead == {"gateway": "gw9", "endpoint": "127.0.0.1:9", "reachable": False}
    rows = [mine, dead]
    prev = {"gw0": dict(mine, handshakes=0)}
    assert qrtop.render(rows, prev, 2.0) == ref_qrtop.render(rows, prev, 2.0)
    assert qrtop.render(rows, {}, 0.0) == ref_qrtop.render(rows, {}, 0.0)


# -- utils.benchmarking -----------------------------------------------------------


def test_timeit_excludes_the_warm_call_and_grows_reps(monkeypatch):
    """The first call is excluded; ``reps`` doubles (at least) until one
    trial lasts ``min_time_s``; the best trial's mean comes back."""
    clock = [0.0]
    monkeypatch.setattr(benchmarking, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))
    calls = []

    def fn(x):
        # the warm call costs 10 s on the fake clock, every later one 0.1 s
        clock[0] += 10.0 if not calls else 0.1
        calls.append(x)
        return torch.zeros(1)

    per_call = benchmarking.timeit(fn, 7, min_time_s=1.0, trials=3)
    assert calls[0] == 7 and set(calls) == {7}
    # reps 1 (0.1 s) -> max(2, 1 * 1.0 / 0.1 + 1 = 11) = 11 (1.1 s): one
    # trial of 1, then three of 11
    assert len(calls) == 1 + 1 + 3 * 11
    assert per_call == pytest.approx(0.1)


def test_sync_walks_a_nested_tree(monkeypatch):
    """Every tensor in nested lists, tuples and dicts is found; CPU tensors
    and other leaves need no synchronize."""
    synced = []
    monkeypatch.setattr(benchmarking.torch.cuda, "synchronize", synced.append)
    ts = [torch.full((2,), i) for i in range(4)]
    tree = [ts[0], {"a": (ts[1], [ts[2]]), "b": "text"}, (3.5, {"c": ts[3]}), None]
    assert list(benchmarking._leaves(tree)) == ts
    benchmarking.sync(tree)
    benchmarking.sync(ts[0])
    assert synced == []


# -- run_swarm, run_matrix ----------------------------------------------------------


def test_run_swarm_four_peers_on_the_cpu_reports_the_references_keys(run):
    """Four peers through the batching queues on "cpu": every handshake and
    message lands, every op served by the queues, and the report has the
    keys of the reference's swarm."""
    mine = run(swarm_bench.run_swarm(4, "cpu", True, 64, 2.0, 4, warmup=2), limit=300)
    assert mine["failures"] == 0 and mine["messages_received"] == 4
    assert mine["device_served_fraction"] == 1.0 and mine["backend"] == "cpu"
    ref = run(ref_swarm_bench.run_swarm(4, "cpu", True, 64, 2.0, 4, warmup=2), limit=300)
    assert ref["failures"] == 0
    assert sorted(mine) == sorted(ref)
    assert mine["aead"] == ref["aead"] == "AES-256-GCM"


def test_run_matrix_one_combination_on_the_cpu(run, tmp_path):
    report = run(compat_matrix.run_matrix(
        ["ML-KEM-512"], ["ChaCha20-Poly1305"], ["ML-DSA-44"], "cpu", tmp_path / "out",
        {"1KB": 1024}), limit=300)
    assert (report["total"], report["passed"], report["failed"]) == (1, 1, 0)
    (res,) = report["results"]
    assert res["key_exchange_ok"] and res["messaging_ok"] and res["error"] is None
    assert res["file_results"]["1KB"] > 0
    assert len(list((tmp_path / "out").glob("compat_report_*.json"))) == 1


def test_make_report_matches_the_reference(tmp_path, monkeypatch):
    """One list of results (each package's ComboResult, same fields): the
    same report, and the same text beside it."""
    monkeypatch.setattr(time, "strftime", lambda fmt: "20260101_000000")
    rows = [("ML-KEM-768", "ChaCha20-Poly1305", "ML-DSA-65", True, 0.25, {"10KB": 80.5}, None),
            ("HQC-128", "AES-256-GCM", "ML-DSA-44", True, 0.75, {"10KB": 40.0, "1MB": 20.0},
             None),
            ("FrodoKEM-640-SHAKE", "AES-256-GCM", "SPHINCS+-SHA2-128f-simple", False, 0.0,
             {}, "key exchange failed"),
            ("ML-KEM-512", "AES-256-GCM", "ML-DSA-87", True, 0.125, {"10KB": None},
             "file 10KB failed")]
    reports = []
    for name, mod in (("mine", compat_matrix), ("ref", ref_compat_matrix)):
        results = []
        for kem, aead, sig, ok, ke_s, files, err in rows:
            r = mod.ComboResult(kem, aead, sig, connected=True, key_exchange_ok=ok,
                                key_exchange_time=ke_s, messaging_ok=ok,
                                file_results=dict(files), error=err)
            results.append(r)
        reports.append(mod.make_report(results, tmp_path / name, "cpu"))
        assert [f.name for f in sorted((tmp_path / name).iterdir())] == [
            "compat_report_20260101_000000.json", "compat_report_20260101_000000.txt"]
    assert reports[0] == reports[1]
    assert (reports[0]["passed"], reports[0]["failed"]) == (2, 2)
    for ext in ("json", "txt"):
        assert ((tmp_path / "mine" / f"compat_report_20260101_000000.{ext}").read_text()
                == (tmp_path / "ref" / f"compat_report_20260101_000000.{ext}").read_text())
    assert [f.name for f in dataclasses.fields(compat_matrix.ComboResult)] == \
        [f.name for f in dataclasses.fields(ref_compat_matrix.ComboResult)]


# -- the storm-lite chaos mirror ------------------------------------------------------


def _storm_lite(seed: int, package: str = "port"):
    """The reference's ``_storm_lite`` (``tests/test_gateway.py``): 24
    sessions of 4 messages with a re-key after each, a handshake budget of
    16, two device kills and four net delays.  The port's engines run the
    toys on "cuda" and arm their "cpu" fallbacks (``degrade=True``), as the
    reference's always do on a device backend: the kills must degrade the
    plane, not fail the sessions."""
    rule = RefFaultRule if package == "ref" else FaultRule
    rules = [
        rule("device.dispatch", "raise", match={"op": "STORM-SIG"}, nth=8, times=2),
        rule("net.send", "delay", match={"msg_type": "ke_response"}, nth=3, times=4,
             delay_s=0.02),
    ]
    kw = dict(concurrency=24, msgs_per_session=4, rekey_every=1, churn_fraction=0.0, seed=seed,
              max_wait_ms=1.0, autotune=True, handshake_budget=16, ke_timeout=10.0,
              fault_rules=rules)
    if package == "ref":
        return asyncio.run(ref_swarm_bench.run_storm(24, **kw))
    return asyncio.run(swarm_bench.run_storm(24, degrade=True, **kw))


def test_storm_lite_chaos_zero_failures_and_reproducible(monkeypatch):
    monkeypatch.setenv("QRP2P_HEALTH_GATE", "0")
    monkeypatch.setattr(messaging_mod, "KE_RETRY_BACKOFF_S", 0.05)
    s1 = _storm_lite(31337)
    s2 = _storm_lite(31337)
    # chaos shed nothing it shouldn't: every handshake completed (the
    # breaker + retry machinery absorbed the kills; admission never let a
    # timeout through)
    assert s1["failures"] == 0 and s2["failures"] == 0
    # seeded reproducibility: the same rules fired, in full, both runs
    assert s1["chaos"]["injected"] == s2["chaos"]["injected"]
    assert ([(e["scope"], e["action"]) for e in s1["chaos"]["first_injected"]]
            == [(e["scope"], e["action"]) for e in s2["chaos"]["first_injected"]])
    assert s1["chaos"]["injected"] >= 2
    # the tuner saw the degraded plane (device kills -> fallback traffic):
    # at least one queue stepped while degraded or ended at the floor
    # minimum window
    tuners = {**s1["autotune_hub"]["queues"], **s1["autotune_clients"]["queues"]}
    assert any(t["degraded"] or (t["window_ms"] is not None
                                 and t["window_ms"] <= 0.5)
               for t in tuners.values()), tuners


def test_storm_lite_chaos_log_matches_the_reference(monkeypatch):
    """Seed 31337 through both packages: the same number of injected
    faults, and the same (scope, action) sequence in the first eight."""
    monkeypatch.setenv("QRP2P_HEALTH_GATE", "0")
    for mod in (messaging_mod, ref_messaging):
        monkeypatch.setattr(mod, "KE_RETRY_BACKOFF_S", 0.05)
    mine = _storm_lite(31337)
    ref = _storm_lite(31337, "ref")
    assert mine["chaos"]["injected"] == ref["chaos"]["injected"]
    assert ([(e["scope"], e["action"]) for e in mine["chaos"]["first_injected"]]
            == [(e["scope"], e["action"]) for e in ref["chaos"]["first_injected"]])
    assert mine["providers"] == ref["providers"]


# -- the settled divergences ------------------------------------------------------------


def test_backends_are_cuda_by_default_and_cpu_or_cuda_only(tmp_path):
    """Every tool takes "cuda" (the default) or "cpu"; "tpu" and "auto"
    raise; ``run_multichip`` has no ``emulate``."""
    with pytest.raises(ValueError, match="not supported"):
        asyncio.run(swarm_bench.run_swarm(1, "tpu", False, 64, 2.0, 1))
    with pytest.raises(ValueError, match="not supported"):
        asyncio.run(swarm_bench.run_storm(1, backend="auto"))
    with pytest.raises(ValueError, match="not supported"):
        compat_matrix.TestNode("n", tmp_path, "tpu")
    with pytest.raises(ValueError, match="emulate"):
        swarm_bench.run_multichip(emulate=8)
    import inspect

    assert inspect.signature(swarm_bench.run_storm).parameters["backend"].default == "cuda"
    assert inspect.signature(swarm_bench.run_storm).parameters["degrade"].default is False
    for mod in (swarm_bench, compat_matrix):
        with pytest.raises(SystemExit) as exc:
            mod.main(["--backend", "tpu"])
        assert exc.value.code == 2
    assert swarm_bench.RESULTS_DIR == compat_matrix.RESULTS_DIR == "torch_results"


def test_cuda_default_raises_without_a_gpu(monkeypatch):
    """With no GPU the default "cuda" run raises naming the device: there is
    no quiet fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        swarm_bench.main(["--peers", "1", "--warmup", "0", "--no-batch"])
    with pytest.raises(RuntimeError, match="GPU"):
        swarm_bench.run_multichip()


def test_tool_artifacts_go_under_torch_results(tmp_path, monkeypatch, capsys):
    """The CLIs' default artifact directory is ``torch_results/``: an
    ``--slo`` swarm and a matrix run on "cpu" from a fresh directory write
    there and nothing under ``bench_results/``."""
    monkeypatch.chdir(tmp_path)
    assert swarm_bench.main(["--slo", "--peers", "2", "--backend", "cpu", "--warmup", "0"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["failures"] == 0 and stats["obs"]["merged_trace_file"].startswith(
        "torch_results/")
    assert compat_matrix.main(["--backend", "cpu", "--kems", "ML-KEM-512", "--aeads",
                               "ChaCha20-Poly1305", "--sigs", "ML-DSA-44", "--quick"]) == 0
    written = sorted(p.name for p in (tmp_path / "torch_results").iterdir())
    assert {"swarm_trace_events.json", "swarm_merged_trace.json",
            "swarm_metrics_snapshot.json"} <= set(written)
    assert any(n.startswith("compat_report_") and n.endswith(".json") for n in written)
    assert not (tmp_path / "bench_results").exists()
