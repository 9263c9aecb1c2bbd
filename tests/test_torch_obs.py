"""The port's observability layer (quantum_resistant_p2p_tpu_torch.obs)
against the JAX package's (quantum_resistant_p2p_tpu.obs), on the CPU.

Both are stdlib code, so the same inputs, made from a numpy seed, go
through each side's function and the outputs are compared whole: redaction
verdicts, registry snapshots and Prometheus text, span records and their
Chrome trace under an injected clock, flight-recorder rings and dumps,
cost-ledger totals and snapshots, SLO verdicts.  Tolerance: exact (equal
objects, equal bytes).  Neither side imports jax here.
"""

import json
import threading

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.obs import cost as ref_cost
from quantum_resistant_p2p_tpu.obs import flight as ref_flight
from quantum_resistant_p2p_tpu.obs import metrics as ref_metrics
from quantum_resistant_p2p_tpu.obs import redaction as ref_redaction
from quantum_resistant_p2p_tpu.obs import slo as ref_slo
from quantum_resistant_p2p_tpu.obs import trace as ref_trace
from quantum_resistant_p2p_tpu_torch.obs import cost, flight, metrics, redaction, slo, trace

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread (the device_trace test's operators): xdist
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: name fragments the random field names are made of
TOKENS = ("key", "sk", "pk", "public", "secret", "shared", "entry", "verify", "test",
          "password", "stek", "skey", "pub", "master", "id", "nonce", "index", "log",
          "private", "keypair", "passwd", "peer", "op", "n", "KEY", "Secret", "ok")


def _names(seed: int, count: int) -> list[str]:
    rng = np.random.default_rng(seed)
    seps = ("_", "", "-")
    return [seps[rng.integers(3)].join(TOKENS[i] for i in rng.integers(0, len(TOKENS),
                                                                     rng.integers(1, 4)))
            for _ in range(count)]


def _fields(seed: int) -> dict:
    """A flight event's fields: secret-named and public names over bytes,
    long and short strings, numbers, None and nested containers."""
    rng = np.random.default_rng(seed)
    names = _names(seed + 1, 12)
    values = [bytes(rng.integers(0, 256, 40, dtype=np.uint8)), "x" * int(rng.integers(200, 300)),
              "short", int(rng.integers(1 << 40)), float(rng.random()), None, True,
              {"inner_key": b"\x01\x02", "n": 3, "deep": {"a": {"b": {"c": {"d": 1}}}}},
              [b"ab", "cd", 5], (1, 2), object(), {"sk": "s3cret", "pk": "pub"}]
    return dict(zip(names, values))


class _Clock:
    """Injected clock: each read advances by the next step of a seeded walk."""

    def __init__(self, seed: int, start: float = 0.0):
        self.steps = iter(np.random.default_rng(seed).random(10_000) * 0.01)
        self.t = start

    def __call__(self) -> float:
        self.t += float(next(self.steps))
        return self.t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_redaction_verdicts_match(seed):
    """Inputs: 300 names from seed; exact."""
    names = _names(seed, 300) + ["", None, "key", "public_key", "verify_key", "pk_sk"]
    assert [redaction.is_secret_name(n) for n in names] == \
        [ref_redaction.is_secret_name(n) for n in names]
    assert redaction.SECRET_NAME_RE.pattern == ref_redaction.SECRET_NAME_RE.pattern
    assert redaction.NONSECRET_NAME_RE.pattern == ref_redaction.NONSECRET_NAME_RE.pattern


@pytest.mark.parametrize("seed", [3, 4])
def test_flight_redact_value_matches(seed):
    """Inputs: one event's fields from seed; exact."""
    fields = _fields(seed)
    for name, value in fields.items():
        assert flight.redact_value(name, value) == ref_flight.redact_value(name, value)


def _drive_registry(mod, seed: int):
    rng = np.random.default_rng(seed)
    reg = mod.Registry(name=f"reg{seed}")
    c = reg.counter("flushes", "flushes done")
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat", "latency", buckets=(0.001, 0.01, 0.1, 1.0))
    t = reg.histogram("trips")
    for v in rng.integers(1, 9, 20):
        c.inc(int(v))
        c.labels(queue="enc", lane="bulk").inc(int(v) % 3)
    g.set(float(rng.random()))
    g.labels(queue="dec").inc(2.5)
    g.labels(queue="dec").dec(0.5)
    reg.gauge("lazy").set_fn(lambda: 7)
    reg.gauge("broken").set_fn(lambda: 1 / 0)
    for v in rng.exponential(0.05, 200):
        h.record(float(v))
        h.labels(op="sign").record(float(v) * 2)
    for v in rng.integers(1, 6, 50):
        t.record(float(v))
    reg.register_collector("queue", lambda: {"ops": 12, "lanes": {"bulk": 3}, "name": "q",
                                            "ratio": 0.25, "flag": True})
    reg.register_collector("bad", lambda: 1 / 0)
    lh = mod.LatencyHistogram(cap=64)
    for v in rng.random(100):
        lh.record(float(v))
    with pytest.raises(TypeError):
        reg.counter("depth")
    with pytest.raises(TypeError):
        reg.histogram("lat", buckets=(1.0,))
    return (reg.snapshot(), reg.to_prometheus(), mod.prometheus_text(reg, "x"),
            lh.summary(), [h.percentile(p) for p in (0, 50, 99, 100)], h.bucket_counts())


@pytest.mark.parametrize("seed", [5, 6])
def test_metrics_registry_json_and_prometheus_match(seed):
    """Inputs: counter, gauge and histogram records from seed; exact."""
    ours, theirs = _drive_registry(metrics, seed), _drive_registry(ref_metrics, seed)
    assert ours == theirs
    json.dumps(ours[0])  # the snapshot is JSON, the crashing gauge None, not NaN


def _drive_tracer(mod, seed: int):
    tr = mod.Tracer(clock=_Clock(seed))
    rng = np.random.default_rng(seed)
    with tr.span("handshake", peer="p1") as outer:
        for i in range(int(rng.integers(2, 5))):
            with tr.span("queue.flush", op="ML-KEM-768.enc", n=int(rng.integers(1, 99))):
                parent = mod.current()
                with tr.span("device.dispatch", parent=parent, route="direct"):
                    pass
        outer.set_attr("ok", True)
        with mod.node_scope("node-a"):
            with tr.span("send"):
                wire = mod.wire_context(run="bench-1", bad="x" * 99)
    with pytest.raises(KeyError):
        with tr.span("failing"):
            raise KeyError("x")
    adopted = mod.adopt_wire_context(wire)
    with tr.span("remote-child", parent=adopted):
        pass
    recs = tr.snapshot()
    dump = mod.span_dump(node="n1", tracer=tr)
    return recs, mod.to_chrome_trace(recs), wire, {k: dump[k] for k in ("format", "version",
                                                                        "node", "spans")}


@pytest.mark.parametrize("seed", [7, 8])
def test_tracer_spans_and_chrome_trace_match(seed):
    """Inputs: a span tree whose widths and clock steps come from seed;
    exact."""
    ours, theirs = _drive_tracer(trace, seed), _drive_tracer(ref_trace, seed)
    assert ours == theirs
    recs = ours[0]
    flushes = [r for r in recs if r["name"] == "queue.flush"]
    dispatches = [r for r in recs if r["name"] == "device.dispatch"]
    assert [d["parent_id"] for d in dispatches] == [f["span_id"] for f in flushes]
    json.loads(json.dumps(ours[1]))


def test_wire_context_validation_and_opt_out_match(monkeypatch):
    """Inputs: hostile and valid ``_trace`` fields from seed 9; exact."""
    rng = np.random.default_rng(9)
    alphabet = "abcXYZ09_.:-\n /$"
    ids = ["".join(alphabet[i] for i in rng.integers(0, len(alphabet), rng.integers(0, 70)))
           for _ in range(60)]
    cases = [{"trace_id": a, "span_id": b} for a, b in zip(ids[::2], ids[1::2])]
    cases += [None, "x", {"trace_id": 1, "span_id": "a"}, {"trace_id": "a"}, [],
              {"trace_id": "a" * 64, "span_id": "b"}, {"trace_id": "a" * 65, "span_id": "b"}]

    def adopt(mod):
        out = [mod.adopt_wire_context(c) for c in cases]
        return [(c.trace_id, c.span_id, c.node) if c is not None else None for c in out]

    assert adopt(trace) == adopt(ref_trace)
    monkeypatch.setenv("QRP2P_TRACE_PROPAGATE", "0")
    assert adopt(trace) == adopt(ref_trace) == [None] * len(cases)
    with trace.Tracer().span("x"):
        assert trace.wire_context() is None


def test_export_spans_writes_the_dump(tmp_path):
    tr = trace.Tracer(clock=_Clock(10))
    with tr.span("a", n=1):
        pass
    doc = trace.export_spans(tmp_path / "spans.json", node="n", tracer=tr)
    assert json.loads((tmp_path / "spans.json").read_text()) == doc
    assert doc["spans"] == tr.snapshot() and doc["format"] == ref_trace.SPAN_DUMP_FORMAT


def test_device_trace_refuses_a_missing_card_and_profiles_the_cpu(tmp_path):
    """``device="cuda"`` without a GPU raises (no CPU profile instead);
    ``device="cpu"`` writes a Chrome trace of the host's operators."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            with trace.device_trace(tmp_path):
                pass
    with pytest.raises(ValueError):
        with trace.device_trace(tmp_path, device="tpu"):
            pass
    with trace.device_trace(tmp_path, device="cpu") as path:
        torch.ones(64).add_(1).sum()
    events = json.loads(path.read_text())["traceEvents"]
    assert path.parent == tmp_path and any(e.get("name") == "aten::add_" for e in events)


def _drive_flight(mod, seed: int, directory):
    rec = mod.FlightRecorder(cap=8, clock=_Clock(seed, 1.7e9), mono=_Clock(seed + 1))
    for i in range(10):
        rec.record("event", i=i, **_fields(seed + i))
    rec.set_autodump(directory, min_interval_s=5.0, keep=2)
    for kind in ("fault_injected", "fault_injected", "slo_burn", "breaker/open"):
        rec.trigger(kind, seed=seed, private_key=b"k" * 32)
    bundle = rec.dump("manual", path=directory / "manual.json", registries={})
    return rec.snapshot(), bundle


def _dumps(directory) -> list:
    """The bundles in ``directory`` once every dump thread has finished."""
    for t in threading.enumerate():
        if t.name == "qrp2p-flight-dump":
            t.join(timeout=30)
            assert not t.is_alive()
    return sorted(directory.glob("flight_*.json"))


@pytest.mark.parametrize("seed", [11, 12])
def test_flight_ring_redaction_and_dumps_match(tmp_path, monkeypatch, seed):
    """Inputs: ten events' fields and both clocks from seed; exact (the
    rings, the manual bundle's bytes, the autodump file names)."""
    out = {}
    for side, mod in (("port", flight), ("ref", ref_flight)):
        # the dump embeds every live registry; keep both sides' empty
        monkeypatch.setattr(mod._metrics, "global_snapshot", lambda: {})
        (tmp_path / side).mkdir()
        out[side] = _drive_flight(mod, seed, tmp_path / side)
    assert out["port"] == out["ref"]
    ring = out["port"][0]
    assert len(ring) == 8 and all("k" * 32 not in json.dumps(e, default=str) for e in ring)
    assert (tmp_path / "port" / "manual.json").read_bytes() == \
        (tmp_path / "ref" / "manual.json").read_bytes()
    names = {side: [p.name for p in _dumps(tmp_path / side)] for side in ("port", "ref")}
    assert names["port"] == names["ref"] == ["flight_0002_slo_burn.json",
                                             "flight_0003_breaker_open.json"]


def test_flight_dir_env_arms_the_recorder(tmp_path, monkeypatch):
    monkeypatch.setenv("QRP2P_FLIGHT_DIR", str(tmp_path))
    rec = flight.FlightRecorder()
    rec.trigger("fault_injected", op="q")
    found = _dumps(tmp_path)
    bundle = json.loads(found[0].read_text())
    assert bundle["trigger"] == "fault_injected" and bundle["events"][-1]["op"] == "q"


def _drive_ledger(mod, metrics_mod, seed: int):
    rng = np.random.default_rng(seed)
    reg = metrics_mod.Registry(name=f"cost{seed}")
    led = mod.CostLedger(registry=reg, clock=_Clock(seed))
    led.set_handshakes_fn(lambda: 512)
    queues = ("ML-KEM-768.kg", "ML-KEM-768.enc", "ML-DSA-65.sign", "ChaCha20-Poly1305.seal")
    for _ in range(60):
        q = queues[rng.integers(len(queues))]
        kind = rng.integers(6)
        if kind == 0:
            real = int(rng.integers(1, 300))
            led.flush_occupancy(q, ("rekey", "handshake", "bulk")[rng.integers(3)], real,
                                1 << (real - 1).bit_length())
        elif kind == 1:
            led.bypass_items(q, "oversize", int(rng.integers(1, 3)))
        elif kind == 2:
            led.compile_event(q, int(1 << rng.integers(0, 12)), float(rng.random()),
                              where=("warmup", "in_flush")[rng.integers(2)],
                              shard=None if rng.random() < 0.5 else int(rng.integers(4)))
        elif kind == 3:
            led.device_time(q, float(rng.random()) * 1e-3)
        elif kind == 4:
            led.opcache_event(("kem", "sig")[rng.integers(2)], bool(rng.random() < 0.7))
        else:
            led.shard_device_time(int(rng.integers(4)), float(rng.random()))
            led.tuner_decision(q, float(rng.random()), {"p99": float(rng.random())},
                               int(1 << rng.integers(0, 12)), float(rng.random()) * 1e-2,
                               bool(rng.random() < 0.5), False)
    snap = led.snapshot()
    return (led.totals(), snap, led.journal(), led.compile_totals(),
            led.device_seconds_total(), led.padding_waste_fraction("ML-KEM-768.enc"),
            led.device_served_fraction(), led.opcache_hit_rate("kem"), reg.snapshot(),
            reg.to_prometheus())


@pytest.mark.parametrize("seed", [13, 14, 15])
def test_cost_ledger_totals_and_snapshot_match(seed):
    """Inputs: 60 ledger events (occupancy, bypasses, compiles, device
    time, opcache lookups, tuner decisions) from seed; exact."""
    assert _drive_ledger(cost, metrics, seed) == _drive_ledger(ref_cost, ref_metrics, seed)


def _drive_slo(mod, metrics_mod, seed: int):
    rng = np.random.default_rng(seed)
    now = [0.0]
    reg = metrics_mod.Registry(name=f"slo{seed}")
    hist = reg.histogram("handshake_s", buckets=(0.01, 0.05, 0.1, 0.5))
    good, bad = [0], [0]
    eng = mod.SLOEngine(registry=reg, clock=lambda: now[0], warn_interval_s=60.0)
    eng.add(mod.SLOSpec("handshake_p99", 0.99, mod.latency_probe(hist, 0.07),
                        "handshakes under 50 ms", fast_window_s=30.0, slow_window_s=120.0))
    eng.add(mod.SLOSpec("served", 0.9, mod.counter_pair_probe(lambda: good[0], lambda: bad[0]),
                        fast_burn=2.0, slow_burn=1.0, fast_window_s=10.0, slow_window_s=60.0))
    statuses = []
    for step in range(80):
        now[0] += float(rng.random()) * 5
        storm = 30 <= step < 55
        for v in rng.exponential(0.2 if storm else 0.01, 20):
            hist.record(float(v))
        good[0] += int(rng.integers(5, 20))
        bad[0] += int(rng.integers(5, 20)) if storm else int(rng.integers(0, 2))
        statuses.append(eng.status())
    reports = [{"node": f"n{i}", "slo": s} for i, s in enumerate(statuses[-3:])]
    return statuses, eng.probe_totals(), mod.merge_reports(reports), reg.snapshot()


@pytest.mark.parametrize("seed", [16, 17])
def test_slo_engine_verdicts_match(seed):
    """Inputs: 80 clock steps and the latency samples and counter deltas
    of a storm from seed; exact (every status, the merged report, the
    gauges)."""
    ours, theirs = _drive_slo(slo, metrics, seed), _drive_slo(ref_slo, ref_metrics, seed)
    assert ours == theirs
    assert any(s["alerting"] for s in ours[0]) and ours[0][-1]["alerts_total"] >= 1


def test_slo_spec_validation_matches():
    for args in ((0.0,), (1.0,), (0.9, 60.0, 30.0)):
        objective, *windows = args
        kw = dict(zip(("fast_window_s", "slow_window_s"), windows))
        for mod in (slo, ref_slo):
            with pytest.raises(ValueError):
                mod.SLOSpec("x", objective, lambda: (0, 0), **kw)
    hist = metrics.Histogram("h", buckets=(0.1, 1.0))
    with pytest.raises(ValueError, match="below the smallest"):
        slo.latency_probe(hist, 0.01)


def test_registries_and_listeners_are_thread_safe():
    """Eight threads hammer one counter, one histogram and one tracer under
    a short switch interval: no update is lost."""
    import sys

    reg = metrics.Registry(name="stress")
    c, h, tr = reg.counter("c"), reg.histogram("h"), trace.Tracer(cap=100_000)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                c.inc()
                h.record(0.001)
                with tr.span("s"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.value == h.count == len(tr.snapshot()) == 16_000
