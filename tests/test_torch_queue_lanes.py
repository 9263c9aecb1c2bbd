"""The port's batching queue (quantum_resistant_p2p_tpu_torch.provider.batched)
against the JAX package's ``OpQueue`` without a fallback, on the CPU.

Both queues get the same pure-Python batch function and the same
submissions (items and lanes from a numpy seed): the drain order under
mixed lanes, lane shedding, the stats keys, the ``queue.flush`` and
``device.dispatch`` spans, the cost ledger's occupancy and the futures of
an injected fault and a poisoned slot must come out the same.  Tolerance:
exact.  Then the port's own facades on the "cpu" backend: ``warmup()``,
the AEAD's scalar bypass, and the flight events of the health gate and
the operand cache.  No JAX program runs here.
"""

import asyncio
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu import faults as ref_faults
from quantum_resistant_p2p_tpu.obs import cost as ref_cost
from quantum_resistant_p2p_tpu.obs import trace as ref_trace
from quantum_resistant_p2p_tpu.provider import batched as ref_batched
from quantum_resistant_p2p_tpu_torch import faults
from quantum_resistant_p2p_tpu_torch.obs import cost, flight, metrics, trace
from quantum_resistant_p2p_tpu_torch.provider import (LANE_BULK, LANE_HANDSHAKE, LANE_REKEY,
                                                      BatchedAEAD, BatchedFused, BatchedKEM,
                                                      BatchedSignature, LaneShed, OpQueue,
                                                      facade_queues, get_batched_aead, get_fused,
                                                      get_kem, get_signature, get_symmetric,
                                                      health, init_pk_offset, resp_ct_offset)
from quantum_resistant_p2p_tpu_torch.provider import batched

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread: xdist workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tracers(monkeypatch):
    """A fresh tracer on each side, in place of the process tracer."""
    ours, theirs = trace.Tracer(), ref_trace.Tracer()
    monkeypatch.setattr(trace, "TRACER", ours)
    monkeypatch.setattr(ref_trace, "TRACER", theirs)
    return ours, theirs


def _recording_fn(log: list):
    def batch_fn(items):
        log.append(list(items))
        return [("out", x) for x in items]
    return batch_fn


def _lanes(seed: int, n: int) -> list[int]:
    return [int(x) for x in np.random.default_rng(seed).integers(0, 3, n)]


async def _submit_all(q, items, lanes):
    return await asyncio.gather(*(q.submit(it, lane) for it, lane in zip(items, lanes)),
                                return_exceptions=True)


def _run_both(make_args: dict, drive):
    """``drive(queue)`` on the port's queue and on the reference's; ->
    (port result, reference result)."""
    async def port():
        with ThreadPoolExecutor(1) as ex:
            q = OpQueue(make_args["batch_fn"][0], ex, make_args.get("max_batch", 4096),
                        make_args.get("max_wait_ms", 20.0), bucket_floor=make_args.get("floor", 1),
                        label=make_args.get("label", ""),
                        lane_capacity=make_args.get("lane_capacity"))
            return await drive(q), q

    async def ref():
        q = ref_batched.OpQueue(make_args["batch_fn"][1], make_args.get("max_batch", 4096),
                                make_args.get("max_wait_ms", 20.0), fallback_fn=None,
                                bucket_floor=make_args.get("floor", 1),
                                label=make_args.get("label", ""),
                                lane_capacity=make_args.get("lane_capacity"))
        return await drive(q), q

    return asyncio.run(port()), asyncio.run(ref())


def _outcome(r):
    return (type(r).__name__, str(r)) if isinstance(r, Exception) else r


@pytest.mark.parametrize("seed,n,max_batch", [(20, 40, 64), (21, 40, 8), (22, 9, 4),
                                              (23, 100, 16)])
def test_drain_order_under_mixed_lanes_matches(seed, n, max_batch):
    """Inputs: n items with lanes from seed; exact (each flush's items in
    order, each future's result)."""
    logs = ([], [])
    lanes = _lanes(seed, n)
    (ours, q), (theirs, rq) = _run_both(
        {"batch_fn": (_recording_fn(logs[0]), _recording_fn(logs[1])), "max_batch": max_batch},
        lambda q: _submit_all(q, list(range(n)), lanes))
    assert logs[0] == logs[1] and ours == theirs == [("out", i) for i in range(n)]
    for batch in logs[0]:
        assert [lanes[i] for i in batch] == sorted(lanes[i] for i in batch)
    assert q.stats.lane_ops == rq.stats.lane_ops and q._lane_pending == rq._lane_pending


def test_single_lane_drain_is_insertion_order():
    logs = ([], [])
    (ours, _), (theirs, _) = _run_both(
        {"batch_fn": (_recording_fn(logs[0]), _recording_fn(logs[1])), "max_batch": 5},
        lambda q: _submit_all(q, list(range(12)), [LANE_BULK] * 12))
    assert logs[0] == logs[1] == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11]]


@pytest.mark.parametrize("seed", [24, 25])
def test_lane_shed_at_the_same_depth_with_the_same_message(seed):
    """Inputs: 30 submissions' lanes from seed, capacities bulk 4 and
    handshake 6; exact (which op sheds, the LaneShed message and lane,
    the per-lane counts)."""
    lanes = _lanes(seed, 30)
    caps = {LANE_BULK: 4, LANE_HANDSHAKE: 6}
    (ours, q), (theirs, rq) = _run_both(
        {"batch_fn": (_recording_fn([]), _recording_fn([])), "lane_capacity": caps,
         "label": "ChaCha20-Poly1305.seal"},
        lambda q: _submit_all(q, list(range(30)), lanes))
    assert [_outcome(r) for r in ours] == [_outcome(r) for r in theirs]
    shed = [r for r in ours if isinstance(r, LaneShed)]
    assert len(shed) == sum(max(0, lanes.count(lane) - cap) for lane, cap in caps.items())
    assert {r.lane for r in shed} <= set(caps)
    assert str(shed[0]).startswith("queue ChaCha20-Poly1305.seal: ")
    assert q.stats.lane_sheds == rq.stats.lane_sheds
    assert q.stats.as_dict()["lane_sheds"] == rq.stats.as_dict()["lane_sheds"]
    assert q.stats.as_dict()["lanes"] == rq.stats.as_dict()["lanes"]


def test_stats_keys_match_the_reference_with_its_breaker():
    """Inputs: 20 submissions on lanes from seed 26; exact (the whole key
    set, the breaker's and the degrade path's included, and every value
    that is not a time)."""
    lanes = _lanes(26, 20)
    (_, q), (_, rq) = _run_both(
        {"batch_fn": (_recording_fn([]), _recording_fn([])), "max_batch": 8},
        lambda q: _submit_all(q, list(range(20)), lanes))
    ours, theirs = q.stats.as_dict(), rq.stats.as_dict()
    assert set(ours) == set(theirs)
    for key in ("ops", "flushes", "max_batch_seen", "avg_batch", "device_trips", "lanes",
                "lane_sheds", "fallback_ops", "fallback_flushes", "breaker_trips",
                "device_served_fraction"):
        assert ours[key] == theirs[key], key
    assert ours["device_served_fraction"] == 1.0 and ours["breaker_trips"] == 0
    assert q.stats.device_trips == q.stats.flushes == 3 and q.stats.total_wait_s > 0


def _span_view(records):
    """Span records without times, ids and thread names: (name, attrs,
    index of the parent record)."""
    index = {r["span_id"]: i for i, r in enumerate(records)}
    return sorted((r["name"], tuple(sorted((k, v) for k, v in r["attrs"].items()
                                           if k != "waited_ms")),
                   records[index[r["parent_id"]]]["name"] if r["parent_id"] in index else None)
                  for r in records)


@pytest.mark.parametrize("seed", [27, 28])
def test_flush_spans_match(tracers, seed):
    """Inputs: 24 submissions on lanes from seed, max_batch 8; exact (span
    names, attributes but the wait, and each device.dispatch's parent)."""
    lanes = _lanes(seed, 24)
    _run_both({"batch_fn": (_recording_fn([]), _recording_fn([])), "max_batch": 8,
               "label": "ML-KEM-768.enc"},
              lambda q: _submit_all(q, list(range(24)), lanes))
    ours, theirs = (t.snapshot() for t in tracers)
    assert _span_view(ours) == _span_view(theirs)
    flushes = [r for r in ours if r["name"] == "queue.flush"]
    dispatches = [r for r in ours if r["name"] == "device.dispatch"]
    assert len(flushes) == len(dispatches) == 3
    assert sorted(d["parent_id"] for d in dispatches) == sorted(f["span_id"] for f in flushes)
    assert all(d["attrs"]["route"] == "direct" and d["thread"] != "MainThread"
               for d in dispatches)
    assert all(f["attrs"]["waited_ms"] >= 0 and f["attrs"]["lane"] in ("rekey", "handshake",
                                                                         "bulk")
               for f in flushes)


def _faulted_drive(seed: int):
    """Three encaps flushes and two decaps flushes of 6 items each."""
    async def drive(queues):
        enc, dec = queues
        out = []
        for q, flushes in ((enc, 3), (dec, 2)):
            for f in range(flushes):
                out.append(await _submit_all(q, [(f, i) for i in range(6)],
                                             _lanes(seed + f, 6)))
        return out
    return drive


@pytest.mark.parametrize("seed", [29, 30, 31])
def test_injected_fault_and_poisoned_slot_futures_match(tracers, seed):
    """Inputs: the flushes' lanes and the plan seed from seed; the plan
    raises at the 2nd ``ML-KEM-768.enc`` dispatch and poisons one slot of
    the 1st ``ML-KEM-768.dec`` flush; exact (every future, the injection
    logs, the span errors)."""
    results = {}
    for side, (mod, make) in {
            "port": (faults, lambda fn, ex, label: OpQueue(fn, ex, 64, 20.0, label=label)),
            "ref": (ref_faults,
                    lambda fn, ex, label: ref_batched.OpQueue(fn, 64, 20.0, label=label))}.items():
        plan = mod.FaultPlan(seed, [
            mod.FaultRule("device.dispatch", "raise", match={"op": "ML-KEM-768.enc"}, nth=2),
            mod.FaultRule("device.dispatch", "poison", match={"op": "ML-KEM-768.dec"})])

        async def run():
            with ThreadPoolExecutor(1) as ex:
                queues = [make(_recording_fn([]), ex, f"ML-KEM-768.{op}") for op in ("enc", "dec")]
                with plan.activate():
                    return await _faulted_drive(seed)(queues)

        out = asyncio.run(run())
        results[side] = ([[_outcome(r) for r in flush] for flush in out], plan.injected)
    assert results["port"] == results["ref"]
    flushes, injected = results["port"]
    assert [e["action"] for e in injected] == ["raise", "poison"]
    assert all(r[0] == "FaultInjected" for r in flushes[1])
    assert [r[0] for r in flushes[3]].count("FaultInjected") == 1
    assert all(r[0] == "out" for i in (0, 2, 4) for r in flushes[i])
    errors = {t: sorted(r["name"] for r in tracer.snapshot() if r["attrs"].get("error"))
              for t, tracer in zip(("port", "ref"), tracers)}
    assert errors["port"] == errors["ref"] == ["device.dispatch", "queue.flush"]


@pytest.mark.parametrize("floor", [1, 4])
def test_cost_ledger_occupancy_and_device_seconds(floor):
    """Inputs: 21 submissions on lanes from seed 32, max_batch 8; exact
    (the occupancy rows against the reference's queue; the ledger's device
    seconds against the queue's own device histogram, both the same sums
    of the same timer reads)."""
    lanes = _lanes(32, 21)
    reg = metrics.Registry(name="lanes")
    ledgers = (cost.CostLedger(registry=reg), ref_cost.CostLedger())

    async def attach(q):
        q.cost = ledgers[0] if isinstance(q, OpQueue) else ledgers[1]
        return await _submit_all(q, list(range(21)), lanes)

    (_, q), _ = _run_both({"batch_fn": (_recording_fn([]), _recording_fn([])), "max_batch": 8,
                           "floor": floor, "label": "ML-KEM-768.enc"}, attach)
    ours, theirs = ledgers[0].snapshot(), ledgers[1].snapshot()
    assert ours["occupancy"] == theirs["occupancy"]
    assert ours["padding_waste_fraction"] == theirs["padding_waste_fraction"]
    assert reg.snapshot()["gauges"]['cost_device_seconds{op="enc"}'] == q.stats.device_hist.total
    assert ledgers[0].device_seconds_total() == q.stats.device_hist.total
    assert q.stats.device_hist.count == q.stats.flushes == 3


@pytest.fixture
def cpu_facades():
    kem = get_kem("ML-KEM-512", backend="cpu")
    dsa = get_signature("ML-DSA-44", backend="cpu")
    fused = get_fused(get_kem("ML-KEM-768", backend="cpu"),
                      get_signature("ML-DSA-65", backend="cpu"))
    aead = get_batched_aead("ChaCha20-Poly1305", backend="cpu")
    pk_off = init_pk_offset("ML-KEM-768", "ChaCha20-Poly1305")
    facades = (BatchedKEM(kem), BatchedSignature(dsa), BatchedFused(fused, pk_off, resp_ct_offset()),
               BatchedAEAD(aead, get_symmetric("ChaCha20-Poly1305")))
    yield facades
    for f in facades:
        f.close()


#: warm-up calls a queue takes for one size (KEM and ML-DSA with their
#: operand caches; the second size of 2 adds ML-DSA's mixed-key pair)
WARM_CALLS = {"ML-KEM-512": {"kg": 1, "enc": 3, "dec": 1},
              "ML-DSA-44": {"sign": 2, "verify": 2},
              "ML-KEM-768+ML-DSA-65": {"keygen_sign": 1, "encaps_verify_sign": 1,
                                       "decaps_verify_sign": 1},
              "ChaCha20-Poly1305": {"seal": 2, "open": 2}}


def test_warmup_on_the_cpu_facades(tracers, cpu_facades):
    """Sizes (1,) and for ML-KEM and the AEAD (1, 2): every queue's batch
    function runs at each bucket in a ``device.dispatch`` span of route
    "warmup"; each size is one compile event; no flush, trip or device
    seconds are counted; exact."""
    ledger = cost.CostLedger()
    sizes = {"ML-KEM-512": (1, 2), "ML-DSA-44": (1,), "ML-KEM-768+ML-DSA-65": (1,),
             "ChaCha20-Poly1305": (1, 2)}
    for facade in cpu_facades:
        facade.cost = ledger
        for q in facade_queues(facade):
            q.cost = ledger
        facade.warmup(sizes[facade.name])
    spans = tracers[0].snapshot()
    assert {s["attrs"]["route"] for s in spans} == {"warmup"}
    for facade in cpu_facades:
        want = {f"{facade.name}.{op}": calls * len(sizes[facade.name])
                for op, calls in WARM_CALLS[facade.name].items()}
        got = {q.label: sum(s["attrs"]["op"] == q.label for s in spans)
               for q in facade_queues(facade)}
        assert got == want
        assert [s["attrs"]["n"] for s in spans if s["attrs"]["op"] == facade._queues[0].label] \
            == [b for b in sizes[facade.name] for _ in range(WARM_CALLS[facade.name][
                facade._queues[0].label.rsplit(".", 1)[1]])]
        for q in facade_queues(facade):
            assert q.stats.flushes == q.stats.device_trips == q.stats.device_hist.count == 0
    snap = ledger.snapshot()
    assert ledger.device_seconds_total() == 0.0 and snap["occupancy"] == {}
    assert {k: v["events"] for k, v in snap["compiles"].items()} == {
        f"{f.name}[shard=all,warmup]": len(sizes[f.name]) for f in cpu_facades}
    assert [(e["queue"], e["bucket"]) for e in snap["recent_compiles"]] == [
        (f.name, b) for f in cpu_facades for b in sizes[f.name]]


def test_warmup_fault_kills_the_warmup(cpu_facades):
    """A "warmup" kill rule on the encaps queue fails ``warmup()`` with
    FaultInjected; no compile event is counted for it."""
    bk = cpu_facades[0]
    bk.cost = ledger = cost.CostLedger()
    plan = faults.FaultPlan(33, [faults.FaultRule("warmup", "kill",
                                                  match={"op": "ML-KEM-512.enc"})])
    with plan.activate(), pytest.raises(faults.FaultInjected, match="ML-KEM-512.enc"):
        bk.warmup()
    assert [e["op"] for e in plan.injected] == ["ML-KEM-512.enc"]
    assert ledger.compile_totals() == (0, 0.0)


def test_facade_lanes_and_labels(cpu_facades):
    """Labels as the reference spells them; the AEAD defaults to the bulk
    lane, the others to the handshake lane; a facade's lane_capacity
    reaches each of its queues."""
    bk, bs, bf, ba = cpu_facades
    assert [q.label for f in cpu_facades for q in facade_queues(f)] == [
        "ML-KEM-512.kg", "ML-KEM-512.enc", "ML-KEM-512.dec", "ML-DSA-44.sign",
        "ML-DSA-44.verify", "ML-KEM-768+ML-DSA-65.keygen_sign",
        "ML-KEM-768+ML-DSA-65.encaps_verify_sign", "ML-KEM-768+ML-DSA-65.decaps_verify_sign",
        "ChaCha20-Poly1305.seal", "ChaCha20-Poly1305.open"]
    key = bytes(range(32))

    async def run():
        pk, sk = await bk.generate_keypair(lane=LANE_REKEY)
        frames = await asyncio.gather(*(ba.encrypt(key, b"m%d" % i) for i in range(5)),
                                      ba.encrypt(key, b"hs", lane=LANE_HANDSHAKE))
        return pk, frames

    _, frames = asyncio.run(run())
    assert bk.stats()["keygen"]["lanes"] == {"rekey": 1}
    assert ba.stats()["seal"]["lanes"] == {"handshake": 1, "bulk": 5}
    scalar = get_symmetric("ChaCha20-Poly1305")
    assert [scalar.decrypt(key, f) for f in frames] == [b"m%d" % i for i in range(5)] + [b"hs"]
    with BatchedAEAD(ba.algo, lane_capacity={LANE_BULK: 2}) as capped:
        assert {q.lane_capacity[LANE_BULK] for q in facade_queues(capped)} == {2}

        async def flood():
            return await asyncio.gather(*(capped.encrypt(key, b"x") for _ in range(5)),
                                        capped.encrypt(key, b"y", lane=LANE_HANDSHAKE),
                                        return_exceptions=True)

        out = asyncio.run(flood())
    assert [type(r).__name__ for r in out] == ["bytes"] * 2 + ["LaneShed"] * 3 + ["bytes"]
    assert capped.stats()["seal"]["lane_sheds"] == {"bulk": 3}


def test_aead_oversize_items_bypass_the_queue(cpu_facades):
    """A message past the device's max_len goes to the scalar provider
    without enqueueing, counted as a bypass by the ledger; exact."""
    ba = cpu_facades[3]
    ba.cost = ledger = cost.CostLedger()
    for q in facade_queues(ba):
        q.cost = ledger
    key, big = bytes(range(32)), bytes(np.random.default_rng(34).integers(
        0, 256, ba.algo.max_len + 1, dtype=np.uint8))

    async def run():
        frame = await ba.encrypt(key, big, b"ad")
        small = await ba.encrypt(key, b"small", b"ad")
        return frame, await ba.decrypt(key, frame, b"ad"), await ba.decrypt(key, small, b"ad")

    frame, opened, small = asyncio.run(run())
    assert opened == big and small == b"small"
    assert get_symmetric("ChaCha20-Poly1305").decrypt(key, frame, b"ad") == big
    assert ledger.snapshot()["bypasses"] == {"ChaCha20-Poly1305.open[oversize]": 1,
                                             "ChaCha20-Poly1305.seal[oversize]": 1}
    assert ledger.device_served_fraction() == 0.5
    assert ba.stats()["seal"]["ops"] == ba.stats()["open"]["ops"] == 1


def test_health_verdicts_and_opcache_events_reach_the_flight_ring(monkeypatch, cpu_facades):
    """The health gate records each verdict, the operand cache its lookups
    (to an attached ledger) and its release; exact."""
    rec = flight.FlightRecorder()
    monkeypatch.setattr(flight, "RECORDER", rec)
    bk, _, _, ba = cpu_facades
    kem = bk.algo
    ledger = cost.CostLedger()
    kem.opcache.attach_cost(ledger, "kem")
    pk, _ = kem.generate_keypair()
    kem.encapsulate(pk)
    kem.encapsulate(pk)
    assert ledger.snapshot()["opcaches"]["kem"] == {"window": 2, "window_hit_rate": 0.5,
                                                    "hits": 1, "misses": 1}
    assert kem.opcache.zeroize() == 1
    health.gate_facades(ba, scalar=get_symmetric("ChaCha20-Poly1305"))
    ba.algo.seal_batch = lambda *a: [b"\x00" * 130]
    with pytest.raises(RuntimeError, match="device health"):
        health.gate_facades(ba)
    kinds = [(e["kind"], e.get("family"), e.get("entries")) for e in rec.snapshot()]
    assert kinds == [("opcache_zeroized", None, 1), ("health_ok", "aead:ChaCha20-Poly1305", None),
                     ("health_failed", "aead:ChaCha20-Poly1305", None)]


def test_facade_queues_lists_every_queue():
    with BatchedKEM(get_kem("ML-KEM-512", backend="cpu")) as bk:
        assert facade_queues(bk) == [bk._kg, bk._enc, bk._dec]
        assert all(q.hub is bk.breaker and q.breaker is bk.breaker and q.executor is None
                   for q in facade_queues(bk))
    assert batched.LANE_NAMES == ref_batched.LANE_NAMES
    assert (batched.LANE_REKEY, batched.LANE_HANDSHAKE, batched.LANE_BULK) == (
        ref_batched.LANE_REKEY, ref_batched.LANE_HANDSHAKE, ref_batched.LANE_BULK)
