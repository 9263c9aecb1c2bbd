"""The port's breaker, scheduler and degrade path
(quantum_resistant_p2p_tpu_torch.provider.batched / .scheduler) against the
JAX package's, on the CPU.

The ``Breaker``'s transition log is held to the reference's under one
injected clock over seeded sequences of dispatch claims, outcomes, time
steps, trips and quarantines; the placement sequence of the
``DeviceProgramScheduler`` over seeded load patterns of 1-4 logical
shards; an ``OpQueue`` with a fallback under injected ``device.dispatch``
raises and delays (past ``degrade_after_ms`` and past the watchdog) gives
the same futures, stats and span names as the reference's queue (whose
buckets are marked warm: the port has no warm-bucket gating); and the
availability probe reads the same degraded seconds.  Tolerance: exact.
No JAX program runs here.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu import faults as ref_faults
from quantum_resistant_p2p_tpu.obs import flight as ref_flight
from quantum_resistant_p2p_tpu.obs import slo as ref_slo
from quantum_resistant_p2p_tpu.obs import trace as ref_trace
from quantum_resistant_p2p_tpu.provider import batched as ref_batched
from quantum_resistant_p2p_tpu.provider import opcache as ref_opcache
from quantum_resistant_p2p_tpu.provider import scheduler as ref_scheduler
from quantum_resistant_p2p_tpu_torch import faults
from quantum_resistant_p2p_tpu_torch.obs import cost, flight, metrics, slo, trace
from quantum_resistant_p2p_tpu_torch.provider import batched, opcache, scheduler

PORT = {"batched": batched, "scheduler": scheduler, "flight": flight, "trace": trace,
        "faults": faults, "slo": slo, "opcache": opcache}
REF = {"batched": ref_batched, "scheduler": ref_scheduler, "flight": ref_flight,
       "trace": ref_trace, "faults": ref_faults, "slo": ref_slo, "opcache": ref_opcache}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread: xdist workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def recorders(monkeypatch):
    """A fresh flight recorder on each side."""
    ours, theirs = flight.FlightRecorder(), ref_flight.FlightRecorder()
    monkeypatch.setattr(flight, "RECORDER", ours)
    monkeypatch.setattr(ref_flight, "RECORDER", theirs)
    return {"port": ours, "ref": theirs}


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _events(rec, kinds=("breaker_open", "breaker_quarantined", "breaker_transition",
                        "shard_rebalance")):
    return [{k: v for k, v in e.items() if k not in ("t", "mono", "seq", "thread")}
            for e in rec.snapshot() if e["kind"] in kinds]


def _breaker_walk(mod, seed: int, steps: int) -> list:
    """A seeded walk over the breaker's API; -> its observable state after
    every step."""
    rng = np.random.default_rng(seed)
    clock = Clock()
    b = mod.Breaker(cooloff_s=2.0, cooloff_max_s=9.0, clock=clock)
    b.label = "shard1" if seed % 2 else ""
    held = []
    log = []
    for step in range(steps):
        op = int(rng.integers(0, 100))
        if op < 35:
            claim = b.acquire_dispatch()
            if claim != "fallback":
                held.append(claim)
            out = claim
        elif op < 55 and held:
            claim = held.pop(0)
            b.record_success(claim)
            out = ("ok", claim)
        elif op < 75 and held:
            claim = held.pop(0)
            b.record_failure(claim)
            out = ("fail", claim)
        elif op < 80 and held:
            claim = held.pop(0)
            b.release(claim)
            out = ("release", claim)
        elif op < 83:
            b.trip()
            out = "trip"
        elif op < 84 and step >= steps - 50:  # quarantine ends the walk's story
            b.quarantine(f"bad verdict {seed}")
            out = "quarantine"
        else:
            clock.t += float(rng.choice([0.5, 1.0, 2.5, 5.0, 12.0]))
            out = ("tick", clock.t)
        log.append((out, b.state, b.is_open(), b.probe_ready(), b.cooloff_s, b.trips, b.opens,
                    b.closes, round(b.degraded_seconds(), 9)))
    return log


@pytest.mark.parametrize("seed", [80, 81, 82, 83, 84, 85])
def test_breaker_transition_log_matches(recorders, seed):
    """Inputs: 400 steps from seed (claims, outcomes, releases, trips, a
    rare quarantine, clock steps); exact (every step's state, claim, cool-
    off, counters and degraded seconds, and the flight events)."""
    ours, theirs = _breaker_walk(batched, seed, 400), _breaker_walk(ref_batched, seed, 400)
    assert ours == theirs
    states = {s for _, s, *_ in ours}
    assert {"closed", "open", "half_open"} <= states
    assert _events(recorders["port"]) == _events(recorders["ref"])


def _placement_walk(mods, seed: int, n_shards: int) -> list:
    """A seeded load pattern over one scheduler: place, done, trips,
    quarantines and clock steps; -> the chosen shard of every placement and
    the shard snapshots at the end."""
    rng = np.random.default_rng(seed)
    clock = Clock()
    # logical shards on both sides (the reference would look for jax devices)
    sched = mods["scheduler"].DeviceProgramScheduler(shards=n_shards, cooloff_s=1.0,
                                                     devices=[None] * n_shards)
    for s in sched.shards:
        s.breaker._clock = clock
    live, log = [], []
    for _ in range(300):
        op = int(rng.integers(0, 100))
        if op < 45:
            sh = sched.place()
            live.append(sh)
            claim = sh.breaker.acquire_dispatch()
            log.append(("place", sh.index, claim))
            if claim == "probe":
                sh.breaker.record_success(claim) if rng.integers(0, 2) else \
                    sh.breaker.record_failure(claim)
        elif op < 80 and live:
            sched.done(live.pop(int(rng.integers(0, len(live)))))
        elif op < 88:
            sched.shards[int(rng.integers(0, n_shards))].breaker.trip()
        elif op < 89 and n_shards > 1:
            sched.shards[int(rng.integers(0, n_shards))].breaker.quarantine("probe")
        else:
            clock.t += float(rng.choice([0.3, 1.5]))
    snaps = sched.stats()
    return log, snaps, [sched.warmable_shards()[i].index
                        for i in range(len(sched.warmable_shards()))], sched.total_trips()


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [86, 87])
def test_placement_sequence_matches(recorders, seed, n_shards):
    """Inputs: 300 load-pattern steps from seed on 1-4 logical shards;
    exact (each placement's shard and claim, the final stats, the warmable
    shards, and the rebalance flight events)."""
    ours, theirs = _placement_walk(PORT, seed, n_shards), _placement_walk(REF, seed, n_shards)
    assert ours == theirs
    assert {i for _, i, _ in ours[0]} == set(range(n_shards)) or n_shards > 2
    assert _events(recorders["port"]) == _events(recorders["ref"])
    if n_shards == 1:
        assert batched.Breaker is type(scheduler.DeviceProgramScheduler().shards[0].breaker)


def test_select_slot_and_shard_scope_match():
    for mods in (PORT, REF):
        assert mods["scheduler"].select_slot([]) is None
    cache = opcache.DeviceOperandCache(4)
    with opcache.shard_scope(1):
        cache.put("kem", b"key", {"x": torch.zeros(1)})
        assert opcache.current_shard() == 1 and cache.lookup("kem", b"key") is not None
    assert opcache.current_shard() == 0 and cache.lookup("kem", b"key") is None
    assert cache._key("kem", b"k") == ref_opcache.DeviceOperandCache._key("kem", b"k")


# -- the degrade path of one queue --------------------------------------------


def _fns(log: list):
    def device(items):
        log.append(("device", list(items)))
        return [("dev", x) for x in items]

    def fallback(items):
        log.append(("fallback", list(items)))
        return [("cpu", x) for x in items]

    return device, fallback


def _make_queue(mods, device, fallback, breaker, **kw):
    b = mods["batched"]
    if mods is PORT:
        return b.OpQueue(device, None, 64, 5.0, fallback_fn=fallback, breaker=breaker,
                         label="ML-KEM-768.enc", degrade_after_ms=1000.0,
                         dispatch_timeout_ms=2050.0, degrade_ref_batch=4, **kw)
    q = b.OpQueue(device, 64, 5.0, fallback_fn=fallback, breaker=breaker,
                  label="ML-KEM-768.enc", degrade_after_ms=1000.0, dispatch_timeout_ms=2050.0,
                  degrade_ref_batch=4, **kw)
    for bucket in (1, 2, 4, 8, 16, 32, 64):
        q.mark_warm(bucket)
    return q


#: each step: (flush size, seconds the breaker's injected clock moves on
#: after it, past the 0.6 s cool-off, so the cool-off is never a matter of
#: wall time); the plan below raises at the 2nd device dispatch, delays
#: the 4th past degrade_after (1.05 s > 1.0 s: a delay can only grow) and
#: under the watchdog by 1 s (2.05 s), and the 6th past the watchdog by
#: 1 s (3.05 s); a healthy dispatch has 1 s before it counts as slow
STEPS = ((3, 0.0), (4, 0.0), (2, 0.0), (3, 0.7), (4, 0.0), (2, 0.7), (3, 0.0), (2, 0.7),
         (4, 0.0))


def _degrade_plan(fmod):
    return fmod.FaultPlan(88, [
        fmod.FaultRule("device.dispatch", "raise", match={"op": "ML-KEM-768.enc"}, nth=2),
        fmod.FaultRule("device.dispatch", "delay", match={"op": "ML-KEM-768.enc"}, nth=4,
                       delay_s=1.05),
        fmod.FaultRule("device.dispatch", "delay", match={"op": "ML-KEM-768.enc"}, nth=6,
                       delay_s=3.05)])


def _degrade_run(mods, tracer) -> dict:
    log = []
    device, fallback = _fns(log)
    plan = _degrade_plan(mods["faults"])
    clock = Clock()
    breaker = mods["batched"].Breaker(cooloff_s=0.6, clock=clock)

    async def main():
        q = _make_queue(mods, device, fallback, breaker)
        results, states = [], []
        with plan.activate():
            k = 0
            for n, pause in STEPS:
                results.append(await asyncio.gather(*(q.submit(k + i) for i in range(n))))
                k += n
                states.append(breaker.state)
                clock.t += pause
        return q, results, states

    q, results, states = asyncio.run(asyncio.wait_for(main(), 20))
    st = q.stats.as_dict()
    spans = sorted((r["name"], r["attrs"].get("route")) for r in tracer.snapshot())
    return {"results": results, "states": states, "injected": plan.injected,
            "stats": {k: st[k] for k in ("ops", "flushes", "fallback_ops", "fallback_flushes",
                                         "breaker_trips", "device_trips",
                                         "device_served_fraction")},
            "breaker": (breaker.state, breaker.trips, breaker.opens, breaker.closes,
                        breaker.device_trips, breaker.fallback_trips),
            "spans": spans}, breaker, log


def test_queue_with_a_fallback_degrades_and_heals_as_the_reference(monkeypatch, recorders):
    """Nine flushes under a raise, a slow dispatch and a hung one, with a
    0.6 s cool-off on the breaker's injected clock between; exact (every future's result, the breaker
    state after each flush, the injection log, the stats that are not
    times, the breaker's counters, the span names and routes, which path
    served each flush, and the breaker's flight events)."""
    out, breakers, logs = {}, [], {}
    for side, mods in (("port", PORT), ("ref", REF)):
        tracer = mods["trace"].Tracer()
        monkeypatch.setattr(mods["trace"], "TRACER", tracer)
        out[side], breaker, logs[side] = _degrade_run(mods, tracer)
        breakers.append(breaker)
    # closed only now: the port's abandoned dispatch finishes meanwhile;
    # each side's routes are read once its abandoned dispatch has run
    for breaker in breakers:
        breaker.close() if hasattr(breaker, "close") else None
    deadline = time.monotonic() + 5.0
    while min(len(log) for log in logs.values()) < 10 and time.monotonic() < deadline:
        time.sleep(0.01)
    for side, log in logs.items():
        out[side]["routes"] = [kind for kind, _ in log]
    assert out["port"] == out["ref"]
    got = out["port"]
    # raise -> fallback while open; the canary heals; a slow dispatch trips
    # but serves; a hung one is abandoned (it finishes later) and falls back
    assert got["states"] == ["closed", "open", "open", "open", "closed", "open", "closed", "open",
                             "closed"]
    assert [r[0][0] for r in got["results"]] == ["dev", "cpu", "cpu", "cpu", "dev", "dev", "dev",
                                                 "cpu", "dev"]
    assert got["routes"] == ["device", "fallback", "fallback", "fallback", "device", "device",
                             "device", "fallback", "device", "device"]
    assert got["stats"]["breaker_trips"] == 3 and got["stats"]["fallback_ops"] == 11
    assert got["breaker"] == ("closed", 3, 3, 3, 7, 4)
    assert ("fallback.dispatch", "fallback") in got["spans"]
    assert _events(recorders["port"]) == _events(recorders["ref"])


def test_launch_counts_survive_the_device_pool():
    """Kernel wrappers count launches through ``cuda.count_launch`` from
    the breaker's device threads: 16 threads x 2,000 counts at a 1 us
    switch interval lose none."""
    import sys
    import threading

    from quantum_resistant_p2p_tpu_torch.utils import cuda as cuda_build

    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [cuda_build.count_launch(wrapper)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 2000


def test_thread_launch_tallies_split_by_thread():
    """``cuda.thread_launches`` reads what the calling thread counted, while
    other threads count the same wrapper: the global counter holds them all."""
    import threading

    from quantum_resistant_p2p_tpu_torch.utils import cuda as cuda_build

    def wrapper():
        pass

    wrapper.launches = 0
    seen = {}

    def count(k):
        before = cuda_build.thread_launches(wrapper)
        for _ in range(100 * k):
            cuda_build.count_launch(wrapper)
        seen[k] = cuda_build.thread_launches(wrapper) - before

    threads = [threading.Thread(target=count, args=(k,)) for k in range(1, 9)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert seen == {k: 100 * k for k in range(1, 9)}
    assert wrapper.launches == 100 * sum(range(1, 9))
    assert cuda_build.thread_launches(wrapper) == 0  # this thread counted none


def test_queue_without_a_fallback_never_touches_the_breaker():
    """No fallback: a raised dispatch fails its futures and the breaker
    stays closed with no trip (the port's rule: no twin serves unless the
    caller armed one)."""
    plan = faults.FaultPlan(89, [faults.FaultRule("device.dispatch", "raise",
                                                  match={"op": "x"})])
    breaker = batched.Breaker()

    async def main():
        q = batched.OpQueue(lambda items: list(items), None, 8, 2.0, breaker=breaker, label="x")
        with plan.activate():
            return q, await asyncio.gather(q.submit(1), q.submit(2), return_exceptions=True)

    q, out = asyncio.run(asyncio.wait_for(main(), 5))
    breaker.close()
    assert [type(r).__name__ for r in out] == ["FaultInjected"] * 2
    assert breaker.state == "closed" and breaker.trips == 0 and q.stats.breaker_trips == 0
    assert q.stats.device_trips == breaker.device_trips == 1


def test_scheduled_queue_places_each_flush_and_feeds_the_ledger(monkeypatch):
    """Two logical shards, shard 0 tripped: flushes land on shard 1, the
    queue.flush and device.dispatch spans carry it, and the ledger's
    shard_device_time and the per-shard registry children count them;
    the span attributes match the reference's."""
    views = {}
    for side, mods in (("port", PORT), ("ref", REF)):
        tracer = mods["trace"].Tracer()
        monkeypatch.setattr(mods["trace"], "TRACER", tracer)
        sched = mods["scheduler"].DeviceProgramScheduler(shards=2, devices=[None, None])
        sched.shards[0].breaker.trip()

        async def main():
            q = mods["batched"].OpQueue(lambda items: list(items), *(
                (None,) if mods is PORT else ()), 8, 2.0, fallback_fn=lambda items: list(items),
                scheduler=sched, label="ML-KEM-768.dec")
            if mods is REF:
                q.mark_warm(4)
            return await asyncio.gather(*(q.submit(i) for i in range(4)))

        assert asyncio.run(asyncio.wait_for(main(), 5)) == [0, 1, 2, 3]
        views[side] = sorted((r["name"], tuple(sorted((k, v) for k, v in r["attrs"].items()
                                                      if k != "waited_ms")))
                             for r in tracer.snapshot())
        if mods is PORT:
            reg = metrics.Registry(name="sched")
            ledger = cost.CostLedger(registry=reg)
            sched.attach_cost(ledger)
            sched.attach_registry(reg)
            sched.shards[1].run_placed(lambda items: items, [1, 2])
            assert ledger.totals()["device_seconds"] >= 0
            assert sched.stats()["shards"][1]["dispatches"] == 2
            snap = reg.snapshot()
            assert any(k.startswith("shard_dispatches") for k in snap["counters"])
            sched.close()
    assert views["port"] == views["ref"]
    assert any(dict(a).get("shard") == 1 for _, a in views["port"])


def test_degraded_seconds_and_availability_probe_match():
    """One injected clock: open, half-open, close, quarantine; exact (the
    degraded seconds and the probe's (good, bad) at every step)."""
    outs = []
    for mods in (PORT, REF):
        clock = Clock(50.0)
        b = mods["batched"].Breaker(cooloff_s=3.0, clock=clock)
        probe = mods["slo"].breaker_availability_probe(b, clock=clock)
        seq = []
        for step in ("trip", 1.0, 2.5, "acquire", 0.5, "success", 4.0, "trip", 1.0,
                     "quarantine", 7.0):
            if step == "trip":
                b.trip()
            elif step == "acquire":
                seq.append(b.acquire_dispatch())
            elif step == "success":
                b.record_success("probe")
            elif step == "quarantine":
                b.quarantine("x")
            else:
                clock.t += step
            seq.append((b.state, b.degraded_seconds(), probe()))
        outs.append(seq)
    assert outs[0] == outs[1]
    assert outs[0][-1][1] == pytest.approx(4.0 + 8.0)


def test_facade_breaker_rules_and_close():
    """A facade makes and closes its own breaker; a passed breaker or a
    scheduler is its owner's; mixing them is refused as in the
    reference."""
    from quantum_resistant_p2p_tpu_torch.provider import BatchedKEM, get_kem
    kem = get_kem("ML-KEM-512", backend="cpu")
    sched = scheduler.DeviceProgramScheduler(shards=2)
    with pytest.raises(ValueError, match="scheduler"):
        BatchedKEM(kem, scheduler=sched, cooloff_s=1.0)
    with pytest.raises(ValueError, match="breaker or cooloff_s"):
        BatchedKEM(kem, breaker=batched.Breaker(), cooloff_s=1.0)
    with BatchedKEM(kem, cooloff_s=7.0) as bk:
        assert bk.breaker.base_cooloff_s == 7.0 and bk._owns_breaker
        ex = bk.breaker.device_executor
    assert bk.breaker._executor is None and ex._shutdown
    with BatchedKEM(kem, scheduler=sched, fallback=kem) as bk:
        assert bk.breaker is sched.shards[0].breaker and not bk._owns_breaker
        assert all(q.scheduler is sched and q.fallback_fn is not None
                   for q in batched.facade_queues(bk))

        async def run():
            pk, sk = await bk.generate_keypair()
            ct, ss = await bk.encapsulate(pk)
            return ss == await bk.decapsulate(sk, ct)

        assert asyncio.run(asyncio.wait_for(run(), 20))
    assert sum(s.dispatches for s in sched.shards) == 3
    sched.close()



# -- bit-exactness of placed programs (logical CPU shards) --------------------


def test_placed_kem_program_bit_exact_vs_default_device():
    """Placement changes where a program runs, never its bytes: the same
    ML-KEM-512 keygen seeds give the same keys, and decaps the same secret,
    on shards 1 and 3 of four as unplaced (the JAX package's test of the
    same name places on its virtual devices; here the shards are logical,
    as on the "cpu" backend)."""
    from quantum_resistant_p2p_tpu_torch.kem import mlkem

    sched = scheduler.DeviceProgramScheduler(shards=4, backend="cpu")
    assert [s.device for s in sched.shards] == [None] * 4
    kg, enc, dec = mlkem.get("ML-KEM-512")
    rng = np.random.default_rng(20260803)
    d, z, m = (torch.tensor(rng.integers(0, 256, (2, 32), dtype=np.uint8)) for _ in range(3))
    ek_ref, dk_ref = kg(d, z)
    key_ref, ct_ref = enc(ek_ref, m)
    try:
        for shard in (sched.shards[1], sched.shards[3]):
            ek_s, dk_s = shard.run_placed(lambda _items: kg(d, z), [])
            assert torch.equal(ek_s, ek_ref) and torch.equal(dk_s, dk_ref)
            key_s = shard.run_placed(lambda _items: dec(dk_ref, ct_ref), [])
            assert torch.equal(key_s, key_ref)
    finally:
        sched.close()
    assert [s.dispatches for s in sched.shards] == [0, 2, 0, 2]


def test_placed_fused_handshake_step_bit_exact(monkeypatch):
    """The fused keygen_sign program (ML-KEM-512 x ML-DSA-44) with the host
    seeds pinned and a fixed rnd gives byte-identical keys and signatures
    placed on shard 1 of two as unplaced."""
    import os

    from quantum_resistant_p2p_tpu_torch.provider import (get_fused, get_kem, get_signature,
                                                          init_pk_offset)

    kem = get_kem("ML-KEM-512", backend="cpu")
    sig = get_signature("ML-DSA-44", backend="cpu")
    fused = get_fused(kem, sig)
    pk_off = init_pk_offset(kem.name, "AES-256-GCM")
    _spk, ssk = sig.generate_keypair()
    sks = np.frombuffer(ssk, np.uint8)[None]
    tmpl = [b"t" * (pk_off + 2 * kem.public_key_len + 64)]
    rnd = [b"\x07" * 32]
    seeds = os.urandom(64)

    def fixed_urandom(n, _s=seeds):
        return (_s * (n // len(_s) + 1))[:n]

    monkeypatch.setattr(os, "urandom", fixed_urandom)
    ek_ref, dk_ref, sig_ref = fused.keygen_sign_batch(sks, tmpl, pk_off, rnd=rnd)
    sched = scheduler.DeviceProgramScheduler(shards=2, backend="cpu")
    try:
        ek_s, dk_s, sig_s = sched.shards[1].run_placed(
            lambda _items: fused.keygen_sign_batch(sks, tmpl, pk_off, rnd=rnd), [])
    finally:
        sched.close()
    assert np.array_equal(ek_s, ek_ref) and np.array_equal(dk_s, dk_ref)
    assert [bytes(s) for s in sig_s] == [bytes(s) for s in sig_ref]
