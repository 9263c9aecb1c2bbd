"""The port's autotuner (quantum_resistant_p2p_tpu_torch.provider.autotune)
against the JAX package's, on the CPU.

``decide`` is equal over a hypothesis grid of its inputs; a
``QueueTuner`` driven by one synthetic offered-load trace and one
synthetic clock makes the same decision sequence, journals the same
ledger entries and records the same flight events as the reference's;
and ``QRP2P_AUTOTUNE=0`` leaves the queues on their static policy.
Tolerance: exact.  Stdlib and numpy only: no JAX program runs here.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from quantum_resistant_p2p_tpu.obs import cost as ref_cost
from quantum_resistant_p2p_tpu.obs import flight as ref_flight
from quantum_resistant_p2p_tpu.obs import metrics as ref_metrics
from quantum_resistant_p2p_tpu.provider import autotune as ref_autotune
from quantum_resistant_p2p_tpu.provider import batched as ref_batched
from quantum_resistant_p2p_tpu_torch.obs import cost, flight, metrics
from quantum_resistant_p2p_tpu_torch.provider import autotune, batched

PORT = {"autotune": autotune, "batched": batched, "cost": cost, "metrics": metrics}
REF = {"autotune": ref_autotune, "batched": ref_batched, "cost": ref_cost,
       "metrics": ref_metrics}

_lat = st.one_of(st.none(), st.floats(0.0, 0.2, allow_nan=False))


@settings(max_examples=400, deadline=None, database=None)
@given(cur=st.sampled_from([1, 2, 4, 8, 64, 512, 4096]), floor=st.integers(1, 300),
       avg=st.floats(0.0, 6000.0, allow_nan=False), dev=_lat, disp=_lat, degraded=st.booleans(),
       cap=st.sampled_from([64, 4096]), budget=st.sampled_from([0.005, 0.05]))
def test_decide_is_equal_over_its_grid(cur, floor, avg, dev, disp, degraded, cap, budget):
    cfg = autotune.TunerConfig(max_bucket=cap, latency_budget_s=budget)
    ref_cfg = ref_autotune.TunerConfig(max_bucket=cap, latency_budget_s=budget)
    assert autotune.decide(cur, floor, avg, dev, disp, degraded, cfg) == \
        ref_autotune.decide(cur, floor, avg, dev, disp, degraded, ref_cfg)


def test_tuner_config_defaults_match():
    assert autotune.TunerConfig() == autotune.TunerConfig(**vars(ref_autotune.TunerConfig()))


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


class _Breaker:
    state = "closed"


class _Queue:
    """The counters a tuner reads, on one side's ``QueueStats``."""

    def __init__(self, mods, label: str, floor: int):
        self.label = label
        self.bucket_floor = floor
        self.stats = mods["batched"].QueueStats()
        self.breaker = _Breaker()


def _trace_run(mods, seed: int, recorder) -> tuple:
    """A synthetic offered-load trace: each tick adds flushes of a size
    drawn from a drifting load, their device and loop-side latencies, now
    and then a fallback flush or an open breaker; the tuner steps on its
    own cadence."""
    rng = np.random.default_rng(seed)
    clock = _Clock()
    ledger = mods["cost"].CostLedger()
    reg = mods["metrics"].Registry(name="tune")
    tuner_set = mods["autotune"].Autotuner(registry=reg, clock=clock, cost=ledger)
    queues = [_Queue(mods, label, floor) for label, floor in
              (("ML-KEM-768.enc", 1), ("ML-DSA-65.sign", 4))]
    tuners = [tuner_set.attach_queue(q) for q in queues]
    assert tuner_set.attach_queue(queues[0]) is tuners[0]
    out = []
    load = 8.0
    for tick in range(160):
        clock.t += float(rng.choice([0.05, 0.1, 0.3]))
        load = max(1.0, load * float(rng.choice([0.7, 1.0, 1.4])))
        for q, tuner in zip(queues, tuners):
            for _ in range(int(rng.integers(1, 6))):
                n = max(1, int(rng.poisson(load)))
                q.stats.ops += n
                q.stats.flushes += 1
                dev = float(rng.uniform(0.0005, 0.02))
                q.stats.device_hist.record(dev)
                q.stats.dispatch_hist.record(dev * float(rng.choice([1.0, 1.2, 5.0])))
            if rng.integers(0, 25) == 0:
                q.stats.fallback_flushes += 1
            q.breaker.state = "open" if rng.integers(0, 30) == 0 else "closed"
            stepped = tuner.maybe_step()
            out.append((tick, q.label, stepped, tuner.snapshot(), tuner.flush_at(),
                        tuner.wait_s(), tuner.alive()))
    snap = reg.snapshot()
    gauges = {k: v for k, v in snap["gauges"].items() if k.startswith("autotune_")}
    events = [{k: v for k, v in e.items() if k not in ("t", "mono", "seq", "thread")}
              for e in recorder.snapshot() if e["kind"] == "tuner_step"]
    return out, ledger.journal(), tuner_set.snapshot(), gauges, events


@pytest.mark.parametrize("seed", [90, 91, 92])
def test_queue_tuner_makes_the_same_decisions(monkeypatch, seed):
    """Inputs: a 160-tick trace from seed on two queues; exact (every
    step's decision and hot-path reads, the ledger journal, the snapshot,
    the gauges and the tuner_step flight events)."""
    ours_rec, theirs_rec = flight.FlightRecorder(), ref_flight.FlightRecorder()
    monkeypatch.setattr(flight, "RECORDER", ours_rec)
    monkeypatch.setattr(ref_flight, "RECORDER", theirs_rec)
    ours, theirs = _trace_run(PORT, seed, ours_rec), _trace_run(REF, seed, theirs_rec)
    assert ours == theirs
    steps = [s for s in ours[0] if s[2]]
    assert len(steps) >= 20 and len(ours[1]) == len(steps)
    assert {s[3]["degraded"] for s in steps} == {True, False}
    assert len({s[3]["bucket"] for s in steps}) > 2


def test_queue_reads_its_tuner_and_steps_on_flush_completion():
    """A queue with a tuner reads its window and flush-at count, and a
    flush's completion steps it (cadence permitting).  The tuner's window
    floor is 0.5 s, so only an executor hop of over 1 s would read as a
    saturated host (the queue times its flushes on the wall clock)."""
    clock = _Clock()
    cfg = autotune.TunerConfig(min_window_s=0.5, max_window_s=1.0)

    async def main():
        q = batched.OpQueue(lambda items: list(items), None, 64, 50.0, label="x")
        tuner = autotune.Autotuner(cfg=cfg, clock=clock).attach_queue(q)
        assert q.tuner is tuner and q._wait_s() == 0.05 and q._flush_at() == 64
        for _ in range(5):
            await asyncio.gather(*(q.submit(i) for i in range(3)))
        clock.t += 1.0
        await asyncio.gather(*(q.submit(i) for i in range(3)))
        q.breaker.close()
        return q, tuner

    q, tuner = asyncio.run(asyncio.wait_for(main(), 10))
    assert tuner.steps == 1 and tuner.bucket == 4 and not tuner.saturated and q._flush_at() == 8
    assert q._wait_s() == tuner.wait_s() and q._wait_s() <= cfg.max_window_s


@pytest.mark.parametrize("value,want", [("0", False), ("1", True), (None, True)])
def test_autotune_env_default_and_static_queues(monkeypatch, value, want):
    """``QRP2P_AUTOTUNE``: the same default as the reference; off, the
    caller attaches no tuner and every queue keeps its constructor's flush
    policy."""
    if value is None:
        monkeypatch.delenv("QRP2P_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("QRP2P_AUTOTUNE", value)
    assert autotune.autotune_enabled_default() == ref_autotune.autotune_enabled_default() == want
    from quantum_resistant_p2p_tpu_torch.provider import BatchedKEM, get_kem
    with BatchedKEM(get_kem("ML-KEM-512", backend="cpu"), max_wait_ms=7.0) as bk:
        tuner_set = autotune.Autotuner() if autotune.autotune_enabled_default() else None
        if tuner_set is not None:
            tuner_set.attach_facades(bk, None)
        queues = list(batched.facade_queues(bk))
        assert all((q.tuner is not None) == want for q in queues)
        assert all(q._wait_s() == 0.007 and q._flush_at() == 4096 for q in queues)
