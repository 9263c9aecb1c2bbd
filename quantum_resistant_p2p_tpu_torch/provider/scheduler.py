"""Device-program scheduler: the placement axis of the batching queues.

Counterpart of the reference's ``provider/scheduler.py``.  ``OpQueue``
decides WHEN a batch dispatches, the operand cache WHAT device state a
program reuses, and the breaker WHETHER the device path is trusted; the
scheduler decides WHERE.  Every device flush runs against a :class:`Shard`
(one slot of a 1-D placement axis), chosen per flush by a load-aware,
health-aware policy (:func:`select_slot`), and each flush is placed whole,
so its results are those of the unplaced path.

Each shard owns its own :class:`provider.batched.Breaker` (with its own
device and warm-up executors), so a sick device quarantines ONE shard
while its siblings keep serving; the policy routes around open and
quarantined shards and routes a canary flush back when a cool-off expires.

A logical shard has no device pinned: placement then scopes only the
operand cache (``opcache.shard_scope``).
A shard given a ``torch.device("cuda", i)`` also enters
``torch.cuda.device(i)`` on the dispatching thread, where the providers'
index-less "cuda" device, their tables and their kernels' constant
uploads (keyed by device) follow it.  On the "cuda" backend a scheduler
asked for ``shards >= 1`` with no ``devices`` places shard ``i`` on GPU
``i`` (``parallel.shard_devices``) and raises when fewer GPUs exist; on
"cpu", or with ``shards=0``, shards stay logical.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, Callable

import torch

from ..obs import flight as obs_flight
from ..parallel.mesh import shard_devices
from .batched import Breaker, CoalescingHub
from .opcache import shard_scope

logger = logging.getLogger(__name__)


def select_slot(slots):
    """The placement policy.  A *slot* is anything with ``breaker``,
    ``inflight`` and ``index`` (a :class:`Shard`; the reference's fleet
    places gateways with the same function):

    1. a probe-eligible slot (breaker open past its cool-off, or
       half-open with no canary in flight) wins first — healing requires
       routing exactly one unit of work back to it;
    2. otherwise the least-loaded CLOSED slot (tie → lowest index);
    3. otherwise (nothing healthy) the least-loaded non-quarantined slot
       — its breaker claim then degrades the work explicitly, exactly
       like the single-device stack's fallback.

    Deterministic given the load pattern; returns None only for an empty
    slot list.
    """
    slots = list(slots)
    if not slots:
        return None
    probe = [s for s in slots if s.breaker.probe_ready()]
    if probe:
        return min(probe, key=lambda s: (s.inflight, s.index))
    closed = [s for s in slots if s.breaker.state == "closed"]
    pool = closed or [s for s in slots if s.breaker.state != "quarantined"]
    return min(pool or slots, key=lambda s: (s.inflight, s.index))


def _resolve_devices(shards: int, backend: str | None) -> list[Any]:
    """One device a shard: GPU ``i`` for shard ``i`` of a "cuda" axis
    (raising when fewer GPUs exist: no shard degrades to a logical one or
    to the CPU), else logical placeholders (``None``)."""
    if backend == "cuda" and shards >= 1:
        return shard_devices(shards)
    return [None] * max(shards, 1)


class Shard:
    """One slot of the placement axis: a device (or a logical slot), its
    breaker, and its load gauge.

    ``run_placed(fn, items)`` is the placement boundary: it runs one
    device-program callable ON the current (worker) thread under this
    shard's placement: ``torch.cuda.device(i)`` for a shard on GPU ``i``,
    and ``opcache.shard_scope`` so device state cached for one shard is
    never fed to a program on another.  Placement changes only WHERE a
    program runs, never what it computes.
    """

    def __init__(self, index: int, device: Any = None,
                 breaker: Breaker | None = None):
        self.index = index
        self.device = device
        self.label = f"shard{index}"
        self.breaker = breaker if breaker is not None else Breaker()
        #: rides in the breaker's flight-recorder events so a dump tells
        #: WHICH shard opened/quarantined, not just that one did
        self.breaker.label = self.label
        #: guards the load gauge: place()/done() run on the event loop,
        #: run_placed on the dispatch workers
        self._lock = threading.Lock()
        self.inflight = 0
        self.dispatches = 0
        # labeled obs instruments (attached by the scheduler when it is
        # given a registry; None otherwise — recording stays optional)
        self._ctr_dispatches = None
        self._hist_latency = None
        #: cost-ledger feed (obs/cost.py): per-shard placed-program
        #: seconds, attached via DeviceProgramScheduler.attach_cost
        self._cost = None

    @contextlib.contextmanager
    def placement(self):
        """Enter this shard's placement context (on the dispatching
        thread).  Logical shards (``device is None``) scope only the
        opcache; a CUDA shard also makes its GPU the current device."""
        with shard_scope(self.index):
            if self.device is None or self.device.type != "cuda":
                yield
            else:
                with torch.cuda.device(self.device):
                    yield

    def run_placed(self, fn: Callable[[list[Any]], list[Any]],
                   items: list[Any]) -> list[Any]:
        """Run one device-program callable under this shard's placement.
        Failures propagate to the caller, which records them to THIS
        shard's breaker (per-shard quarantine, not fleet-wide)."""
        t0 = time.perf_counter()
        with self.placement():
            out = fn(items)
        dt = time.perf_counter() - t0
        with self._lock:
            self.dispatches += 1
        if self._ctr_dispatches is not None:
            self._ctr_dispatches.inc()
        if self._hist_latency is not None:
            self._hist_latency.record(dt)
        if self._cost is not None:
            # per-shard device seconds (obs/cost.py)
            self._cost.shard_device_time(self.index, dt)
        return out

    def snapshot(self) -> dict[str, Any]:
        b = self.breaker
        with self._lock:
            inflight, dispatches = self.inflight, self.dispatches
        return {
            "shard": self.index,
            "device": str(self.device) if self.device is not None else None,
            "inflight": inflight,
            "dispatches": dispatches,
            "breaker_state": b.state,
            "breaker_opens": b.opens,
            "breaker_closes": b.closes,
            "device_trips": b.device_trips,
            "fallback_trips": b.fallback_trips,
        }


class DeviceProgramScheduler(CoalescingHub):
    """Places device-program flushes onto shards; owns the shard set.

    Placement policy (deterministic given the load pattern):

    1. a probe-eligible shard (breaker open past its cool-off, or
       half-open with no canary in flight) wins first — healing a shard
       requires routing exactly one real flush back to it;
    2. otherwise the least-loaded CLOSED shard (tie → lowest index);
    3. otherwise (no healthy shard) the least-loaded non-quarantined
       shard — its breaker claim then serves the flush from the cpu
       fallback, degrading exactly like the single-device stack.

    The scheduler is also the coalescing hub for the queues it serves
    (:class:`provider.batched.CoalescingHub`): sibling queues flush in one
    scheduling window, and each coalesced flush is then placed on its own.
    ``devices`` (one entry a shard: ``None`` for a logical shard, or a
    ``torch.device``) defaults to GPU ``i`` for shard ``i`` on the "cuda"
    ``backend`` and to logical shards otherwise.  :meth:`close` stops
    every shard's workers.
    """

    def __init__(self, shards: int = 1, cooloff_s: float = 30.0,
                 cooloff_max_s: float = 480.0, registry=None,
                 devices: list[Any] | None = None, backend: str | None = None):
        if devices is None:
            devices = _resolve_devices(shards, backend)
        self.shards = [
            Shard(i, None if dev is None else torch.device(dev),
                  Breaker(cooloff_s, cooloff_max_s))
            for i, dev in enumerate(devices)
        ]
        self._lock = threading.Lock()
        self._last_healthy: frozenset[int] = frozenset(
            s.index for s in self.shards
        )
        super().__init__()
        if registry is not None:
            self.attach_registry(registry)

    # -- observability --------------------------------------------------------

    def attach_registry(self, registry) -> None:
        """Create the per-shard labeled children (obs/metrics.py): a
        ``shard=<i>`` child per instrument, so one scrape (or JSON
        snapshot) breaks dispatch counts and latency down by shard."""
        ctr = registry.counter(
            "shard_dispatches", "device programs run, by placement shard")
        hist = registry.histogram(
            "shard_dispatch_latency", "placed device-program latency (s)")
        gauge = registry.gauge(
            "shard_inflight", "flushes currently placed, by shard")
        for s in self.shards:
            s._ctr_dispatches = ctr.labels(shard=s.index)
            s._hist_latency = hist.labels(shard=s.index)
            child = gauge.labels(shard=s.index)
            child.set_fn(lambda s=s: s.inflight)

    def attach_cost(self, ledger) -> None:
        """Feed per-shard placed-program seconds into a
        :class:`obs.cost.CostLedger` (the engine attaches its ledger)."""
        for s in self.shards:
            s._cost = ledger

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    # -- placement ------------------------------------------------------------

    def place(self) -> Shard:
        """Claim the next flush's shard (pair with :meth:`done`) — the
        shared two-level policy (:func:`select_slot`) applied at the
        local-shard scope."""
        with self._lock:
            chosen = select_slot(self.shards)
            with chosen._lock:
                chosen.inflight += 1
            healthy = frozenset(
                s.index for s in self.shards if s.breaker.state == "closed"
            )
            if healthy != self._last_healthy:
                # the routing table just changed: a flight dump must show
                # WHEN traffic moved off (or back onto) a shard
                obs_flight.record(
                    "shard_rebalance",
                    healthy=sorted(healthy),
                    avoided=sorted(set(range(len(self.shards))) - healthy),
                    placed_on=chosen.index,
                )
                self._last_healthy = healthy
            return chosen

    def done(self, shard: Shard) -> None:
        with shard._lock:
            shard.inflight -= 1

    # -- fleet operations -----------------------------------------------------

    def quarantine_all(self, why: str) -> None:
        """Health-gate verdicts are about the device PROGRAMS (wrong
        answers), not one device: every shard runs the same programs, so a
        correctness failure pins the whole axis onto the cpu fallback."""
        for s in self.shards:
            s.breaker.quarantine(why)

    def total_trips(self) -> int:
        """Serial dispatch steps (device + fallback) across every shard."""
        return sum(s.breaker.device_trips + s.breaker.fallback_trips
                   for s in self.shards)

    def warmable_shards(self) -> list[Shard]:
        """The shards a warm-up runs on: CLOSED breakers only, so a sick
        shard's hung device cannot stall the warm-up of the others."""
        return [s for s in self.shards if s.breaker.state == "closed"]

    def stats(self) -> dict[str, Any]:
        snaps = [s.snapshot() for s in self.shards]
        served = sum(s["dispatches"] for s in snaps)
        return {
            "n_shards": len(self.shards),
            "placement": "least-inflight, probe-first, quarantine-aware",
            "dispatches": served,
            "shards": snaps,
        }

    def close(self) -> None:
        """Wait for in-flight dispatches and stop every shard's workers."""
        for s in self.shards:
            s.breaker.close()
