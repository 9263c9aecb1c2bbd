"""Async batching queue: the host-to-GPU boundary.

Concurrent callers enqueue their KEM, signature and AEAD operations as
futures; a flush takes up to ``max_batch`` of them, pads the batch to a
power-of-two bucket and runs it as one batched call on the device, then
resolves every future.  A flush happens at ``max_batch`` pending operations
or ``max_wait_ms`` after the first enqueue, whichever comes first (an
attached autotuner, provider/autotune.py, moves both).  The queues sharing
a :class:`Breaker` (or a placement scheduler, provider/scheduler.py) flush
in one scheduling window.

Every operation rides a priority lane (:data:`LANE_REKEY`,
:data:`LANE_HANDSHAKE`, :data:`LANE_BULK`): a flush takes its operations
in (lane, arrival) order, and a lane at its ``lane_capacity`` sheds new
operations with :class:`LaneShed`.  Each flush is a ``queue.flush`` span on
the loop and a ``device.dispatch`` span on the worker thread
(obs/trace.py); the device call passes the ``device.dispatch`` and
``warmup`` fault points (faults/); a facade's ``cost`` ledger, when one is
attached (obs/cost.py), counts occupancy, device seconds, scalar bypasses
and warm-up compiles.

Device calls run on the breaker's 2-thread device pool (each shard's,
under a scheduler), so the event loop never blocks on the GPU; each flush
is placed whole, so its results do not depend on which worker ran it.
A queue degrades only where its caller armed a fallback (``fallback=``, a
"cpu" provider or the scalar AEAD): then a device dispatch that is slow,
hung or raising trips the breaker, the flush is served on the CPU, and a
canary flush heals the device path after the cool-off.  Without a
fallback a failed flush raises in every future it carried (an injected
fault too).

Counterpart of the reference's ``provider/batched.py`` (``OpQueue``,
``QueueStats``, ``Breaker``, the lanes and ``LaneShed``, ``_run_valid``,
``facade_queues``, ``BatchedKEM``, ``BatchedSignature``, ``BatchedFused``,
``BatchedAEAD`` and their ``warmup``), held to the reference's queue with
and without a fallback.  The port has no jit, so it has no warm-bucket
gating: every bucket is warm.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..faults import plan as _faults
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..obs.metrics import LatencyHistogram
from ..utils.wipe import wipe
from .base import (BatchedAEADOps, FusedHandshakeOps, KeyExchangeAlgorithm, SignatureAlgorithm,
                   SymmetricAlgorithm, next_pow2, pad_rows)

#: priority lanes, highest priority first (lowest value wins the flush
#: order): re-keys of live sessions must never starve behind a bulk flood,
#: and fresh handshakes sit between the two.  With single-lane traffic the
#: drain is the insertion-order slice.
LANE_REKEY, LANE_HANDSHAKE, LANE_BULK = 0, 1, 2
LANE_NAMES = {LANE_REKEY: "rekey", LANE_HANDSHAKE: "handshake", LANE_BULK: "bulk"}


class LaneShed(RuntimeError):
    """A lane hit its pending-depth bound and this op was shed (loudly):
    admission control at the queue, so a bulk flood degrades BULK, not the
    rekey/handshake lanes sharing the queue."""

    def __init__(self, label: str, lane: int, depth: int):
        super().__init__(
            f"queue {label}: {LANE_NAMES.get(lane, lane)} lane shed at "
            f"depth {depth}"
        )
        self.lane = lane


@dataclass
class QueueStats:
    """Per-queue counters."""

    ops: int = 0
    flushes: int = 0
    max_batch_seen: int = 0
    #: seconds from each flush's first enqueue to its dispatch, summed
    total_wait_s: float = 0.0
    total_dispatch_s: float = 0.0
    #: ops and flushes served by the CPU fallback while the device path was
    #: slow, hung or raising; breaker trips this queue caused
    fallback_ops: int = 0
    fallback_flushes: int = 0
    breaker_trips: int = 0
    #: device calls made (one batch_fn call on a device worker a flush)
    device_trips: int = 0
    #: per-flush batch sizes, most recent last (bounded)
    batch_sizes: list[int] = field(default_factory=list)
    #: per-flush latency seen from the event loop (executor wait included)
    dispatch_hist: LatencyHistogram = field(default_factory=LatencyHistogram)
    #: the batch function's own time on the worker thread (device calls
    #: only: the fallback's and a warm-up's time are not in it)
    device_hist: LatencyHistogram = field(default_factory=LatencyHistogram)
    #: ops submitted / shed per priority lane (lane tag -> count)
    lane_ops: dict = field(default_factory=dict)
    lane_sheds: dict = field(default_factory=dict)
    BATCH_SIZE_HISTORY = 1024

    def as_dict(self) -> dict[str, Any]:
        def ms(h: LatencyHistogram, p: float) -> float:
            return round(1e3 * (h.percentile(p) or 0.0), 3)

        return {
            "ops": self.ops,
            "flushes": self.flushes,
            "max_batch_seen": self.max_batch_seen,
            "avg_batch": (self.ops / self.flushes) if self.flushes else 0.0,
            "avg_dispatch_ms": (
                1e3 * self.total_dispatch_s / self.flushes if self.flushes else 0.0
            ),
            "p50_dispatch_ms": ms(self.dispatch_hist, 50),
            "p99_dispatch_ms": ms(self.dispatch_hist, 99),
            "p50_device_ms": ms(self.device_hist, 50),
            "p99_device_ms": ms(self.device_hist, 99),
            "fallback_ops": self.fallback_ops,
            "fallback_flushes": self.fallback_flushes,
            "breaker_trips": self.breaker_trips,
            "device_trips": self.device_trips,
            # 1.0 = every op rode the device path
            "device_served_fraction": (round((self.ops - self.fallback_ops) / self.ops, 4)
                                       if self.ops else None),
            "lanes": {LANE_NAMES.get(k, str(k)): v for k, v in sorted(self.lane_ops.items())},
            "lane_sheds": {LANE_NAMES.get(k, str(k)): v
                           for k, v in sorted(self.lane_sheds.items())},
        }


class CoalescingHub:
    """The queues registered on one hub (a :class:`Breaker`, or the
    placement scheduler) flush in the same scheduling window: when one
    flushes, every sibling holding items flushes too, so independent
    batches go in flight together instead of one timer window apart.  Only
    queues that already hold items are touched."""

    def __init__(self):
        #: weak: a rebuilt facade's dead queues must not linger
        self._queues: weakref.WeakSet = weakref.WeakSet()
        self._coalescing = False

    def register_queue(self, queue: OpQueue) -> None:
        self._queues.add(queue)

    def coalesce(self, origin: OpQueue) -> None:
        if self._coalescing:
            return
        self._coalescing = True
        try:
            for q in list(self._queues):
                if q is not origin and q._items:
                    q._flush_local()
        finally:
            self._coalescing = False


class Breaker(CoalescingHub):
    """Circuit breaker for one device's dispatch path: closed, open,
    half-open and quarantined.

    * ``closed``: every armed flush dispatches to the device.
    * ``open``: every armed flush runs on the fallback until the cool-off
      expires; failures of canary probes double the cool-off (capped).
    * ``half_open``: the cool-off expired; exactly one real queued flush
      goes to the device as a canary while its siblings keep falling back.
      Its success closes the breaker (and resets the cool-off); its
      failure re-opens it with a doubled cool-off.
    * ``quarantined``: the health gate (provider/health.py) found the
      device path WRONG, not slow; the fallback is pinned for the process.

    Every transition logs one WARNING and is a flight event: ``open`` and
    ``quarantined`` are auto-dump triggers (``breaker_open``,
    ``breaker_quarantined``), the rest ``breaker_transition`` records.
    ``clock`` is injectable (tests drive the state machine on a fake
    timeline).

    The breaker owns two executors: a 2-thread DEVICE pool for live
    dispatches, and a 1-thread WARM-UP pool at nice 19 for ``OpQueue.warm``.
    A hung, abandoned dispatch holds at most the 2 device threads and never
    starves the default executor the fallback runs on.  :meth:`close`
    stops both.
    """

    def __init__(self, cooloff_s: float = 30.0, cooloff_max_s: float = 480.0,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__()
        self._clock = clock
        #: guards every state-machine mutation: outcomes arrive on the event
        #: loop, a health-gate quarantine may come from another thread
        self._lock = threading.RLock()
        self.base_cooloff_s = cooloff_s
        self.cooloff_s = cooloff_s  # current (grows while probes fail)
        self.cooloff_max_s = cooloff_max_s
        #: placement identity ("shard<i>" when a scheduler's shard owns it),
        #: in logs and flight events
        self.label = ""
        self.state = "closed"
        self.trips = 0
        self.opens = 0
        self.closes = 0
        #: device and fallback dispatches of every queue sharing this breaker
        self.device_trips = 0
        self.fallback_trips = 0
        self._open_until = 0.0
        self._probe_in_flight = False
        #: cumulative seconds NOT closed, and the start of the current
        #: degraded stretch: the availability SLO's feed (obs/slo.py)
        self._degraded_s = 0.0
        self._degraded_since: float | None = None
        self._executor: ThreadPoolExecutor | None = None
        self._warmup_executor: ThreadPoolExecutor | None = None

    def is_open(self) -> bool:
        """True while no regular device dispatch may proceed."""
        with self._lock:
            if self.state == "quarantined":
                return True
            return self.state == "open" and self._clock() < self._open_until

    def probe_ready(self) -> bool:
        """True when the next :meth:`acquire_dispatch` would route a canary
        probe (open past the cool-off, or half-open with no probe in
        flight): the placement policy routes a flush back to such a shard
        so it can heal."""
        with self._lock:
            if self._probe_in_flight or self.state == "quarantined":
                return False
            if self.state == "half_open":
                return True
            return self.state == "open" and self._clock() >= self._open_until

    def _set_state(self, new: str, why: str = "") -> None:
        """Transition, log line and flight event (callers hold the lock)."""
        with self._lock:
            if new == self.state:
                return
            log = logging.getLogger(__name__)
            old = self.state
            self.state = new
            now = self._clock()
            if old == "closed" and new != "closed":
                self._degraded_since = now
            elif new == "closed" and self._degraded_since is not None:
                self._degraded_s += now - self._degraded_since
                self._degraded_since = None
            if new == "open":
                self.opens += 1
                log.warning(
                    "circuit breaker OPEN (%s): device dispatch path degraded; "
                    "serving from cpu fallback for %.1fs, then probing",
                    why or "tripped", self.cooloff_s,
                )
            elif new == "closed":
                self.closes += 1
                self.cooloff_s = self.base_cooloff_s
                log.warning(
                    "circuit breaker CLOSED: device canary probe succeeded; "
                    "traffic restored to the device path"
                )
            elif new == "quarantined":
                log.error(
                    "circuit breaker QUARANTINED (%s): device path disabled for "
                    "this process; all ops served from the cpu fallback", why,
                )
            # after the bookkeeping, so the event carries the real counters
            emit = (obs_flight.trigger if new in ("open", "quarantined")
                    else obs_flight.record)
            emit(
                "breaker_open" if new == "open"
                else "breaker_quarantined" if new == "quarantined"
                else "breaker_transition",
                state=new, prev=old, why=why, cooloff_s=round(self.cooloff_s, 3),
                opens=self.opens, closes=self.closes, shard=self.label or None,
            )

    def trip(self) -> None:
        """Record a device failure seen outside the claim protocol: opens
        the breaker without escalating the cool-off."""
        self._trip(escalate=False)

    def _trip(self, escalate: bool) -> None:
        """From closed: open at the base cool-off.  ``escalate`` (a FAILED
        CANARY PROBE) doubles the cool-off, capped; other failures only
        refresh the open clock, so one incident's concurrent dispatches
        cannot compound the backoff.  A quarantined breaker stays so."""
        with self._lock:
            self.trips += 1
            if self.state == "quarantined":
                return
            if escalate:
                self.cooloff_s = min(self.cooloff_s * 2.0, self.cooloff_max_s)
            elif self.state == "closed":
                self.cooloff_s = self.base_cooloff_s
            self._open_until = self._clock() + self.cooloff_s
            if self.state == "open":
                logging.getLogger(__name__).debug(
                    "circuit breaker already open: cool-off clock refreshed "
                    "(concurrent dispatch of the same incident)"
                )
            else:
                self._set_state("open", "canary probe failed" if escalate else "tripped")

    def degraded_seconds(self) -> float:
        """Cumulative seconds this breaker spent NOT closed, the live
        stretch included: the bad side of the availability SLO."""
        with self._lock:
            total = self._degraded_s
            if self._degraded_since is not None:
                total += self._clock() - self._degraded_since
            return total

    def quarantine(self, why: str) -> None:
        """Pin the fallback for the process lifetime (the health gate found
        the device path computing wrong answers)."""
        with self._lock:
            self.trips += 1
            self._set_state("quarantined", why)

    def acquire_dispatch(self) -> str:
        """Claim the next armed flush's route: ``"device"`` (closed),
        ``"probe"`` (half-open canary, one in flight) or ``"fallback"``.
        Pair with :meth:`record_success`, :meth:`record_failure` or
        :meth:`release`."""
        with self._lock:
            if self.state == "closed":
                return "device"
            if self.state == "quarantined":
                return "fallback"
            if self.state == "open":
                if self._clock() < self._open_until:
                    return "fallback"
                self._set_state("half_open")
            if self._probe_in_flight:
                return "fallback"
            self._probe_in_flight = True
            return "probe"

    def record_success(self, claim: str) -> None:
        with self._lock:
            if claim == "probe":
                self._probe_in_flight = False
                self._set_state("closed")

    def record_failure(self, claim: str) -> None:
        with self._lock:
            if claim == "probe":
                self._probe_in_flight = False
                self._trip(escalate=True)
            else:
                self._trip(escalate=False)

    def release(self, claim: str) -> None:
        """Return an un-dispatched claim without recording an outcome."""
        with self._lock:
            if claim == "probe":
                self._probe_in_flight = False

    @property
    def device_executor(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=2, thread_name_prefix="qrp2p-device")
        return self._executor

    @property
    def warmup_executor(self) -> ThreadPoolExecutor:
        if self._warmup_executor is None:
            def _background_priority():
                # nice() is per thread on Linux: demote the warm-up worker
                try:
                    os.nice(19)
                except OSError:
                    pass

            self._warmup_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="qrp2p-warmup",
                initializer=_background_priority)
        return self._warmup_executor

    def close(self) -> None:
        """Wait for in-flight dispatches and stop both executors (a later
        dispatch starts new ones)."""
        for attr in ("_executor", "_warmup_executor"):
            ex = getattr(self, attr)
            setattr(self, attr, None)
            if ex is not None:
                ex.shutdown(wait=True)


class OpQueue:
    """Accumulates (item -> future) pairs; flushes through a batch function.

    ``batch_fn(items) -> list[results]`` is called with at most
    ``max_batch`` items on a device worker: ``executor`` when given, else
    the breaker's (under a scheduler, the placed shard's breaker's) device
    pool.  A result that is an Exception instance fails only its own
    future.  ``label`` names the queue at the fault points and in spans and
    the cost ledger; ``lane_capacity`` maps a lane to its most pending
    operations (absent: unbounded).

    Without ``fallback_fn``, an exception raised by ``batch_fn`` (or by an
    injected device fault) fails every future of the flush, and the breaker
    is not consulted.  With it, the breaker watches every device dispatch:
    one that raises, outlasts ``dispatch_timeout_ms`` (the watchdog: the
    stuck call is abandoned to finish in the background) or takes longer
    than ``degrade_after_ms`` trips the breaker, and while it is open the
    flushes run ``fallback_fn`` on the loop's default executor.  Both
    thresholds hold for a flush of up to ``degrade_ref_batch`` rows and
    scale linearly above it.  Every trip is counted
    (``stats.breaker_trips``) and logged at WARNING.

    ``scheduler`` (provider/scheduler.py) places each flush whole on one
    of its shards, whose breaker takes the claim; ``tuner``
    (provider/autotune.py), when attached, sets the flush-at count and the
    timer window.
    """

    def __init__(self, batch_fn: Callable[[list[Any]], list[Any]],
                 executor: ThreadPoolExecutor | None = None, max_batch: int = 4096,
                 max_wait_ms: float = 2.0,
                 fallback_fn: Callable[[list[Any]], list[Any]] | None = None,
                 degrade_after_ms: float = 2000.0, dispatch_timeout_ms: float = 15000.0,
                 degrade_ref_batch: int = 256, breaker: Breaker | None = None,
                 bucket_floor: int = 1, label: str = "", scheduler=None,
                 lane_capacity: dict[int, int] | None = None):
        self.label = label
        self.batch_fn = batch_fn
        self.executor = executor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.fallback_fn = fallback_fn
        self.degrade_after_s = degrade_after_ms / 1e3
        self.dispatch_timeout_s = dispatch_timeout_ms / 1e3
        self.degrade_ref_batch = degrade_ref_batch
        #: flushes pad up to at least this power of two (the cost ledger's
        #: padded slots, the degrade thresholds' scale)
        self.bucket_floor = min(next_pow2(max(1, bucket_floor)), max_batch)
        self.scheduler = scheduler
        if scheduler is not None:
            # shard 0's breaker is the handle stats readers use; claims are
            # taken on each placed shard's breaker
            self.breaker = breaker if breaker is not None else scheduler.shards[0].breaker
            self.hub = scheduler
        else:
            self.breaker = breaker if breaker is not None else Breaker()
            self.hub = self.breaker
        self.hub.register_queue(self)
        self.stats = QueueStats()
        self.lane_capacity = lane_capacity
        #: adaptive flush policy (provider/autotune.py QueueTuner): None
        #: reads the constructor's max_batch and max_wait_ms
        self.tuner = None
        #: device-cost ledger (obs/cost.py) when attached: observation only
        self.cost = None
        self._items: list[Any] = []
        self._futures: list[asyncio.Future] = []
        #: lane tag per pending item (parallel to _items), and O(1) pending
        #: counts per lane for the capacity check on every submit
        self._lane_tags: list[int] = []
        self._lane_pending: dict[int, int] = {}
        self._timer: asyncio.TimerHandle | None = None
        self._first_enqueue_t = 0.0
        #: strong refs to in-flight flush tasks (the loop holds them weakly)
        self._dispatch_tasks: set[asyncio.Task] = set()

    def _wait_s(self) -> float:
        """The timer window: the tuner's once it has decided, else the
        constructor's."""
        if self.tuner is None:
            return self.max_wait_s
        w = self.tuner.wait_s()
        return self.max_wait_s if w is None else w

    def _flush_at(self) -> int:
        """Pending ops that flush at once: the tuner's choice once decided
        (a bucket of 1 is no early trigger), else ``max_batch``."""
        if self.tuner is None:
            return self.max_batch
        b = self.tuner.flush_at()
        if b is None or b <= 1:
            return self.max_batch
        return min(self.max_batch, b)

    def _shed(self, lane: int) -> None:
        n = self.stats.lane_sheds.get(lane, 0) + 1
        self.stats.lane_sheds[lane] = n
        # loud but bounded: a bulk flood must not turn the log/flight ring
        # into a wall of identical shed lines
        if n == 1 or n % 128 == 0:
            logging.getLogger(__name__).warning(
                "queue %s: %s lane at capacity (%d pending); op shed "
                "(%d total)", self.label or "?", LANE_NAMES.get(lane, lane),
                self.lane_capacity.get(lane), n,
            )
            obs_flight.record(
                "load_shed", where="lane", queue=self.label,
                lane=LANE_NAMES.get(lane, str(lane)), sheds=n,
            )
        raise LaneShed(self.label, lane, self.lane_capacity.get(lane, 0))

    async def submit(self, item: Any, lane: int = LANE_HANDSHAKE) -> Any:
        loop = asyncio.get_running_loop()
        cap = (self.lane_capacity or {}).get(lane)
        if cap is not None and self._lane_pending.get(lane, 0) >= cap:
            self._shed(lane)
        fut: asyncio.Future = loop.create_future()
        self._items.append(item)
        self._futures.append(fut)
        self._lane_tags.append(lane)
        self._lane_pending[lane] = self._lane_pending.get(lane, 0) + 1
        self.stats.ops += 1
        self.stats.lane_ops[lane] = self.stats.lane_ops.get(lane, 0) + 1
        if len(self._items) == 1:
            self._first_enqueue_t = time.perf_counter()
            self._timer = loop.call_later(self._wait_s(), self._flush_soon)
        if len(self._items) >= self._flush_at():
            self._flush_soon()
        return await fut

    def _flush_soon(self) -> None:
        self._flush_local()
        self.hub.coalesce(self)

    def _take_batch(self) -> tuple[list[Any], list[asyncio.Future], int]:
        """Detach up to ``max_batch`` pending ops in (lane, arrival) order.

        With single-lane traffic the drain is the insertion-order slice;
        under mixed lanes a flush takes rekeys first, then handshakes,
        then bulk.  Returns (items, futures, flush_lane): the highest-
        priority lane aboard, stamped on the ``queue.flush`` span."""
        n = len(self._items)
        k = min(self.max_batch, n)
        if len(set(self._lane_tags)) <= 1:
            items = self._items[:k]
            futs = self._futures[:k]
            lane = self._lane_tags[0] if self._lane_tags else LANE_HANDSHAKE
            del self._items[:k], self._futures[:k], self._lane_tags[:k]
            if self._lane_tags:
                self._lane_pending[lane] = len(self._lane_tags)
            else:
                self._lane_pending.clear()
            return items, futs, lane
        order = sorted(range(n), key=lambda i: (self._lane_tags[i], i))
        take = order[:k]
        taken = set(take)
        items = [self._items[i] for i in take]
        futs = [self._futures[i] for i in take]
        lane = min(self._lane_tags[i] for i in take)
        for i in take:
            self._lane_pending[self._lane_tags[i]] -= 1
        self._items = [x for i, x in enumerate(self._items) if i not in taken]
        self._futures = [x for i, x in enumerate(self._futures) if i not in taken]
        self._lane_tags = [x for i, x in enumerate(self._lane_tags) if i not in taken]
        return items, futs, lane

    def _flush_local(self) -> None:
        """Detach pending items synchronously (so late submits cannot bloat
        a batch past max_batch) and dispatch them as tasks."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        loop = asyncio.get_running_loop()
        while self._items:
            items, futs, lane = self._take_batch()
            task = loop.create_task(self._dispatch(items, futs, self._first_enqueue_t, lane))
            self._dispatch_tasks.add(task)
            task.add_done_callback(self._dispatch_tasks.discard)

    def _executor_for(self, breaker: Breaker) -> ThreadPoolExecutor:
        return self.executor if self.executor is not None else breaker.device_executor

    def _traced_call(self, fn, span_name: str, route: str, parent, items: list[Any],
                     shard=None) -> list[Any]:
        """Run one dispatch callable inside a span ON the worker thread, so
        the span measures the call itself and carries the worker's thread
        lane.  ``parent`` is the loop-side context captured before the
        executor hop (contextvars do not cross it).  With a ``shard`` the
        call runs under its placement and the span carries its index.
        Device calls feed ``device_hist`` and the ledger's device seconds;
        the fallback's and a warm-up's do not."""
        attrs = {"op": self.label, "n": len(items), "route": route}
        if shard is not None:
            attrs["shard"] = shard.index
        with obs_trace.span(span_name, parent=parent, **attrs):
            t0 = time.perf_counter()
            try:
                if shard is not None:
                    return shard.run_placed(fn, items)
                return fn(items)
            finally:
                if route not in ("fallback", "warmup"):
                    dt = time.perf_counter() - t0
                    self.stats.device_hist.record(dt)
                    if self.cost is not None:
                        self.cost.device_time(self.label, dt)

    def _device_call(self, items: list[Any], shard_index: int | None = None,
                     lane: int | None = None) -> list[Any]:
        """The device dispatch boundary: the fault points wrap the real
        batch function, a raise at the first failing like a device fault,
        a poisoned slot only its own future.  The shard index and the
        flush's lane ride into the fault-match info."""
        _faults.device_dispatch(self.label, len(items), shard=shard_index,
                                lane=LANE_NAMES.get(lane) if lane is not None else None)
        return _faults.poison_results(self.label, self.batch_fn(items))

    def _direct_fn(self, shard, lane: int | None):
        return functools.partial(self._device_call,
                                 shard_index=shard.index if shard is not None else None,
                                 lane=lane)

    def _warm_call(self, items: list[Any]) -> list[Any]:
        """The warm-up boundary (fault scope "warmup": a killed warm-up
        surfaces as this call raising).  Under a scheduler the warm-up runs
        on every closed shard."""
        _faults.warmup(self.label)
        if self.scheduler is not None:
            warm = self.scheduler.warmable_shards()
            if warm:
                out = None
                for sh in warm:
                    out = sh.run_placed(self.batch_fn, items)
                return out
        return self.batch_fn(items)

    def warm(self, items: list[Any]) -> list[Any]:
        """Run the batch function once on ``items`` on the warm-up worker,
        through the warm-up fault point and in a ``device.dispatch`` span
        of route "warmup"; block until it is done and return its results.
        An item whose result is an Exception raises it.  The facades'
        ``warmup`` calls this; it is not a flush and counts none."""
        ex = self.executor if self.executor is not None else self.breaker.warmup_executor
        out = ex.submit(self._traced_call, self._warm_call, "device.dispatch", "warmup",
                        obs_trace.current(), items).result()
        for r in out:
            if isinstance(r, Exception):
                raise r
        return out

    def _cost_occupancy(self, items: list[Any], lane: int, shard) -> None:
        """Ledger hook for one device flush: real items vs the padded
        bucket the batch function dispatches (fallback flushes pad none)."""
        if self.cost is None:
            return
        self.cost.flush_occupancy(self.label, LANE_NAMES.get(lane, str(lane)), len(items),
                                  max(self.bucket_floor, next_pow2(len(items))),
                                  shard=shard.index if shard is not None else None)

    def _count_trip(self, breaker: Breaker) -> None:
        """One device call, counted here and on the serving breaker."""
        self.stats.device_trips += 1
        breaker.device_trips += 1

    def _trip_breaker(self, reason: str, dt: float, claim: str, breaker: Breaker) -> None:
        self.stats.breaker_trips += 1
        breaker.record_failure(claim)
        logging.getLogger(__name__).warning(
            "batch queue %s%s: device dispatch %s (%.1fs); serving from cpu "
            "fallback for %.0fs", self.label or "?",
            f" [{breaker.label}]" if breaker.label else "", reason, dt, breaker.cooloff_s,
        )

    async def _run_fallback(self, items: list[Any], breaker: Breaker) -> list[Any]:
        self.stats.fallback_flushes += 1
        self.stats.fallback_ops += len(items)
        breaker.fallback_trips += 1
        return await asyncio.get_running_loop().run_in_executor(
            None, self._traced_call, self.fallback_fn, "fallback.dispatch", "fallback",
            obs_trace.current(), items)

    async def _run_batch(self, items: list[Any], flush_span, lane: int) -> list[Any]:
        """One flush: placed whole on one shard (under a scheduler), then
        the device call.  With a fallback it runs under the breaker's claim
        and the watchdog; without one its claim is ``direct``, the breaker
        is not consulted, and a raise fails the flush."""
        if self.scheduler is not None:
            shard = self.scheduler.place()
            breaker = shard.breaker
            flush_span.set_attr("shard", shard.index)
        else:
            shard, breaker = None, self.breaker
        claim = breaker.acquire_dispatch() if self.fallback_fn is not None else "direct"
        try:
            return await self._run_claimed(items, shard, claim, breaker, lane)
        finally:
            if shard is not None:
                self.scheduler.done(shard)

    async def _run_claimed(self, items: list[Any], shard, claim: str, breaker: Breaker,
                           lane: int) -> list[Any]:
        if claim == "fallback":
            return await self._run_fallback(items, breaker)
        t0 = time.perf_counter()
        self._count_trip(breaker)
        self._cost_occupancy(items, lane, shard)
        device = asyncio.get_running_loop().run_in_executor(
            self._executor_for(breaker), self._traced_call, self._direct_fn(shard, lane),
            "device.dispatch", claim, obs_trace.current(), items, shard)
        if claim == "direct":
            return await device
        scale = max(1.0, max(self.bucket_floor, next_pow2(len(items))) / self.degrade_ref_batch)
        try:
            results = await asyncio.wait_for(asyncio.shield(device),
                                             self.dispatch_timeout_s * scale)
        except asyncio.TimeoutError:
            # a thread cannot be cancelled: abandon the call to finish in
            # the background and serve these ops from the fallback
            self._trip_breaker("timed out", time.perf_counter() - t0, claim, breaker)
            device.add_done_callback(lambda f: f.exception())  # reap quietly
            return await self._run_fallback(items, breaker)
        except Exception as exc:  # recorded to the breaker and logged, then served by the fallback
            self._trip_breaker(f"raised {type(exc).__name__}", time.perf_counter() - t0, claim,
                               breaker)
            return await self._run_fallback(items, breaker)
        dt = time.perf_counter() - t0
        if dt > self.degrade_after_s * scale:
            self._trip_breaker("slow", dt, claim, breaker)
        else:
            breaker.record_success(claim)
        return results

    async def _dispatch(self, items: list[Any], futs: list[asyncio.Future], first_t: float,
                        lane: int) -> None:
        self.stats.flushes += 1
        self.stats.max_batch_seen = max(self.stats.max_batch_seen, len(items))
        self.stats.batch_sizes.append(len(items))
        del self.stats.batch_sizes[: -QueueStats.BATCH_SIZE_HISTORY]
        self.stats.total_wait_s += time.perf_counter() - first_t
        t0 = time.perf_counter()
        try:
            # the flush task inherits the context captured when its timer or
            # task was scheduled: the first enqueuer's span is its parent
            with obs_trace.span("queue.flush", op=self.label, n=len(items),
                                lane=LANE_NAMES.get(lane, str(lane)),
                                waited_ms=round(1e3 * (t0 - first_t), 3)) as sp:
                results = await self._run_batch(items, sp, lane)
            dt = time.perf_counter() - t0
            self.stats.total_dispatch_s += dt
            self.stats.dispatch_hist.record(dt)
            if self.tuner is not None:
                # the autotuner steps on flush completion (no background task)
                self.tuner.maybe_step()
            for f, r in zip(futs, results):
                if f.cancelled():
                    continue
                if isinstance(r, Exception):
                    f.set_exception(r)
                else:
                    f.set_result(r)
        except Exception as exc:  # the flush failed: every waiter gets it
            for f in futs:
                if not f.cancelled():
                    f.set_exception(exc)


def _run_valid(items, is_valid, dispatch, invalid_result, floor=1):
    """Filter, pad, dispatch and scatter for the batch functions.

    ``is_valid(item)`` selects items safe to stack; ``dispatch(valid items,
    pow2 target)`` runs the padded batch; invalid slots get
    ``invalid_result()``, so one malformed input never fails its batch
    mates.  The target is the power of two of the flush size (raised to
    ``floor``), not of the valid count, so the batch shape depends only on
    how many operations arrived.
    """
    valid_idx = [i for i, it in enumerate(items) if is_valid(it)]
    results = [invalid_result() for _ in items]
    if valid_idx:
        out = dispatch([items[i] for i in valid_idx], max(floor, next_pow2(len(items))))
        for j, i in enumerate(valid_idx):
            results[i] = out[j]
    return results


def _stack(items, idx: int, tgt: int) -> np.ndarray:
    """Field ``idx`` of each item as uint8 rows, padded to ``tgt`` rows."""
    return pad_rows(np.stack([np.frombuffer(it[idx], np.uint8) for it in items]), tgt)


def _column(items, idx: int, tgt: int) -> list:
    """Field ``idx`` of each item, the last repeated up to ``tgt``."""
    return [it[idx] for it in items] + [items[-1][idx]] * (tgt - len(items))


def facade_queues(facade) -> list[OpQueue]:
    """The live OpQueues of one batched facade (BatchedKEM's keygen,
    encaps and decaps queues, BatchedSignature's sign and verify, ...):
    the one list an observer attaches to, e.g. a cost ledger as every
    queue's ``cost``."""
    return list(facade._queues)


def _timed_warm(facade, n: int) -> None:
    """Run one facade ``_warm_one`` under the clock and attribute its wall
    seconds to the cost ledger as one ``where="warmup"`` compile event of
    its bucket (the first launches of a process build the kernel
    libraries)."""
    t0 = time.perf_counter()
    facade._warm_one(n)
    if facade.cost is not None:
        facade.cost.compile_event(facade.name, facade._bucket(n), time.perf_counter() - t0,
                                  where="warmup")


def _facade_breaker(breaker: Breaker | None, cooloff_s: float | None,
                    scheduler) -> tuple[Breaker, bool]:
    """-> (the facade's breaker, whether the facade made it).  Under a
    scheduler it is shard 0's (the stats handle: each flush claims on its
    placed shard's breaker)."""
    if scheduler is not None:
        if breaker is not None or cooloff_s is not None:
            raise ValueError("pass either scheduler or breaker/cooloff_s: a scheduler owns one "
                             "breaker per shard")
        return scheduler.shards[0].breaker, False
    if breaker is not None:
        if cooloff_s is not None:
            raise ValueError("pass either breaker or cooloff_s, not both (an explicit breaker "
                             "carries its own cool-off)")
        return breaker, False
    return Breaker(cooloff_s if cooloff_s is not None else 30.0), True


class _Facade:
    """Queues of one algorithm's batch functions, sharing one breaker (or
    one scheduler's shards) and its device workers.

    ``ops`` names each queue: its label is ``f"{name}.{op}"``.
    ``fallback_fns`` (None, or one per queue) arm each queue's CPU degrade
    path.  ``bucket_floor`` raises every padded batch to at least that
    power of two; ``lane_capacity`` bounds each lane's pending operations
    in every queue; ``degrade_opts`` are the queues' ``degrade_after_ms``,
    ``dispatch_timeout_ms`` and ``degrade_ref_batch``.  Call :meth:`close`
    (or use ``with``) to stop the workers of a breaker the facade made
    itself; a passed breaker or scheduler is its owner's to close.
    """

    def __init__(self, algo, batch_fns, fallback_fns, ops, max_batch: int, max_wait_ms: float,
                 bucket_floor: int, lane_capacity: dict[int, int] | None,
                 breaker: Breaker | None, cooloff_s: float | None, scheduler, degrade_opts):
        self.algo = algo
        self.name = algo.name
        self.bucket_floor = min(next_pow2(max(1, bucket_floor)), max_batch)
        #: placement axis shared with sibling facades (None: one breaker)
        self.scheduler = scheduler
        #: device-cost ledger (obs/cost.py): warm-up compile attribution
        self.cost = None
        self.breaker, self._owns_breaker = _facade_breaker(breaker, cooloff_s, scheduler)
        self._queues = [
            OpQueue(lambda items, fn=fn: fn(algo, self.bucket_floor, items), None, max_batch,
                    max_wait_ms, fallback_fn=fb,
                    breaker=None if scheduler is not None else self.breaker,
                    bucket_floor=self.bucket_floor, label=f"{algo.name}.{op}",
                    scheduler=scheduler, lane_capacity=lane_capacity, **degrade_opts)
            for fn, fb, op in zip(batch_fns, fallback_fns or [None] * len(ops), ops)]

    def warmup(self, sizes: tuple[int, ...] = (1,)) -> None:
        """Run every queue's batch function at the padded bucket of each
        size (``_warm_one``), through the warm-up fault point; blocks until
        done.  The first launches build the kernel libraries; call it
        before serving.  With a ``cost`` ledger attached, each size is one
        ``where="warmup"`` compile event."""
        for n in sizes:
            _timed_warm(self, n)

    def _bucket(self, n: int) -> int:
        return max(self.bucket_floor, next_pow2(n))

    def close(self) -> None:
        """Wait for in-flight flushes and stop the workers of the facade's
        own breaker."""
        if self._owns_breaker:
            self.breaker.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fallbacks(fallback, batch_fns):
    """The batch functions bound to a same-name CPU provider, padded to
    nothing (floor 1), or None without one."""
    if fallback is None:
        return None
    return [functools.partial(fn, fallback, 1) for fn in batch_fns]


class BatchedKEM(_Facade):
    """Async facade over a KeyExchangeAlgorithm's batch operations: three
    queues (keygen, encaps, decaps), labelled ``<name>.kg``, ``.enc`` and
    ``.dec``.

    ``fallback`` (a same-name "cpu" provider) arms the queues' degrade
    path: a device dispatch that is slow, hung or raising trips the breaker
    and its operations run on the CPU instead of failing."""

    def __init__(self, algo: KeyExchangeAlgorithm, max_batch: int = 4096,
                 max_wait_ms: float = 2.0, fallback: KeyExchangeAlgorithm | None = None,
                 breaker: Breaker | None = None, cooloff_s: float | None = None,
                 bucket_floor: int = 1, scheduler=None,
                 lane_capacity: dict[int, int] | None = None, **degrade_opts):
        self.fallback = fallback
        fns = (self._kg_batch, self._enc_batch, self._dec_batch)
        super().__init__(algo, fns, _fallbacks(fallback, fns), ("kg", "enc", "dec"), max_batch,
                         max_wait_ms, bucket_floor, lane_capacity, breaker, cooloff_s,
                         scheduler, degrade_opts)
        self._kg, self._enc, self._dec = self._queues

    @staticmethod
    def _kg_batch(algo, floor, items: list[None]) -> list[tuple[bytes, bytes]]:
        n = len(items)
        pks, sks = algo.generate_keypair_batch(max(floor, next_pow2(n)))
        out = [(bytes(pk), bytes(sk)) for pk, sk in zip(pks[:n], sks[:n])]
        wipe(sks)
        return out

    @staticmethod
    def _enc_batch(algo, floor, items: list[bytes]):
        def dispatch(valid, tgt):
            pks = pad_rows(np.stack([np.frombuffer(pk, np.uint8) for pk in valid]), tgt)
            cts, sss = algo.encapsulate_batch(pks)
            out = [(bytes(ct), bytes(ss)) for ct, ss in zip(cts, sss)]
            wipe(sss)
            return out

        return _run_valid(items, lambda pk: len(pk) == algo.public_key_len, dispatch,
                          lambda: ValueError("bad public-key length"), floor)

    @staticmethod
    def _dec_batch(algo, floor, items: list[tuple[bytes, bytes]]):
        def dispatch(valid, tgt):
            sks = _stack(valid, 0, tgt)
            sss = algo.decapsulate_batch(sks, _stack(valid, 1, tgt))
            out = [bytes(ss) for ss in sss]
            wipe(sks, sss)
            return out

        return _run_valid(
            items,
            lambda it: len(it[0]) == algo.secret_key_len and len(it[1]) == algo.ciphertext_len,
            dispatch, lambda: ValueError("bad secret-key/ciphertext length"), floor)

    def _warm_one(self, n: int) -> None:
        """Keygen, encaps and decaps at ``n``'s bucket, then, with an
        operand cache, a same-key encaps pair: the cache's miss program,
        then its hit program."""
        n2 = self._bucket(n)
        pairs = self._kg.warm([None] * n2)
        cts = self._enc.warm([pk for pk, _ in pairs])
        self._dec.warm([(sk, ct) for (_, sk), (ct, _) in zip(pairs, cts)])
        if getattr(self.algo, "opcache", None) is not None:
            same = [pairs[0][0]] * n2
            self._enc.warm(same)  # cache miss
            self._enc.warm(same)  # cache hit

    async def generate_keypair(self, lane: int = LANE_HANDSHAKE) -> tuple[bytes, bytes]:
        return await self._kg.submit(None, lane)

    async def encapsulate(self, public_key: bytes,
                          lane: int = LANE_HANDSHAKE) -> tuple[bytes, bytes]:
        return await self._enc.submit(public_key, lane)

    async def decapsulate(self, secret_key: bytes, ciphertext: bytes,
                          lane: int = LANE_HANDSHAKE) -> bytes:
        return await self._dec.submit((secret_key, ciphertext), lane)

    def stats(self) -> dict[str, Any]:
        return {
            "keygen": self._kg.stats.as_dict(),
            "encaps": self._enc.stats.as_dict(),
            "decaps": self._dec.stats.as_dict(),
        }


class BatchedSignature(_Facade):
    """Async facade over a SignatureAlgorithm's batch operations: two
    queues (sign, verify), labelled ``<name>.sign`` and ``.verify``.

    An item of the wrong key or signature length fails alone: a sign with
    a ValueError, a verify with False.  A failed flush raises in every
    future it carried, verify included.  ``fallback`` arms the degrade
    path as on :class:`BatchedKEM`."""

    def __init__(self, algo: SignatureAlgorithm, max_batch: int = 4096,
                 max_wait_ms: float = 2.0, fallback: SignatureAlgorithm | None = None,
                 breaker: Breaker | None = None, cooloff_s: float | None = None,
                 bucket_floor: int = 1, scheduler=None,
                 lane_capacity: dict[int, int] | None = None, **degrade_opts):
        self.fallback = fallback
        fns = (self._sign_batch, self._verify_batch)
        super().__init__(algo, fns, _fallbacks(fallback, fns), ("sign", "verify"), max_batch,
                         max_wait_ms, bucket_floor, lane_capacity, breaker, cooloff_s,
                         scheduler, degrade_opts)
        self._sign, self._verify = self._queues

    @staticmethod
    def _sign_batch(algo, floor, items: list[tuple[bytes, bytes]]):
        def dispatch(valid, tgt):
            sks = _stack(valid, 0, tgt)
            sigs = algo.sign_batch(sks, _column(valid, 1, tgt))
            wipe(sks)
            return sigs

        return _run_valid(items, lambda it: len(it[0]) == algo.secret_key_len, dispatch,
                          lambda: ValueError("bad secret-key length"), floor)

    @staticmethod
    def _verify_batch(algo, floor, items: list[tuple[bytes, bytes, bytes]]):
        def dispatch(valid, tgt):
            oks = algo.verify_batch(_stack(valid, 0, tgt), _column(valid, 1, tgt),
                                    _column(valid, 2, tgt))
            return [bool(ok) for ok in oks]

        return _run_valid(
            items,
            lambda it: len(it[0]) == algo.public_key_len and len(it[2]) == algo.signature_len,
            dispatch, lambda: False, floor)

    def _warm_one(self, n: int) -> None:
        """Sign and verify at ``n``'s bucket under one fresh key; with an
        operand cache, each twice (the cache's miss program, then its hit
        program), and then once more under distinct keys (the mixed-key
        programs a flush of several clients runs)."""
        have_cache = getattr(self.algo, "opcache", None) is not None
        pk, sk = self.algo.generate_keypair()
        n2 = self._bucket(n)
        reps = 2 if have_cache else 1
        for _ in range(reps):
            sigs = self._sign.warm([(sk, b"warmup")] * n2)
        for _ in range(reps):
            self._verify.warm([(pk, b"warmup", sig) for sig in sigs])
        if have_cache and n2 > 1:
            pks, sks = self.algo.generate_keypair_batch(n2)
            sigs = self._sign.warm([(bytes(k), b"warmup") for k in sks])
            self._verify.warm([(bytes(p), b"warmup", sig) for p, sig in zip(pks, sigs)])
            wipe(sks)  # warm-up only key material

    async def sign(self, secret_key: bytes, message: bytes,
                   lane: int = LANE_HANDSHAKE) -> bytes:
        return await self._sign.submit((secret_key, message), lane)

    async def verify(self, public_key: bytes, message: bytes, signature: bytes,
                     lane: int = LANE_HANDSHAKE) -> bool:
        return await self._verify.submit((public_key, message, signature), lane)

    def stats(self) -> dict[str, Any]:
        return {"sign": self._sign.stats.as_dict(), "verify": self._verify.stats.as_dict()}


class BatchedFused(_Facade):
    """Async facade over a ``FusedHandshakeOps`` capability: three queues
    (keygen+sign, verify+encaps+sign, verify+decaps+sign, labelled
    ``<name>.keygen_sign``, ``.encaps_verify_sign`` and
    ``.decaps_verify_sign``), so a handshake step's KEM op, transcript
    hash and signature op are one device trip.

    ``pk_off`` / ``ct_off`` are the static byte offsets of the hex-encoded
    device output inside the init / response transcript templates: facts of
    the caller's canonical-JSON layout, so one facade serves one layout.

    Every field is length-checked per item: a malformed ``keygen_sign``
    item fails alone with a ValueError, a malformed ``encaps_verify_sign``
    or ``decaps_verify_sign`` item fails alone as ``ok=False`` (the verify
    contract: most of their fields come from the peer).

    With both ``fallback_kem`` and ``fallback_sig`` (the "cpu" providers),
    a tripped breaker serves each step composed of per-op CPU calls
    (verify, the KEM op, the host render into the template, sign), which
    give the same bytes the device does.  Without them a failed flush
    raises in every waiter.
    """

    def __init__(self, fused: FusedHandshakeOps, pk_off: int, ct_off: int,
                 max_batch: int = 4096, max_wait_ms: float = 2.0, fallback_kem=None,
                 fallback_sig=None, breaker: Breaker | None = None,
                 cooloff_s: float | None = None, bucket_floor: int = 1, scheduler=None,
                 lane_capacity: dict[int, int] | None = None, **degrade_opts):
        self.pk_off = pk_off
        self.ct_off = ct_off
        self.fallback_kem = fallback_kem
        self.fallback_sig = fallback_sig
        have_fb = fallback_kem is not None and fallback_sig is not None
        super().__init__(fused, (self._kg_batch, self._enc_batch, self._dec_batch),
                         (self._kg_fallback, self._enc_fallback, self._dec_fallback)
                         if have_fb else None,
                         ("keygen_sign", "encaps_verify_sign", "decaps_verify_sign"), max_batch,
                         max_wait_ms, bucket_floor, lane_capacity, breaker, cooloff_s,
                         scheduler, degrade_opts)
        self._kg, self._enc, self._dec = self._queues

    def _kg_valid(self, it) -> bool:
        sk, tmpl = it
        return (len(sk) == self.algo.sig.secret_key_len
                and self.pk_off + 2 * self.algo.kem.public_key_len <= len(tmpl)
                <= self.algo.init_template_len)

    def _enc_valid(self, it) -> bool:
        peer_pk, peer_sig_pk, _msg_in, sig_in, sk, tmpl = it
        return (len(peer_pk) == self.algo.kem.public_key_len
                and len(peer_sig_pk) == self.algo.sig.public_key_len
                and len(sig_in) == self.algo.sig.signature_len
                and len(sk) == self.algo.sig.secret_key_len
                and self.ct_off + 2 * self.algo.kem.ciphertext_len <= len(tmpl)
                <= self.algo.resp_template_len)

    def _dec_valid(self, it) -> bool:
        kem_sk, ct, peer_sig_pk, _msg_in, sig_in, sk, _msg_out = it
        return (len(kem_sk) == self.algo.kem.secret_key_len
                and len(ct) == self.algo.kem.ciphertext_len
                and len(peer_sig_pk) == self.algo.sig.public_key_len
                and len(sig_in) == self.algo.sig.signature_len
                and len(sk) == self.algo.sig.secret_key_len)

    @staticmethod
    def _render(tmpl: bytes, payload: bytes, off: int) -> bytes:
        """Host twin of the device's hex insert: the transcript the
        signature covers."""
        return tmpl[:off] + payload.hex().encode() + tmpl[off + 2 * len(payload):]

    def _kg_batch(self, fused, floor, items):
        def dispatch(valid, tgt):
            sks = _stack(valid, 0, tgt)
            pks, ksks, sigs = fused.keygen_sign_batch(sks, _column(valid, 1, tgt), self.pk_off)
            out = [(bytes(p), bytes(k), s) for p, k, s in zip(pks, ksks, sigs)]
            wipe(sks, ksks)
            return out

        return _run_valid(items, self._kg_valid, dispatch,
                          lambda: ValueError("bad secret-key/template length"), floor)

    def _enc_batch(self, fused, floor, items):
        def dispatch(valid, tgt):
            sks = _stack(valid, 4, tgt)
            oks, cts, sss, sigs = fused.encaps_verify_sign_batch(
                _stack(valid, 0, tgt), _stack(valid, 1, tgt), _column(valid, 2, tgt),
                _column(valid, 3, tgt), sks, _column(valid, 5, tgt), self.ct_off)
            out = [(bool(ok), bytes(ct), bytes(ss), sig)
                   for ok, ct, ss, sig in zip(oks, cts, sss, sigs)]
            wipe(sks, sss)
            return out

        return _run_valid(items, self._enc_valid, dispatch, lambda: (False, b"", b"", b""),
                          floor)

    def _dec_batch(self, fused, floor, items):
        def dispatch(valid, tgt):
            ksks, sks = _stack(valid, 0, tgt), _stack(valid, 5, tgt)
            oks, sss, sigs = fused.decaps_verify_sign_batch(
                ksks, _stack(valid, 1, tgt), _stack(valid, 2, tgt), _column(valid, 3, tgt),
                _column(valid, 4, tgt), sks, _column(valid, 6, tgt))
            out = [(bool(ok), bytes(ss), sig) for ok, ss, sig in zip(oks, sss, sigs)]
            wipe(ksks, sks, sss)
            return out

        return _run_valid(items, self._dec_valid, dispatch, lambda: (False, b"", b""), floor)

    # -- the per-op CPU fallbacks (the same bytes as the device) -----------

    def _kg_fallback(self, items):
        def dispatch(valid, _tgt):
            out = []
            for sk, tmpl in valid:
                pk, ksk = self.fallback_kem.generate_keypair()
                out.append((pk, ksk,
                            self.fallback_sig.sign(sk, self._render(tmpl, pk, self.pk_off))))
            return out

        return _run_valid(items, self._kg_valid, dispatch,
                          lambda: ValueError("bad secret-key/template length"), 1)

    def _enc_fallback(self, items):
        def dispatch(valid, _tgt):
            out = []
            for peer_pk, peer_sig_pk, msg_in, sig_in, sk, tmpl in valid:
                if not self.fallback_sig.verify(peer_sig_pk, msg_in, sig_in):
                    out.append((False, b"", b"", b""))
                    continue
                ct, ss = self.fallback_kem.encapsulate(peer_pk)
                out.append((True, ct, ss,
                            self.fallback_sig.sign(sk, self._render(tmpl, ct, self.ct_off))))
            return out

        return _run_valid(items, self._enc_valid, dispatch, lambda: (False, b"", b"", b""), 1)

    def _dec_fallback(self, items):
        def dispatch(valid, _tgt):
            out = []
            for kem_sk, ct, peer_sig_pk, msg_in, sig_in, sk, msg_out in valid:
                if not self.fallback_sig.verify(peer_sig_pk, msg_in, sig_in):
                    out.append((False, b"", b""))
                    continue
                ss = self.fallback_kem.decapsulate(kem_sk, ct)
                out.append((True, ss, self.fallback_sig.sign(sk, msg_out)))
            return out

        return _run_valid(items, self._dec_valid, dispatch, lambda: (False, b"", b""), 1)

    def _warm_one(self, n: int) -> None:
        """One handshake's three steps at ``n``'s bucket and the live
        offsets, under one fresh signature key: keygen_sign, then
        encaps_verify_sign of its rendered transcripts, then
        decaps_verify_sign."""
        fused, n2 = self.algo, self._bucket(n)
        spk, ssk = fused.sig.generate_keypair()
        init_t = b"w" * (self.pk_off + 2 * fused.kem.public_key_len + 64)
        resp_t = b"w" * (self.ct_off + 2 * fused.kem.ciphertext_len + 64)
        inits = self._kg.warm([(ssk, init_t)] * n2)
        resps = self._enc.warm([(pk, spk, self._render(init_t, pk, self.pk_off), sig, ssk, resp_t)
                                for pk, _, sig in inits])
        self._dec.warm([(ksk, ct, spk, self._render(resp_t, ct, self.ct_off), sig, ssk,
                         b"w" * 128) for (_, ksk, _), (_, ct, _, sig) in zip(inits, resps)])

    async def keygen_sign(self, sig_sk: bytes, template: bytes, lane: int = LANE_HANDSHAKE):
        """-> (kem_pk, kem_sk, sig) for the init step, one device trip."""
        return await self._kg.submit((sig_sk, template), lane)

    async def encaps_verify_sign(self, peer_pk: bytes, peer_sig_pk: bytes, msg_in: bytes,
                                 sig_in: bytes, sig_sk: bytes, template: bytes,
                                 lane: int = LANE_HANDSHAKE):
        """-> (ok, ct, shared_secret, sig) for the response step."""
        return await self._enc.submit((peer_pk, peer_sig_pk, msg_in, sig_in, sig_sk, template),
                                      lane)

    async def decaps_verify_sign(self, kem_sk: bytes, ct: bytes, peer_sig_pk: bytes,
                                 msg_in: bytes, sig_in: bytes, sig_sk: bytes, msg_out: bytes,
                                 lane: int = LANE_HANDSHAKE):
        """-> (ok, shared_secret, sig) for the confirm step."""
        return await self._dec.submit((kem_sk, ct, peer_sig_pk, msg_in, sig_in, sig_sk, msg_out),
                                      lane)

    def stats(self) -> dict[str, Any]:
        return {"keygen_sign": self._kg.stats.as_dict(),
                "encaps_verify_sign": self._enc.stats.as_dict(),
                "decaps_verify_sign": self._dec.stats.as_dict()}


class BatchedAEAD(_Facade):
    """Async facade over a ``BatchedAEADOps`` capability: the data plane.
    Seal and open operations of every live session coalesce into batches
    on two queues (``<name>.seal``, ``<name>.open``), on the bulk lane
    unless the caller names another.

    ``encrypt`` puts the same random 12-byte nonce before ``ciphertext ||
    tag`` that the scalar ``SymmetricAlgorithm.encrypt`` does, and the
    device seal is byte-identical to the scalar one, so a peer cannot tell
    which path sealed a frame.  A message or AAD longer than the device's
    ``max_len`` / ``max_aad_len`` goes to ``scalar`` (the same-name scalar
    provider) on the loop's default executor without enqueueing, counted
    as a bypass by the cost ledger; without ``scalar`` it fails alone with
    a ValueError, as a malformed item does (an open: the same
    "authentication failed" a bad tag gives).  Operands may be
    ``memoryview``s: a frame's bytes go from the wire into the batch rows
    without a copy of their own.

    ``fallback`` (the scalar provider) arms the degrade path: a tripped
    breaker seals and opens on the CPU, with the same bytes.  Without it a
    failed flush raises in every waiter.
    """

    #: the (message, AAD) lengths each warm-up size seals and opens
    warm_shapes = ((256, 256), (1024, 256))

    def __init__(self, device: BatchedAEADOps, scalar: SymmetricAlgorithm | None = None,
                 max_batch: int = 4096, max_wait_ms: float = 2.0,
                 breaker: Breaker | None = None, cooloff_s: float | None = None,
                 bucket_floor: int = 1, scheduler=None,
                 lane_capacity: dict[int, int] | None = None,
                 fallback: SymmetricAlgorithm | None = None, **degrade_opts):
        self.scalar = scalar
        self.fallback = fallback
        self.key_size = device.key_size
        self.nonce_size = device.nonce_size
        self.tag_size = device.tag_size
        super().__init__(device, (self._seal_batch, self._open_batch),
                         (self._seal_fallback, self._open_fallback) if fallback is not None else None,
                         ("seal", "open"), max_batch, max_wait_ms, bucket_floor, lane_capacity,
                         breaker, cooloff_s, scheduler, degrade_opts)
        self._seal, self._open = self._queues

    def _seal_valid(self, it) -> bool:
        key, nonce, pt, aad = it
        return (len(key) == self.key_size and len(nonce) == self.nonce_size
                and len(pt) <= self.algo.max_len and len(aad) <= self.algo.max_aad_len)

    def _open_valid(self, it) -> bool:
        key, nonce, data, aad = it
        return (len(key) == self.key_size and len(nonce) == self.nonce_size
                and self.tag_size <= len(data) <= self.algo.max_len + self.tag_size
                and len(aad) <= self.algo.max_aad_len)

    def _seal_batch(self, device, floor, items):
        def dispatch(valid, tgt):
            keys = _stack(valid, 0, tgt)
            out = device.seal_batch(keys, _stack(valid, 1, tgt), _column(valid, 2, tgt),
                                    _column(valid, 3, tgt))
            wipe(keys)
            return out

        return _run_valid(items, self._seal_valid, dispatch,
                          lambda: ValueError("bad AEAD seal operand"), floor)

    def _open_batch(self, device, floor, items):
        def dispatch(valid, tgt):
            keys = _stack(valid, 0, tgt)
            out = device.open_batch(keys, _stack(valid, 1, tgt), _column(valid, 2, tgt),
                                    _column(valid, 3, tgt))
            wipe(keys)
            return out

        # every malformed input fails as the scalar decrypt's bad tag does
        return _run_valid(items, self._open_valid, dispatch,
                          lambda: ValueError("authentication failed"), floor)

    def _seal_fallback(self, items):
        def dispatch(valid, _tgt):
            return [self.fallback.seal(k, n, bytes(p), bytes(a) or None) for k, n, p, a in valid]

        return _run_valid(items, self._seal_valid, dispatch,
                          lambda: ValueError("bad AEAD seal operand"), 1)

    def _open_fallback(self, items):
        def dispatch(valid, _tgt):
            out = []
            for k, n, d, a in valid:
                try:
                    out.append(self.fallback.open_(k, n, bytes(d), bytes(a) or None))
                except ValueError as e:
                    out.append(ValueError(str(e)))
            return out

        return _run_valid(items, self._open_valid, dispatch,
                          lambda: ValueError("authentication failed"), 1)

    def _warm_one(self, n: int) -> None:
        """Seal, then open, at ``n``'s bucket for each of ``warm_shapes``."""
        n2 = self._bucket(n)
        key, nonce = bytes(self.key_size), bytes(self.nonce_size)
        for msg_len, aad_len in self.warm_shapes:
            aad = bytes(aad_len)
            sealed = self._seal.warm([(key, nonce, bytes(msg_len), aad)] * n2)
            self._open.warm([(key, nonce, frame, aad) for frame in sealed])

    def _bypass(self, op: str, fn, *args):
        """An oversized item on the scalar path, off the loop."""
        if self.cost is not None:
            self.cost.bypass_items(f"{self.name}.{op}", "oversize")
        return asyncio.get_running_loop().run_in_executor(None, functools.partial(fn, *args))

    async def encrypt(self, key: bytes, plaintext, associated_data=None,
                      lane: int = LANE_BULK) -> bytes:
        """-> ``nonce || ciphertext || tag``, as the scalar ``encrypt`` gives."""
        ad = bytes(associated_data) if associated_data else b""
        if self.scalar is not None and (len(plaintext) > self.algo.max_len
                                        or len(ad) > self.algo.max_aad_len):
            return await self._bypass("seal", self.scalar.encrypt, bytes(key), bytes(plaintext),
                                      ad or None)
        nonce = os.urandom(self.nonce_size)
        return nonce + await self._seal.submit((bytes(key), nonce, plaintext, ad), lane)

    async def decrypt(self, key: bytes, data, associated_data=None,
                      lane: int = LANE_BULK) -> bytes:
        """Open ``nonce || ciphertext || tag``; ValueError on failure, as the
        scalar ``decrypt``."""
        if len(data) < self.nonce_size + self.tag_size:
            raise ValueError("ciphertext too short")
        ad = bytes(associated_data) if associated_data else b""
        if self.scalar is not None and (
                len(data) - self.nonce_size - self.tag_size > self.algo.max_len
                or len(ad) > self.algo.max_aad_len):
            return await self._bypass("open", self.scalar.decrypt, bytes(key), bytes(data),
                                      ad or None)
        view = memoryview(data)
        return await self._open.submit((bytes(key), bytes(view[: self.nonce_size]),
                                        view[self.nonce_size:], ad), lane)

    def stats(self) -> dict[str, Any]:
        return {"seal": self._seal.stats.as_dict(), "open": self._open.stats.as_dict()}
