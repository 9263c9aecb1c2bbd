"""Async batching queue: the host-to-GPU boundary.

Concurrent callers enqueue their KEM, signature and AEAD operations as
futures; a flush takes up to ``max_batch`` of them, pads the batch to a
power-of-two bucket and runs it as one batched call on the device, then
resolves every future.  A flush happens at ``max_batch`` pending operations
or ``max_wait_ms`` after the first enqueue, whichever comes first.  The
queues of one facade share a :class:`CoalescingHub`, so when one flushes,
its siblings' pending work goes in the same scheduling window.

Every operation rides a priority lane (:data:`LANE_REKEY`,
:data:`LANE_HANDSHAKE`, :data:`LANE_BULK`): a flush takes its operations
in (lane, arrival) order, and a lane at its ``lane_capacity`` sheds new
operations with :class:`LaneShed`.  Each flush is a ``queue.flush`` span on
the loop and a ``device.dispatch`` span on the worker thread
(obs/trace.py); the device call passes the ``device.dispatch`` and
``warmup`` fault points (faults/); a facade's ``cost`` ledger, when one is
attached (obs/cost.py), counts occupancy, device seconds, scalar bypasses
and warm-up compiles.

The device call runs on the facade's one worker thread, so the event loop
never blocks on the GPU and flushes reach the device in order.  A failed
flush raises in every future it carried (an injected fault too): there is
no CPU path to fall back to.

Counterpart of the reference's ``provider/batched.py`` (``OpQueue``,
``QueueStats``, the lanes and ``LaneShed``, ``_run_valid``,
``facade_queues``, ``BatchedKEM``, ``BatchedSignature``, ``BatchedFused``,
``BatchedAEAD`` and their ``warmup``), held to the reference's queue
without a fallback.  Not ported yet: the circuit breaker and the CPU
degrade path, the warm-bucket tracking, the autotuner and the placement
scheduler.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import os
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
    #: device calls made (one batch_fn call on the worker thread a flush)
    device_trips: int = 0
    #: per-flush batch sizes, most recent last (bounded)
    batch_sizes: list[int] = field(default_factory=list)
    #: per-flush latency seen from the event loop (executor wait included)
    dispatch_hist: LatencyHistogram = field(default_factory=LatencyHistogram)
    #: the batch function's own time on the worker thread
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
            "recent_batch_sizes": self.batch_sizes[-16:],
            "avg_batch": (self.ops / self.flushes) if self.flushes else 0.0,
            "avg_dispatch_ms": (
                1e3 * self.total_dispatch_s / self.flushes if self.flushes else 0.0
            ),
            "p50_dispatch_ms": ms(self.dispatch_hist, 50),
            "p99_dispatch_ms": ms(self.dispatch_hist, 99),
            "p50_device_ms": ms(self.device_hist, 50),
            "p99_device_ms": ms(self.device_hist, 99),
            "device_trips": self.device_trips,
            "lanes": {LANE_NAMES.get(k, str(k)): v for k, v in sorted(self.lane_ops.items())},
            "lane_sheds": {LANE_NAMES.get(k, str(k)): v
                           for k, v in sorted(self.lane_sheds.items())},
        }


class CoalescingHub:
    """The queues registered on one hub flush in the same scheduling
    window: when one flushes, every sibling holding items flushes too, so
    independent batches go in flight together instead of one timer window
    apart.  Only queues that already hold items are touched."""

    def __init__(self):
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


class OpQueue:
    """Accumulates (item -> future) pairs; flushes through a batch function.

    ``batch_fn(items) -> list[results]`` is called with at most
    ``max_batch`` items on ``executor``.  A result that is an Exception
    instance fails only its own future; an exception raised by
    ``batch_fn`` (or by an injected device fault) fails every future of
    the flush.  ``label`` names the queue at the fault points and in spans
    and the cost ledger; ``lane_capacity`` maps a lane to its most pending
    operations (absent: unbounded).
    """

    def __init__(self, batch_fn: Callable[[list[Any]], list[Any]],
                 executor: ThreadPoolExecutor, max_batch: int = 4096,
                 max_wait_ms: float = 2.0, hub: CoalescingHub | None = None,
                 bucket_floor: int = 1, label: str = "",
                 lane_capacity: dict[int, int] | None = None):
        self.label = label
        self.batch_fn = batch_fn
        self.executor = executor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        #: flushes pad up to at least this power of two (the cost ledger's
        #: padded slots)
        self.bucket_floor = min(next_pow2(max(1, bucket_floor)), max_batch)
        self.hub = hub if hub is not None else CoalescingHub()
        self.hub.register_queue(self)
        self.stats = QueueStats()
        self.lane_capacity = lane_capacity
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
            self._timer = loop.call_later(self.max_wait_s, self._flush_soon)
        if len(self._items) >= self.max_batch:
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

    def _traced_call(self, fn, route: str, parent, items: list[Any]) -> list[Any]:
        """Run one device call inside a ``device.dispatch`` span ON the
        worker thread, so the span measures the call itself and carries the
        worker's thread lane.  ``parent`` is the loop-side context captured
        before the executor hop (contextvars do not cross it).  Only a
        flush's call (route "direct") feeds ``device_hist`` and the
        ledger's device seconds; a warm-up's does not."""
        with obs_trace.span("device.dispatch", parent=parent, op=self.label, n=len(items),
                            route=route):
            t0 = time.perf_counter()
            try:
                return fn(items)
            finally:
                if route != "warmup":
                    dt = time.perf_counter() - t0
                    self.stats.device_hist.record(dt)
                    if self.cost is not None:
                        self.cost.device_time(self.label, dt)

    def _device_call(self, lane: int, items: list[Any]) -> list[Any]:
        """The device dispatch boundary: the fault points wrap the real
        batch function, a raise at the first failing the whole flush, a
        poisoned slot only its own future.  The flush's lane rides into the
        fault-match info (match={"lane": "bulk"})."""
        _faults.device_dispatch(self.label, len(items), shard=None, lane=LANE_NAMES.get(lane))
        return _faults.poison_results(self.label, self.batch_fn(items))

    def _warm_call(self, items: list[Any]) -> list[Any]:
        """The warm-up boundary (fault scope "warmup": a killed warm-up
        surfaces as this call raising)."""
        _faults.warmup(self.label)
        return self.batch_fn(items)

    def warm(self, items: list[Any]) -> list[Any]:
        """Run the batch function once on ``items`` on the worker thread,
        through the warm-up fault point and in a ``device.dispatch`` span
        of route "warmup"; block until it is done and return its results.
        An item whose result is an Exception raises it.  The facades'
        ``warmup`` calls this; it is not a flush and counts none."""
        out = self.executor.submit(self._traced_call, self._warm_call, "warmup",
                                   obs_trace.current(), items).result()
        for r in out:
            if isinstance(r, Exception):
                raise r
        return out

    def _cost_occupancy(self, items: list[Any], lane: int) -> None:
        """Ledger hook for one flush: real items vs the padded bucket the
        batch function dispatches."""
        if self.cost is None:
            return
        self.cost.flush_occupancy(self.label, LANE_NAMES.get(lane, str(lane)), len(items),
                                  max(self.bucket_floor, next_pow2(len(items))))

    async def _run_batch(self, items: list[Any], lane: int) -> list[Any]:
        self.stats.device_trips += 1
        self._cost_occupancy(items, lane)
        return await asyncio.get_running_loop().run_in_executor(
            self.executor, self._traced_call, functools.partial(self._device_call, lane),
            "direct", obs_trace.current(), items)

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
                                waited_ms=round(1e3 * (t0 - first_t), 3)):
                results = await self._run_batch(items, lane)
            dt = time.perf_counter() - t0
            self.stats.total_dispatch_s += dt
            self.stats.dispatch_hist.record(dt)
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


class _Facade:
    """Queues of one algorithm's batch functions on one hub and one device
    thread.

    ``ops`` names each queue: its label is ``f"{name}.{op}"``.
    ``bucket_floor`` raises every padded batch to at least that power of
    two; ``lane_capacity`` bounds each lane's pending operations in every
    queue.  Call :meth:`close` (or use ``with``) to stop the worker
    thread.
    """

    def __init__(self, algo, batch_fns, ops, max_batch: int, max_wait_ms: float,
                 bucket_floor: int, lane_capacity: dict[int, int] | None):
        self.algo = algo
        self.name = algo.name
        self.bucket_floor = min(next_pow2(max(1, bucket_floor)), max_batch)
        #: device-cost ledger (obs/cost.py): warm-up compile attribution
        self.cost = None
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix=f"{algo.name}-device")
        hub = CoalescingHub()
        self._queues = [OpQueue(lambda items, fn=fn: fn(algo, self.bucket_floor, items),
                                self._executor, max_batch, max_wait_ms, hub, self.bucket_floor,
                                f"{algo.name}.{op}", lane_capacity)
                        for fn, op in zip(batch_fns, ops)]

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
        """Wait for in-flight flushes and stop the device thread."""
        self._executor.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BatchedKEM(_Facade):
    """Async facade over a KeyExchangeAlgorithm's batch operations: three
    queues (keygen, encaps, decaps), labelled ``<name>.kg``, ``.enc`` and
    ``.dec``."""

    def __init__(self, algo: KeyExchangeAlgorithm, max_batch: int = 4096,
                 max_wait_ms: float = 2.0, bucket_floor: int = 1,
                 lane_capacity: dict[int, int] | None = None):
        super().__init__(algo, (self._kg_batch, self._enc_batch, self._dec_batch),
                         ("kg", "enc", "dec"), max_batch, max_wait_ms, bucket_floor,
                         lane_capacity)
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
    future it carried, verify included."""

    def __init__(self, algo: SignatureAlgorithm, max_batch: int = 4096,
                 max_wait_ms: float = 2.0, bucket_floor: int = 1,
                 lane_capacity: dict[int, int] | None = None):
        super().__init__(algo, (self._sign_batch, self._verify_batch), ("sign", "verify"),
                         max_batch, max_wait_ms, bucket_floor, lane_capacity)
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
    contract: most of their fields come from the peer).  A failed flush
    raises in every waiter: there is no CPU path to fall back to.
    """

    def __init__(self, fused: FusedHandshakeOps, pk_off: int, ct_off: int,
                 max_batch: int = 4096, max_wait_ms: float = 2.0, bucket_floor: int = 1,
                 lane_capacity: dict[int, int] | None = None):
        self.pk_off = pk_off
        self.ct_off = ct_off
        super().__init__(fused, (self._kg_batch, self._enc_batch, self._dec_batch),
                         ("keygen_sign", "encaps_verify_sign", "decaps_verify_sign"), max_batch,
                         max_wait_ms, bucket_floor, lane_capacity)
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
    "authentication failed" a bad tag gives).  A failed flush raises in
    every waiter.  Operands may be ``memoryview``s.
    """

    #: the (message, AAD) lengths each warm-up size seals and opens
    warm_shapes = ((256, 256), (1024, 256))

    def __init__(self, device: BatchedAEADOps, scalar: SymmetricAlgorithm | None = None,
                 max_batch: int = 4096, max_wait_ms: float = 2.0, bucket_floor: int = 1,
                 lane_capacity: dict[int, int] | None = None):
        self.scalar = scalar
        self.key_size = device.key_size
        self.nonce_size = device.nonce_size
        self.tag_size = device.tag_size
        super().__init__(device, (self._seal_batch, self._open_batch), ("seal", "open"),
                         max_batch, max_wait_ms, bucket_floor, lane_capacity)
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
