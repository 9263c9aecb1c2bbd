"""Async batching queue: the host-to-GPU boundary.

Concurrent callers enqueue their KEM operations as futures; a flush takes
up to ``max_batch`` of them, pads the batch to a power-of-two bucket and
runs it as one batched call on the device, then resolves every future.  A
flush happens at ``max_batch`` pending operations or ``max_wait_ms`` after
the first enqueue, whichever comes first.  The queues of one facade share a
:class:`CoalescingHub`, so when one flushes, its siblings' pending work
goes in the same scheduling window.

The device call runs on the facade's one worker thread, so the event loop
never blocks on the GPU and flushes reach the device in order.  A failed
flush raises in every future it carried: there is no CPU path to fall back
to.

Counterpart of the reference's ``provider/batched.py`` (``OpQueue``,
``QueueStats``, ``_run_valid``, ``BatchedKEM``) without its circuit
breaker, CPU degrade path, warm-bucket tracking, autotuner, priority lanes,
placement scheduler and fault hooks.
"""

from __future__ import annotations

import asyncio
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..obs.metrics import LatencyHistogram
from ..utils.wipe import wipe
from .base import KeyExchangeAlgorithm, next_pow2, pad_rows


@dataclass
class QueueStats:
    """Per-queue counters."""

    ops: int = 0
    flushes: int = 0
    max_batch_seen: int = 0
    total_dispatch_s: float = 0.0
    #: per-flush batch sizes, most recent last (bounded)
    batch_sizes: list[int] = field(default_factory=list)
    #: per-flush latency seen from the event loop (executor wait included)
    dispatch_hist: LatencyHistogram = field(default_factory=LatencyHistogram)
    #: the batch function's own time on the worker thread
    device_hist: LatencyHistogram = field(default_factory=LatencyHistogram)
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
    ``batch_fn`` fails every future of the flush.
    """

    def __init__(self, batch_fn: Callable[[list[Any]], list[Any]],
                 executor: ThreadPoolExecutor, max_batch: int = 4096,
                 max_wait_ms: float = 2.0, hub: CoalescingHub | None = None):
        self.batch_fn = batch_fn
        self.executor = executor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.hub = hub if hub is not None else CoalescingHub()
        self.hub.register_queue(self)
        self.stats = QueueStats()
        self._items: list[Any] = []
        self._futures: list[asyncio.Future] = []
        self._timer: asyncio.TimerHandle | None = None
        #: strong refs to in-flight flush tasks (the loop holds them weakly)
        self._dispatch_tasks: set[asyncio.Task] = set()

    async def submit(self, item: Any) -> Any:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._items.append(item)
        self._futures.append(fut)
        self.stats.ops += 1
        if len(self._items) == 1:
            self._timer = loop.call_later(self.max_wait_s, self._flush_soon)
        if len(self._items) >= self.max_batch:
            self._flush_soon()
        return await fut

    def _flush_soon(self) -> None:
        self._flush_local()
        self.hub.coalesce(self)

    def _flush_local(self) -> None:
        """Detach pending items synchronously (so late submits cannot bloat
        a batch past max_batch) and dispatch them as tasks."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        loop = asyncio.get_running_loop()
        while self._items:
            k = min(self.max_batch, len(self._items))
            items, futs = self._items[:k], self._futures[:k]
            del self._items[:k], self._futures[:k]
            task = loop.create_task(self._dispatch(items, futs))
            self._dispatch_tasks.add(task)
            task.add_done_callback(self._dispatch_tasks.discard)

    def _timed_call(self, items: list[Any]) -> list[Any]:
        """The batch function on the worker thread, timed there."""
        with self.stats.device_hist.time():
            return self.batch_fn(items)

    async def _dispatch(self, items: list[Any], futs: list[asyncio.Future]) -> None:
        self.stats.flushes += 1
        self.stats.max_batch_seen = max(self.stats.max_batch_seen, len(items))
        self.stats.batch_sizes.append(len(items))
        del self.stats.batch_sizes[: -QueueStats.BATCH_SIZE_HISTORY]
        t0 = time.perf_counter()
        try:
            results = await asyncio.get_running_loop().run_in_executor(
                self.executor, self._timed_call, items)
        except Exception as exc:  # the flush failed: every waiter gets it
            for f in futs:
                if not f.cancelled():
                    f.set_exception(exc)
            return
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


class BatchedKEM:
    """Async facade over a KeyExchangeAlgorithm's batch operations: three
    queues (keygen, encaps, decaps) on one hub and one device thread.

    ``bucket_floor`` raises every padded batch to at least that power of
    two.  Call :meth:`close` (or use ``with``) to stop the worker thread.
    """

    def __init__(self, algo: KeyExchangeAlgorithm, max_batch: int = 4096,
                 max_wait_ms: float = 2.0, bucket_floor: int = 1):
        self.algo = algo
        self.bucket_floor = min(next_pow2(max(1, bucket_floor)), max_batch)
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix=f"{algo.name}-device")
        hub = CoalescingHub()
        self._kg, self._enc, self._dec = (
            OpQueue(lambda items, fn=fn: fn(algo, self.bucket_floor, items),
                    self._executor, max_batch, max_wait_ms, hub)
            for fn in (self._kg_batch, self._enc_batch, self._dec_batch)
        )

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
            sks = pad_rows(np.stack([np.frombuffer(sk, np.uint8) for sk, _ in valid]), tgt)
            cts = pad_rows(np.stack([np.frombuffer(ct, np.uint8) for _, ct in valid]), tgt)
            sss = algo.decapsulate_batch(sks, cts)
            out = [bytes(ss) for ss in sss]
            wipe(sks, sss)
            return out

        return _run_valid(
            items,
            lambda it: len(it[0]) == algo.secret_key_len and len(it[1]) == algo.ciphertext_len,
            dispatch, lambda: ValueError("bad secret-key/ciphertext length"), floor)

    async def generate_keypair(self) -> tuple[bytes, bytes]:
        return await self._kg.submit(None)

    async def encapsulate(self, public_key: bytes) -> tuple[bytes, bytes]:
        return await self._enc.submit(public_key)

    async def decapsulate(self, secret_key: bytes, ciphertext: bytes) -> bytes:
        return await self._dec.submit((secret_key, ciphertext))

    def stats(self) -> dict[str, Any]:
        return {
            "keygen": self._kg.stats.as_dict(),
            "encaps": self._enc.stats.as_dict(),
            "decaps": self._dec.stats.as_dict(),
        }

    def close(self) -> None:
        """Wait for in-flight flushes and stop the device thread."""
        self._executor.shutdown(wait=True)

    def __enter__(self) -> BatchedKEM:
        return self

    def __exit__(self, *exc) -> None:
        self.close()
