"""Async batching queue: the host-to-GPU boundary.

Concurrent callers enqueue their KEM and signature operations as futures;
a flush takes up to ``max_batch`` of them, pads the batch to a power-of-two
bucket and runs it as one batched call on the device, then resolves every
future.  A
flush happens at ``max_batch`` pending operations or ``max_wait_ms`` after
the first enqueue, whichever comes first.  The queues of one facade share a
:class:`CoalescingHub`, so when one flushes, its siblings' pending work
goes in the same scheduling window.

The device call runs on the facade's one worker thread, so the event loop
never blocks on the GPU and flushes reach the device in order.  A failed
flush raises in every future it carried: there is no CPU path to fall back
to.

Counterpart of the reference's ``provider/batched.py`` (``OpQueue``,
``QueueStats``, ``_run_valid``, ``BatchedKEM``, ``BatchedSignature``,
``BatchedFused``, ``BatchedAEAD``) without its circuit breaker, CPU degrade
path, warm-bucket tracking and warm-up, autotuner, priority lanes,
placement scheduler and fault hooks.
"""

from __future__ import annotations

import asyncio
import os
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ..obs.metrics import LatencyHistogram
from ..utils.wipe import wipe
from .base import (BatchedAEADOps, FusedHandshakeOps, KeyExchangeAlgorithm, SignatureAlgorithm,
                   next_pow2, pad_rows)


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


def _stack(items, idx: int, tgt: int) -> np.ndarray:
    """Field ``idx`` of each item as uint8 rows, padded to ``tgt`` rows."""
    return pad_rows(np.stack([np.frombuffer(it[idx], np.uint8) for it in items]), tgt)


def _column(items, idx: int, tgt: int) -> list:
    """Field ``idx`` of each item, the last repeated up to ``tgt``."""
    return [it[idx] for it in items] + [items[-1][idx]] * (tgt - len(items))


class _Facade:
    """Queues of one algorithm's batch functions on one hub and one device
    thread.

    ``bucket_floor`` raises every padded batch to at least that power of
    two.  Call :meth:`close` (or use ``with``) to stop the worker thread.
    """

    def __init__(self, algo, batch_fns, max_batch: int, max_wait_ms: float,
                 bucket_floor: int):
        self.algo = algo
        self.bucket_floor = min(next_pow2(max(1, bucket_floor)), max_batch)
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix=f"{algo.name}-device")
        hub = CoalescingHub()
        self._queues = [OpQueue(lambda items, fn=fn: fn(algo, self.bucket_floor, items),
                                self._executor, max_batch, max_wait_ms, hub)
                        for fn in batch_fns]

    def close(self) -> None:
        """Wait for in-flight flushes and stop the device thread."""
        self._executor.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BatchedKEM(_Facade):
    """Async facade over a KeyExchangeAlgorithm's batch operations: three
    queues (keygen, encaps, decaps)."""

    def __init__(self, algo: KeyExchangeAlgorithm, max_batch: int = 4096,
                 max_wait_ms: float = 2.0, bucket_floor: int = 1):
        super().__init__(algo, (self._kg_batch, self._enc_batch, self._dec_batch),
                         max_batch, max_wait_ms, bucket_floor)
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


class BatchedSignature(_Facade):
    """Async facade over a SignatureAlgorithm's batch operations: two
    queues (sign, verify).

    An item of the wrong key or signature length fails alone: a sign with
    a ValueError, a verify with False.  A failed flush raises in every
    future it carried, verify included."""

    def __init__(self, algo: SignatureAlgorithm, max_batch: int = 4096,
                 max_wait_ms: float = 2.0, bucket_floor: int = 1):
        super().__init__(algo, (self._sign_batch, self._verify_batch), max_batch,
                         max_wait_ms, bucket_floor)
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

    async def sign(self, secret_key: bytes, message: bytes) -> bytes:
        return await self._sign.submit((secret_key, message))

    async def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        return await self._verify.submit((public_key, message, signature))

    def stats(self) -> dict[str, Any]:
        return {"sign": self._sign.stats.as_dict(), "verify": self._verify.stats.as_dict()}


class BatchedFused(_Facade):
    """Async facade over a ``FusedHandshakeOps`` capability: three queues
    (keygen+sign, verify+encaps+sign, verify+decaps+sign), so a handshake
    step's KEM op, transcript hash and signature op are one device trip.

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
                 max_batch: int = 4096, max_wait_ms: float = 2.0, bucket_floor: int = 1):
        self.name = fused.name
        self.pk_off = pk_off
        self.ct_off = ct_off
        super().__init__(fused, (self._kg_batch, self._enc_batch, self._dec_batch), max_batch,
                         max_wait_ms, bucket_floor)
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

    async def keygen_sign(self, sig_sk: bytes, template: bytes):
        """-> (kem_pk, kem_sk, sig) for the init step, one device trip."""
        return await self._kg.submit((sig_sk, template))

    async def encaps_verify_sign(self, peer_pk: bytes, peer_sig_pk: bytes, msg_in: bytes,
                                 sig_in: bytes, sig_sk: bytes, template: bytes):
        """-> (ok, ct, shared_secret, sig) for the response step."""
        return await self._enc.submit((peer_pk, peer_sig_pk, msg_in, sig_in, sig_sk, template))

    async def decaps_verify_sign(self, kem_sk: bytes, ct: bytes, peer_sig_pk: bytes,
                                 msg_in: bytes, sig_in: bytes, sig_sk: bytes, msg_out: bytes):
        """-> (ok, shared_secret, sig) for the confirm step."""
        return await self._dec.submit((kem_sk, ct, peer_sig_pk, msg_in, sig_in, sig_sk, msg_out))

    def stats(self) -> dict[str, Any]:
        return {"keygen_sign": self._kg.stats.as_dict(),
                "encaps_verify_sign": self._enc.stats.as_dict(),
                "decaps_verify_sign": self._dec.stats.as_dict()}


class BatchedAEAD(_Facade):
    """Async facade over a ``BatchedAEADOps`` capability: the data plane.
    Seal and open operations of every live session coalesce into batches.

    ``encrypt`` puts the same random 12-byte nonce before ``ciphertext ||
    tag`` that the scalar ``SymmetricAlgorithm.encrypt`` does, and the
    device seal is byte-identical to the scalar one, so a peer cannot tell
    which path sealed a frame.  An item that is malformed or longer than
    the device's ``max_len`` / ``max_aad_len`` fails alone with a
    ValueError (an open: the same "authentication failed" a bad tag gives);
    a failed flush raises in every waiter.  Operands may be ``memoryview``s.
    """

    def __init__(self, device: BatchedAEADOps, max_batch: int = 4096, max_wait_ms: float = 2.0,
                 bucket_floor: int = 1):
        self.name = device.name
        self.key_size = device.key_size
        self.nonce_size = device.nonce_size
        self.tag_size = device.tag_size
        super().__init__(device, (self._seal_batch, self._open_batch), max_batch, max_wait_ms,
                         bucket_floor)
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

    async def encrypt(self, key: bytes, plaintext, associated_data=None) -> bytes:
        """-> ``nonce || ciphertext || tag``, as the scalar ``encrypt`` gives."""
        nonce = os.urandom(self.nonce_size)
        ad = bytes(associated_data) if associated_data else b""
        return nonce + await self._seal.submit((bytes(key), nonce, plaintext, ad))

    async def decrypt(self, key: bytes, data, associated_data=None) -> bytes:
        """Open ``nonce || ciphertext || tag``; ValueError on failure, as the
        scalar ``decrypt``."""
        if len(data) < self.nonce_size + self.tag_size:
            raise ValueError("ciphertext too short")
        view = memoryview(data)
        ad = bytes(associated_data) if associated_data else b""
        return await self._open.submit((bytes(key), bytes(view[: self.nonce_size]),
                                        view[self.nonce_size:], ad))

    def stats(self) -> dict[str, Any]:
        return {"seal": self._seal.stats.as_dict(), "open": self._open.stats.as_dict()}
