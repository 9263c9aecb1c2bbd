"""Device operand cache: per-key precompute kept on the device.

Encaps against a key spends most of its sampling work on that key alone
(ExpandA, the t_hat decode, H(ek)), and so do sign and verify (ExpandA and
the key NTTs).  A node encapsulates against hot peer keys, signs with its
one key and verifies a peer's again and again, so the cache keeps
``kem.mlkem.precompute_ek``'s and ``sig.mldsa.precompute_sk/pk``'s
tensors on the device, keyed by SHA-256 of the raw key bytes, with LRU
eviction so peer churn cannot pin unbounded device memory.  Raw key bytes
never appear in stats.

Lookups and inserts take a lock (queues dispatch from an executor thread).
The miss path computes outside the lock, so two threads racing on one cold
key may both compute; the second insert wins with an identical value.
With a cost ledger attached (:meth:`DeviceOperandCache.attach_cost`),
every lookup is a hit or miss event in its sliding window; releasing the
entries is a flight-recorder event.

Entries are partitioned by placement shard (:func:`shard_scope`, entered
by ``provider.scheduler.Shard.placement`` on the dispatching thread), so
tensors cached for one shard's device are never fed to a program placed
on another; the LRU capacity is shared across shards.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import threading
from collections import OrderedDict
from typing import Any

from ..obs import flight as obs_flight
from ..utils.wipe import wipe


#: keys whose device state a provider's cache keeps (LRU)
OPCACHE_KEYS = 8

#: the placement shard of the current dispatch (0: the one-device world)
_SHARD: contextvars.ContextVar[int] = contextvars.ContextVar("qrp2p_opcache_shard", default=0)


@contextlib.contextmanager
def shard_scope(index: int):
    """Namespace operand-cache lookups and inserts to placement shard
    ``index`` for the duration of the block."""
    token = _SHARD.set(index)
    try:
        yield
    finally:
        _SHARD.reset(token)


def current_shard() -> int:
    """The active placement scope."""
    return _SHARD.get()


class DeviceOperandCache:
    """Content-hash-keyed LRU of per-key dicts of device tensors,
    partitioned by placement shard (:func:`shard_scope`)."""

    def __init__(self, capacity: int = OPCACHE_KEYS):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple[str, int, bytes], Any] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        #: cost-ledger feed (obs/cost.py): None records nothing extra
        self._cost = None
        self._cost_kind = ""

    def attach_cost(self, ledger, kind: str) -> None:
        """Feed hit/miss events into a :class:`obs.cost.CostLedger` under
        cache label ``kind`` ("kem" / "sig")."""
        self._cost = ledger
        self._cost_kind = kind

    @staticmethod
    def _key(kind: str, key_bytes: bytes) -> tuple[str, int, bytes]:
        return (kind, _SHARD.get(), hashlib.sha256(key_bytes).digest())

    def lookup(self, kind: str, key_bytes: bytes) -> Any | None:
        """Cached state or None.  A lookup/put split rather than a
        compute-on-miss callback: the providers' miss path computes the op
        and the precompute together (``mlkem.encaps_cold``) and needs both."""
        k = self._key(kind, bytes(key_bytes))
        with self._lock:
            if k in self._entries:
                self._entries.move_to_end(k)
                self.hits += 1
                hit, out = True, self._entries[k]
            else:
                self.misses += 1
                hit, out = False, None
        if self._cost is not None:
            # outside the lock: the ledger takes its own
            self._cost.opcache_event(self._cost_kind, hit)
        return out

    def put(self, kind: str, key_bytes: bytes, val: Any) -> None:
        k = self._key(kind, bytes(key_bytes))
        with self._lock:
            self._entries[k] = val
            self._entries.move_to_end(k)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def zeroize(self) -> int:
        """Zero every cached tensor in place on its device, then drop the
        entries; returns how many were released."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for val in entries:
            wipe(*val.values())
        # key-lifetime events belong in the flight ring (counts only,
        # never key identities)
        obs_flight.record("opcache_zeroized", entries=len(entries))
        return len(entries)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }
