"""Device operand cache: per-key precompute kept on the device.

Encaps against a key spends most of its sampling work on that key alone
(ExpandA, the t_hat decode, H(ek)).  A node encapsulates against hot peer
keys again and again, so the cache keeps ``kem.mlkem.precompute_ek``'s
tensors on the device, keyed by SHA-256 of the raw key bytes, with LRU
eviction so peer churn cannot pin unbounded device memory.  Raw key bytes
never appear in stats.

Lookups and inserts take a lock (queues dispatch from an executor thread).
The miss path computes outside the lock, so two threads racing on one cold
key may both compute; the second insert wins with an identical value.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any

from ..utils.wipe import wipe


class DeviceOperandCache:
    """Content-hash-keyed LRU of per-key dicts of device tensors."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple[str, bytes], Any] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _key(kind: str, key_bytes: bytes) -> tuple[str, bytes]:
        return (kind, hashlib.sha256(key_bytes).digest())

    def lookup(self, kind: str, key_bytes: bytes) -> Any | None:
        """Cached state or None.  A lookup/put split rather than a
        compute-on-miss callback: the providers' miss path computes the op
        and the precompute together (``mlkem.encaps_cold``) and needs both."""
        k = self._key(kind, bytes(key_bytes))
        with self._lock:
            if k in self._entries:
                self._entries.move_to_end(k)
                self.hits += 1
                return self._entries[k]
            self.misses += 1
            return None

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
