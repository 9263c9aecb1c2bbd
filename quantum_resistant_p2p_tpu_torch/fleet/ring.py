"""Seeded consistent-hash ring: deterministic peer→gateway assignment.

Counterpart of the JAX package's ``fleet/ring.py`` (stdlib only), point
for point: for the same members, vnodes and seed both rings assign every
key alike (tests/test_torch_fleet.py holds them together).

Classic consistent hashing with BOUNDED virtual nodes: each member owns
``vnodes`` points on a 64-bit ring, a key is served by the first member
point clockwise of the key's hash, and — the property the fleet's handoff
story rests on — adding or removing one member moves ONLY the arcs that
member owns (~1/N of the key space), never reshuffling the rest
(tests/test_torch_fleet.py pins this).

Determinism: every point derives from ``sha256(seed:member:vnode)``, so
two processes given the same (seed, membership) compute byte-identical
assignments — the router and any offline tool agree on who owns a peer
without coordination.

The ring tracks MEMBERSHIP only.  Liveness lives one level up
(:class:`.manager.GatewayFleet`'s per-member breakers): routing walks
:meth:`successors` and takes the first member the fleet considers
healthy, so a dead gateway's arc drains to its ring successors and —
because membership never changed — snaps back the moment its breaker
closes again.

Members are plain string ids, so the SAME machinery places every tier:
peer→gateway assignment is the original use, and the replicated control
plane (docs/fleet.md "HA control plane") puts ROUTERS on a ring too —
clients walk ``successors(key)`` over router ids
to pick which replica to ask first and the deterministic failover order
when it is dead, exactly the discipline the data plane already uses.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Iterator

#: default virtual nodes per member: enough for ~±15% arc balance at
#: small fleets while keeping the ring a few hundred points (bounded
#: memory and O(log) lookups, never a point per peer)
DEFAULT_VNODES = 64


def _point(seed: int, data: str) -> int:
    """One deterministic 64-bit ring coordinate."""
    digest = hashlib.sha256(f"{seed}:{data}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


class HashRing:
    """Seeded consistent-hash ring over string member ids."""

    def __init__(self, members: Iterable[str] = (), vnodes: int = DEFAULT_VNODES,
                 seed: int = 0):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self.seed = seed
        self._members: set[str] = set()
        #: sorted, parallel: ring coordinate -> owning member
        self._points: list[int] = []
        self._owners: list[str] = []
        for m in members:
            self.add(m)

    # -- membership -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return member in self._members

    def members(self) -> list[str]:
        return sorted(self._members)

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for v in range(self.vnodes):
            pt = _point(self.seed, f"{member}:{v}")
            idx = bisect.bisect_left(self._points, pt)
            self._points.insert(idx, pt)
            self._owners.insert(idx, member)

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != member]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]

    # -- lookup ---------------------------------------------------------------

    def assign(self, key: str) -> str | None:
        """The member owning ``key``'s ring position (None when empty)."""
        for m in self.successors(key):
            return m
        return None

    def successors(self, key: str) -> Iterator[str]:
        """Distinct members in ring order starting at ``key``'s position —
        the handoff order: index 0 is the owner, index 1 the gateway that
        inherits the arc when the owner dies, and so on."""
        if not self._points:
            return
        start = bisect.bisect_right(self._points, _point(self.seed, key))
        seen: set[str] = set()
        n = len(self._points)
        for i in range(n):
            owner = self._owners[(start + i) % n]
            if owner not in seen:
                seen.add(owner)
                yield owner

    def assignment_counts(self, keys: Iterable[str]) -> dict[str, int]:
        """Keys-per-member histogram (balance diagnostics, docs/fleet.md)."""
        out: dict[str, int] = {m: 0 for m in self._members}
        for k in keys:
            owner = self.assign(k)
            if owner is not None:
                out[owner] += 1
        return out
