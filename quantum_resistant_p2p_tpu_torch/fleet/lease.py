"""Leader lease for the replicated router control plane.

Counterpart of the JAX package's ``fleet/lease.py`` (stdlib only): the
same state machine, so the same injected clock and frames give both the
same transition log (tests/test_torch_fleet.py).

One router must hold STEK-rotation and admission-budget *authority* at a
time; every other router follows and can take over without losing the
ticket accept window.  This module is the PURE state machine for that
decision — no sockets, no tasks, no wall clock.  The router layer
(fleet/manager.py) feeds it observed claim/renew frames and asks it when
to claim; everything here is deterministic given the injected clock, so
tests drive failovers tick by tick (tests/test_torch_fleet_ha.py pins
seeded determinism on two independently-clocked replicas).

Design, in the shape the rest of the repo already uses:

- **Monotonic epochs.**  A claim always uses ``max_seen_epoch + 1`` —
  the same only-forward discipline as the STEK ring's rotation epochs.
  Two routers racing a claim produce distinct epochs only if one saw the
  other's frame; if neither did, the tie breaks on (epoch, holder-id)
  ordering when the frames cross, and the loser demotes loudly.
- **Relative TTLs on injectable clocks.**  Frames carry ``ttl_s``, never
  absolute deadlines — each replica arms ``now() + ttl_s`` on ITS clock,
  so bounded clock skew shifts the window but never inverts it.
- **Rank-staggered claims.**  When a lease expires, the replica with the
  lowest live rank claims first (``rank * claim_stagger_s`` delay), so
  failover is deterministic under seeded tests instead of a thundering
  herd: rt0 dies → rt1 claims at one stagger, rt2 would claim at two.
- **Stale-lease fencing.**  Any frame carrying ``epoch < max_seen`` is
  rejected (the caller replies ``__rt_reject__``), and a leader that
  *receives* such a reject — proof a newer lease exists — demotes
  immediately instead of split-braining.  "Demoted" is a distinct,
  loudly-reported role, not a silent fallback to follower.

The transition log (``(t, from_role, to_role, epoch, reason)`` tuples)
is the seam the determinism test pins: same clocks + same observed
frames ⇒ byte-identical logs.
"""

from __future__ import annotations

import time
from typing import Any, Callable

__all__ = ["LeaderLease", "FOLLOWER", "LEADER", "DEMOTED"]

FOLLOWER = "follower"
LEADER = "leader"
DEMOTED = "demoted"

#: default lease time-to-live: a leader that misses ~2 renew intervals
#: loses the lease (renew cadence is ttl/3 — see :meth:`renew_due`)
DEFAULT_TTL_S = 1.5
#: per-rank claim stagger after expiry: rank r waits r * stagger before
#: claiming, so the lowest live rank wins deterministically
DEFAULT_CLAIM_STAGGER_S = 0.25


class LeaderLease:
    """One replica's view of the fleet-wide leader lease.

    ``node_id`` names this replica in claim frames; ``rank`` orders the
    claim stagger (rank 0 claims first — by convention the spawn index).
    ``clock`` is any monotonic ``() -> float``; tests inject fakes.
    """

    def __init__(self, node_id: str, rank: int, *,
                 ttl_s: float = DEFAULT_TTL_S,
                 claim_stagger_s: float = DEFAULT_CLAIM_STAGGER_S,
                 clock: Callable[[], float] = time.monotonic):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        if rank < 0:
            raise ValueError(f"rank must be >= 0, got {rank}")
        self.node_id = node_id
        self.rank = int(rank)
        self.ttl_s = float(ttl_s)
        self.claim_stagger_s = float(claim_stagger_s)
        self._clock = clock
        #: highest lease epoch this replica has ever seen (claims go
        #: max_seen + 1; anything below max_seen is fenced as stale)
        self.max_seen_epoch = 0
        #: who holds the current lease, per this replica's view
        self.holder: str | None = None
        #: local deadline for the current lease.  Born one full TTL in
        #: the future — the birth grace: a freshly (re)started replica
        #: must assume a leader might exist and stay quiet until a whole
        #: TTL passes with no renewal, or every respawn would claim a
        #: stale epoch, get fenced, and come up demoted for nothing
        self.expires_at = self._clock() + self.ttl_s
        self.role = FOLLOWER
        #: append-only transition log — the determinism pin
        self.transitions: list[tuple[float, str, str, int, str]] = []
        #: stale frames fenced (mirrored into router stats)
        self.stale_rejects = 0

    # -- introspection ---------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self.role == LEADER

    @property
    def epoch(self) -> int:
        """The lease epoch in force (0 before any claim was ever seen)."""
        return self.max_seen_epoch

    def lease_expired(self, now: float | None = None) -> bool:
        now = self._clock() if now is None else now
        return now >= self.expires_at

    def view(self) -> dict[str, Any]:
        """Snapshot for ``/fleet`` + heartbeats (obs surface)."""
        return {
            "role": self.role,
            "epoch": self.max_seen_epoch,
            "holder": self.holder,
            "node": self.node_id,
            "rank": self.rank,
            "ttl_s": self.ttl_s,
            "expires_in_s": round(max(0.0, self.expires_at - self._clock()), 3),
            "stale_rejects": self.stale_rejects,
            "transitions": len(self.transitions),
        }

    # -- transitions -----------------------------------------------------------

    def _move(self, to_role: str, epoch: int, reason: str) -> None:
        if to_role != self.role:
            self.transitions.append(
                (round(self._clock(), 6), self.role, to_role, epoch, reason))
            self.role = to_role

    # -- the claim side (this replica wants the lease) -------------------------

    def claim_due(self, now: float | None = None) -> bool:
        """Should this replica claim NOW?  True once the current lease
        has been expired for this replica's rank-staggered delay.  A
        demoted replica never claims again without an explicit
        :meth:`rejoin` — demotion is loud and sticky by design."""
        if self.role == DEMOTED:
            return False
        if self.role == LEADER:
            return False
        now = self._clock() if now is None else now
        return now >= self.expires_at + self.rank * self.claim_stagger_s

    def claim(self) -> dict[str, Any]:
        """Take the lease: bump the epoch past everything seen and become
        leader.  Returns the claim frame body (epoch + relative ttl) the
        caller broadcasts as ``__rt_lease__``."""
        self.max_seen_epoch += 1
        self.holder = self.node_id
        self.expires_at = self._clock() + self.ttl_s
        self._move(LEADER, self.max_seen_epoch, "claimed")
        return {"holder": self.node_id, "epoch": self.max_seen_epoch,
                "ttl_s": self.ttl_s}

    def renew_due(self, now: float | None = None) -> bool:
        """A leader renews at ttl/3 cadence — two missed renewals still
        leave a third before followers see expiry."""
        if self.role != LEADER:
            return False
        now = self._clock() if now is None else now
        return now >= self.expires_at - (2.0 * self.ttl_s) / 3.0

    def renew(self) -> dict[str, Any]:
        """Extend our own lease (same epoch — renewal, not re-claim)."""
        if self.role != LEADER:
            raise RuntimeError(f"{self.node_id}: renew as {self.role}")
        self.expires_at = self._clock() + self.ttl_s
        return {"holder": self.node_id, "epoch": self.max_seen_epoch,
                "ttl_s": self.ttl_s}

    # -- the observe side (frames from peer replicas) --------------------------

    def observe(self, holder: str, epoch: int,
                ttl_s: float | None = None) -> bool:
        """Fold a peer's claim/renew frame in.  Returns True when the
        frame is accepted (fresh), False when it is STALE — the caller
        must then reply ``__rt_reject__`` carrying OUR epoch so the
        stale sender demotes (fencing, both directions).

        A frame at our exact epoch from the holder we already track is a
        renewal; a frame at our epoch from a DIFFERENT holder is a tied
        race — broken on holder id (lexicographically smallest wins, the
        same total order the ring uses for member ids) so both sides
        converge without a third arbiter.
        """
        epoch = int(epoch)
        ttl = self.ttl_s if ttl_s is None else float(ttl_s)
        if epoch < self.max_seen_epoch:
            self.stale_rejects += 1
            return False
        if epoch == self.max_seen_epoch and self.holder is not None:
            if holder != self.holder:
                # tied claim race: deterministic total order, no arbiter
                if min(holder, self.holder) != holder:
                    self.stale_rejects += 1
                    return False
            elif holder == self.node_id:
                # our own frame echoed back — nothing to fold in
                return True
        if epoch > self.max_seen_epoch or holder != self.holder:
            if self.role == LEADER and holder != self.node_id:
                # someone else provably holds a fresher lease: split-brain
                # averted by stepping down loudly, never by ignoring it
                self._move(DEMOTED, epoch, f"superseded_by={holder}")
            elif self.role == FOLLOWER:
                self._move(FOLLOWER, epoch, f"adopted={holder}")
        self.max_seen_epoch = epoch
        self.holder = holder
        self.expires_at = self._clock() + ttl
        return True

    def observe_reject(self, epoch: int) -> bool:
        """A peer fenced one of OUR authority frames as stale, telling us
        a lease at ``epoch`` exists.  If we thought we were leader, that
        is proof of split-brain: demote loudly.  Returns True when a
        demotion happened (the caller flight-records it)."""
        epoch = int(epoch)
        if epoch > self.max_seen_epoch:
            self.max_seen_epoch = epoch
        if self.role == LEADER:
            self._move(DEMOTED, epoch, "fenced_by_peer")
            self.holder = None
            return True
        return False

    def rejoin(self) -> None:
        """Operator/respawn path: a demoted replica re-enters as a plain
        follower (a router process restart constructs a fresh lease, so
        this mainly serves tests and the in-task router fleet)."""
        if self.role == DEMOTED:
            self._move(FOLLOWER, self.max_seen_epoch, "rejoined")
