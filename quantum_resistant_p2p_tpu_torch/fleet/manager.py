"""GatewayFleet: N gateway processes behind a peer-routing tier, with
gateway death as the first-class case (docs/fleet.md).

Counterpart of the JAX package's ``fleet/manager.py``, method for method,
over the port's breaker, placement policy, STEK ring, fault plan and
observability layer.  It differs in two places: a ``spawn="process"``
gateway runs ``python -m quantum_resistant_p2p_tpu_torch.fleet.gateway``,
and ``providers`` defaults to "real" (the default handshake on the
gateways' ``backend``, "cuda" unless ``gateway_kw`` says otherwise), where
that fleet defaults to the stdlib storm toys.

The design seed: **a dead gateway is a breaker-open shard at fleet
scope**.  Each :class:`GatewayMember` owns a
:class:`provider.batched.Breaker` — the SAME closed → open → half-open →
closed state machine that guards a chip's dispatch path — driven by
fleet-level evidence instead of dispatch latency:

* missed heartbeats  → ``record_failure`` (non-probe): the breaker opens,
  the member's ring arc drains to its successors, in-flight handshakes on
  it are retried by their initiators under the existing typed busy/retry
  machinery;
* the half-open canary is a CONTROL probe (one ``__gw_probe__``
  round-trip), never a client session: ``probe_ready()`` members get
  exactly one probe per cool-off, failures escalate the backoff
  exponentially (capped) exactly like a sick chip's canary;
* probe success → ``record_success("probe")`` closes the breaker and the
  member takes its ring ownership back — membership never changed, so
  the arc snaps back with zero reshuffling of other members' peers.

Placement, quarantine and rebalance are ONE policy at both scopes:
:func:`provider.scheduler.select_slot` — the local shard axis's placement
rule — picks among :class:`GatewayMember`\\ s too (they expose the same
``breaker`` / ``inflight`` / ``index`` slot protocol): the health loop
routes the next canary probe through it, and routing falls back to it
(quarantine-aware, least-loaded) when the ring walk finds no closed
member.

Admission: the fleet budget is the SUM of per-gateway budgets over the
currently-closed members; an over-budget route query is shed AT THE
ROUTER with the same typed ``__busy__`` frame a gateway's connection
budget uses, so clients treat both scopes with one retry policy.

Cross-process SLO aggregation: each heartbeat carries the gateway's
cumulative SLO probe totals (:meth:`obs.slo.SLOEngine.probe_totals`); the
fleet sums them per spec and evaluates ONE :class:`obs.slo.SLOEngine`
over the sums — the per-node ``slo_report.json`` files the gateways write
on shutdown are the offline twin (:func:`obs.slo.merge_reports`).

HA control plane (docs/fleet.md "HA control plane"): the router itself
is no longer a load-bearing singleton.  A fleet constructed with
``router_peers`` runs as ONE REPLICA of a replicated control plane — a
:class:`fleet.lease.LeaderLease` (monotonic epochs, relative TTLs,
rank-staggered claims on the injectable clock) decides which replica
holds STEK-rotation and admission authority; the leader replicates the
full authority state (STEK ring export + membership roster) to followers
on every change over the same length-framed control link
(``__rt_lease__`` / ``__rt_sync__``), so ANY follower can assume the
lease without losing the ticket accept window.  Authority frames carry
the lease epoch; a follower fences stale epochs with ``__rt_reject__``
and the stale sender demotes loudly instead of split-braining.  Replicas
run in ``attach`` mode: gateways are spawned by the driver, dial every
router, and register via hello — members materialize on registration
instead of at spawn.

Everything here runs on the event loop (the breakers' own locks cover
their cross-thread surface); the clock is injectable so handoff/heal
tests drive deterministic timelines.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import sys
import time
from pathlib import Path
from typing import Any, Callable

from ..app.resumption import STEKRing
from ..faults import plan as _faults
from ..obs import flight as obs_flight
from ..obs import slo as obs_slo
from ..obs.metrics import Registry
from ..provider.batched import Breaker
from ..provider.scheduler import select_slot
from . import control
from .lease import LeaderLease
from .ring import HashRing

logger = logging.getLogger(__name__)

#: heartbeat cadence and the miss budget: a member whose last heartbeat is
#: older than ``hb_miss_limit * hb_interval`` is declared dead (breaker
#: opens).  Defaults favor fast CI storms; production deployments pass
#: their own (docs/fleet.md sizes the detection-latency/false-positive
#: trade).
HB_INTERVAL_S = 0.25
HB_MISS_LIMIT = 4


class FleetBusy(RuntimeError):
    """The fleet admission budget is exhausted: this route query was shed
    at the router (the wire twin is the typed ``__busy__`` frame)."""


class GatewayMember:
    """Router-side state for one gateway process — a fleet-scope slot.

    Satisfies the :func:`provider.scheduler.select_slot` slot protocol
    (``index`` / ``inflight`` / ``breaker``), which is what lets the
    shard-placement policy pick among gateways unchanged."""

    def __init__(self, gateway_id: str, index: int, cooloff_s: float = 1.0,
                 cooloff_max_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.gateway_id = gateway_id
        self.index = index
        self._cooloffs = (cooloff_s, cooloff_max_s)
        self._clock = clock
        #: fleet-scope breaker: the provider-layer state machine reused at
        #: the second placement level (module docstring)
        self.breaker = Breaker(cooloff_s, cooloff_max_s, clock=clock)
        self.breaker.label = gateway_id
        #: live sessions the router believes are on this gateway
        self.inflight = 0
        #: routes issued in the current / previous heartbeat window (not
        #: yet necessarily visible in the gateway's own connection count —
        #: the reconcile slack below)
        self.routed_since_hb = 0
        self.routed_prev_hb = 0
        #: cumulative sessions routed here
        self.assigned = 0
        # -- liveness / transport ------------------------------------------
        self.host: str | None = None
        self.port: int | None = None  # the P2P port peers dial
        self.pid: int | None = None
        #: the gateway's own telemetry listener (obs/http.py), announced
        #: in its hello/heartbeats; None when it runs without one
        self.telemetry_port: int | None = None
        #: the per-gateway admission cap the process announced in its
        #: hello — cross-checked against the router's configured cap so a
        #: respawn running a stale config is caught at registration
        self.announced_max_peers: int | None = None
        self.proc: Any = None  # asyncio subprocess (spawn="process")
        self.task: asyncio.Task | None = None  # spawn="task"
        self.writer: asyncio.StreamWriter | None = None
        #: control-connection generation: bumped on every accepted hello.
        #: A member may be re-dialed (reconnect after a transient drop, a
        #: gateway heartbeating a respawned router) while the OLD read
        #: loop is still draining — without the generation gate the stale
        #: loop's heartbeats would double-shift the inflight reconcile
        #: windows and its EOF would tear down the LIVE registration
        self.conn_gen = 0
        #: frames dropped from superseded connections (bug evidence)
        self.superseded_frames = 0
        self.last_hb: float | None = None
        self.hb_count = 0
        #: latest heartbeat stats / cumulative SLO probe totals
        self.stats: dict[str, Any] = {}
        self.slo_totals: dict[str, Any] = {}
        #: final stats from the gateway's ``__gw_bye__``
        self.final_stats: dict[str, Any] | None = None
        #: chaos partition: control traffic dropped until this clock time
        self.partitioned_until = 0.0
        #: True once stop()/kill() decided this member's life is over —
        #: excluded from routing and probing
        self.stopped = False
        self.killed = False
        #: True while a graceful drain / rolling restart owns this member:
        #: excluded from routing and from death-detection (the exit is
        #: PLANNED — declaring it dead would be noise), cleared when the
        #: respawned process re-registers
        self.draining = False
        #: rolling restarts survived (snapshot bookkeeping)
        self.restarts = 0
        self._probe_fut: asyncio.Future | None = None
        self._probe_n = 0

    @property
    def registered(self) -> bool:
        return self.port is not None

    def reset_for_respawn(self) -> None:
        """Forget the dead incarnation's transport/liveness state so the
        respawned process registers like a fresh member — ring arc,
        identity, and cumulative route counters unchanged; the fleet
        breaker is rebuilt closed (a planned restart is not failure
        evidence)."""
        self.proc = None
        self.task = None
        self.writer = None
        self.port = None
        self.pid = None
        self.telemetry_port = None
        self.announced_max_peers = None
        self.last_hb = None
        self.final_stats = None
        self.stats = {}
        self.slo_totals = {}
        self.killed = False
        self.stopped = False
        self._probe_fut = None
        self._probe_n = 0
        self.inflight = 0
        self.routed_since_hb = 0
        self.routed_prev_hb = 0
        self.restarts += 1
        self.breaker = Breaker(*self._cooloffs, clock=self._clock)
        self.breaker.label = self.gateway_id

    def snapshot(self) -> dict[str, Any]:
        b = self.breaker
        return {
            "gateway": self.gateway_id,
            "index": self.index,
            "port": self.port,
            "pid": self.pid,
            "inflight": self.inflight,
            "assigned": self.assigned,
            "heartbeats": self.hb_count,
            "breaker_state": b.state,
            "breaker_opens": b.opens,
            "breaker_closes": b.closes,
            "killed": self.killed,
            "stopped": self.stopped,
            "draining": self.draining,
            "restarts": self.restarts,
            "telemetry_port": self.telemetry_port,
            "stats": self.stats,
        }


class GatewayFleet:
    """Spawns, watches, routes to, and heals a pod of gateway processes."""

    def __init__(
        self,
        gateways: int = 3,
        *,
        spawn: str = "process",
        providers: str = "real",
        seed: int = 0,
        ring_vnodes: int = 64,
        hb_interval: float = HB_INTERVAL_S,
        hb_miss_limit: int = HB_MISS_LIMIT,
        cooloff_s: float = 1.0,
        cooloff_max_s: float = 30.0,
        per_gateway_max_peers: int = 0,
        handshake_budget: int = 0,
        gateway_kw: dict[str, Any] | None = None,
        report_dir: str | Path | None = None,
        host: str = "127.0.0.1",
        clock: Callable[[], float] = time.monotonic,
        register_timeout: float = 60.0,
        telemetry_port: int | None = None,
        ticket_key_rotation_s: float = 0.0,
        attach: bool = False,
        ctrl_port: int | None = None,
        router_id: str = "rt0",
        router_rank: int = 0,
        router_peers: list[dict[str, Any]] | None = None,
        lease_ttl_s: float | None = None,
        lease_stagger_s: float | None = None,
    ):
        if spawn not in ("process", "task"):
            raise ValueError(f"spawn must be 'process' or 'task', got {spawn!r}")
        self.spawn = spawn
        self.providers = providers
        self.seed = seed
        self.hb_interval = hb_interval
        self.hb_miss_limit = hb_miss_limit
        self.per_gateway_max_peers = per_gateway_max_peers
        self.handshake_budget = handshake_budget
        self.gateway_kw = dict(gateway_kw or {})
        self.report_dir = Path(report_dir) if report_dir is not None else None
        self.host = host
        self._clock = clock
        #: attach mode (HA replicas): this router spawns NOTHING — the
        #: driver owns the gateway processes, which dial every router and
        #: materialize as members on their hello
        self.attach = attach
        self._requested_ctrl_port = ctrl_port
        self._cooloffs = (cooloff_s, cooloff_max_s)
        # -- replicated control plane (None = the classic standalone) ------
        self.router_id = router_id
        self.router_peers = list(router_peers or [])
        self.lease: LeaderLease | None = None
        if router_peers is not None:
            lease_kw: dict[str, Any] = {"clock": clock}
            if lease_ttl_s is not None:
                lease_kw["ttl_s"] = lease_ttl_s
            if lease_stagger_s is not None:
                lease_kw["claim_stagger_s"] = lease_stagger_s
            self.lease = LeaderLease(router_id, router_rank, **lease_kw)
        #: ``__rt_reject__`` fences this replica RECEIVED (each one is
        #: proof a peer holds a fresher lease than a frame we sent)
        self.lease_rejects = 0
        #: stale peer authority frames this replica fenced
        self.lease_fenced = 0
        #: RT_SYNC state replications applied from the leader
        self.syncs_applied = 0
        #: fleet birth on the injected clock: the availability SLO measures
        #: gateway-seconds SINCE START — the raw monotonic value is time
        #: since boot, which would dilute any outage into un-alertable noise
        self._t0 = clock()
        self._register_timeout = register_timeout
        # attach mode: members materialize on hello (the driver spawns the
        # gateway processes; ``gateways`` is only the expected head count)
        ids = [] if attach else [f"gw{i}" for i in range(gateways)]
        self.members: dict[str, GatewayMember] = {
            gid: GatewayMember(gid, i, cooloff_s, cooloff_max_s, clock)
            for i, gid in enumerate(ids)
        }
        #: consistent-hash peer→gateway assignment (fleet/ring.py): seeded,
        #: bounded virtual nodes; membership is STABLE across deaths —
        #: liveness is the breakers' business, so a healed gateway's arc
        #: snaps back without reshuffling anyone else's peers
        self.ring = HashRing(ids, vnodes=ring_vnodes, seed=seed)
        self._server: asyncio.Server | None = None
        self.ctrl_port: int | None = None
        self._running = False
        self._health_task: asyncio.Task | None = None
        self._bg: set[asyncio.Task] = set()
        self._watchers: list[Callable[[str, str], None]] = []
        self._registered_ev = asyncio.Event()
        # -- fleet counters (the router-side half of the admission SLI) ----
        self.routes_ok = 0
        self.route_sheds = 0
        self.rebalance_picks = 0
        self.handoffs = 0
        self._last_healthy: frozenset[str] = frozenset(ids)
        #: the fleet's authoritative session-ticket-encryption keys
        #: (app/resumption.py STEKRing: current + previous = the dual-key
        #: accept window), pushed to every gateway over the control link
        #: on registration and on rotation — one ring per fleet is what
        #: makes a ticket minted by gw1 resume on gw2 after a handoff
        self.ticket_keys = STEKRing()
        #: automatic rotation cadence on the injected clock (0 = manual
        #: rotation only via rotate_stek())
        self.ticket_key_rotation_s = ticket_key_rotation_s
        self._last_key_rotation_t = clock()
        self.key_rotations = 0
        self.registry = Registry(name="fleet")
        self.slo = self._build_slo_engine()
        #: router-side telemetry (obs/http.py): None = off (the default).
        #: When armed, the router serves the aggregated /fleet view and
        #: every gateway (unless gateway_kw overrides) opens its OWN
        #: ephemeral telemetry listener, announced via hello/heartbeat.
        self._telemetry_port = telemetry_port
        self.telemetry = None

    # -- events ---------------------------------------------------------------

    def on_event(self, handler: Callable[[str, str], None]) -> None:
        """Register a fleet transition callback ``handler(event, gateway)``
        — fired from the control read loops and the health tick (loop
        domain).  Events: registered / gateway_dead / gateway_healed /
        probe_failed / bye."""
        if handler not in self._watchers:
            self._watchers.append(handler)

    def _fire(self, event: str, gateway: str) -> None:
        for h in list(self._watchers):
            try:
                h(event, gateway)
            except Exception:
                logger.exception("fleet event handler failed")

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> None:
        """Start the control/route server, spawn every gateway, and wait
        until all of them registered (hello received).  Attach mode binds
        the REQUESTED control port (a respawned replica must come back
        where the gateways' reconnect loops are dialing), spawns nothing,
        and waits for nobody — registration arrives when it arrives."""
        self._server = await asyncio.start_server(
            self._on_ctrl, self.host, self._requested_ctrl_port or 0)
        self.ctrl_port = self._server.sockets[0].getsockname()[1]
        self._running = True
        if self._telemetry_port is not None:
            from ..obs.http import TelemetryServer, json_route
            from ..obs.metrics import (PROMETHEUS_CONTENT_TYPE,
                                       prometheus_text)

            def prom():
                return 200, PROMETHEUS_CONTENT_TYPE, prometheus_text(
                    self.registry).encode()

            try:
                self.telemetry = TelemetryServer({
                    "/fleet": json_route(self.fleet_view),
                    "/metrics": prom,
                    "/metrics.json": json_route(self.registry.snapshot),
                    "/slo": json_route(self.slo_status),
                    "/healthz": json_route(lambda: {
                        "ok": True, "role": "fleet-router",
                        "router": self.router_id,
                        "lease": self.lease_view(),
                        "gateways": len(self.members),
                    }),
                }, host=self.host, port=self._telemetry_port).start()
            except OSError as e:
                # an optional observability listener must never stop the
                # fleet from starting (same degrade policy as the engine)
                logger.warning("fleet telemetry disabled: cannot bind "
                               "port %s (%s)", self._telemetry_port, e)
        if self.report_dir is not None:
            self.report_dir.mkdir(parents=True, exist_ok=True)
            # a previous run's per-node reports would leak into this run's
            # collect_reports() merge (a killed gateway writes none,
            # leaving its stale twin behind to impersonate it)
            for stale in self.report_dir.glob("*_slo_report.json"):
                stale.unlink()
        if not self.attach:
            for member in self._members_sorted():
                await self._spawn_member(member)
            try:
                await asyncio.wait_for(self._registered_ev.wait(),
                                       self._register_timeout)
            except asyncio.TimeoutError:
                missing = [m.gateway_id for m in self.members.values()
                           if not m.registered]
                await self.stop()
                raise RuntimeError(
                    f"fleet start: gateways never registered: {missing}")
        self._health_task = asyncio.create_task(self._health_loop())
        logger.info("fleet up: %d gateways on router port %s (router %s)",
                    len(self.members), self.ctrl_port, self.router_id)

    def _members_sorted(self) -> list[GatewayMember]:
        return [self.members[g] for g in sorted(self.members)]

    def _gateway_config(self, member: GatewayMember) -> dict[str, Any]:
        cfg = {
            "gateway_id": member.gateway_id,
            "router_host": self.host,
            # the gateway binds its P2P listener where the router will
            # advertise it (_route_reply hands clients member.host)
            "bind_host": self.host,
            "router_port": self.ctrl_port,
            "providers": self.providers,
            "max_peers": self.per_gateway_max_peers,
            "handshake_budget": self.handshake_budget,
            "hb_interval": self.hb_interval,
            "report_dir": str(self.report_dir) if self.report_dir else None,
            # a telemetry-armed fleet scrapes its gateways too: each opens
            # an ephemeral listener, announced back through hello
            "telemetry_port": (0 if self._telemetry_port is not None
                               else None),
        }
        cfg.update(self.gateway_kw)
        return cfg

    async def _spawn_member(self, member: GatewayMember) -> None:
        cfg = self._gateway_config(member)
        if self.spawn == "task":
            from .gateway import run_gateway

            member.task = asyncio.create_task(run_gateway(cfg))
            return
        stderr = asyncio.subprocess.DEVNULL
        log_f = None
        if self.report_dir is not None:
            log_path = self.report_dir / f"{member.gateway_id}.log"
            stderr = log_f = await asyncio.get_running_loop().run_in_executor(
                None, lambda: open(log_path, "wb"))
        try:
            member.proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m",
                "quantum_resistant_p2p_tpu_torch.fleet.gateway",
                json.dumps(cfg),
                stdout=asyncio.subprocess.DEVNULL, stderr=stderr,
                start_new_session=True,
            )
        finally:
            if log_f is not None:
                # the child holds its own dup of the fd; keeping the
                # router-side file object open would pin one fd per
                # gateway per fleet for the driver's lifetime
                log_f.close()
        member.pid = member.proc.pid

    async def stop(self) -> None:
        """Graceful drain: ask every live gateway to write its per-node
        SLO report and exit; SIGKILL/cancel whatever does not comply.

        An ATTACH-mode replica owns no gateway processes and must not
        reach for them: a router being rolled mid-storm that sent
        ``__gw_stop__`` on its way out would take the entire (healthy,
        serving) data plane down with it — it just closes its own
        listener and lets the gateways' reconnect loops find the respawn.
        """
        self._running = False
        if self._health_task is not None:
            self._health_task.cancel()
        if self.attach:
            for member in self._members_sorted():
                if member.writer is not None:
                    member.writer.close()
                    member.writer = None
            for t in list(self._bg):
                t.cancel()
            if self._server is not None:
                self._server.close()
                await self._server.wait_closed()
                self._server = None
            await self._stop_telemetry()
            return
        await self._stop_telemetry()
        for member in self._members_sorted():
            member.stopped = True
            if member.proc is not None and member.pid is not None:
                # un-freeze a pause-chaos'd gateway so it can process the
                # stop frame and write its slo report instead of burning
                # the drain deadline SIGSTOPped (harmless if running)
                try:
                    os.kill(member.pid, signal.SIGCONT)
                except (OSError, ProcessLookupError):  # pragma: no cover
                    pass
            if member.writer is not None:
                try:
                    await control.send_ctrl(member.writer,
                                            {"type": control.GW_STOP})
                except (ConnectionError, OSError, RuntimeError):
                    pass
        deadline = 10.0
        for member in self._members_sorted():
            if member.proc is not None:
                try:
                    await asyncio.wait_for(member.proc.wait(), deadline)
                except asyncio.TimeoutError:
                    member.proc.kill()
                    await member.proc.wait()
            elif member.task is not None:
                try:
                    await asyncio.wait_for(member.task, deadline)
                except asyncio.TimeoutError:
                    member.task.cancel()
                except asyncio.CancelledError:
                    pass  # a chaos-killed in-process gateway: already dead
                except Exception:
                    logger.exception("gateway %s task died with an error "
                                     "during stop", member.gateway_id)
        for t in list(self._bg):
            t.cancel()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _stop_telemetry(self) -> None:
        """Stop the telemetry listener off the loop: the HTTP server's
        shutdown waits out its accept poll (up to 0.25 s), which on the
        loop would stall every replica, gateway and client of a task-mode
        fleet for longer than a third of a short lease TTL (ROADMAP C8)."""
        if self.telemetry is not None:
            srv, self.telemetry = self.telemetry, None
            await asyncio.get_running_loop().run_in_executor(None, srv.stop)

    def kill(self, gateway_id: str) -> None:
        """Abrupt gateway death (chaos ``kill_gateway``): SIGKILL the
        subprocess / cancel the in-process task.  The member stays in the
        ring — death is the breakers' business, detected by missed
        heartbeats exactly like an unplanned crash."""
        member = self.members[gateway_id]
        member.killed = True
        if member.proc is not None:
            try:
                member.proc.kill()
            except ProcessLookupError:  # pragma: no cover - already gone
                pass
        elif member.task is not None:
            member.task.cancel()
        obs_flight.record("fleet_gateway_killed", gateway=gateway_id)

    def pause(self, gateway_id: str, seconds: float) -> None:
        """Chaos ``pause_gateway``: SIGSTOP the subprocess for ``seconds``
        then SIGCONT (in-process gateways degrade to a partition — a task
        cannot be frozen)."""
        member = self.members[gateway_id]
        if member.proc is not None and member.pid is not None:
            try:
                os.kill(member.pid, signal.SIGSTOP)
                asyncio.get_running_loop().call_later(
                    seconds, self._resume, member)
            except (OSError, ProcessLookupError):  # pragma: no cover
                pass
        else:
            self.partition(gateway_id, seconds)

    def _resume(self, member: GatewayMember) -> None:
        # no `stopped` gate: resuming a stopping/gone process is harmless,
        # while skipping it would leave a paused gateway frozen through
        # stop()'s drain
        if member.pid is not None:
            try:
                os.kill(member.pid, signal.SIGCONT)
            except (OSError, ProcessLookupError):  # pragma: no cover
                pass

    def partition(self, gateway_id: str, seconds: float) -> None:
        """Chaos ``partition``: drop router<->gateway control traffic
        (heartbeats in, probes out) for ``seconds``.  The gateway keeps
        serving peers — the fleet just cannot SEE it, the exact
        false-dead case the half-open re-entry machinery must handle."""
        member = self.members[gateway_id]
        member.partitioned_until = max(
            member.partitioned_until, self._clock() + seconds)

    # -- control server -------------------------------------------------------

    async def _on_ctrl(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        try:
            msg = await asyncio.wait_for(control.read_ctrl(reader), 10.0)
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError, OSError, ValueError):
            # slow/garbled/dropped first frame: untrusted dialer, drop it
            writer.close()
            return
        mtype = msg.get("type")
        if mtype == control.GW_HELLO:
            await self._gateway_conn(msg, reader, writer)
        elif mtype == control.ROUTE:
            try:
                await control.send_ctrl(writer, self._route_reply(msg))
            except (ConnectionError, OSError):
                pass
            writer.close()
        elif mtype == control.ROUTE_DONE:
            self.session_done(str(msg.get("gateway", "")))
            writer.close()
        elif mtype == control.RT_LEASE:
            await self._on_rt_lease(msg, writer)
            writer.close()
        elif mtype == control.RT_SYNC:
            await self._on_rt_sync(msg, writer)
            writer.close()
        else:
            writer.close()

    async def _gateway_conn(self, hello: dict, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        gid = str(hello.get("gateway", ""))
        member = self.members.get(gid)
        if member is None:
            if not self.attach:
                logger.warning("hello from unknown gateway %r", gid)
                writer.close()
                return
            # attach mode: gateways are spawned by the driver and register
            # themselves — membership (and the ring arc) materializes here
            member = GatewayMember(gid, len(self.members), *self._cooloffs,
                                   clock=self._clock)
            self.members[gid] = member
            self.ring.add(gid)
            if self.lease is not None and self.lease.is_leader:
                self._spawn(self._replicate_state(), f"member sync:{gid}")
        if member.writer is not None and member.writer is not writer:
            # a SECOND control connection for a registered member (a
            # reconnect landing before the old loop saw its EOF): the new
            # hello supersedes.  Without this, both read loops would feed
            # _on_heartbeat — every heartbeat double-shifts the inflight
            # reconcile windows, halving the reconcile slack — and the
            # old loop's eventual EOF would null the LIVE writer, leaving
            # a serving gateway unreachable for probes and STEK pushes
            # until ITS next reconnect
            old = member.writer
            member.writer = None
            old.close()
        member.conn_gen += 1
        gen = member.conn_gen
        member.host = self.host
        member.port = int(hello.get("p2p_port", 0))
        member.pid = int(hello.get("pid") or 0) or member.pid
        tport = hello.get("telemetry_port")
        member.telemetry_port = int(tport) if tport is not None else None
        announced = hello.get("max_peers")
        member.announced_max_peers = (int(announced) if announced is not None
                                      else None)
        if (member.announced_max_peers is not None
                and self.per_gateway_max_peers
                and member.announced_max_peers != self.per_gateway_max_peers):
            # a respawn running a stale config: its own admission cap and
            # the router's budget arithmetic (_fleet_budget) now disagree —
            # routing still works, but surface the drift loudly
            logger.warning(
                "gateway %s announced max_peers=%d but the router is "
                "configured for %d per gateway — config drift", gid,
                member.announced_max_peers, self.per_gateway_max_peers)
        member.writer = writer
        member.last_hb = self._clock()
        member.draining = False  # a respawned member is serving again
        logger.info("gateway %s registered (p2p port %s)", gid, member.port)
        # push the fleet STEK ring FIRST: a gateway must never mint (or
        # refuse) tickets under its private random ring once it is part
        # of a fleet — and a respawned gateway needs the ring before its
        # first resume arrives, or every pre-restart ticket would draw
        # unknown_stek instead of resuming
        try:
            await control.send_ctrl(writer, {
                "type": control.GW_TICKET_KEYS,
                "keys": self.ticket_keys.export(),
                "lease_epoch": self._lease_epoch(),
            })
        except (ConnectionError, OSError):
            # the gateway died between hello and the push: undo the
            # registration state set above — a half-registered member
            # (port set, writer dead) would be routable, would satisfy
            # restart_member's registered check, and would stall
            # start()'s all-registered event
            member.port = None
            if member.writer is writer:
                member.writer = None
            member.last_hb = None
            writer.close()
            return
        self._fire("registered", gid)
        if all(m.registered for m in self.members.values()):
            self._registered_ev.set()
        try:
            while True:
                msg = await control.read_ctrl(reader)
                if member.conn_gen != gen:
                    # this loop's connection was superseded by a fresh
                    # hello: its frames are the DEAD incarnation's — a
                    # heartbeat here must not touch liveness or shift the
                    # reconcile windows the live connection now owns
                    member.superseded_frames += 1
                    break
                mtype = msg.get("type")
                sender = str(msg.get("gateway", gid) or gid)
                if sender != gid:
                    # a frame claiming another member's identity on gid's
                    # registered connection (stale config / confused
                    # respawn): it must not mutate gid's state, and it
                    # CERTAINLY must not mutate the claimed member's
                    logger.warning(
                        "gateway %s sent %s claiming identity %r — frame "
                        "dropped", gid, mtype, sender)
                    continue
                if mtype == control.GW_HEARTBEAT:
                    self._on_heartbeat(member, msg)
                elif mtype == control.GW_PROBE_OK:
                    self._on_probe_ok(member, msg)
                elif mtype == control.GW_BYE:
                    member.final_stats = msg.get("stats") or {}
                    self._fire("bye", gid)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            if member.writer is writer:
                member.writer = None
            writer.close()

    def _on_heartbeat(self, member: GatewayMember, msg: dict) -> None:
        if self._clock() < member.partitioned_until:
            return  # chaos partition: the router never saw it
        member.last_hb = self._clock()
        member.hb_count += 1
        member.stats = msg.get("stats") or {}
        tport = member.stats.get("telemetry_port")
        if tport is not None:
            member.telemetry_port = int(tport)
        # Reconcile the router's inflight BELIEF with the gateway's own
        # connection count: a client whose ``__route_done__`` frame was
        # lost (its open_connection error is swallowed client-side) would
        # otherwise leak its admission slot FOREVER and eventually wedge
        # the fleet budget in permanent FleetBusy.  The cap pads for
        # routes granted in the last TWO heartbeat windows, which the
        # gateway cannot be assumed to see as connections yet (a saturated
        # client loop can take more than one window to finish its dial) —
        # so a leak ages out once its peer disconnects plus two
        # heartbeats, and a slow-dialing live session is not clamped away.
        reported = member.stats.get("connections")
        if reported is not None:
            cap = (int(reported) + member.routed_since_hb
                   + member.routed_prev_hb)
            if member.inflight > cap:
                member.inflight = cap
        member.routed_prev_hb = member.routed_since_hb
        member.routed_since_hb = 0
        totals = msg.get("slo_totals") or {}
        if isinstance(totals, dict):
            member.slo_totals = totals

    def _on_probe_ok(self, member: GatewayMember, msg: dict) -> None:
        if self._clock() < member.partitioned_until:
            return  # a partitioned member's probe reply is lost too
        fut = member._probe_fut
        if fut is not None and not fut.done() and msg.get("n") == member._probe_n:
            fut.set_result(True)

    # -- replicated control plane (leader lease) ------------------------------

    @property
    def has_authority(self) -> bool:
        """May this replica rotate STEKs / own admission policy NOW?
        Standalone fleets (no lease) always do — the classic single-router
        behavior is the degenerate one-replica case."""
        return self.lease is None or self.lease.is_leader

    def lease_view(self) -> dict[str, Any]:
        if self.lease is None:
            # a standalone router IS the (only possible) authority holder
            return {"role": "leader", "epoch": 0, "holder": self.router_id,
                    "standalone": True}
        return self.lease.view()

    def _lease_epoch(self) -> int:
        return 0 if self.lease is None else self.lease.epoch

    def _observe_lease(self, holder: str, epoch: int,
                       ttl_s: float | None) -> bool:
        """Fold a peer claim/renew in; demotions surface LOUDLY (flight
        record + event), never as a silent role flip.  False = stale."""
        assert self.lease is not None
        was = self.lease.role
        ok = self.lease.observe(holder, int(epoch), ttl_s)
        if self.lease.role != was and self.lease.role == "demoted":
            logger.error("router %s DEMOTED: lease epoch %s is held by %s",
                         self.router_id, epoch, holder)
            obs_flight.trigger("router_demoted", router=self.router_id,
                               epoch=int(epoch), holder=holder)
            self._fire("lease_demoted", self.router_id)
        return ok

    async def _on_rt_lease(self, msg: dict, writer) -> None:
        """A peer's lease claim/renewal.  Stale epochs are fenced with a
        typed ``__rt_reject__`` reply carrying OUR epoch — the proof the
        stale sender needs to demote instead of split-braining."""
        if self.lease is None:
            return
        holder = str(msg.get("holder", ""))
        ttl_s = msg.get("ttl_s")
        if not self._observe_lease(holder, int(msg.get("epoch") or 0),
                                   float(ttl_s) if ttl_s is not None else None):
            self.lease_fenced += 1
            obs_flight.record("stale_lease_fenced", router=self.router_id,
                              sender=holder, at_epoch=self.lease.epoch)
            try:
                await control.send_ctrl(writer, {
                    "type": control.RT_REJECT,
                    "router": self.router_id,
                    "epoch": self.lease.epoch,
                })
            except (ConnectionError, OSError):
                pass

    async def _on_rt_sync(self, msg: dict, writer) -> None:
        """Leader → follower authority-state replication: the STEK ring
        export (current + previous — the full accept window), the
        rotation count, and the membership roster, fenced on the lease
        epoch exactly like the lease frames themselves."""
        if self.lease is None:
            return
        holder = str(msg.get("holder", ""))
        epoch = int(msg.get("epoch") or 0)
        if not self._observe_lease(holder, epoch, None):
            self.lease_fenced += 1
            obs_flight.record("stale_sync_fenced", router=self.router_id,
                              sender=holder, at_epoch=self.lease.epoch)
            try:
                await control.send_ctrl(writer, {
                    "type": control.RT_REJECT,
                    "router": self.router_id,
                    "epoch": self.lease.epoch,
                })
            except (ConnectionError, OSError):
                pass
            return
        keys = msg.get("keys")
        if keys:
            try:
                installed = self.ticket_keys.install(
                    [(str(ep), bytes.fromhex(str(key_hex)))
                     for ep, key_hex in keys], guard=True)
            except (ValueError, TypeError):
                logger.warning("router %s: malformed STEK sync from %s "
                               "ignored", self.router_id, holder)
                return
            if not installed:
                # structural regression guard (STEKRing.install): a
                # pre-rotation replicate frame landed after the rotation
                # it predates — same lease epoch, separate connections
                obs_flight.record("stale_stek_sync_skipped",
                                  router=self.router_id, sender=holder)
                return
        self.key_rotations = max(self.key_rotations,
                                 int(msg.get("rotations") or 0))
        for gid in (msg.get("members") or ()):
            gid = str(gid)
            if gid not in self.members:
                # roster adoption: a replica that (re)started after a
                # gateway registered elsewhere still places it on the ring;
                # liveness stays the gateway's own hello/heartbeat business
                self.members[gid] = GatewayMember(
                    gid, len(self.members), *self._cooloffs,
                    clock=self._clock)
                self.ring.add(gid)
        self.syncs_applied += 1

    def _lease_tick(self) -> None:
        """The lease half of the health tick: claim when the lease (plus
        our rank stagger) expired, renew at ttl/3 cadence while leading.
        Claims and renewals broadcast to every peer; a claim also
        replicates the full authority state and re-pushes the STEK ring
        to our connected gateways, so the accept window survives the
        failover (tickets minted under the dead leader still redeem)."""
        assert self.lease is not None
        if self.lease.claim_due():
            body = self.lease.claim()
            logger.warning("router %s claimed the lease (epoch %s)",
                           self.router_id, body["epoch"])
            obs_flight.record("lease_claimed", router=self.router_id,
                              epoch=body["epoch"])
            self._fire("lease_claimed", self.router_id)
            self._spawn(self._announce_lease(body, sync=True),
                        f"lease claim:{self.router_id}")
        elif self.lease.renew_due():
            body = self.lease.renew()
            self._spawn(self._announce_lease(body, sync=False),
                        f"lease renew:{self.router_id}")

    async def _announce_lease(self, body: dict[str, Any],
                              sync: bool) -> None:
        frame = {"type": control.RT_LEASE, "holder": body["holder"],
                 "epoch": body["epoch"], "ttl_s": body["ttl_s"]}
        for peer in self.router_peers:
            await self._peer_send(peer, frame)
        if self.lease is not None and self.lease.is_leader:
            # EVERY renewal re-replicates the authority state, not just
            # the claim: a follower that restarted since the last change
            # (a mid-roll respawn) converges within one renew interval
            # instead of holding a private random STEK ring until the
            # next rotation — which is exactly the window a failover
            # would lose the accept window in
            await self._replicate_state()
            if sync:
                await self._push_stek_to_gateways()

    def _sync_frame(self) -> dict[str, Any]:
        return {"type": control.RT_SYNC, "holder": self.router_id,
                "epoch": self._lease_epoch(),
                "keys": self.ticket_keys.export(),
                "rotations": self.key_rotations,
                "members": sorted(self.members)}

    async def _replicate_state(self) -> None:
        """Leader → every follower: full authority state, on every change
        (claim, STEK rotation, membership growth)."""
        frame = self._sync_frame()
        for peer in self.router_peers:
            await self._peer_send(peer, frame)

    async def _peer_send(self, peer: dict[str, Any],
                         frame: dict[str, Any]) -> None:
        """One frame to one peer replica, short-lived connection (the
        route_query discipline).  The receiver replies ONLY to fence a
        stale frame; an accepted frame is acked by the close.  A reject
        reply is proof a fresher lease exists: count it, demote loudly."""
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(str(peer.get("host") or self.host),
                                        int(peer["port"])), 2.0)
        except (OSError, asyncio.TimeoutError, ValueError, KeyError):
            return  # a dead peer misses this round; reconvergence is cheap
        try:
            await control.send_ctrl(writer, frame)
            reply = asyncio.ensure_future(control.read_ctrl(reader))
            # consume the reply task's outcome even when WE get cancelled
            # mid-wait (fleet stop, chaos kill): an EOF landing in the
            # same tick as the cancellation would otherwise surface as an
            # unretrieved-exception warning after the fact
            reply.add_done_callback(
                lambda t: None if t.cancelled() else t.exception())
            try:
                msg = await asyncio.wait_for(reply, 2.0)
            except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                    ConnectionError, OSError, ValueError):
                return  # closed without a reply = accepted
            mtype = msg.get("type")
            if mtype == control.RT_REJECT:
                # stale-lease fence bounced back at us: a peer holds proof
                # of a fresher lease — never keep claiming over it
                self.lease_rejects += 1
                peer_id = str(msg.get("router", ""))
                peer_epoch = int(msg.get("epoch") or 0)
                if self.lease is not None:
                    was = self.lease.role
                    if self.lease.observe_reject(peer_epoch):
                        logger.error(
                            "router %s DEMOTED: %s fenced our frame at "
                            "epoch %s", self.router_id, peer_id, peer_epoch)
                        obs_flight.trigger("router_demoted",
                                           router=self.router_id,
                                           epoch=peer_epoch, holder=peer_id)
                        if self.lease.role != was:
                            self._fire("lease_demoted", self.router_id)
        except (ConnectionError, OSError):
            pass
        finally:
            writer.close()

    async def _push_stek_to_gateways(self) -> None:
        """Re-push the (replicated) STEK ring to every gateway connected
        to THIS replica — the new leader's first act, so a ticket minted
        under the dead leader's key redeems on the very next resume."""
        for member in self._members_sorted():
            if member.writer is None or member.stopped:
                continue
            try:
                await control.send_ctrl(member.writer, {
                    "type": control.GW_TICKET_KEYS,
                    "keys": self.ticket_keys.export(),
                    "lease_epoch": self._lease_epoch(),
                })
            except (ConnectionError, OSError, RuntimeError):
                logger.warning("STEK re-push to %s failed",
                               member.gateway_id)

    # -- health loop / handoff ------------------------------------------------

    async def _health_loop(self) -> None:
        while self._running:
            await asyncio.sleep(self.hb_interval)
            self._health_tick()

    def _health_tick(self) -> None:
        """One fleet health pass (also driven directly by tests on an
        injected clock): chaos hooks, death detection, probe routing."""
        now = self._clock()
        # chaos first, in sorted order on ONE loop: the process-scope rule
        # counters advance on a deterministic event stream (faults/plan.py)
        for member in self._members_sorted():
            if member.stopped:
                continue
            for entry in _faults.process_control(member.gateway_id):
                self._apply_chaos(member, entry)
        # the lease half: claim/renew/demote decisions on this same tick
        if self.lease is not None:
            self._lease_tick()
        # automatic STEK rotation (dual-key window: the demoted key still
        # opens tickets minted just before the rotation) — LEADER-ONLY in
        # a replicated control plane: a follower rotating would fork the
        # accept window and orphan every in-flight ticket
        if (self.ticket_key_rotation_s and self.has_authority
                and now - self._last_key_rotation_t
                >= self.ticket_key_rotation_s):
            self._last_key_rotation_t = now
            self._spawn(self.rotate_stek(), "stek rotation")
        for member in self._members_sorted():
            if member.stopped or member.draining or member.last_hb is None:
                # a draining member's exit is PLANNED (rolling restart):
                # declaring it dead would flap the breaker for noise
                continue
            missed_for = now - member.last_hb
            if (member.breaker.state == "closed"
                    and missed_for > self.hb_miss_limit * self.hb_interval):
                # a dead gateway is a breaker-open shard at fleet scope:
                # non-probe failure — open at the base cool-off, arc drains
                # to the ring successors, probes decide re-entry
                member.breaker.record_failure("device")
                logger.warning(
                    "gateway %s missed heartbeats for %.2fs: fleet breaker "
                    "OPEN; ring arc handed to successors",
                    member.gateway_id, missed_for)
                obs_flight.trigger("fleet_gateway_dead",
                                   gateway=member.gateway_id,
                                   missed_for_s=round(missed_for, 3))
                self._fire("gateway_dead", member.gateway_id)
        self._note_rebalance()
        # probe routing through the SHARED placement policy: select_slot
        # prefers a probe-eligible slot — at fleet scope the unit of work
        # it receives is a control canary, never a client session
        live = [m for m in self._members_sorted()
                if not m.stopped and not m.draining]
        slot = select_slot(live)
        if slot is None or not slot.breaker.probe_ready():
            return
        claim = slot.breaker.acquire_dispatch()
        if claim != "probe":
            slot.breaker.release(claim)
            return
        slot._probe_n += 1
        self._spawn(self._probe_gateway(slot, slot._probe_n),
                    f"probe:{slot.gateway_id}")

    def _apply_chaos(self, member: GatewayMember, entry: dict) -> None:
        action = entry.get("action")
        logger.warning("chaos: %s on %s", action, member.gateway_id)
        if action == "kill_gateway":
            self.kill(member.gateway_id)
        elif action == "pause_gateway":
            self.pause(member.gateway_id, float(entry.get("delay_s", 1.0)))
        elif action == "partition":
            self.partition(member.gateway_id,
                           float(entry.get("delay_s", 1.0)))
        elif action == "drain_gateway":
            # graceful-drain chaos: the gateway runs the full drain
            # protocol mid-storm (a kill rule on a later tick makes this
            # the drain-interrupt scenario)
            self._spawn(self.drain(member.gateway_id),
                        f"chaos drain:{member.gateway_id}")

    async def _probe_call(self, member: GatewayMember, n: int) -> None:
        """ONE half-open canary round-trip: send ``__gw_probe__``, await
        the matching reply.  Raises on a dead/partitioned/slow gateway —
        the caller records the outcome to the member's fleet breaker
        (every caller must record the outcome on the breaker)."""
        if member.writer is None:
            raise ConnectionError(f"{member.gateway_id}: no control link")
        if self._clock() < member.partitioned_until:
            raise ConnectionError(f"{member.gateway_id}: partitioned")
        loop = asyncio.get_running_loop()
        member._probe_fut = loop.create_future()
        await control.send_ctrl(member.writer,
                                {"type": control.GW_PROBE, "n": n})
        await asyncio.wait_for(member._probe_fut,
                               self.hb_miss_limit * self.hb_interval)

    async def _probe_gateway(self, member: GatewayMember, n: int) -> None:
        try:
            await self._probe_call(member, n)
        except (asyncio.TimeoutError, ConnectionError, OSError,
                RuntimeError) as e:
            # failed canary: the fleet breaker re-opens with escalating
            # backoff — a SIGKILLed gateway costs one bounded probe per
            # (growing) cool-off, never a client session
            member.breaker.record_failure("probe")
            logger.warning("gateway %s canary probe failed (%s)",
                           member.gateway_id, e)
            self._fire("probe_failed", member.gateway_id)
            return
        member.breaker.record_success("probe")
        # the probe round-trip IS fresh liveness evidence: without this the
        # next health tick would re-declare the just-healed member dead off
        # its stale pre-outage heartbeat timestamp and flap the arc
        member.last_hb = self._clock()
        logger.warning(
            "gateway %s canary probe succeeded: fleet breaker CLOSED; "
            "ring ownership restored", member.gateway_id)
        obs_flight.record("fleet_gateway_healed", gateway=member.gateway_id,
                          probes=n)
        self._fire("gateway_healed", member.gateway_id)
        self._note_rebalance()

    def _note_rebalance(self) -> None:
        healthy = frozenset(
            m.gateway_id for m in self.members.values()
            if not m.stopped and not m.draining
            and m.breaker.state == "closed")
        if healthy != self._last_healthy:
            obs_flight.record(
                "fleet_rebalance", healthy=sorted(healthy),
                avoided=sorted(set(self.members) - healthy))
            self._last_healthy = healthy

    def _spawn(self, coro, what: str) -> None:
        task = asyncio.create_task(coro, name=what)
        self._bg.add(task)
        task.add_done_callback(self._bg.discard)

    # -- routing --------------------------------------------------------------

    def fleet_budget(self) -> int | None:
        """Current fleet admission budget: the sum of per-gateway budgets
        over CLOSED members (a dead gateway's capacity is not capacity).
        None = unlimited (no per-gateway budget configured) — distinct
        from 0, which means a configured fleet with ZERO healthy capacity
        and must shed, not admit unbounded."""
        if not self.per_gateway_max_peers:
            return None
        healthy = sum(1 for m in self.members.values()
                      if not m.stopped and not m.draining
                      and m.breaker.state == "closed")
        return self.per_gateway_max_peers * healthy

    def route(self, peer_id: str,
              exclude: tuple[str, ...] = ()) -> GatewayMember | None:
        """Assign ``peer_id`` a gateway: ring owner first, then ring
        successors that are closed, then the shared placement policy's
        quarantine-aware last resort.  Raises :class:`FleetBusy` when the
        fleet admission budget is exhausted (the wire reply is the typed
        ``__busy__`` frame); returns None when no member is routable.

        ``exclude`` lists gateways the CLIENT just watched fail — honored
        for this query even when their breakers have not opened yet (the
        router may be one heartbeat behind the truth), but never treated
        as failure evidence on its own."""
        budget = self.fleet_budget()
        if budget is not None:
            # count load on the same members the budget counts capacity
            # for: a dead gateway's still-claimed sessions are being
            # re-routed — charging them against the shrunken budget would
            # over-shed during exactly the handoff window
            inflight = sum(m.inflight for m in self.members.values()
                           if not m.stopped and not m.draining
                           and m.breaker.state == "closed")
            if inflight >= budget:
                self.route_sheds += 1
                if self.route_sheds == 1 or self.route_sheds % 64 == 0:
                    logger.warning(
                        "fleet admission budget reached (%d live sessions, "
                        "budget %d): shedding route query (%d shed so far)",
                        inflight, budget, self.route_sheds)
                    obs_flight.record("load_shed", where="fleet_router",
                                      inflight=inflight, budget=budget,
                                      sheds=self.route_sheds)
                raise FleetBusy(
                    f"fleet at capacity ({inflight}/{budget} sessions)")
        chosen: GatewayMember | None = None
        owner: str | None = None
        for gid in self.ring.successors(peer_id):
            if owner is None:
                owner = gid
            member = self.members[gid]
            if (gid in exclude or member.stopped or member.draining
                    or not member.registered):
                continue
            if member.breaker.state == "closed":
                chosen = member
                break
        if chosen is None:
            # no closed member on the ring walk: the shared two-level
            # policy's degraded placement (least-loaded non-quarantined).
            # Unlike the shard scope, the routed unit here is a CLIENT
            # session, never a canary — prefer members that are NOT
            # probe-eligible (a probe-ready member is the one most likely
            # freshly dead; its probe is the health loop's job), falling
            # back to anyone only when every survivor is probe-ready.
            pool = [m for m in self._members_sorted()
                    if not m.stopped and not m.draining and m.registered
                    and m.gateway_id not in exclude]
            non_probe = [m for m in pool if not m.breaker.probe_ready()]
            chosen = select_slot(non_probe or pool)
            if chosen is None:
                return None
            self.rebalance_picks += 1
        if owner is not None and chosen.gateway_id != owner:
            self.handoffs += 1
        chosen.inflight += 1
        chosen.routed_since_hb += 1
        chosen.assigned += 1
        self.routes_ok += 1
        return chosen

    def session_done(self, gateway_id: str) -> None:
        """A routed session ended (client-side signal): release its
        admission slot."""
        member = self.members.get(gateway_id)
        if member is not None and member.inflight > 0:
            member.inflight -= 1

    # -- STEK rotation / graceful drain / rolling restart ---------------------

    async def rotate_stek(self) -> str:
        """Rotate the fleet's ticket-sealing key (the old current stays in
        the accept window) and push the new ring to every live gateway.
        Returns the new epoch.  Tickets minted before the PREVIOUS
        rotation stop resuming — the documented forward-secrecy bound."""
        if not self.has_authority:
            # a follower/demoted replica asked to rotate (operator error,
            # split-brain remnant): refusing here is the local half of the
            # fencing — the wire half is followers rejecting the stale push
            raise RuntimeError(
                f"router {self.router_id} ({self.lease_view()['role']}) "
                "does not hold the lease: STEK rotation refused")
        epoch = self.ticket_keys.rotate()
        self.key_rotations += 1
        obs_flight.record("stek_rotated", epoch=epoch,
                          rotations=self.key_rotations)
        logger.warning("fleet STEK rotated (epoch %s); pushing to %d "
                       "gateway(s)", epoch, len(self.members))
        for member in self._members_sorted():
            if member.writer is None or member.stopped:
                continue
            try:
                await control.send_ctrl(member.writer, {
                    "type": control.GW_TICKET_KEYS,
                    "keys": self.ticket_keys.export(),
                    "lease_epoch": self._lease_epoch(),
                })
            except (ConnectionError, OSError, RuntimeError):
                # a dying gateway misses the push; re-registration (or the
                # respawn after its restart) re-sends the current ring
                logger.warning("STEK push to %s failed", member.gateway_id)
        if self.lease is not None:
            # every rotation replicates: ANY follower must be able to
            # assume the lease without losing the accept window
            await self._replicate_state()
        return epoch

    async def drain(self, gateway_id: str) -> None:
        """Ask one gateway to drain gracefully: it stops admitting,
        flushes outboxes, nudges its peers to resume on their ring
        successor, writes its slo report, and exits 0.  The member is
        excluded from routing (and death detection) until it — or its
        respawned successor — re-registers."""
        member = self.members[gateway_id]
        member.draining = True
        obs_flight.record("fleet_gateway_drain", gateway=gateway_id)
        logger.warning("draining gateway %s (routing excluded)", gateway_id)
        if member.writer is not None:
            try:
                await control.send_ctrl(member.writer, {
                    "type": control.GW_DRAIN,
                    "lease_epoch": self._lease_epoch(),
                })
            except (ConnectionError, OSError, RuntimeError):
                pass  # already dying; the exit path is the same

    async def _await_exit(self, member: GatewayMember,
                          timeout: float) -> bool:
        """Wait for a draining gateway to exit; escalate to SIGKILL/cancel
        on timeout.  True = exited within the grace window."""
        if member.proc is not None:
            try:
                await asyncio.wait_for(member.proc.wait(), timeout)
                return True
            except asyncio.TimeoutError:
                logger.warning("gateway %s ignored drain for %.1fs; killing",
                               member.gateway_id, timeout)
                member.proc.kill()
                await member.proc.wait()
                return False
        if member.task is not None:
            try:
                await asyncio.wait_for(member.task, timeout)
                return True
            except asyncio.TimeoutError:
                member.task.cancel()
                return False
            except asyncio.CancelledError:
                return True  # chaos already cancelled it
            except Exception:
                logger.exception("gateway %s task died during drain",
                                 member.gateway_id)
                return True
        return True

    async def _await_registered(self, member: GatewayMember,
                                timeout: float) -> bool:
        """Poll (real time — respawn is a wall-clock operation) until the
        respawned member's hello lands."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if member.registered:
                return True
            await asyncio.sleep(0.05)
        return member.registered

    async def restart_member(self, gateway_id: str,
                             drain_timeout: float = 30.0) -> dict[str, Any]:
        """Gracefully restart ONE gateway: drain -> wait for exit ->
        respawn -> wait for re-registration (the STEK ring rides the
        re-registration hello, so pre-restart tickets resume on the new
        process)."""
        member = self.members[gateway_id]
        t0 = time.monotonic()
        await self.drain(gateway_id)
        graceful = await self._await_exit(member, drain_timeout)
        member.reset_for_respawn()
        await self._spawn_member(member)
        registered = await self._await_registered(member,
                                                  self._register_timeout)
        out = {
            "gateway": gateway_id,
            "graceful_exit": graceful,
            "registered": registered,
            "took_s": round(time.monotonic() - t0, 3),
        }
        obs_flight.record("fleet_gateway_restarted", **out)
        if not registered:
            logger.error("gateway %s never re-registered after restart",
                         gateway_id)
        return out

    async def rolling_restart(self,
                              drain_timeout: float = 30.0) -> dict[str, Any]:
        """Restart the whole fleet one gateway at a time (docs/robustness.md
        "Rolling restarts"): each member is drained (its peers nudged to
        resume — via ticket — on the ring successor), awaited, respawned,
        and re-registered before the next begins, so the fleet never loses
        more than one gateway of capacity and every moved session resumes
        for two HKDFs instead of a full handshake."""
        results = []
        for gateway_id in sorted(self.members):
            if self.members[gateway_id].stopped:
                continue
            results.append(await self.restart_member(gateway_id,
                                                     drain_timeout))
        ok = all(r["registered"] for r in results)
        obs_flight.record("fleet_rolling_restart",
                          gateways=[r["gateway"] for r in results], ok=ok)
        return {"restarted": results, "ok": ok}

    def _route_reply(self, msg: dict) -> dict:
        peer_id = str(msg.get("peer_id", ""))
        exclude = tuple(str(g) for g in msg.get("exclude") or ())
        try:
            member = self.route(peer_id, exclude)
        except FleetBusy:
            return {"type": control.BUSY, "scope": "fleet"}
        if member is None:
            return {"type": control.NO_ROUTE}
        return {"type": control.ROUTE_OK, "gateway": member.gateway_id,
                "host": member.host or self.host, "port": member.port}

    # -- fleet SLO aggregation ------------------------------------------------

    def _sum_totals(self, name: str) -> tuple[float, float]:
        good = bad = 0.0
        for m in self.members.values():
            pair = m.slo_totals.get(name)
            if isinstance(pair, (list, tuple)) and len(pair) == 2:
                good += float(pair[0])
                bad += float(pair[1])
        return good, bad

    def _sum_stat(self, key: str) -> float:
        return float(sum(float(m.stats.get(key) or 0.0)
                         for m in self.members.values()))

    def _build_slo_engine(self) -> obs_slo.SLOEngine:
        """ONE multi-window burn engine over the SUMS of every gateway's
        probe totals (heartbeat feed) — the per-node reports merged live;
        obs.slo.merge_reports computes the same aggregation offline from the
        slo_report.json files."""
        eng = obs_slo.SLOEngine(registry=self.registry, clock=self._clock)
        eng.add(obs_slo.SLOSpec(
            "fleet_handshake_p99", objective=0.99,
            probe=lambda: self._sum_totals("handshake_p99"),
            description="fleet-wide initiated handshakes within the "
                        "latency threshold (sum of per-gateway totals)",
        ))
        eng.add(obs_slo.SLOSpec(
            "fleet_shed_rate", objective=0.99,
            probe=self._shed_probe,
            description="admission decisions accepted vs shed across the "
                        "router and every gateway boundary",
            fast_burn=10.0, slow_burn=1.0,
        ))
        eng.add(obs_slo.SLOSpec(
            "fleet_device_served", objective=0.9,
            probe=lambda: (self._sum_stat("device_trips"),
                           self._sum_stat("fallback_trips")),
            description="dispatch steps served from the device path "
                        "across every gateway (vs cpu fallback)",
            fast_burn=5.0, slow_burn=2.0,
        ))
        eng.add(obs_slo.SLOSpec(
            "fleet_gateway_availability", objective=0.95,
            probe=self._availability_probe,
            description="gateway-seconds the fleet breakers were closed "
                        "vs degraded (dead/partitioned/probing)",
            fast_burn=5.0, slow_burn=1.0,
        ))
        return eng

    def _shed_probe(self) -> tuple[float, float]:
        good, bad = self._sum_totals("gateway_shed_rate")
        return good + self.routes_ok, bad + self.route_sheds

    def _availability_probe(self) -> tuple[float, float]:
        bad = sum(m.breaker.degraded_seconds()
                  for m in self.members.values())
        total = len(self.members) * (self._clock() - self._t0)
        return max(0.0, total - bad), bad

    def slo_status(self) -> dict[str, Any]:
        return self.slo.status()

    def fleet_cost_totals(self) -> dict[str, Any]:
        """Fleet-wide device-cost economics: the numeric cost totals each
        gateway's heartbeat carries (obs/cost.py ``CostLedger.totals``),
        summed — plus the derived fleet padding-waste fraction."""
        sums: dict[str, Any] = {}
        per_gateway: dict[str, Any] = {}
        for m in self._members_sorted():
            cost = m.stats.get("cost")
            if not isinstance(cost, dict):
                continue
            per_gateway[m.gateway_id] = cost
            for k, v in cost.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    # int seed keeps event counts ints in the artifact
                    # (float fields stay float through float addition)
                    sums[k] = sums.get(k, 0) + v
        # the ratio fields must be re-derived from the summed raw counts,
        # not summed themselves (a sum of fractions is meaningless)
        for ratio in ("padding_waste_fraction", "opcache_hit_rate_cumulative"):
            sums.pop(ratio, None)
        total = sums.get("items_real", 0) + sums.get("items_padded", 0)
        sums["padding_waste_fraction"] = (
            round(sums.get("items_padded", 0) / total, 6) if total else None)
        looked = sums.get("opcache_hits", 0) + sums.get("opcache_misses", 0)
        sums["opcache_hit_rate_cumulative"] = (
            round(sums.get("opcache_hits", 0) / looked, 6) if looked else None)
        return {"fleet": sums, "per_gateway": per_gateway}

    def fleet_view(self) -> dict[str, Any]:
        """The aggregated ``/fleet`` document the router's telemetry
        endpoint serves: the summed SLO engine's burn report + the
        heartbeat cost totals + per-member routing/liveness state (each
        member row carries its own telemetry port, so a dashboard can
        walk from the router to every gateway's scrape)."""
        return {
            "router": self.stats(),
            "slo": self.slo_status(),
            "cost": self.fleet_cost_totals(),
        }

    # -- reporting ------------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        return {
            "gateways": len(self.members),
            "router_id": self.router_id,
            "lease": self.lease_view(),
            "lease_rejects": self.lease_rejects,
            "lease_fenced": self.lease_fenced,
            "syncs_applied": self.syncs_applied,
            "spawn": self.spawn,
            "seed": self.seed,
            "ring_vnodes": self.ring.vnodes,
            "routes_ok": self.routes_ok,
            "route_sheds": self.route_sheds,
            "rebalance_picks": self.rebalance_picks,
            "handoffs": self.handoffs,
            "fleet_budget": self.fleet_budget(),
            "stek_epoch": self.ticket_keys.current_epoch,
            "stek_rotations": self.key_rotations,
            "members": [m.snapshot() for m in self._members_sorted()],
        }

    def collect_reports(self) -> list[dict[str, Any]]:
        """The per-node ``slo_report.json`` documents the gateways wrote
        on shutdown (report_dir), for :func:`obs.slo.merge_reports`."""
        if self.report_dir is None:
            return []
        out = []
        for path in sorted(self.report_dir.glob("*_slo_report.json")):
            try:
                out.append(json.loads(path.read_text()))
            except (OSError, ValueError):
                logger.warning("unreadable slo report %s", path)
        return out
