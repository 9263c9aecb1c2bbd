"""Multi-process fleet chaos storms: a gateway fleet's and a replicated
router fleet's.

Counterpart of the JAX package's ``fleet/storm.py``, method for method,
over the port's gateway fleet, router fleet, engine and providers.  It
differs in five places:

* both storms take a ``backend`` ("cuda" by default; that module
  hard-codes "tpu"): the client plane's providers and engine run on it,
  and it reaches every gateway through ``gateway_kw["backend"]``;
* ``providers`` defaults to "real" (ML-KEM-768 x ML-DSA-65, fused),
  where that module defaults to the stdlib storm toys;
* the clients seal with the gateways' AEAD: :class:`StormAEAD` with the
  toys, as there, and ChaCha20-Poly1305 with the real providers (that
  module's clients always seal with :class:`StormAEAD`, which a gateway
  serving a real AEAD rejects with ``algorithm_mismatch``).  The client
  plane's batched AEAD (K8 on "cuda") is shared by every client, as its
  KEM, signature and fused queues are;
* secret keys are wiped by the port's ``utils/wipe.py``, and the client
  plane's engine is closed (its device workers stopped) on the way out.
* after a router kill, :func:`run_router_storm` reads the routers only
  once a live replica holds the lease again (within
  :data:`LEASE_SETTLE_TIMEOUT_S`).  That module reads them the moment its
  sessions end, and a follower claims a lease TTL plus its rank's stagger
  after the last renewal it saw: its 12-session leader-kill storm outlives
  the claim by 0.25-0.30 s on an idle host, and by 0.03-0.07 s when no
  stall of the loop lengthens the sessions, so its report can show no
  leader at all (ROADMAP C8).

:func:`run_fleet_storm` drives ``sessions`` live peers through a
:class:`fleet.manager.GatewayFleet` over real TCP — every session asks
the router which gateway owns it (consistent-hash assignment, typed
``__busy__`` shed at the fleet admission budget), dials that gateway's OWN
process, runs the full authenticated handshake, and delivers its bulk
messages.  Gateway death is the measured case, not an abort: a session
whose gateway dies — mid-handshake or mid-session — re-routes to the ring
successor, re-keys, and resumes delivery from where it stopped
(undelivered messages are preserved client-side and re-sent under the NEW
session key; nothing is ever sent in plaintext because the engine refuses
to send without a shared key).  The acceptance currency:

* ``lost_established_sessions == 0`` — no session that completed a
  handshake failed to finish its workload;
* a BOUNDED handshake-failure burst (``handshake_failures`` counts
  failed attempts; the kill makes some inevitable, the ring handoff
  makes them finite);
* fleet ``device_served_fraction >= 0.9`` summed across every gateway
  process and the client plane.

Chaos rides the seeded fault plan's ``process`` scope (faults/plan.py):
the fleet health loop polls ``process_control(gateway)`` per gateway per
tick in sorted order, so the ``injected`` log is byte-reproducible from
the seed.  :func:`run_router_storm` is the control-plane twin: the same
data plane behind replicated routers (fleet/router.py), with the chaos on
the routers.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import random
import tempfile
import time
from collections import deque
from pathlib import Path
from typing import Any

from ..faults import FaultPlan
from ..obs import slo as obs_slo
from ..utils.wipe import wipe
from . import control
from .manager import GatewayFleet
from .stormlib import (StormAEAD, prewarm_facades, register_storm_providers,
                       storm_env)

logger = logging.getLogger(__name__)

#: how long a router storm waits, after a kill, for a live replica to hold
#: the lease before it reads the routers (it returns as soon as one does: a
#: follower claims ttl + rank x stagger after the last renewal it saw)
LEASE_SETTLE_TIMEOUT_S = 30.0


def _storm_providers(providers: str) -> tuple[str, str, Any]:
    """The handshake's KEM and signature names and the AEAD instance a
    storm's clients use: the gateways' own choice for ``providers``
    (fleet/gateway.py), so every handshake negotiates."""
    if providers == "stdlib":
        return "STORM-KEM", "STORM-SIG", StormAEAD()
    from ..provider import get_symmetric

    return "ML-KEM-768", "ML-DSA-65", get_symmetric("ChaCha20-Poly1305")


def default_kill_rules(gateway: str = "gw1", tick: int = 8) -> list:
    """The canonical mid-storm chaos: SIGKILL one gateway on its Nth
    health tick (~``tick * hb_interval`` seconds in)."""
    from ..faults import FaultRule

    return [FaultRule("process", "kill_gateway",
                      match={"gateway": gateway}, nth=tick)]


async def run_fleet_storm(
    sessions: int = 1000,
    gateways: int = 3,
    providers: str = "real",
    seed: int = 0,
    arrival_rate: float = 0.0,
    concurrency: int = 256,
    msgs_per_session: int = 2,
    spawn: str = "process",
    per_gateway_max_peers: int = 0,
    handshake_budget: int = 0,
    max_batch: int = 4096,
    max_wait_ms: float = 3.0,
    autotune: bool = True,
    hb_interval: float = 0.25,
    ke_timeout: float = 120.0,
    session_attempts: int = 4,
    prewarm_cap: int = 256,
    fault_rules=None,
    report_dir: str | Path | None = None,
    telemetry: bool = False,
    scrape_cb=None,
    roll: bool = False,
    roll_delay_s: float = 3.0,
    drain_timeout: float = 30.0,
    msg_interval_s: float = 0.0,
    backend: str = "cuda",
) -> dict[str, Any]:
    """One seeded fleet storm; returns the JSON-ready report.

    ``telemetry=True`` arms the live HTTP endpoints (obs/http.py): the
    router serves ``/fleet`` and every gateway its own ephemeral scrape
    surface.  ``scrape_cb(endpoints)`` — a scraper of those surfaces — is
    called WHILE the gateways are still alive (just before drain) with
    ``{gateway_id: "host:port"}`` and its return value lands in the report
    as ``cost_snapshot``.

    ``roll=True`` runs a mid-storm ROLLING RESTART of every gateway
    (``GatewayFleet.rolling_restart`` — each drained, SIGTERM-style, then
    respawned) ``roll_delay_s`` after the first session launches.  A
    displaced session carries its resumption ticket to wherever the ring
    re-routes it, so post-restart reconnects are cheap 1-RTT resumes —
    the report splits them (``post_roll_resumed`` vs ``post_roll_full``),
    whose acceptance is a >=90% resume rate.

    ``backend`` runs the client plane's providers and engine, and every
    gateway's, on "cuda" (the default) or "cpu"."""
    register_storm_providers()
    from ..app.messaging import SecureMessaging
    from ..net.p2p_node import P2PNode
    from ..provider import get_kem, get_signature

    kem_name, sig_name, aead = _storm_providers(providers)
    rng = random.Random(seed)
    tmp_reports = report_dir is None
    if tmp_reports:
        report_dir = Path(tempfile.mkdtemp(prefix="qrp2p_fleet_"))
    report_dir = Path(report_dir)

    fleet = GatewayFleet(
        gateways, spawn=spawn, providers=providers, seed=seed,
        hb_interval=hb_interval,
        per_gateway_max_peers=per_gateway_max_peers,
        handshake_budget=handshake_budget,
        report_dir=report_dir,
        telemetry_port=0 if telemetry else None,
        gateway_kw={
            "max_batch": max_batch, "max_wait_ms": max_wait_ms,
            "autotune": autotune, "ke_timeout": ke_timeout,
            "backend": backend,
            # the ring does not split load perfectly: a gateway's share of
            # the concurrent window can exceed concurrency/N, so warm each
            # gateway up to the FULL concurrency (capped) — a cold bucket
            # silently degrades its whole share to the cpu fallback
            "prewarm_cap": min(prewarm_cap, max(1, concurrency)),
        },
    )

    clients: list[Any] = []
    established_sessions = 0
    completed = 0
    failures = 0
    lost_established = 0
    handoffs = 0
    handshake_failures = 0
    route_busy = 0
    msgs_delivered = 0
    first_lat: list[float] = []
    # resumption accounting: reconnects of ALREADY-established sessions,
    # split by whether the ticket resumed (vs a full re-handshake) and by
    # whether they happened after the rolling restart began — the >=90%
    # post-restart resume rate is the roll's acceptance currency
    resumed_reconnects = 0
    full_reconnects = 0
    post_roll_resumed = 0
    post_roll_full = 0
    reconnects_no_ticket = [0]
    roll_state: dict[str, Any] = {"t0": None, "report": None}

    proto = None
    with storm_env(ke_timeout, fd_need=4 * sessions + 128):
        # Everything below unwinds through the finally: the gateway
        # subprocesses are spawned start_new_session=True, so a raising
        # session task that skipped fleet.stop() would ORPHAN them (holding
        # their ports) and leak every client socket — the fleet-scope twin
        # of the storm_env restore guarantee.
        try:
            await fleet.start()
            # shared client-side batching plane (the storm-bench proto
            # pattern): every client coalesces into one set of queues
            proto = SecureMessaging(
                P2PNode(node_id="proto", host="127.0.0.1", port=0),
                kem=get_kem(kem_name, backend), symmetric=aead,
                signature=get_signature(sig_name, backend), backend=backend,
                use_batching=True, max_batch=max_batch,
                max_wait_ms=max_wait_ms, autotune=autotune,
            )
            await proto.wait_ready()
            if prewarm_cap and proto._bkem is not None:
                # the client plane sees the FULL concurrency (every initiator
                # coalesces into these queues): warm its reachable buckets
                await prewarm_facades(
                    (proto._bkem, proto._bsig, proto._bfused),
                    min(max_batch, max(concurrency, 1), prewarm_cap))
            kp_pks, kp_sks = proto.signature.generate_keypair_batch(sessions)
            sem = asyncio.Semaphore(concurrency)

            def make_client(i: int):
                node = P2PNode(node_id=f"peer{i:05d}", host="127.0.0.1", port=0)
                sm = SecureMessaging(
                    node, kem=proto.kem, symmetric=proto.symmetric,
                    signature=proto.signature,
                    sig_keypair=(bytes(kp_pks[i]), bytes(kp_sks[i])),
                    backend=backend,
                    # fleet handoff replaces single-peer healing: a dead
                    # gateway must be LEFT dead and its arc re-routed, not
                    # redialed at its last known (now vacant) address
                    auto_heal=False,
                )
                sm._bkem, sm._bsig, sm._bfused, sm._baead = (
                    proto._bkem, proto._bsig, proto._bfused, proto._baead)
                sm.use_batching = True
                clients.append(sm)
                return sm

            async def route(peer_id: str, exclude: list[str]):
                """Bounded route-query retry: BUSY backs off (the typed fleet
                shed), transport errors retry, NO_ROUTE gives up."""
                nonlocal route_busy
                delay = 0.1
                for _ in range(6):
                    try:
                        reply = await control.route_query(
                            fleet.host, fleet.ctrl_port, peer_id, exclude)
                    except (OSError, asyncio.TimeoutError, ValueError):
                        await asyncio.sleep(delay)
                        delay *= 2
                        continue
                    rtype = reply.get("type")
                    if rtype == control.ROUTE_OK:
                        return reply
                    if rtype == control.BUSY:
                        route_busy += 1
                        if str(reply.get("scope") or "fleet") == "fleet":
                            # fleet-wide saturation: re-asking sooner cannot
                            # help, every member counts against one budget
                            await asyncio.sleep(delay)
                            delay *= 2
                        # a narrower shed scope re-asks immediately — the
                        # router can still route around a busy member
                        continue
                    if rtype == control.NO_ROUTE:
                        # NO_ROUTE is TRANSIENT during a rolling restart
                        # (one gateway draining + one freshly dead can
                        # empty the pool for a beat): back off and re-ask —
                        # only a fleet that stays unroutable through the
                        # retry budget gives up
                        await asyncio.sleep(delay)
                        delay *= 2
                        continue
                    # unknown reply verb (version skew): treat as transient
                    await asyncio.sleep(delay)
                    delay *= 2
                return None

            async def one_session(i: int, start_at: float, t_origin: float,
                                  srng: random.Random) -> None:
                nonlocal established_sessions, completed, failures
                nonlocal lost_established, handoffs, handshake_failures
                nonlocal msgs_delivered, resumed_reconnects, full_reconnects
                nonlocal post_roll_resumed, post_roll_full
                delay = start_at - (time.perf_counter() - t_origin)
                if delay > 0:
                    await asyncio.sleep(delay)
                async with sem:
                    peer_id = f"peer{i:05d}"
                    sm = make_client(i)
                    # bounded exclude (the most recent death only): under a
                    # ROLLING restart every gateway fails once — excluding
                    # more than the latest failure can transiently exclude
                    # every survivor and manufacture NO_ROUTE for itself
                    exclude: deque = deque(maxlen=1)
                    was_established = False
                    #: which gateway the held ticket is keyed under — NOT
                    #: simply the previous route target: an intermediate
                    #: failed handshake must not orphan the ticket minted
                    #: by the gateway before it
                    ticket_gid: str | None = None
                    delivered = 0
                    for attempt in range(session_attempts):
                        if attempt:
                            # seeded, bounded reroute jitter: N clients of
                            # one dead/drained gateway must not hammer the
                            # ring successor in the same tick
                            await asyncio.sleep(srng.uniform(0.0, 0.25))
                        reply = await route(peer_id, list(exclude))
                        if reply is None:
                            break
                        gid = reply["gateway"]
                        if await sm.node.connect_to_peer(
                                reply["host"], reply["port"], retries=2) != gid:
                            # dead/unreachable gateway the router has not
                            # noticed yet: exclude it and walk the ring
                            exclude.append(gid)
                            await control.route_done(fleet.host, fleet.ctrl_port,
                                                     gid)
                            continue
                        if ticket_gid is not None and ticket_gid != gid:
                            # fleet handoff: the ticket the dead/drained
                            # gateway minted resumes on the successor (one
                            # STEK ring per fleet)
                            sm.adopt_ticket(gid, sm.take_ticket(ticket_gid))
                            ticket_gid = gid
                        had_ticket = sm.ticket_for(gid) is not None
                        t0 = time.perf_counter()
                        r0 = sm._ctr_resumes_used.value
                        ok = await sm.initiate_key_exchange(gid)
                        resumed = sm._ctr_resumes_used.value > r0
                        if not ok:
                            handshake_failures += 1
                            await control.route_done(fleet.host, fleet.ctrl_port,
                                                     gid)
                            if not sm.node.is_connected(gid):
                                # the gateway died mid-handshake: the typed
                                # retry machinery already backed off; hand the
                                # arc to the ring successor
                                exclude.append(gid)
                            continue
                        if was_established:
                            # a reconnect of a live session: the resume-vs-
                            # full split is the roll's currency
                            after_roll = (roll_state["t0"] is not None
                                          and t0 >= roll_state["t0"])
                            if resumed:
                                resumed_reconnects += 1
                                post_roll_resumed += 1 if after_roll else 0
                            else:
                                full_reconnects += 1
                                post_roll_full += 1 if after_roll else 0
                                if not had_ticket:
                                    # diagnostic split: a full reconnect
                                    # WITH a ticket means a reject/timeout
                                    # (investigate); without one it is the
                                    # mint-delivery race at establishment
                                    reconnects_no_ticket[0] += 1
                        else:
                            first_lat.append(time.perf_counter() - t0)
                            established_sessions += 1
                            was_established = True
                        # the just-established gateway minted (or will
                        # refresh) this session's ticket
                        ticket_gid = gid
                        while delivered < msgs_per_session:
                            sent = await sm.send_message(
                                gid, b"fleet storm %d/%d" % (i, delivered))
                            if sent is None:
                                break
                            delivered += 1
                            msgs_delivered += 1
                            if msg_interval_s:
                                # paced traffic: sessions LIVE long enough
                                # to be displaced by a mid-storm restart —
                                # back-to-back sends finish in microseconds
                                # and prove nothing about displacement
                                await asyncio.sleep(msg_interval_s)
                        if delivered >= msgs_per_session:
                            completed += 1
                            await control.route_done(fleet.host, fleet.ctrl_port,
                                                     gid)
                            return
                        # mid-session death: preserve the undelivered tail and
                        # hand off to the ring successor (re-key, resume)
                        handoffs += 1
                        exclude.append(gid)
                        await control.route_done(fleet.host, fleet.ctrl_port, gid)
                    failures += 1
                    if was_established:
                        lost_established += 1

            offsets = []
            t = 0.0
            for _ in range(sessions):
                if arrival_rate > 0:
                    t += rng.uniform(0.0, 2.0 / arrival_rate)
                offsets.append(t)

            session_rngs = [random.Random(rng.getrandbits(64))
                            for _ in range(sessions)]
            plan = FaultPlan(seed, list(fault_rules)) if fault_rules else None
            ctx = plan.activate() if plan is not None else None
            if ctx is not None:
                ctx.__enter__()
            t_origin = time.perf_counter()
            roll_task = None
            if roll:
                async def _roll() -> None:
                    # mid-storm rolling restart: drain -> respawn -> re-
                    # register every gateway in turn while the sessions run
                    await asyncio.sleep(roll_delay_s)
                    roll_state["t0"] = time.perf_counter()
                    roll_state["report"] = await fleet.rolling_restart(
                        drain_timeout=drain_timeout)

                roll_task = asyncio.create_task(_roll())
            try:
                await asyncio.gather(*(
                    one_session(i, offsets[i], t_origin, session_rngs[i])
                    for i in range(sessions)))
                if roll_task is not None:
                    await roll_task
            finally:
                if roll_task is not None:
                    roll_task.cancel()
                if ctx is not None:
                    ctx.__exit__(None, None, None)
            elapsed = time.perf_counter() - t_origin

            fleet_slo = fleet.slo_status()
            fleet_stats = fleet.stats()
            proto_metrics = proto.metrics()
            # fleet-wide device-cost economics (obs/cost.py): the heartbeat
            # totals the router summed, plus the driver-side client plane
            fleet_cost = fleet.fleet_cost_totals()
            fleet_cost["client_plane"] = proto.cost.totals()
            telemetry_info = None
            cost_snapshot = None
            if telemetry:
                telemetry_info = {
                    "router_port": (fleet.telemetry.port
                                    if fleet.telemetry is not None else None),
                    "gateways": {m.gateway_id: m.telemetry_port
                                 for m in fleet._members_sorted()},
                }
                if scrape_cb is not None:
                    # scrape the LIVE per-gateway endpoints before drain.
                    # A killed gateway's endpoint is gone; the scraper
                    # reports it unreachable.
                    endpoints = {
                        m.gateway_id: f"{fleet.host}:{m.telemetry_port}"
                        for m in fleet._members_sorted()
                        if m.telemetry_port
                    }
                    try:
                        cost_snapshot = await asyncio.get_running_loop(
                        ).run_in_executor(None, scrape_cb, endpoints)
                    except Exception:
                        logger.exception("telemetry scrape failed")
        finally:
            await fleet.stop()
            for sm in clients:
                try:
                    await sm.node.stop()
                except (ConnectionError, OSError, RuntimeError):
                    logger.exception("client node stop failed")
            if proto is not None:
                await proto.node.stop()
                proto.close()

    # fleet-wide device-served: every gateway process's queue totals (the
    # final __gw_bye__ stats; heartbeat stats as fallback for a killed
    # gateway) plus the driver-side client plane
    total_ops = fb_ops = 0
    per_gateway: dict[str, Any] = {}
    for m in fleet._members_sorted():
        stats = m.final_stats or m.stats
        per_gateway[m.gateway_id] = stats
        total_ops += int(stats.get("ops") or 0)
        fb_ops += int(stats.get("fallback_ops") or 0)
    for fam in ("kem_queue", "sig_queue", "fused_queue"):
        for q in proto_metrics.get(fam, {}).values():
            total_ops += q["ops"]
            fb_ops += q["fallback_ops"]
    reports = fleet.collect_reports()
    merged = obs_slo.merge_reports(reports) if reports else None
    if tmp_reports:
        # scratch report dir (smoke / parity runs): reports are merged
        # above, so don't leak one /tmp/qrp2p_fleet_* per invocation
        import shutil

        shutil.rmtree(report_dir, ignore_errors=True)

    f_sorted = sorted(first_lat)

    def pct(p: float):
        if not f_sorted:
            return None
        return round(f_sorted[min(len(f_sorted) - 1,
                                  int(len(f_sorted) * p / 100.0))], 4)

    out: dict[str, Any] = {
        "workload": "fleet_storm",
        "sessions": sessions,
        "gateways": gateways,
        "spawn": spawn,
        "providers": ("stdlib-toy (serving-loop workload)"
                      if providers == "stdlib"
                      else f"{kem_name}+{sig_name}"),
        "seed": seed,
        "arrival_rate": arrival_rate,
        "concurrency": concurrency,
        "msgs_per_session": msgs_per_session,
        "elapsed_s": round(elapsed, 3),
        "established_sessions": established_sessions,
        "completed_sessions": completed,
        "failures": failures,
        "lost_established_sessions": lost_established,
        "handoffs": handoffs,
        "handshake_failures": handshake_failures,
        "route_busy": route_busy,
        "msgs_delivered": msgs_delivered,
        # reconnects of established sessions, split resume-vs-full (and by
        # whether they fell after the rolling restart began): the ticket
        # machinery's acceptance currency (docs/protocol.md "Session
        # resumption"; a roll's acceptance gates on the post-roll rate)
        "resumed_reconnects": resumed_reconnects,
        "full_handshake_reconnects": full_reconnects,
        "ticket_resume_rate": (
            round(resumed_reconnects / (resumed_reconnects + full_reconnects),
                  4) if (resumed_reconnects + full_reconnects) else None),
        "post_roll_resumed": post_roll_resumed,
        "post_roll_full": post_roll_full,
        "post_roll_resume_rate": (
            round(post_roll_resumed / (post_roll_resumed + post_roll_full), 4)
            if (post_roll_resumed + post_roll_full) else None),
        "full_reconnects_without_ticket": reconnects_no_ticket[0],
        "client_resumes_used": sum(
            sm._ctr_resumes_used.value for sm in clients),
        "client_resume_fallbacks": sum(
            sm._ctr_resume_fallbacks.value for sm in clients),
        "roll": roll_state["report"],
        # the engine refuses to send without a shared key (fail-closed,
        # tests/test_faults.py pins it) and this harness only sends
        # through send_message — plaintext on the wire is structurally
        # impossible; the field records the claim the chaos gate makes
        "plaintext_sends": 0,
        "handshakes_per_s": (round(established_sessions / elapsed, 2)
                             if elapsed else None),
        "p50_handshake_s": pct(50),
        "p99_handshake_s": pct(99),
        "device_served_fraction": (
            round((total_ops - fb_ops) / total_ops, 4) if total_ops else None),
        "fleet": fleet_stats,
        "per_gateway": per_gateway,
        "fleet_slo": fleet_slo,
        "fleet_slo_merged": merged,
        "fleet_cost": fleet_cost,
    }
    if telemetry_info is not None:
        out["telemetry"] = telemetry_info
    if cost_snapshot is not None:
        out["cost_snapshot"] = cost_snapshot
    wipe(kp_sks)  # every session adopted its own copy at construction
    if plan is not None:
        out["chaos"] = {
            "seed": plan.seed,
            "injected": len(plan.injected),
            "injected_log": plan.injected,
        }
    return out


def default_router_kill_rules(router: str = "rt0", tick: int = 8) -> list:
    """The canonical control-plane chaos: SIGKILL one ROUTER replica —
    by convention rt0, rank 0, the deterministic initial leaseholder —
    on its Nth chaos tick (~``tick * hb_interval`` seconds in)."""
    from ..faults import FaultRule

    return [FaultRule("process", "kill_router",
                      match={"router": router}, nth=tick)]


async def run_router_storm(
    sessions: int = 1000,
    gateways: int = 3,
    routers: int = 2,
    providers: str = "real",
    seed: int = 0,
    arrival_rate: float = 0.0,
    concurrency: int = 256,
    msgs_per_session: int = 4,
    spawn: str = "process",
    per_gateway_max_peers: int = 0,
    handshake_budget: int = 0,
    max_batch: int = 4096,
    max_wait_ms: float = 3.0,
    autotune: bool = True,
    hb_interval: float = 0.25,
    ke_timeout: float = 120.0,
    session_attempts: int = 6,
    prewarm_cap: int = 256,
    fault_rules=None,
    report_dir: str | Path | None = None,
    roll: bool = True,
    roll_delay_s: float = 3.0,
    lease_ttl_s: float = 1.0,
    lease_stagger_s: float = 0.2,
    msg_interval_s: float = 0.0,
    backend: str = "cuda",
) -> dict[str, Any]:
    """The ROUTER-roll storm: same live data plane as
    :func:`run_fleet_storm`, but the control plane is N replicated
    routers (fleet/router.py) and the chaos targets THEM — a seeded
    mid-storm SIGKILL of the leader replica plus (``roll=True``) a
    rolling restart of every router.  The acceptance currency:

    * ``lost_established_sessions == 0`` — router death must be invisible
      to established sessions (the gateways keep serving; only routing
      and STEK authority move);
    * ``plaintext_sends == 0`` — structural, as in every storm;
    * ``post_failover_resume_rate >= 0.9`` — reconnects AFTER the leader
      died still redeem tickets minted under the dead leader's STEK
      (replicated dual-key window, docs/fleet.md "HA control plane").

    Every session deliberately drops its gateway connection mid-workload
    and reconnects: gateways survive this storm, so without the forced
    drop there would be nothing for the ticket machinery to prove.
    Clients walk the ROUTER ring (successors of their peer id) for route
    queries, failing over to the next replica on transport errors with
    the usual typed-busy/backoff + seeded-jitter discipline.

    ``backend`` runs the client plane's providers and engine, and every
    gateway's, on "cuda" (the default) or "cpu"; the router replicas run
    no crypto.
    """
    register_storm_providers()
    from ..app.messaging import SecureMessaging
    from ..net.p2p_node import P2PNode
    from ..provider import get_kem, get_signature
    from .router import RouterFleet

    kem_name, sig_name, aead = _storm_providers(providers)
    rng = random.Random(seed)
    tmp_reports = report_dir is None
    if tmp_reports:
        report_dir = Path(tempfile.mkdtemp(prefix="qrp2p_rroll_"))
    report_dir = Path(report_dir)

    rf = RouterFleet(
        routers, gateways, spawn=spawn, providers=providers, seed=seed,
        hb_interval=hb_interval,
        per_gateway_max_peers=per_gateway_max_peers,
        handshake_budget=handshake_budget,
        report_dir=report_dir,
        lease_ttl_s=lease_ttl_s, lease_stagger_s=lease_stagger_s,
        gateway_kw={
            "max_batch": max_batch, "max_wait_ms": max_wait_ms,
            "autotune": autotune, "ke_timeout": ke_timeout,
            "backend": backend,
            "prewarm_cap": min(prewarm_cap, max(1, concurrency)),
        },
    )

    clients: list[Any] = []
    established_sessions = 0
    completed = 0
    failures = 0
    lost_established = 0
    handoffs = 0
    handshake_failures = 0
    route_busy = 0
    router_failovers = 0
    msgs_delivered = 0
    forced_drops = 0
    first_lat: list[float] = []
    resumed_reconnects = 0
    full_reconnects = 0
    post_failover_resumed = 0
    post_failover_full = 0
    #: perf_counter stamp of the FIRST control-plane event (chaos kill or
    #: roll start) — reconnects at/after it count as post-failover
    failover_state: dict[str, Any] = {"t0": None, "kill_t0": None,
                                      "roll_t0": None, "report": None}

    def _mark_failover(key: str) -> None:
        now = time.perf_counter()
        failover_state[key] = now
        if failover_state["t0"] is None or now < failover_state["t0"]:
            failover_state["t0"] = now

    proto = None
    leader0: str | None = None
    final_router_stats: dict[str, Any] | None = None
    with storm_env(ke_timeout, fd_need=4 * sessions + 256):
        try:
            await rf.start()
            leader0 = await rf.leader_id()
            proto = SecureMessaging(
                P2PNode(node_id="proto", host="127.0.0.1", port=0),
                kem=get_kem(kem_name, backend), symmetric=aead,
                signature=get_signature(sig_name, backend), backend=backend,
                use_batching=True, max_batch=max_batch,
                max_wait_ms=max_wait_ms, autotune=autotune,
            )
            await proto.wait_ready()
            if prewarm_cap and proto._bkem is not None:
                await prewarm_facades(
                    (proto._bkem, proto._bsig, proto._bfused),
                    min(max_batch, max(concurrency, 1), prewarm_cap))
            kp_pks, kp_sks = proto.signature.generate_keypair_batch(sessions)
            sem = asyncio.Semaphore(concurrency)

            def make_client(i: int):
                node = P2PNode(node_id=f"peer{i:05d}", host="127.0.0.1",
                               port=0)
                sm = SecureMessaging(
                    node, kem=proto.kem, symmetric=proto.symmetric,
                    signature=proto.signature,
                    sig_keypair=(bytes(kp_pks[i]), bytes(kp_sks[i])),
                    backend=backend, auto_heal=False,
                )
                sm._bkem, sm._bsig, sm._bfused, sm._baead = (
                    proto._bkem, proto._bsig, proto._bfused, proto._baead)
                sm.use_batching = True
                clients.append(sm)
                return sm

            async def route(peer_id: str, exclude: list[str],
                            srng: random.Random):
                """Walk the ROUTER ring (per-peer successor order) with
                bounded retries: a dead replica is skipped — the client-
                visible face of the failover — BUSY backs off (typed
                fleet shed), NO_ROUTE is transient during re-registration
                after a respawn."""
                nonlocal route_busy, router_failovers
                delay = 0.1
                for _ in range(8):
                    for rid in rf.router_ring.successors(peer_id):
                        m = rf.routers[rid]
                        try:
                            reply = await control.route_query(
                                m.host, m.ctrl_port, peer_id, exclude)
                        except (OSError, asyncio.TimeoutError, ValueError):
                            # replica down/respawning: the next ring
                            # successor answers instead
                            router_failovers += 1
                            continue
                        rtype = reply.get("type")
                        if rtype == control.ROUTE_OK:
                            return reply, rid
                        if rtype == control.BUSY:
                            route_busy += 1
                            break  # one budget fleet-wide: back off
                        # NO_ROUTE / unknown verb: transient, back off
                        break
                    await asyncio.sleep(delay * (0.5 + srng.random()))
                    delay = min(delay * 2, 2.0)
                return None, None

            async def done(gid: str, rid_hint: str | None) -> None:
                """Advisory inflight release: any live replica will do."""
                order = list(rf.routers)
                if rid_hint in rf.routers:
                    order.remove(rid_hint)
                    order.insert(0, rid_hint)
                for rid in order:
                    m = rf.routers[rid]
                    try:
                        await control.route_done(m.host, m.ctrl_port, gid)
                        return
                    except (OSError, asyncio.TimeoutError, ValueError):
                        continue

            drop_at = max(1, msgs_per_session // 2)

            async def one_session(i: int, start_at: float, t_origin: float,
                                  srng: random.Random) -> None:
                nonlocal established_sessions, completed, failures
                nonlocal lost_established, handoffs, handshake_failures
                nonlocal msgs_delivered, resumed_reconnects, full_reconnects
                nonlocal post_failover_resumed, post_failover_full
                nonlocal forced_drops
                delay = start_at - (time.perf_counter() - t_origin)
                if delay > 0:
                    await asyncio.sleep(delay)
                async with sem:
                    peer_id = f"peer{i:05d}"
                    sm = make_client(i)
                    exclude: deque = deque(maxlen=1)
                    was_established = False
                    ticket_gid: str | None = None
                    delivered = 0
                    dropped = False
                    for attempt in range(session_attempts):
                        if attempt:
                            await asyncio.sleep(srng.uniform(0.0, 0.25))
                        reply, rid = await route(peer_id, list(exclude), srng)
                        if reply is None:
                            break
                        gid = reply["gateway"]
                        if await sm.node.connect_to_peer(
                                reply["host"], reply["port"],
                                retries=2) != gid:
                            exclude.append(gid)
                            await done(gid, rid)
                            continue
                        if ticket_gid is not None and ticket_gid != gid:
                            sm.adopt_ticket(gid, sm.take_ticket(ticket_gid))
                            ticket_gid = gid
                        t0 = time.perf_counter()
                        r0 = sm._ctr_resumes_used.value
                        ok = await sm.initiate_key_exchange(gid)
                        resumed = sm._ctr_resumes_used.value > r0
                        if not ok:
                            handshake_failures += 1
                            await done(gid, rid)
                            if not sm.node.is_connected(gid):
                                exclude.append(gid)
                            continue
                        if was_established:
                            after = (failover_state["t0"] is not None
                                     and t0 >= failover_state["t0"])
                            if resumed:
                                resumed_reconnects += 1
                                post_failover_resumed += 1 if after else 0
                            else:
                                full_reconnects += 1
                                post_failover_full += 1 if after else 0
                        else:
                            first_lat.append(time.perf_counter() - t0)
                            established_sessions += 1
                            was_established = True
                        ticket_gid = gid
                        intentional = False
                        while delivered < msgs_per_session:
                            sent = await sm.send_message(
                                gid, b"router storm %d/%d" % (i, delivered))
                            if sent is None:
                                break
                            delivered += 1
                            msgs_delivered += 1
                            if msg_interval_s:
                                await asyncio.sleep(msg_interval_s)
                            if not dropped and delivered == drop_at:
                                # the deliberate mid-workload drop: the
                                # gateways SURVIVE this storm, so without
                                # it no reconnect would ever exercise the
                                # replicated ticket window
                                dropped = True
                                intentional = True
                                forced_drops += 1
                                await sm.node.disconnect_from_peer(gid)
                                break
                        if delivered >= msgs_per_session:
                            completed += 1
                            await done(gid, rid)
                            return
                        if not intentional:
                            # a REAL loss (not our forced drop): hand the
                            # arc to the ring successor as usual
                            handoffs += 1
                            exclude.append(gid)
                        await done(gid, rid)
                    failures += 1
                    if was_established:
                        lost_established += 1

            offsets = []
            t = 0.0
            for _ in range(sessions):
                if arrival_rate > 0:
                    t += rng.uniform(0.0, 2.0 / arrival_rate)
                offsets.append(t)

            session_rngs = [random.Random(rng.getrandbits(64))
                            for _ in range(sessions)]
            plan = FaultPlan(seed, list(fault_rules)) if fault_rules else None
            ctx = plan.activate() if plan is not None else None
            if ctx is not None:
                ctx.__enter__()
            t_origin = time.perf_counter()

            async def _watch_kills() -> None:
                # stamp the moment the chaos kill lands so reconnects can
                # be split pre/post failover (the plan fires inside the
                # RouterFleet's chaos loop, not here)
                while failover_state["kill_t0"] is None:
                    if rf.router_kills > 0:
                        _mark_failover("kill_t0")
                        return
                    await asyncio.sleep(0.05)

            watch_task = asyncio.create_task(_watch_kills())
            roll_task = None
            if roll:
                async def _roll() -> None:
                    await asyncio.sleep(roll_delay_s)
                    _mark_failover("roll_t0")
                    failover_state["report"] = await rf.rolling_restart()

                roll_task = asyncio.create_task(_roll())
            try:
                await asyncio.gather(*(
                    one_session(i, offsets[i], t_origin, session_rngs[i])
                    for i in range(sessions)))
                if roll_task is not None:
                    await roll_task
            finally:
                watch_task.cancel()
                if roll_task is not None:
                    roll_task.cancel()
                if ctx is not None:
                    ctx.__exit__(None, None, None)
            elapsed = time.perf_counter() - t_origin
            if rf.router_kills:
                # past the limit the report shows the routers as they are
                with contextlib.suppress(RuntimeError):
                    await rf.await_leader(LEASE_SETTLE_TIMEOUT_S)
            final_router_stats = await rf.stats()
            proto_metrics = proto.metrics()
            client_cost = proto.cost.totals()
        finally:
            await rf.stop()
            for sm in clients:
                try:
                    await sm.node.stop()
                except (ConnectionError, OSError, RuntimeError):
                    logger.exception("client node stop failed")
            if proto is not None:
                await proto.node.stop()
                proto.close()

    # device-served: the client plane's queue totals (the gateway-side
    # split lands in the merged per-node SLO reports below — no single
    # router holds an authoritative final-stats view in this storm)
    total_ops = fb_ops = 0
    for fam in ("kem_queue", "sig_queue", "fused_queue"):
        for q in proto_metrics.get(fam, {}).values():
            total_ops += q["ops"]
            fb_ops += q["fallback_ops"]
    reports = []
    _loop = asyncio.get_running_loop()
    for path in sorted(report_dir.glob("*_slo_report.json")):
        try:
            text = await _loop.run_in_executor(None, path.read_text)
            reports.append(json.loads(text))
        except (OSError, ValueError):
            logger.warning("unreadable slo report %s", path)
    merged = obs_slo.merge_reports(reports) if reports else None
    if tmp_reports:
        import shutil

        shutil.rmtree(report_dir, ignore_errors=True)

    f_sorted = sorted(first_lat)

    def pct(p: float):
        if not f_sorted:
            return None
        return round(f_sorted[min(len(f_sorted) - 1,
                                  int(len(f_sorted) * p / 100.0))], 4)

    post_total = post_failover_resumed + post_failover_full
    out: dict[str, Any] = {
        "workload": "router_roll_storm",
        "sessions": sessions,
        "gateways": gateways,
        "routers": routers,
        "spawn": spawn,
        "providers": ("stdlib-toy (serving-loop workload)"
                      if providers == "stdlib"
                      else f"{kem_name}+{sig_name}"),
        "seed": seed,
        "arrival_rate": arrival_rate,
        "concurrency": concurrency,
        "msgs_per_session": msgs_per_session,
        "elapsed_s": round(elapsed, 3),
        "initial_leader": leader0,
        "established_sessions": established_sessions,
        "completed_sessions": completed,
        "failures": failures,
        "lost_established_sessions": lost_established,
        "handoffs": handoffs,
        "handshake_failures": handshake_failures,
        "route_busy": route_busy,
        "router_failovers": router_failovers,
        "forced_drops": forced_drops,
        "msgs_delivered": msgs_delivered,
        "resumed_reconnects": resumed_reconnects,
        "full_handshake_reconnects": full_reconnects,
        "ticket_resume_rate": (
            round(resumed_reconnects / (resumed_reconnects + full_reconnects),
                  4) if (resumed_reconnects + full_reconnects) else None),
        # reconnects at/after the first control-plane event (leader kill
        # or roll start): tickets redeemed here were minted under a STEK
        # authority that no longer exists — the HA gate's currency
        "post_failover_resumed": post_failover_resumed,
        "post_failover_full": post_failover_full,
        "post_failover_resume_rate": (
            round(post_failover_resumed / post_total, 4)
            if post_total else None),
        "client_resumes_used": sum(
            sm._ctr_resumes_used.value for sm in clients),
        "client_resume_fallbacks": sum(
            sm._ctr_resume_fallbacks.value for sm in clients),
        "router_kills": rf.router_kills,
        "router_pauses": rf.router_pauses,
        "roll": failover_state["report"],
        "plaintext_sends": 0,
        "handshakes_per_s": (round(established_sessions / elapsed, 2)
                             if elapsed else None),
        "p50_handshake_s": pct(50),
        "p99_handshake_s": pct(99),
        "device_served_fraction": (
            round((total_ops - fb_ops) / total_ops, 4) if total_ops else None),
        "router_fleet": final_router_stats,
        "fleet_slo_merged": merged,
        "client_cost": client_cost,
    }
    wipe(kp_sks)  # every session adopted its own copy at construction
    if plan is not None:
        out["chaos"] = {
            "seed": plan.seed,
            "injected": len(plan.injected),
            "injected_log": plan.injected,
        }
    return out


def write_fleet_artifacts(out: dict[str, Any], out_dir: str | Path) -> None:
    """Write the merged fleet SLO report into ``out_dir``, and nothing
    anywhere else."""
    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    if out.get("fleet_slo_merged") is not None:
        (d / "fleet_slo_report.json").write_text(
            json.dumps({"merged": out["fleet_slo_merged"],
                        "live": out.get("fleet_slo")}, indent=2) + "\n")
