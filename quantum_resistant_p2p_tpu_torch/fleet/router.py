"""Router replica worker + the RouterFleet driver (docs/fleet.md
"HA control plane").

Counterpart of the JAX package's ``fleet/router.py``, method for method,
over the port's gateway fleet, ring, fault plan and flight recorder.  It
differs in three places: a replica runs ``python -m
quantum_resistant_p2p_tpu_torch.fleet.router`` and a gateway ``python -m
quantum_resistant_p2p_tpu_torch.fleet.gateway``; ``providers``
defaults to "real" (the default handshake on the gateways' ``backend``,
"cuda" unless ``gateway_kw`` says otherwise), where that driver defaults
to the stdlib storm toys; and :meth:`RouterFleet.start` returns once every
replica follows one leader, rejoining a replica that came up demoted,
where that driver returns once any replica leads (ROADMAP C8).  A router replica runs no crypto: nothing on its
path creates a CUDA context or places a tensor on the card.

Two halves:

* :func:`run_router` — ONE control-plane replica as its own process
  (``python -m quantum_resistant_p2p_tpu_torch.fleet.router '<json config>'``):
  a :class:`fleet.manager.GatewayFleet` in **attach** mode (fixed control
  port, spawns nothing, members materialize on gateway hellos) with a
  :class:`fleet.lease.LeaderLease` deciding whether THIS replica holds
  STEK-rotation and admission authority.  SIGTERM = graceful stop (close
  the listener, stop renewing — followers claim after the TTL).

* :class:`RouterFleet` — the driver that owns the WHOLE two-tier pod: it
  pre-allocates stable control/telemetry ports, spawns N router replicas
  and G gateway processes (each gateway dials EVERY router), runs the
  seeded chaos tick (``kill_router`` / ``pause_router`` through
  faults/plan.py's ``router_control`` hook), and drives the router-roll:
  SIGTERM → await exit → respawn on the SAME ports → await reachable,
  one replica at a time.  ``spawn="task"`` runs every replica in-process
  for deterministic tests (same code path; kills degrade to abrupt
  listener teardown).

The driver deliberately has NO control-protocol surface of its own: role
discovery goes through each replica's ``/fleet`` telemetry view (or
direct object access in task mode), so the wire protocol stays exactly
the verbs of the control protocol (fleet/control.py).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import socket
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Callable

from ..faults import plan as _faults
from ..obs import flight as obs_flight
from .manager import GatewayFleet
from .ring import HashRing

logger = logging.getLogger(__name__)

#: how long a router respawn may take before the roll declares it wedged
ROUTER_REGISTER_TIMEOUT_S = 30.0


def _free_port(host: str = "127.0.0.1") -> int:
    """Reserve-and-release one ephemeral port: the classic pre-allocation
    trick — a respawned replica must come back on the SAME port the
    gateways' reconnect loops and the clients' failover order are already
    dialing, so the port is chosen before the first spawn."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


# -- the replica worker --------------------------------------------------------


async def run_router(cfg: dict[str, Any],
                     *, ready_cb: Callable[[GatewayFleet], None] | None = None,
                     ) -> None:
    """Run one control-plane replica until SIGTERM/cancellation.

    ``cfg`` keys: ``router_id``, ``rank``, ``ctrl_port``, ``peers``
    (the OTHER replicas: ``[{"router", "host", "port"}, ...]``),
    ``telemetry_port``, plus the GatewayFleet knobs (``hb_interval``,
    ``per_gateway_max_peers``, ``handshake_budget``, ``seed``,
    ``lease_ttl_s``, ``lease_stagger_s``, ``ticket_key_rotation_s``).
    ``ready_cb`` (task mode) receives the live fleet object."""
    fleet = GatewayFleet(
        0,
        attach=True,
        spawn="process",
        seed=int(cfg.get("seed") or 0),
        hb_interval=float(cfg.get("hb_interval") or 0.25),
        hb_miss_limit=int(cfg.get("hb_miss_limit") or 4),
        per_gateway_max_peers=int(cfg.get("per_gateway_max_peers") or 0),
        handshake_budget=int(cfg.get("handshake_budget") or 0),
        host=str(cfg.get("host") or "127.0.0.1"),
        ctrl_port=int(cfg["ctrl_port"]),
        router_id=str(cfg.get("router_id") or "rt0"),
        router_rank=int(cfg.get("rank") or 0),
        router_peers=list(cfg.get("peers") or ()),
        lease_ttl_s=(float(cfg["lease_ttl_s"])
                     if cfg.get("lease_ttl_s") is not None else None),
        lease_stagger_s=(float(cfg["lease_stagger_s"])
                         if cfg.get("lease_stagger_s") is not None else None),
        telemetry_port=(int(cfg["telemetry_port"])
                        if cfg.get("telemetry_port") is not None else None),
        ticket_key_rotation_s=float(cfg.get("ticket_key_rotation_s") or 0.0),
    )
    stop_ev = asyncio.Event()
    loop = asyncio.get_running_loop()
    sigterm_armed = False
    if cfg.get("own_process"):
        try:
            loop.add_signal_handler(signal.SIGTERM, stop_ev.set)
            sigterm_armed = True
        except (NotImplementedError, ValueError, RuntimeError):
            pass
    await fleet.start()
    if ready_cb is not None:
        ready_cb(fleet)
    try:
        await stop_ev.wait()
    finally:
        if sigterm_armed:
            try:
                loop.remove_signal_handler(signal.SIGTERM)
            except (NotImplementedError, ValueError, RuntimeError):
                pass
        await fleet.stop()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m quantum_resistant_p2p_tpu_torch.fleet.router "
              "'<json config>'", file=sys.stderr)
        return 2
    blob = argv[0]
    if not blob.lstrip().startswith("{") and Path(blob).is_file():
        blob = Path(blob).read_text()
    cfg = json.loads(blob)
    cfg["own_process"] = True
    logging.basicConfig(level=logging.WARNING)
    asyncio.run(run_router(cfg))
    return 0


# -- the driver ----------------------------------------------------------------


class RouterMember:
    """Driver-side state for one router replica."""

    def __init__(self, router_id: str, rank: int, host: str,
                 ctrl_port: int, telemetry_port: int):
        self.router_id = router_id
        self.rank = rank
        self.host = host
        self.ctrl_port = ctrl_port
        self.telemetry_port = telemetry_port
        self.proc: Any = None  # spawn="process"
        self.task: asyncio.Task | None = None  # spawn="task"
        self.fleet: GatewayFleet | None = None  # task mode only
        self.killed = False
        self.restarts = 0

    @property
    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.returncode is None
        return self.task is not None and not self.task.done()

    def endpoint(self) -> dict[str, Any]:
        return {"router": self.router_id, "host": self.host,
                "port": self.ctrl_port}


class RouterFleet:
    """N replicated routers + G gateways, all owned by this driver.

    The consistent-hash machinery the data plane uses for peer→gateway
    placement places ROUTERS too: :attr:`router_ring` is a
    :class:`fleet.ring.HashRing` over router ids — clients walk
    ``successors(peer_id)`` for their per-peer failover order, so router
    load spreads and every client agrees on the order without
    coordination."""

    def __init__(
        self,
        routers: int = 2,
        gateways: int = 3,
        *,
        spawn: str = "process",
        providers: str = "real",
        seed: int = 0,
        hb_interval: float = 0.25,
        hb_miss_limit: int = 4,
        per_gateway_max_peers: int = 0,
        handshake_budget: int = 0,
        gateway_kw: dict[str, Any] | None = None,
        report_dir: str | Path | None = None,
        host: str = "127.0.0.1",
        lease_ttl_s: float | None = None,
        lease_stagger_s: float | None = None,
        ticket_key_rotation_s: float = 0.0,
        register_timeout: float = 60.0,
        telemetry: bool = True,
    ):
        if routers < 1:
            raise ValueError(f"need >= 1 router, got {routers}")
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
        self.lease_ttl_s = lease_ttl_s
        self.lease_stagger_s = lease_stagger_s
        self.ticket_key_rotation_s = ticket_key_rotation_s
        self._register_timeout = register_timeout
        self._telemetry = telemetry
        # stable ports BEFORE any spawn: respawns rebind the same ones
        self.routers: dict[str, RouterMember] = {}
        for i in range(routers):
            rid = f"rt{i}"
            self.routers[rid] = RouterMember(
                rid, i, host, _free_port(host),
                _free_port(host) if telemetry else 0)
        #: routers on the SAME ring machinery the data plane uses —
        #: per-peer failover order for clients
        self.router_ring = HashRing(sorted(self.routers), vnodes=16,
                                    seed=seed)
        self.gateway_ids = [f"gw{i}" for i in range(gateways)]
        self._gw_procs: dict[str, Any] = {}
        self._gw_tasks: dict[str, asyncio.Task] = {}
        self._chaos_task: asyncio.Task | None = None
        self._running = False
        self.router_kills = 0
        self.router_pauses = 0

    # -- config ---------------------------------------------------------------

    def router_endpoints(self) -> list[dict[str, Any]]:
        return [m.endpoint() for _rid, m in sorted(self.routers.items())]

    def _router_config(self, member: RouterMember) -> dict[str, Any]:
        peers = [m.endpoint() for rid, m in sorted(self.routers.items())
                 if rid != member.router_id]
        return {
            "router_id": member.router_id,
            "rank": member.rank,
            "host": self.host,
            "ctrl_port": member.ctrl_port,
            "peers": peers,
            "telemetry_port": (member.telemetry_port
                               if self._telemetry else None),
            "hb_interval": self.hb_interval,
            "hb_miss_limit": self.hb_miss_limit,
            "per_gateway_max_peers": self.per_gateway_max_peers,
            "handshake_budget": self.handshake_budget,
            "seed": self.seed,
            "lease_ttl_s": self.lease_ttl_s,
            "lease_stagger_s": self.lease_stagger_s,
            "ticket_key_rotation_s": self.ticket_key_rotation_s,
        }

    def _gateway_config(self, gid: str) -> dict[str, Any]:
        cfg = {
            "gateway_id": gid,
            "bind_host": self.host,
            "routers": self.router_endpoints(),
            "seed": self.seed,
            "providers": self.providers,
            "max_peers": self.per_gateway_max_peers,
            "handshake_budget": self.handshake_budget,
            "hb_interval": self.hb_interval,
            "report_dir": str(self.report_dir) if self.report_dir else None,
            "telemetry_port": 0 if self._telemetry else None,
        }
        cfg.update(self.gateway_kw)
        return cfg

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> None:
        """Routers first (reachable), then gateways, then wait until
        every router has seen every gateway register AND a leader holds
        the lease — the storm must not start against a fleet whose STEK
        authority is still unsettled."""
        if self.report_dir is not None:
            self.report_dir.mkdir(parents=True, exist_ok=True)
        self._running = True
        for _rid, member in sorted(self.routers.items()):
            await self._spawn_router(member)
        await self._await_routers_reachable(self._register_timeout)
        for gid in self.gateway_ids:
            await self._spawn_gateway(gid)
        await self._await_gateways_registered(self._register_timeout)
        await self._await_settled_lease(self._register_timeout)
        self._chaos_task = asyncio.create_task(self._chaos_loop())
        logger.info("router fleet up: %d routers, %d gateways",
                    len(self.routers), len(self.gateway_ids))

    async def _spawn_router(self, member: RouterMember) -> None:
        cfg = self._router_config(member)
        member.killed = False
        if self.spawn == "task":
            member.fleet = None

            def on_ready(fleet: GatewayFleet, m=member) -> None:
                m.fleet = fleet

            member.task = asyncio.create_task(
                run_router(cfg, ready_cb=on_ready),
                name=f"router:{member.router_id}")
            return
        stderr = asyncio.subprocess.DEVNULL
        log_f = None
        if self.report_dir is not None:
            log_path = self.report_dir / f"{member.router_id}.log"
            stderr = log_f = await asyncio.get_running_loop().run_in_executor(
                None, lambda: open(log_path, "ab"))
        try:
            member.proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m",
                "quantum_resistant_p2p_tpu_torch.fleet.router", json.dumps(cfg),
                stdout=asyncio.subprocess.DEVNULL, stderr=stderr,
                start_new_session=True,
            )
        finally:
            if log_f is not None:
                log_f.close()

    async def _spawn_gateway(self, gid: str) -> None:
        cfg = self._gateway_config(gid)
        if self.spawn == "task":
            from .gateway import run_gateway

            self._gw_tasks[gid] = asyncio.create_task(
                run_gateway(cfg), name=f"gateway:{gid}")
            return
        stderr = asyncio.subprocess.DEVNULL
        log_f = None
        if self.report_dir is not None:
            log_path = self.report_dir / f"{gid}.log"
            stderr = log_f = await asyncio.get_running_loop().run_in_executor(
                None, lambda: open(log_path, "wb"))
        try:
            self._gw_procs[gid] = await asyncio.create_subprocess_exec(
                sys.executable, "-m",
                "quantum_resistant_p2p_tpu_torch.fleet.gateway",
                json.dumps(cfg),
                stdout=asyncio.subprocess.DEVNULL, stderr=stderr,
                start_new_session=True,
            )
        finally:
            if log_f is not None:
                log_f.close()

    async def stop(self) -> None:
        """Gateways down first (SIGTERM = graceful drain; they write their
        slo reports), routers after — the reverse of start."""
        self._running = False
        if self._chaos_task is not None:
            self._chaos_task.cancel()
        for gid, proc in sorted(self._gw_procs.items()):
            if proc.returncode is None:
                try:
                    proc.terminate()
                except ProcessLookupError:  # pragma: no cover
                    pass
        for gid, proc in sorted(self._gw_procs.items()):
            try:
                await asyncio.wait_for(proc.wait(), 10.0)
            except asyncio.TimeoutError:
                proc.kill()
                await proc.wait()
        for gid, task in sorted(self._gw_tasks.items()):
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.debug("gateway task %s raised during stop",
                             gid, exc_info=True)
        for _rid, member in sorted(self.routers.items()):
            await self._stop_router(member, graceful=True)

    async def _stop_router(self, member: RouterMember,
                           graceful: bool) -> None:
        if member.proc is not None:
            if member.proc.returncode is None:
                try:
                    if graceful:
                        member.proc.terminate()
                    else:
                        member.proc.kill()
                except ProcessLookupError:  # pragma: no cover
                    pass
            try:
                await asyncio.wait_for(member.proc.wait(), 10.0)
            except asyncio.TimeoutError:
                member.proc.kill()
                await member.proc.wait()
            member.proc = None
        if member.task is not None:
            member.task.cancel()
            try:
                await member.task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.debug("router task %s raised during stop",
                             member.router_id, exc_info=True)
            member.task = None
            member.fleet = None

    # -- readiness / role discovery -------------------------------------------

    def _fetch_fleet_view(self, member: RouterMember) -> dict[str, Any] | None:
        """One /fleet scrape (blocking; callers run it in the executor)."""
        url = (f"http://{member.host}:{member.telemetry_port}/fleet")
        try:
            with urllib.request.urlopen(url, timeout=2.0) as resp:
                return json.loads(resp.read())
        except (urllib.error.URLError, OSError, ValueError):
            return None

    async def router_view(self, rid: str) -> dict[str, Any] | None:
        """The replica's router-stats block (task mode: direct object
        access; process mode: its /fleet telemetry view)."""
        member = self.routers[rid]
        if member.fleet is not None:
            return member.fleet.stats()
        if not self._telemetry:
            return None
        doc = await asyncio.get_running_loop().run_in_executor(
            None, self._fetch_fleet_view, member)
        return None if doc is None else doc.get("router")

    async def leader_id(self) -> str | None:
        """Which replica holds the lease RIGHT NOW (None = no leader —
        mid-failover, or nobody reachable)."""
        for rid in sorted(self.routers):
            view = await self.router_view(rid)
            if view and (view.get("lease") or {}).get("role") == "leader":
                return rid
        return None

    async def await_leader(self, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            rid = await self.leader_id()
            if rid is not None:
                return rid
            await asyncio.sleep(0.1)
        raise RuntimeError("router fleet: no replica claimed the lease "
                           f"within {timeout}s")

    async def _await_settled_lease(self, timeout: float) -> str:
        """Wait until one replica leads and every other follows it (each
        replica's view names the same holder), and return the leader.  Two
        replicas born together both claim epoch 1 when the first one's claim
        frame reaches the other only after its rank stagger (a loaded
        host's loop can delay it that long); the tie demotes the loser,
        which then never claims, so the leader's death would leave no
        replica to take the lease.  Such a replica is brought back as a
        follower here: ``LeaderLease.rejoin`` in task mode, a restart (a
        fresh lease) in process mode.  Frames on the wire are unchanged."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            leases = {rid: ((await self.router_view(rid)) or {}).get("lease") or {}
                      for rid in sorted(self.routers)}
            for rid, lease in leases.items():
                if lease.get("role") != "demoted":
                    continue
                logger.warning("router %s came up demoted: rejoining it as a follower", rid)
                member = self.routers[rid]
                if member.fleet is not None and member.fleet.lease is not None:
                    member.fleet.lease.rejoin()
                else:
                    await self.restart_router(rid)
                obs_flight.record("router_rejoined", router=rid)
            leaders = [rid for rid, lease in leases.items() if lease.get("role") == "leader"]
            if len(leaders) == 1 and all(lease.get("holder") == leaders[0]
                                         for lease in leases.values()):
                return leaders[0]
            await asyncio.sleep(0.1)
        raise RuntimeError("router fleet: the replicas did not settle on one leader "
                           f"within {timeout}s")

    async def _await_routers_reachable(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        pending = dict(self.routers)
        while pending and time.monotonic() < deadline:
            for rid, member in list(pending.items()):
                try:
                    _r, w = await asyncio.open_connection(
                        member.host, member.ctrl_port)
                    w.close()
                    del pending[rid]
                except OSError:
                    pass
            if pending:
                await asyncio.sleep(0.1)
        if pending:
            raise RuntimeError(
                f"routers never became reachable: {sorted(pending)}")

    async def _await_gateways_registered(self, timeout: float) -> None:
        """Every router must see every gateway registered (hello + STEK
        push landed) — a storm started earlier would race registration."""
        deadline = time.monotonic() + timeout
        want = set(self.gateway_ids)
        while time.monotonic() < deadline:
            ok = True
            for rid in sorted(self.routers):
                view = await self.router_view(rid)
                got = {m.get("gateway") for m in (view or {}).get("members")
                       or [] if m.get("port")}
                if not want <= got:
                    ok = False
                    break
            if ok:
                return
            await asyncio.sleep(0.1)
        raise RuntimeError("gateways never registered with every router")

    # -- chaos ----------------------------------------------------------------

    async def _chaos_loop(self) -> None:
        """The control-plane twin of the fleet health tick: poll the
        seeded plan once per router per tick, sorted order, one loop —
        the injected log stays byte-reproducible from the seed."""
        while self._running:
            await asyncio.sleep(self.hb_interval)
            for rid in sorted(self.routers):
                member = self.routers[rid]
                if member.killed:
                    continue
                for entry in _faults.router_control(rid):
                    await self._apply_chaos(member, entry)

    async def _apply_chaos(self, member: RouterMember,
                           entry: dict[str, Any]) -> None:
        action = entry.get("action")
        logger.warning("chaos: %s on %s", action, member.router_id)
        if action == "kill_router":
            await self.kill_router(member.router_id)
        elif action == "pause_router":
            self.pause_router(member.router_id,
                              float(entry.get("delay_s", 1.0)))

    async def kill_router(self, rid: str) -> None:
        """Abrupt replica death (chaos ``kill_router``): SIGKILL the
        process / tear the task down without a graceful stop.  Followers
        detect the silence (no renewals) and claim after the TTL."""
        member = self.routers[rid]
        member.killed = True
        self.router_kills += 1
        obs_flight.record("router_killed", router=rid,
                          kills=self.router_kills)
        if member.proc is not None:
            try:
                member.proc.kill()
            except ProcessLookupError:  # pragma: no cover - already gone
                pass
            await member.proc.wait()
            member.proc = None
        elif member.task is not None:
            member.task.cancel()
            try:
                await member.task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.debug("router task %s raised during kill",
                             member.router_id, exc_info=True)
            member.task = None
            member.fleet = None

    def pause_router(self, rid: str, seconds: float) -> None:
        """Chaos ``pause_router``: freeze the replica (SIGSTOP/CONT).  A
        paused LEADER stops renewing — the failover path without a death.
        Task-mode replicas cannot be frozen; the pause degrades to a
        no-op there (the kill action is the task-mode chaos tool)."""
        member = self.routers[rid]
        if member.proc is None or member.proc.returncode is not None:
            return
        pid = member.proc.pid
        self.router_pauses += 1
        obs_flight.record("router_paused", router=rid, seconds=seconds)
        try:
            os.kill(pid, signal.SIGSTOP)
        except (OSError, ProcessLookupError):  # pragma: no cover
            return
        loop = asyncio.get_running_loop()

        def resume() -> None:
            try:
                os.kill(pid, signal.SIGCONT)
            except (OSError, ProcessLookupError):  # pragma: no cover
                pass

        loop.call_later(seconds, resume)

    # -- the router roll ------------------------------------------------------

    async def restart_router(self, rid: str) -> dict[str, Any]:
        """One replica's roll: graceful stop (SIGTERM — a stopping leader
        goes silent, followers claim), respawn on the SAME ports, await
        reachable, then await the fleet's authority state on it (see
        :meth:`_await_synced`).  A chaos-killed replica just respawns."""
        member = self.routers[rid]
        t0 = time.monotonic()
        await self._stop_router(member, graceful=True)
        member.restarts += 1
        await self._spawn_router(member)
        deadline = time.monotonic() + ROUTER_REGISTER_TIMEOUT_S
        reachable = False
        while time.monotonic() < deadline:
            try:
                _r, w = await asyncio.open_connection(member.host,
                                                      member.ctrl_port)
                w.close()
                reachable = True
                break
            except OSError:
                await asyncio.sleep(0.1)
        synced = await self._await_synced(rid, deadline) if reachable else None
        out = {"router": rid, "reachable": reachable, "synced": synced,
               "took_s": round(time.monotonic() - t0, 3)}
        obs_flight.record("router_restarted", **out)
        if not reachable:
            logger.error("router %s never came back after restart", rid)
        elif synced is False:
            logger.error("router %s came back but never received the fleet's "
                         "authority state", rid)
        return out

    async def _await_synced(self, rid: str, deadline: float) -> bool | None:
        """Whether a respawned replica holds the fleet's authority state
        (the leader's STEK ring) by ``deadline``: it applied a leader's
        sync.  A respawn starts with a private random STEK ring (and may
        briefly claim a lease the live leader then fences); a roll that
        stopped the next replica, the leader, before this one synced would
        let it claim the lease for real and push that ring over the
        gateways', and every ticket minted before the roll would then be
        refused as unknown_stek.  None when no other replica is alive to
        sync from or the replica's view cannot be read (no telemetry)."""
        if not any(m.alive for r, m in self.routers.items() if r != rid):
            return None
        while time.monotonic() < deadline:
            view = await self.router_view(rid)
            if view is None and self.routers[rid].fleet is None and not self._telemetry:
                return None
            if view and (view.get("syncs_applied") or 0) > 0:
                return True
            await asyncio.sleep(0.1)
        return False

    async def rolling_restart(self) -> dict[str, Any]:
        """Roll EVERY replica, one at a time, lowest rank first — the
        lease moves at most once per step, the control plane never loses
        more than one replica, and the data plane never notices (gateways
        keep serving; their reconnect loops re-register with each
        respawn)."""
        results = []
        for rid in sorted(self.routers):
            results.append(await self.restart_router(rid))
        ok = all(r["reachable"] and r["synced"] is not False for r in results)
        obs_flight.record("router_rolling_restart",
                          routers=[r["router"] for r in results], ok=ok)
        return {"restarted": results, "ok": ok}

    # -- reporting ------------------------------------------------------------

    async def stats(self) -> dict[str, Any]:
        rows = []
        for rid in sorted(self.routers):
            member = self.routers[rid]
            view = await self.router_view(rid)
            rows.append({
                "router": rid,
                "rank": member.rank,
                "ctrl_port": member.ctrl_port,
                "telemetry_port": member.telemetry_port,
                "alive": member.alive,
                "killed": member.killed,
                "restarts": member.restarts,
                "lease": (view or {}).get("lease"),
                "lease_rejects": (view or {}).get("lease_rejects"),
                "lease_fenced": (view or {}).get("lease_fenced"),
                "syncs_applied": (view or {}).get("syncs_applied"),
                "routes_ok": (view or {}).get("routes_ok"),
                "route_sheds": (view or {}).get("route_sheds"),
                "stek_epoch": (view or {}).get("stek_epoch"),
                "stek_rotations": (view or {}).get("stek_rotations"),
            })
        return {
            "routers": rows,
            "gateways": list(self.gateway_ids),
            "router_kills": self.router_kills,
            "router_pauses": self.router_pauses,
            "ring_members": self.router_ring.members(),
        }


if __name__ == "__main__":
    sys.exit(main())
