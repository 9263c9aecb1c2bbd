"""Gateway worker: one P2PNode + SecureMessaging engine per process.

Counterpart of the JAX package's ``fleet/gateway.py``, over the port's
engine.  Spawned by :class:`fleet.manager.GatewayFleet` as
``python -m quantum_resistant_p2p_tpu_torch.fleet.gateway '<json config>'``
(or run in-process as an asyncio task — ``spawn="task"`` — for
deterministic tests; same code path, same control protocol over real
localhost TCP).

Where it differs from the JAX package's gateway:

* the providers run on the ``backend`` config key, "cuda" by default
  (that gateway hard-codes "tpu"), and the engine is built on it;
* ``providers`` defaults to "real": ML-KEM-768 x ML-DSA-65, fused, with
  ChaCha20-Poly1305, whose batched data plane is a kernel of the port.
  That gateway picks AES-256-GCM and quietly degrades to the stdlib
  :class:`StormAEAD` when it cannot be built; the port's AES-256-GCM needs
  the ``cryptography`` wheel at its first seal, and an AEAD that cannot
  be built raises here.  "stdlib" selects the storm toys;
* the engine keeps the port's ``degrade=False``: no CPU fallback is armed
  on any queue, and a failed health gate or warm-up fails the gateway;
* the heartbeat and bye stats carry ``kernel_launches``, each kernel
  wrapper's launch count in this process;
* the engine is closed (its device workers stopped) on the way out.

Lifecycle:

1. enter :func:`fleet.stormlib.storm_env` — per-PROCESS fd limit +
   protocol-timeout guard (the single-process storm's environment,
   applied where it actually lives: in this process);
2. start the P2P node on an ephemeral port, build the engine
   (``use_batching=True`` — the full queue/scheduler/autotuner plane),
   wait for warm-up;
3. dial the router's control port, send ``__gw_hello__`` (the P2P port
   peers will be routed to), then heartbeat every ``hb_interval`` with
   liveness stats and the cumulative SLO probe totals the router
   aggregates fleet-wide;
4. answer ``__gw_probe__`` (the fleet breaker's half-open canary) with
   ``__gw_probe_ok__``;
5. on ``__gw_stop__``: write the per-node ``slo_report.json``
   (:meth:`app.messaging.SecureMessaging.slo_report`) into
   ``report_dir``, send ``__gw_bye__`` with final stats, exit 0.

Abrupt death (SIGKILL from the chaos plan, or task cancellation) skips
4-5 by construction — peers see a dropped TCP session, the router sees
missed heartbeats, and the fleet handoff machinery takes over.

HA control plane (docs/fleet.md): when the config carries a ``routers``
list instead of the single ``router_host``/``router_port`` pair, the
gateway maintains ONE control link PER router replica — hello +
heartbeats to all of them, with a seeded-jitter reconnect loop per link
so a rolled router's respawn sees a staggered redial wave, not a
thundering herd.  Authority frames (``__gw_stek__`` / ``__gw_drain__``)
carry the sender's lease epoch; the gateway honors the highest epoch it
has seen and drops anything older (the gateway-side half of stale-lease
fencing — a demoted router's pushes are rejected and flight-recorded,
never installed).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import sys
from pathlib import Path
from typing import Any, Awaitable, Callable

from ..obs import flight as obs_flight
from . import control
from .stormlib import (StormAEAD, prewarm_facades, register_storm_providers,
                       seeded_jitter_rng, storm_env)

logger = logging.getLogger(__name__)

#: config defaults; the manager overrides via the JSON blob
DEFAULTS: dict[str, Any] = {
    "gateway_id": "gw0",
    "router_host": "127.0.0.1",
    "bind_host": "127.0.0.1",
    "router_port": 0,
    #: HA mode: a list of ``{"router", "host", "port"}`` replica
    #: endpoints.  None/empty = the classic single-router link above.
    "routers": None,
    #: seeds the per-link reconnect jitter (the storm passes its seed)
    "seed": 0,
    #: "stdlib" (the storm toys) or anything else for the real providers
    #: (ML-KEM-768 x ML-DSA-65 + ChaCha20-Poly1305), on ``backend``
    "providers": "real",
    "backend": "cuda",
    "max_peers": 0,
    "handshake_budget": 0,
    "bulk_lane_capacity": 0,
    "max_batch": 4096,
    "max_wait_ms": 3.0,
    "autotune": True,
    "shard_devices": 0,
    "ke_timeout": 120.0,
    "hb_interval": 0.25,
    "report_dir": None,
    "fd_need": 4096,
    "prewarm_cap": 64,
    #: live telemetry endpoints (obs/http.py): None = off (the global
    #: default), 0 = ephemeral port — announced through hello/heartbeat
    #: so the router can find each gateway's scrape
    "telemetry_port": None,
}


def kernel_wrappers() -> dict[str, Any]:
    """Every kernel wrapper of the port by name; each counts its launches
    in ``launches``."""
    from ..core import chacha_cuda, keccak_cuda, sha256_cuda, sha512_cuda
    from ..kem import frodo_cuda, mlkem_cuda
    from ..sig import mldsa_cuda

    return {
        "keccak_sponge": keccak_cuda.sponge,
        "mlkem_sample_ntt": mlkem_cuda.sample_ntt,
        "mlkem_prf_cbd": mlkem_cuda.prf_cbd,
        "mlkem_prf_cbd_ntt": mlkem_cuda.prf_cbd_ntt,
        "mlkem_ntt": mlkem_cuda.ntt, "mlkem_ntt_inv": mlkem_cuda.ntt_inv,
        "mldsa_rej_ntt": mldsa_cuda.rej_ntt,
        "mldsa_rej_bounded": mldsa_cuda.rej_bounded,
        "mldsa_ntt": mldsa_cuda.ntt, "mldsa_ntt_inv": mldsa_cuda.ntt_inv,
        "keccak_sponge_varlen": keccak_cuda.sponge_varlen,
        "chacha_blocks": chacha_cuda.chacha_blocks,
        "frodo_a_times_s": frodo_cuda.a_times_s,
        "frodo_s_times_a": frodo_cuda.s_times_a,
        "frodo_cdf_sample": frodo_cuda.cdf_sample,
        "sha256_compress": sha256_cuda.compress,
        "sha512_compress": sha512_cuda.compress,
    }


def kernel_launches() -> dict[str, int]:
    """Each kernel wrapper's launches in this process so far, by name:
    what this gateway ran on the card."""
    return {name: w.launches for name, w in kernel_wrappers().items()}


def _engine_stats(engine, received: int) -> dict[str, Any]:
    """The compact heartbeat payload: liveness + the counters the fleet
    sums (device/fallback trips feed the fleet_device_served SLO; the
    cost totals feed the router's aggregated ``/fleet`` economics)."""
    q = engine._collect_queues()
    gw = {
        "msgs_received": received,
        "connections": len(engine.node.get_peers()),
        "admitted": engine.node.admitted,
        "connection_sheds": engine.node.sheds,
        "handshake_sheds": engine._ctr_handshake_sheds.value,
        "device_trips": q.get("device_trips", 0),
        "fallback_trips": q.get("fallback_trips", 0),
        "breaker_state": q.get("breaker_state"),
        "device_served_fraction": q.get("device_served_fraction"),
        "handshake_attempts": engine._handshake_latency.count,
        "telemetry_port": engine.telemetry_port,
        "cost": engine.cost.totals(),
        # the resumption/drain surface (the router's /fleet view and the
        # roll-storm report read these per gateway)
        "draining": engine.draining,
        "tickets_minted": engine._ctr_tickets_minted.value,
        "resumes_ok": engine._ctr_resumes_ok.value,
        "resume_rejects": engine._ctr_resume_rejects.value,
        "kernel_launches": kernel_launches(),
    }
    total = fb = 0
    for fam in ("kem_queue", "sig_queue", "fused_queue"):
        for qq in q.get(fam, {}).values():
            total += qq["ops"]
            fb += qq["fallback_ops"]
    gw["ops"] = total
    gw["fallback_ops"] = fb
    return gw


async def _dispatch(msg: dict, send: Callable[[dict], Awaitable[None]],
                    engine, gid: str, state: dict[str, Any]) -> str:
    """Handle one router control frame (shared by the single-router loop
    and every HA link).  Returns ``"ok"`` / ``"drain"`` / ``"stop"``;
    transport errors from the probe reply propagate to the caller (its
    link is dead).

    ``state["lease_epoch"]`` is the highest lease epoch this gateway has
    honored: authority frames (STEK pushes, drains) below it come from a
    router that provably LOST the lease — dropped and flight-recorded,
    the gateway-side half of stale-lease fencing.  Frames without an
    epoch (a standalone router) carry 0 and the gate stays inert."""
    mtype = msg.get("type")
    if mtype == control.GW_PROBE:
        await send({
            "type": control.GW_PROBE_OK, "gateway": gid,
            "n": msg.get("n"),
        })
    elif mtype == control.GW_TICKET_KEYS:
        epoch = int(msg.get("lease_epoch") or 0)
        if epoch < state["lease_epoch"]:
            state["stale_authority_rejects"] += 1
            obs_flight.record("stale_authority_rejected", gateway=gid,
                              frame="stek", lease_epoch=epoch,
                              honored=state["lease_epoch"])
            logger.warning("gateway %s: STEK push at stale lease epoch %d "
                           "(honoring %d) rejected", gid, epoch,
                           state["lease_epoch"])
            return "ok"
        state["lease_epoch"] = epoch
        # the fleet's ticket-sealing keys (current + previous): replace
        # the engine's private ring so tickets minted ANYWHERE in the
        # fleet resume here
        try:
            installed = engine.tickets.install([
                (str(ep), bytes.fromhex(str(key_hex)))
                for ep, key_hex in (msg.get("keys") or [])
            ], guard=True)
        except (ValueError, TypeError):
            logger.warning("gateway %s: malformed STEK push ignored", gid)
        else:
            if not installed:
                # same-lease-epoch ordering race (STEKRing.install guard):
                # a pre-rotation push arriving after the rotation must not
                # re-mint under the key the fleet is dropping
                state["stale_authority_rejects"] += 1
                obs_flight.record("stale_stek_push_skipped", gateway=gid)
    elif mtype == control.GW_DRAIN:
        epoch = int(msg.get("lease_epoch") or 0)
        if epoch < state["lease_epoch"]:
            state["stale_authority_rejects"] += 1
            obs_flight.record("stale_authority_rejected", gateway=gid,
                              frame="drain", lease_epoch=epoch,
                              honored=state["lease_epoch"])
            logger.warning("gateway %s: drain at stale lease epoch %d "
                           "(honoring %d) rejected", gid, epoch,
                           state["lease_epoch"])
            return "ok"
        state["lease_epoch"] = epoch or state["lease_epoch"]
        state["drain_reason"] = "router"
        return "drain"
    elif mtype == control.GW_STOP:
        return "stop"
    return "ok"


async def run_gateway(cfg: dict[str, Any]) -> None:
    """Run one gateway until the router says stop (or the task is
    cancelled — the abrupt-death path)."""
    cfg = {**DEFAULTS, **cfg}
    gid = str(cfg["gateway_id"])
    from ..app.messaging import SecureMessaging
    from ..net.p2p_node import P2PNode
    from ..provider import get_kem, get_signature, get_symmetric

    backend = str(cfg["backend"])
    with storm_env(float(cfg["ke_timeout"]), fd_need=int(cfg["fd_need"])):
        if cfg["providers"] == "stdlib":
            register_storm_providers()
            kem_name, sig_name = "STORM-KEM", "STORM-SIG"
            aead: Any = StormAEAD()
        else:
            kem_name, sig_name = "ML-KEM-768", "ML-DSA-65"
            # the AEAD whose batched data plane runs on the card; no
            # quiet degrade to the storm AEAD
            aead = get_symmetric("ChaCha20-Poly1305")
        # the providers first: a "cuda" gateway without a GPU raises here,
        # before it listens
        kem = get_kem(kem_name, backend)
        signature = get_signature(sig_name, backend)
        node = P2PNode(node_id=gid, host=str(cfg["bind_host"]), port=0,
                       max_peers=int(cfg["max_peers"]))
        await node.start()
        telemetry_port = cfg.get("telemetry_port")
        engine = SecureMessaging(
            node, kem=kem, symmetric=aead, signature=signature,
            backend=backend,
            use_batching=True, max_batch=int(cfg["max_batch"]),
            max_wait_ms=float(cfg["max_wait_ms"]),
            autotune=bool(cfg["autotune"]),
            shard_devices=int(cfg["shard_devices"]),
            max_inflight_handshakes=int(cfg["handshake_budget"]),
            bulk_lane_capacity=int(cfg["bulk_lane_capacity"]),
            telemetry_port=(int(telemetry_port)
                            if telemetry_port is not None else None),
        )
        received = 0

        def on_msg(peer_id, message):
            nonlocal received
            if not message.is_system:
                received += 1

        engine.register_message_listener(on_msg)
        try:
            await engine.wait_ready()
            cap = int(cfg["prewarm_cap"])
            if cap and engine._bkem is not None:
                # warm every pow2 flush bucket this gateway's share of the
                # storm can hit
                await prewarm_facades(
                    (engine._bkem, engine._bsig, engine._bfused),
                    min(int(cfg["max_batch"]), cap))
        except BaseException:
            # a failed gate or warm-up (or a cancel while warming): the
            # gateway never registers, and leaves no listener behind
            await node.stop()
            engine.close()
            raise

        # -- control links -------------------------------------------------
        # multi=False is the classic single-router lifecycle (one link,
        # loss = exit); multi=True is the HA control plane: one link per
        # router replica, each with its own reconnect loop
        router_list = cfg.get("routers")
        multi = bool(router_list)
        if not multi:
            router_list = [{"router": "router",
                            "host": cfg["router_host"],
                            "port": cfg["router_port"]}]
        stop_ev = asyncio.Event()
        # graceful drain triggers: a router's __gw_drain__ verb OR a
        # SIGTERM (a rolling restart / orchestrator shutdown delivers
        # SIGTERM — a PLANNED restart must not look like a crash)
        drain_ev = asyncio.Event()
        #: cross-link shared state: the highest lease epoch honored (the
        #: gateway-side fencing gate) + the drain reason for the report
        state: dict[str, Any] = {"lease_epoch": 0,
                                 "stale_authority_rejects": 0,
                                 "drain_reason": None}
        #: live per-router send closures (a link registers on hello,
        #: deregisters on loss) — the bye fan-out at exit walks these
        senders: dict[str, Callable[[dict], Awaitable[None]]] = {}
        writers: dict[str, asyncio.StreamWriter] = {}

        def hello_frame() -> dict:
            return {
                "type": control.GW_HELLO, "gateway": gid,
                "p2p_port": node.port, "pid": os.getpid(),
                "max_peers": int(cfg["max_peers"]),
                # announce the scrape surface: the router's /fleet view
                # finds each gateway's endpoints here
                "telemetry_port": engine.telemetry_port,
            }

        def hb_frame() -> dict:
            stats = _engine_stats(engine, received)
            # the lease surface rides the heartbeat: which authority
            # epoch this gateway honors, over how many router links
            stats["lease_epoch"] = state["lease_epoch"]
            stats["router_links"] = len(senders)
            stats["stale_authority_rejects"] = state["stale_authority_rejects"]
            return {
                "type": control.GW_HEARTBEAT, "gateway": gid,
                "stats": stats,
                "slo_totals": {
                    k: list(v)
                    for k, v in engine.slo.probe_totals().items()
                },
            }

        async def heartbeat(send: Callable[[dict], Awaitable[None]]) -> None:
            while not stop_ev.is_set():
                await asyncio.sleep(float(cfg["hb_interval"]))
                try:
                    await send(hb_frame())
                except (ConnectionError, OSError):
                    if not multi:
                        stop_ev.set()
                    return

        async def link(rt: dict[str, Any]) -> None:
            """One router replica's control-link lifecycle: dial, hello,
            heartbeat, dispatch — redialing with seeded-jitter backoff in
            HA mode so a rolled router's respawn sees a staggered wave."""
            rid = str(rt.get("router") or "router")
            # deterministic per-(gateway, router) jitter stream
            rng = seeded_jitter_rng(int(cfg["seed"]), gid, rid)
            backoff = 0.05
            while not (stop_ev.is_set() or drain_ev.is_set()):
                try:
                    reader, writer = await asyncio.open_connection(
                        str(rt["host"]), int(rt["port"]))
                except OSError:
                    if not multi:
                        return  # classic mode: no router, no gateway
                    await asyncio.sleep(backoff * (0.5 + rng.random()))
                    backoff = min(backoff * 2.0, 2.0)
                    continue
                backoff = 0.05
                # one writer, two senders (heartbeat task + the dispatch
                # loop's probe replies): serialize sends — two coroutines
                # suspended in the same drain() while the router
                # back-pressures the transport trip asyncio's
                # single-waiter assert and kill the heartbeat task
                send_lock = asyncio.Lock()

                async def send(frame: dict, _w=writer,
                               _lock=send_lock) -> None:
                    async with _lock:
                        await control.send_ctrl(_w, frame)

                hb_task: asyncio.Task | None = None
                lost = False
                try:
                    await send(hello_frame())
                    senders[rid] = send
                    writers[rid] = writer
                    hb_task = asyncio.create_task(heartbeat(send))
                    while True:
                        read_t = asyncio.ensure_future(
                            control.read_ctrl(reader))
                        drain_t = asyncio.ensure_future(drain_ev.wait())
                        stop_t = asyncio.ensure_future(stop_ev.wait())
                        try:
                            await asyncio.wait(
                                {read_t, drain_t, stop_t},
                                return_when=asyncio.FIRST_COMPLETED)
                        except asyncio.CancelledError:
                            # the whole link task is being torn down while
                            # we were blocked in the select: the read task
                            # would otherwise outlive us and log its EOF
                            # as an unretrieved exception
                            read_t.cancel()
                            read_t.add_done_callback(
                                lambda t: None if t.cancelled()
                                else t.exception())
                            raise
                        finally:
                            drain_t.cancel()
                            stop_t.cancel()
                        if not read_t.done():
                            # drain/stop fired: leave the link OPEN — the
                            # epilogue still owes this router a bye frame.
                            # The cancel is a no-op when an EOF raced in
                            # just now, so consume the task's outcome
                            # either way or it surfaces much later as an
                            # unretrieved-exception warning
                            read_t.cancel()
                            read_t.add_done_callback(
                                lambda t: None if t.cancelled()
                                else t.exception())
                            return
                        msg = read_t.result()
                        verdict = await _dispatch(msg, send, engine, gid,
                                                  state)
                        if verdict == "drain":
                            drain_ev.set()
                            return
                        if verdict == "stop":
                            stop_ev.set()
                            return
                except (asyncio.IncompleteReadError, ConnectionError,
                        OSError):
                    lost = True
                finally:
                    if hb_task is not None:
                        hb_task.cancel()
                    if lost:
                        senders.pop(rid, None)
                        writers.pop(rid, None)
                        writer.close()
                if not multi:
                    return  # classic mode: link loss = exit, no redial
                await asyncio.sleep(backoff * (0.5 + rng.random()))

        link_tasks = [asyncio.create_task(link(rt)) for rt in router_list]
        loop = asyncio.get_running_loop()
        sigterm_armed = False
        if cfg.get("own_process"):
            # subprocess mode only (main() sets the flag): an in-process
            # task gateway must not steal the driver's SIGTERM handling
            try:
                loop.add_signal_handler(signal.SIGTERM, drain_ev.set)
                sigterm_armed = True
            except (NotImplementedError, ValueError, RuntimeError):
                pass  # non-main thread / platform without signal support
        try:
            drain_t = asyncio.ensure_future(drain_ev.wait())
            stop_t = asyncio.ensure_future(stop_ev.wait())
            waits: set[asyncio.Future] = {drain_t, stop_t}
            if not multi:
                # classic mode additionally exits when its ONLY link ends
                # (router gone); HA links redial forever instead
                waits |= set(link_tasks)
            try:
                await asyncio.wait(waits,
                                   return_when=asyncio.FIRST_COMPLETED)
            finally:
                drain_t.cancel()
                stop_t.cancel()
            if drain_ev.is_set() and not stop_ev.is_set():
                # the graceful-drain protocol (app/messaging.py): stop
                # admitting (/readyz -> 503 draining), flush outboxes,
                # nudge every peer to resume — via ticket — on its ring
                # successor; then fall through to the report/bye path
                await engine.drain(
                    reason=state.get("drain_reason") or "sigterm")
            # per-node SLO report first (the fleet merge input), then the
            # final stats frame
            stop_ev.set()
            report_dir = cfg.get("report_dir")
            if report_dir:
                path = Path(report_dir) / f"{gid}_slo_report.json"
                report = json.dumps(engine.slo_report(), indent=2,
                                    sort_keys=True)
                try:
                    await asyncio.get_running_loop().run_in_executor(
                        None, path.write_text, report)
                except OSError:
                    logger.exception("gateway %s: slo report write failed",
                                     gid)
            for _rid, send in sorted(senders.items()):
                try:
                    await send({
                        "type": control.GW_BYE, "gateway": gid,
                        "stats": _engine_stats(engine, received),
                    })
                except (ConnectionError, OSError):
                    pass
        finally:
            # runs on the graceful path AND on task cancellation (the
            # in-process abrupt-death mode): close every transport so
            # peers see the drop immediately
            stop_ev.set()
            for t in link_tasks:
                t.cancel()
            if sigterm_armed:
                try:
                    loop.remove_signal_handler(signal.SIGTERM)
                except (NotImplementedError, ValueError, RuntimeError):
                    pass
            engine.stop_telemetry()
            for w in writers.values():
                w.close()
            await node.stop()
            engine.close()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m quantum_resistant_p2p_tpu_torch.fleet.gateway "
              "'<json config>'", file=sys.stderr)
        return 2
    # the single argument is an inline JSON blob, or a path to one
    blob = argv[0]
    if not blob.lstrip().startswith("{") and Path(blob).is_file():
        blob = Path(blob).read_text()
    cfg = json.loads(blob)
    # this process IS the gateway: SIGTERM means "drain gracefully"
    cfg["own_process"] = True
    logging.basicConfig(level=logging.WARNING)
    asyncio.run(run_gateway(cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
