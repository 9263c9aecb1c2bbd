"""The port's replicated router and chaos storms
(quantum_resistant_p2p_tpu_torch.fleet.router and .storm) against the JAX
package's, on the CPU.

* Mirrors of the three storm tests of the reference's suites, over the
  port's modules with the stdlib toy providers and task-mode fleets:
  ``test_fleet_storm_survives_seeded_gateway_kill`` and
  ``test_roll_storm_sessions_survive_and_resume`` (``tests/test_fleet.py``)
  and ``test_router_storm_survives_seeded_leader_kill``
  (``tests/test_router_ha.py``), with the same arguments and assertions.
* Parity with the reference on the same inputs: the same seeded storm
  through each package injects the same chaos log and reports the same
  keys; the default kill rules are equal; the router ring places 400 peer
  ids, made with numpy from a seed, the same way; the replica and gateway
  configs are equal but for the default ``providers`` ("real" here).
* A mixed control plane over TCP: one port replica and one reference
  replica as each other's peers, a port gateway registered with both; the
  rank-0 replica leads, and when its task is cancelled the other claims
  the lease and its STEK push is honored by the gateway's epoch fencing.
  Both ways round.
* The "real" router storm on "cpu": ML-KEM-768 x ML-DSA-65, fused, and
  ChaCha20-Poly1305 on both sides, on the plain versions, through a
  leader kill, with no fallback armed or served.
* Process mode: two ``-m`` router processes and two ``-m`` gateways, a
  leader kill, the lease's handoff, a restart on the same ports, and no
  process left.
* ROADMAP C8 (the port's storm and router fleet, no frame changed): a
  leader-kill storm whose sessions end before the follower's claim is due
  reports the routers once the failover settled, and a replica that came
  up demoted from a tied claim at birth is rejoined before the fleet
  counts as up.  Both fail on the tree before the repair.

Tolerance: exact.  PyTorch runs on one thread; JAX's caches are cleared at
the module's end if JAX was loaded (ROADMAP C1).  Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.app import messaging as ref_messaging
from quantum_resistant_p2p_tpu.fleet import router as ref_router
from quantum_resistant_p2p_tpu.fleet import storm as ref_storm
from quantum_resistant_p2p_tpu.fleet import stormlib as ref_stormlib
from quantum_resistant_p2p_tpu.provider import registry as ref_registry
from quantum_resistant_p2p_tpu_torch.app import messaging as messaging_mod
from quantum_resistant_p2p_tpu_torch.fleet import gateway as fleet_gateway
from quantum_resistant_p2p_tpu_torch.fleet import router as fleet_router
from quantum_resistant_p2p_tpu_torch.fleet import stormlib
from quantum_resistant_p2p_tpu_torch.fleet.lease import DEMOTED, FOLLOWER, LEADER
from quantum_resistant_p2p_tpu_torch.fleet.router import RouterFleet
from quantum_resistant_p2p_tpu_torch.fleet.storm import (default_kill_rules,
                                                         default_router_kill_rules,
                                                         run_fleet_storm, run_router_storm)
from quantum_resistant_p2p_tpu_torch.provider import facade_queues

REPO = Path(__file__).resolve().parents[1]
#: the longest one wait of a live scenario may take
WAIT_S = 20.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_release():
    """One PyTorch CPU thread (xdist workers share the cores); JAX's caches
    cleared at the end if anything loaded JAX (ROADMAP C1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _health_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("QRP2P_HEALTH_CACHE", str(tmp_path / "health"))


@pytest.fixture(autouse=True)
def _registries(monkeypatch):
    """The storm toys a storm registers leave both registries as they were:
    other test modules of the same process list them."""
    from quantum_resistant_p2p_tpu_torch.provider import registry

    for mod in (registry, ref_registry):
        for table in ("_KEMS", "_SIGS"):
            monkeypatch.setattr(mod, table, dict(getattr(mod, table)))
    for mod in (stormlib, ref_stormlib):
        monkeypatch.setattr(mod, "_STORM_REGISTERED", False)


@pytest.fixture(autouse=True)
def fast_timeout(monkeypatch):
    for mod in (messaging_mod, ref_messaging):
        monkeypatch.setattr(mod, "KEY_EXCHANGE_TIMEOUT", 5.0)
        monkeypatch.setattr(mod, "KE_RETRY_BACKOFF_S", 0.05)


@pytest.fixture
def run():
    loop = asyncio.new_event_loop()
    yield lambda coro, limit=120.0: loop.run_until_complete(asyncio.wait_for(coro, limit))
    loop.run_until_complete(loop.shutdown_asyncgens())
    loop.close()


async def _until(cond, what: str, timeout: float = WAIT_S) -> None:
    """Wait for ``cond()`` (a plain or an async predicate)."""
    t0 = time.monotonic()
    while True:
        got = cond()
        if asyncio.iscoroutine(got):
            got = await got
        if got:
            return
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


# -- the three storms (mirrors) -----------------------------------------------

#: the reference tests' arguments, as they pass them (``tests/test_fleet.py``
#: and ``tests/test_router_ha.py``); the port's storms take the toys by name
KILL_STORM = dict(sessions=10, gateways=3, spawn="task", concurrency=10, msgs_per_session=4,
                  hb_interval=0.05, ke_timeout=30.0, msg_interval_s=0.1, session_attempts=8,
                  seed=5)
ROLL_STORM = dict(sessions=24, gateways=2, spawn="task", concurrency=8, msgs_per_session=6,
                  arrival_rate=20.0, hb_interval=0.05, ke_timeout=30.0, seed=5, roll=True,
                  roll_delay_s=0.5, drain_timeout=10.0, session_attempts=8,
                  msg_interval_s=0.05)
ROUTER_STORM = dict(sessions=12, gateways=2, routers=2, spawn="task", concurrency=12,
                    msgs_per_session=6, msg_interval_s=0.1, hb_interval=0.1, ke_timeout=30.0,
                    session_attempts=8, seed=3, lease_ttl_s=0.5, lease_stagger_s=0.1,
                    roll=False)


def test_fleet_storm_survives_seeded_gateway_kill(run):
    """A seeded mid-storm gateway kill: every established session finishes
    (ring-successor handoff + re-key), 0 plaintext sends, and the injected
    log replays from the seed."""
    out = run(run_fleet_storm(providers="stdlib", fault_rules=default_kill_rules("gw1", tick=2),
                              **KILL_STORM))
    assert out["completed_sessions"] == 10
    assert out["lost_established_sessions"] == 0
    assert out["plaintext_sends"] == 0
    assert out["chaos"]["injected_log"] == [
        {"scope": "process", "action": "kill_gateway", "n": 2, "gateway": "gw1"}]
    assert out["fleet"]["members"][1]["killed"] is True


def test_roll_storm_sessions_survive_and_resume(run):
    """Every gateway drained and respawned mid-storm: 0 lost established
    sessions, 0 plaintext, and displaced sessions resume by ticket wherever
    the ring re-routes them."""
    out = run(run_fleet_storm(providers="stdlib", **ROLL_STORM))
    assert out["completed_sessions"] == 24
    assert out["lost_established_sessions"] == 0
    assert out["plaintext_sends"] == 0
    assert out["roll"] and out["roll"]["ok"]
    assert out["resumed_reconnects"] >= 1
    assert out["full_handshake_reconnects"] == 0
    assert out["post_roll_resume_rate"] in (None, 1.0)


def test_router_storm_survives_seeded_leader_kill(run):
    """A seeded mid-storm kill of the initial leader: every established
    session finishes (clients walk the router ring on transport errors), 0
    plaintext, and reconnects after the kill resume by tickets minted
    before it."""
    out = run(run_router_storm(providers="stdlib",
                               fault_rules=default_router_kill_rules("rt0", 4), **ROUTER_STORM))
    assert out["completed_sessions"] == 12
    assert out["lost_established_sessions"] == 0
    assert out["plaintext_sends"] == 0
    assert out["router_kills"] >= 1
    assert out["chaos"]["injected"] >= 1
    assert out["router_failovers"] >= 1
    assert out["post_failover_resumed"] >= 1
    roles = {row["router"]: (row["lease"] or {}).get("role")
             for row in out["router_fleet"]["routers"]}
    assert roles.get("rt1") == LEADER
    assert out["initial_leader"] == "rt0"


def test_router_storm_reports_the_routers_once_its_failover_settles(run):
    """ROADMAP C8's cause: a storm whose sessions end before the follower's
    claim is due.  Two sessions of two messages end ~0.3 s after the
    activation; rt0 dies on the first chaos tick, and rt1 claims the lease
    a default TTL (1.5 s) plus its stagger after the last renewal it saw.
    The report must read the routers once rt1 leads, not mid-failover with
    no leader (the 12-session mirror above outlives that claim by only
    0.03-0.07 s on an idle host when nothing stalls the loop)."""
    out = run(run_router_storm(
        providers="stdlib", fault_rules=default_router_kill_rules("rt0", 1),
        **{**ROUTER_STORM, "sessions": 2, "concurrency": 2, "msgs_per_session": 2,
           "lease_ttl_s": 1.5}))
    assert out["completed_sessions"] == 2 and out["lost_established_sessions"] == 0
    assert out["router_kills"] == 1 and out["initial_leader"] == "rt0"
    roles = {row["router"]: (row["lease"] or {}).get("role")
             for row in out["router_fleet"]["routers"]}
    assert roles == {"rt0": None, "rt1": LEADER}
    rt1 = next(row for row in out["router_fleet"]["routers"] if row["router"] == "rt1")
    assert rt1["lease"]["epoch"] == 2


def test_router_fleet_rejoins_a_replica_that_came_up_demoted(run, monkeypatch):
    """ROADMAP C8's second path, seen under load: rt0's first frames reach
    rt1 only after rt1's own claim was due (here held back until rt1 has
    claimed), so both claim epoch 1 and the tie demotes rt1, which never
    claims again.  The fleet must come up with rt1 following, so that rt0's
    death still leaves a replica to take the lease."""
    from quantum_resistant_p2p_tpu_torch.fleet.manager import GatewayFleet

    peer_send = GatewayFleet._peer_send
    routers: dict = {}

    def rt1_claims():
        rt1 = routers["rf"].routers["rt1"].fleet
        return [] if rt1 is None else [epoch for _t, _was, _to, epoch, reason
                                       in rt1.lease.transitions if reason == "claimed"]

    async def late_from_rt0(self, peer, frame):
        t0 = time.monotonic()
        while self.router_id == "rt0" and not rt1_claims() and time.monotonic() - t0 < WAIT_S:
            await asyncio.sleep(0.02)
        await peer_send(self, peer, frame)

    monkeypatch.setattr(GatewayFleet, "_peer_send", late_from_rt0)

    async def scenario():
        rf = routers["rf"] = RouterFleet(2, 1, spawn="task", providers="stdlib", seed=3,
                                         hb_interval=0.1, lease_ttl_s=0.5, lease_stagger_s=0.1,
                                         telemetry=False)
        await rf.start()
        try:
            rt1 = rf.routers["rt1"].fleet.lease
            assert rt1_claims() == [1]
            assert any(to == DEMOTED for _t, _was, to, *_rest in rt1.transitions)
            assert (rt1.role, rt1.holder) == (FOLLOWER, "rt0")
            await rf.kill_router("rt0")
            await _until(lambda: rt1.is_leader, "rt1 to claim the lease")
            assert rt1.epoch == 2
        finally:
            await rf.stop()

    run(scenario())


# -- parity with the reference --------------------------------------------------


@pytest.mark.parametrize("kind", ["fleet", "router"])
def test_same_seeded_storm_gives_the_reference_chaos_log(run, kind):
    """The same seeded stdlib task-mode storm through each package: the kill
    rule (a gateway's, or the leader's) injects the same chaos log, and the
    reports carry the same keys."""
    if kind == "fleet":
        mine = run(run_fleet_storm(providers="stdlib",
                                   fault_rules=default_kill_rules("gw1", tick=2), **KILL_STORM))
        ref = run(ref_storm.run_fleet_storm(
            fault_rules=ref_storm.default_kill_rules("gw1", tick=2), **KILL_STORM))
    else:
        mine = run(run_router_storm(providers="stdlib",
                                    fault_rules=default_router_kill_rules("rt0", 4),
                                    **ROUTER_STORM))
        ref = run(ref_storm.run_router_storm(
            fault_rules=ref_storm.default_router_kill_rules("rt0", 4), **ROUTER_STORM))
    assert mine["chaos"] == ref["chaos"] and mine["chaos"]["injected"] == 1
    assert sorted(mine) == sorted(ref)
    assert mine["providers"] == ref["providers"] == "stdlib-toy (serving-loop workload)"


@pytest.mark.parametrize(("target", "tick"), [(None, None), ("gw2", 5), ("gw0", 1)])
def test_default_kill_rules_match_the_reference(target, tick):
    kw = {} if target is None else {"tick": tick}
    gw = () if target is None else (target,)
    rt = () if target is None else (target.replace("gw", "rt"),)
    assert [dataclasses.asdict(r) for r in default_kill_rules(*gw, **kw)] == \
        [dataclasses.asdict(r) for r in ref_storm.default_kill_rules(*gw, **kw)]
    assert [dataclasses.asdict(r) for r in default_router_kill_rules(*rt, **kw)] == \
        [dataclasses.asdict(r) for r in ref_storm.default_router_kill_rules(*rt, **kw)]


@pytest.mark.parametrize("seed", [190, 191, 192])
def test_router_ring_matches_the_reference(seed):
    """400 peer ids made with numpy from the seed: the same owner and the
    same failover order over the routers in both packages."""
    rng = np.random.default_rng(seed)
    peers = [f"peer{int(x):08x}" for x in rng.integers(0, 2**32, 400)]
    routers = int(rng.integers(2, 6))
    mine = RouterFleet(routers, 1, spawn="task", seed=seed, telemetry=False)
    ref = ref_router.RouterFleet(routers, 1, spawn="task", seed=seed, telemetry=False)
    assert mine.router_ring.members() == ref.router_ring.members()
    assert [mine.router_ring.assign(p) for p in peers] == [ref.router_ring.assign(p)
                                                           for p in peers]
    assert [list(mine.router_ring.successors(p)) for p in peers] == \
        [list(ref.router_ring.successors(p)) for p in peers]
    assert len({mine.router_ring.assign(p) for p in peers}) == routers


def test_router_and_gateway_configs_match_the_reference(tmp_path):
    """The replica configs are equal; the gateway configs are equal but for
    ``providers``, whose default is "real" here and "stdlib" there, and equal
    whole when it is passed."""
    kw = dict(spawn="task", seed=9, hb_interval=0.1, hb_miss_limit=3, per_gateway_max_peers=3,
              handshake_budget=5, report_dir=tmp_path, lease_ttl_s=0.7, lease_stagger_s=0.1,
              ticket_key_rotation_s=2.0, gateway_kw={"backend": "cpu", "prewarm_cap": 8})
    mine, ref = RouterFleet(3, 2, **kw), ref_router.RouterFleet(3, 2, **kw)
    # the same pre-allocated ports on both sides
    for rid, m in mine.routers.items():
        ref.routers[rid].ctrl_port = m.ctrl_port
        ref.routers[rid].telemetry_port = m.telemetry_port
    assert mine.router_endpoints() == ref.router_endpoints()
    for rid in mine.routers:
        assert mine._router_config(mine.routers[rid]) == ref._router_config(ref.routers[rid])
    for gid in mine.gateway_ids:
        a, b = mine._gateway_config(gid), ref._gateway_config(gid)
        assert (a.pop("providers"), b.pop("providers")) == ("real", "stdlib")
        assert a == b and a["backend"] == "cpu"
    same = RouterFleet(2, 2, providers="stdlib", **kw)
    other = ref_router.RouterFleet(2, 2, providers="stdlib", **kw)
    for rid, m in same.routers.items():
        other.routers[rid].ctrl_port = m.ctrl_port
        other.routers[rid].telemetry_port = m.telemetry_port
    assert same._gateway_config("gw1") == other._gateway_config("gw1")


# -- a mixed control plane ------------------------------------------------------

TTL_S, STAGGER_S = 0.5, 0.1


@pytest.mark.parametrize("port_rank", [0, 1])
def test_mixed_control_plane_fails_over_across_the_packages(run, monkeypatch, port_rank):
    """A port replica and a reference replica, each the other's peer, and a
    port gateway dialing both: the rank-0 replica takes the lease and the
    gateway registers with both; cancelling the leader lets the other claim
    within the lease TTL (plus its rank's stagger), and the gateway honors
    its STEK push: its heartbeats report the new epoch, its engine's ticket
    ring is the new leader's, and it rejected no authority frame."""
    engines = []

    class Recorded(messaging_mod.SecureMessaging):
        def __init__(self, node, *a, **kw):
            super().__init__(node, *a, **kw)
            engines.append(self)

    monkeypatch.setattr(messaging_mod, "SecureMessaging", Recorded)
    mods = [fleet_router, ref_router] if port_rank == 0 else [ref_router, fleet_router]
    ports = [fleet_router._free_port() for _ in range(2)]
    ids = ["rt0", "rt1"]
    endpoints = [{"router": ids[i], "host": "127.0.0.1", "port": ports[i]} for i in range(2)]

    def cfg(i: int) -> dict:
        return {"router_id": ids[i], "rank": i, "ctrl_port": ports[i],
                "peers": [endpoints[1 - i]], "hb_interval": 0.05, "seed": 7,
                "lease_ttl_s": TTL_S, "lease_stagger_s": STAGGER_S}

    def role(fleet) -> str:
        return fleet.stats()["lease"]["role"]

    def epoch(fleet) -> int:
        return int(fleet.stats()["lease"]["epoch"])

    async def main():
        fleets: dict[int, object] = {}
        tasks = [asyncio.create_task(mods[i].run_router(
            cfg(i), ready_cb=lambda f, i=i: fleets.__setitem__(i, f))) for i in range(2)]
        gateway = None
        try:
            await _until(lambda: len(fleets) == 2, "both replicas")
            gateway = asyncio.create_task(fleet_gateway.run_gateway({
                "gateway_id": "gwM", "bind_host": "127.0.0.1", "routers": endpoints,
                "providers": "stdlib", "hb_interval": 0.05, "prewarm_cap": 4, "seed": 7}))

            def registered(f) -> bool:
                m = f.members.get("gwM")
                return m is not None and m.registered

            await _until(lambda: all(registered(f) for f in fleets.values()),
                         "the gateway's registration with both replicas")
            await _until(lambda: role(fleets[0]) == LEADER, "rank 0 to lead")
            assert role(fleets[1]) == FOLLOWER
            first = epoch(fleets[0])
            await _until(lambda: fleets[0].members["gwM"].stats.get("lease_epoch") == first,
                         "the gateway to honor the first epoch")
            t_cancel = time.monotonic()
            tasks[0].cancel()
            await asyncio.gather(tasks[0], return_exceptions=True)
            await _until(lambda: role(fleets[1]) == LEADER, "the other replica's claim")
            took = time.monotonic() - t_cancel
            assert took <= TTL_S + STAGGER_S + 0.5, took
            second = epoch(fleets[1])
            assert second > first
            member = fleets[1].members["gwM"]
            await _until(lambda: member.stats.get("lease_epoch") == second,
                         "the gateway to honor the new leader's STEK push")
            assert member.registered and member.stats["stale_authority_rejects"] == 0
            (engine,) = engines
            assert engine.tickets.current_epoch == fleets[1].ticket_keys.current_epoch
            assert engine.tickets.export() == fleets[1].ticket_keys.export()
        finally:
            if gateway is not None:
                gateway.cancel()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, *([gateway] if gateway else []),
                                 return_exceptions=True)

    run(main())


# -- the "real" router storm on the CPU -------------------------------------------


def test_real_router_storm_on_the_cpu(run, monkeypatch):
    """Four sessions through two task-mode routers and two gateways with the
    real providers on "cpu": ML-KEM-768 x ML-DSA-65, fused, and
    ChaCha20-Poly1305 on the clients' and the gateways' side (with the
    storm AEAD on the clients, every handshake would be refused as an
    algorithm mismatch).  Through the leader's kill every session
    completes, none is lost, no fallback is armed or serves an op."""
    engines = []

    class Recorded(messaging_mod.SecureMessaging):
        def __init__(self, node, *a, **kw):
            super().__init__(node, *a, **kw)
            engines.append(self)

    monkeypatch.setattr(messaging_mod, "SecureMessaging", Recorded)
    out = run(run_router_storm(
        sessions=4, gateways=2, routers=2, spawn="task", providers="real", backend="cpu",
        concurrency=4, msgs_per_session=2, prewarm_cap=0, ke_timeout=60.0, session_attempts=6,
        seed=3, roll=False, fault_rules=default_router_kill_rules("rt0", 2)), 240.0)
    assert out["providers"] == "ML-KEM-768+ML-DSA-65"
    assert out["completed_sessions"] == out["established_sessions"] == 4
    assert out["lost_established_sessions"] == 0 and out["plaintext_sends"] == 0
    assert out["handshake_failures"] == 0
    assert out["router_kills"] == 1 and out["initial_leader"] == "rt0"
    assert out["device_served_fraction"] == 1.0
    by_role = {"gw": [], "proto": [], "peer": []}
    for e in engines:
        assert (e.kem.name, e.signature.name, e.symmetric.name, e.backend) == (
            "ML-KEM-768", "ML-DSA-65", "ChaCha20-Poly1305", "cpu")
        by_role[next(r for r in by_role if e.node.node_id.startswith(r))].append(e)
    gateways, (plane,), clients = by_role["gw"], by_role["proto"], by_role["peer"]
    assert sorted(g.node.node_id for g in gateways) == ["gw0", "gw1"] and len(clients) == 4
    for e in gateways + [plane]:
        assert e._bfused is not None and e._baead is not None
        queues = [q for f in (e._bkem, e._bsig, e._bfused, e._baead) for q in facade_queues(f)]
        assert queues and all(q.fallback_fn is None for q in queues)
        assert all(q.stats.fallback_ops == 0 for q in queues)
    # the clients shared the client plane's queues, the AEAD's included
    for c in clients:
        assert (c._bkem, c._bsig, c._bfused, c._baead) == (plane._bkem, plane._bsig,
                                                           plane._bfused, plane._baead)
    assert plane._baead.stats()["seal"]["ops"] >= 8  # 4 sessions x 2 messages
    assert sum(g._bfused.stats()["encaps_verify_sign"]["ops"] for g in gateways) == \
        4 + out["full_handshake_reconnects"]


# -- process mode ---------------------------------------------------------------


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_process_mode_router_fleet_failover_restart_and_no_process_left(run, monkeypatch,
                                                                        tmp_path):
    """Two ``python -m`` router replicas and two ``-m`` gateways (stdlib toys
    on "cpu"): both replicas reachable and one leader; a kill of the leader
    hands the lease to the other, with which both gateways stay registered;
    restart_router brings the killed replica back on the same ports, where
    both gateways register again; stop() leaves no router or gateway pid
    alive."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    rf = RouterFleet(2, 2, spawn="process", providers="stdlib", register_timeout=90.0,
                     report_dir=tmp_path, gateway_kw={"backend": "cpu", "prewarm_cap": 0})
    pids: set[int] = set()

    def logs() -> str:
        return "".join(f"{p.name}: {p.read_text()[-1500:]}" for p in sorted(tmp_path.glob("*.log")))

    async def members(rid: str) -> set:
        view = await rf.router_view(rid)
        return {m.get("gateway") for m in (view or {}).get("members") or [] if m.get("port")}

    async def main():
        try:
            await asyncio.wait_for(rf.start(), 150.0)
            pids.update(m.proc.pid for m in rf.routers.values())
            pids.update(p.pid for p in rf._gw_procs.values())
            for m in rf.routers.values():  # both replicas reachable
                _r, w = await asyncio.wait_for(asyncio.open_connection(m.host, m.ctrl_port), 5.0)
                w.close()
            leader = await asyncio.wait_for(rf.await_leader(30.0), 40.0)
            roles = []
            for rid in sorted(rf.routers):
                roles.append(((await rf.router_view(rid)) or {}).get("lease", {}).get("role"))
            assert sorted(roles) == [FOLLOWER, LEADER], logs()
            other = next(r for r in rf.routers if r != leader)
            ports = (rf.routers[leader].ctrl_port, rf.routers[leader].telemetry_port)
            await asyncio.wait_for(rf.kill_router(leader), WAIT_S)
            assert rf.router_kills == 1 and not rf.routers[leader].alive
            await _until(lambda: _leads(other), "the survivor's claim")
            assert await members(other) == {"gw0", "gw1"}, logs()
            restart = await asyncio.wait_for(rf.restart_router(leader), 60.0)
            assert restart["reachable"] and restart["synced"], logs()
            m = rf.routers[leader]
            assert (m.ctrl_port, m.telemetry_port) == ports and m.restarts == 1
            pids.add(m.proc.pid)
            await _until(lambda: _has_both(leader), "both gateways on the restarted replica",
                         60.0)
            assert await rf.leader_id() == other
            await asyncio.wait_for(rf.stop(), 60.0)
        finally:
            for m in rf.routers.values():
                if m.proc is not None and m.proc.returncode is None:
                    m.proc.kill()
                    await m.proc.wait()
            for p in rf._gw_procs.values():
                if p.returncode is None:
                    p.kill()
                    await p.wait()

    async def _leads(rid: str) -> bool:
        return await rf.leader_id() == rid

    async def _has_both(rid: str) -> bool:
        return await members(rid) == {"gw0", "gw1"}

    run(main(), 300.0)
    assert len(pids) == 5
    assert not [p for p in pids if _alive(p)]


def test_router_roll_after_a_leader_kill_keeps_the_fleets_stek_ring(run, monkeypatch):
    """A killed leader, then a roll of both replicas (phase 19's order): each
    respawned replica applies the live leader's sync before the roll stops
    the next one, so the replica that leads at the end holds the fleet's
    STEK ring and every gateway keeps the ring it minted tickets under (a
    respawn that led with its private ring would make them unknown_stek).
    The reference's roll returns on reachable alone and loses the ring
    (ROADMAP C9)."""
    engines = []

    class Recorded(messaging_mod.SecureMessaging):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(messaging_mod, "SecureMessaging", Recorded)
    rf = RouterFleet(2, 2, spawn="task", providers="stdlib", register_timeout=60.0,
                     gateway_kw={"backend": "cpu", "prewarm_cap": 0})

    async def main():
        await rf.start()
        try:
            first = await rf.await_leader(WAIT_S)
            ring = (await rf.router_view(first))["stek_epoch"]
            await _until(lambda: [e.tickets.current_epoch for e in engines] == [ring, ring],
                         "the fleet's ring on both gateways")
            await rf.kill_router(first)
            await _until(rf.leader_id, "the survivor's claim")
            rolled = await rf.rolling_restart()
            assert rolled["ok"] and all(r["synced"] for r in rolled["restarted"]), rolled
            await asyncio.sleep(1.0)  # a lease interval for any late claim
            views = [await rf.router_view(rid) for rid in sorted(rf.routers)]
            assert [v["stek_epoch"] for v in views] == [ring, ring]
            assert [e.tickets.current_epoch for e in engines] == [ring, ring]
        finally:
            await rf.stop()

    run(main(), 180.0)
