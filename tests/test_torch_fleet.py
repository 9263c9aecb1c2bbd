"""The port's gateway fleet (quantum_resistant_p2p_tpu_torch.fleet) against
the JAX package's ``fleet/``, on the CPU.

* Mirrors of ``tests/test_fleet.py`` over the port's modules: 23 of its 25
  tests.  ``test_fleet_storm_survives_seeded_gateway_kill`` and
  ``test_roll_storm_sessions_survive_and_resume`` drive ``fleet.storm``,
  which is not ported yet (ROADMAP item 16b); the report-directory merge is
  mirrored on ``obs.slo.merge_reports`` alone (its CLI is item 17b's).  The
  live cases run task-mode fleets of stdlib toy providers over real
  localhost TCP, as the reference's do.
* Parity with the reference on the same inputs, made with numpy from a
  seed: ring assignments and successor walks, control-frame bytes (each
  package reading the other's), lease transition logs under one
  injected-clock script, jitter draws, process-chaos logs and offline
  routing decisions.
* Interop over TCP in one process: a port router in attach mode drives a
  reference gateway, and a reference router a port gateway (register,
  route, STEK push proved by a ticket the router's ring opens, probe, stop
  and bye).
* The "real" fleet on the CPU: ML-KEM-768 x ML-DSA-65, fused, with
  ChaCha20-Poly1305, on the plain versions, with no fallback armed.
* Process mode: two ``-m`` gateways, one killed, the survivor's bye and
  slo report, no process left.

Tolerance: exact.  PyTorch runs on one thread; JAX's caches are cleared at
the module's end (ROADMAP C1).  Every wait is bounded.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.app import messaging as ref_messaging
from quantum_resistant_p2p_tpu.faults import FaultPlan as RefFaultPlan
from quantum_resistant_p2p_tpu.faults import FaultRule as RefFaultRule
from quantum_resistant_p2p_tpu.faults import plan as ref_plan_mod
from quantum_resistant_p2p_tpu.fleet import control as ref_control
from quantum_resistant_p2p_tpu.fleet import gateway as ref_gateway
from quantum_resistant_p2p_tpu.fleet import manager as ref_manager
from quantum_resistant_p2p_tpu.fleet import ring as ref_ring
from quantum_resistant_p2p_tpu.fleet import stormlib as ref_stormlib
from quantum_resistant_p2p_tpu.net import p2p_node as ref_p2p
from quantum_resistant_p2p_tpu.provider import registry as ref_registry
from quantum_resistant_p2p_tpu_torch.app import messaging as messaging_mod
from quantum_resistant_p2p_tpu_torch.faults import FaultPlan, FaultRule
from quantum_resistant_p2p_tpu_torch.faults import plan as plan_mod
from quantum_resistant_p2p_tpu_torch.fleet import control as fleet_control
from quantum_resistant_p2p_tpu_torch.fleet import gateway as fleet_gateway
from quantum_resistant_p2p_tpu_torch.fleet import stormlib
from quantum_resistant_p2p_tpu_torch.fleet.manager import (FleetBusy, GatewayFleet,
                                                           GatewayMember)
from quantum_resistant_p2p_tpu_torch.fleet.ring import HashRing
from quantum_resistant_p2p_tpu_torch.fleet.stormlib import storm_env
from quantum_resistant_p2p_tpu_torch.net.p2p_node import P2PNode
from quantum_resistant_p2p_tpu_torch.obs.slo import merge_reports
from quantum_resistant_p2p_tpu_torch.provider import get_kem, get_signature, get_symmetric
from quantum_resistant_p2p_tpu_torch.provider.scheduler import select_slot

REPO = Path(__file__).resolve().parents[1]
#: the longest one wait of a live scenario may take
WAIT_S = 20.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_release():
    """One PyTorch CPU thread (xdist workers share the cores); JAX's caches
    cleared at the end (ROADMAP C1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _health_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("QRP2P_HEALTH_CACHE", str(tmp_path / "health"))


@pytest.fixture(autouse=True)
def _registries(monkeypatch):
    """The storm toys a test registers (itself, or through a gateway task of
    either package) leave both registries as they were: other test modules
    of the same process list them."""
    from quantum_resistant_p2p_tpu_torch.provider import registry

    for mod in (registry, ref_registry):
        for table in ("_KEMS", "_SIGS"):
            monkeypatch.setattr(mod, table, dict(getattr(mod, table)))
    for mod in (stormlib, ref_stormlib):
        monkeypatch.setattr(mod, "_STORM_REGISTERED", False)


@pytest.fixture
def run():
    loop = asyncio.new_event_loop()
    yield lambda coro: loop.run_until_complete(asyncio.wait_for(coro, 120.0))
    loop.run_until_complete(loop.shutdown_asyncgens())
    loop.close()


@pytest.fixture(autouse=True)
def fast_timeout(monkeypatch):
    monkeypatch.setattr(messaging_mod, "KEY_EXCHANGE_TIMEOUT", 5.0)
    monkeypatch.setattr(messaging_mod, "KE_RETRY_BACKOFF_S", 0.05)


async def _until(cond, what: str, timeout: float = WAIT_S) -> None:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


KEYS = [f"peer{i:04d}" for i in range(400)]


# -- consistent-hash ring (mirrors) -------------------------------------------


def test_ring_deterministic_across_instances():
    a = HashRing(["gw0", "gw1", "gw2"], seed=7)
    b = HashRing(["gw2", "gw0", "gw1"], seed=7)
    assert [a.assign(k) for k in KEYS] == [b.assign(k) for k in KEYS]
    c = HashRing(["gw0", "gw1", "gw2"], seed=8)
    assert [a.assign(k) for k in KEYS] != [c.assign(k) for k in KEYS]


def test_ring_add_moves_only_the_new_members_arc():
    ring = HashRing(["gw0", "gw1", "gw2"], seed=0)
    before = {k: ring.assign(k) for k in KEYS}
    ring.add("gw3")
    moved = {k for k in KEYS if ring.assign(k) != before[k]}
    assert moved
    assert all(ring.assign(k) == "gw3" for k in moved)


def test_ring_remove_moves_only_the_dead_members_arc():
    ring = HashRing(["gw0", "gw1", "gw2"], seed=0)
    before = {k: ring.assign(k) for k in KEYS}
    ring.remove("gw1")
    for k in KEYS:
        if before[k] != "gw1":
            assert ring.assign(k) == before[k]
        else:
            assert ring.assign(k) in ("gw0", "gw2")


def test_ring_successors_start_at_owner_and_cover_members():
    ring = HashRing(["gw0", "gw1", "gw2"], seed=0)
    for k in KEYS[:32]:
        order = list(ring.successors(k))
        assert order[0] == ring.assign(k)
        assert sorted(order) == ["gw0", "gw1", "gw2"]


# -- the shared two-level placement policy (mirrors) --------------------------


def _member(gid, index, clock):
    return GatewayMember(gid, index, cooloff_s=1.0, cooloff_max_s=8.0, clock=clock)


def test_select_slot_places_among_gateway_members():
    now = [100.0]
    members = [_member(f"gw{i}", i, lambda: now[0]) for i in range(3)]
    members[0].inflight = 5
    members[1].inflight = 2
    members[2].inflight = 2
    assert select_slot(members) is members[1]


def test_select_slot_prefers_probe_ready_member_then_degrades():
    now = [100.0]
    members = [_member(f"gw{i}", i, lambda: now[0]) for i in range(3)]
    members[1].breaker.record_failure("device")
    assert select_slot(members) is members[0]
    now[0] += 2.0
    assert select_slot(members) is members[1]
    members[1].breaker.record_failure("probe")
    members[0].breaker.quarantine("test")
    assert select_slot(members) is members[2]


# -- router-side routing and admission, offline (mirrors) ---------------------


def _offline_fleet(n=3, per_gateway_max_peers=0, clock=None, fleet_cls=GatewayFleet, seed=0):
    fleet = fleet_cls(n, spawn="task", providers="stdlib", seed=seed,
                      per_gateway_max_peers=per_gateway_max_peers,
                      clock=clock or time.monotonic)
    for m in fleet.members.values():
        m.host, m.port = "127.0.0.1", 40000 + m.index
    return fleet


def test_fleet_admission_shed_is_typed_busy():
    fleet = _offline_fleet(2, per_gateway_max_peers=2)
    for i in range(4):
        assert fleet.route(f"peer{i}") is not None
    with pytest.raises(FleetBusy):
        fleet.route("peer4")
    reply = fleet._route_reply({"peer_id": "peer5"})
    assert reply == {"type": fleet_control.BUSY, "scope": "fleet"}
    assert fleet.route_sheds == 2
    fleet.session_done(fleet.ring.assign("peer0"))
    assert fleet.route("peer6") is not None


def test_fleet_budget_excludes_open_members():
    now = [100.0]
    fleet = _offline_fleet(3, per_gateway_max_peers=5, clock=lambda: now[0])
    assert fleet.fleet_budget() == 15
    fleet.members["gw1"].breaker.record_failure("device")
    assert fleet.fleet_budget() == 10


def test_all_dead_budget_sheds_instead_of_admitting_unbounded():
    now = [100.0]
    fleet = _offline_fleet(3, per_gateway_max_peers=5, clock=lambda: now[0])
    for m in fleet.members.values():
        m.breaker.record_failure("device")
    assert fleet.fleet_budget() == 0
    with pytest.raises(FleetBusy):
        fleet.route("peer0")
    assert _offline_fleet(3).fleet_budget() is None


def test_probe_heal_refreshes_liveness_no_instant_redeath(run):
    now = [100.0]
    fleet = _offline_fleet(2, clock=lambda: now[0])
    gw1 = fleet.members["gw1"]
    gw1.last_hb = now[0]
    now[0] += fleet.hb_miss_limit * fleet.hb_interval + 1.0
    fleet._health_tick()
    assert gw1.breaker.state == "open"
    now[0] += gw1.breaker.cooloff_s + 0.1
    assert gw1.breaker.acquire_dispatch() == "probe"

    async def wire_probe_ok(member, n):
        return None

    fleet._probe_call = wire_probe_ok
    run(fleet._probe_gateway(gw1, 1))
    assert gw1.breaker.state == "closed"
    fleet._health_tick()
    assert gw1.breaker.state == "closed"


def test_route_hands_open_members_arc_to_ring_successor():
    now = [100.0]
    fleet = _offline_fleet(3, clock=lambda: now[0])
    owner_key = next(k for k in KEYS if fleet.ring.assign(k) == "gw1")
    successor = list(fleet.ring.successors(owner_key))[1]
    assert fleet.route(owner_key).gateway_id == "gw1"
    fleet.members["gw1"].breaker.record_failure("device")
    assert fleet.route(owner_key).gateway_id == successor
    assert fleet.handoffs == 1
    key2 = next(k for k in KEYS if fleet.ring.assign(k) == "gw0")
    assert fleet.route(key2, exclude=("gw0",)).gateway_id != "gw0"


# -- seeded process-scope chaos (mirrors) -------------------------------------


def test_process_chaos_log_is_deterministic_from_seed():
    def drive(seed):
        plan = FaultPlan(seed, [
            FaultRule("process", "kill_gateway", match={"gateway": "gw1"}, nth=3),
            FaultRule("process", "pause_gateway", match={"gateway": "gw0"}, nth=2,
                      delay_s=0.5),
        ])
        with plan.activate():
            for _tick in range(4):
                for gid in ("gw0", "gw1", "gw2"):
                    plan_mod.process_control(gid)
        return json.dumps(plan.injected, sort_keys=True)

    log = drive(11)
    assert log == drive(11)
    assert json.loads(log) == [
        {"scope": "process", "action": "pause_gateway", "n": 2, "gateway": "gw0",
         "delay_s": 0.5},
        {"scope": "process", "action": "kill_gateway", "n": 3, "gateway": "gw1"},
    ]
    assert drive(12) == log


def test_process_control_is_noop_without_plan():
    assert plan_mod.process_control("gw0") == []


# -- storm_env (mirror) -------------------------------------------------------


def test_storm_env_restores_timeout_even_on_raise():
    before = messaging_mod.KEY_EXCHANGE_TIMEOUT
    with pytest.raises(RuntimeError):
        with storm_env(99.0):
            assert messaging_mod.KEY_EXCHANGE_TIMEOUT == 99.0
            raise RuntimeError("storm blew up")
    assert messaging_mod.KEY_EXCHANGE_TIMEOUT == before


# -- per-node SLO report merging (mirrors) ------------------------------------


def _node_report(node, good, bad, burn_fast, alerting=False):
    return {"node": node, "slo": {"specs": [{
        "name": "handshake_p99", "objective": 0.99, "good_total": good, "bad_total": bad,
        "burn_fast": burn_fast, "alerting": alerting}]}}


def test_merge_reports_fleet_totals_and_worst_node():
    merged = merge_reports([
        _node_report("gw0", 98.0, 2.0, 0.5),
        _node_report("gw1", 40.0, 10.0, 20.0, alerting=True),
        _node_report("gw2", 100.0, 0.0, 0.0),
    ])
    slo = merged["slos"]["handshake_p99"]
    assert slo["good_total"] == 238.0 and slo["bad_total"] == 12.0
    assert slo["fleet_error_rate"] == round(12.0 / 250.0, 6)
    assert slo["fleet_burn"] == round((12.0 / 250.0) / 0.01, 4)
    assert slo["worst_node"] == "gw1"
    assert merged["worst_node"] == "gw1"
    assert merged["alerting"] == ["gw1"]


def test_slo_merge_cli_merges_a_report_dir(tmp_path):
    """The reference's test drives ``tools/slo_merge.py`` (ROADMAP item
    17b); here the same report directory goes through ``merge_reports``,
    the function that CLI calls."""
    for i in range(2):
        (tmp_path / f"gw{i}_slo_report.json").write_text(
            json.dumps(_node_report(f"gw{i}", 10.0 * (i + 1), float(i), 0.1)))
    reports = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*_slo_report.json"))]
    doc = merge_reports(reports)
    assert doc["nodes"] == ["gw0", "gw1"]
    assert doc["slos"]["handshake_p99"]["good_total"] == 30.0


# -- live fleet: death, handoff, half-open heal (mirrors) ---------------------


FAST = dict(hb_interval=0.05, cooloff_s=0.25, cooloff_max_s=2.0, register_timeout=30.0,
            providers="stdlib")


def _storm_client(name: str):
    """A port client engine on the port's storm toys ("cpu")."""
    stormlib.register_storm_providers()
    node = P2PNode(node_id=name, host="127.0.0.1", port=0)
    return node, messaging_mod.SecureMessaging(
        node, kem=get_kem("STORM-KEM", "cpu"), symmetric=stormlib.StormAEAD(),
        signature=get_signature("STORM-SIG", "cpu"), backend="cpu", auto_heal=False)


def test_gateway_death_mid_handshake_fails_fast_typed(run):
    async def scenario():
        fleet = GatewayFleet(2, spawn="task", **FAST)
        await fleet.start()
        node = None
        try:
            node, sm = _storm_client("client")
            victim = fleet.members["gw0"]
            assert await node.connect_to_peer("127.0.0.1", victim.port) == "gw0"
            plan = FaultPlan(0, [FaultRule("net.send", "drop",
                                           match={"msg_type": "ke_response"}, nth=1)])
            with plan.activate():
                task = asyncio.ensure_future(sm.initiate_key_exchange("gw0"))
                await asyncio.sleep(0.15)
                fleet.kill("gw0")
                t0 = time.monotonic()
                ok = await task
                waited = time.monotonic() - t0
            assert plan.injected
            assert ok is False
            assert waited < messaging_mod.KEY_EXCHANGE_TIMEOUT / 2
            assert "gw0" not in sm.shared_keys
            assert await sm.send_message("gw0", b"secret") is None
            sm.close()
        finally:
            if node is not None:
                await node.stop()
            await fleet.stop()

    run(scenario())


def test_partitioned_gateway_heals_via_half_open_probe(run):
    async def scenario():
        fleet = GatewayFleet(2, spawn="task", **FAST)
        events = []
        fleet.on_event(lambda ev, gid: events.append((ev, gid)))
        await fleet.start()
        try:
            owned = next(k for k in KEYS if fleet.ring.assign(k) == "gw1")
            assert fleet.route(owned).gateway_id == "gw1"
            fleet.partition("gw1", 0.6)
            await _until(lambda: fleet.members["gw1"].breaker.state != "closed",
                         "the partitioned gateway's breaker to open", 5.0)
            assert fleet.members["gw1"].breaker.state == "open"
            assert ("gateway_dead", "gw1") in events
            assert fleet.route(owned).gateway_id == "gw0"
            await _until(lambda: fleet.members["gw1"].breaker.state == "closed",
                         "the half-open probe to close the breaker", 10.0)
            assert ("gateway_healed", "gw1") in events
            assert fleet.route(owned).gateway_id == "gw1"
        finally:
            await fleet.stop()

    run(scenario())


# -- graceful drain / rolling restart / STEK distribution (mirrors) -----------


def test_draining_member_excluded_from_routing():
    fleet = _offline_fleet(3)
    fleet.members["gw0"].draining = True
    for peer in (f"p{i}" for i in range(24)):
        m = fleet.route(peer)
        assert m is not None and m.gateway_id != "gw0"
        fleet.session_done(m.gateway_id)
    fleet.per_gateway_max_peers = 4
    assert fleet.fleet_budget() == 8


def test_drain_gateway_is_a_valid_chaos_action():
    FaultRule("process", "drain_gateway", match={"gateway": "gw0"})
    with pytest.raises(ValueError):
        FaultRule("process", "nonsense")
    for action in ("corrupt", "expire", "replay"):
        FaultRule("ticket", action)
    with pytest.raises(ValueError):
        FaultRule("ticket", "drop")


def test_reset_for_respawn_forgets_the_dead_incarnation():
    m = GatewayMember("gw0", 0, clock=time.monotonic)
    m.host, m.port, m.pid = "127.0.0.1", 40000, 123
    m.last_hb = 1.0
    m.breaker.record_failure("device")
    m.inflight = 7
    m.reset_for_respawn()
    assert not m.registered and m.pid is None and m.last_hb is None
    assert m.breaker.state == "closed"
    assert m.inflight == 0 and m.restarts == 1


def test_stek_pushed_on_registration_and_rotation(run):
    async def main():
        fleet = GatewayFleet(2, spawn="task", hb_interval=0.05, providers="stdlib")
        try:
            await fleet.start()
            blob = fleet.ticket_keys.seal_ticket(
                {"v": 1, "holder": "x", "secret": "00" * 32, "nonce": "n"})
            epoch0 = fleet.ticket_keys.current_epoch
            epoch1 = await fleet.rotate_stek()
            assert epoch1 != epoch0
            meta, _secret = fleet.ticket_keys.open_ticket(blob)
            assert meta["holder"] == "x"
            assert fleet.stats()["stek_epoch"] == epoch1
        finally:
            await fleet.stop()

    run(main())


def test_rolling_restart_respawns_and_reregisters(run):
    async def main():
        fleet = GatewayFleet(2, spawn="task", hb_interval=0.05, providers="stdlib")
        try:
            await fleet.start()
            rep = await fleet.rolling_restart(drain_timeout=10.0)
            assert rep["ok"] is True
            assert [r["gateway"] for r in rep["restarted"]] == ["gw0", "gw1"]
            assert all(r["graceful_exit"] and r["registered"] for r in rep["restarted"])
            assert all(m.registered and not m.draining for m in fleet.members.values())
            assert all(m.restarts == 1 for m in fleet.members.values())
        finally:
            await fleet.stop()

    run(main())


# -- parity with the reference, same seeded inputs ----------------------------


def _names(rng, n: int, prefix: str) -> list[str]:
    return [f"{prefix}{bytes(rng.integers(0, 256, 4, dtype=np.uint8)).hex()}" for _ in range(n)]


@pytest.mark.parametrize("seed", [160, 161, 162])
def test_ring_assignments_match_the_reference(seed):
    """Members, vnodes, ring seed and 400 keys from the numpy seed: assign,
    successors and the histogram agree before and after an add and a
    remove."""
    rng = np.random.default_rng(seed)
    members = _names(rng, int(rng.integers(2, 7)), "gw")
    vnodes, ring_seed = int(rng.integers(1, 97)), int(rng.integers(0, 2**31))
    keys = _names(rng, 400, "peer")
    mine = HashRing(members, vnodes=vnodes, seed=ring_seed)
    ref = ref_ring.HashRing(members, vnodes=vnodes, seed=ring_seed)

    def same():
        assert mine.members() == ref.members() and len(mine) == len(ref)
        assert [mine.assign(k) for k in keys] == [ref.assign(k) for k in keys]
        assert [list(mine.successors(k)) for k in keys] == [list(ref.successors(k))
                                                            for k in keys]
        assert mine.assignment_counts(keys) == ref.assignment_counts(keys)

    same()
    added = _names(rng, 1, "gw")[0]
    mine.add(added)
    ref.add(added)
    same()
    gone = members[int(rng.integers(0, len(members)))]
    mine.remove(gone)
    ref.remove(gone)
    same()
    assert HashRing(vnodes=vnodes).assign("k") is ref_ring.HashRing(vnodes=vnodes).assign("k")


class _CaptureWriter:
    """Just enough StreamWriter for ``send_ctrl``."""

    def __init__(self):
        self.buf = b""

    def write(self, data):
        self.buf += data

    async def drain(self):
        pass

    def close(self):
        pass


async def _read_all(read_ctrl, buf: bytes) -> list[dict]:
    reader = asyncio.StreamReader()
    reader.feed_data(buf)
    reader.feed_eof()
    out = []
    while True:
        try:
            out.append(await read_ctrl(reader))
        except asyncio.IncompleteReadError:
            return out


def _frames(rng) -> list[dict]:
    types = [v for k, v in vars(fleet_control).items() if k.isupper() and isinstance(v, str)
             and v.startswith("__")]
    frames = []
    for _ in range(24):
        frame = {"type": types[int(rng.integers(0, len(types)))]}
        for j in range(int(rng.integers(0, 6))):
            kind = int(rng.integers(0, 5))
            value = (int(rng.integers(-2**40, 2**40)) if kind == 0
                     else float(rng.random()) if kind == 1
                     else bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                             dtype=np.uint8)).hex() if kind == 2
                     else [[str(int(rng.integers(0, 99))), "é"]] if kind == 3
                     else {"stats": {"ops": int(rng.integers(0, 9)), "ok": bool(j % 2),
                                     "none": None}})
            frame[f"k{j}"] = value
        frames.append(frame)
    return frames


@pytest.mark.parametrize("seed", [163, 164])
def test_control_frames_are_byte_identical_and_cross_read(run, seed):
    """The same dict goes out as the same bytes from either package, and
    each package's reader reads the other's frames; a chunk flag is
    refused by both."""
    frames = _frames(np.random.default_rng(seed))

    async def main():
        mine, ref = _CaptureWriter(), _CaptureWriter()
        for f in frames:
            await fleet_control.send_ctrl(mine, f)
            await ref_control.send_ctrl(ref, f)
        assert mine.buf == ref.buf
        assert await _read_all(fleet_control.read_ctrl, ref.buf) == frames
        assert await _read_all(ref_control.read_ctrl, mine.buf) == frames
        chunked = bytearray(mine.buf[:fleet_control._HEADER.size + 2])
        chunked[3] = 1  # the flags byte
        for read in (fleet_control.read_ctrl, ref_control.read_ctrl):
            reader = asyncio.StreamReader()
            reader.feed_data(bytes(chunked))
            reader.feed_eof()
            with pytest.raises(ValueError, match="bad control frame header"):
                await read(reader)

    run(main())
    names = ("GW_HELLO", "GW_HEARTBEAT", "GW_PROBE", "GW_PROBE_OK", "GW_TICKET_KEYS",
             "GW_DRAIN", "GW_STOP", "GW_BYE", "RT_LEASE", "RT_SYNC", "RT_REJECT", "ROUTE",
             "ROUTE_OK", "ROUTE_DONE", "BUSY", "NO_ROUTE")
    assert [getattr(fleet_control, n) for n in names] == [getattr(ref_control, n)
                                                          for n in names]


def _lease_script(lease_mod, seed: int) -> list:
    """One seeded script of clock steps, claims, renewals, observed frames,
    rejects and rejoins on two replicas of ``lease_mod``; returns every
    answer, view and transition log."""
    rng = np.random.default_rng(seed)
    now = [0.0]
    # times on a grid of binary fractions, so the script lands exactly on
    # expiries, stagger edges and renewal points too
    tick = 0.125
    ttl, stagger = tick * int(rng.integers(4, 17)), tick * int(rng.integers(1, 5))
    leases = [lease_mod.LeaderLease(f"rt{i}", i, ttl_s=ttl, claim_stagger_s=stagger,
                                    clock=lambda: now[0]) for i in range(2)]
    out = []
    for _ in range(300):
        now[0] += tick * int(rng.integers(0, 9))
        me = leases[int(rng.integers(0, 2))]
        op = int(rng.integers(0, 6))
        if op == 0:
            out.append(("claim", me.claim_due() and me.claim()))
        elif op == 1:
            out.append(("renew", me.renew_due() and me.renew()))
        elif op == 2:
            holder = ("rt0", "rt1", "rt9")[int(rng.integers(0, 3))]
            epoch = max(0, me.epoch + int(rng.integers(-1, 3)))
            out.append(("observe", me.observe(holder, epoch, tick * int(rng.integers(1, 17)))))
        elif op == 3:
            out.append(("reject", me.observe_reject(me.epoch + int(rng.integers(-1, 2)))))
        elif op == 4:
            me.rejoin()
            out.append(("rejoin", me.role))
        else:
            out.append(("view", me.view(), me.is_leader, me.lease_expired()))
    out.append([lease.transitions for lease in leases])
    return out


@pytest.mark.parametrize("seed", [165, 166, 167])
def test_lease_state_sequence_matches_the_reference(seed):
    from quantum_resistant_p2p_tpu.fleet import lease as ref_lease
    from quantum_resistant_p2p_tpu_torch.fleet import lease

    mine = _lease_script(lease, seed)
    assert repr(mine) == repr(_lease_script(ref_lease, seed))
    assert any(t for t in mine[-1])  # the script moved some role


@pytest.mark.parametrize("seed", [168, 169])
def test_seeded_jitter_draws_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        s = int(rng.integers(0, 2**62))
        labels = _names(rng, int(rng.integers(1, 4)), "l")
        a = stormlib.seeded_jitter_rng(s, *labels)
        b = ref_stormlib.seeded_jitter_rng(s, *labels)
        assert [a.random() for _ in range(16)] == [b.random() for _ in range(16)]
        assert a.uniform(0.0, 0.25) == b.uniform(0.0, 0.25)


def _chaos_log(plan_cls, rule_cls, hook, seed: int) -> str:
    rng = np.random.default_rng(seed)
    gids = ["gw0", "gw1", "gw2", "gw3"]
    actions = ("kill_gateway", "pause_gateway", "partition", "drain_gateway")
    rules = []
    for _ in range(6):
        gid = gids[int(rng.integers(0, 4))] if rng.random() < 0.8 else "*"
        rules.append(rule_cls("process", actions[int(rng.integers(0, 4))],
                              match={"gateway": gid}, nth=int(rng.integers(1, 6)),
                              times=int(rng.integers(1, 3)),
                              delay_s=round(float(rng.uniform(0.1, 2.0)), 3)))
    plan = plan_cls(seed, rules)
    with plan.activate():
        for _tick in range(12):
            for gid in gids:
                if rng.random() < 0.9:
                    hook(gid)
    return json.dumps(plan.injected, sort_keys=True)


@pytest.mark.parametrize("seed", [170, 171, 172])
def test_same_plan_seed_gives_the_reference_chaos_log(seed):
    mine = _chaos_log(FaultPlan, FaultRule, plan_mod.process_control, seed)
    assert mine == _chaos_log(RefFaultPlan, RefFaultRule, ref_plan_mod.process_control, seed)
    assert json.loads(mine)


@pytest.mark.parametrize("seed", [173, 174])
def test_offline_routing_matches_the_reference(seed):
    """Both routers, offline with the same seed and members, walk the same
    breaker failures, excludes, drains and session ends to the same
    answers and counters."""
    rng = np.random.default_rng(seed)
    now = [100.0]
    n, cap, ring_seed = int(rng.integers(2, 6)), int(rng.integers(0, 4)), int(rng.integers(0, 99))
    fleets = [_offline_fleet(n, cap, lambda: now[0], cls, ring_seed)
              for cls in (GatewayFleet, ref_manager.GatewayFleet)]
    answers = [[], []]
    for step in range(300):
        op = int(rng.integers(0, 10))
        gid = f"gw{int(rng.integers(0, n))}"
        peer = f"peer{int(rng.integers(0, 64))}"
        exclude = (f"gw{int(rng.integers(0, n))}",) if rng.random() < 0.2 else ()
        now[0] += float(rng.uniform(0.0, 0.5))
        for fleet, out in zip(fleets, answers):
            m = fleet.members[gid]
            if op == 0:
                m.breaker.record_failure("device")
            elif op == 1 and m.breaker.acquire_dispatch() == "probe":
                m.breaker.record_success("probe")
            elif op == 2:
                m.draining = not m.draining
            elif op == 3:
                fleet.session_done(gid)
            else:
                out.append(fleet._route_reply({"peer_id": peer, "exclude": list(exclude)}))
            out.append((m.breaker.state, fleet.fleet_budget()))
    assert answers[0] == answers[1]
    keys = ("routes_ok", "route_sheds", "rebalance_picks", "handoffs", "fleet_budget")
    assert [fleets[0].stats()[k] for k in keys] == [fleets[1].stats()[k] for k in keys]


def test_gateway_defaults_and_the_launch_counts_in_its_stats():
    """The port's gateway serves the real providers on "cuda" unless told
    otherwise; every other default is the reference's.  Its stats name
    every kernel wrapper's launch count."""
    mine, ref = dict(fleet_gateway.DEFAULTS), dict(ref_gateway.DEFAULTS)
    assert (mine.pop("providers"), mine.pop("backend"), ref.pop("providers")) == (
        "real", "cuda", "stdlib")
    assert mine == ref
    launches = fleet_gateway.kernel_launches()
    assert len(launches) == 17 and all(isinstance(v, int) for v in launches.values())
    assert {"keccak_sponge", "mlkem_sample_ntt", "mldsa_rej_bounded",
            "chacha_blocks"} <= set(launches)


# -- interop over TCP ---------------------------------------------------------


def _gateway_cfg(port: int, gid: str) -> dict:
    return {"gateway_id": gid, "router_host": "127.0.0.1", "bind_host": "127.0.0.1",
            "router_port": port, "providers": "stdlib", "hb_interval": 0.05,
            "prewarm_cap": 4}


async def _interop(fleet, run_gateway, client_pair, stop_frame, gid: str) -> dict:
    """Start ``fleet`` (attach mode), a gateway task of the other package on
    it, route a client there, handshake, rotate and push the STEK, probe,
    stop; returns the member's bye stats."""
    await fleet.start()
    task = asyncio.create_task(run_gateway(_gateway_cfg(fleet.ctrl_port, gid)))
    node = None
    try:
        await _until(lambda: gid in fleet.members and fleet.members[gid].registered,
                     "the gateway's registration")
        member = fleet.members[gid]
        await _until(lambda: member.hb_count >= 2, "two heartbeats")
        assert fleet.route("someone").gateway_id == gid
        epoch = await fleet.rotate_stek()
        node, sm = client_pair()
        await node.start()
        reply = await fleet_control.route_query("127.0.0.1", fleet.ctrl_port, node.node_id)
        assert (reply["type"], reply["gateway"], reply["port"]) == (
            fleet_control.ROUTE_OK, gid, member.port)
        assert await node.connect_to_peer(reply["host"], reply["port"]) == gid
        assert await asyncio.wait_for(sm.initiate_key_exchange(gid), WAIT_S)
        assert await sm.send_message(gid, b"across the packages") is not None
        await _until(lambda: sm.ticket_for(gid) is not None, "the gateway's ticket")
        # the gateway minted under the ring this router pushed after rotating
        fields, _secret = fleet.ticket_keys.open_ticket(sm.ticket_for(gid)["ticket"])
        assert fields and fleet.ticket_keys.current_epoch == epoch
        await _until(lambda: (member.stats.get("msgs_received") or 0) >= 1,
                     "the message in a heartbeat")
        member._probe_n += 1
        await fleet._probe_call(member, member._probe_n)  # raises unless answered
        await stop_frame(member.writer, {"type": fleet_control.GW_STOP})
        await asyncio.wait_for(task, WAIT_S)
        await _until(lambda: member.final_stats is not None, "the bye")
        return member.final_stats
    finally:
        if node is not None:
            await node.stop()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await fleet.stop()


def test_port_router_drives_a_reference_gateway(run):
    """A port router in attach mode and a reference gateway task: register,
    heartbeats, route, STEK push (a port client's ticket from that gateway
    opens under the router's ring), probe, stop, bye."""
    fleet = GatewayFleet(0, attach=True, spawn="task", hb_interval=0.05, providers="stdlib")
    bye = run(_interop(fleet, ref_gateway.run_gateway, lambda: _storm_client("port-client"),
                       fleet_control.send_ctrl, "gwR"))
    assert bye["msgs_received"] == 1 and bye["fallback_ops"] == 0
    assert "kernel_launches" not in bye  # the reference gateway's stats


def test_reference_router_drives_a_port_gateway(run):
    """A reference router in attach mode and a port gateway task, the other
    way round; the reference's manager keeps the port's extra
    ``kernel_launches`` key in the member's stats."""
    def ref_client():
        ref_stormlib.register_storm_providers()
        node = ref_p2p.P2PNode(node_id="ref-client", host="127.0.0.1", port=0)
        return node, ref_messaging.SecureMessaging(
            node, kem=ref_registry.get_kem("STORM-KEM", "cpu"),
            symmetric=ref_stormlib.StormAEAD(),
            signature=ref_registry.get_signature("STORM-SIG", "cpu"), auto_heal=False)

    fleet = ref_manager.GatewayFleet(0, attach=True, spawn="task", hb_interval=0.05)
    bye = run(_interop(fleet, fleet_gateway.run_gateway, ref_client, ref_control.send_ctrl,
                       "gwP"))
    assert bye["msgs_received"] == 1 and bye["fallback_ops"] == 0
    assert bye["device_served_fraction"] == 1.0
    assert set(bye["kernel_launches"]) == set(fleet_gateway.kernel_launches())


# -- the "real" fleet on the CPU ----------------------------------------------


def test_real_fleet_on_the_cpu_serves_the_default_handshake(run, monkeypatch):
    """Two task-mode gateways with the real providers on "cpu": ML-KEM-768 x
    ML-DSA-65, fused, and ChaCha20-Poly1305 on its batched data plane, no
    fallback armed.  One client routes, handshakes and sends a message; the
    keys agree and the gateway's stats count no fallback op."""
    from quantum_resistant_p2p_tpu_torch.provider import facade_queues

    gateways = {}

    class Recorded(messaging_mod.SecureMessaging):
        def __init__(self, node, *a, **kw):
            super().__init__(node, *a, **kw)
            gateways[node.node_id] = self

    monkeypatch.setattr(messaging_mod, "SecureMessaging", Recorded)

    async def main():
        fleet = GatewayFleet(2, spawn="task", providers="real", hb_interval=0.1,
                             register_timeout=90.0,
                             gateway_kw={"backend": "cpu", "prewarm_cap": 0})
        await fleet.start()
        node = P2PNode("real-client", "127.0.0.1", 0)
        try:
            await node.start()
            client = messaging_mod.SecureMessaging(
                node, backend="cpu", symmetric=get_symmetric("ChaCha20-Poly1305"),
                auto_heal=False)
            reply = await fleet_control.route_query("127.0.0.1", fleet.ctrl_port, node.node_id)
            gid = reply["gateway"]
            gw = gateways[gid]
            assert (gw.kem.name, gw.signature.name, gw.symmetric.name, gw.backend) == (
                "ML-KEM-768", "ML-DSA-65", "ChaCha20-Poly1305", "cpu")
            assert gw._bfused is not None and gw._baead is not None
            queues = [q for f in (gw._bkem, gw._bsig, gw._bfused, gw._baead)
                      for q in facade_queues(f)]
            assert queues and all(q.fallback_fn is None for q in queues)
            assert await node.connect_to_peer(reply["host"], reply["port"]) == gid
            assert await asyncio.wait_for(client.initiate_key_exchange(gid), 60.0)
            await _until(lambda: gw.verify_key_exchange_state(node.node_id), "the confirm")
            assert gw.shared_keys[node.node_id] == client.shared_keys[gid]
            assert await client.send_message(gid, b"on the plain versions") is not None
            member = fleet.members[gid]
            await _until(lambda: (member.stats.get("msgs_received") or 0) == 1,
                         "the message in a heartbeat", 60.0)
            stats = member.stats
            assert stats["fallback_ops"] == 0 and stats["fallback_trips"] == 0
            assert stats["ops"] > 0 and stats["device_served_fraction"] == 1.0
            assert gw._bfused.stats()["encaps_verify_sign"]["ops"] == 1
            assert gw._baead.stats()["open"]["ops"] >= 1
            client.close()
        finally:
            await node.stop()
            await fleet.stop()

    run(main())


# -- process mode -------------------------------------------------------------


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_process_mode_fleet_kill_handoff_and_no_process_left(run, monkeypatch, tmp_path):
    """Two ``python -m`` gateways (stdlib toys on "cpu") register; a kill of
    one opens its fleet breaker and its arc goes to the successor; stop()
    gets the survivor's bye and slo report; no gateway pid is alive."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    fleet = GatewayFleet(2, spawn="process", providers="stdlib", hb_interval=0.1,
                         cooloff_s=30.0, register_timeout=90.0, report_dir=tmp_path,
                         gateway_kw={"backend": "cpu", "prewarm_cap": 0})

    def logs() -> str:
        return "".join(p.read_text()[-1500:] for p in sorted(tmp_path.glob("*.log")))

    async def main():
        try:
            await asyncio.wait_for(fleet.start(), 120.0)
            pids = {g: m.pid for g, m in fleet.members.items()}
            assert all(m.registered and m.proc is not None for m in fleet.members.values())
            owned = next(k for k in KEYS if fleet.ring.assign(k) == "gw0")
            successor = list(fleet.ring.successors(owned))[1]
            assert fleet.route(owned).gateway_id == "gw0"
            fleet.kill("gw0")
            await asyncio.wait_for(_until(
                lambda: fleet.members["gw0"].breaker.state == "open",
                "the killed gateway's breaker to open"), WAIT_S)
            assert fleet.route(owned).gateway_id == successor == "gw1"
            await asyncio.wait_for(fleet.stop(), 60.0)
            survivor = fleet.members["gw1"]
            assert survivor.final_stats is not None, logs()
            assert fleet.members["gw0"].final_stats is None
            reports = fleet.collect_reports()
            assert [r["node"] for r in reports] == ["gw1"]
            assert (tmp_path / "gw1_slo_report.json").is_file()
            return pids
        finally:
            for m in fleet.members.values():
                if m.proc is not None and m.proc.returncode is None:
                    m.proc.kill()
                    await m.proc.wait()

    pids = run(main())
    assert not [p for p in pids.values() if _alive(p)]
