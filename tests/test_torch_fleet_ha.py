"""The port's replicated-router control plane (fleet/lease.py and the
lease half of fleet/manager.py), on the CPU.

Mirrors 7 of the 8 tests of ``tests/test_router_ha.py`` over the port's
modules: lease failover on injected clocks, the tied claim, sticky
demotion, stale lease and sync frames fenced with a typed reject, a stale
leader demoting on the reject reply (live TCP), a ticket minted under a
dead leader redeeming after failover, and a second hello superseding a
stale control link.  ``test_router_storm_survives_seeded_leader_kill``
drives ``fleet.storm``, which is not ported yet (ROADMAP item 16b).  One
more test holds the gateway's half of the fencing: STEK pushes and drains
below the lease epoch it honors are dropped.

Everything runs on stdlib toy crypto, fake clocks and task-mode fleets.
PyTorch runs on one thread; the module imports nothing of the JAX
package.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

from quantum_resistant_p2p_tpu_torch.app.resumption import STEKRing
from quantum_resistant_p2p_tpu_torch.fleet import control as fleet_control
from quantum_resistant_p2p_tpu_torch.fleet import gateway as fleet_gateway
from quantum_resistant_p2p_tpu_torch.fleet.lease import DEMOTED, FOLLOWER, LEADER, LeaderLease
from quantum_resistant_p2p_tpu_torch.fleet.manager import GatewayFleet
from quantum_resistant_p2p_tpu_torch.obs import flight as obs_flight


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def run():
    loop = asyncio.new_event_loop()
    yield lambda coro: loop.run_until_complete(asyncio.wait_for(coro, 60.0))
    loop.run_until_complete(loop.shutdown_asyncgens())
    loop.close()


@pytest.fixture
def recorder(monkeypatch):
    rec = obs_flight.FlightRecorder()
    monkeypatch.setattr(obs_flight, "RECORDER", rec)
    return rec


def _kinds(rec):
    return [ev["kind"] for ev in rec.snapshot()]


# -- lease state machine: seeded determinism (mirrors) ------------------------


def _scripted_failover():
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    rt0 = LeaderLease("rt0", 0, ttl_s=1.0, claim_stagger_s=0.25, clock=clock)
    rt1 = LeaderLease("rt1", 1, ttl_s=1.0, claim_stagger_s=0.25, clock=clock)
    assert not rt0.claim_due() and not rt1.claim_due()
    now[0] = 1.0
    assert rt0.claim_due() and not rt1.claim_due()
    body = rt0.claim()
    assert body["epoch"] == 1 and rt0.is_leader
    assert rt1.observe(body["holder"], body["epoch"], body["ttl_s"])
    now[0] = 1.5
    assert rt0.renew_due()
    body = rt0.renew()
    assert rt1.observe(body["holder"], body["epoch"], body["ttl_s"])
    now[0] = 2.6
    assert not rt1.claim_due()
    now[0] = 2.8
    assert rt1.claim_due()
    body = rt1.claim()
    assert body["epoch"] == 2 and rt1.is_leader
    rt0b = LeaderLease("rt0", 0, ttl_s=1.0, claim_stagger_s=0.25, clock=clock)
    assert not rt0b.claim_due()
    assert rt0b.observe(body["holder"], body["epoch"], body["ttl_s"])
    assert rt0b.role == FOLLOWER and rt0b.holder == "rt1"
    return rt0.transitions + rt0b.transitions, rt1.transitions


def test_lease_failover_is_deterministic_on_injected_clocks():
    a0, a1 = _scripted_failover()
    b0, b1 = _scripted_failover()
    assert repr(a0) == repr(b0)
    assert repr(a1) == repr(b1)
    assert [t[1:3] for t in a1] == [(FOLLOWER, LEADER)]
    assert a1[0][3] == 2


def test_tied_claim_race_converges_without_arbiter():
    now = [10.0]
    a = LeaderLease("rt0", 0, ttl_s=1.0, clock=lambda: now[0])
    b = LeaderLease("rt1", 0, ttl_s=1.0, clock=lambda: now[0])
    assert a.claim()["epoch"] == 1
    assert b.claim()["epoch"] == 1
    assert a.observe("rt1", 1, 1.0) is False
    assert a.is_leader and a.stale_rejects == 1
    assert b.observe("rt0", 1, 1.0) is True
    assert b.role == DEMOTED
    assert any(reason == "superseded_by=rt0" for *_ignored, reason in b.transitions)


def test_demotion_is_sticky_until_rejoin():
    now = [0.0]
    lease = LeaderLease("rt0", 0, ttl_s=1.0, clock=lambda: now[0])
    now[0] = 1.0
    lease.claim()
    assert lease.observe_reject(7) is True
    assert lease.role == DEMOTED and lease.max_seen_epoch == 7
    now[0] = 100.0
    assert not lease.claim_due()
    assert any(reason == "fenced_by_peer" for *_ignored, reason in lease.transitions)
    lease.rejoin()
    assert lease.role == FOLLOWER
    assert lease.claim_due()


# -- stale-lease fencing over the control link (mirrors) ----------------------


class _CaptureWriter:
    def __init__(self):
        self.buf = b""
        self.closed = False

    def write(self, data):
        self.buf += data

    async def drain(self):
        pass

    def close(self):
        self.closed = True


async def _decode_frames(buf: bytes) -> list[dict]:
    reader = asyncio.StreamReader()
    reader.feed_data(buf)
    reader.feed_eof()
    frames = []
    while True:
        try:
            frames.append(await fleet_control.read_ctrl(reader))
        except asyncio.IncompleteReadError:
            return frames


def _replica(router_id: str, rank: int, peers=None) -> GatewayFleet:
    return GatewayFleet(0, attach=True, spawn="task", providers="stdlib", router_id=router_id,
                        router_rank=rank, router_peers=list(peers or []), lease_ttl_s=1.0,
                        lease_stagger_s=0.25)


def test_stale_authority_frames_are_fenced_and_flight_recorded(run, recorder):
    fleet = _replica("rtA", 0)
    assert fleet.lease.observe("rtB", 5, 60.0)
    w = _CaptureWriter()
    run(fleet._on_rt_lease({"type": fleet_control.RT_LEASE, "holder": "rtC", "epoch": 3,
                            "ttl_s": 1.0}, w))
    (reject,) = run(_decode_frames(w.buf))
    assert reject == {"type": fleet_control.RT_REJECT, "router": "rtA", "epoch": 5}
    assert fleet.lease_fenced == 1
    assert "stale_lease_fenced" in _kinds(recorder)

    ring_before = fleet.ticket_keys.export()
    w2 = _CaptureWriter()
    run(fleet._on_rt_sync({"type": fleet_control.RT_SYNC, "holder": "rtC", "epoch": 2,
                           "keys": [["eeee", "00" * 32]], "rotations": 9, "members": ["gwZ"]},
                          w2))
    (reject2,) = run(_decode_frames(w2.buf))
    assert reject2["type"] == fleet_control.RT_REJECT
    assert reject2["epoch"] == 5
    assert fleet.ticket_keys.export() == ring_before
    assert "gwZ" not in fleet.members
    assert fleet.lease_fenced == 2
    assert "stale_sync_fenced" in _kinds(recorder)


def test_stale_leader_demotes_on_reject_reply(run, recorder):
    async def scenario():
        peer = _replica("rtB", 1)
        await peer.start()
        try:
            assert peer.lease.observe("rtX", 5, 60.0)
            stale = _replica("rtA", 0, peers=[{"router": "rtB", "host": "127.0.0.1",
                                               "port": peer.ctrl_port}])
            body = stale.lease.claim()
            assert body["epoch"] == 1 and stale.lease.is_leader
            await stale._announce_lease(body, sync=False)
            assert stale.lease.role == DEMOTED
            assert stale.lease_rejects >= 1
            assert peer.lease_fenced >= 1
            kinds = _kinds(obs_flight.RECORDER)
            assert "router_demoted" in kinds
            assert "stale_lease_fenced" in kinds
        finally:
            await peer.stop()

    run(scenario())


# -- STEK replication: the accept window survives failover (mirror) -----------


def _import_export(ring_export):
    return [(ep, bytes.fromhex(key_hex)) for ep, key_hex in ring_export]


def test_ticket_minted_under_dead_leader_redeems_after_failover():
    leader = STEKRing()
    follower = STEKRing()
    assert follower.install(_import_export(leader.export()), guard=True)
    secret = bytes(range(32))
    ticket = leader.seal_ticket({"sid": "s1", "secret": secret.hex()})
    pre_rotation = leader.export()
    leader.rotate()
    assert follower.install(_import_export(leader.export()), guard=True)
    fields, stek = follower.open_ticket(ticket)
    assert fields == {"sid": "s1"} and stek == secret
    fields2, _stek2 = follower.open_ticket(
        follower.seal_ticket({"sid": "s2", "secret": secret.hex()}))
    assert fields2 == {"sid": "s2"}
    assert follower.install(_import_export(pre_rotation), guard=True) is False
    fields3, _stek3 = follower.open_ticket(ticket)
    assert fields3 == {"sid": "s1"}


# -- conn_gen supersede (mirror) ----------------------------------------------


def test_second_hello_supersedes_stale_control_connection(run):
    async def gw_conn(port, hello):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        await fleet_control.send_ctrl(writer, hello)
        push = await fleet_control.read_ctrl(reader)
        assert push["type"] == fleet_control.GW_TICKET_KEYS
        return reader, writer

    async def scenario():
        fleet = GatewayFleet(0, attach=True, spawn="task", providers="stdlib",
                             hb_interval=0.5)
        await fleet.start()
        try:
            hello = {"type": fleet_control.GW_HELLO, "gateway": "gwX", "p2p_port": 41001,
                     "pid": 1}
            r1, w1 = await gw_conn(fleet.ctrl_port, hello)
            member = fleet.members["gwX"]
            assert member.conn_gen == 1 and member.port == 41001
            live_writer = member.writer
            _r2, w2 = await gw_conn(fleet.ctrl_port, dict(hello, p2p_port=41002, pid=2))
            assert member.conn_gen == 2
            assert member.port == 41002
            assert member.writer is not live_writer
            assert await r1.read() == b""
            w1.close()
            await asyncio.sleep(0.1)
            assert member.port == 41002
            assert member.writer is not None
            assert member.registered
            hb_count = member.hb_count
            await fleet_control.send_ctrl(w2, {"type": fleet_control.GW_HEARTBEAT,
                                               "gateway": "gwX", "stats": {"connections": 0}})
            for _ in range(40):
                if member.hb_count > hb_count:
                    break
                await asyncio.sleep(0.02)
            assert member.hb_count == hb_count + 1
            assert member.breaker.state == "closed"
            w2.close()
        finally:
            await fleet.stop()

    run(scenario())


# -- the gateway's half of the fencing ----------------------------------------


class _Tickets:
    def __init__(self):
        self.installed = []

    def install(self, keys, guard=False):
        self.installed.append(keys)
        return True


class _Engine:
    def __init__(self):
        self.tickets = _Tickets()


def test_gateway_drops_authority_frames_below_its_honored_epoch(run, recorder):
    """A STEK push or drain below the lease epoch the gateway honors comes
    from a router that lost the lease: dropped, counted and flight-recorded,
    never installed; a fresh one is honored and raises the epoch."""
    engine, sent = _Engine(), []

    async def send(frame):
        sent.append(frame)

    state = {"lease_epoch": 0, "stale_authority_rejects": 0, "drain_reason": None}
    key = "11" * 32
    dispatch = fleet_gateway._dispatch
    assert run(dispatch({"type": fleet_control.GW_TICKET_KEYS, "lease_epoch": 4,
                         "keys": [["e4", key]]}, send, engine, "gw0", state)) == "ok"
    assert state["lease_epoch"] == 4 and engine.tickets.installed == [
        [("e4", bytes.fromhex(key))]]
    assert run(dispatch({"type": fleet_control.GW_TICKET_KEYS, "lease_epoch": 3,
                         "keys": [["e3", key]]}, send, engine, "gw0", state)) == "ok"
    assert run(dispatch({"type": fleet_control.GW_DRAIN, "lease_epoch": 2}, send, engine,
                        "gw0", state)) == "ok"
    assert len(engine.tickets.installed) == 1 and state["stale_authority_rejects"] == 2
    assert _kinds(recorder).count("stale_authority_rejected") == 2
    assert run(dispatch({"type": fleet_control.GW_PROBE, "n": 7}, send, engine, "gw0",
                        state)) == "ok"
    assert sent == [{"type": fleet_control.GW_PROBE_OK, "gateway": "gw0", "n": 7}]
    assert run(dispatch({"type": fleet_control.GW_DRAIN, "lease_epoch": 5}, send, engine,
                        "gw0", state)) == "drain"
    assert (state["lease_epoch"], state["drain_reason"]) == (5, "router")
    assert run(dispatch({"type": fleet_control.GW_STOP}, send, engine, "gw0", state)) == "stop"
