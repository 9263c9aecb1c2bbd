"""The port's protocol engine (quantum_resistant_p2p_tpu_torch.app.messaging)
against the JAX package's ``app/messaging.py``, on the CPU.

* The free parts (``derive_message_key``, ``_canonical``, the constants,
  ``RejectReason``, ``KeyExchangeState``) are byte-equal over seeded inputs.
* A port engine ("cpu" providers, batching and fusing on) and a reference
  engine ("cpu", unbatched) complete ML-KEM-768 + ML-DSA-65 handshakes with
  each other in both directions, over ``bin1`` and over JSON: the keys
  agree, messages arrive both ways under AES-256-GCM and then, after both
  sides swap, under ChaCha20-Poly1305 (the port on its batched AEAD), a
  ticket minted by one side resumes on the other, and ``algorithm_mismatch``
  comes back typed either way.  The bytes on the wire are the same whether
  or not the port fuses (the reference's "cpu" engine never does).  With
  HQC-128 as the KEM (no fused pair) the port side handshakes through its
  BatchedKEM, against the reference both ways, and two port engines
  hot-swap to it.
* Mirrors of the reference's engine tests that need no JAX program:
  ``tests/test_messaging_e2e.py`` (real providers, the port's ``KeyStorage``
  as the vault and its ``SecureLogger`` as the audit log; one case over the
  reference's vault, so the engine's use of a vault stays interoperable),
  the fault and healing cases of
  ``tests/test_faults.py`` and the resumption and drain cases of
  ``tests/test_resumption.py`` (stdlib toy algorithms on the port's
  interfaces, as the reference's own fault tests use, so their timeouts
  stay short).
* A default engine runs on "cuda": without a GPU it raises.

Tolerance: exact.  The reference side runs its "cpu" backend, which
compiles no JAX program (ROADMAP C1); the module still clears JAX's caches
at its end, as the other port modules do.  PyTorch runs on one thread.
Every socket wait sits under an 8 s ``asyncio.wait_for``.
"""

from __future__ import annotations

import asyncio
import gc
import hashlib
import hmac
import json
import os
import time
import uuid

import jax
import numpy as np
import pytest
import torch

from quantum_resistant_p2p_tpu.app import messaging as ref_msg
from quantum_resistant_p2p_tpu.net import p2p_node as ref_net
from quantum_resistant_p2p_tpu_torch import faults
from quantum_resistant_p2p_tpu_torch.app import Message, MessageStore
from quantum_resistant_p2p_tpu_torch.app import messaging as msg
from quantum_resistant_p2p_tpu_torch.app.resumption import STEKRing, mint_fields
from quantum_resistant_p2p_tpu_torch.net import p2p_node as net
from quantum_resistant_p2p_tpu_torch.provider import get_symmetric
from quantum_resistant_p2p_tpu_torch.provider.base import (KeyExchangeAlgorithm,
                                                           SignatureAlgorithm,
                                                           SymmetricAlgorithm)

#: the longest one socket wait may take
WAIT_S = 8.0


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


def _run(coro, timeout: float = 120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _until(cond, what: str, timeout: float = WAIT_S) -> None:
    async def poll():
        while not cond():
            await asyncio.sleep(0.01)

    try:
        await asyncio.wait_for(poll(), timeout)
    except asyncio.TimeoutError:
        raise AssertionError(f"timed out waiting for {what}") from None


async def _connect(a_node, b_node) -> None:
    got = await asyncio.wait_for(a_node.connect_to_peer("127.0.0.1", b_node.port), WAIT_S)
    assert got == b_node.node_id
    await _until(lambda: b_node.is_connected(a_node.node_id), "the inbound registration")


def _inbox(engine) -> list:
    box = []
    engine.register_message_listener(lambda peer, m: None if m.is_system else box.append(m))
    return box


# -- the free parts -------------------------------------------------------------


def test_constants_and_enums_match():
    names = ("REPLAY_WINDOW", "KEY_EXCHANGE_TIMEOUT", "DEDUP_CAPACITY", "KE_RETRY_ATTEMPTS",
             "KE_RETRY_BACKOFF_S", "HEAL_ATTEMPTS", "HEAL_BACKOFF_S", "OUTBOX_CAPACITY",
             "REKEY_AFTER_AEAD_FAILURES", "REKEY_COOLDOWN_S", "HAD_SESSION_TTL_S",
             "HAD_SESSION_CAP", "WARMUP_SIZES", "HANDSHAKE_SLO_THRESHOLD_S",
             "RESUME_TICKET_TTL_S", "TICKET_CAP")
    assert [getattr(msg, n) for n in names] == [getattr(ref_msg, n) for n in names]
    assert {r.name: r.value for r in msg.RejectReason} == {
        r.name: r.value for r in ref_msg.RejectReason}
    assert {s.name: s.value for s in msg.KeyExchangeState} == {
        s.name: s.value for s in ref_msg.KeyExchangeState}
    e = msg.KeyExchangeFailed("server_busy")
    assert (e.reason, str(e)) == (ref_msg.KeyExchangeFailed("server_busy").reason,
                                  str(ref_msg.KeyExchangeFailed("server_busy")))


@pytest.mark.parametrize("seed", [70, 71, 72])
def test_derive_message_key_and_canonical_are_byte_equal(seed):
    """Inputs: secrets, ids, AEAD names and transcripts from seed; exact."""
    rng = np.random.default_rng(seed)
    for _ in range(16):
        secret = bytes(rng.integers(0, 256, int(rng.integers(16, 64)), dtype=np.uint8))
        ida, idb = str(uuid.UUID(bytes=bytes(rng.integers(0, 256, 16, dtype=np.uint8)))), "bob"
        aead = ("AES-256-GCM", "ChaCha20-Poly1305")[int(rng.integers(0, 2))]
        assert msg.derive_message_key(secret, ida, idb, aead) == ref_msg.derive_message_key(
            secret, ida, idb, aead)
        assert msg.derive_message_key(secret, idb, ida, aead) == msg.derive_message_key(
            secret, ida, idb, aead)
        data = {"message_id": ida, "sender": idb, "timestamp": float(rng.random()) * 2e9,
                "public_key": secret.hex(), "n": int(rng.integers(-9, 9)), "é": [True, None]}
        assert msg._canonical(data) == ref_msg._canonical(data)


def test_wipe_zeroes_in_place_and_skips_none():
    buf = bytearray(b"secret")
    msg._wipe(buf)
    msg._wipe(None)
    assert buf == bytearray(6)


def test_default_engine_runs_on_cuda_and_raises_without_a_gpu():
    """The entry point's default backend is "cuda"; the CPU is used only
    when asked for.  ``mesh_devices`` splits "cuda" batches only: on "cpu"
    the providers run each batch whole, and without a GPU a meshed default
    engine raises."""
    import inspect

    assert inspect.signature(msg.SecureMessaging).parameters["backend"].default == "cuda"
    node = net.P2PNode("gpu-default", "127.0.0.1", 0)
    if not torch.cuda.is_available():
        for kw in ({}, {"mesh_devices": 2}):
            with pytest.raises(RuntimeError, match="cuda"):
                msg.SecureMessaging(node, **kw)
    e = msg.SecureMessaging(node, backend="cpu", mesh_devices=2)
    try:
        assert e.mesh_devices == 2 and e.kem._mesh is None and e.signature._mesh is None
    finally:
        e.close()


def _device_toy_engine(monkeypatch, name: str, **kw):
    """A batching engine over the toy algorithms claiming the "cuda"
    backend, their "cpu" twins served by the patched registry."""
    twins = {"PT-TOY-KEM": ToyKEM, "PT-TOY-SIG": ToySig}
    monkeypatch.setattr(msg, "get_kem", lambda algo, backend: twins[algo](backend))
    monkeypatch.setattr(msg, "get_signature", lambda algo, backend: twins[algo](backend))
    return msg.SecureMessaging(net.P2PNode(name, "127.0.0.1", 0), kem=ToyKEM("cuda"),
                               signature=ToySig("cuda"), symmetric=ToyAEAD(), backend="cpu",
                               use_batching=True, **kw)


@pytest.mark.parametrize("degrade", [False, True])
def test_device_queues_arm_a_cpu_fallback_only_when_asked(monkeypatch, degrade):
    """A device engine's batching queues get the "cpu" twins as fallbacks
    only with ``degrade=True`` (the reference always arms them); by default
    no queue can serve an op from the CPU."""
    from quantum_resistant_p2p_tpu_torch.provider import facade_queues

    monkeypatch.setattr(msg.SecureMessaging, "_spawn_warmup", lambda self, **k: None)
    e = _device_toy_engine(monkeypatch, "device-toys", degrade=degrade)
    try:
        queues = [q for f in (e._bkem, e._bsig) for q in facade_queues(f)]
        assert len(queues) == 5
        assert [q.fallback_fn is not None for q in queues] == [degrade] * 5
        twins = (e._bkem.fallback, e._bsig.fallback)
        assert [getattr(t, "backend", None) for t in twins] == (
            ["cpu", "cpu"] if degrade else [None, None])
    finally:
        e.close()


@pytest.mark.parametrize("where", ["gate", "warmup"])
def test_a_failed_gate_or_warmup_raises_from_wait_ready(monkeypatch, where):
    """Without ``degrade`` a failed health verdict or warm-up quarantines
    nothing: ``wait_ready`` raises it and ``/readyz`` stays not ready."""
    from quantum_resistant_p2p_tpu_torch.provider import batched, health

    def fail(*args, **kwargs):
        raise RuntimeError(f"device {where} failed")

    monkeypatch.setattr(health, "gate_facades", fail if where == "gate" else lambda *a, **k: [])
    if where == "warmup":
        monkeypatch.setattr(batched.BatchedKEM, "warmup", fail)

    async def main():
        e = _device_toy_engine(monkeypatch, f"failed-{where}")
        try:
            with pytest.raises(RuntimeError, match=f"device {where} failed"):
                await e.wait_ready(WAIT_S)
            doc = e.ready_status()
            assert (doc["ready"], doc["warm"], doc["degraded"]) == (False, True, [])
            assert f"device {where} failed" in doc["warmup_error"]
            assert [s.breaker.state for s in e._scheduler.shards] == ["closed"]
        finally:
            e.close()

    _run(main())


# -- stacks ---------------------------------------------------------------------


def _port_engine(node, **kw):
    kw.setdefault("backend", "cpu")
    return msg.SecureMessaging(node, **kw)


def _ref_engine(node, **kw):
    return ref_msg.SecureMessaging(node, backend="cpu", **kw)


async def _mixed_pair(initiator: str, binary: bool, symmetric: str):
    """(initiator engine, responder engine): one side the port's (batched,
    fused, "cpu"), the other the reference's ("cpu", unbatched); the
    initiator dials."""
    nodes = {"port": net.P2PNode("port-eng", "127.0.0.1", 0, binary_wire=binary),
             "ref": ref_net.P2PNode(node_id="ref-eng", host="127.0.0.1", port=0,
                                    binary_wire=binary)}
    for n in nodes.values():
        await n.start()
    engines = {
        "port": _port_engine(nodes["port"], use_batching=True, max_batch=64,
                             symmetric=get_symmetric(symmetric)),
        "ref": _ref_engine(nodes["ref"],
                           symmetric=ref_msg.get_symmetric(symmetric)),
    }
    await engines["port"].wait_ready()
    responder = "ref" if initiator == "port" else "port"
    await _connect(nodes[initiator], nodes[responder])
    return engines[initiator], engines[responder]


async def _stop(*engines):
    for e in engines:
        await e.node.stop()
        if isinstance(e, msg.SecureMessaging):
            e.close()


async def _exchange(a, b, tag: bytes) -> None:
    """One message each way; each arrives once, as sent."""
    got_a, got_b = _inbox(a), _inbox(b)
    assert await asyncio.wait_for(a.send_message(b.node_id, tag + b" a->b"), WAIT_S)
    assert await asyncio.wait_for(b.send_message(a.node_id, tag + b" b->a"), WAIT_S)
    await _until(lambda: got_a and got_b, f"{tag!r} both ways")
    assert [m.content for m in got_b] == [tag + b" a->b"]
    assert [m.content for m in got_a] == [tag + b" b->a"]
    assert got_b[0].sender_id == a.node_id and got_a[0].sender_id == b.node_id


# -- interop: port engine <-> reference engine -----------------------------------


@pytest.mark.parametrize("binary", [True, False], ids=["bin1", "json"])
@pytest.mark.parametrize("initiator", ["port", "ref"])
def test_port_and_reference_engines_interoperate(initiator, binary):
    """Real ML-KEM-768 + ML-DSA-65: a full handshake (the port side fused),
    messages both ways under AES-256-GCM, a ticket resume across the
    packages, then both sides swap to ChaCha20-Poly1305 and talk again."""

    async def main():
        a, b = await _mixed_pair(initiator, binary, "AES-256-GCM")
        port = a if initiator == "port" else b
        wire = "bin1" if binary else "json"
        assert a.node.peer_wire_format(b.node_id) == wire
        assert await asyncio.wait_for(a.initiate_key_exchange(b.node_id), 60)
        await _until(lambda: b.verify_key_exchange_state(a.node_id), "the responder's confirm")
        assert a.shared_keys[b.node_id] == b.shared_keys[a.node_id]
        assert bytes(a.raw_secrets[b.node_id]) == bytes(b.raw_secrets[a.node_id])
        fused = port._bfused.stats()
        steps = (("keygen_sign", "decaps_verify_sign") if port is a
                 else ("encaps_verify_sign",))
        assert all(fused[s]["ops"] == 1 for s in steps)
        assert port._bkem.stats()["keygen"]["ops"] == 0
        await _exchange(a, b, b"aes")

        # the responder minted a ticket; it resumes on a fresh connection
        assert a.ticket_for(b.node_id) is not None
        await a.node.disconnect_from_peer(b.node_id, intentional=True)
        await asyncio.sleep(0.05)
        await _connect(a.node, b.node)
        assert await asyncio.wait_for(a.initiate_key_exchange(b.node_id), 30)
        assert a._ctr_resumes_used.value == 1 and b._ctr_resumes_ok.value == 1
        await _until(lambda: b.shared_keys.get(a.node_id) == a.shared_keys[b.node_id],
                     "the resumed key")
        await _exchange(a, b, b"resumed")

        for e in (a, b):
            await e.set_symmetric_algorithm("ChaCha20-Poly1305")
        assert port._baead is not None
        assert a.shared_keys[b.node_id] == b.shared_keys[a.node_id]
        await _exchange(a, b, b"chacha")
        assert port._baead.stats()["seal"]["ops"] == 1
        assert port._baead.stats()["open"]["ops"] == 1
        await port.wait_ready()
        await _stop(a, b)

    _run(main())


@pytest.mark.parametrize("initiator", ["port", "ref"])
def test_algorithm_mismatch_is_typed_both_ways(initiator):
    """An initiator on ML-KEM-512 against a responder on ML-KEM-768: the
    responder refuses with a typed ``algorithm_mismatch``, whichever
    package is on which side (the gossip pre-check is bypassed so the
    refusal comes over the wire)."""

    async def main():
        nodes = {"port": net.P2PNode("port-eng", "127.0.0.1", 0),
                 "ref": ref_net.P2PNode(node_id="ref-eng", host="127.0.0.1", port=0)}
        for n in nodes.values():
            await n.start()
        kem = {initiator: "ML-KEM-512"}
        engines = {
            "port": _port_engine(nodes["port"], use_batching=True, max_batch=64,
                                 kem=msg.get_kem(kem.get("port", "ML-KEM-768"), "cpu")),
            "ref": _ref_engine(nodes["ref"],
                               kem=ref_msg.get_kem(kem.get("ref", "ML-KEM-768"), "cpu"))}
        await engines["port"].wait_ready()
        responder = "ref" if initiator == "port" else "port"
        a, b = engines[initiator], engines[responder]
        # no gossip reaches the initiator, so its pre-check cannot refuse
        a.node.unregister_message_handler("settings_update", a._handle_settings_update)
        await _connect(a.node, b.node)
        status = await asyncio.wait_for(a._initiate_once(b.node_id), 30)
        assert status == msg.RejectReason.ALGORITHM_MISMATCH.value == "algorithm_mismatch"
        assert a.ke_state[b.node_id].value == "none"
        assert b.node_id not in a.shared_keys and a.node_id not in b.shared_keys
        await _stop(a, b)

    _run(main())


@pytest.mark.parametrize("binary", [True, False], ids=["bin1", "json"])
@pytest.mark.parametrize("initiator", ["port", "ref"])
def test_hqc_engines_interoperate(initiator, binary):
    """HQC-128 as the KEM (with ML-DSA-65): no fused capability exists for
    the pair, so the port side's handshake runs unfused through its
    BatchedKEM; the keys agree with the reference engine's and messages
    arrive both ways."""

    async def main():
        nodes = {"port": net.P2PNode("port-eng", "127.0.0.1", 0, binary_wire=binary),
                 "ref": ref_net.P2PNode(node_id="ref-eng", host="127.0.0.1", port=0,
                                        binary_wire=binary)}
        for n in nodes.values():
            await n.start()
        engines = {
            "port": _port_engine(nodes["port"], use_batching=True, max_batch=64,
                                 kem=msg.get_kem("HQC-128", "cpu")),
            "ref": _ref_engine(nodes["ref"], kem=ref_msg.get_kem("HQC-128", "cpu"))}
        port = engines["port"]
        await port.wait_ready()
        assert port._bfused is None and port._bkem is not None
        responder = "ref" if initiator == "port" else "port"
        a, b = engines[initiator], engines[responder]
        await _connect(a.node, b.node)
        assert a.node.peer_wire_format(b.node_id) == ("bin1" if binary else "json")
        assert await asyncio.wait_for(a.initiate_key_exchange(b.node_id), 60)
        await _until(lambda: b.verify_key_exchange_state(a.node_id), "the responder's confirm")
        assert a.shared_keys[b.node_id] == b.shared_keys[a.node_id]
        assert len(a.raw_secrets[b.node_id]) == 64
        kem_ops = port._bkem.stats()
        steps = ("keygen", "decaps") if port is a else ("encaps",)
        assert all(kem_ops[s]["ops"] == 1 for s in steps)
        await _exchange(a, b, b"hqc")
        await _stop(a, b)

    _run(main())


# -- mirrors of tests/test_messaging_e2e.py --------------------------------------


class Stack:
    """A node stack minus UI: the port's vault (or, with ``vault="reference"``,
    the reference's), the port's audit log, transport and protocol engine."""

    def __init__(self, name: str, tmp_path, vault: str = "port", **sm_kwargs):
        from quantum_resistant_p2p_tpu.storage import KeyStorage as RefKeyStorage
        from quantum_resistant_p2p_tpu_torch.storage import KeyStorage, SecureLogger

        vault_cls = {"port": KeyStorage, "reference": RefKeyStorage}[vault]
        self.storage = vault_cls(tmp_path / f"{name}.vault.json")
        assert self.storage.unlock("test_password")
        self.logger = SecureLogger(self.storage.get_or_create_purpose_key("secure_logger"),
                                   tmp_path / f"{name}.logs")
        self.node = net.P2PNode(name, "127.0.0.1", 0)
        self.messaging = None
        self.inbox: list[tuple[str, Message]] = []
        self.got_message = asyncio.Event()
        self._sm_kwargs = sm_kwargs

    async def start(self):
        await self.node.start()
        self.messaging = _port_engine(self.node, key_storage=self.storage,
                                      secure_logger=self.logger, **self._sm_kwargs)
        self.messaging.register_message_listener(self._on_msg)

    def _on_msg(self, peer_id, message):
        self.inbox.append((peer_id, message))
        self.got_message.set()

    async def stop(self):
        await self.node.stop()
        self.messaging.close()


async def _connected_pair(tmp_path, **kw):
    a, b = Stack("alice", tmp_path, **kw), Stack("bob", tmp_path, **kw)
    await a.start()
    await b.start()
    await _connect(a.node, b.node)
    return a, b


@pytest.mark.parametrize("vault", ["port", "reference"])
def test_handshake_and_messaging(tmp_path, vault):
    async def main():
        a, b = await _connected_pair(tmp_path, vault=vault)
        assert await a.messaging.initiate_key_exchange("bob")
        assert a.messaging.verify_key_exchange_state("bob")
        await _until(lambda: b.messaging.verify_key_exchange_state("alice"), "bob's confirm")
        assert a.messaging.shared_keys["bob"] == b.messaging.shared_keys["alice"]
        assert await a.messaging.send_message("bob", b"hello post-quantum world") is not None
        await _until(lambda: [m for m in b.inbox if not m[1].is_system], "the message")
        peers = [m for m in b.inbox if not m[1].is_system]
        assert peers[-1][0] == "alice" and peers[-1][1].content == b"hello post-quantum world"
        a.got_message.clear()
        assert await b.messaging.send_message("alice", b"ack") is not None
        await asyncio.wait_for(a.got_message.wait(), WAIT_S)
        await _until(lambda: any(m.content == b"ack" for _, m in a.inbox), "the ack")
        # shared-key history was persisted on both sides
        assert a.storage.list_key_history("bob")
        assert b.storage.list_key_history("alice")
        # and the handshakes and messages went to the encrypted audit logs
        for stack, role in ((a, "initiator"), (b, "responder")):
            exchanges = stack.logger.get_events(event_type="key_exchange")
            assert [e["role"] for e in exchanges if e["success"]] == [role]
        assert a.logger.get_security_metrics()["messages_sent"] == 1
        await a.stop()
        await b.stop()

    _run(main())


def test_file_transfer(tmp_path):
    async def main():
        a, b = await _connected_pair(tmp_path)
        assert await a.messaging.initiate_key_exchange("bob")
        payload = bytes(range(256)) * 512  # 128 KiB -> exercises chunking
        f = tmp_path / "blob.bin"
        f.write_bytes(payload)
        assert await a.messaging.send_file("bob", f) is not None
        await _until(lambda: any(m.is_file for _, m in b.inbox), "the file")
        files = [m for _, m in b.inbox if m.is_file]
        assert files[0].content == payload and files[0].filename == "blob.bin"
        await a.stop()
        await b.stop()

    _run(main())


def test_tampered_ciphertext_rejected(tmp_path):
    async def main():
        a, b = await _connected_pair(tmp_path)
        assert await a.messaging.initiate_key_exchange("bob")
        key_count = len([m for m in b.inbox if not m[1].is_system])
        await a.node.send_message("bob", "secure_message", ct=b"\x00" * 64, ad=b"{}")
        await asyncio.sleep(0.2)
        assert len([m for m in b.inbox if not m[1].is_system]) == key_count
        await a.stop()
        await b.stop()

    _run(main())


def test_settings_gossip_and_mismatch_block(tmp_path):
    async def main():
        a, b = await _connected_pair(tmp_path)
        await _until(lambda: a.messaging.peer_settings.get("bob"), "the gossip")
        assert a.messaging.settings_match("bob") is True
        await b.messaging.set_symmetric_algorithm("ChaCha20-Poly1305")
        await _until(lambda: a.messaging.peer_settings.get("bob", {}).get("aead")
                     == "ChaCha20-Poly1305", "the changed gossip")
        assert a.messaging.settings_match("bob") is False
        assert await a.messaging.adopt_peer_settings("bob")
        assert a.messaging.settings_match("bob") is True
        assert await a.messaging.initiate_key_exchange("bob")
        assert await a.messaging.send_message("bob", b"after swap") is not None
        await a.stop()
        await b.stop()

    _run(main())


def test_hot_swap_to_hqc_rehandshakes_unfused(tmp_path):
    """Both batched engines swap from the fused ML-KEM-768 pair to HQC-128:
    the fused facade goes, the re-handshake runs keygen, encaps and decaps
    through the fresh BatchedKEM queues, and messages flow under the new
    64-byte secret's key."""

    async def main():
        kw = dict(use_batching=True, max_batch=64, max_wait_ms=2.0)
        a, b = await _connected_pair(tmp_path, **kw)
        await a.messaging.wait_ready()
        await b.messaging.wait_ready()
        assert await a.messaging.initiate_key_exchange("bob")
        await b.messaging.set_key_exchange_algorithm("HQC-128")
        await _until(lambda: a.messaging.peer_settings.get("bob", {}).get("kem") == "HQC-128",
                     "the gateway's new settings")
        await a.messaging.set_key_exchange_algorithm("HQC-128")
        assert a.messaging._bfused is None and b.messaging._bfused is None
        await _until(lambda: a.messaging.verify_key_exchange_state("bob")
                     and b.messaging.verify_key_exchange_state("alice")
                     and a.messaging.shared_keys["bob"] == b.messaging.shared_keys["alice"],
                     "the HQC re-handshake", timeout=60)
        assert len(a.messaging.raw_secrets["bob"]) == 64
        ops = {op: q._bkem.stats()[op]["ops"] for q, op in
               ((a.messaging, "keygen"), (b.messaging, "encaps"), (a.messaging, "decaps"))}
        assert min(ops.values()) >= 1, ops
        assert await a.messaging.send_message("bob", b"after the hqc swap") is not None
        await _until(lambda: any(m.content == b"after the hqc swap" for _, m in b.inbox),
                     "the message under the HQC key")
        await a.stop()
        await b.stop()

    _run(main())


def test_message_store():
    store = MessageStore()
    m = Message(content=b"x", sender_id="a", recipient_id="b")
    store.add_message("a", m, unread=True)
    assert store.get_unread_count("a") == 1
    store.mark_read("a")
    assert store.get_unread_count("a") == 0
    assert store.get_messages("a")[0].content == b"x"
    assert Message.from_dict(m.to_dict()).content == b"x"


def test_handshake_with_batched_cpu_provider(tmp_path):
    """The batched path on the port's "cpu" providers: ML-KEM-768 x
    ML-DSA-65 fuses there too (ROADMAP C3), so the handshake rides the
    composite queues in at most 4 trips on the initiator's scheduler."""

    async def main():
        kw = dict(use_batching=True, max_batch=64, max_wait_ms=2.0)
        a, b = await _connected_pair(tmp_path, **kw)
        assert a.messaging._bkem is not None
        await a.messaging.wait_ready()
        await b.messaging.wait_ready()
        assert a.messaging.ready_status()["ready"]
        assert await a.messaging.initiate_key_exchange("bob")
        assert a.messaging.shared_keys["bob"] == b.messaging.shared_keys["alice"]
        assert await a.messaging.send_message("bob", b"batched hello") is not None
        await _until(lambda: any(m.content == b"batched hello" for _, m in b.inbox),
                     "the batched message")
        assert a.messaging._bfused is not None
        fa, fb = a.messaging._bfused.stats(), b.messaging._bfused.stats()
        assert fa["keygen_sign"]["ops"] >= 1
        assert fa["decaps_verify_sign"]["ops"] >= 1
        assert fb["encaps_verify_sign"]["ops"] >= 1
        assert a.messaging._bkem.stats()["keygen"]["ops"] == 0
        assert a.messaging._bsig.stats()["sign"]["ops"] >= 1
        trips = a.messaging.metrics()["handshake_trips"]
        assert trips["count"] == 1
        assert trips["last"] is not None and trips["last"] <= 4
        q = a.messaging.metrics()
        assert q["device_served_fraction"] == 1.0 and q["fallback_trips"] == 0
        await a.stop()
        await b.stop()

    _run(main())


# -- stdlib toy algorithms on the port's interfaces ------------------------------


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    out = b""
    ctr = 0
    while len(out) < n:
        out += hashlib.sha256(key + nonce + ctr.to_bytes(8, "big")).digest()
        ctr += 1
    return out[:n]


def _rows(items) -> np.ndarray:
    return np.stack([np.frombuffer(b, np.uint8) for b in items])


class ToyAEAD(SymmetricAlgorithm):
    name = "PT-TOY-AEAD"
    display_name = "PT-TOY-AEAD"
    key_size = 32
    nonce_size = 16

    def encrypt(self, key, plaintext, associated_data=None):
        nonce = os.urandom(self.nonce_size)
        ct = bytes(a ^ b for a, b in zip(plaintext, _keystream(key, nonce, len(plaintext))))
        tag = hmac.new(key, nonce + ct + (associated_data or b""), hashlib.sha256).digest()
        return nonce + ct + tag

    def decrypt(self, key, data, associated_data=None):
        if len(data) < self.nonce_size + 32:
            raise ValueError("ciphertext too short")
        nonce, ct, tag = data[: self.nonce_size], data[self.nonce_size:-32], data[-32:]
        want = hmac.new(key, nonce + ct + (associated_data or b""), hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise ValueError("authentication failed")
        return bytes(a ^ b for a, b in zip(ct, _keystream(key, nonce, len(ct))))


class ToyKEM(KeyExchangeAlgorithm):
    name = "PT-TOY-KEM"
    public_key_len = secret_key_len = ciphertext_len = shared_secret_len = 32

    def __init__(self, backend="cpu"):
        self.backend = backend

    def generate_keypair_batch(self, n):
        sks = [os.urandom(32) for _ in range(n)]
        return _rows(hashlib.sha256(b"pk" + sk).digest() for sk in sks), _rows(sks)

    def encapsulate_batch(self, public_keys):
        cts = [os.urandom(32) for _ in public_keys]
        return _rows(cts), _rows(hashlib.sha256(bytes(pk) + ct).digest()
                                 for pk, ct in zip(public_keys, cts))

    def decapsulate_batch(self, secret_keys, ciphertexts):
        return _rows(hashlib.sha256(hashlib.sha256(b"pk" + bytes(sk)).digest() + bytes(ct))
                     .digest() for sk, ct in zip(secret_keys, ciphertexts))


class ToySig(SignatureAlgorithm):
    name = "PT-TOY-SIG"
    public_key_len = secret_key_len = signature_len = 32

    def __init__(self, backend="cpu"):
        self.backend = backend

    def generate_keypair(self):
        sk = os.urandom(32)
        return hashlib.sha256(b"pk" + sk).digest(), sk

    def sign(self, secret_key, message):
        pk = hashlib.sha256(b"pk" + secret_key).digest()
        return hashlib.sha256(b"sig" + pk + message).digest()

    def verify(self, public_key, message, signature):
        return hmac.compare_digest(signature,
                                   hashlib.sha256(b"sig" + public_key + message).digest())


@pytest.fixture
def fast_timeout(monkeypatch):
    monkeypatch.setattr(msg, "KEY_EXCHANGE_TIMEOUT", 1.5)
    monkeypatch.setattr(msg, "KE_RETRY_BACKOFF_S", 0.05)
    monkeypatch.setattr(msg, "HEAL_BACKOFF_S", 0.05)


def _toy_engine(node, **kw):
    return msg.SecureMessaging(node, kem=ToyKEM(), symmetric=ToyAEAD(), signature=ToySig(),
                               backend="cpu", **kw)


async def _toy_pair(a_kw=None, b_kw=None, a_node_kw=None, b_node_kw=None):
    a_node = net.P2PNode("alice", "127.0.0.1", 0, **(a_node_kw or {}))
    b_node = net.P2PNode("bob", "127.0.0.1", 0, **(b_node_kw or {}))
    await a_node.start()
    await b_node.start()
    a = _toy_engine(a_node, **(a_kw or {}))
    b = _toy_engine(b_node, **(b_kw or {}))
    await _connect(a_node, b_node)
    return a, b


async def _reconnect(a, b):
    await a.node.disconnect_from_peer("bob", intentional=True)
    await asyncio.sleep(0.05)
    await _connect(a.node, b.node)


# -- mirrors of tests/test_faults.py (fault injection and healing) ---------------


@pytest.mark.parametrize("retries, ok_first", [(msg.KE_RETRY_ATTEMPTS, True), (0, False)],
                         ids=["bounded_retry", "no_retry"])
def test_dropped_response(fast_timeout, retries, ok_first):
    """One dropped ke_response: the bounded retry completes the exchange;
    with retries=0 the attempt fails closed, typed, and a later attempt
    succeeds."""

    async def main():
        a, b = await _toy_pair()
        plan = faults.FaultPlan(7, [faults.FaultRule(
            "net.send", "drop", match={"msg_type": "ke_response"}, nth=1)])
        with plan.activate():
            ok = await a.initiate_key_exchange("bob", retries=retries)
        assert ok is ok_first
        if not ok:
            assert a.ke_state["bob"] is msg.KeyExchangeState.NONE
            assert await a.initiate_key_exchange("bob", retries=0)
        assert a.verify_key_exchange_state("bob")
        assert [e["action"] for e in plan.injected] == ["drop"]
        await _stop(a, b)

    _run(main(), 30)


def test_corrupted_response_never_delivers_plaintext_then_retry_heals(fast_timeout):
    async def main():
        a, b = await _toy_pair()
        plan = faults.FaultPlan(11, [faults.FaultRule(
            "net.send", "corrupt", match={"msg_type": "ke_response"}, nth=1,
            corrupt_field="ciphertext")])
        with plan.activate():
            assert not await a.initiate_key_exchange("bob", retries=0)
            assert "bob" not in a.shared_keys or (
                a.shared_keys.get("bob") != b.shared_keys.get("alice"))
            assert await a.initiate_key_exchange("bob")
        assert a.verify_key_exchange_state("bob")
        assert a.shared_keys["bob"] == b.shared_keys["alice"]
        assert [e["action"] for e in plan.injected] == ["corrupt"]
        await _stop(a, b)

    _run(main(), 30)


def test_replayed_init_rejected(fast_timeout):
    """Replay window: a ke_init with an old timestamp is refused typed."""

    async def main():
        a, b = await _toy_pair()
        rejections = []

        async def on_reject(peer_id, m):
            rejections.append(m.get("reason"))

        a.node.register_message_handler("ke_reject", on_reject)
        pk, _ = a.kem.generate_keypair()
        stale = {"message_id": str(uuid.uuid4()), "kem": a.kem.name,
                 "aead": a.symmetric.name, "public_key": pk.hex(), "sender": "alice",
                 "recipient": "bob", "timestamp": time.time() - 3600}
        sig = a.signature.sign(a._sig_keypair[1],
                               json.dumps(stale, sort_keys=True, separators=(",", ":")).encode())
        await a.node.send_message("bob", "ke_init", ke_data=stale, sig=sig,
                                  sig_algo=a.signature.name, sig_pk=a._sig_keypair[0])
        await _until(lambda: rejections, "the rejection")
        assert rejections == ["timestamp_invalid"]
        await _stop(a, b)

    _run(main(), 30)


def test_corrupted_ciphertext_mid_session_triggers_rekey_not_plaintext(fast_timeout):
    async def main():
        a, b = await _toy_pair()
        got = _inbox(b)
        assert await a.initiate_key_exchange("bob")
        old_key = b.shared_keys["alice"]
        old_raw = b.raw_secrets["alice"]
        plan = faults.FaultPlan(23, [faults.FaultRule(
            "net.send", "corrupt", match={"msg_type": "secure_message"}, nth=1,
            corrupt_field="ct")])
        with plan.activate():
            assert await a.send_message("bob", b"poisoned in flight") is not None
            await _until(lambda: b.shared_keys.get("alice") not in (None, old_key)
                         and b.verify_key_exchange_state("alice"), "the automatic rekey")
        assert got == []
        assert old_raw == bytearray(len(old_raw))  # the dropped secret was wiped in place
        assert b.shared_keys["alice"] == a.shared_keys["bob"]
        assert b.metrics()["resilience"]["rekeys"] == 1
        assert await a.send_message("bob", b"after rekey") is not None
        await _until(lambda: got, "the message after the rekey")
        assert [m.content for m in got] == [b"after rekey"]
        assert [e["action"] for e in plan.injected] == ["corrupt"]
        await _stop(a, b)

    _run(main(), 30)


def test_disconnect_fails_closed_with_healing_disabled(fast_timeout):
    async def main():
        a, b = await _toy_pair(a_kw={"auto_heal": False}, b_kw={"auto_heal": False})
        assert await a.initiate_key_exchange("bob")
        await b.node.stop()
        await _until(lambda: not a.node.is_connected("bob"), "the disconnect")
        assert not a.verify_key_exchange_state("bob")
        assert await a.send_message("bob", b"into the void") is None
        await a.node.stop()

    _run(main(), 30)


def test_disconnect_reconnect_rehandshake_delivers_queued_messages(fast_timeout):
    async def main():
        a, b = await _toy_pair()
        got = _inbox(b)
        assert await a.initiate_key_exchange("bob")
        old_key = a.shared_keys["bob"]
        b.node._peers["alice"].writer.close()  # a network blip, not a disconnect
        await _until(lambda: not a.node.is_connected("bob"), "the drop")
        assert await a.send_message("bob", b"queued during outage 1") is not None
        assert await a.send_message("bob", b"queued during outage 2") is not None
        await _until(lambda: len(got) >= 2, "the queued messages")
        assert [m.content for m in got] == [b"queued during outage 1",
                                            b"queued during outage 2"]
        assert a.verify_key_exchange_state("bob")
        assert a.shared_keys["bob"] != old_key
        assert a.shared_keys["bob"] == b.shared_keys["alice"]
        r = a.metrics()["resilience"]
        assert (r["heals_ok"], r["outbox_queued"], r["outbox_dropped"]) == (1, 2, 0)
        await _stop(a, b)

    _run(main(), 30)


# -- mirrors of tests/test_resumption.py (tickets and drain) ---------------------


def test_resume_happy_path_end_to_end(fast_timeout):
    async def main():
        a, b = await _toy_pair()
        assert await a.initiate_key_exchange("bob")
        entry = a.ticket_for("bob")  # rides the ke_response frame
        assert entry is not None
        first_blob = bytes(entry["ticket"])
        assert b._ctr_tickets_minted.value == 1
        await _reconnect(a, b)
        assert await a.initiate_key_exchange("bob")
        assert (a._ctr_resumes_used.value, b._ctr_resumes_ok.value,
                a._ctr_resume_fallbacks.value) == (1, 1, 0)
        got = _inbox(b)
        assert await a.send_message("bob", b"resumed traffic") is not None
        await _until(lambda: got, "the resumed message")
        assert got[0].content == b"resumed traffic"
        entry2 = a.ticket_for("bob")
        assert entry2 is not None and bytes(entry2["ticket"]) != first_blob
        await _stop(a, b)

    _run(main(), 30)


def test_resume_skips_kem_and_signatures(fast_timeout):
    """The abbreviated exchange runs no KEM or signature op: a plan on the
    scalar-op fault point matches none."""

    async def main():
        a, b = await _toy_pair()
        done = []
        b.register_message_listener(lambda p, m: done.append(m) if m.is_system else None)
        assert await a.initiate_key_exchange("bob")
        await _until(lambda: done, "the ke_test")
        plan = faults.FaultPlan(0, [faults.FaultRule("scalar.op", "raise", nth=10_000)])
        with plan.activate():
            await _reconnect(a, b)
            assert await a.initiate_key_exchange("bob")
        assert a._ctr_resumes_used.value == 1
        assert plan._matched == [0]
        await _stop(a, b)

    _run(main(), 30)


def test_in_session_rekey_still_runs_full_handshake(fast_timeout):
    async def main():
        a, b = await _toy_pair()
        assert await a.initiate_key_exchange("bob")
        a.shared_keys.pop("bob", None)
        a.ke_state["bob"] = msg.KeyExchangeState.NONE
        assert await a.initiate_key_exchange("bob")
        assert a._ctr_resumes_used.value == 0
        assert a.ticket_for("bob") is not None
        await _stop(a, b)

    _run(main(), 30)


def _doctored_entry(entry, blob):
    return {"ticket": blob, "expires_at": entry["expires_at"],
            "secret": bytearray(entry["secret"])}


@pytest.mark.parametrize("doctor", [
    lambda blob: blob[:10],                                  # truncated
    lambda blob: blob + b"x" * 5000,                         # oversized
    lambda blob: os.urandom(len(blob)),                      # garbage
    lambda blob: blob[:3] + b"00000000" + blob[11:],         # flipped epoch
    lambda blob: blob[:-4] + bytes(4),                       # broken MAC
], ids=["truncated", "oversized", "garbage", "epoch", "mac"])
def test_hostile_ticket_falls_back_to_full_handshake(fast_timeout, doctor):
    async def main():
        a, b = await _toy_pair()
        assert await a.initiate_key_exchange("bob")
        entry = a.take_ticket("bob")
        await _reconnect(a, b)
        a.adopt_ticket("bob", _doctored_entry(entry, doctor(entry["ticket"])))
        assert await a.initiate_key_exchange("bob")
        assert (a._ctr_resumes_used.value, a._ctr_resume_fallbacks.value,
                b._ctr_resume_rejects.value, b._ctr_resumes_ok.value) == (0, 1, 1, 0)
        assert a.verify_key_exchange_state("bob")
        await _stop(a, b)

    _run(main(), 30)


def test_replayed_ticket_second_use_full_handshakes_and_counts(fast_timeout):
    async def main():
        a, b = await _toy_pair()
        assert await a.initiate_key_exchange("bob")
        entry = a.ticket_for("bob")
        saved = _doctored_entry(entry, bytes(entry["ticket"]))
        await _reconnect(a, b)
        assert await a.initiate_key_exchange("bob")
        assert a._ctr_resumes_used.value == 1
        await _reconnect(a, b)
        a.adopt_ticket("bob", saved)
        assert await a.initiate_key_exchange("bob")
        assert a._ctr_resumes_used.value == 1
        assert b._replay.replays == 1
        assert b._ctr_resume_rejects.value == 1
        assert a.verify_key_exchange_state("bob")
        await _stop(a, b)

    _run(main(), 30)


@pytest.mark.parametrize("case", ["expired", "never_saw_the_stek", "stolen_blob"])
def test_bad_presentation_is_rejected_typed(fast_timeout, case):
    """An expired ticket, a responder with another STEK ring, and the blob
    without its secret: each a typed reject at the responder and a full
    handshake that establishes."""

    async def main():
        a, b = await _toy_pair()
        assert await a.initiate_key_exchange("bob")
        entry = a.take_ticket("bob")
        await _reconnect(a, b)
        if case == "expired":
            secret = bytearray(os.urandom(32))
            blob = b.tickets.seal_ticket(mint_fields(
                "alice", "bob", bytes(secret), a.kem.name, a.symmetric.name,
                a.signature.name, time.time() - 5.0))
            entry = {"ticket": blob, "expires_at": time.time() + 100.0, "secret": secret}
        elif case == "never_saw_the_stek":
            b.tickets = STEKRing()
        else:
            entry = {"ticket": entry["ticket"], "expires_at": entry["expires_at"],
                     "secret": bytearray(os.urandom(32))}
        a.adopt_ticket("bob", entry)
        assert await a.initiate_key_exchange("bob")
        assert (a._ctr_resumes_used.value, b._ctr_resume_rejects.value) == (0, 1)
        assert a.verify_key_exchange_state("bob")
        await _stop(a, b)

    _run(main(), 30)


@pytest.mark.parametrize("action", ["corrupt", "expire", "replay"])
def test_ticket_fault_injection_is_typed_and_logged(fast_timeout, action):
    async def main():
        a, b = await _toy_pair()
        assert await a.initiate_key_exchange("bob")
        await _reconnect(a, b)
        plan = faults.FaultPlan(5, [faults.FaultRule("ticket", action, nth=1)])
        with plan.activate():
            assert await a.initiate_key_exchange("bob")
        assert (a._ctr_resumes_used.value, a._ctr_resume_fallbacks.value,
                b._ctr_resume_rejects.value) == (0, 1, 1)
        assert plan.injected and plan.injected[0]["action"] == action
        assert a.verify_key_exchange_state("bob")
        await _stop(a, b)

    _run(main(), 30)


def test_opted_out_wire_is_byte_identical_to_pre_resumption(fast_timeout):
    async def main():
        sent: list[tuple[str, frozenset]] = []
        a, b = await _toy_pair(a_kw={"resumption": False}, b_kw={"resumption": False},
                               a_node_kw={"resumption": False},
                               b_node_kw={"resumption": False})
        for node in (a.node, b.node):
            orig = node.send_message

            async def spy(peer_id, msg_type, _orig=orig, **payload):
                sent.append((msg_type, frozenset(payload)))
                return await _orig(peer_id, msg_type, **payload)

            node.send_message = spy
        assert await a.initiate_key_exchange("bob")
        assert [t for t, _ in sent if t.startswith("ke_")] == [
            "ke_init", "ke_response", "ke_confirm", "ke_test"]
        resp_keys = next(keys for t, keys in sent if t == "ke_response")
        assert resp_keys == frozenset({"ke_data", "sig", "sig_algo", "sig_pk"})
        assert a.ticket_for("bob") is None and b._ctr_tickets_minted.value == 0
        await _stop(a, b)

    _run(main(), 30)


def test_unnegotiated_peer_gets_no_tickets(fast_timeout):
    async def main():
        a, b = await _toy_pair(b_kw={"resumption": False}, b_node_kw={"resumption": False})
        assert await a.initiate_key_exchange("bob")
        assert a.ticket_for("bob") is None and b._ctr_tickets_minted.value == 0
        await _reconnect(a, b)
        assert await a.initiate_key_exchange("bob")
        assert (a._ctr_resumes_used.value, a._ctr_resume_fallbacks.value) == (0, 0)
        await _stop(a, b)

    _run(main(), 30)


def test_resume_ok_without_fresh_ticket_stores_no_secret(fast_timeout, monkeypatch):
    async def main():
        a, b = await _toy_pair()
        assert await a.initiate_key_exchange("bob")
        assert a.ticket_for("bob") is not None
        await _reconnect(a, b)
        monkeypatch.setattr(b.tickets, "seal_ticket", lambda fields: b"")
        assert await a.initiate_key_exchange("bob")
        assert a._ctr_resumes_used.value == 1
        assert a.shared_keys.get("bob") is not None
        assert a.ticket_for("bob") is None
        await _stop(a, b)

    _run(main(), 30)


def test_drain_readyz_sheds_and_nudges(fast_timeout):
    async def main():
        a, b = await _toy_pair()
        assert await a.initiate_key_exchange("bob")
        res = await b.drain("rolling-restart-test")
        assert b.draining and res["nudged"] == 1
        ready = b.ready_status()
        assert (ready["ready"], ready["draining"], ready["drain_reason"]) == (
            False, True, "rolling-restart-test")
        await _until(lambda: a._ctr_rehome_nudges.value, "the rehome nudge")
        assert a._ctr_rehome_nudges.value == 1
        a.shared_keys.pop("bob", None)
        a._tickets.pop("bob", None)
        a.ke_state["bob"] = msg.KeyExchangeState.NONE
        assert not await a.initiate_key_exchange("bob", retries=0)
        assert b._ctr_handshake_sheds.value >= 1
        assert (await b._resume_respond("alice", {}, {}, "x")) == "draining"
        assert (await b.drain("second")).get("already_draining")
        await _stop(a, b)

    _run(main(), 30)


def test_drain_flushes_outbox(fast_timeout):
    async def main():
        a, b = await _toy_pair()
        assert await a.initiate_key_exchange("bob")
        got = _inbox(b)
        a._outbox["bob"] = [Message(content=b"parked", sender_id=a.node_id,
                                    recipient_id="bob")]
        assert (await a.drain("test"))["flushed"] == 1
        await _until(lambda: got, "the flushed message")
        assert got[0].content == b"parked"
        await _stop(a, b)

    _run(main(), 30)


def test_busy_shed_is_typed_and_rekeys_are_exempt(fast_timeout):
    """Admission control: over ``max_inflight_handshakes`` a ke_init draws
    a typed ``server_busy``, which the initiator retries; a peer with a
    completed session re-keys past the budget."""

    async def main():
        a, b = await _toy_pair(b_kw={"max_inflight_handshakes": 1})
        b._responding = 1  # one handshake in flight at the responder
        assert await a._initiate_once("bob") == msg.RejectReason.BUSY.value
        assert b._ctr_handshake_sheds.value == 1
        b._responding = 0
        assert await a.initiate_key_exchange("bob")
        b._responding = 1
        a.shared_keys.pop("bob", None)
        a.ke_state["bob"] = msg.KeyExchangeState.NONE
        assert await a.initiate_key_exchange("bob")  # bob knows alice: a rekey
        assert b._ctr_handshake_sheds.value == 1
        b._responding = 0
        await _stop(a, b)

    _run(main(), 30)
