"""The port's session state (quantum_resistant_p2p_tpu_torch.app:
``resumption`` and ``message_store``) against the JAX package's, on the
CPU.

Every derivation is byte-equal under the same inputs; with ``os.urandom``
patched to one seeded stream (the STEK, its epoch, the sealing nonce and
the ticket nonce all come from it) the rings, the minted fields and the
sealed tickets are byte-equal too.  Tickets open across the two packages,
and rotation, the accept window, the replay cache and every typed reject
reason match.  Tolerance: exact.  Stdlib only on both sides.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os

import numpy as np
import pytest

from quantum_resistant_p2p_tpu.app import message_store as ref_store
from quantum_resistant_p2p_tpu.app import resumption as ref_res
from quantum_resistant_p2p_tpu_torch.app import message_store as store
from quantum_resistant_p2p_tpu_torch.app import resumption as res

SIDES = {"port": res, "ref": ref_res}


class _Urandom:
    """``os.urandom`` from a numpy seed (reset per side)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def __call__(self, n: int) -> bytes:
        return bytes(self.rng.integers(0, 256, n, dtype=np.uint8))


def _both(monkeypatch, seed: int, fn):
    """``fn(module)`` on each side under the same seeded ``os.urandom``."""
    out = {}
    for side, mod in SIDES.items():
        monkeypatch.setattr(os, "urandom", _Urandom(seed))
        out[side] = fn(mod)
    return out["port"], out["ref"]


@pytest.mark.parametrize("seed", [60, 61, 62])
def test_derivations_are_byte_equal(seed):
    """Inputs: secrets, ids and nonces from seed; exact."""
    rng = np.random.default_rng(seed)

    def rb(n):
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))

    for _ in range(8):
        raw, salt, info = rb(32), rb(int(rng.integers(0, 40))), rb(int(rng.integers(0, 40)))
        length = int(rng.integers(1, 100))
        ida, idb = rb(8).hex(), rb(8).hex()
        cn, sn, mid = rb(16).hex(), rb(16).hex(), rb(16).hex()
        data, blob = rb(int(rng.integers(0, 200))), rb(int(rng.integers(0, 200)))
        outs = []
        for mod in SIDES.values():
            rsec = mod.derive_resumption_secret(raw, ida, idb)
            key = mod.derive_resumed_key(rsec, cn, sn, "ChaCha20-Poly1305")
            outs.append((mod.hkdf_sha256(raw, salt, info, length), rsec, key,
                         mod.ratchet_resumption_secret(rsec, cn, sn),
                         mod.resume_binder(rsec, data, blob),
                         mod.resume_binder(rsec, data, memoryview(blob)),
                         mod.resume_confirm_tag(key, mid, cn, sn),
                         mod._keystream(rsec, salt, length)))
        assert outs[0] == outs[1]
    # RFC 5869 A.1
    okm = res.hkdf_sha256(bytes([0x0b] * 22), bytes(range(13)), bytes(range(0xf0, 0xfa)), 42)
    assert okm.hex().startswith("3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf")


@pytest.mark.parametrize("seed", [63, 64])
def test_rings_mints_and_tickets_are_byte_equal_under_one_urandom(monkeypatch, seed):
    """Inputs: ``os.urandom`` from seed; exact (epochs, keys, the minted
    fields with their uuid4 nonce, the sealed blobs, rotations)."""
    secret = hashlib.sha256(b"secret%d" % seed).digest()

    def run(mod):
        ring = mod.STEKRing()
        fields = mod.mint_fields("holder-a", "issuer-b", secret, "ML-KEM-768",
                                 "ChaCha20-Poly1305", "ML-DSA-65", 1.7e9 + 0.12345)
        blob = ring.seal_ticket(fields)
        epochs = [ring.current_epoch, ring.rotate()]
        blob2 = ring.seal_ticket(fields)
        opened = ring.open_ticket(blob), ring.open_ticket(blob2)
        return ring.export(), fields, blob, blob2, epochs, opened, ring.epochs

    ours, theirs = _both(monkeypatch, seed, run)
    assert ours == theirs
    export, fields, blob, _, epochs, opened, ring_epochs = ours
    assert ring_epochs == epochs[::-1] and len(export) == 2
    assert fields["expires_at"] == round(1.7e9 + 0.12345, 3) and len(fields["nonce"]) == 32
    assert blob[:3] == b"QT1" and blob[3:11] == epochs[0].encode()
    assert opened[0][1] == opened[1][1] == secret
    assert "secret" not in opened[0][0]


@pytest.mark.parametrize("minter,opener", [("port", "ref"), ("ref", "port")])
def test_tickets_open_across_the_packages(monkeypatch, minter, opener):
    """A ring exported by one side and installed on the other: a ticket
    sealed by one opens in the other, fields and secret intact."""
    monkeypatch.setattr(os, "urandom", _Urandom(65))
    mint_ring = SIDES[minter].STEKRing()
    open_ring = SIDES[opener].STEKRing([(e, bytes.fromhex(k)) for e, k in mint_ring.export()])
    secret = bytes(range(32))
    fields = SIDES[minter].mint_fields("a", "b", secret, "K", "A", "S", 123.0)
    got, sec = open_ring.open_ticket(mint_ring.seal_ticket(fields))
    assert sec == secret and got == {k: v for k, v in fields.items() if k != "secret"}


def test_rotation_accept_window_and_install_guard_match(monkeypatch):
    """Three rotations: a ticket of the previous key still opens, one two
    keys back is an unknown STEK; the install guard refuses a regression;
    exact."""
    def run(mod):
        ring = mod.STEKRing()
        fields = mod.mint_fields("a", "b", bytes(32), "K", "A", "S", 9.0)
        blobs = []
        for _ in range(3):
            blobs.append(ring.seal_ticket(fields))
            ring.rotate()
        reasons = []
        for blob in blobs:
            try:
                ring.open_ticket(blob)
                reasons.append("ok")
            except mod.TicketError as e:
                reasons.append(e.reason)
        old = ring.export()
        ring.rotate()
        installed = (ring.install([(e, bytes.fromhex(k)) for e, k in old], guard=True),
                     ring.install([(e, bytes.fromhex(k)) for e, k in old], guard=False))
        bad = []
        for keys in ([], [("short", bytes(32))], [("abcdefgh", bytes(5))]):
            try:
                mod.STEKRing(keys) if keys else ring.install(keys)
            except ValueError as e:
                bad.append(str(e))
        try:
            ring.rotate(bytes(5))
        except ValueError as e:
            bad.append(str(e))
        return reasons, installed, bad, ring.epochs == [e for e, _ in old]

    ours, theirs = _both(monkeypatch, 66, run)
    assert ours == theirs
    assert ours[0] == ["unknown_stek", "unknown_stek", "ok"] and ours[1] == (False, True)
    assert ours[3] and len(ours[2]) == 4


def _sealed(mod, ring, body: bytes) -> bytes:
    """A blob whose ciphertext is ``body`` under the ring's current key."""
    epoch = ring.current_epoch
    key = dict((e, bytes.fromhex(k)) for e, k in ring.export())[epoch]
    nonce = bytes(16)
    ct = bytes(a ^ b for a, b in zip(body, mod._keystream(key, nonce, len(body))))
    header = mod.TICKET_MAGIC + epoch.encode() + nonce
    return header + ct + hmac.new(key, header + ct, hashlib.sha256).digest()


HOSTILE = {
    "truncated": lambda mod, ring, blob: blob[:20],
    "oversized": lambda mod, ring, blob: blob + bytes(5000),
    "magic": lambda mod, ring, blob: b"QT2" + blob[3:],
    "epoch-not-ascii": lambda mod, ring, blob: blob[:3] + b"\xff" * 8 + blob[11:],
    "unknown-epoch": lambda mod, ring, blob: blob[:3] + b"00000000" + blob[11:],
    "flipped-ct": lambda mod, ring, blob: blob[:40] + bytes([blob[40] ^ 1]) + blob[41:],
    "flipped-tag": lambda mod, ring, blob: blob[:-1] + bytes([blob[-1] ^ 1]),
    "not-json": lambda mod, ring, blob: _sealed(mod, ring, b"{not json"),
    "json-list": lambda mod, ring, blob: _sealed(mod, ring, b"[1, 2]"),
    "bad-secret-hex": lambda mod, ring, blob: _sealed(mod, ring, b'{"secret": "zz"}'),
    "short-secret": lambda mod, ring, blob: _sealed(mod, ring, b'{"secret": "00ff"}'),
    "no-secret": lambda mod, ring, blob: _sealed(mod, ring, b'{"v": 1}'),
}


@pytest.mark.parametrize("name", sorted(HOSTILE))
def test_hostile_tickets_are_refused_with_the_same_reason(monkeypatch, name):
    def run(mod):
        ring = mod.STEKRing()
        blob = ring.seal_ticket(mod.mint_fields("a", "b", bytes(32), "K", "A", "S", 9.0))
        with pytest.raises(mod.TicketError) as e:
            ring.open_ticket(HOSTILE[name](mod, ring, blob))
        return e.value.reason, str(e.value)

    ours, theirs = _both(monkeypatch, 67, run)
    assert ours == theirs and ours[0] in res.REASONS
    assert res.REASONS == ref_res.REASONS
    assert res.TicketError("draining").reason == "draining"


@pytest.mark.parametrize("seed", [68, 69])
def test_replay_cache_matches(seed):
    """Inputs: 300 (nonce, expiry, now) presentations from seed at capacity
    16; exact (each verdict, the size, the replay count)."""
    rng = np.random.default_rng(seed)
    events = [(f"n{int(rng.integers(0, 40))}", float(rng.integers(0, 100)),
               float(rng.integers(0, 100))) for _ in range(300)]
    outs = []
    for mod in SIDES.values():
        cache = mod.ReplayCache(capacity=16)
        verdicts = [cache.seen(*e) for e in events]
        outs.append((verdicts, len(cache), cache.replays))
    assert outs[0] == outs[1] and any(outs[0][0]) and not all(outs[0][0])


def test_resumption_default_reads_the_same_variable(monkeypatch):
    for value, want in (("0", False), ("1", True), ("yes", True)):
        monkeypatch.setenv("QRP2P_RESUMPTION", value)
        assert res.resumption_default() == ref_res.resumption_default() == want
    monkeypatch.delenv("QRP2P_RESUMPTION")
    assert res.resumption_default() and ref_res.resumption_default()


def test_message_store_matches():
    """One sequence of adds, reads and mark-reads on each store; exact
    (histories as dicts, unread counts, conversations), and a message
    crosses packages through ``to_dict`` / ``from_dict``."""
    rng = np.random.default_rng(70)
    outs = []
    for mod in (store, ref_store):
        s = mod.MessageStore()
        log = []
        for i in range(60):
            peer = f"peer{int(rng.integers(0, 4))}"
            op = int(rng.integers(0, 3))
            if op == 0:
                m = mod.Message(content=bytes([i]) * i, sender_id=peer, recipient_id="me",
                                timestamp=float(i), message_id=f"m{i}", is_file=bool(i % 2),
                                filename=f"f{i}" if i % 2 else None, key_exchange_algo="K")
                s.add_message(peer, m, unread=bool(i % 3))
            elif op == 1:
                s.mark_read(peer)
            log.append((s.get_unread_count(peer), [m.to_dict() for m in s.get_messages(peer)]))
        outs.append((log, s.conversations()))
        rng = np.random.default_rng(70)
    assert outs[0] == outs[1]
    d = store.Message(b"x", "a", "b").to_dict()
    assert ref_store.Message.from_dict(d).to_dict() == d
    assert store.Message.from_dict(ref_store.Message(b"y", "b", "a").to_dict()).content == b"y"
    assert json.loads(json.dumps(d)) == d
