"""Session-resumption tickets: PSK-style abbreviated handshakes.

Counterpart of the reference's ``app/resumption.py``, byte for byte in
every derivation and in the ticket layout.  After a confirmed full
handshake the responder mints an **encrypted, self-contained resumption
ticket**, sealed under a session-ticket-encryption key (STEK) only the
responder side holds, and a reconnect presents it for a 1-RTT abbreviated
exchange: two HKDF calls and two HMACs, no KEM, no signatures, no device
dispatch.

Ticket blob layout (opaque to the holder)::

    b"QT1" | epoch 8B (ascii hex) | nonce 16B | ct | tag 32B

``ct`` seals the canonical-JSON ticket fields (holder identity, the
HKDF-derived resumption secret, negotiated suite, expiry, a single-use
nonce) with a stdlib encrypt-then-MAC construction (SHA-256 keystream +
HMAC-SHA256) keyed by the STEK.  The ``epoch`` names WHICH key sealed the
blob: a :class:`STEKRing` accepts the current and the previous key (the
dual-key rotation window), so a ticket minted just before a rotation still
resumes.

Trust model: the sealed blob is public by construction; it reveals
nothing without the STEK, and a STOLEN blob is useless without the
resumption secret (the presenter must also supply a binder HMAC keyed by
it, the TLS-PSK binder analog).  Hostile input of any shape is a typed
:class:`TicketError` whose ``reason`` the responder echoes in its reject
frame.  Replay is bounded per responder by a :class:`ReplayCache` over the
ticket's single-use nonce, and across responders by the ticket expiry.

Randomness comes from ``os.urandom`` alone (the STEK, its epoch, the
sealing nonce, and ``uuid.uuid4`` for the ticket nonce), so a caller that
patches ``os.urandom`` fixes every random byte.  Stdlib only.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import uuid
import json

__all__ = [
    "TicketError", "STEKRing", "ReplayCache", "hkdf_sha256",
    "derive_resumption_secret", "derive_resumed_key",
    "ratchet_resumption_secret", "resume_binder", "resume_confirm_tag",
    "resumption_default",
]

#: ticket wire magic + version (bump on layout change)
TICKET_MAGIC = b"QT1"
#: epoch field: 8 ascii-hex bytes naming the sealing STEK
EPOCH_LEN = 8
NONCE_LEN = 16
TAG_LEN = 32
#: hard bound on accepted ticket blobs — a hostile length claim must cost
#: one comparison, never memory
MAX_TICKET_LEN = 4096
MIN_TICKET_LEN = len(TICKET_MAGIC) + EPOCH_LEN + NONCE_LEN + TAG_LEN

#: typed reject reasons (the reference's protocol table); the responder echoes
#: these in ``ke_resume_reject`` so the initiator's fallback is explainable
REASONS = (
    "malformed_ticket", "unknown_stek", "bad_ticket_auth", "expired_ticket",
    "replayed_ticket", "holder_mismatch", "suite_mismatch", "bad_binder",
    "resumption_disabled", "draining",
)


def resumption_default() -> bool:
    """``QRP2P_RESUMPTION`` policy: tickets are on unless ``0`` (the same
    shape as the binary-wire knob, ``QRP2P_BINARY_WIRE``)."""
    return os.environ.get("QRP2P_RESUMPTION", "1") != "0"


class TicketError(ValueError):
    """Typed ticket-validation failure.  ``reason`` is one of
    :data:`REASONS` — carried as an attribute so the responder's reject
    frame and the tests classify on the typed value, never message text."""

    def __init__(self, reason: str):
        super().__init__(f"ticket rejected: {reason}")
        self.reason = reason


def hkdf_sha256(ikm: bytes, salt: bytes, info: bytes, length: int = 32) -> bytes:
    """RFC 5869 HKDF-SHA256 (extract + expand) on the stdlib: the one
    copy the session layer derives every key with."""
    prk = hmac.new(salt or bytes(32), ikm, hashlib.sha256).digest()
    okm = b""
    t = b""
    i = 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


def derive_resumption_secret(raw_secret: bytes, id_a: str, id_b: str) -> bytes:
    """The resumption master secret: HKDF over the session's raw KEM
    secret, salted by the sorted peer ids (both sides derive identically,
    mirroring :func:`app.messaging.derive_message_key`).  Knowing it —
    not holding the sealed blob — is what authorizes a resume."""
    ids = "|".join(sorted([id_a, id_b]))
    return hkdf_sha256(raw_secret, salt=ids.encode(),
                       info=b"qrp2p-tpu/resumption/v1")


def derive_resumed_key(resumption_secret: bytes, client_nonce: str,
                       server_nonce: str, aead_name: str) -> bytes:
    """The resumed session's message key: fresh per resume (both nonces
    are single-exchange), bound to the AEAD name exactly like the full
    handshake's key derivation."""
    return hkdf_sha256(
        resumption_secret,
        salt=(client_nonce + "|" + server_nonce).encode(),
        info=b"qrp2p-tpu/resume-key/" + aead_name.encode(),
    )


def ratchet_resumption_secret(resumption_secret: bytes, client_nonce: str,
                              server_nonce: str) -> bytes:
    """The NEXT resumption secret, derived by both sides on every
    successful resume: the fresh ticket a resume returns never carries the
    secret that authorized it (one-way ratchet — an old secret cannot
    redeem a new ticket)."""
    return hkdf_sha256(
        resumption_secret,
        salt=(client_nonce + "|" + server_nonce).encode(),
        info=b"qrp2p-tpu/resumption/next",
    )


def resume_binder(resumption_secret: bytes, resume_data: bytes,
                  ticket_blob: bytes) -> str:
    """The presenter's proof-of-secret (TLS-PSK binder analog): an HMAC
    over the resume transcript AND the exact blob presented, keyed by the
    resumption secret — a stolen sealed blob without the secret fails
    here, typed, before any state changes."""
    return hmac.new(resumption_secret,
                    b"qrp2p-tpu/resume-binder|" + resume_data + bytes(ticket_blob),
                    hashlib.sha256).hexdigest()


def resume_confirm_tag(resumed_key: bytes, message_id: str, client_nonce: str,
                       server_nonce: str) -> str:
    """The responder's proof-of-secret: an HMAC under the RESUMED key over
    the exchange ids — the initiator installs nothing until it verifies."""
    return hmac.new(
        resumed_key,
        b"qrp2p-tpu/resume-confirm|" + "|".join(
            (message_id, client_nonce, server_nonce)).encode(),
        hashlib.sha256).hexdigest()


def _keystream(stek: bytes, nonce: bytes, n: int) -> bytes:
    out = b""
    ctr = 0
    while len(out) < n:
        out += hashlib.sha256(stek + nonce
                              + ctr.to_bytes(8, "big")).digest()
        ctr += 1
    return out[:n]


class STEKRing:
    """Current + previous session-ticket-encryption keys (the dual-key
    rotation accept window).

    Mints with the CURRENT key; opens with any key in the window, so a
    rotation never strands the tickets minted just before it.  One
    authoritative ring can be exported and installed on every responder
    (:meth:`export` / :meth:`install`), so a ticket minted by one resumes
    on another after a handoff or a restart.
    """

    #: keys kept: current + previous (the accept window)
    WINDOW = 2

    def __init__(self, keys: "list[tuple[str, bytes]] | None" = None):
        #: epoch -> key, newest first
        self._keys: dict[str, bytes] = {}
        if keys:
            self.install(keys)
        else:
            self.rotate()

    # -- key management -------------------------------------------------------

    @property
    def current_epoch(self) -> str:
        return next(iter(self._keys))

    @property
    def epochs(self) -> list[str]:
        return list(self._keys)

    def rotate(self, stek: bytes | None = None,
               epoch: str | None = None) -> str:
        """Install a fresh current key (random unless given), demoting the
        old current to the accept-only slot and dropping anything older.
        Returns the new epoch."""
        stek_key = stek if stek is not None else os.urandom(32)
        if len(stek_key) != 32:
            raise ValueError("STEK must be 32 bytes")
        new_epoch = epoch if epoch is not None else os.urandom(4).hex()
        keep = list(self._keys.items())[: self.WINDOW - 1]
        self._keys = dict([(new_epoch, stek_key)] + keep)
        return new_epoch

    def install(self, keys: "list[tuple[str, bytes]]", *,
                guard: bool = False) -> bool:
        """Replace the ring with a distributed key set (newest first) —
        the gateway side of the fleet's STEK push.

        ``guard=True`` refuses a set that would REGRESS the accept
        window: with a replicated control plane, a rotation push and a
        renewal-time re-replication ride separate short-lived
        connections, so a pre-rotation frame can land after the rotation
        it predates.  Epochs are random (unordered), but a regression is
        still detectable structurally — the incoming CURRENT key is one
        we already demoted to the accept-only slot.  Installing it would
        re-mint under a key the rest of the fleet is about to drop.
        Returns True when the set was installed, False when the guard
        skipped it (callers flight-record the skip).
        """
        cleaned: list[tuple[str, bytes]] = []
        for epoch, stek_key in keys[: self.WINDOW]:
            epoch = str(epoch)
            stek_key = bytes(stek_key)
            if len(epoch) != EPOCH_LEN or len(stek_key) != 32:
                raise ValueError("malformed STEK entry")
            cleaned.append((epoch, stek_key))
        if not cleaned:
            raise ValueError("empty STEK set")
        if guard and self._keys:
            incoming_current = cleaned[0][0]
            if (incoming_current != self.current_epoch
                    and incoming_current in self._keys):
                return False
        self._keys = dict(cleaned)
        return True

    def export(self) -> list[list[str]]:
        """The distributable form (newest first): ``[[epoch, key_hex]]``
        — for the fleet control link only; never for any peer-facing or
        observability surface."""
        return [[epoch, stek_key.hex()]
                for epoch, stek_key in self._keys.items()]

    # -- seal / open ----------------------------------------------------------

    def seal_ticket(self, fields: dict) -> bytes:
        """Seal the ticket fields under the CURRENT key.  The blob is
        public by construction (like a signature): it
        reveals nothing without the STEK and authorizes nothing without
        the resumption secret inside it."""
        body = json.dumps(fields, sort_keys=True,
                          separators=(",", ":")).encode()
        epoch = self.current_epoch
        stek_key = self._keys[epoch]
        nonce = os.urandom(NONCE_LEN)
        ct = bytes(a ^ b for a, b in
                   zip(body, _keystream(stek_key, nonce, len(body))))
        header = TICKET_MAGIC + epoch.encode() + nonce
        tag = hmac.new(stek_key, header + ct, hashlib.sha256).digest()
        return header + ct + tag

    def open_ticket(self, blob) -> "tuple[dict, bytes]":
        """Open a presented blob -> ``(public_fields, resumption_secret)``.

        Every failure is a typed :class:`TicketError`: wrong
        magic/truncated/oversized -> ``malformed_ticket``, an epoch outside
        the accept window (or a gateway that never saw the STEK) ->
        ``unknown_stek``, a failed MAC (corruption, tampering) ->
        ``bad_ticket_auth``.  The secret is returned SEPARATELY from the
        metadata so callers never branch on secret-tainted values."""
        blob = bytes(blob)
        if (len(blob) < MIN_TICKET_LEN or len(blob) > MAX_TICKET_LEN
                or blob[:len(TICKET_MAGIC)] != TICKET_MAGIC):
            raise TicketError("malformed_ticket")
        off = len(TICKET_MAGIC)
        try:
            epoch = blob[off:off + EPOCH_LEN].decode("ascii")
        except UnicodeDecodeError:
            raise TicketError("malformed_ticket") from None
        stek_key = self._keys.get(epoch)
        if stek_key is None:
            raise TicketError("unknown_stek")
        off += EPOCH_LEN
        nonce = blob[off:off + NONCE_LEN]
        ct = blob[off + NONCE_LEN:-TAG_LEN]
        tag = blob[-TAG_LEN:]
        want = hmac.new(stek_key, blob[:-TAG_LEN], hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise TicketError("bad_ticket_auth")
        body = bytes(a ^ b for a, b in
                     zip(ct, _keystream(stek_key, nonce, len(ct))))
        try:
            fields = json.loads(body)
        except ValueError:
            raise TicketError("malformed_ticket") from None
        if not isinstance(fields, dict):
            raise TicketError("malformed_ticket")
        try:
            secret = bytes.fromhex(str(fields.pop("secret", "")))
        except ValueError:
            raise TicketError("malformed_ticket") from None
        if len(secret) != 32:
            raise TicketError("malformed_ticket")
        return fields, secret


def mint_fields(holder: str, issuer: str, secret: bytes, kem: str, aead: str,
                sig: str, expires_at: float) -> dict:
    """The canonical ticket-field layout (one constructor so the mint and
    re-mint paths cannot drift): peer identity, the resumption secret,
    the negotiated suite, expiry, and a fresh single-use nonce."""
    return {
        "v": 1,
        "holder": holder,
        "issuer": issuer,
        "secret": secret.hex(),
        "kem": kem,
        "aead": aead,
        "sig": sig,
        "expires_at": round(float(expires_at), 3),
        "nonce": uuid.uuid4().hex,
    }


class ReplayCache:
    """Bounded single-use ledger over ticket nonces.

    ``seen(nonce, expires_at, now)`` returns True for a REPLAY (and
    records first uses).  Entries expire with their ticket; at capacity
    the earliest-expiring half is evicted — bounded memory under a nonce
    flood, at the documented cost that a very old first-use may be
    forgotten before its ticket expires (the expiry bound still holds)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._seen: dict[str, float] = {}
        #: replays observed (the counter the hostile-ticket tests bump)
        self.replays = 0

    def seen(self, nonce: str, expires_at: float, now: float) -> bool:
        expiry = self._seen.get(nonce)
        if expiry is not None and expiry >= now:
            self.replays += 1
            return True
        self._seen[nonce] = expires_at
        if len(self._seen) > self.capacity:
            for n, _exp in sorted(self._seen.items(),
                                  key=lambda kv: kv[1])[: self.capacity // 2]:
                if n != nonce:
                    del self._seen[n]
        return False

    def __len__(self) -> int:
        return len(self._seen)
