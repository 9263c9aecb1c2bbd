"""Asyncio TCP P2P node with framed, chunked message transport.

Counterpart of the reference's ``net/p2p_node.py``, byte for byte on the
wire, so a port node and a reference node talk to each other: TCP server
and client, peer registry, hello handshake, chunked framing, per-type
handler dispatch, disconnect fan-out.

Frame:   magic b"QP" | version u8 | flags u8 | length u32be | payload
         flags bit0 = CHUNK (payload carries a chunk header)
         flags bit1 = BIN   (payload is the negotiated binary encoding)
Chunk:   stream_id 16B | index u32be | count u32be | data
Payload: UTF-8 JSON object with a mandatory "type" key (the compat
         default), or, on connections that negotiated ``bin1`` in the
         hello exchange, the compact binary encoding below.

Binary payload::

    token b"B1" | type_len u8 | type | n_fields u8 | fields...
    field := key_len u8 | key | kind u8 | value_len u32be | value
    kind 0 = raw bytes (decoded as a zero-copy memoryview into the frame
             buffer: ciphertexts go from the socket buffer to the batched
             AEAD open with no copy and no base64 round trip)
    kind 1 = UTF-8 canonical JSON (everything else, incl. ``_trace``)

Negotiation: a node with ``QRP2P_BINARY_WIRE`` unset or ``1`` offers
``"wire": ["bin1"]`` in its hello; both sides offering upgrades every
later frame on that connection.  ``QRP2P_BINARY_WIRE=0`` and
un-negotiated peers send the JSON frames.  Session resumption is offered
the same way (``"resume": ["tik1"]``, ``QRP2P_RESUMPTION``).  Hostile
binary input (oversized lengths, truncated headers, a wrong token,
trailing bytes) fails as a typed :class:`WireError`: a log line, a
``wire_error`` flight event and the ``wire_errors`` counter, the offending
connection dropped, the serving loop and every other peer untouched.

Messages above ``chunk_size`` (default 64 KiB) are split into chunk frames
and reassembled on the far side.  Every send passes the ``net.send`` fault
point (faults/) and is a ``net.send`` span whose context rides the frame
as ``_trace``; every received message is one ``net.recv`` span parented
on it (obs/trace.py).  Stdlib only: the GPU is never on this path.

A connected peer's frames are corked (:class:`_CorkedWriter`): the frames
written in one turn of the event loop reach the socket together, in
writes of up to 64 KiB, instead of one small TCP segment each.  The bytes
on the wire are the reference's; only their segmentation differs.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import os
import random
import struct
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from ..faults import plan as _faults
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace

logger = logging.getLogger(__name__)

#: hello-response window; generous because a peer's loop can stall for a
#: few seconds behind a busy event loop
HELLO_TIMEOUT = 15.0

_MAGIC = b"QP"
_VERSION = 1
_FLAG_CHUNK = 0x01
_FLAG_BIN = 0x02
_HEADER = struct.Struct(">2sBBI")
_CHUNK_HEADER = struct.Struct(">16sII")

#: binary-payload negotiation token: the first two payload bytes of every
#: bin1 frame.  A frame flagged BIN without it is hostile/corrupt input
#: and fails typed (WireError), never as a stray json/struct exception.
_BIN_TOKEN = b"B1"
_BIN_WIRE_NAME = "bin1"
_BIN_KIND_RAW = 0
_BIN_KIND_JSON = 1

#: session-resumption negotiation token: offered in the hello exactly like
#: the wire format; tickets and resume frames flow only when BOTH sides
#: offered, so an opted-out (``QRP2P_RESUMPTION=0``) or older peer sees
#: the pre-resumption frames
_RESUME_NAME = "tik1"

#: bounded reconnect jitter (seconds): N clients of one dead gateway must
#: not redial its ring successor in the same tick — each reconnect sleeps
#: a seeded uniform [0, this) before dialing
RECONNECT_JITTER_S = 0.25

MessageHandler = Callable[[str, dict], Awaitable[None]]
ConnectionHandler = Callable[[str, str], None]  # (event, peer_id)

MAX_FRAME = 16 * 1024 * 1024

#: a corked peer writer hands its held frames to the socket once it holds
#: this many bytes or buffers (below Linux's IOV_MAX of 1024 for one
#: scatter-gather send), or else at the end of the event loop's turn
CORK_BYTES = 64 * 1024
CORK_BUFFERS = 512

#: largest raw value the binary decoder accepts per field — the sender
#: routes messages with a bigger bytes value (huge file transfers) over
#: the JSON wire instead, which chunks and reassembles without a
#: per-field cap; the receive-side bound stays tight against hostile
#: length claims
_BIN_MAX_FIELD = MAX_FRAME


class WireError(ValueError):
    """Typed wire-protocol violation (bad magic/version, oversized length,
    truncated or malformed binary payload, un-negotiated binary frame).
    The read loop maps it to one loud, counted connection drop — hostile
    input on one socket can never kill the node's serving loop."""


def binary_wire_default() -> bool:
    """``QRP2P_BINARY_WIRE`` policy: offer the binary wire unless ``0``."""
    return os.environ.get("QRP2P_BINARY_WIRE", "1") != "0"


def resumption_offer_default() -> bool:
    """``QRP2P_RESUMPTION`` policy: offer ticket resumption unless ``0``
    (the transport-side twin of ``app.resumption.resumption_default`` —
    kept local so net/ never imports the app layer)."""
    return os.environ.get("QRP2P_RESUMPTION", "1") != "0"


def _encode_bin(message: dict) -> list:
    """Encode a message dict as binary-payload segments (zero-copy: raw
    bytes/memoryview values ride as their own segments, uncopied)."""
    msg_type = str(message.get("type", ""))
    fields = [(k, v) for k, v in message.items() if k != "type"]
    tb = msg_type.encode()
    if len(tb) > 255 or len(fields) > 255:
        raise ValueError("binary frame: type/field count out of range")
    head = bytearray(_BIN_TOKEN)
    head.append(len(tb))
    head += tb
    head.append(len(fields))
    segs: list = [bytes(head)]
    for k, v in fields:
        kb = k.encode()
        if len(kb) > 255:
            raise ValueError(f"binary frame: key {k!r} too long")
        if isinstance(v, (bytes, bytearray, memoryview)):
            kind, vb = _BIN_KIND_RAW, v
        else:
            kind, vb = _BIN_KIND_JSON, json.dumps(
                v, separators=(",", ":")).encode()
        segs.append(bytes([len(kb)]) + kb + bytes([kind])
                    + len(vb).to_bytes(4, "big"))
        segs.append(vb)
    return segs


def _decode_bin(buf) -> dict:
    """Decode a binary payload into a message dict.

    ``memoryview``-parsed: raw-kind values are returned as views into the
    received frame buffer — the ciphertext of a ``secure_message`` flows
    from the socket buffer into the batched AEAD open without a copy.
    Every length is bounds-checked BEFORE use; any violation is a typed
    :class:`WireError` naming what was malformed.
    """
    view = memoryview(buf)
    pos = 0

    def take(n: int, what: str) -> memoryview:
        nonlocal pos
        if n < 0 or pos + n > len(view):
            raise WireError(f"truncated binary frame ({what})")
        out = view[pos:pos + n]
        pos += n
        return out

    if bytes(take(2, "wire token")) != _BIN_TOKEN:
        raise WireError("bad binary wire token")
    try:
        msg_type = bytes(take(take(1, "type length")[0], "type")).decode()
        message: dict = {"type": msg_type}
        for _ in range(take(1, "field count")[0]):
            fname = bytes(take(take(1, "name length")[0], "field name")).decode()
            kind = take(1, "field kind")[0]
            vlen = int.from_bytes(take(4, "value length"), "big")
            if vlen > _BIN_MAX_FIELD:
                raise WireError(f"oversized binary field {fname!r} ({vlen} bytes)")
            val = take(vlen, f"field {fname!r}")
            if kind == _BIN_KIND_RAW:
                message[fname] = val  # zero-copy view into the frame buffer
            elif kind == _BIN_KIND_JSON:
                message[fname] = json.loads(bytes(val))
            else:
                raise WireError(f"unknown binary field kind {kind}")
    except WireError:
        raise
    except (UnicodeDecodeError, ValueError) as e:
        raise WireError(f"malformed binary frame: {e}") from e
    if pos != len(view):
        raise WireError(f"trailing bytes in binary frame ({len(view) - pos})")
    return message


class _CorkedWriter:
    """A connected peer's stream writer that hands the socket few, large
    writes.

    ``write`` / ``writelines`` hold their buffers; the writer passes them
    on in one ``writelines`` (one scatter-gather send, the buffers
    uncopied) at the end of the event loop's turn, or at once when it
    holds ``CORK_BYTES`` or ``CORK_BUFFERS``.  ``close`` sends what is held
    first, so no frame written before it is dropped.

    Why: a sender's burst runs in one turn of the loop (``drain`` yields
    only once the transport's own buffer passes its high-water mark), so
    frames written one call each reach TCP as one small segment each
    while a receiver in the same loop cannot read.  On a user-space TCP
    stack, 1024 such messages over loopback put the sender into loss
    recovery that then delivered about one message a second; held here,
    the same burst leaves in segments of up to 64 KiB and arrives whole
    (``tests/test_torch_transport.py``, the burst tests).  Any other
    attribute is the wrapped writer's."""

    def __init__(self, writer: asyncio.StreamWriter):
        self._writer = writer
        self._held: list = []
        self._held_bytes = 0
        #: sends handed to the transport (one a flush)
        self.flushes = 0

    def __getattr__(self, name: str):
        return getattr(self._writer, name)

    def write(self, data) -> None:
        self.writelines((data,))

    def writelines(self, buffers) -> None:
        if not self._held:
            asyncio.get_running_loop().call_soon(self.flush)
        for b in buffers:
            if len(b):
                self._held.append(b)
                self._held_bytes += len(b)
        if self._held_bytes >= CORK_BYTES or len(self._held) >= CORK_BUFFERS:
            self.flush()

    def flush(self) -> None:
        """Hand everything held to the transport, in one call."""
        if not self._held:
            return
        held, self._held, self._held_bytes = self._held, [], 0
        if not self._writer.is_closing():
            self._writer.writelines(held)
            self.flushes += 1

    async def drain(self) -> None:
        await self._writer.drain()

    def close(self) -> None:
        self.flush()
        self._writer.close()


@dataclass
class _Peer:
    peer_id: str
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    host: str
    port: int  # the peer's listening port (from hello), not the socket port
    write_lock: asyncio.Lock = field(default_factory=asyncio.Lock)
    reassembly: dict[bytes, dict] = field(default_factory=dict)
    #: negotiated wire format: "json" (compat default) or "bin1" (both
    #: sides offered it in the hello exchange)
    wire: str = "json"
    #: session resumption negotiated (both sides offered "tik1")
    resume: bool = False


class P2PNode:
    """TCP transport node: opaque JSON messages between identified peers."""

    def __init__(
        self,
        node_id: str | None = None,
        host: str = "0.0.0.0",
        port: int = 8000,
        key_storage=None,
        chunk_size: int = 64 * 1024,
        max_peers: int = 0,
        accept_backlog: int = 256,
        binary_wire: bool | None = None,
        resumption: bool | None = None,
        jitter_rng: "random.Random | None" = None,
    ):
        if node_id is None:
            from .identity import load_or_generate_node_id

            node_id = load_or_generate_node_id(key_storage)
        self.node_id = node_id
        self.host = host
        self.port = port
        self.chunk_size = chunk_size
        #: connection budget (admission control): inbound
        #: peers beyond this many live connections are SHED at the hello —
        #: a typed ``__busy__`` reply then close, counted loudly — instead
        #: of admitted into a node already past its serving capacity.
        #: 0 = unlimited (the default; every pre-gateway caller).
        self.max_peers = max_peers
        #: kernel accept backlog for the listening socket: bounds the
        #: not-yet-accepted connection queue during an arrival storm (the
        #: kernel-side half of the backpressure story)
        self.accept_backlog = accept_backlog
        #: inbound connections shed over the budget (the gateway gauge)
        self.sheds = 0
        #: inbound connections ADMITTED at the same decision point — the
        #: good side matching ``sheds``: an SLI that counts connection
        #: sheds as bad must count connection admissions as good, or a
        #: reconnect wave of peers that never handshake reads as a
        #: near-total admission outage
        self.admitted = 0
        #: peers admitted but not yet registered (the hello reply awaits
        #: between the budget check and registration): counted against
        #: the budget so a storm of concurrent hellos cannot all pass the
        #: check before any of them registers
        self._admitting: set[str] = set()
        #: dials WE made that a remote shed with ``__busy__``
        self.busy_rejects = 0
        #: offer the length-prefixed binary wire format in hellos; actual
        #: use is per-connection, negotiated (both sides must offer).
        #: None reads QRP2P_BINARY_WIRE (default: offer).
        self.binary_wire = (binary_wire_default() if binary_wire is None
                            else binary_wire)
        #: offer session-resumption tickets in hellos (the session layer
        #: only mints/presents for peers where BOTH sides offered).
        #: None reads QRP2P_RESUMPTION (default: offer).
        self.resumption = (resumption_offer_default() if resumption is None
                           else resumption)
        #: seeded reconnect-jitter RNG: derived from a digest of the FULL
        #: node id (a raw prefix would hand every 'peerNNNNN'-style id
        #: sharing 8 leading bytes the SAME stream — re-synchronizing
        #: exactly the reconnect wave the jitter exists to spread);
        #: injectable so tests pin the exact jitter sequence
        if jitter_rng is None:
            import hashlib

            jitter_rng = random.Random(int.from_bytes(
                hashlib.sha256(self.node_id.encode()).digest()[:8], "big"))
        self._jitter_rng = jitter_rng
        #: typed wire-protocol violations (WireError) observed on read
        #: loops — each one dropped exactly one connection, loudly
        self.wire_errors = 0
        self._server: asyncio.Server | None = None
        self._peers: dict[str, _Peer] = {}
        self._read_tasks: dict[str, asyncio.Task] = {}
        self._msg_handlers: dict[str, list[MessageHandler]] = {}
        self._conn_handlers: list[ConnectionHandler] = []
        self._running = False
        #: peers THIS node dialed (only the dialing side redials on a drop —
        #: the listening side cannot know the peer's current address)
        self._dialed: set[str] = set()
        #: last known (host, listen_port) per peer; survives disconnects so
        #: session healing can redial
        self._addr: dict[str, tuple[str, int]] = {}
        #: peers whose disconnect was requested locally (stop(), an explicit
        #: disconnect): these must NOT be healed back
        self._intentional: set[str] = set()

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_inbound, self.host, self.port,
            backlog=self.accept_backlog,
        )
        self._running = True
        actual = self._server.sockets[0].getsockname()[1] if self._server.sockets else self.port
        self.port = actual
        logger.info("node %s listening on %s:%s", self.node_id[:8], self.host, self.port)

    async def stop(self) -> None:
        self._running = False
        for peer_id in list(self._peers):
            await self.disconnect_from_peer(peer_id)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- registry / handlers -------------------------------------------------

    def get_peers(self) -> list[str]:
        return list(self._peers)

    def is_connected(self, peer_id: str) -> bool:
        return peer_id in self._peers

    def get_peer_address(self, peer_id: str) -> tuple[str, int] | None:
        p = self._peers.get(peer_id)
        return (p.host, p.port) if p else None

    def peer_wire_format(self, peer_id: str) -> str | None:
        """The negotiated wire format for a live peer ("json" | "bin1"),
        None when unknown."""
        p = self._peers.get(peer_id)
        return p.wire if p else None

    def peer_resumption(self, peer_id: str) -> bool:
        """True when session resumption was negotiated with this live peer
        (both hellos offered it) — the session layer's gate for minting
        and presenting tickets."""
        p = self._peers.get(peer_id)
        return bool(p and p.resume)

    def _hello(self) -> dict:
        """Hello payload: node identity + (when enabled) the wire-format
        and resumption offers.  With the offers disabled the payload — and
        therefore the hello frame bytes — is identical to the historical
        one (pinned)."""
        hello = {"type": "__hello__", "node_id": self.node_id,
                 "listen_port": self.port}
        if self.binary_wire:
            hello["wire"] = [_BIN_WIRE_NAME]
        if self.resumption:
            hello["resume"] = [_RESUME_NAME]
        return hello

    def _negotiated_wire(self, hello: dict) -> str:
        """Per-connection wire format from the peer's hello: ``bin1`` iff
        BOTH sides offered it, else the JSON compat default."""
        offered = hello.get("wire")
        if (self.binary_wire and isinstance(offered, (list, tuple))
                and _BIN_WIRE_NAME in offered):
            return _BIN_WIRE_NAME
        return "json"

    def _negotiated_resume(self, hello: dict) -> bool:
        """Session resumption iff BOTH sides offered it (hostile hello
        shapes — wrong types, unknown tokens — read as not-offered)."""
        offered = hello.get("resume")
        return bool(self.resumption and isinstance(offered, (list, tuple))
                    and _RESUME_NAME in offered)

    def register_message_handler(self, msg_type: str, handler: MessageHandler) -> None:
        handlers = self._msg_handlers.setdefault(msg_type, [])
        if handler not in handlers:
            handlers.append(handler)

    def unregister_message_handler(self, msg_type: str, handler: MessageHandler) -> None:
        self._msg_handlers.get(msg_type, []).remove(handler)

    def register_connection_handler(self, handler: ConnectionHandler) -> None:
        if handler not in self._conn_handlers:
            self._conn_handlers.append(handler)

    def _fire_connection_event(self, event: str, peer_id: str) -> None:
        for h in list(self._conn_handlers):
            try:
                h(event, peer_id)
            except Exception:
                logger.exception("connection handler failed")

    # -- connecting ----------------------------------------------------------

    async def connect_to_peer(self, host: str, port: int, timeout: float = 10.0,
                              retries: int = 2) -> str | None:
        """Dial a peer, run the hello handshake, return its node id.

        A busy peer (e.g. its loop briefly stalled) may miss the hello
        window; only
        TRANSIENT failures (timeouts, dropped connections) are retried with
        backoff — a wrong-protocol endpoint ("bad hello") fails once, fast.
        """
        for attempt in range(retries + 1):
            peer_id, retryable = await self._connect_once(host, port, timeout)
            if peer_id is not None:
                self._dialed.add(peer_id)
            if peer_id is not None or not retryable or attempt == retries:
                return peer_id
            await asyncio.sleep(0.5 * (attempt + 1))
        return None

    def should_heal(self, peer_id: str) -> bool:
        """True when a dropped session to ``peer_id`` is OURS to redial:
        this node is running, dialed the peer originally, knows an address,
        and the disconnect was not locally requested."""
        return (
            self._running
            and peer_id in self._dialed
            and peer_id in self._addr
            and peer_id not in self._intentional
        )

    def _reconnect_jitter(self) -> float:
        """The next seeded reconnect-jitter delay (uniform
        [0, RECONNECT_JITTER_S)): one draw per redial, pinned
        deterministic under an injected ``jitter_rng``."""
        return self._jitter_rng.uniform(0.0, RECONNECT_JITTER_S)

    async def reconnect(self, peer_id: str, timeout: float = 10.0,
                        retries: int = 2) -> bool:
        """Redial a dropped peer at its last known address (existing
        connect backoff applies).  False when unknown, unreachable, or a
        DIFFERENT node now answers there.

        Each redial first sleeps a seeded, bounded jitter: after a
        gateway death every one of its N clients enters this path at the
        same moment, and without the jitter they all hammer the ring
        successor in the same tick (the thundering herd the fleet
        handoff machinery would otherwise create for itself)."""
        addr = self._addr.get(peer_id)
        if addr is None:
            return False
        await asyncio.sleep(self._reconnect_jitter())
        prior_dialed = set(self._dialed)
        got = await self.connect_to_peer(addr[0], addr[1], timeout, retries)
        if got is not None and got != peer_id:
            if got in prior_dialed:
                # The address was reused by a node we HAD chosen to talk to
                # (its hello just re-registered it, clobbering any previous
                # socket): keep this verified session rather than killing a
                # peer the heal machinery exists to protect.
                logger.warning(
                    "reconnect to %s reached known peer %s instead; keeping "
                    "that session", peer_id[:8], got[:8],
                )
                return False
            # A true stranger answered.  Drop the probe connection WITHOUT
            # marking it intentional (a genuine later session stays
            # healable) — and remove it from _dialed first, so its
            # disconnect event cannot spawn a heal that redials a node this
            # peer never chose.
            logger.warning(
                "reconnect to %s found a different node (%s); dropping it",
                peer_id[:8], got[:8],
            )
            self._dialed.discard(got)
            await self.disconnect_from_peer(got, intentional=False)
            return False
        return got == peer_id

    async def _connect_once(self, host: str, port: int,
                            timeout: float) -> tuple[str | None, bool]:
        """-> (peer_id | None, retryable)."""
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), timeout
            )
        except (OSError, asyncio.TimeoutError) as e:
            logger.warning("connect to %s:%s failed: %s", host, port, e)
            return None, True
        try:
            await self._send_frame(writer, asyncio.Lock(), self._hello())
            hello = await asyncio.wait_for(self._read_plain_frame(reader), HELLO_TIMEOUT)
            if hello.get("type") == "__busy__":
                # the remote gateway shed this dial (connection budget):
                # a TYPED fast failure — retryable once load drains, and
                # counted so a storm driver can report client-side sheds
                self.busy_rejects += 1
                logger.warning("peer %s:%s is at capacity (shed our dial)",
                               host, port)
                writer.close()
                return None, True
            if hello.get("type") != "__hello__":
                raise ValueError("bad hello")
        except Exception as e:
            logger.warning("hello with %s:%s failed: %s", host, port, e)
            writer.close()
            # a peer that SPOKE but spoke wrong is not transient
            return None, not isinstance(e, ValueError)
        peer_id = hello["node_id"]
        self._register_peer(peer_id, reader, writer, host,
                            int(hello.get("listen_port", port)),
                            wire=self._negotiated_wire(hello),
                            resume=self._negotiated_resume(hello))
        return peer_id, False

    async def _on_inbound(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        addr = writer.get_extra_info("peername") or ("?", 0)
        try:
            hello = await asyncio.wait_for(self._read_plain_frame(reader), HELLO_TIMEOUT)
            if hello.get("type") != "__hello__":
                raise ValueError("bad hello")
            peer_id = str(hello.get("node_id", ""))
            if not peer_id:
                raise ValueError("bad hello")
            known = peer_id in self._peers or peer_id in self._admitting
            if (
                self.max_peers
                and not known
                and len(self._peers) + len(self._admitting) >= self.max_peers
            ):
                # Admission control: over the connection budget, shed LOUDLY
                # with a typed reply (the dialer sees a fast, retryable
                # "busy", never a timeout).  A reconnect of an already-
                # registered peer replaces its socket and is never shed.
                # In-flight admissions (_admitting) count against the
                # budget: the hello reply below AWAITS, so without the
                # reservation a storm of concurrent hellos would all pass
                # this check before any of them registers.
                await self._shed_inbound(writer, addr)
                return
            self._admitting.add(peer_id)
            try:
                await self._send_frame(writer, asyncio.Lock(), self._hello())
            finally:
                self._admitting.discard(peer_id)
        except Exception as e:
            logger.warning("inbound hello from %s failed: %s", addr, e)
            writer.close()
            return
        self._register_peer(
            peer_id, reader, writer, addr[0],
            int(hello.get("listen_port", addr[1])),
            wire=self._negotiated_wire(hello),
            resume=self._negotiated_resume(hello),
        )
        self.admitted += 1

    async def _shed_inbound(self, writer: asyncio.StreamWriter, addr) -> None:
        """Refuse one over-budget inbound connection: typed ``__busy__``
        reply, loud (rate-limited) log line, flight-recorder event."""
        self.sheds += 1
        if self.sheds == 1 or self.sheds % 64 == 0:
            logger.warning(
                "connection budget reached (%d peers, max %d): shedding "
                "inbound connection from %s (%d shed so far)",
                len(self._peers), self.max_peers, addr, self.sheds,
            )
            obs_flight.record(
                "load_shed", where="connection", node=self.node_id[:8],
                peers=len(self._peers), max_peers=self.max_peers,
                sheds=self.sheds,
            )
        try:
            await self._send_frame(writer, asyncio.Lock(), {"type": "__busy__"})
        except (ConnectionError, OSError):
            pass  # the dialer is gone; the shed stands either way
        writer.close()

    def _register_peer(self, peer_id, reader, writer, host, port,
                       wire: str = "json", resume: bool = False) -> None:
        old = self._peers.pop(peer_id, None)
        if old is not None:
            old.writer.close()
            task = self._read_tasks.pop(peer_id, None)
            if task:
                task.cancel()
        peer = _Peer(peer_id, reader, _CorkedWriter(writer), host, port,
                     wire=wire, resume=resume)
        self._peers[peer_id] = peer
        self._addr[peer_id] = (host, port)
        self._intentional.discard(peer_id)
        self._read_tasks[peer_id] = asyncio.create_task(self._read_loop(peer))
        logger.info("peer %s connected (%s:%s, wire=%s)", peer_id[:8], host,
                    port, wire)
        self._fire_connection_event("connect", peer_id)

    async def disconnect_from_peer(self, peer_id: str,
                                   intentional: bool = True) -> None:
        """Drop a peer.  ``intentional=True`` (the default: a local request)
        additionally marks the peer as not-to-be-healed; transport-failure
        evictions pass False so session healing may redial."""
        if intentional:
            self._intentional.add(peer_id)
        peer = self._peers.pop(peer_id, None)
        task = self._read_tasks.pop(peer_id, None)
        if task:
            task.cancel()
        if peer is not None:
            peer.writer.close()
            self._fire_connection_event("disconnect", peer_id)

    # -- send ----------------------------------------------------------------

    async def send_message(self, peer_id: str, msg_type: str, **payload: Any) -> bool:
        """Send a JSON message; bytes values are transparently base64-tagged."""
        peer = self._peers.get(peer_id)
        if peer is None:
            logger.warning("send to unknown peer %s", peer_id[:8])
            return False
        # the send rides the caller's span chain (a handshake's net sends
        # interleave with its device dispatches in the flame graph); the
        # node scope attributes it to THIS node even when one process
        # hosts many (the swarm benches)
        with obs_trace.node_scope(self.node_id), \
                obs_trace.span("net.send", peer=peer_id[:8], msg_type=msg_type):
            # fault-injection boundary (faults/): a plan may drop, delay, or
            # corrupt this message BEFORE encoding — a no-op without a plan
            action, payload2 = _faults.net_send(self.node_id, peer_id, msg_type,
                                                payload)
            if action == "drop":
                return True  # swallowed by the (simulated) network
            if action == "delay":
                await asyncio.sleep(payload2)
            else:
                payload = payload2
            binary = peer.wire == _BIN_WIRE_NAME and not any(
                isinstance(v, (bytes, bytearray, memoryview))
                and len(v) > _BIN_MAX_FIELD
                for v in payload.values()
            )
            # ^ messages carrying a bytes value past the decoder's
            # per-field cap (huge file sends) fall back to the JSON wire
            # for THIS message — a bin1 peer accepts JSON frames at any
            # time, so the oversized transfer chunks through exactly as
            # before negotiation instead of being dropped as hostile
            if binary:
                # negotiated binary path: bytes values ride raw (no b64/hex
                # round-trip, no copy), everything else as per-field JSON
                message = {"type": msg_type, **payload}
            else:
                message = {"type": msg_type,
                           **{k: _encode_value(v) for k, v in payload.items()}}
            # cross-peer trace propagation: a bounded, ids-only ``_trace``
            # field (the net.send span's own context, so the receiver's
            # chain parents onto this exact send).  Correlation ids only —
            # never payload data.
            wire_ctx = obs_trace.wire_context()
            if wire_ctx is not None:
                message["_trace"] = wire_ctx
            try:
                if binary:
                    await self._send_frame_bin(peer.writer, peer.write_lock,
                                               message)
                else:
                    await self._send_frame(peer.writer, peer.write_lock, message)
                return True
            except (ConnectionError, OSError) as e:
                logger.warning("send to %s failed: %s; evicting", peer_id[:8], e)
                await self.disconnect_from_peer(peer_id, intentional=False)
                return False

    async def _send_frame(self, writer, lock: asyncio.Lock, message: dict) -> None:
        body = json.dumps(message, separators=(",", ":")).encode()
        async with lock:
            if len(body) <= self.chunk_size:
                writer.write(_HEADER.pack(_MAGIC, _VERSION, 0, len(body)) + body)
            else:
                stream_id = uuid.uuid4().bytes
                chunks = [
                    body[i : i + self.chunk_size]
                    for i in range(0, len(body), self.chunk_size)
                ]
                for idx, chunk in enumerate(chunks):
                    payload = _CHUNK_HEADER.pack(stream_id, idx, len(chunks)) + chunk
                    writer.write(
                        _HEADER.pack(_MAGIC, _VERSION, _FLAG_CHUNK, len(payload)) + payload
                    )
            await writer.drain()

    async def _send_frame_bin(self, writer, lock: asyncio.Lock,
                              message: dict) -> None:
        """Binary-wire twin of _send_frame: length-prefixed compact frames
        with raw-bytes pass-through.  A small frame's header and encoded
        segments go to the writer in one ``writelines`` call: the
        ciphertext bytes the AEAD produced are never concatenated,
        encoded, or copied on the way out (a peer's writer is corked, see
        :class:`_CorkedWriter`).  The reference writes each segment with
        its own ``write``; the bytes on the wire are the same."""
        segs = _encode_bin(message)
        total = sum(len(s) for s in segs)
        async with lock:
            if total <= self.chunk_size:
                writer.writelines(
                    [_HEADER.pack(_MAGIC, _VERSION, _FLAG_BIN, total), *segs])
            else:
                body = b"".join(segs)  # chunked path: slicing needs one buffer
                stream_id = uuid.uuid4().bytes
                chunks = [
                    body[i: i + self.chunk_size]
                    for i in range(0, len(body), self.chunk_size)
                ]
                for idx, chunk in enumerate(chunks):
                    payload = _CHUNK_HEADER.pack(stream_id, idx, len(chunks)) + chunk
                    writer.write(
                        _HEADER.pack(_MAGIC, _VERSION,
                                     _FLAG_CHUNK | _FLAG_BIN, len(payload))
                        + payload
                    )
            await writer.drain()

    # -- receive -------------------------------------------------------------

    async def _read_plain_frame(self, reader: asyncio.StreamReader) -> dict:
        flags, payload = await self._read_raw(reader)
        if flags & _FLAG_CHUNK:
            raise WireError("unexpected chunked hello")
        if flags & _FLAG_BIN:
            # the hello IS the negotiation; it always travels as JSON
            raise WireError("unexpected binary hello")
        return json.loads(payload)

    @staticmethod
    async def _read_raw(reader: asyncio.StreamReader) -> tuple[int, bytes]:
        header = await reader.readexactly(_HEADER.size)
        magic, version, flags, length = _HEADER.unpack(header)
        if magic != _MAGIC or version != _VERSION:
            raise WireError(f"bad frame header {header!r}")
        if length > MAX_FRAME:
            raise WireError(f"oversized frame ({length} bytes)")
        return flags, await reader.readexactly(length)

    def _decode_body(self, peer: _Peer, body, binary: bool) -> dict:
        """One logical frame body -> message dict; malformed input of
        either format is a typed WireError (the read loop's loud drop)."""
        if binary:
            if peer.wire != _BIN_WIRE_NAME:
                raise WireError("binary frame from un-negotiated peer")
            return _decode_bin(body)
        try:
            message = json.loads(body)
        except ValueError as e:
            raise WireError(f"malformed JSON frame: {e}") from e
        if not isinstance(message, dict):
            raise WireError("JSON frame is not an object")
        return message

    async def _read_loop(self, peer: _Peer) -> None:
        try:
            while True:
                flags, payload = await self._read_raw(peer.reader)
                chunks = 0
                binary = bool(flags & _FLAG_BIN)
                if flags & _FLAG_CHUNK:
                    reassembled = self._reassemble(peer, payload, binary)
                    if reassembled is None:
                        continue
                    message, chunks = reassembled
                else:
                    message = self._decode_body(peer, payload, binary)
                await self._dispatch(peer.peer_id, message, chunks)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        except WireError as e:
            # hostile or corrupt wire input: TYPED and loud — one warning,
            # one flight event, one counted connection drop.  The serving
            # loop and every other peer keep running (the finally below
            # evicts exactly this peer); the dialing side's session-heal
            # machinery may redial.
            self.wire_errors += 1
            logger.warning("wire error from %s: %s; dropping connection "
                           "(%d total)", peer.peer_id[:8], e, self.wire_errors)
            obs_flight.record("wire_error", node=self.node_id[:8],
                              peer=peer.peer_id[:8], error=str(e),
                              wire=peer.wire, total=self.wire_errors)
        except Exception:
            logger.exception("read loop error for %s", peer.peer_id[:8])
        finally:
            if self._peers.get(peer.peer_id) is peer:
                self._peers.pop(peer.peer_id, None)
                self._read_tasks.pop(peer.peer_id, None)
                peer.writer.close()
                self._fire_connection_event("disconnect", peer.peer_id)

    def _reassemble(self, peer: _Peer, payload: bytes,
                    binary: bool = False) -> tuple[dict, int] | None:
        """-> (message, chunk_count) once complete, None while partial.
        The chunk count rides into the dispatch's single ``net.recv`` span
        (``chunks=`` attr): the LOGICAL message gets one span linked to its
        handlers, not per-chunk spans with no edge to the dispatch."""
        if len(payload) < _CHUNK_HEADER.size:
            raise WireError("truncated chunk header")
        stream_id, index, count = _CHUNK_HEADER.unpack_from(payload)
        if count == 0 or index >= count:
            raise WireError(f"chunk index {index} out of range (count {count})")
        data = payload[_CHUNK_HEADER.size :]
        entry = peer.reassembly.setdefault(stream_id, {"count": count, "chunks": {}})
        if count != entry["count"]:
            raise WireError("chunk count changed mid-stream")
        entry["chunks"][index] = data
        if len(entry["chunks"]) < entry["count"]:
            return None
        del peer.reassembly[stream_id]
        body = b"".join(entry["chunks"][i] for i in range(count))
        return self._decode_body(peer, body, binary), count

    async def _dispatch(self, peer_id: str, message: dict,
                        chunks: int = 0) -> None:
        msg_type = message.get("type", "")
        # cross-peer propagation: adopt the sender's bounded _trace context
        # (validated — a malformed/hostile one is ignored and the receive
        # roots a fresh trace exactly as before).  Popped FIRST so handlers
        # never see the field: the wire protocol's payload surface is
        # unchanged for them, hostile or not.
        parent = obs_trace.adopt_wire_context(message.pop("_trace", None))
        decoded = {k: _decode_value(v) for k, v in message.items()}
        handlers = self._msg_handlers.get(msg_type, [])
        if not handlers:
            logger.debug("no handler for message type %r", msg_type)
        attrs = {"chunks": chunks} if chunks else {}
        # one receive span per LOGICAL message: handler work (and any
        # crypto dispatches it enqueues) correlates under it — and, with an
        # adopted parent, under the SENDER's trace (the initiator's
        # handshake and the responder's device dispatches become one tree)
        with obs_trace.node_scope(self.node_id), \
                obs_trace.span("net.recv", parent=parent, peer=peer_id[:8],
                               msg_type=msg_type, **attrs):
            for h in list(handlers):
                try:
                    await h(peer_id, decoded)
                except Exception:
                    logger.exception("handler for %r failed", msg_type)


def _encode_value(v: Any) -> Any:
    if isinstance(v, (bytes, bytearray)):
        return {"__b64__": base64.b64encode(bytes(v)).decode("ascii")}
    return v


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict) and set(v) == {"__b64__"}:
        return base64.b64decode(v["__b64__"])
    return v
