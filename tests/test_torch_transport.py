"""The port's transport (quantum_resistant_p2p_tpu_torch.net.p2p_node)
against the JAX package's ``net/p2p_node.py``, on the CPU.

The codecs and frames are held byte for byte to the reference over
messages generated from numpy seeds; hostile inputs raise the same
``WireError`` message in both; two port nodes talk over loopback, and a
port node and a reference node talk to each other in both directions over
both wire formats.  The same seeded ``FaultPlan`` gives the same injected
log for ``net.send`` in both, and the ``net.send`` / ``net.recv`` spans
chain across the wire as the reference's do.  Tolerance: exact.

Every socket binds to port 0 on 127.0.0.1 and every await runs under a
deadline (``_run``), so a stuck connection fails the test in seconds.
"""

from __future__ import annotations

import asyncio
import fcntl
import json
import platform
import random
import socket
import struct
import termios
import uuid

import numpy as np
import pytest

from quantum_resistant_p2p_tpu import faults as ref_faults
from quantum_resistant_p2p_tpu.net import p2p_node as ref_net
from quantum_resistant_p2p_tpu.obs import trace as ref_trace
from quantum_resistant_p2p_tpu_torch import faults
from quantum_resistant_p2p_tpu_torch.net import p2p_node as net
from quantum_resistant_p2p_tpu_torch.obs import trace

SIDES = {"port": net, "ref": ref_net}
#: the longest any networked test may take
DEADLINE_S = 8.0


def _run(coro, timeout: float = DEADLINE_S):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _message(rng: np.random.Generator, i: int) -> dict:
    """A message of raw, JSON and nested fields, sized from ``rng``."""
    msg = {"type": f"kind{i % 3}"}
    for f in range(int(rng.integers(0, 6))):
        kind = int(rng.integers(0, 4))
        n = int(rng.integers(0, 300))
        if kind == 0:
            msg[f"raw{f}"] = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        elif kind == 1:
            msg[f"num{f}"] = int(rng.integers(-2**31, 2**31))
        elif kind == 2:
            msg[f"txt{f}"] = "é" * (n % 17) + str(n)
        else:
            msg[f"obj{f}"] = {"a": [n, None, True], "b": {"c": n / 7}}
    return msg


def _plain(msg: dict) -> dict:
    return {k: bytes(v) if isinstance(v, memoryview) else v for k, v in msg.items()}


@pytest.mark.parametrize("seed", range(40, 46))
def test_bin_codec_is_byte_equal(seed):
    """Inputs: 40 messages from seed; exact (the encoded segments, and the
    decoded fields; raw fields decode as memoryviews in both)."""
    rng = np.random.default_rng(seed)
    for i in range(40):
        msg = _message(rng, i)
        segs = net._encode_bin(msg)
        assert segs == ref_net._encode_bin(msg)
        body = b"".join(segs)
        ours, theirs = net._decode_bin(body), ref_net._decode_bin(body)
        assert {k: type(v) for k, v in ours.items()} == {k: type(v) for k, v in theirs.items()}
        assert _plain(ours) == _plain(theirs) == msg


class _Writer:
    """A stream writer that keeps what is written, and counts the calls."""

    def __init__(self):
        self.out = bytearray()
        self.calls = 0

    def write(self, b):
        self.calls += 1
        self.out += b

    def writelines(self, bufs):
        self.calls += 1
        for b in bufs:
            self.out += b

    async def drain(self):
        return None


def _frames(mod, msg: dict, chunk_size: int, binary: bool) -> bytes:
    node = mod.P2PNode(node_id="frames", host="127.0.0.1", port=0, chunk_size=chunk_size)
    w = _Writer()
    send = node._send_frame_bin if binary else node._send_frame
    wire = {k: v for k, v in msg.items()} if binary else {
        k: mod._encode_value(v) for k, v in msg.items()}
    asyncio.run(send(w, asyncio.Lock(), wire))
    return bytes(w.out)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("seed,chunk_size", [(47, 64 * 1024), (48, 97), (49, 300)])
def test_json_binary_and_chunk_frames_are_byte_equal(monkeypatch, seed, chunk_size, binary):
    """Inputs: 12 messages from seed, framed at ``chunk_size`` (the small
    sizes chunk most of them) with the chunk stream ids from one seeded
    stream; exact (the bytes on the wire), and each side reassembles the
    other's frames to the message."""
    rng = np.random.default_rng(seed)
    msgs = [_message(rng, i) for i in range(12)]
    wires = {}
    for side, mod in SIDES.items():
        ids = random.Random(seed)
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=ids.getrandbits(128)))
        wires[side] = [_frames(mod, m, chunk_size, binary) for m in msgs]
    assert wires["port"] == wires["ref"]
    for mod in SIDES.values():
        node = mod.P2PNode(node_id="rx", host="127.0.0.1", port=0)
        peer = mod._Peer("tx", None, None, "127.0.0.1", 1, wire="bin1" if binary else "json")
        for m, frame in zip(msgs, wires["port"]):
            out, pos = None, 0
            while pos < len(frame):
                _, _, flags, length = mod._HEADER.unpack_from(frame, pos)
                payload = frame[pos + mod._HEADER.size: pos + mod._HEADER.size + length]
                pos += mod._HEADER.size + length
                if flags & mod._FLAG_CHUNK:
                    got = node._reassemble(peer, payload, binary)
                    out = got[0] if got is not None else None
                else:
                    out = node._decode_body(peer, payload, binary)
            decoded = {k: mod._decode_value(v) for k, v in _plain(out).items()}
            assert decoded == m


def test_a_small_binary_frame_is_one_transport_call():
    """The port hands a small bin1 frame to the transport in one call (the
    reference in one a segment), and each chunk of a big one in one."""
    msg = {"type": "secure_message", "ct": bytes(300), "n": 1, "ad": b"x"}
    node = net.P2PNode(node_id="frames", host="127.0.0.1", port=0, chunk_size=100)
    for chunk_size, calls in ((64 * 1024, 1), (100, 4)):
        node.chunk_size = chunk_size
        w = _Writer()
        asyncio.run(node._send_frame_bin(w, asyncio.Lock(), msg))
        assert w.calls == calls


def _bin(msg: dict) -> bytes:
    return b"".join(net._encode_bin(msg))


HOSTILE_BODIES = {
    "token": b"XX" + _bin({"type": "ping", "ct": b"x" * 32})[2:],
    "truncated-type": _bin({"type": "ping", "ct": b"x" * 32})[:5],
    "trailing": _bin({"type": "ping", "ct": b"x" * 32}) + b"garbage",
    "short-value": _bin({"type": "ping", "ct": b"x" * 32})[:-10],
    "oversized-field": (net._BIN_TOKEN + bytes([4]) + b"ping" + bytes([1]) + bytes([2]) + b"ct"
                        + bytes([0]) + (1 << 30).to_bytes(4, "big") + b"tiny"),
    "unknown-kind": (net._BIN_TOKEN + bytes([4]) + b"ping" + bytes([1]) + bytes([2]) + b"ct"
                     + bytes([7]) + (1).to_bytes(4, "big") + b"t"),
    "bad-json": (net._BIN_TOKEN + bytes([4]) + b"ping" + bytes([1]) + bytes([2]) + b"ct"
                 + bytes([1]) + (2).to_bytes(4, "big") + b"{x"),
    "bad-utf8": net._BIN_TOKEN + bytes([2]) + b"\xff\xfe" + bytes([0]),
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(HOSTILE_BODIES))
def test_hostile_binary_bodies_raise_the_same_wire_error(name):
    body = HOSTILE_BODIES[name]
    errors = []
    for mod in SIDES.values():
        with pytest.raises(mod.WireError) as e:
            mod._decode_bin(body)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


HOSTILE_FRAMES = {
    "oversized": net._HEADER.pack(net._MAGIC, net._VERSION, net._FLAG_BIN, 17 * 1024 * 1024),
    "bad-magic": net._HEADER.pack(b"ZZ", 1, 0, 0),
    "bad-version": net._HEADER.pack(net._MAGIC, 9, 0, 0),
    "truncated-chunk": (net._HEADER.pack(net._MAGIC, net._VERSION, net._FLAG_CHUNK, 5)
                        + b"short"),
    "chunk-range": (net._HEADER.pack(net._MAGIC, net._VERSION, net._FLAG_CHUNK,
                                     net._CHUNK_HEADER.size)
                    + net._CHUNK_HEADER.pack(b"s" * 16, 5, 2)),
    "json-not-object": net._HEADER.pack(net._MAGIC, net._VERSION, 0, 2) + b"[]",
    "json-malformed": net._HEADER.pack(net._MAGIC, net._VERSION, 0, 2) + b"{x",
    "bin-unnegotiated": (net._HEADER.pack(net._MAGIC, net._VERSION, net._FLAG_BIN,
                                          len(_bin({"type": "hi"}))) + _bin({"type": "hi"})),
}


@pytest.mark.parametrize("name", sorted(HOSTILE_FRAMES))
def test_hostile_frames_raise_the_same_wire_error(name):
    """A frame fed to each side's reader and decoder on a JSON connection;
    exact (the WireError message)."""
    frame = HOSTILE_FRAMES[name]
    errors = []
    for mod in SIDES.values():
        async def read():
            reader = asyncio.StreamReader()
            reader.feed_data(frame)
            reader.feed_eof()
            node = mod.P2PNode(node_id="rx", host="127.0.0.1", port=0)
            peer = mod._Peer("tx", reader, None, "127.0.0.1", 1)
            flags, payload = await node._read_raw(reader)
            if flags & mod._FLAG_CHUNK:
                return node._reassemble(peer, payload, bool(flags & mod._FLAG_BIN))
            return node._decode_body(peer, payload, bool(flags & mod._FLAG_BIN))

        with pytest.raises(mod.WireError) as e:
            _run(read())
        errors.append(str(e.value))
    assert errors[0] == errors[1]


async def _connect(a, b, b_id: str) -> None:
    """``a`` dials ``b`` and both registries list the other."""
    assert await a.connect_to_peer("127.0.0.1", b.port, timeout=2.0, retries=0) == b_id
    while not b.is_connected(a.node_id):
        await asyncio.sleep(0.005)


def _inbox(node, msg_type: str) -> asyncio.Queue:
    q: asyncio.Queue = asyncio.Queue()

    async def handler(peer_id, msg):
        q.put_nowait((peer_id, msg))

    node.register_message_handler(msg_type, handler)
    return q


@pytest.mark.parametrize("env,expect", [("1", "bin1"), ("0", "json")])
def test_two_port_nodes_hello_chunk_disconnect_and_reconnect(monkeypatch, env, expect):
    """QRP2P_BINARY_WIRE on or off: the negotiated format, a bytes message,
    one above ``chunk_size``, the disconnect fan-out on both sides, then
    ``reconnect`` (seeded jitter) and a message on the new connection."""
    monkeypatch.setenv("QRP2P_BINARY_WIRE", env)

    async def main():
        a = net.P2PNode("node-a", "127.0.0.1", 0, chunk_size=1024,
                        jitter_rng=random.Random(50))
        b = net.P2PNode("node-b", "127.0.0.1", 0, chunk_size=1024)
        events = []
        a.register_connection_handler(lambda ev, p: events.append(("a", ev, p)))
        b.register_connection_handler(lambda ev, p: events.append(("b", ev, p)))
        inbox = _inbox(b, "data")
        await a.start()
        await b.start()
        try:
            await _connect(a, b, "node-b")
            wires = (a.peer_wire_format("node-b"), b.peer_wire_format("node-a"))
            big = bytes(np.random.default_rng(51).integers(0, 256, 5000, dtype=np.uint8))
            assert await a.send_message("node-b", "data", blob=b"small", n=1)
            assert await a.send_message("node-b", "data", blob=big, n=2)
            got = [await inbox.get() for _ in range(2)]
            await a.disconnect_from_peer("node-b", intentional=False)
            while b.is_connected("node-a"):
                await asyncio.sleep(0.005)
            assert a.should_heal("node-b")
            assert await a.reconnect("node-b", timeout=2.0, retries=0)
            while not b.is_connected("node-a"):
                await asyncio.sleep(0.005)
            assert await a.send_message("node-b", "data", blob=b"again", n=3)
            got.append(await inbox.get())
            return wires, got, list(events)
        finally:
            await a.stop()
            await b.stop()

    wires, got, events = _run(main())
    assert wires == (expect, expect)
    assert [(p, bytes(m["blob"]), m["n"]) for p, m in got] == [
        ("node-a", b"small", 1), ("node-a", bytes(np.random.default_rng(51).integers(
            0, 256, 5000, dtype=np.uint8)), 2), ("node-a", b"again", 3)]
    assert events[:4] == [("b", "connect", "node-a"), ("a", "connect", "node-b"),
                          ("a", "disconnect", "node-b"), ("b", "disconnect", "node-a")] or \
        events[:4] == [("a", "connect", "node-b"), ("b", "connect", "node-a"),
                       ("a", "disconnect", "node-b"), ("b", "disconnect", "node-a")]
    assert sorted(events[4:6]) == [("a", "connect", "node-b"), ("b", "connect", "node-a")]


@pytest.mark.parametrize("dialer", ["port", "ref"])
@pytest.mark.parametrize("binary", [True, False])
def test_port_and_reference_nodes_interoperate(dialer, binary):
    """A port node and a reference node, either one dialing, over bin1 or
    JSON: the negotiated format on both sides, and bytes, JSON and a
    chunked message each way arrive as sent."""
    big = bytes(np.random.default_rng(52).integers(0, 256, 3000, dtype=np.uint8))

    async def main():
        nodes = {"port": net.P2PNode("port-node", "127.0.0.1", 0, chunk_size=1024,
                                     binary_wire=binary),
                 "ref": ref_net.P2PNode("ref-node", "127.0.0.1", 0, chunk_size=1024,
                                        binary_wire=binary)}
        listener = "ref" if dialer == "port" else "port"
        inbox = {s: _inbox(n, "data") for s, n in nodes.items()}
        for n in nodes.values():
            await n.start()
        try:
            await _connect(nodes[dialer], nodes[listener], nodes[listener].node_id)
            fmt = {s: n.peer_wire_format(nodes["ref" if s == "port" else "port"].node_id)
                   for s, n in nodes.items()}
            got = {}
            for src, dst in (("port", "ref"), ("ref", "port")):
                to = nodes[dst].node_id
                assert await nodes[src].send_message(to, "data", blob=b"\x00\x01hi", meta={
                    "from": src, "n": [1, 2]})
                assert await nodes[src].send_message(to, "data", blob=big, meta=None)
                got[dst] = [await inbox[dst].get() for _ in range(2)]
            return fmt, got
        finally:
            for n in nodes.values():
                await n.stop()

    fmt, got = _run(main())
    want = "bin1" if binary else "json"
    assert fmt == {"port": want, "ref": want}
    for dst, src in (("ref", "port"), ("port", "ref")):
        (p1, m1), (p2, m2) = got[dst]
        assert p1 == p2 == f"{src}-node"
        assert bytes(m1["blob"]) == b"\x00\x01hi" and m1["meta"] == {"from": src, "n": [1, 2]}
        assert bytes(m2["blob"]) == big and m2["meta"] is None
        assert isinstance(m1["blob"], memoryview if binary else bytes)


#: how long the receiver of a burst waits for its last message
BURST_WAIT_S = 5.0


def _segment_sender(raw: bool):
    """The reference's send of a small bin1 frame, as a stand-in for the
    port's: the header and each encoded segment in a ``write`` of its own,
    into the peer's corked writer, or with ``raw`` straight to the stream
    writer under it (the segmentation the reference's node gives TCP)."""
    async def send(self, writer, lock, message):
        segs = net._encode_bin(message)
        out = writer._writer if raw else writer
        async with lock:
            out.write(net._HEADER.pack(net._MAGIC, net._VERSION, net._FLAG_BIN,
                                       sum(len(s) for s in segs)))
            for seg in segs:
                out.write(seg)
            await writer.drain()

    return send


def _stall_report(tx, rx) -> str:
    """Where the bytes of a burst that did not arrive are: the sender's
    transport buffer and TCP state (Linux ``TCP_INFO``: the congestion
    state, 3 = loss recovery, and the window), and what the receiver holds
    unread in its socket and its stream reader."""
    sender, receiver = tx._peers["rx"].writer, rx._peers["tx"]
    try:
        info = sender.transport.get_extra_info("socket").getsockopt(
            socket.IPPROTO_TCP, socket.TCP_INFO, 104)
        tcp = f"ca_state {info[1]}, cwnd {struct.unpack_from('I', info, 80)[0]}"
    except OSError as e:
        tcp = f"TCP_INFO unavailable ({e})"
    try:
        fd = receiver.writer.transport.get_extra_info("socket").fileno()
        unread = struct.unpack("i", fcntl.ioctl(fd, termios.FIONREAD, bytes(4)))[0]
    except OSError as e:
        unread = f"unknown ({e})"
    return (f"kernel {platform.release()}; "
            f"sender: {sender.transport.get_write_buffer_size()} B buffered, {tcp}; "
            f"receiver: {unread} B unread in the socket, {len(receiver.reader._buffer)} B in "
            "the stream reader")


@pytest.mark.parametrize("style,n", [("port", 1024), ("segments", 1024), ("uncorked", 1024),
                                     ("reference", 1024), ("port", 4096)])
def test_a_burst_of_bin1_messages_arrives_whole_and_in_order(monkeypatch, style, n):
    """Inputs: ``n`` frames of 284 bytes (a sealed 256-byte message) from
    seed 58, sent back to back over bin1 with no yield between sends, as
    chip_smoke.py's phase 15 sends 1024; exact (every one arrives, in
    order, within the deadline).  ``port`` is the port's send;
    ``segments`` writes the header and each segment with its own
    ``write``, as the reference's send does, into the port's corked
    writer; ``uncorked`` does so straight to the stream writer (on a
    user-space TCP stack that burst stalls: PERF.md); ``reference`` is a reference node sending to a port node.  Through the
    cork the burst reaches the transport in at most n / 32 sends."""
    frames = [bytes(r) for r in np.random.default_rng(58).integers(
        0, 256, (n, 284), dtype=np.uint8)]
    if style in ("segments", "uncorked"):
        monkeypatch.setattr(net.P2PNode, "_send_frame_bin", _segment_sender(style == "uncorked"))

    async def main():
        sender = (ref_net if style == "reference" else net).P2PNode("tx", "127.0.0.1", 0)
        receiver = net.P2PNode("rx", "127.0.0.1", 0)
        got = []

        async def on(peer_id, msg):
            got.append((msg["i"], bytes(msg["frame"])))

        receiver.register_message_handler("secure_message", on)
        await sender.start()
        await receiver.start()
        try:
            await _connect(sender, receiver, "rx")
            assert sender.peer_wire_format("rx") == "bin1"
            for i, f in enumerate(frames):
                assert await sender.send_message("rx", "secure_message", i=i, frame=f)
            t0 = asyncio.get_running_loop().time()
            while len(got) < n and asyncio.get_running_loop().time() - t0 < BURST_WAIT_S:
                await asyncio.sleep(0.005)
            report = _stall_report(sender, receiver) if len(got) < n else ""
            return got, getattr(sender._peers["rx"].writer, "flushes", None), report
        finally:
            await sender.stop()
            await receiver.stop()

    got, flushes, report = _run(main())
    assert len(got) == n, f"{len(got)} of {n} arrived within {BURST_WAIT_S} s; {report}"
    assert got == list(enumerate(frames))
    if style in ("port", "segments"):
        assert flushes <= n // 32


def test_a_corked_writer_sends_what_it_holds_before_closing():
    """Frames written just before ``close`` are handed to the transport,
    in order, in one call; a burst is handed over in sends of at most
    CORK_BYTES / CORK_BUFFERS; an empty write is dropped."""
    class Raw:
        def __init__(self):
            self.calls, self.closed = [], False

        def writelines(self, bufs):
            self.calls.append([bytes(b) for b in bufs])

        def is_closing(self):
            return self.closed

        def close(self):
            self.closed = True

    async def main():
        raw = Raw()
        w = net._CorkedWriter(raw)
        w.write(b"a")
        w.writelines([b"b", b"", memoryview(b"cd")])
        w.close()
        closed = list(raw.calls)
        raw = Raw()
        w = net._CorkedWriter(raw)
        for i in range(net.CORK_BUFFERS + 3):
            w.write(bytes([i % 256]))
        big = bytes(net.CORK_BYTES)
        w.write(big)
        await asyncio.sleep(0)
        return closed, [len(c) for c in raw.calls], w.flushes

    closed, sizes, flushes = _run(main())
    assert closed == [[b"a", b"b", b"cd"]]
    assert sizes == [net.CORK_BUFFERS, 4] and flushes == 2


def test_net_send_fault_log_matches(monkeypatch):
    """One seeded plan on each side: drop the 2nd message, corrupt the
    4th, delay the 6th; exact (the injected log, and what arrives)."""
    def plan(mod):
        return mod.FaultPlan(53, [
            mod.FaultRule("net.send", "drop", match={"msg_type": "data"}, nth=2),
            mod.FaultRule("net.send", "corrupt", match={"msg_type": "data"}, nth=4),
            mod.FaultRule("net.send", "delay", match={"msg_type": "data"}, nth=6, delay_s=0.01)])

    out = {}
    for side, (mod, fmod) in {"port": (net, faults), "ref": (ref_net, ref_faults)}.items():
        p = plan(fmod)

        async def main():
            a = mod.P2PNode("node-a", "127.0.0.1", 0)
            b = mod.P2PNode("node-b", "127.0.0.1", 0)
            inbox = _inbox(b, "data")
            await a.start()
            await b.start()
            try:
                await _connect(a, b, "node-b")
                with p.activate():
                    for i in range(7):
                        assert await a.send_message("node-b", "data", i=i,
                                                    ct=bytes(range(i, i + 16)))
                got = []
                while len(got) < 6:
                    got.append(await inbox.get())
                return [(m["i"], bytes(m["ct"])) for _, m in got]
            finally:
                await a.stop()
                await b.stop()

        out[side] = (_run(main()), p.injected)
    assert out["port"] == out["ref"]
    got, injected = out["port"]
    assert [e["action"] for e in injected] == ["drop", "corrupt", "delay"]
    assert [i for i, _ in got] == [0, 2, 3, 4, 5, 6]
    assert got[2][1] != bytes(range(3, 19)) and got[0][1] == bytes(range(16))


def _span_view(records):
    index = {r["span_id"]: r for r in records}
    return sorted((r["name"], r["attrs"].get("msg_type"), r.get("node"),
                   index[r["parent_id"]]["name"] if r["parent_id"] in index else None)
                  for r in records)


def test_send_and_recv_spans_chain_across_the_wire(monkeypatch):
    """A root span on A around two sends; B's handler opens a span.  Exact
    (span names, message types, nodes and parents); every net.recv is
    parented on the net.send whose frame carried it, in the sender's
    trace."""
    views = {}
    for side, (mod, tmod) in {"port": (net, trace), "ref": (ref_net, ref_trace)}.items():
        tracer = tmod.Tracer()
        monkeypatch.setattr(tmod, "TRACER", tracer)

        async def main():
            a = mod.P2PNode("node-a", "127.0.0.1", 0)
            b = mod.P2PNode("node-b", "127.0.0.1", 0)
            done: asyncio.Queue = asyncio.Queue()

            async def handler(peer_id, msg):
                with tmod.span("handle", kind=msg["k"]):
                    done.put_nowait(msg["k"])

            b.register_message_handler("data", handler)
            await a.start()
            await b.start()
            try:
                await _connect(a, b, "node-b")
                with tmod.span("session"):
                    for k in range(2):
                        assert await a.send_message("node-b", "data", k=k)
                return [await done.get() for _ in range(2)]
            finally:
                await a.stop()
                await b.stop()

        assert _run(main()) == [0, 1]
        records = tracer.snapshot()
        sends = {r["span_id"]: r for r in records if r["name"] == "net.send"}
        recvs = [r for r in records if r["name"] == "net.recv"]
        assert len(sends) == len(recvs) == 2
        assert all(r["parent_id"] in sends and r["trace_id"] == sends[r["parent_id"]]["trace_id"]
                   for r in recvs)
        views[side] = _span_view(records)
    assert views["port"] == views["ref"]


def test_inbound_over_budget_is_shed_with_busy():
    """``max_peers=1``: a second dialer gets the typed busy reply, counted
    on both sides; exact against the reference's counters."""
    counts = {}
    for side, mod in SIDES.items():
        async def main():
            hub = mod.P2PNode("hub", "127.0.0.1", 0, max_peers=1)
            c1 = mod.P2PNode("c1", "127.0.0.1", 0)
            c2 = mod.P2PNode("c2", "127.0.0.1", 0)
            for n in (hub, c1, c2):
                await n.start()
            try:
                await _connect(c1, hub, "hub")
                assert await c2.connect_to_peer("127.0.0.1", hub.port, timeout=2.0,
                                                retries=0) is None
                return hub.sheds, hub.admitted, c2.busy_rejects, hub.get_peers()
            finally:
                for n in (hub, c1, c2):
                    await n.stop()

        counts[side] = _run(main())
    assert counts["port"] == counts["ref"] == (1, 1, 1, ["c1"])


def test_hello_payloads_and_env_defaults_match(monkeypatch):
    for wire_env in ("0", "1"):
        for resume_env in ("0", "1"):
            monkeypatch.setenv("QRP2P_BINARY_WIRE", wire_env)
            monkeypatch.setenv("QRP2P_RESUMPTION", resume_env)
            hellos = [json.dumps(mod.P2PNode("n", "127.0.0.1", 7)._hello()) for mod in
                      SIDES.values()]
            assert hellos[0] == hellos[1]
            assert net.binary_wire_default() == ref_net.binary_wire_default() == (wire_env == "1")
            assert net.resumption_offer_default() == (resume_env == "1")
    jitter = [[mod.P2PNode("peer00042", "127.0.0.1", 0)._reconnect_jitter() for _ in range(3)]
              for mod in SIDES.values()]
    assert jitter[0] == jitter[1] and all(0 <= j < net.RECONNECT_JITTER_S for j in jitter[0])
