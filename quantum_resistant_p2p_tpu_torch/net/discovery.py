"""UDP broadcast peer discovery.

Counterpart of the JAX package's ``net/discovery.py`` (stdlib only), with
the same ``node_announcement`` datagram, so port and JAX-package nodes
discover each other.

Capability parity with the reference's networking/discovery.py (257 LoC):
periodic ``node_announcement`` JSON datagrams broadcast on a well-known UDP
port, direct unicast announcements for manual connects, staleness expiry,
local-IP detection via the UDP-connect trick, and manual peer registration.
"""

from __future__ import annotations

import asyncio
import json
import logging
import socket
import time
from typing import Callable

logger = logging.getLogger(__name__)

ANNOUNCE_INTERVAL = 60.0
STALE_AFTER = 300.0
DISCOVERY_PORT = 8001


def get_local_ip() -> str:
    """Best-effort local IP: open a UDP socket toward a public address."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


class NodeDiscovery:
    """Announce this node over UDP broadcast and track announcements from others."""

    def __init__(
        self,
        node_id: str,
        tcp_port: int,
        discovery_port: int = DISCOVERY_PORT,
        announce_interval: float = ANNOUNCE_INTERVAL,
    ):
        self.node_id = node_id
        self.tcp_port = tcp_port
        self.discovery_port = discovery_port
        self.announce_interval = announce_interval
        # peer_id -> {"host", "port", "last_seen"}
        self.known_nodes: dict[str, dict] = {}
        self._transport: asyncio.DatagramTransport | None = None
        self._tasks: list[asyncio.Task] = []
        self._on_discover: list[Callable[[str, str, int], None]] = []

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _DiscoveryProtocol(self),
            local_addr=("0.0.0.0", self.discovery_port),
            allow_broadcast=True,
        )
        # self._tasks is the strong reference keeping both loops alive (the
        # event loop itself only holds weak refs); the done-callback surfaces
        # a loop that dies unexpectedly — otherwise discovery would go silent
        # with the exception parked on the task until GC.
        self._tasks = [
            self._supervise(self._announce_loop(), "announce loop"),
            self._supervise(self._expiry_loop(), "expiry loop"),
        ]
        logger.info("discovery listening on UDP %d", self.discovery_port)

    def _supervise(self, coro, what: str) -> asyncio.Task:
        task = asyncio.create_task(coro)

        def _done(t: asyncio.Task) -> None:
            if not t.cancelled() and t.exception() is not None:
                logger.error("discovery %s died", what, exc_info=t.exception())

        task.add_done_callback(_done)
        return task

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        self._tasks = []
        if self._transport is not None:
            self._transport.close()
            self._transport = None

    # -- announcements ------------------------------------------------------

    def _announcement(self) -> bytes:
        return json.dumps(
            {
                "type": "node_announcement",
                "node_id": self.node_id,
                "ip": get_local_ip(),
                "port": self.tcp_port,
            }
        ).encode()

    async def _announce_loop(self) -> None:
        while True:
            try:
                if self._transport is not None:
                    self._transport.sendto(
                        self._announcement(), ("255.255.255.255", self.discovery_port)
                    )
            except OSError as e:
                logger.debug("broadcast failed: %s", e)
            await asyncio.sleep(self.announce_interval)

    async def _expiry_loop(self) -> None:
        while True:
            now = time.time()
            for node_id in [
                n
                for n, info in self.known_nodes.items()
                if now - info["last_seen"] > STALE_AFTER
            ]:
                logger.info("expiring stale peer %s", node_id[:8])
                del self.known_nodes[node_id]
            await asyncio.sleep(60.0)

    def announce_to(self, host: str, port: int | None = None) -> None:
        """Unicast announcement (manual connect flow)."""
        if self._transport is not None:
            self._transport.sendto(
                self._announcement(), (host, port or self.discovery_port)
            )

    def add_known_node(self, node_id: str, host: str, port: int) -> None:
        self.known_nodes[node_id] = {"host": host, "port": port, "last_seen": time.time()}
        self._fire(node_id, host, port)

    def on_discover(self, cb: Callable[[str, str, int], None]) -> None:
        self._on_discover.append(cb)

    def _fire(self, node_id: str, host: str, port: int) -> None:
        for cb in list(self._on_discover):
            try:
                cb(node_id, host, port)
            except Exception:
                logger.exception("discovery callback failed")

    def get_discovered_nodes(self) -> dict[str, dict]:
        return dict(self.known_nodes)

    # -- datagram ingress ----------------------------------------------------

    def _on_datagram(self, data: bytes, addr: tuple[str, int]) -> None:
        try:
            msg = json.loads(data)
        except (ValueError, UnicodeDecodeError):
            return
        if msg.get("type") != "node_announcement":
            return
        node_id = msg.get("node_id")
        if not node_id or node_id == self.node_id:
            return
        host = msg.get("ip") or addr[0]
        port = int(msg.get("port", 0))
        known = node_id in self.known_nodes
        self.add_known_node(node_id, host, port) if not known else self.known_nodes[
            node_id
        ].update({"host": host, "port": port, "last_seen": time.time()})


class _DiscoveryProtocol(asyncio.DatagramProtocol):
    def __init__(self, owner: NodeDiscovery):
        self.owner = owner

    def datagram_received(self, data: bytes, addr: tuple[str, int]) -> None:
        self.owner._on_datagram(data, addr)
