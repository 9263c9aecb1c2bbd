"""Fleet control-plane protocol: router <-> gateway, client -> router.

Counterpart of the JAX package's ``fleet/control.py`` (stdlib only), frame
for frame: the same dict goes out as the same bytes, so a port router and
a reference gateway (or the other way round) share one control link.

Reuses the port's net/p2p_node.py wire format (magic ``QP`` | version | flags |
u32 length | JSON payload) so fleet frames and peer frames share one
parser discipline, but control messages are small and NEVER chunked —
a chunk flag on a control frame is a protocol error.

Message types (all prefixed ``__gw_``/``__route`` so they can never
collide with application message types):

* ``__gw_hello__``     gateway -> router: registration (gateway id, the
                       P2P listen port peers dial, pid, and — when live
                       telemetry is armed — the gateway's own HTTP
                       telemetry port, so the router's ``/fleet`` view
                       and ``tools/qrtop.py`` can find every scrape).
* ``__gw_heartbeat__`` gateway -> router: liveness + the cross-process
                       SLO aggregation feed (cumulative probe totals,
                       device/fallback trip counters, admission stats,
                       the device-cost ledger totals the router sums
                       fleet-wide, and the telemetry port again).
* ``__gw_probe__``     router -> gateway: the HALF-OPEN canary.  A
                       gateway that missed heartbeats is a breaker-open
                       shard at fleet scope; one probe round-trip is the
                       evidence that lets it take ring ownership back.
* ``__gw_probe_ok__``  gateway -> router: probe reply (echoes ``n``).
* ``__gw_stek__``      router -> gateway: the fleet's session-ticket-
                       encryption keys (current + previous — the dual-key
                       rotation window), pushed on registration and on
                       every rotation.  ONE ring per fleet is what lets a
                       ticket minted by gw1 resume on gw2 after a handoff,
                       and on the respawned gw1 after a rolling restart.
                       The control link is the fleet's trusted channel
                       (localhost/pod-internal by construction — see
                       docs/fleet.md); key material never rides any
                       peer-facing or observability surface.
* ``__gw_drain__``     router -> gateway: GRACEFUL drain (also wired to
                       SIGTERM in the gateway): stop admitting (/readyz
                       goes 503 draining), flush outboxes, nudge peers to
                       resume on their ring successor (``ke_rehome``),
                       write the slo report, send ``__gw_bye__``, exit 0.
                       The planned half of a rolling restart — vs
                       ``__gw_stop__``, the fast teardown.
* ``__gw_stop__``      router -> gateway: drain and exit; the gateway
                       writes its per-node ``slo_report.json`` first.
* ``__gw_bye__``       gateway -> router: final stats before exit.
* ``__rt_lease__``     router -> router: leader-lease claim/renewal
                       (holder id, monotonic lease epoch, RELATIVE ttl —
                       each replica arms the deadline on its OWN clock,
                       so bounded skew shifts the window but never
                       inverts it).  Epochs only move forward; a frame
                       below the receiver's epoch is fenced as stale.
* ``__rt_sync__``      leader router -> follower routers: full authority
                       state replication on every change — the STEK ring
                       export (current + previous key, same dual-key
                       window the gateways hold), membership roster, and
                       the lease epoch that authorizes the frame.  This
                       is what lets ANY follower assume the lease without
                       losing the ticket accept window.  Router links are
                       the same trusted channel as the gateway control
                       link (localhost/pod-internal by construction).
* ``__rt_reject__``    router -> router: stale-lease fence.  Reply to an
                       authority frame whose epoch is below the
                       receiver's: carries the receiver's epoch so the
                       stale sender has PROOF a newer lease exists and
                       demotes loudly instead of split-braining.
* ``__route__``        client -> router: "which gateway serves peer X"
                       (``exclude`` lists gateways the client just
                       watched die — the router may already know).
* ``__route_ok__``     router -> client: gateway id + dial address.
* ``__busy__``         router -> client: fleet admission budget
                       exhausted — the SAME typed shed frame a gateway's
                       connection budget uses (net/p2p_node.py), so
                       clients treat both scopes with one retry policy.
* ``__no_route__``     router -> client: no non-quarantined gateway.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any

from ..net.p2p_node import _HEADER, _MAGIC, _VERSION, MAX_FRAME

GW_HELLO = "__gw_hello__"
GW_HEARTBEAT = "__gw_heartbeat__"
GW_PROBE = "__gw_probe__"
GW_PROBE_OK = "__gw_probe_ok__"
GW_TICKET_KEYS = "__gw_stek__"
GW_DRAIN = "__gw_drain__"
GW_STOP = "__gw_stop__"
GW_BYE = "__gw_bye__"
RT_LEASE = "__rt_lease__"
RT_SYNC = "__rt_sync__"
RT_REJECT = "__rt_reject__"
ROUTE = "__route__"
ROUTE_OK = "__route_ok__"
ROUTE_DONE = "__route_done__"
BUSY = "__busy__"
NO_ROUTE = "__no_route__"


async def send_ctrl(writer: asyncio.StreamWriter, message: dict) -> None:
    """Frame and send one control message (single frame, no chunking)."""
    body = json.dumps(message, separators=(",", ":")).encode()
    writer.write(_HEADER.pack(_MAGIC, _VERSION, 0, len(body)) + body)
    await writer.drain()


async def read_ctrl(reader: asyncio.StreamReader) -> dict:
    """Read one control frame; raises on malformed/chunked/oversized."""
    header = await reader.readexactly(_HEADER.size)
    magic, version, flags, length = _HEADER.unpack(header)
    if magic != _MAGIC or version != _VERSION or flags:
        raise ValueError(f"bad control frame header {header!r}")
    if length > MAX_FRAME:
        raise ValueError(f"oversized control frame ({length} bytes)")
    return json.loads(await reader.readexactly(length))


async def route_query(router_host: str, router_port: int, peer_id: str,
                      exclude: list[str] | None = None,
                      timeout: float = 5.0) -> dict[str, Any]:
    """One client-side route query: open, ask, read, close.

    Returns the reply dict (``type`` one of ROUTE_OK / BUSY / NO_ROUTE).
    Transport failures surface as exceptions — the storm harness's
    bounded retry loop owns the policy."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(router_host, router_port), timeout)
    try:
        await send_ctrl(writer, {"type": ROUTE, "peer_id": peer_id,
                                 "exclude": list(exclude or ())})
        return await asyncio.wait_for(read_ctrl(reader), timeout)
    finally:
        writer.close()


async def route_done(router_host: str, router_port: int, gateway: str,
                     timeout: float = 5.0) -> None:
    """Fire-and-forget session-end signal: releases the admission slot
    the matching route query claimed (best-effort — a lost done frame
    over-counts inflight only until the gateway's next heartbeat, whose
    reported connection count the router reconciles against)."""
    try:
        _reader, writer = await asyncio.wait_for(
            asyncio.open_connection(router_host, router_port), timeout)
    except (OSError, asyncio.TimeoutError):
        return
    try:
        await send_ctrl(writer, {"type": ROUTE_DONE, "gateway": gateway})
    except (ConnectionError, OSError):
        pass
    finally:
        writer.close()
