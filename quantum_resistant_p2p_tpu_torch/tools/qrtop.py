"""qrtop — a terminal dashboard over the fleet's live telemetry endpoints.

Counterpart of the JAX package's ``tools/qrtop.py``: it scrapes the port's
``obs/http.py`` routes of each gateway and the ``/fleet`` view of each port
router (fleet/manager.py, fleet/router.py), which carry the same documents.

Polls N per-gateway telemetry surfaces (``/healthz``, ``/readyz``,
``/cost``, ``/slo``, ``/metrics.json``) and renders one row per gateway:
handshakes/s, shed rate, SLO burn, breaker/shard states, padding-waste
fraction, and warm-up activity (the cost ledger's compile events) — the
serving-cost economics as a top(1)-style loop instead of a post-hoc
artifact.

Endpoints come from the command line (``host:port`` or
``name=host:port``) or are discovered from a fleet router's aggregated
``/fleet`` view (``--fleet host:port`` — the manager announces each
gateway's telemetry port from its hello/heartbeats).  With a REPLICATED
control plane (fleet/router.py), pass ``--fleet`` once per router:
discovery falls back across the replicas (any one reachable is enough),
and each router renders as its own row with a ROLE column
(leader/follower/demoted — the live lease view).

``--snapshot`` takes ONE poll and emits the JSON document instead of
rendering — the artifact mode.

Stdlib-only (urllib + json): runs wherever the gateways do.

Usage::

    python -m quantum_resistant_p2p_tpu_torch.tools.qrtop 127.0.0.1:9100 gw1=127.0.0.1:9101
    python -m quantum_resistant_p2p_tpu_torch.tools.qrtop --fleet 127.0.0.1:9000 --interval 2
    python -m quantum_resistant_p2p_tpu_torch.tools.qrtop --fleet 127.0.0.1:9000 --snapshot \
        --out snap.json
    python -m quantum_resistant_p2p_tpu_torch.tools.qrtop --fleet 127.0.0.1:9000 \
        --fleet 127.0.0.1:9001
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Any

#: per-request scrape timeout: a dead gateway must cost one bounded wait,
#: never hang the dashboard loop
SCRAPE_TIMEOUT_S = 3.0


def fetch_json(base: str, path: str,
               timeout: float = SCRAPE_TIMEOUT_S) -> dict[str, Any] | None:
    """GET ``http://{base}{path}`` as JSON; None when unreachable or
    malformed (a dead gateway is a row that says so, not a crash).
    Non-200 readiness replies still carry a JSON body — parse them."""
    try:
        with urllib.request.urlopen(f"http://{base}{path}",
                                    timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read())
        except (ValueError, OSError):
            return None
    except (OSError, ValueError):
        return None


def _sum_compiles(cost: dict[str, Any]) -> tuple[int, float]:
    events = seconds = 0
    for row in (cost.get("compiles") or {}).values():
        events += row.get("events") or 0
        seconds += row.get("seconds") or 0.0
    return events, round(seconds, 3)


def _opcache_rates(cost: dict[str, Any]) -> dict[str, Any]:
    return {kind: c.get("window_hit_rate")
            for kind, c in (cost.get("opcaches") or {}).items()}


def scrape_gateway(name: str, base: str) -> dict[str, Any]:
    """One gateway's dashboard row, from its live endpoints."""
    health = fetch_json(base, "/healthz")
    if health is None:
        return {"gateway": name, "endpoint": base, "reachable": False}
    ready = fetch_json(base, "/readyz") or {}
    cost = fetch_json(base, "/cost") or {}
    slo = fetch_json(base, "/slo") or {}
    snap = fetch_json(base, "/metrics.json") or {}
    counters = snap.get("counters") or {}
    queues = (snap.get("collected") or {}).get("queues") or {}
    uptime = float(health.get("uptime_s") or 0.0)
    # both halves of the handshake work: a pure gateway only RESPONDS,
    # so its rate lives in the admitted count, not the initiator one
    handshakes = (int(health.get("handshake_attempts") or 0)
                  + int(health.get("handshakes_admitted") or 0))
    compile_events, compile_seconds = _sum_compiles(cost)
    burns = {s.get("name"): s.get("burn_fast")
             for s in (slo.get("specs") or [])}
    return {
        "gateway": name,
        "endpoint": base,
        "reachable": True,
        "node": health.get("node"),
        "uptime_s": round(uptime, 3),
        "ready": bool(ready.get("ready")),
        # a draining gateway (503 /readyz with the reason) renders as the
        # DRAIN state: a rolling restart is visible live, gateway by
        # gateway, instead of reading as mystery unreadiness
        "draining": bool(ready.get("draining")),
        "drain_reason": ready.get("drain_reason"),
        "breakers": ready.get("breakers") or {},
        "handshakes": handshakes,
        "handshake_attempts": int(health.get("handshake_attempts") or 0),
        "hs_per_s": round(handshakes / uptime, 3) if uptime > 0 else None,
        "handshake_sheds": counters.get("handshake_sheds"),
        "handshakes_admitted": counters.get("handshakes_admitted"),
        "bulk_sheds": counters.get("bulk_sheds"),
        "device_served_fraction": queues.get("device_served_fraction"),
        "breaker_state": queues.get("breaker_state"),
        "padding_waste_fraction": cost.get("padding_waste_fraction"),
        "device_seconds_total": cost.get("device_seconds_total"),
        "device_seconds_per_1k_handshakes":
            cost.get("device_seconds_per_1k_handshakes"),
        "compile_events": compile_events,
        "compile_seconds": compile_seconds,
        "recent_compiles": (cost.get("recent_compiles") or [])[-3:],
        "opcache_window_hit_rate": _opcache_rates(cost),
        "tuner_journal_len": cost.get("tuner_journal_len"),
        "slo_alerting": slo.get("alerting") or [],
        "burn_fast": burns,
    }


def scrape_router(name: str, base: str) -> dict[str, Any]:
    """One ROUTER replica's dashboard row, from its ``/fleet`` view: the
    live lease role (leader/follower/demoted), epoch/holder, and the
    control-plane counters — a demoted or dead replica is a visible row,
    the whole point of watching a failover live."""
    doc = fetch_json(base, "/fleet")
    router = (doc or {}).get("router") or {}
    if not router:
        return {"router": name, "endpoint": base, "reachable": False}
    lease = router.get("lease") or {}
    return {
        "router": str(router.get("router_id") or name),
        "endpoint": base,
        "reachable": True,
        "role": lease.get("role"),
        "epoch": lease.get("epoch"),
        "holder": lease.get("holder"),
        "standalone": bool(lease.get("standalone")),
        "gateways": router.get("gateways"),
        "routes_ok": router.get("routes_ok"),
        "route_sheds": router.get("route_sheds"),
        "stek_rotations": router.get("stek_rotations"),
        "lease_rejects": router.get("lease_rejects"),
        "lease_fenced": router.get("lease_fenced"),
        "syncs_applied": router.get("syncs_applied"),
    }


def snapshot_endpoints(endpoints: dict[str, str],
                       routers: dict[str, str] | None = None
                       ) -> dict[str, Any]:
    """One-shot scrape of every endpoint — the ``--snapshot`` document
    (a storm's ``scrape_cb`` can call it while the gateways are live)."""
    doc: dict[str, Any] = {
        "tool": "qrtop --snapshot",
        "endpoints": dict(endpoints),
        "gateways": {name: scrape_gateway(name, base)
                     for name, base in sorted(endpoints.items())},
    }
    if routers:
        doc["routers"] = {name: scrape_router(name, base)
                          for name, base in sorted(routers.items())}
    return doc


def discover_fleet(routers: list[str]) -> tuple[dict[str, str],
                                                dict[str, str]]:
    """Gateway + router telemetry endpoints from the replicas' ``/fleet``
    views, falling back across ``routers`` — with a replicated control
    plane any ONE reachable replica can describe the whole fleet, so a
    dead leader must not blind the dashboard.  Returns
    ``(gateway_endpoints, router_endpoints)``; raises only when every
    replica is unreachable."""
    gw_eps: dict[str, str] = {}
    rt_eps: dict[str, str] = {}
    any_reachable = False
    for i, router in enumerate(routers):
        doc = fetch_json(router, "/fleet")
        host = router.rsplit(":", 1)[0]
        if doc is None:
            rt_eps.setdefault(f"rt?{i}", router)
            continue
        any_reachable = True
        rview = doc.get("router") or {}
        rt_eps[str(rview.get("router_id") or f"rt{i}")] = router
        for member in (rview.get("members") or []):
            port = member.get("telemetry_port")
            if port:
                # first reachable replica wins per gateway (they all
                # describe the same announced ports)
                gw_eps.setdefault(str(member.get("gateway")),
                                  f"{host}:{port}")
    if not any_reachable:
        raise SystemExit("qrtop: no /fleet view at any of "
                         + ", ".join(f"http://{r}" for r in routers))
    return gw_eps, rt_eps


# -- live rendering ------------------------------------------------------------


def _fmt(v: Any, pct: bool = False) -> str:
    if v is None:
        return "-"
    if pct:
        return f"{v * 100:.1f}%"
    if isinstance(v, float):
        return f"{v:.2f}"
    return str(v)


def render_routers(rows: list[dict[str, Any]]) -> str:
    """The control-plane header block: one line per router replica with
    its live lease ROLE — a failover reads as the leader row going
    unreachable and a follower row flipping to leader; a split-brain
    averted reads as a demoted row."""
    cols = ("ROUTER", "ROLE", "EPOCH", "HOLDER", "GWS", "ROUTES", "SHED",
            "SYNCS", "FENCED")
    lines = ["  ".join(f"{c:<10}" for c in cols)]
    for row in rows:
        name = row["router"]
        if not row.get("reachable"):
            lines.append(f"{name:<10}  [unreachable: {row['endpoint']}]")
            continue
        role = ("standalone" if row.get("standalone")
                else row.get("role") or "-")
        vals = (name, role, _fmt(row.get("epoch")),
                row.get("holder") or "-", _fmt(row.get("gateways")),
                _fmt(row.get("routes_ok")), _fmt(row.get("route_sheds")),
                _fmt(row.get("syncs_applied")), _fmt(row.get("lease_fenced")))
        lines.append("  ".join(f"{v:<10}" for v in vals))
    return "\n".join(lines)


def render(rows: list[dict[str, Any]], prev: dict[str, dict[str, Any]],
           elapsed: float) -> str:
    """One dashboard frame.  hs/s comes from the poll-to-poll delta over
    the REAL elapsed seconds when a previous sample exists (the live
    rate), else the uptime average."""
    cols = ("GATEWAY", "UP(s)", "STATE", "RDY", "HS", "HS/S", "SHED",
            "WASTE", "COMP(n/s)", "OPCACHE", "BURN", "BREAKERS")
    lines = ["  ".join(f"{c:<10}" for c in cols)]
    for row in rows:
        name = row["gateway"]
        if not row.get("reachable"):
            lines.append(f"{name:<10}  [unreachable: {row['endpoint']}]")
            continue
        last = prev.get(name)
        if last and elapsed > 0:
            hs_rate = (row["handshakes"]
                       - last.get("handshakes", 0)) / elapsed
        else:
            hs_rate = row.get("hs_per_s")
        sheds = sum(row.get(k) or 0 for k in
                    ("handshake_sheds", "bulk_sheds"))
        comp = f"{row['compile_events']}/{row['compile_seconds']:.1f}"
        opc = ",".join(f"{k}:{_fmt(v, pct=True)}" for k, v in
                       sorted(row["opcache_window_hit_rate"].items())) or "-"
        burn = max((b for b in row["burn_fast"].values()
                    if isinstance(b, (int, float))), default=None)
        breakers = ",".join(f"{k}:{v}" for k, v in
                            sorted(row["breakers"].items())) or "-"
        alert = "!" if row["slo_alerting"] else ""
        # DRAIN makes a rolling restart legible live; otherwise the
        # state is simply whether the gateway serves (run) or not
        state = "DRAIN" if row.get("draining") else "run"
        vals = (name, _fmt(row["uptime_s"]), state,
                "y" if row["ready"] else "N",
                str(row["handshakes"]), _fmt(hs_rate), str(sheds),
                _fmt(row["padding_waste_fraction"], pct=True), comp, opc,
                _fmt(burn) + alert, breakers)
        lines.append("  ".join(f"{v:<10}" for v in vals))
    return "\n".join(lines)


def live_loop(endpoints: dict[str, str], interval: float,
              iterations: int | None = None, out=sys.stdout,
              routers: dict[str, str] | None = None) -> None:
    prev: dict[str, dict[str, Any]] = {}
    prev_t: float | None = None
    n = 0
    while iterations is None or n < iterations:
        router_rows = [scrape_router(name, base)
                       for name, base in sorted((routers or {}).items())]
        rows = [scrape_gateway(name, base)
                for name, base in sorted(endpoints.items())]
        # rates divide by the REAL elapsed time since the last frame, not
        # the nominal interval — the serial scrape itself takes time (up
        # to timeout x endpoints when a gateway is black-holed), and
        # dividing by the nominal interval would inflate HS/S by exactly
        # that slippage
        now = time.monotonic()
        elapsed = (now - prev_t) if prev_t is not None else 0.0
        prev_t = now
        frame = render(rows, prev, elapsed)
        if router_rows:
            frame = render_routers(router_rows) + "\n\n" + frame
        # ANSI home+clear keeps it a flicker-free top(1)-style refresh
        out.write("\x1b[H\x1b[2J" if out.isatty() else "")
        out.write(time.strftime("qrtop  %H:%M:%S") + f"  ({len(rows)} "
                  "gateway(s))\n" + frame + "\n")
        out.flush()
        prev = {r["gateway"]: r for r in rows if r.get("reachable")}
        n += 1
        if iterations is not None and n >= iterations:
            break
        time.sleep(interval)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("endpoints", nargs="*",
                    help="gateway telemetry endpoints: host:port or "
                         "name=host:port")
    ap.add_argument("--fleet", action="append", default=None,
                    help="router telemetry host:port — discover gateway "
                         "endpoints from its /fleet view; repeat once per "
                         "replica (HA control plane): discovery falls "
                         "back across them and each renders a ROLE row")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll interval (seconds) in live mode")
    ap.add_argument("--iterations", type=int, default=None,
                    help="stop after N frames (default: run until ^C)")
    ap.add_argument("--snapshot", action="store_true",
                    help="one poll, JSON document to stdout (artifact mode)")
    ap.add_argument("--out", default=None,
                    help="with --snapshot: also write the JSON here")
    args = ap.parse_args(argv)

    endpoints: dict[str, str] = {}
    routers: dict[str, str] = {}
    if args.fleet:
        gw_eps, routers = discover_fleet(list(args.fleet))
        endpoints.update(gw_eps)
    for i, spec in enumerate(args.endpoints):
        name, _, base = spec.rpartition("=")
        endpoints[name or f"gw{i}"] = base
    if not endpoints:
        ap.error("no endpoints (pass host:port args or --fleet)")

    if args.snapshot:
        doc = snapshot_endpoints(endpoints, routers=routers or None)
        line = json.dumps(doc, indent=2, sort_keys=True)
        print(line)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
        unreachable = [g for g, row in doc["gateways"].items()
                       if not row.get("reachable")]
        return 1 if len(unreachable) == len(doc["gateways"]) else 0

    try:
        live_loop(endpoints, args.interval, args.iterations,
                  routers=routers or None)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
