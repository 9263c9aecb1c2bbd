"""Simulated peer-swarm benchmark (BASELINE.json config 5).

Counterpart of the JAX package's ``tools/swarm_bench.py``, method for
method, over the port's engine (``app.messaging``), transport
(``net.p2p_node``), storm environment (``fleet.stormlib``), fault plans
(``faults``) and observability (``obs``).

N client stacks connect to one hub node over real localhost TCP and run the
full authenticated 5-message handshake concurrently, with the hub's (and
clients') KEM/signature ops coalescing in the batching queues; then every
client sends one AEAD message.  Reports handshakes/sec, p50/p99 handshake
latency, and end-to-end msgs/sec as ONE JSON line.

It differs from that module in these places:

* ``--backend`` (and every function's ``backend``) is "cuda", the default,
  or "cpu"; anything else raises.  There is no "tpu" or "auto";
* there is no compile cache: ``--prewarm`` runs each facade's ``warmup``
  at every pow2 flush bucket (the first launches at each shape and the
  memory they take);
* the swarm's AEAD is the engine's default AES-256-GCM on every image:
  the port seals it with its own host AES-256-GCM where the
  ``cryptography`` wheel is missing, so no bench-only AEAD stands in;
* the swarm and the storm run in ``fleet.stormlib.storm_env`` (the fd
  limit raised for every socket, the protocol timeout restored on exit),
  close their engines on the way out, and wipe the clients' secret keys;
* :func:`run_storm` takes a ``backend`` for its hub, its client plane and
  their providers (that module hard-codes "tpu") and a ``degrade`` that
  arms the engines' "cpu" fallbacks (that module's engines always arm
  them on a device backend);
* after its warm-up round the swarm waits for the hub to open the warm-up
  messages before its count restarts (that module can count late ones in
  the measured window), and resets the stats of every queue of every
  facade, the fused ones included; the storm also reports ``msgs_sent``
  beside ``msgs_received`` (the hub's count when the window ends, which
  leaves out messages still in flight then and, with ``resume_mix``, the
  one each session sends just before its reconnect, which the hub does
  not open: the JAX package's storm loses it too);
* :func:`run_multichip` holds its operands on the GPUs
  (``provider.base.shard_batch``: one share a device of ``make_mesh(n)``)
  and times ``mlkem.encaps`` on every share with
  ``utils.benchmarking.timeit``; it has no ``emulate`` (XLA's virtual CPU
  devices): a nonzero value raises;
* artifacts go to ``torch_results/`` by default, with the span dump and
  (``--slo``) each plane's SLO report beside them, so ``trace_merge`` and
  ``slo_merge`` can read what a run wrote.

Usage::

    python -m quantum_resistant_p2p_tpu_torch.tools.swarm_bench --peers 1000 --backend cuda
    python -m quantum_resistant_p2p_tpu_torch.tools.swarm_bench --slo --peers 8 --backend cpu
    python -m quantum_resistant_p2p_tpu_torch.tools.swarm_bench --storm --providers real \\
        --aead chacha --resume-mix --peers 128
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import sys
import time
from pathlib import Path

from ..fleet.stormlib import StormAEAD as _StormAEAD
from ..fleet.stormlib import prewarm_facades as _prewarm_facades
from ..fleet.stormlib import register_storm_providers as _register_storm_providers
from ..fleet.stormlib import storm_env as _storm_env
from ..provider.base import BACKENDS

#: where the tools write their artifacts unless told otherwise
RESULTS_DIR = "torch_results"


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not supported (have {BACKENDS})")


def _reset_queue_stats(facades) -> None:
    """Fresh ``QueueStats`` on every queue of every (non-None) facade."""
    from ..provider.batched import QueueStats

    for facade in facades:
        if facade is not None:
            for q in facade._queues:
                q.stats = QueueStats()


async def run_swarm(n_peers: int, backend: str, use_batching: bool,
                    max_batch: int, max_wait_ms: float, concurrency: int,
                    warmup: int = 0, ke_timeout: float = 180.0,
                    batch_floor: int = 1, prewarm: bool = False,
                    slo: bool = False, shard_devices: int = 0) -> dict:
    """``slo=True`` turns the swarm into the single-handshake SLO probe:
    handshakes only (no AEAD message rides in the measured window, so the
    breaker-delta trip accounting below is handshake-pure) and per-handshake
    dispatch-trip stats in the output.  Meaningful at concurrency 1 —
    overlapping handshakes share the breaker counters."""
    _check_backend(backend)
    from ..app.messaging import SecureMessaging
    from ..net.p2p_node import P2PNode
    from ..utils.wipe import wipe

    clients: list[SecureMessaging] = []
    hub = proto = None
    kp_sks = None
    # a generous protocol timeout plus an untimed warmup round keeps the
    # first launches at each batch size out of the measured numbers
    with _storm_env(ke_timeout, fd_need=4 * (n_peers + warmup) + 64):
        hub_node = P2PNode(node_id="hub", host="127.0.0.1", port=0)
        await hub_node.start()
        proto_node = P2PNode(node_id="proto", host="127.0.0.1", port=0)
        try:
            hub = SecureMessaging(
                hub_node, backend=backend, use_batching=use_batching,
                max_batch=max_batch, max_wait_ms=max_wait_ms, batch_floor=batch_floor,
                shard_devices=shard_devices,
            )
            received = 0
            got_all = asyncio.Event()

            def on_msg(peer_id, message):
                nonlocal received
                if not message.is_system:
                    received += 1
                    if received >= n_peers:
                        got_all.set()

            hub.register_message_listener(on_msg)

            # Shared algorithm objects across clients: one provider, one queue.
            proto = SecureMessaging(
                proto_node, backend=backend, use_batching=use_batching,
                max_batch=max_batch, max_wait_ms=max_wait_ms, batch_floor=batch_floor,
                shard_devices=shard_devices,
            )

            # the size-1 buckets warm in the background at construction; wait
            # so warmup clients start against a warm provider
            await hub.wait_ready()
            await proto.wait_ready()

            prewarm_s = 0.0
            if prewarm and use_batching and hub._bkem is not None:
                # every pow2 flush bucket from the facade's (rounded) floor up
                # to the concurrency level, on BOTH planes' facades (the hub's
                # queues are separate objects from the shared client queues)
                b = hub._bkem.bucket_floor
                t0 = time.perf_counter()
                sizes = await _prewarm_facades(
                    (proto._bkem, proto._bsig, hub._bkem, hub._bsig,
                     proto._bfused, hub._bfused),
                    min(max_batch, max(b, concurrency, 1)), floor=b)
                prewarm_s = time.perf_counter() - t0
                print(f"prewarm: buckets {sizes} on 4 facades in {prewarm_s:.1f}s",
                      file=sys.stderr)

            latencies: list[float] = []
            sem = asyncio.Semaphore(concurrency)

            # Pre-generate every client's long-lived sig keypair in ONE device
            # batch: a real peer boots once; the benchmark measures the
            # handshake pipeline.
            n_keys = n_peers + warmup
            kp_pks, kp_sks = proto.signature.generate_keypair_batch(n_keys)
            kp_next = iter(range(n_keys))

            def make_client(i: int) -> SecureMessaging:
                j = next(kp_next)
                node = P2PNode(node_id=f"peer{i:04d}", host="127.0.0.1", port=0)
                sm = SecureMessaging(node, backend=backend, kem=proto.kem,
                                     symmetric=proto.symmetric, signature=proto.signature,
                                     sig_keypair=(bytes(kp_pks[j]), bytes(kp_sks[j])))
                # share the batch queues so all clients coalesce into the same batches
                sm._bkem, sm._bsig = proto._bkem, proto._bsig
                sm._bfused = proto._bfused
                sm.use_batching = use_batching
                clients.append(sm)
                return sm

            async def drive_client(i: int, sm: SecureMessaging) -> None:
                async with sem:
                    assert await sm.node.connect_to_peer("127.0.0.1", hub_node.port) == "hub"
                    t0 = time.perf_counter()
                    ok = await sm.initiate_key_exchange("hub")
                    latencies.append(time.perf_counter() - t0)
                    if not ok:
                        raise RuntimeError(f"handshake {i} failed")
                    if not slo:
                        await sm.send_message("hub", b"hello from peer %d" % i)

            async def one_client(i: int) -> None:
                await drive_client(i, make_client(i))

            if warmup:
                warm = await asyncio.gather(*(one_client(-i - 1) for i in range(warmup)),
                                            return_exceptions=True)
                warm_fail = sum(1 for r in warm if isinstance(r, Exception))
                if warm_fail:
                    print(f"warmup: {warm_fail}/{warmup} failed", file=sys.stderr)
                # the hub opens the warmup messages after their senders
                # return: let them land before the count restarts, or they
                # would be counted in the measured window
                deadline = time.monotonic() + 30.0
                while (not slo and received < warmup - warm_fail
                       and time.monotonic() < deadline):
                    await asyncio.sleep(0.01)
                latencies.clear()
                received = 0
                got_all.clear()
                # the warmup clients stay in `clients`; drop their trip samples
                # so initiator_trips_* describes only the measured (warm) window
                # (reset in place: the registry keeps pointing at the object)
                for sm in clients:
                    sm._handshake_trips.reset()
                # QueueStats are cumulative; reset so device_served_pct and the
                # dispatch histograms describe ONLY the measured window
                if use_batching and hub._bkem is not None:
                    _reset_queue_stats((hub._bkem, hub._bsig, proto._bkem, proto._bsig,
                                        hub._bfused, proto._bfused))

            # pre-build every client stack, then start the measured window
            pre = [make_client(i) for i in range(n_peers)]

            def _breaker_trips() -> int:
                # serial dispatch steps across BOTH sides' breakers — the
                # per-handshake SLO currency, through the one definition
                # SecureMessaging uses
                return proto._trips_now() + hub._trips_now()

            trips0 = _breaker_trips()
            t_start = time.perf_counter()
            results = await asyncio.gather(*(drive_client(i, sm)
                                             for i, sm in enumerate(pre)),
                                           return_exceptions=True)
            failures = [r for r in results if isinstance(r, Exception)]
            if not slo:
                try:
                    await asyncio.wait_for(got_all.wait(), 60)
                except asyncio.TimeoutError:
                    pass
            elapsed = time.perf_counter() - t_start
            trips_delta = _breaker_trips() - trips0

            slo_report = None
            if slo:
                # SLO engine evaluation while the plane is still alive: the hub
                # is the responder/gateway side; the initiator-side latency
                # split aggregates every client stack's histogram against the
                # same threshold the engines alert on
                from ..app.messaging import HANDSHAKE_SLO_THRESHOLD_S
                from ..obs import slo as obs_slo

                good = bad = 0.0
                for sm in clients:
                    g, b = obs_slo.latency_probe(sm._handshake_latency,
                                                 HANDSHAKE_SLO_THRESHOLD_S)()
                    good += g
                    bad += b
                slo_report = {
                    "hub": hub.slo_status(),
                    "client_plane": proto.slo_status(),
                    "initiator_handshake": {
                        "threshold_s": HANDSHAKE_SLO_THRESHOLD_S,
                        "good": good,
                        "bad": bad,
                    },
                    # each plane's per-node report, as a fleet gateway
                    # writes it: what slo_merge folds
                    "node_reports": {"hub": hub.slo_report(),
                                     "client_plane": proto.slo_report()},
                }
        finally:
            for sm in clients:
                await sm.node.stop()
            await hub_node.stop()
            await proto_node.stop()
            for engine in clients + [hub, proto]:
                if engine is not None:
                    engine.close()
            if kp_sks is not None:
                wipe(kp_sks)  # every client adopted its own copy

    lat_sorted = sorted(latencies)
    stats = {
        "peers": n_peers,
        "backend": backend,
        "aead": hub.symmetric.display_name,
        "batching": use_batching,
        "failures": len(failures),
        "elapsed_s": round(elapsed, 3),
        "handshakes_per_s": round(len(latencies) / elapsed, 2),
        "e2e_msgs_per_s": round(received / elapsed, 2),
        "p50_handshake_s": round(statistics.median(lat_sorted), 4) if lat_sorted else None,
        "p99_handshake_s": round(
            lat_sorted[max(0, int(len(lat_sorted) * 0.99) - 1)], 4
        ) if lat_sorted else None,
        "messages_received": received,
    }
    if use_batching and hub._bkem is not None:
        stats["prewarm_s"] = round(prewarm_s, 1)
        stats["batch_floor"] = batch_floor
        stats["shard_devices"] = shard_devices
        if hub._scheduler is not None and hub._scheduler.n_shards > 1:
            stats["shards"] = {
                "hub": hub._scheduler.stats(),
                "client": proto._scheduler.stats()
                if proto._scheduler is not None else None,
            }
        stats["hub_queue"] = {"kem": hub._bkem.stats(), "sig": hub._bsig.stats()}
        stats["client_queue"] = {"kem": proto._bkem.stats(),
                                 "sig": proto._bsig.stats()}
        if hub._bfused is not None:
            stats["hub_queue"]["fused"] = hub._bfused.stats()
        if proto._bfused is not None:
            stats["client_queue"]["fused"] = proto._bfused.stats()
        total_ops = fb_ops = 0
        for side in ("hub_queue", "client_queue"):
            for fam in stats[side].values():
                for q in fam.values():
                    total_ops += q["ops"]
                    fb_ops += q["fallback_ops"]
        stats["device_served_pct"] = round(
            100.0 * (total_ops - fb_ops) / total_ops, 1) if total_ops else None
        # the 0..1 gauge tooling gates on: a "silent CPU swarm" must be
        # caught by the harness
        stats["device_served_fraction"] = round(
            (total_ops - fb_ops) / total_ops, 4) if total_ops else None
        stats["breaker_state"] = hub._queue_breaker.state if hub._queue_breaker else None
        stats["breaker_opens"] = hub._queue_breaker.opens if hub._queue_breaker else 0
        stats["breaker_closes"] = hub._queue_breaker.closes if hub._queue_breaker else 0
        # Measured dispatch trips (never inferred): breaker delta over the
        # measured window across both sides.  In slo mode the window holds
        # ONLY handshakes, so the per-handshake quotient is exact at
        # concurrency 1; the client-side histogram (initiator trips between
        # initiate and completion) rides along from the client stacks.
        stats["dispatch_trips"] = trips_delta
        if latencies:
            stats["trips_per_handshake"] = round(trips_delta / len(latencies), 2)
        client_trips = [
            int(sm._handshake_trips.last) for sm in clients
            if sm._handshake_trips.count and sm._handshake_trips.last is not None
        ]
        if client_trips:
            srt = sorted(client_trips)
            stats["initiator_trips_p50"] = srt[len(srt) // 2]
            stats["initiator_trips_max"] = srt[-1]
    if slo_report is not None:
        stats["slo"] = slo_report
    return stats


def snapshot_digest(snap: dict) -> dict:
    """Compact a ``global_snapshot()`` for keeping: a storm creates one
    registry PER SESSION (``messaging:peer01234``, plus ``#N`` dedup
    suffixes), so the raw dump runs to ~240k lines of mostly-identical
    per-peer histogram buckets.  The digest groups registries by class
    (everything before ``:``), sums counters, folds gauges to
    min/mean/max over the non-null instances, and merges histograms to
    bucketless count/sum/p50/p99 ranges — a few hundred lines that still
    answer every question the artifact exists for (rates, tails, totals).
    Pass ``--full-snapshots`` for the raw dump.
    """
    groups: dict[str, list[dict]] = {}
    for name, reg in snap.items():
        groups.setdefault(str(name).split(":", 1)[0].split("#", 1)[0],
                          []).append(reg)
    digest: dict[str, dict] = {"_digest": {
        "registries": len(snap),
        "groups": {k: len(v) for k, v in sorted(groups.items())},
    }}
    for key, regs in sorted(groups.items()):
        counters: dict[str, float] = {}
        gauges: dict[str, list[float]] = {}
        hists: dict[str, dict] = {}
        for reg in regs:
            for cname, val in (reg.get("counters") or {}).items():
                if isinstance(val, (int, float)):
                    counters[cname] = counters.get(cname, 0) + val
            for gname, val in (reg.get("gauges") or {}).items():
                if isinstance(val, (int, float)):
                    gauges.setdefault(gname, []).append(val)
            for hname, h in (reg.get("histograms") or {}).items():
                if not isinstance(h, dict):
                    continue
                agg = hists.setdefault(hname, {"count": 0, "sum": 0.0,
                                               "p50": [], "p99": []})
                agg["count"] += h.get("count") or 0
                agg["sum"] += h.get("sum") or 0.0
                for p in ("p50", "p99"):
                    if isinstance(h.get(p), (int, float)):
                        agg[p].append(h[p])
        digest[key] = {
            "instances": len(regs),
            "counters": dict(sorted(counters.items())),
            "gauges": {g: {"min": min(vs), "max": max(vs),
                           "mean": round(sum(vs) / len(vs), 6)}
                       for g, vs in sorted(gauges.items())},
            "histograms": {h: {"count": agg["count"],
                               "sum": round(agg["sum"], 6),
                               "p50_range": ([min(agg["p50"]), max(agg["p50"])]
                                             if agg["p50"] else None),
                               "p99_range": ([min(agg["p99"]), max(agg["p99"])]
                                             if agg["p99"] else None)}
                           for h, agg in sorted(hists.items())},
        }
    return digest


#: process-wide default for ``write_obs_artifacts`` (set_full_snapshots):
#: lets a caller with many modes honor ONE --full-snapshots flag without
#: threading it through every signature
_FULL_SNAPSHOTS = False


def set_full_snapshots(value: bool) -> None:
    global _FULL_SNAPSHOTS
    _FULL_SNAPSHOTS = bool(value)


def write_obs_artifacts(stats: dict, out_dir: str | Path,
                        stem: str = "swarm",
                        full_snapshots: bool | None = None) -> dict:
    """Attach the run's observability artifacts to its JSON output: a
    chrome://tracing trace-event file of the recorded spans, the MERGED
    multi-node flame graph (one process lane per node, flow arrows on the
    propagated cross-peer parent edges — :mod:`.trace_merge`), and a
    metrics snapshot of every live registry — digested by
    :func:`snapshot_digest` unless ``full_snapshots``.  Beside them (the
    port's addition) the span dump itself, which :mod:`.trace_merge` reads,
    and, for an ``--slo`` swarm, each plane's ``*_slo_report.json``, which
    :mod:`.slo_merge` reads.  Returns the paths added to ``stats``.
    """
    from ..obs import metrics as obs_metrics
    from ..obs import trace as obs_trace
    from . import trace_merge

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    records = obs_trace.TRACER.snapshot()
    dump = obs_trace.span_dump(records=records)
    dump_path = out / f"{stem}_span_dump.json"
    dump_path.write_text(json.dumps(dump))
    slo_paths = []
    for side, report in ((stats.get("slo") or {}).get("node_reports") or {}).items():
        slo_paths.append(out / f"{stem}_{side}_slo_report.json")
        slo_paths[-1].write_text(json.dumps(report, indent=2, default=str))
    trace_path = out / f"{stem}_trace_events.json"
    trace_path.write_text(json.dumps(obs_trace.to_chrome_trace(records)))
    # every node in this process recorded into ONE tracer; the records'
    # per-span node attribution is what the merge groups lanes by
    merged = trace_merge.merge([dump])
    merged_path = out / f"{stem}_merged_trace.json"
    merged_path.write_text(json.dumps(merged))
    metrics_path = out / f"{stem}_metrics_snapshot.json"
    if full_snapshots is None:
        full_snapshots = _FULL_SNAPSHOTS
    snap = obs_metrics.global_snapshot()
    if not full_snapshots:
        snap = snapshot_digest(snap)
    metrics_path.write_text(json.dumps(snap, indent=2, default=str))
    stats["obs"] = {
        "spans_recorded": len(records),
        "trace_events_file": str(trace_path),
        "merged_trace_file": str(merged_path),
        "merged_nodes": merged["otherData"]["merged_nodes"],
        "cross_node_edges": merged["otherData"]["cross_node_edges"],
        "metrics_snapshot_file": str(metrics_path),
        "metrics_snapshot_mode": "full" if full_snapshots else "digest",
        "span_dump_file": str(dump_path),
        "slo_report_files": [str(p) for p in slo_paths],
    }
    return stats["obs"]


# -- storm workload: the sustained-traffic serving tier ------------------------
#
# The swarm bench above measures a fixed wave of handshakes; the STORM mode
# measures the GATEWAY under sustained concurrent load: many live sessions
# arriving at a configurable rate, holding their connections, mixing re-keys
# and bulk traffic, and churning — driven through the real net/p2p_node TCP
# transport and the full SecureMessaging protocol engine (admission control,
# priority lanes, and the batch autotuner all live).
#
# Crypto providers: ``--providers stdlib`` (the default for storms) runs
# hash-based toy KEM/SIG/AEAD, so the storm measures the SERVING LOOP
# (transport, protocol, queues, batching, admission) rather than raw crypto
# throughput.  ``--providers real`` drives ML-KEM-768 + ML-DSA-65 through the
# same storm on the card.  The emitted JSON carries the provider set.


def _percentile(sorted_vals: list, p: float):
    if not sorted_vals:
        return None
    return round(
        sorted_vals[min(len(sorted_vals) - 1,
                        max(0, int(len(sorted_vals) * p / 100.0)))], 4)


async def run_storm(sessions: int = 1000, providers: str = "stdlib",
                    arrival_rate: float = 0.0, concurrency: int = 512,
                    msgs_per_session: int = 2, rekey_every: int = 0,
                    churn_fraction: float = 0.0, seed: int = 0,
                    max_batch: int = 4096, max_wait_ms: float = 3.0,
                    autotune: bool = True, hub_max_peers: int = 0,
                    handshake_budget: int = 0, bulk_lane_capacity: int = 0,
                    shard_devices: int = 0, ke_timeout: float = 120.0,
                    prewarm: bool = True, prewarm_cap: int = 256,
                    aead_mode: str = "storm", payload_bytes: int = 0,
                    resume_mix: bool = False,
                    fault_rules=None, backend: str = "cuda",
                    degrade: bool = False) -> dict:
    """Sustained-traffic storm: ``sessions`` live peers through one hub.

    Each session (seeded, reproducible): dial (busy-shed retries included)
    -> authenticated handshake -> ``msgs_per_session`` bulk messages, with
    a forced RE-KEY every ``rekey_every`` messages and, with probability
    ``churn_fraction``, one churn cycle (drop the TCP session, redial,
    re-handshake).  ``arrival_rate`` > 0 paces session starts (sessions/s,
    uniform); 0 launches everything behind the ``concurrency`` gate.

    ``aead_mode`` picks the bulk-message AEAD:

    * ``storm`` — the stdlib toy AEAD;
    * ``chacha`` — ChaCha20-Poly1305 through the BATCHED facade
      (provider/batched.BatchedAEAD: K8 on "cuda");
    * ``chacha-scalar`` — the same algorithm on the scalar per-message
      path.

    ``payload_bytes`` pads every bulk message's content up to that size
    (0 keeps the tiny payloads).  Per-message send latency (sign + seal +
    write) is measured and reported as p50/p99_msg_s.

    ``resume_mix``: every session DROPS its TCP connection halfway through
    its workload, redials, and re-establishes — with a held resumption
    ticket that reconnect is a 1-RTT resume (no KEM, no signatures, no
    device dispatch) instead of a full handshake.  The report carries the
    resume rate, resume-vs-full latency split, and a sequential post-storm
    cost probe (device trips + cost-ledger device seconds across N pure
    resume cycles).

    ``backend`` runs the hub's and the client plane's engines and
    providers on "cuda" (the default) or "cpu"; ``degrade=True`` arms
    their "cpu" fallbacks (the queues' degrade path).

    Returns one JSON-ready dict: handshakes/s, p50/p99 split by first
    handshake vs rekey lane, shed counters (connection / handshake /
    bulk), device_served_fraction, and the autotuner's decisions.
    ``fault_rules`` (faults/) arms a seeded chaos plan around the measured
    window — plan.injected rides along, reproducible given the seed.
    """
    import random

    _check_backend(backend)
    from ..app import messaging as _messaging
    from ..app.messaging import SecureMessaging
    from ..faults import FaultPlan
    from ..net.p2p_node import P2PNode
    from ..provider import get_kem, get_signature
    from ..utils.wipe import wipe

    if providers == "stdlib":
        _register_storm_providers()
        kem_name, sig_name = "STORM-KEM", "STORM-SIG"
    else:
        kem_name, sig_name = "ML-KEM-768", "ML-DSA-65"

    rng = random.Random(seed)
    if aead_mode == "storm":
        aead = _StormAEAD()
        batch_aead = False
    elif aead_mode in ("chacha", "chacha-scalar"):
        from ..provider import get_symmetric

        aead = get_symmetric("ChaCha20-Poly1305")
        batch_aead = aead_mode == "chacha"
    else:
        raise ValueError(f"unknown aead_mode {aead_mode!r}")
    # storm_env (fleet/stormlib.py — the same guard every fleet gateway
    # process enters): raised fd limit + module-global protocol-timeout
    # save/restore.  Everything below also runs under one finally: an
    # exception escaping a session task (or Ctrl-C) must still close every
    # socket and stop every engine's device workers
    clients: list[SecureMessaging] = []
    hub_node = hub = proto = None
    kp_sks = None
    with _storm_env(ke_timeout, fd_need=4 * sessions + 64):
        try:
            gateway_kw = dict(
                use_batching=True, max_batch=max_batch, max_wait_ms=max_wait_ms,
                autotune=autotune, shard_devices=shard_devices,
                batch_aead=batch_aead, backend=backend, degrade=degrade,
            )
            hub_node = P2PNode(node_id="hub", host="127.0.0.1", port=0,
                               max_peers=hub_max_peers)
            await hub_node.start()
            hub = SecureMessaging(
                hub_node, kem=get_kem(kem_name, backend), symmetric=aead,
                signature=get_signature(sig_name, backend),
                max_inflight_handshakes=handshake_budget,
                bulk_lane_capacity=bulk_lane_capacity, **gateway_kw,
            )
            received = 0

            def on_msg(peer_id, message):
                nonlocal received
                if not message.is_system:
                    received += 1

            hub.register_message_listener(on_msg)

            # one shared client-side batching plane (the swarm's proto
            # pattern): every client coalesces into the same queues / autotuner
            proto = SecureMessaging(
                P2PNode(node_id="proto", host="127.0.0.1", port=0),
                kem=get_kem(kem_name, backend), symmetric=aead,
                signature=get_signature(sig_name, backend), **gateway_kw,
            )
            await hub.wait_ready()
            await proto.wait_ready()

            if prewarm:
                # warm every pow2 flush bucket a live storm can hit (up to the
                # cap) on BOTH planes.  The AEAD facades also warm the message
                # bucket this storm's package size lands in (b64 content +
                # envelope + sig material)
                aead_facades = ()
                if batch_aead and hub._baead is not None:
                    est = (4 * max(payload_bytes, 64)) // 3 + 640
                    shapes = ((hub._baead.algo._msg_bucket(est), 256),)
                    hub._baead.warm_shapes = shapes
                    proto._baead.warm_shapes = shapes
                    aead_facades = (proto._baead, hub._baead)
                await _prewarm_facades(
                    (proto._bkem, proto._bsig, hub._bkem, hub._bsig,
                     proto._bfused, hub._bfused) + aead_facades,
                    min(max_batch, max(concurrency, 1), prewarm_cap))

            n_keys = sessions
            kp_pks, kp_sks = proto.signature.generate_keypair_batch(n_keys)

            first_lat: list[float] = []
            rekey_lat: list[float] = []
            msg_lat: list[float] = []
            resume_lat: list[float] = []
            churns = rekeys = 0
            resumes_done = resume_fulls = 0
            failures = sent = 0
            sem = asyncio.Semaphore(concurrency)

            def make_client(i: int) -> SecureMessaging:
                node = P2PNode(node_id=f"peer{i:05d}", host="127.0.0.1", port=0)
                sm = SecureMessaging(
                    node, kem=proto.kem, symmetric=proto.symmetric,
                    signature=proto.signature, backend=backend,
                    sig_keypair=(bytes(kp_pks[i]), bytes(kp_sks[i])))
                sm._bkem, sm._bsig, sm._bfused = proto._bkem, proto._bsig, proto._bfused
                sm._baead = proto._baead  # the shared data plane too
                sm.use_batching = True
                clients.append(sm)
                return sm

            def _payload(i: int, k: int) -> bytes:
                base = b"storm payload %d/%d" % (i, k)
                return (base.ljust(payload_bytes, b"x")
                        if payload_bytes else base)

            async def handshake(sm, bucket: list[float]) -> bool:
                nonlocal failures
                t0 = time.perf_counter()
                ok = await sm.initiate_key_exchange("hub")
                bucket.append(time.perf_counter() - t0)
                if not ok:
                    failures += 1
                return ok

            async def resume_cycle(sm) -> bool:
                """One resume-mix reconnect: drop the TCP session, redial,
                re-establish (a held ticket makes it a 1-RTT resume; any
                failure falls back to the full handshake inside
                initiate_key_exchange — never a stall)."""
                nonlocal resumes_done, resume_fulls, failures
                await sm.node.disconnect_from_peer("hub")
                if await sm.node.connect_to_peer("127.0.0.1", hub_node.port,
                                                 retries=4) != "hub":
                    failures += 1
                    return False
                r0 = sm._ctr_resumes_used.value
                rt0 = time.perf_counter()
                ok = await sm.initiate_key_exchange("hub")
                took = time.perf_counter() - rt0
                if not ok:
                    failures += 1
                    return False
                if sm._ctr_resumes_used.value > r0:
                    resumes_done += 1
                    # only ACTUAL resumes feed the resume-latency split
                    resume_lat.append(took)
                else:
                    resume_fulls += 1
                return True

            async def one_session(i: int, start_at: float, t_origin: float,
                                  srng: random.Random) -> None:
                nonlocal churns, rekeys, failures, sent
                delay = start_at - (time.perf_counter() - t_origin)
                if delay > 0:
                    await asyncio.sleep(delay)
                async with sem:
                    sm = make_client(i)
                    if await sm.node.connect_to_peer("127.0.0.1", hub_node.port,
                                                     retries=4) != "hub":
                        failures += 1
                        return
                    if not await handshake(sm, first_lat):
                        return
                    for k in range(msgs_per_session):
                        mt0 = time.perf_counter()
                        if await sm.send_message("hub", _payload(i, k)) is not None:
                            sent += 1
                        msg_lat.append(time.perf_counter() - mt0)
                        if (resume_mix
                                and k + 1 == max(1, msgs_per_session // 2)):
                            # mid-workload reconnect: the resume fast path
                            if not await resume_cycle(sm):
                                return
                        if rekey_every and (k + 1) % rekey_every == 0:
                            # forced re-key: drop the session key and run the
                            # 5-message handshake again — rides the REKEY lane on
                            # both sides (sm and hub have completed a session)
                            sm.shared_keys.pop("hub", None)
                            sm.ke_state["hub"] = _messaging.KeyExchangeState.NONE
                            rekeys += 1
                            if not await handshake(sm, rekey_lat):
                                return
                    if churn_fraction and srng.random() < churn_fraction:
                        # churn: drop the TCP session entirely, redial, re-key
                        await sm.node.disconnect_from_peer("hub")
                        churns += 1
                        if await sm.node.connect_to_peer("127.0.0.1", hub_node.port,
                                                         retries=4) == "hub":
                            await handshake(sm, rekey_lat)
                        else:
                            failures += 1

            # seeded arrival schedule + per-session RNGs: the offered-load trace
            # is a pure function of (seed, sessions, arrival_rate)
            offsets = []
            t = 0.0
            for _ in range(sessions):
                if arrival_rate > 0:
                    t += rng.uniform(0.0, 2.0 / arrival_rate)  # mean 1/rate
                offsets.append(t)
            session_rngs = [random.Random(rng.getrandbits(64)) for _ in range(sessions)]

            plan = FaultPlan(seed, list(fault_rules)) if fault_rules else None
            ctx = plan.activate() if plan is not None else None
            if ctx is not None:
                ctx.__enter__()
            t_origin = time.perf_counter()
            try:
                await asyncio.gather(*(
                    one_session(i, offsets[i], t_origin, session_rngs[i])
                    for i in range(sessions)))
            finally:
                if ctx is not None:
                    ctx.__exit__(None, None, None)
            elapsed = time.perf_counter() - t_origin

            resume_probe = None
            if resume_mix and clients:
                # sequential post-storm cost probe: N pure resume cycles on
                # one client, device trips + cost-ledger device seconds
                # sampled around them — the evidence that resumes cost ~0
                # device-seconds (no KEM, no sigs, no AEAD dispatch rides the
                # abbreviated exchange)
                sm = clients[0]
                trips0 = hub._trips_now() + proto._trips_now()
                dsec0 = ((hub.cost.totals().get("device_seconds") or 0.0)
                         + (proto.cost.totals().get("device_seconds") or 0.0))
                probe_ok = 0
                for _ in range(8):
                    r0 = sm._ctr_resumes_used.value
                    await sm.node.disconnect_from_peer("hub")
                    if await sm.node.connect_to_peer(
                            "127.0.0.1", hub_node.port, retries=4) != "hub":
                        break
                    if not await sm.initiate_key_exchange("hub"):
                        break
                    if sm._ctr_resumes_used.value > r0:
                        probe_ok += 1
                resume_probe = {
                    "resumes": probe_ok,
                    "device_trips": (hub._trips_now() + proto._trips_now()
                                     - trips0),
                    "device_seconds": round(
                        (hub.cost.totals().get("device_seconds") or 0.0)
                        + (proto.cost.totals().get("device_seconds") or 0.0)
                        - dsec0, 6),
                }

            hub_metrics = hub.metrics()
            proto_metrics = proto.metrics()

        finally:
            for sm in clients:
                await sm.node.stop()
            if hub_node is not None:
                await hub_node.stop()
            if proto is not None:
                await proto.node.stop()
            for engine in clients + [hub, proto]:
                if engine is not None:
                    engine.close()
            if kp_sks is not None:
                wipe(kp_sks)  # every session adopted its own copy

    total_hs = len(first_lat) + len(rekey_lat)
    total_ops = fb_ops = 0
    for m in (hub_metrics, proto_metrics):
        for fam in ("kem_queue", "sig_queue", "fused_queue", "aead_queue"):
            for q in m.get(fam, {}).values():
                total_ops += q["ops"]
                fb_ops += q["fallback_ops"]
    f_sorted, r_sorted = sorted(first_lat), sorted(rekey_lat)
    m_sorted = sorted(msg_lat)
    client_busy = sum(sm.node.busy_rejects for sm in clients)
    out = {
        "workload": "storm",
        "sessions": sessions,
        "providers": ("stdlib-toy (serving-loop workload; PQ crypto "
                      "benched by --slo/raw-ops)" if providers == "stdlib"
                      else f"{kem_name}+{sig_name}"),
        "aead": aead.name,
        "aead_mode": aead_mode,
        "batch_aead": batch_aead,
        "payload_bytes": payload_bytes,
        "seed": seed,
        "arrival_rate": arrival_rate,
        "concurrency": concurrency,
        "msgs_per_session": msgs_per_session,
        "rekey_every": rekey_every,
        "churn_fraction": churn_fraction,
        "autotune": autotune,
        "shard_devices": shard_devices,
        "elapsed_s": round(elapsed, 3),
        "failures": failures,
        "handshakes": total_hs,
        "handshakes_per_s": round(total_hs / elapsed, 2) if elapsed else None,
        "msgs_sent": sent,
        "msgs_received": received,
        "msgs_per_s": round(received / elapsed, 2) if elapsed else None,
        # per-message SEND latency (sign + seal + frame write)
        "p50_msg_s": _percentile(m_sorted, 50),
        "p99_msg_s": _percentile(m_sorted, 99),
        "p50_handshake_s": _percentile(f_sorted, 50),
        "p99_handshake_s": _percentile(f_sorted, 99),
        "rekeys": rekeys,
        "p50_rekey_s": _percentile(r_sorted, 50),
        "p99_rekey_s": _percentile(r_sorted, 99),
        "churns": churns,
        # the resume-mix split: reconnects that resumed via ticket vs
        # full-handshake fallbacks, their latency, and the post-storm
        # device-cost probe
        "resume_mix": resume_mix,
        "resumed_reconnects": resumes_done,
        "full_handshake_reconnects": resume_fulls,
        "ticket_resume_rate": (
            round(resumes_done / (resumes_done + resume_fulls), 4)
            if (resumes_done + resume_fulls) else None),
        "p50_resume_s": _percentile(sorted(resume_lat), 50),
        "p99_resume_s": _percentile(sorted(resume_lat), 99),
        "resume_cost_probe": resume_probe,
        "resumption_hub": hub_metrics.get("resumption"),
        "device_served_fraction": (
            round((total_ops - fb_ops) / total_ops, 4) if total_ops else None),
        "sheds": {
            "connection": hub_node.sheds,
            "client_busy_rejects": client_busy,
            "handshake": hub_metrics["gateway"]["handshake_sheds"],
            "bulk_hub": hub_metrics["gateway"]["bulk_sheds"],
            "bulk_clients": sum(
                sm._ctr_bulk_sheds.value for sm in clients) if clients else 0,
        },
        "gateway_hub": {
            k: hub_metrics["gateway"][k]
            for k in ("max_peers", "handshake_budget", "handshake_sheds")},
        "autotune_hub": hub_metrics["gateway"]["autotune"],
        "autotune_clients": proto_metrics["gateway"]["autotune"],
        # the data plane's seal/open queues (None on scalar-AEAD storms)
        "aead_queue": {"hub": hub_metrics.get("aead_queue"),
                       "client_plane": proto_metrics.get("aead_queue")},
        # burn-rate health of both planes at storm end (obs/slo.py)
        "slo": {"hub": hub_metrics["slo"],
                "client_plane": proto_metrics["slo"]},
        # the device-cost ledgers at storm end (obs/cost.py): padding
        # waste, warm-up attribution, device seconds, opcache windows
        "cost": {"hub": hub_metrics["cost"],
                 "client_plane": proto_metrics["cost"]},
    }
    if plan is not None:
        out["chaos"] = {
            "seed": plan.seed,
            "injected": len(plan.injected),
            "first_injected": plan.injected[:8],
        }
    return out


def run_multichip(shard_counts=(1, 2, 4, 8), batch: int = 4096,
                  hs_peers: int = 32, hs_concurrency: int = 8,
                  hs_warmup: int = 8, emulate: int = 0) -> dict:
    """Measure 1→N-GPU scaling of BOTH production paths and return the
    scaling curve.

    * **encaps/s** — the large-batch raw-ops path: one ``batch``-row
      ML-KEM-768 encapsulation with the batch split across an n-GPU mesh
      (``parallel.make_mesh``; n = 1 is the unsplit call on ``cuda:0``),
      each share held on its GPU before the timing (``shard_batch``), every
      share launched before any is waited for, timed by
      :func:`utils.benchmarking.timeit`.
    * **warm handshakes/s** — the latency path: the swarm bench with the
      queue flushes placed across ``shard_devices=n`` scheduler shards, one
      GPU each (set ``hs_peers=0`` to skip).

    Shard counts above ``torch.cuda.device_count()`` are dropped with a
    line on stderr.  ``emulate`` (the JAX package's virtual CPU devices)
    has no counterpart: a nonzero value raises ValueError.
    """
    if emulate:
        raise ValueError("emulate: the port has no virtual devices; the split runs on "
                         "distinct GPUs only (parallel.make_mesh)")
    import numpy as np
    import torch

    from ..kem import mlkem
    from ..parallel.mesh import make_mesh
    from ..provider import get_kem
    from ..provider.base import run_share, shard_batch
    from ..utils.benchmarking import sync, timeit

    if not torch.cuda.is_available():
        raise RuntimeError("run_multichip needs a GPU (torch.cuda.is_available() is False)")
    n_devices = torch.cuda.device_count()
    counts = sorted({c for c in shard_counts if 1 <= c <= n_devices} | {1})
    dropped = sorted(set(shard_counts) - set(counts))
    if dropped:
        print(f"multichip: only {n_devices} device(s) visible; "
              f"skipping shard counts {dropped}", file=sys.stderr)

    p = mlkem.MLKEM768
    rng = np.random.default_rng(0)
    # one keypair reused across rows (the swarm-hot-peer shape); encaps
    # math is row-independent so scaling is not key-bound
    ek_row = get_kem("ML-KEM-768", "cuda").generate_keypair()[0]
    eks = np.broadcast_to(
        np.frombuffer(ek_row, np.uint8), (batch, len(ek_row))).copy()
    ms = rng.integers(0, 256, size=(batch, 32), dtype=np.uint8)

    def enc(ek, m):
        return mlkem.encaps(p, ek, m)

    shards: dict[str, dict] = {}
    for n in counts:
        mesh = make_mesh(n)
        # device-resident operands, one share a GPU: the timed region
        # measures the GPUs, not the host link
        ek_d, m_d = shard_batch(mesh, eks, ms)
        sync((ek_d, m_d))

        def split_encaps(mesh=mesh, ek_d=ek_d, m_d=m_d):
            return [run_share(enc, dev, (e, m))
                    for dev, e, m in zip(mesh.devices, ek_d, m_d)]

        encaps_per_s = batch / timeit(split_encaps)
        entry: dict = {
            "n_shards": n,
            "encaps_per_s": round(encaps_per_s, 1),
            "encaps_batch": batch,
            "rows_per_device": -(-batch // n),
        }
        if hs_peers:
            hs = asyncio.run(run_swarm(
                hs_peers, backend="cuda", use_batching=True, max_batch=4096,
                max_wait_ms=2.0, concurrency=hs_concurrency, warmup=hs_warmup,
                prewarm=True, shard_devices=n,
            ))
            entry["handshakes_per_s"] = hs.get("handshakes_per_s")
            entry["p50_handshake_s"] = hs.get("p50_handshake_s")
            entry["device_served_fraction"] = hs.get("device_served_fraction")
            entry["failures"] = hs.get("failures")
        shards[str(n)] = entry

    base = shards["1"]["encaps_per_s"]
    for entry in shards.values():
        entry["encaps_speedup_vs_1"] = round(entry["encaps_per_s"] / base, 2)
        if entry.get("handshakes_per_s") and shards["1"].get("handshakes_per_s"):
            entry["handshakes_speedup_vs_1"] = round(
                entry["handshakes_per_s"] / shards["1"]["handshakes_per_s"], 2)
    top = str(max(counts))
    return {
        "metric": f"multichip_mlkem768_encaps_batch{batch}_scaling",
        "unit": "encaps/s",
        "n_devices": n_devices,
        "emulated_devices": None,
        "platform": "cuda",
        "device_name": torch.cuda.get_device_name(0),
        "shard_counts": counts,
        "dropped_shard_counts": dropped,
        "value": shards[top]["encaps_per_s"],
        "value_at_1": base,
        "speedup_max_shards": shards[top]["encaps_speedup_vs_1"],
        "shards": shards,
        "ok": True,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--peers", type=int, default=1000)
    ap.add_argument("--backend", default="cuda", choices=BACKENDS)
    ap.add_argument("--batch", action="store_true", default=True)
    ap.add_argument("--no-batch", dest="batch", action="store_false")
    ap.add_argument("--max-batch", type=int, default=4096)
    ap.add_argument("--max-wait-ms", type=float, default=3.0)
    ap.add_argument("--concurrency", type=int, default=256,
                    help="simultaneous in-flight handshakes")
    ap.add_argument("--warmup", type=int, default=32,
                    help="untimed warmup handshakes (the first launches at each size)")
    ap.add_argument("--ke-timeout", type=float, default=180.0)
    ap.add_argument("--batch-floor", type=int, default=1,
                    help="pad device flushes up to this pow2 bucket "
                         "(collapses the bucket space so --prewarm covers it)")
    ap.add_argument("--shard-devices", type=int, default=0,
                    help="place queue flushes across this many scheduler "
                         "shards, one GPU each (provider/scheduler.py; 0 = one "
                         "logical shard)")
    ap.add_argument("--prewarm", action="store_true",
                    help="warm every reachable flush bucket on hub+client "
                         "facades before the measured window")
    ap.add_argument("--slo", action="store_true",
                    help="single-handshake SLO probe: sequential handshakes "
                         "only, with per-handshake dispatch-trip accounting "
                         "(forces --concurrency 1)")
    ap.add_argument("--obs-dir", default=RESULTS_DIR,
                    help="directory for the trace-event, merged multi-node "
                         "trace, and metrics-snapshot artifacts (slo/storm "
                         "modes; '' disables)")
    ap.add_argument("--full-snapshots", action="store_true",
                    help="write the RAW per-registry metrics snapshot "
                         "(~MBs for a storm: one registry per session) "
                         "instead of the compact digest")
    ap.add_argument("--storm", action="store_true",
                    help="sustained-traffic storm: --peers concurrent live "
                         "sessions with arrival pacing, rekey/bulk mix and "
                         "churn through the gateway (admission control, "
                         "priority lanes, batch autotuner)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="with --storm: drive the sessions through an "
                         "N-gateway-PROCESS fleet behind the consistent-hash "
                         "router (fleet/) instead of one in-process hub")
    ap.add_argument("--spawn", default="process", choices=("process", "task"),
                    help="fleet gateway isolation: real subprocesses "
                         "(default) or in-process asyncio tasks (same control "
                         "protocol)")
    ap.add_argument("--chaos-kill", default="",
                    help="fleet chaos: SIGKILL this gateway id mid-storm via "
                         "the seeded fault plan's process scope (e.g. 'gw1')")
    ap.add_argument("--kill-tick", type=int, default=8,
                    help="health tick the --chaos-kill rule fires on")
    ap.add_argument("--per-gateway-max-peers", type=int, default=0,
                    help="fleet: per-gateway connection budget; the fleet "
                         "admission budget is the sum over CLOSED members "
                         "(0 = unlimited)")
    ap.add_argument("--providers", default="stdlib",
                    choices=("stdlib", "real"),
                    help="storm crypto: stdlib toys (serving-loop workload) "
                         "or ML-KEM-768+ML-DSA-65")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="storm session starts per second (0 = all at once "
                         "behind --concurrency)")
    ap.add_argument("--msgs-per-session", type=int, default=2)
    ap.add_argument("--bulk-mix", type=int, default=0,
                    help="storm: bulk-heavy profile — this many bulk "
                         "messages per session (overrides "
                         "--msgs-per-session) with 2 KiB payloads unless "
                         "--payload-bytes says otherwise")
    ap.add_argument("--aead", default="storm",
                    choices=("storm", "chacha", "chacha-scalar"),
                    help="storm bulk AEAD: stdlib toy (default), batched "
                         "ChaCha20-Poly1305 (K8 on the card), or its scalar path")
    ap.add_argument("--payload-bytes", type=int, default=0,
                    help="pad bulk message contents to this size "
                         "(0 = tiny payloads; --bulk-mix defaults this to 2048)")
    ap.add_argument("--resume-mix", action="store_true",
                    help="storm mode: every session drops its TCP "
                         "connection mid-workload and re-establishes via "
                         "its resumption ticket (1-RTT resume, no KEM/sig) "
                         "— reports the resume rate + cost probe")
    ap.add_argument("--rekey-every", type=int, default=0,
                    help="force a re-key every N bulk messages per session")
    ap.add_argument("--churn", type=float, default=0.0,
                    help="per-session probability of one churn cycle "
                         "(drop TCP, redial, re-key)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-autotune", dest="autotune", action="store_false",
                    default=True, help="storm: pin the static flush policy")
    ap.add_argument("--hub-max-peers", type=int, default=0)
    ap.add_argument("--handshake-budget", type=int, default=0)
    ap.add_argument("--bulk-lane-capacity", type=int, default=0)
    args = ap.parse_args(argv)
    if args.storm and args.fleet:
        from ..fleet.storm import (default_kill_rules, run_fleet_storm,
                                   write_fleet_artifacts)

        rules = (default_kill_rules(args.chaos_kill, args.kill_tick)
                 if args.chaos_kill else None)
        stats = asyncio.run(run_fleet_storm(
            args.peers, gateways=args.fleet, providers=args.providers,
            seed=args.seed, arrival_rate=args.arrival_rate,
            concurrency=args.concurrency,
            msgs_per_session=args.msgs_per_session, spawn=args.spawn,
            per_gateway_max_peers=args.per_gateway_max_peers,
            handshake_budget=args.handshake_budget,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            autotune=args.autotune, ke_timeout=args.ke_timeout,
            fault_rules=rules, backend=args.backend,
        ))
        if args.obs_dir:
            write_obs_artifacts(stats, args.obs_dir, stem="fleet_storm",
                                full_snapshots=args.full_snapshots)
            write_fleet_artifacts(stats, args.obs_dir)
        print(json.dumps(stats))
        # the fleet chaos currency: no ESTABLISHED session may be lost —
        # un-established failures under a kill are the bounded burst the
        # report carries
        return 0 if stats["lost_established_sessions"] == 0 else 1
    if args.storm:
        msgs = args.bulk_mix or args.msgs_per_session
        payload = args.payload_bytes or (2048 if args.bulk_mix else 0)
        stats = asyncio.run(run_storm(
            args.peers, providers=args.providers,
            arrival_rate=args.arrival_rate, concurrency=args.concurrency,
            msgs_per_session=msgs,
            rekey_every=args.rekey_every, churn_fraction=args.churn,
            seed=args.seed, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, autotune=args.autotune,
            hub_max_peers=args.hub_max_peers,
            handshake_budget=args.handshake_budget,
            bulk_lane_capacity=args.bulk_lane_capacity,
            shard_devices=args.shard_devices, ke_timeout=args.ke_timeout,
            aead_mode=args.aead, payload_bytes=payload,
            resume_mix=args.resume_mix, backend=args.backend,
        ))
        if args.obs_dir:
            write_obs_artifacts(stats, args.obs_dir, stem="storm",
                                full_snapshots=args.full_snapshots)
        print(json.dumps(stats))
        return 0 if stats["failures"] == 0 else 1
    if args.slo:
        args.concurrency = 1
    stats = asyncio.run(
        run_swarm(args.peers, args.backend, args.batch, args.max_batch,
                  args.max_wait_ms, args.concurrency, args.warmup,
                  args.ke_timeout, args.batch_floor, args.prewarm, args.slo,
                  args.shard_devices)
    )
    if args.slo and args.obs_dir:
        write_obs_artifacts(stats, args.obs_dir,
                            full_snapshots=args.full_snapshots)
    print(json.dumps(stats))
    return 0 if stats["failures"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
