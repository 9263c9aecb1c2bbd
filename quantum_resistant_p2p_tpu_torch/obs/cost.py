"""Device-cost ledger: what the device time is spent on.

Counterpart of the reference's ``obs/cost.py``.  The registry
(obs/metrics.py) answers "what is this process doing" and the SLO engine
(obs/slo.py) "is it doing it well enough"; this module answers **what the
device time is being spent on**:

* **Batch occupancy / padding waste**: every device flush pads up to a
  power-of-two bucket (``provider/batched.py``: ``max(bucket_floor,
  next_pow2(n))``), so real items vs padded slots is real money.  The
  ledger accounts both per (queue, lane) and derives
  ``padding_waste_fraction`` = padded / (real + padded).
* **Compile attribution**: every compile event carries its bucket, shard,
  wall seconds and WHERE it happened (``warmup``: a facade's warm-up; in
  the port that is the first launches, which build the kernel libraries,
  and the warm-up's operand-cache programs).
* **Device seconds**: cumulative on-worker device-call time per op family
  (encaps / sign / keygen_sign / ...) and per placement shard, plus the
  ``device_seconds_per_1k_handshakes`` derived gauge.
* **Opcache effectiveness**: sliding-window hit rates per cache (the
  cumulative counters hide regressions; a window shows the CURRENT rate).
* **Scalar bypasses**: items the device path never saw (AEAD payloads past
  the device's caps run scalar and never enqueue), so
  ``device_served_fraction`` = real / (real + bypassed) stays truthful.
* **Autotuner decision journal**: every ``decide()`` step with its inputs
  and chosen bucket/window, sequence-numbered and stamped with the
  tuner's clock.

:meth:`CostLedger.shard_device_time` is fed by the placement scheduler
(``provider/scheduler.py``, ``attach_cost``) and
:meth:`CostLedger.tuner_decision` by the autotuner
(``provider/autotune.py``).

Everything lands in the metrics registry given as labeled instruments
(``cost_compile_events{queue,shard,where}``,
``cost_flush_items_real{queue,lane}`` / ``…_padded``,
``cost_bypass_items{queue,reason}``,
``cost_device_seconds{op}``, ``opcache_hit_rate{cache}``,
``padding_waste_fraction``, ``device_seconds_per_1k_handshakes``), and
compile events additionally emit structured flight events
(``cost_compile``).

Hot-path discipline: the queue hooks are a few dict updates and counter
increments per FLUSH (never per op), ``device_time`` one per dispatch,
``opcache_event`` one deque append per lookup; the ledger observes, it
never steers when or what a flush dispatches.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

from . import flight as obs_flight

#: retained compile events / journal entries (bounded rings: the ledger
#: must stay O(1) memory under an unbounded storm)
COMPILE_EVENT_CAP = 1024
JOURNAL_CAP = 4096
#: opcache sliding-window length (lookups)
OPCACHE_WINDOW = 512
#: journal/compile tail served by snapshot() (full rings via journal())
SNAPSHOT_TAIL = 64


def _op_family(queue_label: str) -> str:
    """``"ML-KEM-768.enc" -> "enc"`` — the op family the device seconds
    aggregate by (algorithm names churn; the op families are the stable
    cost axis)."""
    return queue_label.rsplit(".", 1)[-1] if queue_label else "?"


class CostLedger:
    """Device-cost accounting for a set of facades (attach it as their
    ``cost`` and their queues', see ``provider.batched.facade_queues``).

    All mutation is lock-guarded: recorders run on the event loop and the
    device threads, and a scrape reads through gauge ``set_fn``
    callbacks.
    """

    def __init__(self, registry=None, clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        #: (queue, lane) -> [real_items, padded_slots, flushes]
        self._occ: dict[tuple[str, str], list] = {}
        #: (queue, reason) -> items that ran scalar, never enqueued
        self._bypass: dict[tuple[str, str], int] = {}
        #: (queue, shard_key, where) -> [events, wall_seconds]
        self._compile_totals: dict[tuple[str, str, str], list] = {}
        self._compile_events: deque[dict[str, Any]] = deque(maxlen=COMPILE_EVENT_CAP)
        #: op family -> on-worker device-program seconds
        self._device_s: dict[str, float] = {}
        #: placement shard index -> placed-program seconds
        self._shard_s: dict[int, float] = {}
        #: cache kind -> (window deque of 0/1, [hits, misses] cumulative)
        self._opcache: dict[str, tuple[deque, list]] = {}
        self._journal: deque[dict[str, Any]] = deque(maxlen=JOURNAL_CAP)
        self._journal_seq = 0
        self._handshakes_fn: Callable[[], int] | None = None
        # registry instruments (None without a registry: recording-only)
        self._ctr_compile = self._g_compile_s = None
        self._ctr_real = self._ctr_pad = self._ctr_bypass = None
        self._g_dev = self._g_hit = None
        if registry is not None:
            self._ctr_compile = registry.counter(
                "cost_compile_events",
                "device-program compile events, by queue/shard/where")
            self._g_compile_s = registry.gauge(
                "cost_compile_seconds",
                "cumulative compile wall seconds, by queue/shard/where")
            self._ctr_real = registry.counter(
                "cost_flush_items_real",
                "real items carried by device flushes, by queue/lane")
            self._ctr_pad = registry.counter(
                "cost_flush_items_padded",
                "padded pow2 slots dispatched empty, by queue/lane")
            self._ctr_bypass = registry.counter(
                "cost_bypass_items",
                "items served on the scalar path without enqueueing, "
                "by queue/reason")
            self._g_dev = registry.gauge(
                "cost_device_seconds",
                "cumulative on-worker device-program seconds, by op family")
            self._g_hit = registry.gauge(
                "opcache_hit_rate",
                f"operand-cache hit rate over the last {OPCACHE_WINDOW} "
                "lookups, by cache")
            registry.gauge(
                "padding_waste_fraction",
                "fraction of dispatched device-batch slots that were pow2 "
                "padding").set_fn(lambda: self.padding_waste_fraction())
            registry.gauge(
                "device_seconds_per_1k_handshakes",
                "cumulative device seconds per 1000 handshakes "
                "(initiated + admitted)"
            ).set_fn(lambda: self.device_seconds_per_1k_handshakes())

    @staticmethod
    def _child(inst, **kv):
        """Labeled child, or None without a registry.  ``labels()`` is
        already a locked create-or-return cache on the instrument family
        (obs/metrics.py) — a second ledger-side cache would only funnel
        every hook through the ledger-wide lock the scrape gauges contend
        on."""
        return inst.labels(**kv) if inst is not None else None

    # -- feeds ----------------------------------------------------------------

    def set_handshakes_fn(self, fn: Callable[[], int]) -> None:
        """Handshake-count feed for the per-1k derived gauge: count BOTH
        halves of the handshake work (initiated and admitted inbound), or
        a gateway that only responds reads None."""
        self._handshakes_fn = fn

    def flush_occupancy(self, queue: str, lane: str, real: int, bucket: int,
                        shard: int | None = None) -> None:
        """One device flush: ``real`` items padded up to ``bucket`` slots.
        Called per FLUSH on the device path."""
        padded = max(0, bucket - real)
        with self._lock:
            row = self._occ.setdefault((queue, lane), [0, 0, 0])
            row[0] += real
            row[1] += padded
            row[2] += 1
        c = self._child(self._ctr_real, queue=queue, lane=lane)
        if c is not None:
            c.inc(real)
            self._child(self._ctr_pad, queue=queue, lane=lane).inc(padded)

    def bypass_items(self, queue: str, reason: str, n: int = 1) -> None:
        """``n`` items served on the scalar path WITHOUT enqueueing (e.g.
        AEAD payloads past the device's caps).  Keeps the device-served
        denominator honest: these items are real traffic the occupancy
        rows never see."""
        with self._lock:
            key = (queue, reason)
            self._bypass[key] = self._bypass.get(key, 0) + n
        c = self._child(self._ctr_bypass, queue=queue, reason=reason)
        if c is not None:
            c.inc(n)

    def compile_event(self, queue: str, bucket: int, seconds: float,
                      where: str, shard: int | None = None) -> None:
        """One device-program compile: ``where`` is ``"warmup"`` (a
        facade's warm-up sweep) or ``"in_flush"`` (a live flush that hit a
        cold program)."""
        shard_key = str(shard) if shard is not None else "all"
        with self._lock:
            row = self._compile_totals.setdefault((queue, shard_key, where),
                                                  [0, 0.0])
            row[0] += 1
            row[1] += seconds
            self._compile_events.append({
                "t": round(self._clock(), 6), "queue": queue,
                "bucket": bucket, "shard": shard_key, "where": where,
                "seconds": round(seconds, 6),
            })
        c = self._child(self._ctr_compile, queue=queue, shard=shard_key,
                        where=where)
        if c is not None:
            c.inc()
            self._child(self._g_compile_s, queue=queue, shard=shard_key,
                        where=where).inc(seconds)
        # compiles are rare and expensive: each one is a flight event, so
        # a diagnostic bundle narrates where the compile seconds went
        obs_flight.record("cost_compile", queue=queue, bucket=bucket,
                          shard=shard_key, where=where,
                          seconds=round(seconds, 4))

    def device_time(self, queue: str, seconds: float) -> None:
        """On-worker device-call seconds for one dispatch (the queue's
        ``_traced_call`` measurement — no executor queueing)."""
        fam = _op_family(queue)
        with self._lock:
            self._device_s[fam] = self._device_s.get(fam, 0.0) + seconds
        c = self._child(self._g_dev, op=fam)
        if c is not None:
            c.inc(seconds)

    def shard_device_time(self, shard: int, seconds: float) -> None:
        """Placed-program seconds per placement shard."""
        with self._lock:
            self._shard_s[shard] = self._shard_s.get(shard, 0.0) + seconds

    def opcache_event(self, cache: str, hit: bool) -> None:
        with self._lock:
            entry = self._opcache.get(cache)
            fresh = entry is None
            if fresh:
                entry = (deque(maxlen=OPCACHE_WINDOW), [0, 0])
                self._opcache[cache] = entry
            entry[0].append(1 if hit else 0)
            entry[1][0 if hit else 1] += 1
        if fresh and self._g_hit is not None:
            # first sighting of this cache: arm its lazy hit-rate child
            self._child(self._g_hit, cache=cache).set_fn(
                lambda c=cache: self.opcache_hit_rate(c))

    def tuner_decision(self, queue: str, t: float, inputs: dict[str, Any],
                       bucket: int, window_s: float, saturated: bool,
                       degraded: bool) -> None:
        """One autotuner ``decide()`` step — EVERY step, not only changes.
        ``t`` is the tuner's own (injectable) clock so a seeded storm's
        journal replays deterministically."""
        with self._lock:
            self._journal_seq += 1
            self._journal.append({
                "seq": self._journal_seq, "t": round(t, 6), "queue": queue,
                "inputs": inputs, "bucket": bucket,
                "window_ms": round(window_s * 1e3, 3),
                "saturated": saturated, "degraded": degraded,
            })

    # -- derived reads --------------------------------------------------------

    def padding_waste_fraction(self, queue: str | None = None) -> float | None:
        """Padded slots / all dispatched slots (None before any flush)."""
        with self._lock:
            real = padded = 0
            for (q, _lane), row in self._occ.items():
                if queue is not None and q != queue:
                    continue
                real += row[0]
                padded += row[1]
        total = real + padded
        return round(padded / total, 6) if total else None

    def device_served_fraction(self, queue: str | None = None) -> float | None:
        """Real device-flushed items / (those + scalar bypasses) — the
        truthful "how much traffic the device actually served" gauge
        (None before any item either way)."""
        with self._lock:
            real = sum(row[0] for (q, _lane), row in self._occ.items()
                       if queue is None or q == queue)
            bypassed = sum(n for (q, _r), n in self._bypass.items()
                           if queue is None or q == queue)
        total = real + bypassed
        return round(real / total, 6) if total else None

    def device_seconds_total(self) -> float:
        with self._lock:
            return sum(self._device_s.values())

    def device_seconds_per_1k_handshakes(self) -> float | None:
        # no defensive except here: the gauge set_fn wrapper
        # (obs/metrics.py Gauge.value) already degrades a crashing
        # callback to None
        fn = self._handshakes_fn
        if fn is None:
            return None
        hs = int(fn())
        if hs <= 0:
            return None
        return round(self.device_seconds_total() * 1000.0 / hs, 6)

    def opcache_hit_rate(self, cache: str) -> float | None:
        with self._lock:
            entry = self._opcache.get(cache)
            if entry is None or not entry[0]:
                return None
            window = list(entry[0])
        return round(sum(window) / len(window), 6)

    def compile_totals(self) -> tuple[int, float]:
        """-> (events, wall seconds) across every queue/shard/where."""
        with self._lock:
            events = sum(r[0] for r in self._compile_totals.values())
            seconds = sum(r[1] for r in self._compile_totals.values())
        return events, round(seconds, 6)

    def journal(self) -> list[dict[str, Any]]:
        """The full (bounded) autotuner decision journal, oldest first."""
        with self._lock:
            return list(self._journal)

    def totals(self) -> dict[str, Any]:
        """The compact cross-process aggregation feed (numeric fields that
        sum across processes)."""
        events, seconds = self.compile_totals()
        with self._lock:
            real = sum(r[0] for r in self._occ.values())
            padded = sum(r[1] for r in self._occ.values())
            bypassed = sum(self._bypass.values())
            hits = sum(t[1][0] for t in self._opcache.values())
            misses = sum(t[1][1] for t in self._opcache.values())
            device_s = sum(self._device_s.values())
        total = real + padded
        served = real + bypassed
        looked = hits + misses
        return {
            "items_real": real,
            "items_padded": padded,
            "items_bypassed": bypassed,
            "padding_waste_fraction": (round(padded / total, 6)
                                       if total else None),
            "device_served_fraction": (round(real / served, 6)
                                       if served else None),
            "compile_events": events,
            "compile_seconds": seconds,
            "device_seconds": round(device_s, 6),
            "opcache_hits": hits,
            "opcache_misses": misses,
            "opcache_hit_rate_cumulative": (round(hits / looked, 6)
                                            if looked else None),
        }

    def snapshot(self) -> dict[str, Any]:
        """JSON-ready ledger document: per-queue occupancy, compile
        attribution, device seconds, opcache windows, and the journal
        tail."""
        with self._lock:
            occupancy = {
                f"{q}[{lane}]": {
                    "items_real": row[0], "items_padded": row[1],
                    "flushes": row[2],
                    "waste_fraction": (round(row[1] / (row[0] + row[1]), 6)
                                       if (row[0] + row[1]) else None),
                }
                for (q, lane), row in sorted(self._occ.items())
            }
            compiles = {
                f"{q}[shard={sh},{where}]": {
                    "events": row[0], "seconds": round(row[1], 6),
                }
                for (q, sh, where), row in sorted(self._compile_totals.items())
            }
            compile_tail = list(self._compile_events)[-SNAPSHOT_TAIL:]
            device_s = {k: round(v, 6)
                        for k, v in sorted(self._device_s.items())}
            shard_s = {str(k): round(v, 6)
                       for k, v in sorted(self._shard_s.items())}
            opcache = {
                kind: {
                    "window": len(win),
                    "window_hit_rate": (round(sum(win) / len(win), 6)
                                        if win else None),
                    "hits": totals[0], "misses": totals[1],
                }
                for kind, (win, totals) in sorted(self._opcache.items())
            }
            bypass = {
                f"{q}[{reason}]": n
                for (q, reason), n in sorted(self._bypass.items())
            }
            journal_tail = list(self._journal)[-SNAPSHOT_TAIL:]
            journal_seq = self._journal_seq
        return {
            "padding_waste_fraction": self.padding_waste_fraction(),
            "device_served_fraction": self.device_served_fraction(),
            "bypasses": bypass,
            "device_seconds_total": round(self.device_seconds_total(), 6),
            "device_seconds_per_1k_handshakes":
                self.device_seconds_per_1k_handshakes(),
            "occupancy": occupancy,
            "compiles": compiles,
            "recent_compiles": compile_tail,
            "device_seconds_by_op": device_s,
            "device_seconds_by_shard": shard_s,
            "opcaches": opcache,
            "tuner_journal_len": journal_seq,
            "tuner_journal_tail": journal_tail,
        }
