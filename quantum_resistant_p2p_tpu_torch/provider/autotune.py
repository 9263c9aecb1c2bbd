"""Adaptive batch-size and flush-window autotuner.

Counterpart of the reference's ``provider/autotune.py``, decision for
decision.  The batching queues (provider/batched.py) have two knobs that
decide the throughput/latency trade under load: WHEN a flush fires (the
timer window) and HOW BIG a flush tries to be (the flush-at count).  The
tuner reads the counters the queues already keep (``QueueStats``: op and
flush counts, the loop-side dispatch and on-worker device latency
histograms, fallback flushes) and derives, per queue:

* ``bucket``: the demand-following right size, the power of two that
  just covers the observed average flush (jumping up in one step,
  shrinking one power of two a step).  While the host keeps up, a wave
  reaching twice the bucket flushes at once.
* ``window_s``: the timer backstop, about twice the on-worker device p50
  while the host keeps up, opened to the cap when the gap between the
  loop-side and the on-worker latency says the host itself is saturated.

Degraded traffic (a breaker not closed, or fallback flushes since the
last step) snaps both knobs down: canary probes must reach the device
promptly, and padded batches are wasted work on the fallback.

The tuner changes only WHEN a flush fires and how many items it carries;
padding is untouched, so every dispatch computes what the static
configuration would.  ``QRP2P_AUTOTUNE=0`` (:func:`autotune_enabled_default`)
tells the caller to attach no tuner, and the queues then read their
constructor values.  Decisions are made on the event loop (stepping rides
flush completion); tuner state is read under a lock, since gauge
callbacks run on whatever thread takes a snapshot.  Every step is
journaled to an attached cost ledger (``tuner_decision``), and every
change is a ``tuner_step`` flight event.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable

from ..obs import flight as obs_flight
from .base import next_pow2 as _next_pow2

logger = logging.getLogger(__name__)

AUTOTUNE_ENV = "QRP2P_AUTOTUNE"


def autotune_enabled_default() -> bool:
    """The env default: ``QRP2P_AUTOTUNE=0`` disables, anything else (or
    unset) enables.  Engines may override per instance (``autotune=``)."""
    return os.environ.get(AUTOTUNE_ENV, "1") != "0"


@dataclass(frozen=True)
class TunerConfig:
    """Bounds and cadence for the decision loop.  All decisions derive
    from queue counters and the injected clock, so a synthetic trace with a
    synthetic clock reproduces the exact decision sequence."""

    #: flush-window clamp (seconds)
    min_window_s: float = 0.0005
    max_window_s: float = 0.020
    #: largest flush-at bucket the tuner may choose
    max_bucket: int = 4096
    #: dispatch p99 budget: a bucket whose flushes exceed this steps down
    latency_budget_s: float = 0.050
    #: decision cadence: at most one step per interval, and only with
    #: at least this many flushes of fresh evidence
    step_interval_s: float = 0.25
    min_flushes_per_step: int = 4


def decide(cur_bucket: int, floor: int, avg_batch: float,
           p50_device_s: float | None, p50_dispatch_s: float | None,
           degraded: bool, cfg: TunerConfig) -> tuple[int, float, bool]:
    """Pure decision function: -> (bucket, window_s, saturated).

    Separated from the stateful stepper so the policy is a function of its
    inputs alone.

    * **window** — the two-regime rule:

      - *keeping up* (loop-observed dispatch latency ~= on-worker program
        time, ``p50_dispatch_s ~= p50_device_s``): track the AMORTIZATION
        BOUND, ~2x the typical device-program time, floored at
        ``min_window_s``.  Cheap warm dispatches flush near-immediately —
        LOWER added latency than any static constant — while expensive
        device programs earn wide windows and real coalescing.
      - *saturated* (loop-observed latency well above on-worker time: the
        dispatch path is QUEUEING; the host, not the device, is the
        bottleneck): open the window to the cap.  Per-flush overhead is
        what is drowning the host, and bigger batches are the only lever
        that reduces it; small "responsive" windows here shatter the
        work into more overhead.

    * **bucket** is the DEMAND-FOLLOWING right-size: the pow2 that just
      covers the observed average flush.  It JUMPS up to demand in one
      step (a climb-one-pow2-per-step transient sits below live demand
      and shatters coalesced batches into undersized flushes) and shrinks
      at most one pow2 per step (hysteresis).  While KEEPING UP, the hot
      path flushes early at 2x the bucket — clear evidence of a fuller-
      than-usual wave, dispatched without waiting out the window's tail.
      While SATURATED the early trigger disengages entirely (it would
      shear backlog-grown waves in half, and under saturation bigger
      batches are the only lever): flushes then fire on the timer alone.  The trigger is never a cap either way; a
      burst still flushes whole.
    * **degraded** (breaker open / half-open, fallback flushes observed)
      snaps both to the floor: canary probes must sample the device
      promptly and fallback batches amortise nothing.
    """
    floor = max(1, _next_pow2(floor))
    if degraded:
        return floor, cfg.min_window_s, False
    dev = p50_device_s if p50_device_s is not None else 0.0
    disp = p50_dispatch_s if p50_dispatch_s is not None else dev
    queueing = max(0.0, disp - dev)
    saturated = queueing > 2.0 * max(dev, cfg.min_window_s)
    if saturated:
        window = min(cfg.max_window_s, cfg.latency_budget_s)
    else:
        window = min(max(2.0 * dev, cfg.min_window_s), cfg.max_window_s,
                     cfg.latency_budget_s)
    target = _next_pow2(max(1, int(avg_batch + 0.5)))
    if target < cur_bucket:
        # shrink hysteresis: one pow2 per step
        target = max(target, cur_bucket // 2)
    bucket = min(max(target, floor), cfg.max_bucket)
    return bucket, window, saturated


class QueueTuner:
    """Per-queue adaptive state: the hot-path reads (flush-at bucket,
    flush window) plus the stepper that refreshes them from the queue's
    own counters.

    The queue holds a strong reference to its tuner; the tuner holds the
    queue weakly (facades are rebuilt on algorithm hot-swap and their dead
    queues must not linger).  All state crossing the lock is scalar, so
    the hot-path reads are two lock acquisitions per flush decision.
    """

    def __init__(self, queue, cfg: TunerConfig,
                 clock: Callable[[], float] = time.monotonic,
                 scheduler=None, cost=None):
        #: guards every read/write of decision state: written on the event
        #: loop (step), read from gauge/exporter/dump threads
        self._lock = threading.Lock()
        self._queue = weakref.ref(queue)
        self.label = queue.label
        self.cfg = cfg
        self._clock = clock
        self._scheduler = scheduler
        #: decision journal sink (obs/cost.py CostLedger): EVERY step is
        #: journaled with its inputs — the flight ``tuner_step`` event
        #: covers changes only; None (the default) journals nothing
        self._cost = cost
        self._floor = max(1, _next_pow2(queue.bucket_floor))
        #: cold-start prior: None = the STATIC configuration (flush at
        #: max_batch, the constructor window) until the first informed
        #: step — a fresh engine behaves exactly like the static stack
        #: for its first quarter second
        self.bucket: int | None = None
        self.window_s: float | None = None
        self.steps = 0
        self.changes = 0
        self.degraded = False
        self.saturated = False
        # last-step snapshot of the queue counters
        self._last_t = clock()
        self._last_ops = queue.stats.ops
        self._last_flushes = queue.stats.flushes
        self._last_fallback = queue.stats.fallback_flushes

    # -- hot path (event loop) ------------------------------------------------

    def flush_at(self) -> int | None:
        """Pending-op count that triggers an immediate flush (None: read
        the static configuration — before the first informed step, and
        whenever the host is SATURATED, where early triggering shears
        backlog-grown waves; see ``decide``).  Otherwise 2x the right-size
        bucket: a wave clearly fuller than typical dispatches without
        waiting out the window's tail, while typical batches are never
        undercut (shattering guard)."""
        with self._lock:
            if self.bucket is None or self.saturated:
                return None
            return 2 * self.bucket

    def chosen_bucket(self) -> int | None:
        """The right-size bucket itself (gauges; flush_at is 2x this)."""
        with self._lock:
            return self.bucket

    def alive(self) -> bool:
        """False once the tuned queue is gone (its facade was rebuilt):
        the gauge children registered for this tuner must stop reporting a
        live-looking value for a dead plane."""
        return self._queue() is not None

    def wait_s(self) -> float | None:
        """Timer window for a partially filled bucket (None = static)."""
        with self._lock:
            return self.window_s

    def maybe_step(self) -> bool:
        """Step if the cadence allows (called from flush completion; no
        background task, so a synthetic clock drives it deterministically)."""
        q = self._queue()
        if q is None:
            return False
        now = self._clock()
        with self._lock:
            due = (now - self._last_t >= self.cfg.step_interval_s
                   and q.stats.flushes - self._last_flushes
                   >= self.cfg.min_flushes_per_step)
        if not due:
            return False
        self.step()
        return True

    # -- decisions ------------------------------------------------------------

    def _plane_degraded(self, q) -> bool:
        """Breaker-probe traffic on the path this queue dispatches to: any
        placement shard (or the single breaker) not closed."""
        if self._scheduler is not None:
            return any(s.breaker.state != "closed"
                       for s in self._scheduler.shards)
        return q.breaker.state != "closed"

    def step(self) -> None:
        """One decision from the counter deltas since the last step."""
        q = self._queue()
        if q is None:
            return
        now = self._clock()
        st = q.stats
        ops, flushes, fallback = st.ops, st.flushes, st.fallback_flushes
        # two latencies, one signal: device_hist is ON-WORKER program time,
        # dispatch_hist is loop-observed (program + executor queueing) —
        # their gap is the saturation detector (see ``decide``)
        p50_device = st.device_hist.percentile(50)
        p50_dispatch = st.dispatch_hist.percentile(50)
        degraded = fallback > self._last_fallback or self._plane_degraded(q)
        with self._lock:
            dt = max(now - self._last_t, 1e-9)
            rate = (ops - self._last_ops) / dt
            avg_batch = ((ops - self._last_ops)
                         / max(1, flushes - self._last_flushes))
            old_bucket, old_window = self.bucket, self.window_s
            self.bucket, self.window_s, self.saturated = decide(
                old_bucket if old_bucket is not None else self._floor,
                q.bucket_floor, avg_batch, p50_device, p50_dispatch,
                degraded, self.cfg
            )
            self.degraded = degraded
            self.steps += 1
            self._last_t = now
            self._last_ops, self._last_flushes = ops, flushes
            self._last_fallback = fallback
            changed = (self.bucket != old_bucket
                       or old_window is None
                       or abs(self.window_s - old_window) > 1e-9)
            if changed:
                self.changes += 1
            bucket, window_s = self.bucket, self.window_s
            saturated = self.saturated
        if self._cost is not None:
            # the full trajectory: every decide() step with its inputs,
            # stamped with the tuner's own (injectable) clock — a seeded
            # storm's tuning history replays deterministically from it
            self._cost.tuner_decision(
                self.label, now,
                {
                    "avg_batch": round(avg_batch, 4),
                    "rate_ops_s": round(rate, 2),
                    "p50_device_ms": (round(p50_device * 1e3, 3)
                                      if p50_device is not None else None),
                    "p50_dispatch_ms": (round(p50_dispatch * 1e3, 3)
                                        if p50_dispatch is not None else None),
                },
                bucket, window_s, saturated, degraded,
            )
        if changed:
            # decision CHANGES are flight events (every step would be
            # noise); the dump narrates why the serving loop re-shaped
            obs_flight.record(
                "tuner_step", queue=self.label, bucket=bucket,
                window_ms=round(window_s * 1e3, 3), rate_ops_s=round(rate, 1),
                avg_batch=round(avg_batch, 2),
                p50_device_ms=(round(p50_device * 1e3, 3)
                               if p50_device else None),
                p50_dispatch_ms=(round(p50_dispatch * 1e3, 3)
                                 if p50_dispatch else None),
                degraded=degraded,
            )

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "bucket": self.bucket,  # None = static cold-start prior
                "window_ms": (round(self.window_s * 1e3, 3)
                              if self.window_s is not None else None),
                "steps": self.steps,
                "changes": self.changes,
                "degraded": self.degraded,
                "saturated": self.saturated,
            }


class Autotuner:
    """The engine-level tuner set: one :class:`QueueTuner` per attached
    OpQueue, plus the obs surface (``autotune_chosen_bucket`` /
    ``autotune_flush_window_ms`` gauge children labeled by queue).

    Facades are rebuilt on algorithm hot-swap, so the engine re-attaches
    after every rebuild; attach is idempotent per queue object.
    """

    def __init__(self, registry=None, cfg: TunerConfig | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 scheduler=None, cost=None):
        self.cfg = cfg if cfg is not None else TunerConfig()
        self._clock = clock
        self._scheduler = scheduler
        self._cost = cost
        self._lock = threading.Lock()
        #: queue -> tuner (weak keys: hot-swapped facades' queues die)
        self._tuners: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._g_bucket = self._g_window = None
        if registry is not None:
            self._g_bucket = registry.gauge(
                "autotune_chosen_bucket", "tuner-chosen flush-at bucket")
            self._g_window = registry.gauge(
                "autotune_flush_window_ms", "tuner-chosen flush window (ms)")

    def attach_queue(self, queue) -> QueueTuner:
        with self._lock:
            tuner = self._tuners.get(queue)
            if tuner is not None:
                return tuner
            tuner = QueueTuner(queue, self.cfg, self._clock,
                               scheduler=self._scheduler, cost=self._cost)
            self._tuners[queue] = tuner
        queue.tuner = tuner
        if self._g_bucket is not None:
            # lazy children: the scrape thread reads through the tuner
            # lock; 0 = "static cold-start prior, no decision yet"; None
            # (-> JSON null / Prometheus NaN) once the queue died in a
            # rebuild: a dead plane must not keep exporting a live-looking
            # last value
            self._g_bucket.labels(queue=tuner.label).set_fn(
                lambda t=tuner: (t.chosen_bucket() or 0) if t.alive()
                else None)
            self._g_window.labels(queue=tuner.label).set_fn(
                lambda t=tuner: (t.wait_s() or 0.0) * 1e3 if t.alive()
                else None)
        return tuner

    def attach_facades(self, *facades) -> None:
        """Attach every OpQueue of the given batched facades (None entries
        are skipped — the fused facade is optional)."""
        from .batched import facade_queues

        for facade in facades:
            if facade is None:
                continue
            for q in facade_queues(facade):
                self.attach_queue(q)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            tuners = list(self._tuners.values())
        return {
            "enabled": True,
            "queues": {t.label: t.snapshot() for t in tuners},
        }
