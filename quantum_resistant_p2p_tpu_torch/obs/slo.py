"""SLO / burn-rate alert engine: "should a human care right now".

Counterpart of the reference's ``obs/slo.py``.  The registry
(obs/metrics.py) answers "what is this process doing"; this module
answers "is it doing it WELL ENOUGH, and how fast is it eating its error
budget".  A :class:`SLOSpec` declares one objective over one
service-level indicator: a ``probe()`` returning cumulative ``(good,
bad)`` totals (handshakes under the latency threshold vs over it, served
vs shed requests), events or seconds alike.

The engine samples every probe on an INJECTABLE clock and evaluates
multi-window burn rates (SRE workbook shape): over a FAST window (default
5 m) and a SLOW window (default 1 h),

    ``burn = (bad_delta / total_delta) / (1 - objective)``

— burn 1.0 consumes exactly the error budget the objective allows; the
alert fires only when BOTH windows exceed their thresholds (the fast
window gives speed, the slow window immunity to blips).  A process
younger than a window evaluates over the history it has, so a sustained
burn in a 30-second run still fires deterministically.

On each alert edge the engine emits a structured ``slo_burn`` flight
event via :func:`obs.flight.trigger` (an armed recorder writes the
diagnostic bundle that explains the burn) plus ONE rate-limited WARNING
per episode.  Budget and burn gauges land in the registry
(``slo_budget_remaining`` / ``slo_burn_fast`` / ``slo_burn_slow``,
labeled ``slo=<name>``), and :meth:`SLOEngine.status` is the JSON report.

A time SLI over a provider breaker (:func:`breaker_availability_probe`:
wall time the breaker was closed vs degraded) uses the same shape.
Stdlib only; probes read counters other layers already keep.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable

from . import flight as _flight

logger = logging.getLogger(__name__)

#: burn-rate window defaults: fast catches a cliff in minutes, slow
#: confirms it is sustained (SRE-workbook multi-window shape)
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0

#: default burn thresholds, tuned for ~99% objectives (a 100% error rate
#: burns at 1/(1-objective), so specs with looser objectives pass lower
#: thresholds explicitly — the engine caps nothing)
FAST_BURN_THRESHOLD = 14.4
SLOW_BURN_THRESHOLD = 1.0

Probe = Callable[[], "tuple[float, float]"]

#: per-spec cap on retained probe samples.  Evaluation frequency is
#: caller-controlled (every status read or scrape ticks the engine), so a hot scraper can produce far more samples per
#: slow window than any fixed ring holds — when the cap is hit the engine
#: DECIMATES interior samples (halving resolution) instead of evicting
#: the oldest: burn math needs the window BASELINES, and silently
#: dropping them collapses the slow window toward the fast one, which
#: un-filters exactly the blips the multi-window design exists to ignore.
MAX_SAMPLES = 4096


class SLOSpec:
    """One declarative objective: name, target fraction, and the probe
    supplying cumulative ``(good, bad)`` totals for its indicator.

    ``fast_burn``/``slow_burn`` are the per-window alert thresholds; both
    windows must exceed theirs for the spec to alert.  Objectives looser
    than ~99% should pass thresholds below ``1/(1-objective)`` (the burn
    ceiling a total outage can reach) or the alert can never fire.
    """

    __slots__ = ("name", "objective", "probe", "description",
                 "fast_window_s", "slow_window_s", "fast_burn", "slow_burn")

    def __init__(self, name: str, objective: float, probe: Probe,
                 description: str = "",
                 fast_window_s: float = FAST_WINDOW_S,
                 slow_window_s: float = SLOW_WINDOW_S,
                 fast_burn: float = FAST_BURN_THRESHOLD,
                 slow_burn: float = SLOW_BURN_THRESHOLD):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if fast_window_s >= slow_window_s:
            raise ValueError("fast window must be shorter than the slow one")
        self.name = name
        self.objective = objective
        self.probe = probe
        self.description = description
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.fast_burn = fast_burn
        self.slow_burn = slow_burn


class _SpecState:
    """Engine-private per-spec sample ring + alert latch."""

    __slots__ = ("spec", "samples", "alerting", "alerts", "last_warn_t")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        #: (t, good_total, bad_total) samples, oldest first; pruned to the
        #: slow window plus one baseline sample just outside it, and
        #: decimated (never baseline-evicted) at MAX_SAMPLES
        self.samples: deque[tuple[float, float, float]] = deque()
        self.alerting = False
        self.alerts = 0
        self.last_warn_t: float | None = None


def _decimate(samples: "deque[tuple[float, float, float]]") -> None:
    """Drop every other INTERIOR sample in place, keeping the oldest
    (the slow window's baseline) and the newest (the latest totals).

    Burn rates only read the newest-at-or-before-cutoff baseline and the
    head, so halving interior resolution costs a little window-edge
    precision; evicting oldest-first (the previous ``deque(maxlen=…)``)
    cost the baseline itself and quietly shortened the slow window."""
    kept = [samples[0]]
    kept.extend(list(samples)[2:-1:2])
    kept.append(samples[-1])
    samples.clear()
    samples.extend(kept)


def _window_rates(samples: "deque[tuple[float, float, float]]",
                  now: float, window_s: float) -> tuple[float, float]:
    """-> (error_rate, total_delta) over the trailing window.

    Baseline = the newest sample at/older than ``now - window_s`` (exact
    window) or the oldest sample available (short-history processes: the
    window is "all of history so far", which is the honest answer for a
    process younger than the window)."""
    if len(samples) < 2:
        return 0.0, 0.0
    cutoff = now - window_s
    base = samples[0]
    for s in samples:
        if s[0] <= cutoff:
            base = s
        else:
            break
    latest = samples[-1]
    good_d = max(0.0, latest[1] - base[1])
    bad_d = max(0.0, latest[2] - base[2])
    total = good_d + bad_d
    if total <= 0.0:
        return 0.0, 0.0
    return bad_d / total, total


class SLOEngine:
    """Evaluates a set of :class:`SLOSpec`\\ s over sampled probe history.

    ``clock`` is injectable (tests drive deterministic timelines);
    ``registry`` (obs/metrics.py) receives the labeled budget/burn gauges
    when provided.  :meth:`status` = sample + evaluate + report; callers
    that only want the side effects (gauges, alerts, flight events) use
    :meth:`evaluate`.
    """

    def __init__(self, registry=None, clock: Callable[[], float] = time.monotonic,
                 warn_interval_s: float = 300.0):
        self._lock = threading.Lock()
        self._states: dict[str, _SpecState] = {}
        self._clock = clock
        self._warn_interval_s = warn_interval_s
        self._g_budget = self._g_fast = self._g_slow = None
        if registry is not None:
            self._g_budget = registry.gauge(
                "slo_budget_remaining",
                "error budget left in the slow window, per SLO (1 = untouched)")
            self._g_fast = registry.gauge(
                "slo_burn_fast", "fast-window burn rate, per SLO")
            self._g_slow = registry.gauge(
                "slo_burn_slow", "slow-window burn rate, per SLO")

    def add(self, spec: SLOSpec) -> SLOSpec:
        """Register a spec (replacing any previous one of the same name)."""
        with self._lock:
            self._states[spec.name] = _SpecState(spec)
        return spec

    def names(self) -> list[str]:
        with self._lock:
            return list(self._states)

    # -- sampling / evaluation ------------------------------------------------

    def tick(self) -> None:
        """Sample every probe once at the current clock reading."""
        now = self._clock()
        with self._lock:
            states = list(self._states.values())
        for st in states:
            try:
                good, bad = st.spec.probe()
            except Exception:
                # one crashing probe (e.g. a mid-teardown queue) must not
                # stop the other SLOs evaluating
                logger.debug("slo probe %s failed", st.spec.name, exc_info=True)
                continue
            with self._lock:
                st.samples.append((now, float(good), float(bad)))
                # prune: everything newer than the slow window stays, plus
                # ONE baseline sample at/older than its left edge
                cutoff = now - st.spec.slow_window_s
                while (len(st.samples) > 2 and st.samples[1][0] <= cutoff):
                    st.samples.popleft()
                if len(st.samples) > MAX_SAMPLES:
                    _decimate(st.samples)

    def probe_totals(self) -> dict[str, tuple[float, float]]:
        """Sample every probe once and return the cumulative ``(good,
        bad)`` totals by spec name — the cross-process aggregation feed
        (sum them across processes and evaluate ONE engine over the sums;
        :func:`merge_reports` is the offline twin over written reports)."""
        out: dict[str, tuple[float, float]] = {}
        with self._lock:
            states = list(self._states.values())
        for st in states:
            try:
                good, bad = st.spec.probe()
            except Exception:
                logger.debug("slo probe %s failed", st.spec.name,
                             exc_info=True)
                continue
            out[st.spec.name] = (float(good), float(bad))
        return out

    def evaluate(self) -> list[dict[str, Any]]:
        """Sample, compute burn rates, update gauges, fire alert edges."""
        self.tick()
        now = self._clock()
        out: list[dict[str, Any]] = []
        with self._lock:
            states = list(self._states.values())
        for st in states:
            spec = st.spec
            with self._lock:
                samples = deque(st.samples)
            err_fast, total_fast = _window_rates(samples, now, spec.fast_window_s)
            err_slow, total_slow = _window_rates(samples, now, spec.slow_window_s)
            budget = 1.0 - spec.objective
            burn_fast = err_fast / budget
            burn_slow = err_slow / budget
            remaining = max(0.0, min(1.0, 1.0 - burn_slow))
            alerting = (total_fast > 0.0
                        and burn_fast >= spec.fast_burn
                        and burn_slow >= spec.slow_burn)
            self._latch(st, alerting, burn_fast, burn_slow, remaining, now)
            if self._g_budget is not None:
                self._g_budget.labels(slo=spec.name).set(round(remaining, 6))
                self._g_fast.labels(slo=spec.name).set(round(burn_fast, 6))
                self._g_slow.labels(slo=spec.name).set(round(burn_slow, 6))
            latest = samples[-1] if samples else (now, 0.0, 0.0)
            out.append({
                "name": spec.name,
                "description": spec.description,
                "objective": spec.objective,
                "windows_s": {"fast": spec.fast_window_s,
                              "slow": spec.slow_window_s},
                "thresholds": {"fast_burn": spec.fast_burn,
                               "slow_burn": spec.slow_burn},
                "good_total": round(latest[1], 6),
                "bad_total": round(latest[2], 6),
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "budget_remaining": round(remaining, 4),
                "alerting": st.alerting,
                "alerts": st.alerts,
            })
        return out

    def _latch(self, st: _SpecState, alerting: bool, burn_fast: float,
               burn_slow: float, remaining: float, now: float) -> None:
        """Alert edge handling: flight event + rate-limited one-time
        WARNING on entry, a structured recovery event on exit."""
        spec = st.spec
        with self._lock:
            entered = alerting and not st.alerting
            recovered = st.alerting and not alerting
            st.alerting = alerting
            if entered:
                st.alerts += 1
            rewarn = (alerting and not entered
                      and st.last_warn_t is not None
                      and now - st.last_warn_t >= self._warn_interval_s)
            if entered or rewarn:
                st.last_warn_t = now
        if entered:
            # the trigger rides the flight recorder's auto-dump machinery:
            # an armed recorder writes the bundle that explains the burn
            _flight.trigger(
                "slo_burn", slo=spec.name, objective=spec.objective,
                burn_fast=round(burn_fast, 4), burn_slow=round(burn_slow, 4),
                budget_remaining=round(remaining, 4), alerts=st.alerts,
            )
        if entered or rewarn:
            logger.warning(
                "SLO %s burning: fast-window burn %.1fx budget (threshold "
                "%.1fx), slow-window %.1fx (threshold %.1fx); error budget "
                "remaining %.0f%%",
                spec.name, burn_fast, spec.fast_burn, burn_slow,
                spec.slow_burn, remaining * 100.0,
            )
        if recovered:
            _flight.record(
                "slo_recovered", slo=spec.name,
                burn_fast=round(burn_fast, 4), burn_slow=round(burn_slow, 4),
            )

    def status(self) -> dict[str, Any]:
        """Evaluate and report: per-spec burn/budget plus the alerting
        roll-up."""
        specs = self.evaluate()
        return {
            "specs": specs,
            "alerting": [s["name"] for s in specs if s["alerting"]],
            "alerts_total": sum(s["alerts"] for s in specs),
        }


# -- cross-process aggregation ------------------------------------------------


def merge_reports(reports: "list[dict[str, Any]]") -> dict[str, Any]:
    """Merge N per-node SLO reports (``{"node": ..., "slo": status()}``
    documents, one a process) into ONE fleet report: per-SLO fleet totals
    and burn (cumulative), plus worst-node attribution so a fleet-level
    burn points at the node eating the budget.  Specs are merged BY NAME, so per-node specs that
    share a name (every gateway's ``handshake_p99``) aggregate while
    node-unique ones pass through with one contributor."""
    slos: dict[str, dict[str, Any]] = {}
    nodes: list[str] = []
    for rep in reports:
        node = str(rep.get("node", f"node{len(nodes)}"))
        nodes.append(node)
        for spec in (rep.get("slo") or {}).get("specs", []):
            name = spec.get("name")
            if not name:
                continue
            e = slos.setdefault(name, {
                "name": name,
                "objective": spec.get("objective"),
                "good_total": 0.0,
                "bad_total": 0.0,
                "nodes": 0,
                "worst_node": None,
                "worst_node_burn_fast": None,
                "alerting_nodes": [],
            })
            e["good_total"] += float(spec.get("good_total") or 0.0)
            e["bad_total"] += float(spec.get("bad_total") or 0.0)
            e["nodes"] += 1
            burn = float(spec.get("burn_fast") or 0.0)
            if (e["worst_node_burn_fast"] is None
                    or burn > e["worst_node_burn_fast"]):
                e["worst_node_burn_fast"] = round(burn, 4)
                e["worst_node"] = node
            if spec.get("alerting"):
                e["alerting_nodes"].append(node)
    worst_node = None
    worst_burn = -1.0
    for e in slos.values():
        total = e["good_total"] + e["bad_total"]
        err = (e["bad_total"] / total) if total else 0.0
        budget = 1.0 - (e["objective"] or 0.0)
        e["fleet_error_rate"] = round(err, 6)
        e["fleet_burn"] = round(err / budget, 4) if budget > 0 else None
        e["good_total"] = round(e["good_total"], 6)
        e["bad_total"] = round(e["bad_total"], 6)
        if (e["worst_node_burn_fast"] or 0.0) > worst_burn:
            worst_burn = e["worst_node_burn_fast"] or 0.0
            worst_node = e["worst_node"]
    return {
        "nodes": nodes,
        "slos": {name: slos[name] for name in sorted(slos)},
        "worst_node": worst_node,
        "alerting": sorted({n for e in slos.values()
                            for n in e["alerting_nodes"]}),
    }


# -- probes over the counters other layers already keep ---------------


def latency_probe(hist, threshold_s: float) -> Probe:
    """Event SLI over a fixed-bucket :class:`obs.metrics.Histogram`: good =
    samples at/under the largest bucket boundary <= ``threshold_s`` (pick a
    threshold ON a boundary for an exact split), bad = the rest."""
    boundary = None
    for b in hist.boundaries:
        if b <= threshold_s:
            boundary = b
        else:
            break
    if boundary is None:
        raise ValueError(
            f"threshold {threshold_s}s is below the smallest bucket "
            f"boundary {hist.boundaries[0]}s")
    bucket_le = format(boundary, "g")

    def probe() -> tuple[float, float]:
        counts = hist.bucket_counts()
        total = counts["+Inf"]
        good = counts[bucket_le]
        return float(good), float(total - good)

    return probe


def counter_pair_probe(good_fn: Callable[[], float],
                       bad_fn: Callable[[], float]) -> Probe:
    """Event SLI from two cumulative counter reads."""
    def probe() -> tuple[float, float]:
        return float(good_fn()), float(bad_fn())

    return probe


def breaker_availability_probe(breaker,
                               clock: Callable[[], float] = time.monotonic
                               ) -> Probe:
    """Time SLI over a provider breaker (provider/batched.py): bad = the
    cumulative seconds its device path was NOT closed
    (:meth:`Breaker.degraded_seconds`), good = the rest of wall time.
    Offsets cancel in the engine's window deltas, so the raw clock reading
    works as the total-time side."""
    def probe() -> tuple[float, float]:
        bad = breaker.degraded_seconds()
        return clock() - bad, bad

    return probe
