"""Typed metrics registry: Counter / Gauge / Histogram with exporters.

Counterpart of the reference's ``obs/metrics.py``.  One snapshot answers
"what is this process doing" and one Prometheus scrape exports it.

Design constraints, in order:

* **Thread-safe**: instruments are hit from the event loop and from the
  facades' device threads; every mutation takes a lock.
* **No per-record allocation on the hot path**: ``Counter.inc`` is an int
  add, ``Histogram.record`` a linear scan over a handful of fixed bucket
  boundaries into a preallocated count list.  Percentiles are
  bucket-resolution estimates (exact when the boundaries are exact, e.g.
  integer trip counts); the sliding-window :class:`LatencyHistogram` (the
  batching queue's ``QueueStats``) keeps exact sample percentiles.
* **Two sources, one snapshot**: instruments owned by the registry, plus
  COLLECTORS: callbacks over live objects that keep their own counters
  (``QueueStats``, operand caches), read at snapshot/export time instead
  of counted twice at record time.

Exporters: :meth:`Registry.snapshot` (JSON-ready nested dict) and
:meth:`Registry.to_prometheus` (Prometheus text exposition format).
Metric LABEL VALUES are public metadata only.
"""

from __future__ import annotations

import collections
import contextlib
import re
import threading
import time
import weakref
from typing import Any, Callable

#: all live registries (weak: a torn-down engine's registry disappears)
_REGISTRIES: "weakref.WeakSet[Registry]" = weakref.WeakSet()
_REGISTRIES_LOCK = threading.Lock()

#: default latency bucket boundaries (seconds): 1 ms .. 60 s, roughly 1-2-5
DEFAULT_LATENCY_BUCKETS = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2,
                           0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0)

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return _PROM_NAME_RE.sub("_", name)


def _prom_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_PROM_LABEL_RE.sub("_", k)}="{str(v)}"' for k, v in labels
    )
    return "{" + inner + "}"


class _Instrument:
    """Shared base: name, help text, and the labeled-child machinery.

    ``labels(**kv)`` returns (creating on first use) a child instrument of
    the same type keyed by the sorted label set; children are exported as
    extra sample lines carrying the label set.
    """

    kind = "untyped"

    def __init__(self, name: str, desc: str = "",
                 labels: tuple[tuple[str, str], ...] = ()):
        self.name = name
        self.desc = desc
        self.label_set = labels
        self._lock = threading.Lock()
        self._children: dict[tuple[tuple[str, str], ...], _Instrument] = {}

    def labels(self, **kv: Any) -> "_Instrument":
        key = tuple(sorted((k, str(v)) for k, v in kv.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child(key)
                self._children[key] = child
            return child

    def _make_child(self, key: tuple[tuple[str, str], ...]) -> "_Instrument":
        return type(self)(self.name, self.desc, labels=key)

    def _each(self) -> "list[_Instrument]":
        with self._lock:
            return [self, *self._children.values()]


class Counter(_Instrument):
    """Monotonically increasing count (thread-safe int add)."""

    kind = "counter"

    def __init__(self, name: str, desc: str = "",
                 labels: tuple[tuple[str, str], ...] = ()):
        super().__init__(name, desc, labels)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """Point-in-time value: ``set``/``inc``/``dec``, or a ``set_fn``
    callback evaluated lazily at snapshot/export time (values that are
    cheaper to read than to push)."""

    kind = "gauge"

    def __init__(self, name: str, desc: str = "",
                 labels: tuple[tuple[str, str], ...] = ()):
        super().__init__(name, desc, labels)
        self._value: float = 0.0
        self._fn: Callable[[], float] | None = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    def set_fn(self, fn: Callable[[], float]) -> None:
        """Make the gauge read ``fn()`` at snapshot time."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float | None:
        """None when a lazy ``set_fn`` crashes — never NaN, which
        json.dumps would serialize as an invalid-JSON token and poison
        every snapshot/bundle embedding it."""
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:  # a crashing lazy gauge must degrade to None, not take the whole snapshot/scrape down
            return None


class Histogram(_Instrument):
    """Fixed-boundary histogram: cumulative ``le`` buckets plus sum/count,
    Prometheus-style.  ``record`` is allocation-free (linear scan into a
    preallocated count list — boundary lists are a handful of entries).

    ``percentile(p)`` answers from the bucket counts: the smallest
    boundary covering p% of samples (exact when boundaries are exact for
    the recorded domain, e.g. integer trip counts; bucket-resolution
    otherwise).  ``last`` keeps the most recent raw sample — surfaces like
    "trips in the last handshake" want the latest observation.
    """

    kind = "histogram"

    def __init__(self, name: str, desc: str = "",
                 buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
                 labels: tuple[tuple[str, str], ...] = ()):
        super().__init__(name, desc, labels)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("bucket boundaries must be non-empty and sorted")
        self.boundaries = tuple(buckets)
        self._counts = [0] * (len(buckets) + 1)  # +1 overflow bucket
        self._sum = 0.0
        self._count = 0
        self._last: float | None = None

    def _make_child(self, key: tuple[tuple[str, str], ...]) -> "Histogram":
        return Histogram(self.name, self.desc, self.boundaries, labels=key)

    def record(self, v: float) -> None:
        with self._lock:
            i = 0
            for i, b in enumerate(self.boundaries):  # noqa: B007
                if v <= b:
                    break
            else:
                i = len(self.boundaries)
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._last = v

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    def reset(self) -> None:
        """Zero the histogram (benchmark warmup windows)."""
        with self._lock:
            self._counts = [0] * (len(self.boundaries) + 1)
            self._sum = 0.0
            self._count = 0
            self._last = None

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def total(self) -> float:
        with self._lock:
            return self._sum

    @property
    def last(self) -> float | None:
        with self._lock:
            return self._last

    def percentile(self, p: float) -> float | None:
        """Smallest bucket boundary covering ``p`` percent of samples.
        None when empty OR when the target falls in the overflow bucket
        (beyond the largest boundary) — never +inf, which would poison
        JSON exports (``Infinity`` is not valid JSON); check
        :meth:`bucket_counts` to distinguish the two."""
        with self._lock:
            if self._count == 0:
                return None
            target = max(1, -(-int(p * self._count) // 100))  # ceil(p% * n)
            cum = 0
            for i, c in enumerate(self._counts[:-1]):
                cum += c
                if cum >= target:
                    return self.boundaries[i]
            return None

    def bucket_counts(self) -> dict[str, int]:
        """Cumulative counts keyed by ``le`` boundary (Prometheus shape)."""
        with self._lock:
            out: dict[str, int] = {}
            cum = 0
            for b, c in zip(self.boundaries, self._counts):
                cum += c
                out[format(b, "g")] = cum
            out["+Inf"] = cum + self._counts[-1]
            return out


class LatencyHistogram:
    """Sliding-window percentile tracker over the last ``cap`` samples.

    A deque of recent samples, sorted on demand: percentiles reflect the
    CURRENT behavior of the system (a lifetime reservoir would keep
    reporting stale latencies long after a regression starts).  Queries
    are rare (metrics dialogs, bench summaries), so the O(cap log cap)
    sort per query is the right trade against per-record cost.
    """

    def __init__(self, cap: int = 1024):
        #: recorders live on the loop AND the device threads: all
        #: mutation is lock-guarded
        self._lock = threading.Lock()
        self._window: collections.deque[float] = collections.deque(maxlen=cap)
        self.count = 0
        self.total = 0.0
        #: most recent sample (None before the first record): metrics
        #: surfaces like "trips in the last handshake" want the latest
        #: observation, not a percentile of the window
        self.last: float | None = None

    def record(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total += seconds
            self._window.append(seconds)
            self.last = seconds

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    def percentile(self, p: float) -> float | None:
        with self._lock:
            if not self._window:
                return None
            s = sorted(self._window)
        return s[min(len(s) - 1, int(p / 100.0 * len(s)))]

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean_s": self.total / self.count if self.count else None,
            "last_s": self.last,
            "p50_s": self.percentile(50),
            "p95_s": self.percentile(95),
            "p99_s": self.percentile(99),
        }


class Registry:
    """A named set of instruments + collectors with two exporters.

    ``counter``/``gauge``/``histogram`` are create-or-return by name (the
    registry is the source of truth, so two call sites asking for the same
    name share one instrument; asking with a different type is an error).
    ``register_collector(name, fn)`` absorbs an external source: ``fn``
    returns a (nested) dict read at snapshot/export time — this is how
    ``QueueStats`` and operand-cache counters join the registry without a
    second set of hot-path increments.
    """

    def __init__(self, name: str = "default"):
        self.name = name
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}
        self._collectors: dict[str, Callable[[], dict[str, Any]]] = {}
        with _REGISTRIES_LOCK:
            _REGISTRIES.add(self)

    # -- instrument factories -------------------------------------------------

    def _get(self, cls, name: str, desc: str, **kw) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, desc, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}"
                )
            return inst

    def counter(self, name: str, desc: str = "") -> Counter:
        return self._get(Counter, name, desc)

    def gauge(self, name: str, desc: str = "") -> Gauge:
        return self._get(Gauge, name, desc)

    def histogram(self, name: str, desc: str = "",
                  buckets: tuple[float, ...] | None = None) -> Histogram:
        """``buckets=None`` = "whatever it already has" (DEFAULT_LATENCY_
        BUCKETS on creation); EXPLICIT boundaries that disagree with an
        existing instrument raise — silently recording into someone
        else's buckets yields wrong percentiles at bucket resolution."""
        h = self._get(Histogram, name, desc,
                      buckets=tuple(buckets) if buckets is not None
                      else DEFAULT_LATENCY_BUCKETS)
        if buckets is not None and h.boundaries != tuple(buckets):
            raise TypeError(
                f"histogram {name!r} already registered with boundaries "
                f"{h.boundaries}, requested {tuple(buckets)}"
            )
        return h

    def register_collector(self, name: str,
                           fn: Callable[[], dict[str, Any]]) -> None:
        with self._lock:
            self._collectors[name] = fn

    # -- exporters ------------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """JSON-ready nested dict of every instrument + collector."""
        with self._lock:
            instruments = list(self._instruments.values())
            collectors = dict(self._collectors)
        out: dict[str, Any] = {"registry": self.name, "counters": {},
                               "gauges": {}, "histograms": {}, "collected": {}}
        for inst in instruments:
            for each in inst._each():
                key = each.name + _prom_labels(each.label_set)
                if isinstance(each, Counter):
                    out["counters"][key] = each.value
                elif isinstance(each, Gauge):
                    out["gauges"][key] = each.value
                elif isinstance(each, Histogram):
                    out["histograms"][key] = {
                        "count": each.count,
                        "sum": each.total,
                        "last": each.last,
                        "p50": each.percentile(50),
                        "p99": each.percentile(99),
                        "buckets": each.bucket_counts(),
                    }
        for name, fn in collectors.items():
            try:
                out["collected"][name] = fn()
            except Exception:  # one crashing collector (e.g. a mid-teardown queue) must not take the whole snapshot down
                out["collected"][name] = {"error": "collector failed"}
        return out

    def to_prometheus(self, prefix: str = "qrp2p") -> str:
        """Prometheus text exposition format.  Collector dicts are
        flattened path-wise into gauge lines (numeric leaves only; strings
        stay in the JSON snapshot)."""
        snap = self.snapshot()
        reg_label = _prom_labels((("registry", self.name),))
        lines: list[str] = []

        def emit(name: str, kind: str, desc: str, samples: list[tuple[str, Any]]):
            lines.append(f"# HELP {name} {desc}")
            lines.append(f"# TYPE {name} {kind}")
            for suffix, v in samples:
                lines.append(f"{name}{suffix} {_fmt_num(v)}")

        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            base = f"{prefix}_{_prom_name(inst.name)}"
            if isinstance(inst, Counter):
                emit(f"{base}_total", "counter", inst.desc or inst.name,
                     [(_merge_labels(each.label_set, self.name), each.value)
                      for each in inst._each()])
            elif isinstance(inst, Gauge):
                emit(base, "gauge", inst.desc or inst.name,
                     [(_merge_labels(each.label_set, self.name), each.value)
                      for each in inst._each()])
            elif isinstance(inst, Histogram):
                lines.append(f"# HELP {base} {inst.desc or inst.name}")
                lines.append(f"# TYPE {base} histogram")
                for each in inst._each():
                    for le, cum in each.bucket_counts().items():
                        lbl = _merge_labels(each.label_set + (("le", le),),
                                            self.name)
                        lines.append(f"{base}_bucket{lbl} {cum}")
                    lbl = _merge_labels(each.label_set, self.name)
                    lines.append(f"{base}_sum{lbl} {_fmt_num(each.total)}")
                    lines.append(f"{base}_count{lbl} {each.count}")
        for cname, collected in snap["collected"].items():
            for path, v in _numeric_leaves(collected):
                name = f"{prefix}_{_prom_name(cname)}_{_prom_name(path)}"
                lines.append(f"{name}{reg_label} {_fmt_num(v)}")
        return "\n".join(lines) + "\n"


def _merge_labels(labels: tuple[tuple[str, str], ...], registry: str) -> str:
    return _prom_labels((("registry", registry),) + labels)


def _fmt_num(v: Any) -> str:
    if v is None:
        return "NaN"  # valid in the Prometheus exposition format (not JSON)
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return format(float(v), "g")


def _numeric_leaves(obj: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Flatten a collector dict to (dotted_path, number) pairs."""
    out: list[tuple[str, Any]] = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            path = f"{prefix}_{k}" if prefix else str(k)
            out.extend(_numeric_leaves(v, path))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out.append((prefix, obj))
    return out


#: the Prometheus exposition content type (the text format spec's)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def prometheus_text(registry: "Registry", prefix: str = "qrp2p") -> str:
    """THE Prometheus text exposition path: every surface that renders a
    registry as Prometheus text calls through here, so there is exactly
    one copy of the exposition logic (:meth:`Registry.to_prometheus`)."""
    return registry.to_prometheus(prefix)


#: process-wide default registry (module-level counters; the flight
#: recorder's dump bundles snapshot EVERY live registry, this one included)
REGISTRY = Registry(name="process")


def global_snapshot() -> dict[str, dict[str, Any]]:
    """Snapshot of every live registry, keyed by registry name (the flight
    recorder embeds this in its diagnostic bundles)."""
    with _REGISTRIES_LOCK:
        regs = list(_REGISTRIES)
    out: dict[str, dict[str, Any]] = {}
    for reg in sorted(regs, key=lambda r: r.name):
        key = reg.name
        n = 2
        while key in out:  # two engines with one name: keep both visible
            key = f"{reg.name}#{n}"
            n += 1
        out[key] = reg.snapshot()
    return out
