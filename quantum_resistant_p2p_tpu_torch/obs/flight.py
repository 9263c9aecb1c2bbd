"""Flight recorder: "what happened in the seconds before".

Counterpart of the reference's ``obs/flight.py``.  A bounded ring buffer
of recent structured events (health-gate verdicts, injected faults, lane
sheds, operand-cache releases, compile events, plus every finished trace
span, fed from obs/trace.py), with a one-call diagnostic bundle dump.

**Redaction happens at record time**, not dump time: key material must
never sit in the ring at all.  The vocabulary (``SECRET_NAME_RE`` /
``NONSECRET_NAME_RE``) lives in obs/redaction.py; this module redacts
secret-named fields, raw bytes and oversized strings whatever arrives.

Auto-dump: :meth:`FlightRecorder.trigger` records the event AND writes a
bundle when a dump directory is armed (``QRP2P_FLIGHT_DIR`` env or
:meth:`set_autodump`), rate-limited per trigger kind with a bounded file
count, and written off-thread so a trigger firing on the event loop never
blocks it.  Injected faults are triggers.

Byte-reproducibility: with injected clocks and a fresh recorder, the
bundle for a seeded fault plan is byte-identical across runs — ``dump``
serialises with sorted keys and compact separators.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable

from . import metrics as _metrics
from . import trace as _trace

# re-exported; the vocabulary itself lives in redaction.py
from .redaction import NONSECRET_NAME_RE, SECRET_NAME_RE, is_secret_name

#: strings longer than this are summarised, not stored (payload hygiene +
#: ring size bound; no legitimate flight field is this long)
MAX_STR = 256
#: structures nested deeper than this are summarised wholesale
MAX_DEPTH = 4

FLIGHT_DIR_ENV = "QRP2P_FLIGHT_DIR"
BUNDLE_VERSION = 1


_is_secret_field = is_secret_name


def redact_value(name: str, value: Any, depth: int = 0) -> Any:
    """One field of a flight event, made safe to persist.

    Secret-NAMED fields are replaced by a typed placeholder whatever their
    value; raw bytes are never stored (length only); oversized strings are
    summarised; dicts/lists recurse with their own key checks; anything
    non-JSON-native is reduced to its type name.
    """
    if _is_secret_field(name):
        try:
            n = len(value)  # type: ignore[arg-type]
        except TypeError:
            n = -1
        return f"[redacted:{type(value).__name__}:{n}]"
    if isinstance(value, (bytes, bytearray, memoryview)):
        return f"[bytes:{len(value)}]"
    if isinstance(value, str):
        if len(value) > MAX_STR:
            return f"[str:{len(value)} chars]"
        return value
    if isinstance(value, (bool, int, float)) or value is None:
        return value
    if depth >= MAX_DEPTH:
        return f"[{type(value).__name__}]"
    if isinstance(value, dict):
        return {str(k): redact_value(str(k), v, depth + 1)
                for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [redact_value(name, v, depth + 1) for v in value]
    return f"[{type(value).__name__}]"


class FlightRecorder:
    """Bounded ring of redacted events + the diagnostic-bundle dump.

    ``clock``/``mono`` are injectable so tests produce byte-identical
    bundles; defaults are wall time (event timestamps humans correlate
    with logs) and monotonic time (rate limiting).
    """

    def __init__(self, cap: int = 2048,
                 clock: Callable[[], float] = time.time,
                 mono: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._events: deque[dict[str, Any]] = deque(maxlen=cap)
        self._seq = 0
        self._clock = clock
        self._mono = mono
        self._dump_dir: Path | None = None
        env_dir = os.environ.get(FLIGHT_DIR_ENV)
        if env_dir:
            self._dump_dir = Path(env_dir)
        self._min_interval_s = 30.0
        self._keep = 8
        self._last_dump: dict[str, float] = {}
        self._dump_count = 0

    # -- recording ------------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> dict[str, Any]:
        """Append one event (redacted immediately; see module doc)."""
        safe = {k: redact_value(k, v) for k, v in fields.items()}
        with self._lock:
            self._seq += 1
            entry = {"seq": self._seq, "t": round(self._clock(), 6),
                     "kind": kind, **safe}
            self._events.append(entry)
        return entry

    def snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._last_dump.clear()

    # -- dumping --------------------------------------------------------------

    def set_autodump(self, directory: str | Path | None,
                     min_interval_s: float = 30.0, keep: int = 8) -> None:
        """Arm (or, with None, disarm) automatic bundle dumps on triggers."""
        with self._lock:
            self._dump_dir = Path(directory) if directory is not None else None
            self._min_interval_s = min_interval_s
            self._keep = keep

    def dump(self, trigger: str, path: str | Path | None = None,
             registries: dict[str, Any] | None = None) -> dict[str, Any]:
        """Build (and optionally write) the diagnostic bundle.

        ``registries`` overrides the metrics section (tests pass ``{}`` for
        byte-reproducibility; the default embeds a snapshot of every live
        registry).  Serialisation is sorted-key/compact, so equal state
        yields equal bytes.
        """
        if registries is None:
            registries = _metrics.global_snapshot()
        bundle = {
            "bundle_version": BUNDLE_VERSION,
            "trigger": trigger,
            "t": round(self._clock(), 6),
            "events": self.snapshot(),
            "metrics": registries,
        }
        if path is not None:
            path = Path(path)
            path.parent.mkdir(parents=True, exist_ok=True)
            # atomic publish: dumps are written off-thread while consumers
            # (operators, tests) poll the directory — a reader must never
            # observe a half-written bundle
            tmp = path.with_name(path.name + ".tmp")
            tmp.write_text(
                json.dumps(bundle, sort_keys=True, separators=(",", ":"),
                           default=str)
            )
            os.replace(tmp, path)
        return bundle

    def trigger(self, kind: str, **fields: Any) -> None:
        """Record the event AND auto-dump a bundle (if armed; rate-limited
        per kind; written off-thread so event-loop callers never block)."""
        self.record(kind, **fields)
        with self._lock:
            directory = self._dump_dir
            if directory is None:
                return
            now = self._mono()
            last = self._last_dump.get(kind)
            if last is not None and now - last < self._min_interval_s:
                return
            self._last_dump[kind] = now
            self._dump_count += 1
            n = self._dump_count
        path = directory / f"flight_{n:04d}_{_safe_name(kind)}.json"

        def _build_and_write() -> None:
            # the bundle build itself (registry snapshots across every live
            # registry + a ring copy) happens HERE, off the caller's
            # thread: triggers fire from the event loop, exactly when the
            # system is already degraded
            try:
                self.dump(kind, path=path)
                self._prune(directory)
            except OSError:
                pass  # a full/unwritable dump dir must never break the caller

        threading.Thread(target=_build_and_write, name="qrp2p-flight-dump",
                         daemon=True).start()

    def _prune(self, directory: Path) -> None:
        dumps = sorted(directory.glob("flight_*.json"))
        for old in dumps[: max(0, len(dumps) - self._keep)]:
            try:
                old.unlink()
            except OSError:
                pass


def _safe_name(kind: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_.-]", "_", kind)[:48]


#: process-wide default recorder: instrumentation sites record here.
#: Module FUNCTIONS below resolve it at call time, so tests can swap in a
#: fresh recorder (monkeypatch) and every producer follows.
RECORDER = FlightRecorder()


def record(kind: str, **fields: Any) -> None:
    RECORDER.record(kind, **fields)


def trigger(kind: str, **fields: Any) -> None:
    RECORDER.trigger(kind, **fields)


def dump(trigger_name: str, path: str | Path | None = None,
         registries: dict[str, Any] | None = None) -> dict[str, Any]:
    return RECORDER.dump(trigger_name, path, registries=registries)


def _on_span(rec: dict[str, Any]) -> None:
    """Span feed: every finished span becomes a flight event (the ring is
    the recent-history buffer the dump narrates from)."""
    RECORDER.record(
        "span", name=rec["name"], trace_id=rec["trace_id"],
        span_id=rec["span_id"], parent_id=rec["parent_id"],
        t0=round(rec["t0"], 6), dur=round(rec["dur"], 6),
        thread=rec["thread"], node=rec.get("node") or None,
        attrs=rec["attrs"],
    )


_trace.TRACER.add_listener(_on_span)
