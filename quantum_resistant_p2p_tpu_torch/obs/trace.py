"""Correlated span tracer: where a handshake or a flush spent its time.

Counterpart of the reference's ``obs/trace.py``.  A :class:`Span` is one
timed region with a name, a correlation context (``trace_id`` shared by a
whole causal chain, ``span_id`` unique per region, ``parent_id`` linking
the chain), and a small dict of public attributes.  The CURRENT span
context lives in a :mod:`contextvars` variable, so it propagates across
``await`` boundaries and into tasks (``loop.create_task`` /
``call_later`` copy the context when they schedule, which is why a batch
queue's timer-driven flush inherits the context of the caller that
enqueued first).

Two boundaries do NOT propagate contextvars and need an explicit handoff:
``loop.run_in_executor`` workers and plain ``threading.Thread`` targets.
Capture :func:`current` on the loop side and pass it as ``parent=`` on the
far side::

    parent = trace.current()                    # loop side
    def work():                                 # executor/thread side
        with trace.span("device.dispatch", parent=parent, op=label):
            ...

Finished spans land in a bounded ring buffer and are fed to the flight
recorder (obs/flight.py).  :func:`to_chrome_trace` renders a span list as
chrome://tracing / Perfetto trace-event JSON.  :func:`device_trace`
profiles the GPU itself with ``torch.profiler``.

**Cross-peer propagation**: :func:`wire_context` renders the current
context as a bounded, ids-only dict a transport attaches to outbound
frames (``_trace``), and :func:`adopt_wire_context` validates an inbound
one from an UNTRUSTED peer: wrong shape, wrong types, over-long or
non-token ids all yield ``None`` (the receiver roots a fresh trace; only
correlation ids ever ride the wire).  ``QRP2P_TRACE_PROPAGATE=0``
disables both directions.

**Node attribution**: span records carry a ``node`` field resolved from
the ambient :func:`node_scope` or inherited from the parent context, so
one process hosting many nodes still attributes every span to the node
that did the work.  Contexts adopted from the wire carry NO node.

Span attributes are DIAGNOSTIC METADATA (op labels, batch sizes, states).
Key material must never be passed as an attribute; the flight recorder
redacts defensively at record time.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import re
import tempfile
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable

#: the current span context of this task/thread (None outside any span).
#: Module-level so every tracer shares one propagation chain.
_CURRENT: contextvars.ContextVar["SpanContext | None"] = contextvars.ContextVar(
    "qrp2p_obs_span", default=None
)

#: the node this task/thread is doing work FOR (a process may host many)
_NODE: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "qrp2p_obs_node", default=None
)

TRACE_PROPAGATE_ENV = "QRP2P_TRACE_PROPAGATE"

#: wire ``_trace`` field hygiene: ids are short opaque tokens.  Anything
#: longer or outside this alphabet is hostile or corrupt — ignored, so a
#: peer can never inject log/trace-file noise through correlation ids.
WIRE_ID_MAX = 64
#: \Z, not $ — $ matches before a trailing newline, which would wave
#: "evil\n" (and 65-byte "a"*64+"\n") through the hostile-input gate
_WIRE_ID_RE = re.compile(r"^[A-Za-z0-9_.:\-]{1,64}\Z")


class SpanContext:
    """Immutable correlation handle: pass it across executor/thread hops.

    ``node`` is the attribution lane of the span that minted the context
    (``None`` for contexts adopted from the wire — a remote parent must
    not pull the local child onto the remote node's lane)."""

    __slots__ = ("trace_id", "span_id", "node")

    def __init__(self, trace_id: str, span_id: str, node: str | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.node = node

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SpanContext({self.trace_id}/{self.span_id})"


class Span:
    """One live timed region.  All identity fields are fixed at
    construction; the attribute dict is mutated only via :meth:`set_attr`
    (lock-guarded: a span handle may legitimately cross the executor
    boundary it was captured around)."""

    __slots__ = ("name", "context", "parent_id", "attrs", "_lock")

    def __init__(self, name: str, context: SpanContext, parent_id: str | None,
                 attrs: dict[str, Any]):
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.attrs = attrs
        self._lock = threading.Lock()

    def set_attr(self, key: str, value: Any) -> None:
        """Attach one more public attribute to the span."""
        with self._lock:
            self.attrs[key] = value


class Tracer:
    """Bounded-ring span recorder with deterministic id assignment.

    ``clock`` is injectable (tests pin it for byte-stable golden exports);
    the default is a perf_counter timeline relative to tracer creation, so
    exported timestamps are small non-negative microsecond offsets.
    """

    def __init__(self, cap: int = 4096,
                 clock: Callable[[], float] | None = None, tag: str = ""):
        self._lock = threading.Lock()
        self._spans: deque[dict[str, Any]] = deque(maxlen=cap)
        self._listeners: list[Callable[[dict[str, Any]], None]] = []
        self._next_id = 0
        #: id prefix disambiguating ids minted by DIFFERENT tracers inside
        #: one merged multi-node trace: every process's tracer counts from
        #: 1, so without a tag two processes' span/trace ids collide.  ""
        #: (the default) keeps single-tracer exports byte-stable; the
        #: process-wide TRACER uses a pid+random tag (pid alone collides
        #: across containers, where every node is pid 1).
        self._tag = tag
        if clock is None:
            epoch = time.perf_counter()
            clock = lambda: time.perf_counter() - epoch  # noqa: E731
        self._clock = clock

    # -- ids ------------------------------------------------------------------

    def _new_id(self) -> str:
        with self._lock:
            self._next_id += 1
            return f"{self._tag}{self._next_id:08x}"

    # -- span lifecycle -------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, parent: SpanContext | None = None,
             **attrs: Any):
        """Open a span; the block's duration is the span's duration.

        ``parent`` defaults to the ambient context (contextvar); pass an
        explicitly captured :func:`current` when crossing an executor or
        thread boundary.  The span context is installed as ambient for the
        duration of the block, so nested spans chain automatically.
        """
        if parent is None:
            parent = _CURRENT.get()
        if parent is None:
            trace_id = "t" + self._new_id()
            parent_id = None
        else:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        # node attribution: the ambient scope (set by the transport around
        # sends/dispatch) wins; an explicitly handed-off parent carries its
        # creator's node across the executor/thread edges contextvars miss
        node = _NODE.get()
        if node is None and parent is not None:
            node = parent.node
        ctx = SpanContext(trace_id, self._new_id(), node)
        sp = Span(name, ctx, parent_id, dict(attrs))
        token = _CURRENT.set(ctx)
        t0 = self._clock()
        try:
            yield sp
        except BaseException as exc:
            sp.set_attr("error", type(exc).__name__)
            raise
        finally:
            _CURRENT.reset(token)
            self._finish(sp, t0, self._clock() - t0)

    def _finish(self, sp: Span, t0: float, dur: float) -> None:
        with sp._lock:
            # the handle may have crossed to a worker still set_attr-ing;
            # copy under ITS lock or the dict can change size mid-copy
            attrs = dict(sp.attrs)
        rec = {
            "name": sp.name,
            "trace_id": sp.context.trace_id,
            "span_id": sp.context.span_id,
            "parent_id": sp.parent_id,
            "t0": t0,
            "dur": dur,
            "thread": threading.current_thread().name,
            "node": sp.context.node or "",
            "attrs": attrs,
        }
        with self._lock:
            self._spans.append(rec)
            listeners = list(self._listeners)
        for cb in listeners:
            try:
                cb(rec)
            except Exception:  # a failing listener must never break the traced operation
                pass

    # -- consumption ----------------------------------------------------------

    def add_listener(self, cb: Callable[[dict[str, Any]], None]) -> None:
        """Subscribe to finished spans (the flight recorder's feed)."""
        with self._lock:
            if cb not in self._listeners:
                self._listeners.append(cb)

    def snapshot(self) -> list[dict[str, Any]]:
        """Finished spans, oldest first (a copy)."""
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        """Drop recorded spans (tests; long-lived sessions before an export)."""
        with self._lock:
            self._spans.clear()

    def now(self) -> float:
        """The tracer's current clock reading — the anchor
        :func:`export_spans` pairs with wall time so dumps from different
        processes can be aligned onto one merged timeline."""
        return self._clock()


def current() -> SpanContext | None:
    """The ambient span context — capture on the loop side, pass as
    ``parent=`` on the far side of an executor/thread hop."""
    return _CURRENT.get()


@contextlib.contextmanager
def node_scope(node_id: str):
    """Attribute spans opened inside the block (and tasks/timers scheduled
    from it — contextvars copy at scheduling time) to ``node_id``.  The
    transport enters this around sends and inbound handler dispatch."""
    token = _NODE.set(node_id)
    try:
        yield
    finally:
        _NODE.reset(token)


def current_node() -> str | None:
    """The ambient node attribution (None outside any :func:`node_scope`)."""
    return _NODE.get()


# -- cross-peer wire propagation ----------------------------------------------


def propagation_enabled() -> bool:
    """Trace-context propagation opt-out (``QRP2P_TRACE_PROPAGATE=0``).
    Read at call time so a live process can be flipped."""
    return os.environ.get(TRACE_PROPAGATE_ENV, "1") != "0"


def wire_context(**extra: str) -> dict[str, str] | None:
    """The current span context as the bounded, ids-only ``_trace`` dict
    a transport attaches to outbound frames — ``None`` when there is no
    current span or propagation is disabled.

    ``extra`` admits additional short PUBLIC correlation tokens (e.g. a
    bench run id); non-string or over-long values are dropped, and the
    receiver ignores everything but the two ids anyway."""
    if not propagation_enabled():
        return None
    ctx = _CURRENT.get()
    if ctx is None:
        return None
    out = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
    for k, v in extra.items():
        if isinstance(v, str) and _WIRE_ID_RE.match(v):
            out[k] = v
    return out


def adopt_wire_context(obj: Any) -> SpanContext | None:
    """Validate an inbound ``_trace`` field from an UNTRUSTED peer into a
    parent :class:`SpanContext` — or ``None``, which simply roots a fresh
    local trace.  Hostile input must never alter control flow: anything
    but a dict of two short token-charset string ids is ignored (wrong
    type, missing/extra nesting, oversized or non-token ids).  The
    adopted context carries no ``node``: the remote parent must not pull
    local spans onto the remote peer's lane."""
    if not propagation_enabled():
        return None
    if not isinstance(obj, dict):
        return None
    trace_id = obj.get("trace_id")
    span_id = obj.get("span_id")
    if not (isinstance(trace_id, str) and isinstance(span_id, str)):
        return None
    if not (_WIRE_ID_RE.match(trace_id) and _WIRE_ID_RE.match(span_id)):
        return None
    return SpanContext(trace_id, span_id)


#: process-wide default tracer: instrumentation sites record here, and
#: :func:`span` reads it at call time, so a caller may put another
#: :class:`Tracer` in its place.  The tag keeps ids from
#: concurrently-traced processes disjoint when their span dumps meet in
#: one merged document: the pid half makes ids greppable back to the
#: dump's ``pid`` field, the random half disambiguates processes whose
#: pids collide (containers typically ALL run their node as pid 1).
TRACER = Tracer(
    tag=f"{os.getpid() & 0xFFFF:04x}{os.urandom(4).hex()}")


def span(name: str, parent: SpanContext | None = None, **attrs: Any):
    """``TRACER.span(...)`` convenience (the form instrumentation uses)."""
    return TRACER.span(name, parent=parent, **attrs)


# -- chrome://tracing export --------------------------------------------------


def to_chrome_trace(records: list[dict[str, Any]]) -> dict[str, Any]:
    """Render finished-span records as a chrome://tracing (trace-event
    format) JSON object: complete events (``"ph": "X"``) with microsecond
    timestamps, one tid lane per recording thread, correlation ids in
    ``args``.  Load the dumped JSON in chrome://tracing or
    https://ui.perfetto.dev to see the flame graph.
    """
    tids: dict[str, int] = {}
    events: list[dict[str, Any]] = []
    for rec in records:
        tid = tids.setdefault(rec["thread"], len(tids) + 1)
        node = rec.get("node") or ""
        events.append({
            "name": rec["name"],
            "ph": "X",
            "ts": round(rec["t0"] * 1e6, 3),
            "dur": round(rec["dur"] * 1e6, 3),
            "pid": 1,
            "tid": tid,
            "cat": rec["name"].split(".", 1)[0],
            "args": {
                "trace_id": rec["trace_id"],
                "span_id": rec["span_id"],
                "parent_id": rec["parent_id"],
                **({"node": node} if node else {}),
                **rec["attrs"],
            },
        })
    meta = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
         "args": {"name": thread}}
        for thread, tid in sorted(tids.items(), key=lambda kv: kv[1])
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


SPAN_DUMP_FORMAT = "qrp2p-spans"
SPAN_DUMP_VERSION = 1


def span_dump(node: str = "", tracer: Tracer | None = None,
              records: list[dict[str, Any]] | None = None) -> dict[str, Any]:
    """One node's finished spans as a merge-ready dump document.

    Beyond the records themselves it carries per-node PROCESS metadata —
    node name, pid, and a (wall, mono) clock anchor pair taken at dump
    time — so a merge can put each node on its own process lane and align
    dumps from DIFFERENT processes (each tracer's clock is relative to its
    own creation) onto one wall-clock timeline.
    """
    tracer = tracer or TRACER
    return {
        "format": SPAN_DUMP_FORMAT,
        "version": SPAN_DUMP_VERSION,
        "node": node,
        "pid": os.getpid(),
        "wall_anchor": time.time(),
        "mono_anchor": tracer.now(),
        "spans": records if records is not None else tracer.snapshot(),
    }


def export_spans(path: str | Path, node: str = "",
                 tracer: Tracer | None = None) -> dict[str, Any]:
    """Write :func:`span_dump` as JSON; returns the dump document."""
    doc = span_dump(node=node, tracer=tracer)
    Path(path).write_text(json.dumps(doc))
    return doc


@contextlib.contextmanager
def device_trace(log_dir: str | Path | None = None, device: str = "cuda"):
    """Profile everything inside the block with ``torch.profiler`` and
    write a Chrome trace (chrome://tracing, https://ui.perfetto.dev) into
    ``log_dir`` (default: ``qrp2p_trace`` under the temporary directory).

    Yields the trace file's path; the file is written when the block
    ends.  ``device="cuda"`` records the card's activity (kernels, copies)
    and raises without a GPU: it never profiles the CPU instead.
    ``device="cpu"`` records the host's operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace(device='cuda') needs a CUDA GPU")
        activities = [ProfilerActivity.CUDA]
    elif device == "cpu":
        activities = [ProfilerActivity.CPU]
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    out_dir = Path(log_dir) if log_dir is not None else Path(tempfile.gettempdir()) / "qrp2p_trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"device_trace_{os.getpid()}_{time.time_ns()}.json"
    with profile(activities=activities) as prof:
        yield path
        if device == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
