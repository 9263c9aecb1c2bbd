"""``obs``: the observability layer (counterpart of the reference's
``obs/``, without its HTTP endpoints).  Stdlib only, apart from
:func:`trace.device_trace`, which imports ``torch.profiler`` when called.

* :mod:`.trace`     — correlated span tracer: contextvar-propagated span
  contexts across ``await``/task boundaries with explicit handoff across
  executor threads, a bounded ring of finished spans, a chrome://tracing
  exporter, and :func:`trace.device_trace` around ``torch.profiler``.
* :mod:`.metrics`   — typed registry (Counter/Gauge/Histogram, thread-safe)
  with collectors over counters kept elsewhere (``QueueStats``, operand
  caches), and JSON-snapshot + Prometheus-text exporters.
* :mod:`.flight`    — bounded ring-buffer flight recorder of recent
  spans/events, redacted at record time (:mod:`.redaction`), dumping a
  diagnostic bundle on triggers (injected faults, SLO burns).
* :mod:`.slo`       — declarative SLO specs evaluated on injectable clocks
  over multi-window burn rates.
* :mod:`.cost`      — device-cost ledger: batch occupancy and padding
  waste, compile attribution, device seconds per op family, operand-cache
  hit windows.

The batching queues (provider/batched.py), the fault engine (faults/) and
the health gate (provider/health.py) report through here.
"""

from __future__ import annotations

from . import flight, metrics, slo, trace  # noqa: F401
from .flight import FlightRecorder  # noqa: F401
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      LatencyHistogram, Registry)
from .slo import SLOEngine, SLOSpec  # noqa: F401
from .trace import (Span, SpanContext, Tracer, current,  # noqa: F401
                    node_scope, span, to_chrome_trace)
