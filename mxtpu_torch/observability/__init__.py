"""Observability of the port (the port of ``mxtpu/observability``):
deterministic request tracing, the failure flight recorder and one
metrics registry.

Three modules, one discipline — counter clocks, never wall clocks, so
every trace, postmortem and metrics delta replays byte for byte under
the same seeds and fault plan:

- :mod:`~mxtpu_torch.observability.trace` — the process-wide
  :class:`Tracer` (off by default; ``MXTPU_TRACE=1`` or
  :func:`tracing`): typed spans and events with tick timestamps and
  correlation ids over the engines' request path (admission, prefix hit,
  copy-on-write, swaps, deferral, prefill chunks, decode steps, draft and
  verify windows, the terminal state, cancels and weight adoptions) plus
  an automatic event for every fired ``resilience.faults`` rule; Chrome
  trace-event export (:func:`export_chrome_trace`); spans are
  ``torch.profiler.record_function`` ranges while a torch profiler
  records.
- :mod:`~mxtpu_torch.observability.flight` — :class:`FlightRecorder`
  (``MXTPU_FLIGHT_BUFFER=N`` or :func:`flight_recording`): bounded
  per-request event rings that, on a failure path (quarantine, shed, a
  failed adoption, checkpoint corruption), snapshot the implicated
  requests' timelines and a counters delta into deterministic,
  JSON-dumpable postmortems.
- :mod:`~mxtpu_torch.observability.metrics` — one
  :class:`MetricsRegistry` with named lazy sources (engine stats, the
  resilience counters, the tracer, the flight recorder, the kernels'
  launch counters) flattened into one snapshot with
  ``snapshot()``/``delta()`` and Prometheus-text and JSON exposition.
"""

from __future__ import annotations

from .flight import (FlightRecorder, Postmortem, flight_recording,
                     get_flight)
from .metrics import MetricsRegistry, default_registry, get_registry
from .trace import (EVENT_TYPES, TraceEvent, Tracer, export_chrome_trace,
                    gateway_rid, get_tracer, tracing)

__all__ = [
    "Tracer", "TraceEvent", "get_tracer", "tracing", "gateway_rid",
    "EVENT_TYPES", "export_chrome_trace",
    "FlightRecorder", "Postmortem", "get_flight", "flight_recording",
    "MetricsRegistry", "get_registry", "default_registry",
]
