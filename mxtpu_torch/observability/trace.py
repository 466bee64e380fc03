"""Deterministic structured tracing: typed spans and events on a tick
clock (the port of ``mxtpu/observability/trace.py``).

Every event is stamped with a process-wide COUNTER tick, never a wall
clock, so the trace of a seeded run under a fault plan replays byte for
byte and tests can assert it.  Optional wall-clock annotations ride in a
separate ``noise`` payload, left out of the deterministic serialization.

Off by default.  Enable with ``MXTPU_TRACE=1`` (read once, when the
tracer is built) or the :func:`tracing` context manager.  While a
``torch.profiler`` session is recording, every span also wraps itself in
``torch.profiler.record_function(<event type>)``, so the engine's host
spans (``engine.iteration``) land in the profiler's trace beside the
kernels they launch.

Event taxonomy (:data:`EVENT_TYPES`, the reference's table whole): every
event carries a registered type; an unregistered type raises at the
emit.  Each declared fault site of ``resilience.faults.SITES`` has its
``fault.<site>`` type here.

Correlation ids: events carry an optional ``rid`` string.  The engines
emit ``"<tag>:<rid>"`` (tag = ``ledger_tag`` or ``"eng"``), and
:meth:`Tracer.alias` maps one id onto another, so one request's events
from every layer assemble into one :meth:`Tracer.timeline`.

Determinism contract: with the tracer reset at the start of a run, the
same seeds and the same fault plan give a byte-identical
:meth:`Tracer.to_json`.  Every emit is host bookkeeping: tracing adds no
device work and changes no result.

This module stays import-light (no torch at import time): the serving
and resilience hot paths import it unconditionally.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Any, Dict, List, NamedTuple, Optional

__all__ = ["TraceEvent", "Tracer", "get_tracer", "tracing",
           "gateway_rid", "EVENT_TYPES", "export_chrome_trace"]


#: alias entries (engine-rid -> gateway-rid) kept for at most this many
#: child ids; the oldest-registered is evicted past it.  One alias lands
#: per submitted request, so the always-on serving posture (ambient
#: MXTPU_FLIGHT_BUFFER, tracer never reset) would otherwise grow the
#: map without bound — the same bounded-bookkeeping discipline as the
#: flight recorder's request rings.
MAX_ALIASES = 8192

#: the registered span/event taxonomy: type -> one-line description
#: ``fault.<site>`` types
#: are declared EXPLICITLY (not derived from ``faults.SITES``), as in
#: the reference, so a site added without its event type shows.
EVENT_TYPES: Dict[str, str] = {
    # -- gateway ------------------------------------------------------------
    "gateway.admit": "request accepted into the gateway queue (QoS "
                     "class, tenant); queue wait = dispatch tick delta",
    "gateway.shed": "request shed (QoS overflow / quota / engine shed)",
    "gateway.dispatch": "request dispatched to a replica (gen, replica, "
                        "wait_ticks)",
    "gateway.hedge": "hedged duplicate dispatch fired",
    "gateway.requeue": "dispatch lost (replica death/stall) — stream "
                       "reset, request requeued at class front",
    "gateway.expired": "tick deadline passed; finished with partial "
                       "stream",
    "gateway.finish": "terminal gateway status (ok/failed)",
    "gateway.pump": "one gateway service iteration (span)",
    # -- router / transport ---------------------------------------------
    "router.dispatch": "replica selected (locality score, chosen "
                       "replica, load)",
    "transport.submit": "spec handed to a replica engine (aliases the "
                        "engine rid to the gateway rid)",
    "transport.worker_spawn": "subprocess replica worker started and "
                              "completed its init handshake (pid is "
                              "noise)",
    "transport.worker_exit": "subprocess replica worker left the pool "
                             "(graceful shutdown, kill, or reaped "
                             "death; exit code when reapable)",
    "transport.rpc_timeout": "a replica RPC exhausted its tick budget "
                             "(method, ticks) — counted toward "
                             "replica death as a transport failure",
    "replica.death": "supervisor declared a replica dead "
                     "(drain-and-requeue)",
    "replica.revive": "probation over — replica re-admitted (a "
                      "subprocess replica respawned a fresh worker "
                      "first)",
    # -- elastic serving ----------------------------------------------------
    "autoscale.decision": "one autoscaler policy evaluation that acted "
                          "(direction, shed delta, queue depth, pool "
                          "size)",
    "autoscale.spawn": "autoscaler grew the pool by one replica (or "
                       "failed to — error field; capacity unchanged)",
    "autoscale.retire": "graceful scale-down lifecycle (stage: begin/"
                        "released/reopened) — the victim drains at "
                        "stream completion, never the death path",
    "serving.adopt": "live weight hot-swap lifecycle (stage: staged/"
                     "installed/failed) — new param generation adopted "
                     "at an iteration boundary",
    "serving.rollback": "previous param generation re-staged "
                        "(hot-swap rollback)",
    # -- engines (parallel.serving) -----------------------------------------
    "engine.iteration": "one engine scheduler iteration (span)",
    "engine.admit": "admission started (prompt tokens)",
    "engine.prefix_hit": "radix/host-tier prefix hit (tokens, pages "
                         "shared — prefill skipped)",
    "engine.cow": "copy-on-write page clone at the divergence point",
    "engine.swap_in": "host-tier chain restored at admission (pages)",
    "engine.swap_out": "pinned chain spilled to the host tier (pages; "
                       "dropped=True when the copy was abandoned)",
    "engine.defer": "admission deferred on transient page exhaustion",
    "engine.prefill_chunk": "one chunked-prefill program ran for a "
                            "prefilling slot",
    "engine.decode": "slot emitted one token in the pooled decode step",
    "engine.draft": "speculative proposal drafted for a slot",
    "engine.verify": "slot scored in the pooled batched-verify call "
                     "(drafted, accepted)",
    "engine.finish": "request terminal in the engine "
                     "(ok/failed/expired/cancelled)",
    "engine.quarantine": "per-slot failure contained (site, error)",
    "engine.requeue": "quarantined request re-queued (retries left)",
    "engine.shed": "submission shed (typed LoadShedError)",
    "engine.cancel": "request cancelled through the idempotent release "
                     "path",
    # -- training guardian --------------------------------------------------
    "guardian.skip": "non-finite step contained (update gated off)",
    "guardian.spike": "finite loss spike detected -> rollback",
    "guardian.rollback": "restored the last verified checkpoint",
    "guardian.checkpoint": "verified checkpoint written",
    "guardian.window": "one fused N-step window dispatched (the "
                       "once-per-N host sync)",
    # -- profiler parity API -----------------------------------------------
    "profiler.counter": "profiler.Counter value change",
    "profiler.marker": "profiler.Marker instant",
    # -- automatic fault events (every resilience.faults site) ----------
    # one type per DECLARED site; a plan firing at an undeclared
    # (test-private) site emits fault.unregistered with a site field
    "fault.serving.step": "injected fault fired at serving.step",
    "fault.serving.admit": "injected fault fired at serving.admit",
    "fault.serving.prefix_lookup":
        "injected fault fired at serving.prefix_lookup",
    "fault.serving.block_alloc":
        "injected fault fired at serving.block_alloc",
    "fault.serving.swap_out": "injected fault fired at serving.swap_out",
    "fault.serving.swap_in": "injected fault fired at serving.swap_in",
    "fault.serving.draft": "injected fault fired at serving.draft",
    "fault.serving.verify": "injected fault fired at serving.verify",
    "fault.gateway.admit": "injected fault fired at gateway.admit",
    "fault.router.dispatch": "injected fault fired at router.dispatch",
    "fault.replica.health": "injected fault fired at replica.health",
    "fault.replica.stream": "injected fault fired at replica.stream",
    "fault.transport.rpc": "injected fault fired at transport.rpc",
    "fault.transport.encode":
        "injected fault fired at transport.encode",
    "fault.transport.worker_death":
        "injected fault fired at transport.worker_death",
    "fault.kvstore.reduce": "injected fault fired at kvstore.reduce",
    "fault.checkpoint.save": "injected fault fired at checkpoint.save",
    "fault.engine.flush": "injected fault fired at engine.flush",
    "fault.guardian.check": "injected fault fired at guardian.check",
    "fault.ckpt.write": "injected fault fired at ckpt.write",
    "fault.ckpt.verify": "injected fault fired at ckpt.verify",
    "fault.autoscale.spawn":
        "injected fault fired at autoscale.spawn",
    "fault.autoscale.retire":
        "injected fault fired at autoscale.retire",
    "fault.serving.adopt": "injected fault fired at serving.adopt",
    "fault.unregistered": "injected fault fired at a site with no "
                          "declared event type (site in fields)",
}


class TraceEvent(NamedTuple):
    """One recorded event.  ``tick`` is the deterministic counter clock
    (one tick per recorded event); ``phase`` is ``"I"`` (instant),
    ``"B"``/``"E"`` (span begin/end); ``noise`` holds wall-clock or
    otherwise non-deterministic annotations, excluded from the
    deterministic serialization."""

    tick: int
    etype: str
    rid: Optional[str]
    phase: str
    fields: Dict[str, Any]
    noise: Dict[str, Any]

    def to_dict(self, include_noise: bool = False) -> Dict[str, Any]:
        d: Dict[str, Any] = {"tick": self.tick, "type": self.etype,
                             "phase": self.phase}
        if self.rid is not None:
            d["rid"] = self.rid
        if self.fields:
            d["fields"] = self.fields
        if include_noise and self.noise:
            d["noise"] = self.noise
        return d


def gateway_rid(tag) -> str:
    """Correlation id of a gateway request from its dispatch tag: the
    gateway tags replica submissions ``(rid, dispatch_gen)`` — every
    generation of one request shares ONE timeline."""
    if isinstance(tag, tuple) and tag:
        return "gw:%s" % (tag[0],)
    return "gw:%s" % (tag,)


class _Span:
    """Begin/end event pair; while a ``torch.profiler`` session records,
    the region is also a ``record_function`` range of the same name."""

    __slots__ = ("_tr", "_etype", "_rid", "_fields", "_ann", "_t0")

    def __init__(self, tracer, etype, rid, fields):
        self._tr = tracer
        self._etype = etype
        self._rid = rid
        self._fields = fields
        self._ann = None
        self._t0 = None

    def __enter__(self):
        self._ann = _profiler_annotation(self._etype)
        if self._ann is not None:
            self._ann.__enter__()
        self._tr.emit(self._etype, rid=self._rid, phase="B",
                      **self._fields)
        if self._tr.record_wall:
            import time
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        noise = None
        if self._t0 is not None:
            import time
            noise = {"wall_s": time.perf_counter() - self._t0}
        self._tr.emit(self._etype, rid=self._rid, phase="E",
                      noise=noise)
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        return False


def _profiler_annotation(name):
    """``torch.profiler.record_function(name)`` when (and only when) a
    torch profiler session is recording, else None.  torch is looked up
    among the modules already imported: a process that never imported it
    runs no profiler, and this module imports nothing heavy."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch._C._autograd._profiler_enabled():
            return None
        return torch.profiler.record_function(name)
    except Exception:  # noqa: BLE001 — tracing must never take the
        return None    # serving path down over a profiler hiccup


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


class Tracer:
    """Process-wide structured tracer (module docstring).

    ``max_events`` bounds the in-memory trace (further events are
    counted in ``dropped_events``, never silently lost from the
    counters); flight-recorder sinks observe every event regardless, so
    their bounded ring buffers stay current past the cap.
    """

    def __init__(self, max_events: Optional[int] = None,
                 enabled: Optional[bool] = None):
        self._lock = threading.RLock()
        self._enabled = (_env_truthy("MXTPU_TRACE") if enabled is None
                         else bool(enabled))
        if max_events is None:
            try:
                max_events = int(os.environ.get("MXTPU_TRACE_EVENTS",
                                                200000))
            except ValueError:
                max_events = 200000
        self._max_events = int(max_events)
        self.record_wall = _env_truthy("MXTPU_TRACE_WALL")
        self._events: List[TraceEvent] = []
        self._alias: Dict[str, str] = {}
        self._tick = 0
        self._dropped = 0
        self._sinks: List[Any] = []   # flight recorders

    # -- lifecycle -------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def active(self) -> bool:
        """Whether emit() records anywhere (the tracer proper OR an
        attached flight-recorder sink) — the cheap guard every
        instrumented hot path checks first."""
        return self._enabled or bool(self._sinks)

    def enable(self, reset: bool = True) -> None:
        with self._lock:
            if reset:
                self.reset()
            self._enabled = True

    def disable(self) -> None:
        with self._lock:
            self._enabled = False

    def reset(self) -> None:
        """Clear events, the tick clock and aliases — the start-of-run
        point the determinism contract is relative to."""
        with self._lock:
            self._events = []
            self._alias = {}
            self._tick = 0
            self._dropped = 0

    # -- sinks (flight recorder) -----------------------------------------
    def add_sink(self, sink) -> None:
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    # -- correlation -----------------------------------------------------
    def alias(self, child: str, parent: str) -> None:
        """Register ``child`` as another name of ``parent``'s timeline
        (the transport's engine-rid -> gateway-rid mapping): events
        emitted under ``child`` resolve to ``parent`` at record time."""
        with self._lock:
            if (child not in self._alias
                    and len(self._alias) >= MAX_ALIASES):
                self._alias.pop(next(iter(self._alias)))
            self._alias[child] = parent

    def resolve(self, rid: Optional[str]) -> Optional[str]:
        if rid is None:
            return None
        return self._alias.get(rid, rid)

    # -- recording -------------------------------------------------------
    def emit(self, etype: str, rid: Optional[str] = None,
             phase: str = "I", noise: Optional[dict] = None,
             **fields) -> Optional[TraceEvent]:
        """Record one typed event (no-op unless :attr:`active`).
        ``etype`` must be registered in :data:`EVENT_TYPES` — a typo
        here is a taxonomy bug and raises."""
        if not (self._enabled or self._sinks):
            return None
        if etype not in EVENT_TYPES:
            raise ValueError(
                "unregistered trace event type %r — add it to "
                "mxtpu_torch.observability.trace.EVENT_TYPES" % (etype,))
        with self._lock:
            rid = self._alias.get(rid, rid) if rid is not None else None
            self._tick += 1
            ev = TraceEvent(self._tick, etype, rid, phase,
                            fields, noise or {})
            if self._enabled:
                if len(self._events) < self._max_events:
                    self._events.append(ev)
                else:
                    self._dropped += 1
            for sink in self._sinks:
                sink.observe(ev)
            return ev

    def span(self, etype: str, rid: Optional[str] = None,
             **fields) -> _Span:
        """Context manager recording a begin/end event pair (and a
        ``torch.profiler.record_function`` range while a torch profiler
        session records)."""
        return _Span(self, etype, rid, fields)

    # -- querying --------------------------------------------------------
    def events(self, rid: Optional[str] = None,
               types=None) -> List[TraceEvent]:
        with self._lock:
            out = list(self._events)
        if rid is not None:
            out = [e for e in out if e.rid == self.resolve(rid)]
        if types is not None:
            tset = {types} if isinstance(types, str) else set(types)
            out = [e for e in out if e.etype in tset]
        return out

    def timeline(self, rid: str) -> List[TraceEvent]:
        """Every recorded event of one request, tick order."""
        return self.events(rid=rid)

    def span_count(self) -> int:
        """Completed spans (end events) recorded so far."""
        with self._lock:
            return sum(1 for e in self._events if e.phase == "E")

    @property
    def ticks(self) -> int:
        """The current tick — cheap; ``stats()`` scans the whole event
        list, which failure-path callers must not pay per postmortem."""
        with self._lock:
            return self._tick

    @property
    def dropped_events(self) -> int:
        return self._dropped

    def stats(self) -> Dict[str, int]:
        """Numeric summary (a MetricsRegistry source)."""
        with self._lock:
            return {
                "enabled": int(self._enabled),
                "events": len(self._events),
                "spans": sum(1 for e in self._events
                             if e.phase == "E"),
                "dropped_events": self._dropped,
                "ticks": self._tick,
                "aliases": len(self._alias),
            }

    # -- serialization ---------------------------------------------------
    def to_json(self, include_noise: bool = False,
                indent: Optional[int] = None) -> str:
        """Deterministic JSON of the recorded trace: same seeds + same
        fault plan (+ a reset at the start of the run) => byte-identical
        output.  ``include_noise=True`` adds the NOISE-labeled
        wall-clock annotations (then equality is no longer promised)."""
        with self._lock:
            events = [e.to_dict(include_noise=include_noise)
                      for e in self._events]
            dropped = self._dropped
        return json.dumps({"version": 1, "clock": "tick",
                           "dropped": dropped, "events": events},
                          sort_keys=True, separators=(",", ":"),
                          indent=indent)


class _TracingContext:
    """``with tracing():`` — enable (resetting by default), restore the
    prior enabled state on exit."""

    def __init__(self, reset: bool = True):
        self._reset = reset
        self._prev = None

    def __enter__(self) -> Tracer:
        tr = get_tracer()
        self._prev = tr.enabled
        tr.enable(reset=self._reset)
        return tr

    def __exit__(self, *exc):
        if not self._prev:
            get_tracer().disable()
        return False


def tracing(reset: bool = True) -> _TracingContext:
    """Scoped tracing: ``with tracing() as tr: ... tr.to_json()``."""
    return _TracingContext(reset=reset)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer instance."""
    return _TRACER


# -- chrome trace-event export (one writer for both APIs) ----------------

def export_chrome_trace(file=None, include_noise: bool = True,
                        tracer: Optional[Tracer] = None) -> Optional[str]:
    """Chrome trace-event JSON (chrome://tracing / Perfetto) of the
    tick-clock structured trace, on the deterministic clock: 1 tick is
    rendered as 1 us.  ``file`` may be a
    path or a writable file object; with neither, the JSON string is
    returned."""
    tr = tracer if tracer is not None else get_tracer()
    tid_map: Dict[str, int] = {}

    def _tid(rid):
        if rid is None:
            return 0
        return tid_map.setdefault(rid, len(tid_map) + 1)

    trace_events: List[dict] = []
    for ev in tr.events():
        ph = {"I": "i", "B": "B", "E": "E"}[ev.phase]
        rec = {"name": ev.etype, "ph": ph, "ts": ev.tick, "pid": 0,
               "tid": _tid(ev.rid), "cat": "mxtpu"}
        if ph == "i":
            rec["s"] = "t"
        args = dict(ev.fields)
        if ev.rid is not None:
            args["rid"] = ev.rid
        if include_noise and ev.noise:
            args["NOISE"] = dict(ev.noise)
        rec["args"] = args
        trace_events.append(rec)

    doc = {"traceEvents": trace_events, "displayTimeUnit": "ms",
           "otherData": {"clock": "mxtpu deterministic tick "
                                  "(1 tick rendered as 1 us)"}}
    text = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    if file is None:
        return text
    if hasattr(file, "write"):
        file.write(text)
        return None
    with open(file, "w") as f:
        f.write(text)
    return None
