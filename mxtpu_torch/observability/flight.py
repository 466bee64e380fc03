"""Failure flight recorder: bounded per-request ring buffers and
postmortems (the port of ``mxtpu/observability/flight.py``).

A failure report must carry the failing request's whole timeline
(admitted where, which tier served its prefix, which fault fired)
without paying unbounded trace memory on the happy path.  The flight
recorder is the bounded always-on form of the tracer: it attaches to the
:class:`~mxtpu_torch.observability.trace.Tracer` as a sink (events flow
even while full tracing is disabled), keeps only the last ``buffer``
events per request id in a ring, and on a failure path (engine
quarantine, load shed, a failed weight adoption, checkpoint corruption)
snapshots a :class:`Postmortem` naming the implicated requests plus a
resilience-counters DELTA (relative to the recorder's reset, so reruns
of the same seed and fault plan serialize byte-identically).

Timelines materialize at READ time (:meth:`FlightRecorder.postmortem_
record` / :meth:`to_json`) from the live ring buffers: a postmortem
dumped after the run shows the implicated requests' later events (a
requeue, the retry's admission) too, not just their history up to the
failure.  The ring bound is the only truncation, and it is explicit
(``MXTPU_FLIGHT_BUFFER`` events per request).

Enable with ``MXTPU_FLIGHT_BUFFER=N`` (ambient, N > 0 events per
request) or the :func:`flight_recording` context manager / ``get_
flight().enable()``.  Determinism: ticks come from the tracer's counter
clock; wall clocks never appear in a postmortem.
"""

from __future__ import annotations

import json
import os
import sys
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .trace import TraceEvent, get_tracer

__all__ = ["Postmortem", "FlightRecorder", "get_flight",
           "flight_recording"]

#: ring buffers kept for at most this many distinct request ids; the
#: oldest-touched id is evicted past it (bounded-bookkeeping discipline)
MAX_TRACKED_REQUESTS = 4096
#: postmortem records kept (oldest evicted past it)
MAX_POSTMORTEMS = 256
#: the process-wide resilience counters the postmortems' deltas read
_COUNTERS_MODULE = __name__.rsplit(".", 2)[0] + ".resilience.counters"


def default_buffer() -> int:
    """Ambient per-request ring size: ``MXTPU_FLIGHT_BUFFER`` (0 = the
    recorder stays off)."""
    try:
        return max(0, int(os.environ.get("MXTPU_FLIGHT_BUFFER", "0")))
    except ValueError:
        return 0


class Postmortem:
    """One failure snapshot: the trigger (kind, tick, context, counters
    delta) captured at failure time plus the implicated request ids
    whose timelines materialize from the ring buffers at read time.
    ``noise`` is the non-deterministic side channel (wall clocks) —
    readable on the object and under ``include_noise=True``,
    excluded from the deterministic serialization like event noise."""

    __slots__ = ("kind", "tick", "rids", "context", "counters", "noise")

    def __init__(self, kind: str, tick: int, rids: Tuple[str, ...],
                 context: Dict[str, Any], counters: Dict[str, int],
                 noise: Optional[Dict[str, Any]] = None):
        self.kind = kind
        self.tick = tick
        self.rids = rids
        self.context = context
        self.counters = counters
        self.noise = dict(noise or {})

    def __repr__(self):
        return "<Postmortem %s tick=%d rids=%r>" % (
            self.kind, self.tick, list(self.rids))


class FlightRecorder:
    """Bounded per-request event rings + failure postmortems (module
    docstring)."""

    def __init__(self, buffer: Optional[int] = None):
        self._buffer = default_buffer() if buffer is None else int(buffer)
        self._rings: Dict[str, deque] = {}
        self._posts: List[Postmortem] = []
        self._counter_base: Dict[str, int] = {}
        self._attached = False
        if self._buffer > 0:
            self.enable(reset=True)

    # -- lifecycle -------------------------------------------------------
    @property
    def active(self) -> bool:
        return self._attached

    @property
    def buffer(self) -> int:
        return self._buffer

    def enable(self, buffer: Optional[int] = None,
               reset: bool = True) -> "FlightRecorder":
        if buffer is not None:
            self._buffer = int(buffer)
        if self._buffer <= 0:
            raise ValueError(
                "flight recorder needs a positive per-request buffer "
                "(set MXTPU_FLIGHT_BUFFER or pass buffer=)")
        if reset:
            self.reset()
        if not self._attached:
            get_tracer().add_sink(self)
            self._attached = True
        return self

    def disable(self) -> None:
        if self._attached:
            get_tracer().remove_sink(self)
            self._attached = False

    def reset(self) -> None:
        """Clear rings and postmortems and re-baseline the counters
        snapshot — the start-of-run point postmortem determinism is
        relative to."""
        self._rings = {}
        self._posts = []
        self._counter_base = self._counters_now()

    # -- the tracer sink -------------------------------------------------
    def observe(self, ev: TraceEvent) -> None:
        """Called by the tracer for every emitted event (rid-less events
        land in a shared ``_global`` ring so pool-level context — spilled
        chains, weight adoptions — survives into postmortems)."""
        rid = ev.rid if ev.rid is not None else "_global"
        ring = self._rings.get(rid)
        if ring is None:
            if len(self._rings) >= MAX_TRACKED_REQUESTS:
                # evict the least-recently-touched id (insertion order
                # approximates it; dict preserves insertion order and a
                # touched ring is re-inserted below)
                self._rings.pop(next(iter(self._rings)))
            ring = deque(maxlen=self._buffer)
        else:
            del self._rings[rid]     # re-insert = touch
        ring.append(ev)
        self._rings[rid] = ring

    # -- failure capture -------------------------------------------------
    @staticmethod
    def _counters_now() -> Dict[str, int]:
        # The ambient recorder is built at import (MXTPU_FLIGHT_BUFFER):
        # counters are read only from an ALREADY-imported counters
        # module.  Before it exists every counter is zero (it holds the
        # only writers), so the empty baseline is exact.
        mod = sys.modules.get(_COUNTERS_MODULE)
        if mod is None:
            return {}
        return mod.counters()

    def failure(self, kind: str, rids=(), noise=None,
                **context) -> Optional[Postmortem]:
        """Record one postmortem (no-op while inactive).  ``rids`` are
        correlation ids (resolved through the tracer's alias map);
        ``context`` must be JSON-able, deterministic host data — engine
        tags, site names, error TYPE names (never wall clocks or memory
        addresses).  Non-deterministic facts worth keeping go in
        ``noise=``: present on the Postmortem and under
        ``include_noise=True``, excluded from the deterministic
        serialization."""
        if not self._attached:
            return None
        tr = get_tracer()
        now = self._counters_now()
        delta = {k: now[k] - self._counter_base.get(k, 0)
                 for k in sorted(now)
                 if now[k] - self._counter_base.get(k, 0)}
        pm = Postmortem(
            kind=kind,
            tick=tr.ticks,
            rids=tuple(tr.resolve(r) for r in rids),
            context=dict(context),
            counters=delta,
            noise=noise)
        if len(self._posts) >= MAX_POSTMORTEMS:
            self._posts.pop(0)
        self._posts.append(pm)
        return pm

    # -- reading ---------------------------------------------------------
    @property
    def postmortems(self) -> List[Postmortem]:
        return list(self._posts)

    def timeline(self, rid: str) -> List[TraceEvent]:
        """The ring-buffered timeline of one request id (resolved
        through the tracer alias map)."""
        rid = get_tracer().resolve(rid)
        return list(self._rings.get(rid, ()))

    def postmortem_record(self, pm: Postmortem,
                          include_noise: bool = False) -> Dict[str, Any]:
        """Materialize one postmortem into a JSON-able record: trigger
        context + counters delta + each implicated request's CURRENT
        ring-buffered timeline (read-time materialization — see module
        docstring)."""
        rec = {
            "kind": pm.kind,
            "tick": pm.tick,
            "context": pm.context,
            "counters": pm.counters,
            "requests": {
                rid: [e.to_dict(include_noise=include_noise)
                      for e in self.timeline(rid)]
                for rid in pm.rids},
        }
        if include_noise and pm.noise:
            rec["noise"] = pm.noise
        return rec

    def stats(self) -> Dict[str, int]:
        """Numeric summary (a MetricsRegistry source)."""
        return {
            "active": int(self._attached),
            "buffer": self._buffer,
            "tracked_requests": len(self._rings),
            "postmortems": len(self._posts),
        }

    def to_json(self, include_noise: bool = False,
                indent: Optional[int] = None) -> str:
        """Deterministic JSON of every postmortem (byte-identical
        across reruns of the same seed + fault plan after a reset —
        the flight-recorder acceptance contract)."""
        return json.dumps(
            {"version": 1, "clock": "tick", "buffer": self._buffer,
             "postmortems": [self.postmortem_record(
                 pm, include_noise=include_noise)
                 for pm in self._posts]},
            sort_keys=True, separators=(",", ":"), indent=indent)


class _FlightContext:
    """``with flight_recording(N):`` — enable (resetting), restore the
    prior attached state AND buffer size on exit, so a scoped recording
    inside a process started with ambient ``MXTPU_FLIGHT_BUFFER`` does
    not silently switch off (or resize) the always-on recorder (the
    same restore discipline as ``tracing()``).  The enter-time reset is
    not undone — the ambient recorder resumes with the events recorded
    since."""

    def __init__(self, buffer: int):
        self._buffer = buffer
        self._prev: Optional[Tuple[bool, int]] = None

    def __enter__(self) -> FlightRecorder:
        fl = get_flight()
        self._prev = (fl.active, fl.buffer)
        return fl.enable(buffer=self._buffer, reset=True)

    def __exit__(self, *exc):
        fl = get_flight()
        prev_attached, prev_buffer = self._prev
        fl.disable()
        fl._buffer = prev_buffer
        if prev_attached:
            fl.enable(buffer=prev_buffer, reset=False)
        return False


def flight_recording(buffer: int = 256) -> _FlightContext:
    """Scoped flight recording: ``with flight_recording(256) as fl:``."""
    return _FlightContext(buffer)


_FLIGHT = FlightRecorder()


def get_flight() -> FlightRecorder:
    """The process-wide flight recorder (attached at import when
    ``MXTPU_FLIGHT_BUFFER`` > 0)."""
    return _FLIGHT
