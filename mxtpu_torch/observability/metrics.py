"""One metrics registry across the port's serving and training (the
port of ``mxtpu/observability/metrics.py``).

The :class:`MetricsRegistry` is the one collection point: named SOURCES
(callables returning nested dicts) are pulled LAZILY at
:meth:`~MetricsRegistry.snapshot` time and flattened into a single
``{"source.key.subkey": number}`` dict, with :meth:`~MetricsRegistry.
delta` for before/after reads and Prometheus-text and JSON exposition.

Built-in sources of the process registry (:func:`get_registry`):

======================  ================================================
source                  pulls
======================  ================================================
``resilience``          :func:`mxtpu_torch.resilience.counters`
                        (process-wide fault, retry, quarantine,
                        checkpoint and adoption counters)
``tracer``              :meth:`~mxtpu_torch.observability.trace.Tracer
                        .stats`
``flight``              :meth:`~mxtpu_torch.observability.flight.
                        FlightRecorder.stats`
``kernel_invocations``  :func:`mxtpu_torch.base.counts` — the kernel
                        wrappers' launch counters
                        (``kernel_invocations.<kernel_name>``): the
                        counter that shows a path went through a kernel
======================  ================================================

Live objects (the engines) register with
:meth:`~MetricsRegistry.register_stats`, which accepts anything with a
``stats`` property or method; unregister when the object retires.  All
values are numbers (bools coerce to 0/1); non-numeric leaves and
non-string keys are skipped during flattening.

Determinism: a snapshot is plain host counters — two runs of the same
seed and fault plan give identical deltas.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, Iterable, List, Optional

__all__ = ["MetricsRegistry", "get_registry", "default_registry"]


def _flatten(prefix: str, value: Any, out: Dict[str, float]) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            if isinstance(k, str):
                _flatten(prefix + "." + k, v, out)
        return
    if isinstance(value, bool):
        out[prefix] = int(value)
    elif isinstance(value, (int, float)):
        out[prefix] = value
    # non-numeric leaves (status strings, error records) are observable
    # through the owning object's own API; the registry is numeric


class MetricsRegistry:
    """Named lazy sources -> one flat numeric snapshot (module
    docstring)."""

    def __init__(self):
        self._sources: Dict[str, Callable[[], dict]] = {}

    # -- registration ----------------------------------------------------
    def register_source(self, name: str, fn: Callable[[], dict],
                        replace: bool = False) -> None:
        """Register ``fn() -> nested dict`` under ``name``.  Sources
        evaluate lazily at snapshot time; a raising source contributes
        one ``<name>.source_error = 1`` key instead of killing the
        snapshot (telemetry must never take the service down)."""
        if name in self._sources and not replace:
            raise ValueError(
                "metrics source %r already registered (pass "
                "replace=True to swap it)" % (name,))
        if not callable(fn):
            raise TypeError("metrics source must be a callable "
                            "returning a dict, got %r" % (fn,))
        self._sources[name] = fn

    def register_stats(self, name: str, obj: Any,
                       replace: bool = False) -> None:
        """Register a live object exposing ``stats`` (property, method,
        or plain dict attribute) — the serving engines."""
        if not hasattr(obj, "stats"):
            raise TypeError(
                "register_stats needs an object with a `stats` "
                "property/method, got %r" % (type(obj).__name__,))

        def _pull(o=obj):
            st = o.stats
            return st() if callable(st) else st

        self.register_source(name, _pull, replace=replace)

    def unregister(self, name: str) -> None:
        self._sources.pop(name, None)

    def sources(self) -> List[str]:
        return sorted(self._sources)

    # -- collection ------------------------------------------------------
    def snapshot(self, sources: Optional[Iterable[str]] = None
                 ) -> Dict[str, float]:
        """One flat ``{"source.key": number}`` dict over the selected
        (default: all) sources, pulled lazily now."""
        names = self.sources() if sources is None else list(sources)
        out: Dict[str, float] = {}
        for name in names:
            fn = self._sources.get(name)
            if fn is None:
                raise KeyError(
                    "unknown metrics source %r (registered: %r)"
                    % (name, self.sources()))
            try:
                val = fn()
            except Exception:  # noqa: BLE001 — a broken source must
                out[name + ".source_error"] = 1   # not kill telemetry
                continue
            _flatten(name, val if isinstance(val, dict) else
                     {"value": val}, out)
        return out

    def delta(self, before: Dict[str, float],
              after: Optional[Dict[str, float]] = None,
              include_zero: bool = False) -> Dict[str, float]:
        """``after - before`` per key (``after`` defaults to a fresh
        snapshot).  Keys absent from ``before`` count from 0; keys
        absent from ``after`` are dropped (their object retired)."""
        if after is None:
            after = self.snapshot()
        out = {}
        for k, v in after.items():
            d = v - before.get(k, 0)
            if d or include_zero:
                out[k] = d
        return out

    # -- exposition ------------------------------------------------------
    @staticmethod
    def _prom_name(key: str) -> str:
        return "mxtpu_" + re.sub(r"[^a-zA-Z0-9_]", "_", key)

    def to_prometheus(self,
                      snapshot: Optional[Dict[str, float]] = None) -> str:
        """Prometheus text exposition (all gauges — these are live
        counters/levels read at scrape time)."""
        snap = self.snapshot() if snapshot is None else snapshot
        lines = []
        for key in sorted(snap):
            name = self._prom_name(key)
            lines.append("# TYPE %s gauge" % name)
            val = snap[key]
            lines.append("%s %s" % (
                name, ("%d" % val) if isinstance(val, int)
                else repr(float(val))))
        return "\n".join(lines) + "\n"

    def to_json(self, snapshot: Optional[Dict[str, float]] = None,
                indent: Optional[int] = None) -> str:
        snap = self.snapshot() if snapshot is None else snapshot
        return json.dumps(snap, sort_keys=True,
                          separators=(",", ":"), indent=indent)


# -- built-in sources ----------------------------------------------------

def _src_resilience() -> dict:
    from ..resilience.counters import counters
    return counters()


def _src_tracer() -> dict:
    from .trace import get_tracer
    return get_tracer().stats()


def _src_flight() -> dict:
    from .flight import get_flight
    return get_flight().stats()


def _src_kernel_invocations() -> dict:
    """The kernel wrappers' launch counters, keyed by kernel name
    (``kernel_invocations.paged_attention`` etc.): one per call a wrapper
    served since the last ``base.reset_counts()``."""
    from ..base import counts
    return counts()


def default_registry() -> MetricsRegistry:
    """A fresh registry pre-loaded with the built-in process-wide
    sources (module docstring table)."""
    reg = MetricsRegistry()
    reg.register_source("resilience", _src_resilience)
    reg.register_source("tracer", _src_tracer)
    reg.register_source("flight", _src_flight)
    reg.register_source("kernel_invocations", _src_kernel_invocations)
    return reg


_REGISTRY = default_registry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (built-in sources pre-registered; add
    live engines with :meth:`MetricsRegistry.register_stats`)."""
    return _REGISTRY
