"""Deterministic fault injection: named sites and replayable fault
plans (the port of ``mxtpu/resilience/faults.py``, kept nearly verbatim
so one plan spec fires at the same hits in both engines).

Every injection is counter-driven: a plan names a site, a hit number and
an action, and the Nth matching ``inject()`` call fires it, identically
on every rerun.  No randomness anywhere.

Sites woven into the port (``SITES`` below):

==========================  ==============================================
site                        fires at
==========================  ==============================================
``serving.step``            once per decoding slot per scheduler
                            iteration, keyed by request id, before the
                            pooled decode step
``serving.admit``           start of admission (both engines), keyed by
                            request id
``serving.prefix_lookup``   before the paged engine's radix lookup, keyed
                            by request id
``serving.block_alloc``     before the paged engine's page allocation,
                            keyed by request id; genuine transient
                            exhaustion defers admission, it never raises
``serving.swap_out``        before the hierarchical cache spills a pinned
                            chain to host memory: a raise drops the chain
                            (recomputed on the next miss), never stores
                            it half copied
``serving.swap_in``         before a spilled chain is restored at
                            admission, keyed by request id: a raise
                            releases every page the restore allocated and
                            quarantines only that request
``serving.draft``           once per speculating slot per iteration,
                            keyed by request id, before its proposal
``serving.verify``          once per slot in a pooled verify call, keyed
                            by request id, before the call
``serving.adopt``           first thing in an engine's ``adopt()``, keyed
                            by the checkpoint's basename: a raise is an
                            adoption that never started
``gateway.admit``           top of ``Gateway.submit``, keyed by the
                            gateway request id, before any queue or
                            quota state changes
``router.dispatch``         before a routed submit, keyed by the gateway
                            request id: a ``ReplicaDownError`` reroutes
``replica.health``          each supervisor health probe, keyed by
                            replica id
``replica.stream``          each replica ``poll``, keyed by replica id
``transport.rpc``           before a subprocess replica's RPC frame is
                            written, keyed by replica id
``transport.encode``        before a subprocess submit encodes its spec,
                            keyed by replica id
``transport.worker_death``  before each subprocess RPC, keyed by replica
                            id: a raise is turned into a SIGKILL of the
                            worker
``autoscale.spawn``         before the autoscaler spawns a replica, keyed
                            by the new replica id: a raise keeps the
                            pool's capacity
``autoscale.retire``        at a retiring replica's release, keyed by its
                            id: a raise reopens it intact
``ckpt.write``              before a verified checkpoint's first byte
                            lands (``resilience.checkpoint``), keyed by
                            basename
``ckpt.verify``             at each checkpoint verification, keyed by
                            basename
==========================  ==============================================

``inject(site, key=...)`` takes any site name: the table is the
documented surface, not a closed set.  The reference declares more sites
(kvstore, training); the port declares the ones its code fires.

Every firing (raise or delay) is also a trace event: ``fault.<site>``
for a site with a registered event type, ``fault.unregistered`` with
the site in its fields otherwise (``_trace_fired``; recorded only while
the tracer or a flight recorder is active).

Plan grammar (one or more ``;``-separated rules)::

    RULE   := SITE ["#" KEY] ["@" N] ["+" | "x" COUNT | "%" PERIOD] ":" ACTION
    ACTION := "raise" ["=" EXC ["(" MESSAGE ")"]]
            | "delay" ["=" SECONDS]

- ``SITE`` matches the ``inject()`` site name exactly.
- ``#KEY`` restricts the rule to ``inject(site, key=...)`` calls whose
  ``str(key)`` equals KEY (e.g. one request id).  Calls that do not
  match a rule's key do not advance its hit counter.
- ``@N`` — first firing hit (default 1).
- Firing span: default fires on hit N only; ``+`` fires on every hit
  >= N; ``xC`` fires on hits N .. N+C-1; ``%P`` fires on hit N and
  every P hits after it (``@N`` defaults to P, so ``site%100`` fires
  on hits 100, 200, ...).
- ``raise`` raises EXC (a builtin exception name, ``MXTPUError``, or a
  dotted import path; default :class:`InjectedFault`) constructed with
  MESSAGE (default names the site and hit number).
- ``delay`` calls the plan's sleep callable with SECONDS (default
  0.05).  Tests pass ``sleep=`` a recorder so no real time passes.

Activation: ``with fault_plan("serving.step@3:raise=OSError"):`` for a
scoped plan (per-thread; entering resets the hit counters so a plan
object replays identically), or the ``MXTPU_FAULT_PLAN`` environment
variable for a process-wide ambient plan (parsed once on first use;
``reload_env_plan()`` re-reads it).  When both exist the context-manager
plan wins on its thread.
"""

from __future__ import annotations

import builtins
import os
import re
import threading
import time
from typing import List, Optional, Union

from ..base import MXTPUError
from .counters import bump

__all__ = ["InjectedFault", "FaultRule", "FaultPlan", "fault_plan",
           "inject", "active_plan", "site_stats", "reload_env_plan",
           "SITES"]

#: the documented injection sites (see module docstring for locations)
SITES = ("serving.step", "serving.admit", "serving.prefix_lookup",
         "serving.block_alloc", "serving.swap_out", "serving.swap_in",
         "serving.draft", "serving.verify", "serving.adopt",
         "gateway.admit", "router.dispatch", "replica.health",
         "replica.stream", "transport.rpc", "transport.encode",
         "transport.worker_death", "autoscale.spawn", "autoscale.retire",
         "ckpt.write", "ckpt.verify")


class InjectedFault(MXTPUError):
    """Default exception raised by a ``raise`` rule."""


_RULE_RE = re.compile(
    r"^(?P<site>[\w.\-]+)"
    r"(?:\#(?P<key>[\w.\-]+))?"
    r"(?:@(?P<at>\d+))?"
    r"(?:(?P<always>\+)|x(?P<count>\d+)|%(?P<period>\d+))?$")
_EXC_RE = re.compile(r"^(?P<name>[\w.]+)(?:\((?P<msg>.*)\))?$")


def _resolve_exc(name: str):
    """Exception class from a plan spec: builtin name, the port's error
    types, or a dotted import path."""
    if name in ("MXTPUError", "MXNetError"):
        return MXTPUError
    if name == "InjectedFault":
        return InjectedFault
    cls = getattr(builtins, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        return cls
    if "." in name:
        import importlib
        mod, _, attr = name.rpartition(".")
        try:
            cls = getattr(importlib.import_module(mod), attr)
        except (ImportError, AttributeError):
            cls = None
        if isinstance(cls, type) and issubclass(cls, BaseException):
            return cls
    raise ValueError(
        "fault plan: %r is not an exception class (use a builtin name, "
        "MXTPUError, InjectedFault, or a dotted import path)" % (name,))


class FaultRule:
    """One parsed plan rule with its per-plan hit/fired counters."""

    __slots__ = ("site", "key", "at", "count", "always", "period",
                 "action", "exc", "message", "seconds", "hits", "fired")

    def __init__(self, site, action, key=None, at=1, count=1,
                 always=False, period=None, exc=InjectedFault,
                 message=None, seconds=0.05):
        self.site = site
        self.key = key
        self.at = int(at)
        self.count = int(count)
        self.always = bool(always)
        self.period = int(period) if period else None
        self.action = action            # "raise" | "delay"
        self.exc = exc
        self.message = message
        self.seconds = float(seconds)
        self.hits = 0
        self.fired = 0

    @classmethod
    def parse(cls, text: str) -> "FaultRule":
        head, sep, action = text.partition(":")
        if not sep:
            raise ValueError(
                "fault plan rule %r: expected SITE[...]:ACTION" % (text,))
        m = _RULE_RE.match(head.strip())
        if m is None:
            raise ValueError(
                "fault plan rule %r: cannot parse site spec %r "
                "(grammar: SITE[#KEY][@N][+|xCOUNT|%%PERIOD])"
                % (text, head))
        g = m.groupdict()
        period = int(g["period"]) if g["period"] else None
        at = int(g["at"]) if g["at"] else (period or 1)
        kw = dict(site=g["site"], key=g["key"], at=at,
                  count=int(g["count"]) if g["count"] else 1,
                  always=bool(g["always"]), period=period)

        verb, _, arg = action.strip().partition("=")
        verb = verb.strip()
        if verb == "raise":
            exc, msg = InjectedFault, None
            if arg:
                em = _EXC_RE.match(arg.strip())
                if em is None:
                    raise ValueError(
                        "fault plan rule %r: bad raise spec %r "
                        "(expected ExcName or ExcName(message))"
                        % (text, arg))
                exc = _resolve_exc(em.group("name"))
                msg = em.group("msg")
            return cls(action="raise", exc=exc, message=msg, **kw)
        if verb == "delay":
            seconds = 0.05
            if arg:
                try:
                    seconds = float(arg)
                except ValueError:
                    raise ValueError(
                        "fault plan rule %r: bad delay seconds %r"
                        % (text, arg)) from None
            return cls(action="delay", seconds=seconds, **kw)
        raise ValueError(
            "fault plan rule %r: unknown action %r (raise|delay)"
            % (text, verb))

    # -- firing -----------------------------------------------------------
    def matches(self, site: str, key: Optional[str]) -> bool:
        if site != self.site:
            return False
        return self.key is None or self.key == key

    def fires(self, hit: int) -> bool:
        if hit < self.at:
            return False
        if self.always:
            return True
        if self.period is not None:
            return (hit - self.at) % self.period == 0
        return hit < self.at + self.count

    def make_exc(self) -> BaseException:
        msg = self.message
        if msg is None:
            msg = ("injected fault at site %r (hit %d)"
                   % (self.site, self.hits))
        return self.exc(msg)

    def reset(self):
        self.hits = 0
        self.fired = 0

    def __repr__(self):
        return "<FaultRule %s:%s hits=%d fired=%d>" % (
            self.site, self.action, self.hits, self.fired)


def _trace_fired(site: str, key: Optional[str], rule: "FaultRule",
                 action: str) -> None:
    """The trace event of a PLAN FIRING: a fired raise or delay lands in
    the structured trace and the flight recorder's rings as
    ``fault.<site>``, so the postmortem of a faulted run names which rule
    hit where.  A site outside the taxonomy emits ``fault.unregistered``
    with the site in its fields.  Imported lazily so this module stays
    import-light."""
    from ..observability.trace import EVENT_TYPES, get_tracer
    tr = get_tracer()
    if not tr.active:
        return
    etype = "fault." + site
    fields = {"site": site, "action": action, "hit": rule.hits}
    if key is not None:
        fields["key"] = str(key)
    if etype not in EVENT_TYPES:
        etype = "fault.unregistered"
    tr.emit(etype, **fields)


class FaultPlan:
    """A parsed set of rules plus the per-activation hit counters.

    Entering the context manager resets every rule's counters, so one
    plan object replays bit-identically across activations.  ``sleep``
    is the callable delay rules use — inject a recorder in tests so no
    real time passes."""

    def __init__(self, rules: Union[str, List[FaultRule], None],
                 sleep=None):
        if rules is None:
            rules = []
        if isinstance(rules, str):
            rules = [FaultRule.parse(r) for r in rules.split(";")
                     if r.strip()]
        self.rules: List[FaultRule] = list(rules)
        self._sleep = sleep if sleep is not None else time.sleep

    # -- the injection hook ----------------------------------------------
    def on_inject(self, site: str, key: Optional[str]):
        for rule in self.rules:
            if not rule.matches(site, key):
                continue
            rule.hits += 1
            if not rule.fires(rule.hits):
                continue
            rule.fired += 1
            if rule.action == "delay":
                bump("faults_delayed")
                _trace_fired(site, key, rule, "delay")
                self._sleep(rule.seconds)
                continue
            bump("faults_injected")
            _trace_fired(site, key, rule, "raise")
            raise rule.make_exc()

    # -- introspection ----------------------------------------------------
    def stats(self) -> dict:
        """{site: {"hits": n, "fired": m}} aggregated over the rules."""
        out: dict = {}
        for r in self.rules:
            s = out.setdefault(r.site, {"hits": 0, "fired": 0})
            s["hits"] += r.hits
            s["fired"] += r.fired
        return out

    # -- activation --------------------------------------------------------
    def __enter__(self):
        for r in self.rules:
            r.reset()
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:  # tolerate out-of-order exits rather than corrupt the stack
            try:
                stack.remove(self)
            except ValueError:
                pass
        return False


_TLS = threading.local()
_UNSET = object()
_ENV_PLAN = _UNSET  # parsed MXTPU_FAULT_PLAN (None = var absent)


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _env_plan() -> Optional[FaultPlan]:
    global _ENV_PLAN
    if _ENV_PLAN is _UNSET:
        spec = os.environ.get("MXTPU_FAULT_PLAN")
        _ENV_PLAN = FaultPlan(spec) if spec else None
    return _ENV_PLAN


def reload_env_plan() -> Optional[FaultPlan]:
    """Re-read ``MXTPU_FAULT_PLAN`` (it is otherwise parsed once, on
    first use)."""
    global _ENV_PLAN
    _ENV_PLAN = _UNSET
    return _env_plan()


def fault_plan(spec: Union[str, List[FaultRule], FaultPlan, None],
               sleep=None) -> FaultPlan:
    """Context manager activating a fault plan on this thread::

        with fault_plan("serving.step@3:raise=OSError(flaky)"):
            engine.run()
    """
    if isinstance(spec, FaultPlan):
        if sleep is not None:   # honor the override — silently keeping
            spec._sleep = sleep  # the plan's real time.sleep would break
        return spec              # the no-real-sleeps test discipline
    return FaultPlan(spec, sleep=sleep)


def active_plan() -> Optional[FaultPlan]:
    """The plan ``inject()`` would consult right now (thread-scoped plan
    first, then the ambient env plan)."""
    stack = getattr(_TLS, "stack", None)
    if stack:
        return stack[-1]
    return _env_plan()


def inject(site: str, key=None) -> None:
    """The hook woven into hot paths: no-op unless a plan is active and
    a rule matches; a matching ``raise`` rule raises HERE, so the
    exception propagates exactly like a real failure at this site."""
    plan = active_plan()
    if plan is None:
        return
    plan.on_inject(site, None if key is None else str(key))


def site_stats() -> dict:
    """Hit/fired statistics of the currently active plan ({} if none)."""
    plan = active_plan()
    return plan.stats() if plan is not None else {}
