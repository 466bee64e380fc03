"""Deterministic metrics-driven autoscaling of a supervised replica
pool (the port of ``mxtpu/serving/autoscale.py``).

The :class:`Autoscaler` is a counter-clock policy loop over a live
:class:`~mxtpu_torch.serving.gateway.Gateway`: one :meth:`tick` per gateway
pump reads :class:`~mxtpu_torch.observability.metrics.MetricsRegistry`
DELTAS — shed counters, queue depth, per-replica load — and grows the
pool BEFORE users are turned away, then shrinks it back through a
graceful retire path that never drops a stream.  No wall clocks
anywhere: two runs of the same seed + fault plan make byte-identical
decisions at byte-identical ticks.

**Scale-up** fires when the last tick shed anything (``gateway.
qos_shed_requests`` / ``gateway.engine_shed_requests`` /
``resilience.shed_requests`` deltas — the same counters a
:class:`~mxtpu_torch.resilience.LoadShedError`'s ``retry_after_ticks`` hint
is computed from) or the queue outgrew the pool's free capacity.  One
replica spawns per decision through the same factory conventions as
:func:`~mxtpu_torch.serving.replica_pool` — a callable ``factory(i)`` joins
in-process, a ``"module:callable"`` spec string joins as a
:class:`~mxtpu_torch.serving.transport.SubprocessReplica` worker.

**Scale-down** is the OPPOSITE of the supervisor's death path: no
drain-and-requeue, no stream resets.  After ``cooldown_ticks`` of
sustained idleness the deterministic victim (highest-numbered idle
replica) is marked ``retiring`` — the router stops placing new work on
it, its ``submit`` refuses fresh admissions, and its in-flight streams
decode to natural completion.  Only at ``load == 0`` does the release
step run: the ``autoscale.retire`` fault site fires first (a raise
re-opens admissions and the victim rejoins the pool fully intact),
then an empty-replica ``drain()`` (asserted to requeue ZERO tags),
page-accounting assertions (``blocks_in_use == 0``,
``pinned_blocks == 0`` — the invariant of a clean retirement), then
pool removal and, for subprocess replicas, graceful
worker shutdown.

**Hysteresis**: every decision (including a failed spawn) starts a
``cooldown_ticks`` quiet period, and scale-down additionally requires
that many CONSECUTIVE idle ticks — flapping traffic holds the pool
steady.  Bounds come from ``min_replicas`` / ``max_replicas``
(defaults: ``MXTPU_AUTOSCALE_MIN`` / ``MXTPU_AUTOSCALE_MAX`` /
``MXTPU_AUTOSCALE_COOLDOWN_TICKS``).

**Hot-swap fan-out**: :meth:`adopt` pushes a verified checkpoint to
every active replica (each engine stages it and swaps at its own
iteration boundary — see ``PagedContinuousBatchingEngine.adopt``; a
generation is the engine's own, so replicas sharing one model swap
apart) and remembers it so replicas spawned LATER adopt the same
generation instead of serving stale factory weights.
:meth:`rollback` re-stages the previous generation pool-wide.

Fault sites: ``autoscale.spawn`` keyed by the new
replica id — a raise degrades to current capacity (the decision is
counted, the pool is unchanged, cooldown still starts);
``autoscale.retire`` keyed by the victim id — a raise re-opens
admissions on a fully intact victim.  Every decision emits an
``autoscale.*`` trace event and every failure leaves a flight-recorder
postmortem, all byte-replayable.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from ..observability.flight import get_flight as _flight
from ..observability.metrics import MetricsRegistry
from ..observability.trace import get_tracer as _tracer
from ..resilience.counters import bump as _bump
from ..resilience.faults import inject as _inject
from .transport import (InProcessReplica, ReplicaTransport,
                        SubprocessReplica)

__all__ = ["Autoscaler"]


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class Autoscaler:
    """Counter-clock elastic-pool policy loop (module docstring).

    Parameters
    ----------
    gateway : the live :class:`~mxtpu_torch.serving.gateway.Gateway` whose
        pool this autoscaler manages.  Call :meth:`tick` once after
        each ``gateway.pump()``.
    factory : replica factory, following :func:`~mxtpu_torch.serving.
        replica_pool` conventions — a callable ``factory(i) -> engine``
        (wrapped in an :class:`InProcessReplica`) or a
        ``"module:callable"`` spec string (spawned as a
        :class:`SubprocessReplica` worker).
    min_replicas / max_replicas : pool size bounds (defaults
        ``MXTPU_AUTOSCALE_MIN`` = 1 / ``MXTPU_AUTOSCALE_MAX`` = 4).
    cooldown_ticks : hysteresis — quiet ticks after any decision, and
        the idle-streak length scale-down requires (default
        ``MXTPU_AUTOSCALE_COOLDOWN_TICKS`` = 5).
    kwargs : subprocess factory kwargs dict, or a callable
        ``i -> dict`` for per-replica values (ledger tags, devices).
    registry : the MetricsRegistry to read deltas through; default a
        private one wired to this gateway + the process resilience
        counters (so two autoscalers never alias each other's deltas).
    **spawn_kw : passed through to :class:`SubprocessReplica`
        (``rpc_timeout_ticks``, ``env``, ...).
    """

    def __init__(self, gateway, factory,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 cooldown_ticks: Optional[int] = None,
                 kwargs=None,
                 registry: Optional[MetricsRegistry] = None,
                 **spawn_kw):
        if min_replicas is None:
            min_replicas = _env_int("MXTPU_AUTOSCALE_MIN", 1)
        if max_replicas is None:
            max_replicas = _env_int("MXTPU_AUTOSCALE_MAX", 4)
        if cooldown_ticks is None:
            cooldown_ticks = _env_int("MXTPU_AUTOSCALE_COOLDOWN_TICKS", 5)
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1, got %d"
                             % min_replicas)
        if max_replicas < min_replicas:
            raise ValueError(
                "max_replicas (%d) must be >= min_replicas (%d)"
                % (max_replicas, min_replicas))
        if cooldown_ticks < 0:
            raise ValueError("cooldown_ticks must be >= 0, got %d"
                             % cooldown_ticks)
        self._gw = gateway
        self._factory = factory
        self._kwargs = kwargs
        self._spawn_kw = dict(spawn_kw)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown_ticks = int(cooldown_ticks)
        if registry is None:
            registry = MetricsRegistry()
            from ..resilience.counters import counters as _counters
            registry.register_source("resilience", _counters)
            registry.register_stats("gateway", gateway)
        self._registry = registry
        self._prev = self._registry.snapshot()
        # policy state — host ints only, never a clock
        self._ticks = 0
        self._cooldown = 0
        self._idle_streak = 0
        self._checkpoint = None       # last pool-wide adopted checkpoint
        # counters
        self._decisions = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._spawn_failures = 0
        self._retire_reopened = 0
        self._retired = 0
        self._adoptions_pushed = 0
        self._last_shed_delta = 0

    # -- introspection ---------------------------------------------------
    @property
    def supervisor(self):
        return self._gw.supervisor

    def _active(self) -> List[ReplicaTransport]:
        """Replicas the policy counts as serving capacity: alive and
        not already on the way out."""
        return [r for r in self.supervisor.alive if not r.retiring]

    def _retiring(self) -> List[ReplicaTransport]:
        return [r for r in self.supervisor.replicas
                if r.retiring and r.alive]

    @property
    def stats(self) -> dict:
        return {
            "ticks": self._ticks,
            "replicas": len(self.supervisor.replicas),
            "active_replicas": len(self._active()),
            "retiring_replicas": len(self._retiring()),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "cooldown_remaining": self._cooldown,
            "idle_streak": self._idle_streak,
            "decisions": self._decisions,
            "scale_ups": self._scale_ups,
            "scale_downs": self._scale_downs,
            "spawn_failures": self._spawn_failures,
            "retire_reopened": self._retire_reopened,
            "retired_replicas": self._retired,
            "adoptions_pushed": self._adoptions_pushed,
            "last_shed_delta": self._last_shed_delta,
        }

    # -- observability plumbing ------------------------------------------
    @staticmethod
    def _emit(etype, **fields):
        tr = _tracer()
        if tr.active:
            tr.emit(etype, **fields)

    @staticmethod
    def _flight_failure(kind, **context):
        fl = _flight()
        if fl.active:
            fl.failure(kind, **context)

    # -- the policy loop -------------------------------------------------
    def tick(self) -> Optional[str]:
        """One policy evaluation — call after each ``gateway.pump()``.
        Completes any pending retirement whose streams finished, then
        reads the registry delta since the last tick and decides at
        most ONE action.  Returns ``"grow"`` / ``"shrink"`` when a
        decision fired (including a degraded spawn), else None."""
        self._ticks += 1
        if self._cooldown > 0:
            self._cooldown -= 1
        # retire completion is not a new decision: pending victims
        # release the moment their last stream finishes, cooldown or not
        self._sweep_retiring()
        snap = self._registry.snapshot()
        delta = self._registry.delta(self._prev, snap)
        self._prev = snap
        shed_delta = int(
            delta.get("gateway.qos_shed_requests", 0)
            + delta.get("gateway.engine_shed_requests", 0)
            + delta.get("resilience.shed_requests", 0))
        self._last_shed_delta = shed_delta
        queue = int(snap.get("gateway.queued", 0))
        active = self._active()
        # demand the pool cannot decode THIS tick: gateway queue plus
        # work sitting in engine queues beyond the pool's slot capacity
        # (replicas absorb admissions into internal queues long before
        # they shed, so gateway.queued alone under-reads pressure)
        load = sum(r.load for r in active)
        cap = sum(r.capacity for r in active)
        backlog = queue + load - cap
        busy = queue > 0 or shed_delta > 0 or load > 0
        self._idle_streak = 0 if busy else self._idle_streak + 1
        if self._cooldown > 0:
            return None
        if (shed_delta > 0 or backlog > 0) and \
                len(active) < self.max_replicas:
            return self._grow(
                reason="shed" if shed_delta > 0 else "backlog",
                shed_delta=shed_delta, queue=queue, load=load,
                capacity=cap)
        if (self._idle_streak >= max(1, self.cooldown_ticks)
                and len(active) > self.min_replicas):
            victim = self._pick_victim(active)
            if victim is not None:
                return self._shrink(victim)
        return None

    # -- scale-up --------------------------------------------------------
    def _next_replica_id(self) -> str:
        """Deterministic fresh id: one past the highest ``r<N>`` in the
        pool (ids of retired replicas are never reused while any later
        one lives, so trace streams stay unambiguous)."""
        top = -1
        for r in self.supervisor.replicas:
            m = re.match(r"^r(\d+)$", r.replica_id)
            if m:
                top = max(top, int(m.group(1)))
        return "r%d" % (top + 1)

    def _grow(self, reason: str, **signals) -> str:
        self._decisions += 1
        self._cooldown = self.cooldown_ticks
        new_id = self._next_replica_id()
        self._emit("autoscale.decision", action="grow", reason=reason,
                   replica=new_id,
                   replicas=len(self.supervisor.replicas), **signals)
        try:
            _inject("autoscale.spawn", key=new_id)
            rep = self._spawn(new_id)
        except Exception as exc:  # noqa: BLE001 — a failed spawn
            # degrades to current capacity; it must never take down
            # the pool that IS serving
            self._spawn_failures += 1
            _bump("autoscale_spawn_failures")
            self._flight_failure(
                "autoscale_spawn_failed", replica=new_id,
                reason=reason, error=str(exc),
                error_type=type(exc).__name__)
            return "grow"
        if self._checkpoint is not None:
            # a pool that hot-swapped must not serve two generations:
            # the newcomer stages the adopted checkpoint before it
            # takes its first admission (installed on its first step)
            try:
                rep.adopt(self._checkpoint)
                self._adoptions_pushed += 1
            except Exception as exc:  # noqa: BLE001 — the newcomer
                # keeps its factory weights; the postmortem says so
                self._flight_failure(
                    "autoscale_adopt_failed", replica=new_id,
                    error=str(exc), error_type=type(exc).__name__)
        self.supervisor.add_replica(rep)
        self._scale_ups += 1
        _bump("autoscale_spawns")
        self._emit("autoscale.spawn", replica=new_id, reason=reason,
                   replicas=len(self.supervisor.replicas))
        return "grow"

    def _spawn(self, new_id: str) -> ReplicaTransport:
        idx = int(new_id[1:])
        if callable(self._factory):
            return InProcessReplica(self._factory(idx), new_id)
        if isinstance(self._factory, str):
            kw = (self._kwargs(idx) if callable(self._kwargs)
                  else dict(self._kwargs or {}))
            return SubprocessReplica(self._factory, kwargs=kw,
                                     replica_id=new_id,
                                     **self._spawn_kw)
        raise TypeError(
            "autoscaler factory must be a callable factory(i) -> "
            "engine or a 'module:callable' spec string, got %r"
            % (self._factory,))

    # -- scale-down ------------------------------------------------------
    @staticmethod
    def _pick_victim(active) -> Optional[ReplicaTransport]:
        """The deterministic victim: the HIGHEST-numbered idle replica
        (last in id order), so a stable pool always shrinks from the
        same end."""
        idle = [r for r in active if r.load == 0]
        if not idle:
            return None
        return sorted(idle, key=lambda r: r.replica_id)[-1]

    def _shrink(self, victim: ReplicaTransport) -> str:
        self._decisions += 1
        self._cooldown = self.cooldown_ticks
        self._idle_streak = 0
        victim.retiring = True
        self._scale_downs += 1
        self._emit("autoscale.decision", action="shrink",
                   reason="idle", replica=victim.replica_id,
                   replicas=len(self.supervisor.replicas))
        self._emit("autoscale.retire", stage="begin",
                   replica=victim.replica_id, load=victim.load)
        # release happens in _sweep_retiring once load hits 0 — for an
        # idle victim that is the very next tick
        return "shrink"

    def retire(self, replica_id: str) -> None:
        """Operator-driven decommission of one replica: admissions
        stop NOW; the release step runs on a later :meth:`tick` once
        its in-flight streams decode to natural completion (no stream
        is dropped, no tag is requeued).  Refuses to shrink the active
        pool below ``min_replicas``."""
        rep = self.supervisor.replica(replica_id)
        if rep.retiring:
            return
        if not rep.alive:
            raise ValueError(
                "replica %r is dead — the supervisor death path owns "
                "it, not a graceful retire" % (replica_id,))
        if len(self._active()) - 1 < self.min_replicas:
            raise ValueError(
                "retiring %r would drop the active pool below "
                "min_replicas=%d" % (replica_id, self.min_replicas))
        self._shrink(rep)

    def _sweep_retiring(self) -> None:
        for rep in self._retiring():
            if rep.load > 0:
                continue    # streams still draining to completion
            self._release(rep)

    def _release(self, rep: ReplicaTransport) -> None:
        """The retire release step: fault site first (a raise re-opens
        admissions on a fully intact victim), then the zero-requeue
        drain, page-accounting assertions, pool removal, and worker
        teardown."""
        try:
            _inject("autoscale.retire", key=rep.replica_id)
        except Exception as exc:  # noqa: BLE001 — a refused release
            # re-opens the victim: it rejoins the pool fully intact
            rep.retiring = False
            self._retire_reopened += 1
            _bump("autoscale_retire_reopened")
            self._emit("autoscale.retire", stage="reopened",
                       replica=rep.replica_id,
                       error=type(exc).__name__)
            self._flight_failure(
                "autoscale_retire_reopened", replica=rep.replica_id,
                error=str(exc), error_type=type(exc).__name__)
            return
        # the graceful path: the victim is empty, so drain() requeues
        # NOTHING (the death path's drain-and-requeue never runs) and
        # only drops the cache tiers
        requeued = rep.drain()
        assert not requeued, (
            "graceful retire drained %d tag(s) off %r — victim was "
            "supposed to be empty" % (len(requeued), rep.replica_id))
        st = rep.stats()
        blocks = int(st.get("blocks_in_use", 0))
        pinned = int(st.get("pinned_blocks", 0))
        assert blocks == 0 and pinned == 0, (
            "retired replica %r still holds pages: blocks_in_use=%d "
            "pinned_blocks=%d" % (rep.replica_id, blocks, pinned))
        self.supervisor.remove_replica(rep.replica_id)
        if hasattr(rep, "shutdown"):
            try:
                rep.shutdown()
            except Exception:  # noqa: BLE001 — a worker that dies rudely
                pass           # during teardown is already torn down
        if hasattr(rep, "close"):
            rep.close()
        self._retired += 1
        _bump("autoscale_retires")
        self._emit("autoscale.retire", stage="released",
                   replica=rep.replica_id, blocks_in_use=blocks,
                   pinned_blocks=pinned,
                   replicas=len(self.supervisor.replicas))

    # -- hot-swap fan-out ------------------------------------------------
    def adopt(self, checkpoint) -> Dict[str, int]:
        """Stage ``checkpoint`` on every active replica (id order) and
        remember it for future spawns.  Returns ``{replica_id ->
        staged generation}``.  A failing replica stops the fan-out and
        re-raises its typed error — replicas already staged keep the
        new generation (recover pool-wide with :meth:`rollback`); the
        checkpoint is only remembered when EVERY replica staged it."""
        out: Dict[str, int] = {}
        for rep in sorted(self._active(), key=lambda r: r.replica_id):
            out[rep.replica_id] = int(rep.adopt(checkpoint))
            self._adoptions_pushed += 1
        self._checkpoint = checkpoint
        return out

    def rollback(self) -> Dict[str, int]:
        """Re-stage the previous generation on every active replica
        (id order); forgets the remembered checkpoint so future spawns
        serve factory weights again."""
        out: Dict[str, int] = {}
        for rep in sorted(self._active(), key=lambda r: r.replica_id):
            out[rep.replica_id] = int(rep.rollback())
        self._checkpoint = None
        return out
