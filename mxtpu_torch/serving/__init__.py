"""mxtpu_torch.serving — fault-tolerant multi-replica serving: supervised
replica pool, prefix-locality router, streaming QoS gateway, elastic
autoscaling (the port of ``mxtpu/serving``).

Everything below this package serves from ONE engine; this is the
service layer that turns N engine replicas into one front.  Topology::

      client ──► Gateway ──► Router ──► ReplicaSupervisor
                 (QoS,        (prefix     │   health checks, stall
                  quotas,      locality    │   detection, drain-and-
                  streaming,   + load,     │   requeue, revive
                  deadlines,   hedging,    ▼
                  hedging)     reroute)   [ReplicaTransport × N]
                                           InProcessReplica(engine)
                                           SubprocessReplica(worker)

Layers (each module's docstring has the full story):

- :mod:`~mxtpu_torch.serving.transport` — :class:`ReplicaTransport`, the
  process seam: :class:`InProcessReplica` adapts one port
  ``ContinuousBatchingEngine``/``PagedContinuousBatchingEngine`` in this
  process, :class:`SubprocessReplica` one in a spawned worker process
  (:mod:`~mxtpu_torch.serving.worker`, pipe RPC, a real ``SIGKILL`` on
  death).
- :mod:`~mxtpu_torch.serving.supervisor` — :class:`ReplicaSupervisor`:
  counter-clock health checks (consecutive ``replica.health`` /
  ``replica.stream`` failures, stall detection on ``progress()`` deltas),
  deterministic drain-and-requeue on declared death (zero pages
  survive on a dead replica), probation revival.
- :mod:`~mxtpu_torch.serving.router` — :class:`Router`: places requests
  by the paged engines' exact radix/host-tier locality signal
  (``prefix_probe``) blended with load; typed
  :class:`ReplicaDownError` reroutes ride a ``RetryPolicy``.
- :mod:`~mxtpu_torch.serving.gateway` — :class:`Gateway`: per-iteration
  token streaming, QoS classes + per-tenant quotas over bounded
  admission (shed lowest class first, structured
  :class:`~mxtpu_torch.resilience.QosShedError` /
  :class:`~mxtpu_torch.resilience.EngineShedError` with retry-after
  hints), tick-counted deadlines, hedged re-dispatch.
- :mod:`~mxtpu_torch.serving.autoscale` — :class:`Autoscaler`: grows the
  pool on sheds or backlog, retires idle replicas gracefully, fans a
  weight adoption out to every replica and to later spawns.

Every failure path is a counter-driven fault site (``gateway.admit``,
``router.dispatch``, ``replica.health``, ``replica.stream``,
``transport.*``, ``autoscale.*``), so the whole service replays
bit-for-bit: any stream that completes — routed, hedged, requeued after
a mid-decode replica death — is bit-identical to an isolated
``TransformerLM.generate`` with the same seed.  Replicas may share one
model (several 8B replicas fit one card only so): each engine's weight
generation is its own.
"""

from __future__ import annotations

import os
from typing import Optional

from .autoscale import Autoscaler
from .gateway import Gateway
from .router import Router
from .supervisor import ReplicaSupervisor
from .transport import (InProcessReplica, ReplicaDownError,
                        ReplicaTransport, SubprocessReplica,
                        request_spec)

__all__ = ["Autoscaler", "Gateway", "Router", "ReplicaSupervisor",
           "ReplicaTransport", "InProcessReplica", "SubprocessReplica",
           "ReplicaDownError", "request_spec", "replica_pool"]


def replica_pool(factory, n: Optional[int] = None,
                 transport: Optional[str] = None,
                 kwargs=None, **spawn_kw):
    """Build N replicas from an engine factory.

    ``transport`` selects the boundary (default from
    ``MXTPU_REPLICA_TRANSPORT``, itself defaulting to ``inprocess``):

    - ``"inprocess"`` — ``factory(i)`` is a CALLABLE returning a fresh
      engine for replica i (the engines may share one model).
    - ``"subprocess"`` — ``factory`` is a ``"module:callable"`` SPEC
      string resolved inside each spawned worker process
      (:class:`SubprocessReplica`); ``kwargs`` is the factory's kwargs
      dict, or a callable ``i -> dict`` for per-replica values (ledger
      tags, devices).  Extra keyword arguments pass through to
      :class:`SubprocessReplica` (``rpc_timeout_ticks``, ``codec``,
      ``env``, ...).

    ``n`` defaults to ``MXTPU_REPLICAS`` (itself defaulting to 1: one
    replica is a plain engine behind the gateway's QoS front).

    >>> pool = replica_pool(
    ...     lambda i: PagedContinuousBatchingEngine(
    ...         model, ledger_tag="r%d" % i), n=2)
    >>> gw = Gateway(pool)

    >>> pool = replica_pool(
    ...     "mxtpu_torch.serving.worker:demo_paged_engine", n=2,
    ...     transport="subprocess",
    ...     kwargs=lambda i: {"ledger_tag": "r%d" % i})
    """
    if n is None:
        try:
            n = int(os.environ.get("MXTPU_REPLICAS", 1))
        except ValueError:
            n = 1
    if n < 1:
        raise ValueError("replica_pool needs n >= 1, got %d" % n)
    if transport is None:
        transport = os.environ.get("MXTPU_REPLICA_TRANSPORT",
                                   "inprocess").strip() or "inprocess"
    if transport == "inprocess":
        if not callable(factory):
            raise ValueError(
                "inprocess replica_pool needs a callable factory(i) "
                "returning an engine, got %r" % (factory,))
        return [InProcessReplica(factory(i), "r%d" % i)
                for i in range(n)]
    if transport == "subprocess":
        if not isinstance(factory, str):
            raise ValueError(
                "subprocess replica_pool needs a 'module:callable' "
                "factory spec string (resolved in the worker process), "
                "got %r" % (factory,))
        return [SubprocessReplica(
            factory,
            kwargs=(kwargs(i) if callable(kwargs)
                    else dict(kwargs or {})),
            replica_id="r%d" % i, **spawn_kw) for i in range(n)]
    raise ValueError(
        "unknown replica transport %r (MXTPU_REPLICA_TRANSPORT: "
        "'inprocess' or 'subprocess')" % (transport,))
