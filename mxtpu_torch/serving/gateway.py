"""Gateway: the streaming, QoS-aware front of a supervised replica
pool (the port of ``mxtpu/serving/gateway.py``).

One ``Gateway`` owns the client-facing request lifecycle; everything
below it (placement, health, death) is the router's and supervisor's
job.  The gateway adds exactly the production concerns the engines
deliberately left out:

- **streaming**: both engines decode iteration-at-a-time; the gateway
  surfaces that as a per-request token stream (:meth:`stream`) fed by
  each :meth:`pump` — tokens reach the caller as they decode, not at
  completion.  When a request is re-dispatched (replica death, hedge
  winner change) the stream emits a ``("reset",)`` event and replays
  from the new dispatch: the restart is bit-identical from the seed, so
  the post-reset stream equals the fault-free stream exactly.
- **QoS classes**: ``qos_classes`` priority levels (0 = highest;
  default from ``MXTPU_QOS_CLASSES``).  Dispatch order is (class,
  arrival); under a full queue the LOWEST class sheds first — an
  arriving higher-class request displaces the newest lowest-class
  queued request rather than being refused.  Sheds carry the
  structured :class:`~mxtpu_torch.resilience.QosShedError` (queue depth,
  limit, deterministic retry-after-ticks hint).
- **per-tenant quotas**: at most ``tenant_quota`` outstanding requests
  per tenant, shed with the same typed error.  Engine-level sheds
  surfacing through a dispatch are mapped to
  :class:`~mxtpu_torch.resilience.EngineShedError` instead — callers can
  tell "back off / raise my class" from "this request can never fit".
- **deadlines and hedging**: gateway deadlines are counted in PUMPS
  (ticks), not seconds — deterministic and replayable.  With
  ``hedge_fraction``, a request still unfinished after that fraction
  of its deadline is duplicated onto the next-best replica; the first
  dispatch to finish wins and the loser is cancelled through the
  engines' idempotent release path.  Hedged streams stay bit-identical
  (same spec, same seed ⇒ same tokens on any replica).
- **drain-and-requeue**: tags drained off a dead replica requeue at
  the front of their class and redispatch from their seeds; affected
  streams complete bit-identical to a fault-free run.

Results are the engines' form: (1, T_prompt + generated) int32 CPU
tensors.

The ``gateway.admit`` fault site fires at the top of :meth:`submit`,
keyed by the request id — a raise models a poisoned admission path and
rejects the request before any queue/quota state changes.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as onp
import torch

from ..base import MXTPUError
from ..observability.flight import get_flight as _flight
from ..observability.trace import gateway_rid, get_tracer as _tracer
from ..resilience import (EngineShedError, LoadShedError, QosShedError,
                          RetryPolicy)
from ..resilience.counters import bump as _bump
from ..resilience.faults import inject as _inject
from .router import Router
from .supervisor import ReplicaSupervisor
from .transport import (InProcessReplica, ReplicaDownError,
                        ReplicaTransport, request_spec)

__all__ = ["Gateway"]


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class _GwRequest:
    """Host-side lifecycle record of one gateway request."""

    __slots__ = ("rid", "spec", "qos", "tenant", "deadline_ticks",
                 "hedge", "submitted_tick", "status", "result", "error",
                 "gens", "buffers", "next_gen", "resets", "requeues",
                 "hedged", "winner_gen")

    def __init__(self, rid, spec, qos, tenant, deadline_ticks, hedge,
                 tick):
        self.rid = rid
        self.spec = spec
        self.qos = qos
        self.tenant = tenant
        self.deadline_ticks = deadline_ticks
        self.hedge = hedge
        self.submitted_tick = tick
        self.status = "queued"     # queued/dispatched/ok/failed/
        #                            expired/shed
        self.result = None
        self.error = None
        self.gens: Dict[int, str] = {}     # live gen -> replica id
        self.buffers: Dict[int, List[int]] = {}
        self.next_gen = 0
        self.resets = 0
        self.requeues = 0
        self.hedged = False
        self.winner_gen = None     # the dispatch the final result is from

    @property
    def terminal(self):
        return self.status in ("ok", "failed", "expired", "shed")

    @property
    def head_gen(self) -> Optional[int]:
        """The dispatch the stream follows: the OLDEST live one."""
        return min(self.gens) if self.gens else None


class Gateway:
    """Streaming QoS gateway over a supervised replica pool (module
    docstring).

    Parameters
    ----------
    replicas : ReplicaTransport list, OR raw engines (each is wrapped
        in an :class:`InProcessReplica` with ids r0, r1, ...).
    qos_classes : priority levels (>= 1); None reads
        ``MXTPU_QOS_CLASSES`` (default 2).  Class 0 is highest;
        ``submit`` defaults to the LOWEST class.
    max_pending : bound on the gateway QUEUE (not in-flight work);
        None = unbounded.  Overflow sheds lowest-class-first.
    tenant_quota : max outstanding (queued + in-flight) requests per
        tenant; None = off.
    hedge_fraction : fraction of a request's deadline after which an
        unfinished request is duplicated onto another replica (None
        disables hedging; requests opt in/out per-submit).
    fail_threshold / stall_ticks / revive_after_ticks : supervisor
        knobs (see :class:`ReplicaSupervisor`).
    router : routing policy — a Router POLICY NAME (``"locality"`` /
        ``"round_robin"``) or a factory ``(supervisor) -> Router`` for
        custom scoring knobs.  (The Router needs the supervisor this
        gateway constructs, so a pre-built instance cannot exist yet —
        hence name-or-factory.)  Default: a locality router.
    retry : RetryPolicy for dispatch rerouting (see Router).
    history : terminal request records kept for status/result reads
        (oldest evicted past it — the engines' bounded-bookkeeping
        discipline; a long-lived gateway must not grow per-request
        state without bound).
    """

    def __init__(self, replicas, qos_classes: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 hedge_fraction: Optional[float] = 0.5,
                 fail_threshold: int = 3,
                 stall_ticks: Optional[int] = 25,
                 revive_after_ticks: Optional[int] = None,
                 router=None,
                 retry: Optional[RetryPolicy] = None,
                 history: int = 1024):
        wrapped: List[ReplicaTransport] = []
        for i, r in enumerate(replicas):
            if isinstance(r, ReplicaTransport):
                wrapped.append(r)
            else:
                wrapped.append(InProcessReplica(r, "r%d" % i))
        self._sup = ReplicaSupervisor(
            wrapped, fail_threshold=fail_threshold,
            stall_ticks=stall_ticks,
            revive_after_ticks=revive_after_ticks)
        if router is None:
            self._router = Router(self._sup, retry=retry)
        elif isinstance(router, str):
            self._router = Router(self._sup, policy=router, retry=retry)
        elif callable(router):
            self._router = router(self._sup)
        else:
            raise TypeError(
                "router must be a policy name ('locality'/"
                "'round_robin') or a factory (supervisor) -> Router, "
                "got %r — a pre-built Router cannot reference the "
                "supervisor this gateway is about to construct"
                % (router,))
        if qos_classes is None:
            qos_classes = _env_int("MXTPU_QOS_CLASSES", 2)
        if qos_classes < 1:
            raise ValueError("qos_classes must be >= 1, got %d"
                             % qos_classes)
        self._qos_classes = int(qos_classes)
        self._max_pending = (None if max_pending is None
                             else int(max_pending))
        self._tenant_quota = (None if tenant_quota is None
                              else int(tenant_quota))
        if hedge_fraction is not None and not 0 < hedge_fraction <= 1:
            raise ValueError("hedge_fraction must be in (0, 1], got %r"
                             % (hedge_fraction,))
        self._hedge_fraction = hedge_fraction
        self._tick = 0
        self._next_rid = 0
        self._reqs: Dict[int, _GwRequest] = {}
        self._queue: List[int] = []           # queued rids
        self._tenant_out: Dict[Any, int] = {}
        self._history = max(int(history), 8)
        self._done: List[int] = []            # terminal rids, oldest 1st
        # counters
        self._qos_sheds = 0
        self._engine_sheds = 0
        self._hedges = 0
        self._requeued = 0
        self._ttft: Dict[int, int] = {}       # rid -> ticks to 1st token

    # -- introspection ---------------------------------------------------
    @property
    def supervisor(self) -> ReplicaSupervisor:
        return self._sup

    @property
    def router(self) -> Router:
        return self._router

    @property
    def tick_count(self) -> int:
        return self._tick

    @property
    def pending(self) -> int:
        return len(self._queue)

    def status(self, rid) -> str:
        req = self._reqs.get(rid)
        return req.status if req is not None else "unknown"

    def error(self, rid) -> Optional[dict]:
        req = self._reqs.get(rid)
        return req.error if req is not None else None

    def streamed(self, rid) -> List[int]:
        """Tokens streamed so far on the request's CURRENT head
        dispatch (resets on requeue — see :meth:`stream`); after
        completion, the winning dispatch's full stream."""
        req = self._reqs[rid]
        g = req.winner_gen if req.terminal else req.head_gen
        if g is not None and g in req.buffers:
            return list(req.buffers[g])
        return []

    @property
    def stats(self) -> dict:
        # key names use the *_requests suffix convention
        return {
            "ticks": self._tick,
            "queued": len(self._queue),
            "outstanding": sum(1 for r in self._reqs.values()
                               if not r.terminal),
            "qos_shed_requests": self._qos_sheds,
            "engine_shed_requests": self._engine_sheds,
            "hedged_requests": self._hedges,
            "requeued_requests": self._requeued,
            "ttft_ticks": dict(self._ttft),
            "supervisor": self._sup.stats,
            "router": self._router.stats,
        }

    # -- observability plumbing ------------------------------------------
    @staticmethod
    def _emit(etype, rid, **fields):
        tr = _tracer()
        if tr.active:
            tr.emit(etype,
                    rid=None if rid is None else gateway_rid(rid),
                    **fields)

    @staticmethod
    def _flight_failure(kind, rid=None, **context):
        fl = _flight()
        if fl.active:
            rids = () if rid is None else (gateway_rid(rid),)
            fl.failure(kind, rids=rids, **context)

    # -- admission -------------------------------------------------------
    def _retry_after(self) -> int:
        """Deterministic backoff hint in ticks: how long until the
        queue likely reaches this request's position, from live
        counters (never a clock)."""
        cap = sum(r.capacity for r in self._sup.alive) or 1
        return max(1, -(-(len(self._queue) + 1) // cap))

    def submit(self, prompt_ids, max_new_tokens, temperature=0.0,
               top_k=0, top_p=0.0, repetition_penalty=1.0, seed=None,
               eos_id=None, qos: Optional[int] = None, tenant=None,
               deadline_ticks: Optional[int] = None,
               hedge: Optional[bool] = None,
               engine_retries: int = 0) -> int:
        """Queue one request; returns its gateway id.  Sampling knobs
        follow the engine ``submit`` contract (the seed is part of the
        respec every re-dispatch reuses — what makes requeues and
        hedges bit-identical).  ``qos``: priority class (0 highest,
        default lowest).  ``deadline_ticks``: pump-count budget; past
        it the request finishes ``expired`` with its partial stream.
        ``hedge``: opt in/out of hedged re-dispatch (default: hedging
        is on whenever the gateway has a ``hedge_fraction`` AND the
        request has a deadline).  ``engine_retries``: per-slot fault
        retries INSIDE a replica (the engine's ``retries=``), distinct
        from replica-death requeues which are always automatic."""
        rid = self._next_rid
        _inject("gateway.admit", key=rid)
        if qos is None:
            qos = self._qos_classes - 1
        if not 0 <= qos < self._qos_classes:
            raise ValueError("qos must be in [0, %d), got %r"
                             % (self._qos_classes, qos))
        # validate BEFORE any shed/displacement decision: a malformed
        # submit must never cost an innocent queued request its slot
        spec = request_spec(prompt_ids, max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p,
                            repetition_penalty=repetition_penalty,
                            seed=seed, eos_id=eos_id,
                            retries=engine_retries)
        if self._tenant_quota is not None and tenant is not None and \
                self._tenant_out.get(tenant, 0) >= self._tenant_quota:
            self._qos_sheds += 1
            _bump("gateway_sheds")
            self._emit("gateway.shed", None, reason="tenant_quota",
                       tenant=str(tenant))
            self._flight_failure("shed", reason="tenant_quota",
                                 tenant=str(tenant))
            raise QosShedError(
                "tenant %r has %d outstanding request(s) >= quota %d"
                % (tenant, self._tenant_out.get(tenant, 0),
                   self._tenant_quota),
                queue_depth=len(self._queue), limit=self._tenant_quota,
                retry_after_ticks=self._retry_after())
        if self._max_pending is not None and \
                len(self._queue) >= self._max_pending:
            victim = self._pick_shed_victim(qos)
            if victim is None:
                self._qos_sheds += 1
                _bump("gateway_sheds")
                self._emit("gateway.shed", None, reason="queue_full",
                           qos=qos)
                self._flight_failure("shed", reason="queue_full",
                                     qos=qos)
                raise QosShedError(
                    "gateway queue full (%d >= max_pending=%d) and no "
                    "lower class to displace: request shed — back off "
                    "%d tick(s) and resubmit"
                    % (len(self._queue), self._max_pending,
                       self._retry_after()),
                    queue_depth=len(self._queue),
                    limit=self._max_pending,
                    retry_after_ticks=self._retry_after())
            self._shed_queued(victim)
        self._next_rid += 1
        req = _GwRequest(rid, spec, qos, tenant, deadline_ticks,
                         hedge, self._tick)
        self._reqs[rid] = req
        self._queue.append(rid)
        self._emit("gateway.admit", rid, qos=qos,
                   prompt_tokens=int(spec["prompt"].shape[1]),
                   deadline_ticks=deadline_ticks)
        if tenant is not None:
            self._tenant_out[tenant] = self._tenant_out.get(tenant, 0) + 1
        return rid

    def _pick_shed_victim(self, incoming_qos: int) -> Optional[int]:
        """The queued rid QoS overflow displaces: the NEWEST request of
        the LOWEST class strictly below ``incoming_qos``."""
        worst: Optional[int] = None
        for rid in self._queue:
            req = self._reqs[rid]
            if req.qos <= incoming_qos:
                continue
            if worst is None or (req.qos, rid) >= (
                    self._reqs[worst].qos, worst):
                worst = rid
        return worst

    def _shed_queued(self, rid):
        """Displace one queued request (QoS overflow): status ``shed``
        with the structured error recorded for the caller to inspect."""
        self._queue.remove(rid)
        req = self._reqs[rid]
        exc = QosShedError(
            "displaced from the gateway queue by higher-priority "
            "traffic (class %d) — back off %d tick(s) and resubmit"
            % (req.qos, self._retry_after()),
            queue_depth=len(self._queue), limit=self._max_pending,
            retry_after_ticks=self._retry_after())
        self._emit("gateway.shed", rid, reason="displaced", qos=req.qos)
        self._flight_failure("shed", rid=rid, reason="displaced",
                             qos=req.qos)
        self._finish_shed(req, exc)
        self._qos_sheds += 1
        _bump("gateway_sheds")

    def _mark_done(self, req):
        """Bounded terminal bookkeeping: records past ``history``
        completions evict oldest-first (so status()/result() of recent
        requests stay readable without unbounded growth)."""
        self._done.append(req.rid)
        if len(self._done) > self._history:
            for rid in self._done[:-self._history]:
                self._reqs.pop(rid, None)
                self._ttft.pop(rid, None)
            del self._done[:-self._history]

    def _finish_shed(self, req, exc):
        req.status = "shed"
        req.error = {"type": type(exc).__name__, "error": str(exc),
                     "tick": self._tick, "exception": exc}
        self._release_tenant(req)
        self._mark_done(req)

    def _release_tenant(self, req):
        if req.tenant is not None and req.tenant in self._tenant_out:
            self._tenant_out[req.tenant] -= 1
            if self._tenant_out[req.tenant] <= 0:
                del self._tenant_out[req.tenant]

    # -- dispatch --------------------------------------------------------
    def _dispatch_queued(self) -> List[int]:
        """Route queued requests in (class, arrival) order while the
        pool has room.  A permanent engine shed maps to
        EngineShedError; a transient one leaves the request queued.
        Returns the rids that went terminal at dispatch (sheds,
        engine-rejected requests) so pump() reports them done."""
        ended: List[int] = []
        if not self._queue:
            return ended
        for rid in sorted(self._queue,
                          key=lambda r: (self._reqs[r].qos, r)):
            req = self._reqs[rid]
            try:
                replica = self._router.dispatch(
                    req.spec, (rid, req.next_gen))
            except LoadShedError as exc:
                if getattr(exc, "permanent", False):
                    self._queue.remove(rid)
                    mapped = EngineShedError(
                        str(exc), queue_depth=exc.queue_depth,
                        limit=exc.limit, retry_after_ticks=None,
                        permanent=True)
                    self._emit("gateway.shed", rid,
                               reason="engine_permanent")
                    self._flight_failure("shed", rid=rid,
                                         reason="engine_permanent")
                    self._finish_shed(req, mapped)
                    self._engine_sheds += 1
                    _bump("gateway_sheds")
                    ended.append(rid)
                continue
            except ReplicaDownError:
                break       # pool-wide outage: nothing routable now
            except Exception as exc:  # noqa: BLE001 — a request the
                # engines REJECT (e.g. longer than a slot) must fail
                # alone, never poison the pump for its neighbors
                self._queue.remove(rid)
                req.status = "failed"
                req.error = {"type": type(exc).__name__,
                             "error": str(exc), "tick": self._tick,
                             "site": "router.dispatch",
                             "exception": exc}
                self._emit("gateway.finish", rid, status="failed",
                           error=type(exc).__name__)
                self._release_tenant(req)
                self._mark_done(req)
                ended.append(rid)
                continue
            if replica is None:
                break       # no capacity anywhere this tick
            self._emit("gateway.dispatch", rid, gen=req.next_gen,
                       replica=replica,
                       wait_ticks=self._tick - req.submitted_tick)
            req.gens[req.next_gen] = replica
            req.buffers[req.next_gen] = []
            req.next_gen += 1
            req.status = "dispatched"
            self._queue.remove(rid)
        return ended

    # -- one service iteration -------------------------------------------
    def pump(self) -> List[int]:
        """One gateway iteration: dispatch queued work, tick the
        supervised pool (health → step → poll per replica), ingest
        token/finish events, requeue drained tags, then run the hedge
        and deadline sweeps.  Returns the rids that went terminal this
        pump.  With tracing active the iteration runs inside a
        ``gateway.pump`` span."""
        tr = _tracer()
        if not tr.active:
            return self._pump_impl()
        with tr.span("gateway.pump", tick=self._tick + 1):
            return self._pump_impl()

    def _pump_impl(self) -> List[int]:
        self._tick += 1
        done: List[int] = []
        done.extend(self._dispatch_queued())
        tokens, finished, requeue, restarted = self._sup.tick()
        for (rid, gen) in restarted:
            # an engine-level retry restarted the request from scratch:
            # its streamed tokens are void; the stream resets in place
            req = self._reqs.get(rid)
            if req is not None and not req.terminal and gen in req.gens:
                req.buffers[gen] = []
                req.resets += 1
        for (rid, gen), new in tokens.items():
            req = self._reqs.get(rid)
            if req is None or req.terminal or gen not in req.gens:
                continue
            if not req.buffers[gen] and rid not in self._ttft:
                self._ttft[rid] = self._tick - req.submitted_tick
            req.buffers[gen].extend(new)
        for (rid, gen), status, result, eng_err in finished:
            req = self._reqs.get(rid)
            if req is None or gen not in req.gens:
                continue
            if req.terminal:
                req.gens.pop(gen, None)
                continue
            req.gens.pop(gen)
            if status == "ok":
                self._resolve(req, result, winner_gen=gen)
                done.append(rid)
            elif req.gens:
                # an engine-level failure of one dispatch while a hedge
                # twin still runs: drop this dispatch, let the twin win
                req.buffers.pop(gen, None)
            else:
                req.status = "failed"
                req.winner_gen = gen
                req.result = result
                if eng_err is not None:
                    req.error = dict(eng_err)
                self._emit("gateway.finish", rid, status="failed",
                           gen=gen)
                self._release_tenant(req)
                self._mark_done(req)
                done.append(rid)
        for (rid, gen) in requeue:
            req = self._reqs.get(rid)
            if req is None or req.terminal:
                continue
            req.gens.pop(gen, None)
            req.buffers.pop(gen, None)
            if req.gens:
                continue    # a live twin survives the death
            req.resets += 1
            req.requeues += 1
            self._requeued += 1
            _bump("gateway_requeues")
            # the stream-reset event: everything streamed on the lost
            # dispatch is void; the re-dispatch restarts from the seed
            self._emit("gateway.requeue", rid, gen=gen,
                       resets=req.resets)
            req.status = "queued"
            self._queue.append(rid)
        self._hedge_sweep()
        done.extend(self._deadline_sweep())
        return done

    def _resolve(self, req, result, winner_gen):
        req.status = "ok"
        req.result = result
        req.winner_gen = winner_gen
        self._emit("gateway.finish", req.rid, status="ok",
                   gen=winner_gen,
                   ticks=self._tick - req.submitted_tick)
        self._release_tenant(req)
        self._mark_done(req)
        # retire hedge losers through the engines' idempotent release
        for gen, rep_id in list(req.gens.items()):
            try:
                self._sup.replica(rep_id).cancel((req.rid, gen))
            except KeyError:
                pass
            req.gens.pop(gen, None)
            req.buffers.pop(gen, None)

    def _hedge_sweep(self):
        if self._hedge_fraction is None:
            return
        for req in list(self._reqs.values()):
            if (req.terminal or req.hedged or req.hedge is False
                    or req.deadline_ticks is None
                    or len(req.gens) != 1):
                continue
            waited = self._tick - req.submitted_tick
            if waited < max(1, int(self._hedge_fraction
                                   * req.deadline_ticks)):
                continue
            exclude = list(req.gens.values())
            try:
                replica = self._router.dispatch(
                    req.spec, (req.rid, req.next_gen), exclude=exclude)
            except (LoadShedError, ReplicaDownError):
                continue    # no spare capacity: skip, retry next pump
            if replica is None:
                continue
            self._emit("gateway.hedge", req.rid, gen=req.next_gen,
                       replica=replica)
            req.gens[req.next_gen] = replica
            req.buffers[req.next_gen] = []
            req.next_gen += 1
            req.hedged = True
            self._hedges += 1
            _bump("gateway_hedges")

    def _deadline_sweep(self) -> List[int]:
        done = []
        for req in list(self._reqs.values()):  # _mark_done may evict
            if req.terminal or req.deadline_ticks is None:
                continue
            if self._tick - req.submitted_tick < req.deadline_ticks:
                continue
            for gen, rep_id in list(req.gens.items()):
                try:
                    self._sup.replica(rep_id).cancel((req.rid, gen))
                except KeyError:
                    pass
            req.winner_gen = req.head_gen   # the stream the client saw
            req.gens.clear()
            if req.rid in self._queue:
                self._queue.remove(req.rid)
            req.status = "expired"
            req.result = self._partial_result(req)
            self._emit("gateway.expired", req.rid,
                       deadline_ticks=req.deadline_ticks)
            self._release_tenant(req)
            self._mark_done(req)
            done.append(req.rid)
        return done

    def _partial_result(self, req) -> torch.Tensor:
        toks = req.buffers.get(req.winner_gen, []) \
            if req.winner_gen is not None else []
        out = onp.concatenate(
            [req.spec["prompt"],
             onp.asarray([toks], dtype=onp.int32).reshape(1, -1)],
            axis=1)
        return torch.from_numpy(out.astype(onp.int32))

    # -- results / streaming ---------------------------------------------
    def result(self, rid) -> torch.Tensor:
        """The final (1, T_prompt + generated) output of a terminal
        request; raises the stored typed error for shed requests and
        MXTPUError for non-terminal ones."""
        req = self._reqs[rid]
        if req.status == "shed":
            raise req.error["exception"]
        if not req.terminal:
            raise MXTPUError("request %r is %s — pump()/run() first"
                             % (rid, req.status))
        return req.result

    def take_result(self, rid) -> torch.Tensor:
        res = self.result(rid)
        del self._reqs[rid]
        return res

    def stream(self, rid):
        """Generator of stream events for one request, driving the
        gateway as needed: ``("tokens", [ids...])`` as tokens decode
        and ``("reset",)`` whenever the serving dispatch changed
        (replica death requeue, hedge winner) — everything after the
        LAST reset is the complete, bit-exact stream.  Terminates when
        the request does; shed requests raise their typed error."""
        req = self._reqs[rid]
        sent, head = 0, None
        # the guard budgets ALL live work, not just this request — a
        # stream opened behind a deep queue legitimately waits for
        # everything ahead of it; work submitted mid-stream extends
        # the budget additively (each request's share counted once)
        counted: set = set()

        def _budget(prev):
            new = [r for r in self._reqs.values()
                   if not r.terminal and r.rid not in counted]
            counted.update(r.rid for r in new)
            return prev + (self._run_limit(new) if new else 0)

        guard, limit = 0, _budget(0)
        while True:
            if req.status == "shed":
                raise req.error["exception"]
            g = req.winner_gen if req.terminal else req.head_gen
            if g is not None and g != head:
                if head is not None:
                    yield ("reset",)
                head, sent = g, 0
            buf = req.buffers.get(head, ()) if head is not None else ()
            if head is not None and head in req.buffers and \
                    sent > len(buf):
                # same LIVE dispatch, emptier buffer: an engine-level
                # retry restarted the request in place — reset the
                # stream.  (A popped buffer means a pending requeue:
                # the head-change branch above emits THAT reset once
                # the new dispatch exists.)
                yield ("reset",)
                sent = 0
            if sent < len(buf):
                yield ("tokens", list(buf[sent:]))
                sent = len(buf)
            if req.terminal:
                return
            self._sup.require_alive()
            self.pump()
            guard += 1
            limit = _budget(limit)
            if guard > limit:
                raise RuntimeError(
                    "gateway stream failed to converge — service bug "
                    "(request %r status %s)" % (rid, req.status))

    # -- drain -----------------------------------------------------------
    def _run_limit(self, reqs) -> int:
        out = 0
        for r in reqs:
            chunks = -(-r.spec["prompt"].shape[1] // 8)
            retries = 1 + int(r.spec.get("retries", 0) or 0)
            out += retries * (r.spec["max_new_tokens"] + chunks + 4)
        # requeues/hedges re-run work: one full extra pass per replica
        # plus slack for deferrals and health-check-only ticks
        return 4 * out * (1 + len(self._sup.replicas)) + 64

    def run(self) -> Dict[int, torch.Tensor]:
        """Pump until every submitted request is terminal; returns
        {rid -> final output} for everything that produced one (sheds
        excluded — their typed error stays readable via
        :meth:`error`)."""
        live = [r for r in self._reqs.values() if not r.terminal]
        guard, limit = 0, self._run_limit(live)
        while any(not r.terminal for r in self._reqs.values()):
            self._sup.require_alive()
            self.pump()
            guard += 1
            if guard > limit:
                raise RuntimeError(
                    "gateway run() failed to converge — service bug "
                    "(queued=%d outstanding=%d)"
                    % (len(self._queue),
                       sum(1 for r in self._reqs.values()
                           if not r.terminal)))
        out = {}
        for rid, req in list(self._reqs.items()):
            if req.result is not None:
                out[rid] = req.result
        return out
