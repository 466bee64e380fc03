"""ReplicaSupervisor: owns the replica pool and decides who is dead (the
port of ``mxtpu/serving/supervisor.py``).

Health is judged on COUNTERS, never clocks (every declared death replays
bit-for-bit under a fault plan):

- **probe failures**: each supervisor tick health-checks every alive
  replica (``replica.health`` fault site, keyed by replica id) and
  counts CONSECUTIVE failures — transient blips below
  ``fail_threshold`` never kill a replica, and any clean probe resets
  the count.  Exceptions escaping the replica's ``step()``/``poll()``
  (``replica.stream``) count toward the same consecutive tally: a
  replica that can't decode or stream is as dead as one that can't
  answer a probe.
- **stall detection**: a replica holding work whose
  :meth:`~mxtpu_torch.serving.transport.ReplicaTransport.progress` tuple has
  not changed for ``stall_ticks`` consecutive ticks is declared dead —
  the deltas-of-``stats()`` form of a hung process (chunked prefill
  advances the tuple every iteration, so long prompts never look like
  stalls).
- **transport vs stall**: with remote replicas the progress tuple
  itself arrives by RPC, and the two failure modes must never blur — a
  poll/progress RPC that times out or hits a dead pipe is a TRANSPORT
  failure (counted toward the consecutive-failure death, surfaced per
  replica in ``stats()["transport_failures"]``, death reason
  "transport ..."), while the stall counter only ever advances on a
  progress tuple that was successfully READ and did not change.  A
  slow-but-alive worker mid chunked prefill whose poll timed out once
  can therefore never look stalled.

Death runs **drain-and-requeue**: the dead replica cancels every held
request through the engine's idempotent release path (zero pages may
survive on a dead replica — asserted in tests), drops both cache tiers,
and hands the request TAGS back; the gateway requeues each spec from
its seed, so every affected stream completes bit-identical to a
fault-free run.  ``revive_after_ticks`` optionally re-admits a drained
replica after a probation period (deterministic, tick-counted) — the
supervised-pool form of replica replacement.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from ..base import MXTPUError
from ..observability.flight import get_flight as _flight
from ..observability.trace import gateway_rid, get_tracer as _tracer
from ..resilience import TransportError
from ..resilience.counters import bump as _bump
from .transport import ReplicaTransport

__all__ = ["ReplicaSupervisor"]


class ReplicaSupervisor:
    """Supervise N replica transports (module docstring).

    Parameters
    ----------
    replicas : list of ReplicaTransport (ids must be unique).
    fail_threshold : consecutive health/step/stream failures that
        declare a replica dead (>= 1).
    stall_ticks : ticks without progress (while holding work) that
        declare a stall (>= 2; 0/None disables stall detection).
    revive_after_ticks : re-admit a dead replica this many ticks after
        its death (None = never; its engine was drained clean, so
        revival is sound — it simply rejoins empty).
    on_death : callback ``(replica, tags, reason)`` fired after the
        drain; the gateway requeues the tags.
    """

    def __init__(self, replicas: List[ReplicaTransport],
                 fail_threshold: int = 3,
                 stall_ticks: Optional[int] = 25,
                 revive_after_ticks: Optional[int] = None,
                 on_death: Optional[Callable] = None):
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate replica ids: %r" % (ids,))
        if not replicas:
            raise ValueError("ReplicaSupervisor needs >= 1 replica")
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1, got %d"
                             % fail_threshold)
        if stall_ticks is not None and stall_ticks and stall_ticks < 2:
            raise ValueError("stall_ticks must be >= 2 (one tick of "
                             "equal progress is normal), got %d"
                             % stall_ticks)
        self._replicas = list(replicas)
        self._fail_threshold = int(fail_threshold)
        self._stall_ticks = int(stall_ticks or 0)
        self._revive_after = (None if revive_after_ticks is None
                              else int(revive_after_ticks))
        self._on_death = on_death
        self.tick_count = 0
        self._consec: Dict[str, int] = {r.replica_id: 0 for r in replicas}
        self._last_progress: Dict[str, tuple] = {}
        self._stalled_for: Dict[str, int] = {}
        self._death_tick: Dict[str, int] = {}
        self._deaths = 0
        self._revivals = 0
        self._requeued = 0
        self._last_errors: Dict[str, dict] = {}
        # cumulative per-replica TRANSPORT failures (RPC timeouts, dead
        # pipes) — split from stall counting, see module docstring
        self._transport_failures: Dict[str, int] = {
            r.replica_id: 0 for r in replicas}

    # -- introspection ---------------------------------------------------
    @property
    def replicas(self) -> List[ReplicaTransport]:
        return list(self._replicas)

    @property
    def alive(self) -> List[ReplicaTransport]:
        return [r for r in self._replicas if r.alive]

    def replica(self, replica_id: str) -> ReplicaTransport:
        for r in self._replicas:
            if r.replica_id == replica_id:
                return r
        raise KeyError(replica_id)

    # -- elastic pool membership (the autoscaler's grow and retire) -------
    def add_replica(self, rep: ReplicaTransport) -> None:
        """Admit one freshly spawned replica into the pool (the
        autoscaler's scale-up path).  It joins with clean failure
        counters and becomes routable on the next tick."""
        if any(r.replica_id == rep.replica_id for r in self._replicas):
            raise ValueError("duplicate replica id %r"
                             % (rep.replica_id,))
        self._replicas.append(rep)
        self._consec[rep.replica_id] = 0
        self._transport_failures[rep.replica_id] = 0

    def remove_replica(self, replica_id: str) -> ReplicaTransport:
        """Drop one replica from the pool and forget its supervision
        state (the autoscaler's retire release step — the replica must
        already be drained; the caller owns process teardown for
        subprocess transports).  The pool never shrinks below one."""
        rep = self.replica(replica_id)
        if len(self._replicas) <= 1:
            raise ValueError(
                "cannot remove the last replica from the pool")
        self._replicas.remove(rep)
        for d in (self._consec, self._transport_failures,
                  self._last_progress, self._stalled_for,
                  self._death_tick, self._last_errors):
            d.pop(replica_id, None)
        return rep

    @property
    def stats(self) -> dict:
        return {
            "ticks": self.tick_count,
            "replicas": len(self._replicas),
            "alive": len(self.alive),
            "deaths": self._deaths,
            "revivals": self._revivals,
            "requeued_requests": self._requeued,
            "consecutive_failures": dict(self._consec),
            "transport_failures": dict(self._transport_failures),
            "last_errors": dict(self._last_errors),
        }

    # -- death / revival -------------------------------------------------
    def _declare_dead(self, rep: ReplicaTransport, reason: str,
                      exc: Optional[BaseException]) -> List[Any]:
        rep.alive = False
        self._deaths += 1
        self._death_tick[rep.replica_id] = self.tick_count
        self._last_errors[rep.replica_id] = {
            "reason": reason,
            "type": type(exc).__name__ if exc is not None else None,
            "error": str(exc) if exc is not None else None,
            "tick": self.tick_count,
        }
        _bump("replica_deaths")
        try:
            tags = rep.drain()
        except Exception as drain_exc:  # noqa: BLE001 — a dead
            # replica failing its own drain must not take the pool
            # down; whatever tags it could not report are lost to
            # THAT replica only (recorded for the operator)
            tags = []
            self._last_errors[rep.replica_id]["drain_error"] = \
                "%s: %s" % (type(drain_exc).__name__, drain_exc)
        self._requeued += len(tags)
        tr = _tracer()
        if tr.active:
            tr.emit("replica.death", replica=rep.replica_id,
                    reason=reason,
                    error=(type(exc).__name__ if exc is not None
                           else None),
                    tick=self.tick_count, requeued=len(tags))
        fl = _flight()
        if fl.active:
            # the postmortem names the dead replica and every drained
            # request; their timelines (read-time materialized) carry
            # the requeue/re-dispatch events that follow.  For a
            # subprocess replica it also names the drained TAGS and
            # exit code (deterministic: -9 under a planned kill), and
            # the worker pid under the noise channel so reruns stay
            # byte-identical
            ctx = {"replica": rep.replica_id, "reason": reason,
                   "tick": self.tick_count,
                   "error": (type(exc).__name__ if exc is not None
                             else None),
                   "drained_tags": [list(t) if isinstance(t, tuple)
                                    else t for t in tags]}
            code = getattr(rep, "exit_code", None)
            if code is not None:
                ctx["exit_code"] = code
            pid = getattr(rep, "pid", None)
            fl.failure("replica_death",
                       rids=[gateway_rid(t) for t in tags],
                       noise=({"pid": pid} if pid is not None
                              else None),
                       **ctx)
        if self._on_death is not None:
            self._on_death(rep, tags, reason)
        return tags

    def revive(self, replica_id: str) -> None:
        """Re-admit one drained replica (probation over, or an operator
        decision in tests/tools): failure counters reset, the replica
        rejoins empty and routable.

        A transport whose worker PROCESS is dead (a killed
        :class:`~mxtpu_torch.serving.transport.SubprocessReplica`) is
        respawned first — fresh pipe, fresh handshake, factory re-run
        worker-side — because flipping ``alive`` on a corpse would
        re-admit a replica that fails every probe and immediately
        re-dies.  Duck-typed on ``respawn``/``worker_dead`` so stub
        transports in tests opt in by providing them; a respawn that
        raises leaves the replica dead (probation keeps retrying on
        later ticks)."""
        rep = self.replica(replica_id)
        if rep.alive:
            return
        if (hasattr(rep, "respawn")
                and getattr(rep, "worker_dead", False)):
            rep.respawn()           # a raise keeps the replica dead
        rep.alive = True
        self._consec[replica_id] = 0
        self._stalled_for.pop(replica_id, None)
        self._last_progress.pop(replica_id, None)
        self._death_tick.pop(replica_id, None)
        self._revivals += 1
        tr = _tracer()
        if tr.active:
            tr.emit("replica.revive", replica=replica_id,
                    tick=self.tick_count)

    def _fail(self, rep: ReplicaTransport, reason: str,
              exc: BaseException) -> Optional[List[Any]]:
        """Count one replica-level failure; returns drained tags when
        this failure crossed the death threshold."""
        self._consec[rep.replica_id] += 1
        self._last_errors[rep.replica_id] = {
            "reason": reason, "type": type(exc).__name__,
            "error": str(exc), "tick": self.tick_count,
        }
        if self._consec[rep.replica_id] >= self._fail_threshold:
            return self._declare_dead(rep, reason, exc)
        return None

    # -- one supervision round -------------------------------------------
    def tick(self) -> Tuple[Dict[Any, List[int]],
                            List[Tuple[Any, str, Any]],
                            List[Any], List[Any]]:
        """One round over the pool, in replica order: revive probation
        expiries, then per alive replica health-check → step → poll.
        Returns ``(tokens, finished, requeue_tags, restarted_tags)``
        aggregated over the pool — ``requeue_tags`` lists every
        request drained off replicas that died THIS tick,
        ``restarted_tags`` every request an ENGINE restarted in place
        (its streamed tokens are void — see ``ReplicaTransport.poll``)."""
        self.tick_count += 1
        if self._revive_after is not None:
            for r in self._replicas:
                t0 = self._death_tick.get(r.replica_id)
                if (not r.alive and t0 is not None
                        and self.tick_count - t0 >= self._revive_after):
                    try:
                        self.revive(r.replica_id)
                    except Exception as exc:  # noqa: BLE001 — a failed
                        # respawn keeps the replica dead; its death
                        # tick stands, so probation retries next tick
                        self._last_errors[r.replica_id] = {
                            "reason": "revive/respawn failed",
                            "type": type(exc).__name__,
                            "error": str(exc),
                            "tick": self.tick_count,
                        }
        tokens: Dict[Any, List[int]] = {}
        finished: List[Tuple[Any, str, Any]] = []
        requeue: List[Any] = []
        restarted: List[Any] = []
        for rep in self._replicas:
            if not rep.alive:
                continue
            try:
                rep.health()
                rep.step()
                polled = rep.poll()
            except Exception as exc:  # noqa: BLE001 — a replica-level
                # failure must never take the pool down; it is counted
                # toward THIS replica's death and contained there
                if isinstance(exc, TransportError):
                    self._transport_failures[rep.replica_id] += 1
                    reason = ("transport failure (%s)"
                              % type(exc).__name__)
                else:
                    reason = "probe/step/stream failure"
                dead = self._fail(rep, reason, exc)
                if dead:
                    requeue.extend(dead)
                continue
            toks, fins = polled[0], polled[1]
            restarted.extend(polled[2] if len(polled) > 2 else [])
            stall_tags, clean = self._check_stall(rep)
            if clean:
                # only a fully clean round (probe + step + poll + a
                # READABLE progress tuple) resets the consecutive count
                # — a tick whose progress RPC failed was not clean
                self._consec[rep.replica_id] = 0
            for tag, new in toks.items():
                tokens.setdefault(tag, []).extend(new)
            finished.extend(fins)
            if stall_tags:
                requeue.extend(stall_tags)
        return tokens, finished, requeue, restarted

    def _check_stall(self, rep: ReplicaTransport
                     ) -> Tuple[Optional[List[Any]], bool]:
        """Stall check for one replica; returns ``(drained_tags,
        clean)`` — ``drained_tags`` when this check declared a death
        (stalled, or the transport-failure threshold crossed),
        ``clean`` False when the progress read itself failed (a
        TRANSPORT failure: the stall counter must not move — a worker
        whose poll timed out has not been observed to stop decoding)."""
        if not self._stall_ticks:
            return None, True
        rid = rep.replica_id
        if rep.load == 0:
            self._stalled_for.pop(rid, None)
            self._last_progress.pop(rid, None)
            return None, True
        try:
            prog = rep.progress()
        except Exception as exc:  # noqa: BLE001 — an unanswerable
            # progress poll is a transport failure, NEVER a stall
            self._transport_failures[rid] += 1
            return self._fail(
                rep, "transport failure (progress poll: %s)"
                % type(exc).__name__, exc), False
        if prog != self._last_progress.get(rid):
            self._last_progress[rid] = prog
            self._stalled_for[rid] = 0
            return None, True
        self._stalled_for[rid] = self._stalled_for.get(rid, 0) + 1
        if self._stalled_for[rid] >= self._stall_ticks:
            return self._declare_dead(
                rep, "stalled (no progress for %d ticks with %d "
                "request(s) held)" % (self._stalled_for[rid], rep.load),
                None), True
        return None, True

    def require_alive(self) -> None:
        """Raise when the whole pool is down (the gateway's run() guard
        turns an undrainable queue into a typed error instead of a
        hang)."""
        if not self.alive:
            raise MXTPUError(
                "all %d replica(s) are down (deaths=%d) — the pool "
                "cannot make progress; revive a replica or rebuild the "
                "pool" % (len(self._replicas), self._deaths))
