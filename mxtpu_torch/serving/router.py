"""Prefix-locality router: place each request on the replica that
already holds the most of its prompt (the port of
``mxtpu/serving/router.py``).

At serving scale the KV cache IS the capacity, and a prompt prefix the
target replica has cached (radix index, pinned tier, or host tier —
``prefix_probe`` reads all three) is prefill work nobody pays twice.
The score blends that exact, cheap host-side signal with load:

    score(replica) = prefix_hit_tokens - load_weight * held_requests

``load_weight`` is measured in tokens-per-queued-request: the default
(8) means one queued request outweighs 8 cached prompt tokens, so
locality wins between comparably busy replicas and a hot replica still
sheds onto a cold one (the classic locality/balance blend; ties break
on the lowest replica index, deterministically).  ``policy=
"round_robin"`` ignores both signals — the bench's control arm.

Dispatch rides :class:`~mxtpu_torch.resilience.RetryPolicy` with the typed
:class:`~mxtpu_torch.serving.transport.ReplicaDownError`: a replica that
refuses (declared dead between selection and submit, or the
``router.dispatch`` fault site) is EXCLUDED and the retry picks the
next-best replica — the reroute path, deterministic under the policy's
injectable clock/sleep.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set

from ..observability.trace import gateway_rid, get_tracer as _tracer
from ..resilience import RetryPolicy
from ..resilience.faults import inject as _inject
from .supervisor import ReplicaSupervisor
from .transport import ReplicaDownError, ReplicaTransport

__all__ = ["Router"]


class Router:
    """Score-and-dispatch over a supervised pool (module docstring).

    Parameters
    ----------
    supervisor : the pool (only ALIVE replicas are routable).
    load_weight : queued-request penalty in prompt-token units (>= 0).
    policy : ``"locality"`` (default) or ``"round_robin"``.
    backlog : max requests a replica may hold QUEUED beyond its active
        slots before the router stops offering it work (default 1 —
        one admission-ready request per replica keeps iteration
        boundaries busy without deep per-replica queues that defeat
        the gateway's QoS ordering).
    retry : RetryPolicy for the reroute path (default: 1 + #replicas
        attempts, zero backoff — rerouting an in-process pool costs
        nothing to try immediately; pass a policy with a real schedule
        for remote transports).
    """

    def __init__(self, supervisor: ReplicaSupervisor,
                 load_weight: float = 8.0, policy: str = "locality",
                 backlog: int = 1,
                 retry: Optional[RetryPolicy] = None):
        if policy not in ("locality", "round_robin"):
            raise ValueError("policy must be 'locality' or "
                             "'round_robin', got %r" % (policy,))
        if load_weight < 0:
            raise ValueError("load_weight must be >= 0")
        self._sup = supervisor
        self._load_weight = float(load_weight)
        self._policy = policy
        self._backlog = int(backlog)
        self._retry = retry if retry is not None else RetryPolicy(
            max_attempts=1 + len(supervisor.replicas), base_delay=0.0,
            max_delay=0.0, retry_on=(ReplicaDownError,),
            sleep=lambda s: None)
        self._rr_next = 0
        # -- counters (the bench's evidence) ------------------------------
        self._dispatches = 0
        self._locality_hits = 0
        self._locality_tokens = 0
        self._reroutes = 0

    @property
    def stats(self) -> dict:
        return {
            "dispatches": self._dispatches,
            "locality_hits": self._locality_hits,
            "locality_tokens": self._locality_tokens,
            "reroutes": self._reroutes,
            "policy": self._policy,
            "prefix_hit_rate": (self._locality_hits / self._dispatches
                                if self._dispatches else 0.0),
        }

    # -- selection -------------------------------------------------------
    def _routable(self, exclude: Set[str]) -> List[ReplicaTransport]:
        # retiring replicas (autoscaler graceful scale-down) keep
        # decoding their in-flight streams but take no new work
        return [r for r in self._sup.alive
                if r.replica_id not in exclude
                and not getattr(r, "retiring", False)]

    def has_capacity(self, exclude: Sequence[str] = ()) -> bool:
        return any(self._has_room(r) for r in self._routable(set(exclude)))

    def _has_room(self, rep: ReplicaTransport) -> bool:
        return (rep.free_slots > 0
                or rep.load - rep.capacity < self._backlog)

    def select(self, prompt, exclude: Sequence[str] = (),
               require_capacity: bool = True
               ) -> Optional[ReplicaTransport]:
        """Best replica for this prompt, or None when every routable
        replica is at capacity (the caller leaves the request queued).
        Raises :class:`ReplicaDownError` when NO replica is routable at
        all — the typed signal the retry/reroute path consumes."""
        pick = self._pick(prompt, exclude, require_capacity)
        return pick[0] if pick is not None else None

    def _pick(self, prompt, exclude, require_capacity):
        """(replica, prefix_hit_tokens) of the winner, probing each
        candidate exactly once (the probe result feeds both the score
        and the dispatch hit counters — never probed twice)."""
        cands = self._routable(set(exclude))
        if not cands:
            raise ReplicaDownError(
                "no alive replica to route to (%d excluded, %d total)"
                % (len(set(exclude)), len(self._sup.replicas)))
        if require_capacity:
            cands = [r for r in cands if self._has_room(r)]
            if not cands:
                return None
        if self._policy == "round_robin":
            # cands keep the supervisor's replica order
            pick = cands[self._rr_next % len(cands)]
            self._rr_next += 1
            return pick, pick.prefix_probe(prompt)
        best, best_hit, best_score = None, 0, None
        for r in cands:
            hit = r.prefix_probe(prompt)
            score = hit - self._load_weight * r.load
            if best_score is None or score > best_score:
                best, best_hit, best_score = r, hit, score
        return best, best_hit

    # -- dispatch --------------------------------------------------------
    def dispatch(self, spec: dict, tag,
                 exclude: Sequence[str] = ()) -> Optional[str]:
        """Route one spec: select, fire the ``router.dispatch`` site
        (keyed by tag), submit.  A :class:`ReplicaDownError` from the
        site or the submit EXCLUDES that replica and rides the
        RetryPolicy onto the next-best one (``reroutes`` counts the
        extra attempts).  Returns the replica id that accepted, or
        None when no routable replica has capacity right now."""
        tried: Set[str] = set(exclude)
        state = {"first": True}

        def _attempt():
            if not state["first"]:
                self._reroutes += 1
            state["first"] = False
            pick = self._pick(spec["prompt"], tried, True)
            if pick is None:
                return None
            rep, hit_tokens = pick
            try:
                # keyed by the gateway REQUEST id (the docs' contract)
                # — the gateway's tag is (rid, dispatch_gen)
                _inject("router.dispatch",
                        key=tag[0] if isinstance(tag, tuple) else tag)
                rep.submit(spec, tag)
            except ReplicaDownError:
                tried.add(rep.replica_id)
                raise
            self._dispatches += 1
            tr = _tracer()
            if tr.active:
                # the placement decision, with its locality evidence:
                # score = prefix_hit_tokens - load_weight * held
                tr.emit("router.dispatch", rid=gateway_rid(tag),
                        replica=rep.replica_id,
                        prefix_hit_tokens=int(hit_tokens),
                        load=int(rep.load), policy=self._policy)
            if hit_tokens > 0:
                self._locality_hits += 1
                self._locality_tokens += hit_tokens
            return rep.replica_id

        return self._retry.call(_attempt)
