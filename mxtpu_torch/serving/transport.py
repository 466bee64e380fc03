"""Replica transports: the seam between the service layer and one
engine replica (the port of ``mxtpu/serving/transport.py``).

The supervisor/router/gateway above never touch an engine directly —
they speak :class:`ReplicaTransport`, a small imperative protocol
(submit / step / poll / health / cancel / drain / prefix_probe).  Two
implementations: :class:`InProcessReplica` adapts one
``ContinuousBatchingEngine`` / ``PagedContinuousBatchingEngine``
instance in this process, and :class:`SubprocessReplica` hosts the
engine in a SPAWNED worker process over a length-prefixed pipe RPC
(``mxtpu_torch.serving.worker``; replica death there is a real
``SIGKILL``).  The protocol is the seam where another transport slots in
without the service layer changing — everything a remote transport
needs is already host-side data (token ids, specs, counters), never
device tensors.

Determinism: a transport call never consults a clock or randomness.
``poll()`` materializes newly decoded tokens in slot order, ``drain()``
returns tags in submission order, and the two fault sites
(``replica.health`` keyed by replica id in :meth:`health`,
``replica.stream`` keyed by replica id in :meth:`poll`) are
counter-driven like every site in ``mxtpu_torch.resilience.faults`` —
a replica death replays bit-for-bit.

Host reads: :meth:`InProcessReplica.poll` copies the pooled (B,) token
vectors its slots emitted since the last poll to the host in ONE copy a
poll (every distinct vector once, shared by every slot that holds it),
not one device read per token per request.
"""

from __future__ import annotations

import builtins
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as onp
import torch

from ..base import MXTPUError
from ..observability.trace import gateway_rid, get_tracer as _tracer
from ..parallel.serving import _SpecTokens
from ..resilience import (EngineShedError, LoadShedError, QosShedError,
                          TransportError, TransportTimeoutError,
                          WorkerDiedError)
from ..resilience.faults import InjectedFault, inject as _inject
from .worker import (decode_poll, make_codec, read_frame as _read_frame,
                     write_frame as _write_frame)

__all__ = ["ReplicaDownError", "ReplicaTransport", "InProcessReplica",
           "SubprocessReplica", "request_spec"]

#: engine-submit keyword names a request spec may carry (the seed is
#: part of the spec, which is what makes a drained request's requeue
#: restart bit-identically on another replica)
SPEC_KEYS = ("max_new_tokens", "temperature", "top_k", "top_p",
             "repetition_penalty", "seed", "eos_id", "retries",
             "speculative")


def request_spec(prompt_ids, max_new_tokens, **kw) -> dict:
    """Normalize one request into the host-side spec the service layer
    re-dispatches from: the prompt (a tensor or an array) as (1, Tp)
    int32 numpy plus the engine-submit sampling/seed knobs.  A spec is
    pure host data — the unit of drain-and-requeue and of hedged
    duplication."""
    arr = _host(prompt_ids)
    if arr.ndim != 2 or arr.shape[0] != 1:
        raise ValueError(
            "request spec takes ONE prompt: (1, T_prompt), got %r"
            % (arr.shape,))
    bad = sorted(set(kw) - set(SPEC_KEYS))
    if bad:
        raise ValueError("unknown request-spec key(s) %r (valid: %r)"
                         % (bad, SPEC_KEYS))
    spec = {"prompt": onp.asarray(arr, dtype=onp.int32),
            "max_new_tokens": int(max_new_tokens)}
    spec.update(kw)
    return spec


def _host(ids) -> onp.ndarray:
    """Token ids (a tensor on any device, or an array) as numpy."""
    if torch.is_tensor(ids):
        return ids.detach().cpu().numpy()
    return onp.asarray(ids)


class ReplicaDownError(MXTPUError):
    """A dispatch/submit reached a replica that is not accepting work
    (declared dead by the supervisor, or no alive replica exists).
    Typed so the router's reroute path can retry OTHER replicas under a
    ``RetryPolicy(retry_on=(ReplicaDownError,))`` while every other
    exception propagates."""


class ReplicaTransport:
    """Protocol one replica speaks (module docstring).  Subclasses
    implement everything; the base class only documents the contract
    and provides the shared ``alive`` flag the supervisor flips."""

    #: stable identifier ("r0", "r1", ... for pool-built replicas);
    #: fault-plan keys and router labels use it
    replica_id: str = "r?"
    #: flipped False by the supervisor on declared death; transports
    #: refuse new work while down
    alive: bool = True
    #: flipped True by the autoscaler's graceful scale-down: a retiring replica refuses
    #: NEW admissions but keeps decoding its in-flight streams to
    #: completion — the opposite of the death path, which drains and
    #: requeues.  The router skips retiring replicas at dispatch.
    retiring: bool = False

    # -- capacity / placement signals ------------------------------------
    @property
    def capacity(self) -> int:
        """Concurrent request slots this replica can decode."""
        raise NotImplementedError

    @property
    def load(self) -> int:
        """Requests currently held (active + queued)."""
        raise NotImplementedError

    @property
    def free_slots(self) -> int:
        raise NotImplementedError

    def prefix_probe(self, prompt) -> int:
        """Prompt tokens this replica's caches would skip prefilling
        (read-only; the router's locality signal)."""
        raise NotImplementedError

    # -- work ------------------------------------------------------------
    def submit(self, spec: dict, tag) -> Any:
        """Queue one request spec under an opaque ``tag`` (the
        gateway's request id); raises :class:`ReplicaDownError` when
        not alive."""
        raise NotImplementedError

    def step(self) -> None:
        """Advance the replica one scheduler iteration."""
        raise NotImplementedError

    def poll(self) -> Tuple[Dict[Any, List[int]],
                            List[Tuple[Any, str, Optional[torch.Tensor],
                                       Optional[dict]]],
                            List[Any]]:
        """Collect progress since the last poll: ``(tokens, finished,
        restarts)`` where ``tokens`` maps tag -> newly decoded token
        ids (stream order), ``finished`` lists ``(tag, status, result,
        error_record)`` for requests that went terminal (error_record
        is the engine's last error dict for failed requests, None
        otherwise), and ``restarts`` lists tags whose request the
        ENGINE restarted from scratch (quarantine + retry) — their
        already-streamed tokens are void and the stream replays from
        token 0 (for an unseeded sampled request the retry redraws, so
        mixing attempts would corrupt the stream).  Fires
        ``replica.stream``."""
        raise NotImplementedError

    def health(self) -> None:
        """One health probe; raises on an unhealthy replica.  Fires
        ``replica.health``."""
        raise NotImplementedError

    def progress(self) -> tuple:
        """A host-counter tuple that changes whenever the replica makes
        ANY forward progress (decode steps, tokens, prefill chunks,
        completions) — the supervisor's stall detector compares
        consecutive values, never timestamps."""
        raise NotImplementedError

    def cancel(self, tag) -> bool:
        """Retire one request (hedge loser / gateway deadline); its
        partial work is released idempotently."""
        raise NotImplementedError

    def drain(self) -> List[Any]:
        """Death path: cancel every held request, release all cache
        tiers, and return the tags (submission order) for requeueing
        elsewhere.  After drain the replica holds zero pages."""
        raise NotImplementedError

    def adopt(self, checkpoint) -> int:
        """Stage a verified checkpoint as the replica engine's next
        weight generation (its own, whatever model it shares); returns
        the staged generation number.  In-flight streams finish on the
        old weights; failures leave the old generation serving."""
        raise NotImplementedError

    def rollback(self) -> int:
        """Re-stage the engine's previous weight generation."""
        raise NotImplementedError


class InProcessReplica(ReplicaTransport):
    """ReplicaTransport over one engine instance in this process.

    The adapter owns the tag <-> engine-rid mapping and the per-request
    streamed-token cursors; the engine keeps its own semantics
    (quarantine, deadlines, speculation) untouched — an engine-level
    per-slot fault is the ENGINE's failure path (that request retries
    or fails), while an exception escaping :meth:`health` /
    :meth:`step` / :meth:`poll` is a REPLICA-level signal the
    supervisor counts toward declared death.  An engine over a tp > 1
    mesh raises: the service layer over tensor-parallel engines is not
    ported.
    """

    def __init__(self, engine, replica_id: str = "r0"):
        dec = getattr(engine, "_dec", None)
        if dec is not None and dec.tp > 1:
            raise MXTPUError(
                "a replica over a tensor-parallel engine (tp=%d) is not "
                "ported: the service layer serves one-rank engines (ROADMAP "
                "A6's leftovers)" % dec.tp)
        self._eng = engine
        self.replica_id = str(replica_id)
        self.alive = True
        self._tags: Dict[int, Any] = {}        # engine rid -> tag
        self._cursor: Dict[int, List[int]] = {}  # rid -> [entries, toks]
        # correlation-id scope: an engine left
        # on the default "eng" tag takes this replica's id, so pooled
        # replicas' timelines never collide
        if getattr(engine, "_trace_tag", None) in (None, "eng"):
            engine._trace_tag = self.replica_id

    @property
    def engine(self):
        return self._eng

    # -- capacity / placement signals ------------------------------------
    @property
    def capacity(self) -> int:
        return self._eng.num_slots

    @property
    def load(self) -> int:
        return self._eng.active + self._eng.pending

    @property
    def free_slots(self) -> int:
        return self._eng.free_slots

    def prefix_probe(self, prompt) -> int:
        return self._eng.prefix_probe(onp.asarray(prompt))

    def stats(self) -> dict:
        return dict(self._eng.stats)

    # -- work ------------------------------------------------------------
    def submit(self, spec: dict, tag) -> int:
        if not self.alive:
            raise ReplicaDownError(
                "replica %s is down: submit refused" % self.replica_id)
        if self.retiring:
            raise ReplicaDownError(
                "replica %s is retiring: submit refused (in-flight "
                "streams are draining to completion)" % self.replica_id)
        kw = {k: spec[k] for k in SPEC_KEYS if k in spec}
        rid = self._eng.submit(spec["prompt"], kw.pop("max_new_tokens"),
                               **kw)
        tr = _tracer()
        if tr.active and hasattr(self._eng, "_trace_key"):
            # thread the correlation id along the rid<->tag map: every
            # engine event of this request resolves onto the gateway
            # request's timeline from here on
            gw = gateway_rid(tag)
            tr.alias(self._eng._trace_key(rid), gw)
            tr.emit("transport.submit", rid=gw,
                    replica=self.replica_id, engine_rid=str(rid))
        self._tags[rid] = tag
        # [emitted entries consumed, tokens streamed, prompt length,
        #  the slot object last streamed from] — the slot reference is
        # the attempt-identity marker: an engine-level retry admits a
        # FRESH slot, so identity (not counts, which a re-decoded
        # retry can make equal) detects restarts
        self._cursor[rid] = [0, 0, int(spec["prompt"].shape[1]), None]
        return rid

    def step(self) -> None:
        # a staged weight generation installs at an EMPTY iteration
        # boundary, so an otherwise-idle engine still needs the step
        if self._eng.pending or self._eng.active \
                or getattr(self._eng, "_staged_adoption", None) is not None:
            self._eng.step()

    def _slot_of(self, rid):
        for slot in self._eng._slots:
            if slot is not None and slot.req.rid == rid:
                return slot
        return None

    def _host_rows(self, pending) -> Dict[int, onp.ndarray]:
        """The pooled (B,) token vectors the ``pending`` slots emitted
        since the last poll, on the host: ``{id(vector): row}``.  Every
        distinct vector is read once, in ONE copy (a stack, then one
        host transfer), however many slots hold it; speculative entries
        are already host ints."""
        pooled: Dict[int, torch.Tensor] = {}
        for _, rid, slot in pending:
            for entry in slot.emitted[self._cursor[rid][0]:]:
                if not isinstance(entry, _SpecTokens):
                    pooled.setdefault(id(entry), entry)
        if not pooled:
            return {}
        rows = torch.stack(list(pooled.values())).cpu().numpy()
        return dict(zip(pooled, rows))

    def _new_tokens(self, rid, slot, host) -> List[int]:
        """The entries appended to ``slot.emitted`` since the last poll,
        as ints (``host``: :meth:`_host_rows`)."""
        cur = self._cursor[rid]
        out: List[int] = []
        for entry in slot.emitted[cur[0]:]:
            if isinstance(entry, _SpecTokens):
                out.extend(int(t) for t in entry.toks)
            else:
                out.append(int(host[id(entry)][slot.row]))
        cur[0] = len(slot.emitted)
        cur[1] += len(out)
        return out

    def poll(self):
        _inject("replica.stream", key=self.replica_id)
        tokens: Dict[Any, List[int]] = {}
        finished: List[Tuple[Any, str, Optional[torch.Tensor],
                             Optional[dict]]] = []
        restarts: List[Any] = []
        # active slots with new entries: (tag, rid, slot), read after the
        # walk in one host copy (their keys hold their place in tokens)
        pending = []
        for rid in list(self._tags):
            st = self._eng.status(rid)
            if st == "queued":
                cur = self._cursor[rid]
                if cur[0] or cur[1]:
                    # the engine quarantined and re-queued this request
                    # (its retries=): the restart is from scratch, so
                    # everything streamed so far is void
                    self._cursor[rid] = [0, 0, cur[2], None]
                    restarts.append(self._tags[rid])
                continue
            if st == "active":
                slot = self._slot_of(rid)
                if slot is not None:
                    cur = self._cursor[rid]
                    if cur[3] is not None and cur[3] is not slot:
                        # a restart that re-admitted between polls (a
                        # health blip skipped the tick that would have
                        # observed it queued): a fresh slot OBJECT is
                        # a fresh attempt, even if it has re-decoded
                        # exactly as many entries as we had consumed
                        if cur[0] or cur[1]:
                            restarts.append(self._tags[rid])
                        cur[0] = cur[1] = 0
                    cur[3] = slot
                if slot is not None and \
                        len(slot.emitted) > self._cursor[rid][0]:
                    tokens[self._tags[rid]] = []
                    pending.append((self._tags[rid], rid, slot))
                continue
            # terminal: flush the un-streamed tail of the final output,
            # then hand the result over (pops the engine's record)
            tag = self._tags.pop(rid)
            cur = self._cursor.pop(rid)
            res = self._eng.take_result(rid)
            seq = res.numpy()[0]
            tail = [int(t) for t in seq[cur[2] + cur[1]:]]
            if tail:
                tokens.setdefault(tag, []).extend(tail)
            finished.append((tag, st, res, self._eng.error(rid)))
        if pending:
            host = self._host_rows(pending)
            for tag, rid, slot in pending:
                new = self._new_tokens(rid, slot, host)
                if new:
                    tokens[tag] = new
                else:
                    del tokens[tag]
        return tokens, finished, restarts

    def health(self) -> None:
        _inject("replica.health", key=self.replica_id)
        # cheap invariant probe: the stats snapshot must be readable
        # and internally consistent (a wedged/corrupt engine raises)
        st = self._eng.stats
        if st["steps"] < 0:
            raise MXTPUError("replica %s: corrupt stats %r"
                             % (self.replica_id, st))

    def progress(self) -> tuple:
        st = self._eng.stats
        chunks = sum(getattr(s, "chunk_i", 0)
                     for s in self._eng._slots if s is not None)
        return (st["steps"], st["generated_tokens"],
                st["quarantined_requests"], len(self._eng._done), chunks)

    def cancel(self, tag) -> bool:
        rid = next((r for r, t in self._tags.items() if t == tag), None)
        if rid is None:
            return False
        self._tags.pop(rid, None)
        self._cursor.pop(rid, None)
        if self._eng.cancel(rid):
            self._eng.take_result(rid)      # discard the partial
            return True
        if self._eng.status(rid) in ("ok", "failed", "expired",
                                     "cancelled"):
            self._eng.take_result(rid)      # raced its own finish
        return False

    def drain(self) -> List[Any]:
        # the tags come FIRST and the engine calls are best-effort: a
        # replica is usually drained precisely because its engine is
        # broken, and a raise here must never lose the tag list (the
        # requests requeue elsewhere either way; a wedged engine's
        # pages die with its process)
        tags = [self._tags[rid] for rid in sorted(self._tags)]
        for rid in sorted(self._tags):
            try:
                if self._eng.cancel(rid):
                    self._eng.take_result(rid)
                elif rid in self._eng._results:
                    # finished between the last poll and death: never
                    # delivered — requeue it like the rest (the
                    # restart is bit-identical from the seed)
                    self._eng.take_result(rid)
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
        self._tags.clear()
        self._cursor.clear()
        try:
            self._eng.drop_cache()
        except Exception:  # noqa: BLE001
            pass
        return tags

    def adopt(self, checkpoint) -> int:
        return self._eng.adopt(checkpoint)

    def rollback(self) -> int:
        return self._eng.rollback()


# -- the cross-process transport ------------------------------------------

def _enc_tag(tag) -> Any:
    return list(tag) if isinstance(tag, tuple) else tag


#: exception type names rebuilt with their structured attributes so the
#: gateway's typed shed handling works unchanged across the boundary
_SHED_TYPES = {"LoadShedError": LoadShedError,
               "QosShedError": QosShedError,
               "EngineShedError": EngineShedError}


def _rebuild_error(err: dict) -> BaseException:
    """Reconstruct a worker-marshalled exception as the REAL type where
    the service layer's handling depends on it (shed family, replica
    down, injected faults, builtins); anything unrecognized surfaces as
    a plainly-labelled MXTPUError."""
    name = err.get("type") or "Exception"
    msg = err.get("msg") or ""
    attrs = err.get("attrs") or {}
    if name in _SHED_TYPES:
        return _SHED_TYPES[name](
            msg, queue_depth=attrs.get("queue_depth"),
            limit=attrs.get("limit"),
            retry_after_ticks=attrs.get("retry_after_ticks"),
            permanent=bool(attrs.get("permanent", False)))
    if name == "ReplicaDownError":
        return ReplicaDownError(msg)
    if name == "InjectedFault":
        return InjectedFault(msg)
    if name == "CorruptCheckpointError":
        # typed so the hot-swap contract (corrupt checkpoint -> old
        # generation keeps serving, caller sees the REAL error class)
        # survives the process boundary
        from ..resilience.checkpoint import CorruptCheckpointError
        return CorruptCheckpointError(msg)
    if name == "MXTPUError":
        return MXTPUError(msg)
    cls = getattr(builtins, name, None)
    if (isinstance(cls, type) and issubclass(cls, Exception)
            and not issubclass(cls, (KeyboardInterrupt, SystemExit))):
        try:
            return cls(msg)
        except Exception:  # noqa: BLE001 — odd constructor signature
            pass
    return MXTPUError("worker-side %s: %s" % (name, msg))


def _default_waiter(pipe, seconds: float) -> bool:
    """One readiness tick on the worker's stdout pipe (the pipe is
    UNBUFFERED, so fd-level readiness is the truth).  Injectable: tests
    pass a waiter that always returns False for an instant,
    zero-wall-clock timeout."""
    import select
    ready, _, _ = select.select([pipe], [], [], seconds)
    return bool(ready)


def default_rpc_timeout_ticks() -> int:
    """Ambient per-RPC tick budget (``MXTPU_RPC_TIMEOUT_TICKS``,
    default 2400 — at the default 0.05s readiness tick that is 120s,
    generous enough for a worker's first step, which loads the kernels'
    libraries and warms the allocator, inside a step RPC)."""
    try:
        return max(1, int(os.environ.get("MXTPU_RPC_TIMEOUT_TICKS",
                                         2400)))
    except ValueError:
        return 2400


class SubprocessReplica(ReplicaTransport):
    """ReplicaTransport over one engine in a SPAWNED worker process
    (``mxtpu_torch.serving.worker``) — replica death is a real
    ``SIGKILL``, not a flag flip.

    Every protocol call crosses the pipe as host data (length-prefixed
    json/msgpack frames, :mod:`mxtpu_torch.serving.worker` has the wire
    format); the worker wraps its engine in an
    :class:`InProcessReplica`, so tag/cursor/restart/drain semantics
    are identical to the in-process transport.  Parent-side state is a
    TAG MIRROR (engine-rid -> tag, submission order) — the drain
    contract survives a worker that can no longer answer.

    Robustness model:

    - **tick-budget timeouts**: every RPC waits for its response in
      ``tick_seconds`` readiness ticks through an injectable
      ``waiter``; ``rpc_timeout_ticks`` ticks without a frame raise a
      typed :class:`~mxtpu_torch.resilience.TransportTimeoutError` — a
      replica-level signal the supervisor counts toward death, NEVER a
      stall.  A late response is discarded by frame id afterwards, so
      a transient timeout is recoverable.
    - **heartbeat-backed health**: the worker stamps every response
      with its served-frame count; :meth:`health` asserts it advanced.
    - **real process kill**: :meth:`kill` SIGKILLs the worker; the
      ``transport.worker_death`` fault site is intercepted to do
      exactly that, making a real mid-decode process kill
      deterministic and replayable under the plan grammar.
    - **fail-soft placement signals**: a transport failure inside
      :meth:`prefix_probe` / the load properties degrades the signal
      (no locality, looks full) instead of failing dispatch — the
      router routes around it and the supervisor's own probes decide
      death.
    - **submit on a dead worker** raises :class:`ReplicaDownError`
      (the router's typed reroute path), never a transport error: new
      work reroutes immediately, death is declared by the supervisor.

    The spawned environment inherits this process's, minus the ambient
    fault/trace/flight variables (``MXTPU_FAULT_PLAN``, ``MXTPU_TRACE``,
    ``MXTPU_FLIGHT_BUFFER``) — injection and observability are PARENT
    concerns: fault plans drive the ``transport.*`` sites parent-side,
    and worker trace events are forwarded per-RPC and re-emitted under
    the parent's counter clock (one timeline per request spanning both
    processes).  Pass ``env=`` to opt a worker into its own plan.
    """

    #: env vars NOT inherited by workers (see class docstring)
    _SCRUBBED_ENV = ("MXTPU_FAULT_PLAN", "MXTPU_TRACE",
                     "MXTPU_FLIGHT_BUFFER", "MXTPU_REPLICAS",
                     "MXTPU_REPLICA_TRANSPORT")

    def __init__(self, factory: str, kwargs: Optional[dict] = None,
                 replica_id: str = "r0",
                 rpc_timeout_ticks: Optional[int] = None,
                 init_timeout_ticks: Optional[int] = None,
                 tick_seconds: float = 0.05,
                 waiter=None, codec: Optional[str] = None,
                 env: Optional[dict] = None,
                 python: Optional[str] = None):
        self.replica_id = str(replica_id)
        self.alive = True
        self._timeout_ticks = (default_rpc_timeout_ticks()
                               if rpc_timeout_ticks is None
                               else max(1, int(rpc_timeout_ticks)))
        self._init_ticks = (max(self._timeout_ticks, 4800)
                            if init_timeout_ticks is None
                            else max(1, int(init_timeout_ticks)))
        self._tick_seconds = float(tick_seconds)
        self._waiter = waiter or _default_waiter
        codec = codec or os.environ.get("MXTPU_RPC_CODEC", "json")
        self._codec = codec
        self._dumps, self._loads = make_codec(codec)
        self._mirror: Dict[int, Any] = {}   # engine rid -> tag
        self._stale: set = set()            # timed-out frame ids
        self._next_fid = 0
        self._last_heartbeat = 0
        self._last_drain: Optional[dict] = None
        self._exit_emitted = False
        self.pid: Optional[int] = None
        # everything a FRESH worker needs is kept so respawn() (the
        # supervisor's probation revival of a dead worker) can rebuild
        # pipe + handshake + factory call from scratch
        self._factory = factory
        self._factory_kwargs = dict(kwargs or {})
        child_env = dict(os.environ)
        for var in self._SCRUBBED_ENV:
            child_env.pop(var, None)
        # the worker imports the port (and a factory module beside it,
        # such as a script at the checkout's root) from the same checkout
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        child_env["PYTHONPATH"] = (
            pkg_root + os.pathsep + child_env["PYTHONPATH"]
            if child_env.get("PYTHONPATH") else pkg_root)
        child_env.update(env or {})
        self._child_env = child_env
        self._python = python
        self._proc: Optional[subprocess.Popen] = None
        self._spawn()

    def _spawn(self) -> None:
        """Start one worker process and handshake it (shared by
        construction and :meth:`respawn`)."""
        # -c (not -m): the package import graph already holds
        # mxtpu_torch.serving.worker, and runpy would warn about
        # re-executing a module that import brought in
        self._proc = subprocess.Popen(
            [self._python or sys.executable, "-c",
             "import sys; from mxtpu_torch.serving.worker import main; "
             "sys.exit(main())"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=self._child_env, bufsize=0)
        try:
            self._handshake(self._factory, self._factory_kwargs)
        except BaseException:
            self._kill_worker()
            raise
        tr = _tracer()
        if tr.active:
            tr.emit("transport.worker_spawn", replica=self.replica_id,
                    capacity=self._capacity, noise={"pid": self.pid})

    def respawn(self) -> None:
        """Spawn a FRESH worker for this replica — new pipe, new
        handshake, factory re-run worker-side — after the old one
        died.  The supervisor's probation ``revive()`` calls this for
        subprocess replicas instead of re-admitting a corpse; per-
        worker protocol state (tag mirror, frame ids, heartbeat) resets
        because the new process shares none of it.  Raises
        :class:`~mxtpu_torch.resilience.TransportError` while the old worker
        is still running (kill or shut it down first)."""
        if self._proc is not None and self._proc.poll() is None:
            raise TransportError(
                "replica %s worker pid %s is still running — respawn "
                "only replaces a DEAD worker" % (self.replica_id,
                                                 self.pid))
        if self._proc is not None:
            self._emit_exit()
            for pipe in (self._proc.stdin, self._proc.stdout):
                try:
                    if pipe is not None:
                        pipe.close()
                except Exception:  # noqa: BLE001
                    pass
        self._proc = None
        self._mirror.clear()
        self._stale.clear()
        self._next_fid = 0
        self._last_heartbeat = 0
        self._last_drain = None
        self._exit_emitted = False
        self.pid = None
        self._spawn()

    @property
    def worker_dead(self) -> bool:
        """Whether the worker PROCESS is gone (closed, exited, or
        killed) — the supervisor's revive() respawns exactly when this
        is true."""
        return self._proc is None or self._proc.poll() is not None

    def _handshake(self, factory: str, kwargs: Optional[dict]) -> None:
        init = {"factory": factory, "kwargs": dict(kwargs or {}),
                "replica_id": self.replica_id, "codec": self._codec}
        import json
        try:
            _write_frame(self._proc.stdin,
                         json.dumps(init, sort_keys=True).encode())
        except (BrokenPipeError, OSError) as exc:
            raise WorkerDiedError(
                "replica %s worker died before init: %s"
                % (self.replica_id, exc),
                exit_code=self._reap()) from exc
        resp = json.loads(self._read_raw_frame(
            self._init_ticks, "init").decode())
        if not resp.get("ok"):
            raise TransportError(
                "replica %s worker failed to initialize: %s"
                % (self.replica_id,
                   _rebuild_error(resp.get("error") or {})))
        self.pid = resp.get("pid")
        self._capacity = int(resp.get("capacity", 0))

    # -- pipe plumbing ---------------------------------------------------
    def _read_raw_frame(self, budget: int, method: str) -> bytes:
        """One frame off the pipe under a tick budget (the RPC timeout
        machinery; see class docstring)."""
        proc = self._proc
        waited = 0
        while not self._waiter(proc.stdout, self._tick_seconds):
            if proc.poll() is not None:
                raise WorkerDiedError(
                    "replica %s worker pid %s died awaiting %r "
                    "(exit %s)" % (self.replica_id, self.pid, method,
                                   proc.returncode),
                    exit_code=proc.returncode)
            waited += 1
            if waited >= budget:
                tr = _tracer()
                if tr.active:
                    tr.emit("transport.rpc_timeout",
                            replica=self.replica_id, method=method,
                            ticks=budget)
                raise TransportTimeoutError(
                    "replica %s RPC %r exhausted its %d-tick budget "
                    "(tick=%.3fs)" % (self.replica_id, method, budget,
                                      self._tick_seconds),
                    method=method, ticks=budget)
        buf = _read_frame(proc.stdout)
        if buf is None:
            code = self._reap()
            raise WorkerDiedError(
                "replica %s worker pid %s died mid-RPC %r (pipe EOF, "
                "exit %s)" % (self.replica_id, self.pid, method, code),
                exit_code=code)
        return buf

    def _read_response(self, want_id: int, method: str,
                       budget: int) -> dict:
        while True:
            try:
                resp = self._loads(self._read_raw_frame(budget, method))
            except TransportTimeoutError:
                # remember the outstanding frame so its late response
                # is discarded (a TRANSIENT timeout stays recoverable)
                self._stale.add(want_id)
                raise
            fid = resp.get("id")
            if fid in self._stale:
                self._stale.discard(fid)
                continue
            if fid != want_id:
                raise TransportError(
                    "replica %s answered frame %r while %r was "
                    "outstanding (%s) — stream desynchronized"
                    % (self.replica_id, fid, want_id, method))
            return resp

    def _rpc(self, method: str, params: Optional[dict] = None,
             budget: Optional[int] = None):
        _inject("transport.rpc", key=self.replica_id)
        try:
            _inject("transport.worker_death", key=self.replica_id)
        except BaseException:
            # the plan-grammar spelling of a REAL process kill: the
            # injected raise is intercepted and converted into a
            # SIGKILL of our own worker — the RPC below then fails on
            # the dead pipe exactly as an unplanned kill would,
            # deterministically at the planned hit
            self._kill_worker()
        proc = self._proc
        if proc is None:
            raise WorkerDiedError(
                "replica %s has been closed — no worker to issue %r"
                % (self.replica_id, method))
        if proc.poll() is not None:
            raise WorkerDiedError(
                "replica %s worker pid %s is dead (exit %s) — cannot "
                "issue %r" % (self.replica_id, self.pid,
                              proc.returncode, method),
                exit_code=proc.returncode)
        fid = self._next_fid
        self._next_fid += 1
        tr = _tracer()
        frame = {"id": fid, "method": method, "params": params or {}}
        if tr.active:
            frame["trace"] = True
        try:
            _write_frame(proc.stdin, self._dumps(frame))
        except (BrokenPipeError, OSError) as exc:
            code = self._reap()
            raise WorkerDiedError(
                "replica %s worker pid %s died writing %r frame "
                "(exit %s)" % (self.replica_id, self.pid, method, code),
                exit_code=code) from exc
        resp = self._read_response(
            fid, method,
            self._timeout_ticks if budget is None else budget)
        self._last_heartbeat = int(resp.get("served",
                                            self._last_heartbeat))
        if tr.active:
            for ev in resp.get("events") or ():
                etype, erid, phase, fields = ev
                # worker events arrive pre-resolved to the gateway rid
                # (the worker-side InProcessReplica registered the
                # alias); re-emit under the parent's counter clock
                tr.emit(etype, rid=erid, phase=phase,
                        **{k: v for k, v in (fields or {}).items()
                           if k not in ("rid", "phase", "noise")})
        if resp.get("ok"):
            return resp.get("result")
        raise _rebuild_error(resp.get("error") or {})

    # -- lifecycle -------------------------------------------------------
    @property
    def exit_code(self) -> Optional[int]:
        return None if self._proc is None else self._proc.returncode

    def _emit_exit(self) -> None:
        if self._exit_emitted or self._proc is None:
            return
        self._exit_emitted = True
        tr = _tracer()
        if tr.active:
            tr.emit("transport.worker_exit", replica=self.replica_id,
                    code=self._proc.returncode,
                    noise={"pid": self.pid})

    def _reap(self) -> Optional[int]:
        proc = self._proc
        if proc is None:
            return None
        try:
            proc.wait(timeout=30)
        except Exception:  # noqa: BLE001 — unreapable stays unknown
            return None
        self._emit_exit()
        return proc.returncode

    def _kill_worker(self) -> Optional[int]:
        proc = self._proc
        if proc is None:
            return None
        if proc.poll() is None:
            try:
                proc.kill()             # SIGKILL — no goodbye
            except OSError:
                pass
        return self._reap()

    def kill(self) -> Optional[int]:
        """SIGKILL the worker (tests/chaos drills); returns the exit
        code (``-9`` once reaped).  The supervisor discovers the death
        on its next probe and runs drain-and-requeue off the parent-
        side tag mirror."""
        return self._kill_worker()

    def shutdown(self):
        """GRACEFUL worker exit: the worker flushes its in-flight
        cursors (one final poll crosses back) and leaves with exit
        code 0.  Returns the final ``(tokens, finished, restarts)``;
        the replica refuses work afterwards."""
        proc = self._proc
        if proc is None or proc.poll() is not None:
            self.alive = False
            return {}, [], []
        res = self._rpc("shutdown")
        final = decode_poll(res["final"])
        try:
            proc.wait(timeout=60)
        except Exception:  # noqa: BLE001 — a worker that will not exit
            proc.kill()    # gracefully is killed
            self._reap()
        self._emit_exit()
        self.alive = False
        self._mirror.clear()
        return final

    def close(self) -> None:
        """Tear the worker down unconditionally (kill + reap + close
        pipes).  Idempotent; also the destructor path, so an abandoned
        transport never orphans its process."""
        if self._proc is None:
            return
        self._kill_worker()
        for pipe in (self._proc.stdin, self._proc.stdout):
            try:
                if pipe is not None:
                    pipe.close()
            except Exception:  # noqa: BLE001
                pass
        self._proc = None
        self.alive = False

    def __del__(self):  # pragma: no cover — gc timing
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    # -- capacity / placement signals ------------------------------------
    def _signals(self) -> dict:
        if (not self.alive or self._proc is None
                or self._proc.poll() is not None):
            return {"capacity": self._capacity, "load": 0,
                    "free_slots": 0}
        try:
            return self._rpc("signals")
        except TransportError:
            # fail-soft: a replica that cannot answer looks FULL (the
            # router routes around it); liveness is the supervisor's
            # call, made on its own probes
            return {"capacity": self._capacity,
                    "load": self._capacity, "free_slots": 0}

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def load(self) -> int:
        return int(self._signals()["load"])

    @property
    def free_slots(self) -> int:
        return int(self._signals()["free_slots"])

    def prefix_probe(self, prompt) -> int:
        if (not self.alive or self._proc is None
                or self._proc.poll() is not None):
            return 0
        arr = _host(prompt)
        try:
            return int(self._rpc(
                "prefix_probe",
                {"prompt": onp.asarray(arr, dtype=onp.int32).tolist()}))
        except TransportError:
            return 0                    # fail-soft: no locality signal

    def stats(self) -> dict:
        """Worker engine stats; a DEAD worker reports zero resident
        pages — its pool died with its address space, which is exactly
        the zero-leak claim the kill-drain tests assert."""
        if self._proc is None or self._proc.poll() is not None:
            return {"blocks_in_use": 0, "pinned_blocks": 0,
                    "worker": "dead"}
        return dict(self._rpc("stats"))

    # -- work ------------------------------------------------------------
    def submit(self, spec: dict, tag) -> int:
        if not self.alive:
            raise ReplicaDownError(
                "replica %s is down: submit refused" % self.replica_id)
        if self.retiring:
            raise ReplicaDownError(
                "replica %s is retiring: submit refused (in-flight "
                "streams are draining to completion)" % self.replica_id)
        if self._proc is None or self._proc.poll() is not None:
            raise ReplicaDownError(
                "replica %s worker process is dead: submit refused"
                % self.replica_id)
        _inject("transport.encode", key=self.replica_id)
        wire = {k: spec[k] for k in SPEC_KEYS if k in spec}
        wire["prompt"] = onp.asarray(spec["prompt"],
                                     dtype=onp.int32).tolist()
        try:
            res = self._rpc("submit", {"spec": wire,
                                       "tag": _enc_tag(tag)})
        except WorkerDiedError as exc:
            # new work reroutes through the router's typed path; the
            # supervisor declares the death on its own next probe
            raise ReplicaDownError(
                "replica %s worker died during submit: %s"
                % (self.replica_id, exc)) from exc
        rid = int(res["rid"])
        self._mirror[rid] = tag
        tr = _tracer()
        if tr.active:
            tr.alias("%s:%s" % (self.replica_id, rid),
                     gateway_rid(tag))
        return rid

    def step(self) -> None:
        self._rpc("step")

    def poll(self):
        _inject("replica.stream", key=self.replica_id)
        tokens, finished, restarts = decode_poll(self._rpc("poll"))
        if finished:
            done = {t for t, _, _, _ in finished}
            for rid in [r for r, t in self._mirror.items()
                        if t in done]:
                del self._mirror[rid]
        return tokens, finished, restarts

    def health(self) -> None:
        _inject("replica.health", key=self.replica_id)
        before = self._last_heartbeat
        self._rpc("health")
        if self._last_heartbeat <= before:
            raise TransportError(
                "replica %s heartbeat did not advance (%d -> %d): the "
                "worker is answering without serving"
                % (self.replica_id, before, self._last_heartbeat))

    def progress(self) -> tuple:
        return tuple(self._rpc("progress"))

    def cancel(self, tag) -> bool:
        rid = next((r for r, t in self._mirror.items() if t == tag),
                   None)
        if rid is not None:
            del self._mirror[rid]
        if self._proc is None or self._proc.poll() is not None:
            return False
        try:
            return bool(self._rpc("cancel", {"tag": _enc_tag(tag)}))
        except TransportError:
            return False                # released when the process died

    def drain(self) -> List[Any]:
        # the MIRROR is the source of truth (submission order = rid
        # order): a drain is usually running precisely because the
        # worker cannot answer, and the tag list must never be lost
        tags = [self._mirror[rid] for rid in sorted(self._mirror)]
        proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                res = self._rpc("drain")
                # the live worker drained clean (its in-process adapter
                # runs the V004 sanitizer check); record its report for
                # the death postmortem
                self._last_drain = {
                    "blocks_in_use": int(res["blocks_in_use"]),
                    "pinned_blocks": int(res["pinned_blocks"])}
            except Exception:  # noqa: BLE001 — a wedged worker's pages
                # die with its process; make that true right now
                self._kill_worker()
        self._mirror.clear()
        self._stale.clear()
        return tags

    def adopt(self, checkpoint) -> int:
        """Hot-swap RPC: the checkpoint path crosses the wire as a
        string (same-host shared filesystem); the worker-side engine
        reads, CRC-verifies, and stages it itself, so a corrupt file
        raises here as the rebuilt typed error and the worker keeps
        serving its old generation."""
        return int(self._rpc("adopt", {"checkpoint": str(checkpoint)}))

    def rollback(self) -> int:
        return int(self._rpc("rollback"))
