"""Resilience of the port (the port of ``mxtpu/resilience``):
deterministic fault plans (``faults``), the process-wide counters
(``counters``), verified checkpoints (``checkpoint``) and
:class:`RetryPolicy` (``retry``).

The engines' fault contract (quarantine, retries, deadlines, bounded
admission) and their live weight hot-swap, which reads verified
checkpoints and is each engine's own (engines sharing one model adopt
apart), live in ``mxtpu_torch/parallel/serving.py``; the replica
service layer's failure paths (typed sheds, transport failures, replica
deaths) in ``mxtpu_torch/serving``.  The training guardian is not ported
yet: it drives the trainer's ``guard``, which the port's
``SPMDTrainer`` does not have.

Typed rejections and transport failures are exported here:
:class:`LoadShedError` (the engines' bounded admission) and its gateway
forms :class:`QosShedError` and :class:`EngineShedError`;
:class:`TransportError`, :class:`TransportTimeoutError` and
:class:`WorkerDiedError` (a subprocess replica's RPC failures).
"""

from ..base import LoadShedError, MXTPUError
from .checkpoint import (CheckpointSet, CorruptCheckpointError,
                         rotate_history, verify, verify_dir,
                         write_verified)
from .counters import bump, counters, reset_counters
from .faults import (SITES, FaultPlan, FaultRule, InjectedFault,
                     active_plan, fault_plan, inject, reload_env_plan,
                     site_stats)
from .retry import RetryPolicy

__all__ = ["FaultPlan", "FaultRule", "InjectedFault", "fault_plan", "inject",
           "active_plan", "site_stats", "reload_env_plan", "SITES",
           "RetryPolicy", "LoadShedError", "QosShedError",
           "EngineShedError", "TransportError", "TransportTimeoutError",
           "WorkerDiedError", "bump", "counters", "reset_counters",
           "CheckpointSet", "CorruptCheckpointError", "write_verified",
           "verify", "verify_dir", "rotate_history"]


class QosShedError(LoadShedError):
    """The GATEWAY shed this request by QoS policy — its class lost to
    higher-priority traffic (queue full, a lower class was displaced,
    or a per-tenant quota tripped) while the engines below may be
    perfectly healthy.  Back off ``retry_after_ticks`` and resubmit
    (possibly at a higher class); see ``mxtpu_torch.serving.Gateway``."""


class EngineShedError(LoadShedError):
    """An ENGINE-level shed surfaced through the gateway: the replica's
    own admission refused the request (most often ``permanent=True`` —
    it can never fit the replica's page pool), as opposed to the
    gateway's QoS policy.  Distinct from :class:`QosShedError` so
    caller backoff policies can tell "try again later / raise my
    class" from "this request is malformed for this deployment"."""


class TransportError(MXTPUError):
    """A replica RPC failed at the TRANSPORT layer — the pipe broke,
    the frame was malformed, or the worker answered garbage — as
    opposed to the replica's engine raising a (marshalled) error of its
    own.  A replica-level signal: the supervisor counts it toward the
    same consecutive-failure death as a failed health probe, and its
    death reason says "transport", never "stalled" (a worker that
    cannot answer is not a worker that stopped decoding)."""


class TransportTimeoutError(TransportError):
    """A replica RPC exhausted its tick budget (``rpc_timeout_ticks``
    waiter rounds — see ``mxtpu_torch.serving.SubprocessReplica``)
    without a response.  ``method`` is the RPC that timed out, ``ticks``
    the budget that was exhausted.  A TRANSIENT timeout is recoverable
    — the transport discards the late response by frame id when it
    eventually arrives — but the supervisor still counts each one toward
    declared death."""

    def __init__(self, message, method=None, ticks=None):
        super().__init__(message)
        self.method = method
        self.ticks = ticks


class WorkerDiedError(TransportError):
    """The worker PROCESS behind a subprocess replica is gone — EOF on
    the RPC pipe or a reaped exit — so no RPC can ever complete.
    Terminal for the replica: the supervisor's death path drains the
    parent-side tag mirror and requeues every held request (the
    worker's pages died with its address space).  ``exit_code`` is the
    process's ``returncode`` when it was reapable (e.g. ``-9`` after a
    SIGKILL), else None."""

    def __init__(self, message, exit_code=None):
        super().__init__(message)
        self.exit_code = exit_code
