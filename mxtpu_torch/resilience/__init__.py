"""Resilience of the port (the port of ``mxtpu/resilience``):
deterministic fault plans (``faults``), the process-wide counters
(``counters``), verified checkpoints (``checkpoint``) and
:class:`RetryPolicy` (``retry``).

The engines' fault contract (quarantine, retries, deadlines, bounded
admission) and their live weight hot-swap, which reads verified
checkpoints, live in ``mxtpu_torch/parallel/serving.py``.  The training
guardian is not ported yet: it drives the trainer's ``guard``, which
the port's ``SPMDTrainer`` does not have.
"""

from ..base import LoadShedError
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
           "RetryPolicy", "LoadShedError", "bump", "counters",
           "reset_counters", "CheckpointSet", "CorruptCheckpointError",
           "write_verified", "verify", "verify_dir", "rotate_history"]
