"""Resilience of the port's serving engines: deterministic fault plans
(``faults``) and the process-wide counters (``counters``), copies of the
reference's ``mxtpu/resilience/faults.py`` and ``counters.py``.

The engines' fault contract (quarantine, retries, deadlines, bounded
admission) lives in ``mxtpu_torch/parallel/serving.py``; this package
holds only the injection machinery it is tested through.  Retry
policies, the training guardian, verified checkpoints and tracing are
not ported yet.
"""

from ..base import LoadShedError
from .counters import bump, counters, reset_counters
from .faults import (SITES, FaultPlan, FaultRule, InjectedFault,
                     active_plan, fault_plan, inject, reload_env_plan,
                     site_stats)

__all__ = ["FaultPlan", "FaultRule", "InjectedFault", "fault_plan", "inject",
           "active_plan", "site_stats", "reload_env_plan", "SITES",
           "LoadShedError", "bump", "counters", "reset_counters"]
