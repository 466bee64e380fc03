"""Process-wide resilience counters (the port's copy of
``mxtpu/resilience/counters.py``).

One flat dict, bumped by the fault injector (faults fired, delays
injected), ``RetryPolicy`` (backoff sleeps, exhaustions), the verified
checkpoints (writes, corruptions, fallbacks) and the serving engines
(quarantines, retries, deadline evictions, load sheds, weight
adoptions).  It lives in its own module so ``faults`` and the
engines can import it without cycles.
"""

from __future__ import annotations

import threading

__all__ = ["bump", "counters", "reset_counters"]

_LOCK = threading.Lock()

_COUNTERS = {
    "faults_injected": 0,      # raise-action rules fired
    "faults_delayed": 0,       # delay-action rules fired
    "retries": 0,              # quarantined requests re-queued and
    #                            backoff sleeps taken by RetryPolicy.call
    "retry_exhaustions": 0,    # calls that re-raised after the budget
    "quarantined_slots": 0,    # serving slots scrubbed after a fault
    "deadline_evictions": 0,   # requests evicted past their deadline
    "shed_requests": 0,        # submissions rejected by admission bounds
    "ckpt_writes": 0,          # verified checkpoint payloads written
    "ckpt_corruptions": 0,     # checkpoints that failed verification
    "ckpt_fallbacks": 0,       # restores that fell back past a bad checkpoint
    "adoptions": 0,            # weight generations installed by engines
    "adoption_failures": 0,    # adopt() calls that raised
    "adoption_rollbacks": 0,   # rollback() calls
}


def bump(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> dict:
    """Snapshot of the process-wide resilience counters."""
    with _LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0
