"""RetryPolicy: exponential backoff with a deadline budget and an
injectable clock and sleep (the port of ``mxtpu/resilience/retry.py``).

Semantics:

- attempt 1 runs immediately; after a retryable failure the policy
  sleeps ``min(max_delay, base_delay * multiplier**(attempt-1))`` and
  tries again, up to ``max_attempts`` total attempts;
- ``deadline`` (seconds, measured by ``clock`` from the first attempt)
  bounds the whole call: if the next backoff would land past it, the
  policy gives up immediately instead of sleeping into a lost cause;
- exhaustion re-raises the ORIGINAL exception (not a wrapper — callers'
  except clauses keep working) with ``mxtpu_retry_attempts`` set to the
  attempt count and, on Python 3.11+, an explanatory ``add_note``;
- ``clock`` / ``sleep`` are injectable so tests drive the backoff with
  a fake clock — no real sleeping, fully deterministic.

There is deliberately no jitter knob: determinism is the point of this
package.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple, Type

from .counters import bump

__all__ = ["RetryPolicy"]


class RetryPolicy:
    """Exponential-backoff retry with deadline budget.

    Parameters
    ----------
    max_attempts : total attempts (>= 1); 1 means no retries.
    base_delay / multiplier / max_delay : backoff schedule in seconds.
    deadline : optional total budget in seconds across all attempts.
    retry_on : exception classes that trigger a retry; anything else
        propagates immediately.
    clock / sleep : injectable time sources (tests pass fakes).
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.05,
                 multiplier: float = 2.0, max_delay: float = 2.0,
                 deadline: float = None,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 clock: Callable[[], float] = None,
                 sleep: Callable[[float], None] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1, got %r"
                             % (max_attempts,))
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.deadline = None if deadline is None else float(deadline)
        self.retry_on = retry_on
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep

    def backoff(self, attempt: int) -> float:
        """Delay slept after failed attempt number ``attempt`` (1-based)."""
        return min(self.max_delay,
                   self.base_delay * self.multiplier ** (attempt - 1))

    def call(self, fn, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy."""
        t0 = self._clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.retry_on as exc:
                delay = self.backoff(attempt)
                exhausted = attempt >= self.max_attempts
                if not exhausted and self.deadline is not None:
                    # would the next attempt start past the budget?
                    exhausted = (self._clock() - t0) + delay > self.deadline
                if exhausted:
                    exc.mxtpu_retry_attempts = attempt
                    if hasattr(exc, "add_note"):
                        exc.add_note(
                            "[mxtpu.resilience] retry exhausted after "
                            "%d attempt(s)" % attempt)
                    bump("retry_exhaustions")
                    raise
                bump("retries")
                self._sleep(delay)

    def wrap(self, fn):
        """Decorator form of :meth:`call`."""
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped

    def __repr__(self):
        return ("RetryPolicy(max_attempts=%d, base_delay=%g, "
                "multiplier=%g, max_delay=%g, deadline=%r)"
                % (self.max_attempts, self.base_delay, self.multiplier,
                   self.max_delay, self.deadline))
