"""Core plumbing of the PyTorch/CUDA port: errors, device resolution and
the kernels' launch counters.

The port is a package of its own beside ``mxtpu`` (the JAX reference)
and imports nothing of it: what it needs from there lives here as its
own copy.
"""

from __future__ import annotations

import torch

__all__ = ["MXTPUError", "LoadShedError", "resolve_device", "parse_bytes",
           "bump", "count", "counts", "reset_counts"]


class MXTPUError(RuntimeError):
    """Default error type (the port's copy of ``mxtpu.base.MXTPUError``)."""


class LoadShedError(MXTPUError):
    """Typed rejection of a request by the serving engine's admission
    bounds: the queue is at ``max_pending``, or the request needs more
    pages than the whole pool.  ``queue_depth`` is the queue at shed
    time, ``limit`` the bound that tripped, ``retry_after_ticks`` a
    suggested backoff in scheduler iterations (None when retrying cannot
    help), and ``permanent`` True when no backoff can admit it."""

    def __init__(self, message, queue_depth=None, limit=None,
                 retry_after_ticks=None, permanent=False):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.limit = limit
        self.retry_after_ticks = retry_after_ticks
        self.permanent = bool(permanent)


def parse_bytes(text) -> int:
    """'8GB' / '512MiB' / '1e9' -> bytes (decimal suffixes are powers of
    1024 too); a copy of ``mxtpu/analysis/memory_estimate.parse_bytes``."""
    if isinstance(text, (int, float)):
        return int(text)
    s = str(text).strip().lower()
    mult = 1
    for suf, m in (("tib", 1024 ** 4), ("tb", 1024 ** 4),
                   ("gib", 1024 ** 3), ("gb", 1024 ** 3),
                   ("mib", 1024 ** 2), ("mb", 1024 ** 2),
                   ("kib", 1024), ("kb", 1024), ("b", 1)):
        if s.endswith(suf):
            mult = m
            s = s[:-len(suf)].strip()
            break
    return int(float(s) * mult)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card by default, the
    CPU only when the caller names it.  With no device given and no
    CUDA present this raises — an entry point never carries on on the
    CPU behind the caller's back."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise MXTPUError(
            "no CUDA device is available: the port runs on the GPU by "
            "default — pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")


# -- launch counters ----------------------------------------------------
# One plain integer per kernel (the counterpart of
# mxtpu/ops/pallas/counters.py).  A kernel wrapper adds one per call it
# serves: on a CUDA tensor where it launches its kernel, on a CPU tensor
# where it runs the kernel's plain version.  A moving count is how a run
# shows that its main path went through the wrapper.

_COUNTS: dict = {}


def bump(name, n=1):
    """Record ``n`` calls served by kernel ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def count(name):
    """Calls served by one kernel since the last reset (0 if none)."""
    return _COUNTS.get(name, 0)


def counts():
    """Snapshot of every counter."""
    return dict(_COUNTS)


def reset_counts():
    """Set every counter to 0."""
    _COUNTS.clear()
