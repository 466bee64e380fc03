"""Device mesh and multi-process rendezvous (the port of
``mxtpu/parallel/mesh.py``).

The reference is one controller over a named grid of devices; the port
is one process a rank over ``torch.distributed``.  A :class:`DeviceMesh`
lays the world's ranks out on the reference's axes, in its order
``("dp", "pp", "ep", "sp", "tp")`` with ``tp`` innermost (rank r sits at
the row-major coordinate of r), and gives every axis longer than one its
``torch.distributed`` process group: the ranks that differ only along
that axis.  A mesh of one rank needs no process group at all, so every
single-process caller runs as it did before meshes existed.

:func:`init_process_group` maps the reference's launcher environment
(``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_WORKER``,
``DMLC_WORKER_ID``) onto ``torch.distributed.init_process_group``.  The
backend is gloo, the only one that runs two ranks on one card and on the
CPU, and the ``timeout`` is explicit (torch's default is 30 minutes): a
rank that hangs fails its collective within the timeout instead of
holding its peers forever.
"""

from __future__ import annotations

import datetime
import itertools
import os
from typing import Optional

import torch.distributed as dist

from ..base import MXTPUError

__all__ = ["DeviceMesh", "make_mesh", "init_process_group", "rank",
           "num_workers", "current_mesh", "DEFAULT_TIMEOUT_S"]

_AXIS_ORDER = ("dp", "pp", "ep", "sp", "tp")  # tp innermost, as the
# reference orders its mesh

_CURRENT = []      # meshes entered with ``with mesh:``, innermost last

#: seconds a collective waits for its peers before it raises
DEFAULT_TIMEOUT_S = 300.0


def init_process_group(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       timeout: float = DEFAULT_TIMEOUT_S):
    """Join the world (the reference's ps-lite rendezvous).

    Arguments not given come from the reference's launcher environment:
    ``coordinator_address`` from ``DMLC_PS_ROOT_URI`` and
    ``DMLC_PS_ROOT_PORT`` (default port 9000; ``tcp://host:port``), the
    world size from ``DMLC_NUM_WORKER`` and this process's rank from
    ``DMLC_WORKER_ID``.  ``coordinator_address`` may also be any
    ``torch.distributed`` init method (``file:///path``, ``tcp://...``).
    ``timeout`` (seconds) bounds every collective of the world."""
    if coordinator_address is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI")
        port = os.environ.get("DMLC_PS_ROOT_PORT", "9000")
        if uri:
            coordinator_address = "%s:%s" % (uri, port)
    if num_processes is None and "DMLC_NUM_WORKER" in os.environ:
        num_processes = int(os.environ["DMLC_NUM_WORKER"])
    if process_id is None and "DMLC_WORKER_ID" in os.environ:
        process_id = int(os.environ["DMLC_WORKER_ID"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise MXTPUError(
            "init_process_group needs a coordinator address, a world size "
            "and a rank (arguments, or DMLC_PS_ROOT_URI/DMLC_PS_ROOT_PORT, "
            "DMLC_NUM_WORKER and DMLC_WORKER_ID)")
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group("gloo", init_method=coordinator_address,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout))


def rank() -> int:
    """This process's rank (the reference's ``kvstore.rank``); 0 outside
    a world."""
    return dist.get_rank() if dist.is_initialized() else 0


def num_workers() -> int:
    """The world's size in processes (``kvstore.num_workers``); 1
    outside a world."""
    return dist.get_world_size() if dist.is_initialized() else 1


class DeviceMesh:
    """The world's ranks on named axes dp/pp/ep/sp/tp.

    Axis sizes of 1 are kept, so sharding rules can always name every
    axis.  ``num_devices`` ranks must form the world (its size equal to
    the mesh's); a mesh of one rank works without a world.  Each axis
    longer than one has ``group(axis)``, this rank's process group along
    it, and ``coord(axis)``, this rank's place on it.  Every rank must
    build its meshes in the same order (``torch.distributed.new_group``
    is collective).  ``with mesh:`` makes it the collectives' default
    (:func:`current_mesh`)."""

    def __init__(self, dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
                 ep: int = 1):
        sizes = {"dp": int(dp), "pp": int(pp), "ep": int(ep),
                 "sp": int(sp), "tp": int(tp)}
        if min(sizes.values()) < 1:
            raise ValueError("mesh axis sizes must be >= 1, got %r" % sizes)
        self.axis_sizes = sizes
        n = self.num_devices
        world = num_workers()
        if n > 1 and world != n:
            raise MXTPUError(
                "mesh dp*tp*sp*pp*ep=%d needs a torch.distributed world of "
                "%d ranks (init_process_group), this one has %d"
                % (n, n, world))
        self._rank = rank() if n > 1 else 0
        shape = tuple(sizes[a] for a in _AXIS_ORDER)
        self._coords = dict(zip(_AXIS_ORDER,
                                _unravel(self._rank, shape)))
        self._groups = {}
        for i, axis in enumerate(_AXIS_ORDER):
            if shape[i] == 1:
                continue
            others = [range(s) if j != i else [0]
                      for j, s in enumerate(shape)]
            for base in itertools.product(*others):
                ranks = []
                for c in range(shape[i]):
                    at = list(base)
                    at[i] = c
                    ranks.append(_ravel(at, shape))
                group = dist.new_group(ranks)     # collective: every rank
                if self._rank in ranks:
                    self._groups[axis] = (group, ranks)

    @property
    def axis_names(self):
        return _AXIS_ORDER

    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    @property
    def num_devices(self) -> int:
        n = 1
        for v in self.axis_sizes.values():
            n *= v
        return n

    @property
    def rank(self) -> int:
        """This process's rank in the world (0 on a one-rank mesh)."""
        return self._rank

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self._coords[axis]

    def group(self, axis: str):
        """This rank's process group along ``axis``; raises on an axis
        of size 1, which has none."""
        if axis not in self._groups:
            raise MXTPUError("mesh axis %r has size %d: no process group"
                             % (axis, self.axis_sizes.get(axis, 0)))
        return self._groups[axis][0]

    def group_ranks(self, axis: str):
        """The world ranks along ``axis`` through this rank, in axis
        order ([this rank] on an axis of size 1)."""
        if axis not in self._groups:
            return [self._rank]
        return list(self._groups[axis][1])

    def __enter__(self):
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.pop()

    def __repr__(self):
        return "DeviceMesh(%s)" % ", ".join(
            "%s=%d" % (a, self.axis_sizes[a]) for a in _AXIS_ORDER)


def current_mesh() -> Optional[DeviceMesh]:
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _CURRENT[-1] if _CURRENT else None


def _unravel(r, shape):
    out = []
    for s in reversed(shape):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


def _ravel(coords, shape):
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
              ep: int = 1) -> DeviceMesh:
    """Build a DeviceMesh; with no arguments every rank of the world goes
    to dp (a one-rank mesh outside a world)."""
    if dp == 1 and tp == 1 and sp == 1 and pp == 1 and ep == 1:
        dp = num_workers()
    return DeviceMesh(dp=dp, tp=tp, sp=sp, pp=pp, ep=ep)
