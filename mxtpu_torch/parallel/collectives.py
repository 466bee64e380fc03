"""The collective verbs over one mesh axis (the port of
``mxtpu/parallel/collectives.py``).

The reference's verbs are XLA collectives inside ``shard_map``, named by
``axis_name``.  The port has no ``shard_map``: each verb is an eager
call on the axis's ``torch.distributed`` process group
(:meth:`DeviceMesh.group`), on this rank's local tensor, with the
reference's semantics (``tiled`` gathers and scatters concatenate on
``axis``).  The mesh is the ``mesh=`` argument, else the innermost one
entered with ``with mesh:``.  On an axis of size 1 every verb returns
its input as it is.

- :func:`all_reduce` gathers every rank's tensor and reduces them in
  rank order, so the order of a sum is the same for every element
  whatever the buffer's length (a ring all-reduce splits its buffer
  into chunks by length, so a verify window's rows would be summed in
  another order than a decode step's).  Float inputs below float32 are
  summed in float32 and rounded once to their dtype.
- :func:`all_gather`, :func:`broadcast` and :func:`all_to_all` map onto
  ``all_gather``, ``broadcast`` and ``all_to_all_single``;
  :func:`reduce_scatter` is :func:`all_reduce` then this rank's chunk,
  and :func:`ppermute` a gather then the source's slice (zeros where
  this rank receives nothing, as ``lax.ppermute``).

CUDA tensors.  The world's backend is gloo (:func:`~mxtpu_torch.
parallel.mesh.init_process_group`), the one that runs two ranks on one
card and on the CPU.  In PyTorch 2.11 gloo takes CUDA tensors for
``all_gather``, ``broadcast`` and ``all_to_all_single``, the three
primitives the verbs use (probed on the H100), so every verb hands its
CUDA tensor to gloo as it is; the compute stays on the card.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..base import MXTPUError
from .mesh import current_mesh

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "ppermute",
           "all_to_all", "broadcast", "barrier", "timing", "stats"]


_STATS = {"calls": 0, "seconds": 0.0}
_TIMED = [False]


def timing(on=True):
    """Time every primitive from here on (or stop): the card is
    synchronized before and after each, so its seconds are the
    collective's alone (:func:`stats`)."""
    _TIMED[0] = bool(on)


def stats(reset=False):
    """{"calls", "seconds"} of the primitives timed so far."""
    out = dict(_STATS)
    if reset:
        _STATS.update(calls=0, seconds=0.0)
    return out


def _run(primitive, x, *args, **kwargs):
    """One ``torch.distributed`` primitive on ``x`` (timed under
    :func:`timing`)."""
    if not _TIMED[0]:
        return primitive(*args, **kwargs)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out = primitive(*args, **kwargs)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    _STATS["calls"] += 1
    _STATS["seconds"] += time.perf_counter() - t0
    return out


def _axis(axis_name, mesh):
    """(group, size, this rank's coordinate, group ranks) of one axis."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise MXTPUError("collective over %r outside a mesh: pass mesh= or "
                         "enter one (with mesh:)" % (axis_name,))
    n = mesh.size(axis_name)
    if n == 1:
        return None, 1, 0, mesh.group_ranks(axis_name)
    return (mesh.group(axis_name), n, mesh.coord(axis_name),
            mesh.group_ranks(axis_name))


def _gather_list(x, group, n):
    """Every rank's ``x`` (same shape), in rank order."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(n)]
    _run(dist.all_gather, x, out, x, group=group)
    return out


def all_reduce(x, axis_name: str, op: str = "sum", mesh=None):
    """sum, mean, max or min of ``x`` over the axis, the same tensor on
    every rank.  Sums run in rank order (module docstring), in float32
    for float inputs narrower than that."""
    group, n, _, _ = _axis(axis_name, mesh)
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError("unsupported all_reduce op %r" % op)
    if n == 1:
        return x
    parts = _gather_list(x, group, n)
    if op in ("max", "min"):
        f = torch.maximum if op == "max" else torch.minimum
        acc = parts[0]
        for p in parts[1:]:
            acc = f(acc, p)
        return acc
    wide = x.is_floating_point() and x.element_size() < 4
    acc = parts[0].float() if wide else parts[0].clone()
    for p in parts[1:]:
        acc += p.float() if wide else p
    if op == "mean":
        acc = acc / n
    return acc.to(x.dtype)


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = True,
               mesh=None):
    """Every rank's ``x`` concatenated on ``axis`` in rank order
    (``tiled``), or stacked on a new leading ``axis``."""
    group, n, _, _ = _axis(axis_name, mesh)
    if n == 1:
        return x if tiled else x.unsqueeze(axis)
    parts = _gather_list(x, group, n)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)


def reduce_scatter(x, axis_name: str, axis: int = 0, mesh=None):
    """The sum over the axis, scattered: rank c keeps chunk c of
    ``axis`` (its length must divide by the axis size)."""
    _, n, c, _ = _axis(axis_name, mesh)
    if x.shape[axis] % n:
        raise MXTPUError("reduce_scatter: axis %d of %s does not divide "
                         "over %d ranks" % (axis, tuple(x.shape), n))
    total = all_reduce(x, axis_name, "sum", mesh)
    return total.chunk(n, dim=axis)[c].contiguous()


def ppermute(x, axis_name: str, perm, mesh=None):
    """``x`` sent along ``perm``, pairs (source, destination) of axis
    coordinates: this rank gets its source's tensor, zeros if none."""
    _, n, c, _ = _axis(axis_name, mesh)
    src = [s for s, d in perm if d == c]
    if n == 1:
        return x.clone() if src else torch.zeros_like(x)
    parts = all_gather(x, axis_name, 0, tiled=False, mesh=mesh)
    return parts[src[0]].clone() if src else torch.zeros_like(x)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int,
               mesh=None):
    """``x`` split into n chunks on ``split_axis``, chunk j sent to rank
    j, the received chunks concatenated on ``concat_axis`` in rank
    order (``lax.all_to_all(tiled=True)``)."""
    group, n, _, _ = _axis(axis_name, mesh)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise MXTPUError("all_to_all: axis %d of %s does not divide over "
                         "%d ranks" % (split_axis, tuple(x.shape), n))
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    _run(dist.all_to_all_single, x, recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=concat_axis)


def broadcast(x, axis_name: str, src: int = 0, mesh=None):
    """Coordinate ``src``'s ``x`` on every rank of the axis (in place on
    ``x``, which is also returned)."""
    group, n, _, ranks = _axis(axis_name, mesh)
    if n == 1:
        return x
    _run(dist.broadcast, x, x, ranks[src], group=group)
    return x


def barrier(axis_name: str = None, mesh=None):
    """Block until every rank of the axis (of the world, without one)
    gets here (the reference's kvstore barrier)."""
    if axis_name is None:
        if dist.is_initialized():
            dist.barrier()
        return
    group, n, _, _ = _axis(axis_name, mesh)
    if n > 1:
        dist.barrier(group=group)
