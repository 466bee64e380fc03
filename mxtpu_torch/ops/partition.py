"""The head-sharding scope of the paged kernels (the port of
``mxtpu/ops/pallas/partition.py``).

Under tensor parallelism each rank's page pools hold only its KV heads
and its queries only the query heads of those (the kv-major GQA fold
keeps query head h = kv*rep + r beside its KV head, so a contiguous
split of the heads needs no traffic inside attention).  The
``ShardedDecoder`` opens :func:`head_sharding_scope` around every model
call it makes at tp > 1, naming the mesh axes that split the pools' KV
axis (``cache_spec[1]``) and the model's whole head counts; the K1 and
K2 wrappers (``ops.paged_attention``, ``ops.prefill_attention``) read
:func:`current_head_sharding` and refuse (:func:`check_head_shard`) a
call whose pools do not hold ``KV / shards`` heads or whose queries do
not hold ``H / shards``.

The reference's ``head_shard_map`` has no counterpart: it wraps a
single-controller ``pallas_call`` in ``shard_map`` so each device runs
the kernel on its heads; here each rank is its own process and already
holds its shard, so the kernel simply runs on what it is given.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

from ..base import MXTPUError

__all__ = ["HeadSharding", "head_sharding_scope", "current_head_sharding",
           "check_head_shard"]

_SCOPE = []


class HeadSharding(NamedTuple):
    """An active scope: the mesh, the axes that split the KV heads, the
    shard count, and the model's whole query and KV head counts (None
    where not given)."""
    mesh: object
    axes: tuple
    shards: int
    heads: Optional[int]
    kv_heads: Optional[int]


@contextlib.contextmanager
def head_sharding_scope(mesh, axes, heads=None, kv_heads=None):
    """Declare, for the block, that the page pools' KV-heads axis is
    split over mesh ``axes`` (a name or a tuple of names); a scope that
    resolves to one shard is recorded as inactive."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    shards = 1
    sizes = getattr(mesh, "axis_sizes", None) or {}
    for a in axes:
        shards *= int(sizes.get(a, 1))
    entry = None
    if axes and shards > 1:
        entry = HeadSharding(mesh, axes, shards, heads, kv_heads)
    _SCOPE.append(entry)
    try:
        yield entry
    finally:
        _SCOPE.pop()


def current_head_sharding() -> Optional[HeadSharding]:
    """The innermost active scope, or None when unscoped or one shard."""
    return _SCOPE[-1] if _SCOPE else None


def check_head_shard(name, q_heads, kv_heads):
    """Raise unless a kernel call at ``q_heads`` query heads over pools of
    ``kv_heads`` heads is this rank's shard of the active scope."""
    hs = current_head_sharding()
    if hs is None:
        return
    want_q = None if hs.heads is None else hs.heads // hs.shards
    want_kv = None if hs.kv_heads is None else hs.kv_heads // hs.shards
    if (want_q is not None and q_heads != want_q) or \
            (want_kv is not None and kv_heads != want_kv):
        raise MXTPUError(
            "%s: the heads are split over %d shards (%s), so a rank holds "
            "%s query heads and %s KV heads; this call has %d and %d"
            % (name, hs.shards, "x".join(hs.axes), want_q, want_kv,
               q_heads, kv_heads))
