"""Sharding rules: parameter-name patterns to partition specs (the port
of ``mxtpu/parallel/sharding.py``).

An ordered rule list ``(regex, PartitionSpec)``, first match wins,
default replicate; Megatron's conventions (column-parallel weights split
their output dim on ``"tp"``, row-parallel ones their input dim).  A
:class:`PartitionSpec` is a tuple with one entry a tensor dim: a mesh
axis name, a tuple of names, or None.

The reference hands the specs to GSPMD, which places global arrays; the
port cuts each rank's local slice itself (:meth:`ShardingRules.local`,
:meth:`ShardingRules.shard_params`): rank c of an axis of n keeps chunk
c of n of each split dim.  Two places differ from a plain chunk, both
because GSPMD reshards behind the reference's cut and an explicit
per-rank split must land the data where the local computation reads it:

- **A fused weight splits by group.**  The decoder's ``qkv_weight`` is
  the rows ``[q; k; v]`` under the reference's rule ``P("tp", None)``.
  A contiguous half of those rows would not follow the heads (at
  Llama-3-8B rank 0 would hold 24 of the 32 query heads and no K or V).
  Given the row groups (``groups``: ``(H*D, KV*D, KV*D)``), each group
  is chunked on its own and rank c keeps ``[q_c; k_c; v_c]``: query
  heads ``[c*H/n, (c+1)*H/n)``, KV heads ``[c*KV/n, ...)`` and their V
  rows, in that local order, which is the order a model of H/n and KV/n
  heads reads (and G3's fused int8 V epilogue, whose V columns are the
  last ``KV/n * D``).  The kv-major GQA fold puts every query head with
  its KV head.  The rule keeps the reference's pattern and spec, so
  ``spec_for`` and ``iter_rules`` read the same.
- **An int4 group scale follows its weight's input split.**  A
  row-parallel int4 weight (input dim split) keeps only its own input
  groups, so its ``wscale`` (O, G), replicated on the group axis by
  the rule ``quantize_weights`` adds, is cut on that axis the same way;
  a local input length that is not a whole number of groups raises.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXTPUError

__all__ = ["ShardingRules", "PartitionSpec"]


class PartitionSpec(tuple):
    """``PartitionSpec("tp", None)``: one entry a tensor dim (a mesh axis
    name, a tuple of them, or None for a dim that is not split)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __reduce__(self):
        return (PartitionSpec, tuple(self))

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shards_of(entry, mesh):
    """(shard count, this rank's chunk) of one spec entry on ``mesh``:
    the product of the named axes' sizes, and the row-major position of
    this rank's coordinates on them."""
    n, c = 1, 0
    for a in _axes(entry):
        s = mesh.size(a)
        n, c = n * s, c * s + mesh.coord(a)
    return n, c


class ShardingRules:
    """Ordered (pattern → PartitionSpec) mapping for named parameters."""

    def __init__(self, rules: Optional[Iterable[Tuple[str, tuple]]] = None):
        self._rules: List[Tuple[re.Pattern, PartitionSpec]] = [
            (re.compile(pat), PartitionSpec(*spec))
            for pat, spec in (rules or [])]

    def add(self, pattern: str, spec):
        self._rules.append((re.compile(pattern), PartitionSpec(*spec)))
        return self

    def extend(self, other: "ShardingRules"):
        """Append another ruleset's rules (lower precedence: earlier rules
        win in :meth:`spec_for`'s first-match scan)."""
        self._rules.extend(other._rules)
        return self

    def iter_rules(self) -> List[Tuple[str, PartitionSpec]]:
        """Ordered (pattern string, spec) view of the rule list."""
        return [(pat.pattern, spec) for pat, spec in self._rules]

    def first_match(self, name: str):
        """Index of the winning rule for ``name``, or None when the name
        falls through to the replicate default."""
        for i, (pat, _) in enumerate(self._rules):
            if pat.search(name):
                return i
        return None

    def __len__(self):
        return len(self._rules)

    def spec_for(self, name: str, ndim: int) -> PartitionSpec:
        for pat, spec in self._rules:
            if pat.search(name):
                if len(spec) > ndim:
                    raise ValueError(
                        f"rule {pat.pattern} spec {spec} has more axes than "
                        f"param {name} (ndim={ndim})")
                return spec
        return PartitionSpec()  # replicate

    def split_dims(self, name, ndim, mesh):
        """[(dim, shard count, this rank's chunk)] of every dim of
        ``name`` the rules split over more than one shard on ``mesh``."""
        out = []
        for d, entry in enumerate(self.spec_for(name, ndim)):
            n, c = shards_of(entry, mesh)
            if n > 1:
                out.append((d, n, c))
        return out

    def local(self, name, arr, mesh, groups=None, split_k=None):
        """This rank's slice of the whole tensor ``arr`` (numpy or torch)
        named ``name`` (module docstring): ``groups`` the row groups of a
        fused weight, ``split_k`` the (shard count, chunk) of a
        row-parallel int4 weight whose group scales this is."""
        if torch.is_tensor(arr):
            t = arr
        else:
            a = np.ascontiguousarray(arr)
            t = torch.from_numpy(a if a.flags.writeable else a.copy())
        cuts = self.split_dims(name, t.dim(), mesh)
        if split_k is not None and t.dim() == 2:
            cuts.append((1,) + tuple(split_k))
        for d, n, c in cuts:
            size = t.shape[d]
            if d == 0 and groups is not None:
                if sum(groups) != size or any(g % n for g in groups):
                    raise MXTPUError(
                        "parameter %s: its row groups %s do not split over "
                        "%d shards" % (name, tuple(groups), n))
                parts, at = [], 0
                for g in groups:
                    parts.append(t.narrow(0, at + c * (g // n), g // n))
                    at += g
                t = torch.cat(parts, 0)
                continue
            if size % n:
                raise MXTPUError(
                    "parameter %s: dim %d of %d does not split over %d "
                    "shards" % (name, d, size, n))
            t = t.narrow(d, c * (size // n), size // n)
        # a copy of its own, so the whole tensor is not kept alive
        return t.clone(memory_format=torch.contiguous_format) if cuts else t

    def shard_params(self, named, mesh, groups=None):
        """``{name: this rank's slice}`` of the whole tensors ``named``:
        ``groups`` maps the names of fused weights to their row groups;
        an int4 ``wscale`` whose weight (``..._weight`` beside it in
        ``named``) is split on its input dim is cut with it."""
        groups = groups or {}
        out = {}
        for name, arr in named.items():
            split_k = None
            if name.endswith("wscale"):
                wname = name[:-len("wscale")] + "weight"
                if wname in named:
                    split_k = int4_scale_split(self, wname, named[wname],
                                               arr, mesh)
            out[name] = self.local(name, arr, mesh, groups.get(name),
                                   split_k)
        return out

    def __repr__(self):
        return "ShardingRules(%s)" % ", ".join(
            f"{p.pattern!r}→{s}" for p, s in self._rules)


def int4_scale_split(rules, wname, weight, wscale, mesh):
    """(shard count, chunk) to cut the group axis of an int4 weight's
    scales ``wscale`` (O, G) by, where ``weight`` (O, K/2 packed) is
    split on its input dim; None for any other weight.  Raises where a
    group would straddle two shards."""
    if len(wscale.shape) != 2 or weight.dtype not in (np.int8, torch.int8):
        return None
    cut = [(n, c) for d, n, c in rules.split_dims(wname, 2, mesh) if d == 1]
    if not cut:
        return None
    n, c = cut[0]
    K = 2 * weight.shape[1]
    G = wscale.shape[1]
    if G % n:
        raise MXTPUError(
            "int4 weight %s: its local input length %s over %d shards is not "
            "a whole number of its groups of %d (K=%d, %d groups): a group "
            "would straddle two shards; pick a group_size that divides "
            "K/%d" % (wname, K / n, n, K // G, K, G, n))
    return n, c
