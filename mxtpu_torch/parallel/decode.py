"""Sharded decode (the port of ``mxtpu/parallel/decode.py``'s
``ShardedDecoder``): a port ``TransformerLM`` over a tensor-parallel mesh,
and the one seam through which the serving engines reach the model.

The reference compiles each decode program once for the whole mesh and
runs it from one controller.  The port is one process a rank, so the
decoder keeps the reference's one controller: rank 0 of the ``tp`` axis
runs the caller (an engine with its scheduler, allocator, prefix index,
sampler, clocks, deadlines, fault plans, tracer and flight recorder, or
a ``generate`` loop), and every model call it makes through the decoder
is broadcast (the call's name and its host arguments: token ids, block
tables, positions, page ids, source lanes, tree masks) to the other
ranks, which run :meth:`ShardedDecoder.follow` and make the same call on
their shard and their own caches.  Wall-clock deadlines, injected faults
and sampling therefore cannot send the ranks down different branches
(an engine on every rank would deadlock the first time a deadline fired
on one rank and not another), and there is one trace and one flight
record, as in the reference.  The cost is one small broadcast a model
call.

Each rank's model is sharded in place by the rules
(``TransformerLM.shard``): the fused qkv by head group, its pools hold
only its KV heads (``cache_spec``'s head split), and its K1/K2 launches
run on those heads inside :func:`~mxtpu_torch.ops.partition.
head_sharding_scope`.  Caches, pools, host page buffers and weight
leaves that a call makes stay on the rank that made them; rank 0 hands
the caller its own and names the others' by a handle in later calls
(dropped on every rank once rank 0's object is collected).

On a mesh whose ``tp`` axis is 1 the decoder calls the model directly:
no process group, no broadcast, no head scope, no timing, the model
untouched.

A weight hot-swap (``prepare_adoption``) sends no weights: rank 0 sends
the checkpoint's path, and each rank reads the file and keeps its own
shard.

Not ported: a ``cache_spec`` other than the head split (the reference's
replicated ``PartitionSpec()``), and meshes with another axis above 1
(ROADMAP A6's leftovers); both raise.
"""

from __future__ import annotations

import os
import pickle
import time
import weakref

import numpy as np
import torch
import torch.distributed as dist

from .. import base
from ..base import MXTPUError
from ..ops.partition import head_sharding_scope
from . import collectives
from .mesh import DeviceMesh
from .sharding import PartitionSpec as P, ShardingRules

__all__ = ["ShardedDecoder", "DEFAULT_CACHE_SPEC"]

#: the pools' (N, KV, bs, D) split: KV heads over "tp"
DEFAULT_CACHE_SPEC = P(None, "tp", None, None)

# the model calls the engines and generate make, and those whose result
# stays on each rank under a handle (caches, pools, host page buffers,
# weight leaves)
_SEAM = ("init_cache", "prefill", "write_cache_slot", "step_slots",
         "verify_slots", "permute_cache_span", "init_block_pool",
         "step_pages", "verify_pages", "prefill_pages", "copy_block",
         "permute_pool_span", "read_pages", "write_pages",
         "prepare_adoption", "install_leaves", "_live_param_leaves",
         "generate", "gathered_params")
_MAKES = frozenset({"init_cache", "init_block_pool", "read_pages",
                    "prepare_adoption", "_live_param_leaves"})


class _Held(list):
    """A rank-local result rank 0 names by handle (a list, so it can be
    weakly referenced)."""


class _Ref:
    __slots__ = ("h",)

    def __init__(self, h):
        self.h = h


class _Tensor:
    """A tensor argument in a message: its host copy, and whether it
    lives on the rank's device."""
    __slots__ = ("t", "dev")

    def __init__(self, t, dev):
        self.t, self.dev = t, dev


class _Channel:
    """The controller's call stream over one mesh's ``tp`` group: one
    fixed-size broadcast a call (a second one only for a long message),
    the handle table of rank-local results, and the decoders and models
    built over the mesh, in order."""

    HEAD = 8192             # bytes broadcast with every call

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.group("tp")
        self.src = mesh.group_ranks("tp")[0]
        self.controller = mesh.coord("tp") == 0
        self.next = 0
        self.objects = {}           # handle -> local object (followers)
        self.handles = {}           # id(object) -> handle (controller)
        self.released = []
        self.in_flight = []         # (event, pinned buffer) on followers
        self.decoders = []
        self.models = []
        self.calls = 0
        self.seconds = 0.0
        self.bytes = 0
        self.local = {}             # call name -> [calls, seconds] here

    # -- transport ---------------------------------------------------------
    def send(self, msg):
        t0 = time.perf_counter()
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        n, cap = len(data), self.HEAD - 8
        head = np.zeros(self.HEAD, np.uint8)
        head[:8] = np.frombuffer(np.int64(n).tobytes(), np.uint8)
        head[8:8 + min(n, cap)] = np.frombuffer(data[:cap], np.uint8)
        dist.broadcast(torch.from_numpy(head), self.src, group=self.group)
        if n > cap:
            rest = np.frombuffer(data[cap:], np.uint8).copy()
            dist.broadcast(torch.from_numpy(rest), self.src,
                           group=self.group)
        self.calls += 1
        self.bytes += n
        self.seconds += time.perf_counter() - t0

    def recv(self):
        head = torch.empty(self.HEAD, dtype=torch.uint8)
        dist.broadcast(head, self.src, group=self.group)
        raw = head.numpy()
        n, cap = int(raw[:8].view(np.int64)[0]), self.HEAD - 8
        data = raw[8:8 + min(n, cap)].tobytes()
        if n > cap:
            rest = torch.empty(n - cap, dtype=torch.uint8)
            dist.broadcast(rest, self.src, group=self.group)
            data += rest.numpy().tobytes()
        return pickle.loads(data)

    # -- arguments and results ---------------------------------------------
    def encode(self, x):
        h = self.handles.get(id(x))
        if h is not None:
            return _Ref(h)
        if torch.is_tensor(x):
            return _Tensor(x.detach().cpu(), x.device.type != "cpu")
        if isinstance(x, (list, tuple)):
            return type(x)(self.encode(v) for v in x)
        if isinstance(x, dict):
            return {k: self.encode(v) for k, v in x.items()}
        return x

    def decode(self, x, device):
        if isinstance(x, _Ref):
            return self.objects[x.h]
        if isinstance(x, _Tensor):
            return x.t.to(device) if x.dev else x.t
        if isinstance(x, (list, tuple)):
            return type(x)(self.decode(v, device) for v in x)
        if isinstance(x, dict):
            return {k: self.decode(v, device) for k, v in x.items()}
        return x

    def register(self, name, out):
        """Give a call's rank-local result its handle (the same number on
        every rank: every rank makes the same calls in the same order)."""
        if name not in _MAKES:
            return out
        if isinstance(out, (list, tuple)):
            out = _Held(out)
        h = self.next
        self.next += 1
        if self.controller:
            key = id(out)
            self.handles[key] = h
            weakref.finalize(out, self._drop, key, h)
        else:
            self.objects[h] = out
        return out

    def _drop(self, key, h):
        self.handles.pop(key, None)
        self.released.append(h)

    def take_released(self):
        out, self.released = self.released, []
        return out

    def release(self, handles):
        """Drop the followers' objects rank 0 has dropped; a pinned host
        buffer is kept until an event after its last copy completes."""
        self.in_flight = [(e, b) for e, b in self.in_flight if not e.query()]
        for h in handles:
            obj = self.objects.pop(h, None)
            if torch.is_tensor(obj) and obj.is_pinned():
                ev = torch.cuda.Event()
                ev.record()
                self.in_flight.append((ev, obj))


def _channel(mesh):
    ch = getattr(mesh, "_tp_channel", None)
    if ch is None:
        ch = mesh._tp_channel = _Channel(mesh)
    return ch


class ShardedDecoder:
    """A port ``TransformerLM`` over a mesh with tp-sharded parameters.

    Parameters
    ----------
    block : a port ``TransformerLM`` (the whole model, on this rank's
        device; at tp > 1 it is sharded in place).
    mesh : a :class:`~mxtpu_torch.parallel.mesh.DeviceMesh` (None: one
        rank).  Every axis but ``tp`` must be 1.
    rules : :class:`~mxtpu_torch.parallel.sharding.ShardingRules` (None:
        replicate everything).
    cache_spec : the pools' partition spec; only the default, KV heads
        over ``"tp"``, is ported.

    Rank 0 of the tp axis calls the methods (the model's: ``generate``
    and the engines' cache and pool forms); the other ranks call
    :meth:`follow`.  :meth:`shutdown` on rank 0 releases them.
    """

    def __init__(self, block, mesh: DeviceMesh = None,
                 rules: ShardingRules = None, cache_spec=DEFAULT_CACHE_SPEC,
                 _follower=False):
        self._block = block
        self._mesh = mesh if mesh is not None else DeviceMesh()
        self._rules = rules if rules is not None else ShardingRules()
        self._cache_spec = P(*cache_spec)
        attn = block.layers[0].attn
        n0 = block.tp_size
        self._heads = attn.heads * n0
        self._kv_heads = attn.kv_heads * n0
        sizes = self._mesh.axis_sizes
        self.tp = sizes["tp"]
        if self._cache_spec != DEFAULT_CACHE_SPEC:
            raise MXTPUError(
                "ShardedDecoder: cache_spec %r is not ported: the port's "
                "pools split their KV heads over 'tp' (%r); a replicated or "
                "other cache layout is among ROADMAP A6's leftovers"
                % (tuple(self._cache_spec), tuple(DEFAULT_CACHE_SPEC)))
        if any(v > 1 for a, v in sizes.items() if a != "tp"):
            raise MXTPUError(
                "ShardedDecoder: %r has an axis other than tp above 1; the "
                "port serves over tp alone (dp, pp, sp and ep meshes are "
                "among ROADMAP A6/A7's leftovers)" % (self._mesh,))
        self._validate_kv_sharding()
        self._has_moe = None
        self._ch = None
        if self.tp == 1:
            return
        ch = _channel(self._mesh)
        block.shard(self._mesh, self._rules)
        if ch.controller and not _follower:
            if not any(m is block for m in ch.models):
                ch.models.append(block)
            idx = next(i for i, m in enumerate(ch.models) if m is block)
            ch.send((None, "_new", (idx, self._rules, self._cache_spec), {},
                     ch.take_released()))
        self._idx = len(ch.decoders)
        ch.decoders.append(self)
        self._ch = ch

    def _validate_kv_sharding(self):
        """The head split must divide every attention's KV heads (the
        reference's check and error text)."""
        spec = self._cache_spec
        axes = ()
        if len(spec) > 1 and spec[1] is not None:
            axes = spec[1] if isinstance(spec[1], tuple) else (spec[1],)
        shards = 1
        for a in axes:
            shards *= self._mesh.axis_sizes.get(a, 1)
        if shards <= 1:
            return
        for i, layer in enumerate(self._block.layers):
            kv = layer.attn.kv_heads * self._block.tp_size
            if kv % shards != 0:
                raise ValueError(
                    "KV cache sharding %r splits the %d kv heads of "
                    "block %r over %d shards, which does not divide "
                    "evenly — this would fail inside GSPMD at the first "
                    "decode step.  Use a model whose num_kv_heads is "
                    "divisible by the tp axis, or pass "
                    "cache_spec=PartitionSpec() to replicate the caches."
                    % (tuple(spec), kv, "layers.%d.attn" % i, shards))

    def _block_has_moe(self):
        """Whether the model routes through experts (a ``SwitchMoE``
        anywhere in it), computed once.  The engines then opt out of
        prefill bucketing (padded tokens would join the routing), prefix
        sharing and the hierarchical cache (capacity budgets from the
        whole prompt, so a prefix's K/V depends on its suffix) and
        speculation (a window's routing is not the steps')."""
        if self._has_moe is None:
            from ..models.moe import SwitchMoE

            self._has_moe = any(isinstance(m, SwitchMoE)
                                for m in self._block.modules())
        return self._has_moe

    @property
    def device(self):
        return self._block.device

    def broadcast_stats(self):
        """The controller's call stream so far: calls, seconds spent
        sending them, payload bytes (zeros at tp = 1)."""
        ch = self._ch
        if ch is None:
            return {"calls": 0, "seconds": 0.0, "bytes": 0}
        return {"calls": ch.calls, "seconds": ch.seconds, "bytes": ch.bytes}

    # -- the calls ----------------------------------------------------------
    def _model_call(self, name, args, kwargs):
        if name == "write_pages":
            pools, pages, host = args[:3]
            start = args[3] if len(args) > 3 else kwargs.get("start", 0)
            return self._block.write_pages(pools, pages,
                                           host[start:start + len(pages)])
        return getattr(self._block, name)(*args, **kwargs)

    def _local(self, name, args, kwargs):
        """Make one call on this rank's shard at tp > 1, inside its head
        scope, its host seconds kept (:meth:`rank_report`)."""
        t0 = time.perf_counter()
        c0 = collectives.stats()["seconds"]
        with head_sharding_scope(self._mesh, self._cache_spec[1],
                                 self._heads, self._kv_heads):
            out = self._model_call(name, args, kwargs)
        rec = self._ch.local.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += time.perf_counter() - t0
        rec[2] += collectives.stats()["seconds"] - c0
        return out

    def _report(self, reset, timing=None):
        """This rank's part of :meth:`rank_report`."""
        ch, m = self._ch, self._block
        out = dict(rank=self._mesh.rank, counts=base.counts(),
                   calls={k: list(v) for k, v in ch.local.items()},
                   collectives=collectives.stats(reset),
                   heads=m.layers[0].attn.heads,
                   kv_heads=m.layers[0].attn.kv_heads,
                   peak_bytes=(torch.cuda.max_memory_allocated(m.device)
                               if m.device.type == "cuda" else 0))
        if reset:
            base.reset_counts()
            ch.local.clear()
            if m.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(m.device)
        if timing is not None:
            collectives.timing(timing)
        return out

    def rank_report(self, reset=False, timing=None):
        """Every rank's record, in rank order (on rank 0; a collective of
        the tp axis): its kernels' launch counts, its calls' host
        seconds by name, its collectives' seconds (``parallel.
        collectives.stats``), its attention's local head counts and its
        peak device memory; ``reset`` zeroes them all after reading, and
        ``timing`` (True or False) then turns ``parallel.collectives.
        timing`` on or off on every rank.  One rank: ``[]``."""
        ch = self._ch
        if ch is None:
            return []
        ch.send((self._idx, "_report", (bool(reset), timing), {},
                 ch.take_released()))
        return self._gather_report(bool(reset), timing)

    def _gather_report(self, reset, timing=None):
        out = [None] * self.tp
        dist.all_gather_object(out, self._report(reset, timing),
                               group=self._ch.group)
        return out

    def _controller(self):
        """The channel at tp > 1 (None at tp = 1); raises off rank 0."""
        ch = self._ch
        if ch is not None and not ch.controller:
            raise MXTPUError("ShardedDecoder: rank %d is not the controller "
                             "of its tp axis; it runs follow()"
                             % self._mesh.rank)
        return ch

    def _call(self, name, args, kwargs):
        ch = self._controller()
        if ch is None:
            return self._model_call(name, args, kwargs)
        ch.send((self._idx, name, ch.encode(args), ch.encode(kwargs),
                 ch.take_released()))
        return ch.register(name, self._local(name, args, kwargs))

    def generate(self, prompt_ids, max_new_tokens, max_length=None,
                 temperature=0.0, top_k=0, top_p=0.0, repetition_penalty=1.0,
                 seed=None, cache_dtype=None):
        """``TransformerLM.generate`` over the mesh (same arguments, same
        result).  A sampled call without a seed draws one on rank 0."""
        if temperature and temperature > 0.0 and seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        return self._call("generate", (prompt_ids, max_new_tokens),
                          dict(max_length=max_length,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p,
                               repetition_penalty=repetition_penalty,
                               seed=seed, cache_dtype=cache_dtype))

    def prepare_adoption(self, named, path=None):
        """``TransformerLM.prepare_adoption`` on every rank's shard.  At
        tp > 1 no array crosses the channel: rank 0 slices its shard
        from ``named`` (the checkpoint it has read and verified; a
        mismatch raises here, before another rank hears of it) and sends
        ``path``, the checkpoint's file, from which every other rank
        reads its own copy and slices its own shard.  The file must be
        readable from every rank (one host, or a shared filesystem)."""
        ch = self._controller()
        if ch is None:
            return self._block.prepare_adoption(named)
        if path is None:
            raise MXTPUError("ShardedDecoder.prepare_adoption at tp > 1 "
                             "needs path=, the checkpoint's file, from "
                             "which each rank reads its own shard")
        out = self._local("prepare_adoption", (named,), {})
        ch.send((self._idx, "_adopt", (os.path.abspath(path),), {},
                 ch.take_released()))
        return ch.register("prepare_adoption", out)

    def write_pages(self, pools, pages, host, start=0):
        """``TransformerLM.write_pages`` of rows ``start ..
        start + len(pages)`` of the host buffer ``host`` (each rank's own
        buffer of its heads, from :meth:`read_pages`)."""
        return self._call("write_pages", (pools, pages, host, start), {})

    # -- the other ranks ------------------------------------------------------
    @staticmethod
    def follow(mesh, *models):
        """Run on every rank of the tp axis but rank 0: make each call
        rank 0 makes, on this rank's shard, until rank 0's
        :meth:`shutdown`.  ``models`` are this rank's whole models in
        the order rank 0 first built a decoder over each (an engine
        builds its target's, then its draft's).  A lost controller
        raises out of the broadcast."""
        ch = _channel(mesh)
        if ch.controller:
            raise MXTPUError("follow() runs on the ranks other than rank 0 "
                             "of the tp axis")
        while True:
            idx, name, args, kwargs, released = ch.recv()
            ch.release(released)
            if name == "_stop":
                return
            if name == "_new":
                mi, rules, cache_spec = args
                ShardedDecoder(models[mi], mesh, rules, cache_spec,
                               _follower=True)
                continue
            if name == "_report":
                ch.decoders[idx]._gather_report(*args)
                continue
            if name == "_adopt":
                leaves = ch.decoders[idx]._local(
                    "prepare_adoption", (_checkpoint_params(args[0]),), {})
                ch.register("prepare_adoption", leaves)
                continue
            dec = ch.decoders[idx]
            dev = dec.device
            out = dec._local(name, ch.decode(args, dev),
                             ch.decode(kwargs, dev))
            ch.register(name, out)

    @staticmethod
    def shutdown(mesh):
        """On rank 0: release the other ranks from :meth:`follow`."""
        ch = getattr(mesh, "_tp_channel", None)
        if ch is not None and ch.controller:
            ch.send((None, "_stop", (), {}, ch.take_released()))
            mesh._tp_channel = None


def _checkpoint_params(path):
    """The ``{name: array}`` of a checkpoint file: a pickle of
    ``{"params": {...}, ...}`` or of the mapping itself (the engines'
    ``adopt``, which has verified the file on rank 0)."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    named = blob.get("params", blob) if isinstance(blob, dict) else None
    if not isinstance(named, dict):
        raise MXTPUError("checkpoint %s is not a params mapping (got %s)"
                         % (path, type(blob).__name__))
    return named


def _seam(name):
    def call(self, *args, **kwargs):
        return self._call(name, args, kwargs)
    call.__name__ = name
    call.__doc__ = ("``TransformerLM.%s`` on every rank's shard (the "
                    "module docstring)." % name)
    return call


for _name in _SEAM:
    if _name not in ShardedDecoder.__dict__:
        setattr(ShardedDecoder, _name, _seam(_name))
del _name
