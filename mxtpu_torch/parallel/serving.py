"""Continuous batching (the port of ``ContinuousBatchingEngine`` and
``PagedContinuousBatchingEngine`` from ``mxtpu/parallel/serving.py``).

Both engines keep ``num_slots`` pool rows and run one scheduler
iteration a ``step()``: admissions into free rows, then ONE pooled
decode step over every decoding row and sampling — or, where
speculation drafted tokens, ONE pooled verify call.

- :class:`ContinuousBatchingEngine` keeps a contiguous cache row a slot
  (``TransformerLM.init_cache(num_slots, max_length)``).  Admission
  prefills the whole prompt (padded to the power-of-two ladder, as the
  reference pads it) into a scratch cache and copies it into the row
  (``write_cache_slot``); decode runs ``step_slots``, verification
  ``verify_slots`` and the tree fix-up ``permute_cache_span``.  The slot
  path's attention is plain PyTorch, as the reference computes it in
  XLA.
- :class:`PagedContinuousBatchingEngine`, its subclass, keeps one pool
  of ``num_blocks`` fixed-size pages a layer: a request holds
  ceil(need / block_size) pages listed in its block table, page 0 being
  the null page that absorbs dead-lane writes.  An iteration first runs
  one prefill chunk for every slot still prefilling, then admits: a
  radix prefix lookup shares the full prompt pages another request
  already computed (refcounted, never recomputed), the partially
  matching page at the divergence is cloned copy-on-write, pages are
  allocated, and the first chunk runs at once; a request that cannot
  get its pages now waits at the queue head (FIFO kept).  Decode runs
  ``step_pages`` (K1), verification ``verify_pages`` (K1's window or
  tree mask) and prefill ``prefill_pages`` (K2).  The chunk plan, the
  table width and the allocation order are the reference's, so page
  ids and written positions match the JAX engine's step for step.  It
  overrides the decode hooks (``_decode_state``, ``_run_step``,
  ``_run_verify``, ``_run_verify_tree``, ``_run_fixup``) and the
  admission; the scheduler, the sampling and the speculation are the
  base class's.

The first token of a request comes from the last real logit row of its
prefill, and sampled requests draw from their own ``torch.Generator``
seeded after prefill, so an engine stream equals the port's isolated
``TransformerLM.generate`` with the same seed.

Unlike the reference, which threads new caches through every compiled
program, caches and pools are updated IN PLACE.  For the paged pool two
orderings follow: the copy-on-write clone runs before the first chunk's
own writes, and a shared prefix page is never written (the allocator
hands a request only pages it owns alone for every position it writes).

Speculative decoding (``spec_k > 0`` and/or ``spec_tree``): a host-side
n-gram drafter proposes up to ``spec_k`` tokens per slot from the
request's own prompt and output (``NGramDrafter``), or a small tree of
alternatives (``TreeDrafter``; ``spec_tree=None`` reads
``MXTPU_SPEC_TREE``); or, with ``draft_block``, a small dense draft
``TransformerLM`` proposes them greedily from its own contiguous slot
cache (``j + 1`` pooled ``step_slots`` calls for j drafts, so a fully
accepted window leaves no gap in the draft cache, whose rows mirror the
target's row and position).  ONE pooled verify call scores every slot's
window (lane w at pos + w) or tree (lane w on its own root-to-node
path).  Each window position is drawn with the rule and the draw
sequential decode would use there — greedy, penalized with the window's
earlier tokens, or from the request's generator peeked ahead
(``sampler.future_states``) and advanced by the tokens emitted — and a
slot emits its longest matching prefix plus one, so every stream equals
its non-speculative stream.  Rejected lanes stay in the cache past the
slot's position, behind every later mask; rollback is a host position
fix-up.  A tree whose accepted path took a side branch moves that
path's K/V into depth order before the next step reads it.

``cache_dtype="int8"`` (or ``MXTPU_CACHE_DTYPE=int8``) stores the caches
as int8 payloads with one float32 scale per head and position; every
write quantizes per row, so the streams are those of the model's
isolated ``generate(cache_dtype="int8")``.  The engines keep the status
of the last ``max(history, 2 * num_slots)`` finished requests.

Failure paths (both engines, the reference's contract): an exception in
a per-request path — admission and its prefill chunks, the fault sites
``serving.admit``, ``serving.step``, ``serving.draft`` and
``serving.verify`` (``mxtpu_torch.resilience.faults``), the paged
engine's ``serving.prefix_lookup``, ``serving.block_alloc`` and
``serving.swap_in``, the per-slot eos read — quarantines only that
request: its row is scrubbed (the paged engine releases its pages) and
it re-queues from scratch while it has ``retries`` left, else finishes
``failed`` with its partial output and an error record (``error``).
Every other stream is untouched: each request draws from its own
generator and penalty row.  ``deadline_s`` evicts a request at the next
iteration boundary as ``expired`` (the engine's ``clock``), and
``max_pending`` bounds the queue with a typed
:class:`~mxtpu_torch.base.LoadShedError`.  A failure of a pooled call
itself propagates to the caller.

Hierarchical prefix cache (the paged engine): a finished request's
full-page chain stays pinned in the pool (``pin_bytes``, an LRU budget),
spills to pinned host memory under budget or pool pressure
(``host_cache_bytes``) and comes back on a later radix miss, so a
popular prompt survives a lull and a session's next turn (``session=``)
prefills only its new suffix.  The policy is
:class:`~mxtpu_torch.parallel.paging.HierarchicalCache`; the copies are
``TransformerLM.read_pages`` / ``write_pages`` (a chain's pages as one
buffer a page a row: one gather or scatter a pool tensor and one copy
between the card and host), all on the engine's stream: a spill's
device-to-host copy is ordered before any later write into the pages it
frees, and a restore's host-to-device copy before any read of the pages
it fills.  The host buffers are pinned and stay referenced until an
event after their copy completes, whatever the host tier drops
meanwhile.  With
``overlap_swaps`` a restore runs at the end of the iteration, after the
pooled decode step was issued (stream order, no side stream), and the
request admits at the next one; a request defers so once an attempt, so
one whose restore does not fit then recomputes its prefix.

Observability (both engines, the reference's emit sites): while the
process tracer or a flight recorder is active
(``mxtpu_torch.observability``), each iteration is an
``engine.iteration`` span (a ``torch.profiler.record_function`` range
under a recording profiler) and each request's path is a timeline of
typed events under ``"<ledger_tag>:<rid>"`` (``engine.admit``,
``engine.prefix_hit``, ``engine.cow``, ``engine.prefill_chunk``,
``engine.draft``, ``engine.decode``, ``engine.verify``,
``engine.swap_out``, ``engine.swap_in``, ``engine.defer``,
``engine.quarantine``, ``engine.requeue``, ``engine.shed``,
``engine.cancel``, ``engine.finish``); quarantines, sheds and failed
adoptions leave flight-recorder postmortems.  Every site is guarded by
``tracer.active``: tracing off costs one attribute read a site, and on
it is host bookkeeping only — the same launches, the same streams.

External control: ``cancel(rid)`` finishes a queued request
``cancelled`` with an empty output, or evicts an active one through the
scrub path (the paged engine returns its pages) with its partial output.
Live weight hot-swap: ``adopt(path)`` reads a verified checkpoint
(``resilience.checkpoint``; the ``serving.adopt`` site fires first), has
the model place its arrays beside the live weights
(``TransformerLM.prepare_adoption``, a copy of the engine's own; over
a tp mesh each rank reads the file and places its own shard) and
stages them; admissions wait while a generation is staged, and it
installs at the first iteration boundary with no occupied slot, so
in-flight streams finish on the generation they were admitted under and
every later admission rides the new one; the cached prefix state is
dropped at install.  ``rollback()`` stages the previous generation the
same way; ``MXTPU_HOTSWAP=0`` refuses ``adopt``.  A weight generation
belongs to the engine, as each reference engine's decoder holds its
own: engines sharing one model adopt, install and roll back apart.  An
engine that installed a generation binds its leaves onto the model
(``TransformerLM.install_leaves``, pointer rebinds, no copy) for the
length of each of its iterations and puts the model's own back after,
so every forward call it makes reads its generation, and a model no
engine adopted on serves its own parameters.  A draft model that is the
target itself keeps drafting with the model's own parameters, as the
reference's separate draft decoder does.

Tensor parallelism (``mesh=``, ``rules=``): every model call goes
through a :class:`~mxtpu_torch.parallel.decode.ShardedDecoder`, which
at tp > 1 runs the engine's calls on every rank's shard from rank 0 (the
engine, its scheduler and its sampling live on rank 0 alone); each
rank's pools and host page buffers hold its KV heads.  At tp = 1 the
decoder calls the model directly.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..base import LoadShedError, MXTPUError, parse_bytes, resolve_device
from ..models import sampler
from ..models.transformer import TransformerLM, pool_tensors
from ..observability.flight import get_flight as _flight
from ..observability.trace import get_tracer as _tracer
from ..ops.tensor import resolve_cache_dtype
from ..resilience.counters import bump as _bump
from ..resilience.faults import inject as _inject
from .decode import DEFAULT_CACHE_SPEC, ShardedDecoder
from .paging import NULL_PAGE, BlockPool, HierarchicalCache, PrefixIndex

__all__ = ["Request", "ContinuousBatchingEngine",
           "PagedContinuousBatchingEngine", "resolve_cache_dtype"]


def _bucket(n, base=8):
    """Smallest power of two >= n (floor ``base``)."""
    b = base
    while b < n:
        b *= 2
    return b


def _parse_spec_tree(value):
    """Normalize a tree-speculation config to ``(max_nodes, branch)``
    ints: 1 <= max_nodes <= 31 (root + 31 draft nodes fill the verify
    kernel's 32-lane ancestor bitmask) and branch >= 1.  Accepts a
    tuple or list, a bare int (branch 2) or a ``"nodes,branch"``
    string."""
    if isinstance(value, str):
        value = tuple(p for p in value.replace(",", " ").split() if p)
    if isinstance(value, int):
        value = (value, 2)
    try:
        nodes = int(value[0])
        branch = int(value[1]) if len(value) > 1 else 2
    except (TypeError, ValueError, IndexError):
        raise ValueError(
            "spec_tree must be (max_nodes, branch), a bare node count, "
            "or a 'nodes,branch' string — got %r" % (value,))
    if not 1 <= nodes <= 31:
        raise ValueError(
            "spec_tree max_nodes must be in [1, 31] (root + 31 draft "
            "nodes fill the verify kernel's 32-lane int32 ancestor "
            "bitmask), got %d" % nodes)
    if branch < 1:
        raise ValueError("spec_tree branch must be >= 1, got %d" % branch)
    return nodes, branch


def _ambient_spec_tree():
    """The engines' default tree config from ``MXTPU_SPEC_TREE``
    ("nodes,branch"; unset or empty: no tree drafting)."""
    v = os.environ.get("MXTPU_SPEC_TREE", "").strip()
    return _parse_spec_tree(v) if v else None


def _tree_paths(parent):
    """Per-lane path tables of draft trees given by their parent lanes
    (B, W) (parent[b, w] < w for w >= 1): depth (B, W) int32, the lane's
    depth; anc (B, W) int32, its strict-ancestor lane bitmask (K1's
    tree mask); perm (B, W, W) int64, its root path in depth order
    padded with the lane itself (gathering at perm[b, w] gives
    "ancestors and self")."""
    B, W = parent.shape
    depth = np.zeros((B, W), np.int32)
    anc = np.zeros((B, W), np.int32)
    perm = np.zeros((B, W, W), np.int64)
    for b in range(B):
        for w in range(1, W):
            p = int(parent[b, w])
            dw = depth[b, p] + 1
            depth[b, w] = dw
            anc[b, w] = anc[b, p] | (1 << p)
            perm[b, w, :dw] = perm[b, p, :dw]
            perm[b, w, dw:] = w
    return depth, anc, perm


class Request:
    """One generation request (host-side record)."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "temperature", "top_k",
                 "top_p", "repetition_penalty", "seed", "eos_id",
                 "deadline_at", "retries_left", "speculative", "session",
                 "spec_tree")

    def __init__(self, rid, prompt, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=0.0, repetition_penalty=1.0, seed=None, eos_id=None,
                 deadline_at=None, retries=0, speculative=None, session=None,
                 spec_tree=None):
        self.rid = rid
        self.prompt = prompt            # (1, Tp) int32 numpy
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature or 0.0)
        self.top_k = int(top_k or 0)
        self.top_p = float(top_p or 0.0)
        self.repetition_penalty = float(repetition_penalty or 1.0)
        self.seed = seed
        self.eos_id = eos_id
        self.deadline_at = deadline_at  # absolute clock() value or None
        self.retries_left = int(retries)
        self.speculative = speculative  # None = engine default
        self.session = session          # paged engine only
        self.spec_tree = spec_tree      # None = engine default;
        #                                 False = linear drafting

    @property
    def sampled(self):
        return self.temperature > 0.0

    @property
    def penalized(self):
        return self.repetition_penalty != 1.0

    @property
    def sample_config(self):
        """Slots sharing a config batch into ONE pooled sampling call."""
        return (self.temperature, self.top_k, self.top_p,
                self.repetition_penalty)


class _SpecTokens:
    """One verify iteration's emitted tokens for ONE slot (host ints,
    >= 1): the per-slot entry form of ``_Slot.emitted`` beside the
    pooled (B,) vectors of plain steps."""

    __slots__ = ("toks",)

    def __init__(self, toks):
        self.toks = toks


class _TreeDraft:
    """One slot's draft tree for one verify iteration (host ints).
    Node j rides window lane j + 1 (lane 0 carries the committed root
    token); ``parent[j]`` is the window lane of its parent, so
    ``parent[j] <= j``.  A linear draft is the chain 0, 1, ..., k-1."""

    __slots__ = ("toks", "parent")

    def __init__(self, toks, parent):
        self.toks = [int(t) for t in toks]
        self.parent = [int(p) for p in parent]
        if len(self.parent) != len(self.toks):
            raise ValueError(
                "tree draft needs one parent lane per node: %d nodes "
                "vs %d parents" % (len(self.toks), len(self.parent)))
        for j, p in enumerate(self.parent):
            if not 0 <= p <= j:
                raise ValueError(
                    "tree draft is not topological: node %d (window "
                    "lane %d) names parent lane %d" % (j, j + 1, p))

    def __len__(self):
        return len(self.toks)


class _Slot:
    """Host-side state of one occupied pool row.  ``pos`` is the cache
    position of the last sampled token, which the next decode step
    writes (None while a paged prompt is still prefilling).
    ``emitted`` holds references to the pooled (B,) token vector of each
    plain step (row ``row`` is this slot's token, read back to the host
    only when the request finishes) and a :class:`_SpecTokens` per
    verify iteration.  A speculating slot keeps a host mirror of its
    ``history`` (prompt and emitted tokens), which the drafters propose
    from."""

    __slots__ = ("req", "row", "Tp", "pos", "emitted", "n_emitted", "gen",
                 "history", "param_gen")

    def __init__(self, req, row, param_gen=0):
        self.req = req
        self.row = row
        self.param_gen = param_gen    # weight generation at admission
        self.Tp = req.prompt.shape[1]
        self.pos = None
        self.emitted = []
        self.n_emitted = 0
        self.gen = None               # torch.Generator of a sampled request
        self.history = None           # host ints while speculating

    @property
    def prefilling(self):
        return self.pos is None


class _PagedSlot(_Slot):
    """A paged slot: its chunk plan, the next chunk, and the pending
    copy-on-write clone (src_page, dst_page) of its first chunk."""

    __slots__ = ("chunks", "chunk_i", "cow")

    def __init__(self, req, row, chunks, cow, param_gen=0):
        super().__init__(req, row, param_gen)
        self.chunks = chunks          # [(start, T_actual, T_bucketed)]
        self.chunk_i = 0
        self.cow = cow


class _AdmissionDeferred(Exception):
    """Internal: the page pool is transiently exhausted — the request
    stays at the queue head and retries at the next iteration."""


def _same_device(a, b):
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class ContinuousBatchingEngine:
    """Iteration-level scheduler over a pool of contiguous cache rows
    (module docstring).

    Parameters
    ----------
    model : a port ``TransformerLM`` on ``device``.
    num_slots : pool rows B (the pooled decode step's batch).
    max_length : per-slot cache length; every request fits prompt + new
        tokens in it.
    spec_k : most drafted tokens per slot per iteration (0, the
        default, drafts nothing unless ``spec_tree`` is set).
    spec_ngram : longest n-gram the drafters match (>= 1).
    spec_tree : ``(max_nodes, branch)`` (or ``"nodes,branch"``, or a bare
        node count) to draft trees instead of chains: at most
        ``max_nodes`` <= 31 nodes, ``branch`` children a node.  Requests
        opt out with ``submit(spec_tree=False)`` (linear drafting) or
        name their own; linear windows ride the tree verify call as
        chains.  None reads ``MXTPU_SPEC_TREE`` (unset: no trees).
        Self-drafting only: it cannot be combined with ``draft_block``.
    draft_block : a small dense port ``TransformerLM`` with the target's
        vocabulary on the engine's device: drafts come from its pooled
        greedy decode over its own slot cache instead of the n-gram
        lookup (the verify side is the same).  Needs ``spec_k >= 1``.
    history : terminal requests whose status the engine remembers: the
        records of all but the last ``max(history, 2 * num_slots)``
        finished requests are dropped (``status`` then answers
        ``unknown``).
    cache_dtype : the caches' element type: None (the ambient
        ``MXTPU_CACHE_DTYPE``, else each model's own dtype), a float
        dtype, or ``"int8"`` for int8 payloads with one float32 scale
        per head and position (:func:`resolve_cache_dtype`).
    device : where the engine runs; the CUDA card unless named.  With no
        device named and no CUDA present the constructor raises.
    max_pending : bound of the admission queue (None: unbounded); a
        submit past it sheds with :class:`LoadShedError`.
    clock : the deadlines' clock, seconds (``time.monotonic`` unless
        given).
    ledger_tag : the engine's correlation-id scope in traces: its
        requests' events carry ``"<ledger_tag>:<rid>"`` (``"eng"`` unless
        given; engines traced side by side need distinct tags).
    mesh, rules, cache_spec : tensor parallelism: the model served over
        ``mesh``'s ``tp`` axis, split by ``rules``
        (``models.transformer.transformer_lm_sharding_rules()``), each
        rank's caches holding its KV heads (``cache_spec``, only the
        default head split).  Every model call goes through a
        :class:`~mxtpu_torch.parallel.decode.ShardedDecoder`: the engine
        runs on rank 0 of the axis, the other ranks run
        ``ShardedDecoder.follow(mesh, model[, draft_block])``.  None: one
        rank.
    draft_rules : the draft model's rules (``rules`` when None).
    """

    #: whether ``submit(session=...)`` is honoured (the paged engine's
    #: hierarchical cache; the slot engine has no page chains to pin)
    _supports_sessions = False

    def __init__(self, model, num_slots: int = 4, max_length: int = 256,
                 spec_k: int = 0, spec_ngram: int = 3, spec_tree=None,
                 draft_block=None, history: int = 1024, cache_dtype=None,
                 device=None, max_pending: Optional[int] = None, clock=None,
                 ledger_tag: Optional[str] = None, mesh=None, rules=None,
                 cache_spec=DEFAULT_CACHE_SPEC, draft_rules=None):
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0, got %d" % spec_k)
        self._device = resolve_device(device)
        if not _same_device(model.device, self._device):
            raise MXTPUError("the model is on %s, the engine on %s"
                             % (model.device, self._device))
        self._model = model
        self._dec = ShardedDecoder(model, mesh, rules, cache_spec)
        self._num_slots = int(num_slots)
        self._max_length = int(max_length)
        self._cache_dtype = resolve_cache_dtype(cache_dtype, model.dtype)
        self._slots: List[Optional[_Slot]] = [None] * self._num_slots
        self._queue: List[Request] = []
        self._results: Dict[int, torch.Tensor] = {}
        self._status: Dict[int, str] = {}
        # the status records of terminal requests, oldest first; only
        # the last self._history are kept
        self._history = max(int(history), 2 * self._num_slots)
        self._done: List[int] = []
        self._next_rid = 0
        self._last_tokens = torch.zeros(self._num_slots, dtype=torch.long,
                                        device=self._device)
        self._seen = None                # (B, V) bool, penalized rows
        self._steps = 0
        self._tokens_generated = 0
        # -- resilience --------------------------------------------------
        self._max_pending = None if max_pending is None else int(max_pending)
        self._clock = clock if clock is not None else time.monotonic
        self._errors: Dict[int, dict] = {}    # rid -> last error record
        self._quarantined = 0
        self._retries = 0
        self._deadline_evictions = 0
        self._shed = 0
        # -- speculative decoding ----------------------------------------
        self._spec_k = int(spec_k)
        self._spec_ngram = int(spec_ngram)
        if spec_tree is None:
            spec_tree = _ambient_spec_tree()
        self._spec_tree = (None if spec_tree is None
                           else _parse_spec_tree(spec_tree))
        if self._spec_tree is not None and draft_block is not None:
            raise ValueError(
                "spec_tree drafting is self-drafted (n-gram tree lookup): "
                "it cannot be combined with draft_block; pick one proposal "
                "source")
        # a routed (MoE) target's window is not its steps (the capacity
        # of the unbounded decode routing is a function of the batch):
        # self-drafting is silently off for it, linear and tree alike
        self._spec_on = ((self._spec_k > 0 or self._spec_tree is not None)
                         and not self._dec._block_has_moe())
        self._draft = draft_block
        self._draft_dec = None
        self._draft_pool = None
        if draft_block is not None:
            if self._spec_k < 1:
                raise ValueError("draft_block needs spec_k >= 1 (it bounds "
                                 "the drafted window)")
            if not self._spec_on:
                # an explicit draft model is a configuration the caller
                # asked for: fail loudly instead of serving without it
                raise ValueError(
                    "draft_block speculation is unsupported for MoE target "
                    "blocks: their decode routing is not window-parity-"
                    "safe, so MoE targets opt out of speculation entirely "
                    "(docs/inference.md)")
            if not isinstance(draft_block, TransformerLM):
                raise ValueError(
                    "draft_block must be a dense port TransformerLM, not %s"
                    % type(draft_block).__name__)
            if draft_block.num_experts:
                raise ValueError(
                    "draft_block must be a dense block: MoE decode routing "
                    "is not window-parity-safe (the same reason MoE targets "
                    "opt out of speculation)")
            if draft_block.vocab_size != model.vocab_size:
                raise ValueError(
                    "draft_block's vocabulary (%d) is not the target's (%d)"
                    % (draft_block.vocab_size, model.vocab_size))
            if not _same_device(draft_block.device, self._device):
                raise MXTPUError("the draft model is on %s, the engine on %s"
                                 % (draft_block.device, self._device))
            # rows and length of the target's: the draft cache mirrors the
            # target row and position-wise, so rollback is one host fix-up
            self._draft_cache_dtype = resolve_cache_dtype(cache_dtype,
                                                          draft_block.dtype)
            self._draft_dec = self._dec if draft_block is model else \
                ShardedDecoder(draft_block, mesh, draft_rules or rules,
                               cache_spec)
            self._draft_pool = self._draft_dec.init_cache(
                self._num_slots, self._max_length, self._draft_cache_dtype)
        self._drafter = (sampler.NGramDrafter(max_ngram=self._spec_ngram)
                         if self._spec_on and draft_block is None else None)
        self._tree_drafters: Dict[tuple, sampler.TreeDrafter] = {}
        self._drafted_tokens = 0
        self._accepted_tokens = 0
        self._tree_nodes_drafted = 0   # draft nodes proposed as trees
        self._tree_paths = 0           # root-to-leaf paths proposed
        self._verify_calls = 0
        self._slot_iterations = 0      # slot participations in decode
        #                                calls: tokens per slot-iteration
        #                                is the speculation multiplier
        # -- live weight hot-swap ------------------------------------------
        self._param_gen = 0                 # current weight generation
        self._leaves = None                 # this engine's installed
        #                                     leaves (None: the model's)
        self._own_leaves = None             # the model's, while bound
        self._staged_adoption = None        # placed leaves awaiting an
        #                                     empty iteration boundary
        self._prev_leaves = None            # rollback target
        self._adoption_staged_step = None   # _steps when staged
        self._adoptions = 0
        self._adoption_failures = 0
        self._rollbacks = 0
        self._last_adoption_steps = 0       # stage -> install, iterations
        # -- observability -------------------------------------------------
        self._trace_tag = ledger_tag or "eng"
        self._init_cache()

    def _init_cache(self):
        """The target's cache: one contiguous row a slot."""
        self._pool = self._dec.init_cache(self._num_slots,
                                            self._max_length,
                                            self._cache_dtype)

    # -- observability plumbing --------------------------------------------
    def _trace_key(self, rid) -> str:
        """Correlation id of one engine request: ``"<tag>:<rid>"``."""
        return "%s:%s" % (self._trace_tag, rid)

    def _emit(self, etype, rid, **fields):
        """Record one trace event of request ``rid`` (None: the engine's
        own); a no-op while tracing and flight recording are both off."""
        tr = _tracer()
        if tr.active:
            tr.emit(etype,
                    rid=None if rid is None else self._trace_key(rid),
                    **fields)

    def _flight_failure(self, kind, rid=None, **context):
        """A flight-recorder postmortem of a failure path (no-op while the
        recorder is off)."""
        fl = _flight()
        if fl.active:
            rids = () if rid is None else (self._trace_key(rid),)
            fl.failure(kind, rids=rids, engine=self._trace_tag, **context)

    # -- introspection ---------------------------------------------------
    @property
    def num_slots(self):
        return self._num_slots

    @property
    def free_slots(self):
        return sum(1 for s in self._slots if s is None)

    @property
    def pending(self):
        return len(self._queue)

    @property
    def active(self):
        return sum(1 for s in self._slots if s is not None)

    @property
    def stats(self):
        return {
            "steps": self._steps,
            "generated_tokens": self._tokens_generated,
            "quarantined_requests": self._quarantined,
            "retried_requests": self._retries,
            "expired_requests": self._deadline_evictions,
            "shed_requests": self._shed,
            "drafted_tokens": self._drafted_tokens,
            "accepted_tokens": self._accepted_tokens,
            "tree_nodes_drafted": self._tree_nodes_drafted,
            "tree_paths": self._tree_paths,
            "slot_iterations": self._slot_iterations,
            "draft_hit_rate": (self._accepted_tokens / self._drafted_tokens
                               if self._drafted_tokens else 0.0),
            "verify_calls": self._verify_calls,
            # live weight hot-swap
            "param_generation": self._param_gen,
            "adoptions": self._adoptions,
            "adoption_failures": self._adoption_failures,
            "rollbacks": self._rollbacks,
            "adoption_staged": int(self._staged_adoption is not None),
            "last_adoption_steps": self._last_adoption_steps,
        }

    def status(self, rid) -> str:
        """``queued`` / ``active`` / ``ok`` / ``failed`` / ``expired`` /
        ``cancelled`` (``unknown`` for a rid not issued or no longer
        remembered)."""
        return self._status.get(rid, "unknown")

    def error(self, rid) -> Optional[dict]:
        """The last error record of a quarantined request (``{"type",
        "error", "site", "step", "emitted"}``) or None; kept after a
        successful retry."""
        return self._errors.get(rid)

    def prefix_probe(self, prompt_ids) -> int:
        """How many of a prompt's tokens this engine would skip
        prefilling if it were admitted now: 0 here (no prefix reuse)."""
        return 0

    def drop_cache(self) -> int:
        """Release every cached page chain beyond the live requests;
        returns the device pages freed (0 here: no cache tiers)."""
        return 0

    # -- request intake --------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens, temperature=0.0, top_k=0,
               top_p=0.0, repetition_penalty=1.0, seed=None, eos_id=None,
               deadline_s=None, retries=0, speculative=None, session=None,
               spec_tree=None) -> int:
        """Queue one request, prompt_ids (1, Tp); returns its id.
        temperature 0 is greedy; ``seed`` reproduces a sampled stream.
        ``deadline_s``: seconds on the engine's clock, past which the
        request is evicted at the next iteration boundary as ``expired``
        with its partial output.  ``retries``: how many times a
        quarantined request restarts from scratch (the same stream as a
        fresh submit) before it finishes ``failed``.
        ``speculative=False`` opts the request out of the engine's
        speculation; ``spec_tree`` is None (the engine's default), False
        (linear drafting) or the request's own tree config (a
        self-drafting engine only).  The output is the same in every
        mode.  ``session``: a conversation handle (the paged engine
        only): the finished request's page chain stays pinned so the
        next turn prefills only its new suffix, until
        ``close_session``."""
        if session is not None and not self._supports_sessions:
            raise ValueError(
                "submit(session=...) needs the paged engine's hierarchical "
                "cache (PagedContinuousBatchingEngine): the slot engine has "
                "no page chains to pin")
        if spec_tree is not None and spec_tree is not False:
            spec_tree = _parse_spec_tree(spec_tree)
            if not self._spec_on or self._drafter is None:
                raise ValueError(
                    "submit(spec_tree=...) needs a self-drafting "
                    "speculation-enabled engine (spec_k > 0 or spec_tree= "
                    "at construction, a dense non-MoE block, and no "
                    "draft_block)")
        prompt = np.asarray(torch.as_tensor(prompt_ids).cpu(),
                            dtype=np.int32)
        if prompt.ndim != 2 or prompt.shape[0] != 1:
            raise ValueError("submit() takes ONE request: prompt_ids must "
                             "be (1, T_prompt), got %r" % (prompt.shape,))
        Tp = prompt.shape[1]
        if Tp + int(max_new_tokens) > self._max_length:
            raise ValueError("request needs %d cache positions > "
                             "max_length %d"
                             % (Tp + int(max_new_tokens), self._max_length))
        self._check_capacity(Tp, int(max_new_tokens))
        if self._max_pending is not None and \
                len(self._queue) >= self._max_pending:
            self._shed += 1
            _bump("shed_requests")
            self._emit("engine.shed", None, queue_depth=len(self._queue),
                       limit=self._max_pending)
            self._flight_failure("shed", queue_depth=len(self._queue),
                                 limit=self._max_pending)
            raise LoadShedError(
                "admission queue full (%d pending >= max_pending=%d): "
                "request shed — back off and resubmit"
                % (len(self._queue), self._max_pending),
                queue_depth=len(self._queue), limit=self._max_pending,
                retry_after_ticks=max(
                    1, -(-len(self._queue) // self._num_slots)))
        rid = self._next_rid
        self._next_rid += 1
        deadline_at = (None if deadline_s is None
                       else self._clock() + float(deadline_s))
        self._queue.append(Request(
            rid, prompt, max_new_tokens, temperature, top_k, top_p,
            repetition_penalty, seed, eos_id, deadline_at=deadline_at,
            retries=retries, speculative=speculative, session=session,
            spec_tree=spec_tree))
        self._status[rid] = "queued"
        return rid

    def _check_capacity(self, Tp, max_new):
        """Shed a request that can never be admitted (the paged engine's
        page budget); every request that fits max_length fits a row."""

    # -- admission -------------------------------------------------------
    def _slot_prefill(self, dec, cache, cache_dtype, row, prompt):
        """Prefill ``prompt`` (1, Tp) int32 into row ``row`` of ``cache``
        (the model's behind the decoder ``dec``): the prompt padded to
        the power-of-two ladder (capped at max_length; a routed model's
        exactly Tp long, since padded tokens would join its routing)
        through a fresh batch-1 scratch cache, then copied into the row.
        Returns the logits of the prompt's last real position, (1, V)."""
        Tp = prompt.shape[1]
        Tb = Tp if dec._block_has_moe() else min(_bucket(Tp),
                                                  self._max_length)
        raw = np.zeros((1, Tb), np.int64)
        raw[0, :Tp] = prompt[0]
        scratch = dec.init_cache(1, Tb, cache_dtype)
        logits = dec.prefill(torch.from_numpy(raw).to(self._device),
                             scratch)
        dec.write_cache_slot(cache, scratch, row)
        return logits[:, Tp - 1]

    def _admit(self, req, row):
        """Slot prefill of the whole prompt, then the first token."""
        _inject("serving.admit", key=req.rid)
        self._emit("engine.admit", req.rid, prompt_tokens=req.prompt.shape[1])
        slot = _Slot(req, row, self._param_gen)
        self._slots[row] = slot
        self._status[req.rid] = "active"
        last = self._slot_prefill(self._dec, self._pool, self._cache_dtype,
                                  row, req.prompt)
        self._first_token(slot, last)

    def _first_token(self, slot, last):
        """The admission tail shared by both engines, from the prompt's
        last real logit row ``last`` (1, V): the generator of a sampled
        request (seeded after prefill, as ``generate`` seeds it), the
        penalty row, the first draw, the drafters' history and the draft
        model's prefill; a request done after one token finishes."""
        req, row = slot.req, slot.row
        if req.sampled:
            slot.gen = torch.Generator(device=self._device)
            slot.gen.manual_seed(int(req.seed) if req.seed is not None
                                 else int(np.random.randint(0, 2**31 - 1)))
        V = last.shape[-1]
        if self._seen is None or self._seen.shape[-1] != V:
            self._seen = torch.zeros((self._num_slots, V), dtype=torch.bool,
                                     device=self._device)
        if req.penalized:
            self._seen[row] = False
            self._seen[row, torch.from_numpy(req.prompt[0]).long().to(
                self._device)] = True
        tok = sampler.sample_next_token(
            last, slot.gen, req.temperature, req.top_k, req.top_p,
            req.repetition_penalty,
            seen_mask=self._seen[row:row + 1] if req.penalized else None)
        if req.penalized:
            self._seen[row, tok[0]] = True
        lt = self._last_tokens.clone()
        lt[row] = tok[0]
        self._last_tokens = lt
        slot.pos = slot.Tp
        slot.emitted = [lt]
        slot.n_emitted = 1
        if self._speculates(req):
            # the drafters' history: prompt and first token (one small
            # host read per admission)
            slot.history = [int(t) for t in req.prompt[0]] + [int(tok[0])]
            if self._draft is not None:
                with self._draft_leaves():
                    self._slot_prefill(self._draft_dec, self._draft_pool,
                                       self._draft_cache_dtype, row,
                                       req.prompt)
        self._prefilled(slot)
        if self._slot_done(slot):
            self._finish(row)

    def _prefilled(self, slot):
        """Called once a slot's prompt is in the cache (the paged engine
        registers its prompt pages here)."""

    # -- decode ----------------------------------------------------------
    def _slot_done(self, slot):
        if slot.n_emitted >= slot.req.max_new_tokens:
            return True
        if slot.req.eos_id is not None:
            last = slot.emitted[-1]
            if isinstance(last, _SpecTokens):
                return int(last.toks[-1]) == slot.req.eos_id
            return int(last[slot.row]) == slot.req.eos_id
        return False

    def _finish(self, row):
        """Store a finished slot's result and free the row."""
        slot = self._slots[row]
        self._store_result(slot.req, slot.emitted, row, "ok")
        self._slots[row] = None
        self._retire(row, slot.req)

    def _store_result(self, req, emitted, row, status):
        """Read a request's emitted tokens back (row ``row`` of each
        pooled vector, and the verify iterations' own lists), store the
        prompt and them as its result and mark it ``status``."""
        pooled = [e for e in emitted if not isinstance(e, _SpecTokens)]
        col = iter(torch.stack(pooled)[:, row].cpu().numpy()
                   if pooled else ())
        toks = []
        for e in emitted:
            if isinstance(e, _SpecTokens):
                toks.extend(int(t) for t in e.toks)
            else:
                toks.append(int(next(col)))
        self._results[req.rid] = torch.from_numpy(np.concatenate(
            [req.prompt, np.asarray(toks, np.int32).reshape(1, -1)], axis=1))
        self._terminal(req.rid, status)
        self._emit("engine.finish", req.rid, status=status, emitted=len(toks))

    def _retire(self, row, req):
        """Return a row that finished ``ok`` (the paged engine first
        offers its page chain to the hierarchical cache)."""
        self._release(row)

    def _release(self, row):
        """Return a row's cache (the paged engine's pages); idempotent."""

    def _terminal(self, rid, status="ok"):
        """Mark a request terminal, dropping the status and error records
        of the oldest terminal requests past ``history``."""
        self._status[rid] = status
        self._done.append(rid)
        if len(self._done) > self._history:
            for old in self._done[:-self._history]:
                self._status.pop(old, None)
                self._errors.pop(old, None)
            del self._done[:-self._history]

    # -- failure paths -----------------------------------------------------
    def _scrub_row(self, row):
        """Return a row after a failure: clear its penalty row and its
        cache (the next admission overwrites the contents)."""
        if self._seen is not None:
            self._seen[row] = False
        self._release(row)

    @staticmethod
    def _emitted_count(emitted):
        return sum(len(e.toks) if isinstance(e, _SpecTokens) else 1
                   for e in emitted or [])

    def _requeue_or_fail(self, req, exc, site, emitted=None, row=0):
        """Record the error, then re-queue the request while it has
        retries left (a restart from scratch), else finish it
        ``failed`` with its partial output."""
        self._errors[req.rid] = {
            "type": type(exc).__name__, "error": str(exc), "site": site,
            "step": self._steps, "emitted": self._emitted_count(emitted)}
        if req.retries_left > 0:
            req.retries_left -= 1
            self._retries += 1
            _bump("retries")
            self._emit("engine.requeue", req.rid,
                       retries_left=req.retries_left, site=site)
            self._status[req.rid] = "queued"
            self._queue.append(req)
        else:
            self._store_result(req, emitted or [], row, "failed")

    def _quarantine_request(self, req, exc, site, row, emitted=None):
        """Scrub the row and fail or re-queue the request (an occupied
        slot and a failed admission alike)."""
        self._scrub_row(row)
        self._quarantined += 1
        _bump("quarantined_slots")
        self._emit("engine.quarantine", req.rid, site=site,
                   error=type(exc).__name__, step=self._steps)
        self._flight_failure("quarantine", rid=req.rid, site=site,
                             error=type(exc).__name__, step=self._steps)
        self._requeue_or_fail(req, exc, site, emitted=emitted, row=row)

    def _quarantine(self, row, exc, site):
        """Evict only the offending slot; every other slot's generator,
        penalty row and cache stay as they were."""
        slot = self._slots[row]
        self._slots[row] = None
        self._quarantine_request(slot.req, exc, site, row,
                                 emitted=slot.emitted)

    def _evict_expired(self):
        """Iteration-boundary deadline sweep over the slots and the
        queue: an expired request finishes ``expired`` with its partial
        output."""
        now = self._clock()

        def expired(req):
            return req.deadline_at is not None and now >= req.deadline_at

        for i, slot in enumerate(self._slots):
            if slot is not None and expired(slot.req):
                self._slots[i] = None
                self._scrub_row(i)
                self._deadline_evictions += 1
                _bump("deadline_evictions")
                self._store_result(slot.req, slot.emitted, i, "expired")
        if any(expired(r) for r in self._queue):
            keep = []
            for req in self._queue:
                if expired(req):
                    self._deadline_evictions += 1
                    _bump("deadline_evictions")
                    self._store_result(req, [], 0, "expired")
                else:
                    keep.append(req)
            self._queue = keep

    # the decode hooks: the slot engine's forms (the paged engine adds
    # its block tables)
    def _decode_state(self, active):
        """pos (B,) int32 on the device: dead lanes at position 0."""
        pos = np.zeros((self._num_slots,), np.int32)
        for i in active:
            pos[i] = self._slots[i].pos
        return torch.from_numpy(pos).to(self._device)

    def _run_step(self, state):
        return self._dec.step_slots(self._last_tokens.reshape(-1, 1),
                                      self._pool, state)

    def _run_verify(self, state, window, valid_len):
        return self._dec.verify_slots(window, self._pool, state, valid_len)

    def _run_verify_tree(self, state, window, valid_len, perm, depth, anc):
        return self._dec.verify_slots(window, self._pool, state, valid_len,
                                        tree=(perm, depth))

    def _run_fixup(self, state, src_lane):
        self._dec.permute_cache_span(self._pool, state, src_lane)

    def _decode_active(self, active):
        """Draft, then ONE plain pooled step or ONE pooled verify call
        for every decoding slot: a tree verify when any slot drafted a
        tree (linear windows ride it as chains), else a linear one.
        Drafting may quarantine slots out of ``active``."""
        drafts = self._draft_phase(active)
        if not active:
            return
        if drafts and _tracer().active:
            for i, d in sorted(drafts.items()):
                self._emit("engine.draft", self._slots[i].req.rid,
                           proposed=len(d))
        if not drafts:
            self._decode_plain(active)
        elif any(isinstance(d, _TreeDraft) for d in drafts.values()):
            self._decode_verify_tree(active, drafts)
        else:
            self._decode_verify(active, drafts)

    def _decode_plain(self, active):
        """ONE pooled decode step over every decoding slot; speculating
        slots mirror their token into the host history."""
        logits = self._run_step(self._decode_state(active))
        self._sample_pool(logits[:, 0], active)
        self._steps += 1
        self._tokens_generated += len(active)
        self._slot_iterations += len(active)
        hist = [i for i in active if self._slots[i].history is not None]
        if hist:
            toks = self._last_tokens.cpu().numpy()
            for i in hist:
                self._slots[i].history.append(int(toks[i]))
        trace_on = _tracer().active
        for i in active:
            s = self._slots[i]
            s.pos += 1
            s.n_emitted += 1
            s.emitted.append(self._last_tokens)
            if trace_on:
                self._emit("engine.decode", s.req.rid, pos=s.pos,
                           emitted=s.n_emitted)
            try:
                done = self._slot_done(s)
            except Exception as exc:        # the per-slot eos host read
                self._quarantine(i, exc, "serving.step")
                continue
            if done:
                self._finish(i)

    # -- speculative decoding ----------------------------------------------
    def _speculates(self, req):
        """Whether a request drafts: speculation on and not opted out,
        and more than one token to generate."""
        return (self._spec_on and req.speculative is not False
                and req.max_new_tokens > 1)

    def _spec_extent(self, slot):
        """Token capacity of the slot's cache: a drafted window clamps
        here, so a verify write never lands past it."""
        return self._max_length

    def _spec_budget(self, slot):
        """Draft tokens one slot may propose this iteration: never past
        the request's remaining tokens nor the slot's extent."""
        return min(self._spec_k,
                   slot.req.max_new_tokens - slot.n_emitted - 1,
                   self._spec_extent(slot) - 1 - slot.pos)

    def _tree_cfg_for(self, req):
        """The request's (max_nodes, branch) tree config, or None for
        linear drafting (always None with a draft model)."""
        if not self._spec_on or self._draft is not None \
                or req.spec_tree is False:
            return None
        if req.spec_tree is not None:
            return req.spec_tree        # validated at submit
        return self._spec_tree

    def _tree_drafter_for(self, cfg):
        """The TreeDrafter of one config (drafters are stateless)."""
        d = self._tree_drafters.get(cfg)
        if d is None:
            d = sampler.TreeDrafter(max_nodes=cfg[0], branch=cfg[1],
                                    max_ngram=self._spec_ngram)
            self._tree_drafters[cfg] = d
        return d

    def _tree_budget(self, slot, nodes):
        """Tree nodes one slot may propose this iteration: the clamps of
        ``_spec_budget`` (the deepest path emits at most nodes + 1
        tokens; the last lane writes at pos + nodes)."""
        return min(nodes, slot.req.max_new_tokens - slot.n_emitted - 1,
                   self._spec_extent(slot) - 1 - slot.pos)

    def _draft_phase(self, active):
        """Draft proposals of every speculating slot: {row: token list
        or _TreeDraft}, empty drafts left out.  The ``serving.draft``
        site fires once a speculating slot before its proposal; a raise
        there or in the drafter quarantines the slot and removes it from
        ``active``."""
        if not self._spec_on:
            return {}
        rows = []
        for i in list(active):
            if self._slots[i].history is None:
                continue
            try:
                _inject("serving.draft", key=self._slots[i].req.rid)
            except Exception as exc:
                self._quarantine(i, exc, "serving.draft")
                active.remove(i)
                continue
            rows.append(i)
        if not rows:
            return {}
        if self._draft is not None:
            return self._propose_model(rows)
        out = {}
        for i in rows:
            s = self._slots[i]
            try:
                cfg = self._tree_cfg_for(s.req)
                if cfg is not None:
                    n = self._tree_budget(s, cfg[0])
                    toks = []
                    if n > 0:
                        toks, par, _ = self._tree_drafter_for(
                            cfg).propose_tree(s.history, n, n)
                    if toks:
                        d = _TreeDraft(toks, par)
                        self._tree_nodes_drafted += len(toks)
                        # leaves: nodes no other node names as parent
                        self._tree_paths += len(toks) - len(
                            {p for p in d.parent if p > 0})
                        out[i] = d
                    continue
                k = self._spec_budget(s)
                d = self._drafter.propose(s.history, k) if k > 0 else []
            except Exception as exc:
                self._quarantine(i, exc, "serving.draft")
                active.remove(i)
                continue
            if d:
                out[i] = d
        return out

    def _verify_faults(self, active, drafts):
        """The ``serving.verify`` site, once a slot of a pooled verify
        call before it: a raise quarantines the slot.  Returns whether
        any drafted slot is left (else the iteration is a plain
        step)."""
        for i in list(active):
            try:
                _inject("serving.verify", key=self._slots[i].req.rid)
            except Exception as exc:
                self._quarantine(i, exc, "serving.verify")
                active.remove(i)
                drafts.pop(i, None)
        return bool(drafts)

    def _propose_model(self, rows):
        """Pooled greedy drafting with the draft model: j proposals a row
        from j + 1 pooled ``step_slots`` calls over the draft cache, the
        last one writing the last draft's K/V, so a fully accepted
        window leaves no gap.  Rows that do not draft flow through at
        position 0 (their draft rows are never read); a write past the
        cache is clamped onto its last position, which the row rewrites
        before it attends it."""
        B = self._num_slots
        j = max(0, min(self._spec_k,
                       max(self._spec_budget(self._slots[i]) for i in rows)))
        pos = np.zeros((B,), np.int64)
        for i in rows:
            pos[i] = self._slots[i].pos
        pos = torch.from_numpy(pos).to(self._device)
        tok = self._last_tokens.reshape(-1, 1)
        proposals = []
        with self._draft_leaves():
            for w in range(j + 1):
                logits = self._draft_dec.step_slots(
                    tok, self._draft_pool,
                    (pos + w).clamp(max=self._max_length - 1))
                if w < j:
                    nxt = torch.argmax(logits[:, 0], dim=-1)
                    proposals.append(nxt)
                    tok = nxt.reshape(-1, 1)
        if not proposals:
            return {}
        mat = torch.stack(proposals, dim=1).cpu().numpy()
        out = {}
        for i in rows:
            k = self._spec_budget(self._slots[i])
            if k > 0:
                out[i] = [int(t) for t in mat[i, :k]]
        return out

    def _window(self, drafts_tokens, W):
        """The (B, W) verify window on the device: each row's last
        sampled token, then its drafted tokens (zeros past them)."""
        dr = torch.from_numpy(drafts_tokens).to(self._device)
        return torch.cat([self._last_tokens.reshape(-1, 1), dr], dim=1)
    def _decode_verify(self, active, drafts):
        """Linear speculative iteration: ONE pooled verify call scores
        every row's window (last token + drafts), the candidate draw at
        each window position uses the rule and the draw sequential
        decode would use there, and each row emits its accepted prefix
        plus one."""
        if not self._verify_faults(active, drafts):
            if active:
                self._decode_plain(active)
            return
        B = self._num_slots
        W = _bucket(max(len(d) for d in drafts.values()) + 1, base=2)
        state = self._decode_state(active)
        dr = np.zeros((B, W - 1), np.int64)
        vl = np.zeros((B,), np.int32)
        nreal = 0
        for i in active:
            d = drafts.get(i, ())[:W - 1]
            vl[i] = 1 + len(d)
            dr[i, :len(d)] = d
            nreal += len(d)
        window = self._window(dr, W)
        logits = self._run_verify(state, window,
                                  torch.from_numpy(vl).to(self._device))
        M, states = self._sample_window(logits, active, window, W)
        # ONE host sync: the candidates and the window
        M_h, win_h = torch.stack([M, window]).cpu().numpy()
        match = (M_h[:, :W - 1] == win_h[:, 1:]) & \
            (np.arange(W - 1)[None, :] < (vl - 1)[:, None])
        counts = 1 + np.cumprod(match, axis=1).sum(axis=1)
        self._commit(active, M_h, counts, states, nreal, vl, finish=True)

    def _decode_verify_tree(self, active, drafts):
        """Tree speculative iteration: ONE pooled verify call scores
        every row's draft tree — the root token on window lane 0, node j
        on lane j+1, each lane attending only its root-to-node path
        through the kernel's ancestor mask.  Lane w's candidate uses the
        draw and penalty state sequential decode would use at its depth
        along its path; a lane is accepted when its whole path matched,
        and a row emits its deepest accepted path plus one.  Sibling
        tokens are distinct, so the accepted lanes form one chain.  A
        row whose path took a side branch has that path's K/V moved
        into depth order (``_run_fixup``)."""
        if not self._verify_faults(active, drafts):
            if active:
                self._decode_plain(active)
            return
        B = self._num_slots
        W = _bucket(max(len(d) for d in drafts.values()) + 1, base=2)
        state = self._decode_state(active)
        dr = np.zeros((B, W - 1), np.int64)
        vl = np.zeros((B,), np.int32)
        # padding lanes continue a chain off the previous lane, so every
        # row's tree is well formed; they are never accepted
        parent = np.maximum(np.arange(W) - 1, 0)[None, :].repeat(B, 0)
        nreal = 0
        for i in active:
            d = drafts.get(i)
            if d is None:
                vl[i] = 1
                continue
            if isinstance(d, _TreeDraft):
                toks, par = d.toks, d.parent
            else:                       # a linear draft is a chain
                toks, par = list(d), list(range(len(d)))
            n = min(len(toks), W - 1)
            vl[i] = 1 + n
            dr[i, :n] = toks[:n]
            parent[i, 1:n + 1] = par[:n]
            nreal += n
        depth, anc, perm = _tree_paths(parent)
        window = self._window(dr, W)
        dev = self._device
        logits = self._run_verify_tree(
            state, window, torch.from_numpy(vl).to(dev),
            torch.from_numpy(perm).to(dev), torch.from_numpy(depth).to(dev),
            torch.from_numpy(anc).to(dev))
        M, states = self._sample_window(logits, active, window, W,
                                        perm=perm, depth=depth)
        M_h, win_h = torch.stack([M, window]).cpu().numpy()
        lane = np.arange(W)
        matched = (win_h == np.take_along_axis(M_h, parent, axis=1)) & \
            (lane[None, :] < vl[:, None])
        matched[:, 0] = True
        accepted = np.take_along_axis(
            matched, perm.reshape(B, -1), axis=1).reshape(B, W, W).all(2)
        counts = ((depth + 1) * accepted).max(axis=1)
        # the accepted lane at each depth (one per depth: siblings differ)
        path_lane = (((depth[:, :, None] == lane[None, None, :])
                      & accepted[:, :, None]) * lane[None, :, None]).sum(1)
        path_M = np.take_along_axis(M_h, path_lane, axis=1)
        finished = self._commit(active, path_M, counts, states, nreal, vl,
                                tree=drafts)
        src = np.full((B, W), -1, np.int64)
        for i in active:
            m = int(counts[i])
            if i not in finished and (path_lane[i, :m] != lane[:m]).any():
                # pos + j must hold lane path[j]'s K/V before the next
                # step reads it (finished rows release their cache)
                src[i, :m] = path_lane[i, :m]
        if (src >= 0).any():
            self._run_fixup(state, torch.from_numpy(src).to(dev))
        for i in finished:
            self._finish(i)

    def _commit(self, active, M_h, counts, states, nreal, vl, finish=False,
                tree=None):
        """Emit each row's first counts[b] candidates M_h[b] (cut at
        eos): advance its position, draw stream, history and penalty
        row.  With ``finish`` a row that is done finishes at once (the
        linear window); else the done rows are returned for the caller
        to finish (after the tree fix-up, which reads their tables).
        ``vl`` (B,) is each row's valid window length and ``tree`` the
        drafts of a tree iteration, for the ``engine.verify`` events."""
        W = M_h.shape[1]
        rows = np.arange(len(counts))
        last = M_h[rows, np.clip(counts - 1, 0, W - 1)]
        self._last_tokens = torch.from_numpy(last.astype(np.int64)).to(
            self._device)
        self._steps += 1
        self._verify_calls += 1
        self._drafted_tokens += nreal
        self._slot_iterations += len(active)
        finished = []
        trace_on = _tracer().active
        for i in active:
            s = self._slots[i]
            m = int(counts[i])
            if s.req.penalized:
                self._seen[i, torch.from_numpy(M_h[i, :m]).to(
                    self._device)] = True
            toks = M_h[i, :m].astype(np.int32)
            if s.req.eos_id is not None:
                hits = np.nonzero(toks == s.req.eos_id)[0]
                if hits.size:           # stop AT eos, as sequential does
                    m = int(hits[0]) + 1
                    toks = toks[:m]
            if trace_on:
                fields = dict(drafted=int(vl[i]) - 1, accepted=m - 1)
                if tree is not None:
                    fields["tree"] = isinstance(tree.get(i), _TreeDraft)
                self._emit("engine.verify", s.req.rid, **fields)
            self._accepted_tokens += m - 1
            self._tokens_generated += m
            s.pos += m
            s.n_emitted += m
            if s.gen is not None:
                s.gen.set_state(states[i][m])   # exactly m draws used
            if s.history is not None:
                s.history.extend(int(t) for t in toks)
            s.emitted.append(_SpecTokens(toks.copy()))
            if self._slot_done(s):
                if finish:
                    self._finish(i)
                else:
                    finished.append(i)
        return finished

    def _sample_window(self, logits, active, window, W, perm=None,
                       depth=None):
        """Candidate draws for every window lane: lane w of row b is
        drawn from logits[b, w] with the draw and penalty state
        sequential decode would use there.  Linear (no ``perm``): the
        slot's w-th future draw, its seen tokens plus window lanes
        1..w.  Tree: the depth[b, w]-th future draw, its seen tokens
        plus the lanes of w's path (``perm[b, w]``).  Returns (M (B, W)
        int64 on the device, {row: generator states after 0..W draws}
        for the sampled rows)."""
        B = self._num_slots
        V = logits.shape[-1]
        dev = self._device
        groups: Dict[tuple, List[int]] = {}
        for i in active:
            groups.setdefault(self._slots[i].req.sample_config,
                              []).append(i)
        seen_w = [self._seen] * W
        pen = [i for i in active if self._slots[i].req.penalized]
        if pen:
            pr = torch.zeros(B, dtype=torch.bool)
            pr[pen] = True
            pr = pr.to(dev)[:, None]
            rows = torch.arange(B, device=dev)[:, None]
            if perm is None:
                seen_w, cur = [self._seen], self._seen
                for w in range(1, W):
                    upd = cur.clone()
                    upd[rows[:, 0], window[:, w]] = True
                    cur = torch.where(pr, upd, cur)
                    seen_w.append(cur)
            else:
                perm_d = torch.from_numpy(perm).to(dev)
                seen_w = []
                for w in range(W):
                    upd = self._seen.clone()
                    upd[rows, torch.gather(window, 1, perm_d[:, w])] = True
                    seen_w.append(torch.where(pr, upd, self._seen))
        states = {i: sampler.future_states(self._slots[i].gen, W, V, dev)
                  for i in active if self._slots[i].gen is not None}
        ahead = (np.arange(W)[None, :].repeat(B, 0) if depth is None
                 else depth)
        cols: List[Optional[torch.Tensor]] = [None] * W
        for (temp, top_k, top_p, rep), members in groups.items():
            mask = torch.zeros(B, dtype=torch.bool)
            mask[members] = True
            mask = mask.to(dev)
            for w in range(W):
                gens = None
                if temp > 0.0:
                    gens = [sampler.generator_at(states[i][ahead[i, w]], dev)
                            if i in members else None for i in range(B)]
                out = sampler.sample_next_token(
                    logits[:, w], gens, temp, top_k, top_p, rep,
                    seen_mask=seen_w[w] if rep != 1.0 else None,
                    active_mask=mask)
                cols[w] = out if cols[w] is None \
                    else torch.where(mask, out, cols[w])
        return torch.stack(cols, dim=1), states

    def _sample_pool(self, last, active):
        """Pooled sampling: slots sharing a sampling config draw in ONE
        call, each row with its own generator and an active mask, so a
        row's draw equals the isolated single-request draw."""
        B = self._num_slots
        groups: Dict[tuple, List[int]] = {}
        for i in active:
            groups.setdefault(self._slots[i].req.sample_config,
                              []).append(i)
        next_tokens = None
        for (temp, top_k, top_p, rep), members in groups.items():
            mask = torch.zeros(B, dtype=torch.bool)
            mask[members] = True
            mask = mask.to(self._device)
            gens = None
            if temp > 0.0:
                gens = [self._slots[i].gen if i in members else None
                        for i in range(B)]
            out = sampler.sample_next_token(
                last, gens, temp, top_k, top_p, rep,
                seen_mask=self._seen if rep != 1.0 else None,
                active_mask=mask)
            next_tokens = out if next_tokens is None \
                else torch.where(mask, out, next_tokens)
            if rep != 1.0:
                idx = torch.tensor(members, device=self._device)
                self._seen[idx, out[idx]] = True
        self._last_tokens = next_tokens

    # -- one scheduler iteration ------------------------------------------
    def _admit_queued(self):
        """Admission at the iteration boundary: queued requests into free
        rows, in order (a request with nothing to generate finishes at
        once).  The paged engine defers at the queue head while its
        pages run short."""
        for i in range(self._num_slots):
            # a staged weight generation waits for an empty boundary: a
            # fresh admission would pin the old one and starve the install
            if not self._queue or self._staged_adoption is not None:
                break
            if self._slots[i] is not None:
                continue
            req = self._queue.pop(0)
            if req.max_new_tokens <= 0:
                self._store_result(req, [], 0, "ok")
                continue
            try:
                self._admit(req, i)
            except _AdmissionDeferred:
                self._emit("engine.defer", req.rid,
                           free_pages=self._bp.free_count)
                self._queue.insert(0, req)
                break
            except Exception as exc:
                # a failed admission leaves the row free
                if self._slots[i] is not None and self._slots[i].req is req:
                    self._slots[i] = None
                self._quarantine_request(req, exc, "serving.admit", row=i)

    def _advance_prefills(self):
        """The paged engine's chunk phase (a slot prefill is whole)."""

    def _after_decode(self):
        """The iteration's tail after the pooled call (the paged engine
        runs a deferred restore here)."""

    def step(self):
        """One iteration: the deadline sweep, the install of a staged
        weight generation once no slot is occupied, ONE prefill chunk per
        prefilling slot (paged), admissions (none while a generation is
        staged; the paged engine deferring at the queue head on transient
        page exhaustion), the ``serving.step`` site once a decoding slot,
        then ONE pooled decode step or verify call over every decoding
        slot.  Returns the ids of the requests that reached a terminal
        status this iteration.  While tracing, the iteration is one
        ``engine.iteration`` span."""
        tr = _tracer()
        if not tr.active:
            return self._step_impl()
        with tr.span("engine.iteration", tag=self._trace_tag,
                     step=self._steps):
            return self._step_impl()

    def _step_impl(self):
        finished_before = set(self._results)
        self._evict_expired()
        self._maybe_install_adoption()
        with self._bound_leaves():
            self._iterate()
        return [r for r in self._results if r not in finished_before]

    def _iterate(self):
        """The iteration after the install: chunks, admissions, the
        ``serving.step`` site, the pooled decode call and its tail."""
        self._advance_prefills()
        self._admit_queued()
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and not s.prefilling]
        # every decoding slot rides the generation it was admitted under
        # (installs happen only at empty boundaries)
        assert all(self._slots[i].param_gen == self._param_gen
                   for i in active), "slot outlived a weight install"
        for i in list(active):
            try:
                _inject("serving.step", key=self._slots[i].req.rid)
            except Exception as exc:
                self._quarantine(i, exc, "serving.step")
                active.remove(i)
        if active:
            self._decode_active(active)
        self._after_decode()

    @contextlib.contextmanager
    def _bound_leaves(self):
        """This engine's weight generation on the model for the block:
        its installed leaves rebound onto the model's parameters, the
        model's own put back after (nothing while it serves the model's
        own)."""
        if self._leaves is None:
            yield
            return
        own = self._dec._live_param_leaves()
        self._dec.install_leaves(self._leaves)
        self._own_leaves = own
        try:
            yield
        finally:
            self._own_leaves = None
            self._dec.install_leaves(own)

    @contextlib.contextmanager
    def _draft_leaves(self):
        """The draft model's own parameters for the block: where the
        draft is the target itself and this engine's generation is bound
        on it, the model's own leaves are put back meanwhile."""
        if self._draft is not self._model or self._own_leaves is None:
            yield
            return
        self._dec.install_leaves(self._own_leaves)
        try:
            yield
        finally:
            self._dec.install_leaves(self._leaves)

    def take_result(self, rid):
        """Pop one finished request's output: (1, Tp + generated) int32
        tensor on the CPU."""
        return self._results.pop(rid)

    # -- external control --------------------------------------------------
    def cancel(self, rid) -> bool:
        """Cancel one non-terminal request now: a queued one finishes
        ``cancelled`` with an empty output (its prompt); an active one is
        evicted through the scrub path every failure takes (the paged
        engine returns its pages) and finishes ``cancelled`` with its
        partial output.  Every other stream is untouched.  Returns False
        for a rid that is unknown or already terminal."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                self._emit("engine.cancel", rid)
                self._store_result(req, [], 0, "cancelled")
                return True
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.req.rid == rid:
                self._slots[i] = None
                self._scrub_row(i)
                self._emit("engine.cancel", rid)
                self._store_result(slot.req, slot.emitted, i, "cancelled")
                return True
        return False

    # -- live weight hot-swap ----------------------------------------------
    @staticmethod
    def _hotswap_enabled():
        """``MXTPU_HOTSWAP`` (default on): ``0`` refuses every ``adopt``
        in the process, so an operator can freeze the weights."""
        return os.environ.get("MXTPU_HOTSWAP", "1").strip().lower() \
            not in ("0", "false", "off")

    def adopt(self, checkpoint):
        """Stage a verified checkpoint as the NEXT weight generation; it
        installs at the first iteration boundary with no occupied slot.
        Returns the staged generation number.

        - The checkpoint is CRC-verified on the host
          (:func:`~mxtpu_torch.resilience.checkpoint.verify`, its
          manifest required) and its arrays checked against the model's
          parameters before anything changes: a corrupt or torn file
          raises :class:`~mxtpu_torch.resilience.CorruptCheckpointError`
          (a mismatched one ``ValueError``) and the engine keeps serving
          its generation untouched.
        - In-flight streams finish on the generation they were admitted
          under: the install waits for every slot to drain, and no
          request is admitted while a generation is staged.
        - Requests admitted after the install ride the new generation;
          the cached prefix state (index, pinned and host tiers,
          sessions) is dropped at install, its K/V being the old
          weights'.
        - :meth:`rollback` stages the previous generation the same way.

        ``checkpoint`` is the path of a pickle of ``{"params": {name:
        array}, ...}`` or of ``{name: array}`` (the reference's names,
        instance prefix or not), written by ``write_verified``.  The
        ``serving.adopt`` site fires first, keyed by the file's basename:
        a raise is an adoption that never started."""
        import pickle

        from ..resilience.checkpoint import (CorruptCheckpointError,
                                             verify as _ckpt_verify)

        if not self._hotswap_enabled():
            raise RuntimeError(
                "live weight hot-swap is disabled (MXTPU_HOTSWAP=0) — "
                "adopt() refused; the serving generation is frozen")
        name = os.path.basename(str(checkpoint))
        try:
            _inject("serving.adopt", key=name)
            with open(checkpoint, "rb") as f:
                payload = f.read()
            _ckpt_verify(str(checkpoint), required=True, data=payload)
            try:
                blob = pickle.loads(payload)
            except Exception as exc:
                raise CorruptCheckpointError(
                    "checkpoint payload failed to unpickle: %s" % exc,
                    path=str(checkpoint))
            del payload
            named = blob.get("params", blob) if isinstance(blob, dict) \
                else None
            if not isinstance(named, dict):
                raise CorruptCheckpointError(
                    "checkpoint payload is not a params mapping (got %s)"
                    % type(blob).__name__, path=str(checkpoint))
            leaves = self._dec.prepare_adoption(named, path=checkpoint)
        except Exception as exc:
            self._adoption_failures += 1
            _bump("adoption_failures")
            self._emit("serving.adopt", None, stage="failed",
                       checkpoint=name, error=type(exc).__name__,
                       param_generation=self._param_gen)
            self._flight_failure("adoption_failed", checkpoint=name,
                                 error=type(exc).__name__,
                                 param_generation=self._param_gen)
            raise
        return self._stage_leaves(leaves, name)

    def rollback(self):
        """Stage the PREVIOUS weight generation (kept on the device until
        the next install, so no checkpoint is read).  Same boundary
        semantics as :meth:`adopt`; raises ``RuntimeError`` when no
        adoption has installed yet."""
        if self._prev_leaves is None:
            raise RuntimeError(
                "rollback() has no previous weight generation — no "
                "adoption has installed on this engine yet")
        self._rollbacks += 1
        _bump("adoption_rollbacks")
        self._emit("serving.rollback", None,
                   param_generation=self._param_gen)
        return self._stage_leaves(self._prev_leaves, "<rollback>")

    def _stage_leaves(self, leaves, name):
        """The tail of adopt and rollback: park the placed leaves; the
        admissions wait until the slots drain to an empty boundary."""
        self._staged_adoption = leaves
        self._adoption_staged_step = self._steps
        self._emit("serving.adopt", None, stage="staged", checkpoint=name,
                   param_generation=self._param_gen,
                   active_slots=self.active)
        return self._param_gen + 1

    def _maybe_install_adoption(self):
        """Iteration-boundary install: with a generation staged and no
        occupied slot, make the staged leaves this engine's generation
        (keeping the live ones, the model's own before any install, for
        rollback), bump the generation and drop every cached prefix
        (computed under the old weights).  Runs first in the iteration,
        so its admissions already ride the new generation; the model
        itself is left as it is (``_bound_leaves``)."""
        if self._staged_adoption is None:
            return
        if any(s is not None for s in self._slots):
            return                      # streams still on the old one
        self._prev_leaves = (self._leaves if self._leaves is not None
                             else self._dec._live_param_leaves())
        self._leaves = self._staged_adoption
        self._staged_adoption = None
        self._param_gen += 1
        self._last_adoption_steps = self._steps - self._adoption_staged_step
        self._adoption_staged_step = None
        self._adoptions += 1
        _bump("adoptions")
        freed = self.drop_cache()
        self._emit("serving.adopt", None, stage="installed",
                   param_generation=self._param_gen,
                   latency_steps=self._last_adoption_steps,
                   dropped_pages=freed)

    def _iterations_left(self):
        """An upper bound on the iterations the queue and the slots still
        need (a request with retries may restart as often)."""
        return sum((1 + r.retries_left) * r.max_new_tokens
                   for r in self._queue) + sum(
            (1 + s.req.retries_left) * s.req.max_new_tokens - s.n_emitted
            for s in self._slots if s is not None)

    def run(self):
        """Drain the queue and every slot; returns {request id →
        (1, Tp + generated) int32 CPU tensor}."""
        limit = 4 * (self._iterations_left() + len(self._queue)
                     + self._num_slots + 1)
        guard = 0
        while self._queue or any(s is not None for s in self._slots):
            self.step()
            guard += 1
            if guard > limit:
                raise RuntimeError(
                    "continuous-batching run() failed to converge — "
                    "scheduler bug")
        out, self._results = self._results, {}
        return out


class _HostPage:
    """One page of a spilled chain in host memory: row ``index`` of the
    chain's host buffer (``TransformerLM.read_pages``' form)."""

    __slots__ = ("buf", "index")

    def __init__(self, buf, index):
        self.buf = buf
        self.index = index


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """Iteration-level scheduler over a paged KV pool (module docstring).

    Parameters as :class:`ContinuousBatchingEngine`, and:

    block_size : tokens per page.
    num_blocks : pool capacity in pages (page 0 comes on top).  Default
        ``num_slots * ceil(max_length / block_size)``.
    prefill_chunk : tokens ingested per iteration while prefilling
        (power of two >= 8).  Chunk lengths are padded to the
        power-of-two ladder, as the reference pads them to its compiled
        shapes, which keeps the chunk plan, and so the page ids,
        identical to the reference's.
    pin_bytes : the pinned tier's budget: finished requests' full-page
        chains stay pinned in the pool under an LRU policy holding at
        most ``pin_bytes // bytes_per_block`` distinct pages.  An int or
        a "16MiB"-style string; None reads ``MXTPU_PIN_BYTES`` (unset:
        0, off).  Session chains pin regardless of it.
    host_cache_bytes : the host tier's budget: chains evicted from the
        pinned tier spill to pinned host memory (``serving.swap_out``)
        and are restored on a radix miss (``serving.swap_in``).  Same
        forms; None reads ``MXTPU_HOST_CACHE_BYTES`` (unset: 0, off).
    overlap_swaps : restore at the iteration boundary instead of inside
        admission: a request whose prompt the host tier matches defers
        once, the pooled decode step is issued first, and the restore
        runs after it.  The streams are the same as without it wherever
        that restore fits when it runs; a request defers for a restore
        once an attempt (the reference's rule), so under sustained pool
        pressure one whose restore does not fit recomputes its prefix
        instead (another chunk plan: other bits in bf16).

    A request whose worst-case page need exceeds the whole pool is shed
    at ``submit`` with :class:`~mxtpu_torch.base.LoadShedError`.  With
    ``draft_block`` the target verifies the draft's window (its last
    token and up to spec_k drafts, padded to a power of two) through K1,
    over float or int8 pools; the draft keeps its own contiguous slot
    cache.
    """

    _supports_sessions = True

    def __init__(self, model, num_slots: int = 4, max_length: int = 256,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 64, spec_k: int = 0,
                 spec_ngram: int = 3, spec_tree=None, draft_block=None,
                 history: int = 1024, cache_dtype=None, device=None,
                 max_pending: Optional[int] = None, clock=None,
                 pin_bytes=None, host_cache_bytes=None,
                 overlap_swaps: bool = False,
                 ledger_tag: Optional[str] = None, mesh=None, rules=None,
                 cache_spec=DEFAULT_CACHE_SPEC, draft_rules=None):
        bs = int(block_size)
        chunk = int(prefill_chunk)
        if bs < 1:
            raise ValueError("block_size must be >= 1, got %d" % bs)
        if chunk < 8 or (chunk & (chunk - 1)):
            raise ValueError("prefill_chunk must be a power of two >= 8, "
                             "got %d" % chunk)
        self._bs = bs
        self._chunk = chunk
        self._num_blocks = num_blocks
        self._prefill_chunks = 0
        self._prefill_tokens = 0
        self._prefix_hits = 0
        self._cow_copies = 0
        # -- hierarchical prefix cache -----------------------------------
        self._pin_bytes = self._budget_bytes(pin_bytes, "MXTPU_PIN_BYTES")
        self._host_bytes = self._budget_bytes(host_cache_bytes,
                                              "MXTPU_HOST_CACHE_BYTES")
        self._sessions: Dict[Any, int] = {}   # sid -> turns submitted
        self._swap_ins = 0              # pages restored host -> device
        self._swap_outs = 0             # pages spilled device -> host
        self._swap_out_failures = 0     # spills whose copy raised
        self._session_hits = 0
        self._prefill_tokens_avoided = 0
        self._in_flight: List[tuple] = []   # (event, host buffer)
        self._overlap_swaps = bool(overlap_swaps)
        self._swap_pending: Optional[Request] = None
        self._swap_attempted: set = set()   # rids already deferred once
        self._deferred_swap_ins = 0
        super().__init__(model, num_slots, max_length, spec_k=spec_k,
                         spec_ngram=spec_ngram, spec_tree=spec_tree,
                         draft_block=draft_block, history=history,
                         cache_dtype=cache_dtype, device=device,
                         max_pending=max_pending, clock=clock,
                         ledger_tag=ledger_tag, mesh=mesh, rules=rules,
                         cache_spec=cache_spec, draft_rules=draft_rules)

    def _init_cache(self):
        """The page pool, its allocator, the prefix index and the
        hierarchical cache's policy."""
        bs = self._bs
        # table width: every request's pages plus headroom for the last
        # chunk's bucket padding (padded writes stay inside the request's
        # own pages)
        self._M = -(-(self._max_length + self._chunk) // bs)
        num_blocks = self._num_blocks
        if num_blocks is None:
            num_blocks = self._num_slots * (-(-self._max_length // bs))
        self._prefix = PrefixIndex(bs)
        self._bp = BlockPool(int(num_blocks), bs, on_free=self._prefix.evict)
        self._pools = self._dec.init_block_pool(self._bp.capacity + 1, bs,
                                                  self._cache_dtype)
        self._slot_pages: List[Optional[List[int]]] = [None] * self._num_slots
        # a page priced from the pools as allocated: every pool tensor's
        # row, the (k, v) leaves of each layer, an int8 leaf's payload
        # and scales both.  The two budgets price different memories, as
        # the reference's do: the pinned tier a device's (one rank's
        # heads), the host tier the whole page (every rank's heads)
        per_rank = sum(t[0].numel() * t.element_size()
                       for t in pool_tensors(self._pools))
        self._bytes_per_block = per_rank * self._dec.tp
        self._moe = self._dec._block_has_moe()
        # a routed model shares no prefix, so its cache has no budget and
        # never holds a chain (sessions are refused at submit)
        self._hc = HierarchicalCache(
            self._bp, self._prefix,
            pin_blocks=0 if self._moe else self._pin_bytes // per_rank,
            host_blocks=0 if self._moe
            else self._host_bytes // self._bytes_per_block)

    @staticmethod
    def _budget_bytes(value, env):
        """One tier's budget: an int or "16MiB"-style string, else the
        environment variable, else 0 (the tier off)."""
        if value is None:
            value = os.environ.get(env, 0)
        return int(parse_bytes(value))

    @property
    def stats(self):
        st = super().stats
        st.update({
            "prefill_chunks": self._prefill_chunks,
            "prefill_tokens": self._prefill_tokens,
            "blocks_in_use": self._bp.in_use,
            "blocks_free": self._bp.free_count,
            "blocks_shared": self._bp.shared_count,
            "shared_extra_refs": self._bp.shared_extra_refs,
            "prefix_hit_requests": self._prefix_hits,
            "cow_copied_blocks": self._cow_copies,
            "block_size": self._bs,
            "num_blocks": self._bp.capacity,
            "pinned_blocks": self._hc.pinned_blocks,
            "spilled_blocks": self._hc.spilled_blocks,
            "swapped_in_blocks": self._swap_ins,
            "swapped_out_blocks": self._swap_outs,
            "swap_out_failures": self._swap_out_failures,
            "deferred_swap_in_requests": self._deferred_swap_ins,
            "session_hit_requests": self._session_hits,
            "sessions_open": len(self._sessions),
            "prefill_tokens_avoided": self._prefill_tokens_avoided,
        })
        return st

    # -- hierarchical prefix cache -----------------------------------------
    def _hierarchy_on(self):
        """Whether finished chains are worth pinning: an auto-pin
        budget, a host tier, or at least one open session."""
        return (self._hc.pin_blocks > 0 or self._hc.host_blocks > 0
                or bool(self._sessions))

    def _hold(self, buf):
        """Keep the host buffer of a copy just issued alive until an
        event after it completes, whatever the host tier drops
        meanwhile."""
        if self._device.type != "cuda":
            return
        self._in_flight = [(e, b) for e, b in self._in_flight
                           if not e.query()]
        ev = torch.cuda.Event()
        ev.record()
        self._in_flight.append((ev, buf))

    def _read_pages(self, pages):
        """Device-to-host copy of pages (one gather a pool tensor, one
        copy): one host entry a page, each a row of the same buffer."""
        buf = self._dec.read_pages(self._pools, pages)
        self._hold(buf)
        return [_HostPage(buf, i) for i in range(len(pages))]

    def _write_pages(self, pages, content):
        """Host-to-device restore of ``content`` (consecutive entries of
        one spill, so one slice of its buffer) into ``pages``."""
        first = content[0]
        assert all(e.buf is first.buf and e.index == first.index + j
                   for j, e in enumerate(content))
        self._dec.write_pages(self._pools, pages, first.buf, first.index)
        self._hold(first.buf)

    def _spill_chain(self, chain):
        """Evict one pinned chain from the device tier: copy its pages
        to host (budget permitting), then unpin.  The
        ``serving.swap_out`` site fires once a spill; a raise there or in
        the copy drops the chain without a host copy (a recompute on the
        next miss, never a wrong page) and counts in
        ``swap_out_failures``."""
        content = None
        if self._hc.host_blocks >= len(chain.pages):
            try:
                _inject("serving.swap_out")
                content = self._read_pages(chain.pages)
            except Exception:
                self._swap_out_failures += 1
                content = None
        if content is not None:
            self._hc.spill(chain, content)
            self._emit("engine.swap_out", None, pages=len(chain.pages),
                       dropped=False)
            self._swap_outs += len(chain.pages)
        else:
            self._emit("engine.swap_out", None, pages=len(chain.pages),
                       dropped=True)
            self._hc.drop_chain(chain)

    def _enforce_pin_budget(self):
        while True:
            victim = self._hc.pick_budget_victim()
            if victim is None:
                return
            self._spill_chain(victim)

    def _reclaim(self, short):
        """Pool pressure: spill pinned chains (non-session LRU first,
        sessions last) until ``short`` pages freed or nothing evictable
        remains — live admissions beat cached prefixes."""
        while short > 0:
            victim = self._hc.pick_pressure_victim()
            if victim is None:
                return
            before = self._bp.free_count
            self._spill_chain(victim)
            short -= self._bp.free_count - before

    def _try_swap_in(self, req, full):
        """Host-tier lookup at admission: when a spilled chain matches
        more of the prompt than the device walk's ``full`` pages,
        restore the missing pages, index them and pin the chain.
        Returns True whenever the pool was touched (pages restored, or a
        reclaim ran for a restore that then could not fit): the caller
        re-walks the index, since a reclaim may have freed pages of the
        first walk.  The ``serving.swap_in`` site fires before the
        restore; a raise releases the pages it allocated and propagates
        to the admission's quarantine."""
        if not self._hc.host_chains:
            return False
        Tp = req.prompt.shape[1]
        match = self._hc.host_match(req.prompt[0], limit=Tp - 1)
        if match is None or match[1] <= len(full):
            return False
        chain, npages = match
        extra = npages - len(full)
        # hold the device-matched prefix across the reclaim below: a
        # spill may otherwise free (and recycle) exactly these pages
        for bid in full:
            self._bp.retain(bid)
        try:
            if extra > self._bp.free_count:
                self._reclaim(extra - self._bp.free_count)
            if extra > self._bp.free_count:
                return True
            _inject("serving.swap_in", key=req.rid)
            fresh = self._bp.alloc(extra)
            try:
                self._write_pages(fresh, chain.content[len(full):npages])
            except Exception:
                for bid in fresh:
                    self._bp.release(bid)
                raise
            tokens = chain.tokens[:npages * self._bs]
            self._prefix.register(tokens, list(full) + fresh)
            pages, _ = self._prefix.lookup(tokens, limit=len(tokens))
            self._hc.pin_chain(tokens, pages, sid=chain.sid)
            if npages == len(chain.content):
                self._hc.drop_host(chain)
            # else a partial restore keeps the host copy: a session's
            # unrestored tail stays recoverable for its next turn.  The
            # allocation's reference hands over to the pin.
            for bid in fresh:
                self._bp.release(bid)
        finally:
            for bid in full:
                self._bp.release(bid)
        self._emit("engine.swap_in", req.rid, pages=len(fresh))
        self._swap_ins += len(fresh)
        return True

    def _offer_chain(self, row, req):
        """Finish-time tail of a request that ended ``ok``: register the
        full written pages of its final sequence (prompt and emitted
        tokens) and pin the chain.  The last token's K/V is never
        written, so only pages fully below ``len(seq) - 1`` count; a
        speculative window's rejected lanes lie past it too.  A session
        closed while the request was in flight degrades to an ordinary
        budget-governed pin."""
        sid = req.session
        if sid is not None and sid not in self._sessions:
            sid = None
        if sid is None and self._hc.pin_blocks <= 0 \
                and self._hc.host_blocks <= 0:
            return
        pages = self._slot_pages[row]
        seq = self._results[req.rid][0].tolist()
        fullp = min((len(seq) - 1) // self._bs, len(pages))
        if fullp <= 0:
            return
        self._prefix.register(seq, pages[:fullp])
        tokens = tuple(seq[:fullp * self._bs])
        chain_pages, _ = self._prefix.lookup(tokens, limit=len(tokens))
        if len(chain_pages) < fullp:
            return                      # raced an eviction: nothing to pin
        self._hc.pin_chain(tokens, chain_pages, sid=sid)
        self._enforce_pin_budget()

    def close_session(self, sid) -> int:
        """Release one conversation's chains from both tiers (device pins
        unpin, host copies drop).  Unknown sids are a no-op; in-flight
        requests of the session keep their own pages.  Returns the device
        pages freed."""
        self._sessions.pop(sid, None)
        return self._hc.close_session(sid)

    def prefix_probe(self, prompt_ids) -> int:
        """The radix walk's hit length or, when a spilled chain would
        beat it, the host tier's page-aligned match.  Read-only: no
        refcount, tick or restore."""
        arr = np.asarray(torch.as_tensor(prompt_ids).cpu())
        if arr.ndim != 2 or arr.shape[0] != 1:
            raise ValueError("prefix_probe takes ONE prompt: (1, T), got %r"
                             % (arr.shape,))
        if self._moe:
            return 0            # a routed model opts out of sharing
        Tp = arr.shape[1]
        n = self._prefix.probe(arr[0], limit=Tp - 1)
        if self._hc.host_chains:
            m = self._hc.host_match(arr[0], limit=Tp - 1)
            if m is not None:
                n = max(n, m[1] * self._bs)
        return n

    def drop_cache(self) -> int:
        """Release both tiers and every open session: pinned chains drop
        without a host copy, host copies drop, and the index entries
        evict as their pages return.  Returns the device pages freed."""
        self._sessions.clear()
        self._swap_pending = None
        self._swap_attempted.clear()
        freed = 0
        for chain in list(self._hc._chains.values()):
            before = self._bp.free_count
            self._hc.drop_chain(chain)
            freed += self._bp.free_count - before
        for host in list(self._hc._host.values()):
            self._hc.drop_host(host)
        return freed

    # -- request intake --------------------------------------------------
    def _plan_chunks(self, start, Tp):
        """Chunk schedule over prompt positions [start, Tp), the
        reference's: chunk shapes stay on the power-of-two ladder
        (<= prefill_chunk) and descend it where bucket padding would
        spill past the slot extent; a routed model's chunks are
        unpadded, min(rest, prefill_chunk) tokens (padded tokens would
        join its routing).  Returns the schedule and the padded extent
        (the last position any chunk's padding writes)."""
        cap = -(-self._max_length // self._bs) * self._bs
        chunks, extent = [], 0
        while start < Tp:
            rem = Tp - start
            if self._moe:
                Tact = Tb = min(rem, self._chunk)
                chunks.append((start, Tact, Tb))
                extent = max(extent, start + Tb)
                start += Tact
                continue
            Tb = min(_bucket(rem), self._chunk)
            while Tb > 8 and start + Tb > cap:
                Tb //= 2
            Tact = min(rem, Tb)
            chunks.append((start, Tact, Tb))
            extent = max(extent, start + Tb)
            start += Tact
        return chunks, extent

    def _pages_needed(self, Tp, max_new):
        """Worst-case (share-nothing) page count of one request."""
        _, extent = self._plan_chunks(0, Tp)
        return -(-max(Tp + max_new, extent) // self._bs)

    def _check_capacity(self, Tp, max_new):
        need = self._pages_needed(Tp, max_new)
        if need > self._bp.capacity:
            self._shed += 1
            _bump("shed_requests")
            self._emit("engine.shed", None, pages_needed=need,
                       pool_capacity=self._bp.capacity)
            self._flight_failure("shed", pages_needed=need,
                                 pool_capacity=self._bp.capacity)
            raise LoadShedError(
                "request needs %d page(s) > pool capacity %d "
                "(block_size=%d): can never be admitted — shed"
                % (need, self._bp.capacity, self._bs),
                queue_depth=len(self._queue), limit=self._bp.capacity,
                permanent=True)

    def submit(self, prompt_ids, max_new_tokens, temperature=0.0, top_k=0,
               top_p=0.0, repetition_penalty=1.0, seed=None, eos_id=None,
               deadline_s=None, retries=0, speculative=None, session=None,
               spec_tree=None) -> int:
        """The base ``submit``; a ``session`` handle is counted open until
        ``close_session``.  A routed (MoE) model refuses ``session``: it
        shares no prefix, so a chain cannot be reused across turns."""
        if session is not None and self._moe:
            raise ValueError(
                "submit(session=...) is unsupported for MoE blocks: they "
                "opt out of prefix sharing (expert capacity budgets from "
                "the FULL prompt length), and a chain that cannot be shared "
                "cannot be reused across turns")
        rid = super().submit(prompt_ids, max_new_tokens, temperature, top_k,
                             top_p, repetition_penalty, seed, eos_id,
                             deadline_s, retries, speculative, session,
                             spec_tree)
        if session is not None:
            self._sessions[session] = self._sessions.get(session, 0) + 1
        return rid

    # -- admission -------------------------------------------------------
    def _table_row(self, row):
        t = np.full((self._M,), NULL_PAGE, np.int32)
        pages = self._slot_pages[row]
        if pages:
            t[:len(pages)] = pages
        return t

    def _admit(self, req, row):
        """Prefix lookup (with the host tier), page allocation and chunk
        plan; the first chunk (after the copy-on-write clone) runs at
        once, so a prompt no longer than one chunk finishes admission
        this iteration.  The matched pages and the copy-on-write donor
        are held before any reclaim, so a spill cannot free them."""
        _inject("serving.admit", key=req.rid)
        Tp = req.prompt.shape[1]
        self._emit("engine.admit", req.rid, prompt_tokens=Tp)
        full, partial = [], None
        if not self._moe:
            # a routed model's prefix K/V depends on its whole prompt
            # (capacity budgets from it): it skips the lookup and restores
            _inject("serving.prefix_lookup", key=req.rid)
            full, partial = self._prefix.lookup(req.prompt[0], limit=Tp - 1)
            if self._overlap_swaps:
                # restores run only at the iteration boundary
                # (_service_pending_swap): a cold-chain admission defers
                # once
                if (req.rid not in self._swap_attempted
                        and self._hc.host_chains):
                    m = self._hc.host_match(req.prompt[0], limit=Tp - 1)
                    if m is not None and m[1] > len(full):
                        self._swap_pending = req
                        raise _AdmissionDeferred()
            elif self._try_swap_in(req, full):
                # a restore adds pages and its reclaim may have freed some
                # of the first walk's: walk again
                full, partial = self._prefix.lookup(req.prompt[0],
                                                    limit=Tp - 1)
        n_shared = len(full) * self._bs + (partial[1] if partial else 0)
        chunks, extent = self._plan_chunks(n_shared, Tp)
        n_pages = -(-max(Tp + req.max_new_tokens, extent) // self._bs)
        need = n_pages - len(full)
        _inject("serving.block_alloc", key=req.rid)
        held = list(full) + ([partial[0]] if partial else [])
        for bid in held:
            self._bp.retain(bid)
        try:
            if need > self._bp.free_count:
                self._reclaim(need - self._bp.free_count)
            if need > self._bp.free_count:
                raise _AdmissionDeferred()
            fresh = self._bp.alloc(need)
        except BaseException:
            for bid in held:
                self._bp.release(bid)
            raise
        if partial:
            # the donor's hold only had to span the reclaim: the clone
            # runs in this admission's first chunk
            self._bp.release(partial[0])
        pages = list(full) + fresh      # the holds on `full` are its refs
        self._slot_pages[row] = pages
        cow = None
        if full or partial:
            self._prefix_hits += 1
        if n_shared:
            self._emit("engine.prefix_hit", req.rid, tokens=n_shared,
                       pages=len(full), session=req.session is not None)
            self._prefill_tokens_avoided += n_shared
            self._hc.touch_prefix(req.prompt[0], Tp - 1)
            if req.session is not None:
                self._session_hits += 1
        if partial:
            cow = (partial[0], pages[len(full)])
            self._emit("engine.cow", req.rid, src=int(partial[0]),
                       dst=int(pages[len(full)]))
            self._cow_copies += 1
        self._slots[row] = _PagedSlot(req, row, chunks, cow, self._param_gen)
        self._status[req.rid] = "active"
        self._swap_attempted.discard(req.rid)
        self._advance_prefill(row)

    def _advance_prefill(self, row):
        """Run ONE prefill chunk of a prefilling slot; the last chunk
        samples the first token from the prompt's last real logit row."""
        slot = self._slots[row]
        req = slot.req
        start, Tact, Tb = slot.chunks[slot.chunk_i]
        self._emit("engine.prefill_chunk", req.rid, index=slot.chunk_i,
                   start=start, tokens=Tact)
        raw = np.zeros((1, Tb), np.int64)
        raw[0, :Tact] = req.prompt[0, start:start + Tact]
        if slot.cow is not None:
            # the clone lands before this chunk writes into its page
            self._dec.copy_block(self._pools, *slot.cow)
            slot.cow = None
        table = torch.from_numpy(self._table_row(row)).to(self._device)
        # a routed model budgets every chunk's capacity from the prompt
        logits = self._dec.prefill_pages(
            torch.from_numpy(raw).to(self._device), self._pools, table,
            start, total_len=slot.Tp if self._moe else None)
        slot.chunk_i += 1
        self._prefill_chunks += 1
        self._prefill_tokens += Tact
        if slot.chunk_i < len(slot.chunks):
            return                           # more chunks next iteration
        self._first_token(slot, logits[:, slot.Tp - 1 - start])

    def _prefilled(self, slot):
        # prompt pages fully below Tp are now immutable (a routed model's
        # are never shared)
        if self._moe:
            return
        self._prefix.register(slot.req.prompt[0],
                              self._slot_pages[slot.row][:slot.Tp // self._bs])

    def _retire(self, row, req):
        """Pin the finished request's chain (before the row's release, so
        its pages never transiently free), then release the row."""
        if self._hierarchy_on():
            self._offer_chain(row, req)
        self._release(row)

    def _release(self, row):
        """The last reference frees a page and evicts its prefix-index
        entry; a row already released is left as it is."""
        pages, self._slot_pages[row] = self._slot_pages[row], None
        for bid in pages or ():
            self._bp.release(bid)

    def _terminal(self, rid, status="ok"):
        super()._terminal(rid, status)
        # a deferred restore's rid that ends on any path is forgotten
        self._swap_attempted.discard(rid)

    # -- decode hooks ----------------------------------------------------
    def _spec_extent(self, slot):
        """Token capacity of the slot's pages: a drafted window clamps
        here, so a verify write never needs a page the slot lacks."""
        return len(self._slot_pages[slot.row]) * self._bs

    def _decode_state(self, active):
        """pos (B,) and tables (B, M) int32 on the device: dead lanes
        carry all-null tables and position 0."""
        pos = np.zeros((self._num_slots,), np.int32)
        tables = np.zeros((self._num_slots, self._M), np.int32)
        for i in active:
            pos[i] = self._slots[i].pos
            tables[i] = self._table_row(i)
        return (torch.from_numpy(pos).to(self._device),
                torch.from_numpy(tables).to(self._device))

    def _run_step(self, state):
        pos, tables = state
        return self._dec.step_pages(self._last_tokens.reshape(-1, 1),
                                      self._pools, tables, pos)

    def _run_verify(self, state, window, valid_len):
        pos, tables = state
        return self._dec.verify_pages(window, self._pools, tables, pos,
                                        valid_len)

    def _run_verify_tree(self, state, window, valid_len, perm, depth, anc):
        pos, tables = state
        return self._dec.verify_pages(window, self._pools, tables, pos,
                                        valid_len, tree=(depth, anc))

    def _run_fixup(self, state, src_lane):
        pos, tables = state
        self._dec.permute_pool_span(self._pools, tables, pos, src_lane)

    # -- one scheduler iteration ------------------------------------------
    def _advance_prefills(self):
        """One chunk a prefilling slot; a failing chunk quarantines its
        request under the admission site."""
        for i in range(self._num_slots):
            s = self._slots[i]
            if s is not None and s.prefilling:
                try:
                    self._advance_prefill(i)
                except Exception as exc:
                    self._quarantine(i, exc, "serving.admit")

    def _after_decode(self):
        self._service_pending_swap()

    def _service_pending_swap(self):
        """With ``overlap_swaps``: run the restore an admission deferred,
        after the pooled decode step was issued.  The request waits at
        the queue head and shares the restored pages at the next
        iteration's lookup.  A ``serving.swap_in`` fault quarantines
        only that request (a retry defers and restores again); each rid
        defers at most once an attempt."""
        req = self._swap_pending
        if req is None:
            return
        self._swap_pending = None
        self._swap_attempted.add(req.rid)
        if all(q.rid != req.rid for q in self._queue):
            return                      # evicted while deferred
        full, _ = self._prefix.lookup(req.prompt[0],
                                      limit=req.prompt.shape[1] - 1)
        try:
            if self._try_swap_in(req, full):
                self._deferred_swap_ins += 1
        except Exception as exc:
            # the admission-fault contract without the row scrub: the
            # request never left the queue
            self._queue = [q for q in self._queue if q.rid != req.rid]
            self._swap_attempted.discard(req.rid)
            self._quarantined += 1
            _bump("quarantined_slots")
            self._requeue_or_fail(req, exc, "serving.admit")

    def _iterations_left(self):
        """The base bound with every request's prefill chunks, plus
        room for the deferrals of a full pool (4 * capacity // 2)."""
        def iters(req, emitted=0):
            chunks = -(-req.prompt.shape[1] // self._chunk)
            return (1 + req.retries_left) * (
                req.max_new_tokens + chunks) - emitted

        return sum(iters(r) for r in self._queue) + sum(
            iters(s.req, s.n_emitted) for s in self._slots
            if s is not None) + self._bp.capacity // 2
