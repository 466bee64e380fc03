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

Not in this slice: the hierarchical cache and sessions, fault sites,
tracing, quarantine and retries, deadlines, bounded admission, weight
hot-swap, tensor parallelism.  ``submit`` raises
``NotImplementedError`` for their knobs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..base import LoadShedError, MXTPUError, resolve_device
from ..models import sampler
from ..models.transformer import TransformerLM
from ..ops.tensor import resolve_cache_dtype
from .paging import NULL_PAGE, BlockPool, PrefixIndex

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
                 "speculative", "spec_tree")

    def __init__(self, rid, prompt, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=0.0, repetition_penalty=1.0, seed=None, eos_id=None,
                 speculative=None, spec_tree=None):
        self.rid = rid
        self.prompt = prompt            # (1, Tp) int32 numpy
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature or 0.0)
        self.top_k = int(top_k or 0)
        self.top_p = float(top_p or 0.0)
        self.repetition_penalty = float(repetition_penalty or 1.0)
        self.seed = seed
        self.eos_id = eos_id
        self.speculative = speculative  # None = engine default
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
                 "history")

    def __init__(self, req, row):
        self.req = req
        self.row = row
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

    def __init__(self, req, row, chunks, cow):
        super().__init__(req, row)
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
    """

    def __init__(self, model, num_slots: int = 4, max_length: int = 256,
                 spec_k: int = 0, spec_ngram: int = 3, spec_tree=None,
                 draft_block=None, history: int = 1024, cache_dtype=None,
                 device=None):
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0, got %d" % spec_k)
        self._device = resolve_device(device)
        if not _same_device(model.device, self._device):
            raise MXTPUError("the model is on %s, the engine on %s"
                             % (model.device, self._device))
        self._model = model
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
        self._spec_on = self._spec_k > 0 or self._spec_tree is not None
        self._draft = draft_block
        self._draft_pool = None
        if draft_block is not None:
            if self._spec_k < 1:
                raise ValueError("draft_block needs spec_k >= 1 (it bounds "
                                 "the drafted window)")
            if not isinstance(draft_block, TransformerLM):
                raise ValueError(
                    "draft_block must be a dense port TransformerLM, not %s"
                    % type(draft_block).__name__)
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
            self._draft_pool = draft_block.init_cache(
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
        self._init_cache()

    def _init_cache(self):
        """The target's cache: one contiguous row a slot."""
        self._pool = self._model.init_cache(self._num_slots,
                                            self._max_length,
                                            self._cache_dtype)

    # -- introspection ---------------------------------------------------
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
            "shed_requests": self._shed,
            "drafted_tokens": self._drafted_tokens,
            "accepted_tokens": self._accepted_tokens,
            "tree_nodes_drafted": self._tree_nodes_drafted,
            "tree_paths": self._tree_paths,
            "slot_iterations": self._slot_iterations,
            "draft_hit_rate": (self._accepted_tokens / self._drafted_tokens
                               if self._drafted_tokens else 0.0),
            "verify_calls": self._verify_calls,
        }

    def status(self, rid) -> str:
        """``queued`` / ``active`` / ``ok`` (``unknown`` otherwise)."""
        return self._status.get(rid, "unknown")

    # -- request intake --------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens, temperature=0.0, top_k=0,
               top_p=0.0, repetition_penalty=1.0, seed=None, eos_id=None,
               deadline_s=None, retries=0, speculative=None, session=None,
               spec_tree=None) -> int:
        """Queue one request, prompt_ids (1, Tp); returns its id.
        temperature 0 is greedy; ``seed`` reproduces a sampled stream.
        ``speculative=False`` opts the request out of the engine's
        speculation; ``spec_tree`` is None (the engine's default), False
        (linear drafting) or the request's own tree config (a
        self-drafting engine only).  The output is the same in every
        mode."""
        for knob, value, default in (
                ("deadline_s", deadline_s, None), ("retries", retries, 0),
                ("session", session, None)):
            if value != default:
                raise NotImplementedError(
                    "submit(%s=...) is not ported to mxtpu_torch yet" % knob)
        if spec_tree is not None and spec_tree is not False:
            spec_tree = _parse_spec_tree(spec_tree)
            if not self._spec_on or self._drafter is None:
                raise ValueError(
                    "submit(spec_tree=...) needs a self-drafting "
                    "speculation-enabled engine (spec_k > 0 or spec_tree= "
                    "at construction, and no draft_block)")
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
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, prompt, max_new_tokens, temperature,
                                   top_k, top_p, repetition_penalty, seed,
                                   eos_id, speculative, spec_tree))
        self._status[rid] = "queued"
        return rid

    def _check_capacity(self, Tp, max_new):
        """Shed a request that can never be admitted (the paged engine's
        page budget); every request that fits max_length fits a row."""

    # -- admission -------------------------------------------------------
    def _slot_prefill(self, model, cache, cache_dtype, row, prompt):
        """Prefill ``prompt`` (1, Tp) int32 into row ``row`` of ``cache``
        (``model``'s): the prompt padded to the power-of-two ladder
        (capped at max_length) through a fresh batch-1 scratch cache,
        then copied into the row.  Returns the logits of the prompt's
        last real position, (1, V)."""
        Tp = prompt.shape[1]
        Tb = min(_bucket(Tp), self._max_length)
        raw = np.zeros((1, Tb), np.int64)
        raw[0, :Tp] = prompt[0]
        scratch = model.init_cache(1, Tb, cache_dtype)
        logits = model.prefill(torch.from_numpy(raw).to(self._device),
                               scratch)
        model.write_cache_slot(cache, scratch, row)
        return logits[:, Tp - 1]

    def _admit(self, req, row):
        """Slot prefill of the whole prompt, then the first token."""
        slot = _Slot(req, row)
        self._slots[row] = slot
        self._status[req.rid] = "active"
        last = self._slot_prefill(self._model, self._pool, self._cache_dtype,
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
                self._slot_prefill(self._draft, self._draft_pool,
                                   self._draft_cache_dtype, row, req.prompt)
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
        """Read the slot's tokens back, store the result and free the
        row."""
        slot = self._slots[row]
        req = slot.req
        pooled = [e for e in slot.emitted if not isinstance(e, _SpecTokens)]
        col = iter(torch.stack(pooled)[:, row].cpu().numpy()
                   if pooled else ())
        toks = []
        for e in slot.emitted:
            if isinstance(e, _SpecTokens):
                toks.extend(int(t) for t in e.toks)
            else:
                toks.append(int(next(col)))
        self._results[req.rid] = torch.from_numpy(np.concatenate(
            [req.prompt, np.asarray(toks, np.int32).reshape(1, -1)], axis=1))
        self._terminal(req.rid)
        self._slots[row] = None
        self._release(row)

    def _release(self, row):
        """Return a finished row's cache (the paged engine's pages)."""

    def _terminal(self, rid):
        """Mark a request ``ok``, dropping the status records of the
        oldest terminal requests past ``history``."""
        self._status[rid] = "ok"
        self._done.append(rid)
        if len(self._done) > self._history:
            for old in self._done[:-self._history]:
                self._status.pop(old, None)
            del self._done[:-self._history]

    # the decode hooks: the slot engine's forms (the paged engine adds
    # its block tables)
    def _decode_state(self, active):
        """pos (B,) int32 on the device: dead lanes at position 0."""
        pos = np.zeros((self._num_slots,), np.int32)
        for i in active:
            pos[i] = self._slots[i].pos
        return torch.from_numpy(pos).to(self._device)

    def _run_step(self, state):
        return self._model.step_slots(self._last_tokens.reshape(-1, 1),
                                      self._pool, state)

    def _run_verify(self, state, window, valid_len):
        return self._model.verify_slots(window, self._pool, state, valid_len)

    def _run_verify_tree(self, state, window, valid_len, perm, depth, anc):
        return self._model.verify_slots(window, self._pool, state, valid_len,
                                        tree=(perm, depth))

    def _run_fixup(self, state, src_lane):
        self._model.permute_cache_span(self._pool, state, src_lane)

    def _decode_active(self, active):
        """Draft, then ONE plain pooled step or ONE pooled verify call
        for every decoding slot: a tree verify when any slot drafted a
        tree (linear windows ride it as chains), else a linear one."""
        drafts = self._draft_phase(active)
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
        for i in active:
            s = self._slots[i]
            s.pos += 1
            s.n_emitted += 1
            s.emitted.append(self._last_tokens)
            if self._slot_done(s):
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
        or _TreeDraft}, empty drafts left out."""
        if not self._spec_on:
            return {}
        rows = [i for i in active if self._slots[i].history is not None]
        if not rows:
            return {}
        if self._draft is not None:
            return self._propose_model(rows)
        out = {}
        for i in rows:
            s = self._slots[i]
            cfg = self._tree_cfg_for(s.req)
            if cfg is not None:
                n = self._tree_budget(s, cfg[0])
                if n <= 0:
                    continue
                toks, par, _ = self._tree_drafter_for(cfg).propose_tree(
                    s.history, n, n)
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
            if d:
                out[i] = d
        return out

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
        for w in range(j + 1):
            logits = self._draft.step_slots(
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
        for i in self._commit(active, M_h, counts, states, nreal):
            self._finish(i)

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
        finished = self._commit(active, path_M, counts, states, nreal)
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

    def _commit(self, active, M_h, counts, states, nreal):
        """Emit each row's first counts[b] candidates M_h[b] (cut at
        eos): advance its position, draw stream, history and penalty
        row.  Returns the rows that are done, for the caller to finish
        (after the tree fix-up, which reads their tables)."""
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
            if not self._queue:
                break
            if self._slots[i] is not None:
                continue
            req = self._queue.pop(0)
            if req.max_new_tokens <= 0:
                self._results[req.rid] = torch.from_numpy(req.prompt.copy())
                self._terminal(req.rid)
                continue
            try:
                self._admit(req, i)
            except _AdmissionDeferred:
                self._queue.insert(0, req)
                break

    def _advance_prefills(self):
        """The paged engine's chunk phase (a slot prefill is whole)."""

    def step(self):
        """One iteration: ONE prefill chunk per prefilling slot (paged),
        admissions (the paged engine deferring at the queue head on
        transient page exhaustion), then ONE pooled decode step or
        verify call over every decoding slot.  Returns the ids of the
        requests finished this iteration."""
        finished_before = set(self._results)
        self._advance_prefills()
        self._admit_queued()
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and not s.prefilling]
        if active:
            self._decode_active(active)
        return [r for r in self._results if r not in finished_before]

    def take_result(self, rid):
        """Pop one finished request's output: (1, Tp + generated) int32
        tensor on the CPU."""
        return self._results.pop(rid)

    def _iterations_left(self):
        """An upper bound on the iterations the queue and the slots still
        need."""
        return sum(r.max_new_tokens + 1 for r in self._queue) + sum(
            s.req.max_new_tokens + 1 - s.n_emitted
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

    A request whose worst-case page need exceeds the whole pool is shed
    at ``submit`` with :class:`~mxtpu_torch.base.LoadShedError`.  With
    ``draft_block`` the target verifies the draft's window (its last
    token and up to spec_k drafts, padded to a power of two) through K1,
    over float or int8 pools; the draft keeps its own contiguous slot
    cache.
    """

    def __init__(self, model, num_slots: int = 4, max_length: int = 256,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 64, spec_k: int = 0,
                 spec_ngram: int = 3, spec_tree=None, draft_block=None,
                 history: int = 1024, cache_dtype=None, device=None):
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
        super().__init__(model, num_slots, max_length, spec_k=spec_k,
                         spec_ngram=spec_ngram, spec_tree=spec_tree,
                         draft_block=draft_block, history=history,
                         cache_dtype=cache_dtype, device=device)

    def _init_cache(self):
        """The page pool, its allocator and the prefix index."""
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
        self._pools = self._model.init_block_pool(self._bp.capacity + 1, bs,
                                                  self._cache_dtype)
        self._slot_pages: List[Optional[List[int]]] = [None] * self._num_slots

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
        })
        return st

    # -- request intake --------------------------------------------------
    def _plan_chunks(self, start, Tp):
        """Chunk schedule over prompt positions [start, Tp), the
        reference's: chunk shapes stay on the power-of-two ladder
        (<= prefill_chunk) and descend it where bucket padding would
        spill past the slot extent.  Returns the schedule and the padded
        extent (the last position any chunk's padding writes)."""
        cap = -(-self._max_length // self._bs) * self._bs
        chunks, extent = [], 0
        while start < Tp:
            rem = Tp - start
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
            raise LoadShedError(
                "request needs %d page(s) > pool capacity %d "
                "(block_size=%d): can never be admitted — shed"
                % (need, self._bp.capacity, self._bs),
                queue_depth=len(self._queue), limit=self._bp.capacity,
                permanent=True)

    # -- admission -------------------------------------------------------
    def _table_row(self, row):
        t = np.full((self._M,), NULL_PAGE, np.int32)
        pages = self._slot_pages[row]
        if pages:
            t[:len(pages)] = pages
        return t

    def _admit(self, req, row):
        """Prefix lookup, page allocation and chunk plan; the first chunk
        (after the copy-on-write clone) runs at once, so a prompt no
        longer than one chunk finishes admission this iteration."""
        Tp = req.prompt.shape[1]
        full, partial = self._prefix.lookup(req.prompt[0], limit=Tp - 1)
        n_shared = len(full) * self._bs + (partial[1] if partial else 0)
        chunks, extent = self._plan_chunks(n_shared, Tp)
        n_pages = -(-max(Tp + req.max_new_tokens, extent) // self._bs)
        need = n_pages - len(full)
        if need > self._bp.free_count:
            raise _AdmissionDeferred()
        fresh = self._bp.alloc(need)
        for bid in full:
            self._bp.retain(bid)
        pages = list(full) + fresh
        self._slot_pages[row] = pages
        cow = None
        if full or partial:
            self._prefix_hits += 1
        if partial:
            cow = (partial[0], pages[len(full)])
            self._cow_copies += 1
        self._slots[row] = _PagedSlot(req, row, chunks, cow)
        self._status[req.rid] = "active"
        self._advance_prefill(row)

    def _advance_prefill(self, row):
        """Run ONE prefill chunk of a prefilling slot; the last chunk
        samples the first token from the prompt's last real logit row."""
        slot = self._slots[row]
        req = slot.req
        start, Tact, Tb = slot.chunks[slot.chunk_i]
        raw = np.zeros((1, Tb), np.int64)
        raw[0, :Tact] = req.prompt[0, start:start + Tact]
        if slot.cow is not None:
            # the clone lands before this chunk writes into its page
            self._model.copy_block(self._pools, *slot.cow)
            slot.cow = None
        table = torch.from_numpy(self._table_row(row)).to(self._device)
        logits = self._model.prefill_pages(
            torch.from_numpy(raw).to(self._device), self._pools, table,
            start)
        slot.chunk_i += 1
        self._prefill_chunks += 1
        self._prefill_tokens += Tact
        if slot.chunk_i < len(slot.chunks):
            return                           # more chunks next iteration
        self._first_token(slot, logits[:, slot.Tp - 1 - start])

    def _prefilled(self, slot):
        # prompt pages fully below Tp are now immutable
        self._prefix.register(slot.req.prompt[0],
                              self._slot_pages[slot.row][:slot.Tp // self._bs])

    def _release(self, row):
        """The last reference frees a page and evicts its prefix-index
        entry."""
        pages, self._slot_pages[row] = self._slot_pages[row], None
        for bid in pages:
            self._bp.release(bid)

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
        return self._model.step_pages(self._last_tokens.reshape(-1, 1),
                                      self._pools, tables, pos)

    def _run_verify(self, state, window, valid_len):
        pos, tables = state
        return self._model.verify_pages(window, self._pools, tables, pos,
                                        valid_len)

    def _run_verify_tree(self, state, window, valid_len, perm, depth, anc):
        pos, tables = state
        return self._model.verify_pages(window, self._pools, tables, pos,
                                        valid_len, tree=(depth, anc))

    def _run_fixup(self, state, src_lane):
        pos, tables = state
        self._model.permute_pool_span(self._pools, tables, pos, src_lane)

    # -- one scheduler iteration ------------------------------------------
    def _advance_prefills(self):
        for i in range(self._num_slots):
            s = self._slots[i]
            if s is not None and s.prefilling:
                self._advance_prefill(i)

    def _iterations_left(self):
        return super()._iterations_left() + sum(
            -(-r.prompt.shape[1] // self._chunk) for r in self._queue) + sum(
            len(s.chunks) for s in self._slots if s is not None) \
            + self._bp.capacity // 2 + 1
