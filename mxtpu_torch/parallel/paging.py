"""Host-side bookkeeping of the block-paged KV cache: a refcounted page
allocator with pins, a radix prefix index and the policy of the
hierarchical prefix cache (the port of ``BlockPool``, ``PrefixIndex``,
``CachedChain``, ``HostChain`` and ``HierarchicalCache`` from
``mxtpu/parallel/paging.py``, kept nearly verbatim so page ids, victims
and ticks match the reference engine's step for step; the reference's
opt-in page-lifecycle sanitizer is not ported).

Everything here is pure host state — the device only ever sees padded
int32 block tables — and deterministic: the free list is ordered and
allocation order is a function of the request sequence alone.

Page 0 is the NULL page (:data:`NULL_PAGE`): never allocated, it absorbs
the writes of dead pool lanes and pads every table's tail.

The prefix index shares only IMMUTABLE pages: a page is registered once
the prompt tokens covering it are fully written, and decode never writes
a full prompt page.  So a shared page is never written again — the
serving engine's in-place pool writes land only in pages the writing
request owns alone.  Refcounts count tables referencing a page; when
the last table drops a page it returns to the free list and its index
entry is evicted, so the index can never dangle onto a recycled page.

Hierarchical cache: :class:`HierarchicalCache` keeps full-page chains
alive past their last table reference by pinning them —
:meth:`BlockPool.pin` holds one reference per pin plus an explicit pin
count, and :meth:`BlockPool.release` refuses to let a table release
recycle a pinned page — under an LRU policy with a pinned-page budget.
Chains evicted from the device tier spill to a host-memory tier (the
engine owns the copies and the ``serving.swap_out`` / ``serving.swap_in``
fault sites; this module owns only the deterministic policy: victim
order, budgets, LRU ticks, token-prefix matching).  Session chains
(``sid`` not None) pin regardless of the auto-pin budget, are evicted
only under pool pressure, and release on ``close_session``.  No clock
is read anywhere.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..base import MXTPUError

__all__ = ["BlockPool", "BlockPoolExhausted", "NULL_PAGE", "PrefixIndex",
           "HierarchicalCache", "CachedChain", "HostChain"]

#: the reserved garbage-absorbing page id
NULL_PAGE = 0


class BlockPoolExhausted(MXTPUError):
    """The page pool has fewer free pages than an allocation needs."""


class BlockPool:
    """Refcounted fixed-size page allocator over ids ``1..capacity``
    (id 0 is the reserved null page).

    ``on_free`` (optional callable) fires with the page id whenever a
    refcount drops to zero — the prefix index hooks it to evict stale
    entries, so a table can never reference a recycled page."""

    def __init__(self, capacity: int, block_size: int, on_free=None):
        if capacity < 1:
            raise ValueError("BlockPool needs capacity >= 1, got %d"
                             % capacity)
        self.capacity = int(capacity)
        self.block_size = int(block_size)
        self._on_free = on_free
        # ordered free list: alloc pops lowest ids first
        self._free: List[int] = list(range(1, self.capacity + 1))
        self._refs: Dict[int, int] = {}
        self._pins: Dict[int, int] = {}  # page id -> pin count

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def shared_count(self) -> int:
        """Pages referenced by more than one table right now."""
        return sum(1 for c in self._refs.values() if c > 1)

    @property
    def shared_extra_refs(self) -> int:
        """Sum of (refcount - 1) over shared pages — the page copies
        sharing saves right now."""
        return sum(c - 1 for c in self._refs.values() if c > 1)

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` fresh pages at refcount 1 (lowest ids first).
        Raises :class:`BlockPoolExhausted` allocating nothing when
        fewer than ``n`` pages are free."""
        if n > len(self._free):
            raise BlockPoolExhausted(
                "page pool exhausted: need %d page(s), %d free of %d "
                "(%d held by live requests)"
                % (n, len(self._free), self.capacity, self.in_use))
        got, self._free = self._free[:n], self._free[n:]
        for bid in got:
            self._refs[bid] = 1
        return got

    def retain(self, bid: int) -> None:
        """Add one table reference to an allocated page (prefix hit)."""
        if bid not in self._refs:
            raise MXTPUError("retain() of unallocated page %d" % bid)
        self._refs[bid] += 1

    # -- pinning (hierarchical cache) -----------------------------------
    @property
    def pinned_count(self) -> int:
        """Distinct pages held by at least one pin right now."""
        return len(self._pins)

    def pin_count(self, bid: int) -> int:
        return self._pins.get(bid, 0)

    def pin(self, bid: int) -> None:
        """Hold one PIN on an allocated page: a reference (the page can
        never free while pinned) plus an explicit pin count that
        :meth:`release` refuses to eat, so a table double-release can
        never recycle a pinned page."""
        if bid not in self._refs:
            raise MXTPUError("pin() of unallocated page %d" % bid)
        self._refs[bid] += 1
        self._pins[bid] = self._pins.get(bid, 0) + 1

    def unpin(self, bid: int) -> None:
        """Drop one pin and the reference it holds; the last overall
        reference frees the page as usual."""
        count = self._pins.get(bid, 0)
        if count <= 0:
            raise MXTPUError("unpin() of unpinned page %d" % bid)
        if count == 1:
            del self._pins[bid]
        else:
            self._pins[bid] = count - 1
        self.release(bid)

    def release(self, bid: int) -> None:
        """Drop one table reference; the last drop frees the page and
        fires ``on_free``.  A release that would dip into the references
        pins hold raises instead of recycling the pinned page."""
        count = self._refs.get(bid)
        if count is None:
            raise MXTPUError("release() of unallocated page %d" % bid)
        if count - 1 < self._pins.get(bid, 0):
            raise MXTPUError(
                "release() of page %d would recycle a pinned page "
                "(refs %d, pins %d) — unpin() first"
                % (bid, count, self._pins.get(bid, 0)))
        if count > 1:
            self._refs[bid] = count - 1
            return
        del self._refs[bid]
        # insertion keeps the list sorted (freed pages are reused
        # lowest-first)
        lo, hi = 0, len(self._free)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._free[mid] < bid:
                lo = mid + 1
            else:
                hi = mid
        self._free.insert(lo, bid)
        if self._on_free is not None:
            self._on_free(bid)

    def refcount(self, bid: int) -> int:
        return self._refs.get(bid, 0)


class _RadixNode:
    __slots__ = ("children", "bid")

    def __init__(self):
        # full block-size token tuple -> child node
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.bid: Optional[int] = None  # page holding this edge's K/V


class PrefixIndex:
    """Radix tree over prompts at page granularity.

    A node at depth i+1 represents prompt tokens [0, (i+1)*bs) and
    carries the page holding K/V for tokens [i*bs, (i+1)*bs).  Lookup
    walks full-page matches, then scans the children of the divergence
    node for the edge sharing the LONGEST strict token prefix — that
    page is the copy-on-write donor."""

    def __init__(self, block_size: int):
        self._bs = int(block_size)
        self._root = _RadixNode()
        # page id -> node, so BlockPool.on_free evicts in O(1)
        self._nodes: Dict[int, _RadixNode] = {}
        self._parents: Dict[int, Tuple[_RadixNode, Tuple[int, ...]]] = {}

    def __len__(self):
        return len(self._nodes)

    def lookup(self, tokens: Sequence[int], limit: int
               ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Match ``tokens[:limit]`` against the tree.

        Returns ``(full_pages, partial)``: the page ids of every fully
        matched page in sequence order, and — when the next edge matches
        only partially — ``(donor_page_id, matched_tokens)`` for the
        copy-on-write clone, or None.  ``limit`` caps the shareable
        extent (the engine passes Tp-1 so the last prompt token is
        always recomputed: its logits seed the first sample)."""
        bs = self._bs
        toks = [int(t) for t in tokens]
        node, full = self._root, []
        i = 0
        while i + bs <= limit:
            chunk = tuple(toks[i:i + bs])
            child = node.children.get(chunk)
            if child is None or child.bid is None:
                break
            full.append(child.bid)
            node = child
            i += bs
        # partial match of the next edge: the COW donor
        rest = toks[i:limit]
        best, best_r = None, 0
        for chunk, child in node.children.items():
            if child.bid is None:
                continue
            r = 0
            for a, b in zip(chunk, rest):
                if a != b:
                    break
                r += 1
            if r > best_r:
                best, best_r = child.bid, r
        partial = (best, best_r) if best is not None and best_r > 0 \
            else None
        return full, partial

    def probe(self, tokens: Sequence[int], limit: int) -> int:
        """How many of ``tokens[:limit]`` a request admitted now would
        skip prefilling (full-page matches plus the copy-on-write
        donor's partial tokens).  Read-only: no refcount, no tick."""
        full, partial = self.lookup(tokens, limit)
        return len(full) * self._bs + (partial[1] if partial else 0)

    def register(self, tokens: Sequence[int], page_ids: Sequence[int]
                 ) -> None:
        """Insert the full prompt pages of one finished prefill:
        ``page_ids[i]`` holds K/V for tokens [i*bs, (i+1)*bs).  Nodes
        that already exist keep their page."""
        bs = self._bs
        toks = [int(t) for t in tokens]
        node = self._root
        for i, bid in enumerate(page_ids):
            chunk = tuple(toks[i * bs:(i + 1) * bs])
            if len(chunk) < bs:
                break  # only full pages are immutable/shareable
            child = node.children.get(chunk)
            if child is None:
                child = _RadixNode()
                child.bid = int(bid)
                node.children[chunk] = child
                self._nodes[int(bid)] = child
                self._parents[int(bid)] = (node, chunk)
            node = child

    def evict(self, bid: int) -> None:
        """Drop the entry holding page ``bid`` (BlockPool.on_free hook)
        and its now unreachable subtree."""
        node = self._nodes.pop(int(bid), None)
        if node is None:
            return
        parent, chunk = self._parents.pop(int(bid))
        if parent.children.get(chunk) is node:
            del parent.children[chunk]
        stack = list(node.children.values())
        while stack:
            sub = stack.pop()
            if sub.bid is not None:
                self._nodes.pop(sub.bid, None)
                self._parents.pop(sub.bid, None)
            stack.extend(sub.children.values())


class CachedChain:
    """One pinned full-page chain in the DEVICE tier: ``pages[i]``
    holds K/V for ``tokens[i*bs : (i+1)*bs]``.  ``sid`` tags a session
    handle (exempt from auto-pin budget eviction); ``tick`` is the
    LRU/frequency stamp (a deterministic counter, never a clock)."""

    __slots__ = ("tokens", "pages", "sid", "tick", "hits")

    def __init__(self, tokens, pages, sid=None, tick=0):
        self.tokens: Tuple[int, ...] = tuple(int(t) for t in tokens)
        self.pages: List[int] = [int(b) for b in pages]
        self.sid = sid
        self.tick = tick
        self.hits = 0

    def __repr__(self):
        return "<CachedChain %d page(s)%s tick=%d hits=%d>" % (
            len(self.pages),
            "" if self.sid is None else " sid=%r" % (self.sid,),
            self.tick, self.hits)


class HostChain:
    """One chain spilled to the HOST tier: ``content[i]`` is the
    engine-owned host copy (opaque here) of the page covering
    ``tokens[i*bs : (i+1)*bs]``."""

    __slots__ = ("tokens", "content", "sid", "tick")

    def __init__(self, tokens, content, sid=None, tick=0):
        self.tokens: Tuple[int, ...] = tuple(int(t) for t in tokens)
        self.content: List[Any] = list(content)
        self.sid = sid
        self.tick = tick

    def __repr__(self):
        return "<HostChain %d page(s)%s tick=%d>" % (
            len(self.content),
            "" if self.sid is None else " sid=%r" % (self.sid,),
            self.tick)


class HierarchicalCache:
    """Deterministic POLICY of the hierarchical prefix cache (module
    docstring): which chains are pinned in the device tier, which live
    in the host tier, and who gets evicted when.  The engine owns the
    actual device↔host copies and the fault sites; everything here is
    pure host bookkeeping, so policy decisions replay bit-for-bit.

    Tiers and rules:

    - **Device (pinned)**: full-page chains held by
      :meth:`BlockPool.pin` past their last table reference.  Auto-pin
      (non-session) chains respect ``pin_blocks`` — the distinct-page
      budget — via LRU eviction (:meth:`pick_budget_victim`).  Session
      chains pin regardless (explicit user handles) and are only
      evicted under POOL pressure.
    - **Host**: spilled chains with engine-owned page content, capped
      at ``host_blocks`` pages — over-budget admissions evict the
      oldest host chains first; a chain larger than the whole host
      budget is dropped instead of stored.
    - **Pool pressure** (:meth:`pick_pressure_victim`): when live
      admissions need pages, spill chains that would actually FREE
      pages (refcount == their pin), non-session LRU first, session
      LRU last — live traffic always beats cached prefixes.
    """

    def __init__(self, pool: BlockPool, index: PrefixIndex,
                 pin_blocks: int = 0, host_blocks: int = 0):
        self._bp = pool
        self._index = index
        self._bs = pool.block_size
        self.pin_blocks = int(pin_blocks)
        self.host_blocks = int(host_blocks)
        self._chains: Dict[Tuple[int, ...], CachedChain] = {}
        self._host: Dict[Tuple[int, ...], HostChain] = {}
        self._tick = 0

    # -- introspection ---------------------------------------------------
    @property
    def pinned_blocks(self) -> int:
        """Distinct device pages held by pins right now."""
        return self._bp.pinned_count

    @property
    def spilled_blocks(self) -> int:
        """Pages resident in the host tier right now."""
        return sum(len(h.content) for h in self._host.values())

    @property
    def device_chains(self) -> int:
        return len(self._chains)

    @property
    def host_chains(self) -> int:
        return len(self._host)

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    # -- device tier -----------------------------------------------------
    def pin_chain(self, tokens: Sequence[int], pages: Sequence[int],
                  sid=None) -> CachedChain:
        """Pin one full-page chain (pages must be allocated — the
        caller holds them via its table or a fresh alloc).  An existing
        chain with the same tokens is touched instead of duplicated (a
        session sid, once set, sticks); chains whose tokens are a
        strict prefix of the new chain's — same sid, or untagged — are
        superseded: their pages stay pinned through the longer chain.
        New pins land BEFORE old unpins, so shared pages never
        transiently free."""
        key = tuple(int(t) for t in tokens)
        if len(key) != len(pages) * self._bs:
            raise MXTPUError(
                "pin_chain: %d token(s) do not cover %d page(s) of %d"
                % (len(key), len(pages), self._bs))
        chain = self._chains.get(key)
        if chain is not None:
            chain.tick = self._next_tick()
            chain.hits += 1
            if chain.sid is None:
                chain.sid = sid
            return chain
        chain = CachedChain(key, pages, sid=sid, tick=self._next_tick())
        for bid in chain.pages:
            self._bp.pin(bid)
        self._chains[key] = chain
        for old_key in [k for k in self._chains
                        if len(k) < len(key) and key[:len(k)] == k]:
            old = self._chains[old_key]
            if old.sid is None or old.sid == sid:
                self.unpin_chain(old)
        return chain

    def unpin_chain(self, chain: CachedChain) -> int:
        """Drop one chain's pins; returns how many pages actually
        FREED (pages still referenced by live tables or sibling chains
        stay allocated)."""
        self._chains.pop(chain.tokens, None)
        freed = 0
        for bid in chain.pages:
            last = (self._bp.refcount(bid) == 1)
            self._bp.unpin(bid)
            freed += int(last)
        return freed

    def _match_pages(self, chain_tokens: Tuple[int, ...],
                     t: Tuple[int, ...]) -> int:
        """Page-aligned longest-prefix match: how many FULL pages of
        ``chain_tokens`` prefix-match ``t`` (the one matcher both LRU
        touching and host-tier lookup share)."""
        bs = self._bs
        k = min(len(chain_tokens), len(t) - len(t) % bs)
        j = 0
        while j + bs <= k and chain_tokens[j:j + bs] == t[j:j + bs]:
            j += bs
        return j // bs

    def touch_prefix(self, tokens: Sequence[int], limit: int) -> None:
        """LRU/frequency stamp every device chain sharing at least one
        full page with ``tokens[:limit]`` — called on admission hits so
        hot prefixes stay resident."""
        t = tuple(int(x) for x in tokens[:limit])
        for chain in self._chains.values():
            if self._match_pages(chain.tokens, t):
                chain.tick = self._next_tick()
                chain.hits += 1

    def _freeable(self, chain: CachedChain) -> int:
        """Pages this chain's eviction would return to the free list:
        those whose ONLY reference is this chain's pin."""
        return sum(1 for bid in chain.pages
                   if self._bp.refcount(bid) == 1
                   and self._bp.pin_count(bid) == 1)

    def _lru(self, chains: List[CachedChain]) -> Optional[CachedChain]:
        return min(chains, key=lambda c: c.tick) if chains else None

    def pick_budget_victim(self) -> Optional[CachedChain]:
        """The chain the auto-pin budget evicts next: LRU NON-session
        chain while distinct pinned pages exceed ``pin_blocks``.
        Session chains never budget-evict (they may hold the pinned
        tier over budget — ``close_session`` is their release)."""
        if self._bp.pinned_count <= self.pin_blocks:
            return None
        return self._lru([c for c in self._chains.values()
                          if c.sid is None])

    def pick_pressure_victim(self) -> Optional[CachedChain]:
        """The chain POOL pressure evicts next: LRU among chains whose
        eviction frees at least one page — non-session chains first,
        sessions only when no non-session chain can help."""
        frees = [c for c in self._chains.values() if self._freeable(c)]
        return (self._lru([c for c in frees if c.sid is None])
                or self._lru(frees))

    # -- host tier ---------------------------------------------------------
    def spill(self, chain: CachedChain, content: Sequence[Any]) -> None:
        """Move one device chain to the host tier: record the engine's
        page content, unpin the device pages, and evict the OLDEST host
        chains past the ``host_blocks`` budget (a chain bigger than the
        whole budget is dropped, not stored)."""
        self.unpin_chain(chain)
        if len(content) != len(chain.pages) or \
                len(content) > self.host_blocks:
            return
        self._host[chain.tokens] = HostChain(
            chain.tokens, content, sid=chain.sid,
            tick=self._next_tick())
        while self.spilled_blocks > self.host_blocks:
            oldest = min(self._host.values(), key=lambda h: h.tick)
            del self._host[oldest.tokens]

    def drop_chain(self, chain: CachedChain) -> None:
        """Evict one device chain WITHOUT a host copy (swap-out failed
        or the host tier is disabled) — the cached prefill is simply
        lost and recomputed on the next miss."""
        self.unpin_chain(chain)

    def host_match(self, tokens: Sequence[int], limit: int
                   ) -> Optional[Tuple[HostChain, int]]:
        """Longest page-aligned prefix match of ``tokens[:limit]``
        against the host tier: ``(chain, n_pages)`` or None.  Ties
        break on the most recently used chain (deterministic — ticks
        are unique)."""
        t = tuple(int(x) for x in tokens[:limit])
        best: Optional[Tuple[HostChain, int]] = None
        for chain in self._host.values():
            n = self._match_pages(chain.tokens, t)
            if n and (best is None or n > best[1]
                      or (n == best[1] and chain.tick > best[0].tick)):
                best = (chain, n)
        return best

    def drop_host(self, chain: HostChain) -> None:
        self._host.pop(chain.tokens, None)

    # -- sessions ----------------------------------------------------------
    def close_session(self, sid) -> int:
        """Release every chain tagged ``sid`` from BOTH tiers; returns
        the number of device pages actually freed."""
        freed = 0
        for chain in [c for c in self._chains.values() if c.sid == sid]:
            freed += self.unpin_chain(chain)
        for chain in [h for h in self._host.values() if h.sid == sid]:
            del self._host[chain.tokens]
        return freed
