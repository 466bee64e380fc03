"""The hierarchical prefix cache of the port's paged engine (pins, the
host-memory tier, sessions, overlapped restores) held against the JAX
reference engine, replaying tests/test_serving_hierarchical.py's
scenarios and the overlapped-restore twins of
tests/test_serving_router.py on the same weights (the weight bridge).

Both engines run every scenario side by side (``Twin``): greedy streams
must be token-identical, the pool's state (slot pages, free list,
refcounts, pins, device and host chains with their ticks) equal after
every drain, and every paging, hierarchy and resilience stats key equal.
Fault plans are the same spec in both frameworks, each engine consulting
its own package's plan; their per-site hit counts must agree.  Seeded
sampled streams must equal the port's own ``generate`` (JAX draws with
threefry, the port with torch.Generator).

The model is the reference's 1-layer micro-LM (vocab 32, 16 units, seed
7), float32 and int8 pools.  The reference's compile-budget and
tp-sharded scenarios have no counterpart here (no compiled programs; one
device).
"""

import contextlib

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.base import MXTPUError as JaxError
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import transformer_lm_sharding_rules
from mxtpu.parallel import PagedContinuousBatchingEngine as JaxEngine
from mxtpu.parallel.mesh import DeviceMesh
from mxtpu.parallel.paging import BlockPool as JaxPool
from mxtpu.parallel.paging import HierarchicalCache as JaxCache
from mxtpu.parallel.paging import PrefixIndex as JaxIndex
from mxtpu.resilience import fault_plan as jax_fault_plan
from mxtpu_torch.base import MXTPUError
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import TransformerLM
from mxtpu_torch.parallel.paging import BlockPool, HierarchicalCache, \
    PrefixIndex
from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine
from mxtpu_torch.resilience import fault_plan

MAXLEN = 48
BS = 8
VOCAB = 32
ENGINE = dict(num_slots=2, max_length=MAXLEN, block_size=BS, prefill_chunk=8)
DTYPES = ["float32", "int8"]
#: the stats keys both engines must agree on
KEYS = ("steps", "generated_tokens", "quarantined_requests",
        "retried_requests", "expired_requests", "shed_requests",
        "blocks_in_use", "blocks_free", "blocks_shared", "shared_extra_refs",
        "prefix_hit_requests", "cow_copied_blocks", "num_blocks",
        "pinned_blocks", "spilled_blocks", "swapped_in_blocks",
        "swapped_out_blocks", "deferred_swap_in_requests",
        "session_hit_requests", "sessions_open", "prefill_tokens_avoided")


@pytest.fixture(scope="module", autouse=True)
def _compile_ledger_left_as_found():
    """The JAX engines built here compile many pool shapes into the
    process-wide compile ledger, which later tests in the same process
    read (``check_compiles``): leave it as this module found it."""
    import copy

    from mxtpu.analysis.compile_ledger import get_ledger

    led = get_ledger()
    with led._lock:
        saved = copy.deepcopy((led._sites, led._seen, led._seq))
    yield
    with led._lock:
        led._sites, led._seen, led._seq = saved


@pytest.fixture(scope="module")
def models():
    mx.random.seed(7)
    ref = JaxLM(VOCAB, units=16, hidden_size=32, num_layers=1, num_heads=2,
                num_kv_heads=2)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    port = TransformerLM(VOCAB, 16, 32, 1, 2, 2, device="cpu")
    load_mxtpu_params(port, {k: v.data().asnumpy()
                             for k, v in ref.collect_params().items()})
    return ref, port


def _pool_state(e):
    """Everything of an engine's pool the reference's order decides
    (chains by their length, not their tokens: a sampled stream's
    tokens differ across frameworks)."""
    bp, hc = e._bp, e._hc
    return (list(e._slot_pages), list(bp._free), dict(bp._refs),
            dict(bp._pins),
            sorted((c.tick, len(k), list(c.pages), c.sid, c.hits)
                   for k, c in hc._chains.items()),
            sorted((h.tick, len(k), len(h.content), h.sid)
                   for k, h in hc._host.items()),
            hc.pin_blocks, hc.host_blocks)


class Twin:
    """One engine configuration in both frameworks, driven in lockstep
    (both number requests from 0, so a rid names the same request)."""

    faulted = False     # a fault plan ran (a spill may then have dropped)

    def __init__(self, models, **kw):
        ref, self.model = models
        kw = dict(ENGINE, **kw)
        self.j = JaxEngine(ref, DeviceMesh(dp=1),
                           transformer_lm_sharding_rules(), **kw)
        self.p = PagedContinuousBatchingEngine(self.model, device="cpu", **kw)
        self.cache_dtype = kw.get("cache_dtype")
        self.sampled = {}

    @property
    def engines(self):
        return (self.j, self.p)

    def submit(self, prompt, n, **kw):
        prompt = np.asarray(prompt, np.int32)
        rj = self.j.submit(nd.array(prompt, dtype="int32"), n, **kw)
        rp = self.p.submit(prompt, n, **kw)
        assert rj == rp
        if kw.get("temperature"):
            self.sampled[rp] = (prompt, n, kw)
        return rp

    def step(self):
        self.j.step()
        self.p.step()

    def run(self):
        """Drain both: the port's results, after holding every greedy
        stream to the reference's, every sampled one to the port's
        ``generate``, and the pool states and stats to each other."""
        jres, pres = self.j.run(), self.p.run()
        assert sorted(jres) == sorted(pres)
        for rid in pres:
            self.check_stream(rid, jres[rid].asnumpy(), pres[rid].numpy())
        self.check()
        return {rid: r.numpy() for rid, r in pres.items()}

    def check_stream(self, rid, jax_out, port_out):
        if rid not in self.sampled:
            np.testing.assert_array_equal(port_out, jax_out)
            return
        prompt, n, kw = self.sampled[rid]
        kw = {k: v for k, v in kw.items()
              if k in ("temperature", "top_k", "top_p", "seed",
                       "repetition_penalty")}
        if port_out.shape[1] == prompt.shape[1] + n:   # a finished stream
            want = self.model.generate(
                torch.from_numpy(prompt), n, max_length=MAXLEN,
                cache_dtype=self.cache_dtype, **kw).numpy()
            np.testing.assert_array_equal(port_out, want)

    def check(self):
        assert _pool_state(self.j) == _pool_state(self.p)
        sj, sp = self.j.stats, self.p.stats
        assert {k: sj[k] for k in KEYS} == {k: sp[k] for k in KEYS}
        assert sp["swap_out_failures"] == 0 or self.faulted

    def both(self, fn):
        return [fn(e) for e in self.engines]

    @contextlib.contextmanager
    def plan(self, spec):
        """The same fault plan in both frameworks; their per-site hits
        and firings must agree."""
        self.faulted = True
        with jax_fault_plan(spec) as jp, fault_plan(spec) as pp:
            yield pp
        assert jp.stats() == pp.stats()

    def status(self, rid):
        st = self.p.status(rid)
        assert self.j.status(rid) == st
        return st


def _rand(rng, n):
    return rng.randint(0, VOCAB, (1, n))


# ------------------------------------------------ BlockPool pin states

@pytest.mark.parametrize("framework", ["port", "reference"])
def test_block_pool_pin_unpin_and_release_guard(framework):
    """A pin is a reference plus a pin count: pages free only after the
    last unpin, a table release can never dip into pinned references,
    and unpinning an unpinned page is a typed error."""
    Pool, Err = ((BlockPool, MXTPUError) if framework == "port"
                 else (JaxPool, JaxError))
    freed = []
    bp = Pool(4, 8, on_free=freed.append)
    (a,) = bp.alloc(1)
    bp.pin(a)
    assert bp.pinned_count == 1 and bp.pin_count(a) == 1
    bp.release(a)
    assert bp.refcount(a) == 1 and not freed
    with pytest.raises(Err, match="pinned"):
        bp.release(a)
    bp.pin(a)
    bp.unpin(a)
    assert not freed
    bp.unpin(a)
    assert freed == [a] and bp.pinned_count == 0
    with pytest.raises(Err, match="unpin"):
        bp.unpin(a)
    with pytest.raises(Err, match="pin"):
        bp.pin(99)


def _policy_units(Pool, Index, Cache):
    """tests/test_serving_hierarchical.py's policy walk; returns the
    observations to compare across frameworks."""
    seen = []
    idx = Index(4)
    bp = Pool(8, 4, on_free=idx.evict)
    hc = Cache(bp, idx, pin_blocks=2, host_blocks=2)
    toks = list(range(12))
    pages = bp.alloc(3)
    c1 = hc.pin_chain(toks[:4], pages[:1])
    hc.pin_chain(toks[:8], pages[:2])
    assert hc.device_chains == 1 and c1.tokens not in hc._chains
    assert bp.pin_count(pages[0]) == 1
    hc.pin_chain(toks[:12], pages[:3], sid="s")
    assert hc.device_chains == 1 and bp.pinned_count == 3
    for bid in pages:
        bp.release(bid)
    assert hc.pick_budget_victim() is None
    extra = bp.alloc(2)
    c3 = hc.pin_chain([90, 91, 92, 93, 94, 95, 96, 97], extra)
    for bid in extra:
        bp.release(bid)
    hc.touch_prefix(toks, 12)
    assert hc.pick_budget_victim() is c3
    assert hc.pick_pressure_victim() is c3
    hc.spill(c3, ["p0", "p1"])
    assert bp.pinned_count == 3 and hc.spilled_blocks == 2
    extra2 = bp.alloc(2)
    c4 = hc.pin_chain([80, 81, 82, 83, 84, 85, 86, 87], extra2)
    for bid in extra2:
        bp.release(bid)
    hc.spill(c4, ["q0", "q1"])
    assert hc.host_chains == 1
    got = hc.host_match([80, 81, 82, 83, 84, 85, 99], limit=7)
    assert got is not None and got[1] == 1
    assert hc.host_match(toks, limit=12) is None
    seen.append((list(bp._free), dict(bp._refs), dict(bp._pins),
                 {k: (c.pages, c.tick, c.hits) for k, c in hc._chains.items()},
                 {k: (h.content, h.tick) for k, h in hc._host.items()}))
    assert hc.close_session("s") == 3
    assert bp.pinned_count == 0 and bp.in_use == 0
    return seen


def test_hierarchical_cache_policy_units():
    """Prefix supersede, LRU budget victims that are never sessions,
    pressure victims that would free pages, the host tier's oldest-first
    budget: the same walk in both frameworks, the same states."""
    assert _policy_units(BlockPool, PrefixIndex, HierarchicalCache) == \
        _policy_units(JaxPool, JaxIndex, JaxCache)


def _policy_trace(Pool, Index, Cache, seed, ops=300):
    """A seeded random walk of pin_chain / touch_prefix / spill /
    drop_chain / host_match / close_session over one policy object: the
    victims, ticks and both tiers after every operation."""
    rng = np.random.RandomState(seed)
    bs = 4
    idx = Index(bs)
    bp = Pool(24, bs, on_free=idx.evict)
    hc = Cache(bp, idx, pin_blocks=int(rng.randint(2, 10)),
               host_blocks=int(rng.randint(2, 12)))
    # a few shared openings so chains supersede and share pages
    openings = [list(rng.randint(0, 6, 4 * bs)) for _ in range(3)]
    trace = []
    for _ in range(ops):
        op = rng.randint(6)
        if op <= 1:                                  # pin a finished chain
            toks = list(openings[rng.randint(3)][:bs * rng.randint(1, 4)])
            toks += list(rng.randint(0, 6, bs * rng.randint(0, 3)))
            n = len(toks) // bs
            full, _ = idx.lookup(toks, len(toks))
            need = n - len(full)
            if need > bp.free_count:
                victim = hc.pick_pressure_victim()
                trace.append(("pressure", None if victim is None
                              else victim.tokens))
                if victim is not None:
                    hc.spill(victim, list(range(len(victim.pages))))
                continue
            for bid in full:
                bp.retain(bid)
            fresh = bp.alloc(need)
            pages = full + fresh
            idx.register(toks, pages)
            sid = ["a", "b", None, None][rng.randint(4)]
            c = hc.pin_chain(toks, pages, sid=sid)
            for bid in pages:
                bp.release(bid)
            trace.append(("pin", c.tokens, c.tick))
            victim = hc.pick_budget_victim()
            while victim is not None:
                trace.append(("budget", victim.tokens))
                hc.spill(victim, list(range(len(victim.pages))))
                victim = hc.pick_budget_victim()
        elif op == 2:
            toks = list(openings[rng.randint(3)][:bs * rng.randint(1, 5)])
            hc.touch_prefix(toks, len(toks))
            trace.append(("touch",))
        elif op == 3:
            toks = list(openings[rng.randint(3)]) + [0] * bs
            m = hc.host_match(toks, len(toks) - 1)
            trace.append(("host_match", None if m is None
                          else (m[0].tokens, m[1])))
            if m is not None and rng.randint(2):
                hc.drop_host(m[0])
        elif op == 4 and hc.device_chains:
            victim = hc.pick_pressure_victim()
            trace.append(("drop", None if victim is None else victim.tokens))
            if victim is not None:
                hc.drop_chain(victim)
        else:
            sid = ["a", "b"][rng.randint(2)]
            trace.append(("close", sid, hc.close_session(sid)))
        trace.append((list(bp._free), dict(bp._pins),
                      sorted((k, tuple(c.pages), c.sid, c.tick, c.hits)
                             for k, c in hc._chains.items()),
                      sorted((k, h.sid, h.tick)
                             for k, h in hc._host.items()),
                      hc.spilled_blocks))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_random_walk_matches_reference(seed):
    """The policy object is deterministic host bookkeeping: the same
    seeded operations give the same victims, ticks and tier contents."""
    assert _policy_trace(BlockPool, PrefixIndex, HierarchicalCache, seed) \
        == _policy_trace(JaxPool, JaxIndex, JaxCache, seed)


# ------------------------------------------- cross-burst pinned re-hit

@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_pinned_chain_survives_lull_and_rehits(models, cache_dtype):
    """The engine drains completely (a lull) and a later identical prompt
    still hits the pinned pages: prefill_tokens_avoided counts the
    skipped prefix."""
    tw = Twin(models, pin_bytes="1MiB", cache_dtype=cache_dtype)
    p = _rand(np.random.RandomState(3), 19)
    tw.submit(p, 5)
    tw.run()
    st = tw.p.stats
    assert st["pinned_blocks"] > 0
    assert st["blocks_in_use"] == st["pinned_blocks"]
    assert st["prefill_tokens_avoided"] == 0
    tw.submit(p, 5)
    tw.run()
    st = tw.p.stats
    assert st["prefix_hit_requests"] >= 1
    assert st["prefill_tokens_avoided"] == 2 * BS
    assert st["swapped_in_blocks"] == st["swapped_out_blocks"] == 0


@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_pin_budget_lru_eviction_order(models, cache_dtype):
    """With room for one chain the LRU chain is evicted (dropped: no
    host tier) when the next finishes; the survivor re-hits."""
    tw = Twin(models, pin_bytes="1MiB", cache_dtype=cache_dtype)
    rng = np.random.RandomState(5)
    pa, pb = _rand(rng, 17), _rand(rng, 17)
    tw.submit(pa, 4)
    tw.run()
    assert tw.p._bytes_per_block == tw.j._bytes_per_block > 0
    assert tw.p.stats["pinned_blocks"] == 2
    for e in tw.engines:
        e._hc.pin_blocks = 2
    tw.submit(pb, 4)
    tw.run()
    st = tw.p.stats
    assert st["pinned_blocks"] == 2
    avoided0 = st["prefill_tokens_avoided"]
    tw.submit(pb, 4)
    tw.run()
    assert tw.p.stats["prefill_tokens_avoided"] - avoided0 == 2 * BS
    tw.submit(pa, 4)
    tw.run()


@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_budgets_price_pages_as_the_reference(models, cache_dtype):
    """pin_blocks and host_blocks from the same byte budgets: a page is
    priced from the pools as allocated (int8 payload and scales)."""
    tw = Twin(models, pin_bytes="3KiB", host_cache_bytes="100KiB",
              cache_dtype=cache_dtype)
    tw.submit(_rand(np.random.RandomState(1), 9), 2)
    tw.run()
    assert tw.p._bytes_per_block == tw.j._bytes_per_block
    assert (tw.p._hc.pin_blocks, tw.p._hc.host_blocks) == \
        (tw.j._hc.pin_blocks, tw.j._hc.host_blocks)
    assert tw.p._hc.pin_blocks > 0


# ------------------------------------------------- host tier round trip

@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_swap_out_swap_in_round_trip_bit_exact(models, cache_dtype):
    """pin_bytes=1 (0 pages) makes the device tier a pass-through: every
    finished chain spills to host at once and restores on the next
    miss."""
    tw = Twin(models, pin_bytes=1, host_cache_bytes="1MiB",
              cache_dtype=cache_dtype)
    p = _rand(np.random.RandomState(7), 19)
    tw.submit(p, 5)
    tw.run()
    st = tw.p.stats
    assert st["pinned_blocks"] == 0 and st["blocks_in_use"] == 0
    assert st["spilled_blocks"] == 2 and st["swapped_out_blocks"] == 2
    tw.submit(p, 5)
    tw.run()
    st = tw.p.stats
    assert st["swapped_in_blocks"] == 2
    assert st["prefill_tokens_avoided"] == 2 * BS
    assert st["swapped_out_blocks"] == 4 and st["spilled_blocks"] == 2


@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_page_round_trip_is_exact(models, cache_dtype):
    """read_pages then write_pages into fresh pages: every pool tensor's
    rows come back equal, and other pages are untouched."""
    port = models[1]
    pools = port.init_block_pool(12, BS, cache_dtype)
    gen = torch.Generator().manual_seed(0)
    from mxtpu_torch.models.transformer import pool_tensors
    for t in pool_tensors(pools):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
        else:
            t.copy_(torch.rand(t.shape, generator=gen))
    before = [t.clone() for t in pool_tensors(pools)]
    host = port.read_pages(pools, [3, 7, 1])
    per_page = sum(t[0].numel() * t.element_size()
                   for t in pool_tensors(pools))
    assert host.dtype == torch.uint8 and host.shape == (3, per_page)
    port.write_pages(pools, [10, 2, 11], host)
    for t, b in zip(pool_tensors(pools), before):
        for src, dst in ((3, 10), (7, 2), (1, 11)):
            assert torch.equal(t[dst], b[src])
        for keep in (0, 1, 3, 4, 5, 6, 7, 8, 9):
            assert torch.equal(t[keep], b[keep])


def test_swapped_in_seeded_sampled_parity(models):
    """Sampled draws ride restored chains exactly."""
    tw = Twin(models, pin_bytes=1, host_cache_bytes="1MiB")
    p = _rand(np.random.RandomState(11), 18)
    kw = dict(temperature=0.8, top_k=12, seed=404)
    tw.submit(p, 6, **kw)
    tw.run()
    tw.submit(p, 6, **kw)
    tw.run()
    assert tw.p.stats["swapped_in_blocks"] == 2


# --------------------------------------------------- multi-turn sessions

@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_session_turns_prefill_only_new_suffix(models, cache_dtype):
    """Three turns on one session handle: turn N+1 skips every full page
    of the transcript, and close_session returns the pool to zero."""
    tw = Twin(models, max_length=96, num_blocks=24, cache_dtype=cache_dtype)
    rng = np.random.RandomState(13)
    prompt = _rand(rng, 12)
    avoided = [0]
    for turn in range(3):
        rid = tw.submit(prompt, 6, session="chat-1")
        res = tw.run()
        st = tw.p.stats
        avoided.append(st["prefill_tokens_avoided"])
        if turn > 0:
            transcript = prompt.shape[1] - 4
            assert avoided[-1] - avoided[-2] == (transcript - 1) // BS * BS
            assert st["session_hit_requests"] == turn
        prompt = np.concatenate([res[rid], _rand(rng, 4)], axis=1)
    st = tw.p.stats
    assert st["pinned_blocks"] > 0 and st["sessions_open"] == 1
    freed = tw.both(lambda e: e.close_session("chat-1"))
    assert freed[0] == freed[1]
    tw.check()
    st = tw.p.stats
    assert st["pinned_blocks"] == 0 and st["blocks_in_use"] == 0
    assert st["sessions_open"] == 0


def test_two_sessions_share_system_prompt_pages(models):
    """Two conversations opening with one system prompt share its pinned
    pages (priced once); closing one keeps the other's chain."""
    tw = Twin(models, max_length=96, num_blocks=24)
    rng = np.random.RandomState(17)
    system = _rand(rng, 16)
    pa = np.concatenate([system, _rand(rng, 6)], 1)
    pb = np.concatenate([system, _rand(rng, 7)], 1)
    tw.submit(pa, 5, session="a")
    tw.run()
    rb = tw.submit(pb, 5, session="b")
    res = tw.run()
    assert tw.p.stats["pinned_blocks"] == 4
    # A's own third page frees; the two system-prompt pages stay B's
    assert tw.both(lambda e: e.close_session("a")) == [1, 1]
    tw.check()
    assert tw.p.stats["pinned_blocks"] == 3
    tb = np.concatenate([res[rb], _rand(rng, 4)], 1)
    avoided0 = tw.p.stats["prefill_tokens_avoided"]
    tw.submit(tb, 4, session="b")
    tw.run()
    assert tw.p.stats["prefill_tokens_avoided"] > avoided0
    freed = tw.both(lambda e: e.close_session("b"))
    assert freed[0] == freed[1]
    tw.check()
    assert tw.p.stats["blocks_in_use"] == 0


# ------------------------------------------- eviction-order edge cases

@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_pool_pressure_evicts_pinned_before_deferring(models, cache_dtype):
    """A new admission that needs a pinned chain's pages spills it (live
    traffic beats cache) instead of deferring; it comes back from the
    host tier on the next hit."""
    tw = Twin(models, num_blocks=6, pin_bytes="1MiB",
              host_cache_bytes="1MiB", cache_dtype=cache_dtype)
    rng = np.random.RandomState(19)
    pa = _rand(rng, 19)
    tw.submit(pa, 5)
    tw.run()
    for e in tw.engines:
        e._hc.pin_blocks = 6
    st = tw.p.stats
    assert st["pinned_blocks"] == 2 and st["blocks_free"] == 4
    pb = _rand(rng, 21)
    tw.submit(pb, 19)
    tw.run()
    st = tw.p.stats
    assert st["swapped_out_blocks"] == 2 and st["spilled_blocks"] == 2
    tw.submit(pa, 5)
    tw.run()
    assert tw.p.stats["swapped_in_blocks"] == 2


def test_session_chains_evict_last_under_pressure(models):
    """Non-session chains go first under pressure; the session chain
    spills only when nothing else can free pages, and comes back on its
    next turn."""
    tw = Twin(models, num_blocks=8, pin_bytes="1MiB",
              host_cache_bytes="1MiB")
    rng = np.random.RandomState(23)
    ps, pn = _rand(rng, 22), _rand(rng, 17)
    tw.submit(ps, 6, session="s")
    tw.run()
    tw.submit(pn, 4)
    tw.run()
    st = tw.p.stats
    assert st["pinned_blocks"] == 5 and st["blocks_free"] == 3
    tw.submit(_rand(rng, 17), 23)
    tw.run()
    assert any(c.sid == "s" for c in tw.p._hc._chains.values())
    for e in tw.engines:
        e._hc.pin_blocks = 0
        e._enforce_pin_budget()
    tw.check()
    st = tw.p.stats
    assert st["pinned_blocks"] == 3 and st["blocks_free"] == 5
    tw.submit(_rand(rng, 20), 28)
    tw.run()
    assert all(c.sid != "s" for c in tw.p._hc._chains.values())
    assert tw.p._hc.host_chains >= 1
    avoided0 = tw.p.stats["prefill_tokens_avoided"]
    tw.submit(ps, 4, session="s")
    tw.run()
    st = tw.p.stats
    assert st["swapped_in_blocks"] >= 2
    assert st["prefill_tokens_avoided"] - avoided0 == 2 * BS
    for e in tw.engines:
        e.close_session("s")
        e._enforce_pin_budget()
    tw.check()
    assert tw.p.stats["blocks_in_use"] == tw.p.stats["pinned_blocks"] == 0


def test_pinned_page_as_cow_donor_keeps_refcounts(models):
    """A request diverging inside a pinned page clones it copy-on-write;
    spilling the donor chain mid-flight leaves the clone's stream exact
    and nothing leaks."""
    tw = Twin(models, pin_bytes="1MiB", host_cache_bytes="1MiB")
    rng = np.random.RandomState(29)
    base = _rand(rng, 13)
    tw.submit(np.concatenate([base, _rand(rng, 4)], 1), 4)
    tw.run()
    assert tw.p.stats["pinned_blocks"] >= 2
    donor_pages = list(next(iter(tw.p._hc._chains.values())).pages)
    tw.submit(np.concatenate([base, _rand(rng, 6)], 1), 6)
    tw.step()
    assert tw.p.stats["cow_copied_blocks"] >= 1
    assert tw.p._bp.pin_count(donor_pages[1]) == 1
    assert tw.p._slot_pages == tw.j._slot_pages
    for e in tw.engines:
        e._spill_chain(next(iter(e._hc._chains.values())))
    tw.run()
    for e in tw.engines:
        e._hc.pin_blocks = 0
        e._enforce_pin_budget()
    tw.check()
    assert tw.p.stats["blocks_in_use"] == tw.p.stats["pinned_blocks"] == 0


def test_admission_holds_matched_pages_across_reclaim(models):
    """The hold order: an admission's matched prefix pages, held only by
    a pinned chain, are retained before the reclaim its allocation
    needs, so spilling that very chain cannot free (and hand back) a
    page the admission shares.  The reclaim spills the chain, frees only
    its unshared page, and the stream is exact."""
    tw = Twin(models, num_blocks=6, pin_bytes="1MiB",
              host_cache_bytes="1MiB")
    rng = np.random.RandomState(61)
    pa = _rand(rng, 25)                      # 3 full pages pinned
    tw.submit(pa, 3)
    tw.run()
    assert tw.p.stats["pinned_blocks"] == 3 and tw.p.stats["blocks_free"] == 3
    pinned = list(next(iter(tw.p._hc._chains.values())).pages)
    # shares the chain's first two pages and needs 4 fresh ones, one
    # more than is free: the reclaim spills the only chain, the matched
    # one, and only its third page may come free
    pb = np.concatenate([pa[:, :16], _rand(rng, 4)], 1)
    rb = tw.submit(pb, 25)
    tw.step()
    row = next(i for i, s in enumerate(tw.p._slots)
               if s is not None and s.req.rid == rb)
    pages = tw.p._slot_pages[row]
    assert pages[:2] == pinned[:2] and pinned[2] in pages[2:]
    assert len(set(pages)) == len(pages) == 6    # no page handed out twice
    assert tw.p.stats["swapped_out_blocks"] == 3
    assert tw.p.stats["prefill_tokens_avoided"] == 2 * BS
    assert tw.p._slot_pages == tw.j._slot_pages
    tw.run()
    assert tw.p.stats["blocks_in_use"] == tw.p.stats["pinned_blocks"]


# --------------------------------------------------- swap fault plans

@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_swap_in_fault_quarantines_and_retry_restores(models, cache_dtype):
    """A ``serving.swap_in`` raise releases the restore's pages and
    quarantines only that request; its retry restores cleanly.  A
    sampled neighbour is not perturbed."""
    tw = Twin(models, pin_bytes=1, host_cache_bytes="1MiB",
              cache_dtype=cache_dtype)
    rng = np.random.RandomState(31)
    p, pn = _rand(rng, 19), _rand(rng, 6)
    tw.submit(p, 5)
    tw.run()
    before = tw.p.stats
    r2 = tw.submit(p, 5, retries=1)
    tw.submit(pn, 4, temperature=0.6, seed=99)
    with tw.plan("serving.swap_in#%d@1:raise=OSError(dma dead)" % r2) as pl:
        tw.run()
    assert pl.stats()["serving.swap_in"]["fired"] == 1
    assert tw.status(r2) == "ok"
    st = tw.p.stats
    assert st["quarantined_requests"] - before["quarantined_requests"] == 1
    assert st["retried_requests"] - before["retried_requests"] == 1
    assert st["swapped_in_blocks"] == 2
    assert st["blocks_in_use"] == 0
    assert tw.p.error(r2)["site"] == tw.j.error(r2)["site"] == "serving.admit"


@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_swap_out_fault_drops_chain_without_poisoning(models, cache_dtype):
    """A ``serving.swap_out`` raise degrades the spill to a drop: no
    half-copied host chain, the request proceeds, the prefix recomputes
    on the next miss, and the port counts the failed spill."""
    tw = Twin(models, pin_bytes=1, host_cache_bytes="1MiB",
              cache_dtype=cache_dtype)
    p = _rand(np.random.RandomState(37), 19)
    with tw.plan("serving.swap_out@1:raise=OSError(copy dead)"):
        tw.submit(p, 5)
        tw.run()
    st = tw.p.stats
    assert st["spilled_blocks"] == 0 and st["swapped_out_blocks"] == 0
    assert st["pinned_blocks"] == 0 and st["blocks_in_use"] == 0
    assert st["swap_out_failures"] == 1
    tw.submit(p, 5)
    tw.run()
    st = tw.p.stats
    assert st["prefill_tokens_avoided"] == 0
    assert st["spilled_blocks"] == 2 and st["swap_out_failures"] == 1


def test_session_close_zeroes_pool_on_every_fault_path(models):
    """blocks_in_use == 0 after the sessions close on every fault path:
    a step fault, a swap_in fault with a retry, a deadline eviction."""
    clock = {"t": 0.0}
    tw = Twin(models, num_blocks=12, pin_bytes=1, host_cache_bytes="1MiB",
              clock=lambda: clock["t"])
    p = _rand(np.random.RandomState(41), 17)
    r1 = tw.submit(p, 6, session="s1")
    with tw.plan("serving.step#%d@2:raise=RuntimeError(dead)" % r1):
        tw.run()
    assert tw.status(r1) == "failed"
    tw.submit(p, 4, session="s2")
    tw.run()
    for e in tw.engines:
        e._spill_chain(next(c for c in e._hc._chains.values()
                            if c.sid == "s2"))
    tw.check()
    r2 = tw.submit(p, 4, retries=1, session="s2")
    with tw.plan("serving.swap_in#%d@1:raise=OSError(x)" % r2):
        tw.run()
    assert tw.status(r2) == "ok"
    r3 = tw.submit(p, 8, session="s3", deadline_s=5.0)
    tw.step()
    clock["t"] = 10.0
    tw.run()
    assert tw.status(r3) == "expired"
    for sid in ("s1", "s2", "s3"):
        for e in tw.engines:
            e.close_session(sid)
    tw.check()
    st = tw.p.stats
    assert st["pinned_blocks"] == 0 and st["blocks_in_use"] == 0
    assert st["blocks_free"] == st["num_blocks"]


def test_close_session_while_in_flight_never_leaks_pins(models):
    """Closing a session while its request decodes leaves no orphaned
    pin: the finish-time offer degrades to an ordinary chain (budget 0,
    no host tier: no pin at all)."""
    tw = Twin(models)
    r = tw.submit(_rand(np.random.RandomState(59), 17), 6, session="gone")
    tw.step()
    for e in tw.engines:
        e.close_session("gone")
    tw.run()
    assert tw.status(r) == "ok"
    st = tw.p.stats
    assert st["sessions_open"] == 0 and st["pinned_blocks"] == 0
    assert st["blocks_in_use"] == 0


def test_partial_restore_keeps_host_tail_for_session(models):
    """A short prompt matching only a prefix of a spilled transcript
    restores just that prefix and keeps the host copy, so the session's
    next full turn restores the rest."""
    tw = Twin(models, max_length=96, num_blocks=24, pin_bytes="1MiB",
              host_cache_bytes="1MiB")
    rng = np.random.RandomState(53)
    base = _rand(rng, 16)
    t1 = np.concatenate([base, _rand(rng, 14)], 1)
    r1 = tw.submit(t1, 9, session="s")
    res = tw.run()
    chain_len = len(next(c for c in tw.p._hc._chains.values()
                         if c.sid == "s").pages)
    assert chain_len >= 4
    for e in tw.engines:
        e._spill_chain(next(c for c in e._hc._chains.values()
                            if c.sid == "s"))
    tw.submit(np.concatenate([base, _rand(rng, 3)], 1), 4)
    tw.run()
    st = tw.p.stats
    assert st["swapped_in_blocks"] == 2 and tw.p._hc.host_chains >= 1
    p2 = np.concatenate([res[r1], _rand(rng, 4)], 1)
    avoided0 = st["prefill_tokens_avoided"]
    tw.submit(p2, 4, session="s")
    tw.run()
    st = tw.p.stats
    assert st["swapped_in_blocks"] == chain_len
    assert st["prefill_tokens_avoided"] - avoided0 == chain_len * BS
    for e in tw.engines:
        e.close_session("s")
        e._hc.pin_blocks = 0
        e._enforce_pin_budget()
    tw.check()
    assert tw.p.stats["blocks_in_use"] == 0


@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_probe_and_drop_cache_read_both_tiers(models, cache_dtype):
    """prefix_probe walks the device index and the host tier without
    touching either; drop_cache releases both tiers and every session,
    leaving no page in use."""
    tw = Twin(models, max_length=96, num_blocks=24, pin_bytes="1MiB",
              host_cache_bytes="1MiB", cache_dtype=cache_dtype)
    rng = np.random.RandomState(67)
    pa, pb = _rand(rng, 27), _rand(rng, 19)
    tw.submit(pa, 4, session="s")
    tw.submit(pb, 4)
    tw.run()
    for e in tw.engines:
        e._spill_chain(next(c for c in e._hc._chains.values()
                            if c.sid is None))
    tw.check()
    for q in (pa, pb, np.concatenate([pb[:, :9], _rand(rng, 5)], 1),
              _rand(rng, 12)):
        state = _pool_state(tw.p)
        probes = [e.prefix_probe(arr) for e, arr in
                  ((tw.j, nd.array(q, dtype="int32")), (tw.p, q))]
        assert probes[0] == probes[1]
        assert _pool_state(tw.p) == state
    assert tw.p.prefix_probe(pa) == 3 * BS
    assert tw.p.prefix_probe(pb) == 2 * BS      # from the host tier
    freed = tw.both(lambda e: e.drop_cache())
    assert freed[0] == freed[1] > 0
    tw.check()
    st = tw.p.stats
    assert st["blocks_in_use"] == st["pinned_blocks"] == 0
    assert st["spilled_blocks"] == 0 and st["sessions_open"] == 0


# ----------------------------------------------- overlapped swap restores

def _overlap_twin(models, flag, **kw):
    return Twin(models, num_slots=2, max_length=48, block_size=8,
                prefill_chunk=8, pin_bytes=0, host_cache_bytes="4MiB",
                overlap_swaps=flag, **kw)


def _drive_cold_chain(tw, seed):
    """tests/test_serving_router.py's scenario: spill a chain to host,
    keep one request decoding, admit a cold-chain request; returns the
    per-iteration emission deltas of the decoding slot (port)."""
    rng = np.random.RandomState(seed)
    P = rng.randint(0, VOCAB, (1, 16))
    Q = rng.randint(0, VOCAB, (1, 6))
    P3 = np.concatenate([P, rng.randint(0, VOCAB, (1, 3))], axis=1)
    tw.submit(P, 4)
    tw.run()
    assert tw.p.stats["swapped_out_blocks"] >= 2
    r2 = tw.submit(Q, 12)
    for _ in range(3):
        tw.step()
    r3 = tw.submit(P3, 4)
    deltas = []
    last = next(s for s in tw.p._slots
                if s is not None and s.req.rid == r2).n_emitted
    while tw.p.status(r2) == "active" or \
            tw.p.status(r3) in ("queued", "active"):
        tw.step()
        s2 = next((s for s in tw.p._slots
                   if s is not None and s.req.rid == r2), None)
        if s2 is not None:
            deltas.append(s2.n_emitted - last)
            last = s2.n_emitted
    for rid in (r2, r3):
        tw.check_stream(rid, tw.j.take_result(rid).asnumpy(),
                        tw.p.take_result(rid).numpy())
    tw.check()
    return deltas


@pytest.mark.parametrize("cache_dtype", DTYPES)
def test_overlap_swaps_defers_restore_without_token_gap(models, cache_dtype):
    """With overlap_swaps the restore moves to the iteration boundary:
    the decoding slot emits one token every iteration, one deferral, the
    restore happens, and the synchronous twin gives the same streams and
    the same prefill avoided."""
    sync = _overlap_twin(models, False, cache_dtype=cache_dtype)
    over = _overlap_twin(models, True, cache_dtype=cache_dtype)
    _drive_cold_chain(sync, 5)
    deltas = _drive_cold_chain(over, 5)
    st_s, st_o = sync.p.stats, over.p.stats
    assert st_o["deferred_swap_in_requests"] == 1
    assert st_s["deferred_swap_in_requests"] == 0
    assert st_o["swapped_in_blocks"] >= 2 and st_s["swapped_in_blocks"] >= 2
    assert all(d == 1 for d in deltas), deltas
    assert st_o["prefill_tokens_avoided"] == st_s["prefill_tokens_avoided"]
    assert st_o["blocks_in_use"] == 0 and st_s["blocks_in_use"] == 0


def test_overlap_swap_in_fault_retries_bit_exact(models):
    """A swap_in fault at the deferred restore quarantines only the cold
    request; its retry defers again, restores and completes."""
    tw = _overlap_twin(models, True)
    rng = np.random.RandomState(97)
    P = rng.randint(0, VOCAB, (1, 16))
    P2 = np.concatenate([P, rng.randint(0, VOCAB, (1, 2))], axis=1)
    tw.submit(P, 3)
    tw.run()
    assert tw.p.stats["swapped_out_blocks"] >= 2
    swap_ins0 = tw.p.stats["swapped_in_blocks"]
    r2 = tw.submit(P2, 4, retries=1)
    with tw.plan("serving.swap_in#%d@1:raise=OSError(copy-fail)" % r2) as pl:
        tw.run()
    assert pl.stats()["serving.swap_in"]["fired"] == 1
    assert tw.status(r2) == "ok"
    assert tw.p.stats["swapped_in_blocks"] > swap_ins0
    assert tw.p.stats["blocks_in_use"] == 0


def test_slot_engine_rejects_sessions(models):
    from mxtpu_torch.parallel.serving import ContinuousBatchingEngine
    e = ContinuousBatchingEngine(models[1], device="cpu", num_slots=2,
                                 max_length=MAXLEN)
    with pytest.raises(ValueError, match="session"):
        e.submit(np.array([[1, 2, 3]], np.int32), 2, session="s")
    assert e.prefix_probe(np.array([[1, 2, 3]])) == 0
    assert e.drop_cache() == 0
