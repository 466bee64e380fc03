"""Serving a Switch MoE model in the port, held against the JAX reference
on the CPU with the reference's weights carried across by
``load_mxtpu_params``.

- the slot engine and the paged engine (the reference's
  ``test_moe_engine_parity`` and ``test_moe_paged_engine_parity``):
  greedy streams token-identical to the reference engines', with equal
  page ids, and to ``generate``; a seeded stream equal to the port's
  ``generate`` with that seed; prompts longer than a chunk thread the
  prompt's length (``total_len``) into every chunk;
- the reference's opt-outs for routed models: prefill bucketing off on
  both engines (chunks and slot prefill at the prompt's own length),
  speculation silently off (linear and tree, engine-wide and per
  request), an explicit ``draft_block`` on an MoE target and an MoE
  ``draft_block`` refused with the reference's messages, a
  ``spec_tree`` request refused, no prefix lookup and no registration
  (``prefix_hit_requests`` 0 on a shared prefix), ``prefix_probe`` 0, a
  hierarchical cache with no budget, ``submit(session=...)`` refused;
- tp=2 (``tests/torch_tp_world.py``, scenario ``moe``): the port's
  two-rank ``ShardedDecoder.generate`` equals the reference's tp=2 arm of
  ``test_moe_block_disables_bucketing``, its engines' streams equal the
  port's tp=1 streams, its gathered parameters are the whole arrays, and
  rules that split an expert raise."""

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import transformer_lm_sharding_rules
from mxtpu.parallel import (ContinuousBatchingEngine as JaxSlotEngine,
                            PagedContinuousBatchingEngine as JaxEngine,
                            ShardedDecoder as JaxDecoder, make_mesh)
from mxtpu_torch import base
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import TransformerLM
from mxtpu_torch.parallel.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)

import torch_tp_world as world

SPEC = (40, 16, 32, 1, 4, 2)          # vocab, units, hidden, layers, heads, kv
MOE = dict(num_experts=4, capacity_factor=4.0)
ENGINE = dict(num_slots=2, max_length=16, block_size=8, prefill_chunk=8)


def _params(block):
    return {k: v.data().asnumpy() for k, v in block.collect_params().items()}


def _ref(seed=9, spec=SPEC, **kw):
    mx.random.seed(seed)
    ref = JaxLM(*spec[:5], num_kv_heads=spec[5], **dict(MOE, **kw))
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    return ref


def _port(params, spec=SPEC, **kw):
    port = TransformerLM(*spec, device="cpu", **dict(MOE, **kw))
    load_mxtpu_params(port, params)
    return port


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(dp=1, tp=2)


@pytest.fixture(scope="module")
def models():
    ref = _ref()
    return ref, _port(_params(ref))


def _prompts(rng, lengths, vocab=40):
    return [rng.randint(0, vocab, (1, t)).astype(np.int32) for t in lengths]


def _nd(p):
    return nd.array(p, dtype="int32")


def _run(eng, prompts, n, wrap=lambda p: p):
    rids = [eng.submit(wrap(p), n) for p in prompts]
    res = eng.run()
    return [np.asarray(res[r].asnumpy() if hasattr(res[r], "asnumpy")
                       else res[r].numpy()) for r in rids]


def _row_of(engine, rid):
    for i, s in enumerate(engine._slots):
        if s is not None and s.req.rid == rid:
            return i
    raise AssertionError("rid %d holds no slot" % rid)


# -- the engines against the reference's ----------------------------------------

def test_moe_slot_engine_parity(models, mesh):
    """The reference's test_moe_engine_parity: the prompts prefill at
    their own lengths and the streams equal the reference engine's and
    ``generate``'s."""
    ref, port = models
    prompts = _prompts(np.random.RandomState(23), (3, 4, 5))
    je = JaxSlotEngine(ref, mesh, transformer_lm_sharding_rules(),
                       num_slots=2, max_length=16)
    want = _run(je, prompts, 3, _nd)
    eng = ContinuousBatchingEngine(port, num_slots=2, max_length=16,
                                   device="cpu")
    calls = []
    orig = eng._dec.prefill
    eng._dec.prefill = lambda ids, *a, **k: (calls.append(ids.shape[1]),
                                             orig(ids, *a, **k))[1]
    got = _run(eng, prompts, 3)
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, port.generate(torch.from_numpy(p), 3).numpy())
    assert calls == [3, 4, 5]              # no bucket padding


def test_moe_paged_engine_parity_and_page_ids(models, mesh):
    """The reference's test_moe_paged_engine_parity, plus a prompt of
    two chunks: streams and page ids equal the reference engine's,
    chunks are unpadded and each carries the prompt's length."""
    ref, port = models
    prompts = _prompts(np.random.RandomState(23), (3, 4, 11))
    je = JaxEngine(ref, mesh, transformer_lm_sharding_rules(), **ENGINE)
    eng = PagedContinuousBatchingEngine(port, device="cpu", **ENGINE)
    chunks = []
    orig = eng._dec.prefill_pages

    def spy(ids, *a, **k):
        chunks.append((ids.shape[1], k.get("total_len")))
        return orig(ids, *a, **k)

    eng._dec.prefill_pages = spy
    jr = [je.submit(_nd(p), 3) for p in prompts]
    pr = [eng.submit(p, 3) for p in prompts]
    je.step()
    eng.step()
    assert [je._slot_pages[_row_of(je, r)] for r in jr[:2]] == \
        [eng._slot_pages[_row_of(eng, r)] for r in pr[:2]]
    jres, res = je.run(), eng.run()
    for a, b, p in zip(jr, pr, prompts):
        np.testing.assert_array_equal(res[b].numpy(), jres[a].asnumpy())
        np.testing.assert_array_equal(
            res[b].numpy(), port.generate(torch.from_numpy(p), 3).numpy())
    assert sorted(chunks) == sorted([(3, 3), (4, 4), (8, 11), (3, 11)])
    st = eng.stats
    assert st["prefix_hit_requests"] == 0 == je.stats["prefix_hit_requests"]
    assert st["blocks_in_use"] == 0 and st["steps"] == je.stats["steps"]
    assert st["prefill_tokens"] == 18


def test_seeded_stream_equals_generate(models):
    port = models[1]
    p = _prompts(np.random.RandomState(5), (6,))[0]
    kw = dict(temperature=0.8, top_k=10, seed=7)
    for eng in (PagedContinuousBatchingEngine(port, device="cpu", **ENGINE),
                ContinuousBatchingEngine(port, num_slots=2, max_length=16,
                                         device="cpu")):
        rid = eng.submit(p, 6, **kw)
        got = eng.run()[rid].numpy()
        np.testing.assert_array_equal(
            got, port.generate(torch.from_numpy(p), 6, **kw).numpy())


def test_decode_runs_the_paged_kernels_wrappers(models):
    """Every decode step and chunk goes through K1's and K2's wrappers."""
    port = models[1]
    eng = PagedContinuousBatchingEngine(port, device="cpu", **ENGINE)
    base.reset_counts()
    _run(eng, _prompts(np.random.RandomState(1), (5, 9)), 4)
    st = eng.stats
    assert base.count("paged_attention") == st["steps"] * len(port.layers)
    assert base.count("paged_prefill") == st["prefill_chunks"] == 3


# -- the opt-outs ---------------------------------------------------------------

def test_moe_blocks_opt_out_of_speculation(models):
    """The reference's test_moe_blocks_opt_out_of_speculation
    (tests/test_speculative.py:266), on both engines, plus trees and a
    request's ``spec_tree``."""
    port = models[1]
    torch.manual_seed(10)
    dense = TransformerLM(40, 16, 32, 1, 2, 2, device="cpu")
    for cls, kw in ((ContinuousBatchingEngine, {}),
                    (PagedContinuousBatchingEngine, dict(block_size=8,
                                                         prefill_chunk=8))):
        mk = dict(num_slots=2, max_length=16, device="cpu", **kw)
        for spec in (dict(spec_k=3), dict(spec_tree=(6, 2)),
                     dict(spec_k=3, spec_tree=(6, 2))):
            eng = cls(port, **mk, **spec)
            assert eng._spec_on is False and eng._drafter is None
            with pytest.raises(ValueError, match="non-MoE"):
                eng.submit(np.array([[1, 2, 3]], np.int32), 2,
                           spec_tree=(4, 2))
            p = np.array([[1, 2, 3, 1, 2, 3, 1, 2]], np.int32)
            rid = eng.submit(p, 6, speculative=True)
            got = eng.run()[rid].numpy()
            np.testing.assert_array_equal(
                got, port.generate(torch.from_numpy(p), 6).numpy())
            assert eng.stats["drafted_tokens"] == 0
            assert eng.stats["verify_calls"] == 0
        with pytest.raises(ValueError, match="dense"):
            cls(dense, **mk, spec_k=3, draft_block=port)
        with pytest.raises(ValueError, match="spec_k"):
            cls(dense, **mk, draft_block=dense)
        with pytest.raises(ValueError, match="MoE target"):
            cls(port, **mk, spec_k=3, draft_block=dense)
        with pytest.raises(ValueError, match="MoE target"):
            cls(port, **mk, spec_k=3, draft_block=port)


def test_paged_engine_shares_no_prefix_and_pins_nothing(models):
    """A shared 13-token prefix: no lookup hit, no copy-on-write, no
    registration; ``prefix_probe`` 0; a hierarchical cache with no
    budget even when budgets are given, so nothing is pinned or spilled;
    ``session=`` refused; ``drop_cache`` and
    ``close_session`` free nothing."""
    port = models[1]
    eng = PagedContinuousBatchingEngine(port, device="cpu", num_slots=2,
                                        max_length=32, block_size=8,
                                        prefill_chunk=8, pin_bytes="1MiB",
                                        host_cache_bytes="1MiB")
    assert eng._hc.pin_blocks == 0 and eng._hc.host_blocks == 0
    assert not eng._hierarchy_on()
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 40, (1, 13))
    pa = np.concatenate([shared, rng.randint(0, 40, (1, 3))], 1)
    pb = np.concatenate([shared, rng.randint(0, 40, (1, 5))], 1)
    pa, pb = pa.astype(np.int32), pb.astype(np.int32)
    ra = eng.submit(pa, 6)
    eng.step()
    eng.step()
    assert eng.prefix_probe(pb) == 0
    rb = eng.submit(pb, 5)
    eng.step()
    pages = [eng._slot_pages[_row_of(eng, r)] for r in (ra, rb)]
    assert not set(pages[0]) & set(pages[1])
    res = eng.run()
    for r, p, n in ((ra, pa, 6), (rb, pb, 5)):
        np.testing.assert_array_equal(
            res[r].numpy(), port.generate(torch.from_numpy(p), n).numpy())
    st = eng.stats
    assert st["prefix_hit_requests"] == 0 and st["cow_copied_blocks"] == 0
    assert st["blocks_shared"] == 0 and st["pinned_blocks"] == 0
    assert st["spilled_blocks"] == 0 and not eng._hc._chains
    assert st["swapped_out_blocks"] == 0 and st["blocks_in_use"] == 0
    assert eng._prefix.probe(pa[0], limit=15) == 0    # nothing registered
    assert eng.prefix_probe(pa) == 0
    with pytest.raises(ValueError, match="session"):
        eng.submit(pa, 2, session="chat")
    assert eng.drop_cache() == 0 and eng.close_session("chat") == 0


def test_dense_paged_engine_still_shares_and_buckets():
    """The opt-outs key on the model: a dense model keeps bucketed
    chunks, the hierarchical cache and prefix hits."""
    torch.manual_seed(3)
    dense = TransformerLM(40, 16, 32, 1, 4, 2, device="cpu")
    eng = PagedContinuousBatchingEngine(dense, device="cpu", num_slots=2,
                                        max_length=32, block_size=8,
                                        prefill_chunk=8)
    assert eng._hc is not None and eng._spec_on is False
    assert eng._plan_chunks(0, 11)[0] == [(0, 8, 8), (8, 3, 8)]
    p = np.arange(1, 14, dtype=np.int32)[None]
    eng.submit(p, 4)
    eng.step()
    eng.step()                          # both chunks in: pages registered
    assert eng.prefix_probe(p) == 8
    eng.run()


# -- tensor parallelism -----------------------------------------------------------

@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """The reference's test_moe_block_disables_bucketing model (2 layers)
    and the port's tp=2 world over it."""
    spec = (40, 16, 32, 2, 4, 2)
    ref = _ref(seed=9, spec=spec)
    reqs = [(p, 4, {}) for p in _prompts(np.random.RandomState(31),
                                          (3, 5, 11))]
    payload = dict(spec=spec, params=_params(ref), moe=MOE, engine=ENGINE,
                   prompt=np.random.RandomState(23).randint(0, 40, (2, 3)),
                   reqs=reqs)
    got = world.run_world(2, "moe", tmp_path_factory.mktemp("moe_tp2"),
                          payload)
    return dict(ref=ref, spec=spec, reqs=reqs, payload=payload,
                out=got[0]["rank0"], shapes=[g["shapes"] for g in got])


def test_tp2_generate_equals_the_references_tp2_arm(tp2, mesh):
    dec = JaxDecoder(tp2["ref"], mesh, transformer_lm_sharding_rules())
    assert dec._block_has_moe() and tp2["out"]["has_moe"]
    prompt = nd.array(tp2["payload"]["prompt"], dtype="int32")
    want = dec.generate(prompt, max_new_tokens=3).asnumpy()
    np.testing.assert_array_equal(tp2["out"]["generate"], want)
    np.testing.assert_array_equal(want, tp2["ref"].generate(
        prompt, max_new_tokens=3).asnumpy())


def test_tp2_engine_streams_equal_tp1(tp2):
    port = _port(tp2["payload"]["params"], spec=tp2["spec"])
    for name, eng in (
            ("paged", PagedContinuousBatchingEngine(port, device="cpu",
                                                    **ENGINE)),
            ("slot", ContinuousBatchingEngine(port, num_slots=2,
                                              max_length=16, device="cpu"))):
        want = world.streams(eng, tp2["reqs"])
        for g, w in zip(tp2["out"][name], want):
            np.testing.assert_array_equal(g, w)
    assert tp2["out"]["paged_stats"]["prefix_hit_requests"] == 0


def test_tp2_splits_the_attention_and_keeps_the_experts_whole(tp2):
    """Each rank runs 2 of the 4 query heads and 1 of the 2 KV heads;
    the router and the experts keep their whole shapes on both."""
    for r in tp2["out"]["report"]:
        assert (r["heads"], r["kv_heads"]) == (2, 1)
    for shapes in tp2["shapes"]:
        assert shapes["layer0_moe_experts_w1"] == (4, 16, 32)
        assert shapes["layer1_moe_router_weight"] == (4, 16)
        assert shapes["layer0_attn_qkv_weight"] == (16, 16)


def test_tp2_gathered_parameters_are_the_whole_arrays(tp2):
    want = {k.split("_", 1)[1]: v for k, v in tp2["payload"]["params"].items()}
    got = tp2["out"]["export"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_rules_that_split_an_expert_raise(tp2):
    err = tp2["out"]["split_error"]
    assert err is not None and "expert parallelism" in err
    assert "layer0_moe_experts_w1" in err
    assert tp2["out"]["split_untouched"] == 4
