"""Tensor parallelism of the port (``mesh=make_mesh(tp=2)``,
``rules=transformer_lm_sharding_rules()``) held against the reference's
own tp=2 arms on the same weights.

The port's side is one gloo world of two CPU ranks
(``tests/torch_tp_world.py``, scenario ``serving``): rank 0 runs the
engines and ``ShardedDecoder``, rank 1 follows it.  The reference's side
runs in this process on the forced CPU devices at ``make_mesh(dp=1,
tp=2)``.  Logits agree within 1e-4; greedy streams are token-identical
with equal page ids and counters; seeded-sampled streams equal the
port's own tp=2 ``generate`` (the two frameworks draw differently); the
speculative streams equal the plain ones and the reference's, with its
counters; the gathered tp=2 export equals the tp=1 weights bit for bit.
"""

import numpy as np
import pytest

import mxtpu as mx
from mxtpu import nd
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import llama_tiny as jax_llama_tiny
from mxtpu.models.transformer import transformer_lm_sharding_rules
from mxtpu.parallel import (ContinuousBatchingEngine as JaxSlotEngine,
                            PagedContinuousBatchingEngine as JaxEngine,
                            ShardedDecoder as JaxDecoder, make_mesh)

import torch_tp_world as world

MAXLEN = 32
ENGINE = dict(num_slots=2, max_length=MAXLEN, block_size=8, prefill_chunk=8)
MICRO_ENGINE = dict(num_slots=3, max_length=64, block_size=8,
                    prefill_chunk=8)
P_FORK = [1, 2, 3, 1, 2, 4, 1, 2, 3, 1, 2]
P_FORK2 = [5, 6, 7, 5, 6, 8, 5, 6, 7, 5, 6]
P_FORK3 = [9, 3, 2, 9, 3, 5, 9, 3, 2, 9, 3]
STATS = ("steps", "prefill_chunks", "prefix_hit_requests",
         "cow_copied_blocks", "blocks_in_use", "blocks_shared",
         "swapped_in_blocks", "swapped_out_blocks", "generated_tokens")


def _params(block):
    return {k: v.data().asnumpy() for k, v in block.collect_params().items()}


def _jax_model(seed, *args, **kw):
    mx.random.seed(seed)
    ref = JaxLM(*args, **kw) if args else jax_llama_tiny(vocab_size=50)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    return ref


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(dp=1, tp=2)


@pytest.fixture(scope="module")
def refs():
    return dict(a=_jax_model(77), b=_jax_model(78),
                micro=_jax_model(1, 20, units=32, hidden_size=64,
                                 num_layers=1, num_heads=4, num_kv_heads=2))


@pytest.fixture(scope="module")
def traffic():
    rng = np.random.RandomState(3)
    greedy = [(rng.randint(0, 50, (1, t)).astype(np.int32), n, {})
              for t, n in ((3, 6), (5, 3), (12, 5), (7, 2))]
    greedy.append((rng.randint(0, 50, (1, 6)).astype(np.int32), 6,
                   dict(repetition_penalty=1.3)))
    sampled = [(rng.randint(0, 50, (1, 5)).astype(np.int32), 5,
                dict(temperature=0.8, top_k=6, seed=13)),
               (rng.randint(0, 50, (1, 9)).astype(np.int32), 4,
                dict(temperature=0.7, top_p=0.9, seed=5,
                     repetition_penalty=1.2))]
    shared = rng.randint(0, 50, (1, 13))
    prefix = [np.concatenate([shared, rng.randint(0, 50, (1, k))],
                             1).astype(np.int32) for k in (3, 5)]
    micro = [(np.array([P_FORK], np.int32), 20, {}),
             (np.array([P_FORK2], np.int32), 20,
              dict(temperature=0.8, seed=7)),
             (np.array([P_FORK3], np.int32), 18,
              dict(temperature=0.6, seed=9, repetition_penalty=1.3))]
    return dict(greedy=greedy, sampled=sampled, prefix=prefix, micro=micro,
                logit=rng.randint(0, 50, (1, 7)).astype(np.int64),
                swap=rng.randint(0, 50, (1, 19)).astype(np.int32))


@pytest.fixture(scope="module")
def tp2(refs, traffic, tmp_path_factory):
    """The port's tp=2 world: rank 0's record of every scenario."""
    tmp = tmp_path_factory.mktemp("tp2")
    payload = dict(
        spec=(50, 64, 172, 2, 4, 2), params=_params(refs["a"]),
        params_b=_params(refs["b"]), draft_spec=(50, 32, 64, 1, 4, 2),
        micro_spec=(20, 32, 64, 1, 4, 2), micro_params=_params(refs["micro"]),
        engine=ENGINE, micro_engine=MICRO_ENGINE, tmp=str(tmp),
        greedy=traffic["greedy"], sampled=traffic["sampled"],
        prefix=traffic["prefix"], micro_reqs=traffic["micro"],
        logit_prompt=traffic["logit"], swap_prompt=traffic["swap"])
    got = world.run_world(2, "serving", tmp, payload)
    assert [r["load_equal"] for r in got] == [True, True]
    return got[0]["rank0"]


def _nd(p):
    return nd.array(p, dtype="int32")


def _jax_streams(eng, reqs):
    rids = [eng.submit(_nd(p), n, **kw) for p, n, kw in reqs]
    res = eng.run()
    return [res[r].asnumpy() for r in rids]


def _iso(refs, mesh, which="a"):
    return JaxDecoder(refs[which], mesh, transformer_lm_sharding_rules())


def _generate(iso, reqs):
    return [iso.generate(_nd(p), max_new_tokens=n, max_length=MAXLEN,
                         **kw).asnumpy() for p, n, kw in reqs]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _same_stats(got, want, keys=STATS):
    keys = [k for k in keys if k in got and k in want]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_sharded_decoder_logits_and_generate(tp2, refs, traffic, mesh):
    """The prefill logits within 1e-4 of the reference's forward, and
    greedy (and penalized) ``generate`` token-identical to the
    reference's tp=2 ``ShardedDecoder``."""
    want = refs["a"](nd.array(traffic["logit"], dtype="int32")).asnumpy()
    np.testing.assert_allclose(tp2["logits"], want, atol=1e-4, rtol=1e-4)
    _equal(tp2["generate"], _generate(_iso(refs, mesh), traffic["greedy"]))


def test_paged_engine_greedy_streams_and_counters(tp2, refs, traffic, mesh):
    """Join/evict with a chunked prompt and a penalized request: streams
    and counters of the reference's tp=2 paged engine; each rank's pools
    hold one of the two KV heads."""
    je = JaxEngine(refs["a"], mesh, transformer_lm_sharding_rules(),
                   **ENGINE)
    _equal(tp2["paged_greedy"], _jax_streams(je, traffic["greedy"]))
    _same_stats(tp2["paged_greedy_stats"], je.stats)
    assert tp2["paged_pools_kv"] == 1
    for r in tp2["report"]:
        assert (r["heads"], r["kv_heads"]) == (2, 1)


def test_slot_engine_greedy_streams_and_counters(tp2, refs, traffic, mesh):
    je = JaxSlotEngine(refs["a"], mesh, transformer_lm_sharding_rules(),
                       num_slots=2, max_length=MAXLEN)
    _equal(tp2["slot_greedy"], _jax_streams(je, traffic["greedy"]))
    _same_stats(tp2["slot_greedy_stats"], je.stats)


@pytest.mark.parametrize("engine", ["paged", "slot"])
def test_seeded_sampled_streams_equal_tp2_generate(tp2, engine):
    """A seeded-sampled and a sampled-penalized request: each engine's
    tp=2 stream equals the tp=2 ``generate`` with the same seed."""
    _equal(tp2["%s_sampled" % engine], tp2["generate_sampled"])


def test_int8_cache_streams_and_counters(tp2, refs, traffic, mesh):
    je = JaxEngine(refs["a"], mesh, transformer_lm_sharding_rules(),
                   cache_dtype="int8", **ENGINE)
    _equal(tp2["int8"], _jax_streams(je, traffic["greedy"]))
    _same_stats(tp2["int8_stats"], je.stats)


def test_prefix_sharing_cow_pages_and_streams(tp2, refs, traffic, mesh):
    """B shares A's first page and clones the divergence page: the page
    ids at the copy-on-write point, the streams and the counters."""
    je = JaxEngine(refs["a"], mesh, transformer_lm_sharding_rules(),
                   **ENGINE)
    pa, pb = traffic["prefix"]
    ra = je.submit(_nd(pa), 6)
    je.step()
    je.step()
    rb = je.submit(_nd(pb), 5)
    je.step()
    pages = [list(je._slot_pages[i]) for r in (ra, rb)
             for i, s in enumerate(je._slots)
             if s is not None and s.req.rid == r]
    res = je.run()
    assert tp2["prefix_pages"] == pages
    assert pages[1][0] == pages[0][0] and pages[1][1] != pages[0][1]
    _equal(tp2["prefix"], [res[ra].asnumpy(), res[rb].asnumpy()])
    _same_stats(tp2["prefix_stats"], je.stats)
    assert tp2["prefix_stats"]["cow_copied_blocks"] == 1


def test_hierarchical_swap_round_trip(tp2, refs, traffic, mesh):
    """The reference's tp=2 swap round trip (tests/test_serving_
    hierarchical.py:628): each rank spills and restores its own heads;
    the restored stream and the swap counters equal the reference's."""
    je = JaxEngine(refs["a"], mesh, transformer_lm_sharding_rules(),
                   pin_bytes=1, host_cache_bytes="1MiB", **ENGINE)
    want = [_jax_streams(je, [(traffic["swap"], 5, {})])[0]
            for _ in range(2)]
    _equal(tp2["swap"], want)
    _same_stats(tp2["swap_stats"], je.stats)
    assert tp2["swap_stats"]["swapped_in_blocks"] == 2


def test_hot_swap_adopt_slices_generation_b(tp2, refs, traffic, mesh):
    """``adopt`` of generation B's whole arrays: each rank keeps its
    slice, and the streams are the reference's tp=2 decoder's on B."""
    assert tp2["adopt_gen"] == 1
    _equal(tp2["adopt"], _generate(_iso(refs, mesh, "b"), traffic["greedy"]))


def test_hot_swap_adopt_sends_the_path_not_the_weights(tp2):
    """At tp=2 ``adopt`` sends the checkpoint's path over the channel,
    not its arrays: each rank reads the file and keeps its own shard."""
    assert 0 < tp2["adopt_sent_bytes"] < 1024
    assert tp2["adopt_ckpt_bytes"] > 10 * tp2["adopt_sent_bytes"]


def test_rank_report_turns_collective_timing_on_and_off(tp2):
    """``rank_report(timing=True)`` times every rank's collectives from
    there on, the same count on each; ``timing=False`` stops it."""
    timed = tp2["timed_collectives"]
    assert len(timed) == 2 and timed[0] > 0 and timed[0] == timed[1]
    assert tp2["untimed_collectives"] == [0, 0]


def test_draft_model_speculation_equals_plain(tp2, refs, traffic, mesh):
    """A draft model sharded by the same rules: the greedy streams are
    the reference's plain tp=2 streams."""
    _equal(tp2["draft"], _generate(_iso(refs, mesh), traffic["greedy"]))
    assert tp2["draft_stats"]["drafted_tokens"] > 0
    assert tp2["draft_stats"]["blocks_in_use"] == 0


@pytest.mark.parametrize("spec", ["linear", "tree"])
def test_ngram_speculation_matches_reference(tp2, refs, traffic, mesh,
                                             spec):
    """The cycling micro-model at tp=2: every speculative stream equals
    the plain tp=2 stream bit for bit (greedy, sampled, penalized); the
    greedy stream and the draft, accept, verify and tree counters equal
    the reference's tp=2 engine's."""
    _equal(tp2["micro_" + spec], tp2["micro_plain"])
    kw = dict(spec_k=3) if spec == "linear" else dict(spec_k=3,
                                                      spec_tree=(6, 2))
    je = JaxEngine(refs["micro"], mesh, transformer_lm_sharding_rules(),
                   **MICRO_ENGINE, **kw)
    greedy = traffic["micro"][:1]
    _equal(tp2["micro_" + spec][:1], _jax_streams(je, greedy))
    st = tp2["micro_%s_stats" % spec]
    assert st["accepted_tokens"] > 0
    if spec == "tree":
        assert st["tree_nodes_drafted"] > 0


def test_tp2_export_equals_the_tp1_weights(tp2, refs):
    """The gathered export of the sharded model equals the whole
    reference arrays it was loaded from, bit for bit (the qkv head-group
    split undone)."""
    want = {k.split("_", 1)[1]: v for k, v in _params(refs["a"]).items()}
    got = tp2["export"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
