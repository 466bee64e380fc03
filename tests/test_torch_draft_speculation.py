"""Draft-model speculation (``draft_block=``) on both engines of the port,
the ``MXTPU_SPEC_TREE`` default and the refusals, mirroring the
reference's tests/test_speculative.py (``test_draft_model_mode_full_
acceptance``, its MoE opt-out's refusals as plain type checks: the port
has no MoE).

With the draft model = the target, every greedy draft is the target's own
choice, so greedy windows accept their drafts: the draft hit rate over
greedy-only traffic is 1.0 on the slot engine, whose draft and verify
run the same attention code, and at least 0.9 on the paged engine, whose
verify reads K1's window and whose draft the slot cache.  With a sampled
rider, generated tokens per step exceed 1, as the reference asserts.
Every stream, greedy and sampled, over float and int8 caches, equals the
engine's plain stream and the isolated ``generate``, token for token; a
draft model that is not the target changes how many tokens a window
accepts, never a stream.  Across frameworks, the slot engine's greedy
draft-model streams and its draft and accept counters equal the JAX
engine's on the same weights."""

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import transformer_lm_sharding_rules
from mxtpu.parallel import ContinuousBatchingEngine as JaxSlotEngine
from mxtpu.parallel.mesh import DeviceMesh
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import TransformerLM
from mxtpu_torch.parallel.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)

MAXLEN = 64
SLOT = dict(num_slots=2, max_length=MAXLEN)
PAGED = dict(num_slots=2, max_length=MAXLEN, block_size=8, prefill_chunk=8)
ENGINES = [(ContinuousBatchingEngine, SLOT),
           (PagedContinuousBatchingEngine, PAGED)]
EIDS = ["slot", "paged"]


@pytest.fixture(scope="module")
def models():
    mx.random.seed(1)
    ref = JaxLM(20, units=32, hidden_size=64, num_layers=1, num_heads=4,
                num_kv_heads=2)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    port = TransformerLM(20, 32, 64, 1, 4, 2, device="cpu")
    load_mxtpu_params(port, {k: v.data().asnumpy()
                             for k, v in ref.collect_params().items()})
    return ref, port


def _prompts(seed=17, lengths=(6, 4, 9, 5, 12, 3)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 20, (1, t)).astype(np.int32) for t in lengths]


def _want(port, p, n, **kw):
    return port.generate(torch.from_numpy(p), n, max_length=MAXLEN,
                         **kw).numpy()


@pytest.mark.parametrize("cls,cfg", ENGINES, ids=EIDS)
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_draft_equal_to_target_accepts_greedy_windows(models, cls, cfg,
                                                      cache_dtype):
    port = models[1]
    eng = cls(port, device="cpu", spec_k=3, draft_block=port,
              cache_dtype=cache_dtype, **cfg)
    prompts = _prompts()
    ids = [eng.submit(p, 14) for p in prompts]
    res = eng.run()
    for p, r in zip(prompts, ids):
        np.testing.assert_array_equal(
            res[r].numpy(), _want(port, p, 14, cache_dtype=cache_dtype))
    st = eng.stats
    floor = 1.0 if cls is ContinuousBatchingEngine else 0.9
    assert st["drafted_tokens"] > 0
    assert st["draft_hit_rate"] >= floor, st
    assert st["generated_tokens"] / st["slot_iterations"] > 3.0, st


@pytest.mark.parametrize("cls,cfg", ENGINES, ids=EIDS)
def test_draft_mode_full_acceptance_with_a_sampled_rider(models, cls, cfg):
    """The reference's scenario: a greedy request and a sampled rider,
    both equal to generate; tokens a step above 1."""
    port = models[1]
    eng = cls(port, device="cpu", spec_k=3, draft_block=port, **cfg)
    p1, p2 = _prompts(17, (6, 4))
    r1 = eng.submit(p1, 16)
    r2 = eng.submit(p2, 12, temperature=0.8, top_k=10, seed=7)
    res = eng.run()
    np.testing.assert_array_equal(res[r1].numpy(), _want(port, p1, 16))
    np.testing.assert_array_equal(
        res[r2].numpy(), _want(port, p2, 12, temperature=0.8, top_k=10,
                               seed=7))
    st = eng.stats
    assert st["drafted_tokens"] > 0 and st["accepted_tokens"] > 0
    assert st["generated_tokens"] / st["steps"] > 1.0


@pytest.mark.parametrize("cls,cfg", ENGINES, ids=EIDS)
def test_another_draft_model_never_changes_a_stream(models, cls, cfg):
    """A draft that is not the target (another seed, two layers, other
    widths, the same vocabulary): greedy, sampled, penalized and opted-out
    streams equal the plain engine's."""
    port = models[1]
    torch.manual_seed(5)
    draft = TransformerLM(20, 16, 32, 2, 2, 1, device="cpu")
    reqs = [dict(), dict(temperature=0.7, seed=3),
            dict(repetition_penalty=1.3), dict(speculative=False),
            dict(eos_id=4)]
    prompts = _prompts(23, (7, 5, 9, 4, 6))

    def run(**kw):
        e = cls(port, device="cpu", **cfg, **kw)
        ids = [e.submit(p, 12, **r) for p, r in zip(prompts, reqs)]
        res = e.run()
        return [res[i].numpy() for i in ids], e.stats

    plain, _ = run()
    got, st = run(spec_k=4, draft_block=draft)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    assert st["drafted_tokens"] > 0


def test_slot_draft_streams_and_counters_match_the_reference(models):
    ref, port = models
    je = JaxSlotEngine(ref, DeviceMesh(dp=1), transformer_lm_sharding_rules(),
                       spec_k=3, draft_block=ref, **SLOT)
    pe = ContinuousBatchingEngine(port, device="cpu", spec_k=3,
                                  draft_block=port, **SLOT)
    prompts = _prompts(29, (6, 4, 9))
    jr = [je.submit(nd.array(p, dtype="int32"), 12) for p in prompts]
    pr = [pe.submit(p, 12) for p in prompts]
    jres, pres = je.run(), pe.run()
    for a, b in zip(jr, pr):
        np.testing.assert_array_equal(pres[b].numpy(), jres[a].asnumpy())
    keys = ("drafted_tokens", "accepted_tokens", "verify_calls", "steps",
            "slot_iterations")
    assert {k: pe.stats[k] for k in keys} == {k: je.stats[k] for k in keys}


@pytest.mark.parametrize("cls,cfg", ENGINES, ids=EIDS)
def test_spec_tree_default_comes_from_the_environment(models, monkeypatch,
                                                      cls, cfg):
    """``MXTPU_SPEC_TREE`` ("nodes,branch") is the engines' tree default:
    trees are drafted and the streams stay plain; an explicit config
    wins, and a draft model beside the ambient tree is refused."""
    port = models[1]
    prompts = [np.array([[1, 2, 3, 1, 2, 4, 1, 2, 3, 1, 2]], np.int32),
               np.array([[5, 6, 7, 5, 6, 8, 5, 6, 7, 5, 6]], np.int32)]
    plain = cls(port, device="cpu", **cfg)
    pids = [plain.submit(p, 14) for p in prompts]
    want = plain.run()
    monkeypatch.setenv("MXTPU_SPEC_TREE", "6,2")
    eng = cls(port, device="cpu", **cfg)
    assert eng._spec_tree == (6, 2)
    ids = [eng.submit(p, 14) for p in prompts]
    res = eng.run()
    for a, b in zip(ids, pids):
        np.testing.assert_array_equal(res[a].numpy(), want[b].numpy())
    assert eng.stats["tree_nodes_drafted"] > 0
    assert cls(port, device="cpu", spec_tree=(4, 3), **cfg)._spec_tree \
        == (4, 3)
    with pytest.raises(ValueError, match="spec_tree"):
        cls(port, device="cpu", spec_k=2, draft_block=port, **cfg)
    monkeypatch.setenv("MXTPU_SPEC_TREE", "")
    assert cls(port, device="cpu", **cfg)._spec_tree is None
    monkeypatch.setenv("MXTPU_SPEC_TREE", "40,2")
    with pytest.raises(ValueError, match="max_nodes"):
        cls(port, device="cpu", **cfg)


@pytest.mark.parametrize("cls,cfg", ENGINES, ids=EIDS)
def test_draft_block_refusals(models, cls, cfg):
    port = models[1]
    with pytest.raises(ValueError, match="spec_k"):
        cls(port, device="cpu", draft_block=port, **cfg)
    with pytest.raises(ValueError, match="spec_tree"):
        cls(port, device="cpu", spec_k=2, spec_tree=(4, 2),
            draft_block=port, **cfg)
    with pytest.raises(ValueError, match="dense"):
        cls(port, device="cpu", spec_k=2, draft_block=port.layers[0], **cfg)
    other = TransformerLM(30, 16, 32, 1, 2, 1, device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        cls(port, device="cpu", spec_k=2, draft_block=other, **cfg)
    eng = cls(port, device="cpu", spec_k=2, draft_block=port, **cfg)
    with pytest.raises(ValueError, match="self-drafting"):
        eng.submit(np.array([[1, 2, 3]], np.int32), 4, spec_tree=(4, 2))
