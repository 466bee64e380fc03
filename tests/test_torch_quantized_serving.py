"""Serving with an int8 KV cache in the port, held against the JAX
reference (tests/test_quantized_serving.py's scenarios, on the same
weights through the weight bridge) and inside the port against its own
isolated ``generate(cache_dtype="int8")``.

Across frameworks: ``llama_tiny``'s int8 prefill logits within 1e-4 of
the reference's where every payload agrees (1e-3 where a row rounds one
step otherwise at a boundary, reported), and greedy int8 engine streams
token-identical to the reference's paged engine with identical page ids.
Inside the port: int8 prefill logits within 2% relative of the float
cache's (the reference's documented claim), and every engine stream
(greedy, seeded-sampled, penalized, shared-prefix, chunked; linear, tree
and mixed speculation, side-branch fix-ups included) equal to int8
``generate`` token for token, every page back in the pool.

The reference's own mixed-pool int8 arm
(tests/test_tree_speculative.py::test_paged_tree_mixed_pool_bit_identical)
holds its int8 engine against a float32 ``generate`` and fails there;
the port's mixed pool is held to its own int8 ``generate`` here."""

import numpy as np
import pytest
import torch

import mxtpu as mx
from chip_smoke import fork_prompts
from mxtpu import nd
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import llama_tiny as jax_llama_tiny, \
    transformer_lm_sharding_rules
from mxtpu.parallel import PagedContinuousBatchingEngine as JaxEngine, \
    make_mesh
from mxtpu_torch import base
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import TransformerLM, llama_tiny
from mxtpu_torch.parallel.serving import (PagedContinuousBatchingEngine,
                                          resolve_cache_dtype)

MAXLEN = 32
ENGINE = dict(num_slots=2, max_length=MAXLEN, block_size=8, prefill_chunk=8,
              cache_dtype="int8")
P_FORK = [1, 2, 3, 1, 2, 4, 1, 2, 3, 1, 2]
P_FORK2 = [5, 6, 7, 5, 6, 8, 5, 6, 7, 5, 6]
P_FORK3 = [9, 3, 2, 9, 3, 5, 9, 3, 2, 9, 3]


def _bridge(ref, port):
    load_mxtpu_params(port, {k: v.data().asnumpy()
                             for k, v in ref.collect_params().items()})
    return ref, port


@pytest.fixture(scope="module")
def models():
    """tests/test_quantized_serving.py's ``tiny``: llama_tiny, vocab 50,
    seed 77."""
    mx.random.seed(77)
    ref = jax_llama_tiny(vocab_size=50)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    return _bridge(ref, llama_tiny(vocab_size=50, device="cpu"))


@pytest.fixture(scope="module")
def micro():
    """The cycling micro-model of the speculative tests (seed 1, vocab
    20, 1 layer), port side only."""
    mx.random.seed(1)
    ref = JaxLM(20, units=32, hidden_size=64, num_layers=1, num_heads=4,
                num_kv_heads=2)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))
    return _bridge(ref, TransformerLM(20, 32, 64, 1, 4, 2, device="cpu"))[1]


def _prompt(rng, t, vocab=50):
    return rng.randint(0, vocab, (1, t)).astype(np.int32)


def _want(port, p, n, max_length=MAXLEN, **kw):
    return port.generate(torch.from_numpy(np.asarray(p)), n,
                         max_length=max_length, cache_dtype="int8",
                         **kw).numpy()


# -- against the reference ---------------------------------------------------

def test_int8_prefill_logits_and_payload_match_reference(models):
    """One 12-token prefill into an int8 contiguous cache in both
    frameworks: the payloads agree (a row may round one step otherwise
    where x / s sits on a rounding boundary: reported, held to 1e-3) and
    the logits within 1e-4."""
    ref, port = models
    p = _prompt(np.random.RandomState(5), 12)
    jl, jcaches = ref.prefill(nd.array(p, dtype="int32"),
                              ref.init_cache(1, MAXLEN, "int8"))
    caches = port.init_cache(1, MAXLEN, "int8")
    got = port.prefill(torch.from_numpy(p).long(), caches)
    off_by_one = 0
    for (jk, jv), (k, v) in zip(jcaches, caches):
        for jleaf, leaf in ((jk, k), (jv, v)):
            d = np.abs(leaf[0].numpy().astype(np.int32)
                       - jleaf[0].asnumpy().astype(np.int32))
            assert d.max() <= 1
            off_by_one += int((d == 1).sum())
            np.testing.assert_allclose(leaf[1].numpy(), jleaf[1].asnumpy(),
                                       rtol=1e-6, atol=0)
    tol = 1e-4 if off_by_one == 0 else 1e-3
    print("payload elements one step apart: %d" % off_by_one)
    np.testing.assert_allclose(got.numpy(), jl.asnumpy(), atol=tol, rtol=tol)


def test_int8_greedy_streams_and_pages_match_reference(models):
    """More requests than slots, one prompt prefilled in two chunks, and
    a request sharing another's prefix (copy-on-write at the divergence
    page): greedy int8 streams token-identical to the reference engine's,
    with identical page ids at the sharing point, and every page back."""
    ref, port = models
    jeng = JaxEngine(ref, make_mesh(dp=1, tp=2),
                     transformer_lm_sharding_rules(), **ENGINE)
    eng = PagedContinuousBatchingEngine(port, device="cpu", **ENGINE)
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 50, (1, 13))
    pa = np.concatenate([shared, rng.randint(0, 50, (1, 3))], 1)
    pb = np.concatenate([shared, rng.randint(0, 50, (1, 5))], 1)
    rest = [_prompt(rng, t) for t in (5, 12, 7)]
    rids = {}
    for e, wrap in ((jeng, lambda p: nd.array(p, dtype="int32")),
                    (eng, lambda p: p.astype(np.int32))):
        ra = e.submit(wrap(pa), 6)
        e.step()
        e.step()
        rb = e.submit(wrap(pb), 5)
        e.step()                        # B admits: shares A's first page
        pages = [list(e._slot_pages[i]) for i in range(2)]
        rids[e] = ([ra, rb] + [e.submit(wrap(p), n)
                               for p, n in zip(rest, (3, 5, 2))], pages)
    assert rids[eng][1] == rids[jeng][1]
    steps = eng.stats["steps"]
    base.reset_counts()
    jres, res = jeng.run(), eng.run()
    for jr, r in zip(rids[jeng][0], rids[eng][0]):
        np.testing.assert_array_equal(res[r].numpy(), jres[jr].asnumpy())
    assert eng.stats["cow_copied_blocks"] == 1
    assert eng.stats["blocks_in_use"] == 0
    assert jeng.stats["blocks_in_use"] == 0
    # every decode step and every chunk went through the int8 wrappers
    counts = base.counts()
    assert counts.get("paged_attention[int8]", 0) == 2 * (
        eng.stats["steps"] - steps)
    assert counts.get("paged_prefill[int8]", 0) > 0
    assert "paged_attention" not in counts and "paged_prefill" not in counts


# -- inside the port ---------------------------------------------------------

def test_int8_prefill_logits_within_two_percent_of_float(models):
    port = models[1]
    p = torch.from_numpy(_prompt(np.random.RandomState(5), 12)).long()
    ref = port.prefill(p, port.init_cache(1, MAXLEN))
    out = port.prefill(p, port.init_cache(1, MAXLEN, "int8"))
    rel = float((out - ref).abs().max() / ref.abs().max())
    assert rel < 0.02, rel


def test_resolve_cache_dtype_reads_the_ambient_default(models, monkeypatch):
    port = models[1]
    assert resolve_cache_dtype(None) == torch.float32
    assert resolve_cache_dtype(None, torch.bfloat16) == torch.bfloat16
    assert resolve_cache_dtype("int8") == "int8"
    monkeypatch.setenv("MXTPU_CACHE_DTYPE", "int8")
    assert resolve_cache_dtype(None) == "int8"
    eng = PagedContinuousBatchingEngine(port, device="cpu", num_slots=1,
                                        max_length=16, block_size=8)
    pk, pv = eng._pools[0]
    assert pk[0].dtype == torch.int8 and pk[1].dtype == torch.float32
    assert tuple(pk[1].shape) == tuple(pk[0].shape[:3])
    p = np.array([[3, 1, 4, 1, 5]], np.int32)
    r = eng.submit(p, 4)
    np.testing.assert_array_equal(eng.run()[r].numpy(),
                                  port.generate(torch.from_numpy(p),
                                                4).numpy())


def test_int8_engine_shared_chunked_speculative_equals_generate(models):
    """tests/test_quantized_serving.py's paged scenario: prefix sharing,
    chunked prefill and spec_k = 2 at int8; greedy and seeded-sampled
    streams equal int8 generate, and a penalized request beside them."""
    port = models[1]
    eng = PagedContinuousBatchingEngine(port, device="cpu", spec_k=2,
                                        **ENGINE)
    rng = np.random.RandomState(2)
    shared = rng.randint(0, 50, (1, 13))
    pa = np.concatenate([shared, rng.randint(0, 50, (1, 4))], 1)
    pb = np.concatenate([shared, rng.randint(0, 50, (1, 2))], 1)
    long = _prompt(rng, 17)             # 3 chunks at prefill_chunk=8
    sampled = _prompt(rng, 6)
    ra = eng.submit(pa, 5)
    eng.step()                          # A prefills and registers pages
    eng.step()
    rb = eng.submit(pb, 4)              # shares A's full prefix pages
    rc = eng.submit(long, 3)
    rd = eng.submit(sampled, 4, temperature=0.9, top_k=8, seed=21)
    re = eng.submit(pa, 6, repetition_penalty=1.4)
    res = eng.run()
    np.testing.assert_array_equal(res[ra].numpy(), _want(port, pa, 5))
    np.testing.assert_array_equal(res[rb].numpy(), _want(port, pb, 4))
    np.testing.assert_array_equal(res[rc].numpy(), _want(port, long, 3))
    np.testing.assert_array_equal(
        res[rd].numpy(),
        _want(port, sampled, 4, temperature=0.9, top_k=8, seed=21))
    np.testing.assert_array_equal(
        res[re].numpy(), _want(port, pa, 6, repetition_penalty=1.4))
    st = eng.stats
    assert st["prefix_hit_requests"] >= 1
    assert st["blocks_in_use"] == 0     # clean drain


REQS = [(P_FORK, 20, dict()),
        (P_FORK2, 20, dict(temperature=0.8, seed=7)),
        (P_FORK3, 18, dict(temperature=0.6, seed=9, repetition_penalty=1.3))]


@pytest.mark.parametrize("spec", [dict(spec_k=3), dict(spec_tree=(6, 2)),
                                  dict(spec_k=3, spec_tree=(6, 2))],
                         ids=["linear", "tree", "mixed"])
def test_int8_speculative_streams_equal_plain_and_generate(micro, spec):
    """The cycling micro-model with an int8 cache: greedy, seeded-sampled
    and penalized streams with speculation equal the same settings'
    streams without it and int8 generate; drafts are accepted.  In the
    mixed pool request 1 drafts linearly (spec_tree=False) and rides the
    tree verify call as a chain."""
    cfg = dict(ENGINE, num_slots=3, max_length=64)
    outs = {}
    for on in (False, True):
        eng = PagedContinuousBatchingEngine(micro, device="cpu", **cfg,
                                            **(spec if on else {}))
        rids = [eng.submit(np.array([p], np.int32), n,
                           **dict(kw, **({"spec_tree": False}
                                         if on and j == 1
                                         and "spec_tree" in spec else {})))
                for j, (p, n, kw) in enumerate(REQS)]
        res = eng.run()
        outs[on] = [res[r].numpy() for r in rids]
        assert eng.stats["blocks_in_use"] == 0
    st = eng.stats
    assert st["accepted_tokens"] > 0
    if "spec_tree" in spec:
        assert st["tree_nodes_drafted"] > 0
    if len(spec) == 2:
        assert st["drafted_tokens"] > st["tree_nodes_drafted"]
    for (p, n, kw), a, b in zip(REQS, outs[False], outs[True]):
        want = _want(micro, [p], n, max_length=64, **kw)
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(b, want)


def test_int8_side_branch_fixup_moves_payload_and_scales(micro):
    """Accepted side-branch paths move their int8 rows and scales into
    depth order before the next step reads them; streams equal int8
    generate and every page comes back."""
    prompts = fork_prompts(micro, 3, np.random.RandomState(0))
    calls = []
    inner = micro.permute_pool_span

    def counted(*a, **kw):
        calls.append(a[3].clone())
        return inner(*a, **kw)
    micro.permute_pool_span = counted
    try:
        eng = PagedContinuousBatchingEngine(
            micro, device="cpu", spec_tree=(6, 2),
            **dict(ENGINE, num_slots=3, max_length=64))
        rids = [eng.submit(np.array([p], np.int32), 12) for p in prompts]
        res = eng.run()
    finally:
        del micro.permute_pool_span
    assert any(bool(((s >= 0) & (s != torch.arange(s.shape[1]))).any())
               for s in calls), "no side-branch fix-up ran"
    for r, p in zip(rids, prompts):
        np.testing.assert_array_equal(res[r].numpy(),
                                      _want(micro, [p], 12, max_length=64))
    assert eng.stats["blocks_in_use"] == 0
