"""The slot engine of the port (``ContinuousBatchingEngine`` over one
contiguous cache row a slot), held against the JAX reference on the
same seeded numpy inputs and weights (the weight bridge), and inside the
port against its isolated ``generate`` and its own plain streams.

- The contiguous cache ops (``cache_write_rows`` / ``_span`` / ``_slot``,
  their ``_q8`` forms, ``cache_permute_span`` / ``_q8``) equal the
  reference's ``_internal_cache_*`` ops bit for bit (exact: they move or
  quantize the same bits), invalid and past-the-end lanes included.
- ``step_slots``, ``verify_slots`` (linear and tree) and
  ``permute_cache_span`` of the model give the reference's logits and
  caches within 1e-4 (the tolerance of tests/test_torch_transformer.py:
  float32 sums in other orders), over float and int8 caches.
- Lane w of ``verify_slots`` is ``step_slots`` at pos + w ``torch.equal``
  (and a tree lane the sequential step along its path).
- Engine streams: greedy streams token-identical to the reference
  ``ContinuousBatchingEngine`` (with its draft, accept and verify
  counters) and to the port's ``generate``, over float and int8 caches,
  plain, linear and tree speculation; seeded-sampled and penalized
  speculative streams equal the plain ones.

The model is the reference speculative tests' cycling micro-model (seed
1, vocab 20, 1 layer), so drafts are accepted and rejected for real."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import transformer_lm_sharding_rules
from mxtpu.ops import tensor as jtensor
from mxtpu.parallel import ContinuousBatchingEngine as JaxSlotEngine
from mxtpu.parallel.mesh import DeviceMesh
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import TransformerLM
from mxtpu_torch.ops import tensor
from mxtpu_torch.parallel.serving import ContinuousBatchingEngine, _tree_paths

TOL = dict(atol=1e-4, rtol=1e-4)
MAXLEN = 48
B, KV, T, D = 3, 2, 12, 16
P_FORK = [1, 2, 3, 1, 2, 4, 1, 2, 3, 1, 2]
P_FORK2 = [5, 6, 7, 5, 6, 8, 5, 6, 7, 5, 6]
P_FORK3 = [9, 3, 2, 9, 3, 5, 9, 3, 2, 9, 3]
COUNTERS = ("drafted_tokens", "accepted_tokens", "verify_calls",
            "tree_nodes_drafted", "tree_paths", "slot_iterations", "steps",
            "generated_tokens")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cache(rng):
    return rng.randn(B, KV, T, D).astype(np.float32)


def _q8_cache(rng):
    q, s = tensor._q8_quantize(_t(_cache(rng)))
    return q.numpy(), s.numpy()


# -- the contiguous cache ops --------------------------------------------

def test_cache_write_rows_and_slot_are_the_reference_bit_for_bit():
    rng = np.random.RandomState(0)
    cache = _cache(rng)
    new = rng.randn(B, KV, 1, D).astype(np.float32)
    pos = np.array([3, 11, 0], np.int32)
    want = jtensor._internal_cache_write_rows(jnp.asarray(cache),
                                              jnp.asarray(new),
                                              jnp.asarray(pos))
    got = tensor.cache_write_rows(_t(cache), _t(new), _t(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    block = rng.randn(1, KV, 5, D).astype(np.float32)
    want = jtensor._internal_cache_write_slot(jnp.asarray(cache),
                                              jnp.asarray(block), 1, 4)
    got = tensor.cache_write_slot(_t(cache), _t(block), 1, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pos,vl", [([2, 9, 0], [4, 3, 0]),
                                    ([8, 10, 5], [4, 4, 1]),
                                    ([11, 0, 12], [1, 2, 0])],
                         ids=["mixed", "past-end", "edges"])
def test_cache_write_span_is_the_reference_bit_for_bit(pos, vl):
    """Lanes past valid_len, a dead row and positions past T_max write
    nothing (the reference drops them by scattering out of bounds)."""
    rng = np.random.RandomState(1)
    cache = _cache(rng)
    new = rng.randn(B, KV, 4, D).astype(np.float32)
    pos, vl = np.array(pos, np.int32), np.array(vl, np.int32)
    want = jtensor._internal_cache_write_span(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos),
        jnp.asarray(vl))
    got = tensor.cache_write_span(_t(cache), _t(new), _t(pos), _t(vl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q, s = _q8_cache(rng)
    jq, js = jtensor._internal_cache_write_span_q8(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(new), jnp.asarray(pos),
        jnp.asarray(vl))
    pq, ps = tensor.cache_write_span_q8(_t(q), _t(s), _t(new), _t(pos),
                                        _t(vl))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_q8_rows_and_slot_writes_are_the_reference_bit_for_bit():
    rng = np.random.RandomState(2)
    q, s = _q8_cache(rng)
    new = rng.randn(B, KV, 1, D).astype(np.float32) * 3
    pos = np.array([0, 7, 11], np.int32)
    jq, js = jtensor._internal_cache_write_rows_q8(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(new), jnp.asarray(pos))
    pq, ps = tensor.cache_write_rows_q8(_t(q), _t(s), _t(new), _t(pos))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    bq, bs = tensor._q8_quantize(_t(rng.randn(1, KV, 6, D).astype(
        np.float32)))
    jq, js = jtensor._internal_cache_write_slot_q8(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(bq.numpy()),
        jnp.asarray(bs.numpy()), 2, 3)
    pq, ps = tensor.cache_write_slot_q8(_t(q), _t(s), bq, bs, 2, 3)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("src,pos", [
    ([[0, 2, 3, -1], [0, 1, -1, -1], [-1, -1, -1, -1]], [3, 6, 0]),
    ([[0, 1, 3, -1], [0, 2, 3, -1], [0, 3, -1, -1]], [9, 8, 11])],
    ids=["inside", "past-end"])
def test_cache_permute_span_is_the_reference_bit_for_bit(src, pos):
    rng = np.random.RandomState(3)
    cache = _cache(rng)
    src, pos = np.array(src, np.int32), np.array(pos, np.int32)
    want = jtensor._internal_cache_permute_span(
        jnp.asarray(cache), jnp.asarray(pos), jnp.asarray(src))
    got = tensor.cache_permute_span(_t(cache), _t(pos), _t(src))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q, s = _q8_cache(rng)
    jq, js = jtensor._internal_cache_permute_span_q8(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(pos), jnp.asarray(src))
    pq, ps = tensor.cache_permute_span_q8(_t(q), _t(s), _t(pos), _t(src))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


# -- the model's slot forms -------------------------------------------------

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


def _caches(rng, dtype, n_layers=1, kv=2, d=8, tmax=24):
    """Per-layer caches of seeded content, (reference, port) forms."""
    jc, pc = [], []
    for _ in range(n_layers):
        jl, pl = [], []
        for _ in range(2):
            x = rng.randn(3, kv, tmax, d).astype(np.float32)
            if dtype == "int8":
                q, s = tensor._q8_quantize(_t(x))
                jl.append((nd.array(q.numpy(), dtype="int8"),
                           nd.array(s.numpy())))
                pl.append((q, s))
            else:
                jl.append(nd.array(x))
                pl.append(_t(x))
        jc.append(tuple(jl))
        pc.append(tuple(pl))
    return jc, pc


def _port_cache_np(pc):
    return [np.asarray(t) for pair in pc for leaf in pair
            for t in (leaf if isinstance(leaf, tuple) else (leaf,))]


def _ref_cache_np(jc):
    return [leaf_t.asnumpy() for pair in jc for leaf in pair
            for leaf_t in (leaf if isinstance(leaf, tuple) else (leaf,))]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_step_and_verify_slots_match_the_reference(models, dtype):
    """step_slots, verify_slots (a chain, then a tree) and the tree
    fix-up, one after another on the same caches: logits and caches
    within 1e-4 of the reference's (int8 payloads within one step)."""
    ref, port = models
    rng = np.random.RandomState(4)
    jc, pc = _caches(rng, dtype)
    tok = rng.randint(0, 20, (3, 1))
    pos = np.array([5, 11, 0], np.int32)
    jl, jc = ref.step_slots(nd.array(tok, dtype="int32"), jc,
                            nd.array(pos, dtype="int32"))
    pl = port.step_slots(_t(tok), pc, _t(pos))
    np.testing.assert_allclose(pl.numpy(), jl.asnumpy(), **TOL)
    win = rng.randint(0, 20, (3, 4))
    vl = np.array([4, 2, 0], np.int32)
    jl, jc = ref.verify_slots(nd.array(win, dtype="int32"), jc,
                              nd.array(pos + 1, dtype="int32"),
                              nd.array(vl, dtype="int32"))
    pl = port.verify_slots(_t(win), pc, _t(pos + 1), _t(vl))
    np.testing.assert_allclose(pl.numpy()[0], jl.asnumpy()[0], **TOL)
    np.testing.assert_allclose(pl.numpy()[1, :2], jl.asnumpy()[1, :2],
                               **TOL)
    parent = np.array([[0, 0, 0, 1], [0, 0, 1, 2], [0, 0, 1, 2]])
    depth, _, perm = _tree_paths(parent)
    tpos = pos + 5
    jl, jc = ref.verify_slots(nd.array(win, dtype="int32"), jc,
                              nd.array(tpos, dtype="int32"),
                              nd.array(vl, dtype="int32"),
                              tree=(nd.array(perm, dtype="int32"),
                                    nd.array(depth, dtype="int32")))
    pl = port.verify_slots(_t(win), pc, _t(tpos), _t(vl),
                           tree=(_t(perm), _t(depth)))
    np.testing.assert_allclose(pl.numpy()[0], jl.asnumpy()[0], **TOL)
    np.testing.assert_allclose(pl.numpy()[1, :2], jl.asnumpy()[1, :2],
                               **TOL)
    src = np.array([[0, 2, -1, -1], [0, 1, -1, -1], [-1] * 4], np.int32)
    jc = ref.permute_cache_span(jc, nd.array(tpos, dtype="int32"),
                                nd.array(src, dtype="int32"))
    port.permute_cache_span(pc, _t(tpos), _t(src))
    for a, b in zip(_port_cache_np(pc), _ref_cache_np(jc)):
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(a, b, **TOL)


def _clone(caches):
    return [tuple(tuple(t.clone() for t in leaf) if isinstance(leaf, tuple)
                  else leaf.clone() for leaf in pair) for pair in caches]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_verify_lane_is_the_step_at_its_position(models, dtype):
    """Lane w of a window equals step_slots at pos + w, and a tree lane
    the sequential steps along its root path, ``torch.equal``."""
    port = models[1]
    rng = np.random.RandomState(5)
    _, pa = _caches(rng, dtype)
    pb = _clone(pa)
    win = rng.randint(0, 20, (3, 4))
    pos = np.array([3, 9, 14], np.int32)
    vl = np.array([4, 4, 4], np.int32)
    got = port.verify_slots(_t(win), pa, _t(pos), _t(vl))
    for w in range(4):
        step = port.step_slots(_t(win[:, w:w + 1]), pb, _t(pos + w))
        assert torch.equal(got[:, w], step[:, 0]), w
    pc = _clone(pa)
    parent = np.array([[0, 0, 0, 2]] * 3)         # lanes 0 -> 2 -> 3
    depth, _, perm = _tree_paths(parent)
    got = port.verify_slots(_t(win), pa, _t(pos + 4), _t(vl),
                            tree=(_t(perm), _t(depth)))
    for d, lane in enumerate((0, 2, 3)):
        step = port.step_slots(_t(win[:, lane:lane + 1]), pc, _t(pos + 4 + d))
        assert torch.equal(got[:, lane], step[:, 0]), lane


# -- the engine ------------------------------------------------------------

def _prompts():
    rng = np.random.RandomState(0)
    return [(list(rng.randint(0, 20, t)), n)
            for t, n in ((6, 12), (4, 10), (5, 8), (24, 10))] + [
        (P_FORK, 16), (P_FORK2, 14), (P_FORK3, 12)]


def _jax_engine(ref, **kw):
    return JaxSlotEngine(ref, DeviceMesh(dp=1), transformer_lm_sharding_rules(),
                         num_slots=3, max_length=MAXLEN, **kw)


@pytest.mark.parametrize("spec", [dict(), dict(spec_k=3),
                                  dict(spec_tree=(6, 2)),
                                  dict(spec_k=3, spec_tree=(6, 2))],
                         ids=["plain", "linear", "tree", "mixed"])
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_greedy_streams_match_the_reference_engine_and_generate(
        models, spec, cache_dtype):
    ref, port = models
    je = _jax_engine(ref, cache_dtype=cache_dtype, **spec)
    pe = ContinuousBatchingEngine(port, device="cpu", num_slots=3,
                                  max_length=MAXLEN, cache_dtype=cache_dtype,
                                  **spec)
    jr, pr = [], []
    for j, (p, n) in enumerate(_prompts()):
        kw = {"spec_tree": False} if "spec_tree" in spec and j == 1 else {}
        jr.append(je.submit(nd.array(np.array([p]), dtype="int32"), n, **kw))
        pr.append(pe.submit(np.array([p], np.int32), n, **kw))
    jres, pres = je.run(), pe.run()
    for (p, n), a, b in zip(_prompts(), jr, pr):
        got = pres[b].numpy()
        np.testing.assert_array_equal(got, jres[a].asnumpy())
        want = port.generate(torch.tensor([p]), n, max_length=MAXLEN,
                             cache_dtype=cache_dtype).numpy()
        np.testing.assert_array_equal(got, want)
    js, ps = je.stats, pe.stats
    assert {k: ps[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    if spec:
        assert 0 < ps["accepted_tokens"] < ps["drafted_tokens"]


@pytest.mark.parametrize("spec", [dict(spec_k=3), dict(spec_tree=(6, 2))],
                         ids=["linear", "tree"])
def test_sampled_and_penalized_speculative_streams_equal_plain(models, spec):
    port = models[1]
    reqs = [(P_FORK, 16, dict(temperature=0.8, seed=7)),
            (P_FORK2, 14, dict(temperature=0.6, top_k=8, seed=9,
                               repetition_penalty=1.3)),
            (P_FORK3, 12, dict(repetition_penalty=1.4)),
            (P_FORK, 10, dict(eos_id=3))]

    def run(**kw):
        e = ContinuousBatchingEngine(port, device="cpu", num_slots=3,
                                     max_length=MAXLEN, **kw)
        ids = [e.submit(np.array([p], np.int32), n, **r) for p, n, r in reqs]
        res = e.run()
        return [res[i].numpy() for i in ids], e.stats

    plain, _ = run()
    got, st = run(**spec)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    assert st["accepted_tokens"] > 0
    for (p, n, r), a in zip(reqs[:3], plain):
        want = port.generate(torch.tensor([p]), n, max_length=MAXLEN,
                             **{k: v for k, v in r.items()}).numpy()
        np.testing.assert_array_equal(a, want)


def test_slot_engine_knobs(models):
    port = models[1]
    eng = ContinuousBatchingEngine(port, device="cpu", num_slots=2,
                                   max_length=16)
    with pytest.raises(ValueError, match="max_length"):
        eng.submit(np.zeros((1, 10), np.int32), 8)
    with pytest.raises(ValueError, match="ONE request"):
        eng.submit(np.zeros((2, 4), np.int32), 2)
    with pytest.raises(ValueError, match="session"):    # paged engine only
        eng.submit(np.zeros((1, 4), np.int32), 2, session="s")
    with pytest.raises(ValueError, match="self-drafting"):
        eng.submit(np.zeros((1, 4), np.int32), 2, spec_tree=(4, 2))
    r0 = eng.submit(np.array([P_FORK[:6]], np.int32), 0)
    r1 = eng.submit(np.array([P_FORK[:6]], np.int32), 1)
    res = eng.run()
    assert res[r0].shape == (1, 6) and res[r1].shape == (1, 7)
    assert eng.status(r1) == "ok" and eng.free_slots == 2
