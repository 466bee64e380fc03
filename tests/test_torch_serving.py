"""The port's PagedContinuousBatchingEngine held against the JAX
reference engine on the same weights (the weight bridge), replaying the
reference's own paged-serving scenarios (tests/test_serving_paged.py:
join/evict, and prefix sharing with copy-on-write at the divergence):
greedy streams must be token-identical, the page ids of every slot
identical at the copy-on-write point, and every page back in the pool
after the run.

Inside the port, seeded sampled and penalized engine streams must equal
the port's isolated ``generate`` with the same seed, token for token
(sampled streams cannot match across frameworks: JAX draws with
threefry, the port with torch.Generator)."""

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.models.transformer import llama_tiny as jax_llama_tiny, \
    transformer_lm_sharding_rules
from mxtpu.parallel import PagedContinuousBatchingEngine as JaxEngine, \
    make_mesh
from mxtpu_torch import base
from mxtpu_torch.base import LoadShedError, MXTPUError
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import llama_tiny
from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

MAXLEN = 32
BS = 8
ENGINE = dict(num_slots=2, max_length=MAXLEN, block_size=BS,
              prefill_chunk=8)


@pytest.fixture(scope="module")
def models():
    mx.random.seed(77)
    ref = jax_llama_tiny(vocab_size=50)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    port = llama_tiny(vocab_size=50, device="cpu")
    load_mxtpu_params(port, {k: v.data().asnumpy()
                             for k, v in ref.collect_params().items()})
    return ref, port


@pytest.fixture(scope="module")
def jax_eng(models):
    return JaxEngine(models[0], make_mesh(dp=1, tp=2),
                     transformer_lm_sharding_rules(), **ENGINE)


@pytest.fixture
def eng(models):
    return PagedContinuousBatchingEngine(models[1], device="cpu", **ENGINE)


def _prompts(rng, lengths):
    return [rng.randint(0, 50, (1, t)).astype(np.int32) for t in lengths]


def _row_of(engine, rid):
    for i, s in enumerate(engine._slots):
        if s is not None and s.req.rid == rid:
            return i
    raise AssertionError("rid %d holds no slot" % rid)


def test_join_evict_greedy_streams_match_reference(jax_eng, eng):
    """More requests than slots, mixed lengths, one prompt prefilled in
    two chunks (tests/test_serving_paged.py:119)."""
    rng = np.random.RandomState(3)
    prompts = _prompts(rng, (3, 5, 12, 7))
    news = [6, 3, 5, 2]
    jrids = [jax_eng.submit(nd.array(p, dtype="int32"), n)
             for p, n in zip(prompts, news)]
    rids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    base.reset_counts()
    jres, res = jax_eng.run(), eng.run()
    for jr, r in zip(jrids, rids):
        np.testing.assert_array_equal(res[r].numpy(), jres[jr].asnumpy())
    st = eng.stats
    assert st["blocks_in_use"] == 0 and jax_eng.stats["blocks_in_use"] == 0
    assert st["blocks_free"] == st["num_blocks"]
    assert st["steps"] == jax_eng.stats["steps"]
    # every decode step and every prefill chunk went through the wrappers
    assert base.count("paged_attention") == 2 * st["steps"]
    assert base.count("paged_prefill") == 2 * st["prefill_chunks"]


def test_prefix_sharing_cow_pages_and_streams_match_reference(jax_eng, eng):
    """B shares A's 13-token prefix: one full page shared, the
    divergence page cloned copy-on-write
    (tests/test_serving_paged.py:137)."""
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 50, (1, 13))
    pa = np.concatenate([shared, rng.randint(0, 50, (1, 3))], 1)
    pb = np.concatenate([shared, rng.randint(0, 50, (1, 5))], 1)
    pa, pb = pa.astype(np.int32), pb.astype(np.int32)
    rids = {}
    for e, wrap in ((jax_eng, lambda p: nd.array(p, dtype="int32")),
                    (eng, lambda p: p)):
        ra = e.submit(wrap(pa), 6)
        e.step()                        # admit + chunk [0:8)
        e.step()                        # chunk [8:16) -> registered
        rb = e.submit(wrap(pb), 5)
        e.step()                        # B admits: shares A's first page
        rids[e] = (ra, rb)
    ja, jb = rids[jax_eng]
    ra, rb = rids[eng]
    pages = [eng._slot_pages[_row_of(eng, r)] for r in (ra, rb)]
    jpages = [jax_eng._slot_pages[_row_of(jax_eng, r)] for r in (ja, jb)]
    assert pages == jpages
    assert pages[1][0] == pages[0][0] and pages[1][1] != pages[0][1]
    st = eng.stats
    assert st["blocks_shared"] == 1
    assert st["prefix_hit_requests"] == 1 and st["cow_copied_blocks"] == 1
    for e in (jax_eng, eng):
        while e.pending or e.active:
            e.step()
    np.testing.assert_array_equal(eng.take_result(ra).numpy(),
                                  jax_eng.take_result(ja).asnumpy())
    np.testing.assert_array_equal(eng.take_result(rb).numpy(),
                                  jax_eng.take_result(jb).asnumpy())
    assert eng.stats["blocks_in_use"] == 0


def test_sampled_and_penalized_streams_equal_isolated_generate(models, eng):
    """Seeded sampled requests (per-request generators) and a penalized
    one share a prompt prefix and the pool; each stream equals the
    port's isolated generate with the same knobs."""
    port = models[1]
    rng = np.random.RandomState(11)
    shared = rng.randint(0, 50, (1, 10))
    pa = np.concatenate([shared, rng.randint(0, 50, (1, 2))], 1)
    pb = np.concatenate([shared, rng.randint(0, 50, (1, 4))], 1)
    pa, pb = pa.astype(np.int32), pb.astype(np.int32)
    knobs = [(pa, 5, dict(temperature=0.8, top_k=20, top_p=0.9, seed=101)),
             (pb, 4, dict(temperature=0.7, seed=202)),
             (pa, 5, dict(repetition_penalty=1.3))]
    ra = eng.submit(pa, 5, **knobs[0][2])
    eng.step()
    eng.step()
    rb = eng.submit(pb, 4, **knobs[1][2])
    rc = eng.submit(pa, 5, **knobs[2][2])
    res = eng.run()
    for rid, (p, n, kw) in zip((ra, rb, rc), knobs):
        want = port.generate(torch.from_numpy(p), n, max_length=MAXLEN,
                             **kw).numpy()
        np.testing.assert_array_equal(res[rid].numpy(), want)
    assert eng.stats["prefix_hit_requests"] >= 1
    assert eng.stats["blocks_in_use"] == 0


def test_sampled_stream_depends_on_its_seed_only(models):
    """A seeded stream is the same whether it decodes alone or beside
    another sampled request."""
    port = models[1]
    p = np.array([[5, 9, 2, 7]], np.int32)
    alone = PagedContinuousBatchingEngine(port, device="cpu", **ENGINE)
    r = alone.submit(p, 8, temperature=1.0, seed=5)
    want = alone.run()[r].numpy()
    mixed = PagedContinuousBatchingEngine(port, device="cpu", **ENGINE)
    mixed.submit(np.array([[1, 2, 3]], np.int32), 8, temperature=1.0,
                 seed=6)
    r = mixed.submit(p, 8, temperature=1.0, seed=5)
    np.testing.assert_array_equal(mixed.run()[r].numpy(), want)


def test_pool_exhaustion_sheds_impossible_and_defers_transient(models):
    port = models[1]
    small = PagedContinuousBatchingEngine(port, device="cpu", num_blocks=3,
                                          **ENGINE)
    rng = np.random.RandomState(29)
    with pytest.raises(LoadShedError, match="can never be admitted"):
        small.submit(_prompts(rng, (10,))[0], 15)     # needs 4 pages > 3
    assert small.stats["shed_requests"] == 1 and small.pending == 0
    p1, p2 = _prompts(rng, (6, 7))
    r1 = small.submit(p1, 10)                         # 2 pages
    r2 = small.submit(p2, 9)                          # waits for r1
    small.step()
    assert small.active == 1 and small.pending == 1   # deferred, FIFO kept
    res = small.run()
    for r, p, n in ((r1, p1, 10), (r2, p2, 9)):
        assert small.status(r) == "ok"
        np.testing.assert_array_equal(
            res[r].numpy(), port.generate(torch.from_numpy(p), n).numpy())
    assert small.stats["blocks_in_use"] == 0


def test_request_edge_cases(models, eng):
    p = np.array([[4, 8, 15, 16]], np.int32)
    r0 = eng.submit(p, 0)                   # nothing to generate
    r1 = eng.submit(p, 1)                   # finishes at admission
    res = eng.run()
    np.testing.assert_array_equal(res[r0].numpy(), p)
    assert tuple(res[r1].shape) == (1, 5)
    with pytest.raises(ValueError):         # does not fit max_length
        eng.submit(p, MAXLEN)
    with pytest.raises(ValueError):         # one request at a time
        eng.submit(np.zeros((2, 3), np.int32), 2)
    # the fault contract's knobs and sessions are honoured: a request
    # that meets no fault or deadline streams as it would without them
    for knob in (dict(deadline_s=600.0), dict(retries=1), dict(session="s")):
        r = eng.submit(p, 2, **knob)
        np.testing.assert_array_equal(
            eng.run()[r].numpy(),
            models[1].generate(torch.from_numpy(p), 2).numpy())
        assert eng.status(r) == "ok"
    assert eng.stats["sessions_open"] == 1 and eng.stats["pinned_blocks"] == 0
    eng.close_session("s")
    assert eng.stats["sessions_open"] == 0
    # the speculative knobs follow the reference: speculative= is a
    # request's opt-in/out of the engine's speculation (none here, so the
    # stream is the plain one); a tree config needs a speculating engine
    with pytest.raises(ValueError, match="spec_tree"):
        eng.submit(p, 2, spec_tree=(4, 2))
    r = eng.submit(p, 3, speculative=True)
    np.testing.assert_array_equal(
        eng.run()[r].numpy(),
        models[1].generate(torch.from_numpy(p), 3).numpy())
    eos = int(models[1].generate(torch.from_numpy(p), 3)[0, -1])
    r = eng.submit(p, 3, eos_id=eos)
    out = eng.run()[r].numpy()
    assert out[0, -1] == eos and out.shape[1] <= 7


def test_engine_needs_a_device_where_there_is_no_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(MXTPUError, match="device='cpu'"):
        PagedContinuousBatchingEngine(models[1], **ENGINE)
    with pytest.raises(MXTPUError, match="model is on"):
        PagedContinuousBatchingEngine(models[1], device="meta", **ENGINE)


@pytest.mark.parametrize("framework", ["port", "reference"])
def test_terminal_status_records_are_bounded_by_history(models, framework):
    """Both engines keep the status of only the last max(history,
    2 * num_slots) terminal requests: with one slot and history=2, after
    three completions the first rid is ``unknown`` and the last two
    ``ok``."""
    ref, port = models
    kw = dict(ENGINE, num_slots=1, history=2)
    if framework == "port":
        e = PagedContinuousBatchingEngine(port, device="cpu", **kw)
        wrap = lambda p: p                                  # noqa: E731
    else:
        e = JaxEngine(ref, make_mesh(dp=1, tp=2),
                      transformer_lm_sharding_rules(), **kw)
        wrap = lambda p: nd.array(p, dtype="int32")         # noqa: E731
    rids = [e.submit(wrap(np.array([[4, 8, 15, t]], np.int32)), 2)
            for t in range(3)]
    assert [e.status(r) for r in rids] == ["queued"] * 3
    e.run()
    assert [e.status(r) for r in rids] == ["unknown", "ok", "ok"]
