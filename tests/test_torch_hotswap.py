"""Live weight hot-swap (``adopt`` / ``rollback``) and ``cancel`` of the
port's engines held against the JAX reference engines:
tests/test_serving_elastic.py's hot-swap scenarios on both engine kinds.

The checkpoint is the reference's: a second seeded net's parameters,
pickled as ``{"params": {name: array}, ...}`` under their instance-
prefixed names and written by the reference's ``write_verified``.  Both
engines (the reference's and the port's, on the same bridged weights)
run one schedule side by side — adopt with a stream in flight, the
install at the drained boundary, new admissions, rollback, a corrupt
file, the kill switch, an injected ``serving.adopt`` fault, cancels —
and after every iteration the streams must be token-identical, the page
tables, free list and refcounts equal, and the stats equal; the whole
lifecycle's trace is byte-equal too.  Every stream is also held to the
port's own ``generate`` of the generation it rode.
"""

import contextlib
import os
import pickle

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.contrib import quantization as jq
from mxtpu.models.transformer import llama_tiny as jax_llama_tiny, \
    transformer_lm_sharding_rules
from mxtpu.observability import tracing as jax_tracing
from mxtpu.parallel import ContinuousBatchingEngine as JaxSlotEngine
from mxtpu.parallel import PagedContinuousBatchingEngine as JaxPagedEngine
from mxtpu.parallel.decode import ShardedDecoder
from mxtpu.parallel.mesh import DeviceMesh
from mxtpu.resilience import fault_plan as jax_fault_plan
from mxtpu.resilience.checkpoint import \
    CorruptCheckpointError as JaxCorruptCheckpointError
from mxtpu.resilience.checkpoint import write_verified as jax_write_verified
from mxtpu_torch.contrib import quantization as q
from mxtpu_torch.models.convert import export_mxtpu_params, load_mxtpu_params
from mxtpu_torch.models.transformer import llama_tiny
from mxtpu_torch.observability import tracing
from mxtpu_torch.parallel.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)
from mxtpu_torch.resilience import (CorruptCheckpointError, fault_plan,
                                    write_verified)
from mxtpu_torch.resilience.counters import counters

VOCAB = 50
MAX_LEN = 32
KINDS = ["slot", "paged"]
#: stats both engines must agree on after every iteration
KEYS = ("steps", "generated_tokens", "param_generation", "adoptions",
        "adoption_failures", "rollbacks", "adoption_staged",
        "last_adoption_steps", "quarantined_requests", "retried_requests")
PAGED_KEYS = ("blocks_in_use", "blocks_free", "prefix_hit_requests",
              "pinned_blocks", "cow_copied_blocks")


@pytest.fixture(scope="module", autouse=True)
def _compile_ledger_left_as_found():
    """The JAX engines built here compile pool shapes into the
    process-wide compile ledger, which later tests in the same process
    read: leave it as this module found it."""
    import copy

    from mxtpu.analysis.compile_ledger import get_ledger

    led = get_ledger()
    with led._lock:
        saved = copy.deepcopy((led._sites, led._seen, led._seq))
    yield
    with led._lock:
        led._sites, led._seen, led._seq = saved


def _ref_net(seed):
    mx.random.seed(seed)
    net = jax_llama_tiny(vocab_size=VOCAB)
    net.initialize()
    net(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    return net


def _named(net):
    """{instance-prefixed reference name: numpy array}."""
    return {k: v.data().asnumpy() for k, v in net.collect_params().items()}


@pytest.fixture(scope="module")
def nets():
    """The reference's net_a (seed 7) and net_b (seed 13)."""
    return _ref_net(7), _ref_net(13)


def _port(named):
    return load_mxtpu_params(llama_tiny(vocab_size=VOCAB, device="cpu"),
                             named)


@pytest.fixture(scope="module")
def ckpt(nets, tmp_path_factory):
    """The guardian-shaped checkpoint of net_b, written by the reference
    (instance-prefixed names: adoption strips them)."""
    blob = pickle.dumps({"step": 42, "num_update": 1,
                         "params": _named(nets[1]), "opt_states": {},
                         "scale_state": None, "rng": None})
    path = str(tmp_path_factory.mktemp("hotswap") / "step42.ckpt")
    jax_write_verified(path, blob)
    return path


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randint(0, VOCAB, (1, t)), dtype=np.int32)
            for t in lengths]


def _want(named, prompt, n):
    """The port's generate on a fresh model holding ``named``."""
    return _port(named).generate(torch.from_numpy(prompt), n,
                                 max_length=MAX_LEN).numpy()


class Twin:
    """The reference's engine and the port's, one kind and configuration,
    on the same weights, driven in lockstep (both number requests from
    0)."""

    def __init__(self, kind, ref_net, port_model, **kw):
        kw = dict(dict(num_slots=2, max_length=MAX_LEN), **kw)
        self.kind = kind
        if kind == "paged":
            kw = dict(dict(block_size=8, prefill_chunk=8), **kw)
            self.j = JaxPagedEngine(ref_net, DeviceMesh(dp=1),
                                    transformer_lm_sharding_rules(), **kw)
            self.p = PagedContinuousBatchingEngine(port_model, device="cpu",
                                                   **kw)
        else:
            self.j = JaxSlotEngine(ref_net, DeviceMesh(dp=1),
                                   transformer_lm_sharding_rules(), **kw)
            self.p = ContinuousBatchingEngine(port_model, device="cpu", **kw)

    def both(self, fn):
        out = [fn(e) for e in (self.j, self.p)]
        return out

    def submit(self, prompt, n, **kw):
        rj = self.j.submit(nd.array(prompt, dtype="int32"), n, **kw)
        rp = self.p.submit(prompt, n, **kw)
        assert rj == rp
        return rp

    def check(self):
        sj, sp = self.j.stats, self.p.stats
        keys = KEYS + (PAGED_KEYS if self.kind == "paged" else ())
        assert {k: sp[k] for k in keys} == {k: sj[k] for k in keys}
        if self.kind == "paged":
            assert list(self.p._slot_pages) == list(self.j._slot_pages)
            assert list(self.p._bp._free) == list(self.j._bp._free)
            assert dict(self.p._bp._refs) == dict(self.j._bp._refs)

    def step(self):
        self.j.step()
        self.p.step()
        self.check()

    def status(self, rid):
        st = self.p.status(rid)
        assert self.j.status(rid) == st
        return st

    def drain(self, rid, bound=60):
        for _ in range(bound):
            if self.status(rid) not in ("queued", "active"):
                break
            self.step()
        return self.take(rid)

    def take(self, rid):
        a = self.j.take_result(rid).asnumpy()
        b = self.p.take_result(rid).numpy()
        np.testing.assert_array_equal(b, a)
        return b

    def adopt(self, path):
        gens = self.both(lambda e: e.adopt(path))
        assert gens[0] == gens[1]
        self.check()
        return gens[1]

    def rollback(self):
        gens = self.both(lambda e: e.rollback())
        assert gens[0] == gens[1]
        return gens[1]


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


@pytest.mark.parametrize("kind", KINDS)
def test_hot_swap_lifecycle_equals_reference(nets, ckpt, kind, tmp_path):
    """tests/test_serving_elastic.py's lifecycle on both engines in both
    frameworks: the stream in flight at adopt() finishes on A, new
    admissions ride B, rollback returns to A, a corrupt checkpoint raises
    typed and changes nothing, the kill switch refuses; the whole trace
    is byte-equal to the reference's."""
    net_a, net_b = nets
    a, b = _named(net_a), _named(net_b)
    extra = dict(pin_bytes="1MiB") if kind == "paged" else {}
    tw = Twin(kind, net_a, _port(a), ledger_tag="hs", **extra)
    prompt = _prompts(6, [4])[0]
    ref_old, ref_new = _want(a, prompt, 6), _want(b, prompt, 6)
    before = counters()
    with jax_tracing() as jtr, tracing() as ptr:
        # adopt with a stream in flight: it stays on A, the install waits
        r_old = tw.submit(prompt, 6)
        tw.step()
        assert tw.adopt(ckpt) == 1
        assert tw.p.stats["adoption_staged"] == 1
        # a request submitted while staged waits for the install
        r_wait = tw.submit(prompt, 6)
        np.testing.assert_array_equal(tw.drain(r_old), ref_old)
        assert tw.status(r_wait) == "queued"
        tw.step()                   # the drained boundary: B installs
        st = tw.p.stats
        assert st["param_generation"] == 1 and st["adoptions"] == 1
        assert st["last_adoption_steps"] >= 1 and st["adoption_staged"] == 0
        if kind == "paged":
            assert st["pinned_blocks"] == 0    # A's chains were dropped
        np.testing.assert_array_equal(tw.drain(r_wait), ref_new)
        np.testing.assert_array_equal(tw.drain(tw.submit(prompt, 6)),
                                      ref_new)
        # rollback stages A again
        assert tw.rollback() == 2
        tw.step()
        assert tw.p.stats["param_generation"] == 2
        assert tw.p.stats["rollbacks"] == 1
        np.testing.assert_array_equal(tw.drain(tw.submit(prompt, 6)),
                                      ref_old)
        # a corrupt checkpoint raises typed and changes nothing
        bad = str(tmp_path / "bad.ckpt")
        write_verified(bad, open(ckpt, "rb").read())
        with open(bad, "r+b") as f:
            f.seek(10)
            f.write(b"\xff\xff\xff")
        with pytest.raises(JaxCorruptCheckpointError):
            tw.j.adopt(bad)
        with pytest.raises(CorruptCheckpointError):
            tw.p.adopt(bad)
        tw.check()
        assert tw.p.stats["adoption_failures"] == 1
        assert tw.p.stats["param_generation"] == 2
        np.testing.assert_array_equal(tw.drain(tw.submit(prompt, 6)),
                                      ref_old)
        # the kill switch refuses adoption outright
        with _env("MXTPU_HOTSWAP", "0"):
            for e in (tw.j, tw.p):
                with pytest.raises(RuntimeError, match="MXTPU_HOTSWAP"):
                    e.adopt(ckpt)
        assert jtr.to_json() == ptr.to_json()
        stages = [e.fields.get("stage") for e in ptr.events()
                  if e.etype == "serving.adopt"]
        assert stages == ["staged", "installed", "staged", "installed",
                          "failed"]
    after = counters()
    assert {k: after[k] - before[k] for k in
            ("adoptions", "adoption_failures", "adoption_rollbacks")} == \
        {"adoptions": 2, "adoption_failures": 1, "adoption_rollbacks": 1}


@pytest.mark.parametrize("kind", KINDS)
def test_adopt_fault_and_refusals_keep_the_generation(nets, ckpt, kind,
                                                      tmp_path):
    """An injected ``serving.adopt`` fault, a rollback before any
    install, a checkpoint of another architecture and a payload that is
    not a params mapping: each refused as the reference refuses it, the
    engine serving its generation bit for bit."""
    net_a, _ = nets
    a = _named(net_a)
    tw = Twin(kind, net_a, _port(a))
    with jax_fault_plan("serving.adopt@1:raise=RuntimeError(torn read)"), \
            fault_plan("serving.adopt@1:raise=RuntimeError(torn read)"):
        for e in (tw.j, tw.p):
            with pytest.raises(RuntimeError, match="torn read"):
                e.adopt(ckpt)
    for e in (tw.j, tw.p):
        with pytest.raises(RuntimeError, match="no previous"):
            e.rollback()
    wrong = str(tmp_path / "wrong.ckpt")
    named = {k: v for k, v in _named(nets[1]).items()
             if not k.endswith("lm_head_weight")}
    write_verified(wrong, pickle.dumps({"params": named}))
    notmap = str(tmp_path / "notmap.ckpt")
    write_verified(notmap, pickle.dumps([1, 2, 3]))
    for path, (jexc, pexc) in ((wrong, (ValueError, ValueError)),
                               (notmap, (JaxCorruptCheckpointError,
                                         CorruptCheckpointError))):
        with pytest.raises(jexc):
            tw.j.adopt(path)
        with pytest.raises(pexc):
            tw.p.adopt(path)
    tw.check()
    assert tw.p.stats["adoption_failures"] == 3
    assert tw.p.stats["param_generation"] == 0
    prompt = _prompts(4, [4])[0]
    np.testing.assert_array_equal(tw.drain(tw.submit(prompt, 5)),
                                  _want(a, prompt, 5))


@pytest.mark.parametrize("kind", KINDS)
def test_cancel_queued_and_active_equals_reference(nets, kind):
    """A queued request cancels with its prompt alone, an active one with
    its partial output through the scrub path (the paged engine's pages
    come back); the other streams equal their uncancelled runs; unknown
    and terminal rids answer False; every step equal to the reference."""
    net_a, _ = nets
    a = _named(net_a)
    tw = Twin(kind, net_a, _port(a))
    p0, p1, p2, p3 = _prompts(9, [5, 11, 7, 9])
    in_use = tw.p.stats.get("blocks_in_use")
    with jax_tracing() as jtr, tracing() as ptr:
        r0, r1, r2 = tw.submit(p0, 8), tw.submit(p1, 8), tw.submit(p2, 8)
        tw.step()
        tw.step()
        assert tw.both(lambda e: e.cancel(r2)) == [True, True]  # queued
        assert tw.status(r2) == "cancelled"
        np.testing.assert_array_equal(tw.take(r2), p2)
        assert tw.both(lambda e: e.cancel(r0)) == [True, True]  # active
        tw.check()
        assert tw.status(r0) == "cancelled"
        part = tw.take(r0)
        assert p0.shape[1] < part.shape[1] < p0.shape[1] + 8
        np.testing.assert_array_equal(
            part, _want(a, p0, 8)[:, :part.shape[1]])
        r3 = tw.submit(p3, 6)       # takes the freed row
        np.testing.assert_array_equal(tw.drain(r1), _want(a, p1, 8))
        np.testing.assert_array_equal(tw.drain(r3), _want(a, p3, 6))
        assert tw.both(lambda e: e.cancel(r1)) == [False, False]
        assert tw.both(lambda e: e.cancel(99)) == [False, False]
        assert jtr.to_json() == ptr.to_json()
    assert [e.rid for e in ptr.events() if e.etype == "engine.cancel"] == \
        ["eng:%d" % r2, "eng:%d" % r0]
    if kind == "paged":
        assert tw.p.stats["blocks_in_use"] == in_use == 0


def test_cancel_while_prefilling_returns_pages(nets):
    """A paged request cancelled between its prefill chunks releases the
    pages it was allocated; its output is its prompt."""
    net_a, _ = nets
    tw = Twin("paged", net_a, _port(_named(net_a)))
    long_prompt = _prompts(11, [21])[0]
    rid = tw.submit(long_prompt, 4)
    tw.step()                       # the first of three chunks
    assert tw.p.stats["blocks_in_use"] > 0
    assert tw.both(lambda e: e.cancel(rid)) == [True, True]
    tw.check()
    assert tw.p.stats["blocks_in_use"] == 0
    np.testing.assert_array_equal(tw.take(rid), long_prompt)


def test_prepare_adoption_names_and_refusals(nets):
    """The model's hooks: exact names first, the instance prefix
    stripped, extra names ignored (unlike ``load_mxtpu_params``), an
    ambiguous stripped name refused like a missing one, a wrong shape
    refused; ``install_leaves`` changes what every later call reads and
    keeps the head tied to a tied embedding."""
    net_a, net_b = nets
    model = _port(_named(net_a))
    b = _named(net_b)
    stripped = export_mxtpu_params(_port(b))
    leaves = model.prepare_adoption(dict(stripped, extra_weight=np.ones(3)))
    for named in (b, stripped):
        got = model.prepare_adoption(named)
        assert all(torch.equal(x, y) for x, y in zip(got, leaves))
    ambiguous = dict(b)
    key = next(k for k in b if k.endswith("embed_weight"))
    ambiguous["othernet3_embed_weight"] = b[key]
    del ambiguous[key]
    ambiguous["transformerlm9_embed_weight"] = b[key]
    with pytest.raises(ValueError, match="missing parameter"):
        model.prepare_adoption(ambiguous)
    bad = dict(stripped, norm_weight=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        model.prepare_adoption(bad)
    ids = torch.tensor([[1, 2, 3, 4]])
    old = model._live_param_leaves()
    model.install_leaves(leaves)
    assert torch.equal(model(ids), _port(b)(ids))
    model.install_leaves(old)
    assert torch.equal(model(ids), _port(_named(net_a))(ids))
    tied = llama_tiny(vocab_size=VOCAB, device="cpu")
    tied.tie_weights, tied.lm_head = True, None
    names = [n for n, _ in tied._adoption_params()]
    assert "lm_head_weight" not in names
    fresh = tied.prepare_adoption({k: v for k, v in stripped.items()
                                   if k != "lm_head_weight"})
    tied.install_leaves(fresh)
    assert tied._logits(torch.zeros(1, 1, 64)).shape[-1] == VOCAB
    assert tied.embed.weight.data_ptr() == fresh[names.index(
        "embed_weight")].data_ptr()


def test_int8_model_adopts_as_the_reference(nets, tmp_path):
    """A weight-quantized (int8) model: a float checkpoint is refused
    with the reference's error type (its ``wscale`` entries are
    missing); a checkpoint of a quantized net adopts, and the streams
    ride its payloads and scales."""
    ref_q = _ref_net(7)
    jq.quantize_weights(ref_q, bits=8)
    ref_qb = _ref_net(13)
    jq.quantize_weights(ref_qb, bits=8)
    port_q = llama_tiny(vocab_size=VOCAB, device="cpu")
    q.quantize_weights(port_q, bits=8)
    load_mxtpu_params(port_q, _named(ref_q))
    dec = ShardedDecoder(ref_q, DeviceMesh(dp=1),
                         transformer_lm_sharding_rules())
    with pytest.raises(ValueError):
        dec.prepare_adoption(_named(nets[1]))
    with pytest.raises(ValueError):
        port_q.prepare_adoption(_named(nets[1]))
    dec.prepare_adoption(_named(ref_qb))
    path = str(tmp_path / "q.ckpt")
    write_verified(path, pickle.dumps({"params": _named(ref_qb)}))
    eng = PagedContinuousBatchingEngine(port_q, device="cpu", num_slots=2,
                                        max_length=MAX_LEN, block_size=8,
                                        prefill_chunk=8)
    eng.adopt(path)
    prompt = _prompts(6, [4])[0]
    rid = eng.submit(prompt, 6)
    out = eng.run()[rid].numpy()
    want = llama_tiny(vocab_size=VOCAB, device="cpu")
    q.quantize_weights(want, bits=8)
    load_mxtpu_params(want, _named(ref_qb))
    np.testing.assert_array_equal(
        out, want.generate(torch.from_numpy(prompt), 6,
                           max_length=MAX_LEN).numpy())
    assert port_q.layers[0].attn.qkv.weight.dtype == torch.int8


def test_adopt_reads_a_port_written_checkpoint(nets, tmp_path):
    """The port's own writer: ``export_mxtpu_params`` → pickle →
    ``write_verified`` (the card phase's path).  Its names are the
    prefix-stripped ones, the port's parameter names, so they match
    exactly; the reference's decoder, whose names all carry an instance
    prefix, strips ``layer0_`` off them and refuses the file, while the
    same arrays under a prefix adopt in both."""
    net_a, net_b = nets
    exported = export_mxtpu_params(_port(_named(net_b)))
    path = str(tmp_path / "b.ckpt")
    write_verified(path, pickle.dumps({"params": exported}))
    eng = PagedContinuousBatchingEngine(_port(_named(net_a)), device="cpu",
                                        num_slots=2, max_length=MAX_LEN,
                                        block_size=8, prefill_chunk=8)
    assert eng.adopt(path) == 1
    prompt = _prompts(8, [6])[0]
    rid = eng.submit(prompt, 5)
    np.testing.assert_array_equal(eng.run()[rid].numpy(),
                                  _want(_named(net_b), prompt, 5))
    dec = ShardedDecoder(net_a, DeviceMesh(dp=1),
                         transformer_lm_sharding_rules())
    with pytest.raises(ValueError, match="missing parameter"):
        dec.prepare_adoption(exported)
    prefixed = str(tmp_path / "prefixed.ckpt")
    write_verified(prefixed, pickle.dumps(
        {"params": {"transformerlm5_" + k: v for k, v in exported.items()}}))
    tw = Twin("paged", net_a, _port(_named(net_a)))
    tw.adopt(prefixed)
    np.testing.assert_array_equal(tw.drain(tw.submit(prompt, 5)),
                                  _want(_named(net_b), prompt, 5))


# ------------------------------------------------- the card phase's helpers

def test_chip_smoke_hotswap_run_on_the_cpu(tmp_path):
    """Phase 6e(b)'s schedule (``chip_smoke.hotswap_run``) on two seeded
    llama_tiny generations on the CPU: streams in flight at adopt() stay
    on A, later ones ride B, rollback returns to A, the corrupt copy is
    refused, the cancelled stream is a prefix of A's and its pages come
    back; the record carries every number the card phase logs."""
    import chip_smoke

    gens = []
    for seed in (0, 1):
        m = llama_tiny(vocab_size=VOCAB, device="cpu")
        chip_smoke.init_weights(m, torch.Generator().manual_seed(seed), 0.2)
        gens.append(m)
    named = export_mxtpu_params(gens[1])
    fresh_b = load_mxtpu_params(llama_tiny(vocab_size=VOCAB, device="cpu"),
                                named)
    path = str(tmp_path / "generation-b.ckpt")
    assert chip_smoke.write_generation(named, path) == os.path.getsize(path)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, VOCAB, (1, t)), kw) for t, kw in (
        (9, {}), (4, dict(temperature=0.8, seed=11)), (17, {}), (6, {}),
        (12, {}), (5, dict(temperature=0.7, top_p=0.9, seed=2)))]
    cfg = dict(num_slots=4, max_length=48, block_size=8, prefill_chunk=8,
               device="cpu")
    rec, problems = chip_smoke.hotswap_run(gens[0], fresh_b, path, reqs,
                                           cfg, 8, split=4)
    assert problems == []
    p = torch.from_numpy(reqs[0][0])          # the generations differ
    assert not torch.equal(gens[0].generate(p, 8), fresh_b.generate(p, 8))
    assert rec["stage_to_install_steps"] >= 1
    assert rec["placed_bytes"] == sum(p.numel() * 4
                                      for p in gens[0].parameters())
    assert rec["blocks_in_use"] == rec["blocks_in_use_before"] == 0
    assert 1 <= rec["cancelled_tokens"] < 8
    for key in ("adopt_ms", "install_ms", "place_ms", "place_gb_per_s",
                "read_verify_ms", "read_verify_unpickle_ms"):
        assert rec[key] > 0, key
    assert sorted(os.listdir(str(tmp_path))) == ["generation-b.ckpt",
                                                 "generation-b.ckpt.mxmf"]


def test_chip_smoke_timelines_and_corrupt_copy(tmp_path):
    """``timeline_problems`` passes admit-to-finish timelines and names
    a request whose timeline is missing; ``corrupt_copy`` flips bytes of
    a copy that then fails verification, the original intact."""
    import chip_smoke
    from mxtpu_torch.resilience import verify

    eng = PagedContinuousBatchingEngine(_port(_named(_ref_net(7))),
                                        device="cpu", num_slots=2,
                                        max_length=MAX_LEN, block_size=8,
                                        prefill_chunk=8)
    with tracing() as tr:
        rids = [eng.submit(p, 4) for p in _prompts(2, [5, 12, 3])]
        eng.run()
        assert chip_smoke.timeline_problems(tr, rids) == []
        assert len(chip_smoke.timeline_problems(tr, rids + [7])) == 1
    src = str(tmp_path / "a.ckpt")
    write_verified(src, bytes(range(64)))
    chip_smoke.corrupt_copy(src, src + ".bad", at=10, n=3)
    with pytest.raises(CorruptCheckpointError):
        verify(src + ".bad", required=True)
    assert verify(src, required=True)["size"] == 64
    bad = open(src + ".bad", "rb").read()
    assert [i for i in range(64) if bad[i] != i] == [10, 11, 12]
