"""The port's replica service layer (``mxtpu_torch.serving``: gateway,
router, supervisor, in-process transport) held against the JAX
reference's ``mxtpu.serving``, side by side.

Every scenario of tests/test_serving_router.py that is not marked slow
runs twice: once on the reference's ``Gateway`` over three reference
paged engines sharing one seeded ``llama_tiny``, once on the port's
``Gateway`` over three port engines sharing that net's bridged weights,
with the same prompts, knobs and fault plans.  The streams, statuses,
the gateway's stats (the supervisor's and the router's inside them) and
every replica's page counts must be equal, and every completed stream
must equal the reference's isolated ``ShardedDecoder.generate``.
Sampled streams are the exception: the two frameworks draw from
different generators (JAX's PRNG, ``torch.Generator``), so a sampled
stream of the port is held to the port's own ``generate`` with the same
seed, and everything else about its request (status, counts, timing in
ticks) to the reference.  One scenario with a replica death, a hedge and
a QoS shed also holds the trace and the flight recorder's JSON byte for
byte.

Both sides' engines are module-scoped and every scenario runs on both in
the same order, so their prefix caches stay equal from test to test.
"""

import copy
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu.resilience as jax_resilience
import mxtpu.serving as jax_serving
from mxtpu import nd
from mxtpu.models.transformer import llama_tiny as jax_llama_tiny
from mxtpu.models.transformer import transformer_lm_sharding_rules
from mxtpu.observability import flight_recording as jax_flight_recording
from mxtpu.observability import get_tracer as jax_get_tracer
from mxtpu.observability import tracing as jax_tracing
from mxtpu.parallel import ContinuousBatchingEngine as JaxSlotEngine
from mxtpu.parallel import PagedContinuousBatchingEngine as JaxPagedEngine
from mxtpu.parallel import ShardedDecoder, make_mesh
from mxtpu_torch import resilience as port_resilience
from mxtpu_torch import serving as port_serving
from mxtpu_torch.base import MXTPUError
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import llama_tiny
from mxtpu_torch.observability import flight_recording, get_tracer, tracing
from mxtpu_torch.parallel.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)
from mxtpu_torch.serving import InProcessReplica, ReplicaSupervisor

VOCAB = 50
MAXLEN = 32
ENGINE = dict(num_slots=2, max_length=MAXLEN, block_size=8, prefill_chunk=8,
              pin_bytes="1MiB")
#: engine stats both frameworks report (the reference's compile count and
#: the port's chunk counters are their own)
PAGE_KEYS = ("steps", "generated_tokens", "blocks_in_use", "blocks_free",
             "pinned_blocks", "prefix_hit_requests", "prefill_tokens_avoided",
             "cow_copied_blocks", "quarantined_requests", "retried_requests",
             "sessions_open", "swapped_out_blocks", "swapped_in_blocks",
             "deferred_swap_in_requests", "shed_requests")


@pytest.fixture(scope="module", autouse=True)
def _compile_ledger_left_as_found():
    """The reference engines compile into the process-wide compile
    ledger, which the reference's own serving tests read per replica
    tag: leave it as this module found it."""
    from mxtpu.analysis.compile_ledger import get_ledger

    led = get_ledger()
    with led._lock:
        saved = copy.deepcopy((led._sites, led._seen, led._seq))
    yield
    with led._lock:
        led._sites, led._seen, led._seq = saved


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module: its engines run thousands of
    tiny ops, which more threads only slow, and which stall for whole
    scheduler quanta when other processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_tracers():
    """Both tracers keep their events after ``tracing()`` exits: scrub
    them so later tests see the off-by-default state."""
    yield
    get_tracer().reset()
    jax_get_tracer().reset()


def ref_net(seed):
    mx.random.seed(seed)
    net = jax_llama_tiny(vocab_size=VOCAB)
    net.initialize()
    net(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    return net


def named(net):
    """{instance-prefixed reference name: numpy array}."""
    return {k: v.data().asnumpy() for k, v in net.collect_params().items()}


def port_model(net):
    return load_mxtpu_params(llama_tiny(vocab_size=VOCAB, device="cpu"),
                             named(net))


def ref_side(net, engines=None, **extra):
    """The reference's half: its serving package, plan and tracer, and
    its prompts as NDArrays."""
    return SimpleNamespace(
        name="ref", pkg="mxtpu", serving=jax_serving, res=jax_resilience,
        net=net, engines=engines, plan=jax_resilience.fault_plan,
        tracing=jax_tracing, flight=jax_flight_recording,
        arr=lambda p: nd.array(np.asarray(p), dtype="int32"),
        np=lambda r: np.asarray(r.asnumpy()),
        paged=lambda m, **kw: JaxPagedEngine(
            m, make_mesh(dp=1), transformer_lm_sharding_rules(), **kw),
        slot=lambda m, **kw: JaxSlotEngine(
            m, make_mesh(dp=1), transformer_lm_sharding_rules(), **kw),
        **extra)


def port_side(model, engines=None, **extra):
    """The port's half, its prompts as CPU tensors."""
    return SimpleNamespace(
        name="port", pkg="mxtpu_torch", serving=port_serving,
        res=port_resilience, net=model, engines=engines,
        plan=port_resilience.fault_plan, tracing=tracing,
        flight=flight_recording,
        arr=lambda p: torch.from_numpy(np.asarray(p, np.int32)),
        np=lambda r: r.numpy(),
        paged=lambda m, **kw: PagedContinuousBatchingEngine(
            m, device="cpu", **kw),
        slot=lambda m, **kw: ContinuousBatchingEngine(m, device="cpu", **kw),
        **extra)


@pytest.fixture(scope="module")
def sides():
    """The reference's net (seed 77) and three paged engines over it
    (ledger tags r0..r2), the port's bridged model and its three, and the
    reference's isolated decoder."""
    net = ref_net(77)
    model = port_model(net)
    ref = ref_side(net, [ref_side(net).paged(net, ledger_tag="r%d" % i,
                                             **ENGINE) for i in range(3)])
    port = port_side(model, [PagedContinuousBatchingEngine(
        model, device="cpu", ledger_tag="r%d" % i, **ENGINE)
        for i in range(3)])
    isolated = ShardedDecoder(net, make_mesh(dp=1),
                              transformer_lm_sharding_rules())
    return ref, port, isolated


def _common(rec):
    """A record without its framework-specific part (the ``own`` key:
    sampled tokens), at any depth."""
    if isinstance(rec, dict):
        return {k: _common(v) for k, v in rec.items() if k != "own"}
    if isinstance(rec, (list, tuple)):
        return type(rec)(_common(v) for v in rec)
    return rec


def both(sides, scenario):
    """Run ``scenario(side)`` on the reference, then on the port; their
    records must be equal but for sampled tokens.  Returns the port's
    record."""
    ref, port = sides[0], sides[1]
    j = scenario(ref)
    p = scenario(port)
    assert _common(p) == _common(j)
    return p


def prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randint(0, VOCAB, (1, t)), dtype=np.int32)
            for t in lengths]


def want(isolated, p, n, **kw):
    return isolated.generate(nd.array(p, dtype="int32"), max_new_tokens=n,
                             max_length=MAXLEN, **kw).asnumpy()


def sampled(kw):
    return bool(kw.get("temperature"))


def port_want(model, p, n, **kw):
    """The port's own generate: the reference for its sampled streams."""
    return model.generate(torch.from_numpy(p), n, max_length=MAXLEN,
                          **kw).numpy()


def gateway(S, n=2, **kw):
    """A fresh gateway over the first n module engines of one side."""
    return S.serving.Gateway(S.engines[:n], **kw)


def pages(S, engines):
    return [{k: e.stats[k] for k in PAGE_KEYS} for e in engines]


def record(S, gw, rids, res=None, n=2, own=()):
    """Everything both frameworks must agree on after one scenario; the
    tokens of the sampled requests ``own`` go under ``own``."""
    res = res or {}
    toks = {r: S.np(res[r]).tolist() for r in res}
    streamed = {r: gw.streamed(r) for r in rids
                if r in gw._reqs and gw.status(r) != "shed"}
    return {
        "status": [gw.status(r) for r in rids],
        "results": {r: t for r, t in toks.items() if r not in own},
        "streamed": {r: t for r, t in streamed.items() if r not in own},
        "own": {"results": {r: t for r, t in toks.items() if r in own},
                "streamed": {r: t for r, t in streamed.items()
                             if r in own}},
        "lengths": {r: len(t[0]) for r, t in toks.items()},
        "errors": {r: {k: v for k, v in (gw.error(r) or {}).items()
                       if k != "exception"} for r in rids if r in gw._reqs},
        "stats": gw.stats,
        "pages": pages(S, S.engines[:n]),
    }


def assert_want(rec, sides, reqs):
    """Each completed stream equals the reference's isolated decode (a
    sampled one the port's own generate)."""
    for rid, (p, n, kw) in reqs.items():
        if sampled(kw):
            got = rec["own"]["results"][rid]
            ref = port_want(sides[1].net, p, n, **kw)
        else:
            got = rec["results"][rid]
            ref = want(sides[2], p, n, **kw)
        np.testing.assert_array_equal(np.asarray(got), ref)


def stream_events(gw, rid):
    toks, resets, events = [], 0, []
    for ev in gw.stream(rid):
        events.append(ev[0])
        if ev[0] == "tokens":
            toks.extend(ev[1])
        else:
            toks, resets = [], resets + 1
    return toks, resets, events


# ---------------------------------------------------------------- basics

def test_gateway_parity_and_streaming_fast_anchor(sides):
    """Greedy, seeded-sampled and penalized requests through a 2-replica
    gateway: equal records, each stream the isolated reference's, the
    streamed tokens the output's generated suffix, TTFT recorded, only
    pinned pages left."""
    p1, p2, p3 = prompts(3, (5, 7, 4))
    reqs = [(p1, 6, {}), (p2, 5, dict(temperature=0.8, seed=11)),
            (p3, 4, dict(repetition_penalty=1.3))]

    def scenario(S):
        gw = gateway(S)
        rids = [gw.submit(S.arr(p), n, **kw) for p, n, kw in reqs]
        return record(S, gw, rids, gw.run(), own={1})

    rec = both(sides, scenario)
    assert_want(rec, sides, dict(enumerate(reqs)))
    assert rec["streamed"][0] == rec["results"][0][0][5:]
    assert 0 in rec["stats"]["ttft_ticks"]
    assert rec["status"] == ["ok"] * 3
    for st in rec["pages"]:
        assert st["blocks_in_use"] == st["pinned_blocks"], st


def test_stream_generator_yields_tokens_as_they_decode(sides):
    (p,) = prompts(9, (6,))

    def scenario(S):
        gw = gateway(S)
        rid = gw.submit(S.arr(p), 6)
        toks, resets, events = stream_events(gw, rid)
        rec = record(S, gw, [rid], {rid: gw.result(rid)})
        rec.update(toks=toks, resets=resets, events=events)
        return rec

    rec = both(sides, scenario)
    w = want(sides[2], p, 6)
    np.testing.assert_array_equal(np.asarray(rec["results"][0]), w)
    assert rec["toks"] == [int(t) for t in w[0, 6:]]
    assert rec["resets"] == 0
    assert rec["events"].count("tokens") > 1   # tokens arrived per pump


def test_router_prefers_prefix_locality_over_round_robin(sides):
    """A warm replica takes every prefixed repeat (its cached pages
    skip the prefill); a round-robin control spreads them."""
    rng = np.random.RandomState(21)
    base = rng.randint(0, VOCAB, (1, 16)).astype(np.int32)
    reps = [np.concatenate([base, rng.randint(0, VOCAB, (1, 2))],
                           axis=1).astype(np.int32) for _ in range(3)]

    def scenario(S):
        gw = gateway(S)
        gw.submit(S.arr(base), 4)
        gw.run()
        warmed = [e.stats["prefill_tokens_avoided"] for e in S.engines[:2]]
        rids = [gw.submit(S.arr(p), 3) for p in reps]
        rec = record(S, gw, rids, gw.run())
        rec["gained"] = [e.stats["prefill_tokens_avoided"] - w
                         for e, w in zip(S.engines[:2], warmed)]
        rr = S.serving.Gateway(S.engines[:2], router="round_robin")
        rids = [rr.submit(S.arr(p), 3) for p in reps[:2]]
        rec["round_robin"] = record(S, rr, rids, rr.run())
        return rec

    rec = both(sides, scenario)
    assert_want(rec, sides, {i + 1: (p, 3, {}) for i, p in enumerate(reps)})
    assert sorted(rec["gained"])[0] == 0
    assert sorted(rec["gained"])[1] >= 3 * 16
    assert rec["stats"]["router"]["locality_hits"] >= 3
    assert rec["stats"]["router"]["prefix_hit_rate"] > 0.5
    assert rec["round_robin"]["stats"]["router"]["policy"] == "round_robin"
    assert_want(rec["round_robin"], sides,
                {i: (p, 3, {}) for i, p in enumerate(reps[:2])})


# ------------------------------------------------- replica death / drain

def test_replica_death_mid_decode_drains_and_requeues_bit_exact(sides):
    """A ``replica.health`` plan kills r1 mid-decode: its requests drain
    and requeue onto r0, every stream completes bit-identical to the
    fault-free run, the dead replica holds zero pages, and a rerun under
    the same plan reproduces everything."""
    p1, p2, p3, p4 = prompts(31, (5, 9, 6, 4))
    reqs = [(p1, 8, {}), (p2, 7, dict(temperature=0.7, seed=5)),
            (p3, 6, {}), (p4, 5, dict(repetition_penalty=1.2))]

    def scenario(S):
        recs = []
        for _ in range(2):
            gw = gateway(S, fail_threshold=2)
            rids = [gw.submit(S.arr(p), n, **kw) for p, n, kw in reqs]
            with S.plan("replica.health#r1@3x2:raise=OSError(dead-host)") \
                    as pl:
                res = gw.run()
            rec = record(S, gw, rids, res, own={1})
            rec["fired"] = pl.stats()["replica.health"]["fired"]
            dead = gw.supervisor.replica("r1")
            rec["dead"] = (dead.alive, {k: dead.stats()[k] for k in (
                "blocks_in_use", "pinned_blocks", "sessions_open")})
            recs.append(rec)
        return recs

    recs = both(sides, scenario)
    for rec in recs:
        assert_want(rec, sides, dict(enumerate(reqs)))
        assert rec["fired"] == 2
        assert rec["status"] == ["ok"] * 4
        assert rec["stats"]["supervisor"]["deaths"] == 1
        assert rec["stats"]["requeued_requests"] >= 1
        assert rec["dead"] == (False, {"blocks_in_use": 0, "pinned_blocks": 0,
                                       "sessions_open": 0})
    assert recs[0]["results"] == recs[1]["results"]
    assert recs[0]["own"] == recs[1]["own"]


def test_stream_fault_transient_blip_vs_death(sides):
    """One ``replica.stream`` failure below fail_threshold kills nothing;
    two consecutive ones at the threshold do, and the stream is still
    exact."""
    (p,) = prompts(41, (6,))

    def scenario(S):
        recs = []
        for plan in ("replica.stream#r0@2:raise=OSError(torn)",
                     "replica.stream#r0@2x2:raise=OSError(torn)"):
            gw = gateway(S, fail_threshold=2)
            rid = gw.submit(S.arr(p), 6)
            with S.plan(plan):
                recs.append(record(S, gw, [rid], gw.run()))
        return recs

    recs = both(sides, scenario)
    for rec in recs:
        assert_want(rec, sides, {0: (p, 6, {})})
    assert recs[0]["stats"]["supervisor"]["deaths"] == 0
    assert recs[1]["stats"]["supervisor"]["deaths"] in (0, 1)


def test_streaming_reset_after_replica_death(sides):
    """A stream cut by its replica's death emits a reset and replays from
    the new dispatch: the post-reset tokens are the whole stream."""
    (p,) = prompts(43, (5,))

    def scenario(S):
        gw = gateway(S, fail_threshold=1)
        rid = gw.submit(S.arr(p), 8)
        with S.plan("replica.health#r0@4:raise=OSError(died)"):
            toks, resets, _ = stream_events(gw, rid)
        rec = record(S, gw, [rid], {rid: gw.result(rid)})
        rec.update(toks=toks, resets=resets,
                   gw_resets=gw._reqs[rid].resets)
        return rec

    rec = both(sides, scenario)
    w = want(sides[2], p, 8)
    np.testing.assert_array_equal(np.asarray(rec["results"][0]), w)
    assert rec["toks"] == [int(t) for t in w[0, 5:]]
    assert rec["resets"] == rec["gw_resets"]


def test_engine_retry_resets_stream_not_mixed(sides):
    """An ENGINE-level quarantine and retry restarts the request: the
    stream resets instead of mixing the two attempts' tokens."""
    (p,) = prompts(107, (5,))

    def scenario(S):
        gw = gateway(S)
        rid = gw.submit(S.arr(p), 6, temperature=0.9, engine_retries=1)
        with S.plan("serving.step@3:raise=RuntimeError(mid-decode)"):
            toks, resets, _ = stream_events(gw, rid)
        rec = record(S, gw, [rid], {rid: gw.result(rid)}, own={rid})
        rec.update(resets=resets)
        rec["own"]["toks"] = toks
        return rec

    rec = both(sides, scenario)
    assert rec["status"] == ["ok"]
    assert rec["own"]["toks"] == rec["own"]["results"][0][0][5:]
    assert rec["resets"] >= 1


def test_revive_after_probation_rejoins_pool(sides):
    (p,) = prompts(47, (5,))

    def scenario(S):
        gw = gateway(S, fail_threshold=1, revive_after_ticks=3)
        rid = gw.submit(S.arr(p), 6)
        with S.plan("replica.health#r0@2:raise=OSError(blip)"):
            rec = record(S, gw, [rid], gw.run())
        rec["alive"] = len(gw.supervisor.alive)
        return rec

    rec = both(sides, scenario)
    assert_want(rec, sides, {0: (p, 6, {})})
    st = rec["stats"]["supervisor"]
    assert st["deaths"] == 1 and st["revivals"] == 1
    assert rec["alive"] == 2


def stub_class(serving):
    """A replica that holds one request forever and never progresses
    (pure host logic, no engine)."""
    class Stub(serving.ReplicaTransport):
        def __init__(self, rid):
            self.replica_id = rid
            self.alive = True
        capacity = property(lambda s: 1)
        load = property(lambda s: 1)
        free_slots = property(lambda s: 0)

        def prefix_probe(self, p):
            return 0

        def submit(self, spec, tag):
            return tag

        def step(self):
            pass

        def poll(self):
            return {}, []

        def health(self):
            pass

        def progress(self):
            return (7,)

        def cancel(self, tag):
            return False

        def drain(self):
            return [("t", 0)]
    return Stub


def test_stall_detection_declares_dead_and_requeues():
    def scenario(serving):
        sup = serving.ReplicaSupervisor([stub_class(serving)("s0")],
                                        fail_threshold=3, stall_ticks=3)
        requeued = []
        for _ in range(6):
            requeued.extend(sup.tick()[2])
        return requeued, sup.stats

    requeued, st = scenario(port_serving)
    assert (requeued, st) == scenario(jax_serving)
    assert st["deaths"] == 1 and requeued == [("t", 0)]
    assert "stalled" in st["last_errors"]["s0"]["reason"]


# --------------------------------------------------- reroute and hedging

def test_router_dispatch_fault_reroutes_via_retry_policy(sides):
    """A typed ReplicaDownError at ``router.dispatch`` (keyed by the
    gateway rid) rides the RetryPolicy onto the next replica."""
    (p,) = prompts(53, (6,))

    def scenario(S):
        gw = gateway(S)
        rid = gw.submit(S.arr(p), 5)
        with S.plan("router.dispatch#%d@1:raise=%s.serving.transport."
                    "ReplicaDownError(flaky-link)" % (rid, S.pkg)):
            return record(S, gw, [rid], gw.run())

    rec = both(sides, scenario)
    assert_want(rec, sides, {0: (p, 5, {})})
    assert rec["stats"]["router"]["reroutes"] == 1


def test_hedged_redispatch_after_deadline_fraction(sides):
    """Unfinished past hedge_fraction × deadline, a request is duplicated
    onto the other replica; the first finisher wins, the loser is
    cancelled, and the stream is exact."""
    (p,) = prompts(59, (5,))
    kw = dict(deadline_ticks=40, temperature=0.6, seed=9)

    def scenario(S):
        gw = gateway(S, hedge_fraction=0.25)
        rid = gw.submit(S.arr(p), 12, **kw)
        return record(S, gw, [rid], gw.run(), own={rid})

    rec = both(sides, scenario)
    assert_want(rec, sides, {0: (p, 12, dict(temperature=0.6, seed=9))})
    assert rec["stats"]["hedged_requests"] == 1
    for st in rec["pages"]:
        assert st["blocks_in_use"] == st["pinned_blocks"], st


def test_gateway_deadline_expires_with_partial_stream(sides):
    (p,) = prompts(61, (5,))

    def scenario(S):
        gw = gateway(S, hedge_fraction=None)
        rid = gw.submit(S.arr(p), 20, deadline_ticks=5)
        gw.run()
        return record(S, gw, [rid], {rid: gw.result(rid)})

    rec = both(sides, scenario)
    assert rec["status"] == ["expired"]
    part = np.asarray(rec["results"][0])
    w = want(sides[2], p, 20)
    assert p.shape[1] <= part.shape[1] < w.shape[1]
    np.testing.assert_array_equal(part[0], w[0, :part.shape[1]])
    for st in rec["pages"]:
        assert st["blocks_in_use"] == st["pinned_blocks"], st


# --------------------------------------------------------- QoS / shedding

def test_gateway_admit_fault_rejects_before_any_state(sides):
    (p,) = prompts(67, (4,))

    def scenario(S):
        gw = gateway(S, max_pending=4)
        with S.plan("gateway.admit@1:raise=RuntimeError(poisoned)"):
            with pytest.raises(RuntimeError, match="poisoned"):
                gw.submit(S.arr(p), 3)
        pending = gw.pending
        rid = gw.submit(S.arr(p), 3)
        queued = gw.status(rid)
        rec = record(S, gw, [rid], gw.run())
        rec.update(pending=pending, queued=queued)
        return rec

    rec = both(sides, scenario)
    assert rec["pending"] == 0 and rec["queued"] == "queued"
    assert_want(rec, sides, {0: (p, 3, {})})


def test_qos_overflow_sheds_lowest_class_first(sides):
    """A full queue displaces the newest lowest-class request for a
    higher-class arrival; with nothing lower queued the arrival sheds,
    typed and structured."""
    p1, p2, p3, p4 = prompts(71, (4, 5, 6, 4))

    def scenario(S):
        gw = gateway(S, n=1, qos_classes=3, max_pending=2)
        ra = gw.submit(S.arr(p1), 3, qos=2)
        rb = gw.submit(S.arr(p2), 3, qos=2)
        rc = gw.submit(S.arr(p3), 3, qos=0)
        exc = gw.error(rb)["exception"]
        assert isinstance(exc, S.res.QosShedError)
        with pytest.raises(S.res.QosShedError) as ei:
            gw.submit(S.arr(p4), 3, qos=2)
        with pytest.raises(S.res.QosShedError):
            gw.result(rb)
        e = ei.value
        rec = record(S, gw, [ra, rb, rc], gw.run(), n=1)
        rec["shed"] = (e.queue_depth, e.limit, e.retry_after_ticks,
                       e.permanent, exc.retry_after_ticks)
        return rec

    rec = both(sides, scenario)
    assert rec["status"] == ["ok", "shed", "ok"]
    assert rec["errors"][1]["type"] == "QosShedError"
    assert rec["shed"][:2] == (2, 2) and rec["shed"][2] >= 1
    assert not rec["shed"][3] and rec["shed"][4] >= 1
    assert_want(rec, sides, {0: (p1, 3, {}), 2: (p3, 3, {})})
    assert rec["stats"]["qos_shed_requests"] == 2


def test_tenant_quota_sheds_typed(sides):
    p1, p2, p3 = prompts(73, (4, 5, 4))

    def scenario(S):
        gw = gateway(S, tenant_quota=2)
        r1 = gw.submit(S.arr(p1), 3, tenant="acme")
        r2 = gw.submit(S.arr(p2), 3, tenant="acme")
        with pytest.raises(S.res.QosShedError) as ei:
            gw.submit(S.arr(p3), 3, tenant="acme")
        r3 = gw.submit(S.arr(p3), 3, tenant="other")
        rec = record(S, gw, [r1, r2, r3], gw.run())
        r4 = gw.submit(S.arr(p1), 3, tenant="acme")
        rec.update(limit=ei.value.limit, queued=gw.status(r4))
        gw.run()
        return rec

    rec = both(sides, scenario)
    assert rec["limit"] == 2 and rec["queued"] == "queued"
    assert_want(rec, sides, {0: (p1, 3, {}), 1: (p2, 3, {}),
                                2: (p3, 3, {})})


def test_engine_shed_maps_to_typed_subclass(sides):
    """A request the engine can never admit (more pages than its pool)
    surfaces as a permanent EngineShedError, not a QoS shed."""
    rng = np.random.RandomState(79)
    p = rng.randint(0, VOCAB, (1, 18)).astype(np.int32)

    def scenario(S):
        eng = S.paged(S.net, num_slots=2, max_length=MAXLEN, block_size=8,
                      prefill_chunk=8, num_blocks=3)
        gw = S.serving.Gateway([eng])
        rid = gw.submit(S.arr(p), 10)
        gw.run()
        exc = gw.error(rid)["exception"]
        assert isinstance(exc, S.res.EngineShedError)
        assert isinstance(exc, S.res.LoadShedError)
        with pytest.raises(S.res.EngineShedError):
            gw.result(rid)
        return (gw.status(rid), gw.error(rid)["type"], exc.permanent,
                exc.retry_after_ticks, gw.stats)

    rec = both(sides, scenario)
    assert rec[:4] == ("shed", "EngineShedError", True, None)


def test_loadshed_carries_structured_context(sides):
    rng = np.random.RandomState(83)
    p = rng.randint(0, VOCAB, (1, 4)).astype(np.int32)
    big = rng.randint(0, VOCAB, (1, 20)).astype(np.int32)

    def scenario(S):
        eng = S.slot(S.net, num_slots=2, max_length=MAXLEN, max_pending=1)
        eng.submit(S.arr(p), 3)
        with pytest.raises(S.res.LoadShedError) as ei:
            eng.submit(S.arr(p), 3)
        paged = S.paged(S.net, num_slots=2, max_length=MAXLEN, block_size=8,
                        prefill_chunk=8, num_blocks=2)
        with pytest.raises(S.res.LoadShedError) as ej:
            paged.submit(S.arr(big), 10)
        return [(e.value.queue_depth, e.value.limit,
                 e.value.retry_after_ticks, e.value.permanent)
                for e in (ei, ej)]

    rec = both(sides, scenario)
    assert rec[0] == (1, 1, 1, False)
    assert rec[1][1:] == (2, None, True)


def test_replica_pool_and_env_defaults(monkeypatch):
    """MXTPU_REPLICAS sizes replica_pool; MXTPU_QOS_CLASSES sets the
    gateway's class count (stub engines, no device work)."""
    class StubEng:
        num_slots = 1
        active = pending = 0
        free_slots = 1
        stats = {"steps": 0, "generated_tokens": 0,
                 "quarantined_requests": 0}

        def prefix_probe(self, p):
            return 0

    def scenario(serving):
        built = []
        monkeypatch.setenv("MXTPU_REPLICAS", "3")
        pool = serving.replica_pool(lambda i: built.append(i) or StubEng())
        assert all(isinstance(r, serving.InProcessReplica) for r in pool)
        monkeypatch.setenv("MXTPU_QOS_CLASSES", "5")
        gw = serving.Gateway(pool)
        with pytest.raises(ValueError):
            gw.submit(np.zeros((1, 2), np.int32), 1, qos=5)
        with pytest.raises(ValueError):
            serving.replica_pool(lambda i: StubEng(), n=0)
        monkeypatch.delenv("MXTPU_REPLICAS")
        monkeypatch.delenv("MXTPU_QOS_CLASSES")
        return built, [r.replica_id for r in pool], gw._qos_classes

    rec = scenario(port_serving)
    assert rec == scenario(jax_serving)
    assert rec == ([0, 1, 2], ["r0", "r1", "r2"], 5)


def test_supervisor_all_dead_raises_typed(sides):
    (p,) = prompts(89, (4,))

    def scenario(S):
        gw = gateway(S, fail_threshold=1)
        gw.submit(S.arr(p), 4)
        with S.plan("replica.health+:raise=OSError(rack-down)"):
            with pytest.raises(Exception, match="all 2 replica") as ei:
                gw.run()
        return type(ei.value).__name__, pages(S, S.engines[:2]), gw.stats

    rec = both(sides, scenario)
    assert rec[0] == "MXTPUError"
    for st in rec[1]:
        assert st["blocks_in_use"] == 0 and st["pinned_blocks"] == 0


def test_overlap_swap_in_fault_retries_bit_exact(sides):
    """A ``serving.swap_in`` fault at the deferred restore quarantines
    only the cold request; its retry restores and completes exact."""
    rng = np.random.RandomState(97)
    P = rng.randint(0, VOCAB, (1, 16)).astype(np.int32)
    P2 = np.concatenate([P, rng.randint(0, VOCAB, (1, 2))],
                        axis=1).astype(np.int32)

    def scenario(S):
        eng = S.paged(S.net, num_slots=2, max_length=48, block_size=8,
                      prefill_chunk=8, pin_bytes=0, host_cache_bytes="4MiB",
                      overlap_swaps=True)
        eng.submit(S.arr(P), 3)
        eng.run()
        out = [eng.stats["swapped_out_blocks"], eng.stats["swapped_in_blocks"]]
        r2 = eng.submit(S.arr(P2), 4, retries=1)
        with S.plan("serving.swap_in#%d@1:raise=OSError(copy-fail)" % r2) \
                as plan:
            res = eng.run()
        out += [plan.stats()["serving.swap_in"]["fired"], eng.status(r2),
                S.np(res[r2]).tolist(), pages(S, [eng])]
        return out

    rec = both(sides, scenario)
    assert rec[0] >= 2 and rec[2] == 1 and rec[3] == "ok"
    np.testing.assert_array_equal(
        np.asarray(rec[4]),
        sides[2].generate(nd.array(P2, dtype="int32"), max_new_tokens=4,
                          max_length=48).asnumpy())
    assert rec[5][0]["swapped_in_blocks"] > rec[1]
    assert rec[5][0]["blocks_in_use"] == 0


# ------------------------------------------------- trace and flight bytes

def test_death_hedge_shed_trace_and_flight_bytes_equal_reference(sides):
    """Three replicas, QoS classes under a bounded queue (one displaced
    shed), a hedged request with a deadline, and r2 declared dead
    mid-decode: the trace and the flight recorder's postmortems are
    byte-equal to the reference's, and every completed stream is
    exact."""
    rng = np.random.RandomState(101)
    ps = [rng.randint(0, VOCAB, (1, t)).astype(np.int32)
          for t in (5, 8, 11, 6, 4)]
    cfgs = [dict(), dict(temperature=0.9, seed=3),
            dict(repetition_penalty=1.4),
            dict(temperature=0.5, seed=8, top_k=7), dict()]
    news = (7, 20, 7, 7, 7)

    def scenario(S):
        with S.flight(64) as fl, S.tracing() as tr:
            gw = gateway(S, n=3, fail_threshold=2, hedge_fraction=0.3,
                         max_pending=4, qos_classes=2)
            rids = []
            for i, (p, c) in enumerate(zip(ps, cfgs)):
                kw = dict(c)
                if i == 1:
                    kw["deadline_ticks"] = 40
                rids.append(gw.submit(S.arr(p), news[i],
                                      qos=1 if i < 4 else 0, **kw))
            with S.plan("replica.health#r2@2x2:raise=OSError(gone)"):
                res = gw.run()
            rec = record(S, gw, rids, res, n=3, own={1, 3})
            rec.update(trace=tr.to_json(), flight=fl.to_json())
        return rec

    rec = both(sides, scenario)
    st = rec["stats"]
    assert st["supervisor"]["deaths"] == 1 and st["hedged_requests"] == 1
    assert st["qos_shed_requests"] == 1 and "shed" in rec["status"]
    assert_want(rec, sides, {i: (ps[i], news[i], cfgs[i]) for i, s in
                                enumerate(rec["status"]) if s == "ok"})
    types = {e["type"] for e in json.loads(rec["trace"])["events"]}
    assert {"gateway.pump", "gateway.shed", "gateway.hedge",
            "gateway.requeue", "replica.death", "router.dispatch",
            "transport.submit", "engine.admit"} <= types, types
    kinds = [pm["kind"] for pm in json.loads(rec["flight"])["postmortems"]]
    assert "replica_death" in kinds and "shed" in kinds


# ------------------------------------------------------- host reads

def test_poll_reads_the_pooled_tokens_once(sides, monkeypatch):
    """An InProcessReplica poll copies the pooled token vectors its slots
    emitted since the last poll to the host in one copy, however many
    slots and steps they span; the streams are the engine's own."""
    model = sides[1].net
    eng = PagedContinuousBatchingEngine(model, device="cpu", **ENGINE)
    rep = InProcessReplica(eng, "rp")
    spec = port_serving.request_spec
    ps = prompts(5, (4, 6))
    for i, p in enumerate(ps):
        rep.submit(spec(torch.from_numpy(p), 6), ("t", i))
    copies = []
    real = torch.Tensor.cpu

    def counted(t, *a, **kw):
        copies.append(tuple(t.shape))
        return real(t, *a, **kw)

    got = {}
    for _ in range(40):
        for _ in range(2):
            rep.step()                       # two steps between polls
        monkeypatch.setattr(torch.Tensor, "cpu", counted)
        del copies[:]
        toks, fins, _ = rep.poll()
        monkeypatch.setattr(torch.Tensor, "cpu", real)
        assert len(copies) <= 1, copies
        for tag, new in toks.items():
            got.setdefault(tag, []).extend(new)
        for tag, st, res, _ in fins:
            assert st == "ok"
            assert got[tag] == res.numpy()[0, ps[tag[1]].shape[1]:].tolist()
        if not rep.load:
            break
    assert sorted(got) == [("t", 0), ("t", 1)]
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(
            np.asarray([p[0].tolist() + got[("t", i)]]),
            want(sides[2], p, 6))


def test_supervisor_requires_alive_typed_port_error():
    """The port's all-down guard raises the port's own MXTPUError."""
    sup = ReplicaSupervisor([stub_class(port_serving)("s0")],
                            fail_threshold=1, stall_ticks=None)
    sup._replicas[0].alive = False
    with pytest.raises(MXTPUError, match="all 1 replica"):
        sup.require_alive()


# ------------------------------------------- the card phase's helpers

#: phase 6r's model on the CPU: 6e(b)'s cut of llama_3_8b narrowed to 4
#: heads (512 units) over a 512-token vocabulary, float32
CUT_KW = dict(seed=0, device="cpu", vocab_size=512, width_factor=1 / 32,
              dtype="float32")


def test_chip_smoke_replicas_run_on_the_cpu():
    """Phase 6r(a)'s three runs (``chip_smoke.replicas_run``) on phase 5's
    traffic and settings, on a narrow cut on the CPU: no problem found,
    and the record carries what the card phase logs — r1 killed holding
    emitted tokens and its requests redispatched a tick later, the shed
    request served by the revived r1, the autoscaler's two grows and two
    retires."""
    import chip_smoke

    model = chip_smoke.replica_engine(**CUT_KW)._model
    cfg = dict(chip_smoke.SERVE, device="cpu")
    reqs = chip_smoke.traffic(512)
    want = chip_smoke.serve_streams(
        PagedContinuousBatchingEngine(model, **cfg), reqs,
        chip_smoke.NEW_TOKENS)
    rec, problems = chip_smoke.replicas_run(model, reqs, want, cfg,
                                            chip_smoke.NEW_TOKENS)
    assert problems == []
    engines = rec.pop("engines")
    assert len(engines) == 3
    f = rec["faulted"]
    assert f["death_tick"] == chip_smoke.REPLICA_DEATH_HIT
    assert any(f["emitted_before_death"].values())
    assert set(f["death_to_redispatch_ticks"].values()) == {1}
    assert f["shed"] == [10] and f["resubmitted_to"] == "r1"
    assert [d[1] for d in rec["autoscaled"]["decisions"]] == \
        ["grow", "grow", "shrink", "shrink"]
    for run in ("clean", "faulted", "autoscaled"):
        r = rec[run]
        assert r["steps"] > 0 and r["chunks"] > 0
        assert len(r["ttft_ticks"]) == 12
        for key in ("wall_ms_per_tick", "step_ms_per_tick",
                    "token_read_ms_per_tick", "service_ms_per_tick"):
            assert key in r
