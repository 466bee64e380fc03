"""Elastic serving of the port (``mxtpu_torch.serving.Autoscaler``) and
per-engine weight generations, held against the JAX reference.

- A weight generation belongs to the ENGINE, as each reference engine's
  decoder holds its own: two engines over one model adopt, install and
  roll back apart.  Two port engines of each kind over one model run
  beside the reference's two engines over one net; one adopts while a
  stream is in flight on the other, and after every iteration the
  statuses, stats and page tables are equal, every stream equals the
  generation it was admitted under, and the trace is byte-equal.
- The autoscaler scenarios of tests/test_serving_elastic.py (grow on
  backlog and retire when idle, an operator's retire, the spawn and
  retire fault sites, the adopt fan-out that covers a late spawn) run on
  both frameworks' gateways over engines that share one model; their
  decisions, the gateway's stats and every stream must be equal (a
  sampled stream is held to the port's own ``generate``).
"""

import pickle

import numpy as np
import pytest
import torch

import mxtpu.serving as jax_serving
from mxtpu import nd
from mxtpu.models.transformer import transformer_lm_sharding_rules
from mxtpu.parallel import ShardedDecoder, make_mesh
from mxtpu.resilience.checkpoint import write_verified as jax_write_verified
from mxtpu_torch import serving as port_serving
from mxtpu_torch.observability import EVENT_TYPES
from test_torch_serving_router import (  # noqa: F401  (fixtures)
    _clean_tracers, _common, _compile_ledger_left_as_found,
    _one_torch_thread, named, port_model, port_side, ref_net, ref_side)

VOCAB = 50
MAX_LEN = 32
PAGED = dict(num_slots=2, max_length=MAX_LEN, block_size=8, prefill_chunk=8)
SLOT = dict(num_slots=2, max_length=MAX_LEN)
#: greedy, seeded sampling, penalized: the reference's acceptance trio
SAMPLING = ({}, {"temperature": 0.8, "top_k": 8, "seed": 23},
            {"repetition_penalty": 1.3, "seed": 5})
#: engine stats both frameworks report
KEYS = ("steps", "generated_tokens", "param_generation", "adoptions",
        "adoption_failures", "rollbacks", "adoption_staged",
        "last_adoption_steps", "quarantined_requests", "drafted_tokens",
        "accepted_tokens", "verify_calls", "slot_iterations")
PAGED_KEYS = ("blocks_in_use", "blocks_free", "prefix_hit_requests",
              "pinned_blocks", "cow_copied_blocks")


@pytest.fixture(scope="module")
def nets():
    """The reference's net_a (seed 7) and net_b (seed 13), and the
    port's bridged copies."""
    a, b = ref_net(7), ref_net(13)
    return a, b, port_model(a), port_model(b)


@pytest.fixture(scope="module")
def ckpt(nets, tmp_path_factory):
    """net_b's parameters as a verified checkpoint, written by the
    reference (instance-prefixed names: adoption strips them)."""
    blob = pickle.dumps({"step": 42, "num_update": 1,
                         "params": named(nets[1]), "opt_states": {},
                         "scale_state": None, "rng": None})
    path = str(tmp_path_factory.mktemp("elastic") / "step42.ckpt")
    jax_write_verified(path, blob)
    return path


@pytest.fixture(scope="module")
def decs(nets):
    """The reference's isolated decoders of net_a and net_b."""
    return tuple(ShardedDecoder(n, make_mesh(dp=1),
                                transformer_lm_sharding_rules())
                 for n in nets[:2])


def prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randint(0, VOCAB, (1, t)), dtype=np.int32)
            for t in lengths]


def ref_want(dec, p, n, **kw):
    return dec.generate(nd.array(p, dtype="int32"), max_new_tokens=n,
                        max_length=MAX_LEN, **kw).asnumpy()


def port_want(model, p, n, **kw):
    return model.generate(torch.from_numpy(p), n, max_length=MAX_LEN,
                          **kw).numpy()


# --------------------------------------------- per-engine generations

KINDS = {"slot": ("slot", SLOT, {}), "paged": ("paged", PAGED, {}),
         "slot+draft": ("slot", SLOT, {"spec_k": 2, "draft": True})}


def engine_check(S, eng, kind):
    st = eng.stats
    keys = KEYS + (PAGED_KEYS if kind == "paged" else ())
    out = {k: st[k] for k in keys}
    out["status"] = dict(eng._status)
    out["slots"] = [None if s is None else (s.req.rid, s.n_emitted)
                    for s in eng._slots]
    if kind == "paged":
        out.update(pages=list(eng._slot_pages), free=list(eng._bp._free),
                   refs=dict(eng._bp._refs))
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_engines_sharing_one_model_adopt_apart(nets, ckpt, decs, kind):
    """Two engines over ONE model: e2 decodes a 12-token stream while e1
    adopts net_b's checkpoint, installs it and serves on it; e2's stream
    (and its next request) stay on net_a, e1 rolls back to net_a, and the
    model itself keeps serving its own parameters.  Step for step equal
    to the reference's two engines over one net; the traces byte-equal."""
    net_a, _, model_a, _ = nets
    ek, cfg, extra = KINDS[kind]
    p_long, p1, p2 = prompts(17, (5, 4, 6))

    def scenario(S, net):
        def make(tag):
            kw = dict(cfg, ledger_tag=tag)
            if extra:
                kw.update(spec_k=extra["spec_k"], draft_block=net)
            return getattr(S, ek)(net, **kw)

        e1, e2 = make("e1"), make("e2")
        checks, out = [], {}

        def step():
            e1.step()
            e2.step()
            checks.append([engine_check(S, e, ek) for e in (e1, e2)])

        def drain(eng, rid):
            for _ in range(60):
                if eng.status(rid) not in ("queued", "active"):
                    break
                step()
            return S.np(eng.take_result(rid)).tolist()

        with S.tracing() as tr:
            r_long = e2.submit(S.arr(p_long), 12)
            step()
            out["staged"] = e1.adopt(ckpt)
            step()                       # e1 is empty: B installs now
            r1 = e1.submit(S.arr(p1), 6)
            out["b"] = drain(e1, r1)
            out["long"] = drain(e2, r_long)
            out["a"] = drain(e2, e2.submit(S.arr(p2), 6))
            out["rolled"] = e1.rollback()
            step()
            out["back"] = drain(e1, e1.submit(S.arr(p1), 6))
            out["trace"] = tr.to_json()
        out["checks"] = checks
        return out

    j = scenario(ref_side(net_a), net_a)
    p = scenario(port_side(model_a), model_a)
    assert p == j
    assert (p["staged"], p["rolled"]) == (1, 2)
    assert p["checks"][-1][0]["param_generation"] == 2
    assert p["checks"][-1][1]["param_generation"] == 0
    dec_a, dec_b = decs
    np.testing.assert_array_equal(np.asarray(p["long"]),
                                  ref_want(dec_a, p_long, 12))
    np.testing.assert_array_equal(np.asarray(p["b"]), ref_want(dec_b, p1, 6))
    np.testing.assert_array_equal(np.asarray(p["a"]), ref_want(dec_a, p2, 6))
    np.testing.assert_array_equal(np.asarray(p["back"]),
                                  ref_want(dec_a, p1, 6))
    # nothing of e1's generation stayed on the model
    np.testing.assert_array_equal(port_want(model_a, p1, 6),
                                  ref_want(dec_a, p1, 6))


def test_adopting_engine_binds_its_leaves_only_inside_its_iteration(
        nets, ckpt):
    """The model's parameters point at its own tensors outside an
    adopted engine's iteration and at the engine's inside it."""
    model = nets[2]

    def ptrs(leaves):
        return [t.data_ptr() for t in leaves]

    own = ptrs(model._live_param_leaves())
    side = port_side(model)
    eng = side.paged(model, **PAGED)
    eng.adopt(ckpt)
    eng.step()                                  # installs
    seen = []
    real = model.step_pages

    def spy(*a, **kw):
        seen.append(ptrs(model._live_param_leaves()))
        return real(*a, **kw)

    model.step_pages = spy
    try:
        eng.submit(prompts(3, (4,))[0], 3)
        eng.run()
    finally:
        del model.step_pages
    assert seen and all(s == ptrs(eng._leaves) for s in seen)
    assert ptrs(eng._leaves) != own
    assert ptrs(model._live_param_leaves()) == own


# ---------------------------------------------------------- autoscaling

def factory(S, net, prefix):
    def make(i):
        return S.paged(net, ledger_tag="%s%d" % (prefix, i), **PAGED)
    return make


def drive(gw, asc, rids, bound=400):
    for _ in range(bound):
        gw.pump()
        asc.tick()
        if all(gw.status(r) in ("ok", "failed", "expired", "shed")
               for r in rids):
            return
    raise AssertionError("streams did not finish within %d pumps" % bound)


def streams(S, gw, rids, reqs):
    """{"common": greedy streams, "own": sampled ones} of finished rids."""
    out = {"common": {}, "own": {}}
    for rid, (_, _, kw) in zip(rids, reqs):
        key = "own" if kw.get("temperature") else "common"
        out[key][rid] = S.np(gw.result(rid)).tolist()
    return out


def both(nets, scenario):
    """``scenario(side, net)`` on the reference's net_a, then the port's;
    records equal but for sampled tokens."""
    j = scenario(ref_side(nets[0]), nets[0])
    p = scenario(port_side(nets[2]), nets[2])
    assert _common(p) == _common(j)
    return p


def assert_streams(rec, nets, dec, reqs, rids):
    for rid, (p, n, kw) in zip(rids, reqs):
        if kw.get("temperature"):
            np.testing.assert_array_equal(np.asarray(rec["own"][rid]),
                                          port_want(nets[2], p, n, **kw))
        else:
            np.testing.assert_array_equal(np.asarray(rec["common"][rid]),
                                          ref_want(dec, p, n, **kw))


def test_autoscaler_grows_on_backlog_then_retires_idle(nets, decs):
    ps = prompts(3, [3, 4, 3, 5, 4, 3])
    reqs = [(p, 5, SAMPLING[i % 3]) for i, p in enumerate(ps)]

    def scenario(S, net):
        gw = S.serving.Gateway(S.serving.replica_pool(
            factory(S, net, "el"), n=1), hedge_fraction=None)
        asc = S.serving.Autoscaler(gw, factory(S, net, "el"),
                                   min_replicas=1, max_replicas=3,
                                   cooldown_ticks=2)
        with S.tracing() as tr:
            rids = [gw.submit(S.arr(p), n, **kw) for p, n, kw in reqs]
            drive(gw, asc, rids)
            grown = (asc.stats["scale_ups"], len(gw.supervisor.replicas))
            for _ in range(120):
                gw.pump()
                asc.tick()
                if len(gw.supervisor.replicas) == 1:
                    break
            trace = tr.to_json()
        rec = streams(S, gw, rids, reqs)
        rec.update(grown=grown, asc=asc.stats, gw=gw.stats, trace=trace,
                   status=[gw.status(r) for r in rids],
                   replicas=len(gw.supervisor.replicas))
        return rec, rids

    rec, rids = both(nets, scenario)
    assert rec["grown"][0] >= 1 and rec["grown"][1] >= 2
    assert rec["replicas"] == 1
    for etype in ("autoscale.decision", "autoscale.spawn",
                  "autoscale.retire"):
        assert '"%s"' % etype in rec["trace"]
    assert rec["gw"]["requeued_requests"] == 0
    assert rec["status"] == ["ok"] * len(reqs)
    assert_streams(rec, nets, decs[0], reqs, rids)
    st = rec["asc"]
    assert st["retired_replicas"] == st["scale_downs"] >= 1
    assert st["retiring_replicas"] == 0


def test_operator_retire_preserves_inflight_streams(nets, decs):
    """``retire("r1")`` with r1 mid-stream: fresh admissions are refused
    on it, its streams decode to completion, then it releases with no
    page and no requeue."""
    ps = prompts(9, [3, 4, 5, 3])
    reqs = [(p, 6, SAMPLING[i % 3]) for i, p in enumerate(ps)]

    def scenario(S, net):
        gw = S.serving.Gateway(S.serving.replica_pool(
            factory(S, net, "rt"), n=2), hedge_fraction=None)
        asc = S.serving.Autoscaler(gw, factory(S, net, "rt"),
                                   min_replicas=1, max_replicas=2,
                                   cooldown_ticks=3)
        rids = [gw.submit(S.arr(p), n, **kw) for p, n, kw in reqs]
        for _ in range(3):
            gw.pump()
            asc.tick()
        victim = gw.supervisor.replica("r1")
        load = victim.load
        asc.retire("r1")
        with pytest.raises(S.serving.ReplicaDownError, match="retiring"):
            victim.submit(S.serving.request_spec(ps[0], 1), ("probe", 0))
        drive(gw, asc, rids)
        for _ in range(40):
            gw.pump()
            asc.tick()
            if len(gw.supervisor.replicas) == 1:
                break
        rec = streams(S, gw, rids, reqs)
        rec.update(load=load, asc=asc.stats, gw=gw.stats,
                   left=[r.replica_id for r in gw.supervisor.replicas],
                   victim=(victim.stats()["blocks_in_use"],
                           victim.stats()["pinned_blocks"]))
        return rec, rids

    rec, rids = both(nets, scenario)
    assert rec["load"] > 0 and rec["left"] == ["r0"]
    assert rec["gw"]["requeued_requests"] == 0
    assert rec["asc"]["retired_replicas"] == 1 and rec["victim"] == (0, 0)
    assert_streams(rec, nets, decs[0], reqs, rids)


def test_retire_refuses_to_drop_below_min(nets):
    def scenario(S, net):
        gw = S.serving.Gateway(S.serving.replica_pool(
            factory(S, net, "mn"), n=1), hedge_fraction=None)
        asc = S.serving.Autoscaler(gw, factory(S, net, "mn"),
                                   min_replicas=1, max_replicas=2)
        with pytest.raises(ValueError, match="min_replicas") as ei:
            asc.retire("r0")
        return str(ei.value), asc.stats

    both(nets, scenario)


def test_autoscale_spawn_fault_degrades_to_current_capacity(nets, decs):
    ps = prompts(5, [3, 4, 3, 4])
    reqs = [(p, 5, {"seed": 11}) for p in ps]

    def scenario(S, net):
        gw = S.serving.Gateway(S.serving.replica_pool(
            factory(S, net, "sf"), n=1), hedge_fraction=None)
        asc = S.serving.Autoscaler(gw, factory(S, net, "sf"),
                                   min_replicas=1, max_replicas=3,
                                   cooldown_ticks=2)
        with S.flight(256) as fl:
            with S.plan("autoscale.spawn@1+:raise=RuntimeError(spawn "
                        "refused)"):
                rids = [gw.submit(S.arr(p), n, **kw) for p, n, kw in reqs]
                drive(gw, asc, rids)
            kinds = [pm.kind for pm in fl.postmortems]
        rec = streams(S, gw, rids, reqs)
        rec.update(asc=asc.stats, gw=gw.stats, kinds=kinds,
                   replicas=len(gw.supervisor.replicas))
        return rec, rids

    rec, rids = both(nets, scenario)
    assert rec["replicas"] == 1
    assert rec["asc"]["spawn_failures"] >= 1 and rec["asc"]["scale_ups"] == 0
    assert "autoscale_spawn_failed" in rec["kinds"]
    assert_streams(rec, nets, decs[0], reqs, rids)


def test_autoscale_retire_fault_reopens_admissions(nets, decs):
    (prompt,) = prompts(2, [4])

    def scenario(S, net):
        gw = S.serving.Gateway(S.serving.replica_pool(
            factory(S, net, "rf"), n=2), hedge_fraction=None)
        asc = S.serving.Autoscaler(gw, factory(S, net, "rf"),
                                   min_replicas=1, max_replicas=2,
                                   cooldown_ticks=2)
        with S.flight(256) as fl:
            with S.plan("autoscale.retire@1:raise=RuntimeError(release "
                        "denied)"):
                for _ in range(30):
                    gw.pump()
                    asc.tick()
                    if asc.stats["retire_reopened"]:
                        break
            kinds = [pm.kind for pm in fl.postmortems]
        rid = gw.submit(S.arr(prompt), 5, seed=7)
        for _ in range(200):
            gw.pump()
            if gw.status(rid) == "ok":
                break
        return dict(asc=asc.stats, kinds=kinds,
                    replicas=len(gw.supervisor.replicas),
                    retiring=[r.retiring for r in gw.supervisor.replicas],
                    common={rid: S.np(gw.result(rid)).tolist()}), rid

    rec, rid = both(nets, scenario)
    assert rec["asc"]["retire_reopened"] == 1
    assert rec["replicas"] == 2 and not any(rec["retiring"])
    assert "autoscale_retire_reopened" in rec["kinds"]
    np.testing.assert_array_equal(np.asarray(rec["common"][rid]),
                                  ref_want(decs[0], prompt, 5, seed=7))


def test_autoscaler_adopt_fans_out_and_covers_late_spawns(nets, ckpt, decs):
    """Pool-wide adopt stages on every active replica (engines sharing
    one model, each on its own generation), and a replica spawned after
    the swap adopts the remembered checkpoint instead of serving the
    factory's weights."""
    (prompt,) = prompts(8, [4])

    def scenario(S, net):
        gw = S.serving.Gateway(S.serving.replica_pool(
            factory(S, net, "fo"), n=2), hedge_fraction=None)
        asc = S.serving.Autoscaler(gw, factory(S, net, "fo"),
                                   min_replicas=1, max_replicas=3,
                                   cooldown_ticks=1)
        staged = asc.adopt(ckpt)
        rids = [gw.submit(S.arr(prompt), 5, seed=9) for _ in range(6)]
        drive(gw, asc, rids)
        gens = {r.replica_id: r.stats()["param_generation"]
                for r in gw.supervisor.replicas}
        return dict(staged=staged, asc=asc.stats, gw=gw.stats, gens=gens,
                    common={r: S.np(gw.result(r)).tolist() for r in rids})

    rec = both(nets, scenario)
    assert rec["staged"] == {"r0": 1, "r1": 1}
    assert rec["asc"]["scale_ups"] >= 1
    assert set(rec["gens"].values()) == {1} and len(rec["gens"]) >= 3
    for out in rec["common"].values():
        np.testing.assert_array_equal(np.asarray(out),
                                      ref_want(decs[1], prompt, 5, seed=9))
    # the shared model still serves its own generation
    np.testing.assert_array_equal(port_want(nets[2], prompt, 5),
                                  ref_want(decs[0], prompt, 5))


def test_elastic_trace_event_types_registered():
    for etype in ("autoscale.decision", "autoscale.spawn",
                  "autoscale.retire", "serving.adopt", "serving.rollback",
                  "fault.autoscale.spawn", "fault.autoscale.retire",
                  "fault.serving.adopt"):
        assert etype in EVENT_TYPES, etype
    assert port_serving.__all__ == jax_serving.__all__
