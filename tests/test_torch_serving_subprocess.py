"""Cross-process replicas of the port (``mxtpu_torch.serving``:
``SubprocessReplica`` and its worker) against the JAX reference's.

Workers are real spawned processes (one engine each, length-prefixed
pipe RPC).  The port's workers build ``demo_paged_engine`` on the CPU
through their factory kwargs (``device="cpu"``); their streams are held
to the port's in-process engine over the same seeded net.  The
reference's workers (``mxtpu.serving.worker:demo_paged_engine``) run
the same plans beside them, and the service record — statuses, death
reasons, requeue counts, the supervisor's stats — must be equal.  The
two draw their weights differently, so their tokens differ; no plan
here depends on a token's value.

Order matters and is relied on (the module's pools are shared):
non-destructive tests first, then the SIGKILL test (which kills worker
r1 of both pools), then graceful shutdown on r0 LAST.
"""

import sys

import numpy as np
import pytest
import torch

import mxtpu.resilience as jax_resilience
import mxtpu.serving as jax_serving
from mxtpu.observability import flight_recording as jax_flight_recording
from mxtpu.observability import get_tracer as jax_get_tracer
from mxtpu.observability import tracing as jax_tracing
import mxtpu_torch.serving as port_serving
from mxtpu_torch.observability import flight_recording, get_tracer, tracing
from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine
from mxtpu_torch.resilience import (TransportError, TransportTimeoutError,
                                    fault_plan)
from mxtpu_torch.serving import (ReplicaSupervisor, SubprocessReplica,
                                 replica_pool, request_spec)
from mxtpu_torch.serving import worker as port_worker
from mxtpu_torch.serving.worker import seeded_llama_tiny
from test_torch_serving_router import _one_torch_thread  # noqa: F401

FACTORY = "mxtpu_torch.serving.worker:demo_paged_engine"
JAX_FACTORY = "mxtpu.serving.worker:demo_paged_engine"
VOCAB = 50
MAX_LEN = 32
#: a port worker's environment: one intra-op thread, as this process
#: runs (``_one_torch_thread``)
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
#: the demo factory's engine settings (the in-process twin must match)
ENGINE = dict(num_slots=2, max_length=MAX_LEN, block_size=8,
              prefill_chunk=8, pin_bytes="1MiB")


@pytest.fixture(autouse=True)
def _clean_tracers():
    yield
    get_tracer().reset()
    jax_get_tracer().reset()


class Pools:
    """The module's two 2-worker pools (the port's on the CPU and the
    reference's), spawned once and closed at the module's end."""

    def __init__(self):
        self.port = replica_pool(
            FACTORY, n=2, transport="subprocess",
            kwargs=lambda i: {"ledger_tag": "r%d" % i, "device": "cpu"},
            env=ONE_THREAD)
        self.ref = jax_serving.replica_pool(
            JAX_FACTORY, n=2, transport="subprocess",
            kwargs=lambda i: {"ledger_tag": "r%d" % i})

    def close(self):
        for rep in self.port + self.ref:
            rep.close()


@pytest.fixture(scope="module")
def pools():
    p = Pools()
    yield p
    p.close()


@pytest.fixture(scope="module")
def twin():
    """The workers' seeded net, built in this process."""
    return seeded_llama_tiny(77, VOCAB, "cpu")


def prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randint(0, VOCAB, (1, t)), dtype=np.int32)
            for t in lengths]


def in_process(model, reqs):
    """The streams of ``reqs`` [(prompt, n)] on a fresh in-process engine
    over ``model`` with the workers' settings."""
    eng = PagedContinuousBatchingEngine(model, device="cpu", **ENGINE)
    rids = [eng.submit(p, n) for p, n in reqs]
    res = eng.run()
    return [res[r].numpy() for r in rids]


def service_record(gw, rids):
    """What the port's and the reference's subprocess runs must agree on
    (error messages name worker pids, so only their reasons and types)."""
    sup = gw.supervisor.stats
    return {
        "status": [gw.status(r) for r in rids],
        "lengths": [tuple(gw.result(r).shape) for r in rids
                    if gw.status(r) == "ok"],
        "requeued": gw.stats["requeued_requests"],
        "supervisor": {k: v for k, v in sup.items() if k != "last_errors"},
        "deaths": {r: (e["reason"], e["type"])
                   for r, e in sup["last_errors"].items()},
        "router": gw.router.stats,
    }


# ---------------------------------------------------- transport-free

def test_replica_pool_transport_selection(monkeypatch):
    for serving in (port_serving, jax_serving):
        with pytest.raises(ValueError, match="module:callable"):
            serving.replica_pool(lambda i: None, n=1, transport="subprocess")
        with pytest.raises(ValueError, match="callable factory"):
            serving.replica_pool("mod:fn", n=1, transport="inprocess")
        with pytest.raises(ValueError, match="unknown replica transport"):
            serving.replica_pool(lambda i: None, n=1,
                                 transport="carrier-pigeon")
        monkeypatch.setenv("MXTPU_REPLICA_TRANSPORT", "subprocess")
        with pytest.raises(ValueError, match="module:callable"):
            serving.replica_pool(lambda i: None, n=1)
        monkeypatch.delenv("MXTPU_REPLICA_TRANSPORT")


def test_codecs_framing_and_factory_resolution(monkeypatch):
    """The wire helpers: json round trip, length-prefixed frames over a
    pipe, msgpack opt-in with a clear error where it is missing, and
    ``module:callable`` factory specs."""
    import io

    dumps, loads = port_worker.make_codec("json")
    msg = {"id": 3, "method": "poll", "params": {"tag": [1, 0]}}
    assert loads(dumps(msg)) == msg
    buf = io.BytesIO()
    port_worker.write_frame(buf, b"abc")
    port_worker.write_frame(buf, b"")
    buf.seek(0)
    assert port_worker.read_frame(buf) == b"abc"
    assert port_worker.read_frame(buf) == b""
    assert port_worker.read_frame(buf) is None
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ValueError, match="msgpack is not importable"):
        port_worker.make_codec("msgpack")
    with pytest.raises(ValueError, match="unknown RPC codec"):
        port_worker.make_codec("xml")
    assert port_worker.resolve_factory(FACTORY) is \
        port_worker.demo_paged_engine
    with pytest.raises(ValueError, match="module:callable"):
        port_worker.resolve_factory("no-colon")
    polled = ({("a", 0): [1, 2]},
              [(("a", 0), "ok", torch.tensor([[5, 1, 2]],
                                              dtype=torch.int32), None)],
              [("b", 1)])
    tokens, finished, restarts = port_worker.decode_poll(
        loads(dumps(port_worker.encode_poll(polled))))
    assert tokens == {("a", 0): [1, 2]} and restarts == [("b", 1)]
    assert finished[0][:2] == (("a", 0), "ok") and finished[0][3] is None
    assert torch.equal(finished[0][2], polled[1][0][2])


class StubReplica:
    """Holds one request forever, with a scriptable progress() — no
    engine, no process."""

    def __init__(self, replica_id, progress_fn):
        self.replica_id = replica_id
        self.alive = True
        self.retiring = False
        self.capacity = 2
        self._progress_fn = progress_fn

    load = property(lambda s: 1)
    free_slots = property(lambda s: 1)

    def health(self):
        pass

    def step(self):
        pass

    def poll(self):
        return {}, [], []

    def progress(self):
        return self._progress_fn()

    def drain(self):
        return [("t", 0)]

    def stats(self):
        return {"blocks_in_use": 0, "pinned_blocks": 0}

    def cancel(self, tag):
        return False

    def prefix_probe(self, prompt):
        return 0


class DeadWorkerStub(StubReplica):
    """A stub whose worker process can die: it opts into the
    supervisor's respawn protocol (``respawn``/``worker_dead``)."""

    def __init__(self, error):
        super().__init__("r0", lambda: (1, 1, 0, 1, 0))
        self.worker_dead = False
        self.respawns = 0
        self.fail_respawn = False
        self.health_exc = None
        self._error = error

    def health(self):
        if self.health_exc is not None:
            raise self.health_exc

    def respawn(self):
        if self.fail_respawn:
            raise self._error("spawn refused")
        self.respawns += 1
        self.worker_dead = False


SIDES = {"port": (ReplicaSupervisor, TransportError, TransportTimeoutError),
         "ref": (jax_serving.ReplicaSupervisor, jax_resilience.TransportError,
                 jax_resilience.TransportTimeoutError)}


def test_supervisor_counts_progress_raise_as_transport_not_stall():
    """A progress RPC that raises is a transport failure: the stall
    counter never moves, the replica dies at fail_threshold with a
    transport reason — as in the reference."""
    out = {}
    for name, (Sup, _, Timeout) in SIDES.items():
        def boom():
            raise Timeout("no answer", method="progress", ticks=4)
        rep = StubReplica("r0", boom)
        sup = Sup([rep], fail_threshold=3, stall_ticks=5)
        requeued = []
        for _ in range(3):
            requeued.extend(sup.tick()[2])
        out[name] = (requeued, sup.stats, rep.alive,
                     sup._stalled_for.get("r0", 0))
    assert out["port"] == out["ref"]
    requeued, st, alive, stalled = out["port"]
    assert requeued == [("t", 0)] and not alive and stalled == 0
    assert st["transport_failures"]["r0"] == 3 and st["deaths"] == 1
    assert "transport failure (progress poll" in \
        st["last_errors"]["r0"]["reason"]


def test_supervisor_stall_reason_still_fires_on_readable_no_progress():
    out = {}
    for name, (Sup, _, _) in SIDES.items():
        sup = Sup([StubReplica("r0", lambda: (1, 1, 0, 1, 0))],
                  fail_threshold=3, stall_ticks=3)
        for _ in range(4):
            sup.tick()
        out[name] = sup.stats
    assert out["port"] == out["ref"]
    st = out["port"]
    assert st["deaths"] == 1 and st["transport_failures"]["r0"] == 0
    assert st["last_errors"]["r0"]["reason"].startswith("stalled")


def test_probation_revive_respawns_dead_worker_stub():
    """revive() respawns a transport whose worker process died before
    it flips ``alive``."""
    out = {}
    for name, (Sup, Err, Timeout) in SIDES.items():
        rep = DeadWorkerStub(Err)
        rep.health_exc = Timeout("no answer", method="health", ticks=4)
        sup = Sup([rep], fail_threshold=1, stall_ticks=None,
                  revive_after_ticks=2)
        seen = []
        sup.tick()
        seen.append((rep.alive, rep.respawns))
        rep.worker_dead, rep.health_exc = True, None
        for _ in range(2):
            sup.tick()
            seen.append((rep.alive, rep.respawns, rep.worker_dead))
        out[name] = (seen, sup.stats)
    assert out["port"] == out["ref"]
    seen, st = out["port"]
    assert seen == [(False, 0), (False, 0, True), (True, 1, False)]
    assert st["revivals"] == 1 and st["transport_failures"]["r0"] == 1


def test_probation_revive_retries_after_failed_respawn():
    out = {}
    for name, (Sup, Err, Timeout) in SIDES.items():
        rep = DeadWorkerStub(Err)
        rep.fail_respawn = True
        rep.health_exc = Timeout("no answer", method="health", ticks=4)
        sup = Sup([rep], fail_threshold=1, stall_ticks=None,
                  revive_after_ticks=1)
        sup.tick()
        rep.worker_dead, rep.health_exc = True, None
        sup.tick()
        first = (rep.alive, dict(sup.stats["last_errors"]["r0"]))
        rep.fail_respawn = False
        sup.tick()
        out[name] = (first, rep.alive, rep.respawns, sup.stats["revivals"])
    assert out["port"] == out["ref"]
    first, alive, respawns, revivals = out["port"]
    assert first[0] is False
    assert first[1]["reason"] == "revive/respawn failed"
    assert (alive, respawns, revivals) == (True, 1, 1)


def test_worker_that_cannot_come_up_fails_its_handshake_typed():
    """A worker whose factory raises (here: no device named on a
    machine without CUDA) fails the handshake with a TransportError that
    quotes the real reason; nothing carries on elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device "
                    "is the card, so the factory comes up")
    with pytest.raises(TransportError, match="no CUDA device"):
        SubprocessReplica(FACTORY, replica_id="rx", env=ONE_THREAD)


# ------------------------------------------------- shared-pool tests

def test_cross_process_parity_and_no_false_stall(pools, twin):
    """Three streams through a Gateway over two worker processes equal
    the in-process engine's; one long chunked prefill (24 tokens, chunks
    of 8) never looks stalled with stall_ticks=3; worker-side engine
    events cross the pipe onto the gateway request's timeline; the
    service record equals the reference's."""
    ps = prompts(11, (5, 24, 4))
    news = (6, 6, 5)
    recs = {}
    for name, pool, trc in (("port", pools.port, tracing),
                            ("ref", pools.ref, jax_tracing)):
        serving = port_serving if name == "port" else jax_serving
        with trc() as tr:
            gw = serving.Gateway(pool, stall_ticks=3, fail_threshold=2)
            rids = [gw.submit(p, n) for p, n in zip(ps, news)]
            res = gw.run()
            kinds = [{e.etype for e in tr.events(rid="gw:%s" % r)}
                     for r in rids]
        recs[name] = service_record(gw, rids)
        recs[name]["pages"] = [(st["blocks_in_use"], st["pinned_blocks"])
                               for st in (rep.stats() for rep in pool)]
        if name == "port":
            got = [res[r].numpy() for r in rids]
            port_kinds = kinds
    assert recs["port"] == recs["ref"]
    rec = recs["port"]
    assert rec["status"] == ["ok"] * 3
    assert rec["supervisor"]["deaths"] == 0
    assert rec["supervisor"]["transport_failures"] == {"r0": 0, "r1": 0}
    for g, w in zip(got, in_process(twin, list(zip(ps, news)))):
        np.testing.assert_array_equal(g, w)
    for kinds in port_kinds:
        assert "transport.submit" in kinds
        assert any(k.startswith("engine.") for k in kinds), kinds
    for used, pinned in rec["pages"]:
        assert used == pinned


def test_rpc_timeout_typed_and_stale_frame_recovery(pools):
    """A response past its tick budget raises TransportTimeoutError
    naming the method and the budget; the late frame is discarded by id
    and the next RPC succeeds."""
    rep = pools.port[0]
    real_waiter, real_ticks = rep._waiter, rep._timeout_ticks
    try:
        rep._waiter = lambda pipe, seconds: False   # never "ready"
        rep._timeout_ticks = 7
        with tracing() as tr:
            with pytest.raises(TransportTimeoutError) as ei:
                rep.stats()
            evs = tr.events(types=["transport.rpc_timeout"])
    finally:
        rep._waiter, rep._timeout_ticks = real_waiter, real_ticks
    assert (ei.value.method, ei.value.ticks) == ("stats", 7)
    assert isinstance(ei.value, TransportError)
    assert evs and evs[0].fields == {"replica": "r0", "method": "stats",
                                     "ticks": 7}
    st = rep.stats()
    assert st["blocks_in_use"] == st["pinned_blocks"]
    assert rep.alive
    rep.health()                        # the heartbeat advanced


def test_transport_fault_sites_fire_by_literal_plan(pools):
    """``transport.encode`` fires before any byte crosses and
    ``transport.rpc`` before the frame is written: the worker stays
    consistent through both."""
    rep = pools.port[0]
    prompt = np.array([[4, 5, 6]], dtype=np.int32)
    with tracing() as tr:
        with fault_plan("transport.encode#r0@1:raise=ValueError(bad-encode)"):
            with pytest.raises(ValueError, match="bad-encode"):
                rep.submit(request_spec(prompt, 2), ("enc", 0))
        with fault_plan("transport.rpc#r0@1:raise=mxtpu_torch.resilience."
                        "TransportTimeoutError(injected-timeout)"):
            with pytest.raises(TransportTimeoutError,
                               match="injected-timeout"):
                rep.stats()
        kinds = [e.etype for e in tr.events()]
    assert "fault.transport.encode" in kinds
    assert "fault.transport.rpc" in kinds
    assert ("enc", 0) not in rep._mirror.values()
    st = rep.stats()
    assert st["blocks_in_use"] == st["pinned_blocks"]


def test_injected_rpc_fault_counts_toward_replica_death(pools):
    """Injected ``transport.rpc`` timeouts in the supervisor loop count
    on the transport ledger and retire r1 at fail_threshold; the drain
    RPC after the death still goes through and the worker is unharmed —
    the same record as the reference's."""
    out = {}
    for name, pool, Sup, plan, pkg in (
            ("port", pools.port, ReplicaSupervisor, fault_plan,
             "mxtpu_torch"),
            ("ref", pools.ref, jax_serving.ReplicaSupervisor,
             jax_resilience.fault_plan, "mxtpu")):
        sup = Sup(pool, fail_threshold=2, stall_ticks=None)
        with plan("transport.rpc#r1@1x2:raise=%s.resilience."
                  "TransportTimeoutError(injected-timeout)" % pkg):
            for _ in range(2):
                sup.tick()
        st = sup.stats
        sup.revive("r1")
        pool[1].health()
        out[name] = (st, pool[1].stats()["blocks_in_use"])
    assert out["port"] == out["ref"]
    st, used = out["port"]
    assert st["transport_failures"] == {"r0": 0, "r1": 2}
    assert st["deaths"] == 1 and used == 0
    assert st["last_errors"]["r1"]["reason"] == \
        "transport failure (TransportTimeoutError)"


def test_worker_sigkill_mid_decode_drains_bit_exact(pools, twin):
    """A planned ``transport.worker_death`` SIGKILLs worker r1
    mid-decode: the supervisor sees WorkerDiedError, drains r1's streams
    off the parent's tag mirror and requeues them; every stream equals
    the fault-free in-process one; the dead replica reports zero pages;
    the postmortem names exit code -9 and the drained tags (the pid on
    the noise channel only).  The service record equals the
    reference's."""
    ps = prompts(3, (5, 7, 4))
    news = (6, 5, 4)
    recs = {}
    for name, pool, pkg in (("port", pools.port, "mxtpu_torch"),
                            ("ref", pools.ref, "mxtpu")):
        port = name == "port"
        serving = port_serving if port else jax_serving
        plan = fault_plan if port else jax_resilience.fault_plan
        trc = tracing if port else jax_tracing
        fr = flight_recording if port else jax_flight_recording
        pid = pool[1].pid
        with fr(64) as fl, trc() as tr:
            gw = serving.Gateway(pool, fail_threshold=1, hedge_fraction=None)
            with plan("transport.worker_death#r1@25:raise="
                      "OSError(planned-kill)"):
                rids = [gw.submit(p, n) for p, n in zip(ps, news)]
                res = gw.run()
            kinds = [e.etype for e in tr.events()]
            pms = [p for p in fl.postmortems if p.kind == "replica_death"]
            lean = fl.to_json()
        rec = service_record(gw, rids)
        dead = pool[1]
        rec.update(dead=(dead.alive, dead.exit_code, dead.stats()),
                   kinds=sorted({"fault.transport.worker_death",
                                 "transport.worker_exit",
                                 "replica.death"} & set(kinds)),
                   context=[(p.context["replica"], p.context["exit_code"],
                             p.context["drained_tags"], p.noise == {
                                 "pid": pid}) for p in pms])
        recs[name] = rec
        if port:
            got = [res[r].numpy() for r in rids]
            assert '"pid"' not in lean and '"noise"' not in lean
            assert all(fl.timeline(r) for p in pms for r in p.rids)
    assert recs["port"] == recs["ref"]
    rec = recs["port"]
    assert rec["status"] == ["ok"] * 3
    assert rec["supervisor"]["deaths"] == 1
    assert rec["requeued"] >= 1
    assert "transport failure" in rec["deaths"]["r1"][0]
    assert rec["deaths"]["r1"][1] == "WorkerDiedError"
    assert rec["dead"] == (False, -9, {"blocks_in_use": 0,
                                       "pinned_blocks": 0,
                                       "worker": "dead"})
    assert len(rec["kinds"]) == 3
    ((replica, code, tags, pid_noise),) = rec["context"]
    assert (replica, code, pid_noise) == ("r1", -9, True) and tags
    for g, w in zip(got, in_process(twin, list(zip(ps, news)))):
        np.testing.assert_array_equal(g, w)
    st0 = pools.port[0].stats()
    assert st0["blocks_in_use"] == st0["pinned_blocks"]


def test_killed_worker_respawns_on_probation_and_serves(pools, twin):
    """Probation ``revive`` of the killed r1 spawns a fresh worker (new
    pid, new pipe, the factory run again) that serves bit-exact."""
    rep = pools.port[1]
    assert rep.worker_dead and not rep.alive
    pid = rep.pid
    rep.alive = True                        # a fresh pool's member
    sup = ReplicaSupervisor([rep], fail_threshold=1, stall_ticks=None,
                            revive_after_ticks=2)
    sup.tick()                              # the dead pipe: declared dead
    assert not rep.alive
    assert sup.stats["last_errors"]["r1"]["type"] == "WorkerDiedError"
    for _ in range(4):
        sup.tick()
        if rep.alive:
            break
    assert rep.alive and not rep.worker_dead and rep.pid != pid
    assert sup.stats["revivals"] == 1
    with pytest.raises(TransportError, match="DEAD"):
        rep.respawn()                       # a live worker stays
    prompt = np.array([[4, 5, 6, 7]], dtype=np.int32)
    rep.submit(request_spec(prompt, 4), ("back", 0))
    for _ in range(64):
        rep.step()
        _toks, fins, _re = rep.poll()
        if fins:
            break
    assert fins[0][:2] == (("back", 0), "ok")
    np.testing.assert_array_equal(fins[0][2].numpy(),
                                  in_process(twin, [(prompt, 4)])[0])


def test_graceful_shutdown_flushes_inflight_cursors(pools, twin):
    """LAST (ends r0): ``shutdown()`` sends the shutdown RPC and the
    worker's final frame flushes tokens decoded but not yet polled; the
    worker exits 0, as the reference's does."""
    prompt = np.array([[7, 8, 9, 10]], dtype=np.int32)
    want = in_process(twin, [(prompt, 3)])[0]
    out = {}
    for name, rep in (("port", pools.port[0]), ("ref", pools.ref[0])):
        spec = (request_spec if name == "port"
                else jax_serving.request_spec)(prompt, 3)
        base = rep.progress()[1]
        rep.submit(spec, ("bye", 0))
        for _ in range(64):
            rep.step()
            if rep.progress()[1] - base >= 3:   # decoded, never polled
                break
        tokens, finished, _ = rep.shutdown()
        fin = [f for f in finished if f[0] == ("bye", 0)]
        out[name] = (rep.alive, rep.exit_code, len(tokens[("bye", 0)]),
                     [f[1] for f in fin], rep.shutdown())
        if name == "port":
            got, final = tokens[("bye", 0)], fin[0][2].numpy()
    assert out["port"] == out["ref"]
    assert out["port"] == (False, 0, 3, ["ok"], ({}, [], []))
    np.testing.assert_array_equal(final, want)
    assert got == want[0, prompt.shape[1]:].tolist()


def test_chip_smoke_subprocess_run_on_the_cpu(monkeypatch):
    """Phase 6r(b)'s run (``chip_smoke.subprocess_run``) with two CPU
    workers of ``chip_smoke:replica_engine`` on a narrow cut: no problem
    found — every stream the in-process engine's, r1 SIGKILLed
    mid-decode (exit -9, its streams with emitted tokens requeued), the
    respawned r1 serving later arrivals, both shutdowns 0 — and the
    record carries the spawn seconds and the RPC times."""
    import chip_smoke
    from test_torch_serving_router import CUT_KW

    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # the workers inherit it
    model = chip_smoke.replica_engine(**CUT_KW)._model
    reqs = chip_smoke.traffic(512)
    want = in_process_cut(model, reqs, chip_smoke)
    rec, problems = chip_smoke.subprocess_run(reqs, want,
                                              chip_smoke.NEW_TOKENS, CUT_KW)
    assert problems == []
    assert rec["exit_codes"] == {"kill": -9, "shutdown": [0, 0]}
    assert rec["served_after_respawn"]
    assert any(rec["emitted_before_kill"].values())
    assert len(rec["spawn_s"]) == 2 and rec["respawn_s"] > 0
    assert rec["step_rpc_ms"] > 0 and rec["poll_rpc_ms"] > 0


def in_process_cut(model, reqs, chip_smoke):
    """The streams of ``reqs`` from one in-process engine on phase 5's
    settings."""
    eng = PagedContinuousBatchingEngine(model, device="cpu",
                                        **chip_smoke.SERVE)
    return chip_smoke.serve_streams(eng, reqs, chip_smoke.NEW_TOKENS)
