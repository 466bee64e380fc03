"""The engines' fault contract in the port (fault plans, quarantine,
retries, deadlines, bounded admission) held against the JAX reference:
the fault-plan grammar against ``mxtpu.resilience.faults`` on the same
specs, and tests/test_serving_faults.py's scenarios replayed on both
engines (the slot engine and the paged one) in both frameworks on the
same weights (the weight bridge).

Each scenario runs the same requests and the same plan spec through the
reference engine and the port's: greedy streams (finished, failed or
expired) must be token-identical, statuses, error records and the
resilience stats equal, and each plan's per-site hits and firings
equal.  Seeded sampled streams must equal the port's own ``generate``
(JAX draws with threefry, the port with torch.Generator).  Deadlines
run on one injected clock: no real sleeps.
"""

import contextlib

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import llama_tiny as jax_llama_tiny, \
    transformer_lm_sharding_rules
from mxtpu.parallel import ContinuousBatchingEngine as JaxSlotEngine
from mxtpu.parallel import PagedContinuousBatchingEngine as JaxPagedEngine
from mxtpu.parallel.mesh import DeviceMesh
from mxtpu.resilience import faults as jax_faults
from mxtpu_torch.base import LoadShedError, MXTPUError
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import TransformerLM, llama_tiny
from mxtpu_torch.parallel.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)
from mxtpu_torch.resilience import faults
from mxtpu_torch.resilience.counters import counters as fault_counters

MAXLEN = 32
KINDS = ["slot", "paged"]
KEYS = ("steps", "generated_tokens", "quarantined_requests",
        "retried_requests", "expired_requests", "shed_requests",
        "drafted_tokens", "accepted_tokens", "verify_calls")
PAGED_KEYS = ("blocks_in_use", "blocks_free", "prefix_hit_requests",
              "cow_copied_blocks")
CLK = {"t": 0.0}        # the engines' injected clock


@pytest.fixture(scope="module", autouse=True)
def _compile_ledger_left_as_found():
    """The JAX engines built here compile many pool shapes into the
    process-wide compile ledger, which later tests in the same process
    read (``check_compiles``): leave it as this module found it."""
    import copy

    from mxtpu.analysis.compile_ledger import get_ledger

    led = get_ledger()
    with led._lock:
        saved = copy.deepcopy((led._sites, led._seen, led._seq))
    yield
    with led._lock:
        led._sites, led._seen, led._seq = saved


# -------------------------------------------------- the plan grammar

SPECS = [
    "serving.step@3:raise=OSError",
    "serving.step#7@2:raise=RuntimeError(poisoned)",
    "serving.admit@1+:raise=OSError(disk full)",
    "serving.swap_in#4@1x2:raise=MXTPUError(dma)",
    "serving.verify%3:raise",
    "serving.draft@2%2:raise=InjectedFault(x)",
    "serving.step@2:delay=0.25; serving.admit#1:raise=KeyError(k)",
    "serving.block_alloc@4x3:delay",
    "site.private-1#a.b@5+:raise=ValueError(with (parens))",
]


def _rule_fields(rule):
    return (rule.site, rule.key, rule.at, rule.count, rule.always,
            rule.period, rule.action, rule.exc.__name__, rule.message,
            rule.seconds)


@pytest.mark.parametrize("spec", SPECS)
def test_plan_grammar_parses_as_the_reference(spec):
    assert [_rule_fields(r) for r in faults.FaultPlan(spec).rules] == \
        [_rule_fields(r) for r in jax_faults.FaultPlan(spec).rules]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_fires_at_the_reference_hits(spec):
    """The same seeded stream of inject() calls through both plans:
    the same calls raise (the same exception type and message), the
    same delays sleep, and per-site stats() agree."""
    rng = np.random.RandomState(len(spec))
    sites = sorted({r.site for r in faults.FaultPlan(spec).rules}
                   | {"serving.step"})
    calls = [(sites[rng.randint(len(sites))],
              [None, 1, 4, 7, "a.b"][rng.randint(5)]) for _ in range(60)]

    def drive(mod):
        slept, out = [], []
        with mod.fault_plan(spec, sleep=slept.append) as plan:
            for site, key in calls:
                try:
                    mod.inject(site, key=key)
                    out.append(None)
                except Exception as exc:   # noqa: BLE001 — any raise rule
                    out.append((type(exc).__name__, str(exc)))
        return out, slept, plan.stats()

    assert drive(faults) == drive(jax_faults)


@pytest.mark.parametrize("spec", ["serving.step", "serving.step@x:raise",
                                  "serving.step:explode",
                                  "serving.step:raise=NotAnError",
                                  "serving.step:delay=soon",
                                  "serving.step:raise=bad spec("])
def test_plan_grammar_errors_as_the_reference(spec):
    with pytest.raises(ValueError):
        jax_faults.FaultPlan(spec)
    with pytest.raises(ValueError):
        faults.FaultPlan(spec)


def test_env_plan_and_scoped_plan_precedence(monkeypatch):
    """MXTPU_FAULT_PLAN is the ambient plan; a scoped plan wins on its
    thread; counters record the firings."""
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "serving.admit@2:raise=OSError(env)")
    try:
        env = faults.reload_env_plan()
        before = fault_counters()["faults_injected"]
        faults.inject("serving.admit")
        with pytest.raises(OSError, match="env"):
            faults.inject("serving.admit")
        assert env.stats() == {"serving.admit": {"hits": 2, "fired": 1}}
        with faults.fault_plan("serving.admit:raise=KeyError") as scoped:
            assert faults.active_plan() is scoped
            with pytest.raises(KeyError):
                faults.inject("serving.admit")
        assert faults.active_plan() is env
        assert faults.site_stats() == env.stats()
        assert fault_counters()["faults_injected"] == before + 2
    finally:
        monkeypatch.delenv("MXTPU_FAULT_PLAN")
        faults.reload_env_plan()
    assert faults.active_plan() is None and faults.site_stats() == {}


# ---------------------------------------------------- the engine twins

def _bridge(ref, port):
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    load_mxtpu_params(port, {k: v.data().asnumpy()
                             for k, v in ref.collect_params().items()})
    return ref, port


@pytest.fixture(scope="module")
def tiny():
    """tests/test_serving_faults.py's model: llama_tiny, vocab 50, seed
    77."""
    mx.random.seed(77)
    ref = jax_llama_tiny(vocab_size=50)
    ref.initialize()
    return _bridge(ref, llama_tiny(vocab_size=50, device="cpu"))


@pytest.fixture(scope="module")
def cycling():
    """The speculative tests' cycling micro-model (seed 1, vocab 20), so
    the draft and verify sites fire."""
    mx.random.seed(1)
    ref = JaxLM(20, units=32, hidden_size=64, num_layers=1, num_heads=4,
                num_kv_heads=2)
    ref.initialize()
    return _bridge(ref, TransformerLM(20, 32, 64, 1, 4, 2, device="cpu"))


class FaultTwin:
    """One engine kind and configuration in both frameworks, driven in
    lockstep (both number requests from 0)."""

    def __init__(self, models, kind, **kw):
        ref, self.model = models
        kw = dict(dict(num_slots=2, max_length=MAXLEN,
                       clock=lambda: CLK["t"]), **kw)
        self.kind = kind
        self.max_length = kw["max_length"]
        if kind == "paged":
            kw = dict(dict(block_size=8, prefill_chunk=8), **kw)
            self.j = JaxPagedEngine(ref, DeviceMesh(dp=1),
                                    transformer_lm_sharding_rules(), **kw)
            self.p = PagedContinuousBatchingEngine(self.model, device="cpu",
                                                   **kw)
        else:
            self.j = JaxSlotEngine(ref, DeviceMesh(dp=1),
                                   transformer_lm_sharding_rules(), **kw)
            self.p = ContinuousBatchingEngine(self.model, device="cpu", **kw)
        self.sampled = {}

    @property
    def engines(self):
        return (self.j, self.p)

    def submit(self, prompt, n, **kw):
        prompt = np.asarray(prompt, np.int32)
        rj = self.j.submit(nd.array(prompt, dtype="int32"), n, **kw)
        rp = self.p.submit(prompt, n, **kw)
        assert rj == rp
        if kw.get("temperature"):
            self.sampled[rp] = (prompt, n, kw)
        return rp

    def step(self):
        self.j.step()
        self.p.step()

    def run(self):
        """Drain both and hold them together; the port's results."""
        jres, pres = self.j.run(), self.p.run()
        assert sorted(jres) == sorted(pres)
        for rid in pres:
            got = pres[rid].numpy()
            if rid in self.sampled:
                prompt, n, kw = self.sampled[rid]
                if self.p.status(rid) == "ok":
                    want = self.model.generate(
                        torch.from_numpy(prompt), n,
                        max_length=self.max_length,
                        **{k: v for k, v in kw.items()
                           if k in ("temperature", "top_k", "seed")}).numpy()
                    np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_array_equal(got, jres[rid].asnumpy())
            # (a status past ``history`` is forgotten in both)
            assert self.status(rid) in ("ok", "failed", "expired",
                                        "unknown")
            assert self.p.error(rid) == self.j.error(rid)
        self.check()
        return {rid: r.numpy() for rid, r in pres.items()}

    def check(self):
        keys = KEYS + (PAGED_KEYS if self.kind == "paged" else ())
        if self.sampled and self.p._spec_on:
            # a sampled stream drafts its own tokens in each framework
            keys = tuple(k for k in keys if k not in (
                "steps", "drafted_tokens", "accepted_tokens",
                "verify_calls"))
        sj, sp = self.j.stats, self.p.stats
        assert {k: sj[k] for k in keys} == {k: sp[k] for k in keys}
        assert self.p.free_slots == self.j.free_slots
        assert self.p.pending == self.j.pending
        if self.kind == "paged":
            assert self.p._slot_pages == self.j._slot_pages
            assert self.p._bp._free == self.j._bp._free

    def status(self, rid):
        st = self.p.status(rid)
        assert self.j.status(rid) == st
        return st

    @contextlib.contextmanager
    def plan(self, spec):
        with jax_faults.fault_plan(spec) as jp, faults.fault_plan(spec) as pp:
            yield pp
        assert jp.stats() == pp.stats()


@pytest.fixture(scope="module", params=KINDS)
def tw(request, tiny):
    """ONE twin of each engine kind serves every scenario (as the
    reference's module engine does), over the injected clock."""
    return FaultTwin(tiny, request.param)


@pytest.fixture(params=KINDS)
def spec_tw(request, cycling):
    return FaultTwin(cycling, request.param, max_length=64, spec_k=3)


def _prompts(rng, lengths, vocab=50):
    return [rng.randint(0, vocab, (1, t)) for t in lengths]


def test_quarantine_preserves_other_streams_and_retry_completes(tw):
    """A ``serving.step`` failure in r2's slot quarantines only it: r1
    and r3 (which backfills the row) stream as without the fault, and
    r2's retry restarts from scratch and completes."""
    p1, p2, p3 = _prompts(np.random.RandomState(3), (3, 5, 4))
    before = tw.p.stats
    r1 = tw.submit(p1, 6)
    r2 = tw.submit(p2, 5, retries=1)
    tw.submit(p3, 4)
    with tw.plan("serving.step#%d@2:raise=RuntimeError(poisoned)"
                 % r2) as plan:
        tw.run()
    assert plan.stats()["serving.step"]["fired"] == 1
    assert tw.status(r2) == "ok" and tw.status(r1) == "ok"
    err = tw.p.error(r2)
    assert err["type"] == "RuntimeError" and err["site"] == "serving.step"
    after = tw.p.stats
    assert after["quarantined_requests"] - before["quarantined_requests"] == 1
    assert after["retried_requests"] - before["retried_requests"] == 1


def test_quarantine_without_retries_fails_with_partial_output(tw):
    """No retry budget: ``failed``, an error record, and the tokens
    emitted before the fault, a prefix of the fault-free stream."""
    p1, p2 = _prompts(np.random.RandomState(7), (4, 6))
    tw.submit(p1, 6)
    r2 = tw.submit(p2, 5)
    with tw.plan("serving.step#%d@3:raise=RuntimeError(dead)" % r2):
        res = tw.run()
    assert tw.status(r2) == "failed"
    assert tw.p.error(r2)["error"] == "dead"
    part = res[r2]
    full = tw.model.generate(torch.from_numpy(p2.astype(np.int32)), 5,
                             max_length=MAXLEN).numpy()
    assert p2.shape[1] < part.shape[1] < full.shape[1]
    np.testing.assert_array_equal(part[0], full[0, :part.shape[1]])


def test_sampled_streams_survive_neighbor_quarantine(tw):
    """A seeded sampled stream beside a quarantined slot draws what it
    draws alone."""
    p1, p2 = _prompts(np.random.RandomState(11), (3, 4))
    tw.submit(p1, 6, temperature=0.8, top_k=20, seed=101)
    r2 = tw.submit(p2, 6)
    with tw.plan("serving.step#%d@2:raise=OSError(gone)" % r2):
        tw.run()
    assert tw.status(r2) == "failed"


def test_admission_fault_quarantines_request_not_engine(tw):
    """A ``serving.admit`` failure fails that request only; the row
    stays free and the engine keeps serving."""
    p1, p2 = _prompts(np.random.RandomState(13), (3, 5))
    r1 = tw.submit(p1, 4)
    r2 = tw.submit(p2, 4)
    with tw.plan("serving.admit#%d@1:raise=OSError(oom)" % r1):
        tw.run()
    assert tw.status(r1) == "failed" and tw.status(r2) == "ok"
    assert tw.p.error(r1)["site"] == "serving.admit"


def test_engine_survives_consecutive_poisoned_admissions(tw):
    """Every admission fails (a fail-always plan): each request is
    recorded failed, no row or page leaks, and the next clean request
    streams in full."""
    prompts = _prompts(np.random.RandomState(17), (3, 4, 5, 3, 4))
    with tw.plan("serving.admit@1+:raise=OSError(disk full)"):
        rids = [tw.submit(p, 3) for p in prompts]
        tw.run()
    assert [tw.status(r) for r in rids] == ["failed"] * len(rids)
    assert tw.p.free_slots == 2 and tw.p.pending == 0
    r = tw.submit(prompts[0], 4)
    tw.run()
    assert tw.status(r) == "ok"


def test_fault_scenarios_deterministic_across_reruns(tw):
    """The same plan over the same workload gives the same outputs,
    statuses and firings every time."""
    p1, p2 = _prompts(np.random.RandomState(19), (4, 5))

    def scenario():
        r1 = tw.submit(p1, 5)
        r2 = tw.submit(p2, 4, retries=1)
        with tw.plan("serving.step#%d@2:raise=RuntimeError(x)"
                     % r2) as plan:
            res = tw.run()
        return (res[r1], res[r2], tw.status(r1), tw.status(r2),
                plan.stats()["serving.step"]["fired"])

    a, b = scenario(), scenario()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2:] == b[2:]


def test_deadline_eviction_at_iteration_boundary(tw):
    """A request past its deadline is evicted at the next step()
    boundary as ``expired`` with its partial output; queued requests
    expire without taking a row."""
    t0 = CLK["t"]
    p1, p2, p3 = _prompts(np.random.RandomState(23), (3, 4, 3))
    before = tw.p.stats["expired_requests"]
    ra = tw.submit(p1, 8, deadline_s=5.0)
    rb = tw.submit(p2, 8)
    tw.step()
    tw.step()
    assert tw.status(ra) == "active"
    CLK["t"] = t0 + 10.0
    tw.step()
    assert tw.status(ra) == "expired" and tw.status(rb) == "active"
    assert tw.p.stats["expired_requests"] - before == 1
    rq = tw.submit(p3, 4, deadline_s=-1.0)
    tw.step()
    assert tw.status(rq) == "expired"
    res = tw.run()
    full = tw.model.generate(torch.from_numpy(p1.astype(np.int32)), 8,
                             max_length=MAXLEN).numpy()
    np.testing.assert_array_equal(res[ra][0], full[0, :res[ra].shape[1]])
    np.testing.assert_array_equal(res[rq], p3)


@pytest.mark.parametrize("kind", KINDS)
def test_bounded_admission_sheds_with_typed_error(tiny, kind):
    """max_pending bounds the queue: the overflow submit raises
    LoadShedError (an MXTPUError), nothing is enqueued, the counter
    records it, and its backoff hint is the reference's."""
    tw = FaultTwin(tiny, kind, max_pending=2)
    p = _prompts(np.random.RandomState(29), (3,))[0]
    tw.submit(p, 3)
    tw.submit(p, 3)
    with pytest.raises(LoadShedError, match="max_pending") as got:
        tw.p.submit(p.astype(np.int32), 3)
    with pytest.raises(Exception, match="max_pending") as want:
        tw.j.submit(nd.array(p, dtype="int32"), 3)
    assert issubclass(LoadShedError, MXTPUError)
    for attr in ("queue_depth", "limit", "retry_after_ticks", "permanent"):
        assert getattr(got.value, attr) == getattr(want.value, attr)
    assert tw.p.pending == 2 and tw.p.stats["shed_requests"] == 1
    tw.check()


def test_stats_exposes_resilience_counters(tw):
    for key in ("quarantined_requests", "retried_requests",
                "expired_requests", "shed_requests"):
        assert key in tw.p.stats


def test_paged_admission_sites_quarantine_and_retry(tiny):
    """The paged engine's own admission sites: a ``serving.prefix_lookup``
    or ``serving.block_alloc`` raise quarantines the request before any
    page is held; its retry completes, and no page leaks."""
    tw = FaultTwin(tiny, "paged")
    rng = np.random.RandomState(31)
    shared = rng.randint(0, 50, (1, 10))
    pa = np.concatenate([shared, rng.randint(0, 50, (1, 3))], 1)
    pb = np.concatenate([shared, rng.randint(0, 50, (1, 5))], 1)
    tw.submit(pa, 6)
    tw.step()
    tw.step()
    rb = tw.submit(pb, 5, retries=2)
    spec = ("serving.prefix_lookup#%d@1:raise=KeyError(index);"
            "serving.block_alloc#%d@1:raise=OSError(pool)" % (rb, rb))
    with tw.plan(spec) as plan:
        tw.run()
    assert plan.stats() == {
        "serving.prefix_lookup": {"hits": 3, "fired": 1},
        "serving.block_alloc": {"hits": 2, "fired": 1}}
    assert tw.status(rb) == "ok" and tw.p.error(rb)["site"] == "serving.admit"
    assert tw.p.stats["retried_requests"] == 2
    assert tw.p.stats["blocks_in_use"] == 0


def test_draft_fault_quarantines_only_offending_slot(spec_tw):
    """A ``serving.draft`` fault fails only its request; the sampled
    neighbour's speculative stream draws what it draws alone."""
    p1, p2 = _prompts(np.random.RandomState(3), (6, 5), vocab=20)
    before = spec_tw.p.stats
    spec_tw.submit(p1, 14, temperature=0.8, top_k=10, seed=101)
    r2 = spec_tw.submit(p2, 12)
    with spec_tw.plan("serving.draft#%d@2:raise=OSError(bad-history)"
                      % r2) as plan:
        spec_tw.run()
    assert plan.stats()["serving.draft"]["fired"] == 1
    assert spec_tw.status(r2) == "failed"
    assert spec_tw.p.error(r2)["site"] == "serving.draft"
    assert spec_tw.p.stats["quarantined_requests"] - \
        before["quarantined_requests"] == 1
    assert spec_tw.p.free_slots == 2


def test_verify_fault_retry_completes_bit_identically(spec_tw):
    """A ``serving.verify`` fault quarantines only its slot; the retry
    restarts from scratch and completes."""
    p1, p2 = _prompts(np.random.RandomState(7), (6, 4), vocab=20)
    spec_tw.submit(p1, 14)
    r2 = spec_tw.submit(p2, 12, retries=1)
    with spec_tw.plan("serving.verify#%d@1:raise=RuntimeError(poisoned)"
                      % r2) as plan:
        spec_tw.run()
    assert plan.stats()["serving.verify"]["fired"] == 1
    assert spec_tw.status(r2) == "ok"
    assert spec_tw.p.error(r2)["site"] == "serving.verify"
    assert spec_tw.p.stats["verify_calls"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_terminal_status_history_is_bounded(tiny, kind):
    """Only the last ``history`` terminal requests keep status and
    error records."""
    tw = FaultTwin(tiny, kind, history=4)
    p = _prompts(np.random.RandomState(31), (3,))[0]
    rids = [tw.submit(p, 0) for _ in range(8)]
    with tw.plan("serving.admit@1+:raise=OSError(x)"):
        failed = [tw.submit(p, 2) for _ in range(2)]
        tw.run()
    assert [tw.status(r) for r in rids] == ["unknown"] * 6 + ["ok"] * 2
    assert [tw.status(r) for r in failed] == ["failed"] * 2
    assert tw.p.error(failed[0]) is not None
    more = [tw.submit(p, 0) for _ in range(4)]
    tw.run()
    assert [tw.status(r) for r in more] == ["ok"] * 4
    assert tw.p.error(failed[0]) is None and tw.j.error(failed[0]) is None
