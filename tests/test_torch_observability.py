"""Observability of the port (``mxtpu_torch.observability``: the tracer,
the flight recorder, the metrics registry) held against the JAX
reference.

The unit cases are tests/test_observability.py's that need no gateway,
replica, transport or profiler module, run on the port's copies.  The
cross-framework cases drive one traffic mix through the reference's
engine and the port's on the same bridged weights, each under its own
package's tracer, flight recorder and fault plan: the two
``get_tracer().to_json()`` and the two ``get_flight().to_json()`` must be
byte-equal.  Events carry counts, positions and page ids, never tokens,
so a seeded sampled stream (threefry in JAX, torch.Generator in the port)
traces alike as long as its lengths do.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import llama_tiny as jax_llama_tiny, \
    transformer_lm_sharding_rules
from mxtpu.observability import flight_recording as jax_flight_recording
from mxtpu.observability import tracing as jax_tracing
from mxtpu.observability.trace import EVENT_TYPES as JAX_EVENT_TYPES
from mxtpu.parallel import ContinuousBatchingEngine as JaxSlotEngine
from mxtpu.parallel import PagedContinuousBatchingEngine as JaxPagedEngine
from mxtpu.parallel.mesh import DeviceMesh
from mxtpu.resilience import fault_plan as jax_fault_plan
from mxtpu_torch import base
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import TransformerLM, llama_tiny
from mxtpu_torch.observability import (EVENT_TYPES, MetricsRegistry,
                                       export_chrome_trace, flight_recording,
                                       get_flight, get_registry, get_tracer,
                                       tracing)
from mxtpu_torch.parallel.serving import (ContinuousBatchingEngine,
                                          PagedContinuousBatchingEngine)
from mxtpu_torch.resilience import fault_plan
from mxtpu_torch.resilience.faults import SITES, inject

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAXLEN = 32
VOCAB = 50
KINDS = ["slot", "paged"]


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


@pytest.fixture(autouse=True)
def _clean_tracer():
    yield
    get_tracer().reset()


def _bridge(ref, port):
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    load_mxtpu_params(port, {k: v.data().asnumpy()
                             for k, v in ref.collect_params().items()})
    return ref, port


@pytest.fixture(scope="module")
def tiny():
    """llama_tiny, vocab 50, float32, seed 77, bridged."""
    mx.random.seed(77)
    ref = jax_llama_tiny(vocab_size=VOCAB)
    ref.initialize()
    return _bridge(ref, llama_tiny(vocab_size=VOCAB, device="cpu"))


@pytest.fixture(scope="module")
def cycling():
    """The speculative tests' cycling micro-model (seed 1, vocab 20), so
    drafts are proposed and accepted."""
    mx.random.seed(1)
    ref = JaxLM(20, units=32, hidden_size=64, num_layers=1, num_heads=4,
                num_kv_heads=2)
    ref.initialize()
    return _bridge(ref, TransformerLM(20, 32, 64, 1, 4, 2, device="cpu"))


def _engine(kind, model, **kw):
    kw = dict(dict(num_slots=2, max_length=MAXLEN), **kw)
    if kind == "paged":
        kw = dict(dict(block_size=8, prefill_chunk=8), **kw)
        return PagedContinuousBatchingEngine(model, device="cpu", **kw)
    return ContinuousBatchingEngine(model, device="cpu", **kw)


def _jax_engine(kind, ref, **kw):
    kw = dict(dict(num_slots=2, max_length=MAXLEN), **kw)
    cls = JaxSlotEngine
    if kind == "paged":
        kw = dict(dict(block_size=8, prefill_chunk=8), **kw)
        cls = JaxPagedEngine
    return cls(ref, DeviceMesh(dp=1), transformer_lm_sharding_rules(), **kw)


def _mix_prompts():
    """Two prompts over one 11-token prefix (a full page and a
    copy-on-write edge), three others of assorted lengths."""
    rng = np.random.RandomState(0)
    shared = rng.randint(0, VOCAB, (1, 11))
    a = np.concatenate([shared, rng.randint(0, VOCAB, (1, 6))], axis=1)
    b = np.concatenate([shared, rng.randint(0, VOCAB, (1, 4))], axis=1)
    return [a, b] + [rng.randint(0, VOCAB, (1, n)) for n in (5, 19, 3)]


#: greedy, seeded sampled, two with retries; request 2 fails at its
#: second decode step (no retries left), request 4 fails its first
#: admission and retries
MIX_KW = [{}, dict(temperature=0.8, top_k=8, seed=5), {}, {},
          dict(retries=1, temperature=0.7, seed=3)]
MIX_PLAN = ("serving.step#2@2:raise=RuntimeError(boom);"
            "serving.admit#4@1:raise=OSError(flaky)")


def _drive(eng, array, reqs, plan, tracing_cm, flight_cm, plan_cm,
           warm=3):
    """Submit the first request, step ``warm`` iterations (its prompt
    pages register), submit the rest and drain, under the package's
    tracer, flight recorder and fault plan.  Returns (trace JSON, flight
    JSON, outputs)."""
    with tracing_cm() as tr, flight_cm(64) as fl, plan_cm(plan):
        (p0, n0, k0), rest = reqs[0], reqs[1:]
        eng.submit(array(p0), n0, **k0)
        for _ in range(warm):
            eng.step()
        for p, n, k in rest:
            eng.submit(array(p), n, **k)
        out = eng.run()
        return tr.to_json(), fl.to_json(), out


def _both(models, kind, reqs, plan="", warm=3, **kw):
    ref, port = models
    j = _drive(_jax_engine(kind, ref, **kw),
               lambda p: nd.array(np.asarray(p), dtype="int32"), reqs, plan,
               jax_tracing, jax_flight_recording, jax_fault_plan, warm)
    p = _drive(_engine(kind, port, **kw),
               lambda p: np.asarray(p, np.int32), reqs, plan,
               tracing, flight_recording, fault_plan, warm)
    return j, p


def _assert_same_bytes(j, p):
    if j[0] != p[0]:
        a, b = json.loads(j[0])["events"], json.loads(p[0])["events"]
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
        raise AssertionError("traces part at event %d: reference %r, port "
                             "%r (%d vs %d events)"
                             % (first, a[first:first + 1], b[first:first + 1],
                                len(a), len(b)))
    assert j[1] == p[1]


# ---------------------------------------------------------------- tracer

def test_event_types_are_the_references():
    assert sorted(EVENT_TYPES) == sorted(JAX_EVENT_TYPES)
    for site in SITES:
        assert "fault." + site in EVENT_TYPES


def test_tracer_off_by_default_emit_is_noop():
    tr = get_tracer()
    assert not tr.enabled and not tr.active
    assert tr.emit("engine.decode", rid="eng:0", pos=1) is None
    assert tr.events() == []


def test_emit_unknown_event_type_raises():
    with tracing() as tr:
        with pytest.raises(ValueError, match="unregistered trace event"):
            tr.emit("engine.decoed", rid="eng:0")


def test_tracing_context_restores_prior_state():
    assert not get_tracer().enabled
    with tracing() as tr:
        assert tr.enabled
        with tracing():         # nested: stays enabled afterwards
            pass
        assert tr.enabled
    assert not get_tracer().enabled


def test_span_pairs_and_alias_resolution():
    with tracing() as tr:
        tr.alias("eng:0", "gw:5")
        with tr.span("engine.iteration", tag="eng"):
            tr.emit("engine.decode", rid="eng:0", pos=3)
        evs = tr.events()
        assert [e.phase for e in evs] == ["B", "I", "E"]
        assert [e.tick for e in evs] == [1, 2, 3]
        assert evs[1].rid == "gw:5"
        assert tr.timeline("gw:5") == [evs[1]]
        assert tr.timeline("eng:0") == [evs[1]]
        assert tr.span_count() == 1


@pytest.mark.parametrize("value,on", [("1", True), ("on", True),
                                      ("0", False), ("off", False),
                                      ("", False)])
def test_ambient_mxtpu_trace(monkeypatch, value, on):
    """``MXTPU_TRACE`` switches a tracer on when it is built."""
    from mxtpu_torch.observability.trace import Tracer
    monkeypatch.setenv("MXTPU_TRACE", value)
    tr = Tracer()
    assert tr.enabled is on and tr.active is on
    assert (tr.emit("engine.decode", rid="eng:0", pos=1) is None) is not on


def test_max_events_counts_dropped(monkeypatch):
    monkeypatch.setenv("MXTPU_TRACE_EVENTS", "5")
    from mxtpu_torch.observability.trace import Tracer
    tr = Tracer(enabled=True)
    for i in range(8):
        tr.emit("engine.decode", rid="eng:0", pos=i)
    assert len(tr.events()) == 5 and tr.dropped_events == 3
    assert json.loads(tr.to_json())["dropped"] == 3
    assert tr.stats()["ticks"] == 8


def test_wall_noise_is_kept_out_of_the_deterministic_json(monkeypatch):
    monkeypatch.setenv("MXTPU_TRACE_WALL", "1")
    from mxtpu_torch.observability.trace import Tracer
    tr = Tracer(enabled=True)
    with tr.span("engine.iteration", step=0):
        pass
    assert "wall_s" in tr.events()[1].noise
    assert "noise" not in tr.to_json()
    assert "wall_s" in tr.to_json(include_noise=True)


@pytest.mark.parametrize("site", SITES)
def test_fault_site_event_matrix(site):
    """Every declared site's firing lands under ``fault.<site>``."""
    with tracing() as tr:
        with fault_plan("%s@1:raise" % site):
            with pytest.raises(Exception):
                inject(site, key=1)
        (ev,) = tr.events(types="fault." + site)
        assert ev.fields == {"site": site, "action": "raise", "hit": 1,
                             "key": "1"}


def test_fault_delay_and_unregistered_site_events():
    with tracing() as tr:
        with fault_plan("serving.step@1:delay=0.5", sleep=lambda s: None):
            inject("serving.step", key=9)
        (ev,) = tr.events(types="fault.serving.step")
        assert ev.fields["action"] == "delay"
        with fault_plan("tests.private.site@1:raise"):
            with pytest.raises(Exception):
                inject("tests.private.site")
        (ev,) = tr.events(types="fault.unregistered")
        assert ev.fields["site"] == "tests.private.site"


def test_alias_map_bounded():
    from mxtpu_torch.observability.trace import MAX_ALIASES
    with tracing() as tr:
        for i in range(MAX_ALIASES + 7):
            tr.alias("eng:%d" % i, "gw:%d" % i)
        assert len(tr._alias) == MAX_ALIASES
        assert tr.resolve("eng:0") == "eng:0"           # evicted
        newest = MAX_ALIASES + 6
        assert tr.resolve("eng:%d" % newest) == "gw:%d" % newest
        tr.alias("eng:%d" % newest, "gw:%d" % newest)
        assert len(tr._alias) == MAX_ALIASES


def test_span_is_a_profiler_range_only_while_profiling():
    """Under a recording torch.profiler a span is a ``record_function``
    range of its event type; otherwise no range is opened."""
    from mxtpu_torch.observability import trace
    assert trace._profiler_annotation("engine.iteration") is None
    with tracing() as tr, torch.profiler.profile() as prof:
        with tr.span("engine.iteration", step=0):
            torch.ones(4).add_(1)
    assert "engine.iteration" in {e.key for e in prof.key_averages()}


# -------------------------------------------------------- flight recorder

def test_flight_ring_buffer_bounds():
    with tracing(), flight_recording(buffer=4) as fl:
        tr = get_tracer()
        for i in range(10):
            tr.emit("engine.decode", rid="eng:0", pos=i)
        tl = fl.timeline("eng:0")
        assert [e.fields["pos"] for e in tl] == [6, 7, 8, 9]


def test_flight_failure_inactive_is_noop():
    fl = get_flight()
    assert not fl.active
    assert fl.failure("quarantine", rids=("eng:0",)) is None


def test_flight_recording_restores_ambient_state():
    fl = get_flight()
    assert not fl.active
    prev_buffer = fl.buffer
    try:
        fl.enable(buffer=96, reset=True)      # as MXTPU_FLIGHT_BUFFER does
        with flight_recording(buffer=8) as scoped:
            assert scoped is fl and fl.buffer == 8
        assert fl.active and fl.buffer == 96
    finally:
        fl.disable()
        fl._buffer = prev_buffer
    with flight_recording(buffer=8):
        pass
    assert not fl.active and fl.buffer == prev_buffer


def test_ambient_flight_buffer_import_order():
    """MXTPU_FLIGHT_BUFFER arms the recorder at import; its baseline is
    taken before the counters module exists, and a later failure still
    reads a correct counters delta."""
    code = (
        "from mxtpu_torch.observability import get_flight\n"
        "fl = get_flight()\n"
        "assert fl.active and fl.buffer == 48, (fl.active, fl.buffer)\n"
        "from mxtpu_torch.resilience.counters import bump\n"
        "bump('probe_counter', 3)\n"
        "pm = fl.failure('shed', context='bootstrap-probe')\n"
        "assert pm.counters == {'probe_counter': 3}, pm.counters\n"
        "import sys\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'mxtpu')]\n")
    env = dict(os.environ, MXTPU_FLIGHT_BUFFER="48", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]


def test_ckpt_corruption_flight_postmortem(tmp_path):
    from mxtpu_torch.resilience import checkpoint as ckpt

    with flight_recording(buffer=16) as fl:
        cs = ckpt.CheckpointSet(str(tmp_path), keep=3)
        cs.save(0, b"good-0")
        cs.save(1, b"good-1")
        buf = bytearray(open(cs.path(1), "rb").read())
        buf[0] ^= 0xFF
        open(cs.path(1), "wb").write(bytes(buf))
        assert cs.latest_verified() == (0, b"good-0")
        (pm,) = fl.postmortems
        assert pm.kind == "ckpt_corruption"
        assert pm.context["step"] == 1
        assert pm.context["file"] == os.path.basename(cs.path(1))
        assert pm.counters.get("ckpt_corruptions") == 1


# --------------------------------------------------------- engine traces

def test_timeline_covers_request_path(tiny):
    """A shared-prefix pair on the paged engine: the second request's
    timeline runs admission → prefix hit → copy-on-write → prefill chunk
    → decode → finish, in tick order."""
    pa, pb = _mix_prompts()[:2]
    eng = _engine("paged", tiny[1])
    with tracing() as tr:
        eng.submit(pa, 3)
        for _ in range(3):
            eng.step()
        rb = eng.submit(pb, 3)
        eng.run()
        tl = tr.timeline("eng:%d" % rb)
        kinds = [e.etype for e in tl]
        assert kinds[0] == "engine.admit" and kinds[-1] == "engine.finish"
        for k in ("engine.prefix_hit", "engine.cow", "engine.prefill_chunk",
                  "engine.decode"):
            assert k in kinds, kinds
        assert [e.tick for e in tl] == sorted(e.tick for e in tl)
        hit = next(e for e in tl if e.etype == "engine.prefix_hit")
        assert hit.fields == {"tokens": 11, "pages": 1, "session": False}
        assert tl[-1].fields == {"status": "ok", "emitted": 3}
        assert tr.span_count() > 0 and tr.dropped_events == 0


@pytest.mark.parametrize("kind", KINDS)
def test_trace_and_flight_json_equal_reference(tiny, kind):
    """Greedy and seeded requests over a shared prefix, one request
    quarantined for good and one retried: the trace and the flight
    recorder's postmortems are byte-equal to the reference's."""
    reqs = [(p, 4, k) for p, k in zip(_mix_prompts(), MIX_KW)]
    j, p = _both(tiny, kind, reqs, MIX_PLAN)
    _assert_same_bytes(j, p)
    events = json.loads(p[0])["events"]
    types = {e["type"] for e in events}
    want = {"engine.iteration", "engine.admit", "engine.decode",
            "engine.quarantine", "engine.requeue", "engine.finish",
            "fault.serving.step", "fault.serving.admit"}
    if kind == "paged":
        want |= {"engine.prefill_chunk", "engine.prefix_hit", "engine.cow"}
    assert want <= types, want - types
    posts = json.loads(p[1])["postmortems"]
    assert [pm["kind"] for pm in posts] == ["quarantine", "quarantine"]
    assert {pm["counters"]["quarantined_slots"] for pm in posts} == {1, 2}
    finals = {e["rid"]: e["fields"]["status"] for e in events
              if e["type"] == "engine.finish"}
    assert finals == {"eng:0": "ok", "eng:1": "ok", "eng:2": "failed",
                      "eng:3": "ok", "eng:4": "ok"}


@pytest.mark.parametrize("spec", [dict(spec_k=3), dict(spec_tree=(6, 2))],
                         ids=["linear", "tree"])
def test_speculative_trace_equal_reference(cycling, spec):
    """Greedy speculation on the cycling model: the draft and verify
    events (drafted and accepted counts, tree or not) equal the
    reference's."""
    fork = [1, 2, 3, 1, 2, 4, 1, 2, 3, 1, 2]
    reqs = [([fork], 12, {}), ([[5, 6, 7, 5, 6, 8, 5, 6]], 10, {}),
            ([[9, 3, 2, 9, 3, 5, 9]], 8, {})]
    j, p = _both(cycling, "paged", reqs, max_length=48, **spec)
    _assert_same_bytes(j, p)
    verify = [e for e in json.loads(p[0])["events"]
              if e["type"] == "engine.verify"]
    assert verify and sum(e["fields"]["accepted"] for e in verify) > 0
    # a tree iteration marks each row's window, tree or not (a row that
    # drafted nothing rides it too); a linear one carries no such field
    if "spec_tree" in spec:
        assert any(e["fields"]["tree"] for e in verify)
    else:
        assert not any("tree" in e["fields"] for e in verify)


def test_hierarchy_trace_equal_reference(tiny):
    """Pinned chains spilled to the host tier and restored: the swap
    events (and the prefix hits they feed) equal the reference's."""
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, VOCAB, (1, 17))
    filler = [rng.randint(0, VOCAB, (1, 9)) for _ in range(2)]
    reqs = [(prompt, 3, {})] + [(f, 3, {}) for f in filler] + \
        [(np.concatenate([prompt, rng.randint(0, VOCAB, (1, 2))], 1), 3,
          {})]
    j, p = _both(tiny, "paged", reqs, warm=8, pin_bytes=1,
                 host_cache_bytes="1MiB")
    _assert_same_bytes(j, p)
    types = {e["type"] for e in json.loads(p[0])["events"]}
    assert {"engine.swap_out", "engine.swap_in", "engine.prefix_hit"} <= types


def test_tracer_off_streams_equal_traced(tiny):
    """Tracing changes no result: the same engine serves one workload
    untraced and traced, token for token, and records nothing untraced."""
    reqs = [(p, 4, k) for p, k in zip(_mix_prompts(), MIX_KW)]
    eng = _engine("paged", tiny[1])

    def run():
        rids = [eng.submit(p, n, **k) for p, n, k in reqs]
        out = eng.run()
        return [out[r].numpy() for r in rids]

    plain = run()
    assert get_tracer().events() == []
    with tracing() as tr, flight_recording(16):
        traced = run()
        assert tr.events()
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


def test_chrome_trace_export_shape(tiny, tmp_path):
    eng = _engine("paged", tiny[1])
    with tracing():
        eng.submit(_mix_prompts()[0], 3)
        eng.run()
        text = export_chrome_trace()
        export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.loads(text)
    assert json.loads((tmp_path / "t.json").read_text()) == doc
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} == {"B", "E", "i"}
    assert all(e["cat"] == "mxtpu" and e["pid"] == 0 for e in evs)
    assert [e["ts"] for e in evs] == sorted(e["ts"] for e in evs)
    assert all(e["s"] == "t" for e in evs if e["ph"] == "i")
    req = [e for e in evs if e["args"].get("rid") == "eng:0"]
    assert req[0]["name"] == "engine.admit" and req[0]["tid"] == 1
    assert sum(e["ph"] == "B" for e in evs) == sum(e["ph"] == "E"
                                                   for e in evs)


# ------------------------------------------------------- metrics registry

def test_registry_flatten_snapshot_and_delta():
    reg = MetricsRegistry()
    reg.register_source("a", lambda: {"x": 1, "nested": {"y": 2.5,
                                                         "flag": True},
                                      "skip": "str", "bad": {3: 4}})
    snap = reg.snapshot()
    assert snap == {"a.x": 1, "a.nested.y": 2.5, "a.nested.flag": 1}
    reg.register_source("a", lambda: {"x": 4, "nested": {"y": 2.5}},
                        replace=True)
    assert reg.delta(snap) == {"a.x": 3}
    assert reg.delta(snap, include_zero=True)["a.nested.y"] == 0


def test_registry_register_stats_and_prometheus(tiny):
    eng = _engine("paged", tiny[1])
    reg = MetricsRegistry()
    reg.register_stats("engine0", eng)
    before = reg.snapshot()
    eng.submit(_mix_prompts()[0], 3)
    eng.run()
    d = reg.delta(before)
    # 2 decode-step tokens: the first of the 3 samples at prefill
    assert d["engine0.generated_tokens"] == 2
    assert d["engine0.steps"] > 0
    prom = reg.to_prometheus()
    assert "# TYPE mxtpu_engine0_generated_tokens gauge" in prom
    assert "mxtpu_engine0_generated_tokens 2" in prom
    assert json.loads(reg.to_json())["engine0.generated_tokens"] == 2
    reg.unregister("engine0")
    assert reg.sources() == []


def test_registry_source_errors_and_misuse():
    reg = MetricsRegistry()
    reg.register_source("boom", lambda: 1 / 0)
    assert reg.snapshot() == {"boom.source_error": 1}
    with pytest.raises(ValueError, match="already registered"):
        reg.register_source("boom", dict)
    with pytest.raises(TypeError):
        reg.register_source("x", 42)
    with pytest.raises(TypeError):
        reg.register_stats("y", object())
    with pytest.raises(KeyError):
        reg.snapshot(sources=("nope",))


def test_process_registry_builtin_sources(tiny):
    """resilience, tracer, flight and kernel_invocations; the last reads
    the kernel wrappers' launch counters (their plain versions on the
    CPU)."""
    reg = get_registry()
    assert reg.sources() == ["flight", "kernel_invocations", "resilience",
                             "tracer"]
    snap = reg.snapshot(sources=("resilience", "tracer", "flight"))
    for key in ("resilience.quarantined_slots", "resilience.adoptions",
                "tracer.events", "flight.postmortems"):
        assert key in snap
    base.reset_counts()
    eng = _engine("paged", tiny[1])
    eng.submit(_mix_prompts()[0], 3)
    eng.run()
    kern = reg.snapshot(sources=("kernel_invocations",))
    assert kern["kernel_invocations.paged_attention"] == 2 * 2   # 2 layers
    assert kern["kernel_invocations.paged_prefill"] == 3 * 2     # 3 chunks
