"""Speculative and tree-speculative serving in the port, held against
the JAX reference engine on the same weights (the weight bridge), and
inside the port against its own non-speculative streams.

The model is the reference tests' cycling micro-model
(tests/test_speculative_paged.py: seed 1, vocab 20, 1 layer, 32 units,
4 heads over 2 kv heads), so drafts are accepted and rejected for real;
the branchy prompts are tests/test_tree_speculative.py's.  Across
frameworks, greedy streams must be token-identical and the draft,
accept, verify and tree counters equal (the reference engine's float
pool: its int8 arm is not ported).  Inside the port, greedy, seeded-
sampled and penalized speculative streams must equal the same engine
settings' streams with speculation off and the isolated ``generate``,
token for token.

``verify_pages`` is held against both of the reference's arms (its XLA
gather path, which computes trees through ``_internal_tree_verify_attn``,
and its Pallas kernel in interpret mode) at 1e-4 on the logits, the
tolerance of tests/test_torch_transformer.py."""

import numpy as np
import pytest
import torch

import mxtpu as mx
from chip_smoke import fork_prompts
from mxtpu import nd
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import transformer_lm_sharding_rules
from mxtpu.parallel import PagedContinuousBatchingEngine as JaxEngine
from mxtpu.parallel.mesh import DeviceMesh
from mxtpu_torch import base
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import TransformerLM
from mxtpu_torch.parallel.serving import (PagedContinuousBatchingEngine,
                                          _tree_paths)

MAXLEN = 64
ENGINE = dict(num_slots=3, max_length=MAXLEN, block_size=8, prefill_chunk=8)
TOL = dict(atol=1e-4, rtol=1e-4)
P_FORK = [1, 2, 3, 1, 2, 4, 1, 2, 3, 1, 2]
P_FORK2 = [5, 6, 7, 5, 6, 8, 5, 6, 7, 5, 6]
P_FORK3 = [9, 3, 2, 9, 3, 5, 9, 3, 2, 9, 3]
REQS = [(P_FORK, 20, dict()),
        (P_FORK2, 20, dict(temperature=0.8, seed=7)),
        (P_FORK3, 18, dict(temperature=0.6, seed=9, repetition_penalty=1.3))]
COUNTERS = ("drafted_tokens", "accepted_tokens", "verify_calls",
            "tree_nodes_drafted", "tree_paths", "slot_iterations", "steps")


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


def _jax_engine(ref, **spec):
    return JaxEngine(ref, DeviceMesh(dp=1), transformer_lm_sharding_rules(),
                     **ENGINE, **spec)


def _run_both(models, spec, prompts, overrides=None):
    """The same greedy requests through both engines: streams and the
    counters must agree."""
    ref, port = models
    je = _jax_engine(ref, **spec)
    pe = PagedContinuousBatchingEngine(port, device="cpu", **ENGINE, **spec)
    jr, pr = [], []
    for j, (p, n) in enumerate(prompts):
        kw = overrides(j) if overrides else {}
        jr.append(je.submit(nd.array(np.array([p]), dtype="int32"), n, **kw))
        pr.append(pe.submit(np.array([p], np.int32), n, **kw))
    jres, pres = je.run(), pe.run()
    for a, b in zip(jr, pr):
        np.testing.assert_array_equal(pres[b].numpy(), jres[a].asnumpy())
    js, ps = je.stats, pe.stats
    assert {k: ps[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ps["blocks_in_use"] == 0
    return ps


def test_greedy_linear_speculation_matches_reference(models):
    """spec_k = 3: the reference's paged parity scenario, greedy, with
    a long prompt prefilled in chunks."""
    rng = np.random.RandomState(0)
    prompts = [(list(rng.randint(0, 20, t)), n)
               for t, n in ((6, 12), (4, 10), (5, 8), (24, 10))]
    st = _run_both(models, dict(spec_k=3), prompts)
    assert 0 < st["accepted_tokens"] < st["drafted_tokens"]


def test_greedy_tree_speculation_matches_reference(models):
    """spec_tree = (6, 2) on the float pool, the branchy prompts."""
    st = _run_both(models, dict(spec_tree=(6, 2)),
                   [(P_FORK, 20), (P_FORK2, 20), (P_FORK3, 18)])
    assert st["tree_nodes_drafted"] > 0 and st["tree_paths"] > 0
    assert st["accepted_tokens"] > 0


def test_mixed_pool_matches_reference(models):
    """spec_k = 3 and spec_tree = (6, 2): request 1 drafts linearly
    (spec_tree=False) and rides the tree verify as a chain (the float arm
    of tests/test_tree_speculative.py's mixed-pool scenario)."""
    st = _run_both(models, dict(spec_k=3, spec_tree=(6, 2)),
                   [(P_FORK, 20), (P_FORK2, 20), (P_FORK3, 18)],
                   overrides=lambda j: {"spec_tree": False} if j == 1 else {})
    assert st["drafted_tokens"] > st["tree_nodes_drafted"] > 0


@pytest.mark.parametrize("spec", [dict(spec_k=3), dict(spec_tree=(6, 2)),
                                  dict(spec_k=3, spec_tree=(6, 2))],
                         ids=["linear", "tree", "mixed"])
def test_speculative_streams_equal_plain_streams_and_generate(models, spec):
    """Greedy, seeded-sampled and penalized (and sampled+penalized)
    streams, a shared prefix among them: speculation changes no token."""
    port = models[1]
    reqs = REQS + [(P_FORK + P_FORK2, 14, dict(repetition_penalty=1.3)),
                   (P_FORK + P_FORK3, 12, dict(temperature=0.9, top_p=0.8,
                                               seed=3))]
    outs = {}
    for on in (False, True):
        eng = PagedContinuousBatchingEngine(port, device="cpu", **ENGINE,
                                            **(spec if on else {}))
        rids = [eng.submit(np.array([p], np.int32), n, **kw)
                for p, n, kw in reqs]
        res = eng.run()
        outs[on] = [res[r].numpy() for r in rids]
        assert eng.stats["blocks_in_use"] == 0
    assert eng.stats["accepted_tokens"] > 0
    assert eng.stats["prefix_hit_requests"] > 0
    for (p, n, kw), a, b in zip(reqs, outs[False], outs[True]):
        want = port.generate(torch.tensor([p]), n, max_length=MAXLEN,
                             **kw).numpy()
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(b, want)


def test_side_branch_fixup_runs_and_streams_hold(models):
    """Accepted side-branch paths move their K/V into depth order
    (``permute_pool_span``) before the next step reads them; the streams
    still equal generate."""
    port = models[1]
    prompts = fork_prompts(port, 3, np.random.RandomState(0))
    calls = []
    inner = port.permute_pool_span

    def counted(*a, **kw):
        calls.append(a[3].clone())
        return inner(*a, **kw)
    port.permute_pool_span = counted
    try:
        eng = PagedContinuousBatchingEngine(port, device="cpu", **ENGINE,
                                            spec_tree=(6, 2))
        rids = [eng.submit(np.array([p], np.int32), 12) for p in prompts]
        res = eng.run()
    finally:
        del port.permute_pool_span
    assert calls, "no side-branch fix-up ran"
    # a fix-up moves at least one lane off the identity
    assert any(bool(((s >= 0) & (s != torch.arange(s.shape[1]))).any())
               for s in calls)
    for r, p in zip(rids, prompts):
        np.testing.assert_array_equal(
            res[r].numpy(), port.generate(torch.tensor([p]), 12).numpy())
    assert eng.stats["blocks_in_use"] == 0


def _prefilled(port, rng, rows=2, T=11, M=4):
    """Pools holding ``rows`` prompts of T tokens, each through its own
    table; returns (pools, tables, pos, last token per row)."""
    pools = port.init_block_pool(1 + rows * M, 8)
    tables = np.arange(1, 1 + rows * M, dtype=np.int32).reshape(rows, M)
    last = []
    for b in range(rows):
        toks = rng.randint(0, 20, (1, T))
        port.prefill_pages(torch.from_numpy(toks), pools,
                           torch.from_numpy(tables[b]), 0)
        last.append(int(toks[0, -1]))
    return (pools, torch.from_numpy(tables),
            torch.full((rows,), T - 1, dtype=torch.int32), last)


def test_rejected_window_leaves_the_next_step_unchanged(models):
    """Two verify windows that agree on lane 0 and differ in the drafted
    (rejected) lanes leave different K/V past the accepted position, yet
    the next step's logits are the same bits: the rejected rows sit
    behind its mask."""
    port = models[1]
    out = []
    for drafts in ([3, 4, 5], [11, 12, 13]):
        pools, tables, pos, last = _prefilled(port, np.random.RandomState(4))
        window = torch.tensor([[t] + drafts for t in last])
        port.verify_pages(window, pools, tables, pos,
                          torch.full((2,), 4, dtype=torch.int32))
        nxt = torch.tensor([[7], [8]])              # one token emitted
        logits = port.step_pages(nxt, pools, tables, pos + 1)
        out.append((logits, [pk.clone() for pk, _ in pools]))
    assert torch.equal(out[0][0], out[1][0])
    # the rejected lanes did land, differently, at pos + 2 and pos + 3
    assert not torch.equal(out[0][1][0], out[1][1][0])


@pytest.mark.parametrize("gate", ["0", "1"], ids=["xla", "pallas"])
@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_verify_pages_logits_match_both_reference_arms(models, monkeypatch,
                                                       gate, tree):
    """One verify window over two prefilled slots and a dead lane,
    against the reference's verify_pages with its paged-attention gate
    off (XLA; trees through _internal_tree_verify_attn) and on (the
    Pallas kernel in interpret mode, trees through anc)."""
    ref, port = models
    monkeypatch.setenv("MXTPU_PALLAS_PAGED_ATTN", gate)
    pools, tables, pos, last = _prefilled(port, np.random.RandomState(5))
    jpools = [(nd.NDArray(pk.numpy()), nd.NDArray(pv.numpy()))
              for pk, pv in pools]
    W = 4
    window = np.array([[last[0], 4, 9, 4], [last[1], 1, 2, 3], [0] * W],
                      np.int32)
    tables = torch.cat([tables, torch.zeros(1, tables.shape[1],
                                            dtype=torch.int32)])
    pos = torch.cat([pos, torch.zeros(1, dtype=torch.int32)])
    vl = np.array([4, 3, 0], np.int32)
    ptree = jtree = None
    if tree:
        parent = np.array([[0, 0, 1, 0], [0, 0, 1, 2], [0, 0, 1, 2]])
        depth, anc, perm = _tree_paths(parent)
        jtree = tuple(nd.array(a, dtype="int32") for a in (perm, depth, anc))
        ptree = (torch.from_numpy(depth), torch.from_numpy(anc))
    jl, _ = ref.verify_pages(nd.array(window, dtype="int32"), jpools,
                             nd.array(tables.numpy(), dtype="int32"),
                             nd.array(pos.numpy(), dtype="int32"),
                             nd.array(vl, dtype="int32"), tree=jtree)
    base.reset_counts()
    got = port.verify_pages(torch.from_numpy(window).long(), pools, tables,
                            pos, torch.from_numpy(vl), tree=ptree)
    assert base.count("paged_attention") == 1
    np.testing.assert_allclose(got.numpy()[:2], jl.asnumpy()[:2], **TOL)


def test_verify_lanes_equal_sequential_steps(models):
    """Lane w of a linear window gives the logits sequential steps give
    at pos + w (held to the logits tolerance: the window's products run
    over 4x the rows of a step's)."""
    port = models[1]
    pools, tables, pos, last = _prefilled(port, np.random.RandomState(6))
    seq_pools = [(pk.clone(), pv.clone()) for pk, pv in pools]
    window = torch.tensor([[last[0], 4, 9, 4], [last[1], 1, 2, 3]])
    got = port.verify_pages(window, pools, tables, pos,
                            torch.full((2,), 4, dtype=torch.int32))
    for w in range(4):
        want = port.step_pages(window[:, w:w + 1], seq_pools, tables,
                               pos + w)
        torch.testing.assert_close(got[:, w], want[:, 0], **TOL)


def test_engine_speculation_knobs(models):
    port = models[1]
    # draft_block's refusals, the reference's ValueErrors: no window to
    # bound, a tree config beside it, a draft that is not a dense LM
    with pytest.raises(ValueError, match="spec_k"):
        PagedContinuousBatchingEngine(port, device="cpu", draft_block=port)
    with pytest.raises(ValueError, match="spec_tree"):
        PagedContinuousBatchingEngine(port, device="cpu", spec_k=2,
                                      spec_tree=(4, 2), draft_block=port)
    with pytest.raises(ValueError, match="dense"):
        PagedContinuousBatchingEngine(port, device="cpu", spec_k=2,
                                      draft_block=port.layers[0])
    with pytest.raises(ValueError, match="spec_k"):
        PagedContinuousBatchingEngine(port, device="cpu", spec_k=-1)
    with pytest.raises(ValueError, match="max_nodes"):
        PagedContinuousBatchingEngine(port, device="cpu", spec_tree=(32, 2))
    eng = PagedContinuousBatchingEngine(port, device="cpu", **ENGINE,
                                        spec_k=3)
    p = np.array([P_FORK], np.int32)
    with pytest.raises(ValueError, match="max_nodes"):
        eng.submit(p, 4, spec_tree=(40, 2))
    r0 = eng.submit(p, 10, spec_tree=(4, 2))        # its own tree config
    r1 = eng.submit(p, 10, speculative=False)       # opted out
    res = eng.run()
    want = port.generate(torch.from_numpy(p), 10).numpy()
    for r in (r0, r1):
        np.testing.assert_array_equal(res[r].numpy(), want)
    st = eng.stats
    assert st["tree_nodes_drafted"] > 0
    assert st["draft_hit_rate"] == st["accepted_tokens"] / st[
        "drafted_tokens"]
