"""The port's speculative drafters (``NGramDrafter``, ``TreeDrafter``,
copied from ``mxtpu/models/sampler.py``), its tree-config parser and
draft record, and its peeked draws, held against the JAX reference.

The drafters are pure host functions of (history, budgets): on 200
seeded histories the port's proposals must equal the reference's.  A
peeked draw (``sampler.future_states``) must be the very draw the
request's generator makes there, and peeking must not move it."""

import numpy as np
import pytest
import torch

from mxtpu.models.sampler import NGramDrafter as JaxNGram
from mxtpu.models.sampler import TreeDrafter as JaxTree
from mxtpu.parallel.serving import _parse_spec_tree as jax_parse
from mxtpu_torch.models import sampler
from mxtpu_torch.parallel.serving import _parse_spec_tree, _TreeDraft


def _histories(n=200, seed=0):
    """Seeded histories over small vocabularies (so n-grams recur), of
    lengths 0 to 60, some of them motifs repeated with substitutions."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        vocab = int(rng.randint(2, 12))
        L = int(rng.randint(0, 61))
        h = rng.randint(0, vocab, L)
        if i % 3 == 0 and L:
            motif = rng.randint(0, vocab, int(rng.randint(1, 8)))
            h = np.tile(motif, L // len(motif) + 1)[:L]
            h[rng.randint(0, L, 2)] = rng.randint(0, vocab, 2)
        out.append([int(t) for t in h])
    return out


@pytest.mark.parametrize("max_ngram,min_ngram", [(3, 1), (1, 1), (4, 2)])
def test_ngram_drafter_matches_reference(max_ngram, min_ngram):
    port = sampler.NGramDrafter(max_ngram, min_ngram)
    ref = JaxNGram(max_ngram, min_ngram)
    for i, h in enumerate(_histories()):
        k = i % 7
        assert port.propose(h, k) == ref.propose(h, k), (h, k)


@pytest.mark.parametrize("nodes,branch,ngram", [(6, 2, 3), (15, 2, 3),
                                                (31, 3, 2), (4, 1, 3)])
def test_tree_drafter_matches_reference(nodes, branch, ngram):
    port = sampler.TreeDrafter(nodes, branch, max_ngram=ngram)
    ref = JaxTree(nodes, branch, max_ngram=ngram)
    for i, h in enumerate(_histories(seed=nodes)):
        budget, depth = i % (nodes + 2), i % 9
        assert port.propose_tree(h, budget, depth) == \
            ref.propose_tree(h, budget, depth), (h, budget, depth)


def test_tree_drafter_forks_with_unique_siblings():
    """A history whose trailing bigram recurred with two continuations
    forks at the root once the primary chain is cut short (depth 3),
    and no node has two children with one token."""
    toks, parent, depth = sampler.TreeDrafter(6, 2).propose_tree(
        [5, 1, 2, 7, 1, 2, 8, 1, 2], 6, 3)
    assert toks == [8, 1, 2, 7, 1, 2]
    assert len(set(parent)) < len(parent)          # some node forks
    kids = {}
    for t, p in zip(toks, parent):
        assert (p, t) not in kids
        kids[(p, t)] = True
    assert all(p <= j for j, p in enumerate(parent))
    assert all(d == (1 if p == 0 else depth[p - 1] + 1)
               for p, d in zip(parent, depth))


def test_drafters_reject_bad_budgets():
    with pytest.raises(ValueError):
        sampler.NGramDrafter(max_ngram=1, min_ngram=2)
    with pytest.raises(ValueError):
        sampler.TreeDrafter(max_nodes=0)
    with pytest.raises(ValueError):
        sampler.TreeDrafter(branch=0)


@pytest.mark.parametrize("value", [(6, 2), [15, 3], 6, "6,3", "31",
                                   " 4  1 "])
def test_spec_tree_config_forms_match_reference(value):
    assert _parse_spec_tree(value) == jax_parse(value)


@pytest.mark.parametrize("value", [(32, 2), 0, (4, 0), object(), "x"])
def test_spec_tree_config_rejects_what_the_reference_rejects(value):
    with pytest.raises(ValueError):
        jax_parse(value)
    with pytest.raises(ValueError):
        _parse_spec_tree(value)


def test_tree_draft_record_checks_topology():
    assert len(_TreeDraft([5, 6, 7], [0, 1, 1])) == 3
    with pytest.raises(ValueError, match="topological"):
        _TreeDraft([5, 6], [0, 2])
    with pytest.raises(ValueError, match="one parent"):
        _TreeDraft([5, 6], [0])


def test_future_states_peek_the_draws_without_moving_the_generator():
    V, dev = 50, torch.device("cpu")
    g = torch.Generator().manual_seed(11)
    before = g.get_state()
    states = sampler.future_states(g, 4, V, dev)
    assert torch.equal(g.get_state(), before) and len(states) == 5
    real = [torch.rand(V, generator=g) for _ in range(4)]
    for k in range(4):
        peek = torch.rand(V, generator=sampler.generator_at(states[k], dev))
        assert torch.equal(peek, real[k])
    assert torch.equal(g.get_state(), states[4])


def test_a_peeked_sampled_draw_is_the_sequential_draw():
    """sample_next_token from a generator set to future state k draws
    what the request's generator would draw at its k-th next call."""
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(3, 40).astype(np.float32))
    g = torch.Generator().manual_seed(5)
    states = sampler.future_states(g, 3, 40, torch.device("cpu"))
    seq = [sampler.sample_next_token(logits[k:k + 1], g, 0.9, top_k=10)
           for k in range(3)]
    for k in range(3):
        peek = sampler.sample_next_token(
            logits[k:k + 1], sampler.generator_at(states[k], "cpu"), 0.9,
            top_k=10)
        assert torch.equal(peek, seq[k])
