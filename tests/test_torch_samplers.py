"""The port's sequence samplers (``BeamSearchSampler``, ``beam_search``,
``SequenceSampler`` in ``mxtpu_torch/models/sampler.py``) against the
JAX reference's on the same weights (the weight bridge) and prompts.

Beam search: tokens identical to the reference's and scores within 1e-4
(the reference's arithmetic in float64 on logits that differ by float32
sums in other orders, the tolerance of tests/test_torch_transformer.py),
with and without an eos that freezes beams; ``beam_size=1`` is greedy
``generate`` token for token.
``SequenceSampler`` draws with ``torch.Generator`` and is not held to
the reference's draws: its structure (shapes, the prompt kept, rows
sorted by descending score, eos padding, a seed reproducing its samples,
greedy rows equal to ``generate``) is held instead."""

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.models.sampler import BeamSearchSampler as JaxBeam
from mxtpu.models.sampler import beam_search as jax_beam_search
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.sampler import (BeamSearchSampler, SequenceSampler,
                                        beam_search)
from mxtpu_torch.models.transformer import TransformerLM

VOCAB = 50


@pytest.fixture(scope="module")
def models():
    mx.random.seed(3)
    ref = JaxLM(VOCAB, units=32, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    port = TransformerLM(VOCAB, 32, 64, 2, 4, 2, device="cpu")
    load_mxtpu_params(port, {k: v.data().asnumpy()
                             for k, v in ref.collect_params().items()})
    return ref, port


def _prompt(B=2, T=7, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("K,alpha,eos", [(3, 0.6, None), (4, 0.6, 5),
                                         (2, 1.0, None), (1, 0.6, None)],
                         ids=["k3", "k4-eos", "k2-alpha1", "k1"])
def test_beam_search_matches_the_reference(models, K, alpha, eos):
    ref, port = models
    p = _prompt()
    want, wscores = JaxBeam(ref, K, alpha, eos)(nd.array(p, dtype="int32"),
                                                10)
    got, scores = BeamSearchSampler(port, K, alpha, eos)(p, 10)
    assert got.dtype == torch.int32 and got.shape == (2, K, 17)
    np.testing.assert_array_equal(got.numpy(), want.asnumpy())
    np.testing.assert_allclose(scores, wscores, atol=1e-4, rtol=1e-4)


def test_beam_search_function_matches_the_reference(models):
    """``beam_search`` against the reference's, a max_length past the
    new tokens and an eos."""
    ref, port = models
    p = _prompt(1, 9, seed=2)
    want, wscores = jax_beam_search(ref, nd.array(p, dtype="int32"), 8,
                                    beam_size=3, eos_id=7, max_length=24)
    got, scores = beam_search(port, p, 8, beam_size=3, eos_id=7,
                              max_length=24)
    np.testing.assert_array_equal(got.numpy(), want.asnumpy())
    np.testing.assert_allclose(scores, wscores, atol=1e-4, rtol=1e-4)


def test_beam_size_one_is_greedy_generate(models):
    port = models[1]
    p = _prompt(3, 5, seed=1)
    got, scores = beam_search(port, p, 12, beam_size=1)
    want = port.generate(torch.from_numpy(p), 12).numpy()
    np.testing.assert_array_equal(got.numpy()[:, 0], want)
    assert scores.shape == (3, 1) and (scores < 0).all()


def test_beam_search_edges(models):
    port = models[1]
    p = _prompt()
    got, scores = beam_search(port, p, 0, beam_size=3)
    assert got.shape == (2, 3, 7) and not scores.any()
    np.testing.assert_array_equal(got.numpy()[:, 1], p)
    with pytest.raises(ValueError, match="beam_size"):
        beam_search(port, p, 2, beam_size=VOCAB + 1)
    with pytest.raises(ValueError, match="max_length"):
        beam_search(port, p, 5, beam_size=2, max_length=9)
    got, scores = beam_search(port, p, 6, beam_size=4, max_length=20)
    order = scores / ((5.0 + 6) / 6.0) ** 0.6
    assert (np.diff(order, axis=1) <= 1e-12).all()


def test_sequence_sampler_structure_and_seeding(models):
    port = models[1]
    p = _prompt()
    s = SequenceSampler(port, n_samples=4, temperature=0.8, top_k=10)
    a, sa = s(p, 9, seed=11)
    b, sb = s(p, 9, seed=11)
    c, _ = s(p, 9, seed=12)
    assert a.shape == (2, 4, 16) and a.dtype == torch.int32
    assert torch.equal(a, b) and np.array_equal(sa, sb)
    assert not torch.equal(a, c)
    np.testing.assert_array_equal(a.numpy()[:, :, :7],
                                  np.repeat(p[:, None], 4, axis=1))
    assert (np.diff(sa, axis=1) <= 0).all() and (sa < 0).all()
    g, gs = SequenceSampler(port, n_samples=3, temperature=0.0)(p, 6)
    want = port.generate(torch.from_numpy(p), 6).numpy()
    for k in range(3):
        np.testing.assert_array_equal(g.numpy()[:, k], want)
    eos = int(want[0, 8])
    e, _ = SequenceSampler(port, n_samples=2, temperature=0.0,
                           eos_id=eos)(p[:1], 6)
    assert (e.numpy()[0, :, 9:] == eos).all()
    pen, _ = SequenceSampler(port, n_samples=2, temperature=0.7,
                             repetition_penalty=1.5)(p, 5, seed=2)
    assert pen.shape == (2, 2, 12)
