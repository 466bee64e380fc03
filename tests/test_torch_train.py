"""The port's training path held against the JAX reference's: the full
forward of ``llama_tiny``, its gradients, ``Adam._step_t`` and three
``SPMDTrainer`` steps on the reference training example's synthetic data
(``examples/parallel/llama_train.py``), with the weights bridged by
``load_mxtpu_params`` and read back by ``export_mxtpu_params``.

Batch 2 x T 32, so that the reference takes its Pallas flash path (run
in interpret mode) and not its dense rule; the port's wrappers run the
kernels' plain versions on the CPU.  Tolerances, float32 on both sides
with sums taken in other orders:

- logits within 1e-4 (absolute and relative);
- every gradient within 1e-4 of that gradient's max-abs;
- ``Adam._step_t`` within 1e-6;
- losses of three trainer steps within 1e-4 relative;
- weights after them within 3·lr everywhere (Adam moves a weight at most
  ~lr a step, and where the gradient is ~0 its direction is rounding
  noise on either side), and within 1e-5 where the first step's
  gradient exceeds 1e-6.

The reference runs once, in module-scoped fixtures."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mxtpu as mx
from mxtpu import autograd, nd
from mxtpu.models.transformer import (MultiHeadAttention as JaxMHA,
                                      llama_tiny as jax_llama_tiny)
from mxtpu.parallel import SPMDTrainer as JaxTrainer, make_mesh
from mxtpu_torch import base
from mxtpu_torch.models.convert import (export_mxtpu_params,
                                        load_mxtpu_params, mxtpu_name,
                                        strip_instance_prefix)
from mxtpu_torch.models.transformer import MultiHeadAttention, llama_tiny
from mxtpu_torch.optimizer import Adam, Optimizer
from mxtpu_torch.parallel.trainer import SPMDTrainer

VOCAB = 512          # the reference training example's vocabulary
LR = 1e-3
STEPS = 3
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _example():
    spec = importlib.util.spec_from_file_location(
        "llama_train_example", ROOT / "examples" / "parallel" /
        "llama_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run():
    """Both frameworks from the same weights: logits and step-1
    gradients on the first batch, then STEPS trainer steps."""
    ex = _example()
    batches = [b.asnumpy() for b in ex.synthetic_batches(2, 32, STEPS)]
    mx.random.seed(3)
    ref = jax_llama_tiny(vocab_size=VOCAB)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))
    params = {k: v.data().asnumpy() for k, v in ref.collect_params().items()}
    port = llama_tiny(vocab_size=VOCAB, device="cpu")
    load_mxtpu_params(port, params)
    out = {"batches": batches, "params": params}

    x0 = nd.array(batches[0], dtype="int32")
    ref_loss = ex.NextTokenLoss()
    with autograd.record():
        logits = ref(x0)
        loss = ref_loss(logits, x0).mean()
    loss.backward()
    out["ref_logits"] = logits.asnumpy()
    out["ref_grads"] = {strip_instance_prefix(p.name): p.grad().asnumpy()
                        for p in ref.collect_params().values()}

    base.reset_counts()
    x0 = torch.from_numpy(batches[0].copy())
    logits = port(x0)
    chip_smoke.NextTokenLoss()(logits, x0).mean().backward()
    out["counts"] = base.counts()
    out["logits"] = logits.detach().numpy()
    out["grads"] = {mxtpu_name(n): p.grad.numpy()
                    for n, p in port.named_parameters()}
    port.zero_grad(set_to_none=True)

    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    jt = JaxTrainer(ref, ex.NextTokenLoss(), "adam", mesh,
                    optimizer_params={"learning_rate": LR})
    pt = SPMDTrainer(port, chip_smoke.NextTokenLoss(), "adam",
                     {"learning_rate": LR})
    out["ref_losses"] = [float(jt.step(nd.array(b, dtype="int32"),
                                       nd.array(b, dtype="int32")).asnumpy())
                         for b in batches]
    out["losses"] = [float(pt.step(b, b)) for b in batches]
    out["ref_trained"] = {strip_instance_prefix(k): v.data().asnumpy()
                          for k, v in ref.collect_params().items()}
    out["trained"] = export_mxtpu_params(port)
    return out


def test_chip_smoke_data_is_the_reference_examples():
    ex = _example()
    want = [b.asnumpy() for b in ex.synthetic_batches(3, 40, 4, seed=5)]
    got = list(chip_smoke.synthetic_batches(3, 40, 4, vocab=VOCAB, seed=5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_full_forward_logits_match(run):
    assert run["counts"] == {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2}
    np.testing.assert_allclose(run["logits"], run["ref_logits"], rtol=1e-4,
                               atol=1e-4)


def test_every_gradient_matches_at_step_1(run):
    assert set(run["grads"]) == set(run["ref_grads"])
    for name, want in run["ref_grads"].items():
        got = run["grads"][name]
        assert got.shape == want.shape, name
        bound = 1e-4 * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= bound, name


def test_trainer_losses_match(run):
    np.testing.assert_allclose(run["losses"], run["ref_losses"], rtol=1e-4)


def test_trained_weights_match(run):
    for name, want in run["ref_trained"].items():
        got = run["trained"][name]
        diff = np.abs(got - want)
        assert float(diff.max()) <= 3 * LR, name
        moved = np.abs(run["ref_grads"][name]) > 1e-6
        assert float(diff[moved].max(initial=0.0)) <= 1e-5, name


def test_export_is_the_inverse_of_load(run):
    port = llama_tiny(vocab_size=VOCAB, device="cpu")
    load_mxtpu_params(port, run["params"])
    exported = export_mxtpu_params(port)
    assert set(exported) == {strip_instance_prefix(k) for k in run["params"]}
    for k, v in run["params"].items():
        np.testing.assert_array_equal(exported[strip_instance_prefix(k)], v)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(wd=0.01, rescale_grad=0.5, clip_gradient=0.3),
], ids=["plain", "wd-rescale-clip"])
def test_adam_step_t_matches_reference(kw):
    """t = 1..3 on random arrays, a third of the gradients near epsilon
    (where adding epsilon after the bias correction, as torch.optim.Adam
    does, would move the weights differently)."""
    rng = np.random.RandomState(0)
    w = rng.randn(64, 48).astype("float32")
    ref_opt = mx.optimizer.Adam(learning_rate=2e-3, **kw)
    opt = Adam(learning_rate=2e-3, **kw)
    jw = jnp.array(w)
    jst = ref_opt.create_state(0, nd.array(w))
    tw = torch.from_numpy(w.copy())
    st = opt.create_state(0, tw)
    for t in (1, 2, 3):
        g = rng.randn(64, 48).astype("float32")
        g[::3] *= 1e-8
        jw, jst = ref_opt._step_t(jw, jnp.array(g), jst, jnp.float32(2e-3),
                                  jnp.float32(kw.get("wd", 0.0)),
                                  jnp.float32(t))
        tw, st = opt._step_t(tw, torch.from_numpy(g), st, 2e-3,
                             kw.get("wd", 0.0), t)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6, err_msg="t=%d" % t)
        for a, b in zip(st, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)


def test_trainer_refuses_an_optimizer_without_a_rule():
    with pytest.raises(ValueError, match="_step"):
        SPMDTrainer(torch.nn.Linear(2, 2), chip_smoke.NextTokenLoss(),
                    Optimizer())


def test_trainer_learning_rate():
    tr = SPMDTrainer(torch.nn.Linear(2, 2), chip_smoke.NextTokenLoss(),
                     "adam", {"learning_rate": 0.1})
    assert tr.learning_rate == 0.1
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25


def test_gqa_repeats_each_kv_head_for_its_query_heads():
    """Head h reads kv head h // rep (MXNet's element-wise repeat), the
    reference's pairing; tiling the kv heads (``.repeat``) pairs them
    otherwise and is far off."""
    mx.random.seed(9)
    ref = JaxMHA(64, 8, 2, use_rotary=True, causal=True, use_bias=False,
                 prefix="mha_")
    ref.initialize()
    x = np.random.RandomState(4).randn(2, 24, 64).astype("float32")
    want = ref(nd.array(x)).asnumpy()
    port = MultiHeadAttention(64, 8, 2, device="cpu")
    with torch.no_grad():
        for n, p in ref.collect_params().items():
            dst = port.qkv if "qkv" in n else port.out_proj
            dst.weight.copy_(torch.from_numpy(p.data().asnumpy()))
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    from mxtpu_torch.ops.flash_attention import flash_attention
    q, k, v = port._project(torch.from_numpy(x), 0)
    tiled = port._merge(flash_attention(q, k.repeat(1, 4, 1, 1),
                                        v.repeat(1, 4, 1, 1), causal=True))
    assert float(np.abs(tiled.detach().numpy() - want).max()) > 1e-2


@pytest.mark.parametrize("width,depth", [(1.0, 0.125), (0.125, 0.0625),
                                         (0.3, 0.5), (1.0, 1.0)])
def test_llama_3_8b_scaling_rounds_as_the_reference(width, depth):
    """width_factor/depth_factor round heads, SwiGLU width, kv heads and
    layers exactly as the reference's llama_3_8b."""
    from mxtpu.models.transformer import llama_3_8b as jax_llama_3_8b
    from mxtpu_torch.models.transformer import llama_3_8b

    ref = jax_llama_3_8b(vocab_size=64, width_factor=width,
                         depth_factor=depth)
    port = llama_3_8b(vocab_size=64, width_factor=width, depth_factor=depth,
                      device="meta")
    ra, pa = ref.layers[0].attn, port.layers[0].attn
    assert (pa.heads, pa.kv_heads, pa.head_dim) == (
        ra._heads, ra._kv_heads, ra._head_dim)
    assert port.layers[0].gate_proj.out_features == \
        ref.layers[0].gate_proj._units
    assert len(port.layers) == len(ref.layers)


@pytest.mark.parametrize("kw,shape", [
    (dict(), (6, 10)),
    (dict(sparse_label=False), (6, 10)),
    (dict(from_logits=True, weight=0.5), (6, 10)),
    (dict(batch_axis=1), (3, 5, 10)),
    (dict(sparse_label=False, weight=2.0, batch_axis=1), (4, 7, 10)),
], ids=["sparse", "dense-label", "from-logits-weight", "batch-axis-1",
        "dense-weight-batch-axis-1"])
def test_softmax_cross_entropy_matches_reference(kw, shape):
    from mxtpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCE
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    rng = np.random.RandomState(len(shape) + shape[0])
    pred = rng.randn(*shape).astype("float32")
    if kw.get("sparse_label", True):
        label = rng.randint(0, shape[-1], shape[:-1]).astype("float32")
    else:
        label = rng.dirichlet(np.ones(shape[-1]), shape[:-1]).astype(
            "float32")
    want = JaxCE(**kw)(nd.array(pred), nd.array(label)).asnumpy()
    got = SoftmaxCrossEntropyLoss(**kw)(torch.from_numpy(pred),
                                        torch.from_numpy(label))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
