"""The port's vision training path held against the JAX reference on the
CPU: the ops (``convolution``, ``fully_connected``, ``pooling``,
``batch_norm`` and the BatchNorm layer's running statistics), ``SGD``,
``Xavier``, the weight bridge, and the slice as a whole — a narrow
ResNet-v1 trained by ``Trainer("sgd")`` through
``SoftmaxCrossEntropyLoss``, its weights carried across by
``load_mxtpu_params``.

The whole slice runs against both arms of the reference: with
``MXTPU_PALLAS_CONV_BWD=1`` (its eligible convs' backward through the
Pallas kernel in interpret mode) and without (XLA autodiff).  The port
always routes eligible convs to K6, whose plain version runs on the CPU.

The net runs at (4, 3, 64, 64): at (2, 3, 32, 32) three SGD steps turn
a float32 rounding-sized change of the start into weights that differ
by more than 1e-2 (ROADMAP C), which no float32 implementation could
hold to 1e-5.

Tolerances, float32 on both sides with sums in other orders:

- op forwards within 1e-5, their gradients within 1e-4;
- logits within 1e-4; every gradient after one backward within 1e-4 of
  that gradient's max-abs;
- the losses of three trainer steps within 1e-4 relative; the weights
  and running statistics after them within 1e-5.

The reference's blocks carry explicit prefixes, so these tests leave its
process-global name counters (``dense`` among them) where they were."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mxtpu as mx
from mxtpu import autograd, gluon as jgluon, nd
from mxtpu.gluon import nn as jnn
from mxtpu.gluon.block import _NameManager
from mxtpu.gluon.model_zoo.vision import resnet as jresnet
from mxtpu.ops import nn as jops
from mxtpu_torch import base
from mxtpu_torch.base import MXTPUError
from mxtpu_torch.gluon import nn as pnn
from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxtpu_torch.gluon.model_zoo import vision
from mxtpu_torch.gluon.trainer import Trainer
from mxtpu_torch.initializer import Xavier
from mxtpu_torch.models.convert import (export_mxtpu_params,
                                        load_mxtpu_params,
                                        strip_instance_prefix)
from mxtpu_torch.ops import conv_bwd
from mxtpu_torch.ops import nn as pops
from mxtpu_torch.optimizer import SGD

SGD_PARAMS = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
STEPS = 3
BATCH = 4
SIZE = 64
#: the narrow nets: (block name, layers, channels, 3x3 convs that take K6)
NETS = {
    "bottleneck": ("BottleneckV1", [1, 1, 1, 1], [16, 32, 64, 128, 256], 4),
    "basic": ("BasicBlockV1", [1, 1, 1, 1], [8, 8, 16, 32, 64], 5),
}


def _name_counters():
    mgr = getattr(_NameManager._current, "value", None)
    return dict(mgr._counter) if mgr is not None else {}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# -- ops ---------------------------------------------------------------------

def _grads_match(jfn, pfn, arrays, ct, fwd_tol=1e-5, grad_tol=1e-4):
    """jfn/pfn on the same arrays: forwards within fwd_tol, and the
    gradients of sum(out * ct) with respect to every array within
    grad_tol."""
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    jgrads = vjp(jnp.asarray(ct))
    ts = [_t(a).requires_grad_() for a in arrays]
    pout = pfn(*ts)
    _close(pout.detach().numpy(), jout, fwd_tol, "forward")
    pgrads = torch.autograd.grad(pout, ts, _t(ct), allow_unused=True)
    for i, (g, jg) in enumerate(zip(pgrads, jgrads)):
        g = torch.zeros_like(ts[i]) if g is None else g    # unused: 0
        _close(g.numpy(), jg, grad_tol, "gradient %d" % i)


@pytest.mark.parametrize("case", [
    dict(kernel=(3, 3), pad=(1, 1), bias=False),
    dict(kernel=(3, 3), pad=(1, 1), bias=True),
    dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), bias=False),
    dict(kernel=(1, 1), stride=(2, 2), bias=True),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), bias=False),
], ids=["3x3-k6", "3x3-k6-bias", "7x7s2", "1x1s2-bias", "3x3s2"])
def test_convolution_matches_reference(case):
    rng = np.random.RandomState(len(case["kernel"]) + case["kernel"][0])
    kw = {k: case[k] for k in ("kernel", "stride", "pad") if k in case}
    x = rng.randn(2, 5, 9, 8).astype("f")
    w = (rng.randn(6, 5, *case["kernel"]) * 0.2).astype("f")
    arrays = [x, w] + ([rng.randn(6).astype("f")] if case["bias"] else [])
    jfn = lambda *a: jops.convolution(*a, num_filter=6, **kw)  # noqa: E731
    pfn = lambda *a: pops.convolution(*a, **kw)                # noqa: E731
    ct = rng.randn(*np.asarray(jfn(*arrays)).shape).astype("f")
    base.reset_counts()
    _grads_match(jfn, pfn, arrays, ct)
    eligible = tuple(case["kernel"]) == (3, 3) and "stride" not in case
    assert base.count(conv_bwd.NAME) == int(eligible)


def test_fully_connected_matches_reference():
    rng = np.random.RandomState(7)
    arrays = [rng.randn(3, 4, 2, 2).astype("f"),
              rng.randn(5, 16).astype("f"), rng.randn(5).astype("f")]
    ct = rng.randn(3, 5).astype("f")
    _grads_match(jops.fully_connected, pops.fully_connected, arrays, ct)


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="max"),
    dict(global_pool=True, pool_type="avg"),
], ids=["max-3-2-1", "max-2-2", "global-avg"])
def test_pooling_matches_reference(kw):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 9, 10).astype("f")
    shape = np.asarray(jops.pooling(jnp.asarray(x), **kw)).shape
    ct = rng.randn(*shape).astype("f")
    _grads_match(lambda a: jops.pooling(a, **kw),
                 lambda a: pops.pooling(a, **kw), [x], ct)


def test_max_pooling_pads_with_minus_infinity():
    x = -torch.ones(1, 1, 4, 4) - torch.arange(16.0).reshape(1, 1, 4, 4)
    y = pops.pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1))
    assert float(y.max()) < 0          # zero padding would win every window
    _close(y.numpy(), np.asarray(jops.pooling(
        jnp.asarray(x.numpy()), kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
        0, "forward")


def test_relu_matches_reference():
    x = np.random.RandomState(2).randn(4, 6).astype("f")
    _grads_match(jops.activation_op, pops.activation_op, [x],
                 np.random.RandomState(3).randn(4, 6).astype("f"))


@pytest.mark.parametrize("training", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("fix_gamma", [False, True],
                         ids=["scale", "fix-gamma"])
def test_batch_norm_matches_reference(training, fix_gamma):
    rng = np.random.RandomState(11)
    x = (rng.randn(4, 3, 5, 6) * 2 + 3).astype("f")
    gamma, beta = rng.rand(3).astype("f") + 0.5, rng.randn(3).astype("f")
    mm, mv = rng.randn(3).astype("f"), rng.rand(3).astype("f") + 0.5
    kw = dict(fix_gamma=fix_gamma, eps=1e-5)
    jfn = lambda a, g, b: jops.batch_norm(  # noqa: E731
        a, g, b, jnp.asarray(mm), jnp.asarray(mv), _training=training, **kw)
    pfn = lambda a, g, b: pops.batch_norm(  # noqa: E731
        a, g, b, _t(mm), _t(mv), training=training, **kw)
    _grads_match(jfn, pfn, [x, gamma, beta], rng.randn(*x.shape).astype("f"))
    _, jmean, jvar = jops.batch_norm(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.asarray(mm), jnp.asarray(mv), output_mean_var=True,
        _training=training, **kw)
    _, pmean, pvar = pops.batch_norm(_t(x), _t(gamma), _t(beta), _t(mm),
                                     _t(mv), output_mean_var=True,
                                     training=training, **kw)
    _close(pmean.numpy(), jmean, 1e-5, "mean")
    _close(pvar.numpy(), jvar, 1e-5, "var")


def test_batch_norm_layer_running_stats_match_reference():
    """Two training forwards move the running statistics by momentum 0.9
    with the biased batch variance; eval mode then normalizes with them.
    torch's own batch_norm (unbiased variance) would be off by N/(N-1)."""
    rng = np.random.RandomState(4)
    xs = [(rng.randn(2, 3, 2, 2) * 3 + 1).astype("f") for _ in range(2)]
    before = _name_counters()
    ref = jnn.BatchNorm(in_channels=3, prefix="bn_")
    ref.initialize()
    port = pnn.BatchNorm(in_channels=3, device="cpu")
    for x in xs:
        with autograd.record():
            want = ref(nd.array(x)).asnumpy()
        _close(port(_t(x)).detach().numpy(), want, 1e-5, "train forward")
    _close(port.running_mean.numpy(), ref.running_mean.data().asnumpy(),
           1e-6, "running_mean")
    _close(port.running_var.numpy(), ref.running_var.data().asnumpy(),
           1e-6, "running_var")
    unbiased = torch.ones(3)
    for x in xs:
        torch.nn.functional.batch_norm(_t(x), torch.zeros(3), unbiased,
                                       training=True, momentum=0.1)
    assert float((unbiased - port.running_var).abs().max()) > 1e-3
    port.eval()
    _close(port(_t(xs[0])).detach().numpy(),
           ref(nd.array(xs[0])).asnumpy(), 1e-5, "eval forward")
    assert _name_counters() == before


# -- optimizer, initializer, bridge ------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(momentum=0.9, wd=1e-4),
    dict(momentum=0.0, wd=1e-3),
    dict(momentum=0.9, wd=1e-4, rescale_grad=0.5, clip_gradient=0.3),
], ids=["momentum", "plain", "rescale-clip"])
def test_sgd_step_matches_reference(kw):
    rng = np.random.RandomState(0)
    w = rng.randn(16, 12).astype("f")
    ref_opt = mx.optimizer.SGD(learning_rate=0.05, **kw)
    opt = SGD(learning_rate=0.05, **kw)
    jw, tw = jnp.asarray(w), _t(w)
    jst = ref_opt.create_state(0, nd.array(w))
    st = opt.create_state(0, tw)
    for _ in range(3):
        g = rng.randn(16, 12).astype("f")
        jw, jst = ref_opt._step(jw, jnp.asarray(g), jst, 0.05, kw["wd"])
        tw, st = opt._step(tw, _t(g), st, 0.05, kw["wd"])
        _close(tw.numpy(), jw, 1e-6, "weight")
        if kw["momentum"]:
            _close(st.numpy(), jst, 1e-6, "momentum")
        else:
            assert st is None and jst is None


def test_trainer_skips_what_takes_no_gradient():
    net = pnn.BatchNorm(in_channels=4, device="cpu")
    net.gamma.requires_grad_(False)                # frozen: not updated
    params = net.collect_params()
    assert set(params) == {"gamma", "beta", "running_mean", "running_var"}
    tr = Trainer(params, "sgd", {"learning_rate": 1.0, "wd": 0.5})
    net.beta.grad = torch.ones(4)
    tr.step(2)
    np.testing.assert_array_equal(net.beta.detach().numpy(), -0.5)
    assert net.beta.grad is None                  # consumed: "write" next
    for name in ("gamma", "running_var"):
        np.testing.assert_array_equal(params[name].detach().numpy(), 1.0)
    np.testing.assert_array_equal(net.running_mean.numpy(), 0.0)
    assert tr.learning_rate == 1.0
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25
    with pytest.raises(ValueError):
        Trainer(net.parameters(), "sgd")


def test_xavier_draws_within_its_scale():
    net = vision.resnet18_v1(classes=10, device="cpu")
    net.initialize(Xavier(magnitude=2.0), torch.Generator().manual_seed(0))
    params = net.collect_params()
    w = params["conv0_weight"].detach()            # (64, 3, 7, 7)
    scale = (2.0 / ((3 * 49 + 64 * 49) / 2.0)) ** 0.5
    assert float(w.abs().max()) <= scale
    assert abs(float(w.std()) - scale / 3 ** 0.5) < 0.05 * scale
    for name, t in params.items():
        if name.endswith(("gamma", "running_var")):
            np.testing.assert_array_equal(t.detach().numpy(), 1.0)
        elif name.endswith(("beta", "bias", "running_mean")):
            np.testing.assert_array_equal(t.detach().numpy(), 0.0)
    again = vision.resnet18_v1(classes=10, device="cpu").initialize(
        Xavier(magnitude=2.0), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        again.collect_params()["dense0_weight"].detach().numpy(),
        params["dense0_weight"].detach().numpy())


@pytest.mark.parametrize("layers", [18, 50])
def test_zoo_names_and_shapes_are_the_references(layers):
    """Every conv weight and bias (BottleneckV1's 1x1 biases included),
    BatchNorm's four tensors and the Dense output, by the reference's
    prefix-stripped names; shapes wherever the reference knows them
    before its first forward (the narrow nets below carry every shape
    across through the bridge's shape check)."""
    before = _name_counters()
    ref = jresnet.get_resnet(1, layers, classes=7, prefix="resnetv10_")
    want = {strip_instance_prefix(k): tuple(v.shape)
            for k, v in ref.collect_params().items()}
    port = vision.get_model("resnet%d_v1" % layers, classes=7, device="cpu")
    got = {k: tuple(t.shape) for k, t in port.collect_params().items()}
    assert set(got) == set(want)
    known = [k for k, shape in want.items() if 0 not in shape]
    assert known
    assert all(got[k] == want[k] for k in known)
    assert _name_counters() == before


def test_bridge_raises_on_missing_extra_and_shape():
    net = vision.resnet18_v1(classes=4, device="cpu")
    params = {"resnetv10_" + k: v for k, v in
              export_mxtpu_params(net).items()}
    bad = dict(params)
    bad.pop("resnetv10_stage1_batchnorm0_running_var")
    with pytest.raises(MXTPUError, match="missing"):
        load_mxtpu_params(net, bad)
    bad = dict(params, resnetv10_extra_weight=np.zeros(1, "f"))
    with pytest.raises(MXTPUError, match="extra"):
        load_mxtpu_params(net, bad)
    bad = dict(params, resnetv10_dense0_bias=np.zeros(5, "f"))
    with pytest.raises(MXTPUError, match="shape"):
        load_mxtpu_params(net, bad)


def test_get_model_refuses_what_is_not_ported():
    with pytest.raises(ValueError):
        vision.get_model("resnet50_v2", device="cpu")
    with pytest.raises(MXTPUError):
        vision.get_resnet(1, 50, pretrained=True, device="cpu")


# -- the slice as a whole ----------------------------------------------------

def _batches(n, batch=BATCH, size=SIZE):
    xs, ys = chip_smoke.synthetic_images(n * batch, size, 10, seed=1)
    return [(xs[i * batch:(i + 1) * batch], ys[i * batch:(i + 1) * batch])
            for i in range(n)]


def _reference_run(block, layers, channels, steps):
    """The reference net from seed 1 (Xavier, magnitude 2): its weights,
    then the logits and gradients of one recorded forward/backward on the
    first batch, then ``steps`` Trainer steps (the first on that
    backward)."""
    mx.random.seed(1)
    net = jresnet.ResNetV1(getattr(jresnet, block), layers, channels,
                           classes=10, prefix="resnetv10_")
    net.initialize(mx.init.Xavier(magnitude=2.0))
    batches = _batches(steps)
    net(nd.array(batches[0][0]))                  # deferred shapes
    params = net.collect_params()
    out = {"params": {k: v.data().asnumpy() for k, v in params.items()}}
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss(prefix="ce_")
    trainer = jgluon.Trainer(params, "sgd", dict(SGD_PARAMS))
    losses = []
    for i, (x, y) in enumerate(batches):
        with autograd.record():
            logits = net(nd.array(x))
            loss = loss_fn(logits, nd.array(y.astype("f")))
        loss.backward()
        if i == 0:
            out["logits"] = logits.asnumpy()
            out["grads"] = {strip_instance_prefix(p.name): p.grad().asnumpy()
                            for p in params.values() if p.grad_req != "null"}
        losses.append(float(loss.mean().asnumpy()))
        trainer.step(x.shape[0])
    out["losses"] = losses
    out["trained"] = {strip_instance_prefix(k): v.data().asnumpy()
                      for k, v in params.items()}
    return out


def _port_run(block, layers, channels, params, steps, batch=BATCH,
              size=SIZE):
    net = vision.ResNetV1(getattr(vision, block), layers, channels,
                          classes=10, device="cpu")
    load_mxtpu_params(net, params)
    net.train()
    loss_fn = SoftmaxCrossEntropyLoss()
    trainer = Trainer(net.collect_params(), "sgd", dict(SGD_PARAMS))
    out, losses, counts = {}, [], []
    for i, (x, y) in enumerate(_batches(steps, batch, size)):
        base.reset_counts()
        logits = net(torch.from_numpy(x))
        loss = loss_fn(logits, torch.from_numpy(y))
        loss.sum().backward()
        counts.append(base.count(conv_bwd.NAME))
        if i == 0:
            out["logits"] = logits.detach().numpy()
            out["grads"] = {k: t.grad.numpy().copy() for k, t in
                            net.collect_params().items()
                            if isinstance(t, torch.nn.Parameter)}
        losses.append(float(loss.detach().mean()))
        trainer.step(x.shape[0])
    out.update(losses=losses, counts=counts,
               trained=export_mxtpu_params(net))
    return out


@pytest.fixture(scope="module")
def runs():
    """The narrow BottleneckV1 net: the reference in both arms (gate on,
    then off, from the same seed), and the port from its weights."""
    block, layers, channels, _ = NETS["bottleneck"]
    before = _name_counters()
    ref = {}
    for arm, gate in (("gate_on", "1"), ("gate_off", "0")):
        mp = pytest.MonkeyPatch()
        mp.setenv("MXTPU_PALLAS_CONV_BWD", gate)
        try:
            ref[arm] = _reference_run(block, layers, channels, STEPS)
        finally:
            mp.undo()
    for k, v in ref["gate_on"]["params"].items():
        np.testing.assert_array_equal(v, ref["gate_off"]["params"][k])
    port = _port_run(block, layers, channels, ref["gate_on"]["params"],
                     STEPS)
    return dict(ref=ref, port=port, counters=(before, _name_counters()))


ARMS = ["gate_on", "gate_off"]


def _check_logits_and_grads(ref, port):
    """Logits within 1e-4; every gradient within 1e-4 of its max-abs,
    and a conv bias that feeds a BatchNorm (a gradient of 0 in exact
    arithmetic) within 1e-4 of its conv weight's largest gradient on each
    side (``chip_smoke.gap_over_bound``, which phase 13 also uses)."""
    _close(port["logits"], ref["logits"], 1e-4, "logits")
    assert set(port["grads"]) == set(ref["grads"])
    gap, name = chip_smoke.gap_over_bound(ref["grads"], port["grads"])
    assert gap <= 1.0, (name, gap)


@pytest.mark.parametrize("arm", ARMS)
def test_resnet_v1_logits_and_gradients(runs, arm):
    _check_logits_and_grads(runs["ref"][arm], runs["port"])


def test_resnet_v1_routes_every_eligible_conv_to_k6(runs):
    assert runs["port"]["counts"] == [NETS["bottleneck"][3]] * STEPS


@pytest.mark.parametrize("arm", ARMS)
def test_resnet_v1_trainer_losses(runs, arm):
    np.testing.assert_allclose(runs["port"]["losses"],
                               runs["ref"][arm]["losses"], rtol=1e-4)


@pytest.mark.parametrize("arm", ARMS)
def test_resnet_v1_trained_weights_and_running_stats(runs, arm):
    want, got = runs["ref"][arm]["trained"], runs["port"]["trained"]
    assert set(got) == set(want)
    for name, w in want.items():
        _close(got[name], w, 1e-5, name)


def test_resnet_v1_leaves_the_reference_name_counters(runs):
    before, after = runs["counters"]
    assert after.get("dense", 0) == before.get("dense", 0)
    assert after == before


def test_three_sgd_steps_amplify_a_change_of_the_start(runs):
    """Why the trainer tests above run at (4, 3, 64, 64): three SGD steps
    amplify a change of the starting weights, and there a 1e-7 relative
    change (about the gap between two frameworks' float32 results) still
    moves the trained weights by less than their 1e-5 tolerance.  (At (2, 3, 32, 32), where stage
    4's BatchNorm normalizes 2 values a channel, the same change moves
    them by more than 1e-2; ROADMAP C.)"""
    block, layers, channels, _ = NETS["bottleneck"]
    params = runs["ref"]["gate_on"]["params"]
    rng = np.random.RandomState(0)
    nudged = {k: (v * (1 + 1e-7 * rng.randn(*v.shape))).astype("f")
              for k, v in params.items()}
    moved = _port_run(block, layers, channels, nudged, STEPS)["trained"]
    gap = max(float(np.abs(moved[k] - w).max())
              for k, w in runs["port"]["trained"].items())
    assert gap <= 1e-5, gap


def test_basic_block_net_logits_and_gradients(monkeypatch):
    """resnet18_v1's BasicBlockV1 in a narrow net, one backward against
    the gate-on reference; its stride-2 3x3 convs stay off K6."""
    block, layers, channels, eligible = NETS["basic"]
    monkeypatch.setenv("MXTPU_PALLAS_CONV_BWD", "1")
    ref = _reference_run(block, layers, channels, 1)
    port = _port_run(block, layers, channels, ref["params"], 1)
    _check_logits_and_grads(ref, port)
    assert port["counts"] == [eligible]
