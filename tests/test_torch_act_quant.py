"""The port's int8 post-training quantization (A2c) held against the JAX
reference on the CPU: ``quantize_v2``, ``dequantize_v2``,
``quantized_fully_connected`` and ``quantized_conv`` (Q1's and Q2's
plain versions run here), calibration's ``optimal_thresholds`` and
``_Collector``, ``quantize_net`` on the two nets the reference can
quantize, the weight bridge of a quantized net, and every quantized layer
of a ``resnet18_v1`` against the reference's op chain on its captured
input.  The same seeded numpy inputs go to both frameworks.

Tolerances: none for the ops.  The payloads, ranges, int32 sums and
outputs are compared bit for bit (``np.array_equal``): both sides round
the same float32 operations once each in the same order (XLA's CPU
contracts no multiply-add here).  In ``quantize_net`` the float layers
between the quantized ones (BatchNorm, relu, pooling, and the float
layers of an excluded one) may round apart by an ulp in the two
frameworks: the calibrated ranges are held within 1e-6 relative
(``RANGE_TOL``; the net's input's range exactly), the outputs within
1e-5 of the reference's largest output (``NET_TOL``) with their argmax
equal.

The reference cannot quantize a ResNet itself: its trace of a bias-free
``Convolution`` records two inputs for three argument slots and its
calibration raises ``StopIteration`` (``mxtpu/symbol/symbol.py:323``).
So the whole-ResNet test holds each quantized layer of the port's net to
the reference's ops (``quantize_v2`` then ``quantized_conv`` /
``quantized_fully_connected``, weights by its ``quantize_params``) on
that layer's captured input.

The reference names traced nodes by a process-global counter; these
tests read it before each ``quantize_net`` to name its nodes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.contrib import quantization as R
from mxtpu.gluon import nn as jnn
from mxtpu.symbol import symbol as jsym
from mxtpu_torch import base
from mxtpu_torch.base import MXTPUError
from mxtpu_torch.contrib import quantization as P
from mxtpu_torch.gluon import nn as pnn
from mxtpu_torch.gluon.model_zoo import vision
from mxtpu_torch.models.convert import (export_mxtpu_params,
                                        load_mxtpu_params,
                                        strip_instance_prefix)
from mxtpu_torch.ops import quantized as Q

#: quantize_net's outputs against the reference's, over its largest one
NET_TOL = 1e-5
#: a calibrated range against the reference's, relative: a layer behind a
#: float one sees that layer's float32 output, which the port (torch's
#: matmul, conv) and XLA may round apart by an ulp (2**-23 relative)
RANGE_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(port, ref, what=""):
    port = port.detach().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert port.dtype == ref.dtype, (what, port.dtype, ref.dtype)
    assert np.array_equal(port, ref), (what, np.abs(
        port.astype(np.float64) - ref.astype(np.float64)).max())


# -- the ops -----------------------------------------------------------------

def _quantize_case(case):
    rng = np.random.RandomState(3)
    if case == "randn":
        return rng.randn(3, 5, 7).astype("f") * 2.5, None
    if case == "calibrated":
        return rng.randn(4, 33).astype("f"), (-1.3, 2.1)
    if case == "half_steps":
        # a range of +-127 makes the scale exactly 1: every value is an
        # exact half-step, rounded half to even, or beyond the range
        x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5, 126.5,
                      -126.5, 127.5, 200.0, -300.0, 0.0], "f")
        return x, (-127.0, 127.0)
    if case == "beyond_range":
        return rng.randn(64).astype("f") * 4, (-0.5, 0.75)
    if case == "all_zero":
        return np.zeros((2, 8), "f"), None
    if case == "one_end":
        return rng.randn(16, 4).astype("f"), (None, 1.0)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["randn", "calibrated", "half_steps",
                                  "beyond_range", "all_zero", "one_end"])
def test_quantize_v2_matches_reference_bit_for_bit(case):
    x, rng_ = _quantize_case(case)
    kw = {} if rng_ is None else dict(min_calib_range=rng_[0],
                                      max_calib_range=rng_[1])
    jq, jmn, jmx = R.quantize_v2(jnp.asarray(x), **kw)
    pq, pmn, pmx = P.quantize_v2(_t(x), **kw)
    _equal(pq, jq, "payload")
    _equal(pmn, jmn, "min")
    _equal(pmx, jmx, "max")
    if case == "all_zero":
        assert not pq.any()


@pytest.mark.parametrize("case", ["randn", "calibrated", "all_zero"])
def test_dequantize_v2_matches_reference_bit_for_bit(case):
    x, rng_ = _quantize_case(case)
    kw = {} if rng_ is None else dict(min_calib_range=rng_[0],
                                      max_calib_range=rng_[1])
    jq, jmn, jmx = R.quantize_v2(jnp.asarray(x), **kw)
    pq, pmn, pmx = P.quantize_v2(_t(x), **kw)
    _equal(P.dequantize_v2(pq, pmn, pmx), R.dequantize_v2(jq, jmn, jmx))
    # ranges given as numbers, as the reference's graph attributes are
    _equal(P.dequantize_v2(pq, float(pmn), float(pmx)),
           R.dequantize_v2(jq, jmn, jmx))


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


#: (x_min, x_max, w_min, w_max): asymmetric ranges, as calibration gives
RANGES = (np.float32(-1.7), np.float32(2.3), np.float32(-0.4),
          np.float32(0.5))


def _ranges(torch_side):
    if torch_side:
        return [torch.tensor(v) for v in RANGES]
    return [jnp.asarray(v) for v in RANGES]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape", [(6, 40), (5, 3, 2, 4), (1, 147)],
                         ids=["2d", "4d_flatten", "k_tail"])
def test_quantized_fully_connected_matches_reference(shape, bias):
    rng = np.random.RandomState(sum(shape))
    x = _int8(rng, *shape)
    K = int(np.prod(shape[1:]))
    w = _int8(rng, 7, K)
    b = rng.randn(7).astype("f")
    jb = jnp.asarray(b) if bias else None
    pb = _t(b) if bias else None
    want = R.quantized_fully_connected(
        jnp.asarray(x), jnp.asarray(w), *_ranges(False), bias=jb,
        no_bias=not bias)
    got = P.quantized_fully_connected(_t(x), _t(w), *_ranges(True), bias=pb,
                                      no_bias=not bias)
    _equal(got, want)
    # no_bias wins over a bias given, as in the reference
    _equal(P.quantized_fully_connected(_t(x), _t(w), *_ranges(True),
                                       bias=_t(b), no_bias=True),
           R.quantized_fully_connected(jnp.asarray(x), jnp.asarray(w),
                                       *_ranges(False), bias=jnp.asarray(b),
                                       no_bias=True))


def test_quantized_fully_connected_without_flatten_keeps_leading_axes():
    rng = np.random.RandomState(9)
    x, w = _int8(rng, 2, 3, 16), _int8(rng, 5, 16)
    want = R.quantized_fully_connected(jnp.asarray(x), jnp.asarray(w),
                                       *_ranges(False), flatten=False)
    got = P.quantized_fully_connected(_t(x), _t(w), *_ranges(True),
                                      flatten=False)
    _equal(got, want)


#: ResNet's geometries (C_in, C_out, kernel, stride, pad), then dilation
#: and groups
CONV_CASES = {
    "stem_7x7s2": dict(C=3, O=8, kernel=(7, 7), stride=(2, 2), pad=(3, 3)),
    "1x1s1": dict(C=16, O=8, kernel=(1, 1)),
    "1x1s2": dict(C=16, O=8, kernel=(1, 1), stride=(2, 2)),
    "3x3s1": dict(C=8, O=8, kernel=(3, 3), pad=(1, 1)),
    "3x3s2": dict(C=8, O=16, kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    "dilate2": dict(C=6, O=6, kernel=(3, 3), pad=(2, 2), dilate=(2, 2)),
    "groups2": dict(C=6, O=8, kernel=(3, 3), pad=(1, 1), num_group=2),
}


def _conv_args(name):
    case = dict(CONV_CASES[name])
    C, O = case.pop("C"), case.pop("O")
    rng = np.random.RandomState(len(name) + C)
    g = case.get("num_group", 1)
    x = _int8(rng, 2, C, 13, 11)
    w = _int8(rng, O, C // g, *case["kernel"])
    return x, w, rng.randn(O).astype("f"), case


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("name", list(CONV_CASES))
def test_quantized_conv_matches_reference_bit_for_bit(name, bias):
    x, w, b, kw = _conv_args(name)
    want = R.quantized_conv(jnp.asarray(x), jnp.asarray(w), *_ranges(False),
                            bias=jnp.asarray(b) if bias else None,
                            num_filter=w.shape[0], **kw)
    base.reset_counts()
    got = P.quantized_conv(_t(x), _t(w), *_ranges(True),
                           bias=_t(b) if bias else None,
                           num_filter=w.shape[0], **kw)
    _equal(got, want)
    assert base.count(Q.QCONV) == 1


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_quantized_conv_int32_sums_are_exact(name):
    from jax import lax

    x, w, _, kw = _conv_args(name)
    stride = kw.get("stride", (1, 1))
    pad = kw.get("pad", (0, 0))
    dilate = kw.get("dilate", (1, 1))
    groups = kw.get("num_group", 1)
    dn = lax.conv_dimension_numbers(x.shape, w.shape,
                                    ("NCHW", "OIHW", "NCHW"))
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), window_strides=stride,
        padding=[(p, p) for p in pad], rhs_dilation=dilate,
        dimension_numbers=dn, feature_group_count=groups,
        preferred_element_type=jnp.int32)
    got = Q.qconv_sums(_t(x), _t(w), stride, pad, dilate, groups)
    _equal(got, want)


def test_fully_connected_int32_sums_are_exact_at_the_largest_k():
    """ResNet-50's largest sums: K = 4608 products of +-127."""
    rng = np.random.RandomState(4)
    x = np.full((3, 4608), 127, np.int8)
    x[1] = -127
    x[2] = _int8(rng, 4608)
    w = np.full((2, 4608), -127, np.int8)
    got = Q.qfc_sums(_t(x), _t(w)).numpy()
    want = x.astype(np.int64) @ w.astype(np.int64).T
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert abs(int(want[0, 0])) == 4608 * 127 * 127


@pytest.mark.parametrize("shape", [(1, 4, 6, 6), (2, 3, 5)])
def test_quantized_conv_raises_on_1d_and_3d(shape):
    x = torch.zeros(shape, dtype=torch.int8)
    w = torch.zeros((2, shape[1], 3), dtype=torch.int8)
    one = torch.tensor(1.0)
    kernel = (3,) if len(shape) == 3 else (3, 3, 3)
    with pytest.raises(MXTPUError, match="2-D"):
        P.quantized_conv(x, w, -one, one, -one, one, kernel=kernel)


def test_pack_weight_pads_k_to_32_with_zeros():
    rng = np.random.RandomState(2)
    w = _t(_int8(rng, 4, 3, 7, 7))
    packed = Q.pack_weight(w)
    assert tuple(packed.shape) == (4, 160) and packed.is_contiguous()
    assert torch.equal(packed[:, :147], w.reshape(4, 147))
    assert not packed[:, 147:].any()
    aligned = _t(_int8(rng, 4, 8, 2, 2))
    assert aligned.data_ptr() % 16 == 0
    assert Q.pack_weight(aligned).data_ptr() == aligned.data_ptr()
    # rows off a 16-byte boundary are copied to an aligned buffer
    off = _t(_int8(rng, 2 * 64 + 1))[1:].view(2, 64)
    assert off.data_ptr() % 16
    moved = Q.pack_weight(off)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, off)


def test_q1_q2_tiles_follow_the_group_width():
    """The stem's kernel: 128 pixels, 64 or 128 channels by the group's
    width.  The channels-last kernel: 64 channels where a group has 64,
    and 64 pixels where 128 would leave fewer than two blocks an SM of
    the H100's 132 (ResNet-50's 7x7 stage at batch 128)."""
    M56, M28, M14, M7 = (128 * h * h for h in (56, 28, 14, 7))
    assert Q._plan(M56, 64, "nchw") == (128, 64)
    assert Q._plan(M56, 128, "nchw") == (128, 128)
    assert Q._plan(M56, 2048, "nchw") == (128, 128)
    assert Q._plan(M56, 64) == (128, 64)
    assert Q._plan(M56, 256) == (128, 128)
    assert Q._plan(M28, 128) == (128, 128)
    assert Q._plan(M14, 256) == (128, 128)
    assert Q._plan(M7, 512) == (64, 128)
    assert Q._plan(M7, 2048) == (128, 128)
    for M, Ng in ((M56, 64), (M14, 256), (M7, 512), (M7, 2048)):
        bm, bn = Q._plan(M, Ng)
        assert -(-M // bm) * -(-Ng // bn) >= 2 * 132


# -- calibration ---------------------------------------------------------------

def _histograms():
    rng = np.random.RandomState(11)
    out = []
    for scale, outlier in ((1.0, 0.0), (0.3, 25.0), (2.0, -9.0)):
        data = rng.randn(20000) * scale
        if outlier:
            data = np.concatenate([data, [outlier]])
        th = np.abs(data).max()
        out.append(np.histogram(data.astype("f"), bins=2048,
                                range=(-th, th)))
    # the reference's own bulk-vs-outlier case
    rng = np.random.RandomState(0)
    data = np.concatenate([rng.randn(100000), [40.0]]).astype(np.float32)
    out.append(np.histogram(data, bins=2048, range=(-40, 40)))
    return out


@pytest.mark.parametrize("i", range(4), ids=["normal", "outlier",
                                            "wide", "reference_case"])
def test_optimal_thresholds_matches_reference(i):
    hist, edges = _histograms()[i]
    want = R.optimal_thresholds(hist, edges)
    got = P.optimal_thresholds(hist, edges)
    assert got == want
    if i == 3:
        assert got < 10.0


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_collector_ranges_match_reference(mode):
    rng = np.random.RandomState(5)
    batches = [("a", rng.randn(4, 8, 5).astype("f")),
               ("b", np.abs(rng.randn(6, 3)).astype("f") * 3),
               ("a", rng.randn(2, 8, 5).astype("f") * 2 - 1),
               ("b", np.abs(rng.randn(6, 3)).astype("f"))]
    want, got = R._Collector(mode), P._Collector(mode)
    for name, arr in batches:
        want.update(name, arr)
        got.update(name, _t(arr))
    assert got.ranges() == want.ranges()


# -- quantize_net --------------------------------------------------------------

def _mlp(rng):
    """The reference's ``test_quantize_net_gluon_roundtrip`` net (Dense
    with relu, Dense) and its port (the relu as its own layer), weights
    from the reference's initializer, bridged.  The reference's layers
    are made in their net's name scope, so that their names do not
    depend on the nets made before."""
    mx.random.seed(5)
    ref = jnn.HybridSequential(prefix="mlp0_")
    with ref.name_scope():
        ref.add(jnn.Dense(16, in_units=8, activation="relu"), jnn.Dense(4))
    ref.initialize()
    ref(nd.array(rng.rand(2, 8).astype("f")))
    port = pnn.HybridSequential(prefix="")
    port.add(pnn.Dense(16, in_units=8, device="cpu"), pnn.Activation("relu"),
             pnn.Dense(4, in_units=16, device="cpu"))
    x = rng.rand(8, 8).astype("f")
    calib = [rng.rand(16, 8).astype("f") for _ in range(3)]
    return ref, port, x, calib


def _conv_bn(rng):
    """The reference's ``test_quantize_net_with_batchnorm`` net:
    Conv(bias)-BN-relu-GAP-Dense, BatchNorm's running statistics moved
    off their start so that eval mode shows."""
    mx.random.seed(7)
    ref = jnn.HybridSequential(prefix="convbn0_")
    with ref.name_scope():
        ref.add(jnn.Conv2D(4, 3, padding=1, in_channels=2),
                jnn.BatchNorm(in_channels=4), jnn.Activation("relu"),
                jnn.GlobalAvgPool2D(), jnn.Flatten(),
                jnn.Dense(3, in_units=4))
    ref.initialize()
    ref(nd.array(rng.rand(1, 2, 8, 8).astype("f")))
    for name, p in ref.collect_params().items():
        if name.endswith("running_mean"):
            p.set_data(nd.array(rng.randn(4).astype("f") * 0.1))
        elif name.endswith("running_var"):
            p.set_data(nd.array(rng.rand(4).astype("f") + 0.5))
    port = pnn.HybridSequential(prefix="")
    port.add(pnn.Conv2D(4, 3, padding=1, in_channels=2, device="cpu"),
             pnn.BatchNorm(in_channels=4, device="cpu"),
             pnn.Activation("relu"), pnn.GlobalAvgPool2D(),
             pnn.Dense(3, in_units=4, device="cpu"))
    x = rng.rand(4, 2, 8, 8).astype("f")
    calib = [rng.rand(8, 2, 8, 8).astype("f") for _ in range(2)]
    return ref, port, x, calib


NETS = {"mlp": _mlp, "conv_bn": _conv_bn}


def _bridged(net_name, seed=1):
    rng = np.random.RandomState(seed)
    ref, port, x, calib = NETS[net_name](rng)
    load_mxtpu_params(port, {k: v.data().asnumpy()
                             for k, v in ref.collect_params().items()})
    return ref, port, x, calib


def _reference_quantized(ref, calib, **kw):
    """The reference's quantize_net, its node names read off its counter
    first: ({port name: reference node name}, the quantized block)."""
    counts = dict(jsym._name_counter)
    names = {}
    for op, kind in (("Convolution", "convolution"),
                     ("FullyConnected", "fullyconnected")):
        for i in range(4):
            names["%s%d" % (kind, i)] = "%s%d" % (kind,
                                                  counts.get(op, 0) + i)
    excluded = [names[n] for n in kw.pop("exclude_layers", ())]
    qnet = R.quantize_net(ref, calib_data=iter(calib) if calib else None,
                          exclude_layers=excluded, **kw)
    return names, qnet


def _reference_ranges(qnet):
    """{node name: (min, max)} of the reference's quantize nodes."""
    out = {}
    for node in qnet._sym_outputs._topo():
        if node.op == "_contrib_quantize_v2":
            out[node.name[:-len("_quantize")]] = (
                node.kwargs.get("min_calib_range"),
                node.kwargs.get("max_calib_range"))
    return out


def _by_reference_name(params):
    return {strip_instance_prefix(k): v.data().asnumpy()
            for k, v in params.items()}


@pytest.mark.parametrize("mode", ["naive", "entropy"])
@pytest.mark.parametrize("net_name", list(NETS))
def test_quantize_net_matches_reference(net_name, mode):
    ref, port, x, calib = _bridged(net_name)
    port.eval()
    ref_float = ref(nd.array(x)).asnumpy()
    names, jq = _reference_quantized(ref, calib, calib_mode=mode)
    want = jq(nd.array(x)).asnumpy()
    pq = P.quantize_net(port, calib_data=calib, calib_mode=mode)
    # the ranges
    jr = _reference_ranges(jq)
    qlayers = [m for m in pq.modules()
               if isinstance(m, (P.QuantizedConv2D, P.QuantizedDense))]
    assert not P._layers(pq) and len(qlayers) == len(jr)
    port_ranges = [(m.min_calib_range, m.max_calib_range) for m in qlayers]
    want_ranges = [jr[names[n]] for n, _, _ in P._layers(port)]
    np.testing.assert_allclose(np.float32(port_ranges),
                               np.float32(want_ranges), rtol=RANGE_TOL,
                               atol=0)
    assert port_ranges[0] == want_ranges[0]       # the data's own range
    # payloads, qmin and qmax by name
    got_params = export_mxtpu_params(pq)
    want_params = _by_reference_name(jq.collect_params())
    quantized = [k for k in want_params if k.endswith(("_quantized",
                                                       "_qmin", "_qmax"))]
    assert len(quantized) == 3 * len(jr)
    for k in quantized:
        _equal(got_params[k], want_params[k], k)
    # outputs
    base.reset_counts()
    with torch.no_grad():
        got = pq(_t(x)).numpy()
    assert np.abs(got - want).max() <= NET_TOL * np.abs(want).max()
    assert (got.argmax(1) == want.argmax(1)).all()
    if mode == "naive":
        # (the reference's own test of these nets; entropy's clipped
        # ranges may move an argmax of the float net)
        assert (got.argmax(1) == ref_float.argmax(1)).all()
    kinds = [type(m).__name__ for m in qlayers]
    assert base.count(Q.QCONV) == kinds.count("QuantizedConv2D")
    assert base.count(Q.QFC) == kinds.count("QuantizedDense")
    # the float net is left as it was
    assert not any(isinstance(m, (P.QuantizedConv2D, P.QuantizedDense))
                   for m in port.modules())


@pytest.mark.parametrize("net_name,excluded", [
    ("mlp", "fullyconnected1"), ("mlp", "fullyconnected0"),
    ("conv_bn", "convolution0")])
def test_quantize_net_exclusion_keeps_the_layer_float(net_name, excluded):
    ref, port, x, calib = _bridged(net_name)
    port.eval()
    names, jq = _reference_quantized(ref, calib,
                                     exclude_layers=[excluded])
    want = jq(nd.array(x)).asnumpy()
    pq = P.quantize_net(port, calib_data=calib, exclude_layers=[excluded])
    paths = {n: path for n, path, _ in P._layers(port)}
    kept = [(path, type(layer)) for _, path, layer in P._layers(pq)]
    assert kept == [(paths[excluded],
                     type(port.get_submodule(paths[excluded])))]
    assert names[excluded] not in _reference_ranges(jq)
    with torch.no_grad():
        got = pq(_t(x)).numpy()
    assert np.abs(got - want).max() <= NET_TOL * np.abs(want).max()
    assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("net_name", list(NETS))
def test_quantize_net_calib_mode_none_takes_runtime_ranges(net_name):
    ref, port, x, _ = _bridged(net_name)
    port.eval()
    _, jq = _reference_quantized(ref, None, calib_mode="none")
    want = jq(nd.array(x)).asnumpy()
    pq = P.quantize_net(port, calib_mode="none")
    assert all(m.min_calib_range is None and m.max_calib_range is None
               for m in pq.modules()
               if isinstance(m, (P.QuantizedConv2D, P.QuantizedDense)))
    with torch.no_grad():
        got = pq(_t(x)).numpy()
    assert np.abs(got - want).max() <= NET_TOL * np.abs(want).max()
    assert (got.argmax(1) == want.argmax(1)).all()


def test_quantize_net_raises_like_the_reference():
    ref, port, _, calib = _bridged("mlp")
    with pytest.raises(MXTPUError, match="unknown calib_mode"):
        P.quantize_net(port, calib_data=calib, calib_mode="percentile")
    with pytest.raises(MXTPUError, match="nothing to quantize"):
        P.quantize_net(port, calib_data=calib,
                       exclude_layers=["fullyconnected0", "fullyconnected1"])
    with pytest.raises(MXTPUError, match="needs calib_data"):
        P.quantize_net(port, calib_mode="entropy")
    with pytest.raises(MXTPUError, match="int8"):
        P.quantize_net(port, quantized_dtype="uint8", calib_data=calib)
    for kw in (dict(calib_mode="percentile"),
               dict(exclude_layers=["fullyconnected%d" % i
                                    for i in range(100)])):
        with pytest.raises(R.MXTPUError):
            R.quantize_net(ref, calib_data=iter(calib), **kw)


def test_quantize_net_stops_after_num_calib_examples():
    _, port, _, calib = _bridged("conv_bn")
    first = P.quantize_net(port, calib_data=calib[:1])
    capped = P.quantize_net(port, calib_data=calib, num_calib_examples=8)
    both = P.quantize_net(port, calib_data=calib)

    def ranges(net):
        return [(m.min_calib_range, m.max_calib_range)
                for m in net.modules() if isinstance(m, P.QuantizedConv2D)]

    assert ranges(capped) == ranges(first) != ranges(both)


def test_reference_quantized_params_load_into_the_port():
    """The weight bridge: the reference's own quantized parameters
    (``conv0_weight_quantized``, ``…_qmin``, ``…_qmax``, the float bias
    and BatchNorm's tensors) load into the port's quantized block by
    name, and the block computes the reference's output with them."""
    ref, port, x, calib = _bridged("conv_bn", seed=4)
    port.eval()
    _, jq = _reference_quantized(ref, calib)
    want = jq(nd.array(x)).asnumpy()
    pq = P.quantize_net(port, calib_data=calib)
    given = _by_reference_name(jq.collect_params())
    for t in pq.collect_params().values():
        with torch.no_grad():
            t.zero_()
    load_mxtpu_params(pq, given)
    again = export_mxtpu_params(pq)
    assert sorted(again) == sorted(given)
    for k in given:
        _equal(again[k], given[k], k)
    with torch.no_grad():
        got = pq(_t(x)).numpy()
    assert np.abs(got - want).max() <= NET_TOL * np.abs(want).max()


# -- the whole ResNet ----------------------------------------------------------

class _Args:
    """The two methods of a traced symbol ``quantize_params`` reads."""

    def __init__(self, names):
        self.names = names

    def list_arguments(self):
        return self.names

    def list_auxiliary_states(self):
        return []


def _resnet18(rng):
    net = vision.resnet18_v1(classes=10, device="cpu")
    params = {}
    for name, t in net.collect_params().items():
        shape = tuple(t.shape)
        if name.endswith("running_var"):
            params[name] = (rng.rand(*shape) + 0.5).astype("f")
        elif name.endswith(("gamma", "running_mean", "beta", "bias")):
            params[name] = (rng.randn(*shape) * 0.1
                            + name.endswith("gamma")).astype("f")
        else:
            fan_in = int(np.prod(shape[1:]))
            params[name] = (rng.randn(*shape) * np.sqrt(2.0 / fan_in)
                            ).astype("f")
    load_mxtpu_params(net, params)
    return net.eval(), params


def test_resnet18_every_quantized_layer_matches_the_reference_ops():
    """``quantize_net`` replaces all 20 convolutions and the Dense of
    ``resnet18_v1`` (32x32, batch 2); each quantized layer's output on
    its captured float input equals the reference's ``quantize_v2`` then
    ``quantized_conv`` / ``quantized_fully_connected`` with the weights
    of its ``quantize_params``, and the calibrated ranges equal the
    reference's ``_Collector`` fed the same layers' inputs."""
    rng = np.random.RandomState(0)
    net, params = _resnet18(rng)
    calib = [rng.rand(2, 3, 32, 32).astype("f") for _ in range(2)]
    x = rng.rand(2, 3, 32, 32).astype("f")
    qnet = P.quantize_net(net, calib_data=calib)
    qlayers = [(n, m) for n, m in qnet.named_modules()
               if isinstance(m, (P.QuantizedConv2D, P.QuantizedDense))]
    kinds = [type(m).__name__ for _, m in qlayers]
    assert kinds.count("QuantizedConv2D") == 20
    assert kinds.count("QuantizedDense") == 1
    assert not P._layers(qnet)

    # the ranges: the reference's collector on the float net's inputs
    collector = R._Collector("naive")
    float_layers = {path: layer for _, path, layer in P._layers(net)}
    names = {path: name for name, path, _ in P._layers(net)}
    hooks = [layer.register_forward_hook(
        lambda m, a, o, name=names[path]: collector.update(
            name, a[0].numpy())) for path, layer in float_layers.items()]
    with torch.no_grad():
        for b in calib:
            net(_t(b))
    for h in hooks:
        h.remove()
    want_ranges = collector.ranges()
    for path, m in qlayers:
        assert (m.min_calib_range, m.max_calib_range) == \
            want_ranges[names[path]], path

    # each layer on its captured input
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, a, o, path=path: seen.__setitem__(path, (a[0], o)))
        for path, m in qlayers]
    base.reset_counts()
    with torch.no_grad():
        logits = qnet(_t(x))
    for h in hooks:
        h.remove()
    assert base.count(Q.QCONV) == 20 and base.count(Q.QFC) == 1
    assert torch.isfinite(logits).all()
    for path, m in qlayers:
        inp, out = seen[path]
        wname = names[path] + "_weight"
        wparams = R.quantize_params(
            _Args([wname + "_quantized"]),
            {wname: nd.array(params[_param_name(net, path)])})
        wq = wparams[wname + "_quantized"].asnumpy()
        wmin = wparams[wname + "_qmin"].asnumpy()
        wmax = wparams[wname + "_qmax"].asnumpy()
        _equal(m.weight_quantized, wq, path)
        _equal(m.weight_qmin, wmin, path)
        _equal(m.weight_qmax, wmax, path)
        q, mn, mx_ = R.quantize_v2(jnp.asarray(inp.numpy()),
                                   m.min_calib_range, m.max_calib_range)
        bias = None if m.bias is None else jnp.asarray(m.bias.numpy())
        if isinstance(m, P.QuantizedConv2D):
            kw = {k: v for k, v in m._kwargs.items()}
            want = R.quantized_conv(q, jnp.asarray(wq), mn, mx_,
                                    jnp.asarray(wmin), jnp.asarray(wmax),
                                    bias=bias, **kw)
        else:
            want = R.quantized_fully_connected(
                q, jnp.asarray(wq), mn, mx_, jnp.asarray(wmin),
                jnp.asarray(wmax), bias=bias)
        _equal(out, want, path)


def _param_name(net, path):
    """The bridge's name of the float weight of the layer at ``path``."""
    layer = net.get_submodule(path)
    for name, t in net.collect_params().items():
        if t is layer.weight:
            return name
    raise KeyError(path)


# -- the card check's helpers, rehearsed on the CPU -----------------------------

def test_chip_smoke_counts_and_captures_q1_by_geometry():
    """``chip_smoke.py``'s phase 16 plumbing on a narrow quantized ResNet:
    ``FirstByKey`` counts Q1's calls by geometry and keeps each first
    call's inputs, which replay to the same output; ``PlainQuant`` puts
    the plain versions in the wrappers' place (the CPU route is plain
    already, so the logits are equal); the bound prices int8 products."""
    import chip_smoke

    rng = np.random.RandomState(3)
    net = vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                          [8, 16, 32, 64, 128], classes=5, device="cpu")
    load_mxtpu_params(net, {k: (rng.randn(*t.shape) * 0.1 + (
        1.0 if k.endswith(("gamma", "running_var")) else 0.0)).astype("f")
        for k, t in net.collect_params().items()})
    net.eval()
    qnet = P.quantize_net(net, calib_data=[rng.rand(2, 3, 32, 32)
                                           .astype("f")])
    x = _t(rng.rand(2, 3, 32, 32).astype("f"))
    by_geom = chip_smoke.FirstByKey(Q, "qconv", chip_smoke.qconv_key)
    with by_geom, torch.no_grad():
        got = qnet(x)
    assert Q.qconv is not by_geom
    convs = sum(isinstance(m, P.QuantizedConv2D) for m in qnet.modules())
    assert sum(by_geom.counts.values()) == convs == 17
    assert (3, 8, 7, 2, 32) in by_geom.counts
    assert chip_smoke.qconv_row((3, 8, 7, 2, 32)) == "qconv[3->8,7x7s2,32]"
    for key, (args, kw) in by_geom.args.items():
        out = Q.qconv(*args, **kw)
        nbytes, ops = chip_smoke.qconv_work(args[0], args[1], args[3], out,
                                            *args[4:7])
        assert ops == 2 * out.numel() * args[1][0].numel()
        ms, by = chip_smoke.bound(nbytes, ops, torch.int8)
        assert ms > 0 and by in ("bytes", "operations")
    with chip_smoke.PlainQuant(), torch.no_grad():
        assert Q.qfc is Q.qfc_plain
        plain = qnet(x)
    assert Q.qfc is not Q.qfc_plain
    assert torch.equal(got, plain)


@pytest.mark.parametrize("geom", [(7, 2, 3, 1, 32), (1, 2, 0, 1, 16),
                                  (1, 2, 0, 1, 15), (1, 1, 0, 1, 9),
                                  (3, 2, 1, 1, 15), (3, 1, 2, 2, 12)],
                         ids=lambda g: "k%ds%dp%dd%d-%d" % g)
def test_chip_smoke_prices_only_the_input_a_conv_reads(geom):
    """Q1's bytes bound counts the input pixels that the strides and
    dilation reach (a 1x1 stride-2 conv reads a quarter of x), found here
    independently as the pixels whose gradient is not zero, and the bias
    only where there is one."""
    import chip_smoke

    k, s, p, d, H = geom
    N, C, Co = 2, 3, 4
    OH = Q.conv_out_size(H, k, s, p, d)
    x = torch.zeros((N, C, H, H), dtype=torch.int8)
    w = torch.ones((Co, C, k, k), dtype=torch.int8)
    out = torch.zeros((N, Co, OH, OH))
    grad = torch.nn.grad.conv2d_input(
        (1, 1, H, H), torch.ones((1, 1, k, k), dtype=torch.float64),
        torch.ones((1, 1, OH, OH), dtype=torch.float64), stride=s,
        padding=p, dilation=d)
    read = int((grad != 0).sum())
    if (k, s) == (1, 2):
        assert read == ((H + 1) // 2) ** 2
    for bias in (None, torch.zeros(Co)):
        nbytes, ops = chip_smoke.qconv_work(x, w, bias, out, (s, s), (p, p),
                                            (d, d))
        assert nbytes == N * C * read + w.numel() + 4 * out.numel() + (
            0 if bias is None else 4 * Co)
        assert ops == 2 * out.numel() * C * k * k
