"""Q1's channels-last route and Q3, the quantizer that writes its input,
held against the JAX reference on the CPU (their plain versions run
here; the kernels on the card, ``tests/test_torch_cuda.py -k quant``).

- Q3's plain version (``ops/quantized.py:quantize_nhwc_plain``) and the
  quantized layer's channels-last payload equal the reference's
  ``quantize_v2`` bit for bit (calibrated and runtime ranges, half-steps,
  values out of range, +-inf), stored channels-last.
- Q1's plain version on a channels-last payload equals the reference's
  ``quantized_conv`` bit for bit at ResNet-50's 20 conv geometries at
  batch 1.
- A numpy emulation of ``qconv_nhwc_kernel``'s A-tile address map (each
  pixel row's 16-byte chunks of each 64-byte K step: the byte offset in
  x it copies, or a zero-fill) reproduces ``F.unfold``'s columns in (r,
  s, c) order, and its product with the OHWI-packed weights gives the
  reference's int32 sums, at those geometries and at padding, stride,
  dilation, group and tail edges.
- The route by layout, the quantized layer's choice of route, and
  ``chip_smoke.py``'s new helpers (Q3's rows, the ``_int_mm``
  yardstick, ptxas's report of Q1 and Q3).

Tolerances: none; every comparison is exact (``np.array_equal`` /
``torch.equal``): the int32 sums are exact in any order and both sides
round the same float32 operations once each in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from mxtpu.contrib import quantization as R
from mxtpu_torch import base
from mxtpu_torch.base import MXTPUError
from mxtpu_torch.contrib import quantization as P
from mxtpu_torch.ops import quantized as Q

#: ResNet-50 v1's 20 distinct conv geometries (C_in, C_out, kernel,
#: stride, pad, input size)
RESNET50_QCONV = [g for g, _ in chip_smoke.RESNET50_QCONV]
NON_STEM = RESNET50_QCONV[1:]
#: (N, C_in, C_out, kernel, stride, pad, dilate, groups, H, W): a K step
#: across 4, 2 and 4/3 taps (C / groups 16, 32, 48), padding beyond the
#: kernel's reach, dilation, odd sizes, groups, pixel tails
EDGES = [
    (2, 16, 24, 3, 1, 1, 1, 1, 9, 7),
    (1, 32, 8, 3, 2, 2, 1, 1, 11, 13),
    (3, 48, 40, 3, 1, 2, 2, 1, 10, 9),
    (2, 64, 64, 5, 2, 4, 1, 1, 12, 12),
    (1, 64, 32, 3, 1, 1, 3, 2, 15, 8),
    (2, 96, 96, 1, 3, 0, 1, 3, 17, 5),
    (1, 16, 16, 7, 1, 3, 1, 1, 7, 7),
    (2, 256, 64, 3, 2, 1, 1, 4, 9, 9),
]


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cl(x):
    return x.contiguous(memory_format=torch.channels_last)


def _cl_strides(q):
    N, C, H, W = q.shape
    return q.stride() == (C * H * W, 1, W * C, C)


# -- Q3 ----------------------------------------------------------------------

def _q3_case(case):
    """(x (2, C, H, W) float32, (min, max) or None for x's own range)."""
    rng = np.random.RandomState(7)
    if case == "calibrated":
        return rng.randn(2, 32, 5, 7).astype("f"), (-1.3, 2.1)
    if case == "runtime":
        return (rng.randn(2, 48, 7, 7) * 3).astype("f"), None
    if case == "half_steps":
        # a range of +-127 makes the scale 1: exact half-steps, rounded
        # half to even, and values beyond the range
        v = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5, 126.5,
                      -126.5, 127.5, 200.0, -300.0, 0.0, -0.0, 3.49999,
                      -3.5], "f")
        return np.resize(v, (2, 16, 3, 5)).astype("f"), (-127.0, 127.0)
    if case == "beyond_range":
        return (rng.randn(2, 16, 9, 33) * 4).astype("f"), (-0.5, 0.75)
    if case == "inf":
        x = rng.randn(2, 64, 3, 3).astype("f")
        x[0, 3, 1, 1], x[1, 60, 0, 2] = np.inf, -np.inf
        return x, (-2.0, 2.0)
    raise ValueError(case)


Q3_CASES = ["calibrated", "runtime", "half_steps", "beyond_range", "inf"]


@pytest.mark.parametrize("case", Q3_CASES)
def test_q3_plain_equals_reference_quantize_v2(case):
    x, rng_ = _q3_case(case)
    kw = {} if rng_ is None else dict(min_calib_range=rng_[0],
                                      max_calib_range=rng_[1])
    jq, jmn, jmx = R.quantize_v2(jnp.asarray(x), **kw)
    mn = torch.tensor(np.asarray(jmn))
    mx = torch.tensor(np.asarray(jmx))
    got = Q.quantize_nhwc_plain(_t(x), P._q_scale(mn, mx))
    assert got.dtype == torch.int8 and _cl_strides(got)
    assert np.array_equal(got.numpy(), np.asarray(jq))


@pytest.mark.parametrize("case", Q3_CASES)
def test_q3_through_the_quantized_layer_equals_reference(case):
    """The layer's channels-last payload (``_quantize(x, True)``, the
    wrapper counted once) and its NCHW one (``quantize_v2``) hold the
    reference's values; only the strides differ."""
    x, rng_ = _q3_case(case)
    C = x.shape[1]
    layer = P.QuantizedConv2D(8, C, (1, 1), calib_range=rng_, device="cpu")
    jq, jmn, jmx = R.quantize_v2(
        jnp.asarray(x), *(rng_ if rng_ is not None else (None, None)))
    base.reset_counts()
    q, mn, mx = layer._quantize(_t(x), channels_last=True)
    assert base.counts() == {Q.QUANTIZE_NHWC: 1}
    q2, _, _ = layer._quantize(_t(x))
    assert _cl_strides(q) and q2.is_contiguous()
    for a in (q, q2):
        assert np.array_equal(a.numpy(), np.asarray(jq))
    assert np.array_equal(mn.numpy(), np.asarray(jmn))
    assert np.array_equal(mx.numpy(), np.asarray(jmx))


def test_quantize_v2_keeps_nchw_payloads():
    x = _t(np.random.RandomState(1).randn(2, 32, 4, 4).astype("f"))
    q, _, _ = P.quantize_v2(x)
    assert q.is_contiguous() and not _cl_strides(q)


# -- Q1 on channels-last payloads: the plain version -------------------------

def _geom_id(g):
    return "%dto%d-%dx%ds%d-%d" % (g[0], g[1], g[2], g[2], g[3], g[5])


RANGES = (np.float32(-1.7), np.float32(2.3), np.float32(-0.4),
          np.float32(0.5))


@pytest.mark.parametrize("geom", RESNET50_QCONV, ids=_geom_id)
def test_q1_on_the_channels_last_payload_equals_reference(geom):
    Ci, Co, k, s, p, H = geom
    rng = np.random.RandomState(sum(geom))
    x, w = _int8(rng, 1, Ci, H, H), _int8(rng, Co, Ci, k, k)
    b = rng.randn(Co).astype("f")
    kw = dict(kernel=(k, k), stride=(s, s), pad=(p, p), num_filter=Co)
    want = R.quantized_conv(jnp.asarray(x), jnp.asarray(w),
                            *[jnp.asarray(v) for v in RANGES],
                            bias=jnp.asarray(b), **kw)
    xt = _t(x) if Ci % 16 else _cl(_t(x))
    form = Q.route(xt, 1, (k, k))
    assert form == ("stem" if Ci <= 4 else "nchw" if Ci % 16 else "nhwc")
    base.reset_counts()
    got = P.quantized_conv(xt, _t(w), *[torch.tensor(v) for v in RANGES],
                           bias=_t(b),
                           packed_weight=Q.pack_weight(_t(w), form == "nhwc",
                                                       form == "stem"),
                           **kw)
    assert got.is_contiguous()
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert base.count(Q.QCONV) == 1
    assert base.count(Q.QCONV_NHWC) == (form == "nhwc")
    assert base.count(Q.QCONV_STEM) == (form == "stem")


# -- Q1's channels-last kernel, emulated -------------------------------------

def _a_tile_map(N, C, H, W, KH, KW, sh, sw, ph, pw, dh, dw, groups, g, Kp,
                BM):
    """``qconv_nhwc_kernel``'s A-tile addresses for group g, emulated in
    its own arithmetic: for every pixel row of the tiles (M rounded up to
    BM) and every 16-byte chunk of every 64-byte K step, the byte offset
    in x (stored (N, H, W, C)) that its cp.async copies, or -1 where it
    zero-fills.  A thread's chunk q keeps (k, r, s, c), set once by
    division and stepped by 64 bytes a stage; a row keeps its image
    offset and its first tap's position."""
    Cg = C // groups
    OH = Q.conv_out_size(H, KH, sh, ph, dh)
    OW = Q.conv_out_size(W, KW, sw, pw, dw)
    OHW, M, K = OH * OW, N * OH * OW, Cg * KH * KW
    m = np.arange(-(-M // BM) * BM, dtype=np.int64)
    img, p = m // OHW, m % OHW
    oh, ow = p // OW, p % OW
    live = m < M
    ih0 = np.where(live, oh * sh - ph, -(1 << 29))
    iw0 = np.where(live, ow * sw - pw, -(1 << 29))
    xoff = np.where(live, img * H * W * C + g * Cg, 0)
    nk = -(-Kp // 64)
    out = np.full((len(m), 4 * nk), -1, np.int64)
    for q in range(4):
        k = 16 * q
        t = k // Cg
        c = k - t * Cg
        r = t // KW
        s = t - r * KW
        for kt in range(nk):
            ih, iw = ih0 + r * dh, iw0 + s * dw
            ok = (k < K) & (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
            out[:, 4 * kt + q] = np.where(ok, xoff + (ih * W + iw) * C + c,
                                          -1)
            k += 64
            c += 64
            while c >= Cg:
                c -= Cg
                s += 1
                if s == KW:
                    s = 0
                    r += 1
    return out, M, K


def _a_tile(x, addr):
    """The A tile's bytes: each chunk's 16 bytes from x's channels-last
    storage, zeros where the map zero-fills."""
    flat = x.permute(0, 2, 3, 1).reshape(-1).numpy()
    rows, chunks = addr.shape
    idx = addr[:, :, None] + np.arange(16)
    tile = np.where(addr[:, :, None] >= 0, flat[np.maximum(idx, 0)], 0)
    return tile.reshape(rows, chunks * 16).astype(np.int64)


def _check_a_map(N, Ci, Co, k, s, p, d, groups, H, W, seed, BM):
    rng = np.random.RandomState(seed)
    x = _cl(_t(_int8(rng, N, Ci, H, W)))
    w = _t(_int8(rng, Co, Ci // groups, k, k))
    packed = Q.pack_weight(w, channels_last=True)
    Kp, Cg, Ng = packed.shape[1], Ci // groups, Co // groups
    sums = Q.qconv_sums(x, w, (s, s), (p, p), (d, d), groups)
    for g in range(groups):
        addr, M, K = _a_tile_map(N, Ci, H, W, k, k, s, s, p, p, d, d, groups,
                                 g, Kp, BM)
        A = _a_tile(x, addr)
        cols = F.unfold(x[:, g * Cg:(g + 1) * Cg].double(), (k, k),
                        dilation=d, padding=p, stride=s)
        L = cols.shape[-1]
        want = cols.reshape(N, Cg, k * k, L).permute(0, 3, 2, 1).reshape(
            N * L, K)
        assert A.shape[0] >= M and A.shape[1] >= Kp
        assert np.array_equal(A[:M, :K], want.numpy().astype(np.int64))
        assert not A[:M, K:].any() and not A[M:].any()
        # the GEMM over the OHWI rows gives the reference's int32 sums
        wg = packed[g * Ng:(g + 1) * Ng].numpy().astype(np.int64)
        got = A[:M, :Kp] @ wg.T
        ref = sums[:, g * Ng:(g + 1) * Ng].permute(0, 2, 3, 1).reshape(
            M, Ng).numpy()
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("geom", NON_STEM, ids=_geom_id)
def test_q1_a_tile_map_reproduces_unfold_at_resnet50_geometries(geom):
    Ci, Co, k, s, p, H = geom
    bm, _ = Q._plan(128 * Q.conv_out_size(H, k, s, p, 1) ** 2, Co)
    _check_a_map(1, Ci, Co, k, s, p, 1, 1, H, H, sum(geom), bm)


@pytest.mark.parametrize("case", EDGES,
                         ids=lambda c: "N%d-%dto%d-k%ds%dp%dd%dg%d-%dx%d" % c)
@pytest.mark.parametrize("BM", [64, 128])
def test_q1_a_tile_map_reproduces_unfold_at_its_edges(case, BM):
    _check_a_map(*case, seed=sum(case), BM=BM)


def test_pack_weight_channels_last_is_ohwi_padded():
    w = _t(_int8(np.random.RandomState(5), 6, 16, 3, 3))
    packed = Q.pack_weight(w, channels_last=True)
    assert tuple(packed.shape) == (6, 160) and packed.data_ptr() % 16 == 0
    assert torch.equal(packed[:, :144], w.permute(0, 2, 3, 1).reshape(6, 144))
    assert not packed[:, 144:].any()
    one = _t(_int8(np.random.RandomState(6), 8, 64, 1, 1))
    assert torch.equal(Q.pack_weight(one, True), Q.pack_weight(one))


# -- the route ---------------------------------------------------------------

def test_q1_routes_by_layout():
    x = torch.zeros((2, 32, 5, 5), dtype=torch.int8)
    assert Q.route(x) == "nchw"
    assert Q.route(_cl(x)) == "nhwc"
    assert Q.route(_cl(x), groups=2) == "nhwc"      # 16 a group
    assert Q.route(_cl(x), groups=4) is None        # 8 a group
    assert Q.route(_cl(torch.zeros((2, 8, 5, 5), dtype=torch.int8))) is None
    assert Q.route(x[:, :, 1:]) is None             # neither layout
    # one pixel: both layouts at once, the channels-last kernel takes it
    assert Q.route(torch.zeros((2, 32, 1, 1), dtype=torch.int8)) == "nhwc"


def test_quantized_conv_layer_takes_q3_where_its_channels_allow():
    """A layer of 16 input channels a group quantizes its float input by
    Q3 and runs Q1's channels-last route, whatever the input's layout
    (one stored channels-last or strided is copied NCHW first, so the
    payload and the packed weights agree); with the route off, or the
    stem's 3 channels (the stem's route), the torch chain and NCHW; the
    outputs are the same bits either way."""
    rng = np.random.RandomState(2)
    x = _t(rng.randn(2, 32, 9, 9).astype("f"))
    for calib in (None, (-2.5, 3.0)):
        layer = P.QuantizedConv2D(24, 32, (3, 3), padding=(1, 1), groups=2,
                                  calib_range=calib, device="cpu")
        layer.weight_quantized.copy_(_t(_int8(rng, 24, 16, 3, 3)))
        layer.weight_qmin.fill_(-0.3)
        layer.weight_qmax.fill_(0.3)
        base.reset_counts()
        with torch.no_grad():
            got = layer(x)
        assert base.counts() == {Q.QUANTIZE_NHWC: 1, Q.QCONV: 1,
                                 Q.QCONV_NHWC: 1}
        layer._nhwc = False
        base.reset_counts()
        with torch.no_grad():
            want = layer(x)
        assert base.counts() == {Q.QCONV: 1}
        assert torch.equal(got, want)
        layer._nhwc = True
        for other, same in [(_cl(x), x), (x[:, :, 1:],
                                          x[:, :, 1:].contiguous())]:
            base.reset_counts()
            with torch.no_grad():
                out = layer(other)
            assert base.counts() == {Q.QUANTIZE_NHWC: 1, Q.QCONV: 1,
                                     Q.QCONV_NHWC: 1}
            with torch.no_grad():
                assert torch.equal(out, layer(same))
    stem = P.QuantizedConv2D(8, 3, (7, 7), strides=(2, 2), padding=(3, 3),
                             device="cpu")
    base.reset_counts()
    with torch.no_grad():
        stem(_t(rng.randn(1, 3, 20, 20).astype("f")))
    assert base.counts() == {Q.QCONV: 1, Q.QCONV_STEM: 1}


def test_q3_wrapper_counts_on_the_cpu_and_raises_on_other_devices():
    x = torch.ones((1, 16, 2, 2))
    base.reset_counts()
    Q.quantize_nhwc(x, torch.tensor(0.5))
    assert base.counts() == {Q.QUANTIZE_NHWC: 1}
    with pytest.raises(MXTPUError):
        Q.quantize_nhwc(x.to("meta"), torch.tensor(0.5, device="meta"))


# -- chip_smoke.py's helpers -------------------------------------------------

def test_chip_smoke_rows_and_yardstick_of_q1_and_q3():
    """Q3's row names, the ``_int_mm`` yardstick (one int8 product on the
    channels-last payload viewed (N*H*W, C), then the epilogue) equal to
    Q1's plain version where it applies and absent elsewhere, Q3's
    library named, phase 6d and 6s taking every other request of phase
    5's traffic and 6s one motif request of each kind."""
    assert chip_smoke.quantize_row((128, 64, 56, 56)) == \
        "quantize_nhwc[64x56x56]"
    x = torch.zeros((4, 64, 3, 5))
    assert chip_smoke.quantize_key((x, None), {}) == (4, 64, 3, 5)
    rng = np.random.RandomState(4)
    xq = _cl(_t(_int8(rng, 2, 32, 5, 3)))
    w = _t(_int8(rng, 24, 32, 1, 1))
    scale, bias = torch.tensor(3e-5), _t(rng.randn(24).astype("f"))
    lib = chip_smoke.qconv_int_mm(xq, w, scale, bias, (1, 1), (0, 0),
                                  (1, 1), 1)
    assert torch.equal(lib(), Q.qconv_plain(xq, w, scale, bias))
    for args in [(xq.contiguous(), w), (xq, _t(_int8(rng, 8, 32, 3, 3)))]:
        assert chip_smoke.qconv_int_mm(*args, scale, None, (1, 1), (0, 0),
                                       (1, 1), 1) is None
    assert chip_smoke.qconv_int_mm(xq, w, scale, None, (2, 2), (0, 0),
                                   (1, 1), 1) is None
    assert "quantize_per_tensor" in chip_smoke.Q3_LIBRARY
    assert len(list(range(12))[chip_smoke.CUT]) == 6

    def kind(i):
        kw = chip_smoke.motif_kwargs(i)
        return ("none" if kw.get("speculative") is False else
                "linear" if kw.get("spec_tree") is False else "tree",
                "temperature" in kw, "repetition_penalty" in kw)
    cut = [kind(i) for i in chip_smoke.MOTIF_CUT]
    assert len(cut) == 6 and set(cut) == {kind(i) for i in range(12)}


def test_resnet50_tables_are_the_nets_convs():
    """``chip_smoke.py``'s ``RESNET50_QCONV`` and ``RESNET50_Q3`` (which
    ``kernel_ab.py`` and the card tests read) are ResNet-50 v1's convs at
    224x224, traced on the meta device: each geometry with its calls a
    forward, and the input shapes of the convs whose channels a group
    are a multiple of 16, each with its calls."""
    from mxtpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxtpu_torch.gluon.nn import Conv2D

    net = resnet50_v1(device="meta")
    geoms, shapes = {}, {}

    def hook(mod, args):
        k, (n, c, h, w) = mod._kwargs, args[0].shape
        assert h == w and k["kernel"][0] == k["kernel"][1]
        g = (c, int(mod.weight.shape[0]), k["kernel"][0], k["stride"][0],
             k["pad"][0], h)
        geoms[g] = geoms.get(g, 0) + 1
        if (c // k["num_group"]) % 16 == 0:
            shapes[(c, h)] = shapes.get((c, h), 0) + 1

    for m in net.modules():
        if isinstance(m, Conv2D):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        net(torch.empty(1, 3, 224, 224, device="meta"))
    assert sorted(geoms.items()) == sorted(chip_smoke.RESNET50_QCONV)
    assert sorted(shapes.items()) == sorted(chip_smoke.RESNET50_Q3)
    assert sum(geoms.values()) == chip_smoke.QUANT["qconv"]
    assert sum(shapes.values()) == chip_smoke.QUANT["quantize_nhwc"]


PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117qconv_nhwc_kernelILi128ELi128EEEvNS_8NhwcArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117qconv_nhwc_kernelILi128ELi128EEEvNS_8NhwcArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 0 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19qfc_kernelILi64ELi64EEEvNS_6FcArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19qfc_kernelILi64ELi64EEEvNS_6FcArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 94 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112qconv_kernelILi64EEEvNS_8ConvArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112qconv_kernelILi64EEEvNS_8ConvArgsE
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 137 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117qconv_stem_kernelENS_8StemArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117qconv_stem_kernelENS_8StemArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120quantize_nhwc_kernelEPKfS2_Paii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120quantize_nhwc_kernelEPKfS2_Paii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers
"""


def test_chip_smoke_reads_q1_and_q3_registers_and_spills():
    """Every Q1 kernel's (the stem's too), Q2's and Q3's registers and
    spills are read from ptxas's report."""
    got = chip_smoke.quant_kernel_registers(PTXAS)
    assert [(k["kernel"], k["template"]) for k in got] == [
        ("qconv[nhwc]", [128, 128]), ("qfc", [64, 64]), ("qconv[nchw]", [64]),
        ("qconv[stem]", []), ("quantize_nhwc", [])]
    assert [k["registers"] for k in got] == [126, 94, 137, 110, 40]
    assert [(k["spill_stores"], k["spill_loads"]) for k in got] == [
        (0, 0), (0, 0), (4, 8), (0, 0), (0, 0)]
