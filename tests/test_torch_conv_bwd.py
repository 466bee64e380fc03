"""K6, the fused 3x3 stride-1 conv backward, held against the JAX
reference on the CPU: the port's plain version (what the wrapper runs on
a CPU tensor) against the reference's Pallas kernel under ``jax.vjp``
(interpret mode on the CPU, as ``tests/test_conv_bwd_pallas.py`` runs
it) and against XLA's autodiff of ``lax.conv_general_dilated``, on the
reference test's shapes (N, H, W, Ci, Co) and a bfloat16 case; the
autograd Function and the wrapper's counter; and the routing rule
(``eligible``/``fits``) against the reference's, down to the 13 convs of
ResNet-50 v1 at 224x224 that take the kernel.  The CUDA kernel's
arithmetic, emulated: its 3xTF32 products (the TF32 split as
``tests/test_torch_flash_attention.py`` emulates K3's) with each k8
step's product summed in float32, rounded to nearest, held to the card's
float32 bounds against float64 at stage 1's pixel count on one-signed
inputs, where one TF32 product a step is not; and the wrapper's launch
plan (tile rows, shared memory, dW's pixel splits).

Tolerances: float32 rtol 1e-4 / atol 1e-5 (both sides sum float32
products, in other orders).  bfloat16: max abs error within 2**-7 of
the largest element, since both sides sum exact products of bfloat16
values in float32 and round once to bfloat16, and two roundings of
nearly equal values differ by at most one bfloat16 ulp, 2**-7 of the
value at most.

The port works in NCHW/OIHW, the reference in NHWC/HWIO: inputs are
drawn once with numpy and transposed for each side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mxtpu.ops.pallas import conv_bwd as ref
from mxtpu_torch import base
from mxtpu_torch.ops import conv_bwd

SHAPES = [(2, 8, 8, 16, 32), (1, 14, 14, 32, 32), (2, 7, 9, 8, 24)]


def _inputs(shape, seed=0):
    N, H, W, Ci, Co = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, Ci).astype("f")
    w = (rng.randn(3, 3, Ci, Co) * 0.1).astype("f")
    dy = rng.randn(N, H, W, Co).astype("f")
    return x, w, dy


def _port(x, w, dy, dtype=torch.float32):
    """The port's plain version on NHWC/HWIO numpy inputs; NHWC/HWIO
    float32 numpy results."""
    t = lambda a, p: torch.from_numpy(a.transpose(p).copy()).to(dtype)  # noqa: E731
    dx, dw = conv_bwd.conv_bwd_plain(t(x, (0, 3, 1, 2)), t(w, (3, 2, 0, 1)),
                                     t(dy, (0, 3, 1, 2)))
    assert dx.dtype == dtype and dw.dtype == dtype
    return (dx.float().numpy().transpose(0, 2, 3, 1),
            dw.float().numpy().transpose(2, 3, 1, 0))


def _xla_conv(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("arm", ["pallas_interpret", "xla_autodiff"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_reference_fp32(shape, arm):
    x, w, dy = _inputs(shape)
    fn = ref.conv3x3_s1 if arm == "pallas_interpret" else _xla_conv
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    got_dx, got_dw = _port(x, w, dy)
    np.testing.assert_allclose(got_dx, np.asarray(want_dx), rtol=1e-4,
                               atol=1e-5, err_msg="dx")
    np.testing.assert_allclose(got_dw, np.asarray(want_dw), rtol=1e-4,
                               atol=1e-5, err_msg="dw")


def test_plain_matches_pallas_interpret_bf16():
    x, w, dy = (a.astype(jnp.bfloat16) for a in _inputs((2, 8, 8, 16, 32), 1))
    _, vjp = jax.vjp(ref.conv3x3_s1, jnp.asarray(x), jnp.asarray(w))
    want = [np.asarray(g, dtype="float32") for g in vjp(jnp.asarray(dy))]
    got = _port(*(np.asarray(a, dtype="float32") for a in (x, w, dy)),
                dtype=torch.bfloat16)
    for g, r, name in zip(got, want, ("dx", "dw")):
        bound = 2 ** -7 * float(np.abs(r).max())
        assert float(np.abs(g - r).max()) <= bound, name


def test_autograd_function_and_wrapper_count():
    """Conv3x3S1's forward is conv2d and its backward the wrapper (one
    count per backward); its gradients are autograd's of F.conv2d."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 5, 6, 7).astype("f")).requires_grad_()
    w = torch.from_numpy(rng.randn(4, 5, 3, 3).astype("f")).requires_grad_()
    dy = torch.from_numpy(rng.randn(2, 4, 6, 7).astype("f"))
    base.reset_counts()
    y = conv_bwd.Conv3x3S1.apply(x, w)
    assert base.count(conv_bwd.NAME) == 0
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    assert base.count(conv_bwd.NAME) == 1
    y2 = F.conv2d(x, w, padding=1)
    wx, ww = torch.autograd.grad(y2, (x, w), dy)
    np.testing.assert_allclose(y.detach().numpy(), y2.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), wx.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), ww.numpy(), rtol=1e-4, atol=1e-5)


#: (ndim, kernel, stride, dilate, pad, groups, NCHW in_shape, num_filter):
#: the cases of tests/test_conv_bwd_pallas.py::test_eligibility_gate, each
#: ResNet-50 stage's 3x3 conv at batch 128 (7x7x512 fails the size rule)
#: and sizes around the 12 MiB budget
GATE = [
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 1, None, None),
    (2, (3, 3), (2, 2), (1, 1), (1, 1), 1, None, None),
    (2, (7, 7), (1, 1), (1, 1), (3, 3), 1, None, None),
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 2, None, None),
    (1, (3,), (1,), (1,), (1,), 1, None, None),
    (2, (3, 3), (1, 1), (2, 2), (1, 1), 1, None, None),
    (2, (3, 3), (1, 1), (1, 1), (0, 0), 1, None, None),
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 1, (8, 64, 56, 56), 64),
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 1, (8, 64, 224, 224), 64),
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 1, (128, 64, 56, 56), 64),
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 1, (128, 128, 28, 28), 128),
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 1, (128, 256, 14, 14), 256),
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 1, (128, 512, 7, 7), 512),
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 1, (1, 64, 112, 112), 64),
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 1, (1, 64, 128, 128), 64),
    (2, (3, 3), (1, 1), (1, 1), (1, 1), 1, (1, 300, 16, 16), 100),
]


@pytest.mark.parametrize("case", GATE, ids=[str(i) for i in range(len(GATE))])
def test_eligible_agrees_with_reference(case):
    *geom, in_shape, nf = case
    want = ref.eligible(*geom, in_shape=in_shape, num_filter=nf)
    assert conv_bwd.eligible(*geom, in_shape=in_shape, num_filter=nf) == want
    if in_shape is not None:
        N, Ci, H, W = in_shape
        assert conv_bwd.fits(H, W, Ci, nf) == ref.fits(H, W, Ci, nf)


def test_resnet50_routes_13_convs_to_the_kernel():
    """ResNet-50 v1 at (128, 3, 224, 224), traced on the meta device: of
    its 3x3 convs, the 13 of stages 1-3 take K6 by both rules and the 3 of
    stage 4 do not."""
    from mxtpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxtpu_torch.gluon.nn import Conv2D

    net = resnet50_v1(device="meta")
    seen = []

    def hook(mod, args, out):
        k = mod._kwargs
        geom = (2, k["kernel"], k["stride"], k["dilate"], k["pad"],
                k["num_group"])
        shape, nf = tuple(args[0].shape), int(mod.weight.shape[0])
        seen.append((k["kernel"],
                     ref.eligible(*geom, in_shape=shape, num_filter=nf),
                     conv_bwd.eligible(*geom, in_shape=shape, num_filter=nf)))

    for m in net.modules():
        if isinstance(m, Conv2D):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.empty(128, 3, 224, 224, device="meta"))
    assert len(seen) == 53
    assert sum(k == (3, 3) for k, _, _ in seen) == 16
    assert all(r == p for _, r, p in seen)
    assert sum(p for _, _, p in seen) == 13


# -- the CUDA kernel's 3xTF32 arithmetic, emulated ----------------------------

#: chip_smoke.py's float32 bounds for K6 against its plain version,
#: relative to the largest element: dX (GRAD_TOL) and dW (DW_TOL)
GRAD_TOL, DW_TOL = 2e-5, 1e-4


def _tf32(x):
    """float32 x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, by integer ops on the float32 bits
    (add half of the 13 dropped bits' unit to the magnitude, then clear
    them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as K6 forms it: a = ab + as, b = bb + bs in TF32, and
    small*big + big*small + big*big with float32 sums."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def _mm_tf32(a, b):
    """a @ b as one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _emulated_bwd(x, w, dy, mm):
    """K6's sums with each k8 step's product formed by ``mm``: dX adds
    one step (8 channels of one tap) at a time, in the kernel's order
    (channel slices, then taps); dW adds a tap's steps of 8 pixels in
    order within each of the wrapper's pixel splits, then the splits in
    order.  Every add is float32, rounded to nearest.  Full-width tiles
    only (W <= 64, whole tiles)."""
    N, Ci, H, W = x.shape
    Co = w.shape[0]
    P = N * H * W
    plan = conv_bwd._plan(N, H, W, Ci, Co, 4, 16)
    assert W <= 64 and plan["tr_w"] * W % 8 == 0 and H % plan["tr_w"] == 0
    xp, dyp = F.pad(x, (1, 1, 1, 1)), F.pad(dy, (1, 1, 1, 1))

    def rows(t):
        return t.permute(0, 2, 3, 1).reshape(P, -1)

    dx = torch.zeros(P, Ci)
    for s in range(0, Co, 8):
        for kh in range(3):
            for kw in range(3):
                a = rows(dyp[:, s:s + 8, 2 - kh:2 - kh + H, 2 - kw:2 - kw + W])
                dx = dx + mm(a, w[s:s + 8, :, kh, kw])
    dx = dx.reshape(N, H, W, Ci).permute(0, 3, 1, 2)
    dw = torch.empty(Co, Ci, 3, 3)
    ys = rows(dy).reshape(P // 8, 8, Co).transpose(1, 2)
    per = plan["chunk"] * plan["tr_w"] * W // 8      # steps a split
    for kh in range(3):
        for kw in range(3):
            xs = rows(xp[:, :, kh:kh + H, kw:kw + W]).reshape(P // 8, 8, Ci)
            part = mm(ys, xs)                         # (steps, Co, Ci)
            pad = -part.shape[0] % per
            part = F.pad(part, (0, 0, 0, 0, 0, pad)).reshape(-1, per, Co, Ci)
            acc = torch.zeros(part.shape[0], Co, Ci)
            for k in range(per):
                acc = acc + part[:, k]
            total = torch.zeros(Co, Ci)
            for split in acc:
                total = total + split
            dw[:, :, kh, kw] = total
    return dx, dw


def test_3xtf32_holds_the_card_bounds_where_tf32_does_not():
    """At stage 1's pixel count (128 x 56 x 56) on one-signed inputs (x =
    |randn| + 1, dY = |randn|, as post-ReLU activations are), narrow
    channels: the emulated 3xTF32 kernel is within GRAD_TOL (dX) and
    DW_TOL (dW) of the float64 gradients; one TF32 product a step puts
    dX over 10x past GRAD_TOL.  (Its dW passes: the TF32 roundings are
    to nearest, and over 401,408 one-signed terms they average out.)"""
    rng = np.random.RandomState(0)
    N, Ci, Co, H, W = 128, 8, 8, 56, 56
    x = torch.from_numpy((np.abs(rng.randn(N, Ci, H, W)) + 1).astype("f"))
    w = torch.from_numpy(rng.randn(Co, Ci, 3, 3).astype("f"))
    dy = torch.from_numpy(np.abs(rng.randn(N, Co, H, W)).astype("f"))
    x64, w64 = x.double().requires_grad_(), w.double().requires_grad_()
    want = torch.autograd.grad(F.conv2d(x64, w64, padding=1), (x64, w64),
                               dy.double())

    def over(got):
        return [float((g.double() - r).abs().max() / r.abs().max()) / tol
                for g, r, tol in zip(got, want, (GRAD_TOL, DW_TOL))]

    assert max(over(_emulated_bwd(x, w, dy, _mm_3xtf32))) <= 0.1
    assert over(_emulated_bwd(x, w, dy, _mm_tf32))[0] > 10


# -- the launch plan -----------------------------------------------------------

#: (N, Ci, Co, H, W): ResNet-50's stage shapes at batch 128 and 4, the
#: card tests' geometries, widths past one 64-column tile row, and 1-3
PLAN_SHAPES = [(128, 64, 64, 56, 56), (128, 128, 128, 28, 28),
               (128, 256, 256, 14, 14), (4, 64, 64, 56, 56),
               (4, 256, 256, 14, 14), (2, 8, 24, 7, 9), (3, 70, 66, 12, 10),
               (1, 130, 7, 5, 6), (2, 12, 20, 9, 11), (1, 8, 16, 3, 71),
               (1, 8, 16, 3, 100), (2, 3, 5, 4, 1000), (2, 8, 8, 5, 1),
               (2, 8, 8, 5, 2), (2, 8, 8, 5, 3), (1, 1, 1, 1, 1)]


@pytest.mark.parametrize("elt", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_pixel_and_fits_a_block(shape, elt):
    """Every vector width the rows allow: the tiles stay within the
    kernels' 224 (dX) and 128 (dW) pixels and one block's shared memory,
    dW's tiles cover the N*H rows and W columns, and its splits cover
    every tile once with none empty, each a whole number of tiles (so of
    k8 steps)."""
    N, Ci, Co, H, W = shape
    for vec in (16, 8, 4, 2):
        if vec < elt or (vec > elt and (W * elt) % vec):
            continue
        p = conv_bwd._plan(N, H, W, Ci, Co, elt, vec)
        tc = min(W, 64)
        assert 1 <= p["tr_x"] and p["tr_x"] * tc <= 224
        assert 1 <= p["tr_w"] and p["tr_w"] * tc <= 128
        assert conv_bwd._dx_smem(p["tr_x"], W, elt, vec) <= 232448
        assert conv_bwd._dw_smem(p["tr_w"], W, elt, vec) <= 232448
        assert p["tiles"] == -(-N * H // p["tr_w"]) * -(-W // tc)
        splits, chunk = p["splits"], p["chunk"]
        assert splits >= 1 and chunk >= 1 and isinstance(chunk, int)
        assert (splits - 1) * chunk < p["tiles"] <= splits * chunk


def test_plan_at_resnet50_stage_shapes():
    """Batch 128, float32, 16-byte copies: whole rows of 224 pixels for
    dX (4, 8 and 16 rows) and of up to 128 for dW, and dW's splits near
    the target of 264 blocks."""
    got = [conv_bwd._plan(128, H, H, C, C, 4, 16)
           for C, H in ((64, 56), (128, 28), (256, 14))]
    assert [(p["tr_x"], p["tr_w"]) for p in got] == [(4, 2), (8, 4),
                                                     (16, 9)]
    assert [(p["splits"], p["chunk"]) for p in got] == [(128, 28), (32, 28),
                                                        (8, 25)]
    for p, C in zip(got, (64, 128, 256)):
        blocks = p["splits"] * -(-C // 32) * -(-C // 64)
        assert 200 <= blocks <= 264


@pytest.mark.parametrize("W,elt,offset,want", [
    (56, 4, 0, 16), (14, 4, 0, 8), (9, 4, 0, 4), (56, 2, 0, 16),
    (28, 2, 0, 8), (10, 2, 0, 4), (9, 2, 0, 2), (56, 4, 4, 4),
    (56, 2, 2, 2), (56, 4, 8, 8)])
def test_copy_width_follows_row_and_base_alignment(W, elt, offset, want):
    assert conv_bwd._vec(W, elt, 4096, 4096 + offset) == want
