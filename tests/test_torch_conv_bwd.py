"""K6, the fused 3x3 stride-1 conv backward, held against the JAX
reference on the CPU: the port's plain version (what the wrapper runs on
a CPU tensor) against the reference's Pallas kernel under ``jax.vjp``
(interpret mode on the CPU, as ``tests/test_conv_bwd_pallas.py`` runs
it) and against XLA's autodiff of ``lax.conv_general_dilated``, on the
reference test's shapes (N, H, W, Ci, Co) and a bfloat16 case; the
autograd Function and the wrapper's counter; and the routing rule
(``eligible``/``fits``) against the reference's, down to the 13 convs of
ResNet-50 v1 at 224x224 that take the kernel.

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
