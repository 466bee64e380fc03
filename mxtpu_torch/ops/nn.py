"""Neural-net ops of the vision training path (the port of
``mxtpu/ops/nn.py`` as far as ResNet-v1 uses it): ``convolution``,
``fully_connected``, ``pooling``, ``activation_op`` and ``batch_norm``.

Layouts are MXNet's at every op: NCHW activations, OIHW conv weights,
(units, in_units) dense weights.  ``convolution`` routes a conv that
K6 takes (``conv_bwd.eligible``: 3x3, stride 1, pad 1, and the
reference's size rule) through ``conv_bwd.Conv3x3S1``, whose backward is
the K6 kernel; every other conv is ``F.conv2d`` with autograd's
backward.  The reference routes to its kernel only under
``MXTPU_PALLAS_CONV_BWD``; the gradient is the same function either way.

Float32 convolutions run through cuDNN under PyTorch's TF32 setting;
``torch.backends.cudnn.allow_tf32 = False`` gives the reference's
HIGHEST precision (``chip_smoke.py`` sets it).

Not ported yet: 1-D/3-D and NHWC convolutions, deconvolution, windowed
average and global max pooling, the ``full`` pooling convention,
activations other than relu, and the reference's other norms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXTPUError
from . import conv_bwd

__all__ = ["fully_connected", "convolution", "pooling", "activation_op",
           "batch_norm"]


def fully_connected(x, weight, bias=None, flatten=True):
    """y = x·weightᵀ + bias; ``flatten`` folds every axis after the first."""
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    y = torch.matmul(x, weight.t())
    return y if bias is None else y + bias


def convolution(x, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_group=1):
    """2-D NCHW convolution with OIHW weights; bias added after."""
    ndim = len(kernel) if kernel else x.ndim - 2
    if ndim != 2 or x.ndim != 4:
        raise MXTPUError("convolution: only 2-D NCHW is ported, got a %d-D "
                         "kernel on a %d-D input" % (ndim, x.ndim))
    stride = tuple(stride) if stride else (1, 1)
    dilate = tuple(dilate) if dilate else (1, 1)
    pad = tuple(pad) if pad else (0, 0)
    kernel = tuple(kernel) if kernel else tuple(weight.shape[2:])
    if conv_bwd.eligible(ndim, kernel, stride, dilate, pad, num_group,
                         in_shape=tuple(x.shape),
                         num_filter=int(weight.shape[0])):
        y = conv_bwd.Conv3x3S1.apply(x, weight)
    else:
        y = F.conv2d(x, weight, stride=stride, padding=pad, dilation=dilate,
                     groups=num_group)
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def pooling(x, kernel=(), pool_type="max", global_pool=False, stride=(),
            pad=()):
    """Global average over the spatial axes, or a 2-D windowed max whose
    padding counts as -inf (an element of the window always wins), with
    the ``valid`` convention (floor output sizing)."""
    if global_pool and pool_type == "avg":
        return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)
    if not global_pool and pool_type == "max" and x.ndim == 4:
        return F.max_pool2d(x, tuple(kernel), stride=tuple(stride) or (1, 1),
                            padding=tuple(pad) or (0, 0))
    raise MXTPUError("pooling: %s%s pooling is not ported"
                     % ("global " if global_pool else "", pool_type))


def activation_op(x, act_type="relu"):
    if act_type == "relu":
        return torch.relu(x)
    raise MXTPUError("activation %r is not ported" % act_type)


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
               fix_gamma=True, use_global_stats=False, axis=1,
               output_mean_var=False, training=False):
    """BatchNorm forward.  Batch statistics when ``training`` and not
    ``use_global_stats`` (two passes in float32, the biased variance),
    else the moving ones; the per-channel scale and shift are folded in
    float32 and applied in x's dtype.  The moving statistics are not
    updated here: the ``BatchNorm`` layer does that, with its momentum."""
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    axis = axis % x.ndim
    red = tuple(i for i in range(x.ndim) if i != axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    if training and not use_global_stats:
        xf = x.float()
        mean = xf.mean(dim=red)
        var = (xf - mean.reshape(shape)).square().mean(dim=red)
    else:
        mean = moving_mean.float()
        var = moving_var.float()
    scale = gamma.float() * torch.rsqrt(var + eps)
    shift = beta.float() - mean * scale
    out = x * scale.reshape(shape).to(x.dtype) \
        + shift.reshape(shape).to(x.dtype)
    if output_mean_var:
        return out, mean, var
    return out
