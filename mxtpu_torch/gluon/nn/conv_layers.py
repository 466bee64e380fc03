"""Convolution and pooling layers (the port of
``mxtpu/gluon/nn/conv_layers.py`` as far as ResNet-v1 uses it):
``Conv2D``, ``MaxPool2D`` and ``GlobalAvgPool2D``, NCHW with OIHW
weights.  A 3x3, stride-1, pad-1 ``Conv2D`` takes the K6 backward
through ``ops.nn.convolution``.

Not ported yet: 1-D/3-D and transposed convolutions, the ``layout``
argument (NHWC), a fused ``activation``, average and global max pooling,
``ceil_mode``."""

from __future__ import annotations

import torch
from torch import nn

from ...base import MXTPUError
from ...ops import nn as ops
from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _to_tuple(x, n):
    if isinstance(x, (tuple, list)):
        assert len(x) == n
        return tuple(x)
    return (x,) * n


class Conv2D(HybridBlock):
    """2-D convolution: weight (channels, in_channels // groups, kh, kw),
    bias (channels,) when ``use_bias``; both start at zero until
    ``initialize``."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, use_bias=True, in_channels=0,
                 prefix=None, device=None, dtype=None):
        super().__init__(prefix)
        if in_channels <= 0:
            raise MXTPUError("Conv2D needs in_channels: the port does not "
                             "defer shapes")
        kernel_size = _to_tuple(kernel_size, 2)
        factory = dict(device=device, dtype=dtype)
        self._kwargs = {"kernel": kernel_size, "stride": _to_tuple(strides, 2),
                        "dilate": _to_tuple(dilation, 2),
                        "pad": _to_tuple(padding, 2), "num_group": groups}
        self.weight = nn.Parameter(torch.zeros(
            (channels, in_channels // groups) + kernel_size, **factory))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(channels, **factory))
        else:
            self.register_parameter("bias", None)

    def _alias(self):
        return "conv"

    def forward(self, x):
        return ops.convolution(x, self.weight, self.bias, **self._kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 prefix=None):
        super().__init__(prefix)
        if strides is None:
            strides = pool_size
        if isinstance(strides, int):
            strides = (strides,) * len(pool_size)
        if isinstance(padding, int):
            padding = (padding,) * len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type}

    def _alias(self):
        return "pool"

    def forward(self, x):
        return ops.pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, **kwargs):
        if isinstance(pool_size, int):
            pool_size = (pool_size,) * 2
        super().__init__(pool_size, strides, padding, False, "max", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, **kwargs):
        super().__init__((1, 1), None, 0, True, "avg", **kwargs)
