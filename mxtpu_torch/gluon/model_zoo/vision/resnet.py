"""ResNet v1 (the port of ``mxtpu/gluon/model_zoo/vision/resnet.py``):
``BasicBlockV1``, ``BottleneckV1``, ``ResNetV1``, ``get_resnet`` and
``resnet18_v1`` … ``resnet152_v1``.  The blocks and their order are the
reference's, so ``collect_params`` gives the reference's parameter names.
Every 3x3 conv is stride 1 except BasicBlockV1's first in a downsampling
block; those whose size the reference's rule admits take the K6 backward.

Input channels are explicit (3 for the stem, the image's colours), where
the reference defers them.  The model is built on the CUDA card unless
``device`` names another; weights start at zero until ``initialize``.

Not ported yet: ResNet v2 (``BasicBlockV2``, ``BottleneckV2``,
``ResNetV2``), the ``thumbnail`` stem and pretrained weights."""

from __future__ import annotations

import torch

from ....base import MXTPUError, resolve_device
from ....ops import nn as ops
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "get_resnet"]


def _conv3x3(channels, stride, in_channels, **factory):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, **factory)


def _downsample(channels, stride, in_channels, device, dtype):
    down = nn.HybridSequential(prefix="")
    down.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                       use_bias=False, in_channels=in_channels,
                       device=device, dtype=dtype))
    down.add(nn.BatchNorm(in_channels=channels, device=device))
    return down


class BasicBlockV1(HybridBlock):
    """conv3x3-bn-relu-conv3x3-bn plus the identity (or a 1x1
    downsample), then relu."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 prefix=None, device=None, dtype=None):
        super().__init__(prefix)
        factory = dict(device=device, dtype=dtype)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, **factory))
        self.body.add(nn.BatchNorm(in_channels=channels, device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, **factory))
        self.body.add(nn.BatchNorm(in_channels=channels, device=device))
        self.downsample = (_downsample(channels, stride, in_channels,
                                       **factory) if downsample else None)

    def forward(self, x):
        # the body first, as the reference's hybrid_forward: the convs
        # run in the order they are registered
        out = self.body(x)
        residual = x if self.downsample is None else self.downsample(x)
        return ops.activation_op(out + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1 (with the stride) - 3x3 - 1x1 bottleneck, each conv followed by
    BatchNorm, plus the identity (or a 1x1 downsample), then relu.  The two
    1x1 convs keep the reference's default bias."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 prefix=None, device=None, dtype=None):
        super().__init__(prefix)
        factory = dict(device=device, dtype=dtype)
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                in_channels=in_channels, **factory))
        self.body.add(nn.BatchNorm(in_channels=mid, device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid, **factory))
        self.body.add(nn.BatchNorm(in_channels=mid, device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                in_channels=mid, **factory))
        self.body.add(nn.BatchNorm(in_channels=channels, device=device))
        self.downsample = (_downsample(channels, stride, in_channels,
                                       **factory) if downsample else None)

    def forward(self, x):
        # the body first, as the reference's hybrid_forward: the convs
        # run in the order they are registered
        out = self.body(x)
        residual = x if self.downsample is None else self.downsample(x)
        return ops.activation_op(out + residual, act_type="relu")


class ResNetV1(HybridBlock):
    """Stem (7x7/2 conv, BatchNorm, relu, 3x3/2 max pool),
    ``len(layers)`` stages of ``block``, global average pooling and a
    Dense classifier."""

    def __init__(self, block, layers, channels, classes=1000, prefix=None,
                 device=None, dtype=torch.float32):
        super().__init__(prefix)
        assert len(layers) == len(channels) - 1
        device = resolve_device(device)
        factory = dict(device=device, dtype=dtype)
        self.features = nn.HybridSequential(prefix="")
        self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                    in_channels=3, **factory))
        self.features.add(nn.BatchNorm(in_channels=channels[0],
                                       device=device))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(3, 2, 1))
        for i, num_layer in enumerate(layers):
            stage = nn.HybridSequential(prefix="stage%d_" % (i + 1))
            stride = 1 if i == 0 else 2
            stage.add(block(channels[i + 1], stride,
                            channels[i + 1] != channels[i],
                            in_channels=channels[i], prefix="", **factory))
            for _ in range(num_layer - 1):
                stage.add(block(channels[i + 1], 1, False,
                                in_channels=channels[i + 1], prefix="",
                                **factory))
            self.features.add(stage)
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1], **factory)

    def forward(self, x):
        return self.output(self.features(x))


#: num_layers -> (block type, blocks per stage, channels)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """A ResNet of ``num_layers`` (18, 34, 50, 101 or 152); version 1 only,
    no pretrained weights."""
    if num_layers not in resnet_spec:
        raise MXTPUError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, sorted(resnet_spec)))
    if version != 1 or pretrained:
        raise MXTPUError("only ResNet v1 with random weights is ported")
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)
