"""Basic layers (the port of ``mxtpu/gluon/nn/basic_layers.py`` as far as
ResNet-v1 uses it): ``HybridSequential``, ``Dense`` and ``BatchNorm``.

Not ported yet: ``Sequential``, ``Dropout``, ``Embedding``, the other
norms, ``Flatten``, ``Lambda``, and BatchNorm's ``scale=False``,
``center=False`` and ``use_global_stats`` switches."""

from __future__ import annotations

import torch
from torch import nn

from ...base import MXTPUError
from ...ops import nn as ops
from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "BatchNorm"]


class HybridSequential(HybridBlock):
    """Blocks run one after another."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """y = x·weightᵀ + bias, weight (units, in_units); both start at zero
    until ``initialize``.  (A fused ``activation`` is not ported.)"""

    def __init__(self, units, use_bias=True, flatten=True, in_units=0,
                 prefix=None, device=None, dtype=None):
        super().__init__(prefix)
        if in_units <= 0:
            raise MXTPUError("Dense needs in_units: the port does not defer "
                             "shapes")
        factory = dict(device=device, dtype=dtype)
        self._flatten = flatten
        self.weight = nn.Parameter(torch.zeros((units, in_units), **factory))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(units, **factory))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return ops.fully_connected(x, self.weight, self.bias,
                                   flatten=self._flatten)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis``.  In training mode it normalizes
    with the batch statistics and then moves the running ones: ``running
    * momentum + batch * (1 - momentum)``, with the biased batch
    variance, as the reference's layer does
    (``torch.nn.functional.batch_norm`` would move them with the unbiased
    one).  In eval mode it uses the running statistics.  gamma, beta and
    the running statistics are float32 whatever the input's dtype."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, in_channels=0,
                 prefix=None, device=None):
        super().__init__(prefix)
        if in_channels <= 0:
            raise MXTPUError("BatchNorm needs in_channels: the port does not "
                             "defer shapes")
        factory = dict(device=device, dtype=torch.float32)
        self._kwargs = {"axis": axis, "eps": epsilon, "fix_gamma": False}
        self._momentum = momentum
        self.gamma = nn.Parameter(torch.ones(in_channels, **factory))
        self.beta = nn.Parameter(torch.zeros(in_channels, **factory))
        self.register_buffer("running_mean",
                             torch.zeros(in_channels, **factory))
        self.register_buffer("running_var",
                             torch.ones(in_channels, **factory))

    def forward(self, x):
        args = (x, self.gamma, self.beta, self.running_mean,
                self.running_var)
        if not self.training:
            return ops.batch_norm(*args, **self._kwargs)
        out, mean, var = ops.batch_norm(*args, output_mean_var=True,
                                        training=True, **self._kwargs)
        with torch.no_grad():
            m = self._momentum
            self.running_mean.copy_(self.running_mean * m + mean * (1 - m))
            self.running_var.copy_(self.running_var * m + var * (1 - m))
        return out
