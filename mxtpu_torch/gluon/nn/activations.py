"""Activation layers (the port of ``mxtpu/gluon/nn/activations.py`` as
far as ResNet-v1 uses it)."""

from __future__ import annotations

from ...ops import nn as ops
from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """A named activation (relu is the one ported)."""

    def __init__(self, activation, prefix=None):
        super().__init__(prefix)
        self._act_type = activation

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return ops.activation_op(x, act_type=self._act_type)
