"""Gluon layers of the port (``mxtpu/gluon/nn`` as far as ResNet-v1 uses
it)."""

from .activations import Activation
from .basic_layers import BatchNorm, Dense, HybridSequential
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Dense", "HybridSequential", "Conv2D",
           "GlobalAvgPool2D", "MaxPool2D"]
