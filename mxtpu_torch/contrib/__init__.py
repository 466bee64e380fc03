"""Contributed modules of the port (the counterpart of ``mxtpu.contrib``):
weight-only int8/int4 quantization."""

from . import quantization  # noqa: F401
