"""Weight initializers (the port of ``mxtpu/initializer.py`` as far as the
vision example uses it): the ``Initializer`` base with the reference's
dispatch by parameter name, and ``Xavier``.

An initializer is called as ``init(name, tensor, generator)`` and fills
``tensor`` in place: names ending in ``bias``, ``beta`` or
``running_mean`` get 0, ``gamma`` and ``running_var`` get 1, and every
other tensor is a weight drawn from ``generator`` (a ``torch.Generator``
on the tensor's device).  The reference draws from its global JAX key;
the two give different numbers from one seed.  ``HybridBlock.initialize``
walks a block's parameters in name order.

Not ported yet: the registry, ``InitDesc`` attributes, Xavier's
``rnd_type="gaussian"`` and ``factor_type`` "in"/"out", and the other
initializers (``Uniform``, ``Normal``, ``Orthogonal``, ``MSRAPrelu``, …).
"""

from __future__ import annotations

import math

from .base import MXTPUError

__all__ = ["Initializer", "Xavier"]


class Initializer:
    """Fills parameters in place by name; subclasses draw the weights."""

    def __call__(self, name, tensor, generator=None):
        if name.endswith(("bias", "beta", "running_mean")):
            tensor.zero_()
        elif name.endswith(("gamma", "running_var")):
            tensor.fill_(1.0)
        else:
            self._init_weight(tensor, generator)

    def _init_weight(self, tensor, generator):
        raise NotImplementedError


class Xavier(Initializer):
    """Glorot init as the vision example uses it (the reference's default
    ``rnd_type="uniform"``, ``factor_type="avg"``): U(-s, s) with s =
    sqrt(magnitude / ((fan_in + fan_out) / 2)), fan_in =
    shape[1]·prod(shape[2:]), fan_out = shape[0]·prod(shape[2:])."""

    def __init__(self, magnitude=3):
        self.magnitude = float(magnitude)

    def _init_weight(self, tensor, generator):
        shape = tensor.shape
        if len(shape) < 2:
            raise MXTPUError("Xavier requires at least 2D weight, got shape "
                             "%s" % (tuple(shape),))
        hw_scale = float(math.prod(shape[2:]))
        factor = (shape[1] + shape[0]) * hw_scale / 2.0
        scale = math.sqrt(self.magnitude / factor)
        tensor.uniform_(-scale, scale, generator=generator)
