"""``HybridBlock``, the base of the port's Gluon layers: a
``torch.nn.Module`` that carries the reference's naming, so that its
parameters can be matched with the reference's by name.

In the reference every block takes a prefix when it is created: the one
it is given, or ``<alias><count>_`` counted per alias within the
enclosing block's name scope; a block with the empty prefix opens no
scope of its own, so its children are counted in its parent's.  The
port computes the same names from the module tree, as if each block's
children were created inside its scope (which is how the model zoo
builds them).  Names leave out the outermost block's own prefix, as
the weight bridge matches them (``resnetv10_stage1_conv0_weight`` →
``stage1_conv0_weight``).

Shapes are explicit (``in_channels``, ``in_units``), where the reference
defers them; ``module.train()`` and ``eval()`` decide batch or running
statistics, where the reference asks ``autograd.is_training()``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["HybridBlock"]


class HybridBlock(nn.Module):
    """A Gluon block: ``prefix`` None (named ``<alias><count>_`` in its
    parent's scope), empty (no scope of its own) or given."""

    def __init__(self, prefix=None):
        super().__init__()
        self.prefix = prefix

    def _alias(self):
        return type(self).__name__.lower()

    def collect_params(self):
        """``{reference name: tensor}`` of every parameter and running
        statistic under this block, names sorted, without this block's
        own prefix."""
        out = {}
        _collect(self, "", {}, out)
        return dict(sorted(out.items()))

    def initialize(self, init, generator=None):
        """Fill every parameter and running statistic in place with
        ``init`` (an :class:`mxtpu_torch.initializer.Initializer`), in
        name order, drawing from ``generator``."""
        with torch.no_grad():
            for name, t in self.collect_params().items():
                init(name, t, generator)
        return self


def _collect(block, prefix, counter, out):
    for name, t in list(block.named_parameters(recurse=False)) + list(
            block.named_buffers(recurse=False)):
        out[prefix + name] = t
    for child in block.children():
        if not isinstance(child, HybridBlock):
            raise TypeError("%s holds a %s, which has no reference name"
                            % (type(block).__name__, type(child).__name__))
        own = child.prefix
        if own is None:
            alias = child._alias()
            own = "%s%d_" % (alias, counter.get(alias, 0))
            counter[alias] = counter.get(alias, 0) + 1
        if own:
            _collect(child, prefix + own, {}, out)
        else:
            _collect(child, prefix, counter, out)
