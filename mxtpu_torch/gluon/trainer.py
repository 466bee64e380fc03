"""``Trainer`` (the port of ``mxtpu/gluon/trainer.py`` on one device with
no kvstore): binds parameters to an optimizer, and ``step(batch_size)``
applies one update with the gradient rescaled by ``1 / batch_size``.

As in MXNet, the loss's backward sums over the batch (``loss.sum()
.backward()`` on the per-sample loss, the ones that MXNet's
``loss.backward()`` back-propagates) and the step divides by the batch.
Parameters that take no gradient (``requires_grad`` False, the
reference's ``grad_req="null"``, e.g. a frozen weight) and tensors that are
not parameters (BatchNorm's running statistics, which
``collect_params`` also lists) are left alone.  Every other parameter
gets the optimizer's weight decay, BatchNorm's gamma and beta and every
bias included, as in the reference with no ``wd_mult`` set.

The update runs in place under ``no_grad`` and consumes the gradient
(``p.grad = None``), so the next backward writes it afresh, as the
reference's ``grad_req="write"`` does.

Not ported yet: kvstores and multi-device reduction, ``update_on_kvstore``,
``allreduce_grads``/``update``, the guard and AMP loss scaling,
``save_states``/``load_states``, ``lr_mult``/``wd_mult``, and the fused
multi-tensor update (its arithmetic is the same as the loop here).
"""

from __future__ import annotations

import torch
from torch import nn

from .. import optimizer as opt

__all__ = ["Trainer"]


class Trainer:
    """params : ``{name: tensor}`` (e.g. ``net.collect_params()``, taken in
    sorted name order) or a list of tensors.
    optimizer : a name (``"sgd"``) or an :class:`Optimizer`."""

    def __init__(self, params, optimizer, optimizer_params=None):
        if isinstance(params, dict):
            params = [params[k] for k in sorted(params)]
        if not isinstance(params, (list, tuple)) or not all(
                isinstance(p, torch.Tensor) for p in params):
            raise ValueError("First argument must be a list or dict of "
                             "tensors, got %r" % type(params))
        self._params = [p for p in params
                        if isinstance(p, nn.Parameter) and p.requires_grad]
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        self._states = [None] * len(self._params)
        self._counts = [0] * len(self._params)

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size):
        """One update of every trainable parameter, the gradients rescaled
        by ``rescale_grad / batch_size``."""
        optimizer = self._optimizer
        optimizer.rescale_grad = self._scale / batch_size
        with torch.no_grad():
            for i, p in enumerate(self._params):
                if self._counts[i] == 0:
                    self._states[i] = optimizer.create_state(i, p)
                self._counts[i] += 1
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                optimizer._step_t(p, grad, self._states[i],
                                  optimizer._get_lr(i), optimizer._get_wd(i),
                                  self._counts[i])
                p.grad = None
