"""SPMDTrainer on one card (the port of ``mxtpu/parallel/trainer.py``'s
per-step path): forward, the loss's mean, backward, then the optimizer's
``_step_t`` on every parameter with ``t`` the update count.

The reference compiles the step as one SPMD program over a device mesh;
the port runs it eagerly on the model's one device.  Parameters are
updated in place, in the reference's order (sorted by reference
parameter name, as ``_stage_params`` sorts them), and each gradient is
dropped as soon as its parameter is updated, so the step never holds a
second copy of the weights.

Not ported yet: the mesh and sharding rules, ``guard`` and dynamic loss
scaling, ``step_window``, ``clip_gradient_norm``, ``remat`` and
``save_states``/``load_states``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import optimizer as opt_mod
from ..models.convert import mxtpu_name

__all__ = ["SPMDTrainer"]


class SPMDTrainer:
    """Trains ``block`` with ``loss_fn`` and ``optimizer``.

    block : an ``nn.Module`` on the device it trains on.
    loss_fn : callable(pred, label) → per-sample loss tensor.
    optimizer : a name (``"adam"``) or an :class:`Optimizer` with a
        ``_step``/``_step_t`` rule.
    """

    def __init__(self, block, loss_fn, optimizer, optimizer_params=None):
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        cls = type(optimizer)
        if (cls._step is opt_mod.Optimizer._step
                and cls._step_t is opt_mod.Optimizer._step_t):
            raise ValueError(
                "SPMDTrainer requires an optimizer with a _step/_step_t "
                "rule; %s has neither" % cls.__name__)
        self._block = block
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._num_update = 0
        self._params = None
        self._states = None

    def _stage_params(self):
        named = sorted((mxtpu_name(n), p)
                       for n, p in self._block.named_parameters()
                       if p.requires_grad)
        self._params = [p for _, p in named]
        self._states = [self._optimizer.create_state(i, p.detach())
                        for i, p in enumerate(self._params)]

    @property
    def learning_rate(self):
        return self._optimizer._get_lr(0)

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, data, label):
        """One optimization step on a batch.  Returns the scalar loss (a
        device tensor, detached; no host sync)."""
        if self._params is None:
            self._stage_params()
        device = self._params[0].device
        data, label = (x.to(device) if torch.is_tensor(x)
                       else torch.tensor(np.asarray(x), device=device)
                       for x in (data, label))
        for p in self._params:
            p.grad = None
        loss = self._loss_fn(self._block(data), label).mean()
        loss.backward()
        self._num_update += 1
        opt = self._optimizer
        lr = opt._get_lr(0)
        with torch.no_grad():
            for i, (p, st) in enumerate(zip(self._params, self._states)):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                opt._step_t(p.data, g, st, lr, opt._get_wd(i),
                            self._num_update)
                p.grad = None
        return loss.detach()
