"""SPMDTrainer on one card (the port of ``mxtpu/parallel/trainer.py``'s
per-step path): forward, the loss's mean, backward, then the optimizer's
``_step_t`` on every parameter with ``t`` the update count.

A block that returns a tuple (``TransformerLM(return_moe_aux=True)``'s
``(logits, aux)``) hands the loss its FIRST output, unless the loss has
``accepts_full_output = True``, as the reference's trainer does.
``NextTokenLoss`` and ``synthetic_batches`` are the reference training
example's loss and data (``examples/parallel/llama_train.py``).

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

__all__ = ["SPMDTrainer", "NextTokenLoss", "synthetic_batches"]


def synthetic_batches(batch, seq, steps, vocab, seed=0):
    """The reference training example's synthetic language, with the
    vocabulary a parameter: arithmetic token sequences with 2% noise, as
    int32 numpy arrays."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        start = rng.randint(0, vocab, (batch, 1))
        stride = rng.randint(1, 5, (batch, 1))
        base = (start + stride * np.arange(seq)) % vocab
        noise = (rng.rand(batch, seq) < 0.02) * rng.randint(0, vocab,
                                                            (batch, seq))
        yield ((base + noise) % vocab).astype(np.int32)


class NextTokenLoss:
    """The reference training example's shifted cross-entropy: predict
    token t+1 from the prefix up to t (one loss per predicted token).
    It takes the model's whole output (``accepts_full_output``): from a
    ``(logits, aux)`` pair it adds ``moe_aux_weight`` times the Switch
    load-balancing term."""

    accepts_full_output = True

    def __init__(self, moe_aux_weight=0.0):
        from ..gluon.loss import SoftmaxCrossEntropyLoss

        self._ce = SoftmaxCrossEntropyLoss()
        self._aux_w = moe_aux_weight

    def __call__(self, logits, labels):
        aux = None
        if isinstance(logits, tuple):
            logits, aux = logits
        loss = self._ce(logits[:, :-1].reshape(-1, logits.shape[-1]),
                        labels[:, 1:].reshape(-1))
        if aux is not None and self._aux_w:
            loss = loss + self._aux_w * aux
        return loss


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
        out = self._block(data)
        if isinstance(out, tuple) and not getattr(
                self._loss_fn, "accepts_full_output", False):
            out = out[0]
        loss = self._loss_fn(out, label).mean()
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
