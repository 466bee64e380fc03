"""Optimizers (the port of ``mxtpu/optimizer/optimizer.py`` as far as the
training paths use it): the ``Optimizer`` base — learning rate, weight
decay, gradient rescale and clip, the registry — ``SGD`` and ``Adam``.

Each rule is ``_step(weight, grad, state, lr, wd)`` and, for rules that
depend on the update count, ``_step_t(..., t)``, as in the reference.
Unlike the reference's pure functions, the port's rules update the
weight and the state IN PLACE (under ``torch.no_grad``) and return them,
so a step allocates no second copy of the parameters.  The rules are
plain PyTorch: the reference left them to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Optimizer", "SGD", "Adam", "register", "create"]


class Optimizer:
    """Base optimizer: ``learning_rate``, ``wd``, ``rescale_grad`` and
    ``clip_gradient`` as in the reference.  Subclasses implement
    ``create_state`` and ``_step`` (and ``_step_t`` where the update count
    matters)."""

    opt_registry: dict = {}

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def create_state(self, index, weight):
        """The state of one parameter (None for a stateless rule)."""
        return None

    def _step(self, weight, grad, state, lr, wd):
        """Update ``weight`` and ``state`` in place; return both."""
        raise NotImplementedError

    def _step_t(self, weight, grad, state, lr, wd, t):
        """``_step`` with the update count ``t`` (1 on the first update);
        rules whose arithmetic depends on it override this."""
        return self._step(weight, grad, state, lr, wd)

    def _grad(self, weight, grad, wd):
        """clip(grad * rescale_grad) + wd * weight, the reference's
        gradient preamble (no copy when it changes nothing)."""
        g = grad if self.rescale_grad == 1.0 else grad * self.rescale_grad
        if self.clip_gradient is not None and self.clip_gradient > 0:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g + wd * weight if wd else g

    def set_learning_rate(self, lr):
        self.lr = lr

    def _get_lr(self, index):
        return self.lr

    def _get_wd(self, index):
        return self.wd


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay (the reference's
    ``sgd_mom_update``, or ``sgd_update`` when ``momentum`` is 0):

        g   = clip(grad * rescale_grad) + wd * w
        mom = momentum * mom - lr * g
        w  += mom                        (w -= lr * g without momentum)"""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else torch.zeros_like(weight)

    @torch.no_grad()
    def _step(self, weight, grad, state, lr, wd):
        g = self._grad(weight, grad, wd)
        if self.momentum == 0.0:
            weight.sub_(g * lr)
            return weight, None
        state.mul_(self.momentum).sub_(g * lr)
        weight.add_(state)
        return weight, state


@register
class Adam(Optimizer):
    """Adam with the reference's arithmetic (``adam_update`` with the
    bias correction folded into the learning rate):

        g   = clip(grad * rescale_grad) + wd * w
        m   = beta1 * m + (1 - beta1) * g
        v   = beta2 * v + (1 - beta2) * g * g
        lr_t = lr * sqrt(1 - beta2**t) / (1 - beta1**t)     (float32)
        w  -= lr_t * m / (sqrt(v) + epsilon)

    epsilon is added to sqrt(v) itself, not to its bias-corrected value
    as ``torch.optim.Adam`` does, so the two differ wherever |g| is near
    epsilon."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def _step(self, weight, grad, state, lr, wd):
        mean, var = state
        g = self._grad(weight, grad, wd)
        mean.mul_(self.beta1).add_(g * (1.0 - self.beta1))
        var.mul_(self.beta2).add_(g.mul(1.0 - self.beta2).mul_(g))
        weight.sub_(mean.mul(lr).div_(var.sqrt().add_(self.epsilon)))
        return weight, (mean, var)

    def _step_t(self, weight, grad, state, lr, wd, t):
        """The bias correction in float32, as the reference traces it."""
        f = np.float32
        t = f(t)
        lr = f(lr) * np.sqrt(f(1.0) - f(self.beta2) ** t) \
            / (f(1.0) - f(self.beta1) ** t)
        return self._step(weight, grad, state, float(lr), wd)
