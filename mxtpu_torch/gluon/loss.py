"""Losses (the port of ``mxtpu/gluon/loss.py``, as far as the training
path uses it): the ``Loss`` base with the reference's scalar weighting,
and ``SoftmaxCrossEntropyLoss`` over the last axis.  Each is an
``nn.Module`` over (pred, label) that returns one loss per sample: the
mean over every axis but ``batch_axis``.

Not ported yet: the reference's ``axis`` other than -1 and the
``sample_weight`` input."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Loss", "SoftmaxCrossEntropyLoss"]


class Loss(nn.Module):
    """Base loss: a scalar ``weight`` and the ``batch_axis`` the per-sample
    mean keeps."""

    def __init__(self, weight, batch_axis):
        super().__init__()
        if weight is not None and not isinstance(weight, (float, int)):
            raise TypeError("weight must be a number, got %r" % (weight,))
        self._weight = weight
        self._batch_axis = batch_axis

    def _per_sample(self, loss):
        if self._weight is not None:
            loss = loss * self._weight
        axes = [a for a in range(loss.ndim)
                if a != self._batch_axis % loss.ndim]
        return loss.mean(dim=axes) if axes else loss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy over the last axis: float32 ``log_softmax``
    of the prediction (unless ``from_logits``), then the label's entry
    (``sparse_label``, integer class ids) or the sum against a dense
    label distribution, negated."""

    def __init__(self, *, sparse_label=True, from_logits=False, weight=None,
                 batch_axis=0):
        super().__init__(weight, batch_axis)
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label):
        pred = pred.float()
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=-1)
        if self._sparse_label:
            idx = torch.as_tensor(label, device=pred.device).long()
            loss = -torch.gather(pred, -1, idx.unsqueeze(-1))
        else:
            label = torch.as_tensor(label, device=pred.device).reshape(
                pred.shape).to(pred.dtype)
            loss = -(pred * label).sum(dim=-1, keepdim=True)
        return self._per_sample(loss)
