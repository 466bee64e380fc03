"""Switch / GShard mixture-of-experts routing (the port of
``mxtpu/ops/moe.py``'s ``switch_moe``).

The reference computes the whole op with XLA einsums and no Pallas
kernel, so it is plain PyTorch here too: float32 throughout (x and the
three weights are upcast, as the reference upcasts them), with the
expert products as ``torch.bmm``.  Dispatch and combine gather and
``index_add`` where the reference contracts (S, E, C) one-hot tensors;
a one-hot contraction adds exact zeros, so the two give the same values
(top-1 bit for bit; top-k sums its k gated terms in choice order).

What a plain transcription would get wrong, and what this keeps of the
reference:

- ties: ``jax.lax.top_k`` picks the lower expert index among equal
  gates (every gate ties under an all-zero router).  ``torch.topk``
  promises no order, so the choices come from a stable descending sort;
- GELU is the tanh approximation (``jax.nn.gelu``'s default) and swish
  is written ``h * sigmoid(h)``;
- capacity is ``max(1, ceil(k * S / E * capacity_factor))`` in Python
  floats, and fills choice-major: every token's first choice before any
  token's second;
- the load-balancing term reads the first choices' fractions detached
  (the reference's ``stop_gradient``); the z-loss is
  ``mean(logsumexp(logits)**2)``.

The products are float32 and assume TF32 is off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default);
with TF32 on, the card rounds their inputs to 10 mantissa bits and the
routing may differ from the CPU's.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from ..base import MXTPUError

__all__ = ["switch_moe", "expert_capacity", "ACTIVATIONS"]

ACTIVATIONS = ("swish", "gelu", "relu")


def expert_capacity(S, E, k, capacity_factor, capacity=None):
    """Per-expert slot count of ``switch_moe`` for S tokens: an explicit
    ``capacity`` (at least 1), else S·k when ``capacity_factor <= 0``
    (nothing drops), else ``max(1, ceil(k * S / E * capacity_factor))``
    (GShard's k-scaled budget)."""
    if capacity is not None:
        return max(1, int(capacity))
    if capacity_factor <= 0:
        return S * k
    return max(1, int(math.ceil(k * S / E * capacity_factor)))


def _activate(h, activation):
    if activation == "swish":
        return h * torch.sigmoid(h)
    if activation == "gelu":
        return F.gelu(h, approximate="tanh")
    return torch.relu(h)


def switch_moe(x, router_w, w1, w2, capacity_factor=1.25,
               activation="swish", top_k=1, normalize_gates=True,
               capacity=None, *, router_jitter=0.0, z_loss_weight=0.0,
               training=False, generator=None):
    """Routed expert FFN (Switch top-1 / GShard top-k).

    x (B, T, d) or (S, d); ``router_w`` (E, d), the Dense (out, in)
    layout; ``w1`` (E, d, h); ``w2`` (E, h, d).  Returns ``(y, aux)``: y
    of x's shape and dtype, its dropped (over-capacity) rows exactly
    zero (callers add the residual); ``aux`` the float32 scalar
    E·sum(f_e·p_e) (f_e: the share of first choices to expert e, p_e:
    its mean gate) plus ``z_loss_weight`` times the router z-loss.

    ``top_k`` > 1 dispatches each token to its k best experts; with
    ``normalize_gates`` the k gates are renormalized to sum to 1.
    ``capacity_factor`` <= 0 bounds nothing (capacity S·k: the decode
    configuration); ``capacity`` overrides the formula (chunked prefill
    budgets from the whole prompt).

    ``router_jitter`` (keyword only): with ``training``, the router's
    input is multiplied by noise uniform in (1 - eps, 1 + eps) drawn
    from ``generator`` (a ``torch.Generator`` on x's device; None: the
    device's default generator).  The draws are not the reference's
    (threefry), so jittered routing is not held across frameworks."""
    if activation not in ACTIVATIONS:
        raise MXTPUError("switch_moe: activation must be one of %s, got %r"
                         % (ACTIVATIONS, activation))
    orig_shape = x.shape
    d = orig_shape[-1]
    xf = x.reshape(-1, d).float()
    S = xf.shape[0]
    E = router_w.shape[0]
    k = int(top_k)
    if not 1 <= k <= E:
        raise MXTPUError("switch_moe: top_k %d outside [1, %d experts]"
                         % (k, E))

    xr = xf
    if router_jitter and training:
        noise = torch.empty_like(xr).uniform_(
            1.0 - router_jitter, 1.0 + router_jitter, generator=generator)
        xr = xr * noise
    logits = xr @ router_w.float().t()                        # (S, E)
    gates = torch.softmax(logits, dim=-1)
    C = expert_capacity(S, E, k, capacity_factor, capacity)

    # the k best experts a token, lower index first among equal gates
    order = torch.sort(gates, dim=-1, descending=True, stable=True).indices
    topi = order[:, :k]                                       # (S, k)
    topv = torch.gather(gates, 1, topi)
    if k > 1 and normalize_gates:
        topv = topv / topv.sum(dim=-1, keepdim=True)

    # capacity in choice-major order: the n-th assignment to expert e
    # (choice 0 of every token, then choice 1, ...) takes slot n-1
    choice = topi.t().reshape(-1)                             # (k*S,)
    oh = F.one_hot(choice, E)
    pos = (torch.cumsum(oh, dim=0) * oh).sum(dim=-1) - 1      # 0-based
    kept = pos < C
    tok = torch.arange(S, device=x.device).repeat(k)[kept]
    slot = (choice * C + pos)[kept]
    gate = topv.t().reshape(-1)[kept]

    xe = xf.new_zeros(E * C, d).index_copy(0, slot, xf[tok])
    h = torch.bmm(xe.view(E, C, d), w1.float())
    ye = torch.bmm(_activate(h, activation), w2.float()).view(E * C, d)
    y = xf.new_zeros(S, d).index_add(0, tok, gate[:, None] * ye[slot])

    # load balancing over FIRST choices (Switch; GShard's top-2 too)
    frac = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    prob = gates.mean(dim=0)
    aux = E * torch.sum(frac.detach() * prob)
    if z_loss_weight:
        z = torch.logsumexp(logits, dim=-1)
        aux = aux + z_loss_weight * torch.mean(z * z)
    return y.reshape(orig_shape).to(x.dtype), aux.float()
