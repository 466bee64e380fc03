"""Switch mixture-of-experts blocks (the port of ``mxtpu/models/moe.py``):
``SwitchMoE``, the routed FFN over ``ops.moe.switch_moe``, and
``MoEDecoderLayer``, the Llama decoder layer with its SwiGLU FFN swapped
for it, in every form the dense layer has.

Capacity by path, as in the reference:

- the full forward (training) uses the training capacity,
  ceil(k·S/E·capacity_factor), over the whole batch;
- prefill (``prefill``, ``prefill_pages``) uses the training capacity
  budgeted from the WHOLE prompt (``total_len``), so a chunk of a long
  prompt is not squeezed into a chunk-sized budget; one chunk of the
  whole prompt routes as the full forward does;
- every decode form (``step``, ``step_slots``, ``verify_slots``,
  ``step_pages``, ``verify_pages``) runs capacity-unbounded, so dead pool
  lanes cannot evict a live token from an expert.  The unbounded
  capacity is still a function of the batch, so a W-lane window is not
  guaranteed to route as W one-token steps: the serving engines opt MoE
  models out of speculation, of prefix sharing and of prefill bucketing.

The decode forms normalize the FFN's input with ``ops.contrib.
rows_rms_norm`` (G2), whose rows do not depend on the row count, so the
engines' steps and ``generate``'s steps round it alike; the attention
runs as the dense layer's does (its norm inside G1's qkv launch).
Prefill and the full forward use the ``RMSNorm`` module.

The router and the experts are never split: under tensor parallelism
every rank keeps them whole and routes the whole (reduced) activations;
expert parallelism (an ``ep`` axis) is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ..initializer import Xavier
from ..ops.contrib import rows_rms_norm
from ..ops.moe import expert_capacity, switch_moe
from ..parallel.sharding import PartitionSpec as P, ShardingRules

__all__ = ["SwitchMoE", "MoEDecoderLayer", "moe_sharding_rules"]


class SwitchMoE(nn.Module):
    """Switch-Transformer FFN: top-1 (or top-k) routed experts with a
    static capacity; dropped tokens give zero (use it inside a residual
    block).

    Parameters ``router_weight`` (E, units), ``experts_w1`` (E, units,
    hidden) and ``experts_w2`` (E, hidden, units), Xavier-initialized
    with the reference's fans (fan_in = shape[1]·prod(shape[2:]),
    fan_out = shape[0]·prod(shape[2:])).

    ``forward`` returns y, or ``(y, aux)`` with ``return_aux``;
    ``aux_loss`` keeps the last forward's aux as the live tensor, so a
    loss may add it and back-propagate through the router.  Router
    jitter applies only in training: the module in train mode with
    gradients enabled; its noise comes from ``generator``."""

    def __init__(self, units, hidden_size, num_experts, capacity_factor=1.25,
                 activation="swish", return_aux=False, top_k=1,
                 router_jitter=0.0, z_loss_weight=0.0, generator=None,
                 device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.num_experts = int(num_experts)
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.return_aux = bool(return_aux)
        self.top_k = int(top_k)
        self.router_jitter = router_jitter
        self.z_loss_weight = z_loss_weight
        self.generator = generator
        E = self.num_experts
        self.router_weight = nn.Parameter(torch.empty(E, units, **fk))
        self.experts_w1 = nn.Parameter(torch.empty(E, units, hidden_size,
                                                   **fk))
        self.experts_w2 = nn.Parameter(torch.empty(E, hidden_size, units,
                                                   **fk))
        init = Xavier()
        with torch.no_grad():
            for p in (self.router_weight, self.experts_w1, self.experts_w2):
                init._init_weight(p, None)
        self.aux_loss = None

    def _route(self, x, **kw):
        return switch_moe(x, self.router_weight, self.experts_w1,
                          self.experts_w2, activation=self.activation,
                          top_k=self.top_k, **kw)

    def forward(self, x):
        y, aux = self._route(
            x, capacity_factor=self.capacity_factor,
            router_jitter=self.router_jitter,
            z_loss_weight=self.z_loss_weight,
            training=self.training and torch.is_grad_enabled(),
            generator=self.generator)
        self.aux_loss = aux
        return (y, aux) if self.return_aux else y

    def decode_forward(self, x):
        """The capacity-UNBOUNDED forward of incremental decode: a step
        routes only its B tokens, where the training capacity would drop
        tokens the full-context forward kept."""
        return self._route(x, capacity_factor=0.0)[0]

    def prefill_forward(self, x, total_len=None):
        """The forward of (chunked) prefill: the training capacity
        budgeted from the WHOLE prompt, ceil(k·B·total_len/E·cf), so a
        chunk of T tokens of a ``total_len``-token prompt gets the
        full-context forward's slot count (``total_len`` defaults to T).
        Tokens still compete only with their own chunk for the slots.
        Raises ``ValueError`` when ``total_len`` < T."""
        B, T = x.shape[0], x.shape[1]
        total = int(total_len) if total_len is not None else T
        if total < T:
            raise ValueError("prefill total_len %d < chunk length %d"
                             % (total, T))
        capacity = None
        if self.capacity_factor > 0:
            capacity = expert_capacity(B * total, self.num_experts,
                                       self.top_k, self.capacity_factor)
        return self._route(x, capacity_factor=self.capacity_factor,
                           capacity=capacity)[0]


class MoEDecoderLayer(nn.Module):
    """``LlamaDecoderLayer`` with the SwiGLU FFN swapped for
    :class:`SwitchMoE` (pre-RMSNorm residual structure kept), in every
    form the dense layer has (module docstring)."""

    def __init__(self, units, hidden_size, num_heads, num_kv_heads,
                 num_experts, capacity_factor=1.25, return_aux=False,
                 device=None, dtype=None):
        super().__init__()
        from .transformer import MultiHeadAttention, RMSNorm

        fk = {"device": device, "dtype": dtype}
        self.return_aux = bool(return_aux)
        self.attn_norm = RMSNorm(units, **fk)
        self.attn = MultiHeadAttention(units, num_heads, num_kv_heads, **fk)
        self.ffn_norm = RMSNorm(units, **fk)
        self.moe = SwitchMoE(units, hidden_size, num_experts,
                             capacity_factor, return_aux=return_aux, **fk)

    def forward(self, x):
        x = x + self.attn(self.attn_norm(x))
        out = self.moe(self.ffn_norm(x))
        if self.return_aux:
            return x + out[0], out[1]
        return x + out

    def _decode_ffn(self, x):
        return x + self.moe.decode_forward(
            rows_rms_norm(x, self.ffn_norm.weight))

    def _prefill_ffn(self, x, total_len):
        return x + self.moe.prefill_forward(self.ffn_norm(x), total_len)

    def step(self, x, cache_k, cache_v, pos):
        """One decode token a row at position ``pos`` (int) through the
        contiguous cache (``generate``'s step): the attention's one-token
        prefill, then the capacity-unbounded FFN."""
        return self._decode_ffn(x + self.attn.prefill(
            self.attn_norm(x), cache_k, cache_v, pos))

    def prefill(self, x, cache_k, cache_v, start_pos=0, total_len=None):
        """T prompt tokens at [start_pos, start_pos + T); ``total_len``
        (the whole prompt's length, capacity's budget) defaults to
        start_pos + T, exact for one chunk and for a prompt's last."""
        h = self.attn.prefill(self.attn_norm(x), cache_k, cache_v, start_pos)
        total = total_len if total_len is not None \
            else start_pos + x.shape[1]
        return self._prefill_ffn(x + h, total)

    def step_slots(self, x, cache_k, cache_v, pos):
        return self._decode_ffn(x + self.attn.step_slots(
            x, self.attn_norm, cache_k, cache_v, pos))

    def verify_slots(self, x, cache_k, cache_v, pos, valid_len, tree=None):
        """The verify window (routing caveat in the module docstring: the
        engines opt MoE models out of speculation)."""
        return self._decode_ffn(x + self.attn.verify_slots(
            x, self.attn_norm, cache_k, cache_v, pos, valid_len, tree))

    def step_pages(self, x, pool_k, pool_v, tables, pos):
        return self._decode_ffn(x + self.attn.step_pages(
            x, self.attn_norm, pool_k, pool_v, tables, pos))

    def verify_pages(self, x, pool_k, pool_v, tables, pos, valid_len,
                     tree=None):
        return self._decode_ffn(x + self.attn.verify_pages(
            x, self.attn_norm, pool_k, pool_v, tables, pos, valid_len, tree))

    def prefill_pages(self, x, pool_k, pool_v, table, start_pos=0,
                      total_len=None):
        """One prompt chunk through the block table; ``total_len``
        defaults to the chunk's length (exact for a one-chunk prompt
        only: the engines pass the prompt's length)."""
        h = self.attn.prefill_pages(self.attn_norm(x), pool_k, pool_v, table,
                                    start_pos)
        total = total_len if total_len is not None else x.shape[1]
        return self._prefill_ffn(x + h, total)


def moe_sharding_rules(base=None):
    """The experts over ``ep``, the router replicated; ``base``'s rules
    (the transformer's) after them.  The port serves and trains over
    ``tp`` alone, so a mesh with ``ep`` above 1 is refused
    (``ShardedDecoder``) and a rule that splits an expert raises in
    ``TransformerLM.shard``."""
    out = ShardingRules([
        (r"experts_w1$", P("ep", None, None)),
        (r"experts_w2$", P("ep", None, None)),
    ])
    if base is not None:
        out.extend(base)
    return out
