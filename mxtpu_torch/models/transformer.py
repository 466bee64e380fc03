"""Llama-style decoder LM (the port of ``LlamaDecoderLayer``,
``TransformerLM``, ``llama_tiny`` and ``llama_3_8b`` from
``mxtpu/models/transformer.py``).

The attention keeps the reference's layout: one fused QKV projection
split as [q | k | v], and the kv-major GQA fold — query head
h = kv*rep + r attends kv head kv — so the paged kernels read the
UNrepeated cache.  Dense weights are (out, in) in both frameworks.

The full forward (``TransformerLM.forward``, token ids → logits) is the
training path: its attention repeats each kv head ``rep`` times
(``repeat_interleave``, MXNet's element-wise ``repeat``: head h reads kv
head h // rep) and goes through ``ops.flash_attention`` (K3 forward,
K4/K5 backward), differentiable.

Two cache forms, both under ``torch.no_grad``:

- the paged pool (``init_block_pool`` / ``prefill_pages`` /
  ``step_pages`` / ``verify_pages`` / ``permute_pool_span`` /
  ``copy_block`` / ``read_pages`` / ``write_pages``), what the paged
  serving engine runs.  Its
  attention always goes through the two kernel wrappers
  (``ops.paged_attention``, ``ops.prefill_attention``), which alone
  pick the plain version on a CPU tensor or the CUDA kernel on the card;
- the contiguous per-sequence cache (``init_cache`` / ``prefill`` /
  ``step`` and ``generate``, the isolated reference inside the port;
  ``step_slots`` / ``verify_slots`` / ``permute_cache_span`` /
  ``write_cache_slot``, the slot engine's pooled forms, one cache row a
  slot): a plain masked softmax over the whole cache, no kernel, as the
  reference computes it.  ``verify_slots`` attends one window lane at a
  time with the step's shapes, so lane w is ``step_slots`` at pos + w
  bit for bit on any device.

Either form holds float leaves or, with the dtype ``"int8"``, int8
payloads with one float32 scale per head and position (see the leaf
helpers below).

The decode step and the verify window (``step_pages``,
``verify_pages``) run their six projections (qkv, out_proj, gate, up,
down, lm_head) through G1, the row-invariant projection: out_proj and
down through ``ops.linear.rows_linear``, and the four that read a norm's
output (qkv after attn_norm, gate and up after ffn_norm, lm_head after
the final norm) through ``ops.linear.rows_norm_linear``, which computes
the norm (G2, ``ops.contrib.rows_rms_norm``) inside the projection's
launch, with G2-then-G1's bits.  A row's result does not depend on how
many rows the call has: a verify window's lane rounds as the step at its
position would, so a speculative stream equals its plain stream in
bfloat16 too.  Prefill and the training forward keep ``nn.Linear`` and
``RMSNorm``.

A model quantized by ``contrib.quantization.quantize_weights`` holds
``QuantizedLinear`` layers in place of its ``nn.Linear`` ones (int8 or
packed int4 weights with float32 scales).  Every path then runs them
through G3 or G4 (``ops.linear.wq_matmul``, row invariant like G1):
the step and the window the norm-fused forms on the four normed
projections, every other call the op itself, prefill and ``generate``
included.  An int8 qkv over int8 pools takes the reference's fused int8
V epilogue in the step and the window (``_fused_q8_epilogue_on``,
``_project_qkv_fused_q8``): one G3 launch over the whole qkv weight
(``ops.linear.wq_matmul_q8``) gives q and k in x's dtype and V as the
pool stores it, int8 rows with their scales, which land by the
``*_pre_q8`` writes; the bits are those of projecting and then
quantizing at the write, which int4 weights, prefill and every other
cache write still do.

Unlike the reference, whose caches are immutable arrays threaded
through each call, every cache and pool here is updated IN PLACE.

Tensor parallelism (``TransformerLM.shard``, driven by
``parallel.decode.ShardedDecoder``): each rank keeps its slice of every
weight by ``transformer_lm_sharding_rules()`` (the fused qkv by head
group, so a rank runs H/n query and KV/n KV heads), and the layers
gather or reduce across the ``tp`` axis: the embedding's hidden split
is gathered after the lookup, out_proj's and down's partial sums are
reduced, the head's vocabulary split is gathered after the logits.  A
partial sum leaves its kernel already rounded to the activations' dtype
(G1, G3 and G4 write x's dtype); the reduce adds the partials in rank
order in float32 and rounds the sum again, so a bf16 model rounds twice
where tp = 1 rounds once.  The order is per element, so a row's sum
does not depend on the row count and a verify window still equals its
steps.  Every kernel runs on the rank's local shapes.

Live weight hot-swap (the serving engines' ``adopt``): ``TransformerLM.
prepare_adoption`` places a checkpoint's arrays on the device beside the
live weights and ``install_leaves`` points the parameters at them, so
every later launch reads them; nothing caches a copy or a pointer of a
weight across calls.  A generation is the engine's, not the model's: an
adopting engine binds its leaves for the length of its own iteration
and puts the model's own back after, so engines sharing one model adopt
apart.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..base import MXTPUError, resolve_device
from ..ops import paged_attention, prefill_attention
from ..ops.flash_attention import flash_attention
from ..ops.contrib import rms_norm, rope, rows_rms_norm
from ..contrib.quantization import QuantizedLinear
from ..ops.linear import rows_linear, rows_norm_linear, wq_matmul_q8
from ..ops.tensor import (cache_dequant, cache_permute_span,
                          cache_permute_span_q8, cache_write_q8,
                          cache_write_rows, cache_write_rows_q8,
                          cache_write_slot, cache_write_slot_q8,
                          cache_write_span, cache_write_span_q8,
                          paged_block_copy, paged_cache_permute_span,
                          paged_cache_permute_span_q8, paged_cache_write,
                          paged_cache_write_q8, paged_cache_write_rows,
                          paged_cache_write_rows_pre_q8,
                          paged_cache_write_rows_q8, paged_cache_write_span,
                          paged_cache_write_span_pre_q8,
                          paged_cache_write_span_q8, resolve_cache_dtype)
from ..parallel.collectives import all_gather, all_reduce
from ..parallel.sharding import (PartitionSpec as P, ShardingRules,
                                 int4_scale_split)
from .convert import mxtpu_name, strip_instance_prefix
from .moe import MoEDecoderLayer
from .sampler import sample_next_token

__all__ = ["RMSNorm", "MultiHeadAttention", "LlamaDecoderLayer",
           "MoEDecoderLayer", "TransformerLM", "llama_tiny", "llama_3_8b",
           "pool_tensors", "transformer_lm_sharding_rules"]


class RMSNorm(nn.Module):
    def __init__(self, units, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(units, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight)


# -- KV-cache leaves ---------------------------------------------------------
# A cache leaf is either one float tensor or, with dtype "int8", an
# (int8 payload, float32 scales) PAIR: the payload has the float leaf's
# shape, the scales that shape without its trailing D axis (one scale
# per head and position).  The helpers below dispatch every cache write
# and read on the leaf's form, so each attention method stays written
# once (the reference's _q8cache / _payload, mxtpu/models/transformer.py).

def _q8(leaf):
    """True when a cache leaf is the int8 (payload, scales) pair."""
    return isinstance(leaf, tuple)


def _new_leaf(shape, device, dtype):
    """A zero cache leaf of ``shape``: float of ``dtype`` (a torch dtype
    or its name), or the int8 pair for ``"int8"``."""
    if str(dtype) == "int8":
        return (torch.zeros(shape, device=device, dtype=torch.int8),
                torch.zeros(shape[:-1], device=device, dtype=torch.float32))
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.zeros(shape, device=device, dtype=dtype)


def _write(leaf, new, float_op, q8_op, *args):
    """Write K or V rows ``new`` into a cache leaf with ``float_op`` or,
    on an int8 leaf, its quantizing twin ``q8_op``."""
    if _q8(leaf):
        q8_op(leaf[0], leaf[1], new, *args)
    else:
        float_op(leaf, new, *args)


def _kernel_pools(pool_k, pool_v):
    """A layer's pools as the kernel wrappers take them: (pool_k,
    pool_v, {} or the int8 scales as keywords)."""
    if _q8(pool_k):
        return pool_k[0], pool_v[0], dict(k_scales=pool_k[1],
                                          v_scales=pool_v[1])
    return pool_k, pool_v, {}


def _linear(layer, x, rows):
    """``layer(x)`` for a bias-free ``nn.Linear``; with ``rows`` through
    :func:`rows_linear`.  A ``QuantizedLinear`` is its op (G3 or G4)
    either way."""
    if rows and not isinstance(layer, QuantizedLinear):
        return rows_linear(x, layer.weight)
    return layer(x)


def _normed_linear(norm, layer, x, rows):
    """``layer(norm(x))`` for an :class:`RMSNorm` and a bias-free
    ``nn.Linear``; with ``rows`` one :func:`rows_norm_linear` call (a
    ``QuantizedLinear``'s norm-fused op)."""
    if not rows:
        return layer(norm(x))
    if isinstance(layer, QuantizedLinear):
        return layer.normed(x, norm.weight)
    return rows_norm_linear(x, norm.weight, layer.weight)


def pool_tensors(pools):
    """Every tensor of per-layer (k, v) pools in one order: a layer's k
    then v, an int8 leaf's payload then its scales.  Each holds one page
    a row of its first axis."""
    return [t for pair in pools for leaf in pair
            for t in (leaf if _q8(leaf) else (leaf,))]


def _float_view(leaf):
    """A cache leaf as attention reads it: the float tensor, or an int8
    pair dequantized to float32."""
    return cache_dequant(*leaf) if _q8(leaf) else leaf


def _masked_softmax(scores, valid):
    """float32 softmax with positions where ``valid`` is False at -inf
    (the reference's masked_softmax), cast back to the scores' dtype."""
    x = scores.float().masked_fill(~valid, float("-inf"))
    return torch.softmax(x, dim=-1).to(scores.dtype)


class _TP:
    """The tensor-parallel axis a sharded module reduces or gathers over:
    the mesh, the axis name, the shard count ``n`` and this rank's chunk
    ``c``.  Partial sums, each already in the activations' dtype, are
    added in rank order in float32 and the sum rounded to that dtype
    (``parallel.collectives.all_reduce``)."""

    def __init__(self, mesh, axis, n, c):
        self.mesh, self.axis, self.n, self.c = mesh, axis, n, c

    def reduce(self, x):
        return all_reduce(x, self.axis, mesh=self.mesh)

    def gather(self, x):
        return all_gather(x, self.axis, axis=-1, mesh=self.mesh)


class MultiHeadAttention(nn.Module):
    """Causal self-attention of the Llama decoder: the fused QKV
    projection (no bias), GQA and rotary embedding, in its full forward
    and its cached decode forms."""

    def __init__(self, units, num_heads, num_kv_heads=None, device=None,
                 dtype=None):
        super().__init__()
        self.heads = num_heads
        self.kv_heads = num_kv_heads or num_heads
        if units % num_heads or num_heads % self.kv_heads:
            raise ValueError("units %d, heads %d and kv heads %d do not "
                             "divide" % (units, num_heads, self.kv_heads))
        self.head_dim = units // num_heads
        qkv_units = units + 2 * self.kv_heads * self.head_dim
        self.qkv = nn.Linear(units, qkv_units, bias=False, device=device,
                             dtype=dtype)
        self.out_proj = nn.Linear(units, units, bias=False, device=device,
                                  dtype=dtype)
        self._tp = None     # tensor parallel: out_proj's partial sums

    def _project(self, x, offset, norm=None, rows=False):
        """x (B, T, C) → q (B, H, T, D), k and v (B, KV, T, D), rope
        applied at ``offset`` (python int, (B,) or (B, T) tensor); x
        goes through the RMSNorm ``norm`` first where one is given.
        ``rows`` routes the projection through ``rows_linear`` or, with
        ``norm``, ``rows_norm_linear``, whose rounding of a row does not
        depend on the row count (the decode step and the verify
        window)."""
        B, T, _ = x.shape
        H, KV, D = self.heads, self.kv_heads, self.head_dim
        qkv = (_linear(self.qkv, x, rows) if norm is None
               else _normed_linear(norm, self.qkv, x, rows))
        q = qkv[..., :H * D].reshape(B, T, H, D).transpose(1, 2)
        k = qkv[..., H * D:(H + KV) * D].reshape(B, T, KV, D).transpose(1, 2)
        v = qkv[..., (H + KV) * D:].reshape(B, T, KV, D).transpose(1, 2)
        return rope(q, offset=offset), rope(k, offset=offset), v

    def _merge(self, out, rows=False):
        """(B, H, T, D) attention output → (B, T, C) projected."""
        B, H, T, D = out.shape
        y = _linear(self.out_proj, out.transpose(1, 2).reshape(B, T, H * D),
                    rows)
        return y if self._tp is None else self._tp.reduce(y)

    def forward(self, x):
        """x (B, T, C) → (B, T, C): rope at offset 0, each kv head
        repeated for its ``rep`` query heads, causal flash attention."""
        q, k, v = self._project(x, 0)
        rep = self.heads // self.kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        return self._merge(flash_attention(q, k, v, causal=True))

    # -- contiguous cache: the isolated reference --------------------------
    def init_cache(self, batch_size, max_length, dtype=None):
        """(k, v) caches of (B, KV, max_length, D), zeros, of ``dtype``
        (the weights' by default); ``"int8"`` makes each an (int8
        payload, float32 (B, KV, max_length) scales) pair."""
        w = self.qkv.weight
        shape = (batch_size, self.kv_heads, max_length, self.head_dim)
        dt = dtype or w.dtype
        return (_new_leaf(shape, w.device, dt), _new_leaf(shape, w.device, dt))

    def prefill(self, x, cache_k, cache_v, start_pos=0):
        """T tokens at positions [start_pos, start_pos+T) in one pass:
        their K/V are written into the caches in place and each query
        attends the cache up to its own position.  An int8 cache is
        read dequantized, the chunk's own rows included, as the
        reference reads it."""
        B, T, _ = x.shape
        H, KV, D = self.heads, self.kv_heads, self.head_dim
        q, k, v = self._project(x, start_pos)
        views = []
        for cache, new in ((cache_k, k), (cache_v, v)):
            if _q8(cache):
                cache_write_q8(*cache, new, start_pos)
                views.append(cache_dequant(*cache))
            else:
                cache[:, :, start_pos:start_pos + T] = new.to(cache.dtype)
                views.append(cache)
        keys, values = views
        Tmax = keys.shape[2]
        rep = H // KV
        q_r = q.reshape(B * KV, rep * T, D).to(keys.dtype)
        keys = keys.reshape(B * KV, Tmax, D)
        values = values.reshape(B * KV, Tmax, D)
        scores = torch.bmm(q_r, keys.transpose(1, 2)) / math.sqrt(D)
        dev = x.device
        valid = (torch.arange(Tmax, device=dev)[None, :]
                 <= (torch.arange(T, device=dev) + start_pos)[:, None])
        attn = _masked_softmax(scores.reshape(B * KV, rep, T, Tmax), valid)
        out = torch.bmm(attn.reshape(B * KV, rep * T, Tmax), values)
        out = out.reshape(B, KV, rep, T, D).reshape(B, H, T, D)
        return self._merge(out.to(x.dtype))

    def _slot_attend(self, q, keys, values, limit):
        """One query lane per row against the whole contiguous cache: q
        (B, H, 1, D); ``keys``/``values`` (B, KV, T_max, D) float views;
        row b attends positions <= limit[b].  The GQA fold of the
        reference's ``step_slots`` → (B, H, 1, D) in q's dtype."""
        B, H, _, D = q.shape
        KV, Tmax = keys.shape[1], keys.shape[2]
        rep = H // KV
        q_r = q.reshape(B * KV, rep, D).to(keys.dtype)
        scores = torch.bmm(q_r, keys.reshape(B * KV, Tmax, D).transpose(
            1, 2)) / math.sqrt(D)
        valid = (torch.arange(Tmax, device=q.device)[None, :]
                 <= limit.reshape(-1, 1).long())            # (B, Tmax)
        attn = _masked_softmax(scores.reshape(B, KV, rep, Tmax),
                               valid[:, None, None, :])
        out = torch.bmm(attn.reshape(B * KV, rep, Tmax),
                        values.reshape(B * KV, Tmax, D))
        return out.reshape(B, H, 1, D).to(q.dtype)

    def step_slots(self, x, norm, cache_k, cache_v, pos):
        """One decode token per cache row, each at its own position: x
        (B, 1, C), the residual stream, normalized by ``norm`` inside
        the qkv projection's launch; ``pos`` (B,) int.  Row b writes its
        K/V at pos[b] of its cache row and attends its own [0, pos[b]]
        (the reference's ``step_slots``; projections row invariant as in
        :meth:`step_pages`)."""
        q, k, v = self._project(x, pos, norm, rows=True)
        _write(cache_k, k, cache_write_rows, cache_write_rows_q8, pos)
        _write(cache_v, v, cache_write_rows, cache_write_rows_q8, pos)
        out = self._slot_attend(q, _float_view(cache_k),
                                _float_view(cache_v), pos)
        return self._merge(out, rows=True)

    def verify_slots(self, x, norm, cache_k, cache_v, pos, valid_len,
                     tree=None):
        """A speculative verify window per cache row: x (B, W, C), lane
        w at position pos[b] + w, its first ``valid_len[b]`` lanes
        written (the rest write nothing); lane w attends [0, pos[b] +
        w].  Each lane is attended on its own with the step's shapes,
        so its logits are :meth:`step_slots`' at pos[b] + w bit for
        bit, not only to rounding.

        ``tree=(perm, depth)`` ((B, W, W) and (B, W) integer) verifies a
        draft tree: lane w is rotated at pos[b] + depth[b, w], its K/V
        stays at pos[b] + w, and it attends its root path, the window's
        positions gathered into path order through ``perm[b, w]`` (the
        reference's ``_internal_tree_verify_attn``), under the step's
        mask t <= pos[b] + depth[b, w]."""
        B, W, _ = x.shape
        off = pos if tree is None else pos.reshape(-1, 1) + tree[1]
        q, k, v = self._project(x, off, norm, rows=True)
        _write(cache_k, k, cache_write_span, cache_write_span_q8, pos,
               valid_len)
        _write(cache_v, v, cache_write_span, cache_write_span_q8, pos,
               valid_len)
        keys, values = _float_view(cache_k), _float_view(cache_v)
        p = pos.reshape(-1).long()
        outs = []
        for w in range(W):
            if tree is None:
                outs.append(self._slot_attend(q[:, :, w:w + 1], keys,
                                              values, p + w))
                continue
            Tmax = keys.shape[2]
            t = torch.arange(Tmax, device=x.device)[None, :]
            rel = t - p[:, None]                                  # (B, T)
            inside = (rel >= 0) & (rel < W)
            anc = torch.gather(tree[0][:, w].long(), 1, rel.clamp(0, W - 1))
            src = torch.where(inside, p[:, None] + anc, t).clamp(0, Tmax - 1)
            idx = src[:, None, :, None].expand(keys.shape)
            outs.append(self._slot_attend(
                q[:, :, w:w + 1], torch.gather(keys, 2, idx),
                torch.gather(values, 2, idx), p + tree[1][:, w].long()))
        return self._merge(torch.cat(outs, dim=2), rows=True)

    # -- the fused int8 V epilogue -------------------------------------------
    def _fused_q8_epilogue_on(self, pool_v):
        """Whether the step and the window project qkv with G3's q8
        epilogue: an int8 ``QuantizedLinear`` qkv feeding an int8 pool
        (the reference's eligibility; its paged kernels are always on
        here)."""
        return (_q8(pool_v) and isinstance(self.qkv, QuantizedLinear)
                and self.qkv.bits == 8)

    def _project_qkv_fused_q8(self, x, offset, norm):
        """:meth:`_project` with the fused epilogue, in one launch over
        the whole qkv weight: q (B, H, T, D) and k (B, KV, T, D) roped
        at ``offset`` in x's dtype, V as the int8 pool stores it,
        payload (B, KV, T, D) int8 and scales (B, KV, T) float32 — the
        bits of projecting and then quantizing at the write."""
        B, T, _ = x.shape
        H, KV, D = self.heads, self.kv_heads, self.head_dim
        qk, vq, vs = wq_matmul_q8(x, self.qkv.weight, self.qkv.wscale, D,
                                  KV * D, gamma=norm.weight,
                                  bias=self.qkv.bias)
        q = qk[..., :H * D].reshape(B, T, H, D).transpose(1, 2)
        k = qk[..., H * D:].reshape(B, T, KV, D).transpose(1, 2)
        return (rope(q, offset=offset), rope(k, offset=offset),
                vq.reshape(B, T, KV, D).transpose(1, 2),
                vs.reshape(B, T, KV).transpose(1, 2))

    # -- paged pool: the serving path --------------------------------------
    def init_block_pool(self, num_blocks, block_size, dtype=None):
        """(k, v) page pools of (num_blocks, KV, block_size, D), zeros,
        of ``dtype`` (the weights' by default); ``"int8"`` makes each an
        (int8 payload, float32 (num_blocks, KV, block_size) scales)
        pair.  Page 0 is the null page."""
        w = self.qkv.weight
        shape = (num_blocks, self.kv_heads, block_size, self.head_dim)
        dt = dtype or w.dtype
        return (_new_leaf(shape, w.device, dt), _new_leaf(shape, w.device, dt))

    def step_pages(self, x, norm, pool_k, pool_v, tables, pos):
        """One decode token per slot: x (B, 1, C), the residual stream,
        which the RMSNorm ``norm`` normalizes inside the qkv
        projection's launch; ``tables`` (B, M) int32, ``pos`` (B,)
        int32.  Row b writes its K/V at position pos[b] through its
        table, then the ragged paged decode kernel reads [0, pos[b]]."""
        if self._fused_q8_epilogue_on(pool_v):
            q, k, vq, vs = self._project_qkv_fused_q8(x, pos, norm)
            paged_cache_write_rows_pre_q8(*pool_v, vq, vs, tables, pos)
        else:
            q, k, v = self._project(x, pos, norm, rows=True)
            _write(pool_v, v, paged_cache_write_rows,
                   paged_cache_write_rows_q8, tables, pos)
        _write(pool_k, k, paged_cache_write_rows, paged_cache_write_rows_q8,
               tables, pos)
        pk, pv, scales = _kernel_pools(pool_k, pool_v)
        out = paged_attention.paged_decode_attention(
            q.contiguous(), pk, pv, tables, pos, **scales)
        return self._merge(out, rows=True)

    def verify_pages(self, x, norm, pool_k, pool_v, tables, pos, valid_len,
                     tree=None):
        """A speculative verify window per slot: x (B, W, C), normalized
        by ``norm`` inside the qkv projection as in :meth:`step_pages`,
        holds row b's last sampled token and up to W-1 drafted tokens,
        written at
        positions pos[b] .. pos[b]+W-1 (its first ``valid_len[b]`` lanes;
        the rest go to the null page), then read by the paged decode
        kernel: lane w attends [0, pos[b] + w].

        ``tree=(depth, anc)``, both (B, W) int32, verifies a draft tree
        instead: lane w is rotated at pos[b] + depth[b, w] and attends
        the committed history, itself and the lanes ``anc[b, w]`` marks
        as its ancestors.  Rejected lanes stay in the pool past the
        slot's position, behind every later mask."""
        off = pos if tree is None else pos.reshape(-1, 1) + tree[0]
        if self._fused_q8_epilogue_on(pool_v):
            q, k, vq, vs = self._project_qkv_fused_q8(x, off, norm)
            paged_cache_write_span_pre_q8(*pool_v, vq, vs, tables, pos,
                                          valid_len)
        else:
            q, k, v = self._project(x, off, norm, rows=True)
            _write(pool_v, v, paged_cache_write_span,
                   paged_cache_write_span_q8, tables, pos, valid_len)
        _write(pool_k, k, paged_cache_write_span, paged_cache_write_span_q8,
               tables, pos, valid_len)
        pk, pv, scales = _kernel_pools(pool_k, pool_v)
        out = paged_attention.paged_decode_attention(
            q.contiguous(), pk, pv, tables, pos,
            anc=None if tree is None else tree[1], **scales)
        return self._merge(out, rows=True)

    def prefill_pages(self, x, pool_k, pool_v, table, start_pos=0):
        """One prompt chunk x (1, T, C) at positions [start_pos,
        start_pos+T): its K/V scatter through ``table`` (M,) int32, then
        the chunked-prefill kernel attends shared prefix pages, earlier
        chunks and the chunk itself."""
        q, k, v = self._project(x, start_pos)
        _write(pool_k, k, paged_cache_write, paged_cache_write_q8, table,
               start_pos)
        _write(pool_v, v, paged_cache_write, paged_cache_write_q8, table,
               start_pos)
        pk, pv, scales = _kernel_pools(pool_k, pool_v)
        out = prefill_attention.paged_prefill_attention(
            q.contiguous(), pk, pv, table, start_pos, **scales)
        return self._merge(out)


class LlamaDecoderLayer(nn.Module):
    """Pre-RMSNorm block: GQA attention with rotary, then SwiGLU FFN."""

    def __init__(self, units, hidden_size, num_heads, num_kv_heads,
                 device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.attn_norm = RMSNorm(units, **fk)
        self.attn = MultiHeadAttention(units, num_heads, num_kv_heads, **fk)
        self.ffn_norm = RMSNorm(units, **fk)
        self.gate_proj = nn.Linear(units, hidden_size, bias=False, **fk)
        self.up_proj = nn.Linear(units, hidden_size, bias=False, **fk)
        self.down_proj = nn.Linear(hidden_size, units, bias=False, **fk)
        self._tp = None     # tensor parallel: down's partial sums

    def _ffn(self, x, rows=False):
        if rows:        # ffn_norm runs inside the gate and up launches
            gate, up = (_normed_linear(self.ffn_norm, proj, x, True)
                        for proj in (self.gate_proj, self.up_proj))
        else:
            h = self.ffn_norm(x)
            gate, up = self.gate_proj(h), self.up_proj(h)
        y = _linear(self.down_proj, F.silu(gate) * up, rows)
        return x + (y if self._tp is None else self._tp.reduce(y))

    def forward(self, x):
        return self._ffn(x + self.attn(self.attn_norm(x)))

    def prefill(self, x, cache_k, cache_v, start_pos=0, total_len=None):
        """``total_len`` (a routed layer's capacity budget) is accepted
        and ignored, so the model passes it to every layer alike."""
        return self._ffn(x + self.attn.prefill(self.attn_norm(x), cache_k,
                                               cache_v, start_pos))

    def step(self, x, cache_k, cache_v, pos):
        """``generate``'s step: a one-token prefill at ``pos``."""
        return self.prefill(x, cache_k, cache_v, pos)

    def step_slots(self, x, cache_k, cache_v, pos):
        return self._ffn(x + self.attn.step_slots(
            x, self.attn_norm, cache_k, cache_v, pos), rows=True)

    def verify_slots(self, x, cache_k, cache_v, pos, valid_len, tree=None):
        return self._ffn(x + self.attn.verify_slots(
            x, self.attn_norm, cache_k, cache_v, pos, valid_len, tree),
            rows=True)

    def step_pages(self, x, pool_k, pool_v, tables, pos):
        return self._ffn(x + self.attn.step_pages(
            x, self.attn_norm, pool_k, pool_v, tables, pos), rows=True)

    def verify_pages(self, x, pool_k, pool_v, tables, pos, valid_len,
                     tree=None):
        return self._ffn(x + self.attn.verify_pages(
            x, self.attn_norm, pool_k, pool_v, tables, pos, valid_len,
            tree), rows=True)

    def prefill_pages(self, x, pool_k, pool_v, table, start_pos=0,
                      total_len=None):
        return self._ffn(x + self.attn.prefill_pages(
            self.attn_norm(x), pool_k, pool_v, table, start_pos))


class TransformerLM(nn.Module):
    """Causal decoder LM, Llama architecture.

    Built on the CUDA card unless ``device`` names another; with no
    device named and no CUDA present the constructor raises.  With
    ``tie_weights`` the logits head is the embedding's weight (no
    ``lm_head``, so ``quantize_weights`` leaves the head in float, as
    the reference never quantizes a tied head).

    ``num_experts`` builds :class:`~mxtpu_torch.models.moe.
    MoEDecoderLayer`s (a Switch top-1 FFN of that many experts of
    ``hidden_size``, ``capacity_factor``) in place of the SwiGLU
    layers; with ``return_moe_aux`` the full forward returns ``(logits,
    aux)``, aux the layers' load-balancing terms summed over the layers
    and divided by their count."""

    def __init__(self, vocab_size, units, hidden_size, num_layers, num_heads,
                 num_kv_heads=None, device=None, dtype=torch.float32,
                 tie_weights=False, num_experts=None, capacity_factor=1.25,
                 return_moe_aux=False):
        super().__init__()
        device = resolve_device(device)
        fk = {"device": device, "dtype": dtype}
        self.vocab_size = vocab_size
        self.num_experts = int(num_experts) if num_experts else None
        self.return_moe_aux = bool(return_moe_aux and num_experts)
        self.embed = nn.Embedding(vocab_size, units, **fk)
        kv = num_kv_heads or num_heads
        self.layers = nn.ModuleList([
            MoEDecoderLayer(units, hidden_size, num_heads, kv, num_experts,
                            capacity_factor, return_aux=self.return_moe_aux,
                            **fk) if num_experts else
            LlamaDecoderLayer(units, hidden_size, num_heads, kv, **fk)
            for _ in range(num_layers)])
        self.norm = RMSNorm(units, **fk)
        self.tie_weights = bool(tie_weights)
        self.lm_head = None if self.tie_weights else nn.Linear(
            units, vocab_size, bias=False, **fk)
        # tensor parallel (:meth:`shard`): the embedding's hidden split,
        # gathered after the lookup, and the head's vocabulary split,
        # gathered after the logits
        self._tp_embed = None
        self._tp_head = None
        self._tp_shard = None

    @property
    def device(self):
        return self.embed.weight.device

    @property
    def dtype(self):
        return self.embed.weight.dtype

    def _embed(self, token_ids):
        x = self.embed(token_ids)
        return x if self._tp_embed is None else self._tp_embed.gather(x)

    def _logits(self, x, rows=False):
        if self.tie_weights:
            w = self.embed.weight
            tp = self._tp_embed
            if tp is None:
                return (rows_norm_linear(x, self.norm.weight, w) if rows
                        else F.linear(self.norm(x), w))
            # the head reads the embedding's hidden split: row parallel,
            # its partial logits over the whole vocabulary reduced
            h = rows_rms_norm(x, self.norm.weight) if rows else self.norm(x)
            k = w.shape[1]
            h = h[..., tp.c * k:(tp.c + 1) * k].contiguous()
            return tp.reduce(rows_linear(h, w) if rows else F.linear(h, w))
        y = _normed_linear(self.norm, self.lm_head, x, rows)
        return y if self._tp_head is None else self._tp_head.gather(y)

    def forward(self, token_ids):
        """token_ids (B, T) → logits (B, T, V), differentiable: the
        training forward; ``(logits, aux)`` with ``return_moe_aux``."""
        x = self._embed(torch.as_tensor(token_ids,
                                        device=self.device).long())
        aux = None
        for layer in self.layers:
            x = layer(x)
            if self.return_moe_aux:
                x, a = x
                aux = a if aux is None else aux + a
        logits = self._logits(x)
        if self.return_moe_aux:
            return logits, aux / len(self.layers)
        return logits

    # -- contiguous cache: the isolated reference --------------------------
    def init_cache(self, batch_size, max_length, dtype=None):
        """Per-layer (k, v) caches of (B, KV, max_length, D) of
        ``dtype``, the model's by default (int8 pairs for ``"int8"``)."""
        return [layer.attn.init_cache(batch_size, max_length,
                                      dtype or self.dtype)
                for layer in self.layers]

    @torch.no_grad()
    def prefill(self, token_ids, caches, start_pos=0, total_len=None):
        """token_ids (B, T) at positions [start_pos, start_pos+T) →
        logits (B, T, V); every layer's cache is written in place.
        ``total_len``: the whole prompt's length, from which routed
        (MoE) layers budget their expert capacity (start_pos + T by
        default)."""
        x = self._embed(token_ids)
        for layer, (ck, cv) in zip(self.layers, caches):
            x = layer.prefill(x, ck, cv, start_pos, total_len=total_len)
        return self._logits(x)

    @torch.no_grad()
    def step(self, token_ids, caches, pos):
        """One token per row, token_ids (B, 1), at position ``pos``
        (int) → logits (B, 1, V): a one-token prefill (routed layers
        capacity-unbounded)."""
        x = self._embed(token_ids)
        for layer, (ck, cv) in zip(self.layers, caches):
            x = layer.step(x, ck, cv, pos)
        return self._logits(x)

    @torch.no_grad()
    def step_slots(self, token_ids, caches, pos):
        """One decode token per cache row, each at its own position:
        token_ids (B, 1), ``pos`` (B,) int → logits (B, 1, V).  Row b
        writes at pos[b] of its cache row and attends its own [0,
        pos[b]]: the slot engine's pooled step."""
        x = self._embed(token_ids)
        for layer, (ck, cv) in zip(self.layers, caches):
            x = layer.step_slots(x, ck, cv, pos)
        return self._logits(x, rows=True)

    @torch.no_grad()
    def verify_slots(self, token_ids, caches, pos, valid_len, tree=None):
        """Score a speculative window per cache row in one forward:
        token_ids (B, W), row b's last sampled token then up to W-1
        drafts from position pos[b] → logits (B, W, V), lane w's equal
        to :meth:`step_slots`' at pos[b] + w (on its own tree path with
        ``tree=(perm, depth)``, see ``MultiHeadAttention.verify_slots``).
        ``valid_len`` (B,) counts each row's real lanes; the others
        write nothing."""
        x = self._embed(token_ids)
        for layer, (ck, cv) in zip(self.layers, caches):
            x = layer.verify_slots(x, ck, cv, pos, valid_len, tree)
        return self._logits(x, rows=True)

    @torch.no_grad()
    def permute_cache_span(self, caches, pos, src_lane):
        """The tree fix-up in every layer's contiguous cache, in place:
        row b's entry at pos[b] + src_lane[b, j] moves to pos[b] + j
        (lanes marked -1 stay as they are)."""
        for leaf in (leaf for pair in caches for leaf in pair):
            if _q8(leaf):
                cache_permute_span_q8(*leaf, pos, src_lane)
            else:
                cache_permute_span(leaf, pos, src_lane)

    @torch.no_grad()
    def write_cache_slot(self, caches, slot_caches, slot, pos=0):
        """Copy one sequence's per-layer caches (batch 1, length T) into
        row ``slot`` of ``caches`` at positions pos .. pos+T-1, in place
        (an int8 scratch is copied as it is, no requantization)."""
        for pair, spair in zip(caches, slot_caches):
            for leaf, new in zip(pair, spair):
                if _q8(leaf):
                    cache_write_slot_q8(*leaf, *new, slot, pos)
                else:
                    cache_write_slot(leaf, new, slot, pos)

    # -- paged pool: the serving path --------------------------------------
    def init_block_pool(self, num_blocks, block_size, dtype=None):
        """Per-layer (k, v) page pools of (num_blocks, KV, bs, D) of
        ``dtype``, the model's by default (int8 pairs for ``"int8"``)."""
        return [layer.attn.init_block_pool(num_blocks, block_size,
                                           dtype or self.dtype)
                for layer in self.layers]

    @torch.no_grad()
    def step_pages(self, token_ids, pools, tables, pos):
        """One decode token per slot: token_ids (B, 1), ``tables`` (B, M)
        int32, ``pos`` (B,) int32 → logits (B, 1, V).  Row b writes at
        position pos[b] and attends its own [0, pos[b]]."""
        x = self._embed(token_ids)
        for layer, (pk, pv) in zip(self.layers, pools):
            x = layer.step_pages(x, pk, pv, tables, pos)
        return self._logits(x, rows=True)

    @torch.no_grad()
    def verify_pages(self, token_ids, pools, tables, pos, valid_len,
                     tree=None):
        """Score a speculative window per slot in one forward:
        token_ids (B, W) — row b's last sampled token then up to W-1
        drafted tokens, from position pos[b] — → logits (B, W, V).
        Lane w's logits are those the sequential step at pos[b] + w
        would give (on its own tree path with ``tree=(depth, anc)``, see
        ``MultiHeadAttention.verify_pages``).  ``valid_len`` (B,) int32
        counts each row's real lanes.  Rejection needs only a host
        position roll-back."""
        x = self._embed(token_ids)
        for layer, (pk, pv) in zip(self.layers, pools):
            x = layer.verify_pages(x, pk, pv, tables, pos, valid_len, tree)
        return self._logits(x, rows=True)

    @torch.no_grad()
    def permute_pool_span(self, pools, tables, pos, src_lane):
        """The tree fix-up in every layer's pools, in place: row b's
        entry at position pos[b] + src_lane[b, j] moves to pos[b] + j,
        so an accepted side-branch path lands where sequential decode
        would have written it (lanes marked -1 stay as they are)."""
        for leaf in (leaf for pair in pools for leaf in pair):
            if _q8(leaf):
                paged_cache_permute_span_q8(*leaf, tables, pos, src_lane)
            else:
                paged_cache_permute_span(leaf, tables, pos, src_lane)

    @torch.no_grad()
    def prefill_pages(self, token_ids, pools, table, start_pos=0,
                      total_len=None):
        """One prompt chunk token_ids (1, T) at positions [start_pos,
        start_pos+T) through the block table ``table`` (M,) int32 →
        logits (1, T, V).  ``total_len``: the whole prompt's length, the
        routed layers' capacity budget (the chunk's length by
        default)."""
        x = self._embed(token_ids)
        for layer, (pk, pv) in zip(self.layers, pools):
            x = layer.prefill_pages(x, pk, pv, table, start_pos,
                                    total_len=total_len)
        return self._logits(x)

    @torch.no_grad()
    def copy_block(self, pools, src, dst):
        """Copy page ``src`` onto page ``dst`` in every layer's pools —
        the copy-on-write of prefix sharing; ``src == dst`` does
        nothing."""
        for t in pool_tensors(pools):
            paged_block_copy(t, src, dst)

    @torch.no_grad()
    def read_pages(self, pools, pages):
        """Copy pages ``pages`` of every layer's pools to host memory: one
        gather a pool tensor into one device buffer that holds a page a
        row (the pool tensors' rows side by side as bytes, in
        :func:`pool_tensors` order), then ONE copy of it to host.
        Returns the (len(pages), bytes a page) uint8 CPU tensor.  From the
        card the copy lands in pinned memory, ``non_blocking`` on the
        current stream, so it is ordered before any later write to those
        pages; the caller keeps the buffer alive until it is done."""
        tensors = pool_tensors(pools)
        n = len(pages)
        idx = torch.tensor(pages, dtype=torch.long, device=tensors[0].device)
        rows = torch.cat([t.index_select(0, idx).reshape(n, -1)
                          .view(torch.uint8) for t in tensors], dim=1)
        if not rows.is_cuda:
            return rows
        host = torch.empty(rows.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        return host

    @torch.no_grad()
    def write_pages(self, pools, pages, host):
        """Write ``host`` (:meth:`read_pages`' form, a page a row) into
        pages ``pages`` of every layer's pools, in place: ONE copy to the
        device (``non_blocking`` from pinned memory, on the current
        stream), then one ``index_copy_`` a pool tensor."""
        tensors = pool_tensors(pools)
        n = len(pages)
        idx = torch.tensor(pages, dtype=torch.long, device=tensors[0].device)
        rows = host.to(tensors[0].device, non_blocking=True)
        at = 0
        for t in tensors:
            nb = t[0].numel() * t.element_size()
            src = rows[:, at:at + nb].contiguous().view(t.dtype)
            t.index_copy_(0, idx, src.reshape(n, *t.shape[1:]))
            at += nb

    # -- live weight hot-swap -----------------------------------------------
    def _adoption_params(self):
        """[(reference name, parameter)] sorted by name, the reference
        decoder's order: the prefix-stripped names ``load_mxtpu_params``
        uses (a quantized layer's int8 payload and ``wscale`` included;
        a tied head is the embedding, named once).  Kept until the
        parameter objects change (``quantize_weights`` replaces
        layers), since an adopting engine rebinds through it twice an
        iteration."""
        key = tuple(map(id, self.parameters()))
        if getattr(self, "_adoption_key", None) != key:
            self._adoption_order = sorted(
                ((mxtpu_name(n), p) for n, p in self.named_parameters()),
                key=lambda np_: np_[0])
            self._adoption_key = key
        return self._adoption_order

    # -- tensor parallelism -------------------------------------------------
    def _fused_groups(self):
        """{name: row groups} of the fused weights: each layer's qkv
        weight (and its int8 or int4 scales), ``(H*D, KV*D, KV*D)``."""
        out = {}
        for i, layer in enumerate(self.layers):
            a = layer.attn
            g = (a.heads * a.head_dim, a.kv_heads * a.head_dim,
                 a.kv_heads * a.head_dim)
            out["layer%d_attn_qkv_weight" % i] = g
            out["layer%d_attn_qkv_wscale" % i] = g
        return out

    @torch.no_grad()
    def shard(self, mesh, rules):
        """Keep only this rank's shard of every parameter, in place, by
        ``rules`` on ``mesh`` (``parallel.sharding``: the fused qkv split
        by head group), and turn on the layers' tensor-parallel forms:

        - the embedding split on hidden: lookup, then ``all_gather``;
        - qkv, gate and up column parallel on the local heads or hidden;
          the attention then runs H/n query and KV/n KV heads;
        - out_proj and down row parallel, their partial sums
          ``all_reduce``d (partials in the activations' dtype, added
          in rank order in float32, the sum rounded again);
        - the head split on vocabulary: local logits, then
          ``all_gather``; a tied head (the embedding's hidden split) is
          row parallel, its partial logits over the whole vocabulary
          reduced;
        - a routed (MoE) layer's ``ffn_norm``, router and experts whole
          on every rank (a rule that splits them raises: expert
          parallelism is not ported).

        A layer's projections are split together or not at all, and
        every split is over one mesh axis; anything else raises.  A mesh
        whose axes the rules do not split leaves the model as it is.
        Sharding again by equal rules on the same mesh does nothing."""
        key = (id(mesh), tuple(rules.iter_rules()))
        if self._tp_shard is not None:
            if self._tp_shard["key"] == key:
                return self
            raise MXTPUError("this model is already sharded on another mesh "
                             "or by other rules")
        params = self._adoption_params()
        full = {name: p.data for name, p in params}
        groups = self._fused_groups()
        plan, shard, axis = {}, None, None
        for name, t in full.items():
            split_k = None
            if name.endswith("wscale"):
                wname = name[:-len("wscale")] + "weight"
                split_k = int4_scale_split(rules, wname, full[wname], t, mesh)
            spec = rules.spec_for(name, t.dim())
            cuts = rules.split_dims(name, t.dim(), mesh)
            for d, n, c in cuts:
                entry = spec[d]
                if not isinstance(entry, str) or shard not in (None, (n, c)):
                    raise MXTPUError(
                        "tensor parallel: every split must be over the same "
                        "single mesh axis; %s is split by %r" % (name, spec))
                shard, axis = (n, c), entry
            plan[name] = (groups.get(name), split_k, [d for d, _, _ in cuts])
        if shard is None:
            return self
        dims = {name: p[2] for name, p in plan.items()}

        def form(names, want):
            got = [dims[nm] for nm in names]
            if all(g == [] for g in got):
                return False
            if got == [[w] for w in want]:
                return True
            raise MXTPUError(
                "tensor parallel: %s must be split on dims %s together or "
                "not at all; the rules give %s" % (names, want, got))

        for name, d in dims.items():
            if d and "_moe_" in name:
                raise MXTPUError(
                    "tensor parallel: %s is split by the rules (dims %s); "
                    "the router and the experts stay whole on every rank — "
                    "expert parallelism (an ep axis) is not ported"
                    % (name, d))
        tp = _TP(mesh, axis, *shard)
        n = tp.n
        seen = set()
        for i, layer in enumerate(self.layers):
            pre = "layer%d_" % i
            attn = [pre + "attn_qkv_weight", pre + "attn_out_weight"]
            ffn = [] if isinstance(layer, MoEDecoderLayer) else [
                pre + "gate_weight", pre + "up_weight", pre + "down_weight"]
            seen.update(attn + ffn)
            if form(attn, [0, 1]):
                a = layer.attn
                if a.heads % n or a.kv_heads % n:
                    raise MXTPUError(
                        "tensor parallel: %d query and %d KV heads do not "
                        "split over %d shards" % (a.heads, a.kv_heads, n))
                a.heads //= n
                a.kv_heads //= n
                a.qkv.out_features //= n
                a.out_proj.in_features //= n
                a._tp = tp
            if form(ffn, [0, 0, 1]):
                layer.gate_proj.out_features //= n
                layer.up_proj.out_features //= n
                layer.down_proj.in_features //= n
                layer._tp = tp
        seen.add("embed_weight")
        if form(["embed_weight"], [1]):
            self.embed.embedding_dim //= n
            self._tp_embed = tp
        if not self.tie_weights:
            seen.add("lm_head_weight")
            if form(["lm_head_weight"], [0]):
                self.lm_head.out_features //= n
                self._tp_head = tp
        for name, (_, _, d) in plan.items():
            if name.endswith("wscale"):
                wd = dims[name[:-len("wscale")] + "weight"]
                if (wd == [0]) != (d == [0]) or d not in ([], [0]):
                    raise MXTPUError(
                        "tensor parallel: %s must be split with its weight's "
                        "output dim (%s), the rules give %s" % (name, wd, d))
            elif d and name not in seen:
                raise MXTPUError("tensor parallel: %s cannot be split (the "
                                 "rules give dims %s)" % (name, d))
        for name, p in params:
            g, split_k, _ = plan[name]
            p.data = rules.local(name, p.data, mesh, g, split_k)
        self._tp_shard = dict(key=key, plan=plan, mesh=mesh, rules=rules,
                              tp=tp)
        return self

    @property
    def tp_size(self):
        """The shard count of the model's tensor parallelism (1 unless
        :meth:`shard` split it)."""
        return 1 if self._tp_shard is None else self._tp_shard["tp"].n

    def _local_slice(self, name, arr):
        """This rank's slice of the whole reference array ``arr`` of
        parameter ``name`` (``arr`` itself when the model is not
        sharded), a CPU tensor."""
        if self._tp_shard is None:
            return torch.from_numpy(np.array(arr))
        sh = self._tp_shard
        g, split_k, _ = sh["plan"][name]
        return sh["rules"].local(name, np.asarray(arr), sh["mesh"], g,
                                 split_k)

    @torch.no_grad()
    def gathered_params(self):
        """``{reference name: whole tensor}`` of every parameter,
        gathered from the shards (collective: every rank of the axis
        calls it; every rank gets the whole tensors)."""
        params = self._adoption_params()
        if self._tp_shard is None:
            return {name: p.data for name, p in params}
        sh = self._tp_shard
        tp = sh["tp"]
        out = {}
        for name, p in params:
            g, split_k, dims = sh["plan"][name]
            t = p.data
            for d in reversed(dims + ([1] if split_k else [])):
                parts = all_gather(t, tp.axis, 0, tiled=False, mesh=tp.mesh)
                if d == 0 and g is not None:
                    pieces, at = [], 0
                    for rows in (x // tp.n for x in g):
                        pieces += [q.narrow(0, at, rows) for q in parts]
                        at += rows
                    t = torch.cat(pieces, 0)
                else:
                    t = torch.cat(list(parts.unbind(0)), d)
            out[name] = t
        return out

    def _live_param_leaves(self):
        """The tensors every later call reads, in ``_adoption_params``
        order (rollback keeps them to install again)."""
        return tuple(p.data for _, p in self._adoption_params())

    def prepare_adoption(self, named):
        """Validate ``{name: host array}`` against this model's
        parameters and place each array on the model's device in its
        parameter's dtype, WITHOUT installing anything (the counterpart
        of the reference decoder's ``prepare_adoption``): the engines
        stage a checkpoint while streams are in flight and install it at
        an empty iteration boundary.  Extra names are ignored.  A name
        matches exactly first, else with the outermost instance prefix
        stripped (``transformerlm1_embed_weight``); an ambiguous stripped
        name is a mismatch.  Raises ``ValueError`` on a missing name or a
        shape that differs."""
        stripped = {}
        for k in named:
            key = strip_instance_prefix(k)
            stripped[key] = None if key in stripped else k
        leaves = []
        for name, p in self._adoption_params():
            src = name if name in named else stripped.get(name)
            if src is None:
                raise ValueError("checkpoint is missing parameter %r — "
                                 "architecture mismatch" % name)
            arr = self._local_slice(name, named[src])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    "checkpoint parameter %r has shape %r, block expects "
                    "%r — architecture mismatch"
                    % (name, tuple(arr.shape), tuple(p.shape)))
            leaves.append(arr.to(device=p.device, dtype=p.dtype))
        return tuple(leaves)

    @torch.no_grad()
    def install_leaves(self, leaves):
        """Point every parameter at its tensor in ``leaves`` (from
        :meth:`prepare_adoption`, or a :meth:`_live_param_leaves` kept
        for rollback): every later call, and so every kernel launch
        (the kernels read ``data_ptr()`` at each launch), reads the new
        tensors; no copy is made.  The serving engines hold their weight
        generation apart from the model and bind it with this for the
        length of one iteration, putting the model's own leaves back
        after, so engines sharing the model adopt apart."""
        params = self._adoption_params()
        if len(leaves) != len(params):
            raise ValueError("%d leaves for %d parameters"
                             % (len(leaves), len(params)))
        for (_, p), leaf in zip(params, leaves):
            p.data = leaf

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens, max_length=None,
                 temperature=0.0, top_k=0, top_p=0.0, repetition_penalty=1.0,
                 seed=None, cache_dtype=None):
        """Greedy (temperature 0) or sampled decode with the contiguous
        cache: the prompt in ONE prefill, then one ``step`` per token.
        prompt_ids (B, Tp) → (B, Tp + max_new_tokens), in the prompt's
        dtype on the model's device.

        Sampled draws come from one ``torch.Generator`` seeded with
        ``seed`` (a random seed when None), so an engine request with
        the same seed draws the same tokens.  repetition_penalty != 1
        applies in greedy mode too.  ``cache_dtype`` is the cache's
        element type (:func:`~mxtpu_torch.ops.tensor.resolve_cache_dtype`;
        the model's dtype by default, ``"int8"``
        for the quantized cache)."""
        prompt_ids = torch.as_tensor(prompt_ids, device=self.device)
        B, Tp = prompt_ids.shape
        total = Tp + max_new_tokens
        max_length = max_length or total
        if max_length < total:
            raise ValueError("max_length %d < prompt+new %d"
                             % (max_length, total))
        ids = prompt_ids.long()
        caches = self.init_cache(
            B, max_length, resolve_cache_dtype(cache_dtype, self.dtype))
        logits = self.prefill(ids, caches)
        sampled = bool(temperature and temperature > 0.0)
        penalized = bool(repetition_penalty and repetition_penalty != 1.0)
        gen = None
        if sampled:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed) if seed is not None
                            else int(np.random.randint(0, 2**31 - 1)))
        seen = None
        if penalized:
            seen = torch.zeros((B, logits.shape[-1]), dtype=torch.bool,
                               device=self.device)
            seen[torch.arange(B, device=self.device)[:, None], ids] = True
        tokens = [ids]
        rows = torch.arange(B, device=self.device)
        for pos in range(Tp, total):
            if sampled or penalized:
                nxt = sample_next_token(
                    logits[:, -1], gen, temperature if sampled else 0.0,
                    top_k, top_p, repetition_penalty, seen_mask=seen)
            else:
                nxt = torch.argmax(logits[:, -1], dim=-1)
            nxt = nxt.reshape(B, 1)
            tokens.append(nxt)
            if penalized:
                seen[rows, nxt[:, 0]] = True
            if pos < total - 1:
                logits = self.step(nxt, caches, pos)
        return torch.cat(tokens, dim=1).to(prompt_ids.dtype)


def llama_tiny(vocab_size=256, device=None, dtype=torch.float32, **kwargs):
    """Tiny decoder for tests: 2 layers, 64 units, 4 heads over 2 kv
    heads (head_dim 16), SwiGLU 172.  ``kwargs``: the constructor's
    (``num_experts``, ``capacity_factor``, ``return_moe_aux``,
    ``tie_weights``)."""
    return TransformerLM(vocab_size, units=64, hidden_size=172, num_layers=2,
                         num_heads=4, num_kv_heads=2, device=device,
                         dtype=dtype, **kwargs)


def llama_3_8b(vocab_size=128256, width_factor=1.0, depth_factor=1.0,
               device=None, dtype=torch.bfloat16, **kwargs):
    """Llama-3-8B geometry: 4096 units, 32 heads over 8 kv heads
    (head_dim 128), SwiGLU 14336, 32 layers, vocab 128256.

    ``width_factor``/``depth_factor`` scale it down as the reference
    does, with its rounding: heads a multiple of 4 (at least 4), head_dim
    128, SwiGLU a multiple of 128, 4:1 GQA, at least one layer.
    ``kwargs``: the constructor's (``num_experts=8`` makes each layer a
    Switch FFN of 8 experts of the SwiGLU's hidden width)."""
    heads = max(4, int(32 * width_factor) // 4 * 4)
    hidden = int(14336 * width_factor) // 128 * 128 or 128
    return TransformerLM(vocab_size, units=128 * heads, hidden_size=hidden,
                         num_layers=max(1, int(32 * depth_factor)),
                         num_heads=heads, num_kv_heads=max(1, heads // 4),
                         device=device, dtype=dtype, **kwargs)


def transformer_lm_sharding_rules():
    """Tensor-parallel layout of the decoder family (the reference's
    rules): qkv, gate and up column parallel, out_proj and down row
    parallel, the embedding split on hidden and the head on vocabulary.
    The fused qkv splits by head group (``parallel.sharding``)."""
    return ShardingRules([
        (r"qkv_weight$", P("tp", None)),
        (r"attn_out_weight$", P(None, "tp")),
        (r"(gate|up)_weight$", P("tp", None)),
        (r"down_weight$", P(None, "tp")),
        (r"embed_weight$", P(None, "tp")),
        (r"lm_head_weight$", P("tp", None)),
    ])
