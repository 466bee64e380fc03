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
  ``copy_block``), what the serving engine runs.  Its
  attention always goes through the two kernel wrappers
  (``ops.paged_attention``, ``ops.prefill_attention``), which alone
  pick the plain version on a CPU tensor or the CUDA kernel on the card;
- the contiguous per-sequence cache (``init_cache`` / ``prefill`` /
  ``step`` and ``generate``), the isolated reference inside the port: a
  plain masked softmax over the whole cache, no kernel.

Unlike the reference, whose caches are immutable arrays threaded
through each call, every cache and pool here is updated IN PLACE.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..base import resolve_device
from ..ops import paged_attention, prefill_attention
from ..ops.flash_attention import flash_attention
from ..ops.contrib import rms_norm, rope
from ..ops.tensor import (paged_block_copy, paged_cache_permute_span,
                          paged_cache_write, paged_cache_write_rows,
                          paged_cache_write_span)
from .sampler import sample_next_token

__all__ = ["RMSNorm", "MultiHeadAttention", "LlamaDecoderLayer",
           "TransformerLM", "llama_tiny", "llama_3_8b"]


class RMSNorm(nn.Module):
    def __init__(self, units, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(units, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight)


def _masked_softmax(scores, valid):
    """float32 softmax with positions where ``valid`` is False at -inf
    (the reference's masked_softmax), cast back to the scores' dtype."""
    x = scores.float().masked_fill(~valid, float("-inf"))
    return torch.softmax(x, dim=-1).to(scores.dtype)


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

    def _project(self, x, offset):
        """x (B, T, C) → q (B, H, T, D), k and v (B, KV, T, D), rope
        applied at ``offset`` (python int, (B,) or (B, T) tensor)."""
        B, T, _ = x.shape
        H, KV, D = self.heads, self.kv_heads, self.head_dim
        qkv = self.qkv(x)
        q = qkv[..., :H * D].reshape(B, T, H, D).transpose(1, 2)
        k = qkv[..., H * D:(H + KV) * D].reshape(B, T, KV, D).transpose(1, 2)
        v = qkv[..., (H + KV) * D:].reshape(B, T, KV, D).transpose(1, 2)
        return rope(q, offset=offset), rope(k, offset=offset), v

    def _merge(self, out):
        """(B, H, T, D) attention output → (B, T, C) projected."""
        B, H, T, D = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(B, T, H * D))

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
        """(k, v) caches of (B, KV, max_length, D), zeros."""
        w = self.qkv.weight
        shape = (batch_size, self.kv_heads, max_length, self.head_dim)
        dt = dtype or w.dtype
        return (torch.zeros(shape, device=w.device, dtype=dt),
                torch.zeros(shape, device=w.device, dtype=dt))

    def prefill(self, x, cache_k, cache_v, start_pos=0):
        """T tokens at positions [start_pos, start_pos+T) in one pass:
        their K/V are written into the caches in place and each query
        attends the cache up to its own position."""
        B, T, _ = x.shape
        H, KV, D = self.heads, self.kv_heads, self.head_dim
        Tmax = cache_k.shape[2]
        q, k, v = self._project(x, start_pos)
        cache_k[:, :, start_pos:start_pos + T] = k.to(cache_k.dtype)
        cache_v[:, :, start_pos:start_pos + T] = v.to(cache_v.dtype)
        rep = H // KV
        q_r = q.reshape(B * KV, rep * T, D)
        keys = cache_k.reshape(B * KV, Tmax, D)
        values = cache_v.reshape(B * KV, Tmax, D)
        scores = torch.bmm(q_r, keys.transpose(1, 2)) / math.sqrt(D)
        dev = x.device
        valid = (torch.arange(Tmax, device=dev)[None, :]
                 <= (torch.arange(T, device=dev) + start_pos)[:, None])
        attn = _masked_softmax(scores.reshape(B * KV, rep, T, Tmax), valid)
        out = torch.bmm(attn.reshape(B * KV, rep * T, Tmax), values)
        out = out.reshape(B, KV, rep, T, D).reshape(B, H, T, D)
        return self._merge(out)

    # -- paged pool: the serving path --------------------------------------
    def init_block_pool(self, num_blocks, block_size, dtype=None):
        """(k, v) page pools of (num_blocks, KV, block_size, D), zeros;
        page 0 is the null page."""
        w = self.qkv.weight
        shape = (num_blocks, self.kv_heads, block_size, self.head_dim)
        dt = dtype or w.dtype
        return (torch.zeros(shape, device=w.device, dtype=dt),
                torch.zeros(shape, device=w.device, dtype=dt))

    def step_pages(self, x, pool_k, pool_v, tables, pos):
        """One decode token per slot: x (B, 1, C), ``tables`` (B, M)
        int32, ``pos`` (B,) int32.  Row b writes its K/V at position
        pos[b] through its table, then the ragged paged decode kernel
        reads [0, pos[b]]."""
        q, k, v = self._project(x, pos)
        paged_cache_write_rows(pool_k, k, tables, pos)
        paged_cache_write_rows(pool_v, v, tables, pos)
        out = paged_attention.paged_decode_attention(
            q.contiguous(), pool_k, pool_v, tables, pos)
        return self._merge(out)

    def verify_pages(self, x, pool_k, pool_v, tables, pos, valid_len,
                     tree=None):
        """A speculative verify window per slot: x (B, W, C) holds row
        b's last sampled token and up to W-1 drafted tokens, written at
        positions pos[b] .. pos[b]+W-1 (its first ``valid_len[b]`` lanes;
        the rest go to the null page), then read by the paged decode
        kernel: lane w attends [0, pos[b] + w].

        ``tree=(depth, anc)``, both (B, W) int32, verifies a draft tree
        instead: lane w is rotated at pos[b] + depth[b, w] and attends
        the committed history, itself and the lanes ``anc[b, w]`` marks
        as its ancestors.  Rejected lanes stay in the pool past the
        slot's position, behind every later mask."""
        off = pos if tree is None else pos.reshape(-1, 1) + tree[0]
        q, k, v = self._project(x, off)
        paged_cache_write_span(pool_k, k, tables, pos, valid_len)
        paged_cache_write_span(pool_v, v, tables, pos, valid_len)
        out = paged_attention.paged_decode_attention(
            q.contiguous(), pool_k, pool_v, tables, pos,
            anc=None if tree is None else tree[1])
        return self._merge(out)

    def prefill_pages(self, x, pool_k, pool_v, table, start_pos=0):
        """One prompt chunk x (1, T, C) at positions [start_pos,
        start_pos+T): its K/V scatter through ``table`` (M,) int32, then
        the chunked-prefill kernel attends shared prefix pages, earlier
        chunks and the chunk itself."""
        q, k, v = self._project(x, start_pos)
        paged_cache_write(pool_k, k, table, start_pos)
        paged_cache_write(pool_v, v, table, start_pos)
        out = prefill_attention.paged_prefill_attention(
            q.contiguous(), pool_k, pool_v, table, start_pos)
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

    def _ffn(self, x):
        h = self.ffn_norm(x)
        return x + self.down_proj(F.silu(self.gate_proj(h))
                                  * self.up_proj(h))

    def forward(self, x):
        return self._ffn(x + self.attn(self.attn_norm(x)))

    def prefill(self, x, cache_k, cache_v, start_pos=0):
        return self._ffn(x + self.attn.prefill(self.attn_norm(x), cache_k,
                                               cache_v, start_pos))

    def step_pages(self, x, pool_k, pool_v, tables, pos):
        return self._ffn(x + self.attn.step_pages(self.attn_norm(x), pool_k,
                                                  pool_v, tables, pos))

    def verify_pages(self, x, pool_k, pool_v, tables, pos, valid_len,
                     tree=None):
        return self._ffn(x + self.attn.verify_pages(
            self.attn_norm(x), pool_k, pool_v, tables, pos, valid_len,
            tree))

    def prefill_pages(self, x, pool_k, pool_v, table, start_pos=0):
        return self._ffn(x + self.attn.prefill_pages(
            self.attn_norm(x), pool_k, pool_v, table, start_pos))


class TransformerLM(nn.Module):
    """Causal decoder LM, Llama architecture.

    Built on the CUDA card unless ``device`` names another; with no
    device named and no CUDA present the constructor raises."""

    def __init__(self, vocab_size, units, hidden_size, num_layers, num_heads,
                 num_kv_heads=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        fk = {"device": device, "dtype": dtype}
        self.vocab_size = vocab_size
        self.embed = nn.Embedding(vocab_size, units, **fk)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(units, hidden_size, num_heads,
                              num_kv_heads or num_heads, **fk)
            for _ in range(num_layers)])
        self.norm = RMSNorm(units, **fk)
        self.lm_head = nn.Linear(units, vocab_size, bias=False, **fk)

    @property
    def device(self):
        return self.embed.weight.device

    @property
    def dtype(self):
        return self.embed.weight.dtype

    def _logits(self, x):
        return self.lm_head(self.norm(x))

    def forward(self, token_ids):
        """token_ids (B, T) → logits (B, T, V), differentiable: the
        training forward."""
        x = self.embed(torch.as_tensor(token_ids, device=self.device).long())
        for layer in self.layers:
            x = layer(x)
        return self._logits(x)

    # -- contiguous cache: the isolated reference --------------------------
    def init_cache(self, batch_size, max_length, dtype=None):
        """Per-layer (k, v) caches of (B, KV, max_length, D)."""
        return [layer.attn.init_cache(batch_size, max_length, dtype)
                for layer in self.layers]

    @torch.no_grad()
    def prefill(self, token_ids, caches, start_pos=0):
        """token_ids (B, T) at positions [start_pos, start_pos+T) →
        logits (B, T, V); every layer's cache is written in place."""
        x = self.embed(token_ids)
        for layer, (ck, cv) in zip(self.layers, caches):
            x = layer.prefill(x, ck, cv, start_pos)
        return self._logits(x)

    def step(self, token_ids, caches, pos):
        """One token per row, token_ids (B, 1), at position ``pos``
        (int) → logits (B, 1, V): a one-token prefill."""
        return self.prefill(token_ids, caches, start_pos=pos)

    # -- paged pool: the serving path --------------------------------------
    def init_block_pool(self, num_blocks, block_size, dtype=None):
        """Per-layer (k, v) page pools of (num_blocks, KV, bs, D)."""
        return [layer.attn.init_block_pool(num_blocks, block_size, dtype)
                for layer in self.layers]

    @torch.no_grad()
    def step_pages(self, token_ids, pools, tables, pos):
        """One decode token per slot: token_ids (B, 1), ``tables`` (B, M)
        int32, ``pos`` (B,) int32 → logits (B, 1, V).  Row b writes at
        position pos[b] and attends its own [0, pos[b]]."""
        x = self.embed(token_ids)
        for layer, (pk, pv) in zip(self.layers, pools):
            x = layer.step_pages(x, pk, pv, tables, pos)
        return self._logits(x)

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
        x = self.embed(token_ids)
        for layer, (pk, pv) in zip(self.layers, pools):
            x = layer.verify_pages(x, pk, pv, tables, pos, valid_len, tree)
        return self._logits(x)

    @torch.no_grad()
    def permute_pool_span(self, pools, tables, pos, src_lane):
        """The tree fix-up in every layer's pools, in place: row b's
        entry at position pos[b] + src_lane[b, j] moves to pos[b] + j,
        so an accepted side-branch path lands where sequential decode
        would have written it (lanes marked -1 stay as they are)."""
        for pk, pv in pools:
            paged_cache_permute_span(pk, tables, pos, src_lane)
            paged_cache_permute_span(pv, tables, pos, src_lane)

    @torch.no_grad()
    def prefill_pages(self, token_ids, pools, table, start_pos=0):
        """One prompt chunk token_ids (1, T) at positions [start_pos,
        start_pos+T) through the block table ``table`` (M,) int32 →
        logits (1, T, V)."""
        x = self.embed(token_ids)
        for layer, (pk, pv) in zip(self.layers, pools):
            x = layer.prefill_pages(x, pk, pv, table, start_pos)
        return self._logits(x)

    @torch.no_grad()
    def copy_block(self, pools, src, dst):
        """Copy page ``src`` onto page ``dst`` in every layer's pools —
        the copy-on-write of prefix sharing; ``src == dst`` does
        nothing."""
        for pk, pv in pools:
            paged_block_copy(pk, src, dst)
            paged_block_copy(pv, src, dst)

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens, max_length=None,
                 temperature=0.0, top_k=0, top_p=0.0, repetition_penalty=1.0,
                 seed=None):
        """Greedy (temperature 0) or sampled decode with the contiguous
        cache: the prompt in ONE prefill, then one ``step`` per token.
        prompt_ids (B, Tp) → (B, Tp + max_new_tokens), in the prompt's
        dtype on the model's device.

        Sampled draws come from one ``torch.Generator`` seeded with
        ``seed`` (a random seed when None), so an engine request with
        the same seed draws the same tokens.  repetition_penalty != 1
        applies in greedy mode too."""
        prompt_ids = torch.as_tensor(prompt_ids, device=self.device)
        B, Tp = prompt_ids.shape
        total = Tp + max_new_tokens
        max_length = max_length or total
        if max_length < total:
            raise ValueError("max_length %d < prompt+new %d"
                             % (max_length, total))
        ids = prompt_ids.long()
        caches = self.init_cache(B, max_length)
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


def llama_tiny(vocab_size=256, device=None, dtype=torch.float32):
    """Tiny decoder for tests: 2 layers, 64 units, 4 heads over 2 kv
    heads (head_dim 16), SwiGLU 172."""
    return TransformerLM(vocab_size, units=64, hidden_size=172, num_layers=2,
                         num_heads=4, num_kv_heads=2, device=device,
                         dtype=dtype)


def llama_3_8b(vocab_size=128256, width_factor=1.0, depth_factor=1.0,
               device=None, dtype=torch.bfloat16):
    """Llama-3-8B geometry: 4096 units, 32 heads over 8 kv heads
    (head_dim 128), SwiGLU 14336, 32 layers, vocab 128256.

    ``width_factor``/``depth_factor`` scale it down as the reference
    does, with its rounding: heads a multiple of 4 (at least 4), head_dim
    128, SwiGLU a multiple of 128, 4:1 GQA, at least one layer."""
    heads = max(4, int(32 * width_factor) // 4 * 4)
    hidden = int(14336 * width_factor) // 128 * 128 or 128
    return TransformerLM(vocab_size, units=128 * heads, hidden_size=hidden,
                         num_layers=max(1, int(32 * depth_factor)),
                         num_heads=heads, num_kv_heads=max(1, heads // 4),
                         device=device, dtype=dtype)
