"""The paged KV-cache ops as torch index ops (the port of the six
float block-paged cache ops in ``mxtpu/ops/tensor.py`` and of their int8
twins), the int8 quantizer of the KV cache, and the ambient choice of
its dtype (``resolve_cache_dtype``).

The pool is (N, KV, block_size, D); a request's block table lists its
pages in sequence order, logical position ``p`` living in page
``table[p // block_size]`` at offset ``p % block_size``.  Page 0 is the
null page: table entries past a request's allocation carry it, and
dead pool lanes (all-zero tables, position 0) write only there.

Unlike the reference, whose arrays are immutable and whose ops return a
new pool, the write and copy ops here update the pool IN PLACE (and
return it for convenience).  Writes are plain index assignment, never
``accumulate=True``: several dead lanes may hit the same null-page row,
and which of them lands there does not matter.

The float write, permute and copy ops index the pool's first three axes
only, so the same op moves an int8 payload (N, KV, bs, D) and its
float32 scales (N, KV, bs).  An int8 cache leaf is that pair: each K or
V row of D values is quantized on its own (``_q8_quantize``: scale =
max|x| / 127), so a row's stored payload and scale depend on that row
alone, whichever op wrote it — chunked prefill, a decode step or a
speculative window store the same bits.  The ``*_q8`` ops quantize,
then run the float op on the payload and on the scales with the same
indices.
"""

from __future__ import annotations

import os

import torch

__all__ = ["paged_cache_gather", "paged_cache_write",
           "paged_cache_write_rows", "paged_cache_write_span",
           "paged_cache_permute_span", "paged_block_copy", "_q8_quantize",
           "cache_dequant", "cache_write_q8", "paged_cache_gather_q8",
           "paged_cache_write_q8", "paged_cache_write_rows_q8",
           "paged_cache_write_span_q8", "paged_cache_permute_span_q8",
           "resolve_cache_dtype"]

_Q8_EPS = 1e-8  # scale floor (the reference's _Q8_EPS)


def resolve_cache_dtype(cache_dtype, default=torch.float32):
    """None → the ambient default: ``MXTPU_CACHE_DTYPE`` (e.g. "int8" to
    run every engine and ``generate`` quantized without touching call
    sites), else ``default`` (the port's copy of
    ``mxtpu.parallel.decode.resolve_cache_dtype``, whose default is
    float32; the engine and ``generate`` pass the model's own dtype, so
    a bfloat16 model keeps bfloat16 pools)."""
    if cache_dtype is not None:
        return cache_dtype
    return os.environ.get("MXTPU_CACHE_DTYPE", default)


def _q8_quantize(new):
    """(..., D) float → ((..., D) int8, (...,) float32 scale): symmetric
    round-to-nearest per-row quantization, in the reference's order of
    arithmetic (cast to float32; s = max(max|x|, 1e-8) / 127; round(x /
    s) half to even; clip to ±127), so the same float32 input gives the
    reference's payload and scales bit for bit.  A zero row gets the
    floor scale and a zero payload, which dequantizes to exact zeros."""
    x = new.float()
    s = torch.clamp_min(x.abs().amax(dim=-1), _Q8_EPS) / 127.0
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def cache_dequant(payload, scales):
    """An int8 cache's float32 view: payload * scale, the scale of each
    row broadcast over its D values."""
    return payload.float() * scales[..., None].float()


def cache_write_q8(cache, scales, new, pos=0):
    """The contiguous int8 cache's write in place: ``new`` (B, KV, T, D)
    is quantized per row and lands at positions pos .. pos+T-1 of the
    payload (B, KV, Tmax, D) and the scales (B, KV, Tmax)."""
    q, s = _q8_quantize(new)
    p = int(pos)
    cache[:, :, p:p + new.shape[2]] = q
    scales[:, :, p:p + new.shape[2]] = s
    return cache, scales


def paged_cache_gather(pool, table):
    """Gather a request's pages into sequence order: ``pool``
    (N, KV, bs, D) indexed by ``table`` (..., M) → (..., KV, M*bs, D).
    Null-padded entries contribute positions that sit past every
    validity mask."""
    g = pool[table.long()]                       # (..., M, KV, bs, D)
    m, kv, bs, d = g.shape[-4:]
    lead = tuple(g.shape[:-4])
    n = len(lead)
    perm = tuple(range(n)) + (n + 1, n, n + 2, n + 3)
    return g.permute(perm).reshape(lead + (kv, m * bs, d))


def paged_cache_write(pool, new, table, start_pos=0):
    """Scatter one sequence's prefill chunk ``new`` (1, KV, T, D) into
    ``pool`` in place: logical position ``start_pos + t`` lands in page
    ``table[(start_pos + t) // bs]`` at offset ``(start_pos + t) % bs``."""
    t = table.reshape(-1).long()
    bs = pool.shape[2]
    p = int(start_pos) + torch.arange(new.shape[2], device=pool.device)
    blk, off = t[p // bs], p % bs
    pool[blk, :, off] = new[0].transpose(0, 1).to(pool.dtype)
    return pool


def paged_cache_write_rows(pool, new, tables, pos):
    """Per-slot decode write in place: row b of ``new`` (B, KV, 1, D)
    lands at logical position ``pos[b]`` of the sequence ``tables[b]``
    (B, M) describes.  Live slots own disjoint pages; dead lanes'
    all-null tables scribble only on the null page."""
    t = tables.long()
    bs = pool.shape[2]
    p = pos.reshape(-1).long()
    rows = torch.arange(t.shape[0], device=pool.device)
    blk, off = t[rows, p // bs], p % bs
    pool[blk, :, off] = new[:, :, 0].to(pool.dtype)
    return pool


def _span_rows(tables, pos, lanes, bs):
    """Page and offset of logical positions pos[b] + lanes[b, w] through
    ``tables`` (B, M), with the page clamped onto the table: (blk,
    off, on_table), each (B, W)."""
    t = tables.long()
    M = t.shape[1]
    p = pos.reshape(-1, 1).long() + lanes
    page = p // bs
    blk = torch.gather(t, 1, page.clamp(0, M - 1))
    return blk, p % bs, page < M


def paged_cache_write_span(pool, new, tables, pos, valid_len):
    """Speculative-window write in place: row b of ``new`` (B, KV, W, D)
    lands at logical positions pos[b] .. pos[b]+W-1 of the sequence
    ``tables[b]`` describes, its first ``valid_len[b]`` lanes only.
    Lanes past valid_len and positions whose page falls off the table
    go to the null page 0, which absorbs them."""
    B, W = new.shape[0], new.shape[2]
    lanes = torch.arange(W, device=pool.device)[None, :].expand(B, W)
    blk, off, on_table = _span_rows(tables, pos, lanes, pool.shape[2])
    valid = lanes < valid_len.reshape(-1, 1).long()
    blk = torch.where(valid & on_table, blk, torch.zeros_like(blk))
    pool[blk, :, off] = new.transpose(1, 2).to(pool.dtype)
    return pool


def paged_cache_permute_span(pool, tables, pos, src_lane):
    """The tree fix-up in place: row b's entry at logical position
    pos[b] + src_lane[b, j] moves to pos[b] + j, so an accepted
    root-to-leaf path stored in lane order lands in depth order.  Lanes
    with src_lane < 0, and destinations off the table, write the null
    page 0.  Every source row is read (an advanced-index gather copies)
    before any row is written, so a source and a destination of one
    slot may overlap."""
    W = src_lane.shape[1]
    bs = pool.shape[2]
    sl = src_lane.long()
    src_blk, src_off, _ = _span_rows(tables, pos, sl.clamp(0, W - 1), bs)
    vals = pool[src_blk, :, src_off]                     # (B, W, KV, D)
    lanes = torch.arange(W, device=pool.device)[None, :].expand_as(sl)
    dst_blk, dst_off, on_table = _span_rows(tables, pos, lanes, bs)
    dst_blk = torch.where((sl >= 0) & on_table, dst_blk,
                          torch.zeros_like(dst_blk))
    pool[dst_blk, :, dst_off] = vals
    return pool


def paged_block_copy(pool, src=0, dst=0):
    """Copy page ``src`` onto page ``dst`` in place — the copy-on-write
    of prefix sharing.  ``src == dst`` leaves the pool as it was."""
    s, d = int(src), int(dst)
    if s != d:
        pool[d] = pool[s]
    return pool


def paged_cache_gather_q8(pool, scales, table):
    """The int8 twin of :func:`paged_cache_gather`: payload and scale
    pages gathered through ``table`` and dequantized, the float32
    (..., KV, M*bs, D) sequence-order view."""
    return (paged_cache_gather(pool, table).float()
            * paged_cache_gather(scales[..., None], table).float())


def paged_cache_write_q8(pool, scales, new, table, start_pos=0):
    """The int8 twin of :func:`paged_cache_write`: the chunk quantized
    per row, payload and scales scattered alike."""
    q, s = _q8_quantize(new)
    paged_cache_write(pool, q, table, start_pos)
    paged_cache_write(scales, s, table, start_pos)
    return pool, scales


def paged_cache_write_rows_q8(pool, scales, new, tables, pos):
    """The int8 twin of :func:`paged_cache_write_rows`."""
    q, s = _q8_quantize(new)
    paged_cache_write_rows(pool, q, tables, pos)
    paged_cache_write_rows(scales, s, tables, pos)
    return pool, scales


def paged_cache_write_span_q8(pool, scales, new, tables, pos, valid_len):
    """The int8 twin of :func:`paged_cache_write_span`: invalid lanes go
    to the null page on both the payload and the scale scatter."""
    q, s = _q8_quantize(new)
    paged_cache_write_span(pool, q, tables, pos, valid_len)
    paged_cache_write_span(scales, s, tables, pos, valid_len)
    return pool, scales


def paged_cache_permute_span_q8(pool, scales, tables, pos, src_lane):
    """The int8 twin of :func:`paged_cache_permute_span`: payload and
    scales move with one index set, no requantization; each is gathered
    in full before it is written."""
    paged_cache_permute_span(pool, tables, pos, src_lane)
    paged_cache_permute_span(scales, tables, pos, src_lane)
    return pool, scales
