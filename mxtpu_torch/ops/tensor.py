"""The KV-cache ops as torch index ops (the port of the block-paged
cache ops and the contiguous slot-cache ops of ``mxtpu/ops/tensor.py``,
and of their int8 twins), the int8 quantizer of the KV cache, and the
ambient choice of its dtype (``resolve_cache_dtype``).  The ``*_pre_q8``
writes land rows that arrive quantized (G3's q8 epilogue) with their
``*_q8`` twin's index math.

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
           "paged_cache_write_rows_pre_q8", "paged_cache_write_span_pre_q8",
           "cache_write_rows", "cache_write_span", "cache_write_slot",
           "cache_permute_span", "cache_write_rows_q8", "cache_write_span_q8",
           "cache_write_slot_q8", "cache_permute_span_q8",
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


_LEVELS: dict = {}  # a 0-dim float32 127 a device


def _levels(device):
    """127, the int8 levels, as a 0-dim float32 tensor on ``device``
    (cached a device): a divisor that keeps a division IEEE on CUDA,
    which divides by a Python number through its reciprocal."""
    levels = _LEVELS.get(device)
    if levels is None:
        levels = _LEVELS[device] = torch.tensor(127.0, device=device)
    return levels


def _q8_quantize(new):
    """(..., D) float → ((..., D) int8, (...,) float32 scale): symmetric
    round-to-nearest per-row quantization, in the reference's order of
    arithmetic (cast to float32; s = max(max|x|, 1e-8) / 127; round(x /
    s) half to even; clip to ±127), so the same float32 input gives the
    reference's payload and scales bit for bit.  A zero row gets the
    floor scale and a zero payload, which dequantizes to exact zeros.
    Both divisions are IEEE divisions on every device: 127 is a 0-dim
    tensor on x's device, since CUDA divides by a Python number through
    its reciprocal (G3's q8 epilogue divides the same way)."""
    x = new.float()
    s = torch.clamp_min(x.abs().amax(dim=-1), _Q8_EPS) / _levels(x.device)
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


# -- the contiguous per-slot cache of the slot engine ----------------------
# The cache is (B, KV, T_max, D), one row a slot (and an int8 cache's
# scales (B, KV, T_max)); the float ops index its first three axes only,
# so one op moves a payload and its scales alike.

def _write_lanes(cache, dst, vals, valid):
    """``cache[b, :, dst[b, w]] = vals[b, w]`` for the lanes where
    ``valid`` (B, W) holds, with no host sync: the reference drops the
    other lanes by scattering them past T_max, which an index_put here
    refuses.  An invalid lane writes what its row's first valid lane
    writes, where that lane writes it; in a row with no valid lane, the
    value already at the row's first clamped position back onto it.
    Every row's duplicate writes carry one value, so the result does not
    depend on which lands.  ``vals`` (B, W, ...) is read in full before
    any write."""
    B, W = dst.shape
    rows = torch.arange(B, device=cache.device)[:, None]
    first = valid.int().argmax(dim=1, keepdim=True)              # (B, 1)
    some = valid.any(dim=1, keepdim=True)
    at = torch.where(some, dst.gather(1, first),
                     dst[:, :1].clamp(0, cache.shape[2] - 1))
    tail = (1,) * (vals.dim() - 2)
    anchor = torch.where(some.reshape((B, 1) + tail), vals[rows, first],
                         cache[rows, :, at])
    cache[rows, :, torch.where(valid, dst, at)] = torch.where(
        valid.reshape((B, W) + tail), vals, anchor)
    return cache


def cache_write_rows(cache, new, pos):
    """Per-slot decode write in place: row b of ``new`` (B, KV, 1, D)
    lands at position ``pos[b]`` of cache row b."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, pos.reshape(-1).long()] = new[:, :, 0].to(cache.dtype)
    return cache


def cache_write_span(cache, new, pos, valid_len):
    """Speculative-window write in place: row b of ``new`` (B, KV, W, D)
    lands at positions pos[b] .. pos[b]+W-1 of cache row b, its first
    ``valid_len[b]`` lanes only; the other lanes, and positions past
    T_max, write nothing (:func:`_write_lanes`)."""
    B, W = new.shape[0], new.shape[2]
    lanes = torch.arange(W, device=cache.device)[None, :]
    dst = pos.reshape(-1, 1).long() + lanes
    valid = (lanes < valid_len.reshape(-1, 1).long()) & (dst < cache.shape[2])
    return _write_lanes(cache, dst, new.transpose(1, 2).to(cache.dtype),
                        valid)


def cache_write_slot(cache, new, slot=0, pos=0):
    """Copy one sequence's cache block ``new`` (1, KV, T, D) into row
    ``slot`` of ``cache`` at positions pos .. pos+T-1 (the slot
    prefill's write)."""
    p = int(pos)
    cache[int(slot), :, p:p + new.shape[2]] = new[0].to(cache.dtype)
    return cache


def cache_permute_span(cache, pos, src_lane):
    """The tree fix-up in place: row b's entry at position pos[b] +
    src_lane[b, j] moves to pos[b] + j.  Lanes with src_lane < 0, and
    destinations past T_max, write nothing; every source is read before
    any write, so a row's sources and destinations may overlap."""
    B, W = src_lane.shape
    T = cache.shape[2]
    sl = src_lane.long()
    p = pos.reshape(-1, 1).long()
    rows = torch.arange(B, device=cache.device)[:, None]
    vals = cache[rows, :, (p + sl.clamp(0, W - 1)).clamp(0, T - 1)]
    dst = p + torch.arange(W, device=cache.device)[None, :]
    return _write_lanes(cache, dst, vals, (sl >= 0) & (dst < T))


def cache_write_rows_q8(cache, scales, new, pos):
    """The int8 twin of :func:`cache_write_rows`."""
    q, s = _q8_quantize(new)
    cache_write_rows(cache, q, pos)
    cache_write_rows(scales, s, pos)
    return cache, scales


def cache_write_span_q8(cache, scales, new, pos, valid_len):
    """The int8 twin of :func:`cache_write_span`: invalid lanes write
    nothing on the payload and on the scales."""
    q, s = _q8_quantize(new)
    cache_write_span(cache, q, pos, valid_len)
    cache_write_span(scales, s, pos, valid_len)
    return cache, scales


def cache_write_slot_q8(cache, scales, new_q, new_s, slot=0, pos=0):
    """The int8 twin of :func:`cache_write_slot`: an already quantized
    block (payload (1, KV, T, D) int8 and its (1, KV, T) scales, the
    slot prefill's scratch) copied, no requantization."""
    cache_write_slot(cache, new_q, slot, pos)
    cache_write_slot(scales, new_s, slot, pos)
    return cache, scales


def cache_permute_span_q8(cache, scales, pos, src_lane):
    """The int8 twin of :func:`cache_permute_span`: payload and scales
    move with one index set, no requantization."""
    cache_permute_span(cache, pos, src_lane)
    cache_permute_span(scales, pos, src_lane)
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


def paged_cache_write_rows_pre_q8(pool, scales, new_q, new_s, tables, pos):
    """:func:`paged_cache_write_rows_q8` of rows that arrive quantized
    (G3's q8 epilogue): ``new_q`` (B, KV, 1, D) int8 and ``new_s`` (B,
    KV, 1) float32 land with the same index math, no requantization."""
    paged_cache_write_rows(pool, new_q, tables, pos)
    paged_cache_write_rows(scales, new_s, tables, pos)
    return pool, scales


def paged_cache_write_span_pre_q8(pool, scales, new_q, new_s, tables, pos,
                                  valid_len):
    """:func:`paged_cache_write_span_q8` of pre-quantized rows: payload
    (B, KV, W, D) int8 and scales (B, KV, W) float32, invalid lanes to
    the null page on both scatters, no requantization."""
    paged_cache_write_span(pool, new_q, tables, pos, valid_len)
    paged_cache_write_span(scales, new_s, tables, pos, valid_len)
    return pool, scales


def paged_cache_permute_span_q8(pool, scales, tables, pos, src_lane):
    """The int8 twin of :func:`paged_cache_permute_span`: payload and
    scales move with one index set, no requantization; each is gathered
    in full before it is written."""
    paged_cache_permute_span(pool, tables, pos, src_lane)
    paged_cache_permute_span(scales, tables, pos, src_lane)
    return pool, scales
