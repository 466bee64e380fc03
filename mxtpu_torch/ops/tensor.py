"""The paged KV-cache ops as torch index ops (the port of the six
float block-paged cache ops in ``mxtpu/ops/tensor.py``).

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
"""

from __future__ import annotations

import torch

__all__ = ["paged_cache_gather", "paged_cache_write",
           "paged_cache_write_rows", "paged_cache_write_span",
           "paged_cache_permute_span", "paged_block_copy"]


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
    pool[blk, :, off, :] = new[0].transpose(0, 1).to(pool.dtype)
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
    pool[blk, :, off, :] = new[:, :, 0, :].to(pool.dtype)
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
    B, _, W, _ = new.shape
    lanes = torch.arange(W, device=pool.device)[None, :].expand(B, W)
    blk, off, on_table = _span_rows(tables, pos, lanes, pool.shape[2])
    valid = lanes < valid_len.reshape(-1, 1).long()
    blk = torch.where(valid & on_table, blk, torch.zeros_like(blk))
    pool[blk, :, off, :] = new.transpose(1, 2).to(pool.dtype)
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
    vals = pool[src_blk, :, src_off, :]                  # (B, W, KV, D)
    lanes = torch.arange(W, device=pool.device)[None, :].expand_as(sl)
    dst_blk, dst_off, on_table = _span_rows(tables, pos, lanes, bs)
    dst_blk = torch.where((sl >= 0) & on_table, dst_blk,
                          torch.zeros_like(dst_blk))
    pool[dst_blk, :, dst_off, :] = vals
    return pool


def paged_block_copy(pool, src=0, dst=0):
    """Copy page ``src`` onto page ``dst`` in place — the copy-on-write
    of prefix sharing.  ``src == dst`` leaves the pool as it was."""
    s, d = int(src), int(dst)
    if s != d:
        pool[d] = pool[s]
    return pool
