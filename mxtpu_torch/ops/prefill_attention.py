"""Chunked-prefill attention over one slot's block table: the CUDA
kernel ``csrc/prefill_attention.cu`` (the port of the Pallas TPU kernel
``mxtpu/ops/pallas/prefill_attention.py``) and its plain PyTorch
version.

``paged_prefill_attention`` is the wrapper the model calls.  On a CPU
tensor it runs :func:`paged_prefill_attention_plain`; on a CUDA tensor
it launches the kernel, or raises — there is no fallback from the card
to the plain version.  Each call adds one to the ``paged_prefill``
launch counter (``mxtpu_torch.base``).

Ported: float32 and bfloat16 pools, and int8 pools with their float32
scales (``k_scales``/``v_scales``), for float32 or bfloat16 queries.
Calls over int8 pools count under ``paged_prefill[int8]``.
"""

from __future__ import annotations

import math

import torch

from ..base import MXTPUError, bump
from .paged_attention import (MAX_SMEM_BYTES, _NEG_INF, check_index,
                              check_kernel_geometry, gather_pages, kernel_fn)

__all__ = ["paged_prefill_attention", "paged_prefill_attention_plain",
           "KERNEL_NAME", "KERNEL_NAME_Q8"]

KERNEL_NAME = "paged_prefill"
KERNEL_NAME_Q8 = "paged_prefill[int8]"
_FNS: dict = {}


def paged_prefill_attention_plain(q, pool_k, pool_v, table, start_pos,
                                  k_scales=None, v_scales=None):
    """The kernel's plain version: gather the whole table (and
    dequantize an int8 pool with its scales), then a causal masked
    float32 softmax (the math of the reference's ``xla_reference``).
    q (1, H, T, D) is one chunk whose K/V already sit in the pools at
    positions start_pos .. start_pos+T-1; query t attends positions
    <= start_pos + t.  Returns (1, H, T, D)."""
    _, H, T, D = q.shape
    KV = pool_k.shape[1]
    rep = H // KV
    table = table.reshape(-1)
    keys = gather_pages(pool_k, k_scales, table)         # (KV, M*bs, D)
    values = gather_pages(pool_v, v_scales, table)
    qr = q.reshape(KV, rep * T, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("kld,ktd->klt", qr, keys)
    k_pos = torch.arange(keys.shape[1], device=q.device)
    start = start_pos.reshape(()).long() if torch.is_tensor(start_pos) \
        else int(start_pos)
    q_pos = start + torch.arange(rep * T, device=q.device) % T
    valid = k_pos[None, None, :] <= q_pos[None, :, None]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("klt,ktd->kld", p, values)
    return o.reshape(1, H, T, D).to(q.dtype)


def paged_prefill_attention(q, pool_k, pool_v, table, start_pos,
                            k_scales=None, v_scales=None):
    """Chunked-prefill attention of one slot.

    q : (1, H, T, D) chunk queries, rope applied; T is the padded chunk
        length.  The chunk's K/V are already written to the pools.
    pool_k / pool_v : (N, KV, bs, D) page pools (page 0 = null page):
        float of q's dtype, or int8 payloads with ``k_scales`` /
        ``v_scales`` (N, KV, bs) float32.
    table : (M,) int32 block table of the slot.
    start_pos : the chunk's first logical position (python int or an
        int32 scalar tensor on q's device).

    Returns (1, H, T, D) in q's dtype."""
    _, H, T, D = q.shape
    quant = k_scales is not None
    name = KERNEL_NAME_Q8 if quant else KERNEL_NAME
    if q.device.type == "cpu":
        bump(name)
        return paged_prefill_attention_plain(q, pool_k, pool_v, table,
                                             start_pos, k_scales, v_scales)
    if q.device.type != "cuda":
        raise MXTPUError("paged_prefill_attention: no kernel for device %s"
                         % q.device)
    if q.shape[0] != 1:
        raise MXTPUError("paged_prefill_attention: q must be one chunk "
                         "(1, H, T, D), got %s" % (tuple(q.shape),))
    check_kernel_geometry(q, pool_k, pool_v, k_scales, v_scales)
    _, KV, bs, _ = pool_k.shape
    M = table.shape[-1]
    check_index("table", table, (M,), q.device)
    if torch.is_tensor(start_pos):
        start = start_pos.reshape(1)
        check_index("start_pos", start, (1,), q.device)
    else:
        start = torch.full((1,), int(start_pos), dtype=torch.int32,
                           device=q.device)
    rep = H // KV
    fn, stages = kernel_fn("prefill_attention", "mxtpu_paged_prefill",
                           q.dtype, quant, 7, 6, _FNS)
    if not stages(rep * T, D, bs, M, pool_k.element_size()):
        raise MXTPUError("paged_prefill_attention: D=%d, bs=%d, M=%d need "
                         "more than %d bytes of shared memory"
                         % (D, bs, M, MAX_SMEM_BYTES))
    sm_scale = 1.0 / math.sqrt(D)
    nv = torch.clamp(torch.div(start + (T - 1), bs, rounding_mode="floor")
                     + 1, 1, M).to(torch.int32)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scales = [k_scales.data_ptr(), v_scales.data_ptr()] if quant else []
    rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *scales,
            table.data_ptr(), start.data_ptr(), nv.data_ptr(),
            out.data_ptr(), KV, rep, T, D, bs, M, sm_scale, stream)
    if rc != 0:
        raise MXTPUError("paged_prefill_attention: CUDA launch failed "
                         "(cudaError %d)" % rc)
    bump(name)
    return out
