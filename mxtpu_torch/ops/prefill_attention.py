"""Chunked-prefill attention over one slot's block table: the CUDA
kernels of ``csrc/prefill_attention.cu`` (the port of the Pallas TPU
kernel ``mxtpu/ops/pallas/prefill_attention.py``) and their plain
PyTorch version.

``paged_prefill_attention`` is the wrapper the model calls.  On a CPU
tensor it runs :func:`paged_prefill_attention_plain`; on a CUDA tensor
it launches a kernel, or raises — there is no fallback from the card
to the plain version.  Each call adds one to the ``paged_prefill``
launch counter (``mxtpu_torch.base``); calls over int8 pools count
under ``paged_prefill[int8]``.

Two routes on the card, chosen by :func:`route` from q's dtype alone:
bfloat16 queries (over bfloat16 pools, or int8 pools with their float32
scales ``k_scales``/``v_scales``) run the tensor-core kernel
(``mma.sync`` bf16 with float32 sums, the key walk split over a thread
block cluster; its launch plan is :func:`_tc_plan`); float32 queries
(over float32 or int8 pools) run the float32 walk on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXTPUError, bump
from .partition import check_head_shard
from . import _build
from .paged_attention import (CUDA_CORES, MAX_SMEM_BYTES, TENSOR_CORES,
                              _NEG_INF, check_index, check_kernel_geometry,
                              gather_pages, kernel_fn, route, tc_depth)

__all__ = ["paged_prefill_attention", "paged_prefill_attention_plain",
           "route", "KERNEL_NAME", "KERNEL_NAME_Q8", "TENSOR_CORES",
           "CUDA_CORES"]

KERNEL_NAME = "paged_prefill"
KERNEL_NAME_Q8 = "paged_prefill[int8]"
_FNS: dict = {}
_TC_FNS: dict = {}

# the tensor-core kernel's tiling (csrc/prefill_attention.cu): keys a
# staged tile, warps a block (16 fold rows each), blocks a cluster, and
# the SMs the splits aim to fill (the H100's 132)
_TC_KEYS = 32
_TC_MAX_WARPS = 4
_TC_MAX_SPLITS = 8
_SMS = 132


def _cdiv(a, b):
    return -(-a // b)


def _tc_smem(rows, DP, M, quant, stages):
    """Shared memory of one tensor-core block, in bytes, as the kernel
    carves it (``tc_smem_bytes``): the page ids, the queries, then the
    larger of the walk's buffers and the combine's float32 rows."""
    ld, ld8 = DP + 8, DP + 16
    stage = (2 * _TC_KEYS * ld8 + 2 * _TC_KEYS * 4 if quant
             else 2 * _TC_KEYS * ld * 2)
    walk = stages * stage + (2 * _TC_KEYS * ld * 2 if quant else 0)
    combine = rows * (DP + 2) * 4
    return _cdiv(M, 4) * 16 + rows * ld * 2 + max(walk, combine)


def _tc_plan(KV, fold, D, bs, M, quant):
    """The tensor-core launch: ``warps`` a block (16 fold lanes each, so
    ``groups`` lane groups a kv head), ``splits`` blocks a cluster (each
    walks every splits-th key tile; as many as fill the SMs with the
    grid of KV x groups, at most 8 and at most the tiles a table can
    hold), ring ``stages`` (the most of 4, 3, 2 that fit) and the
    shared memory ``smem`` in bytes."""
    DP = tc_depth(D)
    warps = min(_TC_MAX_WARPS, _cdiv(fold, 16))
    groups = _cdiv(fold, 16 * warps)
    splits = max(1, min(_TC_MAX_SPLITS, _cdiv(M * bs, _TC_KEYS),
                        _SMS // (KV * groups)))
    for stages in (4, 3, 2):
        smem = _tc_smem(16 * warps, DP, M, quant, stages)
        if smem <= MAX_SMEM_BYTES:
            return dict(DP=DP, warps=warps, groups=groups, splits=splits,
                        stages=stages, smem=smem)
    raise MXTPUError("paged_prefill_attention: head_dim %d with a table of "
                     "%d pages needs more than %d bytes of shared memory"
                     % (D, M, MAX_SMEM_BYTES))


def _tc_fn(quant):
    """The tensor-core launch function of the kernel library (it refuses
    a plan whose shared memory disagrees with its own layout)."""
    fn = _TC_FNS.get(quant)
    if fn is None:
        lib = _build.load("prefill_attention")
        fn = getattr(lib, "mxtpu_paged_prefill_tc_bf16" + ("_q8" if quant
                                                           else ""))
        fn.argtypes = [ctypes.c_void_p] * (6 + 2 * quant) + [
            ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _TC_FNS[quant] = fn
    return fn


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
    check_head_shard("paged_prefill_attention", H, pool_k.shape[1])
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
    start = None
    if torch.is_tensor(start_pos):
        start = start_pos.reshape(1)
        check_index("start_pos", start, (1,), q.device)
    rep = H // KV
    sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr()]
    if quant:
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
    if route(q) == TENSOR_CORES:
        # the kernel reads a tensor start itself (else the int) and
        # derives the table's live pages from it
        plan = _tc_plan(KV, rep * T, D, bs, M, quant)
        rc = _tc_fn(quant)(
            *ptrs, table.data_ptr(), None if start is None
            else start.data_ptr(), out.data_ptr(),
            0 if start is not None else int(start_pos), KV, rep, T, D, bs,
            M, plan["DP"], plan["warps"], plan["splits"], plan["stages"],
            plan["smem"], sm_scale, stream)
    else:
        fn, stages = kernel_fn("prefill_attention", "mxtpu_paged_prefill",
                               quant, 7, 6, _FNS)
        if not stages(rep * T, D, bs, M, pool_k.element_size()):
            raise MXTPUError("paged_prefill_attention: D=%d, bs=%d, M=%d "
                             "need more than %d bytes of shared memory"
                             % (D, bs, M, MAX_SMEM_BYTES))
        if start is None:
            start = torch.full((1,), int(start_pos), dtype=torch.int32,
                               device=q.device)
        nv = torch.clamp(torch.div(start + (T - 1), bs,
                                   rounding_mode="floor") + 1,
                         1, M).to(torch.int32)
        rc = fn(*ptrs, table.data_ptr(), start.data_ptr(), nv.data_ptr(),
                out.data_ptr(), KV, rep, T, D, bs, M, sm_scale, stream)
    if rc != 0:
        raise MXTPUError("paged_prefill_attention: CUDA launch failed "
                         "(cudaError %d)" % rc)
    bump(name)
    return out
