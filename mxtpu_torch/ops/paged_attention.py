"""Ragged paged decode attention: the CUDA kernel
``csrc/paged_attention.cu`` (the port of the Pallas TPU kernel
``mxtpu/ops/pallas/paged_attention.py``) and its plain PyTorch version.

``paged_decode_attention`` is the wrapper the model calls.  On a CPU
tensor it runs :func:`paged_decode_attention_plain`; on a CUDA tensor it
launches the kernel, or raises for what the kernel does not take —
there is no fallback from the card to the plain version.  Each call
adds one to the ``paged_attention`` launch counter (``mxtpu_torch.base``).

Ported: the plain decode read (W = 1), the speculative verify window
(W > 1) and the tree ancestor mask (``anc``, W <= 32), over float32 and
bfloat16 pools and over int8 pools with their float32 scales
(``k_scales``/``v_scales``, (N, KV, bs)), for float32 or bfloat16
queries.  Calls over int8 pools count under ``paged_attention[int8]``.

Two routes on the card, chosen by :func:`route` from q's dtype alone:
bfloat16 queries (over bfloat16 pools, or int8 pools with their scales)
run the tensor-core kernel (``mma.sync`` bf16 with float32 sums, each
key walk split over a thread-block cluster; its launch plan is
:func:`tc_plan`); float32 queries (over float32 or int8 pools) run the
float32 walk on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..base import MXTPUError, bump
from .partition import check_head_shard
from . import _build
from .tensor import paged_cache_gather, paged_cache_gather_q8

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "KERNEL_NAME", "KERNEL_NAME_Q8", "check_kernel_geometry", "route",
           "tc_plan", "TENSOR_CORES", "CUDA_CORES"]

KERNEL_NAME = "paged_attention"
KERNEL_NAME_Q8 = "paged_attention[int8]"
_NEG_INF = -1e30
#: shared memory one block may use on an H100 (227 KB; kMaxSmem in
#: csrc/paged_common.cuh)
MAX_SMEM_BYTES = 232448
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_FNS: dict = {}
_TC_FNS: dict = {}
#: the two routes on the card (see :func:`route`)
TENSOR_CORES = "tensor_cores"
CUDA_CORES = "cuda_cores"

# the tensor-core kernel's tiling (csrc/paged_attention.cu): keys a
# staged tile (16 a warp), warps a block, blocks a cluster (the splits of
# one key walk) and ring stages; constants, so that no lane's arithmetic
# depends on W, the lane count, B or pos
TC_KEYS = 64
TC_WARPS = 4
TC_SPLITS = 4
TC_STAGES = 3


def _cdiv(a, b):
    return -(-a // b)


def route(q):
    """The kernel a CUDA call runs, from q's dtype alone: bfloat16
    queries (over bfloat16 or int8 pools) take the tensor cores, float32
    queries (over float32 or int8 pools) the float32 walk on the CUDA
    cores."""
    return TENSOR_CORES if q.dtype == torch.bfloat16 else CUDA_CORES


def tc_depth(D):
    """head_dim's class in the tensor-core kernels: the power of two from
    16 up to 256 that holds D (the staged depth past D is zero)."""
    DP = 16
    while DP < D:
        DP *= 2
    return DP


def _tc_smem(nt, DP, M, quant):
    """Shared memory of one tensor-core block, in bytes, as the kernel
    carves it (``tc_smem_bytes``): the page ids, the group's queries,
    then the larger of the walk's buffers (the ring, and an int8 pool's
    converted rows a warp) and the combine's float32 (m, l, O) of every
    warp and lane and of the block."""
    ld = DP + 8
    stage = (2 * TC_KEYS * (DP + 16) + 2 * TC_KEYS * 4 if quant
             else 2 * TC_KEYS * ld * 2)
    walk = TC_STAGES * stage + (TC_WARPS * 2 * 16 * ld * 2 if quant else 0)
    combine = (TC_WARPS + 1) * 8 * nt * (DP + 2) * 4
    return _cdiv(M, 4) * 16 + 8 * nt * ld * 2 + max(walk, combine)


@functools.lru_cache(maxsize=None)
def tc_plan(lanes, D, M, quant):
    """The tensor-core launch for ``lanes`` = rep*W lanes a kv head: the
    head_dim class ``DP``, ``nt`` n8 lane tiles a group (1, 2 or 4, as
    few as hold the lanes; at most 2 at DP 256; the lanes are MMA
    columns), the lane ``groups`` a kv head, the cluster's ``splits``
    (split s walks key tiles s, s + splits, ...), the ring's ``stages``
    and the shared memory ``smem`` in bytes.  The C launcher recomputes
    it and refuses one that disagrees.  Only the group's width depends
    on the lane count, and it changes no lane's arithmetic.  Callers
    must not modify the returned dict."""
    DP = tc_depth(D)
    tiles = _cdiv(lanes, 8)
    nt = min(4 if DP <= 128 else 2, 1 if tiles == 1 else 2 if tiles == 2
             else 4)
    smem = _tc_smem(nt, DP, M, quant)
    if smem > MAX_SMEM_BYTES:
        raise MXTPUError("paged_decode_attention: head_dim %d with a table "
                         "of %d pages needs more than %d bytes of shared "
                         "memory" % (D, M, MAX_SMEM_BYTES))
    return dict(DP=DP, nt=nt, groups=_cdiv(lanes, 8 * nt), splits=TC_SPLITS,
                stages=TC_STAGES, smem=smem)


def _tc_fn(quant):
    """The tensor-core launch function of the kernel library."""
    fn = _TC_FNS.get(quant)
    if fn is None:
        lib = _build.load("paged_attention")
        fn = getattr(lib, "mxtpu_paged_decode_tc_bf16" + ("_q8" if quant
                                                          else ""))
        fn.argtypes = [ctypes.c_void_p] * (7 + 2 * quant) + [
            ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _TC_FNS[quant] = fn
    return fn


def launch_tc(q, pool_k, pool_v, tables, pos, out, plan, k_scales=None,
              v_scales=None, anc=None):
    """The tensor-core kernel on checked operands into ``out`` by
    ``plan``; raises MXTPUError where the launcher refuses the plan or
    the launch."""
    B, H, W, D = q.shape
    _, KV, bs, _ = pool_k.shape
    M = tables.shape[-1]
    quant = k_scales is not None
    scales = [k_scales.data_ptr(), v_scales.data_ptr()] if quant else []
    rc = _tc_fn(quant)(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *scales,
        tables.data_ptr(), pos.data_ptr(),
        None if anc is None else anc.data_ptr(), out.data_ptr(), B, KV,
        (H // KV) * W, W, D, bs, M, plan["DP"], plan["nt"], plan["groups"],
        plan["splits"], plan["stages"], plan["smem"], 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise MXTPUError("paged_decode_attention: CUDA launch failed "
                         "(cudaError %d; plan %r)" % (rc, plan))


def gather_pages(pool, scales, tables):
    """A table's pages in sequence order as float32: (..., KV, M*bs,
    D), an int8 pool dequantized with its ``scales``."""
    if scales is None:
        return paged_cache_gather(pool, tables).float()
    return paged_cache_gather_q8(pool, scales, tables)


def paged_decode_attention_plain(q, pool_k, pool_v, tables, pos, anc=None,
                                 k_scales=None, v_scales=None):
    """The kernel's plain version: gather every table entry (and
    dequantize an int8 pool, payload times scale), then a masked
    float32 softmax (the math of the reference's ``xla_reference``).
    q (B, H, W, D), pools (N, KV, bs, D), tables (B, M), pos (B,) →
    (B, H, W, D) in q's dtype.  Without ``anc`` lane
    w of slot b attends positions <= pos[b] + w.  With ``anc`` (B, W)
    int32 (tree verify: bit j of anc[b, w] marks window lane j a strict
    ancestor of lane w) lane w attends the committed history
    (< pos[b]), itself, and its ancestors."""
    B, H, W, D = q.shape
    KV = pool_k.shape[1]
    rep = H // KV
    keys = gather_pages(pool_k, k_scales, tables)        # (B, KV, M*bs, D)
    values = gather_pages(pool_v, v_scales, tables)
    qr = q.reshape(B, KV, rep * W, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bkld,bktd->bklt", qr, keys)
    k_pos = torch.arange(keys.shape[2], device=q.device)
    w = torch.arange(rep * W, device=q.device) % W
    base = pos.reshape(-1).long()
    if anc is not None:
        bits = anc.reshape(B, W).long()[:, w]               # (B, lanes)
        rel = k_pos[None, None, :] - base[:, None, None]    # (B, 1, t)
        bit = (bits[:, :, None] >> rel.clamp(0, 31)) & 1
        valid = ((rel < 0) | (rel == w[None, :, None])
                 | ((rel >= 0) & (rel < W) & (bit == 1)))   # (B, l, t)
    else:
        valid = (k_pos[None, None, :]
                 <= base[:, None, None] + w[None, :, None])
    s = torch.where(valid[:, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bklt,bktd->bkld", p, values)
    return o.reshape(B, H, W, D).to(q.dtype)


def check_kernel_geometry(q, pool_k, pool_v, k_scales=None, v_scales=None):
    """Raise for operands the CUDA kernels do not take: q float32 or
    bfloat16; pools and q on one CUDA device, contiguous and 16-byte
    aligned; pools (N, KV, bs, D) of q's dtype, or int8 with float32
    scales (N, KV, bs); D <= 256, D % 8 == 0 (the kernels copy rows 16
    bytes, or 8 int8 values, at a time), bs <= 64, and a head count
    that folds onto the kv heads."""
    if q.dtype not in _DTYPES:
        raise MXTPUError("paged attention kernel: q dtype %s is not "
                         "float32 or bfloat16" % q.dtype)
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise MXTPUError("paged attention kernel: int8 pools need both "
                         "k_scales and v_scales")
    pool_dtype = torch.int8 if quant else q.dtype
    operands = [("pool_k", pool_k, pool_dtype), ("pool_v", pool_v,
                                                 pool_dtype)]
    if quant:
        operands += [("k_scales", k_scales, torch.float32),
                     ("v_scales", v_scales, torch.float32)]
    for name, x, dtype in operands:
        if x.device != q.device:
            raise MXTPUError("paged attention kernel: %s is on %s, q on %s"
                             % (name, x.device, q.device))
        if x.dtype != dtype:
            raise MXTPUError("paged attention kernel: %s dtype %s is not "
                             "%s" % (name, x.dtype, dtype))
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise MXTPUError("paged attention kernel: %s is not contiguous "
                             "and 16-byte aligned" % name)
    if pool_k.shape != pool_v.shape or pool_k.ndim != 4:
        raise MXTPUError("paged attention kernel: pools must both be "
                         "(N, KV, bs, D), got %s and %s"
                         % (tuple(pool_k.shape), tuple(pool_v.shape)))
    if quant and not (k_scales.shape == v_scales.shape
                      == pool_k.shape[:3]):
        raise MXTPUError("paged attention kernel: scales must both be "
                         "(N, KV, bs) = %s, got %s and %s"
                         % (tuple(pool_k.shape[:3]), tuple(k_scales.shape),
                            tuple(v_scales.shape)))
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise MXTPUError("paged attention kernel: q is not contiguous and "
                         "16-byte aligned")
    _, KV, bs, D = pool_k.shape
    if q.shape[-1] != D or q.shape[1] % KV:
        raise MXTPUError("paged attention kernel: q %s does not fold onto "
                         "pools %s" % (tuple(q.shape), tuple(pool_k.shape)))
    if D > 256 or D % 8:
        raise MXTPUError("paged attention kernel: head_dim %d must be a "
                         "multiple of 8 and at most 256" % D)
    if bs > 64:
        raise MXTPUError("paged attention kernel: block_size %d exceeds 64"
                         % bs)


def check_index(name, x, shape, device):
    """Raise unless ``x`` is a contiguous int32 tensor of ``shape`` on
    ``device``."""
    if x.dtype != torch.int32 or x.device != device \
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise MXTPUError(
            "paged attention kernel: %s must be a contiguous int32 %s "
            "tensor on %s, got %s %s on %s"
            % (name, tuple(shape), device, x.dtype, tuple(x.shape),
               x.device))


def kernel_fn(source, prefix, quant, n_ptrs, n_ints, cache):
    """The (launch, stages) C functions of a paged kernel library's
    float32 route for the pool's type (float32 or int8), loaded once into
    ``cache``."""
    fns = cache.get(quant)
    if fns is None:
        lib = _build.load(source)
        fn = getattr(lib, "%s_f32%s" % (prefix, "_q8" if quant else ""))
        fn.argtypes = [ctypes.c_void_p] * (n_ptrs + 2 * quant) + [
            ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stages = getattr(lib, prefix + "_stages")
        stages.argtypes = [ctypes.c_int] * 5
        stages.restype = ctypes.c_int
        fns = cache[quant] = (fn, stages)
    return fns


def paged_decode_attention(q, pool_k, pool_v, tables, pos, k_scales=None,
                           v_scales=None, anc=None):
    """Ragged paged attention over block tables: one decode token, or a
    speculative verify window of W tokens, per slot.

    q : (B, H, W, D) queries, rope applied; head h = kv*rep + r.
    pool_k / pool_v : (N, KV, bs, D) page pools (page 0 = null page):
        float of q's dtype, or int8 payloads with ``k_scales`` /
        ``v_scales`` (N, KV, bs) float32, one scale per head and
        position.
    tables : (B, M) int32 block tables.
    pos : (B,) int32 positions (the position window lane 0 wrote).
    anc : optional (B, W) int32 tree ancestor bitmask (W <= 32; see
        :func:`paged_decode_attention_plain`).

    Returns (B, H, W, D) in q's dtype."""
    B, H, W, D = q.shape
    quant = k_scales is not None
    name = KERNEL_NAME_Q8 if quant else KERNEL_NAME
    check_head_shard("paged_decode_attention", H, pool_k.shape[1])
    if anc is not None and W > 32:
        raise ValueError(
            "paged_decode_attention: K004: tree verify window W=%d exceeds "
            "the 32-lane int32 ancestor bitmask — cap spec_tree at 31 "
            "draft nodes (+ root)" % W)
    if q.device.type == "cpu":
        bump(name)
        return paged_decode_attention_plain(q, pool_k, pool_v, tables, pos,
                                            anc, k_scales, v_scales)
    if q.device.type != "cuda":
        raise MXTPUError("paged_decode_attention: no kernel for device %s"
                         % q.device)
    check_kernel_geometry(q, pool_k, pool_v, k_scales, v_scales)
    _, KV, bs, _ = pool_k.shape
    M = tables.shape[-1]
    check_index("tables", tables, (B, M), q.device)
    check_index("pos", pos, (B,), q.device)
    if anc is not None:
        check_index("anc", anc, (B, W), q.device)
    lanes = (H // KV) * W
    out = torch.empty_like(q)
    if route(q) == TENSOR_CORES:
        launch_tc(q, pool_k, pool_v, tables, pos, out,
                  tc_plan(lanes, D, M, quant), k_scales, v_scales, anc)
        bump(name)
        return out
    fn, stages = kernel_fn("paged_attention", "mxtpu_paged_decode", quant, 8,
                           7, _FNS)
    if not stages(lanes, D, bs, M, pool_k.element_size()):
        raise MXTPUError("paged_decode_attention: D=%d, bs=%d, M=%d need "
                         "more than %d bytes of shared memory"
                         % (D, bs, M, MAX_SMEM_BYTES))
    sm_scale = 1.0 / math.sqrt(D)
    nv = torch.clamp(torch.div(pos + (W - 1), bs, rounding_mode="floor")
                     + 1, 1, M).to(torch.int32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scales = [k_scales.data_ptr(), v_scales.data_ptr()] if quant else []
    rc = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *scales,
            tables.data_ptr(), pos.data_ptr(), nv.data_ptr(),
            0 if anc is None else anc.data_ptr(), out.data_ptr(),
            B, KV, lanes, W, D, bs, M, sm_scale, stream)
    if rc != 0:
        raise MXTPUError("paged_decode_attention: CUDA launch failed "
                         "(cudaError %d)" % rc)
    bump(name)
    return out
