"""G1, the row-invariant projection: the CUDA kernel
``csrc/rows_linear.cu`` and its plain PyTorch version.

``rows_linear(x, weight)`` is ``x @ weight.T`` for a bias-free dense
layer whose rounding of a row does not depend on the row count: the
decode step's 8 rows and a verify window's 8W rows round a shared row
alike, bit for bit.  cuBLAS gives no such promise (it picks a split-K
kernel by the row count), so the decode step and the verify window
(``TransformerLM.step_pages`` / ``verify_pages``) run their six
projections through this wrapper; prefill and training keep
``nn.Linear``.  G1 replaces no Pallas kernel: XLA ran these products on
the TPU.

``rows_norm_linear(x, gamma, weight)`` is G2 fused into G1: the
projection of ``rows_rms_norm(x, gamma)`` (``ops/contrib.py``), the
same bits in one launch, which neither launches the norm nor writes the
normed rows.  The step and the window run their four normed projections
(qkv, gate, up, lm_head) through it.

On a CPU tensor the wrappers run their plain versions
(:func:`rows_linear_plain`, :func:`rows_norm_linear_plain`); on a CUDA
tensor they launch the kernel, or raise for what the kernel does not
take.  Each call adds one to the ``rows_linear`` launch counter
(``mxtpu_torch.base``), and a fused call one to ``rows_norm_linear``
too: it is one G1 launch.

A bfloat16 call is one launch on :func:`plan`: every weight byte is read
once at any M <= 128 rows, and the K splits (:func:`splits`,
:func:`k_ranges`, functions of N and K alone) are added in split order
inside a thread-block cluster, so the wrapper allocates nothing but y.

G3 and G4 are the same kernels reading weight-only quantized weights
(the reference's ``wq_matmul_i8`` and ``wq_matmul_i4``,
``mxtpu/contrib/quantization.py``), one op, :func:`wq_matmul`, which
reads the weight type from the shapes: int8 (N, K) with a float32 scale
a channel (wscale (N,)), or two int4 a byte, (N, K/2), with a float32
scale a channel and group (wscale (N, G)); with ``gamma`` the norm is
fused in, as :func:`rows_norm_linear` fuses it into G1.  The weights
are turned into bf16 in registers, so no float copy of a weight is ever
written; a lane reads its weights of a slice with one wide load, its k
permuted inside its group; int8 scales the whole sum once, int4 each
group's sum (a fresh float32 accumulator, its scales carried into shared
memory with the slice) before adding it in k order, and a bias (float32)
comes after the scale.  Their plain versions (:func:`wq_matmul_i8_plain`,
:func:`wq_matmul_i4_plain`) compute that arithmetic in float32
(:func:`wq_matmul_plain` picks one by the shapes, as :func:`wq_matmul`
picks the kernel).  A call adds one to ``rows_linear_i8`` or
``rows_linear_i4``, and a fused one to ``rows_norm_linear`` too; on a
CUDA tensor it launches the kernel or raises (no dequantized weight, no
library GEMM, no fallback).

:func:`wq_matmul_q8` is G3 with the int8 KV cache's quantizer as its
epilogue (the reference's ``_project_qkv_fused_q8`` in one launch over
the whole qkv weight): the last ``v_cols`` output columns, heads of
``head_dim``, leave the launch as an int8 payload and a float32 scale a
row and head, with the bits of ``ops/tensor.py:_q8_quantize`` applied to
the rounded G3 output, so a quantized V never passes through a float
tensor of its own.  The K splits, the k order and the split sums are
G3's plan for the whole N, so the other columns are G3's bits too.  A
head spans several N tiles (64 columns at 8 and 32 rows, and the wider
tiles of the larger classes start mid-head): each block that wrote a
column of a head arrives on a counter of the head after a fence, and
the last to arrive reads the head's rounded values back from L2 and
quantizes them.  The counters live in a zeroed int32 buffer a device,
which each launch leaves zero, so calls on one device run on one
stream at a time.  A call adds one to ``rows_linear_i8`` and
``rows_linear_i8_q8`` (and, with the fused norm, ``rows_norm_linear``
and ``rows_norm_linear_i8_q8``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from ..base import MXTPUError, bump
from . import _build
from .contrib import rms_norm
from .tensor import _q8_quantize

__all__ = ["rows_linear", "rows_linear_plain", "rows_norm_linear",
           "rows_norm_linear_plain", "wq_matmul", "wq_matmul_plain",
           "wq_matmul_i8_plain",
           "wq_matmul_i4_plain", "unpack_int4_torch", "plan", "splits",
           "k_ranges", "scale_area", "wq_matmul_q8", "wq_matmul_q8_plain",
           "KERNEL_NAME", "NORM_KERNEL_NAME", "I8_KERNEL_NAME",
           "I4_KERNEL_NAME", "Q8_KERNEL_NAME", "NORM_Q8_KERNEL_NAME"]

KERNEL_NAME = "rows_linear"
NORM_KERNEL_NAME = "rows_norm_linear"
I8_KERNEL_NAME = "rows_linear_i8"
I4_KERNEL_NAME = "rows_linear_i4"
Q8_KERNEL_NAME = "rows_linear_i8_q8"
NORM_Q8_KERNEL_NAME = "rows_norm_linear_i8_q8"
#: the kernels' weight types (csrc/rows_linear.cu's WT)
_WTYPES = {"bf16": 0, "int8": 1, "int4": 2}
_FNS: dict = {}

# the bf16 kernel's tiling (csrc/rows_linear.cu): x rows a block holds,
# the splits' limits and aim, the K slice, the head of the shared memory
# (mbarriers and the ring's 1024-byte alignment), the partial tile's row
# padding, and one block's shared-memory limit on the H100
_CHUNK = 128
_MAX_SPLITS = 4
_SPLIT_TARGET = 264
_MIN_SPLIT_STEPS = 16
_BK = 64
_HEAD = 2048
_PART_PAD = 4
_GAIN_SLOT = _BK * 4     # the fused norm's gains of one slice, a stage
_NORM_WARPS = 2          # the fused norm's normalizing warps above 8 rows
MAX_SMEM_BYTES = 232448
#: row classes (the kernel's class tables): (rows a block holds, 16-column A
#: tiles a computing warp, 8-row B groups a computing warp, computing
#: warps across the rows, ring stages); 4 computing warps across the N
#: tile of 64 * (A tiles a warp) columns, and one producer warp.  bf16's
#: 128 rows take 256-column tiles, or 192 (the last class) where that
#: grid fits one wave: _ONE_WAVE blocks, 30 clusters of 4 at one block an
#: SM on the H100.
#: The quantized forms' classes keep their accumulators (int4: two sets)
#: in registers with no spill; int8's 128 rows take 128 columns, or 192
#: as bf16's do; int4 has no 128-row class: above 64 rows its 64-row
#: blocks walk the rows in chunks.
_CLASSES = {
    "bf16": ((8, 1, 1, 1, 4), (32, 1, 4, 1, 4), (64, 2, 8, 1, 3),
             (128, 4, 8, 2, 4), (128, 3, 8, 2, 5)),
    "int8": ((8, 1, 1, 1, 8), (32, 1, 4, 1, 6), (64, 2, 8, 1, 4),
             (128, 2, 8, 2, 8), (128, 3, 8, 2, 7)),
    "int4": ((8, 1, 1, 1, 8), (32, 1, 4, 1, 8), (64, 1, 8, 1, 6))}
#: bytes of a weight row's 64-deep slice in a ring stage
_WROW = {"bf16": 128, "int8": 64, "int4": 32}
#: int4's scale slots a stage (the groups that end in its slice: at most
#: 4, gs >= 16), each a float32 scale a column of the tile
_SCALE_SLOTS = {"bf16": 0, "int8": 0, "int4": 4}
#: int4's scale area, at most: in the classes of up to 32 rows, a block's
#: scales of its whole split (the split's groups a multiple of 4), loaded
#: by one TMA box
_SCALE_AREA = 16384
_ONE_WAVE = 120


def _cdiv(a, b):
    return -(-a // b)


def splits(N, K):
    """K splits of a bfloat16 (N, K) weight, from N and K alone: doubled
    while the grid of 64-column tiles holds fewer than 264 blocks (two
    an SM on the H100's 132) and each split keeps 16 k16 steps, at most
    4 (one thread-block cluster: clusters of 8 fit 15 or 30 at a time on
    the H100, and a grid a few clusters past that ran a second wave)."""
    tiles, steps = _cdiv(N, 64), _cdiv(K, 16)
    s = 1
    while s < _MAX_SPLITS and tiles * s < _SPLIT_TARGET \
            and steps >= 2 * s * _MIN_SPLIT_STEPS:
        s *= 2
    return s


def wt_splits(N, K, wtype="bf16", group_size=0):
    """The K splits of weight type ``wtype``: :func:`splits` for bf16 and
    int8; for int4 it is halved while it exceeds the K / group_size
    groups, since an int4 split covers whole groups."""
    s = splits(N, K)
    if wtype == "int4":
        while s > K // group_size:
            s //= 2
    return s


def k_ranges(N, K, wtype="bf16", group_size=0):
    """[(k0, k1), ...]: the K range each split walks, in split order (the
    kernel's ``k_span``: bf16 whole k16 steps but the last, int8 whole
    64-deep slices but the last, int4 whole groups of ``group_size``)."""
    S = wt_splits(N, K, wtype, group_size)
    if wtype == "int4":
        G = K // group_size
        return [(group_size * (s * G // S), group_size * ((s + 1) * G // S))
                for s in range(S)]
    unit = _BK if wtype == "int8" else 16
    steps = _cdiv(K, unit)
    return [(min(unit * (s * steps // S), K),
             min(unit * ((s + 1) * steps // S), K)) for s in range(S)]


def scale_area(N, K, wtype="bf16", group_size=0, bn=64, rows=8):
    """Bytes of int4's scale area for an N tile of ``bn`` columns in a
    class of ``rows`` rows: up to 32 rows, the tile's scales of one
    split's groups where those are a multiple of 4 and fit 16 KiB, else
    0 (each slice's scales are then copied into its stage)."""
    if wtype != "int4" or rows > 32:
        return 0
    G, S = K // group_size, wt_splits(N, K, wtype, group_size)
    if G % (4 * S):
        return 0
    b = bn * (G // S) * 4
    return b if b <= _SCALE_AREA else 0


@functools.lru_cache(maxsize=None)
def plan(M, N, K, norm=False, wtype="bf16", group_size=0):
    """The bfloat16 launch for M >= 1 rows (the C launcher recomputes it
    and refuses a plan that disagrees): the row class ``rows`` (8, 32,
    64 or 128: the x rows one block holds; ``chunks`` of them cover M),
    the N tile ``bn`` (wider as the rows grow, so x's re-reads from L2
    stay under the weights' bytes; at 128 rows 192 columns where that
    grid fits one wave, else 256), ``splits`` (a function of N and K
    alone), the K slice ``bk``, the ring's ``stages``, the ``threads``
    (the computing warps and one producer warp; with ``norm``, the fused
    norm's, two normalizing warps more above 8 rows) and the shared
    memory ``smem`` in bytes (with ``norm``, a slot of gains a stage
    more).  ``wtype`` ("bf16", "int8"
    or "int4" with ``group_size``) picks the class table (G3's and G4's:
    int4's largest holds 64 rows, and more rows take 64-row chunks) and
    the weight bytes of a stage (int4's with its scale slots, and its
    :func:`scale_area`); the splits are :func:`wt_splits`.  Only the N tile and the ring depend
    on M; no element's arithmetic does.  Callers must not modify the
    returned dict."""
    classes = _CLASSES[wtype]
    by_rows = min(4, len(classes))
    c = next((i for i in range(by_rows) if classes[i][0] >= min(M, _CHUNK)),
             by_rows - 1)
    if c == 3 and len(classes) > 4 \
            and _cdiv(N, 192) * wt_splits(N, K, wtype) <= _ONE_WAVE:
        c = 4
    rows, cw, _, warp_rows, stages = classes[c]
    bn = 64 * cw
    stage = bn * _WROW[wtype] + rows * _BK * 2 + _SCALE_SLOTS[wtype] * bn * 4
    smem = _HEAD + max(stages * stage, rows * (bn + _PART_PAD) * 4) \
        + (stages * _GAIN_SLOT if norm else 0) \
        + scale_area(N, K, wtype, group_size, bn, rows)
    warps = 4 * warp_rows + 1 + (_NORM_WARPS if norm and rows > 8 else 0)
    return dict(rows=rows, chunks=_cdiv(M, rows), bn=bn, tiles=_cdiv(N, bn),
                splits=wt_splits(N, K, wtype, group_size), bk=_BK,
                stages=stages, threads=32 * warps, smem=smem)


def rows_linear_plain(x, weight):
    """The kernel's plain version: ``F.linear(x, weight)``."""
    return F.linear(x, weight)


def rows_norm_linear_plain(x, gamma, weight, eps=1e-6):
    """The fused kernel's plain version: ``F.linear`` of ``rms_norm``."""
    return rows_linear_plain(rms_norm(x, gamma, eps), weight)


def _fns():
    if not _FNS:
        lib = _build.load("rows_linear")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fns = dict(bf16=(lib.mxtpu_rows_linear_bf16,
                         [vp] * 3 + [i] * 7 + [vp]),
                   f32=(lib.mxtpu_rows_linear_f32, [vp] * 3 + [i] * 3 + [vp]),
                   norm_bf16=(lib.mxtpu_rows_norm_linear_bf16,
                              [vp] * 4 + [i] * 4 + [f] + [i] * 4 + [vp]),
                   norm_f32=(lib.mxtpu_rows_norm_linear_f32,
                             [vp] * 4 + [i] * 3 + [f, vp]),
                   q_bf16=(lib.mxtpu_rows_linear_q_bf16,
                           [vp] * 6 + [i] * 5 + [f] + [i] * 4 + [vp]),
                   q_f32=(lib.mxtpu_rows_linear_q_f32,
                          [vp] * 6 + [i] * 5 + [f, vp]),
                   q8_bf16=(lib.mxtpu_rows_linear_q8_bf16,
                            [vp] * 9 + [i] * 5 + [f] + [i] * 4 + [vp]),
                   q8_f32=(lib.mxtpu_rows_linear_q8_f32,
                           [vp] * 9 + [i] * 5 + [f, vp]))
        for name, (fn, argtypes) in fns.items():
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn
    return _FNS


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_bf16(x2, weight, y, p):
    """The bf16 kernel on (M, K) rows x2 into y (M, N) by plan ``p``;
    raises MXTPUError where the launcher refuses the plan or the
    launch."""
    (M, K), N = x2.shape, weight.shape[0]
    rc = _fns()["bf16"](
        x2.data_ptr(), weight.data_ptr(), y.data_ptr(), M, N, K, p["bn"],
        p["splits"], p["stages"], p["smem"], _stream(x2))
    if rc != 0:
        raise MXTPUError("rows_linear: CUDA launch failed (cudaError %d; "
                         "plan %r)" % (rc, p))


def _operands(name, x, weight):
    """x as (M, K) contiguous rows, checked against weight (N, K) as the
    kernels take them; raises MXTPUError for what they do not take."""
    N, K = weight.shape
    if x.shape[-1] != K:
        raise MXTPUError("%s: x %s does not match weight %s"
                         % (name, tuple(x.shape), tuple(weight.shape)))
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or weight.dtype != x.dtype or weight.device != x.device:
        raise MXTPUError("%s: x (%s on %s) and weight (%s on %s) must share "
                         "a dtype, float32 or bfloat16, and a device"
                         % (name, x.dtype, x.device, weight.dtype,
                            weight.device))
    x2 = x.reshape(-1, K).contiguous()
    if not weight.is_contiguous():
        raise MXTPUError("%s: weight must be contiguous" % name)
    if x.dtype == torch.bfloat16 and (K % 8 or weight.data_ptr() % 16
                                      or x2.data_ptr() % 16):
        raise MXTPUError("%s: bfloat16 needs K %% 8 == 0 (got %d) and "
                         "16-byte aligned x and weight" % (name, K))
    return x2


def rows_linear(x, weight):
    """y = x @ weight.T, x (..., K), weight (N, K) → (..., N) in x's
    dtype, each row rounded independently of the others (see the
    module docstring).  float32 or bfloat16; on the card x and weight
    share a dtype, and bfloat16 needs K % 8 == 0."""
    if x.device.type == "cpu":
        bump(KERNEL_NAME)
        return rows_linear_plain(x, weight)
    if x.device.type != "cuda":
        raise MXTPUError("rows_linear: no kernel for device %s" % x.device)
    x2 = _operands("rows_linear", x, weight)
    (M, K), N = x2.shape, weight.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(x.shape[:-1] + (N,))
    if x.dtype == torch.bfloat16:
        _launch_bf16(x2, weight, y, plan(M, N, K))
    else:
        rc = _fns()["f32"](x2.data_ptr(), weight.data_ptr(), y.data_ptr(), M,
                           N, K, _stream(x2))
        if rc != 0:
            raise MXTPUError("rows_linear: CUDA launch failed (cudaError %d)"
                             % rc)
    bump(KERNEL_NAME)
    return y.reshape(x.shape[:-1] + (N,))


def rows_norm_linear(x, gamma, weight, eps=1e-6):
    """``rows_linear(rows_rms_norm(x, gamma, eps), weight)`` in one
    launch, bit for bit: x (..., K), gamma (K,), weight (N, K) → (...,
    N) in x's dtype.  The operands as :func:`rows_linear` takes them;
    on the card gamma is contiguous, 16-byte aligned, on x's device, and
    float32 or x's dtype."""
    if x.device.type == "cpu":
        bump(KERNEL_NAME)
        bump(NORM_KERNEL_NAME)
        return rows_norm_linear_plain(x, gamma, weight, eps)
    if x.device.type != "cuda":
        raise MXTPUError("rows_norm_linear: no kernel for device %s"
                         % x.device)
    x2 = _operands("rows_norm_linear", x, weight)
    (M, K), N = x2.shape, weight.shape[0]
    if gamma.shape != (K,) or gamma.device != x.device \
            or gamma.dtype not in (torch.float32, x.dtype) \
            or not gamma.is_contiguous() or gamma.data_ptr() % 16:
        raise MXTPUError("rows_norm_linear: gamma (%s, %s on %s) must be a "
                         "contiguous, 16-byte aligned (%d,) of float32 or "
                         "%s on %s" % (tuple(gamma.shape), gamma.dtype,
                                       gamma.device, K, x.dtype, x.device))
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(x.shape[:-1] + (N,))
    if x.dtype == torch.bfloat16:
        p = plan(M, N, K, norm=True)
        rc = _fns()["norm_bf16"](
            x2.data_ptr(), gamma.data_ptr(), weight.data_ptr(), y.data_ptr(),
            int(gamma.dtype == torch.float32), M, N, K, float(eps), p["bn"],
            p["splits"], p["stages"], p["smem"], _stream(x2))
    else:
        p = None
        rc = _fns()["norm_f32"](
            x2.data_ptr(), gamma.data_ptr(), weight.data_ptr(), y.data_ptr(),
            M, N, K, float(eps), _stream(x2))
    if rc != 0:
        raise MXTPUError("rows_norm_linear: CUDA launch failed (cudaError "
                         "%d; plan %r)" % (rc, p))
    bump(KERNEL_NAME)
    bump(NORM_KERNEL_NAME)
    return y.reshape(x.shape[:-1] + (N,))


# -- G3 and G4: weight-only int8 and int4 --------------------------------

def unpack_int4_torch(packed):
    """(O, I/2) int8 bytes of two int4 values each (k even in the low
    nibble, the reference's ``pack_int4`` layout) → (O, I) int8 values,
    each nibble sign-extended."""
    b = packed.to(torch.int16)
    lo = ((b & 0xF) ^ 8) - 8
    hi = b >> 4
    return torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],)).to(torch.int8)


def wq_matmul_i8_plain(x, qweight, wscale, bias=None):
    """G3's plain version, the reference's ``wq_matmul_i8`` arithmetic:
    ``(x @ q^T) * s`` in float32 (+ bias after the scale), rounded once
    to x's dtype; x (..., K), qweight (N, K) int8, wscale (N,)."""
    out = torch.matmul(x.float(), qweight.float().t()) * wscale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def wq_matmul_i4_plain(x, qweight, wscale, group_size, in_units=0,
                       bias=None):
    """G4's plain version, the reference's ``wq_matmul_i4`` arithmetic:
    the sum over input groups g, in k order, of ``(x_g @ w_g^T) *
    s[:, g]`` in float32 (+ bias), rounded once to x's dtype; qweight
    (N, K/2) packed int4, wscale (N, K / group_size)."""
    N = qweight.shape[0]
    K = int(in_units) or 2 * qweight.shape[1]
    gs = int(group_size) or K
    G = K // gs
    lead = x.shape[:-1]
    xg = x.float().reshape(-1, G, gs).transpose(0, 1)          # (G, M, gs)
    wg = unpack_int4_torch(qweight).float().reshape(N, G, gs).permute(1, 2, 0)
    parts = torch.bmm(xg, wg) * wscale.float().t()[:, None, :]  # (G, M, N)
    out = parts[0]
    for g in range(1, G):
        out = out + parts[g]
    if bias is not None:
        out = out + bias.float()
    return out.reshape(lead + (N,)).to(x.dtype)


def _check_cuda(name, x2, t, what, shape, dtype):
    if t.shape != shape or t.dtype != dtype or t.device != x2.device \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise MXTPUError("%s: %s (%s, %s on %s) must be a contiguous, "
                         "16-byte aligned %s of %s on %s"
                         % (name, what, tuple(t.shape), t.dtype, t.device,
                            shape, dtype, x2.device))


def _wq_type(x, qweight, wscale):
    """("int8", 0) or ("int4", group size), read from the shapes."""
    K = x.shape[-1]
    if qweight.dim() == 2 and wscale.shape[0] == qweight.shape[0]:
        if wscale.dim() == 1 and qweight.shape[1] == K:
            return "int8", 0
        if wscale.dim() == 2 and 2 * qweight.shape[1] == K \
                and K % wscale.shape[1] == 0:
            return "int4", K // wscale.shape[1]
    raise MXTPUError("wq_matmul: weight %s and scales %s do not fit x %s"
                     % (tuple(qweight.shape), tuple(wscale.shape),
                        tuple(x.shape)))


def wq_matmul_plain(x, qweight, wscale, gamma=None, bias=None, eps=1e-6):
    """:func:`wq_matmul`'s plain version: ``rms_norm(x, gamma, eps)``
    first unless gamma is None, then :func:`wq_matmul_i8_plain` or
    :func:`wq_matmul_i4_plain` by the shapes."""
    wtype, gs = _wq_type(x, qweight, wscale)
    if gamma is not None:
        x = rms_norm(x, gamma, eps)
    if wtype == "int8":
        return wq_matmul_i8_plain(x, qweight, wscale, bias)
    return wq_matmul_i4_plain(x, qweight, wscale, gs, x.shape[-1], bias)


def wq_matmul(x, qweight, wscale, gamma=None, bias=None, eps=1e-6):
    """G3 or G4: the weight-only quantized projection of x (..., K),
    float32 or bfloat16, normalized first by ``rows_rms_norm(x, gamma,
    eps)`` in the same launch unless ``gamma`` is None (bit for bit G2
    then the op; gamma (K,) of x's dtype).  The weight type follows from
    the shapes:

    - G3, int8: qweight (N, K) int8, wscale (N,) float32; y = (x @
      qweight^T) * wscale.
    - G4, int4: qweight (N, K/2) two int4 a byte (k even low), wscale (N,
      G) float32 for groups of K / G; y = the sum over groups g, in k
      order, of (x_g @ w_g^T) * wscale[:, g].

    A bias (N,) float32 comes after the scale; y (..., N) is in x's
    dtype, each row rounded independently of the others.  On the card
    the group size is a multiple of 16, and bfloat16 needs K a multiple
    of 16 (int8) or 32 (int4).  A call adds one to ``rows_linear_i8`` or
    ``rows_linear_i4``, and with ``gamma`` to ``rows_norm_linear``."""
    K = x.shape[-1]
    N = qweight.shape[0]
    wtype, gs = _wq_type(x, qweight, wscale)
    counter = I8_KERNEL_NAME if wtype == "int8" else I4_KERNEL_NAME
    if x.device.type == "cpu":
        bump(counter)
        if gamma is not None:
            bump(NORM_KERNEL_NAME)
        return wq_matmul_plain(x, qweight, wscale, gamma, bias, eps)
    name = "wq_matmul"
    if x.device.type != "cuda":
        raise MXTPUError("%s: no kernel for device %s" % (name, x.device))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise MXTPUError("%s: x must be float32 or bfloat16, not %s"
                         % (name, x.dtype))
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    _check_cuda(name, x2, qweight, "qweight", tuple(qweight.shape),
                torch.int8)
    _check_cuda(name, x2, wscale, "wscale", tuple(wscale.shape),
                torch.float32)
    if bias is not None:
        _check_cuda(name, x2, bias, "bias", (N,), torch.float32)
    if gamma is not None:
        _check_cuda(name, x2, gamma, "gamma", (K,), x.dtype)
    if wtype == "int4" and gs % 16:
        raise MXTPUError("%s: the kernel takes a group size that is a "
                         "multiple of 16 (got %d)" % (name, gs))
    if x.dtype == torch.bfloat16 and (
            x2.data_ptr() % 16 or (K % 32 if wtype == "int4" else K % 16)):
        raise MXTPUError("%s: bfloat16 needs a 16-byte aligned x and K a "
                         "multiple of %d (got %d)"
                         % (name, 32 if wtype == "int4" else 16, K))
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(x.shape[:-1] + (N,))
    ptrs = (x2.data_ptr(), None if gamma is None else gamma.data_ptr(),
            qweight.data_ptr(), wscale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            _WTYPES[wtype], gs, M, N, K, float(eps))
    p = None
    if x.dtype == torch.bfloat16:
        p = plan(M, N, K, gamma is not None, wtype, gs)
        rc = _fns()["q_bf16"](*ptrs, p["bn"], p["splits"], p["stages"],
                              p["smem"], _stream(x2))
    else:
        rc = _fns()["q_f32"](*ptrs, _stream(x2))
    if rc != 0:
        raise MXTPUError("%s: CUDA launch failed (cudaError %d; plan %r)"
                         % (name, rc, p))
    bump(counter)
    if gamma is not None:
        bump(NORM_KERNEL_NAME)
    return y.reshape(x.shape[:-1] + (N,))


# -- G3 with the q8 epilogue ---------------------------------------------

_Q8_COUNTERS: dict = {}


def _q8_counters(device, n):
    """The epilogue's arrival counters on ``device``: at least ``n``
    zeroed int32, which every launch leaves zero."""
    buf = _Q8_COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _Q8_COUNTERS[device] = buf
    return buf


def wq_matmul_q8_plain(x, qweight, wscale, head_dim, v_cols, gamma=None,
                       bias=None, eps=1e-6):
    """:func:`wq_matmul_q8`'s plain version: :func:`wq_matmul_plain`,
    then ``_q8_quantize`` on each head of the last ``v_cols`` columns."""
    y = wq_matmul_plain(x, qweight, wscale, gamma, bias, eps)
    N = y.shape[-1]
    lead = y.shape[:-1]
    q, s = _q8_quantize(y[..., N - v_cols:].reshape(
        lead + (v_cols // head_dim, head_dim)))
    return y[..., :N - v_cols], q.reshape(lead + (v_cols,)), s


def wq_matmul_q8(x, qweight, wscale, head_dim, v_cols, gamma=None,
                 bias=None, eps=1e-6):
    """G3 with the q8 epilogue (module docstring), heads of ``head_dim``
    <= 256: x (..., K), float32 or
    bfloat16, qweight (N, K) int8, wscale (N,) float32, normalized first
    by ``gamma`` in the same launch unless it is None, as
    :func:`wq_matmul` takes them.  Returns (y (..., N - v_cols) in x's
    dtype, a view of G3's first columns; the payload (..., v_cols) int8;
    the scales (..., v_cols / head_dim) float32), the bits of
    :func:`wq_matmul` followed by ``_q8_quantize`` on each head of its
    last ``v_cols`` columns."""
    K = x.shape[-1]
    N = qweight.shape[0]
    if _wq_type(x, qweight, wscale)[0] != "int8" or not 1 <= head_dim <= 256 \
            or v_cols < head_dim or v_cols % head_dim or v_cols > N:
        raise MXTPUError("wq_matmul_q8: an int8 weight %s with %d V columns "
                         "in heads of %d (at most 256)"
                         % (tuple(qweight.shape), v_cols, head_dim))
    bumps = [I8_KERNEL_NAME, Q8_KERNEL_NAME] + (
        [] if gamma is None else [NORM_KERNEL_NAME, NORM_Q8_KERNEL_NAME])
    if x.device.type == "cpu":
        for name in bumps:
            bump(name)
        return wq_matmul_q8_plain(x, qweight, wscale, head_dim, v_cols,
                                  gamma, bias, eps)
    name = "wq_matmul_q8"
    if x.device.type != "cuda":
        raise MXTPUError("%s: no kernel for device %s" % (name, x.device))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise MXTPUError("%s: x must be float32 or bfloat16, not %s"
                         % (name, x.dtype))
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    _check_cuda(name, x2, qweight, "qweight", (N, K), torch.int8)
    _check_cuda(name, x2, wscale, "wscale", (N,), torch.float32)
    if bias is not None:
        _check_cuda(name, x2, bias, "bias", (N,), torch.float32)
    if gamma is not None:
        _check_cuda(name, x2, gamma, "gamma", (K,), x.dtype)
    if x.dtype == torch.bfloat16 and (x2.data_ptr() % 16 or K % 16):
        raise MXTPUError("%s: bfloat16 needs a 16-byte aligned x and K a "
                         "multiple of 16 (got %d)" % (name, K))
    lead = x.shape[:-1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    vq = torch.empty((M, v_cols), dtype=torch.int8, device=x.device)
    vs = torch.empty((M, v_cols // head_dim), dtype=torch.float32,
                     device=x.device)
    if M:
        ptrs = (x2.data_ptr(), None if gamma is None else gamma.data_ptr(),
                qweight.data_ptr(), wscale.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(),
                vq.data_ptr(), vs.data_ptr())
        p = None
        if x.dtype == torch.bfloat16:
            p = plan(M, N, K, gamma is not None, "int8")
            ctr = _q8_counters(x.device, p["chunks"] * (v_cols // head_dim))
            rc = _fns()["q8_bf16"](
                *ptrs, ctr.data_ptr(), v_cols, head_dim, M, N, K, float(eps),
                p["bn"], p["splits"], p["stages"], p["smem"], _stream(x2))
        else:
            ctr = _q8_counters(x.device, _cdiv(M, 32) * (v_cols // head_dim))
            rc = _fns()["q8_f32"](*ptrs, ctr.data_ptr(), v_cols, head_dim,
                                  M, N, K, float(eps), _stream(x2))
        if rc != 0:
            raise MXTPUError("%s: CUDA launch failed (cudaError %d; plan %r)"
                             % (name, rc, p))
    for n in bumps:
        bump(n)
    return (y[:, :N - v_cols].reshape(lead + (N - v_cols,)),
            vq.reshape(lead + (v_cols,)),
            vs.reshape(lead + (v_cols // head_dim,)))
