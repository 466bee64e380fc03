"""The int8 x int8 products of post-training quantization: Q1, the
convolution, and Q2, the fully-connected product, and Q3, the activation
quantizer that writes Q1's input (``csrc/quantized.cu``), each beside its
plain PyTorch version.

Q1 and Q2 take int8 operands, sum their products in int32 and return
float32 ``acc * scale (+ bias)``, where ``scale`` is one float32 value
on the operands' device (the product of the input's and the weights'
scales, ``contrib/quantization.py:quantized_conv``).  None of them
replaces a ``pallas_call``: the reference's ``quantize_v2``,
``quantized_conv`` and ``quantized_fully_connected``
(``mxtpu/contrib/quantization.py:42``, ``:81``, ``:62``) run as XLA's
elementwise ops and its int8 ``conv_general_dilated`` and
``dot_general`` with int32 sums.

- :func:`qconv` (Q1): x (N, C, H, W) int8, w (C_out, C / groups, kh, kw)
  int8, 2-D stride, padding, dilation and groups; out (N, C_out, OH, OW)
  float32, NCHW.  Three kernels, chosen by x's layout and channels
  (:func:`route`): a channels-last x whose channels a group are a
  multiple of 16 goes to ``qconv_nhwc_kernel`` (16-byte copies of a
  pixel's channels, tiles by :func:`_plan`); an NCHW-contiguous x of at
  most 4 channels a group (the RGB, RGBA and grey stems, any kernel
  size, stride, padding and dilation whose one-pixel window and weights
  fit a block's shared memory: :func:`_stem_smem`) to
  ``qconv_stem_kernel`` (the input patch of whole output rows staged
  once, a word a pixel, tiles by :func:`_plan_stem`); any other
  NCHW-contiguous x to ``qconv_kernel`` (a byte gather); on the card any
  other x raises.  The kernels read the weights as (C_out, K padded to
  32) rows (:func:`pack_weight`: OHWI order for the channels-last
  kernel, (r, s padded to 8, c padded to 4) for the stem's, OIHW for
  the other); a quantized layer keeps them so and passes ``packed``,
  else each call packs them.
- :func:`qfc` (Q2): x (M, K) and w (N, K) int8; out (M, N) float32.
  The kernel reads both with K padded to 32 (:func:`pack_weight`; zeros
  add nothing to the sums), a view where K already is a multiple; K is
  split over a thread-block cluster as :func:`_plan_fc` says.
- :func:`quantize_nhwc` (Q3): float32 x (N, C, H, W), NCHW-contiguous,
  C a multiple of 16, and the 0-dim float32 scale on x's device: the
  reference's ``clip(round(x / s), -127, 127)`` as int8 (N, C, H, W)
  stored channels-last, in one pass.

The plain versions (:func:`qconv_plain`, :func:`qfc_plain`) take the
product (:func:`qconv_sums`, :func:`qfc_sums`) in float64 on the int8
values and cast it to int32, which is exact on either device (|products|
<= 127^2, and ResNet-50's largest sum, 4608 * 127^2 ~ 7.4e7, is far
below 2^53; PyTorch has no int32 convolution on CUDA), then apply the
same epilogue as separate torch ops: ``acc.float() * scale``, then ``+
bias``.  The kernels round each step once too (no FMA), so a kernel
equals its plain version bit for bit, in any layout of x.
:func:`quantize_nhwc_plain` is the reference's chain in torch ops, then
the channels-last copy.

Each wrapper runs the plain version on a CPU tensor and, on a CUDA
tensor, launches its kernel or raises :class:`MXTPUError`; it adds one
to its counter per call: ``qconv`` for every Q1 call, and ``qconv_nhwc``
or ``qconv_stem`` too for one on the channels-last or the stem's route,
``qfc``, ``quantize_nhwc``.  Nothing builds at import.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..base import MXTPUError, bump
from . import _build

__all__ = ["QCONV", "QCONV_NHWC", "QCONV_STEM", "QFC", "QUANTIZE_NHWC",
           "pack_weight", "conv_out_size", "route", "qconv_sums", "qfc_sums",
           "qconv_plain", "qconv", "qfc_plain", "qfc", "quantize_nhwc_plain",
           "quantize_nhwc"]

QCONV, QCONV_NHWC, QCONV_STEM, QFC = "qconv", "qconv_nhwc", "qconv_stem", \
    "qfc"
QUANTIZE_NHWC = "quantize_nhwc"
_FNS: dict = {}
#: the kernel's K step is 64 bytes, over rows padded to 32
_KPAD = 32


def _lib():
    """The loaded kernel library, entry points typed (built at the first
    launch, never at import)."""
    lib = _FNS.get("lib")
    if lib is None:
        lib = _build.load("quantized")
        lib.mxtpu_qconv.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 18 + [ctypes.c_void_p]
        lib.mxtpu_qconv.restype = ctypes.c_int
        lib.mxtpu_qconv_stem.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 19 + [ctypes.c_void_p]
        lib.mxtpu_qconv_stem.restype = ctypes.c_int
        lib.mxtpu_qfc.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.mxtpu_qfc.restype = ctypes.c_int
        lib.mxtpu_empty.argtypes = [ctypes.c_void_p]
        lib.mxtpu_empty.restype = ctypes.c_int
        lib.mxtpu_qconv_nhwc.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 19 + [ctypes.c_void_p]
        lib.mxtpu_qconv_nhwc.restype = ctypes.c_int
        lib.mxtpu_quantize_nhwc.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.mxtpu_quantize_nhwc.restype = ctypes.c_int
        _FNS["lib"] = lib
    return lib


def pack_weight(w, channels_last=False, stem=False):
    """int8 rows as Q1 and Q2 read them: (rows, K), zero-padded to a
    multiple of 32 bytes and 16-byte aligned (a view of ``w`` where it
    already is so).  For OIHW weights a row is an output channel, K = C_in
    / groups * kh * kw in (c, r, s) order, or with ``channels_last`` in
    (r, s, c) order (OHWI, as Q1's channels-last kernel reads them), or
    with ``stem`` in (r, s, c) order with s padded to a multiple of 8 taps
    and c to 4 channels, zeros there (K = kh * 32 * ceil(kw / 8), as the
    stem's kernel reads them: one 32-byte product step is 8 taps of a
    kernel row); for Q2's (M, K) or (N, K) operands a row is a row."""
    Co = w.shape[0]
    if stem:
        _, Cg, KH, KW = w.shape
        out = torch.zeros((Co, KH, -(-KW // 8) * 8, 4), dtype=w.dtype,
                          device=w.device)
        out[:, :, :KW, :Cg] = w.permute(0, 2, 3, 1)
        return out.reshape(Co, -1)
    if channels_last and w.dim() == 4:
        w = w.permute(0, 2, 3, 1)
    flat = w.reshape(Co, -1)
    K = flat.shape[1]
    Kp = -(-K // _KPAD) * _KPAD
    if Kp == K and flat.is_contiguous() and flat.data_ptr() % 16 == 0:
        return flat
    out = torch.zeros((Co, Kp), dtype=w.dtype, device=w.device)
    out[:, :K] = flat
    return out


def conv_out_size(size, k, stride, pad, dilate):
    """Output length of one spatial axis (floor sizing)."""
    return (size + 2 * pad - dilate * (k - 1) - 1) // stride + 1


def qconv_sums(x, w, stride=(1, 1), pad=(0, 0), dilate=(1, 1), groups=1):
    """Q1's int32 sums, plainly: the float64 convolution of the int8
    values (x in NCHW order, whatever its layout), cast to int32 (exact),
    NCHW as the kernels write it."""
    return F.conv2d(x.double().contiguous(), w.double(),
                    stride=tuple(stride),
                    padding=tuple(pad), dilation=tuple(dilate),
                    groups=groups).to(torch.int32)


def qfc_sums(x, w):
    """Q2's int32 sums, plainly: the float64 product of the int8 values,
    cast to int32 (exact)."""
    return torch.matmul(x.double(), w.double().t()).to(torch.int32)


def _epilogue(acc, scale, bias, shape):
    out = acc.float() * scale
    return out if bias is None else out + bias.reshape(shape)


def qconv_plain(x, w, scale, bias=None, stride=(1, 1), pad=(0, 0),
                dilate=(1, 1), groups=1):
    """Q1's plain version: its sums (:func:`qconv_sums`) times ``scale``,
    plus ``bias`` per channel."""
    return _epilogue(qconv_sums(x, w, stride, pad, dilate, groups), scale,
                     bias, (1, -1, 1, 1))


def qfc_plain(x, w, scale, bias=None):
    """Q2's plain version: its sums (:func:`qfc_sums`) times ``scale``,
    plus ``bias``."""
    return _epilogue(qfc_sums(x, w), scale, bias, (-1,))


def _check_epilogue(name, x, scale, bias, n_out):
    if scale.dtype != torch.float32 or scale.numel() != 1 or \
            scale.device != x.device:
        raise MXTPUError("%s: scale must be one float32 value on %s, got %s "
                         "%s on %s" % (name, x.device, scale.dtype,
                                       tuple(scale.shape), scale.device))
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (n_out,)
                             or bias.device != x.device):
        raise MXTPUError("%s: bias must be (%d,) float32 on %s, got %s %s "
                         "on %s" % (name, n_out, x.device, bias.dtype,
                                    tuple(bias.shape), bias.device))


#: the H100's streaming multiprocessors
_SMS = 132


def _plan(M, Ng, kind="nhwc"):
    """Q1's tile (BM, BN) for M output pixels and Ng output channels a
    group.  The NCHW byte-gather kernel (``nchw``): 128 pixels, and 128
    channels where a group has as many, else 64.  The channels-last
    kernel: 64 channels where a group has at most 64, else 128, and 128
    pixels unless that leaves fewer than two blocks an SM (the 7x7 stage
    and the stride-2 convs into it at batch 128), then 64."""
    if kind == "nchw":
        return 128, 128 if Ng >= 128 else 64
    bn = 64 if Ng <= 64 else 128
    bm = 128 if -(-M // 128) * -(-Ng // bn) >= 2 * _SMS else 64
    return bm, bn


#: a block's shared memory on the H100 (bytes), and the stem kernel's
#: output channels and most pixels a block
_SMEM, _STEM_BN, _STEM_PIXELS = 232448, 64, 256


def _stem_smem(R, TW, KH, KW, sh, sw, dh, dw):
    """Shared memory of a stem block of R output rows x TW columns (as the
    C launcher's ``stem_layout`` computes it): 64 weight rows at a pitch
    of K + 16 bytes; the input patch, PR = (R - 1) * sh + (KH - 1) * dh +
    1 rows of PWp 4-byte words, PWp = PW + 15 rounded up to 16 for PW =
    (TW - 1) * sw + (KW - 1) * dw + 1 input columns (the patch starts at
    the tile's first column floored to 16); the next tile's fetched raw
    input, PR x 4 channel rows of PWp bytes; and the staged int32 tile (64
    channels of the pixels rounded to 32, plus 4)."""
    PR = (R - 1) * sh + (KH - 1) * dh + 1
    PWp = -(-((TW - 1) * sw + (KW - 1) * dw + 1 + 15) // 16) * 16
    weights = _STEM_BN * (KH * -(-KW // 8) * 32 + 16)
    staged = _STEM_BN * (-(-(R * TW) // 32) * 32 + 4) * 4
    return weights + 4 * PR * PWp + 4 * PR * PWp + staged


def _plan_stem(OH, OW, KH, KW, sh, sw, dh, dw):
    """The stem kernel's tile (R, TW): output rows and columns of one
    image a block, at most 256 pixels (a warp's 32 each): columns the
    whole output row up to 256 (a block's rows then write one run a
    channel), rows as many as fill 256 pixels (2 x 112 at ResNet-50's
    stem); halved, rows first, until the block's shared memory fits; None
    where even one pixel's window does not."""
    TW = min(OW, _STEM_PIXELS)
    R = max(1, min(OH, _STEM_PIXELS // TW))
    while _stem_smem(R, TW, KH, KW, sh, sw, dh, dw) > _SMEM:
        if R == 1 and TW == 1:
            return None
        if R > 1:
            R //= 2
        else:
            TW = -(-TW // 2)
    return R, TW


def route(x, groups=1, kernel=(1, 1), dilate=(1, 1)):
    """Q1's kernel for an int8 payload x (N, C, H, W) by its layout and
    channels: ``"nhwc"`` where x is stored channels-last and C / groups is
    a multiple of 16; where x is NCHW-contiguous, ``"stem"`` if C / groups
    is at most 4 and one output pixel's window of the kernel (kh, kw) at
    ``dilate`` fits the stem kernel's shared memory with its weights
    (:func:`_stem_smem`; any realistic stem does), else ``"nchw"``; else
    None (no kernel reads it; the wrapper raises on the card)."""
    Cg = x.shape[1] // groups
    if Cg % 16 == 0 and x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    if not x.is_contiguous():
        return None
    if Cg <= 4 and _stem_smem(1, 1, *kernel, 1, 1, *dilate) <= _SMEM:
        return "stem"
    return "nchw"


#: Q2: the most blocks of a cluster that share a tile's K (the portable
#: limit), and a split's fewest 64-byte steps
_FC_MAX_SPLITS, _FC_MIN_STEPS = 8, 2


def _fc_steps(K):
    """Q2's 64-byte K steps for K bytes (padded to 32)."""
    return -(-(-(-K // _KPAD) * _KPAD) // 64)


def _plan_fc(M, N, K):
    """Q2's split of K for an (M, K) x (N, K) product: S, the blocks of a
    cluster that share each 64 x 64 output tile.  1 where K has fewer
    than 2 * 2 steps of 64 bytes; else the fewest that bring the grid to
    the H100's 132 SMs, at most 8 and keeping each split at least 2 steps
    (5 at ResNet-50's classifier, 128 x 2048 -> 1000: 160 blocks of 6-7
    steps)."""
    nk = _fc_steps(K)
    if nk < 2 * _FC_MIN_STEPS:
        return 1
    tiles = -(-M // 64) * -(-N // 64)
    return max(1, min(_FC_MAX_SPLITS, nk // _FC_MIN_STEPS,
                      -(-_SMS // tiles)))


def _device(name, x):
    if x.device.type not in ("cpu", "cuda"):
        raise MXTPUError("%s: no kernel for device %s" % (name, x.device))
    return x.device.type == "cuda"


def qconv(x, w, scale, bias=None, stride=(1, 1), pad=(0, 0), dilate=(1, 1),
          groups=1, packed=None):
    """Q1: ``scale * conv2d(x, w)`` with int32 sums, ``+ bias``.  x (N, C,
    H, W) int8, channels-last (C / groups a multiple of 16) or
    NCHW-contiguous (:func:`route`), w (C_out, C / groups, kh, kw) int8,
    scale one float32, bias (C_out,) float32 or None; ``packed`` the
    weights as ``pack_weight(w, form == "nhwc", form == "stem")`` gives
    them for ``form = route(x, groups, (kh, kw), dilate)``, if the caller
    keeps them.  Out: NCHW float32."""
    if not _device("qconv", x):
        bump(QCONV)
        kind = route(x, groups, tuple(w.shape[2:]), tuple(dilate)) \
            if x.dim() == 4 and w.dim() == 4 and groups >= 1 else None
        if kind == "nhwc":
            bump(QCONV_NHWC)
        elif kind == "stem":
            bump(QCONV_STEM)
        return qconv_plain(x, w, scale, bias, stride, pad, dilate, groups)
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.dim() != 4 or \
            w.dim() != 4:
        raise MXTPUError("qconv: needs 4-D int8 x and w, got %s %s and %s %s"
                         % (x.dtype, tuple(x.shape), w.dtype,
                            tuple(w.shape)))
    N, C, H, W = x.shape
    Co, Cg, KH, KW = w.shape
    if groups < 1 or C % groups or Co % groups or Cg != C // groups:
        raise MXTPUError("qconv: %d groups do not fit x %s and w %s"
                         % (groups, tuple(x.shape), tuple(w.shape)))
    if w.device != x.device:
        raise MXTPUError("qconv: w on %s, x on %s" % (w.device, x.device))
    _check_epilogue("qconv", x, scale, bias, Co)
    (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
    OH = conv_out_size(H, KH, sh, ph, dh)
    OW = conv_out_size(W, KW, sw, pw, dw)
    if min(sh, sw, dh, dw) < 1 or min(ph, pw) < 0 or OH < 1 or OW < 1 or \
            x.numel() == 0:
        raise MXTPUError("qconv: stride %s, pad %s, dilate %s give no output"
                         " on x %s" % (stride, pad, dilate, tuple(x.shape)))
    if x.numel() >= 2 ** 31 or N * Co * OH * OW >= 2 ** 31:
        raise MXTPUError("qconv: operands of 2**31 elements or more")
    kind = route(x, groups, (KH, KW), (dh, dw))
    if kind is None:
        raise MXTPUError(
            "qconv: x %s with strides %s is neither channels-last with C / "
            "groups a multiple of 16 nor NCHW-contiguous"
            % (tuple(x.shape), tuple(x.stride())))
    nhwc, stem = kind == "nhwc", kind == "stem"
    if nhwc and x.data_ptr() % 16:
        raise MXTPUError("qconv: a channels-last x must be 16-byte aligned")
    wp = pack_weight(w, nhwc, stem) if packed is None else packed
    K = KH * -(-KW // 8) * 32 if stem else Cg * KH * KW
    Kp = wp.shape[1] if wp.dim() == 2 else 0
    if wp.dtype != torch.int8 or wp.dim() != 2 or wp.shape[0] != Co or \
            Kp < K or Kp % _KPAD or not wp.is_contiguous() or \
            wp.data_ptr() % 16 or wp.device != x.device:
        raise MXTPUError("qconv: packed weights must be (%d, K padded to %d)"
                         " int8, contiguous, 16-byte aligned on %s; got %s %s"
                         % (Co, _KPAD, x.device, wp.dtype, tuple(wp.shape)))
    out = torch.empty((N, Co, OH, OW), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), wp.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.contiguous().data_ptr(),
            out.data_ptr(), N, C, H, W, Co, KH, KW, sh, sw, ph, pw, dh, dw,
            groups, OH, OW, Kp)
    if stem:
        rc = _lib().mxtpu_qconv_stem(
            *args, *_plan_stem(OH, OW, KH, KW, sh, sw, dh, dw), stream)
    elif nhwc:
        rc = _lib().mxtpu_qconv_nhwc(
            *args, *_plan(N * OH * OW, Co // groups), stream)
    else:
        rc = _lib().mxtpu_qconv(
            *args, _plan(N * OH * OW, Co // groups, kind)[1], stream)
    if rc != 0:
        raise MXTPUError("qconv: CUDA launch failed (cudaError %d)" % rc)
    bump(QCONV)
    if nhwc:
        bump(QCONV_NHWC)
    elif stem:
        bump(QCONV_STEM)
    return out


def qfc(x, w, scale, bias=None):
    """Q2: ``scale * (x @ w^T)`` with int32 sums, ``+ bias``.  x (M, K)
    and w (N, K) int8, scale one float32, bias (N,) float32 or None."""
    if not _device("qfc", x):
        bump(QFC)
        return qfc_plain(x, w, scale, bias)
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.dim() != 2 or \
            w.dim() != 2 or x.shape[1] != w.shape[1] or x.numel() == 0 or \
            w.numel() == 0:
        raise MXTPUError("qfc: needs int8 x (M, K) and w (N, K), got %s %s "
                         "and %s %s" % (x.dtype, tuple(x.shape), w.dtype,
                                        tuple(w.shape)))
    if w.device != x.device:
        raise MXTPUError("qfc: w on %s, x on %s" % (w.device, x.device))
    M, K = x.shape
    Nn = w.shape[0]
    _check_epilogue("qfc", x, scale, bias, Nn)
    if x.numel() >= 2 ** 31 or w.numel() >= 2 ** 31 or M * Nn >= 2 ** 31:
        raise MXTPUError("qfc: operands of 2**31 elements or more")
    xp, wp = pack_weight(x), pack_weight(w)
    out = torch.empty((M, Nn), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().mxtpu_qfc(
        xp.data_ptr(), wp.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.contiguous().data_ptr(),
        out.data_ptr(), M, Nn, xp.shape[1], _plan_fc(M, Nn, K), stream)
    if rc != 0:
        raise MXTPUError("qfc: CUDA launch failed (cudaError %d)" % rc)
    bump(QFC)
    return out


def quantize_nhwc_plain(x, scale):
    """Q3's plain version: the reference's chain (``x / scale``, round
    half to even, clamp to +-127, int8) in torch ops, then the
    channels-last copy."""
    q = (x / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q.contiguous(memory_format=torch.channels_last)


def quantize_nhwc(x, scale):
    """Q3: float32 x (N, C, H, W) quantized by the 0-dim float32 ``scale``
    as the reference's ``quantize_v2`` does, written as int8 (N, C, H, W)
    stored channels-last: Q1's input.  On the card x must be
    NCHW-contiguous with C a multiple of 16."""
    if not _device("quantize_nhwc", x):
        bump(QUANTIZE_NHWC)
        return quantize_nhwc_plain(x, scale)
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise MXTPUError("quantize_nhwc: needs float32 (N, C, H, W) "
                         "NCHW-contiguous x, got %s %s with strides %s"
                         % (x.dtype, tuple(x.shape), tuple(x.stride())))
    N, C, H, W = x.shape
    if C < 16 or C % 16 or N > 65535 or H * W < 1 or x.numel() >= 2 ** 31:
        raise MXTPUError("quantize_nhwc: x %s: C must be a multiple of 16, "
                         "N at most 65535, fewer than 2**31 elements"
                         % (tuple(x.shape),))
    if scale.dtype != torch.float32 or scale.numel() != 1 or \
            scale.device != x.device:
        raise MXTPUError("quantize_nhwc: scale must be one float32 value on "
                         "%s, got %s %s on %s" % (x.device, scale.dtype,
                                                  tuple(scale.shape),
                                                  scale.device))
    q = torch.empty((N, C, H, W), dtype=torch.int8, device=x.device,
                    memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().mxtpu_quantize_nhwc(x.data_ptr(), scale.data_ptr(),
                                    q.data_ptr(), N, C, H, W, stream)
    if rc != 0:
        raise MXTPUError("quantize_nhwc: CUDA launch failed (cudaError %d)"
                         % rc)
    bump(QUANTIZE_NHWC)
    return q
