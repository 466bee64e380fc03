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
  float32, NCHW.  Two kernels, chosen by x's layout (:func:`route`): a
  channels-last x whose channels a group are a multiple of 16 goes to
  ``qconv_nhwc_kernel`` (16-byte copies of a pixel's channels, tiles by
  :func:`_plan`), an NCHW-contiguous x to ``qconv_kernel`` (the stem's
  3 channels, a byte gather); on the card any other x raises.  The
  kernels read the weights as (C_out, K padded to 32) rows
  (:func:`pack_weight`; OHWI order for the channels-last kernel, OIHW
  for the other); a quantized layer keeps them so and passes
  ``packed``, else each call packs them.
- :func:`qfc` (Q2): x (M, K) and w (N, K) int8; out (M, N) float32.
  The kernel reads both with K padded to 32 (:func:`pack_weight`; zeros
  add nothing to the sums), a view where K already is a multiple.
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
too for one on the channels-last route, ``qfc``, ``quantize_nhwc``.
Nothing builds at import.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..base import MXTPUError, bump
from . import _build

__all__ = ["QCONV", "QCONV_NHWC", "QFC", "QUANTIZE_NHWC", "pack_weight",
           "conv_out_size", "route", "qconv_sums", "qfc_sums", "qconv_plain",
           "qconv", "qfc_plain", "qfc", "quantize_nhwc_plain",
           "quantize_nhwc"]

QCONV, QCONV_NHWC, QFC = "qconv", "qconv_nhwc", "qfc"
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
        lib.mxtpu_qfc.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.mxtpu_qfc.restype = ctypes.c_int
        lib.mxtpu_qconv_nhwc.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 19 + [ctypes.c_void_p]
        lib.mxtpu_qconv_nhwc.restype = ctypes.c_int
        lib.mxtpu_quantize_nhwc.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.mxtpu_quantize_nhwc.restype = ctypes.c_int
        _FNS["lib"] = lib
    return lib


def pack_weight(w, channels_last=False):
    """int8 rows as Q1 and Q2 read them: (rows, K), zero-padded to a
    multiple of 32 bytes and 16-byte aligned (a view of ``w`` where it
    already is so).  For OIHW weights a row is an output channel, K = C_in
    / groups * kh * kw in (c, r, s) order, or with ``channels_last`` in
    (r, s, c) order (OHWI, as Q1's channels-last kernel reads them); for
    Q2's (M, K) or (N, K) operands a row is a row."""
    Co = w.shape[0]
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
    group.  The stem's kernel (``nchw``): 128 pixels, and 128 channels
    where a group has as many, else 64.  The channels-last kernel: 64
    channels where a group has at most 64, else 128, and 128 pixels
    unless that leaves fewer than two blocks an SM (the 7x7 stage and the
    stride-2 convs into it at batch 128), then 64."""
    if kind == "nchw":
        return 128, 128 if Ng >= 128 else 64
    bn = 64 if Ng <= 64 else 128
    bm = 128 if -(-M // 128) * -(-Ng // bn) >= 2 * _SMS else 64
    return bm, bn


def route(x, groups=1):
    """Q1's kernel for an int8 payload x (N, C, H, W) by its layout:
    ``"nhwc"`` where x is stored channels-last and C / groups is a
    multiple of 16, else ``"nchw"`` where x is NCHW-contiguous, else None
    (no kernel reads it; the wrapper raises on the card)."""
    if (x.shape[1] // groups) % 16 == 0 and \
            x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return "nchw" if x.is_contiguous() else None


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
    weights as ``pack_weight(w, channels_last=route(x) == "nhwc")`` gives
    them, if the caller keeps them.  Out: NCHW float32."""
    if not _device("qconv", x):
        bump(QCONV)
        if x.dim() == 4 and groups >= 1 and route(x, groups) == "nhwc":
            bump(QCONV_NHWC)
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
    kind = route(x, groups)
    if kind is None:
        raise MXTPUError(
            "qconv: x %s with strides %s is neither channels-last with C / "
            "groups a multiple of 16 nor NCHW-contiguous"
            % (tuple(x.shape), tuple(x.stride())))
    nhwc = kind == "nhwc"
    if nhwc and x.data_ptr() % 16:
        raise MXTPUError("qconv: a channels-last x must be 16-byte aligned")
    wp = pack_weight(w, nhwc) if packed is None else packed
    K = Cg * KH * KW
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
    tiles = _plan(N * OH * OW, Co // groups, kind)
    if nhwc:
        rc = _lib().mxtpu_qconv_nhwc(*args, *tiles, stream)
    else:
        rc = _lib().mxtpu_qconv(*args, tiles[1], stream)
    if rc != 0:
        raise MXTPUError("qconv: CUDA launch failed (cudaError %d)" % rc)
    bump(QCONV)
    if nhwc:
        bump(QCONV_NHWC)
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
        out.data_ptr(), M, Nn, xp.shape[1], stream)
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
