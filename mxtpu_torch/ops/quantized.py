"""The int8 x int8 products of post-training quantization: Q1, the
convolution, and Q2, the fully-connected product (``csrc/quantized.cu``),
each beside its plain PyTorch version.

Both take int8 operands, sum their products in int32 and return float32
``acc * scale (+ bias)``, where ``scale`` is one float32 value on the
operands' device (the product of the input's and the weights' scales,
``contrib/quantization.py:quantized_conv``).  They replace no
``pallas_call``: the reference's ``quantized_conv`` and
``quantized_fully_connected`` (``mxtpu/contrib/quantization.py:81``,
``:62``) run as XLA's int8 ``conv_general_dilated`` and ``dot_general``
with int32 sums.

- :func:`qconv` (Q1): x (N, C, H, W) int8, w (C_out, C / groups, kh, kw)
  int8, 2-D stride, padding, dilation and groups; out (N, C_out, OH, OW)
  float32.  The kernel reads the weights as (C_out, K padded to 32) rows
  (:func:`pack_weight`); a quantized layer keeps them so and passes
  ``packed``, else each call packs them.
- :func:`qfc` (Q2): x (M, K) and w (N, K) int8; out (M, N) float32.
  The kernel reads both with K padded to 32 (:func:`pack_weight`; zeros
  add nothing to the sums), a view where K already is a multiple.

The plain versions (:func:`qconv_plain`, :func:`qfc_plain`) take the
product (:func:`qconv_sums`, :func:`qfc_sums`) in float64 on the int8 values and cast it to int32, which is
exact on either device (|products| <= 127^2, and ResNet-50's largest sum,
4608 * 127^2 ~ 7.4e7, is far below 2^53; PyTorch has no int32
convolution on CUDA), then apply the same epilogue as separate torch
ops: ``acc.float() * scale``, then ``+ bias``.  The kernels round each
step once too (no FMA), so a kernel equals its plain version bit for
bit.

Each wrapper runs the plain version on a CPU tensor and, on a CUDA
tensor, launches its kernel or raises :class:`MXTPUError`; it adds one
to its counter (``qconv``, ``qfc``) per call.  Nothing builds at import.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..base import MXTPUError, bump
from . import _build

__all__ = ["QCONV", "QFC", "pack_weight", "conv_out_size", "qconv_sums",
           "qfc_sums", "qconv_plain", "qconv", "qfc_plain", "qfc"]

QCONV, QFC = "qconv", "qfc"
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
        _FNS["lib"] = lib
    return lib


def pack_weight(w):
    """int8 rows as Q1 and Q2 read them: (rows, K), zero-padded to a
    multiple of 32 bytes and 16-byte aligned (a view of ``w`` where it
    already is so).  For OIHW weights a row is an output channel, K = C_in
    / groups * kh * kw in (c, r, s) order; for Q2's (M, K) or (N, K)
    operands a row is a row."""
    Co = w.shape[0]
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
    values, cast to int32 (exact)."""
    return F.conv2d(x.double(), w.double(), stride=tuple(stride),
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


def _plan(Ng):
    """Q1's N tile: 128 output channels a block where a group has as
    many, else 64."""
    return 128 if Ng >= 128 else 64


def _device(name, x):
    if x.device.type not in ("cpu", "cuda"):
        raise MXTPUError("%s: no kernel for device %s" % (name, x.device))
    return x.device.type == "cuda"


def qconv(x, w, scale, bias=None, stride=(1, 1), pad=(0, 0), dilate=(1, 1),
          groups=1, packed=None):
    """Q1: ``scale * conv2d(x, w)`` with int32 sums, ``+ bias``.  x (N, C,
    H, W) int8, w (C_out, C / groups, kh, kw) int8, scale one float32,
    bias (C_out,) float32 or None; ``packed`` the weights as
    :func:`pack_weight` gives them, if the caller keeps them."""
    if not _device("qconv", x):
        bump(QCONV)
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
    wp = pack_weight(w) if packed is None else packed
    K = Cg * KH * KW
    Kp = wp.shape[1] if wp.dim() == 2 else 0
    if wp.dtype != torch.int8 or wp.dim() != 2 or wp.shape[0] != Co or \
            Kp < K or Kp % _KPAD or not wp.is_contiguous() or \
            wp.data_ptr() % 16 or wp.device != x.device:
        raise MXTPUError("qconv: packed weights must be (%d, K padded to %d)"
                         " int8, contiguous, 16-byte aligned on %s; got %s %s"
                         % (Co, _KPAD, x.device, wp.dtype, tuple(wp.shape)))
    x = x.contiguous()
    out = torch.empty((N, Co, OH, OW), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().mxtpu_qconv(
        x.data_ptr(), wp.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.contiguous().data_ptr(),
        out.data_ptr(), N, C, H, W, Co, KH, KW, sh, sw, ph, pw, dh, dw,
        groups, OH, OW, Kp, _plan(Co // groups), stream)
    if rc != 0:
        raise MXTPUError("qconv: CUDA launch failed (cudaError %d)" % rc)
    bump(QCONV)
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
