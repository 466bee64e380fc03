"""The fused backward of a 3x3 stride-1 pad-1 convolution (K6): the CUDA
kernel of ``csrc/conv_bwd.cu`` (the port of the Pallas TPU kernel
``_bwd_kernel`` of ``mxtpu/ops/pallas/conv_bwd.py``) and its plain
PyTorch version.

One call computes both gradients, dX and dW, from (x, w, dY).  Layouts
are PyTorch's: x (N, Ci, H, W), w (Co, Ci, 3, 3), dY (N, Co, H, W).  The
reference transposes to NHWC/HWIO around its kernel; here the kernel
reads NCHW directly (a pixel run of one channel is contiguous, which is
what both products walk) and the wrapper only permutes the small weight
to (3, 3, Co, Ci).  Sums run in float32; dX comes back in x's dtype and
dW as float32 cast to w's dtype, as in the reference.

``eligible`` and ``fits`` are the port's copies of the reference's rule
(3x3, stride 1, dilation 1, pad 1, groups 1, and the 12 MiB TPU VMEM
budget), so the port routes exactly the convs the reference routes to
its kernel when ``MXTPU_PALLAS_CONV_BWD`` is on.  The CUDA kernel itself
takes any size; the budget is the reference's, kept for parity.

``conv3x3_s1_backward`` is the wrapper: it runs the plain version on a
CPU tensor, and on a CUDA tensor launches the kernel or raises
:class:`MXTPUError`; it adds one to the ``conv_bwd`` counter per call.
``Conv3x3S1`` is the autograd Function the convolution op routes an
eligible conv through: its forward is ``F.conv2d`` (the reference also
leaves the forward to XLA), its backward the wrapper.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..base import MXTPUError, bump
from . import _build
from .paged_attention import _DTYPES

__all__ = ["NAME", "eligible", "fits", "conv_bwd_plain",
           "conv3x3_s1_backward", "Conv3x3S1"]

NAME = "conv_bwd"
_FNS: dict = {}
_VMEM_BUDGET = 12 * (1 << 20)
#: dW's pixel splits: enough blocks for a few waves over the card's SMs,
#: and at least this many pixels a split
_TARGET_BLOCKS = 1056
_MIN_PIXELS = 128


def fits(H, W, Ci, Co):
    """The reference's per-grid-step VMEM footprint bound (padded image
    and dX accumulator, dY, two dW blocks, all float32) under 12 MiB."""
    f32 = 4
    xp = (H + 2) * (W + 2) * Ci * f32
    dy = H * W * Co * f32
    dw = 2 * 9 * Ci * Co * f32
    return 2 * xp + dy + dw <= _VMEM_BUDGET


def eligible(ndim, kernel, stride, dilate, pad, num_group, in_shape=None,
             num_filter=None):
    """Whether a conv takes K6: 2-D, kernel 3x3, stride 1, dilation 1,
    pad 1, groups 1, and (given the NCHW ``in_shape``) ``fits``."""
    ok = (ndim == 2 and tuple(kernel) == (3, 3)
          and tuple(stride) == (1, 1) and tuple(dilate) == (1, 1)
          and tuple(pad) == (1, 1) and num_group == 1)
    if ok and in_shape is not None:
        N, Ci, H, W = in_shape
        ok = fits(H, W, Ci, num_filter or Ci)
    return ok


def conv_bwd_plain(x, w, dy):
    """K6's plain version, the kernel body's arithmetic: nine products
    per gradient, one per tap, on the 1-padded input, in float32.
    Returns (dX in x's dtype, dW in w's dtype)."""
    N, Ci, H, W = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    dyf, wf = dy.float(), w.float()
    dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    for kh in range(3):
        for kw in range(3):
            xs = xp[:, :, kh:kh + H, kw:kw + W]
            dw[:, :, kh, kw] = torch.einsum("nchw,nohw->oc", xs, dyf)
            dxp[:, :, kh:kh + H, kw:kw + W] += torch.einsum(
                "nohw,oc->nchw", dyf, wf[:, :, kh, kw])
    return dxp[:, :, 1:H + 1, 1:W + 1].to(x.dtype), dw.to(w.dtype)


def _lib():
    """The loaded kernel library, entry points typed (built at the first
    launch, never at import)."""
    lib = _FNS.get("lib")
    if lib is None:
        lib = _build.load("conv_bwd")
        for suffix in _DTYPES.values():
            fn = getattr(lib, "mxtpu_conv_bwd_" + suffix)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _FNS["lib"] = lib
    return lib


def _check(x, w, dy):
    """Raise for operands the kernel does not take."""
    if x.dtype not in _DTYPES:
        raise MXTPUError("conv_bwd: dtype %s is not float32 or bfloat16"
                         % x.dtype)
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[2:]) != (3, 3):
        raise MXTPUError("conv_bwd: needs x (N, Ci, H, W) and w (Co, Ci, 3,"
                         " 3), got %s and %s" % (tuple(x.shape),
                                                 tuple(w.shape)))
    N, Ci, H, W = x.shape
    Co = w.shape[0]
    if w.shape[1] != Ci or tuple(dy.shape) != (N, Co, H, W):
        raise MXTPUError("conv_bwd: shapes differ: x %s, w %s, dy %s"
                         % (tuple(x.shape), tuple(w.shape), tuple(dy.shape)))
    for t in (w, dy):
        if t.dtype != x.dtype or t.device != x.device:
            raise MXTPUError("conv_bwd: operands differ: %s on %s against "
                             "x's %s on %s" % (t.dtype, t.device, x.dtype,
                                               x.device))
    if x.numel() == 0 or dy.numel() == 0:
        raise MXTPUError("conv_bwd: empty operand")
    if x.numel() >= 2 ** 31 or dy.numel() >= 2 ** 31:
        raise MXTPUError("conv_bwd: operands of 2**31 elements or more")


def _splits(pixels, Ci, Co):
    """(splits, chunk): dW's N*H*W pixels cut into ``splits`` runs of
    ``chunk`` (a multiple of 16), enough blocks to fill the card."""
    tiles = 9 * (-(-Ci // 64)) * (-(-Co // 64))
    want = max(1, min(-(-_TARGET_BLOCKS // tiles), pixels // _MIN_PIXELS))
    chunk = -(-pixels // want)
    chunk = -(-chunk // 16) * 16
    return -(-pixels // chunk), chunk


def conv3x3_s1_backward(x, w, dy):
    """K6: (dX, dW) of ``y = conv2d(x, w, padding=1)`` given dY.  x (N, Ci,
    H, W), w (Co, Ci, 3, 3), dy (N, Co, H, W), float32 or bfloat16."""
    if x.device.type not in ("cpu", "cuda"):
        raise MXTPUError("conv_bwd: no kernel for device %s" % x.device)
    if x.device.type == "cpu":
        bump(NAME)
        return conv_bwd_plain(x, w, dy)
    _check(x, w, dy)
    x, dy = x.contiguous(), dy.contiguous()
    N, Ci, H, W = x.shape
    Co = w.shape[0]
    splits, chunk = _splits(N * H * W, Ci, Co)
    wt = w.permute(2, 3, 0, 1).contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    ws = torch.empty((splits, 9, Co, Ci), dtype=torch.float32,
                     device=x.device)
    fn = getattr(_lib(), "mxtpu_conv_bwd_" + _DTYPES[x.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dy.data_ptr(), wt.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), ws.data_ptr(), N, H, W, Ci, Co, splits, chunk,
            stream)
    if rc != 0:
        raise MXTPUError("conv_bwd: CUDA launch failed (cudaError %d)" % rc)
    bump(NAME)
    return dx, dw


class Conv3x3S1(torch.autograd.Function):
    """``F.conv2d(x, w, padding=1)`` whose backward is K6."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return conv3x3_s1_backward(x, w, dy)
