"""The fused backward of a 3x3 stride-1 pad-1 convolution (K6): the CUDA
kernel of ``csrc/conv_bwd.cu`` (the port of the Pallas TPU kernel
``_bwd_kernel`` of ``mxtpu/ops/pallas/conv_bwd.py``) and its plain
PyTorch version.

One call computes both gradients, dX and dW, from (x, w, dY).  Layouts
are PyTorch's: x (N, Ci, H, W), w (Co, Ci, 3, 3), dY (N, Co, H, W).  The
reference transposes to NHWC/HWIO around its kernel; here the kernel
reads NCHW directly (an image row of one channel is contiguous, which is
what its copies walk).  Sums run in float32; dX comes back in x's dtype
and dW as float32 cast to w's dtype, as in the reference.  On the card
both products run on the tensor cores in 3xTF32 (float32 accuracy; in
bfloat16, whose values are exact in TF32, one product).

The wrapper plans the launch (``_plan``): the pixel tiles' rows (as many
as the kernels' 224- and 128-pixel tiles and one block's shared memory
allow), the widest copy the image rows' alignment allows, and dW's
pixel splits (``_splits``); it allocates dW's float32 partials and the
weights' split buffer.

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
#: the kernels' tiles (csrc/conv_bwd.cu): the widest tile row, dX's and
#: dW's pixel tiles at most, dW's channel tile (ci, co); and the shared
#: memory one block may use
_SEG, _DX_PIXELS, _DW_PIXELS, _DW_TILE = 64, 224, 128, (32, 64)
_MAX_SMEM = 232448
#: dW blocks a call aims at: two waves of one (18-warp) block on each of
#: the H100's 132 SMs
_DW_BLOCKS = 264


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
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
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


def _cdiv(a, b):
    return -(-a // b)


def _round4(n):
    return (n + 3) & ~3


def _raw_stride(n, elt, E, res):
    """A staged channel's stride in elements: at least n, a multiple of
    E, and ``res`` 32-bit words mod 32 (the kernel's ``raw_stride``)."""
    ch = n
    while ch % E or (ch * elt) % 128 != 4 * res:
        ch += 1
    return ch


def _geometry(W, elt, vec):
    """(tc, E, eoff, sr, pw): a tile's columns, the elements of one copy,
    the columns staged each side of a tile narrower than the image, a
    staged row's length, and a plane row's (the kernel's ``Geo``)."""
    tc = min(W, _SEG)
    E = max(1, vec // elt)
    eoff = E if tc < W else 0
    return tc, E, eoff, tc + 2 * eoff, tc + 2


def _dx_smem(tr, W, elt, vec):
    """dX's shared memory at ``tr`` tile rows (the kernel's ``dx_smem``):
    the double-buffered split weights, the dY plane, its tables and the
    staged rows."""
    tc, E, eoff, sr, pw = _geometry(W, elt, vec)
    ch = _raw_stride((tr + 2) * sr, elt, E, 4)
    ints = _round4(4 + 2 * (tr + 2) + (tr + 2) * pw)
    return 2 * 9 * 4 * 64 * 16 + ((tr + 2) * pw + 3) * 64 + ints * 4 \
        + _cdiv(8 * ch * elt, 16) * 16


def _dw_smem(tr, W, elt, vec):
    """dW's shared memory at ``tr`` tile rows (the kernel's ``dw_smem``):
    the X planes, the dY fragments, the tap and pixel tables and the
    staged rows."""
    tc, E, eoff, sr, pw = _geometry(W, elt, vec)
    ks = _cdiv(tr * tc, 8)
    chx = _raw_stride((tr + 2) * sr, elt, E, 4)
    chy = _raw_stride(tr * sr, elt, E, 4)
    ints = _round4(11 * 8 * ks + 4 + 4 * (tr + 2) + (tr + 2) * pw)
    ci, co = _DW_TILE
    return 2 * ((tr + 2) * pw + 1) * 40 * 4 + (co // 16) * ks * 64 * 16 \
        + ints * 4 + ci * chx * elt + co * chy * elt


def _tile_rows(pixels, W, elt, vec, smem):
    """The most tile rows whose pixels (``tc`` a row) stay within
    ``pixels`` and whose shared memory fits one block."""
    tr = max(1, pixels // min(W, _SEG))
    while tr > 1 and smem(tr, W, elt, vec) > _MAX_SMEM:
        tr -= 1
    return tr


def _splits(tiles, Ci, Co):
    """(splits, chunk): dW's ``tiles`` pixel tiles cut into ``splits``
    runs of ``chunk`` whole tiles (so of whole k8 steps), at most
    ``_DW_BLOCKS`` blocks over the (ci, co) tiles where they allow one
    split each, none empty."""
    blocks = _cdiv(Ci, _DW_TILE[0]) * _cdiv(Co, _DW_TILE[1])
    want = max(1, min(_DW_BLOCKS // blocks, tiles))
    chunk = _cdiv(tiles, want)
    return _cdiv(tiles, chunk), chunk


def _plan(N, H, W, Ci, Co, elt, vec):
    """The launch's ints: dX's and dW's tile rows, dW's pixel tiles and
    their (splits, chunk)."""
    tr_x = _tile_rows(_DX_PIXELS, W, elt, vec, _dx_smem)
    tr_w = _tile_rows(_DW_PIXELS, W, elt, vec, _dw_smem)
    tiles = _cdiv(N * H, tr_w) * _cdiv(W, min(W, _SEG))
    splits, chunk = _splits(tiles, Ci, Co)
    return dict(tr_x=tr_x, tr_w=tr_w, tiles=tiles, splits=splits,
                chunk=chunk)


def _vec(W, elt, *ptrs):
    """The widest copy, in bytes, that every staged image row allows: 16,
    8 or 4 where the row's bytes and the base addresses divide by it,
    else one element (a bfloat16 row of odd width)."""
    for v in (16, 8, 4):
        if (W * elt) % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    return elt


def conv3x3_s1_backward(x, w, dy):
    """K6: (dX, dW) of ``y = conv2d(x, w, padding=1)`` given dY.  x (N, Ci,
    H, W), w (Co, Ci, 3, 3), dy (N, Co, H, W), float32 or bfloat16."""
    if x.device.type not in ("cpu", "cuda"):
        raise MXTPUError("conv_bwd: no kernel for device %s" % x.device)
    if x.device.type == "cpu":
        bump(NAME)
        return conv_bwd_plain(x, w, dy)
    _check(x, w, dy)
    x, dy, w = x.contiguous(), dy.contiguous(), w.contiguous()
    N, Ci, H, W = x.shape
    Co = w.shape[0]
    elt = x.element_size()
    vec = _vec(W, elt, x.data_ptr(), dy.data_ptr())
    plan = _plan(N, H, W, Ci, Co, elt, vec)
    dx = torch.empty_like(x)
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    ws = torch.empty((plan["splits"], 9, Co, Ci), dtype=torch.float32,
                     device=x.device)
    wsp = torch.empty(_cdiv(Co, 8) * 9 * _cdiv(Ci, 16) * 64 * 16,
                      dtype=torch.uint8, device=x.device)
    fn = getattr(_lib(), "mxtpu_conv_bwd_" + _DTYPES[x.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), ws.data_ptr(), wsp.data_ptr(), N, H, W, Ci, Co,
            plan["tr_x"], plan["tr_w"], vec, plan["splits"], plan["chunk"],
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
