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

On a CPU tensor the wrapper runs :func:`rows_linear_plain`
(``F.linear``); on a CUDA tensor it launches the kernel, or raises for
what the kernel does not take.  Each call adds one to the
``rows_linear`` launch counter (``mxtpu_torch.base``).
"""

from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from ..base import MXTPUError, bump
from . import _build

__all__ = ["rows_linear", "rows_linear_plain", "KERNEL_NAME"]

KERNEL_NAME = "rows_linear"
_FNS: dict = {}


def rows_linear_plain(x, weight):
    """The kernel's plain version: ``F.linear(x, weight)``."""
    return F.linear(x, weight)


def _fns():
    if not _FNS:
        lib = _build.load("rows_linear")
        bf16 = lib.mxtpu_rows_linear_bf16
        bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        f32 = lib.mxtpu_rows_linear_f32
        f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        splits = lib.mxtpu_rows_linear_splits
        splits.argtypes = [ctypes.c_int] * 2
        for fn in (bf16, f32, splits):
            fn.restype = ctypes.c_int
        _FNS.update(bf16=bf16, f32=f32, splits=splits)
    return _FNS


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
    N, K = weight.shape
    if x.shape[-1] != K:
        raise MXTPUError("rows_linear: x %s does not match weight %s"
                         % (tuple(x.shape), tuple(weight.shape)))
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or weight.dtype != x.dtype or weight.device != x.device:
        raise MXTPUError("rows_linear: x (%s on %s) and weight (%s on %s) "
                         "must share a dtype, float32 or bfloat16, and a "
                         "device" % (x.dtype, x.device, weight.dtype,
                                     weight.device))
    x2 = x.reshape(-1, K).contiguous()
    if not weight.is_contiguous():
        raise MXTPUError("rows_linear: weight must be contiguous")
    if x.dtype == torch.bfloat16 and (K % 8 or weight.data_ptr() % 16
                                      or x2.data_ptr() % 16):
        raise MXTPUError("rows_linear: bfloat16 needs K %% 8 == 0 (got %d) "
                         "and 16-byte aligned x and weight" % K)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(x.shape[:-1] + (N,))
    fns = _fns()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        S = fns["splits"](N, K)
        ws = torch.empty((S, M, N), dtype=torch.float32, device=x.device) \
            if S > 1 else None
        rc = fns["bf16"](x2.data_ptr(), weight.data_ptr(), y.data_ptr(),
                         0 if ws is None else ws.data_ptr(), M, N, K, stream)
    else:
        rc = fns["f32"](x2.data_ptr(), weight.data_ptr(), y.data_ptr(), M, N,
                        K, stream)
    if rc != 0:
        raise MXTPUError("rows_linear: CUDA launch failed (cudaError %d)"
                         % rc)
    bump(KERNEL_NAME)
    return y.reshape(x.shape[:-1] + (N,))
