"""RMSNorm and rotary position embedding (the port of the two
``mxtpu/ops/contrib.py`` ops the Llama decoder uses).  Both compute in
float32 and cast back to the input's dtype, as the reference does.

``rows_rms_norm`` is G2, the RMSNorm of the decode step and the verify
window: the CUDA kernel ``rows_rms_norm_kernel`` of
``csrc/rows_linear.cu``, whose result for a row does not depend on how
many rows the call has (PyTorch's mean picks its reduction layout by
the row count).  Its plain version is :func:`rms_norm`, which it runs on
a CPU tensor; on a CUDA tensor it launches the kernel or raises.  Each
call adds one to the ``rows_rms_norm`` launch counter."""

from __future__ import annotations

import ctypes

import torch

from ..base import MXTPUError, bump
from . import _build

__all__ = ["rms_norm", "rows_rms_norm", "rope", "NORM_KERNEL_NAME"]

NORM_KERNEL_NAME = "rows_rms_norm"
_FNS: dict = {}


def rms_norm(data, gamma, eps=1e-6):
    """RMSNorm over the last axis: ``x * rsqrt(mean(x*x) + eps) * gamma``
    in float32, cast back to ``data``'s dtype."""
    x = data.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(data.dtype)


def _norm_fn(dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        lib = _build.load("rows_linear")
        fn = getattr(lib, "mxtpu_rows_rms_norm_" + (
            "bf16" if dtype == torch.bfloat16 else "f32"))
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def rows_rms_norm(data, gamma, eps=1e-6):
    """:func:`rms_norm` whose result for a row is the same bits whatever
    the number of rows (G2).  float32 or bfloat16 ``data`` (..., C),
    ``gamma`` (C,)."""
    if data.device.type == "cpu":
        bump(NORM_KERNEL_NAME)
        return rms_norm(data, gamma, eps)
    if data.device.type != "cuda":
        raise MXTPUError("rows_rms_norm: no kernel for device %s"
                         % data.device)
    C = data.shape[-1]
    if data.dtype not in (torch.float32, torch.bfloat16) \
            or gamma.shape != (C,) or gamma.device != data.device:
        raise MXTPUError("rows_rms_norm: data (%s, %s on %s) must be float32 "
                         "or bfloat16 with gamma (%d,) on its device, got %s "
                         "on %s" % (data.dtype, tuple(data.shape),
                                    data.device, C, tuple(gamma.shape),
                                    gamma.device))
    x = data.reshape(-1, C).contiguous()
    g = gamma.float().contiguous()
    y = torch.empty_like(x)
    if x.shape[0]:
        rc = _norm_fn(x.dtype)(
            x.data_ptr(), g.data_ptr(), y.data_ptr(), x.shape[0], C,
            float(eps), torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise MXTPUError("rows_rms_norm: CUDA launch failed (cudaError "
                             "%d)" % rc)
        bump(NORM_KERNEL_NAME)
    return y.reshape(data.shape)


def rope(data, offset=0):
    """Rotary position embedding over the last axis of (B, H, T, D) or
    (B, T, D), in the Llama half-split pair layout: pairs are
    (x[..., :D/2], x[..., D/2:]).

    ``offset`` is a python int (every row starts at the same position),
    a (B,) integer tensor: row b's positions start at offset[b] (the
    pooled decode step, where each slot sits at its own depth), or a
    (B, T) integer tensor of absolute positions: element (b, t) is
    rotated at offset[b, t] (tree verify, where window lane t sits at
    its tree depth rather than at t).  Base 10000; angles are float32
    (positions are exact in float32 below 2**24, so the (B, T) form is
    bit-identical to the (B,) form wherever offset[b, t] ==
    offset[b] + t)."""
    x = data.float()
    D = x.shape[-1]
    T = x.shape[-2]
    half = D // 2
    dev = x.device
    freqs = torch.pow(
        torch.tensor(10000.0, dtype=torch.float32, device=dev),
        -torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    steps = torch.arange(T, dtype=torch.float32, device=dev)
    if torch.is_tensor(offset) and offset.ndim >= 1:
        if offset.ndim >= 2:
            pos = offset.to(device=dev, dtype=torch.float32)    # (B, T)
        else:
            off = offset.reshape(-1).to(device=dev, dtype=torch.float32)
            pos = steps[None, :] + off[:, None]                # (B, T)
        ang = pos[..., None] * freqs                            # (B, T, D/2)
        shape = (x.shape[0],) + (1,) * (x.ndim - 3) + (T, half)
    else:
        pos = steps + float(offset)
        ang = pos[:, None] * freqs[None, :]                     # (T, D/2)
        shape = (1,) * (x.ndim - 2) + (T, half)
    sin = torch.sin(ang).reshape(shape)
    cos = torch.cos(ang).reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(data.dtype)
