"""Flash attention with its FlashAttention-2 backward: the three CUDA
kernels of ``csrc/flash_attention.cu`` (the port of the Pallas TPU
kernels ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` of
``mxtpu/ops/pallas/flash_attention.py``) and their plain PyTorch
versions.

``flash_attention`` is what the model calls.  It keeps the reference's
dense rule (``T < 16 or D % 8 != 0`` → :func:`dense_attention`, counted
as ``flash_attention_dense``) and otherwise runs a
``torch.autograd.Function`` whose forward is K3 and whose backward is K4
and K5, with ``delta = rowsum(dO * O)`` computed in plain PyTorch
between them, as the reference computes it in XLA.

The three wrappers (``flash_fwd``, ``flash_dq``, ``flash_dkv``) run the
plain version on a CPU tensor, and on a CUDA tensor launch their kernel
or raise :class:`MXTPUError` — there is no fallback from the card to the
plain version.  Each adds one to its launch counter (``flash_fwd``,
``flash_dq``, ``flash_dkv`` in ``mxtpu_torch.base``) per call.

All three run their products on the tensor cores (3xTF32 ``mma.sync``
at float32 accuracy), except K4 and K5 at head_dim above 128, where the
C launcher takes their CUDA-core kernels (``flash_dq_cc_kernel``,
``flash_dkv_cc_kernel``): a K5 warp's dK or dV alone would need 128
registers a thread there, and K4's resident Q and dO would crowd out
the warps.  The route follows head_dim alone (:func:`route`), never
a failure, and counts under the same launch counter.

The reference's ``MXTPU_FLASH_BWD=0`` switch (a recompute backward
through the dense formulation) is not ported: the backward is always
the two kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXTPUError, bump
from . import _build
from .paged_attention import _DTYPES, _NEG_INF

__all__ = ["flash_attention", "dense_attention", "flash_fwd", "flash_dq",
           "flash_dkv", "flash_fwd_plain", "flash_dq_plain",
           "flash_dkv_plain", "fits", "route", "DENSE_NAME", "TENSOR_CORES",
           "CUDA_CORES"]

DENSE_NAME = "flash_attention_dense"
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
_FNS: dict = {}


# -- plain versions: the FlashAttention-2 arithmetic in float32 ----------

def _scores(q, k, scale, causal, prescale):
    """float32 scores (B, H, T, T) with masked entries at -1e30.  The
    forward scales q before the product (``prescale``), the backward
    scales the product, as the Pallas kernels do."""
    qf, kf = q.float(), k.float()
    if prescale:
        s = torch.matmul(qf * scale, kf.transpose(-1, -2))
    else:
        s = scale * torch.matmul(qf, kf.transpose(-1, -2))
    if causal:
        T = q.shape[-2]
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_plain(q, k, v, scale, causal):
    """K3's plain version.  q, k, v (B, H, T, D) → o (B, H, T, D) in q's
    dtype and the per-row logsumexp lse (B, H, T) in float32."""
    s = _scores(q, k, scale, causal, prescale=True)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _probs(q, k, lse, scale, causal):
    """p = exp(s - lse) from the saved logsumexp (masked entries → 0)."""
    return torch.exp(_scores(q, k, scale, causal, prescale=False)
                     - lse[..., None])


def flash_dq_plain(q, k, v, do, lse, delta, scale, causal):
    """K4's plain version: dq = scale * (p * (dO vᵀ - delta)) k, with p
    recomputed from lse.  Returns dq in q's dtype."""
    p = _probs(q, k, lse, scale, causal)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    return (scale * torch.matmul(ds, k.float())).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, scale, causal):
    """K5's plain version: dv = pᵀ dO, dk = scale * dsᵀ q.  Returns
    (dk, dv) in k's and v's dtypes."""
    p = _probs(q, k, lse, scale, causal)
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def dense_attention(q, k, v, scale, causal):
    """The port of the reference's ``_dense_attention``: float32 scores,
    a causal mask aligned to the last key (``tril(Tk - Tq)``), softmax,
    cast back to q's dtype.  Differentiable through autograd."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        keep = torch.ones(Tq, Tk, dtype=torch.bool,
                          device=q.device).tril(Tk - Tq)
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


# -- the kernels -----------------------------------------------------------

_KINDS = {"fwd": (0, 5), "dq": (1, 7), "dkv": (2, 8)}   # kind: (id, pointers)


def _lib():
    """The loaded kernel library with its entry points typed (built at
    the first launch, never at import)."""
    lib = _FNS.get("lib")
    if lib is None:
        lib = _build.load("flash_attention")
        lib.mxtpu_flash_fits.argtypes = [ctypes.c_int] * 3
        lib.mxtpu_flash_fits.restype = ctypes.c_int
        for kind, (_, n_ptr) in _KINDS.items():
            for suffix in _DTYPES.values():
                fn = getattr(lib, "mxtpu_flash_%s_%s" % (kind, suffix))
                fn.argtypes = [ctypes.c_void_p] * n_ptr + [
                    ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int
        _FNS["lib"] = lib
    return lib


def fits(kind, D, dtype):
    """Whether one block's shared memory holds the tiles of kernel
    ``kind`` ("fwd", "dq" or "dkv") at head_dim D in ``dtype`` (loads
    the kernel library)."""
    return bool(_lib().mxtpu_flash_fits(_KINDS[kind][0], D,
                                        dtype.itemsize))


def route(kind, D):
    """The route kernel ``kind`` ("fwd", "dq" or "dkv") takes at head_dim
    D: :data:`CUDA_CORES` for K4 and K5 above 128, else
    :data:`TENSOR_CORES` (the C launcher's ``cc_route``)."""
    return CUDA_CORES if kind != "fwd" and D > 128 else TENSOR_CORES


def _check(name, kind, tensors, floats=()):
    """Raise for operands the kernels do not take: (B, H, T, D) tensors
    of one shape and dtype (float32 or bfloat16) on one CUDA device,
    contiguous and 16-byte aligned, D a multiple of 8 up to 256; lse
    and delta float32 (B, H, T)."""
    q = tensors[0]
    if q.dtype not in _DTYPES:
        raise MXTPUError("%s: dtype %s is not float32 or bfloat16"
                         % (name, q.dtype))
    if q.ndim != 4:
        raise MXTPUError("%s: q must be (B, H, T, D), got %s"
                         % (name, tuple(q.shape)))
    B, H, T, D = q.shape
    for x in tensors:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise MXTPUError("%s: operands differ: %s %s on %s against q's "
                             "%s %s on %s" % (name, tuple(x.shape), x.dtype,
                                              x.device, tuple(q.shape),
                                              q.dtype, q.device))
    for x in floats:
        if tuple(x.shape) != (B, H, T) or x.dtype != torch.float32 \
                or x.device != q.device:
            raise MXTPUError("%s: lse and delta must be float32 (B, H, T) "
                             "on %s, got %s %s on %s"
                             % (name, q.device, x.dtype, tuple(x.shape),
                                x.device))
    for x in tuple(tensors) + tuple(floats):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise MXTPUError("%s: operands must be contiguous and 16-byte "
                             "aligned" % name)
    if D % 8 or D > 256:
        raise MXTPUError("%s: head_dim %d must be a multiple of 8 and at "
                         "most 256" % (name, D))
    if T < 1:
        raise MXTPUError("%s: empty sequence" % name)
    if not fits(kind, D, q.dtype):
        raise MXTPUError("%s: head_dim %d needs more shared memory than one "
                         "block has" % (name, D))


def _launch(name, kind, ptrs, q, scale, causal):
    BH, T, D = q.shape[0] * q.shape[1], q.shape[2], q.shape[3]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fn = getattr(_lib(), "mxtpu_flash_%s_%s" % (kind, _DTYPES[q.dtype]))
    rc = fn(*[x.data_ptr() for x in ptrs], BH, T, D, int(bool(causal)),
            float(scale), stream)
    if rc != 0:
        raise MXTPUError("%s: CUDA launch failed (cudaError %d)" % (name, rc))


def _device(name, q):
    if q.device.type not in ("cpu", "cuda"):
        raise MXTPUError("%s: no kernel for device %s" % (name, q.device))
    return q.device.type == "cuda"


def flash_fwd(q, k, v, scale, causal):
    """K3: q, k, v (B, H, T, D) → (o (B, H, T, D), lse (B, H, T) float32)."""
    if not _device("flash_fwd", q):
        bump("flash_fwd")
        return flash_fwd_plain(q, k, v, scale, causal)
    _check("flash_fwd", "fwd", (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "fwd", (q, k, v, o, lse), q, scale, causal)
    bump("flash_fwd")
    return o, lse


def flash_dq(q, k, v, do, lse, delta, scale, causal):
    """K4: dq (B, H, T, D) from q, k, v, dO, the forward's lse and
    delta = rowsum(dO * O)."""
    if not _device("flash_dq", q):
        bump("flash_dq")
        return flash_dq_plain(q, k, v, do, lse, delta, scale, causal)
    _check("flash_dq", "dq", (q, k, v, do), (lse, delta))
    dq = torch.empty_like(q)
    _launch("flash_dq", "dq", (q, k, v, do, lse, delta, dq), q, scale,
            causal)
    bump("flash_dq")
    return dq


def flash_dkv(q, k, v, do, lse, delta, scale, causal):
    """K5: (dk, dv), each (B, H, T, D), from the same operands as K4."""
    if not _device("flash_dkv", q):
        bump("flash_dkv")
        return flash_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    _check("flash_dkv", "dkv", (q, k, v, do), (lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_dkv", "dkv", (q, k, v, do, lse, delta, dk, dv), q,
            scale, causal)
    bump("flash_dkv")
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward K3, saving (q, k, v, o, lse); backward delta in plain
    PyTorch, then K4 and K5."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Streaming-softmax attention over (B, H, T, D), differentiable.

    ``scale`` defaults to 1/sqrt(D).  Where the reference takes its dense
    path (``T < 16 or D % 8 != 0``) this runs :func:`dense_attention`
    and counts ``flash_attention_dense``; otherwise K3 forward and K4/K5
    backward.  The reference's ``q_block``/``kv_block`` are TPU tiling
    choices that do not change the function: the CUDA kernels pick their
    own tiles, so they are not parameters here."""
    B, H, T, D = q.shape
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))
    if T < 16 or D % 8 != 0:
        bump(DENSE_NAME)
        return dense_attention(q, k, v, scale, causal)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), scale, bool(causal))
