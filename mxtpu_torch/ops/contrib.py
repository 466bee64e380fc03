"""RMSNorm and rotary position embedding (the port of the two
``mxtpu/ops/contrib.py`` ops the Llama decoder uses).  Both compute in
float32 and cast back to the input's dtype, as the reference does."""

from __future__ import annotations

import torch

__all__ = ["rms_norm", "rope"]


def rms_norm(data, gamma, eps=1e-6):
    """RMSNorm over the last axis: ``x * rsqrt(mean(x*x) + eps) * gamma``
    in float32, cast back to ``data``'s dtype."""
    x = data.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(data.dtype)


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
