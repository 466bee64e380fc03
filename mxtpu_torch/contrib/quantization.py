"""Weight-only int8/int4 quantization for serving (the port of the
weight-only path of ``mxtpu/contrib/quantization.py``: ``pack_int4`` /
``unpack_int4``, ``_i4_group``, ``wq_matmul_i8``, ``wq_matmul_i8_q8``,
``wq_matmul_i4``, ``QuantizedDense`` and ``quantize_weights``).

Decode reads every weight once a token, so storing them in int8 halves
that stream, and int4 at group size 64 cuts it to about 0.56 of bf16
(scales included).  The activations and the KV cache stay as they are;
pair with ``cache_dtype="int8"`` for the int8 cache too.

- :func:`quantize_tensor` quantizes one float weight (O, I) on its own
  device in float32 with ``_quantize_dense``'s arithmetic: int8 per
  output channel, ``s = max(max|w|, 1e-8) / 127``, ``q = clip(round(w /
  s), -127, 127)`` (round half to even, as ``np.round``); int4 the same
  per channel and input group with 7, packed two a byte
  (:func:`pack_int4`'s layout).  Its payloads and scales equal the
  reference's numpy result bit for bit.
- :class:`QuantizedLinear` holds the int8 payload and the float32
  scales as frozen parameters named ``weight`` and ``wscale`` (so the
  weight bridge, ``models/convert.py``, carries them under the
  reference's names) and runs the ops below.
- :func:`quantize_weights` rewrites every ``nn.Linear`` of a model
  (a ``TransformerLM``'s qkv, out_proj, gate, up, down and lm_head; the
  embedding is never touched) in place.
- The ops: :func:`wq_matmul_i8` and :func:`wq_matmul_i4` go to G3 and
  G4 (``ops/linear.py:wq_matmul``, ``csrc/rows_linear.cu``): on a CPU
  tensor their plain versions, on a CUDA tensor the kernels, which read the
  int8 or packed int4 weights themselves, so no float copy of a weight
  is ever made.  :func:`wq_matmul_i8_q8` is ``wq_matmul_i8`` followed by
  the KV cache's quantizer per head (``ops/tensor.py:_q8_quantize``),
  the reference's own definition, in one launch: G3 with its q8
  epilogue (``ops/linear.py:wq_matmul_q8``, the whole output as V).
  The decode step and the verify window run that epilogue over the
  whole qkv weight (``models/transformer.py``: the fused int8 V
  epilogue).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..base import MXTPUError
from ..ops import linear as _linear
from ..ops.linear import wq_matmul_i4_plain, wq_matmul_i8_plain

__all__ = ["pack_int4", "unpack_int4", "quantize_tensor", "wq_matmul_i8",
           "wq_matmul_i8_q8", "wq_matmul_i4", "wq_matmul_i8_plain",
           "wq_matmul_i4_plain", "QuantizedLinear", "quantize_weights"]


def pack_int4(q):
    """Pack an int4-valued int8 array (O, I) into (O, I//2) bytes — even
    input index in the low nibble, odd in the high (the ``wq_matmul_i4``
    layout).  Host-side numpy."""
    q = np.asarray(q, np.int8)
    if q.shape[-1] % 2:
        raise MXTPUError("pack_int4 needs an even input dim, got %r"
                         % (q.shape,))
    lo = q[..., 0::2].astype(np.uint8) & 0xF
    hi = q[..., 1::2].astype(np.uint8) & 0xF
    return ((hi << 4) | lo).astype(np.uint8).view(np.int8)


def unpack_int4(packed):
    """Inverse of :func:`pack_int4`."""
    b = np.asarray(packed, np.int8)
    lo = (b.astype(np.int8) << 4).astype(np.int8) >> 4
    hi = b >> 4
    out = np.stack([lo, hi], axis=-1)
    return out.reshape(b.shape[:-1] + (b.shape[-1] * 2,))


def _i4_group(in_units, group_size):
    """Largest divisor of ``in_units`` <= the requested group size —
    group boundaries must tile the input dim exactly."""
    g = max(1, min(int(group_size), in_units))
    while in_units % g:
        g -= 1
    return g


def quantize_tensor(w, bits=8, group_size=64):
    """One float weight (O, I) → (payload, float32 scales) on its device:
    int8 (O, I) and (O,) for ``bits=8``; for ``bits=4`` packed (O, I/2)
    and (O, I / g), g = ``_i4_group(I, group_size)``.  Computed in
    float32 in the reference's order, so the bits equal its numpy
    result."""
    w = w.detach().float()
    O, I = w.shape
    # a true division everywhere: CUDA's division by a Python number
    # multiplies by its reciprocal, one ulp away now and then
    levels = torch.tensor(127.0 if bits == 8 else 7.0, device=w.device)
    if bits == 8:
        s = torch.clamp_min(w.abs().amax(dim=1), 1e-8) / levels
        q = torch.clamp(torch.round(w / s[:, None]), -127, 127)
        return q.to(torch.int8), s
    if bits != 4:
        raise MXTPUError("weight-only bits must be 8 or 4, got %r" % (bits,))
    if I % 2:
        raise MXTPUError("int4 packing needs an even input dim, got %d" % I)
    gs = _i4_group(I, group_size)
    wg = w.reshape(O, I // gs, gs)
    s = torch.clamp_min(wg.abs().amax(dim=2), 1e-8) / levels
    q = torch.clamp(torch.round(wg / s[..., None]), -7, 7).to(
        torch.int32).reshape(O, I)
    del wg
    packed = ((q[:, 1::2] & 0xF) << 4) | (q[:, 0::2] & 0xF)
    return packed.to(torch.uint8).view(torch.int8), s


def _flat(x, flatten):
    return x.reshape(x.shape[0], -1) if flatten and x.dim() > 2 else x


def wq_matmul_i8(x, qweight, wscale, bias=None, flatten=False,
                 no_bias=False):
    """Weight-only int8 matmul: ``(x @ q^T) * s (+ bias)``, qweight (O,
    I) int8, wscale (O,) float32, float32 sums rounded once to x's
    dtype (G3 on the card)."""
    if wscale.dim() != 1:
        raise MXTPUError("wq_matmul_i8: wscale must be (O,), got %s"
                         % (tuple(wscale.shape),))
    return _linear.wq_matmul(_flat(x, flatten), qweight, wscale,
                             bias=None if no_bias else bias)


def wq_matmul_i4(x, qweight, wscale, bias=None, flatten=False,
                 no_bias=False, group_size=0, in_units=0):
    """Weight-only int4 matmul: qweight (O, I/2) two nibbles a byte (even
    input index low), wscale (O, G) one scale a channel and input group
    of ``group_size`` (I / G where 0); each group's float32 sum is
    scaled and added in k order (G4 on the card)."""
    x = _flat(x, flatten)
    K = x.shape[-1]
    if wscale.dim() != 2 or (in_units and int(in_units) != K) or (
            group_size and int(group_size) * wscale.shape[1] != K):
        raise MXTPUError("wq_matmul_i4: wscale %s, group size %d and "
                         "in_units %d do not fit x %s"
                         % (tuple(wscale.shape), group_size, in_units,
                            tuple(x.shape)))
    return _linear.wq_matmul(x, qweight, wscale,
                             bias=None if no_bias else bias)


def wq_matmul_i8_q8(x, qweight, wscale, bias=None, head_dim=0,
                    flatten=False, no_bias=False):
    """``wq_matmul_i8`` with the int8 cache's quantizer as its epilogue,
    per ``head_dim`` group of the output axis: ((..., O) int8 payload,
    (..., O / head_dim) float32 scales), the bits of projecting and then
    quantizing at the cache write (the reference's definition), in one
    G3 launch on the card."""
    if wscale.dim() != 1:
        raise MXTPUError("wq_matmul_i8_q8: wscale must be (O,), got %s"
                         % (tuple(wscale.shape),))
    O = qweight.shape[0]
    _, q, s = _linear.wq_matmul_q8(_flat(x, flatten), qweight, wscale,
                                   int(head_dim) or O, O,
                                   bias=None if no_bias else bias)
    return q, s


class QuantizedLinear(nn.Module):
    """A weight-only quantized dense layer (the port of
    ``QuantizedDense``): the int8 payload ``weight`` ((O, I), or (O,
    I/2) packed int4) and its float32 ``wscale`` ((O,), or (O, I / g))
    as frozen parameters, ``bits`` and ``group_size`` (0 for int8), an
    optional float32 ``bias``.  ``forward`` is the op; :meth:`normed` the
    op of ``rms_norm(x, gamma)`` in one launch (the decode step's and
    the verify window's normed projections)."""

    def __init__(self, in_features, out_features, bits=8, group_size=64,
                 bias=False, device=None):
        super().__init__()
        if bits not in (8, 4):
            raise MXTPUError("weight-only bits must be 8 or 4, got %r"
                             % (bits,))
        if bits == 4 and in_features % 2:
            raise MXTPUError("int4 packing needs an even input dim, got %d"
                             % in_features)
        self.in_features = in_features
        self.out_features = out_features
        self.bits = bits
        self.group_size = _i4_group(in_features, group_size) \
            if bits == 4 else 0
        wshape = ((out_features, in_features) if bits == 8
                  else (out_features, in_features // 2))
        sshape = ((out_features,) if bits == 8
                  else (out_features, in_features // self.group_size))
        frozen = dict(requires_grad=False)
        self.weight = nn.Parameter(torch.zeros(wshape, dtype=torch.int8,
                                               device=device), **frozen)
        self.wscale = nn.Parameter(torch.ones(sshape, dtype=torch.float32,
                                              device=device), **frozen)
        self.bias = nn.Parameter(torch.zeros(
            out_features, dtype=torch.float32, device=device), **frozen) \
            if bias else None

    @classmethod
    def from_linear(cls, linear, bits=8, group_size=64):
        """The quantized replacement of an initialized ``nn.Linear``, on
        its device (its bias kept in float32)."""
        w = linear.weight
        if isinstance(w, nn.parameter.UninitializedParameter) or w.is_meta:
            raise MXTPUError("quantize_weights: a weight is uninitialized "
                             "— initialize the model first")
        O, I = w.shape
        q = cls(I, O, bits, group_size, bias=linear.bias is not None,
                device=w.device)
        payload, scales = quantize_tensor(w, bits, q.group_size or group_size)
        with torch.no_grad():
            q.weight.copy_(payload)
            q.wscale.copy_(scales)
            if linear.bias is not None:
                q.bias.copy_(linear.bias.float())
        return q

    def forward(self, x):
        return _linear.wq_matmul(x, self.weight, self.wscale,
                                 bias=self.bias)

    def normed(self, x, gamma, eps=1e-6):
        """``self(rms_norm(x, gamma, eps))`` with the norm inside the
        launch (G2 fused into G3 or G4): the bits of the row-invariant
        norm (``rows_rms_norm``) then the op."""
        return _linear.wq_matmul(x, self.weight, self.wscale, gamma,
                                 self.bias, eps)

    def extra_repr(self):
        return "%d -> %d, int%d%s" % (
            self.in_features, self.out_features, self.bits,
            ", gs=%d" % self.group_size if self.bits == 4 else "")


def quantize_weights(model, bits=8, group_size=64, rules=None, exclude=()):
    """Rewrite every ``nn.Linear`` under ``model`` in place into a
    :class:`QuantizedLinear` (weight-only int8 or int4, quantized on the
    weights' device; activations and the KV cache are untouched).  For
    a ``TransformerLM``: each layer's qkv, out_proj, gate, up and down
    and the ``lm_head``; the embedding is never touched.  ``exclude``:
    substrings of the reference's parameter names to leave in float
    (e.g. ``("lm_head",)``).  Returns the quantized weights' names
    (prefix-stripped reference names, ``layer0_attn_qkv_weight`` ...:
    the reference's ``quantized_params``).  Raises on an uninitialized
    (meta or lazy) weight and when nothing was quantized.

    ``rules`` (the reference's tensor-parallel ShardingRules) waits for
    the port's sharding (ROADMAP A6): anything but None raises."""
    from ..models.convert import mxtpu_name

    if bits not in (8, 4):
        raise MXTPUError("weight-only bits must be 8 or 4, got %r" % (bits,))
    if rules is not None:
        raise MXTPUError("quantize_weights: rules= (tensor-parallel "
                         "sharding) is not ported yet")
    quantized = []

    def walk(parent, prefix):
        for name, child in list(parent.named_children()):
            path = prefix + name
            if type(child) is nn.Linear:
                pname = mxtpu_name(path + ".weight")
                if any(token in pname for token in exclude):
                    continue
                setattr(parent, name,
                        QuantizedLinear.from_linear(child, bits, group_size))
                quantized.append(pname)
            else:
                walk(child, path + ".")

    walk(model, "")
    if not quantized:
        raise MXTPUError("quantize_weights: no nn.Linear layer found under "
                         "%s" % type(model).__name__)
    return tuple(quantized)
