"""Int8 quantization (the port of ``mxtpu/contrib/quantization.py``):
weight-only int8/int4 serving (``pack_int4`` / ``unpack_int4``,
``_i4_group``, ``wq_matmul_i8``, ``wq_matmul_i8_q8``, ``wq_matmul_i4``,
the reference's ``QuantizedDense`` as :class:`QuantizedLinear`, and
``quantize_weights``), and int8 post-training quantization of
activations and weights (``quantize_v2``, ``dequantize_v2``,
``quantized_fully_connected``, ``quantized_conv``, calibration's
``optimal_thresholds`` and ``_Collector``, and ``quantize_net``; below
the weight-only part).

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

import copy

import numpy as np
import torch
from torch import nn

from ..base import MXTPUError
from ..gluon.block import HybridBlock
from ..gluon.nn import Conv2D, Dense
from ..ops import linear as _linear
from ..ops import quantized as _q
from ..ops.linear import wq_matmul_i4_plain, wq_matmul_i8_plain
from ..ops.tensor import _levels

__all__ = ["pack_int4", "unpack_int4", "quantize_tensor", "wq_matmul_i8",
           "wq_matmul_i8_q8", "wq_matmul_i4", "wq_matmul_i8_plain",
           "wq_matmul_i4_plain", "QuantizedLinear", "quantize_weights",
           "quantize_v2", "dequantize_v2", "quantized_fully_connected",
           "quantized_conv", "optimal_thresholds", "QuantizedConv2D",
           "QuantizedDense", "quantize_net"]


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

    ``rules``: the model's tensor-parallel ``ShardingRules``; then the
    return is a NEW ``ShardingRules`` extending them with an exact-name
    rule for each ``wscale`` (an int8 scale splits with its weight's
    output channels; int4 group scales split the output channels and
    keep the group axis whole), its ``quantized_params`` the names
    above, as the reference returns it.  The whole weight is quantized
    before any split, so each shard's payload and scales are the slice
    of the unsharded ones (``parallel.sharding``: a row-parallel int4
    weight's scales are cut with its input groups)."""
    import re

    from ..models.convert import mxtpu_name
    from ..parallel.sharding import PartitionSpec, ShardingRules

    if bits not in (8, 4):
        raise MXTPUError("weight-only bits must be 8 or 4, got %r" % (bits,))
    if rules is not None and not isinstance(rules, ShardingRules):
        raise MXTPUError("quantize_weights: rules must be ShardingRules, not "
                         "%s" % type(rules).__name__)
    out_rules = None if rules is None else ShardingRules(rules.iter_rules())
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
                if out_rules is not None:
                    wspec = tuple(rules.spec_for(pname, 2))
                    col = wspec[0] if wspec else None
                    sname = pname[:-len("weight")] + "wscale"
                    out_rules.add(re.escape(sname) + "$",
                                  PartitionSpec(col) if bits == 8
                                  else PartitionSpec(col, None))
            else:
                walk(child, path + ".")

    walk(model, "")
    if not quantized:
        raise MXTPUError("quantize_weights: no nn.Linear layer found under "
                         "%s" % type(model).__name__)
    if out_rules is None:
        return tuple(quantized)
    out_rules.quantized_params = tuple(quantized)
    return out_rules


# -- int8 post-training quantization of activations and weights ----------
# The reference's _contrib_quantize_v2 / _contrib_dequantize_v2 /
# _contrib_quantized_fully_connected / _contrib_quantized_conv, in its
# order of arithmetic: s = max(max(|mn|, |mx|), 1e-8) / 127 in float32,
# q = clip(round(x / s), -127, 127) (half to even) as int8, int32 sums,
# then acc * (s_x * s_w) (the two scales multiplied first) + bias.  The
# products run Q1 and Q2 (ops/quantized.py) on a CUDA tensor and their
# plain versions on a CPU one; a quantized conv's input is quantized by
# Q3 where Q1 reads it channels-last.  Every division is by a 0-dim
# tensor on the operand's device: CUDA divides by a Python number
# through its reciprocal.

def _range(v, device):
    """A range end as a 0-dim float32 tensor on ``device``: a tensor as
    it is (cast), a number rounded once to float32, as the reference's
    ``jnp.asarray(v, jnp.float32)``."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _q_scale(mn, mx):
    """Symmetric int8 scale of a (possibly asymmetric) float32 range."""
    return torch.clamp_min(torch.maximum(mn.abs(), mx.abs()), 1e-8) / \
        _levels(mn.device)


def _input_range(x, min_calib_range, max_calib_range):
    """The range ``quantize_v2`` quantizes float32 x by: the calibrated
    ends where given, else x's own min and max (0-dim float32 tensors on
    x's device)."""
    if min_calib_range is None and max_calib_range is None:
        return torch.aminmax(x)
    mn = x.amin() if min_calib_range is None else \
        _range(min_calib_range, x.device)
    mx = x.amax() if max_calib_range is None else \
        _range(max_calib_range, x.device)
    return mn, mx


def quantize_v2(x, min_calib_range=None, max_calib_range=None):
    """float → (int8 payload, min, max), symmetric: the range is the
    calibrated one where given, else the tensor's own min and max (0-dim
    float32 tensors on x's device).  The payload keeps x's layout (NCHW
    for an NCHW x)."""
    x = x.float()
    mn, mx = _input_range(x, min_calib_range, max_calib_range)
    t = x / _q_scale(mn, mx)
    q = t.round_().clamp_(-127, 127).to(torch.int8)
    return q, mn, mx


def dequantize_v2(q, mn, mx):
    """The inverse of :func:`quantize_v2`: q * its scale, float32."""
    return q.float() * _q_scale(_range(mn, q.device), _range(mx, q.device))


def _combined_scale(x, x_min, x_max, w_min, w_max):
    dev = x.device
    return _q_scale(_range(x_min, dev), _range(x_max, dev)) * \
        _q_scale(_range(w_min, dev), _range(w_max, dev))


def quantized_fully_connected(x, weight, x_min, x_max, w_min, w_max,
                              bias=None, num_hidden=0, no_bias=False,
                              flatten=True):
    """int8 x (..., K) times int8 weight (N, K)ᵀ, int32 sums, scaled by
    the two ranges' scales, plus the float32 bias (Q2 on the card);
    ``flatten`` folds every axis after the first."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    scale = _combined_scale(x, x_min, x_max, w_min, w_max)
    b = None if no_bias or bias is None else bias.float()
    lead = x.shape[:-1]
    y = _q.qfc(x.reshape(-1, x.shape[-1]), weight, scale, b)
    return y.reshape(*lead, weight.shape[0])


def quantized_conv(x, weight, x_min, x_max, w_min, w_max, bias=None,
                   kernel=(), stride=(), dilate=(), pad=(), num_filter=0,
                   num_group=1, no_bias=False, packed_weight=None):
    """int8 (N, C, H, W) convolution with OIHW int8 weights, int32 sums,
    scaled by the two ranges' scales, plus the float32 bias per channel
    (Q1 on the card; x stored NCHW, or channels-last as Q3 writes it).
    2-D only: 1-D and 3-D raise.  ``packed_weight``: the weights as
    ``ops.quantized.pack_weight`` gives them for x's layout, which a
    quantized layer keeps (packed on each call otherwise)."""
    ndim = len(kernel) if kernel else x.dim() - 2
    if ndim != 2 or x.dim() != 4:
        raise MXTPUError("quantized_conv: only 2-D NCHW is ported, got a "
                         "%d-D kernel on a %d-D input" % (ndim, x.dim()))
    scale = _combined_scale(x, x_min, x_max, w_min, w_max)
    b = None if no_bias or bias is None else bias.float()
    return _q.qconv(x, weight, scale, b, tuple(stride) or (1, 1),
                    tuple(pad) or (0, 0), tuple(dilate) or (1, 1),
                    num_group, packed=packed_weight)


# -- calibration (host numpy, as the reference's) ------------------------

def optimal_thresholds(hist, hist_edges, num_quantized_bins=255):
    """KL-divergence-optimal |threshold| from a symmetric histogram
    (the reference's own search, copied): P is the windowed histogram
    with clipped outlier mass folded into its edge bins; Q is the window
    re-binned to num_quantized_bins WITHOUT the outlier mass.  Returns
    the |edge| minimizing KL(P||Q)."""
    num_bins = len(hist)
    zero = num_bins // 2
    best_kl, best_t = np.inf, abs(hist_edges[-1])
    for i in range(num_quantized_bins // 2, zero + 1):
        lo, hi = zero - i, zero + i
        sliced = hist[lo:hi].astype(np.float64)
        p = sliced.copy()
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        if p.sum() == 0:
            continue
        # re-bin the (outlier-free) window to the quantized grid, then
        # expand back over the nonzero support of the window
        factor = len(sliced) / num_quantized_bins
        q = np.zeros_like(sliced)
        for j in range(num_quantized_bins):
            a = int(np.floor(j * factor))
            b = min(int(np.ceil((j + 1) * factor)), len(sliced))
            chunk = sliced[a:b]
            cnt = (chunk > 0).sum()
            if cnt:
                q[a:b][chunk > 0] = chunk.sum() / cnt
        p_n = p / p.sum()
        if q.sum() == 0:
            continue
        q_n = q / q.sum()
        support = p_n > 0
        q_s = np.where(q_n[support] > 0, q_n[support], 1e-10)
        kl = float(np.sum(p_n[support] * np.log(p_n[support] / q_s)))
        if kl < best_kl:
            best_kl = kl
            best_t = abs(hist_edges[hi])
    return best_t


class _Collector:
    """Per-layer input statistics over calibration batches.  ``naive``
    takes each batch's min and max on its device (two floats cross to
    the host); ``entropy`` also histograms it, on the host."""

    def __init__(self, mode, num_bins=2048):
        self.mode = mode
        self.num_bins = num_bins
        self.minmax = {}
        self.hists = {}

    def update(self, name, arr):
        if self.mode == "entropy":
            arr = arr.detach().float().cpu().numpy()
            mn, mx = float(arr.min()), float(arr.max())
        else:
            mn, mx = (float(v) for v in torch.aminmax(arr.detach()))
        if name in self.minmax:
            omn, omx = self.minmax[name]
            self.minmax[name] = (min(mn, omn), max(mx, omx))
        else:
            self.minmax[name] = (mn, mx)
        if self.mode == "entropy":
            th = max(abs(mn), abs(mx), 1e-8)
            hist, edges = np.histogram(arr, bins=self.num_bins,
                                       range=(-th, th))
            self.hists.setdefault(name, []).append((hist, edges))

    def ranges(self):
        out = {}
        for name, (mn, mx) in self.minmax.items():
            if self.mode == "entropy":
                # merge per-batch histograms onto one grid spanning the
                # global range (midpoint re-binning), then KL-search
                th = max(abs(mn), abs(mx), 1e-8)
                edges = np.linspace(-th, th, self.num_bins + 1)
                grid = np.zeros(self.num_bins, np.int64)
                for h, e in self.hists[name]:
                    mids = (e[:-1] + e[1:]) / 2
                    idx = np.clip(np.searchsorted(edges, mids) - 1, 0,
                                  self.num_bins - 1)
                    np.add.at(grid, idx, h)
                t = optimal_thresholds(grid, edges)
                out[name] = (-t, t)
            else:
                out[name] = (mn, mx)
        return out


# -- the quantized layers and quantize_net -------------------------------

def _quantize_param(w):
    """``quantize_params``'s arithmetic for one float weight, expression
    for expression (mxtpu/contrib/quantization.py:522-528), in numpy on
    the host: (int8 payload, qmin, qmax)."""
    w = w.detach().float().cpu().numpy()
    t = max(abs(w.min()), abs(w.max()), 1e-8)
    scale = t / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, np.float32(-t), np.float32(t)


class _QuantizedLayer(HybridBlock):
    """What the reference's quantized node holds: the int8 payload
    ``weight_quantized`` and its range ``weight_qmin``/``weight_qmax``
    (0-dim float32), the float32 ``bias`` (or none), all buffers named
    as the reference's parameters, and the calibrated input range
    (``min_calib_range``, ``max_calib_range``: floats, or None for each
    batch's own; kept on the device once a forward has run there).  It
    takes the name of the layer it replaces (its prefix, and its alias
    through ``_alias``), so ``collect_params`` and the weight bridge give
    the reference's names (``dense0_weight_quantized`` ...)."""

    def __init__(self, wshape, use_bias, calib_range, prefix, device):
        super().__init__(prefix)
        self.min_calib_range, self.max_calib_range = \
            calib_range if calib_range is not None else (None, None)
        self._calib = (None, None, None)
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("weight_quantized",
                             torch.zeros(wshape, dtype=torch.int8,
                                         device=device))
        self.register_buffer("weight_qmin", torch.zeros((), **f32))
        self.register_buffer("weight_qmax", torch.zeros((), **f32))
        self.register_buffer("bias", torch.zeros(wshape[0], **f32)
                             if use_bias else None)

    def _take(self, layer):
        q, mn, mx = _quantize_param(layer.weight)
        with torch.no_grad():
            self.weight_quantized.copy_(torch.from_numpy(q))
            self.weight_qmin.fill_(float(mn))
            self.weight_qmax.fill_(float(mx))
            if self.bias is not None:
                self.bias.copy_(layer.bias.detach().float())
        return self

    def _quantize(self, x, channels_last=False):
        """``quantize_v2`` of x with the layer's range; ``channels_last``:
        the payload written channels-last by Q3 (``ops/quantized.py:
        quantize_nhwc``; float32 NCHW-contiguous x, C a multiple of 16),
        the same values."""
        rng = (None, None)
        if self.min_calib_range is not None:
            if self._calib[0] != x.device:
                self._calib = (x.device,
                               _range(self.min_calib_range, x.device),
                               _range(self.max_calib_range, x.device))
            rng = self._calib[1:]
        if not channels_last:
            return quantize_v2(x, *rng)
        mn, mx = _input_range(x, *rng)
        return _q.quantize_nhwc(x, _q_scale(mn, mx)), mn, mx

    def extra_repr(self):
        rng = ("runtime range" if self.min_calib_range is None else
               "calibrated [%g, %g]" % (self.min_calib_range,
                                        self.max_calib_range))
        return "%s, int8, %s" % (tuple(self.weight_quantized.shape), rng)


class QuantizedConv2D(_QuantizedLayer):
    """A ``Conv2D`` quantized as the reference's ``_contrib_quantize_v2``
    then ``_contrib_quantized_conv`` nodes: its input quantized with the
    calibrated range, then Q1 on the int8 weights.  x is taken NCHW
    (copied so if it is stored otherwise); where its input channels a
    group are a multiple of 16, Q3 writes the payload channels-last and
    Q1 reads it so (every ResNet-50 conv but the stem); else the payload
    is NCHW (the stem's route at most 4 channels a group).  It keeps the
    weights packed as Q1 reads them too for the payload's route
    (``ops.quantized.route``), repacked when the route or the weights
    change."""

    def __init__(self, channels, in_channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, use_bias=True,
                 calib_range=None, prefix=None, device=None):
        kernel_size = tuple(kernel_size)
        super().__init__((channels, in_channels // groups) + kernel_size,
                         use_bias, calib_range, prefix, device)
        self._kwargs = {"kernel": kernel_size, "stride": tuple(strides),
                        "dilate": tuple(dilation), "pad": tuple(padding),
                        "num_filter": channels, "num_group": groups}
        self._nhwc = (in_channels // groups) % 16 == 0
        self._pack = (None, None)

    @classmethod
    def from_layer(cls, conv, calib_range):
        kw = conv._kwargs
        Co, Cg = conv.weight.shape[:2]
        return cls(Co, Cg * kw["num_group"], kw["kernel"], kw["stride"],
                   kw["pad"], kw["dilate"], kw["num_group"],
                   conv.bias is not None, calib_range, conv.prefix,
                   conv.weight.device)._take(conv)

    def _alias(self):
        return "conv"

    def _packed(self, q):
        """The weights packed for the payload q's route, kept until the
        weights or the route change; None off the card (the plain route
        reads w itself)."""
        w = self.weight_quantized
        if w.device.type != "cuda" or q.dim() != 4:
            return None
        kw = self._kwargs
        form = _q.route(q, kw["num_group"], kw["kernel"],
                        kw["dilate"] or (1, 1))
        key = (w.data_ptr(), w._version, form)
        if self._pack[0] != key:
            self._pack = (key, _q.pack_weight(w, form == "nhwc",
                                              form == "stem"))
        return self._pack[1]

    def forward(self, x):
        # one layout for the payload and the packed weights: x NCHW, then
        # the payload channels-last by Q3 where the channels allow it
        x = x.float().contiguous()
        nhwc = self._nhwc and x.dim() == 4
        q, mn, mx = self._quantize(x, nhwc)
        return quantized_conv(q, self.weight_quantized, mn, mx,
                              self.weight_qmin, self.weight_qmax, self.bias,
                              no_bias=self.bias is None,
                              packed_weight=self._packed(q),
                              **self._kwargs)


class QuantizedDense(_QuantizedLayer):
    """A ``Dense`` quantized as the reference's ``_contrib_quantize_v2``
    then ``_contrib_quantized_fully_connected`` nodes (Q2 on the card).
    Not the reference's ``QuantizedDense``, the weight-only layer, which
    is :class:`QuantizedLinear` here."""

    def __init__(self, units, in_units, use_bias=True, flatten=True,
                 calib_range=None, prefix=None, device=None):
        super().__init__((units, in_units), use_bias, calib_range, prefix,
                         device)
        self._flatten = flatten

    @classmethod
    def from_layer(cls, dense, calib_range):
        units, in_units = dense.weight.shape
        return cls(units, in_units, dense.bias is not None, dense._flatten,
                   calib_range, dense.prefix, dense.weight.device
                   )._take(dense)

    def _alias(self):
        return "dense"

    def forward(self, x):
        q, mn, mx = self._quantize(x)
        return quantized_fully_connected(
            q, self.weight_quantized, mn, mx, self.weight_qmin,
            self.weight_qmax, self.bias, num_hidden=self.weight_quantized.
            shape[0], no_bias=self.bias is None, flatten=self._flatten)


_QUANTIZED = {Conv2D: ("convolution", QuantizedConv2D),
              Dense: ("fullyconnected", QuantizedDense)}


def _layers(network):
    """(node name, module path, layer) of every ``Conv2D`` and ``Dense``
    under ``network``: ``convolution<i>`` and ``fullyconnected<i>``,
    counted from 0 in the order ``named_modules`` visits them."""
    counts, out = {}, []
    for path, mod in network.named_modules():
        kind = _QUANTIZED.get(type(mod))
        if kind is not None:
            i = counts.get(kind[0], 0)
            counts[kind[0]] = i + 1
            out.append(("%s%d" % (kind[0], i), path, mod))
    return out


def _calibrate(network, targets, calib_data, mode, num_examples,
               data_names):
    """Forwards of the float net in eval mode over the calibration
    batches, each target layer's INPUT (the tensor it will quantize)
    collected by a forward hook; stops once ``num_examples`` have run."""
    collector = _Collector(mode)
    device = next(network.buffers(), None)
    device = next(network.parameters()).device if device is None \
        else device.device
    hooks = [layer.register_forward_hook(
        lambda mod, args, out, name=name: collector.update(name, args[0]))
        for name, _, layer in targets]
    training = network.training
    network.eval()
    seen = 0
    try:
        with torch.no_grad():
            for batch in calib_data:
                if isinstance(batch, dict):
                    batch = batch[data_names[0]]
                x = torch.as_tensor(batch).to(device)
                network(x)
                seen += x.shape[0]
                if num_examples and seen >= num_examples:
                    break
    finally:
        for h in hooks:
            h.remove()
        network.train(training)
    return collector.ranges()


def quantize_net(network, quantized_dtype="int8", exclude_layers=(),
                 calib_data=None, calib_mode="naive",
                 num_calib_examples=None, data_names=("data",), ctx=None,
                 logger=None):
    """A quantized copy of a port Gluon block (the reference's
    ``quantize_net``): every ``Conv2D`` and ``Dense`` not excluded
    becomes a :class:`QuantizedConv2D` or :class:`QuantizedDense`, whose
    input is quantized with its calibrated range and multiplied by its
    int8 weights (Q1 and Q2 on the card); the rest stays float.  The
    copy is returned in eval mode, on the net's device; ``network`` is
    left as it was.

    - ``exclude_layers``: layer names to keep float.  A layer is named
      ``convolution<i>`` or ``fullyconnected<i>``, counted from 0 within
      the net in the order ``named_modules`` visits them, which is
      forward order for ``HybridSequential`` and the model zoo's nets.
      (The reference names its traced nodes by a counter global to the
      process, so a second net traced there starts past 0.)
    - ``calib_mode``: ``naive`` (each layer's input min and max over the
      batches), ``entropy`` (KL-optimal symmetric thresholds of their
      histograms) or ``none`` (each batch's own range at run time).
    - ``calib_data``: an iterable of batches (numpy arrays or tensors, or
      dicts keyed by ``data_names[0]``); ``num_calib_examples``: stop
      once that many examples have run.  Calibration runs the float net
      in eval mode (BatchNorm's running statistics, as the reference's
      executor forward), under ``torch.no_grad``.

    ``ctx`` and ``logger`` are accepted for the reference's signature."""
    if quantized_dtype != "int8":
        raise MXTPUError("only int8 quantization is supported")
    excluded = set(exclude_layers)
    targets = [t for t in _layers(network) if t[0] not in excluded]
    if not targets:
        raise MXTPUError("quantize_net: nothing to quantize")
    for name, _, layer in targets:
        if layer.weight.is_meta:
            raise MXTPUError("quantize_net: layer %s is uninitialized" % name)
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise MXTPUError("calib_mode=%r needs calib_data" % calib_mode)
        ranges = _calibrate(network, targets, calib_data, calib_mode,
                            num_calib_examples, data_names)
    elif calib_mode == "none":
        ranges = {name: None for name, _, _ in targets}
    else:
        raise MXTPUError("unknown calib_mode %r" % calib_mode)
    qnet = copy.deepcopy(network)
    for name, path, layer in targets:
        qlayer = _QUANTIZED[type(layer)][1].from_layer(layer, ranges[name])
        if not path:
            return qlayer.eval()
        parent, _, attr = path.rpartition(".")
        setattr(qnet.get_submodule(parent), attr, qlayer)
    return qnet.eval()
