"""Carry weights from the JAX reference into the port.

``load_mxtpu_params`` takes ``{name: numpy array}`` as exported from the
reference block's ``collect_params()`` (``p.data().asnumpy()`` per
parameter) and copies it into a port ``TransformerLM`` or a port Gluon
block (a ResNet).  Names are matched with the outermost ``<block><N>_``
instance prefix stripped, as the reference's own decoder does
(``transformerlm1_embed_weight`` → ``embed_weight``,
``resnetv10_stage1_conv0_weight`` → ``stage1_conv0_weight``), so the same
architecture maps one to one whatever instance counter the exporting
process had reached.  A Gluon block names its tensors itself
(``HybridBlock.collect_params``: every conv weight and bias, BatchNorm's
gamma, beta and running statistics, the Dense output); the transformer's
names follow from its module paths (``mxtpu_name``).  Dense and conv
weights have the same layout in both frameworks and copy as they are.

``export_mxtpu_params`` is the inverse: a port model's parameters (and
running statistics) as ``{prefix-stripped reference name: numpy array}``,
which ``load_mxtpu_params`` takes back as they are.  Under tensor
parallelism a sharded ``TransformerLM`` loads each rank's slice of the
whole arrays and exports the whole arrays gathered from every rank.

A model quantized by ``contrib.quantization.quantize_weights`` carries
each quantized layer's int8 payload and float32 scales under the
reference's ``QuantizedDense`` names (``layer0_attn_qkv_weight``,
``layer0_attn_qkv_wscale``, ...), copied as they are: int8 stays int8,
so a model quantized by the reference loads into a port model quantized
the same way, and back.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..base import MXTPUError

__all__ = ["load_mxtpu_params", "export_mxtpu_params", "mxtpu_name",
           "strip_instance_prefix"]

# port module path → reference parameter name suffix, where the two
# differ by more than "." vs "_"
_RENAMES = (("attn.out_proj.", "attn_out_"), ("gate_proj.", "gate_"),
            ("up_proj.", "up_"), ("down_proj.", "down_"))


def strip_instance_prefix(name: str) -> str:
    """Drop the outermost ``<block><N>_`` instance prefix of a reference
    parameter name (the port's copy of ``_strip_instance_prefix`` in
    mxtpu/parallel/decode.py)."""
    return re.sub(r"^[a-z][a-z0-9]*?\d+_", "", name)


def mxtpu_name(torch_name: str) -> str:
    """The reference's (prefix-stripped) name of a port parameter:
    ``layers.0.attn.qkv.weight`` → ``layer0_attn_qkv_weight``."""
    name = re.sub(r"^layers\.(\d+)\.", r"layer\1_", torch_name)
    for old, new in _RENAMES:
        name = name.replace(old, new)
    return name.replace(".", "_")


def _named_tensors(model):
    """``{prefix-stripped reference name: tensor}`` of a port model."""
    if hasattr(model, "collect_params"):
        return model.collect_params()
    return {mxtpu_name(n): p for n, p in model.named_parameters()}


def load_mxtpu_params(model, params, mesh=None, rules=None):
    """Copy the reference's parameters ``{name: array}`` into ``model``
    in place (cast to each parameter's dtype and device).  Raises
    :class:`MXTPUError` on a missing name, an extra name or a shape
    that differs.

    Tensor parallelism: with ``mesh`` and ``rules`` a ``TransformerLM``
    is first sharded by them (``TransformerLM.shard``); a sharded model
    loads this rank's slice of each whole reference array."""
    if mesh is not None and hasattr(model, "shard"):
        model.shard(mesh, rules)
    local = getattr(model, "_local_slice", None)
    if getattr(model, "_tp_shard", None) is None:
        local = None
    wanted = _named_tensors(model)
    # a name that is already the port's (export_mxtpu_params's output)
    # keeps its form: stripping would cut ``layer0_`` off it
    given = {k if k in wanted else strip_instance_prefix(k): v
             for k, v in params.items()}
    if len(given) != len(params):
        raise MXTPUError("two reference parameters share a name once the "
                         "instance prefix is stripped")
    missing = sorted(set(wanted) - set(given))
    extra = sorted(set(given) - set(wanted))
    if missing or extra:
        raise MXTPUError("parameter names differ: missing %s, extra %s"
                         % (missing, extra))
    for name, p in wanted.items():
        src = (local(name, given[name]) if local is not None
               else torch.as_tensor(np.array(given[name])))
        if tuple(src.shape) != tuple(p.shape):
            raise MXTPUError("parameter %s: reference shape %s, port shape "
                             "%s" % (name, tuple(src.shape), tuple(p.shape)))
        with torch.no_grad():
            p.copy_(src.to(device=p.device, dtype=p.dtype))
    return model


def export_mxtpu_params(model):
    """``{reference name: numpy array}`` of ``model``'s parameters, names
    without an instance prefix (what :func:`load_mxtpu_params` takes);
    bfloat16 parameters come out as float32.  A sharded ``TransformerLM``
    gathers its whole arrays first (a collective: every rank of its tp
    axis calls this, and every rank gets the whole arrays)."""
    out = {}
    named = (model.gathered_params()
             if getattr(model, "_tp_shard", None) is not None
             else _named_tensors(model))
    for name, p in named.items():
        t = p.detach().cpu()
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out
