"""K2's tensor-core route (``csrc/prefill_attention.cu``,
``prefill_tc_kernel``) on the CPU: its arithmetic emulated in PyTorch,
its route and its launch plan.

The emulation follows the kernel step for step: S = Q.K^T from bf16
operands with float32 sums, times sm_scale in float32 (and first times
the key's scale over an int8 pool, whose payloads are exact in bf16);
masked scores at -1e30 give p = 0; the online softmax over 32-key tiles
with float32 state; P (times the value's scale over an int8 pool) as
two bf16 terms for P.V, hi = bf16(p) and lo = bf16(p - hi), with l
summing the float32 P; each cluster
split walking every splits-th tile of its lane group's keys; and the
splits' (m, l, acc) combined in split order.  At Llama-3-8B's geometry
(head_dim 128, block 16, 8 kv heads, rep 4, 64-token chunks) it is held
within the card's bfloat16 tolerance (2e-2 max abs, ``chip_smoke.TOL``)
of the port's plain version and of the JAX reference's
``xla_reference``, on the same seeded numpy inputs, at the main path's
chunks starting at 256 and 576, over bf16 and int8 pools.  What the
emulation cannot show is the tensor cores' own summation order, which
the card's tests hold (``tests/test_torch_cuda.py``).

The plan (``prefill_attention._tc_plan``): every fold lane in exactly one
lane group, every key tile in exactly one split, and one block's shared
memory within the H100's 232,448 bytes at every geometry of the card
tests."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ops.pallas import prefill_attention as jpf
from mxtpu_torch.ops import prefill_attention as pf
from mxtpu_torch.ops.tensor import _q8_quantize
from test_torch_cuda import GEOMETRIES

#: the card's bfloat16 tolerance for K2 against its plain version
TOL = 2e-2
LLAMA_8B = dict(D=128, bs=16, KV=8, rep=4, T=64, M=64)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split_tiles(ntiles, split, splits):
    """The key tiles one split of the cluster walks, in order: the
    kernel's ``mine`` tiles split, split + splits, ..."""
    mine = -(-(ntiles - split) // splits) if ntiles > split else 0
    return [split + i * splits for i in range(mine)]


def _emulated_tc(q, pool_k, pool_v, table, start, k_scales=None,
                 v_scales=None):
    """K2's tensor-core arithmetic on the CPU: (1, H, T, D) bf16."""
    _, H, T, D = q.shape
    _, KV, bs, _ = pool_k.shape
    M = table.shape[0]
    rep, fold = H // KV, H // KV * T
    plan = pf._tc_plan(KV, fold, D, bs, M, k_scales is not None)
    R, S, kt = 16 * plan["warps"], plan["splits"], pf._TC_KEYS
    nv = min(max((start + T - 1) // bs + 1, 1), M)
    idx = table.long()

    def gather(x):
        return x[idx].transpose(0, 1).reshape(KV, M * bs, *x.shape[3:])

    keys, values = gather(pool_k).float(), gather(pool_v).float()
    ks = vs = None
    if k_scales is not None:
        ks, vs = gather(k_scales), gather(v_scales)
    qf = q.reshape(KV, fold, D).float()
    sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty(KV, fold, D)
    for row0 in range(0, fold, R):
        rows = min(R, fold - row0)
        lim = start + torch.arange(row0, row0 + rows) % T
        t0 = row0 % T
        walk = min(nv * bs, start + min(t0 + rows - 1, T - 1) + 1)
        parts = []
        for split in range(S):
            m = torch.full((KV, rows), -1e30)
            l = torch.zeros(KV, rows)
            acc = torch.zeros(KV, rows, D)
            for j in _split_tiles(-(-walk // kt), split, S):
                key = torch.arange(j * kt, (j + 1) * kt)
                live = key < walk          # past it the tile holds zeros
                pick = key.clamp(max=M * bs - 1)
                k = keys[:, pick] * live[None, :, None]
                v = values[:, pick] * live[None, :, None]
                s = torch.einsum("kld,ktd->klt", qf[:, row0:row0 + rows], k)
                if ks is not None:
                    s = s * (ks[:, pick] * live)[:, None, :]
                s = s * sm_scale
                mask = key[None, None, :] <= lim[None, :, None]
                s = torch.where(mask, s, torch.full_like(s, -1e30))
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.where(mask, torch.exp(s - m_new[..., None]),
                                torch.zeros_like(s))
                l = l * corr + p.sum(-1)
                if vs is not None:
                    p = p * (vs[:, pick] * live)[:, None, :]
                hi = _bf16(p)
                acc = acc * corr[..., None] + torch.einsum(
                    "klt,ktd->kld", _bf16(p - hi), v) + torch.einsum(
                    "klt,ktd->kld", hi, v)
                m = m_new
            parts.append((m, l, acc))
        top = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum = torch.zeros(KV, rows)
        o = torch.zeros(KV, rows, D)
        for m, l, acc in parts:
            w = torch.exp(m - top)
            lsum = lsum + l * w
            o = o + acc * w[..., None]
        out[:, row0:row0 + rows] = o / lsum.clamp_min(1e-30)[..., None]
    return out.reshape(1, H, T, D).to(q.dtype)


def _case(start, seed, D, bs, KV, rep, T, M):
    """One chunk at ``start`` over a shuffled, null-padded table, as
    numpy float32 arrays of bf16 values: q, pools and the table."""
    rng = np.random.RandomState(seed)
    nv = (start + T - 1) // bs + 1
    table = np.zeros(M, np.int32)
    table[:nv] = rng.permutation(np.arange(1, nv + 1))
    shape = (nv + 2, KV, bs, D)

    def bf16(*s):
        return _bf16(torch.from_numpy(rng.randn(*s).astype("f"))).numpy()

    return bf16(1, KV * rep, T, D), bf16(*shape), bf16(*shape), table


@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("start", [256, 576])
def test_tensor_core_arithmetic_holds_the_card_tolerance(start, pools):
    """The emulated kernel against the plain version and the JAX
    reference at the 8B geometry, at the main path's chunk starts."""
    q, pk, pv, table = _case(start, start + (pools == "int8"), **LLAMA_8B)
    tq, tpk, tpv, ttab = map(torch.from_numpy, (q, pk, pv, table))
    tq = tq.bfloat16()
    kw, jkw = {}, {}
    if pools == "int8":
        (tpk, ks), (tpv, vs) = _q8_quantize(tpk), _q8_quantize(tpv)
        kw = dict(k_scales=ks, v_scales=vs)
        jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    else:
        tpk, tpv = tpk.bfloat16(), tpv.bfloat16()
    got = _emulated_tc(tq, tpk, tpv, ttab, start, **kw).float()
    plain = pf.paged_prefill_attention_plain(tq, tpk, tpv, ttab, start,
                                             **kw).float()
    # the reference in float32 on the same (bf16-valued or int8) inputs
    want = np.array(jpf.xla_reference(
        jnp.asarray(q), jnp.asarray(tpk.float().numpy() if pools == "bf16"
                                    else tpk.numpy()),
        jnp.asarray(tpv.float().numpy() if pools == "bf16"
                    else tpv.numpy()),
        jnp.asarray(table), start, **jkw))
    assert got.shape == (1, 32, 64, 128) and torch.isfinite(got).all()
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - torch.from_numpy(want)).abs().max()) <= TOL


def test_route_follows_the_query_dtype():
    """bf16 queries take the tensor cores, float32 queries the float32
    walk, whatever the pools."""
    assert pf.route(torch.zeros(1, 4, 8, 16,
                                dtype=torch.bfloat16)) == pf.TENSOR_CORES
    assert pf.route(torch.zeros(1, 4, 8, 16)) == pf.CUDA_CORES


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "D%d-bs%d-rep%d"
                         % (g[0], g[1], g[3]))
def test_plan_covers_every_lane_and_key_and_fits_a_block(geom, quant):
    """At every card-test geometry, with each chunk length the card tests
    and the 8B path use: the lane groups cover the fold once, the splits
    cover every key tile once whatever the walk's length, and a block
    fits the card."""
    D, bs, KV, rep, _, T, ctx = geom
    M = -(-ctx // bs) + 2
    for chunk in (T, 8, 64):
        fold = rep * chunk
        p = pf._tc_plan(KV, fold, D, bs, M, quant)
        R = 16 * p["warps"]
        assert 1 <= p["warps"] <= 4 and 1 <= p["splits"] <= 8
        assert (p["groups"] - 1) * R < fold <= p["groups"] * R
        assert p["DP"] in (16, 32, 64, 128, 256) and D <= p["DP"] < 2 * max(
            D, 16)
        assert p["stages"] in (2, 3, 4)
        assert p["smem"] == pf._tc_smem(R, p["DP"], M, quant, p["stages"])
        assert p["smem"] <= 232448
        for ntiles in range(0, -(-M * bs // pf._TC_KEYS) + 1):
            walked = [j for s in range(p["splits"])
                      for j in _split_tiles(ntiles, s, p["splits"])]
            assert sorted(walked) == list(range(ntiles))


def test_plan_fills_the_card_at_the_8b_shape():
    """8 kv heads x 4 lane groups x 4 splits: 128 blocks of 4 warps on
    the 132 SMs, a ring of 4 tiles."""
    g = LLAMA_8B
    for quant in (False, True):
        p = pf._tc_plan(g["KV"], g["rep"] * g["T"], g["D"], g["bs"], g["M"],
                        quant)
        assert (p["warps"], p["groups"], p["splits"], p["stages"]) == (4, 4,
                                                                      4, 4)
        assert g["KV"] * p["groups"] * p["splits"] == 128
