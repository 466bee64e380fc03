"""K1's tensor-core route (``csrc/paged_attention.cu``,
``decode_tc_kernel``) on the CPU: its arithmetic emulated in PyTorch,
its route and its launch plan.

The emulation follows the kernel step for step: S^T = K.Q^T from bf16
operands with float32 sums (each k16 step of an MMA as one exact sum
rounded to float32, added to the accumulator in k16 order), times the
key's scale over an int8 pool (whose payloads are exact in bf16), then
times sm_scale in float32; masked scores at -1e30 give p = 0; each
block's 4 warps own 16 keys of every 64-key tile and run their own
online softmax with float32 state (l as the 8 partial sums of a
column's threads, added over them in the kernel's shuffle order at the
end); P (times the value's scale over an int8 pool) enters O^T = V^T.P^T
as two bf16 terms, lo = bf16(p - hi) then hi = bf16(p); each of the
cluster's 4 splits walks every 4th tile; and the (m, l, O) of a block's
warps are combined in warp order, then those of the splits in split
order.  Every lane is a column of its own, so the emulation runs all
slots and lanes at once.  At Llama-3-8B's geometry (head_dim 128, block 16, 8 kv heads,
rep 4, 8 slots) it is held within the card's bfloat16 tolerance (2e-2
max abs, ``chip_smoke.TOL``) of the port's plain version and of the JAX
reference's ``xla_reference``, on the same seeded numpy inputs, at the
main path's decode step (W = 1), a W = 8 window and a W = 16 tree, over
bf16 and int8 pools.  At a small geometry it holds the kernel's three
bit-exact invariants by ``torch.equal``: (a) a chain ``anc`` gives the
bits of no ``anc``; (b) lane w of a W-lane call equals a W = 1 call at
pos + w; (c) slot b of a B-slot call equals a 1-slot call on its own
table row and position.  What the emulation cannot show is the tensor
cores' own summation, which the card's tests hold
(``tests/test_torch_cuda.py``).

The plan (``paged_attention.tc_plan``): the splits and the tile-to-split
map are the same at every W, lane count and slot count; every key tile
lies in one split and every lane in one group; one block's shared
memory stays within the H100's 232,448 bytes at every geometry of the
card tests with W up to 32 over both pool types; and the 8B decode
step's grid fills the 132 SMs."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import tree_anc
from mxtpu.ops.pallas import paged_attention as jpa
from mxtpu_torch.ops import paged_attention as pa
from mxtpu_torch.ops.tensor import _q8_quantize
from test_torch_cuda import GEOMETRIES

#: the card's bfloat16 tolerance for K1 against its plain version
TOL = 2e-2
LLAMA_8B = dict(D=128, bs=16, KV=8, rep=4, B=8, ctx=640)
NEG_INF = -1e30


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split_tiles(ntiles, split, splits):
    """The key tiles one split of the cluster walks, in order: the
    kernel's ``mine`` tiles split, split + splits, ..."""
    mine = -(-(ntiles - split) // splits) if ntiles > split else 0
    return [split + i * splits for i in range(mine)]


def _exact(eq, a, b):
    """One MMA k16 step: the products' sum taken exactly (float64 holds
    every sum of 16 bf16 products here) and rounded once to float32."""
    return torch.einsum(eq, a.double(), b.double()).float()


def _combine(parts):
    """(m, l, O) parts combined in order, as the kernel's ``combine``."""
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum = torch.zeros_like(top)
    o = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        wt = torch.where(m == top, torch.ones_like(m), torch.exp(m - top))
        lsum = lsum + l * wt
        o = o + acc * wt[..., None]
    return top, lsum, o


def _emulated_tc(q, pool_k, pool_v, tables, pos, anc=None, k_scales=None,
                 v_scales=None):
    """K1's tensor-core arithmetic on the CPU: (B, H, W, D) bf16."""
    B, H, W, D = q.shape
    _, KV, bs, _ = pool_k.shape
    M = tables.shape[1]
    lanes = H // KV * W
    quant = k_scales is not None
    plan = pa.tc_plan(lanes, D, M, quant)
    DP, S, KT, NW = plan["DP"], plan["splits"], pa.TC_KEYS, pa.TC_WARPS
    cap = M * bs
    ntiles = -(-cap // KT)
    T = ntiles * KT
    idx = tables.long()

    def gather(x):        # (B, KV, T, ...) in key order, zeros past cap
        g = x[idx].transpose(1, 2).reshape(B, KV, cap, *x.shape[3:]).float()
        pad = [0, 0] * (g.dim() - 3) + [0, T - cap]
        return torch.nn.functional.pad(g, pad)

    keys = torch.nn.functional.pad(gather(pool_k), [0, DP - D])
    values = torch.nn.functional.pad(gather(pool_v), [0, DP - D])
    ks = gather(k_scales) if quant else None
    vs = gather(v_scales) if quant else None
    qf = torch.nn.functional.pad(q.reshape(B, KV, lanes, D).float(),
                                 [0, DP - D])
    # S^T, every key and lane, k16 step by k16 step
    s_all = torch.zeros(B, KV, lanes, T)
    for kk in range(DP // 16):
        d = slice(16 * kk, 16 * kk + 16)
        s_all = s_all + _exact("bkld,bktd->bklt", qf[..., d], keys[..., d])
    # each lane's mask: key < cap and (key <= lim or its window bit)
    w = torch.arange(lanes) % W
    p0 = pos.long()[:, None]                                   # (B, 1)
    if anc is None:
        lim = p0 + w[None, :]
        win = torch.zeros(B, lanes, dtype=torch.long)
    else:
        lim = (p0 - 1).expand(B, lanes)
        win = (anc.long()[:, w] | (1 << w)[None, :]) & ((1 << W) - 1)
    key = torch.arange(T)
    rel = key[None, None, :] - p0[:, :, None]                  # (B, 1, T)
    bit = (win[:, :, None] >> rel.clamp(0, 31)) & 1
    mask = (key[None, None, :] < cap) & (
        (key[None, None, :] <= lim[:, :, None])
        | ((rel >= 0) & (rel < 32) & (bit == 1)))              # (B, l, T)
    mask = mask[:, None]
    sm_scale = 1.0 / math.sqrt(D)
    blocks = []
    for split in range(S):
        parts = []
        for warp in range(NW):
            m = torch.full((B, KV, lanes), NEG_INF)
            lg = torch.zeros(B, KV, lanes, 8)   # l of the threads g = 0..7
            acc = torch.zeros(B, KV, lanes, DP)
            for j in _split_tiles(ntiles, split, S):
                k = slice(j * KT + 16 * warp, j * KT + 16 * warp + 16)
                x = s_all[..., k]
                if quant:
                    x = x * ks[:, :, None, k]
                x = x * sm_scale
                x = torch.where(mask[..., k], x, torch.full_like(x, NEG_INF))
                mn = torch.maximum(m, x.amax(-1))
                corr = torch.where(mn == m, torch.ones_like(m),
                                   torch.exp(m - mn))
                p = torch.where(x == NEG_INF, torch.zeros_like(x),
                                torch.exp(x - mn[..., None]))
                m = mn
                lg = lg * corr[..., None] + (p[..., :8] + p[..., 8:])
                if quant:
                    p = p * vs[:, :, None, k]
                hi = _bf16(p)
                acc = acc * corr[..., None] + _exact(
                    "bklt,bktd->bkld", _bf16(p - hi), values[:, :, k])
                acc = acc + _exact("bklt,bktd->bkld", hi, values[:, :, k])
            # the shuffles over g: xor 4 (g ^ 1), 8 (g ^ 2), 16 (g ^ 4)
            l2 = lg[..., 0::2] + lg[..., 1::2]
            l4 = l2[..., 0::2] + l2[..., 1::2]
            parts.append((m, l4[..., 0] + l4[..., 1], acc))
        blocks.append(_combine(parts))
    _, lsum, o = _combine(blocks)
    out = o[..., :D] * (1.0 / lsum.clamp_min(1e-30))[..., None]
    return out.reshape(B, H, W, D).to(q.dtype)


def _case(seed, W, D, bs, KV, rep, B, ctx):
    """B slots at ragged positions through shuffled, null-padded tables
    (slot 1 a dead lane: an all-null table and position 0), each window
    inside its slot's pages: numpy float32 arrays of bf16 values (q and
    pools), the int32 tables and positions."""
    rng = np.random.RandomState(seed)
    pos = rng.randint(ctx // 4, ctx - W, B).astype(np.int32)
    pos[1] = 0
    nv = (pos + W - 1) // bs + 1
    M = -(-ctx // bs) + 2
    ids = rng.permutation(np.arange(1, 1 + int(nv.sum()))).astype(np.int32)
    tables = np.zeros((B, M), np.int32)
    k = 0
    for b in range(B):
        if b != 1:
            tables[b, :nv[b]] = ids[k:k + nv[b]]
            k += nv[b]
    shape = (int(nv.sum()) + 2, KV, bs, D)

    def bf16(*s):
        return _bf16(torch.from_numpy(rng.randn(*s).astype("f"))).numpy()

    return (bf16(B, KV * rep, W, D), bf16(*shape), bf16(*shape), tables,
            pos)


def _torch_case(case, pools):
    """A case as the port takes it: bf16 q, bf16 or int8 pools (with the
    cache's own quantizer) and their scale keywords."""
    q, pk, pv, tables, pos = map(torch.from_numpy, case)
    q = q.bfloat16()
    if pools == "int8":
        (pk, ks), (pv, vs) = _q8_quantize(pk), _q8_quantize(pv)
        return q, pk, pv, tables, pos, dict(k_scales=ks, v_scales=vs)
    return q, pk.bfloat16(), pv.bfloat16(), tables, pos, {}


@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("W,tree", [(1, False), (8, False), (16, True)],
                         ids=["W1", "W8-window", "W16-tree"])
def test_tensor_core_arithmetic_holds_the_card_tolerance(W, tree, pools):
    """The emulated kernel against the plain version and the JAX
    reference at the 8B geometry: the decode step, a W = 8 window and a
    W = 16 tree."""
    g = LLAMA_8B
    case = _case(W + (pools == "int8"), W, **g)
    q, pk, pv, tables, pos, kw = _torch_case(case, pools)
    anc = (torch.from_numpy(tree_anc(np.random.RandomState(W), g["B"], W))
           if tree else None)
    got = _emulated_tc(q, pk, pv, tables, pos, anc, **kw).float()
    plain = pa.paged_decode_attention_plain(q, pk, pv, tables, pos, anc,
                                            **kw).float()
    # the reference in float32 on the same (bf16-valued or int8) inputs
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    want = np.array(jpa.xla_reference(
        jnp.asarray(case[0]), jnp.asarray(pk.float().numpy() if not kw
                                          else pk.numpy()),
        jnp.asarray(pv.float().numpy() if not kw else pv.numpy()),
        jnp.asarray(case[3]), jnp.asarray(case[4]),
        anc=None if anc is None else jnp.asarray(anc.numpy()), **jkw))
    assert got.shape == (g["B"], g["KV"] * g["rep"], W, g["D"])
    assert torch.isfinite(got).all()
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - torch.from_numpy(want)).abs().max()) <= TOL


@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_tensor_core_arithmetic_holds_the_three_invariants(pools):
    """(a), (b) and (c) by ``torch.equal`` at a small geometry (head_dim
    16, block 8, 2 kv heads, rep 3, W = 5, contexts over several key
    tiles, a dead lane)."""
    W, B = 5, 3
    case = _case(7, W, D=16, bs=8, KV=2, rep=3, B=B, ctx=300)
    q, pk, pv, tables, pos, kw = _torch_case(case, pools)
    lin = _emulated_tc(q, pk, pv, tables, pos, **kw)
    chain = torch.from_numpy(tree_anc(None, B, W, chain=True))
    assert torch.equal(_emulated_tc(q, pk, pv, tables, pos, chain, **kw),
                       lin)
    for w in range(W):
        one = _emulated_tc(q[:, :, w:w + 1], pk, pv, tables, pos + w, **kw)
        assert torch.equal(one, lin[:, :, w:w + 1]), w
    tree = torch.from_numpy(tree_anc(np.random.RandomState(3), B, W))
    both = _emulated_tc(q, pk, pv, tables, pos, tree, **kw)
    for b in range(B):
        assert torch.equal(_emulated_tc(
            q[b:b + 1], pk, pv, tables[b:b + 1], pos[b:b + 1],
            tree[b:b + 1], **kw), both[b:b + 1]), b


def test_route_follows_the_query_dtype():
    """bf16 queries take the tensor cores, float32 queries the float32
    walk, whatever the pools."""
    assert pa.route(torch.zeros(2, 4, 1, 16,
                                dtype=torch.bfloat16)) == pa.TENSOR_CORES
    assert pa.route(torch.zeros(2, 4, 1, 16)) == pa.CUDA_CORES


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "D%d-bs%d-rep%d"
                         % (g[0], g[1], g[3]))
def test_plan_covers_every_lane_and_key_and_fits_a_block(geom, quant):
    """At every card-test geometry and W from 1 to 32: the splits and
    the tile-to-split map do not move with W or the lane count, the lane
    groups cover the lanes once, the splits cover every key tile once
    whatever the walk's length, and a block fits the card."""
    D, bs, KV, rep, _, _, ctx = geom
    M = -(-(ctx + 32) // bs) + 2
    ntiles = -(-M * bs // pa.TC_KEYS)
    maps = set()
    for W in range(1, 33):
        lanes = rep * W
        p = pa.tc_plan(lanes, D, M, quant)
        nl = 8 * p["nt"]
        assert p["nt"] in (1, 2, 4) and (p["nt"] < 4 or p["DP"] <= 128)
        assert (p["groups"] - 1) * nl < lanes <= p["groups"] * nl
        assert p["DP"] in (16, 32, 64, 128, 256) and D <= p["DP"] < 2 * max(
            D, 16)
        assert (p["splits"], p["stages"]) == (pa.TC_SPLITS, pa.TC_STAGES)
        assert p["smem"] == pa._tc_smem(p["nt"], p["DP"], M, quant)
        assert p["smem"] <= 232448
        maps.add(tuple(tuple(_split_tiles(ntiles, s, p["splits"]))
                       for s in range(p["splits"])))
    assert len(maps) == 1
    for n in range(ntiles + 1):
        walked = [j for s in range(pa.TC_SPLITS)
                  for j in _split_tiles(n, s, pa.TC_SPLITS)]
        assert sorted(walked) == list(range(n))


def test_plan_fills_the_card_at_the_8b_decode_step():
    """8 slots x 8 kv heads x 1 lane group x 4 splits: 256 blocks of 4
    warps, two an SM on the 132 SMs (a block's shared memory fits twice
    in an SM's 228 KB with 1 KB reserved each)."""
    g = LLAMA_8B
    M = -(-1024 // g["bs"])
    for quant in (False, True):
        p = pa.tc_plan(g["rep"], g["D"], M, quant)
        blocks = g["B"] * g["KV"] * p["groups"] * p["splits"]
        assert (p["nt"], p["groups"], p["splits"]) == (1, 1, 4)
        assert blocks == 256 >= 132
        assert 2 * (p["smem"] + 1024) <= 228 * 1024
