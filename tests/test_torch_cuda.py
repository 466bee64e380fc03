"""The port's CUDA kernels against their plain PyTorch versions on the
card.  The paged kernels (K1, K2) over geometries the main path does not
reach: head_dim 16 to 256, block sizes 8 to 64, GQA rep 1 to 16, a
single-buffered tile (float32 at head_dim 256), long tables, dead lanes,
pages out of order and chunks starting mid-page; K1's verify window and
tree mask at W = 2 to 32 with its two bit-exact invariants (a chain
``anc`` gives the bits of no ``anc``; lane w of a window equals a W = 1
call at pos + w, checked with ``torch.equal``); K2's tensor-core route
(bf16 queries over bf16 or int8 pools) at its edges: folds that are not a
multiple of 16 or hold fewer than 16 lanes, head_dim 8, 16, 32, 72 and
256, block 64, a 4096-token context, chunks from position 0, mid-page
and at the context's end, each also ``torch.equal`` on a second call.
The flash-attention
kernels (K3 forward, K4 dq, K5 dk/dv) causal and not, at T = 128, 100
and 150 (head_dim 16) and at the training path's (1, 32, 2048, 128),
plus head_dim 8, 72 and 256 and the tiling edges of all three (T = 1,
below and one past a query, key or walked tile), K3's lse held on every
row; K4 and K5 over 2048-row walks with dO = randn and one-signed, the
same bits on a second call, and their route by head_dim (tensor cores
up to 128, CUDA cores above) read from the launched kernels' names.  The conv backward
kernel (K6) over geometries the main path does not reach: Ci != Co,
H != W, N = 1, channel counts that are not multiples of its tiles,
ResNet-50's three stage shapes at batch 4, and one-signed inputs at
stage 1's pixel count.  K1 and K2 over int8 pools with
their float32 scales (the float cases quantized per row by the cache's
quantizer): the decode read, the prefill chunk, and K1's window and
tree with its two invariants.  K1's tensor-core route (bf16 queries)
holds invariant (c) too (slot b of a B-slot call equals a 1-slot call
on its own table row and position, ``torch.equal``), gives the same
bits on a second call, holds (b) and (c) at its edges (20 and 24 lanes,
head_dim 8, 40, 72 and 256), and its launcher refuses a plan that
disagrees with its own.  G1 (``rows_linear``) against its plain
version over ragged shapes and Llama-3-8B's six projection shapes,
every row ``torch.equal`` across row counts from 1 to 200 (every row
class, two 128-row chunks) and under a permutation of the rows (held
relative to its largest output, ``GRAD_TOL``: its outputs reach several
units, where one bfloat16 ulp exceeds 2e-2); a bfloat16 call allocating
only its output, and its launcher refusing a plan that disagrees with
its own; and G2 (``rows_rms_norm``) the same way.  The fused norm
(``rows_norm_linear``) ``torch.equal`` to G2 then G1 at every row class
and two 128-row chunks, in both dtypes and with a gain of either dtype,
at the 8B's four normed projections and ragged shapes; its rows
``torch.equal`` across row counts and orders; no read past x, the gain
or the weights (each lies at the head of a buffer of NaNs).  G3 and G4
(``wq_matmul``: G1 reading int8 or packed int4 weights, by the
shapes) against their plain versions over M 1-200, K not a multiple of
the 64-deep slice, N not a multiple of the tile, group sizes 16, 32, 64
and 128, bf16 and float32 x and the 8B's projections, every row
``torch.equal`` across row counts and orders; their norm-fused forms
``torch.equal`` to G2 then the op; a call that allocates only y and
runs with the library products made to raise; weights quantized on the
card to the CPU's bits.  G3's q8 epilogue (``wq_matmul_q8``) ``torch.equal``
to G3 (or its fused norm) then the cache's quantizer on the V columns,
at every int8 row class and two 128-row chunks, on the 8B's qkv and on
V columns that start mid-tile, with heads not a multiple of a warp; no
payload or scale row written past M.  Q1 and Q2, the int8 convolution
and fully-connected products of post-training quantization, ``torch.equal``
to their plain versions (int32 sums, one rounding a step) at ResNet-50's
20 conv geometries and its classifier, at batch 1, with tails in M, N
and K, groups and dilation, the largest sums, packed stem weights and
rows off a 16-byte boundary; Q1's channels-last route at the 19
non-stem geometries, at each of its four tiles on padding, dilation,
stride 2, odd sizes, groups of 16-channel multiples and K steps across
taps, and at the largest sums; Q3, the quantizer that writes its input,
``torch.equal`` to its plain version at the net's input shapes and at
W not a multiple of 32, C a multiple of 16 but not 64, runtime ranges,
half-steps and +-inf; and a quantized narrow ResNet on the card
``torch.equal`` to its plain route.
The hierarchical prefix cache's page copies (``read_pages`` into pinned
host rows, ``write_pages`` back) ``torch.equal`` over four pool
geometries in float32, bfloat16 and int8, with the source pages
overwritten right after the read; and the hierarchical engine on a tiny
float32 model (a restore round trip, sessions under pool pressure, an
overlapped restore, a ``serving.swap_in`` fault) giving on the card the
CPU's streams, stats and page bookkeeping.
Also what the wrappers reject on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips
where there is none.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances (max absolute error against the plain version): 2e-5 in
float32, where the two differ only in the order of their sums; 2e-2 in
bfloat16, where each rounds its float32 result to bfloat16 after sums
taken in other orders.  The flash gradients (dq, dk, dv) are held
relative to their largest element, so that their bound follows dO's
size: 2e-5 of it in float32 (sums in other orders, a few 2**-23 ulps
apart), 2**-7 in bfloat16 (both sides sum in float32 and round once;
two roundings of nearly equal values differ by at most one bfloat16
ulp, 2**-7 of the value at most).  K6's gradients are held the same way
(``GRAD_TOL``), except its float32 dW (``DW_TOL``, 1e-4 of the largest
element): each element sums up to N*H*W = 401,408 products in another
order on each side, and the rounding error of such a sum grows with its
length, about 2**-24 * sqrt(N*H*W) of the largest partial sum for terms
of random sign (4e-5 at 401,408 terms).  This file imports neither JAX nor
``mxtpu``."""

import contextlib

import numpy as np
import pytest
import torch

from chip_smoke import RESNET50_Q3, tree_anc
from chip_smoke import RESNET50_QCONV as QCONV_TABLE
from mxtpu_torch import base
from mxtpu_torch.ops import contrib
from mxtpu_torch.ops import conv_bwd as cb
from mxtpu_torch.ops import flash_attention as fa
from mxtpu_torch.ops import linear
from mxtpu_torch.ops import paged_attention as pa
from mxtpu_torch.ops import prefill_attention as pf

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}
DW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
DTYPES = [torch.float32, torch.bfloat16]

# (head_dim, block_size, kv heads, rep, slots, chunk T, context)
GEOMETRIES = [
    (16, 8, 2, 2, 4, 8, 40),
    (32, 8, 1, 8, 3, 24, 150),
    (64, 32, 4, 1, 5, 16, 300),
    (128, 16, 8, 4, 8, 64, 640),
    (128, 16, 2, 16, 2, 32, 4096),
    (256, 64, 1, 4, 2, 8, 200),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _decode_case(geom, dtype, seed):
    D, bs, KV, rep, B, _, ctx = geom
    rng = np.random.RandomState(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    pos = rng.randint(0, ctx, B).astype(np.int32)
    pos[B // 2] = 0                       # a dead lane: all-null table
    nv = pos // bs + 1
    M = -(-ctx // bs) + 2
    ids = rng.permutation(np.arange(1, 1 + int(nv.sum()))).astype(np.int32)
    tables = np.zeros((B, M), np.int32)
    k = 0
    for b in range(B):
        if b != B // 2:
            tables[b, :nv[b]] = ids[k:k + nv[b]]
            k += nv[b]
    shape = (int(nv.sum()) + 2, KV, bs, D)
    dev = dict(device="cuda", dtype=dtype)
    return (torch.randn(B, KV * rep, 1, D, generator=g, **dev),
            torch.randn(shape, generator=g, **dev),
            torch.randn(shape, generator=g, **dev),
            torch.from_numpy(tables).cuda(), torch.from_numpy(pos).cuda())


def _prefill_case(geom, dtype, seed, start):
    D, bs, KV, rep, _, T, _ = geom
    rng = np.random.RandomState(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    nv = (start + T - 1) // bs + 1
    table = np.zeros(nv + 3, np.int32)
    table[:nv] = rng.permutation(np.arange(1, nv + 1))
    shape = (nv + 2, KV, bs, D)
    dev = dict(device="cuda", dtype=dtype)
    return (torch.randn(1, KV * rep, T, D, generator=g, **dev),
            torch.randn(shape, generator=g, **dev),
            torch.randn(shape, generator=g, **dev),
            torch.from_numpy(table).cuda(), start)


def _err(a, b):
    torch.cuda.synchronize()
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "D%d-bs%d-rep%d"
                         % (g[0], g[1], g[3]))
def test_decode_kernel_matches_plain(cuda, geom, dtype):
    args = _decode_case(geom, dtype, seed=geom[0] + geom[1])
    base.reset_counts()
    got = pa.paged_decode_attention(*args)
    assert base.count(pa.KERNEL_NAME) == 1
    assert got.shape == args[0].shape and got.dtype == dtype
    assert _err(got, pa.paged_decode_attention_plain(*args)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "D%d-bs%d-rep%d"
                         % (g[0], g[1], g[3]))
def test_prefill_kernel_matches_plain(cuda, geom, dtype):
    bs = geom[1]
    for start in (0, 3 * bs + bs // 2 + 1):
        args = _prefill_case(geom, dtype, seed=start + geom[0], start=start)
        got = pf.paged_prefill_attention(*args)
        want = pf.paged_prefill_attention_plain(*args)
        assert _err(got, want) <= TOL[dtype], start
        tensor_start = torch.full((1,), start, dtype=torch.int32,
                                  device="cuda")
        again = pf.paged_prefill_attention(*args[:4], tensor_start)
        assert _err(again, got) == 0.0


#: K2's tensor-core route at its edges: (head_dim, block, kv heads, rep,
#: chunk T, context): a fold of 24 and of 8 lanes (not a multiple of 16,
#: and rep*T < 16), head_dim 8, 16, 32, 72 (not a multiple of 16) and
#: 256, block 64, and a 4096-token context
TC_EDGES = [
    (64, 16, 2, 3, 8, 100),
    (32, 8, 2, 1, 8, 60),
    (8, 8, 2, 2, 8, 40),
    (16, 8, 2, 2, 8, 40),
    (32, 16, 4, 2, 24, 150),
    (72, 16, 2, 4, 16, 100),
    (256, 16, 2, 4, 16, 300),
    (128, 64, 1, 8, 32, 500),
    (128, 16, 2, 4, 64, 4096),
]


@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("edge", TC_EDGES, ids=lambda e: "D%d-bs%d-fold%d-"
                         "ctx%d" % (e[0], e[1], e[3] * e[4], e[5]))
def test_prefill_tensor_core_route_at_its_edges(cuda, edge, pools):
    """bf16 queries over bf16 or int8 pools: chunks from position 0, from
    mid-page and ending at the context's end, each within TOL of the
    plain version and bit for bit the same on a second call."""
    D, bs, KV, rep, T, ctx = edge
    geom = (D, bs, KV, rep, 1, T, ctx)
    for start in (0, 3 * bs + bs // 2 + 1, ctx - T - bs // 2):
        q, pk, pv, table, _ = _prefill_case(geom, torch.bfloat16,
                                            seed=start + D, start=start)
        kw = {}
        if pools == "int8":
            (pk, ks), (pv, vs) = _q8(pk), _q8(pv)
            kw = dict(k_scales=ks, v_scales=vs)
        assert pf.route(q) == pf.TENSOR_CORES
        base.reset_counts()
        got = pf.paged_prefill_attention(q, pk, pv, table, start, **kw)
        again = pf.paged_prefill_attention(q, pk, pv, table, start, **kw)
        assert base.counts() == {pf.KERNEL_NAME_Q8 if kw
                                 else pf.KERNEL_NAME: 2}
        want = pf.paged_prefill_attention_plain(q, pk, pv, table, start,
                                                **kw)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        assert _err(got, want) <= TOL[torch.bfloat16], start
        assert torch.equal(got, again), start


#: the chunk lengths a routed (MoE) model's unpadded prefill gives K2
UNBUCKETED_T = [1, 37, 97, 641]


@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("T", UNBUCKETED_T)
def test_prefill_kernel_at_unbucketed_chunk_lengths(cuda, T, pools):
    """K2 at chunk lengths off the power-of-two ladder, the 8B geometry
    (head_dim 128, block 16, 8 kv heads, rep 4), a chunk starting
    mid-page: float32 and bf16 queries within TOL of the plain version,
    the tensor-core route the same bits on a second call."""
    geom = (128, 16, 8, 4, 1, T, 2 * T + 64)
    start = 3 * 16 + 9
    for dtype in DTYPES:
        q, pk, pv, table, _ = _prefill_case(geom, dtype, seed=T, start=start)
        kw = {}
        if pools == "int8":
            (pk, ks), (pv, vs) = _q8(pk), _q8(pv)
            kw = dict(k_scales=ks, v_scales=vs)
        got = pf.paged_prefill_attention(q, pk, pv, table, start, **kw)
        want = pf.paged_prefill_attention_plain(q, pk, pv, table, start,
                                                **kw)
        assert got.shape == q.shape and got.dtype == dtype
        assert _err(got, want) <= TOL[dtype], (T, dtype)
        if dtype == torch.bfloat16:
            again = pf.paged_prefill_attention(q, pk, pv, table, start, **kw)
            assert torch.equal(got, again)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, pk, pv, tables, pos = _decode_case(GEOMETRIES[0], torch.float32, 0)
    base.reset_counts()
    bad = [
        (q.double(), pk.double(), pv.double(), tables, pos),   # dtype
        (q, pk, pv, tables.long(), pos),                       # index dtype
        (q, pk, pv, tables, pos.cpu()),                        # device
        (q[:, :, :, :12].contiguous(), pk[..., :12].contiguous(),
         pv[..., :12].contiguous(), tables, pos),              # D % 8
    ]
    for args in bad:
        with pytest.raises(base.MXTPUError):
            pa.paged_decode_attention(*args)
    assert base.count(pa.KERNEL_NAME) == 0
    q4 = q.expand(-1, -1, 4, -1).contiguous()
    with pytest.raises(base.MXTPUError):                       # anc dtype
        pa.paged_decode_attention(q4, pk, pv, tables, pos,
                                  anc=torch.zeros(q.shape[0], 4,
                                                  dtype=torch.int64,
                                                  device="cuda"))
    with pytest.raises(base.MXTPUError):              # scales, float pools
        pa.paged_decode_attention(q, pk, pv, tables, pos,
                                  k_scales=pk[..., 0], v_scales=pv[..., 0])


@pytest.mark.parametrize("W", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMETRIES[:5], ids=lambda g: "D%d-bs%d-rep%d"
                         % (g[0], g[1], g[3]))
def test_verify_window_and_tree_kernels_match_plain(cuda, geom, dtype, W):
    """K1's verify window and tree mask against the plain version, up to
    W = 32 lanes (more lanes than one block holds from rep*W > 32), and
    its bit-exact invariants: (a) a degenerate-chain anc gives the bits
    of no anc; (b) lane w of a W-lane linear call equals a W = 1 call at
    pos + w."""
    D, bs, KV, rep = geom[:4]
    q1, pk, pv, tables, pos = _decode_case(geom[:6] + (geom[6] + W,), dtype,
                                           seed=D + W)
    B = q1.shape[0]
    pos = torch.clamp(pos - W, min=0)
    pos[B // 2] = 0
    g = torch.Generator(device="cuda").manual_seed(W)
    q = torch.randn(B, KV * rep, W, D, generator=g, device="cuda",
                    dtype=dtype)
    rng = np.random.RandomState(W)
    base.reset_counts()
    lin = pa.paged_decode_attention(q, pk, pv, tables, pos)
    assert _err(lin, pa.paged_decode_attention_plain(q, pk, pv, tables,
                                                     pos)) <= TOL[dtype]
    tree = torch.from_numpy(tree_anc(rng, B, W)).cuda()
    got = pa.paged_decode_attention(q, pk, pv, tables, pos, anc=tree)
    assert _err(got, pa.paged_decode_attention_plain(
        q, pk, pv, tables, pos, anc=tree)) <= TOL[dtype]
    chain = pa.paged_decode_attention(
        q, pk, pv, tables, pos,
        anc=torch.from_numpy(tree_anc(rng, B, W, chain=True)).cuda())
    assert torch.equal(chain, lin)
    for w in range(W):
        one = pa.paged_decode_attention(q[:, :, w:w + 1].contiguous(), pk, pv,
                                        tables, pos + w)
        assert torch.equal(one, lin[:, :, w:w + 1]), w
    assert base.count(pa.KERNEL_NAME) == 3 + W


def _q8(pool):
    from mxtpu_torch.ops.tensor import _q8_quantize

    return _q8_quantize(pool)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "D%d-bs%d-rep%d"
                         % (g[0], g[1], g[3]))
def test_int8_decode_and_prefill_kernels_match_plain(cuda, geom, dtype):
    q, pk, pv, tables, pos = _decode_case(geom, dtype, seed=geom[0] + 1)
    (pk, ks), (pv, vs) = _q8(pk), _q8(pv)
    kw = dict(k_scales=ks, v_scales=vs)
    base.reset_counts()
    got = pa.paged_decode_attention(q, pk, pv, tables, pos, **kw)
    assert base.counts() == {pa.KERNEL_NAME_Q8: 1}
    assert got.dtype == dtype
    assert _err(got, pa.paged_decode_attention_plain(
        q, pk, pv, tables, pos, **kw)) <= TOL[dtype]
    bs = geom[1]
    for start in (0, 3 * bs + bs // 2 + 1):
        q, pk, pv, table, _ = _prefill_case(geom, dtype, seed=start,
                                            start=start)
        (pk, ks), (pv, vs) = _q8(pk), _q8(pv)
        kw = dict(k_scales=ks, v_scales=vs)
        got = pf.paged_prefill_attention(q, pk, pv, table, start, **kw)
        want = pf.paged_prefill_attention_plain(q, pk, pv, table, start,
                                                **kw)
        assert _err(got, want) <= TOL[dtype], start
    assert base.count(pf.KERNEL_NAME_Q8) == 2


@pytest.mark.parametrize("W", [2, 8, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMETRIES[2:5], ids=lambda g:
                         "D%d-bs%d-rep%d" % (g[0], g[1], g[3]))
def test_int8_verify_window_and_tree_kernels_match_plain(cuda, geom, dtype,
                                                         W):
    """K1's window and tree over int8 pools, with invariants (a) and (b)
    bit for bit."""
    D, bs, KV, rep = geom[:4]
    q1, pk, pv, tables, pos = _decode_case(geom[:6] + (geom[6] + W,), dtype,
                                           seed=D + W)
    (pk, ks), (pv, vs) = _q8(pk), _q8(pv)
    kw = dict(k_scales=ks, v_scales=vs)
    B = q1.shape[0]
    pos = torch.clamp(pos - W, min=0)
    pos[B // 2] = 0
    g = torch.Generator(device="cuda").manual_seed(W)
    q = torch.randn(B, KV * rep, W, D, generator=g, device="cuda",
                    dtype=dtype)
    rng = np.random.RandomState(W)
    lin = pa.paged_decode_attention(q, pk, pv, tables, pos, **kw)
    assert _err(lin, pa.paged_decode_attention_plain(
        q, pk, pv, tables, pos, **kw)) <= TOL[dtype]
    tree = torch.from_numpy(tree_anc(rng, B, W)).cuda()
    got = pa.paged_decode_attention(q, pk, pv, tables, pos, anc=tree, **kw)
    assert _err(got, pa.paged_decode_attention_plain(
        q, pk, pv, tables, pos, anc=tree, **kw)) <= TOL[dtype]
    chain = pa.paged_decode_attention(
        q, pk, pv, tables, pos,
        anc=torch.from_numpy(tree_anc(rng, B, W, chain=True)).cuda(), **kw)
    assert torch.equal(chain, lin)
    for w in range(W):
        one = pa.paged_decode_attention(q[:, :, w:w + 1].contiguous(), pk, pv,
                                        tables, pos + w, **kw)
        assert torch.equal(one, lin[:, :, w:w + 1]), w


@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "D%d-bs%d-rep%d"
                         % (g[0], g[1], g[3]))
def test_decode_tensor_core_slots_ignore_the_batch(cuda, geom, pools):
    """K1's tensor-core route (bf16 queries over bf16 or int8 pools):
    invariant (c), slot b of a B-slot call equals a 1-slot call on its
    own table row and position, for W = 1, a W = 4 window and a W = 4
    tree; and a second call on the same inputs gives the same bits."""
    D, bs, KV, rep = geom[:4]
    q1, pk, pv, tables, pos = _decode_case(geom[:6] + (geom[6] + 4,),
                                           torch.bfloat16, seed=D + bs)
    kw = {}
    if pools == "int8":
        (pk, ks), (pv, vs) = _q8(pk), _q8(pv)
        kw = dict(k_scales=ks, v_scales=vs)
    B = q1.shape[0]
    g = torch.Generator(device="cuda").manual_seed(bs)
    rng = np.random.RandomState(bs)
    for W, tree in ((1, False), (4, False), (4, True)):
        p = pos if W == 1 else torch.clamp(pos - W, min=0)
        q = q1 if W == 1 else torch.randn(B, KV * rep, W, D, generator=g,
                                          device="cuda",
                                          dtype=torch.bfloat16)
        if tree:
            kw["anc"] = torch.from_numpy(tree_anc(rng, B, W)).cuda()
        assert pa.route(q) == pa.TENSOR_CORES
        base.reset_counts()
        got = pa.paged_decode_attention(q, pk, pv, tables, p, **kw)
        again = pa.paged_decode_attention(q, pk, pv, tables, p, **kw)
        assert torch.equal(got, again), (W, tree)
        assert _err(got, pa.paged_decode_attention_plain(
            q, pk, pv, tables, p, **kw)) <= TOL[torch.bfloat16], (W, tree)
        for b in range(B):
            one = pa.paged_decode_attention(
                q[b:b + 1].contiguous(), pk, pv, tables[b:b + 1].contiguous(),
                p[b:b + 1].contiguous(),
                **{k: v[b:b + 1].contiguous() if k == "anc" else v
                   for k, v in kw.items()})
            assert torch.equal(one, got[b:b + 1]), (W, tree, b)
        assert base.counts() == {pa.KERNEL_NAME_Q8 if pools == "int8"
                                 else pa.KERNEL_NAME: 2 + B}


#: K1's tensor-core route at its edges: (head_dim, block, kv heads, rep,
#: W, context): 20 and 24 lanes (a group of 4 lane tiles, 3 of them
#: used), head_dim 72 and 40 (int8 rows of D % 16 == 8 copy 8 bytes),
#: head_dim 8 with 3 lanes, and head_dim 256 at block 64 (2 lane tiles a
#: group, so 24 lanes take two groups)
TC_DECODE_EDGES = [
    (72, 16, 2, 4, 5, 300),
    (40, 32, 2, 6, 4, 200),
    (8, 8, 2, 3, 1, 60),
    (256, 64, 1, 3, 8, 400),
]


@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("edge", TC_DECODE_EDGES, ids=lambda e: "D%d-bs%d-"
                         "lanes%d" % (e[0], e[1], e[3] * e[4]))
def test_decode_tensor_core_route_at_its_edges(cuda, edge, pools):
    """bf16 queries at the lane counts and depths the card geometries
    miss: linear and tree windows within TOL of the plain version, lane
    w equal to a W = 1 call at pos + w and slot b to a 1-slot call."""
    D, bs, KV, rep, W, ctx = edge
    q1, pk, pv, tables, pos = _decode_case((D, bs, KV, rep, 3, 8, ctx + W),
                                           torch.bfloat16, seed=D + W)
    kw = {}
    if pools == "int8":
        (pk, ks), (pv, vs) = _q8(pk), _q8(pv)
        kw = dict(k_scales=ks, v_scales=vs)
    B = q1.shape[0]
    pos = torch.clamp(pos - W, min=0)
    q = torch.randn(B, KV * rep, W, D, device="cuda", dtype=torch.bfloat16,
                    generator=torch.Generator(device="cuda").manual_seed(W))
    tree = torch.from_numpy(tree_anc(np.random.RandomState(D), B, W)).cuda()
    lin = pa.paged_decode_attention(q, pk, pv, tables, pos, **kw)
    got = pa.paged_decode_attention(q, pk, pv, tables, pos, anc=tree, **kw)
    for anc, out in ((None, lin), (tree, got)):
        assert _err(out, pa.paged_decode_attention_plain(
            q, pk, pv, tables, pos, anc=anc, **kw)) <= TOL[torch.bfloat16]
    for w in range(W):
        one = pa.paged_decode_attention(q[:, :, w:w + 1].contiguous(), pk, pv,
                                        tables, pos + w, **kw)
        assert torch.equal(one, lin[:, :, w:w + 1]), w
    for b in range(B):
        one = pa.paged_decode_attention(
            q[b:b + 1].contiguous(), pk, pv, tables[b:b + 1].contiguous(),
            pos[b:b + 1].contiguous(), anc=tree[b:b + 1].contiguous(), **kw)
        assert torch.equal(one, got[b:b + 1]), b


def test_decode_tensor_core_launcher_refuses_a_plan_that_disagrees(cuda):
    """K1's C launcher recomputes the tensor-core plan and refuses one
    whose head_dim class, lane tiles, groups, splits, stages or shared
    memory disagree with it."""
    geom = GEOMETRIES[3]
    for quant in (False, True):
        q, pk, pv, tables, pos = _decode_case(geom, torch.bfloat16, seed=3)
        kw = {}
        if quant:
            (pk, ks), (pv, vs) = _q8(pk), _q8(pv)
            kw = dict(k_scales=ks, v_scales=vs)
        lanes = q.shape[1] // pk.shape[1]
        p = pa.tc_plan(lanes, q.shape[-1], tables.shape[1], quant)
        out = torch.empty_like(q)
        pa.launch_tc(q, pk, pv, tables, pos, out, p, **kw)
        assert torch.equal(out, pa.paged_decode_attention(q, pk, pv, tables,
                                                          pos, **kw))
        for bad in (dict(p, DP=2 * p["DP"]), dict(p, nt=2 * p["nt"]),
                    dict(p, groups=p["groups"] + 1), dict(p, splits=2),
                    dict(p, stages=2), dict(p, smem=p["smem"] + 16)):
            with pytest.raises(base.MXTPUError, match="cudaError"):
                pa.launch_tc(q, pk, pv, tables, pos, out, bad, **kw)


#: Llama-3-8B's decode-step projections (N, K)
PROJECTIONS = [(6144, 4096), (4096, 4096), (14336, 4096), (4096, 14336),
               (128256, 4096)]


#: G1's cases: small shapes in both dtypes (float32 is the small
#: models' path), the 8B projections in bfloat16; (130, 72) has N not a
#: multiple of 4 and (4096, 520) a 2-block cluster whose last split ends
#: mid-k16 (K % 16 == 8)
LINEAR_CASES = [(nk, dt) for nk in ((96, 64), (200, 40)) for dt in DTYPES] \
    + [((64, 172), torch.float32)] \
    + [(nk, torch.bfloat16) for nk in [(130, 72), (4096, 520), (4096, 512)]
       + PROJECTIONS]


@pytest.mark.parametrize("NK,dtype", LINEAR_CASES, ids=[
    "%dx%d-%s" % (nk + (str(dt)[6:],)) for nk, dt in LINEAR_CASES])
def test_rows_linear_matches_plain_and_each_row_ignores_the_row_count(
        cuda, NK, dtype):
    """M = 200 (two 128-row chunks) against the plain version; every
    prefix of 1 to 128 rows (each row class) and a permutation of 128
    and of 200 rows give each row the full call's bits."""
    N, K = NK
    g = torch.Generator(device="cuda").manual_seed(N + K)
    w = torch.randn(N, K, generator=g, device="cuda", dtype=dtype) * 0.02
    x = torch.randn(200, K, generator=g, device="cuda", dtype=dtype)
    base.reset_counts()
    full = linear.rows_linear(x, w)
    want = linear.rows_linear_plain(x, w)
    assert full.dtype == dtype and full.shape == (200, N)
    assert _err(full, want) <= GRAD_TOL[dtype] * float(
        want.float().abs().max())
    for M in (1, 7, 8, 17, 64, 100, 128):
        assert torch.equal(linear.rows_linear(x[:M], w), full[:M]), M
    for M in (128, 200):
        perm = torch.randperm(
            M, generator=torch.Generator().manual_seed(M)).cuda()
        assert torch.equal(linear.rows_linear(x[:M][perm], w),
                           full[:M][perm]), M
    assert base.counts() == {linear.KERNEL_NAME: 10}


@pytest.mark.parametrize("M", [8, 64, 128])
@pytest.mark.parametrize("NK", [(4096, 4096), (4096, 14336), (128256, 4096)],
                         ids=["out_proj", "down_proj", "lm_head"])
def test_rows_linear_bf16_is_one_launch_that_allocates_only_y(cuda, NK, M):
    """A bfloat16 call allocates its output and nothing else (no split-K
    workspace), at 8-split and 1-split shapes."""
    N, K = NK
    w = torch.randn(N, K, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(M, K, device="cuda", dtype=torch.bfloat16)
    linear.rows_linear(x, w)              # built and loaded
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    y = linear.rows_linear(x, w)
    grew = torch.cuda.memory_allocated() - before
    nbytes = y.numel() * y.element_size()
    assert nbytes <= grew < nbytes + 512, (grew, nbytes)


def test_rows_linear_launcher_refuses_a_plan_that_disagrees(cuda):
    """The C launcher recomputes the plan and refuses one whose N tile,
    splits, stages or shared memory disagree with it."""
    N, K = 4096, 4096
    w = torch.randn(N, K, device="cuda", dtype=torch.bfloat16)
    for M in (8, 128):
        x = torch.randn(M, K, device="cuda", dtype=torch.bfloat16)
        y = torch.empty(M, N, device="cuda", dtype=torch.bfloat16)
        p = linear.plan(M, N, K)
        linear._launch_bf16(x, w, y, p)
        assert torch.equal(y, linear.rows_linear(x, w))
        for bad in (dict(p, bn=2 * p["bn"]), dict(p, splits=p["splits"] // 2),
                    dict(p, stages=1), dict(p, smem=p["smem"] + 16),
                    dict(p, stages=p["stages"] - 1)):
            with pytest.raises(base.MXTPUError, match="cudaError"):
                linear._launch_bf16(x, w, y, bad)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [8, 64, 172, 4096])
def test_rows_rms_norm_matches_plain_and_each_row_ignores_the_row_count(
        cuda, C, dtype):
    from mxtpu_torch.ops import contrib

    g = torch.Generator(device="cuda").manual_seed(C)
    x = torch.randn(128, C, generator=g, device="cuda", dtype=dtype)
    gamma = 1 + 0.1 * torch.randn(C, generator=g, device="cuda", dtype=dtype)
    base.reset_counts()
    full = contrib.rows_rms_norm(x, gamma)
    want = contrib.rms_norm(x, gamma)
    assert full.dtype == dtype
    assert _err(full, want) <= GRAD_TOL[dtype] * float(
        want.float().abs().max())
    for M in (1, 7, 8, 17):
        assert torch.equal(contrib.rows_rms_norm(x[:M], gamma), full[:M]), M
    assert torch.equal(contrib.rows_rms_norm(x.flip(0), gamma).flip(0), full)
    assert base.counts() == {contrib.NORM_KERNEL_NAME: 6}


#: the fused norm's cases, ((N, K), x's dtype, the gain's dtype): the
#: 8B's normed projections (qkv, gate and up, lm_head) with a bf16 gain
#: (the model's) and a float32 one, and ragged shapes: N not a multiple
#: of 4, K % 16 == 8 (a last half k16 step), K not a multiple of 8
NORM_LINEAR_CASES = [
    (nk, torch.bfloat16, gd) for nk in [(6144, 4096), (14336, 4096),
                                        (128256, 4096), (130, 72),
                                        (4096, 520)]
    for gd in DTYPES[::-1]] + [
    (nk, torch.float32, torch.float32)
    for nk in [(96, 72), (200, 40), (64, 172), (4096, 4096)]]


def _norm_linear_case(N, K, dtype, gamma_dtype, M=200):
    g = torch.Generator(device="cuda").manual_seed(N + K)
    w = torch.randn(N, K, generator=g, device="cuda", dtype=dtype) * 0.02
    # rows of different sizes, so each row's scale is its own
    x = (torch.randn(M, K, generator=g, device="cuda") * torch.exp(
        torch.randn(M, 1, generator=g, device="cuda"))).to(dtype)
    gamma = (1 + 0.3 * torch.randn(K, generator=g, device="cuda")).to(
        gamma_dtype)
    return x, gamma, w


@pytest.mark.parametrize("NK,dtype,gamma_dtype", NORM_LINEAR_CASES, ids=[
    "%dx%d-%s-gain%s" % (nk + (str(dt)[6:], str(gd)[6:]))
    for nk, dt, gd in NORM_LINEAR_CASES])
def test_rows_norm_linear_is_g2_then_g1_bit_for_bit(cuda, NK, dtype,
                                                    gamma_dtype):
    """At M = 1, 8, 13, 64, 128 and 200 (every row class, two 128-row
    chunks) the fused norm gives G2-then-G1's bits, in one launch; a
    row's bits do not move with the row count or the rows' order."""
    x, gamma, w = _norm_linear_case(*NK, dtype, gamma_dtype)
    for M in (1, 8, 13, 64, 128, 200):
        base.reset_counts()
        got = linear.rows_norm_linear(x[:M], gamma, w)
        assert base.counts() == {linear.KERNEL_NAME: 1,
                                 linear.NORM_KERNEL_NAME: 1}
        pair = linear.rows_linear(contrib.rows_rms_norm(x[:M], gamma), w)
        assert got.dtype == dtype and torch.equal(got, pair), M
    full = got
    assert torch.equal(linear.rows_norm_linear(x[:8], gamma, w), full[:8])
    assert torch.equal(linear.rows_norm_linear(x[5:6], gamma, w), full[5:6])
    assert torch.equal(linear.rows_norm_linear(x.flip(0), gamma, w).flip(0),
                       full)
    want = linear.rows_norm_linear_plain(x, gamma, w)
    assert _err(full, want) <= GRAD_TOL[dtype] * float(
        want.float().abs().max())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_rows_norm_linear_reads_nothing_past_its_operands(cuda, dtype):
    """x (13 rows, M % 8 == 5), the gain and the weights each at the head
    of a buffer of NaNs, K % 16 == 8: the padded rows and the last half
    k16 step take exact zeros, so every output is finite and the pair's
    bits hold."""
    M, N, K = 13, 130, 520
    x, gamma, w = _norm_linear_case(N, K, dtype, dtype, M)
    heads = []
    for t in (x, gamma, w):
        buf = torch.full((t.numel() + 4096,), float("nan"), device="cuda",
                         dtype=t.dtype)
        buf[:t.numel()] = t.reshape(-1)
        heads.append(buf[:t.numel()].view(t.shape))
    y = linear.rows_norm_linear(*heads)
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y, linear.rows_linear(contrib.rows_rms_norm(x, gamma),
                                             w))


def test_rows_norm_linear_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(4, 64, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(32, 64, device="cuda", dtype=torch.bfloat16)
    gamma = torch.ones(72, device="cuda", dtype=torch.bfloat16)
    base.reset_counts()
    bad = [(x, gamma[:60], w), (x, gamma[:64].cpu(), w),
           (x, gamma[:64].half(), w), (x, gamma[1:65], w),
           (x, torch.ones(64, 2, device="cuda")[:, 0], w),
           (x.float(), gamma[:64], w.float()), (x, gamma[:64], w.float())]
    for args in bad:
        with pytest.raises(base.MXTPUError):
            linear.rows_norm_linear(*args)
    assert base.counts() == {}


def test_rows_linear_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(4, 64, device="cuda")
    w = torch.randn(32, 64, device="cuda")
    base.reset_counts()
    xb, wb = x.bfloat16(), w.bfloat16()
    bad = [(x.double(), w.double()), (x, wb), (x, w.cpu()),
           (xb[:, :60].contiguous(), wb[:, :60].contiguous()),  # K % 8
           (x, w[:, :32]), (x, w.t().contiguous().t())]        # K, layout
    for args in bad:
        with pytest.raises(base.MXTPUError):
            linear.rows_linear(*args)
    assert base.counts() == {}


#: G3's and G4's cases, (N, K, bits, group size, x's dtype): N not a
#: multiple of 4 or of the tile, K not a multiple of the 64-deep slice,
#: every group size of 16 to 128 (an int4 split covers whole groups:
#: (4096, 576) has 9 groups over 2 splits), float32 x (any K for int8),
#: and the 8B's projections at the main path's group size
WQ_CASES = [(130, 80, 8, 0, torch.bfloat16), (4096, 544, 8, 0, torch.bfloat16),
            (96, 72, 8, 0, torch.float32), (200, 96, 8, 0, torch.float32),
            (130, 96, 4, 16, torch.bfloat16), (200, 160, 4, 32, torch.bfloat16),
            (4096, 576, 4, 64, torch.bfloat16),
            (4096, 1024, 4, 128, torch.bfloat16),
            (96, 80, 4, 16, torch.float32), (200, 128, 4, 32, torch.float32)] \
    + [(N, K, 8, 0, torch.bfloat16) for N, K in PROJECTIONS] \
    + [(N, K, 4, 64, torch.bfloat16) for N, K in PROJECTIONS]


def _wq_case(N, K, bits, gs, dtype, M=200):
    """Seeded weights quantized by the port, x of ``dtype``, and a gain."""
    from mxtpu_torch.contrib.quantization import quantize_tensor

    g = torch.Generator(device="cuda").manual_seed(N + K + bits)
    w = torch.randn(N, K, generator=g, device="cuda") * 0.02
    q, s = quantize_tensor(w, bits, gs or 64)
    x = (torch.randn(M, K, generator=g, device="cuda") * torch.exp(
        torch.randn(M, 1, generator=g, device="cuda"))).to(dtype)
    gamma = (1 + 0.3 * torch.randn(K, generator=g, device="cuda")).to(dtype)
    return x, q, s, gamma


def _wq(x, q, s, gamma=None):
    return linear.wq_matmul(x, q, s, gamma)


@pytest.mark.parametrize("N,K,bits,gs,dtype", WQ_CASES, ids=[
    "%dx%d-int%d-g%d-%s" % (c[:4] + (str(c[4])[6:],)) for c in WQ_CASES])
def test_wq_matmul_matches_plain_and_each_row_ignores_the_row_count(
        cuda, N, K, bits, gs, dtype):
    """G3 and G4 at M = 200 (two 128-row chunks) within TOL of their
    largest plain output; every prefix of 1 to 128 rows (each row class)
    and a permutation of 128 and 200 rows give each row the full call's
    bits; one launch a call, counted as int8 or int4."""
    x, q, s, _ = _wq_case(N, K, bits, gs, dtype)
    base.reset_counts()
    full = _wq(x, q, s)
    want = linear.wq_matmul_plain(x, q, s)
    assert full.dtype == dtype and full.shape == (200, N)
    assert _err(full, want) <= TOL[dtype] * float(want.float().abs().max())
    for M in (1, 7, 8, 17, 64, 100, 128):
        assert torch.equal(_wq(x[:M], q, s), full[:M]), M
    for M in (128, 200):
        perm = torch.randperm(
            M, generator=torch.Generator().manual_seed(M)).cuda()
        assert torch.equal(_wq(x[:M][perm], q, s), full[:M][perm]), M
    name = linear.I8_KERNEL_NAME if bits == 8 else linear.I4_KERNEL_NAME
    assert base.counts() == {name: 10}


@pytest.mark.parametrize("N,K,bits,gs,dtype", WQ_CASES, ids=[
    "%dx%d-int%d-g%d-%s" % (c[:4] + (str(c[4])[6:],)) for c in WQ_CASES])
def test_wq_norm_matmul_is_g2_then_the_op_bit_for_bit(cuda, N, K, bits, gs,
                                                      dtype):
    """The fused-norm forms give G2-then-G3/G4's bits at every row class
    and two 128-row chunks, each call one launch."""
    x, q, s, gamma = _wq_case(N, K, bits, gs, dtype)
    name = linear.I8_KERNEL_NAME if bits == 8 else linear.I4_KERNEL_NAME
    for M in (1, 8, 13, 64, 128, 200):
        base.reset_counts()
        got = _wq(x[:M], q, s, gamma)
        assert base.counts() == {name: 1, linear.NORM_KERNEL_NAME: 1}
        pair = _wq(contrib.rows_rms_norm(x[:M], gamma), q, s)
        assert got.dtype == dtype and torch.equal(got, pair), M


@pytest.mark.parametrize("bits", [8, 4])
def test_wq_matmul_makes_no_float_weight_and_calls_no_library_gemm(cuda,
                                                                   bits):
    """A quantized projection on the card launches G3 or G4 and nothing
    else: it allocates only y (no dequantized weight), and with the
    library products made to raise it still runs, counted once."""
    N, K = 14336, 4096
    x, q, s, gamma = _wq_case(N, K, bits, 64, torch.bfloat16, M=8)
    _wq(x, q, s)
    torch.cuda.synchronize()
    saved = (torch.matmul, torch.bmm, torch.nn.functional.linear)

    def refuse(*a, **kw):
        raise AssertionError("a library product was called")

    torch.matmul = torch.bmm = torch.nn.functional.linear = refuse
    try:
        base.reset_counts()
        before = torch.cuda.memory_allocated()
        y = _wq(x, q, s)
        yn = _wq(x, q, s, gamma)
        grew = torch.cuda.memory_allocated() - before
    finally:
        torch.matmul, torch.bmm, torch.nn.functional.linear = saved
    name = linear.I8_KERNEL_NAME if bits == 8 else linear.I4_KERNEL_NAME
    assert base.counts() == {name: 2, linear.NORM_KERNEL_NAME: 1}
    nbytes = y.numel() * y.element_size()
    assert 2 * nbytes <= grew < 2 * nbytes + 1024, (grew, nbytes)
    assert torch.equal(yn, _wq(contrib.rows_rms_norm(x, gamma), q, s))


def test_wq_matmul_rejects_what_the_kernel_does_not_take(cuda):
    from mxtpu_torch.contrib.quantization import quantize_tensor

    w = torch.randn(32, 96, device="cuda")
    q8, s8 = quantize_tensor(w, 8)
    q4, s4 = quantize_tensor(w, 4, 32)
    x = torch.randn(4, 96, device="cuda", dtype=torch.bfloat16)
    base.reset_counts()
    bad8 = [(x[:, :88].contiguous(), q8[:, :88].contiguous(), s8),  # K % 16
            (x, q8.cpu(), s8), (x, q8, s8[:16]), (x, q8, s8.double()),
            (x.half(), q8, s8), (x, q8.float(), s8)]
    q4_24, s4_24 = quantize_tensor(w, 4, 24)
    bad4 = [(x, q4_24, s4_24),                              # group % 16
            (x, q4, s4.t().contiguous()), (x, q4, s4[:, :2]),
            (x[:, :48].contiguous(), q4[:, :24].contiguous(),
             s4[:, :2].contiguous())]
    for args in bad8 + bad4:
        with pytest.raises(base.MXTPUError):
            linear.wq_matmul(*args)
    with pytest.raises(base.MXTPUError):                    # gain dtype
        linear.wq_matmul(x, q8, s8, torch.ones(96, device="cuda"))
    assert base.counts() == {}


def test_quantize_tensor_on_the_card_equals_the_cpu(cuda):
    """The card quantizes a weight to the CPU's bits (int8, and int4 at
    group size 64), so the 8B model can be quantized in place."""
    from mxtpu_torch.contrib.quantization import quantize_tensor

    g = torch.Generator().manual_seed(3)
    w = (torch.randn(512, 4096, generator=g) * 0.02).bfloat16()
    for bits in (8, 4):
        qc, sc = quantize_tensor(w, bits)
        qd, sd = quantize_tensor(w.cuda(), bits)
        assert torch.equal(qd.cpu(), qc) and torch.equal(sd.cpu(), sc), bits


#: G3's q8 epilogue: (N, K, head_dim, V heads, x dtype).  The 8B's qkv
#: (its V heads start on a 64-column tile but mid-tile of the 128- and
#: 192-column classes); V columns that start mid-tile of every class
#: (1000 - 200 = 800, 12.5 tiles of 64) with a head of 40 or 72 columns
#: (not a multiple of a warp); the whole output as V (the reference's
#: wq_matmul_i8_q8); float32 x (the small models' kernel).
Q8_CASES = [(6144, 4096, 128, 8, torch.bfloat16),
            (1000, 256, 40, 5, torch.bfloat16),
            (1008, 528, 72, 3, torch.bfloat16),
            (512, 256, 128, 4, torch.bfloat16),
            (1000, 96, 40, 5, torch.float32),
            (520, 64, 16, 2, torch.float32)]


def _q8_unfused(x, q, s, gamma, hd, nv):
    """The unfused arm: G3 (or its fused norm), then the cache's
    quantizer on each head of the last nv columns."""
    from mxtpu_torch.ops.tensor import _q8_quantize

    y = linear.wq_matmul(x, q, s, gamma)
    N = y.shape[-1]
    vq, vs = _q8_quantize(y[:, N - nv:].reshape(-1, nv // hd, hd))
    return y[:, :N - nv], vq.reshape(-1, nv), vs


@pytest.mark.parametrize("N,K,hd,heads,dtype", Q8_CASES, ids=[
    "%dx%d-hd%d-kv%d-%s" % (c[:4] + (str(c[4])[6:],)) for c in Q8_CASES])
@pytest.mark.parametrize("norm", [False, True], ids=["plain", "norm"])
def test_wq_matmul_q8_is_g3_then_the_cache_quantizer_bit_for_bit(
        cuda, N, K, hd, heads, dtype, norm):
    """G3's q8 epilogue at M = 1, 8, 33, 64, 128 (every int8 row class)
    and 200 (two 128-row chunks): the first columns, the int8 payload
    and the scales ``torch.equal`` to the unfused arm; one launch a
    call, counted as G3 and as the epilogue; the arrival counters are
    left zero."""
    x, q, s, gamma = _wq_case(N, K, 8, 0, dtype)
    nv = hd * heads
    g = gamma if norm else None
    for M in (1, 8, 33, 64, 128, 200):
        base.reset_counts()
        qk, vq, vs = linear.wq_matmul_q8(x[:M], q, s, hd, nv, gamma=g)
        want = {linear.I8_KERNEL_NAME: 1, linear.Q8_KERNEL_NAME: 1}
        if norm:
            want.update({linear.NORM_KERNEL_NAME: 1,
                         linear.NORM_Q8_KERNEL_NAME: 1})
        assert base.counts() == want, M
        wqk, wvq, wvs = _q8_unfused(x[:M], q, s, g, hd, nv)
        assert qk.dtype == dtype and vq.dtype == torch.int8 \
            and vs.dtype == torch.float32
        assert vq.shape == (M, nv) and vs.shape == (M, heads), M
        assert torch.equal(qk, wqk), M
        assert torch.equal(vq, wvq), M
        assert torch.equal(vs, wvs), M
    assert not linear._Q8_COUNTERS[x.device].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_wq_matmul_q8_writes_no_row_past_m(cuda, dtype):
    """The launch writes the payload and the scales of rows < M only:
    buffers of M + 16 rows filled with a sentinel keep it past M, and
    rows < M equal the wrapper's (padded chunks write nothing)."""
    N, K, hd, heads = 1000, 256, 40, 5
    nv = hd * heads
    x, q, s, gamma = _wq_case(N, K, 8, 0, dtype, M=40)
    for M in (8, 33):
        _, wvq, wvs = linear.wq_matmul_q8(x[:M], q, s, hd, nv)
        y = torch.empty(M, N, dtype=dtype, device="cuda")
        vq = torch.full((M + 16, nv), 0x55, dtype=torch.int8, device="cuda")
        vs = torch.full((M + 16, heads), -3.0, device="cuda")
        ctr = linear._q8_counters(x.device, 8 * heads)
        ptrs = (x[:M].contiguous().data_ptr(), None, q.data_ptr(),
                s.data_ptr(), None, y.data_ptr(), vq.data_ptr(),
                vs.data_ptr(), ctr.data_ptr(), nv, hd, M, N, K, 1e-6)
        if dtype == torch.bfloat16:
            p = linear.plan(M, N, K, False, "int8")
            rc = linear._fns()["q8_bf16"](
                *ptrs, p["bn"], p["splits"], p["stages"], p["smem"],
                linear._stream(x))
        else:
            rc = linear._fns()["q8_f32"](*ptrs, linear._stream(x))
        assert rc == 0
        assert torch.equal(vq[:M], wvq) and torch.equal(vs[:M], wvs)
        assert (vq[M:] == 0x55).all() and (vs[M:] == -3.0).all()
        assert not ctr.any()


def test_wq_matmul_q8_rejects_what_the_kernel_does_not_take(cuda):
    from mxtpu_torch.contrib.quantization import quantize_tensor

    w = torch.randn(96, 64, device="cuda")
    q8, s8 = quantize_tensor(w, 8)
    q4, s4 = quantize_tensor(w, 4, 32)
    x = torch.randn(4, 64, device="cuda", dtype=torch.bfloat16)
    base.reset_counts()
    for args in [(x, q8, s8, 16, 40), (x, q8, s8, 16, 112),
                 (x, q8, s8, 0, 32), (x, q4, s4, 16, 32),
                 (x, q8.cpu(), s8, 16, 32)]:
        with pytest.raises(base.MXTPUError):
            linear.wq_matmul_q8(*args)
    assert base.counts() == {}


# (B, H, T, D) of the flash kernels; then K3's tiling edges: T below one
# 128-row query tile, one past it, one past a 64-row tile (head_dim 256
# in float32), a causal T not a multiple of the 64-key tile, and
# head_dim 8, one depth step; then K4's and K5's: one past and one below
# the 16-row walked tile (32 up to head_dim 64), K4's 128-row query tile
# and K5's 128-key tile (K4's 192 rows up to head_dim 64)
FLASH_SHAPES = [(2, 2, 128, 16), (2, 2, 100, 16), (2, 2, 150, 16),
                (1, 3, 70, 72), (1, 2, 96, 256), (1, 32, 2048, 128),
                (1, 2, 40, 64), (1, 2, 129, 128), (1, 2, 65, 256),
                (2, 2, 200, 32), (2, 3, 77, 8),
                (1, 2, 17, 128), (1, 2, 15, 128), (1, 2, 33, 64),
                (1, 2, 31, 64), (1, 2, 127, 128), (1, 2, 193, 64),
                (1, 2, 191, 64)]


def _flash_case(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "T%d-D%d-H%d" % (s[2], s[3], s[1]))
def test_flash_kernels_match_plain(cuda, shape, dtype, causal):
    q, k, v, do = _flash_case(shape, dtype, seed=shape[2] + shape[3])
    scale = 1.0 / shape[3] ** 0.5
    if shape[3] == 256 and dtype == torch.float32:
        # K3 fits one block single-buffered; K4 and K5 do not fit
        o, lse = fa.flash_fwd(q, k, v, scale, causal)
        want_o, want_lse = fa.flash_fwd_plain(q, k, v, scale, causal)
        assert _err(o, want_o) <= TOL[dtype]
        delta = torch.zeros_like(lse)
        with pytest.raises(base.MXTPUError, match="shared memory"):
            fa.flash_dq(q, k, v, do, lse, delta, scale, causal)
        return
    base.reset_counts()
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert _err(o, want_o) <= TOL[dtype]
    assert _err(lse, want_lse) <= TOL[torch.float32]
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = fa.flash_dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, scale, causal)
    want = [fa.flash_dq_plain(q, k, v, do, lse, delta, scale, causal),
            *fa.flash_dkv_plain(q, k, v, do, lse, delta, scale, causal)]
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        bound = GRAD_TOL[dtype] * float(ref.float().abs().max())
        assert _err(got, ref) <= bound, name
    assert base.counts() == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


#: K3's lse at its tiling edges: T = 1, one past a 128-row query tile,
#: one past a 64-row one (head_dim 256), a ragged causal tail at head_dim 8
LSE_SHAPES = [(1, 2, 1, 64), (1, 3, 129, 128), (1, 2, 65, 256),
              (2, 2, 200, 8)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", LSE_SHAPES,
                         ids=lambda s: "T%d-D%d" % (s[2], s[3]))
def test_flash_fwd_lse_matches_plain_on_every_row(cuda, shape, dtype,
                                                  causal):
    """K3's logsumexp within 2e-5 of the plain version's on every row,
    the rows of a partial last query tile included; lse is float32 and
    finite everywhere."""
    q, k, v, _ = _flash_case(shape, dtype, seed=shape[2] + 3 * shape[3])
    scale = 1.0 / shape[3] ** 0.5
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    assert lse.dtype == torch.float32 and bool(torch.isfinite(lse).all())
    row_err = (lse - want_lse).abs().amax(dim=(0, 1))
    bad = (row_err > TOL[torch.float32]).nonzero().flatten().tolist()
    assert not bad, "rows %s off by up to %g" % (bad, float(row_err.max()))
    assert _err(o, want_o) <= TOL[dtype]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_fwd_holds_the_tolerance_on_large_outputs(cuda, causal):
    """K3 within 2e-5 of its plain version over a 2048-key walk where
    |o| reaches several units, as on the training path: the tensor cores
    truncate each sum into an accumulator, so a long chain of products
    into one accumulator drifts one way (7.5e-5 on the training path's
    captured inputs on an H100, where |o| reaches several units)."""
    q, k, v = _flash_case((1, 4, 2048, 128), torch.float32, seed=5)[:3]
    v = v + 3
    o, lse = fa.flash_fwd(q, k, v, 128 ** -0.5, causal)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, 128 ** -0.5, causal)
    assert float(want_o.abs().max()) > 3
    assert _err(o, want_o) <= TOL[torch.float32]
    assert _err(lse, want_lse) <= TOL[torch.float32]


def _flash_bwd_args(shape, dtype, causal, seed, one_signed=False):
    q, k, v, do = _flash_case(shape, dtype, seed=seed)
    if one_signed:
        do = do.abs()
    scale = 1.0 / shape[3] ** 0.5
    o, lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    return q, k, v, do, lse, (do.float() * o.float()).sum(dim=-1), scale, \
        causal


@pytest.mark.parametrize("one_signed", [False, True], ids=["randn", "abs"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_bwd_holds_the_tolerance_over_long_walks(cuda, causal,
                                                       one_signed):
    """K4 and K5 within 2e-5 of their largest element over 2048-row walks
    in float32, with dO = randn and one-signed dO = |randn|: p >= 0 then
    makes every term of dv one sign, where a truncating tensor-core
    accumulator chained over the walk would drift one way."""
    args = _flash_bwd_args((1, 4, 2048, 128), torch.float32, causal, 9,
                           one_signed)
    got = [fa.flash_dq(*args), *fa.flash_dkv(*args)]
    want = [fa.flash_dq_plain(*args), *fa.flash_dkv_plain(*args)]
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert _err(g, w) <= GRAD_TOL[torch.float32] * float(
            w.abs().max()), name


@pytest.mark.parametrize("shape,dtype", [
    ((1, 3, 300, 128), torch.float32), ((1, 3, 300, 128), torch.bfloat16),
    ((2, 2, 200, 64), torch.float32), ((2, 2, 200, 64), torch.bfloat16),
    ((1, 2, 96, 256), torch.bfloat16)],
    ids=["T300-D128-f32", "T300-D128-bf16", "T200-D64-f32", "T200-D64-bf16",
         "T96-D256-bf16"])
def test_flash_bwd_gives_the_same_bits_on_a_second_call(cuda, shape, dtype):
    """No atomics: each element of dq, dk and dv is written by one block
    in a fixed order, so a second call gives the same bits (both routes:
    the CUDA-core one at head_dim 256, in bfloat16, where float32 does
    not fit)."""
    args = _flash_bwd_args(shape, dtype, True, 4)
    first = [fa.flash_dq(*args), *fa.flash_dkv(*args)]
    second = [fa.flash_dq(*args), *fa.flash_dkv(*args)]
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("D", [128, 256])
def test_flash_bwd_route_follows_head_dim(cuda, D):
    """K4 and K5 take the tensor cores up to head_dim 128 and their
    CUDA-core kernels above (bf16 at 256, where float32 does not fit),
    as ``route`` and the C launcher state: the launched kernels' names,
    read by torch.profiler, show which."""
    from torch.profiler import ProfilerActivity, profile

    args = _flash_bwd_args((1, 2, 96, D), torch.bfloat16, True, 3)
    base.reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_dq(*args)
        fa.flash_dkv(*args)
        torch.cuda.synchronize()
    assert base.counts() == {"flash_dq": 1, "flash_dkv": 1}
    names = " ".join(e.key for e in prof.key_averages())
    for kind in ("dq", "dkv"):
        cc = "flash_%s_cc_kernel" % kind
        tc = "flash_%s_kernel" % kind
        if fa.route(kind, D) == fa.CUDA_CORES:
            assert cc in names, names
        else:
            assert tc in names and cc not in names, names


def test_flash_autograd_on_the_card_matches_the_cpu(cuda):
    """flash_attention's gradients through the kernels on the card
    against the plain versions on the CPU."""
    q, k, v, w = _flash_case((2, 4, 150, 64), torch.float32, seed=7)
    cq, ck, cv = (x.cpu().requires_grad_() for x in (q, k, v))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(q, k, v, causal=True)
    (out * w).sum().backward()
    ref = fa.flash_attention(cq, ck, cv, causal=True)
    (ref * w.cpu()).sum().backward()
    assert _err(out.cpu(), ref) <= 2e-5
    for a, b in ((q, cq), (k, ck), (v, cv)):
        assert _err(a.grad.cpu(), b.grad) <= 2e-5 * float(
            b.grad.abs().max())


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v, do = _flash_case((1, 2, 64, 16), torch.float32, seed=1)
    base.reset_counts()
    lse = torch.zeros(1, 2, 64, device="cuda")
    bad = [
        (q.double(), k.double(), v.double()),                 # dtype
        (q.transpose(2, 3), k, v),                            # shape
        (q[..., :12].contiguous(), k[..., :12].contiguous(),
         v[..., :12].contiguous()),                           # D % 8
        (q, k.cpu(), v),                                      # device
        (torch.randn(1, 2, 64, 32, device="cuda")[..., :16], k, v),  # layout
    ]
    for args in bad:
        with pytest.raises(base.MXTPUError):
            fa.flash_fwd(*args, 0.25, True)
    with pytest.raises(base.MXTPUError, match="lse"):
        fa.flash_dq(q, k, v, do, lse.double(), lse, 0.25, True)
    assert base.counts() == {}


#: K6 geometries (N, Ci, Co, H, W): the test shapes, odd sizes, and
#: ResNet-50's three stage shapes at a small batch
CONV_GEOMETRIES = [(2, 16, 32, 8, 8), (1, 32, 32, 14, 14), (2, 8, 24, 7, 9),
                   (3, 70, 66, 12, 10), (1, 130, 7, 5, 6), (4, 64, 64, 56, 56),
                   (4, 128, 128, 28, 28), (4, 256, 256, 14, 14)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", CONV_GEOMETRIES,
                         ids=lambda g: "N%d-%dto%d-%dx%d" % g)
def test_conv_bwd_kernel_matches_plain(cuda, geom, dtype):
    N, Ci, Co, H, W = geom
    g = torch.Generator(device="cuda").manual_seed(sum(geom))
    x, dy = (torch.randn(N, c, H, W, generator=g, device="cuda",
                         dtype=dtype) for c in (Ci, Co))
    w = torch.randn(Co, Ci, 3, 3, generator=g, device="cuda", dtype=dtype)
    base.reset_counts()
    dx, dw = cb.conv3x3_s1_backward(x, w, dy)
    want_dx, want_dw = cb.conv_bwd_plain(x, w, dy)
    torch.cuda.synchronize()
    assert base.counts() == {"conv_bwd": 1}
    assert dx.dtype == dtype and dw.dtype == dtype
    assert _err(dx, want_dx) <= GRAD_TOL[dtype] * float(
        want_dx.float().abs().max())
    assert _err(dw, want_dw) <= DW_TOL[dtype] * float(
        want_dw.float().abs().max())


def test_conv_bwd_holds_the_tolerance_on_one_signed_inputs(cuda):
    """One-signed float32 inputs (x = |randn| + 1, dY = |randn|, as
    ResNet's post-ReLU activations are) at stage 1's pixel count: each
    dW element sums 401,408 products of one sign, where a tensor-core
    sum chained through one accumulator would drift one way."""
    N, Ci, Co, H, W = 128, 16, 16, 56, 56
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(N, Ci, H, W, generator=g, device="cuda").abs() + 1
    dy = torch.randn(N, Co, H, W, generator=g, device="cuda").abs()
    w = torch.randn(Co, Ci, 3, 3, generator=g, device="cuda")
    dx, dw = cb.conv3x3_s1_backward(x, w, dy)
    want_dx, want_dw = cb.conv_bwd_plain(x, w, dy)
    torch.cuda.synchronize()
    assert _err(dx, want_dx) <= GRAD_TOL[torch.float32] * float(
        want_dx.abs().max())
    assert _err(dw, want_dw) <= DW_TOL[torch.float32] * float(
        want_dw.abs().max())


def test_conv_bwd_autograd_on_the_card_matches_the_cpu(cuda):
    """A 3x3 convolution's gradients through K6 on the card against the
    plain version on the CPU."""
    from mxtpu_torch.ops import nn as ops

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, 12, 9, 11, generator=g, device="cuda")
    w = torch.randn(20, 12, 3, 3, generator=g, device="cuda")
    ct = torch.randn(2, 20, 9, 11, generator=g, device="cuda")
    grads = []
    for dev in ("cuda", "cpu"):
        a, b = (t.detach().to(dev).requires_grad_() for t in (x, w))
        y = ops.convolution(a, b, kernel=(3, 3), pad=(1, 1))
        (y * ct.to(dev)).sum().backward()
        grads.append((a.grad.cpu(), b.grad.cpu()))
    for got, want in zip(*grads):
        assert _err(got, want) <= 2e-5 * float(want.abs().max())


def test_conv_bwd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(2, 4, 6, 6, device="cuda")
    w = torch.randn(5, 4, 3, 3, device="cuda")
    dy = torch.randn(2, 5, 6, 6, device="cuda")
    base.reset_counts()
    bad = [
        (x.half(), w.half(), dy.half()),                      # dtype
        (x.double(), w.double(), dy.double()),                # dtype
        (x, torch.randn(5, 4, 5, 5, device="cuda"), dy),      # 5x5 kernel
        (x, w, dy[:, :4]),                                    # dy shape
        (x, w[:, :3], dy),                                    # Ci differs
        (x, w.cpu(), dy),                                     # device
        (x, w.to(torch.bfloat16), dy),                        # mixed dtype
    ]
    for args in bad:
        with pytest.raises(base.MXTPUError):
            cb.conv3x3_s1_backward(*args)
    assert base.counts() == {}


# -- Q1 and Q2, the int8 products of post-training quantization --------------

#: ResNet-50 v1's 20 distinct conv geometries (C_in, C_out, kernel,
#: stride, pad, input size), as the card's main path runs them at batch 128
RESNET50_QCONV = [g for g, _ in QCONV_TABLE]
#: tails: (N, C_in, C_out, kernel, stride, pad, dilate, groups, H, W)
QCONV_EDGES = [
    (1, 3, 64, 7, 2, 3, 1, 1, 224, 224),     # batch 1 stem
    (1, 512, 2048, 1, 1, 0, 1, 1, 7, 7),     # batch 1, M = 49
    (3, 5, 72, 3, 1, 1, 1, 1, 13, 11),       # K = 45, N tail at 64
    (2, 7, 200, 3, 2, 1, 1, 1, 17, 9),       # K = 63, N tail at 128
    (2, 6, 8, 3, 1, 2, 2, 2, 10, 12),        # dilation 2, 2 groups
    (2, 256, 256, 3, 1, 1, 1, 4, 9, 9),      # 4 groups of 64
    (1, 1, 1, 1, 1, 0, 1, 1, 1, 1),          # one pixel, one channel
]
#: Q2: (M, K, N) — the ResNet-50 classifier, then tails in M, N and K,
#: then the split's edges at the classifier's N: K of one step (one
#: split), two steps, 33 steps dealt unevenly over 5 splits, and M of 1
#: (8 splits), 77 and 200
QFC_SHAPES = [(128, 2048, 1000), (1, 2048, 1000), (77, 64, 130),
              (5, 147, 7), (200, 33, 65), (1, 1, 1),
              (128, 32, 1000), (128, 96, 1000), (128, 2080, 1000),
              (77, 2048, 1000), (200, 2048, 1000), (1, 2080, 1000)]
#: the stem's route: (N, C_in, C_out, kernel, stride, pad, dilate, groups,
#: H, W) — the stem at batch 1 and 3, 1, 2 and 4 channels, odd sizes,
#: pads 0 and 3, stride 1, dilation 2, groups, a kernel of 11 taps, output
#: channels past 64, one pixel
QCONV_STEM = [
    (1, 3, 64, 7, 2, 3, 1, 1, 224, 224),
    (3, 3, 64, 7, 2, 3, 1, 1, 224, 224),
    (2, 3, 64, 7, 2, 3, 1, 1, 225, 223),
    (2, 1, 32, 3, 1, 1, 1, 1, 17, 19),
    (1, 2, 64, 7, 2, 3, 1, 1, 30, 31),
    (2, 4, 72, 5, 2, 0, 1, 1, 21, 26),
    (1, 3, 8, 3, 1, 0, 2, 1, 15, 13),
    (1, 3, 64, 7, 1, 3, 2, 1, 37, 29),
    (2, 6, 10, 3, 1, 2, 2, 2, 10, 12),
    (1, 3, 130, 11, 4, 2, 1, 1, 35, 37),
    (1, 4, 24, 1, 1, 0, 1, 1, 9, 7),
]


def _rand_int8(g, *shape):
    return torch.randint(-127, 128, shape, generator=g, device="cuda",
                         dtype=torch.int8)


def _qconv_case(N, Ci, Co, k, s, p, d, groups, H, W, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _rand_int8(g, N, Ci, H, W)
    w = _rand_int8(g, Co, Ci // groups, k, k)
    scale = torch.rand((), generator=g, device="cuda") * 1e-4
    bias = torch.randn(Co, generator=g, device="cuda")
    return x, w, scale, bias, dict(stride=(s, s), pad=(p, p),
                                   dilate=(d, d), groups=groups)


def _qconv_equal(x, w, scale, bias, kw):
    """Q1 on an NCHW payload ``torch.equal`` to its plain version, on the
    stem's kernel or the byte gather as ``route`` says."""
    from mxtpu_torch.ops import quantized as Q

    form = Q.route(x, kw["groups"], tuple(w.shape[2:]), kw["dilate"])
    assert form in ("stem", "nchw")
    for b in (bias, None):
        base.reset_counts()
        got = Q.qconv(x, w, scale, b, **kw)
        want = Q.qconv_plain(x, w, scale, b, **kw)
        torch.cuda.synchronize()
        assert base.counts() == ({"qconv": 1, "qconv_stem": 1}
                                 if form == "stem" else {"qconv": 1})
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got, want)
    return form


@pytest.mark.parametrize("geom", RESNET50_QCONV,
                         ids=lambda g: "%dto%d-%dx%ds%d-%d" % (
                             g[0], g[1], g[2], g[2], g[3], g[5]))
def test_quant_q1_equals_plain_at_resnet50_geometries(cuda, geom):
    Ci, Co, k, s, p, H = geom
    _qconv_equal(*_qconv_case(2, Ci, Co, k, s, p, 1, 1, H, H, sum(geom)))


@pytest.mark.parametrize("case", QCONV_EDGES,
                         ids=lambda c: "N%d-%dto%d-k%ds%dp%dd%dg%d-%dx%d" % c)
def test_quant_q1_equals_plain_at_its_edges(cuda, case):
    form = _qconv_equal(*_qconv_case(*case, seed=sum(case)))
    # 3 channels a group or fewer take the stem's kernel; the 5- and
    # 7-channel cases and the 256-channel groups keep the byte gather
    Cg = case[1] // case[7]
    assert form == ("stem" if Cg <= 4 else "nchw")


@pytest.mark.parametrize("case", QCONV_STEM,
                         ids=lambda c: "N%d-%dto%d-k%ds%dp%dd%dg%d-%dx%d" % c)
def test_quant_q1_stem_equals_plain(cuda, case):
    assert _qconv_equal(*_qconv_case(*case, seed=sum(case))) == "stem"


@pytest.mark.parametrize("tile", [(1, 112), (3, 37), (4, 29), (1, 5),
                                  (16, 16), (7, 1), (2, 113)],
                         ids=lambda t: "R%dxTW%d" % t)
def test_quant_q1_stem_equals_plain_at_forced_tiles(cuda, monkeypatch, tile):
    """Tiles narrower than the image (a run a row, 4-byte stores where a
    row starts off a 16-byte boundary), a partial last row tile, one
    column; each at the stem's geometry on a 45 x 47 image."""
    from mxtpu_torch.ops import quantized as Q

    monkeypatch.setattr(Q, "_plan_stem", lambda *geo: tile)
    assert _qconv_equal(*_qconv_case(2, 3, 64, 7, 2, 3, 1, 1, 45, 47,
                                     seed=7)) == "stem"


def test_quant_q1_stem_holds_the_largest_sums(cuda):
    """All +-127: the stem's largest sums (147 products of 127 * 127), and
    a 4-channel 17x17 kernel's (1156 products, |acc| ~ 1.9e7 > 2**24:
    int32 to float32 rounds to nearest even)."""
    from mxtpu_torch.ops import quantized as Q

    scale = torch.tensor(3.1e-5, device="cuda")
    for C, k, p, H in ((3, 7, 3, 224), (4, 17, 8, 40)):
        x = torch.full((2, C, H, H), 127, dtype=torch.int8, device="cuda")
        x[1, :, ::3] = -127
        w = torch.full((64, C, k, k), 127, dtype=torch.int8, device="cuda")
        w[::5] = -127
        _qconv_equal(x, w, scale, None, dict(stride=(2, 2), pad=(p, p),
                                             dilate=(1, 1), groups=1))
        acc = Q.qconv_sums(x, w, (2, 2), (p, p))
        assert int(acc.abs().max()) == C * k * k * 127 * 127
    assert int(acc.abs().max()) > 2 ** 24


def test_quant_q1_holds_the_largest_sums(cuda):
    """Sums of 4608 products of 127 * 127 (ResNet-50's largest K, |acc|
    ~ 7.4e7 > 2**24: int32 to float32 rounds to nearest even)."""
    from mxtpu_torch.ops import quantized as Q

    x = torch.full((1, 512, 7, 7), 127, dtype=torch.int8, device="cuda")
    x[:, ::3] = -127
    w = torch.full((64, 512, 3, 3), 127, dtype=torch.int8, device="cuda")
    scale = torch.tensor(3.1e-5, device="cuda")
    got = Q.qconv(x, w, scale, pad=(1, 1))
    want = Q.qconv_plain(x, w, scale, pad=(1, 1))
    assert torch.equal(got, want)
    acc = Q.qconv_sums(x, w, pad=(1, 1))
    assert int(acc.abs().max()) > 2 ** 24


def test_quant_q1_takes_packed_weights(cuda):
    """The stem's weights kept packed for its route (K 147 -> 7 x 8 x 4 =
    224), and a 5-channel conv's for the byte gather (K 45 -> 64), as a
    quantized layer keeps them, give the bits of packing on the call; the
    stem's route refuses weights packed for the byte gather."""
    from mxtpu_torch.ops import quantized as Q

    x, w, scale, bias, kw = _qconv_case(2, 3, 64, 7, 2, 3, 1, 1, 40, 40, 3)
    packed = Q.pack_weight(w, stem=True)
    assert tuple(packed.shape) == (64, 224)
    assert torch.equal(Q.qconv(x, w, scale, bias, packed=packed, **kw),
                       Q.qconv_plain(x, w, scale, bias, **kw))
    with pytest.raises(base.MXTPUError):
        Q.qconv(x, w, scale, bias, packed=Q.pack_weight(w), **kw)
    x, w, scale, bias, kw = _qconv_case(2, 5, 72, 3, 1, 1, 1, 1, 13, 11, 4)
    packed = Q.pack_weight(w)
    assert tuple(packed.shape) == (72, 64)
    assert torch.equal(Q.qconv(x, w, scale, bias, packed=packed, **kw),
                       Q.qconv_plain(x, w, scale, bias, **kw))


def test_quant_q1_stem_layer_keeps_its_packing(cuda):
    """A quantized stem layer keeps its weights packed for the stem's
    route (packed once, reused), and its output equals the same op with
    the weights packed on the call; changing the weights repacks."""
    from mxtpu_torch.contrib import quantization as P

    g = torch.Generator(device="cuda").manual_seed(6)
    layer = P.QuantizedConv2D(64, 3, (7, 7), strides=(2, 2), padding=(3, 3),
                              calib_range=(-2.0, 2.5), device="cuda")
    layer.weight_quantized.copy_(_rand_int8(g, 64, 3, 7, 7))
    layer.weight_qmin.fill_(-0.3)
    layer.weight_qmax.fill_(0.3)
    layer.bias.copy_(torch.randn(64, generator=g, device="cuda"))
    x = torch.randn(2, 3, 56, 56, generator=g, device="cuda")
    with torch.no_grad():
        base.reset_counts()
        got = layer(x)
        kept = layer._pack[1]
        again = layer(x)
        torch.cuda.synchronize()
        assert base.counts() == {"qconv": 2, "qconv_stem": 2}
        assert layer._pack[1] is kept and tuple(kept.shape) == (64, 224)
        q, mn, mx = P.quantize_v2(x, torch.tensor(-2.0, device="cuda"),
                                  torch.tensor(2.5, device="cuda"))
        want = P.quantized_conv(q, layer.weight_quantized, mn, mx,
                                layer.weight_qmin, layer.weight_qmax,
                                layer.bias, **layer._kwargs)
        assert torch.equal(got, want) and torch.equal(again, want)
        layer.weight_quantized.neg_()
        flipped = layer(x)
        assert layer._pack[1] is not kept
        assert torch.equal(flipped, P.quantized_conv(
            q, layer.weight_quantized, mn, mx, layer.weight_qmin,
            layer.weight_qmax, layer.bias, **layer._kwargs))


@pytest.mark.parametrize("shape", QFC_SHAPES,
                         ids=lambda s: "M%d-K%d-N%d" % s)
def test_quant_q2_equals_plain(cuda, shape):
    from mxtpu_torch.ops import quantized as Q

    M, K, N = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x, w = _rand_int8(g, M, K), _rand_int8(g, N, K)
    scale = torch.rand((), generator=g, device="cuda") * 1e-4
    bias = torch.randn(N, generator=g, device="cuda")
    assert 1 <= Q._plan_fc(M, N, K) <= 8
    for b in (bias, None):
        base.reset_counts()
        got = Q.qfc(x, w, scale, b)
        torch.cuda.synchronize()
        assert base.counts() == {"qfc": 1}
        assert torch.equal(got, Q.qfc_plain(x, w, scale, b))


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
def test_quant_q2_equals_plain_at_every_split(cuda, monkeypatch, splits):
    """The classifier with its K forced over 1 to 8 blocks of a cluster,
    and the largest sums (2048 products of 127 * 127)."""
    from mxtpu_torch.ops import quantized as Q

    monkeypatch.setattr(Q, "_plan_fc", lambda M, N, K: splits)
    g = torch.Generator(device="cuda").manual_seed(splits)
    x, w = _rand_int8(g, 128, 2048), _rand_int8(g, 1000, 2048)
    scale = torch.tensor(2e-5, device="cuda")
    assert torch.equal(Q.qfc(x, w, scale), Q.qfc_plain(x, w, scale))
    x.fill_(127)
    w.fill_(127)
    w[::3] = -127
    got = Q.qfc(x, w, scale)
    assert torch.equal(got, Q.qfc_plain(x, w, scale))
    assert int(Q.qfc_sums(x, w).abs().max()) == 2048 * 127 * 127


def test_quant_q2_copies_unaligned_rows(cuda):
    """Rows that start off a 16-byte boundary are copied to an aligned
    buffer before the 16-byte loads."""
    from mxtpu_torch.ops import quantized as Q

    g = torch.Generator(device="cuda").manual_seed(8)
    buf = _rand_int8(g, 64 * 96 + 1)
    x = buf[1:].view(64, 96)
    assert x.data_ptr() % 16
    w = _rand_int8(g, 40, 96)
    scale = torch.tensor(2e-5, device="cuda")
    assert torch.equal(Q.qfc(x, w, scale), Q.qfc_plain(x, w, scale))


def test_quantized_net_on_the_card_equals_its_plain_route(cuda, monkeypatch):
    """A narrow ResNet-v1 quantized on the card: every conv through Q1
    and the Dense through Q2, exactly once a forward, every conv of 16
    input channels or a multiple on Q1's channels-last route with its
    input quantized by Q3, and its logits ``torch.equal`` to the same net
    with the plain versions put in the kernels' place."""
    from mxtpu_torch.contrib import quantization as P
    from mxtpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
    from mxtpu_torch.initializer import Xavier
    from mxtpu_torch.ops import quantized as Q

    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                   classes=10, device="cuda")
    net.initialize(Xavier(magnitude=2.0),
                   torch.Generator(device="cuda").manual_seed(1))
    g = torch.Generator(device="cuda").manual_seed(2)
    calib = [torch.rand(4, 3, 64, 64, generator=g, device="cuda")
             for _ in range(2)]
    x = torch.rand(4, 3, 64, 64, generator=g, device="cuda")
    qnet = P.quantize_net(net, calib_data=calib)
    convs = sum(isinstance(m, P.QuantizedConv2D) for m in qnet.modules())
    # the convs of 16-channel multiples a group (not the stem's 3, nor the
    # 8 of the first stage's bottlenecks)
    nhwc = sum(isinstance(m, P.QuantizedConv2D) and m._nhwc
               for m in qnet.modules())
    assert nhwc == convs - 3
    with torch.no_grad():
        base.reset_counts()
        got = qnet(x)
        torch.cuda.synchronize()
        assert base.counts() == {"qconv": convs, "qconv_nhwc": nhwc,
                                 "qconv_stem": 1, "quantize_nhwc": nhwc,
                                 "qfc": 1}
        monkeypatch.setattr(Q, "qconv", lambda x, w, s, b=None, stride=(
            1, 1), pad=(0, 0), dilate=(1, 1), groups=1, packed=None:
            Q.qconv_plain(x, w, s, b, stride, pad, dilate, groups))
        monkeypatch.setattr(Q, "qfc", Q.qfc_plain)
        monkeypatch.setattr(Q, "quantize_nhwc", Q.quantize_nhwc_plain)
        want = qnet(x)
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_quant_q1_q2_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from mxtpu_torch.ops import quantized as Q

    g = torch.Generator(device="cuda").manual_seed(1)
    x, w = _rand_int8(g, 2, 4, 6, 6), _rand_int8(g, 5, 4, 3, 3)
    s = torch.tensor(1e-3, device="cuda")
    base.reset_counts()
    for args, kw in [
            ((x.float(), w, s), {}),                      # float x
            ((x, w.float(), s), {}),                      # float w
            ((x, w, s.double()), {}),                     # float64 scale
            ((x, w, s.cpu()), {}),                        # scale on the CPU
            ((x, w, s, torch.zeros(4, device="cuda")), {}),   # bias shape
            ((x, w.cpu(), s), {}),                        # w on the CPU
            ((x, w, s), dict(groups=3)),                  # groups
            ((x, w, s), dict(stride=(7, 7), pad=(0, 0),
                             dilate=(4, 4))),             # no output
            ((x, w, s), dict(packed=w.reshape(5, 36))),   # K not padded
    ]:
        with pytest.raises(base.MXTPUError):
            Q.qconv(*args, **kw)
    # the stem's route: weights packed short of its K (7 x 32), x not
    # NCHW-contiguous
    xs, ws = _rand_int8(g, 2, 3, 20, 20), _rand_int8(g, 8, 3, 7, 7)
    for args, kw in [
            ((xs, ws, s), dict(packed=Q.pack_weight(ws))),
            ((xs, ws, s), dict(packed=Q.pack_weight(ws, stem=True)[:, :192]
                               .contiguous())),
            ((xs[:, :, 1:], ws, s), {}),
            ((xs.contiguous(memory_format=torch.channels_last), ws, s), {})]:
        with pytest.raises(base.MXTPUError):
            Q.qconv(*args, **kw)
    a, b = _rand_int8(g, 8, 32), _rand_int8(g, 6, 32)
    for args in [(a.float(), b, s), (a, b[:, :16], s), (a, b, s.cpu()),
                 (a, b, s, torch.zeros(5, device="cuda"))]:
        with pytest.raises(base.MXTPUError):
            Q.qfc(*args)
    assert base.counts() == {}


# -- Q1's channels-last route and Q3 ------------------------------------------

#: tails on the channels-last route: (N, C_in, C_out, kernel, stride, pad,
#: dilate, groups, H, W) — K steps across 4, 2 and 4/3 taps (16, 32 and
#: 48 channels a group), padding past the kernel's reach, dilation,
#: stride 2 and 3, odd sizes, groups, N and M tails
QCONV_NHWC_EDGES = [
    (2, 16, 24, 3, 1, 1, 1, 1, 9, 7),
    (1, 32, 8, 3, 2, 2, 1, 1, 11, 13),
    (3, 48, 40, 3, 1, 2, 2, 1, 10, 9),
    (2, 64, 200, 5, 2, 4, 1, 1, 12, 12),
    (1, 64, 32, 3, 1, 1, 3, 2, 15, 8),
    (2, 96, 96, 1, 3, 0, 1, 3, 17, 5),
    (1, 16, 16, 7, 1, 3, 1, 1, 7, 7),
    (2, 256, 64, 3, 2, 1, 1, 4, 9, 9),
    (5, 64, 130, 1, 1, 0, 1, 1, 13, 11),
]
#: the net's Q3 input shapes (C, H, W), then edges: W not a multiple of
#: 32, C a multiple of 16 but not 64, one pixel
Q3_SHAPES = [(c, h, h) for (c, h), _ in RESNET50_Q3] + [
    (128, 56, 56), (48, 9, 33), (16, 5, 7), (80, 1, 1)]


def _nhwc_equal(x, w, scale, bias, kw):
    from mxtpu_torch.ops import quantized as Q

    assert Q.route(x, kw["groups"]) == "nhwc"
    for b in (bias, None):
        base.reset_counts()
        got = Q.qconv(x, w, scale, b, **kw)
        want = Q.qconv_plain(x, w, scale, b, **kw)
        torch.cuda.synchronize()
        assert base.counts() == {"qconv": 1, "qconv_nhwc": 1}
        assert got.is_contiguous() and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("geom", RESNET50_QCONV[1:],
                         ids=lambda g: "%dto%d-%dx%ds%d-%d" % (
                             g[0], g[1], g[2], g[2], g[3], g[5]))
def test_quant_q1_nhwc_equals_plain_at_resnet50_geometries(cuda, geom):
    Ci, Co, k, s, p, H = geom
    x, w, scale, bias, kw = _qconv_case(2, Ci, Co, k, s, p, 1, 1, H, H,
                                        sum(geom))
    _nhwc_equal(x.contiguous(memory_format=torch.channels_last), w, scale,
                bias, kw)


@pytest.mark.parametrize("tile", [(64, 64), (64, 128), (128, 64),
                                  (128, 128)], ids=lambda t: "%dx%d" % t)
@pytest.mark.parametrize("case", QCONV_NHWC_EDGES,
                         ids=lambda c: "N%d-%dto%d-k%ds%dp%dd%dg%d-%dx%d" % c)
def test_quant_q1_nhwc_equals_plain_at_its_edges(cuda, monkeypatch, case,
                                                  tile):
    from mxtpu_torch.ops import quantized as Q

    monkeypatch.setattr(Q, "_plan", lambda M, Ng, kind="nhwc": tile)
    x, w, scale, bias, kw = _qconv_case(*case, seed=sum(case))
    _nhwc_equal(x.contiguous(memory_format=torch.channels_last), w, scale,
                bias, kw)


def test_quant_q1_nhwc_takes_its_plan_at_full_size(cuda):
    """The plan's own tiles at batch 64 and 8: 128 x 128 (512 -> 2048 at
    7x7), 64 x 128 (512 -> 512 3x3 at 7x7), 128 x 64 (64 -> 64 at 28x28)
    and 64 x 64 (64 -> 64 at 14x14)."""
    from mxtpu_torch.ops import quantized as Q

    for N, Ci, Co, k, p, H, tile in [
            (64, 512, 2048, 1, 0, 7, (128, 128)),
            (64, 512, 512, 3, 1, 7, (64, 128)),
            (64, 64, 64, 1, 0, 28, (128, 64)),
            (8, 64, 64, 3, 1, 14, (64, 64))]:
        assert Q._plan(N * H * H, Co) == tile
        x, w, scale, bias, kw = _qconv_case(N, Ci, Co, k, 1, p, 1, 1, H, H,
                                            N + Co)
        _nhwc_equal(x.contiguous(memory_format=torch.channels_last), w,
                    scale, bias, kw)


def test_quant_q1_nhwc_holds_the_largest_sums(cuda):
    """Sums of 4608 products of 127 * 127 on the channels-last route."""
    from mxtpu_torch.ops import quantized as Q

    x = torch.full((1, 512, 7, 7), 127, dtype=torch.int8, device="cuda")
    x[:, ::3] = -127
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.full((64, 512, 3, 3), 127, dtype=torch.int8, device="cuda")
    scale = torch.tensor(3.1e-5, device="cuda")
    _nhwc_equal(x, w, scale, None, dict(stride=(1, 1), pad=(1, 1),
                                        dilate=(1, 1), groups=1))
    assert int(Q.qconv_sums(x, w, pad=(1, 1)).abs().max()) > 2 ** 24


def test_quant_q1_nhwc_takes_packed_ohwi_weights(cuda):
    from mxtpu_torch.ops import quantized as Q

    x, w, scale, bias, kw = _qconv_case(2, 48, 40, 3, 1, 1, 1, 1, 10, 9, 4)
    x = x.contiguous(memory_format=torch.channels_last)
    packed = Q.pack_weight(w, channels_last=True)
    assert tuple(packed.shape) == (40, 448)
    assert torch.equal(Q.qconv(x, w, scale, bias, packed=packed, **kw),
                       Q.qconv_plain(x, w, scale, bias, **kw))


def test_quant_q1_layer_takes_a_channels_last_float_input(cuda):
    """A 3x3 quantized conv fed its float input stored channels-last
    (``x.contiguous(memory_format=torch.channels_last)``) gives the bits
    it gives for the NCHW input: the payload and the packed weights are
    laid out alike, whatever the input's layout."""
    from mxtpu_torch.contrib import quantization as P

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, 64, 14, 14, generator=g, device="cuda")
    for calib in (None, (-2.5, 3.0)):
        layer = P.QuantizedConv2D(96, 64, (3, 3), padding=(1, 1),
                                  calib_range=calib, device="cuda")
        layer.weight_quantized.copy_(_rand_int8(g, 96, 64, 3, 3))
        layer.weight_qmin.fill_(-0.3)
        layer.weight_qmax.fill_(0.3)
        layer.bias.copy_(torch.randn(96, generator=g, device="cuda"))
        outs = []
        with torch.no_grad():
            for xx in (x, x.contiguous(memory_format=torch.channels_last),
                       x):
                base.reset_counts()
                outs.append(layer(xx))
                torch.cuda.synchronize()
                assert base.counts() == {"quantize_nhwc": 1, "qconv": 1,
                                         "qconv_nhwc": 1}
        assert torch.isfinite(outs[0]).all()
        assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2],
                                                             outs[0])


def _q3_equal(x, scale):
    from mxtpu_torch.ops import quantized as Q

    base.reset_counts()
    got = Q.quantize_nhwc(x, scale)
    want = Q.quantize_nhwc_plain(x, scale)
    torch.cuda.synchronize()
    assert base.counts() == {"quantize_nhwc": 1}
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", Q3_SHAPES, ids=lambda s: "%dx%dx%d" % s)
def test_quant_q3_equals_plain(cuda, shape):
    """Calibrated (a range inside x's, so values clamp) and runtime
    ranges, the scale a 0-dim device tensor as the layer computes it."""
    from mxtpu_torch.contrib.quantization import _q_scale

    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = torch.randn((2,) + shape, generator=g, device="cuda") * 3
    for mn, mx in [(torch.tensor(-2.0, device="cuda"),
                    torch.tensor(1.5, device="cuda")), torch.aminmax(x)]:
        _q3_equal(x, _q_scale(mn, mx))


def test_quant_q3_rounds_half_steps_and_clamps_infinities(cuda):
    v = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5, 126.5, -126.5,
                      127.5, 200.0, -300.0, 0.0, -0.0, float("inf"),
                      -float("inf")], device="cuda")
    x = v.repeat(2 * 32 * 3 * 5 // 16).reshape(2, 32, 3, 5)
    _q3_equal(x, torch.tensor(1.0, device="cuda"))
    _q3_equal(x * 0.37, torch.tensor(0.37, device="cuda"))


def test_quant_q1_q3_wrappers_reject_layouts_they_do_not_take(cuda):
    from mxtpu_torch.ops import quantized as Q

    g = torch.Generator(device="cuda").manual_seed(3)
    cl = torch.channels_last
    s = torch.tensor(1e-3, device="cuda")
    x, w = _rand_int8(g, 2, 32, 6, 6), _rand_int8(g, 5, 32, 3, 3)
    base.reset_counts()
    # channels-last with 8 channels a group; neither layout; off 16 bytes
    buf = _rand_int8(g, 2 * 32 * 36 + 1)
    off = buf[1:].view(2, 6, 6, 32).permute(0, 3, 1, 2)
    assert Q.route(off) == "nhwc" and off.data_ptr() % 16
    for args, kw in [
            ((x.contiguous(memory_format=cl), _rand_int8(g, 8, 8, 3, 3), s),
             dict(groups=4)),
            ((x[:, :, 1:], w, s), {}),
            ((off, w, s), {}),
            ((x.contiguous(memory_format=cl), w, s),
             dict(packed=w.reshape(5, 288)[:, :100]))]:
        with pytest.raises(base.MXTPUError):
            Q.qconv(*args, **kw)
    f = torch.randn(2, 32, 6, 6, device="cuda")
    for args in [(f.double(), s), (f.contiguous(memory_format=cl), s),
                 (f[:, :8].contiguous(), s), (f[:, :, 1:], s),
                 (f, s.double()), (f, s.cpu()), (f[0], s)]:
        with pytest.raises(base.MXTPUError):
            Q.quantize_nhwc(*args)
    assert base.counts() == {}


# -- the hierarchical prefix cache: page copies and the engine ---------------

#: (layers, kv heads, block size, head_dim) of the page round trips
PAGE_GEOMS = [(1, 2, 8, 16), (2, 8, 16, 128), (3, 4, 32, 64), (1, 1, 64, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("geom", PAGE_GEOMS,
                         ids=lambda g: "L%d-KV%d-bs%d-D%d" % g)
def test_page_round_trip_is_exact_on_the_card(cuda, geom, dtype):
    """read_pages into pinned host rows, an in-place overwrite of the
    source pages issued right after (the stream orders it behind the
    copy), then write_pages into fresh pages: every pool tensor's rows
    ``torch.equal`` to the originals, every other page untouched."""
    from mxtpu_torch.models.transformer import TransformerLM, pool_tensors

    L, KV, bs, D = geom
    model = TransformerLM(64, KV * D, 32, L, KV, KV, device=cuda)
    n = 24
    pools = model.init_block_pool(n, bs, dtype)
    g = torch.Generator(device="cuda").manual_seed(sum(geom))
    for t in pool_tensors(pools):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device="cuda", dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    before = [t.clone() for t in pool_tensors(pools)]
    src, dst = [5, 17, 2, 9, 23, 1], [3, 22, 11, 4, 7, 20]
    host = model.read_pages(pools, src)
    for t in pool_tensors(pools):
        t[src] = 0
    model.write_pages(pools, dst, host)
    torch.cuda.synchronize()
    assert host.device.type == "cpu" and host.is_pinned()
    rest = [p for p in range(n) if p not in src + dst]
    for t, b in zip(pool_tensors(pools), before):
        assert torch.equal(t[dst], b[src])
        assert torch.equal(t[rest], b[rest])


def _tiny_pair():
    from mxtpu_torch.models.transformer import llama_tiny

    torch.manual_seed(0)
    cpu = llama_tiny(vocab_size=50, device="cpu")
    card = llama_tiny(vocab_size=50, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _scenario(eng, name):
    """One hierarchy scenario on one engine; returns its streams, stats
    and the pool's page bookkeeping after every drain."""
    from mxtpu_torch.resilience import fault_plan

    rng = np.random.RandomState(5)
    out = []

    def drain(plan=None):
        with (fault_plan(plan) if plan else _nullcontext()):
            res = eng.run()
        out.append(({r: t.numpy().tolist() for r, t in res.items()},
                    eng.stats, list(eng._bp._free), dict(eng._bp._pins),
                    sorted((c.tick, list(c.pages), c.sid)
                           for c in eng._hc._chains.values())))
        return res

    p = rng.randint(0, 50, (1, 19)).astype(np.int32)
    if name == "round_trip":
        for _ in range(2):
            eng.submit(p, 5)
            drain()
    elif name == "sessions":
        prompts = [rng.randint(0, 50, (1, 10 + 3 * s)).astype(np.int32)
                   for s in range(3)]
        for turn in range(3):
            rids = [eng.submit(prompts[s], 6, session=s) for s in range(3)]
            res = drain()
            prompts = [np.concatenate([res[r].numpy(), rng.randint(
                0, 50, (1, 4)).astype(np.int32)], 1) for r in rids]
        for s in range(3):
            eng.close_session(s)
        eng.drop_cache()
        drain()
    elif name == "overlap":
        eng.submit(p[:, :16], 4)
        drain()
        eng.submit(rng.randint(0, 50, (1, 6)).astype(np.int32), 12)
        for _ in range(3):
            eng.step()
        eng.submit(np.concatenate([p[:, :16], p[:, 16:]], 1), 4)
        drain()
    else:                                           # a swap_in fault
        eng.submit(p, 5)
        drain()
        r = eng.submit(p, 5, retries=1)
        # (greedy: a sampled neighbour draws from the card's generator)
        eng.submit(rng.randint(0, 50, (1, 6)).astype(np.int32), 4)
        drain("serving.swap_in#%d@1:raise=OSError(copy lost)" % r)
    return out


def _nullcontext():
    import contextlib
    return contextlib.nullcontext()


HIERARCHY_SCENARIOS = {
    "round_trip": dict(pin_bytes=1, host_cache_bytes="1MiB"),
    "sessions": dict(max_length=96, num_blocks=10, pin_bytes=0,
                     host_cache_bytes="1MiB"),
    "overlap": dict(max_length=48, pin_bytes=0, host_cache_bytes="4MiB",
                    overlap_swaps=True),
    "fault": dict(pin_bytes=1, host_cache_bytes="1MiB"),
}


@pytest.mark.parametrize("name", list(HIERARCHY_SCENARIOS))
def test_hierarchical_engine_on_the_card_equals_the_cpu(cuda, name):
    """The paged engine with the hierarchical cache on a tiny float32
    model: the card's run (K1 and K2, copies through pinned memory) and
    the CPU's give the same streams, stats and page bookkeeping after
    every drain."""
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    cfg = dict(dict(num_slots=2, max_length=48, block_size=8,
                    prefill_chunk=8), **HIERARCHY_SCENARIOS[name])
    cpu, card = _tiny_pair()
    got = _scenario(PagedContinuousBatchingEngine(card, **cfg), name)
    want = _scenario(PagedContinuousBatchingEngine(cpu, device="cpu", **cfg),
                     name)
    assert got == want
    st = got[-1][1]
    assert st["swapped_in_blocks"] > 0 and st["swapped_out_blocks"] > 0
    assert st["swap_out_failures"] == 0
    if name == "fault":
        assert (st["quarantined_requests"], st["retried_requests"]) == (1, 1)
    if name == "overlap":
        assert st["deferred_swap_in_requests"] == 1
    if name == "sessions":
        assert st["blocks_in_use"] == st["pinned_blocks"] == 0


# -- observability, live weight hot-swap and cancel -------------------------

def _tiny_generation(seed, dtype=torch.bfloat16, hidden=172):
    """llama_tiny's geometry from ``seed``; ``hidden`` its FFN width (G1's
    bf16 kernel takes K % 8 == 0, which llama_tiny's 172 is not, so the
    bf16 case widens it to 176)."""
    from mxtpu_torch.models.transformer import TransformerLM

    torch.manual_seed(seed)
    return TransformerLM(50, units=64, hidden_size=hidden, num_layers=2,
                         num_heads=4, num_kv_heads=2, device="cuda",
                         dtype=dtype)


@pytest.mark.parametrize("dtype,hidden", [(torch.bfloat16, 176),
                                          (torch.float32, 172)],
                         ids=["bf16-ffn176", "f32-llama_tiny"])
def test_hot_swap_and_cancel_on_the_card(cuda, tmp_path, dtype, hidden):
    """Phase 6e(b)'s schedule (``chip_smoke.hotswap_run``) at llama_tiny's
    size on the card: streams in flight at adopt() finish on A and equal
    an engine that never adopts, later ones equal a fresh engine on B
    loaded by ``load_mxtpu_params``, rollback returns to A, a corrupt
    copy is refused with the generation unchanged, a cancelled request's
    pages come back and the other streams stay A's; K1, K2 and G1
    launched throughout."""
    import chip_smoke
    from mxtpu_torch.models.convert import (export_mxtpu_params,
                                            load_mxtpu_params)

    a, b = (_tiny_generation(s, dtype, hidden) for s in (0, 1))
    named = export_mxtpu_params(b)
    fresh_b = load_mxtpu_params(_tiny_generation(2, dtype, hidden), named)
    path = str(tmp_path / "generation-b.ckpt")
    chip_smoke.write_generation(named, path)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, 50, (1, t)), kw) for t, kw in (
        (9, {}), (4, dict(temperature=0.8, seed=11)), (17, {}), (6, {}),
        (12, {}), (5, dict(temperature=0.7, top_p=0.9, seed=2)))]
    cfg = dict(num_slots=4, max_length=48, block_size=8, prefill_chunk=8)
    base.reset_counts()
    rec, problems = chip_smoke.hotswap_run(a, fresh_b, path, reqs, cfg, 8,
                                           split=4)
    assert problems == []
    counts = base.counts()
    for k in ("paged_attention", "paged_prefill", "rows_linear",
              "rows_norm_linear"):
        assert counts.get(k, 0) > 0, (k, counts)
    assert rec["placed_bytes"] == sum(p.numel() * p.element_size()
                                      for p in a.parameters())
    p = torch.from_numpy(reqs[0][0]).cuda()
    assert not torch.equal(a.generate(p, 8), fresh_b.generate(p, 8))


def test_engine_spans_are_profiler_ranges_on_the_card(cuda):
    """Under a recording ``torch.profiler`` each traced iteration is one
    ``engine.iteration`` range; an untraced one opens none; tracing
    leaves the streams and the launches as they were."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxtpu_torch.observability import tracing
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    model = _tiny_generation(0, torch.float32)
    prompts = [np.random.RandomState(s).randint(0, 50, (1, 11 + s))
               for s in range(3)]
    out = {}
    for traced in (False, True):
        eng = PagedContinuousBatchingEngine(model, num_slots=2,
                                            max_length=48, block_size=8,
                                            prefill_chunk=8)
        rids = [eng.submit(p, 5) for p in prompts]
        base.reset_counts()
        with (tracing() if traced else contextlib.nullcontext()) as tr, \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            steps = 0
            while eng.pending or eng.active:
                eng.step()
                steps += 1
            torch.cuda.synchronize()
        res = eng.run()
        # the host's ranges (the profiler also mirrors each on the device's
        # timeline as a user annotation)
        ranges = sum(1 for e in prof.events() if e.name == "engine.iteration"
                     and e.device_type == DeviceType.CPU)
        out[traced] = ([res[r].numpy() for r in rids], base.counts())
        assert ranges == (steps if traced else 0)
        if traced:
            assert tr.span_count() == steps
    for x, y in zip(out[False][0], out[True][0]):
        np.testing.assert_array_equal(x, y)
    assert out[False][1] == out[True][1]


# -- the replica service layer on the card --------------------------------

def _serve_alone(model, prompts, n, **cfg):
    """Each prompt's stream from one paged engine over ``model``."""
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    eng = PagedContinuousBatchingEngine(model, **cfg)
    rids = [eng.submit(p, n) for p in prompts]
    res = eng.run()
    return [res[r].numpy() for r in rids]


def test_gateway_replica_death_on_the_card(cuda):
    """Two paged replicas sharing one bf16 model behind a ``Gateway``;
    ``replica.health#r1`` declares r1 dead mid-decode: its requests are
    drained and requeued, every stream equals one engine's alone, r1
    holds no page, and K1, K2 and G1 launched."""
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine
    from mxtpu_torch.resilience import fault_plan
    from mxtpu_torch.serving import Gateway

    model = _tiny_generation(0, torch.bfloat16, 176)
    cfg = dict(num_slots=2, max_length=48, block_size=8, prefill_chunk=8)
    prompts = [np.random.RandomState(s).randint(0, 50, (1, 5 + 3 * s))
               for s in range(4)]
    want = _serve_alone(model, prompts, 8, **cfg)
    engines = [PagedContinuousBatchingEngine(model, ledger_tag="r%d" % i,
                                             **cfg) for i in range(2)]
    gw = Gateway(engines, fail_threshold=1, hedge_fraction=None)
    rids = [gw.submit(p, 8) for p in prompts]
    base.reset_counts()
    with fault_plan("replica.health#r1@4:raise=OSError(lost)"):
        res = gw.run()
    counts = base.counts()
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(res[rid].numpy(), w)
    st = gw.stats
    assert st["supervisor"]["deaths"] == 1 and st["requeued_requests"] >= 1
    assert (engines[1].stats["blocks_in_use"],
            engines[1].stats["pinned_blocks"]) == (0, 0)
    for k in ("paged_attention", "paged_prefill", "rows_linear",
              "rows_norm_linear"):
        assert counts.get(k, 0) > 0, (k, counts)


def test_subprocess_worker_on_the_card(cuda):
    """One ``SubprocessReplica`` worker whose engine runs on the card
    (the demo factory, no device named): its streams equal the
    in-process engine's over the same seeded net, and it exits 0."""
    from mxtpu_torch.serving import Gateway, SubprocessReplica
    from mxtpu_torch.serving.worker import seeded_llama_tiny

    prompts = [np.random.RandomState(s).randint(0, 50, (1, 4 + s))
               for s in range(3)]
    want = _serve_alone(seeded_llama_tiny(77, 50, "cuda"), prompts, 6,
                        num_slots=2, max_length=32, block_size=8,
                        prefill_chunk=8, pin_bytes="1MiB")
    rep = SubprocessReplica("mxtpu_torch.serving.worker:demo_paged_engine")
    try:
        gw = Gateway([rep])
        rids = [gw.submit(p, 6) for p in prompts]
        res = gw.run()
        for rid, w in zip(rids, want):
            np.testing.assert_array_equal(res[rid].numpy(), w)
        rep.shutdown()
        assert rep.exit_code == 0
    finally:
        rep.close()


def test_engines_sharing_one_model_adopt_apart_on_the_card(cuda, tmp_path):
    """Two paged engines over ONE bf16 model: e1 adopts generation B while
    e2 decodes; e2's streams equal an engine that never adopts, e1's
    after the install equal an engine over a fresh B, and the model
    itself still serves A."""
    import chip_smoke
    from mxtpu_torch.models.convert import (export_mxtpu_params,
                                            load_mxtpu_params)
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    a = _tiny_generation(0, torch.bfloat16, 176)
    named = export_mxtpu_params(_tiny_generation(1, torch.bfloat16, 176))
    fresh_b = load_mxtpu_params(_tiny_generation(2, torch.bfloat16, 176),
                                named)
    path = str(tmp_path / "b.ckpt")
    chip_smoke.write_generation(named, path)
    cfg = dict(num_slots=2, max_length=48, block_size=8, prefill_chunk=8)
    prompts = [np.random.RandomState(s).randint(0, 50, (1, 6 + s))
               for s in range(2)]
    want_a = _serve_alone(a, prompts, 12, **cfg)
    want_b = _serve_alone(fresh_b, prompts, 12, **cfg)
    e1, e2 = (PagedContinuousBatchingEngine(a, ledger_tag=t, **cfg)
              for t in ("e1", "e2"))
    r2 = e2.submit(prompts[0], 12)
    e2.step()
    assert e1.adopt(path) == 1
    r1 = e1.submit(prompts[0], 12)
    while e1.status(r1) in ("queued", "active") or \
            e2.status(r2) in ("queued", "active"):
        e1.step()
        e2.step()
    np.testing.assert_array_equal(e2.take_result(r2).numpy(), want_a[0])
    np.testing.assert_array_equal(e1.take_result(r1).numpy(), want_b[0])
    assert (e1.stats["param_generation"], e2.stats["param_generation"]) == \
        (1, 0)
    r2 = e2.submit(prompts[1], 12)
    r1 = e1.submit(prompts[1], 12)
    np.testing.assert_array_equal(e2.run()[r2].numpy(), want_a[1])
    np.testing.assert_array_equal(e1.run()[r1].numpy(), want_b[1])
    p = torch.from_numpy(prompts[1]).cuda()
    assert torch.equal(a.generate(p, 12), _tiny_generation(
        0, torch.bfloat16, 176).generate(p, 12))
