"""Q1's stem route and Q2's split of K, emulated on the CPU (the kernels,
``qconv_stem_kernel`` and ``qfc_kernel`` in ``csrc/quantized.cu``, run
on the card only: ``tests/test_torch_cuda.py -k quant``).

- The stem kernel's data movement in its own arithmetic, tile by tile:
  the input patch of 4-byte words it stages (each plane's row copied in
  16-column items from the tile's first column floored to 16, a word a
  pixel holding its channels, zeros off the image and past the group's
  channels), the (r, s padded to 8, c padded
  to 4) A row each fragment register reads from it (one word a tap, taps
  past the kernel's width clamped to its last), the repacked weights
  (``pack_weight(w, stem=True)``), and the output runs its warps write.
  Their int32 product equals ``qconv_sums`` bit for bit, and every output
  element is written once, at ResNet-50's stem at batch 2, at 1 to 4
  channels, strides 1 and 2, pads 0 and 3, dilation 2, odd sizes (225 x
  223), partial row and column tiles, groups, kernels wider than 8 taps
  and output channels past 64; with the epilogue, the result equals the
  JAX reference's ``quantized_conv``.
- ``route`` naming "stem", "nchw" and "nhwc" on the payloads that take
  each; the stem's tile plan and its shared memory.
- Q2's plan (``_plan_fc``): its splits cover K once, the classifier's
  grid fills the H100's 132 SMs, one split where K is short; the
  split-K partial sums, added in every order, equal ``qfc_sums``.

Tolerances: none; every comparison is exact (int32 sums are exact in any
order; both sides round the same float32 operations once each)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.contrib import quantization as R
from mxtpu_torch import base
from mxtpu_torch.contrib import quantization as P
from mxtpu_torch.ops import quantized as Q


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the stem kernel, emulated -----------------------------------------------

def _patch(xg, ih0, iw0, PR, PW, PWp):
    """The block's staged patch (PR, PWp) of uint32 words, as the kernel
    fills it: item (pr, q) copies columns qb + 16 q .. + 15 (qb = iw0
    floored to a multiple of 16) of each plane's input row ih0 + pr into
    the raw rows, zero off the image, then turns them into words
    (qb + 16 q + b - qb, column b's channels in bytes c0 .. c3).  xg: the
    group's planes (Cg, H, W) int8.  Returns the patch, its column of
    iw0 (off) and how often each word was written."""
    Cg, H, W = xg.shape
    qb = iw0 & ~15
    off = iw0 - qb
    nq = (off + PW + 15) >> 4
    assert 16 * nq <= PWp           # the items fit a patch (and raw) row
    pr, col = np.meshgrid(np.arange(PR), np.arange(16 * nq), indexing="ij")
    ih, iw = ih0 + pr, qb + col
    inside = (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
    word = np.zeros(pr.shape, np.uint32)
    for c in range(Cg):
        v = xg[c][np.clip(ih, 0, H - 1), np.clip(iw, 0, W - 1)]
        byte = np.where(inside, v.view(np.uint8), 0).astype(np.uint32)
        word |= byte << np.uint32(8 * c)
    patch = np.zeros((PR, PWp), np.uint32)
    writes = np.zeros((PR, PWp), np.int64)
    patch[pr, col] = word
    np.add.at(writes, (pr, col), 1)
    return patch, off, writes


def _a_rows(patch, PWp, off, P, TW, KH, KW, sh, sw, dh, dw):
    """The A rows the block's fragments read: for each of its warps'
    pixels (32 a warp, past the block's last its last again) and each
    K byte k = (r * SB + sb) * 32 + s8 * 4 + c, byte c of the word at
    patch row i * sh + r * dh, column off + j * sw + min(8 sb + s8,
    KW - 1) * dw.  Returns (32 * warps, K) int64 and the largest row and
    column read."""
    SB = -(-KW // 8)
    p = np.minimum(np.arange(-(-P // 32) * 32), P - 1)
    i, j = p // TW, p % TW
    r, sb, s8 = np.meshgrid(np.arange(KH), np.arange(SB), np.arange(8),
                            indexing="ij")
    rows = (i * sh)[:, None] + (r * dh).reshape(-1)[None, :]
    cols = (off + j * sw)[:, None] + \
        (np.minimum(8 * sb + s8, KW - 1) * dw).reshape(-1)[None, :]
    words = patch[rows, cols]
    bytes_ = ((words[:, :, None] >> (np.uint32(8) * np.arange(
        4, dtype=np.uint32))) & 0xFF).astype(np.uint8).view(np.int8)
    return (bytes_.reshape(len(p), -1).astype(np.int64), int(rows.max()),
            int(cols.max()))


def _stem_emulated(x, w, stride, pad, dilate, groups, tile=None):
    """The stem kernel's int32 output (N, Co, OH, OW), block by block, and
    each output element's count of writes.  ``tile``: (R, TW), else
    ``_plan_stem``'s."""
    N, C, H, W = x.shape
    Co, Cg, KH, KW = w.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
    OH = Q.conv_out_size(H, KH, sh, ph, dh)
    OW = Q.conv_out_size(W, KW, sw, pw, dw)
    Rt, TW = tile or Q._plan_stem(OH, OW, KH, KW, sh, sw, dh, dw)
    assert Rt * TW <= 256
    assert Q._stem_smem(Rt, TW, KH, KW, sh, sw, dh, dw) <= Q._SMEM
    RT, CT = -(-OH // Rt), -(-OW // TW)
    PR = (Rt - 1) * sh + (KH - 1) * dh + 1
    PW = (TW - 1) * sw + (KW - 1) * dw + 1
    PWp = -(-(PW + 15) // 16) * 16
    P = Rt * TW
    packed = Q.pack_weight(_t(w), stem=True).numpy().astype(np.int64)
    Kp = packed.shape[1]
    assert Kp == KH * -(-KW // 8) * 32
    Ng = Co // groups
    out = np.zeros((N, Co, OH, OW), np.int64)
    writes = np.zeros((N, Co, OH, OW), np.int64)
    flat, wflat = out.reshape(-1), writes.reshape(-1)
    for img, rt, ct, g in itertools.product(range(N), range(RT), range(CT),
                                            range(groups)):
        oh0, ow0 = rt * Rt, ct * TW
        patch, off, staged = _patch(x[img, g * Cg:(g + 1) * Cg],
                                    oh0 * sh - ph, ow0 * sw - pw, PR, PW,
                                    PWp)
        assert staged.max() == 1     # each word staged once at most
        A, row, col = _a_rows(patch, PWp, off, P, TW, KH, KW, sh, sw, dh,
                              dw)
        assert row < PR and col < PWp and (staged[:, off:off + PW] == 1).all()
        for n0 in range(0, Ng, 64):
            wt = np.zeros((64, Kp), np.int64)
            rows = packed[g * Ng + n0:g * Ng + min(n0 + 64, Ng)]
            wt[:len(rows)] = rows
            S = (A @ wt.T).T         # the staged tile, channel-major
            # the warps' runs: a channel's rows as one run where the tile
            # spans the image's width, else one run a (channel, row)
            nch, nrows = min(64, Ng - n0), min(Rt, OH - oh0)
            whole = TW == OW
            ln = nrows * OW if whole else min(TW, OW - ow0)
            for c in range(nch):
                ch = g * Ng + n0 + c
                for i in ([0] if whole else range(nrows)):
                    e0 = ((img * Co + ch) * OH + oh0 + i) * OW + ow0
                    s0 = i * TW
                    flat[e0:e0 + ln] = S[c, s0:s0 + ln]
                    wflat[e0:e0 + ln] += 1
    return out, writes


#: (N, C, C_out, kernel, stride, pad, dilate, groups, H, W): ResNet-50's
#: stem at batch 2, then 1 to 4 channels, strides, pads, dilation 2, odd
#: sizes, partial tiles, groups, a kernel wider than 8 taps, channel tails
STEM_CASES = [
    (2, 3, 64, 7, 2, 3, 1, 1, 224, 224),
    (2, 3, 64, 7, 2, 3, 1, 1, 225, 223),
    (1, 1, 16, 3, 1, 1, 1, 1, 17, 19),
    (2, 2, 64, 7, 2, 3, 1, 1, 30, 30),
    (1, 4, 72, 5, 2, 0, 1, 1, 21, 26),
    (1, 3, 8, 3, 1, 0, 2, 1, 15, 13),
    (1, 3, 32, 7, 1, 3, 2, 1, 19, 17),
    (2, 6, 10, 3, 1, 2, 2, 2, 10, 12),
    (1, 3, 130, 11, 4, 2, 1, 1, 35, 37),
    (1, 4, 24, 1, 1, 0, 1, 1, 9, 7),
    (1, 1, 1, 1, 1, 0, 1, 1, 1, 1),
]


def _case(N, C, Co, k, s, p, d, groups, H, W, seed):
    rng = np.random.RandomState(seed)
    x = _int8(rng, N, C, H, W)
    w = _int8(rng, Co, C // groups, k, k)
    return x, w, ((s, s), (p, p), (d, d), groups)


@pytest.mark.parametrize("case", STEM_CASES,
                         ids=lambda c: "N%d-%dto%d-k%ds%dp%dd%dg%d-%dx%d" % c)
def test_stem_emulation_equals_qconv_sums(case):
    x, w, geo = _case(*case, seed=sum(case))
    got, writes = _stem_emulated(x, w, *geo)
    want = Q.qconv_sums(_t(x), _t(w), *geo).numpy()
    assert (writes == 1).all()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("tile", [(1, 112), (3, 37), (4, 29), (1, 5),
                                  (16, 16), (7, 1)],
                         ids=lambda t: "R%d-TW%d" % t)
def test_stem_emulation_holds_at_other_tiles(tile):
    """Tiles narrower than the image (a run a row, columns off a 4-pixel
    boundary), rows that leave a partial last tile, one column."""
    x, w, geo = _case(1, 3, 64, 7, 2, 3, 1, 1, 45, 47, seed=5)
    got, writes = _stem_emulated(x, w, *geo, tile=tile)
    assert (writes == 1).all()
    assert np.array_equal(got, Q.qconv_sums(_t(x), _t(w), *geo).numpy())


def test_stem_emulation_with_the_epilogue_equals_the_reference():
    """The emulated sums through Q1's epilogue (float32 ``acc * scale``,
    then ``+ bias``) equal the reference's ``quantized_conv`` at the
    stem, bit for bit."""
    x, w, geo = _case(1, 3, 64, 7, 2, 3, 1, 1, 224, 224, seed=9)
    b = np.random.RandomState(3).randn(64).astype("f")
    ranges = [np.float32(v) for v in (-1.7, 2.3, -0.41, 0.5)]
    want = R.quantized_conv(jnp.asarray(x), jnp.asarray(w),
                            *[jnp.asarray(v) for v in ranges],
                            bias=jnp.asarray(b), kernel=(7, 7),
                            stride=(2, 2), pad=(3, 3), num_filter=64)
    t = [torch.tensor(v) for v in ranges]
    scale = P._combined_scale(_t(x), *t)
    sums, _ = _stem_emulated(x, w, *geo)
    got = Q._epilogue(torch.from_numpy(sums).to(torch.int32), scale,
                      _t(b), (1, -1, 1, 1))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_pack_weight_stem_pads_taps_to_8_and_channels_to_4():
    w = _t(_int8(np.random.RandomState(4), 5, 3, 7, 7))
    packed = Q.pack_weight(w, stem=True)
    assert tuple(packed.shape) == (5, 224) and packed.is_contiguous()
    v = packed.view(5, 7, 8, 4)
    assert torch.equal(v[:, :, :7, :3], w.permute(0, 2, 3, 1))
    assert not v[:, :, 7].any() and not v[:, :, :, 3].any()
    wide = Q.pack_weight(_t(_int8(np.random.RandomState(5), 2, 1, 3, 11)),
                         stem=True)
    assert tuple(wide.shape) == (2, 3 * 2 * 32)


# -- the route and the stem's plan -----------------------------------------

def test_route_names_each_kernel_by_layout_and_channels():
    cl = torch.channels_last
    for C in (1, 2, 3, 4):
        x = torch.zeros((2, C, 9, 9), dtype=torch.int8)
        assert Q.route(x, 1, (7, 7)) == "stem"
    x = torch.zeros((2, 6, 9, 9), dtype=torch.int8)
    assert Q.route(x, 2, (3, 3)) == "stem"            # 3 a group
    assert Q.route(x, 1, (3, 3)) == "nchw"            # 6 a group
    for C in (5, 7, 8):
        assert Q.route(torch.zeros((1, C, 9, 9), dtype=torch.int8)) == \
            "nchw"
    y = torch.zeros((2, 64, 9, 9), dtype=torch.int8)
    assert Q.route(y.contiguous(memory_format=cl), 1, (3, 3)) == "nhwc"
    assert Q.route(y, 1, (3, 3)) == "nchw"
    # a channels-last 3-channel payload: neither the stem's nor NCHW
    assert Q.route(torch.zeros((2, 3, 9, 9), dtype=torch.int8)
                   .contiguous(memory_format=cl)) is None
    # a window too wide for a block's shared memory keeps the byte gather
    assert Q.route(torch.zeros((1, 3, 9, 9), dtype=torch.int8), 1, (7, 7),
                   (40, 40)) == "nchw"
    assert Q.route(torch.zeros((1, 3, 9, 9), dtype=torch.int8), 1, (7, 7),
                   (20, 20)) == "stem"


def test_stem_plan_takes_whole_rows_and_fits_shared_memory():
    """The stem at 224: tiles of 2 rows of 112 (224 pixels, 7168 tiles at
    batch 128); every plan keeps 256 pixels a tile and fits 227 KB."""
    assert Q._plan_stem(112, 112, 7, 7, 2, 2, 1, 1) == (2, 112)
    # 64 weight rows of 224 + 16 bytes, 9 patch rows of 256 words, 9 x 4
    # raw rows of 256 bytes, the staged 64 x (224 + 4) ints: 91 KB, two
    # blocks an SM
    assert Q._stem_smem(2, 112, 7, 7, 2, 2, 1, 1) == \
        64 * 240 + 9 * 256 * 4 + 9 * 4 * 256 + 64 * 228 * 4
    assert -(-112 // 2) * 128 == 7168
    for geo in [(56, 300, 7, 7, 2, 2, 1, 1), (1, 1, 3, 3, 1, 1, 1, 1),
                (14, 14, 16, 16, 16, 16, 1, 1), (20, 20, 7, 7, 1, 1, 20, 20),
                (500, 7, 3, 3, 1, 1, 1, 1)]:
        R_, TW = Q._plan_stem(*geo)
        assert 1 <= R_ * TW <= 256 and TW <= geo[1] and R_ <= geo[0]
        assert Q._stem_smem(R_, TW, *geo[2:]) <= Q._SMEM
    assert Q._plan_stem(20, 20, 7, 7, 1, 1, 40, 40) is None


def test_stem_counts_on_the_cpu():
    x, w, geo = _case(1, 3, 8, 7, 2, 3, 1, 1, 20, 20, seed=1)
    base.reset_counts()
    Q.qconv(_t(x), _t(w), torch.tensor(1e-3), None, *geo)
    assert base.counts() == {Q.QCONV: 1, Q.QCONV_STEM: 1}
    base.reset_counts()
    x5, w5, geo5 = _case(1, 5, 8, 3, 1, 1, 1, 1, 9, 9, seed=2)
    Q.qconv(_t(x5), _t(w5), torch.tensor(1e-3), None, *geo5)
    assert base.counts() == {Q.QCONV: 1}


# -- Q2's split of K ---------------------------------------------------------

def _fc_splits(K, S):
    """The 64-byte steps (first, end) each of Q2's S splits walks, as
    ``qfc_kernel`` deals them: split z takes steps z * nk // S ..
    (z + 1) * nk // S of the nk steps of K padded to 32."""
    nk = Q._fc_steps(K)
    return [(z * nk // S, (z + 1) * nk // S) for z in range(S)]


@pytest.mark.parametrize("K", [32, 64, 96, 147, 256, 2048, 2080, 4608])
def test_fc_splits_cover_k_once(K):
    for M, N in ((128, 1000), (1, 1000), (77, 1000), (200, 1000),
                 (5, 7)):
        S = Q._plan_fc(M, N, K)
        nk = -(-(-(-K // 32) * 32) // 64)
        assert 1 <= S <= 8
        spans = _fc_splits(K, S)
        assert spans[0][0] == 0 and spans[-1][1] == nk
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        if S > 1:
            assert all(e - s >= 2 for s, e in spans)


def test_fc_plan_fills_the_card_at_the_classifier_and_keeps_short_k_whole():
    S = Q._plan_fc(128, 1000, 2048)
    assert S == 5 and 2 * 16 * S >= 132
    assert Q._plan_fc(128, 1000, 64) == 1
    assert Q._plan_fc(128, 1000, 96) == 1          # 2 steps: no split of 2
    assert Q._plan_fc(1, 1000, 2048) == 8          # 16 tiles: the cluster cap
    assert Q._plan_fc(1024, 1024, 4096) == 1       # 256 tiles fill the card
    assert _fc_splits(2080, 4) == [(0, 8), (8, 16), (16, 24), (24, 33)]


@pytest.mark.parametrize("shape", [(128, 2048, 1000), (77, 2080, 65),
                                   (3, 320, 9)],
                         ids=lambda s: "M%d-K%d-N%d" % s)
def test_split_k_partial_sums_in_every_order_equal_qfc_sums(shape):
    """Each split's int32 partial tile over its 64-byte steps of the
    padded K, added in every order of the splits (the kernel's blocks sum
    them in rank order; any order gives the same bits), equals
    ``qfc_sums``; block z's rows 64 z / S .. cover the tile once."""
    M, K, N = shape
    rng = np.random.RandomState(sum(shape))
    x, w = _t(_int8(rng, M, K)), _t(_int8(rng, N, K))
    xp = Q.pack_weight(x).numpy().astype(np.int64)
    wp = Q.pack_weight(w).numpy().astype(np.int64)
    S = Q._plan_fc(M, N, K)
    parts = [xp[:, 64 * a:64 * b] @ wp[:, 64 * a:64 * b].T
             for a, b in _fc_splits(K, S)]
    want = Q.qfc_sums(x, w).numpy()
    for order in itertools.permutations(range(S)):
        acc = np.zeros((M, N), np.int32)
        for z in order:
            acc = acc + parts[z].astype(np.int32)
        assert np.array_equal(acc, want)
    rows = [range(z * 64 // S, (z + 1) * 64 // S) for z in range(S)]
    assert sorted(r for rr in rows for r in rr) == list(range(64))
