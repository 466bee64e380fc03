"""The port's int8 KV cache, held against the JAX reference on the same
seeded numpy inputs: the quantizer (``_q8_quantize``, payload and scales
bit for bit), the int8 paged cache ops and the contiguous cache's write
and dequantize (exact: they move or quantize data the same way), and the
plain versions of K1's and K2's int8 forms against the reference's
Pallas kernels in interpret mode and its ``xla_reference`` (1e-5: all
compute in float32 and differ only in the order of their sums).

The reference's cache ops return new arrays; the port's write in place,
so the port's arrays after the call are compared with the reference's
results."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import tree_anc
from mxtpu.ops import tensor as jtensor
from mxtpu.ops.pallas import paged_attention as jpa
from mxtpu.ops.pallas import prefill_attention as jpf
from mxtpu_torch.ops import paged_attention, prefill_attention, tensor

TOL = dict(atol=1e-5, rtol=1e-5)
KV, REP, D, BS, N = 2, 2, 16, 8, 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def _q8_rows(rng, shape):
    """Rows with every corner of the quantizer: random values, a zero
    row, a row whose x / s lands on .5 ties, one with a lone maximum and
    values clipped at ±127 by rounding, and a tiny row under the
    scale floor."""
    x = rng.randn(*shape).astype(np.float32) * 3
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1] = np.linspace(-127, 127, shape[-1]).astype(np.float32)
    flat[1, :4] = [0.5, -0.5, 2.5, -126.5]      # ties at s = 1
    flat[2] = rng.randn(shape[-1]).astype(np.float32)
    flat[2, 3] = 1e4                            # everything else near 0
    flat[3] = 1e-10
    return x


@pytest.mark.parametrize("shape", [(6, 16), (2, 3, 5, 16), (4, 1, 128)])
def test_q8_quantize_is_the_reference_bit_for_bit(shape):
    x = _q8_rows(np.random.RandomState(len(shape)), shape)
    jq, js = jtensor._q8_quantize(jnp.asarray(x))
    q, s = tensor._q8_quantize(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), _np(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  _np(js).view(np.int32))
    # a zero row dequantizes to exact zeros
    deq = tensor.cache_dequant(q, s).numpy().reshape(-1, shape[-1])
    assert not deq[0].any()


def test_q8_quantize_of_bfloat16_rows():
    x = torch.from_numpy(_q8_rows(np.random.RandomState(9), (5, 32)))
    xb = x.bfloat16()
    jq, js = jtensor._q8_quantize(jnp.asarray(xb.float().numpy()))
    q, s = tensor._q8_quantize(xb)
    np.testing.assert_array_equal(q.numpy(), _np(jq))
    np.testing.assert_array_equal(s.numpy(), _np(js))


def _pair(rng, n=N, kv=KV, bs=BS, d=D):
    """An int8 pool and its scales, every row already quantized."""
    q, s = tensor._q8_quantize(_t(rng.randn(n, kv, bs, d).astype(
        np.float32)))
    return q.numpy(), s.numpy()


def test_paged_cache_gather_q8_matches_reference():
    rng = np.random.RandomState(3)
    pool, scales = _pair(rng)
    tables = np.array([[3, 1, 0], [5, 2, 11]], np.int32)
    want = _np(jtensor._paged_cache_gather_q8(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(tables)))
    got = tensor.paged_cache_gather_q8(_t(pool), _t(scales), _t(tables))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("start", [0, 3, 6])
def test_paged_cache_write_q8_matches_reference(start):
    rng = np.random.RandomState(4)
    pool, scales = _pair(rng)
    new = _q8_rows(rng, (1, KV, 5, D))
    table = np.array([4, 2, 5, 0], np.int32)
    wp, ws = jtensor._paged_cache_write_q8(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(new),
        jnp.asarray(table), start_pos=start)
    gp, gs = _t(pool), _t(scales)
    out = tensor.paged_cache_write_q8(gp, gs, _t(new), _t(table), start)
    assert out[0] is gp and out[1] is gs        # in place
    np.testing.assert_array_equal(gp.numpy(), _np(wp))
    np.testing.assert_array_equal(gs.numpy(), _np(ws))


def test_paged_cache_write_rows_q8_matches_reference():
    """The dead lane (all-null table, position 0) writes only page 0,
    payload and scale alike."""
    rng = np.random.RandomState(5)
    pool, scales = _pair(rng)
    new = _q8_rows(rng, (3, KV, 1, D))
    tables = np.array([[2, 3, 0], [0, 0, 0], [5, 1, 4]], np.int32)
    pos = np.array([5, 0, 10], np.int32)
    wp, ws = jtensor._paged_cache_write_rows_q8(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(new),
        jnp.asarray(tables), jnp.asarray(pos))
    gp, gs = _t(pool), _t(scales)
    tensor.paged_cache_write_rows_q8(gp, gs, _t(new), _t(tables), _t(pos))
    np.testing.assert_array_equal(gp.numpy(), _np(wp))
    np.testing.assert_array_equal(gs.numpy(), _np(ws))


def _span_case(seed):
    """Two live rows, the second's window crossing from its last page
    onto the table's null padding, and a dead row."""
    rng = np.random.RandomState(seed)
    pool, scales = _pair(rng, n=8)
    tables = np.array([[2, 6, 3], [5, 1, 0], [0, 0, 0]], np.int32)
    pos = np.array([2, 5, 0], np.int32)
    return rng, pool, scales, tables, pos


def test_paged_cache_write_span_q8_matches_reference():
    """Invalid lanes (past valid_len, off the table, a dead row) go to
    the null page on both the payload and the scale scatter."""
    rng, pool, scales, tables, pos = _span_case(9)
    new = _q8_rows(rng, (3, KV, 5, D))
    valid_len = np.array([4, 5, 0], np.int32)
    wp, ws = jtensor._paged_cache_write_span_q8(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(new),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(valid_len))
    gp, gs = _t(pool), _t(scales)
    tensor.paged_cache_write_span_q8(gp, gs, _t(new), _t(tables), _t(pos),
                                     _t(valid_len))
    # page 0 absorbs the invalid lanes: which of them lands is unspecified
    np.testing.assert_array_equal(gp.numpy()[1:], _np(wp)[1:])
    np.testing.assert_array_equal(gs.numpy()[1:], _np(ws)[1:])
    untouched = [4, 7]
    np.testing.assert_array_equal(gp.numpy()[untouched], pool[untouched])
    np.testing.assert_array_equal(gs.numpy()[untouched], scales[untouched])


@pytest.mark.parametrize("src_lane", [
    [[0, 3, 4, -1, -1], [0, 1, 2, 3, 4], [-1] * 5],   # a side branch
    [[2, 0, 1, 4, 3], [4, 3, 2, 1, 0], [0] * 5],       # sources = dests
])
def test_paged_cache_permute_span_q8_matches_reference(src_lane):
    """Payload and scales move with one index set; in the second case
    every source row of a slot is also a destination."""
    _, pool, scales, tables, pos = _span_case(10)
    sl = np.array(src_lane, np.int32)
    wp, ws = jtensor._paged_cache_permute_span_q8(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(tables),
        jnp.asarray(pos), jnp.asarray(sl))
    gp, gs = _t(pool), _t(scales)
    tensor.paged_cache_permute_span_q8(gp, gs, _t(tables), _t(pos), _t(sl))
    np.testing.assert_array_equal(gp.numpy()[1:], _np(wp)[1:])
    np.testing.assert_array_equal(gs.numpy()[1:], _np(ws)[1:])


@pytest.mark.parametrize("src,dst", [(3, 1), (2, 2)])
def test_paged_block_copy_moves_payload_and_scales(src, dst):
    rng = np.random.RandomState(6)
    pool, scales = _pair(rng)
    for arr in (pool, scales):
        want = _np(jtensor._paged_block_copy(jnp.asarray(arr), src=src,
                                             dst=dst))
        got = _t(arr)
        tensor.paged_block_copy(got, src, dst)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pos", [0, 5])
def test_contiguous_cache_write_q8_and_dequant_match_reference(pos):
    rng = np.random.RandomState(11)
    cache, scales = _pair(rng, n=2, bs=12)        # (B, KV, Tmax, D)
    new = _q8_rows(rng, (2, KV, 4, D))
    wc, ws = jtensor._internal_cache_write_q8(
        jnp.asarray(cache), jnp.asarray(scales), jnp.asarray(new), pos=pos)
    gc, gs = _t(cache), _t(scales)
    tensor.cache_write_q8(gc, gs, _t(new), pos)
    np.testing.assert_array_equal(gc.numpy(), _np(wc))
    np.testing.assert_array_equal(gs.numpy(), _np(ws))
    np.testing.assert_array_equal(
        tensor.cache_dequant(gc, gs).numpy(),
        _np(jtensor._internal_cache_dequant(wc, ws)))


# -- the plain int8 kernels ---------------------------------------------------

def _decode_case(seed, W=1):
    """Three live slots at ragged depths through out-of-order pages and
    one dead lane (all-null table, position 0); int8 pools."""
    rng = np.random.RandomState(seed)
    pk, ks = _pair(rng)
    pv, vs = _pair(rng)
    q = rng.randn(4, KV * REP, W, D).astype(np.float32)
    tables = np.array([[7, 2, 0, 0, 0],
                       [0, 0, 0, 0, 0],
                       [3, 11, 5, 9, 0],
                       [10, 0, 0, 0, 0]], np.int32)
    pos = np.array([12, 0, 29, 3], np.int32)
    if W > 1:
        pos = np.array([12 - W // 2, 0, 29 - W, 3], np.int32)
    return q, pk, pv, tables, pos, ks, vs


@pytest.mark.parametrize("W,tree", [(1, None), (2, None), (4, None),
                                    (8, None), (4, "branchy"),
                                    (8, "branchy"), (8, "chain")])
def test_plain_decode_q8_matches_reference_kernel_and_xla(W, tree):
    q, pk, pv, tables, pos, ks, vs = _decode_case(W, W)
    anc = None if tree is None else tree_anc(np.random.RandomState(W), 4,
                                              W, chain=tree == "chain")
    j = [jnp.asarray(a) for a in (q, pk, pv, tables, pos)]
    jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
               anc=None if anc is None else jnp.asarray(anc))
    want_kernel = _np(jpa.paged_decode_attention(*j, **jkw))
    want_xla = _np(jpa.xla_reference(*j, **jkw))
    got = paged_attention.paged_decode_attention_plain(
        *[_t(a) for a in (q, pk, pv, tables, pos)],
        anc=None if anc is None else _t(anc), k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    live = [0, 2, 3]                   # the dead lane's output is garbage
    np.testing.assert_allclose(got[live], want_kernel[live], **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)


@pytest.mark.parametrize("start,T", [(0, 16), (5, 8), (13, 8), (21, 16)])
def test_plain_prefill_q8_matches_reference_kernel_and_xla(start, T):
    """Chunks from position 0 and from mid-page starts, pages out of
    order, null padding, and a chunk padded past the last written
    position."""
    rng = np.random.RandomState(start + T)
    pk, ks = _pair(rng)
    pv, vs = _pair(rng)
    q = rng.randn(1, KV * REP, T, D).astype(np.float32)
    table = np.array([4, 9, 1, 6, 0, 0], np.int32)
    j = [jnp.asarray(a) for a in (q, pk, pv, table)]
    jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    want_kernel = _np(jpf.paged_prefill_attention(*j, start, **jkw))
    want_xla = _np(jpf.xla_reference(*j, start, **jkw))
    got = prefill_attention.paged_prefill_attention_plain(
        *[_t(a) for a in (q, pk, pv, table)], start, k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)


def test_plain_decode_q8_invariants():
    """On int8 pools, as on float ones: a chain ``anc`` gives the bits of
    no ``anc``, and lane w of a window equals a W = 1 call at pos + w."""
    q, pk, pv, tables, pos, ks, vs = [_t(a) for a in _decode_case(3, 8)]
    kw = dict(k_scales=ks, v_scales=vs)
    lin = paged_attention.paged_decode_attention_plain(q, pk, pv, tables,
                                                       pos, **kw)
    chain = paged_attention.paged_decode_attention_plain(
        q, pk, pv, tables, pos, anc=_t(tree_anc(None, 4, 8, chain=True)),
        **kw)
    assert torch.equal(lin, chain)
    for w in range(8):
        one = paged_attention.paged_decode_attention_plain(
            q[:, :, w:w + 1], pk, pv, tables, pos + w, **kw)
        torch.testing.assert_close(one, lin[:, :, w:w + 1], **TOL)


def test_int8_geometry_checks():
    """int8 pools need int8 payloads, float32 scales of (N, KV, bs) and
    D % 8 == 0 (head_dim 8 is taken); block_size 8 (under the TPU's int8
    sublane rule of 32) is taken."""
    q = torch.zeros(2, 4, 1, 16)
    pool = torch.zeros(5, 2, 8, 16, dtype=torch.int8)
    sc = torch.zeros(5, 2, 8)
    paged_attention.check_kernel_geometry(q, pool, pool, sc, sc)
    p8 = torch.zeros(5, 2, 8, 8, dtype=torch.int8)
    paged_attention.check_kernel_geometry(torch.zeros(2, 4, 1, 8), p8, p8,
                                          sc, sc)
    bad = [
        (q, pool.float(), pool.float(), sc, sc),              # not int8
        (q, pool, pool, sc.double(), sc.double()),            # scale dtype
        (q, pool, pool, sc[:, :, :4], sc[:, :, :4]),          # scale shape
        (q, pool, pool, sc, None),                            # one scale
        (torch.zeros(2, 4, 1, 12), torch.zeros(5, 2, 8, 12, dtype=torch.int8),
         torch.zeros(5, 2, 8, 12, dtype=torch.int8), sc, sc),  # D % 8
    ]
    for args in bad:
        with pytest.raises(paged_attention.MXTPUError):
            paged_attention.check_kernel_geometry(*args)
