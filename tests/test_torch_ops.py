"""The port's RMSNorm, rotary embedding and paged KV-cache ops, held
against the JAX reference on the same numpy inputs (made from a seed).

Tolerances: rms_norm and rope compute in float32 in both frameworks, but
``pow``, ``sin`` and ``cos`` may differ by an ulp between XLA and
PyTorch, so they are compared at 1e-6 absolute on O(1) values.  The
cache ops move data without arithmetic and must match exactly.  The
reference's cache ops return a new pool; the port's write in place, so
the port's pool after the call is compared with the reference's
result."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxtpu.ops import contrib as jcontrib
from mxtpu.ops import tensor as jtensor
from mxtpu_torch.ops import contrib, tensor


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    want = np.asarray(jcontrib.rms_norm(jnp.asarray(x), jnp.asarray(g)))
    got = contrib.rms_norm(_t(x), _t(g)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_rms_norm_casts_back_to_input_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    out = contrib.rms_norm(x, torch.ones(8, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("offset", [0, 5, 37])
def test_rope_scalar_offset_matches_reference(offset):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 6, 16).astype(np.float32)
    want = np.asarray(jcontrib.rope(jnp.asarray(x), offset=offset))
    got = contrib.rope(_t(x), offset=offset).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_rope_per_row_offset_matches_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, 1, 16).astype(np.float32)
    pos = np.array([0, 9, 130], np.int32)
    want = np.asarray(jcontrib.rope(jnp.asarray(x), offset=jnp.asarray(pos)))
    got = contrib.rope(_t(x), offset=_t(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _pool(rng, N=6, KV=2, bs=4, D=8):
    return rng.randn(N, KV, bs, D).astype(np.float32)


def test_paged_cache_gather_matches_reference():
    rng = np.random.RandomState(3)
    pool = _pool(rng)
    tables = np.array([[3, 1, 0], [5, 2, 4]], np.int32)
    want = np.asarray(jtensor._paged_cache_gather(jnp.asarray(pool),
                                                  jnp.asarray(tables)))
    got = tensor.paged_cache_gather(_t(pool), _t(tables)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start", [0, 3, 6])
def test_paged_cache_write_matches_reference(start):
    """A chunk written from a mid-page start, across a page boundary,
    through an out-of-order table."""
    rng = np.random.RandomState(4)
    pool = _pool(rng)
    new = rng.randn(1, 2, 5, 8).astype(np.float32)
    table = np.array([4, 2, 5, 0], np.int32)
    want = np.asarray(jtensor._paged_cache_write(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(table),
        start_pos=start))
    got = _t(pool)
    out = tensor.paged_cache_write(got, _t(new), _t(table), start)
    assert out is got                         # in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_cache_write_rows_matches_reference():
    """Live rows land through their own tables; the dead lane (all-null
    table, position 0) writes only the null page 0."""
    rng = np.random.RandomState(5)
    pool = _pool(rng)
    new = rng.randn(3, 2, 1, 8).astype(np.float32)
    tables = np.array([[2, 3, 0], [0, 0, 0], [5, 1, 4]], np.int32)
    pos = np.array([5, 0, 10], np.int32)
    want = np.asarray(jtensor._paged_cache_write_rows(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(pos)))
    got = _t(pool)
    tensor.paged_cache_write_rows(got, _t(new), _t(tables), _t(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    untouched = [1, 2, 5]                     # no row writes there
    np.testing.assert_array_equal(got.numpy()[untouched], pool[untouched])


@pytest.mark.parametrize("src,dst", [(3, 1), (2, 2)])
def test_paged_block_copy_matches_reference(src, dst):
    rng = np.random.RandomState(6)
    pool = _pool(rng)
    want = np.asarray(jtensor._paged_block_copy(jnp.asarray(pool),
                                                src=src, dst=dst))
    got = _t(pool)
    tensor.paged_block_copy(got, src, dst)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rope_absolute_offsets_match_reference():
    """(B, T) offsets: element (b, t) rotated at offset[b, t] (a tree
    window's lanes sit at their depths)."""
    rng = np.random.RandomState(7)
    x = rng.randn(3, 4, 5, 16).astype(np.float32)
    off = rng.randint(0, 200, (3, 5)).astype(np.int32)
    want = np.asarray(jcontrib.rope(jnp.asarray(x), offset=jnp.asarray(off)))
    got = contrib.rope(_t(x), offset=_t(off)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(3, 4, 6, 16), (3, 6, 16)])
def test_rope_absolute_offsets_are_the_per_row_form_on_consecutive_lanes(
        shape):
    """Where offset[b, t] == offset[b] + t the (B, T) form gives the (B,)
    form's bits (a linear window's rotation equals the tree path's)."""
    rng = np.random.RandomState(8)
    x = _t(rng.randn(*shape).astype(np.float32))
    pos = torch.tensor([0, 17, 1000], dtype=torch.int32)
    off = pos[:, None] + torch.arange(6, dtype=torch.int32)[None, :]
    assert torch.equal(contrib.rope(x, offset=off),
                       contrib.rope(x, offset=pos))


def _span_case(seed, W=5):
    """Two live rows, the second's window crossing from its last page
    onto the table's null padding, and a dead row."""
    rng = np.random.RandomState(seed)
    pool = _pool(rng, N=8)
    tables = np.array([[2, 6, 3], [5, 1, 0], [0, 0, 0]], np.int32)
    pos = np.array([2, 5, 0], np.int32)
    return rng, pool, tables, pos


def test_paged_cache_write_span_matches_reference():
    rng, pool, tables, pos = _span_case(9)
    new = rng.randn(3, 2, 5, 8).astype(np.float32)
    valid_len = np.array([4, 5, 0], np.int32)
    want = np.asarray(jtensor._paged_cache_write_span(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(pos), jnp.asarray(valid_len)))
    got = _t(pool)
    out = tensor.paged_cache_write_span(got, _t(new), _t(tables), _t(pos),
                                        _t(valid_len))
    assert out is got                         # in place
    # page 0 absorbs the invalid lanes: which of them lands is unspecified
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    untouched = [4, 7]
    np.testing.assert_array_equal(got.numpy()[untouched], pool[untouched])


@pytest.mark.parametrize("src_lane", [
    [[0, 3, 4, -1, -1], [0, 1, 2, 3, 4], [-1] * 5],   # a side branch
    [[2, 0, 1, 4, 3], [4, 3, 2, 1, 0], [0] * 5],       # overlapping moves
])
def test_paged_cache_permute_span_matches_reference(src_lane):
    """Sources are read before any destination is written, so moves
    whose sources and destinations overlap in one slot land as the
    reference's functional gather-then-scatter does."""
    _, pool, tables, pos = _span_case(10)
    sl = np.array(src_lane, np.int32)
    want = np.asarray(jtensor._paged_cache_permute_span(
        jnp.asarray(pool), jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(sl)))
    got = _t(pool)
    out = tensor.paged_cache_permute_span(got, _t(tables), _t(pos), _t(sl))
    assert out is got
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
