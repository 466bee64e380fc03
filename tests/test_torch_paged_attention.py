"""The plain versions of the port's two paged-attention kernels, held
against the JAX reference's Pallas kernels (run in interpret mode on the
CPU, as the reference's own tests run them) and against the reference's
``xla_reference``, on the same seeded numpy inputs: ragged block tables
padded with the null page, pages out of order, GQA rep 2, a dead pool
lane, a chunk starting mid-page and a padded chunk; and K1's speculative
verify window (W = 2, 4, 8) and tree ancestor mask (branchy trees and the
degenerate chain).  The int8 forms of both are held in
tests/test_torch_q8.py.

Tolerance 1e-5 absolute and relative: all four compute in float32 and
differ only in the order of their sums.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds them against these plain versions there); here the wrappers are
checked for what they do on a CPU tensor."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxtpu.ops.pallas import paged_attention as jpa
from mxtpu.ops.pallas import prefill_attention as jpf
from chip_smoke import tree_anc
from mxtpu_torch import base
from mxtpu_torch.ops import paged_attention, prefill_attention

TOL = dict(atol=1e-5, rtol=1e-5)
KV, REP, D, BS, N = 2, 2, 16, 8, 12


def _pools(rng):
    shape = (N, KV, BS, D)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _decode_case(seed):
    """Three live slots at ragged depths through out-of-order pages,
    and one dead lane (all-null table, position 0)."""
    rng = np.random.RandomState(seed)
    pk, pv = _pools(rng)
    q = rng.randn(4, KV * REP, 1, D).astype(np.float32)
    tables = np.array([[7, 2, 0, 0, 0],
                       [0, 0, 0, 0, 0],
                       [3, 11, 5, 9, 0],
                       [10, 0, 0, 0, 0]], np.int32)
    pos = np.array([12, 0, 29, 3], np.int32)
    return q, pk, pv, tables, pos


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_decode_matches_reference_kernel_and_xla(seed):
    q, pk, pv, tables, pos = _decode_case(seed)
    args = [jnp.asarray(a) for a in (q, pk, pv, tables, pos)]
    want_kernel = np.asarray(jpa.paged_decode_attention(*args))
    want_xla = np.asarray(jpa.xla_reference(*args))
    got = paged_attention.paged_decode_attention_plain(
        *[torch.from_numpy(a) for a in (q, pk, pv, tables, pos)]).numpy()
    live = [0, 2, 3]                   # the dead lane's output is garbage
    np.testing.assert_allclose(got[live], want_kernel[live], **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)


@pytest.mark.parametrize("start,T", [(0, 16), (5, 8), (13, 8), (21, 16)])
def test_plain_prefill_matches_reference_kernel_and_xla(start, T):
    """Chunks from position 0, from mid-page starts, and padded past the
    last written position (a chunk of T lanes whose tail is padding)."""
    rng = np.random.RandomState(start + T)
    pk, pv = _pools(rng)
    q = rng.randn(1, KV * REP, T, D).astype(np.float32)
    table = np.array([4, 9, 1, 6, 0, 0], np.int32)
    args = [jnp.asarray(a) for a in (q, pk, pv, table)]
    want_kernel = np.asarray(jpf.paged_prefill_attention(*args, start))
    want_xla = np.asarray(jpf.xla_reference(*args, start))
    got = prefill_attention.paged_prefill_attention_plain(
        *[torch.from_numpy(a) for a in (q, pk, pv, table)], start).numpy()
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)


def test_plain_prefill_takes_a_tensor_start():
    rng = np.random.RandomState(3)
    pk, pv = _pools(rng)
    q = rng.randn(1, KV * REP, 8, D).astype(np.float32)
    table = np.array([4, 9, 1, 6, 0, 0], np.int32)
    t = [torch.from_numpy(a) for a in (q, pk, pv, table)]
    a = prefill_attention.paged_prefill_attention_plain(*t, 5)
    b = prefill_attention.paged_prefill_attention_plain(
        *t, torch.tensor(5, dtype=torch.int32))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decode_wrapper_on_cpu_counts_and_runs_the_plain_version():
    q, pk, pv, tables, pos = [torch.from_numpy(a) for a in _decode_case(0)]
    base.reset_counts()
    out = paged_attention.paged_decode_attention(q, pk, pv, tables, pos)
    assert base.count(paged_attention.KERNEL_NAME) == 1
    plain = paged_attention.paged_decode_attention_plain(q, pk, pv, tables,
                                                         pos)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_prefill_wrapper_on_cpu_counts_and_runs_the_plain_version():
    rng = np.random.RandomState(4)
    pk, pv = _pools(rng)
    q = rng.randn(1, KV * REP, 8, D).astype(np.float32)
    table = np.array([4, 9, 1, 6, 0, 0], np.int32)
    t = [torch.from_numpy(a) for a in (q, pk, pv, table)]
    base.reset_counts()
    out = prefill_attention.paged_prefill_attention(*t, 13)
    assert base.count(prefill_attention.KERNEL_NAME) == 1
    torch.testing.assert_close(
        out, prefill_attention.paged_prefill_attention_plain(*t, 13),
        rtol=0, atol=0)


def _window_case(seed, W):
    """The decode case with a W-lane query window per slot; slot 3's
    window crosses from its last page onto null-padded table entries."""
    q, pk, pv, tables, pos = _decode_case(seed)
    rng = np.random.RandomState(seed + 100)
    q = rng.randn(4, KV * REP, W, D).astype(np.float32)
    pos = np.array([12 - W // 2, 0, 29 - W, 3], np.int32)
    return q, pk, pv, tables, pos


@pytest.mark.parametrize("W", [2, 4, 8])
@pytest.mark.parametrize("tree", [None, "branchy", "chain"])
def test_plain_verify_window_matches_reference_kernel_and_xla(W, tree):
    """Lane w of a linear window attends positions <= pos + w; a tree
    lane attends the history, itself and its ancestors."""
    q, pk, pv, tables, pos = _window_case(W, W)
    anc = None if tree is None else tree_anc(np.random.RandomState(W), 4,
                                              W, chain=tree == "chain")
    args = [jnp.asarray(a) for a in (q, pk, pv, tables, pos)]
    janc = None if anc is None else jnp.asarray(anc)
    want_kernel = np.asarray(jpa.paged_decode_attention(*args, anc=janc))
    want_xla = np.asarray(jpa.xla_reference(*args, anc=janc))
    got = paged_attention.paged_decode_attention_plain(
        *[torch.from_numpy(a) for a in (q, pk, pv, tables, pos)],
        anc=None if anc is None else torch.from_numpy(anc)).numpy()
    live = [0, 2, 3]
    np.testing.assert_allclose(got[live], want_kernel[live], **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)


def test_plain_chain_tree_equals_linear_window():
    """A degenerate chain's ancestor mask is the linear window's
    triangle: the plain version gives the same bits."""
    q, pk, pv, tables, pos = [torch.from_numpy(a)
                              for a in _window_case(0, 8)]
    anc = torch.from_numpy(tree_anc(None, 4, 8, chain=True))
    lin = paged_attention.paged_decode_attention_plain(q, pk, pv, tables, pos)
    chain = paged_attention.paged_decode_attention_plain(q, pk, pv, tables,
                                                         pos, anc=anc)
    assert torch.equal(lin, chain)


@pytest.mark.parametrize("variant", ["window", "tree", "int8"])
def test_decode_wrapper_rejects_variants_not_ported(variant):
    """Every variant is ported now: the verify window, the tree mask and
    the int8 pools run the plain version on a CPU tensor, counted once
    (int8 pools under their own counter)."""
    q, pk, pv, tables, pos = [torch.from_numpy(a) for a in _decode_case(0)]
    kw = {}
    name = paged_attention.KERNEL_NAME
    if variant == "window":
        q = q.expand(-1, -1, 2, -1).contiguous()
    elif variant == "tree":
        q = q.expand(-1, -1, 4, -1).contiguous()
        kw["anc"] = torch.from_numpy(
            tree_anc(np.random.RandomState(0), 4, 4))
    else:
        pk, pv = pk.mul(40).to(torch.int8), pv.mul(40).to(torch.int8)
        kw["k_scales"] = torch.full((N, KV, BS), 0.025)
        kw["v_scales"] = torch.full((N, KV, BS), 0.02)
        name = paged_attention.KERNEL_NAME_Q8
    base.reset_counts()
    out = paged_attention.paged_decode_attention(q, pk, pv, tables, pos, **kw)
    assert base.counts() == {name: 1}
    torch.testing.assert_close(
        out, paged_attention.paged_decode_attention_plain(
            q, pk, pv, tables, pos, **kw), rtol=0, atol=0)


def test_decode_wrapper_rejects_a_tree_wider_than_the_bitmask():
    """K004: a tree window past 32 lanes does not fit the int32 ancestor
    bitmask (the reference raises the same ValueError)."""
    q, pk, pv, tables, pos = [torch.from_numpy(a) for a in _decode_case(0)]
    q = q.expand(-1, -1, 33, -1).contiguous()
    with pytest.raises(ValueError, match="K004"):
        paged_attention.paged_decode_attention(
            q, pk, pv, tables, pos, anc=torch.zeros(4, 33, dtype=torch.int32))


def test_prefill_wrapper_on_cpu_runs_int8_pools_through_the_plain_version():
    """Int8 pools and their scales on a CPU tensor: the wrapper runs the
    plain version, counted under ``paged_prefill[int8]``."""
    rng = np.random.RandomState(5)
    pk, pv = _pools(rng)
    q = torch.randn(1, KV * REP, 8, D)
    args = (q, torch.from_numpy(pk).mul(40).to(torch.int8),
            torch.from_numpy(pv).mul(40).to(torch.int8),
            torch.tensor([4, 9, 1, 6, 0, 0], dtype=torch.int32), 5)
    kw = dict(k_scales=torch.full((N, KV, BS), 0.025),
              v_scales=torch.full((N, KV, BS), 0.02))
    base.reset_counts()
    out = prefill_attention.paged_prefill_attention(*args, **kw)
    assert base.counts() == {prefill_attention.KERNEL_NAME_Q8: 1}
    torch.testing.assert_close(
        out, prefill_attention.paged_prefill_attention_plain(*args, **kw),
        rtol=0, atol=0)


def test_kernel_geometry_check_rejects_what_the_kernels_do_not_take():
    """The checks the wrappers run before a launch on the card."""
    q = torch.zeros(2, 4, 1, 16)
    pool = torch.zeros(5, 2, 8, 16)
    paged_attention.check_kernel_geometry(q, pool, pool)   # accepted
    bad = [
        (q.double(), pool.double(), pool.double()),          # dtype
        (q, pool.bfloat16(), pool),                          # mixed dtype
        (torch.zeros(2, 4, 1, 12), torch.zeros(5, 2, 8, 12),
         torch.zeros(5, 2, 8, 12)),                          # D % 8
        (torch.zeros(2, 4, 1, 264), torch.zeros(5, 2, 8, 264),
         torch.zeros(5, 2, 8, 264)),                         # D > 256
        (q, torch.zeros(5, 2, 128, 16), torch.zeros(5, 2, 128, 16)),  # bs
        (torch.zeros(2, 3, 1, 16), pool, pool),              # H % KV
        (q, pool.transpose(2, 3).contiguous().transpose(2, 3), pool),
    ]
    for args in bad:
        with pytest.raises(base.MXTPUError):
            paged_attention.check_kernel_geometry(*args)
    with pytest.raises(base.MXTPUError):
        paged_attention.check_index("pos", torch.zeros(2, dtype=torch.int64),
                                    (2,), torch.device("cpu"))
