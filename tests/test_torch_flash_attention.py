"""The port's flash attention (K3 forward, K4 dq, K5 dk/dv) held against
the JAX reference's Pallas kernels, run in interpret mode on the CPU as
the reference's own tests run them.  The same seeded numpy inputs go
through both; on a CPU tensor each port wrapper runs its kernel's plain
version.

Cases: causal and non-causal at T = 128, 100 and 150 (B = H = 2,
D = 16) with ``q_block=64, kv_block=128`` on the reference side (its
own cases in ``tests/test_flash_attention.py``), and the reference's
dense rule (T < 16 or D % 8 != 0).  Tolerance rtol 1e-4 / atol 1e-5, as
the reference's own tests use: both sides compute in float32 and differ
only in the order of their sums.

K3's, K4's and K5's arithmetic on the card (3xTF32 on the tensor cores)
is emulated here: each operand of every product split into TF32 big and
small parts rounded as ``cvt.rna.tf32.f32`` rounds, the product
small*big + big*small + big*big in float32, over K3's 64-key walk and
over the walks of K4 (16-key tiles) and K5 (16-query tiles), each tile's
product added into the float32 sum as the kernels add it.  K3 stays
within the card's float32 tolerance (2e-5 max abs error,
``chip_smoke.TOL``) of the plain version, and K4's dq and K5's dk and dv
within 2e-5 of their largest element (``chip_smoke.GRAD_TOL``); one TF32
product does not."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ops.pallas.flash_attention import (_flash_bwd, _flash_fwd,
                                              flash_attention as jax_flash)
from mxtpu_torch import base
from mxtpu_torch.base import MXTPUError
from mxtpu_torch.ops import flash_attention as fa

TOL = dict(rtol=1e-4, atol=1e-5)
B, H, D = 2, 2, 16
CASES = [(T, causal) for T in (128, 100, 150) for causal in (True, False)]
IDS = ["T%d-%s" % (T, "causal" if c else "full") for T, c in CASES]


@pytest.fixture(scope="module", autouse=True)
def _settle_torch_transcendentals():
    """Call torch.exp and torch.log once on one element before the tests.

    PyTorch's vectorized exp, log and tanh on the CPU settle their
    implementation at their first call in a process.  When that first
    call is split over several intra-op threads (a tensor of 32768
    elements or more), some threads can compute their chunk with a
    relative error up to 1.5e-4 (seen on an x86 CPU with AVX-512: 11 of
    96 fresh processes for exp, 0 of 96 after one call on one element,
    which runs on the calling thread alone).  This file's first test was
    often the first exp of its test worker, and its (2, 2, 128, 128)
    scores put it 4.8e-5 off the reference in some runs."""
    torch.exp(torch.zeros(1))
    torch.log(torch.ones(1))


def _inputs(T, seed, d=D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, d).astype("float32") for _ in range(4)]


def _blocks(T):
    """The blocks the reference's flash_attention would take for
    q_block=64, kv_block=128 (it clamps both to T)."""
    return min(64, T), min(128, T)


def _ref_fwd(q, k, v, causal):
    T = q.shape[2]
    qb, kb = _blocks(T)
    o, lse = _flash_fwd(jnp.array(q), jnp.array(k), jnp.array(v),
                        1.0 / math.sqrt(D), causal, qb, kb, True)
    return np.asarray(o), np.asarray(lse)[:, :T].reshape(B, H, T)


@pytest.mark.parametrize("T,causal", CASES, ids=IDS)
def test_plain_forward_matches_pallas_forward(T, causal):
    q, k, v, _ = _inputs(T, seed=T)
    o_ref, lse_ref = _ref_fwd(q, k, v, causal)
    o, lse = fa.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)),
                                1.0 / math.sqrt(D), causal)
    np.testing.assert_allclose(o.numpy(), o_ref, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, **TOL)


@pytest.mark.parametrize("T,causal", CASES, ids=IDS)
def test_plain_backward_matches_pallas_backward(T, causal):
    """dq, dk and dv given the same o, lse and dO on both sides."""
    q, k, v, do = _inputs(T, seed=T + 1)
    scale = 1.0 / math.sqrt(D)
    qb, kb = _blocks(T)
    jq, jk, jv = jnp.array(q), jnp.array(k), jnp.array(v)
    o, lse_pad = _flash_fwd(jq, jk, jv, scale, causal, qb, kb, True)
    want = _flash_bwd(jq, jk, jv, o, lse_pad, jnp.array(do), scale, causal,
                      qb, kb, True)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to = torch.from_numpy(np.array(o))
    lse = torch.from_numpy(np.array(lse_pad)[:, :T].reshape(B, H, T))
    delta = (tdo * to).sum(dim=-1)
    dq = fa.flash_dq_plain(tq, tk, tv, tdo, lse, delta, scale, causal)
    dk, dv = fa.flash_dkv_plain(tq, tk, tv, tdo, lse, delta, scale, causal)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("T,causal", CASES, ids=IDS)
def test_autograd_matches_jax_grad(T, causal):
    """The port's differentiable flash_attention (K3, then K4/K5 through
    the autograd Function) against jax.grad of the reference's, on a
    weighted sum of the output; the dense rule does not fire."""
    q, k, v, w = _inputs(T, seed=T + 2)

    def ref_loss(a, b, c):
        out = jax_flash(a, b, c, causal=causal, q_block=64, kv_block=128)
        return jnp.sum(out * jnp.array(w))

    want_o = np.asarray(jax_flash(jnp.array(q), jnp.array(k), jnp.array(v),
                                  causal=causal, q_block=64, kv_block=128))
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.array(q), jnp.array(k), jnp.array(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    base.reset_counts()
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    assert base.counts() == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    np.testing.assert_allclose(out.detach().numpy(), want_o, **TOL)
    for got, ref, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("T,d,causal", [(8, 16, True), (8, 16, False),
                                        (32, 12, True)],
                         ids=["T8-causal", "T8-full", "D12-causal"])
def test_dense_rule_matches_reference_and_skips_the_kernels(T, d, causal):
    """T < 16 or D % 8 != 0: both sides take the dense path; only
    ``flash_attention_dense`` moves."""
    q, k, v, w = _inputs(T, seed=T + d, d=d)

    def ref_loss(a, b, c):
        return jnp.sum(jax_flash(a, b, c, causal=causal) * jnp.array(w))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.array(q), jnp.array(k), jnp.array(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    base.reset_counts()
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    assert base.counts() == {fa.DENSE_NAME: 1}
    want_o = np.asarray(jax_flash(jnp.array(q), jnp.array(k), jnp.array(v),
                                  causal=causal))
    np.testing.assert_allclose(out.detach().numpy(), want_o, **TOL)
    for got, ref, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), **TOL,
                                   err_msg=name)


def test_wrappers_raise_off_the_cpu_and_the_card():
    """No kernel and no plain fallback for another device type."""
    x = torch.empty(1, 1, 32, 16, device="meta")
    lse = torch.empty(1, 1, 32, device="meta")
    base.reset_counts()
    with pytest.raises(MXTPUError, match="no kernel"):
        fa.flash_fwd(x, x, x, 0.25, True)
    with pytest.raises(MXTPUError, match="no kernel"):
        fa.flash_dq(x, x, x, x, lse, lse, 0.25, True)
    with pytest.raises(MXTPUError, match="no kernel"):
        fa.flash_dkv(x, x, x, x, lse, lse, 0.25, True)
    assert base.counts() == {}


# -- K3's 3xTF32 arithmetic, emulated ----------------------------------------

CARD_TOL = 2e-5   # chip_smoke.TOL[float32]: kernel against plain version


def _tf32(x):
    """float32 x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, by integer ops on the float32 bits
    (add half of the 13 dropped bits' unit to the magnitude, then clear
    them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as K3 forms it: a = ab + as, b = bb + bs in TF32, and
    small*big + big*small + big*big with float32 sums."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def _mm_tf32(a, b):
    """a @ b as one TF32 product."""
    return _tf32(a) @ _tf32(b)


def _emulated_fwd(q, k, v, scale, causal, mm, tile=64):
    """K3's walk over 64-key tiles with the online softmax, its two
    products formed by ``mm``."""
    T = q.shape[-2]
    qs = q * scale
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros_like(q)
    rows = torch.arange(T)[:, None]
    for k0 in range(0, T, tile):
        kt, vt = k[..., k0:k0 + tile, :], v[..., k0:k0 + tile, :]
        s = mm(qs, kt.transpose(-1, -2))
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[-2])[None, :]
            s = s.masked_fill(keys > rows, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + mm(p, vt)
        m = m_new
    den = l.clamp_min(1e-30)
    return acc / den, (m + torch.log(den))[..., 0]


def test_tf32_rounding_is_to_nearest_with_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's unit at 1.0
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2),
                      one + ulp / 2 - 2 ** -23, one + 3 * ulp / 2, 1e-40,
                      0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp,
                         1e-40, 0.0], dtype=torch.float32)
    got = _tf32(x)
    assert torch.equal(got[:4], want[:4])
    assert got[5] == 0.0
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # a bfloat16 value is exactly TF32, so its small part is zero
    b = torch.randn(64).bfloat16().float()
    assert torch.equal(_tf32(b), b)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_3xtf32_forward_holds_the_card_tolerance(causal):
    """K3's 3xTF32 arithmetic within 2e-5 of the plain version on o and
    lse at (1, 2, 256, 128), where one TF32 product misses it."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 256, 128).astype("float32"))
               for _ in range(3))
    scale = 1.0 / math.sqrt(128)
    want_o, want_lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    o, lse = _emulated_fwd(q, k, v, scale, causal, _mm_3xtf32)
    assert float((o - want_o).abs().max()) <= CARD_TOL
    assert float((lse - want_lse).abs().max()) <= CARD_TOL
    o1, _ = _emulated_fwd(q, k, v, scale, causal, _mm_tf32)
    assert float((o1 - want_o).abs().max()) > 10 * CARD_TOL


def _walk_tile(D):
    """Rows of the tile K4 (keys) and K5 (queries) walk at head_dim D:
    16 above 64, 32 up to it (``walk_rows`` in flash_attention.cu)."""
    return 16 if D > 64 else 32


def _emulated_dq(q, k, v, do, lse, delta, scale, causal, mm):
    """K4's walk over key tiles: s = q.k^T and dp = dO.v^T of the tile,
    p = exp(scale*s - lse) (masked keys exactly 0), ds = p*(dp - delta),
    and the tile's ds.k added into dq in float32; dq scaled once at the
    end.  Each product formed by ``mm``."""
    T, tile = q.shape[-2], _walk_tile(q.shape[-1])
    rows = torch.arange(T)[:, None]
    dq = torch.zeros_like(q)
    for k0 in range(0, T, tile):
        kt, vt = k[..., k0:k0 + tile, :], v[..., k0:k0 + tile, :]
        p = torch.exp(scale * mm(q, kt.transpose(-1, -2)) - lse[..., None])
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[-2])[None, :]
            p = p.masked_fill(keys > rows, 0.0)
        ds = p * (mm(do, vt.transpose(-1, -2)) - delta[..., None])
        dq = dq + mm(ds, kt)
    return scale * dq


def _emulated_dkv(q, k, v, do, lse, delta, scale, causal, mm):
    """K5's walk over query tiles with keys as rows: s^T = k.q^T and
    dp^T = v.dO^T of the tile, p^T = exp(scale*s^T - lse) (masked
    entries exactly 0), ds^T = p^T*(dp^T - delta), and the tile's
    p^T.dO and ds^T.q added into dv and dk in float32; dk scaled once at
    the end."""
    T, tile = q.shape[-2], _walk_tile(q.shape[-1])
    keys = torch.arange(T)[:, None]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, T, tile):
        qt, dot = q[..., q0:q0 + tile, :], do[..., q0:q0 + tile, :]
        pt = torch.exp(scale * mm(k, qt.transpose(-1, -2))
                       - lse[..., None, q0:q0 + tile])
        if causal:
            queries = torch.arange(q0, q0 + qt.shape[-2])[None, :]
            pt = pt.masked_fill(keys > queries, 0.0)
        dst = pt * (mm(v, dot.transpose(-1, -2))
                    - delta[..., None, q0:q0 + tile])
        dv = dv + mm(pt, dot)
        dk = dk + mm(dst, qt)
    return scale * dk, dv


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("one_signed", [False, True], ids=["randn", "abs"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_3xtf32_backward_holds_the_card_tolerance(kernel, one_signed,
                                                  causal):
    """K4's and K5's 3xTF32 arithmetic within 2e-5 of max |plain| at
    (1, 2, 256, 128), with dO = randn and one-signed dO = |randn| (p >= 0
    then makes every term of dv one sign); one TF32 product misses it by
    more than 10x."""
    rng = np.random.RandomState(12)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 256, 128)
                                    .astype("float32")) for _ in range(4))
    if one_signed:
        do = do.abs()
    scale = 1.0 / math.sqrt(128)
    o, lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    delta = (do * o).sum(dim=-1)
    args = (q, k, v, do, lse, delta, scale, causal)
    if kernel == "dq":
        want = (fa.flash_dq_plain(*args),)
        got = (_emulated_dq(*args, _mm_3xtf32),)
        one = (_emulated_dq(*args, _mm_tf32),)
    else:
        want = fa.flash_dkv_plain(*args)
        got = _emulated_dkv(*args, _mm_3xtf32)
        one = _emulated_dkv(*args, _mm_tf32)
    for g, o1, w in zip(got, one, want):
        bound = CARD_TOL * float(w.abs().max())
        assert float((g - w).abs().max()) <= bound
        assert float((o1 - w).abs().max()) > 10 * bound


def test_backward_route_follows_head_dim():
    """K4 and K5 leave the tensor cores only above head_dim 128; K3
    never does."""
    assert fa.route("fwd", 256) == fa.TENSOR_CORES
    for kind in ("dq", "dkv"):
        assert fa.route(kind, 8) == fa.route(kind, 128) == fa.TENSOR_CORES
        assert fa.route(kind, 136) == fa.route(kind, 256) == fa.CUDA_CORES
