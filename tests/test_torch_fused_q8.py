"""The fused int8 V epilogue of the port (G3's q8 epilogue, ``ops/linear.py:
wq_matmul_q8``, and its model route), held against the JAX reference on
the same seeded numpy inputs and inside the port against the
quantize-on-write arm.

- The pre-quantized paged writes equal the reference's
  ``_paged_cache_write_rows_pre_q8`` / ``_paged_cache_write_span_pre_q8``
  bit for bit (exact: they move the same bits).
- ``_fused_q8_epilogue_on`` decides as the reference does with its
  paged kernels on (the port's always are): int8 weights over int8
  pools only.
- The kernel's epilogue arithmetic, emulated (amax; each division as
  ``q8_div`` computes it, in double with an exactly emulated FMA: a
  reciprocal refined by three Newton steps from a 12- or 24-bit
  estimate, the product, its exact residual, one correction, then
  rounded to float; round half to even; the clamp), equals IEEE float32
  division on random and extreme pairs, and ``_q8_quantize`` and the
  reference's quantizer bit for bit on bf16-rounded rows with every
  corner of the quantizer; and its arrival count (each block that
  stored a column of a head arrives once; the count the last one waits
  for) holds for every row class of the 8B's qkv plan and for V
  columns that start mid-tile.
- The model's fused arm equals the quantize-on-write arm ``torch.equal``
  (pools and logits) for ``step_pages`` and ``verify_pages``, linear and
  tree, and its logits stay within 1e-4 of the reference's fused arm
  (interpret-mode Pallas read), the tolerance of
  tests/test_torch_transformer.py.
"""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.contrib import quantization as jq
from mxtpu.models.transformer import llama_tiny as jax_llama_tiny
from mxtpu.ops import tensor as jtensor
from mxtpu_torch import base
from mxtpu_torch.contrib import quantization as q
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import llama_tiny
from mxtpu_torch.ops import linear, tensor
from mxtpu_torch.parallel.serving import _tree_paths

TOL = dict(atol=1e-4, rtol=1e-4)
KV, D, BS, N = 2, 16, 8, 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _pre_q8(rng, B, W):
    x = rng.randn(B, KV, W, D).astype(np.float32) * 2
    vq, vs = tensor._q8_quantize(_t(x))
    return vq.numpy(), vs.numpy()


def _pool(rng):
    vq, vs = tensor._q8_quantize(_t(rng.randn(N, KV, BS, D).astype(
        np.float32)))
    return vq.numpy(), vs.numpy()


def test_pre_q8_row_write_is_the_reference_bit_for_bit():
    rng = np.random.RandomState(0)
    pool, scales = _pool(rng)
    new_q, new_s = _pre_q8(rng, 3, 1)
    tables = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    pos = np.array([5, 17, 0], np.int32)
    jp, js = jtensor._paged_cache_write_rows_pre_q8(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(new_q),
        jnp.asarray(new_s), jnp.asarray(tables), jnp.asarray(pos))
    p, s = _t(pool), _t(scales)
    tensor.paged_cache_write_rows_pre_q8(p, s, _t(new_q), _t(new_s),
                                         _t(tables), _t(pos))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_pre_q8_span_write_is_the_reference_bit_for_bit():
    """Invalid lanes (past valid_len, and a dead row) and a position off
    the table go to the null page on the payload and on the scales."""
    rng = np.random.RandomState(1)
    pool, scales = _pool(rng)
    W = 4
    new_q, new_s = _pre_q8(rng, 3, W)
    tables = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
    pos = np.array([6, 21, 0], np.int32)
    vl = np.array([3, 4, 0], np.int32)
    jp, js = jtensor._paged_cache_write_span_pre_q8(
        jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(new_q),
        jnp.asarray(new_s), jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(vl))
    p, s = _t(pool), _t(scales)
    tensor.paged_cache_write_span_pre_q8(p, s, _t(new_q), _t(new_s),
                                         _t(tables), _t(pos), _t(vl))
    # the null page absorbs the dropped lanes in any order: compare the
    # live pages
    np.testing.assert_array_equal(p.numpy()[1:], np.asarray(jp)[1:])
    np.testing.assert_array_equal(s.numpy()[1:], np.asarray(js)[1:])


def _ref_tiny(seed=3, vocab=50, bits=None, gs=64):
    mx.random.seed(seed)
    ref = jax_llama_tiny(vocab_size=vocab)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))
    if bits:
        jq.quantize_weights(ref, bits=bits, group_size=gs)
    return ref


def _bridge(ref, bits=None, gs=64, vocab=50):
    port = llama_tiny(vocab_size=vocab, device="cpu")
    if bits:
        q.quantize_weights(port, bits=bits, group_size=gs)
    return load_mxtpu_params(port, {k: v.data().asnumpy() for k, v in
                                    ref.collect_params().items()})


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["float", "int8",
                                                     "int4"])
@pytest.mark.parametrize("pool_dtype", ["float32", "int8"])
def test_epilogue_eligibility_is_the_references(monkeypatch, bits,
                                                pool_dtype):
    """With the reference's paged read on, both decide alike: only an
    int8 qkv over int8 pools fuses (int4 keeps quantize-on-write)."""
    monkeypatch.setenv("MXTPU_PALLAS_PAGED_ATTN", "1")
    ref = _ref_tiny(bits=bits)
    port = _bridge(ref, bits=bits)
    jpool = ref.layers[0].attn.init_block_pool(4, BS, pool_dtype)
    ppool = port.layers[0].attn.init_block_pool(4, BS, pool_dtype)
    want = bool(ref.layers[0].attn._fused_q8_epilogue_on(jpool[1]))
    assert port.layers[0].attn._fused_q8_epilogue_on(ppool[1]) == want
    assert want == (bits == 8 and pool_dtype == "int8")


def _corner_rows(rng, rows, hd):
    """bf16-rounded rows with the quantizer's corners: random, zero, .5
    ties at s = 1, a lone maximum, a row under the scale floor."""
    x = rng.randn(rows, hd).astype(np.float32) * 3
    x[0] = 0.0
    x[1] = np.linspace(-127, 127, hd)
    x[1, :4] = [0.5, -0.5, 2.5, -126.5]
    x[2, 3] = 1e4
    x[3] = 1e-10
    return torch.from_numpy(x).bfloat16().float().numpy()


def _fma(a, b, c):
    """a * b + c rounded once to double (exact rational arithmetic)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _rcp(y, bits):
    """csrc/rows_linear.cu's q8_rcp: an estimate of 1 / y good to
    ``bits`` bits (the hardware's approximation), then three Newton
    steps."""
    m, e = math.frexp(1.0 / y)
    r = math.ldexp(math.floor(m * 2 ** bits) / 2 ** bits, e)
    for _ in range(3):
        r = _fma(r, _fma(-y, r, 1.0), r)
    return r


def _div(x, y, ry):
    """csrc/rows_linear.cu's q8_div: x / y from the reciprocal ry, in
    double, rounded to float32."""
    q = x * ry
    return np.float32(_fma(_fma(-q, y, x), ry, q))


def _emulated_epilogue(v, bits=24):
    """The epilogue of csrc/rows_linear.cu (q8_epilogue): one head's row
    at a time, amax in any order, s = max(amax, 1e-8) / 127 and q =
    rint(v / s) by ``_div``, clamped."""
    v = v.astype(np.float32)
    qv = np.zeros(v.shape, np.int8)
    sv = np.zeros(v.shape[:-1], np.float32)
    for r in range(v.shape[0]):
        a = float(np.maximum(np.abs(v[r]).max(), np.float32(1e-8)))
        s = _div(a, 127.0, 1.0 / 127.0)
        rs = _rcp(float(s), bits)
        qv[r] = [np.clip(np.rint(_div(float(x), float(s), rs)), -127, 127)
                 for x in v[r]]
        sv[r] = s
    return qv, sv


@pytest.mark.parametrize("bits", [12, 24])
def test_emulated_division_is_ieee_float32_division(bits):
    """q8_div's arithmetic against numpy's IEEE float32 division: random
    pairs over many binades, quotients near +-127 and near .5 (where
    rint meets a rounding boundary), denormal and extreme numerators,
    and the scale's own division by 127."""
    rng = np.random.RandomState(bits)
    y = np.float32(10.0) ** rng.uniform(-10, 3, 600).astype(np.float32)
    x = (rng.randn(600) * 100).astype(np.float32) * y
    x[:50] = (np.float32(127) + rng.randn(50).astype(np.float32) * 1e-4) * y[:50]
    x[50:100] = (np.round(rng.randn(50) * 50) + np.float32(0.5)).astype(
        np.float32) * y[50:100]
    x[100:110] = np.float32(1e-40)          # denormal numerators
    x[110:120] = -np.float32(3e38) * np.minimum(y[110:120], 1)
    for xi, yi in zip(x, y):
        want = np.float32(xi) / np.float32(yi)
        got = _div(float(xi), float(yi), _rcp(float(yi), bits))
        assert got.view(np.int32) == want.view(np.int32), (xi, yi)
    for a in np.concatenate([np.abs(x[120:220]), [np.float32(1e-8)]]):
        want = np.float32(a) / np.float32(127.0)
        got = _div(float(a), 127.0, 1.0 / 127.0)
        assert got.view(np.int32) == want.view(np.int32), a


@pytest.mark.parametrize("hd", [16, 40, 128])
def test_emulated_epilogue_is_the_cache_quantizer_bit_for_bit(hd):
    v = _corner_rows(np.random.RandomState(hd), 24, hd)
    eq, es = _emulated_epilogue(v)
    pq, ps = tensor._q8_quantize(torch.from_numpy(v))
    jqv, jqs = jtensor._q8_quantize(jnp.asarray(v))
    np.testing.assert_array_equal(eq, pq.numpy())
    np.testing.assert_array_equal(es.view(np.int32),
                                  ps.numpy().view(np.int32))
    np.testing.assert_array_equal(eq, np.asarray(jqv))
    np.testing.assert_array_equal(es.view(np.int32),
                                  np.asarray(jqs).view(np.int32))


def _arrivals(M, N, K, hd, nv, norm):
    """The kernel's arrivals, walked block by block on the plan: {(row
    chunk, head): (blocks that arrive, the count they wait for)}."""
    p = linear.plan(M, N, K, norm, "int8")
    bn, S = p["bn"], p["splits"]
    P = (2 if S == 1 else 4) if norm else S
    blocks = -(-(-(-N // bn) * S) // P) * P        # padded to clusters
    vbeg, heads = N - nv, nv // hd
    seen = {}
    for z in range(p["chunks"]):
        for b in range(blocks):
            n0 = b // S * bn
            lo, hi = max(n0, vbeg), min(n0 + min(bn, N - n0), N)
            h = (lo - vbeg) // hd
            while lo < hi and h < heads and vbeg + h * hd < hi:
                c0 = vbeg + h * hd
                want = ((c0 + hd - 1) // bn - c0 // bn + 1) * S
                got, w = seen.get((z, h), (0, want))
                assert w == want
                seen[(z, h)] = (got + 1, want)
                h += 1
    return seen, p


@pytest.mark.parametrize("N,K,hd,nv", [(6144, 4096, 128, 1024),
                                       (1000, 256, 40, 200),
                                       (1008, 528, 72, 216),
                                       (512, 256, 128, 512)])
@pytest.mark.parametrize("norm", [False, True], ids=["plain", "norm"])
def test_every_head_is_finished_once_at_every_row_class(N, K, hd, nv, norm):
    """At each row class (M = 1 to 200), every (row chunk, head) gets as
    many arrivals as its last block waits for, so exactly one block
    quantizes it; the 8B's V heads cross tiles in the 128- and
    192-column classes."""
    for M in (1, 8, 33, 64, 128, 200):
        seen, p = _arrivals(M, N, K, hd, nv, norm)
        assert len(seen) == p["chunks"] * (nv // hd), M
        for key, (got, want) in seen.items():
            assert got == want, (M, key, p)


def _models(bits=8):
    ref = _ref_tiny(bits=bits)
    return ref, _bridge(ref, bits=bits)


@pytest.fixture(scope="module")
def int8_models():
    return _models()


def _unfused(model):
    """Route the model's step and window through quantize-on-write."""
    for layer in model.layers:
        layer.attn._fused_q8_epilogue_on = lambda pool_v: False


def _fused(model):
    for layer in model.layers:
        layer.attn.__dict__.pop("_fused_q8_epilogue_on", None)


def _decode_inputs(rng, vocab=50, W=3):
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    pos = np.array([9, 4, 0], np.int32)
    prompt = rng.randint(0, vocab, (1, 12))
    win = rng.randint(0, vocab, (3, W))
    vl = np.array([W, 2, 0], np.int32)
    return tables, pos, prompt, win, vl


def _run_arm(port, fused, inputs, tree):
    tables, pos, prompt, win, vl = inputs
    (_fused if fused else _unfused)(port)
    try:
        pools = port.init_block_pool(10, BS, "int8")
        for row, n in ((0, 10), (1, 5)):
            port.prefill_pages(torch.from_numpy(prompt[:, :n]), pools,
                               torch.from_numpy(tables[row]))
        base.reset_counts()
        step = port.step_pages(torch.from_numpy(win[:, :1]), pools,
                               _t(tables), _t(pos))
        tr = None
        if tree:
            parent = np.array([[0, 0, 0], [0, 0, 1], [0, 0, 1]])
            depth, anc, _ = _tree_paths(parent)
            tr = (_t(depth), _t(anc))
        window = port.verify_pages(torch.from_numpy(win), pools, _t(tables),
                                   _t(pos + 1), _t(vl), tree=tr)
        counts = base.counts()
    finally:
        _fused(port)
    return step, window, pools, counts


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_fused_arm_equals_quantize_on_write(int8_models, tree):
    """One G3 launch with the epilogue a layer and call (counted), the
    pools and the logits ``torch.equal`` to the unfused arm's."""
    port = int8_models[1]
    inputs = _decode_inputs(np.random.RandomState(5))
    fs, fw, fp, fc = _run_arm(port, True, inputs, tree)
    us, uw, up, uc = _run_arm(port, False, inputs, tree)
    assert torch.equal(fs, us) and torch.equal(fw, uw)
    for fl, ul in zip(fp, up):
        for fleaf, uleaf in zip(fl, ul):
            for a, b in zip(fleaf, uleaf):
                assert torch.equal(a[1:], b[1:])     # live pages
    L = len(port.layers)
    assert fc[linear.Q8_KERNEL_NAME] == fc[linear.NORM_Q8_KERNEL_NAME] \
        == 2 * L
    assert linear.Q8_KERNEL_NAME not in uc
    assert fc[linear.I8_KERNEL_NAME] == uc[linear.I8_KERNEL_NAME]


def test_fused_step_matches_the_reference_fused_step(int8_models,
                                                     monkeypatch):
    """The port's fused step_pages and verify_pages against the
    reference's fused arm (its Pallas read forced on, interpret mode) on
    the same pools and inputs, within 1e-4."""
    monkeypatch.setenv("MXTPU_PALLAS_PAGED_ATTN", "1")
    ref, port = int8_models
    tables, pos, prompt, win, vl = _decode_inputs(np.random.RandomState(6))
    jpools = ref.init_block_pool(10, BS, "int8")
    ppools = port.init_block_pool(10, BS, "int8")
    for row, n in ((0, 10), (1, 5)):
        _, jpools = ref.prefill_pages(
            nd.array(prompt[:, :n], dtype="int32"), jpools,
            nd.array(tables[row], dtype="int32"))
        port.prefill_pages(torch.from_numpy(prompt[:, :n]), ppools,
                           torch.from_numpy(tables[row]))
    jl, jpools = ref.step_pages(nd.array(win[:, :1], dtype="int32"), jpools,
                                nd.array(tables, dtype="int32"),
                                nd.array(pos, dtype="int32"))
    pl = port.step_pages(torch.from_numpy(win[:, :1]), ppools, _t(tables),
                         _t(pos))
    np.testing.assert_allclose(pl.numpy()[:2], jl.asnumpy()[:2], **TOL)
    jw, _ = ref.verify_pages(nd.array(win, dtype="int32"), jpools,
                             nd.array(tables, dtype="int32"),
                             nd.array(pos + 1, dtype="int32"),
                             nd.array(vl, dtype="int32"))
    pw = port.verify_pages(torch.from_numpy(win), ppools, _t(tables),
                           _t(pos + 1), _t(vl))
    np.testing.assert_allclose(pw.numpy()[0], jw.asnumpy()[0], **TOL)
    np.testing.assert_allclose(pw.numpy()[1, :2], jw.asnumpy()[1, :2],
                               **TOL)


def test_reference_signature_op_is_the_epilogue():
    """``contrib.quantization.wq_matmul_i8_q8`` is the epilogue over the
    whole output, one counted launch: ``wq_matmul_i8`` then the cache's
    quantizer bit for bit, and the reference's op on the same payload,
    scales and x (CPU float32) up to the order of the products' sums
    (scales within 1e-5 relative, payload within one step)."""
    rng = np.random.RandomState(7)
    w = rng.randn(48, 32).astype(np.float32) * 0.1
    x = rng.randn(5, 32).astype(np.float32)
    qw, sw = q.quantize_tensor(torch.from_numpy(w), 8)
    base.reset_counts()
    vq, vs = q.wq_matmul_i8_q8(torch.from_numpy(x), qw, sw, head_dim=16)
    assert base.counts() == {linear.I8_KERNEL_NAME: 1,
                             linear.Q8_KERNEL_NAME: 1}
    jvq, jvs = jq.wq_matmul_i8_q8(jnp.asarray(x), jnp.asarray(qw.numpy()),
                                  jnp.asarray(sw.numpy()), head_dim=16)
    assert vq.shape == (5, 48) and vs.shape == (5, 3)
    wq_, ws_ = tensor._q8_quantize(q.wq_matmul_i8(
        torch.from_numpy(x), qw, sw).reshape(5, 3, 16))
    assert torch.equal(vq, wq_.reshape(5, 48)) and torch.equal(vs, ws_)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), rtol=1e-5)
    assert np.abs(vq.numpy().astype(int) - np.asarray(jvq)).max() <= 1
