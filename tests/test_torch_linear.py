"""G1 and G2, the row-invariant projection (``ops.linear.rows_linear``)
and RMSNorm (``ops.contrib.rows_rms_norm``), and G2 fused into G1
(``ops.linear.rows_norm_linear``): on the CPU their wrappers run the
plain versions, ``F.linear``, ``rms_norm`` and ``F.linear`` of
``rms_norm``, bit for bit, and the decode step and the verify window
reach them for all of their projections (the four that read a norm
through the fused op, so no norm runs apart), while prefill keeps
``nn.Linear`` and ``RMSNorm``.  The CUDA kernels run only on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phase 3c).

G1's bfloat16 kernel on the CPU: its launch plan (``linear.plan``), and
its arithmetic emulated in float32: each k16 step one MMA (16 exact
bf16 products summed in float32, added to the split's float32 sum), the
steps of a split in order, the splits (``linear.k_ranges``, from N and
K alone) added in split order and rounded once to bfloat16.  At the 8B
K (columns cut to 64, splits of the full projection) the emulation is
held within ``GRAD_TOL`` of its largest output of ``F.linear`` and of
JAX's ``dot_general`` with float32 accumulation, rounded to bfloat16, on
the same numpy-seeded inputs, and its rows are ``torch.equal`` at every
row count and order.  What it cannot show is the tensor cores' own
summation inside an MMA, which the card's tests hold.

The row scale that G2 and the fused norm share (``row_scale`` in
``csrc/rows_linear.cu``) is emulated in both of its forms, G2's 256
threads and the one warp that holds eight of their chains a lane, and
the two are held bit-identical, and near ``rms_norm`` and the
reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

import mxtpu as mx
from mxtpu import nd
from mxtpu.models.transformer import llama_tiny as jax_llama_tiny
from mxtpu.ops.contrib import rms_norm as jax_rms_norm
from mxtpu_torch import base
from mxtpu_torch.models.convert import load_mxtpu_params
from mxtpu_torch.models.transformer import llama_tiny
from mxtpu_torch.ops import contrib, linear


@pytest.mark.parametrize("shape", [(1, 64), (7, 64), (3, 5, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_linear_on_cpu_is_f_linear(shape, dtype):
    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(shape, generator=g).to(dtype)
    w = torch.randn(48, 64, generator=g).to(dtype)
    base.reset_counts()
    y = linear.rows_linear(x, w)
    assert base.counts() == {linear.KERNEL_NAME: 1}
    assert torch.equal(y, F.linear(x, w))
    assert torch.equal(linear.rows_linear_plain(x, w), F.linear(x, w))


def test_rows_linear_has_no_kernel_for_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(linear.MXTPUError, match="no kernel"):
        linear.rows_linear(x, torch.zeros(4, 8, device="meta"))


@pytest.mark.parametrize("shape", [(1, 64), (3, 5, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_rms_norm_on_cpu_is_rms_norm(shape, dtype):
    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(shape, generator=g).to(dtype)
    gamma = torch.randn(shape[-1], generator=g).to(dtype)
    base.reset_counts()
    y = contrib.rows_rms_norm(x, gamma)
    assert base.counts() == {contrib.NORM_KERNEL_NAME: 1}
    assert torch.equal(y, contrib.rms_norm(x, gamma))


@pytest.mark.parametrize("shape", [(1, 64), (7, 72), (3, 5, 48)])
@pytest.mark.parametrize("dtype,gamma_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "bf16-f32gain"])
def test_rows_norm_linear_on_cpu_is_the_pair(shape, dtype, gamma_dtype):
    g = torch.Generator().manual_seed(len(shape) + shape[-1])
    x = torch.randn(shape, generator=g).to(dtype)
    gamma = (1 + 0.1 * torch.randn(shape[-1], generator=g)).to(gamma_dtype)
    w = torch.randn(40, shape[-1], generator=g).to(dtype)
    base.reset_counts()
    y = linear.rows_norm_linear(x, gamma, w)
    assert base.counts() == {linear.KERNEL_NAME: 1,
                             linear.NORM_KERNEL_NAME: 1}
    pair = linear.rows_linear(contrib.rows_rms_norm(x, gamma), w)
    assert y.dtype == dtype and torch.equal(y, pair)
    assert torch.equal(linear.rows_norm_linear_plain(x, gamma, w), pair)


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_step_and_verify_reach_rows_linear_and_prefill_does_not(cache_dtype):
    """G1 takes the 5 projections of each layer and the head on the step
    and the verify window, the 3 of them that read a norm (qkv, gate,
    up) and the head through the fused norm, so G2 never runs apart;
    prefill reaches none of them."""
    model = llama_tiny(vocab_size=50, device="cpu")
    L = len(model.layers)
    per_call = {linear.KERNEL_NAME: 5 * L + 1,
                linear.NORM_KERNEL_NAME: 3 * L + 1,
                contrib.NORM_KERNEL_NAME: 0}
    pools = model.init_block_pool(9, 8, cache_dtype)
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    rng = np.random.RandomState(0)
    base.reset_counts()
    for b in range(2):
        model.prefill_pages(torch.from_numpy(rng.randint(0, 50, (1, 8))),
                            pools, tables[b], 0)
    assert all(base.count(k) == 0 for k in per_call)
    pos = torch.tensor([8, 8], dtype=torch.int32)
    model.step_pages(torch.tensor([[3], [4]]), pools, tables, pos)
    assert {k: base.count(k) for k in per_call} == per_call
    model.verify_pages(torch.tensor([[3, 5, 6], [4, 1, 2]]), pools, tables,
                       pos + 1, torch.tensor([3, 2], dtype=torch.int32))
    assert {k: base.count(k) for k in per_call} == {
        k: 2 * n for k, n in per_call.items()}


def _gained_pair():
    """The reference's seeded ``llama_tiny`` (vocab 50) and the port's
    loaded from it, every RMSNorm given its own random gain (not the
    ones it starts at, so a swapped or missing gain shows)."""
    mx.random.seed(78)
    ref = jax_llama_tiny(vocab_size=50)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    rng = np.random.RandomState(11)
    params = {}
    for k, v in ref.collect_params().items():
        if k.endswith("norm_weight"):
            v.set_data(nd.array(1 + 0.5 * rng.standard_normal(
                v.shape).astype(np.float32)))
        params[k] = v.data().asnumpy()
    assert len({params[k].tobytes() for k in params
                if k.endswith("norm_weight")}) == 2 * 2 + 1
    port = llama_tiny(vocab_size=50, device="cpu")
    load_mxtpu_params(port, params)
    return ref, port


def _jax_pools(pools):
    return [tuple(tuple(nd.NDArray(a) for a in leaf) if isinstance(
        leaf, tuple) else nd.NDArray(leaf) for leaf in pair)
        for pair in pools]


def _raw_pools(pools):
    return [tuple(tuple(a._data for a in leaf) if isinstance(leaf, tuple)
                  else leaf._data for leaf in pair) for pair in pools]


@pytest.mark.parametrize("cache_dtype", [None, "int8"], ids=["f32", "int8"])
def test_normed_projections_with_distinct_gains_match_the_reference(
        cache_dtype):
    """A prefill, a pooled decode step and a verify window with a dead
    lane, with each norm's own gain, against the reference's, at the
    logits tolerance of tests/test_torch_transformer.py (1e-4): the
    fused norm takes the gain of the norm it replaces."""
    ref, port = _gained_pair()
    tol = dict(atol=1e-4, rtol=1e-4)
    rng = np.random.RandomState(12)
    toks = rng.randint(0, 50, (1, 11)).astype(np.int32)
    table = np.array([3, 6, 2, 0, 0], np.int32)
    jpools = _raw_pools(ref.init_block_pool(8, 8, cache_dtype or "float32"))
    pools = port.init_block_pool(8, 8, cache_dtype)
    jl, jpools = ref.prefill_pages(nd.array(toks, dtype="int32"),
                                   _jax_pools(jpools),
                                   nd.array(table, dtype="int32"))
    jpools = _raw_pools(jpools)
    got = port.prefill_pages(torch.from_numpy(toks).long(), pools,
                             torch.from_numpy(table), 0)
    np.testing.assert_allclose(got.numpy(), jl.asnumpy(), **tol)
    tables = np.stack([table, np.zeros_like(table)])
    pos = np.array([11, 0], np.int32)
    last = np.array([[int(toks[0, -1])], [0]], np.int32)
    jl, jpools = ref.step_pages(nd.array(last, dtype="int32"),
                                _jax_pools(jpools),
                                nd.array(tables, dtype="int32"),
                                nd.array(pos, dtype="int32"))
    jpools = _raw_pools(jpools)
    got = port.step_pages(torch.from_numpy(last).long(), pools,
                          torch.from_numpy(tables), torch.from_numpy(pos))
    np.testing.assert_allclose(got[0].numpy(), jl.asnumpy()[0], **tol)
    window = np.array([[7, 4, 9], [0, 0, 0]], np.int32)
    vl = np.array([3, 0], np.int32)
    jl, _ = ref.verify_pages(nd.array(window, dtype="int32"),
                             _jax_pools(jpools),
                             nd.array(tables, dtype="int32"),
                             nd.array(pos + 1, dtype="int32"),
                             nd.array(vl, dtype="int32"))
    got = port.verify_pages(torch.from_numpy(window).long(), pools,
                            torch.from_numpy(tables),
                            torch.from_numpy(pos + 1), torch.from_numpy(vl))
    np.testing.assert_allclose(got[0].numpy(), jl.asnumpy()[0], **tol)


def _fma(a, b, c):
    """fmaf on float32 tensors: the product and sum in float64, rounded
    once to float32 (exact for bfloat16 inputs, whose squares hold 16
    bits)."""
    return (a.double() * b.double() + c.double()).float()


def _blocks(x):
    """x (R, C) zero-padded to whole 256-element blocks, (R, n, 256):
    past C a chain adds +0 to its sum of squares, which leaves it as it
    is."""
    R, C = x.shape
    return F.pad(x, (0, -C % 256)).reshape(R, -1, 256)


def _g2_sum(x):
    """G2's sum of squares of each row as 256 threads take it: thread u
    sums elements u, u + 256, ... with fmaf in order, each warp's 32
    threads add by an xor butterfly 16, 8, 4, 2, 1, and the 8 warp sums
    are added in order."""
    blocks = _blocks(x)
    s = torch.zeros(x.shape[0], 256)
    for i in range(blocks.shape[1]):
        s = _fma(blocks[:, i], blocks[:, i], s)
    s = s.reshape(-1, 8, 32)
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, :, lanes ^ o]
    total = s[:, 0, 0]
    for w in range(1, 8):
        total = total + s[:, w, 0]
    return total


def _warp_sum(x):
    """The same sum as one warp takes it (``row_scale``): lane l keeps
    the chains of threads 8l .. 8l + 7, fed by one 16-byte load a
    256-element block; the butterfly's steps 16 and 8 shuffle lanes
    (xor 2, xor 1), its steps 4, 2, 1 add inside the lane, and warp
    w's sum is lane 4w's."""
    blocks = _blocks(x)
    s = torch.zeros(x.shape[0], 32, 8)
    for i in range(blocks.shape[1]):
        v = blocks[:, i].reshape(-1, 32, 8)
        s = _fma(v, v, s)
    lanes = torch.arange(32)
    s = s + s[:, lanes ^ 2]
    s = s + s[:, lanes ^ 1]
    w = ((s[..., 0] + s[..., 4]) + (s[..., 2] + s[..., 6])) \
        + ((s[..., 1] + s[..., 5]) + (s[..., 3] + s[..., 7]))
    total = w[:, 0]
    for k in range(1, 8):
        total = total + w[:, 4 * k]
    return total


@pytest.mark.parametrize("C", [4096, 172, 72], ids=lambda c: "C%d" % c)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_emulated_row_scale_orders_agree_and_hold_rms_norm(C, dtype):
    rng = np.random.RandomState(C)
    x = torch.from_numpy((rng.standard_normal((64, C)) * np.exp(
        rng.standard_normal((64, 1)))).astype(np.float32)).to(dtype).float()
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(C)).astype(
        np.float32))
    total = _g2_sum(x)
    assert torch.equal(_warp_sum(x), total)
    out = x * torch.rsqrt(total / C + 1e-6)[:, None] * gamma
    for ref in (contrib.rms_norm(x, gamma), torch.from_numpy(np.array(
            jax_rms_norm(jnp.asarray(x.numpy()), jnp.asarray(
                gamma.numpy()))))):
        err = (out - ref).abs().max() / ref.abs().max()
        assert float(err) <= 1e-6


#: Llama-3-8B's decode-step projections (name, N, K)
PROJECTIONS = [("qkv", 6144, 4096), ("out_proj", 4096, 4096),
               ("gate_proj", 14336, 4096), ("up_proj", 14336, 4096),
               ("down_proj", 4096, 14336), ("lm_head", 128256, 4096)]
#: one bfloat16 ulp of the largest output (chip_smoke.GRAD_TOL)
GRAD_TOL = 2 ** -7
MAX_SMEM_BYTES = 232448


def _ranges_cover(ranges, K):
    """Each split's K range is nonempty, starts on a k16 step, and the
    ranges tile [0, K) once each, in split order."""
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    for a, b in ranges:
        assert a % 16 == 0 and (b % 16 == 0 or b == K) and a < b


@pytest.mark.parametrize("name,N,K", PROJECTIONS,
                         ids=[p[0] for p in PROJECTIONS])
def test_plan_keeps_the_splits_and_k_order_at_every_row_count(name, N, K):
    S = linear.splits(N, K)
    ranges = linear.k_ranges(N, K)
    assert 1 <= S <= 8 and len(ranges) == S
    _ranges_cover(ranges, K)
    for M in range(1, 257):
        p = linear.plan(M, N, K)
        assert p["splits"] == S and linear.k_ranges(N, K) == ranges
        assert p["smem"] <= MAX_SMEM_BYTES
        # the fused norm's plan: the same but a slot of gains a stage
        # and, above 8 rows, two normalizing warps
        fused = linear.plan(M, N, K, norm=True)
        assert fused == dict(p, smem=p["smem"] + 256 * p["stages"],
                             threads=p["threads"] + 64 * (p["rows"] > 8))
        assert fused["smem"] <= MAX_SMEM_BYTES and fused["threads"] <= 352
        assert p["rows"] >= min(M, 128) and p["rows"] * p["chunks"] >= M
        assert p["rows"] <= p["bn"] and p["tiles"] * p["bn"] >= N
        if p["rows"] == 128:   # 192 columns only where one wave holds it
            assert p["bn"] == 256 or p["tiles"] * S <= 120
        stage = (p["bn"] + p["rows"]) * p["bk"] * 2
        assert 2 <= p["stages"] and p["stages"] * stage <= p["smem"]
    # every M <= 128 is one chunk: the weights stream through once
    assert all(linear.plan(M, N, K)["chunks"] == 1 for M in (8, 64, 128))


@pytest.mark.parametrize("N,K", [(130, 72), (4096, 520), (200, 40),
                                 (4096, 512), (96, 8), (64, 0)])
def test_plan_splits_ragged_shapes_on_k16_steps(N, K):
    ranges = linear.k_ranges(N, K)
    if K == 0:
        assert ranges == [(0, 0)]
        return
    _ranges_cover(ranges, K)
    for M in (1, 9, 33, 65, 129):
        assert linear.plan(M, N, K)["splits"] == len(ranges)


def _emulated(x, w, N_full=None):
    """G1's bfloat16 arithmetic on the CPU, (M, K) x (n, K) -> (M, n)
    bf16, the K splits those of an (N_full, K) weight."""
    M, K = x.shape
    n = w.shape[0]
    steps = -(-K // 16)
    pad = steps * 16 - K                 # the kernel zeroes a half step
    xf = F.pad(x.float(), (0, pad)).reshape(M, 1, steps, 16)
    wf = F.pad(w.float(), (0, pad)).reshape(1, n, steps, 16)
    mma = xf[..., 0] * wf[..., 0]        # (M, n, steps): one MMA a step
    for i in range(1, 16):
        mma = mma + xf[..., i] * wf[..., i]
    y = None
    for k0, k1 in linear.k_ranges(N_full or n, K):
        part = torch.zeros(M, n)
        for s in range(k0 // 16, -(-k1 // 16)):
            part = part + mma[..., s]
        y = part if y is None else y + part
    return y.to(torch.bfloat16)


def _seeded(M, n, K, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(0.02 * rng.standard_normal((n, K)).astype(
        np.float32))
    return x.bfloat16(), w.bfloat16()


@pytest.mark.parametrize("name,N,K", PROJECTIONS,
                         ids=[p[0] for p in PROJECTIONS])
def test_emulated_arithmetic_holds_f_linear_and_jax(name, N, K):
    x, w = _seeded(64, 64, K, seed=len(name))
    got = _emulated(x, w, N)
    want = F.linear(x, w)
    ref = jax.lax.dot_general(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(w.float().numpy()).astype(jnp.bfloat16),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    ref = ref.bfloat16().float()
    tol = GRAD_TOL * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert float((got.float() - ref).abs().max()) <= tol


@pytest.mark.parametrize("name,N,K", [PROJECTIONS[1], PROJECTIONS[4],
                                      PROJECTIONS[5]],
                         ids=["out_proj", "down_proj", "lm_head"])
def test_emulated_rows_ignore_the_row_count_and_order(name, N, K):
    x, w = _seeded(200, 64, K, seed=3)
    full = _emulated(x, w, N)
    for M in (1, 8, 64, 128):
        assert torch.equal(_emulated(x[:M], w, N), full[:M]), M
    perm = torch.from_numpy(np.random.RandomState(4).permutation(200))
    assert torch.equal(_emulated(x[perm], w, N), full[perm])
