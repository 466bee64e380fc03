"""G1 and G2, the row-invariant projection (``ops.linear.rows_linear``)
and RMSNorm (``ops.contrib.rows_rms_norm``): on the CPU their wrappers
run the plain versions, ``F.linear`` and ``rms_norm`` bit for bit, and
the decode step and the verify window reach them for all of their
projections and norms, while prefill keeps ``nn.Linear`` and
``RMSNorm``.  The CUDA kernels run only on the card
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
summation inside an MMA, which the card's tests hold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from mxtpu_torch import base
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


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_step_and_verify_reach_rows_linear_and_prefill_does_not(cache_dtype):
    """G1 takes the 5 projections of each layer and the head, G2 the 2
    norms of each layer and the final one, on the step and the verify
    window; prefill reaches neither."""
    model = llama_tiny(vocab_size=50, device="cpu")
    L = len(model.layers)
    per_call = {linear.KERNEL_NAME: 5 * L + 1,
                contrib.NORM_KERNEL_NAME: 2 * L + 1}
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
