"""G3 and G4's arithmetic (``csrc/rows_linear.cu``, the weight-only int8
and int4 forms of the bf16 kernel) emulated on the CPU, held against the
plain versions (``ops/linear.py``) and the JAX reference's
``wq_matmul_i8`` / ``wq_matmul_i4`` (``mxtpu/contrib/quantization.py``).

The emulation follows the kernel: the plan's K splits (``k_ranges``:
int8 on whole 64-deep slices, int4 on whole groups), each split walked
in 64-deep slices of k16 steps, and inside a slice the kernel's
permutation of k: a lane owns a run of k inside each U-deep block (U =
64 for int8 and for int4 groups of a multiple of 64, else 32 or 16), so
step s of lane t takes k kb .. kb + 3 (the MMA's k 2t, 2t + 1, 2t + 8,
2t + 9), kb = 16t + 4s, 32(s // 2) + 8t + 4(s % 2) or 16s + 4t.  Each
step is one MMA, its 16 products summed in the MMA's k order in float32
(the tensor cores' own order inside a step is not IEEE-sequential, so
this is the arithmetic up to that order); int8 adds the steps of a
split and scales the split sum once, int4 adds each group's steps into
a fresh float32 sum, multiplied by the group's scale and added to the
split's running sum in k order; the splits are added in split order and
rounded to bf16 once.  A row's result so depends only on that row of x:
the tests hold it ``torch.equal`` across row counts and orders.  Shapes:
the 8B projections' K at 64 output channels, and ragged ones with group
sizes 16, 32, 64 and 128 (every run U)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.contrib import quantization as jq
from mxtpu_torch.contrib.quantization import quantize_tensor
from mxtpu_torch.ops import linear


#: the projections' (N, K) of Llama-3-8B
PROJECTIONS = [("qkv", 6144, 4096), ("out_proj", 4096, 4096),
               ("gate_proj", 14336, 4096), ("up_proj", 14336, 4096),
               ("down_proj", 4096, 14336), ("lm_head", 128256, 4096)]
#: bf16's tolerance (chip_smoke.TOL): float32 sums of exact products in
#: other orders, rounded once, against the largest output
TOL = 2e-2


def run_unit(wtype, gs):
    """The kernel's U: the k run a lane owns inside a slice's block."""
    if wtype == "int8" or gs % 64 == 0:
        return 64
    return 32 if gs % 32 == 0 else 16


def step_k(U, s):
    """The 16 k (offsets in the 64-deep slice) of step s, in the MMA's k
    order 0 .. 15: lane t gives k 2t, 2t + 1 (its kb, kb + 1) and 2t + 8,
    2t + 9 (kb + 2, kb + 3)."""
    out = [0] * 16
    for t in range(4):
        if U == 64:
            kb = 16 * t + 4 * s
        elif U == 32:
            kb = 32 * (s // 2) + 8 * t + 4 * (s % 2)
        else:
            kb = 16 * s + 4 * t
        out[2 * t], out[2 * t + 1] = kb, kb + 1
        out[2 * t + 8], out[2 * t + 9] = kb + 2, kb + 3
    return out


def _weights(q, wtype, K):
    """The int weights (N, K) as float32."""
    if wtype == "int8":
        return q.float()
    return linear.unpack_int4_torch(q).float()[:, :K]


def emulated(x, q, s, wtype, gs=0, N_full=None, bias=None):
    """G3/G4's bf16 arithmetic on the CPU: x (M, K) bf16, q and s the
    payload and scales of n output channels; the splits those of an
    (N_full, K) weight."""
    M, K = x.shape
    n = q.shape[0]
    U = run_unit(wtype, gs)
    ranges = linear.k_ranges(N_full or n, K, wtype, gs)
    pad = -K % 64                        # past K x and w land as zeros
    xf = torch.nn.functional.pad(x.float(), (0, pad))
    wf = torch.nn.functional.pad(_weights(q, wtype, K), (0, pad))
    # every step of every split, in order: its 16 k in the MMA's order
    walk = []                            # (split, k list, group end?)
    for split, (k0, k1) in enumerate(ranges):
        gstep = 0
        for ks in range(k0, k1, 64):
            steps = 4 if wtype == "int8" else min(4, (k1 - ks) // 16)
            for st in range(steps):
                ks16 = [ks + o for o in step_k(U, st)]
                end = None
                if wtype == "int4":
                    gstep += 1
                    if gstep == gs // 16:
                        gstep, end = 0, ks16[0] // gs
                walk.append((split, ks16, end))
    idx = torch.tensor([w[1] for w in walk])           # (steps, 16)
    xs, ws = xf[:, idx], wf[:, idx]                    # (M|n, steps, 16)
    mma = xs[:, None, :, 0] * ws[None, :, :, 0]        # (M, n, steps)
    for i in range(1, 16):
        mma = mma + xs[:, None, :, i] * ws[None, :, :, i]
    y = None
    part = accg = None
    for j, (split, _, end) in enumerate(walk):
        if part is None:
            part = torch.zeros(M, n)
        if wtype == "int8":
            part = part + mma[..., j]
        else:
            accg = mma[..., j] if accg is None else accg + mma[..., j]
            if end is not None:
                part = part + accg * s[:, end].float()
                accg = None
        if j + 1 == len(walk) or walk[j + 1][0] != split:
            y = part if y is None else y + part
            part = None
    if wtype == "int8":
        y = y * s.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(torch.bfloat16)


def _case(n, K, wtype, gs, M=64, seed=0):
    """Seeded bf16 x (rows of varied scale) and weights quantized by the
    port's quantize_tensor (int8, or int4 at group size gs)."""
    rng = np.random.RandomState(seed)
    w = torch.from_numpy((0.02 * rng.standard_normal((n, K))).astype(
        np.float32))
    x = torch.from_numpy((rng.standard_normal((M, K)) * np.exp(
        rng.standard_normal((M, 1)))).astype(np.float32)).bfloat16()
    q, s = quantize_tensor(w, 8 if wtype == "int8" else 4, gs or 64)
    return x, q, s


def _reference(x, q, s, wtype, gs, bias=None):
    """The JAX reference's float32 op on the same bits, as float32."""
    args = (jnp.asarray(x.float().numpy()), jnp.asarray(q.numpy()),
            jnp.asarray(s.numpy()),
            None if bias is None else jnp.asarray(bias.numpy()))
    if wtype == "int8":
        out = jq.wq_matmul_i8(*args, no_bias=bias is None)
    else:
        out = jq.wq_matmul_i4(*args, no_bias=bias is None, group_size=gs,
                              in_units=x.shape[1])
    return torch.from_numpy(np.asarray(out))


@pytest.mark.parametrize("U", [64, 32, 16])
def test_step_permutation_covers_each_k_once_inside_its_block(U):
    """A slice's four steps take each of its 64 k once, every step's 16 k
    inside one U-deep block (so inside one group), a lane's four k of a
    step consecutive and its k of the block one run of U / 4."""
    seen = sorted(k for s in range(4) for k in step_k(U, s))
    assert seen == list(range(64))
    for s in range(4):
        ks = step_k(U, s)
        assert len({k // U for k in ks}) == 1
        for t in range(4):
            lane = [ks[2 * t], ks[2 * t + 1], ks[2 * t + 8], ks[2 * t + 9]]
            assert lane == list(range(lane[0], lane[0] + 4))
    for t in range(4):
        for block in range(64 // U):
            run = sorted(k for s in range(4) for i in (2 * t, 2 * t + 1,
                                                       2 * t + 8, 2 * t + 9)
                         for k in [step_k(U, s)[i]] if k // U == block)
            assert run == list(range(run[0], run[0] + U // 4))


#: (name, N, K, weight type, group size): the 8B projections (int8, and
#: int4 at the main path's group size 64) and ragged shapes at every U
CASES = [(name, N, K, "int8", 0) for name, N, K in PROJECTIONS] \
    + [(name, N, K, "int4", 64) for name, N, K in PROJECTIONS] \
    + [("ragged", 130, 80, "int8", 0), ("ragged", 4096, 544, "int8", 0),
       ("ragged", 130, 96, "int4", 16), ("ragged", 200, 160, "int4", 32),
       ("ragged", 4096, 576, "int4", 64), ("ragged", 4096, 1024, "int4", 128),
       ("ragged", 96, 480, "int4", 48), ("ragged", 64, 384, "int4", 96)]


@pytest.mark.parametrize("name,N,K,wtype,gs", CASES, ids=[
    "%s-%dx%d-%s-g%d" % c for c in CASES])
def test_emulated_arithmetic_holds_plain_and_reference(name, N, K, wtype,
                                                       gs):
    """The emulation on 64 output channels (the splits those of the full
    N) within TOL of its largest output of the plain version and of the
    reference's op, with a bias on the ragged shapes."""
    x, q, s = _case(64, K, wtype, gs, seed=K + gs)
    bias = None
    if name == "ragged":
        bias = torch.from_numpy(np.random.RandomState(1).standard_normal(
            64).astype(np.float32))
    got = emulated(x, q, s, wtype, gs, N, bias).float()
    want = linear.wq_matmul_plain(x, q, s, bias=bias).float()
    ref = _reference(x, q, s, wtype, gs, bias).bfloat16().float()
    tol = TOL * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("name,N,K,wtype,gs", [
    CASES[1], CASES[4], CASES[6 + 1], CASES[6 + 4], CASES[12 + 3],
    CASES[12 + 5], CASES[12 + 6]],
    ids=["out_proj-int8", "down_proj-int8", "out_proj-int4",
         "down_proj-int4", "g32", "g128", "g48"])
def test_emulated_rows_ignore_the_row_count_and_order(name, N, K, wtype,
                                                      gs):
    """Each row's bits are the same at any row count and in any
    position: the splits, steps and groups depend on N, K and gs
    alone."""
    x, q, s = _case(64, K, wtype, gs, M=200, seed=5)
    full = emulated(x, q, s, wtype, gs, N)
    for M in (1, 8, 64, 128):
        assert torch.equal(emulated(x[:M], q, s, wtype, gs, N), full[:M]), M
    perm = torch.from_numpy(np.random.RandomState(4).permutation(200))
    assert torch.equal(emulated(x[perm], q, s, wtype, gs, N), full[perm])
