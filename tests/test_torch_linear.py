"""G1 and G2, the row-invariant projection (``ops.linear.rows_linear``)
and RMSNorm (``ops.contrib.rows_rms_norm``): on the CPU their wrappers
run the plain versions, ``F.linear`` and ``rms_norm`` bit for bit, and
the decode step and the verify window reach them for all of their
projections and norms, while prefill keeps ``nn.Linear`` and
``RMSNorm``.  The CUDA kernels run only on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phase 3c)."""

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
