"""The port's Switch mixture-of-experts op and blocks
(``mxtpu_torch/ops/moe.py``, ``mxtpu_torch/models/moe.py``) held against
the JAX reference (``mxtpu/ops/moe.py``) on the CPU, on the same
numpy-seeded inputs.

``switch_moe`` over top-1, 2 and 3, capacity factors 0.125 to 8, an
explicit capacity, unbounded capacity, unnormalized gates, the three
activations, the z-loss, (B, T, d) and (S, d) inputs and all-zero
routers (every gate ties): y within 1e-5, aux within 1e-6 relative, the
same rows dropped and exactly zero, the gradients of x, the router and
both expert tensors within 1e-5 (float32 on both sides).

Also ported from the reference's ``tests/test_moe.py``: every case of
the op and the blocks that needs no mesh and no symbol tracing (the
models' are in ``tests/test_torch_moe_model.py``).  Router jitter draws
differently in the two frameworks (threefry against
``torch.Generator``), so only its contract is tested: nothing outside
training, a changed output in training, the same output from the same
generator state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ops.moe import switch_moe as jax_switch_moe
from mxtpu_torch.base import MXTPUError
from mxtpu_torch.models.moe import MoEDecoderLayer, SwitchMoE
from mxtpu_torch.models.transformer import TransformerLM
from mxtpu_torch.ops.moe import expert_capacity, switch_moe

MOE = dict(num_experts=4, capacity_factor=4.0)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# -- switch_moe against the reference -----------------------------------------

#: (name, shape of x, E, d, h, keywords, zero router)
CASES = []
for _k in (1, 2, 3):
    for _cf in (0.125, 1.0, 1.25, 8.0):
        CASES.append(("k%d-cf%g" % (_k, _cf), (2, 6, 8), 4, 8, 16,
                      dict(top_k=_k, capacity_factor=_cf), False))
CASES += [
    ("k2-capacity3", (2, 6, 8), 4, 8, 16, dict(top_k=2, capacity=3), False),
    ("k1-cf0", (2, 6, 8), 4, 8, 16, dict(capacity_factor=0.0), False),
    ("k2-cf-1", (2, 6, 8), 4, 8, 16, dict(top_k=2, capacity_factor=-1.0),
     False),
    ("k2-unnormalized", (2, 6, 8), 4, 8, 16,
     dict(top_k=2, normalize_gates=False, capacity_factor=1.25), False),
    ("gelu", (2, 6, 8), 4, 8, 16, dict(activation="gelu"), False),
    ("relu-k2", (2, 6, 8), 4, 8, 16, dict(activation="relu", top_k=2),
     False),
    ("zloss", (2, 6, 8), 4, 8, 16, dict(z_loss_weight=1e-2), False),
    ("zloss-k3", (2, 6, 8), 4, 8, 16,
     dict(top_k=3, z_loss_weight=3e-2, capacity_factor=1.0), False),
    ("flat-S", (13, 8), 5, 8, 12, dict(capacity_factor=1.25), False),
    ("flat-S-k2", (13, 8), 5, 8, 12, dict(top_k=2), False),
    ("zero-router-k1", (2, 6, 8), 4, 8, 16, dict(capacity_factor=1.0), True),
    ("zero-router-k2", (2, 6, 8), 4, 8, 16, dict(top_k=2), True),
    ("zero-router-k3-gelu", (1, 9, 8), 4, 8, 16,
     dict(top_k=3, activation="gelu", capacity_factor=2.0), True),
]


def _case_inputs(shape, E, d, h, zero, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype("f")
    rw = (np.zeros((E, d), "f") if zero
          else rng.randn(E, d).astype("f") * 0.7)
    w1 = rng.randn(E, d, h).astype("f") * 0.3
    w2 = rng.randn(E, h, d).astype("f") * 0.3
    r = rng.randn(*shape).astype("f")
    return x, rw, w1, w2, r


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_switch_moe_matches_the_reference_with_gradients(case):
    """y, aux, the dropped rows and the four gradients of
    ``sum(y * r) + 0.5 * aux``."""
    name, shape, E, d, h, kw, zero = case
    x, rw, w1, w2, r = _case_inputs(shape, E, d, h, zero,
                                    seed=len(name) * 7 + E)

    def ref_loss(*args):
        y, aux = jax_switch_moe(*args, **kw)
        return jnp.sum(y * r) + 0.5 * aux, (y, aux)

    (_, (ry, raux)), rgrads = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in (x, rw, w1, w2)))
    ry, raux = np.asarray(ry), float(raux)

    leaves = [_t(a).requires_grad_() for a in (x, rw, w1, w2)]
    y, aux = switch_moe(*leaves, **kw)
    (torch.sum(y * _t(r)) + 0.5 * aux).backward()
    assert y.shape == x.shape and y.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.shape == ()
    got = y.detach().numpy()
    np.testing.assert_allclose(got, ry, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), raux, rtol=1e-6)
    dropped = np.abs(ry.reshape(-1, d)).sum(-1) == 0
    np.testing.assert_array_equal(
        np.abs(got.reshape(-1, d)).sum(-1) == 0, dropped)
    if "cf0.125" in name:
        assert dropped.any()
    for leaf, want in zip(leaves, rgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)


def test_bf16_input_keeps_its_dtype_and_computes_in_float32():
    x, rw, w1, w2, _ = _case_inputs((2, 6, 8), 4, 8, 16, False, 1)
    xb = _t(x).bfloat16()
    y, aux = switch_moe(xb, _t(rw), _t(w1), _t(w2), capacity_factor=2.0)
    want, _ = switch_moe(xb.float(), _t(rw), _t(w1), _t(w2),
                         capacity_factor=2.0)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    torch.testing.assert_close(y, want.bfloat16(), rtol=0, atol=0)


def test_capacity_formula_and_refusals():
    assert expert_capacity(16, 2, 1, 0.125) == 1
    assert expert_capacity(16, 4, 2, 1.25) == 10       # ceil(2*16/4*1.25)
    assert expert_capacity(3, 4, 1, 0.01) == 1
    assert expert_capacity(7, 4, 3, 0.0) == 21         # S*k: unbounded
    assert expert_capacity(7, 4, 3, 2.0, capacity=0) == 1
    x, rw, w1, w2, _ = _case_inputs((4, 8), 2, 8, 16, False, 2)
    with pytest.raises(MXTPUError, match="activation"):
        switch_moe(_t(x), _t(rw), _t(w1), _t(w2), activation="tanh")
    with pytest.raises(MXTPUError, match="top_k"):
        switch_moe(_t(x), _t(rw), _t(w1), _t(w2), top_k=3)


# -- the reference's tests/test_moe.py, ported --------------------------------

def test_single_expert_equals_dense_ffn():
    rng = np.random.RandomState(0)
    d, h, S = 8, 16, 12
    x = rng.randn(2, 6, d).astype("f")
    w1 = rng.randn(1, d, h).astype("f") * 0.3
    w2 = rng.randn(1, h, d).astype("f") * 0.3
    y, aux = switch_moe(_t(x), torch.zeros(1, d), _t(w1), _t(w2),
                        capacity_factor=2.0)
    hn = x.reshape(S, d) @ w1[0]
    hn = hn * (1 / (1 + np.exp(-hn)))  # swish
    np.testing.assert_allclose(y.numpy(), (hn @ w2[0]).reshape(2, 6, d),
                               rtol=1e-4, atol=1e-5)
    assert abs(float(aux) - 1.0) < 1e-5


def test_capacity_drops_tokens_to_zero():
    rng = np.random.RandomState(1)
    d, h = 4, 8
    y, _ = switch_moe(_t(rng.randn(1, 16, d).astype("f")), torch.zeros(2, d),
                      _t(rng.randn(2, d, h).astype("f")),
                      _t(rng.randn(2, h, d).astype("f")),
                      capacity_factor=0.125)
    # capacity ceil(16/2 * 0.125) = 1 per expert, ties to expert 0
    nz = (y[0].abs().sum(-1) > 0).numpy()
    assert nz.sum() == 1 and nz[0]


def test_all_tokens_kept_with_ample_capacity():
    rng = np.random.RandomState(2)
    d, h, E = 6, 12, 4
    y, aux = switch_moe(_t(rng.randn(2, 8, d).astype("f")),
                        _t(rng.randn(E, d).astype("f")),
                        _t(rng.randn(E, d, h).astype("f") * 0.5),
                        _t(rng.randn(E, h, d).astype("f") * 0.5),
                        capacity_factor=8.0)
    assert bool((y.abs().sum(-1) > 1e-8).all())
    assert float(aux) >= 1.0 - 1e-5


def test_moe_block_trains_and_balances():
    """SwitchMoE in a residual block, Adam through ``gluon.Trainer``'s
    rule: the loss falls and every parameter gets a gradient, the aux
    loss through the live ``aux_loss``."""
    torch.manual_seed(3)
    rng = np.random.RandomState(3)
    d, h, E = 8, 16, 4
    blk = SwitchMoE(d, h, E, capacity_factor=2.0, device="cpu")
    X = _t(rng.randn(16, 4, d).astype("f"))
    target = _t(rng.randn(16, 4, d).astype("f") * 0.1)
    opt = torch.optim.Adam(blk.parameters(), lr=5e-3)
    losses = []
    for _ in range(40):
        opt.zero_grad()
        out = blk(X)
        L = 0.5 * ((X + out - target) ** 2).mean() + 0.01 * blk.aux_loss
        L.backward()
        grads = {n: float(p.grad.abs().sum()) for n, p in
                 blk.named_parameters()}
        opt.step()
        losses.append(float(L.detach()))
    assert losses[-1] < losses[0], (losses[0], losses[-1])
    assert all(g > 0 for g in grads.values()), grads


def test_moe_decoder_layer_forward_backward():
    torch.manual_seed(4)
    layer = MoEDecoderLayer(32, 64, 4, 2, 4, device="cpu")
    x = _t(np.random.RandomState(4).randn(2, 8, 32).astype("f"))
    x.requires_grad_()
    y = layer(x)
    y.sum().backward()
    assert y.shape == x.shape
    assert float(x.grad.abs().sum()) > 0


def test_moe_return_aux_trains():
    torch.manual_seed(6)
    rng = np.random.RandomState(6)
    d, h, E = 8, 16, 4
    blk = SwitchMoE(d, h, E, capacity_factor=2.0, return_aux=True,
                    device="cpu")
    X = _t(rng.randn(16, 4, d).astype("f"))
    target = _t(rng.randn(16, 4, d).astype("f") * 0.1)
    opt = torch.optim.Adam(blk.parameters(), lr=5e-3)
    losses = []
    for _ in range(12):
        opt.zero_grad()
        out, aux = blk(X)
        L = 0.5 * ((X + out - target) ** 2).mean() + 0.01 * aux
        L.backward()
        opt.step()
        losses.append(float(L.detach()))
    assert losses[-1] < losses[0]


def test_moe_transformer_lm_decode_parity():
    """The cache step through routed layers reproduces the full forward."""
    torch.manual_seed(8)
    lm = TransformerLM(40, 32, 64, 2, 4, 2, device="cpu", **MOE)
    ids = _t(np.random.RandomState(8).randint(0, 40, (2, 5)))
    full = lm(ids).detach().numpy()
    caches = lm.init_cache(2, 5)
    for pos in range(5):
        logits = lm.step(ids[:, pos:pos + 1], caches, pos)
    np.testing.assert_allclose(logits.numpy()[:, 0], full[:, -1],
                               rtol=2e-4, atol=2e-5)


def test_decode_forward_capacity_unbounded():
    torch.manual_seed(9)
    blk = SwitchMoE(4, 8, 4, capacity_factor=1.25, device="cpu")
    with torch.no_grad():
        blk.router_weight.zero_()
    x = _t(np.random.RandomState(9).randn(2, 1, 4).astype("f"))
    y_train = blk(x).detach()
    assert int((y_train.abs().sum(-1) > 1e-7).sum()) == 1
    y_dec = blk.decode_forward(x)
    assert int((y_dec.abs().sum(-1) > 1e-7).sum()) == 2


def test_top2_matches_two_expert_reference():
    rng = np.random.RandomState(21)
    S, d, h, E = 6, 4, 8, 4
    x = rng.randn(S, d).astype("f")
    rw = rng.randn(E, d).astype("f")
    w1 = rng.randn(E, d, h).astype("f") * 0.3
    w2 = rng.randn(E, h, d).astype("f") * 0.3
    y, _ = switch_moe(_t(x), _t(rw), _t(w1), _t(w2), capacity_factor=100.0,
                      top_k=2, activation="relu")
    logits = x @ rw.T
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g = g / g.sum(-1, keepdims=True)
    expect = np.zeros_like(x)
    for s in range(S):
        top2 = np.argsort(-g[s])[:2]
        denom = g[s][top2].sum()
        for e in top2:
            expect[s] += (g[s][e] / denom) * (np.maximum(x[s] @ w1[e], 0.0)
                                              @ w2[e])
    np.testing.assert_allclose(y.numpy(), expect, rtol=2e-4, atol=2e-5)


def test_top1_unchanged_by_topk_plumbing():
    rng = np.random.RandomState(22)
    S, d, h, E = 5, 4, 8, 3
    args = [_t(rng.randn(S, d).astype("f")), _t(rng.randn(E, d).astype("f")),
            _t(rng.randn(E, d, h).astype("f")),
            _t(rng.randn(E, h, d).astype("f"))]
    y1, a1 = switch_moe(*args, capacity_factor=2.0)
    y2, a2 = switch_moe(*args, capacity_factor=2.0, top_k=1)
    assert torch.equal(y1, y2) and float(a1) == float(a2)


def test_first_choice_fills_capacity_before_second():
    rng = np.random.RandomState(23)
    S, d, h, E = 4, 4, 8, 2
    x = (np.abs(rng.randn(S, d)) + 0.5).astype("f")
    rw = np.zeros((E, d), "f")
    rw[0] = 10.0
    y, _ = switch_moe(_t(x), _t(rw), _t(rng.randn(E, d, h).astype("f")),
                      _t(rng.randn(E, h, d).astype("f")),
                      capacity_factor=0.5, top_k=2)
    assert float(y[2:].abs().sum()) == 0.0
    assert float(y[0].abs().sum()) > 0.0


def test_router_zloss_increases_aux():
    rng = np.random.RandomState(24)
    args = [_t(rng.randn(6, 4).astype("f") * 3),
            _t(rng.randn(4, 4).astype("f") * 3),
            _t(rng.randn(4, 4, 8).astype("f")),
            _t(rng.randn(4, 8, 4).astype("f"))]
    _, a0 = switch_moe(*args, capacity_factor=2.0)
    _, a1 = switch_moe(*args, capacity_factor=2.0, z_loss_weight=1e-2)
    assert float(a1) > float(a0)


def test_router_jitter_training_only():
    """No jitter outside training (eval mode, or no gradients); in
    training the output moves, and one generator state repeats it."""
    torch.manual_seed(25)
    gen = torch.Generator().manual_seed(1)
    blk = SwitchMoE(4, 8, 4, capacity_factor=4.0, router_jitter=0.2,
                    generator=gen, device="cpu")
    x = _t(np.random.RandomState(25).randn(3, 2, 4).astype("f"))
    blk.eval()
    plain = blk(x).detach()
    assert torch.equal(blk(x).detach(), plain)
    blk.train()
    with torch.no_grad():
        assert torch.equal(blk(x), plain)
    state = gen.get_state()
    tr1 = blk(x).detach()
    tr2 = blk(x).detach()
    assert float((tr1 - tr2).abs().max()) > 0
    gen.set_state(state)
    assert torch.equal(blk(x).detach(), tr1)
    # the op alone: jitter only with training=True
    args = (x, blk.router_weight, blk.experts_w1, blk.experts_w2)
    y0, _ = switch_moe(*args, capacity_factor=4.0, router_jitter=0.2)
    assert torch.equal(y0.detach(), plain)


def test_scale_pin_dispatch_and_drop_rate():
    rng = np.random.RandomState(26)
    S, d, h, E = 1024, 16, 32, 8
    args = [_t(rng.randn(S, d).astype("f")),
            _t(rng.randn(E, d).astype("f") * 0.05),
            _t(rng.randn(E, d, h).astype("f") * 0.1),
            _t(rng.randn(E, h, d).astype("f") * 0.1)]

    def drop_rate(cf, k=1):
        y, _ = switch_moe(*args, capacity_factor=cf, top_k=k)
        return float((y.abs().sum(-1) < 1e-9).float().mean())

    assert drop_rate(1.0) < 0.40
    assert drop_rate(2.0) < 0.05
    assert drop_rate(1.0, k=2) < 0.25


def test_moe_prefill_matches_per_token_steps():
    torch.manual_seed(51)
    lm = TransformerLM(40, 16, 32, 2, 4, 2, device="cpu", **MOE)
    ids = _t(np.random.RandomState(52).randint(0, 40, (2, 5)))
    full = lm(ids).detach().numpy()
    logits = lm.prefill(ids, lm.init_cache(2, 5))
    np.testing.assert_allclose(logits.numpy(), full, rtol=2e-4, atol=2e-5)
    assert lm.generate(ids, 3).shape == (2, 8)


def test_prefill_forward_budgets_from_total_len():
    """A two-token chunk of a 16-token prompt keeps what the unbounded
    decode keeps; the chunk-local budget drops; total_len < T raises
    (the reference's tests/test_serving.py:251)."""
    torch.manual_seed(47)
    moe = SwitchMoE(8, 16, 4, capacity_factor=1.0, device="cpu")
    with torch.no_grad():
        moe.router_weight.zero_()
    x = _t(np.random.RandomState(2).randn(1, 2, 8).astype("f"))
    with torch.no_grad():
        kept = moe.prefill_forward(x, total_len=16)
        unbounded = moe.decode_forward(x)
        dropped = moe.prefill_forward(x)
    np.testing.assert_allclose(kept.numpy(), unbounded.numpy(), rtol=1e-6)
    assert float((dropped - unbounded).abs().max()) > 1e-4
    with pytest.raises(ValueError):
        moe.prefill_forward(x, total_len=1)
