"""The port's Switch mixture-of-experts models (``MoEDecoderLayer``,
``TransformerLM(num_experts=)``) and their training held against the
JAX reference on the CPU, with the reference's weights carried across by
``load_mxtpu_params``.

Tolerances, float32 on both sides:

- logits and aux within 1e-4; each layer form (prefill with
  ``total_len``, the slot step and window, the paged step and window,
  chunked paged prefill) within 1e-4; greedy streams token-identical;
  export then load bit for bit; ``quantize_weights``' choice of layers,
  payloads and scales bit for bit;
- ``SPMDTrainer``: a tuple-returning model with a plain loss trains on
  its logits in both frameworks (losses within 1e-4 relative); three
  Adam steps with ``NextTokenLoss(moe_aux_weight=0.01)``, losses within
  1e-4 relative and every weight within 1e-5."""

import jax
import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import gluon, nd
from mxtpu.contrib import quantization as jq
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.parallel import SPMDTrainer as JaxTrainer, make_mesh
from mxtpu_torch import base
from mxtpu_torch.contrib import quantization as q
from mxtpu_torch.models.convert import (export_mxtpu_params,
                                        load_mxtpu_params, mxtpu_name,
                                        strip_instance_prefix)
from mxtpu_torch.models.moe import moe_sharding_rules
from mxtpu_torch.models.transformer import (TransformerLM, llama_3_8b,
                                            llama_tiny)
from mxtpu_torch.optimizer import Adam
from mxtpu_torch.parallel.trainer import (NextTokenLoss, SPMDTrainer,
                                          synthetic_batches)

SPEC = (40, 16, 32, 2, 4, 2)          # vocab, units, hidden, layers, heads, kv
MOE = dict(num_experts=4, capacity_factor=4.0)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _ref_params(ref):
    return {k: v.data().asnumpy() for k, v in ref.collect_params().items()}


def _ref_lm(seed=9, spec=SPEC, **kw):
    mx.random.seed(seed)
    ref = JaxLM(*spec[:5], num_kv_heads=spec[5], **dict(MOE, **kw))
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    return ref


def _port_lm(params, spec=SPEC, **kw):
    port = TransformerLM(*spec, device="cpu", **dict(MOE, **kw))
    load_mxtpu_params(port, params)
    return port


@pytest.fixture(scope="module")
def lms():
    ref = _ref_lm()
    return ref, _port_lm(_ref_params(ref))


# -- the blocks and the model against the reference ----------------------------

def test_parameters_names_shapes_and_xavier_fans(lms):
    torch.manual_seed(0)
    m = llama_tiny(vocab_size=50, device="cpu", num_experts=3)
    names = {mxtpu_name(n): tuple(p.shape) for n, p in m.named_parameters()}
    assert names["layer1_moe_router_weight"] == (3, 64)
    assert names["layer1_moe_experts_w1"] == (3, 64, 172)
    assert names["layer1_moe_experts_w2"] == (3, 172, 64)
    assert not any("gate" in n for n in names)
    assert sorted(mxtpu_name(n) for n, _ in lms[1].named_parameters()) == \
        sorted(strip_instance_prefix(k) for k in _ref_params(lms[0]))
    # Xavier avg with the reference's fans: fan_in = d*h, fan_out = E*h
    w1 = m.layers[0].moe.experts_w1
    bound = (3.0 / ((64 * 172 + 3 * 172) / 2.0)) ** 0.5
    assert 0.9 * bound < float(w1.detach().abs().max()) <= bound
    assert llama_3_8b(device="meta", num_experts=8, depth_factor=1 / 32,
                      width_factor=0.125).layers[0].moe.num_experts == 8


def test_model_logits_aux_and_generate_match_the_reference():
    """Logits within 1e-4; ``return_moe_aux`` gives (logits, aux) with
    aux within 1e-4; greedy generate token-identical."""
    ref = _ref_lm(seed=12, return_moe_aux=True)
    params = _ref_params(ref)
    port = _port_lm(params, return_moe_aux=True)
    ids = np.random.RandomState(8).randint(0, 40, (2, 7)).astype(np.int32)
    rl, raux = ref(nd.array(ids, dtype="int32"))
    pl, paux = port(_t(ids))
    np.testing.assert_allclose(pl.detach().numpy(), rl.asnumpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(paux.detach()), float(raux.asnumpy()),
                               rtol=1e-4)
    plain = _port_lm(params)
    assert not isinstance(plain(_t(ids)), tuple)
    p = np.random.RandomState(30).randint(0, 40, (3, 9))
    want = ref.generate(nd.array(p, dtype="int32"), 8).asnumpy()
    np.testing.assert_array_equal(plain.generate(_t(p), 8).numpy(), want)


def _ref_pools(ref, N, bs):
    return ref.init_block_pool(N, bs)


def test_every_layer_form_matches_the_reference(lms):
    """Through the model's forms, which call each layer's: prefill with
    ``total_len``, the slot step and window, the paged step and window,
    and chunked paged prefill with ``total_len``."""
    ref, port = lms
    rng = np.random.RandomState(14)
    B, Tp, L = 2, 6, 16
    prompt = rng.randint(0, 40, (B, Tp)).astype(np.int32)
    # prefill: a 3-token chunk budgeting from a 9-token prompt
    rl, rc = ref.prefill(nd.array(prompt[:, :3], dtype="int32"),
                         ref.init_cache(B, L), total_len=9)
    caches = port.init_cache(B, L)
    pl = port.prefill(_t(prompt[:, :3]).long(), caches, total_len=9)
    np.testing.assert_allclose(pl.numpy(), rl.asnumpy(), rtol=1e-4,
                               atol=1e-4)
    # the slot forms over a cache holding the whole prompt
    _, rc = ref.prefill(nd.array(prompt, dtype="int32"), ref.init_cache(B, L))
    caches = port.init_cache(B, L)
    port.prefill(_t(prompt).long(), caches)
    pos = np.array([Tp, Tp], np.int32)
    tok = rng.randint(0, 40, (B, 1)).astype(np.int32)
    rl, rc2 = ref.step_slots(nd.array(tok, dtype="int32"), rc,
                             nd.array(pos, dtype="int32"))
    pl = port.step_slots(_t(tok).long(), caches, _t(pos))
    np.testing.assert_allclose(pl.numpy(), rl.asnumpy(), rtol=1e-4,
                               atol=1e-4)
    win = rng.randint(0, 40, (B, 3)).astype(np.int32)
    vl = np.array([3, 2], np.int32)
    rl, _ = ref.verify_slots(nd.array(win, dtype="int32"), rc2,
                             nd.array(pos + 1, dtype="int32"),
                             nd.array(vl, dtype="int32"))
    pl = port.verify_slots(_t(win).long(), caches, _t(pos + 1), _t(vl))
    np.testing.assert_allclose(pl.numpy(), rl.asnumpy(), rtol=1e-4,
                               atol=1e-4)
    # the paged forms: prompt row 0 in two chunks (total_len = Tp), then
    # a step and a window of both rows
    bs, N, M = 4, 12, 5
    tables = np.zeros((B, M), np.int32)
    tables[0, :4] = [3, 1, 7, 2]
    tables[1, :4] = [5, 9, 4, 8]
    rpools = _ref_pools(ref, N, bs)
    ppools = port.init_block_pool(N, bs)
    for b in range(B):
        for start, T in ((0, 3), (3, 3)):
            chunk = prompt[b:b + 1, start:start + T]
            rl, rpools = ref.prefill_pages(
                nd.array(chunk, dtype="int32"), rpools,
                nd.array(tables[b], dtype="int32"), start, total_len=Tp)
            pl = port.prefill_pages(_t(chunk).long(), ppools,
                                    _t(tables[b]), start, total_len=Tp)
            np.testing.assert_allclose(pl.numpy(), rl.asnumpy(), rtol=1e-4,
                                       atol=1e-4)
    rl, rpools = ref.step_pages(nd.array(tok, dtype="int32"), rpools,
                                nd.array(tables, dtype="int32"),
                                nd.array(pos, dtype="int32"))
    pl = port.step_pages(_t(tok).long(), ppools, _t(tables), _t(pos))
    np.testing.assert_allclose(pl.numpy(), rl.asnumpy(), rtol=1e-4,
                               atol=1e-4)
    rl, _ = ref.verify_pages(nd.array(win, dtype="int32"), rpools,
                             nd.array(tables, dtype="int32"),
                             nd.array(pos + 1, dtype="int32"),
                             nd.array(vl, dtype="int32"))
    pl = port.verify_pages(_t(win).long(), ppools, _t(tables), _t(pos + 1),
                           _t(vl))
    np.testing.assert_allclose(pl.numpy(), rl.asnumpy(), rtol=1e-4,
                               atol=1e-4)


def test_decode_forms_normalize_with_g2(lms):
    """The routed FFN's norm in every decode form is ``rows_rms_norm``
    (one call a layer), prefill's the module."""
    port = lms[1]
    caches = port.init_cache(1, 8)
    ids = torch.tensor([[1, 2, 3]])
    base.reset_counts()
    port.prefill(ids, caches)
    assert base.count("rows_rms_norm") == 0
    port.step(torch.tensor([[4]]), caches, 3)
    assert base.count("rows_rms_norm") == len(port.layers)
    port.step_slots(torch.tensor([[5]]), caches, torch.tensor([4]))
    assert base.count("rows_rms_norm") == 2 * len(port.layers)


def test_export_load_round_trip_is_bit_for_bit(lms):
    port = lms[1]
    out = export_mxtpu_params(port)
    assert out["layer0_moe_experts_w1"].shape == (4, 16, 32)
    again = _port_lm(out)
    for (n, p), (_, p2) in zip(port.named_parameters(),
                               again.named_parameters()):
        assert torch.equal(p, p2), n
    ref_names = {strip_instance_prefix(k): v
                 for k, v in _ref_params(lms[0]).items()}
    for name, arr in out.items():
        np.testing.assert_array_equal(arr, ref_names[name])


def test_page_round_trip_on_a_routed_model(lms):
    """``read_pages``/``write_pages`` of an MoE model's pools: pages
    written back land as they were read."""
    port = lms[1]
    pools = port.init_block_pool(6, 4)
    table = torch.tensor([2, 4, 0, 0, 0], dtype=torch.int32)
    port.prefill_pages(torch.tensor([[3, 9, 1, 7, 5, 2]]), pools, table, 0)
    host = port.read_pages(pools, [2, 4])
    fresh = port.init_block_pool(6, 4)
    port.write_pages(fresh, [1, 3], host)
    for (k, v), (k2, v2) in zip(pools, fresh):
        assert torch.equal(k[[2, 4]], k2[[1, 3]])
        assert torch.equal(v[[2, 4]], v2[[1, 3]])


@pytest.mark.parametrize("bits,gs", [(8, 64), (4, 16)], ids=["int8",
                                                            "int4-g16"])
def test_quantize_weights_chooses_the_references_layers(bits, gs):
    """qkv, out_proj and the head are quantized; the router and the
    experts stay float; payloads and scales equal the reference's."""
    ref = _ref_lm(seed=15)
    params = _ref_params(ref)
    names = jq.quantize_weights(ref, bits=bits, group_size=gs)
    port = _port_lm(params)
    got = q.quantize_weights(port, bits=bits, group_size=gs)
    want = sorted(strip_instance_prefix(n) for n in names.quantized_params)
    assert sorted(got) == want
    assert len(got) == 2 * len(port.layers) + 1
    assert not any("moe" in n for n in got)
    exported = export_mxtpu_params(port)
    for k, v in _ref_params(ref).items():
        np.testing.assert_array_equal(exported[strip_instance_prefix(k)], v,
                                      err_msg=k)
    assert port.layers[0].moe.experts_w1.dtype == torch.float32
    ids = np.random.RandomState(5).randint(0, 40, (1, 6)).astype(np.int32)
    want = ref.generate(nd.array(ids, dtype="int32"), 5).asnumpy()
    np.testing.assert_array_equal(port.generate(_t(ids), 5).numpy(), want)


def test_moe_sharding_rules_put_the_experts_on_ep():
    rules = moe_sharding_rules()
    assert rules.spec_for("layer0_moe_experts_w1", 3) == ("ep", None, None)
    assert rules.spec_for("layer0_moe_experts_w2", 3) == ("ep", None, None)
    assert tuple(rules.spec_for("layer0_moe_router_weight", 2)) == ()
    from mxtpu_torch.models.transformer import transformer_lm_sharding_rules

    both = moe_sharding_rules(transformer_lm_sharding_rules())
    assert both.spec_for("layer0_attn_qkv_weight", 2) == ("tp", None)
    assert len(both) == 2 + len(transformer_lm_sharding_rules())


# -- SPMDTrainer ----------------------------------------------------------------

class _PlainRefLoss:
    """A loss without ``accepts_full_output``: it reads logits only."""

    def __init__(self):
        self._ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def __call__(self, logits, labels):
        return self._ce(logits[:, :-1].reshape((-1, logits.shape[-1])),
                        labels[:, 1:].reshape((-1,)))


class _PlainLoss:
    def __init__(self):
        from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

        self._ce = SoftmaxCrossEntropyLoss()

    def __call__(self, logits, labels):
        return self._ce(logits[:, :-1].reshape(-1, logits.shape[-1]),
                        labels[:, 1:].reshape(-1))


def _ref_next_token_loss(aux_weight):
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parent.parent / "examples" /
            "parallel" / "llama_train.py")
    spec = importlib.util.spec_from_file_location("llama_train_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.NextTokenLoss(moe_aux_weight=aux_weight)


def _train(loss_pair, steps, lr=1e-3, seed=31):
    """The reference's and the port's SPMDTrainer (Adam) on the same
    weights and batches; their losses, trained weights and the port's
    first-step gradients."""
    ref = _ref_lm(seed=seed, return_moe_aux=True)
    params = _ref_params(ref)
    port = _port_lm(params, return_moe_aux=True)
    batches = list(synthetic_batches(2, 12, steps, vocab=40, seed=4))
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    jt = JaxTrainer(ref, loss_pair[0], "adam", mesh,
                    optimizer_params={"learning_rate": lr})
    pt = SPMDTrainer(port, loss_pair[1], "adam", {"learning_rate": lr})
    ref_losses = [float(jt.step(nd.array(b, dtype="int32"),
                                nd.array(b, dtype="int32")).asnumpy())
                  for b in batches]
    grads = {}
    losses = []
    for i, b in enumerate(batches):
        if i == 0:
            out = port(_t(b))
            loss_pair[1](out if getattr(loss_pair[1], "accepts_full_output",
                                        False) else out[0],
                         _t(b)).mean().backward()
            grads = {mxtpu_name(n): p.grad.clone()
                     for n, p in port.named_parameters()}
            port.zero_grad(set_to_none=True)
        losses.append(float(pt.step(b, b)))
    ref_trained = {strip_instance_prefix(k): v.data().asnumpy()
                   for k, v in ref.collect_params().items()}
    return ref_losses, losses, ref_trained, export_mxtpu_params(port), grads


def test_trainer_hands_a_plain_loss_the_first_output():
    """A tuple-returning model and a loss without
    ``accepts_full_output``: both trainers train on the logits alone,
    with equal losses (the port's trainer used to hand the loss the
    whole tuple)."""
    ref_losses, losses, _, _, _ = _train((_PlainRefLoss(), _PlainLoss()), 2)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_three_adam_steps_with_the_aux_loss_match_the_reference():
    ref_losses, losses, ref_trained, trained, grads = _train(
        (_ref_next_token_loss(0.01), NextTokenLoss(moe_aux_weight=0.01)), 3)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    for name, want in ref_trained.items():
        np.testing.assert_allclose(trained[name], want, rtol=0, atol=1e-5,
                                   err_msg=name)
    assert float(grads["layer0_moe_router_weight"].abs().sum()) > 0


def test_next_token_loss_adds_the_weighted_aux():
    logits = torch.randn(2, 5, 7, generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 7, (2, 5),
                           generator=torch.Generator().manual_seed(1))
    aux = torch.tensor(1.5)
    plain = NextTokenLoss()(logits, labels)
    assert torch.equal(NextTokenLoss()((logits, aux), labels), plain)
    torch.testing.assert_close(
        NextTokenLoss(moe_aux_weight=0.01)((logits, aux), labels),
        plain + 0.015)
    assert NextTokenLoss.accepts_full_output is True
    assert isinstance(SPMDTrainer(torch.nn.Linear(2, 2), NextTokenLoss(),
                                  Adam()), SPMDTrainer)
