"""Weight-only int8/int4 serving in the port (``mxtpu_torch.contrib.
quantization``; G3 and G4's plain versions in ``ops/linear.py``) held
against the JAX reference (``mxtpu/contrib/quantization.py``) on the CPU,
on the same numpy-seeded inputs and the same weights through the weight
bridge, and inside the port against its own ``generate``.

Against the reference: ``pack_int4``'s bytes; the payloads and scales of
``quantize_weights`` on ``llama_tiny`` bit for bit (int8, int4 at group
sizes 32 and 64); the plain ops within 1e-5 of the largest output of the
reference's float32 ops; a reference-quantized ``llama_tiny`` bridged
into the port: logits within 1e-4, greedy streams token-identical on the
parity prompts, the 11 quantized names, the int4 scales' shape, the
error on an uninitialized model.  In the port: int8-weight engine
streams over an int8 cache (greedy, seeded, shared prefix, chunked,
linear and tree speculation) equal ``generate``; ``wq_matmul`` picks
G3 or G4 by the shapes of the payload and scales and refuses shapes that
fit neither; export then load of a quantized model gives back its
tensors.  The kernels themselves run on
the card only (tests/test_torch_cuda.py, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.contrib import quantization as jq
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import llama_tiny as jax_llama_tiny
from mxtpu_torch import base
from mxtpu_torch.contrib import quantization as q
from mxtpu_torch.models.convert import (export_mxtpu_params,
                                        load_mxtpu_params,
                                        strip_instance_prefix)
from mxtpu_torch.models.transformer import TransformerLM, llama_tiny
from mxtpu_torch.ops import linear
from mxtpu_torch.ops.contrib import rms_norm
from mxtpu_torch.ops.tensor import _q8_quantize
from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

MAXLEN = 32
ENGINE = dict(num_slots=2, max_length=MAXLEN, block_size=8, prefill_chunk=8,
              cache_dtype="int8")
#: (bits, group size) of the cases
QUANT = [(8, 0), (4, 32), (4, 64)]
QIDS = ["int8", "int4-g32", "int4-g64"]


def _ref_params(ref):
    """The reference's parameters as its ``collect_params`` names them."""
    return {k: v.data().asnumpy() for k, v in ref.collect_params().items()}


def _ref_tiny(seed=3, vocab=50):
    mx.random.seed(seed)
    ref = jax_llama_tiny(vocab_size=vocab)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    return ref


def _port_quantized(params, bits, gs, vocab=50):
    """A port llama_tiny quantized like the reference, then given the
    reference's (quantized) parameters through the bridge."""
    port = llama_tiny(vocab_size=vocab, device="cpu")
    q.quantize_weights(port, bits=bits, group_size=gs or 64)
    return load_mxtpu_params(port, params)


@pytest.fixture(scope="module", params=QUANT, ids=QIDS)
def quantized(request):
    """The reference's llama_tiny (vocab 50, seed 3) quantized by its own
    quantize_weights, and the port's copy of it through the bridge."""
    bits, gs = request.param
    ref = _ref_tiny()
    float_params = _ref_params(ref)
    names = jq.quantize_weights(ref, bits=bits, group_size=gs or 64)
    params = _ref_params(ref)
    return dict(bits=bits, gs=gs, ref=ref, float_params=float_params,
                names=names.quantized_params, params=params,
                port=_port_quantized(params, bits, gs))


def test_pack_int4_bytes_and_round_trip_match_the_reference():
    rng = np.random.RandomState(0)
    v = rng.randint(-8, 8, (6, 10)).astype(np.int8)
    packed = q.pack_int4(v)
    assert packed.dtype == np.int8
    np.testing.assert_array_equal(packed, jq.pack_int4(v))
    np.testing.assert_array_equal(q.unpack_int4(packed), v)
    np.testing.assert_array_equal(q.unpack_int4(packed), jq.unpack_int4(
        packed))
    np.testing.assert_array_equal(
        linear.unpack_int4_torch(torch.from_numpy(packed)).numpy(), v)
    for n, g in ((172, 64), (64, 64), (96, 40), (7, 100)):
        assert q._i4_group(n, g) == jq._i4_group(n, g)


def test_quantize_weights_payloads_and_scales_equal_the_reference(quantized):
    """The port quantizes the reference's float weights itself (in
    float32 on the CPU) to the reference's payloads and scales, bit for
    bit; the embedding and the norms stay as they were."""
    port = llama_tiny(vocab_size=50, device="cpu")
    load_mxtpu_params(port, quantized["float_params"])
    names = q.quantize_weights(port, bits=quantized["bits"],
                               group_size=quantized["gs"] or 64)
    assert sorted(names) == sorted(strip_instance_prefix(n)
                                   for n in quantized["names"])
    got = export_mxtpu_params(port)
    want = {strip_instance_prefix(k): v
            for k, v in quantized["params"].items()}
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


@pytest.mark.parametrize("bits,gs", QUANT, ids=QIDS)
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_plain_ops_match_the_reference_ops(bits, gs, bias):
    """The plain G3 and G4 within 1e-5 of the largest output of the
    reference's float32 wq_matmul_i8 / wq_matmul_i4 (bias after the
    scale), on (3, 5, 128) x and a (48, 128) weight quantized by the
    reference."""
    rng = np.random.RandomState(bits + gs)
    w = (rng.randn(48, 128) * 0.05).astype(np.float32)
    x = rng.randn(3, 5, 128).astype(np.float32)
    b = rng.randn(48).astype(np.float32) if bias else None
    if bits == 8:
        s = np.maximum(np.abs(w).max(axis=1), 1e-8) / 127.0
        qw = np.clip(np.round(w / s[:, None]), -127, 127).astype(np.int8)
        want = nd.wq_matmul_i8(nd.array(x), nd.array(qw, dtype="int8"),
                               nd.array(s), None if b is None
                               else nd.array(b), no_bias=b is None)
        got = q.wq_matmul_i8(torch.from_numpy(x), torch.from_numpy(qw),
                             torch.from_numpy(s.astype(np.float32)),
                             None if b is None else torch.from_numpy(b))
    else:
        wg = w.reshape(48, 128 // gs, gs)
        s = np.maximum(np.abs(wg).max(axis=2), 1e-8) / 7.0
        qw = jq.pack_int4(np.clip(np.round(wg / s[..., None]), -7, 7)
                          .astype(np.int8).reshape(48, 128))
        want = nd.wq_matmul_i4(nd.array(x), nd.array(qw, dtype="int8"),
                               nd.array(s), None if b is None
                               else nd.array(b), no_bias=b is None,
                               group_size=gs, in_units=128)
        got = q.wq_matmul_i4(torch.from_numpy(x), torch.from_numpy(qw),
                             torch.from_numpy(s.astype(np.float32)),
                             None if b is None else torch.from_numpy(b),
                             group_size=gs, in_units=128)
    want = want.asnumpy()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    if bits == 8:
        # the projection then the cache's quantizer per 16-wide head,
        # against the reference's op
        pq, ps = q.wq_matmul_i8_q8(
            torch.from_numpy(x), torch.from_numpy(qw),
            torch.from_numpy(s.astype(np.float32)),
            None if b is None else torch.from_numpy(b), head_dim=16)
        wq_, ws_ = _q8_quantize(got.reshape(3, 5, 3, 16))
        assert torch.equal(pq, wq_.reshape(3, 5, 48))
        assert torch.equal(ps, ws_)
        jq8, js8 = nd.wq_matmul_i8_q8(
            nd.array(x), nd.array(qw, dtype="int8"), nd.array(s),
            None if b is None else nd.array(b), head_dim=16,
            no_bias=b is None)
        assert np.abs(pq.numpy().astype(np.int32)
                      - jq8.asnumpy().astype(np.int32)).max() <= 1
        np.testing.assert_allclose(ps.numpy(), js8.asnumpy(), rtol=1e-5)


def test_bridged_quantized_tiny_matches_reference_logits_and_streams(
        quantized):
    """A reference-quantized llama_tiny in the port: prefill logits
    within 1e-4 of the reference's, greedy streams token-identical on the
    parity prompts (tests/test_quantized_serving.py's)."""
    ref, port = quantized["ref"], quantized["port"]
    rng = np.random.RandomState(0)
    for t, n in ((5, 8), (11, 6)):
        p = rng.randint(0, 50, (1, t)).astype(np.int32)
        jl, _ = ref.prefill(nd.array(p, dtype="int32"),
                            ref.init_cache(1, MAXLEN))
        got = port.prefill(torch.from_numpy(p).long(),
                           port.init_cache(1, MAXLEN))
        np.testing.assert_allclose(got.numpy(), jl.asnumpy(), atol=1e-4,
                                   rtol=1e-4)
        want = ref.generate(nd.array(p, dtype="int32"), max_new_tokens=n,
                            max_length=MAXLEN).asnumpy()
        np.testing.assert_array_equal(
            port.generate(torch.from_numpy(p), n, max_length=MAXLEN).numpy(),
            want)


def test_quantize_weights_names_shapes_and_refusals():
    """11 quantized names on llama_tiny (qkv, out, gate, up, down a layer
    and lm_head); int4 at group 32 keeps the qkv weight packed (128, 32)
    with (128, 2) scales and the parameter names; the embedding stays
    float; a meta (uninitialized) model, rules= that are not
    ShardingRules and bits 3 raise."""
    port = llama_tiny(vocab_size=50, device="cpu")
    names = q.quantize_weights(port, bits=4, group_size=32)
    assert len(names) == 11 and "lm_head_weight" in names
    qkv = port.layers[0].attn.qkv
    assert isinstance(qkv, q.QuantizedLinear)
    assert qkv.weight.shape == (128, 32) and qkv.weight.dtype == torch.int8
    assert qkv.wscale.shape == (128, 2)
    assert port.embed.weight.dtype == torch.float32
    params = export_mxtpu_params(port)
    assert params["layer0_attn_qkv_weight"].dtype == np.int8
    assert params["layer0_attn_qkv_wscale"].shape == (128, 2)
    assert "embed_weight" in params and "embed_wscale" not in params
    meta = llama_tiny(vocab_size=50, device="meta")
    with pytest.raises(base.MXTPUError, match="uninitialized"):
        q.quantize_weights(meta, bits=8)
    with pytest.raises(base.MXTPUError, match="rules"):
        q.quantize_weights(llama_tiny(vocab_size=50, device="cpu"),
                           rules=object())
    with pytest.raises(base.MXTPUError, match="bits"):
        q.quantize_weights(llama_tiny(vocab_size=50, device="cpu"), bits=3)
    kept = llama_tiny(vocab_size=50, device="cpu")
    assert len(q.quantize_weights(kept, exclude=("lm_head",))) == 10
    assert type(kept.lm_head) is torch.nn.Linear


def test_export_then_load_gives_a_quantized_model_back(quantized):
    port = quantized["port"]
    params = export_mxtpu_params(port)
    again = _port_quantized(params, quantized["bits"], quantized["gs"])
    for (n1, a), (n2, b) in zip(port.named_parameters(),
                                again.named_parameters()):
        assert n1 == n2 and a.dtype == b.dtype and torch.equal(a, b), n1


def _int8_port(seed=3):
    ref = _ref_tiny(seed)
    jq.quantize_weights(ref, bits=8)
    return _port_quantized(_ref_params(ref), 8, 0)


@pytest.fixture(scope="module")
def int8_port():
    return _int8_port()


def _want(port, p, n, max_length=MAXLEN, **kw):
    return port.generate(torch.from_numpy(np.asarray(p)), n,
                         max_length=max_length, cache_dtype="int8",
                         **kw).numpy()


def test_int8_weights_int8_cache_engine_streams_equal_generate(int8_port):
    """Prefix sharing, chunked prefill and spec_k = 2 over int8 weights
    and an int8 cache: greedy, seeded-sampled and penalized streams
    equal int8 generate; every decode call of the engine took G3, its
    normed projections fused with their norm, never G1 or G2."""
    port = int8_port
    eng = PagedContinuousBatchingEngine(port, device="cpu", spec_k=2,
                                        **ENGINE)
    rng = np.random.RandomState(2)
    shared = rng.randint(0, 50, (1, 13))
    pa = np.concatenate([shared, rng.randint(0, 50, (1, 4))], 1)
    pb = np.concatenate([shared, rng.randint(0, 50, (1, 2))], 1)
    long = rng.randint(0, 50, (1, 17))       # 3 chunks at prefill_chunk=8
    sampled = rng.randint(0, 50, (1, 6))
    ra = eng.submit(pa, 5)
    eng.step()
    eng.step()
    rb = eng.submit(pb, 4)
    rc = eng.submit(long, 3)
    rd = eng.submit(sampled, 4, temperature=0.9, top_k=8, seed=21)
    re = eng.submit(pa, 6, repetition_penalty=1.4)
    calls = {"step": 0}
    inner_step, inner_verify = port.step_pages, port.verify_pages

    def step(*a, **kw):
        calls["step"] += 1
        return inner_step(*a, **kw)

    def verify(*a, **kw):
        calls["step"] += 1
        return inner_verify(*a, **kw)

    port.step_pages, port.verify_pages = step, verify
    try:
        base.reset_counts()
        res = eng.run()
        counts = base.counts()
    finally:
        del port.step_pages, port.verify_pages
    np.testing.assert_array_equal(res[ra].numpy(), _want(port, pa, 5))
    np.testing.assert_array_equal(res[rb].numpy(), _want(port, pb, 4))
    np.testing.assert_array_equal(res[rc].numpy(), _want(port, long, 3))
    np.testing.assert_array_equal(
        res[rd].numpy(),
        _want(port, sampled, 4, temperature=0.9, top_k=8, seed=21))
    np.testing.assert_array_equal(
        res[re].numpy(), _want(port, pa, 6, repetition_penalty=1.4))
    assert eng.stats["prefix_hit_requests"] >= 1
    assert eng.stats["blocks_in_use"] == 0
    L = len(port.layers)
    assert calls["step"] > 0
    assert counts[linear.I8_KERNEL_NAME] >= (5 * L + 1) * calls["step"]
    assert counts.get(linear.KERNEL_NAME, 0) == 0
    assert counts.get("rows_rms_norm", 0) == 0
    assert counts[linear.NORM_KERNEL_NAME] == (3 * L + 1) * calls["step"]


@pytest.fixture(scope="module")
def micro_int8():
    """The cycling micro-model of the speculative tests (seed 1, vocab
    20, 1 layer), quantized to int8 by the reference and bridged."""
    mx.random.seed(1)
    ref = JaxLM(20, units=32, hidden_size=64, num_layers=1, num_heads=4,
                num_kv_heads=2)
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))
    jq.quantize_weights(ref, bits=8)
    port = TransformerLM(20, 32, 64, 1, 4, 2, device="cpu")
    q.quantize_weights(port, bits=8)
    return load_mxtpu_params(port, _ref_params(ref))


REQS = [([1, 2, 3, 1, 2, 4, 1, 2, 3, 1, 2], 20, dict()),
        ([5, 6, 7, 5, 6, 8, 5, 6, 7, 5, 6], 20,
         dict(temperature=0.8, seed=7)),
        ([9, 3, 2, 9, 3, 5, 9, 3, 2, 9, 3], 18,
         dict(temperature=0.6, seed=9, repetition_penalty=1.3))]


@pytest.mark.parametrize("spec", [dict(spec_k=3), dict(spec_tree=(6, 2))],
                         ids=["linear", "tree"])
def test_int8_weights_speculative_streams_equal_plain_and_generate(
        micro_int8, spec):
    """The int8-weight micro-model over an int8 cache: greedy, sampled
    and penalized streams with linear or tree speculation equal the
    streams without it and int8 generate."""
    cfg = dict(ENGINE, num_slots=3, max_length=64)
    outs = {}
    for on in (False, True):
        eng = PagedContinuousBatchingEngine(micro_int8, device="cpu", **cfg,
                                            **(spec if on else {}))
        rids = [eng.submit(np.array([p], np.int32), n, **kw)
                for p, n, kw in REQS]
        res = eng.run()
        outs[on] = [res[r].numpy() for r in rids]
        assert eng.stats["blocks_in_use"] == 0
    assert eng.stats["verify_calls"] > 0
    for (p, n, kw), a, b in zip(REQS, outs[False], outs[True]):
        want = _want(micro_int8, [p], n, max_length=64, **kw)
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(b, want)


@pytest.mark.parametrize("bits,gs", QUANT, ids=QIDS)
@pytest.mark.parametrize("normed", [False, True], ids=["op", "normed"])
def test_wq_matmul_reads_the_weight_type_from_the_shapes(bits, gs, normed):
    """``ops.linear.wq_matmul`` picks G3 or G4 by the shapes of the
    payload and its scales: on the CPU it gives the bits of that type's
    plain op (of ``rms_norm(x, gamma)`` with a gain) and counts one
    launch of that kernel, and one of the fused norm with a gain."""
    rng = np.random.RandomState(bits + gs + 7)
    w = torch.from_numpy((rng.randn(48, 128) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.randn(2, 3, 128).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.3 * rng.randn(128)).astype(np.float32))
    qw, s = q.quantize_tensor(w, bits, gs or 64)
    base.reset_counts()
    got = linear.wq_matmul(x, qw, s, gamma if normed else None)
    xn = rms_norm(x, gamma, 1e-6) if normed else x
    want = (linear.wq_matmul_i8_plain(xn, qw, s) if bits == 8
            else linear.wq_matmul_i4_plain(xn, qw, s, gs, 128))
    assert got.shape == (2, 3, 48) and torch.equal(got, want)
    name = linear.I8_KERNEL_NAME if bits == 8 else linear.I4_KERNEL_NAME
    assert base.counts() == ({name: 1, linear.NORM_KERNEL_NAME: 1}
                             if normed else {name: 1})


def test_wq_matmul_refuses_shapes_that_fit_no_weight_type():
    """A payload and scales that fit neither G3 nor G4 raise, and so do
    the reference-signature ops given a type, group size or input width
    that the shapes deny; nothing is counted."""
    w = torch.randn(32, 96, generator=torch.Generator().manual_seed(5))
    q8, s8 = q.quantize_tensor(w, 8)
    q4, s4 = q.quantize_tensor(w, 4, 32)
    x = torch.randn(4, 96)
    base.reset_counts()
    for args in [(x, q8, s8[:16]), (x, q8, s8[:, None]), (x, q4, s8),
                 (x, q4, s4.t().contiguous()), (x[:, :90], q4, s4),
                 (x, q4, torch.ones(32, 5))]:
        with pytest.raises(base.MXTPUError, match="do not fit"):
            linear.wq_matmul(*args)
    with pytest.raises(base.MXTPUError):
        q.wq_matmul_i8(x, q4, s4)
    with pytest.raises(base.MXTPUError):
        q.wq_matmul_i4(x, q4, s4, group_size=64)
    with pytest.raises(base.MXTPUError):
        q.wq_matmul_i4(x, q4, s4, in_units=48)
    assert base.counts() == {}


#: Llama-3-8B's projections (N, K) and ragged shapes of the card tests
PLAN_SHAPES = [(6144, 4096), (4096, 4096), (14336, 4096), (4096, 14336),
               (128256, 4096), (130, 96), (4096, 576), (4096, 1024)]


#: (N, K, weight type, group size): every group size that divides K
PLAN_CASES = [(N, K, wt, gs) for N, K in PLAN_SHAPES
              for wt, gs in (("int8", 0), ("int4", 16), ("int4", 32),
                             ("int4", 64), ("int4", 128))
              if wt == "int8" or K % gs == 0]


@pytest.mark.parametrize("N,K,wtype,gs", PLAN_CASES,
                         ids=["%dx%d-%s-g%d" % c for c in PLAN_CASES])
def test_quantized_plan_keeps_splits_and_groups_at_every_row_count(
        N, K, wtype, gs):
    """G3's and G4's launch plan: the K splits tile K in order (int8 on
    whole 64-deep slices, as many as bf16's; int4 on whole groups), are
    the same at every row count and with the fused norm; every plan fits
    one block's shared memory with int4's scale slots in each stage, and
    its class keeps a lane's accumulators (int4: two sets) within the
    registers its block size leaves (255 a thread with one row of
    computing warps, 168 with two: at most 128 and 96 of them)."""
    ranges = linear.k_ranges(N, K, wtype, gs)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k1 > k0 for k0, k1 in ranges)
    if wtype == "int4":
        assert all(k0 % gs == 0 for k0, _ in ranges)
    else:
        assert len(ranges) == len(linear.k_ranges(N, K))
        assert all(k0 % 64 == 0 for k0, _ in ranges)
    top = 64 if wtype == "int4" else 128     # the largest class's rows
    for M in (1, 8, 9, 33, 64, 100, 128, 200, 1000):
        for norm in (False, True):
            p = linear.plan(M, N, K, norm, wtype, gs)
            assert p["splits"] == len(ranges)
            assert p["chunks"] * p["rows"] >= M
            assert min(M, top) <= p["rows"] <= top
            assert p["smem"] <= linear.MAX_SMEM_BYTES
            assert p["threads"] <= (12 if norm else 10) * 32
            stage = p["bn"] * (64 if wtype == "int8" else 32 + 16) \
                + p["rows"] * 128
            assert 2 <= p["stages"] and p["stages"] * stage <= p["smem"]
            # int4's scale area up to 32 rows: the tile's scales of a
            # split, whole 16-byte rows of groups, where they fit 16 KiB
            # (the 8B's shapes at group 64 all do)
            area = linear.scale_area(N, K, wtype, gs, p["bn"], p["rows"])
            groups = K // gs if wtype == "int4" else 0
            if area:
                assert groups % (4 * len(ranges)) == 0 and p["rows"] <= 32
                assert area == p["bn"] * groups // len(ranges) * 4 <= 16384
            if wtype == "int4" and gs == 64 and (N, K) in PLAN_SHAPES[:5]:
                assert bool(area) == (p["rows"] <= 32)
            warps = p["threads"] // 32 - 1 - (2 if norm and p["rows"] > 8
                                              else 0)
            warp_rows = warps // 4
            accs = (p["bn"] // 16 // 4) * (p["rows"] // warp_rows // 8) * 4
            accs *= 2 if wtype == "int4" else 1
            assert accs <= (128 if warp_rows == 1 else 96), p
