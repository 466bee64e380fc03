"""The port's mesh, sharding rules, collectives and weight-only
quantization under tensor parallelism, held against the reference.

- ``DeviceMesh``/``make_mesh`` and ``ShardingRules`` on one rank (no
  world): the reference's defaults, first-match rules and errors.
- ``parallel.collectives`` in a gloo world of four CPU ranks against the
  reference's verbs inside ``shard_map`` on four forced CPU devices.
- ``quantize_weights(bits=8 and 4, rules=...)`` at tp=2: the returned
  rules are the reference's, each rank's payloads and scales are the
  slice of the reference's whole ones bit for bit (the slices written
  out here independently of ``ShardingRules.local``), and greedy
  ``generate`` equals the reference's tp=2 decoder's and the port's
  tp=1 one (the reference's ``test_quantized_weights_tp_parity``).
- The refusals: a KV count the tp axis does not divide (the reference's
  text), a ``cache_spec`` other than the head split, an int4 group that
  straddles a shard.
- Speculative streams equal plain ones bit for bit at tp=4 (a model of 4
  KV heads), over float32 and int8 pools.
"""

import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu import nd
from mxtpu.contrib.quantization import quantize_weights as jax_quantize
from mxtpu.models.transformer import TransformerLM as JaxLM
from mxtpu.models.transformer import \
    transformer_lm_sharding_rules as jax_rules
from mxtpu.ops.pallas.partition import head_shard_map
from mxtpu.parallel import ShardedDecoder as JaxDecoder, make_mesh
from mxtpu.parallel import collectives as jax_collectives
from mxtpu_torch.base import MXTPUError
from mxtpu_torch.contrib.quantization import quantize_weights
from mxtpu_torch.models.transformer import transformer_lm_sharding_rules
from mxtpu_torch.parallel.decode import ShardedDecoder
from mxtpu_torch.parallel.mesh import (DeviceMesh, init_process_group,
                                       make_mesh as port_make_mesh)
from mxtpu_torch.parallel.sharding import PartitionSpec, ShardingRules

import torch_tp_world as world

SPEC = (64, 64, 128, 2, 4, 2)         # vocab, units, hidden, layers, H, KV
QUANT = ((8, 64), (4, 32))             # (bits, group size)
MAXLEN = 32


def _params(block):
    return {k.split("_", 1)[1]: v.data().asnumpy()
            for k, v in block.collect_params().items()}


def _jax_model(seed):
    mx.random.seed(seed)
    ref = JaxLM(SPEC[0], units=SPEC[1], hidden_size=SPEC[2],
                num_layers=SPEC[3], num_heads=SPEC[4], num_kv_heads=SPEC[5])
    ref.initialize()
    ref(nd.array(np.zeros((1, 2)), dtype="int32"))   # finish deferred init
    return ref


# -- one rank: the mesh and the rules ---------------------------------------

def test_one_rank_mesh_keeps_the_reference_axes_and_defaults():
    m = port_make_mesh()
    assert m.axis_names == ("dp", "pp", "ep", "sp", "tp")
    assert m.axis_sizes == dict(dp=1, pp=1, ep=1, sp=1, tp=1)
    assert m.num_devices == 1 and m.rank == 0 and m.coord("tp") == 0
    assert repr(m) == "DeviceMesh(dp=1, pp=1, ep=1, sp=1, tp=1)"
    with pytest.raises(MXTPUError, match="world of 2 ranks"):
        DeviceMesh(tp=2)
    with pytest.raises(MXTPUError, match="no process group"):
        m.group("tp")
    with pytest.raises(MXTPUError, match="DMLC_NUM_WORKER"):
        init_process_group()


def test_rules_read_as_the_reference_and_first_match_wins():
    port, ref = transformer_lm_sharding_rules(), jax_rules()
    assert [(p, tuple(s)) for p, s in port.iter_rules()] == \
        [(p, tuple(s)) for p, s in ref.iter_rules()]
    for name in ("layer0_attn_qkv_weight", "layer1_down_weight",
                 "embed_weight", "lm_head_weight", "norm_weight"):
        assert port.first_match(name) == ref.first_match(name)
        assert tuple(port.spec_for(name, 2)) == tuple(ref.spec_for(name, 2))
    rules = ShardingRules([(r"a$", PartitionSpec("tp", None, None))])
    with pytest.raises(ValueError, match="more axes"):
        rules.spec_for("a", 2)
    rules.extend(ShardingRules([(r"a$", PartitionSpec("tp"))]))
    assert rules.first_match("xa") == 0 and len(rules) == 2


def test_quantize_weights_rules_are_the_references():
    """The scale rules ride along as the reference adds them: exact
    names, the weight's output split, int4's group axis whole."""
    for bits, gs in QUANT:
        ref = _jax_model(9)
        want = jax_quantize(ref, bits=bits, group_size=gs, rules=jax_rules())
        port = world.model_from(SPEC, _params(_jax_model(9)))
        got = quantize_weights(port, bits=bits, group_size=gs,
                               rules=transformer_lm_sharding_rules())
        assert len(got.quantized_params) == len(want.quantized_params)
        w = [(p.split("_", 1)[1] if "wscale" in p else p, tuple(s))
             for p, s in want.iter_rules()]
        assert [(p, tuple(s)) for p, s in got.iter_rules()] == w


# -- the collectives --------------------------------------------------------------

@pytest.fixture(scope="module")
def tp4_collectives(tmp_path_factory):
    rng = np.random.RandomState(0)
    payload = dict(x=rng.normal(size=(4, 4, 6)).astype(np.float32),
                   perm=[(i, (i + 1) % 4) for i in range(4)])
    got = world.run_world(4, "collectives_world",
                          tmp_path_factory.mktemp("coll"), payload)
    return payload, got


@pytest.mark.parametrize("verb", [
    "all_reduce_sum", "all_reduce_mean", "all_reduce_max", "all_reduce_min",
    "all_gather0", "all_gather1", "all_gather_stacked", "reduce_scatter",
    "ppermute", "all_to_all"])
def test_collectives_against_the_references_inside_shard_map(
        tp4_collectives, verb):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    payload, got = tp4_collectives
    C = jax_collectives
    fns = {
        "all_reduce_sum": lambda x: C.all_reduce(x, "tp", "sum"),
        "all_reduce_mean": lambda x: C.all_reduce(x, "tp", "mean"),
        "all_reduce_max": lambda x: C.all_reduce(x, "tp", "max"),
        "all_reduce_min": lambda x: C.all_reduce(x, "tp", "min"),
        "all_gather0": lambda x: C.all_gather(x, "tp", 0),
        "all_gather1": lambda x: C.all_gather(x, "tp", 1),
        "all_gather_stacked": lambda x: C.all_gather(x, "tp", 0,
                                                     tiled=False),
        "reduce_scatter": lambda x: C.reduce_scatter(x, "tp", 0),
        "ppermute": lambda x: C.ppermute(x, "tp", payload["perm"]),
        "all_to_all": lambda x: C.all_to_all(x, "tp", 0, 1),
    }
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("tp",))
    f = head_shard_map(fns[verb], mesh, P("tp"), P("tp"))
    want = np.split(np.asarray(f(np.concatenate(payload["x"]))), 4)
    for r in range(4):
        np.testing.assert_allclose(got[r][verb], want[r], rtol=1e-6,
                                   atol=1e-6)


def test_bf16_all_reduce_sums_in_rank_order_in_float32_and_broadcast(
        tp4_collectives):
    payload, got = tp4_collectives
    parts = [torch.from_numpy(x).bfloat16().float() for x in payload["x"]]
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    want = acc.bfloat16().float().numpy()
    for r in range(4):
        np.testing.assert_array_equal(got[r]["all_reduce_bf16"], want)
        np.testing.assert_array_equal(got[r]["broadcast"], payload["x"][1])


# -- quantize_weights(rules=) and the refusals at tp=2 ------------------------

@pytest.fixture(scope="module")
def quant_world(tmp_path_factory):
    rng = np.random.RandomState(4)
    greedy = [(rng.randint(0, SPEC[0], (1, t)).astype(np.int32), n, {})
              for t, n in ((7, 4), (5, 6))]
    payload = dict(spec=SPEC, params=_params(_jax_model(9)), quant=QUANT,
                   greedy=greedy, kv1_spec=(50, 32, 64, 1, 2, 1))
    got = world.run_world(2, "quantized", tmp_path_factory.mktemp("q"),
                          payload)
    return payload, got


def _expected_slice(name, full, r, n, bits):
    """The slice rank r of n holds, written out for the decoder's layout:
    qkv rows by head group, column-parallel rows, row-parallel input
    columns (an int4 weight's scales cut by group with them), the
    embedding's hidden columns, everything else whole."""
    H, KV, D = SPEC[4], SPEC[5], SPEC[1] // SPEC[4]

    def rows(a):
        return np.split(a, n, axis=0)[r]

    def cols(a):
        return np.split(a, n, axis=1)[r]

    if "attn_qkv" in name:
        q, k, v = np.split(full, [H * D, (H + KV) * D], axis=0)
        return np.concatenate([rows(q), rows(k), rows(v)], 0)
    if any(s in name for s in ("gate_", "up_", "lm_head_")):
        return rows(full)
    if "attn_out_" in name or "down_" in name:
        if name.endswith("wscale"):
            return full if bits == 8 else cols(full)
        return cols(full)
    if name == "embed_weight":
        return cols(full)
    return full


def test_quantized_payloads_and_scales_are_the_references_slices(
        quant_world):
    payload, got = quant_world
    for bits, gs in QUANT:
        ref = _jax_model(9)
        jax_quantize(ref, bits=bits, group_size=gs, rules=jax_rules())
        full = _params(ref)
        for r in range(2):
            local = got[r]["local"][bits]
            assert set(local) == set(full)
            for name, arr in full.items():
                want = _expected_slice(name, arr, r, 2, bits)
                np.testing.assert_array_equal(local[name], want,
                                              err_msg="%s int%d" % (name,
                                                                    bits))


class _Coords:
    """A stand-in for rank r of a tp=n mesh (sizes and coordinates)."""

    def __init__(self, r, n):
        self.r, self.n = r, n

    def size(self, axis):
        return self.n if axis == "tp" else 1

    def coord(self, axis):
        return self.r if axis == "tp" else 0


@pytest.mark.parametrize("bits,gs", QUANT, ids=["int8", "int4"])
def test_shard_params_slices_as_written_out(bits, gs):
    """``ShardingRules.shard_params`` on the whole quantized arrays, by
    the rules ``quantize_weights`` returned, with the fused qkv's row
    groups: rank r's slices are the ones written out here."""
    ref = _jax_model(9)
    jax_quantize(ref, bits=bits, group_size=gs, rules=jax_rules())
    full = _params(ref)
    port = world.model_from(SPEC, _params(_jax_model(9)))
    rules = quantize_weights(port, bits=bits, group_size=gs,
                             rules=transformer_lm_sharding_rules())
    for r in range(2):
        got = rules.shard_params(full, _Coords(r, 2),
                                 groups=port._fused_groups())
        for name, arr in full.items():
            np.testing.assert_array_equal(
                got[name].numpy(), _expected_slice(name, arr, r, 2, bits))


def test_quantized_weights_tp_parity(quant_world):
    """The reference's test: tp=2 greedy decode of a weight-quantized
    model emits the tokens of the single-rank run (the port's own, and
    the reference's tp=2 decoder's)."""
    payload, got = quant_world
    mesh = make_mesh(dp=1, tp=2)
    for bits, gs in QUANT:
        ref = _jax_model(9)
        rules = jax_quantize(ref, bits=bits, group_size=gs,
                             rules=jax_rules())
        jdec = JaxDecoder(ref, mesh, rules)
        port = world.model_from(SPEC, payload["params"])
        prules = quantize_weights(port, bits=bits, group_size=gs,
                                  rules=transformer_lm_sharding_rules())
        one = ShardedDecoder(port, DeviceMesh(), prules)
        for (p, n, _), two in zip(payload["greedy"],
                                  got[0]["rank0"]["generate%d" % bits]):
            want = jdec.generate(nd.array(p, dtype="int32"),
                                 max_new_tokens=n,
                                 max_length=MAXLEN).asnumpy()
            np.testing.assert_array_equal(two, want)
            np.testing.assert_array_equal(
                one.generate(torch.from_numpy(p), n).numpy(), two)


def test_refusals_name_their_constraint(quant_world):
    errors = quant_world[1][0]["rank0"]["errors"]
    kind, msg = errors["kv"]
    assert kind == "ValueError" and "splits the 1 kv heads" in msg \
        and "does not divide" in msg
    kind, msg = errors["cache_spec"]
    assert kind == "MXTPUError" and "A6" in msg
    kind, msg = errors["int4_group"]
    assert kind == "MXTPUError" and "straddle" in msg \
        and "attn_out_weight" in msg


# -- speculation at tp=4 -----------------------------------------------------------

@pytest.fixture(scope="module")
def tp4_spec(tmp_path_factory):
    reqs = [(np.array([[1, 2, 3, 1, 2, 4, 1, 2, 3, 1, 2]], np.int32), 16, {}),
            (np.array([[5, 6, 7, 5, 6, 8, 5, 6, 7, 5, 6]], np.int32), 14,
             dict(temperature=0.8, seed=7)),
            (np.array([[9, 3, 2, 9, 3, 5, 9, 3, 2, 9, 3] * 2], np.int32), 12,
             dict(repetition_penalty=1.3))]
    payload = dict(spec=(20, 64, 128, 2, 8, 4), reqs=reqs,
                   engine=dict(num_slots=3, max_length=64, block_size=8,
                               prefill_chunk=8))
    return world.run_world(4, "speculative_tp4",
                           tmp_path_factory.mktemp("tp4"), payload)[0]


@pytest.mark.parametrize("cache", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("spec", ["linear", "tree"])
def test_speculative_equals_plain_bit_for_bit_at_tp4(tp4_spec, cache, spec):
    """Partial sums reduced in rank order whatever the buffer's length:
    a verify window's lanes round as the decode step's, so speculative
    streams equal plain ones at tp=4 too."""
    plain, got = tp4_spec[(cache, "plain")], tp4_spec[(cache, spec)]
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(a, b)
    assert tp4_spec[(cache, spec, "stats")]["verify_calls"] > 0
    assert tp4_spec[(cache, spec, "stats")]["blocks_in_use"] == 0
