"""Gloo worlds of CPU ranks for the tensor-parallel tests of the port.

``run_world(n, scenario, tmp_path, payload)`` spawns ``n`` processes
(the spawn start method), joins them into a gloo world through a
``file://`` rendezvous under ``tmp_path`` (so parallel test workers never
race for a port), builds ``make_mesh(tp=n)`` and runs the function
``scenario`` of this module on every rank as ``scenario(rank, mesh,
payload)``; each rank's return value comes back pickled, in rank order.
Every collective waits at most ``timeout`` seconds, and so does the
join: a hung world fails its test instead of the suite.

This module imports only the port (``mxtpu_torch``), as the ranks do:
the reference arms of the tests run in the pytest process.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import torch

TIMEOUT_S = 120.0


def run_world(n, scenario, tmp_path, payload=None, timeout=TIMEOUT_S):
    """Run ``scenario`` on ``n`` spawned CPU ranks; their results in rank
    order.  Raises if a rank exits non-zero or outlives ``timeout``."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, n, tmp, scenario, timeout))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if alive or codes != [0] * n:
        raise RuntimeError("tp world %s: exit codes %r%s" % (
            scenario, codes, " (timed out)" if alive else ""))
    out = []
    for r in range(n):
        with open(os.path.join(tmp, "rank%d.pkl" % r), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank(rank, n, tmp, scenario, timeout):
    torch.set_num_threads(1)
    from mxtpu_torch.parallel.mesh import init_process_group, make_mesh

    init_process_group("file://" + os.path.join(tmp, "store"), n, rank,
                       timeout=timeout)
    mesh = make_mesh(tp=n)
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    result = globals()[scenario](rank, mesh, payload)
    with tempfile.NamedTemporaryFile("wb", dir=tmp, delete=False) as f:
        pickle.dump(result, f)
    os.replace(f.name, os.path.join(tmp, "rank%d.pkl" % rank))
    import torch.distributed as dist

    dist.destroy_process_group()


def controlled(rank, mesh, models, fn):
    """``fn()`` on rank 0, then the other ranks released; the other ranks
    follow rank 0 over ``models`` (in the order rank 0 first builds a
    decoder over each).  Rank 0's result, None elsewhere."""
    from mxtpu_torch.parallel.decode import ShardedDecoder

    if rank:
        ShardedDecoder.follow(mesh, *models)
        return None
    try:
        return fn()
    finally:
        ShardedDecoder.shutdown(mesh)


def model_from(spec, params=None, seed=None, **kw):
    """A CPU float32 port ``TransformerLM`` of ``spec`` (its constructor's
    arguments, and keywords ``kw``), loaded from the reference's
    ``params`` or filled from a numpy ``seed``."""
    from mxtpu_torch.models.convert import load_mxtpu_params
    from mxtpu_torch.models.transformer import TransformerLM

    model = TransformerLM(*spec, device="cpu", **kw)
    if params is not None:
        load_mxtpu_params(model, params)
    else:
        rng = np.random.RandomState(seed)
        with torch.no_grad():
            for name, p in sorted(model.named_parameters()):
                if not name.endswith("norm.weight"):
                    p.copy_(torch.from_numpy(
                        rng.normal(0, 0.2, p.shape).astype(np.float32)))
    return model


def streams(eng, reqs):
    """Submit ``(prompt, new tokens, submit kwargs)`` requests at once and
    drain: their streams as numpy arrays, in order."""
    rids = [eng.submit(p, n, **kw) for p, n, kw in reqs]
    res = eng.run()
    return [res[r].numpy() for r in rids]


def _row_of(eng, rid):
    for i, s in enumerate(eng._slots):
        if s is not None and s.req.rid == rid:
            return i
    raise AssertionError("rid %d holds no slot" % rid)


COUNTERS = ("drafted_tokens", "accepted_tokens", "verify_calls",
            "tree_nodes_drafted", "tree_paths", "slot_iterations", "steps")


# -- scenarios -----------------------------------------------------------------

def serving(rank, mesh, pl):
    """tp=2 over llama_tiny (vocab 50): ``ShardedDecoder`` (logits and
    greedy ``generate``), both engines greedy, seeded and penalized, the
    int8 cache, prefix sharing with copy-on-write, a hierarchical swap
    round trip, a hot-swap ``adopt``, draft-model speculation, and the
    gathered export; then n-gram linear and tree speculation on the
    cycling micro-model (vocab 20).  Every rank then loads its shard
    straight from the whole arrays (``load_mxtpu_params(mesh=,
    rules=)``) and compares it with the decoder's."""
    from mxtpu_torch.models.convert import load_mxtpu_params
    from mxtpu_torch.models.transformer import (TransformerLM,
                                                transformer_lm_sharding_rules)
    from mxtpu_torch.parallel.decode import ShardedDecoder
    from mxtpu_torch.parallel.serving import (ContinuousBatchingEngine,
                                              PagedContinuousBatchingEngine)
    from mxtpu_torch.resilience.checkpoint import write_verified

    rules = transformer_lm_sharding_rules()
    model = model_from(pl["spec"], pl["params"])
    draft = model_from(pl["draft_spec"], seed=5)
    micro = model_from(pl["micro_spec"], pl["micro_params"])
    eng_kw = dict(pl["engine"], device="cpu", mesh=mesh, rules=rules)

    def paged(m=model, **kw):
        return PagedContinuousBatchingEngine(m, **dict(eng_kw, **kw))

    def run():
        out = {}
        dec = ShardedDecoder(model, mesh, rules)
        ids = torch.from_numpy(pl["logit_prompt"]).long()
        out["logits"] = dec.prefill(ids, dec.init_cache(1, 16)).numpy()
        out["generate"] = [dec.generate(torch.from_numpy(p), n).numpy()
                           for p, n, _ in pl["greedy"]]
        out["generate_sampled"] = [
            dec.generate(torch.from_numpy(p), n, **kw).numpy()
            for p, n, kw in pl["sampled"]]
        gathered = dec.gathered_params()
        out["export"] = {k: v.numpy() for k, v in gathered.items()}
        eng = paged()
        out["paged_greedy"] = streams(eng, pl["greedy"])
        out["paged_greedy_stats"] = eng.stats
        out["paged_pools_kv"] = int(eng._pools[0][0].shape[1])
        out["paged_sampled"] = streams(eng, pl["sampled"])
        eng = ContinuousBatchingEngine(
            model, num_slots=pl["engine"]["num_slots"],
            max_length=pl["engine"]["max_length"], device="cpu", mesh=mesh,
            rules=rules)
        out["slot_greedy"] = streams(eng, pl["greedy"])
        out["slot_greedy_stats"] = eng.stats
        out["slot_sampled"] = streams(eng, pl["sampled"])
        eng = paged(cache_dtype="int8")
        out["int8"] = streams(eng, pl["greedy"])
        out["int8_stats"] = eng.stats
        # prefix sharing: B shares A's first page, clones the second
        eng = paged()
        pa_, pb_ = pl["prefix"]
        ra = eng.submit(pa_, 6)
        eng.step()
        eng.step()
        rb = eng.submit(pb_, 5)
        eng.step()
        out["prefix_pages"] = [list(eng._slot_pages[_row_of(eng, r)])
                               for r in (ra, rb)]
        res = eng.run()
        out["prefix"] = [res[ra].numpy(), res[rb].numpy()]
        out["prefix_stats"] = eng.stats
        # hierarchical: pinned, spilled to each rank's host buffers of its
        # heads, restored
        eng = paged(pin_bytes=1, host_cache_bytes="1MiB")
        p = pl["swap_prompt"]
        out["swap"] = [streams(eng, [(p, 5, {})])[0] for _ in range(2)]
        out["swap_stats"] = eng.stats
        # live weight hot-swap: generation B, sliced by the rules
        eng = paged()
        path = os.path.join(pl["tmp"], "gen_b.ckpt")
        write_verified(path, pickle.dumps({"params": pl["params_b"]}))
        sent = eng._dec.broadcast_stats()["bytes"]
        out["adopt_gen"] = eng.adopt(path)
        out["adopt_sent_bytes"] = eng._dec.broadcast_stats()["bytes"] - sent
        out["adopt_ckpt_bytes"] = os.path.getsize(path)
        out["adopt"] = streams(eng, pl["greedy"])
        # draft-model speculation: the draft is sharded by the same rules
        eng = paged(spec_k=3, draft_block=draft)
        out["draft"] = streams(eng, pl["greedy"])
        out["draft_stats"] = eng.stats
        # n-gram speculation on the cycling micro-model
        mkw = dict(pl["micro_engine"], device="cpu", mesh=mesh, rules=rules)
        for name, kw in (("plain", {}), ("linear", dict(spec_k=3)),
                         ("tree", dict(spec_k=3, spec_tree=(6, 2)))):
            eng = PagedContinuousBatchingEngine(micro, **dict(mkw, **kw))
            out["micro_" + name] = streams(eng, pl["micro_reqs"])
            out["micro_%s_stats" % name] = eng.stats
        out["report"] = dec.rank_report()
        # collectives timed on every rank for one generate, then not
        p0 = torch.from_numpy(pl["greedy"][0][0])
        dec.rank_report(reset=True, timing=True)
        dec.generate(p0, 2)
        timed = dec.rank_report(reset=True, timing=False)
        dec.generate(p0, 2)
        out["timed_collectives"] = [r["collectives"]["calls"] for r in timed]
        out["untimed_collectives"] = [r["collectives"]["calls"]
                                      for r in dec.rank_report()]
        return out

    out = controlled(rank, mesh, [model, draft, micro], run)
    # the same shard loaded straight from the whole arrays
    loaded = load_mxtpu_params(TransformerLM(*pl["spec"], device="cpu"),
                               pl["params"], mesh, rules)
    same = all(torch.equal(p.data, q.data) for (_, p), (_, q) in zip(
        model._adoption_params(), loaded._adoption_params()))
    return {"rank0": out, "load_equal": same}


def quantized(rank, mesh, pl):
    """tp=2: ``quantize_weights(bits=8 and 4, rules=...)`` of the whole
    model on every rank, then ``ShardedDecoder`` keeps each rank's slice:
    every rank returns its local payloads and scales, rank 0 also the
    greedy streams; then the refusals (a KV count tp does not divide, a
    non-default ``cache_spec``, an int4 group that straddles a shard)."""
    from mxtpu_torch.base import MXTPUError
    from mxtpu_torch.contrib.quantization import quantize_weights
    from mxtpu_torch.models.transformer import transformer_lm_sharding_rules
    from mxtpu_torch.parallel.decode import ShardedDecoder
    from mxtpu_torch.parallel.sharding import PartitionSpec

    models, rules = {}, {}
    for bits, gs in pl["quant"]:
        m = model_from(pl["spec"], pl["params"])
        rules[bits] = quantize_weights(
            m, bits=bits, group_size=gs,
            rules=transformer_lm_sharding_rules())
        models[bits] = m
    local = {}

    def run():
        out = {}
        for bits, _ in pl["quant"]:
            dec = ShardedDecoder(models[bits], mesh, rules[bits])
            out["generate%d" % bits] = [
                dec.generate(torch.from_numpy(p), n).numpy()
                for p, n, _ in pl["greedy"]]
        errors = {}
        for name, make in (
                ("kv", lambda: ShardedDecoder(
                    model_from(pl["kv1_spec"], seed=1), mesh,
                    transformer_lm_sharding_rules())),
                ("cache_spec", lambda: ShardedDecoder(
                    model_from(pl["spec"], seed=1), mesh,
                    transformer_lm_sharding_rules(), PartitionSpec())),
                ("int4_group", lambda: _straddle(mesh))):
            try:
                make()
                errors[name] = None
            except (ValueError, MXTPUError) as exc:
                errors[name] = (type(exc).__name__, str(exc))
        out["errors"] = errors
        out["rules"] = {b: r.iter_rules() for b, r in rules.items()}
        return out

    out = controlled(rank, mesh, [models[b] for b, _ in pl["quant"]], run)
    for bits, _ in pl["quant"]:
        local[bits] = {name: p.data.numpy().copy()
                       for name, p in models[bits]._adoption_params()}
    return {"rank0": out, "local": local}


def _straddle(mesh):
    """An int4 model at group size 64 over tp=2: out_proj's 64 inputs
    split into 32 a rank, half a group."""
    from mxtpu_torch.contrib.quantization import quantize_weights
    from mxtpu_torch.models.transformer import (llama_tiny,
                                                transformer_lm_sharding_rules)
    from mxtpu_torch.parallel.decode import ShardedDecoder

    m = llama_tiny(vocab_size=50, device="cpu")
    r = quantize_weights(m, bits=4, group_size=64,
                         rules=transformer_lm_sharding_rules())
    return ShardedDecoder(m, mesh, r)


def speculative_tp4(rank, mesh, pl):
    """tp=4 over a model of 4 KV heads: n-gram linear and tree
    speculation over bf16-free float32 pools and int8 pools, every
    speculative stream against the plain one."""
    from mxtpu_torch.models.transformer import transformer_lm_sharding_rules
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    rules = transformer_lm_sharding_rules()
    model = model_from(pl["spec"], seed=3)

    def run():
        out = {}
        for cache in (None, "int8"):
            for name, kw in (("plain", {}), ("linear", dict(spec_k=3)),
                             ("tree", dict(spec_k=3, spec_tree=(6, 2)))):
                eng = PagedContinuousBatchingEngine(
                    model, cache_dtype=cache, device="cpu", mesh=mesh,
                    rules=rules, **dict(pl["engine"], **kw))
                out[(cache, name)] = streams(eng, pl["reqs"])
                out[(cache, name, "stats")] = eng.stats
        return out

    return controlled(rank, mesh, [model], run)


def moe(rank, mesh, pl):
    """tp=2 over a Switch MoE model (the attention split, the router and
    the experts whole on each rank): ``ShardedDecoder.generate``, both
    engines' greedy streams and the gathered parameters; then the
    refusal of rules that split an expert."""
    from mxtpu_torch.base import MXTPUError
    from mxtpu_torch.models.moe import moe_sharding_rules
    from mxtpu_torch.models.transformer import transformer_lm_sharding_rules
    from mxtpu_torch.parallel.decode import ShardedDecoder
    from mxtpu_torch.parallel.serving import (ContinuousBatchingEngine,
                                              PagedContinuousBatchingEngine)
    from mxtpu_torch.parallel.sharding import PartitionSpec, ShardingRules

    rules = moe_sharding_rules(transformer_lm_sharding_rules())
    model = model_from(pl["spec"], pl["params"], **pl["moe"])
    split = model_from(pl["spec"], pl["params"], **pl["moe"])

    def run():
        out = {}
        dec = ShardedDecoder(model, mesh, rules)
        out["has_moe"] = dec._block_has_moe()
        out["generate"] = dec.generate(torch.from_numpy(pl["prompt"]),
                                       3).numpy()
        eng = PagedContinuousBatchingEngine(
            model, device="cpu", mesh=mesh, rules=rules, **pl["engine"])
        out["paged"] = streams(eng, pl["reqs"])
        out["paged_stats"] = eng.stats
        eng = ContinuousBatchingEngine(
            model, num_slots=pl["engine"]["num_slots"],
            max_length=pl["engine"]["max_length"], device="cpu", mesh=mesh,
            rules=rules)
        out["slot"] = streams(eng, pl["reqs"])
        out["report"] = dec.rank_report()
        out["export"] = {k: v.numpy()
                         for k, v in dec.gathered_params().items()}
        try:
            ShardedDecoder(split, mesh, ShardingRules(
                [(r"experts_w1$", PartitionSpec("tp", None, None))]).extend(
                    transformer_lm_sharding_rules()))
            out["split_error"] = None
        except MXTPUError as exc:
            out["split_error"] = str(exc)
        out["split_untouched"] = split.layers[0].attn.heads
        return out

    out = controlled(rank, mesh, [model], run)
    local = {name: tuple(p.shape) for name, p in model._adoption_params()}
    return {"rank0": out, "shapes": local}


def collectives_world(rank, mesh, pl):
    """Every verb of ``parallel.collectives`` on this rank's slice of the
    payload's arrays."""
    from mxtpu_torch.parallel import collectives as C

    x = torch.from_numpy(pl["x"][rank])
    out = {}
    with mesh:
        for op in ("sum", "mean", "max", "min"):
            out["all_reduce_" + op] = C.all_reduce(x, "tp", op)
        out["all_reduce_bf16"] = C.all_reduce(x.bfloat16(), "tp").float()
        out["all_gather0"] = C.all_gather(x, "tp", 0)
        out["all_gather1"] = C.all_gather(x, "tp", 1)
        out["all_gather_stacked"] = C.all_gather(x, "tp", 0, tiled=False)
        out["reduce_scatter"] = C.reduce_scatter(x, "tp", 0)
        out["ppermute"] = C.ppermute(x, "tp", pl["perm"])
        out["all_to_all"] = C.all_to_all(x, "tp", 0, 1)
        b = x.clone()
        out["broadcast"] = C.broadcast(b, "tp", src=1)
        C.barrier("tp")
        C.barrier()
    return {k: v.numpy() for k, v in out.items()}
