#!/usr/bin/env python3
"""Time a kernel of two trees on the same captured or seeded inputs.

    python3 kernel_ab.py capture k6 INPUTS.pt
    python3 kernel_ab.py capture k2 INPUTS.pt
    python3 kernel_ab.py capture k1 INPUTS.pt
    python3 kernel_ab.py measure ROOT INPUTS.pt
    python3 kernel_ab.py g1 ROOT_A ROOT_B
    python3 kernel_ab.py norm ROOT_A ROOT_B
    python3 kernel_ab.py flash ROOT_A ROOT_B
    python3 kernel_ab.py quant ROOT_A ROOT_B
    python3 kernel_ab.py q8 ROOT_A ROOT_B
    python3 kernel_ab.py qconv ROOT_A ROOT_B

``capture k6`` trains ResNet-50 v1 as ``chip_smoke.py`` phase 14 does
(this tree's port) and saves the first counted step's K6 inputs, one
call per stage shape.  ``capture k2`` serves ``chip_smoke.py`` phase 5's
traffic through the 32-layer Llama-3-8B, over bf16 pools and over int8
pools, and saves layer 0's K2 inputs at two chunks of each: the first
at position 256 or later and the last chunk of the longest prompt.
``capture k1`` saves layer 0's K1 inputs over bf16 and over int8 pools:
a decode step of phase 5's traffic (phases 5 and 5b), and the W = 8
window and W = 16 tree of phase 6b's speculative serve (phase 6c's over
int8 pools).  ``measure`` imports the ``chip_smoke`` and ``mxtpu_torch``
of the checkout at ROOT (this tree or another, such as its parent
unpacked with ``git archive``), and prints one JSON line per captured
call: that tree's ``chip_smoke.measure_conv`` (K6) or
``chip_smoke.measure`` (K1, K2) on the saved inputs (kernel against
plain version, kernel, plain and library times, bounds; on a
tensor-core route also the same bits on a second call).  Compare two
trees on one card in one run, in turns: capture, then measure A, B, B,
A.

``g1`` times G1 (``rows_linear``) of the checkouts at ROOT_A and ROOT_B
in turns, A, B, B, A, each turn a process of its own that imports that
tree's ``mxtpu_torch``: seeded bfloat16 x and w at Llama-3-8B's six
projections and M = 8, 64 and 128 rows (the decode step, an 8-slot
W = 8 window and W = 16 tree), each timed by this file's own
``device_ms`` (not the trees' ``chip_smoke.cuda_ms``, whose L2 flush
may differ), beside ``torch.matmul`` on the same inputs.  It prints one
JSON line per (turn, projection, M), then one line with each row's four
turns.

``norm`` times the normed projection of the checkouts at ROOT_A and
ROOT_B the same way, in turns A, B, B, A, one process each: seeded
bfloat16 x, gain (bf16, the model's) and w at Llama-3-8B's four
projections that read a norm (qkv, gate, up, lm_head) and M = 8, 64 and
128 rows, the tree's ``rows_norm_linear`` where it has one, else its
G2 then G1 (``rows_rms_norm``, then ``rows_linear``), by ``device_ms``,
beside ``F.rms_norm`` then ``torch.matmul`` on the same inputs; and by
``kernel_us``, the kernels' own device time of back-to-back calls on
inputs left in L2, as the decode step runs them (a graph replay counts
each launch's latency too), beside the tree's G1 alone.

``flash`` times K4 (``flash_dq``) and K5 (``flash_dkv``) of the checkouts
at ROOT_A and ROOT_B the same way, in turns A, B, B, A, one process
each: seeded (1, 32, 2048, 128) float32 causal q, k, v and dO (the
training path's shape), with lse and delta from the plain forward; each
kernel by ``device_ms``, held against its plain version first; beside
them the tree's whole backward (``torch.autograd.grad`` through its
``flash_attention``: delta, K4 and K5) and SDPA's, both by
``events_ms`` (autograd is not captured in a graph).

``quant`` times the projections of the checkouts at ROOT_A and ROOT_B
the same way, in turns A, B, B, A, one process each: seeded bfloat16 x
and w at Llama-3-8B's six projections and M = 8, 64 and 128, each
tree's G1 (``rows_linear``) and, where the tree has them, G3 and G4
(``wq_matmul``, int8 and int4 at group size 64) on the same w
quantized by its ``quantize_tensor``, and on the four projections that
read a norm G3's and G4's fused forms (``wq_matmul`` with the gain),
all by ``device_ms``: a parent without them gives G1 against the
change's G3 and G4 on one card.

``q8`` profiles the int8-weight decode step over int8 pools of the
checkouts at ROOT_A and ROOT_B in turns, A, B, B, A, one process each:
that tree's ``chip_smoke.llama_3_8b_quantized(8)`` (the 8B model at full
width and depth, bf16 weights from seed 0, quantized to int8 on the
card) in that tree's ``PagedContinuousBatchingEngine`` on phase 5's
settings with int8 pools, 8 slots at ~520 tokens of context (seeded
512-token prompts, as ``profile_decode_steps``), and ``Q8_STEPS``
pooled decode steps under ``chip_smoke.profile_device``: kernels a step,
device time a step, wall time a step and the idle share, beside the
first ``Q8_TOKENS`` tokens of each stream, which the two trees must
share.  A tree with the fused int8 V epilogue runs it there; its parent
quantizes V at the write.

``qconv`` times Q1, Q2 and the activation quantizer of the checkouts at
ROOT_A and ROOT_B the same way, in turns A, B, B, A, one process each:
seeded int8 x and w at ResNet-50 v1's 20 conv geometries at batch 128,
x stored channels-last where the tree has Q1's channels-last route
(``ops.quantized.route``) and the conv's channels allow it, else NCHW,
each call by ``device_ms`` with the weights packed as the tree's
quantized layer keeps them (for the stem's route where the tree has
one); Q2 at the classifier, 128 x 2048 -> 1000, with a bias; and at the
8 shapes of the net's quantized conv inputs, float32 x = randn and
relu(randn) (half zeros), the tree's Q3 (``quantize_nhwc``) where it has
one, else the torch chain ``quantize_v2`` runs (divide, round, clamp,
cast).  Each turn prints its rows and the launch-weighted totals a
forward (``chip_smoke.py``'s ``RESNET50_QCONV``, ``RESNET50_Q3``): all
of Q1, the stem, the 19 channels-last geometries, Q2, the stem + Q2,
and Q3 on each input.
Needs one CUDA card.
"""

import json
import os
import subprocess
import sys

import torch

from chip_smoke import RESNET50_Q3, RESNET50_QCONV

#: Llama-3-8B's decode-step projections (name, N, K) and G1's row counts
G1_PROJECTIONS = [("qkv", 6144, 4096), ("out_proj", 4096, 4096),
                  ("gate_proj", 14336, 4096), ("up_proj", 14336, 4096),
                  ("down_proj", 4096, 14336), ("lm_head", 128256, 4096)]
G1_ROWS = (8, 64, 128)
#: the projections that read a norm's output
NORMED = ("qkv", "gate_proj", "up_proj", "lm_head")


def device_ms(fn, iters=50):
    """Mean device milliseconds of ``fn``: captured once in a CUDA graph,
    replayed between CUDA events, and before each replay the L2 flushed
    by reading 64 MB (more than the H100's 50 MB), which leaves only
    clean lines in L2, so no write-back of the flush lands in the timed
    window."""
    flush = torch.ones(16 << 20, dtype=torch.float32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.sum()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def events_ms(fn, iters=20):
    """Mean milliseconds of ``fn`` between CUDA events, without a graph,
    the L2 flushed before each call as in ``device_ms``."""
    flush = torch.ones(16 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.sum()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def flash_tree(root, turn):
    """One turn of ``flash``: the tree at ``root``'s K4 and K5 and its
    whole backward on seeded training-shape inputs, beside SDPA's."""
    sys.path.insert(0, root)
    from mxtpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(1, 32, 2048, 128, device="cuda",
                               generator=g) for _ in range(4))
    scale = 128 ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, scale, True)
    args = (q, k, v, do, lse, (do * o).sum(dim=-1), scale, True)
    row = dict(turn=turn, tree=root)
    for kind in ("flash_dq", "flash_dkv"):
        got, want = getattr(fa, kind)(*args), getattr(fa, kind + "_plain")(
            *args)
        pairs = [(got, want)] if kind == "flash_dq" else zip(got, want)
        row[kind + "_rel_err"] = max(
            float((a - b).abs().max() / b.abs().max()) for a, b in pairs)
        row[kind + "_ms"] = device_ms(lambda: getattr(fa, kind)(*args))
    lq, lk, lv = (x.clone().requires_grad_() for x in (q, k, v))
    for name, fn in (("bwd_ms", lambda: fa.flash_attention(
            lq, lk, lv, causal=True, scale=scale)),
                     ("sdpa_bwd_ms", lambda: F.scaled_dot_product_attention(
                         lq, lk, lv, is_causal=True, scale=scale))):
        out = fn()
        row[name] = events_ms(lambda: torch.autograd.grad(
            out, (lq, lk, lv), do, retain_graph=True))
        del out
    print(json.dumps(row), flush=True)


def g1_tree(root, turn):
    """One turn of ``g1``: the tree at ``root``'s G1 on seeded inputs."""
    sys.path.insert(0, root)
    from mxtpu_torch.ops import linear

    g = torch.Generator(device="cuda").manual_seed(0)
    for name, N, K in G1_PROJECTIONS:
        w = torch.randn(N, K, device="cuda", dtype=torch.bfloat16,
                        generator=g) * 0.02
        x = torch.randn(max(G1_ROWS), K, device="cuda", dtype=torch.bfloat16,
                        generator=g)
        for M in G1_ROWS:
            xm = x[:M].contiguous()
            print(json.dumps(dict(
                turn=turn, tree=root, projection=name, M=M, N=N, K=K,
                ms=device_ms(lambda: linear.rows_linear(xm, w)),
                library_ms=device_ms(lambda: torch.matmul(xm, w.t())))),
                flush=True)
        del w, x


def kernel_us(fn, iters=40):
    """Mean microseconds of device time in the kernels ``fn`` launches
    (torch.profiler), over back-to-back calls on L2-warm inputs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters


def norm_tree(root, turn):
    """One turn of ``norm``: the tree at ``root``'s normed projection
    on seeded inputs."""
    sys.path.insert(0, root)
    from mxtpu_torch.ops import contrib, linear

    F = torch.nn.functional
    fused = getattr(linear, "rows_norm_linear", None)
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, N, K in G1_PROJECTIONS:
        if name not in NORMED:
            continue
        w = torch.randn(N, K, device="cuda", dtype=torch.bfloat16,
                        generator=g) * 0.02
        x = torch.randn(max(G1_ROWS), K, device="cuda", dtype=torch.bfloat16,
                        generator=g)
        gamma = (1 + 0.1 * torch.randn(K, device="cuda", generator=g)).to(
            torch.bfloat16)
        for M in G1_ROWS:
            xm = x[:M].contiguous()
            if fused is not None:
                op, run = "rows_norm_linear", lambda: fused(xm, gamma, w)
            else:
                op, run = "rows_rms_norm+rows_linear", lambda: \
                    linear.rows_linear(contrib.rows_rms_norm(xm, gamma), w)
            print(json.dumps(dict(
                turn=turn, tree=root, projection=name, M=M, N=N, K=K, op=op,
                ms=device_ms(run),
                library_ms=device_ms(lambda: torch.matmul(
                    F.rms_norm(xm, (K,), gamma, 1e-6), w.t())),
                kernel_us=kernel_us(run),
                g1_kernel_us=kernel_us(lambda: linear.rows_linear(xm, w)))),
                flush=True)
        del w, x


def quant_tree(root, turn):
    """One turn of ``quant``: the tree at ``root``'s G1, and its G3 and
    G4 where it has them, on seeded inputs."""
    sys.path.insert(0, root)
    from mxtpu_torch.ops import linear

    try:
        from mxtpu_torch.contrib.quantization import quantize_tensor
    except ImportError:                  # a tree before the quantized forms
        quantize_tensor = None
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, N, K in G1_PROJECTIONS:
        w = torch.randn(N, K, device="cuda", dtype=torch.bfloat16,
                        generator=g) * 0.02
        x = torch.randn(max(G1_ROWS), K, device="cuda", dtype=torch.bfloat16,
                        generator=g)
        gamma = (1 + 0.1 * torch.randn(K, device="cuda", generator=g)).to(
            torch.bfloat16)
        forms = {"g1": lambda xm: linear.rows_linear(xm, w)}
        if quantize_tensor is not None:
            q8, s8 = quantize_tensor(w, 8)
            q4, s4 = quantize_tensor(w, 4, 64)
            forms["g3"] = lambda xm: linear.wq_matmul(xm, q8, s8)
            forms["g4"] = lambda xm: linear.wq_matmul(xm, q4, s4)
            if name in NORMED:
                forms["g3n"] = lambda xm: linear.wq_matmul(xm, q8, s8, gamma)
                forms["g4n"] = lambda xm: linear.wq_matmul(xm, q4, s4, gamma)
        for M in G1_ROWS:
            xm = x[:M].contiguous()
            row = dict(turn=turn, tree=root, projection=name, M=M, N=N, K=K)
            for form, fn in forms.items():
                row[form + "_ms"] = device_ms(lambda: fn(xm))
            print(json.dumps(row), flush=True)
        del w, x, gamma, forms


def qconv_tree(root, turn):
    """One turn of ``qconv``: the tree at ``root``'s Q1 at ResNet-50's
    geometries and its quantizer at the net's input shapes."""
    sys.path.insert(0, root)
    from mxtpu_torch.ops import quantized as Q

    route = getattr(Q, "route", None)
    g = torch.Generator(device="cuda").manual_seed(0)
    scale = torch.tensor(1e-5, device="cuda")
    totals = dict(qconv_ms=0.0, stem_ms=0.0, qconv_nhwc_ms=0.0, qfc_ms=0.0,
                  stem_qfc_ms=0.0, quantize_randn_ms=0.0,
                  quantize_relu_ms=0.0)
    for (ci, co, k, s, p, h), n in RESNET50_QCONV:
        x = torch.randint(-127, 128, (128, ci, h, h), generator=g,
                          device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (co, ci, k, k), generator=g,
                          device="cuda", dtype=torch.int8)
        cl = route is not None and ci % 16 == 0
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        if hasattr(Q, "QCONV_STEM"):     # a tree with the stem's route
            form = Q.route(x, 1, (k, k))
            packed = Q.pack_weight(w, form == "nhwc", form == "stem")
        else:
            form = "nhwc" if cl else "nchw"
            packed = Q.pack_weight(w, cl) if cl else Q.pack_weight(w)
        args = (x, w, scale, None, (s, s), (p, p), (1, 1), 1)
        if not torch.equal(Q.qconv(*args, packed=packed),
                           Q.qconv_plain(*args)):
            raise AssertionError("%s: Q1 differs from its plain version"
                                 % root)
        ms = device_ms(lambda: Q.qconv(*args, packed=packed))
        totals["qconv_ms"] += n * ms
        totals["stem_ms" if ci == 3 else "qconv_nhwc_ms"] += n * ms
        print(json.dumps(dict(turn=turn, tree=root, geometry=[ci, co, k, s,
                                                              p, h],
                              channels_last=cl, form=form, ms=ms)),
              flush=True)
        del x, w, packed
    x = torch.randint(-127, 128, (128, 2048), generator=g, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (1000, 2048), generator=g, device="cuda",
                      dtype=torch.int8)
    bias = torch.randn(1000, generator=g, device="cuda")
    if not torch.equal(Q.qfc(x, w, scale, bias),
                       Q.qfc_plain(x, w, scale, bias)):
        raise AssertionError("%s: Q2 differs from its plain version" % root)
    ms = device_ms(lambda: Q.qfc(x, w, scale, bias))
    totals["qfc_ms"] = ms
    totals["stem_qfc_ms"] = totals["stem_ms"] + ms
    print(json.dumps(dict(turn=turn, tree=root, qfc=[128, 2048, 1000],
                          ms=ms)), flush=True)
    del x, w
    qs = torch.tensor(0.02, device="cuda")
    for (c, h), n in RESNET50_Q3:
        x = torch.randn(128, c, h, h, generator=g, device="cuda")
        for kind, xx in (("randn", x), ("relu", x.relu())):
            if hasattr(Q, "quantize_nhwc"):
                def fn():
                    return Q.quantize_nhwc(xx, qs)
            else:
                def fn():
                    return (xx / qs).round_().clamp_(-127, 127).to(
                        torch.int8)
            ms = device_ms(fn)
            totals["quantize_%s_ms" % kind] += n * ms
            print(json.dumps(dict(turn=turn, tree=root, quantize=[c, h, h],
                                  input=kind, ms=ms)), flush=True)
    print(json.dumps(dict(turn=turn, tree=root, per_forward=totals)),
          flush=True)


#: q8's profiled decode steps a turn, and the tokens a stream prints
Q8_STEPS = 8
Q8_TOKENS = 16


def q8_tree(root, turn):
    """One turn of ``q8``: the tree at ``root``'s int8 x int8 decode step
    profiled, and its streams' first tokens."""
    sys.path.insert(0, root)
    import numpy as np

    import chip_smoke
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    chip_smoke.log = lambda **fields: None
    model = chip_smoke.llama_3_8b_quantized(8)
    eng = PagedContinuousBatchingEngine(model, cache_dtype="int8",
                                        **chip_smoke.SERVE)
    rng = np.random.RandomState(5)
    slots = chip_smoke.SERVE["num_slots"]
    rids = [eng.submit(rng.randint(0, model.vocab_size, (1, 512)),
                       Q8_STEPS + Q8_TOKENS + 4) for _ in range(slots)]
    for _ in range(512 // chip_smoke.SERVE["prefill_chunk"] + 1):
        eng.step()                     # every slot prefilled, decoding
    for _ in range(2):
        eng.step()                     # warm
    res = chip_smoke.profile_device(eng.step, Q8_STEPS)
    out = eng.run()
    print(json.dumps(dict(
        turn=turn, tree=root, steps=Q8_STEPS,
        kernels_per_step=res["kernels_per_step"],
        device_ms_per_step=res["device_ms_per_step"],
        wall_ms_per_step=res["wall_ms_per_step"],
        device_idle_share=res["device_idle_share"],
        top=res["top"][:6],
        streams=[out[r][0, 512:512 + Q8_TOKENS].tolist() for r in rids])),
        flush=True)


def turns(kind, root_a, root_b, collect):
    """``kind``'s turns, A, B, B, A, one process each (``<kind>-tree``),
    and their summary: ``collect(rows, line)`` files each printed line
    into ``rows``."""
    print(json.dumps(dict(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())), flush=True)
    rows = {}
    for turn, root in enumerate((root_a, root_b, root_b, root_a)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), kind + "-tree",
             os.path.abspath(root), str(turn)], capture_output=True,
            text=True)
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            collect(rows, json.loads(line))
    print(json.dumps({kind + "_turns_A_B_B_A": rows}), flush=True)
    return 0


def g1(root_a, root_b):
    """``g1``'s turns and their summary."""
    return turns("g1", root_a, root_b, lambda rows, r: rows.setdefault(
        "%s,M=%d" % (r["projection"], r["M"]), []).append(
            (r["ms"], r["library_ms"])))


def norm(root_a, root_b):
    """``norm``'s turns and their summary."""
    return turns("norm", root_a, root_b, lambda rows, r: rows.setdefault(
        "%s,M=%d" % (r["projection"], r["M"]), []).append(
            (r["ms"], r["library_ms"], r["kernel_us"], r["g1_kernel_us"])))


def quant(root_a, root_b):
    """``quant``'s turns and their summary: (G1, G3, G4, G3 fused, G4
    fused) ms a turn (None where a tree or a projection has no such
    form)."""
    return turns("quant", root_a, root_b, lambda rows, r: rows.setdefault(
        "%s,M=%d" % (r["projection"], r["M"]), []).append(
            (r["g1_ms"], r.get("g3_ms"), r.get("g4_ms"), r.get("g3n_ms"),
             r.get("g4n_ms"))))


def q8(root_a, root_b):
    """``q8``'s turns and their summary: (kernels, device ms, wall ms) a
    step a turn, and whether every turn's streams agree."""
    streams = []

    def collect(rows, r):
        streams.append(r["streams"])
        rows.setdefault("kernels_device_ms_wall_ms", []).append(
            (r["kernels_per_step"], r["device_ms_per_step"],
             r["wall_ms_per_step"]))
        rows["streams_agree"] = all(x == streams[0] for x in streams)

    return turns("q8", root_a, root_b, collect)


def qconv(root_a, root_b):
    """``qconv``'s turns and their summary: each row's ms a turn, and the
    launch-weighted totals a forward."""
    def collect(rows, r):
        if "per_forward" in r:
            rows.setdefault("per_forward", []).append(r["per_forward"])
        elif "geometry" in r:
            rows.setdefault("qconv%s" % r["geometry"], []).append(r["ms"])
        elif "qfc" in r:
            rows.setdefault("qfc%s" % r["qfc"], []).append(r["ms"])
        else:
            rows.setdefault("quantize%s,%s" % (r["quantize"], r["input"]),
                            []).append(r["ms"])

    return turns("qconv", root_a, root_b, collect)


def flash(root_a, root_b):
    """``flash``'s turns and their summary."""
    def collect(rows, r):
        for key in ("flash_dq_ms", "flash_dkv_ms", "bwd_ms", "sdpa_bwd_ms"):
            rows.setdefault(key, []).append(r[key])

    return turns("flash", root_a, root_b, collect)


def _cpu(x):
    return x.cpu() if torch.is_tensor(x) else x


def _cuda(x):
    return x.cuda() if torch.is_tensor(x) else x


def capture(kind):
    """{"kind": kind, "calls": {row name: (args, keywords)}} on the CPU."""
    import chip_smoke

    chip_smoke.card()
    chip_smoke.build()
    if kind == "k6":
        _, captured = chip_smoke.train_resnet50()
        calls = {name: (args, {}) for name, args in captured.items()}
    elif kind == "k1":
        model = chip_smoke.llama_3_8b_model()
        calls, reqs = {}, None
        for cache_dtype in (None, "int8"):
            _, caps, _ = chip_smoke.serve_llama_3_8b(model, cache_dtype)
            calls.update({name: cap for name, cap in caps.items()
                          if name.startswith("paged_attention")})
            _, verify, reqs, _ = chip_smoke.serve_llama_3_8b_speculative(
                model, cache_dtype, reqs)
            for vkind, (args, kw) in verify.items():
                calls["paged_attention[%s%sW=%d]" % (
                    "int8," if cache_dtype else "",
                    "tree," if vkind == "tree" else "",
                    args[0].shape[2])] = (args, kw)
    else:
        model = chip_smoke.llama_3_8b_model()
        calls = {}
        for cache_dtype in (None, "int8"):
            _, caps, _ = chip_smoke.serve_llama_3_8b(model, cache_dtype)
            calls.update({name: cap for name, cap in caps.items()
                          if name.startswith("paged_prefill")})
    return {"kind": kind, "calls": {
        name: ([_cpu(a) for a in args], {k: _cpu(v) for k, v in kw.items()})
        for name, (args, kw) in calls.items()}}


def main(argv):
    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) == 3 and argv[0] == "g1":
        return g1(argv[1], argv[2])
    if len(argv) == 3 and argv[0] == "g1-tree":
        g1_tree(argv[1], int(argv[2]))
        return 0
    if len(argv) == 3 and argv[0] == "norm":
        return norm(argv[1], argv[2])
    if len(argv) == 3 and argv[0] == "norm-tree":
        norm_tree(argv[1], int(argv[2]))
        return 0
    if len(argv) == 3 and argv[0] == "quant":
        return quant(argv[1], argv[2])
    if len(argv) == 3 and argv[0] == "quant-tree":
        quant_tree(argv[1], int(argv[2]))
        return 0
    if len(argv) == 3 and argv[0] == "q8":
        return q8(argv[1], argv[2])
    if len(argv) == 3 and argv[0] == "q8-tree":
        q8_tree(argv[1], int(argv[2]))
        return 0
    if len(argv) == 3 and argv[0] == "qconv":
        return qconv(argv[1], argv[2])
    if len(argv) == 3 and argv[0] == "qconv-tree":
        qconv_tree(argv[1], int(argv[2]))
        return 0
    if len(argv) == 3 and argv[0] == "flash":
        return flash(argv[1], argv[2])
    if len(argv) == 3 and argv[0] == "flash-tree":
        flash_tree(argv[1], int(argv[2]))
        return 0
    if len(argv) == 3 and argv[0] == "capture" and argv[1] in ("k6", "k2",
                                                                 "k1"):
        torch.save(capture(argv[1]), argv[2])
        return 0
    if len(argv) == 3 and argv[0] == "measure":
        sys.path.insert(0, argv[1])
        import chip_smoke

        chip_smoke.card()
        flush = chip_smoke._L2Flush()
        saved = torch.load(argv[2])
        for name, (args, kw) in saved["calls"].items():
            args = [_cuda(a) for a in args]
            if saved["kind"] == "k6":
                res = chip_smoke.measure_conv(args, flush)
                extra = dict(cout=args[1].shape[0])
            else:
                res = chip_smoke.measure(
                    name, args, flush, kw={k: _cuda(v) for k, v in kw.items()})
                extra = (dict(pos=args[4].tolist())
                         if saved["kind"] == "k1" else dict(start=args[4]))
            print(json.dumps(dict(tree=argv[1], kernel=name,
                                  shape=list(args[0].shape), **extra, **res)),
                  flush=True)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
