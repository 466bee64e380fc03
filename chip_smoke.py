#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card: its name and power limit as ``nvidia-smi`` gives them, the
   torch and CUDA versions; TF32 is switched off for float32 products;
2. build the CUDA kernels from ``mxtpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) into ``mxtpu_torch/_build``;
3. each kernel against its plain PyTorch version on the card, at the
   test geometry (head_dim 16, block 8, 2 kv heads, rep 2) and the
   Llama-3-8B one (head_dim 128, block 16, 8 kv heads, rep 4, 8 slots,
   64-token chunks), in float32 and bfloat16, with ragged tables, null
   padding, pages out of order and a chunk starting mid-page; kernel,
   plain and library (gather + scaled_dot_product_attention) times;
4. a small float32 model served by the paged engine on the card, its
   streams token-identical to the model's isolated ``generate``;
5. the main path: the full-width 32-layer Llama-3-8B in bfloat16 with
   seeded random weights, serving 12 requests (prompts of 64-640
   tokens, 6 sharing a 256-token prefix, 32 new tokens each, 2 of them
   sampled) through ``PagedContinuousBatchingEngine``; the kernel
   launch counts are zeroed just before and read just after, and must
   equal 32 per decode step and 32 per prefill chunk;
6. torch.profiler over four more decode steps of the same engine: the
   device time by kernel and the device's idle share;
7. layer 0's kernel inputs captured from the main run (one prefill
   chunk, one decode step): kernel against plain version on them, and
   the kernel, plain and library times (device time of a CUDA-graph
   replay, L2 flushed before each) at the main path's shapes;
8. the flash-attention kernels (K3 forward, K4 dq, K5 dk/dv) against
   their plain versions, causal and not, at T = 128, 100 and 150
   (head_dim 16) and at (1, 32, 2048, 128), in float32 and bfloat16;
9. a small float32 model trained 3 Adam steps by ``SPMDTrainer`` on the
   card and on the CPU: the losses agree within 1e-4 relative;
10. the training main path: the full-width Llama-3-8B cut to 4 layers,
   float32, 1 warm-up and 5 counted steps on 1 x 2048 tokens; the flash
   launch counts must be 20 each and the dense rule must not fire;
   torch.profiler over one more step;
11. layer 0's flash inputs captured from the first counted step: kernel
   against plain version, and the kernel, plain and library times;
12. the conv backward kernel (K6) against its plain version at the test
   geometries and ResNet-50's three stage shapes at batch 128, in
   float32 and bfloat16;
13. a narrow ResNet-v1 trained 3 SGD steps by ``gluon.Trainer`` on the
   card and on the CPU, the card's net taking the CPU's weights before
   each step: each step's loss within 1e-4 relative, its gradients
   within 1e-4 of their largest element;
14. the vision main path: ``resnet50_v1`` at full width and depth,
   float32, Xavier weights from seed 0, trained by ``Trainer("sgd")``
   on one batch of 128 synthetic 224x224 images, 1 warm-up and 5
   counted steps; K6 must launch exactly 13 times a step and the loss
   must fall; torch.profiler over one more step;
15. one K6 call per stage shape captured from the first counted step:
   kernel against plain version, and the kernel, plain and library
   (cuDNN's convolution backward) times.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  The script needs one CUDA card and
exits non-zero without one.

Tolerances (kernel against plain version, max absolute error): 2e-5 in
float32, where the two differ only in the order of their sums; 2e-2 in
bfloat16, where each rounds its float32 result to bfloat16 (one bf16
ulp is 2**-7 relative) after sums taken in other orders.  The flash
gradients (dq, dk, dv) and K6's are held relative to their largest
element (``GRAD_TOL``), since their size follows dO's, which the training
loss makes tiny; K6's float32 dW to 1e-4 of it (``DW_TOL``), since each
element sums up to N*H*W = 401,408 products in another order on each
side, and the rounding error of a sum of random-sign terms grows as
about 2**-24 * sqrt(N*H*W) of its largest partial sum (4e-5 there).
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

#: NVIDIA H100 SXM data sheet: HBM3 bytes/s and dense peak operations/s
#: by input type (bf16 on the tensor cores, float32 on the CUDA cores)
H100_BYTES_PER_S = 3.35e12
H100_PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: flash gradients, max abs error over max |plain|: float32 sums in other
#: orders stay within a few ulps of the largest element (2**-23 each);
#: in bfloat16 both sides sum in float32 and round once, and two
#: roundings of nearly equal values differ by at most one bf16 ulp,
#: 2**-7 of the value at most
GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}
DW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
TINY = dict(D=16, bs=8, KV=2, rep=2, B=4, T=8, ctx=40)
LLAMA_8B = dict(D=128, bs=16, KV=8, rep=4, B=8, T=64, ctx=640)
SERVE = dict(num_slots=8, max_length=1024, block_size=16, prefill_chunk=64)
NEW_TOKENS = 32
KERNEL_SOURCES = {
    "paged_attention": ("mxtpu_torch/csrc/paged_attention.cu",
                        "mxtpu/ops/pallas/paged_attention.py:117"),
    "paged_prefill": ("mxtpu_torch/csrc/prefill_attention.cu",
                      "mxtpu/ops/pallas/prefill_attention.py:113"),
    "flash_fwd": ("mxtpu_torch/csrc/flash_attention.cu",
                  "mxtpu/ops/pallas/flash_attention.py:107"),
    "flash_dq": ("mxtpu_torch/csrc/flash_attention.cu",
                 "mxtpu/ops/pallas/flash_attention.py:202"),
    "flash_dkv": ("mxtpu_torch/csrc/flash_attention.cu",
                  "mxtpu/ops/pallas/flash_attention.py:246"),
    "conv_bwd": ("mxtpu_torch/csrc/conv_bwd.cu",
                 "mxtpu/ops/pallas/conv_bwd.py:101"),
}
#: flash kernels against plain versions: (B, H, T, D)
FLASH_SHAPES = [(2, 2, 128, 16), (2, 2, 100, 16), (2, 2, 150, 16),
                (1, 32, 2048, 128)]
#: the training main path: Llama-3-8B at full width, 4 of 32 layers
TRAIN = dict(depth_factor=0.125, batch=1, seq=2048, lr=3e-4, warmup=1,
             steps=5)
#: K6 against its plain version, (N, Ci, Co, H, W): the test geometries
#: and ResNet-50 v1's three stage shapes at batch 128
CONV_SHAPES = [(2, 16, 32, 8, 8), (1, 32, 32, 14, 14), (2, 8, 24, 7, 9),
               (128, 64, 64, 56, 56), (128, 128, 128, 28, 28),
               (128, 256, 256, 14, 14)]
#: the example's optimizer (examples/gluon/image_classification.py)
SGD_PARAMS = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
#: the narrow ResNet-v1 of tests/test_torch_resnet.py
SMALL_RESNET = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
                    classes=10, batch=4, size=64, steps=3, seed=1,
                    eligible=4)
#: the vision main path: ResNet-50 v1, 13 of its 16 3x3 convs take K6
RESNET = dict(batch=128, size=224, classes=1000, seed=0, warmup=1, steps=5,
              eligible=13)


def log(**fields):
    print(json.dumps(fields), flush=True)


# -- timing and work accounting ---------------------------------------------

class _L2Flush:
    """Writes 64 MB between timed launches, more than the H100's 50 MB
    L2, so each launch finds its inputs in device memory as it does on
    the serving path (the next layer's pages are another pool)."""

    def __init__(self):
        self.buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self):
        self.buf.zero_()


def cuda_ms(fn, flush, iters=20):
    """Mean device milliseconds of ``fn``: its launches are captured once
    in a CUDA graph, so the host's launch gaps do not count, and the
    graph is replayed between CUDA events, the L2 flushed before each
    replay."""
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
        flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def bound(nbytes, ops, dtype):
    """Least time the card could take: bytes over the memory rate or
    operations over the peak rate for the inputs' type, the larger."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def decode_work(q, pool_k, tables, pos):
    """Bytes and operations a decode call needs on these inputs: q read
    and out written once, each slot's keys and values 0..pos[b] read
    once, 4 operations per (lane, key, d) for the scores and the sum."""
    B, H, W, D = q.shape
    KV = pool_k.shape[1]
    elt = q.element_size()
    keys = int((pos.long() + 1).sum())
    nbytes = (2 * q.numel() * elt + keys * KV * D * 2 * elt
              + 4 * (tables.numel() + pos.numel()))
    return nbytes, 4 * keys * H * W * D


def prefill_work(q, pool_k, table, start):
    """The same for one prefill chunk: keys 0..start+T-1 read once, lane
    t of the chunk attending start+t+1 keys."""
    _, H, T, D = q.shape
    KV = pool_k.shape[1]
    elt = q.element_size()
    nbytes = (2 * q.numel() * elt + (start + T) * KV * D * 2 * elt
              + 4 * table.numel())
    attended = T * (start + 1) + T * (T - 1) // 2
    return nbytes, 4 * attended * H * D


def library_decode(q, pool_k, pool_v, tables, pos):
    """The yardstick: gather each slot's pages, then PyTorch's
    scaled_dot_product_attention over them (never called by the port)."""
    from mxtpu_torch.ops.tensor import paged_cache_gather

    k = paged_cache_gather(pool_k, tables)           # (B, KV, M*bs, D)
    v = paged_cache_gather(pool_v, tables)
    mask = (torch.arange(k.shape[2], device=q.device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def library_prefill(q, pool_k, pool_v, table, start):
    from mxtpu_torch.ops.tensor import paged_cache_gather

    k = paged_cache_gather(pool_k, table)[None]      # (1, KV, M*bs, D)
    v = paged_cache_gather(pool_v, table)[None]
    qpos = start + torch.arange(q.shape[2], device=q.device)
    mask = torch.arange(k.shape[2], device=q.device)[None, :] <= qpos[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


# -- the training path's data and loss ----------------------------------------

def synthetic_batches(batch, seq, steps, vocab, seed=0):
    """The reference training example's synthetic language
    (examples/parallel/llama_train.py), with the vocabulary a parameter:
    arithmetic token sequences with 2% noise, as int32 numpy arrays."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        start = rng.randint(0, vocab, (batch, 1))
        stride = rng.randint(1, 5, (batch, 1))
        base = (start + stride * np.arange(seq)) % vocab
        noise = (rng.rand(batch, seq) < 0.02) * rng.randint(0, vocab,
                                                            (batch, seq))
        yield ((base + noise) % vocab).astype(np.int32)


class NextTokenLoss:
    """The reference training example's shifted cross-entropy: predict token t+1
    from the prefix up to t (one loss per predicted token)."""

    def __init__(self):
        from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

        self._ce = SoftmaxCrossEntropyLoss()

    def __call__(self, logits, labels):
        return self._ce(logits[:, :-1].reshape(-1, logits.shape[-1]),
                        labels[:, 1:].reshape(-1))


def synthetic_images(n, size, classes, seed):
    """The reference image-classification example's synthetic set
    (examples/gluon/image_classification.py, ``synth``), with the number
    of classes a parameter: class centres drawn once from seed 0, images
    ``clip(centre + 0.15 * noise, 0, 1)`` of shape (n, 3, size, size)
    float32, labels int64."""
    centers = np.random.RandomState(0).rand(classes, 3, 1, 1).astype("f")
    r = np.random.RandomState(seed)
    ys = r.randint(0, classes, n)
    xs = (centers[ys] + 0.15 * r.randn(n, 3, size, size).astype("f")).clip(
        0, 1)
    return xs, ys.astype(np.int64)


# -- phase 1 and 2 ----------------------------------------------------------

def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return line


def build():
    from mxtpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(phase="build", seconds=time.perf_counter() - t0,
        per_source={k: v["seconds"] for k, v in built.items()})
    for name, res in built.items():
        for line in res["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print("ptxas[%s] %s" % (name, line.strip()), flush=True)


# -- phase 3: kernels against plain versions --------------------------------

def _pages(rng, n, first=1):
    """n distinct page ids >= first, out of order."""
    return rng.permutation(np.arange(first, first + n)).astype(np.int32)


def decode_case(geom, dtype, seed):
    """Ragged slots through out-of-order pages with null-padded tables;
    slot 1 is a dead lane (all-null table, position 0)."""
    rng = np.random.RandomState(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, KV, rep, D, bs = (geom[k] for k in ("B", "KV", "rep", "D", "bs"))
    pos = rng.randint(0, geom["ctx"], B).astype(np.int32)
    pos[1] = 0
    nv = pos // bs + 1
    M = -(-geom["ctx"] // bs) + 2
    N = 1 + int(nv.sum()) + 3
    ids = _pages(rng, N - 1)
    tables = np.zeros((B, M), np.int32)
    k = 0
    for b in range(B):
        if b != 1:
            tables[b, :nv[b]] = ids[k:k + nv[b]]
            k += nv[b]
    shape = (N, KV, bs, D)
    dev = dict(device="cuda", dtype=dtype)
    return (torch.randn(B, KV * rep, 1, D, generator=g, **dev),
            torch.randn(shape, generator=g, **dev),
            torch.randn(shape, generator=g, **dev),
            torch.from_numpy(tables).cuda(), torch.from_numpy(pos).cuda())


def prefill_case(geom, dtype, seed):
    """One chunk of T lanes starting mid-page, its table out of order
    and null-padded."""
    rng = np.random.RandomState(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    KV, rep, D, bs, T = (geom[k] for k in ("KV", "rep", "D", "bs", "T"))
    start = (geom["ctx"] // 2) // bs * bs + bs // 2 + 1
    nv = (start + T - 1) // bs + 1
    table = np.zeros(nv + 3, np.int32)
    table[:nv] = _pages(rng, nv)
    shape = (nv + 4, KV, bs, D)
    dev = dict(device="cuda", dtype=dtype)
    return (torch.randn(1, KV * rep, T, D, generator=g, **dev),
            torch.randn(shape, generator=g, **dev),
            torch.randn(shape, generator=g, **dev),
            torch.from_numpy(table).cuda(), start)


def measure(name, args, flush, timed=True):
    """Kernel against plain version on ``args``; with ``timed`` also the
    kernel, plain and library times and the bound."""
    from mxtpu_torch.ops import paged_attention as pa
    from mxtpu_torch.ops import prefill_attention as pf

    if name == "paged_attention":
        kernel, plain, library = (pa.paged_decode_attention,
                                  pa.paged_decode_attention_plain,
                                  library_decode)
        work = decode_work(args[0], args[1], args[3], args[4])
    else:
        kernel, plain, library = (pf.paged_prefill_attention,
                                  pf.paged_prefill_attention_plain,
                                  library_prefill)
        work = prefill_work(args[0], args[1], args[3], args[4])
    dtype = args[0].dtype
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not err <= TOL[dtype]:
        raise AssertionError("%s disagrees with its plain version: max abs "
                             "error %g > %g (%s, %s)" % (
                                 name, err, TOL[dtype], dtype,
                                 tuple(args[0].shape)))
    res = dict(max_abs_err=err, err_over_tol=err / TOL[dtype])
    if timed:
        res["ms"] = cuda_ms(lambda: kernel(*args), flush)
        res["plain_ms"] = cuda_ms(lambda: plain(*args), flush)
        res["library_ms"] = cuda_ms(lambda: library(*args), flush)
        res["bound_ms"], res["bound_by"] = bound(work[0], work[1], dtype)
    return res


def kernels_against_plain(flush):
    for gname, geom in (("tiny", TINY), ("llama_3_8b", LLAMA_8B)):
        for dtype in (torch.float32, torch.bfloat16):
            for seed in (0, 1):
                for name, case in (("paged_attention", decode_case),
                                   ("paged_prefill", prefill_case)):
                    args = case(geom, dtype, seed)
                    res = measure(name, args, flush, timed=seed == 0)
                    log(phase="kernel_vs_plain", kernel=name,
                        geometry=gname, dtype=str(dtype).split(".")[1],
                        shape=list(args[0].shape), seed=seed, **res)


# -- phase 4: a small model against its isolated reference ------------------

def init_weights(model, gen, std):
    """Normal(0, std) weights from ``gen``; RMSNorm gains stay 1."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("norm.weight"):
                p.normal_(0.0, std, generator=gen)


def small_model_reference_check():
    """A 2-layer float32 model on the card: the paged engine (through the
    two kernels) must give the same tokens as the model's isolated
    generate (contiguous cache, no kernel), greedy and seeded-sampled,
    with prefix sharing and chunked prefill in play."""
    from mxtpu_torch.models.transformer import llama_tiny
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    model = llama_tiny(vocab_size=64, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(1), 0.1)
    eng = PagedContinuousBatchingEngine(model, num_slots=3, max_length=48,
                                        block_size=8, prefill_chunk=8)
    rng = np.random.RandomState(2)
    shared = rng.randint(0, 64, 13)
    prompts = [rng.randint(0, 64, (1, n)) for n in (5, 21, 9)] + [
        np.concatenate([shared, rng.randint(0, 64, n)])[None]
        for n in (3, 7, 11)]
    knobs = [{}, {}, dict(temperature=0.9, top_p=0.9, seed=7), {},
             dict(repetition_penalty=1.3), {}]
    rids = [eng.submit(p, 10, **kw) for p, kw in zip(prompts, knobs)]
    res = eng.run()
    for rid, p, kw in zip(rids, prompts, knobs):
        want = model.generate(torch.from_numpy(p), 10, **kw).cpu().numpy()
        got = res[rid].numpy()
        if not np.array_equal(got, want):
            raise AssertionError("engine stream %r differs from isolated "
                                 "generate %r (%r)" % (got, want, kw))
    st = eng.stats
    if st["blocks_in_use"] != 0 or st["prefix_hit_requests"] == 0:
        raise AssertionError("small model: pages leaked or no prefix hit: "
                             "%r" % st)
    log(phase="small_model_reference", requests=len(rids), ok=True,
        prefix_hit_requests=st["prefix_hit_requests"])


# -- phase 5 and 6: the main path --------------------------------------------

def traffic(vocab, seed=0):
    """12 requests: prompts of 64-640 tokens, 6 of them opening with one
    256-token prefix (so at least 288 long); 10 greedy, 2 sampled."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 256)
    shared_at = (0, 2, 5, 8, 9, 11)
    reqs = []
    for i in range(12):
        if i in shared_at:
            n = int(rng.randint(288, 641))
            p = np.concatenate([prefix, rng.randint(0, vocab, n - 256)])
        else:
            p = rng.randint(0, vocab, int(rng.randint(64, 641)))
        kw = dict(temperature=0.8, top_p=0.9, seed=1000 + i) \
            if i in (3, 8) else {}
        reqs.append((p[None].astype(np.int64), kw))
    return reqs


class Capture:
    """Wraps a kernel wrapper during the main run: every call goes
    through unchanged, and the first call that ``want`` accepts has its
    inputs cloned (the pools change in place as the run goes on)."""

    def __init__(self, module, attr, want):
        self.module, self.attr, self.want = module, attr, want
        self.inner = None
        self.calls = 0
        self.args = None

    def __call__(self, *args, **kw):
        if self.args is None and self.want(self.calls, args):
            self.args = [a.clone() if torch.is_tensor(a) else a
                         for a in args]
        self.calls += 1
        return self.inner(*args, **kw)

    def __enter__(self):
        # what is there at entry: another Capture of the same wrapper nests
        self.inner = getattr(self.module, self.attr)
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)


class FiniteLogits:
    """Wraps the sampler during the main run: folds whether every logit
    row it samples from (the live rows) is finite into one device flag,
    read once at the end."""

    def __init__(self, module):
        self.module = module
        self.inner = module.sample_next_token
        self.ok = None

    def __call__(self, logits, *args, **kw):
        fin = torch.isfinite(logits).all(dim=-1)
        mask = kw.get("active_mask")
        if mask is not None:
            fin = fin | ~mask
        self.ok = fin.all() if self.ok is None else self.ok & fin.all()
        return self.inner(logits, *args, **kw)

    def __enter__(self):
        self.module.sample_next_token = self
        return self

    def __exit__(self, *exc):
        self.module.sample_next_token = self.inner


class Timed:
    """CUDA events around every call of one model method."""

    def __init__(self, model, attr):
        self.model, self.attr = model, attr
        self.inner = getattr(model, attr)
        self.events = []

    def __call__(self, *args, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.inner(*args, **kw)
        e.record()
        self.events.append((s, e))
        return out

    def ms(self):
        return sum(s.elapsed_time(e) for s, e in self.events)

    def __enter__(self):
        setattr(self.model, self.attr, self)
        return self

    def __exit__(self, *exc):
        delattr(self.model, self.attr)


def serve_llama_3_8b():
    from mxtpu_torch import base
    from mxtpu_torch.models import sampler
    from mxtpu_torch.models.transformer import llama_3_8b
    from mxtpu_torch.ops import paged_attention as pa
    from mxtpu_torch.ops import prefill_attention as pf
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    t0 = time.perf_counter()
    model = llama_3_8b(device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(0), 0.02)
    torch.cuda.synchronize()
    n_layers = len(model.layers)
    log(phase="model", layers=n_layers, dtype="bfloat16",
        params=sum(p.numel() for p in model.parameters()),
        seconds=time.perf_counter() - t0)
    eng = PagedContinuousBatchingEngine(model, **SERVE)
    # warm-up request: cuBLAS handles and the allocator, outside the count
    eng.submit(np.arange(64)[None], 2)
    eng.run()
    before = eng.stats
    reqs = traffic(model.vocab_size)
    decode_cap = Capture(pa, "paged_decode_attention",
                         lambda n, a: n >= 20 * n_layers
                         and n % n_layers == 0)
    prefill_cap = Capture(pf, "paged_prefill_attention",
                          lambda n, a: a[4] >= 256)
    with decode_cap, prefill_cap, FiniteLogits(sampler) as finite, \
            Timed(model, "prefill_pages") as t_pre, \
            Timed(model, "step_pages") as t_dec:
        torch.cuda.synchronize()
        rids = [eng.submit(p, NEW_TOKENS, **kw) for p, kw in reqs]
        base.reset_counts()
        t_run = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = base.counts()
    after = eng.stats
    steps = after["steps"] - before["steps"]
    chunks = after["prefill_chunks"] - before["prefill_chunks"]
    for rid, (p, _) in zip(rids, reqs):
        if tuple(res[rid].shape) != (1, p.shape[1] + NEW_TOKENS):
            raise AssertionError("request %d returned %s, wanted %d tokens"
                                 % (rid, tuple(res[rid].shape),
                                    p.shape[1] + NEW_TOKENS))
    if finite.ok is None or not bool(finite.ok):
        raise AssertionError("a sampled logit row was not finite")
    if after["blocks_in_use"] != 0:
        raise AssertionError("pages leaked: %r" % after)
    if after["prefix_hit_requests"] - before["prefix_hit_requests"] <= 0:
        raise AssertionError("no request shared the prefix: %r" % after)
    want = {"paged_attention": n_layers * steps,
            "paged_prefill": n_layers * chunks}
    for name, n in want.items():
        if launches.get(name, 0) != n or n == 0:
            raise AssertionError("%s launched %d times, wanted %d"
                                 % (name, launches.get(name, 0), n))
    gen_tokens = after["generated_tokens"] - before["generated_tokens"]
    pre_tokens = after["prefill_tokens"] - before["prefill_tokens"]
    log(phase="serve", requests=len(rids), decode_steps=steps,
        prefill_chunks=chunks, launches=launches,
        prefix_hit_requests=after["prefix_hit_requests"]
        - before["prefix_hit_requests"],
        cow_copied_blocks=after["cow_copied_blocks"]
        - before["cow_copied_blocks"],
        prefill_tokens=pre_tokens, decode_tokens=gen_tokens,
        prefill_ms=t_pre.ms(), decode_ms=t_dec.ms(),
        prefill_tokens_per_s=pre_tokens / (t_pre.ms() / 1e3),
        decode_tokens_per_s=gen_tokens / (t_dec.ms() / 1e3),
        mean_ms_per_decode_step=t_dec.ms() / steps, wall_s=wall,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    if decode_cap.args is None or prefill_cap.args is None:
        raise AssertionError("no kernel inputs were captured")
    profile_decode_steps(eng, model.vocab_size)
    return launches, {"paged_attention": decode_cap.args,
                      "paged_prefill": prefill_cap.args}


def profile_device(run, steps):
    """torch.profiler over ``steps`` calls of ``run``: the wall time per
    step, the device time per step by kernel, and the share of the step
    the device sat idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue               # host ops: their kernels have own rows
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3 / steps, e.key, e.count // steps))
    rows.sort(reverse=True)
    device = sum(r[0] for r in rows)
    return dict(steps=steps, wall_ms_per_step=wall,
                kernels_per_step=sum(r[2] for r in rows),
                device_ms_per_step=device if rows else "not measured",
                device_idle_share=1.0 - device / wall if rows
                else "not measured",
                top=[dict(kernel=k[:80], ms_per_step=ms, calls_per_step=n)
                     for ms, k, n in rows[:12]])


def profile_decode_steps(eng, vocab, steps=4):
    """The profile of a few pooled decode steps (8 slots at ~520 tokens
    of context, after the main run and outside its counts)."""
    rng = np.random.RandomState(5)
    for _ in range(SERVE["num_slots"]):
        eng.submit(rng.randint(0, vocab, (1, 512)), steps + 12)
    for _ in range(512 // SERVE["prefill_chunk"] + 1):
        eng.step()                     # every slot prefilled, decoding
    res = profile_device(eng.step, steps)
    eng.run()
    log(phase="profile_decode", **res)


# -- phase 8: the flash kernels against their plain versions ----------------

def flash_args(q, k, v, do, causal):
    """Each flash kernel's operands on (q, k, v, dO), as its wrapper
    takes them: K4 and K5 get the plain forward's lse and
    delta = rowsum(dO*O)."""
    from mxtpu_torch.ops import flash_attention as fa

    scale = 1.0 / q.shape[-1] ** 0.5
    o, lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    bwd = (q, k, v, do, lse, (do.float() * o.float()).sum(dim=-1), scale,
           causal)
    return {"flash_fwd": (q, k, v, scale, causal), "flash_dq": bwd,
            "flash_dkv": bwd}


def flash_err(kind, args):
    """Max abs error of flash kernel ``kind`` against its plain version
    on its operands ``args``, and the largest error over its bound:
    ``TOL`` on o and 2e-5 on lse; ``GRAD_TOL`` times max |plain| on the
    gradients, so a kernel that wrote zeros is off by its whole bound
    over ``GRAD_TOL``, whatever the size of dO."""
    from mxtpu_torch.ops import flash_attention as fa

    got = getattr(fa, kind)(*args)
    want = getattr(fa, kind + "_plain")(*args)
    if kind == "flash_dq":
        got, want = (got,), (want,)
    torch.cuda.synchronize()
    err, worst = 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        e = float((a.float() - b.float()).abs().max())
        tol = TOL[b.dtype] if kind == "flash_fwd" else (
            GRAD_TOL[b.dtype] * float(b.float().abs().max()))
        if not e <= tol:
            raise AssertionError("%s disagrees with its plain version: "
                                 "output %d max abs error %g > %g (%s, %s,"
                                 " causal=%s)" % (kind, i, e, tol,
                                                  args[0].dtype,
                                                  tuple(args[0].shape),
                                                  args[-1]))
        err, worst = max(err, e), max(worst, e / tol if tol else 0.0)
    return err, worst


def flash_case(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            for _ in range(4)]


def flash_kernels_against_plain():
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_case(shape, dtype, seed=shape[2])
            for causal in (True, False):
                errs = {kind: flash_err(kind, args) for kind, args in
                        flash_args(q, k, v, do, causal).items()}
                log(phase="flash_vs_plain", shape=list(shape),
                    dtype=str(dtype).split(".")[1], causal=causal,
                    max_abs_err={k: e[0] for k, e in errs.items()},
                    err_over_tol={k: e[1] for k, e in errs.items()})


# -- phase 9: a small model trained on the card against the CPU -------------

def small_training_check(steps=3):
    """A 2-layer float32 model (T = 32, so flash_attention takes K3-K5)
    trained 3 Adam steps on the card through the kernels and on the CPU
    through their plain versions, from the same numpy-seeded weights and
    data: the losses agree within 1e-4 relative (float32 on both sides,
    sums in other orders, over three steps)."""
    from mxtpu_torch import base
    from mxtpu_torch.models.transformer import llama_tiny
    from mxtpu_torch.parallel.trainer import SPMDTrainer

    batches = list(synthetic_batches(2, 32, steps, vocab=512, seed=1))
    losses = {}
    for dev in ("cpu", "cuda"):
        model = llama_tiny(vocab_size=512, device=dev)
        rng = np.random.RandomState(11)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if not name.endswith("norm.weight"):
                    p.copy_(torch.from_numpy(
                        rng.normal(0, 0.05, p.shape).astype(np.float32)))
        trainer = SPMDTrainer(model, NextTokenLoss(), "adam",
                              {"learning_rate": 1e-3})
        base.reset_counts()
        losses[dev] = [float(trainer.step(b, b)) for b in batches]
        launches = base.counts()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    want = {"flash_fwd": 2 * steps, "flash_dq": 2 * steps,
            "flash_dkv": 2 * steps}
    if not rel <= 1e-4 or launches != want:
        raise AssertionError("small model: card losses %r, CPU losses %r "
                             "(max rel %g > 1e-4) or launches %r != %r"
                             % (losses["cuda"], losses["cpu"], rel,
                                launches, want))
    log(phase="small_training_reference", losses_cuda=losses["cuda"],
        losses_cpu=losses["cpu"], max_rel_diff=rel, launches=launches)


# -- phases 10 and 11: the training main path ---------------------------------

def train_llama_3_8b():
    """Llama-3-8B at full width and 4 layers, float32, seeded random
    weights, trained by SPMDTrainer with Adam (lr 3e-4) on one batch of
    1 x 2048 tokens of the synthetic language over the full vocabulary:
    one warm-up step, then 5 steps with the launch counts zeroed just
    before and read just after.  Every step trains on the same batch, so
    a falling loss shows the gradients and the update descend (on fresh
    batches of 128k random token ids five steps move the loss less than
    one batch differs from the next).  Layer 0's flash inputs are
    captured from the first counted step."""
    from mxtpu_torch import base
    from mxtpu_torch.models.transformer import llama_3_8b
    from mxtpu_torch.ops import flash_attention as fa
    from mxtpu_torch.parallel.trainer import SPMDTrainer

    t0 = time.perf_counter()
    model = llama_3_8b(depth_factor=TRAIN["depth_factor"], device="cuda",
                       dtype=torch.float32)
    init_weights(model, torch.Generator(device="cuda").manual_seed(0), 0.02)
    n_layers = len(model.layers)
    trainer = SPMDTrainer(model, NextTokenLoss(), "adam",
                          {"learning_rate": TRAIN["lr"]})
    batch = next(synthetic_batches(TRAIN["batch"], TRAIN["seq"], 1,
                                   vocab=model.vocab_size, seed=0))
    torch.cuda.synchronize()
    log(phase="train_model", layers=n_layers, dtype="float32",
        params=sum(p.numel() for p in model.parameters()),
        seconds=time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.step(batch, batch) for _ in range(TRAIN["warmup"])]
    torch.cuda.synchronize()
    # the backward runs the layers last to first: layer 0's is the last
    # dq/dkv call of a step
    caps = [Capture(fa, "flash_fwd", lambda n, a: n == 0),
            Capture(fa, "flash_dq", lambda n, a: n == n_layers - 1),
            Capture(fa, "flash_dkv", lambda n, a: n == n_layers - 1)]
    events = []
    with caps[0], caps[1], caps[2]:
        base.reset_counts()
        t_run = time.perf_counter()
        for _ in range(TRAIN["steps"]):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            losses.append(trainer.step(batch, batch))
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = base.counts()
    losses = [float(x) for x in losses]
    timed = losses[TRAIN["warmup"]:]
    want = n_layers * TRAIN["steps"]
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        if launches.get(name, 0) != want:
            raise AssertionError("%s launched %d times, wanted %d"
                                 % (name, launches.get(name, 0), want))
    if launches.get(fa.DENSE_NAME, 0) != 0:
        raise AssertionError("the dense rule fired %d times on the main "
                             "path" % launches[fa.DENSE_NAME])
    if not all(np.isfinite(losses)) or not timed[-1] < timed[0]:
        raise AssertionError("training losses not finite or not falling: "
                             "%r" % losses)
    step_ms = [s.elapsed_time(e) for s, e in events]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    mean_ms = sum(step_ms) / len(step_ms)
    log(phase="train", steps=TRAIN["steps"], launches=launches,
        losses=losses, ms_per_step=step_ms, mean_ms_per_step=mean_ms,
        tokens_per_step=tokens, tokens_per_s=tokens / (mean_ms / 1e3),
        wall_s=wall,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(phase="profile_train", **profile_device(
        lambda: trainer.step(batch, batch), 1))
    if any(c.args is None for c in caps):
        raise AssertionError("no flash inputs were captured")
    return launches, {c.attr: c.args for c in caps}


def flash_work(kind, q, causal):
    """Bytes and operations one flash call needs on these inputs: each
    operand read once and each result written once; 4*D (K3), 6*D (K4)
    or 8*D (K5) operations per attended (row, key) pair, the causal
    half when causal."""
    B, H, T, D = q.shape
    n, rows, elt = B * H * T * D, B * H * T, q.element_size()
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    if kind == "flash_fwd":
        return 4 * n * elt + 4 * rows, 4 * D * pairs
    if kind == "flash_dq":
        return 5 * n * elt + 8 * rows, 6 * D * pairs
    return 6 * n * elt + 8 * rows, 8 * D * pairs


def event_ms(fn, flush, iters=10):
    """Mean milliseconds of ``fn`` between CUDA events, the L2 flushed
    before each call (for work a CUDA graph cannot capture)."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def measure_flash(kind, args, flush):
    """Layer 0's captured flash operands: the kernel against its plain
    version, and the kernel, plain and library times.  The library is
    scaled_dot_product_attention: its forward for K3, its autograd
    backward (dq, dk and dv together) for K4 and K5."""
    from mxtpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    q, k, v = args[:3]
    scale, causal = args[-2:]
    err, ratio = flash_err(kind, args)
    res = dict(max_abs_err=err, err_over_tol=ratio)
    res["ms"] = cuda_ms(lambda: getattr(fa, kind)(*args), flush)
    res["plain_ms"] = cuda_ms(lambda: getattr(fa, kind + "_plain")(*args),
                              flush)
    if kind == "flash_fwd":
        res["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale), flush)
    else:
        lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal,
                                             scale=scale)
        res["library_ms"] = event_ms(lambda: torch.autograd.grad(
            out, (lq, lk, lv), args[3], retain_graph=True), flush)
    work = flash_work(kind, q, causal)
    res["bound_ms"], res["bound_by"] = bound(work[0], work[1], q.dtype)
    return res


# -- phases 12 to 15: the vision training path -------------------------------

def conv_err(args):
    """K6 against its plain version on (x, w, dy): max abs errors of dX
    and dW, and the larger of the two over its bound (``GRAD_TOL`` for
    dX, ``DW_TOL`` for dW, times the plain result's largest element)."""
    from mxtpu_torch.ops import conv_bwd as cb

    got = cb.conv3x3_s1_backward(*args)
    want = cb.conv_bwd_plain(*args)
    torch.cuda.synchronize()
    errs, worst = [], 0.0
    for name, a, b, tols in zip(("dx", "dw"), got, want, (GRAD_TOL, DW_TOL)):
        e = float((a.float() - b.float()).abs().max())
        tol = tols[b.dtype] * float(b.float().abs().max())
        if not e <= tol:
            raise AssertionError("conv_bwd disagrees with its plain version: "
                                 "%s max abs error %g > %g (%s, x %s)"
                                 % (name, e, tol, b.dtype,
                                    tuple(args[0].shape)))
        errs.append(e)
        worst = max(worst, e / tol if tol else 0.0)
    return max(errs), worst


def conv_kernel_against_plain():
    for N, Ci, Co, H, W in CONV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(N + Ci + Co + H)
            dev = dict(device="cuda", dtype=dtype, generator=g)
            args = (torch.randn(N, Ci, H, W, **dev),
                    torch.randn(Co, Ci, 3, 3, **dev),
                    torch.randn(N, Co, H, W, **dev))
            err, ratio = conv_err(args)
            log(phase="conv_vs_plain", shape=[N, Ci, Co, H, W],
                dtype=str(dtype).split(".")[1], max_abs_err=err,
                err_over_tol=ratio)


def resnet_step(net, loss_fn, trainer, x, y):
    """One step of the example's loop: forward, the per-sample loss,
    its sum's backward (MXNet's ``loss.backward()``), then
    ``trainer.step(batch)``.  Returns the mean loss (device tensor)."""
    loss = loss_fn(net(x), y)
    loss.sum().backward()
    trainer.step(x.shape[0])
    return loss.detach().mean()


def gap_over_bound(want, got, tol=1e-4):
    """The largest gap between two ``{name: tensor}`` maps (gradients,
    or weights and running statistics), each over its bound, and the
    name it is at.  The bound is ``tol`` of the tensor's max-abs, except
    for a conv bias that feeds a BatchNorm: its gradient is 0 in exact
    arithmetic (the batch mean takes any shift out), so it and the bias
    itself (0 at the start) are float32 residue on either side, held to
    ``tol`` of the conv weight's max-abs, on each side's value."""
    worst, where = 0.0, None
    for name, w in want.items():
        w, g = np.asarray(w), np.asarray(got[name])
        if g.shape != w.shape:
            return np.inf, name
        if name.startswith("stage") and name.endswith("_bias"):
            bound = tol * float(np.abs(want[name[:-4] + "weight"]).max())
            gap = max(float(np.abs(g).max()), float(np.abs(w).max()))
        else:
            bound = tol * float(np.abs(w).max())
            gap = float(np.abs(g - w).max())
        ratio = gap / bound if bound else (np.inf if gap else 0.0)
        if ratio >= worst:
            worst, where = ratio, name
    return worst, where


def small_resnet_training_check():
    """The narrow ResNet-v1 of the CPU tests, Xavier weights (seed 1),
    trained 3 SGD steps on the card through K6 and on the CPU through
    its plain version, on the same synthetic 64x64 images.  Before each
    step the card's net takes the CPU net's weights and running
    statistics (each trainer keeps its own momentum): the 3-step
    trajectory of this net can turn a rounding-sized change of its start
    into a jump (a ReLU or max-pool switch crossed; ROADMAP C), so each
    step is compared from one state.
    Gates, each step: the loss within 1e-4 relative; each gradient, and
    each weight and running statistic after the card's and the CPU's
    ``Trainer.step`` and BatchNorm update, within ``gap_over_bound``'s
    1e-4 of its largest element (one step from a shared state moves a
    tensor by lr times its gradient and momentum, so its gap is at most
    the gradient's, relative to a tensor that started at 0 like beta);
    K6 4 times a step on the card."""
    from mxtpu_torch import base
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxtpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
    from mxtpu_torch.gluon.trainer import Trainer
    from mxtpu_torch.initializer import Xavier

    cfg = SMALL_RESNET
    xs, ys = synthetic_images(cfg["batch"] * cfg["steps"], cfg["size"],
                              cfg["classes"], seed=1)
    nets, trainers = {}, {}
    for dev in ("cpu", "cuda"):
        nets[dev] = ResNetV1(BottleneckV1, cfg["layers"], cfg["channels"],
                             classes=cfg["classes"], device=dev)
        trainers[dev] = Trainer(nets[dev].collect_params(), "sgd",
                                dict(SGD_PARAMS))
    nets["cpu"].initialize(Xavier(magnitude=2.0),
                           torch.Generator().manual_seed(cfg["seed"]))
    loss_fn = SoftmaxCrossEntropyLoss()
    losses = {"cpu": [], "cuda": []}
    rel, launches = 0.0, 0
    gaps = {"grads": (0.0, None), "states": (0.0, None)}
    for i in range(cfg["steps"]):
        nets["cuda"].load_state_dict(nets["cpu"].state_dict())
        part = slice(i * cfg["batch"], (i + 1) * cfg["batch"])
        grads, states = {}, {}
        for dev, net in nets.items():
            x, y = (torch.from_numpy(a[part]).to(dev) for a in (xs, ys))
            base.reset_counts()
            loss = loss_fn(net(x), y)
            loss.sum().backward()
            launches += base.count("conv_bwd") if dev == "cuda" else 0
            grads[dev] = {k: t.grad.detach().cpu().clone() for k, t in
                          net.collect_params().items()
                          if isinstance(t, torch.nn.Parameter)}
            trainers[dev].step(cfg["batch"])
            states[dev] = {k: t.detach().cpu().clone() for k, t in
                           net.collect_params().items()}
            losses[dev].append(float(loss.detach().mean()))
        rel = max(rel, abs(losses["cuda"][-1] - losses["cpu"][-1])
                  / abs(losses["cpu"][-1]))
        for key, pair in (("grads", grads), ("states", states)):
            gaps[key] = max(gaps[key], gap_over_bound(pair["cpu"],
                                                      pair["cuda"]),
                            key=lambda g: g[0])
    want = cfg["eligible"] * cfg["steps"]
    if (not rel <= 1e-4 or not all(g[0] <= 1.0 for g in gaps.values())
            or launches != want):
        raise AssertionError("small ResNet: card losses %r, CPU losses %r "
                             "(max rel %g > 1e-4), gaps over their bounds "
                             "%r, or %d K6 launches != %d"
                             % (losses["cuda"], losses["cpu"], rel, gaps,
                                launches, want))
    log(phase="small_resnet_reference", losses_cuda=losses["cuda"],
        losses_cpu=losses["cpu"], max_rel_diff=rel,
        grad_gap_over_tol=gaps["grads"][0],
        state_gap_over_tol=gaps["states"][0],
        worst_state=gaps["states"][1], launches={"conv_bwd": launches})


def train_resnet50():
    """ResNet-50 v1 at full width and depth, float32, Xavier (magnitude
    2) weights from seed 0, trained by Trainer("sgd", lr 0.05, momentum
    0.9, wd 1e-4) on one batch of 128 synthetic 224x224 images of 1000
    classes: one warm-up step, then 5 steps with the launch counts zeroed
    just before and read just after.  One K6 call per stage shape is
    captured from the first counted step."""
    from mxtpu_torch import base
    from mxtpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxtpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxtpu_torch.gluon.trainer import Trainer
    from mxtpu_torch.initializer import Xavier
    from mxtpu_torch.ops import conv_bwd as cb

    cfg = RESNET
    t0 = time.perf_counter()
    net = resnet50_v1(classes=cfg["classes"], device="cuda")
    net.initialize(Xavier(magnitude=2.0),
                   torch.Generator(device="cuda").manual_seed(cfg["seed"]))
    net.train()
    trainer = Trainer(net.collect_params(), "sgd", dict(SGD_PARAMS))
    loss_fn = SoftmaxCrossEntropyLoss()
    xs, ys = synthetic_images(cfg["batch"], cfg["size"], cfg["classes"],
                              seed=cfg["seed"])
    x, y = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    torch.cuda.synchronize()
    log(phase="resnet_model", dtype="float32",
        params=sum(p.numel() for p in net.parameters()),
        batch=list(x.shape), seconds=time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    losses = [resnet_step(net, loss_fn, trainer, x, y)
              for _ in range(cfg["warmup"])]
    torch.cuda.synchronize()
    shapes = [(s[0], s[1], s[3], s[4]) for s in CONV_SHAPES
              if s[0] == cfg["batch"]]
    caps = [Capture(cb, "conv3x3_s1_backward",
                    lambda n, a, s=s: tuple(a[0].shape) == s)
            for s in shapes]
    events = []
    with caps[0], caps[1], caps[2]:
        base.reset_counts()
        t_run = time.perf_counter()
        for _ in range(cfg["steps"]):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            losses.append(resnet_step(net, loss_fn, trainer, x, y))
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = base.counts()
    losses = [float(v) for v in losses]
    timed = losses[cfg["warmup"]:]
    want = {"conv_bwd": cfg["eligible"] * cfg["steps"]}
    if launches != want:
        raise AssertionError("ResNet-50: launches %r, wanted %r"
                             % (launches, want))
    if not all(np.isfinite(losses)) or not timed[-1] < timed[0]:
        raise AssertionError("ResNet-50 losses not finite or not falling: "
                             "%r" % losses)
    step_ms = [s.elapsed_time(e) for s, e in events]
    mean_ms = sum(step_ms) / len(step_ms)
    log(phase="train_resnet50", steps=cfg["steps"], launches=launches,
        losses=losses, ms_per_step=step_ms, mean_ms_per_step=mean_ms,
        images_per_step=cfg["batch"],
        images_per_s=cfg["batch"] / (mean_ms / 1e3), wall_s=wall,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(phase="profile_resnet50", **profile_device(
        lambda: resnet_step(net, loss_fn, trainer, x, y), 1))
    if any(c.args is None for c in caps):
        raise AssertionError("no K6 inputs were captured")
    return launches, [c.args for c in caps]


def conv_work(x, w):
    """Bytes and operations one K6 call needs: x, dY and w read once, dX
    and dW written once; two products of 2*N*H*W*9*Ci*Co operations."""
    N, Ci, H, W = x.shape
    Co = w.shape[0]
    nbytes = (2 * x.numel() + N * Co * H * W) * x.element_size() \
        + 2 * w.numel() * w.element_size()
    return nbytes, 4 * N * H * W * 9 * Ci * Co


def measure_conv(args, flush):
    """One captured K6 call: kernel against plain version, and the
    kernel, plain and library times, each as CUDA-graph replays.  The
    library is cuDNN's backward of the same conv
    (``aten.convolution_backward`` for dX and dW, TF32 off as ``card``
    set it)."""
    from mxtpu_torch.ops import conv_bwd as cb

    x, w, dy = args
    err, ratio = conv_err(args)
    res = dict(max_abs_err=err, err_over_tol=ratio)
    res["ms"] = cuda_ms(lambda: cb.conv3x3_s1_backward(*args), flush)
    res["plain_ms"] = cuda_ms(lambda: cb.conv_bwd_plain(*args), flush)
    res["library_ms"] = cuda_ms(lambda: torch.ops.aten.convolution_backward(
        dy, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [True, True, False]), flush)
    res["bound_ms"], res["bound_by"] = bound(*conv_work(x, w), x.dtype)
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device — it runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import mxtpu_torch  # noqa: F401  (fails here outside a checkout)

    card()
    build()
    flush = _L2Flush()
    kernels_against_plain(flush)
    small_model_reference_check()
    launches, served = serve_llama_3_8b()
    results = {}
    for name, args in served.items():
        results[name] = measure(name, args, flush)
        log(phase="served_inputs", kernel=name, shape=list(args[0].shape),
            **results[name])
    del served
    torch.cuda.empty_cache()
    flash_kernels_against_plain()
    small_training_check()
    trained, captured = train_llama_3_8b()
    torch.cuda.empty_cache()
    launches.update(trained)
    for name, args in captured.items():
        results[name] = measure_flash(name, args, flush)
        log(phase="training_inputs", kernel=name,
            shape=list(args[0].shape), **results[name])
    del captured
    torch.cuda.empty_cache()
    conv_kernel_against_plain()
    small_resnet_training_check()
    trained, captured = train_resnet50()
    torch.cuda.empty_cache()
    launches.update(trained)
    for i, args in enumerate(captured):
        res = measure_conv(args, flush)
        log(phase="resnet_inputs", kernel="conv_bwd",
            shape=list(args[0].shape), cout=args[1].shape[0], **res)
        if i == 0:                     # the kernels line: stage 1's shape
            results["conv_bwd"] = res
    rows = []
    for name, res in results.items():
        source, replaces = KERNEL_SOURCES[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=res["max_abs_err"],
                         err_over_tol=res["err_over_tol"], ms=res["ms"],
                         plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                         bound_by=res["bound_by"],
                         library_ms=res["library_ms"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
