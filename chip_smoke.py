#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card: its name and power limit as ``nvidia-smi`` gives them, the
   torch and CUDA versions; TF32 is switched off for float32 products;
2. build the CUDA kernels from ``mxtpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) into ``mxtpu_torch/_build``, logging ptxas's
   registers and spill bytes of every G3 and G4 instantiation and of Q1's
   (the stem's too), Q2's and Q3's kernels, and failing if one spills;
   then the timing
   floor on a line of its own (``timing_floor``): an empty captured
   graph and G2 on 8 x 4096 bf16 values, timed as every kernel is
   (``cuda_ms``) under a flush that writes 64 MB and leaves dirty lines
   in L2 (``_L2FlushByWrite``, the script's earlier flush) and under
   ``_L2Flush``, which reads 64 MB and leaves clean ones;
3. each kernel against its plain PyTorch version on the card, at the
   test geometry (head_dim 16, block 8, 2 kv heads, rep 2; and head_dim
   8, the small speculative model's) and the
   Llama-3-8B one (head_dim 128, block 16, 8 kv heads, rep 4, 8 slots,
   64-token chunks), in float32 and bfloat16, with ragged tables, null
   padding, pages out of order and a chunk starting mid-page; kernel,
   plain and library (gather + scaled_dot_product_attention) times;
3b. K1's speculative verify window (W = 2, 4, 8, 16, 32) and tree
   ancestor mask (seeded branchy trees) against the plain version at
   head_dim 64 and 128, block 8, 16 and 32, rep 1, 4 and 8, float32 and
   bfloat16 (llama_3_8b's geometry holds more lanes than one block from
   W = 16), with its two bit-exact invariants (``torch.equal``): a
   degenerate-chain ``anc`` gives the bits of no ``anc``, and lane w of
   a W-lane window equals a W = 1 call at pos + w;
3c. phases 3 and 3b again over int8 pools and their float32 scales (the
   random pools quantized by the cache's own quantizer): K1 int8 at
   W = 1, windows W = 2..32 and trees, invariants (a) and (b) with
   ``torch.equal``, and K2 int8 with a chunk starting mid-page; K2 at the
   unbucketed chunk lengths a routed model gives it (T = 1, 37, 97 and
   641, mid-page, float32 and bf16 queries over float and int8 pools);
   then G1,
   the row-invariant projection, against its plain version (F.linear)
   at small ragged shapes in float32 and bfloat16 (M up to 200, two
   128-row chunks) and at the six 8B projections in bfloat16, M = 8 and
   128, with its guarantee held by ``torch.equal`` (a row of an 8-row
   and a 64-row call, and of a call on the rows reversed, equals that
   row of the full call), and its time against
   F.linear and torch.matmul at M = 8, 64 and 128 (the decode step and
   the W = 8 and W = 16 windows of 8 slots); G2, the row-invariant
   RMSNorm, the same way against the port's rms_norm and F.rms_norm;
   and the fused
   norm (``rows_norm_linear``, G2 inside G1's launch) held bit-identical
   (``torch.equal``) to G2 then G1 at small ragged shapes in float32
   and bfloat16 (M up to 200, K % 16 == 8) with a gain of either dtype
   and at the 8B's four normed projections (qkv, gate, up, lm_head), M =
   8, 64 and 128, its rows invariant as G1's are, and its time against
   the pair (the gain's cast, G2, G1) and F.rms_norm then torch.matmul;
   then G3 and G4, the weight-only int8 and int4 projections (G1 reading
   int8 or packed int4 weights, ``ops/linear.py``'s ``wq_matmul_i8`` /
   ``wq_matmul_i4`` and their norm-fused forms), weights quantized on
   the card: at small ragged shapes (group sizes 16 to 128, bf16 and
   float32 x) and the 8B's six projections (int4 at group size 64),
   within TOL of their largest plain output, rows invariant and the
   fused forms equal to G2 then the op (``torch.equal``), timed at M =
   8, 64 and 128 against the plain version and the library yardstick
   (``torch._weight_int8pack_mm`` / ``_weight_int4pack_mm`` on their own
   packed layouts, else dequantize + torch.matmul, labelled); and G3's
   q8 epilogue (``wq_matmul_q8``) on the 8B's qkv at M = 8, 64 and 128,
   plain and norm-fused: its q/k rows, int8 V payload and scales
   ``torch.equal`` to the unfused arm (G3 or its fused norm, then the
   cache's quantizer on the V heads), within TOL of its plain version,
   timed beside the plain version, the unfused arm and the library
   (F.rms_norm, ``torch._weight_int8pack_mm``, the quantizer);
4. a small float32 model served by the paged engine on the card, its
   streams token-identical to the model's isolated ``generate``;
4b. a 1-layer float32 model (vocab 20, numpy-seeded weights) served by
   one engine with spec_k = 3 and spec_tree = (6, 2) over a mixed pool,
   greedy, seeded-sampled and penalized, prefix sharing and chunked
   prefill in play: every stream equals the same settings' stream with
   speculation off and ``generate``; drafts are accepted, a tree
   side-branch fix-up runs, no page leaks;
4c. phase 4b with an int8 cache, every stream equal to the same settings'
   stream without speculation and to int8 ``generate``;
4m. a small float32 Switch MoE model (``llama_tiny``'s widths, 4 experts,
   capacity factor 4) served by the paged engine (chunked, unpadded
   prefill) and the slot engine: greedy and seeded streams
   token-identical to its ``generate``, no prefix shared, K1 and K2
   launched; its prefill and full-forward logits within 1e-4 of the
   same model on the CPU;
5. the main path: the full-width 32-layer Llama-3-8B in bfloat16 with
   seeded random weights, serving 12 requests (prompts of 64-640
   tokens, 6 sharing a 256-token prefix, 32 new tokens each, 2 of them
   sampled) through ``PagedContinuousBatchingEngine``; the kernel
   launch counts are zeroed just before and read just after, and must
   equal 32 per decode step and 32 per prefill chunk for K1 and K2, 161
   per decode step for G1 (5 projections a layer and the head), 97 of
   them fused with their norm (``rows_norm_linear``: qkv, gate, up a
   layer and the head) and none for G2 apart; every K1 and K2 call
   must take the tensor-core route (``paged_attention.route`` and
   ``prefill_attention.route``: bf16 queries);
5b. the main path again with an int8 cache: K1 int8 32 per decode step,
   K2 int8 32 per chunk, no float K1/K2 launch; the pool bytes, and how
   many streams equal the bf16 run's (a reading: random weights tie
   often in bf16);
6. torch.profiler over four more decode steps of the same engine (of
   phase 5's and of 5b's): the device time by kernel and the device's
   idle share;
6b. the speculative main path: the same model serves 12 motif requests
   (``motif_traffic``: 6 tree, 5 linear, 1 not speculating; 2 sampled,
   1 penalized; 32 new tokens each) twice on the main path's engine
   settings, with speculation off and with spec_k = 4, spec_tree =
   (15, 2); K1's launches must be 32 per step or verify call, by W and
   tree, G1's 161 and the fused norm's 97 per step or verify call (their
   calls counted by row count M), G2's none; every K1 and K2 call on
   the tensor-core route; every
   speculative stream must be token-identical to its plain stream, K1 must hold
   invariant (b) on the captured window, and ``window_op_bits`` must
   find no op of the step (norms, projections, rope, SwiGLU, residual
   adds) that rounds a window lane otherwise at W = 8 or W = 16;
6c. phase 6b's traffic and engines with an int8 cache: every speculative
   stream token-identical to the int8 plain stream, K1 int8's launches
   by (W, tree);
5q. the weight-only quantized main path: phase 5's model cut to 4 of
   its 32 layers at full width (``CUT_DEPTH``) and rebuilt from its seed,
   quantized in place on the card by ``quantize_weights``
   (int8; then again with int4 at group size 64), layer 0's qkv and the
   lm_head first held ``torch.equal`` to the same weights quantized on
   the CPU; served phase 5's traffic over bf16 pools and, int8, over
   int8 pools: G3 or G4 launched 5 a layer and the head each step and
   prefill chunk, 3 a layer and the head fused with their norm, no G1
   or G2, every page back; the weight bytes, decode ms a step, tokens/s,
   prefill tokens/s and peak memory; no cuBLAS or CUTLASS GEMM kernel in
   the profiled decode steps and prefill chunk; the streams held against
   ``generate`` (``streams_vs_generate``: where a greedy stream parts,
   generate's logit gap must stay within ``PARTING_ULPS`` bf16 ulps of
   its top logit; phase 5's bf16 run is held the same way); the int8
   weights over int8 pools take the fused int8 V epilogue (G3 with its
   q8 epilogue a layer each step, the ``*_i8_q8`` launches exact), and
   the same run through quantize-on-write (the unfused arm, entered
   directly, ``UnfusedQ8``) must give the same streams token for token,
   each run's profiled decode step read (kernels and device time a
   step);
6q. phase 6b's speculative serve of each quantized model's own motif
   traffic (int8 weights over int8 pools, int4 over bf16 pools): every
   speculative stream token-identical to its plain stream, the
   projections' launches exact, ``window_op_bits`` empty over G4;
6d. draft-model speculation on the paged engine: every other request of
   phase 5's traffic (``CUT``: 6 of 12) and its engine with spec_k = 4
   and ``draft_block`` = the 8B model itself (its own contiguous slot
   cache of 1.07 GB, no second copy of the weights),
   over bf16 pools and over int8 ones: every stream, greedy and
   sampled, token-identical to phase 5's (5b's) plain stream, the
   greedy requests at 2 or more decode tokens a slot-iteration, the
   launches exact (K1 and K2 32 a target call or chunk, G1 161 a target
   or draft call); tokens a slot-iteration, the draft hit rate and the
   verify calls read;
6s. the slot engine at 8B (``ContinuousBatchingEngine``, 8 contiguous
   cache rows of 1024 positions, 1.07 GB): every other request of phase
   5's 12, the greedy streams held against ``generate`` by the C5 rule;
   then one motif request of each kind of phase 6b's (``MOTIF_CUT``: 6
   of 12) without speculation and with spec_k = 4, every
   speculative stream token-identical to its plain stream; G1 161 a step
   or verify call, no K1 or K2 (the slot path's attention is plain
   PyTorch, as the reference's is XLA's);
6t. beam search (4 beams) and ``SequenceSampler`` (4 samples) on the 8B
   model, one 64-token prompt and 16 new tokens: finite scores, rows
   sorted by score, the prompt kept, a seed reproducing its samples,
   and ``beam_size=1`` equal to greedy ``generate`` (one request: its
   count is not cut);
6h. the hierarchical prefix cache and sessions (``serve_sessions``) on
   phase 5's model cut to 4 of its 32 layers at full width
   (``CUT_DEPTH``, seed 0): 4 sessions of 3 turns (one 256-token
   system prompt, 64-192 tokens of each, every next turn the
   transcript and 64 new tokens; session 1 seeded-sampled; turn 1's
   first arrival alone), then a lull (a
   320-token prompt and 4 unrelated requests, then the prompt again),
   through seven engines on phase 5's settings: no hierarchy, H-dev
   (everything pinned), H-host (a 76-page pool, no pin budget, a 2 GiB
   host tier), H-host with ``overlap_swaps`` (80 pages), with spec_k = 4
   and spec_tree = (15, 2), and H-dev and H-host over int8 pools.  Every
   H-host stream token-identical to H-dev's (int8 to int8), their waves'
   prefill tokens and tokens avoided equal, 8 session hits in turns 2-3,
   every session restored at least once (H-host, int8 H-host), every
   spill stored (none dropped), deferred restores with ``overlap_swaps``,
   one
   ``serving.swap_in`` fault in H-host's turn 3 (one quarantine, one
   retry), the launches exact (K1 and K2 one a layer a step or chunk, G1
   5 a layer and the head a step, 3 a layer and the head fused), no
   page in use or pinned after ``close_session`` and
   ``drop_cache``; the greedy H-dev streams against ``generate`` by the
   C5 rule; the copies' device time and GB/s, the prefill time and
   tokens turns 2-3 avoided against the no-hierarchy engine; then 16
   seeded pages of bf16 and int8 pools read to host and written back
   into fresh pages, ``torch.equal``;
6e. tracing, live weight hot-swap and cancel: (a) phase 5's engine and
   traffic on the resident 8B model, untraced and under ``tracing()``
   and ``flight_recording()`` in turns, every stream token-identical to
   phase 5's and every run's launches phase 5's, each traced request's
   timeline from ``engine.admit`` to ``engine.finish``, no event
   dropped, one traced iteration under ``torch.profiler`` holding an
   ``engine.iteration`` range; the ms a decode step traced and untraced
   and the chrome trace's bytes; (b) after the 8B model is freed,
   ``llama_3_8b(depth_factor=0.125)`` in bf16 (full width, 4 of 32
   layers) on phase 5's settings: generation B (seed 1) written as the
   reference's checkpoint (float32 arrays pickled, ``write_verified``)
   into a temporary directory, ``adopt`` with 8 of phase 5's requests in
   flight (they finish equal to an engine that never adopts), the other
   4 after the install equal to a fresh engine on B, ``rollback`` back
   to A, a copy of B with three bytes flipped refused
   (``CorruptCheckpointError``) with the generation kept, and ``cancel``
   of an active request (its pages back, the others A's streams); the
   ms to read and verify, to place (GB/s) and to install, the stage →
   install iterations and the peak memory;
6r. the replica service layer (``mxtpu_torch.serving``): (a) after
   6e(a), on the resident 8B model, three paged replicas sharing it
   (phase 5's settings) behind a ``Gateway`` with the locality router
   serve phase 5's 12 requests three times (``replicas_run``): clean;
   faulted under one plan (``replica.health#r1`` declares r1 dead while
   it holds streams that have emitted tokens, its requests drained and
   requeued; one ``router.dispatch`` raise rerouted; one request hedged
   under a tick deadline; one low-class request shed by ``max_pending``
   and resubmitted after r1's probation revival, which serves it); and
   under an ``Autoscaler`` from 1 replica to 3 on the backlog and back
   to 1 after idle ticks.  Every completed stream token-identical to
   phase 5's, each stream's tokens its output's suffix, the dead and the
   retired replicas at zero pages and every replica at ``blocks_in_use
   == pinned_blocks``, the launches exact (K1 and K2 32 a replica step
   or chunk, G1 161 a step, 97 fused), one death, one revive and one
   reroute; wall ms a gateway tick against the replicas' step ms in it,
   TTFT ticks, death-to-requeue ticks, prefix hits a replica, the
   autoscaler's decisions and their ticks, the peak memory; one profiled
   pump holding a ``gateway.pump`` range; (b) after 6e(b), on its cut,
   two ``SubprocessReplica`` workers (``chip_smoke:replica_engine``,
   each building the cut from seed 0 on the card) behind a ``Gateway``
   serve phase 5's traffic while a ``transport.worker_death`` rule
   SIGKILLs r1 mid-decode; probation respawns it and it serves again;
   both shut down gracefully.  Every stream token-identical to
   generation A's in-process one (6e(b)'s first 8, the other 4 served
   here), the kill's exit code -9 and its requests requeued, the
   shutdowns' 0; each worker's spawn seconds, the median RPC ms of
   ``step`` and ``poll``, wall ms a tick against the in-process ms a
   step, the kill-to-requeue ticks;
6p. tensor parallelism (``mesh=make_mesh(tp=2)``,
   ``rules=transformer_lm_sharding_rules()``) after 6r(b), on its cut
   (``CUT_DEPTH``, seed 0): phase 5's 12 requests through in-process
   tp=1 engines over bf16 and int8 pools, and 6b's motif requests
   (``MOTIF_CUT``) plainly; then two ranks spawned on ``cuda:0`` (gloo,
   a file rendezvous; NCCL refuses two ranks on one GPU), each building
   the cut and keeping its shard (16 of the 32 query heads, 4 of the 8
   KV heads, the local halves of every projection), rank 0 running the
   engines and the other following it (``ShardedDecoder.follow``): the
   same traffic over bf16 and int8 pools, and the motif requests plainly
   and with spec_k = 4, spec_tree = (15, 2) over both.  Every tp=2
   greedy stream equals tp=1's or parts within ``PARTING_ULPS`` of
   tp=1's top logit (logged); every speculative tp=2 stream equals the
   plain tp=2 one; each rank's launches exact (K1 a layer a step, K2 a
   layer a chunk, G1 and the fused norm as phase 5 counts them) and its
   heads KV/2; layer 0's K1 (W = 1, the window, the tree) and K2 inputs,
   captured on rank 0 at the per-shard geometry over bf16 and int8
   pools, against their plain versions (K1 at W = 1 and K2 timed as the
   ``kernels`` rows ``paged_attention[tp=2]`` and
   ``paged_prefill[tp=2]``).  Logs each rank's ms a step and a chunk
   and decode tokens/s at tp=2 against tp=1, both sides on one clock
   (host wall time, the card synchronized before and after each step
   and chunk, no other instrumentation); then, from a second bf16 pass
   with every collective timed (the card synchronized around each),
   the ms a step and a chunk in collectives and that pass's own ms a
   step; the controller's broadcast ms a call, each rank's peak memory
   and the phase's seconds, with the card's name and power limit;
6m. Switch MoE serving at full width (``serve_moe_8b``):
   ``llama_3_8b(num_experts=8, capacity_factor=1.25)`` cut to 4 of its
   32 layers, bf16, seeded random weights, serving phase 5's traffic
   through the paged engine (each prompt one unpadded chunk), the slot
   engine and a paged engine built with spec_k = 4: no prefix shared,
   no draft, the spec_k engine's streams identical to the plain
   engine's, no page leaked, finite logits, K1, K2 and G1 launched
   (the ``moe_launches`` line); each engine's greedy streams against
   ``generate`` by C5's rule extended by routing
   (``moe_streams_vs_generate``: a stream may part where generate's
   logits near-tie or after a routing flip whose router gap lies
   within the one-ulp bound of its bf16 input, and every primary flip
   must lie within it; the routes are recorded in a second run of the
   paged and slot engines, whose streams must be the timed run's);
   decode ms a step, the routed FFN's ms a step (CUDA events in the
   bare run, and its profiler ranges' device time in one profiled
   step), the experts' float32 upcast bytes a call, prefill tokens/s,
   peak memory and the share of prompt tokens each layer's capacity
   dropped; K2 at the longest unpadded chunk becomes the ``kernels`` row
   ``paged_prefill[unbucketed,T=<n>]``, its launches the paged run's
   calls of K2's wrapper at that length;
7. layer 0's kernel inputs captured from the main runs (two prefill
   chunks, the first at position 256 or later and the last chunk of the
   longest prompt, at 576; one decode step, one linear verify window
   and one tree; over the bf16 pools and over the int8 ones): kernel
   against plain version on them, and the kernel, plain and library
   times (device time of a CUDA-graph replay, L2 flushed before each)
   at the main path's shapes; the library is a gather (and dequantize)
   then scaled_dot_product_attention.  K1's and K2's tensor-core routes
   (bf16 queries: ``mma.sync`` bf16, each key walk split over a
   thread-block cluster) must give the same bits on a second call, and
   their rows carry ``route`` and ``bound_tc_ms``, their operations alone
   at the bf16 tensor-core peak;
8. the flash-attention kernels (K3 forward, K4 dq, K5 dk/dv) against
   their plain versions, causal and not, at T = 128, 100 and 150
   (head_dim 16), (1, 3, 70, 72), (1, 2, 96, 256) and (1, 32, 2048,
   128), in float32 and bfloat16 (K4 and K5 not at head_dim 256 in
   float32, where one block cannot hold their tiles), and K4 and K5 on
   one-signed dO = |randn| at (1, 32, 2048, 128) float32, causal, where
   p >= 0 makes every term of dv one sign;
9. a small float32 model trained 3 Adam steps by ``SPMDTrainer`` on the
   card and on the CPU: the losses agree within 1e-4 relative;
10. the training main path: the full-width Llama-3-8B cut to 4 layers,
   float32, 1 warm-up and 5 counted steps on 1 x 2048 tokens; the flash
   launch counts must be 20 each and the dense rule must not fire;
   torch.profiler over one more step;
10m. Switch MoE training at full width: ``llama_3_8b(num_experts=8)``
   cut to one layer, float32, ``return_moe_aux``, one forward and
   backward (a finite aux, a nonzero gradient on the router and on every
   expert that received tokens), then SPMDTrainer with Adam and
   ``NextTokenLoss(moe_aux_weight=0.01)`` for 1 + 5 steps of phase 10's
   batch: K3-K5 launched once a step each, a finite loss that falls;
   ms a step and peak memory;
11. layer 0's flash inputs captured from the first counted step: kernel
   against plain version, and the kernel, plain and library times; each
   row also carries ``bound_tc_ms``, the bound of its 3xTF32 route on
   the tensor cores (three TF32 products at 495 TFLOP/s) beside
   ``bound_ms``, that of the same function in float32 on the CUDA cores;
   K4's and K5's rows carry ``bwd_ms``, the port's whole backward
   (delta, K4 and K5 through ``torch.autograd.grad``), timed as their
   ``library_ms`` (SDPA's whole backward) is, and K4 and K5 must give
   the same bits on a second call;
12. the conv backward kernel (K6) against its plain version at the test
   geometries and ResNet-50's three stage shapes at batch 128, in
   float32 and bfloat16, and on one-signed float32 inputs (x = |randn|
   + 1, dY = |randn|, as ResNet's post-ReLU activations are) at (128,
   16, 16, 56, 56), where each dW element sums 401,408 products of one
   sign: a tensor-core sum that drifts one way would show there;
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
   (cuDNN's convolution backward) times; each stage shape is a row of the
   ``kernels`` line (``conv_bwd[64x56x56]``, ``conv_bwd[128x28x28]``,
   ``conv_bwd[256x14x14]``) with its launches in phase 14 (3, 4 and 6 a
   step) and ``bound_tc_ms``, the bound of K6's 3xTF32 route on the
   tensor cores, beside ``bound_ms``;
16. int8 inference of phase 14's trained net: ``quantize_net`` with
   ``calib_mode="naive"`` over 2 batches of 32 synthetic 224x224 images
   (seed 1), then 1 warm-up and 5 counted forwards at batch 128 (seed
   2) and one profiled: exactly 53 Q1 launches a forward, 52 of them on
   the channels-last route (``qconv_nhwc``) and the stem on the stem's
   route (``qconv_stem``), 52 Q3 (``quantize_nhwc``) and 1 Q2, finite
   logits
   ``torch.equal`` to the plain route's (``PlainQuant``: Q1's, Q2's and
   Q3's plain versions in their wrappers' place), and the int8 logits'
   error against the float32 net's and their top-1 agreement logged;
17. one Q1 call per distinct conv geometry captured from phase 16 (20;
   each row's ``form`` its route, ``stem`` or ``nhwc``), one Q3 call per
   distinct input shape, and the Q2 call (its ``splits``, the blocks of
   a cluster that share a tile's K, and ``launch_floor_ms``, an empty
   kernel replayed from a captured graph in the same run), each
   ``torch.equal`` to its plain version, with the kernel, plain and
   library times (Q2, and Q1's 1x1 stride-1 convs on their
   channels-last payload viewed (N*H*W, C): ``torch._int_mm`` and the
   same epilogue; Q1's other convs: cuDNN's bf16 convolution of the same
   shape and layout, labelled, as no PyTorch call computes an int8
   convolution on CUDA; cuDNN's time stands beside ``_int_mm``'s as
   ``cudnn_bf16_ms`` too; Q3: none, its plain version is the torch
   chain the net ran before it).

Each phase's seconds are logged (``phase_seconds``).

The second-to-last line is ``{"kernels": [...]}`` (K1's verify and tree
inputs as rows of their own, ``paged_attention[W=8]`` and
``paged_attention[tree,W=16]``, the int8 forms as
``paged_attention[int8]``, ``paged_attention[int8,W=8]``,
``paged_attention[int8,tree,W=16]`` and ``paged_prefill[int8]``, K1
and K2 at phase 6p's per-shard geometry as ``paged_attention[tp=2]`` and
``paged_prefill[tp=2]`` (launches: rank 0's in 6p's bf16 run), K2 at
the long chunk as ``paged_prefill[long]`` and ``paged_prefill[int8,long]``
(launches: the main runs' K2 calls at 512 or later), G1
as one row per projection and row count, ``rows_linear[qkv,M=8]``,
``rows_linear[qkv,M=64]``, ``rows_linear[qkv,M=128]`` ... (launches: at
M = 8 phase 5's, at 64 and 128 phase 6b's windows and trees), the
fused norm the same way for its four projections,
``rows_norm_linear[qkv,M=8]`` ..., G2 as ``rows_rms_norm[M=8]`` (no
launch on the main path since the fused norm took its place), G3 and
G4 the same way as G1 and the fused norm, ``rows_linear_i8[qkv,M=8]``,
``rows_norm_linear_i4[lm_head,M=128]`` ... (launches: phases 5q and 6q,
M = 64 from prefill chunks and W = 8 windows; a fused row at 64 rows
that the motif traffic never launched is left out), each with its
``library`` label, G3's q8 epilogue as ``rows_linear_i8_q8[qkv,M=8]``
... and ``rows_norm_linear_i8_q8[qkv,M=8]`` ... (launches: phases 5q
and 6q over int8 pools, every one norm-fused), K6 as
one row per stage shape, and Q1 as one row per conv geometry,
``qconv[3->64,7x7s2,224]`` ... (``form``: ``nhwc``, or ``stem`` for
the stem's kernel), Q3 as one row per input shape,
``quantize_nhwc[64x56x56]`` ..., and Q2 as ``qfc[128x2048->1000]``
(with ``splits`` and ``launch_floor_ms``; launches: phase 16's, each
with its ``library`` label and ``tolerance`` "torch.equal")); the last
line is
``{"ok": true, "device": {...}}``.  The script needs one CUDA card and
exits non-zero without one.

Tolerances (kernel against plain version, max absolute error): 2e-5 in
float32, where the two differ only in the order of their sums; 2e-2 in
bfloat16, where each rounds its float32 result to bfloat16 (one bf16
ulp is 2**-7 relative) after sums taken in other orders.  G1 is held
relative to its largest output (``GRAD_TOL``): its outputs reach |y| of
several units, where one bf16 ulp exceeds 2e-2.  The flash
gradients (dq, dk, dv) and K6's are held relative to their largest
element (``GRAD_TOL``), since their size follows dO's, which the training
loss makes tiny; K6's float32 dW to 1e-4 of it (``DW_TOL``), since each
element sums up to N*H*W = 401,408 products in another order on each
side, and the rounding error of a sum of random-sign terms grows as
about 2**-24 * sqrt(N*H*W) of its largest partial sum (4e-5 there).
Q1 and Q2 are exact: their int32 sums are the plain version's in any
order, and their epilogue rounds each step once as the plain version's
separate torch ops do, so they are held by ``torch.equal``; so is Q3,
which rounds each step of the torch chain once, as it does.
"""

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from mxtpu_torch.parallel.trainer import (  # noqa: E402
    NextTokenLoss, synthetic_batches)

#: NVIDIA H100 SXM data sheet: HBM3 bytes/s and dense peak operations/s
#: by input type (bf16 and int8 on the tensor cores, float32 on the CUDA
#: cores)
H100_BYTES_PER_S = 3.35e12
H100_PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
                 torch.int8: 1979e12}
#: dense TF32 on the tensor cores: a 3xTF32 product is three TF32 products
H100_TF32_OPS = 495e12
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
#: the depth of phases 5q/6q and 6h: full width, 4 of 32 layers (the cut
#: of phases 6e(b), 6r(b) and 10).  Serving runs at the host's pace,
#: about 2000 launches a full-depth step, and at full depth these two
#: phases took 326 s and 166 s of a 990 s run against the 1200 s limit;
#: phase 5 holds the main path at full depth
CUT_DEPTH = 0.125
KERNEL_SOURCES = {
    "paged_attention": ("mxtpu_torch/csrc/paged_attention.cu",
                        "mxtpu/ops/pallas/paged_attention.py:117"),
    "paged_prefill": ("mxtpu_torch/csrc/prefill_attention.cu",
                      "mxtpu/ops/pallas/prefill_attention.py:113"),
    "rows_linear": ("mxtpu_torch/csrc/rows_linear.cu",
                    "none: no pallas_call (XLA's dot in "
                    "mxtpu/models/transformer.py); repairs the port's "
                    "row-count-dependent rounding"),
    "rows_rms_norm": ("mxtpu_torch/csrc/rows_linear.cu",
                      "none: no pallas_call (XLA's rms_norm in "
                      "mxtpu/ops/contrib.py); repairs the port's "
                      "row-count-dependent rounding"),
    "rows_norm_linear": ("mxtpu_torch/csrc/rows_linear.cu",
                         "none: no pallas_call (XLA's rms_norm and dot in "
                         "mxtpu/models/transformer.py); G2 fused into G1, "
                         "the port's row-invariant repair"),
    "rows_linear_i8": ("mxtpu_torch/csrc/rows_linear.cu",
                       "none: no pallas_call (XLA's dot_general in "
                       "mxtpu/contrib/quantization.py:124, wq_matmul_i8); "
                       "G1 reading int8 weights, row-invariant"),
    "rows_linear_i4": ("mxtpu_torch/csrc/rows_linear.cu",
                       "none: no pallas_call (XLA's einsum in "
                       "mxtpu/contrib/quantization.py:173, wq_matmul_i4); "
                       "G1 reading packed int4 weights, row-invariant"),
    "rows_norm_linear_i8": ("mxtpu_torch/csrc/rows_linear.cu",
                            "none: no pallas_call (XLA's rms_norm and "
                            "mxtpu/contrib/quantization.py:124); G2 fused "
                            "into G3"),
    "rows_norm_linear_i4": ("mxtpu_torch/csrc/rows_linear.cu",
                            "none: no pallas_call (XLA's rms_norm and "
                            "mxtpu/contrib/quantization.py:173); G2 fused "
                            "into G4"),
    "rows_linear_i8_q8": ("mxtpu_torch/csrc/rows_linear.cu",
                          "none: no pallas_call (XLA's dot_general and "
                          "_q8_quantize in mxtpu/contrib/quantization.py:"
                          "144, wq_matmul_i8_q8); G3 with the int8 KV "
                          "cache's quantizer as its epilogue"),
    "rows_norm_linear_i8_q8": ("mxtpu_torch/csrc/rows_linear.cu",
                               "none: no pallas_call (XLA's rms_norm and "
                               "mxtpu/contrib/quantization.py:144); G2 "
                               "fused into G3 with the q8 epilogue"),
    "flash_fwd": ("mxtpu_torch/csrc/flash_attention.cu",
                  "mxtpu/ops/pallas/flash_attention.py:107"),
    "flash_dq": ("mxtpu_torch/csrc/flash_attention.cu",
                 "mxtpu/ops/pallas/flash_attention.py:202"),
    "flash_dkv": ("mxtpu_torch/csrc/flash_attention.cu",
                  "mxtpu/ops/pallas/flash_attention.py:246"),
    "conv_bwd": ("mxtpu_torch/csrc/conv_bwd.cu",
                 "mxtpu/ops/pallas/conv_bwd.py:101"),
    "qconv": ("mxtpu_torch/csrc/quantized.cu",
              "none: no pallas_call (XLA's int8 conv_general_dilated with "
              "int32 sums in mxtpu/contrib/quantization.py:81, "
              "quantized_conv)"),
    "qfc": ("mxtpu_torch/csrc/quantized.cu",
            "none: no pallas_call (XLA's int8 dot_general with int32 sums "
            "in mxtpu/contrib/quantization.py:62, "
            "quantized_fully_connected)"),
    "quantize_nhwc": ("mxtpu_torch/csrc/quantized.cu",
                      "none: no pallas_call (XLA's elementwise divide, "
                      "round, clip and cast in mxtpu/contrib/"
                      "quantization.py:42-52, quantize_v2); Q1's "
                      "channels-last input in one pass"),
}
#: flash kernels against plain versions: (B, H, T, D), one shape of each
#: head_dim class of the kernels (up to 64, 128 and 256)
FLASH_SHAPES = [(2, 2, 128, 16), (2, 2, 100, 16), (2, 2, 150, 16),
                (1, 3, 70, 72), (1, 2, 96, 256), (1, 32, 2048, 128)]
#: the training main path: Llama-3-8B at full width, 4 of 32 layers
TRAIN = dict(depth_factor=0.125, batch=1, seq=2048, lr=3e-4, warmup=1,
             steps=5)
#: K6 against its plain version, (N, Ci, Co, H, W): the test geometries
#: and ResNet-50 v1's three stage shapes at batch 128
CONV_SHAPES = [(2, 16, 32, 8, 8), (1, 32, 32, 14, 14), (2, 8, 24, 7, 9),
               (128, 64, 64, 56, 56), (128, 128, 128, 28, 28),
               (128, 256, 256, 14, 14)]
#: K6 on one-signed float32 inputs at stage 1's pixel count
CONV_ONE_SIGNED = (128, 16, 16, 56, 56)
#: the example's optimizer (examples/gluon/image_classification.py)
SGD_PARAMS = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
#: the narrow ResNet-v1 of tests/test_torch_resnet.py
SMALL_RESNET = dict(layers=[1, 1, 1, 1], channels=[16, 32, 64, 128, 256],
                    classes=10, batch=4, size=64, steps=3, seed=1,
                    eligible=4)
#: the vision main path: ResNet-50 v1, 13 of its 16 3x3 convs take K6
RESNET = dict(batch=128, size=224, classes=1000, seed=0, warmup=1, steps=5,
              eligible=13)
#: int8 inference of phase 14's net: calibration batches (seed 1), the
#: test batch (seed 2), and Q1's and Q2's launches a forward
QUANT = dict(calib_batches=2, calib_batch=32, calib_seed=1, seed=2,
             batch=128, warmup=1, forwards=5, qconv=53, qconv_nhwc=52,
             qconv_stem=1, quantize_nhwc=52, qfc=1)
#: ResNet-50 v1's 20 distinct conv geometries (C_in, C_out, kernel,
#: stride, pad, input size) at 224x224 and Q1's launches a forward at
#: each; phase 16 holds the net's launches to it
RESNET50_QCONV = [
    ((3, 64, 7, 2, 3, 224), 1), ((64, 64, 1, 1, 0, 56), 1),
    ((64, 64, 3, 1, 1, 56), 3), ((64, 256, 1, 1, 0, 56), 4),
    ((256, 64, 1, 1, 0, 56), 2), ((256, 128, 1, 2, 0, 56), 1),
    ((128, 128, 3, 1, 1, 28), 4), ((128, 512, 1, 1, 0, 28), 4),
    ((256, 512, 1, 2, 0, 56), 1), ((512, 128, 1, 1, 0, 28), 3),
    ((512, 256, 1, 2, 0, 28), 1), ((256, 256, 3, 1, 1, 14), 6),
    ((256, 1024, 1, 1, 0, 14), 6), ((512, 1024, 1, 2, 0, 28), 1),
    ((1024, 256, 1, 1, 0, 14), 5), ((1024, 512, 1, 2, 0, 14), 1),
    ((512, 512, 3, 1, 1, 7), 3), ((512, 2048, 1, 1, 0, 7), 3),
    ((1024, 2048, 1, 2, 0, 14), 1), ((2048, 512, 1, 1, 0, 7), 2)]
#: the input shapes (C, H = W) that Q3 quantizes (every conv's but the
#: stem's) and its launches a forward at each
RESNET50_Q3 = [((64, 56), 8), ((256, 56), 4), ((128, 28), 8),
               ((512, 28), 5), ((256, 14), 12), ((1024, 14), 7),
               ((512, 7), 6), ((2048, 7), 2)]
#: Q1's library yardstick: no PyTorch call computes an int8 convolution
#: on CUDA, so cuDNN's bf16 one of the same shape and layout (int8 values
#: are exact in bf16); a 1x1 stride-1 conv on a channels-last payload is
#: one int8 product, ``torch._int_mm``, plus the epilogue
QCONV_LIBRARY = ("cuDNN bf16 F.conv2d of the same shape and layout (int8 "
                 "exact in bf16)")
QCONV_INT_MM = ("torch._int_mm on the channels-last payload viewed "
                "(N*H*W, C) + the epilogue")
#: Q3's library yardstick, timed only: PyTorch's one-call quantizer on
#: the same values already stored channels-last; its bits differ from
#: the reference's near half-steps of x / scale (it multiplies by the
#: scale's reciprocal) and below -127 (its range reaches -128)
Q3_LIBRARY = ("torch.quantize_per_tensor(x, scale, 0, torch.qint8) on x "
              "stored channels-last (timed only: rounds x * (1 / scale), "
              "floor -128)")
#: phases 6d and 6s serve every other request of phase 5's traffic
#: (greedy and sampled, with and without the shared prefix)
CUT = slice(None, None, 2)
#: phase 6s serves 6 of the 12 motif requests, one of each kind
#: (``motif_kwargs``): greedy tree, sampled tree, penalized tree, sampled
#: linear, greedy linear, not speculating
MOTIF_CUT = (0, 2, 4, 7, 8, 11)


def log(**fields):
    print(json.dumps(fields), flush=True)


# -- timing and work accounting ---------------------------------------------

class _L2Flush:
    """Reads 64 MB between timed launches, more than the H100's 50 MB
    L2, so each launch finds its inputs in device memory as it does on
    the serving path (the next layer's pages are another pool).  A read
    leaves L2 holding clean lines only: a flush that writes (the
    script's earlier flush zeroed the buffer) leaves up to 50 MB of
    dirty lines, whose write-back then falls inside the timed window."""

    def __init__(self):
        self.buf = torch.ones(16 << 20, dtype=torch.float32, device="cuda")

    def __call__(self):
        self.buf.sum()


class _L2FlushByWrite(_L2Flush):
    """The script's earlier flush, kept only to show its floor
    (``timing_floor``): it writes the 64 MB."""

    def __call__(self):
        self.buf.zero_()


def timing_floor():
    """The timing floor under each flush: an empty captured graph, and
    G2 on 8 rows of 4096 bf16 values (64 KB read), in milliseconds."""
    from mxtpu_torch.ops import contrib

    x = torch.randn(8, 4096, device="cuda", dtype=torch.bfloat16)
    gamma = torch.ones(4096, device="cuda")
    out = {}
    for name, flush in (("write_flush", _L2FlushByWrite()),
                        ("read_flush", _L2Flush())):
        out[name] = dict(
            empty_graph_ms=cuda_ms(lambda: None, flush),
            rows_rms_norm_8x4096_ms=cuda_ms(
                lambda: contrib.rows_rms_norm(x, gamma), flush))
        del flush
    log(phase="timing_floor", **out)


def cuda_ms(fn, flush, iters=20):
    """Mean device milliseconds of ``fn``: its launches are captured once
    in a CUDA graph, so the host's launch gaps do not count, and the
    graph is replayed between CUDA events, the L2 flushed (``_L2Flush``)
    before each replay."""
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


def attended_keys(pos, W, anc=None):
    """(B, W) keys each window lane attends: pos + w + 1 on a linear
    window, pos + popcount(anc[b, w]) + 1 on a tree."""
    p = pos.long().reshape(-1, 1)
    if anc is None:
        return p + torch.arange(W, device=pos.device)[None, :] + 1
    bits = anc.long()
    pop = sum((bits >> i) & 1 for i in range(32))
    return p + pop + 1


def key_bytes(pool_k):
    """Bytes one key (or value) row of one kv head costs in the pool: D
    elements of the pool's own type, plus a 4-byte scale for int8."""
    D = pool_k.shape[-1]
    return D * pool_k.element_size() + (4 if pool_k.dtype == torch.int8
                                        else 0)


def decode_work(q, pool_k, tables, pos, anc=None):
    """Bytes and operations a decode or verify call needs on these
    inputs: q (and anc) read and out written once, each slot's keys and
    values 0..pos[b]+W-1 read once (at the pool's bytes per row, scales
    included), 4 operations per (lane, attended key, d) for the scores
    and the sum."""
    B, H, W, D = q.shape
    KV = pool_k.shape[1]
    keys = int((pos.long() + W).sum())
    nbytes = (2 * q.numel() * q.element_size()
              + keys * KV * 2 * key_bytes(pool_k)
              + 4 * (tables.numel() + pos.numel())
              + (0 if anc is None else 4 * anc.numel()))
    attended = int(attended_keys(pos, W, anc).sum())
    return nbytes, 4 * attended * H * D


def prefill_work(q, pool_k, table, start):
    """The same for one prefill chunk: keys 0..start+T-1 read once, lane
    t of the chunk attending start+t+1 keys."""
    _, H, T, D = q.shape
    KV = pool_k.shape[1]
    nbytes = (2 * q.numel() * q.element_size()
              + (start + T) * KV * 2 * key_bytes(pool_k)
              + 4 * table.numel())
    attended = T * (start + 1) + T * (T - 1) // 2
    return nbytes, 4 * attended * H * D


def verify_mask(pos, W, T, anc=None):
    """(B, 1, W, T) boolean mask of K1's lanes: key t <= pos + w, or with
    ``anc`` the history, the lane itself and its ancestors."""
    t = torch.arange(T, device=pos.device)[None, None, :]
    p = pos.long()[:, None, None]
    w = torch.arange(W, device=pos.device)[None, :, None]
    if anc is None:
        return (t <= p + w)[:, None]
    rel = t - p
    bit = (anc.long()[:, :, None] >> rel.clamp(0, 31)) & 1
    return ((rel < 0) | (rel == w)
            | ((rel >= 0) & (rel < W) & (bit == 1)))[:, None]


def library_pages(pool, scales, tables, dtype):
    """A table's pages in sequence order for the yardstick: gathered,
    and for an int8 pool dequantized, in ``dtype``."""
    from mxtpu_torch.ops.tensor import (paged_cache_gather,
                                        paged_cache_gather_q8)

    if scales is None:
        return paged_cache_gather(pool, tables)
    return paged_cache_gather_q8(pool, scales, tables).to(dtype)


def library_decode(q, pool_k, pool_v, tables, pos, anc=None, k_scales=None,
                   v_scales=None):
    """The yardstick: gather each slot's pages (and dequantize an int8
    pool), then PyTorch's scaled_dot_product_attention over them with
    K1's boolean mask (never called by the port)."""
    k = library_pages(pool_k, k_scales, tables, q.dtype)  # (B, KV, M*bs, D)
    v = library_pages(pool_v, v_scales, tables, q.dtype)
    mask = verify_mask(pos, q.shape[2], k.shape[2], anc)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def library_prefill(q, pool_k, pool_v, table, start, k_scales=None,
                    v_scales=None):
    k = library_pages(pool_k, k_scales, table, q.dtype)[None]
    v = library_pages(pool_v, v_scales, table, q.dtype)[None]
    qpos = start + torch.arange(q.shape[2], device=q.device)
    mask = torch.arange(k.shape[2], device=q.device)[None, :] <= qpos[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


# -- the training path's data and loss ----------------------------------------

# synthetic_batches and NextTokenLoss: the reference training example's
# data and loss, from mxtpu_torch.parallel.trainer (imported above)


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

def card_line():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card():
    line = card_line()
    print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(phase="device", torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return line


#: the weight types of rows_linear.cu's bf16 kernel (its first template
#: argument): G3's and G4's names
WQ_TYPES = {1: "rows_linear_i8", 2: "rows_linear_i4"}
#: quantized.cu's Q1, Q2 and Q3 kernels by their names in ptxas's report
Q_KERNELS = {"qconv_nhwc_kernel": "qconv[nhwc]",
             "qconv_stem_kernel": "qconv[stem]",
             "qconv_kernel": "qconv[nchw]",
             "qfc_kernel": "qfc",
             "quantize_nhwc_kernel": "quantize_nhwc"}


def quant_kernel_registers(ptxas_log):
    """[{kernel, template, gain, registers, spill_stores, spill_loads}]
    of every G3 and G4 instantiation of the bf16 kernel in ``ptxas -v``'s
    report of rows_linear.cu (template: its integer arguments WT, CW,
    NGW, STAGES, WR; gain: none, bf16 or float32, the fused norm's), of
    each instantiation of the q8 epilogue they call (its frame and
    spills; no registers of its own), and, in quantized.cu's report, of
    every instantiation of Q1's three kernels (template: BM, BN, or BN,
    or none for the stem's), of Q2's and of Q3's."""
    out, cur, entry = [], None, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m and m.group(1) != entry:
            # a function the kernels call (G3's q8 epilogue): its own
            # record, so its frame never stands for the last kernel's
            cur = None
            if "q8_epilogue" in m.group(1):
                cur = dict(kernel="q8_epilogue", template=[], gain="none")
                out.append(cur)
            continue
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            cur, entry = None, m.group(1)
            q = re.search(r"\d(%s)(?:I((?:Li\d+E)+)E)?"
                          % "|".join(Q_KERNELS), m.group(1))
            if q:
                cur = dict(kernel=Q_KERNELS[q.group(1)], template=[
                    int(v) for v in re.findall(r"Li(\d+)E",
                                               q.group(2) or "")],
                    gain="none")
                out.append(cur)
                continue
            k = re.search(r"rows_linear_bf16_kernelI((?:Li\d+E)+)(\w*?)EEv",
                          m.group(1))
            if k:
                args = [int(v) for v in re.findall(r"Li(\d+)E", k.group(1))]
                if args[0] in WQ_TYPES:
                    gain = k.group(2)
                    cur = dict(kernel=WQ_TYPES[args[0]], template=args,
                               gain="none" if "NoNorm" in gain else
                               "bf16" if "bfloat16" in gain else "float32")
                    out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def build():
    from mxtpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(phase="build", seconds=time.perf_counter() - t0,
        per_source={k: v["seconds"] for k, v in built.items()})
    for name, res in built.items():
        for line in res["log"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "smem", "spill")):
                print("ptxas[%s] %s" % (name, line.strip()), flush=True)
    # G3's, G4's, Q1's, Q2's and Q3's registers and spills, from ptxas's
    # report of this build: every instantiation must keep its
    # accumulators in registers
    for src, what in (("rows_linear", "G3/G4"), ("quantized", "Q1-Q3")):
        if src not in built:
            log(phase="build", quant_kernels="%s not built in this run"
                % what)
            continue
        kernels = quant_kernel_registers(built[src]["log"])
        for k in kernels:
            log(phase="build", **k)
        spilled = [k for k in kernels
                   if k.get("spill_stores", 1) or k.get("spill_loads", 1)]
        if not kernels or spilled:
            raise AssertionError("%s kernels spill registers (or ptxas "
                                 "reported none): %s"
                                 % (what, spilled or kernels))


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


def q8_case(args):
    """A float kernel case's pools quantized per row into int8 payloads
    and scales (the cache's own quantizer): (args, scale keywords)."""
    from mxtpu_torch.ops.tensor import _q8_quantize

    (pk, ks), (pv, vs) = _q8_quantize(args[1]), _q8_quantize(args[2])
    return ((args[0], pk, pv) + tuple(args[3:]),
            dict(k_scales=ks, v_scales=vs))


def measure(name, args, flush, timed=True, kw=None):
    """Kernel against plain version on ``args`` and the keywords ``kw``
    (K1's tree ``anc``, an int8 pool's scales); with ``timed`` also the
    kernel, plain and library times and the bound."""
    from mxtpu_torch.ops import paged_attention as pa
    from mxtpu_torch.ops import prefill_attention as pf

    kw = kw or {}
    args = tuple(args)
    if name.startswith("paged_attention"):
        kernel, plain, library = (pa.paged_decode_attention,
                                  pa.paged_decode_attention_plain,
                                  library_decode)
        work = decode_work(args[0], args[1], args[3], args[4],
                           kw.get("anc"))
    else:
        kernel, plain, library = (pf.paged_prefill_attention,
                                  pf.paged_prefill_attention_plain,
                                  library_prefill)
        work = prefill_work(args[0], args[1], args[3], args[4])
    kernel, plain, library = (
        (lambda *a, f=f: f(*a, **kw)) for f in (kernel, plain, library))
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
    tc = (pa if name.startswith("paged_attention")
          else pf).route(args[0]) == pa.TENSOR_CORES
    if tc:
        # K1's and K2's tensor-core routes: the same inputs give the same
        # bits
        res["route"] = pa.TENSOR_CORES
        if not torch.equal(kernel(*args), got):
            raise AssertionError("%s gave other bits on a second call (%s)"
                                 % (name, tuple(args[0].shape)))
    if timed:
        res["ms"] = cuda_ms(lambda: kernel(*args), flush)
        res["plain_ms"] = cuda_ms(lambda: plain(*args), flush)
        res["library_ms"] = cuda_ms(lambda: library(*args), flush)
        res["bound_ms"], res["bound_by"] = bound(work[0], work[1], dtype)
        if tc:
            # its operations alone at the bf16 tensor-core peak
            res["bound_tc_ms"] = work[1] / H100_PEAK_OPS[torch.bfloat16] * 1e3
    return res


#: K1's verify window and tree geometries: (name, dict) as decode_case
#: takes them; llama_3_8b's holds more lanes than one block from W = 16
VERIFY_GEOMS = [
    ("D64-bs8-rep1", dict(D=64, bs=8, KV=2, rep=1, B=4, ctx=200)),
    ("D128-bs16-rep4", dict(LLAMA_8B)),
    ("D128-bs32-rep8", dict(D=128, bs=32, KV=2, rep=8, B=3, ctx=300)),
]
VERIFY_WIDTHS = (2, 4, 8, 16, 32)


def tree_anc(rng, B, W, chain=False):
    """(B, W) int32 numpy strict-ancestor bitmasks of seeded branchy
    trees in window-lane order (each lane's parent one of the 3 lanes
    before it), or of the degenerate chain anc[b, w] = (1 << w) - 1."""
    anc = np.zeros((B, W), np.int64)
    for b in range(B):
        for w in range(1, W):
            p = w - 1 if chain else int(rng.randint(max(0, w - 3), w))
            anc[b, w] = anc[b, p] | (1 << p)
    return anc.astype(np.int32)


def verify_kernels_against_plain(quant=False):
    """K1's verify window (W = 2..32) and tree mask against the plain
    version, float32 and bfloat16 queries (over int8 pools and their
    scales with ``quant``), and its two bit-exact invariants: (a) a
    degenerate-chain anc gives the bits of no anc; (b) lane w of a
    W-lane linear call equals a W = 1 call at pos + w."""
    from mxtpu_torch.ops import paged_attention as pa

    worst = 0.0
    for gname, geom in VERIFY_GEOMS:
        for dtype in (torch.float32, torch.bfloat16):
            for W in VERIFY_WIDTHS:
                rng = np.random.RandomState(W)
                case = dict(geom, ctx=geom["ctx"] + W)
                q, pk, pv, tables, pos = decode_case(case, dtype, seed=W)
                B, H = q.shape[:2]
                # every live slot's table covers its window
                pos = torch.clamp(pos - W, min=0)
                pos[1] = 0
                q = torch.randn(B, H, W, q.shape[-1], device="cuda",
                                dtype=dtype, generator=torch.Generator(
                                    device="cuda").manual_seed(W))
                kw = {}
                if quant:
                    (q, pk, pv, tables, pos), kw = q8_case(
                        (q, pk, pv, tables, pos))
                errs = {}
                lin = pa.paged_decode_attention(q, pk, pv, tables, pos, **kw)
                for kind, anc in (("linear", None),
                                  ("tree", tree_anc(rng, B, W)),
                                  ("chain", tree_anc(rng, B, W, True))):
                    if anc is not None:
                        anc = torch.from_numpy(anc).cuda()
                    got = lin if anc is None else \
                        pa.paged_decode_attention(q, pk, pv, tables, pos,
                                                  anc=anc, **kw)
                    want = pa.paged_decode_attention_plain(
                        q, pk, pv, tables, pos, anc=anc, **kw)
                    torch.cuda.synchronize()
                    errs[kind] = float((got.float() - want.float())
                                       .abs().max())
                    if not errs[kind] <= TOL[dtype]:
                        raise AssertionError(
                            "K1 %s W=%d disagrees with its plain version: "
                            "%g > %g (%s, %s)" % (kind, W, errs[kind],
                                                  TOL[dtype], gname, dtype))
                    if kind == "chain" and not torch.equal(got, lin):
                        raise AssertionError(
                            "K1 invariant (a): a chain anc changed the "
                            "bits (W=%d, %s, %s)" % (W, gname, dtype))
                for w in range(W):
                    one = pa.paged_decode_attention(
                        q[:, :, w:w + 1].contiguous(), pk, pv, tables,
                        pos + w, **kw)
                    if not torch.equal(one, lin[:, :, w:w + 1]):
                        raise AssertionError(
                            "K1 invariant (b): lane %d of a W=%d window "
                            "differs from a W=1 call at pos+%d (%s, %s)"
                            % (w, W, w, gname, dtype))
                worst = max(worst, max(e / TOL[dtype]
                                       for e in errs.values()))
                log(phase="verify_vs_plain", geometry=gname,
                    dtype=str(dtype).split(".")[1], W=W,
                    pools="int8" if quant else "float",
                    lanes=H // pk.shape[1] * W, max_abs_err=errs,
                    invariants="a,b bit-exact")
    return worst


def kernels_against_plain(flush, quant=False):
    """K1 (W = 1) and K2 against their plain versions at the test and
    the 8B geometry, float32 and bfloat16 queries, over float pools or
    (``quant``) int8 pools with their scales."""
    for gname, geom in (("tiny", TINY), ("D8", dict(TINY, D=8)),
                        ("llama_3_8b", LLAMA_8B)):
        for dtype in (torch.float32, torch.bfloat16):
            for seed in (0, 1):
                for name, case in (("paged_attention", decode_case),
                                   ("paged_prefill", prefill_case)):
                    args, kw = case(geom, dtype, seed), {}
                    if quant:
                        args, kw = q8_case(args)
                        name += "[int8]"
                    res = measure(name, args, flush, timed=seed == 0, kw=kw)
                    log(phase="kernel_vs_plain", kernel=name,
                        geometry=gname, dtype=str(dtype).split(".")[1],
                        shape=list(args[0].shape), seed=seed, **res)


#: chunk lengths off K2's power-of-two ladder, as a routed (MoE) model's
#: unpadded prefill gives them (phase 6m: one chunk a prompt)
UNBUCKETED_T = (1, 37, 97, 641)


def prefill_unbucketed_against_plain(flush):
    """K2 at ``UNBUCKETED_T``, the 8B geometry and a chunk starting
    mid-page: float32 and bfloat16 queries (the walk and the tensor-core
    route), over float pools and over int8 pools with their scales,
    each within TOL of the plain version (``measure``, untimed; the
    tensor-core route gives the same bits on a second call)."""
    for T in UNBUCKETED_T:
        geom = dict(LLAMA_8B, T=T, ctx=max(LLAMA_8B["ctx"], 2 * T))
        for dtype in (torch.float32, torch.bfloat16):
            for quant in (False, True):
                args, kw = prefill_case(geom, dtype, seed=T), {}
                name = "paged_prefill"
                if quant:
                    args, kw = q8_case(args)
                    name += "[int8]"
                res = measure(name, args, flush, timed=False, kw=kw)
                log(phase="kernel_vs_plain_unbucketed", kernel=name,
                    dtype=str(dtype).split(".")[1], T=T, start=args[4],
                    shape=list(args[0].shape), **res)


#: the decode step's six projections of llama_3_8b, as (name, N, K)
PROJECTIONS = [("qkv", 6144, 4096), ("out_proj", 4096, 4096),
               ("gate_proj", 14336, 4096), ("up_proj", 14336, 4096),
               ("down_proj", 4096, 14336), ("lm_head", 128256, 4096)]


def linear_err(x, w):
    """G1 against its plain version on (x, w): the max abs error and
    that error over its bound, ``GRAD_TOL`` times max |plain| (two
    roundings of float32 sums taken in other orders differ by at most
    one ulp of the output's type at the largest output)."""
    from mxtpu_torch.ops import linear

    got = linear.rows_linear(x, w)
    want = linear.rows_linear_plain(x, w)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = GRAD_TOL[x.dtype] * float(want.float().abs().max())
    if not err <= tol:
        raise AssertionError("rows_linear disagrees with its plain version: "
                             "max abs error %g > %g (%s, x %s, w %s)"
                             % (err, tol, x.dtype, tuple(x.shape),
                                tuple(w.shape)))
    return got, err, err / tol


def rows_invariant(x, w, got):
    """G1's guarantee on (x, w) and its output ``got``: each row of an
    8-row and a 64-row call, and of a call on the rows in reverse order,
    is bit-identical to that row of the full call."""
    from mxtpu_torch.ops import linear

    part = [linear.rows_linear(x[:m].contiguous(), w) for m in (8, 64)]
    rev = linear.rows_linear(x.flip(0).contiguous(), w)
    if not (all(torch.equal(p, got[:p.shape[0]]) for p in part)
            and torch.equal(rev.flip(0), got)):
        raise AssertionError("rows_linear rounds a row by the row count or "
                             "position (x %s, w %s, %s)"
                             % (tuple(x.shape), tuple(w.shape), x.dtype))


def linear_against_plain(flush):
    """G1 at the 8B projections, bfloat16, M = 8 (the decode step), 64
    and 128 (an 8-slot W = 8 and W = 16 window) with its rows invariant;
    ragged M and float32 at small shapes.  Returns {(projection, M):
    timed result} for the kernels line."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for M, N, K, dtype in ((1, 96, 64, torch.float32),
                           (17, 200, 32, torch.float32),
                           (9, 64, 172, torch.float32),
                           (7, 130, 72, torch.bfloat16),
                           (33, 4096, 512, torch.bfloat16),
                           (200, 4096, 520, torch.bfloat16)):
        x = torch.randn(M, K, device="cuda", dtype=dtype, generator=g)
        w = torch.randn(N, K, device="cuda", dtype=dtype, generator=g)
        got, err, ratio = linear_err(x, w)
        rows_invariant(x, w, got)
        log(phase="linear_vs_plain", M=M, N=N, K=K,
            dtype=str(dtype).split(".")[1], max_abs_err=err,
            err_over_tol=ratio)
    results = {}
    for name, N, K in PROJECTIONS:
        w = torch.randn(N, K, device="cuda", dtype=torch.bfloat16,
                        generator=g) * 0.02
        x = torch.randn(128, K, device="cuda", dtype=torch.bfloat16,
                        generator=g)
        full, err, ratio = linear_err(x, w)
        rows_invariant(x, w, full)
        for M in (8, 64, 128):
            xm = x[:M].contiguous()
            res = measure_linear(xm, w, flush)
            log(phase="linear_vs_plain", projection=name, M=M, N=N, K=K,
                dtype="bfloat16", **res)
            results[name, M] = res
        del w, x
    return results


def norm_against_plain(flush):
    """G2, the row-invariant RMSNorm, against its plain version (the
    port's rms_norm) at the small models' widths and the 8B's, float32
    and bfloat16, held relative to its largest output (``GRAD_TOL``), and
    its guarantee by ``torch.equal``: a row of an 8-row call, and of a
    call on the rows reversed, equals that row of a 128-row call.
    Returns the 8B bf16 norm's timed result at M = 8."""
    from mxtpu_torch.ops import contrib

    g = torch.Generator(device="cuda").manual_seed(1)
    res = None
    for C in (32, 64, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(128, C, device="cuda", dtype=dtype, generator=g)
            gamma = 1 + 0.1 * torch.randn(C, device="cuda", dtype=dtype,
                                          generator=g)
            full = contrib.rows_rms_norm(x, gamma)
            want = contrib.rms_norm(x, gamma)
            torch.cuda.synchronize()
            err = float((full.float() - want.float()).abs().max())
            tol = GRAD_TOL[dtype] * float(want.float().abs().max())
            if not err <= tol:
                raise AssertionError("rows_rms_norm disagrees with its plain "
                                     "version: %g > %g (C=%d, %s)"
                                     % (err, tol, C, dtype))
            part = contrib.rows_rms_norm(x[:8].contiguous(), gamma)
            rev = contrib.rows_rms_norm(x.flip(0).contiguous(), gamma)
            if not (torch.equal(part, full[:8])
                    and torch.equal(rev.flip(0), full)):
                raise AssertionError("rows_rms_norm rounds a row by the row "
                                     "count or position (C=%d, %s)"
                                     % (C, dtype))
            out = dict(max_abs_err=err, err_over_tol=err / tol)
            if C == 4096 and dtype == torch.bfloat16:
                x8 = x[:8].contiguous()
                out["ms"] = cuda_ms(lambda: contrib.rows_rms_norm(x8, gamma),
                                    flush)
                out["plain_ms"] = cuda_ms(
                    lambda: contrib.rms_norm(x8, gamma), flush)
                out["library_ms"] = cuda_ms(
                    lambda: torch.nn.functional.rms_norm(x8, (C,), gamma,
                                                         1e-6), flush)
                nbytes = 2 * x8.numel() * 2 + C * 2
                out["bound_ms"], out["bound_by"] = bound(
                    nbytes, 4 * x8.numel(), dtype)
                res = out
            log(phase="norm_vs_plain", C=C, dtype=str(dtype).split(".")[1],
                **out)
    return res


#: the 8B projections that read a norm's output: the fused norm's
NORMED = ("qkv", "gate_proj", "up_proj", "lm_head")


def norm_linear_check(x, gamma, w):
    """The fused norm on (x, gamma, w) held bit-identical to G2 then G1
    (``torch.equal``), its rows invariant (a row of an 8-row call and of
    a call on the rows reversed equals that row of the full call), and
    against its plain version as G1 is (``linear_err``).  Returns the
    max abs error against the plain version and that over its bound."""
    from mxtpu_torch.ops import contrib, linear

    got = linear.rows_norm_linear(x, gamma, w)
    pair = linear.rows_linear(contrib.rows_rms_norm(x, gamma), w)
    part = linear.rows_norm_linear(x[:8].contiguous(), gamma, w)
    rev = linear.rows_norm_linear(x.flip(0).contiguous(), gamma, w)
    plain = linear.rows_norm_linear_plain(x, gamma, w)
    torch.cuda.synchronize()
    what = "(x %s %s, gamma %s, w %s)" % (tuple(x.shape), x.dtype,
                                          gamma.dtype, tuple(w.shape))
    if not torch.equal(got, pair):
        raise AssertionError("rows_norm_linear differs from rows_rms_norm "
                             "then rows_linear " + what)
    if not (torch.equal(part, got[:part.shape[0]])
            and torch.equal(rev.flip(0), got)):
        raise AssertionError("rows_norm_linear rounds a row by the row "
                             "count or position " + what)
    err = float((got.float() - plain.float()).abs().max())
    tol = GRAD_TOL[x.dtype] * float(plain.float().abs().max())
    if not err <= tol:
        raise AssertionError("rows_norm_linear disagrees with its plain "
                             "version: %g > %g %s" % (err, tol, what))
    return err, err / tol


def norm_linear_against_pair(flush):
    """The fused norm (``rows_norm_linear``) against G2 then G1
    (``norm_linear_check``) at small ragged shapes in float32 and
    bfloat16 (M up to 200, two 128-row chunks; K % 16 == 8; rows of
    different sizes) with a gain of x's dtype and of float32, and at
    the 8B's four normed projections, M = 8 (the decode step), 64 and
    128 (an 8-slot W = 8 window and W = 16 tree), with the model's bf16
    gain, where it is timed against the pair as the step ran it before
    (the gain's cast, G2, G1), its plain version, and F.rms_norm then
    torch.matmul (the library).  Returns {(projection, M): timed
    result} for the kernels line."""
    from mxtpu_torch.ops import contrib, linear

    g = torch.Generator(device="cuda").manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    for M, N, K, dtype, gdtype in ((1, 96, 72, f32, f32),
                                   (17, 200, 40, f32, f32),
                                   (9, 64, 172, f32, f32),
                                   (200, 64, 168, f32, f32),
                                   (7, 130, 72, bf16, bf16),
                                   (7, 130, 72, bf16, f32),
                                   (33, 4096, 520, bf16, bf16),
                                   (200, 4096, 520, bf16, bf16),
                                   (200, 4096, 520, bf16, f32)):
        x = (torch.randn(M, K, device="cuda", generator=g) * torch.exp(
            torch.randn(M, 1, device="cuda", generator=g))).to(dtype)
        w = (torch.randn(N, K, device="cuda", generator=g) * 0.02).to(dtype)
        gamma = (1 + 0.3 * torch.randn(K, device="cuda", generator=g)).to(
            gdtype)
        err, ratio = norm_linear_check(x, gamma, w)
        log(phase="norm_linear_vs_pair", M=M, N=N, K=K,
            dtype=str(dtype).split(".")[1], gain=str(gdtype).split(".")[1],
            bit_identical_to_pair=True, max_abs_err=err, err_over_tol=ratio)
    results = {}
    for name, N, K in PROJECTIONS:
        if name not in NORMED:
            continue
        w = torch.randn(N, K, device="cuda", dtype=bf16, generator=g) * 0.02
        x = torch.randn(128, K, device="cuda", dtype=bf16, generator=g)
        gamma = (1 + 0.1 * torch.randn(K, device="cuda", generator=g)).to(
            bf16)
        norm_linear_check(x, gamma.float(), w)
        for M in (8, 64, 128):
            xm = x[:M].contiguous()
            err, ratio = norm_linear_check(xm, gamma, w)
            res = dict(max_abs_err=err, err_over_tol=ratio)
            res["ms"] = cuda_ms(
                lambda: linear.rows_norm_linear(xm, gamma, w), flush)
            res["pair_ms"] = cuda_ms(lambda: linear.rows_linear(
                contrib.rows_rms_norm(xm, gamma), w), flush)
            res["plain_ms"] = cuda_ms(
                lambda: linear.rows_norm_linear_plain(xm, gamma, w), flush)
            res["library_ms"] = cuda_ms(lambda: torch.matmul(
                torch.nn.functional.rms_norm(xm, (K,), gamma, 1e-6), w.t()),
                flush)
            nbytes = (xm.numel() + K + w.numel() + M * N) * 2
            res["bound_ms"], res["bound_by"] = bound(
                nbytes, 2 * M * N * K + 4 * M * K, bf16)
            log(phase="norm_linear_vs_pair", projection=name, M=M, N=N, K=K,
                dtype="bfloat16", gain="bfloat16",
                bit_identical_to_pair=True, **res)
            results[name, M] = res
        del w, x
    return results


def measure_linear(x, w, flush):
    """G1 on (x, w): kernel against plain version, and the kernel, plain
    (F.linear) and library (torch.matmul) times with the bound."""
    from mxtpu_torch.ops import linear

    _, err, ratio = linear_err(x, w)
    M, K = x.shape
    N = w.shape[0]
    res = dict(max_abs_err=err, err_over_tol=ratio)
    res["ms"] = cuda_ms(lambda: linear.rows_linear(x, w), flush)
    res["plain_ms"] = cuda_ms(lambda: linear.rows_linear_plain(x, w), flush)
    res["library_ms"] = cuda_ms(lambda: torch.matmul(x, w.t()), flush)
    nbytes = (x.numel() + w.numel() + M * N) * x.element_size()
    res["bound_ms"], res["bound_by"] = bound(nbytes, 2 * M * N * K, x.dtype)
    return res


#: the weight-only forms' group size on the main path (int4)
QUANT_GROUP = 64
#: G3 and G4 by bits: the kernels-line name of the op
WQ_NAME = {8: "rows_linear_i8", 4: "rows_linear_i4"}


def wq_call(x, q, s, gamma=None):
    """G3 or G4 (by the shapes of q and s) on x, with ``gamma`` its
    norm-fused form."""
    from mxtpu_torch.ops import linear

    return linear.wq_matmul(x, q, s, gamma)


def wq_plain(x, q, s, gamma=None):
    """The plain version of ``wq_call``."""
    from mxtpu_torch.ops import linear

    return linear.wq_matmul_plain(x, q, s, gamma)


def wq_bits(s):
    """8 for G3's (N,) scales, 4 for G4's (N, groups)."""
    return 8 if s.dim() == 1 else 4


def wq_err(x, q, s, gamma=None):
    """G3/G4 against the plain version: max abs error and that over TOL
    times max |plain| (float32 sums of exact products in other orders,
    rounded once: within a bf16 ulp of the largest output in bf16)."""
    got = wq_call(x, q, s, gamma)
    want = wq_plain(x, q, s, gamma)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL[x.dtype] * float(want.float().abs().max())
    if not err <= tol:
        raise AssertionError("%s%s disagrees with its plain version: %g > %g "
                             "(x %s %s, w %s)"
                             % (WQ_NAME[wq_bits(s)],
                                "+norm" if gamma is not None else "", err,
                                tol, tuple(x.shape), x.dtype,
                                tuple(q.shape)))
    return got, err, err / tol


def wq_invariant(x, q, s, gamma, full):
    """G3/G4's rows by ``torch.equal``: an 8-row call's rows inside the
    64- and 128-row calls, theirs inside the full call's; and the fused
    form equals G2 then the op at 1, 8, 64, 128 and all rows."""
    from mxtpu_torch.ops import contrib

    bits = wq_bits(s)
    part = {M: wq_call(x[:M].contiguous(), q, s)
            for M in (8, 64, 128) if M <= x.shape[0]}
    ok = all(torch.equal(part[M], full[:M]) for M in part) and all(
        torch.equal(part[a], part[b][:a]) for a, b in ((8, 64), (64, 128))
        if b in part)
    if not ok:
        raise AssertionError("%s rounds a row by the row count (x %s, w %s)"
                             % (WQ_NAME[bits], tuple(x.shape),
                                tuple(q.shape)))
    for M in sorted({1, 8, 64, 128, x.shape[0]}):
        if M > x.shape[0]:
            continue
        xm = x[:M].contiguous()
        if not torch.equal(wq_call(xm, q, s, gamma),
                           wq_call(contrib.rows_rms_norm(xm, gamma), q, s)):
            raise AssertionError("the fused %s differs from G2 then %s at "
                                 "M = %d (w %s)" % (WQ_NAME[bits],
                                                    WQ_NAME[bits], M,
                                                    tuple(q.shape)))


def wq_library(x, q, s, gamma=None):
    """The library yardstick of G3/G4 (its own packed layout converted
    here, outside any timed window): ``torch._weight_int8pack_mm`` or
    ``torch._weight_int4pack_mm`` where the card's torch runs it on CUDA
    bf16 (after F.rms_norm with a gain), else dequantize then
    torch.matmul, labelled, with the reason.  Returns (fn, label,
    reason)."""
    from mxtpu_torch.ops import linear

    F = torch.nn.functional
    K = x.shape[-1]
    bits = wq_bits(s)
    gs = 0 if bits == 8 else K // s.shape[1]

    def pre(v):
        return v if gamma is None else F.rms_norm(v, (K,), gamma, 1e-6)
    try:
        if bits == 8:
            sb = s.to(x.dtype)
            fn, label = (lambda: torch._weight_int8pack_mm(pre(x), q, sb),
                         "torch._weight_int8pack_mm")
        else:
            # tinygemm's layout: k even in the high nibble of a uint8,
            # values q + 8, and (groups, N, 2) scales and zeros
            u = linear.unpack_int4_torch(q).to(torch.int32) + 8
            packed = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
            wp = torch._convert_weight_to_int4pack(packed, 8)
            sz = torch.stack([s.t(), torch.zeros_like(s.t())], -1).to(
                x.dtype).contiguous()
            fn, label = (lambda: torch._weight_int4pack_mm(pre(x), wp, gs,
                                                           sz),
                         "torch._weight_int4pack_mm")
        fn()
        torch.cuda.synchronize()
        return fn, label, None
    except (RuntimeError, NotImplementedError, TypeError,
            AttributeError) as e:
        reason = "%s: %s" % (type(e).__name__, str(e).splitlines()[0][:160])
    N = q.shape[0]
    if bits == 8:
        def deq():
            return (q.float() * s[:, None]).to(x.dtype)
    else:
        def deq():
            return (linear.unpack_int4_torch(q).float().reshape(N, -1, gs)
                    * s[..., None]).reshape(N, K).to(x.dtype)
    return (lambda: torch.matmul(pre(x), deq().t()),
            "dequantize+torch.matmul (two calls)", reason)


def measure_wq(x, q, s, flush, gamma=None):
    """G3/G4 (fused with ``gamma``'s norm where given) on x: against the
    plain version, and the kernel, plain and library times with the
    bound (the int8 or packed int4 weights, their scales, x, y and the
    gain read or written once)."""
    _, err, ratio = wq_err(x, q, s, gamma)
    M, K = x.shape
    N = q.shape[0]
    res = dict(max_abs_err=err, err_over_tol=ratio)
    res["ms"] = cuda_ms(lambda: wq_call(x, q, s, gamma), flush)
    res["plain_ms"] = cuda_ms(lambda: wq_plain(x, q, s, gamma), flush)
    fn, res["library"], reason = wq_library(x, q, s, gamma)
    if reason:
        res["library_error"] = reason
    res["library_ms"] = cuda_ms(fn, flush)
    nbytes = (q.numel() + 4 * s.numel() + (x.numel() + M * N) * 2
              + (K * 2 if gamma is not None else 0))
    res["bound_ms"], res["bound_by"] = bound(nbytes, 2 * M * N * K,
                                             torch.bfloat16)
    res["weight_bytes"] = q.numel() + 4 * s.numel()
    return res


#: the 8B's qkv as G3's q8 epilogue splits it: head_dim and V heads
Q8_HEAD_DIM, Q8_V_HEADS = 128, 8


def q8_unfused(x, q, s, gamma=None):
    """The epilogue's unfused arm: G3 (or its fused norm), then the
    cache's quantizer on each V head."""
    from mxtpu_torch.ops import linear
    from mxtpu_torch.ops.tensor import _q8_quantize

    nv = Q8_HEAD_DIM * Q8_V_HEADS
    y = linear.wq_matmul(x, q, s, gamma)
    N = y.shape[-1]
    vq, vs = _q8_quantize(y[:, N - nv:].reshape(-1, Q8_V_HEADS, Q8_HEAD_DIM))
    return y[:, :N - nv], vq.reshape(-1, nv), vs


def measure_q8(x, q, s, flush, gamma=None):
    """G3 with its q8 epilogue on the 8B's qkv: the q/k rows, the int8
    payload and the scales ``torch.equal`` to the unfused arm (raises
    otherwise); against the plain version (q/k and the dequantized V
    within TOL of their largest plain value); the kernel's, the plain
    version's, the unfused arm's (``unfused_ms``) and the library's
    (``torch._weight_int8pack_mm``, after F.rms_norm with a gain, then
    the cache's quantizer) times; the bound (weights, scales, x, the
    gain, q/k, payload and scales read or written once)."""
    from mxtpu_torch.ops import linear
    from mxtpu_torch.ops.tensor import _q8_quantize

    hd, nv = Q8_HEAD_DIM, Q8_HEAD_DIM * Q8_V_HEADS
    M, K = x.shape
    N = q.shape[0]

    def fused():
        return linear.wq_matmul_q8(x, q, s, hd, nv, gamma=gamma)

    got = fused()
    want = q8_unfused(x, q, s, gamma)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("G3's q8 epilogue differs from G3 then the "
                             "cache's quantizer (M = %d, fused norm %s)"
                             % (M, gamma is not None))
    plain = linear.wq_matmul_q8_plain(x, q, s, hd, nv, gamma)
    torch.cuda.synchronize()

    def deq(v):
        return (v[1].float().reshape(M, -1, hd)
                * v[2][..., None]).reshape(M, nv)
    err = max(float((got[0].float() - plain[0].float()).abs().max()),
              float((deq(got) - deq(plain)).abs().max()))
    tol = TOL[x.dtype] * max(float(plain[0].float().abs().max()),
                             float(deq(plain).abs().max()))
    if not err <= tol:
        raise AssertionError("G3's q8 epilogue disagrees with its plain "
                             "version: %g > %g" % (err, tol))
    res = dict(max_abs_err=err, err_over_tol=err / tol,
               bit_identical_to_unfused=True)
    res["ms"] = cuda_ms(fused, flush)
    res["plain_ms"] = cuda_ms(lambda: linear.wq_matmul_q8_plain(
        x, q, s, hd, nv, gamma), flush)
    res["unfused_ms"] = cuda_ms(lambda: q8_unfused(x, q, s, gamma), flush)
    fn, res["library"], reason = wq_library(x, q, s, gamma)
    if reason:
        res["library_error"] = reason
    res["library"] += " + _q8_quantize"
    res["library_ms"] = cuda_ms(lambda: _q8_quantize(
        fn()[:, N - nv:].reshape(M, -1, hd)), flush)
    nbytes = (q.numel() + 4 * s.numel() + x.numel() * 2
              + M * (N - nv) * 2 + M * nv + M * (nv // hd) * 4
              + (K * 2 if gamma is not None else 0))
    res["bound_ms"], res["bound_by"] = bound(nbytes, 2 * M * N * K,
                                             torch.bfloat16)
    res["weight_bytes"] = q.numel() + 4 * s.numel()
    return res


def quant_linear_against_plain(flush):
    """G3 and G4, the weight-only int8 and int4 projections (``ops/
    linear.py:wq_matmul``, plain and norm-fused): at small ragged shapes
    (N not a multiple of the tile, K not of the 64-deep slice, group
    sizes 16 to 128, bf16 and float32 x, M up to 200) and at the 8B's six projections (int4 at
    group size 64), weights quantized on the card by ``quantize_tensor``,
    each against its plain version (TOL relative to its largest output),
    rows invariant and the fused forms equal to G2 then the op
    (``torch.equal``); at the 8B shapes and M = 8, 64 and 128 timed
    against the plain version and the library yardstick.  Returns
    {(kernels-line row name): timed result}."""
    from mxtpu_torch.contrib.quantization import quantize_tensor

    g = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    for N, K, bits, gs, dtype in ((130, 80, 8, 0, bf16),
                                  (4096, 544, 8, 0, bf16),
                                  (96, 72, 8, 0, f32), (200, 96, 8, 0, f32),
                                  (130, 96, 4, 16, bf16),
                                  (200, 160, 4, 32, bf16),
                                  (4096, 576, 4, 64, bf16),
                                  (4096, 1024, 4, 128, bf16),
                                  (96, 80, 4, 16, f32),
                                  (200, 128, 4, 32, f32)):
        w = torch.randn(N, K, device="cuda", generator=g) * 0.02
        q, s = quantize_tensor(w, bits, gs or QUANT_GROUP)
        x = (torch.randn(200, K, device="cuda", generator=g) * torch.exp(
            torch.randn(200, 1, device="cuda", generator=g))).to(dtype)
        gamma = (1 + 0.3 * torch.randn(K, device="cuda", generator=g)).to(
            dtype)
        full, err, ratio = wq_err(x, q, s)
        wq_invariant(x, q, s, gamma, full)
        _, nerr, nratio = wq_err(x, q, s, gamma)
        log(phase="quant_linear_vs_plain", kernel=WQ_NAME[bits], M=200, N=N,
            K=K, group_size=gs, dtype=str(dtype).split(".")[1],
            max_abs_err=err, err_over_tol=ratio, fused_max_abs_err=nerr,
            fused_err_over_tol=nratio, rows_invariant=True,
            fused_bit_identical_to_pair=True)
    results = {}
    for name, N, K in PROJECTIONS:
        w = torch.randn(N, K, device="cuda", dtype=bf16, generator=g) * 0.02
        x = torch.randn(200, K, device="cuda", dtype=bf16, generator=g)
        gamma = (1 + 0.1 * torch.randn(K, device="cuda", generator=g)).to(
            bf16)
        for bits in (8, 4):
            gs = QUANT_GROUP if bits == 4 else 0
            q, s = quantize_tensor(w, bits, QUANT_GROUP)
            full, _, _ = wq_err(x, q, s)
            wq_invariant(x, q, s, gamma, full)
            for M in (8, 64, 128):
                xm = x[:M].contiguous()
                for fused in (False, True):
                    if fused and name not in NORMED:
                        continue
                    res = measure_wq(xm, q, s, flush,
                                     gamma if fused else None)
                    row = "%s_i%d[%s,M=%d]" % (
                        "rows_norm_linear" if fused else "rows_linear", bits,
                        name, M)
                    log(phase="quant_linear_vs_plain", kernel=row, M=M, N=N,
                        K=K, group_size=gs, dtype="bfloat16",
                        rows_invariant=True, **res)
                    results[row] = res
            if bits == 8 and name == "qkv":
                # G3's q8 epilogue, plain and norm-fused (the decode
                # step's and the window's qkv over int8 pools)
                for M in (8, 64, 128):
                    xm = x[:M].contiguous()
                    for fused in (False, True):
                        res = measure_q8(xm, q, s, flush,
                                         gamma if fused else None)
                        row = "%s_i8_q8[qkv,M=%d]" % (
                            "rows_norm_linear" if fused else "rows_linear",
                            M)
                        log(phase="quant_linear_vs_plain", kernel=row, M=M,
                            N=N, K=K, dtype="bfloat16", **res)
                        results[row] = res
            del q, s, full
        del w, x
    torch.cuda.empty_cache()
    return results


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
        self.kwargs = None

    def __call__(self, *args, **kw):
        if self.args is None and self.want(self.calls, args, kw):
            self.args = [a.clone() if torch.is_tensor(a) else a
                         for a in args]
            self.kwargs = {k: a.clone() if torch.is_tensor(a) else a
                           for k, a in kw.items()}
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


def llama_3_8b_model(depth_factor=1.0):
    """The main path's model: llama_3_8b at full width and depth (or
    ``depth_factor`` of its layers), bf16, Normal(0, 0.02) weights from
    seed 0."""
    from mxtpu_torch.models.transformer import llama_3_8b

    t0 = time.perf_counter()
    model = llama_3_8b(depth_factor=depth_factor, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(0), 0.02)
    torch.cuda.synchronize()
    log(phase="model", layers=len(model.layers), dtype="bfloat16",
        params=sum(p.numel() for p in model.parameters()),
        seconds=time.perf_counter() - t0)
    return model


def k_names(cache_dtype):
    """K1's and K2's launch counter names for a cache dtype."""
    tag = "[int8]" if cache_dtype == "int8" else ""
    return "paged_attention" + tag, "paged_prefill" + tag


def long_chunk_start(reqs):
    """The first position of the longest prompt's last chunk (576 on
    ``traffic``'s 611-token prompt): K2's longest walk on the main
    path."""
    chunk = SERVE["prefill_chunk"]
    start = (max(p.shape[1] for p, _ in reqs) - 1) // chunk * chunk
    if start < 512:
        raise AssertionError("the traffic has no chunk at 512 or later")
    return start


def long_row(name):
    """The kernels-line row of K2 at the long chunk: ``paged_prefill``
    gives ``paged_prefill[long]``, ``paged_prefill[int8]`` gives
    ``paged_prefill[int8,long]``."""
    return name[:-1] + ",long]" if name.endswith("]") else name + "[long]"


def k2_key(args, kw):
    """A K2 call's route on the card and whether its chunk starts at 512
    or later."""
    from mxtpu_torch.ops import prefill_attention as pf

    return pf.route(args[0]), args[4] >= 512


def k1_route(args, kw):
    """A K1 call's route on the card."""
    from mxtpu_torch.ops import paged_attention as pa

    return pa.route(args[0])


def tensor_core_routes(kernel, routes, want):
    """Every call of ``kernel`` (K1 or K2) in a bf16 main-path run took
    the tensor-core route, ``want`` of them (``routes``: calls by
    route)."""
    from mxtpu_torch.ops import paged_attention as pa

    if routes != {pa.TENSOR_CORES: want}:
        raise AssertionError("%s's calls by route %r, wanted all %d on %s"
                             % (kernel, routes, want, pa.TENSOR_CORES))


def k2_routes(counts, want):
    """Every K2 call of a bf16 main-path run (``counts`` by ``k2_key``)
    took the tensor-core route, ``want`` of them."""
    routes = {}
    for (route, _), n in counts.items():
        routes[route] = routes.get(route, 0) + n
    tensor_core_routes("K2", routes, want)


def pool_bytes(eng):
    """Bytes of an engine's KV pools, payloads and scales."""
    return sum(t.numel() * t.element_size() for pair in eng._pools
               for leaf in pair
               for t in (leaf if isinstance(leaf, tuple) else (leaf,)))


#: the projections' launch counters (G1, the fused norm, G3, G4) and G2's
PROJECTION_COUNTERS = ("rows_linear", "rows_norm_linear", "rows_linear_i8",
                       "rows_linear_i4", "rows_rms_norm", "rows_linear_i8_q8",
                       "rows_norm_linear_i8_q8")


def projection_launches(model, calls, chunks, q8=False):
    """The projections' launches a serving run must count, by counter:
    each step or verify call runs 5 projections a layer and the head,
    3 a layer and the head fused with their norm; G1 on a bf16 model,
    G3 or G4 on a quantized one, which runs them in each prefill chunk
    too (5 a layer and the head).  With ``q8`` (int8 weights over int8
    pools, the fused V epilogue) each step's or window's qkv is one of
    G3's, with the epilogue.  No G2 launch."""
    L = len(model.layers)
    bits = getattr(model.lm_head, "bits", None)
    want = {"rows_norm_linear": (3 * L + 1) * calls}
    if bits is None:
        want["rows_linear"] = (5 * L + 1) * calls
    else:
        want["rows_linear_i%d" % bits] = (5 * L + 1) * (calls + chunks)
    if q8:
        want["rows_linear_i8_q8"] = want["rows_norm_linear_i8_q8"] = \
            L * calls
    return want


def q8_route(model, eng):
    """Whether the engine's steps and windows take the fused int8 V
    epilogue (the model's own decision on the engine's pools)."""
    return bool(model.layers[0].attn._fused_q8_epilogue_on(eng._pools[0][1]))


class UnfusedQ8:
    """Routes a model's step and window through quantize-on-write (the
    unfused arm of the fused int8 V epilogue) while it is entered."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        for layer in self.model.layers:
            layer.attn._fused_q8_epilogue_on = lambda pool_v: False
        return self

    def __exit__(self, *exc):
        for layer in self.model.layers:
            del layer.attn._fused_q8_epilogue_on


def projection_launches_differ(launches, want):
    """The projection counters whose launches differ from ``want``."""
    return {k: (launches.get(k, 0), want.get(k, 0))
            for k in PROJECTION_COUNTERS
            if launches.get(k, 0) != want.get(k, 0)}


def wq_key(proj):
    """A G3/G4 call's (projection, rows, fused), for ``Counted`` on
    ``ops.linear.wq_matmul``."""
    return lambda a, kw: (proj[a[1].data_ptr()],
                          a[0].numel() // a[0].shape[-1],
                          (a[3] if len(a) > 3 else kw.get("gamma"))
                          is not None)


def wq_rows(counts, bits):
    """G3/G4 launches by kernels-line row from a ``wq_key`` count:
    ``rows_linear_i8[<proj>,M=<rows>]`` every call (fused or not),
    ``rows_norm_linear_i8[...]`` the fused ones."""
    out = {}
    for (proj, M, fused), n in counts.items():
        for kind in ("rows_linear", "rows_norm_linear")[:1 + fused]:
            name = "%s_i%d[%s,M=%d]" % (kind, bits, proj, M)
            out[name] = out.get(name, 0) + n
    return out


def q8_key(proj):
    """A fused-epilogue call's (projection, rows, fused), for ``Counted``
    on ``wq_matmul_q8`` (imported by the model)."""
    return lambda a, kw: (proj[a[1].data_ptr()],
                          a[0].numel() // a[0].shape[-1],
                          kw.get("gamma") is not None)


def q8_rows(counts):
    """The epilogue's launches by kernels-line row from a ``q8_key``
    count: ``rows_linear_i8_q8[<proj>,M=<rows>]`` every call,
    ``rows_norm_linear_i8_q8[...]`` the norm-fused ones; each is a G3
    launch too (the counters count it so), so it adds to G3's rows,
    ``rows_linear_i8[...]`` and ``rows_norm_linear_i8[...]``, as well."""
    out = {}
    for (proj, M, fused), n in counts.items():
        for kind in ("rows_linear", "rows_norm_linear")[:1 + fused]:
            for suffix in ("_i8", "_i8_q8"):
                name = "%s%s[%s,M=%d]" % (kind, suffix, proj, M)
                out[name] = out.get(name, 0) + n
    return out


#: phase 5's bf16 run, read by phase 6e: its launches, decode steps, wall
#: seconds and device ms per decode step
MAIN_PATH = {}


def serve_llama_3_8b(model, cache_dtype=None):
    """The main path: ``traffic`` through the paged engine on SERVE's
    settings (pools of the model's dtype, or int8 with ``cache_dtype``),
    every kernel's launch count zeroed just before and read just after
    the run and held exact: K1 32 per decode step, K2 32 per chunk (the
    int8 forms on an int8 cache, no float launch), G1 161 per step, 97
    of them the fused norm's, and no G2 apart; no norm kernel in the
    profiled steps.
    Returns the launches (with G1's and the fused norm's by projection),
    layer 0's captured K1 and K2 inputs as (args, keywords), and the
    streams."""
    from mxtpu_torch import base
    from mxtpu_torch.models import sampler
    from mxtpu_torch.models import transformer
    from mxtpu_torch.ops import linear
    from mxtpu_torch.ops import paged_attention as pa
    from mxtpu_torch.ops import prefill_attention as pf
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    n_layers = len(model.layers)
    bits = getattr(model.lm_head, "bits", None)
    k1, k2 = k_names(cache_dtype)
    eng = PagedContinuousBatchingEngine(model, cache_dtype=cache_dtype,
                                        **SERVE)
    # warm-up request: cuBLAS handles and the allocator, outside the count
    eng.submit(np.arange(64)[None], 2)
    eng.run()
    before = eng.stats
    reqs = traffic(model.vocab_size)
    long_start = long_chunk_start(reqs)
    decode_cap = Capture(pa, "paged_decode_attention",
                         lambda n, a, kw: n >= 20 * n_layers
                         and n % n_layers == 0)
    prefill_cap = Capture(pf, "paged_prefill_attention",
                          lambda n, a, kw: a[4] >= 256)
    long_cap = Capture(pf, "paged_prefill_attention",
                       lambda n, a, kw: a[4] == long_start)
    proj = projection_names(model)
    torch.cuda.reset_peak_memory_stats()
    with decode_cap, prefill_cap, long_cap, \
            Counted(pa, "paged_decode_attention", k1_route) as k1_calls, \
            Counted(pf, "paged_prefill_attention", k2_key) as k2_calls, \
            FiniteLogits(sampler) as finite, \
            Counted(transformer, "rows_linear",
                    lambda a, kw: proj[a[1].data_ptr()]) as g1, \
            Counted(transformer, "rows_norm_linear",
                    lambda a, kw: proj[a[2].data_ptr()]) as fused, \
            Counted(linear, "wq_matmul", wq_key(proj)) as wq, \
            Counted(transformer, "wq_matmul_q8", q8_key(proj)) as wq8, \
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
    if cache_dtype is None and bits is None:
        # what phase 6e's traced rerun of this run is held to
        MAIN_PATH.update(launches=dict(launches), steps=steps, wall_s=wall,
                         ms_per_decode_step=t_dec.ms() / steps)
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
    want = {k1: n_layers * steps, k2: n_layers * chunks}
    q8 = q8_route(model, eng)
    want.update(projection_launches(model, steps, chunks, q8))
    if launches != want or not steps or not chunks:
        raise AssertionError("launches %r, wanted exactly %r" % (launches,
                                                                 want))
    tensor_core_routes("K1", k1_calls.counts, n_layers * steps)
    k2_routes(k2_calls.counts, n_layers * chunks)
    gen_tokens = after["generated_tokens"] - before["generated_tokens"]
    pre_tokens = after["prefill_tokens"] - before["prefill_tokens"]
    by_proj = {k: g1.counts.get(k, 0) + fused.counts.get(k, 0)
               for k in set(g1.counts) | set(fused.counts)}
    log(phase="serve", cache_dtype=str(eng._cache_dtype), requests=len(rids),
        decode_steps=steps, prefill_chunks=chunks, launches=launches,
        rows_linear_by_projection=by_proj,
        rows_norm_linear_by_projection=fused.counts,
        prefix_hit_requests=after["prefix_hit_requests"]
        - before["prefix_hit_requests"],
        cow_copied_blocks=after["cow_copied_blocks"]
        - before["cow_copied_blocks"],
        k1_calls_by_route=k1_calls.counts,
        k2_calls_by_route={"%s,start>=512" % r if long else r: n
                           for (r, long), n in k2_calls.counts.items()},
        prefill_tokens=pre_tokens, decode_tokens=gen_tokens,
        prefill_ms=t_pre.ms(), decode_ms=t_dec.ms(),
        prefill_tokens_per_s=pre_tokens / (t_pre.ms() / 1e3),
        decode_tokens_per_s=gen_tokens / (t_dec.ms() / 1e3),
        mean_ms_per_decode_step=t_dec.ms() / steps, wall_s=wall,
        pool_bytes=pool_bytes(eng), weight_bits=bits or 16,
        weight_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()),
        wq_by_projection_M_fused={"%s,M=%d,%s" % (p, m, f): n
                                  for (p, m, f), n in wq.counts.items()},
        fused_q8_epilogue=q8,
        q8_by_projection_M_fused={"%s,M=%d,%s" % (p, m, f): n
                                  for (p, m, f), n in wq8.counts.items()},
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    if (decode_cap.args is None or prefill_cap.args is None
            or long_cap.args is None):
        raise AssertionError("no kernel inputs were captured")
    profile_decode_steps(eng, model.vocab_size, quantized=bits is not None)
    rows = wq_rows(wq.counts, bits) if bits else {}
    for k, n in q8_rows(wq8.counts).items():
        rows[k] = rows.get(k, 0) + n
    launches.update(rows)
    launches.update({"rows_linear(%s)" % k: n for k, n in by_proj.items()})
    launches.update({"rows_norm_linear(%s)" % k: n
                     for k, n in fused.counts.items()})
    k2_long = long_row(k2)
    launches[k2_long] = sum(n for (_, long), n in k2_calls.counts.items()
                            if long)
    caps = {k1: (decode_cap.args, decode_cap.kwargs),
            k2: (prefill_cap.args, prefill_cap.kwargs),
            k2_long: (long_cap.args, long_cap.kwargs)}
    return launches, caps, [res[r].numpy() for r in rids]


def projection_names(model):
    """{weight's data_ptr: projection name} of the model's G1 calls."""
    proj = {layer.weight.data_ptr(): name for block in model.layers
            for name, layer in (("qkv", block.attn.qkv),
                                ("out_proj", block.attn.out_proj),
                                ("gate_proj", block.gate_proj),
                                ("up_proj", block.up_proj),
                                ("down_proj", block.down_proj))}
    proj[model.lm_head.weight.data_ptr()] = "lm_head"
    return proj


def compare_streams(name, reqs, a, b):
    """How many of two runs' streams are token-identical, and where the
    first of the others parts (a reading, not a gate)."""
    parted = []
    for j, ((p, kw), x, y) in enumerate(zip(reqs, a, b)):
        diff = np.nonzero(x[0] != y[0])[0]
        if diff.size:
            parted.append(dict(request=j, sampled="temperature" in kw,
                               token=int(diff[0]) - p.shape[1]))
    log(phase=name, requests=len(reqs), identical=len(reqs) - len(parted),
        parted=parted)


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
                rows_linear_ms_per_step=sum(r[0] for r in rows
                                            if "rows_linear" in r[1]),
                rms_norm_calls_per_step=sum(r[2] for r in rows
                                            if "rms_norm" in r[1]),
                library_gemm_calls_per_step=sum(
                    r[2] for r in rows if is_library_gemm(r[1])),
                library_gemm_kernels=sorted({r[1][:80] for r in rows
                                             if is_library_gemm(r[1])}),
                device_ms_per_step=device if rows else "not measured",
                device_idle_share=1.0 - device / wall if rows
                else "not measured",
                top=[dict(kernel=k[:80], ms_per_step=ms, calls_per_step=n)
                     for ms, k, n in rows[:12]])


#: kernel names of the library GEMMs (cuBLAS, cuBLASLt, CUTLASS)
LIBRARY_GEMM = ("gemm", "cutlass", "cublas", "nvjet", "xmma")


def is_library_gemm(kernel):
    return any(w in kernel.lower() for w in LIBRARY_GEMM)


def profile_decode_steps(eng, vocab, steps=4, quantized=False):
    """The profile of a few pooled decode steps (8 slots at ~520 tokens
    of context, after the main run and outside its counts): its kernels
    a step, and no norm kernel among them (the fused norm runs inside
    G1's launches).  With a ``quantized`` model also one prefill chunk
    (a 64-token prompt alone in the engine), and neither it nor a step
    may launch a library GEMM: every projection is G3 or G4."""
    rng = np.random.RandomState(5)
    if quantized:
        eng.submit(rng.randint(0, vocab, (1, SERVE["prefill_chunk"])), 1)
        res = profile_device(eng.step, 1)
        eng.run()
        log(phase="profile_prefill_chunk",
            cache_dtype=str(eng._cache_dtype), **res)
        if res["library_gemm_calls_per_step"]:
            raise AssertionError("a library GEMM ran in the quantized "
                                 "prefill chunk: %r" % res)
    for _ in range(SERVE["num_slots"]):
        eng.submit(rng.randint(0, vocab, (1, 512)), steps + 12)
    for _ in range(512 // SERVE["prefill_chunk"] + 1):
        eng.step()                     # every slot prefilled, decoding
    res = profile_device(eng.step, steps)
    eng.run()
    log(phase="profile_decode", cache_dtype=str(eng._cache_dtype), **res)
    if res["rms_norm_calls_per_step"]:
        raise AssertionError("a norm kernel ran in the decode step: %r"
                             % res)
    if quantized and res["library_gemm_calls_per_step"]:
        raise AssertionError("a library GEMM ran in the quantized decode "
                             "step: %r" % res)


# -- phases 5q and 6q: weight-only int8 and int4 serving ----------------------

def llama_3_8b_quantized(bits, depth_factor=1.0):
    """Phases 5q and 6q's model: phase 5's (llama_3_8b at full width and
    depth, or ``depth_factor`` of its layers, bf16, Normal(0, 0.02)
    weights from seed 0) quantized in place
    on the card by ``quantize_weights`` (int4 at group size 64).  First
    layer 0's qkv and the lm_head are quantized on the card and on the
    CPU, and the two must be ``torch.equal``."""
    from mxtpu_torch.contrib.quantization import (quantize_tensor,
                                                  quantize_weights)

    model = llama_3_8b_model(depth_factor)
    for lin in (model.layers[0].attn.qkv, model.lm_head):
        qd, sd = quantize_tensor(lin.weight, bits, QUANT_GROUP)
        qc, sc = quantize_tensor(lin.weight.cpu(), bits, QUANT_GROUP)
        if not (torch.equal(qd.cpu(), qc) and torch.equal(sd.cpu(), sc)):
            raise AssertionError("quantizing %s on the card differs from "
                                 "the CPU (int%d)" % (tuple(lin.weight.shape),
                                                      bits))
        del qd, sd, qc, sc
    before = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    names = quantize_weights(model, bits=bits, group_size=QUANT_GROUP)
    torch.cuda.synchronize()
    log(phase="quantize", bits=bits,
        group_size=QUANT_GROUP if bits == 4 else None,
        quantized=len(names), seconds=time.perf_counter() - t0,
        weight_bytes_bf16=before,
        weight_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()),
        card_equals_cpu=["layer0_attn_qkv", "lm_head"])
    return model


def generate_logits(model, ids, prompt_len, cache_dtype):
    """The logits ``generate`` had for the token after ``ids`` (1, T):
    its own loop, one prefill of the prompt then a step a token, over a
    contiguous cache as long as generate's."""
    from mxtpu_torch.ops.tensor import resolve_cache_dtype

    ids = torch.from_numpy(ids).cuda().long()
    caches = model.init_cache(1, prompt_len + NEW_TOKENS,
                              resolve_cache_dtype(cache_dtype, model.dtype))
    logits = model.prefill(ids[:, :prompt_len], caches)
    for pos in range(prompt_len, ids.shape[1]):
        logits = model.step(ids[:, pos:pos + 1], caches, pos)
    return logits[0, -1].float()


#: the widest logit gap, in bf16 ulps of generate's top logit, at which
#: a greedy engine stream may part from ``generate`` (runs of PR 15 read
#: 0-9 on the 8B model in bf16, quantized or not)
PARTING_ULPS = 16


def streams_vs_generate(model, reqs, streams, cache_dtype=None):
    """Each engine stream of a serve run against the model's own
    ``generate`` (contiguous cache, plain masked-softmax attention, the
    unfused norm; G3/G4 in every projection of a quantized model,
    nn.Linear of a bf16 one; the same seed for a sampled request), and
    for a greedy stream that parts, generate's own logits where it
    parts: the gap from its top logit to the engine's token, in bf16
    ulps of the top logit, and that token's rank.  At 8B in bf16 with
    random weights the two paths' roundings part the streams at such
    near-ties, with or without quantized weights, so a parting is no
    fault; a gap over ``PARTING_ULPS`` is, since a wrong projection
    moves the logits far more than a rounding does.  The rank is read,
    not held: random weights crowd several logits within a few ulps of
    the top.  Sampled streams are read only."""
    parted = []
    for j, ((p, kw), got) in enumerate(zip(reqs, streams)):
        want = model.generate(torch.from_numpy(p).cuda(), NEW_TOKENS,
                              cache_dtype=cache_dtype, **kw).cpu().numpy()
        diff = np.nonzero(want[0] != got[0])[0]
        if not diff.size:
            continue
        at = int(diff[0])
        entry = dict(request=j, sampled="temperature" in kw,
                     token=at - p.shape[1])
        if not entry["sampled"]:
            lg = generate_logits(model, want[:, :at], p.shape[1],
                                 cache_dtype)
            top, eng = float(lg[want[0, at]]), float(lg[got[0, at]])
            ulp = 2.0 ** (np.floor(np.log2(abs(top))) - 7)
            entry.update(gap=top - eng, gap_ulps=(top - eng) / ulp,
                         engine_token_rank=1 + int((lg > eng).sum()))
        parted.append(entry)
    log(phase="streams_vs_generate", cache_dtype=str(cache_dtype),
        weight_bits=getattr(model.lm_head, "bits", 16),
        requests=len(reqs), identical=len(reqs) - len(parted),
        parted=parted, bound_ulps=PARTING_ULPS)
    wide = [e for e in parted if e.get("gap_ulps", 0) > PARTING_ULPS]
    if wide:
        raise AssertionError("engine streams part from generate over %d "
                             "bf16 ulps of its top logit: %r"
                             % (PARTING_ULPS, wide))


def serve_quantized(bits):
    """Phase 5q: the quantized 8B model at ``CUT_DEPTH``
    (``llama_3_8b_quantized``) served
    phase 5's traffic on its engine settings over bf16 pools and, with
    int8 weights, over int8 pools too, every launch count exact (G3 or
    G4 5 a layer and the head a step and a chunk, 3 a layer and the head
    fused with their norm; no G1, no G2), every page back, the streams
    held against ``generate`` (``streams_vs_generate``), no library
    GEMM in the profiled steps or prefill chunk.  Phase 6q: phase 6b's
    speculative serve of the model's own motif traffic, over int8 pools
    with int8 weights and over bf16 pools with int4 weights, every
    speculative stream token-identical to its plain stream.  Returns G3's or G4's launches
    by kernels-line row over these runs."""
    model = llama_3_8b_quantized(bits, CUT_DEPTH)
    rows = {}
    reqs = traffic(model.vocab_size)
    runs = {}
    for cache_dtype in (None, "int8") if bits == 8 else (None,):
        launches, _, runs[cache_dtype] = serve_llama_3_8b(model, cache_dtype)
        streams_vs_generate(model, reqs, runs[cache_dtype], cache_dtype)
        for k, n in launches.items():
            if k.startswith(("rows_linear_i", "rows_norm_linear_i")):
                rows[k] = rows.get(k, 0) + n
    if bits == 8:
        compare_streams("int8_pools_vs_bf16_pools_streams", reqs, runs[None],
                        runs["int8"])
        # the fused int8 V epilogue against its unfused arm: the same
        # engine settings and traffic with quantize-on-write
        with UnfusedQ8(model):
            unfused = serve_llama_3_8b(model, "int8")[2]
        parted = [j for j, (a, b) in enumerate(zip(runs["int8"], unfused))
                  if not np.array_equal(a, b)]
        log(phase="fused_q8_vs_unfused_streams", requests=len(reqs),
            identical=len(reqs) - len(parted), parted=parted)
        if parted:
            raise AssertionError("the fused int8 V epilogue's streams %r "
                                 "differ from the unfused arm's" % parted)
    _, _, _, by_m = serve_llama_3_8b_speculative(
        model, "int8" if bits == 8 else None)
    for k, n in by_m["wq"].items():
        rows[k] = rows.get(k, 0) + n
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# -- speculative serving: a small model, then the 8B main path --------------

class Counted:
    """Counts every call of one attribute (a kernel wrapper or a model
    method) during a run, by ``key(args, kwargs)``, and passes it on."""

    def __init__(self, owner, attr, key):
        self.owner, self.attr, self.key = owner, attr, key
        self.inner = None
        self.own = False
        self.counts = {}

    def __call__(self, *args, **kw):
        k = self.key(args, kw)
        self.counts[k] = self.counts.get(k, 0) + 1
        return self.inner(*args, **kw)

    def __enter__(self):
        # an instance's method is restored by deleting the override (a
        # bound method kept on the instance would hold it in a cycle)
        self.own = self.attr in getattr(self.owner, "__dict__", {})
        self.inner = getattr(self.owner, self.attr)
        setattr(self.owner, self.attr, self)
        return self

    def __exit__(self, *exc):
        if self.own or isinstance(self.owner, type(sys)):
            setattr(self.owner, self.attr, self.inner)
        elif self.attr in self.owner.__dict__:
            # (a Timed nested inside may have removed the override)
            delattr(self.owner, self.attr)


def k1_key(args, kw):
    """A K1 call's window width and whether it took a tree's anc."""
    return (int(args[0].shape[2]), kw.get("anc") is not None)


def model_key(args, kw):
    """A step_pages or verify_pages call's window width and kind."""
    return (int(args[0].shape[1]), kw.get("tree", args[5] if len(args) > 5
                                         else None) is not None)


def init_weights_numpy(model, seed, std):
    """Normal(0, std) weights drawn with numpy from ``seed``, in
    parameter order (the same on every device); RMSNorm gains stay 1."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("norm.weight"):
                p.copy_(torch.from_numpy(
                    rng.normal(0.0, std, tuple(p.shape)).astype("f")))


#: the small speculative model: the reference tests' cycling micro-model
#: geometry (vocab 20, 1 layer, 32 units, 4 heads over 2 kv heads)
SPEC_SMALL = dict(vocab=20, units=32, hidden=64, layers=1, heads=4, kv=2,
                  seed=2, std=0.5)
#: branchy prompts (tests/test_tree_speculative.py): the trailing bigram
#: recurs with two continuations, so the tree drafter forks
P_FORK = [1, 2, 3, 1, 2, 4, 1, 2, 3, 1, 2]
P_FORK2 = [5, 6, 7, 5, 6, 8, 5, 6, 7, 5, 6]
P_FORK3 = [9, 3, 2, 9, 3, 5, 9, 3, 2, 9, 3]


def fork_prompts(model, n, rng, tries=60, cache_dtype=None):
    """``n`` prompts s + y + s + [z] + s[:2] whose greedy continuation on
    ``model`` is s[2], y: after the first token the history ends with s,
    whose most recent occurrence continues with z (the tree drafter's
    primary chain) and whose earlier one with y (a side branch), so the
    accepted path takes the side branch and the fix-up runs.  Found by
    a fixed-point search on the model itself (with its ``cache_dtype``
    cache)."""
    V = model.vocab_size
    out = []
    for _ in range(tries):
        s = [int(t) for t in rng.randint(0, V, 3)]
        y = [int(t) for t in rng.randint(0, V, 2)]
        for _ in range(4):
            p = s + y + s + [(y[0] + 1) % V] + s[:2]
            c = model.generate(torch.tensor([p]), 3, cache_dtype=cache_dtype)[
                0, len(p):].tolist()
            if c == [s[2]] + y:
                out.append(p)
                break
            s[2], y = c[0], c[1:]
        if len(out) == n:
            return out
    raise AssertionError("no prompt of the model forks onto a side branch")


def small_model_speculative_check(device="cuda", cache_dtype=None):
    """A 1-layer float32 model on ``device``, numpy-seeded weights, its
    cache float32 or (``cache_dtype="int8"``) int8, served by one engine
    with spec_k = 3 and spec_tree = (6, 2) over a
    mixed pool (one request drafts linearly, spec_tree=False), prefix
    sharing and 2-chunk prefills in play: every greedy, seeded-sampled
    and penalized stream equals the same engine settings' stream with
    speculation off and the model's isolated generate.  Drafts must be
    accepted, a tree side-branch fix-up must run, and every page must
    come back."""
    from mxtpu_torch.models.transformer import TransformerLM
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    c = SPEC_SMALL
    model = TransformerLM(c["vocab"], c["units"], c["hidden"], c["layers"],
                          c["heads"], c["kv"], device=device)
    init_weights_numpy(model, c["seed"], c["std"])
    cfg = dict(num_slots=3, max_length=64, block_size=8, prefill_chunk=8,
               device=device, cache_dtype=cache_dtype)
    shared = P_FORK + P_FORK2
    reqs = [(p, 16, {}) for p in fork_prompts(
        model, 2, np.random.RandomState(0), cache_dtype=cache_dtype)]
    reqs += [(P_FORK, 20, {}),
             (P_FORK2, 20, dict(temperature=0.8, seed=7)),
             (P_FORK3, 18, dict(temperature=0.6, seed=9,
                                repetition_penalty=1.3)),
             (P_FORK2 + P_FORK, 16, dict(spec_tree=False)),
             (shared, 14, {}),
             (shared + [4, 9], 14, dict(repetition_penalty=1.3))]
    outs = {}
    for spec in (False, True):
        eng = PagedContinuousBatchingEngine(
            model, **cfg, **(dict(spec_k=3, spec_tree=(6, 2)) if spec
                             else {}))
        with Counted(model, "permute_pool_span", lambda a, kw: 0) as fix:
            rids = []
            for j, (p, n, kw) in enumerate(reqs):
                rids.append(eng.submit(np.array([p]), n, **kw))
                if p is shared:
                    for _ in range(3):
                        eng.step()      # the donor's pages register
            res = eng.run()
        outs[spec] = [res[r].numpy() for r in rids]
        st = eng.stats
    for j, (p, n, kw) in enumerate(reqs):
        kw = {k: v for k, v in kw.items() if k != "spec_tree"}
        want = model.generate(torch.tensor([p]), n, cache_dtype=cache_dtype,
                              **kw).cpu().numpy()
        for spec in (False, True):
            if not np.array_equal(outs[spec][j], want):
                raise AssertionError(
                    "small speculative model: request %d (%r, spec=%s) "
                    "gave %r, generate %r" % (j, kw, spec, outs[spec][j],
                                              want))
    fixups = fix.counts.get(0, 0)
    if (st["accepted_tokens"] <= 0 or st["tree_nodes_drafted"] <= 0
            or fixups <= 0 or st["blocks_in_use"] != 0
            or st["prefix_hit_requests"] <= 0):
        raise AssertionError("small speculative model: no accepts, no "
                             "tree, no fix-up, no prefix hit or leaked "
                             "pages: %r, %d fix-ups" % (st, fixups))
    log(phase="small_model_speculative", device=str(device),
        cache_dtype=str(eng._cache_dtype), requests=len(reqs), fixups=fixups,
        **{k: st[k] for k in ("drafted_tokens", "accepted_tokens",
                              "tree_nodes_drafted", "tree_paths",
                              "verify_calls", "slot_iterations",
                              "prefix_hit_requests")})


#: the speculative main path's engine: SERVE plus speculation
SPEC_SERVE = dict(SERVE, spec_k=4, spec_tree=(15, 2))


#: speculative traffic: a MOTIF_LEN-token motif prompt, continued by the
#: model's own greedy text, probed PROBE tokens deep
MOTIF_LEN = 128
PROBE = 400


def motif_kwargs(i):
    """The submit kwargs of motif request i of 12: 0-5 draft trees, 6-10
    draft linearly, 11 does not speculate; 2 (a tree) and 7 are
    seeded-sampled, 4 penalized."""
    kw = {} if i < 6 else (dict(spec_tree=False) if i < 11
                           else dict(speculative=False))
    if i in (2, 7):
        kw.update(temperature=0.8, top_p=0.9, seed=2000 + i)
    if i == 4:
        kw.update(repetition_penalty=1.2)
    return kw


def motif_traffic(model, seed=0):
    """12 requests of 256-528 prompt tokens: a seeded random 16-48-token
    motif repeated to 128 tokens with 2 random substitutions (the
    repetitive text n-gram drafting targets), followed by the model's
    own greedy continuation of it, cut where the model's next token
    already occurs in the prompt (an n-gram match).  A random-weight
    model neither continues a motif nor repeats itself: its tokens are
    near-uniform over the vocabulary, so without the cut almost no
    request would draft.  The continuations come from one paged-engine
    run of PROBE tokens; each cut is then confirmed by a one-token run
    on the main path's engine settings (the same prefill as the
    measured runs, so the same first token), moving to the request's
    next match where it fails.  A request without a confirmed match is
    cut at a seeded point.  6 requests draft trees, 5 draft linearly
    (spec_tree=False), 1 does not speculate; 2 are seeded-sampled (one of
    them a tree), 1 penalized.  Returns the (prompt, submit kwargs)
    pairs and the number of confirmed cuts."""
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    rng = np.random.RandomState(seed)
    V = model.vocab_size
    motifs, kws = [], []
    for i in range(12):
        motif = rng.randint(0, V, int(rng.randint(16, 49)))
        p = np.tile(motif, MOTIF_LEN // len(motif) + 1)[:MOTIF_LEN]
        at = rng.randint(0, MOTIF_LEN, MOTIF_LEN // 64)
        p[at] = rng.randint(0, V, len(at))
        motifs.append(p[None].astype(np.int64))
        kws.append(motif_kwargs(i))
    probe = PagedContinuousBatchingEngine(
        model, **dict(SERVE, num_slots=12))
    rids = [probe.submit(p, PROBE) for p in motifs]
    res = probe.run()
    del probe
    rows = [res[r].numpy()[0] for r in rids]
    cands = []
    for row in rows:
        seen, c = set(row[:2 * MOTIF_LEN].tolist()), []
        for j in range(2 * MOTIF_LEN, len(row)):
            if int(row[j]) in seen:
                c.append(j)
            seen.add(int(row[j]))
        cands.append(c)
    check = PagedContinuousBatchingEngine(model, **SERVE)
    cut = [c[0] if c else None for c in cands]
    ok = [False] * 12
    for _ in range(3):
        todo = [i for i in range(12) if cut[i] is not None and not ok[i]]
        if not todo:
            break
        rids = {i: check.submit(rows[i][None, :cut[i]], 1, **kws[i])
                for i in todo}
        res = check.run()
        for i, r in rids.items():
            first = int(res[r].numpy()[0, -1])
            if first in set(rows[i][:cut[i]].tolist()):
                ok[i] = True
            else:
                later = [j for j in cands[i] if j > cut[i]]
                cut[i] = later[0] if later else None
    del check
    reqs = []
    for i in range(12):
        c = cut[i] if ok[i] else int(rng.randint(2 * MOTIF_LEN,
                                                 len(rows[i])))
        reqs.append((rows[i][None, :c].astype(np.int64), kws[i]))
    return reqs, sum(ok)


def serve_speculative(model, eng, reqs):
    """One run of ``reqs`` through ``eng`` with the K1 calls and the
    model's step/verify calls counted by (W, tree), the decode calls
    timed and the sampled logits checked finite.  The first linear and
    the first tree K1 call are captured."""
    from mxtpu_torch import base
    from mxtpu_torch.models import sampler, transformer
    from mxtpu_torch.ops import linear
    from mxtpu_torch.ops import paged_attention as pa
    from mxtpu_torch.ops import prefill_attention as pf

    n_layers = len(model.layers)
    k1_name = k_names(eng._cache_dtype)[0]
    proj = projection_names(model)
    lin_cap = Capture(pa, "paged_decode_attention",
                      lambda n, a, kw: a[0].shape[2] > 1
                      and kw.get("anc") is None)
    tree_cap = Capture(pa, "paged_decode_attention",
                       lambda n, a, kw: kw.get("anc") is not None)
    before = eng.stats
    torch.cuda.reset_peak_memory_stats()
    with lin_cap, tree_cap, Counted(pa, "paged_decode_attention",
                                    k1_key) as k1, \
            Counted(pa, "paged_decode_attention", k1_route) as k1_routes, \
            Counted(model, "step_pages", model_key) as steps, \
            Counted(model, "verify_pages", model_key) as verifies, \
            Counted(pf, "paged_prefill_attention", k2_key) as k2_calls, \
            Counted(transformer, "rows_linear",
                    lambda a, kw: (proj[a[1].data_ptr()],
                                   a[0].numel() // a[0].shape[-1])) as g1, \
            Counted(transformer, "rows_norm_linear",
                    lambda a, kw: (proj[a[2].data_ptr()],
                                   a[0].numel() // a[0].shape[-1])) \
            as fused, \
            Counted(linear, "wq_matmul", wq_key(proj)) as wq, \
            Counted(transformer, "wq_matmul_q8", q8_key(proj)) as wq8, \
            FiniteLogits(sampler) as finite, \
            Timed(model, "step_pages") as t_step, \
            Timed(model, "verify_pages") as t_ver:
        torch.cuda.synchronize()
        rids = [eng.submit(p, NEW_TOKENS, **kw) for p, kw in reqs]
        base.reset_counts()
        t_run = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = base.counts()
    after = eng.stats
    d = {k: after[k] - before[k] for k in (
        "steps", "generated_tokens", "prefill_tokens", "prefill_chunks",
        "verify_calls", "drafted_tokens", "accepted_tokens",
        "tree_nodes_drafted", "tree_paths", "slot_iterations")}
    k2_routes(k2_calls.counts, n_layers * d["prefill_chunks"])
    tensor_core_routes("K1", k1_routes.counts, n_layers * d["steps"])
    calls = dict(steps.counts)
    calls.update(verifies.counts)
    for key, n in calls.items():
        if k1.counts.get(key, 0) != n_layers * n:
            raise AssertionError("K1 launched %d times with (W, tree) = %r"
                                 ", wanted %d x %d model calls"
                                 % (k1.counts.get(key, 0), key, n_layers,
                                    n))
    differ = projection_launches_differ(launches, projection_launches(
        model, d["steps"], d["prefill_chunks"], q8_route(model, eng)))
    if (set(k1.counts) != set(calls)
            or sum(verifies.counts.values()) != d["verify_calls"]
            or sum(calls.values()) != d["steps"]
            or launches.get(k1_name, 0) != n_layers * d["steps"]
            or differ):
        raise AssertionError("K1 (%s), G1, G3/G4, fused norm or G2 "
                             "launches %r (projections (got, wanted): %r) "
                             "do not equal "
                             "%d x (plain steps + verify calls) %r, stats "
                             "%r"
                             % (k1_name, launches, differ, n_layers, calls,
                                d))
    if finite.ok is None or not bool(finite.ok):
        raise AssertionError("a sampled logit row was not finite")
    if after["blocks_in_use"] != 0:
        raise AssertionError("pages leaked: %r" % after)
    # G1's calls, the fused norm's among them
    g1_calls = {k: g1.counts.get(k, 0) + fused.counts.get(k, 0)
                for k in set(g1.counts) | set(fused.counts)}
    # generated_tokens counts decode tokens (each request's first token
    # comes from its prefill)
    decode_tokens = d["generated_tokens"]
    decode_ms = t_step.ms() + t_ver.ms()
    n_calls = sum(calls.values())
    out = dict(decode_calls={"%s%d" % ("tree,W=" if t else "W=", w): n
                             for (w, t), n in sorted(calls.items())},
               k1_launches={"%s%d" % ("tree,W=" if t else "W=", w): n
                            for (w, t), n in sorted(k1.counts.items())},
               decode_tokens=decode_tokens, decode_ms=decode_ms,
               decode_tokens_per_s=decode_tokens / (decode_ms / 1e3),
               mean_ms_per_decode_call=decode_ms / n_calls,
               mean_ms_per_step=t_step.ms() / max(1, len(t_step.events)),
               mean_ms_per_verify=(t_ver.ms() / len(t_ver.events)
                                   if t_ver.events else None),
               tokens_per_slot_iteration=decode_tokens
               / max(1, d["slot_iterations"]),
               accepted_per_slot_iteration=d["accepted_tokens"]
               / max(1, d["slot_iterations"]),
               draft_hit_rate=(d["accepted_tokens"] / d["drafted_tokens"]
                               if d["drafted_tokens"] else 0.0),
               rows_linear_by_M={"M=%d" % m: sum(
                   n for (_, mm), n in g1_calls.items() if mm == m)
                   for m in sorted({m for _, m in g1_calls})},
               rows_linear_by_projection_and_M={
                   "%s,M=%d" % k: n for k, n in sorted(g1_calls.items())},
               rows_norm_linear_by_projection_and_M={
                   "%s,M=%d" % k: n
                   for k, n in sorted(fused.counts.items())},
               wq_by_projection_M_fused={"%s,M=%d,%s" % k: n
                                         for k, n in wq.counts.items()},
               q8_by_projection_M_fused={"%s,M=%d,%s" % k: n
                                         for k, n in wq8.counts.items()},
               wall_s=wall,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               **d)
    streams = [res[r].numpy() for r in rids]
    caps = {"linear": lin_cap.args and (lin_cap.args[:5], lin_cap.kwargs),
            "tree": tree_cap.args and (tree_cap.args[:5], tree_cap.kwargs)}
    bits = getattr(model.lm_head, "bits", None)
    out_rows = wq_rows(wq.counts, bits) if bits else {}
    for k, n in q8_rows(wq8.counts).items():
        out_rows[k] = out_rows.get(k, 0) + n
    return out, streams, k1.counts, caps, out_rows


def serve_llama_3_8b_speculative(model, cache_dtype=None, reqs=None):
    """The 8B model served the motif traffic (``reqs``, made when None)
    twice on the main path's engine settings and ``cache_dtype``: once
    with speculation off, once with spec_k = 4 and spec_tree = (15, 2).
    K1's launches must be 32 per model call by (W, tree), G1's 161 and
    the fused norm's 97.
    Every speculative stream must be token-identical to its plain
    stream: G1 rounds a verify window's rows as the step rounds them,
    K1 gives a window's lane the bits of a step at its position
    (invariant (b), held here on the main path's captured window), and
    ``window_op_bits`` must find no op of the step whose bits a window
    lane changes.  Returns K1's launch counts by (W, tree), the first
    linear and tree K1 inputs as (args, keywords), the traffic, and the
    speculative run's G1 and fused-norm calls by "projection,M=rows"
    ({"rows_linear": ..., "rows_norm_linear": ...})."""
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    if reqs is None:
        t0 = time.perf_counter()
        reqs, matched = motif_traffic(model)
        log(phase="speculative_traffic", requests=len(reqs),
            prompt_tokens=[int(p.shape[1]) for p, _ in reqs],
            confirmed_matches=matched, seconds=time.perf_counter() - t0)
    runs = {}
    for spec in (False, True):
        cfg = dict(SPEC_SERVE if spec else SERVE, cache_dtype=cache_dtype)
        eng = PagedContinuousBatchingEngine(model, **cfg)
        eng.submit(np.arange(64)[None], 2)      # warm-up, outside counts
        eng.run()
        runs[spec] = serve_speculative(model, eng, reqs)
        log(phase="serve_speculative", speculative=spec,
            cache_dtype=str(eng._cache_dtype),
            engine={k: v for k, v in cfg.items() if k != "cache_dtype"},
            **runs[spec][0])
        del eng
        torch.cuda.empty_cache()
    plain, spec = runs[False], runs[True]
    if spec[0]["verify_calls"] <= 0 or spec[0]["tree_nodes_drafted"] <= 0:
        raise AssertionError("no verify call or no tree drafted: %r"
                             % spec[0])
    parted = [j for j, (a, b) in enumerate(zip(plain[1], spec[1]))
              if not np.array_equal(a, b)]
    log(phase="speculative_identity", cache_dtype=str(cache_dtype),
        requests=len(reqs), identical=len(reqs) - len(parted),
        parted=parted)
    if parted:
        raise AssertionError("speculative streams %r differ from the plain "
                             "streams" % parted)
    caps = spec[3]
    if caps["tree"] is None:
        raise AssertionError("no tree verify call was captured")
    derived = caps["linear"] is None
    if derived:
        # no iteration drafted linearly alone: the tree call's inputs as
        # an 8-lane linear window
        t_args, t_kw = caps["tree"]
        caps["linear"] = ([t_args[0][:, :, :8].contiguous()] + list(
            t_args[1:5]), {k: v for k, v in t_kw.items() if k != "anc"})
    log(phase="verify_capture", cache_dtype=str(cache_dtype),
        linear_W=int(caps["linear"][0][0].shape[2]),
        tree_W=int(caps["tree"][0][0].shape[2]), linear_derived=derived)
    lane_invariant(*caps["linear"])
    if cache_dtype is None:
        bits = window_op_bits(model)
        log(phase="window_op_bits", **bits)
        if bits["bits_differ"]:
            raise AssertionError("a verify window's lane rounds %r otherwise "
                                 "than the step" % bits["bits_differ"])
    by_m = {k: spec[0][k + "_by_projection_and_M"]
            for k in ("rows_linear", "rows_norm_linear")}
    by_m["wq"] = {k: plain[4].get(k, 0) + spec[4].get(k, 0)
                  for k in set(plain[4]) | set(spec[4])}
    return spec[2], caps, reqs, by_m


# -- the rest of decoding: draft-model speculation, the slot engine and the
# -- sequence samplers at 8B ---------------------------------------------------

#: phase 5's engine settings with the draft model's window
DRAFT_SERVE = dict(SERVE, spec_k=4)
#: the slot engine's settings at 8B: contiguous caches of 8 rows x 1024
#: positions (8 x 1024 x 32 layers x 8 kv heads x 128 x 2 x 2 B = 1.07 GB)
SLOT_SERVE = dict(num_slots=8, max_length=1024)


class Emitted:
    """Wraps an engine's ``_finish``: each finished request's decode
    tokens and the decode iterations it took part in (the first token
    comes from its prefill)."""

    def __init__(self, eng):
        self.eng = eng
        self.inner = None
        self.by_rid = {}

    def __call__(self, row):
        slot = self.eng._slots[row]
        self.by_rid[slot.req.rid] = (slot.n_emitted - 1,
                                     len(slot.emitted) - 1)
        return self.inner(row)

    def __enter__(self):
        self.inner = self.eng._finish
        self.eng._finish = self
        return self

    def __exit__(self, *exc):
        del self.eng._finish


def serve_draft_model(model, cache_dtype, plain_streams):
    """Draft-model speculation on the paged engine: every other request of
    phase 5's traffic (``CUT``) and its engine with spec_k = 4 and
    ``draft_block`` = the model itself (its
    own contiguous slot cache, no second copy of the weights), over the
    model's pools or int8 ones.  Every stream, greedy and sampled, must
    be token-identical to phase 5's (or 5b's) plain stream, the greedy
    requests must average 2 or more decode tokens a slot-iteration, and
    the launches are exact: K1 32 a target call (plain step or verify
    window), K2 32 a chunk, G1 161 a target or draft call (97 fused)."""
    from mxtpu_torch import base
    from mxtpu_torch.models import sampler
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    L = len(model.layers)
    k1, k2 = k_names(cache_dtype)
    reqs = traffic(model.vocab_size)[CUT]
    plain_streams = plain_streams[CUT]
    eng = PagedContinuousBatchingEngine(model, cache_dtype=cache_dtype,
                                        draft_block=model, **DRAFT_SERVE)
    eng.submit(np.arange(64)[None], 2)          # warm-up, outside counts
    eng.run()
    before = eng.stats
    with Counted(model, "step_slots", lambda a, kw: int(a[0].shape[0])) \
            as drafts, Counted(model, "verify_pages", model_key) as verifies, \
            FiniteLogits(sampler) as finite, Emitted(eng) as emitted, \
            Timed(model, "step_slots") as t_draft, \
            Timed(model, "verify_pages") as t_ver, \
            Timed(model, "step_pages") as t_step:
        torch.cuda.synchronize()
        rids = [eng.submit(p, NEW_TOKENS, **kw) for p, kw in reqs]
        base.reset_counts()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = base.counts()
    after = eng.stats
    d = {k: after[k] - before[k] for k in (
        "steps", "generated_tokens", "prefill_chunks", "verify_calls",
        "drafted_tokens", "accepted_tokens", "slot_iterations")}
    n_draft = sum(drafts.counts.values())
    want = {k1: L * d["steps"], k2: L * d["prefill_chunks"]}
    want.update(projection_launches(model, d["steps"] + n_draft, 0))
    streams = [res[r].numpy() for r in rids]
    parted = [j for j, (a, b) in enumerate(zip(streams, plain_streams))
              if not np.array_equal(a, b)]
    greedy = [r for r, (_, kw) in zip(rids, reqs) if "temperature" not in kw]
    g_tok = sum(emitted.by_rid[r][0] for r in greedy)
    g_it = sum(emitted.by_rid[r][1] for r in greedy)
    log(phase="serve_draft_model", cache_dtype=str(eng._cache_dtype),
        requests=len(rids), identical_to_plain=len(rids) - len(parted),
        parted=parted, target_calls=d["steps"], draft_calls=n_draft,
        verify_calls=d["verify_calls"], verify_windows=verifies.counts and {
            "W=%d" % w: n for (w, _), n in verifies.counts.items()},
        drafted_tokens=d["drafted_tokens"],
        accepted_tokens=d["accepted_tokens"],
        draft_hit_rate=(d["accepted_tokens"] / d["drafted_tokens"]
                        if d["drafted_tokens"] else 0.0),
        tokens_per_slot_iteration=d["generated_tokens"]
        / max(1, d["slot_iterations"]),
        greedy_tokens_per_slot_iteration=g_tok / max(1, g_it),
        draft_ms=t_draft.ms(), verify_ms=t_ver.ms(), step_ms=t_step.ms(),
        decode_tokens_per_s=d["generated_tokens"]
        / ((t_draft.ms() + t_ver.ms() + t_step.ms()) / 1e3),
        launches=launches, wall_s=wall)
    if finite.ok is None or not bool(finite.ok):
        raise AssertionError("a sampled logit row was not finite")
    if launches != want:
        raise AssertionError("draft-model launches %r, wanted exactly %r"
                             % (launches, want))
    if parted:
        raise AssertionError("draft-model streams %r differ from the plain "
                             "streams" % parted)
    if after["blocks_in_use"] != 0:
        raise AssertionError("pages leaked: %r" % after)
    if not g_it or g_tok / g_it < 2.0:
        raise AssertionError("the greedy requests took %d decode tokens in "
                             "%d slot-iterations (< 2 a slot-iteration)"
                             % (g_tok, g_it))
    del eng
    torch.cuda.empty_cache()


def slot_run(model, reqs, cfg):
    """``reqs`` through a ``ContinuousBatchingEngine`` on ``cfg`` (warmed
    up outside the counts): its streams and a summary.  The slot path
    launches G1 (161 a step or verify call, 97 fused) and no K1 or K2:
    its attention is plain PyTorch, as the reference's is XLA's."""
    from mxtpu_torch import base
    from mxtpu_torch.models import sampler
    from mxtpu_torch.parallel.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, **cfg)
    eng.submit(np.arange(64)[None], 2)
    eng.run()
    before = eng.stats
    with FiniteLogits(sampler) as finite, \
            Counted(model, "verify_slots",
                    lambda a, kw: int(a[0].shape[1])) as verifies, \
            Timed(model, "step_slots") as t_step, \
            Timed(model, "verify_slots") as t_ver:
        torch.cuda.synchronize()
        rids = [eng.submit(p, NEW_TOKENS, **kw) for p, kw in reqs]
        base.reset_counts()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = base.counts()
    after = eng.stats
    d = {k: after[k] - before[k] for k in (
        "steps", "generated_tokens", "verify_calls", "drafted_tokens",
        "accepted_tokens", "slot_iterations", "tree_nodes_drafted")}
    want = projection_launches(model, d["steps"], 0)
    out = dict(spec_k=cfg.get("spec_k", 0), requests=len(rids),
               decode_calls=d["steps"], verify_calls=d["verify_calls"],
               verify_windows={"W=%d" % w: n
                               for w, n in verifies.counts.items()},
               drafted_tokens=d["drafted_tokens"],
               accepted_tokens=d["accepted_tokens"],
               tokens_per_slot_iteration=d["generated_tokens"]
               / max(1, d["slot_iterations"]),
               step_ms=t_step.ms(), verify_ms=t_ver.ms(),
               mean_ms_per_step=t_step.ms() / max(1, len(t_step.events)),
               decode_tokens_per_s=d["generated_tokens"]
               / ((t_step.ms() + t_ver.ms()) / 1e3),
               launches=launches, wall_s=wall,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    if finite.ok is None or not bool(finite.ok):
        raise AssertionError("a sampled logit row was not finite")
    if launches != want:
        raise AssertionError("slot engine launches %r, wanted exactly %r"
                             % (launches, want))
    del eng
    torch.cuda.empty_cache()
    return [res[r].numpy() for r in rids], out


def serve_slots(model, motif_reqs):
    """The slot engine at 8B (``SLOT_SERVE``): every other request of
    phase 5's 12 (``CUT``), the greedy streams held against ``generate``
    by the C5 rule (``streams_vs_generate``); then one request of each
    kind of phase 6b's motif traffic (``MOTIF_CUT``) without speculation
    and with spec_k = 4,
    every speculative stream token-identical to its plain stream (a
    window lane attends with the step's shapes, and G1 rounds its rows as
    the step's)."""
    reqs = traffic(model.vocab_size)[CUT]
    motif_reqs = [motif_reqs[i] for i in MOTIF_CUT]
    streams, out = slot_run(model, reqs, SLOT_SERVE)
    log(phase="serve_slots", traffic="phase 5", **out)
    streams_vs_generate(model, reqs, streams)
    plain, out = slot_run(model, motif_reqs, SLOT_SERVE)
    log(phase="serve_slots", traffic="motif", **out)
    spec, out = slot_run(model, motif_reqs, dict(SLOT_SERVE, spec_k=4))
    log(phase="serve_slots", traffic="motif", **out)
    parted = []
    for j, ((p, kw), a, b) in enumerate(zip(motif_reqs, plain, spec)):
        diff = np.nonzero(a[0] != b[0])[0]
        if diff.size:
            at = int(diff[0])
            entry = dict(request=j, token=at - p.shape[1],
                         sampled="temperature" in kw)
            if not entry["sampled"]:
                lg = generate_logits(model, a[:, :at], p.shape[1], None)
                top, other = float(lg[a[0, at]]), float(lg[b[0, at]])
                ulp = 2.0 ** (np.floor(np.log2(abs(top))) - 7)
                entry.update(gap=top - other, gap_ulps=(top - other) / ulp)
            parted.append(entry)
    log(phase="slot_speculative_identity", requests=len(motif_reqs),
        identical=len(motif_reqs) - len(parted), parted=parted,
        drafted_tokens=out["drafted_tokens"],
        accepted_tokens=out["accepted_tokens"])
    if not out["verify_calls"]:
        raise AssertionError("the slot engine verified no window: %r" % out)
    if parted:
        raise AssertionError("the slot engine's speculative streams part "
                             "from its plain streams: %r" % parted)


def samplers_8b(model):
    """Beam search (4 beams) and ``SequenceSampler`` (4 samples) on the
    8B model, one 64-token prompt, 16 new tokens: finite scores, the
    prompt kept, rows sorted by score, the same samples from the same
    seed, and ``beam_size=1`` equal to greedy ``generate``."""
    from mxtpu_torch.models.sampler import (BeamSearchSampler,
                                            SequenceSampler, beam_search)

    p = np.random.RandomState(11).randint(0, model.vocab_size, (1, 64))
    n = 16
    t0 = time.perf_counter()
    beams, scores = BeamSearchSampler(model, beam_size=4)(p, n)
    t_beam = time.perf_counter() - t0
    one, _ = beam_search(model, p, n, beam_size=1)
    want = model.generate(torch.from_numpy(p).cuda(), n).cpu().numpy()
    s = SequenceSampler(model, n_samples=4, temperature=0.8, top_k=50)
    t0 = time.perf_counter()
    samples, sscores = s(p, n, seed=3)
    t_seq = time.perf_counter() - t0
    again, _ = s(p, n, seed=3)
    checks = dict(
        beam_shape=tuple(beams.shape) == (1, 4, 64 + n),
        beam_scores_finite=bool(np.isfinite(scores).all()),
        beams_sorted=bool((np.diff(scores, axis=1) <= 0).all()),
        beam_prompt_kept=bool((beams.numpy()[0, :, :64] == p).all()),
        beam_size_1_is_generate=bool(np.array_equal(one.numpy()[:, 0], want)),
        samples_shape=tuple(samples.shape) == (1, 4, 64 + n),
        sample_scores_finite=bool(np.isfinite(sscores).all()),
        samples_sorted=bool((np.diff(sscores, axis=1) <= 0).all()),
        sample_prompt_kept=bool((samples.numpy()[0, :, :64] == p).all()),
        seed_reproduces=bool(torch.equal(samples, again)))
    log(phase="samplers", beam_s=t_beam, sequence_s=t_seq,
        beam_scores=scores[0].tolist(), sample_scores=sscores[0].tolist(),
        **checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError("the samplers failed %r" % failed)


# -- phase 6h: the hierarchical prefix cache and sessions ----------------------

#: phase 6h's traffic: SESSIONS conversations of TURNS turns, each opening
#: with one 256-token system prompt and 64-192 tokens of its own, each
#: next turn the last transcript and 64 new tokens; session 1 seeded-
#: sampled; then a lull
SESSIONS, TURNS = 4, 3
SESSION_KW = {1: dict(temperature=0.8, top_p=0.9, seed=3001)}
#: H-host's pool, cut from SERVE's 512 pages to 76 so that pool pressure
#: spills session chains between turns: every session restores at least
#: once (turns 2-3) and every request shares what H-dev's shares.  With
#: ``overlap_swaps`` a request defers for a restore once an attempt (the
#: reference's rule): at 76 pages the last restore of a wave's cascade
#: does not fit when it runs, and that request recomputes its
#: transcript, so the overlapped engine gets 80 pages (3 of 4 sessions
#: restore, 4 deferred restores, every request shares what H-dev's does)
HOST_POOL, OVERLAP_POOL = 76, 80
#: the greedy session whose turn-3 restore in H-host meets the fault
#: plan, the wave's last (the policy is host bookkeeping of token counts
#: alone, so it restores at turn 3 whatever the model)
FAULT_SESSION = 3
#: the hierarchy's engines: H-dev pins everything on the device; H-host
#: spills every chain it cannot keep to a host tier of 2 GiB
H_DEV = dict(SERVE, pin_bytes="64GiB")
H_HOST = dict(SERVE, num_blocks=HOST_POOL, pin_bytes=0,
              host_cache_bytes="2GiB")
HIERARCHY_RUNS = (
    ("none", dict(SERVE), None),
    ("H-dev", H_DEV, None),
    ("H-host", H_HOST, None),
    ("H-host,overlap", dict(H_HOST, num_blocks=OVERLAP_POOL,
                            overlap_swaps=True), None),
    ("H-host,spec", dict(H_HOST, spec_k=4, spec_tree=(15, 2)), None),
    ("H-dev,int8", H_DEV, "int8"),
    ("H-host,int8", H_HOST, "int8"),
)
#: the engine a run is held token-identical to
IDENTICAL_TO = {"H-host": "H-dev", "H-host,overlap": "H-dev",
                "H-host,spec": "H-dev", "H-host,int8": "H-dev,int8"}


def session_traffic(vocab, seed=6):
    """Phase 6h's prompts: the turn-1 prompts of SESSIONS sessions (one
    256-token system prompt, then 64-192 tokens of each), the 64-token
    messages of turns 2..TURNS, the lull's 320-token prompt and its 4
    unrelated requests of 64-640 tokens."""
    rng = np.random.RandomState(seed)
    system = rng.randint(0, vocab, 256)
    opens = [np.concatenate([system, rng.randint(
        0, vocab, int(rng.randint(64, 193)))])[None].astype(np.int64)
             for _ in range(SESSIONS)]
    follow = [[rng.randint(0, vocab, (1, 64)) for _ in range(TURNS - 1)]
              for _ in range(SESSIONS)]
    lull = rng.randint(0, vocab, (1, 320))
    unrelated = [rng.randint(0, vocab, (1, int(rng.randint(64, 641))))
                 for _ in range(4)]
    return opens, follow, lull, unrelated


class CopyTimer:
    """CUDA events around every call of the model's ``read_pages`` or
    ``write_pages`` (one spilled or restored chain each) and the bytes
    it moved (its uint8 host buffer)."""

    def __init__(self, model, attr):
        self.model, self.attr = model, attr
        self.inner = getattr(model, attr)
        self.calls = []

    def __call__(self, pools, pages, *rest):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.inner(pools, pages, *rest)
        e.record()
        host = out if rest == () else rest[0]
        self.calls.append((len(pages), host.numel(), s, e))
        return out

    def summary(self):
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for _, _, s, e in self.calls]
        pages = sum(c[0] for c in self.calls)
        nbytes = sum(c[1] for c in self.calls)
        return dict(chains=len(ms), pages=pages, bytes=nbytes,
                    ms=sum(ms), ms_per_chain=sum(ms) / len(ms) if ms else None,
                    gb_per_s=nbytes / sum(ms) / 1e6 if sum(ms) else None)

    def __enter__(self):
        setattr(self.model, self.attr, self)
        return self

    def __exit__(self, *exc):
        delattr(self.model, self.attr)


class Spills:
    """Records every chain an engine's ``_spill_chain`` is handed: its
    pages, and whether the host tier took it."""

    def __init__(self, eng):
        self.eng = eng
        self.inner = None
        self.pages = 0
        self.stored = 0

    def __call__(self, chain):
        before = self.eng._swap_outs
        self.inner(chain)
        self.pages += len(chain.pages)
        self.stored += self.eng._swap_outs - before

    def __enter__(self):
        self.inner = self.eng._spill_chain
        self.eng._spill_chain = self
        return self

    def __exit__(self, *exc):
        del self.eng._spill_chain


class Restores:
    """Records every restore an engine's ``_try_swap_in`` makes: the
    wave (``label``), the request's session and the pages brought back
    from host."""

    def __init__(self, eng):
        self.eng = eng
        self.inner = None
        self.label = None
        self.events = []

    def __call__(self, req, full):
        before = self.eng._swap_ins
        try:
            return self.inner(req, full)
        finally:
            n = self.eng._swap_ins - before
            if n:
                self.events.append((self.label, req.session, n))

    def by_session(self):
        out = {}
        for _, s, n in self.events:
            out[str(s)] = out.get(str(s), 0) + n
        return out

    def __enter__(self):
        self.inner = self.eng._try_swap_in
        self.eng._try_swap_in = self
        return self

    def __exit__(self, *exc):
        del self.eng._try_swap_in


def hierarchy_run(model, name, cfg, cache_dtype, traffic, fault=False):
    """One engine of phase 6h through the session waves and the lull,
    with every launch counted (K1 and K2 one a layer a step or chunk, G1
    5 a layer and the head a step, 3 a layer and the head fused, exact),
    the copies timed, the spills and
    restores recorded, each wave's prefill time, tokens and tokens
    avoided read, and, after ``close_session`` of every session and
    ``drop_cache``, no page in use or pinned.  With ``fault`` the turn
    of the first greedy session whose transcript waits in the host tier
    at turn 3 is submitted with ``retries=1`` under
    ``serving.swap_in#<rid>@1:raise=OSError``: one quarantine, one
    retry.  Returns the streams by (session, turn) and "lull"/"repeat",
    and the run's record."""
    from mxtpu_torch import base
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine
    from mxtpu_torch.resilience import fault_plan

    L = len(model.layers)
    k1, k2 = k_names(cache_dtype)
    opens, follow, lull, unrelated = traffic
    eng = PagedContinuousBatchingEngine(model, cache_dtype=cache_dtype, **cfg)
    eng.submit(np.arange(64)[None], 2)           # warm-up, outside counts
    eng.run()
    eng.drop_cache()
    torch.cuda.reset_peak_memory_stats()
    before = eng.stats
    prompts = list(opens)
    streams, waves, faulted = {}, [], None

    def wave(label, subs, fault_key=None, lead=False):
        """Submit ``subs`` and run them out; with ``lead`` the first
        arrives alone and the others once its prompt is in the pool."""
        restores.label = label
        st0 = eng.stats
        with Timed(model, "prefill_pages") as t_pre:
            rids = {}
            for key, (p, kw) in subs.items():
                rids[key] = eng.submit(p, NEW_TOKENS, **kw)
                if lead:
                    eng.step()
                    while any(s is not None and s.prefilling
                              for s in eng._slots):
                        eng.step()
                    lead = False
            plan = contextlib.nullcontext()
            if fault_key is not None:
                plan = fault_plan("serving.swap_in#%d@1:raise=OSError(copy "
                                  "lost)" % rids[fault_key])
            with plan as armed:
                res = eng.run()
            torch.cuda.synchronize()
        if armed is not None and armed.stats() != {
                "serving.swap_in": {"hits": 2, "fired": 1}}:
            raise AssertionError("%s: the fault plan read %r"
                                 % (name, armed.stats()))
        st1 = eng.stats
        for key, rid in rids.items():
            streams[key] = res[rid].numpy()
            if eng.status(rid) != "ok":
                raise AssertionError("%s: request %r ended %s"
                                     % (name, key, eng.status(rid)))
        waves.append(dict(wave=label, prefill_ms=t_pre.ms(), **{
            k: st1[k] - st0[k] for k in (
                "prefill_tokens", "prefill_tokens_avoided", "prefill_chunks",
                "prefix_hit_requests", "session_hit_requests",
                "swapped_in_blocks", "swapped_out_blocks", "steps")}))
        return rids

    with Spills(eng) as spills, Restores(eng) as restores, \
            CopyTimer(model, "read_pages") as t_out, \
            CopyTimer(model, "write_pages") as t_in:
        torch.cuda.synchronize()
        base.reset_counts()
        t_run = time.perf_counter()
        for turn in range(TURNS):
            subs = {(s, turn): (prompts[s], dict(
                SESSION_KW.get(s, {}), **({} if name == "none"
                                          else dict(session=s))))
                    for s in range(SESSIONS)}
            if fault and turn == TURNS - 1:
                faulted = FAULT_SESSION
                subs[(faulted, turn)][1]["retries"] = 1
            wave("turn %d" % (turn + 1), subs,
                 None if faulted is None else (faulted, turn), lead=turn == 0)
            if turn + 1 < TURNS:
                prompts = [np.concatenate([streams[(s, turn)],
                                           follow[s][turn]], axis=1)
                           for s in range(SESSIONS)]
        wave("lull", dict([("lull", (lull, {}))] + [
            (("unrelated", j), (u, {})) for j, u in enumerate(unrelated)]))
        wave("repeat", {"repeat": (lull, {})})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = base.counts()
    after = eng.stats
    d = {k: after[k] - before[k] for k in (
        "steps", "prefill_chunks", "prefill_tokens", "prefill_tokens_avoided",
        "session_hit_requests", "prefix_hit_requests", "swapped_in_blocks",
        "swapped_out_blocks", "swap_out_failures", "deferred_swap_in_requests",
        "quarantined_requests", "retried_requests", "generated_tokens")}
    want = {k1: L * d["steps"], k2: L * d["prefill_chunks"]}
    want.update(projection_launches(model, d["steps"], d["prefill_chunks"]))
    if launches != want:
        raise AssertionError("%s: launches %r, wanted exactly %r"
                             % (name, launches, want))
    for s in range(SESSIONS):
        eng.close_session(s)
    eng.drop_cache()
    closed = eng.stats
    rec = dict(engine=name, cache_dtype=str(eng._cache_dtype),
               num_blocks=eng._bp.capacity,
               pin_blocks=eng._hc.pin_blocks, host_blocks=eng._hc.host_blocks,
               waves=waves, launches=launches, spilled_pages=spills.pages,
               spilled_pages_stored=spills.stored,
               restored_pages_by_session=restores.by_session(),
               restores=restores.events,
               spill=t_out.summary(), restore=t_in.summary(), wall_s=wall,
               blocks_in_use_after_close=closed["blocks_in_use"],
               pinned_blocks_after_close=closed["pinned_blocks"],
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               faulted_session=faulted, **d)
    log(phase="hierarchy", **rec)
    if closed["blocks_in_use"] or closed["pinned_blocks"]:
        raise AssertionError("%s: pages left after close_session and "
                             "drop_cache: %r" % (name, closed))
    if d["swap_out_failures"] or spills.stored != spills.pages:
        raise AssertionError("%s: a spill dropped its chain (%d of %d pages "
                             "stored, %d failures)"
                             % (name, spills.stored, spills.pages,
                                d["swap_out_failures"]))
    if d["swapped_out_blocks"] != spills.pages:
        raise AssertionError("%s: swapped_out_blocks %d != pages spilled %d"
                             % (name, d["swapped_out_blocks"], spills.pages))
    del eng
    torch.cuda.empty_cache()
    return streams, rec


def serve_sessions():
    """Phase 6h: the hierarchical prefix cache and sessions on the main
    path's model at ``CUT_DEPTH`` (``HIERARCHY_RUNS``).  Each engine serves
    ``session_traffic``'s waves and the lull.  Held: every stream of
    H-host, H-host with ``overlap_swaps`` and H-host with spec_k = 4
    token-identical to H-dev's (int8 H-host to int8 H-dev), and their
    session waves' prefill tokens and tokens avoided equal; the greedy
    H-dev streams against ``generate`` by the C5 rule; 8 session hits
    a run in turns 2-3 but in the no-hierarchy engine; spills and
    restores in every H-host run, every session restored at least once
    in H-host and int8 H-host, no spill dropped;
    deferred restores with ``overlap_swaps``; H-dev never spilling; the
    lull's repeat a prefix hit; the one faulted restore in H-host: one
    quarantine, one retry.  Then a page round trip on 16 seeded pages of
    bf16 and int8 pools, ``torch.equal``."""
    model = llama_3_8b_model(CUT_DEPTH)
    traffic = session_traffic(model.vocab_size)
    runs, recs = {}, {}
    for name, cfg, cache_dtype in HIERARCHY_RUNS:
        runs[name], recs[name] = hierarchy_run(
            model, name, cfg, cache_dtype, traffic, fault=name == "H-host" and FAULT_SESSION is not None)
    problems = []
    session_waves = ["turn %d" % (t + 1) for t in range(TURNS)] + ["lull"]
    for name, ref in IDENTICAL_TO.items():
        a, b = runs[ref], runs[name]
        parted = sorted(str(k) for k in a if k != "repeat"
                        and not np.array_equal(a[k], b[k]))
        if parted:
            problems.append("%s parts from %s at %s" % (name, ref, parted))
        for key in ("prefill_tokens", "prefill_tokens_avoided"):
            x = [w[key] for w in recs[ref]["waves"]
                 if w["wave"] in session_waves]
            y = [w[key] for w in recs[name]["waves"]
                 if w["wave"] in session_waves]
            if x != y:
                problems.append("%s's %s by wave %r != %s's %r"
                                % (name, key, y, ref, x))
        rec = recs[name]
        if rec["swapped_in_blocks"] <= 0 or rec["swapped_out_blocks"] <= 0:
            problems.append("%s restored %d and spilled %d pages"
                            % (name, rec["swapped_in_blocks"],
                               rec["swapped_out_blocks"]))
        missing = [s for s in range(SESSIONS)
                   if not rec["restored_pages_by_session"].get(str(s))]
        if missing and name in ("H-host", "H-host,int8"):
            # (the overlapped engine's larger pool spares one session;
            # the speculative one's timing may spare one)
            problems.append("%s: sessions %r never restored" % (name, missing))
    for name, rec in recs.items():
        # turns 2-3: every session's transcript (turn 1's later arrivals
        # hit the system prompt too, and are read apart)
        want_hits = 0 if name == "none" else SESSIONS * (TURNS - 1)
        hits = sum(w["session_hit_requests"] for w in rec["waves"]
                   if w["wave"] not in ("turn 1", "lull", "repeat"))
        if hits != want_hits:
            problems.append("%s: %d session hits in turns 2-%d, wanted %d"
                            % (name, hits, TURNS, want_hits))
        repeat = rec["waves"][-1]
        if name != "none" and (repeat["prefix_hit_requests"] != 1
                               or repeat["prefill_tokens_avoided"] < 304):
            problems.append("%s: the lull's repeat was no prefix hit: %r"
                            % (name, repeat))
        if name.startswith("H-dev") and rec["spilled_pages"]:
            problems.append("%s spilled %d pages" % (name,
                                                     rec["spilled_pages"]))
    if recs["H-host,overlap"]["deferred_swap_in_requests"] <= 0:
        problems.append("no restore was deferred with overlap_swaps")
    if (recs["H-host"]["quarantined_requests"],
            recs["H-host"]["retried_requests"]) != (1, 1):
        problems.append("the faulted restore gave %d quarantines and %d "
                        "retries" % (recs["H-host"]["quarantined_requests"],
                                     recs["H-host"]["retried_requests"]))
    if recs["H-dev"]["prefill_chunks"] >= recs["none"]["prefill_chunks"]:
        problems.append("the hierarchy ran no fewer chunks than none")
    # the repeat of the lull's prompt: a pinned hit shares 319 tokens (19
    # pages and a 15-token copy-on-write clone), a restore 304 (whole
    # pages): another chunk plan.  Every restoring engine's repeat is
    # H-host's (int8: int8 H-host's), held by the C5 rule where it parts
    # from H-dev's
    for name, ref in (("H-host", "H-dev"), ("H-host,int8", "H-dev,int8")):
        for other in IDENTICAL_TO:
            if other.endswith("int8") == name.endswith("int8") and not \
                    np.array_equal(runs[name]["repeat"],
                                   runs[other]["repeat"]):
                problems.append("%s's repeat parts from %s's"
                                % (other, name))
        parts = not np.array_equal(runs[ref]["repeat"], runs[name]["repeat"])
        log(phase="hierarchy_repeat", engine=name, parts_from=ref,
            parted=parts)
        if parts:
            streams_vs_generate(model, [(traffic[2], {})],
                                [runs[name]["repeat"]],
                                "int8" if name.endswith("int8") else None)
    keys = [(s, t) for t in range(TURNS) for s in range(SESSIONS)
            if s not in SESSION_KW]
    reqs, greedy = [], []
    for s, t in keys:
        reqs.append((runs["H-dev"][(s, t)][:, :-NEW_TOKENS], {}))
        greedy.append(runs["H-dev"][(s, t)])
    reqs.append((traffic[2], {}))
    greedy.append(runs["H-dev"]["lull"])
    streams_vs_generate(model, reqs, greedy)
    # turn 1 and the lull: the same prompts with and without the
    # hierarchy (a reading; later turns follow each engine's transcript)
    first = [k for k in keys if k[1] == 0]
    compare_streams("hierarchy_vs_none", [(runs["H-dev"][k][:, :-NEW_TOKENS],
                                           {}) for k in first]
                    + [(traffic[2], {})],
                    [runs["none"][k] for k in first] + [runs["none"]["lull"]],
                    [runs["H-dev"][k] for k in first] + [runs["H-dev"]["lull"]])
    turn_ms = {name: sum(w["prefill_ms"] for w in rec["waves"]
                         if w["wave"] in ("turn 2", "turn 3"))
               for name, rec in recs.items()}
    turn_tokens = {name: sum(w["prefill_tokens"] for w in rec["waves"]
                             if w["wave"] in ("turn 2", "turn 3"))
                   for name, rec in recs.items()}
    log(phase="hierarchy_avoided", turns="2-3", prefill_ms=turn_ms,
        prefill_tokens=turn_tokens,
        avoided_ms={n: turn_ms["none"] - v for n, v in turn_ms.items()},
        avoided_tokens={n: turn_tokens["none"] - v
                        for n, v in turn_tokens.items()})
    page_round_trip()
    if problems:
        raise AssertionError("phase 6h: " + "; ".join(problems))


def page_round_trip(n=16, seed=7):
    """``read_pages`` then ``write_pages`` of 16 seeded pages of the 8B
    geometry's pools (one layer's k and v, 8 kv heads, block 16, head_dim
    128), bf16 and int8, into 16 fresh pages: every pool tensor's rows
    ``torch.equal`` to the originals, the host rows pinned."""
    from mxtpu_torch.models.transformer import TransformerLM, pool_tensors

    model = TransformerLM(256, 4096, 64, 1, 32, 8, device="cuda",
                          dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for dtype in ("bfloat16", "int8"):
        pools = model.init_block_pool(4 * n, 16, dtype)
        for t in pool_tensors(pools):
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device="cuda", dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
        perm = np.random.RandomState(seed).permutation(4 * n - 1) + 1
        src, dst = [int(b) for b in perm[:n]], [int(b) for b in perm[n:2 * n]]
        host = model.read_pages(pools, src)
        model.write_pages(pools, dst, host)
        torch.cuda.synchronize()
        equal = all(torch.equal(t[dst], t[src]) for t in pool_tensors(pools))
        pinned = host.is_pinned()
        log(phase="page_round_trip", dtype=dtype, pages=n, equal=equal,
            pinned=pinned, bytes_a_page=host.shape[1])
        if not (equal and pinned):
            raise AssertionError("page round trip (%s): equal %s, pinned %s"
                                 % (dtype, equal, pinned))


# -- phase 6e: tracing, live weight hot-swap and cancel ---------------------

#: phase 6e(b)'s model: phase 10's cut of llama_3_8b (full width, 4 of 32
#: layers, 1.92 B parameters).  A whole-8B checkpoint in the reference's
#: format (float32 arrays in a pickle) is 32 GB on the host, and the phase
#: reads it twice.
HOTSWAP_DEPTH = 0.125
#: phase 5's traffic split for 6e(b): the first 8 requests (one a slot,
#: so all are admitted before adopt()) and the 4 submitted after it
HOTSWAP_SPLIT = 8


def timeline_problems(tracer, rids, tag="eng"):
    """Each request's trace timeline must open with ``engine.admit`` and
    close with ``engine.finish``: the requests where it does not."""
    out = []
    for rid in rids:
        kinds = [e.etype for e in tracer.timeline("%s:%d" % (tag, rid))]
        if kinds[:1] != ["engine.admit"] or kinds[-1:] != ["engine.finish"]:
            out.append("request %d's timeline runs %s .. %s"
                       % (rid, kinds[:1], kinds[-1:]))
    return out


def serve_traced(model, streams):
    """Phase 6e(a): phase 5's engine settings and traffic on the resident
    8B model, untraced and under ``tracing()`` and ``flight_recording()``
    in turns (untraced, traced, traced, untraced) on one engine, warmed
    up as phase 5's: every run's streams token-identical to phase 5's,
    its launches phase 5's exactly (tracing adds no device work), each
    traced request's timeline from ``engine.admit`` to ``engine.finish``,
    no event dropped, no postmortem.  Logs each run's device ms a decode
    step (CUDA events around ``step_pages``) and wall ms a decode step
    (the run's host time over its decode steps) beside phase 5's, the
    events recorded and the bytes of one ``export_chrome_trace``; then
    one traced iteration under ``torch.profiler``, which must hold an
    ``engine.iteration`` range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxtpu_torch import base
    from mxtpu_torch.observability import (export_chrome_trace,
                                           flight_recording, tracing)
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    eng = PagedContinuousBatchingEngine(model, **SERVE)
    eng.submit(np.arange(64)[None], 2)           # warm-up, as phase 5's
    eng.run()
    reqs = traffic(model.vocab_size)
    runs, problems = [], []
    for traced in (False, True, True, False):
        with contextlib.ExitStack() as stack:
            if traced:
                tr = stack.enter_context(tracing())
                fl = stack.enter_context(flight_recording(256))
            t_dec = stack.enter_context(Timed(model, "step_pages"))
            torch.cuda.synchronize()
            rids = [eng.submit(p, NEW_TOKENS, **kw) for p, kw in reqs]
            base.reset_counts()
            t0 = time.perf_counter()
            res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = len(t_dec.events)
            run = dict(traced=traced, launches=base.counts(), steps=steps,
                       wall_ms_per_decode_step=wall * 1e3 / steps,
                       ms_per_decode_step=t_dec.ms() / steps)
            parted = [j for j, r in enumerate(rids)
                      if not np.array_equal(res[r].numpy(), streams[j])]
            if parted:
                problems.append("run %d: streams %r part from phase 5's"
                                % (len(runs), parted))
            if traced:
                problems += timeline_problems(tr, rids)
                run.update(events=len(tr.events()),
                           dropped_events=tr.dropped_events,
                           chrome_trace_bytes=len(
                               export_chrome_trace().encode()),
                           postmortems=len(fl.postmortems))
            runs.append(run)
    with tracing():
        eng.submit(reqs[1][0], 4)
        eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        eng.run()
    # the host's ranges; the profiler mirrors each on the device's timeline
    ranges = sum(1 for e in prof.events() if e.name == "engine.iteration"
                 and e.device_type == DeviceType.CPU)
    for run in runs:
        log(phase="traced_rerun", **run)

    def mean(key, traced):
        vals = [r[key] for r in runs if r["traced"] == traced]
        return sum(vals) / len(vals)

    log(phase="traced_rerun_summary", card=card_line(),
        profiled_iteration_ranges=ranges,
        ms_per_decode_step=dict(traced=mean("ms_per_decode_step", True),
                                untraced=mean("ms_per_decode_step", False),
                                phase5=MAIN_PATH.get("ms_per_decode_step")),
        wall_ms_per_decode_step=dict(
            traced=mean("wall_ms_per_decode_step", True),
            untraced=mean("wall_ms_per_decode_step", False),
            phase5=MAIN_PATH["wall_s"] * 1e3 / MAIN_PATH["steps"]
            if MAIN_PATH else None))
    want = MAIN_PATH.get("launches", runs[0]["launches"])
    for j, run in enumerate(runs):
        if run["launches"] != want or (MAIN_PATH and run["steps"]
                                       != MAIN_PATH["steps"]):
            problems.append("run %d: launches %r in %d steps, phase 5's %r"
                            % (j, run["launches"], run["steps"], want))
        if run["traced"] and (run["dropped_events"] or run["postmortems"]):
            problems.append("run %d: %d events dropped, %d postmortems"
                            % (j, run["dropped_events"], run["postmortems"]))
    if ranges < 1:
        problems.append("no engine.iteration range in the profiled step")
    if problems:
        raise AssertionError("phase 6e(a): " + "; ".join(problems))


def write_generation(named, path):
    """One weight generation in the reference's checkpoint form: the
    arrays of ``export_mxtpu_params`` (float32) → ``pickle.dumps({"params":
    ...})`` → ``write_verified``.  Returns the bytes written."""
    import pickle

    from mxtpu_torch.resilience import write_verified

    blob = pickle.dumps({"params": named})
    write_verified(path, blob)
    return len(blob)


def corrupt_copy(src, dst, at=10, n=3):
    """A copy of a verified checkpoint (payload and manifest) with ``n``
    bytes flipped at byte ``at``."""
    import shutil

    shutil.copyfile(src, dst)
    shutil.copyfile(src + ".mxmf", dst + ".mxmf")
    with open(dst, "r+b") as f:
        f.seek(at)
        flipped = bytes(b ^ 0xFF for b in f.read(n))
        f.seek(at)
        f.write(flipped)


def _sync(model):
    if model.device.type == "cuda":
        torch.cuda.synchronize()


def serve_streams(eng, reqs, n):
    """Submit ``reqs`` at once and drain: their streams, in order."""
    rids = [eng.submit(p, n, **kw) for p, kw in reqs]
    res = eng.run()
    return [res[r].numpy() for r in rids]


def hotswap_run(model, fresh_b, path, reqs, cfg, n, split=HOTSWAP_SPLIT,
                keep=None):
    """Phase 6e(b)'s schedule on ``model`` (generation A), with the
    verified checkpoint of generation B at ``path`` and ``fresh_b``, a
    model that ``load_mxtpu_params`` gave B's arrays.  The references: an
    engine on A that never adopts serving ``reqs[:split]``, one on
    ``fresh_b`` serving ``reqs[split:]``.  Then one engine on A: the
    first requests admitted, ``adopt(path)``, the rest submitted while B
    is staged: the first finish equal to A's streams, the rest equal to
    B's; ``rollback()``, and the first requests again equal A's; a copy
    of B with three bytes flipped raises ``CorruptCheckpointError`` and
    leaves the generation as it was; the first requests once more, one
    of them cancelled after its second token: the others equal A's, its
    output a prefix of A's stream, the pages in use back to their count
    before.  Returns the record (times in ms on the host clock, the
    model's device synchronized) and the problems found; ``keep``, a
    dict, receives A's streams of the first requests as ``want_a``."""
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine
    from mxtpu_torch.resilience import CorruptCheckpointError

    first, second = reqs[:split], reqs[split:]
    want_a = serve_streams(PagedContinuousBatchingEngine(model, **cfg),
                           first, n)
    if keep is not None:
        keep["want_a"] = want_a
    want_b = serve_streams(PagedContinuousBatchingEngine(fresh_b, **cfg),
                           second, n)
    eng = PagedContinuousBatchingEngine(model, **cfg)
    problems, rec = [], {}

    def held(name, got, want):
        parted = [i for i, (g, w) in enumerate(zip(got, want))
                  if not np.array_equal(g, w)]
        if parted or len(got) != len(want):
            problems.append("%s: streams %r part" % (name, parted))

    place = []
    prepare = model.prepare_adoption

    def timed_prepare(named):
        t = time.perf_counter()
        leaves = prepare(named)
        _sync(model)
        place.append((time.perf_counter() - t,
                      sum(x.numel() * x.element_size() for x in leaves),
                      sum(np.asarray(a).nbytes for a in named.values())))
        return leaves

    installs = []
    install = eng._maybe_install_adoption

    def timed_install():
        gen = eng.stats["param_generation"]
        t = time.perf_counter()
        install()
        _sync(model)
        if eng.stats["param_generation"] != gen:
            installs.append(time.perf_counter() - t)

    eng._maybe_install_adoption = timed_install
    model.prepare_adoption = timed_prepare
    try:
        rids = [eng.submit(p, n, **kw) for p, kw in first]
        eng.step()                      # every one admitted, on A
        t = time.perf_counter()
        if eng.adopt(path) != 1:
            problems.append("adopt staged another generation than 1")
        rec["adopt_ms"] = (time.perf_counter() - t) * 1e3
    finally:
        del model.prepare_adoption
    later = [eng.submit(p, n, **kw) for p, kw in second]
    res = eng.run()
    held("in flight at adopt vs A", [res[r].numpy() for r in rids], want_a)
    held("admitted after the install vs B", [res[r].numpy() for r in later],
         want_b)
    st = eng.stats
    rec.update(stage_to_install_steps=st["last_adoption_steps"],
               install_ms=installs[0] * 1e3 if installs else None,
               place_ms=place[0][0] * 1e3, placed_bytes=place[0][1],
               host_bytes=place[0][2],
               place_gb_per_s=place[0][1] / place[0][0] / 1e9,
               read_verify_unpickle_ms=rec["adopt_ms"] - place[0][0] * 1e3)
    if (st["param_generation"], st["adoptions"]) != (1, 1) or not installs:
        problems.append("after the install: %r" % st)
    if eng.rollback() != 2:
        problems.append("rollback staged another generation than 2")
    held("after rollback vs A", serve_streams(eng, first, n), want_a)
    bad = path + ".corrupt"
    corrupt_copy(path, bad)
    t = time.perf_counter()
    try:
        eng.adopt(bad)
        problems.append("a corrupt checkpoint was adopted")
    except CorruptCheckpointError:
        rec["read_verify_ms"] = (time.perf_counter() - t) * 1e3
    finally:
        for f in (bad, bad + ".mxmf"):
            os.remove(f)
    st = eng.stats
    if (st["param_generation"], st["adoption_staged"],
            st["adoption_failures"]) != (2, 0, 1):
        problems.append("after the corrupt checkpoint: %r" % st)
    in_use = st["blocks_in_use"]
    rids = [eng.submit(p, n, **kw) for p, kw in first]
    victim = rids[int(np.argmin([p.shape[1] for p, _ in first]))]
    for _ in range(64 * len(first)):
        eng.step()
        slot = [s for s in eng._slots if s is not None and s.req.rid == victim]
        if slot and slot[0].n_emitted >= 2:
            break
    if not eng.cancel(victim) or eng.status(victim) != "cancelled":
        problems.append("cancel of request %d refused" % victim)
    res = eng.run()
    got = [res[r].numpy() for r in rids]
    v = rids.index(victim)
    held("beside the cancel vs A", got[:v] + got[v + 1:],
         want_a[:v] + want_a[v + 1:])
    cut = got[v].shape[1]
    if not (first[v][0].shape[1] < cut < want_a[v].shape[1]
            and np.array_equal(got[v], want_a[v][:, :cut])):
        problems.append("the cancelled stream (%d tokens) is no prefix of "
                        "A's" % cut)
    rec.update(cancelled_tokens=cut - first[v][0].shape[1],
               blocks_in_use=eng.stats["blocks_in_use"],
               blocks_in_use_before=in_use)
    if eng.stats["blocks_in_use"] != in_use:
        problems.append("cancel left %d pages in use, %d before"
                        % (eng.stats["blocks_in_use"], in_use))
    return rec, problems


def serve_hotswap():
    """Phase 6e(b): live weight hot-swap and cancel at full width.
    Generation A is ``llama_3_8b(depth_factor=0.125)`` in bf16 from seed
    0, generation B the same from seed 1, written by
    ``write_generation`` into a temporary directory (removed at the end);
    ``hotswap_run`` on phase 5's engine settings and traffic, every
    kernel's count set to 0 before it and K1, K2 and G1 (and the fused
    norm) required to have launched after.  Logs the write's seconds
    and bytes, the ms to read and verify B (the corrupt copy's refusal,
    which reads it whole), the ms and GB/s to place B, the stage →
    install iterations and the install's ms, and the peak memory.
    Returns generation A's model and its streams of the first 8 requests
    (phase 6r(b)'s references)."""
    import shutil
    import tempfile

    from mxtpu_torch import base
    from mxtpu_torch.models.convert import (export_mxtpu_params,
                                            load_mxtpu_params)
    from mxtpu_torch.models.transformer import llama_3_8b

    torch.cuda.reset_peak_memory_stats()
    models = []
    for seed in (0, 1):
        m = llama_3_8b(depth_factor=HOTSWAP_DEPTH, device="cuda")
        init_weights(m, torch.Generator(device="cuda").manual_seed(seed),
                     0.02)
        models.append(m)
    model = models[0]
    named = export_mxtpu_params(models.pop())
    fresh_b = llama_3_8b(depth_factor=HOTSWAP_DEPTH, device="cuda")
    load_mxtpu_params(fresh_b, named)
    tmp = tempfile.mkdtemp(prefix="hotswap-")
    try:
        path = os.path.join(tmp, "generation-b.ckpt")
        t = time.perf_counter()
        nbytes = write_generation(named, path)
        write_s = time.perf_counter() - t
        del named
        gc.collect()
        base.reset_counts()
        keep = {}
        rec, problems = hotswap_run(model, fresh_b, path,
                                    traffic(model.vocab_size), SERVE,
                                    NEW_TOKENS, keep=keep)
        launches = base.counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(phase="hotswap", card=card_line(), layers=len(model.layers),
        params=sum(p.numel() for p in model.parameters()),
        checkpoint_bytes=nbytes, write_s=write_s, launches=launches,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, **rec)
    for k in ("paged_attention", "paged_prefill", "rows_linear",
              "rows_norm_linear"):
        if not launches.get(k):
            problems.append("the hot-swap path never launched %s" % k)
    if problems:
        raise AssertionError("phase 6e(b): " + "; ".join(problems))
    return model, keep["want_a"]


# -- phase 6r: the replica service layer -------------------------------------

#: phase 6r(a)'s faulted run on phase 5's traffic (``replicas_run``): r1's
#: health probe at this hit (a gateway tick) declares it dead, with
#: fail_threshold 1; by then it holds streams that have emitted tokens
#: (the run checks it)
REPLICA_DEATH_HIT = 8
#: probation: r1 is revived this many gateway ticks after its death
REPLICA_REVIVE_TICKS = 6
#: the request whose first dispatch raises ReplicaDownError (rerouted)
REPLICA_REROUTED = 4
#: the request with a tick deadline (609 tokens, 10 chunks), hedged once
#: REPLICA_HEDGE_FRACTION of it has passed unfinished
REPLICA_HEDGED = 5
REPLICA_DEADLINE = 400
REPLICA_HEDGE_FRACTION = 0.05
#: the gateway queue's bound: 11 low-class requests fill it and the
#: high-class 12th displaces the newest of them (request 10), which is
#: resubmitted once r1 is back
REPLICA_MAX_PENDING = 11
#: the autoscaled run: engines of 4 slots (phase 5's settings otherwise),
#: one arrival a tick, so that 12 requests need 3 replicas; quiet ticks
#: after a decision
AUTOSCALE_SLOTS = 4
AUTOSCALE_COOLDOWN = 4


class HostTimer:
    """Host seconds of every call of one attribute (a method of a class
    or an instance), by call, while entered; nothing synchronizes."""

    def __init__(self, owner, attr):
        self.owner, self.attr = owner, attr
        self.inner = None
        self.calls = []

    def __call__(self, *args, **kw):
        t = time.perf_counter()
        try:
            return self.inner(*args, **kw)
        finally:
            self.calls.append(time.perf_counter() - t)

    def __enter__(self):
        self.inner = getattr(self.owner, self.attr)
        wrapper = self
        if isinstance(self.owner, type):
            def method(obj, *args, **kw):
                return wrapper(obj, *args, **kw)
            setattr(self.owner, self.attr, method)
        else:
            setattr(self.owner, self.attr, self)
        return self

    def __exit__(self, *exc):
        if isinstance(self.owner, type):
            setattr(self.owner, self.attr, self.inner)
        else:
            delattr(self.owner, self.attr)

    def take(self):
        """The seconds recorded since the last take."""
        out, self.calls = sum(self.calls), []
        return out


def engine_work(engines):
    """(decode steps, prefill chunks) the engines ran so far."""
    return (sum(e.stats["steps"] for e in engines),
            sum(e.stats["prefill_chunks"] for e in engines))


def gateway_loop(gw, done, limit, on_tick=None, autoscaler=None):
    """Pump ``gw`` until ``done()`` (at most ``limit`` pumps); per tick the
    wall seconds, the host seconds inside the replicas' ``step`` and in
    the pooled tokens' host read (``_host_rows``, where a poll waits for
    the card).  ``on_tick()`` runs after each pump (and the autoscaler's
    tick)."""
    from mxtpu_torch.serving import InProcessReplica

    ticks = []
    with HostTimer(InProcessReplica, "step") as st, \
            HostTimer(InProcessReplica, "_host_rows") as rows:
        for _ in range(limit):
            if done():
                break
            t = time.perf_counter()
            gw.pump()
            wall = time.perf_counter() - t
            ticks.append((wall, st.take(), rows.take()))
            if autoscaler is not None:
                autoscaler.tick()
            if on_tick is not None:
                on_tick()
        else:
            raise AssertionError("the gateway did not finish in %d ticks"
                                 % limit)
    return ticks


def tick_summary(ticks):
    """ms a gateway tick: wall, the replicas' step (host), the host read
    of the pooled tokens, and the rest (the service layer's own)."""
    n = len(ticks)
    wall, step, rows = (sum(t[k] for t in ticks) * 1e3 / n for k in range(3))
    return dict(ticks=n, wall_ms_per_tick=wall, step_ms_per_tick=step,
                token_read_ms_per_tick=rows,
                service_ms_per_tick=wall - step - rows)


def replicas_run(model, reqs, want, cfg, n):
    """Phase 6r(a)'s three runs of ``reqs`` through the service layer on
    ``model``: three paged replicas (``cfg``) sharing it behind a
    ``Gateway`` with the locality router (clean, then faulted), then an
    ``Autoscaler`` from 1 replica of AUTOSCALE_SLOTS to 3 and back.
    ``want`` are the requests' streams from one engine.  Every completed
    stream must equal its ``want`` and its streamed tokens its suffix,
    each run's kernel launches be exact (``projection_launches`` and 32 a
    layer a step or chunk), every replica end at ``blocks_in_use ==
    pinned_blocks``; the faulted run must see one death of r1 while it
    held emitted tokens (its drained pages 0, its requests requeued and
    served), one reroute, one hedge, one QoS shed (resubmitted after the
    revive, which r1 serves) and one revive; the autoscaled run must grow
    and retire back to one replica, the retired ones at zero pages.
    Returns the record and the problems found."""
    from mxtpu_torch import base
    from mxtpu_torch.observability import tracing
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine
    from mxtpu_torch.resilience import QosShedError, fault_plan
    from mxtpu_torch.serving import Autoscaler, Gateway, replica_pool

    L = len(model.layers)
    problems, rec = [], {}
    sync = torch.cuda.synchronize if model.device.type == "cuda" \
        else (lambda: None)

    def held(run, gw, rids):
        """Streams against ``want`` (``rids[i]`` serves request i)."""
        for i, rid in rids.items():
            if gw.status(rid) != "ok":
                problems.append("%s: request %d ended %s" % (
                    run, i, gw.status(rid)))
                continue
            out = gw.result(rid).numpy()
            if not np.array_equal(out, want[i]):
                parted = np.nonzero(out[0] != want[i][0])[0]
                problems.append("%s: request %d parts at %d" % (
                    run, i, int(parted[0]) if len(parted) else -1))
                log(phase="replicas_parted", run=run, request=i,
                    prompt_tokens=int(reqs[i][0].shape[1]),
                    at=int(parted[0]) if len(parted) else None)
            tp = reqs[i][0].shape[1]
            if gw.streamed(rid) != out[0, tp:].tolist():
                problems.append("%s: request %d's streamed tokens are not "
                                "its output's suffix" % (run, i))

    def launches_exact(run, engines, before, counts):
        steps, chunks = (a - b for a, b in zip(engine_work(engines), before))
        want_l = {"paged_attention": L * steps, "paged_prefill": L * chunks}
        want_l.update(projection_launches(model, steps, chunks))
        if model.device.type == "cuda" and counts != want_l:
            problems.append("%s: launches %r, wanted exactly %r"
                            % (run, counts, want_l))
        return dict(steps=steps, chunks=chunks, launches=counts)

    def pages_settled(run, engines):
        for j, e in enumerate(engines):
            st = e.stats
            if st["blocks_in_use"] != st["pinned_blocks"]:
                problems.append("%s: replica %d ends with %d pages in use, "
                                "%d pinned" % (run, j, st["blocks_in_use"],
                                               st["pinned_blocks"]))

    engines = [PagedContinuousBatchingEngine(model, ledger_tag="r%d" % i,
                                             **cfg) for i in range(3)]
    limit = 40 * (n + 16)

    # -- clean --------------------------------------------------------------
    before = engine_work(engines)
    hits0 = [e.stats["prefix_hit_requests"] for e in engines]
    gw = Gateway(engines, hedge_fraction=None)
    rids = {i: gw.submit(p, n, **kw) for i, (p, kw) in enumerate(reqs)}
    sync()
    base.reset_counts()
    ticks = gateway_loop(gw, lambda: all(gw.status(r) not in (
        "queued", "dispatched") for r in rids.values()), limit)
    sync()
    held("clean", gw, rids)
    rec["clean"] = dict(
        tick_summary(ticks), **launches_exact("clean", engines, before,
                                              base.counts()),
        ttft_ticks=sorted(gw.stats["ttft_ticks"].values()),
        prefix_hits=[e.stats["prefix_hit_requests"] - h
                     for e, h in zip(engines, hits0)])
    pages_settled("clean", engines)

    # -- faulted ------------------------------------------------------------
    before = engine_work(engines)
    gw = Gateway(engines, fail_threshold=1,
                 revive_after_ticks=REPLICA_REVIVE_TICKS,
                 hedge_fraction=REPLICA_HEDGE_FRACTION, qos_classes=2,
                 max_pending=REPLICA_MAX_PENDING)
    rids = {}
    for i, (p, kw) in enumerate(reqs):
        extra = dict(deadline_ticks=REPLICA_DEADLINE) \
            if i == REPLICA_HEDGED else {}
        rids[i] = gw.submit(p, n, qos=0 if i == len(reqs) - 1 else 1,
                            **extra, **kw)
    shed = [i for i, r in rids.items() if gw.status(r) == "shed"]
    retry_after = [gw.error(rids[i])["exception"].retry_after_ticks
                   for i in shed]
    plan = ("replica.health#r1@%d:raise=OSError(replica r1 lost);"
            "router.dispatch#%d@1:raise=mxtpu_torch.serving.transport."
            "ReplicaDownError(link flap)" % (REPLICA_DEATH_HIT,
                                             rids[REPLICA_REROUTED]))
    state = dict(prev_on_r1={}, death=None, redispatch={}, resubmitted=None,
                 resub_replica=None)

    def on_r1():
        return {i: len(gw.streamed(r)) for i, r in rids.items()
                if r in gw._reqs and "r1" in gw._reqs[r].gens.values()}

    def watch():
        sup = gw.supervisor.stats
        if sup["deaths"] and state["death"] is None:
            st = engines[1].stats
            requeued = [i for i, r in rids.items()
                        if r in gw._reqs and gw._reqs[r].requeues]
            state["death"] = dict(
                tick=gw.tick_count, requeued=requeued,
                emitted_before={i: state["prev_on_r1"].get(i, 0)
                                for i in requeued},
                pages=(st["blocks_in_use"], st["pinned_blocks"]))
        elif state["death"] is None:
            state["prev_on_r1"] = on_r1()
        if state["death"] is not None:
            for i in state["death"]["requeued"]:
                if i not in state["redispatch"] and gw._reqs[rids[i]].gens:
                    state["redispatch"][i] = gw.tick_count
        if sup["revivals"] and state["resubmitted"] is None:
            p, kw = reqs[shed[0]]
            state["resubmitted"] = gw.submit(p, n, qos=1, **kw)
            state["resub_tick"] = gw.tick_count
        r = state["resubmitted"]
        if r is not None and state["resub_replica"] is None and \
                gw._reqs[r].gens:
            state["resub_replica"] = sorted(gw._reqs[r].gens.values())[0]

    def faulted_done():
        return state["resubmitted"] is not None and all(
            gw.status(r) not in ("queued", "dispatched")
            for r in list(rids.values()) + [state["resubmitted"]])

    hits0 = [e.stats["prefix_hit_requests"] for e in engines]
    sync()
    base.reset_counts()
    with tracing() as tr, fault_plan(plan):
        ticks = gateway_loop(gw, faulted_done, limit, on_tick=watch)
    sync()
    counts = base.counts()
    if len(shed) != 1:
        problems.append("faulted: %d requests shed, wanted 1" % len(shed))
    else:
        rids[shed[0]] = state["resubmitted"]
    held("faulted", gw, rids)
    st = gw.stats
    sup = st["supervisor"]
    death = state["death"] or {}
    if (sup["deaths"], sup["revivals"], st["router"]["reroutes"],
            st["hedged_requests"], st["qos_shed_requests"]) != (1, 1, 1, 1, 1):
        problems.append("faulted: deaths %d, revivals %d, reroutes %d, "
                        "hedges %d, QoS sheds %d; wanted one each"
                        % (sup["deaths"], sup["revivals"],
                           st["router"]["reroutes"], st["hedged_requests"],
                           st["qos_shed_requests"]))
    if not any(death.get("emitted_before", {}).values()):
        problems.append("faulted: r1 died holding no stream with emitted "
                        "tokens (%r)" % (death,))
    if death.get("pages") != (0, 0):
        problems.append("faulted: the dead r1 holds pages %r after its "
                        "drain" % (death.get("pages"),))
    if state["resub_replica"] != "r1":
        problems.append("faulted: the revived r1 served nothing (the "
                        "resubmitted request went to %r)"
                        % (state["resub_replica"],))
    requeue_events = [e for e in tr.events(types=["gateway.requeue"])]
    if len(requeue_events) != len(death.get("requeued", ())) or \
            not requeue_events:
        problems.append("faulted: %d gateway.requeue events for %d requeued "
                        "requests" % (len(requeue_events),
                                      len(death.get("requeued", ()))))
    rec["faulted"] = dict(
        tick_summary(ticks), **launches_exact("faulted", engines, before,
                                              counts),
        death_tick=death.get("tick"), requeued=death.get("requeued"),
        emitted_before_death=death.get("emitted_before"),
        death_to_requeue_ticks=0 if requeue_events else None,
        death_to_redispatch_ticks={
            i: t - death["tick"] for i, t in state["redispatch"].items()}
        if death else None,
        shed=shed, retry_after_ticks=retry_after,
        resubmitted_at_tick=state.get("resub_tick"),
        resubmitted_to=state["resub_replica"],
        ttft_ticks=sorted(st["ttft_ticks"].values()),
        prefix_hits=[e.stats["prefix_hit_requests"] - h
                     for e, h in zip(engines, hits0)],
        events=len(tr.events()))
    pages_settled("faulted", engines)

    # -- autoscaled ---------------------------------------------------------
    made = []

    def factory(i):
        eng = PagedContinuousBatchingEngine(
            model, ledger_tag="a%d" % i,
            **dict(cfg, num_slots=AUTOSCALE_SLOTS))
        made.append(eng)
        return eng

    gw = Gateway(replica_pool(factory, n=1, transport="inprocess"),
                 hedge_fraction=None)
    asc = Autoscaler(gw, factory, min_replicas=1, max_replicas=3,
                     cooldown_ticks=AUTOSCALE_COOLDOWN)
    rids, decisions = {}, []
    sync()
    base.reset_counts()
    orig_tick = asc.tick

    def asc_tick():
        out = orig_tick()
        if out is not None:
            decisions.append((gw.tick_count, out,
                              len(gw.supervisor.replicas)))
        return out

    asc.tick = asc_tick

    def arrive():
        if len(rids) < len(reqs):
            i = len(rids)
            p, kw = reqs[i]
            rids[i] = gw.submit(p, n, **kw)

    arrive()
    ticks = gateway_loop(
        gw, lambda: len(rids) == len(reqs) and len(gw.supervisor.replicas)
        == 1 and all(gw.status(r) not in ("queued", "dispatched")
                     for r in rids.values()),
        limit, on_tick=arrive, autoscaler=asc)
    sync()
    counts = base.counts()
    held("autoscaled", gw, rids)
    a = asc.stats
    if a["scale_ups"] != 2 or a["retired_replicas"] != 2 or \
            len(gw.supervisor.replicas) != 1:
        problems.append("autoscaled: %d scale-ups, %d retired, %d replicas "
                        "left; wanted 2, 2, 1" % (
                            a["scale_ups"], a["retired_replicas"],
                            len(gw.supervisor.replicas)))
    live = {id(r.engine) for r in gw.supervisor.replicas}
    for eng in made:
        if id(eng) not in live and (eng.stats["blocks_in_use"]
                                    or eng.stats["pinned_blocks"]):
            problems.append("autoscaled: a retired replica holds pages %r"
                            % ((eng.stats["blocks_in_use"],
                                eng.stats["pinned_blocks"]),))
    served = [e.stats["generated_tokens"] for e in made]
    if len(made) != 3 or not all(served):
        problems.append("autoscaled: replicas made %d, tokens each %r"
                        % (len(made), served))
    rec["autoscaled"] = dict(
        tick_summary(ticks), **launches_exact("autoscaled", made, (0, 0),
                                              counts),
        decisions=decisions, tokens_by_replica=served,
        ttft_ticks=sorted(gw.stats["ttft_ticks"].values()),
        autoscaler=a)
    pages_settled("autoscaled", [r.engine for r in gw.supervisor.replicas])
    rec["engines"] = engines
    return rec, problems


def serve_replicas(model, streams):
    """Phase 6r(a): ``replicas_run`` on the resident 8B model with phase
    5's settings and traffic, held to phase 5's streams; then one traced
    gateway pump under ``torch.profiler``, which must hold a
    ``gateway.pump`` range.  Logs each run's record with the card's name
    and power limit and the peak memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mxtpu_torch.observability import tracing
    from mxtpu_torch.serving import Gateway

    torch.cuda.reset_peak_memory_stats()
    reqs = traffic(model.vocab_size)
    rec, problems = replicas_run(model, reqs, streams, SERVE, NEW_TOKENS)
    engines = rec.pop("engines")
    with tracing():
        gw = Gateway(engines[:1], hedge_fraction=None)
        gw.submit(reqs[1][0], 4)
        gw.pump()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            gw.pump()
            torch.cuda.synchronize()
        gw.run()
    ranges = sum(1 for e in prof.events() if e.name == "gateway.pump"
                 and e.device_type == DeviceType.CPU)
    for run, r in rec.items():
        log(phase="replicas", run=run, card=card_line(), **r)
    log(phase="replicas_summary", card=card_line(),
        profiled_pump_ranges=ranges,
        phase5_ms_per_decode_step=MAIN_PATH.get("ms_per_decode_step"),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    if ranges < 1:
        problems.append("no gateway.pump range in the profiled pump")
    if problems:
        raise AssertionError("phase 6r(a): " + "; ".join(problems))


def replica_engine(seed=0, device="cuda", ledger_tag="r0", dtype=None,
                   **model_kw):
    """Phase 6r(b)'s worker factory (``"chip_smoke:replica_engine"``, run
    in each ``SubprocessReplica`` worker): 6e(b)'s cut of llama_3_8b
    (``model_kw`` override its arguments; ``dtype`` a torch dtype's
    name) with Normal(0, 0.02) weights from a generator on ``device``
    seeded with ``seed`` — generation A of 6e(b) bit for bit — behind a
    paged engine on phase 5's settings."""
    from mxtpu_torch.models.transformer import llama_3_8b
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    kw = dict(depth_factor=HOTSWAP_DEPTH)
    kw.update(model_kw)
    if dtype is not None:
        kw["dtype"] = getattr(torch, dtype)
    model = llama_3_8b(device=device, **kw)
    init_weights(model, torch.Generator(device=device).manual_seed(seed),
                 0.02)
    return PagedContinuousBatchingEngine(model, ledger_tag=ledger_tag,
                                         device=device, **SERVE)


#: phase 6r(b): r1's RPC at this hit (its worker's RPCs counted from its
#: spawn) is turned into a SIGKILL by the ``transport.worker_death`` rule,
#: mid-decode; probation revives (and respawns) it this many ticks later
WORKER_KILL_HIT = 60
WORKER_REVIVE_TICKS = 2


def subprocess_run(reqs, want, n, factory_kw, in_process_ms=None,
                   first=HOTSWAP_SPLIT):
    """Phase 6r(b)'s run: two ``SubprocessReplica`` workers of
    ``replica_engine`` (``factory_kw`` its kwargs) behind a ``Gateway``
    serve ``reqs[:first]`` while a ``transport.worker_death`` rule
    SIGKILLs r1; probation respawns it and the other requests arrive
    then; both workers shut down at the end.  Every stream must equal
    ``want``, the kill's exit code be -9 with r1's streams (some with
    emitted tokens) requeued, the respawned r1 serve at least one
    request, and both shutdowns exit 0.  Returns the record and the
    problems found.  A tick's wall time includes any respawn that ran in
    it (``median_ms_per_tick`` leaves it out)."""
    from mxtpu_torch.resilience import fault_plan
    from mxtpu_torch.serving import Gateway, SubprocessReplica

    problems, rec = [], {}
    reps, spawn_s = [], []
    try:
        for i in range(2):
            t = time.perf_counter()
            reps.append(SubprocessReplica(
                "chip_smoke:replica_engine", replica_id="r%d" % i,
                kwargs=dict(factory_kw, ledger_tag="r%d" % i)))
            spawn_s.append(time.perf_counter() - t)
        rpc = {}
        real_rpc = SubprocessReplica._rpc

        def timed_rpc(self, method, params=None, budget=None):
            t = time.perf_counter()
            try:
                return real_rpc(self, method, params, budget)
            finally:
                rpc.setdefault(method, []).append(time.perf_counter() - t)

        gw = Gateway(reps, fail_threshold=1, hedge_fraction=None,
                     revive_after_ticks=WORKER_REVIVE_TICKS)
        rids = {i: gw.submit(p, n, **kw)
                for i, (p, kw) in enumerate(reqs[:first])}
        state = dict(prev={}, death=None, redispatch={}, respawn_s=None,
                     after_revive=set())
        respawn = reps[1].respawn

        def timed_respawn():
            t = time.perf_counter()
            respawn()
            state["respawn_s"] = time.perf_counter() - t

        reps[1].respawn = timed_respawn

        def watch():
            sup = gw.supervisor.stats
            if sup["deaths"] and state["death"] is None:
                requeued = [i for i, r in rids.items()
                            if gw._reqs[r].requeues]
                state["death"] = dict(
                    tick=gw.tick_count, requeued=requeued,
                    exit_code=reps[1].exit_code,
                    emitted_before={i: state["prev"].get(i, 0)
                                    for i in requeued})
            elif state["death"] is None:
                state["prev"] = {
                    i: len(gw.streamed(r)) for i, r in rids.items()
                    if "r1" in gw._reqs[r].gens.values()}
            if state["death"] is not None:
                for i in state["death"]["requeued"]:
                    if i not in state["redispatch"] and \
                            gw._reqs[rids[i]].gens:
                        state["redispatch"][i] = gw.tick_count
            if sup["revivals"]:
                for i in range(len(rids), len(reqs)):
                    rids[i] = gw.submit(reqs[i][0], n, **reqs[i][1])
                state["after_revive"] |= {
                    i for i, r in rids.items()
                    if "r1" in gw._reqs[r].gens.values()}

        ticks = []
        SubprocessReplica._rpc = timed_rpc
        try:
            with fault_plan("transport.worker_death#r1@%d:raise="
                            "OSError(planned kill)" % WORKER_KILL_HIT):
                for _ in range(40 * (n + 16)):
                    if len(rids) == len(reqs) and all(
                            gw.status(r) not in ("queued", "dispatched")
                            for r in rids.values()):
                        break
                    t = time.perf_counter()
                    gw.pump()
                    ticks.append(time.perf_counter() - t)
                    watch()
        finally:
            SubprocessReplica._rpc = real_rpc
        for i, r in rids.items():
            out = gw.result(r).numpy() if gw.status(r) == "ok" else None
            if out is None or not np.array_equal(out, want[i]):
                problems.append("request %d (%s) parts from generation A's "
                                "in-process stream" % (i, gw.status(r)))
        death = state["death"] or {}
        if death.get("exit_code") != -9 or not death.get("requeued"):
            problems.append("the kill: exit code %r, requeued %r"
                            % (death.get("exit_code"),
                               death.get("requeued")))
        if not any(death.get("emitted_before", {}).values()):
            problems.append("r1 was killed holding no stream with emitted "
                            "tokens")
        sup = gw.supervisor.stats
        if (sup["deaths"], sup["revivals"]) != (1, 1) or \
                not state["after_revive"]:
            problems.append("deaths %d, revivals %d, requests served by the "
                            "respawned r1 %r" % (sup["deaths"],
                                                 sup["revivals"],
                                                 sorted(state[
                                                     "after_revive"])))
        codes = []
        for rep in reps:
            rep.shutdown()
            codes.append(rep.exit_code)
        if codes != [0, 0]:
            problems.append("shutdown exit codes %r" % codes)

        def median_ms(method):
            v = sorted(rpc.get(method, []))
            return v[len(v) // 2] * 1e3 if v else None

        rec = dict(
            spawn_s=spawn_s, respawn_s=state["respawn_s"],
            step_rpc_ms=median_ms("step"), poll_rpc_ms=median_ms("poll"),
            rpcs={m: len(v) for m, v in rpc.items()},
            ticks=len(ticks), wall_ms_per_tick=sum(ticks) * 1e3 / len(ticks),
            median_ms_per_tick=sorted(ticks)[len(ticks) // 2] * 1e3,
            in_process_ms_per_step=in_process_ms,
            kill_tick=death.get("tick"), requeued=death.get("requeued"),
            emitted_before_kill=death.get("emitted_before"),
            kill_to_requeue_ticks=0 if death.get("requeued") else None,
            kill_to_redispatch_ticks={
                i: t - death["tick"] for i, t in state["redispatch"].items()}
            if death else None,
            served_after_respawn=sorted(state["after_revive"]),
            exit_codes=dict(kill=death.get("exit_code"), shutdown=codes),
            supervisor=dict(deaths=sup["deaths"], revivals=sup["revivals"],
                            transport_failures=sup["transport_failures"]))
    finally:
        for rep in reps:
            rep.close()
    return rec, problems


def serve_subprocess_replicas(model, want_a):
    """Phase 6r(b): ``subprocess_run`` on 6e(b)'s cut (``model``,
    generation A) with phase 5's traffic: the first 8 streams are
    6e(b)'s ``want_a``, the other 4 served here on an in-process engine
    over ``model`` (its ms a step timed on the host, the device
    synchronized).  Logs the record with the card's name and power
    limit."""
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    reqs = traffic(model.vocab_size)
    eng = PagedContinuousBatchingEngine(model, **SERVE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rest = serve_streams(eng, reqs[HOTSWAP_SPLIT:], NEW_TOKENS)
    torch.cuda.synchronize()
    in_process_ms = (time.perf_counter() - t) * 1e3 / eng.stats["steps"]
    rec, problems = subprocess_run(reqs, list(want_a) + rest, NEW_TOKENS,
                                   {"seed": 0}, in_process_ms)
    log(phase="subprocess_replicas", card=card_line(), **rec)
    if problems:
        raise AssertionError("phase 6r(b): " + "; ".join(problems))


# -- phase 6p: tensor parallelism ---------------------------------------------

#: phase 6p: the tp axis, and how long a rank waits on a collective (or
#: the parent on a rank) before it fails
TP = 2
TP_TIMEOUT_S = 600.0


class SyncedCalls:
    """Host wall time of every call of some model methods, the card
    synchronized before and after each: phase 6p times tp=1 and each
    tp=2 rank's steps and chunks so, on one clock."""

    def __init__(self, model, attrs):
        self.model, self.attrs = model, attrs
        self.seconds = dict.fromkeys(attrs, 0.0)

    def _wrap(self, attr):
        inner = getattr(self.model, attr)

        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[attr] += time.perf_counter() - t
            return out
        return call

    def __enter__(self):
        for a in self.attrs:
            setattr(self.model, a, self._wrap(a))
        return self

    def __exit__(self, *exc):
        for a in self.attrs:
            delattr(self.model, a)


def tp_cut_model(seed=0):
    """6e(b)'s cut (full width, ``CUT_DEPTH`` of the layers, bf16) with
    Normal(0, 0.02) weights from a CUDA generator seeded with ``seed``:
    ``llama_3_8b_model(CUT_DEPTH)`` bit for bit, built without its log
    line (every rank of phase 6p builds one)."""
    from mxtpu_torch.models.transformer import llama_3_8b

    model = llama_3_8b(depth_factor=CUT_DEPTH, device="cuda")
    init_weights(model, torch.Generator(device="cuda").manual_seed(seed),
                 0.02)
    return model


def tp_rank(rank, store, out, reqs, motif):
    """One rank of phase 6p's world (spawned): gloo over a file
    rendezvous, two ranks on ``cuda:0``.  Each builds the cut from seed 0
    and keeps its shard; rank 0 runs ``tp_controller`` and saves its
    record to ``out``, the other rank follows it.  Each rank's steps and
    chunks are timed as tp=1's (``SyncedCalls``)."""
    import torch.distributed as dist

    from mxtpu_torch.parallel.decode import ShardedDecoder
    from mxtpu_torch.parallel.mesh import init_process_group, make_mesh

    if not torch.cuda.is_available():
        raise RuntimeError("phase 6p: rank %d finds no GPU" % rank)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    init_process_group("file://" + store, TP, rank, timeout=TP_TIMEOUT_S)
    mesh = make_mesh(tp=TP)
    model = tp_cut_model()
    with SyncedCalls(model, ("step_pages", "prefill_pages")):
        if rank:
            ShardedDecoder.follow(mesh, model)
        else:
            torch.save(tp_controller(mesh, model, reqs, motif), out)
    dist.destroy_process_group()


def tp_layer0(kind, L):
    """A ``Capture`` test for layer 0's first K1 call of ``kind`` (``1``
    a decode step after 20 model calls, ``"window"`` a linear verify
    window, ``"tree"``; every model call makes one a layer)."""
    def want(n, a, kw):
        if n % L or (kind == 1 and n < 20 * L):
            return False
        W, tree = int(a[0].shape[2]), kw.get("anc") is not None
        return {1: W == 1, "window": W > 1 and not tree,
                "tree": tree}[kind]
    return want


def tp_collective_pass(mesh, model, rules, reqs, streams):
    """Phase 6p's second bf16 pass, apart from the timed one: the same
    traffic through a fresh engine with every collective timed on both
    ranks (the card synchronized before and after each).  Its streams
    must equal the timed pass's ``streams``.  Returns each rank's ms a
    step and a chunk (this instrumented pass's) and the ms of them in
    collectives."""
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    eng = PagedContinuousBatchingEngine(model, mesh=mesh, rules=rules,
                                        **SERVE)
    dec = eng._dec
    eng.submit(np.arange(64)[None], 2)              # warm-up, not counted
    eng.run()
    before = eng.stats
    dec.rank_report(reset=True, timing=True)
    got = serve_streams(eng, reqs, NEW_TOKENS)
    report = dec.rank_report(reset=True, timing=False)
    after = eng.stats
    if any(not np.array_equal(a, b) for a, b in zip(got, streams)):
        raise AssertionError("phase 6p: the collective-timed pass's streams "
                             "differ from the timed pass's")
    steps = after["steps"] - before["steps"]
    chunks = after["prefill_chunks"] - before["prefill_chunks"]
    return [dict(
        rank=r["rank"],
        ms_per_step=r["calls"]["step_pages"][1] * 1e3 / steps,
        collective_ms_per_step=r["calls"]["step_pages"][2] * 1e3 / steps,
        ms_per_chunk=r["calls"]["prefill_pages"][1] * 1e3 / chunks,
        collective_ms_per_chunk=r["calls"]["prefill_pages"][2] * 1e3
        / chunks,
        collective_calls=r["collectives"]["calls"]) for r in report]


def tp_controller(mesh, model, reqs, motif):
    """Rank 0 of phase 6p: phase 5's traffic over bf16 and int8 pools,
    then the motif requests plainly and with 6b's speculation (bf16 and
    int8), every engine over the tp=2 mesh; each rank's launches held
    exact, its pools' heads KV/2; layer 0's K1 (W = 1, window, tree) and
    K2 inputs captured here at the per-shard geometry and held against
    their plain versions (bf16's W = 1 and K2 timed as kernels-line
    rows).  Returns the record."""
    from mxtpu_torch.models.transformer import transformer_lm_sharding_rules
    from mxtpu_torch.ops import paged_attention as pa
    from mxtpu_torch.ops import prefill_attention as pf
    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    rules = transformer_lm_sharding_rules()
    L = len(model.layers)
    # each rank's share of the heads (the model is whole until the first
    # engine shards it)
    kv, heads = (model.layers[0].attn.kv_heads // TP,
                 model.layers[0].attn.heads // TP)
    rec = {"runs": {}, "motif": {}, "caps": {}, "checks": {}}
    for cache_dtype in (None, "int8"):
        k1, k2 = k_names(cache_dtype)
        eng = PagedContinuousBatchingEngine(
            model, mesh=mesh, rules=rules, cache_dtype=cache_dtype, **SERVE)
        dec = eng._dec
        eng.submit(np.arange(64)[None], 2)          # warm-up, not counted
        eng.run()
        before = eng.stats
        b0 = dec.broadcast_stats()
        dec.rank_report(reset=True)
        d_cap = Capture(pa, "paged_decode_attention", tp_layer0(1, L))
        p_cap = Capture(pf, "paged_prefill_attention",
                        lambda n, a, kw: n % L == 0 and a[4] >= 256)
        with d_cap, p_cap:
            torch.cuda.synchronize()
            t = time.perf_counter()
            streams = serve_streams(eng, reqs, NEW_TOKENS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        report = dec.rank_report()
        b1 = dec.broadcast_stats()
        after = eng.stats
        steps = after["steps"] - before["steps"]
        chunks = after["prefill_chunks"] - before["prefill_chunks"]
        want = {k1: L * steps, k2: L * chunks}
        want.update(projection_launches(model, steps, chunks))
        for r in report:
            if r["counts"] != want or not steps or not chunks:
                raise AssertionError(
                    "phase 6p: rank %d launched %r, wanted exactly %r"
                    % (r["rank"], r["counts"], want))
            if (r["kv_heads"], r["heads"]) != (kv, heads):
                raise AssertionError("phase 6p: rank %d holds %d query and "
                                     "%d KV heads, wanted %d and %d"
                                     % (r["rank"], r["heads"], r["kv_heads"],
                                        heads, kv))
        leaf = eng._pools[0][0]
        pool_heads = (leaf[0] if isinstance(leaf, tuple) else leaf).shape[1]
        if pool_heads != kv or after["blocks_in_use"]:
            raise AssertionError("phase 6p: rank 0's pools hold %d KV heads "
                                 "(wanted %d), %d pages in use"
                                 % (pool_heads, kv, after["blocks_in_use"]))
        decode_tokens = after["generated_tokens"] - before["generated_tokens"]
        calls = b1["calls"] - b0["calls"]
        rec["runs"][str(cache_dtype)] = dict(
            streams=streams, steps=steps, chunks=chunks, wall_s=wall,
            decode_tokens=decode_tokens, launches=report[0]["counts"],
            broadcast_calls=calls,
            broadcast_ms_per_call=(b1["seconds"] - b0["seconds"]) * 1e3
            / calls,
            broadcast_bytes_per_call=(b1["bytes"] - b0["bytes"]) / calls,
            ranks=[dict(
                rank=r["rank"],
                ms_per_step=r["calls"]["step_pages"][1] * 1e3 / steps,
                ms_per_chunk=r["calls"]["prefill_pages"][1] * 1e3 / chunks,
                peak_memory_gib=r["peak_bytes"] / 2**30) for r in report])
        for cap, name in ((d_cap, k1), (p_cap, k2)):
            if cap.args is None:
                raise AssertionError("phase 6p: no %s input captured" % name)
            rec["caps"][name] = (cap.args, cap.kwargs)
        del eng, dec, d_cap, p_cap
        gc.collect()
        if cache_dtype is None:
            rec["collectives"] = tp_collective_pass(mesh, model, rules, reqs,
                                                    streams)
    for cache_dtype in (None, "int8"):
        k1 = k_names(cache_dtype)[0]
        plain = serve_streams(PagedContinuousBatchingEngine(
            model, mesh=mesh, rules=rules, cache_dtype=cache_dtype, **SERVE),
            motif, NEW_TOKENS)
        eng = PagedContinuousBatchingEngine(
            model, mesh=mesh, rules=rules, cache_dtype=cache_dtype,
            **SPEC_SERVE)
        w_cap = Capture(pa, "paged_decode_attention", tp_layer0("window", L))
        t_cap = Capture(pa, "paged_decode_attention", tp_layer0("tree", L))
        with w_cap, t_cap:
            spec = serve_streams(eng, motif, NEW_TOKENS)
        st = eng.stats
        differ = [j for j, (a, b) in enumerate(zip(plain, spec))
                  if not np.array_equal(a, b)]
        if differ:
            raise AssertionError("phase 6p: speculative tp=2 streams %r "
                                 "differ from the plain tp=2 streams (%s)"
                                 % (differ, cache_dtype))
        rec["motif"][str(cache_dtype)] = dict(
            streams=plain, accepted_tokens=st["accepted_tokens"],
            drafted_tokens=st["drafted_tokens"],
            verify_calls=st["verify_calls"])
        for cap, kind in ((w_cap, "W=%d"), (t_cap, "tree,W=%d")):
            if cap.args is None:
                raise AssertionError("phase 6p: no K1 %s input captured (%s)"
                                     % (kind % 0, cache_dtype))
            W = int(cap.args[0].shape[2])
            tag = "int8," if cache_dtype else ""
            rec["caps"]["paged_attention[%s%s]" % (tag, kind % W)] = (
                cap.args, cap.kwargs)
        del eng, w_cap, t_cap
        gc.collect()
    flush = _L2Flush()
    rows = {"paged_attention": "paged_attention[tp=2]",
            "paged_prefill": "paged_prefill[tp=2]"}
    rec["rows"] = {}
    for name, (args, kw) in rec.pop("caps").items():
        res = measure(name, args, flush, timed=name in rows, kw=kw)
        rec["checks"][name] = dict(shape=list(args[0].shape),
                                   pool_heads=int(args[1].shape[1]),
                                   max_abs_err=res["max_abs_err"])
        if name in rows:
            rec["rows"][rows[name]] = res
    from mxtpu_torch.parallel.decode import ShardedDecoder
    ShardedDecoder.shutdown(mesh)
    return rec


def tp_partings(model, reqs, tp1, tp2, cache_dtype):
    """The tp=2 streams against the tp=1 engine's: where a greedy stream
    parts, the gap between the two tokens in tp=1's own logits (those of
    ``generate`` over the tp=1 stream's prefix), in bf16 ulps of its top
    logit.  Sampled streams are read only.  Returns the partings."""
    parted = []
    for j, ((p, kw), a, b) in enumerate(zip(reqs, tp1, tp2)):
        diff = np.nonzero(a[0] != b[0])[0]
        if not diff.size:
            continue
        at = int(diff[0])
        entry = dict(request=j, sampled="temperature" in kw,
                     token=at - p.shape[1])
        if not entry["sampled"]:
            lg = generate_logits(model, a[:, :at], p.shape[1], cache_dtype)
            top = float(lg.max())
            ulp = 2.0 ** (np.floor(np.log2(abs(top))) - 7)
            gap = float(lg[a[0, at]]) - float(lg[b[0, at]])
            entry.update(gap=gap, gap_ulps=gap / ulp)
        parted.append(entry)
    return parted


def serve_tensor_parallel(model):
    """Phase 6p: tensor parallelism (``mesh=make_mesh(tp=2)``,
    ``rules=transformer_lm_sharding_rules()``) over two gloo ranks on the
    one card, spawned (``tp_rank``), on ``model``, 6e(b)'s cut; the same
    traffic through in-process tp=1 engines on ``model`` first.  Every
    greedy tp=2 stream must equal tp=1's or part within
    ``PARTING_ULPS`` of tp=1's top logit, every speculative tp=2 stream
    its plain tp=2 stream; each rank's launches exact (checked on rank
    0).  Logs each rank's ms a step and decode tokens/s against tp=1,
    both timed by ``SyncedCalls``; the ms a step in collectives from a
    second pass (``tp_collective_pass``); the controller's broadcast ms
    a call, each rank's peak memory, with the card's name and power
    limit.  Returns
    the kernels-line rows (K1 at W = 1 and K2 at the per-shard
    geometry) and their launches (rank 0's, the bf16 run's)."""
    import tempfile

    import torch.multiprocessing as mp

    from mxtpu_torch.parallel.serving import PagedContinuousBatchingEngine

    t0 = time.perf_counter()
    reqs = traffic(model.vocab_size)
    motif_all, confirmed = motif_traffic(model)
    motif = [motif_all[i] for i in MOTIF_CUT]
    tp1 = {}
    for cache_dtype in (None, "int8"):
        eng = PagedContinuousBatchingEngine(model, cache_dtype=cache_dtype,
                                            **SERVE)
        eng.submit(np.arange(64)[None], 2)
        eng.run()
        before = eng.stats
        with SyncedCalls(model, ("step_pages",)) as t_dec:
            streams = serve_streams(eng, reqs, NEW_TOKENS)
        after = eng.stats
        steps = after["steps"] - before["steps"]
        dec_s = t_dec.seconds["step_pages"]
        tp1[str(cache_dtype)] = dict(
            streams=streams, ms_per_step=dec_s * 1e3 / steps,
            decode_tokens_per_s=(after["generated_tokens"]
                                 - before["generated_tokens"]) / dec_s)
        del eng
    tp1_motif = serve_streams(PagedContinuousBatchingEngine(model, **SERVE),
                              motif, NEW_TOKENS)
    t_spawn = time.perf_counter()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        procs = [ctx.Process(target=tp_rank,
                             args=(r, os.path.join(tmp, "store"), out, reqs,
                                   motif))
                 for r in range(TP)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + TP_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * TP:
            raise AssertionError("phase 6p: the ranks exited %r" % codes)
        rec = torch.load(out, weights_only=False)
    world_s = time.perf_counter() - t_spawn
    problems, partings = [], {}
    for cache_dtype in ("None", "int8"):
        got = rec["runs"][cache_dtype]
        parted = tp_partings(model, reqs, tp1[cache_dtype]["streams"],
                             got.pop("streams"),
                             None if cache_dtype == "None" else "int8")
        partings[cache_dtype] = parted
        problems += ["%s request %d parts %.1f ulps from tp=1"
                     % (cache_dtype, e["request"], e["gap_ulps"])
                     for e in parted if e.get("gap_ulps", 0) > PARTING_ULPS]
        dec_s = sum(r["ms_per_step"] for r in got["ranks"][:1]) \
            * got["steps"] / 1e3
        got["decode_tokens_per_s"] = got["decode_tokens"] / dec_s
        got["tp1_decode_tokens_per_s"] = tp1[cache_dtype][
            "decode_tokens_per_s"]
        got["tp1_ms_per_step"] = tp1[cache_dtype]["ms_per_step"]
    motif_parted = tp_partings(model, motif, tp1_motif,
                               rec["motif"]["None"]["streams"], None)
    for m in rec["motif"].values():
        m.pop("streams")
    problems += ["motif request %d parts %.1f ulps from tp=1"
                 % (e["request"], e["gap_ulps"])
                 for e in motif_parted if e.get("gap_ulps", 0) > PARTING_ULPS]
    log(phase="tensor_parallel", card=card_line(), tp=TP, backend="gloo",
        ranks_on="cuda:0", clock="host, card synchronized a step",
        runs=rec["runs"], collectives_pass=rec["collectives"],
        motif=rec["motif"],
        motif_confirmed=confirmed, kernel_checks=rec["checks"],
        partings=partings, motif_partings=motif_parted,
        bound_ulps=PARTING_ULPS, world_s=world_s,
        seconds=time.perf_counter() - t0)
    if problems:
        raise AssertionError("phase 6p: " + "; ".join(problems))
    launches = rec["runs"]["None"]["launches"]
    return rec["rows"], {
        "paged_attention[tp=2]": launches["paged_attention"],
        "paged_prefill[tp=2]": launches["paged_prefill"]}


def lane_invariant(args, kw):
    """K1 invariant (b) on a captured main-path window (``kw``: an int8
    pool's scales): lane w equals a W = 1 call at pos + w, bit for
    bit."""
    from mxtpu_torch.ops import paged_attention as pa

    q, pk, pv, tables, pos = args
    lin = pa.paged_decode_attention(q, pk, pv, tables, pos, **kw)
    for w in range(q.shape[2]):
        one = pa.paged_decode_attention(q[:, :, w:w + 1].contiguous(), pk,
                                        pv, tables, pos + w, **kw)
        if not torch.equal(one, lin[:, :, w:w + 1]):
            raise AssertionError("K1 invariant (b) fails on the main "
                                 "path's window at lane %d" % w)


def window_op_bits(model, widths=(8, 16)):
    """Which ops of the decode step give a verify window's lane other
    bits than the step gives the same row: each op of layer 0 and the
    head once on (8, W, n) and once on the (8, 1, n) rows of lanes 0,
    W // 2 and W - 1, as the step and the verify call run it (out_proj
    and down through rows_linear; each norm with the projections that
    read it through rows_norm_linear, in bf16 and, for attn_norm + qkv
    and the final norm + lm_head, in float32; rope at the lanes'
    positions, linear and tree; the SwiGLU product; the residual adds).
    Returns the ops whose bits differ (an empty list is C1's gate) and
    those that agree."""
    from torch.nn import functional as F

    from mxtpu_torch.contrib.quantization import QuantizedLinear
    from mxtpu_torch.ops.contrib import rope
    from mxtpu_torch.ops.linear import rows_linear, rows_norm_linear

    layer, attn = model.layers[0], model.layers[0].attn
    dev, dt = model.device, model.dtype
    C, H, D = layer.attn_norm.weight.shape[0], attn.heads, attn.head_dim
    hidden = layer.gate_proj.weight.shape[0]
    g = torch.Generator(device=dev).manual_seed(3)

    def proj(mod):
        if isinstance(mod, QuantizedLinear):
            return mod                          # G3 or G4
        return lambda x: rows_linear(x, mod.weight)

    def normed(norm, mod, dtype=None):
        # in float32 too: a reduction whose order moves with the row
        # count shows in float32 bits, while bf16 rounding hides most of it
        if isinstance(mod, QuantizedLinear):
            gamma = norm.weight if dtype is None else norm.weight.to(dtype)
            return lambda x: mod.normed(x if dtype is None else x.to(dtype),
                                        gamma)
        if dtype is None:
            return lambda x: rows_norm_linear(x, norm.weight, mod.weight)
        gamma, w = norm.weight.to(dtype), mod.weight.to(dtype)
        return lambda x: rows_norm_linear(x.to(dtype), gamma, w)

    def heads(fn):
        # (8, T, H*D) rows <-> (8, H, T, D) heads, as _project does
        return lambda x, pos: fn(x.reshape(8, -1, H, D).transpose(1, 2),
                                 pos).transpose(1, 2).reshape(x.shape)

    ops = [("attn_norm+qkv", C, normed(layer.attn_norm, attn.qkv)),
           ("attn_norm+qkv[float32]", C,
            normed(layer.attn_norm, attn.qkv, torch.float32)),
           ("rope", H * D, heads(lambda q, pos: rope(q, offset=pos))),
           ("rope_tree", H * D, heads(lambda q, pos: rope(
               q, offset=pos[:, None] + torch.arange(
                   q.shape[2], device=dev, dtype=pos.dtype)[None, :]))),
           ("out_proj", C, proj(attn.out_proj)),
           ("residual_add", 2 * C, lambda x: x[..., :C] + x[..., C:]),
           ("ffn_norm+gate_proj", C, normed(layer.ffn_norm,
                                            layer.gate_proj)),
           ("ffn_norm+up_proj", C, normed(layer.ffn_norm, layer.up_proj)),
           ("swiglu", 2 * hidden,
            lambda x: F.silu(x[..., :hidden]) * x[..., hidden:]),
           ("down_proj", hidden, proj(layer.down_proj)),
           ("norm+lm_head", C, normed(model.norm, model.lm_head)),
           ("norm+lm_head[float32]", C,
            normed(model.norm, model.lm_head, torch.float32))]
    differ, same = set(), set()
    pos = torch.arange(8, device=dev, dtype=torch.int32) * 37 + 200
    with torch.no_grad():
        for W in widths:
            for name, n, op in ops:
                xw = torch.randn(8, W, n, generator=g, device=dev, dtype=dt)
                rope_op = name.startswith("rope")
                full = op(xw, pos) if rope_op else op(xw)
                ok = True
                for j in sorted({0, W // 2, W - 1}):
                    row = xw[:, j:j + 1].contiguous()
                    one = op(row, pos + j) if rope_op else op(row)
                    ok = ok and torch.equal(full[:, j:j + 1], one)
                (same if ok else differ).add(name)
    return dict(widths=list(widths), bits_differ=sorted(differ),
                bit_identical=sorted(same - differ))


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


def same_bits(kind, args):
    """Kernel ``kind`` called twice on ``args``: raise unless both calls
    give the same bits (no atomics, a fixed order of sums)."""
    from mxtpu_torch.ops import flash_attention as fa

    a, b = getattr(fa, kind)(*args), getattr(fa, kind)(*args)
    if kind == "flash_dq":
        a, b = (a,), (b,)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("%s gave other bits on a second call (%s, %s)"
                             % (kind, args[0].dtype, tuple(args[0].shape)))


def flash_case(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=dtype)
            for _ in range(4)]


def flash_kernels_against_plain():
    """Each flash kernel against its plain version at ``FLASH_SHAPES``,
    float32 and bfloat16, causal and not; K4 and K5 where one block
    holds their tiles (not at head_dim 256 in float32)."""
    from mxtpu_torch.ops import flash_attention as fa

    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_case(shape, dtype, seed=shape[2])
            for causal in (True, False):
                errs = {kind: flash_err(kind, args) for kind, args in
                        flash_args(q, k, v, do, causal).items()
                        if fa.fits(kind[len("flash_"):], shape[3], dtype)}
                log(phase="flash_vs_plain", shape=list(shape),
                    dtype=str(dtype).split(".")[1], causal=causal,
                    max_abs_err={k: e[0] for k, e in errs.items()},
                    err_over_tol={k: e[1] for k, e in errs.items()})
    shape = FLASH_SHAPES[-1]
    q, k, v, do = flash_case(shape, torch.float32, seed=shape[2] + 1)
    args = flash_args(q, k, v, do.abs(), True)
    errs = {kind: flash_err(kind, args[kind])
            for kind in ("flash_dq", "flash_dkv")}
    log(phase="flash_vs_plain", shape=list(shape), dtype="float32",
        causal=True, one_signed_do=True,
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
    caps = [Capture(fa, "flash_fwd", lambda n, a, kw: n == 0),
            Capture(fa, "flash_dq", lambda n, a, kw: n == n_layers - 1),
            Capture(fa, "flash_dkv", lambda n, a, kw: n == n_layers - 1)]
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
    backward (dq, dk and dv together) for K4 and K5, beside which K4's
    and K5's rows carry ``bwd_ms``, the port's whole backward (delta, K4
    and K5) through ``torch.autograd.grad`` and timed the same way; K4
    and K5 must give the same bits on a second call."""
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
        same_bits(kind, args)
        lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
        for name, fn in (
                ("library_ms", lambda a, b, c: F.scaled_dot_product_attention(
                    a, b, c, is_causal=causal, scale=scale)),
                ("bwd_ms", lambda a, b, c: fa.flash_attention(
                    a, b, c, causal=causal, scale=scale))):
            out = fn(lq, lk, lv)
            res[name] = event_ms(lambda: torch.autograd.grad(
                out, (lq, lk, lv), args[3], retain_graph=True), flush)
            del out
    work = flash_work(kind, q, causal)
    res["bound_ms"], res["bound_by"] = bound(work[0], work[1], q.dtype)
    if q.dtype == torch.float32:
        # the route: every product in 3xTF32 on the tensor cores
        res["bound_tc_ms"] = max(work[0] / H100_BYTES_PER_S,
                                 3 * work[1] / H100_TF32_OPS) * 1e3
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
    N, Ci, Co, H, W = CONV_ONE_SIGNED
    g = torch.Generator(device="cuda").manual_seed(7)
    dev = dict(device="cuda", generator=g)
    args = (torch.randn(N, Ci, H, W, **dev).abs() + 1,
            torch.randn(Co, Ci, 3, 3, **dev),
            torch.randn(N, Co, H, W, **dev).abs())
    err, ratio = conv_err(args)
    log(phase="conv_vs_plain", shape=[N, Ci, Co, H, W], dtype="float32",
        inputs="one-signed", max_abs_err=err, err_over_tol=ratio)


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
    captured from the first counted step, and K6's calls are counted by
    stage shape.  Returns the launches, by kernel and by K6 row name,
    the captured inputs by row name, and the trained net (phase 16
    quantizes it)."""
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
                    lambda n, a, kw, s=s: tuple(a[0].shape) == s)
            for s in shapes]
    by_shape = Counted(cb, "conv3x3_s1_backward",
                       lambda a, kw: tuple(a[0].shape))
    events = []
    with caps[0], caps[1], caps[2], by_shape:
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
    names = [conv_row(s[1], s[2]) for s in shapes]
    for name, s in zip(names, shapes):
        launches[name] = by_shape.counts.get(s, 0)
    if sum(launches[n] for n in names) != want["conv_bwd"]:
        raise AssertionError("K6's launches by stage shape %r do not add up "
                             "to %d" % (by_shape.counts, want["conv_bwd"]))
    return launches, dict(zip(names, (c.args for c in caps))), net


def conv_row(Ci, H):
    """A K6 row's name in the kernels line: its stage shape."""
    return "conv_bwd[%dx%dx%d]" % (Ci, H, H)


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
    work = conv_work(x, w)
    res["bound_ms"], res["bound_by"] = bound(work[0], work[1], x.dtype)
    if x.dtype == torch.float32:
        # K6's route: both products in 3xTF32 on the tensor cores
        res["bound_tc_ms"] = max(work[0] / H100_BYTES_PER_S,
                                 3 * work[1] / H100_TF32_OPS) * 1e3
    return res


# -- phases 16 and 17: int8 inference of the trained ResNet-50 ---------------

class FirstByKey:
    """Wraps a kernel wrapper during a run: counts its calls by
    ``key(args, kwargs)`` and clones the inputs of the first call of
    each key; every call goes through unchanged."""

    def __init__(self, module, attr, key):
        self.module, self.attr, self.key = module, attr, key
        self.inner = None
        self.counts = {}
        self.args = {}

    def __call__(self, *args, **kw):
        k = self.key(args, kw)
        self.counts[k] = self.counts.get(k, 0) + 1
        if k not in self.args:
            self.args[k] = (
                [a.clone() if torch.is_tensor(a) else a for a in args],
                {n: a.clone() if torch.is_tensor(a) else a
                 for n, a in kw.items()})
        return self.inner(*args, **kw)

    def __enter__(self):
        self.inner = getattr(self.module, self.attr)
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)


class PlainQuant:
    """Puts Q1's, Q2's and Q3's plain versions in their wrappers' place:
    the plain route of a quantized net (no other op changes)."""

    def __enter__(self):
        from mxtpu_torch.ops import quantized as Q

        self.Q, self.saved = Q, (Q.qconv, Q.qfc, Q.quantize_nhwc)

        def qconv(x, w, scale, bias=None, stride=(1, 1), pad=(0, 0),
                  dilate=(1, 1), groups=1, packed=None):
            return Q.qconv_plain(x, w, scale, bias, stride, pad, dilate,
                                 groups)
        Q.qconv, Q.qfc, Q.quantize_nhwc = (qconv, Q.qfc_plain,
                                           Q.quantize_nhwc_plain)
        return self

    def __exit__(self, *exc):
        self.Q.qconv, self.Q.qfc, self.Q.quantize_nhwc = self.saved


def qconv_key(args, kw):
    """A Q1 call's geometry: (C_in, C_out, kernel, stride, input size)."""
    x, w, stride = args[0], args[1], args[4]
    return (int(x.shape[1]), int(w.shape[0]), int(w.shape[2]),
            int(stride[0]), int(x.shape[2]))


def qconv_row(key):
    """A Q1 row's name in the kernels line: its geometry."""
    ci, co, k, st, h = key
    return "qconv[%d->%d,%dx%ds%d,%d]" % (ci, co, k, k, st, h)


def qfc_row(key):
    m, k, n = key
    return "qfc[%dx%d->%d]" % (m, k, n)


def quantize_key(args, kw):
    """A Q3 call's input shape (N, C, H, W)."""
    return tuple(int(v) for v in args[0].shape)


def quantize_row(key):
    """A Q3 row's name in the kernels line: C x H x W of its input."""
    return "quantize_nhwc[%dx%dx%d]" % key[1:]


def quantize_resnet50(held):
    """Phase 16: ``quantize_net`` of phase 14's trained ``resnet50_v1``
    (its weights and running statistics), taken from the one-slot list
    ``held`` so that the float net is freed before the int8 run's peak
    memory is read, with ``calib_mode="naive"`` over
    2 batches of 32 synthetic 224x224 images (seed 1), then int8
    inference at batch 128 (seed 2): 1 warm-up and 5 counted forwards,
    and one profiled.  Gates: exactly 53 Q1 launches a forward, 52 on the
    channels-last route and 1 on the stem's, 52 Q3 and 1 Q2 (launch
    counts zeroed just
    before, read just after), finite logits, and the kernel route's
    logits ``torch.equal`` to the plain route's (``PlainQuant``) on the
    same batch.  Logs the int8 logits' error
    against the float32 net's and their top-1 agreement, ms a forward
    (and the float32 net's, eval mode, TF32 off), images/s and peak
    memory (after the warm-up forward, before any input is captured).
    Returns the launches by kernel and by row and the first captured
    inputs of each row."""
    from mxtpu_torch import base
    from mxtpu_torch.contrib.quantization import QuantizedConv2D, quantize_net
    from mxtpu_torch.ops import quantized as Q

    cfg = QUANT
    n_calib = cfg["calib_batch"] * cfg["calib_batches"]
    cx, _ = synthetic_images(n_calib, RESNET["size"], RESNET["classes"],
                             seed=cfg["calib_seed"])
    calib = [cx[i:i + cfg["calib_batch"]]
             for i in range(0, n_calib, cfg["calib_batch"])]
    xs, _ = synthetic_images(cfg["batch"], RESNET["size"], RESNET["classes"],
                             seed=cfg["seed"])
    x = torch.from_numpy(xs).cuda()
    net = held.pop()
    net.eval()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qnet = quantize_net(net, calib_mode="naive", calib_data=calib)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    convs = sum(isinstance(m, QuantizedConv2D) for m in qnet.modules())
    if convs != cfg["qconv"]:
        raise AssertionError("quantize_net made %d quantized convs, wanted "
                             "%d" % (convs, cfg["qconv"]))

    def forward():
        with torch.no_grad():
            return qnet(x)

    def timed(fn, n):
        out = []
        for _ in range(n):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            out.append((s, e))
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in out]

    with torch.no_grad():
        ref = net(x)
        float_ms = timed(lambda: net(x), 3)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(cfg["warmup"]):
        forward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    by_geom = FirstByKey(Q, "qconv", qconv_key)
    fc = FirstByKey(Q, "qfc", lambda a, kw: (int(a[0].shape[0]),
                                             int(a[0].shape[1]),
                                             int(a[1].shape[0])))
    by_shape = FirstByKey(Q, "quantize_nhwc", quantize_key)
    outs = []
    with by_geom, fc, by_shape:
        base.reset_counts()
        t_run = time.perf_counter()
        ms = timed(lambda: outs.append(forward()), cfg["forwards"])
        wall = time.perf_counter() - t_run
        launches = base.counts()
    logits = outs[-1]
    del outs[:-1]
    want = {k: cfg[k] * cfg["forwards"]
            for k in ("qconv", "qconv_nhwc", "qconv_stem", "quantize_nhwc",
                      "qfc")}
    if launches != want:
        raise AssertionError("int8 ResNet-50: launches %r, wanted %r"
                             % (launches, want))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("int8 ResNet-50: logits not finite")
    t0 = time.perf_counter()
    with PlainQuant():
        plain = forward()
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    if not torch.equal(logits, plain):
        raise AssertionError(
            "int8 ResNet-50: the kernel route's logits differ from the "
            "plain route's by up to %g" % float((logits - plain).abs().max()))
    mean_ms = sum(ms) / len(ms)
    log(phase="quantized_resnet50", calib_mode="naive",
        calib_images=n_calib, quantize_s=t_quant, launches=launches,
        ms_per_forward=ms, mean_ms_per_forward=mean_ms,
        float32_ms_per_forward=float_ms,
        images_per_forward=cfg["batch"],
        images_per_s=cfg["batch"] / (mean_ms / 1e3), wall_s=wall,
        peak_memory_gib=peak, plain_route_s=t_plain,
        plain_route_equal=True,
        rel_err_vs_float32=float((logits - ref).abs().max()
                                 / ref.abs().max()),
        top1_agreement=float((logits.argmax(1) == ref.argmax(1))
                             .float().mean()),
        geometries=len(by_geom.counts), q3_shapes=len(by_shape.counts))
    log(phase="profile_resnet50_int8", **profile_device(forward, 1))
    n = cfg["forwards"]
    want_geom = {(ci, co, k, s, h): c * n
                 for (ci, co, k, s, _, h), c in RESNET50_QCONV}
    want_shape = {(cfg["batch"], c, h, h): q * n for (c, h), q in RESNET50_Q3}
    if by_geom.counts != want_geom or by_shape.counts != want_shape:
        raise AssertionError(
            "Q1's and Q3's launches by geometry %r, %r are not "
            "RESNET50_QCONV's and RESNET50_Q3's" % (by_geom.counts,
                                                    by_shape.counts))
    rows, captured = {}, {}
    for key, n in by_geom.counts.items():
        rows[qconv_row(key)] = n
        captured[qconv_row(key)] = by_geom.args[key]
    for key, n in by_shape.counts.items():
        rows[quantize_row(key)] = n
        captured[quantize_row(key)] = by_shape.args[key]
    for key, n in fc.counts.items():
        rows[qfc_row(key)] = n
        captured[qfc_row(key)] = fc.args[key]
    return rows, captured


def conv_reach(size, out, k, stride, pad, dilate):
    """How many input positions along one axis a convolution reads: a
    1x1 stride-2 conv reads every other one."""
    taps = {o * stride - pad + r * dilate for o in range(out)
            for r in range(k)}
    return sum(0 <= t < size for t in taps)


def qconv_work(x, w, bias, out, stride, pad, dilate):
    """Bytes and operations one Q1 call needs: the pixels of x that the
    strides and dilation reach and w read once (int8), the bias (float32,
    where there is one) read once, the float32 output written once;
    2 * M * C_out * K operations."""
    N, C, H, W = x.shape
    KH, KW = w.shape[2:]
    OH, OW = out.shape[2:]
    read = (conv_reach(H, OH, KH, stride[0], pad[0], dilate[0])
            * conv_reach(W, OW, KW, stride[1], pad[1], dilate[1]))
    nbytes = N * C * read + w.numel() + 4 * out.numel()
    if bias is not None:
        nbytes += 4 * bias.numel()
    return nbytes, 2 * out.numel() * w[0].numel()


def qconv_int_mm(x, w, scale, bias, stride, pad, dilate, groups):
    """For a 1x1 stride-1 conv on a channels-last payload (one group, no
    padding or dilation to speak of), one PyTorch int8 product computing
    Q1's function: ``torch._int_mm`` of x viewed (N*H*W, C) and w viewed
    (C_out, C) transposed, then the same epilogue, returned as (N, C_out,
    H, W) (a view of the channels-last result); else None."""
    N, C, H, W = x.shape
    if tuple(w.shape[2:]) != (1, 1) or tuple(stride) != (1, 1) or \
            tuple(pad) != (0, 0) or groups != 1 or \
            not x.is_contiguous(memory_format=torch.channels_last):
        return None
    x2 = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    wt = w.reshape(w.shape[0], C).t()

    def library():
        out = torch._int_mm(x2, wt).float() * scale
        out = out if bias is None else out + bias
        return out.view(N, H, W, -1).permute(0, 3, 1, 2)
    return library


def measure_quantized(name, args, kw, flush):
    """Phase 17: one captured Q1, Q2 or Q3 call held ``torch.equal`` to
    its plain version, and the kernel, plain and library times.  The
    library is ``torch._int_mm`` plus the same epilogue for Q2 and for
    Q1's 1x1 stride-1 convs on their channels-last payload, cuDNN's bf16
    ``F.conv2d`` of the same shape and layout for Q1's others (no PyTorch
    call computes an int8 convolution on CUDA; its time stands beside
    ``_int_mm``'s as ``cudnn_bf16_ms`` too), and for Q3
    ``torch.quantize_per_tensor`` (``Q3_LIBRARY``; timed only, its bits
    differ)."""
    from mxtpu_torch.ops import quantized as Q

    F = torch.nn.functional
    res = dict(max_abs_err=0.0, err_over_tol=0.0, tolerance="torch.equal")
    if name.startswith("quantize_nhwc"):
        x, scale = args

        def kernel():
            return Q.quantize_nhwc(x, scale)

        def plain():
            return Q.quantize_nhwc_plain(x, scale)
        x_cl = x.contiguous(memory_format=torch.channels_last)
        s_host = float(scale)

        def library():
            return torch.quantize_per_tensor(x_cl, s_host, 0, torch.qint8)
        res["library"] = Q3_LIBRARY
        nbytes, ops = 5 * x.numel(), 0
        dtype = torch.float32
    elif name.startswith("qconv"):
        x, w, scale, bias = args[:4]
        stride, pad, dilate, groups = args[4:8]

        def kernel():
            return Q.qconv(*args, **kw)

        def plain():
            return Q.qconv_plain(x, w, scale, bias, stride, pad, dilate,
                                 groups)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)

        def cudnn():
            return F.conv2d(xb, wb, stride=stride, padding=pad,
                            dilation=dilate, groups=groups)
        library = qconv_int_mm(x, w, scale, bias, stride, pad, dilate,
                               groups)
        res["form"] = Q.route(x, groups, tuple(w.shape[2:]), dilate)
        if library is None:
            library, res["library"] = cudnn, QCONV_LIBRARY
        else:
            res["library"] = QCONV_INT_MM
            res["cudnn_bf16_ms"] = cuda_ms(cudnn, flush)
            if not torch.equal(library(), plain()):
                raise AssertionError("%s: the _int_mm yardstick differs "
                                     "from the plain version" % name)
        dtype = torch.int8
    else:
        x, w, scale, bias = args[:4]

        def kernel():
            return Q.qfc(*args, **kw)

        def plain():
            return Q.qfc_plain(x, w, scale, bias)
        wt = w.t()

        def library():
            out = torch._int_mm(x, wt).float() * scale
            return out if bias is None else out + bias
        res["library"] = "torch._int_mm + the epilogue"
        res["splits"] = Q._plan_fc(x.shape[0], w.shape[0], x.shape[1])
        res["launch_floor_ms"] = cuda_ms(lambda: Q._lib().mxtpu_empty(
            torch.cuda.current_stream().cuda_stream), flush)
        dtype = torch.int8
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("%s differs from its plain version by up to %g"
                             % (name, float((got.float() - want.float())
                                            .abs().max())))
    res["ms"] = cuda_ms(kernel, flush)
    res["plain_ms"] = cuda_ms(plain, flush)
    res["library_ms"] = cuda_ms(library, flush)
    if name.startswith("qconv"):
        nbytes, ops = qconv_work(x, w, bias, got, stride, pad, dilate)
    elif name.startswith("qfc"):
        nbytes = x.numel() + w.numel() + 4 * got.numel()
        if bias is not None:
            nbytes += 4 * bias.numel()
        ops = 2 * got.numel() * x.shape[1]
    res["bound_ms"], res["bound_by"] = bound(nbytes, ops, dtype)
    return res


# -- phases 4m, 6m and 10m: Switch mixture-of-experts -------------------------

#: phase 4m's routed model: llama_tiny's widths, 4 experts a layer
MOE_SMALL = dict(num_experts=4, capacity_factor=4.0)
#: phase 6m's: llama_3_8b's widths, 8 top-1 experts a layer of the
#: SwiGLU's hidden width (14336), CUT_DEPTH of its layers
MOE_8B = dict(num_experts=8, capacity_factor=1.25)
#: phase 6m's paged engine: each prompt (at most 640 tokens) one chunk, so
#: the engine routes every prompt as generate's one prefill does
MOE_SERVE = dict(SERVE, prefill_chunk=1024)
#: phase 10m: one full-width layer of 8 experts, float32
MOE_TRAIN = dict(num_experts=8, depth_factor=1 / 32, aux_weight=0.01)


def small_moe_reference_check():
    """A 2-layer float32 Switch MoE model (``MOE_SMALL``) on the card:
    the paged engine (chunked prefill, every chunk budgeting capacity
    from its prompt's length) and the slot engine give the tokens of
    the model's own ``generate``, greedy and seeded-sampled, with no
    prefix shared; the prefill logits and the full forward's are within
    1e-4 of the same model on the CPU."""
    from mxtpu_torch import base
    from mxtpu_torch.models.transformer import llama_tiny
    from mxtpu_torch.parallel.serving import (ContinuousBatchingEngine,
                                              PagedContinuousBatchingEngine)

    model = llama_tiny(vocab_size=64, device="cuda", **MOE_SMALL)
    init_weights(model, torch.Generator(device="cuda").manual_seed(1), 0.1)
    cpu = llama_tiny(vocab_size=64, device="cpu", **MOE_SMALL)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.RandomState(2)
    shared = rng.randint(0, 64, 13)
    prompts = [rng.randint(0, 64, (1, n)) for n in (5, 21, 9)] + [
        np.concatenate([shared, rng.randint(0, 64, n)])[None]
        for n in (3, 7)]
    knobs = [{}, {}, dict(temperature=0.9, top_p=0.9, seed=7), {},
             dict(repetition_penalty=1.3)]
    want = [model.generate(torch.from_numpy(p), 10, **kw).cpu().numpy()
            for p, kw in zip(prompts, knobs)]
    out = {}
    for name, eng in (
            ("paged", PagedContinuousBatchingEngine(
                model, num_slots=3, max_length=48, block_size=8,
                prefill_chunk=8)),
            ("slot", ContinuousBatchingEngine(model, num_slots=3,
                                              max_length=48))):
        base.reset_counts()
        rids = [eng.submit(p, 10, **kw) for p, kw in zip(prompts, knobs)]
        res = eng.run()
        for rid, w, kw in zip(rids, want, knobs):
            if not np.array_equal(res[rid].numpy(), w):
                raise AssertionError("MoE %s engine stream %r differs from "
                                     "generate %r (%r)" % (
                                         name, res[rid].numpy(), w, kw))
        st = eng.stats
        if st.get("blocks_in_use", 0) or st.get("prefix_hit_requests", 0):
            raise AssertionError("MoE %s engine: pages leaked or a prefix "
                                 "shared: %r" % (name, st))
        out[name] = base.counts()
    if not (out["paged"].get("paged_attention")
            and out["paged"].get("paged_prefill")):
        raise AssertionError("the MoE paged engine launched no K1 or K2: %r"
                             % out["paged"])
    ids = torch.from_numpy(rng.randint(0, 64, (2, 11)))
    errs = {}
    with torch.no_grad():
        for form in ("prefill", "forward"):
            if form == "prefill":
                got = model.prefill(ids.cuda(), model.init_cache(2, 11))
                ref = cpu.prefill(ids, cpu.init_cache(2, 11))
            else:
                got, ref = model(ids.cuda()), cpu(ids)
            errs[form] = float((got.cpu() - ref).abs().max())
    if not max(errs.values()) <= 1e-4:
        raise AssertionError("MoE logits on the card differ from the CPU: "
                             "%r > 1e-4" % errs)
    log(phase="small_moe_reference", requests=len(prompts), ok=True,
        launches=out, logits_vs_cpu_max_abs=errs)


def bf16_ulp(x):
    """One bf16 ulp of each element of ``x`` (0 where x is 0)."""
    m, e = torch.frexp(x.float().abs())
    return torch.where(m == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


class Routes:
    """The top-1 routing of every token at every routed layer during a
    run, recorded by instance overrides of each ``SwitchMoE``'s
    ``decode_forward`` and ``prefill_forward`` (the package has no
    switch for it): per (stream, position, layer) the expert chosen, the
    router's logits and, for each pair of experts (a, b), the bound
    sum_j ulp(x_j) * |w_a,j - w_b,j| by which their logit difference can
    move when every element of the router's bf16 input x moves by one
    ulp.  An engine run names a token by its slot's request and
    position; ``generate`` by ``stream`` and the step's position.  It
    also counts the prompt tokens each layer's prefill capacity
    dropped."""

    def __init__(self, model, eng=None):
        self.model, self.eng = model, eng
        self.moes = [layer.moe for layer in model.layers]
        self.streams = {}          # rid -> stream index (engine runs)
        self.key = None            # (stream, start) of the prefill running
        self.pos = None            # generate's step position
        self.rec = {}              # layer -> [(stream, pos, logits, bounds)]
        self.drops = [[0, 0] for _ in self.moes]
        E = self.moes[0].num_experts
        self.pairs = []
        for moe in self.moes:
            w = moe.router_weight.detach().float()
            self.pairs.append((w, (w[:, None, :] - w[None, :, :]).abs()
                               .reshape(E * E, -1).t().contiguous()))

    def _record(self, i, x, prefill, total_len=None):
        w, diff = self.pairs[i]
        E = w.shape[0]
        xf = x.reshape(-1, x.shape[-1]).float()
        if prefill:
            if self.key is None or self.key[0] is None:
                return
            stream, start = self.key
            T = x.shape[1]
            streams = torch.full((T,), stream, dtype=torch.long)
            pos = start + torch.arange(T)
            keep = slice(None)
            moe = self.moes[i]
            total = int(total_len) if total_len is not None else T
            cap = max(1, math.ceil(moe.top_k * x.shape[0] * total / E
                                   * moe.capacity_factor))
            route = torch.argmax(xf @ w.t(), dim=-1)
            over = torch.clamp(torch.bincount(route, minlength=E) - cap,
                               min=0)
            self.drops[i][0] += int(over.sum())
            self.drops[i][1] += T
        elif self.eng is not None:
            rows, streams, pos = [], [], []
            for b, slot in enumerate(self.eng._slots):
                if slot is None or slot.prefilling \
                        or slot.req.rid not in self.streams:
                    continue
                rows.append(b)
                streams.append(self.streams[slot.req.rid])
                pos.append(slot.pos)
            if not rows:
                return
            keep = torch.tensor(rows, device=x.device)
            streams, pos = torch.tensor(streams), torch.tensor(pos)
        else:
            if self.key is None:
                return
            streams = torch.full((xf.shape[0],), self.key[0],
                                 dtype=torch.long)
            pos = torch.full((xf.shape[0],), self.pos, dtype=torch.long)
            keep = slice(None)
        xk = xf[keep]
        self.rec.setdefault(i, []).append(
            (streams, pos, xk @ w.t(), bf16_ulp(xk) @ diff))

    def _override(self, owner, attr, make):
        """Put ``make(current)`` on ``owner`` as ``attr``; ``__exit__``
        puts back what was there (another override, or nothing)."""
        self._saved.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, make(getattr(owner, attr)))

    def _wrap(self, i, moe, name):
        prefill = name == "prefill_forward"

        def make(inner):
            def call(x, *a, **kw):
                self._record(i, x, prefill, *a, **kw)
                return inner(x, *a, **kw)
            return call

        self._override(moe, name, make)

    def _engine_key(self, attr, key):
        def make(inner):
            def call(*a, **kw):
                self.key = key(*a)
                try:
                    return inner(*a, **kw)
                finally:
                    self.key = None
            return call

        self._override(self.eng, attr, make)

    def __enter__(self):
        self._saved = []
        for i, moe in enumerate(self.moes):
            self._wrap(i, moe, "decode_forward")
            self._wrap(i, moe, "prefill_forward")
        if self.eng is None:
            def make(inner):
                def step(ids, caches, pos):
                    self.pos = pos
                    return inner(ids, caches, pos)
                return step

            self._override(self.model, "step", make)
        elif hasattr(self.eng, "_advance_prefill"):
            def paged_key(row):
                slot = self.eng._slots[row]
                return (self.streams.get(slot.req.rid),
                        slot.chunks[slot.chunk_i][0])

            self._engine_key("_advance_prefill", paged_key)
        else:
            self._engine_key("_admit", lambda req, row: (
                self.streams.get(req.rid), 0))
        return self

    def __exit__(self, *exc):
        for owner, attr, prev in reversed(self._saved):
            if prev is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, prev)

    def table(self):
        """{(stream, layer): {pos: (route, logits, bounds)}} on the host
        (a stream of None, a warm-up request, is left out)."""
        out = {}
        for i, parts in self.rec.items():
            for streams, pos, logits, bounds in parts:
                lg, bd = logits.cpu().numpy(), bounds.cpu().numpy()
                for k, (s, p) in enumerate(zip(streams.tolist(),
                                               pos.tolist())):
                    if s is None or s < 0:
                        continue
                    out.setdefault((s, i), {})[p] = (
                        int(lg[k].argmax()), lg[k], bd[k])
        return out

    def drop_shares(self):
        return [d / t if t else 0.0 for d, t in self.drops]


def routing_flips(gen, eng, stream, n_layers, upto):
    """The tokens of ``stream`` at positions below ``upto`` whose expert
    differs between the ``generate`` run ``gen`` and the engine run
    ``eng`` (``Routes.table``s): each with generate's gap from its
    expert's logit to the engine's expert's, the one-ulp bound of that
    pair, and whether it is primary (no flip at a lower layer and an
    earlier or equal position, whose changed output would reach it)."""
    flips = []
    for i in range(n_layers):
        g, e = gen.get((stream, i), {}), eng.get((stream, i), {})
        for p in sorted(set(g) & set(e)):
            if p >= upto or g[p][0] == e[p][0]:
                continue
            a, b = g[p][0], e[p][0]
            E = len(g[p][1])
            flips.append(dict(layer=i, pos=p, generate_expert=a,
                              engine_expert=b,
                              gap=float(g[p][1][a] - g[p][1][b]),
                              bound=float(g[p][2][a * E + b]),
                              engine_gap=float(e[p][1][b] - e[p][1][a])))
    for f in flips:
        f["primary"] = not any(o["layer"] < f["layer"]
                               and o["pos"] <= f["pos"] for o in flips)
    return flips


def moe_streams_vs_generate(name, model, reqs, streams, gen_streams,
                            gen_routes, routes):
    """C5's rule extended by routing: a greedy engine stream may part
    from ``generate`` where generate's top logits lie within
    ``PARTING_ULPS``, or after a primary routing flip on that stream
    whose gap lies within its one-ulp bound (``routing_flips``).  Every
    primary flip on any stream, parted or not, must lie within its
    bound; flips downstream of one are logged, not held.  Sampled
    streams are read only."""
    n_layers = len(model.layers)
    gen_t, eng_t = gen_routes.table(), routes.table()
    parted, wide, unexplained, flip_log = [], [], [], []
    for j, ((p, kw), got, want) in enumerate(zip(reqs, streams,
                                                 gen_streams)):
        diff = np.nonzero(want[0] != got[0])[0]
        at = int(diff[0]) if diff.size else want.shape[1]
        flips = routing_flips(gen_t, eng_t, j, n_layers, at)
        primary = [f for f in flips if f["primary"]]
        wide += [dict(f, request=j) for f in primary
                 if f["gap"] > f["bound"]]
        flip_log += [dict(f, request=j) for f in primary]
        if not diff.size:
            continue
        entry = dict(request=j, sampled="temperature" in kw,
                     token=at - p.shape[1], flips=len(flips),
                     primary_flips=len(primary))
        if not entry["sampled"]:
            lg = generate_logits(model, want[:, :at], p.shape[1], None)
            top, eng = float(lg[want[0, at]]), float(lg[got[0, at]])
            ulp = 2.0 ** (np.floor(np.log2(abs(top))) - 7)
            entry.update(gap=top - eng, gap_ulps=(top - eng) / ulp)
            entry["explained_by"] = (
                "logits" if entry["gap_ulps"] <= PARTING_ULPS else
                "routing" if any(f["gap"] <= f["bound"] for f in primary)
                else None)
            if entry["explained_by"] is None:
                unexplained.append(entry)
        parted.append(entry)
    shares = [f["gap"] / f["bound"] for f in flip_log if f["bound"] > 0]
    log(phase="moe_streams_vs_generate", engine=name, requests=len(reqs),
        identical=len(reqs) - len(parted), parted=parted,
        bound_ulps=PARTING_ULPS, primary_flips=flip_log,
        max_primary_gap_share_of_bound=max(shares) if shares else None)
    if wide or unexplained:
        raise AssertionError(
            "MoE %s engine: routing flips wider than their one-ulp bound "
            "%r, or partings from generate that neither a near-tie of its "
            "logits nor a routing flip explains %r" % (name, wide,
                                                       unexplained))


def serve_moe_8b():
    """Phase 6m: ``llama_3_8b(**MOE_8B)`` at full width and CUT_DEPTH,
    bf16, Normal(0, 0.02) weights from seed 0, served phase 5's traffic
    by the paged engine (``MOE_SERVE``), the slot engine and a paged
    engine built with ``spec_k=4``.  Held: no prefix shared, speculation
    off (0 drafted, streams identical to the plain engine's), no page
    leaked, finite logits, K1, K2 and G1 launched, and each engine's
    streams against ``generate`` by ``moe_streams_vs_generate`` (the
    routes from a second run, held to the timed run's streams).
    Returns the kernels-line row of K2 at the longest (unpadded) chunk:
    its name, its launches at that length in the paged run and its
    captured inputs."""
    from mxtpu_torch import base
    from mxtpu_torch.models import sampler
    from mxtpu_torch.models.transformer import llama_3_8b
    from mxtpu_torch.ops import prefill_attention as pf
    from mxtpu_torch.parallel.serving import (ContinuousBatchingEngine,
                                              PagedContinuousBatchingEngine)

    t0 = time.perf_counter()
    model = llama_3_8b(depth_factor=CUT_DEPTH, device="cuda", **MOE_8B)
    init_weights(model, torch.Generator(device="cuda").manual_seed(0), 0.02)
    n_layers = len(model.layers)
    moe0 = model.layers[0].moe
    torch.cuda.synchronize()
    log(phase="moe_model", layers=n_layers, dtype="bfloat16",
        params=sum(p.numel() for p in model.parameters()),
        experts=moe0.num_experts, capacity_factor=moe0.capacity_factor,
        expert_hidden=moe0.experts_w1.shape[-1],
        seconds=time.perf_counter() - t0)
    reqs = traffic(model.vocab_size)
    longest = max(p.shape[1] for p, _ in reqs)
    gen_routes = Routes(model)
    gen_streams = []
    with gen_routes:
        for j, (p, kw) in enumerate(reqs):
            gen_routes.key = (j, 0)
            gen_streams.append(model.generate(torch.from_numpy(p).cuda(),
                                              NEW_TOKENS, **kw).cpu().numpy())
    gen_routes.key = None
    out, streams, routes = {}, {}, {}
    k2_cap = Capture(pf, "paged_prefill_attention",
                     lambda n, a, kw: a[0].shape[2] == longest)
    for name, make in (
            ("paged", lambda: PagedContinuousBatchingEngine(model,
                                                            **MOE_SERVE)),
            ("slot", lambda: ContinuousBatchingEngine(model, **SLOT_SERVE)),
            ("spec_k=4", lambda: PagedContinuousBatchingEngine(
                model, spec_k=4, **MOE_SERVE))):
        # the timed run is bare; the routes are recorded in a second run
        # on a fresh engine (``Routes`` synchronizes the stream inside
        # the timed calls), whose streams must be the timed run's
        eng = make()
        eng.submit(np.arange(64)[None], 2)         # warm-up, outside counts
        eng.run()
        before = eng.stats
        moe_ms = [Timed(layer.moe, "decode_forward")
                  for layer in model.layers]
        step_attr = "step_pages" if name != "slot" else "step_slots"
        pre_attr = "prefill_pages" if name != "slot" else "prefill"
        torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            if name == "paged":
                stack.enter_context(k2_cap)
                k2_by_len = stack.enter_context(Counted(
                    pf, "paged_prefill_attention",
                    lambda a, kw: int(a[0].shape[2])))
            finite = stack.enter_context(FiniteLogits(sampler))
            t_dec = stack.enter_context(Timed(model, step_attr))
            t_pre = stack.enter_context(Timed(model, pre_attr))
            for t in moe_ms:
                stack.enter_context(t)
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
        streams[name] = [res[r].numpy() for r in rids]
        for r, (p, _) in zip(rids, reqs):
            if tuple(res[r].shape) != (1, p.shape[1] + NEW_TOKENS):
                raise AssertionError("MoE %s: request %d returned %s" % (
                    name, r, tuple(res[r].shape)))
        if finite.ok is None or not bool(finite.ok):
            raise AssertionError("MoE %s: a sampled logit row was not "
                                 "finite" % name)
        if after.get("blocks_in_use", 0) or after.get(
                "prefix_hit_requests", 0) != before.get(
                    "prefix_hit_requests", 0):
            raise AssertionError("MoE %s: pages leaked or a prefix shared: "
                                 "%r" % (name, after))
        if after["drafted_tokens"] or after["verify_calls"]:
            raise AssertionError("MoE %s: the engine speculated: %r"
                                 % (name, after))
        pre_tokens = sum(p.shape[1] for p, _ in reqs)
        expert_elems = moe0.experts_w1.numel() + moe0.experts_w2.numel()
        out[name] = dict(
            launches=launches, decode_steps=steps,
            prefill_calls=len(t_pre.events),
            mean_ms_per_decode_step=t_dec.ms() / steps,
            moe_ffn_event_ms_per_decode_step=sum(t.ms() for t in moe_ms)
            / steps,
            prefill_tokens_per_s=pre_tokens / (t_pre.ms() / 1e3),
            wall_s=wall,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            # a call reads both bf16 expert tensors, writes their float32
            # copies and reads those in the products
            expert_upcast_bytes_per_layer_call=expert_elems * (2 + 4 + 4))
        if name == "paged":
            paged_eng = eng
            out[name]["paged_prefill_calls_by_chunk_length"] = {
                str(t): n for t, n in sorted(k2_by_len.counts.items())}
        del eng
        if name == "spec_k=4":
            continue
        eng = make()
        eng.submit(np.arange(64)[None], 2)
        eng.run()
        rec = Routes(model, eng)
        with rec:
            rids = [eng.submit(p, NEW_TOKENS, **kw) for p, kw in reqs]
            rec.streams = {r: j for j, r in enumerate(rids)}
            res = eng.run()
        if not all(np.array_equal(res[r].numpy(), want)
                   for r, want in zip(rids, streams[name])):
            raise AssertionError("MoE %s: the routed run's streams differ "
                                 "from the timed run's" % name)
        routes[name] = rec
        out[name]["prompt_tokens_dropped_share_by_layer"] = rec.drop_shares()
        del eng
    if not all(np.array_equal(a, b) for a, b in zip(streams["spec_k=4"],
                                                    streams["paged"])):
        raise AssertionError("MoE: the spec_k=4 engine's streams differ "
                             "from the plain engine's")
    paged = out["paged"]["launches"]
    want_k = {"paged_attention": n_layers * out["paged"]["decode_steps"],
              "paged_prefill": n_layers * len(reqs)}
    if any(paged.get(k) != n for k, n in want_k.items()) or not (
            paged.get("rows_linear") and paged.get("rows_norm_linear")):
        raise AssertionError("MoE paged engine launches %r: wanted K1 and "
                             "K2 %r and G1 launched" % (paged, want_k))
    moe_launches = {k: paged.get(k, 0) for k in (
        "paged_attention", "paged_prefill", "rows_linear",
        "rows_norm_linear", "rows_rms_norm")}
    for name in ("paged", "slot"):
        moe_streams_vs_generate(name, model, reqs, streams[name],
                                gen_streams, gen_routes, routes[name])
    # one profiled decode step of 8 slots at ~520 tokens: the routed FFN's
    # device time from its profiler range, beside the step's
    rng = np.random.RandomState(5)
    for _ in range(MOE_SERVE["num_slots"]):
        paged_eng.submit(rng.randint(0, model.vocab_size, (1, 512)), 8)
    paged_eng.step()                           # every slot prefilled
    ranged = []
    for layer in model.layers:
        inner = layer.moe.decode_forward

        def ranged_call(x, inner=inner):
            with torch.profiler.record_function("moe_ffn"):
                return inner(x)

        layer.moe.decode_forward = ranged_call
        ranged.append(layer.moe)
    try:
        prof = profile_moe_step(paged_eng.step)
    finally:
        for moe in ranged:
            del moe.decode_forward
    paged_eng.run()
    log(phase="serve_moe", model="llama_3_8b(num_experts=8, "
        "capacity_factor=1.25, depth_factor=%g)" % CUT_DEPTH,
        requests=len(reqs), engines=out, moe_launches=moe_launches,
        profile=prof)
    k2_name = "paged_prefill[unbucketed,T=%d]" % longest
    if k2_cap.args is None:
        raise AssertionError("the MoE main path ran no %d-token chunk"
                             % longest)
    # the wrapper's calls by chunk length are its launches: their total
    # is the launch count the wrapper kept
    n_k2 = k2_by_len.counts.get(longest, 0)
    if not n_k2 or sum(k2_by_len.counts.values()) != paged.get(
            "paged_prefill"):
        raise AssertionError("MoE paged engine: K2 calls by chunk length "
                             "%r against %r launches; none at T = %d" % (
                                 k2_by_len.counts, paged.get("paged_prefill"),
                                 longest))
    del model, paged_eng, routes, gen_routes
    gc.collect()
    torch.cuda.empty_cache()
    return moe_launches, k2_name, n_k2, (k2_cap.args, k2_cap.kwargs)


def profile_moe_step(run):
    """One profiled call of ``run``: ``profile_device``'s record of it,
    and the device time of its ``moe_ffn`` ranges (the kernels their
    ops launched), or "not measured" where the profiler gives none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    moe = [e for e in prof.key_averages() if e.key == "moe_ffn"]
    total = getattr(moe[0], "device_time_total", None) if moe else None
    if total is None and moe:
        total = getattr(moe[0], "cuda_time_total", 0)
    device = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return dict(moe_ffn_device_ms_per_step=total / 1e3 if total
                else "not measured",
                moe_ffn_ranges=moe[0].count if moe else 0,
                device_ms_per_step=device / 1e3 if device
                else "not measured")


def train_moe_8b():
    """Phase 10m: ``llama_3_8b`` at full width, one layer of 8 experts
    (``MOE_TRAIN``), float32, returning ``(logits, aux)``, trained by
    SPMDTrainer with Adam and ``NextTokenLoss(moe_aux_weight=0.01)`` on
    phase 10's batch: first one forward and backward outside the trainer
    (a finite aux; a nonzero gradient on the router and on every expert
    that received tokens), then one warm-up step and 5 steps with the
    counts zeroed just before: K3, K4 and K5 each launched once a layer
    a step, a finite loss that falls."""
    from mxtpu_torch import base
    from mxtpu_torch.models.transformer import llama_3_8b
    from mxtpu_torch.parallel.trainer import SPMDTrainer

    t0 = time.perf_counter()
    model = llama_3_8b(depth_factor=MOE_TRAIN["depth_factor"], device="cuda",
                       dtype=torch.float32,
                       num_experts=MOE_TRAIN["num_experts"],
                       return_moe_aux=True)
    init_weights(model, torch.Generator(device="cuda").manual_seed(0), 0.02)
    n_layers = len(model.layers)
    loss_fn = NextTokenLoss(moe_aux_weight=MOE_TRAIN["aux_weight"])
    batch = next(synthetic_batches(TRAIN["batch"], TRAIN["seq"], 1,
                                   vocab=model.vocab_size, seed=0))
    torch.cuda.synchronize()
    log(phase="train_moe_model", layers=n_layers, dtype="float32",
        params=sum(p.numel() for p in model.parameters()),
        seconds=time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    routed = []
    hooks = [layer.ffn_norm.register_forward_hook(
        lambda mod, args, out, moe=layer.moe: routed.append(torch.bincount(
            torch.argmax(out.reshape(-1, out.shape[-1]).float()
                         @ moe.router_weight.float().t(), dim=-1),
            minlength=moe.num_experts)))
        for layer in model.layers]
    ids = torch.from_numpy(batch).cuda()
    out = model(ids)
    aux = float(out[1].detach())
    loss_fn(out, ids).mean().backward()
    for h in hooks:
        h.remove()
    grads = {}
    for i, layer in enumerate(model.layers):
        moe = layer.moe
        got = routed[i].cpu().numpy()
        g1 = moe.experts_w1.grad.abs().flatten(1).sum(1).cpu().numpy()
        g2 = moe.experts_w2.grad.abs().flatten(1).sum(1).cpu().numpy()
        router = float(moe.router_weight.grad.abs().sum())
        grads[i] = dict(tokens_by_expert=got.tolist(),
                        router_grad_abs_sum=router,
                        w1_grad_abs_sum=g1.tolist(),
                        w2_grad_abs_sum=g2.tolist())
        if not router > 0 or any(not (a > 0 and b > 0) for a, b, n
                                 in zip(g1, g2, got) if n > 0):
            raise AssertionError("MoE training: a zero gradient on the "
                                 "router or on an expert that received "
                                 "tokens: %r" % grads[i])
    if not np.isfinite(aux):
        raise AssertionError("MoE training: aux %r is not finite" % aux)
    model.zero_grad(set_to_none=True)
    del out
    trainer = SPMDTrainer(model, loss_fn, "adam",
                          {"learning_rate": TRAIN["lr"]})
    losses = [trainer.step(batch, batch) for _ in range(TRAIN["warmup"])]
    torch.cuda.synchronize()
    events = []
    base.reset_counts()
    for _ in range(TRAIN["steps"]):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        losses.append(trainer.step(batch, batch))
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    launches = base.counts()
    losses = [float(x) for x in losses]
    timed = losses[TRAIN["warmup"]:]
    want = n_layers * TRAIN["steps"]
    if any(launches.get(k, 0) != want
           for k in ("flash_fwd", "flash_dq", "flash_dkv")):
        raise AssertionError("MoE training launches %r: wanted K3-K5 %d "
                             "each" % (launches, want))
    if not all(np.isfinite(losses)) or not timed[-1] < timed[0]:
        raise AssertionError("MoE training losses not finite or not "
                             "falling: %r" % losses)
    step_ms = [s.elapsed_time(e) for s, e in events]
    mean_ms = sum(step_ms) / len(step_ms)
    tokens = TRAIN["batch"] * TRAIN["seq"]
    moe_launches = {k: launches.get(k, 0)
                    for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    log(phase="train_moe", model="llama_3_8b(num_experts=8, "
        "depth_factor=1/32, return_moe_aux=True)", aux=aux,
        aux_weight=MOE_TRAIN["aux_weight"], gradients=grads,
        launches=launches, losses=losses, ms_per_step=step_ms,
        mean_ms_per_step=mean_ms, tokens_per_s=tokens / (mean_ms / 1e3),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return moe_launches


class PhaseClock:
    """Logs the seconds since the last mark (and since the first) under a
    phase's name: ``{"phase": "phase_seconds", "name": ..., ...}``."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        log(phase="phase_seconds", name=name, seconds=now - self.last,
            total_s=now - self.start)
        self.last = now


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device — it runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import mxtpu_torch  # noqa: F401  (fails here outside a checkout)

    tick = PhaseClock()
    card()
    build()
    timing_floor()
    tick("1-2 card, build, timing floor")
    flush = _L2Flush()
    kernels_against_plain(flush)
    verify_kernels_against_plain()
    kernels_against_plain(flush, quant=True)
    verify_kernels_against_plain(quant=True)
    prefill_unbucketed_against_plain(flush)
    g1 = linear_against_plain(flush)
    g2 = norm_against_plain(flush)
    fused = norm_linear_against_pair(flush)
    wq_results = quant_linear_against_plain(flush)
    tick("3, 3b, 3c kernels against plain")
    small_model_reference_check()
    small_model_speculative_check()
    small_model_speculative_check(cache_dtype="int8")
    tick("4, 4b, 4c small models")
    small_moe_reference_check()
    tick("4m small MoE model")
    model = llama_3_8b_model()
    launches, served, streams = serve_llama_3_8b(model)
    streams_vs_generate(model, traffic(model.vocab_size), streams)
    launches_q8, served_q8, streams_q8 = serve_llama_3_8b(model, "int8")
    compare_streams("int8_vs_bf16_streams", traffic(model.vocab_size),
                    streams, streams_q8)
    tick("5, 5b, 6 serving")
    # G1's launches on the main path are the bf16 run's
    launches.update({k: n for k, n in launches_q8.items()
                     if not k.startswith("rows_linear")})
    served.update(served_q8)
    k1_counts, verify_caps, reqs, g1_by_m = serve_llama_3_8b_speculative(
        model)
    k1_counts_q8, verify_caps_q8, _, _ = serve_llama_3_8b_speculative(
        model, "int8", reqs)
    tick("6b, 6c speculative serving")
    # the rest of decoding: draft-model speculation on the paged engine
    # (the model's pools, then int8 ones), the slot engine, the samplers
    serve_draft_model(model, None, streams)
    serve_draft_model(model, "int8", streams_q8)
    tick("6d draft model")
    serve_slots(model, reqs)
    tick("6s slot engine")
    samplers_8b(model)
    tick("6t samplers")
    serve_sessions()
    gc.collect()
    torch.cuda.empty_cache()
    tick("6h hierarchical cache and sessions")
    serve_traced(model, streams)
    tick("6e(a) traced rerun")
    serve_replicas(model, streams)
    tick("6r(a) in-process replicas")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model_a, want_a = serve_hotswap()
    gc.collect()
    torch.cuda.empty_cache()
    tick("6e(b) hot-swap and cancel")
    serve_subprocess_replicas(model_a, want_a)
    del want_a
    tick("6r(b) subprocess replicas")
    tp_rows, tp_launches = serve_tensor_parallel(model_a)
    del model_a
    gc.collect()
    torch.cuda.empty_cache()
    tick("6p tensor parallelism")
    results = dict(tp_rows)
    launches.update(tp_launches)
    # phase 6m: Switch MoE serving at full width; K2 at its longest
    # unpadded chunk joins the kernels line
    moe_serve, k2_name, k2_n, (k2_args, k2_kw) = serve_moe_8b()
    results[k2_name] = measure(k2_name, k2_args, flush, kw=k2_kw)
    launches[k2_name] = k2_n
    log(phase="moe_inputs", kernel=k2_name, shape=list(k2_args[0].shape),
        launches=k2_n, **results[k2_name])
    del k2_args, k2_kw
    tick("6m MoE serving")
    # phases 5q and 6q: the weight-only int8 and int4 model
    quant_launches = {}
    for bits in (8, 4):
        quant_launches.update(serve_quantized(bits))
    tick("5q, 6q weight-only quantized serving")
    for name, res in wq_results.items():
        n = quant_launches.get(name, 0)
        if not n and (name.startswith("rows_norm_linear")
                      or "_q8[" in name) and "M=64" in name:
            # only a linear W = 8 window runs a fused projection (and the
            # epilogue) at 64 rows, and the motif traffic may draft none
            log(phase="kernels_row_dropped", kernel=name, launches=0)
            continue
        if not n:
            raise AssertionError("the quantized main path never launched %s"
                                 % name)
        results[name], launches[name] = res, n
    for name, (args, kw) in served.items():
        results[name] = measure(name, args, flush, kw=kw)
        log(phase="served_inputs", kernel=name, shape=list(args[0].shape),
            **results[name])
    for tag, counts, caps in (("", k1_counts, verify_caps),
                              ("int8,", k1_counts_q8, verify_caps_q8)):
        for kind, (args, kw) in caps.items():
            W = int(args[0].shape[2])
            name = "paged_attention[%s%sW=%d]" % (
                tag, "tree," if kind == "tree" else "", W)
            results[name] = measure(name, args, flush, kw=kw)
            launches[name] = counts.get((W, kind == "tree"), 0)
            if not launches[name]:
                raise AssertionError("the speculative main path never "
                                     "launched K1 as %s" % name)
            log(phase="verify_inputs", kernel=name,
                shape=list(args[0].shape), launches=launches[name],
                **results[name])
    for pname, N, K in PROJECTIONS:
        for M in (8, 64, 128):
            name = "rows_linear[%s,M=%d]" % (pname, M)
            results[name] = g1[pname, M]
            # M = 8: the decode steps of phase 5; 64 and 128: phase 6b's
            # W = 8 windows and W = 16 trees of 8 slots
            for kind in ("rows_linear", "rows_norm_linear"):
                if kind == "rows_norm_linear" and pname not in NORMED:
                    continue
                name = "%s[%s,M=%d]" % (kind, pname, M)
                results[name] = (g1 if kind == "rows_linear"
                                 else fused)[pname, M]
                launches[name] = (
                    launches["%s(%s)" % (kind, pname)] if M == 8
                    else g1_by_m[kind].get("%s,M=%d" % (pname, M), 0))
                if not launches[name]:
                    raise AssertionError("the main path never launched %s"
                                         % name)
    # G2 no longer runs apart on the main path: its row keeps its times
    results["rows_rms_norm[M=8]"] = g2
    launches["rows_rms_norm[M=8]"] = launches.get("rows_rms_norm", 0)
    del served, verify_caps, verify_caps_q8
    torch.cuda.empty_cache()
    tick("7 serving kernels timed")
    flash_kernels_against_plain()
    small_training_check()
    tick("8, 9 flash kernels, small training")
    trained, captured = train_llama_3_8b()
    torch.cuda.empty_cache()
    launches.update(trained)
    for name, args in captured.items():
        results[name] = measure_flash(name, args, flush)
        log(phase="training_inputs", kernel=name,
            shape=list(args[0].shape), **results[name])
    del captured
    torch.cuda.empty_cache()
    tick("10, 11 Llama training")
    moe_train = train_moe_8b()
    log(phase="moe_launches", serve_6m=moe_serve, train_10m=moe_train)
    tick("10m MoE training")
    conv_kernel_against_plain()
    small_resnet_training_check()
    tick("12, 13 conv kernel, small ResNet")
    trained, captured, net = train_resnet50()
    torch.cuda.empty_cache()
    launches.update(trained)
    for name, args in captured.items():
        results[name] = measure_conv(args, flush)
        log(phase="resnet_inputs", kernel=name, shape=list(args[0].shape),
            cout=args[1].shape[0], launches=launches[name], **results[name])
    del captured
    tick("14, 15 ResNet training")
    # phases 16 and 17: int8 inference of the trained net, then Q1 at
    # each distinct conv geometry and Q2 at the classifier
    held = [net]
    del net
    quantized, captured = quantize_resnet50(held)
    gc.collect()
    torch.cuda.empty_cache()
    tick("16 int8 ResNet-50")
    launches.update(quantized)
    for name, (args, kw) in captured.items():
        results[name] = measure_quantized(name, args, kw, flush)
        log(phase="quantized_inputs", kernel=name,
            shape=list(args[0].shape), wshape=list(args[1].shape),
            launches=launches[name], **results[name])
    del captured
    tick("17 int8 kernels timed")
    rows = []
    for name, res in results.items():
        source, replaces = KERNEL_SOURCES[name.split("[")[0]]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=res["max_abs_err"],
                         err_over_tol=res["err_over_tol"], ms=res["ms"],
                         plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
                         bound_by=res["bound_by"],
                         library_ms=res["library_ms"]))
        for key in ("bound_tc_ms", "bwd_ms", "library", "library_error",
                    "weight_bytes", "tolerance", "form", "cudnn_bf16_ms",
                    "splits", "launch_floor_ms"):
            if key in res:
                rows[-1][key] = res[key]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
