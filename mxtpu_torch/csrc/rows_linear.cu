// The row-invariant ops of the decode step and the verify window, for
// Hopper (sm_90a): G1, the projection,
//
//   y (M, N) = x (M, K) @ w (N, K)^T,   float32 accumulation,
//
// for the six projections (qkv, out_proj, gate, up, down, lm_head), and
// G2, the RMSNorm of every row,
//
//   y = x * rsqrt(mean(x * x) + eps) * gamma,   in float32,
//
// for the three norms (attn_norm, ffn_norm, the final norm).  They
// replace no Pallas kernel: XLA's dot and rms_norm ran these ops on the
// TPU.  They exist because PyTorch's library kernels pick their layout
// by the row count (cuBLAS a split-K kernel at the decode step's 8 rows
// and another at a verify window's 8W rows; the mean's reduction, see G2
// below), so a window lane and the step at its position rounded the
// same row otherwise, and bfloat16 speculative streams parted from plain
// ones at logit ties.
//
// G1's guarantee, by construction: a row's result depends only on that
// row of x and on w, never on M or on where the row sits.  Each output
// element is one chain of products accumulated in a fixed order: the
// split of K into S ranges and the k16 walk inside each depend on N and
// K alone (splits(), k_range()), and the S partial sums are added in
// split order 0, 1, ..., S-1 and rounded once.  Rows never meet.
//
// What bounds it on the H100: weight bytes.  A projection does 2MNK
// operations on 2NK weight bytes, M operations a byte, so at M <= 128
// it stays below the ~295 a byte at which the bf16 tensor cores, and
// not HBM, would be the limit; the decode step (M = 8) of the 8B model
// reads 15 GB of weights, ~4.5 ms at 3.35 TB/s.
//
// bfloat16 (rows_linear_bf16_kernel): the design reads every weight
// byte from device memory once a call, in one launch:
//
// - One block per (N tile, K split, 128-row chunk of M).  The block
//   holds every row of x of its chunk (M <= 128: all of them) against
//   its weight tile, so the weights stream through once at any
//   M <= 128; above 128 rows the grid's z axis walks 128-row chunks.
// - The weights are the MMA's A operand (mma.sync m16n8k16, bf16 in,
//   float32 sums: 16 weight rows, i.e. 16 output columns) and x's rows
//   its B operand (8 rows a fragment), so M = 8 fills every MMA and one
//   instruction shape serves every M.  A row class (8, 32, 64 or 128
//   rows, by M) fixes the fragments a computing warp holds; the N tile
//   widens with the class (64 columns up to 32 rows, 128 at 64, 256 at
//   128) so x, re-read from L2 by every N tile, stays at most half the
//   weights' bytes; at 128 rows it narrows to 192 where that grid fits
//   one wave of clusters (N = 4096: 88 blocks, not 64 on 132 SMs).  The
//   tile's width changes no element's arithmetic.
// - A producer warp streams 64-deep K slices of the weight tile and of
//   the chunk's x rows into a ring of shared-memory stages by TMA (one
//   cp.async.bulk.tensor box each, 128-byte swizzle, so ldmatrix's
//   rows fall on distinct banks; rows past N or M and columns past K
//   land as zeros), each stage completing on an mbarrier; the computing
//   warps release a stage on a second mbarrier.  A slice reaching past
//   its split's end runs only the split's k16 steps (the box's tail is
//   the next split's); past K the box holds zeros, so a last half step
//   (K % 16 == 8) adds exact zeros.  The ring is sized by
//   the class so two or more blocks share an SM up to 64 rows.  Two
//   cheaper loaders were tried first and measured on the H100: one
//   cp.async.bulk a 128- or 256-byte weight row (the copies issue one
//   at a time; a fifth of the bytes' rate), and 16-byte cp.async by
//   every thread (the SM's outstanding requests cap it near 2.3 TB/s,
//   and at M = 128 the x re-reads then doubled the time).
// - Split-K in one launch: the S <= 4 blocks of one N tile form a
//   thread-block cluster.  Each writes its float32 partial tile to its
//   own shared memory; after a cluster barrier each block adds, for its
//   share of the tile, the S partials over distributed shared memory in
//   split order, rounds once to bfloat16 and stores.  No workspace, no
//   second kernel.  S = 1 (lm_head) launches no cluster.
// - The launch plan (row class, N tile, S, stages, shared memory) is
//   the wrapper's (ops/linear.py: plan); the launcher recomputes it and
//   refuses a plan that disagrees, or a cluster the card cannot
//   schedule.  The tensor maps are encoded on the host each call.
//
// float32 (rows_linear_f32_kernel): the small models' path, on the CUDA
// cores (no TF32): a 32x32 output tile per block of 256 threads, K in
// 32-deep slices through shared memory, each output one sequential FMA
// chain over k ascending.
//
// G2 (rows_rms_norm_kernel): PyTorch's mean over the last axis picks its
// reduction layout by the number of rows (whole warps per row at 8 rows,
// one warp per row at 128), so a row's mean of squares, and now and then
// its bf16 output, differed between a step and a window lane.  Here one
// warp reduces a row in an order fixed by C alone (row_scale), and a
// block of 256 threads writes the row; nothing depends on the row count.
// Bound: bytes (each row read twice, from L1/L2 the second time, written
// once), but a call is far too small for that to show: its time is the
// launch.
//
// The fused norm (rows_norm_linear: the decode step's and the verify
// window's qkv, gate, up and lm_head, whose x is the output of G2 and
// nothing else) runs G2 inside G1's launch and gives G2-then-G1's bits:
//
//   y = rows_linear(rows_rms_norm(x, gamma, eps), w),
//
// so no norm kernel is launched and the normed rows never reach device
// memory.  The bf16 kernel first computes the scales of the chunk's rows
// with row_scale, reading x from global memory (it sits in L2), the rows
// dealt over the blocks of a cluster (every fused launch is clustered,
// lm_head's single-split tiles too) and shared over distributed shared
// memory after a cluster barrier, while the producer warp starts the
// ring.  The producer copies each slice's gains beside it.  Above 8 rows
// two more warps normalize each landed x slice in place in its stage
// ((x * r) * gamma[k], rounded once to bf16: G2's expression and
// rounding), each element once a block, and release it to the computing
// warps on a third mbarrier, so the MMA loop is G1's; at 8 rows each
// computing warp normalizes its own B fragments after ldmatrix.
// Measured on the H100 on the way (kernel_ab.py norm): B fragments
// normalized in registers at every row count (the 4 column warps
// repeating it) made a call 1.5-5x slower at 64 and 128 rows; the slice
// normalized by the computing warps themselves cost 25-40% at 128 rows;
// the gains read from global memory a slice at a time cost up to 60%.
// Rows past M and columns past K are left as the zeros the TMA box lands
// there.  The float32 kernel normalizes x as it fills its tile.  gamma is
// read in its own dtype (bf16 or float32) and converted in the kernel,
// exactly: no cast is launched.
//
// G3 and G4, the weight-only quantized forms (the reference's
// wq_matmul_i8 and wq_matmul_i4, mxtpu/contrib/quantization.py, which XLA
// ran with no Pallas kernel): G1's kernel with the weight type as a
// template parameter WT.  int8 (G3): w (N, K) int8 with one float32 scale
// a channel, y = (x @ w^T) * s.  int4 (G4): w (N, K/2) bytes, two
// weights a byte (k even in the low nibble), one float32 scale a channel
// and group of gs k, y = sum over groups g in k order of
// (x_g @ w_g^T) * s[:, g].  Bias (float32) is added after the scale.
// What bounds them: the weight bytes again, now half (int8) or a quarter
// plus the scales (int4) of bf16's, so the instructions a weight byte
// costs (its shared load, its conversion to bf16) and the latency of a
// block's walk decide the time at the decode step's 8 rows.  The design
// is G1's, with these differences:
// - The weights land by TMA in 64-deep slices of 64 (int8) or 32 (int4)
//   bytes a row, not swizzled, and are turned into bf16 in registers
//   (exactly: an int8 or int4 value is a bf16, and a bf16 x bf16 product
//   is exact in float32); a float copy of the weight never exists.
// - A lane owns a run of k inside each U-deep block of a slice (U = 64
//   for int8 and for int4 groups of a multiple of 64; else 32 or 16, a
//   divisor of gs, so k never leaves its group): one 16-byte (int8) or
//   8-byte (int4) shared load a row gives it its weights for all four
//   k16 steps of a slice, a half warp reading 128 consecutive bytes.
//   Step s of lane t takes k kb .. kb + 3 (the MMA's k 2t, 2t + 1 and
//   2t + 8, 2t + 9), kb = 16t + 4s at U = 64; x's B fragments are read
//   in the same order, one 16-byte chunk of x's row giving two steps.
//   The MMA sums the same products.  Conversion: int8 through float32
//   (bytes into 2^23 + u by prmt, a subtraction, the float's upper half
//   by prmt); int4 a pair a prmt, a lop3 and a bf16 subtraction (two
//   nibbles under the bf16 exponent of 128 with the sign bit flipped:
//   128 + w + 8, then 136 off).
// - int4's scales reach shared memory with the slices, so a computing
//   warp reads them there at each group's end and never waits on device
//   memory in its walk: up to 32 rows a block's scales of its whole
//   split land by one TMA box with the first stage (where the split's
//   groups are a multiple of 4 and fit 16 KiB: every 8B projection at
//   group 64); otherwise the producer warp's 32 lanes copy the scales
//   of the groups that end in a slice into its stage (cp.async, tracked
//   by the stage's mbarrier).  Measured at 8 rows: those per-lane copies
//   cost 10-15% against none at all, and the TMA box took G4 from
//   0.72-0.86 to 0.66-0.81 of the time of the kernel before this design
//   (16-bit loads of four nibbles, scales read from device memory).
// - int8: the splits are whole 64-deep slices (K's last slice is zero
//   past K); their float32 partials are added in split order, then
//   multiplied by the channel's scale once and rounded once.
// - int4: the K splits cover whole groups (splits(N, K) halved while it
//   exceeds the K / gs groups: a function of N, K and gs), and each
//   group's k16 steps accumulate into a fresh float32 fragment, which is
//   multiplied by s[n, g] and added to the split's running sum.
// - The classes keep both sets of accumulators in registers with no
//   spill: a block of one row of computing warps (5 warps) may use 255
//   registers a thread, one of two rows (9 warps) 168.  int8's 128 rows
//   take 128 columns, or 192 where that grid fits one wave (as bf16's);
//   int4 has no 128-row class: above 64 rows its 64-row blocks walk the
//   rows in chunks (the grid's z), each reading the weights again (from
//   L2 while the grid's chunks run together).  Above 8 rows x's B
//   fragments are loaded a step at a time (8 bytes a lane), which keeps
//   the 64-row int4 class at three blocks an SM.
// Nothing changes for M: the plan's splits, k ranges and groups are
// functions of N, K and gs alone, so a row rounds alike at any row count.
// Measured on the H100 on the way (kernel_ab.py quant, and quant-tree
// turns over variant trees of the class tables), and dropped:
// - int4's 64-row class with two A tiles a warp (128 accumulators,
//   200-220 registers, one block an SM): 1.4-2.4x the one-tile class.
// - x's B fragments of both steps of a pair held at once at 64 rows (one
//   16-byte load): 140 registers, two blocks an SM instead of three,
//   1.3-1.9x; above 8 rows a step's 8 bytes are loaded at a time.
// - The groups' loop outside the steps' (a group's two MMAs back to
//   back, fewer registers): 1.4-1.8x at 64 and 128 rows, the same with
//   plain C++ shared loads or a non-volatile mma.
// - int4 splits up to 8 (clusters of 8): down at 128 rows 10% faster,
//   out_proj at 8 and 64 rows 7-20% slower; int8 splits up to 8: 12-27%
//   faster at 64 rows on N = 4096, 13-36% slower at 128.
// - Two 64-deep slices a stage at 8 rows (more bytes a barrier round
//   trip): lm_head 5% faster, the others up to 20% slower (128-deep
//   int4 slices in the kernel before had read 0.89-1.28x).
// - The fused norm's row scales with all of a 4096-element row's loads
//   in flight: ptxas spilled 8-12 bytes for occupancy; pinning one block
//   an SM (__launch_bounds__ minimum 1) kept them at 1.2-1.6x the time.
// - The tensor maps' descriptors prefetched (prefetch.tensormap) while
//   the barriers are set up: no change.  Kept: the split-K epilogue
//   loads every split's partial before the first sum (3-10% on G4 and
//   G3, out_proj at 8 rows 0.0191 to 0.0180 ms).
// The float32 kernel takes the same weight types, converting each weight
// as it fills its tile.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "paged_common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using mxtpu_port::bulk_copy;
using mxtpu_port::kMaxSmem;
using mxtpu_port::mbar_expect;
using mxtpu_port::mbar_init;
using mxtpu_port::mbar_wait;

constexpr int kChunk = 128;        // x rows a block holds, at most
constexpr int kWarpCols = 4;       // computing warps across the N tile
constexpr int kBK = 64;            // K slice: one 128-byte swizzled row
constexpr int kMaxSplits = 4;      // blocks a cluster
constexpr int kSplitTarget = 264;  // blocks the splits aim for at 64-column
                                   // tiles (two an SM on 132 SMs)
constexpr int kMinSplitSteps = 16; // k16 steps a split walks, at least
constexpr int kMaxStages = 8;      // ring stages a block may hold
constexpr int kHead = 2048;        // mbarriers, and the ring's alignment
constexpr int kPartPad = 4;        // float padding of a partial-sum row
// The head of the bf16 kernel's shared memory: the stages' mbarriers (a
// slice landed, normalized, released), the scales of the chunk's rows
// (the fused norm), then the ring from the next 1024-byte boundary.
constexpr int kScalesEnd = 3 * kMaxStages * 8 + kChunk * 4;
static_assert(kScalesEnd + 1023 <= kHead,
              "the head holds the barriers, the scales and the alignment");
// Blocks a cluster of the fused norm, which deals the chunk's rows over
// them: the splits of P / S N tiles.  Four, but two for single-split
// projections (lm_head), whose blocks need no cluster of their own: on
// the H100 clusters of 4 there cost 2-3% at 8 rows and 20% at 128 (a
// wave more at one block an SM), and no cluster at all (every block
// reducing all its rows) cost more than 2.
constexpr int kNormCluster = 4;
static_assert(kNormCluster % kMaxSplits == 0, "S divides the cluster");
inline int norm_cluster(int S) { return S == 1 ? 2 : kNormCluster; }
// Warps of a fused block that normalize the landed x slices (8 rows
// apart a thread, kChunk / 8 rows at most), beside the computing warps
// and the producer, in the classes of more than 8 rows.  More of them
// cost more than they gave on the H100: at 64 rows 4 such warps left
// room for one block an SM, not two.  In the 8-row class (NGW = 1) each
// computing warp normalizes its own B fragments in registers instead:
// 2 words a k16 step, where a hand-off to other warps cost 6% of
// lm_head's call.
constexpr int kNormWarps = 2;
constexpr int kNormRows = kChunk / (kNormWarps * 32 / 8);
// The fused norm's gains of one slice (64 float32 at most), a slot a
// stage after the ring, filled by the producer with the slice.
constexpr int kGainSlot = kBK * 4;

// Weight types of the bf16 kernel (and of the float32 kernel, where
// kWFloat is x's float32): bf16 (G1), int8 (G3), int4 two a byte (G4).
constexpr int kWFloat = 0, kWI8 = 1, kWI4 = 2;
// bytes of a weight row's 64-deep slice in a stage
__host__ __device__ constexpr int wrow_bytes(int WT) {
  return (kBK * 2) >> WT;
}
// int4's scale slots a stage: the groups that end in its slice, at most
// 4 (gs >= 16), each BN float32 scales
__host__ __device__ constexpr int scale_slots(int WT) {
  return WT == kWI4 ? 4 : 0;
}
// int4's scale area: in the classes of up to 32 rows, a block's scales of
// its whole split (BN columns by the split's groups, a multiple of 4 so
// that a row of them is whole 16-byte units) land by one TMA box with the
// first stage, where they fit kScaleArea bytes; otherwise (0 bytes) the
// producer's lanes copy each slice's into its stage's slots.  (In the
// 64-row class the area cost a block an SM, and down and lm_head 7-21%.)
constexpr int kScaleArea = 16384;
__host__ __device__ inline int scale_area_bytes(int WT, int K, int S, int gs,
                                                int BN, int rows) {
  if (WT != kWI4 || rows > 32 || (K / gs) % (4 * S)) return 0;
  const int bytes = BN * (K / gs / S) * 4;
  return bytes <= kScaleArea ? bytes : 0;
}

// K splits of a (N, K) bf16 product: a function of N and K alone.  The
// S splits of one 64-column tile double while the grid holds fewer than
// kSplitTarget blocks and each split keeps kMinSplitSteps k16 steps.
__host__ __device__ inline int splits(int N, int K) {
  const int tiles = (N + 63) / 64;
  const int steps = (K + 15) / 16;
  int s = 1;
  while (s < kMaxSplits && tiles * s < kSplitTarget &&
         steps >= 2 * s * kMinSplitSteps)
    s *= 2;
  return s;
}

// The splits of weight type WT: bf16's and int8's are splits(N, K); an
// int4 split covers whole groups of gs, so splits(N, K) is halved while
// it exceeds the K / gs groups.
__host__ __device__ inline int wt_splits(int WT, int N, int K, int gs) {
  int s = splits(N, K);
  if (WT == kWI4)
    while (s > K / gs) s /= 2;
  return s;
}

// The k16 steps [*lo, *hi) that split `split` of S walks, in order.
__host__ __device__ inline void k_range(int K, int S, int split, int* lo,
                                        int* hi) {
  const int steps = (K + 15) / 16;
  *lo = split * steps / S;
  *hi = (split + 1) * steps / S;
}

// The K range [*kbeg, *kend) that split `split` of S walks: k_range's
// k16 steps (the last cut at K); for int8 whole 64-deep slices (the last
// cut at K), so every slice but K's last is whole; for int4 the split's
// whole groups.
__host__ __device__ inline void k_span(int WT, int K, int S, int gs,
                                       int split, int* kbeg, int* kend) {
  if (WT == kWI4) {
    const int groups = K / gs;
    *kbeg = gs * (split * groups / S);
    *kend = gs * ((split + 1) * groups / S);
  } else if (WT == kWI8) {
    const int slices = (K + kBK - 1) / kBK;
    *kbeg = kBK * (split * slices / S);
    const int end = kBK * ((split + 1) * slices / S);
    *kend = end < K ? end : K;
  } else {
    int lo, hi;
    k_range(K, S, split, &lo, &hi);
    *kbeg = 16 * lo;
    *kend = 16 * hi < K ? 16 * hi : K;
  }
}

// A row class: the rows a block holds, a computing warp's 16-column A
// tiles (CW) and 8-row B groups (NGW), the computing warps across the
// rows, and the ring's stages.  A block runs 4 * warp_rows computing
// warps and one producer warp.  128 rows take 256-column tiles, or 192
// where that grid fits one wave (the last class).  One table a weight
// type: int8's stages hold about bf16's ring bytes; int4 keeps a second
// set of accumulators (a group's), so its 64- and 128-row classes take
// half the A tiles, and it has no 192-column class.
struct RowClass {
  int rows, cw, ngw, warp_rows, stages;
};
constexpr RowClass kBf16Classes[] = {{8, 1, 1, 1, 4}, {32, 1, 4, 1, 4},
                                     {64, 2, 8, 1, 3}, {128, 4, 8, 2, 4},
                                     {128, 3, 8, 2, 5}};
// The quantized forms' classes hold both accumulator sets (int4) in
// registers with no spill: a block of one row of computing warps (5
// warps) may use 255 registers a thread, one of two rows (9 warps) 168.
// int8's 128 rows take 128-column tiles, or 192 where that grid fits one
// wave (as bf16's); int4 has no 128-row class: above 64 rows the 64-row
// blocks walk the rows in chunks (the grid's z).
constexpr RowClass kI8Classes[] = {{8, 1, 1, 1, 8}, {32, 1, 4, 1, 6},
                                   {64, 2, 8, 1, 4}, {128, 2, 8, 2, 8},
                                   {128, 3, 8, 2, 7}};
constexpr RowClass kI4Classes[] = {{8, 1, 1, 1, 8}, {32, 1, 4, 1, 8},
                                   {64, 1, 8, 1, 6}};
// Weight type WT's classes: how many, and class c.
constexpr int num_classes(int WT) {
  return WT == kWI4 ? 3 : 5;
}
constexpr RowClass row_classes(int WT, int c) {
  return WT == kWI4 ? kI4Classes[c] : WT == kWI8 ? kI8Classes[c]
                                                 : kBf16Classes[c];
}
// Blocks of one block an SM that fit the H100 at once in clusters of 4
// (30 such clusters); a grid a few blocks past it runs a second wave.
constexpr int kOneWave = 120;

// The class of M rows: the first that holds min(M, 128) rows (the last
// one if none does), and for bf16 and int8 at 128 rows the 192-column
// class where that grid fits one wave.
inline int row_class(int M, int N, int K, int WT = kWFloat) {
  const int m = M < kChunk ? M : kChunk;
  const int by_rows = num_classes(WT) > 4 ? 4 : num_classes(WT);
  int c = 0;
  while (c + 1 < by_rows && row_classes(WT, c).rows < m) ++c;
  if (c == 3 && num_classes(WT) > 4 &&
      (N + 191) / 192 * wt_splits(WT, N, K, 0) <= kOneWave)
    c = 4;
  return c;
}

// A ring stage's bytes: the slice of the weight tile, of the x rows,
// then int4's scale slots.
inline int stage_bytes_of(const RowClass& c, int WT) {
  const int bn = 16 * kWarpCols * c.cw;
  return bn * wrow_bytes(WT) + c.rows * kBK * 2 + scale_slots(WT) * bn * 4;
}

// Shared memory of one block, as the kernel carves it: the stages'
// mbarriers (and the fused norm's row scales), then (1024-byte aligned,
// for the 128-byte swizzle) the ring of weight tiles and x rows, which
// the float32 partial tile reuses after the walk, then the fused norm's
// gain slots, then int4's scale area.
inline size_t smem_bytes(const RowClass& c, int stages, bool norm,
                         int WT = kWFloat, int K = 0, int S = 1,
                         int gs = 0) {
  const int bn = 16 * kWarpCols * c.cw;
  const size_t ring = (size_t)stages * stage_bytes_of(c, WT);
  const size_t part = (size_t)c.rows * (bn + kPartPad) * 4;
  return kHead + (ring > part ? ring : part) +
         (norm ? (size_t)stages * kGainSlot : 0) +
         scale_area_bytes(WT, K, S, gs, bn, c.rows);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices: lane i gives the row address of matrix i/8,
// row i%8; lane (g, t) receives row g, columns 2t and 2t+1 of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
// two of them, from the row addresses of lanes 0-15
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(a)
      : "memory");
}

// d += a.b, one m16n8k16 bf16 product with float32 sums.  Lane (g, t)
// holds a = A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// b = B[2t..2t+1][g], B[2t+8..2t+9][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].  Here A is the weight tile (row = output
// column), B[k][r] = x[r][k] (column = x row).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A box of a 2-D tensor map (coordinates: k, then row) into shared
// memory by the TMA engine, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int k, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the cluster's barrier in two halves, so a warp can arrive early and wait
// late (the producer arrives before it starts the ring)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
struct NoNorm {};  // the gain type of a plain G1 launch

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// elements e .. e + 7 of a row, as raw 16-byte words (one for bf16,
// two for float; 16-byte aligned), and as floats
template <typename T>
struct Raw8 {
  uint4 w[sizeof(T) / 2];
};
template <typename T>
__device__ __forceinline__ Raw8<T> load_raw8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)sizeof(T) / 2; ++i)
    r.w[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}
__device__ __forceinline__ void unpack8(const Raw8<bf16>& r, float (&v)[8]) {
  const uint32_t w[4] = {r.w[0].x, r.w[0].y, r.w[0].z, r.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack8(const Raw8<float>& r, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[4 * i] = __uint_as_float(r.w[i].x);
    v[4 * i + 1] = __uint_as_float(r.w[i].y);
    v[4 * i + 2] = __uint_as_float(r.w[i].z);
    v[4 * i + 3] = __uint_as_float(r.w[i].w);
  }
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  unpack8(load_raw8(p), v);
}

// The scale rsqrt(mean(x * x) + eps) of one row of C elements, computed
// by one warp (every lane returns it): G2's and the fused norm's, so the
// two agree by construction.  The order of the sums depends on C alone,
// and is that of 256 threads each summing the squares of elements u,
// u + 256, u + 512, ... (thread u) in order with fmaf, each warp of 32
// adding its threads' sums by an xor butterfly 16, 8, 4, 2, 1, and the 8
// warp sums added in order.  Lane l holds the chains of threads 8l ..
// 8l + 7, so one 16-byte load (two for float) feeds all eight: thread
// u = 8l + j is lane (l % 4) and chain j of warp l / 4, the butterfly's
// steps 16 and 8 are shuffles (lane xor 2, xor 1), its steps 4, 2 and 1
// adds inside the lane, and warp w's sum lands on lanes 4w .. 4w + 3.
// Past C a chain adds nothing (+0 to a sum of squares).  B rows of 16
// bytes a lane are loaded before their first sum (how many loads are in
// flight; the order of the sums does not depend on it).
template <int B, typename T>
__device__ __forceinline__ float row_scale_inline(const T* __restrict__ xr,
                                                  int C, float eps,
                                                  int lane) {
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (C % 8 == 0 && (reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
    for (int e0 = 8 * lane; e0 < C; e0 += 256 * B) {
      Raw8<T> raw[B];
#pragma unroll
      for (int b = 0; b < B; ++b)
        if (e0 + 256 * b < C) raw[b] = load_raw8(xr + e0 + 256 * b);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (e0 + 256 * b < C) {
          float v[8];
          unpack8(raw[b], v);
#pragma unroll
          for (int j = 0; j < 8; ++j) s[j] = fmaf(v[j], v[j], s[j]);
        }
      }
    }
  } else {
    for (int e = 8 * lane; e < C; e += 256) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = e + j < C ? to_float(xr[e + j]) : 0.f;
        s[j] = fmaf(v, v, s[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
  const float warp_sum =
      ((s[0] + s[4]) + (s[2] + s[6])) + ((s[1] + s[5]) + (s[3] + s[7]));
  float total = __shfl_sync(0xffffffffu, warp_sum, 0);
#pragma unroll
  for (int w = 1; w < 8; ++w)
    total += __shfl_sync(0xffffffffu, warp_sum, 4 * w);
  return rsqrtf(total / C + eps);
}

// G2's and G1's call of it, 256 bytes a lane in flight (a 4096-element
// bf16 row at once); the quantized forms inline it with fewer
template <typename T>
__device__ float row_scale(const T* __restrict__ xr, int C, float eps,
                           int lane) {
  return row_scale_inline<(int)(32 / sizeof(T))>(xr, C, eps, lane);
}

// 8 bf16 x values of one row in shared memory, normalized in place as G2
// writes them: (x * r) * gamma, rounded to bf16
__device__ __forceinline__ void norm8(unsigned char* p, float r,
                                      const float (&g)[8]) {
  uint4* q = reinterpret_cast<uint4*>(p);
  float v[8];
  load8(reinterpret_cast<const bf16*>(q), v);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 o = __floats2bfloat162_rn(v[2 * i] * r * g[2 * i],
                                             v[2 * i + 1] * r * g[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&o);
  }
  *q = make_uint4(w[0], w[1], w[2], w[3]);
}

// gamma[k], gamma[k + 1] as floats, from a gain slot
__device__ __forceinline__ float2 gain2(const bf16* g) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g));
}
__device__ __forceinline__ float2 gain2(const float* g) {
  return *reinterpret_cast<const float2*>(g);
}

// a B fragment's two x values (k, k + 1 of one row), normalized as G2
// writes them: (x * r) * gamma, rounded to bf16
__device__ __forceinline__ uint32_t norm2(uint32_t b, float r, float2 gm) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  __nv_bfloat162 o = __floats2bfloat162_rn(v.x * r * gm.x, v.y * r * gm.y);
  return *reinterpret_cast<uint32_t*>(&o);
}

// generic-proxy writes to shared memory ordered before later TMA writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2, 4, 8 and 16 bytes of shared memory (the quantized forms' fragments
// and scales)
__device__ __forceinline__ uint32_t lds_u16(unsigned a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t lds_u32(unsigned a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void lds_u64(uint32_t& lo, uint32_t& hi,
                                        unsigned a) {
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(lo), "=r"(hi)
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void lds_u128(uint32_t (&r)[4], unsigned a) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// 4 bytes from global to shared memory by cp.async, and an arrival on
// `bar` once all of the thread's earlier cp.async copies have landed
// (counted among the barrier's expected arrivals: .noinc)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// four int8 weights (the bytes of w, k ascending) as two bf16 pairs, lo =
// (k0, k1) and hi = (k2, k3), exactly: byte u = w + 128 goes into the
// mantissa of 2^23 (the float 2^23 + u), 2^23 + 128 is subtracted, and
// the float's upper half is the bf16 (an integer of 8 significant bits)
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kMagic = 8388736.f;  // 2^23 + 128
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kMagic;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kMagic;
  const float f2 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kMagic;
  const float f3 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kMagic;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// int4 weights 2p and 2p + 1 of the eight nibbles of w (k ascending; v =
// w >> 4) as one bf16 pair, exactly: byte p of w and of v go into the
// pair's two halves, whose low nibbles n are kept and flipped to
// u = n ^ 8 = weight + 8 under the bf16 exponent of 128 (one lop3:
// (t & 0x000F000F) ^ 0x43084308, the bf16 128 + u), and 136 is subtracted
template <int P>
__device__ __forceinline__ uint32_t i4_pair(uint32_t w, uint32_t v) {
  const uint32_t t =
      __byte_perm(w, v, P | (P << 4) | ((4 + P) << 8) | ((4 + P) << 12));
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n"
      : "=r"(r)
      : "r"(t), "r"(0x000F000Fu), "r"(0x43084308u));
  const uint32_t off = 0x43084308u;  // (136, 136)
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<uint32_t*>(&d);
}

// G3's q8 epilogue: the last nv columns of y, heads of hd columns, leave
// the launch as the int8 KV cache stores them, an int8 payload vq (M, nv)
// and a float32 scale a row and head vs (M, nv / hd), with the bits of
// _q8_quantize (ops/tensor.py) applied to the y that G3 rounds.  A null
// vq launches plain G3.  counters holds one int a row chunk and head,
// zero between launches; the launch's last arriving block resets it.
struct Q8Out {
  int8_t* vq;
  float* vs;
  int* counters;
  int nv, hd;
};

__device__ __forceinline__ float load_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_l2(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// x / y rounded to float as IEEE division rounds it (div.rn.f32), with no
// call: ptxas expands a division into a fast path and a call to its slow
// path, and the call left it spilling 4-12 bytes in the G3 kernels that
// carry the epilogue below.  Here in double: a reciprocal of y refined by
// three Newton steps from the hardware's estimate (each step doubles its
// bits), x times it, the product's exact residual x - q * y (one FMA) and
// one correction: the result is within 2^-52 of x / y, relative.  A
// quotient of two floats is a float midpoint or lies 2^-50 or more from
// every midpoint, relative, so rounding the double to float gives the
// float quotient's bits, ties included.  y is normal and positive here
// (the scale floor is 1e-8 / 127).
__device__ __forceinline__ double q8_rcp(double y) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(y));
#pragma unroll
  for (int i = 0; i < 3; ++i) r = fma(r, fma(-y, r, 1.0), r);
  return r;
}
__device__ __forceinline__ float q8_div(float x, double y, double ry) {
  const double q = (double)x * ry;
  return __double2float_rn(fma(fma(-q, y, (double)x), ry, q));
}

// The epilogue of one block, after it stored its share of output columns
// [c_lo, c_hi) of rows [r0, r0 + nrows) (row chunk `chunk`) to y, every
// thread of the block calling.  A head spans several tiles of tile_w
// columns, each written by per_tile blocks (the K splits share a tile's
// rows out): every block that wrote a column of the head arrives on the
// head's counter after a fence, and the last to arrive reads the head's
// rounded values back from L2 and quantizes them, a warp a row with all
// its loads in flight: amax over the head's columns (exact in any order),
// s = max(amax, 1e-8) / 127 and q = round-half-even(v / s), both
// divisions with IEEE's bits (q8_div), clamped to +-127.  The rows' y
// columns stay written (they are the epilogue's staging).  The block
// learns that it arrived last by __syncthreads_or, so the epilogue holds
// nothing of the kernel's shared memory.  It is a function of its own, not
// inlined: inlined, ptxas's allocation of an 8-row int8 class spilled 4
// bytes (ptxas -v on the H100); called, neither the kernels nor it spill.
constexpr int kQ8PerLane = 8;  // a lane's values of a head: head_dim <= 256
template <typename T>
__device__ __noinline__ void q8_epilogue(const Q8Out q8, const T* y, int N,
                                        int c_lo, int c_hi, int tile_w,
                                        int per_tile, int chunk, int r0,
                                        int nrows) {
  const int vbeg = N - q8.nv;
  const int lo = max(c_lo, vbeg);
  const int hi = min(c_hi, N);
  if (lo >= hi) return;  // no V column in this block's tile
  const int heads = q8.nv / q8.hd;
  const int lane = threadIdx.x & 31;
  __threadfence();
  __syncthreads();
#pragma unroll 1
  for (int h = (lo - vbeg) / q8.hd; h < heads && vbeg + h * q8.hd < hi;
       ++h) {
    const int c0 = vbeg + h * q8.hd;
    const int arrivals =
        ((c0 + q8.hd - 1) / tile_w - c0 / tile_w + 1) * per_tile;
    int* ctr = q8.counters + (size_t)chunk * heads + h;
    const int first = threadIdx.x == 0 ? atomicAdd(ctr, 1) : 0;
    if (!__syncthreads_or(threadIdx.x == 0 && first == arrivals - 1))
      continue;
    __threadfence();
#pragma unroll 1
    for (int r = threadIdx.x >> 5; r < nrows; r += blockDim.x >> 5) {
      const T* src = y + (size_t)(r0 + r) * N + c0;
      float v[kQ8PerLane];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < kQ8PerLane; ++i) {
        v[i] = lane + 32 * i < q8.hd ? load_l2(src + lane + 32 * i) : 0.f;
        amax = fmaxf(amax, fabsf(v[i]));
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float s = q8_div(fmaxf(amax, 1e-8f), 127.0, 1.0 / 127.0);
      const double sd = s;
      const double rs = q8_rcp(sd);
      int8_t* dst = q8.vq + (size_t)(r0 + r) * q8.nv + h * q8.hd;
#pragma unroll
      for (int i = 0; i < kQ8PerLane; ++i) {
        if (lane + 32 * i < q8.hd) {
          const float q = rintf(q8_div(v[i], sd, rs));
          dst[lane + 32 * i] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
        }
      }
      if (lane == 0) q8.vs[(size_t)(r0 + r) * heads + h] = s;
    }
    if (threadIdx.x == 0) *ctr = 0;  // for the next launch
  }
}

// The threads of a bf16-kernel block: G1's launch bounds are those of its
// widest classes (288, or 352 with the fused norm's normalizing warps);
// the quantized forms' are their class's own (4 * WR computing warps, the
// producer, and the normalizing warps), so a block of one row of
// computing warps may use 255 registers a thread.
__host__ __device__ constexpr int block_threads(int WT, int NGW, int WR,
                                                bool norm) {
  return WT == kWFloat
             ? (!norm || NGW == 1 ? 288 : 288 + 32 * kNormWarps)
             : 32 * (kWarpCols * WR + 1 + (norm && NGW > 1 ? kNormWarps : 0));
}

// One block: output columns [n0, n0 + BN) of rows [m0, m0 + rows), over
// the K range of split blockIdx.x % S (k_span).  Warps 0 ..
// 4*warp_rows - 1 compute: warp w owns the 16*CW columns (w % 4) and the
// 8*NGW rows (w / 4) of the tile.  The next warp produces: it loads slice
// i (a 64-deep box of the weight tile and one of the chunk's x rows, both
// through tensor maps, x's with the 128-byte swizzle; rows past N or M
// and columns past K land as zeros) into stage i % STAGES once the
// computing warps have released the stage (and int4's producer copies
// the scales of the groups that end in the slice beside it).  The S splits of an N tile are consecutive blocks of a cluster
// of P (P = S, or norm_cluster with the fused norm, whose grid is padded
// to whole clusters: a block past the last N tile loads and stores
// nothing).
//
// WT is the weight type (kWFloat: bf16, kWI8, kWI4 with wscale (N, K /
// gs)); the quantized forms scale (and add bias, float32, unless null) in
// the epilogue or, int4, at each group's end.  WR is the quantized forms'
// rows of computing warps (G1 reads warp_rows).
//
// G (NoNorm, bf16 or float) is the gain's type.  With a gain the
// producer also copies each slice's gains into the stage's gain slot,
// and above 8 rows kNormWarps more warps normalize each landed x slice
// in place before the computing warps read it (a third mbarrier a
// stage; at 8 rows the computing warps normalize their B fragments).
// Row r of the chunk is first reduced (row_scale) by cluster block
// r % P, by one of its warps, and its scale is shared with the cluster
// over distributed shared memory.
template <int WT, int CW, int NGW, int STAGES, int WR, typename G>
__global__ void __launch_bounds__(
    block_threads(WT, NGW, WR, !std::is_same<G, NoNorm>::value))
    rows_linear_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap smap,
                            const bf16* __restrict__ x,
                            const G* __restrict__ gamma, float eps,
                            const float* __restrict__ wscale,
                            const float* __restrict__ bias,
                            bf16* __restrict__ y, int M, int N, int K,
                            int S, int P, int warp_rows, int gs,
                            const Q8Out q8) {
  static_assert(STAGES <= kMaxStages, "the head holds kMaxStages barriers");
  constexpr bool kNorm = !std::is_same<G, NoNorm>::value;
  constexpr bool kNormWarpsOn = kNorm && NGW > 1;  // else in registers
  constexpr int BN = 16 * kWarpCols * CW;
  constexpr int PLD = BN + kPartPad;
  constexpr int WB = wrow_bytes(WT);  // a weight row's bytes in a stage
  constexpr int SQ = scale_slots(WT);
  extern __shared__ uint4 smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  uint64_t* normed = empty + kMaxStages;
  float* scales = reinterpret_cast<float*>(normed + kMaxStages);
  const unsigned base = smem_addr(smem_raw);
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem_raw) +
                        (((base + kScalesEnd + 1023) & ~1023u) - base);
  const int wrows = WT == kWFloat ? warp_rows : WR;
  const int R = 8 * NGW * wrows;
  // a stage: the weight box, the x box, then int4's scale slots
  const int xoff = BN * WB;
  const int soff = BN * WB + R * kBK * 2;
  const int stage_bytes = soff + SQ * BN * 4;
  const int ring_bytes = max(STAGES * stage_bytes, R * PLD * 4);
  unsigned char* gslots = ring + ring_bytes;
  // int4's scale area (128-byte aligned), if its split's scales fit one
  const int sarea_bytes = scale_area_bytes(WT, K, S, gs, BN, R);
  unsigned char* sarea = gslots + (kNorm ? STAGES * kGainSlot : 0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cwarps = kWarpCols * wrows;  // computing warps
  const int nnw = kNormWarpsOn ? kNormWarps : 0;  // normalizing warps
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wcol = warp % kWarpCols;
  const int grp0 = warp / kWarpCols * NGW;  // the warp's first 8-row group
  const int split = blockIdx.x % S;
  const int rank = blockIdx.x % P;           // in the cluster
  const int n0 = blockIdx.x / S * BN;
  const int m0 = blockIdx.z * R;
  const int rows = min(R, M - m0);
  const int groups = (rows + 7) / 8;        // 8-row groups holding a row
  const int ncols = min(BN, N - n0);
  int kbeg, kend;
  k_span(WT, K, S, gs, split, &kbeg, &kend);
  const int nslices =
      kend > kbeg && n0 < N ? (kend - kbeg + kBK - 1) / kBK : 0;
  cg::cluster_group cluster = cg::this_cluster();

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      // int4 without a scale area: the producer's 32 lanes also arrive,
      // as their scales land
      mbar_init(&full[st], WT == kWI4 && !sarea_bytes ? 33 : 1);
      mbar_init(&empty[st], cwarps);
      if (nnw) mbar_init(&normed[st], nnw);
    }
  }
  __syncthreads();

  // With the fused norm a cluster passes two barriers before the
  // epilogue: the scales are written (phase 0), and read (phase 1, after
  // which a block may leave; the producer arrives at both at once).  A
  // block of no cluster (P = 1) would sync its reducing warps on barrier
  // 1: norm_cluster() does not ask for one, but with that path in the
  // kernel nvcc lays the 64-row class out 1.5x faster on the H100
  // (kernel_ab.py norm's kernel_us, qkv at M = 64: 35 against 52 us).
  const bool clustered = kNorm && P > 1;
  if constexpr (kNorm) {
    if (warp != cwarps) {
      // the chunk's rows dealt over the cluster's blocks, and in each
      // over its computing and normalizing warps
      const int nw = cwarps + nnw;
      const int w = warp < cwarps ? warp : warp - 1;
      for (int r = rank + P * w; r < rows; r += P * nw) {
        const bf16* xr = x + (size_t)(m0 + r) * K;
        float v;
        if constexpr (WT == kWFloat) {
          v = row_scale(xr, K, eps, lane);
        } else {
          // inlined (a call spilled the registers live across it), with
          // 128 bytes a lane in flight at 8 rows and 64 above: all 256
          // left ptxas spilling 8-12 bytes for occupancy, and pinning one
          // block an SM instead to keep them cost 20-60%
          v = row_scale_inline<NGW == 1 ? 8 : 4>(xr, K, eps, lane);
        }
        if (lane == 0) scales[r] = v;
      }
      if (clustered) {
        cluster_arrive();
        cluster_wait();
      } else {
        asm volatile("bar.sync 1, %0;\n" ::"r"(32 * nw) : "memory");
      }
    }
  }

  float acc[CW][NGW][4];
  if (warp == cwarps) {
    if (clustered) cluster_arrive_relaxed();
    if constexpr (WT == kWFloat) {
      if (lane == 0) {
        for (int i = 0; i < nslices; ++i) {
          const int st = i % STAGES;
          const int k0 = kbeg + i * kBK;
          // the gains of the slice's columns up to the split's end
          const int gbytes =
              kNorm ? min(kBK, kend - k0) * (int)sizeof(G) : 0;
          if (i >= STAGES) mbar_wait(&empty[st], (i / STAGES - 1) & 1);
          unsigned char* ws = ring + (size_t)st * stage_bytes;
          mbar_expect(&full[st], stage_bytes + gbytes);
          tma_load(ws, &wmap, k0, n0, &full[st]);
          tma_load(ws + BN * WB, &xmap, k0, m0, &full[st]);
          if constexpr (kNorm)
            bulk_copy(gslots + st * kGainSlot, gamma + k0, gbytes, &full[st]);
        }
      }
    } else if ((WT == kWI4 && !sarea_bytes) || lane == 0) {
      // the quantized forms: lane 0 loads the slices as G1's producer
      // does, and int4's scale area with the first; without one, int4's
      // 32 lanes copy the scales of the groups that end in a slice into
      // its stage's slots (group j at slot j % SQ, BN columns, rows past
      // N reading row N - 1's)
      const int ngroups = WT == kWI4 ? K / gs : 0;
      for (int i = 0; i < nslices; ++i) {
        const int st = i % STAGES;
        const int k0 = kbeg + i * kBK;
        const int gbytes = kNorm ? min(kBK, kend - k0) * (int)sizeof(G) : 0;
        if (i >= STAGES) mbar_wait(&empty[st], (i / STAGES - 1) & 1);
        unsigned char* ws = ring + (size_t)st * stage_bytes;
        if (lane == 0) {
          mbar_expect(&full[st], soff + gbytes + (i == 0 ? sarea_bytes : 0));
          // the weight map's columns are bytes
          tma_load(ws, &wmap, WT == kWI4 ? k0 / 2 : k0, n0, &full[st]);
          tma_load(ws + xoff, &xmap, k0, m0, &full[st]);
          if constexpr (kNorm)
            bulk_copy(gslots + st * kGainSlot, gamma + k0, gbytes, &full[st]);
          // the scale map's coordinates: group, then column (past N zeros)
          if (i == 0 && sarea_bytes)
            tma_load(sarea, &smap, kbeg / gs, n0, &full[st]);
        }
        if constexpr (WT == kWI4) {
          if (!sarea_bytes) {
            // groups [g_lo, g_hi) end in (k0, k1]
            const int k1 = min(k0 + kBK, kend);
            const int g_lo = k0 / gs;
            const int items = (k1 / gs - g_lo) * BN;
            float* slot = reinterpret_cast<float*>(ws + soff);
            for (int it = lane; it < items; it += 32) {
              const int grp = g_lo + it / BN;
              const int col = it % BN;
              const int n = min(n0 + col, N - 1);
              cp_async4(slot + (grp % SQ) * BN + col,
                        wscale + (size_t)n * ngroups + grp);
            }
            cp_async_arrive(&full[st]);
          }
        }
      }
    }
    if (clustered) {
      cluster_wait();
      cluster_arrive_relaxed();
    }
  } else if (warp > cwarps) {
    if constexpr (kNormWarpsOn) {
      // normalize each landed slice: thread u takes 16-byte chunk u % 8
      // of rows u / 8, u / 8 + 8, ... of the slice's x rows (each row's
      // chunk at the same swizzled place, so one set of gains); chunks
      // past the split's end are left as they are
      const int u = tid - 32 * (cwarps + 1);
      const int r0 = u >> 3;
      float rsc[kNormRows];
#pragma unroll
      for (int j = 0; j < kNormRows; ++j) {
        const int r = r0 + 8 * j;
        rsc[j] = r >= rows    ? 0.f
                 : clustered ? *cluster.map_shared_rank(scales + r, r % P)
                             : scales[r];
      }
      if (clustered) cluster_arrive();
      const int c8 = 8 * ((u & 7) ^ (r0 & 7));
      for (int i = 0; i < nslices; ++i) {
        const int st = i % STAGES;
        mbar_wait(&full[st], (i / STAGES) & 1);
        if (kbeg + i * kBK + c8 < kend) {
          float gk[8];
          load8(reinterpret_cast<const G*>(gslots + st * kGainSlot) + c8,
                gk);
          unsigned char* xs =
              ring + (size_t)st * stage_bytes + xoff + (u & 7) * 16;
#pragma unroll
          for (int j = 0; j < kNormRows; ++j) {
            const int r = r0 + 8 * j;
            if (r < rows) norm8(xs + r * kBK * 2, rsc[j], gk);
          }
          fence_proxy_async();  // before the stage's next TMA write
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&normed[st]);
      }
    }
  } else if constexpr (WT == kWFloat) {
    // the scale of the lane's x row (registers normalization: row g)
    float rs = 0.f;
    if constexpr (kNorm && !kNormWarpsOn) {
      if (g < rows)
        rs = clustered ? *cluster.map_shared_rank(scales + g, g % P)
                       : scales[g];
    }
    if (clustered) cluster_arrive();
#pragma unroll
    for (int c = 0; c < CW; ++c)
#pragma unroll
      for (int j = 0; j < NGW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
    // ldmatrix rows (128 bytes each, 16-byte chunk c stored at c ^ (row
    // % 8), and row % 8 == lane % 8 for every row a lane addresses): A
    // rows wcol*16*CW + lane % 16, chunk 2kk + lane / 16; B pairs of
    // 8-row groups, rows 8 * (lane / 16) + lane % 8, chunk
    // 2kk + (lane / 8) % 2
    const int sw = lane & 7;
    const unsigned a_row = (wcol * 16 * CW + (lane & 15)) * kBK * 2;
    const int a_hi = lane >> 4;
    const unsigned b_row =
        BN * WB + (grp0 * 8 + 8 * (lane >> 4) + (lane & 7)) * kBK * 2;
    const int b_hi = (lane >> 3) & 1;
    for (int i = 0; i < nslices; ++i) {
      const int st = i % STAGES;
      // with the fused norm the slice is read once normalized (which it
      // is only after it landed)
      if (kNormWarpsOn) mbar_wait(&normed[st], (i / STAGES) & 1);
      mbar_wait(&full[st], (i / STAGES) & 1);
      const unsigned ws = smem_addr(ring) + st * stage_bytes;
      const int steps = (kend - (kbeg + i * kBK) + 15) / 16;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (kk >= steps) break;
        uint32_t a[CW][4];
        uint32_t b[NGW][2];
        const unsigned a_chunk = ((2 * kk + a_hi) ^ sw) << 4;
        const unsigned b_chunk = ((2 * kk + b_hi) ^ sw) << 4;
#pragma unroll
        for (int c = 0; c < CW; ++c)
          ldsm_x4(a[c], ws + a_row + c * 16 * kBK * 2 + a_chunk);
        if constexpr (NGW == 1) {
          ldsm_x2(b[0][0], b[0][1], ws + b_row + b_chunk);
          if constexpr (kNorm) {
            // the lane's k = 2t, 2t + 1 and 2t + 8, 2t + 9 of the step
            // (past the split's end x is zero and so is the gain)
            const G* gs_ =
                reinterpret_cast<const G*>(gslots + st * kGainSlot);
            const int k = 16 * kk + 2 * t;
            const int left = kend - (kbeg + i * kBK);
            b[0][0] = norm2(b[0][0], rs, gain2(gs_ + k));
            b[0][1] = norm2(b[0][1], rs,
                            k + 8 < left ? gain2(gs_ + k + 8)
                                         : make_float2(0.f, 0.f));
          }
        } else {
#pragma unroll
          for (int j = 0; j < NGW; j += 2) {
            if (grp0 + j < groups) {
              uint32_t r[4];
              ldsm_x4(r, ws + b_row + j * 8 * kBK * 2 + b_chunk);
              b[j][0] = r[0];
              b[j][1] = r[1];
              b[j + 1][0] = r[2];
              b[j + 1][1] = r[3];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < NGW; ++j) {
          if (grp0 + j < groups) {
#pragma unroll
            for (int c = 0; c < CW; ++c)
              mma_bf16(acc[c][j], a[c], b[j][0], b[j][1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  } else {
    // The quantized forms.  A lane owns a run of k inside each U-deep
    // block of a slice (U = 64 for int8 and for int4 groups of a multiple
    // of 64 k, else 32 or 16, dividing gs), so one shared load gives it
    // its weights for every k16 step of the block, and a step's 16 k are
    // those of the four lanes t: step s of lane t takes k kb, kb + 1
    // (the MMA's 2t, 2t + 1) and kb + 2, kb + 3 (2t + 8, 2t + 9) of the
    // slice, kb = 16t + 4s (U = 64), 32(s / 2) + 8t + 4(s % 2) (U = 32)
    // or 16s + 4t (U = 16).  x's B fragments are read in the same order:
    // k kb .. kb + 3 are 8 bytes of one 16-byte chunk of x's row.  The
    // weight tile's rows (WB bytes, no swizzle) are read 16 (int8), 8,
    // 4 or 4 x 2 (int4) bytes a lane a row; each half warp reads 128
    // consecutive bytes (U = 64).
    float rs = 0.f;
    if constexpr (kNorm && !kNormWarpsOn) {
      if (g < rows)
        rs = clustered ? *cluster.map_shared_rank(scales + g, g % P)
                       : scales[g];
    }
    if (clustered) cluster_arrive();
    const int U = WT == kWI8 || gs % 64 == 0 ? 64 : gs % 32 == 0 ? 32 : 16;
    // int4: each group's k16 steps accumulate into accg from zero; at
    // the group's end accg times the group's scales (from the stage's
    // slot) is added to acc
    float accg[CW][NGW][4];
#pragma unroll
    for (int c = 0; c < CW; ++c)
#pragma unroll
      for (int j = 0; j < NGW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][j][e] = accg[c][j][e] = 0.f;
    const int gsteps = WT == kWI4 ? gs / 16 : 1;
    const int gps = WT == kWI4 ? K / gs / S : 0;  // groups a split (area)
    int gstep = 0;                          // the step's place in its group
    int grp = WT == kWI4 ? kbeg / gs : 0;   // the group being walked
    // row g of the warp's first A tile (row g + 8 at 8 * WB further), and
    // x row 8 * grp0 + g of a box (16-byte chunk c stored at c ^ g)
    const int a_row = (wcol * 16 * CW + g) * WB;
    const int b_row = (grp0 * 8 + g) * kBK * 2;
    for (int i = 0; i < nslices; ++i) {
      const int st = i % STAGES;
      // with the fused norm the slice is read once normalized
      if (kNormWarpsOn) mbar_wait(&normed[st], (i / STAGES) & 1);
      mbar_wait(&full[st], (i / STAGES) & 1);
      const unsigned ws = smem_addr(ring) + st * stage_bytes;
      {
        const int left = kend - (kbeg + i * kBK);
        // int8 splits are whole slices (K's last is zero past K)
        const int steps = WT == kWI8 ? 4 : min(4, left / 16);
        const unsigned wq = ws + a_row;
        const unsigned xq = ws + xoff + b_row;
        // the lane's weight words of the slice, rows g and g + 8 of each
        // A tile: int8 k 16t .. 16t + 15; int4 word w holding steps 2w
        // and 2w + 1 (nibbles 4h .. 4h + 3 of word w: step 2w + h)
        constexpr int NWD = WT == kWI8 ? 4 : 2;
        uint32_t wd[CW][2][NWD];
#pragma unroll
        for (int c = 0; c < CW; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const unsigned a = wq + (c * 16 + 8 * r) * WB;
            if constexpr (WT == kWI8) {
              lds_u128(wd[c][r], a + 16 * t);
            } else if (U == 64) {
              lds_u64(wd[c][r][0], wd[c][r][1], a + 8 * t);
            } else if (U == 32) {
              wd[c][r][0] = lds_u32(a + 4 * t);
              wd[c][r][1] = lds_u32(a + 16 + 4 * t);
            } else {
              wd[c][r][0] = __byte_perm(lds_u16(a + 2 * t),
                                        lds_u16(a + 8 + 2 * t), 0x5410);
              wd[c][r][1] = __byte_perm(lds_u16(a + 16 + 2 * t),
                                        lds_u16(a + 24 + 2 * t), 0x5410);
            }
          }
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          // the pair of steps 2w, 2w + 1
          if (2 * w >= steps) break;
          // x's B fragments, k kb .. kb + 3 of row 8j + g: at 8 rows both
          // steps' at once, (bp[2h], bp[2h + 1]) step 2w + h's, one
          // 16-byte chunk (chunk 2t + w at U = 64, 4w + t at U = 32) or 8
          // bytes a step (chunk 2s + t / 2, half t % 2, at U = 16); with
          // more rows a step's 8 bytes at a time, for fewer registers
          uint32_t bp[4];
          if constexpr (NGW == 1) {
            const unsigned xr = xq;
            if (U == 16) {
              const unsigned half = 8 * (t & 1);
              lds_u64(bp[0], bp[1],
                      xr + (((4 * w + (t >> 1)) ^ g) << 4) + half);
              lds_u64(bp[2], bp[3],
                      xr + (((4 * w + 2 + (t >> 1)) ^ g) << 4) + half);
            } else {
              lds_u128(bp, xr + (((U == 64 ? 2 * t + w : 4 * w + t) ^ g)
                                 << 4));
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int s = 2 * w + h;
            if (s >= steps) break;
            // a[c][r]: row r's (kb, kb + 1); a[c][2 + r]: (kb + 2, kb + 3)
            uint32_t a[CW][4];
#pragma unroll
            for (int c = 0; c < CW; ++c)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                if constexpr (WT == kWI8) {
                  i8x4_bf16(wd[c][r][s], a[c][r], a[c][2 + r]);
                } else {
                  const uint32_t v = wd[c][r][w] >> 4;
                  if (h == 0) {
                    a[c][r] = i4_pair<0>(wd[c][r][w], v);
                    a[c][2 + r] = i4_pair<1>(wd[c][r][w], v);
                  } else {
                    a[c][r] = i4_pair<2>(wd[c][r][w], v);
                    a[c][2 + r] = i4_pair<3>(wd[c][r][w], v);
                  }
                }
              }
            uint32_t b[NGW][2];
            if constexpr (NGW == 1) {
              b[0][0] = bp[2 * h];
              b[0][1] = bp[2 * h + 1];
              if constexpr (kNorm) {
                // the lane's k kb .. kb + 3 of the slice (past the
                // split's or K's end x is zero and so is the gain)
                const int kb = U == 64   ? 16 * t + 4 * s
                               : U == 32 ? 32 * w + 8 * t + 4 * h
                                         : 16 * s + 4 * t;
                const G* gsl =
                    reinterpret_cast<const G*>(gslots + st * kGainSlot);
                const bool in = kb < left;
                b[0][0] = norm2(b[0][0], rs,
                                in ? gain2(gsl + kb) : make_float2(0.f, 0.f));
                b[0][1] = norm2(b[0][1], rs,
                                in ? gain2(gsl + kb + 2)
                                   : make_float2(0.f, 0.f));
              }
            } else {
              const unsigned off =
                  U == 16 ? (((4 * w + 2 * h + (t >> 1)) ^ g) << 4) +
                                8 * (t & 1)
                          : (((U == 64 ? 2 * t + w : 4 * w + t) ^ g) << 4) +
                                8 * h;
#pragma unroll
              for (int j = 0; j < NGW; ++j)
                if (grp0 + j < groups)
                  lds_u64(b[j][0], b[j][1], xq + j * 8 * kBK * 2 + off);
            }
#pragma unroll
            for (int j = 0; j < NGW; ++j) {
              if (grp0 + j < groups) {
#pragma unroll
                for (int c = 0; c < CW; ++c) {
                  if constexpr (WT == kWI4)
                    mma_bf16(accg[c][j], a[c], b[j][0], b[j][1]);
                  else
                    mma_bf16(acc[c][j], a[c], b[j][0], b[j][1]);
                }
              }
            }
            if constexpr (WT == kWI4) {
              if (++gstep == gsteps) {
                // the group ends: its sums scaled into the running sum,
                // by the scales of columns g and g + 8 of each A tile,
                // from the scale area ([column][group of the split]) or
                // the stage's slot ([group % SQ][column])
                gstep = 0;
                const int col = wcol * 16 * CW + g;
                const int cst = sarea_bytes ? 4 * gps : 4;  // a column's
                const unsigned sl =
                    sarea_bytes
                        ? smem_addr(sarea) + col * cst + (grp - kbeg / gs) * 4
                        : ws + soff + ((grp % SQ) * BN + col) * 4;
                ++grp;
#pragma unroll
                for (int c = 0; c < CW; ++c) {
                  const float s0 =
                      __uint_as_float(lds_u32(sl + c * 16 * cst));
                  const float s1 =
                      __uint_as_float(lds_u32(sl + (c * 16 + 8) * cst));
#pragma unroll
                  for (int j = 0; j < NGW; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                      acc[c][j][e] = __fadd_rn(
                          acc[c][j][e],
                          __fmul_rn(accg[c][j][e], e < 2 ? s0 : s1));
                      accg[c][j][e] = 0.f;
                    }
                }
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  if (clustered) cluster_wait();
  // the partial tile, rows x BN floats, over the ring
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);
  if (warp < cwarps) {
#pragma unroll
    for (int c = 0; c < CW; ++c)
#pragma unroll
      for (int j = 0; j < NGW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[((grp0 + j) * 8 + 2 * t + (e & 1)) * PLD + wcol * 16 * CW +
               c * 16 + g + (e >= 2 ? 8 : 0)] = acc[c][j][e];
  }
  if (S > 1)
    cluster.sync();
  else
    __syncthreads();

  // this block's share of the tile, the S partials (cluster blocks
  // rank - split .. rank - split + S - 1) added in split order
  constexpr int quads = BN / 4;
  const int total = rows * quads;
  const int q_lo = split * total / S;
  const int q_hi = (split + 1) * total / S;
  const int first = rank - split;
  for (int q = q_lo + tid; q < q_hi; q += blockDim.x) {
    const int r = q / quads;
    const int c = (q - r * quads) * 4;
    if (c >= ncols) continue;
    float4 v;
    if constexpr (WT == kWFloat) {
      v = *reinterpret_cast<const float4*>(
          (S > 1 ? cluster.map_shared_rank(part, first) : part) + r * PLD +
          c);
      for (int z = 1; z < S; ++z) {
        const float4 u = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, first + z) + r * PLD + c);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
    } else {
      // the quantized forms: every split's partial loaded before the
      // first sum (each a distributed shared memory read, latencies
      // overlapped), then added in split order as G1 adds them
      float4 u[kMaxSplits];
#pragma unroll
      for (int z = 0; z < kMaxSplits; ++z)
        if (z < S)
          u[z] = *reinterpret_cast<const float4*>(
              (S > 1 ? cluster.map_shared_rank(part, first + z) : part) +
              r * PLD + c);
      v = u[0];
#pragma unroll
      for (int z = 1; z < kMaxSplits; ++z) {
        if (z < S) {
          v.x += u[z].x;
          v.y += u[z].y;
          v.z += u[z].z;
          v.w += u[z].w;
        }
      }
    }
    if constexpr (WT != kWFloat) {
      // int8: the channel's scale once, on the whole sum; then the bias
      auto fix = [&](float f, int n) {
        if (n < N) {
          if (WT == kWI8) f = __fmul_rn(f, wscale[n]);
          if (bias != nullptr) f = __fadd_rn(f, bias[n]);
        }
        return f;
      };
      const int n = n0 + c;
      v = make_float4(fix(v.x, n), fix(v.y, n + 1), fix(v.z, n + 2),
                      fix(v.w, n + 3));
    }
    bf16* out = y + (size_t)(m0 + r) * N + n0 + c;
    if (c + 4 <= ncols && N % 4 == 0) {
      __nv_bfloat162 lo2 = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi2 = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo2);
      packed.y = *reinterpret_cast<uint32_t*>(&hi2);
      *reinterpret_cast<uint2*>(out) = packed;
    } else {
      const float e4[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && c + e < ncols; ++e)
        out[e] = __float2bfloat16(e4[e]);
    }
  }
  if (S > 1) cluster.sync();  // no block leaves while another reads it
  if constexpr (WT == kWI8) {
    if (q8.vq != nullptr)
      q8_epilogue(q8, y, N, n0, n0 + ncols, BN, S, blockIdx.z, m0, rows);
  }
}

constexpr int kF = 32;   // float32 path: output tile and K slice
constexpr int kNormThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    rows_rms_norm_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         T* __restrict__ y, int C, float eps) {
  __shared__ float scale;
  const T* xr = x + (size_t)blockIdx.x * C;
  if (threadIdx.x < 32) {
    const float r = row_scale(xr, C, eps, threadIdx.x);
    if (threadIdx.x == 0) scale = r;
  }
  __syncthreads();
  const float r = scale;
  T* yr = y + (size_t)blockIdx.x * C;
  for (int i = threadIdx.x; i < C; i += kNormThreads)
    store(yr + i, to_float(xr[i]) * r * gamma[i]);
}

// NORM: x's rows normalized by gamma as the tile fills (the fused norm;
// each warp reduces 4 of the tile's 32 rows first).  WT: w float32
// (kWFloat), int8 (N, K) or int4 bytes (N, K / 2) with wscale, converted
// as the tile fills; int8 scales the sum, int4 each group's sum of 16 k
// or more (gs % 16 == 0), in k order, then bias (float32, unless null).
template <bool NORM, int WT>
__global__ void __launch_bounds__(256)
    rows_linear_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ gamma, float eps,
                           const void* __restrict__ w,
                           const float* __restrict__ wscale,
                           const float* __restrict__ bias,
                           float* __restrict__ y, int M, int N, int K,
                           int gs, const Q8Out q8) {
  __shared__ float xs[kF][kF + 1];   // xs[m][k]
  __shared__ float wt[kF][kF + 1];   // wt[n][k]
  __shared__ float sc[kF];           // the rows' scales
  const int tx = threadIdx.x % kF;   // output column in the tile
  const int ty = threadIdx.x / kF;   // rows ty, ty+8, ty+16, ty+24
  const int n0 = blockIdx.x * kF;
  const int m0 = blockIdx.y * kF;
  if constexpr (NORM) {
    for (int r = ty; r < kF; r += 256 / kF) {
      const float v = m0 + r < M
                          ? row_scale(x + (size_t)(m0 + r) * K, K, eps, tx)
                          : 0.f;
      if (tx == 0) sc[r] = v;
    }
    __syncthreads();
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float accg[4] = {0.f, 0.f, 0.f, 0.f};  // int4: the group's sums
  for (int k0 = 0; k0 < K; k0 += kF) {
    for (int i = threadIdx.x; i < kF * kF; i += 256) {
      const int r = i / kF;
      const int c = i % kF;
      float v = 0.f;
      if (m0 + r < M && k0 + c < K) {
        v = x[(size_t)(m0 + r) * K + k0 + c];
        if constexpr (NORM) v = v * sc[r] * gamma[k0 + c];
      }
      xs[r][c] = v;
      float wv = 0.f;
      if (n0 + r < N && k0 + c < K) {
        const size_t at = (size_t)(n0 + r) * K + k0 + c;
        if constexpr (WT == kWFloat) {
          wv = static_cast<const float*>(w)[at];
        } else if constexpr (WT == kWI8) {
          wv = static_cast<const int8_t*>(w)[at];
        } else {
          const int b = static_cast<const int8_t*>(w)[at / 2];
          wv = (k0 + c) & 1 ? b >> 4 : (int8_t)((unsigned)b << 4) >> 4;
        }
      }
      wt[r][c] = wv;
    }
    __syncthreads();
    if constexpr (WT == kWI4) {
      for (int h = 0; h < kF && k0 + h < K; h += 16) {
#pragma unroll
        for (int k = h; k < h + 16; ++k) {
          const float b = wt[tx][k];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            accg[u] = fmaf(xs[ty + 8 * u][k], b, accg[u]);
        }
        if ((k0 + h + 16) % gs == 0) {
          const int n = n0 + tx;
          const float s =
              n < N ? wscale[(size_t)n * (K / gs) + (k0 + h) / gs] : 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[u] = __fadd_rn(acc[u], __fmul_rn(accg[u], s));
            accg[u] = 0.f;
          }
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kF; ++k) {
        const float b = wt[tx][k];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u] = fmaf(xs[ty + 8 * u][k], b, acc[u]);
      }
    }
    __syncthreads();
  }
  const int n = n0 + tx;
  if (n < N) {
    float s = 1.f, b = 0.f;
    if constexpr (WT == kWI8) s = wscale[n];
    if (WT != kWFloat && bias != nullptr) b = bias[n];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = m0 + ty + 8 * u;
      float v = acc[u];
      if constexpr (WT == kWI8) v = __fmul_rn(v, s);
      if constexpr (WT != kWFloat) {
        if (bias != nullptr) v = __fadd_rn(v, b);
      }
      if (m < M) y[(size_t)m * N + n] = v;
    }
  }
  if constexpr (WT == kWI8) {
    if (q8.vq != nullptr)
      q8_epilogue(q8, y, N, n0, min(n0 + kF, N), kF, 1, blockIdx.y, m0,
                  min(kF, M - m0));
  }
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (no link to libcuda).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once.
cudaError_t tiled_encoder(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr)
      return cudaErrorNotSupported;
  }
  *out = encode;
  return cudaSuccess;
}

// A (rows, K) row-major tensor as a map of boxes of box_rows rows and a
// 64-deep K slice, out-of-bounds elements loading as zeros: bf16 x or
// weights (WT = kWFloat; 128-byte rows, 128-byte swizzle), or int8 or
// packed int4 weights as bytes (64- or 32-byte rows, not swizzled).
cudaError_t encode_map(CUtensorMap* map, const void* p, int rows, int K,
                       int box_rows, int WT = kWFloat) {
  EncodeTiled encode;
  const cudaError_t err = tiled_encoder(&encode);
  if (err != cudaSuccess) return err;
  // a row's bytes, and the box's
  const int row_bytes = WT == kWFloat ? 2 * K : WT == kWI8 ? K : K / 2;
  const int box_bytes = wrow_bytes(WT);
  const int elem = WT == kWFloat ? 2 : 1;
  const cuuint64_t dims[2] = {(cuuint64_t)(row_bytes / elem),
                              (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(box_bytes / elem),
                             (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map,
      WT == kWFloat ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(p), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      WT == kWFloat ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// int4's (N, G) float32 scales as a map of boxes of box_rows columns and
// box_groups groups (whole 16-byte units), past N loading as zeros
cudaError_t encode_scale_map(CUtensorMap* map, const float* p, int N, int G,
                             int box_rows, int box_groups) {
  EncodeTiled encode;
  const cudaError_t err = tiled_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)G, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)G * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_groups, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One bf16 launch of weight type WT and class CI (row_classes(WT, CI)) with
// warp_rows rows of computing warps, its x rows normalized by gamma
// unless G is NoNorm.  The kernel's shared-memory limit is raised once
// per size, and whether the card can schedule a cluster of S such blocks
// is asked once per (S, block shape).
template <int WT, int CI, typename G>
int launch_bf16(const void* x, const G* gamma, float eps, const void* w,
                const float* wscale, const float* bias, void* y, int M,
                int N, int K, int gs, int S, int P, int smem, void* stream,
                const Q8Out& q8) {
  constexpr RowClass C = row_classes(WT, CI);
  constexpr int BN = 16 * kWarpCols * C.cw;
  constexpr bool kNorm = !std::is_same<G, NoNorm>::value;
  auto kernel =
      rows_linear_bf16_kernel<WT, C.cw, C.ngw, C.stages, C.warp_rows, G>;
  static int smem_set = 0;
  static int schedulable[kNormCluster + 1][2] = {};  // smem schedulable
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  CUtensorMap wmap = {}, xmap = {}, smap = {};
  const int rows = 8 * C.ngw * C.warp_rows;  // a block's x rows
  if (K > 0) {
    if ((err = encode_map(&wmap, w, N, K, BN, WT)) != cudaSuccess ||
        (err = encode_map(&xmap, x, M, K, rows)) != cudaSuccess)
      return (int)err;
    if (scale_area_bytes(WT, K, S, gs, BN, rows) &&
        (err = encode_scale_map(&smap, wscale, N, K / gs, BN,
                                K / gs / S)) != cudaSuccess)
      return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  const int blocks = (N + BN - 1) / BN * S;
  cfg.gridDim = dim3((blocks + P - 1) / P * P, 1, (M + rows - 1) / rows);
  cfg.blockDim = dim3(
      32 * (kWarpCols * C.warp_rows + 1 + (kNorm && C.ngw > 1 ? kNormWarps
                                                               : 0)),
      1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = P > 1 ? 1 : 0;
  int& known = schedulable[P][C.warp_rows - 1];
  if (P > 1 && known != smem) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    known = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, wmap, xmap, smap, (const bf16*)x,
                           gamma, eps, wscale, bias, (bf16*)y, M, N, K, S, P,
                           C.warp_rows, gs, q8);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// G1 (WT = kWFloat), G3 or G4 in bfloat16 on the wrapper's launch plan,
// its x rows normalized by gamma unless G is NoNorm: see
// mxtpu_rows_linear_bf16 and mxtpu_rows_linear_q_bf16.
template <int WT, typename G>
int rows_linear_bf16(const void* x, const G* gamma, float eps, const void* w,
                     const float* wscale, const float* bias, void* y, int M,
                     int N, int K, int gs, int bn, int S, int stages,
                     int smem, void* stream, Q8Out q8 = {}) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  // the packed types' rows are whole 16-byte units (the tensor map's
  // stride) and int4's groups whole k16 steps
  if ((WT == kWI8 && K % 16) ||
      (WT == kWI4 && (K % 32 || gs < 16 || gs % 16 || K % gs)))
    return (int)cudaErrorInvalidValue;
  const int ci = row_class(M, N, K, WT);
  const RowClass c = row_classes(WT, ci);
  constexpr bool kNorm = !std::is_same<G, NoNorm>::value;
  if (bn != 16 * kWarpCols * c.cw || S != wt_splits(WT, N, K, gs) ||
      stages != c.stages || smem < 0 || (size_t)smem > kMaxSmem ||
      (size_t)smem != smem_bytes(c, stages, kNorm, WT, K, S, gs))
    return (int)cudaErrorInvalidValue;
  // blocks a cluster
  const int P = kNorm ? norm_cluster(S) : S;
#define MXTPU_LAUNCH(CI)                                                    \
  return launch_bf16<WT, CI>(x, gamma, eps, w, wscale, bias, y, M, N, K, gs, \
                             S, P, smem, stream, q8)
  if (ci == 0) MXTPU_LAUNCH(0);
  if (ci == 1) MXTPU_LAUNCH(1);
  if (ci == 2) MXTPU_LAUNCH(2);
  // a type with fewer classes has none to instantiate
  if constexpr (num_classes(WT) > 3)
    if (ci == 3) MXTPU_LAUNCH(3);
  if constexpr (num_classes(WT) > 4)
    if (ci == 4) MXTPU_LAUNCH(4);
  return (int)cudaErrorInvalidValue;
#undef MXTPU_LAUNCH
}

template <bool NORM, int WT>
int launch_f32(const void* x, const void* gamma, const void* w,
               const void* wscale, const void* bias, void* y, int M, int N,
               int K, float eps, int gs, void* stream, Q8Out q8 = {}) {
  const dim3 grid((N + kF - 1) / kF, (M + kF - 1) / kF);
  rows_linear_f32_kernel<NORM, WT><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)gamma, eps, w, (const float*)wscale,
      (const float*)bias, (float*)y, M, N, K, gs, q8);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// G1 in bfloat16 on the wrapper's launch plan (ops/linear.py: plan): an
// N tile of `bn` columns, `S` K splits, a ring of `stages` stages and
// `smem` bytes of shared memory.  A plan that disagrees with the layout
// this file computes for (M, N, K) is refused (cudaErrorInvalidValue),
// and so is a cluster the card cannot schedule
// (cudaErrorInvalidConfiguration).
int mxtpu_rows_linear_bf16(const void* x, const void* w, void* y, int M,
                           int N, int K, int bn, int S, int stages, int smem,
                           void* stream) {
  return rows_linear_bf16<kWFloat>(x, (const NoNorm*)nullptr, 0.f, w,
                                   nullptr, nullptr, y, M, N, K, 0, bn, S,
                                   stages, smem, stream);
}

// The fused norm in bfloat16: G2 then G1 in one launch, on G1's plan.
// gamma (K,) is float32 when gamma_f32 is nonzero, else bfloat16, 8-byte
// aligned.
int mxtpu_rows_norm_linear_bf16(const void* x, const void* gamma,
                                const void* w, void* y, int gamma_f32, int M,
                                int N, int K, float eps, int bn, int S,
                                int stages, int smem, void* stream) {
  if (gamma_f32)
    return rows_linear_bf16<kWFloat>(x, (const float*)gamma, eps, w, nullptr,
                                     nullptr, y, M, N, K, 0, bn, S, stages,
                                     smem, stream);
  return rows_linear_bf16<kWFloat>(x, (const bf16*)gamma, eps, w, nullptr,
                                   nullptr, y, M, N, K, 0, bn, S, stages,
                                   smem, stream);
}

// G3 (wtype 1: w (N, K) int8, wscale (N,)) or G4 (wtype 2: w (N, K / 2)
// packed int4, wscale (N, K / gs)) in bfloat16 on the wrapper's plan, as
// mxtpu_rows_linear_bf16; bias (N,) float32 or null; with a gamma (K,),
// bfloat16, the fused norm.  K % 16 == 0 for int8; K % 32 == 0, gs % 16
// == 0 and K % gs == 0 for int4; anything else is refused.
int mxtpu_rows_linear_q_bf16(const void* x, const void* gamma, const void* w,
                             const void* wscale, const void* bias, void* y,
                             int wtype, int gs, int M, int N, int K,
                             float eps, int bn, int S, int stages, int smem,
                             void* stream) {
  const float* s = (const float*)wscale;
  const float* b = (const float*)bias;
  const bf16* gm = (const bf16*)gamma;
  const NoNorm* none = nullptr;
  if (wtype == kWI8)
    return gamma ? rows_linear_bf16<kWI8>(x, gm, eps, w, s, b, y, M, N, K,
                                          gs, bn, S, stages, smem, stream)
                 : rows_linear_bf16<kWI8>(x, none, eps, w, s, b, y, M, N, K,
                                          gs, bn, S, stages, smem, stream);
  if (wtype == kWI4)
    return gamma ? rows_linear_bf16<kWI4>(x, gm, eps, w, s, b, y, M, N, K,
                                          gs, bn, S, stages, smem, stream)
                 : rows_linear_bf16<kWI4>(x, none, eps, w, s, b, y, M, N, K,
                                          gs, bn, S, stages, smem, stream);
  return (int)cudaErrorInvalidValue;
}

// G3 with its q8 epilogue (Q8Out) in bfloat16, on G3's plan for (M, N,
// K): y (M, N) as mxtpu_rows_linear_q_bf16 writes it, and the last nv
// columns, heads of hd <= 256, also as the int8 payload vq (M, nv) and the
// float32 scales vs (M, nv / hd); counters (ceil(M / rows) * nv / hd
// ints, rows the plan's class rows) are zero and left zero.
int mxtpu_rows_linear_q8_bf16(const void* x, const void* gamma,
                              const void* w, const void* wscale,
                              const void* bias, void* y, void* vq, void* vs,
                              void* counters, int nv, int hd, int M, int N,
                              int K, float eps, int bn, int S, int stages,
                              int smem, void* stream) {
  if (nv < 1 || hd < 1 || hd > 32 * kQ8PerLane || nv % hd || nv > N || !vq ||
      !vs || !counters)
    return (int)cudaErrorInvalidValue;
  const Q8Out q8 = {(int8_t*)vq, (float*)vs, (int*)counters, nv, hd};
  const float* s = (const float*)wscale;
  const float* b = (const float*)bias;
  if (gamma)
    return rows_linear_bf16<kWI8>(x, (const bf16*)gamma, eps, w, s, b, y, M,
                                  N, K, 0, bn, S, stages, smem, stream, q8);
  return rows_linear_bf16<kWI8>(x, (const NoNorm*)nullptr, eps, w, s, b, y,
                                M, N, K, 0, bn, S, stages, smem, stream, q8);
}

// The same in float32 (a float32 gamma, any K; counters ceil(M / 32) *
// nv / hd ints)
int mxtpu_rows_linear_q8_f32(const void* x, const void* gamma,
                             const void* w, const void* wscale,
                             const void* bias, void* y, void* vq, void* vs,
                             void* counters, int nv, int hd, int M, int N,
                             int K, float eps, void* stream) {
  if (M < 1 || N < 1 || K < 0 || nv < 1 || hd < 1 || hd > 32 * kQ8PerLane ||
      nv % hd || nv > N || !vq || !vs || !counters)
    return (int)cudaErrorInvalidValue;
  const Q8Out q8 = {(int8_t*)vq, (float*)vs, (int*)counters, nv, hd};
  return gamma ? launch_f32<true, kWI8>(x, gamma, w, wscale, bias, y, M, N,
                                        K, eps, 0, stream, q8)
               : launch_f32<false, kWI8>(x, gamma, w, wscale, bias, y, M, N,
                                         K, eps, 0, stream, q8);
}

// G2 over M rows of C elements; gamma is float32 (C,)
int mxtpu_rows_rms_norm_f32(const void* x, const void* gamma, void* y,
                            int M, int C, float eps, void* stream) {
  rows_rms_norm_kernel<float><<<M, kNormThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)gamma, (float*)y, C, eps);
  return (int)cudaGetLastError();
}

int mxtpu_rows_rms_norm_bf16(const void* x, const void* gamma, void* y,
                             int M, int C, float eps, void* stream) {
  rows_rms_norm_kernel<__nv_bfloat16>
      <<<M, kNormThreads, 0, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)x, (const float*)gamma,
          (__nv_bfloat16*)y, C, eps);
  return (int)cudaGetLastError();
}

int mxtpu_rows_linear_f32(const void* x, const void* w, void* y, int M, int N,
                          int K, void* stream) {
  return launch_f32<false, kWFloat>(x, nullptr, w, nullptr, nullptr, y, M, N,
                                    K, 0.f, 0, stream);
}

// The fused norm in float32; gamma is float32 (K,)
int mxtpu_rows_norm_linear_f32(const void* x, const void* gamma,
                               const void* w, void* y, int M, int N, int K,
                               float eps, void* stream) {
  return launch_f32<true, kWFloat>(x, gamma, w, nullptr, nullptr, y, M, N, K,
                                   eps, 0, stream);
}

// G3 or G4 in float32 (wtype, wscale, bias and gs as in
// mxtpu_rows_linear_q_bf16, but any K for int8 and an even K for int4),
// with a float32 gamma the fused norm
int mxtpu_rows_linear_q_f32(const void* x, const void* gamma, const void* w,
                            const void* wscale, const void* bias, void* y,
                            int wtype, int gs, int M, int N, int K, float eps,
                            void* stream) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  if (wtype == kWI8)
    return gamma ? launch_f32<true, kWI8>(x, gamma, w, wscale, bias, y, M, N,
                                          K, eps, gs, stream)
                 : launch_f32<false, kWI8>(x, gamma, w, wscale, bias, y, M,
                                           N, K, eps, gs, stream);
  if (wtype == kWI4 && K % 2 == 0 && gs >= 16 && gs % 16 == 0 && K % gs == 0)
    return gamma ? launch_f32<true, kWI4>(x, gamma, w, wscale, bias, y, M, N,
                                          K, eps, gs, stream)
                 : launch_f32<false, kWI4>(x, gamma, w, wscale, bias, y, M,
                                           N, K, eps, gs, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
