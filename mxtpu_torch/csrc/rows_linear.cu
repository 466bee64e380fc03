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
// block of 256 threads normalizes one row: each thread sums the squares
// of its strided elements in order, the warps reduce by a fixed
// butterfly, and thread 0 adds the 8 warp sums in order; nothing depends
// on the row count.  Bound: bytes (each row read twice, from L1/L2 the
// second time, written once).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
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

// The k16 steps [*lo, *hi) that split `split` of S walks, in order.
__host__ __device__ inline void k_range(int K, int S, int split, int* lo,
                                        int* hi) {
  const int steps = (K + 15) / 16;
  *lo = split * steps / S;
  *hi = (split + 1) * steps / S;
}

// A row class: the rows a block holds, a computing warp's 16-column A
// tiles (CW) and 8-row B groups (NGW), the computing warps across the
// rows, and the ring's stages.  A block runs 4 * warp_rows computing
// warps and one producer warp.  128 rows take 256-column tiles, or 192
// where that grid fits one wave (the last class).
struct RowClass {
  int rows, cw, ngw, warp_rows, stages;
};
constexpr RowClass kClasses[] = {{8, 1, 1, 1, 4},   {32, 1, 4, 1, 4},
                                 {64, 2, 8, 1, 3},  {128, 4, 8, 2, 4},
                                 {128, 3, 8, 2, 5}};
// Blocks of one block an SM that fit the H100 at once in clusters of 4
// (30 such clusters); a grid a few blocks past it runs a second wave.
constexpr int kOneWave = 120;

inline int row_class(int M, int N, int K) {
  const int m = M < kChunk ? M : kChunk;
  int c = 0;
  while (kClasses[c].rows < m) ++c;
  if (c == 3 && (N + 191) / 192 * splits(N, K) <= kOneWave) c = 4;
  return c;
}

// Shared memory of one block, as the kernel carves it: the stages'
// mbarriers, then (1024-byte aligned, for the 128-byte swizzle) the ring
// of weight tiles and x rows, which the float32 partial tile reuses
// after the walk.
inline size_t smem_bytes(const RowClass& c, int stages) {
  const int bn = 16 * kWarpCols * c.cw;
  const size_t ring = (size_t)stages * (bn + c.rows) * kBK * 2;
  const size_t part = (size_t)c.rows * (bn + kPartPad) * 4;
  return kHead + (ring > part ? ring : part);
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

// One block: output columns [n0, n0 + BN) of rows [m0, m0 + rows), over
// the k16 steps of split blockIdx.x % S.  Warps 0 .. 4*warp_rows - 1
// compute: warp w owns the 16*CW columns (w % 4) and the 8*NGW rows
// (w / 4) of the tile.  The last warp produces: it loads slice i (a
// 64-deep box of the weight tile and one of the chunk's x rows, both
// through tensor maps with the 128-byte swizzle; rows past N or M and
// columns past K land as zeros) into stage i % STAGES once the
// computing warps have released the stage.
template <int CW, int NGW, int STAGES>
__global__ void __launch_bounds__(288)
    rows_linear_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap xmap,
                            bf16* __restrict__ y, int M, int N, int K,
                            int S, int warp_rows) {
  static_assert(STAGES <= kMaxStages, "the head holds kMaxStages barriers");
  constexpr int BN = 16 * kWarpCols * CW;
  constexpr int PLD = BN + kPartPad;
  extern __shared__ uint4 smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  const unsigned base = smem_addr(smem_raw);
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem_raw) +
                        (((base + 2 * kMaxStages * 8 + 1023) & ~1023u) -
                         base);
  const int R = 8 * NGW * warp_rows;
  const int stage_bytes = (BN + R) * kBK * 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cwarps = kWarpCols * warp_rows;  // computing warps
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wcol = warp % kWarpCols;
  const int grp0 = warp / kWarpCols * NGW;  // the warp's first 8-row group
  const int split = blockIdx.x % S;
  const int n0 = blockIdx.x / S * BN;
  const int m0 = blockIdx.z * R;
  const int rows = min(R, M - m0);
  const int groups = (rows + 7) / 8;        // 8-row groups holding a row
  const int ncols = min(BN, N - n0);
  int lo, hi;
  k_range(K, S, split, &lo, &hi);
  const int kbeg = 16 * lo;
  const int kend = min(16 * hi, K);
  const int nslices = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], cwarps);
    }
  }
  __syncthreads();

  float acc[CW][NGW][4];
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int j = 0; j < NGW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;

  if (warp == cwarps) {
    if (lane == 0) {
      for (int i = 0; i < nslices; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[st], (i / STAGES - 1) & 1);
        unsigned char* ws = ring + (size_t)st * stage_bytes;
        mbar_expect(&full[st], stage_bytes);
        tma_load(ws, &wmap, kbeg + i * kBK, n0, &full[st]);
        tma_load(ws + BN * kBK * 2, &xmap, kbeg + i * kBK, m0, &full[st]);
      }
    }
  } else {
    // ldmatrix rows (128 bytes each, 16-byte chunk c stored at c ^ (row
    // % 8), and row % 8 == lane % 8 for every row a lane addresses): A
    // rows wcol*16*CW + lane % 16, chunk 2kk + lane / 16; B pairs of
    // 8-row groups, rows 8 * (lane / 16) + lane % 8, chunk
    // 2kk + (lane / 8) % 2
    const int sw = lane & 7;
    const unsigned a_row = (wcol * 16 * CW + (lane & 15)) * kBK * 2;
    const int a_hi = lane >> 4;
    const unsigned b_row =
        BN * kBK * 2 + (grp0 * 8 + 8 * (lane >> 4) + (lane & 7)) * kBK * 2;
    const int b_hi = (lane >> 3) & 1;
    for (int i = 0; i < nslices; ++i) {
      const int st = i % STAGES;
      mbar_wait(&full[st], (i / STAGES) & 1);
      const unsigned ws = smem_addr(ring) + st * stage_bytes;
      const int steps = (kend - (kbeg + i * kBK) + 15) / 16;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (kk >= steps) break;
        const unsigned a_chunk = ((2 * kk + a_hi) ^ sw) << 4;
        const unsigned b_chunk = ((2 * kk + b_hi) ^ sw) << 4;
        uint32_t a[CW][4];
#pragma unroll
        for (int c = 0; c < CW; ++c)
          ldsm_x4(a[c], ws + a_row + c * 16 * kBK * 2 + a_chunk);
        uint32_t b[NGW][2];
        if constexpr (NGW == 1) {
          ldsm_x2(b[0][0], b[0][1], ws + b_row + b_chunk);
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
  }

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
  cg::cluster_group cluster = cg::this_cluster();
  if (S > 1)
    cluster.sync();
  else
    __syncthreads();

  // this block's share of the tile, the S partials added in split order
  constexpr int quads = BN / 4;
  const int total = rows * quads;
  const int q_lo = split * total / S;
  const int q_hi = (split + 1) * total / S;
  for (int q = q_lo + tid; q < q_hi; q += blockDim.x) {
    const int r = q / quads;
    const int c = (q - r * quads) * 4;
    if (c >= ncols) continue;
    float4 v = *reinterpret_cast<const float4*>(
        (S > 1 ? cluster.map_shared_rank(part, 0) : part) + r * PLD + c);
    for (int z = 1; z < S; ++z) {
      const float4 u = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, z) + r * PLD + c);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
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
}

constexpr int kF = 32;   // float32 path: output tile and K slice
constexpr int kNormThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    rows_rms_norm_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         T* __restrict__ y, int C, float eps) {
  __shared__ float warp_sums[kNormThreads / 32];
  __shared__ float scale;
  const T* xr = x + (size_t)blockIdx.x * C;
  float s = 0.f;
  for (int i = threadIdx.x; i < C; i += kNormThreads) {
    const float v = to_float(xr[i]);
    s = fmaf(v, v, s);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = warp_sums[0];
    for (int w = 1; w < kNormThreads / 32; ++w) total += warp_sums[w];
    scale = rsqrtf(total / C + eps);
  }
  __syncthreads();
  const float r = scale;
  T* yr = y + (size_t)blockIdx.x * C;
  for (int i = threadIdx.x; i < C; i += kNormThreads)
    store(yr + i, to_float(xr[i]) * r * gamma[i]);
}

__global__ void __launch_bounds__(256)
    rows_linear_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           float* __restrict__ y, int M, int N, int K) {
  __shared__ float xs[kF][kF + 1];   // xs[m][k]
  __shared__ float wt[kF][kF + 1];   // wt[n][k]
  const int tx = threadIdx.x % kF;   // output column in the tile
  const int ty = threadIdx.x / kF;   // rows ty, ty+8, ty+16, ty+24
  const int n0 = blockIdx.x * kF;
  const int m0 = blockIdx.y * kF;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += kF) {
    for (int i = threadIdx.x; i < kF * kF; i += 256) {
      const int r = i / kF;
      const int c = i % kF;
      xs[r][c] = (m0 + r < M && k0 + c < K) ? x[(size_t)(m0 + r) * K + k0 + c]
                                             : 0.f;
      wt[r][c] = (n0 + r < N && k0 + c < K) ? w[(size_t)(n0 + r) * K + k0 + c]
                                             : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF; ++k) {
      const float b = wt[tx][k];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(xs[ty + 8 * u][k], b, acc[u]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m0 + ty + 8 * u;
    if (m < M && n0 + tx < N) y[(size_t)m * N + n0 + tx] = acc[u];
  }
}



// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (no link to libcuda).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// A (rows, K) bf16 row-major tensor as a map of (box_rows, 64) boxes with
// the 128-byte swizzle; out-of-bounds elements load as zeros.
cudaError_t encode_map(CUtensorMap* map, const void* p, int rows, int K,
                       int box_rows) {
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
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One bf16 launch of class <CW, NGW, STAGES> with warp_rows rows of
// computing warps.  The kernel's shared-memory limit is raised once per
// size, and whether the card can schedule a cluster of S such blocks is
// asked once per (S, block shape).
template <int CW, int NGW, int STAGES>
int launch_bf16(const void* x, const void* w, void* y, int M, int N, int K,
                int S, int smem, int warp_rows, void* stream) {
  constexpr int BN = 16 * kWarpCols * CW;
  auto kernel = rows_linear_bf16_kernel<CW, NGW, STAGES>;
  static int smem_set = 0;
  static int schedulable[kMaxSplits + 1][2] = {};  // smem found schedulable
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  CUtensorMap wmap = {}, xmap = {};
  if (K > 0) {
    const int rows = 8 * NGW * warp_rows;
    if ((err = encode_map(&wmap, w, N, K, BN)) != cudaSuccess ||
        (err = encode_map(&xmap, x, M, K, rows)) != cudaSuccess)
      return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN * S, 1, (M + kChunk - 1) / kChunk);
  cfg.blockDim = dim3(32 * (kWarpCols * warp_rows + 1), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  int& known = schedulable[S][warp_rows - 1];
  if (S > 1 && known != smem) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    known = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, wmap, xmap, (bf16*)y, M, N, K, S,
                           warp_rows);
  if (err != cudaSuccess) return (int)err;
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
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const int ci = row_class(M, N, K);
  const RowClass& c = kClasses[ci];
  if (bn != 16 * kWarpCols * c.cw || S != splits(N, K) ||
      stages != c.stages || smem < 0 || (size_t)smem > kMaxSmem ||
      (size_t)smem != smem_bytes(c, stages))
    return (int)cudaErrorInvalidValue;
  switch (ci) {
    case 0:
      return launch_bf16<1, 1, 4>(x, w, y, M, N, K, S, smem, c.warp_rows,
                                  stream);
    case 1:
      return launch_bf16<1, 4, 4>(x, w, y, M, N, K, S, smem, c.warp_rows,
                                  stream);
    case 2:
      return launch_bf16<2, 8, 3>(x, w, y, M, N, K, S, smem, c.warp_rows,
                                  stream);
    case 3:
      return launch_bf16<4, 8, 4>(x, w, y, M, N, K, S, smem, c.warp_rows,
                                  stream);
    default:
      return launch_bf16<3, 8, 5>(x, w, y, M, N, K, S, smem, c.warp_rows,
                                  stream);
  }
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
  const dim3 grid((N + kF - 1) / kF, (M + kF - 1) / kF);
  rows_linear_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)y, M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
