// Flash attention forward and its FlashAttention-2 backward, for Hopper
// (sm_90a): three kernels, one per Pallas TPU kernel of
// mxtpu/ops/pallas/flash_attention.py.
//
//   flash_fwd_kernel  replaces _fwd_kernel (K3, flash_attention.py:107,
//                     pallas_call :185): o = softmax(q.k^T*scale).v with
//                     the online softmax, plus the per-row logsumexp lse;
//   flash_dq_kernel   replaces _dq_kernel (K4, :202, pallas_call :317):
//                     dq = scale * sum_k ds.k, ds = p*(dO.v^T - delta),
//                     p = exp(s - lse);
//   flash_dkv_kernel  replaces _dkv_kernel (K5, :246, pallas_call :333):
//                     dv = sum_q p^T.dO and dk = scale * sum_q ds^T.q.
//
// Operands are (B*H, T, D) row-major; lse and delta (B*H, T) float32;
// delta = rowsum(dO*O) comes from the caller, as the reference computes
// it in XLA outside the kernels.
//
// On the TPU a grid step carried the online-softmax state (or a
// gradient sum) in VMEM scratch to the next step of the sequential grid
// axis.  Blocks on the card run in parallel and in no order, so the
// sequential axis is a loop inside one block.  No block writes what
// another reads, so nothing needs atomics, and a second call gives the
// same bits.  The walked tiles are copied 16 bytes a thread with
// cp.async, and the copies of tile j+1 run while the block computes on
// tile j.  Each kernel masks the ragged edge itself (rows and keys at or
// past T; rows past T land as zeros) instead of padding in the wrapper.
// Arithmetic: the Pallas kernels' in float32 — masked scores at -1e30,
// p = exp(s - m) in the forward with l = l*corr + sum p, the output
// acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)); in the backward
// s = scale * (q.k), p = exp(s - lse) (exactly 0 where masked),
// ds = p*(dp - delta), dq and dk scaled by `scale` once at the end.
//
// All three run every product on the tensor cores, as warp-level
// mma.sync.m16n8k8 TF32 at float32 accuracy (3xTF32).  The reference
// runs the kernels at Precision.HIGHEST for float32, and the port holds
// K3 to 2e-5 of its plain version and K4/K5 to 2e-5 of their largest
// gradient element.  TF32 keeps 10 mantissa bits, so each operand x is
// split as big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big) (the
// same rounding done by integer ops, see split()), and a product is
// small*big + big*small + big*big, three MMAs (CUTLASS's
// OpMultiplyAddFastF32 order; the small*small term, about 2^-22 of the
// product, is dropped).  Raw float32 bits are never fed to an MMA: it
// truncates them.  Emulated on the CPU at (1, 4, 1024, 128), causal, the
// max abs error of o against float64 is 8.4e-7 in float32, 1.5e-6 in
// 3xTF32 and 9.7e-4 in plain TF32, 50x the tolerance; dq, dk and dv at
// (1, 2, 2048, 128) fall within 1.0-1.25e-6 of max |plain| in 3xTF32 and
// 2.8e-4 to 6.7e-4 in plain TF32 (tests/test_torch_flash_attention.py
// holds the arithmetic of all three).  The emulation sums with rounding
// to nearest; an MMA adds into its accumulator with truncation toward
// zero, so a long chain of MMAs into one accumulator drifts by up to an
// ulp of the running sum a link, all one way.  Chained through, S's 48
// links at D = 128 and O's 768 over 2048 keys put K3's o 7.5e-5 off on
// the training path's inputs, where |o| reaches several units
// (chip_smoke.py phase 11 on the H100).  So each product step runs its
// MMAs into a fresh zero accumulator and adds the result in float32,
// rounded to nearest: once a depth step for S (and dP), once a walked
// tile for O, dQ, dK and dV (K3: acc = acc * corr + (P.V of the tile),
// one fused multiply-add).  A bfloat16 operand is exactly a TF32 value,
// so its small part is zero and the MMAs with it are skipped (mma3s).
//
// Fragments.  Lane (g, t) = (lane/4, lane%4) holds rows g and g+8 of
// the MMA's C fragment at columns 2t and 2t+1 of each 8-column group.
// The A fragment of the next product wants k = t and t+4 of an 8-step
// where the C fragment has columns 2t and 2t+1; since that product sums
// over k, k is relabelled (k = t is column 2t, k = t+4 column 2t+1) and
// the B fragment is read from rows 2t and 2t+1.  So P (K3), dS (K4) and
// P^T, dS^T (K5) go from one product's C fragment straight into the
// next one's A fragment, never through shared memory.  A depth step of
// a score product relabels its dims the same way (k = t is dim 2t).
//
// Splitting costs more instructions than the MMAs it feeds, so each
// walked tile is split once by the whole block, not once by each warp
// (split_tile): staged with 16-byte cp.async copies, then split into
// planes of (big, big, small, small) words from which a lane's whole B
// fragment, big and small, is one 16-byte load: a (row, dim-pair) plane
// for the B operand of a score product (rows are its n8 columns, dim
// pairs its depth) and a (row-pair, dim) plane for the B operand of an
// accumulation (row pairs are its depth).  Plane rows are 16 and 8
// words mod 32 apart, which keeps each quarter-warp's loads on distinct
// banks.  The next tile's copies are issued as soon as the split has
// read the staged one and land while the warps multiply.  The resident
// operand of each kernel (the A operand of its score products) stays in
// shared memory as float32, rows 8 words mod 32 apart (a half-warp's
// 8-byte loads on banks 8g + 2t), and is split as the A fragments are
// read.  The causal mask runs on diagonal tiles only, and a warp skips a
// tile that none of its rows attends (its p would be exactly 0).
//
//   K3: split-Q.  A block per (b*h, query tile), each warp 16 query
//       rows, resident Q (pre-scaled); walked K/V tiles of 16 keys (32
//       up to head_dim 64): K's (key, dim-pair) plane for S = Q.K^T, V's
//       (key-pair, dim) plane for O += P.V.
//   K4: the same split-Q with Q and dO resident, a warp pair per 16
//       query rows (128 a block); walked K/V tiles: K's and V's (key,
//       dim-pair) planes for S = Q.K^T and dP = dO.V^T, K's (key-pair,
//       dim) plane for dQ += dS.K.  One warp of a pair computes S and
//       P, the other dP; they swap them through shared memory (a named
//       barrier of the pair's 64 threads), both form dS, and each adds
//       dS.K into half of dQ's 8-dim column tiles.
//   K5: keys as rows, a warp pair per 16 keys (128 a block), K and V
//       resident; walked Q/dO tiles of 16 queries (32 up to head_dim
//       64), from the diagonal on when causal: Q's and dO's (query,
//       dim-pair) planes for S^T = K.Q^T and dP^T = V.dO^T, their
//       (query-pair, dim) planes for dV += P^T.dO and dK += dS^T.Q.
//       One warp of a pair computes S^T, P^T and dV, the other dP^T,
//       then (given P^T through shared memory) dS^T and dK.
//
// What bounds them on the card is latency, not a pipe: the MMAs feed on
// shared-memory loads and on each other, and the block's two barriers
// a tile keep its warps in step, so the more warps an SM holds the
// faster they run (K4 and K5 with one warp per 16 rows ran 1.9x slower
// at 4 warps a block than at 8 on the H100).  K3 takes 16 warps (256
// query rows, 123 registers a thread, 190 KB of shared memory at D =
// 128 in float32).  K4's and K5's two resident operands fill the SM's
// shared memory at 128 rows, and K5's dK and dV alone would be 128
// registers a thread for a warp that owned both: hence the pairs, 16
// warps of at most 128 registers on the same shared memory, each warp
// with half the products and one accumulator.  The grid's x dimension
// is the head: blocks start in order of their linear index, so all
// heads' heaviest causal tiles (K3's and K4's last query tiles, K5's
// first key tiles) start first and the light ones fill the tail.  The
// staging copies and the split walk each row at the class's widest
// head_dim, so that their indices are shifts.
//
// Bound on the H100 at the training path's shape (B*H = 32, T = 2048,
// D = 128, causal, float32): operations.  Counting the causal half of
// the score tile, K3 does 4*D flops per attended (row, key) pair (34.4
// GFLOP), K4 6*D (51.5 GFLOP) and K5 8*D (68.7 GFLOP): 0.513, 0.770 and
// 1.026 ms at the 67 TFLOP/s float32 CUDA-core peak, the bound of the
// same function in true float32.  In 3xTF32 on the tensor cores it is
// three times the flops at 495 TFLOP/s: 0.208, 0.3125 and 0.4167 ms,
// against ~0.04-0.06 ms to move their 134-201 MB.
//
// Head_dim above 128 (K4 and K5 only): K5's dK or dV alone would be 128
// registers a thread, and K4's resident Q and dO 34 KB a pair, so there
// K4 and K5 take their CUDA-core route (flash_dq_cc_kernel,
// flash_dkv_cc_kernel), chosen by head_dim in dispatch(): one block of
// 256 threads per (b*h, 64-row query tile) (K4) or 64-key tile (K5);
// each thread owns a 4x4 patch of the 64x64 score tile and 4 rows by 4
// float4 columns of the output; p (or ds) goes through shared memory
// between the two products, which run as true float32 FMAs.

#include "paged_common.cuh"
#include "tf32x3.cuh"

namespace {

using mxtpu_port::cp_async16;
using mxtpu_port::cp_async_commit;
using mxtpu_port::cp_async_wait_all;
using mxtpu_port::cp_async_wait_one;
using mxtpu_port::from_float;
using mxtpu_port::kMaxSmem;
using mxtpu_port::kNegInf;
using mxtpu_port::load2;
using mxtpu_port::mma3;
using mxtpu_port::mma3s;
using mxtpu_port::split;
using mxtpu_port::split_a;
using mxtpu_port::to_float;

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// row stride, in elements, of a tile staged in T (16 bytes of padding
// keep the rows of neighbouring keys in different banks)
__host__ __device__ inline int ld_t(int D, int elt) { return D + 16 / elt; }

// The tensor-core kernels' strides (see the note): resident float32
// rows, in floats; a (row, dim-pair) plane's rows and a (row-pair, dim)
// plane's row pairs, in 32-bit words
__host__ __device__ inline int ld_res(int D) { return D + ((8 - D) & 31); }
__host__ __device__ inline int ld_rows(int D) {
  return 2 * D + ((16 - 2 * D) & 31);
}
__host__ __device__ inline int ld_pairs(int D) { return 4 * D + 8; }
// rows of a walked tile (K3's and K4's keys, K5's queries) by head_dim
// class (chosen for K3 on the H100 at head_dim 64, 128 and 256): 32 up
// to head_dim 64 and 16 above, where the resident operands fill shared
// memory
__host__ __device__ constexpr int walk_rows(int D) { return D > 64 ? 16 : 32; }
// K3's most warps a block: 12 up to head_dim 64, 16 (registers capped
// at 128 a thread) up to 128, and 8 above, where the output accumulator
// alone is 128 registers a thread
__host__ __device__ constexpr int fwd_max_warps(int D) {
  return D > 128 ? 8 : D > 64 ? 16 : 12;
}
// K4's and K5's warp pairs a block: a pair owns 16 query rows (K4) or
// 16 keys (K5), and its two warps share the work (see the note)
constexpr int kPairs = 8;

// K3's shared memory for a block of `warps` warps (16 query rows each):
// the pre-scaled queries, the split K and V planes, and one staged
// K/V tile
__host__ __device__ inline size_t fwd_smem_bytes(int D, int elt,
                                                 int warps) {
  const int kt = walk_rows(D);
  return ((size_t)16 * warps * ld_res(D) + (size_t)kt * ld_rows(D) +
          (size_t)kt / 2 * ld_pairs(D)) * 4 +
         (size_t)2 * kt * ld_t(D, elt) * elt;
}

// K3's warps a block: the most of 16, 12, 8 or 4 (up to fwd_max_warps)
// that fit (0 when none do)
__host__ __device__ inline int fwd_warps(int D, int elt) {
  for (int w = fwd_max_warps(D); w > 0; w -= 4)
    if (fwd_smem_bytes(D, elt, w) <= kMaxSmem) return w;
  return 0;
}

// floats a warp hands its partner for one walked tile: its 16 x R
// C fragments, 4*R a lane
__host__ __device__ constexpr int handoff_floats(int D) {
  return 32 * 4 * walk_rows(D) / 8;
}

// K4's shared memory: resident Q and dO, K's and V's (key, dim-pair)
// planes, K's (key-pair, dim) plane, the pairs' P and dP, one staged
// K/V tile
__host__ __device__ inline size_t dq_smem_bytes(int D, int elt) {
  const int kt = walk_rows(D);
  return ((size_t)2 * 16 * kPairs * ld_res(D) + (size_t)2 * kt * ld_rows(D) +
          (size_t)kt / 2 * ld_pairs(D) +
          (size_t)2 * kPairs * handoff_floats(D)) * 4 +
         (size_t)2 * kt * ld_t(D, elt) * elt;
}

// K5's shared memory: resident K and V, Q's and dO's planes of both
// kinds, the pairs' P^T, one staged Q/dO tile
__host__ __device__ inline size_t dkv_smem_bytes(int D, int elt) {
  const int qt = walk_rows(D);
  return ((size_t)2 * 16 * kPairs * ld_res(D) + (size_t)2 * qt * ld_rows(D) +
          (size_t)qt * ld_pairs(D) + (size_t)kPairs * handoff_floats(D)) *
             4 +
         (size_t)2 * qt * ld_t(D, elt) * elt;
}

// Rows [r0, r0 + n) of one (T, D) matrix into a float32 tile of row
// stride ld, times `scale`; rows at or past T as zeros.
template <typename T>
__device__ void load_rows_f(float* dst, const T* __restrict__ src, int r0,
                            int T_len, int D, float scale, int ld, int n) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * ld + d] =
        r0 + r < T_len ? to_float(src[(size_t)(r0 + r) * D + d]) * scale
                       : 0.f;
  }
}

// -- the walked tiles of the tensor-core kernels --------------------------

// Start the copies of tile j of two (T, D) matrices a and b (R rows from
// row j*R, row stride ld) into the staging buffers; rows at or past T
// land as zeros.  A row is walked as 8*DT / E 16-byte chunks, the
// class's widest, so that the indices are shifts; chunks past D are
// skipped.
template <typename T, int DT, int R>
__device__ void issue_tile(T* As, T* Bs, const T* __restrict__ a,
                           const T* __restrict__ b, int j, int T_len, int D,
                           int ld) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = 8 * DT / E;  // chunks a row
  for (int c = threadIdx.x; c < 2 * R * CPR; c += blockDim.x) {
    const int r = (c / CPR) % R, col = (c % CPR) * E;
    if (col >= D) continue;
    const bool is_b = c >= R * CPR, valid = j * R + r < T_len;
    const size_t at = valid ? (size_t)(j * R + r) * D + col : 0;
    cp_async16((is_b ? Bs : As) + r * ld + col, (is_b ? b : a) + at, valid);
  }
  cp_async_commit();
}

// Split one staged tile of R rows (row stride ld) into the planes the
// warps' B fragments read with one 16-byte load each; the caller names
// the planes it wants (nullptr: not made):
//   rows[r][p]  = big, big, small, small of dims 2p, 2p+1 of row r (a
//                 depth step's k = t, t+4 for p = 4*step + t);
//   pairs[i][d] = big, big, small, small of rows 2i, 2i+1 at dim d (a
//                 row step's k = t, t+4 for i = 4*step + t).
// A thread takes rows 2i, 2i+1 at dims 2p, 2p+1; rows are walked as 4*DT
// dim pairs, the class's widest (shifts, not divisions); pairs past D
// are skipped.
template <typename T, int DT, int R>
__device__ void split_tile(uint32_t* rows, uint32_t* pairs, const T* src,
                           int D, int ld) {
  constexpr int P = 4 * DT;  // dim pairs a row
  const int ldr = ld_rows(D), ldp = ld_pairs(D);
  for (int c = threadIdx.x; c < R / 2 * P; c += blockDim.x) {
    const int i = c / P, p = c % P;
    if (2 * p >= D) continue;
    const float2 x0 = load2(src + 2 * i * ld + 2 * p);        // row 2i
    const float2 x1 = load2(src + (2 * i + 1) * ld + 2 * p);  // row 2i+1
    uint32_t b00, b01, b10, b11, s00, s01, s10, s11;  // b<row><dim>
    split(x0.x, b00, s00);
    split(x0.y, b01, s01);
    split(x1.x, b10, s10);
    split(x1.y, b11, s11);
    if (rows) {
      *reinterpret_cast<uint4*>(rows + 2 * i * ldr + 4 * p) =
          make_uint4(b00, b01, s00, s01);
      *reinterpret_cast<uint4*>(rows + (2 * i + 1) * ldr + 4 * p) =
          make_uint4(b10, b11, s10, s11);
    }
    if (pairs) {
      uint4* dst = reinterpret_cast<uint4*>(pairs + i * ldp + 8 * p);
      dst[0] = make_uint4(b00, b10, s00, s10);  // dim 2p
      dst[1] = make_uint4(b01, b11, s01, s11);  // dim 2p+1
    }
  }
}

// c = A.B over D for one warp's 16 rows of A against NT 8-row groups of
// B, summed a depth step at a time (a fresh accumulator each, added in
// float32): A float32 rows (arow: row g at dim 2t, row stride lda), B a
// (row, dim-pair) plane (bp: row g at word 4t).  AS/BS: whether A's/B's
// small parts can be non-zero.
template <int DT, int NT, bool AS, bool BS>
__device__ __forceinline__ void score_tile(float (&c)[NT][4],
                                           const float* arow, int lda,
                                           const uint32_t* bp, int ldr,
                                           int D) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DT; ++ks) {
    if (ks * 8 < D) {
      const float2 x0 = load2(arow + ks * 8);
      const float2 x1 = load2(arow + 8 * lda + ks * 8);
      uint32_t ab[4], as[4];
      split_a(x0.x, x1.x, x0.y, x1.y, ab, as);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float f[4] = {0.f, 0.f, 0.f, 0.f};
        mma3s<AS, BS>(f, ab, as,
                      *reinterpret_cast<const uint4*>(bp + nt * 8 * ldr +
                                                      ks * 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) c[nt][e] += f[e];
      }
    }
  }
}

// acc += X.B for one warp's 16 rows at the 8-dim column tiles dn =
// dn0 + STEP*j: X (16 x 8*NT) in C fragments, relabelled into A
// fragments (k = t is column 2t, k = t+4 column 2t+1); B a (row-pair,
// dim) plane (bp: row pair t at word 4g).  The tile's product runs into
// a fresh accumulator for each column tile and is added in float32.
template <int NC, int NT, int STEP, bool BS>
__device__ __forceinline__ void accumulate_tile(float (&acc)[NC][4],
                                                const float (&x)[NT][4],
                                                const uint32_t* bp, int ldp,
                                                int D, int dn0) {
  uint32_t xb[NT][4], xs[NT][4];
#pragma unroll
  for (int kk = 0; kk < NT; ++kk)
    split_a(x[kk][0], x[kk][2], x[kk][1], x[kk][3], xb[kk], xs[kk]);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int dn = dn0 + STEP * j;
    if (dn * 8 < D) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NT; ++kk)
        mma3s<true, BS>(c, xb[kk], xs[kk],
                        *reinterpret_cast<const uint4*>(bp + kk * 4 * ldp +
                                                        dn * 32));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += c[e];
    }
  }
}

// The two warps of pair `id` (ids from 1; 0 is __syncthreads'): arrive
// without waiting (the shared-memory writes before it made visible to
// the partner first), or wait until both have arrived.
__device__ __forceinline__ void pair_arrive(int id) {
  __threadfence_block();
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// A warp's C fragments (16 x 8*NT) to and from its pair's hand-off
// buffer, lane-major so each float4 lies on its own banks
template <int NT>
__device__ __forceinline__ void put_frag(float* buf, const float (&x)[NT][4],
                                         int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    *reinterpret_cast<float4*>(buf + (nt * 32 + lane) * 4) =
        make_float4(x[nt][0], x[nt][1], x[nt][2], x[nt][3]);
}
template <int NT>
__device__ __forceinline__ void get_frag(float (&x)[NT][4], const float* buf,
                                         int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float4 f = *reinterpret_cast<const float4*>(buf + (nt * 32 + lane) *
                                                      4);
    x[nt][0] = f.x; x[nt][1] = f.y; x[nt][2] = f.z; x[nt][3] = f.w;
  }
}

// -- K3 ------------------------------------------------------------------

// DT: 8-wide column tiles of the widest head_dim of the launch's class
template <typename T, int DT>
__global__ void __launch_bounds__(32 * fwd_max_warps(8 * DT))
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int T_len, int D, int causal,
                     float scale) {
  constexpr int KT = walk_rows(8 * DT);  // keys per K/V tile
  constexpr int NT = KT / 8;             // 8-key groups of a tile
  extern __shared__ uint4 smem[];
  const int rows = blockDim.x / 2;  // 16 query rows a warp
  const int ldq = ld_res(D), ldkp = ld_rows(D), ldvp = ld_pairs(D);
  const int ldr = ld_t(D, sizeof(T));
  float* Qs = reinterpret_cast<float*>(smem);
  uint32_t* Kp = reinterpret_cast<uint32_t*>(Qs + rows * ldq);
  uint32_t* Vp = Kp + KT * ldkp;
  T* Kr = reinterpret_cast<T*>(Vp + KT / 2 * ldvp);  // the staged tile
  T* Vr = Kr + KT * ldr;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // blocks start in order of their linear index, x fastest: all heads'
  // last query tiles first, so the heaviest causal walks start first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * rows;
  const int r0 = q0 + 16 * warp;  // the warp's first query row
  const size_t base = (size_t)blockIdx.x * T_len * D;
  int nk = (T_len + KT - 1) / KT;
  if (causal) nk = min(nk, (q0 + rows - 1) / KT + 1);
  const T* kg = k + base;
  const T* vg = v + base;
  issue_tile<T, DT, KT>(Kr, Vr, kg, vg, 0, T_len, D, ldr);
  load_rows_f(Qs, q + base, q0, T_len, D, scale, ldq, rows);

  // rows g (h = 0) and g + 8 (h = 1) of the warp's 16
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  const float* qrow = Qs + (16 * warp + g) * ldq + 2 * t;
  const uint32_t* kp = Kp + g * ldkp + 4 * t;
  const uint32_t* vp = Vp + t * ldvp + 4 * g;
  for (int j = 0; j < nk; ++j) {
    // tile j has landed, and no warp still reads the planes of tile j-1
    cp_async_wait_all();
    __syncthreads();
    split_tile<T, DT, KT>(Kp, nullptr, Kr, D, ldr);
    split_tile<T, DT, KT>(nullptr, Vp, Vr, D, ldr);
    __syncthreads();
    if (j + 1 < nk)  // lands while the warps compute
      issue_tile<T, DT, KT>(Kr, Vr, kg, vg, j + 1, T_len, D, ldr);
    const int key0 = j * KT;
    // a warp whose rows all lie past T, or before this tile's first key
    // when causal, attends none of it
    if (r0 >= T_len || (causal && key0 > r0 + 15)) continue;
    // S = Q.K^T: k = t, t+4 of a depth step are dims 2t, 2t+1
    float s[NT][4];
    score_tile<DT, NT, true, sizeof(T) == 4>(s, qrow, ldq, kp, ldkp, D);
    // the mask, on tiles that reach past T or past the warp's first row
    if (key0 + KT > T_len || (causal && key0 + KT - 1 > r0)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + nt * 8 + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          if (key >= T_len || (causal && key > row)) s[nt][e] = kNegInf;
        }
    }
    // the online softmax; a row's scores lie in one quad of lanes
    float cr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - m_new);
          sum += s[nt][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m[h] - m_new);
      l[h] = l[h] * corr + sum;
      m[h] = m_new;
      cr[h] = corr;  // the rescale of O, applied with the tile's P.V
    }
    // O += P.V with P straight from S's fragment: k = t is key 2t,
    // k = t+4 key 2t+1, the pair the V plane holds together
    uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
    for (int kk = 0; kk < NT; ++kk)
      split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3], pb[kk], ps[kk]);
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      if (dn * 8 < D) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NT; ++kk)
          mma3<T>(c, pb[kk], ps[kk],
                  *reinterpret_cast<const uint4*>(vp + kk * 4 * ldvp +
                                                  dn * 32));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[dn][e] = fmaf(acc[dn][e], cr[e >> 1], c[e]);
      }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= T_len) continue;
    const float den = fmaxf(l[h], 1e-30f);
    T* out = o + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      if (dn * 8 < D) {
        out[dn * 8] = from_float<T>(acc[dn][2 * h] / den);
        out[dn * 8 + 1] = from_float<T>(acc[dn][2 * h + 1] / den);
      }
    if (t == 0) lse[(size_t)blockIdx.x * T_len + row] = m[h] + logf(den);
  }
}

// -- K4 ------------------------------------------------------------------

// DT: 8-wide column tiles of the widest head_dim of the class (8 or 16).
// Warp 2i computes S = Q.K^T and P, warp 2i+1 dP = dO.V^T, for the pair's
// 16 rows; they swap P and dP, both form dS, and each adds dS.K into
// half of dQ's column tiles (even ones, odd ones).
template <typename T, int DT>
__global__ void __launch_bounds__(64 * kPairs)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int T_len, int D, int causal, float scale) {
  constexpr int KT = walk_rows(8 * DT);  // keys per K/V tile
  constexpr int NT = KT / 8;
  constexpr int NC = (DT + 1) / 2;  // dQ's column tiles a warp
  constexpr bool F32 = sizeof(T) == 4;  // operands with a small part
  extern __shared__ uint4 smem[];
  const int rows = blockDim.x / 4;  // 16 query rows a pair
  const int lda = ld_res(D), ldr = ld_rows(D), ldp = ld_pairs(D);
  const int ldt = ld_t(D, sizeof(T));
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + rows * lda;
  uint32_t* Kr = reinterpret_cast<uint32_t*>(dOs + rows * lda);
  uint32_t* Vr = Kr + KT * ldr;  // K's and V's (key, dim-pair) planes
  uint32_t* Kp = Vr + KT * ldr;  // K's (key-pair, dim) plane
  float* hand = reinterpret_cast<float*>(Kp + KT / 2 * ldp);  // P, dP
  T* Kt = reinterpret_cast<T*>(hand + 2 * kPairs * handoff_floats(8 * DT));
  T* Vt = Kt + KT * ldt;  // the staged tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1, role = warp & 1;  // role 0: P, 1: dP
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest first, as K3
  const int q0 = qt * rows;
  const int r0 = q0 + 16 * pair;
  const size_t base = (size_t)blockIdx.x * T_len * D;
  int nk = (T_len + KT - 1) / KT;
  if (causal) nk = min(nk, (q0 + rows - 1) / KT + 1);
  const T* kg = k + base;
  const T* vg = v + base;
  issue_tile<T, DT, KT>(Kt, Vt, kg, vg, 0, T_len, D, ldt);
  load_rows_f(Qs, q + base, q0, T_len, D, 1.f, lda, rows);
  load_rows_f(dOs, dout + base, q0, T_len, D, 1.f, lda, rows);
  // lse and delta of rows g (h = 0) and g + 8 (h = 1)
  float ls[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    const size_t at = (size_t)blockIdx.x * T_len + row;
    ls[h] = row < T_len ? lse[at] : 0.f;
    dl[h] = row < T_len ? delta[at] : 0.f;
  }

  float acc[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // the A rows (Q or dO) and B plane (K or V) of this warp's product
  const float* arow = (role ? dOs : Qs) + (16 * pair + g) * lda + 2 * t;
  const uint32_t* br = (role ? Vr : Kr) + g * ldr + 4 * t;
  const uint32_t* kp = Kp + t * ldp + 4 * g;
  float* mine = hand + (2 * pair + role) * handoff_floats(8 * DT);
  const float* theirs = hand + (2 * pair + 1 - role) * handoff_floats(8 * DT);
  for (int j = 0; j < nk; ++j) {
    // tile j has landed, and no warp still reads the planes (or the
    // hand-off buffers) of tile j-1
    cp_async_wait_all();
    __syncthreads();
    split_tile<T, DT, KT>(Kr, Kp, Kt, D, ldt);
    split_tile<T, DT, KT>(Vr, nullptr, Vt, D, ldt);
    __syncthreads();
    if (j + 1 < nk)
      issue_tile<T, DT, KT>(Kt, Vt, kg, vg, j + 1, T_len, D, ldt);
    const int key0 = j * KT;
    if (r0 >= T_len || (causal && key0 > r0 + 15)) continue;
    // S (role 0) or dP (role 1): rows g, g+8 by keys 2t, 2t+1 of each
    // 8-key group
    float x[NT][4], y[NT][4];
    score_tile<DT, NT, F32, F32>(x, arow, lda, br, ldr, D);
    if (role == 0) {
      // P = exp(scale*S - lse), exactly 0 at keys at or past T and past
      // the diagonal (on the tiles that reach them)
      const bool edge = key0 + KT > T_len || (causal && key0 + KT - 1 > r0);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + nt * 8 + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          x[nt][e] = expf(scale * x[nt][e] - ls[e >> 1]);
          if (edge && (key >= T_len || (causal && key > row))) x[nt][e] = 0.f;
        }
    }
    put_frag(mine, x, lane);
    pair_sync(1 + pair);
    get_frag(y, theirs, lane);
    // dS = P*(dP - delta), the same bits in both warps
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = role ? y[nt][e] : x[nt][e];
        const float dp = role ? x[nt][e] : y[nt][e];
        x[nt][e] = p * (dp - dl[e >> 1]);
      }
    // dQ += dS.K on this warp's column tiles, dS straight from its C
    // fragment
    accumulate_tile<NC, NT, 2, F32>(acc, x, kp, ldp, D, role);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= T_len) continue;
    T* out = dq + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int dn = role + 2 * j;
      if (dn * 8 < D) {
        out[dn * 8] = from_float<T>(scale * acc[j][2 * h]);
        out[dn * 8 + 1] = from_float<T>(scale * acc[j][2 * h + 1]);
      }
    }
  }
}

// -- K5 ------------------------------------------------------------------

// Warp 2i computes S^T = K.Q^T, P^T and dV += P^T.dO for the pair's 16
// keys; warp 2i+1 dP^T = V.dO^T, then, given P^T, dS^T and dK +=
// dS^T.Q.
template <typename T, int DT>
__global__ void __launch_bounds__(64 * kPairs)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int T_len, int D, int causal,
                     float scale) {
  constexpr int QT = walk_rows(8 * DT);  // queries per Q/dO tile
  constexpr int NT = QT / 8;
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ uint4 smem[];
  const int keys = blockDim.x / 4;  // 16 a pair
  const int lda = ld_res(D), ldr = ld_rows(D), ldp = ld_pairs(D);
  const int ldt = ld_t(D, sizeof(T));
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + keys * lda;
  uint32_t* Qr = reinterpret_cast<uint32_t*>(Vs + keys * lda);
  uint32_t* dOr = Qr + QT * ldr;  // Q's and dO's (query, dim-pair) planes
  uint32_t* Qp = dOr + QT * ldr;  // their (query-pair, dim) planes
  uint32_t* dOp = Qp + QT / 2 * ldp;
  float* hand = reinterpret_cast<float*>(dOp + QT / 2 * ldp);  // P^T
  T* Qt = reinterpret_cast<T*>(hand + kPairs * handoff_floats(8 * DT));
  T* dOt = Qt + QT * ldt;  // the staged tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1, role = warp & 1;  // role 0: dV, 1: dK
  // all heads' first key tiles (the heaviest when causal) start first
  const int k0 = blockIdx.y * keys;
  const int kw = k0 + 16 * pair;  // the pair's first key
  const size_t base = (size_t)blockIdx.x * T_len * D;
  const float* rowv = (role ? delta : lse) + (size_t)blockIdx.x * T_len;
  const int nq = (T_len + QT - 1) / QT;
  const int first = causal ? k0 / QT : 0;  // no earlier query sees k0 on
  const T* qg = q + base;
  const T* dog = dout + base;
  issue_tile<T, DT, QT>(Qt, dOt, qg, dog, first, T_len, D, ldt);
  load_rows_f(Ks, k + base, k0, T_len, D, 1.f, lda, keys);
  load_rows_f(Vs, v + base, k0, T_len, D, 1.f, lda, keys);

  float acc[DT][4];  // dV (role 0) or dK (role 1)
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  // the A rows (K or V) and B planes of this warp's two products
  const float* arow = (role ? Vs : Ks) + (16 * pair + g) * lda + 2 * t;
  const uint32_t* br = (role ? dOr : Qr) + g * ldr + 4 * t;
  const uint32_t* bp = (role ? Qp : dOp) + t * ldp + 4 * g;
  float* pt = hand + pair * handoff_floats(8 * DT);
  for (int i = first; i < nq; ++i) {
    cp_async_wait_all();
    __syncthreads();
    split_tile<T, DT, QT>(Qr, Qp, Qt, D, ldt);
    split_tile<T, DT, QT>(dOr, dOp, dOt, D, ldt);
    __syncthreads();
    if (i + 1 < nq)
      issue_tile<T, DT, QT>(Qt, dOt, qg, dog, i + 1, T_len, D, ldt);
    const int q0 = i * QT;
    // a pair whose keys all lie past T, or past this tile's last query
    // when causal, is attended by none of it
    if (kw >= T_len || (causal && kw > q0 + QT - 1)) continue;
    // lse (role 0) or delta (role 1) of the lane's queries
    // q0 + 8nt + 2t + u
    float rv[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int qq = q0 + nt * 8 + 2 * t + u;
        rv[nt][u] = qq < T_len ? rowv[qq] : 0.f;
      }
    // S^T (role 0) or dP^T (role 1): keys g, g+8 by queries 2t, 2t+1 of
    // each 8-query group
    float x[NT][4];
    score_tile<DT, NT, F32, F32>(x, arow, lda, br, ldr, D);
    if (role == 0) {
      // P^T, exactly 0 at keys or queries at or past T and past the
      // diagonal (on the tiles that reach them), handed to the partner
      const bool edge = kw + 16 > T_len || q0 + QT > T_len ||
                        (causal && kw + 15 > q0);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + g + 8 * (e >> 1);
          const int qq = q0 + nt * 8 + 2 * t + (e & 1);
          x[nt][e] = expf(scale * x[nt][e] - rv[nt][e & 1]);
          if (edge && (key >= T_len || qq >= T_len || (causal && key > qq)))
            x[nt][e] = 0.f;
        }
      put_frag(pt, x, lane);
      pair_arrive(1 + pair);
    } else {
      // dS^T = P^T*(dP^T - delta)
      float p[NT][4];
      pair_sync(1 + pair);
      get_frag(p, pt, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[nt][e] = p[nt][e] * (x[nt][e] - rv[nt][e & 1]);
    }
    // dV += P^T.dO or dK += dS^T.Q, straight from the C fragment
    accumulate_tile<DT, NT, 1, F32>(acc, x, bp, ldp, D, 0);
  }

  const float mul = role ? scale : 1.f;
  T* out = (role ? dk : dv) + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw + g + 8 * h;
    if (key >= T_len) continue;
    T* o = out + (size_t)key * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
      if (dn * 8 < D) {
        o[dn * 8] = from_float<T>(mul * acc[dn][2 * h]);
        o[dn * 8 + 1] = from_float<T>(mul * acc[dn][2 * h + 1]);
      }
  }
}

// -- K4 and K5 above head_dim 128: the CUDA-core route ---------------------

constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kLdP = kTile + 4;  // row stride of the p / ds tile

// row stride of a float32 resident tile
__host__ __device__ inline int ld_f(int D) { return D + 4; }

// the route's shared memory with `stages` tile buffers
__host__ __device__ inline size_t cc_smem_bytes(int kind, int D, int elt,
                                                int stages) {
  const size_t tile_t = (size_t)kTile * ld_t(D, elt) * elt;
  const size_t tile_f = (size_t)kTile * ld_f(D) * sizeof(float);
  const size_t p = (size_t)kTile * kLdP * sizeof(float);
  const size_t rows = (size_t)kTile * sizeof(float);
  if (kind == kDq) return 2 * tile_f + 2 * rows + 2 * stages * tile_t + p;
  return 2 * tile_f + stages * (2 * tile_t + 2 * rows) + p;
}

__host__ __device__ inline int cc_stages(int kind, int D, int elt) {
  if (cc_smem_bytes(kind, D, elt, 2) <= kMaxSmem) return 2;
  return cc_smem_bytes(kind, D, elt, 1) <= kMaxSmem ? 1 : 0;
}

// 4 consecutive elements as float32 (16 bytes for float, 8 for bf16)
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

// Start the copies of rows [r0, r0 + kTile) of one (T, D) matrix into a
// tile of row stride ld; rows at or past T land as zeros.
template <typename T>
__device__ void issue_rows(T* dst, const T* __restrict__ src, int r0,
                           int T_len, int D) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = D / E;
  const int ld = ld_t(D, sizeof(T));
  for (int c = threadIdx.x; c < kTile * per_row; c += blockDim.x) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * E;
    const bool valid = r0 + r < T_len;
    cp_async16(dst + r * ld + col,
               valid ? src + (size_t)(r0 + r) * D + col : src, valid);
  }
}

// kTile float32 values of one row of lse/delta; past T as zeros
__device__ void load_vec(float* dst, const float* __restrict__ src, int r0,
                         int T_len) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x)
    dst[i] = r0 + i < T_len ? src[r0 + i] : 0.f;
}

// The walk's buffering: with two stages, tile j+1's copies are issued
// before tile j is waited for; with one, each tile is copied and waited
// for in turn.  `issue(j, buf)` starts tile j's copies into buffer buf.
template <typename Issue>
__device__ __forceinline__ int await_tile(int j, int first, int n,
                                          int stages, Issue issue) {
  if (stages == 1) {
    issue(j, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    return 0;
  }
  const int buf = (j - first) & 1;
  if (j + 1 < n) {
    issue(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
  } else {
    cp_async_wait_all();
  }
  __syncthreads();
  return buf;
}

// acc[i][c][:] += sum_k P[r0 + i][k] * X[k][(tx + 16c)*4 + :] over the 64
// keys of a tile: P float32 (stride kLdP), X in T (stride ldx).
template <typename T, int CG>
__device__ __forceinline__ void accumulate_pv(float (&acc)[4][CG][4],
                                              const float* P, int r0,
                                              const T* X, int ldx, int D,
                                              int tx) {
  for (int k = 0; k < kTile; k += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(P + (r0 + i) * kLdP + k, p[i]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const int col = (tx + 16 * c) * 4;
        if (col < D) {
          float x[4];
          load4(X + (k + u) * ldx + col, x);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][c][e] += p[i][u] * x[e];
        }
      }
    }
  }
}

// acc[u][c][:] += sum_r P[r][k0 + u] * X[r][(tx + 16c)*4 + :] over the
// 64 rows of a tile: the transposed product of K5.
template <typename T, int CG>
__device__ __forceinline__ void accumulate_ptx(float (&acc)[4][CG][4],
                                               const float* P, int k0,
                                               const T* X, int ldx, int D,
                                               int tx) {
  for (int r = 0; r < kTile; ++r) {
    float p[4];
    load4(P + r * kLdP + k0, p);
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = (tx + 16 * c) * 4;
      if (col < D) {
        float x[4];
        load4(X + r * ldx + col, x);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][c][e] += p[u] * x[e];
      }
    }
  }
}

// s[i][j] = A[r0 + i] . B[tx + 16j] over D: A rows of one tile, B rows
// of the other; each in float32 or T.
template <typename TA, typename TB>
__device__ __forceinline__ void scores(float (&s)[4][4], const TA* A,
                                       int lda, int r0, const TB* Bm,
                                       int ldb, int tx, int D) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float b[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) load4(Bm + (tx + 16 * j) * ldb + d, b[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a[4];
      load4(A + (r0 + i) * lda + d, a);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j] += a[e] * b[j][e];
    }
  }
}

// CG: float4 column groups a thread, ceil(D / 64)
template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
    flash_dq_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int T_len, int D, int causal, float scale,
                       int stages) {
  extern __shared__ uint4 smem[];
  const int ldt = ld_t(D, sizeof(T));
  const int ldf = ld_f(D);
  const size_t tile_t = (size_t)kTile * ldt;
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kTile * ldf;
  float* lse_s = dOs + kTile * ldf;
  float* delta_s = lse_s + kTile;
  T* kv = reinterpret_cast<T*>(delta_s + kTile);
  T* Ks[2] = {kv, kv + 2 * tile_t};
  T* Vs[2] = {kv + tile_t, kv + 3 * tile_t};
  float* dSs = reinterpret_cast<float*>(kv + 2 * stages * tile_t);

  const int tid = threadIdx.x, tx = tid & 15, r0 = (tid >> 4) * 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kTile;
  const size_t base = (size_t)blockIdx.y * T_len * D;
  const size_t rbase = (size_t)blockIdx.y * T_len;
  const T* kg = k + base;
  const T* vg = v + base;
  int nk = (T_len + kTile - 1) / kTile;
  if (causal) nk = min(nk, qt + 1);
  auto issue = [&](int j, int b) {
    issue_rows(Ks[b], kg, j * kTile, T_len, D);
    issue_rows(Vs[b], vg, j * kTile, T_len, D);
  };
  if (stages == 2) {
    issue(0, 0);
    cp_async_commit();
  }
  load_rows_f(Qs, q + base, q0, T_len, D, 1.f, ldf, kTile);
  load_rows_f(dOs, dout + base, q0, T_len, D, 1.f, ldf, kTile);
  load_vec(lse_s, lse + rbase, q0, T_len);
  load_vec(delta_s, delta + rbase, q0, T_len);

  float acc[4][CG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const int b = await_tile(j, 0, nk, stages, issue);
    float s[4][4], dp[4][4];
    scores(s, Qs, ldf, r0, Ks[b], ldt, tx, D);
    scores(dp, dOs, ldf, r0, Vs[b], ldt, tx, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r0 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = j * kTile + tx + 16 * jj;
        const bool masked = key >= T_len || (causal && key > row);
        const float p =
            masked ? 0.f : expf(scale * s[i][jj] - lse_s[r0 + i]);
        dSs[(r0 + i) * kLdP + tx + 16 * jj] =
            p * (dp[i][jj] - delta_s[r0 + i]);
      }
    }
    __syncthreads();
    accumulate_pv<T, CG>(acc, dSs, r0, Ks[b], ldt, D, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= T_len) continue;
    T* out = dq + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = (tx + 16 * c) * 4;
      if (col < D)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[col + e] = from_float<T>(scale * acc[i][c][e]);
    }
  }
}

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_cc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int T_len, int D, int causal,
                        float scale, int stages) {
  extern __shared__ uint4 smem[];
  const int ldt = ld_t(D, sizeof(T));
  const int ldf = ld_f(D);
  const size_t tile_t = (size_t)kTile * ldt;
  float* Kf = reinterpret_cast<float*>(smem);
  float* Vf = Kf + kTile * ldf;
  float* Ps = Vf + kTile * ldf;  // p, then ds, of the current Q tile
  float* rows = Ps + kTile * kLdP;
  float* lse_s[2] = {rows, rows + 2 * kTile};
  float* delta_s[2] = {rows + kTile, rows + 3 * kTile};
  T* qd = reinterpret_cast<T*>(rows + 2 * stages * kTile);
  T* Qs[2] = {qd, qd + 2 * tile_t};
  T* dOs[2] = {qd + tile_t, qd + 3 * tile_t};

  const int tid = threadIdx.x, tx = tid & 15, r0 = (tid >> 4) * 4;
  const int kt = blockIdx.x;  // heaviest (first) key tiles first
  const int k0 = kt * kTile;
  const size_t base = (size_t)blockIdx.y * T_len * D;
  const size_t rbase = (size_t)blockIdx.y * T_len;
  const T* qg = q + base;
  const T* dog = dout + base;
  const int nq = (T_len + kTile - 1) / kTile;
  const int first = causal ? kt : 0;
  auto issue = [&](int i, int b) {
    issue_rows(Qs[b], qg, i * kTile, T_len, D);
    issue_rows(dOs[b], dog, i * kTile, T_len, D);
    load_vec(lse_s[b], lse + rbase, i * kTile, T_len);
    load_vec(delta_s[b], delta + rbase, i * kTile, T_len);
  };
  if (stages == 2) {
    issue(first, 0);
    cp_async_commit();
  }
  load_rows_f(Kf, k + base, k0, T_len, D, 1.f, ldf, kTile);
  load_rows_f(Vf, v + base, k0, T_len, D, 1.f, ldf, kTile);

  float adk[4][CG][4], adv[4][CG][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[u][c][e] = adv[u][c][e] = 0.f;
  for (int i = first; i < nq; ++i) {
    const int b = await_tile(i, first, nq, stages, issue);
    // s[a][jj]: query row r0 + a of this tile against key tx + 16jj
    float s[4][4], dp[4][4];
    scores(s, Qs[b], ldt, r0, Kf, ldf, tx, D);
    scores(dp, dOs[b], ldt, r0, Vf, ldf, tx, D);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = i * kTile + r0 + a;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = k0 + tx + 16 * jj;
        const bool masked =
            row >= T_len || key >= T_len || (causal && key > row);
        const float p =
            masked ? 0.f : expf(scale * s[a][jj] - lse_s[b][r0 + a]);
        Ps[(r0 + a) * kLdP + tx + 16 * jj] = p;
        s[a][jj] = p * (dp[a][jj] - delta_s[b][r0 + a]);  // ds
      }
    }
    __syncthreads();
    accumulate_ptx<T, CG>(adv, Ps, r0, dOs[b], ldt, D, tx);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        Ps[(r0 + a) * kLdP + tx + 16 * jj] = s[a][jj];
    __syncthreads();
    accumulate_ptx<T, CG>(adk, Ps, r0, Qs[b], ldt, D, tx);
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int key = k0 + r0 + u;
    if (key >= T_len) continue;
    T* ok = dk + base + (size_t)key * D;
    T* ov = dv + base + (size_t)key * D;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = (tx + 16 * c) * 4;
      if (col < D)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ok[col + e] = from_float<T>(scale * adk[u][c][e]);
          ov[col + e] = from_float<T>(adv[u][c][e]);
        }
    }
  }
}

// -- launches ------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out, *lse_out, *dk, *dv;  // out: o of K3, dq of K4
  int BH, T_len, D, causal;
  float scale;
  void* stream;
};

// K4 and K5 take the tensor cores up to head_dim 128, the CUDA cores
// above (see the note)
__host__ __device__ inline bool cc_route(int kind, int D) {
  return kind != kFwd && D > 128;
}

// shared memory of a launch of `kind` at head_dim D, element size elt
// (0 when one block cannot hold its tiles)
inline size_t launch_smem(int kind, int D, int elt) {
  if (cc_route(kind, D)) {
    const int stages = cc_stages(kind, D, elt);
    return stages ? cc_smem_bytes(kind, D, elt, stages) : 0;
  }
  size_t bytes;
  if (kind == kFwd) {
    const int warps = fwd_warps(D, elt);
    if (warps == 0) return 0;
    bytes = fwd_smem_bytes(D, elt, warps);
  } else {
    bytes = kind == kDq ? dq_smem_bytes(D, elt) : dkv_smem_bytes(D, elt);
  }
  return bytes <= kMaxSmem ? bytes : 0;
}

// the CUDA-core route of K4 and K5 (head_dim 136 to 256)
template <typename T>
int launch_cc(int kind, const Args& a) {
  const cudaStream_t st = (cudaStream_t)a.stream;
  const int stages = cc_stages(kind, a.D, sizeof(T));
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = cc_smem_bytes(kind, a.D, sizeof(T), stages);
  const dim3 grid((a.T_len + kTile - 1) / kTile, a.BH);
  cudaError_t err;
  if (kind == kDq) {
    err = mxtpu_port::allow_smem(flash_dq_cc_kernel<T, 4>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_dq_cc_kernel<T, 4><<<grid, kThreads, smem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (T*)a.out, a.T_len, a.D,
        a.causal, a.scale, stages);
  } else {
    err = mxtpu_port::allow_smem(flash_dkv_cc_kernel<T, 4>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_dkv_cc_kernel<T, 4><<<grid, kThreads, smem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (T*)a.dk, (T*)a.dv,
        a.T_len, a.D, a.causal, a.scale, stages);
  }
  return (int)cudaGetLastError();
}

// the tensor-core kernels; DT: 8-wide column tiles of the widest
// head_dim of the class (8, 16, or 32 for K3 only)
template <typename T, int DT>
int launch(int kind, const Args& a) {
  const cudaStream_t st = (cudaStream_t)a.stream;
  const size_t smem = launch_smem(kind, a.D, sizeof(T));
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (kind == kFwd) {
    const int warps = fwd_warps(a.D, sizeof(T));
    const dim3 grid(a.BH, (a.T_len + 16 * warps - 1) / (16 * warps));
    err = mxtpu_port::allow_smem(flash_fwd_kernel<T, DT>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<T, DT><<<grid, 32 * warps, smem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out,
        (float*)a.lse_out, a.T_len, a.D, a.causal, a.scale);
    return (int)cudaGetLastError();
  }
  if constexpr (DT <= 16) {
    const int rows = 16 * kPairs;  // K4's query rows, K5's keys
    const dim3 grid(a.BH, (a.T_len + rows - 1) / rows);
    if (kind == kDq) {
      err = mxtpu_port::allow_smem(flash_dq_kernel<T, DT>, smem);
      if (err != cudaSuccess) return (int)err;
      flash_dq_kernel<T, DT><<<grid, 4 * rows, smem, st>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (T*)a.out, a.T_len,
          a.D, a.causal, a.scale);
    } else {
      err = mxtpu_port::allow_smem(flash_dkv_kernel<T, DT>, smem);
      if (err != cudaSuccess) return (int)err;
      flash_dkv_kernel<T, DT><<<grid, 4 * rows, smem, st>>>(
          (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
          (const float*)a.lse, (const float*)a.delta, (T*)a.dk, (T*)a.dv,
          a.T_len, a.D, a.causal, a.scale);
    }
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(int kind, const Args& a) {
  if (a.D % 8 || a.D > 256 || a.T_len < 1) return (int)cudaErrorInvalidValue;
  if (cc_route(kind, a.D)) return launch_cc<T>(kind, a);
  if (a.D <= 64) return launch<T, 8>(kind, a);
  if (a.D <= 128) return launch<T, 16>(kind, a);
  return launch<T, 32>(kind, a);
}

}  // namespace

extern "C" {

// Whether one block's shared memory holds the tiles of a launch of
// `kind` (0 fwd, 1 dq, 2 dkv) at head_dim D and element size elt: 1 or
// 0
int mxtpu_flash_fits(int kind, int D, int elt) {
  return launch_smem(kind, D, elt) ? 1 : 0;
}

#define MXTPU_FLASH_ENTRIES(SUFFIX, TYPE)                                    \
  int mxtpu_flash_fwd_##SUFFIX(const void* q, const void* k, const void* v, \
                               void* o, void* lse, int BH, int T_len, int D, \
                               int causal, float scale, void* stream) {     \
    Args a = {q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, \
              BH, T_len, D, causal, scale, stream};                         \
    return dispatch<TYPE>(kFwd, a);                                          \
  }                                                                          \
  int mxtpu_flash_dq_##SUFFIX(const void* q, const void* k, const void* v,  \
                              const void* dout, const void* lse,             \
                              const void* delta, void* dq, int BH,           \
                              int T_len, int D, int causal, float scale,     \
                              void* stream) {                                \
    Args a = {q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr,     \
              BH, T_len, D, causal, scale, stream};                         \
    return dispatch<TYPE>(kDq, a);                                           \
  }                                                                          \
  int mxtpu_flash_dkv_##SUFFIX(const void* q, const void* k, const void* v, \
                               const void* dout, const void* lse,            \
                               const void* delta, void* dk, void* dv,        \
                               int BH, int T_len, int D, int causal,         \
                               float scale, void* stream) {                  \
    Args a = {q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv,          \
              BH, T_len, D, causal, scale, stream};                         \
    return dispatch<TYPE>(kDkv, a);                                          \
  }

MXTPU_FLASH_ENTRIES(f32, float)
MXTPU_FLASH_ENTRIES(bf16, __nv_bfloat16)

}  // extern "C"
