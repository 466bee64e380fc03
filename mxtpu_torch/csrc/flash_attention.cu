// Flash attention forward and its FlashAttention-2 backward, for Hopper
// (sm_90a): three kernels, one per Pallas TPU kernel of
// mxtpu/ops/pallas/flash_attention.py.
//
//   flash_fwd_kernel  replaces _fwd_kernel (K3): o = softmax(q.k^T*scale).v
//                     with the online softmax, plus the per-row
//                     logsumexp lse;
//   flash_dq_kernel   replaces _dq_kernel (K4): dq = scale * sum_k ds.k,
//                     ds = p*(dO.v^T - delta), p = exp(s - lse);
//   flash_dkv_kernel  replaces _dkv_kernel (K5): dv = sum_q p^T.dO and
//                     dk = scale * sum_q ds^T.q.
//
// Operands are (B*H, T, D) row-major; lse and delta (B*H, T) float32;
// delta = rowsum(dO*O) comes from the caller, as the reference computes
// it in XLA outside the kernels.
//
// Design.  On the TPU a grid step carried the online-softmax state (or a
// gradient sum) in VMEM scratch to the next step of the sequential grid
// axis.  Blocks on the card run in parallel and in no order, so the
// sequential axis is a loop inside one block: K3 and K4 run one block of
// 256 threads per (b*h, 64-row query tile) and walk 64-key K/V tiles;
// K5 runs one block per (b*h, 64-key tile) and walks 64-row Q/dO tiles,
// from the diagonal on when causal.  No block writes what another reads,
// so nothing needs atomics.  The block's resident tile is converted to
// float32 once (queries pre-scaled in K3, as the Pallas forward does);
// the walked tiles are copied 16 bytes a thread with cp.async, double-
// buffered where shared memory allows (every float32 and bfloat16 shape
// up to head_dim 128), so the copies of tile j+1 run while the block
// computes on tile j.  Each thread owns a 4x4 patch of the 64x64 score
// tile (4 rows, keys tx + 16j) and 4 rows by ceil(D/64) float4 columns of
// the output; the probabilities (or ds) go through shared memory between
// the two products.  Each kernel masks the ragged edge itself (rows and
// keys at or past T) instead of padding in the wrapper.
//
// Arithmetic: the Pallas kernels' in float32 — masked scores at -1e30,
// p = exp(s - m) in the forward with l = l*corr + sum p, the output
// acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)); in the backward
// s = scale * (q.k), p = exp(s - lse), ds = p*(dp - delta), dq and dk
// scaled by `scale` once at the end.  Products run as true float32 FMAs
// on the CUDA cores (no TF32), as the reference's HIGHEST precision
// asks; bfloat16 operands are read as float32 and the results rounded
// once.
//
// Bound on the H100 at the training path's shape (B*H = 32, T = 2048,
// D = 128, causal, float32): operations.  Counting the causal half of the
// score tile, K3 does 4*D flops per attended (row, key) pair (34.4
// GFLOP), K4 6*D (51.5 GFLOP) and K5 8*D (68.7 GFLOP): 0.51, 0.77 and
// 1.03 ms at the 67 TFLOP/s float32 peak, against ~0.04 ms to move K3's
// 134 MB.  This version stays on the CUDA cores and on one block per SM
// (its shared memory); tensor-core tiles (wgmma on bf16, or 3xTF32 for
// float32) and TMA loads are the next steps.

#include "paged_common.cuh"

namespace {

using mxtpu_port::cp_async16;
using mxtpu_port::cp_async_commit;
using mxtpu_port::cp_async_wait_all;
using mxtpu_port::cp_async_wait_one;
using mxtpu_port::from_float;
using mxtpu_port::kMaxSmem;
using mxtpu_port::kNegInf;
using mxtpu_port::to_float;

constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kLdP = kTile + 4;  // row stride of the p / ds tile

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// row stride, in elements, of a tile staged in T (16 bytes of padding
// keep the rows of neighbouring keys in different banks)
__host__ __device__ inline int ld_t(int D, int elt) { return D + 16 / elt; }
// row stride of a float32 resident tile
__host__ __device__ inline int ld_f(int D) { return D + 4; }

__host__ __device__ inline size_t smem_bytes(int kind, int D, int elt,
                                             int stages) {
  const size_t tile_t = (size_t)kTile * ld_t(D, elt) * elt;
  const size_t tile_f = (size_t)kTile * ld_f(D) * sizeof(float);
  const size_t p = (size_t)kTile * kLdP * sizeof(float);
  const size_t rows = (size_t)kTile * sizeof(float);
  if (kind == kFwd) return tile_f + 2 * stages * tile_t + p;
  if (kind == kDq) return 2 * tile_f + 2 * rows + 2 * stages * tile_t + p;
  return 2 * tile_f + stages * (2 * tile_t + 2 * rows) + p;
}

__host__ __device__ inline int stages_for(int kind, int D, int elt) {
  if (smem_bytes(kind, D, elt, 2) <= kMaxSmem) return 2;
  return smem_bytes(kind, D, elt, 1) <= kMaxSmem ? 1 : 0;
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

// Rows [r0, r0 + kTile) of one (T, D) matrix into a float32 tile of
// row stride ld_f(D), times `scale`; rows at or past T as zeros.
template <typename T>
__device__ void load_rows_f(float* dst, const T* __restrict__ src, int r0,
                            int T_len, int D, float scale) {
  const int ld = ld_f(D);
  for (int i = threadIdx.x; i < kTile * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    dst[r * ld + d] =
        r0 + r < T_len ? to_float(src[(size_t)(r0 + r) * D + d]) * scale
                       : 0.f;
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

// sum / max over the 16 threads that share a row (one half-warp)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// s[i][j] = A[r0 + i] . B[tx + 16j] (and, with two pairs, t[i][j] =
// C[r0 + i] . E[tx + 16j]) over D: A, C rows of one tile, B, E rows of
// the other; each in float32 or T.
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

// -- K3 ------------------------------------------------------------------

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int T_len, int D, int causal,
                     float scale, int stages) {
  extern __shared__ uint4 smem[];
  const int ldt = ld_t(D, sizeof(T));
  const int ldf = ld_f(D);
  const size_t tile_t = (size_t)kTile * ldt;
  float* Qs = reinterpret_cast<float*>(smem);
  T* kv = reinterpret_cast<T*>(Qs + kTile * ldf);
  T* Ks[2] = {kv, kv + 2 * tile_t};
  T* Vs[2] = {kv + tile_t, kv + 3 * tile_t};
  float* Ps = reinterpret_cast<float*>(kv + 2 * stages * tile_t);

  const int tid = threadIdx.x, tx = tid & 15, r0 = (tid >> 4) * 4;
  // heaviest (last) query tiles first: a causal walk grows with the tile
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kTile;
  const size_t base = (size_t)blockIdx.y * T_len * D;
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
  load_rows_f(Qs, q + base, q0, T_len, D, scale);

  float m[4], l[4], acc[4][CG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  for (int j = 0; j < nk; ++j) {
    const int b = await_tile(j, 0, nk, stages, issue);
    float s[4][4];
    scores(s, Qs, ldf, r0, Ks[b], ldt, tx, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = j * kTile + tx + 16 * jj;
        if (key >= T_len || (causal && key > row)) s[i][jj] = kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        Ps[(r0 + i) * kLdP + tx + 16 * jj] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncthreads();
    accumulate_pv<T, CG>(acc, Ps, r0, Vs[b], ldt, D, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= T_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = (tx + 16 * c) * 4;
      if (col < D)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[col + e] = from_float<T>(acc[i][c][e] / den);
    }
    if (tx == 0)
      lse[(size_t)blockIdx.y * T_len + row] = m[i] + logf(den);
  }
}

// -- K4 ------------------------------------------------------------------

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int T_len, int D, int causal, float scale, int stages) {
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
  load_rows_f(Qs, q + base, q0, T_len, D, 1.f);
  load_rows_f(dOs, dout + base, q0, T_len, D, 1.f);
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

// -- K5 ------------------------------------------------------------------

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  load_rows_f(Kf, k + base, k0, T_len, D, 1.f);
  load_rows_f(Vf, v + base, k0, T_len, D, 1.f);

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

template <typename T, int CG>
int launch(int kind, const Args& a) {
  const int stages = stages_for(kind, a.D, sizeof(T));
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(kind, a.D, sizeof(T), stages);
  const dim3 grid((a.T_len + kTile - 1) / kTile, a.BH);
  const cudaStream_t st = (cudaStream_t)a.stream;
  cudaError_t err;
  if (kind == kFwd) {
    err = mxtpu_port::allow_smem(flash_fwd_kernel<T, CG>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<T, CG><<<grid, kThreads, smem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out,
        (float*)a.lse_out, a.T_len, a.D, a.causal, a.scale, stages);
  } else if (kind == kDq) {
    err = mxtpu_port::allow_smem(flash_dq_kernel<T, CG>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_dq_kernel<T, CG><<<grid, kThreads, smem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (T*)a.out, a.T_len, a.D,
        a.causal, a.scale, stages);
  } else {
    err = mxtpu_port::allow_smem(flash_dkv_kernel<T, CG>, smem);
    if (err != cudaSuccess) return (int)err;
    flash_dkv_kernel<T, CG><<<grid, kThreads, smem, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (T*)a.dk, (T*)a.dv,
        a.T_len, a.D, a.causal, a.scale, stages);
  }
  return (int)cudaGetLastError();
}

// float4 column groups per thread: ceil(D / 64)
template <typename T>
int dispatch(int kind, const Args& a) {
  if (a.D % 8 || a.D > 256 || a.T_len < 1) return (int)cudaErrorInvalidValue;
  if (a.D <= 64) return launch<T, 1>(kind, a);
  if (a.D <= 128) return launch<T, 2>(kind, a);
  return launch<T, 4>(kind, a);
}

}  // namespace

extern "C" {

// tile buffers a launch of `kind` (0 fwd, 1 dq, 2 dkv) uses at head_dim
// D and element size elt: 2, 1, or 0 when one block's shared memory
// cannot hold the tiles
int mxtpu_flash_stages(int kind, int D, int elt) {
  return stages_for(kind, D, elt);
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
