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
// replace no Pallas kernel: XLA ran these ops on the TPU.  They exist
// because PyTorch's library kernels pick their layout by the row count
// (cuBLAS a split-K kernel at the decode step's 8 rows and another at a
// verify window's 8W rows; the mean's reduction, see G2 below), so a
// window lane and the step at its position rounded the same row
// otherwise, and bfloat16 speculative streams parted from plain ones at
// logit ties.
//
// G1's guarantee, by construction: a row's result depends only on that
// row of x and on w, never on M or on the other rows.  The tile shapes,
// the order of the K walk and the split of K depend on K and N alone;
// rows never meet (each output element is one dot product accumulated
// in a fixed order), and the rows of a tile past M are zero-filled and
// never stored.
//
// bfloat16 (rows_linear_bf16_kernel): one block of 4 warps per (64-column
// N tile, 64-row M chunk, K split).  K is walked in 64-deep slices
// through a 4-stage cp.async ring in shared memory (16-byte copies, rows
// padded by 16 bytes so the fragment reads hit distinct banks); each warp
// owns 16 columns and runs mma.sync m16n8k16 (bf16 in, float32
// accumulators) on every 16-row tile of the chunk that holds a row below
// M.  The blocks of one N tile are adjacent in the grid, so a weight tile
// read by the first M chunk is found in L2 by the others; at M <= 64 it
// is read once.  The split count S (kernel splits()) depends on N and K
// only: enough blocks to fill the 132 SMs when N is small (out_proj and
// down_proj, N = 4096), one when N is large (lm_head).  With S > 1 each
// split writes its float32 partial sums to a workspace and
// rows_linear_reduce adds them in split order, then rounds once to
// bfloat16; with S = 1 the block rounds and stores itself.
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
//
// Bound on the H100: bytes at the decode step's M = 8 (every weight read
// once, 15 GB per 8B step, ~4.5 ms), operations only at M in the
// thousands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;              // output columns per block
constexpr int kBM = 64;              // rows per M chunk
constexpr int kBK = 64;              // K slice (bf16 elements)
constexpr int kLd = kBK + 8;         // padded smem row, 144 bytes
constexpr int kStages = 4;
constexpr int kThreads = 128;        // 4 warps x 16 columns
constexpr int kTargetBlocks = 512;   // ~4 per SM on 132 SMs
constexpr int kMinSlices = 4;        // K slices per split, at least
constexpr size_t kSmem = (size_t)kStages * (kBN + kBM) * kLd * 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// K splits of a (N, K) bf16 product: a function of N and K alone.
__host__ __device__ inline int splits(int N, int K) {
  const int ntiles = (N + kBN - 1) / kBN;
  const int slices = (K + kBK - 1) / kBK;
  int s = (kTargetBlocks + ntiles - 1) / ntiles;
  const int cap = slices / kMinSlices > 1 ? slices / kMinSlices : 1;
  return s < cap ? s : cap;
}

// Start the copies of K slice `slice` of the block's weight tile and of
// its chunk's rows (only the 16-row tiles that hold a row below M);
// elements past N, M or K land as zeros.
__device__ void start_slice(__nv_bfloat16* ws, __nv_bfloat16* xs,
                            const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w, int n0,
                            int m0, int rows, int slice, int N, int K) {
  const int k0 = slice * kBK;
  constexpr int per_row = kBK / 8;   // 16-byte copies per row
  for (int c = threadIdx.x; c < kBN * per_row; c += kThreads) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * 8;
    const bool valid = n0 + r < N && k0 + col < K;
    cp_async16(ws + r * kLd + col,
               valid ? w + (size_t)(n0 + r) * K + k0 + col : w, valid);
  }
  const int tiles = (rows + 15) / 16;
  for (int c = threadIdx.x; c < tiles * 16 * per_row; c += kThreads) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * 8;
    const bool valid = r < rows && k0 + col < K;
    cp_async16(xs + r * kLd + col,
               valid ? x + (size_t)(m0 + r) * K + k0 + col : x, valid);
  }
}

__global__ void __launch_bounds__(kThreads)
    rows_linear_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* __restrict__ y,
                            float* __restrict__ partial, int M, int N,
                            int K, int S) {
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int mchunks = (M + kBM - 1) / kBM;
  const int ntile = blockIdx.x / mchunks;
  const int n0 = ntile * kBN;
  const int m0 = (blockIdx.x - ntile * mchunks) * kBM;
  const int rows = min(kBM, M - m0);
  const int mtiles = (rows + 15) / 16;
  const int split = blockIdx.y;
  const int slices = (K + kBK - 1) / kBK;
  // split s walks slices [s*slices/S, (s+1)*slices/S), in order
  const int s_begin = (int)((long long)split * slices / S);
  const int s_end = (int)((long long)(split + 1) * slices / S);
  const int nk = s_end - s_begin;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row / column group
  const int t = lane % 4;   // fragment k pair

  float acc[kBM / 16][2][4];
#pragma unroll
  for (int i = 0; i < kBM / 16; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto wbuf = [&](int st) { return smem + (size_t)st * (kBN + kBM) * kLd; };
  auto xbuf = [&](int st) { return wbuf(st) + kBN * kLd; };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk)
      start_slice(wbuf(st), xbuf(st), x, w, n0, m0, rows, s_begin + st, N,
                  K);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < nk)
      start_slice(wbuf(next % kStages), xbuf(next % kStages), x, w, n0, m0,
                  rows, s_begin + next, N, K);
    cp_async_commit();
    const __nv_bfloat16* ws = wbuf(i % kStages);
    const __nv_bfloat16* xs = xbuf(i % kStages);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* p = ws + (warp * 16 + j * 8 + g) * kLd + kk +
                                 2 * t;
        b[j][0] = *reinterpret_cast<const unsigned*>(p);
        b[j][1] = *reinterpret_cast<const unsigned*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < kBM / 16; ++mt) {
        if (mt < mtiles) {
          const __nv_bfloat16* p = xs + (mt * 16 + g) * kLd + kk + 2 * t;
          unsigned a[4];
          a[0] = *reinterpret_cast<const unsigned*>(p);
          a[1] = *reinterpret_cast<const unsigned*>(p + 8 * kLd);
          a[2] = *reinterpret_cast<const unsigned*>(p + 8);
          a[3] = *reinterpret_cast<const unsigned*>(p + 8 * kLd + 8);
          mma_bf16(acc[mt][0], a, b[0]);
          mma_bf16(acc[mt][1], a, b[1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator e of (mt, j): row mt*16 + g (+8 for e >= 2), column
  // warp*16 + j*8 + 2t (+1 for odd e)
#pragma unroll
  for (int mt = 0; mt < kBM / 16; ++mt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + warp * 16 + j * 8 + 2 * t + (e & 1);
        if (r < rows && n < N) {
          const size_t o = (size_t)(m0 + r) * N + n;
          if (S == 1)
            y[o] = __float2bfloat16(acc[mt][j][e]);
          else
            partial[(size_t)split * M * N + o] = acc[mt][j][e];
        }
      }
    }
  }
}

// y = bf16(sum over splits s = 0, 1, ..., S-1 of partial[s]), in order.
__global__ void rows_linear_reduce(const float* __restrict__ partial,
                                   __nv_bfloat16* __restrict__ y,
                                   size_t MN, int S) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = partial[i];
    for (int k = 1; k < S; ++k) s += partial[(size_t)k * MN + i];
    y[i] = __float2bfloat16(s);
  }
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

}  // namespace

extern "C" {

// K splits of a bf16 (N, K) weight; the wrapper allocates an (S, M, N)
// float32 workspace when S > 1.
int mxtpu_rows_linear_splits(int N, int K) { return splits(N, K); }

int mxtpu_rows_linear_bf16(const void* x, const void* w, void* y,
                           void* partial, int M, int N, int K, void* stream) {
  const int S = splits(N, K);
  if (S > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rows_linear_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int mchunks = (M + kBM - 1) / kBM;
  const dim3 grid(((N + kBN - 1) / kBN) * mchunks, S);
  rows_linear_bf16_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y,
      (float*)partial, M, N, K, S);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const size_t MN = (size_t)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  rows_linear_reduce<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (__nv_bfloat16*)y, MN, S);
  return (int)cudaGetLastError();
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
