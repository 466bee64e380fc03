// The backward of a 3x3, stride-1, pad-1 convolution for Hopper (sm_90a):
// both gradients behind one call, replacing the Pallas TPU kernel
// _bwd_kernel of mxtpu/ops/pallas/conv_bwd.py (K6).
//
//   dX[n,ci,h,w]  = sum_{kh,kw,co} dY[n,co,h+1-kh,w+1-kw] * W[co,ci,kh,kw]
//   dW[co,ci,kh,kw] = sum_{n,h,w} dY[n,co,h,w] * X[n,ci,h+kh-1,w+kw-1]
//
// with X and dY zero outside the image.  Operands keep PyTorch's layouts:
// x (N, Ci, H, W), dy (N, Co, H, W), dx (N, Ci, H, W), dw (Co, Ci, 3, 3);
// the wrapper also passes wt = W permuted to (3, 3, Co, Ci) (a small
// tensor), so that a row of the dX product's second operand is contiguous.
//
// Design.  The TPU kernel walks images in a sequential grid and adds each
// image's nine dW products into one VMEM block in place.  Blocks on the
// card run in parallel and in no order, so the two gradients become two
// implicit-GEMM kernels that share nothing, and dW's reduction over
// images is split across blocks and summed by a third kernel:
//
//   conv_dx_kernel   one block per (64-pixel tile, 64-channel Ci tile):
//                    C[pixel][ci] over K = 9 taps x Co, the dY operand
//                    gathered at the tap's shifted pixel (0 off the image);
//   conv_dw_kernel   one block per (64 Ci, 64 Co, tap, pixel split):
//                    C[ci][co] over K = its split's share of the N*H*W
//                    pixels, written to a float32 workspace of its own;
//   conv_dw_reduce   sums the splits in a fixed order and writes dw in the
//                    weight's dtype, so the result is deterministic and
//                    no block writes what another reads (no atomics).
//
// Both products run one 256-thread block on a 64x64 output tile: 16-deep
// K slices of both operands go through shared memory (double-buffered,
// the next slice's loads in registers while the block computes on the
// current one) and each thread accumulates a 4x4 patch in float32 with
// true FMAs on the CUDA cores (no TF32, the reference's HIGHEST
// precision).  bfloat16 operands are widened to float32 on their way into
// shared memory and the results rounded once.  Global loads are scalar
// and masked, so any N, H, W, Ci and Co work: neighbouring threads read
// neighbouring pixels (dW, dX's dY operand) or channels (dX's weights).
//
// Bound on the H100: operations.  The two products are 4*N*H*W*9*Ci*Co
// flops (5.92e10 at ResNet-50's (128, 64, 56, 56) stage shape, 0.88 ms at
// the 67 TFLOP/s float32 peak) against ~0.09 ms to move x, dy, dx and dw
// once.  This version reads dY in both kernels and X once per tap (from
// L2); tensor-core tiles (wgmma on bf16, 3xTF32 for float32), TMA loads
// and one pass over dY for both gradients are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;       // output tile rows
constexpr int kBN = 64;       // output tile columns
constexpr int kBK = 16;       // K slice
constexpr int kThreads = 256;
constexpr int kPad = 4;       // keeps rows 16-byte aligned, spreads banks

struct Slice {
  float a[kBK][kBM + kPad];   // a[k][m]
  float b[kBK][kBN + kPad];   // b[k][n]
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as .to(bfloat16)
}

// acc[i][j] += sum_k a[k][4*tx + i] * b[k][4*ty + j]
__device__ __forceinline__ void multiply(const Slice& s, int tx, int ty,
                                         float acc[4][4]) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&s.a[k][tx * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&s.b[k][ty * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The K loop shared by both products: `load(step, ra, rb)` fetches the
// thread's 4 + 4 elements of slice `step` into registers, `put(slice, ra,
// rb)` writes them to shared memory.
template <typename Load, typename Put>
__device__ __forceinline__ void k_loop(int steps, Slice* s, int tx, int ty,
                                       float acc[4][4], Load load, Put put) {
  float ra[4], rb[4];
  load(0, ra, rb);
  put(s[0], ra, rb);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    const bool more = step + 1 < steps;
    if (more) load(step + 1, ra, rb);
    multiply(s[cur], tx, ty, acc);
    if (more) put(s[cur ^ 1], ra, rb);
    __syncthreads();
  }
}

// dX: C[m = pixel][n = ci] = sum_{tap, co} dY(shifted)[m][co] * wt[tap][co][n]
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dx_kernel(const T* __restrict__ dy, const T* __restrict__ wt,
               T* __restrict__ dx, int N, int H, int W, int Ci, int Co) {
  __shared__ __align__(16) Slice s[2];
  const int HW = H * W;
  const long long M = (long long)N * HW;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  // loads: column t % 64 of the tile, K rows t / 64 + 4i
  const int lc = t % kBM, lr = t / kBM;
  const long long am = m0 + lc;
  const bool a_in = am < M;
  int an = 0, ah = 0, aw = 0;
  if (a_in) {
    an = (int)(am / HW);
    const int p = (int)(am % HW);
    ah = p / W;
    aw = p % W;
  }
  const int bn = n0 + lc;
  const bool b_in = bn < Ci;
  const int co_slices = (Co + kBK - 1) / kBK;

  auto load = [&](int step, float* ra, float* rb) {
    const int tap = step / co_slices;
    const int co0 = (step % co_slices) * kBK;
    const int hs = ah + 1 - tap / 3, ws = aw + 1 - tap % 3;
    const bool ok = a_in && hs >= 0 && hs < H && ws >= 0 && ws < W;
    const long long a_off = (long long)an * Co * HW + hs * W + ws;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int co = co0 + lr + 4 * i;
      ra[i] = ok && co < Co ? to_f(dy[a_off + (long long)co * HW]) : 0.f;
      rb[i] = b_in && co < Co
                  ? to_f(wt[((long long)tap * Co + co) * Ci + bn])
                  : 0.f;
    }
  };
  auto put = [&](Slice& d, const float* ra, const float* rb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d.a[lr + 4 * i][lc] = ra[i];
      d.b[lr + 4 * i][lc] = rb[i];
    }
  };

  float acc[4][4] = {};
  k_loop(9 * co_slices, s, tx, ty, acc, load, put);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + tx * 4 + i;
    if (m >= M) continue;
    const long long img = m / HW, p = m % HW;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + ty * 4 + j;
      if (ci < Ci) dx[(img * Ci + ci) * HW + p] = from_f<T>(acc[i][j]);
    }
  }
}

// dW, one split: ws[split][tap][co][ci] = sum over the split's pixels of
// X(shifted by tap)[pixel][ci] * dY[pixel][co]
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               float* __restrict__ ws, int N, int H, int W, int Ci, int Co,
               int chunk) {
  __shared__ __align__(16) Slice s[2];
  const int HW = H * W;
  const long long K = (long long)N * HW;
  const int m0 = blockIdx.x * kBM;   // ci
  const int n0 = blockIdx.y * kBN;   // co
  const int tap = blockIdx.z % 9, split = blockIdx.z / 9;
  const int dh = tap / 3 - 1, dw = tap % 3 - 1;
  const long long k_begin = (long long)split * chunk;
  const long long k_end = k_begin + chunk < K ? k_begin + chunk : K;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  // loads: K row t % 16 (a pixel), tile columns t / 16 + 16i (channels)
  const int lk = t % kBK, lc = t / kBK;

  auto load = [&](int step, float* ra, float* rb) {
    const long long pix = k_begin + (long long)step * kBK + lk;
    const bool valid = pix < k_end;
    long long img = 0;
    int h = 0, w = 0;
    if (valid) {
      img = pix / HW;
      const int p = (int)(pix % HW);
      h = p / W;
      w = p % W;
    }
    const int hs = h + dh, wsft = w + dw;
    const bool x_ok = valid && hs >= 0 && hs < H && wsft >= 0 && wsft < W;
    const long long x_off = img * Ci * HW + hs * W + wsft;
    const long long y_off = img * Co * HW + h * W + w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = m0 + lc + 16 * i, co = n0 + lc + 16 * i;
      ra[i] = x_ok && ci < Ci ? to_f(x[x_off + (long long)ci * HW]) : 0.f;
      rb[i] = valid && co < Co ? to_f(dy[y_off + (long long)co * HW]) : 0.f;
    }
  };
  auto put = [&](Slice& d, const float* ra, const float* rb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d.a[lk][lc + 16 * i] = ra[i];
      d.b[lk][lc + 16 * i] = rb[i];
    }
  };

  float acc[4][4] = {};
  const int steps = (int)((k_end - k_begin + kBK - 1) / kBK);
  if (steps > 0) k_loop(steps, s, tx, ty, acc, load, put);

  float* out = ws + ((long long)split * 9 + tap) * Co * Ci;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = n0 + ty * 4 + j;
    if (co >= Co) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = m0 + tx * 4 + i;
      if (ci < Ci) out[(long long)co * Ci + ci] = acc[i][j];
    }
  }
}

// dw[co][ci][kh][kw] = sum over splits, in order, of ws[split][tap][co][ci]
template <typename T>
__global__ void conv_dw_reduce(const float* __restrict__ ws,
                               T* __restrict__ dw, int splits, int Ci,
                               int Co) {
  const int total = Co * Ci * 9;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int tap = idx % 9, ci = (idx / 9) % Ci, co = idx / (9 * Ci);
  const long long stride = 9LL * Co * Ci;
  const float* p = ws + ((long long)tap * Co + co) * Ci + ci;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += p[sp * stride];
  dw[idx] = from_f<T>(sum);
}

template <typename T>
int launch(const void* x, const void* dy, const void* wt, void* dx, void* dw,
           void* ws, int N, int H, int W, int Ci, int Co, int splits,
           int chunk, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || splits < 1 ||
      chunk < 1 || (long long)splits * chunk < (long long)N * H * W)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long M = (long long)N * H * W;
  const dim3 gx((unsigned)((M + kBM - 1) / kBM), (Ci + kBN - 1) / kBN);
  conv_dx_kernel<T><<<gx, kThreads, 0, st>>>(
      (const T*)dy, (const T*)wt, (T*)dx, N, H, W, Ci, Co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gw((Ci + kBM - 1) / kBM, (Co + kBN - 1) / kBN, 9 * splits);
  conv_dw_kernel<T><<<gw, kThreads, 0, st>>>(
      (const T*)x, (const T*)dy, (float*)ws, N, H, W, Ci, Co, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = Co * Ci * 9;
  conv_dw_reduce<T><<<(total + 255) / 256, 256, 0, st>>>(
      (const float*)ws, (T*)dw, splits, Ci, Co);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define MXTPU_CONV_BWD_ENTRY(SUFFIX, TYPE)                                    \
  int mxtpu_conv_bwd_##SUFFIX(const void* x, const void* dy, const void* wt, \
                              void* dx, void* dw, void* ws, int N, int H,    \
                              int W, int Ci, int Co, int splits, int chunk,  \
                              void* stream) {                                \
    return launch<TYPE>(x, dy, wt, dx, dw, ws, N, H, W, Ci, Co, splits,     \
                        chunk, stream);                                      \
  }

MXTPU_CONV_BWD_ENTRY(f32, float)
MXTPU_CONV_BWD_ENTRY(bf16, __nv_bfloat16)

#undef MXTPU_CONV_BWD_ENTRY

}  // extern "C"
