// Q1 and Q2: the int8 x int8 products of post-training quantization on
// the tensor cores of Hopper (sm_90a), int32 sums, float32 out.
//
//   Q1 qconv_kernel  out[n,o,oh,ow] = scale * sum_{c,r,s} x[n,c,ih,iw] *
//                    w[o,c,r,s] (+ bias[o]), ih = oh*sh - ph + r*dh,
//                    iw = ow*sw - pw + s*dw, x zero outside the image,
//                    c within o's group
//   Q2 qfc_kernel    out[m,n] = scale * sum_k x[m,k] * w[n,k] (+ bias[n])
//
// They replace no pallas_call: the reference runs quantized_conv and
// quantized_fully_connected (mxtpu/contrib/quantization.py:81, :62) as
// XLA's int8 conv_general_dilated and dot_general with
// preferred_element_type=int32.  Operands keep the reference's layouts:
// x NCHW int8 and OIHW int8 weights (Q1; the weights as (C_out, K
// padded to 32), see below), x (M, K) and w (N, K) int8 (Q2); out is
// NCHW or (M, N) float32.
//
// Arithmetic.  Every product of two int8 values and every sum of them is
// exact in int32 (|acc| <= K * 127^2 < 2^31 for K < 133,000; ResNet-50's
// largest K is 4608), so the order of the sums does not matter and the
// int32 result is the reference's.  The epilogue is the reference's in
// its order, each step rounded once: __int2float_rn(acc), __fmul_rn by
// the combined scale (s_x * s_w, a float32 scalar the wrapper computes
// on the device, so nothing waits on the host), then __fadd_rn of the
// bias.  The intrinsics keep nvcc from contracting the two into an FMA,
// so the result is bit for bit the plain version's (separate torch ops).
//
// Bounds on the H100.  ResNet-50 at batch 128: a 3x3 stage-1 conv
// (128, 64, 56, 56) -> 64 does 2 * 401,408 * 64 * 576 = 2.96e10 int8
// operations, 0.015 ms at the 1979 TOP/s int8 peak; it reads 25.7 MB of
// x and writes 102.8 MB of float32 output, 0.038 ms at 3.35 TB/s.  Most
// of the net's convs are bound by the float32 output they write.
//
// Design: an implicit GEMM, the simple form.  C (M x Ng) with M =
// N*OH*OW output pixels and Ng = C_out / groups channels of a group,
// K = C_in / groups * kh * kw in the weights' (c, r, s) order; the grid
// is (M tiles, Ng tiles, groups).  A block of 4 warps (2 x 2) owns a
// BM x BN tile of C and walks K in 64-byte steps:
//   - A, the im2col gather (Q1, BM = 128): each thread owns one output
//     pixel and gathers its 64 bytes of a step byte by byte,
//     stepping (c, r, s) incrementally; neighbouring threads are
//     neighbouring pixels, so each byte load is coalesced across the
//     warp.  Image borders, the pixel tail and the K tail are exact
//     zeros.  Q2's rows and both kernels' weight rows are 16-byte
//     cp.async copies, zero-filled past the rows or K; the wrapper pads
//     every such row to a multiple of 32 bytes (ops/quantized.py:
//     pack_weight), a view where it already is one.
//   - Double buffering: the next step's gather and copies are issued
//     before the current step's products; the gather is stored after
//     them.
//   - Shared tiles are rows of 64 k-contiguous bytes, each 16-byte chunk
//     XOR-swizzled by its row pair, so every ldmatrix (eight 16-byte
//     rows) hits eight distinct bank groups.  ldmatrix.x4 loads an A
//     fragment (16 rows x 32 k) or two B fragments (2 x 8 columns x 32 k)
//     of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.
//   - Epilogue straight from the accumulators: each (row, column) pair
//     of a thread's fragments stored as float32 (NCHW: a column's rows
//     are consecutive pixels, 32-byte runs).
// The stem's K is 3 * 49 = 147, so a quantized layer keeps its weights
// repacked once as (C_out, K padded to 32) rows (ops/quantized.py:
// pack_weight) and every weight row is 16-byte aligned.  wgmma, TMA,
// NHWC and the quantizer fused into the previous layer wait for a later
// redesign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 64;        // bytes of K a step
constexpr int THREADS = 128;  // four warps, 2 (m) x 2 (n)

// byte offset of 16-byte chunk `chunk` (0..3) of tile row `row`
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 64-deep step of a warp's (MT x 16) x (NT x 8) tile: two k32
// halves, each MT A fragments and NT/2 pairs of B fragments.
template <int MT, int NT>
__device__ __forceinline__ void step_mma(const int8_t* sA, const int8_t* sB,
                                         int wm0, int wn0, int lane,
                                         int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = wm0 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(a[mt], sA + swz(row, 2 * h + (lane >> 4)));
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      const int row = wn0 + np * 16 + (lane & 7) + (lane >> 4) * 8;
      ldmatrix_x4(b, sB + swz(row, 2 * h + ((lane >> 3) & 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_s8(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_s8(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// R rows of a row-major int8 matrix (row stride ld bytes, `rows` valid
// rows from `src`, K valid bytes a row; K, ld and src 16-byte aligned)
// into a swizzled R x 64 tile by 16-byte cp.async copies, zero-filled
// past the rows or K.
template <int R>
struct RowTile {
  static constexpr int CHUNKS = R * 4 / THREADS;  // 16-byte chunks a thread
  const int8_t* src;
  long long ld;
  int rows, K;

  __device__ __forceinline__ void fetch(int kstep, int8_t* tile) {
    const int k0 = kstep * BK;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int id = threadIdx.x + i * THREADS;
      const int row = id >> 2, q = id & 3;
      const int k = k0 + q * 16;
      const bool ok = row < rows && k < K;
      cp_async16(tile + swz(row, q), ok ? src + row * ld + k : src, ok);
    }
  }
};

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;  // (C_out, Kp)
  const float* scale;
  const float* bias;  // null: no bias
  float* out;
  int N, C, H, W, Cout, KH, KW, sh, sw, ph, pw, dh, dw, groups, OH, OW, Kp;
};

// The im2col gather of a 128 x 64 A tile: thread t owns pixel t and
// gathers its 64 bytes of each step, (c, r, s) stepped incrementally.
struct ConvGather {
  const int8_t* x;  // the pixel's image, at its group's first channel
  int ih0, iw0, K, KH, KW, H, W, HW, dh, dw;
  uint32_t reg[BK / 4];

  __device__ __forceinline__ void fetch(int kstep) {
    const int k = kstep * BK;
    const int KHW = KH * KW;
    const int c = k / KHW;
    const int rs = k - c * KHW;
    int r = rs / KW;
    int s = rs - r * KW;
    int ih = ih0 + r * dh;
    const int8_t* xc = x + static_cast<long long>(c) * HW;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) reg[j] = 0;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int iw = iw0 + s * dw;
      if (k + j < K && static_cast<unsigned>(ih) < static_cast<unsigned>(H) &&
          static_cast<unsigned>(iw) < static_cast<unsigned>(W))
        reg[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                           __ldg(xc + ih * W + iw)))
                       << (8 * (j & 3));
      if (++s == KW) {
        s = 0;
        ih += dh;
        if (++r == KH) {
          r = 0;
          ih = ih0;
          xc += HW;
        }
      }
    }
  }

  __device__ __forceinline__ void commit(int8_t* tile) {
#pragma unroll
    for (int q = 0; q < BK / 16; ++q)
      *reinterpret_cast<uint4*>(tile + swz(threadIdx.x, q)) =
          make_uint4(reg[4 * q], reg[4 * q + 1], reg[4 * q + 2],
                     reg[4 * q + 3]);
  }
};

__device__ __forceinline__ float epilogue(int acc, float s, const float* bias,
                                          int ch) {
  const float v = __fmul_rn(__int2float_rn(acc), s);
  return bias ? __fadd_rn(v, bias[ch]) : v;
}

template <int BN>
__global__ void __launch_bounds__(THREADS) qconv_kernel(ConvArgs a) {
  constexpr int BM = THREADS, MT = BM / 32, NT = BN / 16;
  __shared__ __align__(128) int8_t sA[2][BM * BK];
  __shared__ __align__(128) int8_t sB[2][BN * BK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp & 1) * (BM / 2), wn0 = (warp >> 1) * (BN / 2);
  const int g = blockIdx.z;
  const int Cg = a.C / a.groups, Ng = a.Cout / a.groups;
  const int OHW = a.OH * a.OW, HW = a.H * a.W;
  const int M = a.N * OHW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K = Cg * a.KH * a.KW;

  ConvGather ga;
  {
    const int m = m0 + tid;
    ga.K = K;
    ga.KH = a.KH;
    ga.KW = a.KW;
    ga.H = a.H;
    ga.W = a.W;
    ga.HW = HW;
    ga.dh = a.dh;
    ga.dw = a.dw;
    if (m < M) {
      const int img = m / OHW, p = m - img * OHW;
      const int oh = p / a.OW, ow = p - oh * a.OW;
      ga.ih0 = oh * a.sh - a.ph;
      ga.iw0 = ow * a.sw - a.pw;
      ga.x = a.x + (static_cast<long long>(img) * a.C +
                    static_cast<long long>(g) * Cg) * HW;
    } else {
      ga.ih0 = -(1 << 29);  // every tap out of the image: zeros
      ga.iw0 = -(1 << 29);
      ga.x = a.x;
    }
  }
  RowTile<BN> gb;
  gb.src = a.w + (static_cast<long long>(g) * Ng + n0) * a.Kp;
  gb.ld = a.Kp;
  gb.rows = Ng - n0;
  gb.K = a.Kp;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (a.Kp + BK - 1) / BK;
  ga.fetch(0);
  gb.fetch(0, sB[0]);
  ga.commit(sA[0]);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      ga.fetch(kt + 1);
      gb.fetch(kt + 1, sB[cur ^ 1]);
    }
    step_mma<MT, NT>(sA[cur], sB[cur], wm0, wn0, lane, acc);
    if (more) ga.commit(sA[cur ^ 1]);
    cp_async_wait_all();
    __syncthreads();
  }

  const float s = *a.scale;
  const int grp = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm0 + mt * 16 + grp + half * 8;
      if (m >= M) continue;
      const int img = m / OHW, p = m - img * OHW;
      float* o = a.out + static_cast<long long>(img) * a.Cout * OHW + p;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn0 + nt * 8 + 2 * t4 + j;
          if (n >= Ng) continue;
          const int ch = g * Ng + n;
          o[static_cast<long long>(ch) * OHW] =
              epilogue(acc[mt][nt][half * 2 + j], s, a.bias, ch);
        }
      }
    }
  }
}

struct FcArgs {
  const int8_t* x;  // (M, K)
  const int8_t* w;  // (N, K)
  const float* scale;
  const float* bias;
  float* out;  // (M, N)
  int M, N, Kp;
};

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS) qfc_kernel(FcArgs a) {
  constexpr int MT = BM / 32, NT = BN / 16;
  __shared__ __align__(128) int8_t sA[2][BM * BK];
  __shared__ __align__(128) int8_t sB[2][BN * BK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp & 1) * (BM / 2), wn0 = (warp >> 1) * (BN / 2);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  RowTile<BM> ta;
  ta.src = a.x + static_cast<long long>(m0) * a.Kp;
  ta.ld = a.Kp;
  ta.rows = a.M - m0;
  ta.K = a.Kp;
  RowTile<BN> tb;
  tb.src = a.w + static_cast<long long>(n0) * a.Kp;
  tb.ld = a.Kp;
  tb.rows = a.N - n0;
  tb.K = a.Kp;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (a.Kp + BK - 1) / BK;
  ta.fetch(0, sA[0]);
  tb.fetch(0, sB[0]);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      ta.fetch(kt + 1, sA[cur ^ 1]);
      tb.fetch(kt + 1, sB[cur ^ 1]);
    }
    step_mma<MT, NT>(sA[cur], sB[cur], wm0, wn0, lane, acc);
    cp_async_wait_all();
    __syncthreads();
  }

  const float s = *a.scale;
  const int grp = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm0 + mt * 16 + grp + half * 8;
      if (m >= a.M) continue;
      float* o = a.out + static_cast<long long>(m) * a.N;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn0 + nt * 8 + 2 * t4 + j;
          if (n < a.N) o[n] = epilogue(acc[mt][nt][half * 2 + j], s, a.bias, n);
        }
      }
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Q1.  x (N, C, H, W) int8, w (Cout, Kp) int8 (OIHW rows padded with
// zeros to Kp, a multiple of 32, 16-byte aligned), scale one float32,
// bias (Cout,) float32 or null, out (N, Cout, OH, OW) float32.  bn: the
// N tile, 64 or 128 (ops/quantized.py:_plan).  Returns the launch's
// cudaError (0 on success).
int mxtpu_qconv(const void* x, const void* w, const void* scale,
                const void* bias, void* out, int N, int C, int H, int W,
                int Cout, int KH, int KW, int sh, int sw, int ph, int pw,
                int dh, int dw, int groups, int OH, int OW, int Kp, int bn,
                void* stream) {
  if (groups < 1 || C % groups || Cout % groups || Kp % 32 ||
      Kp < C / groups * KH * KW || (bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
             static_cast<const float*>(scale), static_cast<const float*>(bias),
             static_cast<float*>(out), N, C, H, W, Cout, KH, KW, sh, sw, ph,
             pw, dh, dw, groups, OH, OW, Kp};
  const dim3 grid(cdiv(N * OH * OW, 128), cdiv(Cout / groups, bn), groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128)
    qconv_kernel<128><<<grid, THREADS, 0, s>>>(a);
  else
    qconv_kernel<64><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Q2.  x (M, Kp) and w (N, Kp) int8 (rows padded with zeros to Kp, a
// multiple of 32, 16-byte aligned), scale one float32, bias (N,) float32
// or null, out (M, N) float32.
int mxtpu_qfc(const void* x, const void* w, const void* scale,
              const void* bias, void* out, int M, int N, int Kp,
              void* stream) {
  if (M < 1 || N < 1 || Kp < 1 || Kp % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  FcArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
           static_cast<const float*>(scale), static_cast<const float*>(bias),
           static_cast<float*>(out), M, N, Kp};
  const dim3 grid(cdiv(M, 64), cdiv(N, 64));
  qfc_kernel<64, 64><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
