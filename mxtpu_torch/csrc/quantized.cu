// Q1, Q2 and Q3: the int8 x int8 products of post-training quantization
// on the tensor cores of Hopper (sm_90a), int32 sums, float32 out, and
// the activation quantizer that writes Q1's channels-last input.
//
//   Q1 qconv_nhwc_kernel  out[n,o,oh,ow] = scale * sum_{r,s,c} x[n,ih,iw,c]
//                         * w[o,r,s,c] (+ bias[o]), ih = oh*sh - ph + r*dh,
//                         iw = ow*sw - pw + s*dw, x zero outside the
//                         image, c within o's group; x channels-last
//      qconv_kernel       the same on an NCHW x (the stem's route)
//   Q2 qfc_kernel         out[m,n] = scale * sum_k x[m,k] * w[n,k] (+ bias[n])
//   Q3 quantize_nhwc_kernel  q[n,h,w,c] = int8(clamp(rint(x[n,c,h,w] / s),
//                         -127, 127)), x float32 NCHW, q channels-last
//
// They replace no pallas_call: the reference runs quantize_v2,
// quantized_conv and quantized_fully_connected (mxtpu/contrib/
// quantization.py:42-52, :81, :62) as XLA's elementwise ops and its int8
// conv_general_dilated and dot_general with preferred_element_type=int32.
// Shapes and values are the reference's; only the layout of Q1's int8
// input changes: a conv whose input channels a group are a multiple of 16
// reads x (N, C, H, W) stored channels-last, as Q3 writes it, and OHWI
// weights; the stem (3 channels) reads x NCHW and OIHW weights (both as
// (C_out, K padded to 32) rows, see below).  Q2 reads x (M, K) and w
// (N, K); out is NCHW or (M, N) float32.
//
// Arithmetic.  Every product of two int8 values and every sum of them is
// exact in int32 (|acc| <= K * 127^2 < 2^31 for K < 133,000; ResNet-50's
// largest K is 4608), so the order of the sums, (c, r, s) or (r, s, c),
// does not matter and the int32 result is the reference's.  The epilogue
// is the reference's in its order, each step rounded once:
// __int2float_rn(acc), __fmul_rn by the combined scale (s_x * s_w, a
// float32 scalar the wrapper computes on the device, so nothing waits on
// the host), then __fadd_rn of the bias.  The intrinsics keep nvcc from
// contracting the two into an FMA, so the result is bit for bit the plain
// version's (separate torch ops).  Q3 is the reference's chain in one
// pass: __fdiv_rn by the 0-dim scale on the device (IEEE, as torch's
// division by a device tensor), rintf (half to even, as torch.round),
// the clamp, the cast.
//
// Bounds on the H100.  ResNet-50 at batch 128: a 3x3 stage-1 conv
// (128, 64, 56, 56) -> 64 does 2 * 401,408 * 64 * 576 = 2.96e10 int8
// operations, 0.015 ms at the 1979 TOP/s int8 peak; it reads 25.7 MB of
// x and writes 102.8 MB of float32 output, 0.038 ms at 3.35 TB/s.  Most
// of the net's convs are bound by the float32 output they write.  Q3
// reads 4 bytes and writes 1 an element: 0.038 ms for 25.7 M elements.
//
// Q1's design (qconv_nhwc_kernel): an implicit GEMM.  C (M x Ng) with M
// = N*OH*OW output pixels and Ng = C_out / groups channels of a group,
// K = kh * kw * C_in / groups in (r, s, c) order; a block of 8 warps owns
// a BM x BN tile of C (64 or 128 each, ops/quantized.py:_plan) and walks
// K in 64-byte steps:
//   - A, the im2col gather: a row of the tile is one pixel's 64 bytes of
//     a step, four 16-byte chunks, each 16 consecutive channels of one
//     tap (C_in / groups is a multiple of 16, so no chunk crosses a tap).
//     Each chunk is one 16-byte cp.async, zero-filled (source size 0)
//     off the image, past the pixels and past K; a thread keeps its
//     rows' image offsets and its chunk's (r, s, c), stepped by 64 bytes
//     a step, so no instruction is spent per byte.  Weight rows are the
//     same 16-byte copies (the wrapper pads every row to 32 bytes,
//     ops/quantized.py:pack_weight).
//   - A ring of 4 stages (cp.async groups): a step waits for its stage,
//     issues the copies of the step 3 ahead, then runs its products.
//   - Shared tiles are rows of 64 k-contiguous bytes, each 16-byte chunk
//     XOR-swizzled by its row pair, so every ldmatrix (eight 16-byte
//     rows) hits eight distinct bank groups.  ldmatrix.x4 loads an A
//     fragment (16 rows x 32 k) or two B fragments (2 x 8 columns x 32 k)
//     of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32; a warp owns a
//     (BM / 2 or / 4) x 32 part of the tile, at most 64 accumulators a
//     thread, so two or three blocks share an SM.
//   - The epilogue stages the int32 tile through shared memory,
//     channel-major ([BN][BM + 4]: the fragments' stores hit 32 distinct
//     banks), then each warp writes whole runs of a channel's consecutive
//     pixels into NCHW float32: 16 bytes a lane (512 a store
//     instruction) where an image's pixel count is a multiple of 4, else
//     4 (128 a store; the 7x7 stage).
// The stem route (qconv_kernel) is the first, simple form: 4 warps, each
// thread gathers one pixel's bytes of a step byte by byte from NCHW x
// (its K of 3 * 49 = 147 has no 16-byte channel runs), double-buffered.
// Q3 (quantize_nhwc_kernel) transposes a 64-channel x 64-pixel tile of
// one image through shared memory: its float32 reads run along the
// pixels (128 bytes a warp), its int8 writes along the channels (16
// bytes a thread, 64 a pixel).

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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


// -- Q1 on channels-last x --------------------------------------------------

constexpr int NHWC_THREADS = 256;  // eight warps
constexpr int STAGES = 4;          // the cp.async ring

template <int BM, int BN>
struct NhwcTile {
  static constexpr int WN = BN >= 128 ? 4 : 2;  // warps along n
  static constexpr int WM = 8 / WN;             // warps along m
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int STAGE = (BM + BN) * BK;  // bytes of a ring stage
  static constexpr int LD = BM + 4;             // epilogue row, in ints
  static constexpr int RING = STAGES * STAGE, STAGED = BN * LD * 4;
  static constexpr int SMEM = RING > STAGED ? RING : STAGED;
  // blocks an SM: 3 (at most 85 registers a thread) where a warp holds
  // 32 accumulators; the 128 x 128 tile's 64 spill there, so 2
  static constexpr int MIN_BLOCKS = MT * NT > 8 ? 2 : 3;
  static_assert(MT >= 1 && NT % 2 == 0, "warp tile");
};

struct NhwcArgs {
  const int8_t* x;  // (N, H, W, C)
  const int8_t* w;  // (C_out, Kp), k = (r * KW + s) * Cg + c
  const float* scale;
  const float* bias;  // null: no bias
  float* out;         // (N, C_out, OH, OW)
  int N, C, H, W, Cout, KH, KW, sh, sw, ph, pw, dh, dw, groups, OH, OW, Kp;
};

template <int BM, int BN>
__global__ void __launch_bounds__(NHWC_THREADS,
                                  NhwcTile<BM, BN>::MIN_BLOCKS)
    qconv_nhwc_kernel(NhwcArgs a) {
  using T = NhwcTile<BM, BN>;
  constexpr int AR = BM / 64, BR = BN / 64;  // chunks a thread a stage
  extern __shared__ __align__(128) int8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % T::WM) * T::WTM, wn0 = (warp / T::WM) * T::WTN;
  const int g = blockIdx.y;
  const int Cg = a.C / a.groups, Ng = a.Cout / a.groups;
  const int OHW = a.OH * a.OW, M = a.N * OHW;
  const int K = Cg * a.KH * a.KW;
  const int ntiles = (Ng + BN - 1) / BN;
  const int n0 = (blockIdx.x % ntiles) * BN;
  const int m0 = (blockIdx.x / ntiles) * BM;

  // this thread's copies: tile rows (tid >> 2) + 64 i, 16-byte chunk q
  const int q = tid & 3, row0 = tid >> 2;
  int xoff[AR], ih0[AR], iw0[AR];  // a row's image (and group) in x
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int m = m0 + row0 + 64 * i;
    if (m < M) {
      const int img = m / OHW, p = m - img * OHW;
      const int oh = p / a.OW, ow = p - oh * a.OW;
      ih0[i] = oh * a.sh - a.ph;
      iw0[i] = ow * a.sw - a.pw;
      xoff[i] = img * a.H * a.W * a.C + g * Cg;
    } else {
      ih0[i] = -(1 << 29);  // every tap off the image: zeros
      iw0[i] = -(1 << 29);
      xoff[i] = 0;
    }
  }
  // weight rows n0 + row0 + 64 i of the group, row0's first
  const int8_t* wrow = a.w + static_cast<long long>(g * Ng + n0 + row0) *
                                 a.Kp;
  // the chunk's place in K, stepped by BK a stage: k, tap (r, s), c
  int k = 16 * q, r, s, c;
  {
    const int t = k / Cg;
    c = k - t * Cg;
    r = t / a.KW;
    s = t - r * a.KW;
  }

  auto load = [&](int kt, int slot) {
    int8_t* sA = smem + slot * T::STAGE;
    int8_t* sB = sA + BM * BK;
    const int dr = r * a.dh, ds = s * a.dw;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const int ih = ih0[i] + dr, iw = iw0[i] + ds;
      const bool ok = k < K && static_cast<unsigned>(ih) <
                                   static_cast<unsigned>(a.H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(a.W);
      cp_async16(sA + swz(row0 + 64 * i, q),
                 a.x + (ok ? xoff[i] + (ih * a.W + iw) * a.C + c : 0), ok);
    }
    const int kb = kt * BK + 16 * q;
#pragma unroll
    for (int i = 0; i < BR; ++i) {
      const bool ok = n0 + row0 + 64 * i < Ng && kb < a.Kp;
      cp_async16(sB + swz(row0 + 64 * i, q),
                 ok ? wrow + static_cast<long long>(64 * i) * a.Kp + kb
                    : a.w,
                 ok);
    }
    k += BK;
    c += BK;
    while (c >= Cg) {
      c -= Cg;
      if (++s == a.KW) {
        s = 0;
        ++r;
      }
    }
  };

  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (a.Kp + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int ahead = kt + STAGES - 1;
    if (ahead < nk) load(ahead, ahead % STAGES);
    cp_async_commit();
    const int8_t* sA = smem + (kt % STAGES) * T::STAGE;
    step_mma<T::MT, T::NT>(sA, sA + BM * BK, wm0, wn0, lane, acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the int32 tile, channel-major, then one channel's pixels a store
  int* S = reinterpret_cast<int*>(smem);
  const int grp = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm0 + mt * 16 + grp + (e >> 1) * 8;
        const int col = wn0 + nt * 8 + 2 * t4 + (e & 1);
        S[col * T::LD + row] = acc[mt][nt][e];
      }
  __syncthreads();
  const float sc = *a.scale;
  if (OHW % 4 == 0) {
    // 16-byte stores: a lane owns 4 consecutive pixels of a channel (an
    // image's pixel count is a multiple of 4, so they share an image),
    // PL lanes a channel's BM pixels, 32 / PL channels a store
    constexpr int PL = BM / 4, CPW = 32 / PL;
    const int pi = 4 * (lane % PL), m = m0 + pi, img = m / OHW;
    const int ob = m < M ? img * a.Cout * OHW + (m - img * OHW) : -1;
    for (int col = warp * CPW + lane / PL; col < BN; col += 8 * CPW) {
      if (ob < 0 || n0 + col >= Ng) continue;
      const int ch = g * Ng + n0 + col;
      const int4 v = *reinterpret_cast<const int4*>(S + col * T::LD + pi);
      *reinterpret_cast<float4*>(a.out + ch * OHW + ob) = make_float4(
          epilogue(v.x, sc, a.bias, ch), epilogue(v.y, sc, a.bias, ch),
          epilogue(v.z, sc, a.bias, ch), epilogue(v.w, sc, a.bias, ch));
    }
    return;
  }
  int obase[BM / 32];
#pragma unroll
  for (int i = 0; i < BM / 32; ++i) {
    const int m = m0 + lane + 32 * i;
    const int img = m / OHW;
    obase[i] = m < M ? img * a.Cout * OHW + (m - img * OHW) : -1;
  }
  for (int col = warp; col < BN && n0 + col < Ng; col += 8) {
    const int ch = g * Ng + n0 + col;
    float* o = a.out + ch * OHW;
#pragma unroll
    for (int i = 0; i < BM / 32; ++i)
      if (obase[i] >= 0)
        o[obase[i]] = epilogue(S[col * T::LD + lane + 32 * i], sc, a.bias, ch);
  }
}

// -- Q3: float32 NCHW -> int8 channels-last ---------------------------------

constexpr int QT = 64;  // channels and pixels of a Q3 tile

__device__ __forceinline__ uint32_t quantize8(float v, float s) {
  // a zero dividend takes __fdiv_rn's slow path (half of a relu's
  // output); +-0 / s rounds to 0 either way
  float t = v == 0.f ? 0.f : rintf(__fdiv_rn(v, s));
  // torch.clamp keeps a NaN, and the cast makes it 0
  t = t != t ? 0.f : fminf(fmaxf(t, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(__float2int_rz(t))));
}

__global__ void __launch_bounds__(256)
    quantize_nhwc_kernel(const float* x, const float* scale, int8_t* q,
                         int C, int HW) {
  __shared__ uint32_t S[QT][QT / 4 + 1];  // [pixel][channel quad]
  const int n = blockIdx.z, c0 = blockIdx.y * QT, p0 = blockIdx.x * QT;
  const int tid = threadIdx.x;
  const float s = *scale;
  // a warp reads 32 consecutive pixels of a channel
  const int p = tid & 63;
  const float* xb =
      x + (static_cast<long long>(n) * C + c0) * HW + p0 + p;
  const bool pin = p0 + p < HW;
  float v[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cq = (tid >> 6) + 4 * j;
    const bool ok = pin && c0 + 4 * cq < C;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      v[j][b] = ok ? __ldg(xb + static_cast<long long>(4 * cq + b) * HW)
                   : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) word |= quantize8(v[j][b], s) << (8 * b);
    S[p][(tid >> 6) + 4 * j] = word;
  }
  __syncthreads();
  // a thread writes 16 channels of a pixel, four threads a pixel
  const int pp = tid >> 2, ch = tid & 3;
  if (p0 + pp < HW && c0 + 16 * ch < C) {
    const uint4 out = make_uint4(S[pp][4 * ch], S[pp][4 * ch + 1],
                                 S[pp][4 * ch + 2], S[pp][4 * ch + 3]);
    *reinterpret_cast<uint4*>(
        q + (static_cast<long long>(n) * HW + p0 + pp) * C + c0 + 16 * ch) =
        out;
  }
}

template <int BM, int BN>
int launch_nhwc(const NhwcArgs& a, cudaStream_t stream) {
  constexpr int SMEM = NhwcTile<BM, BN>::SMEM;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        qconv_nhwc_kernel<BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  const long long blocks =
      static_cast<long long>((a.N * a.OH * a.OW + BM - 1) / BM) *
      ((a.Cout / a.groups + BN - 1) / BN);
  if (blocks >= (1LL << 31) || a.groups > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  qconv_nhwc_kernel<BM, BN>
      <<<dim3(static_cast<unsigned>(blocks), a.groups), NHWC_THREADS, SMEM,
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Q1, the stem's route.  x (N, C, H, W) int8 contiguous, w (Cout, Kp)
// int8 (OIHW rows padded with zeros to Kp, a multiple of 32, 16-byte
// aligned), scale one float32, bias (Cout,) float32 or null, out (N,
// Cout, OH, OW) float32.  bn: the N tile, 64 or 128 (ops/quantized.py:
// _plan).  Returns the launch's cudaError (0 on success).
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

// Q1 on channels-last x.  x (N, C, H, W) int8 stored (N, H, W, C), 16-byte
// aligned, C / groups a multiple of 16; w (Cout, Kp) int8, OHWI rows
// (k = (r * KW + s) * C / groups + c) padded with zeros to Kp, a multiple
// of 32, 16-byte aligned; scale, bias and out as mxtpu_qconv's.  bm, bn:
// the tile, 64 or 128 each (ops/quantized.py:_plan).
int mxtpu_qconv_nhwc(const void* x, const void* w, const void* scale,
                     const void* bias, void* out, int N, int C, int H, int W,
                     int Cout, int KH, int KW, int sh, int sw, int ph, int pw,
                     int dh, int dw, int groups, int OH, int OW, int Kp,
                     int bm, int bn, void* stream) {
  if (groups < 1 || C % groups || Cout % groups || (C / groups) % 16 ||
      Kp % 32 || Kp < C / groups * KH * KW || (bm != 64 && bm != 128) ||
      (bn != 64 && bn != 128) || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  NhwcArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
             static_cast<const float*>(scale), static_cast<const float*>(bias),
             static_cast<float*>(out), N, C, H, W, Cout, KH, KW, sh, sw, ph,
             pw, dh, dw, groups, OH, OW, Kp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return bn == 128 ? launch_nhwc<128, 128>(a, s)
                     : launch_nhwc<128, 64>(a, s);
  return bn == 128 ? launch_nhwc<64, 128>(a, s) : launch_nhwc<64, 64>(a, s);
}

// Q3.  x (N, C, H, W) float32 contiguous, scale one float32, q (N, C, H, W)
// int8 stored (N, H, W, C), 16-byte aligned; C a multiple of 16.
int mxtpu_quantize_nhwc(const void* x, const void* scale, void* q, int N,
                        int C, int H, int W, void* stream) {
  const int HW = H * W;
  if (N < 1 || N > 65535 || C < 16 || C % 16 || HW < 1 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cdiv(HW, QT), cdiv(C, QT), N);
  quantize_nhwc_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<int8_t*>(q), C, HW);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
