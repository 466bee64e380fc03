// Q1, Q2 and Q3: the int8 x int8 products of post-training quantization
// on the tensor cores of Hopper (sm_90a), int32 sums, float32 out, and
// the activation quantizer that writes Q1's channels-last input.
//
//   Q1 qconv_nhwc_kernel  out[n,o,oh,ow] = scale * sum_{r,s,c} x[n,ih,iw,c]
//                         * w[o,r,s,c] (+ bias[o]), ih = oh*sh - ph + r*dh,
//                         iw = ow*sw - pw + s*dw, x zero outside the
//                         image, c within o's group; x channels-last
//      qconv_stem_kernel  the same on an NCHW x of at most 4 channels a
//                         group (the stem's route: RGB, RGBA, grey)
//      qconv_kernel       the same on any other NCHW x
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
// weights; the stem (at most 4 channels a group) reads x NCHW and weights
// in (r, s, c) order with s padded to 8 taps and c to 4 channels; any
// other NCHW x reads OIHW weights (all as (C_out, K padded to 32) rows,
// see below).  Q2 reads x (M, K) and w (N, K); out is NCHW or (M, N)
// float32.
//
// Arithmetic.  Every product of two int8 values and every sum of them is
// exact in int32 (|acc| <= K * 127^2 < 2^31 for K < 133,000; ResNet-50's
// largest K is 4608), so the order of the sums, (c, r, s) or (r, s, c),
// or split over a cluster, does not matter and the int32 result is the
// reference's.  The epilogue is the reference's in its order, each step
// rounded once:
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
// The stem's design (qconv_stem_kernel).  ResNet-50's stem, 3->64 7x7
// stride 2 at 224^2 and batch 128, reads 19.3 MB of int8 and writes 411 MB
// of float32 (0.1285 ms at 3.35 TB/s; its 30 GOP take 0.015 ms), so it is
// bound by its output.  A tile is R output rows x TW columns of one
// image (2 x 112 = 224 pixels at the stem, ops/quantized.py:_plan_stem)
// and 64 output channels:
//   - A block stages the tile's input patch once, (R - 1) * sh +
//     (KH - 1) * dh + 1 rows of (TW - 1) * sw + (KW - 1) * dw + 1 input
//     columns (9 x 229 at the stem) from the tile's first column floored
//     to a multiple of 16: each NCHW plane's row is copied in 16-byte
//     cp.async chunks (zero-filled off the image) into raw rows, then 16
//     columns at a time are interleaved by byte permutes into one 4-byte
//     word a pixel, (c0, c1, c2, c3), zeros for channels past the
//     group's (3 16-byte loads, 4 16-byte stores).  Neighbouring tiles'
//     patches overlap by (KH - 1) * dh + 1 - sh rows, read from L2.
//   - K runs in (r, s, c) order with s padded to a multiple of 8 and c to
//     4, so one m16n8k32 step is 8 taps of one kernel row (the stem's 7
//     steps: its 7 x 8 x 4 = 224 bytes, zeros at s = 7 and c = 3; weights
//     pack_weight(w, stem=True)).  Each A register of the fragment is
//     then exactly one tap's word, one 32-bit shared load at patch row
//     i * sh + r * dh, column j * sw + s * dw (s past KW clamped to KW - 1,
//     whose weight there is zero): no ldmatrix and no work per byte.  At
//     stride 2 a warp's loads cover 18 consecutive words (lanes with the
//     same word read it once), so they hit distinct banks.  The 64 weight
//     rows sit in shared memory at a pitch of K + 16 bytes (an odd number
//     of 16-byte chunks, so an ldmatrix's 8 rows hit 8 bank groups).
//   - Each warp owns 32 pixels and all 64 channels (64 accumulators).
//   - The epilogue stages the int32 tile channel-major in shared memory
//     ([64][pixels + 4]: the fragments' stores hit 32 banks), then each
//     warp writes a channel's run of pixels (the tile's rows where it
//     spans the image's width: 224 floats at the stem) with 16-byte
//     stores where the run and its staged row are 16-byte aligned, 4-byte
//     stores for the rest.
//   - Blocks are persistent (as many as the card holds, two an SM at the
//     stem: 91 KB of shared memory, 126 registers): a block copies its
//     weights once, and the next tile's input copies are in flight while
//     it multiplies and writes the current tile.
// Tried on the H100 and slower: the output written straight from the
// fragments, 16-pixel warps, one tile a block, and 4-byte copies of each
// channel word.
// qconv_kernel, the first, simple form, keeps NCHW x of more channels: 4
// warps, each thread gathers one pixel's bytes of a step byte by byte,
// double-buffered.
// Q2's design (qfc_kernel).  The classifier, 128 x 2048 -> 1000, is 32
// tiles of 64 x 64: one block each would leave 100 of 132 SMs idle and
// walk K as a chain of 32 memory round trips.  K is split over a
// thread-block cluster of S blocks (ops/quantized.py:_plan_fc: S = 5 at
// the classifier, 160 blocks of 6-7 steps), each with a 4-stage cp.async
// ring; each writes its int32 partial tile to its own shared memory, and
// after a cluster barrier block z sums rows 64 z / S .. of all S tiles
// over distributed shared memory and runs the epilogue on them.  One
// launch, no workspace, no atomics.
// Q3 (quantize_nhwc_kernel) transposes a 64-channel x 64-pixel tile of
// one image through shared memory: its float32 reads run along the
// pixels (128 bytes a warp), its int8 writes along the channels (16
// bytes a thread, 64 a pixel).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;        // bytes of K a step
constexpr int THREADS = 128;  // four warps, 2 (m) x 2 (n)
constexpr int STAGES = 4;     // the cp.async ring (Q1 channels-last, Q2)

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

// acc * s (+ bv where bias is not null), each step rounded once
__device__ __forceinline__ float scaled(int acc, float s, const float* bias,
                                        float bv) {
  const float v = __fmul_rn(__int2float_rn(acc), s);
  return bias ? __fadd_rn(v, bv) : v;
}

__device__ __forceinline__ float epilogue(int acc, float s, const float* bias,
                                          int ch) {
  return scaled(acc, s, bias, bias ? bias[ch] : 0.f);
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

// -- Q1 on NCHW x of at most 4 channels a group: the stem ----------------

constexpr int STEM_BN = 64;         // output channels a block
constexpr int STEM_PIXELS = 256;    // a tile's pixels at most: 32 a warp
constexpr int SMEM_MAX = 232448;    // the H100's shared memory a block

struct StemArgs {
  const int8_t* x;  // (N, C, H, W) NCHW
  const int8_t* w;  // (C_out, Kp), k = (r * SB + s / 8) * 32 + s % 8 * 4 + c
  const float* scale;
  const float* bias;  // null: no bias
  float* out;         // (N, C_out, OH, OW)
  int N, C, H, W, Cout, KH, KW, sh, sw, ph, pw, dh, dw, groups, OH, OW, Kp;
  int R, TW;    // a tile's output rows and columns
  int RT, CT;   // row and column tiles of an image
  int PR, PW;   // the patch's rows and input columns
  int PWp;      // a patch row's pitch, in words, and a raw row's, in bytes
  int LD;       // a staged channel's pixels, in ints
  int pofs;     // the patch's byte offset in shared memory
  int rofs;     // the fetched raw input's
  int sofs;     // the staged tile's
};

// Fills the derived fields of a (tiles, patch, staged row, offsets) from
// its geometry and (R, TW); returns the bytes of shared memory a block
// needs: the 64 weight rows at a pitch of Kp + 16 bytes, the patch (PR
// rows of PWp words: PW + 15 rounded up to 16, room for its first column
// at any of 16 places), the fetched raw input (PR x 4 channel rows of PWp
// bytes) and the staged int32 tile, one after the other
// (ops/quantized.py:_stem_smem computes the same).
long long stem_layout(StemArgs& a) {
  a.RT = (a.OH + a.R - 1) / a.R;
  a.CT = (a.OW + a.TW - 1) / a.TW;
  a.PR = (a.R - 1) * a.sh + (a.KH - 1) * a.dh + 1;
  a.PW = (a.TW - 1) * a.sw + (a.KW - 1) * a.dw + 1;
  a.PWp = (a.PW + 15 + 15) / 16 * 16;
  a.LD = (a.R * a.TW + 31) / 32 * 32 + 4;
  const long long weights = static_cast<long long>(STEM_BN) * (a.Kp + 16);
  const long long patch = 4LL * a.PR * a.PWp;
  const long long raw = 4LL * a.PR * a.PWp;
  const long long total = weights + patch + raw + 4LL * STEM_BN * a.LD;
  const bool fits = total <= SMEM_MAX;
  a.pofs = fits ? static_cast<int>(weights) : 0;
  a.rofs = fits ? static_cast<int>(weights + patch) : 0;
  a.sofs = fits ? static_cast<int>(weights + patch + raw) : 0;
  return total;
}

// A tile's place: its image, first output row and column.
struct StemTile {
  int img, oh0, ow0;
  __device__ __forceinline__ StemTile(const StemArgs& a, int t)
      : img(t / (a.RT * a.CT)),
        oh0((t / a.CT) % a.RT * a.R),
        ow0(t % a.CT * a.TW) {}
};

// The patch of a tile, item by item: item i is patch row i / nq and the
// 16 input columns from qb + 16 (i % nq) (qb: the tile's first input
// column floored to a multiple of 16).  fetch() copies each channel's 16
// bytes of an item into the raw rows ([PR][4][PWp] bytes) by one 16-byte
// cp.async where they lie inside the image and aligned, zero-filled off
// it, by byte loads at a misaligned or straddled edge; store() turns a
// thread's fetched items into patch words.  A thread stores only the
// items it fetched, so its own cp.async wait suffices.  Patch word (pr,
// pc) holds the channels (c0, c1, c2, c3) of input pixel (ih0 + pr, qb +
// pc): the tile's column iw0 is patch column off = iw0 - qb.
struct StemPatch {
  const int8_t* xi;  // the tile's image at its group's first channel
  long long HW;
  int ih0, qb, nq, items, off, Cg;

  __device__ __forceinline__ StemPatch(const StemArgs& a, const StemTile& t,
                                       int g, int Cg_)
      : HW(static_cast<long long>(a.H) * a.W), Cg(Cg_) {
    xi = a.x + (static_cast<long long>(t.img) * a.C + g * Cg) * HW;
    ih0 = t.oh0 * a.sh - a.ph;
    const int iw0 = t.ow0 * a.sw - a.pw;
    qb = iw0 & ~15;  // floor to a multiple of 16
    off = iw0 - qb;
    nq = (off + a.PW + 15) >> 4;
    items = a.PR * nq;
  }

  __device__ __forceinline__ void fetch(const StemArgs& a, int tid,
                                        int nthreads, int8_t* raw) const {
    for (int i = tid; i < items; i += nthreads) {
      const int pr = i / nq, iw = qb + 16 * (i - pr * nq), ih = ih0 + pr;
      const bool row = static_cast<unsigned>(ih) < static_cast<unsigned>(a.H);
      const bool in = row && iw + 16 > 0 && iw < a.W;
      const int8_t* src = xi + static_cast<long long>(row ? ih : 0) * a.W + iw;
      int8_t* dst = raw + pr * 4 * a.PWp + 16 * (i - pr * nq);
      for (int c = 0; c < Cg; ++c, src += HW, dst += a.PWp) {
        if (!in || (iw >= 0 && iw + 16 <= a.W &&
                    (reinterpret_cast<uintptr_t>(src) & 15) == 0)) {
          cp_async16(dst, in ? src : a.x, in);
        } else {
          uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (static_cast<unsigned>(iw + b) < static_cast<unsigned>(a.W))
              v[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                               __ldg(src + b)))
                           << (8 * (b & 3));
          *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(const StemArgs& a, int tid,
                                        int nthreads, const int8_t* raw,
                                        uint32_t* patch) const {
    for (int i = tid; i < items; i += nthreads) {
      const int pr = i / nq, q = i - pr * nq;
      const int8_t* src = raw + pr * 4 * a.PWp + 16 * q;
      uint4 v[4];  // a channel's 16 columns, 4 a word
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = c < Cg ? *reinterpret_cast<const uint4*>(src + c * a.PWp)
                      : make_uint4(0u, 0u, 0u, 0u);
      uint32_t* dst = patch + pr * a.PWp + 16 * q;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t w0 = k == 0 ? v[0].x : k == 1 ? v[0].y
                          : k == 2 ? v[0].z : v[0].w;
        const uint32_t w1 = k == 0 ? v[1].x : k == 1 ? v[1].y
                          : k == 2 ? v[1].z : v[1].w;
        const uint32_t w2 = k == 0 ? v[2].x : k == 1 ? v[2].y
                          : k == 2 ? v[2].z : v[2].w;
        const uint32_t w3 = k == 0 ? v[3].x : k == 1 ? v[3].y
                          : k == 2 ? v[3].z : v[3].w;
        // column b's word: byte c of it is channel c's byte b
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
        const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
        const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
        *reinterpret_cast<uint4*>(dst + 4 * k) =
            make_uint4(__byte_perm(lo01, lo23, 0x5410),
                       __byte_perm(lo01, lo23, 0x7632),
                       __byte_perm(hi01, hi23, 0x5410),
                       __byte_perm(hi01, hi23, 0x7632));
      }
    }
  }
};

// Persistent: a block copies its 64 weight rows once, then walks tiles
// blockIdx.x, + gridDim.x, ...; the next tile's input is copied by
// cp.async while the block multiplies and writes the current one.
__global__ void __launch_bounds__(STEM_PIXELS, 2)
    qconv_stem_kernel(StemArgs a) {
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* sW = smem;
  uint32_t* patch = reinterpret_cast<uint32_t*>(smem + a.pofs);
  int8_t* raw = smem + a.rofs;
  int* S = reinterpret_cast<int*>(smem + a.sofs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int Cg = a.C / a.groups, Ng = a.Cout / a.groups;
  const int g = blockIdx.z, n0 = blockIdx.y * STEM_BN;
  const int P = a.R * a.TW, tiles = a.N * a.RT * a.CT;
  const int KPS = a.Kp + 16;  // a weight row's pitch in shared memory
  const int SB = (a.KW + 7) >> 3;
  const float sc = *a.scale;
  const int nch = min(STEM_BN, Ng - n0);
  const int grp = lane >> 2, t4 = lane & 3;

  // the group's 64 weight rows from n0 (zeros past Ng), 16-byte copies
  {
    const int chunks = a.Kp >> 4;
    const int8_t* wg = a.w + static_cast<long long>(g * Ng + n0) * a.Kp;
    for (int i = tid; i < STEM_BN * chunks; i += nthreads) {
      const int row = i / chunks, q = i - row * chunks;
      const bool ok = n0 + row < Ng;
      cp_async16(sW + row * KPS + 16 * q,
                 ok ? wg + static_cast<long long>(row) * a.Kp + 16 * q : a.w,
                 ok);
    }
  }
  // the first tile's patch
  int t = blockIdx.x;
  if (t < tiles) {
    const StemPatch pt(a, StemTile(a, t), g, Cg);
    pt.fetch(a, tid, nthreads, raw);
    cp_async_commit();
    cp_async_wait<0>();
    pt.store(a, tid, nthreads, raw, patch);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // a thread's fragment rows: pixels grp and grp + 8 of each of its
  // warp's two m16 tiles (32 pixels; past the tile's last, its last)
  int base[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min(warp * 32 + mt * 16 + h * 8 + grp, P - 1);
      const int i = p / a.TW, j = p - i * a.TW;
      base[mt][h] = i * a.sh * a.PWp + j * a.sw;
    }

  for (; t < tiles; t += gridDim.x) {
    // the next tile's input, in flight while this one is multiplied and
    // written
    const int tn = t + gridDim.x;
    const StemPatch pn(a, StemTile(a, tn < tiles ? tn : t), g, Cg);
    if (tn < tiles) pn.fetch(a, tid, nthreads, raw);
    cp_async_commit();
    // products: K in (r, s padded to 8, c padded to 4), a step 8 taps
    int acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    const int poff = StemPatch(a, StemTile(a, t), g, Cg).off;
    for (int r = 0; r < a.KH; ++r) {
      const int roff = r * a.dh * a.PWp + poff;
      for (int sb = 0; sb < SB; ++sb) {
        // taps 8 sb + t4 (k 4 t4 ..) and 8 sb + 4 + t4 (k 16 + 4 t4 ..)
        const int s0 = min(8 * sb + t4, a.KW - 1) * a.dw + roff;
        const int s2 = min(8 * sb + 4 + t4, a.KW - 1) * a.dw + roff;
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          af[mt][0] = patch[base[mt][0] + s0];
          af[mt][1] = patch[base[mt][1] + s0];
          af[mt][2] = patch[base[mt][0] + s2];
          af[mt][3] = patch[base[mt][1] + s2];
        }
        const int8_t* wk = sW + (r * SB + sb) * 32;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, wk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * KPS +
                             ((lane >> 3) & 1) * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_s8(acc[mt][2 * np], af[mt], b[0], b[1]);
            mma_s8(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
      }
    }
    // the int32 tile, channel-major (the stores hit 32 banks)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          S[(nt * 8 + 2 * t4 + (e & 1)) * a.LD + warp * 32 + mt * 16 + grp +
            (e >> 1) * 8] = acc[mt][nt][e];
    __syncthreads();  // the tile is staged, the patch read

    // a channel's run of pixels a warp: the tile's rows as one run where
    // the tile spans the image's width, else one run a row
    const StemTile tile(a, t);
    const int rows = min(a.R, a.OH - tile.oh0);
    const bool whole = a.TW == a.OW;
    const int runs = whole ? nch : nch * rows;
    const int len = whole ? rows * a.OW : min(a.TW, a.OW - tile.ow0);
    for (int run = warp; run < runs; run += nthreads >> 5) {
      const int c = whole ? run : run / rows;
      const int i = whole ? 0 : run - c * rows;
      const int ch = g * Ng + n0 + c;
      const float* bias = a.bias ? a.bias + ch : nullptr;
      const float bv = bias ? __ldg(bias) : 0.f;
      const long long e0 =
          ((static_cast<long long>(tile.img) * a.Cout + ch) * a.OH +
           tile.oh0 + i) * a.OW + tile.ow0;
      const int s0 = c * a.LD + i * a.TW;
      float* dst = a.out + e0;
      int j = lane;
      if (((e0 | s0) & 3) == 0) {
        for (int q = lane; q < len >> 2; q += 32) {
          const int4 u = *reinterpret_cast<const int4*>(S + s0 + 4 * q);
          *reinterpret_cast<float4*>(dst + 4 * q) = make_float4(
              scaled(u.x, sc, bias, bv), scaled(u.y, sc, bias, bv),
              scaled(u.z, sc, bias, bv), scaled(u.w, sc, bias, bv));
        }
        j += len & ~3;
      }
      for (; j < len; j += 32) dst[j] = scaled(S[s0 + j], sc, bias, bv);
    }
    cp_async_wait<0>();
    if (tn < tiles) pn.store(a, tid, nthreads, raw, patch);
    __syncthreads();  // the next patch is staged, the tile written
  }
}

// -- Q2: split K over a thread-block cluster --------------------------------

constexpr int FC_MAX_SPLITS = 8;  // blocks a cluster (the portable limit)
constexpr int FC_LD = 72;         // a partial tile's row, in ints

struct FcArgs {
  const int8_t* x;  // (M, Kp)
  const int8_t* w;  // (N, Kp)
  const float* scale;
  const float* bias;
  float* out;  // (M, N)
  int M, N, Kp;
};

__global__ void __launch_bounds__(THREADS) qfc_kernel(FcArgs a) {
  constexpr int BM = 64, BN = 64, MT = BM / 32, NT = BN / 16;
  constexpr int STAGE = (BM + BN) * BK;
  static_assert(BM * FC_LD * 4 <= STAGES * STAGE, "the partial tile fits");
  __shared__ __align__(128) int8_t smem[STAGES * STAGE];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp & 1) * (BM / 2), wn0 = (warp >> 1) * (BN / 2);
  const int m0 = (blockIdx.x / S) * BM, n0 = blockIdx.y * BN;
  // this split's K steps: k0 .. k1, the steps dealt as evenly as can be
  const int nk = (a.Kp + BK - 1) / BK;
  const int k0 = split * nk / S, k1 = (split + 1) * nk / S;

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

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (k0 + st < k1) {
      ta.fetch(k0 + st, smem + st * STAGE);
      tb.fetch(k0 + st, smem + st * STAGE + BM * BK);
    }
    cp_async_commit();
  }
  for (int kt = k0; kt < k1; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int ahead = kt + STAGES - 1;
    if (ahead < k1) {
      int8_t* slot = smem + ((ahead - k0) % STAGES) * STAGE;
      ta.fetch(ahead, slot);
      tb.fetch(ahead, slot + BM * BK);
    }
    cp_async_commit();
    const int8_t* sA = smem + ((kt - k0) % STAGES) * STAGE;
    step_mma<MT, NT>(sA, sA + BM * BK, wm0, wn0, lane, acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the partial tile, row-major (8-byte stores: a half-warp's hit 32 banks)
  int* T = reinterpret_cast<int*>(smem);
  const int grp = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(
            T + (wm0 + mt * 16 + grp + 8 * h) * FC_LD + wn0 + nt * 8 +
            2 * t4) = make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  cluster.sync();
  // block `split` sums rows 64 split / S .. of every split's tile, four
  // columns a thread, and writes them
  const float sc = *a.scale;
  const int r0 = split * BM / S, r1 = (split + 1) * BM / S;
  for (int i = tid; i < (r1 - r0) * (BN / 4); i += THREADS) {
    const int row = r0 + i / (BN / 4), col = 4 * (i % (BN / 4));
    int4 sum = make_int4(0, 0, 0, 0);
    for (int z = 0; z < S; ++z) {
      const int4 v = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(T, z) + row * FC_LD + col);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int m = m0 + row, n = n0 + col;
    if (m >= a.M) continue;
    float* o = a.out + static_cast<long long>(m) * a.N + n;
    if (n + 3 < a.N && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(
          epilogue(sum.x, sc, a.bias, n), epilogue(sum.y, sc, a.bias, n + 1),
          epilogue(sum.z, sc, a.bias, n + 2),
          epilogue(sum.w, sc, a.bias, n + 3));
    } else {
      const int s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < a.N) o[j] = epilogue(s4[j], sc, a.bias, n + j);
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// An empty kernel: the launch floor that Q2's time is read beside.
__global__ void empty_kernel() {}

// -- Q1 on channels-last x --------------------------------------------------

constexpr int NHWC_THREADS = 256;  // eight warps

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

// Q1 on NCHW x.  x (N, C, H, W) int8 contiguous, w (Cout, Kp) int8 (OIHW
// rows padded with zeros to Kp, a multiple of 32, 16-byte aligned), scale
// one float32, bias (Cout,) float32 or null, out (N, Cout, OH, OW)
// float32.  bn: the N tile, 64 or 128 (ops/quantized.py:_plan).  Returns
// the launch's cudaError (0 on success).
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

// Q1, the stem's route.  x (N, C, H, W) int8 contiguous, C / groups at
// most 4; w (Cout, Kp) int8, rows k = (r * SB + s / 8) * 32 + (s % 8) * 4
// + c with SB = ceil(KW / 8), zeros at s >= KW and c >= C / groups, Kp >=
// KH * SB * 32 a multiple of 32, 16-byte aligned; scale, bias and out as
// mxtpu_qconv's.  R, TW: a block's output rows and columns, R * TW <= 256
// (ops/quantized.py:_plan_stem); a tile whose patch, weights or staged
// tile need more shared memory than a block has is refused.
int mxtpu_qconv_stem(const void* x, const void* w, const void* scale,
                     const void* bias, void* out, int N, int C, int H, int W,
                     int Cout, int KH, int KW, int sh, int sw, int ph, int pw,
                     int dh, int dw, int groups, int OH, int OW, int Kp, int R,
                     int TW, void* stream) {
  if (groups < 1 || groups > 65535 || C % groups || Cout % groups ||
      C / groups < 1 || C / groups > 4 || Kp % 32 ||
      Kp < KH * cdiv(KW, 8) * 32 || R < 1 || TW < 1 ||
      R * TW > STEM_PIXELS || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  StemArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
             static_cast<const float*>(scale), static_cast<const float*>(bias),
             static_cast<float*>(out), N, C, H, W, Cout, KH, KW, sh, sw, ph,
             pw, dh, dw, groups, OH, OW, Kp, R, TW};
  const long long smem = stem_layout(a);
  const long long tiles = static_cast<long long>(N) * a.RT * a.CT;
  const int ntiles = cdiv(Cout / groups, STEM_BN);
  if (smem > SMEM_MAX || tiles >= (1LL << 31) || ntiles > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        qconv_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  // persistent: as many blocks as the card holds at once, shared by the
  // channel tiles and groups, each walking the tiles
  const int threads = 32 * cdiv(R * TW, 32);
  int dev = 0, sms = 0, resident = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, qconv_stem_kernel, threads, static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = static_cast<long long>(resident) * sms /
                     (static_cast<long long>(ntiles) * groups);
  if (blocks < 1) blocks = 1;
  if (blocks > tiles) blocks = tiles;
  qconv_stem_kernel<<<dim3(static_cast<unsigned>(blocks), ntiles, groups),
                      threads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Q2.  x (M, Kp) and w (N, Kp) int8 (rows padded with zeros to Kp, a
// multiple of 32, 16-byte aligned), scale one float32, bias (N,) float32
// or null, out (M, N) float32.  splits: the blocks of a cluster that
// share a 64 x 64 tile's K, 1 to 8 and at most the 64-byte steps of K
// (ops/quantized.py:_plan_fc).
int mxtpu_qfc(const void* x, const void* w, const void* scale,
              const void* bias, void* out, int M, int N, int Kp, int splits,
              void* stream) {
  if (M < 1 || N < 1 || Kp < 1 || Kp % 32 || splits < 1 ||
      splits > FC_MAX_SPLITS || splits > cdiv(Kp, BK) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(cdiv(M, 64)) * splits;
  if (blocks >= (1LL << 31) || cdiv(N, 64) > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  FcArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
           static_cast<const float*>(scale), static_cast<const float*>(bias),
           static_cast<float*>(out), M, N, Kp};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), cdiv(N, 64), 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, qfc_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel (the launch floor).
int mxtpu_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
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
