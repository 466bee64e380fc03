// The backward of a 3x3, stride-1, pad-1 convolution for Hopper (sm_90a):
// both gradients behind one call, replacing the Pallas TPU kernel
// _bwd_kernel of mxtpu/ops/pallas/conv_bwd.py (K6, pallas_call :140).
//
//   dX[n,ci,h,w]  = sum_{kh,kw,co} dY[n,co,h+1-kh,w+1-kw] * W[co,ci,kh,kw]
//   dW[co,ci,kh,kw] = sum_{n,h,w} dY[n,co,h,w] * X[n,ci,h+kh-1,w+kw-1]
//
// with X and dY zero outside the image.  Operands keep PyTorch's layouts:
// x (N, Ci, H, W), dy (N, Co, H, W), w (Co, Ci, 3, 3), dx like x, dw
// like w.  The reference runs its two products at Precision.HIGHEST for
// float32; here both run on the tensor cores as warp-level
// mma.sync.m16n8k8 TF32 at float32 accuracy (3xTF32, tf32x3.cuh, as K3
// does): each operand is split once into TF32 (big, small) planes and a
// product is small*big + big*small + big*big.  A bfloat16 value is
// exactly a TF32 value, so in bfloat16 the small planes are zero and
// only big*big is issued: the same kernels run both types.
//
// Bounds on the H100 at ResNet-50's stage-1 shape, (128, 64, 56, 56)
// float32: the two products are 4*N*H*W*9*Ci*Co = 5.92e10 flops, 0.883
// ms at the 67 TFLOP/s float32 peak of the CUDA cores (the bound of the
// same function in true float32) and 0.359 ms as three TF32 products at
// the tensor cores' 495 TFLOP/s (the bound of this route); moving x, dy
// and dx (103 MB each) and the weights once takes 0.092 ms.  So the
// tensor cores bound it, and the design keeps them fed.
//
// Design.  The TPU kernel walks images in a sequential grid and adds each
// image's nine dW products into one VMEM block in place.  Blocks on the
// card run in parallel and in no order, so the two gradients are
// implicit GEMMs in kernels of their own, and dW's sum over pixels is
// split across blocks and reduced in a fixed order (no atomics):
//
//   split_weights   the pre-pass: W split once a call into a global
//                   (big, small) buffer in the order of dX's A fragments
//                   (every pixel tile re-reads the weights);
//   conv_dx_kernel  C[ci][pixel] over K = Co x 9 taps: A = the split
//                   weights, B = dY at the tap's shift.  One block per
//                   (pixel tile, 64 ci), 8 warps of 32 ci x 7 n8 tiles,
//                   two blocks an SM; K walks 8-channel slices, each
//                   slice's nine taps;
//   conv_dw_kernel  C[co][ci] of one tap over K = its split's pixels:
//                   A = dY, B = X at the tap's shift.  One block per
//                   (32 ci, 64 co, split), 18 warps: two a tap, 32 co x
//                   32 ci each;
//   conv_dw_reduce  sums the splits' float32 partials in order and
//                   writes dw in the weight's dtype.
//
// Pixel tiles are rectangles of tile rows x tile columns in the space
// of the N*H image rows (tc = min(W, 64) columns; 224 pixels for dX,
// 128 for dW, fewer where shared memory asks).  A tile's rows plus one
// halo row above and below, and its columns plus one halo column each
// side, are staged in shared memory, zeros outside the tensor: by
// cp.async in the widest copy the rows' alignment allows (16, 8 or 4
// bytes; a bfloat16 row of odd width element by element), and for dW's
// full-width tiles of 16-byte rows by bulk copies (cp.async.bulk, the
// TMA engine on a byte range: a channel's rows inside one image are one
// run), as are dX's split weights (nine runs a slice), completion
// counted on an mbarrier.  The block then splits the staged values once
// into planes, and every tap reads the same plane at its offset: dX
// reads each dY element once per 64-ci tile, not once per tap, and each
// dW block reads X once for all nine taps.  A tap whose row falls
// outside the pixel's image (a tile may span images) reads a zero plane
// entry instead.  The copies of the next tile (dW) or channel slice (dX,
// whose split weights are double-buffered) are issued as soon as the
// split has read the staged values, and land while the warps multiply:
// the staged values and the planes are the pipeline's two stages.
//
// The planes are laid out so that each fragment comes straight from
// shared memory into the registers an MMA reads (an mma.sync operand is
// a group of consecutive registers; a fragment assembled from wider
// loads costs a move per word, which first doubled dW's instructions),
// and so that a warp's loads hit 32 distinct banks (32-bit words; K is
// relabelled inside each k8 step, as the sum allows):
//   weights         [co slice][tap][m16 tile][big, small][lane]: A, one
//                   16-byte load per half (k = t, t+4 are co 2t, 2t+1);
//   dX's dY plane   [staged pixel][co pair p] = (big 2p, big 2p+1, small
//                   2p, small 2p+1) of the slice's 8 channels: lane (g,
//                   t)'s whole B fragment is one 16-byte load; 16 words a
//                   pixel, so two neighbouring pixels fill the 32 banks;
//   dW's dY         [m16 tile][k step][big, small][lane]: A, one 16-byte
//                   load per half (k = t, t+4 are the step's pixels t,
//                   t+4);
//   dW's X planes   big and small, each [staged pixel][ci] with 40 words
//                   a pixel (8 mod 32): a B fragment is four 4-byte loads
//                   at the two pixels' shifted entries.
//
// Accuracy.  An MMA adds into its accumulator with truncation, so a long
// chain of MMAs into one accumulator drifts one way (K3's lesson on the
// card; dW sums thousands of pixels a split).  Each k8 step's three MMAs
// run into a fresh accumulator (mma0: its first product starts from a
// zero register), which is added to the running float32 sum rounded to
// nearest.
//
// What bounds it.  mma.sync at m16n8k8 TF32 reaches its best issue rate
// only with 16 warps an SM or more, and with fresh accumulators each MMA
// also costs four adds and a load or two: at 3-4 instructions an MMA
// both kernels are bound by instruction issue, and by the barriers
// around each split, not by the tensor pipe.  So occupancy is set by
// registers and shared memory: dX two blocks of 8 warps an SM (108 KB at
// stage 1, 128 registers a thread), dW one block of 18 warps (~200 KB,
// 96 registers: five warps share a sub-core's 16K registers).  ptxas:
// dX 128 registers with 48 bytes spilled in float32 (80 in bfloat16), dW
// 96 registers, no spill.
//
// A fused pass (both gradients from one read of dY, as the reference
// does) would save ~0.03 ms of the 0.092 ms that bytes bound the whole
// call at; the products bound it at 0.359 ms, so it is not worth its
// registers yet.

#include "paged_common.cuh"
#include "tf32x3.cuh"

namespace {

using mxtpu_port::bulk_copy;
using mxtpu_port::cp_async16;
using mxtpu_port::cp_async4;
using mxtpu_port::cp_async8;
using mxtpu_port::cp_async_commit;
using mxtpu_port::cp_async_wait_all;
using mxtpu_port::from_float;
using mxtpu_port::kMaxSmem;
using mxtpu_port::mbar_expect;
using mxtpu_port::mbar_init;
using mxtpu_port::mbar_wait;
using mxtpu_port::mma;
using mxtpu_port::mma0;
using mxtpu_port::split;
using mxtpu_port::to_float;

constexpr int kSeg = 64;          // the widest tile row, in columns
constexpr int kXWarps = 8;        // dX: 2 ci groups x 4 pixel groups
constexpr int kXCi = 64;          // dX's ci tile: 4 m16 tiles
constexpr int kXNt = 7;           // n8 tiles a dX warp
constexpr int kXPix = 4 * 8 * kXNt;  // dX's pixel slots a block (224)
constexpr int kXSlice = 8;        // dX's co slice: one k8 step a tap
constexpr int kWMi = 2;           // m16 tiles (of co) a dW warp
constexpr int kWCo = 64;          // dW's co tile: 4 m16 tiles
constexpr int kWWarps = 9 * kWCo / (16 * kWMi);  // two warps a tap
constexpr int kWCi = 32;          // dW's ci tile: 4 n8 tiles
constexpr int kWPix = 128;        // dW's pixel tile, at most
constexpr int kXPlane = 16;       // words a staged pixel, dX's dY plane
constexpr int kWPlane = 40;       // words a staged pixel, dW's X planes
constexpr int kWBuf = 9 * 4 * 64; // uint4 of one slice's split weights

// The geometry of a call.  Tiles are tr x tc pixels in the space of the
// N*H image rows, and a staged row holds columns [c0 - eoff, c0 + tc +
// eoff) of the tensor (eoff = 0 when tc = W: the halo columns lie
// outside the image) as sr / E copies of `vec` bytes, E elements, lpr =
// 1 << lshift lanes a row.
struct Geo {
  int N, H, W, Ci, Co;
  int rows;  // N*H
  int tc, nseg, vec, E, eoff, sr, pw, lshift;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int a) { return (a + 3) & ~3; }

// A staged channel's stride, in elements: at least n, a multiple of E,
// and `res` words mod 32, which puts the split's reads on distinct banks.
inline int raw_stride(int n, int elt, int E, int res) {
  int ch = n;
  while (ch % E || (ch * elt) % 128 != 4 * res) ++ch;
  return ch;
}

// k8 steps of a dW tile
__host__ __device__ inline int w_steps(int tr, int tc) {
  return cdiv(tr * tc, 8);
}

// int words of the tables: dX's two mbarriers, row table and staged-pixel
// offsets; dW's tap table, dY offsets, pixel positions, its mbarrier,
// two row tables and staged-pixel offsets (the barriers and the int2
// tables start 8-byte aligned)
__host__ __device__ inline int x_ints(const Geo& g, int tr) {
  return round4(4 + 2 * (tr + 2) + (tr + 2) * g.pw);
}
__host__ __device__ inline int w_ints(const Geo& g, int tr) {
  return round4(11 * 8 * w_steps(tr, g.tc) + 4 + 4 * (tr + 2) +
                (tr + 2) * g.pw);
}

// dX: the double-buffered split weights, the dY plane with its three
// zero entries, the tables and one staged slice
size_t dx_smem(const Geo& g, int tr, int elt) {
  const int ch = raw_stride((tr + 2) * g.sr, elt, g.E, 4);
  return (size_t)2 * kWBuf * 16 + (size_t)((tr + 2) * g.pw + 3) * kXPlane * 4 +
         (size_t)x_ints(g, tr) * 4 + (size_t)cdiv(kXSlice * ch * elt, 16) * 16;
}

// dW: the X big and small planes with their zero entry, the dY fragments
// (4 m16 tiles x steps x big/small x 32 lanes), the tables and one staged
// tile of X and dY
size_t dw_smem(const Geo& g, int tr, int elt) {
  const int ks = w_steps(tr, g.tc);
  const int chx = raw_stride((tr + 2) * g.sr, elt, g.E, 4);
  const int chy = raw_stride(tr * g.sr, elt, g.E, 4);
  return (size_t)2 * ((tr + 2) * g.pw + 1) * kWPlane * 4 +
         (size_t)(kWCo / 16) * ks * 64 * 16 + (size_t)w_ints(g, tr) * 4 +
         (size_t)kWCi * chx * elt + (size_t)kWCo * chy * elt;
}

// One copy of `vec` bytes into shared memory (zeros when !ok); a 2-byte
// bfloat16, which cp.async cannot copy, element by element.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, bool ok,
                                           int vec) {
  if (vec == 16) {
    cp_async16(dst, src, ok);
  } else if (vec == 8) {
    cp_async8(dst, src, ok);
  } else if (vec == 4) {
    cp_async4(dst, src, ok);
  } else {
    *dst = ok ? *src : from_float<T>(0.f);
  }
}

// rows[wr] = (image, row in it) of image row r_lo + wr of the N*H, image
// -1 past the tensor, for wr < nrows
__device__ void row_table(int2* rows, int r_lo, int nrows, const Geo& g) {
  for (int wr = threadIdx.x; wr < nrows; wr += blockDim.x) {
    const int r = r_lo + wr;
    rows[wr] = r >= 0 && r < g.rows ? make_int2(r / g.H, r % g.H)
                                    : make_int2(-1, 0);
  }
}

// Start the copies of the image rows of `rows` (nrows of them) of
// channels [c_lo, c_lo + nch) of src (N, C, H, W) into raw[ch * CH + wr *
// sr + x], x holding column c0 - eoff + x; rows past the tensor,
// channels >= C and columns outside [0, W) land as zeros.  lpr lanes
// copy a row.
template <typename T>
__device__ void stage_rows(T* raw, int CH, const T* __restrict__ src, int C,
                           int c_lo, int nch, const int2* rows, int nrows,
                           int c0, const Geo& g) {
  const int lpr = 1 << g.lshift, chunks = g.sr / g.E;
  const int k0 = threadIdx.x & (lpr - 1);
  const float inv = 1.f / nrows;  // item / nrows, exact for items < 2^22
  for (int item = threadIdx.x >> g.lshift; item < nch * nrows;
       item += blockDim.x >> g.lshift) {
    const int ch = (int)((item + 0.5f) * inv), wr = item - ch * nrows;
    const int2 rh = rows[wr];
    const int c = c_lo + ch;
    const bool row_ok = rh.x >= 0 && c < C;
    const T* row = src + ((size_t)(row_ok ? rh.x * C + c : 0) * g.H + rh.y) *
                             g.W;
    T* dst = raw + ch * CH + wr * g.sr;
    for (int k = k0; k < chunks; k += lpr) {
      const int col = c0 - g.eoff + k * g.E;
      const bool ok = row_ok && col >= 0 && col < g.W;
      copy_chunk(dst + k * g.E, ok ? row + col : src, ok, g.vec);
    }
  }
}

// stage_rows by bulk copies, for full-width tiles of 16-byte rows (the
// staged rows of a channel are then one run a image): the calling lane
// copies channel c_lo + ch, arriving on `bar` with its bytes first;
// rows past the tensor and channels >= C are written as zeros.
template <typename T>
__device__ void stage_bulk(T* raw, int CH, const T* __restrict__ src, int C,
                           int c_lo, int ch, const int2* rows, int nrows,
                           uint64_t* bar, const Geo& g) {
  const int c = c_lo + ch;
  const unsigned row_bytes = g.W * sizeof(T);
  T* dst = raw + ch * CH;
  unsigned bytes = 0;
  for (int wr = 0; wr < nrows; ++wr)
    if (rows[wr].x >= 0 && c < C) bytes += row_bytes;
  mbar_expect(bar, bytes);
  for (int wr = 0; wr < nrows;) {
    const int2 rh = rows[wr];
    if (rh.x < 0 || c >= C) {
      uint4* z = reinterpret_cast<uint4*>(dst + wr * g.sr);
      for (unsigned k = 0; k < row_bytes / 16; ++k) z[k] = make_uint4(0, 0, 0, 0);
      ++wr;
      continue;
    }
    int len = 1;
    while (wr + len < nrows && rows[wr + len].x == rh.x) ++len;
    bulk_copy(dst + wr * g.sr, src + ((size_t)(rh.x * C + c) * g.H + rh.y) * g.W,
              len * row_bytes, bar);
    wr += len;
  }
}

// off[p] = the staged element (wr * sr + x) under plane entry p = wr * pw
// + wc (tensor column c0 + wc - 1), -1 where it is a full-width tile's
// halo column (outside the image), for p < nrows * pw
__device__ void staged_offsets(int* off, int nrows, const Geo& g) {
  for (int p = threadIdx.x; p < nrows * g.pw; p += blockDim.x) {
    const int wr = p / g.pw, x = p - wr * g.pw - 1 + g.eoff;
    off[p] = x >= 0 && x < g.tc + 2 * g.eoff ? wr * g.sr + x : -1;
  }
}

template <typename T>
__device__ __forceinline__ float staged(const T* raw, int off) {
  return off >= 0 ? to_float(raw[off]) : 0.f;
}

// c = a.b, one k8 step into a fresh accumulator: in 3xTF32 (small*big,
// big*small, big*big), or for bfloat16, whose small parts are zero,
// big*big alone
template <typename T>
__device__ __forceinline__ void step3(float (&c)[4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], uint4 b) {
  if (sizeof(T) == 4) {
    mma0(c, as, b.x, b.y);
    mma(c, ab, b.z, b.w);
    mma(c, ab, b.x, b.y);
  } else {
    mma0(c, ab, b.x, b.y);
  }
}

// -- the weights' pre-pass -------------------------------------------------

// out[((s * 9 + tap) * mti + mt) * 64 + half * 32 + lane]: lane (g, t)'s A
// fragment of dX's product for ci rows 16mt + g, + 8 and co 8s + 2t,
// 2t + 1 (k = t, t + 4), its big half (half 0) and small half (1); zeros
// past Ci and Co.
template <typename T>
__global__ void split_weights(const T* __restrict__ w, uint4* __restrict__ out,
                              int Ci, int Co, int mti) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cdiv(Co, 8) * 9 * mti * 32) return;
  const int lane = idx & 31, frag = idx >> 5;
  const int mt = frag % mti, tap = (frag / mti) % 9, s = frag / (mti * 9);
  const int g = lane >> 2, t = lane & 3;
  const int co = 8 * s + 2 * t, ci = 16 * mt + g;
  auto at = [&](int o, int i) {
    return o < Co && i < Ci ? to_float(w[((size_t)o * Ci + i) * 9 + tap])
                            : 0.f;
  };
  uint4 big, small;
  split(at(co, ci), big.x, small.x);
  split(at(co, ci + 8), big.y, small.y);
  split(at(co + 1, ci), big.z, small.z);
  split(at(co + 1, ci + 8), big.w, small.w);
  out[(size_t)frag * 64 + lane] = big;
  out[(size_t)frag * 64 + 32 + lane] = small;
}

// -- dX --------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(32 * kXWarps, 2)
    conv_dx_kernel(const T* __restrict__ dy, const uint4* __restrict__ wsp,
                   T* __restrict__ dx, Geo g, int tr, int ch_raw, int mti) {
  extern __shared__ uint4 smem[];
  uint4* wbuf = smem;                   // 2 x [tap][m16 tile][half][lane]
  uint4* plane = wbuf + 2 * kWBuf;      // [staged pixel][co pair]
  const int npx = (tr + 2) * g.pw;      // then three zero entries
  int* ints = reinterpret_cast<int*>(plane + (npx + 3) * 4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ints);  // the weights' two
  int2* rows = reinterpret_cast<int2*>(ints + 4);      // [tr + 2]
  int* xoff = reinterpret_cast<int*>(rows + tr + 2);   // [npx]
  T* raw = reinterpret_cast<T*>(ints + x_ints(g, tr));  // [8][ch_raw]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // ci group, pixel group
  const int r0 = (blockIdx.x / g.nseg) * tr;
  const int c0 = (blockIdx.x % g.nseg) * g.tc;
  const int mt0 = blockIdx.y * (kXCi / 16);
  const int P = tr * g.tc;
  if (threadIdx.x < 12) plane[npx * 4 + threadIdx.x] = make_uint4(0, 0, 0, 0);
  staged_offsets(xoff, tr + 2, g);
  row_table(rows, r0 - 1, tr + 2, g);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
  }

  // the lane's pixel (n index g) of each of its n8 tiles: its plane
  // entry, and which of the three tap rows lie in its image (none for a
  // slot past the tile or the tensor)
  int center[kXNt];
  unsigned rows_ok = 0;
#pragma unroll
  for (int nt = 0; nt < kXNt; ++nt) {
    center[nt] = npx + 1;
    const int m = (wn * kXNt + nt) * 8 + gq;
    const int i = m / g.tc, j = m - i * g.tc;
    const int r = r0 + i;
    if (m < P && r < g.rows && c0 + j < g.W) {
      const int h = r % g.H;
      center[nt] = (i + 1) * g.pw + j + 1;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
        if (h + 1 - kh >= 0 && h + 1 - kh < g.H) rows_ok |= 1u << (3 * nt + kh);
    }
  }

  // slice s: its dY rows by cp.async, its split weights (each tap's m16
  // tiles of the block, contiguous in wsp) as nine bulk copies; m16
  // tiles past Ci are left as they are, since they feed only C rows past
  // Ci, which are never stored
  const int slices = cdiv(g.Co, kXSlice);
  const unsigned tap_bytes = min(4, mti - mt0) * 64 * 16;
  auto issue = [&](int s) {
    stage_rows(raw, ch_raw, dy, g.Co, kXSlice * s, kXSlice, rows, tr + 2, c0,
               g);
    cp_async_commit();
    if (threadIdx.x == 0) {
      uint64_t* bar = bars + (s & 1);
      mbar_expect(bar, 9 * tap_bytes);
      for (int tap = 0; tap < 9; ++tap)
        bulk_copy(wbuf + (s & 1) * kWBuf + tap * 256,
                  wsp + (((size_t)s * 9 + tap) * mti + mt0) * 64, tap_bytes,
                  bar);
    }
  };

  float acc[2][kXNt][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < kXNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  __syncthreads();  // the row table, the barriers
  issue(0);
  for (int s = 0; s < slices; ++s) {
    // slice s has landed; no warp still reads the plane of slice s-1
    cp_async_wait_all();
    mbar_wait(bars + (s & 1), (s >> 1) & 1);
    __syncthreads();
    // split: lane = (staged pixel pb*8 + g, co pair t)
    for (int pb = warp; pb * 8 < npx; pb += kXWarps) {
      const int p = pb * 8 + gq;
      if (p >= npx) continue;
      const int off = xoff[p];
      uint4 o;
      split(staged(raw + 2 * t * ch_raw, off), o.x, o.z);
      split(staged(raw + (2 * t + 1) * ch_raw, off), o.y, o.w);
      plane[p * 4 + t] = o;
    }
    __syncthreads();
    if (s + 1 < slices) issue(s + 1);  // lands while the warps multiply
    const uint4* wb = wbuf + (s & 1) * kWBuf + 2 * wm * 64 + lane;
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
      // the tap row's plane entry of each pixel; a zero entry (npx .. npx
      // + 2 with the column shift) where the row lies outside the image
      const uint4* row[kXNt];
#pragma unroll
      for (int nt = 0; nt < kXNt; ++nt)
        row[nt] = plane + 4 * ((rows_ok >> (3 * nt + kh)) & 1
                                   ? center[nt] + (1 - kh) * g.pw
                                   : npx + 1) + t;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const uint4* f = wb + (3 * kh + kw) * 256;
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          *reinterpret_cast<uint4*>(ab[mi]) = f[mi * 64];
          *reinterpret_cast<uint4*>(as[mi]) = f[mi * 64 + 32];
        }
#pragma unroll
        for (int nt = 0; nt < kXNt; ++nt) {
          const uint4 b = row[nt][4 * (1 - kw)];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            float c[4];
            step3<T>(c, ab[mi], as[mi], b);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][nt][e] += c[e];
          }
        }
      }
    }
  }

  // C fragment: ci rows g, g + 8 of the m16 tile; pixels 2t, 2t + 1
#pragma unroll
  for (int nt = 0; nt < kXNt; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = (wn * kXNt + nt) * 8 + 2 * t + (e & 1);
      const int i = m / g.tc, j = m - i * g.tc;
      const int r = r0 + i, c = c0 + j;
      if (m >= P || r >= g.rows || c >= g.W) continue;
      const int n = r / g.H, h = r - n * g.H;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int ci = (mt0 + 2 * wm + mi) * 16 + gq + 8 * (e >> 1);
        if (ci < g.Ci)
          dx[((size_t)(n * g.Ci + ci) * g.H + h) * g.W + c] =
              from_float<T>(acc[mi][nt][e]);
      }
    }
  }
}

// -- dW --------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(32 * kWWarps, 1)
    conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   float* __restrict__ ws, Geo g, int tr, int ch_x, int ch_y,
                   int tiles, int chunk) {
  extern __shared__ uint4 smem[];
  const int ks_n = w_steps(tr, g.tc), pix = 8 * ks_n;
  const int npx = (tr + 2) * g.pw, zero = npx;
  uint32_t* xbig = reinterpret_cast<uint32_t*>(smem);  // [pixel][ci]
  uint32_t* xsmall = xbig + (npx + 1) * kWPlane;
  uint4* yfrag = reinterpret_cast<uint4*>(xsmall + (npx + 1) * kWPlane);
  int* tab = reinterpret_cast<int*>(yfrag + (kWCo / 16) * ks_n * 64);
  int* yoff = tab + 9 * pix;       // dY's staged element of each pixel
  int* pos = yoff + pix;           // (row << 16 | column) of each pixel
  uint64_t* bar = reinterpret_cast<uint64_t*>(pos + pix);  // the tile's
  int2* rows = reinterpret_cast<int2*>(bar + 2);            // 2 x [tr + 2]
  int* xoff = reinterpret_cast<int*>(rows + 2 * (tr + 2));  // X's staged
                                                           // element of
                                                           // each entry
  T* raw_x = reinterpret_cast<T*>(tab + w_ints(g, tr));  // [32][ch_x]
  T* raw_y = raw_x + kWCi * ch_x;                        // [64][ch_y]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int tap = warp % 9, mt0 = (warp / 9) * kWMi;  // the warp's m16 tiles
  const int ci0 = blockIdx.x * kWCi, co0 = blockIdx.y * kWCo;
  const int P = tr * g.tc;
  const int first = blockIdx.z * chunk, last = min(first + chunk, tiles);

  for (int q = threadIdx.x; q < kWPlane; q += blockDim.x) {
    xbig[zero * kWPlane + q] = 0u;
    xsmall[zero * kWPlane + q] = 0u;
  }
  for (int m = threadIdx.x; m < pix; m += blockDim.x) {
    const int i = m / g.tc, j = m - i * g.tc;
    yoff[m] = m < P ? i * g.sr + g.eoff + j : -1;
    pos[m] = m < P ? i << 16 | j : -1;
  }
  staged_offsets(xoff, tr + 2, g);
  // full-width tiles of 16-byte rows go by bulk copies, issued by the
  // first three warps (a lane a channel of X, then of dY)
  const bool bulk = g.vec == 16 && g.eoff == 0;
  if (threadIdx.x == 0) mbar_init(bar, kWCi + kWCo);

  auto issue = [&](int tile) {
    const int c0 = (tile % g.nseg) * g.tc;
    const int2* rt = rows + (tile & 1) * (tr + 2);
    if (!bulk) {
      stage_rows(raw_x, ch_x, x, g.Ci, ci0, kWCi, rt, tr + 2, c0, g);
      stage_rows(raw_y, ch_y, dy, g.Co, co0, kWCo, rt + 1, tr, c0, g);
      cp_async_commit();
    } else if (warp == 0) {
      stage_bulk(raw_x, ch_x, x, g.Ci, ci0, lane, rt, tr + 2, bar, g);
    } else if (warp < 3) {
      stage_bulk(raw_y, ch_y, dy, g.Co, co0, lane + 32 * (warp - 1), rt + 1, tr,
                 bar, g);
    }
  };

  float acc[kWMi][4][4];
#pragma unroll
  for (int mi = 0; mi < kWMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  if (first < last) {
    row_table(rows + (first & 1) * (tr + 2), (first / g.nseg) * tr - 1, tr + 2,
              g);
    __syncthreads();
    issue(first);
  }
  for (int tile = first; tile < last; ++tile) {
    const int c0 = (tile % g.nseg) * g.tc;
    const int2* rt = rows + (tile & 1) * (tr + 2);
    // the tile has landed; no warp still reads the planes of the last
    cp_async_wait_all();
    if (bulk) mbar_wait(bar, (tile - first) & 1);
    __syncthreads();
    // X: lane = (staged pixel pb*4 + lane/8, ci cb*8 + lane%8)
    for (int item = warp; item < cdiv(npx, 4) * 4; item += kWWarps) {
      const int p = (item >> 2) * 4 + (lane >> 3), ci = (item & 3) * 8 + (lane & 7);
      if (p >= npx) continue;
      uint32_t big, small;
      split(staged(raw_x + ci * ch_x, xoff[p]), big, small);
      xbig[p * kWPlane + ci] = big;
      xsmall[p * kWPlane + ci] = small;
    }
    // dY: lane (g, t)'s A fragments of m16 tile mt, k8 step ks: co rows g,
    // g + 8; k = t, t + 4 are pixels 8ks + t, 8ks + t + 4
    for (int item = warp; item < (kWCo / 16) * ks_n; item += kWWarps) {
      const int mt = item / ks_n, ks = item - mt * ks_n;
      const T* r0w = raw_y + (16 * mt + gq) * ch_y;
      const T* r8w = r0w + 8 * ch_y;
      const int y0 = yoff[8 * ks + t], y4 = yoff[8 * ks + t + 4];
      uint4 big, small;
      split(staged(r0w, y0), big.x, small.x);
      split(staged(r8w, y0), big.y, small.y);
      split(staged(r0w, y4), big.z, small.z);
      split(staged(r8w, y4), big.w, small.w);
      uint4* f = yfrag + (mt * ks_n + ks) * 64 + lane;
      f[0] = big;
      f[32] = small;
    }
    // each tap's X plane entry for each pixel: zero where the tap's row
    // lies outside the pixel's image, or the pixel outside the tensor
    for (int m = threadIdx.x; m < pix; m += blockDim.x) {
      const int pm = pos[m], i = pm >> 16, j = pm & 0xffff;
      const int2 rh = pm >= 0 ? rt[i + 1] : make_int2(-1, 0);
      const bool in = rh.x >= 0 && c0 + j < g.W;
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const int hh = rh.y + q / 3 - 1;
        tab[q * pix + m] = in && hh >= 0 && hh < g.H
                               ? (i + q / 3) * g.pw + j + q % 3
                               : zero;
      }
    }
    if (tile + 1 < last)
      row_table(rows + ((tile + 1) & 1) * (tr + 2),
                ((tile + 1) / g.nseg) * tr - 1, tr + 2, g);
    __syncthreads();
    if (tile + 1 < last) issue(tile + 1);  // lands while the warps multiply
    const int* tt = tab + tap * pix + t;
    const uint4* fa = yfrag + mt0 * ks_n * 64 + lane;
    for (int ks = 0; ks < ks_n; ++ks) {
      const int o0 = tt[8 * ks] * kWPlane + gq, o1 = tt[8 * ks + 4] * kWPlane + gq;
      uint32_t ab[kWMi][4], as[kWMi][4];
#pragma unroll
      for (int mi = 0; mi < kWMi; ++mi) {
        *reinterpret_cast<uint4*>(ab[mi]) = fa[(mi * ks_n + ks) * 64];
        *reinterpret_cast<uint4*>(as[mi]) = fa[(mi * ks_n + ks) * 64 + 32];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // k = t, t + 4: pixels 8ks + t, 8ks + t + 4 at the tap's shift
        const uint4 b = make_uint4(xbig[o0 + 8 * ni], xbig[o1 + 8 * ni],
                                   xsmall[o0 + 8 * ni], xsmall[o1 + 8 * ni]);
#pragma unroll
        for (int mi = 0; mi < kWMi; ++mi) {
          float c[4];
          step3<T>(c, ab[mi], as[mi], b);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += c[e];
        }
      }
    }
  }

  // C fragment: co rows g, g + 8 of the m16 tile; ci 2t, 2t + 1 of the n8
  float* out = ws + ((size_t)blockIdx.z * 9 + tap) * g.Co * g.Ci;
#pragma unroll
  for (int mi = 0; mi < kWMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + 16 * (mt0 + mi) + gq + 8 * (e >> 1);
        const int ci = ci0 + 8 * ni + 2 * t + (e & 1);
        if (co < g.Co && ci < g.Ci) out[(size_t)co * g.Ci + ci] = acc[mi][ni][e];
      }
}

// dw[co][ci][tap] = sum over splits, in order, of ws[split][tap][co][ci]
template <typename T>
__global__ void conv_dw_reduce(const float* __restrict__ ws,
                               T* __restrict__ dw, int splits, int Ci,
                               int Co) {
  const int total = 9 * Co * Ci;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ci = idx % Ci, co = (idx / Ci) % Co, tap = idx / (Ci * Co);
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += ws[(size_t)sp * total + idx];
  dw[((size_t)co * Ci + ci) * 9 + tap] = from_float<T>(sum);
}

template <typename T>
int launch(const void* x, const void* dy, const void* w, void* dx, void* dw,
           void* ws, void* wsp, int N, int H, int W, int Ci, int Co,
           int tr_x, int tr_w, int vec, int splits, int chunk,
           void* stream) {
  const int elt = sizeof(T);
  if (N < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || tr_x < 1 || tr_w < 1 ||
      splits < 1 || chunk < 1 || (vec != 16 && vec != 8 && vec != 4 &&
                                  !(vec == 2 && elt == 2)))
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.N = N; g.H = H; g.W = W; g.Ci = Ci; g.Co = Co;
  g.rows = N * H;
  g.tc = W < kSeg ? W : kSeg;
  g.nseg = cdiv(W, g.tc);
  g.vec = vec;
  g.E = vec / elt > 0 ? vec / elt : 1;
  g.eoff = g.tc < W ? g.E : 0;
  g.sr = g.tc + 2 * g.eoff;
  g.pw = g.tc + 2;
  g.lshift = 0;
  while ((1 << g.lshift) < g.sr / g.E && g.lshift < 5) ++g.lshift;
  const int tiles_w = cdiv(g.rows, tr_w) * g.nseg;
  if (W % g.E || tr_x * g.tc > kXPix || tr_w * g.tc > kWPix ||
      (long long)splits * chunk < tiles_w ||
      (long long)(splits - 1) * chunk >= tiles_w)
    return (int)cudaErrorInvalidValue;
  const size_t smem_x = dx_smem(g, tr_x, elt), smem_w = dw_smem(g, tr_w, elt);
  if (smem_x > kMaxSmem || smem_w > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int mti = cdiv(Ci, 16);

  const int frags = cdiv(Co, 8) * 9 * mti * 32;
  split_weights<T><<<cdiv(frags, 256), 256, 0, st>>>(
      (const T*)w, (uint4*)wsp, Ci, Co, mti);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = mxtpu_port::allow_smem(conv_dx_kernel<T>, smem_x);
  if (err != cudaSuccess) return (int)err;
  const dim3 gx(cdiv(g.rows, tr_x) * g.nseg, cdiv(Ci, kXCi));
  conv_dx_kernel<T><<<gx, 32 * kXWarps, smem_x, st>>>(
      (const T*)dy, (const uint4*)wsp, (T*)dx, g, tr_x,
      raw_stride((tr_x + 2) * g.sr, elt, g.E, 4), mti);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = mxtpu_port::allow_smem(conv_dw_kernel<T>, smem_w);
  if (err != cudaSuccess) return (int)err;
  const dim3 gw(cdiv(Ci, kWCi), cdiv(Co, kWCo), splits);
  conv_dw_kernel<T><<<gw, 32 * kWWarps, smem_w, st>>>(
      (const T*)x, (const T*)dy, (float*)ws, g, tr_w,
      raw_stride((tr_w + 2) * g.sr, elt, g.E, 4),
      raw_stride(tr_w * g.sr, elt, g.E, 4), tiles_w, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int total = 9 * Co * Ci;
  conv_dw_reduce<T><<<cdiv(total, 256), 256, 0, st>>>(
      (const float*)ws, (T*)dw, splits, Ci, Co);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define MXTPU_CONV_BWD_ENTRY(SUFFIX, TYPE)                                    \
  int mxtpu_conv_bwd_##SUFFIX(const void* x, const void* dy, const void* w,  \
                              void* dx, void* dw, void* ws, void* wsp, int N, \
                              int H, int W, int Ci, int Co, int tr_x,        \
                              int tr_w, int vec, int splits, int chunk,      \
                              void* stream) {                                \
    return launch<TYPE>(x, dy, w, dx, dw, ws, wsp, N, H, W, Ci, Co, tr_x,    \
                        tr_w, vec, splits, chunk, stream);                   \
  }

MXTPU_CONV_BWD_ENTRY(f32, float)
MXTPU_CONV_BWD_ENTRY(bf16, __nv_bfloat16)

#undef MXTPU_CONV_BWD_ENTRY

}  // extern "C"
