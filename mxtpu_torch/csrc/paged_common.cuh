// Shared device code of the two paged-attention kernels
// (paged_attention.cu: pooled decode; prefill_attention.cu: chunked
// prefill).  Both walk ONE block-table row of the paged KV pool for ONE
// kv head, with a float32 online softmax carried across the walk, for a
// set of query lanes whose causal limit differs per lane:
//
//   decode  — lane l = r*W + w of slot b attends positions <= pos[b] + w;
//   tree    — lane l = r*W + w attends positions < pos[b] (the committed
//             history) and the window positions pos[b] + j whose bit j
//             is set in anc[b, w] | (1 << w) (its ancestors and itself);
//   prefill — fold lane L = r*T + t of the chunk attends positions
//             <= start + t.
//
// So a key at position `key` is attended by lane ln when key <= lim[ln],
// or when rel = key - win_lo lies in [0, 32) with bit rel set in the
// lane's window mask win[ln].  Plain decode and prefill lanes carry an
// empty mask.
//
// The Pallas kernels on the TPU ran the page walk as the sequential
// third grid axis with the softmax state in VMEM scratch; here the walk
// is a loop inside one CUDA block and the state lives in shared memory.
// The arithmetic is the Pallas kernels': queries pre-scaled by sm_scale
// in float32, masked scores at -1e30, m_new = max(m_prev, max s),
// p = exp(s - m_new), l = l*corr + sum p, acc = acc*corr + p.V, and the
// output acc / max(l, 1e-30) in the query's dtype.
//
// Layout: pools are (N, KV, bs, D) row-major, so one page of one kv
// head is a contiguous bs*D run.  Page 0 is the null page.
//
// Two element types: T for the queries and the output (float32), P for
// the pools (float32, or int8).  An int8 pool
// comes with float32 scales (N, KV, bs), one per head and position, so
// a page's bs scales are contiguous at scales[(page * KV + kv) * bs].
// Each tile's key and value scales are staged with its payload, in the
// same cp.async group, and a value is dequantized where it is read from
// shared memory: (float)payload * scale, the reference's float32
// product k * ks[:, None].  From there on the float32 math is the float
// pools' own, so every invariant of the walk holds on int8 pools bit for
// bit.
//
// The walk goes a TILE of up to kTileKeys keys (a whole number of pages)
// at a time.  Tiles are copied into shared memory with cp.async, 16
// bytes per copy (8 for an int8 pool), double-buffered where the block's
// shared memory allows: the copies of tile j+1
// are in flight while the block computes on tile j, so a slot's walk
// waits on memory about once rather than once per page.  The block
// stages its table row's page ids in shared memory first.  Pages past
// the walk's end land as zeros and their keys are masked.  Rows are
// padded (8 elements of a float pool, 16 bytes of an int8 one; each
// row starts aligned for its copies) so the threads of a warp, each on
// its own key row at the same column, read different banks.  The dot
// products run on the CUDA cores in float32: this walk is the float32
// route of both kernels (float32 queries).  Their bfloat16 queries take
// the tensor cores (paged_attention.cu, prefill_attention.cu), with the
// mma.sync helpers at the end of this file.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace mxtpu_port {

constexpr float kNegInf = -1e30f;
constexpr int kTileKeys = 64;        // keys staged per step of the walk
constexpr int kLanesPerThread = 8;   // score accumulators per thread
constexpr size_t kMaxSmem = 232448;  // shared memory one block may use

template <typename P>
constexpr bool kQuant = sizeof(P) == 1;  // an int8 pool, with scales

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive elements (8-, 16- or 32-byte aligned) as float32
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
// int8 payload values, not yet scaled
__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = (float)(signed char)(u.x >> (8 * i));
    f[4 + i] = (float)(signed char)(u.y >> (8 * i));
  }
}

// 2 consecutive elements as float32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const unsigned short h = *reinterpret_cast<const unsigned short*>(p);
  return make_float2((float)(signed char)(h & 0xffu),
                     (float)(signed char)(h >> 8));
}

// 16-byte asynchronous copy global -> shared; with valid == false the
// 16 shared bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
// the same for 8 bytes (8 int8 values) and for 4 (a scale)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
// A bulk copy (cp.async.bulk: the TMA engine on a plain byte range, no
// tensor map) of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, its completion counted in bytes on an mbarrier.
// One thread inits the barrier for `count` arrivals; each round every
// issuing thread arrives with its byte count, then issues its copies, and
// every thread waits for the round's phase parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  // the buffer's last reads were generic loads; the copy is the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   b),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Keys per tile for a block size: a whole number of pages, at most
// kTileKeys (one page when bs > kTileKeys / 2).
__host__ __device__ inline int tile_keys(int bs) {
  const int pages = kTileKeys / bs > 1 ? kTileKeys / bs : 1;
  return pages * bs;
}

// Query lanes one block can hold: each thread keeps kLanesPerThread
// score accumulators for one key of the tile.
__host__ __device__ inline int max_lanes(int threads, int bs) {
  return kLanesPerThread * (threads / tile_keys(bs));
}

// Elements of one staged key or value row: D plus padding, so that the
// row is a whole number of copies (16 bytes for a float pool, 8 for an
// int8 one, so that head_dim 8 works too; elt = the pool's element
// size, 1 for int8).
__host__ __device__ inline int row_elems(int D, int elt) {
  return D + (elt == 1 ? 16 : 8);
}

// Floats of one block's scale buffers (an int8 pool's key and value
// scales per tile buffer), rounded up to keep what follows 16-byte
// aligned; 0 for a float pool.
__host__ __device__ inline size_t scale_floats(int bs, int elt, int stages) {
  return elt == 1 ? (2 * (size_t)stages * tile_keys(bs) + 3) / 4 * 4 : 0;
}

// Shared memory one block needs, in bytes, with `stages` tile buffers,
// for a table row of M pages (elt = the pool's element size).
__host__ __device__ inline size_t attend_smem_bytes(int lanes, int D, int bs,
                                                    int M, int elt,
                                                    int stages) {
  const size_t kv =
      2 * (size_t)stages * tile_keys(bs) * row_elems(D, elt) * elt;
  const size_t floats = scale_floats(bs, elt, stages)            // scales
                        + (size_t)lanes * D                      // q
                        + (size_t)lanes * tile_keys(bs)          // scores
                        + 3 * (size_t)lanes                      // m, l, corr
                        + (size_t)lanes * D;                     // acc
  return kv + floats * sizeof(float) + (2 * (size_t)lanes + M) * sizeof(int);
}

// Tile buffers a launch uses: two when they fit in kMaxSmem, else one
// (0 when not even one fits).
__host__ __device__ inline int attend_stages(int lanes, int D, int bs, int M,
                                             int elt) {
  if (attend_smem_bytes(lanes, D, bs, M, elt, 2) <= kMaxSmem) return 2;
  return attend_smem_bytes(lanes, D, bs, M, elt, 1) <= kMaxSmem ? 1 : 0;
}

// Pointers into one block's dynamic shared memory (P: the pool's
// element type).
template <typename P>
struct AttendSmem {
  P* k[2];      // key tiles, tile_keys x row_elems each (one buffer,
  P* v[2];      //   twice, when single-buffered); value tiles, the same
  float* ks[2]; // an int8 pool's key and value scales, tile_keys each
  float* vs[2]; //   (null for a float pool)
  float* q;     // lanes x D, pre-scaled queries
  float* s;     // lanes x tile_keys, scores then probabilities
  float* m;     // lanes, running max
  float* l;     // lanes, running denominator
  float* corr;  // lanes, this tile's rescale factor
  float* acc;   // lanes x D, running numerator
  int* lim;     // lanes, last key position each lane attends
  unsigned* win;  // lanes, window mask: bit j = key win_lo + j attended
  int* pages;   // the walked table row's page ids

  __device__ AttendSmem(void* base, int lanes, int D, int bs, int stages) {
    const int elt = (int)sizeof(P);
    const int kt = tile_keys(bs);
    const size_t tile = (size_t)kt * row_elems(D, elt);
    P* t = reinterpret_cast<P*>(base);
    k[0] = t;
    v[0] = t + tile;
    k[1] = stages == 2 ? t + 2 * tile : k[0];
    v[1] = stages == 2 ? t + 3 * tile : v[0];
    float* sc = reinterpret_cast<float*>(t + 2 * stages * tile);
    const bool quant = kQuant<P>;
    ks[0] = quant ? sc : nullptr;
    vs[0] = quant ? sc + kt : nullptr;
    ks[1] = quant && stages == 2 ? sc + 2 * kt : ks[0];
    vs[1] = quant && stages == 2 ? sc + 3 * kt : vs[0];
    q = sc + scale_floats(bs, elt, stages);
    s = q + lanes * D;
    m = s + lanes * kt;
    l = m + lanes;
    corr = l + lanes;
    acc = corr + lanes;
    lim = reinterpret_cast<int*>(acc + lanes * D);
    win = reinterpret_cast<unsigned*>(lim + lanes);
    pages = reinterpret_cast<int*>(win + lanes);
  }
};

// Copy `rows` contiguous rows of D elements into shared memory as
// float32 (row stride D), times `scale`.
template <typename T>
__device__ void load_rows(float* dst, const T* src, int rows, int D,
                          float scale) {
  const int n = rows * D;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = to_float(src[i]) * scale;
}

// Start the copies of the pages [p0, p0 + kt/bs) of one table row into
// a key and a value tile (and, for an int8 pool, their scales into
// kscale and vscale); pages at or past nv land as zeros.
template <typename P>
__device__ void issue_tile(P* kdst, P* vdst, float* kscale, float* vscale,
                           const P* __restrict__ pool_k,
                           const P* __restrict__ pool_v,
                           const float* __restrict__ k_scales,
                           const float* __restrict__ v_scales,
                           const int* table, int p0, int nv, int kv, int KV,
                           int bs, int D) {
  // elements per copy: 16 bytes of a float pool, 8 int8 values
  constexpr int E = kQuant<P> ? 8 : 16 / sizeof(P);
  const int per_row = D / E;
  const int ld = row_elems(D, (int)sizeof(P));
  const int kt = tile_keys(bs);
  const int total = kt * per_row;
  for (int c = threadIdx.x; c < total; c += blockDim.x) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * E;
    const int page = p0 + r / bs;
    const bool valid = page < nv;
    const size_t off =
        valid ? (((size_t)table[page] * KV + kv) * bs + r % bs) * D + col : 0;
    if constexpr (kQuant<P>) {
      cp_async8(kdst + r * ld + col, pool_k + off, valid);
      cp_async8(vdst + r * ld + col, pool_v + off, valid);
    } else {
      cp_async16(kdst + r * ld + col, pool_k + off, valid);
      cp_async16(vdst + r * ld + col, pool_v + off, valid);
    }
  }
  if constexpr (kQuant<P>) {
    for (int r = threadIdx.x; r < kt; r += blockDim.x) {
      const int page = p0 + r / bs;
      const bool valid = page < nv;
      const size_t off =
          valid ? ((size_t)table[page] * KV + kv) * bs + r % bs : 0;
      cp_async4(kscale + r, k_scales + off, valid);
      cp_async4(vscale + r, v_scales + off, valid);
    }
  }
}

// The page walk.  On entry sm.q holds the lanes' queries, sm.lim their
// limits and sm.win their window masks (relative to key position
// win_lo), all visible to the whole block (the caller synced); nv pages
// are walked (the caller trims it to the last page any lane attends).
// Writes the lanes' outputs to `out` (lanes x D, contiguous).
// blockDim.x must be a multiple of 32 and at least tile_keys(bs), and
// lanes at most max_lanes(blockDim.x, bs).  k_scales and v_scales are
// an int8 pool's scales (unused for a float pool).
template <typename T, typename P>
__device__ void attend_pages(const AttendSmem<P>& sm, int stages, int lanes,
                             const P* __restrict__ pool_k,
                             const P* __restrict__ pool_v,
                             const float* __restrict__ k_scales,
                             const float* __restrict__ v_scales,
                             const int* table, int nv, int win_lo,
                             int kv, int KV, int bs, int D,
                             T* __restrict__ out) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int kt = tile_keys(bs);
  const int per_tile = kt / bs;
  const int ntiles = (nv + per_tile - 1) / per_tile;
  const int ld = row_elems(D, (int)sizeof(P));
  // scores: thread (t, g) owns key t of the tile for lanes g, g+G, ...
  const int G = nthreads / kt;
  const int t = tid % kt;
  const int g = tid / kt;
  const int warp = tid / 32;
  const int wl = tid % 32;
  const int nwarps = nthreads / 32;
  const int half = D / 2;

  for (int i = tid; i < lanes; i += nthreads) {
    sm.m[i] = kNegInf;
    sm.l[i] = 0.f;
  }
  for (int i = tid; i < lanes * D; i += nthreads) sm.acc[i] = 0.f;
  // the page ids once, so no tile's copies wait on a table read
  for (int i = tid; i < nv; i += nthreads) sm.pages[i] = table[i];
  __syncthreads();
  table = sm.pages;

  if (stages == 2) {
    issue_tile(sm.k[0], sm.v[0], sm.ks[0], sm.vs[0], pool_k, pool_v,
               k_scales, v_scales, table, 0, nv, kv, KV, bs, D);
    cp_async_commit();
  }
  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (stages == 1) {
      issue_tile(sm.k[0], sm.v[0], sm.ks[0], sm.vs[0], pool_k, pool_v,
                 k_scales, v_scales, table, j * per_tile, nv, kv, KV, bs, D);
      cp_async_commit();
      cp_async_wait_all();
    } else if (j + 1 < ntiles) {
      issue_tile(sm.k[st ^ 1], sm.v[st ^ 1], sm.ks[st ^ 1], sm.vs[st ^ 1],
                 pool_k, pool_v, k_scales, v_scales, table,
                 (j + 1) * per_tile, nv, kv, KV, bs, D);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const P* kb = sm.k[st];
    const P* vb = sm.v[st];
    const float* ksb = sm.ks[st];
    const float* vsb = sm.vs[st];

    // scores, masked past each lane's limit
    if (g < G) {
      float dot[kLanesPerThread];
#pragma unroll
      for (int u = 0; u < kLanesPerThread; ++u) dot[u] = 0.f;
      float key_scale = 1.f;
      if constexpr (kQuant<P>) key_scale = ksb[t];
      for (int d = 0; d < D; d += 8) {
        float kf[8];
        load8(kb + t * ld + d, kf);
        if constexpr (kQuant<P>) {
#pragma unroll
          for (int i = 0; i < 8; ++i) kf[i] *= key_scale;
        }
#pragma unroll
        for (int u = 0; u < kLanesPerThread; ++u) {
          const int ln = g + u * G;
          if (ln < lanes) {
            float qf[8];
            load8(sm.q + ln * D + d, qf);
#pragma unroll
            for (int i = 0; i < 8; ++i) dot[u] += qf[i] * kf[i];
          }
        }
      }
      const int key = j * kt + t;
      // (unsigned)rel >= 32 for keys before win_lo: no window bit
      const unsigned rel = (unsigned)(key - win_lo);
#pragma unroll
      for (int u = 0; u < kLanesPerThread; ++u) {
        const int ln = g + u * G;
        if (ln < lanes) {
          const bool ok = key <= sm.lim[ln] ||
                          (rel < 32u && ((sm.win[ln] >> rel) & 1u));
          sm.s[ln * kt + t] = ok ? dot[u] : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per lane
    for (int ln = warp; ln < lanes; ln += nwarps) {
      float* row = sm.s + ln * kt;
      float mx = kNegInf;
      for (int i = wl; i < kt; i += 32) mx = fmaxf(mx, row[i]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm.m[ln];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int i = wl; i < kt; i += 32) {
        const float e = expf(row[i] - m_new);
        row[i] = e;
        sum += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (wl == 0) {
        const float c = expf(m_prev - m_new);
        sm.l[ln] = sm.l[ln] * c + sum;
        sm.m[ln] = m_new;
        sm.corr[ln] = c;
      }
    }
    __syncthreads();

    // acc = acc*corr + p.V, two columns per thread
    for (int o = tid; o < lanes * half; o += nthreads) {
      const int ln = o / half;
      const int d = 2 * (o - ln * half);
      const float* p = sm.s + ln * kt;
      const float c = sm.corr[ln];
      float a0 = sm.acc[ln * D + d] * c;
      float a1 = sm.acc[ln * D + d + 1] * c;
#pragma unroll 4
      for (int k = 0; k < kt; ++k) {
        float2 v = load2(vb + k * ld + d);
        if constexpr (kQuant<P>) {
          v.x *= vsb[k];
          v.y *= vsb[k];
        }
        a0 += p[k] * v.x;
        a1 += p[k] * v.y;
      }
      sm.acc[ln * D + d] = a0;
      sm.acc[ln * D + d + 1] = a1;
    }
    __syncthreads();
  }

  for (int i = tid; i < lanes * D; i += nthreads) {
    const int ln = i / D;
    out[i] = from_float<T>(sm.acc[i] / fmaxf(sm.l[ln], 1e-30f));
  }
}

// -- bf16 tensor-core helpers (K1's and K2's tensor-core routes) --------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// two 8x8 bf16 matrices: lanes 0-15 give the row addresses (lane i of
// matrix i/8, row i%8); lane (g, t) receives row g, columns 2t and 2t+1
// of each
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}
// four 8x8 bf16 matrices: lane i gives the row address of matrix i/8,
// row i%8; lane (g, t) receives row g, columns 2t and 2t+1 of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
// the same, each matrix transposed: lane (g, t) receives rows 2t and
// 2t+1 of column g
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a.b, one m16n8k16 bf16 product with float32 sums.  Lane (g, t)
// holds a = A[g][2t..2t+1], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// b = B[2t..2t+1][g], B[2t+8..2t+9][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an 8x8 bf16 matrix held as a fragment (lane (g, t): row g, columns 2t
// and 2t+1) transposed in registers: lane (g, t) receives rows 2t and
// 2t+1 of column g
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) as two packed bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// wait until at most n (0..2) cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// Raise the block's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace mxtpu_port
