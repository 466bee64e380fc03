// Chunked-prefill attention over one slot's block table, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel mxtpu/ops/pallas/prefill_attention.py
// (_kernel :113, launched by _call_local / paged_prefill_attention,
// pallas_call :313), over float pools of q's dtype or int8 pools with
// float32 scales (the kernel's `quant` form; paged_common.cuh).
//
// The chunk's queries q (1, H, T, D) fold kv-major into rep*T lanes per
// kv head, lane L = r*T + t, and lane L attends logical key positions
// <= start + L % T.  T is the padded (bucket) chunk length, as in the
// Pallas kernel: padding lanes compute values the caller drops.  The
// arithmetic is the Pallas kernel's: an online softmax with float32
// state, masked scores at -1e30, and the output acc / max(l, 1e-30) in
// q's dtype.  Two routes, chosen by q's dtype alone (the wrapper's
// route()):
//
// bfloat16 queries (over bfloat16 pools, or int8 pools with their
// scales) run on the tensor cores: prefill_tc_kernel.  At Llama-3-8B's
// shape (q (1, 32, 64, 128), 8 kv heads, 320 to 640 keys) one call
// moves 1.3-2.6 MB and does 0.2-0.4 GFLOP, a bound of about 0.0005-0.0008
// ms on either limit of the card (bytes at 3.35 TB/s, bf16 operations
// at 989 TFLOP/s).  What holds a kernel of this size back is latency:
// the sequential walk over the keys, each tile's copy, and the block
// barriers a tile.  So the design keeps every step of the walk short and
// spreads the walk over the card:
//
// - Each warp owns 16 fold rows.  Its scores, its softmax state (m, l)
//   and its 16 x D output accumulator live in registers, as mma.sync
//   fragments; nothing of a row goes through shared memory during the
//   walk.  S = Q.K^T is mma.sync.m16n8k16 bf16 with float32 sums, then
//   times sm_scale in float32 (q*scale is not a bf16 value).  P stays
//   in registers, where the C fragment of S is the A fragment of P.V,
//   as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), two products
//   into the same accumulator; l sums the float32 P.  (With P as one
//   bf16 term the output sat up to 0.78 of the bf16 tolerance from the
//   plain version on the main path's captured int8 chunk, a rounding
//   of P at 2^-9; the second product costs 10-20% of the kernel's time
//   on the H100.)  Fragments come from shared memory by ldmatrix (V's
//   by ldmatrix.trans); staged rows are padded by 16 bytes, so the 8
//   rows of one ldmatrix fall on distinct banks (a 256-byte stride would
//   put them on one).
// - A block holds up to 4 such warps (64 consecutive fold lanes) and
//   stages the keys in tiles of 32 through a ring of up to 4 tiles,
//   16-byte cp.async copies, one barrier a tile.  The block stages its
//   table row's page ids first; key rows past its last attended key
//   land as zeros.  A warp skips a tile none of its rows attends (its
//   p would be exactly 0, so nothing changes).
// - The key walk is split over a thread-block cluster of S blocks
//   (S <= 8, chosen by the wrapper so that the grid of kv heads x lane
//   groups x S fills the 132 SMs: S = 4 and 128 blocks at the 8B
//   shape).  Split s walks tiles s, s+S, s+2S, ... of the block's keys,
//   so splits differ by at most one tile whatever the context.  Each
//   block leaves its rows' (m, l, acc) in its shared memory; after a
//   cluster barrier, block s combines rows s*64/S .. of all S splits,
//   read over distributed shared memory in split order: M = max m_s,
//   out = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30).  No
//   atomics, one launch, and the same inputs give the same bits.  A
//   masked score contributes p = 0, so a split that sees no key of a
//   row keeps m = -1e30, l = 0, acc = 0 and weighs nothing.
// - head_dim is padded to a class DP (16, 32, 64, 128, 256): the staged
//   depth past D is zero, and acc holds DP/2 floats a thread (128 at
//   DP 256).  Fold rows past rep*T are zero queries, never stored.
// - int8 pools: a payload is exact in bf16 (|x| <= 127).  Each tile's
//   payloads and scales land in the same cp.async group; the block then
//   converts the payloads to one bf16 tile, the key scale multiplies S's
//   column after the product and the value scale multiplies P before
//   its split into bf16 terms.
//
// float32 queries (float32 pools, or int8 pools under float32 queries:
// the small float32 models) keep the float32 walk of
// paged_common.cuh on the CUDA cores, shared with K1 (attend_pages):
// one block of 512 threads per (kv head, tile of kQTile lanes), scores,
// softmax state and accumulator in shared memory, in true float32.

#include <cooperative_groups.h>

#include "paged_common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using mxtpu_port::cp_async16;
using mxtpu_port::cp_async4;
using mxtpu_port::cp_async8;
using mxtpu_port::cp_async_commit;
using mxtpu_port::cp_async_wait_all;
using mxtpu_port::cp_async_wait_n;
using mxtpu_port::kMaxSmem;
using mxtpu_port::kNegInf;
using mxtpu_port::ldsm_x4;
using mxtpu_port::ldsm_x4_t;
using mxtpu_port::mma_bf16;
using mxtpu_port::pack_bf16;
using mxtpu_port::split_bf16;

// -- the float32 route --------------------------------------------------

constexpr int kThreads = 512;
constexpr int kQTile = 32;  // query lanes per block (<= max_lanes for
                            // every bs <= 64 at kThreads)

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const T* __restrict__ q, const P* __restrict__ pool_k,
                         const P* __restrict__ pool_v,
                         const float* __restrict__ k_scales,
                         const float* __restrict__ v_scales,
                         const int* __restrict__ table,
                         const int* __restrict__ start,
                         const int* __restrict__ nv, T* __restrict__ out,
                         int KV, int rep, int T_len, int D, int bs,
                         int M, int stages, float sm_scale) {
  extern __shared__ uint4 smem[];
  const int fold = rep * T_len;
  const int tiles = (fold + kQTile - 1) / kQTile;
  const int kv = blockIdx.x / tiles;
  const int lane0 = (blockIdx.x - kv * tiles) * kQTile;
  const int lanes = min(kQTile, fold - lane0);
  mxtpu_port::AttendSmem<P> sm(smem, lanes, D, bs, stages);
  // q and out are (1, KV*rep, T, D): kv head kv's fold is one
  // contiguous run of rep*T rows, this tile a slice of it
  const size_t base = ((size_t)kv * fold + lane0) * D;
  mxtpu_port::load_rows(sm.q, q + base, lanes, D, sm_scale);
  const int st = start[0];
  for (int ln = threadIdx.x; ln < lanes; ln += blockDim.x) {
    sm.lim[ln] = st + (lane0 + ln) % T_len;
    sm.win[ln] = 0u;
  }
  // the tile's last attended key: its pages past that are fully masked
  // for every lane, and skipping them changes nothing
  const int t0 = lane0 % T_len;
  const int max_t = t0 + lanes - 1 < T_len ? t0 + lanes - 1 : T_len - 1;
  const int walk = min(nv[0], (st + max_t) / bs + 1);
  __syncthreads();
  mxtpu_port::attend_pages(sm, stages, lanes, pool_k, pool_v, k_scales,
                           v_scales, table, walk, st, kv, KV, bs, D,
                           out + base);
}

template <typename P>
int launch_f32(const void* q, const void* pool_k, const void* pool_v,
               const void* k_scales, const void* v_scales, const void* table,
               const void* start, const void* nv, void* out, int KV, int rep,
               int T_len, int D, int bs, int M, float sm_scale,
               void* stream) {
  const int fold = rep * T_len;
  const int tiles = (fold + kQTile - 1) / kQTile;
  const int lanes = fold < kQTile ? fold : kQTile;
  const int stages =
      mxtpu_port::attend_stages(lanes, D, bs, M, (int)sizeof(P));
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      mxtpu_port::attend_smem_bytes(lanes, D, bs, M, (int)sizeof(P), stages);
  cudaError_t err =
      mxtpu_port::allow_smem(paged_prefill_kernel<float, P>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_prefill_kernel<float, P><<<KV * tiles, kThreads, smem,
                                   (cudaStream_t)stream>>>(
      (const float*)q, (const P*)pool_k, (const P*)pool_v,
      (const float*)k_scales, (const float*)v_scales, (const int*)table,
      (const int*)start, (const int*)nv, (float*)out, KV, rep, T_len, D, bs,
      M, stages, sm_scale);
  return (int)cudaGetLastError();
}

// -- the tensor-core route ----------------------------------------------

constexpr int kTcKeys = 32;     // keys a staged tile
constexpr int kTcMaxWarps = 4;  // warps (16 fold rows each) a block
constexpr int kTcMaxSplits = 8; // blocks a cluster (the portable limit)

// a staged bf16 row: DP elements and 16 bytes of padding
__host__ __device__ inline int tc_ld(int DP) { return DP + 8; }
// a staged int8 row, in bytes
__host__ __device__ inline int tc_ld8(int DP) { return DP + 16; }

// Bytes of one ring stage: the K and V tiles (bf16), or for an int8 pool
// their payloads and scales.
__host__ __device__ inline size_t tc_stage_bytes(int DP, int quant) {
  return quant ? 2 * (size_t)kTcKeys * tc_ld8(DP) + 2 * kTcKeys * 4
               : 2 * (size_t)kTcKeys * tc_ld(DP) * 2;
}

// One block's shared memory, in this order: the page ids (M, rounded up
// to 4), the queries (rows x tc_ld(DP) bf16), then the larger of the
// walk's buffers (the ring, and an int8 pool's converted bf16 K/V tile)
// and the combine's (m, l, acc of every row in float32), which reuse one
// region.  Every part is a multiple of 16 bytes.
__host__ __device__ inline size_t tc_smem_bytes(int rows, int DP, int M,
                                                int quant, int stages) {
  const size_t pages = (size_t)(M + 3) / 4 * 16;
  const size_t q = (size_t)rows * tc_ld(DP) * 2;
  size_t walk = stages * tc_stage_bytes(DP, quant);
  if (quant) walk += 2 * (size_t)kTcKeys * tc_ld(DP) * 2;
  const size_t combine = (size_t)rows * (DP + 2) * 4;
  return pages + q + (walk > combine ? walk : combine);
}

// The block's shared memory, carved as tc_smem_bytes counts it.
template <bool Q8>
struct TcSmem {
  int* pages;
  bf16* q;
  char* ring;
  bf16* kc;  // an int8 pool's converted K and V tile
  bf16* vc;
  float* m;  // the combine: rows' m, l and acc (DP floats a row)
  float* l;
  float* acc;
  int DP;

  __device__ TcSmem(void* base, int rows, int DP_, int M, int stages)
      : DP(DP_) {
    char* b = reinterpret_cast<char*>(base);
    pages = reinterpret_cast<int*>(b);
    q = reinterpret_cast<bf16*>(b + (size_t)(M + 3) / 4 * 16);
    ring = reinterpret_cast<char*>(q + (size_t)rows * tc_ld(DP));
    kc = reinterpret_cast<bf16*>(ring + stages * tc_stage_bytes(DP, Q8));
    vc = kc + kTcKeys * tc_ld(DP);
    m = reinterpret_cast<float*>(ring);
    l = m + rows;
    acc = l + rows;
  }
  // stage s's K and V tiles: bf16 rows, or int8 payload rows
  __device__ char* k(int s) const { return ring + s * tc_stage_bytes(DP, Q8); }
  __device__ char* v(int s) const {
    return k(s) + (size_t)kTcKeys * (Q8 ? tc_ld8(DP) : tc_ld(DP) * 2);
  }
  // an int8 pool's key and value scales of stage s
  __device__ float* ks(int s) const {
    return reinterpret_cast<float*>(k(s) + 2 * (size_t)kTcKeys * tc_ld8(DP));
  }
  __device__ float* vs(int s) const { return ks(s) + kTcKeys; }
};

// Start the copies of key tile j (keys j*kTcKeys ..) of kv head kv into
// ring stage s; keys at or past `walk` land as zeros.
template <bool Q8>
__device__ void tc_issue(const TcSmem<Q8>& sm, int s, int j,
                         const void* __restrict__ pool_k,
                         const void* __restrict__ pool_v,
                         const float* __restrict__ k_scales,
                         const float* __restrict__ v_scales, int walk,
                         int kv, int KV, int bs, int D) {
  // bytes a copy: 16, or 8 for an int8 row of D % 16 == 8
  const int E = Q8 && (D & 15) ? 8 : 16;
  const int elt = Q8 ? 1 : 2;
  const int per_row = D * elt / E;
  const int ld = Q8 ? tc_ld8(sm.DP) : tc_ld(sm.DP) * 2;  // bytes
  char* kd = sm.k(s);
  char* vd = sm.v(s);
  const char* pk = reinterpret_cast<const char*>(pool_k);
  const char* pv = reinterpret_cast<const char*>(pool_v);
  for (int c = threadIdx.x; c < kTcKeys * per_row; c += blockDim.x) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * E;
    const int key = j * kTcKeys + r;
    const bool valid = key < walk;
    const size_t off =
        valid ? (((size_t)sm.pages[key / bs] * KV + kv) * bs + key % bs) *
                        D * elt + col
              : 0;
    if (E == 16) {
      cp_async16(kd + r * ld + col, pk + off, valid);
      cp_async16(vd + r * ld + col, pv + off, valid);
    } else {
      cp_async8(kd + r * ld + col, pk + off, valid);
      cp_async8(vd + r * ld + col, pv + off, valid);
    }
  }
  if (Q8) {
    for (int r = threadIdx.x; r < kTcKeys; r += blockDim.x) {
      const int key = j * kTcKeys + r;
      const bool valid = key < walk;
      const size_t off =
          valid ? ((size_t)sm.pages[key / bs] * KV + kv) * bs + key % bs : 0;
      cp_async4(sm.ks(s) + r, k_scales + off, valid);
      cp_async4(sm.vs(s) + r, v_scales + off, valid);
    }
  }
}

// An int8 pool's staged payloads of stage s as bf16 (exact: |x| <= 127)
// in the block's K/V tile, depth D .. DP as zeros.
template <bool Q8>
__device__ void tc_convert(const TcSmem<Q8>& sm, int s, int D) {
  const int DP = sm.DP;
  const int per_row = DP / 8;
  const int n = kTcKeys * per_row;
  for (int c = threadIdx.x; c < 2 * n; c += blockDim.x) {
    const int which = c >= n;
    const int rc = c - which * n;
    const int r = rc / per_row;
    const int col = (rc - r * per_row) * 8;
    bf16* dst = (which ? sm.vc : sm.kc) + r * tc_ld(DP) + col;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (col < D) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          (which ? sm.v(s) : sm.k(s)) + r * tc_ld8(DP) + col);
      const unsigned w[2] = {u.x, u.y};
      unsigned h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned x = w[i >> 1] >> (16 * (i & 1));
        h[i] = pack_bf16((float)(signed char)(x & 0xffu),
                         (float)(signed char)((x >> 8) & 0xffu));
      }
      o = make_uint4(h[0], h[1], h[2], h[3]);
    }
    *reinterpret_cast<uint4*>(dst) = o;
  }
}

// One block per (kv head, group of 16*warps fold lanes, split of the
// key walk); the S splits of a lane group form one cluster.
template <int DP, bool Q8>
__global__ void __launch_bounds__(32 * kTcMaxWarps)
    prefill_tc_kernel(const bf16* __restrict__ q,
                      const void* __restrict__ pool_k,
                      const void* __restrict__ pool_v,
                      const float* __restrict__ k_scales,
                      const float* __restrict__ v_scales,
                      const int* __restrict__ table,
                      const int* __restrict__ start, int start_val,
                      bf16* __restrict__ out, int KV, int rep, int T_len,
                      int D, int bs, int M, int stages, float sm_scale) {
  constexpr int NT = kTcKeys / 8;  // 8-key column tiles of S
  constexpr int ND = DP / 8;       // 8-wide depth tiles of the output
  extern __shared__ uint4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int R = blockDim.x / 2;  // 16 rows a warp
  const int fold = rep * T_len;
  const int kv = blockIdx.y;
  const int row0 = blockIdx.x / S * R;
  const int rows = min(R, fold - row0);
  // the chunk's first position: a device scalar, or the launch's int
  const int st = start != nullptr ? start[0] : start_val;
  // the table's pages the chunk can touch, as the Pallas kernel's nv
  const int nv = min(max((st + T_len - 1) / bs + 1, 1), M);
  // the block's last attended key: keys past it are masked for every row
  const int t0 = row0 % T_len;
  const int max_t = t0 + rows - 1 < T_len ? t0 + rows - 1 : T_len - 1;
  const int walk = min(nv * bs, st + max_t + 1);
  const int ntiles = (walk + kTcKeys - 1) / kTcKeys;
  const int mine = ntiles > split ? (ntiles - split + S - 1) / S : 0;
  const int ld = tc_ld(DP);
  TcSmem<Q8> sm(smem, R, DP, M, stages);

  {  // the queries' copies first: they ride the first group
    const int per_row = D / 8;
    const bf16* qb = q + ((size_t)kv * fold + row0) * D;
    for (int c = tid; c < R * per_row; c += blockDim.x) {
      const int r = c / per_row;
      const int col = (c - r * per_row) * 8;
      const bool valid = r < rows;
      cp_async16(sm.q + r * ld + col, valid ? qb + (size_t)r * D + col : qb,
                 valid);
    }
  }
  for (int i = tid; i < (walk + bs - 1) / bs; i += blockDim.x)
    sm.pages[i] = table[i];
  // the depth past D stays zero: in Q, and in a bf16 ring's tiles (the
  // copies write columns below D only)
  for (int i = tid; i < R * (DP - D); i += blockDim.x)
    sm.q[i / (DP - D) * ld + D + i % (DP - D)] = __float2bfloat16(0.f);
  if (!Q8) {
    const int n = stages * 2 * kTcKeys;
    for (int i = tid; i < n * (DP - D); i += blockDim.x) {
      const int r = i / (DP - D);
      reinterpret_cast<bf16*>(sm.ring)[r * ld + D + i % (DP - D)] =
          __float2bfloat16(0.f);
    }
  }
  __syncthreads();  // the page ids
  for (int i = 0; i < stages - 1; ++i) {
    if (i < mine)
      tc_issue(sm, i, split + i * S, pool_k, pool_v, k_scales, v_scales,
               walk, kv, KV, bs, D);
    cp_async_commit();
  }

  // this lane's two rows (g and g+8 of the warp's 16) and their limits;
  // rows past the fold attend nothing
  const int wr = warp * 16;
  const int L0 = row0 + wr + g;
  const int lim0 = L0 < fold ? st + L0 % T_len : -1;
  const int lim1 = L0 + 8 < fold ? st + (L0 + 8) % T_len : -1;
  const int wlim = __reduce_max_sync(0xffffffffu, max(lim0, lim1));
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < mine; ++i) {
    const int s = i % stages;
    const int key0 = (split + i * S) * kTcKeys;
    cp_async_wait_n(stages - 2);
    __syncthreads();  // tile i landed; every warp is done with tile i-1
    if (i + stages - 1 < mine)
      tc_issue(sm, (i + stages - 1) % stages, split + (i + stages - 1) * S,
               pool_k, pool_v, k_scales, v_scales, walk, kv, KV, bs, D);
    cp_async_commit();
    const bf16* kt;
    const bf16* vt;
    if (Q8) {
      tc_convert(sm, s, D);
      __syncthreads();
      kt = sm.kc;
      vt = sm.vc;
    } else {
      kt = reinterpret_cast<const bf16*>(sm.k(s));
      vt = reinterpret_cast<const bf16*>(sm.v(s));
    }
    if (key0 > wlim) continue;  // no row of this warp attends the tile

    // S = Q.K^T
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sm.q + (wr + (lane & 15)) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], a, b[0], b[1]);
        mma_bf16(sc[2 * np + 1], a, b[2], b[3]);
      }
    }
    // scale (times the key's scale on an int8 pool), mask, tile max
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n * 8 + 2 * t + (c & 1);
        float x = sc[n][c];
        if (Q8) x *= sm.ks(s)[col];
        x *= sm_scale;
        x = key0 + col <= (c < 2 ? lim0 : lim1) ? x : kNegInf;
        sc[n][c] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0);
    const float c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // p = exp(s - m), exactly 0 where masked; l sums the float32 p.
    // P.V takes P as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
    // so P enters the product to about 2^-16 of itself
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[NT / 2][4], pl[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = sc[n][c];
        p[c] = x == kNegInf ? 0.f : __expf(x - (c < 2 ? mn0 : mn1));
      }
      sum0 += p[0] + p[1];
      sum1 += p[2] + p[3];
      if (Q8) {
        const int col = n * 8 + 2 * t;
        const float v0 = sm.vs(s)[col], v1 = sm.vs(s)[col + 1];
        p[0] *= v0;
        p[1] *= v1;
        p[2] *= v0;
        p[3] *= v1;
      }
      // the C fragment of S as the A fragment of P.V: keys 2t, 2t+1 of
      // column tile n are k = 2t.. (n even) or 2t+8.. (n odd) of k-step n/2
      const int a = (n & 1) * 2;
      split_bf16(p[0], p[1], pa[n / 2][a], pl[n / 2][a]);
      split_bf16(p[2], p[3], pa[n / 2][a + 1], pl[n / 2][a + 1]);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    // acc += P.V
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                         dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pl[kk], b[0], b[1]);
        mma_bf16(acc[2 * dp], pa[kk], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pl[kk], b[2], b[3]);
        mma_bf16(acc[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    }
  }

  // each row's l over the quad's columns, in a fixed order
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: leave (m, l, acc) there
  if (t == 0) {
    sm.m[wr + g] = m0;
    sm.m[wr + g + 8] = m1;
    sm.l[wr + g] = l0;
    sm.l[wr + g + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<float2*>(sm.acc + (wr + g) * DP + n * 8 + 2 * t) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(sm.acc + (wr + g + 8) * DP + n * 8 + 2 * t) =
        make_float2(acc[n][2], acc[n][3]);
  }
  cluster.sync();

  // this block's share of the rows, combined over the S splits in order
  const int share = (R + S - 1) / S;
  const int quads = D / 4;
  for (int it = tid; it < share * quads; it += blockDim.x) {
    const int r = split * share + it / quads;
    const int d = (it % quads) * 4;
    if (r >= rows) continue;
    float mx = kNegInf;
    for (int z = 0; z < S; ++z)
      mx = fmaxf(mx, cluster.map_shared_rank(sm.m, z)[r]);
    float lsum = 0.f;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int z = 0; z < S; ++z) {
      const float w = __expf(cluster.map_shared_rank(sm.m, z)[r] - mx);
      lsum += cluster.map_shared_rank(sm.l, z)[r] * w;
      const float4 a = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(sm.acc, z) + r * DP + d);
      o[0] += a.x * w;
      o[1] += a.y * w;
      o[2] += a.z * w;
      o[3] += a.w * w;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    uint2 packed;
    packed.x = pack_bf16(o[0] * inv, o[1] * inv);
    packed.y = pack_bf16(o[2] * inv, o[3] * inv);
    *reinterpret_cast<uint2*>(out + ((size_t)kv * fold + row0 + r) * D + d) =
        packed;
  }
  cluster.sync();  // no block leaves while another reads its rows
}

template <int DP, bool Q8>
int launch_tc_dp(const void* q, const void* pool_k, const void* pool_v,
                 const void* k_scales, const void* v_scales,
                 const void* table, const void* start, int start_val,
                 void* out, int KV, int rep, int T_len, int D, int bs, int M,
                 int warps, int splits, int stages, size_t smem,
                 float sm_scale, void* stream) {
  const int rows = 16 * warps;
  const int groups = (rep * T_len + rows - 1) / rows;
  auto kernel = prefill_tc_kernel<DP, Q8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * splits, KV, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, (const bf16*)q, pool_k, pool_v, (const float*)k_scales,
      (const float*)v_scales, (const int*)table, (const int*)start,
      start_val, (bf16*)out, KV, rep, T_len, D, bs, M, stages, sm_scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch plan (warps, splits, stages and the shared memory they
// need) comes from the wrapper (ops/prefill_attention.py, _tc_plan); a
// plan whose bytes disagree with tc_smem_bytes is refused.
template <bool Q8>
int launch_tc(const void* q, const void* pool_k, const void* pool_v,
              const void* k_scales, const void* v_scales, const void* table,
              const void* start, int start_val, void* out, int KV, int rep,
              int T_len, int D, int bs, int M, int DP, int warps, int splits,
              int stages, int smem, float sm_scale, void* stream) {
  if (warps < 1 || warps > kTcMaxWarps || splits < 1 ||
      splits > kTcMaxSplits || stages < 2 || stages > 4 || D % 8 ||
      D > DP || (size_t)smem > kMaxSmem ||
      (size_t)smem != tc_smem_bytes(16 * warps, DP, M, Q8, stages))
    return (int)cudaErrorInvalidValue;
#define MXTPU_TC_DP(N)                                                      \
  case N:                                                                   \
    return launch_tc_dp<N, Q8>(q, pool_k, pool_v, k_scales, v_scales,       \
                               table, start, start_val, out, KV, rep, T_len, \
                               D, bs, M, warps, splits, stages,              \
                               (size_t)smem, sm_scale, stream);
  switch (DP) {
    MXTPU_TC_DP(16)
    MXTPU_TC_DP(32)
    MXTPU_TC_DP(64)
    MXTPU_TC_DP(128)
    MXTPU_TC_DP(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MXTPU_TC_DP
}

}  // namespace

extern "C" {

int mxtpu_paged_prefill_stages(int fold, int D, int bs, int M, int elt) {
  return mxtpu_port::attend_stages(fold < kQTile ? fold : kQTile, D, bs, M,
                                   elt);
}

// the float32 route
int mxtpu_paged_prefill_f32(const void* q, const void* pool_k,
                            const void* pool_v, const void* table,
                            const void* start, const void* nv, void* out,
                            int KV, int rep, int T_len, int D, int bs, int M,
                            float sm_scale, void* stream) {
  return launch_f32<float>(q, pool_k, pool_v, nullptr, nullptr, table, start,
                           nv, out, KV, rep, T_len, D, bs, M, sm_scale,
                           stream);
}
int mxtpu_paged_prefill_f32_q8(const void* q, const void* pool_k,
                               const void* pool_v, const void* k_scales,
                               const void* v_scales, const void* table,
                               const void* start, const void* nv, void* out,
                               int KV, int rep, int T_len, int D, int bs,
                               int M, float sm_scale, void* stream) {
  return launch_f32<int8_t>(q, pool_k, pool_v, k_scales, v_scales, table,
                            start, nv, out, KV, rep, T_len, D, bs, M,
                            sm_scale, stream);
}

// the tensor-core route (bfloat16 queries)
// start: a device int32 scalar, or null for the int start_val
int mxtpu_paged_prefill_tc_bf16(const void* q, const void* pool_k,
                                const void* pool_v, const void* table,
                                const void* start, void* out, int start_val,
                                int KV, int rep, int T_len, int D, int bs,
                                int M, int DP, int warps, int splits,
                                int stages, int smem, float sm_scale,
                                void* stream) {
  return launch_tc<false>(q, pool_k, pool_v, nullptr, nullptr, table, start,
                          start_val, out, KV, rep, T_len, D, bs, M, DP, warps,
                          splits, stages, smem, sm_scale, stream);
}
int mxtpu_paged_prefill_tc_bf16_q8(const void* q, const void* pool_k,
                                   const void* pool_v, const void* k_scales,
                                   const void* v_scales, const void* table,
                                   const void* start, void* out,
                                   int start_val, int KV, int rep, int T_len,
                                   int D, int bs, int M, int DP, int warps,
                                   int splits, int stages, int smem,
                                   float sm_scale, void* stream) {
  return launch_tc<true>(q, pool_k, pool_v, k_scales, v_scales, table, start,
                         start_val, out, KV, rep, T_len, D, bs, M, DP, warps,
                         splits, stages, smem, sm_scale, stream);
}

}  // extern "C"
