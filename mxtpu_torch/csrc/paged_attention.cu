// Ragged paged decode and verify attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mxtpu/ops/pallas/paged_attention.py
// (_kernel :117, launched by _call_local / paged_decode_attention,
// pallas_call :499): the plain decode step (W = 1), the speculative
// verify window (W > 1) and the tree-verify ancestor mask (anc, W <= 32),
// over float pools of q's dtype or int8 pools with float32 scales (the
// kernel's `quant` form; paged_common.cuh).
//
// q (B, H, W, D) folds kv-major into the rep*W query lanes of one (slot
// b, kv head), lane l = r*W + w.  Without anc, lane l attends key
// positions <= pos[b] + w.  With anc it attends the committed history
// (< pos[b]) and the window positions pos[b] + j whose bit j is set in
// anc[b, w] | (1 << w), j < W: its ancestors and itself.  A degenerate
// chain, anc[b, w] = (1 << w) - 1, gives the same key set as no anc.
// No lane attends a key past the table (M*bs).  The arithmetic is the
// Pallas kernel's: an online softmax with float32 state, masked scores at
// -1e30, and the output acc / max(l, 1e-30) in q's dtype.  Two routes,
// chosen by q's dtype alone (the wrapper's route()):
//
// bfloat16 queries (over bfloat16 pools, or int8 pools with their
// scales) run on the tensor cores: decode_tc_kernel.  Bound on the H100:
// bytes.  Llama-3-8B's decode step (8 slots, 8 kv heads, rep 4, head_dim
// 128, block 16, contexts of up to ~670 keys) reads about 14 MB of K/V
// pages a call (0.0042 ms at 3.35 TB/s) and does 4 operations per (lane,
// key, d), 1 to 64 lanes per kv head, far below the card's ~295
// operations per byte.  What held the CUDA-core walk back (0.087 ms) was
// that 64 blocks walked 64 contexts one tile at a time on 132 SMs, one
// tile in flight, four block barriers a tile, the products on the CUDA
// cores out of shared memory.  So:
//
// - Each (slot, kv head, lane group) walk is split over a thread-block
//   cluster of kTcSplits = 4 blocks: split s walks key tiles s, s+4, s+8,
//   ... (64 keys a tile), and stops at the last tile any lane of its
//   group attends.  256 blocks at the 8B decode step, two an SM.  Every
//   block stages its table row's page ids, then keeps a ring of
//   kTcStages = 3 tiles in flight (cp.async, one block barrier a tile),
//   so a split of a typical context has all its tiles in flight at once.
// - Each of the block's 4 warps owns 16 keys of every tile and runs its
//   own online softmax over them.  The keys are the A operand of
//   mma.sync.m16n8k16 (bf16, float32 sums) and the lanes the n8 columns
//   of B: S^T = K.Q^T, then O^T = V^T.P^T, with P^T's fragments made
//   from S^T's accumulators by movmatrix.trans and V^T's by
//   ldmatrix.trans.  A lane is an MMA column: its scores, its (m, l) and
//   its 16-deep rows of O^T live in one column of the warp's registers,
//   and nothing of it goes through shared memory during the walk.
//   Scores are scaled by sm_scale in float32 after the product.  P
//   enters P.V as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi); l
//   sums the float32 p.  Staged rows are padded by 16 bytes, so the 8
//   rows of one ldmatrix fall on distinct banks.
// - At the end every warp leaves its (m, l, O^T) in its block's shared
//   memory, and the block combines its 4 warps in warp order: M = max m,
//   l = sum l e^(m - M), O = sum O e^(m - M).  After a cluster barrier,
//   block s combines its share of the group's lanes over the 4 splits,
//   read over distributed shared memory in split order, the same way,
//   and writes O / max(l, 1e-30).  No atomics, one launch, no workspace.
// - A thread's copies of a tile are one 16-byte chunk (8 bytes of an
//   int8 row of D % 16 == 8) at a fixed depth of every (128 / chunks a
//   row)-th key row, K and V alike, its page and in-page position stepped
//   along without a division.
// - head_dim is padded to a class DP (16 .. 256), the staged depth past
//   D zero.  A group holds 8 * NT lanes (NT n8 tiles: up to 4, 2 at DP
//   256, so O^T takes DP/4 * NT registers a thread).
// - int8 pools: each tile's payloads and scales land in one cp.async
//   group; each warp converts its 16 rows to bf16 (exact: |x| <= 128) in
//   a buffer of its own, by integer and float adds rather than conversion
//   instructions (i8x4_to_bf16); the key scale multiplies the key's score
//   after the product, and the value scale multiplies p before p is split
//   into bf16 terms.
//
// Why the bit-exact invariants hold: the number of splits, the key tile,
// which tiles a split walks, which keys a warp owns, the k16 order of
// both products and the order of the combine are functions of (D, bs,
// the pool's dtype) alone; none depends on W, the lane count, B or pos.
// An MMA column's result depends on that column's operands only, so a
// lane's arithmetic does not depend on the other lanes of its group, on
// the column it sits in, or on how many n8 tiles its group has.  A tile
// past a lane's limit adds exactly nothing (p = 0, a correction of
// exactly 1), and a split or warp that sees no key of a lane weighs
// exactly 0 in the combine.  So (a) a chain anc gives the bits of no
// anc, (b) lane w of a W-lane call equals a W = 1 call at pos[b] + w, and
// (c) slot b of a B-slot call equals a 1-slot call on its own table row
// and position.
//
// float32 queries (float32 pools, or int8 pools under float32 queries:
// the small float32 models) keep the float32 walk of paged_common.cuh on
// the CUDA cores (attend_pages, shared with K2): one block of 256
// threads per (slot, kv head, tile of up to 32 lanes), in true float32.

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
using mxtpu_port::ldsm_x2;
using mxtpu_port::ldsm_x4;
using mxtpu_port::ldsm_x4_t;
using mxtpu_port::mma_bf16;
using mxtpu_port::movmatrix_t;
using mxtpu_port::pack_bf16;
using mxtpu_port::split_bf16;

// -- the float32 route --------------------------------------------------

constexpr int kThreads = 256;

// Lanes one block takes: all of them, or a full tile.
__host__ __device__ inline int tile_lanes(int lanes, int bs) {
  const int cap = mxtpu_port::max_lanes(kThreads, bs);
  return lanes < cap ? lanes : cap;
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ pool_k,
                        const P* __restrict__ pool_v,
                        const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos,
                        const int* __restrict__ nv,
                        const int* __restrict__ anc, T* __restrict__ out,
                        int KV, int lanes, int W, int D, int bs, int M,
                        int stages, float sm_scale) {
  extern __shared__ uint4 smem[];
  const int tile = tile_lanes(lanes, bs);
  const int tiles = (lanes + tile - 1) / tile;
  const int head = blockIdx.x / tiles;  // b*KV + kv
  const int b = head / KV;
  const int kv = head - b * KV;
  const int lane0 = (blockIdx.x - head * tiles) * tile;
  const int nl = min(tile, lanes - lane0);
  mxtpu_port::AttendSmem<P> sm(smem, nl, D, bs, stages);
  // q and out are (B, KV*rep, W, D): the lanes of (b, kv) are one
  // contiguous run of lanes*D elements, this tile a slice of it
  const size_t base = ((size_t)head * lanes + lane0) * D;
  mxtpu_port::load_rows(sm.q, q + base, nl, D, sm_scale);
  const int p = pos[b];
  for (int ln = threadIdx.x; ln < nl; ln += blockDim.x) {
    const int w = (lane0 + ln) % W;
    if (anc != nullptr) {
      sm.lim[ln] = p - 1;
      sm.win[ln] = (unsigned)anc[(size_t)b * W + w] | (1u << w);
    } else {
      sm.lim[ln] = p + w;
      sm.win[ln] = 0u;
    }
  }
  // the largest w of the tile: its last attended key is pos + w, and
  // the pages past it are fully masked for every lane of the tile
  const int w0 = lane0 % W;
  const int max_w = (nl >= W || w0 + nl > W) ? W - 1 : w0 + nl - 1;
  const int walk = min(nv[b], (p + max_w) / bs + 1);
  __syncthreads();
  mxtpu_port::attend_pages(sm, stages, nl, pool_k, pool_v, k_scales,
                           v_scales, tables + (size_t)b * M, walk, p, kv, KV,
                           bs, D, out + base);
}

template <typename T, typename P>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* k_scales, const void* v_scales, const void* tables,
           const void* pos, const void* nv, const void* anc, void* out,
           int B, int KV, int lanes, int W, int D, int bs, int M,
           float sm_scale, void* stream) {
  if (anc != nullptr && W > 32) return (int)cudaErrorInvalidValue;
  const int tile = tile_lanes(lanes, bs);
  const int tiles = (lanes + tile - 1) / tile;
  const int stages =
      mxtpu_port::attend_stages(tile, D, bs, M, (int)sizeof(P));
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      mxtpu_port::attend_smem_bytes(tile, D, bs, M, (int)sizeof(P), stages);
  cudaError_t err = mxtpu_port::allow_smem(paged_decode_kernel<T, P>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T, P><<<B * KV * tiles, kThreads, smem,
                              (cudaStream_t)stream>>>(
      (const T*)q, (const P*)pool_k, (const P*)pool_v,
      (const float*)k_scales, (const float*)v_scales, (const int*)tables,
      (const int*)pos, (const int*)nv, (const int*)anc, (T*)out, KV, lanes,
      W, D, bs, M, stages, sm_scale);
  return (int)cudaGetLastError();
}

// -- the tensor-core route ----------------------------------------------

constexpr int kTcKeys = 64;    // keys a staged tile
constexpr int kTcWarps = 4;    // warps a block, 16 keys of a tile each
constexpr int kTcSplits = 4;   // blocks a cluster
constexpr int kTcStages = 3;   // ring stages

// a staged bf16 row: DP elements and 16 bytes of padding
__host__ __device__ inline int tc_ld(int DP) { return DP + 8; }
// a staged int8 row, in bytes
__host__ __device__ inline int tc_ld8(int DP) { return DP + 16; }
// n8 lane tiles a group may hold: O^T takes DP/4 * NT floats a thread
__host__ __device__ inline int tc_max_nt(int DP) { return DP <= 128 ? 4 : 2; }

// Bytes of one ring stage: the K and V tiles (bf16), or for an int8 pool
// their payloads and scales.
__host__ __device__ inline size_t tc_stage_bytes(int DP, int quant) {
  return quant ? 2 * (size_t)kTcKeys * tc_ld8(DP) + 2 * kTcKeys * 4
               : 2 * (size_t)kTcKeys * tc_ld(DP) * 2;
}

// One block's shared memory, in this order: the page ids (M, rounded up
// to 4), the group's queries (8*NT rows of tc_ld(DP) bf16), then the
// larger of the walk's buffers (the ring; for an int8 pool also each
// warp's converted 16 K and 16 V rows) and the combine's (each warp's m,
// l and O of every lane, then the block's, float32), which reuse one
// region.  Every part is a multiple of 16 bytes.
__host__ __device__ inline size_t tc_smem_bytes(int nt, int DP, int M,
                                                int quant) {
  const size_t pages = (size_t)(M + 3) / 4 * 16;
  const size_t q = (size_t)8 * nt * tc_ld(DP) * 2;
  size_t walk = kTcStages * tc_stage_bytes(DP, quant);
  if (quant) walk += (size_t)kTcWarps * 2 * 16 * tc_ld(DP) * 2;
  const size_t combine = (size_t)(kTcWarps + 1) * 8 * nt * (DP + 2) * 4;
  return pages + q + (walk > combine ? walk : combine);
}

// The block's shared memory, carved as tc_smem_bytes counts it.
template <bool Q8>
struct TcSmem {
  int* pages;
  bf16* q;
  char* ring;
  bf16* conv;  // an int8 pool's converted rows: warp w's K at conv +
               // 32*w rows, its V 16 rows further
  float* m;    // the combine: [warp][lane] m and l, [warp][lane][DP] O,
  float* l;    //   then the block's [lane] m and l and [lane][DP] O
  float* acc;
  float* bm;
  float* bl;
  float* bacc;
  int DP;

  __device__ TcSmem(void* base, int GL, int DP_, int M) : DP(DP_) {
    char* b = reinterpret_cast<char*>(base);
    pages = reinterpret_cast<int*>(b);
    q = reinterpret_cast<bf16*>(b + (size_t)(M + 3) / 4 * 16);
    ring = reinterpret_cast<char*>(q + (size_t)GL * tc_ld(DP));
    conv = reinterpret_cast<bf16*>(ring + kTcStages * tc_stage_bytes(DP, Q8));
    m = reinterpret_cast<float*>(ring);
    l = m + kTcWarps * GL;
    acc = l + kTcWarps * GL;
    bm = acc + (size_t)kTcWarps * GL * DP;
    bl = bm + GL;
    bacc = bl + GL;
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
// ring stage s; keys at or past `walk` land as zeros.  Each thread copies
// one chunk of CH elements (16 bytes: 8 bf16 or 16 int8 values; 8 int8
// values where D % 16 == 8) at a fixed depth of every kStep-th row, K
// and V alike, stepping its page and in-page position along without
// dividing.
template <int DP, int CH, bool Q8>
__device__ void tc_issue(const TcSmem<Q8>& sm, int s, int j,
                         const void* __restrict__ pool_k,
                         const void* __restrict__ pool_v,
                         const float* __restrict__ k_scales,
                         const float* __restrict__ v_scales, int walk,
                         int kv, int KV, int bs, int D) {
  constexpr int kChunks = DP / CH;                // chunks a staged row
  constexpr int kStep = 32 * kTcWarps / kChunks;  // rows apart
  constexpr int elt = Q8 ? 1 : 2;
  constexpr int ld = Q8 ? DP + 16 : (DP + 8) * 2;  // staged row, bytes
  const int col = (threadIdx.x % kChunks) * CH;
  int r = threadIdx.x / kChunks;
  if (col < D) {
    char* kd = sm.k(s) + col * elt;
    char* vd = sm.v(s) + col * elt;
    const char* pk = reinterpret_cast<const char*>(pool_k) + col * elt;
    const char* pv = reinterpret_cast<const char*>(pool_v) + col * elt;
    int key = j * kTcKeys + r;
    int page = key / bs;
    int at = key - page * bs;
    for (; r < kTcKeys; r += kStep, key += kStep) {
      const bool valid = key < walk;
      const size_t off =
          valid ? (((size_t)sm.pages[page] * KV + kv) * bs + at) * D * elt : 0;
      if (CH * elt == 16) {
        cp_async16(kd + r * ld, pk + off, valid);
        cp_async16(vd + r * ld, pv + off, valid);
      } else {
        cp_async8(kd + r * ld, pk + off, valid);
        cp_async8(vd + r * ld, pv + off, valid);
      }
      for (at += kStep; at >= bs; at -= bs) ++page;
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

// tc_issue with the chunk a row's depth D allows
template <int DP, bool Q8>
__device__ __forceinline__ void tc_issue_tile(
    const TcSmem<Q8>& sm, int s, int j, const void* __restrict__ pool_k,
    const void* __restrict__ pool_v, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, int walk, int kv, int KV, int bs,
    int D) {
  if constexpr (Q8) {
    if (D % 16 == 0) {
      tc_issue<DP, 16, Q8>(sm, s, j, pool_k, pool_v, k_scales, v_scales,
                           walk, kv, KV, bs, D);
      return;
    }
  }
  tc_issue<DP, 8, Q8>(sm, s, j, pool_k, pool_v, k_scales, v_scales, walk,
                      kv, KV, bs, D);
}

// Four int8 values (bytes of w, low first) as two packed bf16 pairs,
// exactly and without conversion instructions: byte b ^ 0x80 = b + 128
// set into the mantissa of 2^23 gives 2^23 + b + 128 in float32, less
// 2^23 + 128 the integer b; a float32 integer of magnitude <= 128 has
// its low 16 bits zero, so its high half is its bf16.
__device__ __forceinline__ void i8x4_to_bf16(unsigned w, unsigned& lo,
                                             unsigned& hi) {
  const unsigned x = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540u + i)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
}

// One warp's 16 staged int8 K and V rows of stage s (rows 16*warp ..) as
// bf16 (exact: |x| <= 128) in the warp's own buffer, depth D .. DP zero.
template <int DP, bool Q8>
__device__ void tc_convert(const TcSmem<Q8>& sm, int s, int warp, int lane,
                           int D) {
  constexpr int per_row = DP / 8;
  constexpr int n = 16 * per_row;
  bf16* dst0 = sm.conv + (size_t)32 * warp * tc_ld(DP);
  for (int c = lane; c < 2 * n; c += 32) {
    const int which = c >= n;
    const int rc = c - which * n;
    const int r = rc / per_row;
    const int col = (rc - r * per_row) * 8;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (col < D) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          (which ? sm.v(s) : sm.k(s)) + (16 * warp + r) * tc_ld8(DP) + col);
      unsigned h[4];
      i8x4_to_bf16(u.x, h[0], h[1]);
      i8x4_to_bf16(u.y, h[2], h[3]);
      o = make_uint4(h[0], h[1], h[2], h[3]);
    }
    *reinterpret_cast<uint4*>(dst0 + (which * 16 + r) * tc_ld(DP) + col) = o;
  }
}

// N parts' (m, l, 4 columns of O) of one lane combined in part order:
// M = max m, l = sum l e^(m - M), O = sum O e^(m - M).  A part at M
// weighs exactly 1, one that saw no attended key (m = -1e30) exactly 0.
template <int N>
__device__ __forceinline__ void combine(const float (&mz)[N],
                                        const float (&lz)[N],
                                        const float4 (&az)[N], float& mx,
                                        float& lsum, float4& o) {
  mx = kNegInf;
#pragma unroll
  for (int z = 0; z < N; ++z) mx = fmaxf(mx, mz[z]);
  lsum = 0.f;
  o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int z = 0; z < N; ++z) {
    const float w = mz[z] == mx ? 1.f : __expf(mz[z] - mx);
    lsum += lz[z] * w;
    o.x += az[z].x * w;
    o.y += az[z].y * w;
    o.z += az[z].z * w;
    o.w += az[z].w * w;
  }
}

// Whether a lane with limit lim and window mask win (relative to key
// position p) attends key `key` of a table of cap keys.
__device__ __forceinline__ bool attends(int key, int cap, int lim,
                                        unsigned win, int p) {
  const unsigned rel = (unsigned)(key - p);  // >= 32 before p
  return key < cap && (key <= lim || (rel < 32u && ((win >> rel) & 1u)));
}

// One block per (slot, kv head, group of 8*NT lanes, split of the key
// walk); the kTcSplits splits of a group form one cluster.
template <int DP, int NT, bool Q8>
__global__ void __launch_bounds__(32 * kTcWarps)
    decode_tc_kernel(const bf16* __restrict__ q,
                     const void* __restrict__ pool_k,
                     const void* __restrict__ pool_v,
                     const float* __restrict__ k_scales,
                     const float* __restrict__ v_scales,
                     const int* __restrict__ tables,
                     const int* __restrict__ pos,
                     const int* __restrict__ anc, bf16* __restrict__ out,
                     int KV, int lanes, int W, int D, int bs, int M,
                     float sm_scale) {
  constexpr int GL = 8 * NT;  // lanes a group
  constexpr int KS = DP / 16;  // k16 steps of S^T, 16-deep blocks of O^T
  extern __shared__ uint4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.z;
  const int kv = blockIdx.y;
  const int lane0 = blockIdx.x / kTcSplits * GL;
  const int nl = min(GL, lanes - lane0);
  const int ld = tc_ld(DP);
  TcSmem<Q8> sm(smem, GL, DP, M);

  const int p = pos[b];
  // the group's last attended key is p + (its largest w); the table
  // holds cap keys
  const int w0 = lane0 % W;
  const int max_w = (nl >= W || w0 + nl > W) ? W - 1 : w0 + nl - 1;
  const int cap = M * bs;
  const int walk = min(cap, p + max_w + 1);
  const int ntiles = (walk + kTcKeys - 1) / kTcKeys;
  const int mine =
      ntiles > split ? (ntiles - split + kTcSplits - 1) / kTcSplits : 0;

  // q and out are (B, KV*rep, W, D): the lanes of (b, kv) are one
  // contiguous run of lanes*D elements, this group a slice of it
  const size_t base = ((size_t)(b * KV + kv) * lanes + lane0) * D;
  {  // the queries' copies first: they ride the first group
    const int per_row = D / 8;
    for (int c = tid; c < GL * per_row; c += blockDim.x) {
      const int r = c / per_row;
      const int col = (c - r * per_row) * 8;
      const bool valid = r < nl;
      cp_async16(sm.q + r * ld + col, q + base + (valid ? r * D + col : 0),
                 valid);
    }
  }
  // the table row's page ids, read beside pos[b] rather than after it
  for (int i = tid; i < M; i += blockDim.x)
    sm.pages[i] = tables[(size_t)b * M + i];
  // the depth past D stays zero: in Q, and in a bf16 ring's tiles (the
  // copies write columns below D only)
  if (DP > D) {
    for (int i = tid; i < GL * (DP - D); i += blockDim.x)
      sm.q[i / (DP - D) * ld + D + i % (DP - D)] = __float2bfloat16(0.f);
    if (!Q8) {
      const int n = kTcStages * 2 * kTcKeys;
      for (int i = tid; i < n * (DP - D); i += blockDim.x)
        reinterpret_cast<bf16*>(sm.ring)[i / (DP - D) * ld + D +
                                         i % (DP - D)] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();  // the page ids
  for (int i = 0; i < kTcStages; ++i) {  // every stage is free: fill it
    if (i < mine)
      tc_issue_tile<DP>(sm, i, split + i * kTcSplits, pool_k, pool_v, k_scales,
               v_scales, walk, kv, KV, bs, D);
    cp_async_commit();
  }

  // this thread's lanes: columns 2t and 2t+1 of each n8 tile; lanes past
  // the group attend nothing
  int lim[NT][2];
  unsigned win[NT][2];
  const unsigned wmask = W >= 32 ? 0xffffffffu : (1u << W) - 1u;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ln = 8 * n + 2 * t + c;
      const int w = (lane0 + ln) % W;
      lim[n][c] = ln >= nl ? -1 : anc != nullptr ? p - 1 : p + w;
      win[n][c] = ln >= nl || anc == nullptr
                      ? 0u
                      : (((unsigned)anc[(size_t)b * W + w]) | (1u << w)) &
                            wmask;
    }
  }
  float m[NT][2], l[NT][2];
  float acc[KS][NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    m[n][0] = m[n][1] = kNegInf;
    l[n][0] = l[n][1] = 0.f;
#pragma unroll
    for (int mb = 0; mb < KS; ++mb)
      acc[mb][n][0] = acc[mb][n][1] = acc[mb][n][2] = acc[mb][n][3] = 0.f;
  }

  for (int i = 0; i < mine; ++i) {
    const int s = i % kTcStages;
    // this warp's 16 keys of the tile
    const int key0 = (split + i * kTcSplits) * kTcKeys + 16 * warp;
    cp_async_wait_n(kTcStages - 1);
    __syncthreads();  // tile i landed; every warp is done with tile i-1
    // tile i-1's stage takes tile i + kTcStages - 1
    if (i >= 1 && i + kTcStages - 1 < mine)
      tc_issue_tile<DP>(sm, (i - 1) % kTcStages,
               split + (i + kTcStages - 1) * kTcSplits, pool_k, pool_v,
               k_scales, v_scales, walk, kv, KV, bs, D);
    cp_async_commit();
    if (key0 >= walk) continue;  // no lane of the group attends them
    const bf16* kw;
    const bf16* vw;
    if (Q8) {
      __syncwarp();  // the warp is done reading its previous rows
      tc_convert<DP>(sm, s, warp, lane, D);
      __syncwarp();
      kw = sm.conv + (size_t)32 * warp * ld;
      vw = kw + 16 * ld;
    } else {
      kw = reinterpret_cast<const bf16*>(sm.k(s)) + 16 * warp * ld;
      vw = reinterpret_cast<const bf16*>(sm.v(s)) + 16 * warp * ld;
    }

    // S^T = K.Q^T: rows are the warp's keys, columns the group's lanes
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, kw + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bq[2];
        ldsm_x2(bq, sm.q + (8 * n + (lane & 7)) * ld + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(sc[n], a, bq[0], bq[1]);
      }
    }
    // this thread's keys are key0 + g and key0 + g + 8
    float ks0 = 1.f, ks1 = 1.f, vs0 = 1.f, vs1 = 1.f;
    if (Q8) {
      const int r = 16 * warp + g;
      ks0 = sm.ks(s)[r];
      ks1 = sm.ks(s)[r + 8];
      vs0 = sm.vs(s)[r];
      vs1 = sm.vs(s)[r + 8];
    }
    uint32_t bh[NT][2], bl[NT][2];  // P^T as B fragments: hi and lo terms
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float mx[2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + g + (e >> 1) * 8;
        const int c = e & 1;
        float x = sc[n][e];
        if (Q8) x *= e < 2 ? ks0 : ks1;
        x *= sm_scale;
        sc[n][e] =
            attends(key, cap, lim[n][c], win[n][c], p) ? x : kNegInf;
      }
      mx[0] = fmaxf(sc[n][0], sc[n][2]);
      mx[1] = fmaxf(sc[n][1], sc[n][3]);
#pragma unroll
      for (int o = 4; o <= 16; o <<= 1) {
        mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], o));
        mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], o));
      }
      float corr[2], pr[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float mn = fmaxf(m[n][c], mx[c]);
        corr[c] = mn == m[n][c] ? 1.f : __expf(m[n][c] - mn);
        m[n][c] = mn;
      }
      // p = exp(s - m), exactly 0 where masked; l sums the float32 p
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pr[e] = sc[n][e] == kNegInf ? 0.f : __expf(sc[n][e] - m[n][e & 1]);
      l[n][0] = l[n][0] * corr[0] + (pr[0] + pr[2]);
      l[n][1] = l[n][1] * corr[1] + (pr[1] + pr[3]);
      if (Q8) {
        pr[0] *= vs0;
        pr[1] *= vs0;
        pr[2] *= vs1;
        pr[3] *= vs1;
      }
      // S^T's accumulators hold keys g (and g+8) x lanes 2t, 2t+1: as
      // packed bf16 they are the fragments of two 8x8 matrices, and
      // their transposes are P^T's B fragments (keys 2t.., lane g)
      uint32_t h0, l0, h1, l1;
      split_bf16(pr[0], pr[1], h0, l0);
      split_bf16(pr[2], pr[3], h1, l1);
      bh[n][0] = movmatrix_t(h0);
      bh[n][1] = movmatrix_t(h1);
      bl[n][0] = movmatrix_t(l0);
      bl[n][1] = movmatrix_t(l1);
#pragma unroll
      for (int mb = 0; mb < KS; ++mb) {
        acc[mb][n][0] *= corr[0];
        acc[mb][n][1] *= corr[1];
        acc[mb][n][2] *= corr[0];
        acc[mb][n][3] *= corr[1];
      }
    }
    // O^T += V^T.P^T, the lo term first
#pragma unroll
    for (int mb = 0; mb < KS; ++mb) {
      uint32_t a[4];
      ldsm_x4_t(a, vw + ((lane >> 4) * 8 + (lane & 7)) * ld + mb * 16 +
                       ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_bf16(acc[mb][n], a, bl[n][0], bl[n][1]);
        mma_bf16(acc[mb][n], a, bh[n][0], bh[n][1]);
      }
    }
  }

  // each lane's l over the warp's 8 key rows, in a fixed order
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1) {
      l[n][0] += __shfl_xor_sync(0xffffffffu, l[n][0], o);
      l[n][1] += __shfl_xor_sync(0xffffffffu, l[n][1], o);
    }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: leave (m, l, O) there
  {
    float* pm = sm.m + warp * GL;
    float* pl = sm.l + warp * GL;
    float* pa = sm.acc + (size_t)warp * GL * DP;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int ln = 8 * n + 2 * t;
      if (g == 0) {
        pm[ln] = m[n][0];
        pm[ln + 1] = m[n][1];
        pl[ln] = l[n][0];
        pl[ln + 1] = l[n][1];
      }
#pragma unroll
      for (int mb = 0; mb < KS; ++mb) {
        const int d = 16 * mb + g;
        pa[ln * DP + d] = acc[mb][n][0];
        pa[(ln + 1) * DP + d] = acc[mb][n][1];
        pa[ln * DP + d + 8] = acc[mb][n][2];
        pa[(ln + 1) * DP + d + 8] = acc[mb][n][3];
      }
    }
  }
  __syncthreads();
  // the block's warps combined in warp order into the block's (m, l, O)
  const int quads = D / 4;
  for (int it = tid; it < nl * quads; it += blockDim.x) {
    const int ln = it / quads;
    const int d = (it - ln * quads) * 4;
    float mz[kTcWarps], lz[kTcWarps], mx, lsum;
    float4 az[kTcWarps], o;
#pragma unroll
    for (int wp = 0; wp < kTcWarps; ++wp) {
      mz[wp] = sm.m[wp * GL + ln];
      lz[wp] = sm.l[wp * GL + ln];
      az[wp] = *reinterpret_cast<const float4*>(
          sm.acc + ((size_t)wp * GL + ln) * DP + d);
    }
    combine(mz, lz, az, mx, lsum, o);
    if (d == 0) {
      sm.bm[ln] = mx;
      sm.bl[ln] = lsum;
    }
    *reinterpret_cast<float4*>(sm.bacc + (size_t)ln * DP + d) = o;
  }
  cluster.sync();

  // this block's share of the group's (lane, 4 columns), combined over
  // the splits in split order, read over distributed shared memory
  const float* rm[kTcSplits];
  const float* rl[kTcSplits];
  const float* ra[kTcSplits];
#pragma unroll
  for (int z = 0; z < kTcSplits; ++z) {
    rm[z] = cluster.map_shared_rank(sm.bm, z);
    rl[z] = cluster.map_shared_rank(sm.bl, z);
    ra[z] = cluster.map_shared_rank(sm.bacc, z);
  }
  const int items = nl * quads;
  const int share = (items + kTcSplits - 1) / kTcSplits;
  const int end = min(items, (split + 1) * share);
  for (int it = split * share + tid; it < end; it += blockDim.x) {
    const int ln = it / quads;
    const int d = (it - ln * quads) * 4;
    float mz[kTcSplits], lz[kTcSplits], mx, lsum;
    float4 az[kTcSplits], o;
#pragma unroll
    for (int z = 0; z < kTcSplits; ++z) {
      mz[z] = rm[z][ln];
      lz[z] = rl[z][ln];
      az[z] = *reinterpret_cast<const float4*>(ra[z] + (size_t)ln * DP + d);
    }
    combine(mz, lz, az, mx, lsum, o);
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    uint2 packed;
    packed.x = pack_bf16(o.x * inv, o.y * inv);
    packed.y = pack_bf16(o.z * inv, o.w * inv);
    *reinterpret_cast<uint2*>(out + base + (size_t)ln * D + d) = packed;
  }
  cluster.sync();  // no block leaves while another reads its rows
}

// The kernel's shared-memory limit is raised once per size, and whether
// the card can schedule a cluster of such blocks is asked once.
template <int DP, int NT, bool Q8>
int launch_tc_dp(const void* q, const void* pool_k, const void* pool_v,
                 const void* k_scales, const void* v_scales, const void* tables,
                 const void* pos, const void* anc, void* out, int B, int KV,
                 int lanes, int W, int D, int bs, int M, int groups, int smem,
                 float sm_scale, void* stream) {
  auto kernel = decode_tc_kernel<DP, NT, Q8>;
  static int smem_set = 0;
  static int schedulable = 0;  // the largest smem found schedulable
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * kTcSplits, KV, B);
  cfg.blockDim = dim3(32 * kTcWarps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kTcSplits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > schedulable) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    schedulable = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)q, pool_k, pool_v,
                           (const float*)k_scales, (const float*)v_scales,
                           (const int*)tables, (const int*)pos,
                           (const int*)anc, (bf16*)out, KV, lanes, W, D, bs,
                           M, sm_scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch plan of the tensor-core route for `lanes` lanes a kv head:
// DP, NT (1, 2 or 4 n8 tiles, as few as hold the lanes) and the groups,
// from (lanes, D) alone.
struct TcPlan {
  int DP, nt, groups;
};
__host__ inline TcPlan tc_plan(int lanes, int D) {
  int DP = 16;
  while (DP < D) DP *= 2;
  const int tiles = (lanes + 7) / 8;
  int nt = tiles <= 1 ? 1 : tiles <= 2 ? 2 : 4;
  if (nt > tc_max_nt(DP)) nt = tc_max_nt(DP);
  return {DP, nt, (lanes + 8 * nt - 1) / (8 * nt)};
}

// The plan (DP, NT, groups, splits, stages, shared memory) comes from the
// wrapper (ops/paged_attention.py: tc_plan); one that disagrees with the
// plan and layout this file computes is refused (cudaErrorInvalidValue),
// and so is a cluster the card cannot schedule
// (cudaErrorInvalidConfiguration).
template <bool Q8>
int launch_tc(const void* q, const void* pool_k, const void* pool_v,
              const void* k_scales, const void* v_scales, const void* tables,
              const void* pos, const void* anc, void* out, int B, int KV,
              int lanes, int W, int D, int bs, int M, int DP, int nt,
              int groups, int splits, int stages, int smem, float sm_scale,
              void* stream) {
  if (B < 1 || lanes < 1 || W < 1 || lanes % W || D < 8 || D > 256 ||
      D % 8 || bs < 1 || M < 1 || (anc != nullptr && W > 32))
    return (int)cudaErrorInvalidValue;
  const TcPlan pl = tc_plan(lanes, D);
  if (DP != pl.DP || nt != pl.nt || groups != pl.groups ||
      splits != kTcSplits || stages != kTcStages || smem < 0 ||
      (size_t)smem > kMaxSmem || (size_t)smem != tc_smem_bytes(nt, DP, M, Q8))
    return (int)cudaErrorInvalidValue;
#define MXTPU_TC(DPV, NTV)                                                   \
  if (DP == DPV && nt == NTV)                                                \
    return launch_tc_dp<DPV, NTV, Q8>(q, pool_k, pool_v, k_scales, v_scales, \
                                      tables, pos, anc, out, B, KV, lanes, W, \
                                      D, bs, M, groups, smem, sm_scale,       \
                                      stream);
#define MXTPU_TC_NT(DPV) MXTPU_TC(DPV, 1) MXTPU_TC(DPV, 2) MXTPU_TC(DPV, 4)
  MXTPU_TC_NT(16)
  MXTPU_TC_NT(32)
  MXTPU_TC_NT(64)
  MXTPU_TC_NT(128)
  MXTPU_TC(256, 1)
  MXTPU_TC(256, 2)
#undef MXTPU_TC_NT
#undef MXTPU_TC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int mxtpu_paged_decode_stages(int lanes, int D, int bs, int M, int elt) {
  return mxtpu_port::attend_stages(tile_lanes(lanes, bs), D, bs, M, elt);
}

// the float32 route
int mxtpu_paged_decode_f32(const void* q, const void* pool_k,
                           const void* pool_v, const void* tables,
                           const void* pos, const void* nv, const void* anc,
                           void* out, int B, int KV, int lanes, int W, int D,
                           int bs, int M, float sm_scale, void* stream) {
  return launch<float, float>(q, pool_k, pool_v, nullptr, nullptr, tables,
                              pos, nv, anc, out, B, KV, lanes, W, D, bs, M,
                              sm_scale, stream);
}
int mxtpu_paged_decode_f32_q8(const void* q, const void* pool_k,
                              const void* pool_v, const void* k_scales,
                              const void* v_scales, const void* tables,
                              const void* pos, const void* nv,
                              const void* anc, void* out, int B, int KV,
                              int lanes, int W, int D, int bs, int M,
                              float sm_scale, void* stream) {
  return launch<float, int8_t>(q, pool_k, pool_v, k_scales, v_scales, tables,
                               pos, nv, anc, out, B, KV, lanes, W, D, bs, M,
                               sm_scale, stream);
}

// the tensor-core route (bfloat16 queries); anc may be null
int mxtpu_paged_decode_tc_bf16(const void* q, const void* pool_k,
                               const void* pool_v, const void* tables,
                               const void* pos, const void* anc, void* out,
                               int B, int KV, int lanes, int W, int D, int bs,
                               int M, int DP, int nt, int groups, int splits,
                               int stages, int smem, float sm_scale,
                               void* stream) {
  return launch_tc<false>(q, pool_k, pool_v, nullptr, nullptr, tables, pos,
                          anc, out, B, KV, lanes, W, D, bs, M, DP, nt, groups,
                          splits, stages, smem, sm_scale, stream);
}
int mxtpu_paged_decode_tc_bf16_q8(const void* q, const void* pool_k,
                                  const void* pool_v, const void* k_scales,
                                  const void* v_scales, const void* tables,
                                  const void* pos, const void* anc, void* out,
                                  int B, int KV, int lanes, int W, int D,
                                  int bs, int M, int DP, int nt, int groups,
                                  int splits, int stages, int smem,
                                  float sm_scale, void* stream) {
  return launch_tc<true>(q, pool_k, pool_v, k_scales, v_scales, tables, pos,
                         anc, out, B, KV, lanes, W, D, bs, M, DP, nt, groups,
                         splits, stages, smem, sm_scale, stream);
}

}  // extern "C"
