// Ragged paged decode and verify attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mxtpu/ops/pallas/paged_attention.py
// (_kernel, launched by _call_local / paged_decode_attention): the plain
// decode step (W = 1), the speculative verify window (W > 1) and the
// tree-verify ancestor mask (anc, W <= 32), over float32 or bfloat16
// pools of q's dtype, or over int8 pools with float32 scales (the
// kernel's `quant` form, dequantized where a value leaves shared memory;
// paged_common.cuh).
//
// The rep*W query lanes of one (slot b, kv head) are lane l = r*W + w
// (the kv-major GQA fold).  They are cut into tiles of at most
// max_lanes(256, bs) lanes (32 at every block size up to 64), and one
// CUDA block of 256 threads serves one (slot, kv head, lane tile): it
// loads its own tables[b, :nv], pos[b] and anc[b, :], holds its lanes'
// queries (pre-scaled, float32) in shared memory, and walks the slot's
// pages in tiles of up to 64 keys with a float32 online softmax
// (paged_common.cuh).  The walk stops at the last page any lane of the
// tile attends.  Dead pool lanes carry an all-null table and pos 0: they
// walk page 0 alone and their output is ignored.
//
// Masks.  Without anc, lane l attends key positions <= pos[b] + w (lim)
// with an empty window mask.  With anc, lim = pos[b] - 1 (the committed
// history) and the window mask is anc[b, w] | (1u << w) over positions
// pos[b] .. pos[b] + 31: the lane's strict ancestors and itself.  A
// degenerate chain, anc[b, w] = (1 << w) - 1, gives the same key set as
// no anc, hence the same bits.  A lane's arithmetic never depends on the
// other lanes of its block, and a key tile past its limit adds exactly
// 0 with a correction of exactly 1, so lane w of a W-lane call equals a
// W = 1 call at pos[b] + w on the same pools, bit for bit.
//
// Bound on the H100: bytes.  A call reads each live slot's K/V pages
// (once per lane tile, the repeats mostly from L2) and does about
// `lanes` flops per byte of a bf16 page: 4 on Llama-3-8B's plain step,
// 32-128 on its verify windows, all below the card's ~295 flop/byte
// ridge.  The grid is B*KV*tiles blocks (64 on the 8B plain step, fewer
// than the 132 SMs); each block walks its slot's tiles one after
// another (PERF.md has the times).  Splitting the walk across blocks is
// the next step.

#include "paged_common.cuh"

namespace {

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

}  // namespace

extern "C" {

int mxtpu_paged_decode_stages(int lanes, int D, int bs, int M, int elt) {
  return mxtpu_port::attend_stages(tile_lanes(lanes, bs), D, bs, M, elt);
}

#define MXTPU_DECODE_ENTRIES(SUFFIX, T)                                      \
  int mxtpu_paged_decode_##SUFFIX(                                           \
      const void* q, const void* pool_k, const void* pool_v,                 \
      const void* tables, const void* pos, const void* nv, const void* anc,  \
      void* out, int B, int KV, int lanes, int W, int D, int bs, int M,      \
      float sm_scale, void* stream) {                                        \
    return launch<T, T>(q, pool_k, pool_v, nullptr, nullptr, tables, pos,    \
                        nv, anc, out, B, KV, lanes, W, D, bs, M, sm_scale,   \
                        stream);                                             \
  }                                                                          \
  int mxtpu_paged_decode_##SUFFIX##_q8(                                      \
      const void* q, const void* pool_k, const void* pool_v,                 \
      const void* k_scales, const void* v_scales, const void* tables,        \
      const void* pos, const void* nv, const void* anc, void* out, int B,    \
      int KV, int lanes, int W, int D, int bs, int M, float sm_scale,        \
      void* stream) {                                                        \
    return launch<T, int8_t>(q, pool_k, pool_v, k_scales, v_scales, tables, \
                             pos, nv, anc, out, B, KV, lanes, W, D, bs, M,   \
                             sm_scale, stream);                              \
  }

MXTPU_DECODE_ENTRIES(f32, float)
MXTPU_DECODE_ENTRIES(bf16, __nv_bfloat16)

}  // extern "C"
