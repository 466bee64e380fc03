// Chunked-prefill attention over one slot's block table, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel mxtpu/ops/pallas/prefill_attention.py
// (_kernel, launched by _call_local / paged_prefill_attention), over
// float pools of q's dtype or int8 pools with float32 scales (the
// kernel's `quant` form; paged_common.cuh).
//
// The chunk's queries q (1, H, T, D) fold kv-major into rep*T lanes per
// kv head, lane L = r*T + t.  One CUDA block of 512 threads per (kv
// head, tile of kQTile lanes) walks the table with the float32 online
// softmax of paged_common.cuh; lane L attends logical key positions
// <= start + L % T.  The walk stops at the tile's last attended page:
// nv = clip((start+T-1)//bs + 1, 1, M) for the tile holding t = T-1,
// fewer pages for tiles of earlier positions.  T is the padded (bucket)
// chunk length, as in the Pallas kernel: padding lanes compute garbage
// the caller drops.
//
// Bound on the H100: near the ridge.  At Llama-3-8B shapes (T = 64,
// rep = 4, ~320 tokens of context) one call does ~0.34 GFLOP on ~1.3 MB
// of pages and queries, close to the card's 295 flop/byte.  This
// version computes in float32 on the CUDA cores, not on the tensor
// cores, so it is bound by its own arithmetic, and it re-reads each
// page once per lane tile (8 tiles per kv head at T = 64, mostly from
// L2).  Tensor-core tiles (mma/wgmma) and TMA page loads are the next
// step.

#include "paged_common.cuh"

namespace {

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

template <typename T, typename P>
int launch(const void* q, const void* pool_k, const void* pool_v,
           const void* k_scales, const void* v_scales, const void* table,
           const void* start, const void* nv, void* out, int KV, int rep,
           int T_len, int D, int bs, int M, float sm_scale, void* stream) {
  const int fold = rep * T_len;
  const int tiles = (fold + kQTile - 1) / kQTile;
  const int lanes = fold < kQTile ? fold : kQTile;
  const int stages =
      mxtpu_port::attend_stages(lanes, D, bs, M, (int)sizeof(P));
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      mxtpu_port::attend_smem_bytes(lanes, D, bs, M, (int)sizeof(P), stages);
  cudaError_t err = mxtpu_port::allow_smem(paged_prefill_kernel<T, P>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_prefill_kernel<T, P><<<KV * tiles, kThreads, smem,
                               (cudaStream_t)stream>>>(
      (const T*)q, (const P*)pool_k, (const P*)pool_v,
      (const float*)k_scales, (const float*)v_scales, (const int*)table,
      (const int*)start, (const int*)nv, (T*)out, KV, rep, T_len, D, bs, M,
      stages, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mxtpu_paged_prefill_stages(int fold, int D, int bs, int M, int elt) {
  return mxtpu_port::attend_stages(fold < kQTile ? fold : kQTile, D, bs, M,
                                   elt);
}

#define MXTPU_PREFILL_ENTRIES(SUFFIX, T)                                     \
  int mxtpu_paged_prefill_##SUFFIX(                                          \
      const void* q, const void* pool_k, const void* pool_v,                 \
      const void* table, const void* start, const void* nv, void* out,       \
      int KV, int rep, int T_len, int D, int bs, int M, float sm_scale,      \
      void* stream) {                                                        \
    return launch<T, T>(q, pool_k, pool_v, nullptr, nullptr, table, start,   \
                        nv, out, KV, rep, T_len, D, bs, M, sm_scale,         \
                        stream);                                             \
  }                                                                          \
  int mxtpu_paged_prefill_##SUFFIX##_q8(                                     \
      const void* q, const void* pool_k, const void* pool_v,                 \
      const void* k_scales, const void* v_scales, const void* table,         \
      const void* start, const void* nv, void* out, int KV, int rep,         \
      int T_len, int D, int bs, int M, float sm_scale, void* stream) {       \
    return launch<T, int8_t>(q, pool_k, pool_v, k_scales, v_scales, table,   \
                             start, nv, out, KV, rep, T_len, D, bs, M,       \
                             sm_scale, stream);                              \
  }

MXTPU_PREFILL_ENTRIES(f32, float)
MXTPU_PREFILL_ENTRIES(bf16, __nv_bfloat16)

}  // extern "C"
