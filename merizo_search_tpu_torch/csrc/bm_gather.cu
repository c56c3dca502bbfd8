// The two-batch pipelined scan: phase A of batch i and phase C of batch i-1
// in one launch.
//
// Replaces the Pallas kernel `_bm_gather_kernel` (merizo_search TPU package,
// ops/pallas_scan.py, launched by `blockmax_scan_gather` and driven by
// `fused_topk_step`). Contract, for q [Q, 128] this batch's queries and
// pv_q [Qp, 128], pv_bidx [Qp, KB] int32 the previous batch's queries and
// selected blocks (-1 = padding):
//   - bm [Q, Npad/128]: phase A of blockmax.cuh without the length channel
//     (the JAX kernel has none); int8 maxima times the block scale;
//   - prev [Qp, KB*128]: phase C of gather.cuh without the length channel:
//     bf16 scores; int8 scores times pv_scale_sel [Qp, KB] (the previous
//     batch's per-selected-block scales, gather.cuh's production mode), or
//     raw as f32 where pv_scale_sel is null; NEG_CAP where bidx < 0, the
//     row is >= n_valid or the score is NaN.
// The grid is blockmax's (query tile, block chunk) CTAs, flattened in the
// order of its own launch, followed by gather's (query, column) CTAs;
// blockIdx.x picks the role, and each role runs the CTA body of its
// standalone kernel through one tensor map of the DB. Every score is
// therefore computed by the same score_issue (scan_common.cuh) on the same
// operand positions, and the pipelined results equal the sequential
// fused_topk's bit for bit.
//
// Not carried over from the TPU: the grid windows that tie each previous
// query to a run of grid steps, the padding of KB to 8, the SMEM/VMEM twin
// of pv_bidx and the hand-rolled tile DMA. On the TPU one sequential grid
// had to interleave issuing the gather's DMAs with the stream; here the
// phase-C CTAs are more CTAs, which the hardware schedules onto free SMs.
//
// Bound on the H100: bytes -- the DB read once (phase C's blocks are rows
// of the same DB) over 3.35 TB/s. One launch has one thread count and one
// shared-memory size for both roles: phase A's (THREADS = 384, three
// warpgroups, and its ring for the tile width). A phase-C CTA runs the
// per-query body on its first warpgroup (the body meets on a named barrier
// of 128 threads, so the other two warpgroups return at once) at phase A's
// shared-memory size, one CTA an SM. Phase A's CTAs take the grid geometry
// of the standalone launch (tile width and blocks a CTA from
// ops/blockmax.py, one CTA an SM) and phase C's CTAs run after them and
// mostly add their time. setmaxnreg needs ptxas to see each warpgroup's
// register count at entry; the phase-C branch shares this kernel's entry,
// and ptxas honours it all the same (no warning in _build/nvcc.log).
#include <algorithm>
#include <climits>

#include "blockmax.cuh"
#include "gather.cuh"

namespace mst {

template <class T, int N>
__global__ void __launch_bounds__(THREADS, 1)
bm_gather_kernel(const __grid_constant__ CUtensorMap map, const typename T::In* __restrict__ q,
                 const float* __restrict__ scales, float* __restrict__ bm, int nq, int nb,
                 long long n_valid, int blocks_per_cta, int a_ctas,
                 const typename T::In* __restrict__ pv_q, const int* __restrict__ pv_bidx,
                 const float* __restrict__ pv_scale_sel, float* __restrict__ prev, int kb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int id = blockIdx.x;
  if (id < a_ctas) {
    const int qtiles = (nq + N - 1) / N;
    blockmax_body<T, N, false>(smem, map, q, nullptr, nullptr, scales, bm, nq, nb, n_valid,
                               blocks_per_cta, id % qtiles, id / qtiles);
  } else if (threadIdx.x < GTHREADS) {
    const int c = id - a_ctas;
    gather_body<T>(smem, map, pv_q, nullptr, nullptr, pv_bidx, pv_scale_sel, nullptr, prev, kb,
                   n_valid, c / kb, c % kb);
  }
}

template <class T, int N>
int launch_bm_gather(const CUtensorMap& map, const void* q, const float* scales, float* bm,
                     int nq, int nb, long long n_valid, int blocks_per_cta, const void* pv_q,
                     const int* pv_bidx, const float* pv_scale_sel, float* prev, int nq_prev,
                     int kb, cudaStream_t stream) {
  const size_t smem = std::max<size_t>(WalkSmem<T, N>::LAUNCH, GatherSmem<T>::LAUNCH);
  cudaError_t err = allow_smem(bm_gather_kernel<T, N>, smem);
  if (err != cudaSuccess) return err;
  const long long a_ctas = (long long)((nq + N - 1) / N) *
                           ((nb + blocks_per_cta - 1) / blocks_per_cta);
  const long long ctas = a_ctas + (long long)nq_prev * kb;
  if (ctas <= 0 || ctas > INT_MAX) return cudaErrorInvalidValue;
  using In = typename T::In;
  bm_gather_kernel<T, N><<<(unsigned)ctas, THREADS, smem, stream>>>(
      map, static_cast<const In*>(q), scales, bm, nq, nb, n_valid, blocks_per_cta, (int)a_ctas,
      static_cast<const In*>(pv_q), pv_bidx, pv_scale_sel, prev, kb);
  return cudaGetLastError();
}

template <class T>
int launch_bm_gather_t(const void* q, const void* db, const float* scales, float* bm, int nq,
                       int nb, long long n_valid, int tile, int blocks_per_cta,
                       const void* pv_q, const int* pv_bidx, const float* pv_scale_sel,
                       float* prev, int nq_prev, int kb, cudaStream_t s) {
  if (blocks_per_cta < 1) return cudaErrorInvalidValue;
  CUtensorMap map;
  const int rc = db_tensor_map<T>(&map, db, (long long)nb * BLOCK);
  if (rc != 0) return rc;
  return by_tile(tile, [&](auto tw) {
    return launch_bm_gather<T, decltype(tw)::value>(map, q, scales, bm, nq, nb, n_valid,
                                                    blocks_per_cta, pv_q, pv_bidx,
                                                    pv_scale_sel, prev, nq_prev, kb, s);
  });
}

}  // namespace mst

// dtype: 0 = bf16 (scales and pv_scale_sel null), 1 = int8 (scales
// required, pv_scale_sel optional). tile: phase A's query tile width.
// Returns 0, a cudaError_t, or mst::ERR_TMAP + the encode's CUresult.
extern "C" int mst_bm_gather(int dtype, const void* q, const void* db,
                             const void* scales, void* bm, int nq, int nb,
                             long long n_valid, int tile, int blocks_per_cta,
                             const void* pv_q, const void* pv_bidx,
                             const void* pv_scale_sel, void* prev, int nq_prev,
                             int kb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scales);
  auto ib = static_cast<const int*>(pv_bidx);
  auto ss = static_cast<const float*>(pv_scale_sel);
  auto b = static_cast<float*>(bm);
  auto p = static_cast<float*>(prev);
  if (dtype == 0)
    return mst::launch_bm_gather_t<mst::Bf16>(q, db, sc, b, nq, nb, n_valid, tile,
                                              blocks_per_cta, pv_q, ib, ss, p, nq_prev, kb, s);
  if (dtype == 1)
    return mst::launch_bm_gather_t<mst::Int8>(q, db, sc, b, nq, nb, n_valid, tile,
                                              blocks_per_cta, pv_q, ib, ss, p, nq_prev, kb, s);
  return cudaErrorInvalidValue;
}
