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
// order of its own launch, followed by gather's (query, column group) CTAs;
// blockIdx.x picks the role, and each role runs the CTA body of its
// standalone kernel. Every score is therefore computed by the same mma_rows
// (scan_common.cuh) on the same operand positions, and the pipelined
// results equal the sequential fused_topk's bit for bit.
//
// Not carried over from the TPU: the grid windows that tie each previous
// query to a run of grid steps, the padding of KB to 8, the SMEM/VMEM twin
// of pv_bidx and the hand-rolled tile DMA. On the TPU one sequential grid
// had to interleave issuing the gather's DMAs with the stream; here the
// phase-C CTAs are more CTAs, which the hardware schedules onto free SMs.
//
// Bound on the H100: bytes -- the DB read once (phase C's blocks are rows
// of the same DB) over 3.35 TB/s. Both roles compute on tensor cores
// (mma.sync). One launch has one register and shared-memory budget for
// both roles (phase A's: 256 threads and its ring), so phase-C CTAs run at
// phase A's occupancy and their warps past the 4th stage rows but score
// none. Phase A's CTAs take the grid geometry of the standalone launch
// (query groups and blocks a CTA from ops/blockmax.py); phase C's CTAs run
// after phase A's and mostly add their time.
#include <algorithm>
#include <climits>

#include "blockmax.cuh"
#include "gather.cuh"

namespace mst {

template <class T>
__global__ void __launch_bounds__(THREADS, T::CTAS)
bm_gather_kernel(const typename T::In* __restrict__ q,
                 const typename T::In* __restrict__ db,
                 const float* __restrict__ scales, float* __restrict__ bm,
                 int nq, int nb, long long n_valid, int qgroups, int blocks_per_cta,
                 int a_ctas, const typename T::In* __restrict__ pv_q,
                 const int* __restrict__ pv_bidx,
                 const float* __restrict__ pv_scale_sel, float* __restrict__ prev,
                 int kb, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int id = blockIdx.x;
  if (id < a_ctas) {
    const int qtiles = (nq + QG * qgroups - 1) / (QG * qgroups);
    blockmax_body<T, false>(smem, q, db, nullptr, nullptr, scales, bm, nq, nb, n_valid,
                            qgroups, blocks_per_cta, id % qtiles, id / qtiles);
  } else {
    const int c = id - a_ctas;
    gather_body<T>(smem, pv_q, db, nullptr, nullptr, pv_bidx, pv_scale_sel,
                   nullptr, prev, kb, n_valid, c / groups, c % groups);
  }
}

template <class T>
cudaError_t launch_bm_gather(const void* q, const void* db, const float* scales,
                             float* bm, int nq, int nb, long long n_valid,
                             int qgroups, int blocks_per_cta, const void* pv_q,
                             const int* pv_bidx, const float* pv_scale_sel,
                             float* prev, int nq_prev, int kb,
                             cudaStream_t stream) {
  const size_t smem = std::max(blockmax_smem<T>(), gather_smem<T>());
  cudaError_t err = allow_smem(bm_gather_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  if (qgroups != 1 && qgroups != 2 && qgroups != 4 && qgroups != 8)
    return cudaErrorInvalidValue;
  const int qt = QG * qgroups;
  const long long a_ctas = (long long)((nq + qt - 1) / qt) *
                           ((nb + blocks_per_cta - 1) / blocks_per_cta);
  const int groups = (kb + GROUP - 1) / GROUP;
  const long long ctas = a_ctas + (long long)nq_prev * groups;
  if (ctas <= 0 || ctas > INT_MAX) return cudaErrorInvalidValue;
  using In = typename T::In;
  bm_gather_kernel<T><<<(unsigned)ctas, THREADS, smem, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(db), scales, bm, nq, nb,
      n_valid, qgroups, blocks_per_cta, (int)a_ctas, static_cast<const In*>(pv_q),
      pv_bidx, pv_scale_sel, prev, kb, groups);
  return cudaGetLastError();
}

}  // namespace mst

// dtype: 0 = bf16 (scales and pv_scale_sel null), 1 = int8 (scales
// required, pv_scale_sel optional).
extern "C" int mst_bm_gather(int dtype, const void* q, const void* db,
                             const void* scales, void* bm, int nq, int nb,
                             long long n_valid, int qgroups, int blocks_per_cta,
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
    return mst::launch_bm_gather<mst::Bf16>(q, db, sc, b, nq, nb, n_valid,
                                            qgroups, blocks_per_cta, pv_q, ib, ss, p, nq_prev,
                                            kb, s);
  if (dtype == 1)
    return mst::launch_bm_gather<mst::Int8>(q, db, sc, b, nq, nb, n_valid,
                                            qgroups, blocks_per_cta, pv_q, ib, ss, p, nq_prev,
                                            kb, s);
  return cudaErrorInvalidValue;
}
