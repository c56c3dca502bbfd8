// Phase A launcher: the kernel runs blockmax_body (blockmax.cuh, whose
// header says what it computes, which TPU kernel it replaces and what
// bounds it) once per CTA of a (query tiles, block chunks) grid. The length
// channel is a template argument: the kernel is built with it and without
// it, and the launcher picks one by whether tl is given.
#include "blockmax.cuh"

namespace mst {

template <class T, bool LEN>
__global__ void __launch_bounds__(THREADS, T::CTAS)
blockmax_kernel(const typename T::In* __restrict__ q,
                const typename T::In* __restrict__ db,
                const float* __restrict__ tl, const float* __restrict__ qcap,
                const float* __restrict__ scales, float* __restrict__ bm,
                int nq, int nb, long long n_valid, int qgroups, int blocks_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  blockmax_body<T, LEN>(smem, q, db, tl, qcap, scales, bm, nq, nb, n_valid, qgroups,
                        blocks_per_cta, blockIdx.x, blockIdx.y);
}

template <class T, bool LEN>
cudaError_t launch_blockmax(const void* q, const void* db, const float* tl,
                            const float* qcap, const float* scales, float* bm, int nq,
                            int nb, long long n_valid, int qgroups, int blocks_per_cta,
                            cudaStream_t stream) {
  const size_t smem = blockmax_smem<T>();
  cudaError_t err = allow_smem(blockmax_kernel<T, LEN>, smem);
  if (err != cudaSuccess) return err;
  const int qt = QG * qgroups;
  dim3 grid((nq + qt - 1) / qt, (nb + blocks_per_cta - 1) / blocks_per_cta);
  blockmax_kernel<T, LEN><<<grid, THREADS, smem, stream>>>(
      static_cast<const typename T::In*>(q), static_cast<const typename T::In*>(db),
      tl, qcap, scales, bm, nq, nb, n_valid, qgroups, blocks_per_cta);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_blockmax_len(const void* q, const void* db, const float* tl,
                                const float* qcap, const float* scales, float* bm, int nq,
                                int nb, long long n_valid, int qgroups, int blocks_per_cta,
                                cudaStream_t s) {
  if (qgroups != 1 && qgroups != 2 && qgroups != 4 && qgroups != 8)
    return cudaErrorInvalidValue;
  if (tl != nullptr)
    return launch_blockmax<T, true>(q, db, tl, qcap, scales, bm, nq, nb, n_valid, qgroups,
                                    blocks_per_cta, s);
  return launch_blockmax<T, false>(q, db, nullptr, nullptr, scales, bm, nq, nb, n_valid,
                                   qgroups, blocks_per_cta, s);
}

}  // namespace mst

// dtype: 0 = bf16, 1 = int8 (scales required). tl/qcap: both or neither.
// qgroups: 1, 2, 4 or 8 (a query tile of 32 * qgroups queries).
extern "C" int mst_blockmax_scan(int dtype, const void* q, const void* db,
                                 const void* tl, const void* qcap,
                                 const void* scales, void* bm, int nq, int nb,
                                 long long n_valid, int qgroups, int blocks_per_cta,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return mst::launch_blockmax_len<mst::Bf16>(q, db, f(tl), f(qcap), f(scales),
                                               static_cast<float*>(bm), nq, nb, n_valid,
                                               qgroups, blocks_per_cta, s);
  if (dtype == 1)
    return mst::launch_blockmax_len<mst::Int8>(q, db, f(tl), f(qcap), f(scales),
                                               static_cast<float*>(bm), nq, nb, n_valid,
                                               qgroups, blocks_per_cta, s);
  return cudaErrorInvalidValue;
}
