// Phase C launcher: the kernel runs gather_body (gather.cuh, whose header
// says what it computes, which TPU kernels it replaces and what bounds
// it) once per CTA of a (queries, column groups) grid.
#include "gather.cuh"

namespace mst {

template <class T>
__global__ void __launch_bounds__(GTHREADS)
gather_kernel(const typename T::In* __restrict__ q,
              const typename T::In* __restrict__ db,
              const float* __restrict__ tl, const float* __restrict__ qcap,
              const int* __restrict__ bidx, const float* __restrict__ scale_sel,
              const float* __restrict__ scales, float* __restrict__ out, int kb,
              long long n_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  gather_body<T>(smem, q, db, tl, qcap, bidx, scale_sel, scales, out, kb,
                 n_valid, blockIdx.x, blockIdx.y);
}

template <class T>
cudaError_t launch_gather(const void* q, const void* db, const float* tl,
                          const float* qcap, const int* bidx,
                          const float* scale_sel, const float* scales,
                          float* out, int nq, int kb, long long n_valid,
                          cudaStream_t stream) {
  const size_t smem = gather_smem<T>();
  cudaError_t err = allow_smem(gather_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, (kb + GROUP - 1) / GROUP);
  gather_kernel<T><<<grid, GTHREADS, smem, stream>>>(
      static_cast<const typename T::In*>(q), static_cast<const typename T::In*>(db),
      tl, qcap, bidx, scale_sel, scales, out, kb, n_valid);
  return cudaGetLastError();
}

}  // namespace mst

// dtype: 0 = bf16, 1 = int8. tl/qcap: both or neither. At most one of
// scale_sel / scales is non-null.
extern "C" int mst_gather_block_scores(int dtype, const void* q, const void* db,
                                       const void* tl, const void* qcap,
                                       const void* bidx, const void* scale_sel,
                                       const void* scales, void* out, int nq,
                                       int kb, long long n_valid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto ib = static_cast<const int*>(bidx);
  auto o = static_cast<float*>(out);
  if (dtype == 0)
    return mst::launch_gather<mst::Bf16>(q, db, f(tl), f(qcap), ib, f(scale_sel),
                                         f(scales), o, nq, kb, n_valid, s);
  if (dtype == 1)
    return mst::launch_gather<mst::Int8>(q, db, f(tl), f(qcap), ib, f(scale_sel),
                                         f(scales), o, nq, kb, n_valid, s);
  return cudaErrorInvalidValue;
}
