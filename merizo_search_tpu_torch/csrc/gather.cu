// Phase C of the fused exact top-k scan: rescore the selected 128-row blocks.
//
// Replaces two Pallas kernels of the merizo_search TPU package
// (ops/pallas_scan.py): the kernel inside `gather_block_scores_dma` (the
// production path, which leaves dequantisation to a per-selected-block scale
// applied by the caller) and the kernel inside `gather_block_scores` (the
// BlockSpec variant, which applies per-row scales in the kernel). One kernel
// serves both through its scale mode:
//   - no scales:           out = score                       (bf16, or raw int8)
//   - scale_sel [Q, KB]:   out = score * scale_sel[q, col]   (int8, production)
//   - scales [Npad]:       out = score * scales[row]         (per-row mode)
// out[q, col*128 + r] is the score of row bidx[q, col]*128 + r, or NEG_CAP
// where bidx is -1 (padding), the row is >= n_valid, the length channel
// masks it (!(tl[row] <= qcap[q])), or the score is NaN.
//
// Each score comes from the same `dot_tile` as phase A's (scan_common.cuh),
// so a row scores the same float in both phases, and int8 scaling is the
// same f32 multiply of the same integer.
//
// Bound on the H100: each selected block is 32 KB (bf16) of scattered but
// contiguous reads, plus the [Q, KB*128] f32 output; at KB ~ k+2 the kernel
// moves a few MB per batch and is bound by bytes and launch latency, not by
// the dot work. Design: one CTA of 128 threads per (query, group of GROUP
// selected columns); the CTA reads its own bidx entries (no scalar
// prefetch, no chunking of wide selections -- those were TPU limits),
// stages each block's rows in shared memory with 16-byte coalesced loads,
// and each thread scores one row against the query held in shared memory.
#include "scan_common.cuh"

namespace mst {

constexpr int GTHREADS = BLOCK;  // one thread per row of a block
constexpr int GROUP = 4;         // selected blocks per CTA

template <class T>
size_t gather_smem() {
  return (size_t)(1 + BLOCK) * T::PITCH * sizeof(typename T::Word);
}

template <class T>
__global__ void __launch_bounds__(GTHREADS)
gather_kernel(const typename T::In* __restrict__ q,
              const typename T::In* __restrict__ db,
              const float* __restrict__ tl, const float* __restrict__ qcap,
              const int* __restrict__ bidx, const float* __restrict__ scale_sel,
              const float* __restrict__ scales, float* __restrict__ out, int kb,
              long long n_valid) {
  using Word = typename T::Word;
  extern __shared__ __align__(16) unsigned char smem[];
  Word* qs = reinterpret_cast<Word*>(smem);  // [1][PITCH]
  Word* xs = qs + T::PITCH;                  // [BLOCK][PITCH]

  const int qi = blockIdx.x;
  const int r = threadIdx.x;
  stage_rows<T>(q, qi, qi + 1, 1, qs);
  const float qc = tl != nullptr ? qcap[qi] : 0.f;
  const Word* const xr[1] = {xs + r * T::PITCH};
  const Word* const qr[1] = {qs};

  const int c_end = min(kb, (int)(blockIdx.y + 1) * GROUP);
  for (int c = blockIdx.y * GROUP; c < c_end; ++c) {
    const long long sel = (long long)qi * kb + c;
    const int b = bidx[sel];
    const long long base = (long long)max(b, 0) * BLOCK;
    __syncthreads();  // the previous block's rows are no longer read
    stage_rows<T>(db, base, base + BLOCK, BLOCK, xs);
    __syncthreads();

    typename T::Acc acc[1][1];
    dot_tile<T, 1, 1>(acc, xr, qr);
    float s = (float)acc[0][0];
    const long long row = base + r;
    bool keep = b >= 0 && row < n_valid;
    if (tl != nullptr) keep = keep && tl[row] <= qc;
    if (scale_sel != nullptr) s *= scale_sel[sel];
    if (scales != nullptr) s *= scales[row];
    out[sel * BLOCK + r] = (keep && s == s) ? s : NEG_CAP;
  }
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
