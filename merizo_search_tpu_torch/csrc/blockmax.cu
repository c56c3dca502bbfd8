// Phase A launcher: the kernel runs blockmax_body (blockmax.cuh, whose
// header says what it computes, which TPU kernel it replaces and what
// bounds it) once per CTA of a (query tiles, block chunks) grid sized to
// about one CTA an SM. The tile width N and the length channel are template
// arguments: the kernel is built for each N and with and without the
// channel, and the launcher picks one by N and by whether tl is given. The
// DB reaches the kernel as a TMA tensor map encoded here for each call (the
// pointer and the row count change between calls).
#include "blockmax.cuh"

namespace mst {

template <class T, int N, bool LEN>
__global__ void __launch_bounds__(THREADS, 1)
blockmax_kernel(const __grid_constant__ CUtensorMap map, const typename T::In* __restrict__ q,
                const float* __restrict__ tl, const float* __restrict__ qcap,
                const float* __restrict__ scales, float* __restrict__ bm, int nq, int nb,
                long long n_valid, int blocks_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  blockmax_body<T, N, LEN>(smem, map, q, tl, qcap, scales, bm, nq, nb, n_valid, blocks_per_cta,
                           blockIdx.x, blockIdx.y);
}

template <class T, int N, bool LEN>
int launch_blockmax(const CUtensorMap& map, const void* q, const float* tl, const float* qcap,
                    const float* scales, float* bm, int nq, int nb, long long n_valid,
                    int blocks_per_cta, cudaStream_t stream) {
  const size_t smem = WalkSmem<T, N>::LAUNCH;
  cudaError_t err = allow_smem(blockmax_kernel<T, N, LEN>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nq + N - 1) / N, (nb + blocks_per_cta - 1) / blocks_per_cta);
  blockmax_kernel<T, N, LEN><<<grid, THREADS, smem, stream>>>(
      map, static_cast<const typename T::In*>(q), tl, qcap, scales, bm, nq, nb, n_valid,
      blocks_per_cta);
  return cudaGetLastError();
}

template <class T>
int launch_blockmax_t(const void* q, const void* db, const float* tl, const float* qcap,
                      const float* scales, float* bm, int nq, int nb, long long n_valid,
                      int tile, int blocks_per_cta, cudaStream_t s) {
  if (blocks_per_cta < 1 || nq < 1) return cudaErrorInvalidValue;
  CUtensorMap map;
  const int rc = db_tensor_map<T>(&map, db, (long long)nb * BLOCK);
  if (rc != 0) return rc;
  return by_tile(tile, [&](auto tw) {
    constexpr int N = decltype(tw)::value;
    if (tl != nullptr)
      return launch_blockmax<T, N, true>(map, q, tl, qcap, scales, bm, nq, nb, n_valid,
                                         blocks_per_cta, s);
    return launch_blockmax<T, N, false>(map, q, nullptr, nullptr, scales, bm, nq, nb, n_valid,
                                        blocks_per_cta, s);
  });
}

}  // namespace mst

// dtype: 0 = bf16, 1 = int8 (scales required). tl/qcap: both or neither.
// tile: the query tile width N, 32, 64, 128 or 256. Returns 0, a
// cudaError_t, or mst::ERR_TMAP + the tensor-map encode's CUresult.
extern "C" int mst_blockmax_scan(int dtype, const void* q, const void* db,
                                 const void* tl, const void* qcap,
                                 const void* scales, void* bm, int nq, int nb,
                                 long long n_valid, int tile, int blocks_per_cta,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return mst::launch_blockmax_t<mst::Bf16>(q, db, f(tl), f(qcap), f(scales),
                                             static_cast<float*>(bm), nq, nb, n_valid, tile,
                                             blocks_per_cta, s);
  if (dtype == 1)
    return mst::launch_blockmax_t<mst::Int8>(q, db, f(tl), f(qcap), f(scales),
                                             static_cast<float*>(bm), nq, nb, n_valid, tile,
                                             blocks_per_cta, s);
  return cudaErrorInvalidValue;
}

// Phase A's shared-memory layout as the kernel is built with it
// (WalkSmem<T, N>, blockmax.cuh), for dtype 0 = bf16 / 1 = int8 and tile
// width n: out[0..8] = stages, a slot's bytes, the offsets QT, TL, QCAP,
// RED, BAR, the layout's bytes and the launch's (with the alignment slack).
// Returns 0, or cudaErrorInvalidValue for another dtype or width. Host
// only: it needs no card.
extern "C" int mst_walk_layout(int dtype, int n, int* out) {
  auto fill = [&](auto t) {
    using T = decltype(t);
    return mst::by_tile(n, [&](auto tw) {
      using L = mst::WalkSmem<T, decltype(tw)::value>;
      const int v[9] = {L::S, mst::Slot<T>::BYTES, L::QT, L::TL, L::QCAP, L::RED, L::BAR,
                        L::BYTES, L::LAUNCH};
      for (int i = 0; i < 9; ++i) out[i] = v[i];
      return 0;
    });
  };
  if (dtype == 0) return fill(mst::Bf16{});
  if (dtype == 1) return fill(mst::Int8{});
  return cudaErrorInvalidValue;
}
