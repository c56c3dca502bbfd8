// Phase A in slabs, with superblock maxima.
//
// Replaces the Pallas kernel `_kernel` of the TPU package's measurement tool
// tools/perf_slab_interleave.py (built and launched by `scan_v2`). Contract,
// for q [Q, 128] and db [Npad, 128] of one dtype, Npad a multiple of tile:
//   - bm [Q, Npad/128]: phase A's block maxima with no length channel: the
//     f32 dot (bf16), or the int32 dot times the block's scale (int8,
//     scales[b*128]); floored at NEG_CAP; NEG_CAP for every block whose
//     first row is >= n_valid;
//   - part [Q, Npad/tile * NSLAB]: the max of bm over each slab of
//     tile/NSLAB rows. The wrapper folds it to sbm [Q, Npad/tile], the max
//     of bm over each tile (ops/slab_interleave.py). With part null the
//     kernel is instantiated without it (SBM false): phase A as the search
//     path launches it, BM alone, with the channel compiled out.
//
// What nslab shapes here. On the TPU one grid step took one tile, and nslab
// cut it into row sub-slabs so that the MXU dot of slab r+1 could overlap
// the VPU block-max reduce of slab r. An SM has no such split: within a CTA
// one consumer's tensor-core products run while the other reduces, and the
// TMA ring keeps the next blocks in flight. Here nslab sets the work of one
// CTA instead: a CTA takes one query tile and one slab (tile/nslab rows),
// so nslab sets how many CTAs share a tile, how many blocks each walks
// after staging its query tile once, and how many
// partial maxima a tile has. The outputs do not depend on it.
//
// The CTA body is blockmax.cuh's, built without the length channel (LEN
// false) and with the optional `part` output on. So every score comes from
// score_issue (scan_common.cuh) and BM equals blockmax_scan's with the
// channel off bit for bit, for every nslab.
//
// Bound on the H100: bytes, the DB read once (bf16 4 GiB at 2^24 rows: 1.3
// ms at 3.35 TB/s); like phase A it computes on tensor cores (wgmma).
#include <climits>

#include "blockmax.cuh"

namespace mst {

template <class T, int N, bool SBM>
__global__ void __launch_bounds__(THREADS, 1)
slab_scan_kernel(const __grid_constant__ CUtensorMap map, const typename T::In* __restrict__ q,
                 const float* __restrict__ scales, float* __restrict__ bm,
                 float* __restrict__ part, int nq, int nb, long long n_valid, int slab_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  // a 1-D grid in blockmax's order: the query tiles of a slab run together,
  // so the slab's rows come from device memory once
  const int qtiles = (nq + N - 1) / N;
  const int id = blockIdx.x;
  blockmax_body<T, N, false>(smem, map, q, nullptr, nullptr, scales, bm, nq, nb, n_valid,
                             slab_blocks, id % qtiles, id / qtiles, SBM ? part : nullptr);
}

template <class T, int N, bool SBM>
int launch_slab_sbm(const CUtensorMap& map, const void* q, const float* scales, float* bm,
                    float* part, int nq, int nb, long long n_valid, int slab_blocks,
                    cudaStream_t stream) {
  const size_t smem = WalkSmem<T, N>::LAUNCH;
  cudaError_t err = allow_smem(slab_scan_kernel<T, N, SBM>, smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((nq + N - 1) / N) * (nb / slab_blocks);
  if (ctas <= 0 || ctas > INT_MAX) return cudaErrorInvalidValue;
  slab_scan_kernel<T, N, SBM><<<(unsigned)ctas, THREADS, smem, stream>>>(
      map, static_cast<const typename T::In*>(q), scales, bm, part, nq, nb, n_valid,
      slab_blocks);
  return cudaGetLastError();
}

template <class T>
int launch_slab(int nslab, const void* q, const void* db, const float* scales, float* bm,
                float* part, int nq, int nb, long long n_valid, int tile, int tile_blocks,
                cudaStream_t s) {
  if (nslab != 1 && nslab != 2 && nslab != 4 && nslab != 8) return cudaErrorInvalidValue;
  if (tile_blocks < nslab || tile_blocks % nslab || nb % tile_blocks) return cudaErrorInvalidValue;
  CUtensorMap map;
  const int rc = db_tensor_map<T>(&map, db, (long long)nb * BLOCK);
  if (rc != 0) return rc;
  return by_tile(tile, [&](auto tw) {
    constexpr int N = decltype(tw)::value;
    if (part != nullptr)
      return launch_slab_sbm<T, N, true>(map, q, scales, bm, part, nq, nb, n_valid,
                                         tile_blocks / nslab, s);
    return launch_slab_sbm<T, N, false>(map, q, scales, bm, part, nq, nb, n_valid,
                                        tile_blocks / nslab, s);
  });
}

}  // namespace mst

// dtype: 0 = bf16 (scales null), 1 = int8 (scales [Npad] required). nslab:
// 1, 2, 4 or 8, dividing tile_blocks (= tile / 128), which divides nb.
// tile: the query tile width, 32, 64, 128 or 256.
// bm [nq, nb]; part [nq, nb / tile_blocks * nslab], or null for BM alone.
// Returns 0, a cudaError_t, or mst::ERR_TMAP + the encode's CUresult.
extern "C" int mst_slab_scan(int dtype, int nslab, const void* q, const void* db,
                             const void* scales, void* bm, void* part, int nq, int nb,
                             long long n_valid, int tile, int tile_blocks,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scales);
  auto b = static_cast<float*>(bm);
  auto p = static_cast<float*>(part);
  if (dtype == 0)
    return mst::launch_slab<mst::Bf16>(nslab, q, db, sc, b, p, nq, nb, n_valid, tile,
                                       tile_blocks, s);
  if (dtype == 1)
    return mst::launch_slab<mst::Int8>(nslab, q, db, sc, b, p, nq, nb, n_valid, tile,
                                       tile_blocks, s);
  return cudaErrorInvalidValue;
}
