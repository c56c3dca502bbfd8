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
// the warps' tensor-core products and their reduces interleave block by
// block, and the cp.async ring keeps the next blocks in flight. Here nslab
// sets the work of one CTA instead: a CTA takes one query tile and one slab
// (tile/nslab rows), so nslab sets how many CTAs share a tile, how many
// blocks each walks after loading its query fragments once, and how many
// partial maxima a tile has. The outputs do not depend on it.
//
// The CTA body is blockmax.cuh's, built without the length channel (LEN
// false) and with the optional `part` output on. So every score comes from
// mma_rows (scan_common.cuh) and BM equals blockmax_scan's with the channel
// off bit for bit, for every nslab.
//
// Bound on the H100: bytes, the DB read once (bf16 4 GiB at 2^24 rows: 1.3
// ms at 3.35 TB/s); like phase A it computes on tensor cores (mma.sync).
#include <climits>

#include "blockmax.cuh"

namespace mst {

template <class T, bool SBM>
__global__ void __launch_bounds__(THREADS, T::CTAS)
slab_scan_kernel(const typename T::In* __restrict__ q,
                 const typename T::In* __restrict__ db,
                 const float* __restrict__ scales, float* __restrict__ bm,
                 float* __restrict__ part, int nq, int nb, long long n_valid,
                 int qgroups, int slab_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  // a 1-D grid in blockmax's order: the query tiles of a slab run together,
  // so the slab's rows come from device memory once
  const int qtiles = (nq + QG * qgroups - 1) / (QG * qgroups);
  const int id = blockIdx.x;
  blockmax_body<T, false>(smem, q, db, nullptr, nullptr, scales, bm, nq, nb, n_valid,
                          qgroups, slab_blocks, id % qtiles, id / qtiles,
                          SBM ? part : nullptr);
}

template <class T, bool SBM>
cudaError_t launch_slab_sbm(const void* q, const void* db, const float* scales, float* bm,
                            float* part, int nq, int nb, long long n_valid, int qgroups,
                            int slab_blocks, cudaStream_t stream) {
  const size_t smem = blockmax_smem<T>();
  cudaError_t err = allow_smem(slab_scan_kernel<T, SBM>, smem);
  if (err != cudaSuccess) return err;
  const int qt = QG * qgroups;
  const long long ctas = (long long)((nq + qt - 1) / qt) * (nb / slab_blocks);
  if (ctas <= 0 || ctas > INT_MAX) return cudaErrorInvalidValue;
  using In = typename T::In;
  slab_scan_kernel<T, SBM><<<(unsigned)ctas, THREADS, smem, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(db), scales, bm, part, nq, nb,
      n_valid, qgroups, slab_blocks);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_slab(int nslab, const void* q, const void* db, const float* scales,
                        float* bm, float* part, int nq, int nb, long long n_valid,
                        int qgroups, int tile_blocks, cudaStream_t s) {
  if (nslab != 1 && nslab != 2 && nslab != 4 && nslab != 8) return cudaErrorInvalidValue;
  if (qgroups != 1 && qgroups != 2 && qgroups != 4 && qgroups != 8)
    return cudaErrorInvalidValue;
  if (tile_blocks % nslab || nb % tile_blocks) return cudaErrorInvalidValue;
  if (part != nullptr)
    return launch_slab_sbm<T, true>(q, db, scales, bm, part, nq, nb, n_valid, qgroups,
                                    tile_blocks / nslab, s);
  return launch_slab_sbm<T, false>(q, db, scales, bm, part, nq, nb, n_valid, qgroups,
                                   tile_blocks / nslab, s);
}

}  // namespace mst

// dtype: 0 = bf16 (scales null), 1 = int8 (scales [Npad] required). nslab:
// 1, 2, 4 or 8, dividing tile_blocks (= tile / 128), which divides nb.
// qgroups: 1, 2, 4 or 8 (a query tile of 32 * qgroups queries).
// bm [nq, nb]; part [nq, nb / tile_blocks * nslab], or null for BM alone.
extern "C" int mst_slab_scan(int dtype, int nslab, const void* q, const void* db,
                             const void* scales, void* bm, void* part, int nq, int nb,
                             long long n_valid, int qgroups, int tile_blocks,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scales);
  auto b = static_cast<float*>(bm);
  auto p = static_cast<float*>(part);
  if (dtype == 0)
    return mst::launch_slab<mst::Bf16>(nslab, q, db, sc, b, p, nq, nb, n_valid, qgroups,
                                       tile_blocks, s);
  if (dtype == 1)
    return mst::launch_slab<mst::Int8>(nslab, q, db, sc, b, p, nq, nb, n_valid, qgroups,
                                       tile_blocks, s);
  return cudaErrorInvalidValue;
}
