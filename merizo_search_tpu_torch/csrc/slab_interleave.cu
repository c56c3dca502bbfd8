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
// each warp's FMAs and its shuffle reduce already interleave block by
// block, and the warp schedulers overlap warps. Here nslab sets the work of
// one CTA instead: a CTA takes one 64-query tile and one slab (tile/NSLAB
// rows), so nslab sets how many CTAs share a tile, how many blocks each
// walks after staging its queries once, and how many partial maxima a tile
// has. NSLAB is a template argument (1, 2, 4, 8); the outputs do not depend
// on it.
//
// The CTA body is blockmax.cuh's, with the length channel's pointers passed
// as literal nulls (compiled out, not tested at run time) and the optional
// `part` output on. So every score comes from dot_tile and BM equals
// blockmax_scan's with the channel off bit for bit, for every nslab.
//
// Bound on the H100: bytes, the DB read once (bf16 4 GiB at 2^24 rows: 1.3
// ms at 3.35 TB/s); like phase A it computes on CUDA cores (fmaf / __dp4a),
// so FMA throughput bounds it far above that floor.
#include <climits>

#include "blockmax.cuh"

namespace mst {

template <class T, int NSLAB, bool SBM>
__global__ void __launch_bounds__(THREADS, 2)
slab_scan_kernel(const typename T::In* __restrict__ q,
                 const typename T::In* __restrict__ db,
                 const float* __restrict__ scales, float* __restrict__ bm,
                 float* __restrict__ part, int nq, int nb, long long n_valid,
                 int tile_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  // a 1-D grid in blockmax's order: the query tiles of a slab run together,
  // so the slab's rows come from device memory once
  const int qtiles = (nq + QT - 1) / QT;
  const int id = blockIdx.x;
  blockmax_body<T>(smem, q, db, nullptr, nullptr, scales, bm, nq, nb, n_valid,
                   tile_blocks / NSLAB, id % qtiles, id / qtiles, SBM ? part : nullptr);
}

template <class T, int NSLAB, bool SBM>
cudaError_t launch_slab_sbm(const void* q, const void* db, const float* scales, float* bm,
                            float* part, int nq, int nb, long long n_valid,
                            int tile_blocks, cudaStream_t stream) {
  const size_t smem = blockmax_smem<T>();
  cudaError_t err = allow_smem(slab_scan_kernel<T, NSLAB, SBM>, smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((nq + QT - 1) / QT) * (nb / (tile_blocks / NSLAB));
  if (ctas <= 0 || ctas > INT_MAX) return cudaErrorInvalidValue;
  using In = typename T::In;
  slab_scan_kernel<T, NSLAB, SBM><<<(unsigned)ctas, THREADS, smem, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(db), scales, bm, part, nq, nb,
      n_valid, tile_blocks);
  return cudaGetLastError();
}

template <class T, int NSLAB>
cudaError_t launch_slab(const void* q, const void* db, const float* scales, float* bm,
                        float* part, int nq, int nb, long long n_valid,
                        int tile_blocks, cudaStream_t stream) {
  if (tile_blocks % NSLAB || nb % tile_blocks) return cudaErrorInvalidValue;
  if (part != nullptr)
    return launch_slab_sbm<T, NSLAB, true>(q, db, scales, bm, part, nq, nb, n_valid,
                                           tile_blocks, stream);
  return launch_slab_sbm<T, NSLAB, false>(q, db, scales, bm, part, nq, nb, n_valid,
                                          tile_blocks, stream);
}

template <class T>
cudaError_t launch_slab_n(int nslab, const void* q, const void* db, const float* scales,
                          float* bm, float* part, int nq, int nb, long long n_valid,
                          int tile_blocks, cudaStream_t s) {
  switch (nslab) {
    case 1: return launch_slab<T, 1>(q, db, scales, bm, part, nq, nb, n_valid, tile_blocks, s);
    case 2: return launch_slab<T, 2>(q, db, scales, bm, part, nq, nb, n_valid, tile_blocks, s);
    case 4: return launch_slab<T, 4>(q, db, scales, bm, part, nq, nb, n_valid, tile_blocks, s);
    case 8: return launch_slab<T, 8>(q, db, scales, bm, part, nq, nb, n_valid, tile_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mst

// dtype: 0 = bf16 (scales null), 1 = int8 (scales [Npad] required). nslab:
// 1, 2, 4 or 8, dividing tile_blocks (= tile / 128), which divides nb.
// bm [nq, nb]; part [nq, nb / tile_blocks * nslab], or null for BM alone.
extern "C" int mst_slab_scan(int dtype, int nslab, const void* q, const void* db,
                             const void* scales, void* bm, void* part, int nq, int nb,
                             long long n_valid, int tile_blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scales);
  auto b = static_cast<float*>(bm);
  auto p = static_cast<float*>(part);
  if (dtype == 0)
    return mst::launch_slab_n<mst::Bf16>(nslab, q, db, sc, b, p, nq, nb, n_valid,
                                         tile_blocks, s);
  if (dtype == 1)
    return mst::launch_slab_n<mst::Int8>(nslab, q, db, sc, b, p, nq, nb, n_valid,
                                         tile_blocks, s);
  return cudaErrorInvalidValue;
}
