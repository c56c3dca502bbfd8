// The phase-C gather variants: where int8 phase C's time goes (the read of
// the selected blocks, staging them, the dot), and whether wide loads pay.
//
// Replaces two Pallas kernels of the TPU package's measurement tool
// tools/perf_gather_int8.py: `kernel` in `gather_variant` (modes dma_only,
// concat_only, full) and `kernel` in `gather_int32view` (mode int32view).
// Contract, for bidx [Q, KB] int32 (a negative index reads block 0), db
// [NB*128, 128] of one dtype and groups of G selected blocks (KB % G == 0):
// out float32 [Q, KB/G, G, 128], for query i and group j,
//   - dma_only:    the sum in f32 of row 0 of each of the group's G blocks,
//                  in block order (acc = 0; acc + block g for g = 0..G-1),
//                  the same at every g;
//   - concat_only: row 0 of the group's first block, as f32, at every g;
//   - full:        exact scores of query i against all G*128 rows of the
//                  group: int32 dot then f32 (int8), f32 dot (bf16);
//   - int32view:   the int8 DB read as int32 words [NB, 128, 32]: lanes
//                  0..31 the f32 sum, in block order, of the 32 words of
//                  row 0 of each block (rounded: the words are large);
//                  lanes 32..127 are 0. The same at every g.
// `full` is phase C: one CTA a (query, selected column), each running
// gather.cuh's gather_body, the production kernel's body on its grid, with
// a negative index clamped instead of padded, so its scores and its time
// are the production kernel's (score_issue, scan_common.cuh). The query is an argument; the TPU kernel
// captured it from a module global. The DB reaches every mode's kernel as
// a tensor map (only `full` reads through it) and as a pointer.
//
// A TPU BlockSpec moves every whole block whatever the body reads; on a GPU
// only the loads a kernel makes move bytes. So the three reduction modes
// read every byte of every block they are given and XOR all of it, in 32-bit
// words, into `sink` (one atomicXor a CTA): the tests hold the sink against
// the plain version's, so the kernel provably moved what the TPU kernel
// moved (16 KB a block in int8, 32 KB in bf16). dma_only and concat_only
// read each block in 4-byte words (one word a thread a load, consecutive
// threads on consecutive words), int32view in 16-byte int4 loads: the same
// bytes, so the pair of times says whether wide loads pay for int8 phase C.
//
// Grid: one CTA of GTHREADS (128) threads per (query, group), as the TPU
// grid (Q, KB/G); `full`: per (query, column), as phase C. Bound on the H100: bytes, the selected blocks read once
// plus out written, over 3.35 TB/s.
#include <climits>

#include "gather.cuh"

namespace mst {

enum VariantMode { DMA_ONLY = 0, CONCAT_ONLY = 1, FULL = 2, INT32VIEW = 3 };

template <class T, int MODE>
__global__ void __launch_bounds__(GTHREADS)
gather_variant_kernel(const __grid_constant__ CUtensorMap map,
                      const typename T::In* __restrict__ q,
                      const typename T::In* __restrict__ db,
                      const int* __restrict__ bidx, float* __restrict__ out,
                      unsigned* __restrict__ sink, int kb, int g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qi = blockIdx.x, c0 = blockIdx.y * g;
  if constexpr (MODE == FULL) {
    gather_body<T>(smem, map, q, nullptr, nullptr, bidx, nullptr, nullptr, out, kb, LLONG_MAX, qi,
                   blockIdx.y, false);
  } else {
    constexpr int BYTES = BLOCK * DIM * (int)sizeof(typename T::In);  // a block
    __shared__ unsigned warp_xor[GTHREADS / 32];
    const int t = threadIdx.x;
    unsigned x = 0;
    float acc = 0.f;
    for (int gg = 0; gg < g; ++gg) {
      const long long b = max(bidx[(long long)qi * kb + c0 + gg], 0);
      const typename T::In* blk = db + b * BLOCK * DIM;
      if constexpr (MODE == INT32VIEW) {
        const int4* w = reinterpret_cast<const int4*>(blk);
#pragma unroll
        for (int v = 0; v < BYTES / 16 / GTHREADS; ++v) {
          const int4 a = w[v * GTHREADS + t];
          x ^= (unsigned)a.x ^ (unsigned)a.y ^ (unsigned)a.z ^ (unsigned)a.w;
        }
        if (t < DIM / 4) acc = acc + (float)reinterpret_cast<const int*>(blk)[t];
      } else {
        const unsigned* w = reinterpret_cast<const unsigned*>(blk);
#pragma unroll
        for (int v = 0; v < BYTES / 4 / GTHREADS; ++v) x ^= w[v * GTHREADS + t];
        float r0;
        if constexpr (T::IS_INT) r0 = (float)blk[t];
        else r0 = __bfloat162float(blk[t]);
        if (MODE == DMA_ONLY) acc = acc + r0;
        else if (gg == 0) acc = r0;
      }
    }
    for (int gg = 0; gg < g; ++gg)
      out[((long long)qi * kb + c0 + gg) * BLOCK + t] = acc;  // lanes >= 32 of int32view: 0
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, off);
    if ((t & 31) == 0) warp_xor[t >> 5] = x;
    __syncthreads();
    if (t == 0) {
      for (int w = 1; w < GTHREADS / 32; ++w) x ^= warp_xor[w];
      atomicXor(sink, x);
    }
  }
}

template <class T, int MODE>
int launch_variant(const void* q, const void* db, int nb, const int* bidx, float* out,
                   unsigned* sink, int nq, int kb, int g, cudaStream_t stream) {
  if (g <= 0 || kb % g || (MODE == FULL ? kb : kb / g) > 65535) return cudaErrorInvalidValue;
  CUtensorMap map;
  const int rc = db_tensor_map<T>(&map, db, (long long)nb * BLOCK);
  if (rc != 0) return rc;
  const size_t smem = MODE == FULL ? GatherSmem<T>::LAUNCH : 0;
  cudaError_t err = allow_smem(gather_variant_kernel<T, MODE>, smem);
  if (err != cudaSuccess) return err;
  using In = typename T::In;
  const dim3 grid(nq, MODE == FULL ? kb : kb / g);
  gather_variant_kernel<T, MODE><<<grid, GTHREADS, smem, stream>>>(
      map, static_cast<const In*>(q), static_cast<const In*>(db), bidx, out, sink, kb, g);
  return cudaGetLastError();
}

template <class T>
int launch_variant_m(int mode, const void* q, const void* db, int nb, const int* bidx,
                     float* out, unsigned* sink, int nq, int kb, int g, cudaStream_t s) {
  switch (mode) {
    case DMA_ONLY:
      return launch_variant<T, DMA_ONLY>(q, db, nb, bidx, out, sink, nq, kb, g, s);
    case CONCAT_ONLY:
      return launch_variant<T, CONCAT_ONLY>(q, db, nb, bidx, out, sink, nq, kb, g, s);
    case FULL: return launch_variant<T, FULL>(q, db, nb, bidx, out, sink, nq, kb, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mst

// dtype: 0 = bf16, 1 = int8. mode: 0 dma_only, 1 concat_only, 2 full,
// 3 int32view (int8 only). db: nb blocks. out [nq, kb/g, g, 128] f32, every
// entry written; sink one uint32 preset to 0 (unused by full). kb % g == 0.
// Returns 0, a cudaError_t, or mst::ERR_TMAP + the encode's CUresult.
extern "C" int mst_gather_variant(int dtype, int mode, const void* q, const void* db, int nb,
                                  const void* bidx, void* out, void* sink, int nq,
                                  int kb, int g, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto ib = static_cast<const int*>(bidx);
  auto o = static_cast<float*>(out);
  auto k = static_cast<unsigned*>(sink);
  if (dtype == 1 && mode == mst::INT32VIEW)
    return mst::launch_variant<mst::Int8, mst::INT32VIEW>(q, db, nb, ib, o, k, nq, kb, g, s);
  if (dtype == 0)
    return mst::launch_variant_m<mst::Bf16>(mode, q, db, nb, ib, o, k, nq, kb, g, s);
  if (dtype == 1)
    return mst::launch_variant_m<mst::Int8>(mode, q, db, nb, ib, o, k, nq, kb, g, s);
  return cudaErrorInvalidValue;
}
