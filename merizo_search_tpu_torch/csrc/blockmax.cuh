// Phase A of the fused exact top-k scan: per-128-row block maxima of db.q^T.
// (The CTA body; the kernel and its launcher are in blockmax.cu.)
//
// Replaces the Pallas kernel `_bm_kernel` (merizo_search TPU package,
// ops/pallas_scan.py, launched by `blockmax_scan`). Same contract, one flat
// output: BM[q, b] = max over the 128 rows of block b of score(q, row), where
//   - bf16: score is the f32 dot; int8: the int32 dot, and the block max is
//     multiplied by the block's scale (scales are block-uniform, so the
//     int32 max commutes with dequantisation);
//   - with the length channel (tl, qcap non-null), rows with
//     !(tl[row] <= qcap[q]) are masked (-inf, or INT_MASKED for int8), and
//     NaN scores never win the max (fmaxf);
//   - blocks whose first row is >= n_valid become NEG_CAP, and every other
//     maximum is clamped to NEG_CAP from below, so BM is finite.
// There is no superblock output and no split/grouped layout: those were
// layout aids for the TPU's selection code.
//
// Bound on the H100: the DB is read once (bf16 256 B/row), so the floor is
// bytes / 3.35 TB/s; at Q = 256 the dot work would be tensor-core bound only
// with mma/wgmma. This first version computes with CUDA-core FMAs (bf16 ->
// f32 fmaf; int8 -> __dp4a) and is therefore bound by FMA throughput, well above
// the byte floor (PERF.md records both). Design: one CTA takes one tile of
// 64 queries (staged once in shared memory) and walks `blocks_per_cta` DB
// blocks; each block's 128 rows are staged in shared memory with 16-byte
// coalesced loads. Each of the 8 warps owns 8 queries and each lane 4 rows
// (lane, lane+32, +64, +96): a 4x8 register tile of scores, reduced over
// rows in registers and then across the warp with shuffles. Only BM reaches
// device memory.
#pragma once

#include "scan_common.cuh"

namespace mst {

constexpr int QT = 64;        // queries per CTA
constexpr int THREADS = 256;  // 8 warps x 8 queries
constexpr int RPT = 4;        // rows per lane
constexpr int QPW = 8;        // queries per warp

template <class T>
size_t blockmax_smem() {
  return (size_t)(QT + BLOCK) * T::PITCH * sizeof(typename T::Word) +
         (BLOCK + QT) * sizeof(float);
}

// One CTA's work: query tile `qtile` against DB blocks [chunk *
// blocks_per_cta, +blocks_per_cta). Needs THREADS threads and
// blockmax_smem<T>() bytes at `smem`. blockmax_kernel runs it with the CTA's
// grid coordinates; bm_gather.cu runs it from the phase-A part of its grid;
// slab_interleave.cu also passes `part` [nq, nchunks], which gets the max of
// the BM values the CTA wrote for each query (the chunk's superblock max):
// after its walk each warp reads back the BM it wrote. Updating a running
// max in the per-block epilogue instead cost 16-18% of phase A on the H100
// (PERF.md). Callers pass tl/qcap/part as literal nullptr to compile their
// code out.
template <class T>
__device__ __forceinline__ void
blockmax_body(unsigned char* smem, const typename T::In* __restrict__ q,
              const typename T::In* __restrict__ db,
              const float* __restrict__ tl, const float* __restrict__ qcap,
              const float* __restrict__ scales, float* __restrict__ bm,
              int nq, int nb, long long n_valid, int blocks_per_cta, int qtile,
              int chunk, float* __restrict__ part = nullptr) {
  using Word = typename T::Word;
  using Acc = typename T::Acc;
  Word* qs = reinterpret_cast<Word*>(smem);          // [QT][PITCH]
  Word* xs = qs + QT * T::PITCH;                     // [BLOCK][PITCH]
  float* tls = reinterpret_cast<float*>(xs + BLOCK * T::PITCH);  // [BLOCK]
  float* qcs = tls + BLOCK;                          // [QT]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = qtile * QT;
  const bool use_len = tl != nullptr;

  stage_rows<T>(q, q0, nq, QT, qs);
  if (use_len)
    for (int i = threadIdx.x; i < QT; i += THREADS)
      qcs[i] = q0 + i < nq ? qcap[q0 + i] : 0.f;

  const Word* const xr[RPT] = {xs + lane * T::PITCH, xs + (lane + 32) * T::PITCH,
                               xs + (lane + 64) * T::PITCH,
                               xs + (lane + 96) * T::PITCH};
  const Word* const qr[QPW] = {
      qs + (warp * QPW + 0) * T::PITCH, qs + (warp * QPW + 1) * T::PITCH,
      qs + (warp * QPW + 2) * T::PITCH, qs + (warp * QPW + 3) * T::PITCH,
      qs + (warp * QPW + 4) * T::PITCH, qs + (warp * QPW + 5) * T::PITCH,
      qs + (warp * QPW + 6) * T::PITCH, qs + (warp * QPW + 7) * T::PITCH};

  const int b_begin = chunk * blocks_per_cta;
  const int b_end = min(nb, b_begin + blocks_per_cta);
  for (int b = b_begin; b < b_end; ++b) {
    const long long row0 = (long long)b * BLOCK;
    __syncthreads();  // the previous block's rows are no longer read
    stage_rows<T>(db, row0, row0 + BLOCK, BLOCK, xs);
    if (use_len && threadIdx.x < BLOCK) tls[threadIdx.x] = tl[row0 + threadIdx.x];
    __syncthreads();

    Acc acc[RPT][QPW];
    dot_tile<T, RPT, QPW>(acc, xr, qr);

    const float scale = scales != nullptr ? scales[row0] : 1.f;
    const bool blk_valid = row0 < n_valid;
#pragma unroll
    for (int c = 0; c < QPW; ++c) {
      const int qi = warp * QPW + c;
      float m;
      if constexpr (T::IS_INT) {
        int mi = INT_MASKED;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          int v = acc[r][c];
          if (use_len && !(tls[lane + 32 * r] <= qcs[qi])) v = INT_MASKED;
          mi = max(mi, v);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mi = max(mi, __shfl_xor_sync(0xffffffffu, mi, off));
        m = (float)mi * scale;
      } else {
        m = -INFINITY;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          float v = acc[r][c];
          if (use_len && !(tls[lane + 32 * r] <= qcs[qi])) v = -INFINITY;
          m = fmaxf(m, v);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if (lane == 0 && q0 + qi < nq)
        bm[(long long)(q0 + qi) * nb + b] = blk_valid ? fmaxf(m, NEG_CAP) : NEG_CAP;
    }
  }
  if (part != nullptr) {
    __syncwarp();  // lane 0's BM stores are visible to the warp's lanes
    const int nchunks = (nb + blocks_per_cta - 1) / blocks_per_cta;
    for (int c = 0; c < QPW; ++c) {
      const int qi = q0 + warp * QPW + c;
      if (qi >= nq) break;  // the same for every lane of the warp
      float m = -INFINITY;
      for (int b = b_begin + lane; b < b_end; b += 32) m = fmaxf(m, bm[(long long)qi * nb + b]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) part[(long long)qi * nchunks + chunk] = m;
    }
  }
}

}  // namespace mst
