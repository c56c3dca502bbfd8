// Phase C of the fused exact top-k scan: rescore the selected 128-row blocks.
// (The CTA body; the kernel and its launcher are in gather.cu.)
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
#pragma once

#include "scan_common.cuh"

namespace mst {

constexpr int GTHREADS = BLOCK;  // one thread per row of a block
constexpr int GROUP = 4;         // selected blocks per CTA

template <class T>
size_t gather_smem() {
  return (size_t)(1 + BLOCK) * T::PITCH * sizeof(typename T::Word);
}

// One CTA's work: query `qi` against its selected columns [group * GROUP,
// +GROUP). Needs at least GTHREADS threads (threads past the 128th help
// stage rows and score none) and gather_smem<T>() bytes at `smem`.
// gather_kernel runs it with the CTA's grid coordinates; bm_gather.cu runs
// it from the phase-C part of its grid.
template <class T>
__device__ __forceinline__ void
gather_body(unsigned char* smem, const typename T::In* __restrict__ q,
            const typename T::In* __restrict__ db,
            const float* __restrict__ tl, const float* __restrict__ qcap,
            const int* __restrict__ bidx, const float* __restrict__ scale_sel,
            const float* __restrict__ scales, float* __restrict__ out, int kb,
            long long n_valid, int qi, int group) {
  using Word = typename T::Word;
  Word* qs = reinterpret_cast<Word*>(smem);  // [1][PITCH]
  Word* xs = qs + T::PITCH;                  // [BLOCK][PITCH]

  const int r = threadIdx.x;
  stage_rows<T>(q, qi, qi + 1, 1, qs);
  const float qc = tl != nullptr ? qcap[qi] : 0.f;
  const Word* const xr[1] = {xs + r * T::PITCH};  // read only if r < BLOCK
  const Word* const qr[1] = {qs};

  const int c_end = min(kb, (group + 1) * GROUP);
  for (int c = group * GROUP; c < c_end; ++c) {
    const long long sel = (long long)qi * kb + c;
    const int b = bidx[sel];
    const long long base = (long long)max(b, 0) * BLOCK;
    __syncthreads();  // the previous block's rows are no longer read
    stage_rows<T>(db, base, base + BLOCK, BLOCK, xs);
    __syncthreads();
    if (r >= BLOCK) continue;

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

}  // namespace mst
