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
// The f32 mode (at the end of this file) has a body of its own on the CUDA
// cores, with the same masks and layout.
// out[q, col*128 + r] is the score of row bidx[q, col]*128 + r, or NEG_CAP
// where bidx is -1 (padding), the row is >= n_valid, the length channel
// masks it (!(tl[row] <= qcap[q])), or the score is NaN.
//
// Each score comes from the same `mma_rows` as phase A's (scan_common.cuh),
// with the query in the N slot it has in phase A (qi % 8) and zeros in the
// other seven: the tensor core sees each (row, query) pair in the same
// position, with the same K order, so a row scores the same float in both
// phases, and int8 scaling is the same f32 multiply of the same integer.
//
// Bound on the H100: each selected block is 32 KB (bf16) of scattered but
// contiguous reads, plus the [Q, KB*128] f32 output; at KB ~ k+2 the kernel
// moves a few MB per batch and is bound by bytes and launch latency; on
// tensor cores the dot no longer counts. Design: one CTA per (query, group
// of GROUP selected columns); the CTA reads its own bidx entries and walks
// its columns through a ring of Traits::GSTAGES slots filled by cp.async
// (the next column in flight while one is scored; two slots, not phase A's
// three, so that more CTAs fit an SM); warp w < 4 scores
// m-tiles 2w and 2w+1, and the 8 lanes that hold the query's N slot write
// the scores.
#pragma once

#include "scan_common.cuh"

namespace mst {

constexpr int GTHREADS = BLOCK;  // 4 warps
constexpr int GROUP = 4;         // selected blocks per CTA

template <class T>
size_t gather_smem() {
  return (size_t)T::GSTAGES * Slot<T>::BYTES;
}

// Query `qi` against its selected columns [c_begin, c_end). Needs at least
// GTHREADS threads (warps past the 4th help stage rows and score none) and
// gather_smem<T>() bytes at `smem`. With pad_neg, bidx -1 is padding
// (NEG_CAP, nothing read); without, a negative index scores block 0, as the
// TPU gather variants clamp it (gather_variants.cu).
template <class T>
__device__ __forceinline__ void
gather_cols(unsigned char* smem, const typename T::In* __restrict__ q,
            const typename T::In* __restrict__ db,
            const float* __restrict__ tl, const float* __restrict__ qcap,
            const int* __restrict__ bidx, const float* __restrict__ scale_sel,
            const float* __restrict__ scales, float* __restrict__ out, int kb,
            long long n_valid, int qi, int c_begin, int c_end, bool pad_neg) {
  constexpr int S = T::GSTAGES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int slot_n = qi % 8;                 // the query's N slot in phase A
  uint32_t bfrag[1][T::KSTEPS][2];
  load_query_frag<T>(bfrag[0], q, qi, g == slot_n);
  const float qc = tl != nullptr ? qcap[qi] : 0.f;
  const int ncol = max(0, c_end - c_begin);
  auto block_of = [&](int c) {  // block id of column c, or -1 for padding
    const int b = bidx[(long long)qi * kb + c];
    return b < 0 ? (pad_neg ? -1 : 0) : b;
  };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < ncol) {
      const int b = block_of(c_begin + st);
      if (b >= 0) load_block<T>(smem + st * Slot<T>::BYTES, db, tl, b);
    }
    cp_async_commit();
  }
  for (int i = 0; i < ncol; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // column i has landed; slot (i-1) % S is free
    if (i + S - 1 < ncol) {
      const int b = block_of(c_begin + i + S - 1);
      if (b >= 0) load_block<T>(smem + ((i + S - 1) % S) * Slot<T>::BYTES, db, tl, b);
    }
    cp_async_commit();

    const long long sel = (long long)qi * kb + c_begin + i;
    const int b = block_of(c_begin + i);
    float* o = out + sel * BLOCK;
    if (b < 0) {
      if (threadIdx.x < BLOCK) o[threadIdx.x] = NEG_CAP;
      continue;
    }
    if (warp >= 4) continue;
    const unsigned char* slot = smem + (i % S) * Slot<T>::BYTES;
    const float* tlb = reinterpret_cast<const float*>(slot + Slot<T>::TL);
    const float ss = scale_sel != nullptr ? scale_sel[sel] : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mt = 2 * warp + h;
      typename T::Acc acc[1][4];
      mma_rows<T, 1>(acc, slot + mt * 16 * Slot<T>::PITCH, bfrag, 1);
      if (tig != slot_n / 2) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = mt * 16 + g + 8 * e;
        const long long row = (long long)b * BLOCK + r;
        float s = (float)acc[0][2 * e + slot_n % 2];
        bool keep = row < n_valid;
        if (tl != nullptr) keep = keep && tlb[r] <= qc;
        if (scale_sel != nullptr) s *= ss;
        if (scales != nullptr) s *= scales[row];
        o[r] = (keep && s == s) ? s : NEG_CAP;
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight when the CTA's shared memory is reused
}

// One CTA's work: query `qi` against its selected columns [group * GROUP,
// +GROUP). gather_kernel runs it with the CTA's grid coordinates;
// bm_gather.cu runs it from the phase-C part of its grid.
template <class T>
__device__ __forceinline__ void
gather_body(unsigned char* smem, const typename T::In* __restrict__ q,
            const typename T::In* __restrict__ db,
            const float* __restrict__ tl, const float* __restrict__ qcap,
            const int* __restrict__ bidx, const float* __restrict__ scale_sel,
            const float* __restrict__ scales, float* __restrict__ out, int kb,
            long long n_valid, int qi, int group) {
  gather_cols<T>(smem, q, db, tl, qcap, bidx, scale_sel, scales, out, kb, n_valid,
                 qi, group * GROUP, min(kb, (group + 1) * GROUP), true);
}

// ---------------------------------------------------------------------------
// Phase C on f32 rows: the mode of the TPU kernel in `gather_block_scores_dma`
// that the JAX package's IVF rerank runs on its f32 sidecar (search/ivf.py
// `_rerank_blocks`: the top-(k+1) probed blocks rescored exactly in f32).
// The contract is gather_cols's, masks and layout included; only the dot
// differs. Tensor cores would take f32 only as TF32, which keeps ~3 decimal
// digits, so the score is a plain FFMA chain on the CUDA cores: the query in
// shared memory, one row per thread, k = 0..127 in order from a zero
// accumulator (a fixed order, so a row scores the same float wherever it
// lies). A row is 128 FMAs on 512 bytes (0.5 FLOP a byte), so the 64 KB of
// each selected block, scattered but contiguous, bound it by bytes.
//
// Design: one CTA of 128 threads per (query, GROUP columns), as the bf16 and
// int8 modes; blocks staged by cp.async into a ring of two Slot<F32> slots
// (pitch 528 bytes: the eight 16-byte loads of a quarter-warp at the same k
// fall in distinct bank groups), one block in flight while one is scored.
// Two 68 KB slots leave one CTA an SM.
struct F32 {
  using In = float;
  static constexpr int GSTAGES = 2;
};

inline size_t gather_f32_smem() {
  return (size_t)F32::GSTAGES * Slot<F32>::BYTES + DIM * sizeof(float);
}

__device__ __forceinline__ void
gather_cols_f32(unsigned char* smem, const float* __restrict__ q,
                const float* __restrict__ db, const float* __restrict__ tl,
                const float* __restrict__ qcap, const int* __restrict__ bidx,
                const float* __restrict__ scale_sel, const float* __restrict__ scales,
                float* __restrict__ out, int kb, long long n_valid, int qi,
                int c_begin, int c_end) {
  constexpr int S = F32::GSTAGES;
  using SL = Slot<F32>;
  float* qs = reinterpret_cast<float*>(smem + S * SL::BYTES);
  for (int d = threadIdx.x; d < DIM; d += blockDim.x) qs[d] = q[(long long)qi * DIM + d];
  const float qc = tl != nullptr ? qcap[qi] : 0.f;
  const int ncol = max(0, c_end - c_begin);
  auto block_of = [&](int c) { return bidx[(long long)qi * kb + c]; };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < ncol) {
      const int b = block_of(c_begin + st);
      if (b >= 0) load_block<F32>(smem + st * SL::BYTES, db, tl, b);
    }
    cp_async_commit();
  }
  for (int i = 0; i < ncol; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // column i has landed (and qs is written); slot (i-1) % S is free
    if (i + S - 1 < ncol) {
      const int b = block_of(c_begin + i + S - 1);
      if (b >= 0) load_block<F32>(smem + ((i + S - 1) % S) * SL::BYTES, db, tl, b);
    }
    cp_async_commit();

    const long long sel = (long long)qi * kb + c_begin + i;
    const int b = block_of(c_begin + i);
    float* o = out + sel * BLOCK;
    const int r = threadIdx.x;
    if (r >= BLOCK) continue;
    if (b < 0) {
      o[r] = NEG_CAP;
      continue;
    }
    const unsigned char* slot = smem + (i % S) * SL::BYTES;
    const float4* row = reinterpret_cast<const float4*>(slot + r * SL::PITCH);
    float s = 0.f;
#pragma unroll 8
    for (int k4 = 0; k4 < DIM / 4; ++k4) {
      const float4 x = row[k4];
      s = fmaf(x.x, qs[4 * k4], s);
      s = fmaf(x.y, qs[4 * k4 + 1], s);
      s = fmaf(x.z, qs[4 * k4 + 2], s);
      s = fmaf(x.w, qs[4 * k4 + 3], s);
    }
    const long long rowi = (long long)b * BLOCK + r;
    bool keep = rowi < n_valid;
    if (tl != nullptr) keep = keep && reinterpret_cast<const float*>(slot + SL::TL)[r] <= qc;
    if (scale_sel != nullptr) s *= scale_sel[sel];
    if (scales != nullptr) s *= scales[rowi];
    o[r] = (keep && s == s) ? s : NEG_CAP;
  }
  cp_async_wait<0>();
}

}  // namespace mst
