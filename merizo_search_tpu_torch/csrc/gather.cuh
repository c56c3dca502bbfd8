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


// ---------------------------------------------------------------------------
// Block-major phase C: the IVF launches (the probe gather, bf16 or int8, and
// the f32 rerank). The contract is gather_cols's, masks, scale modes and
// layout included; only which CTA computes which output slot changes.
//
// Why: gather_cols runs one CTA per (query, GROUP columns), so a block that
// q queries select is read from device memory q times. The IVF's probed
// clusters are shared by many queries (nprobe 32, Q 256: 81,920 (query,
// block) pairs over 10,240 distinct blocks), so the per-query walk moves
// ~8x the bytes of its bound. Here the selection is first inverted
// (gather.cu: a counting sort of bidx by block, into a CSR from each
// distinct block to its (query, column) slots), then each distinct block
// is staged once and scored against every slot of its list. Bound: each
// distinct block once, plus the [Q, KB*128] output.
//
// Bits: each slot is computed by the arithmetic the per-query kernel uses.
// bf16/int8: mma_rows with the query in N slot qi % 8 of its n-tile; the
// CSR keeps a block's slots in eight lists, one per residue qi % 8, and
// n-tile t takes the t-th slot of each residue list (zeros where a list is
// shorter), so each (row, query) pair meets the tensor core in the N slot
// and K order it has in the per-query kernel and in phase A. f32: the same
// FFMA chain, k = 0..127 in order from zero, with the query in shared
// memory. Which CTA takes which block, and the order of the slots inside a
// list, come from atomics and may change from run to run; the output does
// not.
//
// Design: one CTA a distinct block (and one per 64 slots for the padding
// list, which a mesh shard's probe fills mostly), with
// no ring: the block's cp.async copies are in flight while the CTA loads
// its list offsets and stages its slots (list entry, query cap, scale) in
// shared memory, so the chain of dependent loads before the dot is short
// (block id, offsets, slots, query fragments), and the CTAs resident on an
// SM overlap one another's chains and loads. bf16/int8 score two n-tiles
// (16 slots) a pass, which keeps registers low enough for five (bf16) or
// six (int8) CTAs an SM; the f32 body (70 KB a block) fits three.

constexpr int RES = 8;     // residue classes of the query index: its N slot
constexpr int BB_NT = 2;   // n-tiles a pass of the bf16/int8 body (16 slots)
constexpr int BB_NQ = 4;   // slots a pass of the f32 body (one float4 a thread to stage)
// CTAs an SM the bf16/int8 kernel is built for (its launch bound)
template <class T>
constexpr int BB_CTAS = T::IS_INT ? 6 : 5;

// The inversion's CSR in the workspace (gather.cu builds it). Bucket b < nb
// is block b, bucket nb collects the padding entries (bidx < 0, or >= nb:
// an id outside the DB is floored to NEG_CAP, never read). Bucket b's
// entries of residue r (entry i = q*KB + c has residue q % 8) are
// list[off[9b + r] .. off[9b + r + 1]); a bucket's eight lists are
// contiguous, the buckets in no particular order.
struct ByBlock {
  const int* off;   // [(nb + 1) * 9]
  const int* dist;  // [nb] the distinct selected blocks, hdr[0] of them, in no order
  const int* hdr;
  const int* list;  // [Q * KB]
  int nb;
};

// One slot of a pass, staged in shared memory after the block: entry
// r * BB_NT + j is the (t0 + j)-th slot of residue list r (n-tile t0 + j, N
// slot r), sel = its flat entry q*KB + c (-1 where the list is shorter),
// with qcap[q] and scale_sel[sel].
struct BBMeta {
  int sel;
  float qc, ss;
};

template <class T>
size_t by_block_smem() {
  return (size_t)Slot<T>::BYTES + RES * BB_NT * sizeof(BBMeta);
}

inline size_t by_block_f32_smem() {
  return (size_t)Slot<F32>::BYTES + BB_NQ * DIM * sizeof(float);
}

// NEG_CAP in every row of the padding list's slots j = first, += step
// (GTHREADS threads, one row each).
__device__ __forceinline__ void by_block_padding(float* __restrict__ out, const ByBlock& cs,
                                                 int first, int step) {
  const int lo = cs.off[cs.nb * (RES + 1)], hi = cs.off[cs.nb * (RES + 1) + RES];
  for (int j = lo + first; j < hi; j += step)
    out[(long long)cs.list[j] * BLOCK + threadIdx.x] = NEG_CAP;
}

// Pass t0's slots of the block whose residue lists start at ro (in global
// memory): threads below RES * BB_NT, one an entry. Two dependent loads (the
// list, then the query's cap and scale) for the whole pass, not for each
// slot a lane writes.
__device__ __forceinline__ void by_block_meta(BBMeta* __restrict__ meta,
                                              const int* __restrict__ ro, const ByBlock& cs,
                                              const float* __restrict__ tl,
                                              const float* __restrict__ qcap,
                                              const float* __restrict__ scale_sel, int kb,
                                              int t0) {
  if (threadIdx.x >= RES * BB_NT) return;
  const int r = threadIdx.x / BB_NT, t = t0 + threadIdx.x % BB_NT;
  const int lo = ro[r];
  BBMeta m{-1, 0.f, 1.f};
  if (t < ro[r + 1] - lo) {
    m.sel = cs.list[lo + t];
    if (tl != nullptr) m.qc = qcap[m.sel / kb];
    if (scale_sel != nullptr) m.ss = scale_sel[m.sel];
  }
  meta[threadIdx.x] = m;
}

// bf16/int8: GTHREADS threads; CTA blockIdx.x < nd stages block
// dist[blockIdx.x] once and scores it against every slot of its lists,
// BB_NT n-tiles a pass (warp w: m-tiles 2w and 2w+1); the CTAs past nd
// share the padding list. The block's copies are in flight while its list
// offsets, per-row scales and pass 0's slots load. Needs by_block_smem<T>()
// bytes at `smem`.
template <class T>
__device__ __forceinline__ void
gather_by_block(unsigned char* smem, const typename T::In* __restrict__ q,
                const typename T::In* __restrict__ db, const float* __restrict__ tl,
                const float* __restrict__ qcap, const float* __restrict__ scale_sel,
                const float* __restrict__ scales, float* __restrict__ out, int kb,
                long long n_valid, const ByBlock& cs) {
  const int nd = cs.hdr[0];
  if ((int)blockIdx.x >= nd) {
    by_block_padding(out, cs, (int)blockIdx.x - nd, (int)gridDim.x - nd);
    return;
  }
  const int b = cs.dist[blockIdx.x];
  load_block<T>(smem, db, tl, b);
  cp_async_commit();
  BBMeta* meta = reinterpret_cast<BBMeta*>(smem + Slot<T>::BYTES);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int* ro = cs.off + b * (RES + 1);  // residue r: list[ro[r] .. ro[r + 1])
  int ntiles = 0;
  {
    int prev = ro[0];
#pragma unroll
    for (int r = 1; r <= RES; ++r) {
      const int cur = ro[r];
      ntiles = max(ntiles, cur - prev);
      prev = cur;
    }
  }
  float rs[2][2];  // per-row mode: the scales of this lane's four rows
#pragma unroll
  for (int hm = 0; hm < 2; ++hm)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      rs[hm][e] = scales != nullptr
                      ? scales[(long long)b * BLOCK + (2 * warp + hm) * 16 + g + 8 * e]
                      : 1.f;
  by_block_meta(meta, ro, cs, tl, qcap, scale_sel, kb, 0);
  cp_async_wait<0>();
  __syncthreads();  // the block has landed; pass 0's slots are staged
  const float* tlb = reinterpret_cast<const float*>(smem + Slot<T>::TL);

  for (int t0 = 0; t0 < ntiles; t0 += BB_NT) {
    if (t0 > 0) {
      __syncthreads();  // the last pass has read its slots
      by_block_meta(meta, ro, cs, tl, qcap, scale_sel, kb, t0);
      __syncthreads();
    }
    const int ntv = min(BB_NT, ntiles - t0);
    uint32_t bfrag[BB_NT][T::KSTEPS][2];  // n-tile j, N slot g: residue g's slot
#pragma unroll
    for (int j = 0; j < BB_NT; ++j) {
      const int sel = meta[g * BB_NT + j].sel;
      load_query_frag<T>(bfrag[j], q, max(sel, 0) / kb, sel >= 0);
    }
#pragma unroll
    for (int hm = 0; hm < 2; ++hm) {
      const int mt = 2 * warp + hm;
      typename T::Acc acc[BB_NT][4];
      mma_rows<T, BB_NT>(acc, smem + mt * 16 * Slot<T>::PITCH, bfrag, ntv);
#pragma unroll
      for (int j = 0; j < BB_NT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // C column 2 tig + h: residue 2 tig + h's slot
          const BBMeta m = meta[(2 * tig + h) * BB_NT + j];
          if (j >= ntv || m.sel < 0) continue;
          float* o = out + (long long)m.sel * BLOCK;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = mt * 16 + g + 8 * e;
            const long long row = (long long)b * BLOCK + r;
            float s = (float)acc[j][2 * e + h];
            bool keep = row < n_valid;
            if (tl != nullptr) keep = keep && tlb[r] <= m.qc;
            if (scale_sel != nullptr) s *= m.ss;
            if (scales != nullptr) s *= rs[hm][e];
            o[r] = (keep && s == s) ? s : NEG_CAP;
          }
        }
      }
    }
  }
}

// f32 (the rerank): CTA blockIdx.x < nd stages block dist[blockIdx.x] once;
// thread r holds row r and runs gather_cols_f32's FFMA chain for BB_NQ
// slots at a time (independent chains, each in k order), their queries
// staged in shared memory and read as broadcasts. The CTAs past nd share
// the padding list.
__device__ __forceinline__ void
gather_by_block_f32(unsigned char* smem, const float* __restrict__ q,
                    const float* __restrict__ db, const float* __restrict__ tl,
                    const float* __restrict__ qcap, const float* __restrict__ scale_sel,
                    const float* __restrict__ scales, float* __restrict__ out, int kb,
                    long long n_valid, const ByBlock& cs) {
  using SL = Slot<F32>;
  const int nd = cs.hdr[0];
  if ((int)blockIdx.x >= nd) {
    by_block_padding(out, cs, (int)blockIdx.x - nd, (int)gridDim.x - nd);
    return;
  }
  const int b = cs.dist[blockIdx.x];
  load_block<F32>(smem, db, tl, b);
  cp_async_commit();
  const int lo = cs.off[b * (RES + 1)], hi = cs.off[b * (RES + 1) + RES];
  float* qs = reinterpret_cast<float*>(smem + SL::BYTES);
  const int r = threadIdx.x;
  const long long rowi = (long long)b * BLOCK + r;
  cp_async_wait<0>();
  __syncthreads();
  const bool keep0 = rowi < n_valid;
  const float tlr = tl != nullptr ? reinterpret_cast<const float*>(smem + SL::TL)[r] : 0.f;
  const float4* row = reinterpret_cast<const float4*>(smem + r * SL::PITCH);

  for (int g0 = lo; g0 < hi; g0 += BB_NQ) {
    const int m = min(BB_NQ, hi - g0);
    {  // stage the pass's queries: thread t copies float4 t % 32 of slot t / 32
      const int j = threadIdx.x >> 5, d4 = threadIdx.x & 31;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < m)
        v = reinterpret_cast<const float4*>(q + (long long)(cs.list[g0 + j] / kb) * DIM)[d4];
      reinterpret_cast<float4*>(qs + j * DIM)[d4] = v;
    }
    __syncthreads();
    float s[BB_NQ];
#pragma unroll
    for (int j = 0; j < BB_NQ; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int k4 = 0; k4 < DIM / 4; ++k4) {
      const float4 x = row[k4];
#pragma unroll
      for (int j = 0; j < BB_NQ; ++j) {
        const float4 y = reinterpret_cast<const float4*>(qs + j * DIM)[k4];
        s[j] = fmaf(x.x, y.x, s[j]);
        s[j] = fmaf(x.y, y.y, s[j]);
        s[j] = fmaf(x.z, y.z, s[j]);
        s[j] = fmaf(x.w, y.w, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BB_NQ; ++j) {
      if (j >= m) continue;
      const int sel = cs.list[g0 + j];
      bool keep = keep0;
      if (tl != nullptr) keep = keep && tlr <= qcap[sel / kb];
      float v = s[j];
      if (scale_sel != nullptr) v *= scale_sel[sel];
      if (scales != nullptr) v *= scales[rowi];
      out[(long long)sel * BLOCK + r] = (keep && v == v) ? v : NEG_CAP;
    }
    __syncthreads();  // the next pass rewrites qs
  }
}

}  // namespace mst
