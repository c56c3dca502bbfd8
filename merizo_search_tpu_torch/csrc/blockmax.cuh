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
// bytes / 3.35 TB/s; the dot (2*Q*128 operations a row) reaches that line
// at Q ~ 300 in bf16 on the tensor cores. Design: every score comes from
// scan_common.cuh's `mma_rows` (mma.sync on tensor cores). A CTA of 8 warps
// takes a query tile of 32 * qgroups queries (qgroups 1, 2, 4 or 8, sized to
// the batch by the wrapper): each warp holds the B fragments of 32 queries
// (four n-tiles) in registers for its whole walk, and the 8/qgroups warps of
// a query group split a block's 8 m-tiles between them. The CTA walks a
// contiguous range of blocks through a ring of Traits::STAGES slots filled
// by cp.async, so the next blocks are in flight while one is multiplied.
// A block's max is reduced on the accumulator fragments (a thread's two
// rows, then shuffles over the 8 row groups), the warps of a group meet in a
// small shared buffer, and one thread a query stores BM after the next
// block's barrier. Only BM reaches device memory.
#pragma once

#include "scan_common.cuh"

namespace mst {

constexpr int THREADS = 256;  // 8 warps
constexpr int QG = 32;        // queries a warp holds (four n-tiles of 8)

template <class T>
size_t blockmax_smem() {
  return (size_t)T::STAGES * Slot<T>::BYTES + 2 * (THREADS / 32) * QG * sizeof(float);
}

// One CTA's work: the query tile `qtile` (32 * qgroups queries) against DB
// blocks [chunk * blocks_per_cta, +blocks_per_cta). Needs THREADS threads
// and blockmax_smem<T>() bytes at `smem`. LEN compiles the length channel
// (tl, qcap) in. blockmax_kernel runs it with the CTA's grid coordinates;
// bm_gather.cu runs it from the phase-A part of its grid; slab_interleave.cu
// also passes `part` [nq, nchunks], which gets the max of the BM values the
// CTA wrote for each query (the chunk's superblock max), kept in a register
// by the thread that stores that query's BM. Callers without it pass a
// literal nullptr.
template <class T, bool LEN>
__device__ __forceinline__ void
blockmax_body(unsigned char* smem, const typename T::In* __restrict__ q,
              const typename T::In* __restrict__ db,
              const float* __restrict__ tl, const float* __restrict__ qcap,
              const float* __restrict__ scales, float* __restrict__ bm,
              int nq, int nb, long long n_valid, int qgroups, int blocks_per_cta,
              int qtile, int chunk, float* __restrict__ part = nullptr) {
  using Acc = typename T::Acc;
  constexpr int S = T::STAGES;
  Acc* red = reinterpret_cast<Acc*>(smem + S * Slot<T>::BYTES);  // [2][8 warps][QG]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wpg = (THREADS / 32) / qgroups;    // warps a query group
  const int grp = warp / wpg;
  const int mt0 = (warp % wpg) * qgroups;      // this warp's first m-tile
  const int qt = QG * qgroups;                 // queries in the tile
  const int q0 = qtile * qt, qbase = q0 + grp * QG;
  const int ntv = max(0, min(4, (nq - qbase + 7) / 8));  // n-tiles with queries

  uint32_t bfrag[4][T::KSTEPS][2];
  float qc[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qi = qbase + j * 8 + g;
    load_query_frag<T>(bfrag[j], q, qi, qi < nq);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int qj = qbase + j * 8 + tig * 2 + c;
      qc[j][c] = LEN && qj < nq ? qcap[qj] : 0.f;
    }
  }

  const int b_begin = chunk * blocks_per_cta;
  const int nblk = max(0, min(nb, b_begin + blocks_per_cta) - b_begin);
  const float* tls = LEN ? tl : nullptr;

  // BM of block b from the group partials in red[par]: one thread a query,
  // which also keeps the max of what it stores for `part`
  float pmax = -INFINITY;
  auto finish = [&](int b, int par) {
    const int t = threadIdx.x;
    if (t >= qt || q0 + t >= nq) return;
    const Acc* r = red + (par * (THREADS / 32) + (t / QG) * wpg) * QG + t % QG;
    Acc m = r[0];
    for (int k = 1; k < wpg; ++k) {
      if constexpr (T::IS_INT) m = max(m, r[k * QG]);
      else m = fmaxf(m, r[k * QG]);
    }
    float v;
    if constexpr (T::IS_INT) v = (float)m * scales[(long long)b * BLOCK];
    else v = m;
    v = (long long)b * BLOCK < n_valid ? fmaxf(v, NEG_CAP) : NEG_CAP;
    bm[(long long)(q0 + t) * nb + b] = v;
    if (part != nullptr) pmax = fmaxf(pmax, v);
  };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < nblk) load_block<T>(smem + st * Slot<T>::BYTES, db, tls, b_begin + st);
    cp_async_commit();
  }
  for (int i = 0; i < nblk; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // block i has landed; slot (i-1) % S and red[(i-1)&1] are free
    if (i > 0) finish(b_begin + i - 1, (i - 1) & 1);
    if (i + S - 1 < nblk)
      load_block<T>(smem + ((i + S - 1) % S) * Slot<T>::BYTES, db, tls, b_begin + i + S - 1);
    cp_async_commit();

    const unsigned char* slot = smem + (i % S) * Slot<T>::BYTES;
    const float* tlb = reinterpret_cast<const float*>(slot + Slot<T>::TL);
    Acc run[4][2];
    Acc lowest;
    if constexpr (T::IS_INT) lowest = INT_MASKED; else lowest = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) run[j][0] = run[j][1] = lowest;
#pragma unroll 1
    for (int mt = mt0; mt < mt0 + qgroups; ++mt) {
      Acc acc[4][4];
      mma_rows<T, 4>(acc, slot + mt * 16 * Slot<T>::PITCH, bfrag, ntv);
      float t0 = 0.f, t1 = 0.f;
      if constexpr (LEN) t0 = tlb[mt * 16 + g], t1 = tlb[mt * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          Acc v0 = acc[j][c], v1 = acc[j][2 + c];
          if constexpr (T::IS_INT) {
            if (LEN && !(t0 <= qc[j][c])) v0 = INT_MASKED;
            if (LEN && !(t1 <= qc[j][c])) v1 = INT_MASKED;
            run[j][c] = max(run[j][c], max(v0, v1));
          } else {
            if (LEN && !(t0 <= qc[j][c])) v0 = -INFINITY;
            if (LEN && !(t1 <= qc[j][c])) v1 = -INFINITY;
            run[j][c] = fmaxf(run[j][c], fmaxf(v0, v1));
          }
        }
    }
    // over the 8 row groups (lane bits 2-4); lanes 0-3 then hold columns
    // j*8 + lane*2 + c of the warp's 32 queries
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const Acc o = __shfl_xor_sync(0xffffffffu, run[j][c], off);
          if constexpr (T::IS_INT) run[j][c] = max(run[j][c], o);
          else run[j][c] = fmaxf(run[j][c], o);
        }
    if (g == 0) {
      Acc* r = red + ((i & 1) * (THREADS / 32) + warp) * QG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j * 8 + tig * 2] = run[j][0];
        r[j * 8 + tig * 2 + 1] = run[j][1];
      }
    }
  }
  __syncthreads();
  if (nblk > 0) finish(b_begin + nblk - 1, (nblk - 1) & 1);
  if (part != nullptr && threadIdx.x < qt && q0 + threadIdx.x < nq)
    part[(long long)(q0 + threadIdx.x) * ((nb + blocks_per_cta - 1) / blocks_per_cta) + chunk] =
        pmax;
}

}  // namespace mst
