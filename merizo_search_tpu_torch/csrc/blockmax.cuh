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
//
// The walk (`walk_blocks`) is shared: it calls an epilogue object's hooks
// around the scores of each block, and phase A, bm_gather.cu,
// slab_interleave.cu and probes.cu's mini_scan differ only in that object.
// Phase A's (`BlockMaxEpi`) reduces a block's max on the accumulator
// fragments (a thread's two rows, then shuffles over the 8 row groups), the
// warps of a group meet in a small shared buffer, and one thread a query
// hands the max to a store policy after the next block's barrier: `BmStore`
// scales it, floors it at NEG_CAP and writes BM. Only BM reaches device
// memory.
#pragma once

#include "scan_common.cuh"

namespace mst {

constexpr int THREADS = 256;  // 8 warps
constexpr int QG = 32;        // queries a warp holds (four n-tiles of 8)

template <class T>
size_t blockmax_smem() {
  return (size_t)T::STAGES * Slot<T>::BYTES + 2 * (THREADS / 32) * QG * sizeof(float);
}

// Where a thread sits in a CTA of the walk: the query tile `qtile` (32 *
// qgroups queries) against DB blocks [chunk * blocks_per_cta,
// +blocks_per_cta) of nb.
struct WalkPos {
  int g, tig, warp;
  int wpg;           // warps a query group
  int mt0, mts;      // this warp's first m-tile and its count (= qgroups)
  int qt, q0, qbase; // queries in the tile, the tile's first, the warp's first
  int ntv;           // the warp's n-tiles with queries
  int b_begin, nblk; // the CTA's first block and its count
  __device__ __forceinline__ WalkPos(int nq, int nb, int qgroups, int blocks_per_cta,
                                     int qtile, int chunk) {
    const int lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    g = lane >> 2;
    tig = lane & 3;
    wpg = (THREADS / 32) / qgroups;
    mt0 = (warp % wpg) * qgroups;
    mts = qgroups;
    qt = QG * qgroups;
    q0 = qtile * qt;
    qbase = q0 + (warp / wpg) * QG;
    ntv = max(0, min(4, (nq - qbase + 7) / 8));
    b_begin = chunk * blocks_per_cta;
    nblk = max(0, min(nb, b_begin + blocks_per_cta) - b_begin);
  }
};

// The walk of one CTA (THREADS threads, blockmax_smem<T>() bytes at smem):
// load the warp's query fragments once, then for each block of the range
// take every score of the warp's m-tiles from mma_rows, through the ring.
// The epilogue `epi` sees, in order: begin_block(b) before block b's first
// m-tile; tile(mt, acc, slot) with m-tile mt's scores (acc as mma_rows
// fills it) and the block's ring slot; end_block(i & 1) after block i's
// last m-tile; and after_block(b, (i & 1)) for block i = b - b_begin right
// after the next block's barrier (or the final one), when whatever
// end_block wrote to shared memory is visible to every thread. LEN stages
// the length channel's tl values beside the rows.
template <class T, bool LEN, class Epi>
__device__ __forceinline__ void walk_blocks(unsigned char* smem, const WalkPos& p,
                                            const typename T::In* __restrict__ q,
                                            const typename T::In* __restrict__ db,
                                            const float* __restrict__ tl, int nq, Epi& epi) {
  constexpr int S = T::STAGES;
  uint32_t bfrag[4][T::KSTEPS][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qi = p.qbase + j * 8 + p.g;
    load_query_frag<T>(bfrag[j], q, qi, qi < nq);
  }
  const float* tls = LEN ? tl : nullptr;

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < p.nblk) load_block<T>(smem + st * Slot<T>::BYTES, db, tls, p.b_begin + st);
    cp_async_commit();
  }
  for (int i = 0; i < p.nblk; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // block i has landed; slot (i-1) % S and epilogue buffer (i-1)&1 are free
    if (i > 0) epi.after_block(p.b_begin + i - 1, (i - 1) & 1);
    if (i + S - 1 < p.nblk)
      load_block<T>(smem + ((i + S - 1) % S) * Slot<T>::BYTES, db, tls, p.b_begin + i + S - 1);
    cp_async_commit();

    const unsigned char* slot = smem + (i % S) * Slot<T>::BYTES;
    epi.begin_block(p.b_begin + i);
#pragma unroll 1
    for (int mt = p.mt0; mt < p.mt0 + p.mts; ++mt) {
      typename T::Acc acc[4][4];
      mma_rows<T, 4>(acc, slot + mt * 16 * Slot<T>::PITCH, bfrag, p.ntv);
      epi.tile(mt, acc, slot);
    }
    epi.end_block(i & 1);
  }
  __syncthreads();
  if (p.nblk > 0) epi.after_block(p.b_begin + p.nblk - 1, (p.nblk - 1) & 1);
}

// Phase A's epilogue: each block's max for each of the tile's queries,
// handed to `store.put(b, qi, max)` by one thread a query (threads 0 ..
// qt-1, queries q0 + t < nq). With LEN, rows whose tl (staged in the slot)
// exceeds the query's qcap are masked first.
template <class T, bool LEN, class Store>
struct BlockMaxEpi {
  using Acc = typename T::Acc;
  const WalkPos& p;
  Store& store;
  Acc* red;          // [2][8 warps][QG], after the ring
  int nq;
  float qc[4][2];    // qcap of the thread's columns (LEN)
  Acc run[4][2];     // the block's max of the thread's columns

  __device__ __forceinline__ BlockMaxEpi(const WalkPos& pos, Store& st, unsigned char* smem,
                                         const float* __restrict__ qcap, int nq_)
      : p(pos), store(st),
        red(reinterpret_cast<Acc*>(smem + T::STAGES * Slot<T>::BYTES)), nq(nq_) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qj = p.qbase + j * 8 + p.tig * 2 + c;
        qc[j][c] = LEN && qj < nq ? qcap[qj] : 0.f;
      }
  }

  __device__ __forceinline__ void begin_block(int) {
    Acc lowest;
    if constexpr (T::IS_INT) lowest = INT_MASKED; else lowest = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) run[j][0] = run[j][1] = lowest;
  }

  __device__ __forceinline__ void tile(int mt, const Acc (&acc)[4][4],
                                       const unsigned char* slot) {
    const float* tlb = reinterpret_cast<const float*>(slot + Slot<T>::TL);
    float t0 = 0.f, t1 = 0.f;
    if constexpr (LEN) t0 = tlb[mt * 16 + p.g], t1 = tlb[mt * 16 + p.g + 8];
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
  // j*8 + lane*2 + c of the warp's 32 queries, which go to red[par]
  __device__ __forceinline__ void end_block(int par) {
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
    if (p.g == 0) {
      Acc* r = red + (par * (THREADS / 32) + p.warp) * QG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j * 8 + p.tig * 2] = run[j][0];
        r[j * 8 + p.tig * 2 + 1] = run[j][1];
      }
    }
  }

  // block b's max from the group partials in red[par]: one thread a query
  __device__ __forceinline__ void after_block(int b, int par) {
    const int t = threadIdx.x;
    if (t >= p.qt || p.q0 + t >= nq) return;
    const Acc* r = red + (par * (THREADS / 32) + (t / QG) * p.wpg) * QG + t % QG;
    Acc m = r[0];
    for (int k = 1; k < p.wpg; ++k) {
      if constexpr (T::IS_INT) m = max(m, r[k * QG]);
      else m = fmaxf(m, r[k * QG]);
    }
    store.put(b, p.q0 + t, m);
  }
};

// Phase A's store: BM[qi, b] = the max (int8: times the block's scale),
// floored at NEG_CAP, or NEG_CAP for a block at or past n_valid. Keeps the
// max of what the thread stored (for slab_interleave.cu's `part`).
template <class T>
struct BmStore {
  const float* __restrict__ scales;
  float* __restrict__ bm;
  int nb;
  long long n_valid;
  float pmax = -INFINITY;
  __device__ __forceinline__ BmStore(const float* s, float* o, int nb_, long long nv)
      : scales(s), bm(o), nb(nb_), n_valid(nv) {}
  __device__ __forceinline__ void put(int b, int qi, typename T::Acc m) {
    float v;
    if constexpr (T::IS_INT) v = (float)m * scales[(long long)b * BLOCK];
    else v = m;
    v = (long long)b * BLOCK < n_valid ? fmaxf(v, NEG_CAP) : NEG_CAP;
    bm[(long long)qi * nb + b] = v;
    pmax = fmaxf(pmax, v);
  }
};

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
  const WalkPos p(nq, nb, qgroups, blocks_per_cta, qtile, chunk);
  BmStore<T> store(scales, bm, nb, n_valid);
  BlockMaxEpi<T, LEN, BmStore<T>> epi(p, store, smem, qcap, nq);
  walk_blocks<T, LEN>(smem, p, q, db, tl, nq, epi);
  if (part != nullptr && threadIdx.x < p.qt && p.q0 + threadIdx.x < nq)
    part[(long long)(p.q0 + threadIdx.x) * ((nb + blocks_per_cta - 1) / blocks_per_cta) + chunk] =
        store.pmax;
}

}  // namespace mst
