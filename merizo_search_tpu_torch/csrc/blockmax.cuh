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
// at Q ~ 300 in bf16 (989 TFLOP/s dense) and Q ~ 600 in int8.
//
// Design (Hopper): a persistent grid, one CTA an SM (ops/blockmax.py
// `phase_a_geometry`: query tiles x chunks of the blocks, about one CTA an
// SM), each CTA walking a contiguous range of blocks with one query tile of
// N = 32, 64, 128 or 256 queries (the least that holds the batch). A CTA is
// three warpgroups:
//   - a producer (warpgroup 2; setmaxnreg gives it 40 registers): one thread
//     keeps TMA loads of 128-row blocks in flight in a ring of T::STAGES
//     slots, each guarded by a `full` mbarrier (the TMA's bytes; the length
//     channel's 512 bytes a block come by a 1-D bulk copy on the same
//     barrier) and an `empty` one (one arrival a warp of the consumer that
//     took the block);
//   - two consumers (setmaxnreg: 232 registers), taking the range's blocks
//     in turn (consumer w blocks w, w+2, ...), each scoring the whole tile
//     against all 128 rows of its block: two wgmma groups m64nN
//     (score_issue, scan_common.cuh), one a 64-row half, into one
//     accumulator (N/2 registers a thread: 128 at N = 256), folded by the
//     epilogue after each half. The consumers never wait for each other, so
//     one's epilogue runs while the other's wgmma keeps the tensor cores
//     busy, and a block's latency (its wait, wgmma, epilogue and store)
//     overlaps the other consumer's block.
// Why whole blocks and the whole tile a consumer: a wgmma reads A (64 rows
// x a k-step) and B (N queries x a k-step) from shared memory, 128 bytes a
// clock an SM at most; two consumers each issuing m64n128 for half the tile
// ask 192 bytes a clock at the tensor cores' rate, one issuing m64n256 asks
// 80, so the widest instruction keeps the dot off the shared-memory limit
// (the column split, with its halves software-pipelined, measured slower:
// PERF.md).
// The query tile is staged once a CTA, in the swizzled layout its B
// descriptor names, with the queries past nq as zero rows.
// Stages: a bf16 block is 32 KB, an int8 one 16 KB; 4 (bf16) and 8 (int8)
// slots keep 128 KB in flight an SM, several times what the SM's share of
// the card's read rate needs over a load's latency, and leave room for the
// 64 KB bf16 query tile at N = 256 (WalkSmem: at most 212 KB with every
// buffer). N stops at 256, wgmma's widest, whose accumulator takes 128 of a
// consumer thread's 232 registers; a batch above 256 takes several tiles.
//
// The epilogue is an object with hooks (`walk_blocks` is the one walk of
// every phase-A-shaped kernel: phase A, bm_gather.cu, slab_interleave.cu and
// probes.cu's mini_scan differ only in it; bm_gather.cu's also keeps a
// block's slot past its two halves, through the slot hooks of WalkHooks).
// Phase A's (`BlockMaxEpi`) folds each half's accumulator into one running
// max a column a thread (the thread's four rows), then a reduce-scatter by
// shuffles over the 8 row groups leaves each lane the warp's max of N/32
// columns, which go to a small shared buffer; the consumer's 128 threads
// meet at a named barrier and one thread a query takes the max over the 4
// warps and hands it to a store policy: `BmStore` scales it, floors it at
// NEG_CAP and writes BM. Only BM reaches device memory.
// The length channel's mask: a thread's 4 rows' tl values come from the
// slot once a block (before the slot is released), the qcap of its columns
// from the tile's qcap values staged in shared memory, one 8-byte load a
// column pair a half; nothing a column stays in registers across blocks,
// and a masked score costs one compare that predicates its max.
#pragma once

#include <type_traits>

#include "scan_common.cuh"

namespace mst {

constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer warpgroup
constexpr int PRODUCER = 128 * CONSUMERS;       // the thread that issues the loads
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;

// Byte offsets of phase A's shared memory (after align_smem) for tile width
// N: the ring's slots (1024-aligned), the query tile (N rows, its atom
// columns N*128 bytes apart), the slots' tl values, the tile's qcap values,
// the epilogue's buffer [CONSUMERS][2 parities][4 warps][N], the barriers.
template <class T, int N>
struct WalkSmem {
  static constexpr int S = T::STAGES;
  static constexpr int QT = S * Slot<T>::BYTES;
  static constexpr int TL = QT + N * Slot<T>::ROWB;
  static constexpr int QCAP = TL + S * TL_BYTES;
  static constexpr int RED = QCAP + N * 4;
  static constexpr int BAR = RED + CONSUMERS * 2 * 4 * N * 4;  // full[S], empty[S]
  static constexpr int BYTES = BAR + 2 * S * 8;
  static constexpr int LAUNCH = BYTES + SW_PERIOD;  // with align_smem's slack
  static_assert(QT % SW_PERIOD == 0 && N * ATOM_B % SW_PERIOD == 0, "swizzled slots and tile");
  static_assert(TL % 16 == 0 && QCAP % 16 == 0 && BAR % 8 == 0, "bulk copies and barriers");
  static_assert(LAUNCH <= SMEM_CTA, "one CTA an SM");
};

// Runs f(std::integral_constant<int, N>{}) for the tile width n (32, 64,
// 128, 256); any other width is an invalid value.
template <class F>
inline int by_tile(int n, F f) {
  switch (n) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ float amax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int amax(int a, int b) { return max(a, b); }

// Where a thread sits in a CTA of the walk: its warpgroup (CONSUMERS for the
// producer), warp in it and lane; the query tile `qtile` (N queries from
// q0) against DB blocks [chunk * blocks_per_cta, +blocks_per_cta) of nb.
struct WalkPos {
  int wg, warp, lane, g, tig;
  int q0;
  int b_begin, nblk;
  __device__ __forceinline__ WalkPos(int nb, int n, int blocks_per_cta, int qtile, int chunk) {
    wg = threadIdx.x >> 7;
    warp = (threadIdx.x >> 5) & 3;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    tig = lane & 3;
    q0 = qtile * n;
    b_begin = chunk * blocks_per_cta;
    nblk = max(0, min(nb, b_begin + blocks_per_cta) - b_begin);
  }
};

// The slot hooks of the walk, with the defaults every epilogue but
// bm_gather.cu's keeps: no bytes beside the block, and the slot released
// before the block's second half is folded.
struct WalkHooks {
  __device__ __forceinline__ int slot_tx() const { return 0; }
  __device__ __forceinline__ void load_slot(int, int, uint64_t*) const {}
  __device__ __forceinline__ bool take_slot(int, int) { return false; }
  __device__ __forceinline__ void slot_block(int, int) {}
};

// The walk of one CTA (THREADS threads, WalkSmem<T, N>::BYTES at smem,
// 1024-aligned): stage the query tile once, then the producer streams the
// range's blocks through the ring while the consumers take them in turn,
// every score from score_issue. The epilogue `epi` sees, in the threads of
// the consumer that takes block b: begin_block(b, tls) once b has landed
// (tls: its tl values, when LEN stages them); half(h, acc) with the scores
// of rows h*64 .. +63 against the tile's N queries (acc as scan_common.cuh
// lays it out); end_block(b, par) after both halves, par alternating from
// block to block of a consumer (its 128 threads may meet there, on named
// barrier 2 + wg); and in every consumer thread finish() after the last
// block (the 256 may meet there, on named barrier 1). The slot is released
// before half(1, ...), so what begin_block wants of it, it reads there;
// unless take_slot(s, b), called after begin_block (and the same in all of
// the consumer's threads), returns true: then slot_block(b, s) runs after
// end_block, on the block still in slot s, and the slot is released after
// it. The producer thread asks the epilogue for slot_tx() more bytes on
// the block's `full` barrier and issues them by load_slot(s, b, bar), after
// the block's TMA.
template <class T, int N, bool LEN, class Epi>
__device__ __forceinline__ void walk_blocks(unsigned char* smem, const WalkPos& p,
                                            const CUtensorMap& map,
                                            const typename T::In* __restrict__ q,
                                            const float* __restrict__ tl,
                                            const float* __restrict__ qcap, int nq, Epi& epi) {
  using L = WalkSmem<T, N>;
  constexpr int S = L::S;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + S;
  float* tls = reinterpret_cast<float*>(smem + L::TL);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the warps of the consumer that took the block
    }
    mbar_init_fence();
  }
  if (p.wg < CONSUMERS) {
    constexpr int CH = Slot<T>::CHUNKS;
    for (int c = threadIdx.x; c < N * CH; c += 128 * CONSUMERS) {
      const int r = c / CH, qi = p.q0 + r;
      stage_row_chunk<T>(smem + L::QT, N, r, c % CH,
                         qi < nq ? q + (long long)qi * DIM : nullptr);
    }
    if constexpr (LEN)
      for (int r = threadIdx.x; r < N; r += 128 * CONSUMERS)
        reinterpret_cast<float*>(smem + L::QCAP)[r] = p.q0 + r < nq ? qcap[p.q0 + r] : 0.f;
    fence_async_smem();
  }
  __syncthreads();

  if (p.wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == PRODUCER && p.nblk > 0) {
      tma_prefetch(map);
      for (int i = 0; i < p.nblk; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(&empty[s], (i / S - 1) & 1);  // round i/S - 1 released
        load_block<T>(smem + s * Slot<T>::BYTES, tls + s * BLOCK, map, LEN ? tl : nullptr,
                      p.b_begin + i, &full[s], epi.slot_tx());
        epi.load_slot(s, p.b_begin + i, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const uint32_t slots = smem_addr(smem), qt = smem_addr(smem + L::QT);
    for (int i = p.wg; i < p.nblk; i += CONSUMERS) {
      const int s = i % S;
      mbar_wait(&full[s], (i / S) & 1);
      epi.begin_block(p.b_begin + i, tls + s * BLOCK);
      const bool keep = epi.take_slot(s, p.b_begin + i);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        typename T::Acc acc[N / 2];
        score_issue<T, N>(acc, slots + s * Slot<T>::BYTES + h * HALF * ATOM_B, Slot<T>::ATOM,
                          qt, N * ATOM_B);
        wgmma_wait<0>();
        fence_acc(acc);
        if (h == 1 && !keep) {  // the warp's reads of slot s are done
          __syncwarp();
          if (p.lane == 0) mbar_arrive(&empty[s]);
        }
        epi.half(h, acc);
      }
      epi.end_block(p.b_begin + i, (i / CONSUMERS) & 1);
      if (keep) {
        epi.slot_block(p.b_begin + i, s);
        __syncwarp();
        if (p.lane == 0) mbar_arrive(&empty[s]);
      }
    }
    epi.finish();
  }
}

// Max over a warp's 8 row groups (lane bits 2-4) of a thread's V column
// values v[k] (column (k/2)*8 + tig*2 + k%2 of its n8 chunks): a
// reduce-scatter by halves (lane bit O keeps the upper or lower half of what
// is left, and takes the max with its partner's other half), then a plain
// butterfly once one value is left. A lane ends with NF = max(V/8, 1) values
// v[0..NF): those of value indices rg_first(g) ..; where fewer than 8 lanes
// hold distinct values, the others repeat them (rg_owner is false).
template <int O, int NL, class Acc, int V>
__device__ __forceinline__ void rowgroup_max(Acc (&v)[V], int lane) {
  if constexpr (O >= 4) {
    if constexpr (NL >= 2) {
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int m = 0; m < NL / 2; ++m) {
        const Acc send = up ? v[m] : v[m + NL / 2];
        const Acc keep = up ? v[m + NL / 2] : v[m];
        v[m] = amax(keep, __shfl_xor_sync(0xffffffffu, send, O));
      }
      rowgroup_max<O / 2, NL / 2>(v, lane);
    } else {
      v[0] = amax(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      rowgroup_max<O / 2, 1>(v, lane);
    }
  }
}
template <int V>
struct RowGroups {
  static constexpr int NF = V >= 8 ? V / 8 : 1;       // values a lane ends with
  static constexpr int SPLIT = V >= 8 ? 3 : (V >= 4 ? 2 : (V >= 2 ? 1 : 0));  // halvings
  __device__ static __forceinline__ int first(int g) { return (g >> (3 - SPLIT)) * NF; }
  __device__ static __forceinline__ bool owner(int g) {
    return (g & ((1 << (3 - SPLIT)) - 1)) == 0;
  }
};

// The 256 consumer threads' max of v, written to *out by thread 0 (named
// barrier 1; `buf`: 8 floats of shared memory).
__device__ __forceinline__ void consumers_max(float v, float* buf, float* out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  bar_sync(1, 128 * CONSUMERS);
  if (threadIdx.x == 0) {
    for (int w = 1; w < 4 * CONSUMERS; ++w) v = fmaxf(v, buf[w]);
    *out = v;
  }
}

// Phase A's epilogue: each block's max for each of the tile's queries,
// handed to `store.put(b, qi, max)` (which returns what it stored) by one
// thread a query of the consumer that took the block (thread t takes the
// tile's columns t and t + 128, where the query is < nq). With LEN, rows
// whose tl exceeds the query's qcap are masked first. finish() calls
// store.finish(*this), which may ask for the max of what a thread stored
// (thread_max) or of what the CTA stored for each query (each_query_max).
template <class T, int N, bool LEN, class Store>
struct BlockMaxEpi : WalkHooks {
  using Acc = typename T::Acc;
  using L = WalkSmem<T, N>;
  static constexpr int V = N / 4, K = (N + 127) / 128;
  const WalkPos& p;
  Store& store;
  Acc* red;           // this consumer's [2][4][N]
  const float* qcs;   // the tile's N qcap values
  int nq;
  float tr[2][2];     // tl of the thread's rows h*64 + warp*16 + g + 8e (LEN)
  Acc run[V];         // the block's max of the thread's columns
  float pm[K];        // the max of what the thread stored for column t + 128k

  __device__ __forceinline__ BlockMaxEpi(const WalkPos& pos, Store& st, unsigned char* smem,
                                         int nq_)
      : p(pos), store(st),
        red(reinterpret_cast<Acc*>(smem + L::RED) + pos.wg * 2 * 4 * N),
        qcs(reinterpret_cast<const float*>(smem + L::QCAP)), nq(nq_) {
#pragma unroll
    for (int k = 0; k < K; ++k) pm[k] = -INFINITY;
  }

  __device__ __forceinline__ void begin_block(int b, const float* tls) {
    store.prefetch(b);
    Acc lowest;
    if constexpr (T::IS_INT) lowest = INT_MASKED; else lowest = -INFINITY;
#pragma unroll
    for (int k = 0; k < V; ++k) run[k] = lowest;
    if constexpr (LEN)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) tr[h][e] = tls[h * HALF + p.warp * 16 + p.g + 8 * e];
  }

  __device__ __forceinline__ void half(int h, const Acc (&acc)[N / 2]) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      float2 qc = make_float2(0.f, 0.f);
      if constexpr (LEN) qc = *reinterpret_cast<const float2*>(qcs + j * 8 + p.tig * 2);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const Acc v0 = acc[4 * j + c], v1 = acc[4 * j + 2 + c];
        Acc& r = run[2 * j + c];
        if constexpr (LEN) {  // a masked score is `lowest`, which never raises r
          const float cap = c ? qc.y : qc.x;
          if (tr[h][0] <= cap) r = amax(r, v0);
          if (tr[h][1] <= cap) r = amax(r, v1);
        } else {
          r = amax(r, amax(v0, v1));
        }
      }
    }
  }

  __device__ __forceinline__ void end_block(int b, int par) {
    using RG = RowGroups<V>;
    rowgroup_max<16, V>(run, p.lane);
    Acc* r = red + par * 4 * N;
    if (RG::owner(p.g))
#pragma unroll
      for (int m = 0; m < RG::NF; ++m) {
        const int k = RG::first(p.g) + m;
        r[p.warp * N + (k >> 1) * 8 + p.tig * 2 + (k & 1)] = run[m];
      }
    bar_sync(2 + p.wg, 128);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (threadIdx.x & 127) + 128 * k;
      if (c < N && p.q0 + c < nq) {
        Acc m = r[c];
#pragma unroll
        for (int w = 1; w < 4; ++w) m = amax(m, r[w * N + c]);
        pm[k] = fmaxf(pm[k], store.put(b, p.q0 + c, m));
      }
    }
  }

  __device__ __forceinline__ void finish() { store.finish(*this); }

  // the max of every value this thread stored
  __device__ __forceinline__ float thread_max() const {
    float v = pm[0];
#pragma unroll
    for (int k = 1; k < K; ++k) v = fmaxf(v, pm[k]);
    return v;
  }

  // f(qi, v) for each of the tile's queries < nq, v the max of what both
  // consumers stored for it, from consumer 0's threads; every consumer
  // thread calls it (named barrier 1), after its walk, when its epilogue
  // buffer is free.
  template <class F>
  __device__ __forceinline__ void each_query_max(F f) {
    float* own = reinterpret_cast<float*>(red);
    const float* other = reinterpret_cast<const float*>(red + (1 - 2 * p.wg) * 2 * 4 * N);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (threadIdx.x & 127) + 128 * k;
      if (c < N) own[c] = pm[k];
    }
    bar_sync(1, 128 * CONSUMERS);
    if (p.wg == 0)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (threadIdx.x & 127) + 128 * k;
        if (c < N && p.q0 + c < nq) f(p.q0 + c, fmaxf(own[c], other[c]));
      }
  }
};

// Phase A's store: BM[qi, b] = the max (int8: times the block's scale, read
// when the block's epilogue begins, so its latency hides behind the
// block's wgmma), floored at NEG_CAP, or NEG_CAP for a block at or past
// n_valid. With `part` (slab_interleave.cu), finish writes the max of what
// the CTA stored for each query to part[qi, chunk] (of nchunks).
template <class T>
struct BmStore {
  const float* __restrict__ scales;
  float* __restrict__ bm;
  int nb;
  long long n_valid;
  float* __restrict__ part;
  int nchunks, chunk;
  float scale = 1.f;  // block b's scale, loaded at begin_block, used at its put
  __device__ __forceinline__ BmStore(const float* s, float* o, int nb_, long long nv, float* pt,
                                     int nch, int ch)
      : scales(s), bm(o), nb(nb_), n_valid(nv), part(pt), nchunks(nch), chunk(ch) {}
  __device__ __forceinline__ void prefetch(int b) {
    if constexpr (T::IS_INT) scale = scales[(long long)b * BLOCK];
  }
  __device__ __forceinline__ float put(int b, int qi, typename T::Acc m) {
    float v;
    if constexpr (T::IS_INT) v = (float)m * scale;
    else v = m;
    v = (long long)b * BLOCK < n_valid ? fmaxf(v, NEG_CAP) : NEG_CAP;
    bm[(long long)qi * nb + b] = v;
    return v;
  }
  template <class Epi>
  __device__ __forceinline__ void finish(Epi& epi) {
    if (part != nullptr)
      epi.each_query_max([&](int qi, float v) { part[(long long)qi * nchunks + chunk] = v; });
  }
};

// One CTA's work: the query tile `qtile` (N queries) against DB blocks
// [chunk * blocks_per_cta, +blocks_per_cta), through the DB's tensor map.
// Needs THREADS threads and WalkSmem<T, N>::LAUNCH bytes at `smem_raw`. LEN
// compiles the length channel (tl, qcap) in. blockmax_kernel runs it with
// the CTA's grid coordinates (bm_gather.cu runs the same walk and store with
// its own epilogue); slab_interleave.cu also passes `part` [nq, nchunks], which gets
// the max of the BM values the CTA wrote for each query (the chunk's
// superblock max). Callers without it pass a literal nullptr.
template <class T, int N, bool LEN>
__device__ __forceinline__ void
blockmax_body(unsigned char* smem_raw, const CUtensorMap& map,
              const typename T::In* __restrict__ q, const float* __restrict__ tl,
              const float* __restrict__ qcap, const float* __restrict__ scales,
              float* __restrict__ bm, int nq, int nb, long long n_valid, int blocks_per_cta,
              int qtile, int chunk, float* __restrict__ part = nullptr) {
  unsigned char* smem = align_smem(smem_raw);
  const WalkPos p(nb, N, blocks_per_cta, qtile, chunk);
  BmStore<T> store(scales, bm, nb, n_valid, part, (nb + blocks_per_cta - 1) / blocks_per_cta,
                   chunk);
  BlockMaxEpi<T, N, LEN, BmStore<T>> epi(p, store, smem, nq);
  walk_blocks<T, N, LEN>(smem, p, map, q, tl, qcap, nq, epi);
}

}  // namespace mst
