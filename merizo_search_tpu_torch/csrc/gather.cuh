// Phase C of the fused exact top-k scan: rescore the selected 128-row blocks.
// (The CTA bodies; the kernels and their launchers are in gather.cu.)
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
// The f32 mode (further down) has a body of its own on the CUDA cores, with
// the same masks and layout.
// out[q, col*128 + r] is the score of row bidx[q, col]*128 + r, or NEG_CAP
// where bidx is -1 (padding), the row is >= n_valid, the length channel
// masks it (!(tl[row] <= qcap[q])), or the score is NaN.
//
// Each score comes from phase A's routine (scan_common.cuh `score_issue`):
// wgmma m64n8 on each 64-row half of the block, with the query in N slot
// qi % 8 of the 8-wide B tile (the slot it has in phase A) and zeros in the
// other seven, the same k-steps in the same order from zero. So a row scores
// the same float in both phases, and int8 scaling is the same f32 multiply
// of the same integer.
//
// Bound on the H100: each selected block is 32 KB (bf16) of scattered but
// contiguous reads, plus the [Q, KB*128] f32 output; at KB ~ k+2 the kernel
// moves a few MB per batch and is bound by bytes and, at the search shape
// (Q 32, KB 12: 3.3 us of bytes), by the latency of one block's read.
// Design: one CTA of one warpgroup per (query, selected column): thread 0
// issues the block's TMA load as soon as the CTA's barrier exists, while the
// CTA stages the query's B tile, so each column waits on one read latency
// and the columns of a batch all wait at once (a bf16 CTA takes 36 KB of
// shared memory, six an SM). (One CTA for two or four columns, each its
// own slot and barrier, was no faster on an H100: equal in bf16, slower in
// int8, at Q 32, KB 12; PERF.md.) gather_variants.cu's `full` mode runs this
// body on the same grid.
#pragma once

#include "scan_common.cuh"

namespace mst {

constexpr int GTHREADS = BLOCK;  // one warpgroup

// Byte offsets of gather_body's shared memory (after align_smem): the
// block's slot (1024-aligned), the query's B tile (8 rows), the block's tl
// values, the barrier. Six CTAs fit an SM.
template <class T>
struct GatherSmem {
  static constexpr int BT = Slot<T>::BYTES;
  static constexpr int TL = BT + 8 * Slot<T>::ROWB;
  static constexpr int BAR = TL + TL_BYTES;
  static constexpr int BYTES = BAR + 8;
  static constexpr int LAUNCH = BYTES + SW_PERIOD;
  static_assert(BT % SW_PERIOD == 0 && TL % 16 == 0 && BAR % 8 == 0, "GatherSmem alignment");
  static_assert(6 * (LAUNCH + SMEM_RESERVED) <= SMEM_SM, "six phase-C CTAs an SM");
};

// One CTA's work: query `qi` against its selected column `col`, through the
// DB's tensor map into one slot. Needs GTHREADS threads (the body meets on
// named barrier 1) and GatherSmem<T>::LAUNCH bytes at `smem_raw`.
// gather_kernel runs it with the CTA's grid coordinates, gather_variants.cu's
// `full` mode on the same grid. With pad_neg, bidx -1 is padding (NEG_CAP,
// nothing read); without, a negative index scores block 0, as the TPU
// gather variants clamp it (gather_variants.cu).
template <class T>
__device__ __forceinline__ void
gather_body(unsigned char* smem_raw, const CUtensorMap& map, const typename T::In* __restrict__ q,
            const float* __restrict__ tl, const float* __restrict__ qcap,
            const int* __restrict__ bidx, const float* __restrict__ scale_sel,
            const float* __restrict__ scales, float* __restrict__ out, int kb,
            long long n_valid, int qi, int col, bool pad_neg = true) {
  using G = GatherSmem<T>;
  constexpr int CH = Slot<T>::CHUNKS;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, tig = tid & 3;
  const long long sel = (long long)qi * kb + col;
  float* o = out + sel * BLOCK;
  int b = bidx[sel];
  if (b < 0) {
    if (pad_neg) {  // the same for every thread of the CTA
      o[tid] = NEG_CAP;
      return;
    }
    b = 0;
  }
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::BAR);
  float* tls = reinterpret_cast<float*>(smem + G::TL);
  const int slot_n = qi % 8;                 // the query's N slot in phase A
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    load_block<T>(smem, tls, map, tl, b, bar);
  }
  for (int c = tid; c < 8 * CH; c += GTHREADS)   // the B tile: the query in row slot_n
    stage_row_chunk<T>(smem + G::BT, 8, c / CH, c % CH,
                       c / CH == slot_n ? q + (long long)qi * DIM : nullptr);
  fence_async_smem();
  const float qc = tl != nullptr ? qcap[qi] : 0.f;
  const float ss = scale_sel != nullptr ? scale_sel[sel] : 1.f;
  bar_sync(1, GTHREADS);  // the B tile is written and the barrier initialised
  mbar_wait(bar, 0);
  typename T::Acc acc[2][4];
  const uint32_t a = smem_addr(smem), bt = smem_addr(smem + G::BT);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    score_issue<T, 8>(acc[h], a + h * HALF * ATOM_B, Slot<T>::ATOM, bt, 8 * ATOM_B);
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  if (tig != slot_n / 2) return;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = h * HALF + warp * 16 + g + 8 * e;
      const long long row = (long long)b * BLOCK + r;
      // constant indices keep acc in registers
      float v = (float)(slot_n & 1 ? acc[h][2 * e + 1] : acc[h][2 * e]);
      bool keep = row < n_valid;
      if (tl != nullptr) keep = keep && tls[r] <= qc;
      if (scale_sel != nullptr) v *= ss;
      if (scales != nullptr) v *= scales[row];
      o[r] = (keep && v == v) ? v : NEG_CAP;
    }
}

// ---------------------------------------------------------------------------
// Phase C on f32 rows: the mode of the TPU kernel in `gather_block_scores_dma`
// that the JAX package's IVF rerank runs on its f32 sidecar (search/ivf.py
// `_rerank_blocks`: the top-(k+1) probed blocks rescored exactly in f32).
// The contract is gather_body's, masks and layout included; only the dot
// differs. Tensor cores would take f32 only as TF32, which keeps ~3 decimal
// digits, so the score is a plain FFMA chain on the CUDA cores: the query in
// shared memory, one row per thread, k = 0..127 in order from a zero
// accumulator (a fixed order, so a row scores the same float wherever it
// lies). A row is 128 FMAs on 512 bytes (0.5 FLOP a byte), so the 64 KB of
// each selected block, scattered but contiguous, bound it by bytes.
//
// Design: one CTA of 128 threads per (query, F32_GROUP columns); blocks
// staged by cp.async (the FFMA chain reads rows, not descriptors, so it keeps
// the pitched layout below) into a ring of two F32Slot slots
// (pitch 528 bytes: the eight 16-byte loads of a quarter-warp at the same k
// fall in distinct bank groups), one block in flight while one is scored.
// Two 68 KB slots leave one CTA an SM.
struct F32 {
  using In = float;
  static constexpr int STAGES = 2;
};
constexpr int F32_GROUP = 4;  // selected blocks per CTA of the f32 body

// A ring slot of the f32 body: one block's rows at pitch ROWB + 16 bytes,
// then its 128 length-channel values.
struct F32Slot {
  static constexpr int ROWB = DIM * 4;
  static constexpr int PITCH = ROWB + 16;
  static constexpr int TL = BLOCK * PITCH;
  static constexpr int BYTES = TL + BLOCK * 4;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of block `b` (and tl's values for it when tl is
// non-null) into `slot`, spread over the CTA's threads; the caller commits.
__device__ __forceinline__ void load_block_f32(unsigned char* slot, const float* __restrict__ db,
                                               const float* __restrict__ tl, long long b) {
  constexpr int CPR = F32Slot::ROWB / 16;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(db + b * BLOCK * DIM);
  for (int c = threadIdx.x; c < BLOCK * CPR; c += blockDim.x)
    cp_async16(slot + (c / CPR) * F32Slot::PITCH + (c % CPR) * 16, src + c * 16);
  if (tl != nullptr)
    for (int c = threadIdx.x; c < BLOCK / 4; c += blockDim.x)
      cp_async16(slot + F32Slot::TL + c * 16, tl + b * BLOCK + c * 4);
}

inline size_t gather_f32_smem() {
  return (size_t)F32::STAGES * F32Slot::BYTES + DIM * sizeof(float);
}

__device__ __forceinline__ void
gather_cols_f32(unsigned char* smem, const float* __restrict__ q,
                const float* __restrict__ db, const float* __restrict__ tl,
                const float* __restrict__ qcap, const int* __restrict__ bidx,
                const float* __restrict__ scale_sel, const float* __restrict__ scales,
                float* __restrict__ out, int kb, long long n_valid, int qi,
                int c_begin, int c_end) {
  constexpr int S = F32::STAGES;
  using SL = F32Slot;
  float* qs = reinterpret_cast<float*>(smem + S * SL::BYTES);
  for (int d = threadIdx.x; d < DIM; d += blockDim.x) qs[d] = q[(long long)qi * DIM + d];
  const float qc = tl != nullptr ? qcap[qi] : 0.f;
  const int ncol = max(0, c_end - c_begin);
  auto block_of = [&](int c) { return bidx[(long long)qi * kb + c]; };

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < ncol) {
      const int b = block_of(c_begin + st);
      if (b >= 0) load_block_f32(smem + st * SL::BYTES, db, tl, b);
    }
    cp_async_commit();
  }
  for (int i = 0; i < ncol; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // column i has landed (and qs is written); slot (i-1) % S is free
    if (i + S - 1 < ncol) {
      const int b = block_of(c_begin + i + S - 1);
      if (b >= 0) load_block_f32(smem + ((i + S - 1) % S) * SL::BYTES, db, tl, b);
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
// the f32 rerank). The contract is gather_body's, masks, scale modes and
// layout included; only which CTA computes which output slot changes.
//
// Why: gather_body runs one CTA per (query, column), so a block that
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
// bf16/int8: score_issue with the query in N slot qi % 8 of its n8 chunk;
// the CSR keeps a block's slots in eight lists, one per residue qi % 8, and
// n8 chunk t of a pass takes the t-th slot of each residue list (zeros
// where a list is shorter), so each (row, query) pair meets the tensor core
// in the N slot and K order it has in the per-query kernel and in phase A
// (the 16-wide tile holds two chunks: wgmma m64n16). f32: the same FFMA
// chain, k = 0..127 in order from zero, with the query in shared memory.
// Which CTA takes which block, and the order of the slots inside a list,
// come from atomics and may change from run to run; the output does not.
//
// Design: one CTA a distinct block (and one per 64 slots for the padding
// list, which a mesh shard's probe fills mostly), with no ring: the block's
// TMA load is in flight while the CTA loads its list offsets and stages its
// slots (list entry, query cap, scale) and their queries' B tile in shared
// memory, so the chain of dependent loads before the dot is short (block
// id, offsets, slots, queries), and the CTAs resident on an SM overlap one
// another's chains and loads. bf16/int8 score two n8 chunks (16 slots) a
// pass; the f32 body (70 KB a block) fits three CTAs an SM.

constexpr int RES = 8;     // residue classes of the query index: its N slot
constexpr int BB_NT = 2;   // n8 chunks a pass of the bf16/int8 body (16 slots)
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
// r * BB_NT + j is the (t0 + j)-th slot of residue list r (n8 chunk j, N
// slot r), sel = its flat entry q*KB + c (-1 where the list is shorter),
// with qcap[q] and scale_sel[sel].
struct BBMeta {
  int sel;
  float qc, ss;
};

// Byte offsets of the bf16/int8 body's shared memory (after align_smem):
// the block (1024-aligned), the pass's B tile (16 rows), the block's tl
// values, the pass's slots, the barrier.
template <class T>
struct ByBlockSmem {
  static constexpr int BT = Slot<T>::BYTES;
  static constexpr int TL = BT + RES * BB_NT * Slot<T>::ROWB;
  static constexpr int META = TL + TL_BYTES;
  static constexpr int BAR = round_up(META + RES * BB_NT * (int)sizeof(BBMeta), 8);
  static constexpr int BYTES = BAR + 8;
  static constexpr int LAUNCH = BYTES + SW_PERIOD;
  static_assert(TL % 16 == 0 && BAR % 8 == 0, "ByBlockSmem alignment");
  static_assert(BB_CTAS<T> * (LAUNCH + SMEM_RESERVED) <= SMEM_SM, "the launch bound's CTAs");
};

// The inversion's workspace in int32s (gather.cu builds the CSR there;
// bm_gather.cu reads it too), sections each a multiple of 4 (16-byte
// aligned): cnt [8(nb+1)] (histogram, then cursor) and hdr [4] (zeroed
// together), off [9(nb+1)], dist [nb], list [m]; `sec` (when non-null)
// gets their five offsets.
inline long long by_block_ws(int nb, long long m, long long* sec) {
  const long long c = 8LL * (nb + 1), o = (9LL * (nb + 1) + 3) & ~3LL,
                  d = ((long long)nb + 3) & ~3LL;
  const long long s[5] = {0, c, c + 4, c + 4 + o, c + 4 + o + d};
  if (sec != nullptr)
    for (int i = 0; i < 5; ++i) sec[i] = s[i];
  return s[4] + m;
}

// The inversion of bidx [nq, kb] over nb blocks into the CSR in ws, on the
// stream with no sync (gather.cu).
cudaError_t invert_blocks(const int* bidx, int* ws, int nq, int kb, int nb, cudaStream_t stream);

inline size_t by_block_f32_smem() {
  return (size_t)F32Slot::BYTES + BB_NQ * DIM * sizeof(float);
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
// dist[blockIdx.x] once (TMA, through the DB's tensor map) and scores it
// against every slot of its lists, BB_NT n8 chunks a pass (row 8j + r of the
// pass's B tile: residue list r's slot of chunk j); the CTAs past nd share
// the padding list. The block's load is in flight while its list offsets,
// per-row scales, pass 0's slots and their queries load. Needs
// ByBlockSmem<T>::LAUNCH bytes at `smem_raw`.
template <class T>
__device__ __forceinline__ void
gather_by_block(unsigned char* smem_raw, const CUtensorMap& map,
                const typename T::In* __restrict__ q, const float* __restrict__ tl,
                const float* __restrict__ qcap, const float* __restrict__ scale_sel,
                const float* __restrict__ scales, float* __restrict__ out, int kb,
                long long n_valid, const ByBlock& cs) {
  using L = ByBlockSmem<T>;
  constexpr int CH = Slot<T>::CHUNKS, NB = RES * BB_NT;  // B tile rows
  const int nd = cs.hdr[0];
  if ((int)blockIdx.x >= nd) {
    by_block_padding(out, cs, (int)blockIdx.x - nd, (int)gridDim.x - nd);
    return;
  }
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const float* tlb = reinterpret_cast<const float*>(smem + L::TL);
  BBMeta* meta = reinterpret_cast<BBMeta*>(smem + L::META);
  const int b = cs.dist[blockIdx.x];
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    load_block<T>(smem, reinterpret_cast<float*>(smem + L::TL), map, tl, b, bar);
  }
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
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
                      ? scales[(long long)b * BLOCK + hm * HALF + warp * 16 + g + 8 * e]
                      : 1.f;
  const uint32_t a = smem_addr(smem), bt = smem_addr(smem + L::BT);

  for (int t0 = 0; t0 < ntiles; t0 += BB_NT) {
    if (t0 > 0) bar_sync(1, GTHREADS);  // the last pass's wgmma and slot reads are done
    by_block_meta(meta, ro, cs, tl, qcap, scale_sel, kb, t0);
    bar_sync(1, GTHREADS);
    for (int c = threadIdx.x; c < NB * CH; c += GTHREADS) {
      const int row = c / CH, sel = meta[(row % RES) * BB_NT + row / RES].sel;
      stage_row_chunk<T>(smem + L::BT, NB, row, c % CH,
                         sel >= 0 ? q + (long long)(sel / kb) * DIM : nullptr);
    }
    fence_async_smem();
    bar_sync(1, GTHREADS);
    mbar_wait(bar, 0);  // the block has landed (at once after the first pass)
    const int ntv = min(BB_NT, ntiles - t0);
    typename T::Acc acc[2][4 * BB_NT];
#pragma unroll
    for (int hm = 0; hm < 2; ++hm)
      score_issue<T, 8 * BB_NT>(acc[hm], a + hm * HALF * ATOM_B, Slot<T>::ATOM, bt, NB * ATOM_B);
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
#pragma unroll
    for (int hm = 0; hm < 2; ++hm)
#pragma unroll
      for (int j = 0; j < BB_NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // column 8j + 2 tig + h: residue 2 tig + h's slot
          const BBMeta m = meta[(2 * tig + h) * BB_NT + j];
          if (j >= ntv || m.sel < 0) continue;
          float* o = out + (long long)m.sel * BLOCK;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = hm * HALF + warp * 16 + g + 8 * e;
            const long long row = (long long)b * BLOCK + r;
            float s = (float)acc[hm][4 * j + 2 * e + h];
            bool keep = row < n_valid;
            if (tl != nullptr) keep = keep && tlb[r] <= m.qc;
            if (scale_sel != nullptr) s *= m.ss;
            if (scales != nullptr) s *= rs[hm][e];
            o[r] = (keep && s == s) ? s : NEG_CAP;
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
  using SL = F32Slot;
  const int nd = cs.hdr[0];
  if ((int)blockIdx.x >= nd) {
    by_block_padding(out, cs, (int)blockIdx.x - nd, (int)gridDim.x - nd);
    return;
  }
  const int b = cs.dist[blockIdx.x];
  load_block_f32(smem, db, tl, b);
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
