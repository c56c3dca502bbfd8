// The two-batch pipelined scan: phase A of batch i and phase C of batch i-1
// in one pass over the DB.
//
// Replaces the Pallas kernel `_bm_gather_kernel` (merizo_search TPU package,
// ops/pallas_scan.py:1014, launched by `blockmax_scan_gather` at :1264 and
// driven by `fused_topk_step`). Contract, for q [Q, 128] this batch's
// queries and pv_q [Qp, 128], pv_bidx [Qp, KB] int32 the previous batch's
// queries and selected blocks (-1 = padding):
//   - bm [Q, Npad/128]: phase A of blockmax.cuh without the length channel
//     (the JAX kernel has none); int8 maxima times the block scale;
//   - prev [Qp, KB*128]: phase C of gather.cuh without the length channel:
//     bf16 scores; int8 scores times pv_scale_sel [Qp, KB] (the previous
//     batch's per-selected-block scales, gather.cuh's production mode), or
//     raw as f32 where pv_scale_sel is null; NEG_CAP where bidx < 0, the
//     row is >= n_valid or the score is NaN.
//
// Bound on the H100: bytes -- the DB read once (phase C's blocks are rows of
// the same DB), the queries, the selection and both outputs, over 3.35 TB/s
// (bf16 1.33 ms at 2^24 rows, Q 256, KB 102; int8 0.69). The design reads
// the DB once, as the bound does: each block the previous batch selected is
// scored while phase A's walk holds it in its TMA ring, so no block is read
// a second time and no CTA runs after the walk.
//
// Design.
//  1. Before the walk (mst_bm_gather_prep: a memset and four small kernels)
//     the previous selection is inverted block-major by the IVF's counting
//     sort (gather.cu invert_blocks: each block's entries q*KB + c in eight
//     residue lists, by q % 8, and the padding entries in bucket nb), and
//     bb_gather_rows copies the listed queries' rows into list order (lq
//     [M, 128], M = Qp*KB: 6.7 MB of bf16 at Qp 256, KB 102) with their
//     scale_sel values (lss [M]). So the rows of a block's entries lie at
//     addresses its offsets give, with no dependent load.
//  2. The walk is phase A's (blockmax.cuh walk_blocks, BlockMaxEpi, BmStore:
//     BM is blockmax_scan's bit for bit) with an epilogue that adds slot
//     hooks. On each block's `full` barrier, beside its TMA, the producer
//     brings the 48-byte window of the CSR's offsets that holds the block's
//     nine residue offsets (one bulk copy). The consumer that takes block b
//     reads them in shared memory; where b lists no entry (most blocks: at
//     most M of them list one) nothing else changes. Where it does, the
//     consumer issues the copies of the block's first pass at once, before
//     its first wgmma, by cp.async (16 rows, row 8j + r the j-th entry of
//     residue list r, zero rows where a list is shorter, and the 16 entries'
//     ids and scales), so they land while phase A's two halves run; keeps
//     the slot past the second half; after end_block waits for the copies,
//     fences them to the async proxy and scores the slot against them with
//     score_issue m64n16 on each half: gather.cuh's block-major body, each
//     entry in N slot q % 8 of its n8 chunk, the slot it has in phase A and
//     in the per-query kernel. Longer lists take more passes of 16, staged
//     by plain loads and stores. Then the slot goes back to the producer.
//     Staging by cp.async and a proxy fence, and not by TMA into a buffer
//     of each slot: a bf16 pass is 4 KB and the ring at N = 256 leaves 15
//     KB of the 227, so the rows go to one B tile a consumer, which the
//     producer cannot fill ahead of the consumer's previous block.
//  3. After the walk, the CTAs of query tile 0 write NEG_CAP in the padding
//     entries (bucket nb), each a share of them (gather.cu's padding CTAs,
//     folded into the persistent grid).
// Every prev score is score_issue's f32 (bf16) or s32 (int8) sum on the
// operand positions of the per-query kernel, times the same f32 scale, so
// the pipelined results equal the sequential fused_topk's bit for bit.
//
// Edge cases. With Q > 256 several query tiles walk each block: only query
// tile 0's CTAs score the lists (and only their producers load offsets). A
// hot block (every previous query selects it) lists Qp entries, Qp/8 a
// residue: Qp/16 passes (16 at Qp 256), whose wgmma work (two m64n16 a
// pass) equals the block's own phase A at N = 256; each pass after the
// first waits on an L2 read of its rows. A selection that repeats a block
// in one query's row lists it more than once: the passes are half the
// longest residue list, at most Qp*KB/16. So a CTA's worst case is its
// range times one phase-A block plus that many passes; under select_blocks
// (distinct blocks a query) at most Qp/16 passes a block.
// The ring: a consumer holds at most one slot (it releases block i's before
// it waits for block i + 2's), so holding it longer still leaves the
// producer S - 2 slots to fill (bf16 2 of 4, 64 KB: twice what an SM's share
// of the read rate needs over a load's latency; int8 6 of 8).
// Shared memory: BmGatherSmem, WalkSmem plus a B tile and 16 entries a
// consumer and the ring's offset windows (bf16 N = 256: 226,752 bytes of
// 232,448; static_asserts). Registers: the passes run after end_block,
// when phase A's accumulator and running maxima are dead, and the first
// pass's copies hold no register across the wgmma (cp.async); ptxas's
// report is in _build/nvcc.log.
#include <algorithm>
#include <climits>

#include "blockmax.cuh"
#include "gather.cuh"

namespace mst {

constexpr int BG_ROWS = RES * BB_NT;  // rows of a pass's B tile: 16 entries
constexpr int BG_WIN = 12;            // ints of a block's offset window: 48 bytes
constexpr int ROW_THREADS = 256;      // bb_gather_rows' CTA

// Byte offsets of the kernel's shared memory (after align_smem): phase A's
// WalkSmem, then a B tile of BG_ROWS rows a consumer (1024-aligned), the
// entries of each consumer's pass (BG_ROWS x {id, scale}), the ring's offset
// windows [S][BG_WIN].
template <class T, int N>
struct BmGatherSmem {
  static constexpr int BT = round_up(WalkSmem<T, N>::BYTES, SW_PERIOD);
  static constexpr int META = BT + CONSUMERS * BG_ROWS * Slot<T>::ROWB;
  static constexpr int WIN = META + CONSUMERS * BG_ROWS * 8;
  static constexpr int BYTES = WIN + T::STAGES * BG_WIN * 4;
  static constexpr int LAUNCH = BYTES + SW_PERIOD;
  static_assert(BT % SW_PERIOD == 0 && BG_ROWS * ATOM_B % SW_PERIOD == 0, "swizzled B tiles");
  static_assert(META % 16 == 0 && WIN % 16 == 0 && BG_WIN * 4 % 16 == 0, "bulk copies");
  static_assert(LAUNCH <= SMEM_CTA, "one CTA an SM");
};

// One entry of a pass: the flat entry q*KB + c (-1 where the list is
// shorter) and its scale_sel (1 without scales).
struct BGEntry {
  int sel;
  float ss;
};

// The previous selection as the walk reads it (mst_bm_gather_prep builds
// it; off and list null for an empty selection).
template <class T>
struct PrevSel {
  const int* off;             // the CSR's residue offsets [(nb + 1) * 9]
  const int* list;            // [M] entries q*KB + c, by (block, residue)
  const typename T::In* lq;   // [M, 128] the rows of pv_q in list order
  const float* lss;           // [M] scale_sel in list order, or null
  float* prev;                // [Qp, KB*128]
  int nb;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Phase A's epilogue and store, plus the slot hooks that score the
// previous selection's lists on the slots that hold their blocks.
template <class T, int N>
struct BmGatherEpi : BlockMaxEpi<T, N, false, BmStore<T>> {
  using Base = BlockMaxEpi<T, N, false, BmStore<T>>;
  using Acc = typename T::Acc;
  using L = BmGatherSmem<T, N>;
  const PrevSel<T>& ps;
  long long n_valid;
  bool on;                // this CTA scores the lists: query tile 0, a nonempty selection
  int chunk, nchunks;
  unsigned char* slots;   // the ring
  unsigned char* bt;      // this consumer's B tile
  BGEntry* meta;          // this consumer's pass entries
  int* win;               // the ring's offset windows

  __device__ __forceinline__ BmGatherEpi(const WalkPos& pos, BmStore<T>& st, unsigned char* smem,
                                         int nq, const PrevSel<T>& sel, long long nv, bool on_,
                                         int chunk_, int nchunks_)
      : Base(pos, st, smem, nq), ps(sel), n_valid(nv), on(on_), chunk(chunk_),
        nchunks(nchunks_), slots(smem), bt(smem + L::BT + pos.wg * BG_ROWS * Slot<T>::ROWB),
        meta(reinterpret_cast<BGEntry*>(smem + L::META) + pos.wg * BG_ROWS),
        win(reinterpret_cast<int*>(smem + L::WIN)) {}

  // block b's residue offsets in slot s's window: list r is [ro[r], ro[r + 1])
  __device__ __forceinline__ const int* ro(int s, int b) const {
    return win + s * BG_WIN + (int)(((RES + 1LL) * b) & 3);
  }

  __device__ __forceinline__ int slot_tx() const { return on ? BG_WIN * 4 : 0; }

  // the 16-byte aligned window of off that holds block b's nine offsets
  __device__ __forceinline__ void load_slot(int s, int b, uint64_t* bar) const {
    if (on) bulk_load(win + s * BG_WIN, ps.off + (((RES + 1LL) * b) & ~3LL), BG_WIN * 4, bar);
  }

  // Pass t0's B tile (row 8j + r: residue list r's entry t0 + j, a zero row
  // where the list is shorter) and entries, from lq, list and lss at the
  // offsets r; by cp.async (the caller waits) or by loads and stores. The
  // consumer's 128 threads.
  template <bool ASYNC>
  __device__ __forceinline__ void stage(const int* r, int t0) {
    constexpr int CH = Slot<T>::CHUNKS;
    const int t = threadIdx.x & 127;
    for (int c = t; c < BG_ROWS * CH; c += 128) {
      const int row = c / CH, k = c % CH, res = row % RES;
      const int e = r[res] + t0 + row / RES;
      unsigned char* dst = bt + sw_chunk(BG_ROWS, row, k);
      if (e < r[res + 1]) {
        const uint4* src = reinterpret_cast<const uint4*>(ps.lq + (long long)e * DIM) + k;
        if constexpr (ASYNC) cp_async16(dst, src);
        else *reinterpret_cast<uint4*>(dst) = *src;
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (t < BG_ROWS) {
      const int res = t / BB_NT, e = r[res] + t0 + t % BB_NT;
      BGEntry* m = meta + t;
      if (e >= r[res + 1]) {
        m->sel = -1;
      } else if constexpr (ASYNC) {
        cp_async4(&m->sel, ps.list + e);
        if (ps.lss != nullptr) cp_async4(&m->ss, ps.lss + e);
        else m->ss = 1.f;
      } else {
        m->sel = ps.list[e];
        m->ss = ps.lss != nullptr ? ps.lss[e] : 1.f;
      }
    }
    if constexpr (ASYNC) cp_async_commit();
  }

  __device__ __forceinline__ bool take_slot(int s, int b) {
    if (!on) return false;
    const int* r = ro(s, b);
    if (r[RES] == r[0]) return false;  // b lists no entry
    stage<true>(r, 0);
    return true;
  }

  // Every pass of block b's lists on slot s (the consumer's 128 threads,
  // named barrier 2 + wg, as end_block).
  __device__ __forceinline__ void slot_block(int b, int s) {
    const WalkPos& p = this->p;
    const int* r = ro(s, b);
    int ntiles = 0;
#pragma unroll
    for (int k = 0; k < RES; ++k) ntiles = max(ntiles, r[k + 1] - r[k]);
    const uint32_t a = smem_addr(slots + s * Slot<T>::BYTES), b_tile = smem_addr(bt);
    for (int t0 = 0; t0 < ntiles; t0 += BB_NT) {
      if (t0 == 0) {
        cp_async_wait<0>();
      } else {
        bar_sync(2 + p.wg, 128);  // the last pass's wgmma and entry reads are done
        stage<false>(r, t0);
      }
      fence_async_smem();
      bar_sync(2 + p.wg, 128);
      Acc acc[2][4 * BB_NT];
#pragma unroll
      for (int hm = 0; hm < 2; ++hm)
        score_issue<T, 8 * BB_NT>(acc[hm], a + hm * HALF * ATOM_B, Slot<T>::ATOM, b_tile,
                                  BG_ROWS * ATOM_B);
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
#pragma unroll
      for (int j = 0; j < BB_NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // column 8j + 2 tig + h: residue 2 tig + h's entry
          const BGEntry m = meta[(2 * p.tig + h) * BB_NT + j];
          if (m.sel < 0) continue;
          float* o = ps.prev + (long long)m.sel * BLOCK;
#pragma unroll
          for (int hm = 0; hm < 2; ++hm)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int rr = hm * HALF + p.warp * 16 + p.g + 8 * e;
              float v = (float)acc[hm][4 * j + 2 * e + h];
              if (ps.lss != nullptr) v *= m.ss;
              o[rr] = ((long long)b * BLOCK + rr < n_valid && v == v) ? v : NEG_CAP;
            }
        }
    }
    bar_sync(2 + p.wg, 128);  // the B tile and entries are free for the next block's copies
  }

  // phase A's finish, then this CTA's share of the padding entries
  __device__ __forceinline__ void finish() {
    Base::finish();
    if (!on) return;
    const int* pad = ps.off + (long long)ps.nb * (RES + 1);
    const int lo = pad[0], hi = pad[RES];
    for (int j = lo + chunk * CONSUMERS + this->p.wg; j < hi; j += nchunks * CONSUMERS)
      ps.prev[(long long)ps.list[j] * BLOCK + (threadIdx.x & 127)] = NEG_CAP;
  }
};

// One CTA: query tile blockIdx.x % qtiles against block chunk
// blockIdx.x / qtiles (blockmax's order, flattened), phase A's walk with
// BmGatherEpi. ps is a __grid_constant__ so that the epilogue can hold a
// reference to it in the parameter space.
template <class T, int N>
__global__ void __launch_bounds__(THREADS, 1)
bm_gather_kernel(const __grid_constant__ CUtensorMap map, const typename T::In* __restrict__ q,
                 const float* __restrict__ scales, float* __restrict__ bm, int nq, int nb,
                 long long n_valid, int blocks_per_cta, int qtiles,
                 const __grid_constant__ PrevSel<T> ps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const int qtile = blockIdx.x % qtiles, chunk = blockIdx.x / qtiles;
  const int nchunks = gridDim.x / qtiles;
  const WalkPos p(nb, N, blocks_per_cta, qtile, chunk);
  BmStore<T> store(scales, bm, nb, n_valid, nullptr, nchunks, chunk);
  BmGatherEpi<T, N> epi(p, store, smem, nq, ps, n_valid, qtile == 0 && ps.list != nullptr,
                        chunk, nchunks);
  walk_blocks<T, N, false>(smem, p, map, q, nullptr, nullptr, nq, epi);
}

// lq[j] = the pv_q row of list entry j (query list[j] / kb), lss[j] =
// scale_sel[list[j]] where scale_sel is given: one thread a 16-byte chunk.
template <class T>
__global__ void __launch_bounds__(ROW_THREADS)
bb_gather_rows(const int* __restrict__ list, const uint4* __restrict__ pv_q,
               const float* __restrict__ scale_sel, uint4* __restrict__ lq,
               float* __restrict__ lss, int kb, long long m) {
  constexpr int CH = Slot<T>::CHUNKS;
  const long long i = (long long)blockIdx.x * ROW_THREADS + threadIdx.x;
  if (i >= m * CH) return;
  const long long j = i / CH;
  const int c = (int)(i % CH), e = list[j];
  lq[i] = pv_q[(long long)(e / kb) * CH + c];
  if (c == 0 && scale_sel != nullptr) lss[j] = scale_sel[e];
}

template <class T>
int launch_prep(const void* pv_q, const int* bidx, const float* scale_sel, int* ws, void* lq,
                float* lss, int nq_prev, int kb, int nb, cudaStream_t s) {
  const long long m = (long long)nq_prev * kb;
  if (m <= 0 || m > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = invert_blocks(bidx, ws, nq_prev, kb, nb, s);
  if (err != cudaSuccess) return err;
  long long sec[5];
  by_block_ws(nb, m, sec);
  const long long n = m * Slot<T>::CHUNKS;
  bb_gather_rows<T><<<(unsigned)((n + ROW_THREADS - 1) / ROW_THREADS), ROW_THREADS, 0, s>>>(
      ws + sec[4], static_cast<const uint4*>(pv_q), scale_sel, static_cast<uint4*>(lq), lss, kb,
      m);
  return cudaGetLastError();
}

template <class T, int N>
int launch_bm_gather(const CUtensorMap& map, const void* q, const float* scales, float* bm,
                     int nq, int nb, long long n_valid, int blocks_per_cta, const PrevSel<T>& ps,
                     cudaStream_t stream) {
  const size_t smem = BmGatherSmem<T, N>::LAUNCH;
  cudaError_t err = allow_smem(bm_gather_kernel<T, N>, smem);
  if (err != cudaSuccess) return err;
  const int qtiles = std::max(1, (nq + N - 1) / N);
  const long long ctas = (long long)qtiles * ((nb + blocks_per_cta - 1) / blocks_per_cta);
  if (ctas <= 0 || ctas > INT_MAX) return cudaErrorInvalidValue;
  bm_gather_kernel<T, N><<<(unsigned)ctas, THREADS, smem, stream>>>(
      map, static_cast<const typename T::In*>(q), scales, bm, nq, nb, n_valid, blocks_per_cta,
      qtiles, ps);
  return cudaGetLastError();
}

template <class T>
int launch_bm_gather_t(const void* q, const void* db, const float* scales, float* bm, int nq,
                       int nb, long long n_valid, int tile, int blocks_per_cta, const int* ws,
                       const void* lq, const float* lss, float* prev, int nq_prev, int kb,
                       cudaStream_t s) {
  if (blocks_per_cta < 1 || nq < 0) return cudaErrorInvalidValue;
  const long long m = (long long)nq_prev * kb;
  PrevSel<T> ps{nullptr, nullptr, static_cast<const typename T::In*>(lq), lss, prev, nb};
  if (m > 0) {
    if (ws == nullptr || lq == nullptr) return cudaErrorInvalidValue;
    long long sec[5];
    by_block_ws(nb, m, sec);
    ps.off = ws + sec[2];
    ps.list = ws + sec[4];
  }
  CUtensorMap map;
  const int rc = db_tensor_map<T>(&map, db, (long long)nb * BLOCK);
  if (rc != 0) return rc;
  return by_tile(tile, [&](auto tw) {
    return launch_bm_gather<T, decltype(tw)::value>(map, q, scales, bm, nq, nb, n_valid,
                                                    blocks_per_cta, ps, s);
  });
}

}  // namespace mst

// The previous selection for mst_bm_gather: pv_bidx [nq_prev, kb] inverted
// over nb blocks into ws (mst_by_block_ws(nb, nq_prev*kb) int32s), the rows
// of pv_q [nq_prev, 128] in the list's order into lq [nq_prev*kb, 128] (of
// the dtype: 0 = bf16, 1 = int8), and pv_scale_sel [nq_prev, kb] (optional)
// in that order into lss [nq_prev*kb]. nq_prev*kb > 0. Returns 0 or a
// cudaError_t.
extern "C" int mst_bm_gather_prep(int dtype, const void* pv_q, const void* pv_bidx,
                                  const void* pv_scale_sel, void* ws, void* lq, void* lss,
                                  int nq_prev, int kb, int nb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto ib = static_cast<const int*>(pv_bidx);
  auto ss = static_cast<const float*>(pv_scale_sel);
  auto w = static_cast<int*>(ws);
  auto l = static_cast<float*>(lss);
  if (dtype == 0)
    return mst::launch_prep<mst::Bf16>(pv_q, ib, ss, w, lq, l, nq_prev, kb, nb, s);
  if (dtype == 1)
    return mst::launch_prep<mst::Int8>(pv_q, ib, ss, w, lq, l, nq_prev, kb, nb, s);
  return cudaErrorInvalidValue;
}

// dtype: 0 = bf16 (scales and lss null), 1 = int8 (scales required, lss
// optional: pv_scale_sel's). tile: phase A's query tile width. ws, lq, lss:
// mst_bm_gather_prep's output for this call's previous selection (ignored
// where nq_prev*kb is 0). Returns 0, a cudaError_t, or mst::ERR_TMAP + the
// encode's CUresult.
extern "C" int mst_bm_gather(int dtype, const void* q, const void* db, const void* scales,
                             void* bm, int nq, int nb, long long n_valid, int tile,
                             int blocks_per_cta, const void* ws, const void* lq,
                             const void* lss, void* prev, int nq_prev, int kb, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scales);
  auto w = static_cast<const int*>(ws);
  auto ls = static_cast<const float*>(lss);
  auto b = static_cast<float*>(bm);
  auto p = static_cast<float*>(prev);
  if (dtype == 0)
    return mst::launch_bm_gather_t<mst::Bf16>(q, db, sc, b, nq, nb, n_valid, tile,
                                              blocks_per_cta, w, lq, ls, p, nq_prev, kb, s);
  if (dtype == 1)
    return mst::launch_bm_gather_t<mst::Int8>(q, db, sc, b, nq, nb, n_valid, tile,
                                              blocks_per_cta, w, lq, ls, p, nq_prev, kb, s);
  return cudaErrorInvalidValue;
}

// The kernel's shared-memory layout as it is built (BmGatherSmem<T, N>),
// for dtype 0 = bf16 / 1 = int8 and tile width n: out[0..4] = the offsets
// BT, META, WIN, the layout's bytes and the launch's (with the alignment
// slack). Returns 0 or cudaErrorInvalidValue. Host only.
extern "C" int mst_bm_gather_layout(int dtype, int n, int* out) {
  auto fill = [&](auto t) {
    return mst::by_tile(n, [&](auto tw) {
      using L = mst::BmGatherSmem<decltype(t), decltype(tw)::value>;
      const int v[5] = {L::BT, L::META, L::WIN, L::BYTES, L::LAUNCH};
      for (int i = 0; i < 5; ++i) out[i] = v[i];
      return 0;
    });
  };
  if (dtype == 0) return fill(mst::Bf16{});
  if (dtype == 1) return fill(mst::Int8{});
  return cudaErrorInvalidValue;
}
