// Phase B of the fused scan: the top K = min(k+1, NB) blocks of each query
// by block maximum, from phase A's BM [Q, NB] float32 (ops/select.py).
//
// It replaces no TPU kernel: the JAX package left this selection to XLA
// (`_select_blocks`, `_topk_finite` in its ops/pallas_scan.py),
// and a library top-k over BM (a radix select) reads BM about five times.
// This kernel reads it once. Bound on the H100: BM read once plus the
// candidates written and read; at TED's shard shape (Q 256, NB 356,441, K
// 101) that is 365.0 MB + ~7 MB, ~0.111 ms at 3.35 TB/s. No operation
// counts: the work is compares and shared-memory counting.
//
// Order. Every entry gets a 64-bit composite: the float's bits mapped to an
// order-preserving uint32 key (negative floats' bits inverted, positive ones'
// sign bit set, so -0.0 < +0.0) in the high half, ~id in the low half. The
// composites of a row are distinct, so "the K largest composites" is one
// exact set, and sorting it descending orders the blocks by value, ties by
// lower block id. No result depends on the order of atomics: they only
// decide where in a buffer an entry lands, and every buffer is either a set
// that the next level selects from or sorted before it is written out.
//
// Design. A level is a grid of (query, slice) CTAs of 512 threads, two an
// SM. A CTA copies its slice (at most 20,480 entries, 80 KB) into shared
// memory once (cp.async, 16 bytes a thread a copy, all in flight together),
// then finds its K winners there:
//   1. each thread keeps the largest key of its strided group of the slice
//      (512 groups); the K-th largest group maximum T is a lower bound of
//      the K-th largest key (K groups each hold a key >= T), so the winners
//      lie among the keys >= T: ~112 for K 101 on TED's shape;
//   2. those candidates are collected (up to four a thread in registers,
//      placed by a scan of the counts) and each is placed by its rank among
//      them (the number of larger composites, summed by several threads): a
//      rank below K is a winner and its place. Where they are more than
//      RANK_CAP, a thread holds more than four, or K is above 256, an exact
//      radix select (8-bit digits of the composite, most significant first,
//      counted in shared histograms with warp-aggregated atomics, two
//      barriers a digit, stopping as soon as the digit's whole bin is
//      taken) cuts exactly K of them, or of the whole slice;
//   3. a slice writes its K (key, id) pairs (pads of key 0, id -1 where it
//      holds fewer than K entries, below every real composite); the last
//      level (one slice a query) writes its winners in rank order (a
//      bitonic sort in shared memory orders more than RANK_CAP) to bidx,
//      forcing in the straddling block, and the selected blocks' scales.
// The copy alone takes 83% of the byte bound's time on the H100. What comes
// after it is a chain of barriers and shared-memory round trips that only
// the SM's other CTA overlaps, so each step is cut to few barriers: atomics
// a candidate, or a radix select over them, cost as much as the copy again
// (PERF.md).
// ops/select.py plans the levels: slices of at most WMAX entries of BM
// (one level where NB fits one slice, as at CATH's NB 3,907), then levels
// over the pairs in slices of at most PCAP until one slice a query is left.
// K above SORT_CAP takes the sort path: the whole row's composites sorted
// bitonically (tiles in shared memory, the wide strides in global memory),
// the first K written out.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace msel {

constexpr int THREADS = 512;          // also the groups whose maxima bound the threshold
constexpr int CCAP = 1024;            // candidate positions a CTA collects
constexpr int RANK_CAP = 256;         // candidates placed by rank, not by a select
constexpr int BINS = 256;             // one 8-bit digit
constexpr int SORT_CAP = 2048;        // the largest K a CTA sorts (ops/select.py SORT_K)
constexpr int SORT_TILE = 4096;       // entries of a shared-memory tile of the sort path
constexpr int SCALE_BLOCK = 128;      // rows a block (a scale each)
constexpr unsigned FULL = 0xffffffffu;

// shared memory of a level CTA, in bytes from the start: two histograms
// (a digit's, and the next one's being zeroed), the digit search's results
// (one set a parity of digit), counters, candidates, the sort buffer
constexpr int OFF_MISC = 2 * BINS * 4;          // 32 ints
constexpr int OFF_CAND = OFF_MISC + 128;        // CCAP ints
constexpr int OFF_SORT = OFF_CAND + CCAP * 4;   // uint64: SORT_CAP (last level), RANK_CAP
enum { M_DIGIT, M_ABOVE, M_BIN, M_EQ = 6, M_OUT, M_SCAN = 16 };   // M_SCAN: a warp's sum

// Where a level CTA's input arrays start: after the sort buffer of the last
// level, or the rank buffer of the others.
__host__ __device__ constexpr int input_offset(bool last) {
  return OFF_SORT + (last ? SORT_CAP : RANK_CAP) * 8;
}

// Entries of a shared input array: the slice, copied from its start rounded
// down to 16 bytes, plus up to 6 entries around it, kept 16-byte aligned.
__host__ __device__ constexpr int span_of(int width) { return ((width + 3) / 4 + 2) * 4; }

__device__ __forceinline__ uint32_t float_key(uint32_t bits) {
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ uint64_t compose(uint32_t key, int id) {
  return ((uint64_t)key << 32) | (uint32_t)(~id);
}

__device__ __forceinline__ int comp_id(uint64_t c) { return (int)~(uint32_t)c; }

// Add 1 to hist[digit] for each lane with v; the lanes that share the first
// active lane's digit add with one atomic (most keys of a row share the
// top digits).
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned digit, bool v) {
  const unsigned act = __ballot_sync(FULL, v);
  if (act == 0) return;
  const int leader = __ffs(act) - 1;
  const unsigned ld = __shfl_sync(FULL, digit, leader);
  const unsigned same = __ballot_sync(FULL, v && digit == ld);
  if (v) {
    if (digit != ld) atomicAdd(&hist[digit], 1u);
    else if ((int)(threadIdx.x & 31) == leader) atomicAdd(&hist[ld], (unsigned)__popc(same));
  }
}

// A place in a buffer for each lane with v (one atomic a warp); -1 elsewhere.
__device__ __forceinline__ int warp_append(int* counter, bool v) {
  const unsigned act = __ballot_sync(FULL, v);
  if (act == 0) return -1;
  const int lane = threadIdx.x & 31, leader = __ffs(act) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(act));
  base = __shfl_sync(FULL, base, leader);
  return v ? base + __popc(act & ((1u << lane) - 1u)) : -1;
}

// What a select takes: every composite > thr, and `quota` of those == thr.
struct Cut {
  uint64_t thr;
  int quota;
};

// The cut that takes exactly k of comp(0..n-1), 0 < k <= n: a radix select
// on 8-bit digits, most significant first. Once the digit's bin is taken
// whole, every composite >= the digits so far is taken (quota INT_MAX);
// after all eight digits, thr is the k-th largest composite itself (equal
// composites are identical pads). Called by the whole CTA. Digit d counts
// into hists[d & 1] while the other is zeroed for digit d + 1, and its
// search writes misc[3 * (d & 1)..]: two barriers a digit. No barrier after
// the last: its readers of hists and misc are done before the next call
// (or a caller) writes either, as every writer waits at a barrier first.
template <class F>
__device__ Cut select_cut(int n, int k, F comp, unsigned* hists, int* misc) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint64_t prefix = 0, mask = 0;
  int rem = k;
  for (int i = tid; i < BINS; i += THREADS) hists[i] = 0;
  __syncthreads();
  for (int shift = 56, d = 0; shift >= 0; shift -= 8, ++d) {
    unsigned* hist = hists + (d & 1) * BINS;
    int* res = misc + 3 * (d & 1);
    for (int i = tid; i < BINS; i += THREADS) hists[((d + 1) & 1) * BINS + i] = 0;
    for (int base = 0; base < n; base += THREADS) {
      const int i = base + tid;
      uint64_t c = 0;
      bool v = false;
      if (i < n) {
        c = comp(i);
        v = (c & mask) == prefix;
      }
      hist_add(hist, (unsigned)(c >> shift) & 255u, v);
    }
    __syncthreads();
    if (tid < 32) {   // the digit whose bin holds the rem-th largest, from the top
      unsigned cnt[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = hist[255 - lane * 8 - j];
        s += cnt[j];
      }
      unsigned incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned excl = incl - s, r = (unsigned)rem;
      if (excl < r && r <= incl) {
        unsigned above = excl, bin = 0;
        int digit = 0;
        bool found = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!found && above + cnt[j] >= r) {
            found = true;
            digit = 255 - lane * 8 - j;
            bin = cnt[j];
          } else if (!found) {
            above += cnt[j];
          }
        }
        res[M_DIGIT] = digit;
        res[M_ABOVE] = (int)above;
        res[M_BIN] = (int)bin;
      }
    }
    __syncthreads();
    rem -= res[M_ABOVE];
    prefix |= (uint64_t)res[M_DIGIT] << shift;
    mask |= (uint64_t)255 << shift;
    if (rem == res[M_BIN]) return {prefix, INT_MAX};
  }
  return {prefix, rem};
}

// Hand each taken i (and its composite) to sink(slot, c), slots 0.. in no
// particular order. counters: M_EQ, M_OUT, zero on entry.
template <class F, class S>
__device__ void take(int n, F comp, Cut cut, int* misc, S sink) {
  for (int base = 0; base < n; base += THREADS) {
    const int i = base + threadIdx.x;
    uint64_t c = 0;
    bool v = false;
    if (i < n) {
      c = comp(i);
      v = c > cut.thr || (c == cut.thr && atomicAdd(&misc[M_EQ], 1) < cut.quota);
    }
    const int slot = warp_append(&misc[M_OUT], v);
    if (v) sink(slot, c);
  }
}

// Exclusive prefix sum of v over the CTA's threads, and the sum in *total;
// warp_sums holds THREADS / 32 ints. One barrier.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int x = warp_sums[w];
    before += w < warp ? x : 0;
    sum += x;
  }
  *total = sum;
  return before + incl - v;
}

// emit(rank, c) for each of cc[0..nc) whose rank (the larger composites,
// and the equal ones listed before it: identical pads) is below k. Each
// rank is summed by tpc threads of a warp, the most that fit.
template <class E>
__device__ void place_by_rank(const uint64_t* cc, int nc, int k, E emit) {
  int tpc = 1;
  while (tpc < 32 && nc * tpc * 2 <= THREADS) tpc <<= 1;
  for (int base = 0; base < nc * tpc; base += THREADS) {
    const int t = base + threadIdx.x, j = t / tpc, part = t & (tpc - 1);
    uint64_t c = 0;
    int rank = 0;
    if (j < nc) {
      c = cc[j];
      for (int i = part; i < nc; i += tpc) rank += cc[i] > c || (cc[i] == c && i < j);
    }
    for (int off = tpc >> 1; off > 0; off >>= 1) rank += __shfl_down_sync(FULL, rank, off, tpc);
    if (j < nc && part == 0 && rank < k) emit(rank, c);
  }
}

// Bitonic steps over n (a power of two) shared entries that sit at global
// index g0.. of their row: sizes size_from..size_to, strides below n,
// descending overall (a run of `size` is descending where its global index
// has bit `size` clear).
__device__ void bitonic(uint64_t* b, int n, long long g0, long long size_from,
                        long long size_to) {
  for (long long size = size_from; size <= size_to; size <<= 1) {
    for (int stride = (int)min(size >> 1, (long long)(n >> 1)); stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += THREADS) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const bool desc = ((g0 + i) & size) == 0;
        const uint64_t x = b[i], y = b[j];
        if ((x < y) == desc) {
          b[i] = y;
          b[j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Column c of a query's output: the c-th winner (composite c_sorted), -1
// where it is the straddling block, which column k always holds; its
// block's scale (1.0 for -1).
__device__ __forceinline__ void write_col(int* bidx_row, float* ss_row, const float* scales,
                                         int c, int k, uint64_t c_sorted, int straddle) {
  int id = straddle;
  if (c < k) {
    id = comp_id(c_sorted);
    if (id == straddle) id = -1;
  }
  bidx_row[c] = id;
  if (ss_row != nullptr) ss_row[c] = id >= 0 ? scales[(long long)id * SCALE_BLOCK] : 1.0f;
}

struct LevelArgs {
  const uint32_t* in_keys;   // BM's float bits, or the previous level's keys [Q, n_row]
  const int* in_ids;         // the previous level's ids [Q, n_row] (pairs levels)
  long long n_row;           // entries a row of the input
  int nq, width, slices, k;
  uint32_t* out_keys;        // [Q, slices, k] (not the last level)
  int* out_ids;
  int* bidx;                 // [Q, k + 1] (the last level)
  float* scale_sel;          // [Q, k + 1] or null
  const float* scales;       // [NB * 128] or null
  int straddle;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

template <bool PAIRS, bool FINAL>
__global__ void __launch_bounds__(THREADS, FINAL ? 1 : 2) select_level(const LevelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  int* misc = reinterpret_cast<int*>(smem + OFF_MISC);
  int* cand = reinterpret_cast<int*>(smem + OFF_CAND);
  uint64_t* sorted = reinterpret_cast<uint64_t*>(smem + OFF_SORT);
  const int in_off = input_offset(FINAL);
  uint32_t* keys_raw = reinterpret_cast<uint32_t*>(smem + in_off);
  int* ids_raw = reinterpret_cast<int*>(smem + in_off + span_of(a.width) * 4);

  const int tid = threadIdx.x;
  const int q = blockIdx.x / a.slices, s = blockIdx.x % a.slices;
  const long long start = (long long)s * a.width;
  const int n = (int)min((long long)a.width, a.n_row - start);
  const long long e0 = (long long)q * a.n_row + start, total = (long long)a.nq * a.n_row;
  if (tid < 16) misc[tid] = 0;

  // the slice [e0, e0 + n) in 16-byte copies from e0 rounded down to 4
  const long long v0 = e0 >> 2, v1 = (e0 + n + 3) >> 2;
  for (long long v = v0 + tid; v < v1; v += THREADS) {
    const int bytes = (int)min(16LL, (total - v * 4) * 4);
    cp_async16(keys_raw + (v - v0) * 4, a.in_keys + v * 4, bytes);
    if (PAIRS) cp_async16(ids_raw + (v - v0) * 4, a.in_ids + v * 4, bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  uint32_t* kv = keys_raw + (e0 & 3);
  const int* iv = ids_raw + (e0 & 3);

  // keys in place (BM's floats), and the maximum of this thread's group:
  // its entries tid, tid + THREADS, ...
  uint32_t gmax = 0;
  for (int i = tid; i < n; i += THREADS) {
    const uint32_t key = PAIRS ? kv[i] : float_key(kv[i]);
    if (!PAIRS) kv[i] = key;
    gmax = max(gmax, key);
  }
  auto comp_at = [&](int i) -> uint64_t {
    return compose(kv[i], PAIRS ? iv[i] : (int)(start + i));
  };

  const int k = a.k, kk = min(k, n);
  const long long o = (long long)blockIdx.x * k;
  int* brow = FINAL ? a.bidx + (long long)q * (k + 1) : nullptr;
  float* srow = FINAL && a.scale_sel != nullptr ? a.scale_sel + (long long)q * (k + 1) : nullptr;
  auto emit = [&](int place, uint64_t c) {   // a winner at its place
    if (FINAL) {
      write_col(brow, srow, a.scales, place, k, c, a.straddle);
    } else {
      a.out_keys[o + place] = (uint32_t)(c >> 32);
      a.out_ids[o + place] = comp_id(c);
    }
  };
  if (FINAL && tid == 0) write_col(brow, srow, a.scales, k, k, 0, a.straddle);

  Cut cut{0, INT_MAX};   // k >= n: every entry
  bool use_cand = false;
  int nc = 0;
  if (k < n) {
    if (2 * k <= THREADS) {
      uint32_t* gmaxes = reinterpret_cast<uint32_t*>(cand);
      gmaxes[tid] = gmax;
      __syncthreads();
      const Cut g = select_cut(THREADS, k, [&](int j) { return compose(gmaxes[j], j); }, hist,
                               misc);
      const uint32_t lo = (uint32_t)(g.thr >> 32);
      // the candidates (~1% of the entries): up to four a thread in
      // registers, placed in `cand` by a scan of the counts
      int h0 = 0, h1 = 0, h2 = 0, h3 = 0, nh = 0;
      for (int i = tid; i < n; i += THREADS) {
        if (kv[i] >= lo) {
          h3 = h2;
          h2 = h1;
          h1 = h0;
          h0 = i;
          ++nh;
        }
      }
      const bool over = __syncthreads_or(nh > 4);   // also: every gmaxes read is done
      const int mine = min(nh, 4);
      const int at = block_scan(mine, misc + M_SCAN, &nc);
      if (!over && nc <= CCAP) {
        if (mine > 0) cand[at] = h0;
        if (mine > 1) cand[at + 1] = h1;
        if (mine > 2) cand[at + 2] = h2;
        if (mine > 3) cand[at + 3] = h3;
      }
      __syncthreads();
      use_cand = !over && nc >= k && nc <= CCAP;
    }
    if (use_cand && nc <= RANK_CAP) {
      uint64_t* cc = sorted;
      for (int j = tid; j < nc; j += THREADS) cc[j] = comp_at(cand[j]);
      __syncthreads();
      place_by_rank(cc, nc, k, emit);
      return;
    }
    if (use_cand) cut = select_cut(nc, k, [&](int j) { return comp_at(cand[j]); }, hist, misc);
    else cut = select_cut(n, k, comp_at, hist, misc);
  }

  if (FINAL) {
    auto sink = [&](int slot, uint64_t c) { sorted[slot] = c; };
    if (use_cand) take(nc, [&](int j) { return comp_at(cand[j]); }, cut, misc, sink);
    else take(n, comp_at, cut, misc, sink);
    __syncthreads();
    if (kk <= RANK_CAP) {
      place_by_rank(sorted, kk, k, emit);
    } else {
      int p = 1;
      while (p < kk) p <<= 1;
      for (int i = kk + tid; i < p; i += THREADS) sorted[i] = 0;
      __syncthreads();
      bitonic(sorted, p, 0, 2, p);
      for (int c = tid; c < kk; c += THREADS) emit(c, sorted[c]);
    }
  } else {
    if (use_cand) take(nc, [&](int j) { return comp_at(cand[j]); }, cut, misc, emit);
    else take(n, comp_at, cut, misc, emit);
    for (int j = kk + tid; j < k; j += THREADS) {   // pads: below every real entry
      a.out_keys[o + j] = 0;
      a.out_ids[o + j] = -1;
    }
  }
}

template <bool PAIRS, bool FINAL>
cudaError_t launch_level(const LevelArgs& a, cudaStream_t stream) {
  const size_t smem = input_offset(FINAL) + (size_t)span_of(a.width) * 4 * (PAIRS ? 2 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_level<PAIRS, FINAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  select_level<PAIRS, FINAL><<<a.nq * a.slices, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- the sort path (K > SORT_CAP) -------------------------------------------
// buf [Q, P] uint64, P a power of two >= NB: the row's composites, then 0s.

// Tiles of n entries in shared memory: with `init`, filled from BM, else
// read from buf; bitonic sizes size_from..size_to over strides below n.
__global__ void __launch_bounds__(THREADS)
sort_tile(const uint32_t* bm, long long nb, uint64_t* buf, long long p, int n, int init,
          long long size_from, long long size_to) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* b = reinterpret_cast<uint64_t*>(smem);
  const long long tiles = p / n, q = blockIdx.x / tiles, g0 = (blockIdx.x % tiles) * n;
  uint64_t* row = buf + q * p + g0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    if (init) {
      const long long g = g0 + i;
      b[i] = g < nb ? compose(float_key(bm[q * nb + g]), (int)g) : 0;
    } else {
      b[i] = row[i];
    }
  }
  __syncthreads();
  bitonic(b, n, g0, size_from, size_to);
  for (int i = threadIdx.x; i < n; i += THREADS) row[i] = b[i];
}

// One bitonic step at a stride of at least a tile, one thread a pair.
__global__ void __launch_bounds__(THREADS)
sort_step(uint64_t* buf, int nq, long long p, long long size, long long stride) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x, half = p >> 1;
  if (t >= nq * half) return;
  const long long q = t / half, u = t % half;
  const long long i = 2 * u - (u & (stride - 1)), j = i + stride;
  const bool desc = (i & size) == 0;
  uint64_t* b = buf + q * p;
  const uint64_t x = b[i], y = b[j];
  if ((x < y) == desc) {
    b[i] = y;
    b[j] = x;
  }
}

__global__ void __launch_bounds__(THREADS)
sort_out(const uint64_t* buf, long long p, int nq, int k, int straddle, int* bidx,
         float* scale_sel, const float* scales) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)nq * (k + 1)) return;
  const long long q = t / (k + 1);
  const int c = (int)(t % (k + 1));
  write_col(bidx + q * (k + 1), scale_sel == nullptr ? nullptr : scale_sel + q * (k + 1),
            scales, c, k, c < k ? buf[q * p + c] : 0, straddle);
}

__global__ void __launch_bounds__(THREADS)
scales_of(const int* bidx, const float* scales, float* out, long long m) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= m) return;
  const int id = bidx[t];
  out[t] = id >= 0 ? scales[(long long)id * SCALE_BLOCK] : 1.0f;
}

inline unsigned grid_of(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace msel

// One level of the select (ops/select.py `plan`): pairs = 0 reads BM
// (in_keys, float32 [nq, n_row]), 1 the previous level's (keys, ids); last
// = 1 writes bidx [nq, k + 1] int32 and, with scales, scale_sel [nq, k + 1]
// (a slice a query: slices 1), 0 writes out_keys / out_ids [nq, slices, k].
// k <= SORT_CAP where last. Returns a cudaError_t.
extern "C" int mst_select_level(int pairs, int last, const void* in_keys, const void* in_ids,
                                int nq, long long n_row, int width, int slices, int k,
                                void* out_keys, void* out_ids, void* bidx, void* scale_sel,
                                const void* scales, int straddle, void* stream) {
  using namespace msel;
  if (nq <= 0 || n_row <= 0 || width <= 0 || slices <= 0 || k <= 0 ||
      (long long)width * slices < n_row || (long long)width * (slices - 1) >= n_row ||
      (last && (slices != 1 || k > SORT_CAP)))
    return cudaErrorInvalidValue;
  const LevelArgs a{static_cast<const uint32_t*>(in_keys), static_cast<const int*>(in_ids),
                    n_row, nq, width, slices, k,
                    static_cast<uint32_t*>(out_keys), static_cast<int*>(out_ids),
                    static_cast<int*>(bidx), static_cast<float*>(scale_sel),
                    static_cast<const float*>(scales), straddle};
  auto s = static_cast<cudaStream_t>(stream);
  if (pairs) return last ? launch_level<true, true>(a, s) : launch_level<true, false>(a, s);
  return last ? launch_level<false, true>(a, s) : launch_level<false, false>(a, s);
}

// The sort path: buf [nq, p] uint64 scratch (p a power of two >= nb); K =
// k winners a query, written as mst_select_level's last level writes them.
// Launches 1 + sum over sizes 2T..p of (log2(size / T) + 1) + 1 kernels,
// T = min(p, SORT_TILE) (ops/select.py `sort_launches`).
extern "C" int mst_select_sort(const void* bm, int nq, long long nb, int k, void* buf,
                               long long p, void* bidx, void* scale_sel, const void* scales,
                               int straddle, void* stream) {
  using namespace msel;
  if (nq <= 0 || nb <= 0 || k <= 0 || k > nb || p < nb || (p & (p - 1)))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<uint64_t*>(buf);
  const int n = (int)(p < SORT_TILE ? p : SORT_TILE);
  const size_t smem = (size_t)n * 8;
  cudaError_t err = cudaFuncSetAttribute(sort_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (unsigned)(nq * (p / n));
  const uint32_t* keys = static_cast<const uint32_t*>(bm);
  sort_tile<<<tiles, THREADS, smem, s>>>(keys, nb, b, p, n, 1, 2, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (long long size = 2LL * n; size <= p; size <<= 1) {
    for (long long stride = size >> 1; stride >= n; stride >>= 1) {
      sort_step<<<grid_of(nq * (p >> 1)), THREADS, 0, s>>>(b, nq, p, size, stride);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    sort_tile<<<tiles, THREADS, smem, s>>>(keys, nb, b, p, n, 0, size, size);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  sort_out<<<grid_of((long long)nq * (k + 1)), THREADS, 0, s>>>(
      b, p, nq, k, straddle, static_cast<int*>(bidx), static_cast<float*>(scale_sel),
      static_cast<const float*>(scales));
  return cudaGetLastError();
}

// scale_sel [m] = scales[bidx * 128] (1.0 where bidx is -1): the scales of a
// given selection (ops/select.py `selected_scales`).
extern "C" int mst_selected_scales(const void* bidx, const void* scales, void* out, long long m,
                                   void* stream) {
  using namespace msel;
  if (m <= 0) return cudaSuccess;
  scales_of<<<grid_of(m), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bidx), static_cast<const float*>(scales),
      static_cast<float*>(out), m);
  return cudaGetLastError();
}
