// Floor probes of the scan: the dot alone and the dot with the block-max
// reduce (mini_scan), and the read of the DB alone (stream_probe).
//
// mini_scan replaces the Pallas kernels `_mini_kernel` of the TPU package's
// tools/perf_floor2.py (tile an argument, bf16 or int8) and
// tools/perf_int8_floor.py (tile 32768, int8). For q [Q, 128] and db rows
// [s*tile, (s+1)*tile) of grid step s:
//   reduce: out[s, q, j] = max over the 128 rows of block j of the step of
//           score(q, row): phase A's block maxima with no mask, no scale and
//           no NEG_CAP floor (int8: the int32 max, written as float);
//   none:   out[s, q, j], j < 8, = max over the step's slabs (tile/nslab rows
//           each) of score(q, slab start + j): the small output that kept
//           the dot alive on the TPU.
// mini_scan runs phase A's walk (blockmax.cuh `walk_blocks`: the same CTA
// of a TMA producer and two wgmma consumers, query tile, persistent grid,
// ring and scan_common.cuh's `score_issue` for every score), so mini_scan
// "none", mini_scan "reduce" and blockmax_scan differ only in the per-block
// epilogue, and their differences split phase A's time: the dot, the
// block-max reduce, and the scale, NEG_CAP floor and store. "reduce" runs
// phase A's own epilogue (BlockMaxEpi) with a raw store at out[b / nbt, q,
// b % nbt]. "none" keeps one running max a column a thread for the sink, in
// registers for the whole walk, and sends the scores of rows 0..7 of each
// slab-start block, from the consumer warp that holds them (warp 0 of the
// consumer that takes the block, first half), to their step's output by
// atomicMax (HeadsEpi).

// stream_probe replaces `_probe_kernel` of tools/perf_hbm.py: for x int8
// [n, d], o[r, c] = i + sum over steps s of x[s*tile + r, c] as f32, r < 8.
//
// On a TPU the BlockSpec DMA moves the whole tile whatever the body reads.
// On a GPU only the loads a kernel makes move bytes, and the compiler drops
// a dot whose result is unused. So each probe also writes a sink that
// depends on all of its work: mini_scan the max of every score a CTA
// computes (one value a CTA, folded by the wrapper), stream_probe the XOR of
// every 32-bit word it reads. The plain versions compute the sinks too.
//
// Bounds on the H100: mini_scan reads the DB once (4 GiB of bf16 at 2^24
// rows: 1.28 ms at 3.35 TB/s) and does 2*Q*N*128 operations (1.11 ms at
// Q = 256 at the 989 TFLOP/s bf16 peak; half that in int8 at 1,979 TOP/s),
// so bytes bound it; it issues the dot as phase A does (wgmma), so its time
// beside phase A's is what the probe is for.
// Design: a CTA's range of blocks may span steps (phase A's geometry is
// blind to them). "reduce" stores by block and needs nothing for that; in
// "none" a step's heads meet through atomicMax on an order-preserving
// integer image of the float, one atomic a head score (nslab blocks a step),
// so no head is held in registers across blocks.
// stream_probe gives each tile to one CTA, as the TPU gave each tile one
// grid step: 512 threads read it with 16-byte loads, four in flight a
// thread, so the sweep over `tile` shows how the read rate depends on the
// work a CTA is given.
#include <climits>

#include "blockmax.cuh"

namespace mst {

constexpr int STHREADS = 512;

// Signed integers in the order of the floats they stand for, so atomicMax
// on them is a max of the floats (no NaN here).
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// mini_scan "reduce"'s store: the raw block max at out[b / nbt, qi, b % nbt];
// finish hands the consumers' max of what they stored (the CTA's part of
// the sink) to *sink.
template <class T>
struct RawStore {
  float* __restrict__ out;
  int nq, nbt;
  float* buf;    // 8 floats of shared memory
  float* sink;
  __device__ __forceinline__ RawStore(float* o, int nq_, int nbt_, float* b, float* sk)
      : out(o), nq(nq_), nbt(nbt_), buf(b), sink(sk) {}
  __device__ __forceinline__ void prefetch(int) {}
  __device__ __forceinline__ float put(int b, int qi, typename T::Acc m) {
    const float v = (float)m;
    out[((long long)(b / nbt) * nq + qi) * nbt + b % nbt] = v;
    return v;
  }
  template <class Epi>
  __device__ __forceinline__ void finish(Epi& epi) { consumers_max(epi.thread_max(), buf, sink); }
};

// mini_scan "none"'s epilogue. run: the max of every score of the thread's
// columns (one max a column, in registers for the whole walk; the sink). In
// warp 0 of the block's consumer, the first half's accumulator holds rows
// 0..7 of the block (row g: acc[4j + c], column j*8 + tig*2 + c); for a block that
// starts a slab they go straight to keys [nsteps, nq, 8] by atomicMax, into
// the block's own step: no head is held across blocks, so a CTA's range
// may span steps.
template <class T, int N>
struct HeadsEpi {
  using Acc = typename T::Acc;
  const WalkPos& p;
  int* __restrict__ keys;
  int nq, nbt, slab_blocks;
  float* buf;
  float* sink;
  int head_step;     // the current block's step if it starts a slab, else -1
  Acc run[N / 4];

  __device__ __forceinline__ HeadsEpi(const WalkPos& pos, int* k, int nq_, int nbt_, int sb,
                                      float* b, float* sk)
      : p(pos), keys(k), nq(nq_), nbt(nbt_), slab_blocks(sb), buf(b), sink(sk), head_step(-1) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      if constexpr (T::IS_INT) run[j] = INT_MASKED;
      else run[j] = -INFINITY;
    }
  }

  __device__ __forceinline__ void begin_block(int b, const float*) {
    head_step = b % slab_blocks == 0 ? b / nbt : -1;
  }

  __device__ __forceinline__ void half(int h, const Acc (&acc)[N / 2]) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        run[2 * j + c] = amax(run[2 * j + c], amax(acc[4 * j + c], acc[4 * j + 2 + c]));
    if (h == 0 && p.warp == 0 && head_step >= 0)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = p.q0 + j * 8 + p.tig * 2 + c;
          if (qi < nq)
            atomicMax(keys + ((long long)head_step * nq + qi) * 8 + p.g,
                      order_key((float)acc[4 * j + c]));
        }
  }

  __device__ __forceinline__ void end_block(int, int) {}

  // the consumers' max of run; queries past nq (zero rows) stay out
  __device__ __forceinline__ void finish() {
    float v = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (p.q0 + j * 8 + p.tig * 2 + c < nq) v = fmaxf(v, (float)run[2 * j + c]);
    consumers_max(v, buf, sink);
  }
};

// One CTA of phase A's grid (blockmax.cu's geometry: query tiles x chunks
// of blocks_per_cta blocks over the nb = nsteps * nbt blocks); the sink of
// CTA (x, y) is sink[y * gridDim.x + x].
template <class T, int N, bool REDUCE>
__global__ void __launch_bounds__(THREADS, 1)
mini_scan_kernel(const __grid_constant__ CUtensorMap map, const typename T::In* __restrict__ q,
                 float* __restrict__ out, float* __restrict__ sink, int nq, int nb, int nbt,
                 int slab_blocks, int blocks_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float warp_best[4 * CONSUMERS];
  unsigned char* smem = align_smem(smem_raw);
  const WalkPos p(nb, N, blocks_per_cta, blockIdx.x, blockIdx.y);
  float* sk = sink + (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if constexpr (REDUCE) {
    RawStore<T> store(out, nq, nbt, warp_best, sk);
    BlockMaxEpi<T, N, false, RawStore<T>> epi(p, store, smem, nq);
    walk_blocks<T, N, false>(smem, p, map, q, nullptr, nullptr, nq, epi);
  } else {
    HeadsEpi<T, N> epi(p, reinterpret_cast<int*>(out), nq, nbt, slab_blocks, warp_best, sk);
    walk_blocks<T, N, false>(smem, p, map, q, nullptr, nullptr, nq, epi);
  }
}

__global__ void __launch_bounds__(STHREADS)
stream_probe_kernel(const int8_t* __restrict__ x, float* __restrict__ o,
                    unsigned* __restrict__ sink, int d, long long tile) {
  __shared__ unsigned warp_xor[STHREADS / 32];
  const int8_t* base = x + (long long)blockIdx.x * tile * d;
  const uint4* src = reinterpret_cast<const uint4*>(base);
  const long long nvec = tile * d / 16;
  unsigned acc = 0;
  long long v = threadIdx.x;
  for (; v + 3 * STHREADS < nvec; v += 4 * STHREADS) {
    const uint4 a = src[v], b = src[v + STHREADS], c = src[v + 2 * STHREADS],
                e = src[v + 3 * STHREADS];
    acc ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
    acc ^= c.x ^ c.y ^ c.z ^ c.w ^ e.x ^ e.y ^ e.z ^ e.w;
  }
  for (; v < nvec; v += STHREADS) {
    const uint4 a = src[v];
    acc ^= a.x ^ a.y ^ a.z ^ a.w;
  }
  for (int e = threadIdx.x; e < 8 * d; e += STHREADS)
    atomicAdd(o + e, (float)base[e]);  // small integers: exact in any order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_xor[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < STHREADS / 32; ++w) acc ^= warp_xor[w];
    atomicXor(sink, acc);
  }
}

template <class T, int N, bool REDUCE>
int launch_mini(const CUtensorMap& map, const void* q, float* out, float* sink, int nq, int nb,
                int nbt, int slab_blocks, int blocks_per_cta, cudaStream_t stream) {
  const size_t smem = WalkSmem<T, N>::LAUNCH;
  cudaError_t err = allow_smem(mini_scan_kernel<T, N, REDUCE>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nq + N - 1) / N, (nb + blocks_per_cta - 1) / blocks_per_cta);
  mini_scan_kernel<T, N, REDUCE><<<grid, THREADS, smem, stream>>>(
      map, static_cast<const typename T::In*>(q), out, sink, nq, nb, nbt, slab_blocks,
      blocks_per_cta);
  return cudaGetLastError();
}

template <class T>
int launch_mini_scan(const void* q, const void* db, float* out, float* sink, int nq, int nsteps,
                     int nbt, int slab_blocks, int reduce, int tile, int blocks_per_cta,
                     cudaStream_t s) {
  const long long nb = (long long)nsteps * nbt;
  if (nq < 1 || nbt < 1 || slab_blocks < 1 || nbt % slab_blocks || blocks_per_cta < 1 ||
      nb > INT_MAX)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  const int rc = db_tensor_map<T>(&map, db, nb * BLOCK);
  if (rc != 0) return rc;
  return by_tile(tile, [&](auto tw) {
    constexpr int N = decltype(tw)::value;
    if (reduce)
      return launch_mini<T, N, true>(map, q, out, sink, nq, (int)nb, nbt, slab_blocks,
                                     blocks_per_cta, s);
    return launch_mini<T, N, false>(map, q, out, sink, nq, (int)nb, nbt, slab_blocks,
                                    blocks_per_cta, s);
  });
}

}  // namespace mst

// dtype: 0 = bf16, 1 = int8. out: [nsteps, nq, nbt] (reduce) or int32 keys
// [nsteps, nq, 8] preset to the key of -inf (none). sink: one float a CTA,
// [ceil(nb / blocks_per_cta), ceil(nq / tile)] for nb = nsteps * nbt.
// slab_blocks divides nbt; tile (the query tile width) is 32, 64, 128 or
// 256. Returns 0, a cudaError_t, or mst::ERR_TMAP + the encode's CUresult.
extern "C" int mst_mini_scan(int dtype, const void* q, const void* db, void* out,
                             void* sink, int nq, int nsteps, int nbt, int slab_blocks,
                             int reduce, int tile, int blocks_per_cta, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  auto k = static_cast<float*>(sink);
  if (dtype == 0)
    return mst::launch_mini_scan<mst::Bf16>(q, db, o, k, nq, nsteps, nbt, slab_blocks,
                                            reduce, tile, blocks_per_cta, s);
  if (dtype == 1)
    return mst::launch_mini_scan<mst::Int8>(q, db, o, k, nq, nsteps, nbt, slab_blocks,
                                            reduce, tile, blocks_per_cta, s);
  return cudaErrorInvalidValue;
}

// x int8 [nsteps*tile, d], d % 16 == 0; o [8, d] preset to i; sink one
// uint32 preset to 0.
extern "C" int mst_stream_probe(const void* x, void* o, void* sink, int d,
                                long long tile, int nsteps, void* stream) {
  mst::stream_probe_kernel<<<nsteps, mst::STHREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<float*>(o),
      static_cast<unsigned*>(sink), d, tile);
  return cudaGetLastError();
}
