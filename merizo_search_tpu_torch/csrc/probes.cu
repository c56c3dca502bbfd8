// Floor probes of the scan: the dot alone and the dot with the block-max
// reduce (mini_scan), and the read of the DB alone (stream_probe).
//
// mini_scan replaces the Pallas kernels `_mini_kernel` of the TPU package's
// tools/perf_floor2.py (tile an argument, bf16 or int8) and
// tools/perf_int8_floor.py (tile 32768, int8). For q [Q, 128] and db rows
// [s*tile, (s+1)*tile) of grid step s:
//   reduce: out[s, q, j] = max over the 128 rows of block j of the step of
//           score(q, row): phase A's block maxima with no mask, no scale and
//           no NEG_CAP floor;
//   none:   out[s, q, j], j < 8, = max over the step's slabs (tile/nslab rows
//           each) of score(q, slab start + j): the small output that kept
//           the dot alive on the TPU.
// mini_scan keeps the CUDA-core dot that phase A had before phase A moved
// to tensor cores (scan_common.cuh's mma_rows): dot_tile below, on rows
// staged as f32 (bf16) or int32 words (int8), f32 fmaf chains for bf16 and
// int32 __dp4a chains (written as f32) for int8. So it is no longer phase
// A's dot; its readings stay comparable with earlier ones.
//
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
// Q = 256 at the bf16 tensor-core peak); it computes on CUDA cores, so FMA
// throughput bounds it. stream_probe is bound by one read of x.
// Design: mini_scan runs the CUDA-core phase A's CTA shape (64 queries against a chunk of
// blocks inside one step; a 4x8 register tile a lane) with the mode's
// epilogue; in `none` mode the CTAs of one step meet through atomicMax on an
// order-preserving integer image of the float. stream_probe gives each tile
// to one CTA, as the TPU gave each tile one grid step: 512 threads read it
// with 16-byte loads, four in flight a thread, so the sweep over `tile`
// shows how the read rate depends on the work a CTA is given.
#include "blockmax.cuh"

namespace mst {

constexpr int STHREADS = 512;
constexpr int QT = 64;   // queries per mini_scan CTA
constexpr int RPT = 4;   // rows per lane
constexpr int QPW = 8;   // queries per warp

// How mini_scan stages and multiplies rows of T on CUDA cores.
template <class T>
struct Cc;

template <>
struct Cc<Bf16> {
  using In = Bf16::In;
  using Word = float;
  using Vec = float4;
  using Acc = float;
  static constexpr bool IS_INT = false;
  static constexpr int WORDS = DIM;          // staged words per row
  static constexpr int WPC = 8;              // words per 16-byte chunk
  static constexpr int PITCH = WORDS + 4;    // smem row pitch (words)
  __device__ static __forceinline__ Acc mac(Acc acc, Word a, Word b) {
    return fmaf(a, b, acc);
  }
  __device__ static __forceinline__ void unpack(uint4 v, Word* dst) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
};

template <>
struct Cc<Int8> {
  using In = Int8::In;
  using Word = int;
  using Vec = int4;
  using Acc = int;
  static constexpr bool IS_INT = true;
  static constexpr int WORDS = DIM / 4;
  static constexpr int WPC = 4;
  static constexpr int PITCH = WORDS + 4;
  __device__ static __forceinline__ Acc mac(Acc acc, Word a, Word b) {
    return __dp4a(a, b, acc);
  }
  __device__ static __forceinline__ void unpack(uint4 v, Word* dst) {
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(&v);
  }
};

// Stage `nrows` rows of a row-major [*, DIM] array, starting at row `row0`,
// into shared memory with pitch C::PITCH. Rows at or past `row_end` are
// zero-filled. Global reads are 16-byte loads, consecutive threads on
// consecutive addresses.
template <class C>
__device__ __forceinline__ void stage_rows(const typename C::In* __restrict__ src,
                                           long long row0, long long row_end,
                                           int nrows, typename C::Word* dst) {
  constexpr int CPR = DIM * (int)sizeof(typename C::In) / 16;  // chunks per row
  for (int c = threadIdx.x; c < nrows * CPR; c += blockDim.x) {
    const int r = c / CPR, k = c % CPR;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < row_end)
      v = reinterpret_cast<const uint4*>(src + (row0 + r) * DIM)[k];
    C::unpack(v, dst + r * C::PITCH + k * C::WPC);
  }
}

// acc[r][c] = sum over words w of x[r][w] * q[c][w], accumulated in word
// order by C::mac.
template <class C, int R, int N>
__device__ __forceinline__ void dot_tile(typename C::Acc (&acc)[R][N],
                                         const typename C::Word* const (&x)[R],
                                         const typename C::Word* const (&q)[N]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) acc[r][c] = 0;
#pragma unroll 1
  for (int w = 0; w < C::WORDS; w += 4) {
    typename C::Vec xv[R], qv[N];
#pragma unroll
    for (int r = 0; r < R; ++r)
      xv[r] = *reinterpret_cast<const typename C::Vec*>(x[r] + w);
#pragma unroll
    for (int c = 0; c < N; ++c)
      qv[c] = *reinterpret_cast<const typename C::Vec*>(q[c] + w);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c) {
        acc[r][c] = C::mac(acc[r][c], qv[c].x, xv[r].x);
        acc[r][c] = C::mac(acc[r][c], qv[c].y, xv[r].y);
        acc[r][c] = C::mac(acc[r][c], qv[c].z, xv[r].z);
        acc[r][c] = C::mac(acc[r][c], qv[c].w, xv[r].w);
      }
  }
}

// Signed integers in the order of the floats they stand for, so atomicMax
// on them is a max of the floats (no NaN here).
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
mini_scan_kernel(const typename T::In* __restrict__ q,
                 const typename T::In* __restrict__ db, float* __restrict__ out,
                 float* __restrict__ sink, int nq, int nbt, int chunk,
                 int slab_blocks, int reduce) {
  using Word = typename T::Word;
  using Acc = typename T::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  Word* qs = reinterpret_cast<Word*>(smem);  // [QT][PITCH]
  Word* xs = qs + QT * T::PITCH;             // [BLOCK][PITCH]
  __shared__ float warp_best[THREADS / 32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * QT;
  stage_rows<T>(q, q0, nq, QT, qs);
  const Word* const xr[RPT] = {xs + lane * T::PITCH, xs + (lane + 32) * T::PITCH,
                               xs + (lane + 64) * T::PITCH,
                               xs + (lane + 96) * T::PITCH};
  const Word* const qr[QPW] = {
      qs + (warp * QPW + 0) * T::PITCH, qs + (warp * QPW + 1) * T::PITCH,
      qs + (warp * QPW + 2) * T::PITCH, qs + (warp * QPW + 3) * T::PITCH,
      qs + (warp * QPW + 4) * T::PITCH, qs + (warp * QPW + 5) * T::PITCH,
      qs + (warp * QPW + 6) * T::PITCH, qs + (warp * QPW + 7) * T::PITCH};

  const long long b_begin = (long long)blockIdx.y * chunk;
  const long long step = b_begin / nbt;
  Acc best;
  if constexpr (T::IS_INT) best = INT_MASKED; else best = -INFINITY;
  float head[QPW];
#pragma unroll
  for (int c = 0; c < QPW; ++c) head[c] = -INFINITY;

  for (long long b = b_begin; b < b_begin + chunk; ++b) {
    __syncthreads();  // the previous block's rows are no longer read
    stage_rows<T>(db, b * BLOCK, (b + 1) * BLOCK, BLOCK, xs);
    __syncthreads();

    Acc acc[RPT][QPW];
    dot_tile<T, RPT, QPW>(acc, xr, qr);
    const int bi = (int)(b - step * nbt);  // block within the step
#pragma unroll
    for (int c = 0; c < QPW; ++c) {
      Acc m = acc[0][c];
#pragma unroll
      for (int r = 1; r < RPT; ++r) m = max(m, acc[r][c]);
      const int qi = q0 + warp * QPW + c;
      if (qi < nq) best = max(best, m);  // zero-filled query rows stay out
      if (reduce) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0 && qi < nq)
          out[(step * nq + qi) * nbt + bi] = (float)m;
      } else if (bi % slab_blocks == 0) {
        head[c] = fmaxf(head[c], (float)acc[0][c]);  // rows 0..7: lanes 0..7
      }
    }
  }

  if (!reduce && lane < 8) {
#pragma unroll
    for (int c = 0; c < QPW; ++c) {
      const int qi = q0 + warp * QPW + c;
      if (qi < nq)
        atomicMax(reinterpret_cast<int*>(out) + (step * nq + qi) * 8 + lane,
                  order_key(head[c]));
    }
  }
  float fb = (float)best;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    fb = fmaxf(fb, __shfl_xor_sync(0xffffffffu, fb, off));
  if (lane == 0) warp_best[warp] = fb;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) fb = fmaxf(fb, warp_best[w]);
    sink[(long long)blockIdx.y * gridDim.x + blockIdx.x] = fb;
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

template <class T>
cudaError_t launch_mini_scan(const void* q, const void* db, float* out,
                             float* sink, int nq, int nsteps, int nbt, int chunk,
                             int slab_blocks, int reduce, cudaStream_t stream) {
  using C = Cc<T>;
  const size_t smem = (size_t)(QT + BLOCK) * C::PITCH * sizeof(typename C::Word);
  cudaError_t err = allow_smem(mini_scan_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((nq + QT - 1) / QT, (unsigned)((long long)nsteps * nbt / chunk));
  mini_scan_kernel<C><<<grid, THREADS, smem, stream>>>(
      static_cast<const typename T::In*>(q), static_cast<const typename T::In*>(db),
      out, sink, nq, nbt, chunk, slab_blocks, reduce);
  return cudaGetLastError();
}

}  // namespace mst

// dtype: 0 = bf16, 1 = int8. out: [nsteps, nq, nbt] (reduce) or int32 keys
// [nsteps, nq, 8] preset to the key of -inf (none). sink: one float a CTA,
// [nsteps*nbt/chunk, ceil(nq/64)]. chunk divides nbt; slab_blocks divides nbt.
extern "C" int mst_mini_scan(int dtype, const void* q, const void* db, void* out,
                             void* sink, int nq, int nsteps, int nbt, int chunk,
                             int slab_blocks, int reduce, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  auto k = static_cast<float*>(sink);
  if (dtype == 0)
    return mst::launch_mini_scan<mst::Bf16>(q, db, o, k, nq, nsteps, nbt, chunk,
                                            slab_blocks, reduce, s);
  if (dtype == 1)
    return mst::launch_mini_scan<mst::Int8>(q, db, o, k, nq, nsteps, nbt, chunk,
                                            slab_blocks, reduce, s);
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
