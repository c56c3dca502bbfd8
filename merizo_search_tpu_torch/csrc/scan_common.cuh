// Shared pieces of the fused-scan kernels (blockmax.cu, gather.cu).
//
// Phase A picks 128-row blocks by their maximum score and phase C ranks the
// rows of the picked blocks by their scores; the cover argument that makes
// the fused scan exact (ops/fused_scan.py) needs both phases to compute the
// SAME float for a (query, row) pair. So every score in both kernels is
// computed by `dot_tile` below, on rows staged by `stage_rows`, with one
// accumulation order: word 0 to word W-1, one `Traits::mac` per word.
//
// bf16: rows are staged as f32 (exact), and the score is a chain of 128
// fmaf's from 0.0f. int8: rows are staged as packed int32 words (4 values),
// and the score is a chain of 32 __dp4a's from 0 -- exact integer
// arithmetic, |score| <= 127*127*128 < 2^24.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mst {

constexpr int BLOCK = 128;              // rows per selection block
constexpr int DIM = 128;                // embedding width
constexpr float NEG_CAP = -3.4e38f;     // finite stand-in for -inf
constexpr int INT_MASKED = -2147483647; // masked int8 score, as in the JAX scan

struct Bf16 {
  using In = __nv_bfloat16;
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

struct Int8 {
  using In = int8_t;
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
// into shared memory with pitch T::PITCH. Rows at or past `row_end` are
// zero-filled. Global reads are 16-byte loads, consecutive threads on
// consecutive addresses.
template <class T>
__device__ __forceinline__ void stage_rows(const typename T::In* __restrict__ src,
                                           long long row0, long long row_end,
                                           int nrows, typename T::Word* dst) {
  constexpr int CPR = DIM * (int)sizeof(typename T::In) / 16;  // chunks per row
  for (int c = threadIdx.x; c < nrows * CPR; c += blockDim.x) {
    const int r = c / CPR, k = c % CPR;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < row_end)
      v = reinterpret_cast<const uint4*>(src + (row0 + r) * DIM)[k];
    T::unpack(v, dst + r * T::PITCH + k * T::WPC);
  }
}

// acc[r][c] = sum over words w of x[r][w] * q[c][w], accumulated in word
// order by T::mac. The only place either kernel computes a score.
template <class T, int R, int C>
__device__ __forceinline__ void dot_tile(typename T::Acc (&acc)[R][C],
                                         const typename T::Word* const (&x)[R],
                                         const typename T::Word* const (&q)[C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0;
#pragma unroll 1
  for (int w = 0; w < T::WORDS; w += 4) {
    typename T::Vec xv[R], qv[C];
#pragma unroll
    for (int r = 0; r < R; ++r)
      xv[r] = *reinterpret_cast<const typename T::Vec*>(x[r] + w);
#pragma unroll
    for (int c = 0; c < C; ++c)
      qv[c] = *reinterpret_cast<const typename T::Vec*>(q[c] + w);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[r][c] = T::mac(acc[r][c], qv[c].x, xv[r].x);
        acc[r][c] = T::mac(acc[r][c], qv[c].y, xv[r].y);
        acc[r][c] = T::mac(acc[r][c], qv[c].z, xv[r].z);
        acc[r][c] = T::mac(acc[r][c], qv[c].w, xv[r].w);
      }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace mst
