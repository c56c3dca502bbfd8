// Shared pieces of the fused-scan kernels (phase A in blockmax.cuh, phase C
// in gather.cuh, and the launchers that run their CTA bodies).
//
// Phase A picks 128-row blocks by their maximum score and phase C ranks the
// rows of the picked blocks by their scores; the cover argument that makes
// the fused scan exact (ops/fused_scan.py) needs both phases to compute the
// SAME float for a (query, row) pair. So every score in both phases comes
// from `mma_rows` below: warp-level tensor-core products (bf16
// mma.m16n8k16 with f32 accumulators, int8 mma.m16n8k32 with s32), DB rows
// as the M operand (16 a fragment, a row in M slot row % 16: blocks are
// 128-row aligned), queries as the N operand (a query in N slot qi % 8 of
// its n-tile, in both phases), K = 128 dims in one fixed order of k-steps
// from a zero accumulator (8 in bf16, 4 in int8). The same instruction on
// the same operand positions gives the same bits; int8 sums are exact.
//
// Rows are staged in their stored dtype by cp.async (16 bytes a copy) into
// a ring of slots in shared memory, one 128-row block a slot, at a pitch of
// row bytes + 16, so that the eight 16-byte rows of an ldmatrix fall in
// distinct bank groups. Query fragments are loaded from device memory
// straight into registers (the B fragment layout is 4 bytes a thread).
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
  using Acc = float;
  static constexpr bool IS_INT = false;
  static constexpr int KSTEPS = DIM / 16;  // mma.m16n8k16 steps over K
  static constexpr int STAGES = 3;         // ring slots of phase A
  static constexpr int GSTAGES = 2;        // ring slots of phase C
  static constexpr int CTAS = 2;           // CTAs an SM phase A is built for
  __device__ static __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct Int8 {
  using In = int8_t;
  using Acc = int;
  static constexpr bool IS_INT = true;
  static constexpr int KSTEPS = DIM / 32;  // mma.m16n8k32 steps over K
  static constexpr int STAGES = 3;
  static constexpr int GSTAGES = 2;
  static constexpr int CTAS = 3;
  __device__ static __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// A ring slot: one block's rows at pitch ROWB + 16 bytes, then its 128
// length-channel values (tl) when the caller stages them.
template <class T>
struct Slot {
  static constexpr int ROWB = DIM * (int)sizeof(typename T::In);  // bytes a row
  static constexpr int PITCH = ROWB + 16;
  static constexpr int TL = BLOCK * PITCH;                         // tl offset
  static constexpr int BYTES = TL + BLOCK * (int)sizeof(float);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
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

// Issue the copies of block `b` (rows b*128 .. +127 of db, and tl's values
// for them when tl is non-null) into `slot`, spread over the CTA's threads.
// The caller commits the group.
template <class T>
__device__ __forceinline__ void load_block(unsigned char* slot,
                                           const typename T::In* __restrict__ db,
                                           const float* __restrict__ tl, long long b) {
  using S = Slot<T>;
  constexpr int CPR = S::ROWB / 16;  // 16-byte chunks a row
  const unsigned char* src = reinterpret_cast<const unsigned char*>(db + b * BLOCK * DIM);
  for (int c = threadIdx.x; c < BLOCK * CPR; c += blockDim.x)
    cp_async16(slot + (c / CPR) * S::PITCH + (c % CPR) * 16, src + c * 16);
  if (tl != nullptr)
    for (int c = threadIdx.x; c < BLOCK / 4; c += blockDim.x)
      cp_async16(slot + S::TL + c * 16, tl + b * BLOCK + c * 4);
}

// The B fragments of one n-tile of 8 queries over all of K: query row
// `qrow` (this lane's N slot is lane / 4) of q, or zeros where `valid` is
// false. b[s][0] holds bytes s*32 + (lane%4)*4 .. +3 of the row and b[s][1]
// the 4 bytes 16 further on: the m16n8k16 (bf16) and m16n8k32 (int8) B
// layouts are the same in bytes.
template <class T>
__device__ __forceinline__ void load_query_frag(uint32_t (&b)[T::KSTEPS][2],
                                                const typename T::In* __restrict__ q,
                                                long long qrow, bool valid) {
  const int tig = threadIdx.x & 3;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(q + qrow * DIM);
#pragma unroll
  for (int s = 0; s < T::KSTEPS; ++s) b[s][0] = b[s][1] = 0u;
  if (valid)
#pragma unroll
    for (int s = 0; s < T::KSTEPS; ++s) {
      b[s][0] = w[s * 8 + tig];
      b[s][1] = w[s * 8 + 4 + tig];
    }
}

// acc[j] = scores of the 16 rows at `rows` (shared memory, pitch
// Slot<T>::PITCH, 16-row aligned within its block) against n-tile j's
// queries, for j < ntv (NT n-tiles, B fragments in b): accumulators from
// zero, k-steps in order. Fragment layout (PTX ISA, mma m16n8k16 / k32):
// acc[j][0..1] are rows lane/4, columns (lane%4)*2 + 0..1; acc[j][2..3]
// rows lane/4 + 8. The only place any kernel of the scan computes a score.
template <class T, int NT>
__device__ __forceinline__ void mma_rows(typename T::Acc (&acc)[NT][4],
                                         const unsigned char* rows,
                                         const uint32_t (&b)[NT][T::KSTEPS][2], int ntv) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  // ldmatrix.x4: lanes 0-15 address rows 0-15 at bytes 0-15 of the k-step,
  // lanes 16-31 the same rows at bytes 16-31 (a0..a3 of the A layout)
  uint32_t addr = smem_addr(rows + (lane & 15) * Slot<T>::PITCH + (lane >> 4) * 16);
#pragma unroll
  for (int s = 0; s < T::KSTEPS; ++s, addr += 32) {
    uint32_t a[4];
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(addr));
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < ntv) T::mma(acc[j], a, b[j][s][0], b[j][s][1]);
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
