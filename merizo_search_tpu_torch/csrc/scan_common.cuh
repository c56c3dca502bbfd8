// Shared pieces of the fused-scan kernels (phase A in blockmax.cuh, phase C
// in gather.cuh, and the launchers that run their CTA bodies), written for
// Hopper (sm_90a): TMA loads into mbarrier-guarded shared-memory slots, and
// every score from one warpgroup tensor-core routine (wgmma).
//
// The cover argument. Phase A picks 128-row blocks by their maximum score
// and phase C ranks the rows of the picked blocks by their scores; the fused
// scan is exact (ops/fused_scan.py) only while both phases compute the SAME
// float for a (query, row) pair. So every score of both phases comes from
// `score_issue` below, and it rests on:
//   - one instruction family: wgmma.mma_async m64nNk16 bf16 -> f32, or
//     m64nNk32 s8 -> s32, DB rows as the A operand (64 rows: a 64-row half
//     of a 128-row block, a row in M slot row % 64) and queries as the B
//     operand, both read from shared memory by descriptors, both K-major;
//   - K = 128 in one fixed order of k-steps (8 in bf16, 4 in int8) from a
//     zero accumulator: the first k-step runs with scale-d 0;
//   - a query in N slot qi % 8 of its n8 chunk in every kernel (phase A's
//     tile starts at a multiple of 32; phase C puts the query in slot qi % 8
//     of an 8- or 16-wide tile and zeros, or other queries, elsewhere).
// Int8 sums are exact integers whatever the instruction. Bf16 sums are the
// tensor core's f32 accumulation of the same products in the same k-step
// order; the width N of the instruction differs between the phases (32-256
// in phase A, 8 or 16 in phase C), and each output element is its own dot
// product, so the bits do not depend on N or on the other columns. The card
// checks this exactly: chip_smoke.py's cover rows and
// tests/test_torch_kernels_gpu.py's cover tests, at every tile width.
//
// Accumulator layout (PTX ISA, wgmma m64nN f32/s32): warp w of the
// warpgroup holds rows w*16 + lane/4 and +8 of the 64; for n8 chunk j its
// registers d[4j + 0..1] are row lane/4, columns j*8 + (lane%4)*2 + 0..1,
// and d[4j + 2..3] row lane/4 + 8, the same columns: the m16n8 accumulator
// fragment of the warp-level instructions, once per chunk.
//
// Shared-memory layout: 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B and
// descriptor layout 1). A row is cut into 128-byte atoms (bf16: two of 64
// dims, int8: one of 128); the rows of one atom column lie 128 bytes apart,
// so 8 rows make one 1024-byte swizzle period (the descriptor's SBO), and
// every atom column starts 1024-byte aligned. Within an atom the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8). A k-step (32 bytes) advances
// the descriptor's start address by 32 bytes inside the atom. A staged
// block is its atom columns one after another (Slot<T>); a query tile the
// same with its own row count. TMA writes the DB blocks; the kernels write
// query tiles with plain stores in the same pattern (stage_row_chunk).
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums; the encode is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mst {

constexpr int BLOCK = 128;              // rows per selection block
constexpr int DIM = 128;                // embedding width
constexpr float NEG_CAP = -3.4e38f;     // finite stand-in for -inf
constexpr int INT_MASKED = -2147483647; // masked int8 score, as in the JAX scan
constexpr int ATOM_B = 128;             // bytes of a row in one swizzle atom
constexpr int SW_PERIOD = 1024;         // 8 rows of an atom: the swizzle period (SBO)
constexpr int HALF = 64;                // rows of one wgmma (a block's half)
constexpr int TL_BYTES = BLOCK * 4;     // a block's length-channel values
constexpr int ERR_TMAP = 100000;        // launcher codes past this: ERR_TMAP + the CUresult
// Shared memory on an H100 (sm_90): a CTA's most dynamic shared memory
// (227 KB), an SM's (228 KB), and what the system reserves of it a CTA.
constexpr int SMEM_CTA = 232448;
constexpr int SMEM_SM = 233472;
constexpr int SMEM_RESERVED = 1024;

// Per-dtype constants. STAGES: phase A's ring slots (blockmax.cuh says why).
struct Bf16 {
  using In = __nv_bfloat16;
  using Acc = float;
  static constexpr bool IS_INT = false;
  static constexpr int ATOMS = 2;     // 128-byte atom columns a row
  static constexpr int KSTEPS = 8;    // k16 steps over K
  static constexpr int STAGES = 4;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

struct Int8 {
  using In = int8_t;
  using Acc = int;
  static constexpr bool IS_INT = true;
  static constexpr int ATOMS = 1;
  static constexpr int KSTEPS = 4;    // k32 steps
  static constexpr int STAGES = 8;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// A staged block: ATOMS atom columns of 128 rows x 128 bytes, 1024-aligned.
template <class T>
struct Slot {
  static constexpr int ROWB = DIM * (int)sizeof(typename T::In);  // bytes a row
  static constexpr int CHUNKS = ROWB / 16;                         // 16-byte chunks a row
  static constexpr int ATOM = BLOCK * ATOM_B;                      // an atom column's bytes
  static constexpr int BYTES = T::ATOMS * ATOM;
  static constexpr int KPA = T::KSTEPS / T::ATOMS;                 // k-steps an atom
};

__host__ __device__ constexpr int round_up(int x, int a) { return (x + a - 1) / a * a; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The dynamic shared memory rounded up to the 1024-byte swizzle period
// (launchers ask for 1024 bytes more than a layout's size).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (round_up((int)a, SW_PERIOD) - (int)a);
}

// ---- mbarriers ------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes mbar_init visible to the async proxy (TMA) and the other threads;
// a CTA barrier follows before anyone waits.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of TMA writes before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed: a barrier's n-th
// completion (n = 0, 1, ...) is the phase of parity n & 1.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(a), "r"(parity)
                 : "memory");
}

// A barrier of `count` threads (a multiple of 32) on hardware barrier `id`
// (1-15; 0 is __syncthreads): lets a warpgroup meet without the others.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Plain stores to shared memory made visible to the async proxy (wgmma,
// TMA); the writers run it before the barrier the readers wait on.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA ------------------------------------------------------------------
__device__ __forceinline__ void tma_prefetch(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map)) : "memory");
}

// A 2-D box of `map` at (x elements, y rows) into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, uint64_t* bar,
                                         int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into dst, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Block b of the DB (rows b*128 .. +127) into `slot`, and with tl non-null
// its 128 length-channel values into tls, all completing on bar (one
// arrival, which also expects `extra_tx` bytes of copies the caller issues
// on bar next). One thread calls it.
template <class T>
__device__ __forceinline__ void load_block(unsigned char* slot, float* tls, const CUtensorMap& map,
                                           const float* __restrict__ tl, long long b,
                                           uint64_t* bar, int extra_tx = 0) {
  mbar_expect_tx(bar, Slot<T>::BYTES + (tl != nullptr ? TL_BYTES : 0) + extra_tx);
#pragma unroll
  for (int a = 0; a < T::ATOMS; ++a)
    tma_load(slot + a * Slot<T>::ATOM, map, bar, a * (ATOM_B / (int)sizeof(typename T::In)),
             (int)(b * BLOCK));
  if (tl != nullptr) bulk_load(tls, tl + b * BLOCK, TL_BYTES, bar);
}

// Byte offset of 16-byte chunk c of row r in a tile of `rows` rows (atom
// pitch rows*128) in the swizzled layout.
__device__ __forceinline__ int sw_chunk(int rows, int r, int c) {
  const int a = c / (ATOM_B / 16), k = c % (ATOM_B / 16);
  return a * rows * ATOM_B + r * ATOM_B + ((k ^ (r & 7)) * 16);
}

// 16-byte chunk c of row r of a tile of `rows` rows at dst, in the
// swizzled layout: the row's bytes c*16 .. +15 from src, or zeros where src
// is null.
template <class T>
__device__ __forceinline__ void stage_row_chunk(unsigned char* dst, int rows, int r, int c,
                                                const typename T::In* src) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (src != nullptr) v = reinterpret_cast<const uint4*>(src)[c];
  *reinterpret_cast<uint4*>(dst + sw_chunk(rows, r, c)) = v;
}

// ---- wgmma ----------------------------------------------------------------
// Descriptor of a K-major operand in the 128-byte swizzle at shared address
// `addr` (1024-aligned, plus a k-step's 32-byte offsets): start address,
// LBO 1 (unused by swizzled K-major layouts), SBO 1024, layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(SW_PERIOD >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Pins an accumulator's registers at this point of the program: after
// wgmma_wait, so that no read of them moves above the wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// One wgmma of width N: d (+)= A[64 x k-step] . B[N x k-step]^T, scale_d 0
// starting from zero. Specialised below for each (dtype, N) the kernels use.
template <class T, int N>
__device__ __forceinline__ void wgmma(typename T::Acc (&d)[N / 2], uint64_t a, uint64_t b,
                                      int scale_d);

#define MST_DF4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MST_DR4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])

template <>
__device__ __forceinline__ void wgmma<Bf16, 8>(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}"
      ", %4, %5, p, 1, 1, 0, 0;\n}\n"
      : MST_DF4(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Bf16, 16>(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1, 0, 0;\n}\n"
      : MST_DF4(0), MST_DF4(4)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Bf16, 32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : MST_DF4(0), MST_DF4(4), MST_DF4(8), MST_DF4(12)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Bf16, 64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MST_DF4(0), MST_DF4(4), MST_DF4(8), MST_DF4(12),
        MST_DF4(16), MST_DF4(20), MST_DF4(24), MST_DF4(28)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Bf16, 128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : MST_DF4(0), MST_DF4(4), MST_DF4(8), MST_DF4(12),
        MST_DF4(16), MST_DF4(20), MST_DF4(24), MST_DF4(28),
        MST_DF4(32), MST_DF4(36), MST_DF4(40), MST_DF4(44),
        MST_DF4(48), MST_DF4(52), MST_DF4(56), MST_DF4(60)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Bf16, 256>(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : MST_DF4(0), MST_DF4(4), MST_DF4(8), MST_DF4(12),
        MST_DF4(16), MST_DF4(20), MST_DF4(24), MST_DF4(28),
        MST_DF4(32), MST_DF4(36), MST_DF4(40), MST_DF4(44),
        MST_DF4(48), MST_DF4(52), MST_DF4(56), MST_DF4(60),
        MST_DF4(64), MST_DF4(68), MST_DF4(72), MST_DF4(76),
        MST_DF4(80), MST_DF4(84), MST_DF4(88), MST_DF4(92),
        MST_DF4(96), MST_DF4(100), MST_DF4(104), MST_DF4(108),
        MST_DF4(112), MST_DF4(116), MST_DF4(120), MST_DF4(124)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Int8, 8>(int (&d)[4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}"
      ", %4, %5, p;\n}\n"
      : MST_DR4(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Int8, 16>(int (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p;\n}\n"
      : MST_DR4(0), MST_DR4(4)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Int8, 32>(int (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p;\n}\n"
      : MST_DR4(0), MST_DR4(4), MST_DR4(8), MST_DR4(12)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Int8, 64>(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p;\n}\n"
      : MST_DR4(0), MST_DR4(4), MST_DR4(8), MST_DR4(12),
        MST_DR4(16), MST_DR4(20), MST_DR4(24), MST_DR4(28)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Int8, 128>(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p;\n}\n"
      : MST_DR4(0), MST_DR4(4), MST_DR4(8), MST_DR4(12),
        MST_DR4(16), MST_DR4(20), MST_DR4(24), MST_DR4(28),
        MST_DR4(32), MST_DR4(36), MST_DR4(40), MST_DR4(44),
        MST_DR4(48), MST_DR4(52), MST_DR4(56), MST_DR4(60)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<Int8, 256>(int (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", %128, %129, p;\n}\n"
      : MST_DR4(0), MST_DR4(4), MST_DR4(8), MST_DR4(12),
        MST_DR4(16), MST_DR4(20), MST_DR4(24), MST_DR4(28),
        MST_DR4(32), MST_DR4(36), MST_DR4(40), MST_DR4(44),
        MST_DR4(48), MST_DR4(52), MST_DR4(56), MST_DR4(60),
        MST_DR4(64), MST_DR4(68), MST_DR4(72), MST_DR4(76),
        MST_DR4(80), MST_DR4(84), MST_DR4(88), MST_DR4(92),
        MST_DR4(96), MST_DR4(100), MST_DR4(104), MST_DR4(108),
        MST_DR4(112), MST_DR4(116), MST_DR4(120), MST_DR4(124)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef MST_DF4
#undef MST_DR4

// THE score routine: issue acc = scores of the 64 rows at shared address
// `a` (a block half; atom pitch a_pitch) against the N query rows at `b`
// (atom pitch b_pitch), all k-steps in order from zero, and commit them as
// one group. The caller waits (wgmma_wait, then fence_acc) before it reads
// acc, and keeps the rows and queries in place until then. Every bf16/int8
// score of the scan's kernels comes from here.
template <class T, int N>
__device__ __forceinline__ void score_issue(typename T::Acc (&acc)[N / 2], uint32_t a,
                                            uint32_t a_pitch, uint32_t b, uint32_t b_pitch) {
  constexpr int KPA = Slot<T>::KPA;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < T::KSTEPS; ++s) {
    const uint32_t off = (s % KPA) * 32;
    wgmma<T, N>(acc, sw128_desc(a + (s / KPA) * a_pitch + off),
                sw128_desc(b + (s / KPA) * b_pitch + off), s > 0);
  }
  wgmma_commit();
}

// ---- host ----------------------------------------------------------------
// Opt a kernel into more than 48 KB of dynamic shared memory.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The DB [rows, 128] of dtype T as a TMA tensor map: boxes of one atom
// column (128 bytes) by 128 rows, 128-byte swizzle. cuTensorMapEncodeTiled is
// a driver function; it is looked up through the runtime
// (cudaGetDriverEntryPoint), so the library links no libcuda and needs no
// driver stub at build time. Returns 0, a cudaError_t, or ERR_TMAP + the
// encode's CUresult.
template <class T>
inline int db_tensor_map(CUtensorMap* map, const void* db, long long rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = []() -> Encode {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn) : nullptr;
  }();
  if (encode == nullptr) return ERR_TMAP + CUDA_ERROR_NOT_FOUND;
  if (rows <= 0 || rows % BLOCK) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)DIM, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Slot<T>::ROWB};
  const cuuint32_t box[2] = {(cuuint32_t)(ATOM_B / sizeof(typename T::In)), (cuuint32_t)BLOCK};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, T::TMA_TYPE, 2, const_cast<void*>(db), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TMAP + (int)r;
}

}  // namespace mst
