// Phase C launchers: the per-query kernel runs gather_body (gather.cuh, whose
// header says what it computes, which TPU kernels it replaces and what
// bounds it) once per CTA of a (queries, selected columns) grid; the
// block-major launch (the IVF's) inverts bidx into a CSR by block and runs
// gather_by_block / gather_by_block_f32 once per CTA of a grid over the
// distinct selected blocks. The bf16/int8 kernels read the DB through a TMA
// tensor map encoded here for each call (scan_common.cuh db_tensor_map).
#include <algorithm>

#include "gather.cuh"

namespace mst {

template <class T>
__global__ void __launch_bounds__(GTHREADS)
gather_kernel(const __grid_constant__ CUtensorMap map, const typename T::In* __restrict__ q,
              const float* __restrict__ tl, const float* __restrict__ qcap,
              const int* __restrict__ bidx, const float* __restrict__ scale_sel,
              const float* __restrict__ scales, float* __restrict__ out, int kb,
              long long n_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  gather_body<T>(smem, map, q, tl, qcap, bidx, scale_sel, scales, out, kb, n_valid, blockIdx.x,
                 blockIdx.y);
}

template <class T>
int launch_gather(const void* q, const void* db, int nb, const float* tl, const float* qcap,
                  const int* bidx, const float* scale_sel, const float* scales, float* out,
                  int nq, int kb, long long n_valid, cudaStream_t stream) {
  CUtensorMap map;
  const int rc = db_tensor_map<T>(&map, db, (long long)nb * BLOCK);
  if (rc != 0) return rc;
  const size_t smem = GatherSmem<T>::LAUNCH;
  cudaError_t err = allow_smem(gather_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, kb);
  gather_kernel<T><<<grid, GTHREADS, smem, stream>>>(
      map, static_cast<const typename T::In*>(q), tl, qcap, bidx, scale_sel, scales, out, kb,
      n_valid);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(GTHREADS)
gather_kernel_f32(const float* __restrict__ q, const float* __restrict__ db,
                  const float* __restrict__ tl, const float* __restrict__ qcap,
                  const int* __restrict__ bidx, const float* __restrict__ scale_sel,
                  const float* __restrict__ scales, float* __restrict__ out, int kb,
                  long long n_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  gather_cols_f32(smem, q, db, tl, qcap, bidx, scale_sel, scales, out, kb, n_valid,
                  blockIdx.x, blockIdx.y * F32_GROUP,
                  min(kb, ((int)blockIdx.y + 1) * F32_GROUP));
}

cudaError_t launch_gather_f32(const float* q, const float* db, const float* tl,
                              const float* qcap, const int* bidx, const float* scale_sel,
                              const float* scales, float* out, int nq, int kb,
                              long long n_valid, cudaStream_t stream) {
  const size_t smem = gather_f32_smem();
  cudaError_t err = allow_smem(gather_kernel_f32, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, (kb + F32_GROUP - 1) / F32_GROUP);
  gather_kernel_f32<<<grid, GTHREADS, smem, stream>>>(q, db, tl, qcap, bidx, scale_sel,
                                                      scales, out, kb, n_valid);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The block-major launch. The inversion is a counting sort of the M = Q*KB
// entries of bidx by (bucket, residue), all on the stream, with no sync:
//   1. zero the histogram and the header;
//   2. bb_count: one thread an entry, atomicAdd on its (bucket, residue);
//   3. bb_alloc: one thread a bucket; each nonempty bucket takes a range of
//      the list (one atomicAdd a warp on hdr[1]) and its offsets, the cursor
//      is set to them, and each nonempty block takes a place in dist (one
//      atomicAdd a warp on hdr[0]);
//   4. bb_count again, scattering: each entry takes a place in its list
//      (atomicAdd on the cursor).
// Then the scoring kernel on min(nb, M) + ceil(M / PAD_SLOTS) CTAs: one a
// distinct block, the rest fill the padding list. Padding can be most of
// the slots (a mesh shard's probe: the other shards' clusters are -1), so
// the padding list gets CTAs by M, each writing at most PAD_SLOTS slots;
// where there is no padding they find an empty list and exit.

constexpr int COUNT_THREADS = 256;
constexpr int PAD_SLOTS = 64;

__global__ void __launch_bounds__(COUNT_THREADS)
bb_count(const int* __restrict__ bidx, int* __restrict__ cnt, int* __restrict__ list, int kb,
         int m, int nb, bool scatter) {
  const int i = blockIdx.x * COUNT_THREADS + threadIdx.x;
  if (i >= m) return;
  int b = bidx[i];
  if (b < 0 || b >= nb) b = nb;
  int* c = cnt + b * RES + (i / kb) % RES;
  if (scatter)
    list[atomicAdd(c, 1)] = i;
  else
    atomicAdd(c, 1);
}

__global__ void __launch_bounds__(COUNT_THREADS)
bb_alloc(int* __restrict__ cnt, int* __restrict__ off, int* __restrict__ dist,
         int* __restrict__ hdr, int nb) {
  const int b = blockIdx.x * COUNT_THREADS + threadIdx.x, lane = threadIdx.x & 31;
  int c[RES], tot = 0;
  int4 lo = make_int4(0, 0, 0, 0), hi = lo;
  if (b <= nb) {
    lo = reinterpret_cast<const int4*>(cnt + b * RES)[0];
    hi = reinterpret_cast<const int4*>(cnt + b * RES)[1];
  }
  c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
  c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
#pragma unroll
  for (int r = 0; r < RES; ++r) tot += c[r];
  int incl = tot;  // the warp's ranges side by side: one atomicAdd a warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += a;
  }
  int base = 0;
  if (lane == 31 && incl > 0) base = atomicAdd(&hdr[1], incl);
  base = __shfl_sync(0xffffffffu, base, 31);
  const bool used = b < nb && tot > 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, used);
  int dbase = 0;
  if (lane == 0 && ballot) dbase = atomicAdd(&hdr[0], __popc(ballot));
  dbase = __shfl_sync(0xffffffffu, dbase, 0);
  if (used) dist[dbase + __popc(ballot & ((1u << lane) - 1u))] = b;
  if (b > nb) return;
  int o = base + incl - tot, cur[RES];
#pragma unroll
  for (int r = 0; r < RES; ++r) {
    off[b * (RES + 1) + r] = cur[r] = o;
    o += c[r];
  }
  off[b * (RES + 1) + RES] = o;
  reinterpret_cast<int4*>(cnt + b * RES)[0] = make_int4(cur[0], cur[1], cur[2], cur[3]);
  reinterpret_cast<int4*>(cnt + b * RES)[1] = make_int4(cur[4], cur[5], cur[6], cur[7]);
}

cudaError_t invert_blocks(const int* bidx, int* ws, int nq, int kb, int nb,
                          cudaStream_t stream) {
  const long long m = (long long)nq * kb;
  long long sec[5];
  by_block_ws(nb, m, sec);
  int* cnt = ws + sec[0];
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * (sec[2] - sec[0]), stream);
  if (err != cudaSuccess) return err;
  const int grid = (int)((m + COUNT_THREADS - 1) / COUNT_THREADS);
  if (grid > 0) {
    bb_count<<<grid, COUNT_THREADS, 0, stream>>>(bidx, cnt, ws + sec[4], kb, (int)m, nb, false);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  bb_alloc<<<(nb + COUNT_THREADS) / COUNT_THREADS, COUNT_THREADS, 0, stream>>>(
      cnt, ws + sec[2], ws + sec[3], ws + sec[1], nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (grid > 0)
    bb_count<<<grid, COUNT_THREADS, 0, stream>>>(bidx, cnt, ws + sec[4], kb, (int)m, nb, true);
  return cudaGetLastError();
}

template <class T>
__global__ void __launch_bounds__(GTHREADS, BB_CTAS<T>)
gather_by_block_kernel(const __grid_constant__ CUtensorMap map,
                       const typename T::In* __restrict__ q, const float* __restrict__ tl,
                       const float* __restrict__ qcap, const float* __restrict__ scale_sel,
                       const float* __restrict__ scales, float* __restrict__ out, int kb,
                       long long n_valid, ByBlock cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  gather_by_block<T>(smem, map, q, tl, qcap, scale_sel, scales, out, kb, n_valid, cs);
}

__global__ void __launch_bounds__(GTHREADS)
gather_by_block_kernel_f32(const float* __restrict__ q, const float* __restrict__ db,
                           const float* __restrict__ tl, const float* __restrict__ qcap,
                           const float* __restrict__ scale_sel,
                           const float* __restrict__ scales, float* __restrict__ out, int kb,
                           long long n_valid, ByBlock cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  gather_by_block_f32(smem, q, db, tl, qcap, scale_sel, scales, out, kb, n_valid, cs);
}

template <class K, class... A>
cudaError_t launch_by_block(K kernel, size_t smem, int grid, cudaStream_t stream, A... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, GTHREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace mst

// Workspace of mst_gather_by_block / mst_invert_blocks in int32s, for nb
// blocks and m = Q*KB entries; with `sec` non-null, the offsets of its
// five sections (cnt, hdr, off, dist, list) go there.
extern "C" long long mst_by_block_ws(int nb, long long m, long long* sec) {
  return mst::by_block_ws(nb, m, sec);
}

// The inversion alone (the CSR in `ws`), for tests and diagnostics.
extern "C" int mst_invert_blocks(const void* bidx, void* ws, int nq, int kb, int nb,
                                 void* stream) {
  return mst::invert_blocks(static_cast<const int*>(bidx), static_cast<int*>(ws), nq, kb,
                            nb, static_cast<cudaStream_t>(stream));
}

// Block-major phase C: mst_gather_block_scores's contract (dtype, scale
// modes, masks, output), db of nb = Npad/128 blocks, `ws` a workspace of
// mst_by_block_ws(nb, nq*kb) int32s. Returns as mst_gather_block_scores.
extern "C" int mst_gather_by_block(int dtype, const void* q, const void* db, const void* tl,
                                   const void* qcap, const void* bidx, const void* scale_sel,
                                   const void* scales, void* out, void* ws, int nq, int kb,
                                   int nb, long long n_valid, void* stream) {
  using namespace mst;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  int* w = static_cast<int*>(ws);
  cudaError_t err = invert_blocks(static_cast<const int*>(bidx), w, nq, kb, nb, s);
  if (err != cudaSuccess) return err;
  const long long m = (long long)nq * kb;
  long long sec[5];
  by_block_ws(nb, m, sec);
  const ByBlock cs{w + sec[2], w + sec[3], w + sec[1], w + sec[4], nb};
  auto o = static_cast<float*>(out);
  const int grid = (int)(std::min<long long>(nb, m) + (m + PAD_SLOTS - 1) / PAD_SLOTS);
  CUtensorMap map;
  if (dtype == 0 || dtype == 1) {
    const int rc = dtype == 0 ? db_tensor_map<Bf16>(&map, db, (long long)nb * BLOCK)
                              : db_tensor_map<Int8>(&map, db, (long long)nb * BLOCK);
    if (rc != 0) return rc;
  }
  if (dtype == 0)
    return launch_by_block(gather_by_block_kernel<Bf16>, ByBlockSmem<Bf16>::LAUNCH, grid, s,
                           map, static_cast<const __nv_bfloat16*>(q), f(tl), f(qcap),
                           f(scale_sel), f(scales), o, kb, n_valid, cs);
  if (dtype == 1)
    return launch_by_block(gather_by_block_kernel<Int8>, ByBlockSmem<Int8>::LAUNCH, grid, s,
                           map, static_cast<const int8_t*>(q), f(tl), f(qcap), f(scale_sel),
                           f(scales), o, kb, n_valid, cs);
  if (dtype == 2)
    return launch_by_block(gather_by_block_kernel_f32, by_block_f32_smem(), grid, s, f(q),
                           f(db), f(tl), f(qcap), f(scale_sel), f(scales), o, kb, n_valid, cs);
  return cudaErrorInvalidValue;
}

// dtype: 0 = bf16, 1 = int8, 2 = f32. db: nb blocks. tl/qcap: both or
// neither. At most one of scale_sel / scales is non-null. Returns 0, a
// cudaError_t, or mst::ERR_TMAP + the tensor-map encode's CUresult.
extern "C" int mst_gather_block_scores(int dtype, const void* q, const void* db,
                                       const void* tl, const void* qcap,
                                       const void* bidx, const void* scale_sel,
                                       const void* scales, void* out, int nq,
                                       int kb, int nb, long long n_valid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto ib = static_cast<const int*>(bidx);
  auto o = static_cast<float*>(out);
  if (dtype == 0)
    return mst::launch_gather<mst::Bf16>(q, db, nb, f(tl), f(qcap), ib, f(scale_sel),
                                         f(scales), o, nq, kb, n_valid, s);
  if (dtype == 1)
    return mst::launch_gather<mst::Int8>(q, db, nb, f(tl), f(qcap), ib, f(scale_sel),
                                         f(scales), o, nq, kb, n_valid, s);
  if (dtype == 2)
    return mst::launch_gather_f32(f(q), f(db), f(tl), f(qcap), ib, f(scale_sel),
                                  f(scales), o, nq, kb, n_valid, s);
  return cudaErrorInvalidValue;
}

// The per-query phase-C body's shared-memory layout as the kernel is built
// with it (GatherSmem<T>, gather.cuh), for dtype 0 = bf16 / 1 = int8:
// out[0..4] = the offsets BT, TL, BAR, the layout's bytes and the launch's
// (with the alignment slack). Returns 0 or cudaErrorInvalidValue. Host only.
extern "C" int mst_gather_layout(int dtype, int* out) {
  auto fill = [&](auto t) {
    using L = mst::GatherSmem<decltype(t)>;
    const int v[5] = {L::BT, L::TL, L::BAR, L::BYTES, L::LAUNCH};
    for (int i = 0; i < 5; ++i) out[i] = v[i];
    return 0;
  };
  if (dtype == 0) return fill(mst::Bf16{});
  if (dtype == 1) return fill(mst::Int8{});
  return cudaErrorInvalidValue;
}
