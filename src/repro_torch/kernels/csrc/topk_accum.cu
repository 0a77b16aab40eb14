// Sparse scatter-accumulate: dense[row, idx[row, j]] += vals[row, j], in
// place -- the per-hop combine of the top-k sparse all-reduce and its
// decompress.  The rank dims are folded into rows: dense is [rows, size],
// idx and vals are [rows, k], and row r adds into dense[r].
//
// Replaces the Pallas kernel repro/kernels/topk_accum.py:topk_accumulate.
// The TPU kernel's one-hot MXU matmul (K * size multiply-adds, a
// workaround for a TPU without scatter) is not carried over: each payload
// entry is one red.global.add.f32 (an atomicAdd whose result is unused),
// so the kernel touches only the lanes the payload names.  Out-of-range
// indices (negative or >= size) are dropped, as the one-hot product drops
// them.
//
// Bound on the card: device memory.  By the measurement rule (each lane
// read and written once) k * rows * (4 idx + 4 val + 4 + 4) bytes; but the
// card moves 32-byte sectors, and at 1% density almost every entry of an
// accumulator larger than L2 is a sector of its own, read from HBM and
// written back, at a random place: chip_smoke.py's sector_bound_ms counts
// 64 bytes for each distinct sector the payload touches.  What limits the
// kernel is that random read-modify-write: tools/probe_topk.py shows a
// payload sorted by index (the best any address order can give) only about
// 1.1x faster, and a binned form (a counting sort of the payload by address
// window first, tools/topk_candidates.cu) slower, so the kernel scatters
// the payload in the order it comes.
//
// Design: a 2-D grid (tiles of a row x rows) with int32 index arithmetic;
// each thread loads kUnroll groups of kVec entries, then issues their
// reductions.  The launch shape (the ACIS_TOPK_* macros) was chosen with
// tools/probe_topk.py: one entry a thread, 4-byte loads; 16-byte loads of
// 4 entries (kVec 4, where k is a multiple of 4) and more entries in
// flight a thread measured no faster.
//
// Order: an atomicAdd rounds like one f32 add.  Top-k indices are distinct
// within a row, so every lane gets at most one add per call and the result
// equals index_add bit for bit; duplicate indices accumulate in an order the
// hardware picks, so they agree only to f32 rounding.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ACIS_TOPK_THREADS
#define ACIS_TOPK_THREADS 256
#endif
#ifndef ACIS_TOPK_UNROLL
#define ACIS_TOPK_UNROLL 1  // groups of entries a thread loads before its reductions
#endif
#ifndef ACIS_TOPK_VEC
#define ACIS_TOPK_VEC 1     // entries a load: 4 (16-byte loads) or 1
#endif

namespace {

constexpr int kThreads = ACIS_TOPK_THREADS;
constexpr int kUnroll = ACIS_TOPK_UNROLL;
constexpr int kVec = ACIS_TOPK_VEC;
constexpr int kMaxGridY = 65535;
static_assert(kVec == 1 || kVec == 4, "entries a load");

__device__ __forceinline__ bool in_range(int32_t j, int64_t size) { return j >= 0 && j < size; }

// W entries a load: 4 (16-byte loads; k % 4 == 0 and 16-byte aligned rows) or 1.
template <int W>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(float* __restrict__ dense, const int32_t* __restrict__ idx,
                   const float* __restrict__ vals, int64_t size, int k, int rows) {
  constexpr int kStep = kThreads * W;
  const int first = blockIdx.x * (kStep * kUnroll) + threadIdx.x * W;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int32_t* ir = idx + (int64_t)row * k;
    const float* vr = vals + (int64_t)row * k;
    float* d = dense + (int64_t)row * size;
    int32_t j[kUnroll][W];
    float v[kUnroll][W];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = first + u * kStep;
      if (e < k) {  // a whole group lies inside the row
        if constexpr (W == 4) {
          const int4 i4 = *reinterpret_cast<const int4*>(ir + e);
          const float4 v4 = *reinterpret_cast<const float4*>(vr + e);
          j[u][0] = i4.x, j[u][1] = i4.y, j[u][2] = i4.z, j[u][3] = i4.w;
          v[u][0] = v4.x, v[u][1] = v4.y, v[u][2] = v4.z, v[u][3] = v4.w;
        } else {
          j[u][0] = ir[e];
          v[u][0] = vr[e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int q = 0; q < W; ++q)
        if (first + u * kStep < k && in_range(j[u][q], size)) atomicAdd(d + j[u][q], v[u][q]);
  }
}

template <int W>
int launch_scatter(float* dense, const int32_t* idx, const float* vals, int64_t rows,
                   int64_t size, int k, cudaStream_t s) {
  const int64_t per_block = (int64_t)kThreads * W * kUnroll;
  const dim3 grid((unsigned)((k + per_block - 1) / per_block),
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  scatter_kernel<W><<<grid, kThreads, 0, s>>>(dense, idx, vals, size, k, (int)rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  dense is
// [rows, size] f32, idx [rows, k] int32 and vals [rows, k] f32, all
// contiguous on CUDA device `device` (the wrapper checks); k < 2^31 -
// 2^16, rows < 2^31.
extern "C" int acis_topk_accumulate(void* dense, const void* idx, const void* vals, int64_t rows,
                                    int64_t size, int64_t k, int device, void* stream) {
  if (rows <= 0 || k <= 0 || size <= 0) return 0;
  if (k >= INT32_MAX - 65536 || rows >= INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(dense);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const float* v = static_cast<const float*>(vals);
  const bool vec = kVec == 4 && k % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  int prev = device;  // launch with `device` current, then restore the caller's
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int rc = vec ? launch_scatter<4>(d, i, v, rows, size, (int)k, s)
                     : launch_scatter<1>(d, i, v, rows, size, (int)k, s);
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
