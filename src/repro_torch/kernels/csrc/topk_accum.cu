// Sparse scatter-accumulate: dense[row, idx[row, j]] += vals[row, j], in
// place -- the per-hop combine of the top-k sparse all-reduce and its
// decompress.  The rank dims are folded into rows: dense is [rows, size],
// idx and vals are [rows, k], and row r adds into dense[r].
//
// Replaces the Pallas kernel repro/kernels/topk_accum.py:topk_accumulate.
// Bound: device memory, k * rows * (4 idx + 4 val) bytes read plus 4
// bytes read and 4 written in dense per entry -- a few tens of MB for a
// 1% payload, against 2 * 4 * size bytes for touching the whole dense row.
// Design: one thread per payload entry, one atomicAdd each, so the kernel
// touches only the lanes the payload names.  The TPU kernel's one-hot MXU
// matmul (K * size multiply-adds, a workaround for a TPU without scatter)
// is not carried over.  Out-of-range indices (negative or >= size) are
// dropped, as the one-hot product drops them.
//
// Order: an atomicAdd rounds like one f32 add.  Top-k indices are distinct
// within a row, so every lane gets at most one add per launch and the
// result equals index_add bit for bit; duplicate indices accumulate in an
// order the hardware picks, so they agree only to f32 rounding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void topk_accumulate_kernel(float* __restrict__ dense, const int32_t* __restrict__ idx,
                                       const float* __restrict__ vals, int64_t size, int64_t k,
                                       int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int64_t j = idx[t];
    if (j < 0 || j >= size) continue;
    atomicAdd(dense + (t / k) * size + j, vals[t]);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  dense is
// [rows, size] f32, idx [rows, k] int32 and vals [rows, k] f32, all
// contiguous (the wrapper checks).
extern "C" int acis_topk_accumulate(void* dense, const void* idx, const void* vals, int64_t rows,
                                    int64_t size, int64_t k, void* stream) {
  const int64_t total = rows * k;
  if (total <= 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32 blocks per SM
  topk_accumulate_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dense), static_cast<const int32_t*>(idx),
      static_cast<const float*>(vals), size, k, total);
  return (int)cudaGetLastError();
}
