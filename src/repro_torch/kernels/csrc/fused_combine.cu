// Hop combine: out = combine(x, y) elementwise over flat contiguous
// operands — the per-hop aggregation of every ring reduce-scatter /
// all-reduce hop (one launch covers the hop of every rank).
//
// Replaces the Pallas kernel repro/kernels/fused_combine.py:fused_combine.
// Bound: device memory, 3 * numel * itemsize bytes (two reads, one write)
// against a handful of ALU ops per element.  Design: a grid-stride loop of
// 16-byte vector loads/stores over the aligned body (4 f32, 8 bf16 or 16
// int8 lanes per thread per step) and a scalar tail; no padding copies and
// no [rows, 128] reshape as the TPU kernel needs.
#include "combine.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int OP>
__global__ void combine_kernel(const T* __restrict__ x, const T* __restrict__ y,
                               T* __restrict__ out, int64_t n, float alpha, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t nvec = vec ? n / V : 0;
  for (int64_t i = tid; i < nvec; i += stride) {
    uint4 xa = reinterpret_cast<const uint4*>(x)[i];
    uint4 ya = reinterpret_cast<const uint4*>(y)[i];
    uint4 oa;
    const T* xv = reinterpret_cast<const T*>(&xa);
    const T* yv = reinterpret_cast<const T*>(&ya);
    T* ov = reinterpret_cast<T*>(&oa);
#pragma unroll
    for (int k = 0; k < V; ++k) ov[k] = acis::Combine<T, OP>::apply(xv[k], yv[k], alpha);
    reinterpret_cast<uint4*>(out)[i] = oa;
  }
  for (int64_t i = nvec * V + tid; i < n; i += stride)
    out[i] = acis::Combine<T, OP>::apply(x[i], y[i], alpha);
}

template <typename T, int OP>
void launch(const void* x, const void* y, void* out, int64_t n, float alpha,
            cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int64_t work = vec ? (n / V + n % V) : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond ~16 blocks per SM
  if (blocks < 1) blocks = 1;
  combine_kernel<T, OP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), n, alpha, vec);
}

template <typename T>
int dispatch_op(int op, const void* x, const void* y, void* out, int64_t n, float alpha,
                cudaStream_t s) {
  switch (op) {
    case acis::kAdd: launch<T, acis::kAdd>(x, y, out, n, alpha, s); return 0;
    case acis::kMax: launch<T, acis::kMax>(x, y, out, n, alpha, s); return 0;
    case acis::kMin: launch<T, acis::kMin>(x, y, out, n, alpha, s); return 0;
    case acis::kMac: launch<T, acis::kMac>(x, y, out, n, alpha, s); return 0;
  }
  return -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for an
// op/dtype code the kernel does not implement.
extern "C" int acis_fused_combine(const void* x, const void* y, void* out, int64_t n, int dtype,
                                  int op, float alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  switch (dtype) {
    case acis::kF32: rc = dispatch_op<float>(op, x, y, out, n, alpha, s); break;
    case acis::kBF16: rc = dispatch_op<__nv_bfloat16>(op, x, y, out, n, alpha, s); break;
    case acis::kI8:
      if (op != acis::kMac) rc = dispatch_op<int8_t>(op, x, y, out, n, alpha, s);
      break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
