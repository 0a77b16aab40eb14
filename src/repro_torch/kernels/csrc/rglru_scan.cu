// RG-LRU gated linear recurrence, batched: for every batch row b and lane d
//   h[b, t, d] = a[b, t, d] * h[b, t-1, d] + b_[b, t, d]
// from h[b, -1, d] = h0[b, d] (zeros when h0 is null), in f32.  The final
// state h[b, T-1, :] also goes to h_last[b, :] when h_last is not null; it
// may be h0 itself (each thread reads its lane of h0 before the loop and
// writes it after).
//
// Replaces the Pallas kernel repro/kernels/chunk_scan.py:rglru_scan (body
// _rglru_kernel): a sequential grid over 256-row time chunks with the carry
// in VMEM scratch and a log-step Hillis-Steele scan inside each chunk.  On
// the card the lanes are the parallelism: one thread per (b, d) lane keeps
// its state in a register and walks T itself, so no carry crosses blocks
// and no log-step rescan is needed.  At the model's prefill shape,
// [8, 512, 4096], that is 32,768 threads in 256 blocks of 128.
//
// Bound: device memory.  a and b are read once and h written once, 12
// bytes per (lane, step) in f32; the arithmetic is 2 flops per 12 bytes.
// Neighbouring threads own neighbouring lanes (the lane stride is 1), so
// every warp load and store is one coalesced 128-byte transaction.  The
// loads of a and b do not depend on h: each thread holds the next kChunk
// steps' loads in registers while it computes the current kChunk steps,
// which keeps 2 * kChunk loads in flight per thread across the dependent
// multiply-add chain.  At decode (T = 1) the kernel is one load, one
// multiply-add and one store per lane: launch latency bounds it.
//
// Numbers: a and b f32 or bf16 (one dtype, widened exactly), h0, h and
// h_last f32.  Each step rounds the product and the sum separately
// (__fmul_rn, __fadd_rn: no contraction into a fused multiply-add), as the
// plain PyTorch version does, so the two agree bit for bit;
// chunk_scan.rglru_tolerance states the f32 bound both meet around the
// float64 recurrence.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // lanes per block
constexpr int kChunk = 8;      // steps whose loads are held ahead

struct Strides {
  // element strides of (batch, time) for a and b, and of batch for h0;
  // the lane dim has stride 1 in all three
  int64_t a_b, a_t, b_b, b_t, h0_b;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TI>
__device__ __forceinline__ void load_chunk(float (&ra)[kChunk], float (&rb)[kChunk],
                                           const TI* __restrict__ a, const TI* __restrict__ b,
                                           const Strides& st, int64_t t0, int64_t T) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int64_t t = t0 + j;
    const bool ok = t < T;
    ra[j] = ok ? to_f32(a[t * st.a_t]) : 1.f;
    rb[j] = ok ? to_f32(b[t * st.b_t]) : 0.f;
  }
}

template <typename TI>
__global__ void __launch_bounds__(kThreads)
    rglru_kernel(const TI* __restrict__ a, const TI* __restrict__ b, const float* h0,
                 float* __restrict__ h, float* h_last, int64_t B, int64_t T, int64_t D,
                 Strides st) {
  const int64_t d = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  for (int64_t bi = blockIdx.y; bi < B; bi += gridDim.y) {
    const TI* ab = a + bi * st.a_b + d;
    const TI* bb = b + bi * st.b_b + d;
    float* hb = h + bi * T * D + d;
    float hv = h0 != nullptr ? h0[bi * st.h0_b + d] : 0.f;

    float pa[kChunk], pb[kChunk];
    if (T > 0) load_chunk<TI>(pa, pb, ab, bb, st, 0, T);
    for (int64_t t0 = 0; t0 < T; t0 += kChunk) {
      float ca[kChunk], cb[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        ca[j] = pa[j];
        cb[j] = pb[j];
      }
      if (t0 + kChunk < T) load_chunk<TI>(pa, pb, ab, bb, st, t0 + kChunk, T);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (t0 + j < T) {
          hv = __fadd_rn(__fmul_rn(ca[j], hv), cb[j]);
          hb[(t0 + j) * D] = hv;
        }
      }
    }
    if (h_last != nullptr) h_last[bi * D + d] = hv;
  }
}

template <typename TI>
int launch(const void* a, const void* b, const float* h0, float* h, float* h_last, int64_t B,
           int64_t T, int64_t D, const Strides& st, cudaStream_t stream) {
  const dim3 grid((unsigned)((D + kThreads - 1) / kThreads), (unsigned)(B < 65535 ? B : 65535));
  rglru_kernel<TI><<<grid, kThreads, 0, stream>>>(static_cast<const TI*>(a),
                                                  static_cast<const TI*>(b), h0, h, h_last, B, T,
                                                  D, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  a and b are
// [B, T, D] with element strides (batch, time) in `strides` (5 int64:
// a_b, a_t, b_b, b_t, h0_b) and unit lane stride; h0 (or null) is [B, D]
// f32 with batch stride h0_b; h is a contiguous [B, T, D] f32 output and
// h_last (or null) a contiguous [B, D] f32 output that may alias h0; dtype
// 0 = f32, 1 = bf16 for a and b.  The wrapper checks shapes, dtypes and
// strides.
extern "C" int acis_rglru_scan(const void* a, const void* b, const void* h0, void* h,
                               void* h_last, int64_t B, int64_t T, int64_t D,
                               const int64_t* strides, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || (D + kThreads - 1) / kThreads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h0p = static_cast<const float*>(h0);
  float* hp = static_cast<float*>(h);
  float* hl = static_cast<float*>(h_last);
  if (dtype == 0) return launch<float>(a, b, h0p, hp, hl, B, T, D, st, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0p, hp, hl, B, T, D, st, s);
  return (int)cudaErrorInvalidValue;
}
