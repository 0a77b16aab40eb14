// RWKV-6 "Finch" WKV recurrence with data-dependent decay, multi-head and
// batched.  Per (batch b, head h), state S[K, V] in f32, token t:
//   kv  = k_t (x) v_t                    (rounded to bf16 when kv_bf16)
//   o_t = sum_k r_t[k] * (S[k, :] + u[k] * kv[k, :])
//   S   = diag(w_t) S + kv
// starting from s0[b, h] (zeros when s0 is null); the final S goes to
// s_out[b, h], which may be s0 itself (each thread reads its column of S
// before the loop and writes it after).
//
// Replaces the Pallas kernel repro/kernels/rwkv6_recurrence.py:
// rwkv6_recurrence (body _wkv_kernel): grid (heads, time chunks) with S in
// VMEM scratch carried across the sequential chunk dim.  Here a block owns
// one (b, h) for the whole sequence, so S never leaves the SM: thread j
// holds column S[:, j] in registers (K <= 64 floats) and steps over T
// itself.  The TPU kernel pads T to a multiple of 64 with w = 1, k = 0;
// this kernel masks the ragged chunk instead (padded lanes load r = k = 0
// and w = 1, which leave S unchanged, and write nothing), and pads K up to
// 16, 32 or 64 the same way.
//
// Staging: r, k, w (K values each) and v (V values) of kChunk = 8 tokens
// sit in shared memory, double-buffered.  While a block computes chunk c
// from one buffer, its threads hold chunk c+1's loads in registers and
// store them into the other buffer after the compute; one __syncthreads
// per chunk.  Loads are along the unit-stride last dim, so neighbouring
// threads read neighbouring addresses.  Inputs are read through strides:
// the model passes [B, T, H, K] activations as [B, H, T, K] views, and o is
// written through its own strides, so no layout copy is made per call.
//
// Bound on the card: at the model's prefill shape, [8, 512, 32, 64] bf16,
// the bytes are about 0.11 GB (0.033 ms at 3.35 TB/s) and the f32
// arithmetic about 8 flops per (k, v) per token, 4.3 GFLOP (0.064 ms at
// 67 TFLOP/s): operations bound it.  This design runs B*H blocks of 64
// threads, each a sequential chain over T, so it is latency-bound well
// above that; the chunked tensor-core form (wkv_chunked), TMA and a wider
// split of K across threads are later speed work.
//
// Numbers: inputs f32 or bf16 (r, k, v one dtype; o is written in it), w,
// u, s0 and S f32, all arithmetic f32.  The sum over k runs in this
// kernel's order with four partial sums and contracted multiply-adds, so o
// and S agree with the plain version only to f32 rounding
// (rwkv6_recurrence.wkv_tolerance states the bound).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // one thread per value column, V <= 64
constexpr int kChunk = 8;     // tokens per shared-memory buffer

struct Strides {
  // element strides of (batch, head, time) for r, k, v, w, o; the last
  // (k or v) dim has stride 1
  int64_t r[3], k[3], v[3], w[3], o[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Chunk c's loads of one thread: r, k, w at (token, k) lanes
// e = tid + kThreads * m (KP / 8 each), and v at (token m, column tid).
template <typename TI, int KP>
struct Pending {
  TI r[KP / 8], k[KP / 8], v[kChunk];
  float w[KP / 8];
};

template <typename TI, int KP>
__device__ __forceinline__ void load_chunk(Pending<TI, KP>& p, const TI* __restrict__ r,
                                           const TI* __restrict__ k, const TI* __restrict__ v,
                                           const float* __restrict__ w, const Strides& st,
                                           int64_t t0, int64_t T, int K, int V) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < KP / 8; ++m) {
    const int e = tid + kThreads * m;
    const int j = e / KP, i = e % KP;
    const int64_t t = t0 + j;
    const bool ok = t < T && i < K;
    p.r[m] = ok ? r[t * st.r[2] + i] : zero_of<TI>();
    p.k[m] = ok ? k[t * st.k[2] + i] : zero_of<TI>();
    p.w[m] = ok ? w[t * st.w[2] + i] : 1.f;
  }
#pragma unroll
  for (int m = 0; m < kChunk; ++m) {
    const int64_t t = t0 + m;
    p.v[m] = (t < T && tid < V) ? v[t * st.v[2] + tid] : zero_of<TI>();
  }
}

template <typename TI, int KP>
__device__ __forceinline__ void store_chunk(const Pending<TI, KP>& p, float (*sr)[KP],
                                            float (*sk)[KP], float (*sw)[KP],
                                            float (*sv)[kThreads]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < KP / 8; ++m) {
    const int e = tid + kThreads * m;
    const int j = e / KP, i = e % KP;
    sr[j][i] = to_f32(p.r[m]);
    sk[j][i] = to_f32(p.k[m]);
    sw[j][i] = p.w[m];
  }
#pragma unroll
  for (int m = 0; m < kChunk; ++m) sv[m][tid] = to_f32(p.v[m]);
}

template <typename TI, int KP, bool KV_BF16>
__global__ void __launch_bounds__(kThreads)
    wkv_kernel(const TI* __restrict__ r, const TI* __restrict__ k, const TI* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* s0, float* s_out, TI* __restrict__ o, int64_t H, int64_t T, int K,
               int V, Strides st) {
  __shared__ float sr[2][kChunk][KP], sk[2][kChunk][KP], sw[2][kChunk][KP];
  __shared__ float sv[2][kChunk][kThreads];
  __shared__ float su[KP];

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x / H, h = blockIdx.x % H;
  r += b * st.r[0] + h * st.r[1];
  k += b * st.k[0] + h * st.k[1];
  v += b * st.v[0] + h * st.v[1];
  w += b * st.w[0] + h * st.w[1];
  o += b * st.o[0] + h * st.o[1];
  const int64_t s_base = (b * H + h) * (int64_t)K * V;

  for (int i = tid; i < KP; i += kThreads) su[i] = i < K ? u[h * K + i] : 0.f;

  float S[KP];
#pragma unroll
  for (int i = 0; i < KP; ++i)
    S[i] = (s0 != nullptr && i < K && tid < V) ? s0[s_base + (int64_t)i * V + tid] : 0.f;

  const int64_t n_chunks = (T + kChunk - 1) / kChunk;
  Pending<TI, KP> p;
  if (n_chunks > 0) {
    load_chunk<TI, KP>(p, r, k, v, w, st, 0, T, K, V);
    store_chunk<TI, KP>(p, sr[0], sk[0], sw[0], sv[0]);
  }
  __syncthreads();

  for (int64_t c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const bool more = c + 1 < n_chunks;
    if (more) load_chunk<TI, KP>(p, r, k, v, w, st, (c + 1) * kChunk, T, K, V);

    const int64_t t0 = c * kChunk;
    const int n = (int)((T - t0) < kChunk ? (T - t0) : kChunk);
    for (int j = 0; j < n; ++j) {
      const float vv = sv[buf][j][tid];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        float kv = sk[buf][j][i] * vv;
        if (KV_BF16) kv = __bfloat162float(__float2bfloat16_rn(kv));
        acc[i & 3] += sr[buf][j][i] * (S[i] + su[i] * kv);
        S[i] = sw[buf][j][i] * S[i] + kv;
      }
      if (tid < V) o[(t0 + j) * st.o[2] + tid] = from_f32<TI>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }

    if (more) store_chunk<TI, KP>(p, sr[buf ^ 1], sk[buf ^ 1], sw[buf ^ 1], sv[buf ^ 1]);
    __syncthreads();
  }

  if (tid < V) {
#pragma unroll
    for (int i = 0; i < KP; ++i)
      if (i < K) s_out[s_base + (int64_t)i * V + tid] = S[i];
  }
}

template <typename TI, int KP>
int launch_kp(const void* r, const void* k, const void* v, const void* w, const void* u,
              const void* s0, void* s_out, void* o, int64_t B, int64_t H, int64_t T, int K, int V,
              const Strides& st, int kv_bf16, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * H)), block(kThreads);
  const TI *rp = static_cast<const TI*>(r), *kp = static_cast<const TI*>(k),
           *vp = static_cast<const TI*>(v);
  const float *wp = static_cast<const float*>(w), *up = static_cast<const float*>(u),
              *s0p = static_cast<const float*>(s0);
  float* sp = static_cast<float*>(s_out);
  TI* op = static_cast<TI*>(o);
  if (kv_bf16)
    wkv_kernel<TI, KP, true><<<grid, block, 0, stream>>>(rp, kp, vp, wp, up, s0p, sp, op, H, T, K, V, st);
  else
    wkv_kernel<TI, KP, false><<<grid, block, 0, stream>>>(rp, kp, vp, wp, up, s0p, sp, op, H, T, K, V, st);
  return (int)cudaGetLastError();
}

template <typename TI>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* s_out, void* o, int64_t B, int64_t H, int64_t T, int K, int V,
           const Strides& st, int kv_bf16, cudaStream_t stream) {
  if (K <= 16) return launch_kp<TI, 16>(r, k, v, w, u, s0, s_out, o, B, H, T, K, V, st, kv_bf16, stream);
  if (K <= 32) return launch_kp<TI, 32>(r, k, v, w, u, s0, s_out, o, B, H, T, K, V, st, kv_bf16, stream);
  return launch_kp<TI, 64>(r, k, v, w, u, s0, s_out, o, B, H, T, K, V, st, kv_bf16, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  r, k, w are
// [B, H, T, K] and v, o [B, H, T, V] with element strides (b, h, t) in
// `strides` (15 int64: r, k, v, w, o) and unit stride in the last dim; u
// is [H, K] f32, s0 (or null) and s_out [B, H, K, V] f32, all contiguous;
// w is f32; dtype 0 = f32, 1 = bf16 for r, k, v and o.  1 <= K, V <= 64
// (the wrapper checks shapes, dtypes and strides).
extern "C" int acis_rwkv6_recurrence(const void* r, const void* k, const void* v, const void* w,
                                     const void* u, const void* s0, void* s_out, void* o,
                                     int64_t B, int64_t H, int64_t T, int K, int V,
                                     const int64_t* strides, int dtype, int kv_bf16,
                                     void* stream) {
  if (K < 1 || K > 64 || V < 1 || V > kThreads || B * H <= 0) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int a = 0; a < 3; ++a) {
    st.r[a] = strides[a];
    st.k[a] = strides[3 + a];
    st.v[a] = strides[6 + a];
    st.w[a] = strides[9 + a];
    st.o[a] = strides[12 + a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(r, k, v, w, u, s0, s_out, o, B, H, T, K, V, st, kv_bf16, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, s_out, o, B, H, T, K, V, st, kv_bf16, s);
  return (int)cudaErrorInvalidValue;
}
