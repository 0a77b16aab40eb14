// RWKV-6 "Finch" WKV recurrence with data-dependent decay, multi-head and
// batched.  Per (batch b, head h), state S[K, V] in f32, token t:
//   kv  = k_t (x) v_t                    (rounded to bf16 when kv_bf16)
//   o_t = sum_k r_t[k] * (S[k, :] + u[k] * kv[k, :])
//   S   = diag(w_t) S + kv
// starting from s0[b, h] (zeros when s0 is null); the final S goes to
// s_out[b, h], which may be s0 itself (each thread reads its own lanes of S
// before the loop and writes the same lanes after).
//
// Replaces the Pallas kernel repro/kernels/rwkv6_recurrence.py:
// rwkv6_recurrence (body _wkv_kernel): grid (heads, time chunks) with S in
// VMEM scratch carried across the sequential chunk dim.  Here a block owns
// one (b, h) and kVCols value columns for the whole sequence, so S never
// leaves the SM: it is split over the block's threads by value column AND
// by key row.  kGroups consecutive lanes share kCpt consecutive columns;
// lane g holds rows 4 (g + kGroups m) + q (q < 4) of them in registers,
// with u of those rows.  Per token a lane does one multiply and three FMAs
// per (row, column) it holds, into two partial sums per column; the lanes'
// sums go to shared memory, and once per chunk each (token, column) adds
// its kGroups partials in a pairwise tree and writes o.  At the model's
// prefill shape ([8, 512, 32, 64] bf16; 8 lanes, 2 columns, 8 rows each)
// that is 256 blocks of 256 threads, 16 warps an SM where the first design
// (one thread a column, every row, o summed in the thread) had 4.
//
// Shared memory: each chunk of kChunk tokens is copied from device memory
// straight into a ring of kStages stages with cp.async (16-byte copies
// where the row, its strides and its base allow, else 8 or 4, else element
// copies); the block waits on a stage only when it computes it.  Once per
// chunk, what every column's lanes read is prepared for them: bf16 r (and,
// without kv_bf16, k and v) widened to f32, v as bf16 pairs {v, v}.  r and
// w are read as float4 (4 rows a load), k as bf16 pairs.  bf16 k (x) v
// under kv_bf16 is one mul.rn.bf16x2 per two rows: it rounds the exact
// product once, as rounding the f32 product does.  Inputs are read through
// strides: the model passes its [B, T, H, K] activations as [B, H, T, K]
// views, and o is written through its own strides, so no layout copy is
// made per call.  The TPU kernel pads T to a multiple of 64 with w = 1,
// k = 0; here a ragged last chunk computes only its real tokens, and K pads
// to 16, 32 or 64 with zero rows (r = k = 0 and S = 0 there, which adds
// nothing).
//
// Bound on the card: at [8, 512, 32, 64] bf16 the bytes are about 0.11 GB
// (0.033 ms at 3.35 TB/s) and the f32 arithmetic 7 flops per (k, v) per
// token, 3.76 GFLOP (0.056 ms at 67 TFLOP/s): operations bound it.  A
// block alone on an SM is latency-bound: tools/probe_wkv.py finds the same
// time at 32, 64 and 128 blocks, and about 1.45 times it at 256, where two
// blocks share most SMs.  The launch shape (the ACIS_WKV_* macros below)
// was chosen with that probe.  Not here:
// the chunked tensor-core form (repro/models/rwkv6.py wkv_chunked), whose
// decay ratios over a chunk need a tolerance of their own that
// wkv_tolerance (a bound for the sequential recurrence) does not give.
//
// Numbers: inputs f32 or bf16 (r, k, v one dtype; o is written in it), w,
// u, s0 and S f32, all arithmetic f32.  The sum over k runs in this
// kernel's order (two partial sums a lane, then the tree over the lanes)
// with contracted multiply-adds, so o and S agree with the plain version
// only to f32 rounding (rwkv6_recurrence.wkv_tolerance states the bound,
// for any order).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ACIS_WKV_GROUPS
#define ACIS_WKV_GROUPS 8   // lanes sharing one value column (2 to 16)
#endif
#ifndef ACIS_WKV_VCOLS
#define ACIS_WKV_VCOLS 64   // value columns per block (32 or 64)
#endif
#ifndef ACIS_WKV_CPT
#define ACIS_WKV_CPT 2      // consecutive value columns per thread (1 to 8)
#endif
#ifndef ACIS_WKV_CHUNK
#define ACIS_WKV_CHUNK 16   // tokens per stage
#endif
#ifndef ACIS_WKV_STAGES
#define ACIS_WKV_STAGES 3   // cp.async ring depth (2 to 4)
#endif
#ifndef ACIS_WKV_UNROLL
#define ACIS_WKV_UNROLL 4   // tokens a loop step computes, interleaved
#endif
#ifndef ACIS_WKV_MAXNREG
#define ACIS_WKV_MAXNREG 0  // registers a thread (0: the compiler's choice)
#endif

namespace {

constexpr int kGroups = ACIS_WKV_GROUPS;
constexpr int kVCols = ACIS_WKV_VCOLS;
constexpr int kCpt = ACIS_WKV_CPT;
constexpr int kChunk = ACIS_WKV_CHUNK;
constexpr int kStages = ACIS_WKV_STAGES;
constexpr int kUnroll = ACIS_WKV_UNROLL;
constexpr int kMaxK = 64, kMaxV = 64;
static_assert(kGroups == 2 || kGroups == 4 || kGroups == 8 || kGroups == 16, "groups");
static_assert(kCpt == 1 || kCpt == 2 || kCpt == 4 || kCpt == 8, "columns a thread");
static_assert((kVCols == 32 || kVCols == 64) && kVCols % kCpt == 0, "columns");
static_assert(kStages >= 2 && kStages <= 4, "stages");

// groups for a padded K: each lane holds a multiple of 4 rows
__host__ __device__ constexpr int groups_for(int kp) { return kGroups < kp / 4 ? kGroups : kp / 4; }
__host__ __device__ constexpr int threads_for(int kp) { return kVCols / kCpt * groups_for(kp); }
static_assert(threads_for(16) % 32 == 0, "whole warps at every padded K");

struct Params {
  const void *r, *k, *v;
  const float *w, *u, *s0;
  float* s_out;
  void* o;
  int H, T, K, V;
  int64_t st[5][3];  // element strides (batch, head, time) of r, k, v, w, o
  int lg[4];         // log2 of the copy bytes for r, k, v, w: 4, 3, 2, or 0 (elements)
  bool vec_s;        // V % 2 == 0 and s0, s_out 8-byte aligned
};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// the f32 value of the low or high bf16 of a pair
__device__ __forceinline__ float bf16_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }
// a * b of two bf16 pairs, rounded to nearest even
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void zero_bytes(void* dst) {
  if constexpr (BYTES == 16) *static_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
  if constexpr (BYTES == 8) *static_cast<int2*>(dst) = make_int2(0, 0);
  if constexpr (BYTES == 4) *static_cast<int*>(dst) = 0;
}

// Copies rows t0 .. t0 + kChunk - 1 of one array into its stage: WIDTH
// elements a row in shared memory, of which the first `valid` exist (later
// ones, and rows at or past T, are zero-filled), in copies of 2^lg bytes
// (16, 8 or 4; lg 0: element copies, for misaligned or ragged rows).
template <typename E, int WIDTH, int NT>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, int64_t st_t, int t0, int T,
                                           int valid, int lg) {
  constexpr int kRowBytes = WIDTH * sizeof(E);
  if (lg == 0) {
    for (int e = threadIdx.x; e < kChunk * WIDTH; e += NT) {
      const int j = e / WIDTH, i = e % WIDTH;
      dst[e] = (t0 + j < T && i < valid) ? src[(int64_t)(t0 + j) * st_t + i] : E(0.f);
    }
    return;
  }
  const int per_row = kRowBytes >> lg, vb = valid * (int)sizeof(E);
  for (int e = threadIdx.x; e < kChunk * per_row; e += NT) {
    const int j = e / per_row, byte = (e % per_row) << lg;  // per_row: a power of 2
    char* d = reinterpret_cast<char*>(dst) + j * kRowBytes + byte;
    const char* sp = reinterpret_cast<const char*>(src + (int64_t)(t0 + j) * st_t) + byte;
    const bool in = t0 + j < T && byte < vb;
    if (lg == 4) {
      if (in) cp_async<16>(d, sp); else zero_bytes<16>(d);
    } else if (lg == 3) {
      if (in) cp_async<8>(d, sp); else zero_bytes<8>(d);
    } else {
      if (in) cp_async<4>(d, sp); else zero_bytes<4>(d);
    }
  }
}

// Shared memory: kStages stages of raw rows, w (f32) [kChunk][KP], r, k
// [kChunk][KP] and v [kChunk][kVCols] in the input dtype; then the chunk's
// prepared operands: r in f32, and k, v in f32 (kPacked: v as bf16 pairs
// {v, v}, k read from the stage); then o's partial sums, [kChunk][G][kVCols
// + 4] f32 (the pad keeps a warp's 8-byte stores off each other's banks).
template <typename TI, int KP, bool KV_BF16>
struct Layout {
  static constexpr bool kPacked = sizeof(TI) == 2 && KV_BF16;
  static constexpr int kW = kChunk * KP * 4, kR = kChunk * KP * (int)sizeof(TI),
                       kV = kChunk * kVCols * (int)sizeof(TI);
  static constexpr int kStage = kW + 2 * kR + kV;
  static constexpr int kPrep = sizeof(TI) == 4 ? 0
                               : kPacked  ? kChunk * (KP + kVCols) * 4
                                          : kChunk * (2 * KP + kVCols) * 4;
  static constexpr int kOStride = kVCols + 4;
  static constexpr int kO = kChunk * groups_for(KP) * kOStride * 4;
  static constexpr int kSmem = kStages * kStage + kPrep + kO;
  static_assert(kW % 16 == 0 && kR % 16 == 0 && kV % 16 == 0, "16-byte stage arrays");
};

#if ACIS_WKV_MAXNREG > 0
#define WKV_BOUNDS(kp) __maxnreg__(ACIS_WKV_MAXNREG)
#else
#define WKV_BOUNDS(kp) __launch_bounds__(threads_for(kp))
#endif

template <typename TI, int KP, bool KV_BF16>
__global__ void WKV_BOUNDS(KP) wkv_kernel(const Params p) {
  using L = Layout<TI, KP, KV_BF16>;
  constexpr int G = groups_for(KP), NT = threads_for(KP);
  constexpr int RPT = KP / G, M = RPT / 4;
  // bf16 inputs with kv in bf16: k (x) v as one bf16x2 multiply per two rows,
  // which rounds the exact product once, as rounding the f32 product does
  constexpr bool kPacked = L::kPacked;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, g = lane % G;
  const int cs = (tid >> 5) * (32 / G) + lane / G;  // column set: columns cs kCpt + c
  const int bh = blockIdx.x, h = bh % p.H;
  const int64_t b = bh / p.H;
  const int v0 = blockIdx.y * kVCols;
  const int K = p.K, V = p.V, T = p.T;
  const int vvalid = V - v0 < kVCols ? V - v0 : kVCols;

  const TI* r = static_cast<const TI*>(p.r) + b * p.st[0][0] + h * p.st[0][1];
  const TI* k = static_cast<const TI*>(p.k) + b * p.st[1][0] + h * p.st[1][1];
  const TI* v = static_cast<const TI*>(p.v) + b * p.st[2][0] + h * p.st[2][1] + v0;
  const float* w = p.w + b * p.st[3][0] + h * p.st[3][1];
  TI* o = static_cast<TI*>(p.o) + b * p.st[4][0] + h * p.st[4][1] + v0;
  const int64_t s_base = (int64_t)bh * K * V;
  unsigned char* prep = smem + kStages * L::kStage;
  float* ob = reinterpret_cast<float*>(prep + L::kPrep);

  // a thread's kCpt columns of one row move as vectors where V and the
  // state's alignment allow
  const bool vec_s = kCpt % 2 == 0 && p.vec_s;
  float S[kCpt][RPT], U[RPT];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * (g + G * m) + q, col0 = v0 + cs * kCpt;
      U[4 * m + q] = i < K ? p.u[h * K + i] : 0.f;
      const float* row = p.s0 + s_base + (int64_t)i * V + col0;
      if (vec_s && p.s0 != nullptr && i < K && col0 < V) {
        if constexpr (kCpt % 2 == 0) {
#pragma unroll
          for (int c = 0; c < kCpt; c += 2) {
            const float2 x = *reinterpret_cast<const float2*>(row + c);
            S[c][4 * m + q] = x.x, S[c + 1][4 * m + q] = x.y;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCpt; ++c)
          S[c][4 * m + q] = (p.s0 != nullptr && i < K && col0 + c < V) ? row[c] : 0.f;
      }
    }

  auto issue = [&](int chunk) {
    unsigned char* s = smem + (chunk % kStages) * L::kStage;
    const int t0 = chunk * kChunk;
    stage_rows<float, KP, NT>(reinterpret_cast<float*>(s), w, p.st[3][2], t0, T, K, p.lg[3]);
    stage_rows<TI, KP, NT>(reinterpret_cast<TI*>(s + L::kW), r, p.st[0][2], t0, T, K, p.lg[0]);
    stage_rows<TI, KP, NT>(reinterpret_cast<TI*>(s + L::kW + L::kR), k, p.st[1][2], t0, T, K,
                           p.lg[1]);
    stage_rows<TI, kVCols, NT>(reinterpret_cast<TI*>(s + L::kW + 2 * L::kR), v, p.st[2][2], t0,
                               T, vvalid, p.lg[2]);
  };

  const int n_chunks = (T + kChunk - 1) / kChunk;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue(c);
    cp_async_commit();  // empty groups keep the count uniform
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();               // ... everyone's; chunk c - 1's stage is free
    if (c + kStages - 1 < n_chunks) issue(c + kStages - 1);
    cp_async_commit();

    const unsigned char* s = smem + (c % kStages) * L::kStage;
    const float* sw = reinterpret_cast<const float*>(s);
    const float *sr, *sk, *sv;
    const uint32_t *kp2 = nullptr, *vp2 = nullptr;  // kPacked: k pairs, {v, v}
    if constexpr (sizeof(TI) == 4) {
      sr = reinterpret_cast<const float*>(s + L::kW);
      sk = reinterpret_cast<const float*>(s + L::kW + L::kR);
      sv = reinterpret_cast<const float*>(s + L::kW + 2 * L::kR);
    } else {  // widen once per chunk what every column's threads read
      const uint32_t* raw = reinterpret_cast<const uint32_t*>(s + L::kW);  // bf16 pairs
      float* wide = reinterpret_cast<float*>(prep);
      sr = wide;
      if constexpr (kPacked) {
        uint32_t* vp = reinterpret_cast<uint32_t*>(wide + kChunk * KP);
        const uint16_t* v16 = reinterpret_cast<const uint16_t*>(s + L::kW + 2 * L::kR);
        for (int e = tid; e < kChunk * KP / 2; e += NT)
          reinterpret_cast<float2*>(wide)[e] = make_float2(bf16_lo(raw[e]), bf16_hi(raw[e]));
        for (int e = tid; e < kChunk * kVCols; e += NT) vp[e] = v16[e] * 0x10001u;
        kp2 = reinterpret_cast<const uint32_t*>(s + L::kW + L::kR);
        vp2 = vp;
      } else {
        for (int e = tid; e < kChunk * (2 * KP + kVCols) / 2; e += NT)
          reinterpret_cast<float2*>(wide)[e] = make_float2(bf16_lo(raw[e]), bf16_hi(raw[e]));
        sk = wide + kChunk * KP;
        sv = wide + 2 * kChunk * KP;
      }
      __syncthreads();
    }

    const int n = T - c * kChunk < kChunk ? T - c * kChunk : kChunk;
    // token j: this lane's rows of o, summed over its rows, into ob[j][g]
    auto step = [&](int j) {
      float acc[kCpt][2];
#pragma unroll
      for (int cc = 0; cc < kCpt; ++cc) acc[cc][0] = acc[cc][1] = 0.f;
      // four rows of a column: acc += r (S + u kv), S = w S + kv
      auto rows4 = [&](int m, int cc, const float4& r4, const float (&kv)[4], const float4& w4) {
        const float rq[4] = {r4.x, r4.y, r4.z, r4.w}, wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float& sq = S[cc][4 * m + q];
          acc[cc][q & 1] = fmaf(rq[q], fmaf(U[4 * m + q], kv[q], sq), acc[cc][q & 1]);
          sq = fmaf(wq[q], sq, kv[q]);
        }
      };
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 r4 = reinterpret_cast<const float4*>(sr + j * KP)[g + G * m];
        const float4 w4 = reinterpret_cast<const float4*>(sw + j * KP)[g + G * m];
        if constexpr (kPacked) {
          const uint2 k2 = reinterpret_cast<const uint2*>(kp2)[j * KP / 4 + g + G * m];
#pragma unroll
          for (int cc = 0; cc < kCpt; ++cc) {
            const uint32_t vp = vp2[j * kVCols + cs * kCpt + cc];
            const uint32_t p0 = bf16x2_mul(k2.x, vp), p1 = bf16x2_mul(k2.y, vp);
            const float kv[4] = {bf16_lo(p0), bf16_hi(p0), bf16_lo(p1), bf16_hi(p1)};
            rows4(m, cc, r4, kv, w4);
          }
        } else {
          const float4 k4 = reinterpret_cast<const float4*>(sk + j * KP)[g + G * m];
#pragma unroll
          for (int cc = 0; cc < kCpt; ++cc) {
            const float vv = sv[j * kVCols + cs * kCpt + cc];
            float kv[4] = {k4.x * vv, k4.y * vv, k4.z * vv, k4.w * vv};
            if constexpr (KV_BF16) {  // f32 inputs: round the f32 product
#pragma unroll
              for (int q = 0; q < 4; ++q) kv[q] = __bfloat162float(__float2bfloat16_rn(kv[q]));
            }
            rows4(m, cc, r4, kv, w4);
          }
        }
      }
      float* dst = ob + (j * G + g) * L::kOStride + cs * kCpt;
#pragma unroll
      for (int cc = 0; cc < kCpt; cc += 2) {
        if constexpr (kCpt == 1)
          dst[0] = acc[0][0] + acc[0][1];
        else
          *reinterpret_cast<float2*>(dst + cc) =
              make_float2(acc[cc][0] + acc[cc][1], acc[cc + 1][0] + acc[cc + 1][1]);
      }
    };
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {  // kUnroll tokens interleave
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) step(j + u);
    }
    for (; j < n; ++j) step(j);
    __syncthreads();

    // o of the chunk: each (token, column) sums its G lanes' partials, in a
    // pairwise tree over g, and is written once
    const int t0 = c * kChunk;
    for (int e = tid; e < n * kVCols; e += NT) {
      const int jj = e / kVCols, col = e % kVCols;
      if (col >= vvalid) continue;
      float part[G];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) part[gg] = ob[(jj * G + gg) * L::kOStride + col];
#pragma unroll
      for (int d = 1; d < G; d <<= 1)
#pragma unroll
        for (int gg = 0; gg < G; gg += 2 * d) part[gg] += part[gg + d];
      store_out(o + (int64_t)(t0 + jj) * p.st[4][2] + col, part[0]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * (g + G * m) + q, col0 = v0 + cs * kCpt;
      if (i >= K || col0 >= V) continue;
      float* row = p.s_out + s_base + (int64_t)i * V + col0;
      if (vec_s) {
        if constexpr (kCpt % 2 == 0) {
#pragma unroll
          for (int c = 0; c < kCpt; c += 2)
            *reinterpret_cast<float2*>(row + c) = make_float2(S[c][4 * m + q], S[c + 1][4 * m + q]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCpt; ++c)
          if (col0 + c < V) row[c] = S[c][4 * m + q];
      }
    }
}

template <typename TI, int KP, bool KV_BF16>
int launch_kp(const Params& p, int64_t BH, cudaStream_t stream) {
  constexpr int smem = Layout<TI, KP, KV_BF16>::kSmem;
  auto* fn = wkv_kernel<TI, KP, KV_BF16>;
  if (smem > 48 * 1024) {
    static uint64_t raised = 0;  // once per instantiation and device
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64 || !(raised >> dev & 1)) {
      const cudaError_t e =
          cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) raised |= uint64_t(1) << dev;
    }
  }
  const dim3 grid((unsigned)BH, (unsigned)((p.V + kVCols - 1) / kVCols));
  fn<<<grid, threads_for(KP), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TI, bool KV_BF16>
int launch(const Params& p, int64_t BH, cudaStream_t s) {
  if (p.K <= 16) return launch_kp<TI, 16, KV_BF16>(p, BH, s);
  if (p.K <= 32) return launch_kp<TI, 32, KV_BF16>(p, BH, s);
  return launch_kp<TI, 64, KV_BF16>(p, BH, s);
}

// log2 of the largest copy (16, 8 or 4 bytes) that the base, the strides
// and the valid width (`n` elements from element `off`) all allow; 0 for
// element copies.
int copy_lg(const void* base, const int64_t* st, int64_t esz, int64_t n, int64_t off) {
  for (int lg = 4; lg >= 2; --lg) {
    const int64_t vec = int64_t(1) << lg;
    bool ok = reinterpret_cast<uintptr_t>(base) % vec == 0 && (n * esz) % vec == 0 &&
              (off * esz) % vec == 0;
    for (int a = 0; a < 3; ++a) ok = ok && (st[a] * esz) % vec == 0;
    if (ok) return lg;
  }
  return 0;
}

int padded_k(int K) { return K <= 16 ? 16 : K <= 32 ? 32 : 64; }

}  // namespace

// The launch shape for K and V: out[0..9] = padded K, groups, rows a
// lane, value columns a block, columns a thread, threads a block, blocks
// per (batch, head), tokens a stage, stages, tokens a loop step.  Lets the
// wrapper's own plan (rwkv6_recurrence.launch_shape) be checked against
// the build.
extern "C" void acis_rwkv6_launch_shape(int K, int V, int* out) {
  const int kp = padded_k(K), g = groups_for(kp);
  const int vals[10] = {kp,   g,      kp / g,  kVCols, kCpt, threads_for(kp),
                        (V + kVCols - 1) / kVCols, kChunk, kStages, kUnroll};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
}

// Returns cudaGetLastError() after the launch (0 = launched).  r, k, w are
// [B, H, T, K] and v, o [B, H, T, V] with element strides (b, h, t) in
// `strides` (15 int64: r, k, v, w, o) and unit stride in the last dim; u
// is [H, K] f32, s0 (or null) and s_out [B, H, K, V] f32, all contiguous;
// w is f32; dtype 0 = f32, 1 = bf16 for r, k, v and o; all on CUDA device
// `device`.  1 <= K, V <= 64, T < 2^31 (the wrapper checks shapes, dtypes
// and strides).
extern "C" int acis_rwkv6_recurrence(const void* r, const void* k, const void* v, const void* w,
                                     const void* u, const void* s0, void* s_out, void* o,
                                     int64_t B, int64_t H, int64_t T, int K, int V,
                                     const int64_t* strides, int dtype, int kv_bf16,
                                     int device, void* stream) {
  if (K < 1 || K > kMaxK || V < 1 || V > kMaxV || B * H <= 0 || T < 0 || T > INT32_MAX ||
      H > INT32_MAX || B * H > INT32_MAX || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.s_out = static_cast<float*>(s_out);
  p.o = o;
  p.H = (int)H;
  p.T = (int)T;
  p.K = K;
  p.V = V;
  for (int x = 0; x < 5; ++x)
    for (int a = 0; a < 3; ++a) p.st[x][a] = strides[3 * x + a];
  const int64_t esz = dtype == 0 ? 4 : 2;
  p.lg[0] = copy_lg(r, p.st[0], esz, K, 0);
  p.lg[1] = copy_lg(k, p.st[1], esz, K, 0);
  p.lg[2] = copy_lg(v, p.st[2], esz, V, kVCols);
  p.lg[3] = copy_lg(w, p.st[3], 4, K, 0);
  p.vec_s = V % 2 == 0 && reinterpret_cast<uintptr_t>(s0) % 8 == 0 &&
            reinterpret_cast<uintptr_t>(s_out) % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t BH = B * H;
  int prev = device;  // launch with `device` current, then restore the caller's
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int rc =
      dtype == 0 ? (kv_bf16 ? launch<float, true>(p, BH, s) : launch<float, false>(p, BH, s))
                 : (kv_bf16 ? launch<__nv_bfloat16, true>(p, BH, s)
                            : launch<__nv_bfloat16, false>(p, BH, s));
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
