// Encoded-domain int8 combine (dequant -> add -> requant): the per-hop
// aggregation of the blockwise-int8 wire format, in two forms.  Every row
// is one 256-lane quantization block with its f32 scale.  Per row:
//
//   acc   = qa * sa + qb * sb                      (f32)
//   scale = absmax(acc) > 0 ? absmax(acc) / 127 : 1
//   q     = clip(rint(acc / scale), -127, 127)     (int8)
//
//  * acis_quant_combine -- over flat operands [rows, 256] + [rows].
//  * acis_quant_hop -- one step of the encoded ring reduce-scatter of every
//    rank at once, both operands read in place from the all-ranks tensors:
//      out[a, r, b] = combine(buf[a, (r - 1) mod n, b], xs[a, r, b, (r - 2 - s) mod n])
//    with the rank dims viewed as [A, n, B] around the ring's axis; each
//    (a, r, b) is a run of `rows` rows (payload [rows, 256], scales [rows]).
//    The step's roll of buf and per-rank gather of xs are never written.
//
// Replaces the Pallas kernel repro/kernels/quant_combine.py:quant_combine.
// Bound: device memory, 3 * (256 + 4) bytes per row (two payloads and
// scales read, one written); the unfused hop (roll, gather, combine) moves
// 7 * (256 + 4).  Design: a half-warp owns a row, one 16-byte load per lane
// and operand, so a warp covers 2 rows a load and keeps `unroll` loads of
// each operand in flight (2 * unroll rows), whose sums, absmax shuffles
// (4 steps within the half-warp), scales and requantization go stage by
// stage together; the step's scales come in as one coalesced vector per
// operand and go out as one.  Blocks walk one (a, r, b) run each on a 2-D
// grid (runs x blocks of a run), the blocks of a run sized from the
// occupancy query times `waves` and striding over its rows (waves 0: one
// step per warp, no stride).  The shipped shape (128 threads, 2 loads per
// operand in flight, one resident grid, no cache hints: evict-first loads
// of xs, read once, measured slower) is tools/probe_quant.py's fastest on
// the card.
//
// Issue slots, not bytes, bounded the first form of this kernel: an IEEE
// division per lane, and four int <-> float conversions per lane on the
// card's conversion unit (a quarter of its float rate).  So:
//  * the kernel divides once per row (the scale, and its reciprocal
//    r = 1/scale rounded once) and multiplies each lane: q0 = acc * r lies
//    within 2^-16 of the rounded quotient (|q| <= 127.00002: r's rounding
//    adds at most 2^-24 of it, q0's own half an ulp of 2^-17, the
//    quotient's half an ulp), so wherever q0 is more than 2^-14 from a
//    half-integer, rint(q0) is rint(acc / scale) exactly.  A thread with a
//    lane nearer a tie (the exact .5 ties among them) takes the IEEE
//    division (__fdiv_rn) for its 16 lanes; so does every lane of a row
//    whose scale or reciprocal leaves the normal range or whose absmax is
//    NaN.  No clamp is needed where the scale is absmax / 127: |acc / scale|
//    rounds to at most 127;
//  * int8 -> f32 and rint -> int8 are exact float adds on the magic
//    constants below (kBias, kRound), with the bytes moved by PRMT.
//
// Bitwise rules, so the kernel equals the plain PyTorch version:
//  * the two products and the sum are rounded separately (__fmul_rn,
//    __fadd_rn): nvcc would otherwise contract them into an FMA;
//  * the scale is an IEEE division (__fdiv_rn), never a reciprocal
//    multiply, and each lane's rint is that of the IEEE quotient (above);
//  * rintf rounds half to even, as torch.round and jnp.round do.
// NaN: the absmax propagates NaN (max.NaN), so a row holding a NaN -- e.g.
// from a NaN input scale -- gets scale 1.0, exactly as the plain version's
// where(absmax > 0, ...) gives it; its NaN lanes are written as 0, which is
// what a float-to-int8 conversion of NaN gives on the card.
//
// The launch shape can be set at build time, for tools/probe_quant.py:
// ACIS_QUANT_THREADS per block, ACIS_QUANT_UNROLL loads per operand in
// flight, ACIS_QUANT_WAVES resident grids per launch (0: one step per
// warp), ACIS_QUANT_STREAM 0 (no cache hints), 1 (xs evict-first) or 2
// (buf and the output evict-first too).
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ACIS_QUANT_THREADS
#define ACIS_QUANT_THREADS 128
#endif
#ifndef ACIS_QUANT_UNROLL
#define ACIS_QUANT_UNROLL 2
#endif
#ifndef ACIS_QUANT_WAVES
#define ACIS_QUANT_WAVES 1
#endif
#ifndef ACIS_QUANT_STREAM
#define ACIS_QUANT_STREAM 0
#endif

namespace {

constexpr int kBlock = 256;                   // lanes per quantization block
constexpr int kThreads = ACIS_QUANT_THREADS;
constexpr int kUnroll = ACIS_QUANT_UNROLL;
constexpr int kWaves = ACIS_QUANT_WAVES;
constexpr int kStream = ACIS_QUANT_STREAM;
constexpr int kStep = 2 * kUnroll;            // rows a warp holds per step
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kStep <= 32, "launch shape");

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// word j of a 16-byte vector (j a constant once unrolled: no local memory)
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The card converts between ints and floats at a quarter of its float
// rate (16 a clock per SM), and a row needs 4 conversions a lane done the
// plain way (two int8 -> f32, rint, f32 -> int8): more than the row's bytes
// take to arrive.  Both directions go through the float rate instead,
// exactly:
//  * int8 -> f32: 0x4B000000 | (b ^ 0x80) is the float 2^23 + b + 128, so
//    subtracting 2^23 + 128 gives b (kBias); the byte moves with a PRMT;
//  * rint: for |q| < 2^22, q + 1.5 * 2^23 rounds to an integer (half to
//    even, as the add rounds), whose bits are 0x4B400000 + rint(q) (kRound):
//    the low byte is rint(q) as an int8, and subtracting kRound back is
//    rint(q) as a float.
constexpr float kBias = 8388736.0f;   // 2^23 + 128
constexpr float kRound = 12582912.0f;  // 1.5 * 2^23

// lane k of 16 int8 lanes (x: the vector's words XOR 0x80808080), as f32
__device__ __forceinline__ float lane_f32(const uint4& x, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(word(x, k >> 2), 0x4B000000u, (k & 3) | 0x7640)),
                   kBias);
}

__device__ __forceinline__ uint4 flip(uint4 v) {
  return make_uint4(v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u, v.w ^ 0x80808080u);
}

// the low bytes of four words, in order
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x40), __byte_perm(c, d, 0x40), 0x5410);
}

template <bool kOnce>
__device__ __forceinline__ uint4 load16(const int8_t* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  return kOnce ? __ldcs(v) : *v;
}

template <bool kOnce>
__device__ __forceinline__ float load_scale(const float* p) {
  return kOnce ? __ldcs(p) : *p;
}

// A row's scale from its absmax m (the same in every lane of the
// half-warp), and whether its lanes must take the IEEE division: a NaN
// row, or a scale or reciprocal outside the normal range.
__device__ __forceinline__ float row_scale(float m, bool* exact) {
  const float scale = (m > 0.0f) ? __fdiv_rn(m, 127.0f) : 1.0f;
  *exact = !(m == m) || scale < 0x1p-126f || scale >= 0x1p126f;
  return scale;
}

// Requantizes this thread's 16 lanes of a row with scale `scale`, r its
// reciprocal (unread when `exact`).
__device__ __forceinline__ uint4 requant(const float (&acc)[16], float scale, float r,
                                         bool exact) {
  uint32_t q[16];  // the int8 result in each low byte
  if (!exact) {
    bool tie = false;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float q0 = __fmul_rn(acc[k], r);
      const float big = __fadd_rn(q0, kRound);
      tie |= fabsf(__fsub_rn(q0, __fsub_rn(big, kRound))) > 0.5f - 0x1p-14f;
      q[k] = __float_as_uint(big);
    }
    exact = tie;
  }
  if (exact) {  // rare: a lane near a tie, an extreme scale, a NaN row
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float t = rintf(__fdiv_rn(acc[k], scale));
      q[k] = (t != t) ? 0u : (uint32_t)(int)fminf(fmaxf(t, -127.0f), 127.0f);
    }
  }
  return make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                    pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
}

// One run of `rows` rows: out = combine(a, b), by the warps `warp` of
// `warps`.  Each warp step covers rows [k0, k0 + kStep): lane l < kStep
// carries row k0 + l's scales, half h of the warp the rows k0 + 2u + h.
// The step's rows go through each stage together (sums, absmax shuffles,
// scales, then requantization), so their latencies overlap.
__device__ __forceinline__ void quant_run(const int8_t* __restrict__ qa,
                                          const float* __restrict__ sa,
                                          const int8_t* __restrict__ qb,
                                          const float* __restrict__ sb, int8_t* __restrict__ qo,
                                          float* __restrict__ so, int64_t rows, int64_t warp,
                                          int64_t warps) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int col = (lane & 15) * 16;  // the lane's 16 bytes of its row
  for (int64_t k0 = warp * kStep; k0 < rows; k0 += warps * kStep) {
    float fa = 0.0f, fb = 0.0f;
    if (lane < kStep && k0 + lane < rows) {
      fa = load_scale<kStream == 2>(sa + k0 + lane);
      fb = load_scale<kStream != 0>(sb + k0 + lane);
    }
    uint4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = k0 + 2 * u + half;
      a[u] = b[u] = make_uint4(0, 0, 0, 0);
      if (row < rows) {
        a[u] = flip(load16<kStream == 2>(qa + row * kBlock + col));
        b[u] = flip(load16<kStream != 0>(qb + row * kBlock + col));
      }
    }
    float acc[kUnroll][16], m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float ra = __shfl_sync(0xffffffffu, fa, 2 * u + half);
      const float rb = __shfl_sync(0xffffffffu, fb, 2 * u + half);
      m[u] = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        acc[u][k] =
            __fadd_rn(__fmul_rn(lane_f32(a[u], k), ra), __fmul_rn(lane_f32(b[u], k), rb));
        m[u] = nan_max(m[u], fabsf(acc[u][k]));
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        m[u] = nan_max(m[u], __shfl_xor_sync(0xffffffffu, m[u], off));
    float scale[kUnroll], r[kUnroll];
    bool exact[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      scale[u] = row_scale(m[u], &exact[u]);
      r[u] = __frcp_rn(scale[u]);
    }
    float mine = 0.0f;  // lane l < kStep: the scale of row k0 + l
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint4 o = requant(acc[u], scale[u], r[u], exact[u]);
      const int64_t row = k0 + 2 * u + half;
      if (row < rows) {
        uint4* dst = reinterpret_cast<uint4*>(qo + row * kBlock + col);
        if (kStream == 2) __stcs(dst, o); else *dst = o;
      }
      const float got = __shfl_sync(0xffffffffu, scale[u], (lane & 1) << 4);
      if ((lane >> 1) == u) mine = got;
    }
    if (lane < kStep && k0 + lane < rows) {
      if (kStream == 2) __stcs(so + k0 + lane, mine); else so[k0 + lane] = mine;
    }
  }
}

// Runs: A * n * B of `rows` rows each; run (a, r, b) = blockIdx.y (+ a
// multiple of gridDim.y) reads buf's run (a, (r - 1) mod n, b) and xs's
// run ((a, r, b), c) with c = (r - 2 - step) mod n.  With A = n = B = 1
// it is the elementwise form.
struct Hop {
  const int8_t* qa;
  const float* sa;
  const int8_t* qb;
  const float* sb;
  int8_t* qo;
  float* so;
  int64_t runs, B, rows;
  int n, step;
};

__device__ __forceinline__ void hop_body(const Hop& h) {
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t run = blockIdx.y; run < h.runs; run += gridDim.y) {
    const int64_t b = run % h.B;
    const int64_t r = (run / h.B) % h.n;
    const int64_t a = run / (h.B * h.n);
    const int64_t sender = (a * h.n + (r + h.n - 1) % h.n) * h.B + b;
    const int64_t local = run * h.n + (r + 2 * (int64_t)h.n - 2 - h.step) % h.n;
    quant_run(h.qa + sender * h.rows * kBlock, h.sa + sender * h.rows,
              h.qb + local * h.rows * kBlock, h.sb + local * h.rows, h.qo + run * h.rows * kBlock,
              h.so + run * h.rows, h.rows, warp, warps);
  }
}

// two entry kernels over one body, so a profile tells the forms apart
__global__ void __launch_bounds__(kThreads) quant_combine_kernel(const __grid_constant__ Hop h) {
  hop_body(h);
}

__global__ void __launch_bounds__(kThreads) quant_hop_kernel(const __grid_constant__ Hop h) {
  hop_body(h);
}

// Blocks the card holds resident at once for `kernel`, asked once per kernel.
template <typename K>
int64_t resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t blocks = (int64_t)sms * per_sm;
  return blocks > 0 ? blocks : 1;
}

template <typename K>
int launch(K kernel, int64_t resident, const Hop& h, cudaStream_t stream) {
  const int64_t gy = h.runs < 65535 ? h.runs : 65535;
  const int64_t per_block = (int64_t)kWarps * kStep;
  int64_t gx = (h.rows + per_block - 1) / per_block;
  if (kWaves > 0) {
    const int64_t cap = resident * kWaves / gy;
    if (gx > cap) gx = cap;
  }
  if (gx < 1) gx = 1;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, stream>>>(h);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

// Runs `fn` with `device` current, then restores the caller's device.
template <typename F>
int on_device(int device, F fn) {
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int rc = fn();
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.  Payloads
// are int8 with 256-lane rows, 16-byte aligned; scales f32; all contiguous
// on CUDA device `device` (the wrapper checks).

// qa, qb, qo: [rows, 256]; sa, sb, so: [rows].
extern "C" int acis_quant_combine(const void* qa, const void* sa, const void* qb, const void* sb,
                                  void* qo, void* so, int64_t rows, int device, void* stream) {
  if (rows <= 0) return 0;
  if (!aligned16(qa) || !aligned16(qb) || !aligned16(qo)) return (int)cudaErrorInvalidValue;
  const Hop h{static_cast<const int8_t*>(qa), static_cast<const float*>(sa),
              static_cast<const int8_t*>(qb), static_cast<const float*>(sb),
              static_cast<int8_t*>(qo), static_cast<float*>(so), 1, 1, rows, 1, 0};
  return on_device(device, [&]() {
    static const int64_t resident = resident_blocks(quant_combine_kernel);
    return launch(quant_combine_kernel, resident, h, static_cast<cudaStream_t>(stream));
  });
}

// q_buf: [A, n, B, rows, 256], s_buf: [A, n, B, rows]; q_xs: [A, n, B, n,
// rows, 256], s_xs: [A, n, B, n, rows]; outputs like buf; 0 <= step <= n - 2.
extern "C" int acis_quant_hop(const void* q_buf, const void* s_buf, const void* q_xs,
                              const void* s_xs, void* q_out, void* s_out, int64_t A, int n,
                              int64_t B, int64_t rows, int step, int device, void* stream) {
  if (n < 2 || step < 0 || step > n - 2 || A < 0 || B < 0 || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (A * B * rows == 0) return 0;
  if (!aligned16(q_buf) || !aligned16(q_xs) || !aligned16(q_out)) return (int)cudaErrorInvalidValue;
  const Hop h{static_cast<const int8_t*>(q_buf), static_cast<const float*>(s_buf),
              static_cast<const int8_t*>(q_xs), static_cast<const float*>(s_xs),
              static_cast<int8_t*>(q_out), static_cast<float*>(s_out), A * n * B, B, rows, n,
              step};
  return on_device(device, [&]() {
    static const int64_t resident = resident_blocks(quant_hop_kernel);
    return launch(quant_hop_kernel, resident, h, static_cast<cudaStream_t>(stream));
  });
}
