// Encoded-domain int8 combine (dequant -> add -> requant): the per-hop
// aggregation of the blockwise-int8 wire format.  Every row is one
// 256-lane quantization block with its f32 scale; the rank dims of the
// ring's chunk are folded into rows, so one launch covers the hop of
// every rank.  Per row:
//
//   acc   = qa * sa + qb * sb                      (f32)
//   scale = absmax(acc) > 0 ? absmax(acc) / 127 : 1
//   q     = clip(rint(acc / scale), -127, 127)     (int8)
//
// Replaces the Pallas kernel repro/kernels/quant_combine.py:quant_combine.
// Bound: device memory, 3 * (256 + 4) bytes per row (two payloads and
// scales read, one written) against ~5 ALU ops per lane.  Design: one warp
// per row; each lane loads 8 int8 of each payload with one 8-byte load,
// and the row's absmax is a warp-shuffle reduction, so nothing but the
// payloads and scales touches device memory.
//
// Bitwise rules, so the kernel equals the plain PyTorch version:
//  * the two products and the sum are rounded separately (__fmul_rn,
//    __fadd_rn): nvcc would otherwise contract them into an FMA;
//  * both divisions are IEEE divisions (__fdiv_rn), never a reciprocal
//    multiply;
//  * rintf rounds half to even, as torch.round and jnp.round do.
// NaN: the absmax propagates NaN (fmaxf alone would drop it), so a row
// holding a NaN -- e.g. from a NaN input scale -- gets scale 1.0, exactly
// as the plain version's where(absmax > 0, ...) gives it; its NaN lanes
// are written as 0, which is what a float-to-int8 conversion of NaN gives
// on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;               // lanes per quantization block
constexpr int kRowsPerCta = 8;            // one warp per row
constexpr int kThreads = 32 * kRowsPerCta;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__global__ void quant_combine_kernel(const int8_t* __restrict__ qa, const float* __restrict__ sa,
                                     const int8_t* __restrict__ qb, const float* __restrict__ sb,
                                     int8_t* __restrict__ qo, float* __restrict__ so,
                                     int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const int64_t base = row * kBlock + lane * 8;
  const uint2 a = *reinterpret_cast<const uint2*>(qa + base);
  const uint2 b = *reinterpret_cast<const uint2*>(qb + base);
  const int8_t* av = reinterpret_cast<const int8_t*>(&a);
  const int8_t* bv = reinterpret_cast<const int8_t*>(&b);
  const float fa = sa[row];
  const float fb = sb[row];
  float acc[8];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc[k] = __fadd_rn(__fmul_rn((float)av[k], fa), __fmul_rn((float)bv[k], fb));
    m = nan_max(m, fabsf(acc[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = (m > 0.0f) ? __fdiv_rn(m, 127.0f) : 1.0f;
  uint2 o;
  int8_t* ov = reinterpret_cast<int8_t*>(&o);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float r = rintf(__fdiv_rn(acc[k], scale));
    ov[k] = (r != r) ? (int8_t)0 : (int8_t)(int)fminf(fmaxf(r, -127.0f), 127.0f);
  }
  *reinterpret_cast<uint2*>(qo + base) = o;
  if (lane == 0) so[row] = scale;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).  The
// payloads are [rows, 256] int8 and the scales [rows] f32, contiguous,
// with 8-byte-aligned payload pointers (the wrapper checks).
extern "C" int acis_quant_combine(const void* qa, const void* sa, const void* qb, const void* sb,
                                  void* qo, void* so, int64_t rows, void* stream) {
  if (rows <= 0) return 0;
  const int64_t ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
  quant_combine_kernel<<<(unsigned)ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), static_cast<const float*>(sa),
      static_cast<const int8_t*>(qb), static_cast<const float*>(sb), static_cast<int8_t*>(qo),
      static_cast<float*>(so), rows);
  return (int)cudaGetLastError();
}
