// Elementwise combines shared by the hop-combine and arena-pack kernels.
//
// Every combine is evaluated in f32 (bf16 operands are widened exactly,
// the result rounded once to nearest-even), which is what PyTorch's own
// elementwise kernels do, so the kernels agree bitwise with the plain
// PyTorch versions.
//
// Two rules are written out rather than left to the compiler:
//  * max/min propagate NaN (jnp.maximum / torch.maximum semantics);
//    fmaxf/fminf alone would drop it.  The first operand's NaN wins,
//    then the second's, as in PyTorch.
//  * f32 `x + alpha*y` is a rounded multiply then a rounded add
//    (__fmul_rn, __fadd_rn): nvcc would otherwise contract it into one
//    FMA, which rounds once and differs from the two-op reference.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace acis {

enum Op : int { kAdd = 0, kMax = 1, kMin = 2, kMac = 3 };
enum Dtype : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int OP>
__device__ __forceinline__ float combine_f32(float a, float b, float alpha) {
  if (OP == kAdd) return __fadd_rn(a, b);
  if (OP == kMax) return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
  if (OP == kMin) return (a != a) ? a : ((b != b) ? b : fminf(a, b));
  return __fadd_rn(a, __fmul_rn(alpha, b));  // kMac
}

template <typename T, int OP>
struct Combine;

template <int OP>
struct Combine<float, OP> {
  static __device__ __forceinline__ float apply(float a, float b, float alpha) {
    return combine_f32<OP>(a, b, alpha);
  }
};

template <int OP>
struct Combine<__nv_bfloat16, OP> {
  static __device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 a, __nv_bfloat16 b,
                                                        float alpha) {
    float fa = __bfloat162float(a);
    float fb = __bfloat162float(b);
    if (OP == kMac) {
      // bf16 `x + alpha*y` is two bf16 ops: the product rounds to bf16
      // before the add, as in the two-op reference
      fb = __bfloat162float(__float2bfloat16_rn(__fmul_rn(alpha, fb)));
      return __float2bfloat16_rn(__fadd_rn(fa, fb));
    }
    return __float2bfloat16_rn(combine_f32<OP>(fa, fb, alpha));
  }
};

template <int OP>
struct Combine<int8_t, OP> {
  static __device__ __forceinline__ int8_t apply(int8_t a, int8_t b, float) {
    // add wraps in two's complement, as int8 addition does in jnp/torch
    if (OP == kAdd) return (int8_t)(uint8_t)((int)a + (int)b);
    if (OP == kMax) return a > b ? a : b;
    return a < b ? a : b;  // kMin (int8 mac is refused by the wrapper)
  }
};

}  // namespace acis
