// Inclusive prefix sum along one dim: x viewed as [B, T, D] (dims before
// the scan dim fold into B, dims after it into D lanes), out[b, t, d] =
// sum over t' <= t of x[b, t', d].  Every (b, d) column is independent.
//
// Replaces the Pallas kernel repro/kernels/chunk_scan.py:prefix_sum (body
// _prefix_kernel), which walks 256-row chunks in order on one core with
// the carry in VMEM scratch.  On the card blocks run in parallel and no
// carry survives between them, so the scan is reduce-then-scan over tiles
// of the scan dim:
//   1. tile_totals: each block sums one tile of each column;
//   2. scan_totals: one block per column turns the tile totals into each
//      tile's carry-in (an exclusive scan over the tiles);
//   3. scan_tiles:  each block reads its tile again, scans it (per thread
//      in registers, then across threads with warp shuffles and shared
//      memory) with its carry-in added, and writes it once.
// A scan that fits in one tile skips passes 1-2.
//
// Bound: device memory.  The function must read x once and write out once;
// this design reads x twice (passes 1 and 3) and writes once, plus
// B * D * tiles floats of carries -- under 0.1% of x at 4,096 elements per
// tile.  Loads are wide where they can be: with one lane (D = 1) a thread's
// 16 rows are contiguous and move as 16-byte vectors; with D > 1 the 32
// threads of a warp read 32 neighbouring lanes of one row, one coalesced
// transaction.  A single-pass decoupled look-back scan would read x once;
// that is speed work, not this kernel's.
//
// Numbers: f32 and bf16 in, accumulated in f32, each output rounded once to
// x's dtype.  The summation order is this kernel's own (neither torch.cumsum's
// nor XLA's): results are exact, and so equal to any order, wherever every
// partial sum is exactly representable (integer-valued f32 data below 2^24).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // scan rows per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Tiling: a block covers `lb` lanes (a power of two, 1..32) and
// (kThreads / lb) * kRows rows of one b.  Thread t owns lane t % lb and
// the kRows rows of its row group t / lb.
struct Layout {
  int64_t T, D, n_tiles, n_lane_tiles;
  int lb;
};

struct Place {
  int64_t base;  // element offset of (b, row 0, lane)
  int64_t col;   // b * D + lane: the column's index in the carries
  int64_t tile, row0;
  bool lane_ok;
};

__device__ __forceinline__ Place place(const Layout& L) {
  const int64_t tile_rows = (int64_t)(kThreads / L.lb) * kRows;
  int64_t bid = blockIdx.x;
  const int64_t tile = bid % L.n_tiles;
  bid /= L.n_tiles;
  const int64_t lt = bid % L.n_lane_tiles;
  const int64_t b = bid / L.n_lane_tiles;
  const int64_t lane = lt * L.lb + threadIdx.x % L.lb;
  Place p;
  p.lane_ok = lane < L.D;
  p.base = b * L.T * L.D + lane;
  p.col = b * L.D + lane;
  p.tile = tile;
  p.row0 = tile * tile_rows + (int64_t)(threadIdx.x / L.lb) * kRows;
  return p;
}

// VEC: D == 1, T a multiple of the vector width and both pointers 16-byte
// aligned, so a thread whose rows all lie inside T reads them as vectors.
template <typename T, bool VEC>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, const Layout& L, const Place& p,
                                          float (&v)[kRows]) {
  if (VEC && p.row0 + kRows <= L.T) {
    constexpr int per = 16 / sizeof(T);
    const uint4* src = reinterpret_cast<const uint4*>(x + p.base + p.row0);
#pragma unroll
    for (int q = 0; q < kRows / per; ++q) {
      const uint4 u = src[q];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < per; ++j) v[q * per + j] = to_f32(e[j]);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = p.row0 + r;
    v[r] = (p.lane_ok && row < L.T) ? to_f32(x[p.base + row * L.D]) : 0.f;
  }
}

// Exclusive sum of v over the row groups before this thread's, for its
// lane; *total gets the sum over all the block's row groups.  Row groups
// of one lane sit lb threads apart, so a warp scans its 32 / lb groups with
// shuffles (none when lb = 32) and shared memory carries the warps' totals.
__device__ __forceinline__ float group_exclusive(float v, int lb, float* wtot, float* total) {
  const int wl = threadIdx.x & 31, w = threadIdx.x >> 5, l = threadIdx.x % lb;
  float inc = v;
  for (int k = lb; k < 32; k <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, inc, k);
    if (wl >= k) inc += t;
  }
  float ex = 0.f;
  if (lb < 32) {
    ex = __shfl_up_sync(0xffffffffu, inc, lb);
    if (wl < lb) ex = 0.f;
  }
  if (wl >= 32 - lb) wtot[w * lb + l] = inc;  // the warp's total for lane l
  __syncthreads();
  float before = 0.f, all = 0.f;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) {
    const float t = wtot[j * lb + l];
    if (j < w) before += t;
    all += t;
  }
  __syncthreads();  // wtot is free again for the next call
  *total = all;
  return before + ex;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    tile_totals(const T* __restrict__ x, float* __restrict__ carry, Layout L) {
  __shared__ float wtot[kThreads];
  const Place p = place(L);
  float v[kRows];
  load_rows<T, VEC>(x, L, p, v);
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s += v[r];
  float total;
  group_exclusive(s, L.lb, wtot, &total);
  if ((int)threadIdx.x < L.lb && p.lane_ok) carry[p.col * L.n_tiles + p.tile] = total;
}

// In place: carry[col, :] (tile totals) becomes each tile's carry-in.
__global__ void __launch_bounds__(kThreads) scan_totals(float* __restrict__ carry, int64_t n_tiles) {
  __shared__ float wtot[kThreads];
  float* c = carry + (int64_t)blockIdx.x * n_tiles;
  float run = 0.f;
  for (int64_t t0 = 0; t0 < n_tiles; t0 += kThreads) {
    const int64_t t = t0 + threadIdx.x;
    const float v = t < n_tiles ? c[t] : 0.f;
    float total;
    const float ex = group_exclusive(v, 1, wtot, &total);
    if (t < n_tiles) c[t] = run + ex;
    run += total;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    scan_tiles(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ carry,
               Layout L) {
  __shared__ float wtot[kThreads];
  const Place p = place(L);
  float v[kRows];
  load_rows<T, VEC>(x, L, p, v);
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s += v[r];
  float total;
  float run = group_exclusive(s, L.lb, wtot, &total);
  if (carry != nullptr && p.lane_ok) run = carry[p.col * L.n_tiles + p.tile] + run;
  if (VEC && p.row0 + kRows <= L.T) {
    constexpr int per = 16 / sizeof(T);
    uint4* dst = reinterpret_cast<uint4*>(out + p.base + p.row0);
#pragma unroll
    for (int q = 0; q < kRows / per; ++q) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < per; ++j) {
        run += v[q * per + j];
        e[j] = from_f32<T>(run);
      }
      dst[q] = u;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = p.row0 + r;
    run += v[r];
    if (p.lane_ok && row < L.T) out[p.base + row * L.D] = from_f32<T>(run);
  }
}

template <typename T>
int launch(const void* x, void* out, void* carry, int64_t B, int64_t T_, int64_t D, int lb,
           int64_t n_tiles, cudaStream_t stream) {
  const Layout L{T_, D, n_tiles, (D + lb - 1) / lb, lb};
  const int64_t blocks = B * L.n_lane_tiles * n_tiles;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffff || B * D > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const bool vec = D == 1 && T_ % (16 / (int64_t)sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  float* cs = n_tiles > 1 ? static_cast<float*>(carry) : nullptr;
  if (cs != nullptr) {
    if (vec)
      tile_totals<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(xs, cs, L);
    else
      tile_totals<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(xs, cs, L);
    scan_totals<<<(unsigned)(B * D), kThreads, 0, stream>>>(cs, n_tiles);
  }
  if (vec)
    scan_tiles<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(xs, os, cs, L);
  else
    scan_tiles<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(xs, os, cs, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x and out are contiguous [B, T, D] of dtype 0 = f32 or 1 = bf16.  lb is
// the block's lane count (a power of two, 1..32) and n_tiles =
// ceil(T / ((256 / lb) * 16)); carry holds B * D * n_tiles floats (unused
// when n_tiles == 1).  Returns cudaGetLastError() after the launches
// (0 = launched), or an error code for arguments the kernel does not take.
extern "C" int acis_prefix_sum(const void* x, void* out, void* carry, int64_t B, int64_t T,
                               int64_t D, int lb, int64_t n_tiles, int dtype, void* stream) {
  if (lb < 1 || lb > 32 || (lb & (lb - 1)) != 0 || n_tiles < 1 ||
      n_tiles * (int64_t)(kThreads / lb) * kRows < T || (n_tiles > 1 && carry == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, carry, B, T, D, lb, n_tiles, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, carry, B, T, D, lb, n_tiles, s);
  return (int)cudaErrorInvalidValue;
}
