// Inclusive prefix sum along one dim: x viewed as [B, T, D] (dims before
// the scan dim fold into B, dims after it into D lanes), out[b, t, d] =
// sum over t' <= t of x[b, t', d].  Every (b, d) column is independent.
//
// Replaces the Pallas kernel repro/kernels/chunk_scan.py:prefix_sum (body
// _prefix_kernel), which walks 256-row chunks in order on one core with
// the carry in VMEM scratch.  On the card blocks run in parallel and no
// carry survives between them, so the scan is a single-pass chained scan
// with decoupled look-back (Merrill & Garland), one launch:
//   * the scan dim is cut in tiles; the tiles of one chain (a b and a run
//     of lb lanes) follow each other along T;
//   * each block takes its tile from an atomic counter, tile-major over the
//     chains, so it only ever waits on tiles whose blocks already started;
//   * it reads its tile once into registers and scans it (per thread, then
//     across threads with warp shuffles and shared memory);
//   * per lane it publishes the tile's aggregate, looks back over the
//     predecessors' words (adding aggregates until it meets an inclusive
//     prefix) for its carry-in, publishes its own inclusive prefix, and
//     writes the tile once with the carry added.
// A status word is 64 bits, the flag (1 aggregate, 2 prefix) above the f32
// value, stored and loaded whole (relaxed, device scope), so a reader never
// sees a flag with another value.  A scan of one tile per chain skips the
// look-back and needs no status words.
//
// Bound: device memory.  x is read once and out written once, plus 8 bytes
// of status per lane and tile and a counter (0.1% of x at 8,192 elements a
// tile), zeroed by the caller before the launch.  Every load of a warp is
// one contiguous run: with one lane (D = 1) the tile is warp-striped, each
// thread's 16-byte vectors 512 bytes apart and scanned across the warp with
// shuffles; with D > 1 the 32 threads of a warp read 32 neighbouring lanes
// of one row.
//
// Numbers: f32 and bf16 in, accumulated in f32, each output rounded once to
// x's dtype.  The summation order is this kernel's own (neither torch.cumsum's
// nor XLA's), and a tile's carry-in adds the predecessors' words back to the
// first inclusive prefix it finds, which depends on which blocks had
// published: the last bits may differ from run to run.  Results are exact,
// and so equal to any order, wherever every partial sum is exactly
// representable (integer-valued f32 data below 2^24).
//
// ACIS_SCAN_ROWS (rows a thread scans, 32) can be set at build time for
// tools/probe_scan.py; the wrapper's chunk_scan.ROWS must then match.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
#ifndef ACIS_SCAN_ROWS
#define ACIS_SCAN_ROWS 32
#endif

constexpr int kRows = ACIS_SCAN_ROWS;  // scan rows per thread
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;
constexpr int kMaxPolls = 1 << 26;  // far beyond any predecessor's publish

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

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long flag, float v) {
  const unsigned long long w = flag | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// Tiling: a block covers `lb` lanes (a power of two, 1..32) and
// (kThreads / lb) * kRows rows of one b.  Thread t owns lane t % lb and
// the kRows rows of its row group t / lb.  A chain is (b, lane tile);
// tile id = tile * n_chains + chain.
struct Layout {
  int64_t T, D, n_tiles, n_lane_tiles, n_chains;
  int lb;
};

struct Place {
  int64_t base;   // element offset of (b, row 0, lane)
  int64_t words;  // index of the status word of (chain, tile, lane 0)
  int64_t tile, first, row0;  // the tile, its first row, the thread's
  bool lane_ok;
};

__device__ __forceinline__ Place place(const Layout& L, int64_t id) {
  const int64_t tile_rows = (int64_t)(kThreads / L.lb) * kRows;
  const int64_t chain = id % L.n_chains;
  const int64_t tile = id / L.n_chains;
  const int64_t lt = chain % L.n_lane_tiles;
  const int64_t b = chain / L.n_lane_tiles;
  const int64_t lane = lt * L.lb + threadIdx.x % L.lb;
  Place p;
  p.lane_ok = lane < L.D;
  p.base = b * L.T * L.D + lane;
  p.words = (chain * L.n_tiles + tile) * L.lb;
  p.tile = tile;
  p.first = tile * tile_rows;
  p.row0 = p.first + (int64_t)(threadIdx.x / L.lb) * kRows;
  return p;
}

// The lanes layout (D > 1, or D == 1 without vectors): thread t reads
// the kRows rows of its row group, one element each, of its lane.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, const Layout& L, const Place& p,
                                          float (&v)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = p.row0 + r;
    v[r] = (p.lane_ok && row < L.T) ? to_f32(x[p.base + row * L.D]) : 0.f;
  }
}

// The striped layout (D == 1, T a multiple of the vector width, both
// pointers 16-byte aligned): warp w covers rows [w, w + 1) * 32 * kRows
// of the tile, and its q-th load is thread t's vector q * 32 + t, so each
// load of a warp reads 512 contiguous bytes.  The vectors of one load are
// scanned across the warp with shuffles: ex[q] is the sum of the warp's
// load q before thread t's vector, seg[q] the load's total.
template <typename T>
struct Striped {
  static constexpr int kPer = 16 / sizeof(T);  // elements a vector
  static constexpr int kLoads = kRows / kPer;  // vectors a thread
  static __device__ __forceinline__ int64_t row(const Place& p, int q) {
    return p.first + (int64_t)(threadIdx.x >> 5) * 32 * kRows + q * 32 * kPer +
           (threadIdx.x & 31) * kPer;
  }
};

// The warp's total of the striped tile; v, ex and seg as above.
template <typename T>
__device__ __forceinline__ float striped_in(const T* __restrict__ x, const Layout& L,
                                            const Place& p, float (&v)[kRows],
                                            float (&ex)[Striped<T>::kLoads],
                                            float (&seg)[Striped<T>::kLoads]) {
  using S = Striped<T>;
  const int t = threadIdx.x & 31;
  float warp_total = 0.f;
#pragma unroll
  for (int q = 0; q < S::kLoads; ++q) {
    const int64_t row = S::row(p, q);
    const uint4 u = row < L.T ? __ldcs(reinterpret_cast<const uint4*>(x + p.base + row))
                              : make_uint4(0, 0, 0, 0);
    const T* e = reinterpret_cast<const T*>(&u);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < S::kPer; ++j) {
      v[q * S::kPer + j] = to_f32(e[j]);
      s += v[q * S::kPer + j];
    }
    float inc = s;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, inc, k);
      if (t >= k) inc += up;
    }
    ex[q] = __shfl_up_sync(0xffffffffu, inc, 1);
    if (t == 0) ex[q] = 0.f;
    seg[q] = __shfl_sync(0xffffffffu, inc, 31);
    warp_total += seg[q];
  }
  return warp_total;
}

template <typename T>
__device__ __forceinline__ void striped_out(T* __restrict__ out, const Layout& L, const Place& p,
                                            const float (&v)[kRows],
                                            const float (&ex)[Striped<T>::kLoads],
                                            const float (&seg)[Striped<T>::kLoads], float run) {
  using S = Striped<T>;
#pragma unroll
  for (int q = 0; q < S::kLoads; ++q) {
    const int64_t row = S::row(p, q);
    float r = run + ex[q];
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < S::kPer; ++j) {
      r += v[q * S::kPer + j];
      e[j] = from_f32<T>(r);
    }
    if (row < L.T) *reinterpret_cast<uint4*>(out + p.base + row) = u;
    run += seg[q];
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
  *total = all;
  return before + ex;
}

// The carry-in of this block's tile, by warp 0 (all 32 threads call it):
// thread j watches lane l = j % lb of the predecessor 1 + base + j / lb
// tiles back, so one round reads a window of 32 / lb predecessors of every
// lane at once.  Threads j < lb first publish the tile's aggregate (tile 0:
// its prefix).  A lane's carry adds the window's words up to the nearest
// inclusive prefix (a ballot finds it); a lane without one adds the whole
// window and the next round reads the window before it.  Threads j < lb
// then publish the tile's prefix; every thread returns its lane's carry.
__device__ __forceinline__ float look_back(unsigned long long* __restrict__ status, const Place& p,
                                           int lb, float total) {
  const int j = threadIdx.x, l = j % lb, k = j / lb, window = 32 / lb;
  unsigned long long* mine = status + p.words;  // lane 0's word of this tile
  if (p.tile == 0) {
    if (j < lb) publish(mine + j, kPrefix, total);
    return 0.f;
  }
  if (j < lb) publish(mine + j, kAggregate, total);
  // the bits of lane l's threads in a ballot: l, l + lb, l + 2 lb, ...
  const unsigned lane_bits = (lb == 32 ? 1u : 0xffffffffu / ((1u << lb) - 1)) << l;
  float carry = 0.f;
  bool done = false;
  int polls = 0;
  for (int64_t back = 1 + k; !__all_sync(0xffffffffu, done); back += window) {
    unsigned long long word = kPrefix;  // before tile 0: a prefix of 0.0
    if (!done && back <= p.tile) {
      const unsigned long long* w = mine - back * lb + l;
      do {
        word = peek(w);
        if (++polls > kMaxPolls) __trap();  // a word never published: fail, not hang
      } while ((word >> 32) == 0);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, word >= kPrefix) & lane_bits;
    const int nearest = prefixes ? __ffs(prefixes) - 1 : 32;
    float v = (!done && j <= nearest) ? __uint_as_float((uint32_t)word) : 0.f;
    for (int off = lb; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    carry += v;
    done = done || prefixes != 0;
  }
  if (j < lb) publish(mine + j, kPrefix, carry + total);
  return carry;
}

// status: n_chains * n_tiles * lb words, then the tile counter, all zero;
// nullptr when n_tiles == 1 (the block's tile is then blockIdx.x).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ x, T* __restrict__ out,
                unsigned long long* __restrict__ status, Layout L) {
  __shared__ float wtot[kThreads];
  __shared__ float carry[32];
  __shared__ int64_t tile_id;
  int64_t id = blockIdx.x;
  unsigned long long* counter = nullptr;
  if (status != nullptr) {
    counter = status + L.n_chains * L.n_tiles * L.lb;
    if (threadIdx.x == 0) tile_id = (int64_t)atomicAdd(counter, 1ull);
    __syncthreads();
    id = tile_id;
  }
  const Place p = place(L, id);
  float v[kRows];
  float ex[Striped<T>::kLoads], seg[Striped<T>::kLoads];
  float run, total;
  if (VEC) {
    const float warp_total = striped_in<T>(x, L, p, v, ex, seg);
    if ((threadIdx.x & 31) == 0) wtot[threadIdx.x >> 5] = warp_total;
    __syncthreads();
    run = total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float t = wtot[w];
      if (w < (int)(threadIdx.x >> 5)) run += t;
      total += t;
    }
  } else {
    load_rows<T>(x, L, p, v);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) s += v[r];
    run = group_exclusive(s, L.lb, wtot, &total);
  }
  if (status != nullptr) {
    if (threadIdx.x < 32) {
      const float c = look_back(status, p, L.lb, total);
      if ((int)threadIdx.x < L.lb) carry[threadIdx.x] = c;
    }
    __syncthreads();
    run = carry[threadIdx.x % L.lb] + run;
  }
  if (VEC) {
    striped_out<T>(out, L, p, v, ex, seg, run);
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
int launch(const void* x, void* out, void* status, int64_t B, int64_t T_, int64_t D, int lb,
           int64_t n_tiles, cudaStream_t stream) {
  const int64_t lane_tiles = (D + lb - 1) / lb;
  const Layout L{T_, D, n_tiles, lane_tiles, B * lane_tiles, lb};
  const int64_t blocks = L.n_chains * n_tiles;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffff || B * D > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const bool vec = D == 1 && T_ % (16 / (int64_t)sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  auto* st = n_tiles > 1 ? static_cast<unsigned long long*>(status) : nullptr;
  if (vec)
    scan_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(xs, os, st, L);
  else
    scan_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(xs, os, st, L);
  return (int)cudaGetLastError();
}

}  // namespace

// x and out are contiguous [B, T, D] of dtype 0 = f32 or 1 = bf16 on CUDA
// device `device`.  lb is the block's lane count (a power of two, 1..32)
// and n_tiles = ceil(T / ((256 / lb) * 16)); status holds B * ceil(D / lb)
// * n_tiles * lb + 1 zeroed 8-byte words (unused when n_tiles == 1).
// Returns cudaGetLastError() after the launch (0 = launched), or an error
// code for arguments the kernel does not take.
extern "C" int acis_prefix_sum(const void* x, void* out, void* status, int64_t B, int64_t T,
                               int64_t D, int lb, int64_t n_tiles, int dtype, int device,
                               void* stream) {
  if (lb < 1 || lb > 32 || (lb & (lb - 1)) != 0 || n_tiles < 1 ||
      n_tiles * (int64_t)(kThreads / lb) * kRows < T || (n_tiles > 1 && status == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int prev = device;  // launch with `device` current, then restore the caller's
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int rc = dtype == 0 ? launch<float>(x, out, status, B, T, D, lb, n_tiles, s)
                            : launch<__nv_bfloat16>(x, out, status, B, T, D, lb, n_tiles, s);
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
