// Arena pack: write N flat parts back to back into a persistent arena, in
// place, optionally combining each part into the arena's current segment
// (arena[seg] = combine(arena[seg], part)).  The rank dims are folded
// into rows: arena is [rows, arena_len], part i is [rows, size_i] and
// lands at columns [offset_i, offset_i + size_i) of every row.
//
// Replaces the Pallas kernel repro/kernels/pack_combine.py:fused_pack.
// Bound: device memory, 2 * sum(size_i) * rows * itemsize bytes for the
// pure pack (read the part, write the arena), 3x with a combine; at the
// sizes a gradient bucket has, the launch itself.  Design:
//  * the part table travels BY VALUE in the kernel parameter (PackParams,
//    __grid_constant__, under 4 KB): no device table, no upload, no host
//    sync.  A pack of more than kMaxParts parts is one launch per group;
//  * a 2-D grid, column tiles of every part in x and rows in y: a block
//    finds its part by a binary search over the tile prefix in the
//    parameter, so there is no per-element division and no table in
//    global memory;
//  * one 16-byte vector per thread per tile where the part's row and its
//    segment share their alignment, scalar head and tail lanes otherwise.
// Lanes past sum(size_i) are never touched: the TPU kernel's whole-arena
// copy exists only because its output aliases the input buffer.
#include "combine.cuh"

constexpr int kMaxParts = 96;

// one launch's table, passed by value
struct PackParams {
  char* arena;
  int64_t arena_len;             // elements per arena row
  int64_t rows;
  int nparts;
  int pad;
  const char* src[kMaxParts];    // device pointer of each part
  int64_t offset[kMaxParts];     // segment start within an arena row
  int64_t size[kMaxParts];       // part elements per row (> 0)
  int tile0[kMaxParts + 1];      // first tile of each part; [nparts] = all
};
static_assert(sizeof(PackParams) <= 4096, "the pack table must stay a small kernel parameter");

namespace {

constexpr int kThreads = 256;
constexpr int kPlain = -1;  // op code of the pure pack

template <typename T, int OP>
__device__ __forceinline__ T pack_one(T dst, T src) {
  if (OP == kPlain) return src;
  return acis::Combine<T, (OP == kPlain ? acis::kAdd : OP)>::apply(dst, src, 1.0f);
}

template <typename T, int OP>
__device__ __forceinline__ uint4 pack_vec(uint4 dst, uint4 src) {
  if (OP == kPlain) return src;
  constexpr int V = 16 / sizeof(T);
  uint4 o;
  const T* d = reinterpret_cast<const T*>(&dst);
  const T* s = reinterpret_cast<const T*>(&src);
  T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int k = 0; k < V; ++k) ov[k] = pack_one<T, OP>(d[k], s[k]);
  return o;
}

// elements from p to the next 16-byte boundary
template <typename T>
__device__ __forceinline__ int64_t head_of(const void* p) {
  return (int64_t)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / (int64_t)sizeof(T);
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) pack_kernel(const __grid_constant__ PackParams p) {
  constexpr int V = 16 / sizeof(T);
  constexpr int64_t kTile = (int64_t)kThreads * V;  // elements a tile covers
  const int t = blockIdx.x;
  int lo = 0, hi = p.nparts - 1;
  while (lo < hi) {  // the last part whose first tile is <= t
    const int mid = (lo + hi + 1) / 2;
    if (p.tile0[mid] <= t) lo = mid; else hi = mid - 1;
  }
  const int64_t size = p.size[lo];
  const int64_t tile = t - p.tile0[lo];
  const T* src0 = reinterpret_cast<const T*>(p.src[lo]);
  T* dst0 = reinterpret_cast<T*>(p.arena) + p.offset[lo];
  const int j = threadIdx.x;
  for (int64_t r = blockIdx.y; r < p.rows; r += gridDim.y) {
    const T* src = src0 + r * size;
    T* dst = dst0 + r * p.arena_len;
    const int64_t head = head_of<T>(src);
    if (head == head_of<T>(dst) && head < size) {
      // vectors from column `head`; tile 0 also takes the head and tail lanes
      const int64_t nvec = (size - head) / V;
      const int64_t v = tile * kThreads + j;
      if (v < nvec) {
        const uint4* s4 = reinterpret_cast<const uint4*>(src + head) + v;
        uint4* d4 = reinterpret_cast<uint4*>(dst + head) + v;
        *d4 = pack_vec<T, OP>(OP == kPlain ? uint4{} : *d4, *s4);
      }
      if (tile == 0) {
        const int64_t tail0 = head + nvec * V;
        if (j < head) dst[j] = pack_one<T, OP>(dst[j], src[j]);
        if (tail0 + j < size) dst[tail0 + j] = pack_one<T, OP>(dst[tail0 + j], src[tail0 + j]);
      }
    } else {
      // scalar lanes: columns [tile * kTile, (tile + 1) * kTile)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t c = tile * kTile + k * kThreads + j;
        if (c < size) dst[c] = pack_one<T, OP>(dst[c], src[c]);
      }
    }
  }
}

template <typename T>
int dispatch_op(int op, const PackParams& p, cudaStream_t s) {
  const dim3 grid((unsigned)p.tile0[p.nparts], (unsigned)(p.rows < 65535 ? p.rows : 65535));
  switch (op) {
    case kPlain: pack_kernel<T, kPlain><<<grid, kThreads, 0, s>>>(p); return 0;
    case acis::kAdd: pack_kernel<T, acis::kAdd><<<grid, kThreads, 0, s>>>(p); return 0;
    case acis::kMax: pack_kernel<T, acis::kMax><<<grid, kThreads, 0, s>>>(p); return 0;
    case acis::kMin: pack_kernel<T, acis::kMin><<<grid, kThreads, 0, s>>>(p); return 0;
  }
  return -1;
}

}  // namespace

extern "C" int acis_fused_pack_max_parts() { return kMaxParts; }

// One launch of nparts in 1..kMaxParts parts.  table, in host memory: their
// device pointers, segment offsets and sizes (nparts int64 each, sizes > 0),
// then the prefix of their tile counts (nparts + 1), back to back; copied
// here into the launch's by-value parameter.  Returns cudaGetLastError()
// after the launch (0 = launched), or -1 for an op/dtype code the kernel
// does not implement or a table out of range.
extern "C" int acis_fused_pack(void* arena, int64_t arena_len, int64_t rows, int nparts,
                               const int64_t* table, int dtype, int op, int device,
                               void* stream) {
  const int64_t* tile0 = table + 3 * nparts;
  if (nparts < 1 || nparts > kMaxParts || rows < 1 || tile0[nparts] < 1 ||
      tile0[nparts] > 0x7fffffff)
    return -1;
  PackParams p{};
  p.arena = static_cast<char*>(arena);
  p.arena_len = arena_len;
  p.rows = rows;
  p.nparts = nparts;
  for (int j = 0; j < nparts; ++j) {
    p.src[j] = reinterpret_cast<const char*>(table[j]);
    p.offset[j] = table[nparts + j];
    p.size[j] = table[2 * nparts + j];
    p.tile0[j] = (int)tile0[j];
  }
  p.tile0[nparts] = (int)tile0[nparts];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  int rc = -1;
  switch (dtype) {
    case acis::kF32: rc = dispatch_op<float>(op, p, s); break;
    case acis::kBF16: rc = dispatch_op<__nv_bfloat16>(op, p, s); break;
    case acis::kI8: rc = dispatch_op<int8_t>(op, p, s); break;
  }
  if (rc == 0) rc = (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
