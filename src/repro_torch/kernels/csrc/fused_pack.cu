// Arena pack: write N flat parts back to back into a persistent arena, in
// place, optionally combining each part into the arena's current segment
// (arena[seg] = combine(arena[seg], part)).  The rank dims are folded
// into rows: arena is [rows, arena_len], part i is [rows, size_i] and
// lands at columns [offset_i, offset_i + size_i) of every row.
//
// Replaces the Pallas kernel repro/kernels/pack_combine.py:fused_pack.
// Bound: device memory, 2 * sum(size_i) * rows * itemsize bytes for the
// pure pack (read the part, write the arena), 3x with a combine.  Design:
// ONE launch for all parts, driven by a small device table of (part
// pointer, segment offset, size, first block); each block finds its part
// by binary search over the table and copies one element range.  The TPU
// kernel's whole-arena copy exists only because its output aliases the
// input buffer; here the kernel writes the arena itself, so lanes past
// sum(size_i) are simply never touched.
#include "combine.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlain = -1;  // op code of the pure pack

struct PackEntry {  // one row of the int64 table the wrapper uploads
  int64_t src;      // device pointer of the part
  int64_t offset;   // segment start within one arena row
  int64_t size;     // part elements per row
  int64_t block0;   // first block of this part
};

template <typename T, int OP>
__global__ void pack_kernel(T* __restrict__ arena, const PackEntry* __restrict__ table,
                            int nparts, int64_t rows, int64_t arena_len, int64_t per_block) {
  const int64_t b = blockIdx.x;
  int lo = 0, hi = nparts - 1;
  while (lo < hi) {  // the last part whose first block is <= b
    const int mid = (lo + hi + 1) / 2;
    if (table[mid].block0 <= b) lo = mid; else hi = mid - 1;
  }
  const PackEntry e = table[lo];
  const T* src = reinterpret_cast<const T*>(e.src);
  const int64_t start = (b - e.block0) * per_block;
  int64_t end = start + per_block;
  if (end > e.size * rows) end = e.size * rows;
  for (int64_t k = start + threadIdx.x; k < end; k += blockDim.x) {
    const int64_t r = k / e.size;
    T* dst = arena + r * arena_len + e.offset + (k - r * e.size);
    if (OP == kPlain) {
      *dst = src[k];
    } else {
      *dst = acis::Combine<T, (OP == kPlain ? acis::kAdd : OP)>::apply(*dst, src[k], 1.0f);
    }
  }
}

template <typename T>
int dispatch_op(int op, void* arena, const void* table, int nparts, int64_t rows,
                int64_t arena_len, int64_t blocks, int64_t per_block, cudaStream_t s) {
  T* a = static_cast<T*>(arena);
  const PackEntry* t = static_cast<const PackEntry*>(table);
  const unsigned g = (unsigned)blocks;
  switch (op) {
    case kPlain:
      pack_kernel<T, kPlain><<<g, kThreads, 0, s>>>(a, t, nparts, rows, arena_len, per_block);
      return 0;
    case acis::kAdd:
      pack_kernel<T, acis::kAdd><<<g, kThreads, 0, s>>>(a, t, nparts, rows, arena_len, per_block);
      return 0;
    case acis::kMax:
      pack_kernel<T, acis::kMax><<<g, kThreads, 0, s>>>(a, t, nparts, rows, arena_len, per_block);
      return 0;
    case acis::kMin:
      pack_kernel<T, acis::kMin><<<g, kThreads, 0, s>>>(a, t, nparts, rows, arena_len, per_block);
      return 0;
  }
  return -1;
}

}  // namespace

// table: device pointer to nparts PackEntry rows (parts of size 0 left
// out); blocks = the total block count the table's block0 column covers.
// Returns cudaGetLastError() after the launch (0 = launched), or -1 for an
// op/dtype code the kernel does not implement.
extern "C" int acis_fused_pack(void* arena, const void* table, int nparts, int64_t rows,
                               int64_t arena_len, int64_t blocks, int64_t per_block,
                               int dtype, int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  switch (dtype) {
    case acis::kF32:
      rc = dispatch_op<float>(op, arena, table, nparts, rows, arena_len, blocks, per_block, s);
      break;
    case acis::kBF16:
      rc = dispatch_op<__nv_bfloat16>(op, arena, table, nparts, rows, arena_len, blocks,
                                      per_block, s);
      break;
    case acis::kI8:
      rc = dispatch_op<int8_t>(op, arena, table, nparts, rows, arena_len, blocks, per_block, s);
      break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
