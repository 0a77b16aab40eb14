// Candidate designs of the top-k scatter-accumulate that tools/probe_topk.py
// times beside the kernel the port ships (src/repro_torch/kernels/csrc/
// topk_accum.cu).  Neither is on any path.
//
//  * first_topk_accumulate: the port's first design -- one thread an entry,
//    a grid-stride loop of at most 132 x 32 blocks, the row found by an
//    int64 division per entry, one atomicAdd each.
//  * binned_topk_accumulate: a counting sort of each row's payload by
//    address window (idx >> shift) into a scratch payload -- a histogram
//    pass, a scan of each row's bins, a scatter of (idx, val) into them --
//    then one reduction per entry of the binned payload, so that the
//    entries a warp issues together fall in one window of the accumulator.
//
// Both add dense[row, idx[row, j]] += vals[row, j] in place and drop
// indices outside [0, size), as the shipped kernel does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPartTile = 8192;  // entries a block bins
constexpr int kPartThreads = 512;
constexpr int kMaxBins = 8192;   // bins a row (32 KB of shared counters)
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ bool in_range(int32_t j, int64_t size) { return j >= 0 && j < size; }

__global__ void first_kernel(float* __restrict__ dense, const int32_t* __restrict__ idx,
                             const float* __restrict__ vals, int64_t size, int64_t k,
                             int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int64_t j = idx[t];
    if (j < 0 || j >= size) continue;
    atomicAdd(dense + (t / k) * size + j, vals[t]);
  }
}

// pass 1: each row's in-range entries counted by bin into counts[row][bin]
__global__ void __launch_bounds__(kPartThreads)
    bin_count_kernel(const int32_t* __restrict__ idx, int64_t size, int k, int rows, int shift,
                     int nb, int* __restrict__ counts) {
  extern __shared__ int hist[];
  const int e0 = blockIdx.x * kPartTile, e1 = e0 + kPartTile < k ? e0 + kPartTile : k;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    for (int b = threadIdx.x; b < nb; b += kPartThreads) hist[b] = 0;
    __syncthreads();
    const int32_t* ir = idx + (int64_t)row * k;
    for (int e = e0 + threadIdx.x; e < e1; e += kPartThreads) {
      const int32_t j = ir[e];
      if (in_range(j, size)) atomicAdd(&hist[j >> shift], 1);
    }
    __syncthreads();
    int* c = counts + (int64_t)row * (nb + 1);
    for (int b = threadIdx.x; b < nb; b += kPartThreads)
      if (hist[b]) atomicAdd(&c[b], hist[b]);
    __syncthreads();
  }
}

// pass 2: one block a row turns its counts into exclusive bin starts and
// writes the row's total after them
__global__ void __launch_bounds__(1024) bin_scan_kernel(int* __restrict__ counts, int nb) {
  __shared__ int warp_sums[32];
  int* c = counts + (int64_t)blockIdx.x * (nb + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (nb + 1023) / 1024, lo = tid * per, hi = lo + per < nb ? lo + per : nb;
  int local = 0;
  for (int b = lo; b < hi; ++b) local += c[b];
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += x;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += x;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  int run = incl - local + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int b = lo; b < hi; ++b) {
    const int x = c[b];
    c[b] = run;
    run += x;
  }
  if (tid == 1023) c[nb] = run;
}

// pass 3: each block counts its tile again, reserves a range of every bin
// it touches and scatters its (idx, val) pairs into them
__global__ void __launch_bounds__(kPartThreads)
    bin_partition_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                         int64_t size, int k, int rows, int shift, int nb,
                         int* __restrict__ cursor, int32_t* __restrict__ sidx,
                         float* __restrict__ svals) {
  extern __shared__ int hist[];
  const int e0 = blockIdx.x * kPartTile, e1 = e0 + kPartTile < k ? e0 + kPartTile : k;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    for (int b = threadIdx.x; b < nb; b += kPartThreads) hist[b] = 0;
    __syncthreads();
    const int32_t* ir = idx + (int64_t)row * k;
    const float* vr = vals + (int64_t)row * k;
    for (int e = e0 + threadIdx.x; e < e1; e += kPartThreads) {
      const int32_t j = ir[e];
      if (in_range(j, size)) atomicAdd(&hist[j >> shift], 1);
    }
    __syncthreads();
    int* c = cursor + (int64_t)row * (nb + 1);
    for (int b = threadIdx.x; b < nb; b += kPartThreads)
      if (hist[b]) hist[b] = atomicAdd(&c[b], hist[b]);  // the block's first slot
    __syncthreads();
    for (int e = e0 + threadIdx.x; e < e1; e += kPartThreads) {
      const int32_t j = ir[e];
      if (!in_range(j, size)) continue;
      const int pos = atomicAdd(&hist[j >> shift], 1);
      sidx[(int64_t)row * k + pos] = j;
      svals[(int64_t)row * k + pos] = vr[e];
    }
    __syncthreads();
  }
}

// pass 4: one reduction per binned entry, row_len[row * stride] entries a row
__global__ void __launch_bounds__(256)
    binned_scatter_kernel(float* __restrict__ dense, const int32_t* __restrict__ sidx,
                          const float* __restrict__ svals, int64_t size, int k, int rows,
                          const int* __restrict__ row_len, int stride) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    if (e < row_len[(int64_t)row * stride])
      atomicAdd(dense + (int64_t)row * size + sidx[(int64_t)row * k + e],
                svals[(int64_t)row * k + e]);
  }
}

}  // namespace

extern "C" int first_topk_accumulate(void* dense, const void* idx, const void* vals,
                                     int64_t rows, int64_t size, int64_t k, void* stream) {
  const int64_t total = rows * k;
  if (total <= 0) return 0;
  int64_t blocks = (total + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  first_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dense), static_cast<const int32_t*>(idx),
      static_cast<const float*>(vals), size, k, total);
  return (int)cudaGetLastError();
}

// Int32 elements of binned_topk_accumulate's scratch.
extern "C" int64_t binned_scratch_elems(int64_t rows, int64_t size, int64_t k, int shift) {
  return rows * (2 * k + ((size - 1) >> shift) + 2);
}

// shift: windows of 2^shift lanes, at most kMaxBins a row; scratch: an
// int32 buffer of binned_scratch_elems() elements.
extern "C" int binned_topk_accumulate(void* dense, const void* idx, const void* vals,
                                      int64_t rows, int64_t size, int64_t k, int shift,
                                      void* scratch, void* stream) {
  if (rows <= 0 || k <= 0 || size <= 0) return 0;
  const int64_t nb = ((size - 1) >> shift) + 1;
  if (nb > kMaxBins || k >= INT32_MAX || rows >= INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const float* v = static_cast<const float*>(vals);
  int32_t* sidx = static_cast<int32_t*>(scratch);
  float* svals = reinterpret_cast<float*>(sidx + rows * k);
  int* counts = sidx + 2 * rows * k;
  cudaError_t e = cudaMemsetAsync(counts, 0, rows * (nb + 1) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned gy = (unsigned)(rows < kMaxGridY ? rows : kMaxGridY);
  const dim3 grid((unsigned)((k + kPartTile - 1) / kPartTile), gy);
  const size_t smem = nb * sizeof(int);
  bin_count_kernel<<<grid, kPartThreads, smem, s>>>(i, size, (int)k, (int)rows, shift, (int)nb,
                                                    counts);
  bin_scan_kernel<<<(unsigned)rows, 1024, 0, s>>>(counts, (int)nb);
  bin_partition_kernel<<<grid, kPartThreads, smem, s>>>(i, v, size, (int)k, (int)rows, shift,
                                                        (int)nb, counts, sidx, svals);
  binned_scatter_kernel<<<dim3((unsigned)((k + 255) / 256), gy), 256, 0, s>>>(
      static_cast<float*>(dense), sidx, svals, size, (int)k, (int)rows, counts + nb,
      (int)(nb + 1));
  return (int)cudaGetLastError();
}
