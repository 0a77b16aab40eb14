// Hop combine: out = combine(x, y) elementwise, in two forms, and the ring
// all-gather beside them.
//
//  * acis_fused_combine — over flat contiguous operands (one launch covers
//    the hop of every rank).
//  * acis_fused_hop — one step of the ring reduce-scatter of every rank at
//    once, reading both operands in place from the all-ranks tensors:
//      out[a, r, b, :] = combine(buf[a, (r - 1) mod n, b, :],
//                                xs[a, r, b, (r - 2 - s) mod n, :])
//    with the rank dims viewed as [A, n, B] around the ring's axis.  On one
//    card every rank's chunk lies in the same memory, so the neighbour's
//    partial sum and the local chunk are found by index arithmetic: no
//    roll, no gather and no index tensor before the combine.
//  * acis_fused_gather — the whole ring all-gather of every rank at once:
//      out[a, r, b, j, :] = first[a, j, b, :]      for every r
//    (each rank ends with every rank's chunk, in rank order).
//
// The combines replace the Pallas kernel
// repro/kernels/fused_combine.py:fused_combine.
// Bound: device memory, 3 * numel * itemsize bytes (two reads, one write)
// against a handful of ALU ops per element; the unfused hop (roll, gather,
// add) moves 7 * numel * itemsize.  Design: each thread keeps `unroll`
// independent 16-byte loads per operand in flight per step (4 f32, 8 bf16
// or 16 int8 lanes each; evict-first where a byte is touched once), with a
// scalar tail.  The elementwise form runs on the grid the card holds
// resident at once (the occupancy query times the SM count, `waves` 1), so
// every thread strides over many vectors; the hop form gives each row
// (a, r, b) of the output its blocks in x and the rows in y, and launches
// one unrolled step per thread (`waves` 0, no grid-stride loop), which
// measured faster for it (tools/probe_combine.py).
//
// The gather replaces no TPU kernel: the reference's all-gather is a ppermute
// loop (repro/core/ring.py:ring_all_gather), n - 1 shifts of a chunk, each
// written into the result at its rank's place.  It is a copy of bytes, so
// one instantiation serves every dtype.  Bound: device memory, (1 + n) *
// first bytes (read every chunk once, write each rank's copy once); the
// PyTorch loop it replaces zeroes the result, then makes n indexed puts and
// n - 1 rolls of every rank's chunk.  Design: a block loads its tile of a
// source segment once, `unroll` 16-byte vectors a thread, and stores it
// into each of the n copies from registers.  Where the segments lie off
// the 16-byte grid, each copy takes a scalar head up to the destination's
// grid, a body of aligned 16-byte stores (each built from the two aligned
// source vectors it straddles by a funnel shift when source and
// destination are out of phase) and a scalar tail: no launch falls back
// to scalar copies.
//
// The combine and hop forms' launch shapes can be set at build time, for
// the probe: ACIS_{COMBINE,HOP}_THREADS per block, ACIS_{COMBINE,HOP}_UNROLL
// loads per operand in flight, ACIS_{COMBINE,HOP}_WAVES resident grids per
// launch (0: one unrolled step per thread), and ACIS_COMBINE_STREAM 0 (no
// cache hints), 1 (the hints above) or 2 (the hop's partial sums
// evict-first too).  The gather has one shape: 256 threads, 4 vectors a
// thread, one unrolled step per thread.
#include "combine.cuh"

#ifndef ACIS_COMBINE_THREADS
#define ACIS_COMBINE_THREADS 512
#endif
#ifndef ACIS_COMBINE_UNROLL
#define ACIS_COMBINE_UNROLL 4
#endif
#ifndef ACIS_COMBINE_WAVES
#define ACIS_COMBINE_WAVES 1
#endif
#ifndef ACIS_HOP_THREADS
#define ACIS_HOP_THREADS 256
#endif
#ifndef ACIS_HOP_UNROLL
#define ACIS_HOP_UNROLL 2
#endif
#ifndef ACIS_HOP_WAVES
#define ACIS_HOP_WAVES 0
#endif
#ifndef ACIS_COMBINE_STREAM
#define ACIS_COMBINE_STREAM 1
#endif

namespace {

struct Shape {
  int threads, unroll, waves;
};
constexpr Shape kCombine{ACIS_COMBINE_THREADS, ACIS_COMBINE_UNROLL, ACIS_COMBINE_WAVES};
constexpr Shape kHop{ACIS_HOP_THREADS, ACIS_HOP_UNROLL, ACIS_HOP_WAVES};
constexpr Shape kGather{256, 4, 0};
constexpr int kStream = ACIS_COMBINE_STREAM;

template <typename T, int OP>
__device__ __forceinline__ uint4 combine_vec(uint4 xa, uint4 ya, float alpha) {
  constexpr int V = 16 / sizeof(T);
  uint4 oa;
  const T* xv = reinterpret_cast<const T*>(&xa);
  const T* yv = reinterpret_cast<const T*>(&ya);
  T* ov = reinterpret_cast<T*>(&oa);
#pragma unroll
  for (int k = 0; k < V; ++k) ov[k] = acis::Combine<T, OP>::apply(xv[k], yv[k], alpha);
  return oa;
}

// out[k] = combine(x[k], y[k]) for k in [0, n), by `lanes` threads of which
// this is `lane`; `vec`: all three pointers are 16-byte aligned.  y is
// read once, so its vectors load evict-first (__ldcs); ONCE marks x and
// out as touched once too (the elementwise form).  In a ring hop x is the
// partial sum the previous hop just wrote and out the one the next hop
// reads, so they stay cached normally.
template <typename T, int OP, bool ONCE, int kUnroll>
__device__ __forceinline__ void combine_run(const T* __restrict__ x, const T* __restrict__ y,
                                            T* __restrict__ out, int64_t n, float alpha,
                                            bool vec, int64_t lane, int64_t lanes) {
  constexpr int V = 16 / sizeof(T);
  const int64_t nvec = vec ? n / V : 0;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);
  const uint4* __restrict__ yv = reinterpret_cast<const uint4*>(y);
  uint4* __restrict__ ov = reinterpret_cast<uint4*>(out);
  int64_t i = lane;
  for (; i + (kUnroll - 1) * lanes < nvec; i += kUnroll * lanes) {
    uint4 xa[kUnroll], ya[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xa[u] = ONCE ? __ldcs(xv + i + u * lanes) : xv[i + u * lanes];
      ya[u] = kStream ? __ldcs(yv + i + u * lanes) : yv[i + u * lanes];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint4 o = combine_vec<T, OP>(xa[u], ya[u], alpha);
      if (ONCE) __stcs(ov + i + u * lanes, o); else ov[i + u * lanes] = o;
    }
  }
  for (; i < nvec; i += lanes) ov[i] = combine_vec<T, OP>(xv[i], yv[i], alpha);
  for (int64_t k = nvec * V + lane; k < n; k += lanes)
    out[k] = acis::Combine<T, OP>::apply(x[k], y[k], alpha);
}

template <typename T, int OP>
__global__ void __launch_bounds__(kCombine.threads)
    combine_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
                   int64_t n, float alpha, bool vec) {
  combine_run<T, OP, kStream != 0, kCombine.unroll>(x, y, out, n, alpha, vec,
                           (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
                           (int64_t)gridDim.x * blockDim.x);
}

// rows = A * n * B output rows of `chunk` elements; row = (a * n + r) * B + b
template <typename T, int OP>
__global__ void __launch_bounds__(kHop.threads)
    hop_kernel(const T* __restrict__ buf, const T* __restrict__ xs, T* __restrict__ out,
               int64_t rows, int n, int64_t B, int64_t chunk, int s, bool vec) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t lanes = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t b = row % B;
    const int64_t r = (row / B) % n;
    const int64_t a = row / (B * n);
    const int64_t sender = (a * n + (r + n - 1) % n) * B + b;  // its row of buf
    const int64_t c = (r + 2 * (int64_t)n - 2 - s) % n;       // 0 <= s <= n - 2
    combine_run<T, OP, kStream == 2, kHop.unroll>(buf + sender * chunk, xs + (row * n + c) * chunk,
                              out + row * chunk, chunk, 1.0f, vec, lane, lanes);
  }
}

// Bytes sh .. sh + 15 of the 32 bytes lo:hi (little-endian words), from
// word Q on: out word m = (w[Q + m + 1]:w[Q + m]) >> b.
template <int Q>
__device__ __forceinline__ uint4 funnel(const uint32_t (&w)[8], uint32_t b) {
  return make_uint4(__funnelshift_r(w[Q], w[Q + 1], b), __funnelshift_r(w[Q + 1], w[Q + 2], b),
                    __funnelshift_r(w[Q + 2], w[Q + 3], b),
                    __funnelshift_r(w[Q + 3], w[Q + 4], b));
}

__device__ __forceinline__ uint4 shifted(uint4 lo, uint4 hi, int sh) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const uint32_t b = (sh & 3) * 8;
  switch (sh >> 2) {  // uniform over the segment: no divergence
    case 0: return funnel<0>(w, b);
    case 1: return funnel<1>(w, b);
    case 2: return funnel<2>(w, b);
    default: return funnel<3>(w, b);
  }
}

// d[k] = s[k] for k in [0, bytes), any alignment, by `lanes` threads of
// which this is `lane` (lanes >= 16): a head of bytes up to d's 16-byte
// grid, aligned 16-byte stores, a tail of bytes.  A store's source bytes
// straddle two aligned vectors when s and d are out of phase; both are
// loaded aligned (each holds a byte of the segment, so neither leaves the
// allocation's 16-byte granule) and funnel-shifted into place.
__device__ __forceinline__ void copy_any(const uint8_t* __restrict__ s, uint8_t* __restrict__ d,
                                        int64_t bytes, int64_t lane, int64_t lanes) {
  const int64_t to_grid = (16 - (int64_t)(reinterpret_cast<uintptr_t>(d) & 15)) & 15;
  const int64_t head = to_grid < bytes ? to_grid : bytes;
  const int64_t nvec = (bytes - head) / 16;
  const int64_t tail = head + nvec * 16;
  if (lane < head) d[lane] = s[lane];
  if (tail + lane < bytes) d[tail + lane] = s[tail + lane];
  const uint8_t* sp = s + head;
  const int sh = (int)(reinterpret_cast<uintptr_t>(sp) & 15);
  const uint4* sv = reinterpret_cast<const uint4*>(sp - sh);
  uint4* dv = reinterpret_cast<uint4*>(d + head);
  if (sh == 0) {
    for (int64_t k = lane; k < nvec; k += lanes) dv[k] = sv[k];
  } else {
    for (int64_t k = lane; k < nvec; k += lanes) dv[k] = shifted(sv[k], sv[k + 1], sh);
  }
}

// Source segment `seg` = (a * J + j) * B + b, of `bytes` bytes, lands in
// rank r's result at segment ((a * n + r) * B + b) * J + j.  J = n when
// B > 1 (a segment is one rank's chunk); J = 1 when B = 1 (then the n
// chunks of one a lie back to back in both, and form one segment).
// ALIGNED: every segment of both lies on the 16-byte grid, so a thread
// loads its `unroll` vectors once and stores them n times.
template <bool ALIGNED>
__global__ void __launch_bounds__(kGather.threads)
    gather_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out, int64_t segs,
                  int n, int64_t B, int64_t J, int64_t bytes) {
  constexpr int U = kGather.unroll;
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t lanes = (int64_t)gridDim.x * blockDim.x;
  const int64_t step = B * J * bytes;  // from rank r's copy to rank r + 1's
  for (int64_t seg = blockIdx.y; seg < segs; seg += gridDim.y) {
    const int64_t b = seg % B;
    const int64_t j = (seg / B) % J;
    const int64_t a = seg / (B * J);
    const uint8_t* s = src + seg * bytes;
    uint8_t* d = out + ((a * n * B + b) * J + j) * bytes;
    if (!ALIGNED) {
      for (int r = 0; r < n; ++r) copy_any(s, d + r * step, bytes, lane, lanes);
      continue;
    }
    const int64_t nvec = bytes / 16;
    const uint4* __restrict__ sv = reinterpret_cast<const uint4*>(s);
    int64_t i = lane;
    for (; i + (U - 1) * lanes < nvec; i += U * lanes) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = sv[i + u * lanes];
      for (int r = 0; r < n; ++r) {
        uint4* dv = reinterpret_cast<uint4*>(d + r * step);
#pragma unroll
        for (int u = 0; u < U; ++u) dv[i + u * lanes] = v[u];
      }
    }
    for (; i < nvec; i += lanes) {
      const uint4 v = sv[i];
      for (int r = 0; r < n; ++r) reinterpret_cast<uint4*>(d + r * step)[i] = v;
    }
  }
}

// Blocks of `sh.threads` the card holds resident at once for `kernel`,
// times `sh.waves`: the grid that keeps every SM full, asked once per
// kernel.
template <typename K>
int64_t resident_blocks(K kernel, Shape sh) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, sh.threads, 0);
  const int64_t blocks = (int64_t)sms * per_sm * sh.waves;
  return blocks > 0 ? blocks : 1;
}

// Blocks for a run of `work` vectors: one unrolled step per thread when
// `sh.waves` is 0, else one vector per thread capped at `cap` blocks.
int64_t grid_for(int64_t work, Shape sh, int64_t cap) {
  const int64_t per_block = (int64_t)sh.threads * (sh.waves == 0 ? sh.unroll : 1);
  int64_t blocks = (work + per_block - 1) / per_block;
  if (sh.waves != 0 && blocks > cap) blocks = cap;
  return blocks > 0 ? blocks : 1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % 16) == 0; }

// threads' worth of work in a run of n elements: vectors plus the tail
template <typename T>
int64_t run_work(int64_t n, bool vec) {
  constexpr int V = 16 / sizeof(T);
  return vec ? n / V + n % V : n;
}

template <typename T, int OP>
void launch_combine(const void* x, const void* y, void* out, int64_t n, float alpha,
                    cudaStream_t stream) {
  static const int64_t resident = resident_blocks(combine_kernel<T, OP>, kCombine);
  const bool vec = aligned16(x) && aligned16(y) && aligned16(out);
  const int64_t blocks = grid_for(run_work<T>(n, vec), kCombine, resident);
  combine_kernel<T, OP><<<(unsigned)blocks, kCombine.threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), n, alpha, vec);
}

template <typename T, int OP>
void launch_hop(const void* buf, const void* xs, void* out, int64_t A, int n, int64_t B,
                int64_t chunk, int s, cudaStream_t stream) {
  static const int64_t resident = resident_blocks(hop_kernel<T, OP>, kHop);
  const bool vec = aligned16(buf) && aligned16(xs) && aligned16(out) &&
                   (chunk * (int64_t)sizeof(T)) % 16 == 0;
  const int64_t rows = A * n * B;
  const int64_t gy = rows < 65535 ? rows : 65535;
  // with waves > 0, the resident grid split over the rows
  const int64_t gx = grid_for(run_work<T>(chunk, vec), kHop, resident / gy);
  hop_kernel<T, OP><<<dim3((unsigned)gx, (unsigned)gy), kHop.threads, 0, stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(xs), static_cast<T*>(out), rows, n, B,
      chunk, s, vec);
}

// first: [A, n, B, chunk_bytes]; out: [A, n, B, n, chunk_bytes].
void launch_gather(const void* first, void* out, int64_t A, int n, int64_t B,
                   int64_t chunk_bytes, cudaStream_t stream) {
  const int64_t J = B == 1 ? 1 : n;
  const int64_t bytes = chunk_bytes * (n / J);
  const int64_t segs = A * J * B;
  const bool aligned = aligned16(first) && aligned16(out) && bytes % 16 == 0;
  const int64_t gy = segs < 65535 ? segs : 65535;
  const int64_t gx = grid_for((bytes + 15) / 16, kGather, 0);
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const auto* src = static_cast<const uint8_t*>(first);
  auto* dst = static_cast<uint8_t*>(out);
  if (aligned)
    gather_kernel<true><<<grid, kGather.threads, 0, stream>>>(src, dst, segs, n, B, J, bytes);
  else
    gather_kernel<false><<<grid, kGather.threads, 0, stream>>>(src, dst, segs, n, B, J, bytes);
}

template <typename T>
int dispatch_combine(int op, const void* x, const void* y, void* out, int64_t n, float alpha,
                     cudaStream_t s) {
  switch (op) {
    case acis::kAdd: launch_combine<T, acis::kAdd>(x, y, out, n, alpha, s); return 0;
    case acis::kMax: launch_combine<T, acis::kMax>(x, y, out, n, alpha, s); return 0;
    case acis::kMin: launch_combine<T, acis::kMin>(x, y, out, n, alpha, s); return 0;
    case acis::kMac: launch_combine<T, acis::kMac>(x, y, out, n, alpha, s); return 0;
  }
  return -1;
}

template <typename T>
int dispatch_hop(int op, const void* buf, const void* xs, void* out, int64_t A, int n,
                 int64_t B, int64_t chunk, int step, cudaStream_t s) {
  switch (op) {
    case acis::kAdd: launch_hop<T, acis::kAdd>(buf, xs, out, A, n, B, chunk, step, s); return 0;
    case acis::kMax: launch_hop<T, acis::kMax>(buf, xs, out, A, n, B, chunk, step, s); return 0;
    case acis::kMin: launch_hop<T, acis::kMin>(buf, xs, out, A, n, B, chunk, step, s); return 0;
  }
  return -1;
}

// Runs `launch` with `device` current, then restores the caller's device.
template <typename F>
int on_device(int device, F launch) {
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int rc = launch();
  const int err = rc != 0 ? rc : (int)cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return err;
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched), or -1 for
// an op/dtype code or a shape the kernel does not implement.
extern "C" int acis_fused_combine(const void* x, const void* y, void* out, int64_t n, int dtype,
                                  int op, float alpha, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    switch (dtype) {
      case acis::kF32: return dispatch_combine<float>(op, x, y, out, n, alpha, s);
      case acis::kBF16: return dispatch_combine<__nv_bfloat16>(op, x, y, out, n, alpha, s);
      case acis::kI8:
        return op == acis::kMac ? -1 : dispatch_combine<int8_t>(op, x, y, out, n, alpha, s);
    }
    return -1;
  });
}

// buf: [A, n, B, chunk]; xs: [A, n, B, n, chunk]; out like buf; 0 <= step <= n - 2.
extern "C" int acis_fused_hop(const void* buf, const void* xs, void* out, int64_t A, int n,
                              int64_t B, int64_t chunk, int step, int dtype, int op, int device,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 2 || step < 0 || step > n - 2) return -1;
  return on_device(device, [&]() {
    switch (dtype) {
      case acis::kF32: return dispatch_hop<float>(op, buf, xs, out, A, n, B, chunk, step, s);
      case acis::kBF16:
        return dispatch_hop<__nv_bfloat16>(op, buf, xs, out, A, n, B, chunk, step, s);
      case acis::kI8: return dispatch_hop<int8_t>(op, buf, xs, out, A, n, B, chunk, step, s);
    }
    return -1;
  });
}

// first: [A, n, B, chunk_bytes] (every rank's chunk, any dtype as bytes);
// out: [A, n, B, n, chunk_bytes], out[a, r, b, j] = first[a, j, b] for every r.
extern "C" int acis_fused_gather(const void* first, void* out, int64_t A, int n, int64_t B,
                                 int64_t chunk_bytes, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || A < 1 || B < 1 || chunk_bytes < 1) return -1;
  return on_device(device, [&]() {
    launch_gather(first, out, A, n, B, chunk_bytes, s);
    return 0;
  });
}
