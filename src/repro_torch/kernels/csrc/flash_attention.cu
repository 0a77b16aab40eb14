// Fused attention on the tensor cores, forward and backward, in the
// FlashAttention-2 form, for the port's model layer.
//
// Replaces no TPU kernel: the reference's attention
// (repro/models/attention.py flash_attention) is a KV-chunked lax.scan that
// XLA fuses, with no Pallas kernel.  It was added because the port's plain
// PyTorch form of that scan (f32 scores, one pass over them per softmax
// step, a ragged last chunk padded with a copy, f32 einsums off the tensor
// cores) held about half of a whisper-small train step.
//
// Layouts (row-major, the model's own):
//   q         [nb, tq, hq, d]    bf16
//   o         [nb, tq, hq, dv]   bf16 (o32: the same in f32; dO the same)
//   k         [nb, tk, hkv, d]   bf16
//   v         [nb, tk, hkv, dv]  bf16
//   lse, dsum [nb, hq, tq]       f32 (log2-sum-exp of S * scale * log2(e);
//                                     rowsum(dO * O) in f32)
// nb is every leading dim times the batch; query head h reads KV head
// h / (hq / hkv).  Key kj is visible to query row i when kj < tk, i < tq,
// kj - i <= hi and kj - i > lo (causal: hi = q_offset; a window w:
// lo = q_offset - w; otherwise the int range's ends).
//
// Accuracy is the f32 result of the plain form, not a bf16 one.  S = q k^T
// takes q, k as they are (bf16, exact products, f32 sums) and scales the f32
// S.  Every f32 operand of a product -- P in P V and in dV = P^T dO, dS in
// dQ = dS K and dK = dS^T Q -- goes to the tensor cores as three bf16 parts,
// hi + mid + lo, which sum back to the f32 value exactly (each part takes
// the next 8 bits of the 24-bit significand), so each product keeps f32's
// bits; dO, V, K, Q are bf16 values already.  The softmax's max and sum are
// f32 in registers, and D = rowsum(dO * O) reads the f32 O.  The forward
// sums each 64-key tile's P V in fresh tensor-core accumulators and adds
// them to O with a rounded f32 add: the tensor cores' own sums then run
// over 64 keys, not a whole row (on an H100, whisper's 1,500-key rows
// summed there left O 4.1 times the error of cuBLAS's f32 product).
//
// Bound: tensor-core operations.  Over nb * hq * tq * tk visible pairs and
// d, the forward does 2 d (S) + 3 * 2 d (P V in three parts) operations a
// pair, the backward 2 * 2 d (S recomputed in both kernels) + 2 * 2 d (dP
// in both) + 3 * 3 * 2 d (dV, dK, dQ); bytes (q, k, v, o read or written
// once) are far below them at whisper's 1,500 frames.  Design: one block of
// 4 warps per 64-row tile, each warp 16 rows, mma.sync m16n8k16 with f32
// accumulation, operands read from XOR-swizzled shared memory by ldmatrix,
// the next 64-row tile copied in by cp.async while this one computes (two
// buffers), tiles that the causal or window mask hides wholly skipped, the
// ragged last tile zero-filled by the copy and masked in registers (no
// padded keys computed into the result).  The backward is deterministic,
// with no atomics: a dK/dV kernel gives each block one K/V tile and loops
// over the Q tiles of the hq / hkv query heads that read it; a dQ kernel
// gives each block one Q tile and loops over the K/V tiles; both recompute
// P from the LSE, and dS = P * (dP - D).  Head dims up to 128 in steps of 8
// run as 64 or 128 columns, the columns past d zero-filled.
//
// The key width may differ from the value width: q and k are d wide, v, o
// and dO dv wide.  Besides d == dv <= 128, one pair is instantiated, d = 192
// and dv = 128: multi-head latent attention's per-head form (128 columns of
// a head's own key and 64 of the rope key every head shares; values of 128).
// Its tiles are larger, so an SM holds two forward blocks and one backward
// block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // rows of a Q tile and of a K/V tile

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* o32;
  const float* lse;
  const float* dsum;
  __nv_bfloat16* o;
  float* o32_out;
  float* lse_out;
  float* dsum_out;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int64_t nb;
  int tq, tk, hq, hkv, d, d_v;  // d: q and k columns; d_v: v, o and dO columns
  int hi, lo;             // visible: lo < kj - i <= hi
  float scale;            // softmax scale
  float scale_log2;       // scale * log2(e)
};

// ---------------------------------------------------------------------------
// shared memory, copies and the tensor-core product
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` of row `r` in a [kTile, DP] bf16 tile:
// chunks XOR-swizzled by the row, so that ldmatrix's 8 rows at one logical
// chunk fall in 8 distinct bank groups.
template <int DP>
__device__ __forceinline__ uint32_t off(int r, int c) {
  return static_cast<uint32_t>(r * (DP * 2) + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows row0 .. row0 + kTile - 1 of a [rows, stride] bf16 matrix (the first
// d columns) into a tile; rows past `rows` and columns past d read as zero.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* g, int64_t stride,
                                          int row0, int rows, int d) {
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = row0 + r < rows && c * 8 < d;
    const __nv_bfloat16* src = ok ? g + (int64_t)(row0 + r) * stride + c * 8 : g;
    cp_async16(tile + off<DP>(r, c), src, ok);
  }
}

__device__ __forceinline__ void ldsm(uint32_t a, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_t(uint32_t a, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The A operand (16 x 16, row-major) at rows r0.., columns k0.. of a tile.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t tile, int r0, int k0, uint32_t* a) {
  const int l = threadIdx.x & 31;
  ldsm(tile + off<DP>(r0 + (l & 15), (k0 >> 3) + (l >> 4)), a);
}
// B operands of two n-tiles (n0, n0 + 8) at k-step k0 where B[k][n] =
// tile[n][k]: b[0], b[1] for n0, b[2], b[3] for n0 + 8.
template <int DP>
__device__ __forceinline__ void load_b(uint32_t tile, int n0, int k0, uint32_t* b) {
  const int l = threadIdx.x & 31;
  ldsm(tile + off<DP>(n0 + (l & 7) + ((l >> 4) << 3), (k0 >> 3) + ((l >> 3) & 1)), b);
}
// The same where B[k][n] = tile[k][n].
template <int DP>
__device__ __forceinline__ void load_bt(uint32_t tile, int n0, int k0, uint32_t* b) {
  const int l = threadIdx.x & 31;
  ldsm_t(tile + off<DP>(k0 + (l & 7) + (((l >> 3) & 1) << 3), (n0 >> 3) + (l >> 4)), b);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// f32 (x, y) as three bf16 pairs hi + mid + lo: each part the round to
// nearest of what the parts before it leave, so the three sum back to x
// and y exactly (24 significand bits in three runs of 8).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& mid,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

// C fragments of n-tiles 2kk and 2kk + 1 (16 x 16 of f32) as the A operand
// of the next product, in three parts.
__device__ __forceinline__ void split_a(const float* c0, const float* c1, uint32_t* ah,
                                        uint32_t* am, uint32_t* al) {
  split(c0[0], c0[1], ah[0], am[0], al[0]);
  split(c0[2], c0[3], ah[1], am[1], al[1]);
  split(c1[0], c1[1], ah[2], am[2], al[2]);
  split(c1[2], c1[3], ah[3], am[3], al[3]);
}

// acc += (hi + mid + lo) . b, the small parts first.
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah, const uint32_t* am,
                                     const uint32_t* al, uint32_t b0, uint32_t b1) {
  mma(c, al, b0, b1);
  mma(c, am, b0, b1);
  mma(c, ah, b0, b1);
}

// 2^x on the special-function unit, results under 2^-126 flushed to zero
// (P there is below every sum it joins by 2^-126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool visible(const Params& p, int i, int kj) {
  const int rel = kj - i;
  return kj < p.tk && i < p.tq && rel <= p.hi && rel > p.lo;
}

// True when every (row, key) of rows i0.. and keys k0.. (a tile each) is
// visible, so the tile needs no mask.
__device__ __forceinline__ bool tile_full(const Params& p, int i0, int k0) {
  return i0 + kTile <= p.tq && k0 + kTile <= p.tk &&
         (int64_t)k0 + kTile - 1 - i0 <= p.hi && (int64_t)k0 - (i0 + kTile - 1) > p.lo;
}

// The K/V tiles [begin, end) that rows i0 .. i1 see.
__device__ __forceinline__ void key_tiles(const Params& p, int i0, int i1, int& begin, int& end) {
  const int64_t kmax = min((int64_t)p.tk - 1, (int64_t)i1 + p.hi);
  const int64_t kmin = max((int64_t)0, (int64_t)i0 + p.lo + 1);
  begin = (int)(kmin / kTile);
  end = kmax < kmin ? begin : (int)(kmax / kTile) + 1;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// forward: O, its f32 copy and the LSE of one 64-row Q tile
// ---------------------------------------------------------------------------

// Blocks an SM holds: three at 64 columns (registers capped to fit them),
// two at 128 and at (192, 128) (shared memory allows no more).
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, DQK <= 64 ? 3 : 2) fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kQBytes = kTile * DQK * 2, kVBytes = kTile * DV * 2;
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + kQBytes;      // two buffers
  const uint32_t sV = sK + 2 * kQBytes;  // two buffers

  const int nqt = (p.tq + kTile - 1) / kTile;
  int64_t bid = blockIdx.x;
  const int qt = (int)(bid % nqt);
  bid /= nqt;
  const int h = (int)(bid % p.hq);
  const int64_t nb = bid / p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qs = (int64_t)p.hq * p.d, ks = (int64_t)p.hkv * p.d;
  const int64_t vs = (int64_t)p.hkv * p.d_v;
  const __nv_bfloat16* qg = p.q + nb * p.tq * qs + (int64_t)h * p.d;
  const __nv_bfloat16* kg = p.k + nb * p.tk * ks + (int64_t)hk * p.d;
  const __nv_bfloat16* vg = p.v + nb * p.tk * vs + (int64_t)hk * p.d_v;
  const int i0 = qt * kTile;
  int jb, je;
  key_tiles(p, i0, min(i0 + kTile, p.tq) - 1, jb, je);

  load_tile<DQK>(sQ, qg, qs, i0, p.tq, p.d);
  if (jb < je) {
    load_tile<DQK>(sK, kg, ks, jb * kTile, p.tk, p.d);
    load_tile<DV>(sV, vg, vs, jb * kTile, p.tk, p.d_v);
  }
  cp_commit();

  const int r0 = warp * 16;
  const int row0 = i0 + r0 + g;  // this thread's rows: row0, row0 + 8
  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = jb; j < je; ++j) {
    const int buf = (j - jb) & 1;
    const uint32_t kb = sK + buf * kQBytes, vb = sV + buf * kVBytes;
    if (j + 1 < je) {
      load_tile<DQK>(sK + (buf ^ 1) * kQBytes, kg, ks, (j + 1) * kTile, p.tk, p.d);
      load_tile<DV>(sV + (buf ^ 1) * kVBytes, vg, vs, (j + 1) * kTile, p.tk, p.d_v);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      uint32_t a[4];
      load_a<DQK>(sQ, r0, kk * 16, a);
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t b[4];
        load_b<DQK>(kb, np * 16, kk * 16, b);
        mma(s[2 * np], a, b[0], b[1]);
        mma(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    const int k0 = j * kTile;
    const bool full = tile_full(p, i0, k0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale_log2;
        if (!full && !visible(p, row0 + (e >> 1) * 8, k0 + n * 8 + 2 * t + (e & 1))) x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with nothing visible yet
      const float corr = exp2f(m[r] - mu[r]);
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(s[n][e] - mu[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }

    // P V of this tile in fresh accumulators, added to O (note above)
    uint32_t ph[kTile / 16][4], pm[kTile / 16][4], pl[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) split_a(s[2 * kk], s[2 * kk + 1], ph[kk], pm[kk], pl[kk]);
#pragma unroll
    for (int np = 0; np < DV / 16; ++np) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t b[4];
        load_bt<DV>(vb, np * 16, kk * 16, b);
        mma3(acc[0], ph[kk], pm[kk], pl[kk], b[0], b[1]);
        mma3(acc[1], ph[kk], pm[kk], pl[kk], b[2], b[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[2 * np][e] += acc[0][e];
        o[2 * np + 1][e] += acc[1][e];
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + r * 8;
    const float sum = quad_sum(l[r]);
    if (i >= p.tq) continue;
    const int64_t at = ((nb * p.tq + i) * p.hq + h) * p.d_v;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col >= p.d_v) continue;
      const float x = sum > 0.f ? o[n][2 * r] / sum : 0.f;
      const float y = sum > 0.f ? o[n][2 * r + 1] / sum : 0.f;
      *reinterpret_cast<float2*>(p.o32_out + at + col) = make_float2(x, y);
      *reinterpret_cast<__nv_bfloat162*>(p.o + at + col) = __floats2bfloat162_rn(x, y);
    }
    if (t == 0)
      p.lse_out[(nb * p.hq + h) * p.tq + i] = sum > 0.f ? m[r] + log2f(sum) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// D = rowsum(dO * O) with the f32 O, one warp a (row, head).
__global__ void __launch_bounds__(256) dsum_kernel(const Params p) {
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);  // (nb, i, h)
  const int lane = threadIdx.x & 31;
  const int64_t rows = p.nb * p.tq * p.hq;
  if (row >= rows) return;
  const __nv_bfloat16* dout = p.dout + row * p.d_v;
  const float* o = p.o32 + row * p.d_v;
  float acc = 0.f;
  for (int c = lane; c < p.d_v; c += 32) acc += __bfloat162float(dout[c]) * o[c];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const int h = (int)(row % p.hq);
    const int64_t ni = row / p.hq;  // nb * tq + i
    const int i = (int)(ni % p.tq);
    const int64_t nb = ni / p.tq;
    p.dsum_out[(nb * p.hq + h) * p.tq + i] = acc;
  }
}

// dQ of one 64-row Q tile over the K/V tiles its rows see.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kQBytes = kTile * DQK * 2, kVBytes = kTile * DV * 2;
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sO = sQ + kQBytes;      // dO
  const uint32_t sK = sO + kVBytes;      // two buffers
  const uint32_t sV = sK + 2 * kQBytes;  // two buffers

  const int nqt = (p.tq + kTile - 1) / kTile;
  int64_t bid = blockIdx.x;
  const int qt = (int)(bid % nqt);
  bid /= nqt;
  const int h = (int)(bid % p.hq);
  const int64_t nb = bid / p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qs = (int64_t)p.hq * p.d, ks = (int64_t)p.hkv * p.d;
  const int64_t os = (int64_t)p.hq * p.d_v, vs = (int64_t)p.hkv * p.d_v;
  const __nv_bfloat16* kg = p.k + nb * p.tk * ks + (int64_t)hk * p.d;
  const __nv_bfloat16* vg = p.v + nb * p.tk * vs + (int64_t)hk * p.d_v;
  const int i0 = qt * kTile;
  int jb, je;
  key_tiles(p, i0, min(i0 + kTile, p.tq) - 1, jb, je);

  load_tile<DQK>(sQ, p.q + nb * p.tq * qs + (int64_t)h * p.d, qs, i0, p.tq, p.d);
  load_tile<DV>(sO, p.dout + nb * p.tq * os + (int64_t)h * p.d_v, os, i0, p.tq, p.d_v);
  if (jb < je) {
    load_tile<DQK>(sK, kg, ks, jb * kTile, p.tk, p.d);
    load_tile<DV>(sV, vg, vs, jb * kTile, p.tk, p.d_v);
  }
  cp_commit();

  const int r0 = warp * 16;
  const int row0 = i0 + r0 + g;
  float lse[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + r * 8;
    const int64_t at = (nb * p.hq + h) * p.tq + i;
    lse[r] = i < p.tq ? p.lse[at] : 0.f;
    dd[r] = i < p.tq ? p.dsum[at] : 0.f;
  }
  float dq[DQK / 8][4];
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = jb; j < je; ++j) {
    const int buf = (j - jb) & 1;
    const uint32_t kb = sK + buf * kQBytes, vb = sV + buf * kVBytes;
    if (j + 1 < je) {
      load_tile<DQK>(sK + (buf ^ 1) * kQBytes, kg, ks, (j + 1) * kTile, p.tk, p.d);
      load_tile<DV>(sV + (buf ^ 1) * kVBytes, vg, vs, (j + 1) * kTile, p.tk, p.d_v);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    if constexpr (DQK == DV) {  // S = Q K^T and dP = dO V^T in one pass
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        uint32_t aq[4], ao[4];
        load_a<DQK>(sQ, r0, kk * 16, aq);
        load_a<DV>(sO, r0, kk * 16, ao);
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          uint32_t b[4];
          load_b<DQK>(kb, np * 16, kk * 16, b);
          mma(s[2 * np], aq, b[0], b[1]);
          mma(s[2 * np + 1], aq, b[2], b[3]);
          load_b<DV>(vb, np * 16, kk * 16, b);
          mma(dp[2 * np], ao, b[0], b[1]);
          mma(dp[2 * np + 1], ao, b[2], b[3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        uint32_t aq[4];
        load_a<DQK>(sQ, r0, kk * 16, aq);
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          uint32_t b[4];
          load_b<DQK>(kb, np * 16, kk * 16, b);
          mma(s[2 * np], aq, b[0], b[1]);
          mma(s[2 * np + 1], aq, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t ao[4];
        load_a<DV>(sO, r0, kk * 16, ao);
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          uint32_t b[4];
          load_b<DV>(vb, np * 16, kk * 16, b);
          mma(dp[2 * np], ao, b[0], b[1]);
          mma(dp[2 * np + 1], ao, b[2], b[3]);
        }
      }
    }
    const int k0 = j * kTile;
    const bool full = tile_full(p, i0, k0);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = full || visible(p, row0 + r * 8, k0 + n * 8 + 2 * t + (e & 1));
        const float pr = ok ? ex2(s[n][e] * p.scale_log2 - lse[r]) : 0.f;
        s[n][e] = pr * (dp[n][e] - dd[r]);  // dS
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t ah[4], am[4], al[4];
      split_a(s[2 * kk], s[2 * kk + 1], ah, am, al);
#pragma unroll
      for (int np = 0; np < DQK / 16; ++np) {
        uint32_t b[4];
        load_bt<DQK>(kb, np * 16, kk * 16, b);
        mma3(dq[2 * np], ah, am, al, b[0], b[1]);
        mma3(dq[2 * np + 1], ah, am, al, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + r * 8;
    if (i >= p.tq) continue;
    const int64_t at = ((nb * p.tq + i) * p.hq + h) * p.d;
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col >= p.d) continue;
      *reinterpret_cast<__nv_bfloat162*>(p.dq + at + col) =
          __floats2bfloat162_rn(dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
    }
  }
}

// dK and dV of one 64-key K/V tile over the Q tiles of every query head
// that reads it.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kQBytes = kTile * DQK * 2, kVBytes = kTile * DV * 2;
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + kQBytes;
  const uint32_t sQ = sV + kVBytes;      // two buffers
  const uint32_t sO = sQ + 2 * kQBytes;  // dO, two buffers
  float* sL = reinterpret_cast<float*>(smem + 3 * kQBytes + 3 * kVBytes);  // [2][kTile] LSE
  float* sD = sL + 2 * kTile;                                              // [2][kTile] D

  const int nkt = (p.tk + kTile - 1) / kTile;
  int64_t bid = blockIdx.x;
  const int kt = (int)(bid % nkt);
  bid /= nkt;
  const int hk = (int)(bid % p.hkv);
  const int64_t nb = bid / p.hkv;
  const int group = p.hq / p.hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qs = (int64_t)p.hq * p.d, ks = (int64_t)p.hkv * p.d;
  const int64_t os = (int64_t)p.hq * p.d_v, vs = (int64_t)p.hkv * p.d_v;
  const int k0 = kt * kTile;
  const int k1 = min(k0 + kTile, p.tk) - 1;
  // the Q tiles [ib, ie) whose rows see a key of this tile
  const int64_t qmax = min((int64_t)p.tq - 1, (int64_t)k1 - p.lo - 1);
  const int64_t qmin = max((int64_t)0, (int64_t)k0 - p.hi);
  const int ib = (int)(qmin / kTile);
  const int nq = qmax < qmin ? 0 : (int)(qmax / kTile) + 1 - ib;
  const int steps = nq * group;

  load_tile<DQK>(sK, p.k + nb * p.tk * ks + (int64_t)hk * p.d, ks, k0, p.tk, p.d);
  load_tile<DV>(sV, p.v + nb * p.tk * vs + (int64_t)hk * p.d_v, vs, k0, p.tk, p.d_v);

  // step s: query head hk * group + s / nq, Q tile ib + s % nq
  auto load_step = [&](int s, int buf) {
    const int h = hk * group + s / nq;
    const int i0 = (ib + s % nq) * kTile;
    load_tile<DQK>(sQ + buf * kQBytes, p.q + nb * p.tq * qs + (int64_t)h * p.d, qs, i0,
                   p.tq, p.d);
    load_tile<DV>(sO + buf * kVBytes, p.dout + nb * p.tq * os + (int64_t)h * p.d_v, os, i0,
                  p.tq, p.d_v);
  };
  // the LSE and D of step s's rows, column threadIdx.x (< kTile)
  auto stats = [&](int s, float& lv, float& dv) {
    const int h = hk * group + s / nq;
    const int i = (ib + s % nq) * kTile + threadIdx.x;
    const int64_t at = (nb * p.hq + h) * p.tq + i;
    lv = i < p.tq ? p.lse[at] : 0.f;
    dv = i < p.tq ? p.dsum[at] : 0.f;
  };
  if (steps > 0) {
    load_step(0, 0);
    if (threadIdx.x < kTile) stats(0, sL[threadIdx.x], sD[threadIdx.x]);
  }
  cp_commit();

  const int r0 = warp * 16;
  const int key0 = k0 + r0 + g;  // this thread's keys: key0, key0 + 8
  float dk[DQK / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n) dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const uint32_t qb = sQ + buf * kQBytes, ob = sO + buf * kVBytes;
    const float* lb = sL + buf * kTile;
    const float* db = sD + buf * kTile;
    float nl = 0.f, nd = 0.f;
    if (s + 1 < steps) {
      load_step(s + 1, buf ^ 1);
      if (threadIdx.x < kTile) stats(s + 1, nl, nd);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
    float st[kTile / 8][4], dpt[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
    if constexpr (DQK == DV) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a<DQK>(sK, r0, kk * 16, ak);
        load_a<DV>(sV, r0, kk * 16, av);
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          uint32_t b[4];
          load_b<DQK>(qb, np * 16, kk * 16, b);
          mma(st[2 * np], ak, b[0], b[1]);
          mma(st[2 * np + 1], ak, b[2], b[3]);
          load_b<DV>(ob, np * 16, kk * 16, b);
          mma(dpt[2 * np], av, b[0], b[1]);
          mma(dpt[2 * np + 1], av, b[2], b[3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        uint32_t ak[4];
        load_a<DQK>(sK, r0, kk * 16, ak);
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          uint32_t b[4];
          load_b<DQK>(qb, np * 16, kk * 16, b);
          mma(st[2 * np], ak, b[0], b[1]);
          mma(st[2 * np + 1], ak, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t av[4];
        load_a<DV>(sV, r0, kk * 16, av);
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          uint32_t b[4];
          load_b<DV>(ob, np * 16, kk * 16, b);
          mma(dpt[2 * np], av, b[0], b[1]);
          mma(dpt[2 * np + 1], av, b[2], b[3]);
        }
      }
    }
    const int i0 = (ib + s % nq) * kTile;
    const bool full = tile_full(p, i0, k0);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);  // query column
        const bool ok = full || visible(p, i0 + c, key0 + (e >> 1) * 8);
        st[n][e] = ok ? ex2(st[n][e] * p.scale_log2 - lb[c]) : 0.f;  // P^T
      }
    }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t ah[4], am[4], al[4];
      split_a(st[2 * kk], st[2 * kk + 1], ah, am, al);
#pragma unroll
      for (int np = 0; np < DV / 16; ++np) {
        uint32_t b[4];
        load_bt<DV>(ob, np * 16, kk * 16, b);
        mma3(dv[2 * np], ah, am, al, b[0], b[1]);
        mma3(dv[2 * np + 1], ah, am, al, b[2], b[3]);
      }
    }
    // dS^T = P^T (dP^T - D); dK += dS^T Q
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] *= dpt[n][e] - db[n * 8 + 2 * t + (e & 1)];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t ah[4], am[4], al[4];
      split_a(st[2 * kk], st[2 * kk + 1], ah, am, al);
#pragma unroll
      for (int np = 0; np < DQK / 16; ++np) {
        uint32_t b[4];
        load_bt<DQK>(qb, np * 16, kk * 16, b);
        mma3(dk[2 * np], ah, am, al, b[0], b[1]);
        mma3(dk[2 * np + 1], ah, am, al, b[2], b[3]);
      }
    }
    if (s + 1 < steps && threadIdx.x < kTile) {
      sL[(buf ^ 1) * kTile + threadIdx.x] = nl;
      sD[(buf ^ 1) * kTile + threadIdx.x] = nd;
    }
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= p.tk) continue;
    const int64_t at = ((nb * p.tk + key) * p.hkv + hk) * p.d;
    const int64_t av = ((nb * p.tk + key) * p.hkv + hk) * p.d_v;
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.d)
        *reinterpret_cast<__nv_bfloat162*>(p.dk + at + col) =
            __floats2bfloat162_rn(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.d_v)
        *reinterpret_cast<__nv_bfloat162*>(p.dv + av + col) =
            __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
int launch(K kernel, int64_t blocks, int threads, size_t smem, cudaStream_t s, const Params& p) {
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int forward(const Params& p, cudaStream_t s) {
  const int64_t blocks = p.nb * p.hq * ((p.tq + kTile - 1) / kTile);
  return launch(fwd_kernel<DQK, DV>, blocks, kThreads, kTile * (3 * DQK + 2 * DV) * 2, s, p);
}

template <int DQK, int DV>
int backward(const Params& p, cudaStream_t s) {
  int rc = launch(dsum_kernel, (p.nb * p.tq * p.hq + 7) / 8, 256, 0, s, p);
  if (rc != 0) return rc;
  rc = launch(dkdv_kernel<DQK, DV>, p.nb * p.hkv * ((p.tk + kTile - 1) / kTile), kThreads,
              3 * kTile * (DQK + DV) * 2 + 4 * kTile * sizeof(float), s, p);
  if (rc != 0) return rc;
  return launch(dq_kernel<DQK, DV>, p.nb * p.hq * ((p.tq + kTile - 1) / kTile), kThreads,
                3 * kTile * (DQK + DV) * 2, s, p);
}

// The widths instantiated: d == dv <= 128 (as 64 or 128 columns), and
// (192, 128).
bool valid(const Params& p) {
  const bool widths = (p.d == p.d_v && p.d <= 128) || (p.d == 192 && p.d_v == 128);
  return p.nb > 0 && p.tq > 0 && p.tk > 0 && p.hkv > 0 && p.hq % p.hkv == 0 && p.d > 0 &&
         p.d % 8 == 0 && widths;
}

// The instantiation of the widths (valid() holds).
template <typename Run>
int dispatch(const Params& p, Run run) {
  using std::integral_constant;
  if (p.d != p.d_v) return run(integral_constant<int, 192>{}, integral_constant<int, 128>{});
  if (p.d <= 64) return run(integral_constant<int, 64>{}, integral_constant<int, 64>{});
  return run(integral_constant<int, 128>{}, integral_constant<int, 128>{});
}

// Runs `launch` with `device` current, then restores the caller's device.
template <typename F>
int on_device(int device, F run) {
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const int rc = run();
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

}  // namespace

// Each returns cudaGetLastError() after its launches (0 = launched), the
// first failure's code, or cudaErrorInvalidValue for a shape the kernels do
// not take.  Pointers are contiguous tensors of the layouts above; d is the
// q and k width, dv (dvw) the v, o and dO width.
extern "C" int acis_flash_fwd(const void* q, const void* k, const void* v, void* o, void* o32,
                              void* lse, int64_t nb, int tq, int tk, int hq, int hkv, int d,
                              int dv, int hi, int lo, float scale, int device, void* stream) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o32_out = static_cast<float*>(o32);
  p.lse_out = static_cast<float*>(lse);
  p.nb = nb; p.tq = tq; p.tk = tk; p.hq = hq; p.hkv = hkv; p.d = d; p.d_v = dv;
  p.hi = hi; p.lo = lo;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return dispatch(p, [&](auto a, auto b) {
      return forward<decltype(a)::value, decltype(b)::value>(p, s);
    });
  });
}

// dsum: [nb, hq, tq] f32 scratch for D.
extern "C" int acis_flash_bwd(const void* q, const void* k, const void* v, const void* o32,
                              const void* lse, const void* dout, void* dsum, void* dq, void* dk,
                              void* dv, int64_t nb, int tq, int tk, int hq, int hkv, int d,
                              int dvw, int hi, int lo, float scale, int device, void* stream) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o32 = static_cast<const float*>(o32);
  p.lse = static_cast<const float*>(lse);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dsum = static_cast<const float*>(dsum);
  p.dsum_out = static_cast<float*>(dsum);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.nb = nb; p.tq = tq; p.tk = tk; p.hq = hq; p.hkv = hkv; p.d = d; p.d_v = dvw;
  p.hi = hi; p.lo = lo;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return dispatch(p, [&](auto a, auto b) {
      return backward<decltype(a)::value, decltype(b)::value>(p, s);
    });
  });
}
