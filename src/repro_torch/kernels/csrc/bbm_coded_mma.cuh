// The batched codes-in entry of the contracted Broken-Booth dot form on the
// int8 tensor cores (sm_90a): bbm_coded_mma_kernel and its launcher,
// included by bbm_dot.cu.
//
// Replaces repro/kernels/bbm_matmul.py:112 _dot_scaled as the reference
// reaches it through bbm_matmul_coded and bbm_matmul_coded_kblocks on the
// vmapped (slot, kv-head) slices of the int-code KV cache's decode
// attention, and through amm_dot's per-slice products (prefill, the float
// cache's decode).  The function is bbm_dot.cu's bbm_coded_kernel's:
//
//   MODE 1  out[z, m, n] = yq * (s_a[z] * s_b[z, n / block])  (per column)
//   MODE 2  out[z, m, n] = sum over K-blocks j, in order, the first as is,
//           of yq_j * (s_a[z] * s_b[z, j])                    (per K-block)
//
// with yq the f32 sum, in chunk order, of the int32 chunk partials of
// sum_k M(a[z, m, k], b[z, k, n]), times 2^vbl (MODE 2: over the block's
// rows alone, chunks restarting at each block), every f32 operation an
// explicit round-to-nearest intrinsic in that kernel's order.  Codes at or
// past live[z1] on the blocked axis (n in MODE 1, k in MODE 2) read as 0.
//
// Arithmetic.  bbm_mma.cuh's contracted form: per code product 34 byte
// products at wl 16 / vbl 13 kind 0 (21 at kind 1), the cache codes'
// Booth planes (bq, d_r, B2_r, -I1_r, -I2_r, -sum neg_r) against the x
// side's bytes (x, x >> m_r, bit m_r - 1, the nonzero-low indicators, a
// ones plane), two int32 sums lo and hi, the chunk partial lo + 256 hi
// (exact modulo 2^32 in any order and split inside a chunk).
//
// Orientation.  One mma.sync.m16n8k16 (s8/u8 operands, s32 accumulators)
// takes the cache's long axis (b's N: positions for the score product, the
// head dimension for the value product) on its 16 rows and a's M (the g
// query heads of one kv head, 7 at qwen2-0.5b: one n8 tile, 1 of 8 padded)
// on its 8 columns; which operand is A changes no bit, each term being an
// x-side byte times a w-side byte.  A step is 16 deep: it never crosses a
// chunk (a ragged step masks its tail codes to 0), and in MODE 2 a
// 16-position KV block is exactly one step.  wgmma would want 64 rows and
// a 32-deep step, which straddles two KV blocks; at decode's sizes the
// products are a small share beside the decode and the reads.
//
// Fragments.  Lane (g, t) holds rows g and g + 8 of the A fragment, which
// are b's columns n0 + 2g and n0 + 2g + 1 (so a thread's two codes at one
// k are neighbours in the value product's row-major V cache), and k slots
// 4t .. 4t + 3 of the step.  Each lane reads its own codes from device
// memory in the cache's grain and decodes them in registers into the A
// bytes of every plane (a prmt per plane and row), no shared memory: the
// score product's K cache is contiguous along k (a lane's four codes are
// one 8-byte load at int16), the value product's V cache along n (a
// lane's two codes one 4-byte load); other strides gather per element.
// The x side (a's contiguous int32 codes, one 16-byte load a lane) forms
// the B bytes in registers as bbm_mma.cuh's does.
//
// Work.  Decode's products are too small to fill the card one output tile
// a warp (16 slices x 32 position tiles x 4 steps for the scores, 64 tiles
// x 32 K-blocks for the values), and a step's 34 dependent mma.sync and
// its loads are latency, so the K axis is spread over warps.  MODE 1: a
// block of four warps on a 16-row tile of b's N by U n8 tiles of M (U = 4
// where M > 8, else 1); the warps take a chunk's steps round robin (a
// step each for the 64-deep scores: 512 blocks), their int32 sums added
// in shared memory at the chunk's end (exact), and warp 0 flushes the
// chunk in order; a tile wholly past live forms no product.  MODE 2 (the
// value product): the 16-row tile's K-blocks go round robin over the
// warps of a thread-block cluster of up to 8 blocks (a K-block a warp at
// S 512: 16 slices x 4 head-dimension tiles x 8 ranks = 512 blocks, where
// the CUDA-core kernel had 32); each warp descales its blocks' parts,
// yq_j 2^vbl (s_a s_b[j]) (each a __fmul_rn), and pushes them into rank
// 0's shared memory (st.shared::cluster, after a relaxed cluster arrive
// at entry and its wait before the first store); after a cluster barrier
// rank 0 adds them once per output in block order with __fadd_rn, the
// dead blocks' +0 parts included, up to kRound blocks a round.  The
// accumulators are split by plane group (Acc) so that the mma chains run
// side by side.
//
// Bound.  At decode's shapes, device memory: the live cached codes (2
// bytes each), a's codes and the outputs; the byte products at the int8
// tensor-core rate take a fraction of that (chip_smoke.py: coded_bound_ms),
// and a launch's own floor of a few microseconds is above both.  The
// design reads each live code once, in full sectors, skips the dead tiles
// and blocks, and spreads the value product's K over the SMs.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <climits>

#include "bbm_mma.cuh"

namespace bbm_coded {

using bbm_mma::bit_bytes;
using bbm_mma::field;
using bbm_mma::nonzero_low;
using bbm_mma::Op;
using bbm_mma::pack4;
using bbm_mma::prmt;
using bbm_mma::signed_bytes;

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kStep = 16;         // k of one mma.m16n8k16
constexpr int kRows = 16;         // b's N per warp tile
constexpr int kRound = 64;        // MODE 2: K-blocks in rank 0's inbox
constexpr int kPart = kRows * 8;  // floats of one K-block's part

// element strides: b (z1, z2, k, n), s_b (z1, z2, j)
struct Strides {
  long long b1, b2, bk, bn, s1, s2, sj;
};

// d += A B: A the w side (16 rows x 16 k), unsigned where AU; B the x side
// (16 k x 8 columns), unsigned where BU.
template <bool AU, bool BU>
__device__ __forceinline__ void mma(int (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t b) {
  if constexpr (!AU && !BU)
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(b));
  else if constexpr (!AU)
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(b));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(b));
}

// ------------------------------------------------------------ the reads
// four (two) consecutive codes at p, aligned to their size
template <typename T>
__device__ __forceinline__ void load4(const T* p, int (&v)[4]) {
  if constexpr (sizeof(T) == 1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = static_cast<int>(static_cast<int8_t>(w >> (8 * i)));
  } else if constexpr (sizeof(T) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = static_cast<int16_t>(w.x);
    v[1] = static_cast<int16_t>(w.x >> 16);
    v[2] = static_cast<int16_t>(w.y);
    v[3] = static_cast<int16_t>(w.y >> 16);
  } else {
    const int4 w = *reinterpret_cast<const int4*>(p);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  }
}

template <typename T>
__device__ __forceinline__ void load2(const T* p, int& v0, int& v1) {
  if constexpr (sizeof(T) == 1) {
    const uint16_t w = *reinterpret_cast<const uint16_t*>(p);
    v0 = static_cast<int8_t>(w), v1 = static_cast<int8_t>(w >> 8);
  } else if constexpr (sizeof(T) == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    v0 = static_cast<int16_t>(w), v1 = static_cast<int16_t>(w >> 16);
  } else {
    const int2 w = *reinterpret_cast<const int2*>(p);
    v0 = w.x, v1 = w.y;
  }
}

__device__ __forceinline__ bool aligned(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// c[h][i] = code (n0 + 2g + h, k0 + 4t + i) of the slice's b, 0 where
// n >= nlim or 4t + i >= klim (past N or live, past the step or live)
template <typename T>
__device__ __forceinline__ void load_w(const T* __restrict__ bz,
                                       const Strides& st, int n0, int k0,
                                       int nlim, int klim, int (&c)[2][4]) {
  const int lane = threadIdx.x & 31, n = n0 + 2 * (lane >> 2);
  const int kq = 4 * (lane & 3);
  if (st.bk == 1) {                 // k contiguous: the K cache's grain
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const T* p = bz + (n + h) * st.bn + k0 + kq;
      if (n + h < nlim && kq + 3 < klim && aligned(p, 4 * sizeof(T))) {
        load4(p, c[h]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          c[h][i] = n + h < nlim && kq + i < klim ? static_cast<int>(p[i])
                                                  : 0;
      }
    }
  } else {                          // n contiguous (the V cache) or neither
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T* p = bz + (k0 + kq + i) * st.bk + n * st.bn;
      const bool ok = kq + i < klim;
      if (ok && st.bn == 1 && n + 1 < nlim && aligned(p, 2 * sizeof(T))) {
        load2(p, c[0][i], c[1][i]);
      } else {
        c[0][i] = ok && n < nlim ? static_cast<int>(p[0]) : 0;
        c[1][i] = ok && n + 1 < nlim ? static_cast<int>(p[st.bn]) : 0;
      }
    }
  }
}

// The x side's B fragment of n8 tile rows m (lane's column g) at k slots
// 4t .. 4t + 3: the four codes (0 past M or klim) as sign-extended 16-bit
// lanes p02 (codes 0, 2), p13 (1, 3), their high bytes q02, q13, and the
// trailing-zero counts tz (kind 0), as bbm_mma.cuh's XWords.
struct XFrag {
  uint32_t p02, p13, q02, q13, tz;
};

__device__ __forceinline__ XFrag load_x(const int* __restrict__ az, int M,
                                        int K, int m, int k0, int klim,
                                        bool vec, const Op& op) {
  const int kq = 4 * (threadIdx.x & 3);
  const int* p = az + static_cast<size_t>(m) * K + k0 + kq;
  int v[4];
  if (m < M && kq + 3 < klim && vec && ((k0 + kq) & 3) == 0) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = m < M && kq + i < klim ? p[i] : 0;
  }
  const int sh = 32 - op.wl;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = static_cast<int>(static_cast<uint32_t>(v[i]) << sh) >> sh;
  XFrag f;
  f.p02 = prmt(v[0], v[2], 0x5410);
  f.p13 = prmt(v[1], v[3], 0x5410);
  f.q02 = prmt(f.p02, f.p02, 0xB391);
  f.q13 = prmt(f.p13, f.p13, 0xB391);
  f.tz = op.kind ? 0u
                 : pack4(__clz(__brev(v[0])), __clz(__brev(v[1])),
                         __clz(__brev(v[2])), __clz(__brev(v[3])));
  return f;
}

// ------------------------------------------------------------ one step
// Accumulator sets of U n8 tiles: set 0 the low significance of x bq and
// the rows' (x >> m) d_r, set 1 the high one; at U = 1 the B2_r, I1_r and
// I2_r (and kind 1's ones) products go to sets 2, 3 and 4, so that no
// chain of dependent mma.sync is longer than a plane group (U = 4 has its
// four tiles' chains side by side).  Integer sums: the split changes no bit.
template <int U>
struct Acc {
  static constexpr int kSets = U == 1 ? 5 : 2;
  static constexpr int kB2 = U == 1 ? 2 : 0, kI1 = U == 1 ? 3 : 0,
                       kI2 = U == 1 ? 4 : 0;
  int v[U][kSets][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int q = 0; q < kSets; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[u][q][e] = 0;
  }
  // the low significance's sum (any order: exact modulo 2^32)
  __device__ __forceinline__ uint32_t lo(int u, int e) const {
    uint32_t r = static_cast<uint32_t>(v[u][0][e]);
#pragma unroll
    for (int q = 2; q < kSets; ++q) r += static_cast<uint32_t>(v[u][q][e]);
    return r;
  }
  __device__ __forceinline__ uint32_t hi(int u, int e) const {
    return static_cast<uint32_t>(v[u][1][e]);
  }
};

// The products of one 16-deep step into acc (U n8 tiles): the lane's
// eight codes c decode into every plane's A bytes (rows g: c[0], g + 8:
// c[1]), each plane multiplied by the U tiles' x bytes.
template <int U>
__device__ __forceinline__ void step(const Op& op, const int (&c)[2][4],
                                     const XFrag (&xf)[U], Acc<U>& acc) {
  using A = Acc<U>;
  uint32_t cw[2][4], l02[2], l13[2], bq0[2], bq1[2];
  const int sh = 32 - op.wl, lsh = 32 - 2 * op.R;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cw[h][i] = static_cast<uint32_t>(c[h][i]) & op.wlmask;
      // bq: the code less its low 2R bits' Booth value, over 2^vbl
      const int xs = static_cast<int>(cw[h][i] << sh) >> sh;
      const int low = op.R ? static_cast<int>(cw[h][i] << lsh) >> lsh : 0;
      q[i] = (xs - low) >> op.vbl;
    }
    l02[h] = prmt(cw[h][0], cw[h][2], 0x5410);
    l13[h] = prmt(cw[h][1], cw[h][3], 0x5410);
    bq0[h] = pack4(q[0], q[1], q[2], q[3]);
    bq1[h] = pack4(q[0] >> 8, q[1] >> 8, q[2] >> 8, q[3] >> 8);
  }
  // x bq (two significances at most)
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint32_t xl = field(xf[u].p02, xf[u].p13, 0);
    if (op.xb == 1 && op.bqb == 1) {
      mma<false, false>(acc.v[u][0], bq0[0], bq0[1], xl);
    } else if (op.xb == 1) {
      mma<true, false>(acc.v[u][0], bq0[0], bq0[1], xl);
      mma<false, false>(acc.v[u][1], bq1[0], bq1[1], xl);
    } else {
      mma<false, true>(acc.v[u][0], bq0[0], bq0[1], xl);
      mma<false, false>(acc.v[u][1], bq0[0], bq0[1],
                        field(xf[u].q02, xf[u].q13, 0));
    }
  }
#pragma unroll 1
  for (int r = 0; r < op.R; ++r) {
    const int m = op.vbl - 2 * r;
    const uint32_t s0 = bbm_mma::code_selector(l02[0], l13[0], r);
    const uint32_t s1 = bbm_mma::code_selector(l02[1], l13[1], r);
    // (x >> m) d_r
    const uint32_t d0 = prmt(bbm_mma::kDLo, bbm_mma::kDHi, s0);
    const uint32_t d1 = prmt(bbm_mma::kDLo, bbm_mma::kDHi, s1);
    if (signed_bytes(op.wl - 1 - m) == 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        mma<false, false>(acc.v[u][0], d0, d1,
                          m <= 8 ? field(xf[u].p02, xf[u].p13, m)
                                 : field(xf[u].q02, xf[u].q13, m - 8));
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        mma<false, true>(acc.v[u][0], d0, d1, field(xf[u].p02, xf[u].p13, m));
        mma<false, false>(acc.v[u][1], d0, d1,
                          field(xf[u].q02, xf[u].q13, m));
      }
    }
    // b_r B2_r
    const uint32_t e0 = prmt(bbm_mma::kB2Lo, bbm_mma::kB2Hi, s0);
    const uint32_t e1 = prmt(bbm_mma::kB2Lo, bbm_mma::kB2Hi, s1);
#pragma unroll
    for (int u = 0; u < U; ++u)
      mma<false, true>(acc.v[u][A::kB2], e0, e1,
                       bit_bytes(xf[u].p02, xf[u].p13, m - 1));
    if (!op.kind) {
      // nz1_r (-I1_r) and nz2_r (-I2_r)
      const uint32_t i0 = prmt(bbm_mma::kI1Lo, bbm_mma::kI1Hi, s0);
      const uint32_t i1 = prmt(bbm_mma::kI1Lo, bbm_mma::kI1Hi, s1);
      const uint32_t j0 = prmt(bbm_mma::kI2Lo, bbm_mma::kI2Hi, s0);
      const uint32_t j1 = prmt(bbm_mma::kI2Lo, bbm_mma::kI2Hi, s1);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        mma<false, true>(acc.v[u][A::kI1], i0, i1, nonzero_low(xf[u].tz, m));
        mma<false, true>(acc.v[u][A::kI2], j0, j1,
                         nonzero_low(xf[u].tz, m - 1));
      }
    }
  }
  if (op.kind && op.R) {
    // the ones plane against -sum_{r<R} neg_r (a row's sign: bit 2r + 1)
    const uint32_t negs = 0xAAAAu & ((1u << (2 * op.R)) - 1u);
    uint32_t n[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      n[h] = pack4(static_cast<uint32_t>(-__popc(cw[h][0] & negs)),
                   static_cast<uint32_t>(-__popc(cw[h][1] & negs)),
                   static_cast<uint32_t>(-__popc(cw[h][2] & negs)),
                   static_cast<uint32_t>(-__popc(cw[h][3] & negs)));
#pragma unroll
    for (int u = 0; u < U; ++u)
      mma<false, true>(acc.v[u][A::kI1], n[0], n[1], 0x01010101u);
  }
}

// The steps s0 = k0, k0 + stride, ... below k1 (each 16 deep at most,
// ending at k1) into acc; codes at k >= klive read as 0.
template <typename T, int U>
__device__ __forceinline__ void steps(
    const int* __restrict__ az, const T* __restrict__ bz, const Strides& st,
    const Op& op, int M, int K, int n0, int m0, int nlim, int klive, int k0,
    int k1, int stride, bool xvec, Acc<U>& acc) {
  const int g = (threadIdx.x & 31) >> 2;
  for (int s0 = k0; s0 < k1; s0 += stride) {
    const int rb = min(kStep, k1 - s0);
    int c[2][4];
    load_w(bz, st, n0, s0, nlim, min(rb, klive - s0), c);
    XFrag xf[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      xf[u] = load_x(az, M, K, m0 + 8 * u + g, s0, rb, xvec, op);
    step<U>(op, c, xf, acc);
  }
}

// a chunk's partial lo + 256 hi (wrapped) added to its f32 sum in order
__device__ __forceinline__ float flush(float blk, uint32_t lo, uint32_t hi) {
  return __fadd_rn(blk, __int2float_rn(static_cast<int>(lo + (hi << 8))));
}

__device__ __forceinline__ void st_cluster(float* p, int rank, float v) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p)), r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(r), "f"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// MODE 1: grid (ceil(N / 16), ceil(M / 8U), Bt), kThreads.
// MODE 2: grid (ranks * ceil(N / 16), ceil(M / 8), Bt), cluster (ranks, 1,
// 1), kThreads, min(K / block, kRound) * kPart floats of shared memory.
template <typename T, int U, int MODE>
__global__ void __launch_bounds__(kThreads)
bbm_coded_mma_kernel(const int* __restrict__ a, const float* __restrict__ s_a,
                     const T* __restrict__ b, const float* __restrict__ s_b,
                     Strides st, const int* __restrict__ live,
                     float* __restrict__ out, int B2, int M, int K, int N,
                     Op op, int chunk, int block, int ranks, bool xvec) {
  const int z = blockIdx.z, z1 = z / B2, z2 = z % B2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * 8 * U;
  const int* az = a + static_cast<size_t>(z) * M * K;
  const T* bz = b + z1 * st.b1 + z2 * st.b2;
  const float* sbz = s_b + z1 * st.s1 + z2 * st.s2;
  const int lv = live ? live[z1] : INT_MAX;
  const float sa = s_a[z], scale = static_cast<float>(1u << op.vbl);

  if constexpr (MODE == 1) {
    // the block's warps split each chunk's steps; warps 1.. hand their
    // integer sums to warp 0 at the chunk's end
    __shared__ uint32_t red[kWarps - 1][2 * U * 4][32];
    const int n0 = blockIdx.x * kRows, nlim = min(N, lv);
    float sb[2];                    // warp 0's column scales, read early
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 2 * g + h;
      sb[h] = warp == 0 && n < N ? sbz[(n / block) * st.sj] : 0.0f;
    }
    float blk[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) blk[u][e] = 0.0f;
    if (n0 < nlim) {                // else every code of the tile reads 0
      for (int c0 = 0; c0 < K; c0 += chunk) {
        const int cend = min(K, c0 + chunk);
        Acc<U> acc;
        acc.zero();
        steps<T, U>(az, bz, st, op, M, K, n0, m0, nlim, K, c0 + warp * kStep,
                    cend, kWarps * kStep, xvec, acc);
        if (warp)
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              red[warp - 1][8 * u + e][lane] = acc.lo(u, e);
              red[warp - 1][8 * u + 4 + e][lane] = acc.hi(u, e);
            }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              uint32_t lo = acc.lo(u, e), hi = acc.hi(u, e);
#pragma unroll
              for (int w = 0; w < kWarps - 1; ++w) {
                lo += red[w][8 * u + e][lane];
                hi += red[w][8 * u + 4 + e][lane];
              }
              blk[u][e] = flush(blk[u][e], lo, hi);
            }
        }
        __syncthreads();
      }
    }
    if (warp) return;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 2 * g + (e >> 1), m = m0 + 8 * u + 2 * t + (e & 1);
        if (n < N && m < M)
          out[(static_cast<size_t>(z) * M + m) * N + n] =
              __fmul_rn(__fmul_rn(blk[u][e], scale),
                        __fmul_rn(sa, sb[e >> 1]));
      }
  } else {
    extern __shared__ float inbox[];          // rank 0: [kRound][kPart]
    cluster_arrive_relaxed();       // waited on before the first remote store
    const int rank = blockIdx.x % ranks, n0 = (blockIdx.x / ranks) * kRows;
    const int blocks = K / block, klive = max(0, min(K, lv));
    const int gw = rank * kWarps + warp, nw = ranks * kWarps;
    bool waited = false;
    float acc = 0.0f;               // rank 0: output threadIdx.x's sum
    for (int jb = 0; jb < blocks; jb += kRound) {
      const int je = min(blocks, jb + kRound);
      for (int j = jb + gw; j < je; j += nw) {
        float blk[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
        const int kb = j * block;
        const float sbj = sbz[j * st.sj];
        for (int c0 = kb; c0 < min(kb + block, klive); c0 += chunk) {
          // a dead block (kb >= klive) forms nothing: yq_j = 0
          Acc<1> part;
          part.zero();
          steps<T, 1>(az, bz, st, op, M, K, n0, m0, N, klive, c0,
                      min(kb + block, c0 + chunk), kStep, xvec, part);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            blk[0][e] = flush(blk[0][e], part.lo(0, e), part.hi(0, e));
        }
        if (!waited) {
          cluster_wait();
          waited = true;
        }
        const float ss = __fmul_rn(sa, sbj);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st_cluster(inbox + (j - jb) * kPart + (2 * g + (e >> 1)) * 8 +
                         2 * t + (e & 1),
                     0, __fmul_rn(__fmul_rn(blk[0][e], scale), ss));
      }
      if (!waited) {
        cluster_wait();
        waited = true;
      }
      cluster_sync();               // the round's parts are in rank 0's inbox
      if (rank == 0)
        for (int j = jb; j < je; j += 8) {
          float p[8];               // eight loads in flight, then the adds
#pragma unroll
          for (int i = 0; i < 8; ++i)
            p[i] = j + i < je ? inbox[(j + i - jb) * kPart + threadIdx.x]
                              : 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (j + i < je) acc = j + i == 0 ? p[i] : __fadd_rn(acc, p[i]);
        }
      if (je < blocks) cluster_sync();        // the inbox is free again
    }
    const int n = n0 + (threadIdx.x >> 3), m = m0 + (threadIdx.x & 7);
    if (rank == 0 && n < N && m < M)
      out[(static_cast<size_t>(z) * M + m) * N + n] = acc;
  }
}

// Launch on the slices of b's element type T.  Returns the cudaError_t;
// cudaErrorInvalidValue where the tensor-core route cannot compute the
// call (a chunk or, in MODE 2, a K-block shorter than a step, or x and bq
// both two bytes wide).
template <typename T>
cudaError_t launch(const int* a, const float* s_a, const T* b,
                   const float* s_b, const Strides& st, const int* live,
                   float* out, int B1, int B2, int M, int K, int N, int wl,
                   int vbl, int kind, int chunk, int mode, int block,
                   cudaStream_t stream) {
  const Op op = bbm_mma::make_op(wl, vbl, kind);
  if (chunk < kStep || op.xb + op.bqb > 3 || (mode == 2 && block < kStep))
    return cudaErrorInvalidValue;
  const bool xvec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const int bt = B1 * B2;
  if (mode == 1) {
    const dim3 grid_1((N + kRows - 1) / kRows, (M + 7) / 8, bt);
    const dim3 grid_4(grid_1.x, (M + 31) / 32, bt);
    if (M > 8)
      bbm_coded_mma_kernel<T, 4, 1><<<grid_4, kThreads, 0, stream>>>(
          a, s_a, b, s_b, st, live, out, B2, M, K, N, op, chunk, block, 1,
          xvec);
    else
      bbm_coded_mma_kernel<T, 1, 1><<<grid_1, kThreads, 0, stream>>>(
          a, s_a, b, s_b, st, live, out, B2, M, K, N, op, chunk, block, 1,
          xvec);
    return cudaGetLastError();
  }
  // MODE 2: a K-block a warp, up to 8 ranks (decode at S 512: 32 blocks,
  // 8 ranks of 4 warps)
  const int blocks = K / block;
  const int ranks = min(8, max(1, (blocks + kWarps - 1) / kWarps));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * ((N + kRows - 1) / kRows), (M + 7) / 8, bt);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = sizeof(float) * kPart * min(blocks, kRound);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bbm_coded_mma_kernel<T, 1, 2>, a, s_a, b,
                            s_b, st, live, out, B2, M, K, N, op, chunk, block,
                            ranks, xvec);
}

}  // namespace bbm_coded
