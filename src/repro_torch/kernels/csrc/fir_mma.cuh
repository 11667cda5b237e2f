// The FIR filterbank's tap sum on the int8 tensor cores (sm_90a): one
// kernel and its host-side launcher, reached by both fir_bank_rows and
// fir_bank_dot wherever shift <= vbl (fir_kernel.py: fir_bank_route).
//
// It replaces, on that route, the Pallas kernel
// repro/kernels/fir_kernel.py _fir_bank_kernel and the XLA dot form
// _fir_bank_dotform.  At shift <= vbl every Broken-Booth product is 2^vbl
// M (bbm_mma.cuh: M = x bq + sum_{r<R} floor((d_r x - kind neg_r) /
// 2^m_r)), so each product's >> shift is exact and
//
//   y[c, n] = (sum_k M(x[c, n - k], h[c, k])) << (vbl - shift),
//
// one contraction per channel.  The floor split of bbm_mma.cuh turns M
// into byte products at one scale (34 a tap product at wl 16 / vbl 13
// kind 0, 20 at kind 1 with the constant below), summed exactly as lo +
// 256 hi in two int32 accumulators: inside the envelope taps
// 2^(2 wl - 1 - shift) < 2^31 the true sum fits in int32, so the wrapped
// sums are exact.
//
// A banded (Toeplitz) product.  For B = 64 consecutive outputs of one
// channel, y[n0 + 64 j + i] = sum_m A[j][m] H[m][i] with the x window
// A[j][m] = x[n0 + 64 j + m - P] and the band H[m][i] = h[i + P - m]
// where 0 <= i + P - m < taps, else 0; P = taps - 1 rounded up to a
// multiple of 4, m < K = 32 ks, ks = ceil((P + 64) / 32).  A warpgroup
// owns 64 rows j (4,096 outputs): wgmma.m64n64k32, A from registers, B
// (each byte plane of the band, one k step) from shared memory.  A k step
// whose band is zero in one half of the 64 columns runs m64n32k32 on the
// other half only (at 31 taps the first and last of the three k steps:
// 64 k of the 96 are multiplied per column instead of 96).
//
// The band.  One block owns one channel's range of time tiles.  It
// decodes its channel's band once, straight from the (wl/2, C, taps)
// digit planes (faulted ones too: any mag in {0, 1, 2}, neg in {0, 1}),
// into wgmma's K-major layout (mma_bytes.cuh: plane_desc): per k step,
// bq's bytes, then per truncated row d_r, B2_r and, at kind 0, -I1_r and
// -I2_r (29 planes of 2 KB a k step at wl 16 / vbl 13 kind 0, 15 at kind
// 1).  Taps outside the band decode as a zero digit, whose bytes are all
// zero.  Kind 1's term -sum_r neg_r of every tap does not depend on x, so
// it is one constant of the channel, -sum_k sum_{r<R} neg_r[c, k], added
// in the epilogue instead of a ones plane.  It must not be masked over the
// zero history before n = 0: a sample of value 0 against a negative
// truncated digit still gives floor(-1 / 2^m) = -1 a row.
//
// The x side.  A block stages its tile's samples (64 x 64 per warpgroup,
// plus the P before it and the band's overhang after it; zeros outside
// [0, N)) once, sign-extended, as 16-bit lanes: each 4-sample group as two
// words (samples 0 and 2, 1 and 3), 40 words a 16 groups so that a warp's
// fragment loads touch every bank twice at most.  Rows of A overlap by
// taps - 1 samples; forming A in registers (mma_bytes.cuh: field,
// nonzero_low) reads the overlap from the one staged copy, so
// the window is never materialised.
//
// The schedule.  A block of four warpgroups (one a 227 KB SM) owns one
// channel's range of tiles, about SMs / C ranges a channel; a tile is 64
// rows a warpgroup, each warpgroup's 64 x 64 outputs written as 8-byte
// pairs that fill whole 32-byte sectors.  Each warpgroup issues its k
// step's products one wgmma at a time, forming the next A bytes while
// the last runs.  Where the tiles fill under half the SMs (a short
// flush), a tile is one 64-row group instead and the four warpgroups
// share it: warpgroup w takes the truncated rows w, w + 4, ... (and
// warpgroup 0 x bq), and their sums meet in shared memory (atomic adds,
// exact modulo 2^32), which cuts each warpgroup's chain of products to a
// quarter.  fir_kernel.py: fir_mma_smem mirrors smem_bytes for one
// 64-row group, the route rule's test that the band fits.
//
// Bound.  The bytes: x read once and y written once, 8 bytes a sample
// (0.010 ms at flush A's (64, 65536) x 31 taps on an H100's 3.35 TB/s);
// the fewest byte products of the exact forms known (34 a tap product at
// kind 0) take 0.0045 ms at 1,979 TOP/s.  The band's structure costs
// 64 / 31 of that on the tensor cores.  What sets the time is the chain
// of small products: tens of CUDA-core instructions form each wgmma's A
// bytes and descriptor, ptxas makes each wgmma wait for the last (C7511,
// once a k step mixes the two widths), and the two sides overlap only
// across warpgroups.  Two wgmmas in flight, a row's wgmmas in one batch,
// every step at one width, and mma.sync instead of wgmma measured no
// faster.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bytes.cuh"

namespace fir_mma {

using bbm_mma::Op;
using bbm_mma::field;
using bbm_mma::nonzero_low;
using bbm_mma::pack4;
using bbm_mma::plane_desc;
using bbm_mma::prmt;

constexpr int kMaxWG = 4;                  // warpgroups a block at most
constexpr int kPlaneWords = 32 * 64 / 4;   // one byte plane, one k step
constexpr int kSmemLimit = 232448;         // shared memory a block may use

// The band's geometry, fixed per launch.
struct Band {
  int P;            // history samples staged before a tile (4 | P >= taps-1)
  int ks;           // k steps of 32
  int planes;       // byte planes a k step
  int nwg;          // warpgroups a block
  int split;        // 0: a warpgroup a 64-row group of the tile (64 nwg
                    // rows); 1: the tile is one 64-row group, and the
                    // truncated rows are dealt out to the warpgroups
  uint32_t halves;  // 2 bits a k step: 0 all 64 columns, 1 columns 0-31,
                    // 2 columns 32-63 (the band is zero in the other half)
};

// 4-sample groups a tile stages, and the words they take (40 a 16)
__host__ __device__ constexpr int span_groups(int nwg, int ks) {
  return (64 * (64 * nwg - 1) + 32 * ks) / 4;
}
__host__ __device__ constexpr int x_words(int groups) {
  return 40 * ((groups + 15) / 16);
}
// 64-row groups a tile
__host__ __device__ constexpr int tile_groups(const Band& b) {
  return b.split ? 1 : b.nwg;
}
// the band's planes, the staged x, and (split) the tile's partial sums
__host__ __device__ constexpr size_t smem_bytes(const Band& b) {
  return static_cast<size_t>(b.ks) * b.planes * kPlaneWords * 4 +
         4 * static_cast<size_t>(x_words(span_groups(tile_groups(b), b.ks))) +
         (b.split ? 4 * 4096 : 0);
}

inline Band make_band(int taps, const Op& op) {
  Band b;
  b.P = (taps + 2) & ~3;
  b.ks = (b.P + 64 + 31) / 32;
  b.planes = op.planes - (op.kind && op.R ? 1 : 0);   // no ones plane
  b.nwg = kMaxWG;
  b.split = 0;
  b.halves = 0;
  for (int s = 0; s < b.ks && s < 16; ++s) {
    const int lo = 32 * s - b.P, hi = 32 * s + 31 - b.P + taps - 1;
    b.halves |= static_cast<uint32_t>(hi < 32 ? 1 : (lo >= 32 ? 2 : 0))
                << (2 * s);
  }
  return b;
}

// ------------------------------------------------------------- wgmma
// wgmma.mma_async m64n64k32 (n32: m64n32k32), A (the warpgroup's 64 rows:
// each warp's 16 in the mma fragment layout) from registers, B (32 k x 64
// or 32 n) from a shared-memory plane, s32 accumulators (n8 tile j's four
// at d[4 j]), d += A B.
__device__ __forceinline__ void wgmma64_ss(int* d, const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma64_su(int* d, const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma64_us(int* d, const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma64_uu(int* d, const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma32_ss(int* d, const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma32_su(int* d, const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma32_us(int* d, const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma32_uu(int* d, const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

template <bool AS, bool BS>
__device__ __forceinline__ void wgmma64(int* d, const uint32_t (&a)[4],
                                        uint64_t desc) {
  if (AS && BS) wgmma64_ss(d, a, desc);
  else if (AS) wgmma64_su(d, a, desc);
  else if (BS) wgmma64_us(d, a, desc);
  else wgmma64_uu(d, a, desc);
}

template <bool AS, bool BS>
__device__ __forceinline__ void wgmma32(int* d, const uint32_t (&a)[4],
                                        uint64_t desc) {
  if (AS && BS) wgmma32_ss(d, a, desc);
  else if (AS) wgmma32_su(d, a, desc);
  else if (BS) wgmma32_us(d, a, desc);
  else wgmma32_uu(d, a, desc);
}

// acc += a times the plane whose descriptor is `desc` over the k step's
// live columns (H: 0 all 64, 1 columns 0-31, 2 columns 32-63): one
// asynchronous wgmma on a copy `ai` of a, issued once the previous one,
// which read ai, is done; the caller forms the next a meanwhile
// (bbm_mma.cuh: products).
template <int H, bool AS, bool BS>
__device__ __forceinline__ void mma(int (&acc)[32], uint32_t (&ai)[4],
                                    const uint32_t (&a)[4], uint64_t desc) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  bbm_mma::hold(ai);
#pragma unroll
  for (int i = 0; i < 4; ++i) ai[i] = a[i];
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  if (H == 0)
    wgmma64<AS, BS>(acc, ai, desc);
  else if (H == 1)
    wgmma32<AS, BS>(acc, ai, desc);
  else   // n8 tiles 4-7: column group 4 of the plane, 1,024 bytes on
    wgmma32<AS, BS>(acc + 16, ai, desc + (4 * 256 >> 4));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------ the band
// Four k bytes of a column into k quads tq and 4 + tq of plane `plane`.
__device__ __forceinline__ void put(uint32_t* dst, int plane, uint32_t q0,
                                    uint32_t q1) {
  dst[plane * kPlaneWords] = q0;
  dst[plane * kPlaneWords + 32] = q1;
}

// The block decodes its channel's band into `bp` ([ks][planes] planes):
// H[m][i] = tap i + P - m.  A warp takes one k step's 8-column group;
// lane (nl, tq) column 8 cg + nl, k quads tq and 4 + tq, so a warp's
// stores into a plane cover 32 distinct banks.  tw: each tap's row
// triplets (a nibble a row), bqs: its bq.
__device__ __forceinline__ void decode_band(const uint32_t* __restrict__ tw,
                                            const int* __restrict__ bqs,
                                            uint32_t* __restrict__ bp,
                                            const Op& op, const Band& band,
                                            int taps) {
  const int lane = threadIdx.x & 31, nl = lane & 7, tq = lane >> 3;
  const int per = op.kind ? 2 : 4;
#pragma unroll 1
  for (int u = threadIdx.x >> 5; u < band.ks * 8; u += blockDim.x >> 5) {
    const int s = u >> 3, cg = u & 7, i = 8 * cg + nl;
    uint32_t* dst = bp + s * band.planes * kPlaneWords + 64 * cg + 4 * nl + tq;
    uint32_t t[2][4];
    int bq[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = i + band.P - (32 * s + 16 * q + 4 * tq + j);
        const bool in = idx >= 0 && idx < taps;
        t[q][j] = in ? tw[idx] : 0u;
        bq[q][j] = in ? bqs[idx] : 0;
      }
    put(dst, 0, pack4(bq[0][0], bq[0][1], bq[0][2], bq[0][3]),
        pack4(bq[1][0], bq[1][1], bq[1][2], bq[1][3]));
    if (op.bqb == 2)
      put(dst, 1,
          pack4(bq[0][0] >> 8, bq[0][1] >> 8, bq[0][2] >> 8, bq[0][3] >> 8),
          pack4(bq[1][0] >> 8, bq[1][1] >> 8, bq[1][2] >> 8, bq[1][3] >> 8));
    if (op.R == 0) continue;
    uint32_t sel[2][8];
    bbm_mma::selectors(t[0], sel[0]);
    bbm_mma::selectors(t[1], sel[1]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r >= op.R) break;
      const int pl = op.bqb + r * per;
      const uint32_t s0 = sel[0][r], s1 = sel[1][r];
      put(dst, pl, prmt(bbm_mma::kDLo, bbm_mma::kDHi, s0),
          prmt(bbm_mma::kDLo, bbm_mma::kDHi, s1));
      put(dst, pl + 1, prmt(bbm_mma::kB2Lo, bbm_mma::kB2Hi, s0),
          prmt(bbm_mma::kB2Lo, bbm_mma::kB2Hi, s1));
      if (!op.kind) {
        put(dst, pl + 2, prmt(bbm_mma::kI1Lo, bbm_mma::kI1Hi, s0),
            prmt(bbm_mma::kI1Lo, bbm_mma::kI1Hi, s1));
        put(dst, pl + 3, prmt(bbm_mma::kI2Lo, bbm_mma::kI2Hi, s0),
            prmt(bbm_mma::kI2Lo, bbm_mma::kI2Hi, s1));
      }
    }
  }
}

// ----------------------------------------------------------- the x side
// Samples nb .. nb + 4 groups - 1 of the channel (zeros outside [0, N)),
// sign-extended to 16-bit lanes, group G at words 40 (G / 16) + 2 (G % 16).
__device__ __forceinline__ void stage_x(const int* __restrict__ xc,
                                        uint32_t* __restrict__ xw, int nb,
                                        int N, int groups, int wl,
                                        bool vec) {
  constexpr int kBatch = 4;       // groups a thread loads before it stores
  const int sh = 32 - wl;
  for (int G0 = threadIdx.x; G0 < groups; G0 += kBatch * blockDim.x) {
    int v[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int G = G0 + b * blockDim.x;
      const int n = nb + 4 * G;
      if (G >= groups) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[b][j] = 0;
      } else if (vec && n >= 0 && n + 3 < N) {
        const int4 q = *reinterpret_cast<const int4*>(xc + n);
        v[b][0] = q.x, v[b][1] = q.y, v[b][2] = q.z, v[b][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[b][j] = n + j >= 0 && n + j < N ? xc[n + j] : 0;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int G = G0 + b * blockDim.x;
      if (G >= groups) break;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[b][j] = static_cast<int>(static_cast<uint32_t>(v[b][j]) << sh) >> sh;
      uint2 w;
      w.x = (static_cast<uint32_t>(v[b][0]) & 0xFFFFu) |
            (static_cast<uint32_t>(v[b][2]) << 16);
      w.y = (static_cast<uint32_t>(v[b][1]) & 0xFFFFu) |
            (static_cast<uint32_t>(v[b][3]) << 16);
      *reinterpret_cast<uint2*>(xw + 40 * (G >> 4) + 2 * (G & 15)) = w;
    }
  }
}

// trailing zeros of a 16-bit lane, 32 for zero
__device__ __forceinline__ uint32_t tz16(uint32_t v) {
  return static_cast<uint32_t>(__clz(__brev(v)));
}

// One k step of the warpgroup's 64 rows into lo and hi: the x bq products
// if `lead`, and truncated rows r0, r0 + rstep, ...; desc: the descriptor
// of the k step's first plane (plane p is 2 KB on).  Word w of
// a thread's fragment holds row 16 warp + g + 8 (w & 1) and k 4 t + 16 (w
// >> 1) .. + 3 (g = lane / 4, t = lane % 4); p02 and p13 are its samples
// 0, 2 and 1, 3 as 16-bit lanes, q02 and q13 their high bytes
// sign-extended, tz their trailing-zero counts as bytes.
template <int KIND, int H>
__device__ __forceinline__ void k_step(const uint32_t* __restrict__ xw,
                                       uint64_t desc, const Op& op,
                                       int row0, int s, int r0, int rstep,
                                       bool lead, int (&lo)[32],
                                       int (&hi)[32]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  uint32_t p02[4], p13[4], q02[4], q13[4], tz[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int row = row0 + 16 * warp + g + 8 * (w & 1);
    const int G = 16 * row + 8 * s + t + 4 * (w >> 1);
    const uint2 v =
        *reinterpret_cast<const uint2*>(xw + 40 * (G >> 4) + 2 * (G & 15));
    p02[w] = v.x;
    p13[w] = v.y;
    q02[w] = prmt(v.x, v.x, 0xB391);
    q13[w] = prmt(v.y, v.y, 0xB391);
    if (KIND == 0)
      tz[w] = pack4(tz16(v.x & 0xFFFFu), tz16(v.y & 0xFFFFu), tz16(v.x >> 16),
                    tz16(v.y >> 16));
  }
  uint32_t a[4], ai[4] = {0u, 0u, 0u, 0u};
  auto frag = [&](auto f) {
#pragma unroll
    for (int w = 0; w < 4; ++w) a[w] = f(w);
  };
  // plane p's descriptor (2,048 bytes a plane, in 16-byte units)
  auto at = [&](int p) {
    return desc + static_cast<uint64_t>(p * (kPlaneWords * 4 >> 4));
  };
  constexpr int per = KIND ? 2 : 4;
  // x bq: x's bytes against bq's (two significances at most)
  frag([&](int w) { return field(p02[w], p13[w], 0); });
  if (!lead) {
  } else if (op.xb == 1 && op.bqb == 1) {
    mma<H, true, true>(lo, ai, a, at(0));
  } else if (op.xb == 1) {
    mma<H, true, false>(lo, ai, a, at(0));
    mma<H, true, true>(hi, ai, a, at(1));
  } else {
    mma<H, false, true>(lo, ai, a, at(0));
    frag([&](int w) { return field(q02[w], q13[w], 0); });
    mma<H, true, true>(hi, ai, a, at(0));
  }
#pragma unroll 1
  for (int r = r0; r < op.R; r += rstep) {
    // m_r may pass 16 (vbl > 16): x >> m is then x's sign, as x >> 16 is
    const int m = op.vbl - 2 * r, mf = m < 16 ? m : 16;
    const int pl = op.bqb + r * per;
    // (x >> m) d_r
    if (bbm_mma::signed_bytes(op.wl - 1 - m) == 1) {
      if (mf <= 8)
        frag([&](int w) { return field(p02[w], p13[w], mf); });
      else
        frag([&](int w) { return field(q02[w], q13[w], mf - 8); });
      mma<H, true, true>(lo, ai, a, at(pl));
    } else {
      frag([&](int w) { return field(p02[w], p13[w], m); });
      mma<H, false, true>(lo, ai, a, at(pl));
      frag([&](int w) { return field(q02[w], q13[w], m); });
      mma<H, true, true>(hi, ai, a, at(pl));
    }
    // b_r B2_r: the low bit of each byte of x's bits [b, b + 8)
    const int b = m - 1 < 15 ? m - 1 : 15;
    if (b <= 8)
      frag([&](int w) { return field(p02[w], p13[w], b) & 0x01010101u; });
    else
      frag([&](int w) {
        return field(q02[w], q13[w], b - 8) & 0x01010101u;
      });
    mma<H, false, true>(lo, ai, a, at(pl + 1));
    if (KIND == 0) {
      // nz1_r (-I1_r), nz2_r (-I2_r)
      frag([&](int w) { return nonzero_low(tz[w], m); });
      mma<H, false, true>(lo, ai, a, at(pl + 2));
      frag([&](int w) { return nonzero_low(tz[w], m - 1); });
      mma<H, false, true>(lo, ai, a, at(pl + 3));
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  bbm_mma::hold(ai);
  bbm_mma::hold(lo);
  bbm_mma::hold(hi);
}

// ------------------------------------------------------------ the kernel
// grid (time ranges, C), 128 band.nwg threads, smem_bytes(band).  A block
// takes tiles [blockIdx.x per_block, + per_block) of its channel c, each
// 4,096 band.nwg outputs.  x, out (C, N); planes (wl/2, C, taps); int32.
__global__ void __launch_bounds__(kMaxWG * 128, 1)
fir_mma_kernel(const int* __restrict__ x, const int* __restrict__ hmag,
               const int* __restrict__ hneg, int* __restrict__ out, int C,
               int N, int taps, Op op, Band band, int up, int per_block,
               bool vec) {
  extern __shared__ uint4 fir_mma_smem[];
  uint32_t* bp = reinterpret_cast<uint32_t*>(fir_mma_smem);
  uint32_t* xw = bp + band.ks * band.planes * kPlaneWords;
  const int c = blockIdx.y;
  const int tile = 4096 * tile_groups(band);
  const int tiles = (N + tile - 1) / tile;
  const int t0 = blockIdx.x * per_block;
  const int t1 = t0 + per_block < tiles ? t0 + per_block : tiles;
  if (t0 >= t1) return;

  // the channel's taps (row triplets, bq), staged where x goes later
  uint32_t* tw = xw;
  int* bqs = reinterpret_cast<int*>(xw + taps);
  const size_t stride = static_cast<size_t>(C) * taps;
  for (int k = threadIdx.x; k < taps; k += blockDim.x) {
    uint32_t w = 0;
    int bq = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r >= op.wl / 2) break;
      const size_t o = r * stride + static_cast<size_t>(c) * taps + k;
      const uint32_t idx = (static_cast<uint32_t>(hmag[o]) & 3u) |
                           ((static_cast<uint32_t>(hneg[o]) & 1u) << 2);
      // (mag, neg) -> the triplet of that digit and sign
      // (bbm_mma.cuh: bbm_pack_triplets_kernel)
      const uint32_t tr = (0x44573310u >> (4 * idx)) & 0xFu;
      w |= tr << (4 * r);
      if (r >= op.R) bq += bbm_mma::triplet_digit(tr) * (1 << (2 * r - op.vbl));
    }
    tw[k] = w;
    bqs[k] = bq;
  }
  __syncthreads();
  // kind 1: -sum_k sum_{r<R} neg_r, the same for every output
  uint32_t negc = 0;
  if (op.kind && op.R) {
    const uint32_t negs =
        0x44444444u & (op.R >= 8 ? 0xFFFFFFFFu : (1u << (4 * op.R)) - 1u);
    for (int k = 0; k < taps; ++k) negc -= __popc(tw[k] & negs);
  }
  decode_band(tw, bqs, bp, op, band, taps);
  // the planes' generic stores, seen by wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  int* oc = out + static_cast<size_t>(c) * N;
  const bool pairs = N % 2 == 0;      // 8-byte stores stay aligned
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
  const int groups = span_groups(tile_groups(band), band.ks);
  uint32_t* part = xw + x_words(groups);      // split: the tile's sums
  // split: every warpgroup on the tile's 64 rows, truncated rows wg,
  // wg + nwg, ..., the x bq products on warpgroup 0; else one 64-row
  // group each, all products
  const int row0 = band.split ? 0 : 64 * wg;
  const int r0 = band.split ? wg : 0, rstep = band.split ? band.nwg : 1;
  const bool lead = !band.split || wg == 0;
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * tile;
    stage_x(x + static_cast<size_t>(c) * N, xw, n0 - band.P, N, groups,
            op.wl, vec);
    if (band.split)
      for (int i = threadIdx.x; i < 4096; i += blockDim.x) part[i] = 0;
    __syncthreads();
    const int first = n0 + 64 * 64 * (row0 / 64);   // its first output
    if (first < N) {
      int lo[32], hi[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) lo[i] = hi[i] = 0;
#pragma unroll 1
      for (int s = 0; s < band.ks; ++s) {
        const uint64_t desc = plane_desc(bp + s * band.planes * kPlaneWords);
        const int half = (band.halves >> (2 * s)) & 3;
        if (op.kind) {
          if (half == 0) k_step<1, 0>(xw, desc, op, row0, s, r0, rstep, lead, lo, hi);
          else if (half == 1) k_step<1, 1>(xw, desc, op, row0, s, r0, rstep, lead, lo, hi);
          else k_step<1, 2>(xw, desc, op, row0, s, r0, rstep, lead, lo, hi);
        } else {
          if (half == 0) k_step<0, 0>(xw, desc, op, row0, s, r0, rstep, lead, lo, hi);
          else if (half == 1) k_step<0, 1>(xw, desc, op, row0, s, r0, rstep, lead, lo, hi);
          else k_step<0, 2>(xw, desc, op, row0, s, r0, rstep, lead, lo, hi);
        }
      }
      // n8 tile j's four: rows g and g + 8, columns 2 tq and 2 tq + 1
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h;
          const int i = 64 * (16 * warp + g + 8 * h) + 8 * j + 2 * tq;
          const uint32_t v0 = static_cast<uint32_t>(lo[4 * j + e]) +
                              (static_cast<uint32_t>(hi[4 * j + e]) << 8);
          const uint32_t v1 = static_cast<uint32_t>(lo[4 * j + e + 1]) +
                              (static_cast<uint32_t>(hi[4 * j + e + 1]) << 8);
          if (band.split) {
            atomicAdd(part + i, v0);         // exact modulo 2^32 in any order
            atomicAdd(part + i + 1, v1);
          } else if (pairs && first + i + 1 < N) {
            *reinterpret_cast<int2*>(oc + first + i) =
                make_int2(static_cast<int>((v0 + negc) << up),
                          static_cast<int>((v1 + negc) << up));
          } else {
            if (first + i < N)
              oc[first + i] = static_cast<int>((v0 + negc) << up);
            if (first + i + 1 < N)
              oc[first + i + 1] = static_cast<int>((v1 + negc) << up);
          }
        }
    }
    if (band.split) {
      __syncthreads();
      for (int i = threadIdx.x; i < 4096 && n0 + i < N; i += blockDim.x)
        oc[n0 + i] = static_cast<int>((part[i] + negc) << up);
    }
    __syncthreads();        // every warpgroup is done with the staged x
  }
}

// Launch on (x, planes) at (wl, vbl, kind) and shift <= vbl: the most
// warpgroups a block (4, 2 or 1) whose band and tile fit in shared
// memory; each channel's tiles split into about SMs / C ranges.  Returns
// the cudaError_t (cudaErrorInvalidValue where no tile fits).
inline cudaError_t launch(const int* x, const int* hmag, const int* hneg,
                          int* out, int C, int N, int taps, int wl, int vbl,
                          int kind, int shift, cudaStream_t st) {
  const Op op = bbm_mma::make_op(wl, vbl, kind);
  Band band = make_band(taps, op);
  while (band.nwg > 1 && smem_bytes(band) > kSmemLimit) band.nwg /= 2;
  if (band.ks > 16 || smem_bytes(band) > kSmemLimit || shift > vbl)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // few tiles (under half the SMs busy): one 64-row group a tile, its
  // truncated rows shared by the warpgroups, which shortens each
  // warpgroup's chain of products
  if (band.nwg > 1 &&
      2 * static_cast<long long>(C) * ((N + 4096 * band.nwg - 1) /
                                       (4096 * band.nwg)) <= sms) {
    Band b = band;
    b.split = 1;
    if (smem_bytes(b) <= kSmemLimit) band = b;
  }
  const size_t smem = smem_bytes(band);
  e = cudaFuncSetAttribute(fir_mma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tile = 4096 * tile_groups(band);
  const int tiles = (N + tile - 1) / tile;
  int ranges = sms / C;
  ranges = ranges < 1 ? 1 : (ranges > tiles ? tiles : ranges);
  const int per_block = (tiles + ranges - 1) / ranges;
  ranges = (tiles + per_block - 1) / per_block;
  const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  fir_mma_kernel<<<dim3(ranges, C), 128 * band.nwg, smem, st>>>(
      x, hmag, hneg, out, C, N, taps, op, band, vbl - shift, per_block, vec);
  return cudaGetLastError();
}

}  // namespace fir_mma
