// The byte arithmetic of the contracted Broken-Booth dot form on the int8
// tensor cores, shared by its two kernels: bbm_mma.cuh (the matmul) and
// fir_mma.cuh (the FIR filterbank's banded contraction).  The operating
// point and its operand widths, the prmt helpers, the triplet -> byte
// tables of the weight-side planes, the x-side byte fields formed in
// registers, and the descriptor of a weight plane in shared memory.
// bbm_mma.cuh's header sets out the arithmetic.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace bbm_mma {

// Bytes of a two's-complement value of `bits` + 1 bits: s8, or u8 + s8.
__host__ __device__ constexpr int signed_bytes(int bits) {
  return bits <= 7 ? 1 : 2;
}

// The operating point, fixed per launch.
struct Op {
  int wl, vbl, kind, R;
  int xb, bqb;                    // bytes of x and of bq
  int planes;                     // weight planes in shared memory
  uint32_t wlmask;
};

inline Op make_op(int wl, int vbl, int kind) {
  Op op;
  op.wl = wl;
  op.vbl = vbl;
  op.kind = kind;
  op.R = (vbl + 1) / 2 < wl / 2 ? (vbl + 1) / 2 : wl / 2;
  op.xb = signed_bytes(wl - 1);
  long long bq = 0;
  for (int r = op.R; r < wl / 2; ++r) bq += 2ll << (2 * r - vbl);
  op.bqb = bq <= 127 ? 1 : 2;
  op.planes = op.bqb + op.R * (kind ? 2 : 4) + (kind && op.R ? 1 : 0);
  op.wlmask = wl >= 32 ? 0xFFFFFFFFu : (1u << wl) - 1u;
  return op;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// byte 0 of each of a, b, c, d
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return prmt(prmt(a, b, 0x0040), prmt(c, d, 0x0040), 0x5410);
}

// Pin registers an asynchronous wgmma reads or writes: the compiler may
// not move their other uses across this point.
template <int N>
__device__ __forceinline__ void hold(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ---------------------------------------------------- the weight planes
// the four low nibbles of e's bytes as a 16-bit prmt selector
__device__ __forceinline__ uint32_t compact(uint32_t e) {
  e = (e | (e >> 4)) & 0x00FF00FFu;
  return (e | (e >> 8)) & 0xFFFFu;
}

// sel[r]: nibble i = row r's triplet of code i (four codes of one column)
__device__ __forceinline__ void selectors(const uint32_t (&t)[4],
                                          uint32_t (&sel)[8]) {
  const uint32_t a_lo = prmt(t[0], t[1], 0x5140), a_hi = prmt(t[0], t[1], 0x7362);
  const uint32_t c_lo = prmt(t[2], t[3], 0x5140), c_hi = prmt(t[2], t[3], 0x7362);
  const uint32_t h[4] = {prmt(a_lo, c_lo, 0x5410), prmt(a_lo, c_lo, 0x7632),
                         prmt(a_hi, c_hi, 0x5410), prmt(a_hi, c_hi, 0x7632)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sel[2 * j] = compact(h[j] & 0x0F0F0F0Fu);
    sel[2 * j + 1] = compact((h[j] >> 4) & 0x0F0F0F0Fu);
  }
}

// triplet -> byte tables (low word: triplets 0-3, high word: 4-7)
constexpr uint32_t kDLo = 0x02010100u, kDHi = 0x00FFFFFEu;    // d
constexpr uint32_t kB2Lo = 0x01000000u, kB2Hi = 0x000000FFu;  // [d=2]-[d=-2]
constexpr uint32_t kI1Lo = 0x00000000u, kI1Hi = 0x00FFFF00u;  // -[d = -1]
constexpr uint32_t kI2Lo = 0x00000000u, kI2Hi = 0x000000FFu;  // -[d = -2]

__device__ __forceinline__ int triplet_digit(uint32_t t) {
  return static_cast<int>((t & 1u) + ((t >> 1) & 1u)) -
         2 * static_cast<int>(t >> 2);
}

// A weight plane (32 k x n bytes) in wgmma's K-major layout without
// swizzle: core matrices of 8 columns x 16 k bytes (128 contiguous
// bytes, a column's 16 bytes each), the two k halves 128 bytes apart
// (the leading byte offset), the column groups 256 bytes apart (the
// stride byte offset).  Byte (n, k) sits at 256 (n / 8) + 128 (k / 16)
// + 16 (n % 8) + k % 16.
constexpr uint32_t kLeadBytes = 128, kStrideBytes = 256;

// The shared-memory matrix descriptor of the plane at `plane`.
__device__ __forceinline__ uint64_t plane_desc(const uint32_t* plane) {
  const uint32_t a =
      static_cast<uint32_t>(__cvta_generic_to_shared(plane));
  return static_cast<uint64_t>((a >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>(kLeadBytes >> 4) << 16) |
         (static_cast<uint64_t>(kStrideBytes >> 4) << 32);
}

// bits [m, m + 8) of each of the four codes from p (m <= 8) or from q
// (bits [8 + m, 16 + m), sign-extended)
__device__ __forceinline__ uint32_t field(uint32_t a02, uint32_t a13,
                                          int m) {
  return prmt(a02 >> m, a13 >> m, 0x6240);
}

// bit b of each code as a 0/1 byte
__device__ __forceinline__ uint32_t bit_bytes(uint32_t p02, uint32_t p13,
                                              int b) {
  return ((p02 >> b) & 0x00010001u) | (((p13 >> b) & 0x00010001u) << 8);
}

// [tz < mm] per byte: the code's low mm bits are not all zero
__device__ __forceinline__ uint32_t nonzero_low(uint32_t tz, int mm) {
  const uint32_t ge = ((tz + 0x01010101u * static_cast<uint32_t>(0x80 - mm))
                       >> 7) & 0x01010101u;
  return ge ^ 0x01010101u;
}

}  // namespace bbm_mma
