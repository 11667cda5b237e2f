// The folded dot form of one Broken-Booth product, as device functions.
//
// Shared by bbm_dot.cu (the contracted matmul) and flash_attention.cuh (the
// score and value products of flash attention on the amm datapath), so the
// integer arithmetic exists once.  For a signed multiplicand a and a wl-bit
// multiplier code b with radix-4 digits d_r (sign bit neg_r = b_{2r+1}),
//
//   bbm(a, b) = 2^vbl * M,  M = a*bq + sum_{r<R} ((d_r*a - kind*neg_r) >> m_r)
//
// with m_r = vbl - 2r, R = num_corr_rows(wl, vbl) = min(wl/2, ceil(vbl/2))
// and bq = sum_{r>=R} d_r << (2r - vbl) (repro/kernels/booth_rows.py:
// booth_high_value, scaled_trunc_rows).  The right shift of a signed value
// is arithmetic (the floor that is the paper's truncation); left shifts of
// possibly negative values go through uint32_t.
//
// Chunked sums: an int32 partial over at most `chunk` = amm_chunk_len(wl,
// vbl) products stays exact; the partials are converted to f32 and added
// in chunk order with round-to-nearest adds (ChunkSum), then multiplied by
// 2^vbl, as repro/kernels/bbm_matmul.py: dot_scaled_chunked does.
//
// The digits come from int32 codes (decode) or from (mag, neg) digit planes
// (from_planes), which may carry injected faults: any mag in {0, 1, 2} and
// neg in {0, 1}.  The accumulator faults of repro/core/faults.py draw
// jax.random.bernoulli's bits per element (bernoulli_hit).
#pragma once
#include <stddef.h>
#include <stdint.h>

namespace bbm {

// One multiplier's digits: bq, and per truncated row r < R the field
// (d_r + 2) | neg_r << 3 in bits [4r, 4r + 4) of `rows`.
struct Digits {
  int bq;
  uint32_t rows;
};

__device__ __forceinline__ Digits decode(int code, int wl, int vbl, int R) {
  const uint32_t u = static_cast<uint32_t>(code) & ((1u << wl) - 1u);
  Digits g{0, 0u};
  uint32_t lo = 0u;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (2 * r < wl) {
      const uint32_t hi = (u >> (2 * r + 1)) & 1u;
      const uint32_t mid = (u >> (2 * r)) & 1u;
      const int d = static_cast<int>(mid + lo) - 2 * static_cast<int>(hi);
      lo = hi;
      if (r < R)
        g.rows |= (static_cast<uint32_t>(d + 2) | (hi << 3)) << (4 * r);
      else
        g.bq += static_cast<int>(static_cast<uint32_t>(d) << (2 * r - vbl));
    }
  }
  return g;
}

// The same from digit planes (wl/2, K, N): row r of the multiplier at
// mag[off + r * stride], neg[off + r * stride]; the signed digit is -mag
// where neg is set.
__device__ __forceinline__ Digits from_planes(const int* __restrict__ mag,
                                              const int* __restrict__ neg,
                                              size_t off, size_t stride,
                                              int wl, int vbl, int R) {
  Digits g{0, 0u};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (2 * r < wl) {
      const size_t o = off + static_cast<size_t>(r) * stride;
      const int m = mag[o] & 3;
      const uint32_t n = static_cast<uint32_t>(neg[o] & 1);
      const int d = n ? -m : m;
      if (r < R)
        g.rows |= (static_cast<uint32_t>(d + 2) | (n << 3)) << (4 * r);
      else
        g.bq += static_cast<int>(static_cast<uint32_t>(d) << (2 * r - vbl));
    }
  }
  return g;
}

// Digits unpacked into registers, reused across the rows of a thread.
struct Unpacked {
  int bq;
  int d[8];
  int n[8];
};

__device__ __forceinline__ Unpacked unpack(const Digits& g) {
  Unpacked u;
  u.bq = g.bq;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    u.d[r] = static_cast<int>((g.rows >> (4 * r)) & 7u) - 2;
    u.n[r] = static_cast<int>((g.rows >> (4 * r + 3)) & 1u);
  }
  return u;
}

// M(a, b) for a signed multiplicand `a` against unpacked digits.
template <int KIND>
__device__ __forceinline__ int scaled_product(int a, const Unpacked& u,
                                              int vbl, int R) {
  int acc = a * u.bq;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r < R) {
      int t = u.d[r] * a;
      if (KIND) t -= u.n[r];
      acc += t >> (vbl - 2 * r);
    }
  }
  return acc;
}

// Signed value of the low wl bits of a code (repro's split_signed).
__device__ __forceinline__ int signed_code(int code, int wl) {
  const int u = code & ((1 << wl) - 1);
  return u >= (1 << (wl - 1)) ? u - (1 << wl) : u;
}

// f32 sum of int32 chunk partials in chunk order.
__device__ __forceinline__ void flush(float& acc, int& part) {
  acc = __fadd_rn(acc, __int2float_rn(part));
  part = 0;
}

// jax.random.bits (uint32) of flat element `idx` under the partitionable
// threefry scheme: the Threefry-2x32 block (20 rounds, JAX's key schedule)
// of the count (0, idx), its two output words xor-ed.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2,
                                                  uint32_t idx) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  uint32_t x0 = k1, x1 = idx + k2;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[g % 2][i]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return x0 ^ x1;
}

// jax.random.bernoulli(key, p) at flat element `idx`: the float32 uniform
// from the top 23 bits, (bits >> 9 | 1.0f's bits) - 1, below p.
__device__ __forceinline__ bool bernoulli_hit(uint32_t k1, uint32_t k2,
                                              uint32_t idx, float p) {
  const uint32_t bits = threefry_bits(k1, k2, idx);
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f) < p;
}

}  // namespace bbm
