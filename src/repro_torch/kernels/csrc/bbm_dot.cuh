// The folded dot form of one Broken-Booth product, as device functions.
//
// Shared by bbm_dot.cu (the contracted matmul) and flash_attention.cu (the
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
#pragma once
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

}  // namespace bbm
