// The rows form of one Broken-Booth product over precoded digits, as device
// functions.
//
// Shared by fir_bank.cu (fir_bank_rows) and bbm_matmul.cu (bbm_matmul_rows),
// so the row semantics of repro/kernels/booth_rows.py:
// bbm_rows_product_precoded exist once on the card.  A multiplier's digits
// arrive as (mag, neg) planes from booth_precode (faulted planes too: any
// mag in {0, 1, 2}, neg in {0, 1}) and are packed one 32-bit word per
// multiplier, row r in bits [3r, 3r + 3) as mag | neg << 2.
//
// Integer rules: right shifts of signed values stay arithmetic (the floor
// is the paper's truncation); every left shift of a possibly negative value
// is done on uint32_t and cast back (a signed left shift of a negative value
// is undefined before C++20).
#pragma once
#include <stddef.h>
#include <stdint.h>

namespace bbm {

__device__ __forceinline__ int shl(int v, int s) {
  return static_cast<int>(static_cast<uint32_t>(v) << s);
}

// R digits of one multiplier packed into a word.  Row r of the planes is
// at mag[off + r * stride], neg[off + r * stride].
template <int R>
__device__ __forceinline__ uint32_t pack_digits(const int32_t* __restrict__ mag,
                                                const int32_t* __restrict__ neg,
                                                size_t off, size_t stride) {
  uint32_t w = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t o = off + static_cast<size_t>(r) * stride;
    w |= static_cast<uint32_t>((mag[o] & 3) | ((neg[o] & 1) << 2)) << (3 * r);
  }
  return w;
}

// Multiply-free form: each row selects among {0, a, 2a} and negates, then
// clears its mr[r] low bits (floor toward -inf) and lands at weight 4^r.
template <int R, int KIND>
__device__ __forceinline__ int bbm_rows(int a, uint32_t w, const int* mr) {
  const int a2 = shl(a, 1);
  uint32_t prod = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int code = (w >> (3 * r)) & 7;
    const int mag = code & 3;
    const int neg = code >> 2;
    const int pos = mag == 2 ? a2 : (mag == 1 ? a : 0);
    int rows;
    if (KIND == 0) {
      rows = neg ? -pos : pos;
    } else {
      rows = neg ? -pos - 1 : pos;           // one's complement; 111 -> -1
    }
    int contrib = shl(rows >> mr[r], mr[r]);  // floor toward -inf
    if (KIND == 1 && mr[r] == 0) contrib += neg;   // S dot survives at m == 0
    prod += static_cast<uint32_t>(contrib) << (2 * r);
  }
  return static_cast<int>(prod);
}

}  // namespace bbm
