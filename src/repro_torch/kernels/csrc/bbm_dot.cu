// The contracted Broken-Booth dot form for Hopper (sm_90a), plain C interface.
//
// Replaces the XLA lowering repro/kernels/bbm_matmul.py: _dot_scaled behind
// bbm_matmul_scaled (the bitexact LM's every MLP product, ROADMAP B2):
//
//   out[m, n] = 2^vbl * sum over K-chunks c, in order, of f32( sum_{k in c}
//               M(x[m, k], w[k, n]) )
//
// with M the folded per-product form of bbm_dot.cuh, chunks of amm_chunk_len
// (wl, vbl) products (each int32 partial exact), f32 adds in chunk order.
// The reference sums each truncated row over K as a digit dot minus one-hot
// residue dots; that K-sum equals the sum of the per-product floors, so one
// pass over the products with integer multiply, shift and add gives the same
// integers without any one-hot contraction.
//
// Design.  One block of 256 threads owns a 64 x 64 output tile; each thread
// 4 x 4 outputs (rows ty + 16i, columns tx + 16j).  K streams through
// shared memory 32 at a time: x as sign-extended int32, w decoded once per
// block into its digits (bq and packed rows, 8 bytes), unpacked into
// registers per use and reused across the thread's 4 rows.  Each thread
// keeps an int32 partial and an f32 sum per output; a counter shared by the
// block flushes the partials at every chunk boundary.
//
// Bound.  Integer issue, not bytes: per product one multiply-add for x*bq
// and per truncated row a multiply, a shift and an add (kind 1: and a
// subtract), 22 instructions at wl 16 / vbl 13 (R = 7), against 12 bytes
// per (m, k) + (k, n) element pair read once.  No tensor cores: the
// products of 16-bit codes need 30 bits, which no tensor-core type holds
// exactly beside the truncation (an int8 IMMA route over split codes is
// later work).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bbm_dot.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64;
constexpr int kTN = 64;
constexpr int kTK = 32;

template <int KIND>
__global__ void __launch_bounds__(kThreads)
bbm_dot_kernel(const int* __restrict__ x, const int* __restrict__ w,
               float* __restrict__ out, int M, int K, int N, int wl, int vbl,
               int R, int chunk, float scale) {
  __shared__ int xs[kTK][kTM + 1];
  __shared__ bbm::Digits ws[kTK][kTN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;

  int part[4][4];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      part[i][j] = 0;
      acc[i][j] = 0.0f;
    }
  int left = chunk;

  for (int kt = 0; kt < K; kt += kTK) {
    for (int e = threadIdx.x; e < kTM * kTK; e += kThreads) {
      const int mm = e / kTK, kk = e % kTK;
      const int gm = m0 + mm, gk = kt + kk;
      xs[kk][mm] = (gm < M && gk < K)
                       ? bbm::signed_code(x[(size_t)gm * K + gk], wl)
                       : 0;
    }
    for (int e = threadIdx.x; e < kTK * kTN; e += kThreads) {
      const int kk = e / kTN, nn = e % kTN;
      const int gk = kt + kk, gn = n0 + nn;
      const int code = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0;
      ws[kk][nn] = bbm::decode(code, wl, vbl, R);
    }
    __syncthreads();
    const int kn = min(kTK, K - kt);
    for (int kk = 0; kk < kn; ++kk) {
      int a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bbm::Unpacked u = bbm::unpack(ws[kk][tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          part[i][j] += bbm::scaled_product<KIND>(a[i], u, vbl, R);
      }
      if (--left == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) bbm::flush(acc[i][j], part[i][j]);
        left = chunk;
      }
    }
    __syncthreads();
  }
  if (left != chunk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) bbm::flush(acc[i][j], part[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = __fmul_rn(acc[i][j], scale);
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  x: (M, K), w: (K, N) int32 codes
// (the low wl bits are read, signed); out: (M, N) f32.  M, K, N >= 1,
// 2 <= wl <= 16 even, 0 <= vbl < wl, R = num_corr_rows(wl, vbl),
// chunk = amm_chunk_len(wl, vbl) >= 1.
int bbm_dot_scaled_launch(const int* x, const int* w, float* out, int M,
                          int K, int N, int wl, int vbl, int kind, int R,
                          int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  const float scale = static_cast<float>(1u << vbl);
  if (kind)
    bbm_dot_kernel<1><<<grid, kThreads, 0, st>>>(x, w, out, M, K, N, wl,
                                                 vbl, R, chunk, scale);
  else
    bbm_dot_kernel<0><<<grid, kThreads, 0, st>>>(x, w, out, M, K, N, wl,
                                                 vbl, R, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* bbm_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
