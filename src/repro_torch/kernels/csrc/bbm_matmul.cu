// The tiled bit-exact Broken-Booth matmul for Hopper (sm_90a), plain C
// interface:
//
//   out[m, n] = sum_k (bbm(x[m, k], w[k, n]) >> shift), int32,
//
// with w given as its radix-4 digit planes (wl/2, K, N) from booth_precode
// (faulted planes included: any mag in {0, 1, 2}, neg in {0, 1}).
//
//   bbm_matmul_rows  replaces the Pallas kernel repro/kernels/bbm_matmul.py
//                    bbm_matmul_kernel (form="rows"): every product walks
//                    its wl/2 Booth rows (bbm_rows.cuh, the row semantics
//                    fir_bank_rows uses), each row truncated as
//                    (row >> m) << m, then >> shift.
//   bbm_matmul_dot   replaces the XLA twin repro/kernels/bbm_matmul.py
//                    _matmul_dotform (form="dot"): per product
//                    M = x*bq + sum_{r<R} ((d_r*x - kind*neg_r) >> m_r)
//                    (bbm_dot.cuh), with the reference's shift rules: a
//                    per-product >> u when u = shift - vbl > 0, a final
//                    << (vbl - shift) when vbl > shift.
//
// Design.  The TPU kernel's grid walks K as a sequential axis and adds
// into the output tile in place; here one block of 256 threads owns a
// 64 x 64 output tile and walks K itself, 32 at a time through shared
// memory (bbm_tile.cuh, the tile bbm_dot.cu uses): x sign-extended, the
// weight digits packed one 32-bit word per (k, n) (rows) or decoded to bq
// and packed truncated rows (dot).  Each thread keeps 4 x 4 sums of shifted
// products (rows ty + 16i, columns tx + 16j) in the ShiftedI32 epilogue,
// so a staged digit word is reused across 4 rows and a staged x across 4
// columns.  Sums run in uint32 (wrapping, as torch's int32 sums); inside
// the envelope K * 2^(2wl-1-shift) < 2^31, which the Python wrappers
// check, nothing wraps.
//
// bbm_matmul_dot has a second route (bbm_matmul_dot_mma_launch) where
// shift <= vbl and the Python rule (bbm_matmul.py: bbm_dot_route) allows
// it: the planes packed into triplet words, then the int8 tensor-core
// tile of bbm_mma.cuh, whose one int32 sum over K is shifted << (vbl -
// shift) (its int32 epilogue); its bound is the int8 tensor cores.
//
// Bound of the CUDA-core tile.  Integer issue, not bytes: a call reads
// 4 (M K + 2 (wl/2) K N) bytes and writes 4 M N, but does M K N products
// of wl/2 rows (rows: select, negate, floor, shifted add per row) or of
// 1 + R multiply-adds (dot).  The rows form and the dot form at shift >
// vbl floor each product before the K sum, which no tensor-core product
// forms.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bbm_mma.cuh"
#include "bbm_rows.cuh"
#include "bbm_tile.cuh"

namespace {

using bbm::kTileK;
using bbm::kTileM;
using bbm::kTileN;
using bbm::kTileThreads;

template <int R, int KIND>
__global__ void __launch_bounds__(kTileThreads)
bbm_matmul_rows_kernel(const int* __restrict__ x,
                       const int* __restrict__ wmag,
                       const int* __restrict__ wneg,
                       int32_t* __restrict__ out, int M, int K, int N,
                       int wl, int vbl, int shift) {
  __shared__ int xs[kTileK][kTileM + 1];
  __shared__ uint32_t wd[kTileK][kTileN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const size_t plane = static_cast<size_t>(K) * N;
  int mr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mr[r] = max(0, vbl - 2 * r);
  bbm::ShiftedI32 epi(out, shift, 0);

  for (int kt = 0; kt < K; kt += kTileK) {
    bbm::stage_x(x, xs, m0, kt, M, K, wl);
    for (int e = threadIdx.x; e < kTileK * kTileN; e += kTileThreads) {
      const int kk = e / kTileN, nn = e % kTileN;
      const int gk = kt + kk, gn = n0 + nn;
      wd[kk][nn] = (gk < K && gn < N)
                       ? bbm::pack_digits<R>(wmag, wneg, (size_t)gk * N + gn,
                                             plane)
                       : 0u;
    }
    __syncthreads();
    const int kn = min(kTileK, K - kt);
    for (int kk = 0; kk < kn; ++kk) {
      int a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w = wd[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          epi.add(i, j, bbm::bbm_rows<R, KIND>(a[i], w, mr));
      }
    }
    __syncthreads();
  }
  epi.store(m0, n0, M, N);
}

template <int KIND>
__global__ void __launch_bounds__(kTileThreads)
bbm_matmul_dot_kernel(const int* __restrict__ x,
                      const int* __restrict__ wmag,
                      const int* __restrict__ wneg,
                      int32_t* __restrict__ out, int M, int K, int N,
                      int wl, int vbl, int R, int u, int up) {
  bbm::ShiftedI32 epi(out, u, up);
  bbm::dot_tile<KIND, true>(x, wmag, wneg, M, K, N, wl, vbl, R, epi);
}

template <int R, int KIND>
cudaError_t launch_rows(const int* x, const int* wmag, const int* wneg,
                        int32_t* out, int M, int K, int N, int wl, int vbl,
                        int shift, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  bbm_matmul_rows_kernel<R, KIND><<<grid, kTileThreads, 0, stream>>>(
      x, wmag, wneg, out, M, K, N, wl, vbl, shift);
  return cudaGetLastError();
}

#define BBM_ROWS_CASE(R)                                                   \
  case R:                                                                  \
    return kind ? launch_rows<R, 1>(x, wmag, wneg, out, M, K, N, wl, vbl,  \
                                    shift, stream)                         \
                : launch_rows<R, 0>(x, wmag, wneg, out, M, K, N, wl, vbl,  \
                                    shift, stream);

cudaError_t rows_dispatch(const int* x, const int* wmag, const int* wneg,
                          int32_t* out, int M, int K, int N, int wl, int vbl,
                          int kind, int shift, cudaStream_t stream) {
  switch (wl / 2) {
    BBM_ROWS_CASE(1) BBM_ROWS_CASE(2) BBM_ROWS_CASE(3) BBM_ROWS_CASE(4)
    BBM_ROWS_CASE(5) BBM_ROWS_CASE(6) BBM_ROWS_CASE(7) BBM_ROWS_CASE(8)
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (M, K) int32 codes (the low wl bits are read, signed), planes (wl/2, K,
// N) int32, out (M, N) int32: contiguous, on the stream's device; M, K, N
// >= 1, 2 <= wl <= 16 even.  Returns the cudaError_t of the launch.
int bbm_matmul_rows_launch(const int* x, const int* wmag, const int* wneg,
                           int* out, int M, int K, int N, int wl, int vbl,
                           int kind, int shift, void* stream) {
  return static_cast<int>(rows_dispatch(x, wmag, wneg, out, M, K, N, wl,
                                        vbl, kind, shift,
                                        static_cast<cudaStream_t>(stream)));
}

// As above; R = num_corr_rows(wl, vbl) <= 8.
int bbm_matmul_dot_launch(const int* x, const int* wmag, const int* wneg,
                          int* out, int M, int K, int N, int wl, int vbl,
                          int kind, int shift, int R, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  const int u = shift > vbl ? shift - vbl : 0;
  const int up = vbl > shift ? vbl - shift : 0;
  if (kind)
    bbm_matmul_dot_kernel<1><<<grid, kTileThreads, 0, st>>>(
        x, wmag, wneg, out, M, K, N, wl, vbl, R, u, up);
  else
    bbm_matmul_dot_kernel<0><<<grid, kTileThreads, 0, st>>>(
        x, wmag, wneg, out, M, K, N, wl, vbl, R, u, up);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route of bbm_matmul_dot_launch (shift <= vbl); words:
// a (K, N) int32 scratch the planes are packed into first.
int bbm_matmul_dot_mma_launch(const int* x, const int* wmag,
                              const int* wneg, int* words, int* out, int M,
                              int K, int N, int wl, int vbl, int kind,
                              int shift, void* stream) {
  const bbm_mma::Epilogue epi{out, nullptr, 0.0f, 0.0f, 0, vbl - shift, N,
                              false};
  return static_cast<int>(bbm_mma::launch(
      x, nullptr, wmag, wneg, words, M, K, N, wl, vbl, kind, K, epi,
      static_cast<cudaStream_t>(stream)));
}

const char* bbm_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
