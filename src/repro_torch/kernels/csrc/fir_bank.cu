// Broken-Booth FIR filterbank kernels for Hopper (sm_90a), plain C interface.
//
// Two routes, chosen by the Python rule fir_kernel.py: fir_bank_route from
// (wl, vbl, kind, shift, taps) alone:
//
//   "mma"        (fir_mma.cuh) wherever shift <= vbl, x and bq are not both
//                two bytes wide and the band fits in shared memory: every
//                product is 2^vbl M, so the tap sum is one contraction, run
//                on the int8 tensor cores as a banded (Toeplitz) product.
//                Both wrappers, fir_bank_rows and fir_bank_dot, take it.
//   "cuda-core"  the two kernels below, for shift > vbl (a floor per
//                product: no contraction form), exact Booth's two-byte x and
//                bq, and tap counts whose band exceeds shared memory:
//
//   fir_bank_rows  replaces the Pallas kernel repro/kernels/fir_kernel.py
//                  _fir_bank_kernel: y[c,n] = sum_k bbm(x[c,n-k], h[c,k]) >> shift,
//                  walking the wl/2 Booth rows of every tap product.
//   fir_bank_dot   replaces the XLA dot form repro/kernels/fir_kernel.py
//                  _fir_bank_dotform: per output
//                  sum_k a*bq[c,k] + sum_k sum_{r<R} ((d_r*a - neg_r*kind) >> m_r),
//                  then the shift rules of the reference (per-product >> u when
//                  shift > vbl, a final << (vbl - shift) when vbl > shift).
//
// The CUDA-core kernels are bound by int32 ALU issue, not memory: a (C, N)
// flush moves 8*C*N bytes but does C*N*taps*wl/2 row evaluations (rows) or
// C*N*taps*(1+R) multiply-adds (dot).  Their design keeps every operand of
// that arithmetic on chip: one block owns one (channel, time tile), stages
// the tile's samples plus the taps-1 samples before it (zeros before n = 0)
// sign-extended into shared memory, and stages its channel's digit planes
// packed one 32-bit word per tap (3 bits per row: mag | neg << 2; the
// packing and the row semantics live in bbm_rows.cuh, shared with
// bbm_matmul.cu).  The TPU kernel's VMEM halo carried across a sequential
// time axis is not needed: blocks read their own history straight from
// device memory, so they run in any order.  Each thread owns kPerThread
// outputs strided by the block width, so a warp reads consecutive
// shared-memory words.
//
// Integer rules: right shifts of signed values stay arithmetic (the floor
// is the paper's truncation); every left shift of a possibly negative
// value is done on uint32_t and cast back (signed left shift of a negative
// value is undefined before C++20).  Inside the int32 envelope
// taps * 2^(2wl-1-shift) < 2^31, which the Python wrappers check before
// launching, no sum overflows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bbm_rows.cuh"
#include "fir_mma.cuh"

namespace {

using bbm::bbm_rows;
using bbm::pack_digits;
using bbm::shl;

constexpr int kThreads = 256;
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;   // outputs per block

// Stage x[c, n0-(taps-1) .. n0+kTile-1], sign-extended, zeros outside [0, N).
__device__ __forceinline__ void stage_samples(const int32_t* __restrict__ xc,
                                              int32_t* xs, int n0, int N,
                                              int taps, int wl) {
  const int span = kTile + taps - 1;
  const int mask = (1 << wl) - 1;
  const int sign = 1 << (wl - 1);
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const int n = n0 - (taps - 1) + j;
    int v = 0;
    if (n >= 0 && n < N) {
      const int u = xc[n] & mask;
      v = u >= sign ? u - (1 << wl) : u;
    }
    xs[j] = v;
  }
}

// Stage the channel's planes: one word per tap, row r in bits [3r, 3r+3).
template <int R>
__device__ __forceinline__ void stage_digits(const int32_t* __restrict__ hmag,
                                             const int32_t* __restrict__ hneg,
                                             uint32_t* dig, int c, int C,
                                             int taps) {
  for (int k = threadIdx.x; k < taps; k += blockDim.x)
    dig[k] = pack_digits<R>(hmag, hneg, static_cast<size_t>(c) * taps + k,
                            static_cast<size_t>(C) * taps);
}

template <int R, int KIND>
__global__ void __launch_bounds__(kThreads)
fir_bank_rows_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ hmag,
                     const int32_t* __restrict__ hneg,
                     int32_t* __restrict__ out, int C, int N, int taps,
                     int wl, int vbl, int shift) {
  extern __shared__ int32_t smem[];
  const int c = blockIdx.y;
  const int n0 = blockIdx.x * kTile;
  int32_t* xs = smem;
  uint32_t* dig = reinterpret_cast<uint32_t*>(smem + kTile + taps - 1);
  stage_samples(x + static_cast<size_t>(c) * N, xs, n0, N, taps, wl);
  stage_digits<R>(hmag, hneg, dig, c, C, taps);
  __syncthreads();

  int mr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mr[r] = max(0, vbl - 2 * r);

  int acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0;
  for (int k = 0; k < taps; ++k) {
    const uint32_t w = dig[k];
    const int base = threadIdx.x + taps - 1 - k;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int prod = bbm_rows<R, KIND>(xs[base + j * kThreads], w, mr);
      acc[j] += prod >> shift;
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int n = n0 + threadIdx.x + j * kThreads;
    if (n < N) out[static_cast<size_t>(c) * N + n] = acc[j];
  }
}

// RC = num_corr_rows(wl, vbl): the truncated rows the dot form walks.
template <int RC, int KIND>
__global__ void __launch_bounds__(kThreads)
fir_bank_dot_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ bq,
                    const int32_t* __restrict__ hmag,
                    const int32_t* __restrict__ hneg,
                    int32_t* __restrict__ out, int C, int N, int taps,
                    int wl, int vbl, int shift) {
  extern __shared__ int32_t smem[];
  const int c = blockIdx.y;
  const int n0 = blockIdx.x * kTile;
  int32_t* xs = smem;
  int32_t* bqs = smem + kTile + taps - 1;
  uint32_t* dig = reinterpret_cast<uint32_t*>(bqs + taps);
  stage_samples(x + static_cast<size_t>(c) * N, xs, n0, N, taps, wl);
  for (int k = threadIdx.x; k < taps; k += blockDim.x)
    bqs[k] = bq[static_cast<size_t>(c) * taps + k];
  stage_digits<RC>(hmag, hneg, dig, c, C, taps);
  __syncthreads();

  const int u = max(shift - vbl, 0);         // per-product residual rescale
  int acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0;
  for (int k = 0; k < taps; ++k) {
    const int b = bqs[k];
    const uint32_t w = dig[k];
    int d[RC > 0 ? RC : 1], s[RC > 0 ? RC : 1];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int code = (w >> (3 * r)) & 7;
      s[r] = code >> 2;
      d[r] = s[r] ? -(code & 3) : (code & 3);   // signed digit
    }
    const int base = threadIdx.x + taps - 1 - k;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int a = xs[base + j * kThreads];
      int mk = a * b;
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const int rowp = d[r] * a - (KIND ? s[r] : 0);
        mk += rowp >> (vbl - 2 * r);
      }
      acc[j] += mk >> u;
    }
  }
  const int up = vbl > shift ? vbl - shift : 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int n = n0 + threadIdx.x + j * kThreads;
    if (n < N) out[static_cast<size_t>(c) * N + n] = shl(acc[j], up);
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

template <int R, int KIND>
cudaError_t launch_rows(const int32_t* x, const int32_t* hmag,
                        const int32_t* hneg, int32_t* out, int C, int N,
                        int taps, int wl, int vbl, int shift,
                        cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * (kTile + taps - 1 + taps);
  cudaError_t err = prepare(fir_bank_rows_kernel<R, KIND>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, C);
  fir_bank_rows_kernel<R, KIND><<<grid, kThreads, smem, stream>>>(
      x, hmag, hneg, out, C, N, taps, wl, vbl, shift);
  return cudaGetLastError();
}

template <int RC, int KIND>
cudaError_t launch_dot(const int32_t* x, const int32_t* bq,
                       const int32_t* hmag, const int32_t* hneg, int32_t* out,
                       int C, int N, int taps, int wl, int vbl, int shift,
                       cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * (kTile + taps - 1 + 2 * taps);
  cudaError_t err = prepare(fir_bank_dot_kernel<RC, KIND>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, C);
  fir_bank_dot_kernel<RC, KIND><<<grid, kThreads, smem, stream>>>(
      x, bq, hmag, hneg, out, C, N, taps, wl, vbl, shift);
  return cudaGetLastError();
}

#define FIR_ROWS_CASE(R)                                                    \
  case R:                                                                   \
    return kind ? launch_rows<R, 1>(x, hmag, hneg, out, C, N, taps, wl,     \
                                    vbl, shift, stream)                     \
                : launch_rows<R, 0>(x, hmag, hneg, out, C, N, taps, wl,     \
                                    vbl, shift, stream);

#define FIR_DOT_CASE(RC)                                                    \
  case RC:                                                                  \
    return kind ? launch_dot<RC, 1>(x, bq, hmag, hneg, out, C, N, taps, wl, \
                                    vbl, shift, stream)                     \
                : launch_dot<RC, 0>(x, bq, hmag, hneg, out, C, N, taps, wl, \
                                    vbl, shift, stream);

cudaError_t rows_dispatch(const int32_t* x, const int32_t* hmag,
                          const int32_t* hneg, int32_t* out, int C, int N,
                          int taps, int wl, int vbl, int kind, int shift,
                          cudaStream_t stream) {
  switch (wl / 2) {
    FIR_ROWS_CASE(1) FIR_ROWS_CASE(2) FIR_ROWS_CASE(3) FIR_ROWS_CASE(4)
    FIR_ROWS_CASE(5) FIR_ROWS_CASE(6) FIR_ROWS_CASE(7) FIR_ROWS_CASE(8)
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dot_dispatch(const int32_t* x, const int32_t* bq,
                         const int32_t* hmag, const int32_t* hneg,
                         int32_t* out, int C, int N, int taps, int wl, int vbl,
                         int kind, int shift, cudaStream_t stream) {
  const int rc = (vbl + 1) / 2 < wl / 2 ? (vbl + 1) / 2 : wl / 2;
  switch (rc) {
    FIR_DOT_CASE(0) FIR_DOT_CASE(1) FIR_DOT_CASE(2) FIR_DOT_CASE(3)
    FIR_DOT_CASE(4) FIR_DOT_CASE(5) FIR_DOT_CASE(6) FIR_DOT_CASE(7)
    FIR_DOT_CASE(8)
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (C, N), planes (wl/2, C, taps), out (C, N): int32, contiguous, on the
// stream's device.  Returns the cudaError_t of the launch (0 on success).
int fir_bank_rows_launch(const void* x, const void* hmag, const void* hneg,
                         void* out, int C, int N, int taps, int wl, int vbl,
                         int kind, int shift, void* stream) {
  return static_cast<int>(rows_dispatch(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(hmag),
      static_cast<const int32_t*>(hneg), static_cast<int32_t*>(out), C, N,
      taps, wl, vbl, kind, shift, static_cast<cudaStream_t>(stream)));
}

// As above plus bq (C, taps) = booth_high_value of the planes.
int fir_bank_dot_launch(const void* x, const void* bq, const void* hmag,
                        const void* hneg, void* out, int C, int N, int taps,
                        int wl, int vbl, int kind, int shift, void* stream) {
  return static_cast<int>(dot_dispatch(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(bq),
      static_cast<const int32_t*>(hmag), static_cast<const int32_t*>(hneg),
      static_cast<int32_t*>(out), C, N, taps, wl, vbl, kind, shift,
      static_cast<cudaStream_t>(stream)));
}

// Either wrapper's tensor-core route (shift <= vbl): the same arguments as
// fir_bank_rows_launch; cudaErrorInvalidValue where the route cannot take
// the call.
int fir_bank_mma_launch(const void* x, const void* hmag, const void* hneg,
                        void* out, int C, int N, int taps, int wl, int vbl,
                        int kind, int shift, void* stream) {
  return static_cast<int>(fir_mma::launch(
      static_cast<const int*>(x), static_cast<const int*>(hmag),
      static_cast<const int*>(hneg), static_cast<int*>(out), C, N, taps, wl,
      vbl, kind, shift, static_cast<cudaStream_t>(stream)));
}

const char* fir_bank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
