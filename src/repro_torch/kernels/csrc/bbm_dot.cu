// The contracted Broken-Booth dot form for Hopper (sm_90a), plain C interface.
//
// Replaces the XLA lowering repro/kernels/bbm_matmul.py: _dot_scaled behind
// bbm_matmul_scaled (the bitexact LM's every MLP product, ROADMAP B2), with
// two entries: codes in (bbm_dot_scaled_launch, the training path) and
// digit planes in (bbm_dot_planes_launch, the fault-injected datapath of
// bbm_matmul_scaled / bbm_matmul_dynamic, with the keyed accumulator
// upsets of repro/core/faults.py drawn in the kernel):
//
//   out[m, n] = 2^vbl * sum over K-chunks c, in order, of f32( sum_{k in c}
//               M(x[m, k], w[k, n]) )
//
// with M the folded per-product form of bbm_dot.cuh, chunks of amm_chunk_len
// (wl, vbl) products (each int32 partial exact), f32 adds in chunk order.
// The reference sums each truncated row over K as a digit dot minus one-hot
// residue dots; that K-sum equals the sum of the per-product floors, which
// both routes below form without the residues.
//
// Two routes, chosen per call by the Python rule (bbm_matmul.py:
// bbm_dot_route) from (wl, vbl) alone:
//
// Tensor cores (bbm_dot_scaled_mma_launch, bbm_dot_planes_mma_launch):
// the int8 wgmma kernel of bbm_mma.cuh, which contracts each row's floor
// as byte products at one scale (34 per code product at wl 16 / vbl 13,
// kind 0; 21 at kind 1), wherever every chunk holds a 32-deep step and
// the operand bytes need at most two significances: the bitexact MLP
// products of training (wl 16 / vbl 13, chunks of 8,191) go here.  Bound:
// the int8 tensor cores (chip_smoke.py counts the fewest byte products of
// the exact forms known, this kernel's 34 and 21, at 1,979 TOP/s).
//
// CUDA cores (bbm_dot_scaled_launch, bbm_dot_planes_launch): the shared
// tile of bbm_tile.cuh (64 x 64 outputs per block of 256 threads, K
// through shared memory 32 at a time, the digits decoded once per block)
// with its chunked f32 epilogue, one integer multiply, shift and add per
// truncated row and product.  It serves chunks shorter than a tensor-core
// step (wl 16 / vbl 3: 7 products; exact Booth: 1) and the points whose
// x and bq both take two bytes; bound there: int32 issue.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bbm_mma.cuh"
#include "bbm_tile.cuh"

namespace {

using bbm::kTileM;
using bbm::kTileN;
using bbm::kTileThreads;

template <int KIND>
__global__ void __launch_bounds__(kTileThreads)
bbm_dot_kernel(const int* __restrict__ x, const int* __restrict__ w,
               float* __restrict__ out, int M, int K, int N, int wl, int vbl,
               int R, int chunk, float scale) {
  bbm::ChunkedF32<false> epi(out, nullptr, 0.0f, 0, chunk, scale);
  bbm::dot_tile<KIND, false>(x, w, nullptr, M, K, N, wl, vbl, R, epi);
}

template <int KIND, bool FAULT>
__global__ void __launch_bounds__(kTileThreads)
bbm_dot_planes_kernel(const int* __restrict__ x,
                      const int* __restrict__ wmag,
                      const int* __restrict__ wneg,
                      const uint32_t* __restrict__ keys, float p, int bit,
                      float* __restrict__ out, int M, int K, int N, int wl,
                      int vbl, int R, int chunk, float scale) {
  bbm::ChunkedF32<FAULT> epi(out, keys, p, bit, chunk, scale);
  bbm::dot_tile<KIND, true>(x, wmag, wneg, M, K, N, wl, vbl, R, epi);
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
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  const float scale = static_cast<float>(1u << vbl);
  if (kind)
    bbm_dot_kernel<1><<<grid, kTileThreads, 0, st>>>(x, w, out, M, K, N, wl,
                                                     vbl, R, chunk, scale);
  else
    bbm_dot_kernel<0><<<grid, kTileThreads, 0, st>>>(x, w, out, M, K, N, wl,
                                                     vbl, R, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

// The planes-in entry: wmag, wneg (wl/2, K, N) int32 digit planes in place
// of w's codes (faulted planes included).  keys: null, or n_chunks pairs of
// uint32 threefry keys (one per K-chunk of `chunk` products) for the
// accumulator fault at rate p on bit `bit`.
int bbm_dot_planes_launch(const int* x, const int* wmag, const int* wneg,
                          const void* keys, float p, int bit, float* out,
                          int M, int K, int N, int wl, int vbl, int kind,
                          int R, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  const float scale = static_cast<float>(1u << vbl);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
#define BBM_DOT_PLANES(KIND, FAULT)                                         \
  bbm_dot_planes_kernel<KIND, FAULT><<<grid, kTileThreads, 0, st>>>(        \
      x, wmag, wneg, k, p, bit, out, M, K, N, wl, vbl, R, chunk, scale)
  if (kind && keys) BBM_DOT_PLANES(1, true);
  else if (kind) BBM_DOT_PLANES(1, false);
  else if (keys) BBM_DOT_PLANES(0, true);
  else BBM_DOT_PLANES(0, false);
#undef BBM_DOT_PLANES
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route of bbm_dot_scaled_launch (same operands; chunk =
// amm_chunk_len(wl, vbl) >= 32).
int bbm_dot_scaled_mma_launch(const int* x, const int* w, float* out, int M,
                              int K, int N, int wl, int vbl, int kind,
                              int chunk, void* stream) {
  const bbm_mma::Epilogue epi{out, nullptr, 0.0f,
                              static_cast<float>(1u << vbl), 0, 0, N, true};
  return static_cast<int>(bbm_mma::launch(
      x, w, nullptr, nullptr, nullptr, M, K, N, wl, vbl, kind, chunk, epi,
      static_cast<cudaStream_t>(stream)));
}

// The tensor-core route of bbm_dot_planes_launch; words: a (K, N) int32
// scratch the planes are packed into first.
int bbm_dot_planes_mma_launch(const int* x, const int* wmag,
                              const int* wneg, int* words, const void* keys,
                              float p, int bit, float* out, int M, int K,
                              int N, int wl, int vbl, int kind, int chunk,
                              void* stream) {
  const bbm_mma::Epilogue epi{out, static_cast<const uint32_t*>(keys), p,
                              static_cast<float>(1u << vbl), bit, 0, N, true};
  return static_cast<int>(bbm_mma::launch(
      x, nullptr, wmag, wneg, words, M, K, N, wl, vbl, kind, chunk, epi,
      static_cast<cudaStream_t>(stream)));
}

const char* bbm_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
