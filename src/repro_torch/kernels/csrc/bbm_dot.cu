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
// Batched, codes in: Bt independent (M, K) x (K, N) products of the
// int-code KV cache's decode attention, the score product Q K^T and the
// value product P V of every (slot, kv-head) slice, in one launch, on two
// routes chosen by the Python rule (bbm_matmul.py: bbm_coded_route): the
// int8 tensor cores (bbm_dot_coded_mma_launch, bbm_coded_mma.cuh) wherever
// every chunk and, per K-block, every block holds a 16-deep mma.sync step
// and the operand bytes need at most two significances; elsewhere the
// CUDA-core bbm_coded_kernel below (bbm_dot_coded_batched_launch).
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

#include <climits>

#include "bbm_coded_mma.cuh"
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

// The batched codes-in entry.  Slice z = z1 * B2 + z2 of Bt = B1 * B2:
//
//   yq[z, m, n] = 2^vbl * (f32 chunk sums, in order, of sum_k M(a[z, m, k],
//                 b[z, k, n]))
//
// a: (Bt, M, K) int32 codes, contiguous; b: int8/int16/int32 codes read
// through element strides (b_s1, b_s2, b_sk, b_sn), so the kernel reads
// the KV cache's own layout.  The epilogue, in the reference's float
// expression order (repro/kernels/bbm_matmul.py: bbm_matmul_coded,
// bbm_matmul_coded_kblocks; every f32 operation an explicit
// round-to-nearest intrinsic, so nothing contracts into an FMA):
//
//   MODE 1  out = yq * (s_a[z] * s_b[z, n / block])           (per column)
//   MODE 2  out = sum over K-blocks j, in order, with the first as is, of
//           yq_j * (s_a[z] * s_b[z, j]), yq_j the chunked sum over the
//           block's rows alone                                 (per K-block)
//
// live (may be null): positions of the blocked axis (N in MODE 1, K in
// MODE 2) at or past live[z1] read as zero codes.  A zero code
// decodes to zero digits, whose products are 0 under both kinds, so the
// kernel skips them: a MODE 1 tile wholly past live forms no product, and
// MODE 2 stops its K loop at the last live block and adds the dead blocks'
// +0 parts, yq_j = 0, in order (the same bits as forming them).
//
// Tile: kCodedM = 8 rows x kCodedN = 32 columns per block of 256 threads,
// one output a thread (decode attention has M = the query heads of one kv
// head, 7 at qwen2-0.5b); K through shared memory kCodedK at a time, the
// multiplier's digits decoded once per block.  The CUDA-core route: chunks
// or K-blocks shorter than a tensor-core step, x and bq both two bytes.
constexpr int kCodedM = 8;
constexpr int kCodedN = 32;
constexpr int kCodedK = 32;
constexpr int kCodedThreads = kCodedM * kCodedN;

template <int KIND, typename T, int MODE>
__global__ void __launch_bounds__(kCodedThreads)
bbm_coded_kernel(const int* __restrict__ a, const float* __restrict__ s_a,
                 const T* __restrict__ b, long long b_s1, long long b_s2,
                 long long b_sk, long long b_sn,
                 const float* __restrict__ s_b, long long t_s1,
                 long long t_s2, long long t_sj,
                 const int* __restrict__ live, float* __restrict__ out,
                 int B2, int M, int K, int N, int wl, int vbl, int R,
                 int chunk, int block, float scale) {
  __shared__ int xs[kCodedK][kCodedM];
  __shared__ bbm::Digits ws[kCodedK][kCodedN];
  const int z = blockIdx.z, z1 = z / B2, z2 = z % B2;
  const int tx = threadIdx.x % kCodedN, ty = threadIdx.x / kCodedN;
  const int m0 = blockIdx.y * kCodedM, n0 = blockIdx.x * kCodedN;
  const int gm = m0 + ty, gn = n0 + tx;
  const int* az = a + static_cast<size_t>(z) * M * K;
  const T* bz = b + z1 * b_s1 + z2 * b_s2;
  const float* sbz = s_b + z1 * t_s1 + z2 * t_s2;
  const int lv = live ? live[z1] : INT_MAX;
  int kend = K;                     // rows with products to form
  if (MODE == 1 && n0 >= lv) kend = 0;
  if (MODE == 2 && lv < K)
    kend = lv <= 0 ? 0 : ((lv + block - 1) / block) * block;
  const float sa = s_a[z];

  int part = 0;                     // int32 partial of the current chunk
  float blk = 0.0f;                 // f32 chunk sums of the current block
  float acc = 0.0f;                 // MODE 2: the ordered block sum
  bool first = true;
  int left_chunk = chunk, left_block = MODE == 2 ? block : K, j = 0;
  for (int kt = 0; kt < kend; kt += kCodedK) {
    {
      const int mm = threadIdx.x / kCodedK, kk = threadIdx.x % kCodedK;
      const int m = m0 + mm, k = kt + kk;
      xs[kk][mm] = (m < M && k < K)
                       ? bbm::signed_code(az[static_cast<size_t>(m) * K + k],
                                          wl)
                       : 0;
    }
    for (int e = threadIdx.x; e < kCodedK * kCodedN; e += kCodedThreads) {
      const int kk = e / kCodedN, nn = e % kCodedN;
      const int k = kt + kk, n = n0 + nn;
      const int at = MODE == 1 ? n : k;
      const int code = (k < K && n < N && at < lv)
                           ? static_cast<int>(bz[k * b_sk + n * b_sn])
                           : 0;
      ws[kk][nn] = bbm::decode(code, wl, vbl, R);
    }
    __syncthreads();
    const int kn = min(kCodedK, kend - kt);
    for (int kk = 0; kk < kn; ++kk) {
      const bbm::Unpacked u = bbm::unpack(ws[kk][tx]);
      part += bbm::scaled_product<KIND>(xs[kk][ty], u, vbl, R);
      --left_block;
      if (--left_chunk == 0 || left_block == 0) {
        bbm::flush(blk, part);
        left_chunk = chunk;
      }
      if (MODE == 2 && left_block == 0) {
        const float p = __fmul_rn(__fmul_rn(blk, scale),
                                  __fmul_rn(sa, sbz[j * t_sj]));
        acc = first ? p : __fadd_rn(acc, p);
        first = false;
        blk = 0.0f;
        left_block = block;
        ++j;
      }
    }
    __syncthreads();
  }
  if (gm >= M || gn >= N) return;
  float v;
  if (MODE == 2) {
    for (; j < K / block; ++j) {    // the dead blocks' +0 parts
      const float p = __fmul_rn(__fmul_rn(0.0f, scale),
                                __fmul_rn(sa, sbz[j * t_sj]));
      acc = first ? p : __fadd_rn(acc, p);
      first = false;
    }
    v = acc;
  } else {
    v = __fmul_rn(__fmul_rn(blk, scale),
                  __fmul_rn(sa, sbz[(gn / block) * t_sj]));
  }
  out[(static_cast<size_t>(z) * M + gm) * N + gn] = v;
}

template <int KIND, typename T>
void launch_coded(dim3 grid, cudaStream_t st, int mode, const int* a,
                  const float* s_a, const void* b, const bbm_coded::Strides& s,
                  const float* s_b, const int* live, float* out, int B2,
                  int M, int K, int N, int wl, int vbl, int R, int chunk,
                  int block, float scale) {
  const T* bt = static_cast<const T*>(b);
#define BBM_CODED(MODE)                                                     \
  bbm_coded_kernel<KIND, T, MODE><<<grid, kCodedThreads, 0, st>>>(          \
      a, s_a, bt, s.b1, s.b2, s.bk, s.bn, s_b, s.s1, s.s2, s.sj, live, out, \
      B2, M, K, N, wl, vbl, R, chunk, block, scale)
  if (mode == 2) BBM_CODED(2);
  else BBM_CODED(1);
#undef BBM_CODED
}

template <int KIND>
void launch_coded_kind(dim3 grid, cudaStream_t st, int mode, int b_bytes,
                       const int* a, const float* s_a, const void* b,
                       const bbm_coded::Strides& s, const float* s_b,
                       const int* live, float* out, int B2, int M, int K,
                       int N, int wl, int vbl, int R, int chunk, int block,
                       float scale) {
  if (b_bytes == 1)
    launch_coded<KIND, int8_t>(grid, st, mode, a, s_a, b, s, s_b, live, out,
                               B2, M, K, N, wl, vbl, R, chunk, block, scale);
  else if (b_bytes == 2)
    launch_coded<KIND, int16_t>(grid, st, mode, a, s_a, b, s, s_b, live, out,
                                B2, M, K, N, wl, vbl, R, chunk, block, scale);
  else
    launch_coded<KIND, int32_t>(grid, st, mode, a, s_a, b, s, s_b, live, out,
                                B2, M, K, N, wl, vbl, R, chunk, block, scale);
}

// An empty kernel: a launch's own floor on the card, timed beside the
// bounds (chip_smoke.py).
__global__ void bbm_empty_kernel() {}

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

// The batched codes-in entry (bbm_coded_kernel): Bt = B1 * B2 slices.
// a: (Bt, M, K) int32 codes; s_a: (Bt,) f32; b: codes of b_bytes (1, 2 or
// 4) bytes at element strides (b_s1, b_s2, b_sk, b_sn) for (z1, z2, k, n);
// s_b: f32 at element strides (t_s1, t_s2, t_sj) for (z1, z2, j); live:
// (B1,) int32 or null; out: (Bt, M, N) f32; mode 1 or 2.  M, K, N >= 1,
// Bt < 65536, block >= 1 (MODE 2: block divides K),
// R = num_corr_rows(wl, vbl), chunk = amm_chunk_len(wl, vbl).
int bbm_dot_coded_batched_launch(const int* a, const float* s_a,
                                 const void* b, int b_bytes, long long b_s1,
                                 long long b_s2, long long b_sk,
                                 long long b_sn, const float* s_b,
                                 long long t_s1, long long t_s2,
                                 long long t_sj, const int* live, float* out,
                                 int B1, int B2, int M, int K, int N, int wl,
                                 int vbl, int kind, int R, int chunk,
                                 int mode, int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kCodedN - 1) / kCodedN, (M + kCodedM - 1) / kCodedM,
            B1 * B2);
  const float scale = static_cast<float>(1u << vbl);
  const bbm_coded::Strides s{b_s1, b_s2, b_sk, b_sn, t_s1, t_s2, t_sj};
  if (kind)
    launch_coded_kind<1>(grid, st, mode, b_bytes, a, s_a, b, s, s_b, live,
                         out, B2, M, K, N, wl, vbl, R, chunk, block, scale);
  else
    launch_coded_kind<0>(grid, st, mode, b_bytes, a, s_a, b, s, s_b, live,
                         out, B2, M, K, N, wl, vbl, R, chunk, block, scale);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core route of bbm_dot_coded_batched_launch (bbm_coded_mma.cuh):
// the same operands, less R; chunk >= 16, and in mode 2 block >= 16.
int bbm_dot_coded_mma_launch(const int* a, const float* s_a, const void* b,
                             int b_bytes, long long b_s1, long long b_s2,
                             long long b_sk, long long b_sn,
                             const float* s_b, long long t_s1,
                             long long t_s2, long long t_sj, const int* live,
                             float* out, int B1, int B2, int M, int K, int N,
                             int wl, int vbl, int kind, int chunk, int mode,
                             int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bbm_coded::Strides s{b_s1, b_s2, b_sk, b_sn, t_s1, t_s2, t_sj};
  cudaError_t err;
  if (b_bytes == 1)
    err = bbm_coded::launch(a, s_a, static_cast<const int8_t*>(b), s_b, s,
                            live, out, B1, B2, M, K, N, wl, vbl, kind, chunk,
                            mode, block, st);
  else if (b_bytes == 2)
    err = bbm_coded::launch(a, s_a, static_cast<const int16_t*>(b), s_b, s,
                            live, out, B1, B2, M, K, N, wl, vbl, kind, chunk,
                            mode, block, st);
  else
    err = bbm_coded::launch(a, s_a, static_cast<const int32_t*>(b), s_b, s,
                            live, out, B1, B2, M, K, N, wl, vbl, kind, chunk,
                            mode, block, st);
  return static_cast<int>(err);
}

// One launch of an empty kernel (1 block of 32 threads).
int bbm_empty_launch(void* stream) {
  bbm_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* bbm_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
