// Fused quantize -> matmul -> counter-hash noise -> descale, for Hopper.
//
// Replaces the Pallas TPU kernel quant_matmul_kernel
// (src/repro/kernels/quant_matmul.py).  For x (M, K) and w (K, N) in f32
// and f32 scales s_x, s_w (device scalars, read through pointers so a
// scale computed on the card costs no host sync):
//
//   xq  = clip(rint(x / s_x), -2^(wl-1), 2^(wl-1) - 1)        (same for w)
//   acc = sum over the K chunks [c*bk, min((c+1)*bk, K)) of the f32 chunk
//         partial sum of xq * wq, the partials added in K order
//   out = (acc + (mu_k + sig_k * z)) * (s_x * s_w)
//
// with mu_k = f32(mu*K), sig_k = f32(sigma) * sqrt(f32(K)) (both formed
// on the host, as the reference folds them) and z the reference's
// _hash_normal: a squares-style uint32 counter hash over the tile-local
// row/column of a logical (bm, bn) tile, salted with i*7919 + j, then
// Box-Muller in f32.  The hash tile is logical: the CUDA blocks need not
// be bm x bn.  The K tail past K counts as zero (the Pallas kernel reads
// an unmasked last K block, which gives NaN off-TPU: ROADMAP C5).
//
// Bits.  Every division is a true IEEE division (__fdiv_rn; the build
// uses no --use_fast_math), rounding is rintf (half to even), and the
// noise and descale use __fadd_rn/__fmul_rn so nothing contracts into an
// FMA that the reference expression does not have.  The chunk partials
// are summed with FMA in any order: that is exact while every partial is
// an integer below 2^24 (wl <= 8 with bk <= 512), where the result is
// bit-equal to the plain PyTorch version; above that (wl = 12, 16: the
// products reach 2^30) f32 rounds and the comparison takes a stated
// tolerance.
//
// Design.  Two launches on the caller's stream.  qm_partial: one block
// per (64-column tile, 16- or 64-row tile, K chunk) quantizes its x and w
// tiles into shared memory as it loads them and accumulates its chunk's
// partial sums in registers (256 threads, 1x4 or 4x4 outputs each),
// writing them to a (chunks, M, N) f32 scratch.  Splitting over the
// chunks keeps the grid wide at decode shapes (M = 8: 76 x 2 blocks for
// K = 896, N = 4864; 14 x 10 for K = 4864, N = 896) without changing
// the reference's summation structure.  qm_finish: one thread per output
// adds the partials in chunk order, draws z and writes the descaled sum.
//
// Bound.  At the decode shapes the kernel reads w once in f32, 17.4 MB
// per call: 5.2 us at 3.35 TB/s, so bytes bound it.  The loads are plain
// coalesced 4-byte loads, not TMA, and there are no tensor cores:
// codes at wl = 16 are not exact in TF32 or bf16, so a tensor-core design
// would change the answer (an int8 IMMA route over split codes could keep
// the bits; later work).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTN = 64;         // columns per block, 4 per thread
constexpr int kTK = 32;         // K rows per shared-memory stage

__device__ __forceinline__ float quantize(float v, float s, float lim) {
  float q = rintf(__fdiv_rn(v, s));
  // clip(q, -lim, lim - 1), passing NaN through as jnp.clip does
  return q < -lim ? -lim : (q > lim - 1.0f ? lim - 1.0f : q);
}

__device__ __forceinline__ uint32_t squares(uint32_t x, uint32_t key) {
  x = x * key;
  x = (x >> 16) | (x << 16);
  x = x * x + key;
  x = (x >> 16) | (x << 16);
  x = x * x + key;
  return x;
}

__device__ __forceinline__ void hash_words(uint32_t r, uint32_t c,
                                           uint32_t seed, uint32_t salt,
                                           uint32_t& w1, uint32_t& w2) {
  uint32_t ctr = r * 0x9E3779B9u + c * 0x85EBCA6Bu;
  ctr = ctr + seed * 0xC2B2AE35u;
  ctr = ctr + salt * 0x27D4EB2Fu;
  w1 = squares(ctr, 0xB5AD4ECEu);
  w2 = squares(ctr ^ 0xDEADBEEFu, 0x548C9DECu);
}

// the element (gm, gn) of an output cut into logical (bm, bn) tiles
__device__ __forceinline__ void tile_words(int gm, int gn, int bm, int bn,
                                           uint32_t seed, uint32_t& w1,
                                           uint32_t& w2) {
  const uint32_t salt = (uint32_t)(gm / bm) * 7919u + (uint32_t)(gn / bn);
  hash_words((uint32_t)(gm % bm), (uint32_t)(gn % bn), seed, salt, w1, w2);
}

__device__ __forceinline__ float box_muller(uint32_t w1, uint32_t w2) {
  float u1 = __fmul_rn(__uint2float_rn(w1), 0x1p-32f);   // exact scaling
  float u2 = __fmul_rn(__uint2float_rn(w2), 0x1p-32f);
  u1 = fminf(fmaxf(u1, 1e-7f), 1.0f);
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(6.28318530717958647692f, u2)));
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
qm_partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ sx_p,
                  const float* __restrict__ sw_p,
                  float* __restrict__ partial, int M, int K, int N, int bk,
                  float lim) {
  constexpr int TM = 16 * RM;
  __shared__ float xs[kTK][TM + 1];   // +1: conflict-free stores
  __shared__ float ws[kTK][kTN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kTN, m0 = blockIdx.y * TM;
  const int chunk = blockIdx.z;
  const int k_begin = chunk * bk;
  const int k_end = min(k_begin + bk, K);
  const float sx = *sx_p, sw = *sw_p;

  float part[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;

  for (int kt = k_begin; kt < k_end; kt += kTK) {
    for (int e = threadIdx.x; e < TM * kTK; e += kThreads) {
      const int mm = e / kTK, kk = e % kTK;
      const int gm = m0 + mm, gk = kt + kk;
      xs[kk][mm] = (gm < M && gk < k_end)
                       ? quantize(x[(size_t)gm * K + gk], sx, lim)
                       : 0.0f;
    }
    for (int e = threadIdx.x; e < kTK * kTN; e += kThreads) {
      const int kk = e / kTN, nn = e % kTN;
      const int gk = kt + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < k_end && gn < N)
                       ? quantize(w[(size_t)gk * N + gn], sw, lim)
                       : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      float a[RM], b[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[kk][ty * RM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    __syncthreads();
  }

  float* dst = partial + (size_t)chunk * M * N;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m0 + ty * RM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) dst[(size_t)gm * N + gn] = part[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
qm_finish_kernel(const float* __restrict__ partial,
                 const float* __restrict__ sx_p,
                 const float* __restrict__ sw_p, float* __restrict__ out,
                 int M, int N, int chunks, int bm, int bn, uint32_t seed,
                 float mu_k, float sig_k) {
  const float scale = __fmul_rn(*sx_p, *sw_p);
  const size_t total = (size_t)M * N;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int c = 0; c < chunks; ++c)
      acc = __fadd_rn(acc, partial[(size_t)c * total + idx]);
    const int gm = (int)(idx / N), gn = (int)(idx % N);
    uint32_t w1, w2;
    tile_words(gm, gn, bm, bn, seed, w1, w2);
    const float eps = __fadd_rn(mu_k, __fmul_rn(sig_k, box_muller(w1, w2)));
    out[idx] = __fmul_rn(__fadd_rn(acc, eps), scale);
  }
}

__global__ void __launch_bounds__(kThreads)
qm_hash_words_kernel(uint32_t* __restrict__ w1, uint32_t* __restrict__ w2,
                     int M, int N, int bm, int bn, uint32_t seed) {
  const size_t total = (size_t)M * N;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    tile_words((int)(idx / N), (int)(idx % N), bm, bn, seed, w1[idx],
               w2[idx]);
  }
}

int elementwise_blocks(size_t total) {
  size_t blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 65535 ? (blocks > 0 ? blocks : 1) : 65535);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  partial: (ceil(K/bk), M, N) f32
// scratch; out: (M, N) f32.  M, K, N >= 1; 1 <= bk; 1 <= bm, bn.
int quant_matmul_launch(const float* x, const float* w, const float* sx,
                        const float* sw, float* partial, float* out, int M,
                        int K, int N, int wl, int bm, int bk, int bn,
                        unsigned int seed, float mu_k, float sig_k,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (K + bk - 1) / bk;
  const float lim = (float)(1 << (wl - 1));
  const int n_tiles = (N + kTN - 1) / kTN;
  if (M <= 32) {
    dim3 grid(n_tiles, (M + 15) / 16, chunks);
    qm_partial_kernel<1><<<grid, kThreads, 0, st>>>(x, w, sx, sw, partial, M,
                                                   K, N, bk, lim);
  } else {
    dim3 grid(n_tiles, (M + 63) / 64, chunks);
    qm_partial_kernel<4><<<grid, kThreads, 0, st>>>(x, w, sx, sw, partial, M,
                                                   K, N, bk, lim);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qm_finish_kernel<<<elementwise_blocks((size_t)M * N), kThreads, 0, st>>>(
      partial, sx, sw, out, M, N, chunks, bm, bn, seed, mu_k, sig_k);
  return (int)cudaGetLastError();
}

// The hash's two uint32 words for every element of an (M, N) output cut
// into (bm, bn) tiles: the check that the kernel's uniforms are the
// reference's, bit for bit.
int qm_hash_words_launch(unsigned int* w1, unsigned int* w2, int M, int N,
                         int bm, int bn, unsigned int seed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qm_hash_words_kernel<<<elementwise_blocks((size_t)M * N), kThreads, 0,
                         st>>>(w1, w2, M, N, bm, bn, seed);
  return (int)cudaGetLastError();
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
