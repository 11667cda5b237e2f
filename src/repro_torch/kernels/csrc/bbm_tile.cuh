// One 64 x 64 output tile of a Broken-Booth matmul on CUDA cores, as device
// functions.
//
// Shared by bbm_dot.cu (bbm_dot_scaled, bbm_dot_planes) and bbm_matmul.cu
// (bbm_matmul_rows, bbm_matmul_dot), so the tiling and the dot-form inner
// loop exist once.  One block of kTileThreads = 256 threads owns the tile;
// each thread 4 x 4 outputs (rows ty + 16i, columns tx + 16j).  K streams
// through shared memory kTileK at a time: x as sign-extended int32
// (stage_x), the multiplier's digits decoded once per block into bq and
// packed truncated rows (bbm_dot.cuh; from codes or from digit planes),
// unpacked into registers per use and reused across the thread's 4 rows.
// This is the CUDA-core route: the Python rule (bbm_matmul.py:
// bbm_dot_route) sends the contracted dot form to the int8 tensor cores
// (bbm_mma.cuh) wherever its chunks and operand bytes allow, and here only
// for chunks shorter than a tensor-core step, x and bq both two bytes
// wide, or bbm_matmul_dot at shift > vbl; bbm_matmul_rows always runs here.
//
// What becomes of each product is the epilogue's, a policy class with
// add(i, j, product), end_k (after every k) and store (after the last):
//
//   ChunkedF32<FAULT>  the amm datapath: int32 partials, flushed into f32
//                      sums in chunk order at every chunk boundary (FAULT:
//                      chunk ci's partial at (m, n) XORed first with
//                      1 << bit where bernoulli(keys[ci], p) hits the flat
//                      index m*N + n); out = f32 sum * 2^vbl.
//   ShiftedI32         the integer matmul: sums of product >> u in uint32
//                      (wrapping, as torch's int32 sums; inside the
//                      envelope the wrappers check nothing wraps);
//                      out = sum << up.
#pragma once
#include <stddef.h>
#include <stdint.h>

#include "bbm_dot.cuh"

namespace bbm {

constexpr int kTileThreads = 256;
constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 32;

// Stage x[m0.., kt..] sign-extended into xs[k][m], zeros outside.
__device__ __forceinline__ void stage_x(const int* __restrict__ x,
                                        int (*xs)[kTileM + 1], int m0, int kt,
                                        int M, int K, int wl) {
  for (int e = threadIdx.x; e < kTileM * kTileK; e += kTileThreads) {
    const int mm = e / kTileK, kk = e % kTileK;
    const int gm = m0 + mm, gk = kt + kk;
    xs[kk][mm] = (gm < M && gk < K)
                     ? signed_code(x[(size_t)gm * K + gk], wl)
                     : 0;
  }
}

template <bool FAULT>
struct ChunkedF32 {
  float* __restrict__ out;
  const uint32_t* __restrict__ keys;
  float p;
  int bit, chunk;
  float scale;
  int left, ci;                     // products left in chunk ci
  int part[4][4];
  float acc[4][4];

  __device__ __forceinline__ ChunkedF32(float* out_, const uint32_t* keys_,
                                        float p_, int bit_, int chunk_,
                                        float scale_)
      : out(out_), keys(keys_), p(p_), bit(bit_), chunk(chunk_),
        scale(scale_), left(chunk_), ci(0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        part[i][j] = 0;
        acc[i][j] = 0.0f;
      }
  }

  __device__ __forceinline__ void add(int i, int j, int prod) {
    part[i][j] += prod;
  }

  // Chunk ci's partials (faulted) into the f32 sums.
  __device__ __forceinline__ void flush_chunk(int m0, int n0, int M, int N) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (FAULT) {
          const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
          if (gm < M && gn < N &&
              bernoulli_hit(keys[2 * ci], keys[2 * ci + 1],
                            static_cast<uint32_t>(gm) * N + gn, p))
            part[i][j] ^= 1 << bit;
        }
        flush(acc[i][j], part[i][j]);
      }
  }

  __device__ __forceinline__ void end_k(int m0, int n0, int M, int N) {
    if (--left == 0) {
      flush_chunk(m0, n0, M, N);
      ++ci;
      left = chunk;
    }
  }

  __device__ __forceinline__ void store(int m0, int n0, int M, int N) {
    if (left != chunk) flush_chunk(m0, n0, M, N);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
};

struct ShiftedI32 {
  int32_t* __restrict__ out;
  int u, up;
  uint32_t acc[4][4];

  __device__ __forceinline__ ShiftedI32(int32_t* out_, int u_, int up_)
      : out(out_), u(u_), up(up_) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0u;
  }

  __device__ __forceinline__ void add(int i, int j, int prod) {
    acc[i][j] += static_cast<uint32_t>(prod >> u);
  }

  __device__ __forceinline__ void end_k(int, int, int, int) {}

  __device__ __forceinline__ void store(int m0, int n0, int M, int N) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + 16 * i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn < N)
          out[(size_t)gm * N + gn] = static_cast<int32_t>(acc[i][j] << up);
      }
    }
  }
};

// The block's tile of sum_k M(x[m, k], w[k, n]) (bbm_dot.cuh), each product
// handed to `epi`.  PLANES: the multiplier's digits come from (mag, neg)
// planes (wl/2, K, N), w = mag and wneg = neg; else w holds codes.
template <int KIND, bool PLANES, class Epi>
__device__ __forceinline__ void dot_tile(const int* __restrict__ x,
                                         const int* __restrict__ w,
                                         const int* __restrict__ wneg, int M,
                                         int K, int N, int wl, int vbl, int R,
                                         Epi& epi) {
  __shared__ int xs[kTileK][kTileM + 1];
  __shared__ Digits ws[kTileK][kTileN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const size_t plane = static_cast<size_t>(K) * N;

  for (int kt = 0; kt < K; kt += kTileK) {
    stage_x(x, xs, m0, kt, M, K, wl);
    for (int e = threadIdx.x; e < kTileK * kTileN; e += kTileThreads) {
      const int kk = e / kTileN, nn = e % kTileN;
      const int gk = kt + kk, gn = n0 + nn;
      const bool in = gk < K && gn < N;
      if (PLANES)
        ws[kk][nn] = in ? from_planes(w, wneg, (size_t)gk * N + gn, plane, wl,
                                      vbl, R)
                        : decode(0, wl, vbl, R);
      else
        ws[kk][nn] = decode(in ? w[(size_t)gk * N + gn] : 0, wl, vbl, R);
    }
    __syncthreads();
    const int kn = min(kTileK, K - kt);
    for (int kk = 0; kk < kn; ++kk) {
      int a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Unpacked u = unpack(ws[kk][tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          epi.add(i, j, scaled_product<KIND>(a[i], u, vbl, R));
      }
      epi.end_k(m0, n0, M, N);
    }
    __syncthreads();
  }
  epi.store(m0, n0, M, N);
}

}  // namespace bbm
