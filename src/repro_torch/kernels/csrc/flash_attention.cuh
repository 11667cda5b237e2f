// Flash attention for Hopper (sm_90a), exact and on the amm datapath, at
// head dims 16, 32 and 64: the kernels, their launch helpers and the entry
// points' bodies, instantiated by flash_attention.cu.  The pieces both
// head-dim ranges share (the copies, the live-tile count, the TF32 split,
// the quad and group reductions, the amm kernels' arguments) live here too;
// flash_attention_wide.cuh includes them for head dims 80 and 128, whose
// kernels are designed apart (flash_attention_wide.cu builds them in a
// library of its own, beside this one).
//
//   flash_attention      replaces repro/kernels/flash_attention.py
//                        _attn_kernel (ROADMAP B4): the exact forward,
//                        s = (q k^T) * 1/sqrt(d), KV rows >= Skv zeroed and
//                        masked, causal mask, online softmax, out =
//                        acc / max(l, 1e-30).
//   flash_attention_amm  replaces repro/kernels/flash_attention.py
//                        _attn_amm_kernel with its tile body _amm_tile_step
//                        (ROADMAP B3): per tile the exact f32 q k^T plus the
//                        straight-through correction toward the Broken-Booth
//                        product of the Q and K codes, the mask at -1e30,
//                        the online softmax, P quantized in the tile with one
//                        scale for the whole (bq, bk) tile, then P V the
//                        same way against V's codes.  Q (pre-scaled by
//                        1/sqrt(d)), K and V arrive with their int16 codes
//                        and per-(bh, block) scales from the wrapper.
//
// Dead tiles.  Each block owns one (q-block, batch*head) and walks the TPU
// kernel's sequential KV grid axis as a loop, but only over the tiles that
// hold a live (row, key) pair: a tile whose first key lies past the
// block's last row (causal) or at or past the valid KV length is dead for
// every row.  Both conditions bound the key from above, so the live tiles
// are the first live_tiles(...) of the axis (kernels/flash_attention.py:
// live_kv_tiles counts the same), and tile 0 is live for every row, so no
// running max stays at -1e30.  In a dead tile p = exp(-1e30 - m) = 0 and
// alpha = exp(m - m) = 1: l and acc come through bit for bit, and skipping
// it is exact.  On the amm datapath that holds for kind 0 only (P's codes
// are 0 there and a kind-0 product of code 0 is 0).  Kind 1 subtracts the
// sign bit of each negative digit before the truncating shift, so its
// product of code 0 is sum_r (0 - n_r) >> m_r = -(number of negative
// digits), a dead tile's P V product is not 0, and the reference adds it:
// kind 1 computes every tile.  A skipped tile's residuals get a dead
// kind-0 tile's values: score product 0 (read by nothing), P codes 0, P
// scale 1e-12 (the quantizer's floor), P V product 0.
//
// Schedule.  Blocks are numbered heaviest first: block L takes q-block
// nq - 1 - L / BH of head L % BH, so under causal the card's first wave
// holds the longest blocks and the short ones fill in behind them.  K and
// V tiles arrive by cp.async, 16-byte copies of f32 rows and 8-byte copies
// of int16 code rows, rows past the valid length zero-filled by the copy.
//
// The exact kernel (128 threads, 4 warps of 16 query rows, 64 x 64 tiles,
// two 103 KiB blocks per SM) double-buffers K and V: the copy of tile j +
// 1 runs while tile j computes.  Its score product runs on the tensor cores
// in 3xTF32 (mma.sync m16n8k8): each f32 operand x is split into hi =
// tf32(x) and lo = tf32(x - hi) (cvt.rna, round to nearest), and lo*hi,
// hi*lo and hi*hi go through one accumulator in that order, which is
// drained into f32 registers with a round-to-nearest add after every
// 8-term step.  Q's split fragments stay in registers for the whole KV
// loop.  Its P V product runs with FFMA on the CUDA cores from P in
// shared memory, summed apart per tile and added to the rescaled
// accumulator.
//
// Error model of the score product (u = 2^-24; a term is q_i k_i, T their
// absolute sum, A = max|q| / sqrt(d), K = max|k|, S = d A K >= T/sqrt(d)):
//   * the split: x - hi is exact, |x - hi| <= 2^-11 |x|, |lo - (x - hi)| <=
//     2^-22 |x|; the dropped lo*lo term and the two low-part roundings
//     leave each term within 3 * 2^-22 (1 + 2^-11) = 12.006 u of q_i k_i;
//   * the tensor core (the model of Fasi et al., "Numerical behavior of
//     NVIDIA tensor cores", 2021): products of TF32 values are exact, the
//     terms of one step are aligned to the largest and truncated to f32's
//     24 bits, the sum is truncated once more: a step of 8 products and
//     the accumulator is within 16 u max|term| + 2 u |result|.  The lo*hi
//     and hi*lo steps carry terms below 2^-10 of the hi*hi ones, so with
//     the last step the 8-term block b is within (16 + 0.03) u max_b +
//     2 u T_b, where max_b <= sqrt(d) A K;
//   * d/8 blocks drain into f32 registers: the first add is exact, the
//     other d/8 - 1 round (u T each); the scale 1/sqrt(d) is a power of
//     two at d = 16 and 64 (exact) and rounds once at d = 32.
// So |s - s_exact| <= (12.006 + 2 + d/8 - 1 + r) u S + 16.03 u (d/8) A K
// = (15.04 + d/8 + r) u S, r = 1 where the scale rounds: 17.04 u S at
// d = 16, 20.04 at d = 32, 23.04 at d = 64, inside the score term (d + 2)
// u S of flash_tolerance (18, 34, 66).
//
// The amm kernel (256 threads on a 128 x 128 tile, 8 x 8 each: rows ty +
// 16i, columns tx + 16j; 199 KiB at D = 64, one block per SM) holds one
// K-or-V buffer beside Q, P and P's codes: V's copy is issued when the
// score products are done and runs under the softmax and P's quantization;
// the next K's copy runs under the P V epilogue.  Its float products stay
// f32 FFMA (flash_amm_compare derives its code-movement bound from two f32
// evaluations); its integer products use bbm_dot.cuh, shared with the
// contracted matmul kernel, and are bit-equal to it: given equal codes,
// the approximate score products are equal (checked through s_out).  A
// row's max and sum reduce over the 16 lanes that share ty with warp
// shuffles; P's tile max over the block through shared memory.
//
// Float semantics.  The products' summation order differs from XLA's and
// from cuBLAS's, and expf may differ from other exp implementations in the
// last place, so these kernels equal their plain versions within stated
// bounds (kernels/flash_attention.py: flash_tolerance, flash_amm_compare).
// Everything after the float products is written as the reference writes
// it: __fadd_rn/__fmul_rn where it has no fused multiply-add, a true
// division and round-half-even (rintf) in the in-tile quantizer of P.
//
// Residuals.  The straight-through gradient of the reference
// differentiates the chunked schedule whose softmax sees the approximate
// scores and whose value products carry the approximate values.  When
// asked, the amm kernel writes both (s_out: every tile's approximate
// score product, descaled; pv_out: every tile's approximate P V product,
// descaled), so the backward can take that gradient in plain PyTorch
// without forming a Broken-Booth product again, and P's codes and tile
// scales (pc_out, ps_out), so a check can tell a code that float rounding
// moved from a wrong scale, mask or rescale.
//
// Bounds on this card.  The exact function, over the live (query, key)
// pairs: from Skv = 26 on, where the model above (flash_attention_wide.cuh
// carries it to P V) admits 3xTF32 for both products, 3 * 4 * pairs * d
// TF32 operations at 495 TFLOP/s (0.0114 ms at (4, 14, 512, 64) causal,
// above its bytes' 0.0088 ms); over shorter KV lengths P V's 2 * pairs * d
// f32 operations at 67 TFLOP/s.  The kernel's own FFMA P V takes 0.014 ms
// at that rate.  The amm kernel adds the integer products of both
// products: at the int8 tensor-core rate, as the contracted form computes
// them (34 byte products a code product at wl 16 / vbl 13 kind 0), they
// take less than its f32 FFMA products, which bound it; its own
// Broken-Booth products run as 22 int32 instructions each on the CUDA
// cores, far above that bound.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bbm_dot.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kDeadScale = 1e-12f;
// the entry points' error codes beside cudaError_t
constexpr int kBadHeadDim = -1;   // no instantiation at this head dim
constexpr int kBadRoute = -2;     // the route does not exist at this head dim

// ------------------------------------------------------------ shared pieces
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !ok.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The live KV tiles of a q-block whose last row is q_last: tiles of bk
// keys, the first kv_len of them valid (kernels/flash_attention.py:
// live_kv_tiles).
__device__ __forceinline__ int live_tiles(int q_last, int kv_len, int bk,
                                          int causal) {
  const int n = (kv_len + bk - 1) / bk;
  return causal ? min(n, q_last / bk + 1) : n;
}

// ------------------------------------------------------------ exact (B4)
constexpr int kExWarps = 4;
constexpr int kExThreads = 32 * kExWarps;
constexpr int kExBM = 16 * kExWarps;   // query rows per block
constexpr int kExBN = 64;              // keys per tile

template <int D>
struct ExactSmem {
  float q[kExBM][D + 4];               // stride D + 4: fragment reads
  float k[2][kExBN][D + 4];            // hit 32 banks
  float v[2][kExBN][D + 4];
  float p[kExWarps][16][kExBN + 8];    // each warp's P rows
  float alpha[kExWarps][16];           // and their rescales
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + e, |e| <= 2^-22 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(~0u, v, 1));
  return fmaxf(v, __shfl_xor_sync(~0u, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(~0u, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(~0u, v, 2));
}

// grid (ceil(Sq / 64) * BH); q: (BH, Sq, D), k/v: (BH, Skv, D), out like
// q.  In the score product lane (g, t) = (lane / 4, lane % 4) holds the
// rows g and g + 8 of its warp's 16, columns 8n + 2t and 8n + 2t + 1 (the
// mma accumulator layout).  In P V it holds the rows rg + RG i (rg = lane
// / (D / 4), RG = 128 / D rows apart) and the output columns 4 dg .. 4 dg
// + 3 (dg = lane % (D / 4)): D / 8 rows by 4 columns, so a key's P values
// and V row cost 12 shared-memory wavefronts a warp at d = 64.
template <int D>
__global__ void __launch_bounds__(kExThreads, 2)
flash_exact_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   int BH, int Sq, int Skv, int causal, float scale) {
  constexpr int KS = D / 8;        // 8-deep steps of the score product
  constexpr int NT = kExBN / 8;    // 8-key column tiles of a KV tile
  constexpr int RC = D / 4;        // 16-byte chunks per row
  constexpr int RG = 32 / RC;      // P V: row groups of a warp
  constexpr int RT = 16 / RG;      // P V: rows per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ExactSmem<D>& sm = *reinterpret_cast<ExactSmem<D>*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = lane / RC, dg = lane % RC;
  const int nq = (Sq + kExBM - 1) / kExBM;
  const int bh = blockIdx.x % BH, q0 = (nq - 1 - blockIdx.x / BH) * kExBM;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Skv * D;
  const float* vb = v + (size_t)bh * Skv * D;
  const int n_live = live_tiles(min(q0 + kExBM, Sq) - 1, Skv, kExBN, causal);

  for (int e = threadIdx.x; e < kExBM * RC; e += kExThreads) {
    const int r = e / RC, c = (e % RC) * 4;
    const bool ok = q0 + r < Sq;
    copy16(&sm.q[r][c], qb + (ok ? (size_t)(q0 + r) * D + c : 0), ok);
  }
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kExBN;
    for (int e = threadIdx.x; e < kExBN * RC; e += kExThreads) {
      const int r = e / RC, c = (e % RC) * 4;
      const bool ok = k0 + r < Skv;
      const size_t off = ok ? (size_t)(k0 + r) * D + c : 0;
      copy16(&sm.k[stage][r][c], kb + off, ok);
      copy16(&sm.v[stage][r][c], vb + off, ok);
    }
    copy_commit();
  };
  load_kv(0, 0);

  const int wr = warp * 16;        // the warp's first row in the block
  uint32_t qhi[KS][4], qlo[KS][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  float(*pw)[kExBN + 8] = sm.p[warp];
  float* aw = sm.alpha[warp];

  for (int tile = 0; tile < n_live; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_live) {
      load_kv(tile + 1, st ^ 1);   // runs under this tile's products
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int c = ks * 8 + t;
        split(sm.q[wr + g][c], qhi[ks][0], qlo[ks][0]);
        split(sm.q[wr + g + 8][c], qhi[ks][1], qlo[ks][1]);
        split(sm.q[wr + g][c + 4], qhi[ks][2], qlo[ks][2]);
        split(sm.q[wr + g + 8][c + 4], qhi[ks][3], qlo[ks][3]);
      }
    }
    // the score product, 3xTF32
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split(sm.k[st][n * 8 + g][ks * 8 + t], bh0, bl0);
        split(sm.k[st][n * 8 + g][ks * 8 + t + 4], bh1, bl1);
        float d4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(d4, qlo[ks], bh0, bh1);
        mma_tf32(d4, qhi[ks], bl0, bl1);
        mma_tf32(d4, qhi[ks], bh0, bh1);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = __fadd_rn(s[n][e], d4[e]);
      }
    }
    // mask, online softmax, P and the rescales to the warp's shared rows
    const int k0 = tile * kExBN;
    float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + wr + g + 8 * (e >> 1);
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool live = col < Skv && (!causal || row >= col);
        s[n][e] = live ? __fmul_rn(s[n][e], scale) : kNegInf;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], s[n][e]);
      }
    float m_new[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m[h], quad_max(rmax[h]));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(__fsub_rn(s[n][e], m_new[e >> 1]));
        rsum[e >> 1] = __fadd_rn(rsum[e >> 1], s[n][e]);
      }
      *reinterpret_cast<float2*>(&pw[g][n * 8 + 2 * t]) =
          make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(&pw[g + 8][n * 8 + 2 * t]) =
          make_float2(s[n][2], s[n][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float alpha = expf(__fsub_rn(m[h], m_new[h]));
      l[h] = __fadd_rn(__fmul_rn(l[h], alpha), quad_sum(rsum[h]));
      m[h] = m_new[h];
      if (t == 0) aw[g + 8 * h] = alpha;
    }
    __syncwarp();
    // P V with FFMA
    float pv[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) pv[i][c] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < kExBN; ++kk) {
      const float4 vv =
          *reinterpret_cast<const float4*>(&sm.v[st][kk][4 * dg]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float pr = pw[rg + RG * i][kk];
        pv[i][0] = fmaf(pr, vv.x, pv[i][0]);
        pv[i][1] = fmaf(pr, vv.y, pv[i][1]);
        pv[i][2] = fmaf(pr, vv.z, pv[i][2]);
        pv[i][3] = fmaf(pr, vv.w, pv[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float alpha = aw[rg + RG * i];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], alpha), pv[i][c]);
    }
    __syncthreads();               // the stage, P and the rescales are free
  }
  // each row's sum to the lanes that hold its output
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (t == 0) aw[g + 8 * h] = l[h];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + wr + rg + RG * i;
    if (row >= Sq) continue;
    const float den = fmaxf(aw[rg + RG * i], 1e-30f);
    *reinterpret_cast<float4*>(&out[((size_t)bh * Sq + row) * D + 4 * dg]) =
        make_float4(__fdiv_rn(acc[i][0], den), __fdiv_rn(acc[i][1], den),
                    __fdiv_rn(acc[i][2], den), __fdiv_rn(acc[i][3], den));
  }
}

// -------------------------------------------------------------- amm (B3)
constexpr int kThreads = 256;
constexpr int BQ = 128;
constexpr int BK = 128;

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

template <int D>
struct AmmSmem {
  float q[BQ][D + 4];       // row-major, stride D + 4: float4 reads of
  short qc[BQ][D + 4];      // 8 rows hit distinct banks, code reads of
  float kv[BK][D + 4];      // 16 rows too; K, then V
  short kvc[BK][D + 4];
  float p[BQ][BK + 1];
  short pc[BQ][BK];
  float red[kThreads / 32];
};

struct AmmArgs {
  int BH, Sqp, Skvp, bq, bk, kv_len, causal, wl, vbl, R, chunk;
  float scale2vbl, inv_lim, lim;
};

// Rows [0, rows) of a (., D) f32 array and of its int16 codes into
// shared memory; the rows up to 128 zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + 4],
                                          short (*dstc)[D + 4],
                                          const float* src, const short* srcc,
                                          int rows) {
  for (int e = threadIdx.x; e < 128 * (D / 4); e += kThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const bool ok = r < rows;
    const size_t off = ok ? (size_t)r * D + c : 0;
    copy16(&dst[r][c], src + off, ok);
    copy8(&dstc[r][c], srcc + off, ok);
  }
  copy_commit();
}

// grid (Sqp / bq * BH).  qf/qc: (BH, Sqp, D); kf/kc/vf/vc: (BH, Skvp, D);
// qs: (BH, Sqp / bq), ks/vs: (BH, Skvp / bk); out: (BH, Sqp, D) f32;
// s_out: null, or (BH, Sqp, Skvp) f32 for each tile's approximate score
// product; pv_out: null, or (BH, Skvp / bk, Sqp, D) f32 for each tile's
// approximate P V product; pc_out: null, or (BH, Sqp, Skvp) int16 for P's
// codes; ps_out: null, or (BH, Sqp / bq, Skvp / bk) f32 for P's tile
// scales.
template <int D, int KIND>
__global__ void __launch_bounds__(kThreads)
flash_amm_kernel(const float* __restrict__ qf, const float* __restrict__ kf,
                 const float* __restrict__ vf, const short* __restrict__ qc,
                 const short* __restrict__ kc, const short* __restrict__ vc,
                 const float* __restrict__ qs, const float* __restrict__ ks,
                 const float* __restrict__ vs, float* __restrict__ out,
                 float* __restrict__ s_out, float* __restrict__ pv_out,
                 short* __restrict__ pc_out, float* __restrict__ ps_out,
                 AmmArgs g) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AmmSmem<D>& sm = *reinterpret_cast<AmmSmem<D>*>(smem_raw);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nq = g.Sqp / g.bq, nk = g.Skvp / g.bk;
  const int bh = blockIdx.x % g.BH, qi = nq - 1 - blockIdx.x / g.BH;
  const int q0 = qi * g.bq;
  const size_t qbase = ((size_t)bh * g.Sqp + q0) * D;
  const size_t kvrow = (size_t)bh * g.Skvp;
  // kind 0 skips dead tiles; kind 1 computes them (see the header)
  const int n_live = KIND ? nk
                          : live_tiles(q0 + g.bq - 1, g.kv_len, g.bk,
                                       g.causal);

  load_tile<D>(sm.q, sm.qc, qf + qbase, qc + qbase, g.bq);
  if (n_live > 0)
    load_tile<D>(sm.kv, sm.kvc, kf + kvrow * D, kc + kvrow * D, g.bk);
  const float sq = qs[(size_t)bh * nq + qi];
  float m[8], l[8], acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }
  for (int kv = 0; kv < n_live; ++kv) {
    const int k0 = kv * g.bk;
    const size_t kbase = (kvrow + k0) * D;
    copy_wait<0>();                // K (and at kv = 0, Q) have landed
    __syncthreads();
    // the exact f32 score product, parked in P's buffer
    {
      float s[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
      for (int d = 0; d < D; d += 4) {
        float4 a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(&sm.q[ty + 16 * i][d]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = *reinterpret_cast<const float4*>(&sm.kv[tx + 16 * j][d]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sm.p[ty + 16 * i][tx + 16 * j] = s[i][j];
    }
    // the Broken-Booth score product of the codes, K^T as the multiplier
    float yq[8][8];
    {
      int part[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          part[i][j] = 0;
          yq[i][j] = 0.0f;
        }
      int left = g.chunk;
      for (int d = 0; d < D; ++d) {
        int a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sm.qc[ty + 16 * i][d];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bbm::Unpacked u = bbm::unpack(
              bbm::decode(sm.kvc[tx + 16 * j][d], g.wl, g.vbl, g.R));
#pragma unroll
          for (int i = 0; i < 8; ++i)
            part[i][j] += bbm::scaled_product<KIND>(a[i], u, g.vbl, g.R);
        }
        if (--left == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) bbm::flush(yq[i][j], part[i][j]);
          left = g.chunk;
        }
      }
      if (left != g.chunk) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) bbm::flush(yq[i][j], part[i][j]);
      }
    }
    __syncthreads();   // K is no longer read: V's copy runs under P's work
    load_tile<D>(sm.kv, sm.kvc, vf + kbase, vc + kbase, g.bk);
    const float sqk = __fmul_rn(sq, ks[(size_t)bh * nk + kv]);
    float alpha[8];
    float pmax = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      float s[8];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        const float approx = __fmul_rn(__fmul_rn(yq[i][j], g.scale2vbl), sqk);
        if (s_out != nullptr && r < g.bq && c < g.bk)
          s_out[((size_t)bh * g.Sqp + q0 + r) * g.Skvp + k0 + c] = approx;
        const float ex = sm.p[r][c];
        float sv = __fadd_rn(ex, __fsub_rn(approx, ex));
        const bool live = k0 + c < g.kv_len && (!g.causal || q0 + r >= k0 + c);
        s[j] = live ? sv : kNegInf;
        if (c < g.bk) rmax = fmaxf(rmax, s[j]);
      }
      const float m_new = fmaxf(m[i], group_max(rmax));
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        const float p = (c < g.bk && r < g.bq)
                            ? expf(__fsub_rn(s[j], m_new)) : 0.0f;
        sm.p[r][c] = p;
        rsum = __fadd_rn(rsum, p);
        pmax = fmaxf(pmax, p);
      }
      alpha[i] = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), group_sum(rsum));
      m[i] = m_new;
    }
    // one scale for the whole (bq, bk) tile of P: a block-wide max
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      pmax = fmaxf(pmax, __shfl_xor_sync(~0u, pmax, o));
    if (threadIdx.x % 32 == 0) sm.red[threadIdx.x / 32] = pmax;
    __syncthreads();
    pmax = sm.red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) pmax = fmaxf(pmax, sm.red[w]);
    const float sp = fmaxf(__fmul_rn(pmax, g.inv_lim), kDeadScale);
    if (ps_out != nullptr && threadIdx.x == 0)
      ps_out[((size_t)bh * nq + qi) * nk + kv] = sp;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float code = rintf(__fdiv_rn(sm.p[r][c], sp));
        code = fminf(fmaxf(code, -g.lim - 1.0f), g.lim);
        sm.pc[r][c] = static_cast<short>(code);
        if (pc_out != nullptr && r < g.bq && c < g.bk)
          pc_out[((size_t)bh * g.Sqp + q0 + r) * g.Skvp + k0 + c] =
              static_cast<short>(code);
      }
    copy_wait<0>();                // V has landed
    __syncthreads();
    float pe[8][DC];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) pe[i][c] = 0.0f;
    for (int kk = 0; kk < g.bk; ++kk) {
      float a[8], b[DC];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sm.p[ty + 16 * i][kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) b[c] = sm.kv[kk][tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) pe[i][c] = fmaf(a[i], b[c], pe[i][c]);
    }
    float yv[8][DC];
    {
      int part[8][DC];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          part[i][c] = 0;
          yv[i][c] = 0.0f;
        }
      int left = g.chunk;
      for (int kk = 0; kk < g.bk; ++kk) {
        int a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sm.pc[ty + 16 * i][kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const bbm::Unpacked u = bbm::unpack(
              bbm::decode(sm.kvc[kk][tx + 16 * c], g.wl, g.vbl, g.R));
#pragma unroll
          for (int i = 0; i < 8; ++i)
            part[i][c] += bbm::scaled_product<KIND>(a[i], u, g.vbl, g.R);
        }
        if (--left == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < DC; ++c) bbm::flush(yv[i][c], part[i][c]);
          left = g.chunk;
        }
      }
      if (left != g.chunk) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) bbm::flush(yv[i][c], part[i][c]);
      }
    }
    __syncthreads();   // V is no longer read: the next K's copy runs
    if (kv + 1 < n_live)            // under the epilogue
      load_tile<D>(sm.kv, sm.kvc, kf + kbase + (size_t)g.bk * D,
                   kc + kbase + (size_t)g.bk * D, g.bk);
    const float spv = __fmul_rn(sp, vs[(size_t)bh * nk + kv]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float approx = __fmul_rn(__fmul_rn(yv[i][c], g.scale2vbl), spv);
        const int r = ty + 16 * i;
        if (pv_out != nullptr && r < g.bq)
          pv_out[(((size_t)bh * nk + kv) * g.Sqp + q0 + r) * D + tx +
                 16 * c] = approx;
        const float pv = __fadd_rn(pe[i][c], __fsub_rn(approx, pe[i][c]));
        acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], alpha[i]), pv);
      }
  }
  // the skipped tiles' residuals: a dead kind-0 tile's values
  for (int kv = n_live; kv < nk; ++kv) {
    const int k0 = kv * g.bk;
    for (int e = threadIdx.x; e < g.bq * g.bk; e += kThreads) {
      const size_t o =
          ((size_t)bh * g.Sqp + q0 + e / g.bk) * g.Skvp + k0 + e % g.bk;
      if (s_out != nullptr) s_out[o] = 0.0f;
      if (pc_out != nullptr) pc_out[o] = 0;
    }
    if (pv_out != nullptr)
      for (int e = threadIdx.x; e < g.bq * D; e += kThreads)
        pv_out[(((size_t)bh * nk + kv) * g.Sqp + q0) * D + e] = 0.0f;
    if (ps_out != nullptr && threadIdx.x == 0)
      ps_out[((size_t)bh * nq + qi) * nk + kv] = kDeadScale;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= g.bq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      out[qbase + (size_t)r * D + tx + 16 * c] = __fdiv_rn(acc[i][c], den);
  }
}

template <typename Kernel>
int launch_config(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return static_cast<int>(err);
}

template <int D>
int exact_launch(const float* q, const float* k, const float* v, float* out,
                 int BH, int Sq, int Skv, int causal, float scale,
                 cudaStream_t st) {
  const size_t smem = sizeof(ExactSmem<D>);
  int err = launch_config(flash_exact_kernel<D>, smem);
  if (err) return err;
  const int blocks = (Sq + kExBM - 1) / kExBM * BH;
  flash_exact_kernel<D><<<blocks, kExThreads, smem, st>>>(q, k, v, out, BH,
                                                          Sq, Skv, causal,
                                                          scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int KIND>
int amm_launch(const float* qf, const float* kf, const float* vf,
               const short* qc, const short* kc, const short* vc,
               const float* qs, const float* ks, const float* vs, float* out,
               float* s_out, float* pv_out, short* pc_out, float* ps_out,
               const AmmArgs& g, cudaStream_t st) {
  const size_t smem = sizeof(AmmSmem<D>);
  int err = launch_config(flash_amm_kernel<D, KIND>, smem);
  if (err) return err;
  flash_amm_kernel<D, KIND><<<g.Sqp / g.bq * g.BH, kThreads, smem, st>>>(
      qf, kf, vf, qc, kc, vc, qs, ks, vs, out, s_out, pv_out, pc_out, ps_out,
      g);
  return static_cast<int>(cudaGetLastError());
}

// The amm entry points' arguments, as the kernels take them.
inline AmmArgs make_amm_args(int BH, int Sqp, int Skvp, int bq, int bk,
                             int kv_len, int causal, int wl, int vbl, int R,
                             int chunk, float inv_lim) {
  AmmArgs g;
  g.BH = BH;
  g.Sqp = Sqp;
  g.Skvp = Skvp;
  g.bq = bq;
  g.bk = bk;
  g.kv_len = kv_len;
  g.causal = causal;
  g.wl = wl;
  g.vbl = vbl;
  g.R = R;
  g.chunk = chunk;
  g.scale2vbl = static_cast<float>(1u << vbl);
  g.inv_lim = inv_lim;
  g.lim = static_cast<float>((1 << (wl - 1)) - 1);
  return g;
}

// The entry points' bodies over the head dims DS... that a source
// instantiates; kBadHeadDim for any other.
template <int... DS>
int exact_dispatch(const float* q, const float* k, const float* v,
                   float* out, int BH, int Sq, int Skv, int D, int causal,
                   float scale, cudaStream_t st) {
  int err = kBadHeadDim;
  ((D == DS ? (err = exact_launch<DS>(q, k, v, out, BH, Sq, Skv, causal,
                                      scale, st), 0) : 0), ...);
  return err;
}

template <int... DS>
int amm_dispatch(const float* qf, const float* kf, const float* vf,
                 const short* qc, const short* kc, const short* vc,
                 const float* qs, const float* ks, const float* vs, float* out,
                 float* s_out, float* pv_out, short* pc_out, float* ps_out,
                 const AmmArgs& g, int D, int kind, cudaStream_t st) {
  int err = kBadHeadDim;
  ((D == DS ? (err = kind ? amm_launch<DS, 1>(qf, kf, vf, qc, kc, vc, qs, ks,
                                              vs, out, s_out, pv_out, pc_out,
                                              ps_out, g, st)
                          : amm_launch<DS, 0>(qf, kf, vf, qc, kc, vc, qs, ks,
                                              vs, out, s_out, pv_out, pc_out,
                                              ps_out, g, st), 0) : 0), ...);
  return err;
}

inline const char* error_string(int err) {
  if (err == kBadHeadDim) return "unsupported head dimension";
  if (err == kBadRoute) return "no such route at this head dimension";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace
