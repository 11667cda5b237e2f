// Flash attention for Hopper (sm_90a), exact and on the amm datapath.
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
//                        1/sqrt(d)), K and V arrive with their codes and
//                        per-(bh, block) scales from the wrapper.
//
// Both walk the TPU kernel's sequential KV grid axis as a loop inside one
// block per (q-block, batch*head); blocks run in any order.  256 threads
// own a 128 x 128 score tile, 8 x 8 each (rows ty + 16i, columns tx + 16j);
// a row's max and sum reduce over the 16 lanes that share ty with warp
// shuffles; P goes through shared memory to the P V product, where each
// thread owns 8 rows x d/16 columns of the output accumulator in registers.
//
// Float semantics.  f32 throughout, FFMA on the CUDA cores, no tensor
// cores: TF32 or bf16 would leave the reference's float contract.  The
// products' summation order differs from XLA's and from cuBLAS's, and expf
// may differ from other exp implementations in the last place, so these
// kernels equal their plain versions within stated bounds
// (kernels/flash_attention.py: flash_tolerance, flash_amm_compare).
// Everything after the float products is written as the reference writes
// it: __fadd_rn/__fmul_rn where it has no fused multiply-add, a true
// division and round-half-even (rintf) in the in-tile quantizer of P.
// The integer products of the amm kernel use bbm_dot.cuh, shared with the
// contracted matmul kernel, and are bit-equal to it: given equal codes,
// the approximate score products are equal (checked through s_out).
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
// Shared memory (d = 64): the exact kernel holds Q, K^T, V and P in f32,
// 165 KB.  The amm kernel holds Q, K^T (then V) and P in f32 plus their
// codes as int16, decoding the multiplier's digits in registers per use:
// 194 KB of the 227 KB a block may take.  The planes of the reference
// (16 int32 words per element) would not fit beside the tiles.
//
// Bound.  The exact kernel: 4 * S_q * S_kv * d f32 operations per head
// (both products), far above its bytes; the amm kernel adds the integer
// products (22 instructions each at wl 16 / vbl 13) of both products.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bbm_dot.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 128;
constexpr int BK = 128;
constexpr float kNegInf = -1e30f;

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
struct ExactSmem {
  float q[BQ][D + 1];
  float kt[D][BK + 1];
  float v[BK][D];
  float p[BQ][BK + 1];
};

// grid (ceil(Sq / bq), BH); q: (BH, Sq, D), k/v: (BH, Skv, D), out like q.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_exact_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   int Sq, int Skv, int bq, int bk, int causal, float scale) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ExactSmem<D>& sm = *reinterpret_cast<ExactSmem<D>*>(smem_raw);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * bq;
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Skv * D;
  const float* vb = v + (size_t)bh * Skv * D;

  for (int e = threadIdx.x; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    sm.q[r][d] = (r < bq && q0 + r < Sq) ? qb[(size_t)(q0 + r) * D + d]
                                         : 0.0f;
  }
  float m[8], l[8], acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }
  const int nk = (Skv + bk - 1) / bk;
  for (int kv = 0; kv < nk; ++kv) {
    const int k0 = kv * bk;
    for (int e = threadIdx.x; e < BK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const bool ok = c < bk && k0 + c < Skv;
      sm.kt[d][c] = ok ? kb[(size_t)(k0 + c) * D + d] : 0.0f;
      sm.v[c][d] = ok ? vb[(size_t)(k0 + c) * D + d] : 0.0f;
    }
    __syncthreads();
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sm.q[ty + 16 * i][d];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sm.kt[d][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    float alpha[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        const bool live = k0 + c < Skv && (!causal || q0 + r >= k0 + c);
        s[i][j] = live ? __fmul_rn(s[i][j], scale) : kNegInf;
        if (c < bk) rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(rmax));
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        const float p = c < bk ? expf(__fsub_rn(s[i][j], m_new)) : 0.0f;
        sm.p[r][c] = p;
        rsum = __fadd_rn(rsum, p);
      }
      alpha[i] = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), group_sum(rsum));
      m[i] = m_new;
    }
    __syncthreads();
    float pv[8][DC];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) pv[i][c] = 0.0f;
    for (int kk = 0; kk < bk; ++kk) {
      float a[8], b[DC];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sm.p[ty + 16 * i][kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) b[c] = sm.v[kk][tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) pv[i][c] = fmaf(a[i], b[c], pv[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], alpha[i]), pv[i][c]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= bq || q0 + r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      out[((size_t)bh * Sq + q0 + r) * D + tx + 16 * c] =
          __fdiv_rn(acc[i][c], den);
  }
}

template <int D>
struct AmmSmem {
  float q[BQ][D + 1];
  short qc[BQ][D];
  union {
    float kt[D][BK + 1];
    float v[BK][D];
  } f;
  union {
    short kt[D][BK + 2];
    short v[BK][D];
  } c;
  float p[BQ][BK + 1];
  short pc[BQ][BK];
  float red[kThreads / 32];
};

struct AmmArgs {
  int Sqp, Skvp, bq, bk, kv_len, causal, wl, vbl, R, chunk;
  float scale2vbl, inv_lim, lim;
};

// grid (Sqp / bq, BH).  qf/qc: (BH, Sqp, D); kf/kc/vf/vc: (BH, Skvp, D);
// qs: (BH, Sqp / bq), ks/vs: (BH, Skvp / bk); out: (BH, Sqp, D) f32;
// s_out: null, or (BH, Sqp, Skvp) f32 for each tile's approximate score
// product; pv_out: null, or (BH, Skvp / bk, Sqp, D) f32 for each tile's
// approximate P V product; pc_out: null, or (BH, Sqp, Skvp) int16 for P's
// codes; ps_out: null, or (BH, Sqp / bq, Skvp / bk) f32 for P's tile
// scales.
template <int D, int KIND>
__global__ void __launch_bounds__(kThreads)
flash_amm_kernel(const float* __restrict__ qf, const float* __restrict__ kf,
                 const float* __restrict__ vf, const int* __restrict__ qc,
                 const int* __restrict__ kc, const int* __restrict__ vc,
                 const float* __restrict__ qs, const float* __restrict__ ks,
                 const float* __restrict__ vs, float* __restrict__ out,
                 float* __restrict__ s_out, float* __restrict__ pv_out,
                 short* __restrict__ pc_out, float* __restrict__ ps_out,
                 AmmArgs g) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AmmSmem<D>& sm = *reinterpret_cast<AmmSmem<D>*>(smem_raw);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, qi = blockIdx.x, q0 = qi * g.bq;
  const int nq = g.Sqp / g.bq, nk = g.Skvp / g.bk;
  const size_t qbase = ((size_t)bh * g.Sqp + q0) * D;

  for (int e = threadIdx.x; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const bool ok = r < g.bq;
    sm.q[r][d] = ok ? qf[qbase + (size_t)r * D + d] : 0.0f;
    sm.qc[r][d] = ok ? static_cast<short>(qc[qbase + (size_t)r * D + d]) : 0;
  }
  const float sq = qs[(size_t)bh * nq + qi];
  float m[8], l[8], acc[8][DC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }
  for (int kv = 0; kv < nk; ++kv) {
    const int k0 = kv * g.bk;
    const size_t kbase = ((size_t)bh * g.Skvp + k0) * D;
    for (int e = threadIdx.x; e < BK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const bool ok = c < g.bk;
      sm.f.kt[d][c] = ok ? kf[kbase + (size_t)c * D + d] : 0.0f;
      sm.c.kt[d][c] = ok ? static_cast<short>(kc[kbase + (size_t)c * D + d])
                         : 0;
    }
    __syncthreads();
    // the exact f32 score product, parked in P's buffer
    {
      float s[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
      for (int d = 0; d < D; ++d) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sm.q[ty + 16 * i][d];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = sm.f.kt[d][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
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
              bbm::decode(sm.c.kt[d][tx + 16 * j], g.wl, g.vbl, g.R));
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
    const float sp = fmaxf(__fmul_rn(pmax, g.inv_lim), 1e-12f);
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
    __syncthreads();   // K's tiles are no longer read: V takes their place
    for (int e = threadIdx.x; e < BK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const bool ok = c < g.bk;
      sm.f.v[c][d] = ok ? vf[kbase + (size_t)c * D + d] : 0.0f;
      sm.c.v[c][d] = ok ? static_cast<short>(vc[kbase + (size_t)c * D + d])
                        : 0;
    }
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
      for (int c = 0; c < DC; ++c) b[c] = sm.f.v[kk][tx + 16 * c];
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
              bbm::decode(sm.c.v[kk][tx + 16 * c], g.wl, g.vbl, g.R));
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
    __syncthreads();
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
                 int BH, int Sq, int Skv, int bq, int bk, int causal,
                 float scale, cudaStream_t st) {
  const size_t smem = sizeof(ExactSmem<D>);
  int err = launch_config(flash_exact_kernel<D>, smem);
  if (err) return err;
  dim3 grid((Sq + bq - 1) / bq, BH);
  flash_exact_kernel<D><<<grid, kThreads, smem, st>>>(q, k, v, out, Sq, Skv,
                                                      bq, bk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int KIND>
int amm_launch(const float* qf, const float* kf, const float* vf,
               const int* qc, const int* kc, const int* vc, const float* qs,
               const float* ks, const float* vs, float* out, float* s_out,
               float* pv_out, short* pc_out, float* ps_out, int BH,
               const AmmArgs& g, cudaStream_t st) {
  const size_t smem = sizeof(AmmSmem<D>);
  int err = launch_config(flash_amm_kernel<D, KIND>, smem);
  if (err) return err;
  dim3 grid(g.Sqp / g.bq, BH);
  flash_amm_kernel<D, KIND><<<grid, kThreads, smem, st>>>(
      qf, kf, vf, qc, kc, vc, qs, ks, vs, out, s_out, pv_out, pc_out, ps_out,
      g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success), or -1 for an unsupported head
// dimension.  D in {16, 32, 64}; 1 <= bq, bk <= 128.
int flash_attention_launch(const float* q, const float* k, const float* v,
                           float* out, int BH, int Sq, int Skv, int D,
                           int bq, int bk, int causal, float scale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return exact_launch<16>(q, k, v, out, BH, Sq, Skv, bq, bk,
                                     causal, scale, st);
    case 32: return exact_launch<32>(q, k, v, out, BH, Sq, Skv, bq, bk,
                                     causal, scale, st);
    case 64: return exact_launch<64>(q, k, v, out, BH, Sq, Skv, bq, bk,
                                     causal, scale, st);
    default: return -1;
  }
}

// Sqp, Skvp: the padded lengths, multiples of bq and bk; kv_len: the valid
// KV positions.  s_out, pv_out, pc_out and ps_out may be null.
int flash_attention_amm_launch(const float* qf, const float* kf,
                               const float* vf, const int* qc, const int* kc,
                               const int* vc, const float* qs,
                               const float* ks, const float* vs, float* out,
                               float* s_out, float* pv_out, short* pc_out,
                               float* ps_out, int BH, int Sqp, int Skvp,
                               int D, int bq, int bk, int kv_len, int causal,
                               int wl, int vbl, int kind, int R, int chunk,
                               float inv_lim, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  AmmArgs g;
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
#define REPRO_AMM(DD)                                                      \
  return kind ? amm_launch<DD, 1>(qf, kf, vf, qc, kc, vc, qs, ks, vs, out, \
                                  s_out, pv_out, pc_out, ps_out, BH, g,    \
                                  st)                                      \
              : amm_launch<DD, 0>(qf, kf, vf, qc, kc, vc, qs, ks, vs, out, \
                                  s_out, pv_out, pc_out, ps_out, BH, g,    \
                                  st);
  switch (D) {
    case 16: REPRO_AMM(16)
    case 32: REPRO_AMM(32)
    case 64: REPRO_AMM(64)
    default: return -1;
  }
#undef REPRO_AMM
}

const char* flash_attention_error_string(int err) {
  if (err == -1) return "unsupported head dimension";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
