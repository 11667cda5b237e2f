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
// Bits.  Every quotient is the IEEE one, rounded to nearest even (see
// Quantizer: two exact correction steps on a true reciprocal, __fdiv_rn
// outside their range; the build uses no --use_fast_math), rounding is
// rintf (half to even), NaN passes through the quantizer, and the noise
// and descale use __fadd_rn/__fmul_rn so nothing contracts into an FMA
// that the reference expression does not have.  A chunk's partial may be summed in any order and split any way,
// but no split crosses a chunk boundary.  Where every chunk partial is an
// integer below 2^24 (wl <= 8 with bk <= 512) the result is bit-equal to
// the plain PyTorch version; above that f32 rounds and the comparison
// takes a stated tolerance.
//
// Two routes, one launch each and no scratch in device memory, chosen by
// the wrapper's plan (quant_matmul_plan in quant_matmul.py, which forms
// the same K slabs from the launch's ranks, tile width and rows a rank):
//
// Decode (M up to the plan's threshold; bound by bytes: at (8, 896) x
// (896, 4864) the call reads w, 17.4 MB, once: 5.2 us at 3.35 TB/s).  A
// thread-block cluster of `ranks` blocks shares one tile of TN (32, 64
// or 128) columns and a group of at most 16 output rows (no padding to
// a fixed tile height); rank r takes the w rows [r*rows, (r+1)*rows),
// cut at the K chunk boundaries into sub-slabs.  Each thread streams its
// rows through its own ring of kStages groups in shared memory
// (cp.async, 16 bytes a copy, kStages - 1 groups ahead, no block barrier:
// a thread reads back only what it copied), quantizes them in registers
// and FFMAs them into every output row; the block's x slab is quantized
// once into shared memory while the ring fills.  Each sub-slab's
// partial is summed over the block's warps and stored into the shared
// memory of the rank that owns the output (st.shared::cluster; the first
// store waits on an arrive made at entry, so every rank has started);
// after one cluster barrier the owner adds the chunks in K order, then the
// noise (drawn while the first loads flew) and the descale.  The plan
// takes the fewest waves of blocks, then the most blocks: one block an
// SM streams at about the memory's share of an SM.  A scalar-copy
// variant (VEC = false) serves an N that is not a multiple of 4 or a w
// off a 16-byte boundary.
//
// Tiled (prefill; bound by operations).  An exact int8 tensor-core route:
// each code q is split into a signed high byte h = q >> 8 and an unsigned
// low byte l = q & 255, q = 256 h + l, and
//   x.w = 2^16 (xh.wh) + 2^8 (xh.wl + xl.wh) + xl.wl,
// four mma.sync m16n8k32 products (.s8.s8, .s8.u8, .u8.s8, .u8.u8) into
// three int32 accumulators, each exact over up to 32,768 rows (|xh wh| <=
// 2^14, |xh wl + xl wh| <= 65,280, xl wl <= 65,025), the longest chunk the
// launch takes.  At a chunk's end the three combine exactly in int64 and
// convert to f32 once, so each chunk partial is the exact sum rounded
// once: bit-equal at wl <= 8 and more accurate than any f32 order above it.
// Integer codes cannot carry NaN, so the tile keeps a NaN flag per row of
// x and column of w and writes NaN where the plain version's NaN code
// would have spread.  Block tile 128 x 64 x 64 (8 warps of 32 x 32), raw
// f32 tiles double-buffered by cp.async (16 bytes, or 4 in the scalar
// variant), quantized and split into padded code planes in shared memory
// (80-byte rows: conflict-free ldmatrix), fragments by ldmatrix.x4.
// Where the output tiles are few, a cluster of ranks splits the whole K
// chunks and each chunk partial goes to the rank owning its element.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The quantizer: clip(rint(v / s), -lim, lim - 1) with v / s the IEEE
// quotient rounded to nearest even, NaN passing through as jnp.clip
// passes it.  __fdiv_rn per element is a sequence with a branch to its
// slow path around every division, which serializes the elements' chains.
// Instead y = RN(1/s) is formed once (a true reciprocal) and each
// quotient by two correction steps (Markstein): q0 = RN(v y); q1 =
// RN(q0 + RN(v - q0 s) y) errs by O(2^-46) relative before its rounding,
// so it is faithful; then r1 = v - q1 s is exact and q2 = RN(q1 + r1 y) =
// RN(v / s) (Markstein's theorem: y within half an ulp of 1/s, q1 within
// one ulp of v / s, nothing underflowing or overflowing).  With |s| in
// [2^-38, 2^38] that holds for |v| in [2^-40, 2^88]; a smaller |v| has
// |v / s| < 1/4, where q2 (exact or not) rounds to the same zero code;
// a larger one, or an infinity, gives q0 = v y, beyond any clip bound
// with the quotient's sign; NaN stays NaN.  No element branches.  An s
// outside that range (for example the 1e-12 floor of an all-zero tensor)
// takes __fdiv_rn for every element.  qm_quotient_check holds q2 against
// __fdiv_rn over every dividend significand, qm_codes the codes against
// the true division's over every exponent.
struct Quantizer {
  float s, y, lim;
  bool fast;
  __device__ __forceinline__ Quantizer(float s_, float lim_) {
    s = s_;
    y = __frcp_rn(s_);
    lim = lim_;
    const float a = fabsf(s_);
    fast = a >= 0x1p-38f && a <= 0x1p38f;
  }
  // RN(v / s) where fast; beyond the clip bound, or NaN, where it is not
  __device__ __forceinline__ float quotient(float v) const {
    const float q0 = __fmul_rn(v, y);
    const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, v), y, q0);
    const float q2 = __fmaf_rn(__fmaf_rn(-q1, s, v), y, q1);
    return fabsf(v) <= 0x1p88f ? q2 : q0;
  }
  // rint, then clip to [-lim, lim - 1] with NaN passing through (the
  // .NaN forms of min and max; a select chain would compile to branches)
  __device__ __forceinline__ float clip(float q) const {
    q = rintf(q);
    float lo, hi;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(lo) : "f"(q), "f"(-lim));
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(hi) : "f"(lo), "f"(lim - 1.0f));
    return hi;
  }
  // the codes, FAST the (uniform) value of `fast`: a caller branches once
  // outside its loop, so no element's chain ends in a branch
  template <bool FAST>
  __device__ __forceinline__ float code(float v) const {
    if constexpr (FAST) return clip(quotient(v));
    return clip(divide(v, s));
  }
  template <bool FAST>
  __device__ __forceinline__ float4 code4(float4 v) const {
    if constexpr (FAST)
      return make_float4(clip(quotient(v.x)), clip(quotient(v.y)),
                         clip(quotient(v.z)), clip(quotient(v.w)));
    const float4 q = divide4(v, s);
    return make_float4(clip(q.x), clip(q.y), clip(q.z), clip(q.w));
  }
  // the true division, out of line: the hot loops stay small
  static __device__ __noinline__ float divide(float v, float s) {
    return __fdiv_rn(v, s);
  }
  static __device__ __noinline__ float4 divide4(float4 v, float s) {
    return make_float4(__fdiv_rn(v.x, s), __fdiv_rn(v.y, s),
                       __fdiv_rn(v.z, s), __fdiv_rn(v.w, s));
  }
};

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

// the noise mu_k + sig_k * z of the output element (gm, gn)
__device__ __forceinline__ float noise(int gm, int gn, int bm, int bn,
                                       uint32_t seed, float mu_k,
                                       float sig_k) {
  uint32_t w1, w2;
  tile_words(gm, gn, bm, bn, seed, w1, w2);
  return __fadd_rn(mu_k, __fmul_rn(sig_k, box_muller(w1, w2)));
}

// (acc + eps) * scale for the output element (gm, gn)
__device__ __forceinline__ float finish(float acc, int gm, int gn, int bm,
                                        int bn, uint32_t seed, float mu_k,
                                        float sig_k, float scale) {
  return __fmul_rn(__fadd_rn(acc, noise(gm, gn, bm, bn, seed, mu_k, sig_k)),
                   scale);
}

// ------------------------------------------------------------ decode route
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a float into the shared memory of the cluster's block `rank`
__device__ __forceinline__ void st_cluster(float* p, int rank, float v) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p), r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(r), "f"(v)
               : "memory");
}

// the split cluster barrier: a block may touch another's shared memory
// only once every block of the cluster has started, which a (relaxed)
// arrive at entry and a wait before the first remote store establish
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

constexpr int kStages = 4;     // the decode route's ring: groups in flight
constexpr int kGroup = 4;      // w rows a thread takes per group

// Dynamic shared memory of the decode route, in floats.
__host__ __device__ constexpr size_t decode_smem_floats(int rows, int mr,
                                                        int tn, int ranks,
                                                        int per_rank) {
  return (size_t)kStages * kGroup * kThreads * 4 + (size_t)rows * mr +
         (size_t)kWarps * mr * tn +
         (size_t)(ranks * per_rank + 1) * ((mr * tn + ranks - 1) / ranks);
}

// grid (ranks, ceil(N / TN), ceil(M / MR)), cluster (ranks, 1, 1).
template <int MR, int TN, bool VEC>
__global__ void __launch_bounds__(kThreads, MR <= 8 ? 2 : 1)
qm_decode_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ sx_p,
                 const float* __restrict__ sw_p, float* __restrict__ out,
                 int M, int K, int N, int bk, int rows, float lim, int bm,
                 int bn, uint32_t seed, float mu_k, float sig_k) {
  constexpr int LPR = TN / 4;             // lanes per w row, 4 columns each
  constexpr int RS = kThreads / LPR;      // rows a block takes at once
  constexpr int U = kGroup, S = kStages;
  extern __shared__ float4 qm_smem[];
  __shared__ int rank_c0[8], rank_n[8];
  float4* ring = qm_smem;                           // [S][U][kThreads]
  float* xs = reinterpret_cast<float*>(ring + S * U * kThreads);  // [rows][MR]
  float* red = xs + (size_t)rows * MR;              // [kWarps][MR][TN]
  float* inbox = red + kWarps * MR * TN;            // [ranks][slabs][per]

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();       // waited on before the first remote store
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid % LPR, slot = tid / LPR;
  const int rank = blockIdx.x, ranks = gridDim.x;
  const int n0 = blockIdx.y * TN, m0 = blockIdx.z * MR;
  const int mr = min(MR, M - m0);
  const int gn = n0 + 4 * col;
  const int kr0 = (int)min((long long)rank * rows, (long long)K);
  const int kr1 = (int)min((long long)kr0 + rows, (long long)K);
  const int c0 = kr0 / bk;
  const int slabs = kr1 > kr0 ? (kr1 - 1) / bk - c0 + 1 : 0;
  const int chunks = (K + bk - 1) / bk;
  const int per_rank = min(chunks, (rows - 1) / bk + 2);
  const int per = (MR * TN + ranks - 1) / ranks;   // outputs a rank owns
  const float sx = *sx_p, sw = *sw_p;
  const Quantizer qx(sx, lim), qw(sw, lim);

  // a cursor over the groups of U rows a thread takes, sub-slab by
  // sub-slab (sub-slab s: this rank's rows inside chunk c0 + s)
  struct Cursor { int s, g, s0, s1, groups; };
  auto open = [&](Cursor& c, int sl) {
    c.s = sl;
    c.g = 0;
    c.groups = 0;
    if (sl < slabs) {
      const long long cb = (long long)(c0 + sl) * bk;
      c.s0 = (int)max((long long)kr0, cb);
      c.s1 = (int)min((long long)kr1, cb + bk);
      c.groups = (c.s1 - c.s0 + RS * U - 1) / (RS * U);
    }
  };
  auto advance = [&](Cursor& c) {
    if (++c.g >= c.groups) open(c, c.s + 1);
  };
  // copy the cursor's group of w into ring stage st (zeros past its rows
  // and columns); one commit group a call, empty past the last group
  auto issue = [&](const Cursor& c, int st) {
    if (c.s < slabs) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = c.s0 + slot + RS * (c.g * U + u);
        float* dst = reinterpret_cast<float*>(ring + (st * U + u) * kThreads +
                                              tid);
        const float* src = w + (size_t)k * N + gn;
        if constexpr (VEC) {
          const bool ok = k < c.s1 && gn < N;
          cp_async(dst, ok ? src : w, 16, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = k < c.s1 && gn + j < N;
            cp_async(dst + j, ok ? src + j : w, 4, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

  // the x slab, quantized once into xs: its first XB rows' loads go out
  // before the ring's, the ring fills while they are quantized
  constexpr int XB = 4;
  float xv[XB][MR];
  auto x_load = [&](int kb) {
#pragma unroll
    for (int j = 0; j < XB; ++j) {
      const int kl = kb + tid + j * kThreads, gk = kr0 + kl;
#pragma unroll
      for (int m = 0; m < MR; ++m)
        xv[j][m] = (m < mr && kl < rows && gk < kr1)
                       ? __ldg(x + (size_t)(m0 + m) * K + gk) : 0.0f;
    }
  };
  auto x_store = [&](int kb, auto fast) {
#pragma unroll
    for (int j = 0; j < XB; ++j) {
      const int kl = kb + tid + j * kThreads;
      if (kl < rows) {
#pragma unroll
        for (int m = 0; m < MR; ++m)
          xs[kl * MR + m] = qx.code<decltype(fast)::value>(xv[j][m]);
      }
    }
  };
  x_load(0);
  Cursor in, use;
  open(in, 0);
  open(use, 0);
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    issue(in, st);
    if (in.s < slabs) advance(in);
  }
  // the noise of this rank's outputs, drawn while the loads fly
  float* eps = inbox + (size_t)ranks * per_rank * per;   // [per]
  for (int o = tid; o < per; o += kThreads) {
    const int e = rank * per + o, m = e / TN, nn = e - m * TN;
    if (m < mr && n0 + nn < N)
      eps[o] = noise(m0 + m, n0 + nn, bm, bn, seed, mu_k, sig_k);
  }
  auto x_slab = [&](auto fast) {
    for (int kb = 0; kb < rows; kb += XB * kThreads) {
      if (kb > 0) x_load(kb);
      x_store(kb, fast);
    }
  };
  if (qx.fast)
    x_slab(std::true_type{});
  else
    x_slab(std::false_type{});
  __syncthreads();

  auto stream = [&](auto fast) {
  int st = 0;
  for (int s = 0; s < slabs; ++s) {
    float acc[MR][4];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.0f;
    for (int g = 0; g < use.groups; ++g) {
      issue(in, (st + S - 1) % S);
      if (in.s < slabs) advance(in);
      cp_async_wait<S - 1>();          // this thread's group st has landed
      const int base = use.s0 + slot + RS * g * U;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // a row past the sub-slab was copied as zeros: its codes are 0
        // and it reads the slab's last x row (a NaN there is its row's)
        const int kl = min(base + RS * u - kr0, rows - 1);
        const float4 c = qw.code4<decltype(fast)::value>(
            ring[(st * U + u) * kThreads + tid]);
        const float q[4] = {c.x, c.y, c.z, c.w};
        const float* xr = xs + (size_t)kl * MR;
        float a[MR];
        if constexpr (MR % 4 == 0) {
#pragma unroll
          for (int m = 0; m < MR; m += 4) {
            const float4 t = *reinterpret_cast<const float4*>(xr + m);
            a[m] = t.x;
            a[m + 1] = t.y;
            a[m + 2] = t.z;
            a[m + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int m = 0; m < MR; ++m) a[m] = xr[m];
        }
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(a[m], q[j], acc[m][j]);
      }
      st = (st + 1) % S;
    }
    open(use, s + 1);
    // this sub-slab's partial: the warp's row slots (butterfly), then the
    // warps in order; pushed into the inbox of the rank owning the output
    if constexpr (LPR < 32) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int off = LPR; off < 32; off <<= 1)
            acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
    }
    if (lane < LPR) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
        if (m < mr)
          *reinterpret_cast<float4*>(red + (warp * MR + m) * TN + 4 * col) =
              make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
    __syncthreads();
    if (s == 0) cluster_wait();     // every rank has started: the prologue hid it
    for (int e = tid; e < mr * TN; e += kThreads) {
      const int m = e / TN, nn = e - m * TN;
      float v = red[m * TN + nn];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) v += red[(i * MR + m) * TN + nn];
      const int owner = e / per;
      st_cluster(inbox + (rank * per_rank + s) * per + (e - owner * per),
                 owner, v);
    }
    __syncthreads();
  }
  };
  if (qw.fast)
    stream(std::true_type{});
  else
    stream(std::false_type{});
  if (slabs == 0) cluster_wait();   // the entry arrive's phase, all the same
  // each rank's first chunk and sub-slab count, for the fold below
  if (tid < ranks) {
    const int lo = (int)min((long long)tid * rows, (long long)K);
    const int hi = (int)min((long long)lo + rows, (long long)K);
    rank_c0[tid] = lo / bk;
    rank_n[tid] = hi > lo ? (hi - 1) / bk - lo / bk + 1 : 0;
  }

  // every rank's partials for this rank's outputs are in its inbox.  The
  // (rank, sub-slab) pairs in rank order are the chunks in K order, each
  // chunk's ranks in order: one pass forms each chunk's partial and adds
  // it on when the chunk changes.  Nothing remote is touched after this
  // barrier, so no rank waits on another to leave.
  cluster.sync();
  const float scale = __fmul_rn(sx, sw);
  for (int o = tid; o < per; o += kThreads) {
    const int e = rank * per + o, m = e / TN, nn = e - m * TN;
    if (m >= mr || n0 + nn >= N) continue;
    float acc = 0.0f, p = 0.0f;
    int cur = -1;
    for (int r = 0; r < ranks; ++r) {
      const int n_r = rank_n[r];
      for (int cl = 0; cl < n_r; ++cl) {
        const int c = rank_c0[r] + cl;
        if (c != cur) {
          if (cur >= 0) acc = __fadd_rn(acc, p);
          p = 0.0f;
          cur = c;
        }
        p += inbox[(r * per_rank + cl) * per + o];
      }
    }
    acc = __fadd_rn(acc, p);
    out[(size_t)(m0 + m) * N + n0 + nn] =
        __fmul_rn(__fadd_rn(acc, eps[o]), scale);
  }
}

// ------------------------------------------------------------- tiled route
constexpr int kTM = 128, kTN = 64, kTK = 64;   // block tile
constexpr int kPlane = kTK + 16;     // bytes per row of a code plane
constexpr int kRawX = kTK + 4;       // floats per row of the raw x stage
constexpr int kRawW = kTN + 4;       // floats per row of the raw w stage
constexpr int kMaxChunk = 32768;     // rows an int32 accumulator holds
// shared memory of the tiled route: raw stages, code planes, NaN flags,
// then, split over ranks, the inbox of chunk partials
constexpr size_t kTiledBase =
    sizeof(float) * (2 * kTM * kRawX + 2 * kTK * kRawW) +
    2 * (kTM + kTN) * kPlane + sizeof(int) * (kTM + kTN);
__host__ __device__ constexpr int tiled_per(int ranks) {
  return (kTM * kTN + ranks - 1) / ranks;
}
__host__ __device__ constexpr size_t tiled_smem(int chunks, int ranks) {
  return kTiledBase +
         sizeof(float) * (ranks > 1 ? (size_t)chunks * tiled_per(ranks) : 0);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

#define QM_MMA(NAME, AT, BT)                                                 \
  __device__ __forceinline__ void NAME(int (&d)[4], const unsigned (&a)[4], \
                                       const unsigned (&b)[2]) {            \
    asm("mma.sync.aligned.m16n8k32.row.col.s32." AT "." BT                   \
        ".s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"       \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                     \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),             \
          "r"(b[1]));                                                        \
  }
QM_MMA(mma_ss, "s8", "s8")
QM_MMA(mma_su, "s8", "u8")
QM_MMA(mma_us, "u8", "s8")
QM_MMA(mma_uu, "u8", "u8")
#undef QM_MMA

// four codes split into their high and low bytes (q = 256 hi + lo: byte 1
// and byte 0 of the int32 code); true if a code of an element whose bit
// is set in `ok` was NaN.  A NaN code converts to 0.
template <bool FAST>
__device__ __forceinline__ bool split4(float4 v, unsigned ok,
                                       const Quantizer& qz, unsigned& hi,
                                       unsigned& lo) {
  const float4 c = qz.code4<FAST>(v);
  const int c0 = (int)c.x, c1 = (int)c.y, c2 = (int)c.z, c3 = (int)c.w;
  lo = __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                   0x5410);
  hi = __byte_perm(__byte_perm(c0, c1, 0x0051), __byte_perm(c2, c3, 0x0051),
                   0x5410);
  return ((ok & 1u) && c.x != c.x) || ((ok & 2u) && c.y != c.y) ||
         ((ok & 4u) && c.z != c.z) || ((ok & 8u) && c.w != c.w);
}

// the valid-element mask of a float4 at rows [k, k + 4) below k1
__device__ __forceinline__ unsigned valid4(int k, int k1) {
  const int left = k1 - k;
  return left >= 4 ? 0xFu : (left > 0 ? (1u << left) - 1u : 0u);
}

// grid (ranks, ceil(N / 64), ceil(M / 128)), cluster (ranks, 1, 1), 256
// threads, tiled_smem bytes.  Rank r takes the whole chunks [r C / ranks,
// (r + 1) C / ranks) of the C chunks; with more than one rank each chunk
// partial goes to the rank that owns its output element, which adds them
// in K order (its inbox holds every chunk's partial of its elements).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
qm_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ sx_p,
                const float* __restrict__ sw_p, float* __restrict__ out,
                int M, int K, int N, int bk, float lim, int bm, int bn,
                uint32_t seed, float mu_k, float sig_k) {
  extern __shared__ float4 qm_smem[];
  float* raw_x = reinterpret_cast<float*>(qm_smem);   // [2][kTM][kRawX]
  float* raw_w = raw_x + 2 * kTM * kRawX;             // [2][kTK][kRawW]
  unsigned char* xh = reinterpret_cast<unsigned char*>(raw_w + 2 * kTK * kRawW);
  unsigned char* xl = xh + kTM * kPlane;              // [kTM][kPlane]
  unsigned char* wh = xl + kTM * kPlane;              // [kTN][kPlane]
  unsigned char* wl = wh + kTN * kPlane;
  int* nan_row = reinterpret_cast<int*>(wl + kTN * kPlane);
  int* nan_col = nan_row + kTM;
  float* inbox = reinterpret_cast<float*>(nan_col + kTN);   // [C][per]

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;   // warp tile 32 x 32
  const int rank = blockIdx.x, ranks = gridDim.x;
  const int n0 = blockIdx.y * kTN, m0 = blockIdx.z * kTM;
  const int per = tiled_per(ranks);
  const float sx = *sx_p, sw = *sw_p;
  const Quantizer qx(sx, lim), qw(sw, lim);
  for (int i = tid; i < kTM + kTN; i += kThreads) nan_row[i] = 0;
  if (ranks > 1) cluster.sync();   // no rank flags another's before it is zeroed

  const int chunks = (K + bk - 1) / bk;
  const int per_chunk = (bk + kTK - 1) / kTK;
  const int last = K - (chunks - 1) * bk;
  const int ca = (int)((long long)rank * chunks / ranks);
  const int cz = (int)((long long)(rank + 1) * chunks / ranks);
  const int stages = cz <= ca ? 0
      : (cz == chunks ? (cz - 1 - ca) * per_chunk + (last + kTK - 1) / kTK
                      : (cz - ca) * per_chunk);
  // stage s: rows [k0, k1) of chunk c, which starts at cb and ends at ce
  auto stage = [&](int s, int& k0, int& k1, long long& cb, long long& ce) {
    const int c = min(ca + s / per_chunk, cz - 1);
    cb = (long long)c * bk;
    ce = min(cb + bk, (long long)K);
    k0 = (int)(cb + (long long)(s - (c - ca) * per_chunk) * kTK);
    k1 = (int)min((long long)k0 + kTK, ce);
  };
  auto issue = [&](int s, int b) {
    int k0, k1;
    long long cb, ce;
    stage(s, k0, k1, cb, ce);
    float* rx = raw_x + b * kTM * kRawX;
    float* rw = raw_w + b * kTK * kRawW;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < kTM * kTK / 4 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / (kTK / 4), q = i % (kTK / 4);
        const int gm = m0 + r, gk = k0 + 4 * q;
        const bool ok = gm < M && gk < k1;
        cp_async(rx + r * kRawX + 4 * q, ok ? x + (size_t)gm * K + gk : x,
                 16, ok);
      }
#pragma unroll
      for (int j = 0; j < kTK * kTN / 4 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / (kTN / 4), q = i % (kTN / 4);
        const int gk = k0 + r, gn = n0 + 4 * q;
        const bool ok = gk < k1 && gn < N;
        cp_async(rw + r * kRawW + 4 * q, ok ? w + (size_t)gk * N + gn : w,
                 16, ok);
      }
    } else {
#pragma unroll 8
      for (int j = 0; j < kTM * kTK / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / kTK, q = i % kTK;
        const int gm = m0 + r, gk = k0 + q;
        const bool ok = gm < M && gk < k1;
        cp_async(rx + r * kRawX + q, ok ? x + (size_t)gm * K + gk : x, 4,
                 ok);
      }
#pragma unroll 8
      for (int j = 0; j < kTK * kTN / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int r = i / kTN, q = i % kTN;
        const int gk = k0 + r, gn = n0 + q;
        const bool ok = gk < k1 && gn < N;
        cp_async(rw + r * kRawW + q, ok ? w + (size_t)gk * N + gn : w, 4,
                 ok);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4];
  int hh[2][4][4], md[2][4][4], ll[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][j][r] = 0.0f;
        hh[i][j][r] = md[i][j][r] = ll[i][j][r] = 0;
      }

  if (stages > 0) issue(0, 0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      issue(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int k0, k1;
    long long cb, ce;
    stage(s, k0, k1, cb, ce);
    // quantize and split the stage into the code planes
    const float* rx = raw_x + (s & 1) * kTM * kRawX;
    const float* rw = raw_w + (s & 1) * kTK * kRawW;
    auto planes = [&](auto fast) {
    // fast: a padding element (a copied zero) is code 0, never NaN, so
    // nothing is masked and no element branches; else the mask keeps a
    // padding element's 0 / 0 out of the NaN flags
    constexpr bool F = decltype(fast)::value;
#pragma unroll
    for (int j = 0; j < kTM * kTK / 4 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kTK / 4), q = i % (kTK / 4);
      const unsigned ok =
          F ? 0xFu : (m0 + r < M ? valid4(k0 + 4 * q, k1) : 0u);
      const float4 v =
          *reinterpret_cast<const float4*>(rx + r * kRawX + 4 * q);
      unsigned hi, lo;
      if (split4<F>(v, ok, qx, hi, lo)) nan_row[r] = 1;
      *reinterpret_cast<unsigned*>(xh + r * kPlane + 4 * q) = hi;
      *reinterpret_cast<unsigned*>(xl + r * kPlane + 4 * q) = lo;
    }
#pragma unroll
    for (int j = 0; j < kTN * kTK / 4 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int nn = i % kTN, q = i / kTN;
      const unsigned ok =
          F ? 0xFu : (n0 + nn < N ? valid4(k0 + 4 * q, k1) : 0u);
      const float* p = rw + 4 * q * kRawW + nn;
      const float4 v =
          make_float4(p[0], p[kRawW], p[2 * kRawW], p[3 * kRawW]);
      unsigned hi, lo;
      if (split4<F>(v, ok, qw, hi, lo)) nan_col[nn] = 1;
      *reinterpret_cast<unsigned*>(wh + nn * kPlane + 4 * q) = hi;
      *reinterpret_cast<unsigned*>(wl + nn * kPlane + 4 * q) = lo;
    }
    };
    if (qx.fast && qw.fast)
      planes(std::true_type{});
    else
      planes(std::false_type{});
    __syncthreads();
    // the four byte products over the stage's 64 rows
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 32) {
      unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16 + (lane & 15);
        const int off = row * kPlane + kk + (lane >> 4) * 16;
        ldsm_x4(ah[i], xh + off);
        ldsm_x4(al[i], xl + off);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int row = wn * 32 + jp * 16 + ((lane >> 4) << 3) + (lane & 7);
        const int off = row * kPlane + kk + ((lane >> 3) & 1) * 16;
        unsigned t[4];
        ldsm_x4(t, wh + off);
        bh[2 * jp][0] = t[0];
        bh[2 * jp][1] = t[1];
        bh[2 * jp + 1][0] = t[2];
        bh[2 * jp + 1][1] = t[3];
        ldsm_x4(t, wl + off);
        bl[2 * jp][0] = t[0];
        bl[2 * jp][1] = t[1];
        bl[2 * jp + 1][0] = t[2];
        bl[2 * jp + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_ss(hh[i][j], ah[i], bh[j]);
          mma_su(md[i][j], ah[i], bl[j]);
          mma_us(md[i][j], al[i], bh[j]);
          mma_uu(ll[i][j], al[i], bl[j]);
        }
    }
    // a chunk's end: its exact partial, rounded once
    if (k1 == ce) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const long long exact = (long long)hh[i][j][r] * 65536 +
                                    (long long)md[i][j][r] * 256 +
                                    (long long)ll[i][j][r];
            const float p = __ll2float_rn(exact);
            if (ranks == 1) {
              acc[i][j][r] = __fadd_rn(acc[i][j][r], p);
            } else {
              const int e = (wm * 32 + i * 16 + (lane >> 2) + (r >> 1) * 8) *
                                kTN + wn * 32 + j * 8 + (lane & 3) * 2 + (r & 1);
              const int owner = e / per;
              st_cluster(inbox + (size_t)(cb / bk) * per + (e - owner * per),
                         owner, p);
            }
            hh[i][j][r] = md[i][j][r] = ll[i][j][r] = 0;
          }
    }
  }

  const float scale = __fmul_rn(sx, sw);
  if (ranks == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int rm = wm * 32 + i * 16 + (lane >> 2) + (r >> 1) * 8;
          const int cn = wn * 32 + j * 8 + (lane & 3) * 2 + (r & 1);
          const int gm = m0 + rm, gn = n0 + cn;
          if (gm < M && gn < N) {
            float v = acc[i][j][r];
            if (nan_row[rm] | nan_col[cn]) v = __int_as_float(0x7fffffff);
            out[(size_t)gm * N + gn] =
                finish(v, gm, gn, bm, bn, seed, mu_k, sig_k, scale);
          }
        }
    return;
  }
  // every rank's NaN flags into every rank's, then the owners add their
  // elements' chunk partials in K order
  for (int i = tid; i < kTM + kTN; i += kThreads)
    if (nan_row[i])
      for (int q = 0; q < ranks; ++q)
        st_cluster(reinterpret_cast<float*>(nan_row + i), q,
                   __int_as_float(1));
  cluster.sync();
  for (int o = tid; o < per; o += kThreads) {
    const int e = rank * per + o;
    const int rm = e / kTN, cn = e - rm * kTN;
    const int gm = m0 + rm, gn = n0 + cn;
    if (e >= kTM * kTN || gm >= M || gn >= N) continue;
    float v = 0.0f;
    for (int c = 0; c < chunks; ++c) v = __fadd_rn(v, inbox[(size_t)c * per + o]);
    if (nan_row[rm] | nan_col[cn]) v = __int_as_float(0x7fffffff);
    out[(size_t)gm * N + gn] =
        finish(v, gm, gn, bm, bn, seed, mu_k, sig_k, scale);
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

// For each divisor s[j] (blockIdx.y) and every dividend significand v in
// [1, 2) and its negative: counts where Quantizer::quotient is not
// __fdiv_rn bit for bit, or s is outside the fast range.
__global__ void __launch_bounds__(kThreads)
qm_quotient_check_kernel(const float* __restrict__ s,
                         unsigned long long* __restrict__ bad) {
  const Quantizer qz(s[blockIdx.y], 32768.0f);
  unsigned miss = 0;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < (1u << 24);
       i += gridDim.x * blockDim.x) {
    const float v = __uint_as_float(0x3f800000u | (i & 0x7FFFFFu) |
                                    ((i >> 23) << 31));
    miss += (!qz.fast || __float_as_uint(qz.quotient(v)) !=
                             __float_as_uint(__fdiv_rn(v, qz.s))) ? 1u : 0u;
  }
  miss = __reduce_add_sync(0xffffffffu, miss);
  if ((threadIdx.x & 31) == 0 && miss)
    atomicAdd(bad, (unsigned long long)miss);
}

// The kernel's codes of v (n values) at scale *s: Quantizer::code.
__global__ void __launch_bounds__(kThreads)
qm_codes_kernel(const float* __restrict__ v, const float* __restrict__ s,
                float* __restrict__ out, size_t n, float lim) {
  const Quantizer qz(*s, lim);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = qz.fast ? qz.code<true>(v[i]) : qz.code<false>(v[i]);
}

int elementwise_blocks(size_t total) {
  size_t blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 65535 ? (blocks > 0 ? blocks : 1) : 65535);
}

// Raise a kernel's dynamic shared memory limit once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  // 220 KB: the plans' budgets (200 KB decode, tiled_smem) below
  // the 227 KB a block may hold, with room for static shared memory
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             220 * 1024);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <int MR, int TN, bool VEC>
cudaError_t launch_decode(const float* x, const float* w, const float* sx,
                          const float* sw, float* out, int M, int K, int N,
                          int bk, int rows, int ranks, float lim, int bm,
                          int bn, uint32_t seed, float mu_k, float sig_k,
                          cudaStream_t st) {
  static unsigned done = 0;
  auto kernel = qm_decode_kernel<MR, TN, VEC>;
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return err;
  const int chunks = (K + bk - 1) / bk;
  const int per_rank = min(chunks, (rows - 1) / bk + 2);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (N + TN - 1) / TN, (M + MR - 1) / MR);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      sizeof(float) * decode_smem_floats(rows, MR, TN, ranks, per_rank);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, w, sx, sw, out, M, K, N, bk,
                            rows, lim, bm, bn, seed, mu_k, sig_k);
}

template <int MR>
cudaError_t decode_by_tile(int tn, bool vec, const float* x, const float* w,
                           const float* sx, const float* sw, float* out,
                           int M, int K, int N, int bk, int rows, int ranks,
                           float lim, int bm, int bn, uint32_t seed,
                           float mu_k, float sig_k, cudaStream_t st) {
  if (tn == 128)
    return vec ? launch_decode<MR, 128, true>(x, w, sx, sw, out, M, K, N, bk,
                                              rows, ranks, lim, bm, bn, seed,
                                              mu_k, sig_k, st)
               : launch_decode<MR, 128, false>(x, w, sx, sw, out, M, K, N,
                                               bk, rows, ranks, lim, bm, bn,
                                               seed, mu_k, sig_k, st);
  if (tn == 64)
    return vec ? launch_decode<MR, 64, true>(x, w, sx, sw, out, M, K, N, bk,
                                             rows, ranks, lim, bm, bn, seed,
                                             mu_k, sig_k, st)
               : launch_decode<MR, 64, false>(x, w, sx, sw, out, M, K, N, bk,
                                              rows, ranks, lim, bm, bn, seed,
                                              mu_k, sig_k, st);
  if (tn == 32)
    return vec ? launch_decode<MR, 32, true>(x, w, sx, sw, out, M, K, N, bk,
                                             rows, ranks, lim, bm, bn, seed,
                                             mu_k, sig_k, st)
               : launch_decode<MR, 32, false>(x, w, sx, sw, out, M, K, N, bk,
                                              rows, ranks, lim, bm, bn, seed,
                                              mu_k, sig_k, st);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  out: (M, N) f32.  M, K, N >= 1;
// 1 <= bk <= K, and bk <= 32,768 on the tiled route; 1 <= bm, bn.  route 0 is the decode route with `ranks`
// blocks of `rows` rows each per cluster and tiles of `tn` (32, 64 or 128)
// columns; route 1 the tiled route with `ranks` blocks per cluster (tn,
// rows unused).
int quant_matmul_launch(const float* x, const float* w, const float* sx,
                        const float* sw, float* out, int M, int K, int N,
                        int wl, int bm, int bk, int bn, unsigned int seed,
                        float mu_k, float sig_k, int route, int ranks, int tn,
                        int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float lim = (float)(1 << (wl - 1));
  cudaError_t err;
  if (route == 0) {
    if (ranks < 1 || ranks > 8 || rows < 1 || rows % 8 != 0 ||
        (long long)ranks * rows < K)
      return (int)cudaErrorInvalidValue;
    const bool vec = N % 4 == 0 && aligned16(w);
    const int mr = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16;
    switch (mr) {
      case 1: err = decode_by_tile<1>(tn, vec, x, w, sx, sw, out, M, K, N, bk, rows, ranks, lim, bm, bn, seed, mu_k, sig_k, st); break;
      case 2: err = decode_by_tile<2>(tn, vec, x, w, sx, sw, out, M, K, N, bk, rows, ranks, lim, bm, bn, seed, mu_k, sig_k, st); break;
      case 4: err = decode_by_tile<4>(tn, vec, x, w, sx, sw, out, M, K, N, bk, rows, ranks, lim, bm, bn, seed, mu_k, sig_k, st); break;
      case 8: err = decode_by_tile<8>(tn, vec, x, w, sx, sw, out, M, K, N, bk, rows, ranks, lim, bm, bn, seed, mu_k, sig_k, st); break;
      default: err = decode_by_tile<16>(tn, vec, x, w, sx, sw, out, M, K, N, bk, rows, ranks, lim, bm, bn, seed, mu_k, sig_k, st); break;
    }
  } else {
    static unsigned done[2] = {0, 0};
    const bool vec = K % 4 == 0 && N % 4 == 0 && bk % 4 == 0 &&
                     aligned16(x) && aligned16(w);
    auto kernel = vec ? qm_tiled_kernel<true> : qm_tiled_kernel<false>;
    const int chunks = (K + bk - 1) / bk;
    if (ranks < 1 || ranks > 8 || ranks > chunks || bk > kMaxChunk ||
        tiled_smem(chunks, ranks) > 220 * 1024)
      return (int)cudaErrorInvalidValue;
    err = allow_smem(kernel, done[vec]);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ranks, (N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = tiled_smem(chunks, ranks);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, x, w, sx, sw, out, M, K, N, bk,
                             lim, bm, bn, seed, mu_k, sig_k);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
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

// Mismatches of the fast quotient against __fdiv_rn over every dividend
// significand (both signs) for each of the n divisors s (in [2^-38,
// 2^38]); bad: one zeroed unsigned long long.
int qm_quotient_check_launch(const float* s, int n, unsigned long long* bad,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qm_quotient_check_kernel<<<dim3(256, n), kThreads, 0, st>>>(s, bad);
  return (int)cudaGetLastError();
}

// The kernel's quantizer on n values: out = clip(rint(v / *s), -2^(wl-1),
// 2^(wl-1) - 1).
int qm_codes_launch(const float* v, const float* s, float* out, long long n,
                    int wl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qm_codes_kernel<<<elementwise_blocks((size_t)n), kThreads, 0, st>>>(
      v, s, out, (size_t)n, (float)(1 << (wl - 1)));
  return (int)cudaGetLastError();
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
