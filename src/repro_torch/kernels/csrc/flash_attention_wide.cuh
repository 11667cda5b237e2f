// Flash attention for Hopper (sm_90a) at head dims 80 and 128 (zamba2-2.7b;
// grok-1-314b, llama3.2-3b, yi-34b, qwen1.5-110b, chameleon-34b): the
// kernels, their launch helpers and the entry points' bodies, instantiated
// by flash_attention_wide.cu.  They compute what flash_attention.cuh's
// kernels compute (its header: the functions, dead tiles, the schedule,
// float semantics, residuals), with a design of their own for these widths.
//
//   flash_attention      (ROADMAP B4, replaces repro/kernels/
//                        flash_attention.py _attn_kernel)
//   flash_attention_amm  (ROADMAP B3, replaces _attn_amm_kernel with its
//                        tile body _amm_tile_step)
//
// Each has two routes, chosen on the host by a pure function of the call
// (kernels/flash_attention.py: flash_exact_route, flash_amm_route) and
// counted apart; neither falls back to the other.
//
// The exact kernel.  A block of two warpgroups (8 warps, one block an SM:
// 225 KiB of shared memory at D = 128, 141 KiB at D = 80; at most 197
// registers a thread, no spills) owns 128 query rows, 64 a warpgroup, and
// walks 32-key tiles.  Both products run on wgmma (tf32, f32
// accumulators), whose B operand is read from shared memory once for a
// warpgroup's 64 rows; mma.sync m16n8k8 reads it once for 16, and a design
// on it (16 warps in pairs splitting D) took shared memory's bandwidth and
// ran no faster.  wgmma takes tf32 operands K-major only, so the block
// holds every operand as split planes in its layout (core matrices of 8
// rows by 4 k, mma_bytes.cuh's byte planes with 4-byte elements): Q's
// high and low parts, split once per block; K's, split once per tile; and
// V^T's, which the same pass writes from the tile's rows.  The tile's K and
// V rows arrive by cp.async, the pass splits each value once (a thread
// four consecutive words of a plane, 16-byte stores: the pass is on the
// tile's critical path, and word by word it took a third of the kernel's
// time), and the next tile's copy runs under the products.  The score product: per
// 8-deep step three wgmma m64n32k8 (Q lo K hi, Q hi K lo, Q hi K hi, A and
// B from shared memory) into one accumulator, drained into f32 registers,
// three steps in flight.  P stays in the score accumulator's registers
// (lane (g, t) of a warp holds keys 8 n + 2 t and 8 n + 2 t + 1 of each
// 8-key tile n, the layout of mma.sync m16n8k8), which P V takes as its A
// fragments in place: slot t of 8-key step n is key 8 n + 2 t and slot t +
// 4 key 8 n + 2 t + 1, and the split pass writes V^T's k in that order.
// Route "tf32" (from PV_3XTF32_MIN_SKV = 26 keys on): P V in 3xTF32, per
// step and column part (64 columns twice at D = 128, 80 at D = 80) three
// wgmma m64nNk8 (P's parts from registers, V^T's planes B), each group
// drained into the rescaled accumulator while the next runs.  Route
// "ffma" (below 26 keys): P V with FFMA, keys in order onto the rescaled
// accumulator, P's values brought from their lane by a shuffle.  A
// warpgroup whose 64 rows all lie before a tile's first key (causal)
// skips the tile (p = 0, alpha = 1 for each of its rows), and the rescale
// is skipped where no row's max moved (alpha = 1).  The tensor cores
// multiply and accumulate as mma.sync does (Fasi et al.'s model below).
//
// Error model of P V in 3xTF32 (u = 2^-24, the score product's model in
// flash_attention.cuh; V = max|v|, terms p_j v_j with sum_j p_j = l):
// the split of p and v leaves each term within 12.006 u |p_j v_j|; a step
// of 8 terms is within 16.03 u of its largest term plus 2 u of its sum;
// the steps drain into the accumulator, which rounds ceil(Skv / 8) - 1
// times (the first add into 0 is exact), and the accumulator's rescale
// rounds once a tile after the first (ceil(Skv / 32) - 1 times).  So the
// numerator is within (30.04 + ceil(Skv/8) + ceil(Skv/32) - 2) u V l, 33.04
// u V l at Skv = 26 and below (Skv + 8) u V l, flash_tolerance's sum term,
// for every Skv >= 26; the denominator is summed in f32 as before.  The
// score product: as at D <= 64 (flash_attention.cuh), each 8-deep step
// drained into f32, d/8 - 1 rounding drains: 26.04 u S at d = 80, 32.04 u
// S at d = 128 (S = d A K), inside the score term (d + 2) u S of
// flash_tolerance (82, 130).  Below 26 keys FFMA P V keeps the sum
// term's own error.
//
// The amm kernel, route "mma" (bbm_dot_route's "mma": every chunk at least
// one tensor-core step deep, x's and bq's bytes in two significances).  A
// block of 256 threads owns the 128 x 128 quantization tile as before.  Its
// integer products run on the int8 tensor cores in the contracted form of
// bbm_mma.cuh (34 byte products a code product at wl 16 / vbl 13 kind 0,
// 21 at kind 1), through bbm_wgmma.cuh's pieces: per 32-deep slab the
// block decodes the multiplier's planes once (column_planes: K's for the
// score product, a 64-key half at a time; V's for P V, 64 columns at a
// time at D = 128, all 80 at D = 80), and each warpgroup runs wgmma on the
// multiplicand's codes, Q's or P's (warp_slab_n: each warp 16 rows, the x
// bytes formed once).  Every operating point of the route has chunks of
// at least 511 products (amm_chunk_len), more than a tile's product sums
// (D or bk <= 128; the launcher refuses a shorter chunk): each product is
// one chunk, its int32 pair lo + 256 hi (exact modulo 2^32) flushed to
// f32 once, as the CUDA-core products flush theirs, so the approximate
// score and P V products, P's codes and scales and every residual keep
// their bits.  The two float products stay f32 FFMA in the 8 x 8 layout of
// flash_attention.cuh's kernel, Q, K and V streamed in 32-wide slices, and
// meet the integer products in shared memory: the combined scores in P's
// buffer, the descaled P V products in the planes' space.  Shared memory:
// P (f32), P's codes, the rows' max, sum and rescale, and one region the
// phases share (two stages of each stream, the planes): 188 KiB at D = 128
// and 203 KiB at D = 80 (kind 0, wl 16 / vbl 13).
//
// The amm kernel, route "tile" (the rest): flash_amm_kernel's CUDA-core
// body, integer products on bbm_dot.cuh, K and V streamed through one
// buffer (at D = 128 in four slices each).
//
// Bounds on this card (chip_smoke.py: flash_bound_ms), over the live
// (query, key) pairs.  The exact function from 26 keys on: 12 pairs d TF32
// operations at 495 TFLOP/s (0.0782 ms at grok-1's (4, 48, 512, 128)
// causal).  The amm function on the "mma" route: 2 pairs d code products
// of 34 byte products, 2 operations each, at 1,979 TOP/s (0.2218 ms at
// that shape), beside its two f32 FFMA products, 4 pairs d operations at
// 67 TFLOP/s (0.1927 ms); on the "tile" route its int32 instructions (1 +
// 3 R a code product) over the int32 rate.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bbm_wgmma.cuh"
#include "flash_attention.cuh"

namespace {

// ----------------------------------------------------- exact (B4), wide
constexpr int kWgThreads = 256;   // two warpgroups
constexpr int kWgBM = 128;        // query rows per block: 64 a warpgroup
constexpr int kWgBN = 32;         // keys per tile

// d (+)= A B, wgmma m64n32k8 tf32: A (64 x 8) and B (8 x 32) from
// shared-memory descriptors, f32 accumulators (16 a thread); acc 0 writes
// A B, else adds it.
__device__ __forceinline__ void wgmma_tf32_ss32(float (&d)[16], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A B, wgmma m64n64k8 tf32: A from registers (each warp's 16
// rows as mma.m16n8k8's A fragment), B (8 x 64) from a shared-memory
// descriptor, f32 accumulators (32 a thread).
__device__ __forceinline__ void wgmma_tf32_rs64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (+)= A B, wgmma m64n80k8 tf32: A from registers (each warp's 16
// rows as mma.m16n8k8's A fragment), B (8 x 80) from a shared-memory
// descriptor, f32 accumulators (40 a thread).
__device__ __forceinline__ void wgmma_tf32_rs80(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers an asynchronous wgmma reads or writes (bbm_mma::hold).
template <int R>
__device__ __forceinline__ void hold_f(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A K-major TF32 plane of one 8-deep step (wgmma's layout without
// swizzle, as mma_bytes.cuh's byte planes): core matrices of 8 rows (or
// columns) n by 4 k, 16 bytes a row, the step's two k halves 128 bytes
// apart, the row groups 256 apart, so element (n, k) is word 64 (n / 8) +
// 32 (k / 4) + 4 (n % 8) + k % 4.  The n and k of word w:
__device__ __forceinline__ int kmajor_n(int w) {
  return 8 * (w >> 6) + ((w >> 2) & 7);
}
__device__ __forceinline__ int kmajor_k(int w) {
  return 4 * ((w >> 5) & 1) + (w & 3);
}

// The four values' TF32 high and low parts, as 16 bytes each at hi and lo.
__device__ __forceinline__ void store_split(uint32_t* hi, uint32_t* lo,
                                            float4 x) {
  uint4 h, l;
  split(x.x, h.x, l.x);
  split(x.y, h.y, l.y);
  split(x.z, h.z, l.z);
  split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

template <int D>
struct WgExactSmem {
  static constexpr int KS = D / 8, NT = kWgBN / 8;
  uint32_t q[KS][2][2][64 * 8];   // Q's planes: [step][hi, lo][warpgroup]
  uint32_t k[KS][2][kWgBN * 8];   // K's: [step][hi, lo], keys the columns
  uint32_t v[NT][2][D * 8];       // V^T's: [8-key step][hi, lo], P's key
                                  // order along k
  float kr[kWgBN][D + 4];         // the tile as copied
  float vr[kWgBN][D + 4];
};

// grid (ceil(Sq / 128) * BH), 256 threads; q: (BH, Sq, D), k/v: (BH,
// Skv, D), out like q.  Warpgroup w holds rows 64 w .. 64 w + 63 of the
// block, its warp i rows 16 i .. 16 i + 15 of those, lane (g, t) rows g
// and g + 8 of the warp's, the accumulator layout of mma.sync m16n8k8.
// The score product: per 8-deep step three wgmma m64n32k8 (Q lo K hi, Q
// hi K lo, Q hi K hi, A and B from the split planes in shared memory) into
// one accumulator, drained into f32 registers; P V: per 8-key step three
// wgmma m64nNk8 (N = 64 twice at D = 128, 80 at D = 80; P's split parts
// the A fragments, in registers, in the score accumulator's order, and
// V^T's planes B), drained into the rescaled accumulator.
template <int D, bool TC>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_exact_wgmma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         int BH, int Sq, int Skv, int causal, float scale) {
  using Sm = WgExactSmem<D>;
  constexpr int KS = Sm::KS, NT = Sm::NT;
  constexpr int RC = D / 4;        // 16-byte chunks per row
  constexpr int NP = D % 64 == 0 ? D / 64 : 1;   // P V's column parts
  constexpr int NW = D / NP;                      // and their width
  static_assert(NW == 64 || NW == 80, "P V parts of 64 or 80 columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wg = warp / 4;
  const int nq = (Sq + kWgBM - 1) / kWgBM;
  const int bh = blockIdx.x % BH, q0 = (nq - 1 - blockIdx.x / BH) * kWgBM;
  const float* kb = k + (size_t)bh * Skv * D;
  const float* vb = v + (size_t)bh * Skv * D;
  const int n_live = live_tiles(min(q0 + kWgBM, Sq) - 1, Skv, kWgBN, causal);

  auto load_kv = [&](int tile) {
    const int k0 = tile * kWgBN;
    for (int e = threadIdx.x; e < kWgBN * RC; e += kWgThreads) {
      const int r = e / RC, c = (e % RC) * 4;
      const bool ok = k0 + r < Skv;
      const size_t off = ok ? (size_t)(k0 + r) * D + c : 0;
      copy16(&sm.kr[r][c], kb + off, ok);
      copy16(&sm.vr[r][c], vb + off, ok);
    }
    copy_commit();
  };
  load_kv(0);
  // Q's planes, split once for the block (zero past Sq); a thread takes
  // four consecutive words of a plane (one row, four k)
  {
    const float* qr = q + (size_t)bh * Sq * D;
    for (int e = threadIdx.x; e < KS * 2 * 64 * 2; e += kWgThreads) {
      const int w = 4 * (e % (64 * 2)), wgi = (e / (64 * 2)) % 2;
      const int ks = e / (2 * 64 * 2);
      const int r = q0 + 64 * wgi + kmajor_n(w), c = 8 * ks + kmajor_k(w);
      const float4 x = r < Sq ? __ldg(reinterpret_cast<const float4*>(
                                    qr + (size_t)r * D + c))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      store_split(&sm.q[ks][0][wgi][w], &sm.q[ks][1][wgi][w], x);
    }
  }
  const int wgr = q0 + 64 * wg;              // the warpgroup's first row
  const int wr = wgr + 16 * (warp % 4);      // the warp's
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[NP][NW / 2];
#pragma unroll
  for (int h = 0; h < NP; ++h)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[h][i] = 0.0f;
  float tq[3][16], tv[2][NW / 2];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) tq[j][i] = 0.0f;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) tv[j][i] = 0.0f;

  for (int tile = 0; tile < n_live; ++tile) {
    copy_wait<0>();
    __syncthreads();               // the tile landed; the planes are free
    // the split pass: each K and V value once, into K's planes and V^T's
    // (V's keys in P's order: slot i < 4 key 2 i, slot 4 + i key 2 i + 1);
    // a thread takes four consecutive words of a plane (one row of K, four
    // k; one column of V^T, four slots), written as 16 bytes
#pragma unroll
    for (int e = threadIdx.x; e < KS * kWgBN * 2; e += kWgThreads) {
      const int w = 4 * (e % (kWgBN * 2)), ks = e / (kWgBN * 2);
      const float4 x = *reinterpret_cast<const float4*>(
          &sm.kr[kmajor_n(w)][8 * ks + kmajor_k(w)]);
      store_split(&sm.k[ks][0][w], &sm.k[ks][1][w], x);
    }
#pragma unroll
    for (int e = threadIdx.x; TC && e < NT * D * 2; e += kWgThreads) {
      const int w = 4 * (e % (D * 2)), st = e / (D * 2);
      const int c = kmajor_n(w), j = (kmajor_k(w) >> 2) + 8 * st;
      const float4 x = make_float4(sm.vr[j][c], sm.vr[j + 2][c],
                                   sm.vr[j + 4][c], sm.vr[j + 6][c]);
      store_split(&sm.v[st][0][w], &sm.v[st][1][w], x);
    }
    // the planes' generic stores, seen by wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (TC && tile + 1 < n_live) load_kv(tile + 1);   // under the products
    const int k0 = tile * kWgBN;
    // a warpgroup whose rows all lie before the tile's first key (causal)
    // or past Sq has nothing to add: p = 0, alpha = 1 for each of its rows
    if (wgr < Sq && (!causal || k0 <= wgr + 63)) {
      // three steps in flight: step ks into tq[ks % 3], drained into s (in
      // step order) once the group two steps on has been issued
      float s[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = 0.0f;
      auto drain = [&](float(&tp)[16]) {
        hold_f(tp);
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] = __fadd_rn(s[i], tp[i]);
      };
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint64_t qh = bbm_mma::plane_desc(sm.q[ks][0][wg]);
        const uint64_t ql = bbm_mma::plane_desc(sm.q[ks][1][wg]);
        const uint64_t kh = bbm_mma::plane_desc(sm.k[ks][0]);
        const uint64_t kl = bbm_mma::plane_desc(sm.k[ks][1]);
        wg_fence();
        wgmma_tf32_ss32(tq[ks % 3], ql, kh, 0);
        wgmma_tf32_ss32(tq[ks % 3], qh, kl, 1);
        wgmma_tf32_ss32(tq[ks % 3], qh, kh, 1);
        wg_commit();
        if (ks >= 2) {
          wg_wait<2>();
          drain(tq[(ks - 2) % 3]);
        }
      }
      wg_wait<1>();
      drain(tq[(KS - 2) % 3]);
      wg_wait<0>();
      drain(tq[(KS - 1) % 3]);
      // mask, online softmax; P stays in s (s[4 n + e]: key tile n)
      float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wr + g + 8 * (e >> 1);
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const bool live = col < Skv && (!causal || row >= col);
          float& x = s[4 * n + e];
          x = live ? __fmul_rn(x, scale) : kNegInf;
          rmax[e >> 1] = fmaxf(rmax[e >> 1], x);
        }
      float m_new[2], rsum[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m[h], quad_max(rmax[h]));
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s[i] = expf(__fsub_rn(s[i], m_new[(i >> 1) & 1]));
        rsum[(i >> 1) & 1] = __fadd_rn(rsum[(i >> 1) & 1], s[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        alpha[h] = expf(__fsub_rn(m[h], m_new[h]));
        l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), quad_sum(rsum[h]));
        m[h] = m_new[h];
      }
      // the rescale, where some row's max moved (else alpha = 1: exact)
      if (!__all_sync(~0u, alpha[0] == 1.0f && alpha[1] == 1.0f)) {
#pragma unroll
        for (int h = 0; h < NP; ++h)
#pragma unroll
          for (int i = 0; i < NW / 2; ++i)
            acc[h][i] = __fmul_rn(acc[h][i], alpha[(i >> 1) & 1]);
      }
      if constexpr (TC) {
        // P V, 3xTF32: per 8-key step n and column part h a group of three
        // wgmma into one of two buffers, each group drained into acc[h] (in
        // step order) while the next runs
        uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          split(s[4 * n + 0], ph[n][0], pl[n][0]);
          split(s[4 * n + 2], ph[n][1], pl[n][1]);
          split(s[4 * n + 1], ph[n][2], pl[n][2]);
          split(s[4 * n + 3], ph[n][3], pl[n][3]);
        }
        constexpr int G = NT * NP;
#pragma unroll
        for (int gi = 0; gi <= G; ++gi) {
          if (gi < G) {
            const int n = gi / NP, h = gi % NP;
            const uint64_t vh = bbm_mma::plane_desc(&sm.v[n][0][h * NW * 8]);
            const uint64_t vl = bbm_mma::plane_desc(&sm.v[n][1][h * NW * 8]);
            float(&tb)[NW / 2] = tv[gi % 2];
            wg_fence();
            if constexpr (NW == 64) {
              wgmma_tf32_rs64(tb, pl[n], vh, 0);
              wgmma_tf32_rs64(tb, ph[n], vl, 1);
              wgmma_tf32_rs64(tb, ph[n], vh, 1);
            } else {
              wgmma_tf32_rs80(tb, pl[n], vh, 0);
              wgmma_tf32_rs80(tb, ph[n], vl, 1);
              wgmma_tf32_rs80(tb, ph[n], vh, 1);
            }
            wg_commit();
          }
          if (gi > 0) {
            if (gi < G)
              wg_wait<1>();
            else
              wg_wait<0>();
            float(&tb)[NW / 2] = tv[(gi - 1) % 2];
            hold_f(tb);
            const int h = (gi - 1) % NP;
#pragma unroll
            for (int i = 0; i < NW / 2; ++i)
              acc[h][i] = __fadd_rn(acc[h][i], tb[i]);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          bbm_mma::hold(ph[n]);
          bbm_mma::hold(pl[n]);
        }
      } else {
        // P V with FFMA, the keys in order, onto the rescaled accumulator,
        // P's values brought from their lane by a shuffle
        const int quad = lane & ~3;
#pragma unroll
        for (int kk = 0; kk < kWgBN; ++kk) {
          const int src = quad | ((kk & 7) >> 1);
          const float p0 =
              __shfl_sync(~0u, s[4 * (kk / 8) + (kk & 1)], src);
          const float p1 =
              __shfl_sync(~0u, s[4 * (kk / 8) + 2 + (kk & 1)], src);
#pragma unroll
          for (int h = 0; h < NP; ++h)
#pragma unroll
            for (int j = 0; j < NW / 8; ++j) {
              const float2 vv = *reinterpret_cast<const float2*>(
                  &sm.vr[kk][h * NW + 8 * j + 2 * t]);
              acc[h][4 * j + 0] = fmaf(p0, vv.x, acc[h][4 * j + 0]);
              acc[h][4 * j + 1] = fmaf(p0, vv.y, acc[h][4 * j + 1]);
              acc[h][4 * j + 2] = fmaf(p1, vv.x, acc[h][4 * j + 2]);
              acc[h][4 * j + 3] = fmaf(p1, vv.y, acc[h][4 * j + 3]);
            }
        }
      }
    }
    if (!TC && tile + 1 < n_live) {
      __syncthreads();             // V's copy is read no more
      load_kv(tile + 1);
    }
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = wr + g + 8 * e2;
    if (row >= Sq) continue;
    const float den = fmaxf(l[e2], 1e-30f);
    float* o = out + ((size_t)bh * Sq + row) * D + 2 * t;
#pragma unroll
    for (int h = 0; h < NP; ++h)
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
        *reinterpret_cast<float2*>(o + h * NW + 8 * j) =
            make_float2(__fdiv_rn(acc[h][4 * j + 2 * e2], den),
                        __fdiv_rn(acc[h][4 * j + 2 * e2 + 1], den));
  }
}

template <int D, bool TC>
int exact_wgmma_launch(const float* q, const float* k, const float* v,
                       float* out, int BH, int Sq, int Skv, int causal,
                       float scale, cudaStream_t st) {
  const size_t smem = sizeof(WgExactSmem<D>);
  int err = launch_config(flash_exact_wgmma_kernel<D, TC>, smem);
  if (err) return err;
  const int blocks = (Sq + kWgBM - 1) / kWgBM * BH;
  flash_exact_wgmma_kernel<D, TC><<<blocks, kWgThreads, smem, st>>>(
      q, k, v, out, BH, Sq, Skv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------- amm (B3), wide, int8 tensor cores
constexpr int kAmSlab = 32;       // d (score) or keys (P V) of one slab
constexpr int kAmHalf = 64;       // keys of a score half
constexpr int kPcStride = BK + 8; // P's codes, int16: 8-byte fragment reads

template <int D>
struct WideAmm {
  // value passes of NV columns: two of 64 at D = 128, one of 80 at D = 80
  static constexpr int NV = D % 64 == 0 ? 64 : D;
  static constexpr int NP = D / NV;
  static constexpr int DS = (D + kAmSlab - 1) / kAmSlab;   // d slabs
  static constexpr int DC = D / 16;     // output columns of a thread
  static constexpr int VC = NV / 16;    // ... in one value pass
  static constexpr int FS = kAmSlab + 4;        // strides: f32 slices,
  static constexpr int CS = kAmSlab + 8;        // code slabs (int16),
  static constexpr int VFS = NV + 4;            // V's f32 slices,
  static constexpr int VCS = NV + 8;            // V's code slabs,
  static constexpr int TS = NV + 1;             // the value pass's products
  // the fixed part: P (f32, stride BK + 1), P's codes, each row's running
  // max, sum and rescale, the block's reduction slots
  static constexpr size_t kP = sizeof(float) * BQ * (BK + 1);
  static constexpr size_t kPc = sizeof(short) * BQ * kPcStride;
  static constexpr size_t kRows = sizeof(float) * (3 * BQ + kThreads / 32);
  static constexpr size_t kFixed = (kP + kPc + kRows + 127) / 128 * 128;
  // the phases' stages (two each) share one region after it
  static constexpr size_t kS1 = sizeof(float) * (BQ + kAmHalf) * FS;
  static constexpr size_t kS2 = sizeof(short) * (BQ + kAmHalf) * CS;
  static constexpr size_t kP1 = sizeof(float) * kAmSlab * VFS;
  static constexpr size_t kP2 = sizeof(short) * kAmSlab * VCS;
  static constexpr size_t kMax2 = kS2 > kP1 ? (kS2 > kP2 ? kS2 : kP2)
                                            : (kP1 > kP2 ? kP1 : kP2);
  // the planes (and, once the value products are formed, those products)
  static constexpr size_t kPlanesOff = (2 * kMax2 + 127) / 128 * 128;
  static size_t smem(int planes) {
    size_t pl = (size_t)planes * kAmSlab * (NV > kAmHalf ? NV : kAmHalf);
    const size_t t = sizeof(float) * BQ * TS;
    pl = pl > t ? pl : t;
    const size_t u = kPlanesOff + pl > 2 * kS1 ? kPlanesOff + pl : 2 * kS1;
    return kFixed + u;
  }
};

// grid (Sqp / bq * BH), 256 threads, WideAmm<D>::smem(op.planes) bytes.
// Arguments and residuals as flash_amm_kernel's.  Per live KV tile:
//   S1  the exact f32 score product of a 64-key half, FFMA in the 8 x 8
//       layout (rows ty + 16 i, columns tx + 16 j), Q and K streamed in
//       32-wide slices of d, parked in P's buffer;
//   S2  the half's Broken-Booth score product on the int8 tensor cores:
//       per 32-deep slab of d the block decodes K's planes once
//       (column_planes), and each warpgroup runs warp_slab_n<64> on Q's
//       codes (each warp 16 rows, all 64 keys) into one int32 pair lo +
//       256 hi, flushed to f32 once (the product is one chunk); then each
//       accumulator's score exact + (approx - exact) into P's buffer;
//   S3  mask, online softmax and P's quantization in the 8 x 8 layout,
//       as flash_amm_kernel does, the rows' max, sum and rescale kept in
//       shared memory;
// then per pass of NV value columns:
//   P2  the Broken-Booth P V product on the tensor cores, V's planes
//       decoded once per 32-key slab, P's codes the x side, the
//       descaled products into the planes' space;
//   P1  the exact f32 P V in the 8 x 8 layout, V streamed in 32-key
//       slices, and each output's exact + (approx - exact) added to its
//       rescaled accumulator.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_amm_mma_kernel(const float* __restrict__ qf,
                     const float* __restrict__ kf,
                     const float* __restrict__ vf,
                     const short* __restrict__ qc,
                     const short* __restrict__ kc,
                     const short* __restrict__ vc,
                     const float* __restrict__ qs,
                     const float* __restrict__ ks,
                     const float* __restrict__ vs, float* __restrict__ out,
                     float* __restrict__ s_out, float* __restrict__ pv_out,
                     short* __restrict__ pc_out, float* __restrict__ ps_out,
                     AmmArgs g, bbm_mma::Op op) {
  using W = WideAmm<D>;
  constexpr int NV = W::NV, VC = W::VC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float(*sp)[BK + 1] = reinterpret_cast<float(*)[BK + 1]>(smem_raw);
  short(*spc)[kPcStride] =
      reinterpret_cast<short(*)[kPcStride]>(smem_raw + W::kP);
  float* row_m = reinterpret_cast<float*>(smem_raw + W::kP + W::kPc);
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;
  float* red = row_a + BQ;
  unsigned char* un = smem_raw + W::kFixed;
  uint32_t* bp = reinterpret_cast<uint32_t*>(un + W::kPlanesOff);
  float* tv = reinterpret_cast<float*>(un + W::kPlanesOff);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32, gl = lane / 4, tl = lane % 4;
  const int nl = lane % 8, tq = lane / 8;
  const int nq = g.Sqp / g.bq, nk = g.Skvp / g.bk;
  const int bh = blockIdx.x % g.BH, qi = nq - 1 - blockIdx.x / g.BH;
  const int q0 = qi * g.bq;
  const size_t qbase = ((size_t)bh * g.Sqp + q0) * D;
  const size_t kvrow = (size_t)bh * g.Skvp;
  // kind 0 skips dead tiles; kind 1 computes them (flash_attention.cuh)
  const int n_live = op.kind ? nk
                             : live_tiles(q0 + g.bq - 1, g.kv_len, g.bk,
                                          g.causal);
  const float sq = qs[(size_t)bh * nq + qi];
  for (int r = tid; r < BQ; r += kThreads) {
    row_m[r] = kNegInf;
    row_l[r] = 0.0f;
  }
  float acc[8][W::DC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < W::DC; ++c) acc[i][c] = 0.0f;
  // a product's int32 pair lo + 256 hi (exact modulo 2^32: the whole
  // product is one chunk) to f32, as the CUDA-core products flush theirs
  auto to_f32 = [](int lo, int hi) {
    return __int2float_rn(static_cast<int>(static_cast<uint32_t>(lo) +
                                           (static_cast<uint32_t>(hi) << 8)));
  };
  const int n_sl = (g.bk + kAmSlab - 1) / kAmSlab;   // 32-key slabs

  for (int kv = 0; kv < n_live; ++kv) {
    const int k0 = kv * g.bk;
    const size_t kb = (kvrow + k0) * D;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      // ---- S1: the exact score product of keys 64 h .. 64 h + 63
      {
        auto load = [&](int ds, int st) {
          float* qd = reinterpret_cast<float*>(un + st * W::kS1);
          float* kd = qd + BQ * W::FS;
          const int d0 = ds * kAmSlab;
          for (int e = tid; e < BQ * kAmSlab / 4; e += kThreads) {
            const int r = e / (kAmSlab / 4), c = (e % (kAmSlab / 4)) * 4;
            const bool ok = r < g.bq && d0 + c < D;
            copy16(qd + r * W::FS + c,
                   qf + qbase + (ok ? (size_t)r * D + d0 + c : 0), ok);
          }
          for (int e = tid; e < kAmHalf * kAmSlab / 4; e += kThreads) {
            const int r = e / (kAmSlab / 4), c = (e % (kAmSlab / 4)) * 4;
            const int key = kAmHalf * h + r;
            const bool ok = key < g.bk && d0 + c < D;
            copy16(kd + r * W::FS + c,
                   kf + kb + (ok ? (size_t)key * D + d0 + c : 0), ok);
          }
          copy_commit();
        };
        float s[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
        __syncthreads();           // the stages are read no more
        load(0, 0);
        for (int ds = 0; ds < W::DS; ++ds) {
          copy_wait<0>();
          __syncthreads();         // the slab landed; the last one is free
          if (ds + 1 < W::DS) load(ds + 1, (ds + 1) & 1);
          const float* qd = reinterpret_cast<const float*>(
              un + (ds & 1) * W::kS1);
          const float* kd = qd + BQ * W::FS;
          const int dn = min(kAmSlab, D - ds * kAmSlab);
          for (int d = 0; d < dn; d += 4) {
            float4 a[8], b[4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              a[i] = *reinterpret_cast<const float4*>(
                  qd + (ty + 16 * i) * W::FS + d);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              b[j] = *reinterpret_cast<const float4*>(
                  kd + (tx + 16 * j) * W::FS + d);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
                s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
                s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
                s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
              }
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sp[ty + 16 * i][kAmHalf * h + tx + 16 * j] = s[i][j];
      }
      // ---- S2: the half's Broken-Booth score product, Q's codes against
      // K's planes (K^T the multiplier), on the tensor cores
      {
        auto load = [&](int ds, int st) {
          short* qcd = reinterpret_cast<short*>(un + st * W::kS2);
          short* kcd = qcd + BQ * W::CS;
          const int d0 = ds * kAmSlab;
          for (int e = tid; e < BQ * kAmSlab / 4; e += kThreads) {
            const int r = e / (kAmSlab / 4), c = (e % (kAmSlab / 4)) * 4;
            const bool ok = r < g.bq && d0 + c < D;
            copy8(qcd + r * W::CS + c,
                  qc + qbase + (ok ? (size_t)r * D + d0 + c : 0), ok);
          }
          for (int e = tid; e < kAmHalf * kAmSlab / 4; e += kThreads) {
            const int r = e / (kAmSlab / 4), c = (e % (kAmSlab / 4)) * 4;
            const int key = kAmHalf * h + r;
            const bool ok = key < g.bk && d0 + c < D;
            copy8(kcd + r * W::CS + c,
                  kc + kb + (ok ? (size_t)key * D + d0 + c : 0), ok);
          }
          copy_commit();
        };
        int lo[kAmHalf / 2], hi[kAmHalf / 2];
#pragma unroll
        for (int e = 0; e < kAmHalf / 2; ++e) lo[e] = hi[e] = 0;
        __syncthreads();
        load(0, 0);
        for (int ds = 0; ds < W::DS; ++ds) {
          copy_wait<0>();
          __syncthreads();         // the slab landed; the last one is free
          if (ds + 1 < W::DS) load(ds + 1, (ds + 1) & 1);
          const short* qcd = reinterpret_cast<const short*>(
              un + (ds & 1) * W::kS2);
          const short* kcd = qcd + BQ * W::CS;
          {
            // K's planes: warp w decodes keys 8 w .. 8 w + 7 of the half
            const int n = 8 * warp + nl;
            uint32_t c[2][4];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const uint2 w2 = *reinterpret_cast<const uint2*>(
                  kcd + n * W::CS + 16 * q + 4 * tq);
              const uint32_t v4[4] = {w2.x, w2.x >> 16, w2.y, w2.y >> 16};
#pragma unroll
              for (int j = 0; j < 4; ++j)
                c[q][j] = static_cast<uint32_t>(static_cast<int>(
                              static_cast<int16_t>(v4[j]))) & op.wlmask;
            }
            bbm_mma::column_planes(c, bp + 64 * warp + 4 * nl + tq,
                                   8 * kAmHalf, op, false);
          }
          // the planes' generic stores, seen by wgmma's async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncthreads();
          bbm_mma::warp_slab_n<kAmHalf>(bbm_mma::XInt16{qcd, W::CS}, bp, op,
                                        0, min(kAmSlab, D - ds * kAmSlab),
                                        lo, hi);
        }
        // each score the softmax sees: exact + (approx - exact)
        const float sqk = __fmul_rn(sq, ks[(size_t)bh * nk + kv]);
#pragma unroll
        for (int j = 0; j < kAmHalf / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * warp + gl + 8 * (e >> 1);
            const int c = kAmHalf * h + 8 * j + 2 * tl + (e & 1);
            const float approx = __fmul_rn(
                __fmul_rn(to_f32(lo[4 * j + e], hi[4 * j + e]), g.scale2vbl),
                sqk);
            if (s_out != nullptr && r < g.bq && c < g.bk)
              s_out[((size_t)bh * g.Sqp + q0 + r) * g.Skvp + k0 + c] = approx;
            const float ex = sp[r][c];
            sp[r][c] = __fadd_rn(ex, __fsub_rn(approx, ex));
          }
      }
    }
    // ---- S3: mask, online softmax, P's quantization (8 x 8 layout)
    __syncthreads();
    float pmax = 0.0f;
    {
      float m_old[8], l_old[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m_old[i] = row_m[ty + 16 * i];
        l_old[i] = row_l[ty + 16 * i];
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 16 * i;
        float s[8];
        float rmax = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          const float sv = sp[r][c];
          const bool live =
              k0 + c < g.kv_len && (!g.causal || q0 + r >= k0 + c);
          s[j] = live ? sv : kNegInf;
          if (c < g.bk) rmax = fmaxf(rmax, s[j]);
        }
        const float m_new = fmaxf(m_old[i], group_max(rmax));
        float rsum = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          const float p = (c < g.bk && r < g.bq)
                              ? expf(__fsub_rn(s[j], m_new)) : 0.0f;
          sp[r][c] = p;
          rsum = __fadd_rn(rsum, p);
          pmax = fmaxf(pmax, p);
        }
        const float alpha = expf(__fsub_rn(m_old[i], m_new));
        const float l_new =
            __fadd_rn(__fmul_rn(l_old[i], alpha), group_sum(rsum));
        if (tx == 0) {
          row_m[r] = m_new;
          row_l[r] = l_new;
          row_a[r] = alpha;
        }
      }
    }
    // one scale for the whole (bq, bk) tile of P: a block-wide max
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      pmax = fmaxf(pmax, __shfl_xor_sync(~0u, pmax, o));
    if (lane == 0) red[warp] = pmax;
    __syncthreads();
    pmax = red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) pmax = fmaxf(pmax, red[w]);
    const float spt = fmaxf(__fmul_rn(pmax, g.inv_lim), kDeadScale);
    if (ps_out != nullptr && tid == 0)
      ps_out[((size_t)bh * nq + qi) * nk + kv] = spt;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float code = rintf(__fdiv_rn(sp[r][c], spt));
        code = fminf(fmaxf(code, -g.lim - 1.0f), g.lim);
        spc[r][c] = static_cast<short>(code);
        if (pc_out != nullptr && r < g.bq && c < g.bk)
          pc_out[((size_t)bh * g.Sqp + q0 + r) * g.Skvp + k0 + c] =
              static_cast<short>(code);
      }
    const float spv = __fmul_rn(spt, vs[(size_t)bh * nk + kv]);
#pragma unroll
    for (int cp = 0; cp < W::NP; ++cp) {
      const int cb = cp * NV;      // the pass's first value column
      // ---- P2: the Broken-Booth P V product, P's codes against V's
      // planes, on the tensor cores
      {
        auto load = [&](int sl, int st) {
          short* vcd = reinterpret_cast<short*>(un + st * W::kP2);
          for (int e = tid; e < kAmSlab * NV / 4; e += kThreads) {
            const int r = e / (NV / 4), c = (e % (NV / 4)) * 4;
            const int key = sl * kAmSlab + r;
            const bool ok = key < g.bk;
            copy8(vcd + r * W::VCS + c,
                  vc + kb + (ok ? (size_t)key * D + cb + c : 0), ok);
          }
          copy_commit();
        };
        int lo[NV / 2], hi[NV / 2];
#pragma unroll
        for (int e = 0; e < NV / 2; ++e) lo[e] = hi[e] = 0;
        __syncthreads();           // P's codes are in; the stages are free
        load(0, 0);
        for (int sl = 0; sl < n_sl; ++sl) {
          copy_wait<0>();
          __syncthreads();         // the slab landed; the last one is free
          if (sl + 1 < n_sl) load(sl + 1, (sl + 1) & 1);
          const short* vcd = reinterpret_cast<const short*>(
              un + (sl & 1) * W::kP2);
          // V's planes: column n (a value column), k the slab's keys
          for (int ng = warp; ng < NV / 8; ng += kThreads / 32) {
            const int n = 8 * ng + nl;
            uint32_t c[2][4];
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                c[q][j] = static_cast<uint32_t>(static_cast<int>(
                              vcd[(16 * q + 4 * tq + j) * W::VCS + n])) &
                          op.wlmask;
            bbm_mma::column_planes(c, bp + 64 * ng + 4 * nl + tq, 8 * NV,
                                   op, false);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncthreads();
          const int kk0 = sl * kAmSlab;
          bbm_mma::warp_slab_n<NV>(
              bbm_mma::XInt16{&spc[0][0] + kk0, kPcStride}, bp, op, 0,
              min(kAmSlab, g.bk - kk0), lo, hi);
        }
        __syncthreads();           // no warp reads the planes any more
#pragma unroll
        for (int j = 0; j < NV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * warp + gl + 8 * (e >> 1);
            const int c = 8 * j + 2 * tl + (e & 1);
            const float approx = __fmul_rn(
                __fmul_rn(to_f32(lo[4 * j + e], hi[4 * j + e]), g.scale2vbl),
                spv);
            if (pv_out != nullptr && r < g.bq)
              pv_out[(((size_t)bh * nk + kv) * g.Sqp + q0 + r) * D + cb +
                     c] = approx;
            tv[r * W::TS + c] = approx;
          }
      }
      // ---- P1: the exact P V (8 x 8 layout), then the outputs
      {
        auto load = [&](int sl, int st) {
          float* vfd = reinterpret_cast<float*>(un + st * W::kP1);
          for (int e = tid; e < kAmSlab * NV / 4; e += kThreads) {
            const int r = e / (NV / 4), c = (e % (NV / 4)) * 4;
            const int key = sl * kAmSlab + r;
            const bool ok = key < g.bk;
            copy16(vfd + r * W::VFS + c,
                   vf + kb + (ok ? (size_t)key * D + cb + c : 0), ok);
          }
          copy_commit();
        };
        float pe[8][VC];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < VC; ++c) pe[i][c] = 0.0f;
        __syncthreads();           // the products are in; the stages free
        load(0, 0);
        for (int sl = 0; sl < n_sl; ++sl) {
          copy_wait<0>();
          __syncthreads();         // the slab landed; the last one is free
          if (sl + 1 < n_sl) load(sl + 1, (sl + 1) & 1);
          const float* vfd = reinterpret_cast<const float*>(
              un + (sl & 1) * W::kP1);
          const int kk0 = sl * kAmSlab, kn = min(kAmSlab, g.bk - kk0);
          for (int kk = 0; kk < kn; ++kk) {
            float a[8], b[VC];
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = sp[ty + 16 * i][kk0 + kk];
#pragma unroll
            for (int c = 0; c < VC; ++c) b[c] = vfd[kk * W::VFS + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int c = 0; c < VC; ++c)
                pe[i][c] = fmaf(a[i], b[c], pe[i][c]);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = ty + 16 * i;
          const float alpha = row_a[r];
#pragma unroll
          for (int c = 0; c < VC; ++c) {
            const float approx = tv[r * W::TS + tx + 16 * c];
            const float pv = __fadd_rn(pe[i][c], __fsub_rn(approx, pe[i][c]));
            acc[i][cp * VC + c] =
                __fadd_rn(__fmul_rn(acc[i][cp * VC + c], alpha), pv);
          }
        }
      }
    }
  }
  // the skipped tiles' residuals: a dead kind-0 tile's values
  for (int kv = n_live; kv < nk; ++kv) {
    const int k0 = kv * g.bk;
    for (int e = tid; e < g.bq * g.bk; e += kThreads) {
      const size_t o =
          ((size_t)bh * g.Sqp + q0 + e / g.bk) * g.Skvp + k0 + e % g.bk;
      if (s_out != nullptr) s_out[o] = 0.0f;
      if (pc_out != nullptr) pc_out[o] = 0;
    }
    if (pv_out != nullptr)
      for (int e = tid; e < g.bq * D; e += kThreads)
        pv_out[(((size_t)bh * nk + kv) * g.Sqp + q0) * D + e] = 0.0f;
    if (ps_out != nullptr && tid == 0)
      ps_out[((size_t)bh * nq + qi) * nk + kv] = kDeadScale;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= g.bq) continue;
    const float den = fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < W::DC; ++c)
      out[qbase + (size_t)r * D + tx + 16 * c] = __fdiv_rn(acc[i][c], den);
  }
}

// --------------------------------------- amm (B3), wide, CUDA-core route
// The route bbm_dot_route calls "tile" (chunks too short for a tensor-core
// step, or x and bq both two bytes wide): flash_amm_kernel's body with its
// integer products on bbm_dot.cuh, the tiles streamed through one buffer.
// The K and V tiles share one buffer.  At D = 80 it holds a whole tile (K,
// then V).  At D = 128 a whole f32 tile and its codes beside Q's,
// P's and P's codes would take 301,568 bytes, above the 232,448 a block
// may have, so K streams in KSL slices of BK / KSL keys (all D columns)
// and V in VSL slices of D / VSL columns (all BK keys).  A thread's score
// columns tx + 16 j fall in K slice j / (8 / KSL) and its output columns
// tx + 16 c in V slice c / (DC / VSL), so each product's sum over d or
// over the keys runs whole, in the same order, inside one slice: the
// slicing changes no bit.
template <int D>
struct TileAmmPlan {
  static constexpr int KSL = D > 80 ? 4 : 1;
  static constexpr int VSL = D > 80 ? 4 : 1;
  static constexpr int KR = BK / KSL;          // keys of a K slice
  static constexpr int VC = D / VSL;           // columns of a V slice
  static constexpr int KV = KR * (D + 4) > BK * (VC + 4) ? KR * (D + 4)
                                                        : BK * (VC + 4);
};

template <int D>
struct TileAmmSmem {
  float q[BQ][D + 4];       // row-major, stride D + 4: float4 reads of
  short qc[BQ][D + 4];      // 8 rows hit distinct banks, code reads of
  float kv[TileAmmPlan<D>::KV]; // 16 rows too; a K slice (stride D + 4), then
  short kvc[TileAmmPlan<D>::KV];// a V slice (stride D / VSL + 4)
  float p[BQ][BK + 1];
  short pc[BQ][BK];
  float red[kThreads / 32];
};


// Rows [0, rows) of COLS columns of a (., D) f32 array and of its int16
// codes into shared memory at stride COLS + 4; the rows up to ROWS
// zero-filled.
template <int D, int ROWS, int COLS>
__device__ __forceinline__ void load_block(float* dst, short* dstc,
                                           const float* src, const short* srcc,
                                           int rows) {
  constexpr int CH = COLS / 4, ST = COLS + 4;
  for (int e = threadIdx.x; e < ROWS * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * 4;
    const bool ok = r < rows;
    const size_t off = ok ? (size_t)r * D + c : 0;
    copy16(dst + r * ST + c, src + off, ok);
    copy8(dstc + r * ST + c, srcc + off, ok);
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
flash_amm_tile_kernel(const float* __restrict__ qf, const float* __restrict__ kf,
                 const float* __restrict__ vf, const short* __restrict__ qc,
                 const short* __restrict__ kc, const short* __restrict__ vc,
                 const float* __restrict__ qs, const float* __restrict__ ks,
                 const float* __restrict__ vs, float* __restrict__ out,
                 float* __restrict__ s_out, float* __restrict__ pv_out,
                 short* __restrict__ pc_out, float* __restrict__ ps_out,
                 AmmArgs g) {
  using Plan = TileAmmPlan<D>;
  constexpr int DC = D / 16;               // output columns of a thread
  constexpr int KSL = Plan::KSL, VSL = Plan::VSL;
  constexpr int KR = Plan::KR, VC = Plan::VC;
  constexpr int JS = 8 / KSL;              // a thread's columns in a K slice
  constexpr int CS = DC / VSL;             // ... and in a V slice
  constexpr int KST = D + 4, VST = VC + 4; // the slices' strides
  static_assert(D % 16 == 0 && DC % VSL == 0, "D in steps of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileAmmSmem<D>& sm = *reinterpret_cast<TileAmmSmem<D>*>(smem_raw);
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
  // K slice s of tile kv: its keys [s KR, (s + 1) KR), every column
  auto load_k = [&](int kv, int s) {
    const size_t o = (kvrow + (size_t)kv * g.bk + (size_t)s * KR) * D;
    load_block<D, KR, D>(sm.kv, sm.kvc, kf + o, kc + o,
                         min(max(g.bk - s * KR, 0), KR));
  };
  // V slice s of tile kv: its columns [s VC, (s + 1) VC), every key
  auto load_v = [&](int kv, int s) {
    const size_t o = (kvrow + (size_t)kv * g.bk) * D + (size_t)s * VC;
    load_block<D, BK, VC>(sm.kv, sm.kvc, vf + o, vc + o, g.bk);
  };

  load_block<D, BQ, D>(&sm.q[0][0], &sm.qc[0][0], qf + qbase, qc + qbase,
                       g.bq);
  if (n_live > 0) load_k(0, 0);
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
    float yq[8][8];
#pragma unroll
    for (int ksl = 0; ksl < KSL; ++ksl) {
      copy_wait<0>();              // the K slice (and at first, Q) landed
      __syncthreads();
      // the exact f32 score product, parked in P's buffer
      {
        float s[8][JS];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < JS; ++j) s[i][j] = 0.0f;
        for (int d = 0; d < D; d += 4) {
          float4 a[8], b[JS];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            a[i] = *reinterpret_cast<const float4*>(&sm.q[ty + 16 * i][d]);
#pragma unroll
          for (int j = 0; j < JS; ++j)
            b[j] = *reinterpret_cast<const float4*>(
                &sm.kv[(tx + 16 * j) * KST + d]);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < JS; ++j) {
              s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
              s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
              s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
              s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < JS; ++j)
            sm.p[ty + 16 * i][tx + 16 * (ksl * JS + j)] = s[i][j];
      }
      // the Broken-Booth score product of the codes, K^T as the multiplier
      {
        int part[8][JS];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < JS; ++j) {
            part[i][j] = 0;
            yq[i][ksl * JS + j] = 0.0f;
          }
        int left = g.chunk;
        for (int d = 0; d < D; ++d) {
          int a[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = sm.qc[ty + 16 * i][d];
#pragma unroll
          for (int j = 0; j < JS; ++j) {
            const bbm::Unpacked u = bbm::unpack(bbm::decode(
                sm.kvc[(tx + 16 * j) * KST + d], g.wl, g.vbl, g.R));
#pragma unroll
            for (int i = 0; i < 8; ++i)
              part[i][j] += bbm::scaled_product<KIND>(a[i], u, g.vbl, g.R);
          }
          if (--left == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < JS; ++j)
                bbm::flush(yq[i][ksl * JS + j], part[i][j]);
            left = g.chunk;
          }
        }
        if (left != g.chunk) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < JS; ++j)
              bbm::flush(yq[i][ksl * JS + j], part[i][j]);
        }
      }
      __syncthreads();   // the K slice is no longer read: the next copy
      if (ksl + 1 < KSL) // (V's first, under P's work) runs
        load_k(kv, ksl + 1);
      else
        load_v(kv, 0);
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
    const float spv = __fmul_rn(sp, vs[(size_t)bh * nk + kv]);
#pragma unroll
    for (int vsl = 0; vsl < VSL; ++vsl) {
      copy_wait<0>();              // the V slice has landed
      __syncthreads();
      float pe[8][CS];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < CS; ++c) pe[i][c] = 0.0f;
      for (int kk = 0; kk < g.bk; ++kk) {
        float a[8], b[CS];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = sm.p[ty + 16 * i][kk];
#pragma unroll
        for (int c = 0; c < CS; ++c) b[c] = sm.kv[kk * VST + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < CS; ++c) pe[i][c] = fmaf(a[i], b[c], pe[i][c]);
      }
      float yv[8][CS];
      {
        int part[8][CS];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < CS; ++c) {
            part[i][c] = 0;
            yv[i][c] = 0.0f;
          }
        int left = g.chunk;
        for (int kk = 0; kk < g.bk; ++kk) {
          int a[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = sm.pc[ty + 16 * i][kk];
#pragma unroll
          for (int c = 0; c < CS; ++c) {
            const bbm::Unpacked u = bbm::unpack(
                bbm::decode(sm.kvc[kk * VST + tx + 16 * c], g.wl, g.vbl, g.R));
#pragma unroll
            for (int i = 0; i < 8; ++i)
              part[i][c] += bbm::scaled_product<KIND>(a[i], u, g.vbl, g.R);
          }
          if (--left == 0) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int c = 0; c < CS; ++c) bbm::flush(yv[i][c], part[i][c]);
            left = g.chunk;
          }
        }
        if (left != g.chunk) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < CS; ++c) bbm::flush(yv[i][c], part[i][c]);
        }
      }
      __syncthreads();   // the V slice is no longer read: the next copy
      if (vsl + 1 < VSL) // (the next tile's K, under the epilogue) runs
        load_v(kv, vsl + 1);
      else if (kv + 1 < n_live)
        load_k(kv + 1, 0);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int cc = 0; cc < CS; ++cc) {
          const int c = vsl * CS + cc;
          const float approx =
              __fmul_rn(__fmul_rn(yv[i][cc], g.scale2vbl), spv);
          const int r = ty + 16 * i;
          if (pv_out != nullptr && r < g.bq)
            pv_out[(((size_t)bh * nk + kv) * g.Sqp + q0 + r) * D + tx +
                   16 * c] = approx;
          const float pv = __fadd_rn(pe[i][cc], __fsub_rn(approx, pe[i][cc]));
          acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], alpha[i]), pv);
        }
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

template <int D, int KIND>
int amm_wide_launch(int route, const float* qf, const float* kf,
                    const float* vf, const short* qc, const short* kc,
                    const short* vc, const float* qs, const float* ks,
                    const float* vs, float* out, float* s_out, float* pv_out,
                    short* pc_out, float* ps_out, const AmmArgs& g,
                    cudaStream_t st) {
  const int blocks = g.Sqp / g.bq * g.BH;
  if (route == 1) {
    const bbm_mma::Op op = bbm_mma::make_op(g.wl, g.vbl, KIND);
    // x's and bq's bytes in two significances, each product one chunk
    if (op.xb + op.bqb > 3 || g.chunk < D || g.chunk < g.bk) return kBadRoute;
    const size_t smem = WideAmm<D>::smem(op.planes);
    int err = launch_config(flash_amm_mma_kernel<D>, smem);
    if (err) return err;
    flash_amm_mma_kernel<D><<<blocks, kThreads, smem, st>>>(
        qf, kf, vf, qc, kc, vc, qs, ks, vs, out, s_out, pv_out, pc_out,
        ps_out, g, op);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != 0) return kBadRoute;
  const size_t smem = sizeof(TileAmmSmem<D>);
  int err = launch_config(flash_amm_tile_kernel<D, KIND>, smem);
  if (err) return err;
  flash_amm_tile_kernel<D, KIND><<<blocks, kThreads, smem, st>>>(
      qf, kf, vf, qc, kc, vc, qs, ks, vs, out, s_out, pv_out, pc_out, ps_out,
      g);
  return static_cast<int>(cudaGetLastError());
}

// The entry points' bodies at the head dims DS...; route 0 or 1 (exact:
// FFMA or 3xTF32 P V; amm: the CUDA-core or the tensor-core products).
template <int... DS>
int exact_wide_dispatch(const float* q, const float* k, const float* v,
                        float* out, int BH, int Sq, int Skv, int D,
                        int causal, float scale, int route, cudaStream_t st) {
  if (route != 0 && route != 1) return kBadRoute;
  int err = kBadHeadDim;
  ((D == DS ? (err = route ? exact_wgmma_launch<DS, true>(
                                 q, k, v, out, BH, Sq, Skv, causal, scale, st)
                           : exact_wgmma_launch<DS, false>(
                                 q, k, v, out, BH, Sq, Skv, causal, scale,
                                 st), 0) : 0), ...);
  return err;
}

template <int... DS>
int amm_wide_dispatch(const float* qf, const float* kf, const float* vf,
                      const short* qc, const short* kc, const short* vc,
                      const float* qs, const float* ks, const float* vs,
                      float* out, float* s_out, float* pv_out, short* pc_out,
                      float* ps_out, const AmmArgs& g, int D, int kind,
                      int route, cudaStream_t st) {
  int err = kBadHeadDim;
  ((D == DS ? (err = kind ? amm_wide_launch<DS, 1>(
                                route, qf, kf, vf, qc, kc, vc, qs, ks, vs,
                                out, s_out, pv_out, pc_out, ps_out, g, st)
                          : amm_wide_launch<DS, 0>(
                                route, qf, kf, vf, qc, kc, vc, qs, ks, vs,
                                out, s_out, pv_out, pc_out, ps_out, g, st),
                 0) : 0), ...);
  return err;
}

}  // namespace
