// The contracted Broken-Booth dot form on the int8 tensor cores (sm_90a):
// one kernel template and its host-side launcher.
//
// Shared by bbm_dot.cu (bbm_dot_scaled and bbm_dot_planes: the chunked
// f32 datapath, with the keyed accumulator upsets) and bbm_matmul.cu
// (bbm_matmul_dot at shift <= vbl: one int32 sum over K, << (vbl -
// shift)).  The Python route rule (bbm_matmul.py: bbm_dot_route) sends a
// call here where every K-chunk of amm_chunk_len(wl, vbl) products holds
// at least one 32-deep tensor-core step and the operand bytes below need
// at most two significances; elsewhere the CUDA-core tile of
// bbm_tile.cuh runs.
//
// Arithmetic.  Each product is 2^vbl * M with M = x*bq + sum_{r<R} q_r,
// q_r = floor((d_r x - kind neg_r) / 2^m_r), m_r = vbl - 2r
// (bbm_dot.cuh).  Per row the floor splits into products of an x-side
// value and a weight-side value, all at one scale:
//
//   q_r = (x >> m_r) d_r + b_r B2_r - [kind 0] (nz1_r I1_r + nz2_r I2_r)
//                                    - [kind 1] neg_r
//
// with b_r = bit m_r - 1 of x, nz1_r = [x mod 2^m_r != 0], nz2_r = [x mod
// 2^(m_r - 1) != 0], B2_r = [d_r = 2] - [d_r = -2], I1_r = [d_r = -1],
// I2_r = [d_r = -2] (floor(2x / 2^m) = 2 (x >> m) + b, floor(-x / 2^m) =
// -(x >> m) - nz1, floor((-x - 1) / 2^m) = -(x >> m) - 1, and so on).  So a
// K-chunk's partial is a sum of int8 matrix products: x's bytes against
// bq's, each row's (x >> m_r) bytes against d_r, the bit planes against
// B2_r (and -I1_r, -I2_r at kind 0), and at kind 1 a ones plane against
// -sum_{r<R} neg_r.  A value wider than s8 splits into a u8 low byte and
// an s8 high byte; the high bytes' products go to a second int32
// accumulator, so the partial is lo + 256 hi.  Integer sums are exact
// modulo 2^32 in any order and any split, and the true partial fits in
// int32 inside amm_chunk_len (that is how the chunk is derived), so the
// wrapped lo + 256 hi is the exact partial: no per-row shift, no per-slab
// fix-up.  At wl 16 / vbl 13 a code product takes 34 byte products at
// kind 0 (2 for x bq, 11 for the seven rows' x >> m_r, 7 bits, 14
// indicators) and 21 at kind 1, against the 56 and 66 of the reference's
// one-hot residue contractions (bbm_matmul.py: _dot_scaled).
//
// Operands.  The weight side decodes once per block and K slab into
// shared memory, as dot_tile decodes digits: per row a 16-bit selector of
// four codes' Booth triplets (u_{2r+1}, u_{2r}, u_{2r-1}) comes straight
// from the codes, and one prmt per selector looks up four k bytes of
// d_r, B2_r, -I1_r or -I2_r; bq is the code less its low 2R bits' Booth
// value, over 2^vbl.  The planes-in entries first pack (mag, neg) planes
// into triplet words (bbm_pack_triplets_kernel, one pass over the planes;
// a nibble per row, transposed in the decode).  A pre-pass writing the
// byte planes per call instead would move 29 bytes a (k, n) at wl 16 /
// vbl 13 through device memory and, for every 128-row block, L2.  The x
// side is formed in registers, in the wgmma A fragment layout (each
// warp's 16 rows as mma.m16n8k32's A), from the int32 codes of the staged
// x tile: two codes a register as 16-bit lanes (and their high bytes,
// sign-extended), so a shift and a prmt give four bytes of any x >> m_r,
// and the trailing-zero counts of four codes give nz1_r and nz2_r by one
// byte-wise compare.
//
// Tiling.  One block of 256 threads (two warpgroups) owns a 128 x 128
// output tile; each warp holds 16 rows and all 128 columns of lo and hi
// (128 accumulator registers), so each x byte is formed once a block.  K
// streams in slabs of up to 32 codes that never cross a chunk boundary
// (a chunk of 8,191 restarts the slabs at its end), through a two-stage
// cp.async ring (x 128 x 32 and w 32 x 128 int32; 16-byte copies where K,
// N, the chunk and the pointers allow, else 4-byte ones).  Each slab: the
// ring's next copy starts, the block decodes the slab's weight planes
// (bq's bytes, then d_r, B2_r, -I1_r, -I2_r per row, then -sum neg_r)
// into wgmma's K-major shared-memory layout, and each warpgroup runs one
// asynchronous wgmma.m64n128k32 (u8/s8, s32 accumulators, A from
// registers) per byte plane, forming the next plane's A bytes while the
// last runs; the codes past a short slab's end are masked to zero (and
// the ones plane with them).  At a chunk's end each thread folds lo + 256
// hi of its outputs into the epilogue.  The decode runs between two
// barriers while no wgmma is in flight (about a quarter of the time at
// the T1 shapes); a pre-pass per call, or decoding half a slab's planes
// while the other half multiplies, would hide it (the latter, tried,
// needed 255 registers and ran slower).
//
// Bound.  The int8 tensor cores: chip_smoke.py charges the fewest byte
// products of the exact forms known, this kernel's own 34 a code product
// at wl 16 / vbl 13 kind 0 and 21 at kind 1 (the reference's one-hot
// residue contractions take 56 and 66), 0.307 and 0.189 ms at (2048,
// 896) x (896, 4864) on an H100's 1,979 dense TOP/s; the bytes (codes in,
// f32 out) take 0.019 ms.  The weight decode and the x bytes are
// CUDA-core work beside the products.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bbm_dot.cuh"
#include "bbm_wgmma.cuh"

namespace bbm_mma {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128;             // block tile (K slab kBK)
constexpr int kXS = kBK + 16;     // words per staged x row (conflict-free
                                  // 16-byte fragment loads)
constexpr int kWS = kBN + 4;      // words per staged w row (the decode's
                                  // column loads two-way at most)
constexpr int kNT = kBN / 8;      // n8 tiles of the block (and of a warp)
constexpr int kPlane = kBK * kBN / 4;           // words per weight plane
constexpr int kMaxPlanes = 2 + 4 * 8;
constexpr size_t kStage = sizeof(int) * (kBM * kXS + kBK * kWS);

// two cp.async stages and one slab's weight planes
__host__ __device__ constexpr size_t smem_bytes(int planes) {
  return 2 * kStage + sizeof(uint32_t) * kPlane * planes;
}

// ------------------------------------------------------------ epilogue
// A chunk's partial into the output.  f32 (the amm datapath): chunk ci's
// partial, XORed with its accumulator upset where keys is set, to f32,
// times 2^vbl (scale), added to the output in chunk order; scaling each
// partial before the add equals scaling the sum, every value an integer
// times a power of two far from f32's range ends.  Else (bbm_matmul_dot
// at shift <= vbl): the one K sum, << up, wrapping as torch's int32 does.
// One kernel serves both (the same code in both libraries); out of line,
// since inlined the threefry draw's registers beside the 128 accumulators
// spill, and a chunk's end is rare.
struct Epilogue {
  void* out;
  const uint32_t* keys;
  float p, scale;
  int bit, up, N;
  bool f32;
  __device__ __noinline__ void operator()(int gm, int gn, uint32_t part,
                                          int ci) const {
    const size_t o = static_cast<size_t>(gm) * N + gn;
    if (!f32) {
      static_cast<int32_t*>(out)[o] = static_cast<int32_t>(part << up);
      return;
    }
    if (keys && bbm::bernoulli_hit(keys[2 * ci], keys[2 * ci + 1],
                                   static_cast<uint32_t>(o), p))
      part ^= 1u << bit;
    const float v = __fmul_rn(__int2float_rn(static_cast<int>(part)), scale);
    float* f = static_cast<float*>(out) + o;
    *f = ci == 0 ? v : __fadd_rn(*f, v);
  }
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0));
}

// The block decodes the slab's weight planes into `bp` (column_planes).
// Warp w, lane (nl, tq) takes column 8 (w + 8 h) + nl and k quads tq and
// 4 + tq, for h = 0, 1: a warp's stores into a plane cover 32 distinct
// banks.
__device__ __forceinline__ void form_weights(const int* __restrict__ ws,
                                             uint32_t* __restrict__ bp,
                                             const Op& op, bool words) {
  const int lane = threadIdx.x & 31, nl = lane & 7, tq = lane >> 3;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int ng = (threadIdx.x >> 5) + 8 * h, n = 8 * ng + nl;
    uint32_t c[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t v =
            static_cast<uint32_t>(ws[(16 * q + 4 * tq + j) * kWS + n]);
        c[q][j] = words ? v : v & op.wlmask;
      }
    column_planes(c, bp + 64 * ng + 4 * nl + tq, kPlane, op, words);
  }
}

// The matmul's slab (its first rb k) at width 128 from int32 x codes.
__device__ __forceinline__ void warp_slab(const int* __restrict__ xs,
                                          const uint32_t* __restrict__ bp,
                                          const Op& op, int rb,
                                          int (&lo)[64], int (&hi)[64]) {
  warp_slab_n<kBN>(XInt32{xs, kXS}, bp, op, 0, rb, lo, hi);
}


// ------------------------------------------------------------ the kernel
// The slab's x (128 x 32) and w (32 x 128) int32 into stage buffers.
__device__ __forceinline__ void issue(const int* __restrict__ x,
                                      const int* __restrict__ w, int* xs,
                                      int* ws, int m0, int n0, int k0, int M,
                                      int K, int N, bool vx, bool vw) {
  const int tid = threadIdx.x;
  if (vx) {
#pragma unroll
    for (int e = tid; e < kBM * kBK / 4; e += kThreads) {
      const int r = e >> 3, q = e & 7;
      const int gm = m0 + r, gk = k0 + 4 * q;
      const bool ok = gm < M && gk < K;
      cp_async(xs + r * kXS + 4 * q, ok ? x + (size_t)gm * K + gk : x, 16,
               ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e >> 5, q = e & 31;
      const int gm = m0 + r, gk = k0 + q;
      const bool ok = gm < M && gk < K;
      cp_async(xs + r * kXS + q, ok ? x + (size_t)gm * K + gk : x, 4, ok);
    }
  }
  if (vw) {
#pragma unroll
    for (int e = tid; e < kBK * kBN / 4; e += kThreads) {
      const int r = e >> 5, q = e & 31;
      const int gk = k0 + r, gn = n0 + 4 * q;
      const bool ok = gk < K && gn < N;
      cp_async(ws + r * kWS + 4 * q, ok ? w + (size_t)gk * N + gn : w, 16,
               ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e >> 7, q = e & 127;
      const int gk = k0 + r, gn = n0 + q;
      const bool ok = gk < K && gn < N;
      cp_async(ws + r * kWS + q, ok ? w + (size_t)gk * N + gn : w, 4, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Slabs of up to 32 k that never cross a chunk boundary: k0 steps by 32
// inside a chunk and restarts at the next chunk's first k.
struct Slabs {
  long long chunk;
  int K, k0, cend;                // slab start, its chunk's end
  __device__ __forceinline__ Slabs(long long chunk_, int K_)
      : chunk(chunk_), K(K_), k0(0),
        cend(chunk_ < K_ ? static_cast<int>(chunk_) : K_) {}
  __device__ __forceinline__ int k1() const { return min(k0 + kBK, cend); }
  __device__ __forceinline__ bool last() const { return k1() == cend; }
  __device__ __forceinline__ bool done() const { return k0 >= K; }
  __device__ __forceinline__ void next() {
    if (last()) {
      k0 = cend;
      cend = static_cast<int>(cend + chunk < K ? cend + chunk : K);
    } else {
      k0 += kBK;
    }
  }
};

// grid (ceil(N / 128), ceil(M / 128)), 256 threads, smem_bytes(op.planes).
// w: int32 codes (words = false) or packed triplet words (K, N).  Chunks
// of `chunk` products end at multiples of chunk and at K; each chunk's
// partial goes to epi(gm, gn, partial, chunk index).
__global__ void __launch_bounds__(kThreads, 1)
bbm_mma_kernel(const int* __restrict__ x, const int* __restrict__ w,
               bool words, bool vx, bool vw, int M, int K, int N, Op op,
               long long chunk, Epilogue epi) {
  extern __shared__ uint4 bbm_mma_smem[];
  int* xs = reinterpret_cast<int*>(bbm_mma_smem);        // [2][kBM][kXS]
  int* ws = xs + 2 * kBM * kXS;                          // [2][kBK][kWS]
  uint32_t* bp = reinterpret_cast<uint32_t*>(ws + 2 * kBK * kWS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int lo[64], hi[64];             // n8 tile j's four at 4 j
#pragma unroll
  for (int i = 0; i < 64; ++i) lo[i] = hi[i] = 0;

  Slabs cur(chunk, K);
  issue(x, w, xs, ws, m0, n0, cur.k0, M, K, N, vx, vw);
  int stage = 0, ci = 0;
  while (!cur.done()) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();        // this slab landed; every warp is done with the last
    Slabs nxt = cur;
    nxt.next();
    if (!nxt.done())
      issue(x, w, xs + (stage ^ 1) * kBM * kXS, ws + (stage ^ 1) * kBK * kWS,
            m0, n0, nxt.k0, M, K, N, vx, vw);
    form_weights(ws + stage * kBK * kWS, bp, op, words);
    // the planes' generic stores, seen by wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    warp_slab(xs + stage * kBM * kXS, bp, op, cur.k1() - cur.k0, lo, hi);
    if (cur.last()) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gm = m0 + warp * 16 + g + 8 * (e >> 1);
          const int gn = n0 + j * 8 + 2 * t + (e & 1);
          if (gm < M && gn < N)
            epi(gm, gn,
                static_cast<uint32_t>(lo[4 * j + e]) +
                    (static_cast<uint32_t>(hi[4 * j + e]) << 8),
                ci);
          lo[4 * j + e] = hi[4 * j + e] = 0;
        }
      ++ci;
    }
    cur = nxt;
    stage ^= 1;
  }
}

// (mag, neg) planes (rows, K, N) -> triplet words (K, N): row r's nibble is
// a triplet of the same digit and sign, (0, 0) -> 000, (1, 0) -> 001,
// (2, 0) -> 011, (0, 1) -> 111, (1, 1) -> 101, (2, 1) -> 100 (mag 3, which
// no decode or fault makes, reads as 2).
__global__ void __launch_bounds__(256)
bbm_pack_triplets_kernel(const int* __restrict__ mag,
                         const int* __restrict__ neg,
                         uint32_t* __restrict__ words, size_t kn, int rows) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < kn;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t tw = 0;
    for (int r = 0; r < rows; ++r) {
      const uint32_t idx = (static_cast<uint32_t>(mag[r * kn + i]) & 3u) |
                           ((static_cast<uint32_t>(neg[r * kn + i]) & 1u) << 2);
      tw |= ((0x44573310u >> (4 * idx)) & 0xFu) << (4 * r);
    }
    words[i] = tw;
  }
}

// Launch the kernel on codes (wmag null) or on planes, which are first
// packed into `tw` (K x N int32 scratch).  Returns the cudaError_t.
inline cudaError_t launch(const int* x, const int* w, const int* wmag,
                          const int* wneg, int* tw, int M, int K, int N,
                          int wl, int vbl, int kind, long long chunk,
                          Epilogue epi, cudaStream_t st) {
  const Op op = make_op(wl, vbl, kind);
  const bool words = wmag != nullptr;
  if (words) {
    const size_t kn = static_cast<size_t>(K) * N;
    const int blocks = static_cast<int>((kn + 255) / 256 < 132 * 16
                                            ? (kn + 255) / 256 : 132 * 16);
    bbm_pack_triplets_kernel<<<blocks, 256, 0, st>>>(
        wmag, wneg, reinterpret_cast<uint32_t*>(tw), kn, wl / 2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    w = tw;
  }
  const size_t smem = smem_bytes(op.planes);
  cudaError_t e = cudaFuncSetAttribute(
      bbm_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxPlanes)));
  if (e != cudaSuccess) return e;
  // 16-byte x copies need every slab start on a multiple of 4
  const bool vx = K % 4 == 0 && (chunk >= K || chunk % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vw = N % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  bbm_mma_kernel<<<grid, kThreads, smem, st>>>(x, w, words, vx, vw, M, K, N,
                                                op, chunk, epi);
  return cudaGetLastError();
}

}  // namespace bbm_mma
