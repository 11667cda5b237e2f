// jax.random.normal(key, shape, float32) bit for bit, for Hopper.
//
// Replaces the XLA op the reference draws its keyed noise with
// (src/repro/models/common.py:264, src/repro/core/noise.py:75,
// src/repro/kernels/ref.py:389).  Each thread takes elements by their
// row-major flat index i (a grid-stride loop, one element at a time):
//
//   bits = w0 ^ w1,  (w0, w1) = Threefry-2x32(key, (i >> 32, i & 0xffffffff))
//   f    = bitcast(bits >> 9 | 0x3f800000) - 1                 in [0, 1)
//   u    = max(lo, fma(f, 2, lo)),  lo = nextafter(-1, 0)
//   z    = sqrt(2) * erf_inv(u)
//
// Threefry is JAX's: 20 rounds, the key schedule (k1, k2, k1 ^ k2 ^
// 0x1BD11BDA) injected after each group of four, the partitionable
// counter of jax_threefry_partitionable.  erf_inv is XLA's ErfInv32
// (w = -log1p(-u*u); a degree-8 polynomial in w - 2.5 for w < 5, else
// in sqrt(w) - 3; times u), log1p is XLA's (a Cephes rational form for
// |y| < sqrt(2) - 1, else log(1 + y)), and log is the one XLA:CPU
// compiles (Cephes' logf: three polynomial chains in the reduced
// mantissa, the exponent added back through ln 2 split in two).
//
// Bits.  The reference's values are those of its compiled CPU program,
// which fuses some multiply-adds and rounds every other step alone; this
// file does exactly the same: each step XLA fused is __fmaf_rn, every
// other one __fadd_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn, so nvcc
// neither contracts nor approximates (and the build takes no
// --use_fast_math).  No libdevice log: its rounding is not XLA:CPU's.
// The plain PyTorch version (core/prng.py: normal_from_bits) is the same
// sequence on the CPU with an exact FMA emulation.
//
// Epilogues (optional), in place on a float32 acc, in the same pass as
// the draw: acc + c1 + c2 * z as XLA compiles it inside a program.  XLA
// folds c2 * sqrt(2) into one float32 constant (the host passes it as
// c2s) and fuses its product with erf_inv(u) into the last add:
//   mode 1: acc[i] = fma(c2s, erf_inv(u), acc[i] + c1)   (the noise
//           branch's yq + mu*K + sigma*sqrt(K)*z, quant_matmul_ref's)
//   mode 2: acc[i] = acc[i] + fma(c2s, erf_inv(u), c1)   (inject_dot_error's
//           y + (mu + sigma*z))
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k1, uint32_t k2,
                                                  uint32_t c0, uint32_t c1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[g % 2][r]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return x0 ^ x1;
}

__device__ __forceinline__ float f32(uint32_t b) { return __uint_as_float(b); }

// XLA:CPU's float32 log of a positive finite t.
__device__ __forceinline__ float xla_log(float t) {
  t = fmaxf(t, f32(0x00800000u));
  const uint32_t b = __float_as_uint(t);
  float e = __fadd_rn(__int2float_rn(static_cast<int>(b >> 23) - 127), 1.0f);
  const float m = f32((b & 0x7FFFFFu) | 0x3F000000u);
  const bool low = m < f32(0x3F3504F3u);            // sqrt(1/2)
  const float x = __fadd_rn(__fadd_rn(m, -1.0f), low ? m : 0.0f);
  if (low) e = __fadd_rn(e, -1.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  const float a = __fmaf_rn(x, __fmaf_rn(x, f32(0x3D9021BBu), f32(0xBDEBD1B8u)),
                            f32(0x3DEF251Au));
  const float bb = __fmaf_rn(x, __fmaf_rn(x, f32(0xBDFE5D4Fu), f32(0x3E11E9BFu)),
                             f32(0xBE2AAE50u));
  const float c = __fmaf_rn(x, __fmaf_rn(x, f32(0x3E4CCEACu), f32(0xBE7FFFFCu)),
                            f32(0x3EAAAAAAu));
  const float poly = __fmaf_rn(x3, __fmaf_rn(x3, a, bb), c);
  const float y = __fmaf_rn(x3, poly, __fmul_rn(e, f32(0xB95E8083u)));
  return __fmaf_rn(e, f32(0x3F318000u),
                   __fadd_rn(__fmaf_rn(-0.5f, x2, x), y));
}

// XLA's float32 log1p of y in (-1, 0].
__device__ __forceinline__ float xla_log1p(float y) {
  if (!(fabsf(y) < f32(0x3ED413CDu))) return xla_log(__fadd_rn(y, 1.0f));
  const float y2 = __fmul_rn(y, y);
  float den = 1.0f;
  den = __fmaf_rn(y, den, f32(0x417101ADu));
  den = __fmaf_rn(y, den, f32(0x42A6185Bu));
  den = __fmaf_rn(y, den, f32(0x435DC32Du));
  den = __fmaf_rn(y, den, f32(0x439A8CA3u));
  den = __fmaf_rn(y, den, f32(0x43586D8Au));
  den = __fmaf_rn(y, den, f32(0x42707982u));
  float num = f32(0x383DE04Bu);
  num = __fmaf_rn(y, num, f32(0x3EFF40C5u));
  num = __fmaf_rn(y, num, f32(0x40D284FAu));
  num = __fmaf_rn(y, num, f32(0x41EF4B9Cu));
  num = __fmaf_rn(y, num, f32(0x4273CC76u));
  num = __fmaf_rn(y, num, f32(0x426473ADu));
  num = __fmaf_rn(y, num, f32(0x41A05101u));
  const float r = __fmul_rn(__fmul_rn(y, y2), __fdiv_rn(num, den));
  return __fadd_rn(y, __fmaf_rn(-0.5f, y2, r));
}

__constant__ uint32_t kErfLt5[9] = {
    0x32F16588u, 0x34B84B36u, 0xB66C7357u, 0xB6935AC1u, 0x396532DBu,
    0xBAA45408u, 0xBB88E4EFu, 0x3E7C8F63u, 0x3FC02E2Fu};
__constant__ uint32_t kErfGe5[9] = {
    0xB951F09Bu, 0x38D3B56Bu, 0x3AB0DC72u, 0xBB70BDE7u, 0x3BBC127Bu,
    0xBBF9C5D7u, 0x3C1AA57Eu, 0x3F8036DBu, 0x40354F7Eu};

// XLA's ErfInv32 of the uniform drawn from `bits`.
__device__ __forceinline__ float erfinv_of_bits(uint32_t bits) {
  const float lo = f32(0xBF7FFFFFu);
  const float f = __fadd_rn(f32((bits >> 9) | 0x3F800000u), -1.0f);
  const float u = fmaxf(__fmaf_rn(f, 2.0f, lo), lo);
  const float lp = xla_log1p(__fmul_rn(u, -u));    // -w
  const bool lt5 = lp > -5.0f;
  const uint32_t* c = lt5 ? kErfLt5 : kErfGe5;
  const float t = lt5 ? __fadd_rn(-2.5f, -lp)
                      : __fadd_rn(__fsqrt_rn(-lp), -3.0f);
  float p = __fmaf_rn(t, f32(c[0]), f32(c[1]));
#pragma unroll
  for (int i = 2; i < 9; ++i) p = __fmaf_rn(t, p, f32(c[i]));
  if (fabsf(u) == 1.0f) p = __int_as_float(0x7F800000);
  return __fmul_rn(u, p);
}

__device__ __forceinline__ float normal_of_bits(uint32_t bits) {
  return __fmul_rn(erfinv_of_bits(bits), f32(0x3FB504F3u));   // sqrt(2)
}

template <int kMode>
__global__ void normal_kernel(float* __restrict__ out, long long n,
                              uint32_t k1, uint32_t k2, float c1, float c2s) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned long long u = static_cast<unsigned long long>(i);
    const uint32_t bits = threefry_bits(
        k1, k2, static_cast<uint32_t>(u >> 32), static_cast<uint32_t>(u));
    if (kMode == 0)
      out[i] = normal_of_bits(bits);
    else if (kMode == 1)
      out[i] = __fmaf_rn(c2s, erfinv_of_bits(bits), __fadd_rn(out[i], c1));
    else
      out[i] = __fadd_rn(out[i], __fmaf_rn(c2s, erfinv_of_bits(bits), c1));
  }
}

// The transform alone, from given uint32 bits: the exhaustive check of
// the 2^23 uniforms against the plain version.
__global__ void normal_bits_kernel(const uint32_t* __restrict__ bits,
                                   float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = normal_of_bits(bits[i]);
}

constexpr int kThreads = 256;

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  // a grid-stride loop past a few waves of the 132 SMs
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  out: n float32; mode 0 writes
// the draw, modes 1 and 2 read acc from out and write its epilogue (see
// the top of the file; c2s is c2 * sqrt(2) rounded to float32).
int normal_launch(float* out, long long n, unsigned int k1, unsigned int k2,
                  int mode, float c1, float c2s, void* stream) {
  if (n <= 0) return 0;
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = grid_for(n);
  if (mode == 0)
    normal_kernel<0><<<g, kThreads, 0, st>>>(out, n, k1, k2, c1, c2s);
  else if (mode == 1)
    normal_kernel<1><<<g, kThreads, 0, st>>>(out, n, k1, k2, c1, c2s);
  else
    normal_kernel<2><<<g, kThreads, 0, st>>>(out, n, k1, k2, c1, c2s);
  return static_cast<int>(cudaGetLastError());
}

int normal_bits_launch(const unsigned int* bits, float* out, long long n,
                       void* stream) {
  if (n <= 0) return 0;
  normal_bits_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(bits, out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* normal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
