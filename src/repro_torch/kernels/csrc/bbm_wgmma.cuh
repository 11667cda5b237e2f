// The device-side pieces of the contracted Broken-Booth dot form on the
// int8 tensor cores (sm_90a), shared by bbm_mma.cuh (the matmul kernel)
// and flash_attention_wide.cuh (the flash kernel's score and value
// products): wgmma.mma_async at widths 64, 80 and 128, a column's weight
// planes from its codes, the x side's bytes formed in registers, and one
// slab's products.  bbm_mma.cuh's header sets out the arithmetic.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bytes.cuh"

namespace bbm_mma {

constexpr int kBK = 32;           // k of a slab: one wgmma step

// wgmma.mma_async m64n128k32, A (the warpgroup's 64 rows: each warp's 16
// in the mma fragment layout) from registers, B (32 k x 128 n) from a
// shared-memory plane, s32 accumulators (each thread's 64: n8 tile j's
// four at 4 j), d += A B.
__device__ __forceinline__ void wgmma_ss(int (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma_su(int (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma_us(int (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma_uu(int (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// The same at N = 64 and 80 (32 and 40 accumulators a thread): the flash
// kernel's key halves and value columns (flash_attention_wide.cuh).
__device__ __forceinline__ void wgmma64_ss(int (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma64_su(int (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma64_us(int (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma64_uu(int (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma80_ss(int (&d)[40],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma80_su(int (&d)[40],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma80_us(int (&d)[40],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma80_uu(int (&d)[40],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// d += A B at width N (the accumulators' count N / 2 a thread)
template <int N, bool AS, bool BS>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc) {
  static_assert(N == 64 || N == 80 || N == 128, "wgmma width");
  if constexpr (N == 128) {
    if (AS && BS) wgmma_ss(d, a, desc);
    else if (AS) wgmma_su(d, a, desc);
    else if (BS) wgmma_us(d, a, desc);
    else wgmma_uu(d, a, desc);
  } else if constexpr (N == 80) {
    if (AS && BS) wgmma80_ss(d, a, desc);
    else if (AS) wgmma80_su(d, a, desc);
    else if (BS) wgmma80_us(d, a, desc);
    else wgmma80_uu(d, a, desc);
  } else {
    if (AS && BS) wgmma64_ss(d, a, desc);
    else if (AS) wgmma64_su(d, a, desc);
    else if (BS) wgmma64_us(d, a, desc);
    else wgmma64_uu(d, a, desc);
  }
}

// Row r's selector of four codes (one column, four consecutive k) from
// their low wl bits packed as 16-bit lanes (l02: codes 0, 2; l13: 1, 3):
// nibble i = bits (2r + 1, 2r, 2r - 1) of code i.
__device__ __forceinline__ uint32_t code_selector(uint32_t l02, uint32_t l13,
                                                  int r) {
  uint32_t a, b;
  if (r == 0) {
    a = (l02 << 1) & 0x00060006u;
    b = (l13 << 1) & 0x00060006u;
  } else {
    a = (l02 >> (2 * r - 1)) & 0x00070007u;
    b = (l13 >> (2 * r - 1)) & 0x00070007u;
  }
  const uint32_t v = a | (b << 4);
  return (v | (v >> 8)) & 0xFFFFu;
}

// Four k bytes of a column into k quads 0 and 4 (the word q0 at k 4 tq,
// q1 at 16 + 4 tq) of weight plane `plane` (pw words a plane), at the
// thread's dst.
__device__ __forceinline__ void put(uint32_t* dst, int plane, int pw,
                                    uint32_t q0, uint32_t q1) {
  dst[plane * pw] = q0;
  dst[plane * pw + 32] = q1;
}

// One column's planes from its eight codes of the slab: c[q][j] at k 16 q
// + 4 tq + j, each the code's low wl bits (or a packed triplet word where
// `words`).  bq's bytes, then per row d_r, B2_r (and -I1_r, -I2_r at kind
// 0), then kind 1's -sum neg_r, each plane pw words after the last, the
// column's words at dst (bp + 64 (n / 8) + 4 (n % 8) + tq).  Codes give
// the selectors and bq directly; packed triplet words go through
// selectors().
__device__ __forceinline__ void column_planes(const uint32_t (&c)[2][4],
                                              uint32_t* __restrict__ dst,
                                              int pw, const Op& op,
                                              bool words) {
  const int per = op.kind ? 2 : 4;
  uint32_t sel[2][8];
  if (words) {
    selectors(c[0], sel[0]);
    selectors(c[1], sel[1]);
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t l02 = prmt(c[q][0], c[q][2], 0x5410);
      const uint32_t l13 = prmt(c[q][1], c[q][3], 0x5410);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        sel[q][r] = r < op.R ? code_selector(l02, l13, r) : 0u;
    }
  }
  {
    // bq = sum_{R <= r < wl/2} d_r 2^(2r - vbl): one s8 plane, or u8 + s8
    uint32_t bq[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int v = 0;
        if (words) {
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if (r >= op.R && 2 * r < op.wl)
              v += triplet_digit((c[q][j] >> (4 * r)) & 7u) *
                   (1 << (2 * r - op.vbl));
        } else {
          // the code less its low 2R bits' Booth value, over 2^vbl
          const int sh = 32 - op.wl, lo = 32 - 2 * op.R;
          const int xs = static_cast<int>(c[q][j] << sh) >> sh;
          const int low = op.R ? static_cast<int>(c[q][j] << lo) >> lo : 0;
          v = (xs - low) >> op.vbl;
        }
        bq[q][j] = static_cast<uint32_t>(v);
      }
    put(dst, 0, pw, pack4(bq[0][0], bq[0][1], bq[0][2], bq[0][3]),
        pack4(bq[1][0], bq[1][1], bq[1][2], bq[1][3]));
    if (op.bqb == 2)
      put(dst, 1, pw,
          pack4(bq[0][0] >> 8, bq[0][1] >> 8, bq[0][2] >> 8, bq[0][3] >> 8),
          pack4(bq[1][0] >> 8, bq[1][1] >> 8, bq[1][2] >> 8, bq[1][3] >> 8));
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r >= op.R) break;
    const int pl = op.bqb + r * per;
    const uint32_t s0 = sel[0][r], s1 = sel[1][r];
    put(dst, pl, pw, prmt(kDLo, kDHi, s0), prmt(kDLo, kDHi, s1));
    put(dst, pl + 1, pw, prmt(kB2Lo, kB2Hi, s0), prmt(kB2Lo, kB2Hi, s1));
    if (!op.kind) {
      put(dst, pl + 2, pw, prmt(kI1Lo, kI1Hi, s0), prmt(kI1Lo, kI1Hi, s1));
      put(dst, pl + 3, pw, prmt(kI2Lo, kI2Hi, s0), prmt(kI2Lo, kI2Hi, s1));
    }
  }
  if (op.kind && op.R) {
    // -sum_{r<R} neg_r: a row's sign is code bit 2r + 1, triplet bit 2
    const uint32_t negs =
        words ? 0x44444444u & (op.R >= 8 ? 0xFFFFFFFFu
                                         : (1u << (4 * op.R)) - 1u)
              : 0xAAAAu & ((1u << (2 * op.R)) - 1u);
    uint32_t cn[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cn[q][j] = static_cast<uint32_t>(-__popc(c[q][j] & negs));
    put(dst, op.bqb + op.R * per, pw,
        pack4(cn[0][0], cn[0][1], cn[0][2], cn[0][3]),
        pack4(cn[1][0], cn[1][1], cn[1][2], cn[1][3]));
  }
}

// ------------------------------------------------------ the x side
// x's bytes in fragment order: word w holds row g + 8 (w & 1) of the
// warp's 16 and k 4 t + 16 (w >> 1) .. + 3 (g = lane / 4, t = lane % 4).
// p02 and p13 hold codes 0, 2 and 1, 3 of the word as sign-extended
// 16-bit lanes, q02 and q13 the same shifted right by 8 (each lane's high
// byte, sign-extended), tz the trailing-zero counts as bytes (32 for a
// zero code).
struct XWords {
  uint32_t p02[4], p13[4], q02[4], q13[4], tz[4];
};

// x codes staged as int32 rows (the matmul's slab) or int16 rows (the
// flash kernel's Q and P codes): load4(row, k, v) reads the four codes at
// k .. k + 3 of a row, k a multiple of 4.
struct XInt32 {
  const int* p;
  int stride;
  __device__ __forceinline__ void load4(int row, int k, int (&v)[4]) const {
    const int4 c = *reinterpret_cast<const int4*>(p + row * stride + k);
    v[0] = c.x, v[1] = c.y, v[2] = c.z, v[3] = c.w;
  }
};

struct XInt16 {
  const short* p;
  int stride;
  __device__ __forceinline__ void load4(int row, int k, int (&v)[4]) const {
    const uint2 c = *reinterpret_cast<const uint2*>(p + row * stride + k);
    v[0] = static_cast<int16_t>(c.x);
    v[1] = static_cast<int16_t>(c.x >> 16);
    v[2] = static_cast<int16_t>(c.y);
    v[3] = static_cast<int16_t>(c.y >> 16);
  }
};

// acc += a (the warpgroup's 64 rows) times weight plane `plane` (width N):
// one asynchronous wgmma on a copy `ai` of a, issued once the previous
// one, which read ai, is done; the caller forms the next a meanwhile, and
// waits for the last (drain) before it reads acc or rewrites the planes.
template <int N, bool AS, bool BS>
__device__ __forceinline__ void products(int (&acc)[N / 2], uint32_t (&ai)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t* plane) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  hold(ai);
#pragma unroll
  for (int i = 0; i < 4; ++i) ai[i] = a[i];
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma<N, AS, BS>(acc, ai, plane_desc(plane));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void drain(int (&lo)[R], int (&hi)[R],
                                      uint32_t (&ai)[4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  hold(ai);
  hold(lo);
  hold(hi);
}

// A staged slab's products into lo and hi at width N (planes 8 N words
// apart, laid out as form_weights lays them): warp w takes rows [16 w, 16
// w + 16) of the block and all N columns, so each x byte is formed once a
// block.  Only the slab's k in [klo, khi) take part: x's codes outside
// read as 0 (a product of code 0 is 0 at kind 0) and the ones plane
// counts only that window, so a chunk that ends inside a slab is two
// windows of one staged slab.
template <int N, class X>
__device__ __forceinline__ void warp_slab_n(const X& xs,
                                            const uint32_t* __restrict__ bp,
                                            const Op& op, int klo, int khi,
                                            int (&lo)[N / 2],
                                            int (&hi)[N / 2]) {
  constexpr int pw = 8 * N;       // words per plane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool full = klo == 0 && khi == kBK;
  const int sh = 32 - op.wl;
  XWords xw;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int row = warp * 16 + g + 8 * (w & 1);
    const int kq = 4 * t + 16 * (w >> 1);
    int v[4];
    xs.load4(row, kq, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = static_cast<int>(static_cast<uint32_t>(v[j]) << sh) >> sh;
      if (!full && (kq + j < klo || kq + j >= khi)) v[j] = 0;
    }
    xw.p02[w] = prmt(v[0], v[2], 0x5410);
    xw.p13[w] = prmt(v[1], v[3], 0x5410);
    xw.q02[w] = prmt(xw.p02[w], xw.p02[w], 0xB391);
    xw.q13[w] = prmt(xw.p13[w], xw.p13[w], 0xB391);
    if (!op.kind)
      xw.tz[w] = pack4(__clz(__brev(v[0])), __clz(__brev(v[1])),
                       __clz(__brev(v[2])), __clz(__brev(v[3])));
  }
  uint32_t a[4], ai[4] = {0u, 0u, 0u, 0u};
  // a[w] = f(word w) over the warp's fragment
  auto frag = [&](auto f) {
#pragma unroll
    for (int w = 0; w < 4; ++w) a[w] = f(w);
  };
  const int per = op.kind ? 2 : 4;
  {
    // x bq: x's bytes against bq's (two significances at most)
    frag([&](int w) { return field(xw.p02[w], xw.p13[w], 0); });
    if (op.xb == 1 && op.bqb == 1) {
      products<N, true, true>(lo, ai, a, bp);
    } else if (op.xb == 1) {
      products<N, true, false>(lo, ai, a, bp);
      products<N, true, true>(hi, ai, a, bp + pw);
    } else {
      products<N, false, true>(lo, ai, a, bp);
      frag([&](int w) { return field(xw.q02[w], xw.q13[w], 0); });
      products<N, true, true>(hi, ai, a, bp);
    }
  }
  const uint32_t* row0 = bp + op.bqb * pw;
#pragma unroll 1
  for (int r = 0; r < op.R; ++r) {
    const int m = op.vbl - 2 * r;
    const uint32_t* pl = row0 + r * per * pw;
    // (x >> m) d_r
    if (signed_bytes(op.wl - 1 - m) == 1) {
      if (m <= 8)
        frag([&](int w) { return field(xw.p02[w], xw.p13[w], m); });
      else
        frag([&](int w) { return field(xw.q02[w], xw.q13[w], m - 8); });
      products<N, true, true>(lo, ai, a, pl);
    } else {
      frag([&](int w) { return field(xw.p02[w], xw.p13[w], m); });
      products<N, false, true>(lo, ai, a, pl);
      frag([&](int w) { return field(xw.q02[w], xw.q13[w], m); });
      products<N, true, true>(hi, ai, a, pl);
    }
    // b_r B2_r
    frag([&](int w) { return bit_bytes(xw.p02[w], xw.p13[w], m - 1); });
    products<N, false, true>(lo, ai, a, pl + pw);
    if (!op.kind) {
      frag([&](int w) { return nonzero_low(xw.tz[w], m); });
      products<N, false, true>(lo, ai, a, pl + 2 * pw);
      frag([&](int w) { return nonzero_low(xw.tz[w], m - 1); });
      products<N, false, true>(lo, ai, a, pl + 3 * pw);
    }
  }
  if (op.kind && op.R) {
    // the ones plane: 1 for each k of the window
    frag([&](int w) {
      const int kq = 4 * t + 16 * (w >> 1);
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kq + j >= klo && kq + j < khi) v |= 1u << (8 * j);
      return v;
    });
    products<N, false, true>(lo, ai, a, row0 + op.R * per * pw);
  }
  drain(lo, hi, ai);
}

}  // namespace bbm_mma
