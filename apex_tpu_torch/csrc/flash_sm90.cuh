// The Hopper (sm_90a) pieces the flash-attention kernels share:
// flash_attention_sm90.cu (the forward) and flash_attention_bwd_sm90.cu
// (dQ and dK/dV).  TMA loads and stores of the [B, T, H, D] views and the
// fp32 [B, T, S] bias, the `wgmma.mma_async` forms the kernels issue
// (fp32 accumulators; S-type products with both operands K-major in
// shared memory, P V-type products with A in registers and B MN-major
// through the transpose bit), rounding two floats into one register of
// the input type, and on the host the tensor maps of those views,
// encoded through sm90::map_nd's cache.  Helpers only: no kernel, no
// entry point.
//
// Layouts are sm90.cuh's: a tile of [rows][D] elements is D / 64 panels
// of [rows][64] (128 bytes a row), the 16-byte chunk c of row r stored at
// chunk c ^ (r & 7), each panel 1024-byte aligned; a K-major operand's
// k-step (16 elements) moves 32 bytes inside a panel, an MN-major one's
// 16 rows (2048 bytes), and the stride from one 64-wide panel of N to the
// next is the LBO.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace flash_sm90 {

using sm90::smem_u32;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int PANEL = 64;            // elements in a 128-byte swizzled row

// -- copies ----------------------------------------------------------------------

// TMA: a box of the tensor at coordinates (c0 innermost, ...) into shared
// memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// -- arithmetic ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to T, the first in the low half (the lower column)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo,
                                                               float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(
    float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo,
                                                              float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- wgmma.mma_async, m64nNk16 with fp32 accumulators ---------------------------
// SS: A (64 x 16) and B (16 x N) both K-major in shared memory, N = 32, 64,
// 96, 128, 160; RS: A (64 x 16) in registers (the accumulator layout's rows
// packed by pack2), B (16 x N) MN-major in shared memory through the
// transpose bit, N = 64, 128.  scale_d 0 starts a fresh sum (d is only
// written), 1 adds to d.

#define APEX_FLASH_SS_N32(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15}, " \
  "%16, %17, p, 1, 1, 0, 0;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
  : "l"(da), "l"(db), "r"(scale_d))

#define APEX_FLASH_SS_N64(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}, " \
  "%32, %33, p, 1, 1, 0, 0;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
  : "l"(da), "l"(db), "r"(scale_d))

#define APEX_FLASH_SS_N96(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47}, " \
  "%48, %49, p, 1, 1, 0, 0;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
    "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]) \
  : "l"(da), "l"(db), "r"(scale_d))

#define APEX_FLASH_SS_N128(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}, " \
  "%64, %65, p, 1, 1, 0, 0;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
    "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
  : "l"(da), "l"(db), "r"(scale_d))

#define APEX_FLASH_SS_N160(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79}, " \
  "%80, %81, p, 1, 1, 0, 0;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
    "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
    "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
    "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
    "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
    "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]) \
  : "l"(da), "l"(db), "r"(scale_d))

#define APEX_FLASH_RS_N64(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}, " \
  "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define APEX_FLASH_RS_N128(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}, " \
  "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
    "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_FLASH_SS_N32("bf16");
  else
    APEX_FLASH_SS_N32("f16");
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_FLASH_SS_N64("bf16");
  else
    APEX_FLASH_SS_N64("f16");
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_FLASH_SS_N96("bf16");
  else
    APEX_FLASH_SS_N96("f16");
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_FLASH_SS_N128("bf16");
  else
    APEX_FLASH_SS_N128("f16");
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[80], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_FLASH_SS_N160("bf16");
  else
    APEX_FLASH_SS_N160("f16");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_FLASH_RS_N64("bf16");
  else
    APEX_FLASH_RS_N64("f16");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_FLASH_RS_N128("bf16");
  else
    APEX_FLASH_RS_N128("f16");
}

// -- host: tensor maps -----------------------------------------------------------

// A map of the [B, T, H, D] view at `ptr` (strides in elements) as the
// tensor [d, T, H, B], its box 64 columns by `rows` rows of one head, the
// 128-byte swizzle.  A dimension of size 1 takes the stride of one packed
// after the dimension before it (its coordinate is always 0), so that a
// size-1 dimension's arbitrary stride meets TMA's rules.
inline bool map_bthd(CUtensorMap* m, CUtensorMapDataType ty, const void* ptr,
                     int d, int t, int h, int b, int64_t st, int64_t sh,
                     int64_t sb, int rows) {
  sm90::MapKeyNd key{};
  key.ptr = ptr;
  key.rank = 4;
  key.type = static_cast<int>(ty);
  key.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  key.dims[0] = static_cast<uint64_t>(d);
  key.dims[1] = static_cast<uint64_t>(t);
  key.dims[2] = static_cast<uint64_t>(h);
  key.dims[3] = static_cast<uint64_t>(b);
  int64_t s[3] = {st, sh, sb};
  int64_t prev_stride = 1, prev_size = d;
  for (int i = 0; i < 3; ++i) {
    if (key.dims[i + 1] == 1) s[i] = prev_stride * prev_size;
    prev_stride = s[i];
    prev_size = static_cast<int64_t>(key.dims[i + 1]);
    key.strides[i] = static_cast<uint64_t>(s[i]) * 2;
  }
  key.box[0] = PANEL;
  key.box[1] = static_cast<uint32_t>(rows);
  key.box[2] = key.box[3] = 1;
  return sm90::map_nd(m, key);
}

// The fp32 [B, T, S] bias at `bias` (strides sb_b, sb_t in elements, the
// last 1) as the tensor [S, T, B] (one batch row when its batch stride is
// 0: broadcast), boxes of 32 keys by `rows` rows.
inline bool map_bias(CUtensorMap* m, const float* bias, int b, int tq,
                     int tk, int64_t sb_b, int64_t sb_t, int rows) {
  sm90::MapKeyNd key{};
  key.ptr = bias;
  key.rank = 3;
  key.type = static_cast<int>(CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  key.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t nb = sb_b != 0 ? static_cast<uint64_t>(b) : 1;
  key.dims[0] = static_cast<uint64_t>(tk);
  key.dims[1] = static_cast<uint64_t>(tq);
  key.dims[2] = nb;
  const int64_t sb = nb == 1 ? sb_t * tq : sb_b;
  key.strides[0] = static_cast<uint64_t>(sb_t) * 4;
  key.strides[1] = static_cast<uint64_t>(sb) * 4;
  key.box[0] = 32;
  key.box[1] = static_cast<uint32_t>(rows);
  key.box[2] = 1;
  return sm90::map_nd(m, key);
}

}  // namespace flash_sm90
