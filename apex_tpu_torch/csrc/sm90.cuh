// Hopper (sm_90a) building blocks shared by flash_attention_sm90.cu,
// flash_attention_bwd_sm90.cu, quant_sm90.cu and conv_sm90.cu: `mbarrier`s,
// TMA loads under tensor maps, `wgmma` shared-memory descriptors and the
// `wgmma.mma_async` forms qmm and the conv kernels issue, and the host's
// tensor-map encoding with a cache.
// Helpers only: no kernel, no entry point.
//
// Layouts (CUTLASS's canonical GMMA forms, `cute/atom/mma_traits_sm90_gmma.hpp`):
//  * K-major with the 128-byte swizzle: an operand tile is [rows][128 bytes]
//    (64 bf16 / fp16 or 128 int8 values of K a row), the 16-byte chunk c of
//    row r stored at chunk c ^ (r & 7), the tile 1024-byte aligned; its
//    descriptor has SBO 1024 (eight rows) and a start that moves 32 bytes a
//    K step of `wgmma` (16 bf16 or 32 int8 values).  TMA's
//    CU_TENSOR_MAP_SWIZZLE_128B writes exactly this from a box 128 bytes
//    wide.
//  * MN-major with the 128-byte swizzle (bf16 / fp16 only, through the
//    instruction's transpose bit): panels of [K rows][64 values of N], each
//    row 128 bytes swizzled as above; SBO 1024 (eight K rows), LBO the
//    stride from one 64-wide panel of N to the next, and the start moves 16
//    rows (2048 bytes) a K step.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace sm90 {

constexpr int SMEM_OPTIN = 232448;   // a block's opt-in shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `c` of row `r` in a 128-byte-swizzled tile
__host__ __device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// -- mbarriers -------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed.  A wait
// longer than ~10 s traps (a fault, not a hang of the card).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  uint64_t t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (uint32_t spins = 1;; ++spins) {
    if (mbar_try(bar, parity)) return;
    if ((spins & 1023) == 0) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (t - t0 > 10000000000ull) __trap();
    }
  }
}

// -- copies ----------------------------------------------------------------------

// TMA: the 2-D box at coordinates (c0 innermost, c1) into shared memory,
// its bytes counted on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the map into the TMA unit's descriptor cache ahead of its first load
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !ok (source
// size 0: nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's generic-proxy writes to shared memory (stores, cp.async)
// made visible to the async proxy (`wgmma` operand reads, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a named barrier of `threads` threads (ids 1..15; 0 is __syncthreads')
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- wgmma -----------------------------------------------------------------------

// A shared-memory matrix descriptor of `wgmma`: the 128-byte swizzle,
// `lbo` and `sbo` in bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers
// across the `wgmma` issue and wait around them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d += A B, int8 x int8 -> int32: A (64 x 32) and B (32 x 128), both
// K-major in shared memory (the only majorness integer `wgmma` takes)
#define APEX_WGMMA_S8_N128() \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}, " \
  "%64, %65, p;\n}\n" \
  : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), \
    "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
    "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), \
    "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), \
    "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
    "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
    "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
    "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), \
    "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
    "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), \
    "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
    "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
    "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]) \
  : "l"(da), "l"(db), "r"(1))

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  APEX_WGMMA_S8_N128();
}

// d += A B, bf16 or fp16 -> fp32: A (64 x 16) and B (16 x N), both in
// shared memory, each K-major (transpose bit 0) or MN-major (bit 1: 16-bit
// types only), the bits TA and TB immediates of the instruction
#define APEX_WGMMA_SS_N128(TY) \
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
  "%64, %65, p, 1, 1, %67, %68;\n}\n" \
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
  : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

#define APEX_WGMMA_SS_N64(TY) \
  asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}, " \
  "%32, %33, p, 1, 1, %35, %36;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
  : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB))

// TA, TB: A's and B's transpose bits (0 K-major, 1 MN-major).  The conv
// forward takes (0, 1), dgrad (0, 0) and wgrad (1, 1).
template <bool BF16, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  if constexpr (BF16) APEX_WGMMA_SS_N128("bf16");
  else APEX_WGMMA_SS_N128("f16");
}
template <bool BF16, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  if constexpr (BF16) APEX_WGMMA_SS_N64("bf16");
  else APEX_WGMMA_SS_N64("f16");
}

// -- host: tensor maps -----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime,
// so the library links no libcuda; null where it is missing.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// What a map of rank <= 4 encodes: the tensor at `ptr` with `dims`
// (innermost first), byte `strides` between the entries of dims 1 ..
// rank - 1, read in boxes of `box`, under `swizzle`.  A map is a function
// of these alone, so one encoded for a key serves every later call with
// that key (the same weight, or a buffer at an address seen before),
// whatever tensor lies there now.  Unused entries are 0.
struct MapKeyNd {
  const void* ptr;
  uint64_t dims[4];
  uint64_t strides[3];
  uint32_t box[4];
  int rank, type, swizzle;
  bool operator==(const MapKeyNd& o) const {
    if (ptr != o.ptr || rank != o.rank || type != o.type ||
        swizzle != o.swizzle)
      return false;
    for (int i = 0; i < 4; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i]) return false;
    for (int i = 0; i < 3; ++i)
      if (strides[i] != o.strides[i]) return false;
    return true;
  }
};

// The map of `key`, encoded on first use and kept in a small table
// (an eager call then pays no encode for a weight or a view it has seen);
// false when cuTensorMapEncodeTiled refuses it (TMA's rules: 16-byte
// aligned start, strides multiples of 16 bytes).  Thread-safe: the
// Python threads of one process may launch at once (ctypes drops the
// GIL).
inline bool map_nd(CUtensorMap* out, const MapKeyNd& key) {
  constexpr int SLOTS = 256;
  static std::mutex lock;
  static MapKeyNd keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static bool used[SLOTS] = {};
  static int next = 0;
  {
    std::lock_guard<std::mutex> g(lock);
    for (int i = 0; i < SLOTS; ++i)
      if (used[i] && keys[i] == key) {
        *out = maps[i];
        return true;
      }
  }
  if (encode_tiled() == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUtensorMap m;
  if (encode_tiled()(&m, static_cast<CUtensorMapDataType>(key.type),
                     key.rank, const_cast<void*>(key.ptr), key.dims,
                     key.strides, key.box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     static_cast<CUtensorMapSwizzle>(key.swizzle),
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  std::lock_guard<std::mutex> g(lock);
  keys[next] = key;
  maps[next] = m;
  used[next] = true;
  next = (next + 1) % SLOTS;
  *out = m;
  return true;
}

// A 2-D map: the row-major [rows, cols] tensor at `ptr` with `row_bytes`
// between rows, read in boxes of box_cols x box_rows.
struct MapKey {
  const void* ptr;
  uint64_t rows, cols, row_bytes;
  uint32_t box_cols, box_rows;
  int type, swizzle;
};

inline bool map_2d(CUtensorMap* out, const MapKey& k) {
  MapKeyNd key{};
  key.ptr = k.ptr;
  key.rank = 2;
  key.type = k.type;
  key.swizzle = k.swizzle;
  key.dims[0] = k.cols;
  key.dims[1] = k.rows;
  key.strides[0] = k.row_bytes;
  key.box[0] = k.box_cols;
  key.box[1] = k.box_rows;
  return map_nd(out, key);
}

}  // namespace sm90
