// Flash-attention forward for Hopper (sm_90a) on `wgmma` and TMA, plain C
// interface.
//
// Replaces, for bf16 / fp16 prefill and training (q_len >= 16) at the
// instantiated head widths 64 and 128, the Pallas TPU kernel
// apex_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_flash_fwd_pallas`).  It computes the function of flash_attention.cu's
// header, lines 8-25, unchanged: the same scores, masks, biases, GQA
// heads, fp32 (m, l, acc), p rounded to the value dtype before the PV
// product, out 0 and lse NEG_INF for a row that sees no key, lse
// [B, H, T] fp32; `_flash_fwd_ref` (apex_tpu_torch/ops/flash_attention.py)
// is its plain version.  A head narrower than the instantiation (48 in
// 64) reads its missing columns as zero (TMA's out-of-bounds fill) and
// never stores them (the store's box is clipped at d).
//
// What bounds it on the H100: ~4 T S H D operations (half under causal)
// against ~(2 T + 2 S) H D bytes, so the tensor cores, at 989 TFLOP/s for
// bf16 and fp16, which only `wgmma` reaches; at width 64 the softmax's
// exponentials (16 a cycle an SM) come as close as the products.  The
// `mma.sync` kernel of flash_attention.cu ran 2.4-3.0x SDPA there.  Here:
//  * Loads are TMA (`cp.async.bulk.tensor`) under `CUtensorMap`s that the
//    launcher encodes from the Params strides, so a [B, T, H, D] view is
//    read in place (a fused projection's strided q, k, v included), and
//    into the 128-byte swizzle that is `wgmma`'s operand layout: a tile is
//    D / 64 panels of [rows][64] elements, 128 bytes a row.  Completion is
//    counted by `mbarrier`s.  The maps are `__grid_constant__` kernel
//    parameters, so a CUDA graph holds them: a captured call's buffers do
//    not move.  TMA's rules (16-byte aligned bases, strides multiples of
//    16 bytes) are the wrapper's routing rule (`_tma_ok`); a map that
//    cuTensorMapEncodeTiled refuses fails the launch, nothing falls back.
//  * A block is NC consumer warpgroups of 64 query rows each (BQ = 64 NC)
//    and one producer warp, of which one thread issues the loads: Q once,
//    then K, V (and the [B, T, S] bias tile) into a 2-stage ring, each
//    stage gated by a full and an empty barrier.  ptxas allocates the
//    consumers within the launch's register count whatever `setmaxnreg`
//    asks (a consumer that needs more spills), so the producer is one
//    warp rather than a warpgroup whose registers `setmaxnreg` would hand
//    over, and the blocks an SM are set for the registers a consumer
//    needs (`Tile::MIN_BLOCKS`): three 64-row blocks an SM at width 64.
//  * A consumer warpgroup computes S = Q K^T with `wgmma.mma_async`, A and
//    B from shared memory (K-major, no transpose), m64nBK: BK / 2 fp32
//    scores a thread in FA2's row layout (a thread holds parts of rows g
//    and g + 8 of its warp's 16), so the online softmax runs in registers,
//    in fp32, in the base-2 domain (one FFMA and one ex2 an element, no
//    branch an element: branches for the biases and the band per element
//    would bind it to instruction issue), the row max and sum over a
//    row's four lanes by two shuffles.  O += P V is `wgmma` with P
//    (rounded to V's dtype) as the register A operand, straight from the
//    score registers, and V the shared-memory B operand through the
//    transpose bit (bf16 and fp16 allow it).  The softmax of one
//    warpgroup overlaps the products of the others on its SM (three
//    blocks an SM at width 64, two warpgroups a block at 128); issuing
//    tile j's scores with tile j - 1's P V inside one warpgroup is slower
//    here: its registers spill at three blocks an SM.
//  * The epilogue writes O, rounded, into the warpgroup's own rows of the
//    Q tile in the swizzled layout and stores it by TMA; lse by the rows'
//    first lanes.
//  * Tiles wholly outside the causal or sliding-window band of the block
//    are never loaded (loop bounds); a warpgroup skips the products of a
//    tile outside its own rows' band.  Query tiles are issued longest
//    first.
// The tiles (block_q, block_k): 64 x 96, 128 x 96, 64 x 160, 128 x 160;
// the rule (`rule_tile` in the wrapper) is 64 x 96 at width 64 and
// 128 x 96 at 128.

#include <cuda.h>   // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

// 0 builds the rule's tiles only (block_k 96)
#ifndef APEX_FLASH_TUNE_TILES
#define APEX_FLASH_TUNE_TILES 1
#endif

// Field order and types mirror flash_attention.cu's Params and the ctypes
// Structure in apex_tpu_torch/ops/flash_attention.py (_FlashParams).
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* kbias;   // [B, S] fp32 or null
  const float* bias;    // [B, T, S] fp32 (last stride 1) or null
  void* out;
  float* lse;           // [B, H, T] fp32, contiguous
  float* part_o;        // decode only: unused here
  float* part_ml;
  int64_t sq_b, sq_t, sq_h;
  int64_t sk_b, sk_t, sk_h;
  int64_t sv_b, sv_t, sv_h;
  int64_t so_b, so_t, so_h;
  int64_t skb_b;
  int64_t sb_b, sb_t;
  int32_t B, H, Hkv, tq, tk;
  int32_t causal, q_offset, window;   // window 0 = none
  int32_t d;            // the head width (<= the instantiated width)
  int32_t vec;
  int32_t splits, chunk;
  int32_t bvec;
  float sm_scale;
};

// The tensor maps of one launch, passed by value as a __grid_constant__
// parameter (each CUtensorMap is 64-byte aligned).
struct Maps {
  CUtensorMap q, k, v, o, bias;
};

namespace {

using namespace sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int STAGES = 2;            // the K / V ring (3 measured no faster)
constexpr int PANEL = 64;            // elements in a 128-byte swizzled row


// -- PTX helpers -----------------------------------------------------------------

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

// The key range rows [q0, q_last] can see (the causal / window band).
__device__ __forceinline__ void key_band(const Params& p, int q0, int q_last,
                                         int& k_begin, int& k_end) {
  k_begin = 0;
  k_end = p.tk;
  if (p.causal) {
    k_end = min(p.tk, p.q_offset + q_last + 1);
    if (p.window > 0) k_begin = max(0, p.q_offset + q0 - p.window + 1);
  }
}

// -- wgmma.mma_async, m64nNk16 with fp32 accumulators ---------------------------
// (N = 96 and 160 for the scores, 64 and 128 for O)

#define APEX_WGMMA_SS_N96(TY) \
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

// d (+)= A B: A (64 x 16) and B (16 x 96) K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_WGMMA_SS_N96("bf16");
  else
    APEX_WGMMA_SS_N96("f16");
}

#define APEX_WGMMA_SS_N160(TY) \
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

// d (+)= A B: A (64 x 16) and B (16 x 160) K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[80], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_WGMMA_SS_N160("bf16");
  else
    APEX_WGMMA_SS_N160("f16");
}

#define APEX_WGMMA_RS_N64(TY) \
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
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d += A B: A (64 x 16) in registers, B (16 x 64) MN-major in shared
// memory (the transpose bit)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_WGMMA_RS_N64("bf16");
  else
    APEX_WGMMA_RS_N64("f16");
}

#define APEX_WGMMA_RS_N128(TY) \
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
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d += A B: A (64 x 16) in registers, B (16 x 128) MN-major in shared
// memory (the transpose bit)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    APEX_WGMMA_RS_N128("bf16");
  else
    APEX_WGMMA_RS_N128("f16");
}


// -- the kernel ------------------------------------------------------------------

// Shared memory of a block: Q (D / 64 swizzled panels of BQ rows), the K
// and V rings, the fp32 bias ring (BK / 32 swizzled boxes of [BQ][32]
// floats a stage) when there is a bias, then the barriers; every tile
// 1024-byte aligned (the swizzle's period), plus 1024 bytes to align the
// base.  Registers: ptxas 12.9 allocates the consumers within the
// launch's count (65536 over the block's threads times MIN_BLOCKS) even
// past a `setmaxnreg.inc` (a consumer then spills), so the producer is one
// warp, not a warpgroup whose registers `setmaxnreg` would hand back, and
// MIN_BLOCKS is the most blocks an SM whose count still holds a
// consumer's S, O and P: 3 (136 registers) at width 64 by 96 keys, 1
// (255) at 128 by 160, else 2 (204) for one consumer warpgroup; 1 (224)
// for two.
template <int D, int NC, int BK>
struct Tile {
  static constexpr int BQ = 64 * NC;
  static constexpr int THREADS = NC * 128 + 32;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one stage of K (or V)
  static constexpr int B_BYTES = BQ * BK * 4;   // one stage of the bias
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BIAS = OFF_V + STAGES * KV_BYTES;
  static constexpr int MIN_BLOCKS =
      NC == 2 ? 1
              : (D == 64 && BK == 96 ? 3 : (D == 128 && BK == 160 ? 1 : 2));
  __host__ __device__ static constexpr int off_bar(bool bias) {
    return OFF_BIAS + (bias ? STAGES * B_BYTES : 0);
  }
  __host__ __device__ static constexpr int bytes(bool bias) {
    return off_bar(bias) + 64 + 1024;
  }
};

// The producer's one thread: Q once, then the K and V tiles (and the
// bias's) of the block's band into the ring.
template <typename T, int D, int NC, int BK>
__device__ __forceinline__ void produce(const Maps& maps, const Params& p,
                                        T* Qs, T* Ks, T* Vs, float* Bs,
                                        uint32_t full0, uint32_t empty0,
                                        uint32_t qbar, int q0, int h, int b,
                                        int k_begin, int n_tiles) {
  using L = Tile<D, NC, BK>;
  constexpr int BQ = L::BQ, NP = D / PANEL;
  const bool has_bias = p.bias != nullptr;
  const int hk = h / (p.H / p.Hkv);
  if (n_tiles > 0) {
    prefetch_map(&maps.k);
    prefetch_map(&maps.v);
    if (has_bias) prefetch_map(&maps.bias);
    mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
      tma_load_4d(Qs + pn * BQ * PANEL, &maps.q, qbar, pn * PANEL, q0, h, b);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(empty0 + 8 * s, ((j / STAGES) - 1) & 1);
    const int k0 = k_begin + j * BK;
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, 2 * L::KV_BYTES + (has_bias ? L::B_BYTES : 0));
    T* ks = Ks + s * BK * D;
    T* vs = Vs + s * BK * D;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn) {
      tma_load_4d(ks + pn * BK * PANEL, &maps.k, full, pn * PANEL, k0, hk, b);
      tma_load_4d(vs + pn * BK * PANEL, &maps.v, full, pn * PANEL, k0, hk, b);
    }
    if (has_bias) {
#pragma unroll
      for (int i = 0; i < BK / 32; ++i)
        tma_load_3d(Bs + s * BQ * BK + i * BQ * 32, &maps.bias, full,
                    k0 + 32 * i, q0, p.sb_b != 0 ? b : 0);
    }
  }
}

// Consumer warpgroup c: rows [q0 + 64 c, q0 + 64 c + 64) over the ring's
// tiles, then its part of the output and lse.
template <typename T, int D, int NC, int BK>
__device__ __forceinline__ void consume(const Maps& maps, const Params& p,
                                        T* Qs, T* Ks, T* Vs, float* Bs,
                                        uint32_t full0, uint32_t empty0,
                                        uint32_t qbar, int q0, int h, int b,
                                        int k_begin, int n_tiles, int wg) {
  using L = Tile<D, NC, BK>;
  constexpr int BQ = L::BQ, NP = D / PANEL;
  const bool has_bias = p.bias != nullptr;
  const int c = wg, tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw0 = q0 + 64 * c;
  const int qw_last = min(qw0 + 63, p.tq - 1);
  const bool rows = qw0 < p.tq;
  int wk_begin, wk_end;                      // this warpgroup's band
  key_band(p, qw0, qw_last, wk_begin, wk_end);
  const float scale2 = p.sm_scale * LOG2E;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const int row0 = qw0 + warp * 16 + g;      // rows row0 and row0 + 8
  const int brow = c * 64 + warp * 16 + g;   // the same in the block tile
  const uint32_t q_addr = smem_u32(Qs) + c * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    const int k0 = k_begin + j * BK;
    if (rows && k0 < wk_end && k0 + BK > wk_begin) {
      const uint32_t k_addr = smem_u32(Ks + s * BK * D);
      const uint32_t v_addr = smem_u32(Vs + s * BK * D);

      // S = Q K^T: 64 rows x BK keys, D / 16 k-steps
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T>(sc,
                    gmma_desc(q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32,
                              16, 1024),
                    gmma_desc(k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32,
                              16, 1024),
                    kk);
      wgmma_commit_wait();
      fence_regs(sc);

      // scale, biases and the band, in base 2; element 4 n + r is row
      // row0 + 8 (r >> 1), key k0 + 8 n + 2 t4 + (r & 1).  A tile inside
      // the band with no bias (most tiles) takes the max of the raw
      // scores and folds the scale into the exponent's FFMA; any other
      // adds its biases and masks in whole-tile passes, without branches
      // per element.
      const bool edge =
          k0 + BK > p.tk ||
          (p.causal &&
           (k0 + BK - 1 > p.q_offset + qw0 ||
            (p.window > 0 && p.q_offset + qw_last - k0 >= p.window)));
      const bool plain =
          !edge && kb == nullptr && !has_bias && scale2 > 0.f;
      float fold = 1.f;   // the scale still to apply in the exponent
      if (plain) {
        fold = scale2;
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= scale2;
        if (kb != nullptr) {
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            const int key0 = k0 + n * 8 + 2 * t4;
            const float a0 = kb[min(key0, p.tk - 1)] * LOG2E;
            const float a1 = kb[min(key0 + 1, p.tk - 1)] * LOG2E;
            sc[4 * n] += a0;
            sc[4 * n + 1] += a1;
            sc[4 * n + 2] += a0;
            sc[4 * n + 3] += a1;
          }
        }
        if (has_bias) {
          const float* bt = Bs + s * BQ * BK;
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            const int kl = n * 8 + 2 * t4;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              // box kl / 32, row brow + 8 hh, its 16-byte chunk swizzled
              // by the row (brow & 7 == g)
              const float2 bb = *reinterpret_cast<const float2*>(
                  bt + (kl / 32) * BQ * 32 + (brow + 8 * hh) * 32 +
                  ((((kl % 32) >> 2) ^ g) << 2) + (kl & 3));
              sc[4 * n + 2 * hh] = fmaf(bb.x, LOG2E, sc[4 * n + 2 * hh]);
              sc[4 * n + 2 * hh + 1] =
                  fmaf(bb.y, LOG2E, sc[4 * n + 2 * hh + 1]);
            }
          }
        }
        if (edge) {
          const int tk = p.tk, win = p.window;
          const bool causal = p.causal != 0;
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int key = k0 + n * 8 + 2 * t4 + (r & 1);
              const int qpos = p.q_offset + row0 + 8 * (r >> 1);
              const bool vis =
                  (key < tk) & (!causal | ((key <= qpos) &
                                           ((win <= 0) | (qpos - key < win))));
              sc[4 * n + r] = vis ? sc[4 * n + r] : -INFINITY;
            }
          }
        }
      }
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
      float alpha[2], mu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        const float m_new = fmaxf(m2[i], mt[i] * fold);
        mu[i] = m_new == -INFINITY ? 0.f : m_new;   // a row hidden so far
        alpha[i] = ex2(m2[i] - mu[i]);
        m2[i] = m_new;
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], fold, -mu[(i >> 1) & 1]));
        ls[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }

      // O += P V: p rounded to the value dtype into the A fragments
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack2<T>(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<T>(o, pa[kk],
                    gmma_desc(v_addr + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit_wait();
      fence_regs(o);
    }
    // the warpgroup's products on stage s are complete (its `wgmma`
    // wait): one arrival a warpgroup frees the stage
    if (tw == 0) mbar_arrive(empty0 + 8 * s);
  }

  // -- the epilogue: O through the warpgroup's rows of the Q tile ----------
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
    const int r = c * 64 + warp * 16 + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(Qs + (n / 8) * BQ * PANEL + r * PANEL +
                                   (((n % 8) ^ g) << 3) + 2 * t4) =
          pack2<T>(o[4 * n + 2 * hh] * inv, o[4 * n + 2 * hh + 1] * inv);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  if (tw == 0 && rows) {
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
      tma_store_4d(&maps.o, Qs + pn * BQ * PANEL + c * 64 * PANEL,
                   pn * PANEL, qw0, h, b);
    tma_store_commit_wait();
  }
  if (t4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row < p.tq)
        p.lse[(static_cast<int64_t>(b) * p.H + h) * p.tq + row] =
            l[hh] > 0.f ? m2[hh] * LN2 + logf(l[hh]) : NEG_INF;
    }
  }
}

template <typename T, int D, int NC, int BK>
__global__ void __launch_bounds__(Tile<D, NC, BK>::THREADS,
                                  Tile<D, NC, BK>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = Tile<D, NC, BK>;
  static_assert(D % PANEL == 0 && BK % 32 == 0, "tile");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);        // later the output tile
  T* Ks = reinterpret_cast<T*>(base + L::OFF_K);
  T* Vs = reinterpret_cast<T*>(base + L::OFF_V);
  float* Bs = reinterpret_cast<float*>(base + L::OFF_BIAS);
  const uint32_t full0 = smem_u32(base + L::off_bar(p.bias != nullptr));
  const uint32_t empty0 = full0 + 8 * STAGES, qbar = empty0 + 8 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * L::BQ;   // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_last = min(q0 + L::BQ, p.tq) - 1;
  int k_begin, k_end;
  key_band(p, q0, q_last, k_begin, k_end);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC);   // a warpgroup's first thread
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warps 0 .. 4 NC - 1 consume, warp 4 NC produces (one thread)
  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    if (threadIdx.x == NC * 128)
      produce<T, D, NC, BK>(maps, p, Qs, Ks, Vs, Bs, full0, empty0, qbar, q0,
                            h, b, k_begin, n_tiles);
  } else {
    consume<T, D, NC, BK>(maps, p, Qs, Ks, Vs, Bs, full0, empty0, qbar, q0, h,
                          b, k_begin, n_tiles, wg);
  }
}

// -- launchers -----------------------------------------------------------------

// A map of the [B, T, H, D] view at `ptr` (strides in elements) as the
// tensor [d, T, H, B], its box 64 columns by `rows` rows of one head, the
// 128-byte swizzle.  A dimension of size 1 takes the stride of one packed
// after the dimension before it (its coordinate is always 0), so that a
// size-1 dimension's arbitrary stride meets TMA's rules.
bool map_bthd(CUtensorMap* m, CUtensorMapDataType ty, const void* ptr, int d,
              int t, int h, int b, int64_t st, int64_t sh, int64_t sb,
              int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  int64_t s[3] = {st, sh, sb};
  int64_t prev_stride = 1, prev_size = d;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) s[i] = prev_stride * prev_size;
    prev_stride = s[i];
    prev_size = static_cast<int64_t>(dims[i + 1]);
  }
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s[0]) * 2,
                                 static_cast<cuuint64_t>(s[1]) * 2,
                                 static_cast<cuuint64_t>(s[2]) * 2};
  const cuuint32_t box[4] = {PANEL, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(m, ty, 4, const_cast<void*>(ptr), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The fp32 [B, T, S] bias as the tensor [S, T, B] (one batch row when its
// batch stride is 0: broadcast), boxes of 32 keys by `rows` rows.
bool map_bias(CUtensorMap* m, const Params& p, int rows) {
  const cuuint64_t nb = p.sb_b != 0 ? static_cast<cuuint64_t>(p.B) : 1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.tk),
                              static_cast<cuuint64_t>(p.tq), nb};
  const int64_t sb = nb == 1 ? p.sb_t * p.tq : p.sb_b;
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(p.sb_t) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(p.bias), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tile whose stages (with the bias's, when there is one) do not fit a
// block's shared memory is refused.  `check`: only say whether the launch
// would be taken.
template <typename T, int D, int NC, int BK>
cudaError_t launch_wgmma(const Params& p, cudaStream_t st, bool check) {
  using L = Tile<D, NC, BK>;
  const int smem = L::bytes(p.bias != nullptr);
  if (smem > SMEM_OPTIN) return cudaErrorInvalidValue;
  if (check) return cudaSuccess;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType ty = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  Maps maps{};
  const bool ok =
      map_bthd(&maps.q, ty, p.q, p.d, p.tq, p.H, p.B, p.sq_t, p.sq_h, p.sq_b,
               L::BQ) &&
      map_bthd(&maps.k, ty, p.k, p.d, p.tk, p.Hkv, p.B, p.sk_t, p.sk_h,
               p.sk_b, BK) &&
      map_bthd(&maps.v, ty, p.v, p.d, p.tk, p.Hkv, p.B, p.sv_t, p.sv_h,
               p.sv_b, BK) &&
      map_bthd(&maps.o, ty, p.out, p.d, p.tq, p.H, p.B, p.so_t, p.so_h,
               p.so_b, 64) &&
      (p.bias == nullptr || map_bias(&maps.bias, p, L::BQ));
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<T, D, NC, BK>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::bytes(true) <= SMEM_OPTIN ? L::bytes(true) : L::bytes(false));
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tq + L::BQ - 1) / L::BQ, p.H, p.B);
  kernel<<<grid, L::THREADS, smem, st>>>(maps, p);
  return cudaGetLastError();
}

// The tile (bq, bk): 64 or 128 query rows (one or two consumer
// warpgroups) by 96 or 160 keys; any other pair, and decode, is refused.
template <typename T, int D>
cudaError_t by_tile(const Params& p, int bq, int bk, cudaStream_t st,
                    bool check) {
  if (p.splits > 0) return cudaErrorInvalidValue;
  if (bq == 64 && bk == 96) return launch_wgmma<T, D, 1, 96>(p, st, check);
  if (bq == 128 && bk == 96) return launch_wgmma<T, D, 2, 96>(p, st, check);
#if APEX_FLASH_TUNE_TILES
  if (bq == 64 && bk == 160) return launch_wgmma<T, D, 1, 160>(p, st, check);
  if (bq == 128 && bk == 160)
    return launch_wgmma<T, D, 2, 160>(p, st, check);
#endif
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(const Params& p, int head_dim, int bq, int bk,
                   cudaStream_t st, bool check) {
  if (head_dim == 64) return by_tile<T, 64>(p, bq, bk, st, check);
  if (head_dim == 128) return by_tile<T, 128>(p, bq, bk, st, check);
  return cudaErrorInvalidValue;
}

cudaError_t by_dtype(const Params& p, int head_dim, int dtype, int bq, int bk,
                     cudaStream_t st, bool check) {
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(p, head_dim, bq, bk, st, check);
  if (dtype == 2) return by_dim<__half>(p, head_dim, bq, bk, st, check);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// head_dim is the instantiated width (64 or 128, >= p->d); dtype 1 bf16,
// 2 fp16; (block_q, block_k) one of the tiles of by_tile.  Every view
// must meet TMA's rules (the wrapper's `_tma_ok`): a map that
// cuTensorMapEncodeTiled refuses returns cudaErrorInvalidValue,
// launching nothing.
extern "C" int flash_attention_fwd_wgmma(const Params* p, int head_dim,
                                         int dtype, int block_q, int block_k,
                                         void* stream) {
  return static_cast<int>(by_dtype(*p, head_dim, dtype, block_q, block_k,
                                   static_cast<cudaStream_t>(stream), false));
}

// 0 when flash_attention_fwd_wgmma would take these arguments (of *p only
// splits and bias, null or not, are read), else the error it would
// return; launches nothing.
extern "C" int flash_attention_fwd_wgmma_check(const Params* p,
                                               int head_dim, int dtype,
                                               int block_q, int block_k) {
  return static_cast<int>(
      by_dtype(*p, head_dim, dtype, block_q, block_k, nullptr, true));
}
