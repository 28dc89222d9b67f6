// Flash-attention backward for Hopper (sm_90a) on `wgmma` and TMA, plain C
// interface: dQ and dK/dV.
//
// Replaces, for bf16 / fp16 at the instantiated head widths 64 and 128
// (heads 33-128 wide), the Pallas TPU kernels apex_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (:440) and `_bwd_dkv_kernel` (:478), launched by
// `_flash_bwd_pallas`.  They compute the function of
// flash_attention_bwd.cu's header, lines 11-25, unchanged: the same
// scores, masks and biases (the causal band and window at any signed
// q_offset, the [B, S] key-padding bias and the fp32 [B, T, S] bias), GQA
// and MQA query heads summed into one dK/dV block, p = exp(s - lse) forced
// to 0 where the band hides a key and past the ragged edges,
// ds = p (dp - delta) sm_scale, p and ds rounded to the input dtype before
// their products, every sum in fp32, and the fp32 column sums of ds per
// (b, h, j) for the key-bias gradient.  `_flash_bwd_ref`
// (apex_tpu_torch/ops/flash_attention.py) is their plain version.  As in
// flash_attention_bwd.cu, dQ and dK/dV stay two kernels that each
// recompute s and dp (seven products a visible pair): every output has one
// owner block, no atomics, the same bits from run to run.
//
// What bounds them on the H100: 14 T S H D operations (half under causal)
// against ~(4 T + 4 S) H D bytes, so the tensor cores, whose full rate
// only `wgmma` reaches; at width 64 the exponentials and the per-element
// arithmetic of p and ds come close to the products.  The `mma.sync`
// kernels of flash_attention_bwd.cu (4 warps, `ldmatrix` operands,
// `cp.async` double buffers) reached 0.09-0.10 of the bound.  Here, on
// flash_attention_sm90.cu's design (flash_sm90.cuh holds what both share):
//  * Loads are TMA under `__grid_constant__` `CUtensorMap`s of the
//    [B, T, H, D] views read in place (a fused projection's strided q, k,
//    v included), into the 128-byte swizzle that is `wgmma`'s operand
//    layout; completion is counted by `mbarrier`s.  The maps come from a
//    cache keyed by pointer, shape and strides, so an eager call on views
//    seen before encodes nothing.  TMA's rules are the wrapper's routing
//    rule (`_tma_ok`); a map that cuTensorMapEncodeTiled refuses fails the
//    launch, nothing falls back.
//  * Registers.  ptxas allocates the consumers within the launch's
//    register count whatever `setmaxnreg` asks, and an SM's 65536
//    registers are four partitions of 16384, one for each warp scheduler:
//    a block of one consumer warpgroup and a producer warp, two an SM,
//    puts three warps on a partition and leaves 168 registers a thread,
//    where dK/dV (dK and dV alone hold 64 or 128) and dQ at width 128
//    spilled.  Those blocks are the one warpgroup (two an SM: 255
//    registers), whose first thread (dQ) or first warp (dK/dV) refills a
//    stage once a named barrier has seen every warp leave it; dQ at width
//    64 (128 registers, three blocks an SM) keeps its producer warp, which
//    measured faster there.
//  * dQ (`flash_bwd_dq_wgmma_kernel`): a warpgroup owns 64 query rows; the
//    block loads its Q and dO tiles once and its rows' lse and delta into
//    registers, and streams K and V (and the [B, T, S] bias tile) through
//    a ring of stages gated by full (and, with a producer, empty)
//    barriers.  S = Q K^T and dP = dO V^T are `wgmma` with both operands
//    K-major in shared memory, issued as two groups so that p is computed
//    while dP is in flight; p and ds are computed in registers in the
//    accumulator layout, the exponential in the base-2 domain; dQ += dS K
//    takes dS, rounded, as the register A operand and K as the MN-major B
//    operand through the transpose bit (the forward's P V with K in V's
//    place).  dQ is stored, rounded, through the warpgroup's rows of the
//    Q tile by TMA.  Query tiles go longest first under causal masking.
//  * dK/dV (`flash_bwd_dkv_wgmma_kernel`): a warpgroup owns 64 keys of one
//    KV head; the block loads K and V once and loops over the H / H_kv
//    query heads of that KV head and, for each, over the query tiles in
//    its band.  Q and dO stream by TMA through a 2-stage ring across head
//    boundaries; lse and delta come with them by 4-byte `cp.async` copies
//    (their rows are not 16-byte aligned at T = 1023) counted on the same
//    full barrier.  S^T = K Q^T and dP^T = V dO^T are `wgmma` with both
//    operands K-major; P^T and dS^T in registers, lse and delta per column
//    from shared memory; dV += P^T dO and dK += dS^T Q take P^T and dS^T,
//    rounded, as register A, and dO and Q MN-major through the transpose
//    bit.  The key-bias partial is the fp32 row sum of dS^T in the
//    accumulator layout.  dK and dV are stored once through the K and V
//    tiles by TMA.  Key tile 0, which sees the most queries under causal
//    masking, goes first.
//  * The tensor cores truncate inside a sum, so an accumulator carried
//    through every tile of a long loop drifts further than fp32 summation:
//    with `wgmma` accumulating in place (scale-d 1), the GQA 12/4 dV of
//    chip_smoke.py phase 8 was one bf16 ulp (0.03125) off the plain
//    version, past its 3e-2 gate, as the `mma.sync` kernels were on the
//    card (measured once; PERF.md).  So each tile's dQ, dV and dK products sum in
//    a fresh accumulator, scale-d 0 on its first k-step, added to the
//    running sum by an IEEE fp32 add; the fresh sums take the registers of
//    the dead score tiles.
//  * Tiles outside the causal / window band of the block are never loaded
//    (loop bounds); a warpgroup skips the products of a tile outside its
//    own rows' band; a tile wholly inside the band skips the masks.
// Tiles (rows a warpgroup x the other side's tile; `dq_by_dim` and
// `dkv_by_dim` below): dQ 64 queries x 64 keys; dK/dV 64 keys x 128
// queries at width 64, x 64 at 128.

#include <cuda.h>   // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"
#include "sm90.cuh"

// Field order and types mirror flash_attention_bwd.cu's BwdParams and the
// ctypes Structure in apex_tpu_torch/ops/flash_attention.py
// (_FlashBwdParams).
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B, H, T] fp32, contiguous
  const float* delta;   // [B, H, T] fp32, contiguous
  const float* kbias;   // [B, S] fp32 or null
  const float* bias;    // [B, T, S] fp32 (last stride 1) or null
  void* dq;
  void* dk;
  void* dv;
  float* dkbias;        // [B, H, S] fp32, contiguous, or null
  float* dbias;         // unused here (db2 only)
  int64_t sq_b, sq_t, sq_h;
  int64_t sk_b, sk_t, sk_h;
  int64_t sv_b, sv_t, sv_h;
  int64_t sdo_b, sdo_t, sdo_h;
  int64_t sdq_b, sdq_t, sdq_h;
  int64_t sdk_b, sdk_t, sdk_h;
  int64_t sdv_b, sdv_t, sdv_h;
  int64_t skb_b;
  int64_t sb_b, sb_t;
  int32_t B, H, Hkv, tq, tk;
  int32_t causal, q_offset, window;   // window 0 = none
  int32_t d;            // the head width (<= the instantiated width)
  float sm_scale;
};

// The tensor maps of one launch, passed by value as a __grid_constant__
// parameter (each CUtensorMap is 64-byte aligned).  dQ stores through
// out_a; dK/dV through out_a (dk) and out_b (dv).
struct BwdMaps {
  CUtensorMap q, k, v, dout, out_a, out_b, bias;
};

namespace {

using namespace sm90;
using namespace flash_sm90;

// Whether query row q (of the call's tq) sees key `key` (of tk): inside
// both lengths and, under causal masking, the band at q_offset.
__device__ __forceinline__ bool seen(const BwdParams& p, int q, int key) {
  const int qpos = p.q_offset + q;
  return (key < p.tk) & (q < p.tq) &
         (!p.causal | ((key <= qpos) &
                       ((p.window <= 0) | (qpos - key < p.window))));
}

// The key range rows [q0, q_last] can see (the causal / window band).
__device__ __forceinline__ void key_band(const BwdParams& p, int q0,
                                         int q_last, int& k_begin,
                                         int& k_end) {
  k_begin = 0;
  k_end = p.tk;
  if (p.causal) {
    k_end = min(p.tk, p.q_offset + q_last + 1);
    if (p.window > 0) k_begin = max(0, p.q_offset + q0 - p.window + 1);
  }
}

// The query range that sees any key of [k0, k_last] (JAX `_qc`).
__device__ __forceinline__ void query_band(const BwdParams& p, int k0,
                                           int k_last, int& q_begin,
                                           int& q_end) {
  q_begin = 0;
  q_end = p.tq;
  if (p.causal) {
    q_begin = max(0, k0 - p.q_offset);
    if (p.window > 0) q_end = min(p.tq, k_last + p.window - p.q_offset);
  }
}

// 4 bytes global -> shared, zero-filled when !ok (source size 0)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies have
// landed (the barrier's count includes it: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// The 64 rows' D / 2 fp32 accumulators of a warpgroup (rows
// row_base + 16 warp + g and + 8), rounded, into a swizzled tile of
// `rows` rows (D / 64 panels), from which TMA stores them.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* tile, int rows, int row_base,
                                           const float (&acc)[D / 2]) {
  const int tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row_base + warp * 16 + g + 8 * hh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(tile + (n / 8) * rows * PANEL +
                                   r * PANEL + (((n % 8) ^ g) << 3) +
                                   2 * t4) =
          pack2<T>(acc[4 * n + 2 * hh], acc[4 * n + 2 * hh + 1]);
  }
}

// TMA store of warpgroup c's staged rows (64 from row_base of a tile of
// `rows` rows) to the view of `map` at rows r0 of head h, batch b; rows
// and columns past the view's edges are clipped.
template <int D, typename T>
__device__ __forceinline__ void store_rows(const CUtensorMap* map,
                                           const T* tile, int rows,
                                           int row_base, int c, int r0, int h,
                                           int b) {
  fence_proxy_async();
  named_bar(1 + c, 128);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int pn = 0; pn < D / PANEL; ++pn)
      tma_store_4d(map, tile + pn * rows * PANEL + row_base * PANEL,
                   pn * PANEL, r0, h, b);
    tma_store_commit_wait();
  }
}

// -- dQ --------------------------------------------------------------------------

// Shared memory of a dQ block: Q and dO (D / 64 swizzled panels of BQ
// rows each), the K and V rings, the fp32 bias ring (BK / 32 swizzled
// boxes of [BQ][32] floats a stage) when there is a bias, then the
// barriers; every tile 1024-byte aligned (the swizzle's period), plus 1024
// bytes to align the base.  PROD: a producer warp fills the ring; without
// one (a single consumer warpgroup), the warpgroup's first thread refills
// each stage as the warpgroup leaves it, so the block is four warps (see
// the header on registers).
template <int D_, int NC_, int BK_, int MINB_, bool PROD_, int STAGES_>
struct DqTile {
  static constexpr int D = D_, NC = NC_, BK = BK_, MINB = MINB_;
  static constexpr int STAGES = STAGES_;   // the ring's depth
  static constexpr bool PROD = PROD_;
  static_assert(PROD || NC == 1, "no producer warp: one warpgroup");
  static constexpr int BQ = 64 * NC;
  static constexpr int THREADS = NC * 128 + (PROD ? 32 : 0);
  static constexpr int Q_BYTES = BQ * D * 2;    // Q (or dO)
  static constexpr int KV_BYTES = BK * D * 2;   // one stage of K (or V)
  static constexpr int B_BYTES = BQ * BK * 4;   // one stage of the bias
  static constexpr int OFF_DO = Q_BYTES;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BIAS = OFF_V + STAGES * KV_BYTES;
  __host__ __device__ static constexpr int off_bar(bool bias) {
    return OFF_BIAS + (bias ? STAGES * B_BYTES : 0);
  }
  __host__ __device__ static constexpr int bytes(bool bias) {
    return off_bar(bias) + 128 + 1024;
  }
};

// One thread's loads of a dQ block: Q and dO once (on qbar) ...
template <typename T, class L>
__device__ __forceinline__ void dq_load_q(const BwdMaps& maps,
                                          const BwdParams& p, T* Qs, T* dOs,
                                          uint32_t qbar, int q0, int h,
                                          int b) {
  prefetch_map(&maps.k);
  prefetch_map(&maps.v);
  if (p.bias != nullptr) prefetch_map(&maps.bias);
  mbar_expect_tx(qbar, 2 * L::Q_BYTES);
#pragma unroll
  for (int pn = 0; pn < L::D / PANEL; ++pn) {
    tma_load_4d(Qs + pn * L::BQ * PANEL, &maps.q, qbar, pn * PANEL, q0, h,
                b);
    tma_load_4d(dOs + pn * L::BQ * PANEL, &maps.dout, qbar, pn * PANEL, q0,
                h, b);
  }
}

// ... and key tile j's K and V (and the bias's) into stage j % STAGES.
template <typename T, class L>
__device__ __forceinline__ void dq_load_tile(const BwdMaps& maps,
                                             const BwdParams& p, T* Ks,
                                             T* Vs, float* Bs, uint32_t full0,
                                             int j, int q0, int h, int b,
                                             int k_begin) {
  constexpr int STAGES = L::STAGES;
  constexpr int D = L::D, BK = L::BK;
  const bool has_bias = p.bias != nullptr;
  const int hk = h / (p.H / p.Hkv);
  const int s = j % STAGES;
  const int k0 = k_begin + j * BK;
  const uint32_t full = full0 + 8 * s;
  mbar_expect_tx(full, 2 * L::KV_BYTES + (has_bias ? L::B_BYTES : 0));
  T* ks = Ks + s * BK * D;
  T* vs = Vs + s * BK * D;
#pragma unroll
  for (int pn = 0; pn < D / PANEL; ++pn) {
    tma_load_4d(ks + pn * BK * PANEL, &maps.k, full, pn * PANEL, k0, hk, b);
    tma_load_4d(vs + pn * BK * PANEL, &maps.v, full, pn * PANEL, k0, hk, b);
  }
  if (has_bias) {
#pragma unroll
    for (int i = 0; i < BK / 32; ++i)
      tma_load_3d(Bs + s * L::BQ * BK + i * L::BQ * 32, &maps.bias, full,
                  k0 + 32 * i, q0, p.sb_b != 0 ? b : 0);
  }
}

// The producer warp's one thread: Q and dO once, then the K and V tiles
// (and the bias's) of the block's band into the ring as it frees.
template <typename T, class L>
__device__ __forceinline__ void dq_produce(const BwdMaps& maps,
                                           const BwdParams& p, T* Qs, T* dOs,
                                           T* Ks, T* Vs, float* Bs,
                                           uint32_t full0, uint32_t empty0,
                                           uint32_t qbar, int q0, int h,
                                           int b, int k_begin, int n_tiles) {
  constexpr int STAGES = L::STAGES;
  if (n_tiles > 0) dq_load_q<T, L>(maps, p, Qs, dOs, qbar, q0, h, b);
  for (int j = 0; j < n_tiles; ++j) {
    if (j >= STAGES)
      mbar_wait(empty0 + 8 * (j % STAGES), ((j / STAGES) - 1) & 1);
    dq_load_tile<T, L>(maps, p, Ks, Vs, Bs, full0, j, q0, h, b, k_begin);
  }
}

// Consumer warpgroup c: dQ of rows [q0 + 64 c, q0 + 64 c + 64) over the
// ring's key tiles, then its store.
template <typename T, class L>
__device__ __forceinline__ void dq_consume(const BwdMaps& maps,
                                           const BwdParams& p, T* Qs, T* dOs,
                                           T* Ks, T* Vs, float* Bs,
                                           uint32_t full0, uint32_t empty0,
                                           uint32_t qbar, int q0, int h,
                                           int b, int k_begin, int n_tiles,
                                           int wg) {
  constexpr int STAGES = L::STAGES;
  constexpr int D = L::D, BK = L::BK, BQ = L::BQ;
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
  const uint32_t do_addr = smem_u32(dOs) + c * 64 * 128;

  // this thread's rows' lse (in base 2) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int64_t ix = (static_cast<int64_t>(b) * p.H + h) * p.tq + row;
    lse2[i] = row < p.tq ? __fmul_rn(p.lse[ix], LOG2E) : 0.f;
    dl[i] = row < p.tq ? p.delta[ix] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (!L::PROD && tw == 0 && n_tiles > 0) {
    dq_load_q<T, L>(maps, p, Qs, dOs, qbar, q0, h, b);
    for (int j = 0; j < min(STAGES, n_tiles); ++j)
      dq_load_tile<T, L>(maps, p, Ks, Vs, Bs, full0, j, q0, h, b, k_begin);
  }
  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    const int k0 = k_begin + j * BK;
    if (rows && k0 < wk_end && k0 + BK > wk_begin) {
      const uint32_t k_addr = smem_u32(Ks + s * BK * D);
      const uint32_t v_addr = smem_u32(Vs + s * BK * D);

      // S = Q K^T and dP = dO V^T: 64 rows x BK keys, D / 16 k-steps
      // each, two groups (p is computed while dP is in flight)
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T>(sc,
                    gmma_desc(q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32,
                              16, 1024),
                    gmma_desc(k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32,
                              16, 1024),
                    kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T>(dp,
                    gmma_desc(do_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32,
                              16, 1024),
                    gmma_desc(v_addr + (kk / 4) * BK * 128 + (kk % 4) * 32,
                              16, 1024),
                    kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // p in place of sc, in base 2; element 4 n + r is row
      // row0 + 8 (r >> 1), key k0 + 8 n + 2 t4 + (r & 1)
      if (kb != nullptr) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const int key0 = k0 + n * 8 + 2 * t4;
          const float a0 = __fmul_rn(kb[min(key0, p.tk - 1)], LOG2E);
          const float a1 = __fmul_rn(kb[min(key0 + 1, p.tk - 1)], LOG2E);
          sc[4 * n] = fmaf(sc[4 * n], scale2, a0);
          sc[4 * n + 1] = fmaf(sc[4 * n + 1], scale2, a1);
          sc[4 * n + 2] = fmaf(sc[4 * n + 2], scale2, a0);
          sc[4 * n + 3] = fmaf(sc[4 * n + 3], scale2, a1);
        }
      } else if (has_bias) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= scale2;
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
      if (kb == nullptr && !has_bias) {   // one FFMA an element
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          sc[i] = ex2(fmaf(sc[i], scale2, -lse2[(i >> 1) & 1]));
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          sc[i] = ex2(sc[i] - lse2[(i >> 1) & 1]);
      }
      const bool edge =
          k0 + BK > p.tk ||
          (p.causal &&
           (k0 + BK - 1 > p.q_offset + qw0 ||
            (p.window > 0 && p.q_offset + qw_last - k0 >= p.window)));
      if (edge) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            sc[4 * n + r] = seen(p, row0 + 8 * (r >> 1),
                                 k0 + n * 8 + 2 * t4 + (r & 1))
                                ? sc[4 * n + r]
                                : 0.f;
      }

      // ds = p (dp - delta) sm_scale in place of p
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sc[i] = sc[i] * (dp[i] - dl[(i >> 1) & 1]) * p.sm_scale;

      // dQ += dS K: ds rounded to k's dtype into the A fragments, the
      // tile's keys summed in a fresh accumulator, added in fp32
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        a[kk][0] = pack2<T>(sc[8 * kk], sc[8 * kk + 1]);
        a[kk][1] = pack2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
        a[kk][2] = pack2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
        a[kk][3] = pack2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      float part[D / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<T>(part, a[kk],
                    gmma_desc(k_addr + kk * 16 * 128, BK * 128, 1024), kk);
      wgmma_commit_wait();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
    }
    // the warpgroup's products on stage s are complete (its `wgmma`
    // wait): one arrival a warpgroup frees the stage, or, without a
    // producer, once every warp is past it, the next tile comes in
    if (L::PROD) {
      if (tw == 0) mbar_arrive(empty0 + 8 * s);
    } else {
      named_bar(1, 128);
      if (tw == 0 && j + STAGES < n_tiles)
        dq_load_tile<T, L>(maps, p, Ks, Vs, Bs, full0, j + STAGES, q0, h, b,
                           k_begin);
    }
  }

  // the warpgroup's own rows of the Q tile stage its dQ (its products,
  // the only readers of those rows, are complete; the tile has landed)
  if (rows) {
    stage_rows<T, D>(Qs, BQ, c * 64, acc);
    store_rows<D>(&maps.out_a, Qs, BQ, c * 64, c, qw0, h, b);
  }
}

template <typename T, class L>
__global__ void __launch_bounds__(L::THREADS, L::MINB)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                          const BwdParams p) {
  constexpr int STAGES = L::STAGES;
  constexpr int NC = L::NC, BK = L::BK;
  static_assert(L::D % PANEL == 0 && BK % 32 == 0, "tile");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);        // later the dQ tile
  T* dOs = reinterpret_cast<T*>(base + L::OFF_DO);
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
    mbar_init_fence();
  }
  __syncthreads();

  // warps 0 .. 4 NC - 1 consume, warp 4 NC (if any) produces (one thread)
  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    if (threadIdx.x == NC * 128)
      dq_produce<T, L>(maps, p, Qs, dOs, Ks, Vs, Bs, full0, empty0, qbar, q0,
                       h, b, k_begin, n_tiles);
  } else {
    dq_consume<T, L>(maps, p, Qs, dOs, Ks, Vs, Bs, full0, empty0, qbar, q0,
                     h, b, k_begin, n_tiles, wg);
  }
}

// -- dK / dV -----------------------------------------------------------------

// Shared memory of a dK/dV block: K and V (D / 64 swizzled panels of BKV
// rows each), the Q and dO rings (BQ rows a stage), the fp32 bias ring
// (BKV / 32 swizzled boxes of [BQ][32] floats a stage) when there is a
// bias, the lse and delta ring ([2][BQ] floats a stage), then the
// barriers.  PROD as DqTile's (without a producer, warp 0 refills).
template <int D_, int NC_, int BQ_, int MINB_, bool PROD_, int STAGES_>
struct DkvTile {
  static constexpr int D = D_, NC = NC_, BQ = BQ_, MINB = MINB_;
  static constexpr int STAGES = STAGES_;   // the ring's depth
  static constexpr bool PROD = PROD_;
  static_assert(PROD || NC == 1, "no producer warp: one warpgroup");
  static constexpr int BKV = 64 * NC;
  static constexpr int THREADS = NC * 128 + (PROD ? 32 : 0);
  static constexpr int KV_BYTES = BKV * D * 2;  // K (or V)
  static constexpr int Q_BYTES = BQ * D * 2;    // one stage of Q (or dO)
  static constexpr int B_BYTES = BQ * BKV * 4;  // one stage of the bias
  static constexpr int LD_BYTES = 2 * BQ * 4;   // one stage of lse, delta
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * Q_BYTES;
  static constexpr int OFF_BIAS = OFF_DO + STAGES * Q_BYTES;
  __host__ __device__ static constexpr int off_ld(bool bias) {
    return OFF_BIAS + (bias ? STAGES * B_BYTES : 0);
  }
  __host__ __device__ static constexpr int off_bar(bool bias) {
    return off_ld(bias) + STAGES * LD_BYTES;
  }
  __host__ __device__ static constexpr int bytes(bool bias) {
    return off_bar(bias) + 128 + 1024;
  }
};

// One warp's loads of a dK/dV block: K and V once (lane 0, on kvbar) ...
template <typename T, class L>
__device__ __forceinline__ void dkv_load_kv(const BwdMaps& maps,
                                            const BwdParams& p, T* Ks, T* Vs,
                                            uint32_t kvbar, int k0, int hk,
                                            int b) {
  if ((threadIdx.x & 31) != 0) return;
  prefetch_map(&maps.q);
  prefetch_map(&maps.dout);
  if (p.bias != nullptr) prefetch_map(&maps.bias);
  mbar_expect_tx(kvbar, 2 * L::KV_BYTES);
#pragma unroll
  for (int pn = 0; pn < L::D / PANEL; ++pn) {
    tma_load_4d(Ks + pn * L::BKV * PANEL, &maps.k, kvbar, pn * PANEL, k0, hk,
                b);
    tma_load_4d(Vs + pn * L::BKV * PANEL, &maps.v, kvbar, pn * PANEL, k0, hk,
                b);
  }
}

// ... and (query head, query tile) `it`'s Q, dO and bias tiles by TMA
// (lane 0) and its lse and delta by the 32 lanes' cp.async (zero past T),
// all counted on the stage's full barrier (1 + 32 arrivals).
template <typename T, class L>
__device__ __forceinline__ void dkv_load_tile(const BwdMaps& maps,
                                              const BwdParams& p, T* Qs,
                                              T* dOs, float* Bs, float* Ls,
                                              uint32_t full0, int it, int k0,
                                              int hk, int b, int q_begin,
                                              int n_qt) {
  constexpr int STAGES = L::STAGES;
  constexpr int D = L::D, BQ = L::BQ, BKV = L::BKV;
  const int lane = threadIdx.x & 31;
  const int s = it % STAGES;
  const int hq = hk * (p.H / p.Hkv) + it / n_qt;
  const int q0 = q_begin + (it % n_qt) * BQ;
  const uint32_t full = full0 + 8 * s;
  if (lane == 0) {
    const bool has_bias = p.bias != nullptr;
    mbar_expect_tx(full, 2 * L::Q_BYTES + (has_bias ? L::B_BYTES : 0));
    T* qs = Qs + s * BQ * D;
    T* ds = dOs + s * BQ * D;
#pragma unroll
    for (int pn = 0; pn < D / PANEL; ++pn) {
      tma_load_4d(qs + pn * BQ * PANEL, &maps.q, full, pn * PANEL, q0, hq, b);
      tma_load_4d(ds + pn * BQ * PANEL, &maps.dout, full, pn * PANEL, q0, hq,
                  b);
    }
    if (has_bias) {
#pragma unroll
      for (int i = 0; i < BKV / 32; ++i)
        tma_load_3d(Bs + s * BQ * BKV + i * BQ * 32, &maps.bias, full,
                    k0 + 32 * i, q0, p.sb_b != 0 ? b : 0);
    }
  }
  float* ls = Ls + s * 2 * BQ;
  const int64_t hrow = (static_cast<int64_t>(b) * p.H + hq) * p.tq;
  for (int i = lane; i < BQ; i += 32) {
    const bool ok = q0 + i < p.tq;
    cp_async4(ls + i, ok ? p.lse + hrow + q0 + i : p.lse, ok);
    cp_async4(ls + BQ + i, ok ? p.delta + hrow + q0 + i : p.delta, ok);
  }
  cp_async_arrive(full);
}

// The producer warp: K and V once, then every (query head, query tile) of
// the block's band into the ring as it frees.
template <typename T, class L>
__device__ __forceinline__ void dkv_produce(
    const BwdMaps& maps, const BwdParams& p, T* Ks, T* Vs, T* Qs, T* dOs,
    float* Bs, float* Ls, uint32_t full0, uint32_t empty0, uint32_t kvbar,
    int k0, int hk, int b, int q_begin, int n_qt) {
  constexpr int STAGES = L::STAGES;
  const int n_it = (p.H / p.Hkv) * n_qt;
  if (n_it > 0) dkv_load_kv<T, L>(maps, p, Ks, Vs, kvbar, k0, hk, b);
  for (int it = 0; it < n_it; ++it) {
    if (it >= STAGES)
      mbar_wait(empty0 + 8 * (it % STAGES), ((it / STAGES) - 1) & 1);
    dkv_load_tile<T, L>(maps, p, Qs, dOs, Bs, Ls, full0, it, k0, hk, b,
                        q_begin, n_qt);
  }
}

// Consumer warpgroup c: dK and dV of keys [k0 + 64 c, k0 + 64 c + 64)
// over the ring's (query head, query tile) pairs, the key-bias partial of
// each head, then the stores.
template <typename T, class L>
__device__ __forceinline__ void dkv_consume(
    const BwdMaps& maps, const BwdParams& p, T* Ks, T* Vs, T* Qs, T* dOs,
    float* Bs, float* Ls, uint32_t full0, uint32_t empty0, uint32_t kvbar,
    int k0, int hk, int b, int q_begin, int n_qt, int wg) {
  constexpr int STAGES = L::STAGES;
  constexpr int D = L::D, BQ = L::BQ, BKV = L::BKV;
  const bool has_bias = p.bias != nullptr;
  const int c = wg, tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int grp = p.H / p.Hkv, n_it = grp * n_qt;
  const int kw0 = k0 + 64 * c;
  const int kw_last = min(kw0 + 63, p.tk - 1);
  const bool keys = kw0 < p.tk;
  int wq_begin, wq_end;                      // this warpgroup's band
  query_band(p, kw0, kw_last, wq_begin, wq_end);
  const float scale2 = p.sm_scale * LOG2E;
  const int key0 = kw0 + warp * 16 + g;      // keys key0 and key0 + 8
  const int bkey = c * 64 + warp * 16 + g;   // the same in the block tile
  float kb2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kb2[i] = (p.kbias != nullptr && key0 + 8 * i < p.tk)
                 ? __fmul_rn(p.kbias[b * p.skb_b + key0 + 8 * i], LOG2E)
                 : 0.f;
  const uint32_t k_addr = smem_u32(Ks) + c * 64 * 128;
  const uint32_t v_addr = smem_u32(Vs) + c * 64 * 128;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float db[2] = {0.f, 0.f};                  // this head's key-bias sums

  if (!L::PROD && warp == 0 && n_it > 0) {
    dkv_load_kv<T, L>(maps, p, Ks, Vs, kvbar, k0, hk, b);
    for (int it = 0; it < min(STAGES, n_it); ++it)
      dkv_load_tile<T, L>(maps, p, Qs, dOs, Bs, Ls, full0, it, k0, hk, b,
                          q_begin, n_qt);
  }
  if (n_it > 0) mbar_wait(kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    const int qt = it % n_qt;
    const int q0 = q_begin + qt * BQ;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    if (keys && q0 < wq_end && q0 + BQ > wq_begin) {
      const uint32_t q_addr = smem_u32(Qs + s * BQ * D);
      const uint32_t do_addr = smem_u32(dOs + s * BQ * D);
      const float* ls = Ls + s * 2 * BQ;     // lse, then delta

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T>(st,
                    gmma_desc(k_addr + (kk / 4) * BKV * 128 + (kk % 4) * 32,
                              16, 1024),
                    gmma_desc(q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32,
                              16, 1024),
                    kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T>(dpt,
                    gmma_desc(v_addr + (kk / 4) * BKV * 128 + (kk % 4) * 32,
                              16, 1024),
                    gmma_desc(do_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32,
                              16, 1024),
                    kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T in place of st, in base 2; element 4 n + r is key
      // key0 + 8 (r >> 1), query q0 + 8 n + 2 t4 + (r & 1)
      // (lse in base 2 is rounded apart from the subtraction, with no
      // contraction into an FMA, as dQ's lse2: a key bias of -1e9 on
      // every key must give p = exp2(x - lse2) = 1 exactly in both
      // kernels; without either bias, one FFMA an element)
      if (has_bias) {
        const float* bt = Bs + s * BQ * BKV;
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const int col = n * 8 + 2 * t4;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
          const float lc[2] = {__fmul_rn(l2.x, LOG2E),
                               __fmul_rn(l2.y, LOG2E)};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // box (bkey + 8 (r >> 1)) / 32, query row col + (r & 1), its
            // 16-byte chunk swizzled by the row
            const int kl = bkey + 8 * (r >> 1), qr = col + (r & 1);
            const float x = fmaf(
                bt[(kl / 32) * BQ * 32 + qr * 32 +
                   ((((kl % 32) >> 2) ^ (qr & 7)) << 2) + (kl & 3)],
                LOG2E, fmaf(st[4 * n + r], scale2, kb2[r >> 1]));
            st[4 * n + r] = ex2(x - lc[r & 1]);
          }
        }
      } else if (p.kbias != nullptr) {
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(ls + n * 8 + 2 * t4);
          const float lc[2] = {__fmul_rn(l2.x, LOG2E),
                               __fmul_rn(l2.y, LOG2E)};
#pragma unroll
          for (int r = 0; r < 4; ++r)
            st[4 * n + r] =
                ex2(fmaf(st[4 * n + r], scale2, kb2[r >> 1]) - lc[r & 1]);
        }
      } else {
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(ls + n * 8 + 2 * t4);
          const float lc[2] = {__fmul_rn(l2.x, LOG2E),
                               __fmul_rn(l2.y, LOG2E)};
#pragma unroll
          for (int r = 0; r < 4; ++r)
            st[4 * n + r] = ex2(fmaf(st[4 * n + r], scale2, -lc[r & 1]));
        }
      }
      const bool edge =
          q0 + BQ > p.tq || kw0 + 64 > p.tk ||
          (p.causal &&
           (kw0 + 63 > p.q_offset + q0 ||
            (p.window > 0 && p.q_offset + q0 + BQ - 1 - kw0 >= p.window)));
      if (edge) {
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            st[4 * n + r] = seen(p, q0 + n * 8 + 2 * t4 + (r & 1),
                                 key0 + 8 * (r >> 1))
                                ? st[4 * n + r]
                                : 0.f;
      }

      // dS^T = P^T (dP^T - delta) sm_scale in place of dP^T
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(ls + BQ + n * 8 + 2 * t4);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dpt[4 * n + r] = st[4 * n + r] *
                           (dpt[4 * n + r] - ((r & 1) ? d2.y : d2.x)) *
                           p.sm_scale;
      }
      if (p.dkbias != nullptr) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) db[(i >> 1) & 1] += dpt[i];
      }

      // P^T rounded to dO's dtype and dS^T to q's, into A fragments
      uint32_t ap[BQ / 16][4], as[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ap[kk][i] = pack2<T>(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
          as[kk][i] = pack2<T>(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
        }
      }
      if constexpr (D == 64) {
        // dV += P^T dO and dK += dS^T Q, each tile's sum in a fresh
        // accumulator added in fp32: at width 64 both at once, at 128 64
        // columns at a time (the registers of one 64-column sum a thread)
        float pv[32], pk[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<T>(pv, ap[kk],
                      gmma_desc(do_addr + kk * 16 * 128, BQ * 128, 1024), kk);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<T>(pk, as[kk],
                      gmma_desc(q_addr + kk * 16 * 128, BQ * 128, 1024), kk);
        wgmma_commit_wait();
        fence_regs(pv);
        fence_regs(pk);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          dv[i] += pv[i];
          dk[i] += pk[i];
        }
      } else {
#pragma unroll
        for (int nc = 0; nc < D / 64; ++nc) {
          float part[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<T>(part, ap[kk],
                        gmma_desc(do_addr + nc * BQ * 128 + kk * 16 * 128,
                                  BQ * 128, 1024),
                        kk);
          wgmma_commit_wait();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < 32; ++i) dv[nc * 32 + i] += part[i];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            wgmma_rs<T>(part, as[kk],
                        gmma_desc(q_addr + nc * BQ * 128 + kk * 16 * 128,
                                  BQ * 128, 1024),
                        kk);
          wgmma_commit_wait();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < 32; ++i) dk[nc * 32 + i] += part[i];
        }
      }
    }
    if (L::PROD) {
      if (tw == 0) mbar_arrive(empty0 + 8 * s);
    } else {
      named_bar(1, 128);
      if (warp == 0 && it + STAGES < n_it)
        dkv_load_tile<T, L>(maps, p, Qs, dOs, Bs, Ls, full0, it + STAGES, k0,
                            hk, b, q_begin, n_qt);
    }

    if (qt == n_qt - 1) {                    // this query head is done
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        db[i] += __shfl_xor_sync(0xffffffffu, db[i], 1);
        db[i] += __shfl_xor_sync(0xffffffffu, db[i], 2);
      }
      if (p.dkbias != nullptr && t4 == 0) {
        const int hq = hk * grp + it / n_qt;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (key0 + 8 * i < p.tk)
            p.dkbias[(static_cast<int64_t>(b) * p.H + hq) * p.tk + key0 +
                     8 * i] = db[i];
      }
      db[0] = db[1] = 0.f;
    }
  }
  if (n_it == 0 && p.dkbias != nullptr) {    // no query sees these keys
    for (int i = tw; i < grp * 64; i += 128) {
      const int key = kw0 + i % 64;
      if (key < p.tk)
        p.dkbias[(static_cast<int64_t>(b) * p.H + hk * grp + i / 64) * p.tk +
                 key] = 0.f;
    }
  }

  // the warpgroup's own rows of the K and V tiles stage dK and dV
  if (keys) {
    stage_rows<T, D>(Ks, BKV, c * 64, dk);
    stage_rows<T, D>(Vs, BKV, c * 64, dv);
    store_rows<D>(&maps.out_a, Ks, BKV, c * 64, c, kw0, hk, b);
    store_rows<D>(&maps.out_b, Vs, BKV, c * 64, c, kw0, hk, b);
  }
}

template <typename T, class L>
__global__ void __launch_bounds__(L::THREADS, L::MINB)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                           const BwdParams p) {
  constexpr int STAGES = L::STAGES;
  constexpr int NC = L::NC, BQ = L::BQ;
  static_assert(L::D % PANEL == 0 && BQ % 16 == 0, "tile");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const bool has_bias = p.bias != nullptr;
  T* Ks = reinterpret_cast<T*>(base);        // later the dK tile
  T* Vs = reinterpret_cast<T*>(base + L::OFF_V);   // later dV
  T* Qs = reinterpret_cast<T*>(base + L::OFF_Q);
  T* dOs = reinterpret_cast<T*>(base + L::OFF_DO);
  float* Bs = reinterpret_cast<float*>(base + L::OFF_BIAS);
  float* Ls = reinterpret_cast<float*>(base + L::off_ld(has_bias));
  const uint32_t full0 = smem_u32(base + L::off_bar(has_bias));
  const uint32_t empty0 = full0 + 8 * STAGES, kvbar = empty0 + 8 * STAGES;

  const int k0 = blockIdx.x * L::BKV;   // key tile 0 (most queries) first
  const int hk = blockIdx.y, b = blockIdx.z;
  int q_begin, q_end;
  query_band(p, k0, min(k0 + L::BKV, p.tk) - 1, q_begin, q_end);
  q_begin = (q_begin / BQ) * BQ;
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);   // lane 0's TMA, 32 cp.async
      mbar_init(empty0 + 8 * s, NC);      // a warpgroup's first thread
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    dkv_produce<T, L>(maps, p, Ks, Vs, Qs, dOs, Bs, Ls, full0, empty0, kvbar,
                      k0, hk, b, q_begin, n_qt);
  } else {
    dkv_consume<T, L>(maps, p, Ks, Vs, Qs, dOs, Bs, Ls, full0, empty0, kvbar,
                      k0, hk, b, q_begin, n_qt, wg);
  }
}

// -- launchers -----------------------------------------------------------------

template <typename T>
CUtensorMapDataType map_type() {
  return std::is_same<T, __nv_bfloat16>::value
             ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
             : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, class L>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t st) {
  constexpr int BK = L::BK;
  const bool has_bias = p.bias != nullptr;
  if (L::bytes(has_bias) > SMEM_OPTIN) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType ty = map_type<T>();
  BwdMaps maps{};
  const bool ok =
      map_bthd(&maps.q, ty, p.q, p.d, p.tq, p.H, p.B, p.sq_t, p.sq_h, p.sq_b,
               L::BQ) &&
      map_bthd(&maps.dout, ty, p.dout, p.d, p.tq, p.H, p.B, p.sdo_t,
               p.sdo_h, p.sdo_b, L::BQ) &&
      map_bthd(&maps.k, ty, p.k, p.d, p.tk, p.Hkv, p.B, p.sk_t, p.sk_h,
               p.sk_b, BK) &&
      map_bthd(&maps.v, ty, p.v, p.d, p.tk, p.Hkv, p.B, p.sv_t, p.sv_h,
               p.sv_b, BK) &&
      map_bthd(&maps.out_a, ty, p.dq, p.d, p.tq, p.H, p.B, p.sdq_t, p.sdq_h,
               p.sdq_b, 64) &&
      (!has_bias ||
       map_bias(&maps.bias, p.bias, p.B, p.tq, p.tk, p.sb_b, p.sb_t, L::BQ));
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_wgmma_kernel<T, L>;
  static const cudaError_t configured = allow_smem(
      kernel, L::bytes(true) <= SMEM_OPTIN ? L::bytes(true)
                                           : L::bytes(false));
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tq + L::BQ - 1) / L::BQ, p.H, p.B);
  kernel<<<grid, L::THREADS, L::bytes(has_bias), st>>>(maps, p);
  return cudaGetLastError();
}

template <typename T, class L>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t st) {
  constexpr int BQ = L::BQ;
  const bool has_bias = p.bias != nullptr;
  if (L::bytes(has_bias) > SMEM_OPTIN) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType ty = map_type<T>();
  BwdMaps maps{};
  const bool ok =
      map_bthd(&maps.q, ty, p.q, p.d, p.tq, p.H, p.B, p.sq_t, p.sq_h, p.sq_b,
               BQ) &&
      map_bthd(&maps.dout, ty, p.dout, p.d, p.tq, p.H, p.B, p.sdo_t,
               p.sdo_h, p.sdo_b, BQ) &&
      map_bthd(&maps.k, ty, p.k, p.d, p.tk, p.Hkv, p.B, p.sk_t, p.sk_h,
               p.sk_b, L::BKV) &&
      map_bthd(&maps.v, ty, p.v, p.d, p.tk, p.Hkv, p.B, p.sv_t, p.sv_h,
               p.sv_b, L::BKV) &&
      map_bthd(&maps.out_a, ty, p.dk, p.d, p.tk, p.Hkv, p.B, p.sdk_t,
               p.sdk_h, p.sdk_b, 64) &&
      map_bthd(&maps.out_b, ty, p.dv, p.d, p.tk, p.Hkv, p.B, p.sdv_t,
               p.sdv_h, p.sdv_b, 64) &&
      (!has_bias ||
       map_bias(&maps.bias, p.bias, p.B, p.tq, p.tk, p.sb_b, p.sb_t, BQ));
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_wgmma_kernel<T, L>;
  static const cudaError_t configured = allow_smem(
      kernel, L::bytes(true) <= SMEM_OPTIN ? L::bytes(true)
                                           : L::bytes(false));
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tk + L::BKV - 1) / L::BKV, p.Hkv, p.B);
  kernel<<<grid, L::THREADS, L::bytes(has_bias), st>>>(maps, p);
  return cudaGetLastError();
}

// The rule's tiles (`Tile<width, warpgroups, the other side's tile,
// blocks an SM, producer warp, stages>`), each the fastest measured
// without a spill on the H100 (chip_smoke.py phase 8 prints ptxas's
// report): dQ 64 x 64 keys, at width 64 three blocks an SM with a
// producer warp and a 3-stage ring (128 registers), at 128 two blocks of
// one warpgroup (191); dK/dV 64 keys x 128 queries at width 64 and x 64 at
// 128, two blocks of one warpgroup (255).
template <typename T>
cudaError_t dq_by_dim(const BwdParams& p, int head_dim, cudaStream_t st) {
  if (head_dim == 64)
    return launch_dq<T, DqTile<64, 1, 64, 3, true, 3>>(p, st);
  if (head_dim == 128)
    return launch_dq<T, DqTile<128, 1, 64, 2, false, 2>>(p, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dkv_by_dim(const BwdParams& p, int head_dim, cudaStream_t st) {
  if (head_dim == 64)
    return launch_dkv<T, DkvTile<64, 1, 128, 2, false, 2>>(p, st);
  if (head_dim == 128)
    return launch_dkv<T, DkvTile<128, 1, 64, 2, false, 2>>(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 on success).
// head_dim is the instantiated width (64 or 128, >= p->d); dtype 1 bf16,
// 2 fp16.  Every view must meet TMA's rules (the wrapper's `_tma_ok`): a
// map that cuTensorMapEncodeTiled refuses returns cudaErrorInvalidValue,
// launching nothing.
extern "C" int flash_attention_bwd_dq_wgmma(const BwdParams* p, int head_dim,
                                            int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(dq_by_dim<__nv_bfloat16>(*p, head_dim, st));
  if (dtype == 2) return static_cast<int>(dq_by_dim<__half>(*p, head_dim, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dkv_wgmma(const BwdParams* p,
                                             int head_dim, int dtype,
                                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(dkv_by_dim<__nv_bfloat16>(*p, head_dim, st));
  if (dtype == 2)
    return static_cast<int>(dkv_by_dim<__half>(*p, head_dim, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
