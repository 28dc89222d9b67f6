// Quantized matmul for Hopper (sm_90a) on `wgmma` and TMA, plain C
// interface.
//
// Replaces, for the prefill and training rows (M > 64) of bf16, fp16 and
// fp32 x, the Pallas TPU kernel apex_tpu/quant/kernels.py `_qmm_kernel`
// (launched by `_pallas_qmm`).  It computes the function of quant.cu's
// header unchanged:
//   qx[m, k]   = clamp(rint(x[m, k] * (1 / xs)), -127, 127)   (fp32, RNE)
//   acc[m, n]  = sum_k qx[m, k] * qw[n, k]                    (int32, exact)
//   out[m, n]  = float(acc) * (xs * ws[n])  rounded once to the output type
// for x [M, K], qw [N, Kp] int8 (K contiguous, zero columns to Kp, the next
// multiple of 16), xs one fp32 value and ws [N] fp32, with the plain
// version `_qmm_ref`'s ops in the same order (IEEE `1 / xs`, __fmul_rn,
// the rounding by a float add of 1.5 * 2^23).  Integer sums are exact in
// any order, so the kernel equals the plain version, and quant.cu's
// kernels, bit for bit.  The decode rows (M <= 64) stay on quant.cu's
// split-K kernel: they are bound by the weight's bytes, and a 64-row
// `wgmma` tile would multiply 7/8 zeros there.
//
// What bounds it on the H100: 2 M N K operations at 1979 TOP/s against the
// bytes of x, qw and out; at M 1024 and 8184 by N, K of 768 and 3072 the
// bytes bound (x bf16 is twice the int8 operand), but a kernel comes near
// either only if the int8 tensor cores stay fed while x is quantized.
// quant.cu fed `mma.sync` (the sm_80 instruction, half of `wgmma`'s rate)
// from `ldmatrix` fragments.  Here:
//  * one producer warp, of which one thread issues TMA loads into a ring
//    of stages under full / empty `mbarrier`s: x's [BM, 128] tile in its own
//    dtype (no swizzle: the consumers read it with ordinary loads) and
//    qw's [BN, 128] int8 tile in `wgmma`'s K-major 128-byte-swizzled
//    layout (CU_TENSOR_MAP_SWIZZLE_128B writes it).  TMA's zero fill past
//    the tensor covers the K tail (x's columns past K, qw's past Kp) and
//    the rows past M and N, so the integer sums are those of the unpadded
//    product;
//  * consumer warpgroups of 64 rows each: NC of them over the tile's rows,
//    times KS over its K steps (KS 2 gives a 64-row tile two warpgroups,
//    on alternate steps, whose int32 sums the epilogue adds: a lone
//    warpgroup an SM hides no latency, and M 1024 at N 768 has only 96
//    tiles of 64 x 128 for 132 SMs).  Each quantizes its rows of an x
//    stage once into its own int8 tile in the same swizzled K-major form
//    (double-buffered), then issues `wgmma.mma_async m64n128k32.s32.s8.s8`
//    with both operands in shared memory and int32 accumulators in
//    registers, NB of them a K step of 32 for a 128 NB wide tile.  The
//    quantize of its next step runs while the products of this one are in
//    flight; one named barrier a step orders the int8 tile's writes before
//    the products that read it, and the products before the next writes
//    over it;
//  * the epilogue: the int32 tile through shared memory (the ring is free
//    by then), then 8 columns of a row a thread, dequantized for 16-byte
//    stores: stored straight from the accumulators, 4 bytes a lane on 8
//    rows, the tile's epilogue cost as much as its products;
//  * ptxas allocates the consumers within the launch's register count
//    whatever `setmaxnreg` asks (flash_attention_sm90.cu's finding), so
//    the producer is one warp.
// Tiles (BM x BN): 128 x 256 (two warpgroups over the rows, 128 int32
// accumulators a thread), 64 x 256 for fp32 x (whose stage is twice the
// bytes; two warpgroups over K), 128 x 128 (two over the rows) and 64 x
// 128 (two over K); the rule (`plan`) takes the wide tile where its tiles
// fill half the SMs or more, else 64 x 128, as quant.cu's.
// The tensor maps are `__grid_constant__` kernel parameters (a CUDA graph
// holds them), encoded once per weight and address (sm90::map_2d).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qmm_quantize.cuh"
#include "sm90.cuh"

namespace {

using namespace qmm;
using namespace sm90;

constexpr int BK = 128;           // K (int8 values) a stage

struct Maps {
  CUtensorMap x, w;
};

struct Args {
  const float* xs;
  const float* ws;
  void* out;
  int M, N, K, Kp, out_code;
};

// out[i .. i + 7] (16- or 32-byte aligned)
__device__ __forceinline__ void store8(void* out, int64_t i, const float* v,
                                       int code) {
  if (code == 0) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + i);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if (code == 1) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
      w[h] = *reinterpret_cast<const uint32_t*>(&p);
    } else {
      const __half2 p = __floats2half2_rn(v[2 * h], v[2 * h + 1]);
      w[h] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
  *reinterpret_cast<uint4*>(static_cast<char*>(out) + 2 * i) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// Shared memory of a block: the ring (x then qw each stage, every tile
// 1024-byte aligned), each consumer warpgroup's two int8 tiles, the
// barriers, plus 1024 bytes to align the base.  After the K loop the
// ring holds the int32 tile [BM][BN + 8] for the epilogue.
template <typename TX, int NC, int NB, int KS>
struct Tile {
  static constexpr int BM = 64 * NC, BN = 128 * NB;
  static constexpr int CWG = NC * KS;                 // consumer warpgroups
  static constexpr int THREADS = CWG * 128 + 32;
  static constexpr int X_BYTES = BM * BK * static_cast<int>(sizeof(TX));
  static constexpr int W_BYTES = BN * BK;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int AQ_BYTES = 64 * BK;            // one int8 tile
  static constexpr int FIXED = CWG * 2 * AQ_BYTES + 64 + 1024;
  static constexpr int FIT = (SMEM_OPTIN - FIXED) / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int OFF_AQ = STAGES * STAGE;
  static constexpr int OFF_BAR = OFF_AQ + CWG * 2 * AQ_BYTES;
  static constexpr int BYTES = OFF_BAR + 2 * STAGES * 8 + 1024;
  static constexpr int LDC = BN + 8;                  // ints: no conflicts
  static_assert(STAGES >= 2 && BYTES <= SMEM_OPTIN, "tile fits");
  static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "aligned");
  static_assert(BM * LDC * 4 <= STAGES * STAGE, "the int32 tile fits");
};

// One block: the [BM, BN] output tile (blockIdx.y, blockIdx.x).  Consumer
// warpgroup wg takes rows 64 (wg % NC) ..  of the tile and, of the K steps,
// those with j % KS == wg / NC: KS 2 splits a 64-row tile's K steps over two
// warpgroups, whose int32 sums are added in the epilogue.
template <typename TX, int NC, int NB, int KS>
__global__ void __launch_bounds__(Tile<TX, NC, NB, KS>::THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ Maps maps, const Args a) {
  using L = Tile<TX, NC, NB, KS>;
  constexpr int S = L::STAGES, CT = L::CWG * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full0 = smem_u32(base + L::OFF_BAR);
  const uint32_t empty0 = full0 + 8 * S;
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * L::BN;
  const int n = (a.Kp + BK - 1) / BK;                  // K steps, >= 1

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NC);   // each reading warp's lane 0
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == L::CWG) {                      // the producer warp
    if (threadIdx.x == CT) {
      prefetch_map(&maps.x);
      prefetch_map(&maps.w);
      for (int j = 0; j < n; ++j) {
        const int s = j % S;
        if (j >= S) mbar_wait(empty0 + 8 * s, ((j / S) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, L::STAGE);
        unsigned char* st = base + s * L::STAGE;
        tma_load_2d(st, &maps.x, full, j * BK, m0);
        tma_load_2d(st + L::X_BYTES, &maps.w, full, j * BK, n0);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [64 mr, 64 mr + 64) of the tile, K steps
  // kp, kp + KS, ...
  const int mr = wg % NC, kp = wg / NC;
  const int tw = threadIdx.x & 127, warp = tw >> 5, lane = tw & 31;
  const float xs = *a.xs;
  const float inv = 1.0f / xs;
  int8_t* aq = reinterpret_cast<int8_t*>(base + L::OFF_AQ) +
               wg * 2 * L::AQ_BYTES;

  // x stage s's rows of this warp (16 of them, 16 w .. 16 w + 15 of the
  // warpgroup's) quantized into int8 tile `buf`: 16-byte chunks of x along
  // a row to consecutive lanes
  constexpr int CPR = BK * static_cast<int>(sizeof(TX)) / 16;  // chunks a row
  constexpr int EPC = 16 / static_cast<int>(sizeof(TX));
  constexpr int ITERS = 16 * CPR / 32;
  auto quantize = [&](int s, int buf) {
    const unsigned char* src = base + s * L::STAGE;
    int8_t* dst = aq + buf * L::AQ_BYTES;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int c = lane + 32 * i;
      const int r = warp * 16 + c / CPR, kc = c % CPR;  // row in the WG
      const int byte = kc * EPC;
      quantize16<TX>(src + ((mr * 64 + r) * BK + byte) * sizeof(TX),
                     dst + swz(r, byte >> 4) + (byte & 15), inv);
    }
  };

  int acc[NB][64];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[b][i] = 0;

  const int bar_id = 1 + wg;
  if (kp < n) {
    mbar_wait(full0 + 8 * (kp % S), (kp / S) & 1);
    quantize(kp % S, 0);
    fence_proxy_async();
    named_bar(bar_id, 128);
  }
  for (int j = kp, it = 0; j < n; j += KS, ++it) {
    const int s = j % S;
    const uint32_t a_addr = smem_u32(aq + (it & 1) * L::AQ_BYTES);
    const uint32_t w_addr = smem_u32(base + s * L::STAGE + L::X_BYTES);
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        wgmma_s8_n128(acc[b], gmma_desc(a_addr + ks * 32, 16, 1024),
                      gmma_desc(w_addr + b * 128 * BK + ks * 32, 16, 1024));
    wgmma_commit();
    const int jn = j + KS;
    if (jn < n) {                          // beside the products of step j
      mbar_wait(full0 + 8 * (jn % S), (jn / S) & 1);
      quantize(jn % S, (it + 1) & 1);
      fence_proxy_async();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);   // stage s is read
    named_bar(bar_id, 128);
  }

  // The epilogue.  Every consumer is past its last step, so every load has
  // landed and the ring is free: the int32 tile goes there (the second K
  // half added to the first), then each thread dequantizes 8 columns of a
  // row at a time for 16-byte stores.  Element 4 i + r of accumulator b is
  // row g + 8 (r >> 1) of the warp's 16, column 128 b + 8 i + 2 t + (r & 1).
  constexpr int LDC = L::LDC;
  int* ct = reinterpret_cast<int*>(base);
  const int g = lane >> 2, t = lane & 3;
  named_bar(15, CT);
#pragma unroll
  for (int pass = KS - 1; pass >= 0; --pass) {
    if (kp == pass) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int2* d = reinterpret_cast<int2*>(
                ct + (mr * 64 + warp * 16 + g + 8 * h) * LDC + 128 * b +
                8 * i + 2 * t);
            int2 v = make_int2(acc[b][4 * i + 2 * h], acc[b][4 * i + 2 * h + 1]);
            if (pass < KS - 1) {
              const int2 o = *d;
              v.x += o.x;
              v.y += o.y;
            }
            *d = v;
          }
    }
    named_bar(15, CT);
  }
  const int ct_id = threadIdx.x;                       // 0 .. CT - 1
  const bool vec = (a.N & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.ws) & 15) == 0;
  for (int id = ct_id; id < L::BM * (L::BN / 8); id += CT) {
    const int r = id / (L::BN / 8), c8 = id % (L::BN / 8) * 8;
    const int gm = m0 + r, gn = n0 + c8;
    if (gm >= a.M || gn >= a.N) continue;
    const int4 q0 = *reinterpret_cast<const int4*>(ct + r * LDC + c8);
    const int4 q1 = *reinterpret_cast<const int4*>(ct + r * LDC + c8 + 4);
    const int q[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    const int64_t idx = static_cast<int64_t>(gm) * a.N + gn;
    float v[8];
    if (vec) {
      const float4 w0 = *reinterpret_cast<const float4*>(a.ws + gn);
      const float4 w1 = *reinterpret_cast<const float4*>(a.ws + gn + 4);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = __fmul_rn(__int2float_rn(q[e]), __fmul_rn(xs, w[e]));
      store8(a.out, idx, v, a.out_code);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (gn + e < a.N)
          store1(a.out, idx + e,
                 __fmul_rn(__int2float_rn(q[e]), __fmul_rn(xs, a.ws[gn + e])),
                 a.out_code);
    }
  }
}

// -- launchers ---------------------------------------------------------------

int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = v > 0 ? v : 132;
  }
  return sms[dev];
}

// The tile (bm, bn) of a call: the caller's (a half at -1 is the rule's),
// or the rule's: the wide tile (128 x 256; 64 x 256 for fp32 x) where its
// tiles fill half the SMs or more, else 64 x 128.  False for a pair the
// kernel lacks, and for the decode rows (M <= 64, quant.cu's).
bool plan(int M, int N, int x_size, int& bm, int& bn) {
  if (M <= 64) return false;
  const int wide_bm = x_size == 4 ? 64 : 128;
  const bool wide = N >= 256 && 2 * ((M + wide_bm - 1) / wide_bm) *
                                        ((N + 255) / 256) >= sm_count();
  const int rbm = wide ? wide_bm : 64, rbn = wide ? 256 : 128;
  bm = bm > 0 ? bm : rbm;
  bn = bn > 0 ? bn : rbn;
  return (bm == wide_bm && bn == 256) || (bm == 128 && bn == 128) ||
         (bm == 64 && bn == 128);
}

template <typename TX, int NC, int NB, int KS>
cudaError_t launch(const Maps& maps, const Args& a, cudaStream_t st) {
  using L = Tile<TX, NC, NB, KS>;
  auto kernel = qmm_wgmma_kernel<TX, NC, NB, KS>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((a.N + L::BN - 1) / L::BN, (a.M + L::BM - 1) / L::BM);
  kernel<<<grid, L::THREADS, L::BYTES, st>>>(maps, a);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t by_tile(const void* x, const void* qw, const Args& a, int bm,
                    int bn, cudaStream_t st) {
  constexpr bool F32 = sizeof(TX) == 4;
  const int ty = F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : std::is_same<TX, __nv_bfloat16>::value
                           ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  Maps maps;
  const MapKey xk{x, static_cast<uint64_t>(a.M), static_cast<uint64_t>(a.K),
                  static_cast<uint64_t>(a.K) * sizeof(TX), BK,
                  static_cast<uint32_t>(bm), ty, CU_TENSOR_MAP_SWIZZLE_NONE};
  const MapKey wk{qw, static_cast<uint64_t>(a.N), static_cast<uint64_t>(a.Kp),
                  static_cast<uint64_t>(a.Kp), BK, static_cast<uint32_t>(bn),
                  CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_128B};
  if (!map_2d(&maps.x, xk) || !map_2d(&maps.w, wk))
    return cudaErrorInvalidValue;
  if (bm == 64 && bn == 256) return launch<TX, 1, 2, 2>(maps, a, st);
  if (bm == 128 && bn == 256 && !F32) return launch<TX, 2, 2, 1>(maps, a, st);
  if (bm == 128 && bn == 128) return launch<TX, 2, 1, 1>(maps, a, st);
  if (bm == 64 && bn == 128) return launch<TX, 1, 1, 2>(maps, a, st);
  return cudaErrorInvalidValue;
}

int x_size(int x_dtype) { return x_dtype == 0 ? 4 : 2; }

}  // namespace

// The tile a call runs (bm, bn: the caller's, a half at -1 the rule's):
// writes it to tile[0..1] and returns 0, or returns -1 when the kernel has
// no such tile or the rows are decode rows (M <= 64).
extern "C" int quant_matmul_sm90_tile(int M, int N, int x_dtype, int bm,
                                      int bn, int* tile) {
  if (!plan(M, N, x_size(x_dtype), bm, bn)) return -1;
  tile[0] = bm;
  tile[1] = bn;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x [M, K] of dtype code x_dtype (0 fp32, 1 bf16, 2 fp16), row-major, its
// start 16-byte aligned and K * itemsize a multiple of 16 (TMA's rules; the
// wrapper's routing rule); qw [N, Kp] int8 with Kp a multiple of 16, K <=
// Kp, 16-byte aligned; xs one fp32 value and ws [N] fp32 in device memory;
// out [M, N] of dtype code out_dtype.  bm, bn: the tile (a half at -1 is
// the rule's).  M > 64.  A map cuTensorMapEncodeTiled refuses returns
// cudaErrorInvalidValue, launching nothing.
extern "C" int quant_matmul_sm90(const void* x, const void* qw,
                                 const float* xs, const float* ws, void* out,
                                 int M, int N, int K, int Kp, int x_dtype,
                                 int out_dtype, int bm, int bn,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype < 0 || out_dtype > 2 || Kp % 16 || K > Kp)
    return cudaErrorInvalidValue;
  if (!plan(M, N, x_size(x_dtype), bm, bn)) return cudaErrorInvalidValue;
  const Args a{xs, ws, out, M, N, K, Kp, out_dtype};
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0) err = by_tile<float>(x, qw, a, bm, bn, st);
  else if (x_dtype == 1) err = by_tile<__nv_bfloat16>(x, qw, a, bm, bn, st);
  else if (x_dtype == 2) err = by_tile<__half>(x, qw, a, bm, bn, st);
  return static_cast<int>(err);
}
