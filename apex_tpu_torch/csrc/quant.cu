// Quantized matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel apex_tpu/quant/kernels.py `_qmm_kernel`
// (launched by `_pallas_qmm`): quantize the activation block to int8
// inside the kernel, an int8 x int8 -> int32 product, and the dequantize
// epilogue before the store.  x never exists as int8 in device memory.
//
// What it computes, for x [M, K] (fp32, bf16 or fp16), qw [N, Kp] int8 (the
// weight quantized per output channel, K contiguous, padded with zero
// columns to Kp, the next multiple of 16), a per-tensor scale xs (one fp32
// value in device memory) and per-channel scales ws [N]:
//   qx[m, k]   = clamp(rint(x[m, k] * (1 / xs)), -127, 127)   (fp32, RNE)
//   acc[m, n]  = sum_k qx[m, k] * qw[n, k]                    (int32, exact)
//   out[m, n]  = float(acc) * (xs * ws[n])  rounded once to the output type
// with the ops of the plain version `_qmm_ref` in the same order: `1 / xs`
// is an IEEE division (no -use_fast_math), the products are __fmul_rn so
// nothing contracts into an FMA.  Integer sums are exact in any order
// (split-K partials included), so the kernel equals the plain version
// bit for bit.
//
// What bounds it on the H100, and what the design does about it:
//  * Prefill and training rows (M > 64; M 1024 and 8184 at K, N of 768 and
//    3072) are bound by operations in principle (2 M N K at 1979 TOP/s
//    against the bytes of x, qw and out), but at these sizes by how fast
//    a block can feed `mma.sync` and by filling 132 SMs:
//    - one block owns a BM x BN output tile: 128 x 256 (64 x 256 for fp32
//      x, whose stage is then as many bytes), 8 warps as 2 (M) x 4 (N),
//      where those tiles fill half the SMs or more (M 8184); else 64 x
//      128, 8 warps as 2 x 4, two blocks an SM (M 1024 at N 768: 96
//      tiles, where 128 x 256 gave 24);
//    - K runs in steps of 128 bytes through a 3-stage ring of 16-byte
//      `cp.async` copies: x's tile in its own dtype and qw's tile, straight
//      from device memory into shared memory, no register staging;
//    - each x stage is quantized once per block, shared memory to an int8
//      tile (double-buffered): the quantize pass of step j + 1 runs beside
//      the products of step j, one barrier a step; every x element is
//      quantized once per N tile, so the 256-wide tile halves that work;
//      the rounding is a float add of 1.5 * 2^23, not a conversion;
//    - A and B fragments of `mma.sync.m16n8k32.s8` come by `ldmatrix` (an
//      int8 row of 16 bytes is one b16 row of an 8 x 8 matrix); the int8
//      tiles' 128-byte rows are swizzled (16-byte chunk c of row r at
//      c ^ (r & 7)), so `ldmatrix` and the copies have no bank conflicts;
//    - the int32 tile goes through shared memory to a row-major epilogue
//      (4 columns a thread, 8- or 16-byte stores): stored from the
//      fragments, 4 bytes a lane, it measured slower than the products
//      at M 8184;
//    - they do not split K: with its partial sums a split measured slower
//      than the unsplit grid at every prefill shape.
//  * Decode rows (M <= 64) are bound by the weight's bytes (N Kp, 0.6 to
//    2.4 MB a call): the weight is spread over the SMs in narrow tiles
//    (BM 16 or 64 rows, BN 32, 4 warps) and K is split so that about two
//    blocks an SM stream it.
//  * Split K: each block adds its int32 partial tile into an int32
//    workspace by `atomicAdd` (exact in any order; from the shared tile,
//    so a warp's atomics are contiguous); the last block to arrive at a
//    tile (a per-tile arrival counter after `__threadfence`) runs the
//    dequantize epilogue, and sets the workspace tile and its counter
//    back to zero, so a call is one launch.  The wrapper owns the
//    workspace (zeroed once, `quant_matmul_workspace` gives its size);
//    calls that share one must be ordered on one stream.
//
// Ragged edges: rows past M and N and K past Kp are copies of source size
// 0 (zeros); x's columns from K to Kp read as zero (element loads where K
// is no multiple of 8 or x is not 16-byte aligned), against qw's zero
// padding, so the integer sums are those of the unpadded product; the
// epilogue masks its stores.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_quantize.cuh"

namespace {

using namespace qmm;

constexpr int BK = 128;           // K bytes (int8 elements) per stage
constexpr int STAGES = 3;         // the cp.async ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk `c` of row `r` in a swizzled [*][128] tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ (r & 7)) << 4);
}

// The dequantized value, stored in the output type (0 fp32, 1 bf16, 2
// fp16) at out[i] (store1, qmm_quantize.cuh) or four at out[i .. i + 3].
__device__ __forceinline__ float dequant(int acc, float s) {
  return __fmul_rn(__int2float_rn(acc), s);
}
// out[i .. i + 3] (i a multiple of 4: 16- or 8-byte aligned)
__device__ __forceinline__ void store4(void* out, int64_t i, float a,
                                       float b, float c, float d, int code) {
  if (code == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) =
        make_float4(a, b, c, d);
  } else if (code == 1) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    const __half2 lo = __floats2half2_rn(a, b);
    const __half2 hi = __floats2half2_rn(c, d);
    *reinterpret_cast<uint2*>(static_cast<__half*>(out) + i) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
}

struct Args {
  const void* x;
  const int8_t* qw;
  const float* xs;
  const float* ws;
  void* out;
  int* work;          // [counters (align32(tiles))][tiles][BM * BN] or null
  int M, N, K, Kp, vec, out_code;
  int steps;          // K steps of each split (gridDim.z splits)
};

// One block: the [BM, BN] output tile (blockIdx.y, blockIdx.x) over K steps
// [z * steps, (z + 1) * steps) of split z = blockIdx.z.
template <typename TX, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N,
                                  BM * BN >= 128 * 128 ? 1 : 2)
qmm_kernel(const Args a) {
  constexpr int NT = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // warp sub-tile
  constexpr int MI = WM / 16, NI = WN / 8;             // mma tiles a warp
  constexpr int EPC = 16 / sizeof(TX);                 // x elements a chunk
  constexpr int CPR = BK / EPC;                        // x chunks a row
  constexpr int XC = BM * CPR / NT;                    // x chunks a thread
  constexpr int WC = BN * (BK / 16) / NT;              // qw chunks a thread
  constexpr int XSTAGE = BM * BK * sizeof(TX);         // bytes
  constexpr int WSTAGE = BN * BK;
  static_assert(MI >= 1 && NI >= 1 && XC >= 1 && WC >= 1 && BK / 32 == 4 &&
                    BM * CPR % NT == 0 && BN * (BK / 16) % NT == 0,
                "tile shape");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xring = smem;                         // [STAGES][BM][BK] TX
  int8_t* wring = reinterpret_cast<int8_t*>(smem + STAGES * XSTAGE);
  int8_t* aq = wring + STAGES * WSTAGE;                // [2][BM][BK] int8

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (a.Kp + BK - 1) / BK;
  const int kb = blockIdx.z * a.steps;
  const int n = min(nk, kb + a.steps) - kb;            // >= 1 (the host)
  const float xs = *a.xs;
  const float inv = 1.0f / xs;
  const TX* x = static_cast<const TX*>(a.x);

  // stage j of this split: x's [BM, BK] block into x slot j % STAGES
  auto load_x = [&](int j) {
    if (j >= n) return;
    TX* dst = reinterpret_cast<TX*>(xring + (j % STAGES) * XSTAGE);
    const int k0 = (kb + j) * BK;
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const int c = tid + i * NT;
      const int row = c / CPR, kc = c % CPR;
      const int gm = m0 + row, gk = k0 + kc * EPC;
      TX* d = dst + row * BK + kc * EPC;
      const TX* src = x + static_cast<int64_t>(gm) * a.K + gk;
      if (a.vec) {
        const bool ok = gm < a.M && gk < a.K;
        cp_async16(d, ok ? src : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          d[e] = (gm < a.M && gk + e < a.K) ? src[e] : TX(0.f);
      }
    }
  };
  // ... and qw's [BN, BK] block into qw slot j % STAGES, swizzled
  auto load_w = [&](int j) {
    if (j >= n) return;
    int8_t* dst = wring + (j % STAGES) * WSTAGE;
    const int k0 = (kb + j) * BK;
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      const int c = tid + i * NT;
      const int row = c / (BK / 16), kc = c % (BK / 16);
      const int gn = n0 + row, gk = k0 + kc * 16;
      const bool ok = gn < a.N && gk < a.Kp;
      cp_async16(dst + swz(row, kc),
                 ok ? a.qw + static_cast<int64_t>(gn) * a.Kp + gk : a.qw, ok);
    }
  };
  // x slot j % STAGES quantized into int8 tile j & 1 (once per block), in
  // four parts, each issued beside a k32 step's products
  auto quantize = [&](int j, int part) {
    const unsigned char* src = xring + (j % STAGES) * XSTAGE;
    int8_t* dst = aq + (j & 1) * BM * BK;
#pragma unroll
    for (int i = part * XC / 4; i < (part + 1) * XC / 4; ++i) {
      const int c = tid + i * NT;
      const int row = c / CPR, kc = c % CPR;
      const int byte = kc * EPC;                       // int8 column
      quantize16<TX>(src + (row * BK + kc * EPC) * sizeof(TX),
                     dst + swz(row, byte >> 4) + (byte & 15), inv);
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  // groups: {x_0}, then g_j = {x_(j+1), qw_j}; g_j must have landed when
  // step j begins, g_(j+1) may still fly
  load_x(0);
  cp_async_commit();
  load_x(1);
  load_w(0);
  cp_async_commit();
  load_x(2);
  load_w(1);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();
#pragma unroll
  for (int part = 0; part < 4; ++part) quantize(0, part);

  for (int j = 0; j < n; ++j) {
    cp_async_wait<1>();
    __syncthreads();        // g_j landed; step j - 1's reads are done
    load_x(j + 3);          // into x slot j % 3 (x_j quantized at j - 1)
    load_w(j + 2);          // into qw slot (j - 1) % 3
    cp_async_commit();
    const int8_t* A = aq + (j & 1) * BM * BK;
    const int8_t* B = wring + (j % STAGES) * WSTAGE;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = wm * WM + mi * 16 + (lane & 15);
        ldsm_x4(af[mi], A + swz(row, 2 * ks + (lane >> 4)));
      }
      if constexpr (NI == 1) {
        const int row = wn * WN + (lane & 7);
        ldsm_x2(bf[0][0], bf[0][1], B + swz(row, 2 * ks + ((lane >> 3) & 1)));
      } else {
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          const int row = wn * WN + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          uint32_t r[4];
          ldsm_x4(r, B + swz(row, 2 * ks + ((lane >> 3) & 1)));
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
      if (j + 1 < n) quantize(j + 1, ks);   // beside the products
    }
  }
  cp_async_wait<0>();

  // The int32 tile through shared memory (the ring is free now), so
  // that the epilogue reads and writes whole rows.
  constexpr int LDC = BN + 8;          // ints: conflict-free 8-byte stores
  static_assert(BM * LDC * 4 <= STAGES * (XSTAGE + WSTAGE) + 2 * BM * BK,
                "the int32 tile fits the ring");
  int* ct = reinterpret_cast<int*>(smem);
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * WM + mi * 16 + g + 8 * h;
        const int col = wn * WN + ni * 8 + 2 * t;
        *reinterpret_cast<int2*>(ct + row * LDC + col) =
            make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  __syncthreads();

  // 4 columns a thread, consecutive threads along a row
  constexpr int Q = BN / 4;
  const bool vec_out = (a.N & 3) == 0;
  auto dequant_store = [&](int r, int c4, int4 v) {
    const int gm = m0 + r, gn = n0 + c4;
    if (gm >= a.M || gn >= a.N) return;
    const int64_t i = static_cast<int64_t>(gm) * a.N + gn;
    const int vv[4] = {v.x, v.y, v.z, v.w};
    if (vec_out) {
      const float4 w4 = *reinterpret_cast<const float4*>(a.ws + gn);
      store4(a.out, i, dequant(vv[0], __fmul_rn(xs, w4.x)),
             dequant(vv[1], __fmul_rn(xs, w4.y)),
             dequant(vv[2], __fmul_rn(xs, w4.z)),
             dequant(vv[3], __fmul_rn(xs, w4.w)), a.out_code);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gn + e < a.N)
          store1(a.out, i + e, dequant(vv[e], __fmul_rn(xs, a.ws[gn + e])),
                 a.out_code);
    }
  };

  if (gridDim.z == 1) {
    for (int i = tid; i < BM * Q; i += NT) {
      const int r = i / Q, c4 = (i % Q) * 4;
      dequant_store(r, c4, *reinterpret_cast<const int4*>(ct + r * LDC + c4));
    }
    return;
  }

  // split K: add the partial tile into the workspace (coalesced, zeros
  // skipped); the last block to arrive dequantizes the tile and leaves
  // the workspace and its counter 0
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int n_tiles = gridDim.x * gridDim.y;
  int* counter = a.work + tile;
  int* part = a.work + ((n_tiles + 31) & ~31) +
              static_cast<int64_t>(tile) * BM * BN;
  for (int i = tid; i < BM * Q; i += NT) {
    const int r = i / Q, c4 = (i % Q) * 4;
    const int4 v = *reinterpret_cast<const int4*>(ct + r * LDC + c4);
    int* d = part + r * BN + c4;
    if (v.x) atomicAdd(d, v.x);
    if (v.y) atomicAdd(d + 1, v.y);
    if (v.z) atomicAdd(d + 2, v.z);
    if (v.w) atomicAdd(d + 3, v.w);
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0)
    last = atomicAdd(counter, 1) == static_cast<int>(gridDim.z) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < BM * Q; i += NT) {
    const int r = i / Q, c4 = (i % Q) * 4;
    int4* d = reinterpret_cast<int4*>(part + r * BN + c4);
    const int4 v = __ldcg(d);
    if (v.x | v.y | v.z | v.w) *d = make_int4(0, 0, 0, 0);
    dequant_store(r, c4, v);
  }
  if (tid == 0) *counter = 0;
}

// -- launchers ---------------------------------------------------------------

// A call's tiles and K splits.  kind 0: decode, BM 16; 1: decode, BM 64
// (both BN 32, K split); 2: BM 128 (64 for fp32 x) x BN 256, one block
// an SM; 3: BM 64 x BN 128, two blocks an SM.  Rows above 64 take the
// 256-wide tile where its tiles fill half the SMs or more (it quantizes
// each x element half as often), else the narrow one, whose grid is four
// times finer; they never split K: on the card a split of those tiles,
// with its int32 partial sums, measured slower than the unsplit grid at
// every prefill shape.
struct Plan {
  int kind, bm, bn, tiles_m, tiles_n, splits, steps;
};

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

// bm, bn: the caller's tile, one of the four below (16 x 32, 64 x 32,
// the wide 128 x 256 or, for fp32 x, 64 x 256, and 64 x 128); a half
// at -1 is the rule's (both -1: the rule's tile).  kind -1 refuses a
// pair the kernel lacks.  The K split follows the tile (decode rows
// only); int32 sums give the same bits at any split.
Plan plan(int M, int N, int Kp, int x_size, int bm = -1, int bn = -1) {
  Plan p;
  const int nk = (Kp + BK - 1) / BK;
  const int sms = sm_count();
  int splits = 1;
  const int wide_bm = x_size == 4 ? 64 : 128;
  if (M <= 64) {
    p.kind = M <= 16 ? 0 : 1;
    p.bm = M <= 16 ? 16 : 64;
    p.bn = 32;
  } else {
    const bool wide = N >= 256 && 2 * ((M + wide_bm - 1) / wide_bm) *
                                          ((N + 255) / 256) >= sms;
    p.kind = wide ? 2 : 3;
    p.bm = wide ? wide_bm : 64;
    p.bn = wide ? 256 : 128;
  }
  if (bm > 0 || bn > 0) {
    p.bm = bm > 0 ? bm : p.bm;
    p.bn = bn > 0 ? bn : p.bn;
    p.kind = p.bm == 16 && p.bn == 32 ? 0 : p.bm == 64 && p.bn == 32 ? 1
           : p.bm == wide_bm && p.bn == 256 ? 2
           : p.bm == 64 && p.bn == 128 ? 3 : -1;
    if (p.kind < 0) return p;
  }
  p.tiles_m = (M + p.bm - 1) / p.bm;
  p.tiles_n = (N + p.bn - 1) / p.bn;
  if (M <= 64) {            // about two blocks an SM stream the weight
    const int tiles = p.tiles_m * p.tiles_n;
    splits = tiles < 2 * sms ? 2 * sms / tiles : 1;
    splits = splits < 1 ? 1 : (splits > nk ? nk : splits);
  }
  p.steps = (nk + splits - 1) / splits;
  p.splits = (nk + p.steps - 1) / p.steps;   // every split has a step
  return p;
}

// int32 elements of the workspace a call needs (0 without a split)
int64_t workspace_ints(const Plan& p) {
  if (p.splits <= 1) return 0;
  const int64_t tiles = static_cast<int64_t>(p.tiles_m) * p.tiles_n;
  return ((tiles + 31) & ~31LL) + tiles * p.bm * p.bn;
}

template <typename TX, int BM, int BN, int WARPS_M, int WARPS_N>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t stream) {
  constexpr int smem = STAGES * (BM * BK * static_cast<int>(sizeof(TX)) +
                                 BN * BK) + 2 * BM * BK;
  auto kernel = qmm_kernel<TX, BM, BN, WARPS_M, WARPS_N>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid(p.tiles_n, p.tiles_m, p.splits);
  kernel<<<grid, 32 * WARPS_M * WARPS_N, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t by_plan(const Args& a, const Plan& p, cudaStream_t st) {
  constexpr int WBM = sizeof(TX) == 4 ? 64 : 128;
  switch (p.kind) {
    case 0: return launch<TX, 16, 32, 1, 4>(a, p, st);
    case 1: return launch<TX, 64, 32, 1, 4>(a, p, st);
    case 2: return launch<TX, WBM, 256, 2, 4>(a, p, st);
    case 3: return launch<TX, 64, 128, 2, 4>(a, p, st);
    case 4: return launch<TX, 64, 128, 2, 2>(a, p, st);
  }
  return cudaErrorInvalidValue;
}

int x_size(int x_dtype) { return x_dtype == 0 ? 4 : 2; }

}  // namespace

// int32 elements of the zeroed workspace quant_matmul needs at this shape
// (0: no K split).  The kernel leaves it zeroed.
// -1 when the kernel has no such tile (bm, bn as `plan`).
extern "C" int64_t quant_matmul_workspace(int M, int N, int Kp,
                                          int x_dtype, int bm, int bn) {
  const Plan p = plan(M, N, Kp, x_size(x_dtype), bm, bn);
  return p.kind < 0 ? -1 : workspace_ints(p);
}

// The tile a call runs (bm, bn as `plan`): writes it to tile[0..1] and
// returns 0, or returns -1 when the kernel has no such tile.
extern "C" int quant_matmul_tile(int M, int N, int Kp, int x_dtype, int bm,
                                 int bn, int* tile) {
  const Plan p = plan(M, N, Kp, x_size(x_dtype), bm, bn);
  if (p.kind < 0) return -1;
  tile[0] = p.bm;
  tile[1] = p.bn;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x [M, K] and out [M, N] of dtype codes x_dtype / out_dtype (0 fp32,
// 1 bf16, 2 fp16); qw [N, Kp] int8 with Kp a multiple of 16 and K <= Kp,
// 16-byte aligned (the wrapper checks both); xs one fp32 value and ws [N]
// fp32 in device memory; work: quant_matmul_workspace(...) zeroed int32
// elements (null when that is 0).  vec: K % 8 == 0 and x 16-byte aligned.
// bm, bn: the tile (`plan`; -1 for a half of the rule's).
extern "C" int quant_matmul(const void* x, const void* qw, const float* xs,
                            const float* ws, void* out, void* work, int M,
                            int N, int K, int Kp, int vec, int x_dtype,
                            int out_dtype, int bm, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype < 0 || out_dtype > 2) return cudaErrorInvalidValue;
  const Plan p = plan(M, N, Kp, x_size(x_dtype), bm, bn);
  if (p.kind < 0) return cudaErrorInvalidValue;
  if (workspace_ints(p) > 0 && work == nullptr) return cudaErrorInvalidValue;
  Args a{x, static_cast<const int8_t*>(qw), xs, ws, out,
         static_cast<int*>(work), M, N, K, Kp, vec, out_dtype, p.steps};
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0) err = by_plan<float>(a, p, st);
  else if (x_dtype == 1) err = by_plan<__nv_bfloat16>(a, p, st);
  else if (x_dtype == 2) err = by_plan<__half>(a, p, st);
  return static_cast<int>(err);
}
