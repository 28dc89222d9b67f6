// NHWC implicit-GEMM convolution forward for Hopper (sm_90a) on `wgmma`,
// plain C interface.
//
// Replaces, for bf16 and fp16 operands whose channel count C is a multiple
// of 64 (every ResNet-50 conv but the C = 3 stem), the Pallas TPU kernel
// apex_tpu/ops/conv.py `_fwd_kernel` (launched by `_im2col_conv` for
// `_pallas_fwd`).  It computes conv.cu's forward unchanged (x [N,H,W,C], w
// HWIO [KH,KW,C,O], y [N,OH,OW,O], all contiguous; a tap (kh, kw) reads x
// at ih = oh*sh - pt + kh*dh, iw = ow*sw - pl + kw*dw, zero outside the
// image): the GEMM M = N*OH*OW, N = O, K = KH*KW*C (k = tap*C + c) with
// fp32 accumulators, the result rounded to the operands' type `res`, and
// the optional epilogue
//   out = relu((res - mean) * invstd * scale + bias + z)
// one rounding at a time (__fmul_rn / __fadd_rn), which equals the conv
// followed by the port's plain `fused_bn_act._fwd_ref` bit for bit; the
// pre-activation `res` is written too when asked for.  C must be a
// multiple of 64, O of 8, and every tensor 16-byte aligned; the wrapper's
// `_fwd_route` sends every other call to conv.cu.
//
// What bounds it on the H100: at ResNet-50's shapes a GEMM of hundreds of
// operations a byte, so the bf16 tensor cores (989 TFLOP/s), which only
// `wgmma` reaches; conv.cu's `mma.sync` ring ran 1.9-2.3x cuDNN.  Here:
//  * a K step is 64 channels of one tap (C is a multiple of 64), so the A
//    tile is one 128-byte row a output pixel: every thread gathers 16-byte
//    chunks of its fixed rows with `cp.async` straight into `wgmma`'s
//    K-major 128-byte-swizzled layout (chunk c of row r at c ^ (r & 7)); a
//    tap outside the image and a row past M are zero-filled by the copy's
//    source size of 0.  A row's image base, ih0 and iw0 are decoded once,
//    before the K loop (conv.cu's gather), and the tap advances by
//    counters, so a step costs a bounds test a row;
//  * the B tile is w viewed as [KH*KW*C, O] (O contiguous), loaded by TMA
//    (one thread, an `mbarrier` a stage) as BN / 64 panels of [64 k][64 o]
//    with the 128-byte swizzle: an MN-major operand, read through the
//    instruction's transpose bit (SBO 1024, LBO one panel), as
//    flash_attention_sm90.cu reads V;
//  * two consumer warpgroups of 64 rows each issue `wgmma.mma_async
//    m64nBNk16` (BN 128, or 64 where O is 64) with both operands in shared
//    memory, four a K step; a ring of 3 stages, refilled while the
//    products run, and two blocks an SM, so one block's loads and
//    epilogue overlap the other's products.  Every thread both loads and
//    multiplies: a warp specialised to gather would hold as many registers
//    as a consumer (ptxas allocates the launch's count whatever
//    `setmaxnreg` asks, flash_attention_sm90.cu's finding) and leave fewer
//    blocks an SM;
//  * the epilogue takes the accumulators once, rounded to the output type
//    into a shared tile over the ring, then 8 channels of a row a thread
//    for 16-byte loads of z and stores of y and preact, the BN arithmetic
//    of conv.cu in between.
// The tile's width (64 or 128) moves which block computes an output, not
// the order of its K sum (the taps and channels in order, 16 at a time):
// every width gives the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "sm90.cuh"

// Field order and types mirror conv.cu's ConvParams and the ctypes
// Structure in apex_tpu_torch/ops/conv.py (_ConvParams).
struct ConvParams {
  const void* a;          // x
  const void* b;          // w
  void* out;              // y
  void* aux;              // unused here
  void* preact;           // the pre-epilogue conv result, or null
  const float* mean;      // epilogue, fp32 [O]
  const float* invstd;
  const float* scale;     // null without the affine part
  const float* bias;
  const void* z;          // residual [N, OH, OW, O] in y's type, or null
  int32_t N, H, W, C, O, OH, OW, KH, KW;
  int32_t sh, sw, dh, dw, pt, pl;
  int32_t relu, epilogue, k_per_split;
};

namespace {

using namespace sm90;

constexpr int BM = 128;          // output rows a block (two warpgroups)
constexpr int BKC = 64;          // channels a K step: one 128-byte row
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int kFar = -(1 << 29); // a row past M: every bounds test fails

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// two floats rounded to T (as from_f rounds), the first in the low half
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

template <typename V>
__device__ __forceinline__ void load8(V (&v)[8], const V* src) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(V)) * 8 / 16; ++i) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const char*>(src) + 16 * i);
    memcpy(reinterpret_cast<char*>(v) + 16 * i, &u, 16);
  }
}
template <typename V>
__device__ __forceinline__ void store8(V* dst, const V (&v)[8]) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(V)) * 8 / 16; ++i) {
    uint4 u;
    memcpy(&u, reinterpret_cast<const char*>(v) + 16 * i, 16);
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dst) + 16 * i) = u;
  }
}

// The output of 8 channels of row m: conv.cu's forward epilogue (emit8).
template <typename T>
__device__ __forceinline__ void emit8(const ConvParams& p, int64_t off, int n,
                                      const T* src) {
  T res[8];
  load8(res, src);
  if (p.preact != nullptr) store8(static_cast<T*>(p.preact) + off, res);
  if (p.epilogue) {
    T zv[8], out[8];
    float mu[8], is[8], sc[8], bi[8];    // the channels' fp32 vectors
    load8(mu, p.mean + n);
    load8(is, p.invstd + n);
    if (p.scale != nullptr) {
      load8(sc, p.scale + n);
      load8(bi, p.bias + n);
    }
    if (p.z != nullptr) load8(zv, static_cast<const T*>(p.z) + off);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float of = __fmul_rn(__fsub_rn(to_f(res[j]), mu[j]), is[j]);
      if (p.scale != nullptr) of = __fadd_rn(__fmul_rn(of, sc[j]), bi[j]);
      if (p.z != nullptr) of = __fadd_rn(of, to_f(zv[j]));
      if (p.relu) of = of < 0.f ? 0.f : of;  // a NaN passes, as in torch
      out[j] = from_f<T>(of);
    }
    store8(static_cast<T*>(p.out) + off, out);
    return;
  }
  store8(static_cast<T*>(p.out) + off, res);
}

// Shared memory: the ring (A then B each stage, 1024-byte aligned), the
// epilogue's staging tile over it, the barriers, 1024 bytes to align.
template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BKC * BN * 2;   // BN / 64 panels
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int LDC = BN + 8;             // the staging tile's row
  static constexpr int RING = STAGES * STAGE;
  static constexpr int C_BYTES = BM * LDC * 2;
  static constexpr int OFF_BAR = RING > C_BYTES ? RING : C_BYTES;
  static constexpr int BYTES = OFF_BAR + 8 * STAGES + 1024;
};

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                      const ConvParams p) {
  using L = Tile<BN>;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  const uint32_t full0 = smem_u32(base + L::OFF_BAR);
  const int tid = threadIdx.x;
  const int M = p.N * p.OH * p.OW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = p.KH * p.KW * (p.C / BKC);            // K steps

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init_fence();
    prefetch_map(&wmap);
  }

  // this thread's A chunks: column kc of rows ar + 32 i, decoded once
  const T* x = static_cast<const T*>(p.a);
  const int kc = tid & 7, ar = tid >> 3;
  int rb[4], ry[4], rx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ar + 32 * i;
    rb[i] = 0;
    ry[i] = rx[i] = kFar;
    if (m < M) {
      const int hw = p.OH * p.OW;
      const int bb = m / hw, r = m - bb * hw;
      const int oh = r / p.OW, ow = r - oh * p.OW;
      rb[i] = bb * p.H * p.W * p.C;
      ry[i] = oh * p.sh - p.pt;
      rx[i] = ow * p.sw - p.pl;
    }
  }
  // the next load's tap and channel offset (K steps are issued in order)
  int lkh = 0, lkw = 0, lc0 = 0;
  auto load = [&](int step) {
    const int s = step % STAGES;
    const uint32_t a_s = ring + s * L::STAGE;
    const int dy = lkh * p.dh, dx = lkw * p.dw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yy = ry[i] + dy, xx = rx[i] + dx;
      const bool ok = static_cast<unsigned>(yy) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(xx) < static_cast<unsigned>(p.W);
      const T* src = ok ? x + rb[i] + (yy * p.W + xx) * p.C + lc0 + kc * 8
                        : x;
      cp_async16(a_s + swz(ar + 32 * i, kc), src, ok);
    }
    if (tid == 0) {
      const uint32_t full = full0 + 8 * s;
      mbar_expect_tx(full, L::B_BYTES);
#pragma unroll
      for (int pn = 0; pn < BN / 64; ++pn)
        tma_load_2d(base + s * L::STAGE + L::A_BYTES + pn * 8192, &wmap,
                    full, n0 + 64 * pn, step * BKC);
    }
    lc0 += BKC;
    if (lc0 == p.C) {
      lc0 = 0;
      if (++lkw == p.KW) {
        lkw = 0;
        ++lkh;
      }
    }
  };

  __syncthreads();                     // the barriers are initialised
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES;
    cp_async_wait<STAGES - 2>();       // this thread's A chunks of step j
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);   // B of step j
    fence_proxy_async();
    __syncthreads();   // every chunk of step j; step j - 1's products done
    const uint32_t a_addr = ring + s * L::STAGE + wg * 64 * 128;
    const uint32_t b_addr = ring + s * L::STAGE + L::A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk)
      wgmma_tb<BF16>(acc, gmma_desc(a_addr + kk * 32, 16, 1024),
                     gmma_desc(b_addr + kk * 16 * 128, 8192, 1024));
    wgmma_commit();
    // refill step j - 1's slot while the products run
    if (j + STAGES - 1 < nk) load(j + STAGES - 1);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the epilogue

  // accumulators -> the staging tile, rounded to T: element 4 i + r is
  // row g + 8 (r >> 1) of the warp's 16, column 8 i + 2 t + (r & 1)
  T* cs = reinterpret_cast<T*>(base);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg * 64 + warp * 16 + g + 8 * h;
      *reinterpret_cast<uint32_t*>(cs + row * L::LDC + 8 * i + 2 * t) =
          pack2<T>(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  __syncthreads();
  for (int id = tid; id < BM * (BN / 8); id += THREADS) {
    const int r = id / (BN / 8), c8 = id % (BN / 8) * 8;
    const int m = m0 + r, n = n0 + c8;
    if (m < M && n < p.O)
      emit8<T>(p, static_cast<int64_t>(m) * p.O + n, n, cs + r * L::LDC + c8);
  }
}

template <typename T, int BN>
cudaError_t launch(const ConvParams& p, cudaStream_t st) {
  using L = Tile<BN>;
  CUtensorMap wmap;
  const MapKey wk{p.b,
                  static_cast<uint64_t>(p.KH) * p.KW * p.C,
                  static_cast<uint64_t>(p.O),
                  static_cast<uint64_t>(p.O) * sizeof(T), 64, BKC,
                  std::is_same<T, __nv_bfloat16>::value
                      ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                  CU_TENSOR_MAP_SWIZZLE_128B};
  if (!map_2d(&wmap, wk)) return cudaErrorInvalidValue;
  auto kernel = conv_fwd_wgmma_kernel<T, BN>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (configured != cudaSuccess) return configured;
  const int m = p.N * p.OH * p.OW;
  const dim3 grid((m + BM - 1) / BM, (p.O + BN - 1) / BN);
  kernel<<<grid, THREADS, L::BYTES, st>>>(wmap, p);
  return cudaGetLastError();
}

// bn: the tile's width, 64 or 128, or -1 for the rule (128 where O is at
// least 128, else 64).
template <typename T>
cudaError_t by_tile(const ConvParams& p, int bn, cudaStream_t st) {
  if (bn < 0) bn = p.O >= 128 ? 128 : 64;
  if (bn == 128) return launch<T, 128>(p, st);
  if (bn == 64) return launch<T, 64>(p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype 1 picks bf16, 2 fp16 operands; C must be a multiple of 64, O of 8,
// x, w (and z, y, preact) contiguous and 16-byte aligned.  bn: the tile's
// width (64 or 128), -1 for the rule.  A weight map that
// cuTensorMapEncodeTiled refuses returns cudaErrorInvalidValue, launching
// nothing.
extern "C" int conv_fwd_wgmma(const ConvParams* p, int dtype, int bn,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->C % BKC != 0 || p->O % 8 != 0) return cudaErrorInvalidValue;
  if (dtype == 1) return static_cast<int>(by_tile<__nv_bfloat16>(*p, bn, st));
  if (dtype == 2) return static_cast<int>(by_tile<__half>(*p, bn, st));
  return cudaErrorInvalidValue;
}
