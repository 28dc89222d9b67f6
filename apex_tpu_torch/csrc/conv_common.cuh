// What conv.cu (the `mma.sync` and FMA kernels) and conv_sm90.cu (the
// `wgmma` kernels) share: the parameter block, the element conversions and
// 8-element moves, the multiply-high division, dgrad's parity classes and
// wgrad's reduce of its split sums.  Helpers and one small kernel; no entry
// point.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// Field order and types mirror the ctypes Structure in
// apex_tpu_torch/ops/conv.py (_ConvParams).
struct ConvParams {
  const void* a;          // forward, wgrad: x; dgrad: dy
  const void* b;          // forward, dgrad: w; wgrad: dy
  void* out;              // forward: y; dgrad: dx; wgrad: fp32 workspace
  void* aux;              // wgrad: dw (the reduce kernel's output)
  void* preact;           // forward: the pre-epilogue conv result, or null
  const float* mean;      // forward epilogue, fp32 [O]
  const float* invstd;
  const float* scale;     // null without the affine part
  const float* bias;
  const void* z;          // residual [N, OH, OW, O] in y's type, or null
  int32_t N, H, W, C, O, OH, OW, KH, KW;
  int32_t sh, sw, dh, dw, pt, pl;
  int32_t relu, epilogue, k_per_split;
};

namespace {

constexpr int kFar = -(1 << 29); // a row past M: every bounds test fails

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
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

template <typename T>
__device__ __forceinline__ void load8(T (&v)[8], const T* src) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) * 8 / 16; ++i) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const char*>(src) + 16 * i);
    memcpy(reinterpret_cast<char*>(v) + 16 * i, &u, 16);
  }
}
template <typename T>
__device__ __forceinline__ void store8(T* dst, const T (&v)[8]) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)) * 8 / 16; ++i) {
    uint4 u;
    memcpy(&u, reinterpret_cast<const char*>(v) + 16 * i, 16);
    *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dst) + 16 * i) = u;
  }
}

// n / d for 0 <= n < 2**31 by a multiply-high and a shift (the
// round-up method CUTLASS's FastDivmod uses), d >= 1.
struct FastDiv {
  uint32_t d, mul, shr;
  FastDiv() = default;
  __host__ __device__ __forceinline__ explicit FastDiv(int div)
      : d(div), mul(0), shr(0) {
    if (div > 1) {
#ifdef __CUDA_ARCH__
      const uint32_t l = 32 - __clz(div - 1);          // ceil(log2 div)
#else
      const uint32_t l = 32 - __builtin_clz(div - 1);
#endif
      mul = static_cast<uint32_t>(((1ull << (31 + l)) + div - 1) / div);
      shr = l - 1;
    }
  }
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n
                  : static_cast<int>(__umulhi(static_cast<uint32_t>(n), mul) >>
                                     shr);
  }
};

// A dgrad parity class: input pixels (ph + sh*i, pw + sw*j), i < Hc,
// j < Wc, reached by the taps kh = kh0 + jh*sth (jh < nth) and
// kw = kw0 + jw*stw (jw < ntw), which read output row oh = i + oh0 -
// jh*doh and column ow = j + ow0 - jw*dow.  At stride 1 the one class is
// every pixel and every tap in order.
struct Parity {
  int ph, pw, Hc, Wc, kh0, kw0, sth, stw, nth, ntw, oh0, doh, ow0, dow;
};

// The kernel offsets k < K with (phase + pad - k*dil) % s == 0: an
// arithmetic progression k0 + j*step (step = s / gcd(dil, s)), n long.
__host__ __device__ __forceinline__ void parity_taps(int phase, int pad,
                                                     int dil, int s, int K,
                                                     int& k0, int& step,
                                                     int& n) {
  int a = dil, b = s;
  while (b != 0) { const int t = a % b; a = b; b = t; }
  step = s / a;
  k0 = -1;
  for (int k = 0; k < step && k < K; ++k)
    if ((phase + pad - k * dil) % s == 0) { k0 = k; break; }
  n = k0 < 0 ? 0 : (K - k0 + step - 1) / step;
}

// Class z (ph = z / sw, pw = z % sw) of the conv's dgrad.  A few hundred
// instructions of integer division: conv_sm90.cu decodes the classes on
// the host, once a launch.
__host__ __device__ __forceinline__ Parity parity_class(const ConvParams& p,
                                                        int z) {
  Parity c{};
  c.ph = z / p.sw;
  c.pw = z - c.ph * p.sw;
  c.Hc = c.ph < p.H ? (p.H - c.ph + p.sh - 1) / p.sh : 0;
  c.Wc = c.pw < p.W ? (p.W - c.pw + p.sw - 1) / p.sw : 0;
  parity_taps(c.ph, p.pt, p.dh, p.sh, p.KH, c.kh0, c.sth, c.nth);
  parity_taps(c.pw, p.pl, p.dw, p.sw, p.KW, c.kw0, c.stw, c.ntw);
  // exact divisions: the class's taps are those that divide
  c.oh0 = (c.ph + p.pt - c.kh0 * p.dh) / p.sh;
  c.doh = c.sth * p.dh / p.sh;
  c.ow0 = (c.pw + p.pl - c.kw0 * p.dw) / p.sw;
  c.dow = c.stw * p.dw / p.sw;
  return c;
}

// dw = cast(sum over splits of the workspace), splits in order.
template <typename T>
__global__ void wgrad_reduce_kernel(const float* ws, T* dw, int splits,
                                    int64_t mn) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < mn;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    dw[i] = from_f<T>(s);
  }
}

// wgrad's second pass: p.out's fp32 [splits, KH*KW*C, O] sums into p.aux
// (dw, in the operands' type); dtype 0 fp32, 1 bf16, 2 fp16.
inline cudaError_t wgrad_reduce(const ConvParams& p, int dtype, int splits,
                                cudaStream_t st) {
  const int64_t mn = (int64_t)p.KH * p.KW * p.C * p.O;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  const float* ws = static_cast<const float*>(p.out);
  if (dtype == 1)
    wgrad_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        ws, static_cast<__nv_bfloat16*>(p.aux), splits, mn);
  else if (dtype == 2)
    wgrad_reduce_kernel<__half><<<blocks, 256, 0, st>>>(
        ws, static_cast<__half*>(p.aux), splits, mn);
  else
    wgrad_reduce_kernel<float><<<blocks, 256, 0, st>>>(
        ws, static_cast<float*>(p.aux), splits, mn);
  return cudaGetLastError();
}

}  // namespace
