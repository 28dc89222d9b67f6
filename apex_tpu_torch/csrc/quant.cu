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
// nothing contracts into an FMA.  Integer sums are exact in any order, so
// the kernel equals the plain version bit for bit.
//
// What bounds it on the H100: at the serving and training shapes (M 256
// to 8184, K 768 / 3072, N 768 / 3072) the int8 tensor cores' 1979 TOPS
// and the bytes of x, qw and out are within a few microseconds of each
// other; this first kernel is bound by neither but by its own issue rate
// (mma.sync from 32-bit shared-memory fragment loads, register-staged
// global loads, one block's loads and products not overlapping across
// warps beyond the double buffer).  Decode (M = 8) is bound by the
// weight's bytes and launches only N / 64 blocks.  wgmma, TMA, deeper
// pipelining and split-K for small M are later work.
//
// Design:
//  * one block owns one [BM, BN] output tile and loops over K in chunks
//    of 64; BM x BN is 128 x 128 for M > 64 and 32 x 64 for decode rows;
//  * 256 threads, 8 warps as 2 (M) x 4 (N); each warp issues
//    mma.sync.m16n8k32.s32.s8.s8.s32 over its (BM/2) x (BN/4) sub-tile;
//  * each stage loads the x chunk (8 elements a thread-chunk, 16 or 32
//    bytes) and the qw chunk (16 bytes) into registers, quantizes x and
//    stores both as int8 rows of 64 bytes padded to 80, so the 32-bit
//    fragment loads of a warp hit 32 distinct banks; two shared buffers,
//    the next chunk's loads in flight while this one's products run;
//  * ragged M and N rows, and a K tail of 16 or 48 bytes, load as zeros;
//    x's columns from K to Kp read as zero (element loads where K is no
//    multiple of 8 or x is not 16-byte aligned), against qw's zero
//    padding, so the integer sums are those of the unpadded product; the
//    epilogue masks its stores.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;            // K elements (int8 bytes) per stage
constexpr int SROW = BK + 16;     // padded shared row, bytes
constexpr int NTHREADS = 256;

// The bits of a 16-bit float type and their value.
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint32_t bits16(__half x) {
  return __half_as_ushort(x);
}
template <typename T> __device__ __forceinline__ float from_bits16(uint32_t b);
template <> __device__ __forceinline__ float from_bits16<__nv_bfloat16>(
    uint32_t b) {
  return __uint_as_float(b << 16);
}
template <> __device__ __forceinline__ float from_bits16<__half>(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

// 8 consecutive elements of x: one 16-byte load (`load`), or element
// loads of the first n with zeros after them (`load_n`).
template <typename T> struct Chunk8 {   // bf16 and fp16
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void load_n(const T* p, int n) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) w[j / 2] |= bits16(p[j]) << (16 * (j % 2));
    raw = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float get(int i) const {
    const uint32_t w = (&raw.x)[i / 2];
    return from_bits16<T>(i % 2 ? w >> 16 : w & 0xffffu);
  }
};

template <> struct Chunk8<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = *reinterpret_cast<const float4*>(p);
    hi = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void load_n(const float* p, int n) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? p[j] : 0.f;
    lo = make_float4(v[0], v[1], v[2], v[3]);
    hi = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ __forceinline__ void zero() {
    lo = hi = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float get(int i) const {
    return i < 4 ? (&lo.x)[i] : (&hi.x)[i - 4];
  }
};

// quantize(): round half to even, clamp to +-127, as torch.round/clamp do
__device__ __forceinline__ uint32_t q8(float v, float inv) {
  float r = rintf(__fmul_rn(v, inv));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

template <typename T>
__device__ __forceinline__ uint2 quantize8(const Chunk8<T>& c, float inv) {
  uint2 out;
  out.x = q8(c.get(0), inv) | (q8(c.get(1), inv) << 8)
        | (q8(c.get(2), inv) << 16) | (q8(c.get(3), inv) << 24);
  out.y = q8(c.get(4), inv) | (q8(c.get(5), inv) << 8)
        | (q8(c.get(6), inv) << 16) | (q8(c.get(7), inv) << 24);
  return out;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TX, typename TO, int BM, int BN>
__global__ void __launch_bounds__(NTHREADS)
qmm_kernel(const TX* __restrict__ x, const int8_t* __restrict__ qw,
           const float* __restrict__ xs_ptr, const float* __restrict__ ws,
           TO* __restrict__ out, int M, int N, int K, int Kp, int vec) {
  constexpr int WM = BM / 2, WN = BN / 4;      // warp sub-tile
  constexpr int MI = WM / 16, NI = WN / 8;     // mma tiles per warp
  constexpr int A_CHUNKS = BM * (BK / 8) / NTHREADS;
  constexpr int B_CHUNKS = BN * (BK / 16) / NTHREADS;
  static_assert(MI >= 1 && NI >= 1 && A_CHUNKS >= 1 && B_CHUNKS >= 1,
                "tile shape");
  __shared__ __align__(16) int8_t As[2][BM * SROW];
  __shared__ __align__(16) int8_t Bs[2][BN * SROW];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float xs = *xs_ptr;
  const float inv = 1.0f / xs;

  Chunk8<TX> xr[A_CHUNKS];
  uint4 br[B_CHUNKS];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * NTHREADS;
      const int row = c / (BK / 8), kc = c % (BK / 8);
      const int gm = m0 + row, gk = k0 + kc * 8;
      const TX* src = x + static_cast<int64_t>(gm) * K + gk;
      if (gm >= M || gk >= K) xr[i].zero();
      else if (vec) xr[i].load(src);
      else xr[i].load_n(src, K - gk);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * NTHREADS;
      const int row = c / (BK / 16), kc = c % (BK / 16);
      const int gn = n0 + row, gk = k0 + kc * 16;
      br[i] = (gn < N && gk < Kp)
                  ? *reinterpret_cast<const uint4*>(
                        qw + static_cast<int64_t>(gn) * Kp + gk)
                  : make_uint4(0, 0, 0, 0);
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * NTHREADS;
      const int row = c / (BK / 8), kc = c % (BK / 8);
      *reinterpret_cast<uint2*>(&As[buf][row * SROW + kc * 8]) =
          quantize8(xr[i], inv);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * NTHREADS;
      const int row = c / (BK / 16), kc = c % (BK / 16);
      *reinterpret_cast<uint4*>(&Bs[buf][row * SROW + kc * 16]) = br[i];
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int nk = (Kp + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);     // in flight during the mma
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int8_t* p = &As[buf][(wm * WM + mi * 16 + g) * SROW + kk + t * 4];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SROW);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SROW + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int8_t* p = &Bs[buf][(wn * WN + ni * 8 + g) * SROW + kk + t * 4];
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // the dequantize epilogue: acc * (xs * ws[n]), no contraction
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int col = n0 + wn * WN + ni * 8 + t * 2;
    float s[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      s[j] = col + j < N ? __fmul_rn(xs, ws[col + j]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        TO* o = out + static_cast<int64_t>(row) * N;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (col + j < N)
            o[col + j] = from_f<TO>(
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + j]), s[j]));
        }
      }
    }
  }
}

struct Args {
  const void* x;
  const void* qw;
  const float* xs;
  const float* ws;
  void* out;
  int M, N, K, Kp, vec;
};

template <typename TX, typename TO, int BM, int BN>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  qmm_kernel<TX, TO, BM, BN><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const TX*>(a.x), static_cast<const int8_t*>(a.qw), a.xs,
      a.ws, static_cast<TO*>(a.out), a.M, a.N, a.K, a.Kp, a.vec);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t by_rows(const Args& a, cudaStream_t st) {
  if (a.M <= 64) return launch<TX, TO, 32, 64>(a, st);
  return launch<TX, TO, 128, 128>(a, st);
}

template <typename TX>
cudaError_t by_out(const Args& a, int out_dtype, cudaStream_t st) {
  if (out_dtype == 0) return by_rows<TX, float>(a, st);
  if (out_dtype == 1) return by_rows<TX, __nv_bfloat16>(a, st);
  if (out_dtype == 2) return by_rows<TX, __half>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x [M, K] and out [M, N] of dtype codes x_dtype / out_dtype (0 fp32,
// 1 bf16, 2 fp16); qw [N, Kp] int8 with Kp a multiple of 16 and K <= Kp,
// 16-byte aligned (the wrapper checks both); xs one fp32 value and ws [N]
// fp32 in device memory.  vec: K % 8 == 0 and x 16-byte aligned.
extern "C" int quant_matmul(const void* x, const void* qw, const float* xs,
                            const float* ws, void* out, int M, int N, int K,
                            int Kp, int vec, int x_dtype, int out_dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{x, qw, xs, ws, out, M, N, K, Kp, vec};
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == 0) err = by_out<float>(a, out_dtype, st);
  else if (x_dtype == 1) err = by_out<__nv_bfloat16>(a, out_dtype, st);
  else if (x_dtype == 2) err = by_out<__half>(a, out_dtype, st);
  return static_cast<int>(err);
}
