// NHWC implicit-GEMM convolution for Hopper (sm_90a), plain C interface:
// forward (with an optional fused BN/ReLU/residual epilogue), input
// gradient (dgrad) and weight gradient (wgrad).
//
// Replaces the Pallas TPU kernels of apex_tpu/ops/conv.py:
//   conv_fwd   -> `_fwd_kernel` (launched by `_im2col_conv` / `_pallas_fwd`)
//   conv_dgrad -> `_pallas_dgrad` (the forward kernel on the stride-dilated
//                 cotangent with rotated, in/out-transposed weights)
//   conv_wgrad -> `_wgrad_kernel` (launched by `_pallas_wgrad`)
//
// What they compute (x [N,H,W,C], w HWIO [KH,KW,C,O], y [N,OH,OW,O]; all
// contiguous; a tap (kh, kw) reads x at ih = oh*sh - pt + kh*dh, iw = ow*sw
// - pl + kw*dw, and zero outside the image):
//   forward  y[m, o]      = sum_{tap, c} x_tap[m, c] * w[tap, c, o]
//            GEMM M = N*OH*OW, N = O, K = KH*KW*C
//   dgrad    dx[m, c]     = sum_{tap, o} dy[b, (h + pt - kh*dh) / sh,
//                            (w + pl - kw*dw) / sw, o] * w[tap, c, o],
//            taking dy only where both divisions are exact and in range
//            stride 1: GEMM M = N*H*W, N = C, K = KH*KW*O
//            stride > 1: one GEMM per parity class (ph, pw) of the input
//            pixels (h = ph + sh*i, w = pw + sw*j), whose taps are those
//            with (ph + pt - kh*dh) % sh == 0 and likewise in w:
//            M = N*Hc*Wc, N = C, K = |taps_h(ph)|*|taps_w(pw)|*O
//   wgrad    dw[tap, c, o] = sum_pixels x_tap[p, c] * dy[p, o]
//            GEMM M = KH*KW*C, N = O, K = N*OH*OW
// Products accumulate in fp32 and the result is cast to the operands' type,
// as the Pallas kernels do.  The forward epilogue takes the conv result
// rounded to the output type `res` and computes, one rounding at a time
// (__fmul_rn / __fadd_rn: no contracted FMA),
//   out = relu((res - mean) * invstd * scale + bias + z)
// which equals the conv followed by the port's plain `fused_bn_act._fwd_ref`
// bit for bit; the pre-activation `res` is written too when asked for.
//
// What bounds them on the H100: at ResNet-50 shapes these are large GEMMs
// (hundreds of operations per byte), bound by tensor-core operations.  This
// is the simple first kernel: bf16 / fp16 `wmma` (16x16x16, fp32
// accumulators) from shared memory, fed by plain loads staged through
// registers; no `wgmma`, TMA or cp.async pipeline yet, so it runs far below
// the tensor-core peak.  fp32 operands take a SIMT FMA path in full fp32 (no
// TF32).
//
// Design:
//  * one kernel template for the three GEMMs; a block computes a 128 x 64
//    output tile over K steps of 32.  Before the math of one K step, the
//    next step's operands are loaded into registers, so global loads overlap
//    the tensor-core work;
//  * the im2col matrix is never built: each 8-element chunk of an operand
//    tile is gathered from NHWC by its own (pixel, tap, channel) arithmetic.
//    Padding is read as zero by the bounds test, so nothing is padded in
//    device memory, and the asymmetric 'SAME' pads (0, 1) cost nothing;
//  * when every channel count is a multiple of 8 (VEC), a chunk is one
//    16-byte load (8 bf16) that never straddles a tap; otherwise (the C = 3
//    stem, small test widths) each element is gathered on its own.  Ragged
//    M, N and K edges are masked either way;
//  * dgrad gathers the cotangent directly (transposed conv): no dilated
//    tensor is made.  At stride 1 every tap of every pixel is live.  At
//    stride > 1 one GEMM over all pixels would gather mostly zeros (3/4 of
//    them at stride 2, all through the tensor cores); instead the pixels
//    split into sh*sw parity classes, each a dense sub-GEMM over only the
//    taps that reach it, all classes in one launch (blockIdx.z = class).
//    Each block decodes its 128 rows once into shared memory (the gather's
//    output row base and the store's input pixel), so neither the K loop
//    nor the epilogue divides by the image shape.  A class no tap reaches
//    (the odd pixels of a 1x1/2 conv) has K = 0 and its blocks only write
//    zeros;
//  * wgrad splits K (the N*OH*OW pixels) over gridDim.z into a fp32
//    workspace [splits, KH*KW*C, O]; a second kernel of this file sums the
//    splits in a fixed order and casts: deterministic, no atomics (the
//    Pallas kernel carries the sum across its sequential batch axis, which
//    the card does not have).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

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

using namespace nvcuda;

constexpr int BM = 128;          // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int BK = 32;           // K per step
constexpr int NTHREADS = 128;
constexpr int LDC = BN + 4;      // fp32 staging of the output tile
static_assert(BM == NTHREADS, "parity mode decodes one row a thread");

constexpr int MODE_FWD = 0;
constexpr int MODE_DGRAD = 1;
constexpr int MODE_WGRAD = 2;
constexpr int MODE_PARITY = 3;   // dgrad at stride > 1, per parity class

// Shared-memory row strides: 16-bit rows are padded to keep the wmma tiles
// 32-byte aligned; fp32 rows by one or four floats against bank conflicts.
template <typename T> struct Tile {
  static constexpr int LDA = BK + 8, LDB = BN + 8;
};
template <> struct Tile<float> {
  static constexpr int LDA = BK + 1, LDB = BN + 4;
};

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

struct Dims {
  int M, N, K;
};

// A dgrad parity class: input pixels (ph + sh*i, pw + sw*j), i < Hc,
// j < Wc, reached by the taps kh = kh0 + jh*sth (jh < nth) and
// kw = kw0 + jw*stw (jw < ntw), which read output row oh = i + oh0 -
// jh*doh and column ow = j + ow0 - jw*dow.  The block's rows are decoded
// once into shared memory: `rbase` (b*OH*OW, or -1 past M), `rij` (i | j
// << 16) and `rpix` (the input pixel the row writes).  Unused outside
// MODE_PARITY.
struct Parity {
  int ph, pw, Hc, Wc, kh0, kw0, sth, stw, nth, ntw, oh0, doh, ow0, dow;
  int m0;
  const int* rbase;
  const int* rij;
  const int* rpix;
};
struct NoParity {};
// What a block of mode MODE carries beside the parameters.
template <int MODE>
using Ctx = typename std::conditional<MODE == MODE_PARITY, Parity,
                                      NoParity>::type;

// The kernel offsets k < K with (phase + pad - k*dil) % s == 0: an
// arithmetic progression k0 + j*step (step = s / gcd(dil, s)), n long.
__device__ __forceinline__ void parity_taps(int phase, int pad, int dil,
                                            int s, int K, int& k0, int& step,
                                            int& n) {
  int a = dil, b = s;
  while (b != 0) { const int t = a % b; a = b; b = t; }
  step = s / a;
  k0 = -1;
  for (int k = 0; k < step && k < K; ++k)
    if ((phase + pad - k * dil) % s == 0) { k0 = k; break; }
  n = k0 < 0 ? 0 : (K - k0 + step - 1) / step;
}

__device__ __forceinline__ Parity parity_class(const ConvParams& p, int z) {
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

template <int MODE>
__host__ __device__ __forceinline__ Dims gemm_dims(const ConvParams& p,
                                                   const Ctx<MODE>& c) {
  if constexpr (MODE == MODE_FWD)
    return {p.N * p.OH * p.OW, p.O, p.KH * p.KW * p.C};
  else if constexpr (MODE == MODE_DGRAD)
    return {p.N * p.H * p.W, p.C, p.KH * p.KW * p.O};
  else if constexpr (MODE == MODE_PARITY)
    return {p.N * c.Hc * c.Wc, p.C, c.nth * c.ntw * p.O};
  else
    return {p.KH * p.KW * p.C, p.O, p.N * p.OH * p.OW};
}

// Offset of A[m, k] in its tensor, or -1 where the gather reads zero
// (padding, or a dgrad tap that falls between strided outputs).
template <int MODE>
__device__ __forceinline__ int64_t a_offset(const ConvParams& p,
                                            const Ctx<MODE>& c, int m,
                                            int k) {
  if constexpr (MODE == MODE_FWD) {
    const int hw = p.OH * p.OW;
    const int b = m / hw, r = m - b * hw;
    const int oh = r / p.OW, ow = r - oh * p.OW;
    const int tap = k / p.C, c = k - tap * p.C;
    const int kh = tap / p.KW, kw = tap - kh * p.KW;
    const int ih = oh * p.sh - p.pt + kh * p.dh;
    const int iw = ow * p.sw - p.pl + kw * p.dw;
    if (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W) return -1;
    return ((int64_t)(b * p.H + ih) * p.W + iw) * p.C + c;
  } else if constexpr (MODE == MODE_DGRAD) {
    const int hw = p.H * p.W;
    const int b = m / hw, r = m - b * hw;
    const int h = r / p.W, w = r - h * p.W;
    const int tap = k / p.O, o = k - tap * p.O;
    const int kh = tap / p.KW, kw = tap - kh * p.KW;
    const int th = h + p.pt - kh * p.dh, tw = w + p.pl - kw * p.dw;
    if (th < 0 || tw < 0) return -1;
    const int oh = th / p.sh, ow = tw / p.sw;
    if (oh * p.sh != th || ow * p.sw != tw || oh >= p.OH || ow >= p.OW)
      return -1;
    return ((int64_t)(b * p.OH + oh) * p.OW + ow) * p.O + o;
  } else if constexpr (MODE == MODE_PARITY) {
    const int r = m - c.m0;            // the block's row, decoded once
    const int ij = c.rij[r];
    const int tap = k / p.O, o = k - tap * p.O;
    const int jh = tap / c.ntw, jw = tap - jh * c.ntw;
    const int oh = (ij & 0xffff) + c.oh0 - jh * c.doh;
    const int ow = (ij >> 16) + c.ow0 - jw * c.dow;
    if (oh < 0 || oh >= p.OH || ow < 0 || ow >= p.OW) return -1;
    return ((int64_t)c.rbase[r] + oh * p.OW + ow) * p.O + o;
  } else {  // wgrad: m = (tap, c), k = output pixel
    const int tap = m / p.C, c = m - tap * p.C;
    const int kh = tap / p.KW, kw = tap - kh * p.KW;
    const int hw = p.OH * p.OW;
    const int b = k / hw, r = k - b * hw;
    const int oh = r / p.OW, ow = r - oh * p.OW;
    const int ih = oh * p.sh - p.pt + kh * p.dh;
    const int iw = ow * p.sw - p.pl + kw * p.dw;
    if (ih < 0 || ih >= p.H || iw < 0 || iw >= p.W) return -1;
    return ((int64_t)(b * p.H + ih) * p.W + iw) * p.C + c;
  }
}

// Offset of B[k, n]: forward w as [K, O]; dgrad w[tap, n = c, o] for
// k = (tap, o); wgrad dy as [pixels, O].
template <int MODE>
__device__ __forceinline__ int64_t b_offset(const ConvParams& p,
                                            const Ctx<MODE>& c, int k,
                                            int n) {
  if constexpr (MODE == MODE_DGRAD) {
    const int tap = k / p.O, o = k - tap * p.O;
    return ((int64_t)tap * p.C + n) * p.O + o;
  } else if constexpr (MODE == MODE_PARITY) {
    const int tap = k / p.O, o = k - tap * p.O;
    const int jh = tap / c.ntw, jw = tap - jh * c.ntw;
    const int kh = c.kh0 + jh * c.sth, kw = c.kw0 + jw * c.stw;
    return ((int64_t)(kh * p.KW + kw) * p.C + n) * p.O + o;
  } else {
    return (int64_t)k * p.O + n;
  }
}

// Which way an operand's 8-element chunks run: the tensor's contiguous
// (channel) dimension.
template <int MODE> struct Chunks {
  static constexpr bool A_ALONG_K = MODE != MODE_WGRAD;
  static constexpr bool B_ALONG_N = MODE != MODE_DGRAD && MODE != MODE_PARITY;
};

template <typename T>
__device__ __forceinline__ void load_vec8(T (&dst)[8], const T* src) {
  constexpr int kVecs = sizeof(T) * 8 / 16;     // 1 for bf16, 2 for fp32
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + v);
    memcpy(&dst[v * (16 / sizeof(T))], &u, 16);
  }
}

template <typename T>
__device__ __forceinline__ void zero8(T (&dst)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j] = from_f<T>(0.f);
}

// The A chunk whose first element is (m, k): 8 elements along k (forward,
// dgrad) or along m (wgrad).  M and K bound the live region.
template <int MODE, typename T, bool VEC>
__device__ __forceinline__ void load_a(const ConvParams& p,
                                       const Ctx<MODE>& c,
                                       const T* a, int M, int K, int m, int k,
                                       T (&dst)[8]) {
  if constexpr (VEC) {
    const int64_t off = (m < M && k < K) ? a_offset<MODE>(p, c, m, k) : -1;
    if (off >= 0) load_vec8(dst, a + off); else zero8(dst);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int mm = Chunks<MODE>::A_ALONG_K ? m : m + j;
      const int kk = Chunks<MODE>::A_ALONG_K ? k + j : k;
      const int64_t off =
          (mm < M && kk < K) ? a_offset<MODE>(p, c, mm, kk) : -1;
      dst[j] = off >= 0 ? a[off] : from_f<T>(0.f);
    }
  }
}

// The B chunk whose first element is (k, n): along n (forward, wgrad) or
// along k (dgrad).
template <int MODE, typename T, bool VEC>
__device__ __forceinline__ void load_b(const ConvParams& p,
                                       const Ctx<MODE>& c,
                                       const T* b, int K, int N, int k, int n,
                                       T (&dst)[8]) {
  if constexpr (VEC) {
    if (k < K && n < N) load_vec8(dst, b + b_offset<MODE>(p, c, k, n));
    else zero8(dst);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = Chunks<MODE>::B_ALONG_N ? k : k + j;
      const int nn = Chunks<MODE>::B_ALONG_N ? n + j : n;
      dst[j] = (kk < K && nn < N) ? b[b_offset<MODE>(p, c, kk, nn)]
                                  : from_f<T>(0.f);
    }
  }
}

constexpr int A_CHUNKS = BM * BK / 8 / NTHREADS;   // 4 a thread
constexpr int B_CHUNKS = BK * BN / 8 / NTHREADS;   // 2 a thread

// Tile coordinates of a thread's i-th chunk.
template <int MODE>
__device__ __forceinline__ void a_chunk(int id, int& m, int& k) {
  if (Chunks<MODE>::A_ALONG_K) { m = id / (BK / 8); k = id % (BK / 8) * 8; }
  else { k = id / (BM / 8); m = id % (BM / 8) * 8; }
}
template <int MODE>
__device__ __forceinline__ void b_chunk(int id, int& k, int& n) {
  if (Chunks<MODE>::B_ALONG_N) { k = id / (BN / 8); n = id % (BN / 8) * 8; }
  else { n = id / (BK / 8); k = id % (BK / 8) * 8; }
}

template <int MODE, typename T, bool VEC>
__device__ __forceinline__ void fetch(const ConvParams& p,
                                      const Ctx<MODE>& c,
                                      const T* a, const T* b, const Dims& g,
                                      int m0,
                                      int n0, int k0, int k_end,
                                      T (&ra)[A_CHUNKS][8],
                                      T (&rb)[B_CHUNKS][8]) {
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    int m, k;
    a_chunk<MODE>(threadIdx.x + i * NTHREADS, m, k);
    load_a<MODE, T, VEC>(p, c, a, g.M, k_end, m0 + m, k0 + k, ra[i]);
  }
#pragma unroll
  for (int i = 0; i < B_CHUNKS; ++i) {
    int k, n;
    b_chunk<MODE>(threadIdx.x + i * NTHREADS, k, n);
    load_b<MODE, T, VEC>(p, c, b, k_end, g.N, k0 + k, n0 + n, rb[i]);
  }
}

// Registers to the shared tiles As[m][k] and Bs[k][n] (row-major).
template <int MODE, typename T>
__device__ __forceinline__ void stash(T* As, T* Bs, const T (&ra)[A_CHUNKS][8],
                                      const T (&rb)[B_CHUNKS][8]) {
  constexpr int LDA = Tile<T>::LDA, LDB = Tile<T>::LDB;
  constexpr bool kTC = !std::is_same<T, float>::value;
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    int m, k;
    a_chunk<MODE>(threadIdx.x + i * NTHREADS, m, k);
    if constexpr (Chunks<MODE>::A_ALONG_K && kTC) {
      uint4 u;
      memcpy(&u, ra[i], 16);
      *reinterpret_cast<uint4*>(As + m * LDA + k) = u;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (Chunks<MODE>::A_ALONG_K) As[m * LDA + k + j] = ra[i][j];
        else As[(m + j) * LDA + k] = ra[i][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < B_CHUNKS; ++i) {
    int k, n;
    b_chunk<MODE>(threadIdx.x + i * NTHREADS, k, n);
    if constexpr (Chunks<MODE>::B_ALONG_N && kTC) {
      uint4 u;
      memcpy(&u, rb[i], 16);
      *reinterpret_cast<uint4*>(Bs + k * LDB + n) = u;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (Chunks<MODE>::B_ALONG_N) Bs[k * LDB + n + j] = rb[i][j];
        else Bs[(k + j) * LDB + n] = rb[i][j];
      }
    }
  }
}

// One output element: the forward's cast and epilogue, dgrad's cast (at
// the class's pixel in parity mode), or wgrad's fp32 partial sum into the
// split's slice of the workspace.
template <int MODE, typename T>
__device__ __forceinline__ void emit(const ConvParams& p, const Ctx<MODE>& c,
                                     const Dims& g, int m, int n, float v) {
  const int64_t off = (int64_t)m * g.N + n;
  if constexpr (MODE == MODE_WGRAD) {
    static_cast<float*>(p.out)[(int64_t)blockIdx.z * g.M * g.N + off] = v;
  } else if constexpr (MODE == MODE_DGRAD) {
    static_cast<T*>(p.out)[off] = from_f<T>(v);
  } else if constexpr (MODE == MODE_PARITY) {
    static_cast<T*>(p.out)[(int64_t)c.rpix[m - c.m0] * p.C + n] =
        from_f<T>(v);
  } else {
    const T res = from_f<T>(v);
    if (p.preact != nullptr) static_cast<T*>(p.preact)[off] = res;
    if (p.epilogue) {
      float of = __fmul_rn(__fsub_rn(to_f(res), p.mean[n]), p.invstd[n]);
      if (p.scale != nullptr)
        of = __fadd_rn(__fmul_rn(of, p.scale[n]), p.bias[n]);
      if (p.z != nullptr)
        of = __fadd_rn(of, to_f(static_cast<const T*>(p.z)[off]));
      if (p.relu) of = of < 0.f ? 0.f : of;    // a NaN passes, as in torch
      static_cast<T*>(p.out)[off] = from_f<T>(of);
    } else {
      static_cast<T*>(p.out)[off] = res;
    }
  }
}

template <int MODE, typename T, bool VEC>
__global__ void __launch_bounds__(NTHREADS) conv_gemm_kernel(
    const ConvParams p) {
  constexpr bool kTC = !std::is_same<T, float>::value;   // tensor cores
  constexpr int LDA = Tile<T>::LDA, LDB = Tile<T>::LDB;
  constexpr int A_BYTES = BM * LDA * sizeof(T);
  constexpr int B_BYTES = BK * LDB * sizeof(T);
  constexpr int C_BYTES = kTC ? BM * LDC * 4 : 0;
  constexpr int SMEM = A_BYTES + B_BYTES > C_BYTES ? A_BYTES + B_BYTES
                                                   : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + A_BYTES);

  Ctx<MODE> c{};
  if constexpr (MODE == MODE_PARITY) c = parity_class(p, blockIdx.z);
  const Dims g = gemm_dims<MODE>(p, c);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  int k_begin = blockIdx.z * p.k_per_split;
  int k_end = min(g.K, k_begin + p.k_per_split);
  if constexpr (MODE == MODE_PARITY) {
    if (m0 >= g.M) return;         // a smaller class: no rows here
    k_begin = 0;                   // blockIdx.z is the class
    k_end = g.K;
    // decode the block's rows once (BM == NTHREADS: one row a thread)
    __shared__ int rbase[BM], rij[BM], rpix[BM];
    const int m = m0 + threadIdx.x;
    if (m < g.M) {
      const int hw = c.Hc * c.Wc;
      const int bb = m / hw, r = m - bb * hw;
      const int i = r / c.Wc, j = r - i * c.Wc;
      rbase[threadIdx.x] = bb * p.OH * p.OW;
      rij[threadIdx.x] = i | (j << 16);
      rpix[threadIdx.x] = (bb * p.H + c.ph + p.sh * i) * p.W + c.pw + p.sw * j;
    }
    c.m0 = m0;
    c.rbase = rbase;
    c.rij = rij;
    c.rpix = rpix;
    __syncthreads();
    if (g.K == 0) {                // no tap reaches the class: zeros
      for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
        const int m = m0 + idx / BN, n = n0 + idx % BN;
        if (m < g.M && n < g.N) emit<MODE, T>(p, c, g, m, n, 0.f);
      }
      return;
    }
  }
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  const int tid = threadIdx.x;

  T ra[A_CHUNKS][8], rb[B_CHUNKS][8];

  // bf16/fp16: warps 2 x 2, each a 64 x 32 sub-tile of 4 x 2 wmma tiles.
  // fp32: threads 16 x 8, each an 8 x 8 sub-tile.
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  const int tx = tid % 8, ty = tid / 8;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
  float sacc[kTC ? 1 : 8][kTC ? 1 : 8];
  if constexpr (kTC) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
  }

  fetch<MODE, T, VEC>(p, c, a, b, g, m0, n0, k_begin, k_end, ra, rb);
  stash<MODE, T>(As, Bs, ra, rb);
  __syncthreads();
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const bool more = k0 + BK < k_end;
    if (more)
      fetch<MODE, T, VEC>(p, c, a, b, g, m0, n0, k0 + BK, k_end, ra, rb);
    if constexpr (kTC) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>
            fa[4];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 64 + i * 16) * LDA + kk,
                                 LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16,
                                 LDB);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_f(As[(ty * 8 + i) * LDA + kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = to_f(Bs[kk * LDB + tx * 8 + j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sacc[i][j] = fmaf(av[i], bv[j], sacc[i][j]);
      }
    }
    __syncthreads();
    if (more) {
      stash<MODE, T>(As, Bs, ra, rb);
      __syncthreads();
    }
  }

  if constexpr (kTC) {
    float* Cs = reinterpret_cast<float*>(smem);   // the tiles are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * LDC + wn * 32 +
                                    j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < BM * BN; idx += NTHREADS) {
      const int r = idx / BN, cc = idx % BN;
      const int m = m0 + r, n = n0 + cc;
      if (m < g.M && n < g.N) emit<MODE, T>(p, c, g, m, n, Cs[r * LDC + cc]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = m0 + ty * 8 + i, n = n0 + tx * 8 + j;
        if (m < g.M && n < g.N) emit<MODE, T>(p, c, g, m, n, sacc[i][j]);
      }
  }
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

// Grid z: wgrad's K splits, the parity classes (sh*sw; x sized by the
// largest, class (0, 0)), else 1.
template <int MODE, typename T, bool VEC>
cudaError_t launch_gemm(const ConvParams& p, int splits, cudaStream_t st) {
  int m = p.N * p.H * p.W, z = splits;
  if (MODE == MODE_PARITY) {
    m = p.N * ((p.H + p.sh - 1) / p.sh) * ((p.W + p.sw - 1) / p.sw);
    z = p.sh * p.sw;
  } else {
    m = gemm_dims<MODE>(p, Ctx<MODE>{}).M;
  }
  const int n = MODE == MODE_FWD || MODE == MODE_WGRAD ? p.O : p.C;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, z);
  conv_gemm_kernel<MODE, T, VEC><<<grid, NTHREADS, 0, st>>>(p);
  return cudaGetLastError();
}

template <int MODE, typename T>
cudaError_t by_vec(const ConvParams& p, int vec, int splits,
                   cudaStream_t st) {
  return vec ? launch_gemm<MODE, T, true>(p, splits, st)
             : launch_gemm<MODE, T, false>(p, splits, st);
}

template <int MODE>
cudaError_t dispatch(const ConvParams& p, int dtype, int vec, int splits,
                     cudaStream_t st) {
  if (dtype == 0) return by_vec<MODE, float>(p, vec, splits, st);
  if (dtype == 1) return by_vec<MODE, __nv_bfloat16>(p, vec, splits, st);
  if (dtype == 2) return by_vec<MODE, __half>(p, vec, splits, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success).  dtype 0 picks fp32, 1 bf16, 2 fp16 operands; vec the 16-byte
// gather, which needs C and O multiples of 8 and 16-byte aligned tensors.
extern "C" int conv_fwd(const ConvParams* p, int dtype, int vec,
                        void* stream) {
  return static_cast<int>(dispatch<MODE_FWD>(
      *p, dtype, vec, 1, static_cast<cudaStream_t>(stream)));
}

// Stride 1: one GEMM over every pixel; stride > 1: the parity classes.
extern "C" int conv_dgrad(const ConvParams* p, int dtype, int vec,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->sh > 1 || p->sw > 1)
    return static_cast<int>(dispatch<MODE_PARITY>(*p, dtype, vec, 1, st));
  return static_cast<int>(dispatch<MODE_DGRAD>(*p, dtype, vec, 1, st));
}

// The split GEMM into p->out (fp32 [splits, KH*KW*C, O], K split every
// p->k_per_split pixels), then the reduce into p->aux (dw, in the operands'
// type).
extern "C" int conv_wgrad(const ConvParams* p, int dtype, int vec,
                          int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch<MODE_WGRAD>(*p, dtype, vec, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t mn = (int64_t)p->KH * p->KW * p->C * p->O;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  const float* ws = static_cast<const float*>(p->out);
  if (dtype == 1)
    wgrad_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        ws, static_cast<__nv_bfloat16*>(p->aux), splits, mn);
  else if (dtype == 2)
    wgrad_reduce_kernel<__half><<<blocks, 256, 0, st>>>(
        ws, static_cast<__half*>(p->aux), splits, mn);
  else
    wgrad_reduce_kernel<float><<<blocks, 256, 0, st>>>(
        ws, static_cast<float*>(p->aux), splits, mn);
  return static_cast<int>(cudaGetLastError());
}
