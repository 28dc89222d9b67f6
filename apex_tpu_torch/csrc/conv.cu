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
//            GEMM M = N*OH*OW, N = O, K = KH*KW*C (k = tap*C + c)
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
// The kernels take channel counts C and O that are multiples of 8 and
// 16-byte aligned tensors: the wrapper pads a ragged count (the C = 3 stem)
// with zeros, and zero weights for the pad, before the launch.
//
// What bounds them on the H100: at ResNet-50 shapes these are GEMMs with
// M, N, K in the hundreds to millions, hundreds of operations per byte,
// so they are bound by tensor-core operations, and a kernel's distance
// from that bound is how well it keeps the tensor cores fed.  The first
// version of this file (wmma 16x16x16 from one shared tile, loads staged
// through registers, 128 x 64 tiles, an im2col address decoded by four
// divisions per 8-element chunk every K step, wgrad's A transposed by
// scalar shared stores, the stem's C = 3 gathered element by element and
// a fp32 staging tile for the epilogue) ran the forward at 13-72 TFLOP/s
// and wgrad at 9-41, 4-11x cuDNN.  This design:
//  * tensor cores: bf16 / fp16 `mma.sync.m16n8k16` with fp32 accumulators,
//    fed by `ldmatrix`.  Every operand tile lies in shared memory as it
//    lies in device memory, along its contiguous channel axis: A as [m][k]
//    (forward, dgrad: channels along k) or [k][m] (wgrad: x's channels are
//    m), B as [k][n] (forward's w, wgrad's dy: channels along n) or [n][k]
//    (dgrad's w: o along k).  `ldmatrix` reads [m][k] and [n][k] tiles
//    straight into fragments and `ldmatrix.trans` reads [k][m] and [k][n]
//    ones, so no operand is ever transposed element by element;
//  * tiles: 128 x 128 where N >= 128, 4 warps of 64 x 64 (4 x 8 mma
//    tiles), and 128 x 64 where N = 64 (ResNet-50's many O = 64 sites), 4
//    warps of 64 x 32; K steps of 32.  On the H100, 8 warps of 64 x 32 in
//    the wide tile, K steps of 64 and a ring of 3 stages were each no
//    faster over the 23 ResNet-50 sites;
//  * a ring of 4 stages (3 for fp32) in dynamic shared memory, filled by
//    16-byte `cp.async` copies issued 3 steps ahead of the math, so the
//    loads of later steps are in flight while the tensor cores work.  A
//    tap outside the image, a row past M and a column past N or K are
//    zero-filled by the copy's source size of 0, not by a branch that
//    writes registers.  Rows are padded by 16 bytes, which leaves
//    `ldmatrix` free of bank conflicts;
//  * addresses: a thread's rows of A are fixed for the whole K loop, so
//    each is decoded once, before it, into registers (the forward: the
//    image base, ih0 = oh*sh - pt, iw0 = ow*sw - pl).  K is walked
//    tap-major with one 8-channel chunk a thread a step, so a step costs
//    one tap decode (two divisions by multiply-high, shared by the
//    thread's rows) and a bounds test per row and tap.  wgrad's thread
//    owns a fixed (tap, channel) chunk and decodes the pixel of each of
//    its rows per step, by multiply-high as well;
//  * the C = 3 stem takes the same 16-byte gather: the wrapper pads C to 8
//    (a layout pass over x, not counted as a launch), so a K step covers
//    four taps of 8 channels;
//  * the epilogue reads the accumulator fragments once: rounded to the
//    output type into a shared tile (fp32 for wgrad's split sums), then
//    each thread takes 8 channels of a row for 16-byte loads of z and
//    stores of y and preact, the BN/ReLU arithmetic done in between;
//  * fp32 operands keep a SIMT FMA path in full fp32 (no TF32) on the
//    same tiles and ring: 8 x 8 outputs a thread, strided so that a
//    warp's shared reads are free of bank conflicts;
//  * dgrad gathers the cotangent directly (transposed conv): no dilated
//    tensor is made.  At stride 1 every tap of every pixel is live.  At
//    stride > 1 one GEMM over all pixels would gather mostly zeros (3/4 of
//    them at stride 2, all through the tensor cores); instead the pixels
//    split into sh*sw parity classes, each a dense sub-GEMM over only the
//    taps that reach it, all classes in one launch (blockIdx.z = class).
//    The store's input pixel of each row is decoded once into shared
//    memory.  A class no tap reaches (the odd pixels of a 1x1/2 conv) has
//    K = 0 and its blocks write zeros;
//  * wgrad splits K (the N*OH*OW pixels) over gridDim.z into a fp32
//    workspace [splits, KH*KW*C, O]; a second kernel (conv_common.cuh)
//    sums the splits in a fixed order and casts: deterministic, no atomics
//    (the Pallas kernel carries the sum across its sequential batch axis,
//    which the card does not have).
// conv_sm90.cu runs the three passes on `wgmma` for bf16 and fp16 where the
// gathered channel count is a multiple of 64 (the routes of ops/conv.py);
// this file keeps the stem, ragged channel counts, fp32, and the `mma.sync`
// route that the smoke run times beside `wgmma` on the same inputs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "conv_common.cuh"

namespace {

constexpr int BM = 128;          // output rows per block
constexpr int BK = 32;           // K per stage
constexpr int WN_WIDE = 64;      // a warp's columns in a 128-wide tile

constexpr int MODE_FWD = 0;
constexpr int MODE_DGRAD = 1;
constexpr int MODE_WGRAD = 2;
constexpr int MODE_PARITY = 3;   // dgrad at stride > 1, per parity class

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !ok (source
// size 0: nothing is read)
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one 8-element chunk (16 bytes of bf16 / fp16, 32 of fp32)
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src, bool ok) {
#pragma unroll
  for (int v = 0; v < static_cast<int>(sizeof(T)) * 8 / 16; ++v)
    cp_async16(reinterpret_cast<char*>(dst) + 16 * v,
               reinterpret_cast<const char*>(src) + 16 * v, ok);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// The block shape: BM x BN outputs (BN 64 or 128), rows padded by 16
// bytes, a ring of STAGES K steps.  Tensor cores: warps of 64 x WN (4 x
// WN / 8 mma tiles); fp32: 2 * BN threads of 8 x 8 outputs.
template <int MODE, typename T, int BN_>
struct Cfg {
  static constexpr int BN = BN_;
  static constexpr bool kTC = !std::is_same<T, float>::value;
  static constexpr int WN = BN == 128 ? WN_WIDE : 32;
  static constexpr int NT = kTC ? (BM / 64) * (BN / WN) * 32 : 2 * BN;
  static constexpr int MIN_BLOCKS = BN == 64 ? 3 : 2;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int STAGES = kTC ? 4 : 3;
  // each operand tile as it lies in device memory (see the notes above)
  static constexpr bool A_MK = MODE != MODE_WGRAD;
  static constexpr bool B_KN = MODE == MODE_FWD || MODE == MODE_WGRAD;
  static constexpr int LDA = A_MK ? BK + PAD : BM + PAD;
  static constexpr int LDB = B_KN ? BN + PAD : BK + PAD;
  static constexpr int A_ELEMS = A_MK ? BM * LDA : BK * LDA;
  static constexpr int B_ELEMS = B_KN ? BK * LDB : BN * LDB;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr int A_IT = BM * BK / 8 / NT;   // A chunks a thread
  static constexpr int B_IT = BK * BN / 8 / NT;   // B chunks a thread
  // the epilogue's staging tile: wgrad's fp32 sums, else the output type
  using S = typename std::conditional<MODE == MODE_WGRAD, float, T>::type;
  static constexpr int LDC = BN + 16 / sizeof(S);
  static constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * sizeof(T);
  static constexpr int C_BYTES = BM * LDC * sizeof(S);
  static constexpr int MAIN_BYTES =
      PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
  static constexpr int SMEM =
      MAIN_BYTES + (MODE == MODE_PARITY ? BM * sizeof(int) : 0);
  static_assert(A_IT * NT * 8 == BM * BK && B_IT * NT * 8 == BK * BN,
                "chunks split evenly over the threads");
};

// The operand gather of one thread: which chunks of each stage it copies,
// and the part of their addresses that does not change along K, decoded
// once.  A chunk is 8 channels of one pixel and tap (C and O are
// multiples of 8), so it is one contiguous 16-byte (32-byte fp32) run.
template <int MODE, typename T, int BN>
struct Gather {
  using C = Cfg<MODE, T, BN>;
  const T* a;
  const T* b;
  int M, N, K, k_end, n0;
  // A_MK modes: rows ar0 + i*AR_STEP at column kc; wgrad: k rows
  // ak0 + i*AK_STEP at column mc
  static constexpr int AR_STEP = C::NT / (BK / 8);
  static constexpr int AK_STEP = C::NT / (BM / 8);
  static constexpr int BR_STEP = C::B_KN ? C::NT / (BN / 8) : C::NT / (BK / 8);
  int arow0, acol;             // first row (or k row) and column of A
  int brow0, bcol;             // the same for B
  int rb[C::A_IT];             // A_MK modes: the row's image base offset
  int ry[C::A_IT], rx[C::A_IT];  // its tap-independent coordinates
  // wgrad: the thread's fixed (tap, channel) chunk of A
  int w_c, w_dih, w_diw;
  bool w_ok;
  FastDiv div_k, div_t, div_p, div_w;   // k -> tap, tap -> row, pixel decode
  Parity par;

  __device__ __forceinline__ Gather(const ConvParams& p, const Parity& cls,
                                    int m0, int n0_, int M_, int N_, int K_,
                                    int k_end_)
      : a(static_cast<const T*>(p.a)), b(static_cast<const T*>(p.b)), M(M_),
        N(N_), K(K_), k_end(k_end_), n0(n0_),
        div_k(MODE == MODE_FWD ? p.C : MODE == MODE_WGRAD ? 1 : p.O),
        div_t(MODE == MODE_PARITY ? max(cls.ntw, 1)
                                  : MODE == MODE_WGRAD ? 1 : p.KW),
        div_p(MODE == MODE_WGRAD ? p.OH * p.OW : 1),
        div_w(MODE == MODE_WGRAD ? p.OW : 1), par(cls) {
    const int tid = threadIdx.x;
    if constexpr (C::B_KN) {
      brow0 = tid / (BN / 8);
      bcol = tid % (BN / 8) * 8;
    } else {
      brow0 = tid / (BK / 8);
      bcol = tid % (BK / 8) * 8;
    }
    if constexpr (MODE == MODE_WGRAD) {
      arow0 = tid / (BM / 8);
      acol = tid % (BM / 8) * 8;
      const int m = m0 + acol;
      const FastDiv div_c(p.C);
      const int tap = div_c(m), c = m - tap * p.C;
      const int kh = tap / p.KW, kw = tap - kh * p.KW;
      w_c = c;
      w_dih = kh * p.dh - p.pt;
      w_diw = kw * p.dw - p.pl;
      w_ok = m < M;
    } else {
      arow0 = tid / (BK / 8);
      acol = tid % (BK / 8) * 8;
#pragma unroll
      for (int i = 0; i < C::A_IT; ++i) {
        const int m = m0 + arow0 + i * AR_STEP;
        rb[i] = 0;
        ry[i] = rx[i] = kFar;
        if (m >= M) continue;
        if constexpr (MODE == MODE_FWD) {
          const int hw = p.OH * p.OW;
          const int bb = m / hw, r = m - bb * hw;
          const int oh = r / p.OW, ow = r - oh * p.OW;
          rb[i] = bb * p.H * p.W * p.C;
          ry[i] = oh * p.sh - p.pt;
          rx[i] = ow * p.sw - p.pl;
        } else if constexpr (MODE == MODE_DGRAD) {
          const int hw = p.H * p.W;
          const int bb = m / hw, r = m - bb * hw;
          const int h = r / p.W, w = r - h * p.W;
          rb[i] = bb * p.OH * p.OW * p.O;
          ry[i] = h + p.pt;
          rx[i] = w + p.pl;
        } else {   // parity: class row (bb, i, j)
          const int hw = cls.Hc * cls.Wc;
          const int bb = m / hw, r = m - bb * hw;
          const int ii = r / cls.Wc, jj = r - ii * cls.Wc;
          rb[i] = bb * p.OH * p.OW * p.O;
          ry[i] = ii + cls.oh0;
          rx[i] = jj + cls.ow0;
        }
      }
    }
  }

  // Issue the copies of the K step at k0 into the stage's tiles.
  __device__ __forceinline__ void load(const ConvParams& p, T* As, T* Bs,
                                       int k0) const {
    if constexpr (MODE == MODE_WGRAD) {
#pragma unroll
      for (int i = 0; i < C::A_IT; ++i) {
        const int kr = arow0 + i * AK_STEP;
        const int px = k0 + kr;
        const int bb = div_p(px), r = px - bb * (p.OH * p.OW);
        const int oh = div_w(r), ow = r - oh * p.OW;
        const int ih = oh * p.sh + w_dih, iw = ow * p.sw + w_diw;
        const bool ok = w_ok && px < k_end &&
                        static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                        static_cast<unsigned>(iw) < static_cast<unsigned>(p.W);
        const T* src = ok ? a + ((bb * p.H + ih) * p.W + iw) * p.C + w_c : a;
        copy8(As + kr * C::LDA + acol, src, ok);
      }
#pragma unroll
      for (int i = 0; i < C::B_IT; ++i) {
        const int kr = brow0 + i * BR_STEP;
        const int px = k0 + kr, n = n0 + bcol;
        const bool ok = px < k_end && n < N;
        copy8(Bs + kr * C::LDB + bcol, ok ? b + px * N + n : b, ok);
      }
    } else {
      // one tap decode a step, shared by the thread's rows of A and B
      const int k = k0 + acol;
      const bool kok = k < K;
      const int tap = div_k(k);
      const int ch = k - tap * (MODE == MODE_FWD ? p.C : p.O);
      const int t1 = div_t(tap), t2 = tap - t1 * (MODE == MODE_PARITY
                                                       ? par.ntw : p.KW);
      int dy, dx;      // the tap's offset from the row's coordinates
      if constexpr (MODE == MODE_FWD) { dy = t1 * p.dh; dx = t2 * p.dw; }
      else if constexpr (MODE == MODE_DGRAD) {
        dy = -t1 * p.dh; dx = -t2 * p.dw;
      } else { dy = -t1 * par.doh; dx = -t2 * par.dow; }
      const int YH = MODE == MODE_FWD ? p.H : p.OH;
      const int XW = MODE == MODE_FWD ? p.W : p.OW;
      const int CH = MODE == MODE_FWD ? p.C : p.O;
#pragma unroll
      for (int i = 0; i < C::A_IT; ++i) {
        const int y = ry[i] + dy, x = rx[i] + dx;
        const bool ok = kok &&
                        static_cast<unsigned>(y) < static_cast<unsigned>(YH) &&
                        static_cast<unsigned>(x) < static_cast<unsigned>(XW);
        const T* src = ok ? a + rb[i] + (y * XW + x) * CH + ch : a;
        copy8(As + (arow0 + i * AR_STEP) * C::LDA + acol, src, ok);
      }
      if constexpr (MODE == MODE_FWD) {     // w as [K][O]
#pragma unroll
        for (int i = 0; i < C::B_IT; ++i) {
          const int kr = brow0 + i * BR_STEP;
          const int kk = k0 + kr, n = n0 + bcol;
          const bool ok = kk < K && n < N;
          copy8(Bs + kr * C::LDB + bcol, ok ? b + kk * N + n : b, ok);
        }
      } else {                              // w[tap, n = c, o], k = (tap, o)
        int wtap = tap;
        if constexpr (MODE == MODE_PARITY)
          wtap = (par.kh0 + t1 * par.sth) * p.KW + par.kw0 + t2 * par.stw;
#pragma unroll
        for (int i = 0; i < C::B_IT; ++i) {
          const int nr = brow0 + i * BR_STEP;
          const int n = n0 + nr;
          const bool ok = kok && n < N;
          copy8(Bs + nr * C::LDB + bcol,       // bcol == acol: the same k
                ok ? b + (wtap * p.C + n) * p.O + ch : b, ok);
        }
      }
    }
  }
};

// The output of 8 channels of one row: the forward's epilogue, dgrad's
// cast (at the class's pixel in parity mode), or wgrad's fp32 partial sum
// into the split's slice of the workspace.
template <int MODE, typename T, typename S>
__device__ __forceinline__ void emit8(const ConvParams& p, int M, int N,
                                      int m, int n, int pix, const S* src) {
  if constexpr (MODE == MODE_WGRAD) {
    float v[8];
    load8(v, src);
    store8(static_cast<float*>(p.out) + ((int64_t)blockIdx.z * M + m) * N + n,
           v);
  } else {
    T res[8];
    load8(res, src);
    const int64_t off = MODE == MODE_PARITY ? (int64_t)pix * p.C + n
                                            : (int64_t)m * N + n;
    if constexpr (MODE == MODE_FWD) {
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
          if (p.scale != nullptr)
            of = __fadd_rn(__fmul_rn(of, sc[j]), bi[j]);
          if (p.z != nullptr) of = __fadd_rn(of, to_f(zv[j]));
          if (p.relu) of = of < 0.f ? 0.f : of;  // a NaN passes, as in torch
          out[j] = from_f<T>(of);
        }
        store8(static_cast<T*>(p.out) + off, out);
        return;
      }
    }
    store8(static_cast<T*>(p.out) + off, res);
  }
}

template <int MODE, typename T, int BN>
__global__ void __launch_bounds__(Cfg<MODE, T, BN>::NT,
                                  Cfg<MODE, T, BN>::MIN_BLOCKS)
conv_gemm_kernel(const ConvParams p) {
  using C = Cfg<MODE, T, BN>;
  using S = typename C::S;
  extern __shared__ __align__(16) unsigned char smem[];
  T* pipe = reinterpret_cast<T*>(smem);

  Parity cls{};
  int M, N, K;
  if constexpr (MODE == MODE_FWD) {
    M = p.N * p.OH * p.OW; N = p.O; K = p.KH * p.KW * p.C;
  } else if constexpr (MODE == MODE_DGRAD) {
    M = p.N * p.H * p.W; N = p.C; K = p.KH * p.KW * p.O;
  } else if constexpr (MODE == MODE_PARITY) {
    cls = parity_class(p, blockIdx.z);
    M = p.N * cls.Hc * cls.Wc; N = p.C; K = cls.nth * cls.ntw * p.O;
  } else {
    M = p.KH * p.KW * p.C; N = p.O; K = p.N * p.OH * p.OW;
  }
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (m0 >= M) return;             // parity: a smaller class, no rows here
  int k_begin = 0, k_end = K;
  if constexpr (MODE == MODE_WGRAD) {
    k_begin = blockIdx.z * p.k_per_split;
    k_end = min(K, k_begin + p.k_per_split);
  }
  int* rpix = reinterpret_cast<int*>(smem + C::MAIN_BYTES);
  if constexpr (MODE == MODE_PARITY) {
    // the input pixel each row's output goes to, read by the epilogue
    for (int r = threadIdx.x; r < BM; r += C::NT) {
      const int m = m0 + r;
      if (m >= M) continue;
      const int hw = cls.Hc * cls.Wc;
      const int bb = m / hw, rr = m - bb * hw;
      const int i = rr / cls.Wc, j = rr - i * cls.Wc;
      rpix[r] = (bb * p.H + cls.ph + p.sh * i) * p.W + cls.pw + p.sw * j;
    }
  }

  const Gather<MODE, T, BN> g(p, cls, m0, n0, M, N, K, k_end);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = (k_end - k_begin + BK - 1) / BK;

  // tensor cores: warps (BN / WN of them along n) of 64 x WN, 4 x NI mma
  // tiles; fp32: threads 16 (m) x BN / 8 (n), each rows ty + 16 i and
  // columns tx + BN / 8 j
  constexpr int TXN = BN / 8;
  constexpr int NI = C::kTC ? C::WN / 8 : 8;      // n tiles (or columns)
  constexpr int MI = C::kTC ? 4 : 8;              // m tiles (or rows)
  const int wm = warp / (BN / C::WN), wn = warp % (BN / C::WN);
  const int ty = tid / TXN, tx = tid % TXN;
  float acc[MI][NI][C::kTC ? 4 : 1];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < (C::kTC ? 4 : 1); ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk)
      g.load(p, pipe + s * C::STAGE_ELEMS,
             pipe + s * C::STAGE_ELEMS + C::A_ELEMS, k_begin + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();   // step kt has landed
    __syncthreads();                  // and step kt - 1's slot is free
    const int nx = kt + C::STAGES - 1;
    if (nx < nk) {
      T* st = pipe + (nx % C::STAGES) * C::STAGE_ELEMS;
      g.load(p, st, st + C::A_ELEMS, k_begin + nx * BK);
    }
    cp_async_commit();
    const T* As = pipe + (kt % C::STAGES) * C::STAGE_ELEMS;
    const T* Bs = As + C::A_ELEMS;
    if constexpr (C::kTC) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[4][4], bfr[NI][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int mb = wm * 64 + mi * 16;
          if constexpr (C::A_MK)
            ldsm_x4(af[mi], As + (mb + (lane & 15)) * C::LDA + kk +
                                (lane >> 4) * 8);
          else
            ldsm_x4_t(af[mi], As + (kk + (lane & 7) + ((lane >> 4) << 3)) *
                                       C::LDA + mb + ((lane >> 3) & 1) * 8);
        }
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          const int nb = wn * C::WN + np * 16;
          uint32_t r[4];
          if constexpr (C::B_KN)
            ldsm_x4_t(r, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  C::LDB + nb + (lane >> 4) * 8);
          else
            ldsm_x4(r, Bs + (nb + (lane & 7) + ((lane >> 4) << 3)) * C::LDB +
                           kk + ((lane >> 3) & 1) * 8);
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma16816<T>(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = to_f(C::A_MK ? As[(ty + 16 * i) * C::LDA + kk]
                               : As[kk * C::LDA + ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bv[j] = to_f(C::B_KN ? Bs[kk * C::LDB + tx + TXN * j]
                               : Bs[(tx + TXN * j) * C::LDB + kk]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j][0] = fmaf(av[i], bv[j], acc[i][j][0]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free for the epilogue

  // accumulators -> the staging tile (rounded to the output type, or fp32
  // for wgrad), then 8 channels of a row a thread
  S* Cs = reinterpret_cast<S*>(smem);
  if constexpr (C::kTC) {
    const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = wm * 64 + mi * 16 + gq + 8 * hh;
          const int col = wn * C::WN + ni * 8 + 2 * t4;
          const float lo = acc[mi][ni][2 * hh], hi = acc[mi][ni][2 * hh + 1];
          if constexpr (std::is_same<S, float>::value)
            *reinterpret_cast<float2*>(Cs + row * C::LDC + col) =
                make_float2(lo, hi);
          else
            *reinterpret_cast<uint32_t*>(Cs + row * C::LDC + col) =
                pack2<T>(lo, hi);
        }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Cs[(ty + 16 * i) * C::LDC + tx + TXN * j] = acc[i][j][0];
  }
  __syncthreads();
  for (int id = tid; id < BM * (BN / 8); id += C::NT) {
    const int r = id / (BN / 8), c8 = id % (BN / 8) * 8;
    const int m = m0 + r, n = n0 + c8;
    if (m < M && n < N)
      emit8<MODE, T, S>(p, M, N, m, n,
                        MODE == MODE_PARITY ? rpix[r] : 0,
                        Cs + r * C::LDC + c8);
  }
}

// Grid z: wgrad's K splits, the parity classes (sh*sw; x sized by the
// largest, class (0, 0)), else 1.  The tile is 128 x 128 where the GEMM's
// N is at least 128, else 128 x 64 (the rule), unless the caller names
// its width (`by_tile`).
template <int MODE, typename T, int BN>
cudaError_t launch_tile(const ConvParams& p, int splits, cudaStream_t st) {
  using C = Cfg<MODE, T, BN>;
  auto kernel = conv_gemm_kernel<MODE, T, BN>;
  // opt in to more than 48 KB once per instantiation (not again while a
  // CUDA graph is being captured)
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (configured != cudaSuccess) return configured;
  int m, z = 1;
  if (MODE == MODE_FWD) m = p.N * p.OH * p.OW;
  else if (MODE == MODE_DGRAD) m = p.N * p.H * p.W;
  else if (MODE == MODE_WGRAD) { m = p.KH * p.KW * p.C; z = splits; }
  else {
    m = p.N * ((p.H + p.sh - 1) / p.sh) * ((p.W + p.sw - 1) / p.sw);
    z = p.sh * p.sw;
  }
  const int n = MODE == MODE_FWD || MODE == MODE_WGRAD ? p.O : p.C;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, z);
  kernel<<<grid, C::NT, C::SMEM, st>>>(p);
  return cudaGetLastError();
}

// bn: the tile's width, 64 or 128 (both instantiations exist for every
// mode and type), or -1 for the rule.  The width changes which block
// computes an output, not the order of its K sum: every width gives the
// same bits.
template <int MODE, typename T>
cudaError_t by_tile(const ConvParams& p, int splits, int bn,
                    cudaStream_t st) {
  const int n = MODE == MODE_FWD || MODE == MODE_WGRAD ? p.O : p.C;
  if (bn < 0) bn = n >= 128 ? 128 : 64;
  if (bn == 128) return launch_tile<MODE, T, 128>(p, splits, st);
  if (bn == 64) return launch_tile<MODE, T, 64>(p, splits, st);
  return cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t dispatch(const ConvParams& p, int dtype, int splits, int bn,
                     cudaStream_t st) {
  if (p.C % 8 != 0 || p.O % 8 != 0) return cudaErrorInvalidValue;
  if (dtype == 0) return by_tile<MODE, float>(p, splits, bn, st);
  if (dtype == 1) return by_tile<MODE, __nv_bfloat16>(p, splits, bn, st);
  if (dtype == 2) return by_tile<MODE, __half>(p, splits, bn, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success).  dtype 0 picks fp32, 1 bf16, 2 fp16 operands.  C and O must be
// multiples of 8 and every tensor 16-byte aligned.  bn: the tile's width
// (64 or 128), -1 for the rule.
extern "C" int conv_fwd(const ConvParams* p, int dtype, int bn,
                        void* stream) {
  return static_cast<int>(dispatch<MODE_FWD>(
      *p, dtype, 1, bn, static_cast<cudaStream_t>(stream)));
}

// Stride 1: one GEMM over every pixel; stride > 1: the parity classes.
extern "C" int conv_dgrad(const ConvParams* p, int dtype, int bn,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->sh > 1 || p->sw > 1)
    return static_cast<int>(dispatch<MODE_PARITY>(*p, dtype, 1, bn, st));
  return static_cast<int>(dispatch<MODE_DGRAD>(*p, dtype, 1, bn, st));
}

// The split GEMM into p->out (fp32 [splits, KH*KW*C, O], K split every
// p->k_per_split pixels), then the reduce into p->aux (dw, in the operands'
// type).  The wrapper sizes the splits by the rule's tile whatever bn is,
// so the sum's order, and its bits, do not depend on bn.
extern "C" int conv_wgrad(const ConvParams* p, int dtype, int splits, int bn,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch<MODE_WGRAD>(*p, dtype, splits, bn, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(wgrad_reduce(*p, dtype, splits, st));
}
