// NHWC implicit-GEMM convolution for Hopper (sm_90a) on `wgmma`: forward,
// input gradient (dgrad) and weight gradient (wgrad), plain C interface.
//
// Replaces, for bf16 and fp16 operands whose gathered channel count is a
// multiple of 64 (every ResNet-50 conv but the C = 3 stem), the Pallas TPU
// kernels of apex_tpu/ops/conv.py:
//   conv_fwd_wgmma   -> `_fwd_kernel` (launched by `_im2col_conv` for
//                       `_pallas_fwd`); C a multiple of 64
//   conv_dgrad_wgmma -> `_pallas_dgrad` (the forward's kernel on the
//                       stride-dilated cotangent with rotated, transposed
//                       weights); O a multiple of 64
//   conv_wgrad_wgmma -> `_wgrad_kernel` (launched by `_pallas_wgrad`); C a
//                       multiple of 64
// They compute conv.cu's GEMMs unchanged (x [N,H,W,C], w HWIO [KH,KW,C,O],
// y [N,OH,OW,O], all contiguous; conv.cu's header gives the three GEMMs and
// dgrad's parity classes) with fp32 accumulators, each result rounded once to
// the operands' type; the forward's optional epilogue
//   out = relu((res - mean) * invstd * scale + bias + z)
// is conv.cu's, one rounding at a time, and equals the conv followed by the
// port's plain `fused_bn_act._fwd_ref` bit for bit.  O (C for dgrad) must be
// a multiple of 8 and every tensor 16-byte aligned; the wrapper's routes
// (`_fwd_route`, `_dgrad_route`, `_wgrad_route`) send every other call to
// conv.cu.
//
// What bounds them on the H100: at ResNet-50's shapes GEMMs of hundreds of
// operations a byte, so the bf16 tensor cores (989 TFLOP/s), which only
// `wgmma` reaches; conv.cu's `mma.sync` ring ran the forward at 1.6-1.8x,
// dgrad at up to 1.5x and wgrad at up to 1.7x cuDNN.  The design:
//  * the forward and dgrad: a K step is 64 channels of one tap (C, for
//    dgrad O, a multiple of 64), so the A tile is one 128-byte row an
//    output pixel: every thread gathers 16-byte chunks of its fixed rows
//    with `cp.async` straight into `wgmma`'s K-major 128-byte-swizzled
//    layout (chunk c of row r at c ^ (r & 7)); a tap outside the image and
//    a row past M are zero-filled by the copy's source size of 0.  A row's
//    image base and coordinates are decoded once, before the K loop, by
//    multiply-high divisors made on the host (as are dgrad's parity
//    classes: decoded in every block, their integer divisions cost 0.3 of
//    dgrad's time at 3x3/1), and the tap advances by counters, so a step
//    costs a bounds test a row.
//    dgrad gathers dy as a transposed conv (no dilated tensor), its rows
//    the input pixels of one parity class (at stride 1 the one class is
//    every pixel), the classes in one launch (blockIdx.z), a class no tap
//    reaches writing zeros;
//  * the weight by TMA (one thread, an `mbarrier` a stage) from its
//    [KH*KW*C, O] view with the 128-byte swizzle: the forward's B is
//    BN / 64 panels of [64 k][64 o], MN-major, read through the
//    instruction's transpose bit (SBO 1024, LBO one panel); dgrad's B is
//    the box of BN rows c at row tap*C + c0 by 64 columns o, which is
//    K-major as it lies (no transpose; rows past the tap's C only feed
//    output columns that are cut);
//  * two consumer warpgroups of 64 rows each issue `wgmma.mma_async
//    m64nBNk16` (BN 128, or 64 where the GEMM's N is 64) with both operands
//    in shared memory, four a K step; a ring of 3 stages, refilled while
//    the products run, and two blocks an SM, so one block's loads and
//    epilogue overlap the other's products.  Every thread both loads and
//    multiplies: a warp specialised to gather would hold as many registers
//    as a consumer (ptxas allocates the launch's count whatever
//    `setmaxnreg` asks, flash_attention_sm90.cu's finding) and leave fewer
//    blocks an SM;
//  * their epilogue takes the accumulators once, rounded to the output type
//    into a shared tile over the ring, then 8 channels of a row a thread
//    for 16-byte stores (the forward: loads of z and the BN arithmetic in
//    between; dgrad: at the class's input pixel, decoded once);
//  * wgrad: M = (tap, c), N = o, K = the N*OH*OW pixels, split over
//    gridDim.z into a fp32 workspace that conv_common.cuh's reduce sums in
//    split order (deterministic, no atomics).  A K step is 32 pixels.  A
//    is x at a tap, [pixels][64 c] a 64-row sub-tile (one tap's 64
//    channels), gathered by `cp.async` as 128-byte rows into the MN-major
//    swizzled layout (a row's pixel decoded once a step, each sub-tile's
//    offset from it fixed); B is dy [N*OH*OW, O], whose rows are
//    contiguous, loaded by TMA as [32 px][64 o] panels, MN-major too: both
//    through the transpose bits.  conv.cu's block covers 128 rows of M,
//    so every block read dy again for its own M tile (at [128,56,56,64]
//    3x3: 5 M tiles, dy through L2 5 times).  Here a block's two
//    warpgroups take two 64-row sub-tiles each beside one dy tile of 64
//    columns (256 x 64, where O is 64) or one each beside 128 columns
//    (128 x 128): the dy tile a step feeds every product of the block, dy
//    goes through L2 once for every 256 rows of M (3 times at that site),
//    and either way a thread keeps 64 fp32 accumulators.  x still comes
//    through L2 once a tap.  Its ring holds 5 stages of 20 KB (256 x 64)
//    or 16 KB (128 x 128), two blocks an SM, loaded 3 steps ahead, and a
//    warpgroup keeps one step's products in flight across the next
//    step's barrier; a warpgroup whose sub-tiles lie past M issues no
//    products.  The split plan (ops/conv.py `_wgrad_wgmma_splits`) sizes
//    the splits so that the blocks fill whole waves of two an SM: a
//    fixed step cost dominates (probes with the loads or the products cut
//    out each took two thirds of the full kernel's time), so a partial
//    last wave cost nearly a whole one.  The partial sums go from the
//    accumulators to the workspace as 8-byte stores.
// Measured by chip_smoke.py (phases 15 and 15b, bf16, B 128, H100 80GB
// HBM3 at 700 W; cuDNN timed as one eager aten.convolution_backward): at
// [128,56,56,64] 3x3/1 dgrad 0.094 ms against conv.cu's mma.sync 0.19
// and cuDNN 0.10-0.17, wgrad 0.148-0.154 against 0.21 and 0.10-0.13; over
// the 52 dgrads and 52 wgrads of a ResNet-50 step 3.49 and 4.91 ms
// against mma.sync's 5.74 and 6.19.  dgrad is faster than both at every
// ResNet-50 site; wgrad trails cuDNN (up to 1.5x at 3x3/1), held by a
// fixed cost a K step at 0.2-0.3 of its bound.
// Sum order: the forward and dgrad sum K in conv.cu's order (the taps in
// order, 16 channels at a time) and `wgmma`'s k16 step adds as
// `mma.sync.m16n8k16` does, so they give conv.cu's bits; wgrad sums each
// split's pixels in order, 16 at a time, then the splits in order, but
// its splits are its own, not conv.cu's.  The tile's width moves which
// block computes an output, not the order of its sum (wgrad's splits are
// sized by the rule's tile whatever runs): every width gives the same
// bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "conv_common.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;          // forward, dgrad: output rows a block
constexpr int BKC = 64;          // forward, dgrad: channels a K step
constexpr int STAGES = 3;
constexpr int THREADS = 256;     // two warpgroups
constexpr int BKP = 32;          // wgrad: pixels a K step (conv.cu's BK)
constexpr int WSTAGES = 5;

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, __nv_bfloat16>::value
             ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
             : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
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

// The forward's and dgrad's shared memory: the ring (A then B each stage,
// 1024-byte aligned), the epilogue's staging tile over it, the barriers,
// dgrad's input pixel of each row, 1024 bytes to align.
template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BKC * BN * 2;   // either B layout
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int LDC = BN + 8;             // the staging tile's row
  static constexpr int RING = STAGES * STAGE;
  static constexpr int C_BYTES = BM * LDC * 2;
  static constexpr int OFF_BAR = RING > C_BYTES ? RING : C_BYTES;
  static constexpr int OFF_PIX = OFF_BAR + 8 * STAGES;
  static constexpr int BYTES = OFF_PIX + 4 * BM + 1024;
};

// What a block's rows decode with, made on the host once a launch:
// decoded in every block (parity_class's and the rows' integer divisions)
// they cost more than the K loop where K is one step, and 0.3 of dgrad's
// time at the 3x3/1 site.  The forward's rows: m = (b, oh, ow); dgrad's
// parity classes (at most kClasses, strides up to 4 x 4: the wrapper's
// route sends a larger stride to conv.cu) and their rows m = (b, i, j).
constexpr int kClasses = 16;
struct RowDivs {
  FastDiv hw, w;                       // by OH*OW, by OW
};
struct Classes {
  Parity c[kClasses];
  FastDiv hw[kClasses], w[kClasses];   // by the class's Hc*Wc, by its Wc
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The K loop of the forward (TB 1: B MN-major) and dgrad (TB 0: B
// K-major): `load(step)` issues step's A chunks of this thread (one
// cp.async group a step) and, from thread 0, its B box on the stage's
// barrier; each warpgroup multiplies its 64 rows of A by B, four k16 a
// step, into `acc`.  Ends with the ring free for the epilogue.
template <typename T, int BN, int TB, typename Load>
__device__ __forceinline__ void k_loop(float (&acc)[BN / 2], int nk,
                                       uint32_t ring, uint32_t full0,
                                       Load& load) {
  using L = Tile<BN>;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
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
      wgmma_ss<BF16, 0, TB>(
          acc, gmma_desc(a_addr + kk * 32, 16, 1024),
          TB ? gmma_desc(b_addr + kk * 16 * 128, 8192, 1024)
             : gmma_desc(b_addr + kk * 32, 16, 1024));
    wgmma_commit();
    // refill step j - 1's slot while the products run
    if (j + STAGES - 1 < nk) load(j + STAGES - 1);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the epilogue
}

// accumulators -> the staging tile, rounded to T: element 4 i + r is row
// g + 8 (r >> 1) of the warp's 16, column 8 i + 2 t + (r & 1)
template <typename T, int BN>
__device__ __forceinline__ void stage_acc(T* cs, const float (&acc)[BN / 2]) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg * 64 + warp * 16 + g + 8 * h;
      *reinterpret_cast<uint32_t*>(cs + row * Tile<BN>::LDC + 8 * i + 2 * t) =
          pack2<T>(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                      const ConvParams p,
                      const __grid_constant__ RowDivs rd) {
  using L = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
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
      const int bb = rd.hw(m), r = m - bb * p.OH * p.OW;
      const int oh = rd.w(r), ow = r - oh * p.OW;
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
  float acc[BN / 2];
  k_loop<T, BN, 1>(acc, nk, ring, full0, load);

  T* cs = reinterpret_cast<T*>(base);
  stage_acc<T, BN>(cs, acc);
  __syncthreads();
  for (int id = tid; id < BM * (BN / 8); id += THREADS) {
    const int r = id / (BN / 8), c8 = id % (BN / 8) * 8;
    const int m = m0 + r, n = n0 + c8;
    if (m < M && n < p.O)
      emit8<T>(p, static_cast<int64_t>(m) * p.O + n, n, cs + r * L::LDC + c8);
  }
}

// dgrad: the rows are parity class blockIdx.z's input pixels (bb, i, j),
// the columns c, K the class's taps x O.  p.a is dy, p.b w, p.out dx.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv_dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                        const ConvParams p,
                        const __grid_constant__ Classes classes) {
  using L = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t ring = smem_u32(base);
  const uint32_t full0 = smem_u32(base + L::OFF_BAR);
  int* rpix = reinterpret_cast<int*>(base + L::OFF_PIX);
  const int tid = threadIdx.x;
  const Parity cls = classes.c[blockIdx.z];
  const int M = p.N * cls.Hc * cls.Wc;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (m0 >= M) return;                 // a smaller class: no rows here
  const int nk = cls.nth * cls.ntw * (p.O / BKC);   // 0: the class is zeros

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init_fence();
    prefetch_map(&wmap);
  }

  // this thread's A chunks: column kc of rows ar + 32 i, decoded once into
  // dy's image base and the class's output row and column at tap (0, 0);
  // the row's input pixel for the epilogue
  const T* dy = static_cast<const T*>(p.a);
  const int kc = tid & 7, ar = tid >> 3;
  int rb[4], ry[4], rx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ar + 32 * i;
    rb[i] = 0;
    ry[i] = rx[i] = kFar;
    if (m < M) {
      const int bb = classes.hw[blockIdx.z](m);
      const int r = m - bb * cls.Hc * cls.Wc;
      const int ii = classes.w[blockIdx.z](r), jj = r - ii * cls.Wc;
      rb[i] = bb * p.OH * p.OW * p.O;
      ry[i] = ii + cls.oh0;
      rx[i] = jj + cls.ow0;
      if (kc == 0)
        rpix[ar + 32 * i] =
            (bb * p.H + cls.ph + p.sh * ii) * p.W + cls.pw + p.sw * jj;
    }
  }
  // the next load's tap of the class (jh, jw) and channel offset of dy
  int ljh = 0, ljw = 0, lc0 = 0;
  auto load = [&](int step) {
    const int s = step % STAGES;
    const uint32_t a_s = ring + s * L::STAGE;
    const int oy = ljh * cls.doh, ox = ljw * cls.dow;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yy = ry[i] - oy, xx = rx[i] - ox;
      const bool ok =
          static_cast<unsigned>(yy) < static_cast<unsigned>(p.OH) &&
          static_cast<unsigned>(xx) < static_cast<unsigned>(p.OW);
      const T* src = ok ? dy + rb[i] + (yy * p.OW + xx) * p.O + lc0 + kc * 8
                        : dy;
      cp_async16(a_s + swz(ar + 32 * i, kc), src, ok);
    }
    if (tid == 0) {
      const uint32_t full = full0 + 8 * s;
      const int tap = (cls.kh0 + ljh * cls.sth) * p.KW + cls.kw0 +
                      ljw * cls.stw;
      mbar_expect_tx(full, L::B_BYTES);
      tma_load_2d(base + s * L::STAGE + L::A_BYTES, &wmap, full, lc0,
                  tap * p.C + n0);
    }
    lc0 += BKC;
    if (lc0 == p.O) {
      lc0 = 0;
      if (++ljw == cls.ntw) {
        ljw = 0;
        ++ljh;
      }
    }
  };

  __syncthreads();                     // the barriers and rpix are written
  float acc[BN / 2];
  k_loop<T, BN, 0>(acc, nk, ring, full0, load);

  T* cs = reinterpret_cast<T*>(base);
  stage_acc<T, BN>(cs, acc);
  __syncthreads();
  T* dx = static_cast<T*>(p.out);
  for (int id = tid; id < BM * (BN / 8); id += THREADS) {
    const int r = id / (BN / 8), c8 = id % (BN / 8) * 8;
    const int m = m0 + r, n = n0 + c8;
    if (m < M && n < p.C) {
      T v[8];
      load8(v, cs + r * L::LDC + c8);
      store8(dx + static_cast<int64_t>(rpix[r]) * p.C + n, v);
    }
  }
}

// wgrad's block: two warpgroups of WS 64-row sub-tiles of M each (a
// sub-tile is one tap's 64 channels) by BN columns of O: 256 x 64 (WS 2)
// or 128 x 128 (WS 1), 64 fp32 accumulators a thread either way.
template <int BN>
struct WTile {
  static constexpr int WS = BN == 64 ? 2 : 1;
  static constexpr int SUBS = 2 * WS;             // sub-tiles a block
  static constexpr int PANEL = BKP * 128;         // [32 px][64 values]
  static constexpr int A_BYTES = SUBS * PANEL;
  static constexpr int B_BYTES = BN / 64 * PANEL;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OFF_BAR = WSTAGES * STAGE;
  static constexpr int BYTES = OFF_BAR + 8 * WSTAGES + 1024;
  static_assert(2 * (BYTES + 1024) <= SMEM_OPTIN + 1024, "two blocks an SM");
};

// wgrad: the rows (tap, c) of sub-tiles blockIdx.x * SUBS on, the columns
// o, K the pixels of split blockIdx.z.  p.a is x, p.b dy, p.out the fp32
// workspace [splits, KH*KW*C, O].
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap dymap,
                        const ConvParams p,
                        const __grid_constant__ RowDivs rd) {
  using L = WTile<BN>;
  constexpr int WS = L::WS;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const uint32_t ring = smem_u32(base);
  const uint32_t full0 = smem_u32(base + L::OFF_BAR);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int cb = p.C / 64;                       // sub-tiles a tap
  const int subs = p.KH * p.KW * cb;             // M / 64
  const int g0 = blockIdx.x * L::SUBS, n0 = blockIdx.y * BN;
  const int hw = p.OH * p.OW;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.N * hw, k_begin + p.k_per_split);
  const int nk = (k_end - k_begin + BKP - 1) / BKP;

  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init_fence();
    prefetch_map(&dymap);
  }

  // this thread's A chunk of every sub-tile: column kc of pixel row ar;
  // each sub-tile's tap offsets, and its offset in x from the pixel's
  // tap-(0, 0) element, fixed for the K loop (a sub-tile past M fails
  // every bounds test)
  const T* x = static_cast<const T*>(p.a);
  const int kc = tid & 7, ar = tid >> 3;
  int uy[L::SUBS], ux[L::SUBS], uo[L::SUBS];
#pragma unroll
  for (int u = 0; u < L::SUBS; ++u) {
    const int g = g0 + u;
    const int tap = g / cb, kh = tap / p.KW, kw = tap - kh * p.KW;
    uy[u] = g < subs ? kh * p.dh : kFar;
    ux[u] = kw * p.dw;
    uo[u] = (kh * p.dh * p.W + ux[u]) * p.C + (g - tap * cb) * 64 + kc * 8;
  }
  int kp = k_begin;                    // the next load's first pixel
  auto load = [&](int step) {
    const int s = step % WSTAGES;
    const uint32_t a_s = ring + s * L::STAGE;
    const int px = kp + ar;
    const int bb = rd.hw(px), r = px - bb * hw;
    const int oh = rd.w(r), ow = r - oh * p.OW;
    // the pixel's tap-(0, 0) input coordinates and their element in x
    const bool live_px = px < k_end;
    const int iy = oh * p.sh - p.pt, ix = ow * p.sw - p.pl;
    const T* xp = x + (static_cast<int64_t>(bb * p.H + iy) * p.W + ix) * p.C;
#pragma unroll
    for (int u = 0; u < L::SUBS; ++u) {
      const int yy = iy + uy[u], xx = ix + ux[u];
      const bool ok = live_px &&
                      static_cast<unsigned>(yy) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(xx) < static_cast<unsigned>(p.W);
      cp_async16(a_s + u * L::PANEL + swz(ar, kc), ok ? xp + uo[u] : x, ok);
    }
    if (tid == 0) {
      const uint32_t full = full0 + 8 * s;
      mbar_expect_tx(full, L::B_BYTES);
#pragma unroll
      for (int pn = 0; pn < BN / 64; ++pn)
        tma_load_2d(base + s * L::STAGE + L::A_BYTES + pn * L::PANEL, &dymap,
                    full, n0 + 64 * pn, kp);
    }
    kp += BKP;
  };

  // The ring runs WSTAGES - 2 steps ahead of the products, and each
  // warpgroup keeps one step's products in flight while it passes the
  // next step's barrier: step j's products overlap step j + 1's wait, and
  // step j - 1's slot is the one refilled at step j + 1.
  __syncthreads();                     // the barriers are initialised
#pragma unroll
  for (int s = 0; s < WSTAGES - 2; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  float acc[WS][BN / 2];
  bool live[WS];                       // uniform over the warpgroup
#pragma unroll
  for (int u = 0; u < WS; ++u) {
    live[u] = g0 + wg * WS + u < subs;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[u][i] = 0.f;
  }
  for (int j = 0; j < nk; ++j) {
    const int s = j % WSTAGES;
    cp_async_wait<WSTAGES - 3>();      // this thread's A chunks of step j
    mbar_wait(full0 + 8 * s, (j / WSTAGES) & 1);   // B of step j
    fence_proxy_async();
    __syncthreads();   // every chunk of step j; step j - 2's products done
    const uint32_t st = ring + s * L::STAGE;
#pragma unroll
    for (int u = 0; u < WS; ++u) fence_regs(acc[u]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < WS; ++u)
      if (live[u]) {
        const uint32_t a_addr = st + (wg * WS + u) * L::PANEL;
#pragma unroll
        for (int kk = 0; kk < BKP / 16; ++kk)
          wgmma_ss<BF16, 1, 1>(
              acc[u], gmma_desc(a_addr + kk * 16 * 128, L::PANEL, 1024),
              gmma_desc(st + L::A_BYTES + kk * 16 * 128, L::PANEL, 1024));
      }
    wgmma_commit();
    // refill step j - 2's slot while the products run
    if (j + WSTAGES - 2 < nk) load(j + WSTAGES - 2);
    cp_async_commit();
    wgmma_wait<1>();                   // step j - 1's products done
#pragma unroll
    for (int u = 0; u < WS; ++u) fence_regs(acc[u]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < WS; ++u) fence_regs(acc[u]);
  cp_async_wait<0>();

  // the split's partial sums, straight from the accumulators: element
  // 4 i + r is row g + 8 (r >> 1) of the warp's 16, column 8 i + 2 t +
  // (r & 1)
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* ws = static_cast<float*>(p.out) +
              static_cast<int64_t>(blockIdx.z) * subs * 64 * p.O;
#pragma unroll
  for (int u = 0; u < WS; ++u) {
    if (!live[u]) continue;
    const int row = (g0 + wg * WS + u) * 64 + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      if (n >= p.O) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            ws + static_cast<int64_t>(row + 8 * h) * p.O + n) =
            make_float2(acc[u][4 * i + 2 * h], acc[u][4 * i + 2 * h + 1]);
    }
  }
}

// The smem opt-in, once per instantiation (not again while a CUDA graph
// is being captured).
template <typename K>
cudaError_t configure(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int BN>
cudaError_t launch_fwd(const ConvParams& p, cudaStream_t st) {
  using L = Tile<BN>;
  CUtensorMap wmap;
  const MapKey wk{p.b, static_cast<uint64_t>(p.KH) * p.KW * p.C,
                  static_cast<uint64_t>(p.O),
                  static_cast<uint64_t>(p.O) * sizeof(T), 64, BKC,
                  tma_type<T>(), CU_TENSOR_MAP_SWIZZLE_128B};
  if (!map_2d(&wmap, wk)) return cudaErrorInvalidValue;
  auto kernel = conv_fwd_wgmma_kernel<T, BN>;
  static const cudaError_t configured = configure(kernel, L::BYTES);
  if (configured != cudaSuccess) return configured;
  const int m = p.N * p.OH * p.OW;
  const dim3 grid((m + BM - 1) / BM, (p.O + BN - 1) / BN);
  const RowDivs rd{FastDiv(p.OH * p.OW), FastDiv(p.OW)};
  kernel<<<grid, THREADS, L::BYTES, st>>>(wmap, p, rd);
  return cudaGetLastError();
}

// Grid z: the parity classes (sh*sw; x sized by the largest, class
// (0, 0)).
template <typename T, int BN>
cudaError_t launch_dgrad(const ConvParams& p, cudaStream_t st) {
  using L = Tile<BN>;
  CUtensorMap wmap;
  const MapKey wk{p.b, static_cast<uint64_t>(p.KH) * p.KW * p.C,
                  static_cast<uint64_t>(p.O),
                  static_cast<uint64_t>(p.O) * sizeof(T), BKC, BN,
                  tma_type<T>(), CU_TENSOR_MAP_SWIZZLE_128B};
  if (!map_2d(&wmap, wk)) return cudaErrorInvalidValue;
  Classes classes{};
  for (int z = 0; z < kClasses && z < p.sh * p.sw; ++z) {
    classes.c[z] = parity_class(p, z);
    classes.hw[z] = FastDiv(classes.c[z].Hc * classes.c[z].Wc);
    classes.w[z] = FastDiv(classes.c[z].Wc);
  }
  auto kernel = conv_dgrad_wgmma_kernel<T, BN>;
  static const cudaError_t configured = configure(kernel, L::BYTES);
  if (configured != cudaSuccess) return configured;
  const int m = p.N * ((p.H + p.sh - 1) / p.sh) * ((p.W + p.sw - 1) / p.sw);
  const dim3 grid((m + BM - 1) / BM, (p.C + BN - 1) / BN, p.sh * p.sw);
  kernel<<<grid, THREADS, L::BYTES, st>>>(wmap, p, classes);
  return cudaGetLastError();
}

// Grid z: the K splits; then the reduce of the splits in order.
template <typename T, int BN>
cudaError_t launch_wgrad(const ConvParams& p, int splits, cudaStream_t st) {
  using L = WTile<BN>;
  CUtensorMap dymap;
  const MapKey dk{p.b, static_cast<uint64_t>(p.N) * p.OH * p.OW,
                  static_cast<uint64_t>(p.O),
                  static_cast<uint64_t>(p.O) * sizeof(T), 64, BKP,
                  tma_type<T>(), CU_TENSOR_MAP_SWIZZLE_128B};
  if (!map_2d(&dymap, dk)) return cudaErrorInvalidValue;
  auto kernel = conv_wgrad_wgmma_kernel<T, BN>;
  static const cudaError_t configured = configure(kernel, L::BYTES);
  if (configured != cudaSuccess) return configured;
  const int subs = p.KH * p.KW * (p.C / 64);
  const dim3 grid((subs + L::SUBS - 1) / L::SUBS, (p.O + BN - 1) / BN,
                  splits);
  const RowDivs rd{FastDiv(p.OH * p.OW), FastDiv(p.OW)};
  kernel<<<grid, THREADS, L::BYTES, st>>>(dymap, p, rd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return wgrad_reduce(p, std::is_same<T, __nv_bfloat16>::value ? 1 : 2,
                      splits, st);
}

// bn: the tile's width, 64 or 128, or -1 for the rule (128 where the
// GEMM's N is at least 128, else 64).
template <typename T>
cudaError_t by_tile(int pass, const ConvParams& p, int splits, int bn,
                    cudaStream_t st) {
  const int n = pass == 1 ? p.C : p.O;
  if (bn < 0) bn = n >= 128 ? 128 : 64;
  if (bn != 64 && bn != 128) return cudaErrorInvalidValue;
  if (pass == 0)
    return bn == 128 ? launch_fwd<T, 128>(p, st) : launch_fwd<T, 64>(p, st);
  if (pass == 1)
    return bn == 128 ? launch_dgrad<T, 128>(p, st)
                     : launch_dgrad<T, 64>(p, st);
  return bn == 128 ? launch_wgrad<T, 128>(p, splits, st)
                   : launch_wgrad<T, 64>(p, splits, st);
}

cudaError_t dispatch(int pass, const ConvParams& p, int dtype, int splits,
                     int bn, cudaStream_t st) {
  if (dtype == 1) return by_tile<__nv_bfloat16>(pass, p, splits, bn, st);
  if (dtype == 2) return by_tile<__half>(pass, p, splits, bn, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success).  dtype 1 picks bf16, 2 fp16 operands; every tensor contiguous
// and 16-byte aligned; bn the tile's width (64 or 128), -1 for the rule.  A
// map that cuTensorMapEncodeTiled refuses returns cudaErrorInvalidValue,
// launching nothing.

// C a multiple of 64, O of 8.
extern "C" int conv_fwd_wgmma(const ConvParams* p, int dtype, int bn,
                              void* stream) {
  if (p->C % BKC != 0 || p->O % 8 != 0) return cudaErrorInvalidValue;
  return static_cast<int>(
      dispatch(0, *p, dtype, 1, bn, static_cast<cudaStream_t>(stream)));
}

// dx from dy (p->a) and w (p->b): O a multiple of 64, C of 8; strides up to
// sh*sw 16 (one launch of the parity classes).
extern "C" int conv_dgrad_wgmma(const ConvParams* p, int dtype, int bn,
                                void* stream) {
  if (p->O % BKC != 0 || p->C % 8 != 0 || p->sh * p->sw > kClasses)
    return cudaErrorInvalidValue;
  return static_cast<int>(
      dispatch(1, *p, dtype, 1, bn, static_cast<cudaStream_t>(stream)));
}

// The split GEMM of x (p->a) and dy (p->b) into p->out (fp32 [splits,
// KH*KW*C, O], K split every p->k_per_split pixels, a multiple of 32), then
// the reduce into p->aux (dw): C a multiple of 64, O of 8.  The wrapper
// sizes the splits as for conv.cu's conv_wgrad, whatever bn is.
extern "C" int conv_wgrad_wgmma(const ConvParams* p, int dtype, int splits,
                                int bn, void* stream) {
  if (p->C % 64 != 0 || p->O % 8 != 0 || p->k_per_split % BKP != 0)
    return cudaErrorInvalidValue;
  return static_cast<int>(dispatch(2, *p, dtype, splits, bn,
                                   static_cast<cudaStream_t>(stream)));
}
