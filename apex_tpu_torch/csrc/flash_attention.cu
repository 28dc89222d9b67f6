// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel apex_tpu/ops/flash_attention.py
// `_fwd_kernel` (launched by `_flash_fwd_pallas`): online-softmax
// attention that never writes the [T, S] score matrix to device memory,
// returning `out` and the fp32 log-sum-exp `lse` of every query row.
//
// What it computes, per (batch b, head h, query row t):
//   s[key] = (q . k) * sm_scale + key_padding_bias[b, key] + bias[b, t, key]
//   causal: key visible iff key <= q_offset + t (and, with a window,
//           q_offset + t - key < window); hidden keys get p = 0, as the
//           Pallas kernel's `jnp.where(mask, p, 0)`
//   out = sum_key p * v / l,  lse = m + log(l);  l == 0 -> out 0, lse NEG_INF
// with (m, l, acc) carried in fp32.  p is rounded to the value dtype
// before the PV product, as the TPU kernel casts p to v's dtype; fp32
// inputs are computed in full fp32 (no TF32).  GQA reads KV head
// h / (H / H_kv) directly: nothing is repeated.  Any head width up to 256
// runs in the next instantiated width (16, 32, 64, 128, 256): loads read
// the missing columns as zero and stores skip them, so nothing padded is
// ever in device memory and the results are those of the unpadded
// function.
//
// What bounds it on the H100, and what the design does about it:
//  * Prefill and training (q_len >= 16, bf16/fp16) are bound by
//    operations: ~4 T S H D flops against ~(T + 2 S) H D bytes.  The first
//    kernel ran both products as fp32 FMA loops over shared memory (one
//    shared-memory load per FMA, 17-24x SDPA).  Here they run on the
//    tensor cores: `mma.sync.m16n8k16` (bf16/fp16 in, fp32 accumulate),
//    operands from shared memory by `ldmatrix` (V by `ldmatrix.trans`),
//    the scores, softmax statistics and O accumulator in registers (FA2's
//    layout: a warp owns 16 query rows, each row's four lanes reduce its
//    max and sum with two shuffles), P packed from the score registers
//    straight into the A fragments of O += P V.  K and V tiles are
//    double-buffered in shared memory by 16-byte `cp.async` copies, so the
//    next tile loads under the current tile's math; rows are padded by 16
//    bytes, which leaves `ldmatrix` free of bank conflicts.  The fp32
//    [B, T, S] bias tile rides in the same copy stages (read from shared
//    memory as float2, rows padded by 8 floats), so its latency is hidden
//    too.  A block is 4 warps (64 query rows) over KV tiles of 64 keys: at
//    the LM's B 8, T 1023 that is 1,536 blocks, at a B 1 prefill 192.
//    Two 16-row tiles a warp (128-row blocks) measured slower at every
//    phase-4 shape on the H100: the registers they need leave one block
//    an SM.  `wgmma` and TMA are later work.  Query tiles are issued
//    longest first, so causal blocks with the most keys start earliest.
//  * fp32 prefill keeps a SIMT kernel in full fp32 (the tensor cores would
//    round to TF32): 64 query rows, two threads a row, FMA loops.  Width
//    256 takes the same kernel for every dtype (p rounded to v's dtype),
//    at 32 rows and 32 keys a tile, four threads a row: the tensor-core
//    kernel's O accumulator and Q fragments (16 rows by 256 a warp) would
//    leave no registers for the scores.  Chosen by shape, not yet fast.
//  * Decode (q_len < 16, serving's q_len = 1) is bound by the K/V bytes.
//    One block per (b, h) streamed 1,024 keys on 96 blocks; here the keys
//    split into chunks (grid: chunks x H x B, sized by the wrapper to
//    cover the 132 SMs several times), each block reads its chunk with
//    16-byte loads and writes its fp32 (m, l, acc) to scratch, and a
//    combine kernel merges the chunks in order: deterministic, a chunk
//    with l == 0 adds nothing, a row hidden everywhere gives 0 and
//    lse = NEG_INF.  One call is then two kernels.
//
// Common to all paths: KV tiles or chunks wholly outside the causal or
// sliding-window band are never loaded (loop bounds), ragged q_len / kv_len
// are masked, and q, k, v and out are read through their strides in the
// [B, T, H, D] layout, so the wrapper makes no transposed copies.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// Field order and types mirror the ctypes Structure in
// apex_tpu_torch/ops/flash_attention.py (_FlashParams).
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* kbias;   // [B, S] fp32 or null
  const float* bias;    // [B, T, S] fp32 (last stride 1) or null
  void* out;
  float* lse;           // [B, H, T] fp32, contiguous
  float* part_o;        // decode: [B, H, T, splits, Dp] fp32 scratch
  float* part_ml;       // decode: [B, H, T, splits, 2] fp32 (m, l)
  int64_t sq_b, sq_t, sq_h;
  int64_t sk_b, sk_t, sk_h;
  int64_t sv_b, sv_t, sv_h;
  int64_t so_b, so_t, so_h;
  int64_t skb_b;
  int64_t sb_b, sb_t;
  int32_t B, H, Hkv, tq, tk;
  int32_t causal, q_offset, window;   // window 0 = none
  int32_t d;            // the head width (<= the instantiated width)
  int32_t vec;          // 1: d % 8 == 0 and every row 16-byte aligned
  int32_t splits, chunk;              // decode: key chunks of `chunk`
  int32_t bvec;         // 1: the bias rows take 16-byte copies
  float sm_scale;
};

namespace {

constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

// round to nearest even, as astype does
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
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

// the two 16-bit values of a 32-bit word to fp32, the low half first
template <typename T> __device__ __forceinline__ void unpack2(uint32_t w,
                                                              float& lo,
                                                              float& hi);
template <> __device__ __forceinline__ void unpack2<__nv_bfloat16>(
    uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
template <> __device__ __forceinline__ void unpack2<__half>(uint32_t w,
                                                            float& lo,
                                                            float& hi) {
  lo = __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
  hi = __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !ok
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  if (key >= p.tk) return false;
  if (!p.causal) return true;
  const int qpos = p.q_offset + row;
  return key <= qpos && (p.window <= 0 || qpos - key < p.window);
}

// The key range a block of query rows [q0, q_last] can see: tiles outside
// the causal / window band are skipped by these bounds.
__device__ __forceinline__ void key_band(const Params& p, int q0, int q_last,
                                         int& k_begin, int& k_end) {
  k_begin = 0;
  k_end = p.tk;
  if (p.causal) {
    k_end = min(p.tk, p.q_offset + q_last + 1);
    if (p.window > 0) k_begin = max(0, p.q_offset + q0 - p.window + 1);
  }
}

// -- bf16 / fp16 prefill: tensor cores ----------------------------------------

constexpr int TC_BQ = 64;        // query rows per block (16 per warp)
constexpr int TC_BK = 64;        // keys per KV tile
constexpr int TC_THREADS = 128;  // 4 warps
constexpr int TC_LDB = TC_BK + 8;   // fp32 bias tile row (conflict-free)

// Rows [r0, r0 + ROWS) of a [*, d] operand (row stride `st`) into a
// [ROWS][D + 8] tile: 16-byte cp.async copies when `vec`, else element
// loads; rows past `n` and columns past `d` are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t st,
                                          int r0, int n, int d, bool vec) {
  constexpr int LDS = D + 8, CPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += TC_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int t = r0 + r;
    T* s = dst + r * LDS + c;
    if (vec) {
      const bool ok = t < n && c < d;
      cp_async16(s, ok ? src + t * st + c : src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[j] = (t < n && c + j < d) ? src[t * st + c + j] : from_f<T>(0.f);
    }
  }
}

// The [ROWS, 64] block of the fp32 [T, S] bias at (q0, k0) into a
// [ROWS][TC_LDB] tile, 16-byte cp.async copies when `bvec` (kv_len and
// the strides multiples of 4, the rows 16-byte aligned); zero outside.
template <int ROWS>
__device__ __forceinline__ void load_bias(float* dst, const float* bias,
                                          int64_t st, int q0, int k0, int tq,
                                          int tk, bool bvec) {
  for (int i = threadIdx.x; i < ROWS * (TC_BK / 4); i += TC_THREADS) {
    const int r = i / (TC_BK / 4), c = (i % (TC_BK / 4)) * 4;
    const int t = q0 + r, key = k0 + c;
    float* s = dst + r * TC_LDB + c;
    if (bvec) {
      const bool ok = t < tq && key < tk;
      cp_async16(s, ok ? bias + t * st + key : bias, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] = (t < tq && key + j < tk) ? bias[t * st + key + j] : 0.f;
    }
  }
}

// A block is 4 warps, each owning 16 query rows.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_mma_kernel(const Params p) {
  constexpr int LDS = D + 8;       // padded row: conflict-free ldmatrix
  constexpr int KD = D / 16;       // k-steps of S = Q K^T
  constexpr int NS = TC_BK / 8;    // 8-key n-tiles of S
  constexpr int NO = D / 8;        // 8-column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BQ][LDS], later the output
  T* Ks = Qs + TC_BQ * LDS;                 // [2][BK][LDS]
  T* Vs = Ks + 2 * TC_BK * LDS;             // [2][BK][LDS]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TC_BK * LDS);
                                            // [2][BQ][TC_LDB] with a bias

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const bool vec = p.vec, bvec = p.bvec;

  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;

  const int q_last = min(q0 + TC_BQ, p.tq) - 1;
  int k_begin, k_end;
  key_band(p, q0, q_last, k_begin, k_end);
  k_begin = (k_begin / TC_BK) * TC_BK;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + TC_BK - 1) / TC_BK : 0;

  load_tile<T, D, TC_BQ>(Qs, q, p.sq_t, q0, p.tq, p.d, vec);
  if (n_tiles > 0) {
    load_tile<T, D, TC_BK>(Ks, k, p.sk_t, k_begin, p.tk, p.d, vec);
    load_tile<T, D, TC_BK>(Vs, v, p.sv_t, k_begin, p.tk, p.d, vec);
    if (bias)
      load_bias<TC_BQ>(Bs, bias, p.sb_t, q0, k_begin, p.tq, p.tk, bvec);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 query rows stay in registers as A fragments
  const int wrow = warp * 16;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], Qs + (wrow + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int row0 = q0 + wrow + g;          // rows g and g + 8 of the warp

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * TC_BK;
    const int buf = j & 1;
    if (j > 0) {
      cp_async_wait_all();                 // tile j has landed
      __syncthreads();                     // and tile j - 1 is consumed
    }
    if (j + 1 < n_tiles) {                 // tile j + 1 loads under the math
      load_tile<T, D, TC_BK>(Ks + (buf ^ 1) * TC_BK * LDS, k, p.sk_t,
                             k0 + TC_BK, p.tk, p.d, vec);
      load_tile<T, D, TC_BK>(Vs + (buf ^ 1) * TC_BK * LDS, v, p.sv_t,
                             k0 + TC_BK, p.tk, p.d, vec);
      if (bias)
        load_bias<TC_BQ>(Bs + (buf ^ 1) * TC_BQ * TC_LDB, bias, p.sb_t, q0,
                         k0 + TC_BK, p.tq, p.tk, bvec);
    }
    cp_async_commit();
    const T* Kb = Ks + buf * TC_BK * LDS;
    const T* Vb = Vs + buf * TC_BK * LDS;
    const float* Bb = Bs + (buf * TC_BQ + wrow + g) * TC_LDB + 2 * t4;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, Kb + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816<T>(s[2 * np], qf[kk], kf[0], kf[1]);
        mma16816<T>(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, biases and the band; element (n, r) is row g + 8 (r >> 1) of
    // the warp, key n * 8 + 2 t4 + (r & 1)
    const bool edge =
        k0 + TC_BK > p.tk ||
        (p.causal && (k0 + TC_BK - 1 > p.q_offset + q0 ||
                      (p.window > 0 && p.q_offset + q_last - k0 >= p.window)));
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int key0 = k0 + n * 8 + 2 * t4;
      float add[4] = {0.f, 0.f, 0.f, 0.f};
      if (kb != nullptr) {
        add[0] = add[2] = key0 < p.tk ? kb[key0] : 0.f;
        add[1] = add[3] = key0 + 1 < p.tk ? kb[key0 + 1] : 0.f;
      }
      if (bias != nullptr) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 bb = *reinterpret_cast<const float2*>(
              Bb + 8 * hh * TC_LDB + n * 8);
          add[2 * hh] += bb.x;
          add[2 * hh + 1] += bb.y;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = fmaf(s[n][r], p.sm_scale, add[r]);
        if (edge && !visible(p, row0 + 8 * (r >> 1), key0 + (r & 1)))
          x = -INFINITY;
        s[n][r] = x;
        mt[r >> 1] = fmaxf(mt[r >> 1], x);
      }
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m_r[i], mt[i]);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;   // a row hidden so far
      alpha[i] = __expf(m_r[i] - mu[i]);
      m_r[i] = m_new;
    }

    // p in fp32 into l; O rescaled
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[n][r] = __expf(s[n][r] - mu[r >> 1]);
        ls[r >> 1] += s[n][r];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + ls[i];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, p rounded to the value dtype as it is packed into the A
    // fragments
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              LDS + dp * 16 + (lane >> 4) * 8);
        mma16816<T>(o[2 * dp], pa, vf[0], vf[1]);
        mma16816<T>(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  // stage the warp's 16 output rows in its own Q rows (read only by it,
  // into registers, before the loop), then 16-byte stores
  T* Os = Qs + wrow * LDS;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv = l_r[hh] > 0.f ? 1.f / l_r[hh] : 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(Os + (g + 8 * hh) * LDS + n * 8 + 2 * t4) =
          pack2<T>(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
  }
  __syncwarp();
  T* out = static_cast<T*>(p.out) + b * p.so_b + h * p.so_h;
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = q0 + wrow + r;
    if (row >= p.tq || c >= p.d) continue;
    T* dst = out + row * p.so_t + c;
    const T* src = Os + r * LDS + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int jj = 0; jj < 8 && c + jj < p.d; ++jj) dst[jj] = src[jj];
    }
  }
  if (t4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row < p.tq)
        p.lse[(static_cast<int64_t>(b) * p.H + h) * p.tq + row] =
            l_r[hh] > 0.f ? m_r[hh] + logf(l_r[hh]) : NEG_INF;
    }
  }
}

// -- fp32 prefill, and every dtype at width 256: SIMT ---------------------------

constexpr int F_THREADS = 128;

// x rounded to T and back: the TPU kernel's cast of p to v's dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// BQ query rows a block over KV tiles of BQ keys: 64 up to width 128,
// 32 at 256 (fp32 tiles of 64 rows would not fit the SM's shared memory).
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(F_THREADS)
flash_fwd_simt_kernel(const Params p) {
  constexpr int BK = BQ;
  constexpr int TPR = F_THREADS / BQ;     // threads sharing one query row
  constexpr int NS = BK / TPR;            // score columns per thread
  constexpr int NA = D / TPR;             // output dims per thread
  constexpr int QS = D + 1;               // padded row strides (banks)
  constexpr int PS = BK + 1;

  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][QS]
  float* Ks = Qs + BQ * QS;            // [BK][QS]
  float* Vs = Ks + BK * QS;            // [BK][D]
  float* Ps = Vs + BK * D;             // [BQ][PS] probabilities
  float* Bs = Ps + BQ * PS;            // [BQ][PS] bias tile
  float* KBs = Bs + BQ * PS;           // [BK] key bias

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int lane = tid % TPR;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);

  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;

  for (int i = tid; i < BQ * D; i += F_THREADS) {
    const int rr = i / D, d = i % D;
    const int t = q0 + rr;
    Qs[rr * QS + d] = t < p.tq && d < p.d ? to_f(q[t * p.sq_t + d]) : 0.f;
  }

  const int row = q0 + r;
  const int q_last = min(q0 + BQ, p.tq) - 1;
  int k_begin, k_end;
  key_band(p, q0, q_last, k_begin, k_end);
  k_begin = (k_begin / BK) * BK;

  float m = NEG_INF, l = 0.f;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float s[NS];

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                   // the previous tile is consumed
    for (int i = tid; i < BK * D; i += F_THREADS) {
      const int c = i / D, d = i % D;
      const int key = k0 + c;
      const bool in = key < p.tk && d < p.d;
      Ks[c * QS + d] = in ? to_f(k[key * p.sk_t + d]) : 0.f;
      Vs[c * D + d] = in ? to_f(v[key * p.sv_t + d]) : 0.f;
    }
    if (bias) {
      for (int i = tid; i < BQ * BK; i += F_THREADS) {
        const int rr = i / BK, c = i % BK;
        const int t = q0 + rr, key = k0 + c;
        Bs[rr * PS + c] =
            (t < p.tq && key < p.tk) ? bias[t * p.sb_t + key] : 0.f;
      }
    }
    if (kb) {
      for (int c = tid; c < BK; c += F_THREADS)
        KBs[c] = k0 + c < p.tk ? kb[k0 + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * QS + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] += qd * Ks[(j * TPR + lane) * QS + d];
    }

    uint32_t valid = 0;
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = j * TPR + lane;
      float x = s[j] * p.sm_scale;
      if (kb) x += KBs[c];
      if (bias) x += Bs[r * PS + c];
      const bool ok = visible(p, row, k0 + c);
      s[j] = ok ? x : NEG_INF;
      valid |= static_cast<uint32_t>(ok) << j;
      mt = fmaxf(mt, s[j]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);

    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float pj = (valid >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      ls += pj;
      Ps[r * PS + j * TPR + lane] = round_to<T>(pj);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();                      // a row's lanes share one warp

#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float pc = Ps[r * PS + c];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += pc * Vs[c * D + i * TPR + lane];
    }
  }

  if (row < p.tq) {
    const float safe = l == 0.f ? 1.f : l;
    T* o = static_cast<T*>(p.out) + b * p.so_b + row * p.so_t + h * p.so_h;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (i * TPR + lane < p.d) o[i * TPR + lane] = from_f<T>(acc[i] / safe);
    if (lane == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.tq + row] =
          l == 0.f ? NEG_INF : m + logf(safe);
  }
}

// -- decode: split-KV ----------------------------------------------------------

constexpr int SP_THREADS = 128;
constexpr int SP_ROWS = 16;      // decode takes q_len < 16
constexpr int SP_RB = 4;         // query rows per pass of the PV sum

// Elements [c, c + 8) of one row, to fp32: 16-byte loads when `vec`;
// zeros for a row that is not `ok` and for columns past d.
template <typename T>
__device__ __forceinline__ void load8(float (&x)[8], const T* row, bool ok,
                                      int c, int d, bool vec) {
  if (!ok || c >= d) {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = 0.f;
  } else if (vec) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(row + c));
      const float4 b = __ldg(reinterpret_cast<const float4*>(row + c + 4));
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + c));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) unpack2<T>(w[j], x[2 * j], x[2 * j + 1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = c + j < d ? to_f(row[c + j]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(SP_THREADS)
flash_fwd_split_kernel(const Params p) {
  constexpr int LPK = D / 8;               // lanes per key row
  constexpr int KPP = SP_THREADS / LPK;    // keys per pass
  extern __shared__ float sm[];
  float* qs = sm;                          // [SP_ROWS][D] fp32 queries
  float* red = qs + SP_ROWS * D;           // [KPP][SP_RB][D] PV partials
  float* ps = red + KPP * SP_RB * D;       // [tq][chunk] scores, then p

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x, grp = tid / LPK, c8 = (tid % LPK) * 8;
  const int c0 = split * p.chunk;
  int lo = c0, hi = min(p.tk, c0 + p.chunk);
  if (p.causal) {                          // the band of rows 0 .. tq - 1
    hi = min(hi, p.q_offset + p.tq);
    if (p.window > 0) lo = max(lo, p.q_offset - p.window + 1);
  }
  const int64_t rbase = (static_cast<int64_t>(b) * p.H + h) * p.tq;
  auto slot = [&](int r) { return (rbase + r) * p.splits + split; };

  if (lo >= hi) {                          // nothing visible: l = 0
    for (int i = tid; i < p.tq * D; i += SP_THREADS)
      p.part_o[slot(i / D) * D + i % D] = 0.f;
    for (int r = tid; r < p.tq; r += SP_THREADS) {
      p.part_ml[slot(r) * 2] = NEG_INF;
      p.part_ml[slot(r) * 2 + 1] = 0.f;
    }
    return;
  }

  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;
  const bool vec = p.vec;

  for (int i = tid; i < p.tq * D; i += SP_THREADS) {
    const int r = i / D, dd = i % D;
    qs[r * D + dd] = dd < p.d ? to_f(q[r * p.sq_t + dd]) : 0.f;
  }
  __syncthreads();

  // scores: LPK lanes share a key row, 8 columns each
  for (int kb0 = lo; kb0 < hi; kb0 += KPP) {
    const int key = kb0 + grp;
    float kx[8];
    load8<T>(kx, k + static_cast<int64_t>(key) * p.sk_t, key < hi, c8, p.d,
             vec);
    for (int r = 0; r < p.tq; ++r) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) part = fmaf(kx[j], qs[r * D + c8 + j], part);
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (c8 == 0 && key < hi) {
        float x = part * p.sm_scale;
        if (kb) x += kb[key];
        if (bias) x += bias[r * p.sb_t + key];
        ps[r * p.chunk + key - c0] = visible(p, r, key) ? x : -INFINITY;
      }
    }
  }
  __syncthreads();

  // the chunk's (m, l) per row; p rounded to the value dtype in place
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < p.tq; r += SP_THREADS / 32) {
    float* row = ps + r * p.chunk;
    float mx = -INFINITY;
    for (int key = lo + lane; key < hi; key += 32)
      mx = fmaxf(mx, row[key - c0]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mu = mx == -INFINITY ? 0.f : mx;
    float l = 0.f;
    for (int key = lo + lane; key < hi; key += 32) {
      const float e = expf(row[key - c0] - mu);
      l += e;
      row[key - c0] = to_f(from_f<T>(e));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      p.part_ml[slot(r) * 2] = mx == -INFINITY ? NEG_INF : mx;
      p.part_ml[slot(r) * 2 + 1] = l;
    }
  }
  __syncthreads();

  // acc = sum_key p v, SP_RB rows a pass, key groups summed in order
  for (int r0 = 0; r0 < p.tq; r0 += SP_RB) {
    float acc[SP_RB][8];
#pragma unroll
    for (int rr = 0; rr < SP_RB; ++rr)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[rr][j] = 0.f;
    for (int key = lo + grp; key < hi; key += KPP) {
      float vx[8];
      load8<T>(vx, v + static_cast<int64_t>(key) * p.sv_t, true, c8, p.d,
               vec);
#pragma unroll
      for (int rr = 0; rr < SP_RB; ++rr) {
        if (r0 + rr >= p.tq) break;
        const float pr = ps[(r0 + rr) * p.chunk + key - c0];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[rr][j] = fmaf(pr, vx[j], acc[rr][j]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < SP_RB; ++rr)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(grp * SP_RB + rr) * D + c8 + j] = acc[rr][j];
    __syncthreads();
    for (int i = tid; i < SP_RB * D; i += SP_THREADS) {
      const int rr = i / D, dd = i % D;
      if (r0 + rr >= p.tq) continue;
      float sum = 0.f;
      for (int gi = 0; gi < KPP; ++gi) sum += red[(gi * SP_RB + rr) * D + dd];
      p.part_o[slot(r0 + rr) * D + dd] = sum;
    }
    __syncthreads();
  }
}

// Merge the chunks of one query row in chunk order.
template <typename T, int D>
__global__ void __launch_bounds__(SP_THREADS)
flash_fwd_combine_kernel(const Params p) {
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int64_t row = (static_cast<int64_t>(b) * p.H + h) * p.tq + r;
  const float* ml = p.part_ml + row * p.splits * 2;
  const float* po = p.part_o + row * p.splits * D;
  float M = -INFINITY;
  for (int c = 0; c < p.splits; ++c)
    if (ml[2 * c + 1] > 0.f) M = fmaxf(M, ml[2 * c]);
  float L = 0.f;
  for (int c = 0; c < p.splits; ++c)
    if (ml[2 * c + 1] > 0.f) L += ml[2 * c + 1] * expf(ml[2 * c] - M);
  T* out = static_cast<T*>(p.out) + b * p.so_b + r * p.so_t + h * p.so_h;
  for (int dd = threadIdx.x; dd < p.d; dd += blockDim.x) {
    float o = 0.f;
    for (int c = 0; c < p.splits; ++c)
      if (ml[2 * c + 1] > 0.f) o += po[c * D + dd] * expf(ml[2 * c] - M);
    out[dd] = from_f<T>(L > 0.f ? o / L : 0.f);
  }
  if (threadIdx.x == 0) p.lse[row] = L > 0.f ? M + logf(L) : NEG_INF;
}

// -- launchers -----------------------------------------------------------------

// Opt in to more than 48 KB of dynamic shared memory once per
// instantiation (and not again while a CUDA graph is being captured).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
cudaError_t launch_mma(const Params& p, cudaStream_t st) {
  constexpr int base = (TC_BQ + 4 * TC_BK) * (D + 8) * sizeof(T);
  constexpr int with_bias = base + 2 * TC_BQ * TC_LDB * sizeof(float);
  auto kernel = flash_fwd_mma_kernel<T, D>;
  static const cudaError_t configured = allow_smem(kernel, with_bias);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tq + TC_BQ - 1) / TC_BQ, p.H, p.B);
  kernel<<<grid, TC_THREADS, p.bias ? with_bias : base, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_simt(const Params& p, cudaStream_t st) {
  constexpr int BQ = D > 128 ? 32 : 64;
  constexpr int smem = sizeof(float) * (2 * BQ * (D + 1) + BQ * D +
                                        2 * BQ * (BQ + 1) + BQ);
  auto kernel = flash_fwd_simt_kernel<T, D, BQ>;
  static const cudaError_t configured = allow_smem(kernel, smem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tq + BQ - 1) / BQ, p.H, p.B);
  kernel<<<grid, F_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

constexpr int SP_MAX_SMEM = 96 * 1024;

template <typename T, int D>
cudaError_t launch_split(const Params& p, cudaStream_t st) {
  const int smem = sizeof(float) * (SP_ROWS * D +
                                    SP_THREADS / (D / 8) * SP_RB * D +
                                    p.tq * p.chunk);
  if (p.tq >= SP_ROWS || smem > SP_MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_split_kernel<T, D>;
  static const cudaError_t configured = allow_smem(kernel, SP_MAX_SMEM);
  if (configured != cudaSuccess) return configured;
  kernel<<<dim3(p.splits, p.H, p.B), SP_THREADS, smem, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_fwd_combine_kernel<T, D><<<dim3(p.tq, p.H, p.B), SP_THREADS, 0, st>>>(
      p);
  return cudaGetLastError();
}

// The wrapper decides the path: scratch and chunks (p.splits > 0) for
// q_len < 16, none otherwise.  Tensor cores take bf16 / fp16 up to width
// 128; fp32, and every dtype at 256, take the SIMT kernel.
template <typename T, int D>
cudaError_t by_path(const Params& p, cudaStream_t st) {
  if (p.splits > 0) return launch_split<T, D>(p, st);
  if constexpr (std::is_same<T, float>::value || D > 128)
    return launch_simt<T, D>(p, st);
  else return launch_mma<T, D>(p, st);
}

template <typename T>
cudaError_t by_dim(const Params& p, int head_dim, cudaStream_t st) {
  switch (head_dim) {
    case 16: return by_path<T, 16>(p, st);
    case 32: return by_path<T, 32>(p, st);
    case 64: return by_path<T, 64>(p, st);
    case 128: return by_path<T, 128>(p, st);
    case 256: return by_path<T, 256>(p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// head_dim is the instantiated width (16/32/64/128/256, >= p->d); dtype
// 0 fp32, 1 bf16, 2 fp16.  p->splits > 0 (q_len < 16) takes the split-KV
// path (p->splits chunks of p->chunk keys, scratch in p->part_o /
// p->part_ml, then the combine kernel); otherwise one kernel, tensor
// cores for bf16/fp16 up to width 128.
extern "C" int flash_attention_fwd(const Params* p, int head_dim, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = by_dim<float>(*p, head_dim, st);
  else if (dtype == 1) err = by_dim<__nv_bfloat16>(*p, head_dim, st);
  else if (dtype == 2) err = by_dim<__half>(*p, head_dim, st);
  return static_cast<int>(err);
}
