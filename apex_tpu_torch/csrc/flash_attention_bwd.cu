// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels apex_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (dQ), `_bwd_dkv_kernel` (dK, dV and the partial sums
// of the key-padding-bias gradient) and `_bwd_db2_kernel` (the
// head-summed gradient of a [B, T, S] bias), all launched by
// `_flash_bwd_pallas`.  None writes the [T, S] score matrix of a head to
// device memory: each recomputes it tile by tile from q, k and the
// forward's fp32 log-sum-exp `lse`.
//
// What they compute, per (batch b, query head h, query row t, key j):
//   s    = (q . k) * sm_scale + key_padding_bias[b, j] + bias[b, t, j]
//   p    = exp(s - lse[b, h, t]), 0 where the causal / window band hides
//          j (a fully masked row has lse = NEG_INF, so without the zero
//          its hidden entries would be 1) and for padding past T or S
//   dp   = dO . v
//   ds   = p * (dp - delta[b, h, t]) * sm_scale,  delta = rowsum(dO * out)
//   dq   = sum_j ds(rounded to the input dtype) * k
//   dv   = sum_t p(rounded to the input dtype) * dO
//   dk   = sum_t ds(rounded) * q
//   dkb  = sum_t ds (fp32, unrounded), per (b, h, j): the caller sums it
//          over heads and divides by sm_scale
//   db2  = sum_h ds (fp32, unrounded) * (1 / sm_scale), per (b, t, j)
// with every product accumulated in fp32, as the Pallas kernels do
// (`_recompute_p_ds`, `p.astype(do.dtype)`, `ds.astype(k.dtype)`).
//
// What bounds them on the H100: as written, shared-memory bandwidth.
// Each score and each accumulation is a plain fp32 FMA loop over
// shared-memory tiles, one shared-memory load per FMA, as in the forward
// kernel.  Tensor cores (wgmma), TMA and split designs are later work.
//
// Design:
//  * dQ: grid (query tiles of 64, heads, batch); the block keeps its Q and
//    dO tiles in shared memory and loops over the KV tiles of 64 keys in
//    its causal / window band (tiles outside it are never loaded);
//  * dK/dV: grid (key tiles of 64, KV heads, batch); the block keeps its K
//    and V tiles and fp32 dK, dV accumulators in registers and loops over
//    the H / H_kv query heads that share the KV head (GQA) and, for each,
//    over the query tiles in the band.  A KV head's query heads therefore
//    sum into one accumulator: no atomics, no second pass;
//  * db2: grid (key tiles of 64, query tiles of 64, batch); the head axis
//    is INSIDE the block, as in the Pallas kernel: one block owns one
//    (b, q-tile, k-tile) of the output, loops over all H query heads (GQA
//    heads read KV head h / (H / H_kv)), recomputes s, p, dp and ds for
//    each, sums ds in fp32 registers and writes the tile once.  No
//    atomics, deterministic.  Tiles outside the causal / window band are
//    written as zeros without loading anything;
//  * 256 threads; 4 threads share one row (a query row in dQ, a key row
//    in dK/dV) and split its 64 columns and D output dims between them,
//    reducing with warp shuffles; a row's threads sit in one warp;
//  * ragged edges (T = 1023 in training) are masked, so any length works;
//  * any head width up to 128 runs in the next instantiated width (16, 32,
//    64, 128): the tiles read the missing columns as zero and the stores
//    skip them, so the results are those of the unpadded function;
//  * fp32, bf16 and fp16 inputs (the rounding of p and ds is to the
//    input's own type);
//  * q, k, v, dO and the outputs are read and written through their
//    strides in the [B, T, H, D] layout, as the forward does;
//  * shared-memory rows are padded by one float against bank conflicts;
//    tiles are fp32 whatever the input dtype, so at D = 128 a block takes
//    162 KB (dQ) and 179 KB (dK/dV) of the SM's 227 KB.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Field order and types mirror the ctypes Structure in
// apex_tpu_torch/ops/flash_attention.py (_FlashBwdParams).
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
  float* dbias;         // [B, T, S] fp32, contiguous, or null (db2 only)
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

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 256;
constexpr int TPR = 4;          // threads sharing one row
constexpr int NS = 64 / TPR;    // score columns per thread
constexpr int PS = 64 + 1;      // padded stride of a [64][64] tile
static_assert(NTHREADS / TPR == BQ && NTHREADS / TPR == BK, "tile shape");

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
  return __float2bfloat16(x);   // round to nearest even, as astype does
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back: the Pallas kernels' `.astype(dtype)` before a
// product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ bool visible(const BwdParams& p, int t, int key) {
  if (t >= p.tq || key >= p.tk) return false;
  if (!p.causal) return true;
  const int qpos = p.q_offset + t;
  return key <= qpos && (p.window <= 0 || qpos - key < p.window);
}

// Load rows [r0, r0 + 64) of a [*, d] operand (row stride `st`) into a
// [64][D + 1] fp32 tile; rows past `n` and columns past `d` (a width
// padded to the instantiated D) are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t st, int r0, int n, int dw) {
  constexpr int QS = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NTHREADS) {
    const int rr = i / D, d = i % D;
    const int t = r0 + rr;
    dst[rr * QS + d] = t < n && d < dw ? to_f(src[t * st + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int NA = D / TPR;          // dq dims per thread
  constexpr int QS = D + 1;

  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][QS]
  float* dOs = Qs + BQ * QS;           // [BQ][QS]
  float* Ks = dOs + BQ * QS;           // [BK][QS]
  float* Vs = Ks + BK * QS;            // [BK][QS]
  float* DSs = Vs + BK * QS;           // [BQ][PS] ds, rounded
  float* Bs = DSs + BQ * PS;           // [BQ][PS] bias tile
  float* KBs = Bs + BQ * PS;           // [BK] key bias

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int lane = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);

  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* dout = static_cast<const T*>(p.dout) + b * p.sdo_b + h * p.sdo_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;

  load_tile<T, D>(Qs, q, p.sq_t, q0, p.tq, p.d);
  load_tile<T, D>(dOs, dout, p.sdo_t, q0, p.tq, p.d);

  const int row = q0 + r;
  const bool row_ok = row < p.tq;
  const int64_t rix = (static_cast<int64_t>(b) * p.H + h) * p.tq + row;
  const float lse_r = row_ok ? p.lse[rix] : 0.f;
  const float delta_r = row_ok ? p.delta[rix] : 0.f;

  const int q_last = min(q0 + BQ, p.tq) - 1;
  int k_begin = 0, k_end = p.tk;
  if (p.causal) {                      // skip tiles outside the band
    k_end = min(p.tk, p.q_offset + q_last + 1);
    if (p.window > 0) k_begin = max(0, p.q_offset + q0 - p.window + 1);
  }
  k_begin = (k_begin / BK) * BK;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float s[NS], dp[NS];

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                   // the previous tile is consumed
    load_tile<T, D>(Ks, k, p.sk_t, k0, p.tk, p.d);
    load_tile<T, D>(Vs, v, p.sv_t, k0, p.tk, p.d);
    if (bias) {
      for (int i = tid; i < BQ * BK; i += NTHREADS) {
        const int rr = i / BK, c = i % BK;
        const int t = q0 + rr, key = k0 + c;
        Bs[rr * PS + c] =
            (t < p.tq && key < p.tk) ? bias[t * p.sb_t + key] : 0.f;
      }
    }
    if (kb) {
      for (int c = tid; c < BK; c += NTHREADS)
        KBs[c] = k0 + c < p.tk ? kb[k0 + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * QS + d];
      const float od = dOs[r * QS + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = j * TPR + lane;
        s[j] += qd * Ks[c * QS + d];
        dp[j] += od * Vs[c * QS + d];
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = j * TPR + lane;
      float x = s[j] * p.sm_scale;
      if (kb) x += KBs[c];
      if (bias) x += Bs[r * PS + c];
      const float pj = visible(p, row, k0 + c) ? expf(x - lse_r) : 0.f;
      DSs[r * PS + c] = round_to<T>(pj * (dp[j] - delta_r) * p.sm_scale);
    }
    __syncwarp();                      // a row's lanes share one warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float dsc = DSs[r * PS + c];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += dsc * Ks[c * QS + i * TPR + lane];
    }
  }

  if (row_ok) {
    T* dq = static_cast<T*>(p.dq) + b * p.sdq_b + row * p.sdq_t + h * p.sdq_h;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (i * TPR + lane < p.d) dq[i * TPR + lane] = from_f<T>(acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int NA = D / TPR;          // dk / dv dims per thread
  constexpr int QS = D + 1;

  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][QS]
  float* Vs = Ks + BK * QS;            // [BK][QS]
  float* Qs = Vs + BK * QS;            // [BQ][QS]
  float* dOs = Qs + BQ * QS;           // [BQ][QS]
  float* Ps = dOs + BQ * QS;           // [BK][PS] p, rounded
  float* DSs = Ps + BK * PS;           // [BK][PS] ds, rounded
  float* Bs = DSs + BK * PS;           // [BK][PS] bias tile, key-major
  float* Ls = Bs + BK * PS;            // [BQ] lse
  float* Dl = Ls + BQ;                 // [BQ] delta
  float* KBs = Dl + BQ;                // [BK] key bias

  const int tid = threadIdx.x;
  const int c = tid / TPR;             // key row of this thread
  const int lane = tid % TPR;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = p.H / p.Hkv;

  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;

  load_tile<T, D>(Ks, k, p.sk_t, k0, p.tk, p.d);
  load_tile<T, D>(Vs, v, p.sv_t, k0, p.tk, p.d);
  for (int i = tid; i < BK; i += NTHREADS)
    KBs[i] = (kb && k0 + i < p.tk) ? kb[k0 + i] : 0.f;

  const int key = k0 + c;
  // the query rows that see any key of this tile (JAX `_qc`)
  int q_begin = 0, q_end = p.tq;
  if (p.causal) {
    q_begin = max(0, k0 - p.q_offset);
    if (p.window > 0)
      q_end = min(p.tq, k0 + BK - 1 + p.window - p.q_offset);
  }
  q_begin = (q_begin / BQ) * BQ;

  float acc_k[NA], acc_v[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc_k[i] = acc_v[i] = 0.f;
  float s[NS], dp[NS];

  for (int g = 0; g < grp; ++g) {
    const int h = hk * grp + g;
    const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
    const T* dout =
        static_cast<const T*>(p.dout) + b * p.sdo_b + h * p.sdo_h;
    const int64_t hrow = (static_cast<int64_t>(b) * p.H + h) * p.tq;
    float db_acc = 0.f;

    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();                 // the previous tile is consumed
      load_tile<T, D>(Qs, q, p.sq_t, q0, p.tq, p.d);
      load_tile<T, D>(dOs, dout, p.sdo_t, q0, p.tq, p.d);
      for (int i = tid; i < BQ; i += NTHREADS) {
        const bool in = q0 + i < p.tq;
        Ls[i] = in ? p.lse[hrow + q0 + i] : 0.f;
        Dl[i] = in ? p.delta[hrow + q0 + i] : 0.f;
      }
      if (bias) {
        for (int i = tid; i < BQ * BK; i += NTHREADS) {
          const int rr = i / BK, cc = i % BK;   // coalesced along keys
          const int t = q0 + rr, kk = k0 + cc;
          Bs[cc * PS + rr] =
              (t < p.tq && kk < p.tk) ? bias[t * p.sb_t + kk] : 0.f;
        }
      }
      __syncthreads();

#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = Ks[c * QS + d];
        const float vd = Vs[c * QS + d];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int rr = j * TPR + lane;
          s[j] += kd * Qs[rr * QS + d];
          dp[j] += vd * dOs[rr * QS + d];
        }
      }
      float db_part = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int rr = j * TPR + lane;
        float x = s[j] * p.sm_scale + KBs[c];
        if (bias) x += Bs[c * PS + rr];
        const float pj = visible(p, q0 + rr, key) ? expf(x - Ls[rr]) : 0.f;
        const float ds = pj * (dp[j] - Dl[rr]) * p.sm_scale;
        db_part += ds;
        Ps[c * PS + rr] = round_to<T>(pj);
        DSs[c * PS + rr] = round_to<T>(ds);
      }
      if (p.dkbias) {
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          db_part += __shfl_xor_sync(0xffffffffu, db_part, off);
        db_acc += db_part;
      }
      __syncwarp();                    // a key's lanes share one warp

#pragma unroll 4
      for (int rr = 0; rr < BQ; ++rr) {
        const float pc = Ps[c * PS + rr];
        const float dsc = DSs[c * PS + rr];
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          acc_v[i] += pc * dOs[rr * QS + i * TPR + lane];
          acc_k[i] += dsc * Qs[rr * QS + i * TPR + lane];
        }
      }
    }
    if (p.dkbias && lane == 0 && key < p.tk)
      p.dkbias[(static_cast<int64_t>(b) * p.H + h) * p.tk + key] = db_acc;
  }

  if (key < p.tk) {
    T* dk = static_cast<T*>(p.dk) + b * p.sdk_b + key * p.sdk_t + hk * p.sdk_h;
    T* dv = static_cast<T*>(p.dv) + b * p.sdv_b + key * p.sdv_t + hk * p.sdv_h;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (i * TPR + lane >= p.d) continue;
      dk[i * TPR + lane] = from_f<T>(acc_k[i]);
      dv[i * TPR + lane] = from_f<T>(acc_v[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_db2_kernel(const BwdParams p) {
  constexpr int QS = D + 1;

  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][QS]
  float* dOs = Qs + BQ * QS;           // [BQ][QS]
  float* Ks = dOs + BQ * QS;           // [BK][QS]
  float* Vs = Ks + BK * QS;            // [BK][QS]
  float* Bs = Vs + BK * QS;            // [BQ][PS] bias tile, then output
  float* Ls = Bs + BQ * PS;            // [BQ] lse of this head
  float* Dl = Ls + BQ;                 // [BQ] delta of this head
  float* KBs = Dl + BQ;                // [BK] key bias

  const int tid = threadIdx.x;
  const int r = tid / TPR;             // query row of this thread
  const int lane = tid % TPR;
  const int k0 = blockIdx.x * BK;
  const int q0 = blockIdx.y * BQ;
  const int b = blockIdx.z;
  const int grp = p.H / p.Hkv;
  float* out = p.dbias + (static_cast<int64_t>(b) * p.tq + q0) * p.tk + k0;

  // a tile no query row of which sees any of its keys: zeros
  bool live = true;
  if (p.causal) {
    const int q_last = min(q0 + BQ, p.tq) - 1;
    const int k_last = min(k0 + BK, p.tk) - 1;
    live = k0 <= p.q_offset + q_last
           && (p.window <= 0 || p.q_offset + q0 - k_last < p.window);
  }
  if (!live) {
    for (int i = tid; i < BQ * BK; i += NTHREADS) {
      const int rr = i / BK, c = i % BK;
      if (q0 + rr < p.tq && k0 + c < p.tk)
        out[static_cast<int64_t>(rr) * p.tk + c] = 0.f;
    }
    return;
  }

  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias + b * p.sb_b;
  for (int i = tid; i < BQ * BK; i += NTHREADS) {
    const int rr = i / BK, c = i % BK;
    const int t = q0 + rr, key = k0 + c;
    Bs[rr * PS + c] = (t < p.tq && key < p.tk) ? bias[t * p.sb_t + key] : 0.f;
  }
  for (int c = tid; c < BK; c += NTHREADS)
    KBs[c] = (kb && k0 + c < p.tk) ? kb[k0 + c] : 0.f;

  const int row = q0 + r;
  float acc[NS], s[NS], dp[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) acc[j] = 0.f;

  for (int h = 0; h < p.H; ++h) {
    const int hk = h / grp;
    __syncthreads();                   // the previous head's tiles consumed
    load_tile<T, D>(Qs, static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h,
                    p.sq_t, q0, p.tq, p.d);
    load_tile<T, D>(dOs,
                    static_cast<const T*>(p.dout) + b * p.sdo_b + h * p.sdo_h,
                    p.sdo_t, q0, p.tq, p.d);
    load_tile<T, D>(Ks, static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h,
                    p.sk_t, k0, p.tk, p.d);
    load_tile<T, D>(Vs, static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h,
                    p.sv_t, k0, p.tk, p.d);
    const int64_t hrow = (static_cast<int64_t>(b) * p.H + h) * p.tq;
    for (int i = tid; i < BQ; i += NTHREADS) {
      const bool in = q0 + i < p.tq;
      Ls[i] = in ? p.lse[hrow + q0 + i] : 0.f;
      Dl[i] = in ? p.delta[hrow + q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * QS + d];
      const float od = dOs[r * QS + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int c = j * TPR + lane;
        s[j] += qd * Ks[c * QS + d];
        dp[j] += od * Vs[c * QS + d];
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = j * TPR + lane;
      const float x = s[j] * p.sm_scale + KBs[c] + Bs[r * PS + c];
      const float pj = visible(p, row, k0 + c) ? expf(x - Ls[r]) : 0.f;
      acc[j] += pj * (dp[j] - Dl[r]) * p.sm_scale;
    }
  }

  // stage the tile through shared memory for coalesced stores
  __syncthreads();
  const float inv_scale = 1.0f / p.sm_scale;
#pragma unroll
  for (int j = 0; j < NS; ++j) Bs[r * PS + j * TPR + lane] = acc[j] * inv_scale;
  __syncthreads();
  for (int i = tid; i < BQ * BK; i += NTHREADS) {
    const int rr = i / BK, c = i % BK;
    if (q0 + rr < p.tq && k0 + c < p.tk)
      out[static_cast<int64_t>(rr) * p.tk + c] = Bs[rr * PS + c];
  }
}

// Each launcher opts in to more than 48 KB of shared memory once per
// instantiation (and not again while a CUDA graph is being captured).
template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  constexpr int QS = D + 1;
  const size_t smem = sizeof(float) * (2 * BQ * QS + 2 * BK * QS
                                       + 2 * BQ * PS + BK);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tq + BQ - 1) / BQ, p.H, p.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  constexpr int QS = D + 1;
  const size_t smem = sizeof(float) * (2 * BK * QS + 2 * BQ * QS
                                       + 3 * BK * PS + 2 * BQ + BK);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tk + BK - 1) / BK, p.Hkv, p.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_db2(const BwdParams& p, cudaStream_t stream) {
  constexpr int QS = D + 1;
  const size_t smem = sizeof(float) * (2 * BQ * QS + 2 * BK * QS
                                       + BQ * PS + 2 * BQ + BK);
  auto kernel = flash_bwd_db2_kernel<T, D>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tk + BK - 1) / BK, (p.tq + BQ - 1) / BQ, p.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

enum class Which { kDq, kDkv, kDb2 };

template <typename T, int D>
cudaError_t launch(const BwdParams& p, Which which, cudaStream_t st) {
  switch (which) {
    case Which::kDq: return launch_dq<T, D>(p, st);
    case Which::kDkv: return launch_dkv<T, D>(p, st);
    case Which::kDb2: return launch_db2<T, D>(p, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(const BwdParams& p, int head_dim, Which which,
                   cudaStream_t st) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, which, st);
    case 32: return launch<T, 32>(p, which, st);
    case 64: return launch<T, 64>(p, which, st);
    case 128: return launch<T, 128>(p, which, st);
  }
  return cudaErrorInvalidValue;
}

int run(const BwdParams* p, int head_dim, int dtype, Which which,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = by_dim<float>(*p, head_dim, which, st);
  else if (dtype == 1) err = by_dim<__nv_bfloat16>(*p, head_dim, which, st);
  else if (dtype == 2) err = by_dim<__half>(*p, head_dim, which, st);
  return static_cast<int>(err);
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on
// success).  head_dim is the instantiated width (16/32/64/128, >= p->d);
// dtype 0 fp32, 1 bf16, 2 fp16.
extern "C" int flash_attention_bwd_dq(const BwdParams* p, int head_dim,
                                      int dtype, void* stream) {
  return run(p, head_dim, dtype, Which::kDq, stream);
}

extern "C" int flash_attention_bwd_dkv(const BwdParams* p, int head_dim,
                                       int dtype, void* stream) {
  return run(p, head_dim, dtype, Which::kDkv, stream);
}

// p->bias and p->dbias must be set.
extern "C" int flash_attention_bwd_db2(const BwdParams* p, int head_dim,
                                       int dtype, void* stream) {
  return run(p, head_dim, dtype, Which::kDb2, stream);
}
