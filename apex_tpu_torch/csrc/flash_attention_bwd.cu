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
// dQ and dK/dV stay two kernels, each recomputing s and dp (seven
// products a visible pair instead of FA2's five): every output has one
// owner block, so there are no atomics and the results are bit-stable
// from run to run, as in the JAX package.
//
// What bounds them on the H100, and what the design does about it:
//  * bf16 / fp16 at head widths up to 128 (training, the main path) are
//    bound by operations: 14 T S H D flops against ~(4 T + 4 S) H D
//    bytes, so every product runs on the tensor cores:
//    `mma.sync.m16n8k16` (bf16/fp16 in, fp32 accumulate), operands from
//    shared memory by `ldmatrix` (the row-major operand of a product by
//    `ldmatrix.trans`), the score tiles and the accumulators in
//    registers in the accumulator layout, p and ds rounded and packed
//    from those registers straight into the A fragments of the next
//    product, as the forward packs P.  Tiles move by 16-byte `cp.async`
//    copies (zero-filled past the ragged edges, so nothing padded is in
//    device memory) into double buffers, rows padded by 16 bytes, which
//    leaves `ldmatrix` free of bank conflicts.
//    - dQ: a block is 4 warps over 64 query rows (16 a warp), looping
//      over the KV tiles of 64 keys in its band; Q and dO stay as A
//      fragments in registers at widths up to 32 (wider, they are read
//      again by `ldmatrix` each tile: held, they pushed `ptxas` past the
//      168 registers that fit three blocks an SM, into spills), lse and
//      delta are per-row scalars; S = Q K^T and dP = dO V^T take K and V
//      as the column operand, dQ += dS K takes K by `ldmatrix.trans`.
//      K, V and the fp32 bias tile are double-buffered.  Query tiles
//      issue longest first under causal masking.
//    - dK/dV: a block is 4 warps over 64 keys (16 a warp), looping over
//      the H / H_kv query heads of its KV head (GQA: they sum into one
//      accumulator) and, for each, over the 64-row query tiles in its
//      band, key-major: S^T = K Q^T and dP^T = V dO^T with K and V as A
//      fragments (held in registers up to width 64), dV += P^T dO and
//      dK += dS^T Q take dO and Q by `ldmatrix.trans`.  lse and delta
//      are per column here: each query tile's come into shared memory
//      with it.  The key-bias partial sum is the fp32 row sum of dS^T in
//      the accumulator layout (two shuffles among four lanes).  A query
//      tile is taken in passes of 64 columns at width 64 and of 32 at
//      16 and 32 (the fastest measured), of 16 at 128, where the dK and
//      dV accumulators hold 128 registers a thread; one pass at a time
//      (`unroll 1`), so `ptxas` reports no spill at any width.  Key tile
//      0, which sees the most queries under causal masking, is issued
//      first.  Q, dO, lse, delta and the bias tile are double-buffered,
//      across head boundaries too.
//    - The tensor cores truncate inside a sum, so an accumulator carried
//      through every tile drifts further than fp32 summation (dV of a
//      KV head shared by 3 query heads was one bf16 ulp off at |dv| ~ 5):
//      each tile's (dQ) or pass's (dK, dV) products sum in a fresh
//      accumulator, added to the running one by an IEEE fp32 add.
//  * fp32 keeps SIMT kernels in full fp32 (the tensor cores would round
//    to TF32): 256 threads, a row (a query row in dQ and db2, a key row
//    in dK/dV) shared by several threads that split its columns and its
//    output dims and reduce with warp shuffles, fp32 tiles in shared
//    memory padded by one float against bank conflicts; 64-row tiles up
//    to width 128 (162 KB for dQ, 179 KB for dK/dV at 128).  Each tells
//    `ptxas` how many blocks its shared memory lets an SM hold (one or
//    two): left to guess, it held width 256's dQ to 64 registers, 1.4x
//    slower, and told one, it gave db2 at 64 too many for two.
//  * Head width 256 runs the SIMT kernels for every dtype (p and ds
//    rounded to the input's type, as above) at 32-row, 32-key tiles:
//    64-row fp32 tiles would not fit the SM's 227 KB, and the tensor-core
//    kernels' fp32 accumulators (dQ, or dK and dV, 16 rows by 256 a warp)
//    would leave no registers for the score tiles.  A kernel chosen by
//    shape, not yet one made fast.
//  * db2 (off every main path): the head axis is INSIDE the block, as in
//    the Pallas kernel; one block owns one (b, 64-row query tile, 64-key
//    tile) of the output, loops over all H query heads, sums ds in fp32
//    registers and writes the tile once, staged through shared memory
//    for coalesced stores.  Per visible pair and head it recomputes S
//    and dP (4 D flops) and one exp: bound by operations (4 T S H D
//    flops against ~(2 T + 2 S) H D + 8 T S bytes).  bf16 / fp16 up to
//    width 128 run it on the tensor cores (`flash_bwd_db2_mma_kernel`):
//    4 warps of 16 rows, S and dP by `mma.sync` from `ldmatrix`
//    fragments as dQ computes them, the next head's Q, dO, K and V in
//    flight by `cp.async` while this head computes, the bias tile, key
//    bias and band mask read once into registers, ds unrounded in the
//    accumulator layout.  fp32 and widths above 128 keep the SIMT
//    kernel.  Tiles outside the causal / window band are written as
//    zeros without loading anything.
//
// Common to all: tiles outside the causal / window band are never loaded
// (loop bounds); ragged edges (T = 1023 in training) are masked, so any
// length works; any head width up to 256 runs in the next instantiated
// width (16, 32, 64, 128, 256): the tiles read the missing columns as
// zero and the stores skip them; a wider head runs the 256 SIMT kernels
// in 256-wide column slices (a correctness path: no model of the repo
// runs it); q, k, v, dO and the outputs are read and written through
// their strides in the [B, T, H, D] layout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// The widest instantiation: a head wider than it runs in it, in MAX_D-wide
// column slices.  Narrower instantiations have one slice at compile time,
// so they compile as they would without the slicing.
constexpr int MAX_D = 256;
template <int D>
__host__ __device__ __forceinline__ int slices(int d) {
  return D == MAX_D ? (d + D - 1) / D : 1;
}

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
  return __float2bfloat16_rn(x);   // round to nearest even, as astype does
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back: the Pallas kernels' `.astype(dtype)` before a
// product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
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

__device__ __forceinline__ bool visible(const BwdParams& p, int t, int key) {
  if (t >= p.tq || key >= p.tk) return false;
  if (!p.causal) return true;
  const int qpos = p.q_offset + t;
  return key <= qpos && (p.window <= 0 || qpos - key < p.window);
}

// -- fp32 (and every dtype at width 256): SIMT --------------------------------

constexpr int NTHREADS = 256;

// Blocks an SM that `floats` of shared memory leave room for, at most
// two: the kernels tell `ptxas` (`__launch_bounds__`), which otherwise
// sizes registers for an occupancy the shared memory does not allow.
__host__ __device__ constexpr int blocks_per_sm(int floats) {
  return 233472 / (floats * 4 + 1024) >= 2 ? 2 : 1;
}
// the shared floats of the three SIMT kernels
__host__ __device__ constexpr int dq_floats(int D, int BT) {
  return 4 * BT * (D + 1) + 2 * BT * (BT + 1) + BT;
}
__host__ __device__ constexpr int dkv_floats(int D, int BT) {
  return 4 * BT * (D + 1) + 3 * BT * (BT + 1) + 3 * BT;
}
__host__ __device__ constexpr int db2_floats(int D, int BT) {
  return 4 * BT * (D + 1) + BT * (BT + 1) + 3 * BT;
}

// Load rows [r0, r0 + ROWS) of a [*, d] operand (row stride `st`) into a
// [ROWS][D + 1] fp32 tile; rows past `n` and columns past `d` (a width
// padded to the instantiated D) are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const T* src,
                                              int64_t st, int r0, int n,
                                              int dw) {
  constexpr int QS = D + 1;
  for (int i = threadIdx.x; i < ROWS * D; i += NTHREADS) {
    const int rr = i / D, d = i % D;
    const int t = r0 + rr;
    dst[rr * QS + d] = t < n && d < dw ? to_f(src[t * st + d]) : 0.f;
  }
}

// BT rows (queries or keys) a tile; TPR threads share one row.  A head
// wider than D (D = 256) is taken in D-wide column slices, in every SIMT
// kernel: S and dP sum their products over every slice, each loaded in
// turn into the same tiles, and blockIdx.y / H (dQ) or / H_kv (dK/dV)
// picks the slice of the output a block writes, so no block holds more
// than D accumulator columns; each slice's blocks recompute S and dP.
template <typename T, int D, int BT>
__global__ void __launch_bounds__(NTHREADS, blocks_per_sm(dq_floats(D, BT)))
flash_bwd_dq_simt_kernel(const BwdParams p) {
  constexpr int TPR = NTHREADS / BT;   // threads sharing one query row
  constexpr int NS = BT / TPR;         // score columns per thread
  constexpr int NA = D / TPR;          // dq dims per thread
  constexpr int QS = D + 1;
  constexpr int PS = BT + 1;

  extern __shared__ float smem[];
  float* Qs = smem;                    // [BT][QS]
  float* dOs = Qs + BT * QS;           // [BT][QS]
  float* Ks = dOs + BT * QS;           // [BT][QS]
  float* Vs = Ks + BT * QS;            // [BT][QS]
  float* DSs = Vs + BT * QS;           // [BT][PS] ds, rounded
  float* Bs = DSs + BT * PS;           // [BT][PS] bias tile
  float* KBs = Bs + BT * PS;           // [BT] key bias

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int lane = tid % TPR;
  const int q0 = blockIdx.x * BT;
  const int nsl = slices<D>(p.d);   // D-wide slices of the head
  const int h = blockIdx.y / nsl;
  const int sl = blockIdx.y - h * nsl; // the slice of dQ this block writes
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);

  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* dout = static_cast<const T*>(p.dout) + b * p.sdo_b + h * p.sdo_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;

  if (nsl == 1) {
    load_tile_f32<T, D, BT>(Qs, q, p.sq_t, q0, p.tq, p.d);
    load_tile_f32<T, D, BT>(dOs, dout, p.sdo_t, q0, p.tq, p.d);
  }

  const int row = q0 + r;
  const bool row_ok = row < p.tq;
  const int64_t rix = (static_cast<int64_t>(b) * p.H + h) * p.tq + row;
  const float lse_r = row_ok ? p.lse[rix] : 0.f;
  const float delta_r = row_ok ? p.delta[rix] : 0.f;

  const int q_last = min(q0 + BT, p.tq) - 1;
  int k_begin = 0, k_end = p.tk;
  if (p.causal) {                      // skip tiles outside the band
    k_end = min(p.tk, p.q_offset + q_last + 1);
    if (p.window > 0) k_begin = max(0, p.q_offset + q0 - p.window + 1);
  }
  k_begin = (k_begin / BT) * BT;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float s[NS], dp[NS];

  for (int k0 = k_begin; k0 < k_end; k0 += BT) {
    __syncthreads();                   // the previous tile is consumed
    if (nsl == 1) {
      load_tile_f32<T, D, BT>(Ks, k, p.sk_t, k0, p.tk, p.d);
      load_tile_f32<T, D, BT>(Vs, v, p.sv_t, k0, p.tk, p.d);
    }
    if (bias) {
      for (int i = tid; i < BT * BT; i += NTHREADS) {
        const int rr = i / BT, c = i % BT;
        const int t = q0 + rr, key = k0 + c;
        Bs[rr * PS + c] =
            (t < p.tq && key < p.tk) ? bias[t * p.sb_t + key] : 0.f;
      }
    }
    if (kb) {
      for (int c = tid; c < BT; c += NTHREADS)
        KBs[c] = k0 + c < p.tk ? kb[k0 + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
    for (int sc = 0; sc < nsl; ++sc) {
      if (nsl > 1) {                   // slice sc of Q, dO, K and V
        if (sc > 0) __syncthreads();
        const int dw = p.d - sc * D;
        load_tile_f32<T, D, BT>(Qs, q + sc * D, p.sq_t, q0, p.tq, dw);
        load_tile_f32<T, D, BT>(dOs, dout + sc * D, p.sdo_t, q0, p.tq, dw);
        load_tile_f32<T, D, BT>(Ks, k + sc * D, p.sk_t, k0, p.tk, dw);
        load_tile_f32<T, D, BT>(Vs, v + sc * D, p.sv_t, k0, p.tk, dw);
        __syncthreads();
      }
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
    }
    if (nsl > 1 && sl != nsl - 1) {    // the slice of K this block sums
      __syncthreads();
      load_tile_f32<T, D, BT>(Ks, k + sl * D, p.sk_t, k0, p.tk,
                              p.d - sl * D);
      __syncthreads();
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
    for (int c = 0; c < BT; ++c) {
      const float dsc = DSs[r * PS + c];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += dsc * Ks[c * QS + i * TPR + lane];
    }
  }

  if (row_ok) {
    T* dq = static_cast<T*>(p.dq) + b * p.sdq_b + row * p.sdq_t + h * p.sdq_h +
            sl * D;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (i * TPR + lane < p.d - sl * D) dq[i * TPR + lane] = from_f<T>(acc[i]);
  }
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(NTHREADS, blocks_per_sm(dkv_floats(D, BT)))
flash_bwd_dkv_simt_kernel(const BwdParams p) {
  constexpr int TPR = NTHREADS / BT;   // threads sharing one key row
  constexpr int NS = BT / TPR;
  constexpr int NA = D / TPR;          // dk / dv dims per thread
  constexpr int QS = D + 1;
  constexpr int PS = BT + 1;

  extern __shared__ float smem[];
  float* Ks = smem;                    // [BT][QS]
  float* Vs = Ks + BT * QS;            // [BT][QS]
  float* Qs = Vs + BT * QS;            // [BT][QS]
  float* dOs = Qs + BT * QS;           // [BT][QS]
  float* Ps = dOs + BT * QS;           // [BT][PS] p, rounded
  float* DSs = Ps + BT * PS;           // [BT][PS] ds, rounded
  float* Bs = DSs + BT * PS;           // [BT][PS] bias tile, key-major
  float* Ls = Bs + BT * PS;            // [BT] lse
  float* Dl = Ls + BT;                 // [BT] delta
  float* KBs = Dl + BT;                // [BT] key bias

  const int tid = threadIdx.x;
  const int c = tid / TPR;             // key row of this thread
  const int lane = tid % TPR;
  const int k0 = blockIdx.x * BT;
  const int nsl = slices<D>(p.d);   // D-wide slices of the head
  const int hk = blockIdx.y / nsl;
  const int sl = blockIdx.y - hk * nsl;  // the slice of dK, dV written
  const int b = blockIdx.z;
  const int grp = p.H / p.Hkv;

  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;

  if (nsl == 1) {
    load_tile_f32<T, D, BT>(Ks, k, p.sk_t, k0, p.tk, p.d);
    load_tile_f32<T, D, BT>(Vs, v, p.sv_t, k0, p.tk, p.d);
  }
  for (int i = tid; i < BT; i += NTHREADS)
    KBs[i] = (kb && k0 + i < p.tk) ? kb[k0 + i] : 0.f;

  const int key = k0 + c;
  // the query rows that see any key of this tile (JAX `_qc`)
  int q_begin = 0, q_end = p.tq;
  if (p.causal) {
    q_begin = max(0, k0 - p.q_offset);
    if (p.window > 0)
      q_end = min(p.tq, k0 + BT - 1 + p.window - p.q_offset);
  }
  q_begin = (q_begin / BT) * BT;

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

    for (int q0 = q_begin; q0 < q_end; q0 += BT) {
      __syncthreads();                 // the previous tile is consumed
      if (nsl == 1) {
        load_tile_f32<T, D, BT>(Qs, q, p.sq_t, q0, p.tq, p.d);
        load_tile_f32<T, D, BT>(dOs, dout, p.sdo_t, q0, p.tq, p.d);
      }
      for (int i = tid; i < BT; i += NTHREADS) {
        const bool in = q0 + i < p.tq;
        Ls[i] = in ? p.lse[hrow + q0 + i] : 0.f;
        Dl[i] = in ? p.delta[hrow + q0 + i] : 0.f;
      }
      if (bias) {
        for (int i = tid; i < BT * BT; i += NTHREADS) {
          const int rr = i / BT, cc = i % BT;   // coalesced along keys
          const int t = q0 + rr, kk = k0 + cc;
          Bs[cc * PS + rr] =
              (t < p.tq && kk < p.tk) ? bias[t * p.sb_t + kk] : 0.f;
        }
      }
      __syncthreads();

#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
      for (int sc = 0; sc < nsl; ++sc) {
        if (nsl > 1) {                 // slice sc of K, V, Q and dO
          if (sc > 0) __syncthreads();
          const int dw = p.d - sc * D;
          load_tile_f32<T, D, BT>(Ks, k + sc * D, p.sk_t, k0, p.tk, dw);
          load_tile_f32<T, D, BT>(Vs, v + sc * D, p.sv_t, k0, p.tk, dw);
          load_tile_f32<T, D, BT>(Qs, q + sc * D, p.sq_t, q0, p.tq, dw);
          load_tile_f32<T, D, BT>(dOs, dout + sc * D, p.sdo_t, q0, p.tq,
                                  dw);
          __syncthreads();
        }
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
      }
      if (nsl > 1 && sl != nsl - 1) {  // the slices of Q and dO summed
        __syncthreads();
        const int dw = p.d - sl * D;
        load_tile_f32<T, D, BT>(Qs, q + sl * D, p.sq_t, q0, p.tq, dw);
        load_tile_f32<T, D, BT>(dOs, dout + sl * D, p.sdo_t, q0, p.tq, dw);
        __syncthreads();
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
      for (int rr = 0; rr < BT; ++rr) {
        const float pc = Ps[c * PS + rr];
        const float dsc = DSs[c * PS + rr];
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          acc_v[i] += pc * dOs[rr * QS + i * TPR + lane];
          acc_k[i] += dsc * Qs[rr * QS + i * TPR + lane];
        }
      }
    }
    if (p.dkbias && lane == 0 && key < p.tk && sl == 0)
      p.dkbias[(static_cast<int64_t>(b) * p.H + h) * p.tk + key] = db_acc;
  }

  if (key < p.tk) {
    T* dk = static_cast<T*>(p.dk) + b * p.sdk_b + key * p.sdk_t +
            hk * p.sdk_h + sl * D;
    T* dv = static_cast<T*>(p.dv) + b * p.sdv_b + key * p.sdv_t +
            hk * p.sdv_h + sl * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (i * TPR + lane >= p.d - sl * D) continue;
      dk[i * TPR + lane] = from_f<T>(acc_k[i]);
      dv[i * TPR + lane] = from_f<T>(acc_v[i]);
    }
  }
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(NTHREADS, blocks_per_sm(db2_floats(D, BT)))
flash_bwd_db2_kernel(const BwdParams p) {
  constexpr int TPR = NTHREADS / BT;   // threads sharing one query row
  constexpr int NS = BT / TPR;
  constexpr int QS = D + 1;
  constexpr int PS = BT + 1;

  extern __shared__ float smem[];
  float* Qs = smem;                    // [BT][QS]
  float* dOs = Qs + BT * QS;           // [BT][QS]
  float* Ks = dOs + BT * QS;           // [BT][QS]
  float* Vs = Ks + BT * QS;            // [BT][QS]
  float* Bs = Vs + BT * QS;            // [BT][PS] bias tile, then output
  float* Ls = Bs + BT * PS;            // [BT] lse of this head
  float* Dl = Ls + BT;                 // [BT] delta of this head
  float* KBs = Dl + BT;                // [BT] key bias

  const int tid = threadIdx.x;
  const int r = tid / TPR;             // query row of this thread
  const int lane = tid % TPR;
  const int k0 = blockIdx.x * BT;
  const int q0 = blockIdx.y * BT;
  const int b = blockIdx.z;
  const int grp = p.H / p.Hkv;
  float* out = p.dbias + (static_cast<int64_t>(b) * p.tq + q0) * p.tk + k0;

  // a tile no query row of which sees any of its keys: zeros
  bool live = true;
  if (p.causal) {
    const int q_last = min(q0 + BT, p.tq) - 1;
    const int k_last = min(k0 + BT, p.tk) - 1;
    live = k0 <= p.q_offset + q_last
           && (p.window <= 0 || p.q_offset + q0 - k_last < p.window);
  }
  if (!live) {
    for (int i = tid; i < BT * BT; i += NTHREADS) {
      const int rr = i / BT, c = i % BT;
      if (q0 + rr < p.tq && k0 + c < p.tk)
        out[static_cast<int64_t>(rr) * p.tk + c] = 0.f;
    }
    return;
  }

  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias + b * p.sb_b;
  for (int i = tid; i < BT * BT; i += NTHREADS) {
    const int rr = i / BT, c = i % BT;
    const int t = q0 + rr, key = k0 + c;
    Bs[rr * PS + c] = (t < p.tq && key < p.tk) ? bias[t * p.sb_t + key] : 0.f;
  }
  for (int c = tid; c < BT; c += NTHREADS)
    KBs[c] = (kb && k0 + c < p.tk) ? kb[k0 + c] : 0.f;

  const int row = q0 + r;
  float acc[NS], s[NS], dp[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) acc[j] = 0.f;

  // a head wider than D: S and dP summed over its D-wide slices, each
  // loaded in turn into the same tiles (db2 has no width output)
  const int nsl = slices<D>(p.d);
  for (int h = 0; h < p.H; ++h) {
    const int hk = h / grp;
    const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
    const T* dout = static_cast<const T*>(p.dout) + b * p.sdo_b + h * p.sdo_h;
    const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
    const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
    const int64_t hrow = (static_cast<int64_t>(b) * p.H + h) * p.tq;
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
    for (int sc = 0; sc < nsl; ++sc) {
      __syncthreads();                 // the last head's or slice's tiles
      const int dw = p.d - sc * D;     // are consumed
      load_tile_f32<T, D, BT>(Qs, q + sc * D, p.sq_t, q0, p.tq, dw);
      load_tile_f32<T, D, BT>(dOs, dout + sc * D, p.sdo_t, q0, p.tq, dw);
      load_tile_f32<T, D, BT>(Ks, k + sc * D, p.sk_t, k0, p.tk, dw);
      load_tile_f32<T, D, BT>(Vs, v + sc * D, p.sv_t, k0, p.tk, dw);
      if (sc == 0) {
        for (int i = tid; i < BT; i += NTHREADS) {
          const bool in = q0 + i < p.tq;
          Ls[i] = in ? p.lse[hrow + q0 + i] : 0.f;
          Dl[i] = in ? p.delta[hrow + q0 + i] : 0.f;
        }
      }
      __syncthreads();

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
  for (int i = tid; i < BT * BT; i += NTHREADS) {
    const int rr = i / BT, c = i % BT;
    if (q0 + rr < p.tq && k0 + c < p.tk)
      out[static_cast<int64_t>(rr) * p.tk + c] = Bs[rr * PS + c];
  }
}

// -- bf16 / fp16 up to width 128: tensor cores --------------------------------

constexpr int TC_BQ = 64;           // query rows per tile
constexpr int TC_BK = 64;           // keys per tile
constexpr int TC_THREADS = 128;     // 4 warps, 16 rows (dQ) or keys (dK/dV)
constexpr int LDB_Q = TC_BK + 8;    // dQ's bias row: float2 reads by row
constexpr int LDB_K = TC_BK + 4;    // dK/dV's: scalar reads down a column

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
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

// The fragment addresses of a [rows][LDS] tile (lane = this lane):
//  A operand, rows r0.. r0 + 15, k-step kk;
__device__ __forceinline__ int a_off(int r0, int kk, int lane, int lds) {
  return (r0 + (lane & 15)) * lds + kk * 16 + (lane >> 4) * 8;
}
//  the column operand of A B^T (B stored [n][k]), n-tiles 2 np and
//  2 np + 1 from row r0, k-step kk (ldmatrix);
__device__ __forceinline__ int b_off(int r0, int np, int kk, int lane,
                                     int lds) {
  return (r0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * lds + kk * 16 +
         ((lane >> 3) & 1) * 8;
}
//  the row-major operand of A B (B stored [k][n]), k-step kk from row r0,
//  n-tiles 2 np and 2 np + 1 (ldmatrix.trans).
__device__ __forceinline__ int bt_off(int r0, int kk, int np, int lane,
                                      int lds) {
  return (r0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lds + np * 16 +
         (lane >> 4) * 8;
}

// A fragment of the 16 x 16 block kk of a [16][8 n] accumulator tile
// (columns 16 kk .. 16 kk + 15), rounded to T.
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       float (&c)[N][4], int kk) {
  a[0] = pack2<T>(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2<T>(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2<T>(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc += part in IEEE fp32: the tensor cores truncate inside a sum, so
// an accumulator carried through every tile of a long loop drifts by
// more than fp32 summation does; each tile's products sum in a fresh
// `part`, added here.
__device__ __forceinline__ void add_tile(float (&acc)[4],
                                         const float (&part)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] += part[r];
}

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

// The [TC_BQ, TC_BK] block of the fp32 [T, S] bias at (q0, k0) into a
// [TC_BQ][LDB] tile, 16-byte cp.async copies when `bvec`; zero outside.
template <int LDB>
__device__ __forceinline__ void load_bias(float* dst, const float* bias,
                                          int64_t st, int q0, int k0, int tq,
                                          int tk, bool bvec) {
  for (int i = threadIdx.x; i < TC_BQ * (TC_BK / 4); i += TC_THREADS) {
    const int r = i / (TC_BK / 4), c = (i % (TC_BK / 4)) * 4;
    const int t = q0 + r, key = k0 + c;
    float* s = dst + r * LDB + c;
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

// Write a warp's 16 x D fp32 accumulators, rounded to T, to rows
// [row0, row0 + 16) of `out` (row stride `st`): staged through the
// warp's own 16 rows `stage` of a [*][D + 8] tile, then 16-byte stores
// when `vec`.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, int64_t st, int row0,
                                           int n, int d, bool vec,
                                           T* stage,
                                           float (&acc)[D / 8][4]) {
  constexpr int LDS = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  __syncwarp();                        // the warp's reads of `stage` done
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * hh) * LDS + n8 * 8 +
                                   2 * t4) =
          pack2<T>(acc[n8][2 * hh], acc[n8][2 * hh + 1]);
  __syncwarp();
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = row0 + r;
    if (row >= n || c >= d) continue;
    T* dst = out + row * st + c;
    const T* src = stage + r * LDS + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int jj = 0; jj < 8 && c + jj < d; ++jj) dst[jj] = src[jj];
    }
  }
}

// dQ: a block is 4 warps, each owning 16 query rows.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_mma_kernel(const BwdParams p, const int vec, const int bvec) {
  constexpr int LDS = D + 8;       // padded row: conflict-free ldmatrix
  constexpr int KD = D / 16;       // k-steps of S = Q K^T and dP = dO V^T
  constexpr int NS = TC_BK / 8;    // 8-key n-tiles of S
  constexpr int NO = D / 8;        // 8-column n-tiles of dQ
  constexpr bool KEEP = D <= 32;   // Q and dO fragments kept in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BQ][LDS], later dQ
  T* dOs = Qs + TC_BQ * LDS;                // [BQ][LDS]
  T* Ks = dOs + TC_BQ * LDS;                // [2][BK][LDS]
  T* Vs = Ks + 2 * TC_BK * LDS;             // [2][BK][LDS]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TC_BK * LDS);
                                            // [2][BQ][LDB_Q] with a bias

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;   // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);

  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* dout = static_cast<const T*>(p.dout) + b * p.sdo_b + h * p.sdo_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;

  const int q_last = min(q0 + TC_BQ, p.tq) - 1;
  int k_begin = 0, k_end = p.tk;
  if (p.causal) {                  // skip tiles outside the band
    k_end = min(p.tk, p.q_offset + q_last + 1);
    if (p.window > 0) k_begin = max(0, p.q_offset + q0 - p.window + 1);
  }
  k_begin = (k_begin / TC_BK) * TC_BK;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + TC_BK - 1) / TC_BK : 0;

  load_tile<T, D, TC_BQ>(Qs, q, p.sq_t, q0, p.tq, p.d, vec);
  load_tile<T, D, TC_BQ>(dOs, dout, p.sdo_t, q0, p.tq, p.d, vec);
  if (n_tiles > 0) {
    load_tile<T, D, TC_BK>(Ks, k, p.sk_t, k_begin, p.tk, p.d, vec);
    load_tile<T, D, TC_BK>(Vs, v, p.sv_t, k_begin, p.tk, p.d, vec);
    if (bias)
      load_bias<LDB_Q>(Bs, bias, p.sb_t, q0, k_begin, p.tq, p.tk, bvec);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int wrow = warp * 16;
  uint32_t qf[KEEP ? KD : 1][4], df[KEEP ? KD : 1][4];
  if constexpr (KEEP) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldsm_x4(qf[kk], Qs + a_off(wrow, kk, lane, LDS));
      ldsm_x4(df[kk], dOs + a_off(wrow, kk, lane, LDS));
    }
  }

  // this thread's rows g and g + 8 of the warp: lse and delta
  const int row0 = q0 + wrow + g;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int64_t ix = (static_cast<int64_t>(b) * p.H + h) * p.tq + row;
    lse_r[i] = row < p.tq ? p.lse[ix] : 0.f;
    dl_r[i] = row < p.tq ? p.delta[ix] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * TC_BK;
    const int buf = j & 1;
    if (j > 0) {
      cp_async_wait_all();             // tile j has landed
      __syncthreads();                 // and tile j - 1 is consumed
    }
    if (j + 1 < n_tiles) {             // tile j + 1 loads under the math
      load_tile<T, D, TC_BK>(Ks + (buf ^ 1) * TC_BK * LDS, k, p.sk_t,
                             k0 + TC_BK, p.tk, p.d, vec);
      load_tile<T, D, TC_BK>(Vs + (buf ^ 1) * TC_BK * LDS, v, p.sv_t,
                             k0 + TC_BK, p.tk, p.d, vec);
      if (bias)
        load_bias<LDB_Q>(Bs + (buf ^ 1) * TC_BQ * LDB_Q, bias, p.sb_t, q0,
                         k0 + TC_BK, p.tq, p.tk, bvec);
    }
    cp_async_commit();
    const T* Kb = Ks + buf * TC_BK * LDS;
    const T* Vb = Vs + buf * TC_BK * LDS;
    const float* Bb = Bs + (buf * TC_BQ + wrow + g) * LDB_Q + 2 * t4;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = dp[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ad[4];
      if constexpr (KEEP) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq[i] = qf[kk][i];
          ad[i] = df[kk][i];
        }
      } else {
        ldsm_x4(aq, Qs + a_off(wrow, kk, lane, LDS));
        ldsm_x4(ad, dOs + a_off(wrow, kk, lane, LDS));
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, Kb + b_off(0, np, kk, lane, LDS));
        mma16816<T>(s[2 * np], aq, kf[0], kf[1]);
        mma16816<T>(s[2 * np + 1], aq, kf[2], kf[3]);
        ldsm_x4(vf, Vb + b_off(0, np, kk, lane, LDS));
        mma16816<T>(dp[2 * np], ad, vf[0], vf[1]);
        mma16816<T>(dp[2 * np + 1], ad, vf[2], vf[3]);
      }
    }

    // p and ds in place of s; element (n, r) is row g + 8 (r >> 1) of
    // the warp, key n * 8 + 2 t4 + (r & 1)
    const bool edge =
        k0 + TC_BK > p.tk || q0 + TC_BQ > p.tq ||
        (p.causal && (k0 + TC_BK - 1 > p.q_offset + q0 ||
                      (p.window > 0 && p.q_offset + q_last - k0 >= p.window)));
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
              Bb + 8 * hh * LDB_Q + n * 8);
          add[2 * hh] += bb.x;
          add[2 * hh + 1] += bb.y;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = fmaf(s[n][r], p.sm_scale, add[r]);
        float pr = __expf(x - lse_r[r >> 1]);
        if (edge && !visible(p, row0 + 8 * (r >> 1), key0 + (r & 1)))
          pr = 0.f;
        s[n][r] = pr * (dp[n][r] - dl_r[r >> 1]) * p.sm_scale;
      }
    }

    // dQ += dS K, ds rounded to k's dtype as it is packed; the tile's
    // 64 keys sum in a fresh accumulator, added to dQ in fp32
    uint32_t a[NS / 2][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) pack_a<T, NS>(a[kk], s, kk);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      float part[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t kf[4];
        ldsm_x4_t(kf, Kb + bt_off(0, kk, np, lane, LDS));
        mma16816<T>(part[0], a[kk], kf[0], kf[1]);
        mma16816<T>(part[1], a[kk], kf[2], kf[3]);
      }
      add_tile(acc[2 * np], part[0]);
      add_tile(acc[2 * np + 1], part[1]);
    }
  }

  // the warp's own Q rows are read by it alone: they stage its dQ
  store_rows<T, D>(static_cast<T*>(p.dq) + b * p.sdq_b + h * p.sdq_h,
                   p.sdq_t, q0 + wrow, p.tq, p.d, vec, Qs + wrow * LDS, acc);
}

// dK/dV: a block is 4 warps, each owning 16 keys.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkv_mma_kernel(const BwdParams p, const int vec, const int bvec) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;       // k-steps of S^T = K Q^T, dP^T = V dO^T
  constexpr int NO = D / 8;        // 8-column n-tiles of dK and dV
  constexpr bool KEEP = D <= 64;   // K and V fragments kept in registers
  // query columns a pass, the fastest measured without a spill (at 128
  // the dK and dV accumulators take 128 registers a thread)
  constexpr int QC = D == 128 ? 16 : D == 64 ? 64 : 32;
  constexpr int NS = QC / 8;       // 8-row n-tiles of S^T a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [BK][LDS], later dK
  T* Vs = Ks + TC_BK * LDS;                 // [BK][LDS], later dV
  T* Qs = Vs + TC_BK * LDS;                 // [2][BQ][LDS]
  T* dOs = Qs + 2 * TC_BQ * LDS;            // [2][BQ][LDS]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TC_BQ * LDS);  // [2][BQ]
  float* Dl = Ls + 2 * TC_BQ;                                   // [2][BQ]
  float* Bs = Dl + 2 * TC_BQ;        // [2][BQ][LDB_K] with a bias

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * TC_BK;   // key tile 0 (most queries) first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int grp = p.H / p.Hkv;

  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;

  // the query rows that see any key of this tile (JAX `_qc`)
  int q_begin = 0, q_end = p.tq;
  if (p.causal) {
    q_begin = max(0, k0 - p.q_offset);
    if (p.window > 0)
      q_end = min(p.tq, k0 + TC_BK - 1 + p.window - p.q_offset);
  }
  q_begin = (q_begin / TC_BQ) * TC_BQ;
  const int n_qt = q_end > q_begin ? (q_end - q_begin + TC_BQ - 1) / TC_BQ
                                   : 0;
  const int n_it = grp * n_qt;       // (query head, query tile) pairs

  // iteration `it`'s Q, dO, lse, delta and bias tiles into buffer `bf`
  auto load_q = [&](int it, int bf) {
    const int hq = hk * grp + it / n_qt;
    const int q0 = q_begin + (it % n_qt) * TC_BQ;
    load_tile<T, D, TC_BQ>(
        Qs + bf * TC_BQ * LDS,
        static_cast<const T*>(p.q) + b * p.sq_b + hq * p.sq_h, p.sq_t, q0,
        p.tq, p.d, vec);
    load_tile<T, D, TC_BQ>(
        dOs + bf * TC_BQ * LDS,
        static_cast<const T*>(p.dout) + b * p.sdo_b + hq * p.sdo_h, p.sdo_t,
        q0, p.tq, p.d, vec);
    const int64_t hrow = (static_cast<int64_t>(b) * p.H + hq) * p.tq;
    for (int i = tid; i < TC_BQ; i += TC_THREADS) {
      const bool ok = q0 + i < p.tq;
      cp_async4(Ls + bf * TC_BQ + i, ok ? p.lse + hrow + q0 + i : p.lse, ok);
      cp_async4(Dl + bf * TC_BQ + i, ok ? p.delta + hrow + q0 + i : p.delta,
                ok);
    }
    if (bias)
      load_bias<LDB_K>(Bs + bf * TC_BQ * LDB_K, bias, p.sb_t, q0, k0, p.tq,
                       p.tk, bvec);
  };

  load_tile<T, D, TC_BK>(Ks, k, p.sk_t, k0, p.tk, p.d, vec);
  load_tile<T, D, TC_BK>(Vs, v, p.sv_t, k0, p.tk, p.d, vec);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int wrow = warp * 16;
  uint32_t kf[KEEP ? KD : 1][4], vf[KEEP ? KD : 1][4];
  if constexpr (KEEP) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldsm_x4(kf[kk], Ks + a_off(wrow, kk, lane, LDS));
      ldsm_x4(vf[kk], Vs + a_off(wrow, kk, lane, LDS));
    }
  }
  // this thread's keys g and g + 8 of the warp, and their key bias
  const int key0 = k0 + wrow + g;
  float kbv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kbv[i] = (kb != nullptr && key0 + 8 * i < p.tk) ? kb[key0 + 8 * i] : 0.f;

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_k[n][r] = acc_v[n][r] = 0.f;
  float db[2] = {0.f, 0.f};          // this head's key-bias partial sums

  for (int it = 0; it < n_it; ++it) {
    const int qt = it % n_qt;
    const int q0 = q_begin + qt * TC_BQ;
    const int buf = it & 1;
    if (it > 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    if (it + 1 < n_it) load_q(it + 1, buf ^ 1);
    cp_async_commit();
    const T* Qb = Qs + buf * TC_BQ * LDS;
    const T* dOb = dOs + buf * TC_BQ * LDS;
    const float* Lb = Ls + buf * TC_BQ;
    const float* Db = Dl + buf * TC_BQ;
    const float* Bb = Bs + buf * TC_BQ * LDB_K + wrow + g;
    const bool edge =
        q0 + TC_BQ > p.tq || k0 + TC_BK > p.tk ||
        (p.causal &&
         (k0 + TC_BK - 1 > p.q_offset + q0 ||
          (p.window > 0 && p.q_offset + q0 + TC_BQ - 1 - k0 >= p.window)));

#pragma unroll 1                       // one pass's registers at a time
    for (int c0 = 0; c0 < TC_BQ; c0 += QC) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x QC query rows per warp
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[n][r] = dp[n][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4];
        if constexpr (KEEP) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i] = kf[kk][i];
            av[i] = vf[kk][i];
          }
        } else {
          ldsm_x4(ak, Ks + a_off(wrow, kk, lane, LDS));
          ldsm_x4(av, Vs + a_off(wrow, kk, lane, LDS));
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t qf[4], of[4];
          ldsm_x4(qf, Qb + b_off(c0, np, kk, lane, LDS));
          mma16816<T>(s[2 * np], ak, qf[0], qf[1]);
          mma16816<T>(s[2 * np + 1], ak, qf[2], qf[3]);
          ldsm_x4(of, dOb + b_off(c0, np, kk, lane, LDS));
          mma16816<T>(dp[2 * np], av, of[0], of[1]);
          mma16816<T>(dp[2 * np + 1], av, of[2], of[3]);
        }
      }

      // p in place of s, ds in place of dp; element (n, r) is key
      // g + 8 (r >> 1) of the warp, query row c0 + n * 8 + 2 t4 + (r & 1)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int col0 = c0 + n * 8 + 2 * t4;
        const float2 lse2 = *reinterpret_cast<const float2*>(Lb + col0);
        const float2 dl2 = *reinterpret_cast<const float2*>(Db + col0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = col0 + (r & 1);
          float x = fmaf(s[n][r], p.sm_scale, kbv[r >> 1]);
          if (bias != nullptr) x += Bb[col * LDB_K + 8 * (r >> 1)];
          float pr = __expf(x - ((r & 1) ? lse2.y : lse2.x));
          if (edge && !visible(p, q0 + col, key0 + 8 * (r >> 1))) pr = 0.f;
          const float ds =
              pr * (dp[n][r] - ((r & 1) ? dl2.y : dl2.x)) * p.sm_scale;
          db[r >> 1] += ds;
          s[n][r] = pr;
          dp[n][r] = ds;
        }
      }

      // dV += P^T dO and dK += dS^T Q, p rounded to dO's dtype and ds to
      // q's as they are packed; the pass's QC rows sum in fresh
      // accumulators, added to dK and dV in fp32
      uint32_t ap[NS / 2][4], ads[NS / 2][4];
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        pack_a<T, NS>(ap[kk], s, kk);
        pack_a<T, NS>(ads[kk], dp, kk);
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        float pv[2][4] = {}, pk[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          uint32_t of[4], qf[4];
          ldsm_x4_t(of, dOb + bt_off(c0, kk, np, lane, LDS));
          mma16816<T>(pv[0], ap[kk], of[0], of[1]);
          mma16816<T>(pv[1], ap[kk], of[2], of[3]);
          ldsm_x4_t(qf, Qb + bt_off(c0, kk, np, lane, LDS));
          mma16816<T>(pk[0], ads[kk], qf[0], qf[1]);
          mma16816<T>(pk[1], ads[kk], qf[2], qf[3]);
        }
        add_tile(acc_v[2 * np], pv[0]);
        add_tile(acc_v[2 * np + 1], pv[1]);
        add_tile(acc_k[2 * np], pk[0]);
        add_tile(acc_k[2 * np + 1], pk[1]);
      }
    }

    if (qt == n_qt - 1) {              // this query head is done
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        db[i] += __shfl_xor_sync(0xffffffffu, db[i], 1);
        db[i] += __shfl_xor_sync(0xffffffffu, db[i], 2);
      }
      if (p.dkbias != nullptr && t4 == 0) {
        const int hq = hk * grp + it / n_qt;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (key0 + 8 * i < p.tk)
            p.dkbias[(static_cast<int64_t>(b) * p.H + hq) * p.tk + key0 +
                     8 * i] = db[i];
      }
      db[0] = db[1] = 0.f;
    }
  }
  if (n_it == 0 && p.dkbias != nullptr) {   // no query sees these keys
    for (int i = tid; i < grp * TC_BK; i += TC_THREADS) {
      const int key = k0 + i % TC_BK;
      if (key < p.tk)
        p.dkbias[(static_cast<int64_t>(b) * p.H + hk * grp + i / TC_BK) *
                     p.tk + key] = 0.f;
    }
  }

  // the warp's own K and V rows are read by it alone: they stage dK, dV
  store_rows<T, D>(static_cast<T*>(p.dk) + b * p.sdk_b + hk * p.sdk_h,
                   p.sdk_t, k0 + wrow, p.tk, p.d, vec, Ks + wrow * LDS,
                   acc_k);
  store_rows<T, D>(static_cast<T*>(p.dv) + b * p.sdv_b + hk * p.sdv_h,
                   p.sdv_t, k0 + wrow, p.tk, p.d, vec, Vs + wrow * LDS,
                   acc_v);
}

// db2 on tensor cores: a block is 4 warps, each owning 16 query rows of
// one (b, 64-row query tile, 64-key tile) of the fp32 output; it loops
// over the H query heads (head h + 1's Q, dO, K and V come in by
// cp.async while head h computes), S = Q K^T and dP = dO V^T by
// mma.sync as dQ computes them, ds in fp32 in the accumulator layout,
// unrounded, summed over heads in registers.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_db2_mma_kernel(const BwdParams p, const int vec, const int bvec) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;       // k-steps of S and dP
  constexpr int NS = TC_BK / 8;    // 8-key n-tiles of S
  constexpr int TILE = TC_BQ * LDS;
  static_assert(TC_BQ == TC_BK && NS * 4 == 32, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);   // [2][Q, dO, K, V][64][LDS]
  float* Bs = reinterpret_cast<float*>(tiles + 8 * TILE);  // [BQ][LDB_Q]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * TC_BK, q0 = blockIdx.y * TC_BQ;
  const int b = blockIdx.z;
  const int grp = p.H / p.Hkv;
  float* out = p.dbias + (static_cast<int64_t>(b) * p.tq + q0) * p.tk + k0;
  const int q_last = min(q0 + TC_BQ, p.tq) - 1;

  // a tile no query row of which sees any of its keys: zeros
  if (p.causal) {
    const int k_last = min(k0 + TC_BK, p.tk) - 1;
    if (k0 > p.q_offset + q_last ||
        (p.window > 0 && p.q_offset + q0 - k_last >= p.window)) {
      for (int i = tid; i < TC_BQ * TC_BK; i += TC_THREADS) {
        const int rr = i / TC_BK, c = i % TC_BK;
        if (q0 + rr < p.tq && k0 + c < p.tk)
          out[static_cast<int64_t>(rr) * p.tk + c] = 0.f;
      }
      return;
    }
  }

  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  auto load_head = [&](int h, int buf) {
    const int hk = h / grp;
    T* base = tiles + buf * 4 * TILE;
    load_tile<T, D, TC_BQ>(
        base, static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h, p.sq_t,
        q0, p.tq, p.d, vec);
    load_tile<T, D, TC_BQ>(
        base + TILE,
        static_cast<const T*>(p.dout) + b * p.sdo_b + h * p.sdo_h, p.sdo_t,
        q0, p.tq, p.d, vec);
    load_tile<T, D, TC_BK>(
        base + 2 * TILE,
        static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h, p.sk_t, k0,
        p.tk, p.d, vec);
    load_tile<T, D, TC_BK>(
        base + 3 * TILE,
        static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h, p.sv_t, k0,
        p.tk, p.d, vec);
  };
  load_bias<LDB_Q>(Bs, p.bias + b * p.sb_b, p.sb_t, q0, k0, p.tq, p.tk,
                   bvec);
  load_head(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the additive terms and the band, once: element (n, r) is row
  // g + 8 (r >> 1) of the warp, key n * 8 + 2 t4 + (r & 1)
  const int wrow = warp * 16;
  const int row0 = q0 + wrow + g;
  const bool edge =
      k0 + TC_BK > p.tk || q0 + TC_BQ > p.tq ||
      (p.causal && (k0 + TC_BK - 1 > p.q_offset + q0 ||
                    (p.window > 0 && p.q_offset + q_last - k0 >= p.window)));
  float add[NS][4];
  uint32_t vis = 0xffffffffu;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int key0 = k0 + n * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = key0 + (r & 1), hh = r >> 1;
      add[n][r] = (kb != nullptr && key < p.tk ? kb[key] : 0.f) +
                  Bs[(wrow + g + 8 * hh) * LDB_Q + n * 8 + 2 * t4 + (r & 1)];
      if (edge && !visible(p, row0 + 8 * hh, key)) vis &= ~(1u << (n * 4 + r));
    }
  }

  float acc[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

  for (int h = 0; h < p.H; ++h) {
    const int buf = h & 1;
    if (h > 0) {
      cp_async_wait_all();             // head h has landed
      __syncthreads();                 // and head h - 1 is consumed
    }
    if (h + 1 < p.H) load_head(h + 1, buf ^ 1);
    cp_async_commit();
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const int64_t ix = (static_cast<int64_t>(b) * p.H + h) * p.tq + row;
      lse_r[i] = row < p.tq ? p.lse[ix] : 0.f;
      dl_r[i] = row < p.tq ? p.delta[ix] : 0.f;
    }
    const T* Qs = tiles + buf * 4 * TILE;
    const T* dOs = Qs + TILE;
    const T* Ks = Qs + 2 * TILE;
    const T* Vs = Qs + 3 * TILE;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = dp[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ad[4];
      ldsm_x4(aq, Qs + a_off(wrow, kk, lane, LDS));
      ldsm_x4(ad, dOs + a_off(wrow, kk, lane, LDS));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, Ks + b_off(0, np, kk, lane, LDS));
        mma16816<T>(s[2 * np], aq, kf[0], kf[1]);
        mma16816<T>(s[2 * np + 1], aq, kf[2], kf[3]);
        ldsm_x4(vf, Vs + b_off(0, np, kk, lane, LDS));
        mma16816<T>(dp[2 * np], ad, vf[0], vf[1]);
        mma16816<T>(dp[2 * np + 1], ad, vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = fmaf(s[n][r], p.sm_scale, add[n][r]);
        const float pr = (vis >> (n * 4 + r)) & 1u
                             ? __expf(x - lse_r[r >> 1]) : 0.f;
        acc[n][r] += pr * (dp[n][r] - dl_r[r >> 1]) * p.sm_scale;
      }
  }

  // stage the tile through shared memory for coalesced stores
  __syncthreads();
  const float inv_scale = 1.0f / p.sm_scale;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      Bs[(wrow + g + 8 * (r >> 1)) * LDB_Q + n * 8 + 2 * t4 + (r & 1)] =
          acc[n][r] * inv_scale;
  __syncthreads();
  for (int i = tid; i < TC_BQ * TC_BK; i += TC_THREADS) {
    const int rr = i / TC_BK, c = i % TC_BK;
    if (q0 + rr < p.tq && k0 + c < p.tk)
      out[static_cast<int64_t>(rr) * p.tk + c] = Bs[rr * LDB_Q + c];
  }
}

// -- launchers -----------------------------------------------------------------

// 1 when every operand row and output row starts on a 16-byte boundary
// and d is a multiple of 8 (2-byte types): the 16-byte copies apply.
bool rows16(const void* ptr, int64_t sb, int64_t st, int64_t sh) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
                            sb % 8 == 0 && st % 8 == 0 && sh % 8 == 0);
}

int vec16(const BwdParams& p) {
  return p.d % 8 == 0 && rows16(p.q, p.sq_b, p.sq_t, p.sq_h) &&
         rows16(p.k, p.sk_b, p.sk_t, p.sk_h) &&
         rows16(p.v, p.sv_b, p.sv_t, p.sv_h) &&
         rows16(p.dout, p.sdo_b, p.sdo_t, p.sdo_h) &&
         rows16(p.dq, p.sdq_b, p.sdq_t, p.sdq_h) &&
         rows16(p.dk, p.sdk_b, p.sdk_t, p.sdk_h) &&
         rows16(p.dv, p.sdv_b, p.sdv_t, p.sdv_h);
}

// 1 when the fp32 [B, T, S] bias takes 16-byte copies
int bias_vec(const BwdParams& p) {
  return p.bias != nullptr && p.tk % 4 == 0 && p.sb_b % 4 == 0 &&
         p.sb_t % 4 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 16 == 0;
}

// Each launcher opts in to more than 48 KB of shared memory once per
// instantiation (and not again while a CUDA graph is being captured).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
cudaError_t launch_dq_mma(const BwdParams& p, cudaStream_t st) {
  constexpr int base = (2 * TC_BQ + 4 * TC_BK) * (D + 8) * sizeof(T);
  constexpr int with_bias = base + 2 * TC_BQ * LDB_Q * sizeof(float);
  auto kernel = flash_bwd_dq_mma_kernel<T, D>;
  static const cudaError_t configured = allow_smem(kernel, with_bias);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tq + TC_BQ - 1) / TC_BQ, p.H, p.B);
  kernel<<<grid, TC_THREADS, p.bias ? with_bias : base, st>>>(p, vec16(p),
                                                             bias_vec(p));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_mma(const BwdParams& p, cudaStream_t st) {
  constexpr int base = (2 * TC_BK + 4 * TC_BQ) * (D + 8) * sizeof(T) +
                       4 * TC_BQ * sizeof(float);
  constexpr int with_bias = base + 2 * TC_BQ * LDB_K * sizeof(float);
  auto kernel = flash_bwd_dkv_mma_kernel<T, D>;
  static const cudaError_t configured = allow_smem(kernel, with_bias);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tk + TC_BK - 1) / TC_BK, p.Hkv, p.B);
  kernel<<<grid, TC_THREADS, p.bias ? with_bias : base, st>>>(p, vec16(p),
                                                             bias_vec(p));
  return cudaGetLastError();
}

template <typename T, int D, int BT>
cudaError_t launch_dq_simt(const BwdParams& p, cudaStream_t st) {
  constexpr int smem = sizeof(float) * dq_floats(D, BT);
  auto kernel = flash_bwd_dq_simt_kernel<T, D, BT>;
  static const cudaError_t configured = allow_smem(kernel, smem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tq + BT - 1) / BT, p.H * slices<D>(p.d), p.B);
  kernel<<<grid, NTHREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, int BT>
cudaError_t launch_dkv_simt(const BwdParams& p, cudaStream_t st) {
  constexpr int smem = sizeof(float) * dkv_floats(D, BT);
  auto kernel = flash_bwd_dkv_simt_kernel<T, D, BT>;
  static const cudaError_t configured = allow_smem(kernel, smem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tk + BT - 1) / BT, p.Hkv * slices<D>(p.d), p.B);
  kernel<<<grid, NTHREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_db2_mma(const BwdParams& p, cudaStream_t st) {
  constexpr int smem = 8 * TC_BQ * (D + 8) * sizeof(T) +
                       TC_BQ * LDB_Q * sizeof(float);
  auto kernel = flash_bwd_db2_mma_kernel<T, D>;
  static const cudaError_t configured = allow_smem(kernel, smem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tk + TC_BK - 1) / TC_BK, (p.tq + TC_BQ - 1) / TC_BQ,
                  p.B);
  kernel<<<grid, TC_THREADS, smem, st>>>(p, vec16(p), bias_vec(p));
  return cudaGetLastError();
}

template <typename T, int D, int BT>
cudaError_t launch_db2(const BwdParams& p, cudaStream_t stream) {
  constexpr int smem = sizeof(float) * db2_floats(D, BT);
  auto kernel = flash_bwd_db2_kernel<T, D, BT>;
  static const cudaError_t configured = allow_smem(kernel, smem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tk + BT - 1) / BT, (p.tq + BT - 1) / BT, p.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

enum class Which { kDq, kDkv, kDb2 };

// The kernel a (dtype, width) takes: tensor cores for bf16 / fp16 up to
// width 128 (dQ, dK/dV and db2), SIMT otherwise, with 32-row tiles at
// width 256.
template <typename T, int D>
cudaError_t launch(const BwdParams& p, Which which, cudaStream_t st) {
  constexpr bool kTensorCores = !std::is_same<T, float>::value && D <= 128;
  constexpr int BT = D > 128 ? 32 : 64;
  switch (which) {
    case Which::kDq:
      if constexpr (kTensorCores) return launch_dq_mma<T, D>(p, st);
      else return launch_dq_simt<T, D, BT>(p, st);
    case Which::kDkv:
      if constexpr (kTensorCores) return launch_dkv_mma<T, D>(p, st);
      else return launch_dkv_simt<T, D, BT>(p, st);
    case Which::kDb2:
      if constexpr (kTensorCores) return launch_db2_mma<T, D>(p, st);
      else return launch_db2<T, D, BT>(p, st);
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
    case 256: return launch<T, 256>(p, which, st);
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
// success).  head_dim is the instantiated width (16/32/64/128/256,
// >= p->d, or 256 for any wider p->d, taken in slices); dtype 0 fp32, 1
// bf16, 2 fp16.
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
