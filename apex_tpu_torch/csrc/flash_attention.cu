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
//           q_offset + t - key < window); hidden keys are NEG_INF and get
//           p = 0, as the Pallas kernel's `jnp.where(mask, p, 0)`
//   out = sum_key p * v / l,  lse = m + log(l);  l == 0 -> out 0, lse NEG_INF
// with (m, l, acc) carried in fp32 across KV tiles.  For bf16 inputs p is
// rounded to bf16 before the PV product, as the TPU kernel casts p to the
// value dtype; fp32 inputs are computed in full fp32.  GQA reads KV head
// h / (H / H_kv) directly: nothing is repeated.
//
// What bounds it on the H100: at the serving shapes it is memory-bound at
// decode (one query row against a long cache: every K/V byte is used
// once) and, as written here, bound by shared-memory bandwidth at
// prefill: the scores and the PV product are plain fp32 FMA loops over
// shared-memory tiles, one shared-memory load per FMA.  This is the
// simple first kernel: tensor cores (wgmma), TMA and split-KV decoding
// are later work.
//
// Design:
//  * grid (query tiles, heads, batch); 128 threads; a Q tile of BQ rows
//    stays in shared memory while the block loops over KV tiles of 64
//    keys.  BQ is 64, 16 or 4 (chosen by the wrapper from q_len), and
//    128 / BQ threads share one query row, so a decode call (q_len = 1)
//    still spreads each row over a whole warp;
//  * KV tiles wholly outside the causal or sliding-window band of the Q
//    tile are never loaded (loop bounds), the rest are masked per element
//    on global positions (q_offset + row against key);
//  * ragged edges are masked, so any q_len / kv_len works;
//  * q, k, v and out are read through their strides in the [B, T, H, D]
//    layout, so the wrapper makes no transposed copies;
//  * shared-memory rows are padded by one float so that the threads of a
//    warp, which sit on different rows, hit different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  int64_t sq_b, sq_t, sq_h;
  int64_t sk_b, sk_t, sk_h;
  int64_t sv_b, sv_t, sv_h;
  int64_t so_b, so_t, so_h;
  int64_t skb_b;
  int64_t sb_b, sb_t;
  int32_t B, H, Hkv, tq, tk;
  int32_t causal, q_offset, window;   // window 0 = none
  float sm_scale;
};

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;          // keys per KV tile
constexpr int NTHREADS = 128;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const Params p) {
  constexpr int TPR = NTHREADS / BQ;   // threads sharing one query row
  constexpr int NS = BK / TPR;         // score columns per thread
  constexpr int NA = D / TPR;          // output dims per thread
  constexpr int QS = D + 1;            // padded row strides (banks)
  constexpr int PS = BK + 1;
  static_assert(TPR <= 32 && NS <= 32 && NA >= 1, "tile shape");

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
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);

  const T* q = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int rr = i / D, d = i % D;
    const int t = q0 + rr;
    Qs[rr * QS + d] = t < p.tq ? to_f(q[t * p.sq_t + d]) : 0.f;
  }

  const int row = q0 + r;
  const int qpos = p.q_offset + row;   // global position of this row
  const int q_last = min(q0 + BQ, p.tq) - 1;
  int k_begin = 0, k_end = p.tk;
  if (p.causal) {                      // skip tiles outside the band
    k_end = min(p.tk, p.q_offset + q_last + 1);
    if (p.window > 0) k_begin = max(0, p.q_offset + q0 - p.window + 1);
  }
  k_begin = (k_begin / BK) * BK;

  float m = NEG_INF, l = 0.f;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float s[NS];

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                   // the previous tile is consumed
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int c = i / D, d = i % D;
      const int key = k0 + c;
      const bool in = key < p.tk;
      Ks[c * QS + d] = in ? to_f(k[key * p.sk_t + d]) : 0.f;
      Vs[c * D + d] = in ? to_f(v[key * p.sv_t + d]) : 0.f;
    }
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
      const int key = k0 + c;
      float x = s[j] * p.sm_scale;
      if (kb) x += KBs[c];
      if (bias) x += Bs[r * PS + c];
      bool ok = key < p.tk;
      if (p.causal) {
        ok = ok && key <= qpos;
        if (p.window > 0) ok = ok && qpos - key < p.window;
      }
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
      Ps[r * PS + j * TPR + lane] = to_f(from_f<T>(pj));   // p in v's dtype
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
    for (int i = 0; i < NA; ++i) o[i * TPR + lane] = from_f<T>(acc[i] / safe);
    if (lane == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.tq + row] =
          l == 0.f ? NEG_INF : m + logf(safe);
  }
}

template <typename T, int D, int BQ>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D
                                       + 2 * BQ * (BK + 1) + BK);
  auto kernel = flash_fwd_kernel<T, D, BQ>;
  // Opt in to more than 48 KB of shared memory once per instantiation
  // (and not again while a CUDA graph is being captured).
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (configured != cudaSuccess) return configured;
  const dim3 grid((p.tq + BQ - 1) / BQ, p.H, p.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_block(const Params& p, int block_q, cudaStream_t stream) {
  switch (block_q) {
    case 64: return launch<T, D, 64>(p, stream);
    case 16: return launch<T, D, 16>(p, stream);
    case 4: return launch<T, D, 4>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(const Params& p, int head_dim, int block_q,
                   cudaStream_t stream) {
  switch (head_dim) {
    case 32: return by_block<T, 32>(p, block_q, stream);
    case 64: return by_block<T, 64>(p, block_q, stream);
    case 128: return by_block<T, 128>(p, block_q, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Head dims 32/64/128, block_q 64/16/4; is_bf16 picks bf16 or fp32.
extern "C" int flash_attention_fwd(const Params* p, int head_dim,
                                   int block_q, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? by_dim<__nv_bfloat16>(*p, head_dim, block_q, st)
              : by_dim<float>(*p, head_dim, block_q, st);
  return static_cast<int>(err);
}
