// Flash-attention decode for Hopper (sm_90a) on a TMA ring, one launch a
// call, plain C interface.
//
// Replaces, for bf16 / fp16 decode (q_len < 16) at the instantiated head
// widths 64 and 128, the Pallas TPU kernel apex_tpu/ops/flash_attention.py
// `_fwd_kernel` (launched by `_flash_fwd_pallas`) on a short query block.
// It computes the function of flash_attention.cu's header, lines 8-25:
// the same scores, masks, biases, GQA heads, p rounded to the value dtype
// before the PV product, out 0 and lse NEG_INF for a row that sees no
// key, lse [B, H, T] fp32.  Its arithmetic is that of flash_attention.cu's
// split-KV kernels and of their plain version `_flash_fwd_split_ref`
// (apex_tpu_torch/ops/flash_attention.py): the keys in chunks of `chunk`
// from key 0, each chunk's fp32 (m_c, l_c, acc_c) with m_c the chunk's
// exact visible maximum, then the chunks merged in chunk order.  Those
// kernels (the `split` route) keep fp32, the other widths and views TMA
// cannot read.
//
// What bounds it on the H100: the K and V bytes.  Serving's decode step
// (B 8, 12 heads of 64, q_len 1) reads 2 x 1024 x 128 bytes a head and
// does ~1 FLOP a byte, so the card's 3.35 TB/s sets the time (0.0075 ms
// at 1,024 keys).  The split-KV kernel reached 0.35 of that: each
// 128-thread block loaded its chunk by synchronous 16-byte loads, ~2 KB in
// flight, where HBM wants ~20 KB or more an SM in flight to stream near
// its peak; its grid ran over query heads, so GQA read K and V once a
// query head; and a second kernel merged the chunks.  Here:
//  * The grid is (splits, Hkv x row blocks, B).  A block serves every
//    query row of its KV head, the H / Hkv query heads x q_len rows (up to
//    RMAX, 64 at width 64 and 32 at 128, and within SCORE_FLOATS scores a
//    chunk: more rows take more row blocks), so K and V are read once a
//    call, GQA included.
//  * One producer warp, of which one thread issues the loads: the
//    block's K tiles and then its V tiles, BK = 32 keys x the width a
//    tile, by TMA (`cp.async.bulk.tensor`) under `CUtensorMap`s of the
//    [B, L, Hkv, D] views (flash_sm90.cuh's map_bthd, through
//    sm90::map_nd's cache; `__grid_constant__`, so a CUDA graph holds
//    them) into a ring of RING_BYTES (32 KB: 8 stages at width 64, 4 at
//    128) under full / empty `mbarrier`s.  It sets up the
//    barriers and issues the first ring's loads before the block's first
//    sync.  Four blocks an SM keep up to 128 KB of loads in flight an SM.
//  * Four consumer warps take the ring 16 KB (a pass) at a time: one wait,
//    one pass whose loads and sums are independent across its tiles, one
//    release.  (A tile at a time, each pass's chain of dependent
//    instructions set the pace, not the bytes.)  They
//    form the scores of the whole chunk in shared memory from the K
//    stages (a key's four lanes a quarter of its row each, read in
//    16-byte pieces of the 128-byte swizzle, conflict-free; the query
//    rows in fp32 in shared memory, read as broadcasts), then the chunk's
//    (m_c, l_c) and p a warp a row, then acc_c = sum p v from the V stages
//    (a thread owns 8 columns of up to four rows over a subset of the
//    keys; the subsets summed in a fixed order).  FP32 FMA: at a few rows
//    a key the work is ~1 FLOP a byte, far under the card's FMA rate.
//  * One launch a call.  2 to MAX_CLUSTER chunks of a (batch, KV head,
//    row block) run as one thread block cluster: each block stores its
//    (acc_c, m_c, l_c) into the shared memory of the cluster's block of
//    rank 0 (distributed shared memory), and after the cluster's barrier
//    that block merges them in chunk order (the combine kernel's
//    arithmetic).  More chunks, or partials too large for that inbox,
//    write them to fp32 scratch, and the last block of the unit to
//    finish, found by an atomic ticket, merges them in chunk order.  The
//    ticket (g_tickets) returns to 0 within the call, so eager calls,
//    captured replays and later calls on another stream find it 0; two
//    calls running at once on two streams of one device must not share
//    it, and the port makes no such calls.  Either merge reads the chunks
//    in chunk order whichever block finished last, so the result is the
//    same bits every call.  A call of one chunk writes its output
//    directly.
//  * Chunks wholly outside the causal or sliding-window band load nothing
//    (their l_c is 0, as the plain version's).
// Chunks are multiples of BK up to MAX_CHUNK keys; the wrapper's rule
// (`_decode_split`) sizes them to about three blocks an SM.

#include <cuda.h>   // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"
#include "sm90.cuh"


// Field order and types mirror flash_attention.cu's Params and the ctypes
// Structure in apex_tpu_torch/ops/flash_attention.py (_FlashParams).
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* kbias;   // [B, S] fp32 or null
  const float* bias;    // [B, T, S] fp32 (last stride 1) or null
  void* out;
  float* lse;           // [B, H, T] fp32, contiguous
  float* part_o;        // more than one chunk: [units][splits][rows][D] fp32
  float* part_ml;       // and [units][splits][rows][2] fp32 (m, l)
  int64_t sq_b, sq_t, sq_h;
  int64_t sk_b, sk_t, sk_h;
  int64_t sv_b, sv_t, sv_h;
  int64_t so_b, so_t, so_h;
  int64_t skb_b;
  int64_t sb_b, sb_t;
  int32_t B, H, Hkv, tq, tk;
  int32_t causal, q_offset, window;   // window 0 = none
  int32_t d;            // the head width (<= the instantiated width)
  int32_t vec;
  int32_t splits, chunk;              // chunks of `chunk` keys from key 0
  int32_t bvec;
  float sm_scale;
};

// The tensor maps of one launch, passed by value as a __grid_constant__
// parameter (each CUtensorMap is 64-byte aligned).
struct Maps {
  CUtensorMap k, v;
};

// One ticket per (batch, KV head, row block) of a call; zero at load, and
// the last block of each unit sets it to 0 again.
constexpr int TICKETS = 1 << 18;
__device__ unsigned int g_tickets[TICKETS];

namespace {

using namespace sm90;
using namespace flash_sm90;

constexpr int BK = 32;               // keys a ring stage
// the K / V ring's bytes a block (48 and 64 KB measured slower: fewer
// blocks an SM), and the blocks an SM the registers are sized for
constexpr int RING_BYTES = 32768;
constexpr int MIN_BLOCKS = 4;
constexpr int CONSUMERS = 128;       // four warps
constexpr int THREADS = CONSUMERS + 32;
constexpr int MAX_CHUNK = 1024;
constexpr int SCORE_FLOATS = 8192;   // a block's scores: rows x chunk
constexpr int MAX_TQ = 16;           // decode takes q_len < 16
constexpr int MAX_CLUSTER = 8;       // chunks merged in a cluster

template <int D>
struct Dec {
  static constexpr int NP = D / PANEL;         // 64-wide panels a row
  static constexpr int STAGE_BYTES = BK * D * 2;
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;
  static constexpr int CPR = D / 8;            // 16-byte pieces a row
  static constexpr int NT = CONSUMERS / CPR;   // row x key-group slots
  static constexpr int RMAX = 4 * NT;          // four rows a thread
  static constexpr int GROUP = 16384 / STAGE_BYTES;   // tiles a pass
  static_assert(STAGES >= 2 * GROUP, "the ring holds two passes or more");
};

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// Whether the chunks of a unit merge within a cluster: 2 .. MAX_CLUSTER
// of them, their partials (each rows x D floats) within MERGE_FLOATS of
// the merging block's shared memory; else through the ticket
__host__ __device__ __forceinline__ bool cluster_merge(int splits, int rows,
                                                       int d) {
  return splits > 1 && splits <= MAX_CLUSTER && splits * rows * d <= 4096;
}

// the query rows one block takes at this chunk
template <int D>
__host__ __device__ __forceinline__ int rows_per_block(int chunk) {
  return imin(Dec<D>::RMAX, SCORE_FLOATS / chunk);
}

// Shared memory after the 1024-byte alignment of the base: the ring,
// then the fp32 query rows (each row four quarters of D / 4 columns, each
// quarter padded by 4 floats, so a warp's four quarters sit in distinct
// banks; later the PV sums of the key groups), the [rows][chunk]
// scores, the chunk's key-padding bias, each row's (m, l), each row's
// band (first and last visible key) and bias row, in a cluster merge the
// merging block's inbox of every chunk's (acc_c, m_c, l_c), the barriers
// and a flag.
template <int D>
struct Layout {
  static constexpr int QPAD = D / 4 + 4;       // a quarter's floats
  static constexpr int QROW = 4 * QPAD;        // a query row's floats
  int qr, sc, kb, ml, ri, mrg, bar, bytes;
  __host__ __device__ Layout(int rows, int chunk, bool cluster, int splits) {
    qr = Dec<D>::STAGES * Dec<D>::STAGE_BYTES;
    // the key groups' sums: NT groups of up to four rows, else one group
    // a slot of up to NT rows, else one of every row
    const int red = D * imax(rows, Dec<D>::NT * imin(rows, 4));
    sc = qr + imax(rows * QROW, red) * 4;
    kb = sc + rows * chunk * 4;
    ml = kb + chunk * 4;
    ri = ml + rows * 2 * 4;
    mrg = (ri + rows * 3 * 4 + 15) & ~15;
    const int merge = cluster ? splits * rows * (D + 2) : 0;
    bar = (mrg + merge * 4 + 7) & ~7;
    bytes = bar + 2 * Dec<D>::STAGES * 8 + 8 + 1024;
  }
};

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
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// the eight 16-bit values of 16 bytes to fp32, in order
template <typename T>
__device__ __forceinline__ void unpack8(const uint4 u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    } else {
      const __half2 h = *reinterpret_cast<const __half2*>(&w[j]);
      const float2 f = __half22float2(h);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  }
}

// -- thread block clusters ------------------------------------------------------

// every thread of the cluster: this block's writes to its shared memory
// before, the cluster's reads of it after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the two halves of a cluster barrier, apart: arrive (ordering nothing),
// and wait for every thread of the cluster to have arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the shared-memory address `addr` of this block in the block of the
// cluster whose rank is `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// the blocks of this block's cluster (1: launched without one)
__device__ __forceinline__ int cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

// 16 bytes of key row `r` of a ring stage: piece c (8 values) of the
// row, in panel c / 8, swizzled by the row (TMA's 128-byte swizzle)
__device__ __forceinline__ uint4 stage_piece(const unsigned char* stage,
                                             int r, int c) {
  return *reinterpret_cast<const uint4*>(stage + (c >> 3) * BK * 128 +
                                         swz(r, c & 7));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_decode_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = Dec<D>;
  using Q = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int group = p.H / p.Hkv;
  const int R = group * p.tq;                  // query rows of a KV head
  const int RB = rows_per_block<D>(p.chunk);
  const int nrb = (R + RB - 1) / RB;
  const int cap = imin(RB, R);                 // a partial's rows
  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / nrb, rb = blockIdx.y - hk * nrb;
  const int r0 = rb * RB;
  const int rows = imin(RB, R - r0);           // this block's rows
  // the chunks of a unit merge within their cluster where the launcher
  // made one of them (2 .. MAX_CLUSTER chunks), else through the ticket
  const int splits = gridDim.x;
  const bool in_cluster = cluster_blocks() > 1;
  const Q lay(cap, p.chunk, in_cluster, splits);
  float* qr = reinterpret_cast<float*>(base + lay.qr);
  float* sc = reinterpret_cast<float*>(base + lay.sc);
  float* kbs = reinterpret_cast<float*>(base + lay.kb);
  float* ml = reinterpret_cast<float*>(base + lay.ml);
  int* ri = reinterpret_cast<int*>(base + lay.ri);   // [rows][3]
  const uint32_t full0 = smem_u32(base + lay.bar);
  const uint32_t empty0 = full0 + 8 * L::STAGES;
  volatile int* last = reinterpret_cast<volatile int*>(
      base + lay.bar + 2 * L::STAGES * 8);

  // the chunk's keys within the band of rows 0 .. tq - 1
  const int c0 = split * p.chunk;
  int lo = c0, hi = imin(p.tk, c0 + p.chunk);
  if (p.causal) {
    hi = imin(hi, p.q_offset + p.tq);
    if (p.window > 0) lo = imax(lo, p.q_offset - p.window + 1);
  }
  const int n = hi - lo;                       // keys to score (<= 0: none)
  const int n_t = n > 0 ? (n + BK - 1) / BK : 0;

  // -- the producer: K tiles, then V tiles, into the ring ------------------
  // Its thread sets up the barriers and issues the ring's first loads
  // before the block's first sync, so the maps' fetch and the loads'
  // latency start at once; later loads wait for their stage's release
  auto load_tile = [&](int i) {
    const int s = i % L::STAGES;
    const uint32_t full = full0 + 8 * s;
    mbar_expect_tx(full, L::STAGE_BYTES);
    const bool is_k = i < n_t;
    const int key0 = lo + (is_k ? i : i - n_t) * BK;
    unsigned char* dst = base + s * L::STAGE_BYTES;
#pragma unroll
    for (int pn = 0; pn < L::NP; ++pn)
      tma_load_4d(dst + pn * BK * 128, is_k ? &maps.k : &maps.v, full,
                  pn * PANEL, key0, hk, b);
  };
  const bool producer = threadIdx.x == CONSUMERS;
  if (producer && n_t > 0) {                   // the maps: kernel parameters
    prefetch_map(&maps.k);
    prefetch_map(&maps.v);
  }
  if (producer) {
#pragma unroll
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);   // a warp's lane 0
    }
    mbar_init_fence();
    for (int i = 0; i < imin(2 * n_t, L::STAGES); ++i) load_tile(i);
  }
  __syncthreads();
  // a block may store into another's shared memory only once that block
  // has started: every block arrives here and waits before its stores
  if (in_cluster) cluster_arrive();

  if (threadIdx.x >= CONSUMERS) {
    if (producer) {
      for (int i = L::STAGES; i < 2 * n_t; ++i) {
        mbar_wait(empty0 + 8 * (i % L::STAGES), ((i / L::STAGES) - 1) & 1);
        load_tile(i);
      }
    }
    if (in_cluster) {                          // the consumers' syncs
      cluster_wait();
      cluster_sync();
    }
    return;
  }

  // -- the consumers -------------------------------------------------------
  constexpr int QW = D / 4, QP = QW / 8;       // a quarter: columns, pieces
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // block row i: query head hk * group + (r0 + i) / tq, row (r0 + i) % tq;
  // its query in fp32, its band and bias row; the chunk's key bias
  const T* q = static_cast<const T*>(p.q) + b * p.sq_b;
  for (int i = tid; i < rows * D; i += CONSUMERS) {
    const int r = i / D, c = i - r * D, rr = r0 + r;
    const int h = hk * group + rr / p.tq, t = rr % p.tq;
    qr[r * Q::QROW + (c / QW) * Q::QPAD + c % QW] =
        c < p.d ? to_f(q[t * p.sq_t + h * p.sq_h + c]) : 0.f;
  }
  for (int r = tid; r < rows; r += CONSUMERS) {
    const int t = (r0 + r) % p.tq, qpos = p.q_offset + t;
    ri[3 * r] = p.causal && p.window > 0 ? qpos - p.window + 1 : INT_MIN;
    ri[3 * r + 1] = p.causal ? qpos : INT_MAX;
    ri[3 * r + 2] = static_cast<int>(t * p.sb_t);
  }
  const float* kb = p.kbias ? p.kbias + b * p.skb_b : nullptr;
  for (int i = tid; i < n; i += CONSUMERS) kbs[i] = kb ? kb[lo + i] : 0.f;
  named_bar(1, CONSUMERS);

  // the ring's tiles GT (16 KB) at a time, the rest of the ring loading
  // meanwhile: wait for them, one pass, release them
  constexpr int GT = L::GROUP;
  auto wait_group = [&](int i0, int ng) {
#pragma unroll
    for (int u = 0; u < GT; ++u)
      if (u < ng)
        mbar_wait(full0 + 8 * ((i0 + u) % L::STAGES),
                  ((i0 + u) / L::STAGES) & 1);
  };
  auto release_group = [&](int i0, int ng) {
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < GT; ++u)
        if (u < ng) mbar_arrive(empty0 + 8 * ((i0 + u) % L::STAGES));
    }
  };

  // scores of the chunk: warp w takes keys 8 w .. 8 w + 7 of each tile,
  // a key's four lanes a quarter of its columns each (their sums joined
  // by two shuffles), one row of the block after another
  const float* bias = p.bias ? p.bias + b * p.sb_b : nullptr;
  const float scale = p.sm_scale;
  const int kq = lane & 3, kr = warp * 8 + (lane >> 2);
  const float* qk = qr + kq * Q::QPAD;
  for (int g0 = 0; g0 < n_t; g0 += GT) {
    const int ng = imin(GT, n_t - g0);
    wait_group(g0, ng);
    uint4 kraw[GT][QP];
#pragma unroll
    for (int u = 0; u < GT; ++u) {
      const unsigned char* stage =
          base + ((g0 + u) % L::STAGES) * L::STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < QP; ++i)
        kraw[u][i] = u < ng ? stage_piece(stage, kr, kq * QP + i)
                            : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int r = 0; r < rows; ++r) {
      const float* qq = qk + r * Q::QROW;
      float acc[GT];
#pragma unroll
      for (int u = 0; u < GT; ++u) acc[u] = 0.f;
#pragma unroll
      for (int i = 0; i < QP; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qq + i * 8);
        const float4 e = *reinterpret_cast<const float4*>(qq + i * 8 + 4);
#pragma unroll
        for (int u = 0; u < GT; ++u) {
          float kx[8];
          unpack8<T>(kraw[u][i], kx);
          float x = acc[u];
          x = fmaf(kx[0], a.x, x);
          x = fmaf(kx[1], a.y, x);
          x = fmaf(kx[2], a.z, x);
          x = fmaf(kx[3], a.w, x);
          x = fmaf(kx[4], e.x, x);
          x = fmaf(kx[5], e.y, x);
          x = fmaf(kx[6], e.z, x);
          x = fmaf(kx[7], e.w, x);
          acc[u] = x;
        }
      }
      const int vlo = ri[3 * r], vhi = ri[3 * r + 1];
      float* scr = sc + r * p.chunk;
#pragma unroll
      for (int u = 0; u < GT; ++u) {
        float x = acc[u];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        const int kl = (g0 + u) * BK + kr, key = lo + kl;
        if (kq == 0 && kl < n) {
          x = x * scale + kbs[kl];
          if (bias) x += bias[ri[3 * r + 2] + key];
          scr[kl] = key >= vlo && key <= vhi ? x : -INFINITY;
        }
      }
    }
    release_group(g0, ng);
  }
  named_bar(1, CONSUMERS);

  // the chunk's (m, l) a warp a row; p rounded to the value dtype in place
  for (int r = warp; r < rows; r += 4) {
    float* row = sc + r * p.chunk;
    float mx = -INFINITY;
#pragma unroll 8
    for (int k = lane; k < n; k += 32) mx = fmaxf(mx, row[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mu = mx == -INFINITY ? 0.f : mx;
    float l = 0.f;
#pragma unroll 8
    for (int k = lane; k < n; k += 32) {
      const float e = expf(row[k] - mu);
      l += e;
      row[k] = to_f(from_f<T>(e));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ml[2 * r] = mx == -INFINITY ? NEG_INF : mx;
      ml[2 * r + 1] = l;
    }
  }
  named_bar(1, CONSUMERS);

  // acc = sum_key p v: thread (piece cc, slot) owns 8 columns of rows rs,
  // rs + RS, ... (up to four) over the keys kg, kg + KG, ... of each tile.
  // Up to four rows, one thread takes them all (RS = 1) and its keys
  // kg + NT v of each tile of the group, a fixed count (the pass
  // unrolled); more rows share out the slots (the general pass)
  const int cc = tid % L::CPR, slot = tid / L::CPR;
  const int RS = rows <= 4 ? 1 : imin(rows, L::NT), KG = L::NT / RS;
  const int rs = slot % RS, kg = slot / RS;
  const bool active = kg < KG;
  const float* prow = sc + rs * p.chunk;
  const int pstep = RS * p.chunk;
  float acc[4][8];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e] = 0.f;
  constexpr int KPT = BK / L::NT;              // a tile's keys a thread, RS 1
  for (int g0 = 0; g0 < n_t; g0 += GT) {
    const int ng = imin(GT, n_t - g0);
    wait_group(n_t + g0, ng);
    if (RS == 1) {
#pragma unroll
      for (int u = 0; u < GT; ++u) {
        const unsigned char* stage =
            base + ((n_t + g0 + u) % L::STAGES) * L::STAGE_BYTES;
#pragma unroll
        for (int v = 0; v < KPT; ++v) {
          const int kk = kg + L::NT * v, kl = (g0 + u) * BK + kk;
          if (u < ng && kl < n) {
            float vx[8];
            unpack8<T>(stage_piece(stage, kk, cc), vx);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              if (m < rows) {
                const float pm = prow[m * pstep + kl];
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  acc[m][e] = fmaf(pm, vx[e], acc[m][e]);
              }
            }
          }
        }
      }
    } else if (active) {
      for (int u = 0; u < ng; ++u) {
        const unsigned char* stage =
            base + ((n_t + g0 + u) % L::STAGES) * L::STAGE_BYTES;
        const int key0 = (g0 + u) * BK, nk = imin(BK, n - key0);
        for (int kk = kg; kk < nk; kk += KG) {
          float vx[8];
          unpack8<T>(stage_piece(stage, kk, cc), vx);
          const float* pr = prow + key0 + kk;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            if (rs + RS * m < rows) {
              const float pm = pr[m * pstep];
#pragma unroll
              for (int e = 0; e < 8; ++e)
                acc[m][e] = fmaf(pm, vx[e], acc[m][e]);
            }
          }
        }
      }
    }
    release_group(n_t + g0, ng);
  }

  // the key groups' sums through shared memory (the query rows' space),
  // added in group order
  named_bar(1, CONSUMERS);
  float* red = qr;
  if (active) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = rs + RS * m;
      if (r < rows) {
        float4* dst = reinterpret_cast<float4*>(red + (kg * rows + r) * D +
                                                cc * 8);
        dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
      }
    }
  }
  named_bar(1, CONSUMERS);
  // element (r, c) of acc_c: the KG groups' sums, added in group order
  auto acc_at = [&](int r, int c) {
    const float* x = red + r * D + c;
    const int step = rows * D;
    float o = 0.f;
    for (int g = 0; g < KG; ++g) o += x[g * step];
    return o;
  };

  T* out = static_cast<T*>(p.out) + b * p.so_b;
  auto out_at = [&](int r) {
    const int rr = r0 + r, h = hk * group + rr / p.tq, t = rr % p.tq;
    return out + t * p.so_t + h * p.so_h;
  };
  auto lse_at = [&](int r) {
    const int rr = r0 + r, h = hk * group + rr / p.tq, t = rr % p.tq;
    return p.lse + (static_cast<int64_t>(b) * p.H + h) * p.tq + t;
  };

  if (gridDim.x == 1) {                       // one chunk: out = acc / l
    for (int i = tid; i < rows * D; i += CONSUMERS) {
      const int r = i / D, c = i - r * D;
      if (c >= p.d) continue;
      const float o = acc_at(r, c);
      const float l = ml[2 * r + 1];
      out_at(r)[c] = from_f<T>(l > 0.f ? o / l : 0.f);
      if (c == 0) *lse_at(r) = l > 0.f ? ml[2 * r] + logf(l) : NEG_INF;
    }
    return;
  }

  if (in_cluster) {
    // each block stores its (acc_c, m_c, l_c) into the inbox of the block
    // of rank 0 (chunk 0), at its chunk's slot; after the cluster's sync
    // that block merges the slots in chunk order from its own shared
    // memory
    cluster_wait();
    const uint32_t inbox = smem_u32(base + lay.mrg);
    const uint32_t to = cluster_addr(inbox, 0);
    const int mlo = splits * cap * D;          // the inbox's (m, l) part
    for (int i = tid; i < rows * D; i += CONSUMERS)
      st_cluster(to + 4 * ((split * cap) * D + i), acc_at(i / D, i % D));
    for (int r = tid; r < rows; r += CONSUMERS) {
      st_cluster(to + 4 * (mlo + 2 * (split * cap + r)), ml[2 * r]);
      st_cluster(to + 4 * (mlo + 2 * (split * cap + r) + 1), ml[2 * r + 1]);
    }
    cluster_sync();
    if (split != 0) return;
    // every slot's loads at once, then the sums in chunk order (a dead
    // chunk, l_c = 0, weighs 0, as the plain version's)
    constexpr int NC = D / 32;
    const float* box = reinterpret_cast<const float*>(base + lay.mrg);
    for (int r = warp; r < rows; r += 4) {
      float mv[MAX_CLUSTER], lv[MAX_CLUSTER], ov[MAX_CLUSTER][NC];
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c) {
        const bool ok = c < splits;
        const float2 x = ok ? *reinterpret_cast<const float2*>(
                                  box + mlo + 2 * (c * cap + r))
                            : make_float2(0.f, 0.f);
        mv[c] = x.x;
        lv[c] = x.y;
#pragma unroll
        for (int e = 0; e < NC; ++e)
          ov[c][e] = ok ? box[(c * cap + r) * D + lane + 32 * e] : 0.f;
      }
      float M = -INFINITY;
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        M = lv[c] > 0.f ? fmaxf(M, mv[c]) : M;
      float Lsum = 0.f, o[NC];
#pragma unroll
      for (int e = 0; e < NC; ++e) o[e] = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c) {
        const float w = lv[c] > 0.f ? expf(mv[c] - M) : 0.f;
        Lsum += lv[c] * w;
#pragma unroll
        for (int e = 0; e < NC; ++e) o[e] += ov[c][e] * w;
      }
      T* orow = out_at(r);
#pragma unroll
      for (int e = 0; e < NC; ++e)
        if (lane + 32 * e < p.d)
          orow[lane + 32 * e] = from_f<T>(Lsum > 0.f ? o[e] / Lsum : 0.f);
      if (lane == 0) *lse_at(r) = Lsum > 0.f ? M + logf(Lsum) : NEG_INF;
    }
    return;
  }

  // more chunks: this one's partial to scratch, then the ticket: the
  // block's writes ordered before thread 0's release (bar.sync, then a
  // gpu-scope fence and the atomic), the last block's reads after its
  // acquire (the atomic, then bar.sync)
  const int64_t unit = (static_cast<int64_t>(b) * p.Hkv + hk) * nrb + rb;
  const int64_t pbase = (unit * splits + split) * cap;
  for (int i = tid; i < rows * D; i += CONSUMERS) {
    const int r = i / D, c = i - r * D;
    p.part_o[(pbase + r) * D + c] = acc_at(r, c);
  }
  for (int r = tid; r < rows; r += CONSUMERS)
    reinterpret_cast<float2*>(p.part_ml)[pbase + r] =
        make_float2(ml[2 * r], ml[2 * r + 1]);
  named_bar(1, CONSUMERS);
  if (tid == 0) {
    unsigned int old;
    asm volatile(
        "fence.acq_rel.gpu;\n"
        "atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
        : "=r"(old)
        : "l"(g_tickets + unit)
        : "memory");
    *last = old == static_cast<unsigned>(splits - 1);
  }
  named_bar(1, CONSUMERS);
  if (!*last) return;

  // the last block: the chunks merged in chunk order, a warp a row, a
  // lane D / 32 of its columns; every lane computes the row's M and L
  // itself, in the same order.  The first G chunks' partials load at
  // once, so a merge of up to G chunks waits on the L2 once
  constexpr int G = 8, NC = D / 32;
  const int64_t ubase = unit * splits * cap;
  for (int r = warp; r < rows; r += 4) {
    const float2* mlr =
        reinterpret_cast<const float2*>(p.part_ml) + ubase + r;
    const float* por = p.part_o + (ubase + r) * D + lane;
    float mv[G], lv[G], ov[G][NC];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const bool ok = u < splits;
      const float2 x = ok ? __ldcg(mlr + u * cap) : make_float2(0.f, 0.f);
      mv[u] = x.x;
      lv[u] = x.y;
#pragma unroll
      for (int e = 0; e < NC; ++e)
        ov[u][e] = ok ? __ldcg(por + (u * cap) * D + 32 * e) : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (lv[u] > 0.f) M = fmaxf(M, mv[u]);
    for (int c = G; c < splits; ++c) {
      const float2 x = __ldcg(mlr + c * cap);
      if (x.y > 0.f) M = fmaxf(M, x.x);
    }
    float Lsum = 0.f, o[NC];
#pragma unroll
    for (int e = 0; e < NC; ++e) o[e] = 0.f;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (lv[u] > 0.f) {
        const float w = expf(mv[u] - M);
        Lsum += lv[u] * w;
#pragma unroll
        for (int e = 0; e < NC; ++e) o[e] += ov[u][e] * w;
      }
    }
    for (int c = G; c < splits; ++c) {
      const float2 x = __ldcg(mlr + c * cap);
      if (x.y > 0.f) {
        const float w = expf(x.x - M);
        Lsum += x.y * w;
#pragma unroll
        for (int e = 0; e < NC; ++e)
          o[e] += __ldcg(por + (c * cap) * D + 32 * e) * w;
      }
    }
#pragma unroll
    for (int e = 0; e < NC; ++e)
      if (lane + 32 * e < p.d)
        out_at(r)[lane + 32 * e] =
            from_f<T>(Lsum > 0.f ? o[e] / Lsum : 0.f);
    if (lane == 0) *lse_at(r) = Lsum > 0.f ? M + logf(Lsum) : NEG_INF;
  }
  if (tid == 0) g_tickets[unit] = 0u;
}

// -- launchers -----------------------------------------------------------------

// Whether the kernel takes p's shape: q_len < 16, a chunk of BK keys or a
// multiple up to MAX_CHUNK, KV heads dividing the query heads.
bool fits(const Params& p) {
  return p.tq >= 1 && p.tq < MAX_TQ && p.chunk >= BK && p.chunk % BK == 0 &&
         p.chunk <= MAX_CHUNK && p.Hkv >= 1 && p.H % p.Hkv == 0;
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t st, bool check,
                   bool cluster_ok) {
  if (!fits(p)) return cudaErrorInvalidValue;
  const int R = (p.H / p.Hkv) * p.tq, RB = rows_per_block<D>(p.chunk);
  const int nrb = (R + RB - 1) / RB, cap = imin(R, RB);
  const int splits = (p.tk + p.chunk - 1) / p.chunk;
  // one ticket a (batch, KV head, row block) of a call of several chunks
  if (splits > 1 && static_cast<int64_t>(p.B) * p.Hkv * nrb > TICKETS)
    return cudaErrorInvalidValue;
  const bool cluster = cluster_ok && cluster_merge(splits, cap, D);
  const int smem = Layout<D>(cap, p.chunk, cluster, splits).bytes;
  if (smem > SMEM_OPTIN) return cudaErrorInvalidValue;
  if (check) return cudaSuccess;
  if (p.splits != splits || p.tk < 1) return cudaErrorInvalidValue;
  if (splits > 1 && (p.part_o == nullptr || p.part_ml == nullptr))
    return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType ty = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  Maps maps{};
  if (!map_bthd(&maps.k, ty, p.k, p.d, p.tk, p.Hkv, p.B, p.sk_t, p.sk_h,
                p.sk_b, BK) ||
      !map_bthd(&maps.v, ty, p.v, p.d, p.tk, p.Hkv, p.B, p.sv_t, p.sv_h,
                p.sv_b, BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_decode_kernel<T, D>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
  if (configured != cudaSuccess) return configured;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, p.Hkv * nrb, p.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster ? splits : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, maps, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t by_dtype(const Params& p, int head_dim, int dtype,
                     cudaStream_t st, bool check, bool cluster) {
  if (dtype == 1) {
    if (head_dim == 64)
      return launch<__nv_bfloat16, 64>(p, st, check, cluster);
    if (head_dim == 128)
      return launch<__nv_bfloat16, 128>(p, st, check, cluster);
  } else if (dtype == 2) {
    if (head_dim == 64) return launch<__half, 64>(p, st, check, cluster);
    if (head_dim == 128) return launch<__half, 128>(p, st, check, cluster);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// head_dim is the instantiated width (64 or 128, >= p->d); dtype 1 bf16,
// 2 fp16; cluster 1 merges a call of 2 .. MAX_CLUSTER chunks in a thread
// block cluster where their partials fit its inbox, 0 merges every call
// of several chunks through the ticket.  p->splits must be ceil(tk /
// chunk); with more than one chunk, p->part_o and p->part_ml are fp32
// scratch of [units][splits][rows][D] and [units][splits][rows][2]
// (units = B x Hkv x row blocks, rows the smaller of the row count and
// flash_attention_fwd_decode_rows).  K and V must meet TMA's rules (the
// wrapper's `_tma_ok`): a map that cuTensorMapEncodeTiled refuses returns
// cudaErrorInvalidValue, launching nothing.
extern "C" int flash_attention_fwd_decode(const Params* p, int head_dim,
                                          int dtype, int cluster,
                                          void* stream) {
  return static_cast<int>(
      by_dtype(*p, head_dim, dtype, static_cast<cudaStream_t>(stream),
               false, cluster != 0));
}

// 0 when flash_attention_fwd_decode would take p's q_len, chunk and heads
// at this width and dtype (with B, tk and several chunks: one ticket each
// of B x Hkv x row blocks), else the error it would return; launches
// nothing.
extern "C" int flash_attention_fwd_decode_check(const Params* p,
                                                int head_dim, int dtype) {
  return static_cast<int>(
      by_dtype(*p, head_dim, dtype, nullptr, true, false));
}

// The query rows one block takes at this width and chunk (a KV head's
// rows past it take more row blocks); 0 for a width the kernel lacks.
extern "C" int flash_attention_fwd_decode_rows(int head_dim, int chunk) {
  if (chunk < BK) return 0;
  if (head_dim == 64) return rows_per_block<64>(chunk);
  if (head_dim == 128) return rows_per_block<128>(chunk);
  return 0;
}
