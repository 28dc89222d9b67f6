// apex_tpu_torch host runtime — host-side hot loops, C ABI for ctypes.
//
// A copy of the JAX package's native runtime at the same ABI (version 2),
// built by the port from its own checkout (apex_tpu_torch/native.py):
//
//  * flatten/unflatten of parameter sets for checkpoint/restore and
//    host<->device staging (multi-threaded memcpy);
//  * the input-pipeline decode epilogue: uint8 HWC image -> normalized
//    float32 NHWC batch;
//  * the fused augmentation epilogue (crop + horizontal flip + normalize
//    in ONE pass over the pixels);
//  * a counter-based synthetic-batch generator (splitmix64 per 8-byte
//    block), filled in parallel without the GIL.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 (apex_tpu_torch/_build.py).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

// Run fn(i) for i in [0, n) over up to `threads` workers.
template <typename F>
void parallel_for(int64_t n, int threads, F fn) {
  if (n <= 0) return;
  int nt = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(threads, n)));
  if (nt == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  std::int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=]() { for (int64_t i = lo; i < hi; ++i) fn(i); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Pack n buffers (byte sizes in `sizes`) into contiguous dst.
// Offsets are the prefix sums; copies run in parallel per tensor.
void apex_flatten(const void** srcs, const int64_t* sizes, int64_t n,
                  void* dst, int threads) {
  std::vector<int64_t> offs(n);
  int64_t acc = 0;
  for (int64_t i = 0; i < n; ++i) { offs[i] = acc; acc += sizes[i]; }
  parallel_for(n, threads, [&](int64_t i) {
    std::memcpy(static_cast<char*>(dst) + offs[i], srcs[i],
                static_cast<size_t>(sizes[i]));
  });
}

// Inverse of apex_flatten.
void apex_unflatten(const void* src, const int64_t* sizes, int64_t n,
                    void** dsts, int threads) {
  std::vector<int64_t> offs(n);
  int64_t acc = 0;
  for (int64_t i = 0; i < n; ++i) { offs[i] = acc; acc += sizes[i]; }
  parallel_for(n, threads, [&](int64_t i) {
    std::memcpy(dsts[i], static_cast<const char*>(src) + offs[i],
                static_cast<size_t>(sizes[i]));
  });
}

// uint8 NHWC images -> float32 NHWC, (x/255 - mean[c]) / std[c].
// n_img images of h*w*c bytes each; parallel over images.
void apex_u8_to_f32_nhwc(const uint8_t* src, float* dst, int64_t n_img,
                         int64_t hw, int64_t c, const float* mean,
                         const float* stddev, int threads) {
  std::vector<float> scale(c), bias(c);
  for (int64_t ch = 0; ch < c; ++ch) {
    scale[ch] = 1.0f / (255.0f * stddev[ch]);
    bias[ch] = -mean[ch] / stddev[ch];
  }
  parallel_for(n_img, threads, [&](int64_t i) {
    const uint8_t* s = src + i * hw * c;
    float* d = dst + i * hw * c;
    for (int64_t p = 0; p < hw; ++p) {
      for (int64_t ch = 0; ch < c; ++ch) {
        d[p * c + ch] = s[p * c + ch] * scale[ch] + bias[ch];
      }
    }
  });
}

// Counter-based synthetic byte stream: block i of 8 bytes is
// splitmix64(seed + i), so generation is embarrassingly parallel, and
// the numpy reference (same recurrence on a uint64 lattice) produces
// bit-identical output.  Little-endian byte order (x86/ARM hosts; asserted in native.py).
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

void apex_synth_u8(uint8_t* dst, int64_t nbytes, uint64_t seed,
                   int threads) {
  int64_t blocks = (nbytes + 7) / 8;
  // Chunk blocks so parallel_for's per-index lambda call doesn't
  // dominate; each task fills a contiguous ~64 KB span.
  const int64_t kSpan = 8192;  // blocks per task (64 KB)
  int64_t tasks = (blocks + kSpan - 1) / kSpan;
  parallel_for(tasks, threads, [&](int64_t t) {
    int64_t lo = t * kSpan, hi = std::min(blocks, lo + kSpan);
    for (int64_t i = lo; i < hi; ++i) {
      uint64_t v = splitmix64(seed + static_cast<uint64_t>(i));
      int64_t off = i * 8;
      int64_t n = std::min<int64_t>(8, nbytes - off);
      std::memcpy(dst + off, &v, static_cast<size_t>(n));
    }
  });
}

// Fused augmentation epilogue: per-image crop window (oy, ox) of
// oh x ow out of h x w, optional horizontal flip, then the normalize
// affine — ONE pass over the output pixels instead of crop + flip +
// normalize as separate host passes (what DALI fuses on GPU for the
// reference's imagenet pipeline).  offs is [n, 2] (oy, ox); flips is
// [n] (0/1).  Parallel over images.
void apex_crop_flip_norm_u8_f32(const uint8_t* src, float* dst, int64_t n,
                                int64_t h, int64_t w, int64_t c,
                                int64_t oh, int64_t ow,
                                const int32_t* offs, const uint8_t* flips,
                                const float* mean, const float* stddev,
                                int threads) {
  std::vector<float> scale(c), bias(c);
  for (int64_t ch = 0; ch < c; ++ch) {
    scale[ch] = 1.0f / (255.0f * stddev[ch]);
    bias[ch] = -mean[ch] / stddev[ch];
  }
  parallel_for(n, threads, [&](int64_t i) {
    int64_t oy = offs[2 * i], ox = offs[2 * i + 1];
    bool flip = flips[i] != 0;
    const uint8_t* img = src + i * h * w * c;
    float* out = dst + i * oh * ow * c;
    for (int64_t y = 0; y < oh; ++y) {
      const uint8_t* row = img + ((oy + y) * w + ox) * c;
      float* drow = out + y * ow * c;
      for (int64_t x = 0; x < ow; ++x) {
        const uint8_t* px = row + (flip ? (ow - 1 - x) : x) * c;
        for (int64_t ch = 0; ch < c; ++ch) {
          drow[x * c + ch] = px[ch] * scale[ch] + bias[ch];
        }
      }
    }
  });
}

// Simple checksum used by tests to verify the library loaded correctly.
// v2: apex_synth_u8 and apex_crop_flip_norm_u8_f32.
int64_t apex_runtime_abi_version() { return 2; }

}  // extern "C"
