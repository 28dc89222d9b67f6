// The quantize and the scalar store of the quantized matmul, shared by its
// two kernels (quant.cu's mma.sync and split-K kernels, quant_sm90.cu's
// wgmma kernel), so that both round x to int8 and write a dequantized
// value exactly alike: the plain version `_qmm_ref`'s ops in order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace qmm {

// The bits of a 16-bit float type and their value.
template <typename T> __device__ __forceinline__ float from_bits16(uint32_t b);
template <> __device__ __forceinline__ float from_bits16<__nv_bfloat16>(
    uint32_t b) {
  return __uint_as_float(b << 16);
}
template <> __device__ __forceinline__ float from_bits16<__half>(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

// quantize(): round half to even, clamp to +-127, as torch.round/clamp
// do.  Clamping first gives the same value (127.5 rounds to 128 and
// clamps to 127 either way; a NaN clamps to -127 either way), and then
// adding 1.5 * 2^23 rounds to the nearest even integer in the low
// mantissa bits, whose low byte is the int8 two's complement: no
// conversion instruction (those issue at a quarter of the FP32 rate).
__device__ __forceinline__ uint32_t q8(float v, float inv) {
  const float r = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(r, 12582912.f)) & 0xffu;
}

// 16 bytes of x in shared memory -> their int8 values, stored at `dst`
template <typename T>
__device__ __forceinline__ void quantize16(const void* src, int8_t* dst,
                                           float inv) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(&raw);
    *reinterpret_cast<uint32_t*>(dst) = q8(v.x, inv) | (q8(v.y, inv) << 8) |
                                        (q8(v.z, inv) << 16) |
                                        (q8(v.w, inv) << 24);
  } else {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t lo = w[2 * h], hi = w[2 * h + 1];
      o[h] = q8(from_bits16<T>(lo & 0xffffu), inv) |
             (q8(from_bits16<T>(lo >> 16), inv) << 8) |
             (q8(from_bits16<T>(hi & 0xffffu), inv) << 16) |
             (q8(from_bits16<T>(hi >> 16), inv) << 24);
    }
    *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
  }
}

// out[i] = v rounded once to the output type (0 fp32, 1 bf16, 2 fp16)
__device__ __forceinline__ void store1(void* out, int64_t i, float v,
                                       int code) {
  if (code == 0) static_cast<float*>(out)[i] = v;
  else if (code == 1)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else static_cast<__half*>(out)[i] = __float2half_rn(v);
}

}  // namespace qmm
