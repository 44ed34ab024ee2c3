// Row quantization of the int8 KV cache, shared by the standalone row
// writers (kv_write.cu: K6, K8, K11, K13; quant_row8: K13 (b)'s streaming
// body) and the int8 walk of the decode attention kernel
// (decode_attention.cu: dattn_walk), which writes a verification chunk's,
// a decode step's or a paged step's new rows inside the launch that
// attends to them.
//
// Bit for bit kv_quant_rows (rama_tpu/models/llama.py:178): x in f32,
// scale = max(max|x| / 127, 1e-10), q = round-half-even(x / scale). The
// division is a true IEEE division (no reciprocal, no fast math), and rintf
// rounds half to even as jnp.round does. The largest |x| is a max, so any
// order of reduction, and any layout of a row over the lanes, gives the
// same scale and the same bytes.
#pragma once

#include "common.cuh"

#include <math.h>

namespace rama {

constexpr int kKvMaxPerLane = 8;      // hd <= 256 in quant_row

// The scale of a row whose largest |x| is amax.
__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(amax / 127.0f, 1e-10f);
}

// x at that scale, as the int8 value's bits in the low byte.
__device__ __forceinline__ uint32_t quant_byte(float x, float scale) {
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(rintf(x / scale))));
}

// Quantize one row of hd elements (warp-wide: lane holds elements lane +
// 32 i) into dst / *dst_scale.
template <typename T>
__device__ __forceinline__ void quant_row(const T* __restrict__ src, int8_t* __restrict__ dst,
                                          float* __restrict__ dst_scale, int hd, int lane) {
  float x[kKvMaxPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kKvMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    x[i] = d < hd ? to_f(src[d]) : 0.f;
    amax = fmaxf(amax, fabsf(x[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = quant_scale(amax);
#pragma unroll
  for (int i = 0; i < kKvMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) dst[d] = static_cast<int8_t>(quant_byte(x[i], scale));
  }
  if (lane == 0) *dst_scale = scale;
}

// One bf16 row of HD <= 128 elements, warp-wide, four consecutive elements
// a lane: u holds lane's elements 4 lane .. 4 lane + 3 as loaded (8 bytes;
// zeros on a lane >= HD / 4). Every lane takes part in the shuffles; sets
// `scale` and returns the lane's four int8 values packed little-endian
// (element 4 lane at the low byte).
template <int HD>
__device__ __forceinline__ uint32_t quant_row4(uint2 u, int lane, float& scale) {
  static_assert(HD % 4 == 0 && HD <= 128, "four elements a lane, one warp a row");
  const float x[4] = {__uint_as_float(u.x << 16),   // bf16 -> f32, exactly __bfloat162float
                      __uint_as_float(u.x & 0xffff0000u), __uint_as_float(u.y << 16),
                      __uint_as_float(u.y & 0xffff0000u)};
  float amax = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  scale = quant_scale(amax);
  uint32_t packed = 0;
  if (lane < HD / 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) packed |= quant_byte(x[e], scale) << (8 * e);
  }
  return packed;
}

// One bf16 row, eight consecutive elements a lane, in a group of LPR
// consecutive lanes of the warp (a power of two, the row's lanes): u holds
// the lane's elements 8 i .. 8 i + 7 of the row, i its index in the group,
// as loaded (16 bytes; zeros on a lane past the row's end). Every lane of
// the warp takes part in the shuffles, which stay within each group; sets
// `scale` and returns the lane's eight int8 values packed little-endian
// (element 8 i at the low byte of .x), to be stored as one 8-byte piece.
template <int LPR>
__device__ __forceinline__ uint2 quant_row8(uint4 u, float& scale) {
  static_assert(LPR >= 1 && LPR <= 32 && (LPR & (LPR - 1)) == 0, "a power-of-two lane group");
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float x[8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);          // bf16 -> f32, exactly __bfloat162float
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    amax = fmaxf(amax, fmaxf(fabsf(x[2 * i]), fabsf(x[2 * i + 1])));
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  scale = quant_scale(amax);
  uint2 packed = make_uint2(0u, 0u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    packed.x |= quant_byte(x[e], scale) << (8 * e);
    packed.y |= quant_byte(x[4 + e], scale) << (8 * e);
  }
  return packed;
}

}  // namespace rama
