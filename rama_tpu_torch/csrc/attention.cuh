// Device helpers shared by the attention kernels (decode_attention.cu and
// attn_block.cu): warp reductions, 16-byte lanes of a cache tile in shared
// memory read as f32, and cp.async copies into shared memory.
#pragma once

#include "common.cuh"

namespace rama {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One lane's EPL cache elements, read from the shared-memory tile as f32:
// 8 of a bf16 / f32 cache, 16 of int8 (one 16-byte load; 32 bytes for f32).
template <typename C> struct Lane { static constexpr int EPL = 8; };
template <> struct Lane<int8_t> { static constexpr int EPL = 16; };

__device__ __forceinline__ void tile_lane(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const char4* c = reinterpret_cast<const char4*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[4 * i] = c[i].x;
    out[4 * i + 1] = c[i].y;
    out[4 * i + 2] = c[i].z;
    out[4 * i + 3] = c[i].w;
  }
}
__device__ __forceinline__ void tile_lane(const __nv_bfloat16* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void tile_lane(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// 16 bytes global -> shared without a register round trip (sm_80+); both
// addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace rama
