// Shared helpers for the port's Hopper kernels (sm_90a). Each .cu file of
// csrc/ is built on its own into a shared library with a plain C interface
// (rama_tpu_torch/ops/kernels/build.py) and loaded through ctypes, so every
// translation unit includes this header once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rama {

// Activation dtype codes shared with the Python wrappers (build.DTYPE_CODES).
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as jnp .astype(bfloat16) does
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float through T and back (the bf16 rounding points of the Pallas
// kernels: probabilities before P.V, the FFN hidden activation).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// 8 consecutive T elements starting at p (16 bytes for bf16, 32 for f32);
// p must be aligned to 8 elements.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

}  // namespace rama

extern "C" const char* rama_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
