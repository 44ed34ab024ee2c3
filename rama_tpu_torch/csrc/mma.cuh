// Tensor-core building blocks shared by the bf16 bodies of the prefill
// attention (prefill_attention.cu), the chunk attention
// (decode_attention.cu) and the quantized GEMM (quant_matmul.cu): cp.async
// copies into shared memory, ldmatrix fragment loads and mma.sync.m16n8k16
// (bf16 in, fp32 accumulate).
#pragma once

#include <atomic>

#include "common.cuh"

namespace rama {

// 16 bytes global -> shared; zeros (and no read of src) when !ok.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane i gives the row address of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Max / sum over the four lanes of a quad (lane = 4 g + c: one accumulator
// row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two floats rounded to nearest even as one bf16 pair (.x, the low half, = lo).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The dynamic shared-memory opt-in (cudaFuncSetAttribute) of one kernel,
// made once a device: a launcher keeps one static SmemOptIn an
// instantiation, so later launches make no driver call besides the launch
// itself (one fewer a call, and none that a stream capture must see).
struct SmemOptIn {
  std::atomic<unsigned long long> done{0};   // a bit a device id below 64
  // bytes 0: the most a block of the card may opt into (for a launcher
  // whose bytes vary from call to call)
  template <class F> cudaError_t set(F kern, size_t bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
    int most = (int)bytes;
    if (!bytes) e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return e;
  }
};

// Fragment coordinates of m16n8k16: lane = 4 g + c; an accumulator holds
// rows g and g + 8 at columns 2c, 2c + 1 of its n8 tile. A fragments of a
// row-major [m][k] tile: ldsm_x4 at row lane % 16, column (lane / 16) * 8.
// B fragments of a row-major [k][n] tile (two n8 tiles at once):
// ldsm_x4_trans at row lane % 8 + ((lane / 8) % 2) * 8, column
// (lane / 16) * 8; registers 0, 1 feed the first n8 tile, 2, 3 the second.

}  // namespace rama
