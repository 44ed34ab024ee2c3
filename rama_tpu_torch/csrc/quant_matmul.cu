// Kernel 1: int8 weight-only group-quantized matmul, y = x @ dequant(W[l]).
//
// Replaces rama_tpu/ops/pallas/quant_matmul.py: quant_matmul_layered
// (stacked (L, K, N) weights; the layer is a pointer offset taken by the
// wrapper) and quant_matmul (one 2-D weight), int8 bodies _kernel_int8_acc
// (_layered) at decode M and _kernel_int8 (_layered) at prefill M.
//
// Bound on the H100: at decode M (<= 32 rows) the work is ~2*M flops per
// weight byte, far below the card's ~295 flop/byte balance point, so the
// kernel is bound by streaming K*N int8 bytes plus K*N/gs*4 scale bytes
// from HBM at 3.35 TB/s (Llama-2-7B wqkv: 50.3 MB + 3.1 MB = 16 us). At
// prefill M (k*T rows, hundreds to thousands) it is bound by 2*M*K*N flops.
//
// Design: decode M takes qmv.cuh — 16-byte int8 loads along N (contiguous
// in the (K, N) layout), the K range split across CTAs so that N = 4096
// still puts ~2 CTAs on each of the 132 SMs, a deterministic second-pass
// reduce of the split partials by the last CTA of each column tile. The
// dequantized weight is w = q * s in fp32 (the Pallas accscale kernel
// scales each group's partial sum instead: the same function, rounded
// differently). Prefill M takes qmm_tiled below: 64x64 output tiles, a
// 32-deep K slab of x and of the dequantized weight staged in shared
// memory, fp32 FMA on the CUDA cores (tensor cores are later work).
#include "qmv.cuh"

namespace rama {

constexpr int kBM = 64, kBN = 64, kBK = 32;

template <typename T>
__global__ void __launch_bounds__(256)
qmm_tiled(const T* __restrict__ x, const int8_t* __restrict__ q,
          const float* __restrict__ s, T* __restrict__ y, int M, int K, int N, int gs) {
  __shared__ float xs[kBK][kBM + 4];  // x tile, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN + 4];  // dequantized weight tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m_base = blockIdx.y * kBM, n_base = blockIdx.x * kBN;
  const bool vec = (N % 8) == 0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += 256) {
      const int m = i / kBK, kk = i % kBK;
      const int gm = m_base + m, gk = k0 + kk;
      xs[kk][m] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
    {
      // 32 rows x 64 columns of int8: 8 bytes per thread
      const int kk = tid / 8, n8 = (tid % 8) * 8;
      const int gk = k0 + kk, gn = n_base + n8;
      float w[8];
      if (gk < K && vec && gn + 8 <= N) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(q + (size_t)gk * N + gn));
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
        const float* srow = s + (size_t)(gk / gs) * N + gn;
#pragma unroll
        for (int c = 0; c < 8; ++c) w[c] = static_cast<float>(b[c]) * __ldg(srow + c);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = gn + c;
          w[c] = (gk < K && n < N)
                     ? static_cast<float>(q[(size_t)gk * N + n]) * s[(size_t)(gk / gs) * N + n]
                     : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) ws[kk][n8 + c] = w[c];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m_base + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n_base + tx * 4 + j;
      if (gn < N) y[(size_t)gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_qmm(const void* x, const void* q, const void* s, void* y, int M,
                       int K, int N, int gs, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmm_tiled<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<T*>(y), M, K, N, gs);
  return cudaGetLastError();
}

}  // namespace rama

extern "C" int rama_qmv(const void* x, const void* q, const void* s, void* y, void* part,
                        void* tickets, int M, int K, int N, int gs, int ks, int gps,
                        int dtype, void* stream) {
  return static_cast<int>(rama::launch_qmv_dtype(dtype, x, q, s, y, part, tickets, M, K,
                                                 N, gs, ks, gps,
                                                 static_cast<cudaStream_t>(stream)));
}

extern "C" int rama_qmm(const void* x, const void* q, const void* s, void* y, int M,
                        int K, int N, int gs, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rama::kBF16)
    return static_cast<int>(rama::launch_qmm<__nv_bfloat16>(x, q, s, y, M, K, N, gs, st));
  if (dtype == rama::kF32)
    return static_cast<int>(rama::launch_qmm<float>(x, q, s, y, M, K, N, gs, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
