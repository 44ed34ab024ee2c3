// Split-K int8 weight-streaming GEMV for decode-sized M, shared by
// quant_matmul.cu (wqkv, wo, lm_head) and ffn.cu (the w2 half of the FFN).
//
// y (M, N) = x (M, K) @ dequant(q (K, N) int8, s (K/gs, N) f32), fp32
// accumulation, output in x's dtype T.
//
// Layout of the work: a CTA of 32 x 8 threads owns 512 output columns
// (16 per lane: one 16-byte load of int8 weights per K row) for a range of
// whole scale groups of K (the split) and MT rows of x (staged in shared
// memory as fp32 and broadcast to the warp). The 8 warps of the CTA take
// alternate K rows of each group and are summed through shared memory. The
// split-K partials go to a fp32 workspace; the last CTA of a column tile
// to finish (an integer ticket, no float atomics) adds the ks partials in
// split order, so results are deterministic run to run.
#pragma once

#include "common.cuh"

namespace rama {

constexpr int kQmvLanes = 32;               // lanes across N
constexpr int kQmvWarps = 8;                // warps across K rows
constexpr int kQmvCols = kQmvLanes * 16;    // 512 columns per CTA

// 16 consecutive int8 weights of row `row` at column col0 (zeros past N).
__device__ __forceinline__ void qmv_load_w(const int8_t* __restrict__ row, int col0,
                                           int N, bool vec, float* w) {
  if (vec) {
    if (col0 < N) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(row + col0));
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int c = 0; c < 16; ++c) w[c] = static_cast<float>(b[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) w[c] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int n = col0 + c;
      w[c] = n < N ? static_cast<float>(row[n]) : 0.f;
    }
  }
}

__device__ __forceinline__ void qmv_load_s(const float* __restrict__ srow, int col0,
                                           int N, bool vec, float* sc) {
  if (vec) {
    if (col0 < N) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(srow + col0) + i);
        sc[4 * i] = v.x; sc[4 * i + 1] = v.y; sc[4 * i + 2] = v.z; sc[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) sc[c] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int n = col0 + c;
      sc[c] = n < N ? srow[n] : 0.f;
    }
  }
}

// grid (ceil(N/512), ks, ceil(M/MT)), block (32, 8), dynamic shared memory
// max(MT * groups_per_split * gs, 8 * 512) floats.
template <typename T, int MT>
__global__ void __launch_bounds__(kQmvLanes * kQmvWarps)
qmv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ s, T* __restrict__ y,
           float* __restrict__ part, unsigned* __restrict__ tickets,
           int M, int K, int N, int gs, int groups_per_split) {
  extern __shared__ float smem[];
  __shared__ bool is_last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kQmvLanes + tx;
  const int nthreads = kQmvLanes * kQmvWarps;
  const int ks = gridDim.y, split = blockIdx.y;
  const int col0 = (blockIdx.x * kQmvLanes + tx) * 16;
  const int m0 = blockIdx.z * MT;
  const bool vec = (N % 16) == 0;
  const int ngroups = K / gs;
  const int g_begin = split * groups_per_split;
  const int g_end = min(ngroups, g_begin + groups_per_split);
  const int k_begin = g_begin * gs;
  const int nk = max(g_end - g_begin, 0) * gs;

  float* xs = smem;  // [MT][nk]
  for (int i = tid; i < MT * nk; i += nthreads) {
    const int m = i / nk, kk = i - m * nk;
    xs[i] = (m0 + m < M) ? to_f(x[(size_t)(m0 + m) * K + k_begin + kk]) : 0.f;
  }
  __syncthreads();

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    float sc[16];
    qmv_load_s(s + (size_t)g * N, col0, N, vec, sc);
#pragma unroll 2
    for (int r = ty; r < gs; r += kQmvWarps) {
      const int k = g * gs + r;
      float w[16];
      qmv_load_w(q + (size_t)k * N, col0, N, vec, w);
#pragma unroll
      for (int c = 0; c < 16; ++c) w[c] *= sc[c];
      const float* xr = xs + (k - k_begin);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xr[m * nk];
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
      }
    }
  }
  __syncthreads();  // xs is reused for the cross-warp sum below

  float* red = smem;  // [8][512]
  const int n_tile0 = blockIdx.x * kQmvCols;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < 16; ++c) red[ty * kQmvCols + tx * 16 + c] = acc[m][c];
    __syncthreads();
    for (int col = tid; col < kQmvCols; col += nthreads) {
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < kQmvWarps; ++t) v += red[t * kQmvCols + col];
      const int n = n_tile0 + col, mm = m0 + m;
      if (n < N && mm < M) {
        if (ks == 1) y[(size_t)mm * N + n] = from_f<T>(v);
        else part[((size_t)split * M + mm) * N + n] = v;
      }
    }
    __syncthreads();
  }
  if (ks == 1) return;

  // last CTA of this (column tile, row chunk) sums the ks partials in order
  __threadfence();
  __syncthreads();
  unsigned* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(ks - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < MT * kQmvCols; i += nthreads) {
    const int m = i / kQmvCols, col = i - m * kQmvCols;
    const int n = n_tile0 + col, mm = m0 + m;
    if (n >= N || mm >= M) continue;
    float v = 0.f;
    for (int sp = 0; sp < ks; ++sp) v += __ldcg(part + ((size_t)sp * M + mm) * N + n);
    y[(size_t)mm * N + n] = from_f<T>(v);
  }
  if (tid == 0) *ticket = 0u;  // ready for the next launch
}

template <typename T, int MT>
cudaError_t launch_qmv_mt(const void* x, const void* q, const void* s, void* y,
                          void* part, void* tickets, int M, int K, int N, int gs,
                          int ks, int gps, cudaStream_t stream) {
  const dim3 grid((N + kQmvCols - 1) / kQmvCols, ks, (M + MT - 1) / MT);
  const dim3 block(kQmvLanes, kQmvWarps);
  const size_t xs_floats = (size_t)MT * gps * gs;
  const size_t red_floats = (size_t)kQmvWarps * kQmvCols;
  const size_t smem = sizeof(float) * (xs_floats > red_floats ? xs_floats : red_floats);
  auto kern = qmv_kernel<T, MT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<T*>(y),
      static_cast<float*>(part), static_cast<unsigned*>(tickets), M, K, N, gs, gps);
  return cudaGetLastError();
}

// MT (rows of x per CTA) follows M: 1, 2, 4 or 8 (larger M runs in
// 8-row chunks, each re-reading the weights).
template <typename T>
cudaError_t launch_qmv(const void* x, const void* q, const void* s, void* y,
                       void* part, void* tickets, int M, int K, int N, int gs,
                       int ks, int gps, cudaStream_t stream) {
  if (M <= 1) return launch_qmv_mt<T, 1>(x, q, s, y, part, tickets, M, K, N, gs, ks, gps, stream);
  if (M <= 2) return launch_qmv_mt<T, 2>(x, q, s, y, part, tickets, M, K, N, gs, ks, gps, stream);
  if (M <= 4) return launch_qmv_mt<T, 4>(x, q, s, y, part, tickets, M, K, N, gs, ks, gps, stream);
  return launch_qmv_mt<T, 8>(x, q, s, y, part, tickets, M, K, N, gs, ks, gps, stream);
}

inline cudaError_t launch_qmv_dtype(int dtype, const void* x, const void* q, const void* s,
                                    void* y, void* part, void* tickets, int M, int K,
                                    int N, int gs, int ks, int gps, cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_qmv<__nv_bfloat16>(x, q, s, y, part, tickets, M, K, N, gs, ks, gps, stream);
  if (dtype == kF32)
    return launch_qmv<float>(x, q, s, y, part, tickets, M, K, N, gs, ks, gps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace rama
