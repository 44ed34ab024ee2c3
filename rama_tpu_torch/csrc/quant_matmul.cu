// Kernel 1: weight-only group-quantized matmul, y = x @ dequant(W[l]),
// int8 or packed int4 weights.
//
// Replaces rama_tpu/ops/pallas/quant_matmul.py: quant_matmul_layered
// (stacked (L, K, N) weights; the layer is a pointer offset taken by the
// wrapper) and quant_matmul (one 2-D weight) -- the int8 bodies
// _kernel_int8_acc(_layered) at decode M and _kernel_int8(_layered) at
// prefill M, and the int4 bodies _kernel_int4_acc(_layered) at decode M and
// _kernel_int4(_layered) at prefill M.
//
// Bound on the H100: at decode M (<= 32 rows) the work is ~2*M flops per
// weight (half a byte for int4), far below the card's ~295 flop/byte
// balance point, so the kernel is bound by streaming the weight bytes plus
// K*N/gs*4 scale bytes from HBM at 3.35 TB/s (Llama-2-7B wqkv: 50.3 MB +
// 3.1 MB = 16 us for int8; 25.2 MB + 3.1 MB = 8.5 us for int4 gs 64). At
// prefill M (k*T rows, hundreds to thousands) it is bound by 2*M*K*N flops.
//
// Design: decode M takes qmv.cuh -- 16-byte weight loads along N
// (contiguous in the (K, N) layout), the K range split across CTAs in whole
// scale groups (int8) or packing blocks (int4) so that N = 4096 still puts
// ~2 CTAs on each of the 132 SMs, a deterministic second-pass reduce of the
// split partials by the last CTA of each column tile. The dequantized
// weight is w = q * s in fp32 (the Pallas accscale kernels scale each
// group's partial sum instead: the same function, rounded differently).
// Prefill M takes qmm_tiled below: 64x64 output tiles, a 32-deep K slab of
// x and of the dequantized weight staged in shared memory, fp32 FMA on the
// CUDA cores (tensor cores are later work). For int4 the slab is 16 packed
// byte rows unpacked into 32 logical rows -- each byte row's low and high
// nibble rows side by side, with the matching x columns gathered beside
// them -- so every weight byte is read once; the sum over K does not care
// in which order the rows come.
#include "qmv.cuh"

namespace rama {

constexpr int kBM = 64, kBN = 64, kBK = 32;

// Logical K row of slab row kk (int4): slab rows 2i and 2i + 1 are the low
// and high nibble rows of byte row r0/2 + i.
__device__ __forceinline__ int int4_slab_row(int k0, int kk, int gs) {
  const int r = k0 / 2 + kk / 2;        // byte row
  const int b = r / gs, j = r - b * gs;  // packing block, row in block
  return 2 * b * gs + j + (kk & 1) * gs;
}

template <typename T, int BITS>
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
      const int gm = m_base + m;
      if constexpr (BITS == 8) {
        const int gk = k0 + kk;
        xs[kk][m] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
      } else {
        const bool ok = gm < M && k0 + kk < K;
        xs[kk][m] = ok ? to_f(x[(size_t)gm * K + int4_slab_row(k0, kk, gs)]) : 0.f;
      }
    }
    if constexpr (BITS == 4) {
      // 16 byte rows x 64 columns of packed int4: 4 bytes per thread, each
      // giving 4 low-nibble weights (slab row 2i) and 4 high (2i + 1)
      const int i = tid / 16, n4 = (tid % 16) * 4;
      const int r = k0 / 2 + i, gn = n_base + n4;
      const int glo = int4_slab_row(k0, 2 * i, gs) / gs;  // scale row of the low nibble
      float lo[4], hi[4];
      if (2 * r < K && (N % 4) == 0 && gn + 4 <= N) {
        const uint32_t v = __ldg(reinterpret_cast<const unsigned*>(q + (size_t)r * N + gn));
        unpack_int4x4(v, lo, hi);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] *= __ldg(s + (size_t)glo * N + gn + c);
          hi[c] *= __ldg(s + (size_t)(glo + 1) * N + gn + c);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = gn + c;
          lo[c] = hi[c] = 0.f;
          if (2 * r < K && n < N) {
            unpack_int4x1(q[(size_t)r * N + n], lo[c], hi[c]);
            lo[c] *= s[(size_t)glo * N + n];
            hi[c] *= s[(size_t)(glo + 1) * N + n];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ws[2 * i][n4 + c] = lo[c];
        ws[2 * i + 1][n4 + c] = hi[c];
      }
    } else {
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

template <typename T, int BITS>
cudaError_t launch_qmm(const void* x, const void* q, const void* s, void* y, int M,
                       int K, int N, int gs, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmm_tiled<T, BITS><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<T*>(y), M, K, N, gs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_qmm_bits(int bits, const void* x, const void* q, const void* s, void* y,
                            int M, int K, int N, int gs, cudaStream_t stream) {
  if (bits == 8) return launch_qmm<T, 8>(x, q, s, y, M, K, N, gs, stream);
  if (bits == 4) return launch_qmm<T, 4>(x, q, s, y, M, K, N, gs, stream);
  return cudaErrorInvalidValue;
}

}  // namespace rama

// `bits` 8: q (K, N) int8; 4: q (K/2, N) packed int4 (K a multiple of 2*gs).
// `bps`: K blocks per split, scale groups for int8 and packing blocks for int4.
extern "C" int rama_qmv(const void* x, const void* q, const void* s, void* y, void* part,
                        void* tickets, int M, int K, int N, int gs, int ks, int bps,
                        int bits, int dtype, void* stream) {
  return static_cast<int>(rama::launch_qmv_dtype(bits, dtype, x, q, s, y, part, tickets, M,
                                                 K, N, gs, ks, bps,
                                                 static_cast<cudaStream_t>(stream)));
}

extern "C" int rama_qmm(const void* x, const void* q, const void* s, void* y, int M,
                        int K, int N, int gs, int bits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rama::kBF16)
    return static_cast<int>(
        rama::launch_qmm_bits<__nv_bfloat16>(bits, x, q, s, y, M, K, N, gs, st));
  if (dtype == rama::kF32)
    return static_cast<int>(rama::launch_qmm_bits<float>(bits, x, q, s, y, M, K, N, gs, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
