// Split-K weight-streaming GEMV for decode-sized M, int8 or packed int4,
// shared by quant_matmul.cu (wqkv, wo, lm_head) and ffn.cu (the w2 half of
// the FFN).
//
// y (M, N) = x (M, K) @ dequant(q, s (K/gs, N) f32 or bf16: S), fp32
// accumulation, output in x's dtype T. q is (K, N) int8 for BITS 8, or (K/2, N) packed
// int4 for BITS 4 in the JAX package's block-local split layout: byte row
// j of packing block b (2*gs logical rows) holds logical row 2b*gs + j in
// its low nibble (scale row 2b) and 2b*gs + gs + j in its high nibble
// (scale row 2b + 1).
//
// Layout of the work: a CTA of 32 x 8 threads owns 512 output columns
// (16 per lane: one 16-byte load of weight bytes per byte row) for a range
// of whole K blocks (the split: scale groups for int8, packing blocks for
// int4) and MT rows of x (staged in shared memory as fp32 and broadcast to
// the warp). The 8 warps of the CTA take alternate byte rows and are summed
// through shared memory. The split-K partials go to a fp32 workspace; the
// last CTA of a column tile to finish (an integer ticket, no float atomics)
// adds the ks partials in split order, so results are deterministic run to
// run.
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

// 16 consecutive scales of a scale row (S: float or bf16) at column col0
// as f32 (zeros past N).
template <typename S>
__device__ __forceinline__ void qmv_load_s(const S* __restrict__ srow, int col0,
                                           int N, bool vec, float* sc) {
  if (vec) {
    if (col0 < N) {
      load8(srow + col0, sc);
      load8(srow + col0 + 8, sc + 8);
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) sc[c] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int n = col0 + c;
      sc[c] = n < N ? to_f(srow[n]) : 0.f;
    }
  }
}

// Sign-extended nibbles of the 4 bytes of a little-endian word: byte c
// holds lo[c] in bits 8c..8c+3 and hi[c] in bits 8c+4..8c+7. Shifting the
// nibble to the top of an unsigned word and then arithmetically back down
// sign-extends it without any signed left shift.
__device__ __forceinline__ void unpack_int4x4(uint32_t w, float* lo, float* hi) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    lo[c] = static_cast<float>(static_cast<int32_t>(w << (28 - 8 * c)) >> 28);
    hi[c] = static_cast<float>(static_cast<int32_t>(w << (24 - 8 * c)) >> 28);
  }
}

// The nibbles of one packed byte (the scalar path at ragged edges).
__device__ __forceinline__ void unpack_int4x1(int8_t b, float& lo, float& hi) {
  const uint32_t u = static_cast<uint8_t>(b);
  lo = static_cast<float>(static_cast<int32_t>(u << 28) >> 28);
  hi = static_cast<float>(static_cast<int32_t>(u << 24) >> 28);
}

// 16 consecutive packed bytes of byte row `row` at column col0 as 16 low
// and 16 high nibbles (zeros past N).
__device__ __forceinline__ void qmv_load_w4(const int8_t* __restrict__ row, int col0,
                                            int N, bool vec, float* lo, float* hi) {
  if (vec) {
    if (col0 < N) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(row + col0));
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) unpack_int4x4(w[i], lo + 4 * i, hi + 4 * i);
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) lo[c] = hi[c] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int n = col0 + c;
      if (n < N) unpack_int4x1(row[n], lo[c], hi[c]);
      else lo[c] = hi[c] = 0.f;
    }
  }
}

// Logical K rows per K block: a scale group (int8) or a packing block of
// two scale groups (int4). Splits never cut a packing block, so both
// nibble planes of a byte row meet the x slab of their own split.
template <int BITS>
__host__ __device__ __forceinline__ int qmv_block_rows(int gs) {
  return BITS == 4 ? 2 * gs : gs;
}

// An activation read through L2 only (ld.global.cg): in the fused attention
// block (attn_block.cu) x is written earlier in the same launch by other
// CTAs, which the non-coherent read-only path need not see.
__device__ __forceinline__ float ld_act(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_act(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// Dynamic shared memory of one GEMV tile, in floats: the x slab or the
// cross-warp sum, whichever is larger.
template <int BITS>
__host__ __device__ __forceinline__ size_t qmv_smem_floats(int mt, int bps, int gs) {
  const size_t xs = (size_t)mt * bps * qmv_block_rows<BITS>(gs);
  const size_t red = (size_t)kQmvWarps * kQmvCols;
  return xs > red ? xs : red;
}

// One CTA's work item of the GEMV: column tile tile_n (of ntiles_n), K split
// `split` (of ks), rows tile_m * MT ..; 256 threads (tid = threadIdx.y * 32 +
// threadIdx.x, or threadIdx.x of a 1-D block), dynamic shared memory `smem`
// of qmv_smem_floats<BITS>(MT, blocks_per_split, gs) floats. x is TX, y TY,
// the scales S.
// A CTA may run several items in a row (the fused attention block's
// persistent phase C): the ticket of the last split of a column tile
// decides who adds the partials, whichever CTA ran the others.
template <typename TX, typename TY, int MT, int BITS, typename S>
__device__ __forceinline__ void qmv_tile(const TX* x, const int8_t* __restrict__ q,
                                         const S* __restrict__ s, TY* __restrict__ y,
                                         float* __restrict__ part, unsigned* __restrict__ tickets,
                                         int M, int K, int N, int gs, int blocks_per_split,
                                         int tile_n, int split, int tile_m, int ks, int ntiles_n,
                                         float* smem) {
  __shared__ bool is_last;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int tx = tid % kQmvLanes, ty = tid / kQmvLanes;
  const int nthreads = kQmvLanes * kQmvWarps;
  const int col0 = (tile_n * kQmvLanes + tx) * 16;
  const int m0 = tile_m * MT;
  const bool vec = (N % 16) == 0;
  const int brows = qmv_block_rows<BITS>(gs);
  const int nblocks = K / brows;
  const int b_begin = split * blocks_per_split;
  const int b_end = min(nblocks, b_begin + blocks_per_split);
  const int k_begin = b_begin * brows;
  const int nk = max(b_end - b_begin, 0) * brows;

  __syncthreads();  // the previous item of this CTA is done with smem
  float* xs = smem;  // [MT][nk]
  for (int i = tid; i < MT * nk; i += nthreads) {
    const int m = i / nk, kk = i - m * nk;
    xs[i] = (m0 + m < M) ? ld_act(x + (size_t)(m0 + m) * K + k_begin + kk) : 0.f;
  }
  __syncthreads();

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;

  if constexpr (BITS == 8) {
    for (int g = b_begin; g < b_end; ++g) {
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
  } else {
    // The split's byte rows, flat, 8 warps apart, so that every warp has
    // work even when gs < 8. A warp reloads its two scale rows only when
    // its byte row enters a new packing block.
    const int nrows = nk / 2;
    int cur = -1;
    float sl[16], sh[16];
#pragma unroll 2
    for (int rr = ty; rr < nrows; rr += kQmvWarps) {
      const int bl = rr / gs, j = rr - bl * gs;  // block in split, row in block
      if (bl != cur) {
        const int g = 2 * (b_begin + bl);
        qmv_load_s(s + (size_t)g * N, col0, N, vec, sl);
        qmv_load_s(s + (size_t)(g + 1) * N, col0, N, vec, sh);
        cur = bl;
      }
      float lo[16], hi[16];
      qmv_load_w4(q + (size_t)(k_begin / 2 + rr) * N, col0, N, vec, lo, hi);
#pragma unroll
      for (int c = 0; c < 16; ++c) { lo[c] *= sl[c]; hi[c] *= sh[c]; }
      const float* xl = xs + bl * 2 * gs + j;  // logical rows 2b*gs + j, + gs
      const float* xh = xl + gs;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xlv = xl[m * nk], xhv = xh[m * nk];
#pragma unroll
        for (int c = 0; c < 16; ++c)
          acc[m][c] = fmaf(xhv, hi[c], fmaf(xlv, lo[c], acc[m][c]));
      }
    }
  }
  __syncthreads();  // xs is reused for the cross-warp sum below

  float* red = smem;  // [8][512]
  const int n_tile0 = tile_n * kQmvCols;
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
        if (ks == 1) y[(size_t)mm * N + n] = from_f<TY>(v);
        else part[((size_t)split * M + mm) * N + n] = v;
      }
    }
    __syncthreads();
  }
  if (ks == 1) return;

  // last CTA of this (column tile, row chunk) sums the ks partials in order
  __threadfence();
  __syncthreads();
  unsigned* ticket = tickets + tile_m * ntiles_n + tile_n;
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
    y[(size_t)mm * N + n] = from_f<TY>(v);
  }
  if (tid == 0) *ticket = 0u;  // ready for the next launch
}

// grid (ceil(N/512), ks, ceil(M/MT)), block (32, 8), dynamic shared memory
// qmv_smem_floats<BITS>(MT, blocks_per_split, gs) floats.
template <typename T, int MT, int BITS, typename S>
__global__ void __launch_bounds__(kQmvLanes * kQmvWarps)
qmv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
           const S* __restrict__ s, T* __restrict__ y,
           float* __restrict__ part, unsigned* __restrict__ tickets,
           int M, int K, int N, int gs, int blocks_per_split) {
  extern __shared__ float smem[];
  qmv_tile<T, T, MT, BITS, S>(x, q, s, y, part, tickets, M, K, N, gs, blocks_per_split,
                           blockIdx.x, blockIdx.y, blockIdx.z, gridDim.y, gridDim.x, smem);
}

template <typename T, int MT, int BITS, typename S>
cudaError_t launch_qmv_mt(const void* x, const void* q, const void* s, void* y,
                          void* part, void* tickets, int M, int K, int N, int gs,
                          int ks, int bps, cudaStream_t stream) {
  const dim3 grid((N + kQmvCols - 1) / kQmvCols, ks, (M + MT - 1) / MT);
  const dim3 block(kQmvLanes, kQmvWarps);
  const size_t smem = sizeof(float) * qmv_smem_floats<BITS>(MT, bps, gs);
  auto kern = qmv_kernel<T, MT, BITS, S>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const S*>(s), static_cast<T*>(y),
      static_cast<float*>(part), static_cast<unsigned*>(tickets), M, K, N, gs, bps);
  return cudaGetLastError();
}

// MT (rows of x per CTA) follows M: 1, 2, 4 or 8 (larger M runs in
// 8-row chunks, each re-reading the weights).
template <typename T, int BITS, typename S>
cudaError_t launch_qmv(const void* x, const void* q, const void* s, void* y,
                       void* part, void* tickets, int M, int K, int N, int gs,
                       int ks, int bps, cudaStream_t stream) {
  if (M <= 1) return launch_qmv_mt<T, 1, BITS, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, bps, stream);
  if (M <= 2) return launch_qmv_mt<T, 2, BITS, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, bps, stream);
  if (M <= 4) return launch_qmv_mt<T, 4, BITS, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, bps, stream);
  return launch_qmv_mt<T, 8, BITS, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, bps, stream);
}

// The C entries' dispatch: `bits` 8 or 4, `dtype` (x and y) and `sdt` (the
// scales) DType codes; `bps` is K blocks per split (scale groups for int8,
// packing blocks for int4).
template <typename T>
cudaError_t launch_qmv_bits(int bits, int sdt, const void* x, const void* q, const void* s,
                            void* y, void* part, void* tickets, int M, int K, int N, int gs,
                            int ks, int bps, cudaStream_t stream) {
  return with_scale_type(sdt, [&](auto st) {
    using S = typename decltype(st)::type;
    if (bits == 8)
      return launch_qmv<T, 8, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, bps, stream);
    if (bits == 4)
      return launch_qmv<T, 4, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, bps, stream);
    return cudaErrorInvalidValue;
  });
}

inline cudaError_t launch_qmv_dtype(int bits, int dtype, int sdt, const void* x,
                                    const void* q, const void* s, void* y, void* part,
                                    void* tickets, int M, int K, int N, int gs, int ks, int bps,
                                    cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_qmv_bits<__nv_bfloat16>(bits, sdt, x, q, s, y, part, tickets, M, K, N, gs,
                                          ks, bps, stream);
  if (dtype == kF32)
    return launch_qmv_bits<float>(bits, sdt, x, q, s, y, part, tickets, M, K, N, gs, ks, bps,
                                  stream);
  return cudaErrorInvalidValue;
}

}  // namespace rama
