// Kernel 2: the SwiGLU FFN of one layer at decode M, int8 or packed int4
// weights, out = (silu(x @ W1[l]) * (x @ W3[l])) @ W2[l].
//
// Replaces rama_tpu/ops/pallas/ffn.py: ffn_fused_layered (_kernel, its int8
// and int4 branches). The Pallas kernel keeps the hidden activation h in VMEM between
// its two phases inside one call; on the GPU that needs a grid-wide sync,
// so this first version is two launches: (1) ffn_w13_kernel below, a
// split-K GEMV over the fused w13 whose last CTA per hidden tile adds the
// partials and applies silu(a) * c, writing h (M, H) in x's dtype (bf16 on
// the serving path: 22 KB per token at 7B, rounded where ffn.py:170
// rounds); (2) the w2 GEMV of qmv.cuh over h.
//
// Bound on the H100: bytes. At 7B one call streams w13 (4096 x 22016 int8
// + f32 scales, 95.6 MB) and w2 (11008 x 4096, 47.9 MB): 143.5 MB, 43 us at
// 3.35 TB/s; int4 (w13 gs 64, w2 gs 16) streams 45.1 + 5.6 MB of w13 and
// 22.5 + 11.3 MB of w2, 84.5 MB, 25 us. The h round trip (M x 11008 x 2
// bytes, twice) adds 0.2 % at M = 8. Design against the bound: 16-byte loads of both halves (8 columns
// of W1 and the matching 8 of W3 per lane), the K range split over CTAs
// to fill the 132 SMs, deterministic split reduction, scales applied to
// each weight before the fp32 FMA. Packed int4 (the block-local split
// layout of qmv.cuh) is unpacked in registers: one byte row gives a lane
// the low-nibble weights of one logical row and the high-nibble weights of
// the row gs further down, each with its own scale row; the K split runs
// in whole packing blocks.
//
// w13 column layouts (QuantizedTensor.il): il == 0 is [W1 | W3]; il > 0 is
// alternating il-wide tiles [W1_0 W3_0 W1_1 W3_1 ...]
// (rama_tpu/models/llama.py:_interleave_w13). Hidden unit j reads W1 column
// c1(j) and W3 column c1(j) + (il ? il : H).
#include "qmv.cuh"

namespace rama {

constexpr int kFfnLanes = 32, kFfnWarps = 8;
constexpr int kFfnUnits = kFfnLanes * 8;  // hidden units per CTA

__device__ __forceinline__ int w1_col(int j, int H, int il) {
  return il ? (j / il) * 2 * il + (j % il) : j;
}

__device__ __forceinline__ void load8_i8(const int8_t* __restrict__ p, bool vec, int valid,
                                         float* w) {
  if (vec && valid == 8) {
    const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = static_cast<float>(b[c]);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = c < valid ? static_cast<float>(p[c]) : 0.f;
  }
}

__device__ __forceinline__ void load8_f32(const float* __restrict__ p, bool vec, int valid,
                                          float* w) {
  if (vec && valid == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = c < valid ? p[c] : 0.f;
  }
}

// 8 packed int4 bytes at p as 8 low and 8 high nibbles (zeros past valid).
__device__ __forceinline__ void load8_i4(const int8_t* __restrict__ p, bool vec, int valid,
                                         float* lo, float* hi) {
  if (vec && valid == 8) {
    const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
    unpack_int4x4(static_cast<uint32_t>(v.x), lo, hi);
    unpack_int4x4(static_cast<uint32_t>(v.y), lo + 4, hi + 4);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      lo[c] = hi[c] = 0.f;
      if (c < valid) unpack_int4x1(p[c], lo[c], hi[c]);
    }
  }
}

// grid (ceil(H/256), ks, ceil(M/MT)), block (32, 8). Lane tx of the CTA
// owns hidden units j0 .. j0+7 with j0 = (blockIdx.x * 32 + tx) * 8.
template <typename T, int MT, int BITS>
__global__ void __launch_bounds__(kFfnLanes * kFfnWarps)
ffn_w13_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, T* __restrict__ h,
               float* __restrict__ part, unsigned* __restrict__ tickets,
               int M, int K, int H, int gs, int il, int blocks_per_split) {
  extern __shared__ float smem[];
  __shared__ bool is_last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kFfnLanes + tx;
  const int nthreads = kFfnLanes * kFfnWarps;
  const int ks = gridDim.y, split = blockIdx.y;
  const int N = 2 * H;
  const int j0 = (blockIdx.x * kFfnLanes + tx) * 8;
  const int valid = max(0, min(8, H - j0));
  // 8 consecutive units stay inside one il tile when il % 8 == 0
  const bool vec = (H % 8 == 0) && (il % 8 == 0);
  const int c1 = valid > 0 ? w1_col(j0, H, il) : 0;
  const int c3 = c1 + (il ? il : H);
  const int m0 = blockIdx.z * MT;
  const int brows = qmv_block_rows<BITS>(gs);
  const int nblocks = K / brows;
  const int b_begin = split * blocks_per_split;
  const int b_end = min(nblocks, b_begin + blocks_per_split);
  const int k_begin = b_begin * brows;
  const int nk = max(b_end - b_begin, 0) * brows;

  float* xs = smem;  // [MT][nk]
  for (int i = tid; i < MT * nk; i += nthreads) {
    const int m = i / nk, kk = i - m * nk;
    xs[i] = (m0 + m < M) ? to_f(x[(size_t)(m0 + m) * K + k_begin + kk]) : 0.f;
  }
  __syncthreads();

  float a[MT][8], c[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int u = 0; u < 8; ++u) { a[m][u] = 0.f; c[m][u] = 0.f; }

  // W1 / W3 scales of scale row g at this lane's 8 units
  auto load_scales = [&](int g, float* s1, float* s3) {
    if (valid > 0 && vec) {
      load8_f32(s + (size_t)g * N + c1, true, valid, s1);
      load8_f32(s + (size_t)g * N + c3, true, valid, s3);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool ok = u < valid;
        const int cc1 = ok ? w1_col(j0 + u, H, il) : 0;
        const int cc3 = cc1 + (il ? il : H);
        s1[u] = ok ? s[(size_t)g * N + cc1] : 0.f;
        s3[u] = ok ? s[(size_t)g * N + cc3] : 0.f;
      }
    }
  };
  if constexpr (BITS == 8) {
    for (int g = b_begin; g < b_end; ++g) {
      float s1[8], s3[8];
      load_scales(g, s1, s3);
#pragma unroll 2
      for (int r = ty; r < gs; r += kFfnWarps) {
        const int k = g * gs + r;
        const int8_t* row = q + (size_t)k * N;
        float w1[8], w3[8];
        if (valid > 0 && vec) {
          load8_i8(row + c1, true, valid, w1);
          load8_i8(row + c3, true, valid, w3);
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const bool ok = u < valid;
            const int cc1 = ok ? w1_col(j0 + u, H, il) : 0;
            const int cc3 = cc1 + (il ? il : H);
            w1[u] = ok ? static_cast<float>(row[cc1]) : 0.f;
            w3[u] = ok ? static_cast<float>(row[cc3]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) { w1[u] *= s1[u]; w3[u] *= s3[u]; }
        const float* xr = xs + (k - k_begin);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xr[m * nk];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            a[m][u] = fmaf(xv, w1[u], a[m][u]);
            c[m][u] = fmaf(xv, w3[u], c[m][u]);
          }
        }
      }
    }
  } else {
    // byte rows of the split, flat, 8 warps apart (see qmv.cuh)
    const int nrows = nk / 2;
    int cur = -1;
    float s1l[8], s3l[8], s1h[8], s3h[8];
#pragma unroll 2
    for (int rr = ty; rr < nrows; rr += kFfnWarps) {
      const int bl = rr / gs, jr = rr - bl * gs;  // block in split, row in block
      if (bl != cur) {
        load_scales(2 * (b_begin + bl), s1l, s3l);
        load_scales(2 * (b_begin + bl) + 1, s1h, s3h);
        cur = bl;
      }
      const int8_t* row = q + (size_t)(k_begin / 2 + rr) * N;
      float w1l[8], w1h[8], w3l[8], w3h[8];
      if (valid > 0 && vec) {
        load8_i4(row + c1, true, valid, w1l, w1h);
        load8_i4(row + c3, true, valid, w3l, w3h);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          w1l[u] = w1h[u] = w3l[u] = w3h[u] = 0.f;
          if (u < valid) {
            const int cc1 = w1_col(j0 + u, H, il);
            unpack_int4x1(row[cc1], w1l[u], w1h[u]);
            unpack_int4x1(row[cc1 + (il ? il : H)], w3l[u], w3h[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        w1l[u] *= s1l[u]; w1h[u] *= s1h[u];
        w3l[u] *= s3l[u]; w3h[u] *= s3h[u];
      }
      const float* xl = xs + bl * 2 * gs + jr;  // logical rows 2b*gs + jr, + gs
      const float* xh = xl + gs;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xlv = xl[m * nk], xhv = xh[m * nk];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          a[m][u] = fmaf(xhv, w1h[u], fmaf(xlv, w1l[u], a[m][u]));
          c[m][u] = fmaf(xhv, w3h[u], fmaf(xlv, w3l[u], c[m][u]));
        }
      }
    }
  }
  __syncthreads();

  // cross-warp sum; partial layout [split][m][unit a | unit c] over (M, 2H)
  float* red = smem;  // [8][2 * 256]
  const int RW = 2 * kFfnUnits;
  const int j_tile0 = blockIdx.x * kFfnUnits;
  auto epilogue = [&](int mm, int j, float av, float cv) {
    const float sig = 1.f / (1.f + expf(-av));
    h[(size_t)mm * H + j] = from_f<T>(av * sig * cv);
  };
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      red[ty * RW + tx * 8 + u] = a[m][u];
      red[ty * RW + kFfnUnits + tx * 8 + u] = c[m][u];
    }
    __syncthreads();
    for (int unit = tid; unit < kFfnUnits; unit += nthreads) {
      float av = 0.f, cv = 0.f;
#pragma unroll
      for (int t = 0; t < kFfnWarps; ++t) {
        av += red[t * RW + unit];
        cv += red[t * RW + kFfnUnits + unit];
      }
      const int j = j_tile0 + unit, mm = m0 + m;
      if (j < H && mm < M) {
        if (ks == 1) {
          epilogue(mm, j, av, cv);
        } else {
          part[((size_t)split * M + mm) * N + j] = av;
          part[((size_t)split * M + mm) * N + H + j] = cv;
        }
      }
    }
    __syncthreads();
  }
  if (ks == 1) return;

  __threadfence();
  __syncthreads();
  unsigned* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(ks - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < MT * kFfnUnits; i += nthreads) {
    const int m = i / kFfnUnits, unit = i - m * kFfnUnits;
    const int j = j_tile0 + unit, mm = m0 + m;
    if (j >= H || mm >= M) continue;
    float av = 0.f, cv = 0.f;
    for (int sp = 0; sp < ks; ++sp) {
      av += __ldcg(part + ((size_t)sp * M + mm) * N + j);
      cv += __ldcg(part + ((size_t)sp * M + mm) * N + H + j);
    }
    epilogue(mm, j, av, cv);
  }
  if (tid == 0) *ticket = 0u;
}

template <typename T, int MT, int BITS>
cudaError_t launch_w13_mt(const void* x, const void* q, const void* s, void* h, void* part,
                          void* tickets, int M, int K, int H, int gs, int il, int ks,
                          int bps, cudaStream_t stream) {
  const dim3 grid((H + kFfnUnits - 1) / kFfnUnits, ks, (M + MT - 1) / MT);
  const dim3 block(kFfnLanes, kFfnWarps);
  const size_t xs_floats = (size_t)MT * bps * qmv_block_rows<BITS>(gs);
  const size_t red_floats = (size_t)kFfnWarps * 2 * kFfnUnits;
  const size_t smem = sizeof(float) * (xs_floats > red_floats ? xs_floats : red_floats);
  auto kern = ffn_w13_kernel<T, MT, BITS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<T*>(h), static_cast<float*>(part),
      static_cast<unsigned*>(tickets), M, K, H, gs, il, bps);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch_w13(const void* x, const void* q, const void* s, void* h, void* part,
                       void* tickets, int M, int K, int H, int gs, int il, int ks, int bps,
                       cudaStream_t stream) {
  if (M <= 1) return launch_w13_mt<T, 1, BITS>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
  if (M <= 2) return launch_w13_mt<T, 2, BITS>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
  if (M <= 4) return launch_w13_mt<T, 4, BITS>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
  return launch_w13_mt<T, 8, BITS>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
}

template <typename T>
cudaError_t launch_w13_bits(int bits, const void* x, const void* q, const void* s, void* h,
                            void* part, void* tickets, int M, int K, int H, int gs, int il,
                            int ks, int bps, cudaStream_t stream) {
  if (bits == 8)
    return launch_w13<T, 8>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
  if (bits == 4)
    return launch_w13<T, 4>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace rama

// Phase 1: h = silu(x @ W1) * (x @ W3). Phase 2 (rama_ffn_w2) is the
// qmv GEMV over h. The wrapper launches both on one stream. `bits` 8 or 4
// per weight; `bps` K blocks per split (scale groups for int8, packing
// blocks for int4).
extern "C" int rama_ffn_w13(const void* x, const void* q13, const void* s13, void* h,
                            void* part, void* tickets, int M, int K, int H, int gs,
                            int il, int ks, int bps, int bits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rama::kBF16)
    return static_cast<int>(rama::launch_w13_bits<__nv_bfloat16>(
        bits, x, q13, s13, h, part, tickets, M, K, H, gs, il, ks, bps, st));
  if (dtype == rama::kF32)
    return static_cast<int>(rama::launch_w13_bits<float>(
        bits, x, q13, s13, h, part, tickets, M, K, H, gs, il, ks, bps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rama_ffn_w2(const void* h, const void* q2, const void* s2, void* y,
                           void* part, void* tickets, int M, int H, int N, int gs, int ks,
                           int bps, int bits, int dtype, void* stream) {
  return static_cast<int>(rama::launch_qmv_dtype(bits, dtype, h, q2, s2, y, part, tickets, M,
                                                 H, N, gs, ks, bps,
                                                 static_cast<cudaStream_t>(stream)));
}
