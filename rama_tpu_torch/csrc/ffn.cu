// Kernel 2: the SwiGLU FFN of one layer at any M (a decode step's slots, a
// verify round's slots x tokens), int8 or packed int4 weights,
// out = (silu(x @ W1[l]) * (x @ W3[l])) @ W2[l].
//
// Replaces rama_tpu/ops/pallas/ffn.py: ffn_fused_layered (_kernel, its int8
// and int4 branches), with f32 or bf16-stored scales (the Pallas kernel
// upcasts them in VMEM, ffn.py:89, :108): every body is instantiated for
// both scale types S, reads a scale as f32, and plans its splits from the
// shapes alone, so a bf16-scale launch equals the same body fed
// scales.float() bit for bit. The Pallas kernel keeps the hidden
// activation h in VMEM between its two phases inside one call; here the
// two phases are two launches on one stream, and h (M, H) goes through
// device memory in x's dtype (bf16 on the serving path: 22 KB a row at 7B,
// rounded where ffn.py:170 rounds; 0.25 % of the bytes at M = 8).
//
// Bound on the H100: bytes, at every M it serves. At 7B one call streams
// w13 (4096 x 22016 int8 + f32 scales, 95.6 MB) and w2 (11008 x 4096, 47.9
// MB): 143.5 MB, 43 us at 3.35 TB/s; int4 (w13 gs 64, w2 gs 16) 84.5 MB, 25
// us (bf16 scales: 139.3 MB, 42 us; int4 76.0 MB, 23 us). At M = 32 the
// 8.7 GFLOP take 9 us of the tensor cores' 989 TFLOP/s; operations bound it
// from M ~ 157 (int8) and ~ 93 (int4) on (270.5 MFLOP a row).
//
// Two bodies, fixed by the activation dtype before the launch:
//
// ffn_mma (bf16, any M): the swap-AB tensor-core body of swapab.cuh (the
// tokens on mma.sync's n8 side; the raw bytes become bf16(float(q) * s) in
// registers after ldmatrix.trans), shared with K1's qmv_mma. Up to 64 rows
// ("one" form: NT 1 / 2 / 4 / 8 n8 tiles) one CTA holds every row of x, so
// each weight byte is read once a call; above 64 ("rows" form) the rows
// split into row blocks of 64 on NT 8, the blocks of a column tile side by
// side on the grid, so that the later blocks find a weight tile in L2 (a
// short last block runs NT 8 on zero rows, in the same launch: a second
// launch at a smaller NT would stream the weights from HBM again). Each
// block converts its weight bytes to bf16 itself. A CTA owns 256 weight
// columns (8 warps) over a K split. Phase A
// (w13): the 256 columns are the W1 and W3 columns of the same 128 hidden
// units (ColsW13), so the silu(a) * c epilogue has both in one CTA and each
// weight row is read in runs of 128 bytes; phase B (w2 over h): 256
// consecutive output columns. K is split across CTAs in whole slabs and
// whole K blocks, about one wave of two CTAs an SM for one row block (the
// plan does not depend on M, every form holds two CTAs an SM); the last CTA
// of a (row block, column tile) adds the split partials in split order, so
// reruns are bit for bit and a row has the same bits at any M.
//
// simt (fp32 activations; no serving path runs them): ffn_w13_kernel
// below, a split-K GEMV on the CUDA cores whose last CTA per hidden tile
// applies silu(a) * c, then the w2 GEMV of qmv.cuh over h; any M in chunks
// of up to 8 rows (grid z).
//
// w13 column layouts (QuantizedTensor.il): il == 0 is [W1 | W3]; il > 0 is
// alternating il-wide tiles [W1_0 W3_0 W1_1 W3_1 ...]
// (rama_tpu/models/llama.py:_interleave_w13). Hidden unit j reads W1 column
// w1_col(j) and W3 column w1_col(j) + (il ? il : H).
#include <type_traits>

#include "swapab.cuh"

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

// 8 scales (f32 or bf16) at p as f32 (zeros past valid).
template <typename S>
__device__ __forceinline__ void load8_s(const S* __restrict__ p, bool vec, int valid, float* w) {
  if (vec && valid == 8) {
    load8(p, w);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = c < valid ? to_f(p[c]) : 0.f;
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
template <typename T, int MT, int BITS, typename S>
__global__ void __launch_bounds__(kFfnLanes * kFfnWarps)
ffn_w13_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
               const S* __restrict__ s, T* __restrict__ h,
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
      load8_s(s + (size_t)g * N + c1, true, valid, s1);
      load8_s(s + (size_t)g * N + c3, true, valid, s3);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool ok = u < valid;
        const int cc1 = ok ? w1_col(j0 + u, H, il) : 0;
        const int cc3 = cc1 + (il ? il : H);
        s1[u] = ok ? to_f(s[(size_t)g * N + cc1]) : 0.f;
        s3[u] = ok ? to_f(s[(size_t)g * N + cc3]) : 0.f;
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

template <typename T, int MT, int BITS, typename S>
cudaError_t launch_w13_mt(const void* x, const void* q, const void* s, void* h, void* part,
                          void* tickets, int M, int K, int H, int gs, int il, int ks,
                          int bps, cudaStream_t stream) {
  const dim3 grid((H + kFfnUnits - 1) / kFfnUnits, ks, (M + MT - 1) / MT);
  const dim3 block(kFfnLanes, kFfnWarps);
  const size_t xs_floats = (size_t)MT * bps * qmv_block_rows<BITS>(gs);
  const size_t red_floats = (size_t)kFfnWarps * 2 * kFfnUnits;
  const size_t smem = sizeof(float) * (xs_floats > red_floats ? xs_floats : red_floats);
  auto kern = ffn_w13_kernel<T, MT, BITS, S>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const S*>(s), static_cast<T*>(h), static_cast<float*>(part),
      static_cast<unsigned*>(tickets), M, K, H, gs, il, bps);
  return cudaGetLastError();
}

template <typename T, int BITS, typename S>
cudaError_t launch_w13(const void* x, const void* q, const void* s, void* h, void* part,
                       void* tickets, int M, int K, int H, int gs, int il, int ks, int bps,
                       cudaStream_t stream) {
  if (M <= 1) return launch_w13_mt<T, 1, BITS, S>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
  if (M <= 2) return launch_w13_mt<T, 2, BITS, S>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
  if (M <= 4) return launch_w13_mt<T, 4, BITS, S>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
  return launch_w13_mt<T, 8, BITS, S>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
}

template <typename T>
cudaError_t launch_w13_bits(int bits, int sdt, const void* x, const void* q, const void* s,
                            void* h, void* part, void* tickets, int M, int K, int H, int gs,
                            int il, int ks, int bps, cudaStream_t stream) {
  return with_scale_type(sdt, [&](auto t) {
    using S = typename decltype(t)::type;
    if (bits == 8)
      return launch_w13<T, 8, S>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
    if (bits == 4)
      return launch_w13<T, 4, S>(x, q, s, h, part, tickets, M, K, H, gs, il, ks, bps, stream);
    return cudaErrorInvalidValue;
  });
}

// ---------------------------------------------------------------------------
// bf16 tensor-core body (swapab.cuh)

constexpr int kFfnBN = 256;                         // weight columns a CTA
constexpr int kFfnMmaThreads = Swab<kFfnBN>::kThreads;   // 8 warps, two m16 tiles each
constexpr int kFfnMmaUnits = kFfnBN / 2;            // hidden units a phase-A CTA
constexpr int kFfnCtas = 2;                         // CTAs an SM (registers capped to fit)

// Phase A's column map: slab column lc is unit u0 + lc % 128's W1 column
// (lc < 128) or its W3 column. A tile inside one il-wide tile (il a
// multiple of 128, or il 0) is two runs of 128 adjacent columns.
struct ColsW13 {
  int u0, H, il, c1, c3;
  bool runs;
  __device__ ColsW13(int u0_, int H_, int il_)
      : u0(u0_), H(H_), il(il_), c1(w1_col(u0_, H_, il_)), c3(il_ ? il_ : H_),
        runs(il_ % kFfnMmaUnits == 0) {}
  __device__ __forceinline__ int operator()(int lc) const {
    const int u = lc & (kFfnMmaUnits - 1);
    if (u0 + u >= H) return -1;
    const int c = runs ? c1 + u : w1_col(u0 + u, H, il);
    return c + (lc < kFfnMmaUnits ? 0 : c3);
  }
};

// grid (tiles * rblocks, ks), 256 threads, swab_smem_bytes<NT, BITS, 256>()
// of dynamic shared memory. x (M, K) bf16, M <= 8 NT for NT < 8, any M at
// NT 8: rblocks = ceil(M / 64) row blocks of at most 64 rows, the row
// blocks of one column tile adjacent on grid x (blockIdx.x = tile * rblocks
// + rb), so they run side by side and the later ones find the weight tile
// they all read in L2. q / s rows of `ncols` columns
// (phase A: w13, 2H; phase B: w2, N); out (M, nout) bf16 (phase A: h, nout
// = H; phase B: y, nout = N). Split y covers slabs [y sps, (y + 1) sps) of
// the ceil(K / 64), the same split for every row block; `part` an fp32
// (rblocks, ks, min(M, 64), tiles * 256) workspace when ks > 1, `tickets`
// one zeroed counter per (row block, column tile).
template <int NT, int BITS, bool VEC, bool PHASE_A, typename S>
__global__ void __launch_bounds__(kFfnMmaThreads, kFfnCtas)
ffn_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
        const S* __restrict__ s, __nv_bfloat16* __restrict__ out, float* __restrict__ part,
        unsigned* __restrict__ tickets, int M, int K, int ncols, int nout, int gs, int il,
        int slabs_per_split) {
  constexpr int T = kFfnMmaThreads, LDC = Swab<kFfnBN>::kLdc;
  extern __shared__ __align__(16) unsigned char ffn_smem[];
  const int tid = threadIdx.x;
  int tile = blockIdx.x, tiles = gridDim.x;
  if constexpr (NT == 8) {   // row block rb: rows 64 rb .. of x, h / y, part, tickets
    const int rblocks = (M + kSwabMaxRows - 1) / kSwabMaxRows;
    const int rb = blockIdx.x % rblocks, m0 = rb * kSwabMaxRows;
    tile = blockIdx.x / rblocks;
    tiles = gridDim.x / rblocks;
    x += (size_t)m0 * K;
    out += (size_t)m0 * nout;
    part += (size_t)rb * gridDim.y * min(M, kSwabMaxRows) * tiles * kFfnBN;
    tickets += rb * tiles;
    M = min(M - m0, kSwabMaxRows);
  }
  using Cols = std::conditional_t<PHASE_A, ColsW13, ColsRange>;
  const Cols cols = [&] {
    if constexpr (PHASE_A) return ColsW13(tile * kFfnMmaUnits, nout, il);
    else return ColsRange{tile * kFfnBN, nout};
  }();
  const float* C = swab_tile<NT, BITS, VEC, kFfnBN>(x, q, s, part, tickets, M, K, ncols, gs,
                                                    slabs_per_split, cols, ffn_smem, tile,
                                                    tiles);
  if (C == nullptr) return;   // another split of this tile adds the partials

  if constexpr (PHASE_A) {
    // h = silu(a) * c in fp32, rounded to bf16 (ffn.py:170)
    for (int i = tid; i < M * kFfnMmaUnits; i += T) {
      const int m = i / kFfnMmaUnits, u = i % kFfnMmaUnits;
      const int j = tile * kFfnMmaUnits + u;
      if (j >= nout) continue;
      const float a = C[m * LDC + u], b = C[m * LDC + kFfnMmaUnits + u];
      out[(size_t)m * nout + j] = __float2bfloat16_rn(a * (1.f / (1.f + expf(-a))) * b);
    }
  } else {
    for (int i = tid; i < M * kFfnBN; i += T) {
      const int m = i / kFfnBN, lc = i % kFfnBN;
      const int n = tile * kFfnBN + lc;
      if (n < nout) out[(size_t)m * nout + n] = __float2bfloat16_rn(C[m * LDC + lc]);
    }
  }
}

// grid x = tiles * rblocks (NT 8; 1 row block for NT < 8)
template <int NT, int BITS, bool VEC, bool PHASE_A, typename S>
cudaError_t launch_ffn_mma(const void* x, const void* q, const void* s, void* out, void* part,
                           void* tickets, int M, int K, int ncols, int nout, int gs, int il,
                           int tiles, int ks, int sps, int rblocks, cudaStream_t stream) {
  constexpr size_t smem = swab_smem_bytes<NT, BITS, kFfnBN>();
  auto kern = ffn_mma<NT, BITS, VEC, PHASE_A, S>;
  static SmemOptIn opt_in;   // one attribute call an instantiation and device
  const cudaError_t e = opt_in.set(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(tiles * rblocks, ks), kFfnMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const S*>(s), static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
      static_cast<unsigned*>(tickets), M, K, ncols, nout, gs, il, sps);
  return cudaGetLastError();
}

// The form for M rows: the smallest NT that holds them (1 / 2 / 4 n8
// tiles), else NT 8 over ceil(M / 64) row blocks ("rows" above 64). A
// `rblocks` other than that raises cudaErrorInvalidValue.
template <int BITS, bool VEC, bool PHASE_A, typename S>
cudaError_t launch_ffn_mma_nt(const void* x, const void* q, const void* s, void* out, void* part,
                              void* tickets, int M, int K, int ncols, int nout, int gs, int il,
                              int tiles, int ks, int sps, int rblocks, cudaStream_t st) {
  if (M < 1 || rblocks != (M + kSwabMaxRows - 1) / kSwabMaxRows) return cudaErrorInvalidValue;
  if (M <= 8)
    return launch_ffn_mma<1, BITS, VEC, PHASE_A, S>(x, q, s, out, part, tickets, M, K, ncols,
                                                    nout, gs, il, tiles, ks, sps, 1, st);
  if (M <= 16)
    return launch_ffn_mma<2, BITS, VEC, PHASE_A, S>(x, q, s, out, part, tickets, M, K, ncols,
                                                    nout, gs, il, tiles, ks, sps, 1, st);
  if (M <= 32)
    return launch_ffn_mma<4, BITS, VEC, PHASE_A, S>(x, q, s, out, part, tickets, M, K, ncols,
                                                    nout, gs, il, tiles, ks, sps, 1, st);
  return launch_ffn_mma<8, BITS, VEC, PHASE_A, S>(x, q, s, out, part, tickets, M, K, ncols,
                                                  nout, gs, il, tiles, ks, sps, rblocks, st);
}

template <int BITS, typename S>
cudaError_t launch_ffn_mma_bits(bool vec, bool phase_a, const void* x, const void* q,
                                const void* s, void* out, void* part, void* tickets, int M, int K,
                                int ncols, int nout, int gs, int il, int tiles, int ks, int sps,
                                int rb, cudaStream_t st) {
  if (phase_a)
    return vec ? launch_ffn_mma_nt<BITS, true, true, S>(x, q, s, out, part, tickets, M, K,
                                                        ncols, nout, gs, il, tiles, ks, sps, rb,
                                                        st)
               : launch_ffn_mma_nt<BITS, false, true, S>(x, q, s, out, part, tickets, M, K,
                                                         ncols, nout, gs, il, tiles, ks, sps, rb,
                                                         st);
  return vec ? launch_ffn_mma_nt<BITS, true, false, S>(x, q, s, out, part, tickets, M, K, ncols,
                                                       nout, gs, il, tiles, ks, sps, rb, st)
             : launch_ffn_mma_nt<BITS, false, false, S>(x, q, s, out, part, tickets, M, K, ncols,
                                                        nout, gs, il, tiles, ks, sps, rb, st);
}

// CTAs an SM that ffn_mma<NT, BITS, VEC, PHASE_A, S> gets (occupancy API,
// with its dynamic shared memory opted into)
template <int NT, int BITS, bool VEC, bool PHASE_A, typename S>
cudaError_t ffn_mma_occupancy(int* ctas) {
  constexpr size_t smem = swab_smem_bytes<NT, BITS, kFfnBN>();
  auto kern = ffn_mma<NT, BITS, VEC, PHASE_A, S>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern, kFfnMmaThreads, smem);
}

template <int BITS, bool VEC, bool PHASE_A, typename S>
cudaError_t ffn_mma_occupancy_nt(int nt, int* ctas) {
  if (nt == 1) return ffn_mma_occupancy<1, BITS, VEC, PHASE_A, S>(ctas);
  if (nt == 2) return ffn_mma_occupancy<2, BITS, VEC, PHASE_A, S>(ctas);
  if (nt == 4) return ffn_mma_occupancy<4, BITS, VEC, PHASE_A, S>(ctas);
  if (nt == 8) return ffn_mma_occupancy<8, BITS, VEC, PHASE_A, S>(ctas);
  return cudaErrorInvalidValue;
}

template <int BITS, typename S>
cudaError_t ffn_mma_occupancy_bits(int nt, bool vec, bool phase_a, int* ctas) {
  if (vec)
    return phase_a ? ffn_mma_occupancy_nt<BITS, true, true, S>(nt, ctas)
                   : ffn_mma_occupancy_nt<BITS, true, false, S>(nt, ctas);
  return phase_a ? ffn_mma_occupancy_nt<BITS, false, true, S>(nt, ctas)
                 : ffn_mma_occupancy_nt<BITS, false, false, S>(nt, ctas);
}

}  // namespace rama

// Every entry takes the scales' dtype `sdt` (a DType code: f32 or bf16;
// common.cuh) beside the activations'.
// The simt body. Phase 1: h = silu(x @ W1) * (x @ W3). Phase 2 (rama_ffn_w2)
// is the qmv GEMV over h. The wrapper launches both on one stream. `bits` 8 or 4
// per weight; `bps` K blocks per split (scale groups for int8, packing
// blocks for int4).
extern "C" int rama_ffn_w13(const void* x, const void* q13, const void* s13, void* h,
                            void* part, void* tickets, int M, int K, int H, int gs,
                            int il, int ks, int bps, int bits, int dtype, int sdt,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rama::kBF16)
    return static_cast<int>(rama::launch_w13_bits<__nv_bfloat16>(
        bits, sdt, x, q13, s13, h, part, tickets, M, K, H, gs, il, ks, bps, st));
  if (dtype == rama::kF32)
    return static_cast<int>(rama::launch_w13_bits<float>(
        bits, sdt, x, q13, s13, h, part, tickets, M, K, H, gs, il, ks, bps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rama_ffn_w2(const void* h, const void* q2, const void* s2, void* y,
                           void* part, void* tickets, int M, int H, int N, int gs, int ks,
                           int bps, int bits, int dtype, int sdt, void* stream) {
  return static_cast<int>(rama::launch_qmv_dtype(bits, dtype, sdt, h, q2, s2, y, part, tickets,
                                                 M, H, N, gs, ks, bps,
                                                 static_cast<cudaStream_t>(stream)));
}

// The bf16 tensor-core body, one phase a call: phase_a 1 is x (M, K) @ w13
// (ncols = 2H columns, plain or il-interleaved) -> h (M, nout = H) =
// silu(a) * c; phase_a 0 is h (M, K = H) @ w2 -> y (M, nout = N). `tiles`
// column tiles (128 hidden units or 256 output columns), `ks` K splits of
// `sps` 64-row slabs, `rblocks` = ceil(M / 64) row blocks, `part` an fp32
// (rblocks, ks, min(M, 64), tiles * 256) workspace when ks > 1, `tickets`
// one zeroed counter per (row block, tile). `vec` (the cp.async path): the
// weight's rows, x's rows and every pointer 16-byte aligned, the column map
// whole on 16-column runs, gs a multiple of 16 dividing, or a multiple of,
// a slab's 64 weight rows (int4: 32 byte rows). Any M >= 1.
extern "C" int rama_ffn_mma(const void* x, const void* q, const void* s, void* out, void* part,
                            void* tickets, int M, int K, int ncols, int nout, int gs, int il,
                            int bits, int phase_a, int tiles, int ks, int sps, int rblocks,
                            int vec, int sdt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rama::with_scale_type(sdt, [&](auto t) {
    using S = typename decltype(t)::type;
    if (bits == 8)
      return rama::launch_ffn_mma_bits<8, S>(vec != 0, phase_a != 0, x, q, s, out, part, tickets,
                                             M, K, ncols, nout, gs, il, tiles, ks, sps, rblocks,
                                             st);
    if (bits == 4)
      return rama::launch_ffn_mma_bits<4, S>(vec != 0, phase_a != 0, x, q, s, out, part, tickets,
                                             M, K, ncols, nout, gs, il, tiles, ks, sps, rblocks,
                                             st);
    return cudaErrorInvalidValue;
  }));
}

// The CTAs an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of the
// tensor-core body's form with `nt` n8 tiles (1, 2, 4, 8), weight bits,
// path (vec), phase and scale type, into ctas[0]; launches nothing.
extern "C" int rama_ffn_mma_occupancy(int nt, int bits, int vec, int phase_a, int sdt,
                                      int* ctas) {
  return static_cast<int>(rama::with_scale_type(sdt, [&](auto t) {
    using S = typename decltype(t)::type;
    if (bits == 8) return rama::ffn_mma_occupancy_bits<8, S>(nt, vec != 0, phase_a != 0, ctas);
    if (bits == 4) return rama::ffn_mma_occupancy_bits<4, S>(nt, vec != 0, phase_a != 0, ctas);
    return cudaErrorInvalidValue;
  }));
}
