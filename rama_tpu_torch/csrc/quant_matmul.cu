// Kernel 1: weight-only group-quantized matmul, y = x @ dequant(W[l]),
// int8 or packed int4 weights.
//
// Replaces rama_tpu/ops/pallas/quant_matmul.py: quant_matmul_layered
// (stacked (L, K, N) weights; the layer is a pointer offset taken by the
// wrapper) and quant_matmul (one 2-D weight) -- the int8 bodies
// _kernel_int8_acc(_layered) at decode M and _kernel_int8(_layered) at
// prefill M, and the int4 bodies _kernel_int4_acc(_layered) at decode M and
// _kernel_int4(_layered) at prefill M. Each takes f32 or bf16-stored
// scales (cast_scales; the Pallas kernels upcast them in VMEM,
// quant_matmul.py:50, :75, :136, :164, :192, :214): every body here is
// instantiated for both scale types S, and turns a scale into f32 where it
// reads it, with the split plan a function of the shapes alone -- so a
// bf16-scale launch equals the same body fed scales.float() bit for bit.
//
// Bound on the H100: at decode M (up to a verify round's 32 rows) the work is ~2*M flops per
// weight (half a byte for int4), far below the card's ~295 flop/byte
// balance point, so the kernel is bound by streaming the weight bytes plus
// K*N/gs*4 scale bytes (f32; *2 for bf16-stored scales) from HBM at 3.35
// TB/s (Llama-2-7B wqkv: 50.3 MB + 3.1 MB = 16 us for int8; 25.2 MB + 3.1
// MB = 8.5 us for int4 gs 64; with bf16 scales 1.6 MB of scales). At
// prefill M (k*T rows, hundreds to thousands) it is bound by 2*M*K*N flops.
//
// Design: bf16 at M <= 32 (a decode step, a verify round of 8 slots x 4
// tokens) takes qmv_mma below, the swap-AB tensor-core body of swapab.cuh
// that K3's ffn_mma runs too: the weight's columns on mma.sync's 16-row
// side and the tokens on its n8 side (NT = 1, 2 or 4 n8 tiles), so one CTA
// holds every row of x and each weight byte is read once; the raw bytes go
// through a cp.async ring and ldmatrix.trans and become bf16(float(q) * s)
// -- exactly dequantize()'s rounding -- in registers. A CTA owns 128 or 256
// consecutive columns (4 or 8 warps) over a split of K in whole 64-row
// slabs and K blocks; the wrapper (quant_matmul.mmv_plan) picks the grid
// that fills the most of one wave of CTA slots, since with every CTA
// resident a call lasts about as long as its longest split (7B at M <= 8:
// wqkv 96 x 5, wo 32 x 16, lm_head 250 x 2 CTAs of 128 columns, four an
// SM). The last CTA of a column tile adds the split partials in split
// order (deterministic).
// fp32 activations at M <= 8 keep qmv.cuh's split-K GEMV on the CUDA cores
// -- 16-byte weight loads along N, the K range split across CTAs in whole
// scale groups (int8) or packing blocks (int4), a deterministic second-pass
// reduce of the split partials by the last CTA of each column tile; its
// dequantized weight is w = q * s in fp32 (the Pallas accscale kernels
// scale each group's partial sum instead: the same function, rounded
// differently); K14's fused wo (attn_block.cu) and the FFN's fp32 w2 share
// that body.
//
// M > 32 in bf16 takes qmm_mma below, the tensor-core body (the Pallas
// kernels' own choice at prefill M: dequantize a block to f32, round it to
// bf16, dot with fp32 accumulation, quant_matmul.py:31-35). fp32
// activations at M > 8 keep qmm_tiled: 64x64 output tiles, a 32-deep K slab
// of x and of the dequantized weight staged in shared memory, fp32 FMA on
// the CUDA cores; for int4 the slab is 16 packed byte rows unpacked into 32
// logical rows -- each byte row's low and high nibble rows side by side,
// with the matching x columns gathered beside them -- so every weight byte
// is read once; the sum over K does not care in which order the rows come.
//
// qmm_mma<BM, BITS, VEC> (BM = 32, 64 or 128 output rows, 128 columns a
// CTA; 8 warps as 2 x 4, each owning (BM / 2) x 32 of the tile as m16n8
// fragments; the slab copies and the dequantization are qslab.cuh's,
// shared with the FFN's tensor-core body in ffn.cu):
//  - K walks in slabs of 64 logical rows (int8: 64 byte rows; int4: 32
//    packed byte rows, whose low nibbles are the slab's rows 0..31 and high
//    nibbles rows 32..63, with x's matching columns gathered in the same
//    order -- two runs of whole 8-column chunks when gs is a multiple of 8).
//  - x tiles (bf16) in a ring of 3 stages, each slab's raw weight bytes and
//    scale rows (at most 4, f32 or bf16 as stored) in a ring of 2, copied
//    with cp.async 16 bytes at a time, zero-filled past M, K and N.
//  - Dequantization: each thread turns 8 weight bytes (int4: 8 bytes, 16
//    nibbles) into bf16(float(q) * s) -- exactly dequantize()'s rounding --
//    in one of two bf16 [64][128] tiles, from which ldmatrix.trans reads the
//    B fragments; x's A fragments come by ldmatrix. Rows padded by 8 bf16
//    keep both free of bank conflicts. Bytes become floats by a PRMT into
//    the mantissa of 2^23 and one FADD, not the quarter-rate I2F.
//  - One barrier a slab: in step t a warp dequantizes slab t + 1 and
//    multiplies slab t, while the copies of slab t + 2 are in flight.
//  - Small M (BM 64 up to M = 64; BM 32, which M <= 32 reaches only when
//    MMV_MAX_M is lowered, as chip_smoke.py does to time the GEMM beside
//    qmv_mma) gives few output tiles, so K is split
//    across CTAs (gridDim.z) in whole slabs and whole K blocks, about two
//    CTAs an SM; partial sums go to an fp32 workspace and the last CTA of a
//    tile (an integer ticket) adds them in split order: deterministic.
//  - VEC false (N or gs not a multiple of 16, or a pointer not
//    16-byte aligned: the tiny and stories shapes) takes the same tiles with
//    plain masked loads in place of cp.async, BM 64.
//
// Bound: at M = 32 the weight bytes (wqkv int8: 53.7 MB, 16 us); from a few
// hundred rows the bf16 tensor-core operations (2 M K N at 989 TFLOP/s).
#include "swapab.cuh"

namespace rama {

constexpr int kBM = 64, kBN = 64, kBK = 32;

// Logical K row of slab row kk (int4): slab rows 2i and 2i + 1 are the low
// and high nibble rows of byte row r0/2 + i.
__device__ __forceinline__ int int4_slab_row(int k0, int kk, int gs) {
  const int r = k0 / 2 + kk / 2;        // byte row
  const int b = r / gs, j = r - b * gs;  // packing block, row in block
  return 2 * b * gs + j + (kk & 1) * gs;
}

template <int BITS, typename S>
__global__ void __launch_bounds__(256)
qmm_tiled(const float* __restrict__ x, const int8_t* __restrict__ q,
          const S* __restrict__ s, float* __restrict__ y, int M, int K, int N, int gs) {
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
        xs[kk][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
      } else {
        const bool ok = gm < M && k0 + kk < K;
        xs[kk][m] = ok ? x[(size_t)gm * K + int4_slab_row(k0, kk, gs)] : 0.f;
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
          lo[c] *= to_f(__ldg(s + (size_t)glo * N + gn + c));
          hi[c] *= to_f(__ldg(s + (size_t)(glo + 1) * N + gn + c));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = gn + c;
          lo[c] = hi[c] = 0.f;
          if (2 * r < K && n < N) {
            unpack_int4x1(q[(size_t)r * N + n], lo[c], hi[c]);
            lo[c] *= to_f(s[(size_t)glo * N + n]);
            hi[c] *= to_f(s[(size_t)(glo + 1) * N + n]);
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
        const S* srow = s + (size_t)(gk / gs) * N + gn;
#pragma unroll
        for (int c = 0; c < 8; ++c) w[c] = static_cast<float>(b[c]) * to_f(__ldg(srow + c));
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = gn + c;
          w[c] = (gk < K && n < N)
                     ? static_cast<float>(q[(size_t)gk * N + n]) *
                           to_f(s[(size_t)(gk / gs) * N + n])
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
      if (gn < N) y[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <int BITS, typename S>
cudaError_t launch_qmm(const void* x, const void* q, const void* s, void* y, int M,
                       int K, int N, int gs, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmm_tiled<BITS, S><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const S*>(s), static_cast<float*>(y), M, K, N, gs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tensor-core body (slabs: qslab.cuh)

// Per tile height: warp rows (4 warp columns of 32 output columns each;
// kWarpRows * 128 threads), kAhead, the slabs whose copies are in flight
// while a warp dequantizes slab t + 1 and multiplies slab t, and the CTAs
// an SM holds (registers capped to fit). Shared memory holds kAhead + 2 x
// tiles, kAhead + 1 raw slabs and two bf16 weight tiles: 68 KB at BM 32
// (three CTAs an SM), 102 KB at 64 and 111 KB at 128 (two), 213 KB at 256
// (one CTA of 16 warps). Picked among 1-3 slabs ahead, 1-3 CTAs an SM and
// 8 or 16 warps by device time at the 7B shapes on the H100.
template <int BM> struct MmaCfg;
template <> struct MmaCfg<32> { static constexpr int kWarpRows = 2, kAhead = 1, kCtas = 3; };
template <> struct MmaCfg<64> { static constexpr int kWarpRows = 2, kAhead = 2, kCtas = 2; };
template <> struct MmaCfg<128> { static constexpr int kWarpRows = 2, kAhead = 1, kCtas = 2; };
template <> struct MmaCfg<256> { static constexpr int kWarpRows = 4, kAhead = 2, kCtas = 1; };

template <int BM, int BITS> constexpr size_t mma_smem_bytes() {
  constexpr int P = MmaCfg<BM>::kAhead;
  return (size_t)(P + 2) * BM * kMmaLdx * 2 +
         (size_t)(P + 1) * slab_raw_bytes<BITS>() +
         (size_t)2 * kMmaBK * kMmaLdw * 2;
}

// grid (ceil(M / BM), ceil(N / 128), ks), MmaCfg<BM>::kWarpRows * 128
// threads, mma_smem_bytes<BM, BITS>() of dynamic shared memory. Split z
// covers slabs [z sps, (z + 1) sps) of the ceil(K / 64). VEC needs gs a
// multiple of 16 that divides, or is a multiple of, the slab's 64 rows
// (int4: 32 byte rows), so a thread's scale row within a slab is the same
// in every slab.
template <int BM, int BITS, bool VEC, typename S>
__global__ void __launch_bounds__(MmaCfg<BM>::kWarpRows * 128, MmaCfg<BM>::kCtas)
qmm_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
        const S* __restrict__ s, __nv_bfloat16* __restrict__ y, float* __restrict__ part,
        unsigned* __restrict__ tickets, int M, int K, int N, int gs, int slabs_per_split) {
  constexpr int WM = MmaCfg<BM>::kWarpRows, P = MmaCfg<BM>::kAhead;
  constexpr int T = WM * 128;                // threads
  constexpr int MT = BM / (16 * WM);         // m16 tiles a warp
  constexpr int XS = P + 2, RS = P + 1;      // x stages, raw stages
  constexpr int QR = mma_q_rows<BITS>();     // weight rows (bytes) a slab
  constexpr int QB = QR * kMmaBN;
  constexpr int SB = kMmaScaleRows * kMmaBN * 4 / sizeof(S);   // a stage's f32-sized room
  extern __shared__ __align__(16) unsigned char qmm_smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(qmm_smem);   // [XS][BM][LDX]
  __nv_bfloat16* Ws = Xs + XS * BM * kMmaLdx;                         // [2][BK][LDW]
  S* Ss = reinterpret_cast<S*>(Ws + 2 * kMmaBK * kMmaLdw);             // [RS][4][BN] (+ room)
  int8_t* Qs = reinterpret_cast<int8_t*>(Ss + RS * SB);                // [RS][QR][BN]
  __shared__ bool is_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m_base = blockIdx.x * BM, n_base = blockIdx.y * kMmaBN;
  const int split = blockIdx.z, ks = gridDim.z;
  const int nslabs = (K + kMmaBK - 1) / kMmaBK;
  const int s_begin = split * slabs_per_split;
  const int nt = min(nslabs, s_begin + slabs_per_split) - s_begin;
  const ColsRange cols{n_base, N};

  // slab t of the split: its x tile into x stage t % XS, its raw weight
  // bytes and scale rows into raw stage t % RS (the masked path reads the
  // weight in dequant); then into Ws[t % 2] as bf16
  auto load = [&](int t) {
    slab_load<BITS, VEC, BM, T>(s_begin + t, x, m_base, M, K, q, s, N, gs, cols,
                                Xs + (t % XS) * BM * kMmaLdx, Qs + (t % RS) * QB,
                                Ss + (t % RS) * SB, tid);
  };
  auto dequant = [&](int t) {
    slab_dequant<BITS, VEC, T>(s_begin + t, Qs + (t % RS) * QB, Ss + (t % RS) * SB, q, s, N, K,
                               gs, cols, Ws + (t % 2) * kMmaBK * kMmaLdw, tid);
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int row_w = (warp / 4) * (BM / WM), col_w = (warp % 4) * 32;

  // Software pipeline, one barrier a slab: in step t a warp dequantizes
  // slab t + 1 into one Ws buffer and multiplies slab t from the other,
  // while the copies of slabs t + 2 .. t + 1 + P are in flight; warps drift
  // apart between barriers, so the ALU work of some overlaps the MMAs of
  // others.
#pragma unroll
  for (int i = 0; i <= P; ++i) {
    if (i < nt) load(i);
    cp_async_commit();
  }
  cp_async_wait<P>();   // slab 0
  __syncthreads();
  dequant(0);
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<P - 1>();   // slab t + 1 (this thread's copies) has landed
    __syncthreads();          // everyone's; Ws[t % 2] is written, step t - 1's reads are done
    if (t + 1 + P < nt) load(t + 1 + P);
    cp_async_commit();
    if (t + 1 < nt) dequant(t + 1);
    const __nv_bfloat16* xs = Xs + (t % XS) * BM * kMmaLdx;
    const __nv_bfloat16* ws = Ws + (t % 2) * kMmaBK * kMmaLdw;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t bf[2][4];
#pragma unroll
      for (int dp = 0; dp < 2; ++dp)
        ldsm_x4_trans(bf[dp], ws + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kMmaLdw +
                                  col_w + dp * 16 + (lane / 16) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, xs + (row_w + mt * 16 + lane % 16) * kMmaLdx + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          mma_bf16(acc[mt][2 * dp], af, bf[dp][0], bf[dp][1]);
          mma_bf16(acc[mt][2 * dp + 1], af, bf[dp][2], bf[dp][3]);
        }
      }
    }
  }

  // epilogue: y (ks == 1) or this split's fp32 partial
  const int g = lane / 4, c = lane % 4;
  const bool pair = (N % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + row_w + mt * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n_base + col_w + j * 8 + 2 * c;
        const float v0 = acc[mt][j][2 * h], v1 = acc[mt][j][2 * h + 1];
        if (ks == 1) {
          __nv_bfloat16* dst = y + (size_t)m * N + n;
          if (pair && n + 1 < N) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < N) dst[0] = __float2bfloat16_rn(v0);
            if (n + 1 < N) dst[1] = __float2bfloat16_rn(v1);
          }
        } else {
          float* dst = part + ((size_t)split * M + m) * N + n;
          if (pair && n + 1 < N) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (n < N) dst[0] = v0;
            if (n + 1 < N) dst[1] = v1;
          }
        }
      }
    }
  }
  if (ks == 1) return;

  // the last CTA of this output tile adds the ks partials in split order
  __threadfence();
  __syncthreads();
  unsigned* ticket = tickets + blockIdx.x * gridDim.y + blockIdx.y;
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(ks - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < BM * kMmaBN; i += T) {
    const int m = m_base + i / kMmaBN, n = n_base + i % kMmaBN;
    if (m >= M || n >= N) continue;
    float v = 0.f;
    for (int sp = 0; sp < ks; ++sp) v += __ldcg(part + ((size_t)sp * M + m) * N + n);
    y[(size_t)m * N + n] = __float2bfloat16_rn(v);
  }
  if (tid == 0) *ticket = 0u;   // ready for the next launch
}

template <int BM, int BITS, bool VEC, typename S>
cudaError_t launch_qmm_mma(const void* x, const void* q, const void* s, void* y, void* part,
                           void* tickets, int M, int K, int N, int gs, int ks, int sps,
                           cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<BM, BITS>();
  auto kern = qmm_mma<BM, BITS, VEC, S>;
  static SmemOptIn opt_in;   // one attribute call an instantiation and device
  const cudaError_t e = opt_in.set(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, (N + kMmaBN - 1) / kMmaBN, ks);
  kern<<<grid, MmaCfg<BM>::kWarpRows * 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const S*>(s), static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
      static_cast<unsigned*>(tickets), M, K, N, gs, sps);
  return cudaGetLastError();
}

template <int BITS, typename S>
cudaError_t launch_qmm_mma_bm(int bm, bool vec, const void* x, const void* q, const void* s,
                              void* y, void* part, void* tickets, int M, int K, int N, int gs,
                              int ks, int sps, cudaStream_t st) {
  if (!vec)
    return bm == 64 ? launch_qmm_mma<64, BITS, false, S>(x, q, s, y, part, tickets, M, K, N,
                                                         gs, ks, sps, st)
                    : cudaErrorInvalidValue;
  switch (bm) {
    case 32:
      return launch_qmm_mma<32, BITS, true, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, sps,
                                               st);
    case 64:
      return launch_qmm_mma<64, BITS, true, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, sps,
                                               st);
    case 128:
      return launch_qmm_mma<128, BITS, true, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, sps,
                                                st);
    case 256:
      return launch_qmm_mma<256, BITS, true, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, sps,
                                                st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 decode body (M <= 32; swapab.cuh)

// The CTAs an SM of a BN-column CTA (BN threads): either width caps
// registers at 128 a thread.
template <int BN> struct MmvCfg;
template <> struct MmvCfg<128> { static constexpr int kCtas = 4; };
template <> struct MmvCfg<256> { static constexpr int kCtas = 2; };

// grid (ceil(N / BN), ks), BN threads, swab_smem_bytes<NT, BITS, BN>() of
// dynamic shared memory. x (M, K) bf16 with M <= 8 NT, y (M, N) bf16. Split
// y covers slabs [y sps, (y + 1) sps) of the ceil(K / 64); `part` an fp32
// (ks, M, gridDim.x * BN) workspace when ks > 1, `tickets` one zeroed
// counter per column tile.
template <int NT, int BITS, bool VEC, int BN, typename S>
__global__ void __launch_bounds__(BN, MmvCfg<BN>::kCtas)
qmv_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
        const S* __restrict__ s, __nv_bfloat16* __restrict__ y, float* __restrict__ part,
        unsigned* __restrict__ tickets, int M, int K, int N, int gs, int slabs_per_split) {
  constexpr int LDC = Swab<BN>::kLdc;
  extern __shared__ __align__(16) unsigned char mmv_smem[];
  const int n0 = blockIdx.x * BN;
  const float* C = swab_tile<NT, BITS, VEC, BN>(x, q, s, part, tickets, M, K, N, gs,
                                                slabs_per_split, ColsRange{n0, N}, mmv_smem,
                                                blockIdx.x, gridDim.x);
  if (C == nullptr) return;   // another split of this tile adds the partials
  for (int i = threadIdx.x; i < M * BN; i += BN) {
    const int m = i / BN, lc = i % BN;
    if (n0 + lc < N) y[(size_t)m * N + n0 + lc] = __float2bfloat16_rn(C[m * LDC + lc]);
  }
}

template <int NT, int BITS, bool VEC, int BN, typename S>
cudaError_t launch_qmv_mma(const void* x, const void* q, const void* s, void* y, void* part,
                           void* tickets, int M, int K, int N, int gs, int ks, int sps,
                           cudaStream_t stream) {
  constexpr size_t smem = swab_smem_bytes<NT, BITS, BN>();
  auto kern = qmv_mma<NT, BITS, VEC, BN, S>;
  static SmemOptIn opt_in;   // one attribute call an instantiation and device
  const cudaError_t e = opt_in.set(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((N + BN - 1) / BN, ks), BN, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const S*>(s), static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
      static_cast<unsigned*>(tickets), M, K, N, gs, sps);
  return cudaGetLastError();
}

template <int BITS, bool VEC, int BN, typename S>
cudaError_t launch_qmv_mma_nt(const void* x, const void* q, const void* s, void* y, void* part,
                              void* tickets, int M, int K, int N, int gs, int ks, int sps,
                              cudaStream_t st) {
  if (M <= 8)
    return launch_qmv_mma<1, BITS, VEC, BN, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, sps,
                                               st);
  if (M <= 16)
    return launch_qmv_mma<2, BITS, VEC, BN, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, sps,
                                               st);
  if (M <= 32)
    return launch_qmv_mma<4, BITS, VEC, BN, S>(x, q, s, y, part, tickets, M, K, N, gs, ks, sps,
                                               st);
  return cudaErrorInvalidValue;
}

// The masked path (vec false: tiny and stories shapes) has the 128-column CTA only.
template <int BITS, typename S>
cudaError_t launch_qmv_mma_bn(int bn, bool vec, const void* x, const void* q, const void* s,
                              void* y, void* part, void* tickets, int M, int K, int N, int gs,
                              int ks, int sps, cudaStream_t st) {
  if (!vec)
    return bn == 128 ? launch_qmv_mma_nt<BITS, false, 128, S>(x, q, s, y, part, tickets, M, K,
                                                              N, gs, ks, sps, st)
                     : cudaErrorInvalidValue;
  if (bn == 128)
    return launch_qmv_mma_nt<BITS, true, 128, S>(x, q, s, y, part, tickets, M, K, N, gs, ks,
                                                 sps, st);
  if (bn == 256)
    return launch_qmv_mma_nt<BITS, true, 256, S>(x, q, s, y, part, tickets, M, K, N, gs, ks,
                                                 sps, st);
  return cudaErrorInvalidValue;
}

}  // namespace rama

// Every entry takes the scales' dtype `sdt` (a DType code: f32 or bf16;
// common.cuh) beside the activations'.
// `bits` 8: q (K, N) int8; 4: q (K/2, N) packed int4 (K a multiple of 2*gs).
// `bps`: K blocks per split, scale groups for int8 and packing blocks for int4.
extern "C" int rama_qmv(const void* x, const void* q, const void* s, void* y, void* part,
                        void* tickets, int M, int K, int N, int gs, int ks, int bps,
                        int bits, int dtype, int sdt, void* stream) {
  return static_cast<int>(rama::launch_qmv_dtype(bits, dtype, sdt, x, q, s, y, part, tickets,
                                                 M, K, N, gs, ks, bps,
                                                 static_cast<cudaStream_t>(stream)));
}

// The fp32 CUDA-core body (M > 8): x (M, K) and y (M, N) float32.
extern "C" int rama_qmm(const void* x, const void* q, const void* s, void* y, int M,
                        int K, int N, int gs, int bits, int sdt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rama::with_scale_type(sdt, [&](auto t) {
    using S = typename decltype(t)::type;
    if (bits == 8) return rama::launch_qmm<8, S>(x, q, s, y, M, K, N, gs, st);
    if (bits == 4) return rama::launch_qmm<4, S>(x, q, s, y, M, K, N, gs, st);
    return cudaErrorInvalidValue;
  }));
}

// The bf16 tensor-core body (M > 8): x (M, K) bf16, y (M, N) bf16; `bm` 32,
// 64, 128 or 256 rows a CTA (64 when !vec); `ks` K splits of `sps` 64-row
// slabs each, `part` an fp32 (ks, M, N) workspace when ks > 1; `tickets`
// one zeroed counter per output tile. `vec` (the cp.async path): N and gs
// multiples of 16, gs a divisor or a multiple of a slab's 64 weight rows
// (int4: 32 byte rows), every pointer 16-byte aligned.
extern "C" int rama_qmm_mma(const void* x, const void* q, const void* s, void* y, void* part,
                            void* tickets, int M, int K, int N, int gs, int bits, int bm,
                            int ks, int sps, int vec, int sdt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rama::with_scale_type(sdt, [&](auto t) {
    using S = typename decltype(t)::type;
    if (bits == 8)
      return rama::launch_qmm_mma_bm<8, S>(bm, vec != 0, x, q, s, y, part, tickets, M, K, N, gs,
                                           ks, sps, st);
    if (bits == 4)
      return rama::launch_qmm_mma_bm<4, S>(bm, vec != 0, x, q, s, y, part, tickets, M, K, N, gs,
                                           ks, sps, st);
    return cudaErrorInvalidValue;
  }));
}

// The bf16 decode body (M <= 32: NT 1 / 2 / 4 n8 tiles): x (M, K)
// bf16, y (M, N) bf16; `bn` 128 or 256 columns a CTA (128 when !vec); `ks`
// K splits of `sps` 64-row slabs each, `part` an fp32 (ks, M, ceil(N / bn)
// * bn) workspace when ks > 1; `tickets` one zeroed counter per column
// tile. `vec` (the cp.async path): N and gs multiples of 16, gs a divisor
// or a multiple of a slab's 64 weight rows (int4: 32 byte rows), every
// pointer 16-byte aligned.
extern "C" int rama_qmv_mma(const void* x, const void* q, const void* s, void* y, void* part,
                            void* tickets, int M, int K, int N, int gs, int bits, int bn,
                            int ks, int sps, int vec, int sdt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rama::with_scale_type(sdt, [&](auto t) {
    using S = typename decltype(t)::type;
    if (bits == 8)
      return rama::launch_qmv_mma_bn<8, S>(bn, vec != 0, x, q, s, y, part, tickets, M, K, N, gs,
                                           ks, sps, st);
    if (bits == 4)
      return rama::launch_qmv_mma_bn<4, S>(bn, vec != 0, x, q, s, y, part, tickets, M, K, N, gs,
                                           ks, sps, st);
    return cudaErrorInvalidValue;
  }));
}
