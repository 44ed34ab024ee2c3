// The swap-AB tensor-core body for decode M (up to 64 rows a CTA), shared
// by the FFN's ffn_mma (ffn.cu: K3, both phases, any M as row blocks of
// 64) and the quantized matmul's qmv_mma (quant_matmul.cu: K1 / K2 at M <=
// 32).
//
// One CTA computes x (M, K) @ dequant(W) over BN weight columns (a column
// map `Cols`, qslab.cuh) and one split of K, with mma.sync m16n8k16 in the
// swap-AB orientation: the weight's columns are the 16-row side and the
// M <= 64 tokens the n8 side (NT = 1, 2, 4 or 8 n8 tiles), so one CTA holds
// every row of x and each weight byte is read once a call. A warp owns 32
// columns as two m16 tiles (BN threads a CTA); its accumulators are 2 x NT
// x 4 floats a thread. K walks in slabs of 64 logical rows that qslab.cuh
// copies into a cp.async ring (swab_ahead slabs in flight: x's rows,
// the raw weight bytes, the scale rows as stored: f32 or bf16, S).
// ldmatrix.trans reads the raw bytes
// straight into A-fragment order (two weight columns' k pairs a register)
// and each thread turns them into exact bf16(float(q) * s) in registers --
// no dequantized tile goes through shared memory, no second barrier; x's
// rows are the B fragments. K is split across CTAs (gridDim.y) in whole
// slabs and whole K blocks; each split's fp32 partial goes to a workspace
// and the last CTA of a column tile (an integer ticket) adds them in split
// order, so reruns are bit for bit, and a row's sums do not depend on the
// other rows of its CTA (each n8 tile accumulates on its own): the same
// split plan gives a row the same bits at any NT. The masked path (VEC
// false: a width or group size off the 16-byte grid) loads with plain
// masked reads into the same tiles.
//
// Fragments: warp w owns slab columns 32 w .. 32 w + 31 as two m16 tiles;
// in tile i (columns 32 w + 16 i ..) MMA row g is column 32 w + 16 i + 2 g
// and row g + 8 the column after it. ldmatrix.trans of the raw [k][n]
// bytes (8 rows of 16 bytes a matrix, read as b16) gives lane (g, c) the
// bytes (k 2c, n 2g), (2c, 2g + 1), (2c + 1, 2g), (2c + 1, 2g + 1) of a
// matrix in one register: bytes 0 and 2 are row g's k pair, bytes 1 and 3
// row g + 8's. They become bf16(float(q) * s) in registers (int4: each
// byte's low nibble feeds a k16 step of the slab's first half, its high
// nibble the matching step of the second).
#pragma once

#include "qslab.cuh"

namespace rama {

constexpr int kSwabAhead = 3;   // slabs in flight while one is multiplied
constexpr int kSwabMaxRows = 64;   // rows of x a CTA holds (NT 8)

// Slabs in flight: kSwabAhead, but two for the 64-row int8 form, whose
// 30,720-byte stages would leave room for one CTA an SM in a ring of four
// (3 x 30,720 = 92,160 bytes: two CTAs an SM, as every other form).
template <int NT, int BITS> __host__ __device__ constexpr int swab_ahead() {
  return NT == 8 && BITS == 8 ? 2 : kSwabAhead;
}

// Shared-memory strides of a BN-column CTA (BN threads: a warp per 32 columns).
template <int BN> struct Swab {
  static constexpr int kThreads = BN;
  static constexpr int kLdq = BN + 16;   // raw tile row stride (bytes): ldmatrix rows
                                         // land on distinct banks
  static constexpr int kLdc = BN + 4;    // epilogue tile row stride (floats)
};

// Rows of the x tile: NT n8 tiles, read by ldmatrix in pairs.
template <int NT> __host__ __device__ constexpr int swab_x_rows() { return NT < 2 ? 16 : NT * 8; }

// One stage of the ring: the slab's x tile, raw weight bytes and scale rows
// (room for f32 rows whichever the scale type: qslab.cuh).
template <int NT, int BITS, int BN> __host__ __device__ constexpr int swab_stage_bytes() {
  return swab_x_rows<NT>() * kMmaLdx * 2 + mma_q_rows<BITS>() * Swab<BN>::kLdq +
         kMmaScaleRows * BN * 4;
}

template <int NT, int BITS, int BN> constexpr size_t swab_smem_bytes() {
  constexpr size_t ring =
      (size_t)(swab_ahead<NT, BITS>() + 1) * swab_stage_bytes<NT, BITS, BN>();
  constexpr size_t epi = (size_t)swab_x_rows<NT>() * Swab<BN>::kLdc * 4;
  return ring > epi ? ring : epi;
}

// Two bf16 of one A fragment register: (k, k + 1) of one weight column.
__device__ __forceinline__ uint32_t pack_ab(float a, float sa, float b, float sb) {
  return pack_bf16(a * sa, b * sb);
}

// The CTA's (M, BN) product over split blockIdx.y of K, column tile
// `tile` of `tiles`: slabs [y sps, (y + 1) sps) of the ceil(K / 64). x (M,
// K) bf16, M <= 8 NT; q / s rows of `ncols` columns (s f32 or bf16: S);
// `part` an fp32 (ks, M, tiles * BN) workspace when ks = gridDim.y > 1,
// `tickets` one zeroed counter per column tile; smem swab_smem_bytes<NT,
// BITS, BN>() of dynamic shared memory. Returns the full fp32 sums C[m][lc] (row stride
// Swab<BN>::kLdc, in smem) to the CTA that holds them -- the only split,
// or the last of the column tile to finish -- and nullptr to the others.
template <int NT, int BITS, bool VEC, int BN, class Cols, typename S>
__device__ __forceinline__ const float* swab_tile(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const S* __restrict__ s, float* __restrict__ part, unsigned* __restrict__ tickets,
    int M, int K, int ncols, int gs, int slabs_per_split, const Cols& cols,
    unsigned char* smem, int tile, int tiles) {
  constexpr int T = Swab<BN>::kThreads, P = swab_ahead<NT, BITS>(), RS = P + 1;
  constexpr int LDQ = Swab<BN>::kLdq, LDC = Swab<BN>::kLdc;
  constexpr int XR = swab_x_rows<NT>();
  constexpr int QR = mma_q_rows<BITS>();
  constexpr int STAGE = swab_stage_bytes<NT, BITS, BN>();
  __shared__ bool is_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int split = blockIdx.y, ks = gridDim.y;
  const int nslabs = (K + kMmaBK - 1) / kMmaBK;
  const int s_begin = split * slabs_per_split;
  const int nt = min(nslabs, s_begin + slabs_per_split) - s_begin;
  const int qrows = BITS == 8 ? K : K / 2;
  // this thread's weight columns: lc0 + 16 i and the one after it, i = 0, 1
  const int lc0 = warp * 32 + 2 * g;
  int nc[2][2];   // their global columns (the masked path's scale reads)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) nc[i][e] = VEC ? 0 : cols(lc0 + 16 * i + e);

  auto x_tile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * STAGE);
  };
  auto q_tile = [&](int st) { return reinterpret_cast<int8_t*>(smem + st * STAGE) +
                                     XR * kMmaLdx * 2; };
  auto s_tile = [&](int st) {
    return reinterpret_cast<S*>(q_tile(st) + QR * LDQ);
  };
  auto load = [&](int t) {
    const int st = t % RS;
    slab_load<BITS, VEC, XR, T, BN, LDQ>(s_begin + t, x, 0, M, K, q, s, ncols, gs, cols,
                                         x_tile(st), q_tile(st), s_tile(st), tid);
    if constexpr (!VEC) slab_raw_masked<BITS, BN, LDQ, T>(s_begin + t, q, ncols, K, cols,
                                                         q_tile(st), tid);
  };

  // The scales of this thread's two columns of tile i for slab rows kk
  // (its k pair kk, kk + 1): (s0 at kk, s0 at kk + 1, s1 at kk, s1 at
  // kk + 1), in f32. The cp.async path reads the staged rows (one row
  // serves a whole k16 step: gs a multiple of 16); the masked path reads s
  // in global memory, zero past K.
  const int gshift = gs < QR ? __ffs(gs) - 1 : 31;
  auto scales = [&](int sl, const S* ss, int i, int kk, float* sc) {
    const int n0 = nc[i][0], n1 = nc[i][1];
    if constexpr (VEC) {
      int row;   // gs is 16 or 32 (a shift) or spans the slab (row 0)
      if constexpr (BITS == 8) row = kk >> gshift;
      else row = 2 * ((kk & 31) >> gshift) + (kk >> 5);
      const float2 v = lds_scale2(ss + row * BN + lc0 + 16 * i);
      sc[0] = sc[1] = v.x;
      sc[2] = sc[3] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int srow;
        bool ok;
        if constexpr (BITS == 8) {
          const int k = sl * kMmaBK + kk + i;
          ok = k < K;
          srow = k / gs;
        } else {
          const int r = sl * QR + ((kk + i) & 31);
          ok = r < qrows;
          srow = 2 * (r / gs) + (kk >> 5);
        }
        sc[i] = ok && n0 >= 0 ? to_f(s[(size_t)srow * ncols + n0]) : 0.f;
        sc[2 + i] = ok && n1 >= 0 ? to_f(s[(size_t)srow * ncols + n1]) : 0.f;
      }
    }
  };
  // A fragment halves from one ldmatrix register's four weights f (bytes
  // 0..3 as above) at slab rows kk, kk + 1: row g's pair, row g + 8's pair.
  auto frag = [&](const float* f, const float* sc, uint32_t& ra, uint32_t& rb) {
    ra = pack_ab(f[0], sc[0], f[2], sc[1]);
    rb = pack_ab(f[1], sc[2], f[3], sc[3]);
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // k16 step j of slab t: A of both m16 tiles from the converted registers,
  // B from x (each B fragment feeds both tiles)
  auto mma_step = [&](const __nv_bfloat16* xs, int j, const uint32_t (&af)[2][4]) {
#pragma unroll
    for (int p = 0; p < (NT + 1) / 2; ++p) {
      uint32_t bf[4];
      ldsm_x4(bf, xs + (p * 16 + lane % 8 + (lane / 16) * 8) * kMmaLdx + j * 16 +
                      ((lane / 8) % 2) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * p], af[i], bf[0], bf[1]);
        if (2 * p + 1 < NT) mma_bf16(acc[i][2 * p + 1], af[i], bf[2], bf[3]);
      }
    }
  };

  // The ring: P slabs in flight while slab t is multiplied; one barrier a
  // slab (it also frees the stage slab t + P overwrites, slab t - 1's).
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < nt) load(i);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<P - 1>();   // slab t (this thread's copies) has landed
    __syncthreads();          // everyone's; every warp is done with slab t - 1
    if (t + P < nt) load(t + P);
    cp_async_commit();
    const int sl = s_begin + t, st = t % RS;
    const __nv_bfloat16* xs = x_tile(st);
    const int8_t* qs = q_tile(st);
    const S* ss = s_tile(st);
    if constexpr (BITS == 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // slab rows 32 h .. 32 h + 31: k16 steps 2 h, 2 h + 1
        if (sl * kMmaBK + 32 * h >= K) break;
        uint32_t r[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4_trans(r[i], qs + (32 * h + lane) * LDQ + warp * 32 + 16 * i);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * h + jj;
          if (sl * kMmaBK + 16 * j >= K) break;
          uint32_t af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float f[4], sc[4];
            scales(sl, ss, i, 16 * j + 2 * c, sc);
            i8x4_to_f32(r[i][2 * jj], f);
            frag(f, sc, af[i][0], af[i][1]);
            if constexpr (!VEC) scales(sl, ss, i, 16 * j + 8 + 2 * c, sc);
            i8x4_to_f32(r[i][2 * jj + 1], f);
            frag(f, sc, af[i][2], af[i][3]);
          }
          mma_step(xs, j, af);
        }
      }
    } else {
      // byte rows 0..31: matrices of rows 0-7, 8-15 (k16 step 0 low
      // nibbles, step 2 high), 16-23, 24-31 (steps 1 and 3)
      uint32_t r[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_trans(r[i], qs + lane * LDQ + warp * 32 + 16 * i);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (sl * QR + 16 * jj >= qrows) break;
        float lo[2][2][4], hi[2][2][4];   // [tile][matrix half][byte]
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          i4x8_to_f32(r[i][2 * jj], lo[i][0], hi[i][0]);
          i4x8_to_f32(r[i][2 * jj + 1], lo[i][1], hi[i][1]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {   // low nibbles: step jj; high: step jj + 2
          const int j = jj + 2 * half;
          uint32_t af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float sc[4];
            scales(sl, ss, i, 16 * j + 2 * c, sc);
            frag(half ? hi[i][0] : lo[i][0], sc, af[i][0], af[i][1]);
            if constexpr (!VEC) scales(sl, ss, i, 16 * j + 8 + 2 * c, sc);
            frag(half ? hi[i][1] : lo[i][1], sc, af[i][2], af[i][3]);
          }
          mma_step(xs, j, af);
        }
      }
    }
  }

  // The CTA's (M, BN) product, fp32, into shared memory: C[m][lc]. The
  // accumulator of tile i, n8 tile j holds columns lc0 + 16 i (row g) and
  // the one after it (row g + 8) at tokens 8 j + 2 c and 8 j + 2 c + 1.
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring
  float* C = reinterpret_cast<float*>(smem);   // [XR][LDC]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = 8 * j + 2 * c, lc = lc0 + 16 * i;
      C[m * LDC + lc] = acc[i][j][0];
      C[(m + 1) * LDC + lc] = acc[i][j][1];
      C[m * LDC + lc + 1] = acc[i][j][2];
      C[(m + 1) * LDC + lc + 1] = acc[i][j][3];
    }
  __syncthreads();

  if (ks > 1) {
    // this split's partial, then the last CTA of the column tile adds the
    // ks partials in split order back into C, four columns a thread at a
    // time with four splits' loads in flight
    const size_t width = (size_t)tiles * BN, sstride = (size_t)M * width;
    float* mine = part + (size_t)tile * BN;
    for (int i = 4 * tid; i < M * BN; i += 4 * T) {
      const int m = i / BN, lc = i % BN;
      *reinterpret_cast<float4*>(mine + split * sstride + m * width + lc) =
          *reinterpret_cast<const float4*>(C + m * LDC + lc);
    }
    __threadfence();
    __syncthreads();
    unsigned* ticket = tickets + tile;
    if (tid == 0) is_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(ks - 1);
    __syncthreads();
    if (!is_last) return nullptr;
    __threadfence();
    for (int i = 4 * tid; i < M * BN; i += 4 * T) {
      const int m = i / BN, lc = i % BN;
      const float* src = mine + m * width + lc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      int sp = 0;
      for (; sp + 4 <= ks; sp += 4) {
        float4 p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          p[u] = __ldcg(reinterpret_cast<const float4*>(src + (sp + u) * sstride));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v.x += p[u].x; v.y += p[u].y; v.z += p[u].z; v.w += p[u].w;
        }
      }
      for (; sp < ks; ++sp) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(src + sp * sstride));
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      *reinterpret_cast<float4*>(C + m * LDC + lc) = v;
    }
    __syncthreads();
    if (tid == 0) *ticket = 0u;   // ready for the next launch
  }
  return C;
}

}  // namespace rama
