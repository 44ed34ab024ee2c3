// Quantized weight slabs for the bf16 tensor-core bodies: the quantized GEMM
// (qmm_mma, quant_matmul.cu) and the fused FFN (ffn_mma, ffn.cu).
//
// A slab is 64 logical K rows of 128 (or 256) weight columns: int8, 64 byte rows;
// int4, 32 packed byte rows whose low nibbles are the slab's rows 0..31 and
// high nibbles rows 32..63, with x's matching columns gathered in the same
// order (the block-split layout of qmv.cuh: byte row j of packing block b
// holds logical rows 2b*gs + j and 2b*gs + gs + j). Which global column a
// slab's column lc is comes from a column map (`Cols`): lc itself plus a
// tile offset for the GEMM; a W1 and a W3 column of the same hidden unit
// for the FFN's up-projection. A map returns -1 for a column past the
// weight's edge; such columns are zeros.
//
//  - slab_load: x's columns of the slab (R rows of x, bf16) into an x tile,
//    and on the cp.async path (VEC) the slab's raw weight bytes and its
//    scale rows (at most 4) into shared memory, 16 bytes a copy, zero-filled
//    past M, K and the map's edge. Scale rows are staged as stored (S: 4
//    f32 or 8 bf16 a copy) and turned into f32 where a body reads them
//    (lds_scale2 / load8<false>, common.cuh). A stage keeps room for f32
//    rows, 4 x 128 x 4 = 2,048 bytes (4,096 at 256 columns), whichever S:
//    bf16 rows fill half of it, so shared memory, occupancy and every
//    split plan are the same for both scale types. The masked path (VEC
//    false) loads the x tile with plain loads and leaves the weight to
//    dequant (or to slab_raw_masked, for a body that converts bytes in
//    registers).
//  - slab_dequant: the slab as bf16(float(q) * s) -- exactly dequantize()'s
//    rounding -- in a bf16 [64][128 + 8] tile, the layout ldmatrix(.trans)
//    reads without bank conflicts.
//
// VEC needs the weight's rows, the x rows and every pointer 16-byte
// aligned, the map to give 16 consecutive global columns for each 16
// aligned slab columns, and gs a multiple of 16 that divides, or is a
// multiple of, a slab's 64 weight rows (int4: 32 byte rows), so a thread's
// scale row within a slab is the same in every slab.
#pragma once

#include "mma.cuh"
#include "qmv.cuh"

namespace rama {

constexpr int kMmaBN = 128;          // weight columns a slab
constexpr int kMmaBK = 64;           // logical K rows a slab
constexpr int kMmaLdx = kMmaBK + 8;  // x tile row stride (bf16)
constexpr int kMmaLdw = kMmaBN + 8;  // dequantized tile row stride (bf16)
constexpr int kMmaScaleRows = 4;     // scale rows a slab touches at most (cp.async path)

// Raw weight bytes of one slab: 64 int8 rows or 32 packed int4 byte rows.
template <int BITS> __host__ __device__ constexpr int mma_q_rows() {
  return BITS == 8 ? kMmaBK : kMmaBK / 2;
}

// Shared bytes of one raw stage: the slab's weight bytes and scale rows
// (room for f32 rows, whichever the scale type).
template <int BITS> constexpr size_t slab_raw_bytes() {
  return (size_t)mma_q_rows<BITS>() * kMmaBN + (size_t)kMmaScaleRows * kMmaBN * 4;
}

// The GEMM's column map: columns n0 .. n0 + 127 of an N-wide weight.
struct ColsRange {
  int n0, n;
  __device__ __forceinline__ int operator()(int lc) const { return n0 + lc < n ? n0 + lc : -1; }
};

// Integer bytes to exact floats without the quarter-rate I2F: a biased
// byte u = b + 128 spliced under the exponent of 2^23 by one PRMT is the
// float 2^23 + u; one FADD takes the bias away.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)) - 8388736.f;
}
// The same for the 4 low and 4 high nibbles of a word (byte c: lo[c] in
// bits 8c..8c+3, hi[c] in 8c+4..8c+7), biased by 8.
__device__ __forceinline__ void i4x8_to_f32(uint32_t w, float* lo, float* hi) {
  const uint32_t ul = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t uh = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = __uint_as_float(__byte_perm(ul, 0x4B000000u, 0x7650 + j)) - 8388616.f;
    hi[j] = __uint_as_float(__byte_perm(uh, 0x4B000000u, 0x7650 + j)) - 8388616.f;
  }
}

// 8 dequantized weights as 8 bf16 (16 bytes) at dst.
__device__ __forceinline__ void store_bf16x8(__nv_bfloat16* dst, const float* w) {
  uint4 v;
  v.x = pack_bf16(w[0], w[1]);
  v.y = pack_bf16(w[2], w[3]);
  v.z = pack_bf16(w[4], w[5]);
  v.w = pack_bf16(w[6], w[7]);
  *reinterpret_cast<uint4*>(dst) = v;
}

// The logical K row (x's column) of row kk of slab sl; for int4 byte row
// r = sl * 32 + kk % 32 of packing block r / gs, its low (kk < 32) or high
// nibble.
template <int BITS> __device__ __forceinline__ int slab_x_col(int sl, int kk, int gs) {
  if constexpr (BITS == 8) {
    return sl * kMmaBK + kk;
  } else {
    const int r = sl * (kMmaBK / 2) + (kk & 31);
    return r + (r / gs + (kk >> 5)) * gs;
  }
}

// Whether row kk of slab sl lies inside K (int4: its byte row inside K / 2).
template <int BITS> __device__ __forceinline__ bool slab_row_ok(int sl, int kk, int K) {
  return BITS == 8 ? sl * kMmaBK + kk < K : sl * (kMmaBK / 2) + (kk & 31) < K / 2;
}

// Slab sl: rows m0 .. m0 + R - 1 of x (M, K) into the x tile xd [R][kMmaLdx];
// on the cp.async path its raw bytes of q (rows of N bytes) into qd
// [QR][QLD] and its scale rows of s (rows of N scales S) into sd [4][BN].
// T threads, this one tid.
// BN: the slab's weight columns (128, or 256 for a wider tile); QLD: the
// raw tile's row stride in bytes (the scale rows' stride is BN scales).
template <int BITS, bool VEC, int R, int T, int BN = kMmaBN, int QLD = BN, class Cols,
          typename S>
__device__ __forceinline__ void slab_load(int sl, const __nv_bfloat16* __restrict__ x, int m0,
                                          int M, int K, const int8_t* __restrict__ q,
                                          const S* __restrict__ s, int N, int gs,
                                          const Cols& cols, __nv_bfloat16* xd, int8_t* qd,
                                          S* sd, int tid) {
  constexpr int QR = mma_q_rows<BITS>();
  if constexpr (VEC) {
#pragma unroll
    for (int c = tid; c < R * (kMmaBK / 8); c += T) {
      const int row = c / (kMmaBK / 8), kk = (c % (kMmaBK / 8)) * 8;
      const int m = m0 + row;
      const bool ok = m < M && slab_row_ok<BITS>(sl, kk, K);
      const int col = ok ? slab_x_col<BITS>(sl, kk, gs) : 0;
      cp_async16_zfill(xd + row * kMmaLdx + kk, x + (size_t)(ok ? m : 0) * K + col, ok);
    }
    const int qrows = BITS == 8 ? K : K / 2;
#pragma unroll
    for (int c = tid; c < QR * (BN / 16); c += T) {
      const int row = c / (BN / 16), lc = (c % (BN / 16)) * 16;
      const int gr = sl * QR + row, n = cols(lc);
      const bool ok = gr < qrows && n >= 0;
      cp_async16_zfill(qd + row * QLD + lc, ok ? q + (size_t)gr * N + n : q, ok);
    }
    // scale rows sg0 .. sg0 + nr - 1 (int4: the two rows of each block),
    // SC scales a copy
    constexpr int SC = 16 / sizeof(S);
    const int span = QR;
    const int srows = gs < span ? span / gs : 1;
    const int b0 = sl * QR / gs;
    const int sg0 = BITS == 8 ? b0 : 2 * b0;
    const int nr = (BITS == 8 ? 1 : 2) * min(srows, qrows / gs - b0);
    for (int c = tid; c < nr * (BN / SC); c += T) {
      const int row = c / (BN / SC), lc = (c % (BN / SC)) * SC;
      const int n = cols(lc);
      const bool ok = n >= 0;
      cp_async16_zfill(sd + row * BN + lc, ok ? s + (size_t)(sg0 + row) * N + n : s, ok);
    }
  } else {
    for (int i = tid; i < R * kMmaBK; i += T) {
      const int row = i / kMmaBK, kk = i % kMmaBK;
      const int m = m0 + row;
      const bool ok = m < M && slab_row_ok<BITS>(sl, kk, K);
      xd[row * kMmaLdx + kk] =
          ok ? x[(size_t)m * K + slab_x_col<BITS>(sl, kk, gs)] : __float2bfloat16_rn(0.f);
    }
  }
}

// The masked path's raw weight bytes of slab sl into qd [QR][QLD] (zeros
// past K and the map's edge), for a body that converts them in registers.
template <int BITS, int BN, int QLD, int T, class Cols>
__device__ __forceinline__ void slab_raw_masked(int sl, const int8_t* __restrict__ q, int N,
                                                int K, const Cols& cols, int8_t* qd, int tid) {
  constexpr int QR = mma_q_rows<BITS>();
  const int qrows = BITS == 8 ? K : K / 2;
  for (int i = tid; i < QR * BN; i += T) {
    const int row = i / BN, lc = i % BN;
    const int gr = sl * QR + row, n = cols(lc);
    qd[row * QLD + lc] = gr < qrows && n >= 0 ? q[(size_t)gr * N + n] : int8_t(0);
  }
}

// Slab sl -> wd [64][kMmaLdw] as bf16(float(q) * s); zeros past K and the
// map's edge. The cp.async path reads the raw stage qs / ss, the masked
// path q and s in global memory. A thread keeps one 8-column group for
// all its chunks (T a multiple of 16), so where one scale row serves the
// whole slab (gs >= its weight rows) it reads the scales once.
template <int BITS, bool VEC, int T, class Cols, typename S>
__device__ __forceinline__ void slab_dequant(int sl, const int8_t* qs, const S* ss,
                                             const int8_t* __restrict__ q,
                                             const S* __restrict__ s, int N, int K, int gs,
                                             const Cols& cols, __nv_bfloat16* wd, int tid) {
  constexpr int QR = mma_q_rows<BITS>();
  constexpr int DQ = (QR * kMmaBN / 8 + T - 1) / T;   // 8-byte chunks a thread dequantizes
  static_assert(T % (kMmaBN / 8) == 0, "a thread's column group must be fixed");
  const int qrows = BITS == 8 ? K : K / 2;
  const bool one_srow = gs >= QR;
  float sc[BITS == 8 ? 8 : 16];   // int4: the low nibbles' scales, then the high
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    const int c = tid + i * T;
    if (DQ * T > QR * (kMmaBN / 8) && c >= QR * (kMmaBN / 8)) break;
    const int row = c / (kMmaBN / 8), col = (c % (kMmaBN / 8)) * 8;
    const int gr = sl * QR + row;   // weight row (int4: byte row)
    if constexpr (VEC) {
      if (i == 0 || !one_srow) {
        const int srow = (gs < QR ? row / gs : 0) * (BITS == 8 ? 1 : 2);
#pragma unroll
        for (int h = 0; h < (BITS == 8 ? 1 : 2); ++h)
          load8<false>(ss + (srow + h) * kMmaBN + col, sc + 8 * h);
      }
    }
    if constexpr (BITS == 8) {
      float w[8];
      if (gr >= qrows) {
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = 0.f;
      } else if constexpr (VEC) {
        const uint2 v = *reinterpret_cast<const uint2*>(qs + row * kMmaBN + col);
        i8x4_to_f32(v.x, w);
        i8x4_to_f32(v.y, w + 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] *= sc[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = cols(col + j);
          w[j] = n >= 0 ? static_cast<float>(q[(size_t)gr * N + n]) *
                              to_f(s[(size_t)(gr / gs) * N + n])
                        : 0.f;
        }
      }
      store_bf16x8(wd + row * kMmaLdw + col, w);
    } else {
      float lo[8], hi[8];
      if (gr >= qrows) {
#pragma unroll
        for (int j = 0; j < 8; ++j) lo[j] = hi[j] = 0.f;
      } else if constexpr (VEC) {
        const uint2 v = *reinterpret_cast<const uint2*>(qs + row * kMmaBN + col);
        i4x8_to_f32(v.x, lo, hi);
        i4x8_to_f32(v.y, lo + 4, hi + 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          lo[j] *= sc[j];
          hi[j] *= sc[8 + j];
        }
      } else {
        const int g = 2 * (gr / gs);   // scale row of the low nibble
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = cols(col + j);
          lo[j] = hi[j] = 0.f;
          if (n >= 0) {
            unpack_int4x1(q[(size_t)gr * N + n], lo[j], hi[j]);
            lo[j] *= to_f(s[(size_t)g * N + n]);
            hi[j] *= to_f(s[(size_t)(g + 1) * N + n]);
          }
        }
      }
      store_bf16x8(wd + row * kMmaLdw + col, lo);
      store_bf16x8(wd + (row + QR) * kMmaLdw + col, hi);
    }
  }
}

}  // namespace rama
