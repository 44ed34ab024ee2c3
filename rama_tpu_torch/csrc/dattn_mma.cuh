// The tensor-core split body of the decode attention over a bf16 cache,
// shared by K4 / K9 / K10 / K12's dattn_mma kernel (decode_attention.cu,
// where its design is described) and K14's split items (attn_block.cu):
// one CTA of kDaThreads threads scores the query rows of one (slot, kv head)
// -- up to kMaxRows in the 8-row form, 16, 32 or kGroupRows in the
// row-block forms -- against one split of <= kMaxChunk cache rows on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) and writes each row's
// partial (m, l, o) for a combine. The caller picks the split and its rows,
// fills the Q tile (load_q) and says which cache rows each query sees
// (lim). (An int8 cache runs dattn_walk, decode_attention.cu.)
#pragma once

#include "mma.cuh"

namespace rama {

constexpr int kDaThreads = 128;
constexpr int kDaWarps = kDaThreads / 32;
constexpr int kMaxRows = 8;     // query rows of the 8-row form (rows 0..7 of one m16 tile)
constexpr int kGroupRows = 64;  // query rows of the largest form; more run as row groups
constexpr int kMaxChunk = 64;   // cache rows per CTA (split), at most
constexpr int kMmaPad = 8;      // bf16 a shared row past hd / past the split: no bank conflicts

// The m16 row blocks of a ROWS-row form. The 8-row form holds its rows in
// rows 0..7 of one A tile (rows 8..15 zero registers, never loaded), one
// row a lane (g); the 16 / 32 / 64-row forms fill 1 / 2 / 4 whole tiles,
// two rows a lane and tile (g and g + 8). A query row's arithmetic is the
// same in every form: its dot products, maxima and sums run in the same
// order whatever tile or lane holds it.
template <int ROWS>
struct RowForm {
  static_assert(ROWS == kMaxRows || ROWS == 16 || ROWS == 32 || ROWS == kGroupRows,
                "the forms take 8, 16, 32 or 64 query rows");
  static constexpr int NB = ROWS == kMaxRows ? 1 : ROWS / 16;   // m16 row blocks
  static constexpr int NH = ROWS == kMaxRows ? 1 : 2;           // rows a lane holds a block
};

// The form a launch of `rows` query rows a kv head runs: the fewest rows
// of 8, 16, 32, 64 that hold them; above 64, row groups of 64
// (ops/kernels/decode_attention.py row_form).
__host__ __device__ constexpr int form_rows(int rows) {
  return rows <= kMaxRows ? kMaxRows : rows <= 16 ? 16 : rows <= 32 ? 32 : kGroupRows;
}

// Shared memory of one dattn_mma CTA of the ROWS-row form: K, V tiles of
// kMaxChunk bf16 rows of hd + 8 elements, Q [ROWS][hd + 8] and P [ROWS]
// [kMaxChunk + 8] bf16, then f32 row maxima and sums [warps][ROWS] (38,400
// bytes at hd 128 and 8 rows, 63,488 at 64 rows).
template <int HD, int ROWS = kMaxRows>
struct MmaSmem {
  static constexpr int LD = HD + kMmaPad;          // bf16 K / V / Q row stride (elements)
  static constexpr int PLD = kMaxChunk + kMmaPad;  // P row stride (bf16)
  static constexpr size_t kv = (size_t)kMaxChunk * LD * 2;
  static constexpr size_t bytes =
      2 * kv + sizeof(__nv_bfloat16) * ((size_t)ROWS * LD + (size_t)ROWS * PLD) +
      sizeof(float) * 2 * kDaWarps * ROWS;
};

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of row block rb of a bf16 [rows][ld] tile at column k0
// (16 columns): rows 16 rb + g and, but in the 8-row form, 16 rb + g + 8.
template <int NH>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const __nv_bfloat16* t, int ld,
                                       int rb, int g, int c, int k0) {
  const __nv_bfloat16* p = t + (rb * 16 + g) * ld + k0 + 2 * c;
  a[0] = lds32(p);
  a[1] = NH > 1 ? lds32(p + 8 * ld) : 0u;
  a[2] = lds32(p + 8);
  a[3] = NH > 1 ? lds32(p + 8 * ld + 8) : 0u;
}

// One split of (slot b, kv head j): the n >= 1 bf16 cache rows s0 .. s0 +
// n - 1, which start at row srow of kc / vc, for the CTA's query rows r0 ..
// r0 + ROWS - 1 of the nq * rep rows of the kv head (row r: head j * rep +
// r % rep of query t = r / rep; r0 is 0 but in a row group past the first).
// load_q(Qs) fills rows 0..ROWS-1 of the bf16 Q tile (row stride
// MmaSmem<HD, ROWS>::LD; rows past the kv head's last zero): by cp.async
// before the cache rows' copies are issued (QLATE false: they land with
// K), or with plain stores after all of them are in flight (QLATE true).
// lim(t): the last cache row query t sees. Writes the partial (m, l) of
// each query row that sees a row of the split to part_ml[(hr * nsplit +
// split) * 2 ..] and its o to part_o[(hr * nsplit + split) * HD ..], hr =
// (b * nq + t) * nh + head. smraw: MmaSmem<HD, ROWS>::bytes of dynamic
// shared memory, 16-byte aligned. The CTA's threads all call it; it ends
// with no barrier (a caller that reuses the shared memory syncs first).
template <int HD, bool QLATE, int ROWS = kMaxRows, class LoadQ, class Lim>
__device__ __forceinline__ void dattn_mma_body(
    const __nv_bfloat16* __restrict__ kc, const __nv_bfloat16* __restrict__ vc,
    float* __restrict__ part_o, float* __restrict__ part_ml, int b, int j, int split,
    int nsplit, int nh, int nkv, int nq, int s0, int n, size_t srow, float scale,
    const LoadQ& load_q, const Lim& lim, unsigned char* smraw, int r0 = 0) {
  using Sm = MmaSmem<HD, ROWS>;
  constexpr int LD = Sm::LD, PLD = Sm::PLD;
  constexpr int NB = RowForm<ROWS>::NB, NH = RowForm<ROWS>::NH;
  constexpr int KS = HD / 16;                 // k-steps of Q K^T = 16-column pairs of O
  constexpr int CPR = HD / 8;                 // 16-byte pieces of a cache row
  constexpr int PW = (KS + kDaWarps - 1) / kDaWarps;   // column pairs of O a warp
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smraw);        // K tile
  __nv_bfloat16* Vs = Ks + kMaxChunk * LD;                            // V tile
  __nv_bfloat16* Qs = Vs + kMaxChunk * LD;                            // [ROWS][LD]
  __nv_bfloat16* Ps = Qs + ROWS * LD;                                 // [ROWS][PLD]
  float* red_m = reinterpret_cast<float*>(Ps + ROWS * PLD);          // [warps][ROWS]
  float* red_l = red_m + kDaWarps * ROWS;                             // [warps][ROWS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int rep = nh / nkv;
  // the CTA's query rows (more than ROWS only in row groups of the 64-row form)
  const int rows = ROWS == kGroupRows ? min(nq * rep - r0, ROWS) : nq * rep;
  const int kr = (n + 15) & ~15;              // rows the warps read: whole 16-row blocks

  if constexpr (!QLATE) load_q(Qs);
  // K then V rows, 16-byte pieces, rows past n zero; V lands while S is computed
  const __nv_bfloat16* kg = kc + srow * HD;
  const __nv_bfloat16* vg = vc + srow * HD;
  for (int i = tid; i < kr * CPR; i += kDaThreads) {
    const int r = i / CPR, ch = i % CPR;
    cp_async16_zfill(Ks + r * LD + ch * 8, kg + (r < n ? (size_t)i * 8 : 0), r < n);
  }
  cp_async_commit();                          // group: Q and K
  for (int i = tid; i < kr * CPR; i += kDaThreads) {
    const int r = i / CPR, ch = i % CPR;
    cp_async16_zfill(Vs + r * LD + ch * 8, vg + (r < n ? (size_t)i * 8 : 0), r < n);
  }
  cp_async_commit();                          // group: V
  if constexpr (QLATE) load_q(Qs);
  cp_async_wait<1>();
  __syncthreads();

  // this lane's query rows 16 rb + 8 h + g of the CTA: their query, the
  // last cache row each sees, whether it sees a row of this split
  int t_r[NB][NH], lim_r[NB][NH];
  bool sees[NB][NH];
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int r = rb * 16 + h * 8 + g;
      t_r[rb][h] = (r0 + r) / rep;
      lim_r[rb][h] = lim(t_r[rb][h]);
      sees[rb][h] = r < rows && s0 <= lim_r[rb][h];
    }

  // S = Q K^T over this warp's 16 cache rows kb..kb+15; lane: query rows of
  // each block, cache rows kb + 8 nt + 2 c + e. Rows past a query row's
  // limit or past n score -inf.
  const int kb = warp * 16;
  float sc[NB][2][2 * NH];                    // [block][n8 tile][2 h + e]
  if (kb < kr) {
    float acc[NB][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kf[4];
      ldsm_x4(kf, Ks + (kb + (lane / 16) * 8 + lane % 8) * LD + ks * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int rb = 0; rb < NB; ++rb) {
        uint32_t a[4];
        a_frag<NH>(a, Qs, LD, rb, g, c, ks * 16);
        mma_bf16(acc[rb][0], a, kf[0], kf[1]);
        mma_bf16(acc[rb][1], a, kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int rb = 0; rb < NB; ++rb)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = kb + nt * 8 + 2 * c + e;
            sc[rb][nt][2 * h + e] = sees[rb][h] && i < n && s0 + i <= lim_r[rb][h]
                                        ? acc[rb][nt][2 * h + e] * scale
                                        : -INFINITY;
          }
  } else {
#pragma unroll
    for (int rb = 0; rb < NB; ++rb)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2 * NH; ++e) sc[rb][nt][e] = -INFINITY;
  }
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float mw = quad_max(fmaxf(fmaxf(sc[rb][0][2 * h], sc[rb][0][2 * h + 1]),
                                      fmaxf(sc[rb][1][2 * h], sc[rb][1][2 * h + 1])));
      if (c == 0) red_m[warp * ROWS + rb * 16 + h * 8 + g] = mw;
    }
  cp_async_wait<0>();                         // V
  __syncthreads();

  // the split's max and sum of each query row; probabilities rounded to
  // bf16 into P. A row that sees no row of this split gets zero
  // probabilities and no (m, l): its combine never reads here.
  float m[NB][NH], l[NB][NH];
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int r = rb * 16 + h * 8 + g;
      m[rb][h] = red_m[r];
#pragma unroll
      for (int w = 1; w < kDaWarps; ++w) m[rb][h] = fmaxf(m[rb][h], red_m[w * ROWS + r]);
      l[rb][h] = 0.f;
    }
  if (kb < kr) {
#pragma unroll
    for (int rb = 0; rb < NB; ++rb)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = sees[rb][h] ? expf(sc[rb][nt][2 * h + e] - m[rb][h]) : 0.f;  // -inf -> 0
            l[rb][h] += p[e];
          }
          *reinterpret_cast<uint32_t*>(Ps + (rb * 16 + h * 8 + g) * PLD + kb + nt * 8 + 2 * c) =
              pack_bf16(p[0], p[1]);
        }
  }
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float ls = quad_sum(l[rb][h]);
      if (c == 0) red_l[warp * ROWS + rb * 16 + h * 8 + g] = ls;
    }
  __syncthreads();
  // each row's (m, l): block rb's by warp rb % kDaWarps
  size_t hr[NB][NH];
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int r = rb * 16 + h * 8 + g;
      const int t = t_r[rb][h];
      hr[rb][h] = ((size_t)b * nq + t) * nh + (size_t)j * rep + (r0 + r - t * rep);
      if (warp == rb % kDaWarps && c == 0 && sees[rb][h]) {
        float lt = 0.f;
#pragma unroll
        for (int w = 0; w < kDaWarps; ++w) lt += red_l[w * ROWS + r];
        part_ml[(hr[rb][h] * nsplit + split) * 2] = m[rb][h];
        part_ml[(hr[rb][h] * nsplit + split) * 2 + 1] = lt;
      }
    }

  // O = P V: warp w computes output columns 16 (w + 4 u) .. + 15 over the
  // split's rows, each V fragment for every row block, and writes its query
  // rows' partials from registers.
  float o[NB][PW][2][4] = {};
  for (int kk = 0; kk < kr / 16; ++kk) {
    uint32_t a[NB][4];
#pragma unroll
    for (int rb = 0; rb < NB; ++rb) a_frag<NH>(a[rb], Ps, PLD, rb, g, c, kk * 16);
#pragma unroll
    for (int u = 0; u < PW; ++u) {
      const int dp = warp + u * kDaWarps;
      if (dp < KS) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                              (lane / 16) * 8);
#pragma unroll
        for (int rb = 0; rb < NB; ++rb) {
          mma_bf16(o[rb][u][0], a[rb], vf[0], vf[1]);
          mma_bf16(o[rb][u][1], a[rb], vf[2], vf[3]);
        }
      }
    }
  }
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      if (rb * 16 + h * 8 + g >= rows) continue;
      float* dst = part_o + (hr[rb][h] * nsplit + split) * HD;
#pragma unroll
      for (int u = 0; u < PW; ++u) {
        const int dp = warp + u * kDaWarps;
        if (dp < KS) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            *reinterpret_cast<float2*>(dst + dp * 16 + nt * 8 + 2 * c) =
                make_float2(o[rb][u][nt][2 * h], o[rb][u][nt][2 * h + 1]);
        }
      }
    }
}

}  // namespace rama
