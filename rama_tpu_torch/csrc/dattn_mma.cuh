// The tensor-core split body of the decode attention over a bf16 cache,
// shared by K4 / K9 / K10 / K12's dattn_mma kernel (decode_attention.cu,
// where its design is described) and K14's split items (attn_block.cu):
// one CTA of kDaThreads threads scores up to kMaxRows query rows of one
// (slot, kv head) against one split of <= kMaxChunk cache rows on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) and writes each row's
// partial (m, l, o) for a combine. The caller picks the split and its rows,
// fills the Q tile (load_q) and says which cache rows each query sees
// (lim). (An int8 cache runs dattn_walk, decode_attention.cu.)
#pragma once

#include "mma.cuh"

namespace rama {

constexpr int kDaThreads = 128;
constexpr int kDaWarps = kDaThreads / 32;
constexpr int kMaxRows = 8;    // T * rep query rows per CTA
constexpr int kMaxChunk = 64;  // cache rows per CTA (split), at most
constexpr int kMmaPad = 8;     // bf16 a shared row past hd / past the split: no bank conflicts

// Shared memory of one dattn_mma CTA: K, V tiles of kMaxChunk bf16 rows of
// hd + 8 elements, Q [kMaxRows][hd + 8] and P [kMaxRows][kMaxChunk + 8]
// bf16, then f32 row maxima and sums [warps][kMaxRows].
template <int HD>
struct MmaSmem {
  static constexpr int LD = HD + kMmaPad;          // bf16 K / V / Q row stride (elements)
  static constexpr int PLD = kMaxChunk + kMmaPad;  // P row stride (bf16)
  static constexpr size_t kv = (size_t)kMaxChunk * LD * 2;
  static constexpr size_t bytes =
      2 * kv + sizeof(__nv_bfloat16) * ((size_t)kMaxRows * LD + (size_t)kMaxRows * PLD) +
      sizeof(float) * 2 * kDaWarps * kMaxRows;
};

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One split of (slot b, kv head j): the n >= 1 bf16 cache rows s0 .. s0 +
// n - 1, which start at row srow of kc / vc, for the rows = nq * rep query
// rows of the kv head (row r: head j * rep + r % rep of query t = r / rep).
// load_q(Qs) fills rows 0..kMaxRows-1 of the bf16 Q tile (row stride
// MmaSmem<HD>::LD; rows past `rows` zero): by cp.async before the cache
// rows' copies are issued (QLATE false: they land with K), or with plain
// stores after all of them are in flight (QLATE true). lim(t): the last
// cache row query t sees. Writes the partial (m, l) of each query row that
// sees a row of the split to part_ml[(hr * nsplit + split) * 2 ..] and its o
// to part_o[(hr * nsplit + split) * HD ..], hr = (b * nq + t) * nh + head.
// smraw: MmaSmem<HD>::bytes of dynamic shared memory, 16-byte aligned. The
// CTA's threads all call it; it ends with no barrier (a caller that reuses
// the shared memory syncs first).
template <int HD, bool QLATE, class LoadQ, class Lim>
__device__ __forceinline__ void dattn_mma_body(
    const __nv_bfloat16* __restrict__ kc, const __nv_bfloat16* __restrict__ vc,
    float* __restrict__ part_o, float* __restrict__ part_ml, int b, int j, int split,
    int nsplit, int nh, int nkv, int nq, int s0, int n, size_t srow, float scale,
    const LoadQ& load_q, const Lim& lim, unsigned char* smraw) {
  using Sm = MmaSmem<HD>;
  constexpr int LD = Sm::LD, PLD = Sm::PLD;
  constexpr int KS = HD / 16;                 // k-steps of Q K^T = 16-column pairs of O
  constexpr int CPR = HD / 8;                 // 16-byte pieces of a cache row
  constexpr int PW = (KS + kDaWarps - 1) / kDaWarps;   // column pairs of O a warp
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smraw);        // K tile
  __nv_bfloat16* Vs = Ks + kMaxChunk * LD;                            // V tile
  __nv_bfloat16* Qs = Vs + kMaxChunk * LD;                            // [kMaxRows][LD]
  __nv_bfloat16* Ps = Qs + kMaxRows * LD;                             // [kMaxRows][PLD]
  float* red_m = reinterpret_cast<float*>(Ps + kMaxRows * PLD);      // [warps][kMaxRows]
  float* red_l = red_m + kDaWarps * kMaxRows;                         // [warps][kMaxRows]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int rep = nh / nkv;
  const int rows = nq * rep;
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

  // S = Q K^T over this warp's 16 cache rows kb..kb+15; lane: query row g,
  // cache rows kb + 8 nt + 2 c + e. Rows past a query row's limit or past
  // n score -inf.
  const int kb = warp * 16;
  const int t_g = g / rep;
  const int lim_g = lim(t_g);
  const bool sees = g < rows && s0 <= lim_g;  // query row g sees a row of this split
  float sc[2][2];
  if (kb < kr) {
    float acc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t a[4] = {lds32(Qs + g * LD + ks * 16 + 2 * c), 0u,
                             lds32(Qs + g * LD + ks * 16 + 8 + 2 * c), 0u};
      uint32_t kf[4];
      ldsm_x4(kf, Ks + (kb + (lane / 16) * 8 + lane % 8) * LD + ks * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(acc[0], a, kf[0], kf[1]);
      mma_bf16(acc[1], a, kf[2], kf[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = kb + nt * 8 + 2 * c + e;
        sc[nt][e] = sees && i < n && s0 + i <= lim_g ? acc[nt][e] * scale : -INFINITY;
      }
    }
  } else {
    sc[0][0] = sc[0][1] = sc[1][0] = sc[1][1] = -INFINITY;
  }
  const float mw = quad_max(fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1])));
  if (c == 0) red_m[warp * kMaxRows + g] = mw;
  cp_async_wait<0>();                         // V
  __syncthreads();

  // the split's max and sum of each query row; probabilities rounded to
  // bf16 into P. A row that sees no row of this split gets zero
  // probabilities and no (m, l): its combine never reads here.
  float m = red_m[g];
#pragma unroll
  for (int w = 1; w < kDaWarps; ++w) m = fmaxf(m, red_m[w * kMaxRows + g]);
  float l = 0.f;
  if (kb < kr) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = sees ? expf(sc[nt][e] - m) : 0.f;   // -inf scores -> 0
        l += p[e];
      }
      *reinterpret_cast<uint32_t*>(Ps + g * PLD + kb + nt * 8 + 2 * c) = pack_bf16(p[0], p[1]);
    }
  }
  l = quad_sum(l);
  if (c == 0) red_l[warp * kMaxRows + g] = l;
  __syncthreads();
  const size_t hr = ((size_t)b * nq + t_g) * nh + (size_t)j * rep + (g - t_g * rep);
  if (warp == 0 && c == 0 && sees) {
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < kDaWarps; ++w) lt += red_l[w * kMaxRows + g];
    part_ml[(hr * nsplit + split) * 2] = m;
    part_ml[(hr * nsplit + split) * 2 + 1] = lt;
  }

  // O = P V: warp w computes output columns 16 (w + 4 u) .. + 15 over the
  // split's rows, and writes its query rows' partials from registers.
  float o[PW][2][4] = {};
  for (int kk = 0; kk < kr / 16; ++kk) {
    const uint32_t a[4] = {lds32(Ps + g * PLD + kk * 16 + 2 * c), 0u,
                           lds32(Ps + g * PLD + kk * 16 + 8 + 2 * c), 0u};
#pragma unroll
    for (int u = 0; u < PW; ++u) {
      const int dp = warp + u * kDaWarps;
      if (dp < KS) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                              (lane / 16) * 8);
        mma_bf16(o[u][0], a, vf[0], vf[1]);
        mma_bf16(o[u][1], a, vf[2], vf[3]);
      }
    }
  }
  if (g < rows) {
    float* dst = part_o + (hr * nsplit + split) * HD;
#pragma unroll
    for (int u = 0; u < PW; ++u) {
      const int dp = warp + u * kDaWarps;
      if (dp < KS) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(dst + dp * 16 + h * 8 + 2 * c) =
              make_float2(o[u][h][0], o[u][h][1]);
      }
    }
  }
}

}  // namespace rama
