// Kernels 4, 7, 10 and 12: decode attention against layer l of the stacked
// KV cache, flash-decoding style, over a bf16 / f32 cache (K4) or an int8
// cache with one f32 scale per (token, kv head) row (K7), for one query per
// slot (T = 1) or a chunk of T <= 8 consecutive queries per slot (K10, the
// speculative-verification chunk, on either cache); K12 runs all of these
// over a shared page pool through per-slot page tables (below).
//
// Replaces rama_tpu/ops/pallas/decode_attention.py:
// decode_attention_layer (_kernel_layered, whole S stripe per program) and
// decode_attention_layer_tiled (_kernel_tiled, online softmax over S-tiles,
// tiles past pos skipped) for K4; decode_attention_layer_q8 and
// decode_attention_layer_tiled_q8 (_kernel_q8, _kernel_tiled_q8) for K7;
// chunk_attention_layer, _tiled, _q8 and _tiled_q8 (the same bodies with
// t > 1 and _row_mask) for K10.
// All compute softmax(q k^T / sqrt(hd)) v for the GQA group of each kv
// head; query t of slot b sits at position pos0[b] + t and sees cache rows
// s <= pos0[b] + t. The int8 forms apply the row scales after the
// products: score = (q . k8[s]) * ks[s] / sqrt(hd), and the V side sums
// (p[s] * vs[s]) * v8[s].
//
// Bound on the H100: bytes. Each (slot, kv head) reads its visible rows of
// K and of V once for all T queries, hd * 2 bytes each for a bf16 cache
// (hd bytes + a 4-byte scale for int8); compute is ~2 T flops per byte.
// At 7B (32 kv heads, hd 128) a slot at pos 1023 reads 16.8 MB per layer
// from a bf16 cache, 8.7 MB from an int8 one: 5 us / 2.6 us at 3.35 TB/s.
//
// Design: the TPU grid walks S-tiles in order inside one program per
// (slot, head group) — at batch 1 that is only 32 programs, too few for 132
// SMs. Here the grid is (S-split, kv head, slot): each CTA holds the
// rows = T * rep query rows of its kv head, t-major as the Pallas
// _chunk_rows lays them out (row r = t * rep + g is query head
// j * rep + g at position pos0 + r / rep), and reads each K/V row of its
// split of the cache (at most kMaxChunk = 64 rows) once for all of them:
// it first issues every copy of the split's K and V rows (and row scales)
// at once — a CTA that loaded row group by row group waited on memory
// about ten times in a row — then works from shared memory. Each row
// scores only cache rows up to its own limit, clamped to S - 1 row by row.
// The CTA takes each row's split max and sum in fp32, rounds its
// probabilities (times the V row scale, for int8) to q's dtype before P.V
// (as decode_attention.py:75,100 and the q8 kernels' bf16 casts do), and
// writes a partial (m, l, o) per row; a CTA whose split starts past the
// last row's limit exits before reading anything. A second small kernel
// (dattn_combine) combines, per query row, exactly the splits that row
// saw. T * rep <= kMaxRows = 8: every Llama-2 shape at T <= 8 (rep 1); a
// wider GQA group takes a shorter chunk. Two bodies compute the split
// (the wrappers pick one by dtype and head dim, ops/kernels/
// decode_attention.py body_for):
//
//  - dattn_split (the SIMT body): fp32, and head dims other than 48 / 64
//    / 128. 16-byte lanes (8 bf16 / f32 or 16 int8 elements, RG lanes a
//    cache row) take fp32 dot products reduced by shuffles; P.V keeps
//    acc[ROWS][EPL] in registers, the row groups of a warp summed by
//    shuffles, the four warps through shared memory.
//  - dattn_mma (the tensor-core body): bf16 q at hd 48 / 64 / 128, on a
//    bf16 or an int8 cache, dense or paged, for 1..8 query rows — the
//    decode steps (K4, K7, K9, K12 decode) as the verification chunks
//    (K10, K12's chunk form). It replaces the SIMT body there because
//    that body's time grew with the rows (T = 4 / 8 took 2.6 / 5.2x the
//    T = 1 split over the same rows): ROWS dot products a row group, each
//    reduced by log2(RG) shuffles, and ROWS x EPL fp32 accumulators (163
//    registers at ROWS 8). Decode steps take it too: rows are independent
//    in it and the splits are the same 64 rows, so a verification row
//    computes bit for bit what the decode step computes at its position,
//    which greedy speculation relies on (with the chunks alone on it, a
//    random-weight 7B target as its own draft accepted 0.81 of its drafts
//    on an H100, not all: a 1-ulp difference flips near-tied logits).
//    It does both products on mma.sync.m16n8k16 (bf16 in, fp32
//    accumulate), as K5's pattn_mma_kernel (prefill_attention.cu) does:
//      * the <= 8 query rows are rows 0..7 of one m16 A tile (rows 8..15
//        are zero registers, never loaded), read straight from a shared
//        Q tile; each of the 4 warps owns 16 cache rows of the split (two
//        n8 tiles of S = Q K^T, K the column-major B operand through
//        ldmatrix);
//      * K / V rows land in shared memory by cp.async, every copy in
//        flight at once, rows padded so that ldmatrix is free of bank
//        conflicts, rows past the split's last visible one zero-filled
//        (and masked when scoring); V's copies form a second group that
//        lands while S is computed;
//      * int8 rows stay bytes in shared memory and become bf16 in
//        registers after ldmatrix (exact: |x| <= 127), as K3's ffn_mma
//        does: ldmatrix hands each lane four consecutive bytes of a K row,
//        so the k order of Q K^T is permuted alike for Q (a free change of
//        summation order), and ldmatrix.trans hands it two dims of two V
//        rows, the even and the odd dims making two n8 tiles of P V;
//        writing bf16 tiles first instead was 9-16 % slower on the int8
//        splits of an H100 and took twice the shared memory;
//      * each score is scaled by 1 / sqrt(hd) (int8: times ks[s] first)
//        and masked by row_limit as -inf; row max and sum over the split
//        by quad shuffles, then across the warps through 64 floats of
//        shared memory; P rounded to bf16 (int8: after the vs[s] scale)
//        into a shared P tile of 8 x 64;
//      * O = P V with V the row-major B operand (ldmatrix.trans), the
//        output's 16-column pairs dealt to the warps, so each partial
//        row is written once from registers: no cross-warp sum of O.
//    38.4 KB of shared memory at hd 128 (int8: 22.5 KB). At 128-row pages
//    the paged forms' 64-row splits are the dense form's, so they equal the
//    dense kernel bit for bit.
//
// Kernel 12, the paged forms (rama_tpu/ops/pallas/paged_attention.py:
// _paged_call via paged_decode_attention_layer, _q8, paged_chunk_
// attention_layer (:156) and _q8 (:179)): the same bodies over a shared
// page pool (L, P, nkv, ps, hd) and per-slot page tables (B, mp). The TPU
// kernel walks a slot's pages in order and repeats the last used page so
// its DMA is elided; here a split of `chunk` rows, chunk dividing ps, lies
// inside one page, so only the address of its rows changes: split s0 of slot b
// reads page clamp(table[b, min(s0 / ps, mp - 1)], 0, P - 1) at in-page
// row s0 % ps, with S = mp * ps for the row limits. Splits past the last
// row's limit exit as in the dense cache, so a slot pays for the pages it
// uses whatever mp is (ragged).
#include "attention.cuh"
#include "dattn_mma.cuh"

#include <math.h>

#include <type_traits>

namespace rama {

enum Body : int { kBodySimt = 0, kBodyMma = 1 };  // ops/kernels/decode_attention.py BODIES

// The last cache row query t of a slot at pos0 sees, clamped to [0, S-1].
__device__ __forceinline__ int row_limit(int pos0, int t, int S) {
  return max(0, min(pos0 + t, S - 1));
}

// Index of the first cache row of split s0 of (slot b, kv head j): in the
// dense cache (L, B, nkv, S, hd) at layer 0, or, with page tables (B, mp),
// in the pool (npages, nkv, ps, hd) at page clamp(table[b, s0 / ps]),
// in-page row s0 % ps (a split lies inside one page).
__device__ __forceinline__ size_t first_row(const int* tables, int b, int j, int s0, int S,
                                            int nkv, int mp, int ps, int npages) {
  if (tables) {
    const int page = min(max(tables[(size_t)b * mp + min(s0 / ps, mp - 1)], 0), npages - 1);
    return ((size_t)page * nkv + j) * (size_t)ps + s0 % ps;
  }
  return ((size_t)b * nkv + j) * (size_t)S + s0;
}

// Dynamic shared memory of one split CTA, in bytes: the K and V tiles
// (chunk rows of hd C) and their row scales, then f32 qs [ROWS][hd],
// sc [ROWS][chunk] and red [warps][ROWS][hd].
template <typename C, int ROWS>
__host__ __device__ __forceinline__ size_t split_smem(int chunk, int hd) {
  return 2 * (size_t)chunk * hd * sizeof(C) + 2 * (size_t)chunk * sizeof(float) +
         sizeof(float) * ((size_t)ROWS * hd + (size_t)ROWS * chunk +
                          (size_t)(kDaThreads / 32) * ROWS * hd);
}

// grid (nsplit, nkv, B), block 128. T: q's dtype; C: the cache's (T, or
// int8_t with row scales ksc / vsc, which are null otherwise). q is
// (B, nq, nh, hd); partials are indexed by query row (b * nq + t) * nh + h.
// RG = lanes per cache row (each lane EPL elements of hd, RG = next power
// of two >= hd/EPL); ROWS >= nq * rep. The CTA first copies its chunk of K
// and V (and their scales) into shared memory with every copy in flight at
// once, so that it waits on the memory once, not once a row group.
// tables: null for the dense cache (L, B, nkv, S, hd); else the (B, mp)
// page tables of a pool (L, npages, nkv, ps, hd) with S = mp * ps and
// chunk dividing ps.
template <typename T, typename C, int RG, int ROWS>
__global__ void __launch_bounds__(kDaThreads)
dattn_split(const T* __restrict__ q, const C* __restrict__ kc, const C* __restrict__ vc,
            const float* __restrict__ ksc, const float* __restrict__ vsc,
            const int* __restrict__ pos0, float* __restrict__ part_o,
            float* __restrict__ part_ml, int nh, int nkv, int S, int hd, int chunk, int nq,
            float scale, const int* __restrict__ tables, int mp, int ps, int npages) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  constexpr int EPL = Lane<C>::EPL;
  constexpr int ngrp = kDaThreads / RG;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int split = blockIdx.x, j = blockIdx.y, b = blockIdx.z, nsplit = gridDim.x;
  const int tid = threadIdx.x;
  const int rep = nh / nkv;
  const int rows = nq * rep;
  const int p0 = pos0[b];
  const int last = row_limit(p0, nq - 1, S);  // the largest limit of the CTA's rows
  const int s0 = split * chunk;
  if (s0 > last) return;  // no row's combine reads this split
  const int s1 = min(s0 + chunk, last + 1);
  const int n = s1 - s0;

  C* kt = reinterpret_cast<C*>(smraw);             // [chunk][hd]
  C* vt = kt + (size_t)chunk * hd;                 // [chunk][hd]
  float* kst = reinterpret_cast<float*>(vt + (size_t)chunk * hd);  // [chunk]
  float* vst = kst + chunk;                        // [chunk]
  float* qs = vst + chunk;                         // [ROWS][hd]
  float* sc = qs + ROWS * hd;                      // [ROWS][chunk]
  float* red = sc + ROWS * chunk;                  // [warps][ROWS][hd]
  const size_t srow = first_row(tables, b, j, s0, S, nkv, mp, ps, npages);
  {
    const int vrow = hd * (int)sizeof(C) / 16;     // 16-byte pieces a row
    const C* kg = kc + srow * hd;
    const C* vg = vc + srow * hd;
    constexpr int kPer = 16 / (int)sizeof(C);
    for (int i = tid; i < n * vrow; i += kDaThreads) {
      cp_async16(kt + (size_t)i * kPer, kg + (size_t)i * kPer);
      cp_async16(vt + (size_t)i * kPer, vg + (size_t)i * kPer);
    }
  }
  if constexpr (kQ8) {
    for (int i = tid; i < n; i += kDaThreads) {
      kst[i] = ksc[srow + i];
      vst[i] = vsc[srow + i];
    }
  }
  for (int i = tid; i < rows * hd; i += kDaThreads) {
    const int r = i / hd, d = i - r * hd;
    const int t = r / rep, g = r - t * rep;
    qs[i] = to_f(q[(((size_t)b * nq + t) * nh + (size_t)j * rep + g) * hd + d]);
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane_g = tid % RG, grp = tid / RG;
  const int d0 = lane_g * EPL;
  const bool active = d0 < hd;

  // scores: every lane runs the same trip count (shuffles need the full
  // warp); a cache row past a query row's limit scores -inf for that row
  for (int base = 0; base < n; base += ngrp) {
    const int i = base + grp;  // row of the tile
    const bool ok = i < n;
    float kv[EPL];
    if (ok && active) {
      tile_lane(kt + (size_t)i * hd + d0, kv);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) kv[e] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
      float d = 0.f;
      if (active) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qs[r * hd + d0 + e], kv[e], d);
      }
#pragma unroll
      for (int o = RG / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane_g == 0 && ok) {
        float v;
        if constexpr (kQ8) v = d * kst[i] * scale;
        else v = d * scale;
        sc[r * chunk + i] = s0 + i <= row_limit(p0, r / rep, S) ? v : -INFINITY;
      }
    }
  }
  __syncthreads();

  // chunk max / sum per query row; probabilities (times the V row scale,
  // for int8) rounded to T for P.V. A row that sees no row of this chunk
  // gets zero probabilities and no (m, l): its combine never reads here.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += kDaThreads / 32) {
    const int t = r / rep;
    if (s0 > row_limit(p0, t, S)) {
      for (int i = lane; i < n; i += 32) sc[r * chunk + i] = 0.f;
      continue;
    }
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sc[r * chunk + i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(sc[r * chunk + i] - m);
      l += e;
      if constexpr (kQ8) sc[r * chunk + i] = round_to<T>(e * vst[i]);
      else sc[r * chunk + i] = round_to<T>(e);
    }
    l = warp_sum(l);
    if (lane == 0) {
      const size_t hr = ((size_t)b * nq + t) * nh + (size_t)j * rep + (r - t * rep);
      part_ml[(hr * nsplit + split) * 2] = m;
      part_ml[(hr * nsplit + split) * 2 + 1] = l;
    }
  }
  __syncthreads();

  float acc[ROWS][EPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  if (active) {
    for (int i = grp; i < n; i += ngrp) {
      float v[EPL];
      tile_lane(vt + (size_t)i * hd + d0, v);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= rows) break;
        const float pr = sc[r * chunk + i];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pr, v[e], acc[r][e]);
      }
    }
  }
  // sum the row groups of each warp with shuffles (lanes lane_g, lane_g +
  // RG, ... hold the same dims), then the warps through shared memory
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
#pragma unroll
      for (int o = RG; o < 32; o <<= 1) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  }
  if (active && lane < RG) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
#pragma unroll
      for (int e = 0; e < EPL; ++e) red[((size_t)warp * rows + r) * hd + d0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * hd; i += kDaThreads) {
    const int r = i / hd, d = i - r * hd;
    const int t = r / rep;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kDaThreads / 32; ++w) v += red[(size_t)w * rows * hd + i];
    const size_t hr = ((size_t)b * nq + t) * nh + (size_t)j * rep + (r - t * rep);
    part_o[(hr * nsplit + split) * hd + d] = v;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body (dattn_mma): bf16 q, hd 48 / 64 / 128, 2..8 query
// rows, a bf16 cache (C = bf16) or an int8 one with row scales ksc / vsc;
// the body itself is dattn_mma_body (dattn_mma.cuh, shared with K14).
// Fragment coordinates: mma.cuh (lane = 4 g + c).

// grid (nsplit, nkv, B), block 128; the operands and partials as
// dattn_split's, chunk <= kMaxChunk, q, kc, vc 16-byte aligned.
template <int HD, bool Q8>
__global__ void __launch_bounds__(kDaThreads)
dattn_mma(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kc,
          const void* __restrict__ vc, const float* __restrict__ ksc,
          const float* __restrict__ vsc, const int* __restrict__ pos0,
          float* __restrict__ part_o, float* __restrict__ part_ml, int nh, int nkv, int S,
          int chunk, int nq, float scale, const int* __restrict__ tables, int mp, int ps,
          int npages) {
  constexpr int LD = MmaSmem<HD, Q8>::LD;
  constexpr int QCH = HD / 8;                 // 16-byte pieces of a bf16 row
  extern __shared__ __align__(16) unsigned char smraw[];
  const int split = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int rep = nh / nkv;
  const int rows = nq * rep;
  const int p0 = pos0[b];
  const int last = row_limit(p0, nq - 1, S);  // the largest limit of the CTA's rows
  const int s0 = split * chunk;
  if (s0 > last) return;  // no row's combine reads this split
  const int n = min(s0 + chunk, last + 1) - s0;
  const size_t srow = first_row(tables, b, j, s0, S, nkv, mp, ps, npages);
  // Q rows 0..rows-1 (row r: head j * rep + r % rep at pos0 + r / rep), the rest zero
  auto load_q = [&](__nv_bfloat16* Qs) {
    for (int i = threadIdx.x; i < kMaxRows * QCH; i += kDaThreads) {
      const int r = i / QCH, ch = i % QCH, t = r / rep;
      const bool ok = r < rows;
      cp_async16_zfill(Qs + r * LD + ch * 8,
                       ok ? q + (((size_t)b * nq + t) * nh + (size_t)j * rep + (r - t * rep)) *
                                    HD + ch * 8
                          : q,
                       ok);
    }
  };
  dattn_mma_body<HD, Q8, false>(kc, vc, ksc, vsc, part_o, part_ml, b, j, split, gridDim.x, nh,
                                nkv, nq, s0, n, srow, scale, load_q,
                                [&](int t) { return row_limit(p0, t, S); }, smraw);
}

// grid (nh, nq, B), block 128: out[b, t, h] = sum_i e^(m_i - M) o_i /
// sum_i e^(m_i - M) l_i over the splits i <= limit / chunk of query t
template <typename T>
__global__ void __launch_bounds__(kDaThreads)
dattn_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
              const int* __restrict__ pos0, T* __restrict__ out, int nh, int S, int hd,
              int chunk, int nsplit, int nq) {
  const int h = blockIdx.x, t = blockIdx.y, b = blockIdx.z;
  const size_t hr = ((size_t)b * nq + t) * nh + h;
  const int nv = row_limit(pos0[b], t, S) / chunk + 1;
  float mx = -INFINITY;
  for (int i = 0; i < nv; ++i) mx = fmaxf(mx, part_ml[(hr * nsplit + i) * 2]);
  float L = 0.f;
  for (int i = 0; i < nv; ++i)
    L += expf(part_ml[(hr * nsplit + i) * 2] - mx) * part_ml[(hr * nsplit + i) * 2 + 1];
  for (int d = threadIdx.x; d < hd; d += kDaThreads) {
    float o = 0.f;
    for (int i = 0; i < nv; ++i)
      o += expf(part_ml[(hr * nsplit + i) * 2] - mx) * part_o[(hr * nsplit + i) * hd + d];
    out[hr * hd + d] = from_f<T>(o / L);
  }
}

// One launch's operands (ks / vs null for a bf16 / f32 cache).
struct DaArgs {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int* pos0;
  void* out;
  float *part_o, *part_ml;
  int B, nq, nh, nkv, S, hd, chunk, nsplit;
  float scale;
  cudaStream_t st;
  int* occ;  // non-null: launch nothing, report the split kernel's occupancy
  const int* tables;  // page tables (B, mp) of a pool of npages pages of ps rows; null: dense
  int mp, ps, npages;
  int body;  // kBodySimt or kBodyMma
};

// Opt kern into `most` bytes of dynamic shared memory (once an
// instantiation and device), then launch it with `smem` over the split
// grid, or, with a.occ, report its resident CTAs per SM, registers per
// thread and shared bytes per CTA instead.
template <class K, class... Args>
cudaError_t launch_or_report(const DaArgs& a, SmemOptIn& opt_in, K kern, size_t most,
                             size_t smem, Args... args) {
  if (most > 48 * 1024) {
    cudaError_t e = opt_in.set(kern, most);
    if (e != cudaSuccess) return e;
  }
  if (a.occ) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a.occ[0], kern, kDaThreads, smem);
    a.occ[1] = fa.numRegs;
    a.occ[2] = (int)smem;
    return e;
  }
  kern<<<dim3(a.nsplit, a.nkv, a.B), kDaThreads, smem, a.st>>>(args...);
  return cudaGetLastError();
}

template <typename T, typename C, int RG, int ROWS>
cudaError_t launch_split(const DaArgs& a) {
  static SmemOptIn opt_in;   // at the most any chunk and hd of this instantiation need
  return launch_or_report(
      a, opt_in, dattn_split<T, C, RG, ROWS>,
      split_smem<C, ROWS>(kMaxChunk, RG * Lane<C>::EPL), split_smem<C, ROWS>(a.chunk, a.hd),
      static_cast<const T*>(a.q), static_cast<const C*>(a.k), static_cast<const C*>(a.v),
      a.ks, a.vs, a.pos0, a.part_o, a.part_ml, a.nh, a.nkv, a.S, a.hd, a.chunk, a.nq,
      a.scale, a.tables, a.mp, a.ps, a.npages);
}

template <typename T, typename C, int RG>
cudaError_t launch_rows(const DaArgs& a) {
  const int rows = a.nq * (a.nh / a.nkv);
  if (rows <= 1) return launch_split<T, C, RG, 1>(a);
  if (rows <= 2) return launch_split<T, C, RG, 2>(a);
  if (rows <= 4) return launch_split<T, C, RG, 4>(a);
  if (rows <= kMaxRows) return launch_split<T, C, RG, kMaxRows>(a);
  return cudaErrorInvalidValue;
}

template <typename T, typename C>
cudaError_t launch_simt(const DaArgs& a) {
  const int lanes = a.hd / Lane<C>::EPL;
  if (lanes <= 1) return launch_rows<T, C, 1>(a);
  if (lanes <= 2) return launch_rows<T, C, 2>(a);
  if (lanes <= 4) return launch_rows<T, C, 4>(a);
  if (lanes <= 8) return launch_rows<T, C, 8>(a);
  if (lanes <= 16) return launch_rows<T, C, 16>(a);
  if constexpr (Lane<C>::EPL == 8) {
    if (lanes <= 32) return launch_rows<T, C, 32>(a);
  }
  return cudaErrorInvalidValue;
}

template <int HD, bool Q8>
cudaError_t launch_mma_hd(const DaArgs& a) {
  static SmemOptIn opt_in;
  constexpr size_t smem = MmaSmem<HD, Q8>::bytes;
  return launch_or_report(a, opt_in, dattn_mma<HD, Q8>, smem, smem,
                          static_cast<const __nv_bfloat16*>(a.q), a.k, a.v, a.ks, a.vs,
                          a.pos0, a.part_o, a.part_ml, a.nh, a.nkv, a.S, a.chunk, a.nq,
                          a.scale, a.tables, a.mp, a.ps, a.npages);
}

// The tensor-core body: bf16 q only, hd 48 / 64 / 128; anything else is
// refused (never handed to the SIMT body).
template <typename T, typename C>
cudaError_t launch_mma(const DaArgs& a) {
  if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
    return cudaErrorInvalidValue;
  } else {
    constexpr bool q8 = std::is_same<C, int8_t>::value;
    if (a.nq * (a.nh / a.nkv) > kMaxRows) return cudaErrorInvalidValue;
    switch (a.hd) {
      case 48: return launch_mma_hd<48, q8>(a);
      case 64: return launch_mma_hd<64, q8>(a);
      case 128: return launch_mma_hd<128, q8>(a);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T, typename C>
cudaError_t launch_all(DaArgs a) {
  if (a.chunk <= 0 || a.chunk > kMaxChunk) return cudaErrorInvalidValue;
  a.nsplit = (a.S + a.chunk - 1) / a.chunk;
  a.scale = 1.f / sqrtf(static_cast<float>(a.hd));
  cudaError_t e;
  if (a.body == kBodyMma) e = launch_mma<T, C>(a);
  else if (a.body == kBodySimt) e = launch_simt<T, C>(a);
  else return cudaErrorInvalidValue;
  if (e != cudaSuccess || a.occ) return e;
  dattn_combine<T><<<dim3(a.nh, a.nq, a.B), kDaThreads, 0, a.st>>>(
      a.part_o, a.part_ml, a.pos0, static_cast<T*>(a.out), a.nh, a.S, a.hd, a.chunk,
      a.nsplit, a.nq);
  return cudaGetLastError();
}

}  // namespace rama

// K4 (nq = 1) and K10. q (B, nq, nh, hd); k/v point at layer l of the
// (L, B, nkv, S, hd) cache of q's dtype; pos0 (B,) int32, query t at
// pos0[b] + t; out (B, nq, nh * hd); part_o (B, nq, nh, nsplit, hd) and
// part_ml (B, nq, nh, nsplit, 2) fp32 scratch with nsplit = ceil(S / chunk),
// chunk <= 64; body: 0 the SIMT body, 1 the tensor-core body (bf16, hd 48 /
// 64 / 128, q and caches 16-byte aligned).
extern "C" int rama_decode_attention(const void* q, const void* k, const void* v,
                                     const void* pos0, void* out, void* part_o,
                                     void* part_ml, int B, int nq, int nh, int nkv, int S,
                                     int hd, int chunk, int dtype, int body, void* stream) {
  rama::DaArgs a{q, k, v, nullptr, nullptr, static_cast<const int*>(pos0), out,
                 static_cast<float*>(part_o), static_cast<float*>(part_ml),
                 B, nq, nh, nkv, S, hd, chunk, 0, 0.f, static_cast<cudaStream_t>(stream),
                 nullptr};
  a.body = body;
  if (dtype == rama::kBF16)
    return static_cast<int>(rama::launch_all<__nv_bfloat16, __nv_bfloat16>(a));
  if (dtype == rama::kF32) return static_cast<int>(rama::launch_all<float, float>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7 (nq = 1) and K10 over an int8 cache: k8/v8 point at layer l of
// (L, B, nkv, S, hd) int8, ks/vs at layer l of its (L, B, nkv, S) f32 row
// scales; hd a multiple of 16.
extern "C" int rama_decode_attention_q8(const void* q, const void* k8, const void* v8,
                                        const void* ks, const void* vs, const void* pos0,
                                        void* out, void* part_o, void* part_ml, int B, int nq,
                                        int nh, int nkv, int S, int hd, int chunk, int dtype,
                                        int body, void* stream) {
  rama::DaArgs a{q, k8, v8, static_cast<const float*>(ks), static_cast<const float*>(vs),
                 static_cast<const int*>(pos0), out, static_cast<float*>(part_o),
                 static_cast<float*>(part_ml), B, nq, nh, nkv, S, hd, chunk, 0, 0.f,
                 static_cast<cudaStream_t>(stream), nullptr};
  a.body = body;
  if (dtype == rama::kBF16) return static_cast<int>(rama::launch_all<__nv_bfloat16, int8_t>(a));
  if (dtype == rama::kF32) return static_cast<int>(rama::launch_all<float, int8_t>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12 (nq = 1: the paged decode step; nq <= 8: the paged verification
// chunk) over a page pool of q's dtype: k/v point at layer l of the
// (L, npages, nkv, ps, hd) pool, tables (B, mp) int32 page ids (entries
// clamped to [0, npages - 1]); chunk divides ps; the scratch as above with
// nsplit = ceil(mp * ps / chunk).
extern "C" int rama_paged_attention(const void* q, const void* k, const void* v,
                                    const void* pos0, const void* tables, void* out,
                                    void* part_o, void* part_ml, int B, int nq, int nh, int nkv,
                                    int mp, int ps, int npages, int hd, int chunk, int dtype,
                                    int body, void* stream) {
  rama::DaArgs a{q, k, v, nullptr, nullptr, static_cast<const int*>(pos0), out,
                 static_cast<float*>(part_o), static_cast<float*>(part_ml),
                 B, nq, nh, nkv, mp * ps, hd, chunk, 0, 0.f, static_cast<cudaStream_t>(stream),
                 nullptr};
  if (chunk <= 0 || ps % chunk) return static_cast<int>(cudaErrorInvalidValue);
  a.tables = static_cast<const int*>(tables);
  a.mp = mp;
  a.ps = ps;
  a.npages = npages;
  a.body = body;
  if (dtype == rama::kBF16)
    return static_cast<int>(rama::launch_all<__nv_bfloat16, __nv_bfloat16>(a));
  if (dtype == rama::kF32) return static_cast<int>(rama::launch_all<float, float>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12 over an int8 pool: k8/v8 point at layer l of (L, npages, nkv, ps, hd)
// int8, ks/vs at layer l of its (L, npages, nkv, ps) f32 row scales.
extern "C" int rama_paged_attention_q8(const void* q, const void* k8, const void* v8,
                                       const void* ks, const void* vs, const void* pos0,
                                       const void* tables, void* out, void* part_o,
                                       void* part_ml, int B, int nq, int nh, int nkv, int mp,
                                       int ps, int npages, int hd, int chunk, int dtype,
                                       int body, void* stream) {
  rama::DaArgs a{q, k8, v8, static_cast<const float*>(ks), static_cast<const float*>(vs),
                 static_cast<const int*>(pos0), out, static_cast<float*>(part_o),
                 static_cast<float*>(part_ml), B, nq, nh, nkv, mp * ps, hd, chunk, 0, 0.f,
                 static_cast<cudaStream_t>(stream), nullptr};
  if (chunk <= 0 || ps % chunk) return static_cast<int>(cudaErrorInvalidValue);
  a.tables = static_cast<const int*>(tables);
  a.mp = mp;
  a.ps = ps;
  a.npages = npages;
  a.body = body;
  if (dtype == rama::kBF16) return static_cast<int>(rama::launch_all<__nv_bfloat16, int8_t>(a));
  if (dtype == rama::kF32) return static_cast<int>(rama::launch_all<float, int8_t>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split kernel that a launch of nq queries of nh heads over nkv kv heads
// of head_dim hd, `chunk` cache rows a CTA, on `body`, would run (int8
// cache if q8): out[0] its resident CTAs per SM, out[1] registers per
// thread, out[2] its dynamic shared memory in bytes. Launches nothing.
extern "C" int rama_decode_attention_occupancy(int nq, int nh, int nkv, int hd, int chunk,
                                               int q8, int dtype, int body, int* out) {
  rama::DaArgs a{};
  a.B = 1;
  a.nq = nq;
  a.nh = nh;
  a.nkv = nkv;
  a.S = chunk;
  a.hd = hd;
  a.chunk = chunk;
  a.occ = out;
  a.body = body;
  if (dtype != rama::kBF16 && dtype != rama::kF32) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = dtype == rama::kBF16;
  if (q8)
    return static_cast<int>(bf ? rama::launch_all<__nv_bfloat16, int8_t>(a)
                               : rama::launch_all<float, int8_t>(a));
  return static_cast<int>(bf ? rama::launch_all<__nv_bfloat16, __nv_bfloat16>(a)
                             : rama::launch_all<float, float>(a));
}
