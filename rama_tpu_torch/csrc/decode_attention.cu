// Kernels 4, 7, 9, 10 and 12: decode attention against layer l of the stacked
// KV cache, flash-decoding style, over a bf16 / f32 cache (K4) or an int8
// cache with one f32 scale per (token, kv head) row (K7), for one query per
// slot (T = 1) or a chunk of T consecutive queries per slot (K10, the
// speculative-verification chunk, on either cache), at any GQA group; K12
// runs all of these over a shared page pool through per-slot page tables
// (below).
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
// saw. Any T * rep rows: the tensor-core bodies hold 8, 16, 32 or 64 rows
// a CTA (the form, dattn_mma.cuh form_rows; more than 64 run as row groups
// of 64 on grid dimension y, nkv * groups), the SIMT body groups of 8; the
// splits stay a function of the cache's rows alone, never of the rows.
// Three bodies compute the splits (the wrappers pick one by dtype, head dim
// and cache, ops/kernels/decode_attention.py body_for):
//
//  - dattn_split (the SIMT body): fp32, and head dims other than 48 / 64
//    / 128. 16-byte lanes (8 bf16 / f32 or 16 int8 elements, RG lanes a
//    cache row) take fp32 dot products reduced by shuffles; P.V keeps
//    acc[ROWS][EPL] in registers, the row groups of a warp summed by
//    shuffles, the four warps through shared memory.
//  - dattn_mma (the tensor-core body): bf16 q at hd 48 / 64 / 128 on a
//    bf16 cache, dense or paged, for any number of query rows — the decode
//    steps (K4, K9, K12 decode) as the verification chunks (K10, K12's
//    chunk form). It replaces the SIMT body there because that body's time grew
//    with the rows (T = 4 / 8 took 2.6 / 5.2x the T = 1 split over the
//    same rows): ROWS dot products a row group, each reduced by log2(RG)
//    shuffles, and ROWS x EPL fp32 accumulators (163 registers at ROWS 8).
//    Decode steps take it too: rows are independent in it and the splits
//    are the same 64 rows, so a verification row computes bit for bit what
//    the decode step computes at its position, which greedy speculation
//    relies on (with the chunks alone on it, a random-weight 7B target as
//    its own draft accepted 0.81 of its drafts on an H100, not all: a 1-ulp
//    difference flips near-tied logits). It does both products on
//    mma.sync.m16n8k16 (bf16 in, fp32 accumulate), as K5's pattn_mma_kernel
//    (prefill_attention.cu) does:
//      * in the 8-row form (up to 8 query rows: every Llama-2 shape at T
//        <= 8, and the decode step of a GQA group <= 8) the rows are rows
//        0..7 of one m16 A tile (rows 8..15 are zero registers, never
//        loaded), read straight from a shared Q tile; the 16 / 32 /
//        64-row forms (a GQA group's verification chunk: TinyLlama's group
//        8 at T 8 is 64 rows) fill 1 / 2 / 4 whole m16 tiles, and the CTA
//        loads its split's K and V once for all its row blocks, as the
//        Pallas kernel's (1, hb, tr, hd) block holds a head group's rows,
//        then loops over the blocks in each product with the same K / V
//        fragment; each of the 4 warps owns 16 cache rows of the split
//        (two n8 tiles of S = Q K^T, K the column-major B operand through
//        ldmatrix);
//      * K / V rows land in shared memory by cp.async, every copy in
//        flight at once, rows padded so that ldmatrix is free of bank
//        conflicts, rows past the split's last visible one zero-filled
//        (and masked when scoring); V's copies form a second group that
//        lands while S is computed;
//      * each score is scaled by 1 / sqrt(hd) and masked by row_limit as
//        -inf; row max and sum over the split by quad shuffles, then
//        across the warps through 64 floats of shared memory; P rounded
//        to bf16 into a shared P tile of 8 x 64;
//      * O = P V with V the row-major B operand (ldmatrix.trans), the
//        output's 16-column pairs dealt to the warps, so each partial
//        row is written once from registers: no cross-warp sum of O.
//    38.4 KB of shared memory at hd 128 (63.5 KB at 64 rows: opted in above
//    48 KB once an instantiation and device). At 128-row pages the paged
//    forms' 64-row splits are the dense form's, so they equal the dense
//    kernel bit for bit.
//  - dattn_walk (the int8 walk body, a CTA walking tiles): bf16 q at hd
//    48 / 64 / 128 on an int8 cache, dense or paged, in the same row forms
//    and groups as dattn_mma (K7, K9 / K10 / K12 over int8); each form has
//    its own register cap (walk_ctas_per_sm) and the wrapper sizes the
//    grid from that form's residency. An int8 split of 64 rows carries half a bf16 split's bytes for
//    the same fixed cost (the Q tile, three barriers, the cross-warp max
//    and sum, a 512-byte partial a query row), and a grid of one CTA a
//    64-row split launched, at short positions of a long cache, mostly
//    CTAs that only exit (67 % of 16,384 in chip_smoke's K12 check). So:
//      * a split is G consecutive tiles of `tile` rows (64; a pool's
//        split_rows below 64-row pages), tiles at multiples of `tile`,
//        G a function of the cache's rows alone (ops/kernels/
//        decode_attention.py split_plan): never of the positions or of
//        T, so a chunk row and the decode row at its position, and a pool
//        and the dense cache of its rows (64- and 128-row pages), walk
//        the same tiles and splits;
//      * one CTA walks a split's tiles with an online softmax, as the
//        Pallas _kernel_tiled_q8 walks its S-tiles: each query row keeps
//        its running max and sum in fp32 and its o in the mma accumulators,
//        rescaled by e^(m_run - m_new) at each tile; P is rounded to bf16
//        (after the vs[s] scale) against the running max. A tile wholly
//        past a row's limit leaves its (m, l, o) as they were bit for bit
//        (the factor exactly 1, P exactly 0);
//      * a tile's copies are cp.async groups: K with the row scales (4-byte
//        cp.async, one a thread; not plain loads between the copies) and,
//        at a split's start, the Q rows, then V, which lands while S is
//        scored. One stage, settled on an H100: a ring of
//        two stages (the next tile in flight while this one is scored, 43.6
//        KB and 94-123 registers at hd 128) held 2-5 CTAs an SM and was
//        slower than one stage (22.6 KB) capped at 80 registers for six
//        CTAs an SM, whose other CTAs hide a tile's latency; cp.async and
//        not TMA, as a tile's rows past the slot's last visible one must
//        read as zeros, which cp.async's zero-fill gives per 16-byte piece;
//      * the grid is (ctas, nkv * groups): the CTAs of a (kv head, row
//        group) walk the list of its (slot, split) items that hold a
//        visible row, slot-major, item x, x + ctas, ..., so no CTA is
//        launched for a split past a slot's position; ctas = min(B *
//        nsplit, one wave of the launched form / (nkv * groups))
//        (decode_attention.py walk_ctas, walk_wave);
//      * int8 rows stay bytes in shared memory and become bf16 in registers
//        after ldmatrix (exact: |x| <= 127) by byte permutes and an fp32
//        add, no conversion instruction (int8x4_f32: I2F / F2F issue at a
//        fraction of the ALU rate and a tile converts 2 x 64 x hd bytes,
//        which took longer than the tile's bytes at S 1024 on an H100):
//        ldmatrix hands each lane four consecutive bytes of a K row, so the
//        k order of Q K^T is permuted alike for Q (a free change of
//        summation order), and ldmatrix.trans hands it two dims of two V
//        rows, the even and the odd dims making two n8 tiles of P V; writing bf16
//        tiles first instead was 9-16 % slower on the int8 splits of an
//        H100 (on dattn_mma's body) and took twice the shared memory;
//      * a second small kernel (dattn_combine_rows) combines each query
//        row's <= ceil(S / (tile G)) partials: a warp a row, lane i's split
//        weight e^(m_i - M) broadcast by shuffles, eight partials in
//        flight a lane;
//      * given a chunk's new K / V rows (kn / vn: a verify round, a dense
//        or paged decode step, a paged round), the walk writes them
//        itself, as K11 (dense), K6 (the dense decode step) or K13 (a)
//        (paged) would before it: a launch of their own took 2.0-3.4 us
//        of device time (and ~35 us of host time) for 0.2-0.8 MB at 7B,
//        far below any bound. Each new row lands at the slot's position
//        the standalone writer's rule gives (new_pos: a dense row past S
//        dropped, the decode step's row clamped onto row S - 1, a pool row
//        past the table clipped into page mp - 1), so in exactly the tile the unfused
//        order would read it from; the CTA whose items hold that tile
//        (each row group's) quantizes the row from kn / vn and stores it
//        into the cache before its walk starts, and its walk then copies
//        it like any row (only a CTA's own stores precede its copies, so
//        only a tile one CTA reaches can take it). The kv head's last row
//        group walks every tile with a new row. The tiles, splits and
//        sums stay as they are:
//        outputs equal the writer followed by the walk bit for bit, the
//        cache byte for byte. A separate instantiation (dattn_walk<…,
//        WRITE>) keeps the walk without rows (K9, and K7 / K10 / K12
//        called without rows) the parent's code, instruction for
//        instruction.
//        Only a page that the tables hold twice (one slot's entries or
//        two slots': the engine's trash page) can show new rows written
//        through its other entry, or miss them, where the unfused order
//        shows them (ROADMAP §3).
//
// Kernel 12, the paged forms (rama_tpu/ops/pallas/paged_attention.py:
// _paged_call via paged_decode_attention_layer, _q8, paged_chunk_
// attention_layer (:156) and _q8 (:179)): the same bodies over a shared
// page pool (L, P, nkv, ps, hd) and per-slot page tables (B, mp). The TPU
// kernel walks a slot's pages in order and repeats the last used page so
// its DMA is elided; here a split of `chunk` rows (a tile of the walk
// body), chunk dividing ps, lies inside one page, so only the address of
// its rows changes: the rows from s0 of slot b are those of page
// clamp(table[b, min(s0 / ps, mp - 1)], 0, P - 1) from in-page row s0 %
// ps, with S = mp * ps for the row limits (a walk split of G tiles may
// span pages: each tile finds its own). Splits past the last row's limit
// exit (or, on the walk body, are never walked) as in the dense cache, so
// a slot pays for the pages it uses whatever mp is (ragged).
#include "attention.cuh"
#include "dattn_mma.cuh"
#include "kv_quant.cuh"

#include <math.h>

#include <type_traits>

namespace rama {

enum Body : int { kBodySimt = 0, kBodyMma = 1, kBodyWalk = 2 };  // decode_attention.py BODIES

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

// Where the new row at position p of a slot lands among the slot's rows,
// by the standalone writers' rule: the dense cache's row p, or -1 (dropped)
// outside [0, S) (K11, kv_write.cu kv_write_chunk), or, for the dense
// decode step's one row a slot (clamp), row clamp(p, 0, S - 1) (K6,
// kv_write_rows: a finished slot's overshoot lands on the last row, the
// row its query sees, row_limit); the pool's position max(p, 0), a row
// past the table (p >= S = mp * ps) at its clip position (mp - 1) ps + p %
// ps, in-page row p % ps of page mp - 1 (K13 (a), kv_write_paged).
__device__ __forceinline__ int new_pos(bool paged, bool clamp, int p, int S, int ps) {
  if (!paged) return clamp ? max(0, min(p, S - 1)) : p >= 0 && p < S ? p : -1;
  return p < 0 ? 0 : p < S ? p : S - ps + p % ps;
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

// grid (nsplit, nkv * groups, B), block 128. T: q's dtype; C: the cache's
// (T, or int8_t with row scales ksc / vsc, which are null otherwise). q is
// (B, nq, nh, hd); partials are indexed by query row (b * nq + t) * nh + h.
// RG = lanes per cache row (each lane EPL elements of hd, RG = next power
// of two >= hd/EPL); a CTA holds ROWS of the kv head's nq * rep query rows,
// from row r0 = (blockIdx.y / nkv) * ROWS: more than kMaxRows run as
// groups of 8, each group re-reading its split. The CTA first copies its
// chunk of K and V (and their scales) into shared memory with every copy in
// flight at once, so that it waits on the memory once, not once a row group.
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
  constexpr bool kGroups = ROWS == kMaxRows;   // row groups: only in the 8-row form
  const int split = blockIdx.x, j = kGroups ? blockIdx.y % nkv : blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x, tid = threadIdx.x;
  const int rep = nh / nkv;
  const int r0 = kGroups ? blockIdx.y / nkv * ROWS : 0;   // the CTA's first query row
  const int rows = kGroups ? min(nq * rep - r0, ROWS) : nq * rep;
  const int p0 = pos0[b];
  // the largest limit of the CTA's rows
  const int last = row_limit(p0, kGroups ? (r0 + rows - 1) / rep : nq - 1, S);
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
    const int ri = i / hd, d = i - ri * hd, r = r0 + ri;
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
        sc[r * chunk + i] = s0 + i <= row_limit(p0, (r0 + r) / rep, S) ? v : -INFINITY;
      }
    }
  }
  __syncthreads();

  // chunk max / sum per query row; probabilities (times the V row scale,
  // for int8) rounded to T for P.V. A row that sees no row of this chunk
  // gets zero probabilities and no (m, l): its combine never reads here.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += kDaThreads / 32) {
    const int t = (r0 + r) / rep;
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
      const size_t hr = ((size_t)b * nq + t) * nh + (size_t)j * rep + (r0 + r - t * rep);
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
    const int ri = i / hd, d = i - ri * hd, r = r0 + ri;
    const int t = r / rep;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kDaThreads / 32; ++w) v += red[(size_t)w * rows * hd + i];
    const size_t hr = ((size_t)b * nq + t) * nh + (size_t)j * rep + (r - t * rep);
    part_o[(hr * nsplit + split) * hd + d] = v;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core body (dattn_mma): bf16 q, hd 48 / 64 / 128, a bf16 cache,
// in the ROWS-row forms; the body itself is dattn_mma_body (dattn_mma.cuh,
// shared with K14). Fragment coordinates: mma.cuh (lane = 4 g + c).

// grid (nsplit, nkv * groups, B), block 128; the operands and partials as
// dattn_split's, chunk <= kMaxChunk, q, kc, vc 16-byte aligned. A CTA holds
// ROWS of the kv head's nq * rep query rows from r0 = (blockIdx.y / nkv) *
// ROWS (groups > 1 only in the 64-row form).
template <int HD, int ROWS>
__global__ void __launch_bounds__(kDaThreads)
dattn_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
          const __nv_bfloat16* __restrict__ vc, const int* __restrict__ pos0,
          float* __restrict__ part_o, float* __restrict__ part_ml, int nh, int nkv, int S,
          int chunk, int nq, float scale, const int* __restrict__ tables, int mp, int ps,
          int npages) {
  constexpr int LD = MmaSmem<HD, ROWS>::LD;
  constexpr int QCH = HD / 8;                 // 16-byte pieces of a bf16 row
  extern __shared__ __align__(16) unsigned char smraw[];
  constexpr bool kGroups = ROWS == kGroupRows;   // row groups: only in the 64-row form
  const int split = blockIdx.x, j = kGroups ? blockIdx.y % nkv : blockIdx.y, b = blockIdx.z;
  const int rep = nh / nkv;
  const int r0 = kGroups ? blockIdx.y / nkv * ROWS : 0;   // the CTA's first query row
  const int rows = kGroups ? min(nq * rep - r0, ROWS) : nq * rep;
  const int p0 = pos0[b];
  // the largest limit of the CTA's rows
  const int last = row_limit(p0, kGroups ? (r0 + rows - 1) / rep : nq - 1, S);
  const int s0 = split * chunk;
  if (s0 > last) return;  // no row's combine reads this split
  const int n = min(s0 + chunk, last + 1) - s0;
  const size_t srow = first_row(tables, b, j, s0, S, nkv, mp, ps, npages);
  // Q rows 0..rows-1 (row r: head j * rep + (r0 + r) % rep at pos0 + (r0 +
  // r) / rep), the rest zero
  auto load_q = [&](__nv_bfloat16* Qs) {
    for (int i = threadIdx.x; i < ROWS * QCH; i += kDaThreads) {
      const int r = i / QCH, ch = i % QCH, t = (r0 + r) / rep;
      const bool ok = r < rows;
      cp_async16_zfill(Qs + r * LD + ch * 8,
                       ok ? q + (((size_t)b * nq + t) * nh + (size_t)j * rep +
                                 (r0 + r - t * rep)) * HD + ch * 8
                          : q,
                       ok);
    }
  };
  dattn_mma_body<HD, false, ROWS>(kc, vc, part_o, part_ml, b, j, split, gridDim.x, nh, nkv, nq,
                                  s0, n, srow, scale, load_q,
                                  [&](int t) { return row_limit(p0, t, S); }, smraw, r0);
}

// ---------------------------------------------------------------------------
// The int8 walk body (dattn_walk): bf16 q, hd 48 / 64 / 128, the row
// forms of dattn_mma, an int8 cache with f32 row scales, dense or paged
// (design above).

// Two 8x8 b16 matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// The four int8 bytes of w as exact fp32 values with no conversion
// instruction (I2F and F2F issue at a fraction of the ALU rate, and a tile
// converts 2 x 64 x hd bytes): byte i, offset by 128, becomes the low byte
// of 2^23's mantissa, then 2^23 + 128 is subtracted.
__device__ __forceinline__ void int8x4_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f;
}

// Two such values (|x| <= 128: their low 16 bits are zero) as a bf16 pair,
// exactly: their high halves (.x, the low half, = lo).
__device__ __forceinline__ uint32_t bf16x2_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 4 bytes (one row scale) global -> shared; zeros (and no read of src) when !ok.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

// The walk's resident CTAs an SM, by form, which caps its registers
// (__launch_bounds__): six for the 8-row form (80 registers at hd 128); the
// row-block forms keep two or four rows' online-softmax state and o a lane
// and block, so fewer (102 / 168 / 255 registers at 16 / 32 / 64 rows).
template <int ROWS>
constexpr int walk_ctas_per_sm() {
  return ROWS == kMaxRows ? 6 : ROWS == 16 ? 5 : ROWS == 32 ? 3 : 2;
}

// Shared memory of one dattn_walk CTA of the ROWS-row form: the K and V
// tiles of kMaxChunk int8 rows of RLD bytes (hd + 16 or + 32: an odd number
// of 16-byte pieces, so ldmatrix's eight rows fall in distinct banks) and
// their f32 row scales ks, vs [kMaxChunk]; a bf16 Q tile [ROWS][hd + 8], P
// [ROWS][kMaxChunk + 8] bf16, f32 row maxima and sums [warps][ROWS], and
// the walk's table of 2 B + 1 ints (walk_smem: 22,596 bytes at hd 128, 8
// rows and 8 slots; 47,684 at 64 rows, above 48 KB past 191 slots).
template <int HD, int ROWS = kMaxRows>
struct WalkSmem {
  static constexpr int LD = HD + kMmaPad;          // bf16 Q row stride (elements)
  static constexpr int PLD = kMaxChunk + kMmaPad;  // bf16 P row stride (elements)
  static constexpr int RLD = ((HD + 16) / 16) % 2 ? HD + 16 : HD + 32;   // int8 row (bytes)
  static constexpr size_t kv = (size_t)kMaxChunk * RLD;
  static constexpr size_t fixed = 2 * kv + 2 * sizeof(float) * kMaxChunk +
                                  sizeof(__nv_bfloat16) * ROWS * (LD + PLD) +
                                  sizeof(float) * 2 * kDaWarps * ROWS;
};
template <int HD, int ROWS>
inline size_t walk_smem(int B) {
  return WalkSmem<HD, ROWS>::fixed + sizeof(int) * (2 * (size_t)B + 1);
}
static_assert(kDaThreads == 2 * kMaxChunk, "one thread copies each row scale of a tile");

// Where a dattn_walk CTA is in its walk: item `item` of its kv head's
// (slot, split) list -- slot-major, each slot's splits that hold a row one
// of its queries sees -- and tile t of the item's tiles [split * G, t1).
// first[b] (the slot's first item) and ntile[b] (its tiles with a visible
// row) are the CTA's shared table.
struct Walk {
  int item, b, split, t, t1;
};

// Move w to the slot that holds w.item (items only grow, so from slot w.b
// on) and to its split's first tile; w.b == B once the list is done.
__device__ __forceinline__ void walk_seek(Walk& w, const int* first, const int* ntile,
                                          int B, int G) {
  while (w.b < B && w.item >= first[w.b + 1]) ++w.b;
  if (w.b < B) {
    w.split = w.item - first[w.b];
    w.t = w.split * G;
    w.t1 = min(w.t + G, ntile[w.b]);
  }
}

// grid (ctas, nkv * groups), block 128: CTA x of (kv head j, row group)
// walks items x, x + ctas, ... of its list, tile by tile, with an online
// softmax over the tiles of each split, and writes each split's partial
// (m, l, o) per query row that sees it. A CTA holds ROWS of the kv head's
// nq * rep query rows, from r0 = (blockIdx.y / nkv) * ROWS (groups > 1
// only in the 64-row form); in the row-block forms each K / V fragment is
// turned into bf16 once for all the row blocks. A tile's copies are two
// cp.async groups, K with the row scales (and, at a split's start, the Q
// rows), then V, which lands while S is scored. Operands and partials as
// dattn_split's; nsplit = ceil(ceil(S / tile) / G); tile <= kMaxChunk
// (dividing ps for a pool).
//
// WRITE: the launch also writes the chunk's new K / V rows kn / vn (B, nq,
// nkv, HD) bf16 (post RoPE), as K11 (dense), K6 (dense, nq 1, clamp) or
// K13 (a) (paged) would before it. Row t lands at the slot's position
// new_pos(pos0 + t), by K6's rule where clamp is set (read only here).
// Before its walk, each CTA quantizes the new rows that land in the tiles
// of its own items, bit for bit as kv_quant_rows (kv_quant.cuh; warp w
// takes (row t, k or v) w, w + 4, ...), stores them into the cache, and
// only then starts the walk, whose copies read them back like any other
// row: each new row's tile is walked by one CTA a row group, and a CTA's
// stores precede its own copies (the barrier). Row groups (64-row form)
// that walk one tile store the same bytes; the kv head's last group walks
// every tile with a new row. Across CTAs this is a race: one row group's
// stores may land while another group's CTA copies that tile (cp.async).
// It is safe only because every writer of a row stores identical bytes
// (the same rows, quantized by the same code, whatever the group): a
// change that makes a group's bytes differ (say, a scale per row group)
// breaks it, and must leave the store to one group with a grid-wide order.
// The walk itself is the parent's code.
template <int HD, int ROWS, bool WRITE>
__global__ void __launch_bounds__(kDaThreads, walk_ctas_per_sm<ROWS>())
dattn_walk(const __nv_bfloat16* __restrict__ q, int8_t* __restrict__ kc,
           int8_t* __restrict__ vc, float* __restrict__ ksc, float* __restrict__ vsc,
           const int* __restrict__ pos0, float* __restrict__ part_o,
           float* __restrict__ part_ml, int B, int nh, int nkv, int S, int tile, int G,
           int nsplit, int nq, float scale, const int* __restrict__ tables, int mp, int ps,
           int npages, const __nv_bfloat16* __restrict__ kn,
           const __nv_bfloat16* __restrict__ vn, int clamp) {
  using Sm = WalkSmem<HD, ROWS>;
  constexpr int LD = Sm::LD, PLD = Sm::PLD, RLD = Sm::RLD;
  constexpr int NB = RowForm<ROWS>::NB, NH = RowForm<ROWS>::NH;
  constexpr int KS = HD / 16;                 // k-steps of Q K^T = 16-byte pieces of a row
  constexpr int QCH = HD / 8;                 // 16-byte pieces of a bf16 Q row
  constexpr int PW = (KS + kDaWarps - 1) / kDaWarps;   // column pairs of O a warp
  constexpr bool QONE = ROWS * QCH <= kDaThreads;      // one Q piece a thread at most
  extern __shared__ __align__(16) unsigned char smraw[];
  unsigned char* Kt = smraw;                                       // [kMaxChunk][RLD]
  unsigned char* Vt = Kt + Sm::kv;                                 // [kMaxChunk][RLD]
  float* kst = reinterpret_cast<float*>(Vt + Sm::kv);              // [kMaxChunk] ks, then vs
  const float* vst = kst + kMaxChunk;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(kst + 2 * kMaxChunk);   // [ROWS][LD]
  __nv_bfloat16* Ps = Qs + ROWS * LD;                              // [ROWS][PLD]
  float* red_m = reinterpret_cast<float*>(Ps + ROWS * PLD);       // [warps][ROWS]
  float* red_l = red_m + kDaWarps * ROWS;                          // [warps][ROWS]
  int* first = reinterpret_cast<int*>(red_l + kDaWarps * ROWS);   // [B + 1]
  int* ntile = first + B + 1;                                      // [B]

  constexpr bool kGroups = ROWS == kGroupRows;   // row groups: only in the 64-row form
  const int j = kGroups ? blockIdx.y % nkv : blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int rep = nh / nkv;
  const int r0 = kGroups ? blockIdx.y / nkv * ROWS : 0;   // the CTA's first query row
  const int rows = kGroups ? min(nq * rep - r0, ROWS) : nq * rep;
  const int tlast = kGroups ? (r0 + rows - 1) / rep : nq - 1;   // the query of its last row
  const int kb = warp * 16;                   // this warp's 16 rows of a tile
  const int tpp = tables ? ps / tile : 1;     // tiles a page

  // the walk's table: slot b's tiles with a visible row and first item
  for (int b = tid; b < B; b += kDaThreads) {
    ntile[b] = row_limit(pos0[b], tlast, S) / tile + 1;
    first[b + 1] = (ntile[b] + G - 1) / G;    // its splits, summed below
  }
  __syncthreads();
  if (tid == 0) {
    first[0] = 0;
    for (int b = 0; b < B; ++b) first[b + 1] += first[b];
  }
  __syncthreads();

  // (WRITE) the new rows that land in the tiles this CTA will walk: warp w
  // quantizes (row t, k or v) jobs w, w + 4, ... of each of its items and
  // stores them into the cache, before the walk's own copies read them
  if constexpr (WRITE) {
    for (int item = blockIdx.x, b = 0; item < first[B]; item += gridDim.x) {
      while (item >= first[b + 1]) ++b;
      const int t0 = (item - first[b]) * G;   // the item's tiles [t0, t1)
      const int lo = t0 * tile, hi = min(t0 + G, ntile[b]) * tile;
      for (int jb = warp; jb < 2 * nq; jb += kDaWarps) {
        const int t = jb / 2, lp = new_pos(tables, clamp, pos0[b] + t, S, ps);
        if (lp < lo || lp >= hi) continue;    // the whole warp
        const bool isv = jb % 2;
        uint2 u = make_uint2(0u, 0u);
        if (lane < HD / 4)
          u = *reinterpret_cast<const uint2*>((isv ? vn : kn) +
                                              (((size_t)b * nq + t) * nkv + j) * HD + 4 * lane);
        float sc;
        const uint32_t packed = quant_row4<HD>(u, lane, sc);
        const size_t d = first_row(tables, b, j, lp, S, nkv, mp, ps, npages);
        if (lane < HD / 4) *reinterpret_cast<uint32_t*>((isv ? vc : kc) + d * HD + 4 * lane) = packed;
        if (lane == 0) (isv ? vsc : ksc)[d] = sc;
      }
    }
    __syncthreads();                          // the stores before any copy of the walk
  }

  // this thread's Q piece where one is enough (tid < ROWS * QCH): row rq of
  // the CTA's rows
  const int rq = tid / QCH, tq = (r0 + rq) / rep;
  const size_t qoff = rq < rows ? ((size_t)tq * nh + (size_t)j * rep + (r0 + rq - tq * rep)) *
                                      HD + (tid % QCH) * 8
                                : 0;

  // the copies of walk position w's tile (rows past the slot's last visible
  // row zero): K, both row scales (P needs vs before V) and (a split's first
  // tile) Q as one group, then V, which the caller commits
  auto load = [&](const Walk& w, int n) {
    const int s0 = w.t * tile;
    size_t srow;                              // the tile's first row in the cache / pool
    if (tables) {
      const int pg = w.t / tpp;
      const int page = min(max(tables[(size_t)w.b * mp + min(pg, mp - 1)], 0), npages - 1);
      srow = ((size_t)page * nkv + j) * ps + (w.t - pg * tpp) * tile;
    } else {
      srow = ((size_t)w.b * nkv + j) * S + s0;
    }
    const int8_t* kg = kc + srow * HD;
    const int8_t* vg = vc + srow * HD;
    const int r = tid % kMaxChunk;            // the row of this thread's scale
#pragma unroll
    for (int i = tid; i < kMaxChunk * KS; i += kDaThreads)
      cp_async16_zfill(Kt + (i / KS) * RLD + (i % KS) * 16, kg + (i / KS < n ? i * 16 : 0),
                       i / KS < n);
    cp_async4_zfill(kst + tid, (tid < kMaxChunk ? ksc : vsc) + srow + (r < n ? r : 0), r < n);
    if (w.t == w.split * G) {                 // a split's first tile: the slot's Q
      const __nv_bfloat16* qb = q + (size_t)w.b * nq * nh * HD;
      if constexpr (QONE) {
        if (tid < ROWS * QCH)
          cp_async16_zfill(Qs + rq * LD + (tid % QCH) * 8, qb + qoff, rq < rows);
      } else {
        for (int i = tid; i < ROWS * QCH; i += kDaThreads) {
          const int ri = i / QCH, ti = (r0 + ri) / rep;
          const bool ok = ri < rows;
          cp_async16_zfill(Qs + ri * LD + (i % QCH) * 8,
                           qb + (ok ? ((size_t)ti * nh + (size_t)j * rep + (r0 + ri - ti * rep)) *
                                              HD + (i % QCH) * 8
                                    : 0),
                           ok);
        }
      }
    }
    cp_async_commit();
#pragma unroll
    for (int i = tid; i < kMaxChunk * KS; i += kDaThreads)
      cp_async16_zfill(Vt + (i / KS) * RLD + (i % KS) * 16, vg + (i / KS < n ? i * 16 : 0),
                       i / KS < n);
  };

  Walk cur{(int)blockIdx.x, 0, 0, 0, 0};
  walk_seek(cur, first, ntile, B, G);

  // each lane's query rows 16 rb + 8 h + g: their query, the limit in this
  // split, and the running max, sum and o of the online softmax
  int t_r[NB][NH], lim_r[NB][NH] = {};
  bool sees[NB][NH] = {};
  float m_run[NB][NH], l_run[NB][NH];
  float o[NB][PW][2][4] = {};
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      t_r[rb][h] = (r0 + rb * 16 + h * 8 + g) / rep;
      m_run[rb][h] = -INFINITY;
      l_run[rb][h] = 0.f;
    }
  while (cur.b < B) {
    const int s0 = cur.t * tile;
    const int n = min(tile, row_limit(pos0[cur.b], tlast, S) + 1 - s0);
    const int kr = (n + 15) & ~15;
    load(cur, n);
    cp_async_commit();
    cp_async_wait<1>();                       // this tile's K (and Q) copies
    __syncthreads();                          // ... everyone's
    if (cur.t == cur.split * G) {             // a split starts
#pragma unroll
      for (int rb = 0; rb < NB; ++rb)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const int r = rb * 16 + h * 8 + g;
          lim_r[rb][h] = row_limit(pos0[cur.b], t_r[rb][h], S);
          sees[rb][h] = r < rows && s0 <= lim_r[rb][h];   // row r sees a row of this split
        }
    }

    // S = Q K^T over this warp's 16 rows of the tile, the int8 bytes turned
    // into bf16 in registers after ldmatrix (dims 4c..4c+3 of a row's
    // 16-dim step: the k order of the product permuted alike for Q), once
    // for every row block; rows past a query row's limit or past the
    // tile's n score -inf
    float sc[NB][2][2 * NH];                  // [block][n8 tile][2 h + e]
    if (kb < kr) {
      float acc[NB][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[2];
        float f0[4], f1[4];
        ldsm_x2(kf, Kt + (kb + ((lane / 8) % 2) * 8 + lane % 8) * RLD + ks * 16);
        int8x4_f32(kf[0], f0);
        int8x4_f32(kf[1], f1);
        const uint32_t b00 = bf16x2_hi(f0[0], f0[1]), b01 = bf16x2_hi(f0[2], f0[3]);
        const uint32_t b10 = bf16x2_hi(f1[0], f1[1]), b11 = bf16x2_hi(f1[2], f1[3]);
#pragma unroll
        for (int rb = 0; rb < NB; ++rb) {
          const __nv_bfloat16* qp = Qs + (rb * 16 + g) * LD + ks * 16 + 4 * c;
          const uint2 q0 = *reinterpret_cast<const uint2*>(qp);
          uint2 q1 = make_uint2(0u, 0u);
          if constexpr (NH > 1) q1 = *reinterpret_cast<const uint2*>(qp + 8 * LD);
          const uint32_t a[4] = {q0.x, q1.x, q0.y, q1.y};
          mma_bf16(acc[rb][0], a, b00, b01);
          mma_bf16(acc[rb][1], a, b10, b11);
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
                                          ? acc[rb][nt][2 * h + e] * kst[i] * scale
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
    __syncthreads();

    // the running max m_new; probabilities against it (times the V row
    // scale) rounded to bf16 into P; o and l rescaled by e^(m_run - m_new).
    // A tile wholly past the row's limit leaves (m, l, o) as they were, bit
    // for bit: m_new = m_run, the factor exactly 1, P exactly 0.
    float alpha[NB][NH], mref[NB][NH], l[NB][NH];
#pragma unroll
    for (int rb = 0; rb < NB; ++rb)
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const int r = rb * 16 + h * 8 + g;
        float m_new = m_run[rb][h];
#pragma unroll
        for (int w = 0; w < kDaWarps; ++w) m_new = fmaxf(m_new, red_m[w * ROWS + r]);
        mref[rb][h] = m_new == -INFINITY ? 0.f : m_new;   // a row that has seen nothing
        alpha[rb][h] = m_new == m_run[rb][h] ? 1.f : expf(m_run[rb][h] - mref[rb][h]);
        m_run[rb][h] = m_new;
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
              const float ex = expf(sc[rb][nt][2 * h + e] - mref[rb][h]);   // -inf -> 0
              l[rb][h] += ex;
              p[e] = ex * vst[kb + nt * 8 + 2 * c + e];
            }
            *reinterpret_cast<uint32_t*>(Ps + (rb * 16 + h * 8 + g) * PLD + kb + nt * 8 +
                                         2 * c) = pack_bf16(p[0], p[1]);
          }
    }
#pragma unroll
    for (int rb = 0; rb < NB; ++rb)
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float ls = quad_sum(l[rb][h]);
        if (c == 0) red_l[warp * ROWS + rb * 16 + h * 8 + g] = ls;
      }
    cp_async_wait<0>();                       // V
    __syncthreads();
#pragma unroll
    for (int rb = 0; rb < NB; ++rb)
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float lt = 0.f;
#pragma unroll
        for (int w = 0; w < kDaWarps; ++w) lt += red_l[w * ROWS + rb * 16 + h * 8 + g];
        l_run[rb][h] = l_run[rb][h] * alpha[rb][h] + lt;
      }

    // O = O * alpha + P V: warp w owns output columns 16 (w + 4 u) .. + 15;
    // ldmatrix.trans gives lane (g, c) bytes of dims 2g, 2g + 1 for rows 2c,
    // 2c + 1, so the even and the odd dims are two n8 tiles and lane (g, c)
    // ends with dims 4c .. 4c + 3 of its rows
#pragma unroll
    for (int rb = 0; rb < NB; ++rb)
#pragma unroll
      for (int u = 0; u < PW; ++u)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[rb][u][nt][e] *= alpha[rb][NH > 1 ? e / 2 : 0];
    for (int kk = 0; kk < kr / 16; ++kk) {
      uint32_t a[NB][4];
#pragma unroll
      for (int rb = 0; rb < NB; ++rb) a_frag<NH>(a[rb], Ps, PLD, rb, g, c, kk * 16);
#pragma unroll
      for (int u = 0; u < PW; ++u) {
        const int dp = warp + u * kDaWarps;
        if (dp < KS) {
          uint32_t vf[2];
          float f0[4], f1[4];
          ldsm_x2_trans(vf, Vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * RLD + dp * 16);
          int8x4_f32(vf[0], f0);
          int8x4_f32(vf[1], f1);
          const uint32_t be0 = bf16x2_hi(f0[0], f0[2]), be1 = bf16x2_hi(f1[0], f1[2]);
          const uint32_t bo0 = bf16x2_hi(f0[1], f0[3]), bo1 = bf16x2_hi(f1[1], f1[3]);
#pragma unroll
          for (int rb = 0; rb < NB; ++rb) {
            mma_bf16(o[rb][u][0], a[rb], be0, be1);
            mma_bf16(o[rb][u][1], a[rb], bo0, bo1);
          }
        }
      }
    }

    if (cur.t + 1 == cur.t1) {                // the split's last tile: its partials
#pragma unroll
      for (int rb = 0; rb < NB; ++rb)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          if (sees[rb][h]) {
            const int r = r0 + rb * 16 + h * 8 + g, t = t_r[rb][h];
            const size_t hr = ((size_t)cur.b * nq + t) * nh + (size_t)j * rep + (r - t * rep);
            const size_t at = hr * nsplit + cur.split;
            if (warp == 0 && c == 0) {
              part_ml[at * 2] = m_run[rb][h];
              part_ml[at * 2 + 1] = l_run[rb][h];
            }
#pragma unroll
            for (int u = 0; u < PW; ++u) {
              const int dp = warp + u * kDaWarps;
              if (dp < KS)
                *reinterpret_cast<float4*>(part_o + at * HD + dp * 16 + 4 * c) =
                    make_float4(o[rb][u][0][2 * h], o[rb][u][1][2 * h], o[rb][u][0][2 * h + 1],
                                o[rb][u][1][2 * h + 1]);
            }
          }
          m_run[rb][h] = -INFINITY;
          l_run[rb][h] = 0.f;
        }
#pragma unroll
      for (int rb = 0; rb < NB; ++rb)
#pragma unroll
        for (int u = 0; u < PW; ++u)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[rb][u][nt][e] = 0.f;
    }
    if (++cur.t == cur.t1) {
      cur.item += gridDim.x;
      walk_seek(cur, first, ntile, B, G);
    }
    __syncthreads();                          // every read of the tiles and of P done
  }
}

// grid (ceil(B * nq * nh / kDaWarps)), block 128: warp w of CTA x combines
// query row hr = x * kDaWarps + w ((b * nq + t) * nh + h) over the splits i
// <= limit / split_len it saw: out = sum_i e^(m_i - M) o_i / sum_i e^(m_i -
// M) l_i, lane i's split weight broadcast by shuffles, lane d holding dims
// 4d .. 4d + 3, eight partials in flight a lane.
template <typename T>
__global__ void __launch_bounds__(kDaThreads)
dattn_combine_rows(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                   const int* __restrict__ pos0, T* __restrict__ out, int nrows, int nh, int S,
                   int hd, int split_len, int nsplit, int nq) {
  constexpr int U = 8;
  const int lane = threadIdx.x % 32;
  const int hr = blockIdx.x * kDaWarps + threadIdx.x / 32;
  if (hr >= nrows) return;                    // the whole warp
  const int b = hr / (nq * nh), t = (hr / nh) % nq;
  const int nv = row_limit(pos0[b], t, S) / split_len + 1;
  const float* ml = part_ml + (size_t)hr * nsplit * 2;
  float mx = -INFINITY;
  for (int i = lane; i < nv; i += 32) mx = fmaxf(mx, ml[2 * i]);
  mx = warp_max(mx);
  const bool act = 4 * lane < hd;
  const float* po = part_o + (size_t)hr * nsplit * hd + (act ? 4 * lane : 0);
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float L = 0.f;
  for (int base = 0; base < nv; base += 32) {
    float w = 0.f;
    if (base + lane < nv) {
      const float2 e = *reinterpret_cast<const float2*>(ml + 2 * (base + lane));
      w = expf(e.x - mx);
      L += w * e.y;
    }
    const int cnt = min(32, nv - base);
    for (int s = 0; s < cnt; s += U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = act && s + u < cnt
                   ? *reinterpret_cast<const float4*>(po + (size_t)(base + s + u) * hd)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float ws = __shfl_sync(0xffffffffu, w, (s + u) & 31);
        if (s + u < cnt) {
          o.x += ws * v[u].x;
          o.y += ws * v[u].y;
          o.z += ws * v[u].z;
          o.w += ws * v[u].w;
        }
      }
    }
  }
  L = warp_sum(L);
  if (act) {
    T* dst = out + (size_t)hr * hd + 4 * lane;
    dst[0] = from_f<T>(o.x / L);
    dst[1] = from_f<T>(o.y / L);
    dst[2] = from_f<T>(o.z / L);
    dst[3] = from_f<T>(o.w / L);
  }
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
  int body;  // kBodySimt, kBodyMma or kBodyWalk
  int tiles = 1;  // G: tiles of `chunk` rows a split (1 but on the walk body)
  int ctas = 0;   // the walk body's CTAs a (kv head, row group)
  int groups = 1;  // row groups a kv head: grid dimension y is nkv * groups
  int* ran = nullptr;  // non-null: set to the query rows a CTA of the launched form
  // the walk body only: the chunk's new K / V rows (B, nq, nkv, hd) bf16,
  // written by the launch (dattn_walk); null: none. clamp: by K6's rule (the
  // dense decode step, nq 1), not K11's (new_pos)
  const void *knew = nullptr, *vnew = nullptr;
  int clamp = 0;
};

// Report kern's resident CTAs per SM, registers per thread and shared
// bytes per CTA (at `smem`) in a.occ.
template <class K>
cudaError_t report(const DaArgs& a, K kern, size_t smem) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a.occ[0], kern, kDaThreads, smem);
  a.occ[1] = fa.numRegs;
  a.occ[2] = (int)smem;
  return e;
}

// Opt kern into `most` bytes of dynamic shared memory (once an
// instantiation and device), then launch it with `smem` over the split
// grid and note its form (`rows` query rows a CTA) in a.ran, or, with
// a.occ, report it instead.
template <class K, class... Args>
cudaError_t launch_or_report(const DaArgs& a, int rows, SmemOptIn& opt_in, K kern,
                             size_t most, size_t smem, Args... args) {
  if (most > 48 * 1024) {
    cudaError_t e = opt_in.set(kern, most);
    if (e != cudaSuccess) return e;
  }
  if (a.occ) return report(a, kern, smem);
  kern<<<dim3(a.nsplit, a.nkv * a.groups, a.B), kDaThreads, smem, a.st>>>(args...);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && a.ran) *a.ran = rows;
  return e;
}

template <typename T, typename C, int RG, int ROWS>
cudaError_t launch_split(const DaArgs& a) {
  static SmemOptIn opt_in;   // at the most any chunk and hd of this instantiation need
  return launch_or_report(
      a, ROWS, opt_in, dattn_split<T, C, RG, ROWS>,
      split_smem<C, ROWS>(kMaxChunk, RG * Lane<C>::EPL), split_smem<C, ROWS>(a.chunk, a.hd),
      static_cast<const T*>(a.q), static_cast<const C*>(a.k), static_cast<const C*>(a.v),
      a.ks, a.vs, a.pos0, a.part_o, a.part_ml, a.nh, a.nkv, a.S, a.hd, a.chunk, a.nq,
      a.scale, a.tables, a.mp, a.ps, a.npages);
}

// The SIMT body takes up to kMaxRows query rows a CTA; more run as groups
// of kMaxRows.
template <typename T, typename C, int RG>
cudaError_t launch_rows(DaArgs a) {
  const int rows = a.nq * (a.nh / a.nkv);
  if (rows <= 1) return launch_split<T, C, RG, 1>(a);
  if (rows <= 2) return launch_split<T, C, RG, 2>(a);
  if (rows <= 4) return launch_split<T, C, RG, 4>(a);
  a.groups = (rows + kMaxRows - 1) / kMaxRows;
  return launch_split<T, C, RG, kMaxRows>(a);
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

template <int HD, int ROWS>
cudaError_t launch_mma_hd(const DaArgs& a) {
  static SmemOptIn opt_in;
  constexpr size_t smem = MmaSmem<HD, ROWS>::bytes;
  return launch_or_report(a, ROWS, opt_in, dattn_mma<HD, ROWS>, smem, smem,
                          static_cast<const __nv_bfloat16*>(a.q),
                          static_cast<const __nv_bfloat16*>(a.k),
                          static_cast<const __nv_bfloat16*>(a.v), a.pos0, a.part_o, a.part_ml,
                          a.nh, a.nkv, a.S, a.chunk, a.nq, a.scale, a.tables, a.mp, a.ps,
                          a.npages);
}

// The walk body, then its combine (or, with a.occ, the walk kernel's
// report); the instantiation that writes the new rows when a.knew is set.
// Its shared memory grows with B (the walk's table): above 48 KB (past
// 3,327 slots at hd 128 in the 8-row form, 191 in the 64-row one) it is
// opted into the card's most, once an instantiation and device.
template <int HD, int ROWS, bool WRITE>
cudaError_t launch_walk(const DaArgs& a) {
  static SmemOptIn opt_in;
  const size_t smem = walk_smem<HD, ROWS>(a.B);
  if (smem > 48 * 1024) {
    cudaError_t e = opt_in.set(dattn_walk<HD, ROWS, WRITE>, 0);
    if (e != cudaSuccess) return e;
  }
  if (a.occ) return report(a, dattn_walk<HD, ROWS, WRITE>, smem);
  if (a.ctas < 1) return cudaErrorInvalidValue;
  dattn_walk<HD, ROWS, WRITE><<<dim3(a.ctas, a.nkv * a.groups), kDaThreads, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<int8_t*>(const_cast<void*>(a.k)),
      static_cast<int8_t*>(const_cast<void*>(a.v)), const_cast<float*>(a.ks),
      const_cast<float*>(a.vs), a.pos0, a.part_o, a.part_ml, a.B, a.nh, a.nkv, a.S, a.chunk,
      a.tiles, a.nsplit, a.nq, a.scale, a.tables, a.mp, a.ps, a.npages,
      static_cast<const __nv_bfloat16*>(a.knew), static_cast<const __nv_bfloat16*>(a.vnew),
      a.clamp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nrows = a.B * a.nq * a.nh;
  dattn_combine_rows<__nv_bfloat16><<<(nrows + kDaWarps - 1) / kDaWarps, kDaThreads, 0, a.st>>>(
      a.part_o, a.part_ml, a.pos0, static_cast<__nv_bfloat16*>(a.out), nrows, a.nh, a.S, a.hd,
      a.chunk * a.tiles, a.nsplit, a.nq);
  e = cudaGetLastError();
  if (e == cudaSuccess && a.ran) *a.ran = ROWS;
  return e;
}

template <int HD, int ROWS>
cudaError_t launch_walk_hd(const DaArgs& a) {
  return a.knew ? launch_walk<HD, ROWS, true>(a) : launch_walk<HD, ROWS, false>(a);
}

// One tensor-core body at head dim HD in the form (form_rows) of the
// launch's query rows a kv head, in row groups of 64 past 64 rows.
template <int HD, bool Q8>
cudaError_t launch_form(DaArgs a) {
  const int rows = a.nq * (a.nh / a.nkv);
  const int form = form_rows(rows);
  a.groups = (rows + form - 1) / form;
  switch (form) {
    case kMaxRows: return Q8 ? launch_walk_hd<HD, kMaxRows>(a) : launch_mma_hd<HD, kMaxRows>(a);
    case 16: return Q8 ? launch_walk_hd<HD, 16>(a) : launch_mma_hd<HD, 16>(a);
    case 32: return Q8 ? launch_walk_hd<HD, 32>(a) : launch_mma_hd<HD, 32>(a);
    default: return Q8 ? launch_walk_hd<HD, kGroupRows>(a) : launch_mma_hd<HD, kGroupRows>(a);
  }
}

// The tensor-core bodies: bf16 q only, hd 48 / 64 / 128, dattn_mma over a
// bf16 cache and dattn_walk over an int8 one, any number of query rows;
// anything else is refused (never handed to the SIMT body).
template <typename T, typename C>
cudaError_t launch_mma(const DaArgs& a) {
  constexpr bool q8 = std::is_same<C, int8_t>::value;
  if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
    return cudaErrorInvalidValue;
  } else {
    if ((a.body == kBodyWalk) != q8) return cudaErrorInvalidValue;
    switch (a.hd) {
      case 48: return launch_form<48, q8>(a);
      case 64: return launch_form<64, q8>(a);
      case 128: return launch_form<128, q8>(a);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T, typename C>
cudaError_t launch_all(DaArgs a) {
  if (a.chunk <= 0 || a.chunk > kMaxChunk || a.tiles < 1) return cudaErrorInvalidValue;
  if (a.body != kBodyWalk && a.tiles != 1) return cudaErrorInvalidValue;
  // new rows are written by the walk alone, and come as a pair
  if ((a.knew || a.vnew) && (a.body != kBodyWalk || !a.knew || !a.vnew))
    return cudaErrorInvalidValue;
  // K6's rule only for the dense decode step's one row a slot (two rows
  // clamped onto row S - 1 would race)
  if (a.clamp && (!a.knew || a.tables || a.nq != 1)) return cudaErrorInvalidValue;
  a.nsplit = ((a.S + a.chunk - 1) / a.chunk + a.tiles - 1) / a.tiles;
  a.scale = 1.f / sqrtf(static_cast<float>(a.hd));
  cudaError_t e;
  if (a.body == kBodyMma || a.body == kBodyWalk) e = launch_mma<T, C>(a);
  else if (a.body == kBodySimt) e = launch_simt<T, C>(a);
  else return cudaErrorInvalidValue;
  if (e != cudaSuccess || a.occ || a.body == kBodyWalk) return e;   // the walk combines itself
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
// 64 / 128, q and caches 16-byte aligned). Every launch entry sets *form
// to the query rows a CTA of the form it launched (a tensor-core body's 8 /
// 16 / 32 / 64, the SIMT body's 1 / 2 / 4 / 8).
extern "C" int rama_decode_attention(const void* q, const void* k, const void* v,
                                     const void* pos0, void* out, void* part_o,
                                     void* part_ml, int B, int nq, int nh, int nkv, int S,
                                     int hd, int chunk, int dtype, int body, void* stream,
                                     int* form) {
  rama::DaArgs a{q, k, v, nullptr, nullptr, static_cast<const int*>(pos0), out,
                 static_cast<float*>(part_o), static_cast<float*>(part_ml),
                 B, nq, nh, nkv, S, hd, chunk, 0, 0.f, static_cast<cudaStream_t>(stream),
                 nullptr};
  a.body = body;
  a.ran = form;
  if (dtype == rama::kBF16)
    return static_cast<int>(rama::launch_all<__nv_bfloat16, __nv_bfloat16>(a));
  if (dtype == rama::kF32) return static_cast<int>(rama::launch_all<float, float>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7 (nq = 1) and K10 over an int8 cache: k8/v8 point at layer l of
// (L, B, nkv, S, hd) int8, ks/vs at layer l of its (L, B, nkv, S) f32 row
// scales; hd a multiple of 16. On the walk body (2) a split is `tiles`
// tiles of `chunk` rows, walked by `ctas` CTAs a kv head, and the scratch
// has nsplit = ceil(ceil(S / chunk) / tiles); the SIMT body takes tiles 1.
// knew / vnew (B, nq, nkv, hd) bf16, the walk body only (null: none): the
// chunk's new rows, quantized and written at [b, :, pos0[b] + t] (rows
// outside [0, S) dropped) by the launch, as K11 before it would; with
// clamp (nq 1 only), the decode step's rows at [b, :, clamp(pos0[b], 0,
// S - 1)], as K6 before it would.
extern "C" int rama_decode_attention_q8(const void* q, const void* k8, const void* v8,
                                        const void* ks, const void* vs, const void* knew,
                                        const void* vnew, const void* pos0,
                                        void* out, void* part_o, void* part_ml, int B, int nq,
                                        int nh, int nkv, int S, int hd, int chunk, int tiles,
                                        int ctas, int clamp, int dtype, int body, void* stream,
                                        int* form) {
  rama::DaArgs a{q, k8, v8, static_cast<const float*>(ks), static_cast<const float*>(vs),
                 static_cast<const int*>(pos0), out, static_cast<float*>(part_o),
                 static_cast<float*>(part_ml), B, nq, nh, nkv, S, hd, chunk, 0, 0.f,
                 static_cast<cudaStream_t>(stream), nullptr};
  a.body = body;
  a.ran = form;
  a.tiles = tiles;
  a.ctas = ctas;
  a.knew = knew;
  a.vnew = vnew;
  a.clamp = clamp;
  if (dtype == rama::kBF16) return static_cast<int>(rama::launch_all<__nv_bfloat16, int8_t>(a));
  if (dtype == rama::kF32) return static_cast<int>(rama::launch_all<float, int8_t>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12 (nq = 1: the paged decode step; nq > 1: the paged verification
// chunk) over a page pool of q's dtype: k/v point at layer l of the
// (L, npages, nkv, ps, hd) pool, tables (B, mp) int32 page ids (entries
// clamped to [0, npages - 1]); chunk divides ps; the scratch as above with
// nsplit = ceil(mp * ps / chunk).
extern "C" int rama_paged_attention(const void* q, const void* k, const void* v,
                                    const void* pos0, const void* tables, void* out,
                                    void* part_o, void* part_ml, int B, int nq, int nh, int nkv,
                                    int mp, int ps, int npages, int hd, int chunk, int dtype,
                                    int body, void* stream, int* form) {
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
  a.ran = form;
  if (dtype == rama::kBF16)
    return static_cast<int>(rama::launch_all<__nv_bfloat16, __nv_bfloat16>(a));
  if (dtype == rama::kF32) return static_cast<int>(rama::launch_all<float, float>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12 over an int8 pool: k8/v8 point at layer l of (L, npages, nkv, ps, hd)
// int8, ks/vs at layer l of its (L, npages, nkv, ps) f32 row scales; tiles
// and ctas as rama_decode_attention_q8's, with S = mp * ps; knew / vnew as
// there, the rows written through the tables as K13 (a) would (position
// max(p, 0), a row past the table clipped into page mp - 1; none dropped).
extern "C" int rama_paged_attention_q8(const void* q, const void* k8, const void* v8,
                                       const void* ks, const void* vs, const void* knew,
                                       const void* vnew, const void* pos0,
                                       const void* tables, void* out, void* part_o,
                                       void* part_ml, int B, int nq, int nh, int nkv, int mp,
                                       int ps, int npages, int hd, int chunk, int tiles,
                                       int ctas, int dtype, int body, void* stream,
                                       int* form) {
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
  a.ran = form;
  a.tiles = tiles;
  a.ctas = ctas;
  a.knew = knew;
  a.vnew = vnew;
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
