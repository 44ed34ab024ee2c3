// Kernel 14: the fused attention block of the T = 1 decode step on a dense
// cache -- RoPE of q and of the new k row, the in-place write of the k / v
// row at pos into layer l of the stacked cache, and attention over the
// cache rows before pos plus the new row (light form); the full form then
// multiplies the attention output by the quantized wo[l], which the Python
// wrapper launches as K1 (quant_matmul.cu) on this file's att.
//
// Replaces rama_tpu/ops/pallas/attn_block.py: attn_rope_write_layered
// (_kernel_aw, the light fusion) and attn_block_layered (_kernel, phase B
// then phase C over wo). For each (slot b, kv head j) with p = pos[b]:
//   q_r  = rope(q[b, j*rep + r]), k_n = rope(k_new[b, j]) in fp32
//          (interleaved pairs: out[2i] = x[2i] c_i - x[2i+1] s_i,
//          out[2i+1] = x[2i+1] c_i + x[2i] s_i; each product and the sum
//          rounded on their own, no FMA contraction);
//   att  = softmax over {cache rows s < p} + {the new row} of q_r . k / sqrt(hd),
//          times v: the new row's score and value from registers (k_n in
//          fp32, not rounded to the cache dtype; v_new as given);
//   cache[l, b, j, p] = (k_n in the cache dtype, v_new).
// Light: att in q's dtype. Full: att held in fp32, then out = att @
// dequant(wo[l]) (int8, or int4 in the block-split layout, group scales) in
// q's dtype. p is clamped to [0, S-1] (the port's rule for a finished
// slot's T = 1 overshoot); the Pallas kernel is not defined there.
//
// Rounding. fp32 computes the cache rows' scores and probabilities in fp32
// (the Pallas kernels' numerics). bf16 runs them on the tensor cores, which
// take bf16 operands: roped q (fp32) is rounded to bf16 as the A operand
// of Q K^T and the probabilities as the A operand of P V, as K4 rounds
// them; the new row's score (fp32 roped q . fp32 k_n), the softmax
// statistics, the combine and att stay fp32, and the full form rounds att
// to bf16 once, as the B operand of its wo product (the unfused mode 1 + K1
// computes the same; K1's swap-AB body rounds the dequantized weights to
// bf16 too). The plain versions keep fp32 throughout and are the oracle,
// within the card's tolerances.
//
// Bound on the H100: bytes -- each (slot, kv head) reads its p rows of K and
// V once (7B, bf16, 8 slots at the kernel check's positions: 47.3 MB,
// 14 us at 3.35 TB/s); the full form adds wo[l] (18.0 MB int8, 9.6 MB int4).
//
// Design. The TPU kernel walks S tiles of one (slot, head group) in grid
// order with the online softmax in VMEM scratch; phase C follows on the same
// sequential grid. Here, bf16 at hd 128 (every Llama-2 shape):
//  * split tensor-core attention: each (slot b, kv head j, 64-row split of
//    rows [0, p)) is one item on the m16n8k16 body of K4 / K10
//    (dattn_mma_body, dattn_mma.cuh), 128 threads; the item ropes its rep
//    query rows in fp32 while its K and V copies are in flight and writes
//    them to the Q tile in bf16, then writes the split's partial (m, l, o)
//    per query row to a workspace. The GQA group picks the body's row form
//    (form_rows: 8 rows up to a group of 8 -- the code every Llama-2 shape
//    and Yi-34B's group 7 ran before the other forms came -- 16, 32, or 64
//    rows; a group above 64 as row groups of 64 on grid y, nkv * groups);
//    the Q tile's rows past the group are zero queries (the body masks
//    their scores and never stores their partials: no NaN). The split
//    kernel's grid is (min(nsplit, kAbSplitCtas), nkv * groups, B): a CTA
//    takes the splits x, x + gridDim.x, ... below p, so a long cache at a
//    short position launches few CTAs that have nothing to do (a CTA a
//    split paid ~8 us a layer for them at pos 64 of 4096 rows on an H100).
//    One CTA walking a whole stripe (the earlier design, kept for fp32
//    below) serialised every stripe on one SM.
//  * the combine, a second launch of a CTA per (b, j): folds the splits
//    together with the new row -- ropes q and k_n again in fp32, scores the
//    new row, M = max(s_new, m_i), L and att = (e^(s_new - M) v_new + sum
//    e^(m_i - M) o_i) / L, eight split partials in flight a thread -- and
//    writes row p of the cache (after every split has read its rows; none
//    reads row p). Its CTAs are (slot, kv head, row group) as the split's,
//    their shared memory sized by the form (roped q [form][hd]) and the
//    group's rows x nsplit split weights; only the kv head's first row
//    group writes row p; past 8 rows a warp a query row (ab_comb_threads).
//    A slot at p = 0 has no split and only combines. Folding the combine
//    into the split kernel (the last split of each (b, j) to take an
//    integer ticket combines) was slower on an H100: 0.0261 against
//    0.0241 ms at S 1024 (PERF.md).
//  * the full form is the light form's two launches, att in bf16, then K1's
//    swap-AB tensor-core body (qmv_mma, quant_matmul.cu) on att: the same
//    function as rounding att to bf16 where wo's product loads it. One
//    cooperative launch of a persistent grid -- the attention items, a
//    grid-wide barrier, then the wo tiles of the same swap-AB body -- was
//    slower on an H100 (0.0515 against 0.0400 ms at S 1024, 0.20 against
//    0.13 at S 4096: the body's 128 registers and ring hold 4 CTAs an SM
//    to the light kernel's 5, and each CTA ran its ~18 items one after
//    another), so the wrapper (ops/kernels/attn_block.py) launches these.
// fp32 (the tests' fp32 models) keeps the SIMT attention: one CTA (256
// threads) per (slot, kv head) -- above a group of 8, per (slot, kv head,
// row group of 8), the first group writing row p -- ropes its query rows
// and the new k row into shared memory, writes row p, folds the new row into the running
// (m, l, acc) first, as the Pallas kernel does at t == 0, then walks rows
// 0 .. p-1 in tiles of `chunk` rows copied with cp.async, fp32 dot products
// reduced by shuffles. Its full form is the same composition as bf16's:
// att in fp32, then K1's fp32 GEMV on att (the wrapper).
#include "attention.cuh"
#include "dattn_mma.cuh"

#include <math.h>

namespace rama {

constexpr int kAbThreads = 256;
constexpr int kAbWarps = kAbThreads / 32;
constexpr int kAbHeadDim = 128;                 // the only head_dim taken
constexpr int kAbRG = kAbHeadDim / 8;           // lanes a cache row (8 elements each)
constexpr int kAbSplitCtas = 16;                // bf16 split CTAs a (slot, kv head), at most

// One launch's operands. q rows of slot b start at q + b * q_stride, the
// new k / v rows at kn / vn + b * kv_stride (the slices of one wqkv output
// row); kc / vc point at layer l of the (L, B, nkv, S, hd) cache.
struct AbArgs {
  const void *q, *kn, *vn;
  const float *cosr, *sinr;   // (B, hd / 2) RoPE rows at pos
  void *kc, *vc;
  const int* pos;
  void* att;                  // (B, nh * hd) in q's dtype
  float *part_o, *part_ml;    // bf16: the splits' partials (B, nh, nsplit, hd) / (.., 2)
  int B, nh, nkv, S, hd, chunk, q_stride, kv_stride, nsplit;
  float scale;
};

__device__ __forceinline__ int ab_pos(const AbArgs& a, int b) {
  return min(max(a.pos[b], 0), a.S - 1);
}

// RoPE of one interleaved pair in fp32, each product and the sum rounded
// on their own (no FMA contraction), as the plain version computes.
__device__ __forceinline__ float2 rope_pair(float x0, float x1, float c, float s) {
  return make_float2(__fadd_rn(__fmul_rn(x0, c), __fmul_rn(x1, -s)),
                     __fadd_rn(__fmul_rn(x1, c), __fmul_rn(x0, s)));
}

// ---------------------------------------------------------------------------
// fp32: the SIMT attention (one CTA walks a stripe)

// Dynamic shared memory of phase B, in bytes: the K and V tiles (chunk rows
// of hd T), then f32 qs [ROWS][hd], kn [hd], vn [hd], sc [ROWS][chunk],
// m / l / alpha [ROWS] and red [warps][ROWS][hd].
template <typename T, int ROWS>
__host__ __device__ __forceinline__ size_t ab_smem(int chunk, int hd) {
  return 2 * (size_t)chunk * hd * sizeof(T) +
         sizeof(float) * ((size_t)ROWS * hd + 2 * (size_t)hd + (size_t)ROWS * chunk +
                          3 * (size_t)ROWS + (size_t)kAbWarps * ROWS * hd);
}

// Phase B for (slot b, kv head j) and its query rows r0 .. r0 + rows - 1
// (GROUPS: row group x / nkv of ROWS rows, grid x = nkv * groups; else r0
// = 0, every row of the group): rope, row write (the kv head's first row
// group only, so one CTA writes row p), attention over rows < p and the new
// row; writes the rows' outputs to att.
template <typename T, int ROWS, bool GROUPS>
__device__ __forceinline__ void ab_attend(const AbArgs& a, int b, int x, unsigned char* smraw) {
  constexpr int EPL = 8, RG = kAbRG, ngrp = kAbThreads / RG;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hd = kAbHeadDim, chunk = a.chunk, half = hd / 2;
  const int j = GROUPS ? x % a.nkv : x, r0 = GROUPS ? x / a.nkv * ROWS : 0;
  const int grp_rep = a.nh / a.nkv;                  // the GQA group
  const int rep = GROUPS ? min(grp_rep - r0, ROWS) : grp_rep;   // this CTA's query rows
  const int p = ab_pos(a, b);
  T* kt = reinterpret_cast<T*>(smraw);               // [chunk][hd]
  T* vt = kt + (size_t)chunk * hd;                   // [chunk][hd]
  float* qs = reinterpret_cast<float*>(vt + (size_t)chunk * hd);  // [ROWS][hd]
  float* kn = qs + ROWS * hd;                        // [hd]
  float* vn = kn + hd;                               // [hd]
  float* sc = vn + hd;                               // [ROWS][chunk]
  float* mrow = sc + ROWS * chunk;                   // [ROWS]
  float* lrow = mrow + ROWS;                         // [ROWS]
  float* arow = lrow + ROWS;                         // [ROWS]
  float* red = arow + ROWS;                          // [warps][ROWS][hd]

  const T* qg = static_cast<const T*>(a.q) + (size_t)b * a.q_stride +
                ((size_t)j * grp_rep + r0) * hd;
  const T* kg = static_cast<const T*>(a.kn) + (size_t)b * a.kv_stride + (size_t)j * hd;
  const T* vg = static_cast<const T*>(a.vn) + (size_t)b * a.kv_stride + (size_t)j * hd;
  const float* cr = a.cosr + (size_t)b * half;
  const float* sr = a.sinr + (size_t)b * half;
  for (int i = tid; i < (rep + 1) * half; i += kAbThreads) {
    const int r = i / half, k = i - r * half;
    const T* src = r < rep ? qg + (size_t)r * hd : kg;
    const float2 o = rope_pair(to_f(src[2 * k]), to_f(src[2 * k + 1]), cr[k], sr[k]);
    float* dst = r < rep ? qs + r * hd : kn;
    dst[2 * k] = o.x;
    dst[2 * k + 1] = o.y;
  }
  for (int d = tid; d < hd; d += kAbThreads) vn[d] = to_f(vg[d]);
  __syncthreads();

  // row p of this stripe: the roped k row in the cache dtype, the v row as
  // given (rows < p are all any CTA of the stripe reads, so the write races
  // nothing); the first row group writes it
  const size_t stripe = ((size_t)b * a.nkv + j) * a.S;
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  if (r0 == 0) {
    for (int d = tid; d < hd; d += kAbThreads) {
      kc[(stripe + p) * hd + d] = from_f<T>(kn[d]);
      vc[(stripe + p) * hd + d] = vg[d];
    }
  }
  // the new row first: m = its score, l = 1, acc = its v row
  for (int r = warp; r < rep; r += kAbWarps) {
    float dsum = 0.f;
    for (int d = lane; d < hd; d += 32) dsum = fmaf(qs[r * hd + d], kn[d], dsum);
    dsum = warp_sum(dsum);
    if (lane == 0) {
      mrow[r] = dsum * a.scale;
      lrow[r] = 1.f;
    }
  }
  const int lane_g = tid % RG, grp = tid / RG, d0 = lane_g * EPL;
  float acc[ROWS][EPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = grp == 0 ? vn[d0 + e] : 0.f;

  for (int s0 = 0; s0 < p; s0 += chunk) {
    const int n = min(chunk, p - s0);
    {
      constexpr int kPer = 16 / (int)sizeof(T);
      const int vrow = hd / kPer;                    // 16-byte pieces a row
      const T* kg2 = kc + (stripe + s0) * hd;
      const T* vg2 = vc + (stripe + s0) * hd;
      for (int i = tid; i < n * vrow; i += kAbThreads) {
        cp_async16(kt + (size_t)i * kPer, kg2 + (size_t)i * kPer);
        cp_async16(vt + (size_t)i * kPer, vg2 + (size_t)i * kPer);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // scores of the tile (every lane runs the same trip count: shuffles)
    for (int base = 0; base < n; base += ngrp) {
      const int i = base + grp;
      const bool ok = i < n;
      float kv[EPL];
      if (ok) {
        tile_lane(kt + (size_t)i * hd + d0, kv);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[e] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= rep) break;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qs[r * hd + d0 + e], kv[e], d);
#pragma unroll
        for (int o = RG / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (lane_g == 0 && ok) sc[r * chunk + i] = d * a.scale;
      }
    }
    __syncthreads();

    // online softmax step per query row (one warp a row)
    for (int r = warp; r < rep; r += kAbWarps) {
      float tm = -INFINITY;
      for (int i = lane; i < n; i += 32) tm = fmaxf(tm, sc[r * chunk + i]);
      tm = warp_max(tm);
      const float m_old = mrow[r], m_new = fmaxf(m_old, tm);
      float ls = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float e = expf(sc[r * chunk + i] - m_new);
        sc[r * chunk + i] = e;
        ls += e;
      }
      ls = warp_sum(ls);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        mrow[r] = m_new;
        lrow[r] = alpha * lrow[r] + ls;
        arow[r] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha acc + e . v (fp32 probabilities, fp32 v)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rep) break;
      const float al = arow[r];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= al;
    }
    for (int i = grp; i < n; i += ngrp) {
      float v[EPL];
      tile_lane(vt + (size_t)i * hd + d0, v);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= rep) break;
        const float pr = sc[r * chunk + i];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pr, v[e], acc[r][e]);
      }
    }
    __syncthreads();  // the next tile overwrites kt / vt / sc
  }

  // sum the row groups: shuffles inside a warp, then the warps
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= rep) break;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
#pragma unroll
      for (int o = RG; o < 32; o <<= 1) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  }
  if (lane < RG) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rep) break;
#pragma unroll
      for (int e = 0; e < EPL; ++e) red[((size_t)warp * rep + r) * hd + d0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * hd; i += kAbThreads) {
    const int r = i / hd;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kAbWarps; ++w) v += red[(size_t)w * rep * hd + i];
    const size_t oi = (size_t)b * a.nh * hd + ((size_t)j * grp_rep + r0) * hd + i;
    static_cast<T*>(a.att)[oi] = from_f<T>(v / lrow[r]);
  }
}

// Light form: grid (nkv, B), one (slot, kv head) a CTA; GROUPS: grid (nkv
// * groups, B), one (slot, kv head, row group of ROWS) a CTA.
template <typename T, int ROWS, bool GROUPS = false>
__global__ void __launch_bounds__(kAbThreads) attn_rope_write_kernel(const AbArgs a) {
  extern __shared__ __align__(16) unsigned char smraw[];
  ab_attend<T, ROWS, GROUPS>(a, blockIdx.y, blockIdx.x, smraw);
}

// ---------------------------------------------------------------------------
// bf16: split tensor-core attention, then the combine

// The combine's shared bytes in the `form`-row form for a CTA of `rows`
// query rows: roped q [form][hd], k_n [hd], M, L, e^(s_new - M) [form],
// then the weights e^(m_i - M) [rows][nsplit] (the 8-row form: 4,704
// bytes before the weights, 48 KB at rows x nsplit = 11,112). nsplit 0:
// the weights kept in the workspace instead (ab_combine_kernel's WG).
inline size_t ab_combine_smem(int form, int rows, int nsplit) {
  return sizeof(float) * ((size_t)form * kAbHeadDim + kAbHeadDim + 3 * (size_t)form +
                          (size_t)rows * nsplit);
}

// The splits of rows [0, p) of a slot at p.
__device__ __forceinline__ int ab_splits(int p) { return (p + kMaxChunk - 1) / kMaxChunk; }

// Split kernel of the ROWS-row form (dattn_mma.cuh RowForm: 8, 16, 32 or 64
// query rows a CTA), grid (min(nsplit, kAbSplitCtas), nkv * groups, B), 128
// threads: CTA x of (slot b, kv head j, row group) takes splits x, x +
// gridDim.x, ... of rows [0, p), each on the tensor-core body, its query
// rows roped in fp32 and rounded to bf16 into the Q tile while the K / V
// copies are in flight (rows past the group's: zero queries, masked and
// never stored), the partials written for the combine. Row groups (groups > 1)
// only in the 64-row form: the CTA's rows are r0 = (y / nkv) * 64 .. r0 +
// 63 of the kv head's rep, j = y % nkv.
template <int ROWS>
__global__ void __launch_bounds__(kDaThreads) ab_split_kernel(const AbArgs a) {
  using T = __nv_bfloat16;
  constexpr int hd = kAbHeadDim, half = hd / 2, LD = MmaSmem<hd, ROWS>::LD;
  constexpr bool kGroups = ROWS == kGroupRows;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int b = blockIdx.z, j = kGroups ? blockIdx.y % a.nkv : blockIdx.y, p = ab_pos(a, b);
  const int rep = a.nh / a.nkv;
  const int r0 = kGroups ? blockIdx.y / a.nkv * ROWS : 0;       // the CTA's first query row
  const int rows = kGroups ? min(rep - r0, ROWS) : rep;
  const T* qg = static_cast<const T*>(a.q) + (size_t)b * a.q_stride + ((size_t)j * rep + r0) * hd;
  const float* cr = a.cosr + (size_t)b * half;
  const float* sr = a.sinr + (size_t)b * half;
  auto load_q = [&](T* Qs) {
    for (int i = threadIdx.x; i < ROWS * half; i += kDaThreads) {
      const int r = i / half, k = i - r * half;
      float2 o = make_float2(0.f, 0.f);
      if (r < rows)
        o = rope_pair(to_f(qg[(size_t)r * hd + 2 * k]), to_f(qg[(size_t)r * hd + 2 * k + 1]),
                      cr[k], sr[k]);
      *reinterpret_cast<uint32_t*>(Qs + r * LD + 2 * k) = pack_bf16(o.x, o.y);
    }
  };
  for (int split = blockIdx.x; split < ab_splits(p); split += gridDim.x) {
    if (split != (int)blockIdx.x) __syncthreads();   // the last split's reads of smem
    const int s0 = split * kMaxChunk;
    dattn_mma_body<hd, true, ROWS>(static_cast<const T*>(a.kc), static_cast<const T*>(a.vc),
                                   a.part_o, a.part_ml, b, j, split, a.nsplit, a.nh, a.nkv, 1,
                                   s0, min(kMaxChunk, p - s0),
                                   ((size_t)b * a.nkv + j) * a.S + s0, a.scale, load_q,
                                   [&](int) { return p - 1; }, smraw, r0);
  }
}

// Threads of the combine CTA in the ROWS-row form: the 8-row form's 128
// (its code before the other forms came), a warp a query row in the
// larger forms (512 / 1024 / 1024 at 16 / 32 / 64 rows): at 128 threads a
// 16-row CTA ran its 1,536 outputs as 12 dependent rounds of split loads
// (0.0147 ms a launch at Mistral-Large's shape on an H100, 1.7x the split
// kernel's 0.0085).
__host__ __device__ constexpr int ab_comb_threads(int rows) {
  return rows == kMaxRows ? kDaThreads : rows * 32 < 1024 ? rows * 32 : 1024;
}

// Combine kernel of the ROWS-row form, grid (nkv * groups, B),
// ab_comb_threads(ROWS) threads, ab_combine_smem(ROWS, ..) bytes: for
// (slot b, kv head j, row group) over its splits of rows < p and the new
// row, rope the group's query rows and k_n in fp32, write row p of the
// stripe (k_n in bf16, v_new as given; the first row group of the kv head
// only, after every split has read its rows: exactly one writer, and no
// CTA reads row p), score the new row in fp32 (q_r . k_n / sqrt(hd)), then
// per query row M = max(s_new, m_i), L = e^(s_new - M) + sum e^(m_i - M)
// l_i and att = (e^(s_new - M) v_new + sum e^(m_i - M) o_i) / L, in split
// order, one output element a thread, att in bf16. A row's arithmetic is
// the same in every form. WG: a cache too long for the split weights
// [rep][nsplit] in shared memory keeps each weight in the workspace, in
// place of the split's m_i once the row's M is known (the same values
// read in the same order: the same bits), so no S is refused.
template <int ROWS, bool WG>
__global__ void __launch_bounds__(ab_comb_threads(ROWS)) ab_combine_kernel(const AbArgs a) {
  using T = __nv_bfloat16;
  constexpr int hd = kAbHeadDim, half = hd / 2;
  constexpr int kThreads = ab_comb_threads(ROWS), kWarps = kThreads / 32;
  constexpr bool kGroups = ROWS == kGroupRows;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int j = kGroups ? blockIdx.x % a.nkv : blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = a.nh / a.nkv, p = ab_pos(a, b), ns = a.nsplit, nv = ab_splits(p);
  const int r0 = kGroups ? blockIdx.x / a.nkv * ROWS : 0;       // the CTA's first query row
  const int rep = kGroups ? min(grp - r0, ROWS) : grp;          // the CTA's query rows
  float* qf = reinterpret_cast<float*>(smraw);   // [rep][hd]
  float* kf = qf + ROWS * hd;                    // [hd]
  float* mrow = kf + hd;                         // [ROWS]
  float* lrow = mrow + ROWS;                     // [ROWS]
  float* wnew = lrow + ROWS;                     // [ROWS]
  float* wsp = wnew + ROWS;                      // [rep][ns]: e^(m_i - M)
  const T* qg = static_cast<const T*>(a.q) + (size_t)b * a.q_stride + ((size_t)j * grp + r0) * hd;
  const T* kg = static_cast<const T*>(a.kn) + (size_t)b * a.kv_stride + (size_t)j * hd;
  const T* vg = static_cast<const T*>(a.vn) + (size_t)b * a.kv_stride + (size_t)j * hd;
  const float* cr = a.cosr + (size_t)b * half;
  const float* sr = a.sinr + (size_t)b * half;
  for (int i = tid; i < (rep + 1) * half; i += kThreads) {
    const int r = i / half, k = i - r * half;
    const T* src = r < rep ? qg + (size_t)r * hd : kg;
    const float2 o = rope_pair(to_f(src[2 * k]), to_f(src[2 * k + 1]), cr[k], sr[k]);
    float* dst = r < rep ? qf + r * hd : kf;
    dst[2 * k] = o.x;
    dst[2 * k + 1] = o.y;
  }
  __syncthreads();
  if (r0 == 0) {
    const size_t row = (((size_t)b * a.nkv + j) * a.S + p) * hd;
    T* kc = static_cast<T*>(a.kc);
    T* vc = static_cast<T*>(a.vc);
    for (int d = tid; d < hd; d += kThreads) {
      kc[row + d] = from_f<T>(kf[d]);
      vc[row + d] = vg[d];
    }
  }
  const size_t hr0 = (size_t)b * a.nh + (size_t)j * grp + r0;   // the CTA's first query row
  for (int r = warp; r < rep; r += kWarps) {
    float dsum = 0.f;
    for (int d = lane; d < hd; d += 32) dsum = fmaf(qf[r * hd + d], kf[d], dsum);
    const float sn = warp_sum(dsum) * a.scale;
    float* mlw = a.part_ml + (hr0 + r) * ns * 2;
    const float* ml = mlw;
    float m = sn;
    for (int i = lane; i < nv; i += 32) m = fmaxf(m, ml[2 * i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < nv; i += 32) {
      const float w = expf(ml[2 * i] - m);
      if constexpr (WG) mlw[2 * i] = w;   // this lane read m_i last just now
      else wsp[r * ns + i] = w;
      l += w * ml[2 * i + 1];
    }
    l = warp_sum(l);
    if (lane == 0) {
      const float w = expf(sn - m);
      mrow[r] = m;
      lrow[r] = l + w;
      wnew[r] = w;
    }
  }
  __syncthreads();
  constexpr int U = 8;   // split partials in flight a thread
  constexpr int WS = WG ? 2 : 1;   // the weights' stride
  T* att = static_cast<T*>(a.att);
  for (int i = tid; i < rep * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const float* po = a.part_o + (hr0 + r) * ns * hd + d;
    const float* w = WG ? a.part_ml + (hr0 + r) * ns * 2 : wsp + r * ns;
    float o = 0.f;
    int s = 0;
    for (; s + U <= nv; s += U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = po[(size_t)(s + u) * hd];
#pragma unroll
      for (int u = 0; u < U; ++u) o += w[(s + u) * WS] * v[u];
    }
    for (; s < nv; ++s) o += w[s * WS] * po[(size_t)s * hd];
    o += wnew[r] * to_f(vg[d]);
    att[hr0 * hd + i] = from_f<T>(o / lrow[r]);
  }
}

// ---------------------------------------------------------------------------
// launchers

// occ non-null: launch nothing; occ[0] resident CTAs per SM, occ[1]
// registers per thread, occ[2] dynamic shared bytes, occ[3] local (spill)
// bytes per thread.
template <class K>
cudaError_t kernel_info(K kern, int threads, size_t smem, int* occ) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[0], kern, threads, smem);
  occ[1] = fa.numRegs;
  occ[2] = (int)smem;
  occ[3] = (int)fa.localSizeBytes;
  return e;
}

// Launch kern or, with occ, report it (kernel_info).
template <class K>
cudaError_t launch_plain(K kern, dim3 grid, int threads, size_t smem, const AbArgs& a,
                         cudaStream_t st, int* occ) {
  if (occ) return kernel_info(kern, threads, smem, occ);
  kern<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int ROWS, bool GROUPS = false>
cudaError_t launch_light(const AbArgs& a, cudaStream_t st, int groups = 1) {
  static SmemOptIn opt_in;   // chunk is always kMaxChunk (ab_shape_ok): one size
  const size_t smem = ab_smem<T, ROWS>(a.chunk, kAbHeadDim);
  auto kern = attn_rope_write_kernel<T, ROWS, GROUPS>;
  const cudaError_t e = opt_in.set(kern, smem);
  if (e != cudaSuccess) return e;
  return launch_plain(kern, dim3(a.nkv * groups, a.B), kAbThreads, smem, a, st, nullptr);
}

// The most dynamic shared bytes a block of the current card may opt into,
// asked once a device.
inline cudaError_t ab_smem_most(size_t* most) {
  static std::atomic<int> known[64];
  int dev = 0, v = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64) v = known[dev].load(std::memory_order_relaxed);
  if (!v) {
    e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    if (dev < 64) known[dev].store(v, std::memory_order_relaxed);
  }
  *most = (size_t)v;
  return cudaSuccess;
}

// The bf16 light form in the ROWS-row form: the split kernel, then the
// combine kernel, over nkv * groups (kv head, row group) pairs (groups > 1
// only in the 64-row form). A kernel whose shared bytes pass 48 KB (the
// split kernel's 32- and 64-row forms; the combine's past 48 KB of split
// weights) is opted in once a device and instantiation, the combine to
// the card's most (its bytes grow with S); past the card's most the
// combine keeps its split weights in the workspace (WG) instead. occ:
// launch nothing, report the split kernel in occ[0..3] and the combine
// kernel in occ[4..7].
template <int ROWS>
cudaError_t launch_light_mma(const AbArgs& a, cudaStream_t st, int* occ) {
  static SmemOptIn split_opt, comb_opt;
  constexpr size_t split_smem = MmaSmem<kAbHeadDim, ROWS>::bytes;
  const int rep = a.nh / a.nkv, groups = (rep + ROWS - 1) / ROWS, rows = min(rep, ROWS);
  size_t comb_smem = ab_combine_smem(ROWS, rows, a.nsplit), most = 0;
  cudaError_t e = cudaSuccess;
  if (split_smem > 48 * 1024) e = split_opt.set(ab_split_kernel<ROWS>, split_smem);
  if (e == cudaSuccess && comb_smem > 48 * 1024) e = ab_smem_most(&most);
  const bool wg = comb_smem > 48 * 1024 && comb_smem > most;
  if (wg) comb_smem = ab_combine_smem(ROWS, rows, 0);
  else if (e == cudaSuccess && comb_smem > 48 * 1024)
    e = comb_opt.set(ab_combine_kernel<ROWS, false>, 0);
  if (e != cudaSuccess) return e;
  const dim3 grid(min(a.nsplit, kAbSplitCtas), a.nkv * groups, a.B);
  e = launch_plain(ab_split_kernel<ROWS>, grid, kDaThreads, split_smem, a, st, occ);
  if (e != cudaSuccess) return e;
  const dim3 cgrid(a.nkv * groups, a.B);
  int* cocc = occ ? occ + 4 : nullptr;
  return wg ? launch_plain(ab_combine_kernel<ROWS, true>, cgrid, ab_comb_threads(ROWS),
                           comb_smem, a, st, cocc)
            : launch_plain(ab_combine_kernel<ROWS, false>, cgrid, ab_comb_threads(ROWS),
                           comb_smem, a, st, cocc);
}

// The bf16 forms: `rows` query rows a CTA (form_rows of the GQA group, or
// a larger form the caller asks for), reported in *form.
inline cudaError_t dispatch_mma(const AbArgs& a, int rows, cudaStream_t st, int* occ,
                                int* form) {
  cudaError_t e;
  switch (rows) {
    case kMaxRows: e = launch_light_mma<kMaxRows>(a, st, occ); break;
    case 16: e = launch_light_mma<16>(a, st, occ); break;
    case 32: e = launch_light_mma<32>(a, st, occ); break;
    case kGroupRows: e = launch_light_mma<kGroupRows>(a, st, occ); break;
    default: return cudaErrorInvalidValue;
  }
  if (e == cudaSuccess && form) *form = rows;
  return e;
}

// The fp32 SIMT body: 1 or 8 query rows a CTA; a group above 8 in row
// groups of 8 on grid x. Reports the form (1 or 8) in *form.
template <typename T>
cudaError_t dispatch_light(const AbArgs& a, cudaStream_t st, int* form) {
  const int rep = a.nh / a.nkv;
  cudaError_t e;
  if (rep == 1) e = launch_light<T, 1>(a, st);
  else if (rep <= 8) e = launch_light<T, 8>(a, st);
  else e = launch_light<T, 8, true>(a, st, (rep + 7) / 8);
  if (e == cudaSuccess && form) *form = rep == 1 ? 1 : 8;
  return e;
}

// The bf16 workspace's splits: ceil((S - 1) / 64) cover every row below the
// last position (at least one).
inline int ab_nsplit(int S) { return max(1, (S - 1 + kMaxChunk - 1) / kMaxChunk); }

// The bf16 form of a launch: form_rows of the GQA group, or `rows` when
// the caller forces a larger form (0: none); 0 if rows is no form or is
// smaller than the group's.
inline int ab_form(const AbArgs& a, int rows) {
  const int want = form_rows(a.nh / a.nkv);
  if (!rows) return want;
  const bool form = rows == kMaxRows || rows == 16 || rows == 32 || rows == kGroupRows;
  return form && rows >= want ? rows : 0;
}

// Any whole GQA group at hd 128 and chunk 64, any S; bf16: a form (ab_form).
inline bool ab_shape_ok(const AbArgs& a, int dtype, int rows) {
  const bool ok = a.hd == kAbHeadDim && a.nkv > 0 && a.nh % a.nkv == 0 && a.nh > 0 && a.S > 0 &&
                  a.chunk == kMaxChunk && a.B > 0;
  if (!ok || dtype != kBF16) return ok && !rows;
  return ab_form(a, rows) != 0;
}

inline AbArgs ab_args(const void* q, const void* kn, const void* vn, const void* cosr,
                      const void* sinr, void* kc, void* vc, const void* pos, void* att,
                      void* part_o, void* part_ml, int B, int nh, int nkv,
                      int S, int hd, int chunk, int q_stride, int kv_stride) {
  AbArgs a{};
  a.q = q; a.kn = kn; a.vn = vn;
  a.cosr = static_cast<const float*>(cosr);
  a.sinr = static_cast<const float*>(sinr);
  a.kc = kc; a.vc = vc;
  a.pos = static_cast<const int*>(pos);
  a.att = att;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B; a.nh = nh; a.nkv = nkv; a.S = S; a.hd = hd; a.chunk = chunk;
  a.q_stride = q_stride; a.kv_stride = kv_stride;
  a.nsplit = ab_nsplit(S);
  a.scale = 1.f / sqrtf(static_cast<float>(hd));
  return a;
}

}  // namespace rama

// K14, light: q (B, nh, hd) rows at q + b * q_stride, k_new / v_new rows at
// kn / vn + b * kv_stride (B, nkv, hd), all of q's dtype; cos / sin (B, hd/2)
// f32; kc / vc layer l of the (L, B, nkv, S, hd) cache of q's dtype (16-byte
// aligned); pos (B,) int32; att (B, nh * hd) of q's dtype. hd must be 128,
// nh a whole multiple of nkv (any GQA group), chunk 64. bf16: part_o (B, nh,
// nsplit, hd) and part_ml (B, nh, nsplit, 2) f32 scratch, nsplit = max(1,
// ceil((S - 1) / 64)), overwritten; rows: 0, or a larger form (8 / 16 / 32 /
// 64 query rows a CTA) than the group's to run instead; fp32 ignores the
// scratch and takes rows 0. After a launch *body is the body that ran (1
// split tensor-core attention, 0 the SIMT body) and *form its query rows a
// CTA (bf16 8 / 16 / 32 / 64, fp32 1 / 8). occ non-null (bf16): launch
// nothing, report the split kernel's {CTAs per SM, registers, shared
// bytes, local bytes} in occ[0..3] and the combine kernel's in occ[4..7].
extern "C" int rama_attn_rope_write(const void* q, const void* kn, const void* vn,
                                    const void* cosr, const void* sinr, void* kc, void* vc,
                                    const void* pos, void* att, void* part_o, void* part_ml,
                                    int B, int nh, int nkv, int S, int hd, int chunk,
                                    int q_stride, int kv_stride, int dtype, int rows,
                                    void* stream, int* body, int* form, int* occ) {
  const rama::AbArgs a = rama::ab_args(q, kn, vn, cosr, sinr, kc, vc, pos, att, part_o, part_ml,
                                       B, nh, nkv, S, hd, chunk, q_stride, kv_stride);
  if (!rama::ab_shape_ok(a, dtype, rows)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rama::kBF16) {
    if (body) *body = 1;
    return static_cast<int>(rama::dispatch_mma(a, rama::ab_form(a, rows), st, occ, form));
  }
  if (dtype == rama::kF32 && !occ) {
    if (body) *body = 0;
    return static_cast<int>(rama::dispatch_light<float>(a, st, form));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
