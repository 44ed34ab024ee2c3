// Kernel 5: causal flash attention for prefill over freshly written cache
// rows, masked per slot by the prompt length.
//
// Replaces rama_tpu/ops/pallas/prefill_attention.py: prefill_attention
// (_kernel). Query t of slot b (at position t) sees key s iff s <= t and
// s < plen[b]; query rows t >= plen still attend to all plen keys. Scores
// in fp32 times 1/sqrt(hd), online softmax over key tiles, the
// unnormalized probabilities rounded to the cache dtype before P.V (as the
// Pallas kernel's e.astype(v.dtype)), the normalizer summed from the
// unrounded fp32 values. A row with no visible key (plen == 0) outputs
// zeros, never NaN. Key tiles above a q tile's diagonal, or wholly at or
// past plen, are never read.
//
// Bound on the H100: 4 * hd flops per visible (query, key) pair (about
// T^2 / 2 pairs a head) against q, k, v and out moved once each. Below
// about 295 flop/B (short prompts: the serving buckets of 16 rows) the
// bytes bound it, above (512-row and longer prompts) the bf16 tensor-core
// operations.
//
// Both bodies take one CTA per (q tile, kv head, slot); the rep query
// heads of the kv head are stacked as the tile's 64 rows (row r is head
// j * rep + r / bq at position t0 + r % bq, bq = 64 / rep), so each K/V
// tile is read once for the whole GQA group.
//
// Any whole GQA group (pa_rows): a CTA holds hc = min(rep, 64) heads of the
// group and bq = 64 / hc positions of each (rounded down), so 64 - hc * bq
// rows of the tile are idle: their queries are zeros, their scores finite,
// their outputs never stored. Above 64 the group is cut into ns = ceil(rep /
// 64) slices of up to 64 heads, the grid's kv-head axis over (kv head,
// slice). Both bodies keep the group-divides-64 case (every Llama-2 /
// TinyLlama shape) as its own compile-time form (GQA false), the code they
// had before any group was taken (pattn_form 0: the group divides 64, 1:
// any other group).
//
// bf16 at hd 48, 64, 128 (pattn_mma_kernel), FlashAttention-2's layout on
// the tensor cores (mma.sync.m16n8k16 bf16 -> fp32):
//  - 4 warps, each owning 16 query rows; q tiles are issued longest
//    (highest positions, most key tiles) first. The Q tile is copied to
//    shared memory with cp.async and held in registers as A fragments
//    (ldmatrix.x4; hd / 16 k-steps).
//  - K and V tiles of 64 keys x hd, double-buffered with cp.async (the
//    next tile's copy overlaps this tile's math); rows padded by 8 bf16 so
//    ldmatrix's eight 16-byte row reads fall in distinct banks. Key rows
//    at or past the CTA's last visible key are zero-filled, never read.
//    At hd 128: 87,040 B of shared memory and about 210 registers a
//    thread, two CTAs an SM.
//  - A warp skips the math of a key tile that no stored row of it can see
//    (every key past its last position or plen; every row of it past T).
//  - S = Q K^T: K is the column-major B operand (ldmatrix, no transpose);
//    a warp's S tile is 16 x 64 fp32 in registers. The causal / plen mask
//    is applied only on tiles that straddle the warp's first position or
//    plen (a warp-uniform test).
//  - Softmax in registers: row max and sum across the four lanes of a row
//    (shfl_xor 1, 2); a row with nothing visible yet keeps m = -inf and
//    adds zeros. Two adjacent n8 accumulator tiles of e, rounded to bf16,
//    are the A fragment of P.V with no trip through shared memory.
//  - O += P V: V is the row-major B operand (ldmatrix.trans); O is 16 x hd
//    fp32 a warp in registers (hd / 2 a thread).
//  - Epilogue: O / l (l == 0 -> zeros), rounded to bf16, staged through
//    the Q tile's shared memory for 16-byte coalesced stores.
//
// fp32, and bf16 at any other hd, take the SIMT body (pattn_kernel): key
// tiles of 32 rows, two threads a query row, q, K, V, P and the output
// accumulator in fp32 shared memory, fp32 FMA on the CUDA cores.
#include "mma.cuh"

#include <math.h>

namespace rama {

constexpr int kPaRows = 64;     // query rows per CTA (rep x positions)
constexpr int kPaKeys = 32;     // keys per tile
constexpr int kPaThreads = 128; // two threads per row

// The rows of a CTA of `rows` (64) for a GQA group of rep: hc heads of the
// group (a slice of it above `rows`), ns slices, bq positions of each head.
struct PaRows {
  int hc, ns, bq;
};
__host__ __device__ inline PaRows pa_rows(int rep, int rows) {
  const int hc = rep < rows ? rep : rows;
  return {hc, (rep + hc - 1) / hc, rows / hc};
}

// The form a launch of nh heads over nkv runs: 0 where the GQA group
// divides 64, 1 for any other whole group; -1 for no whole group.
inline int pattn_form(int nh, int nkv) {
  if (nkv < 1 || nh < nkv || nh % nkv) return -1;
  return kPaRows % (nh / nkv) ? 1 : 0;
}

// GQA false: the group divides 64 (every row live, one slice); true: any
// whole group (pa_rows; idle rows past `live`, blockIdx.y over (kv head,
// slice)).
template <typename T, bool GQA>
__global__ void __launch_bounds__(kPaThreads)
pattn_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
             const int* __restrict__ plen_arr, T* __restrict__ out, int T_, int nh, int nkv,
             int S, int hd, float scale) {
  extern __shared__ float sm[];
  const int rep = nh / nkv;
  const PaRows g = pa_rows(rep, kPaRows);
  const int bq = GQA ? g.bq : kPaRows / rep;   // positions per tile
  const int ns = GQA ? g.ns : 1;
  const int tile = blockIdx.x, b = blockIdx.z;
  const int j = GQA ? blockIdx.y / ns : blockIdx.y;   // kv head; blockIdx.y % ns: its slice
  const int h0 = j * rep + (GQA ? (blockIdx.y - j * ns) * g.hc : 0);   // the CTA's first head
  const int live = GQA ? min(g.hc, j * rep + rep - h0) * bq : kPaRows;   // rows past it idle
  const int t0 = tile * bq;
  const int tid = threadIdx.x;
  const int row = tid / 2, half = tid % 2;
  const int t = t0 + row % bq;         // query position
  const int h = h0 + row / bq;         // query head
  const int plen = plen_arr[b];
  const int ld = hd + 1;               // padded row stride (bank conflicts)

  float* Qs = sm;                        // [64][ld]
  float* Os = Qs + kPaRows * ld;         // [64][ld]
  float* Ks = Os + kPaRows * ld;         // [32][ld]
  float* Vs = Ks + kPaKeys * ld;         // [32][ld]
  float* Ps = Vs + kPaKeys * ld;         // [64][33]

  for (int i = tid; i < kPaRows * hd; i += kPaThreads) {
    const int r = i / hd, d = i - r * hd;
    const int tq = t0 + r % bq, hq = h0 + r / bq;
    Qs[r * ld + d] = tq < T_ && (!GQA || r < live)
                         ? to_f(q[(((size_t)b * T_ + tq) * nh + hq) * hd + d]) : 0.f;
    Os[r * ld + d] = 0.f;
  }

  // last key tile: the diagonal of this q-tile, clipped to the prompt
  const int t_last = min(t0 + bq - 1, T_ - 1);
  const int kt_end = plen > 0 ? min(t_last, plen - 1) / kPaKeys : -1;
  const size_t stripe = ((size_t)b * nkv + j) * (size_t)S * hd;
  const int dh = (hd + 1) / 2;
  const int dbeg = half * dh, dend = min(hd, dbeg + dh);
  float m_run = -INFINITY, l_run = 0.f;

  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * kPaKeys;
    __syncthreads();  // previous tile's K/V/P reads are done (and Q/O init)
    for (int i = tid; i < kPaKeys * hd; i += kPaThreads) {
      const int r = i / hd, d = i - r * hd;
      const int s = k0 + r;
      const bool ok = s < S;
      Ks[r * ld + d] = ok ? to_f(kc[stripe + (size_t)s * hd + d]) : 0.f;
      Vs[r * ld + d] = ok ? to_f(vc[stripe + (size_t)s * hd + d]) : 0.f;
    }
    __syncthreads();

    float sc[16];
    float m_tile = -INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int kk = half * 16 + i;
      const int s = k0 + kk;
      float d = 0.f;
      for (int e = 0; e < hd; ++e) d = fmaf(Qs[row * ld + e], Ks[kk * ld + e], d);
      const bool vis = (s <= t) && (s < plen);
      sc[i] = vis ? d * scale : -INFINITY;
      m_tile = fmaxf(m_tile, sc[i]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    const float m_new = fmaxf(m_run, m_tile);
    float alpha, l_tile = 0.f;
    if (m_new == -INFINITY) {  // nothing visible yet in this row
      alpha = 1.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) Ps[row * 33 + half * 16 + i] = 0.f;
    } else {
      alpha = expf(m_run - m_new);  // m_run == -inf -> 0
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float e = expf(sc[i] - m_new);  // masked -> 0
        l_tile += e;
        Ps[row * 33 + half * 16 + i] = round_to<T>(e);
      }
    }
    l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 1);
    l_run = alpha * l_run + l_tile;
    m_run = m_new;
    __syncwarp();  // the pair's P row is complete

    for (int d = dbeg; d < dend; ++d) {
      float o = alpha * Os[row * ld + d];
#pragma unroll 8
      for (int kk = 0; kk < kPaKeys; ++kk) o = fmaf(Ps[row * 33 + kk], Vs[kk * ld + d], o);
      Os[row * ld + d] = o;
    }
  }
  __syncthreads();
  if (t < T_ && (!GQA || row < live)) {
    const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
    T* orow = out + (((size_t)b * T_ + t) * nh + h) * hd;
    for (int d = dbeg; d < dend; ++d) orow[d] = from_f<T>(Os[row * ld + d] * inv);
  }
}

template <typename T>
cudaError_t launch_pattn(const void* q, const void* k, const void* v, const int* plen,
                         void* out, int B, int T_, int nh, int nkv, int S, int hd, int form,
                         cudaStream_t st) {
  const PaRows g = pa_rows(nh / nkv, kPaRows);
  if ((long long)nkv * g.ns > 65535 || B > 65535) return cudaErrorInvalidValue;
  const int bq = g.bq;
  const int ld = hd + 1;
  const size_t smem = sizeof(float) *
      ((size_t)2 * kPaRows * ld + (size_t)2 * kPaKeys * ld + (size_t)kPaRows * 33);
  auto kern = form ? pattn_kernel<T, true> : pattn_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  kern<<<dim3((T_ + bq - 1) / bq, nkv * g.ns, B), kPaThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), plen,
      static_cast<T*>(out), T_, nh, nkv, S, hd, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tensor-core body

constexpr int kFaRows = 64;      // query rows per CTA: 4 warps x 16
constexpr int kFaKeys = 64;      // keys per K/V tile
constexpr int kFaThreads = 128;
constexpr int kFaPad = 8;        // bf16 per shared row: conflict-free ldmatrix

// Fragment coordinates: mma.cuh. GQA false: the group divides 64 (every
// row live, one slice); true: any whole group (pa_rows; idle rows past
// `live`, blockIdx.x over (kv head, slice)).
template <int HD, bool GQA>
__global__ void __launch_bounds__(kFaThreads, 2)
pattn_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                 const __nv_bfloat16* __restrict__ vc, const int* __restrict__ plen_arr,
                 __nv_bfloat16* __restrict__ out, int T_, int nh, int nkv, int S,
                 float scale_log2) {
  constexpr int LD = HD + kFaPad;   // shared row stride (elements)
  constexpr int KS = HD / 16;       // k-steps of Q K^T
  constexpr int NT = HD / 8;        // n8 tiles of O
  constexpr int CH = HD / 8;        // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);   // [64][LD]
  __nv_bfloat16* Ks = Qs + kFaRows * LD;                            // [2][64][LD]
  __nv_bfloat16* Vs = Ks + 2 * kFaKeys * LD;                        // [2][64][LD]

  const int b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;   // longest rows first
  const int rep = nh / nkv;
  const PaRows pr = pa_rows(rep, kFaRows);
  const int ns = GQA ? pr.ns : 1;
  const int j = GQA ? blockIdx.x / ns : blockIdx.x;
  const int h0 = j * rep + (GQA ? (blockIdx.x - j * ns) * pr.hc : 0);   // the CTA's first head
  const int bq = GQA ? pr.bq : kFaRows / rep;    // positions per tile
  const int live = GQA ? min(pr.hc, j * rep + rep - h0) * bq : kFaRows;   // rows past it idle
  const int t0 = tile * bq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int plen = plen_arr[b];
  // keys [0, kv_lim) may be visible to some row of this tile
  const int kv_lim = min(min(t0 + bq, T_), plen);
  const int n_kt = (kv_lim + kFaKeys - 1) / kFaKeys;
  const size_t stripe = ((size_t)b * nkv + j) * (size_t)S * HD;
  const __nv_bfloat16* kg = kc + stripe;
  const __nv_bfloat16* vg = vc + stripe;

  for (int i = tid; i < kFaRows * CH; i += kFaThreads) {   // rows past T, idle rows zero
    const int r = i / CH, ch = i % CH;
    const int t = t0 + r % bq, h = h0 + r / bq;
    const bool ok = t < T_ && (!GQA || r < live);
    cp_async16_zfill(Qs + r * LD + ch * 8,
                     ok ? q + (((size_t)b * T_ + t) * nh + h) * HD + ch * 8 : q, ok);
  }
  auto load_kv = [&](int kt, int buf) {
    __nv_bfloat16* kd = Ks + buf * kFaKeys * LD;
    __nv_bfloat16* vd = Vs + buf * kFaKeys * LD;
    for (int i = tid; i < kFaKeys * CH; i += kFaThreads) {
      const int r = i / CH, ch = i % CH;
      const int s = kt * kFaKeys + r;
      const bool ok = s < kv_lim;
      const size_t off = ok ? (size_t)s * HD + ch * 8 : 0;
      cp_async16_zfill(kd + r * LD + ch * 8, kg + off, ok);
      cp_async16_zfill(vd + r * LD + ch * 8, vg + off, ok);
    }
  };
  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();

  // this lane's two rows: tile rows r0 = 16 warp + g and r0 + 8
  const int r0 = warp * 16 + g;
  const int tq0 = t0 + r0 % bq, tq1 = t0 + (r0 + 8) % bq;
  // the warp's rows hold positions w0 .. w0 + 15 (all bq of them if bq < 16);
  // it needs the key tiles up to its last stored position and plen - 1
  int w0, w_last;
  if (GQA) {
    // live rows ra .. rb: one head's positions ra % bq .. rb % bq, or, where
    // they reach into the next head, every position 0 .. bq - 1
    const int ra = warp * 16, rb = min(ra + 15, live - 1);
    const bool wraps = ra <= rb && ra / bq != rb / bq;
    w0 = ra > rb ? T_ : t0 + (wraps ? 0 : ra % bq);
    w_last = w0 >= T_ ? -1 : min(min(t0 + (wraps ? bq - 1 : rb % bq), T_ - 1), plen - 1);
  } else {
    w0 = t0 + (bq >= 16 ? (warp * 16) % bq : 0);
    w_last = w0 >= T_ ? -1 : min(min(w0 + min(bq, 16) - 1, T_ - 1), plen - 1);
  }
  uint32_t qf[KS][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max (raw scores)
  float l0 = 0.f, l1 = 0.f;               // this lane's part of the row sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // this tile's K / V (and, at kt 0, Q) have landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
    }
    const int k0 = kt * kFaKeys;
    if (k0 <= w_last) {   // some key of the tile is visible to a stored row of the warp
      const __nv_bfloat16* kb = Ks + buf * kFaKeys * LD;
      const __nv_bfloat16* vb = Vs + buf * kFaKeys * LD;

      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {   // keys 16 np .. 16 np + 15
          uint32_t kf[4];
          ldsm_x4(kf, kb + (np * 16 + (lane / 16) * 8 + lane % 8) * LD + ks * 16 +
                          ((lane / 8) % 2) * 8);
          mma_bf16(sc[2 * np], qf[ks], kf[0], kf[1]);
          mma_bf16(sc[2 * np + 1], qf[ks], kf[2], kf[3]);
        }
      }

      if (k0 + kFaKeys - 1 > w0 || k0 + kFaKeys > plen) {   // the tile straddles a limit
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = k0 + n * 8 + 2 * c + (e & 1);
            const int tq = e < 2 ? tq0 : tq1;
            if (s > tq || s >= plen) sc[n][e] = -INFINITY;
          }
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      // a row with nothing visible yet: exponent base 0, every e and alpha 0
      const float mu0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
      const float mu1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
      const float a0 = exp2f(m0 * scale_log2 - mu0), a1 = exp2f(m1 * scale_log2 - mu1);
      m0 = mx0;
      m1 = mx1;

      uint32_t pf[4][4];   // P as A fragments of the four 16-key k-steps
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float e0 = exp2f(fmaf(sc[n][0], scale_log2, -mu0));
        const float e1 = exp2f(fmaf(sc[n][1], scale_log2, -mu0));
        const float e2 = exp2f(fmaf(sc[n][2], scale_log2, -mu1));
        const float e3 = exp2f(fmaf(sc[n][3], scale_log2, -mu1));
        s0 += e0 + e1;
        s1 += e2 + e3;
        pf[n / 2][(n % 2) * 2] = pack_bf16(e0, e1);
        pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(e2, e3);
      }
      l0 = a0 * l0 + s0;
      l1 = a1 * l1 + s1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int dp = 0; dp < NT / 2; ++dp) {   // output dims 16 dp .. 16 dp + 15
          uint32_t vf[4];
          ldsm_x4_trans(vf, vb + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                                (lane / 16) * 8);
          mma_bf16(o[2 * dp], pf[kk], vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pf[kk], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();   // (plen == 0: the Q copy) before Qs is reused
  __syncthreads();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f, i1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* os = Qs + warp * 16 * LD;   // this warp's 16 rows
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + n * 8 + 2 * c) =
        __floats2bfloat162_rn(o[n][0] * i0, o[n][1] * i0);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + n * 8 + 2 * c) =
        __floats2bfloat162_rn(o[n][2] * i1, o[n][3] * i1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int rl = i / CH, ch = i % CH;
    const int r = warp * 16 + rl;
    const int t = t0 + r % bq, h = h0 + r / bq;
    if (t < T_ && (!GQA || r < live))
      *reinterpret_cast<int4*>(out + (((size_t)b * T_ + t) * nh + h) * HD + ch * 8) =
          *reinterpret_cast<const int4*>(os + rl * LD + ch * 8);
  }
}

template <int HD, bool GQA>
cudaError_t launch_pattn_mma(const void* q, const void* k, const void* v, const int* plen,
                             void* out, int B, int T_, int nh, int nkv, int S,
                             cudaStream_t st) {
  const PaRows g = pa_rows(nh / nkv, kFaRows);
  const int tiles = (T_ + g.bq - 1) / g.bq;
  if ((long long)nkv * g.ns > 2147483647LL || B > 65535 || tiles > 65535)
    return cudaErrorInvalidValue;
  constexpr size_t smem = sizeof(__nv_bfloat16) * (kFaRows + 4 * kFaKeys) * (HD + kFaPad);
  auto kern = pattn_mma_kernel<HD, GQA>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  kern<<<dim3(nkv * g.ns, B, tiles), kFaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), plen, static_cast<__nv_bfloat16*>(out), T_, nh,
      nkv, S, scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_pattn_mma_form(const void* q, const void* k, const void* v, const int* plen,
                                  void* out, int B, int T_, int nh, int nkv, int S, int form,
                                  cudaStream_t st) {
  return form ? launch_pattn_mma<HD, true>(q, k, v, plen, out, B, T_, nh, nkv, S, st)
              : launch_pattn_mma<HD, false>(q, k, v, plen, out, B, T_, nh, nkv, S, st);
}

}  // namespace rama

// q (B, T, nh, hd); k/v (B, nkv, S, hd) with rows 0..T-1 written; plen (B,)
// int32; out (B, T, nh, hd).
extern "C" int rama_prefill_attention(const void* q, const void* k, const void* v,
                                      const void* plen, void* out, int B, int T, int nh,
                                      int nkv, int S, int hd, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pl = static_cast<const int*>(plen);
  const int f = rama::pattn_form(nh, nkv);
  if (f < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == rama::kBF16)
    return static_cast<int>(
        rama::launch_pattn<__nv_bfloat16>(q, k, v, pl, out, B, T, nh, nkv, S, hd, f, st));
  if (dtype == rama::kF32)
    return static_cast<int>(
        rama::launch_pattn<float>(q, k, v, pl, out, B, T, nh, nkv, S, hd, f, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 tensor-core body: the same arguments, hd 48, 64 or 128, every
// pointer 16-byte aligned.
extern "C" int rama_prefill_attention_mma(const void* q, const void* k, const void* v,
                                          const void* plen, void* out, int B, int T, int nh,
                                          int nkv, int S, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pl = static_cast<const int*>(plen);
  const int f = rama::pattn_form(nh, nkv);
  if (f < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 48:
      return static_cast<int>(
          rama::launch_pattn_mma_form<48>(q, k, v, pl, out, B, T, nh, nkv, S, f, st));
    case 64:
      return static_cast<int>(
          rama::launch_pattn_mma_form<64>(q, k, v, pl, out, B, T, nh, nkv, S, f, st));
    case 128:
      return static_cast<int>(
          rama::launch_pattn_mma_form<128>(q, k, v, pl, out, B, T, nh, nkv, S, f, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
