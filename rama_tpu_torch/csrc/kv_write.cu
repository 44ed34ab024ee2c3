// Kernels 6, 8, 11 and 13: quantize K/V rows to int8 with one f32 absmax
// scale per (token, kv head) row and write them into the int8 KV cache, or
// into the int8 page pool, in place.
//
// Replaces rama_tpu/ops/pallas/kv_write.py:
//   write_kv_rows_q8   (K6)  — the decode step's rows, [layer, b, :, pos[b]];
//   write_kv_chunk_q8  (K11) — a verification chunk's T <= 8 rows per slot,
//                              [layer, b, :, pos0[b] + t] (the Pallas kernel
//                              rewrites the one or two 32-row windows they
//                              fall in; here each row is written alone);
//   write_kv_strips_q8 (K8)  — an admission's prefilled strips,
//                              [:, slots[j], :, 0:T], every layer at once;
//   write_kv_paged_q8 and write_kv_prefill_paged_q8 (K13) — the same rows
//                              and strips into pages of the pool through the
//                              page tables (the Pallas kernels DMA the one or
//                              two stripes, or the ceil(T / ps) pages, around
//                              them, one slot a call for the strips; here
//                              each row is written alone, and one launch
//                              writes an admission group's strips).
// The Pallas kernels take rows already quantized by kv_quant_rows
// (rama_tpu/models/llama.py:178) and DMA a tile-rounded window around
// them; here the quantization is fused into the write, so the row is read
// once in the activation dtype and written once as int8 + its scale.
//
// Row quantization: kv_quant.cuh (bit for bit kv_quant_rows), shared with
// the int8 walk of decode_attention.cu.
//
// Bound on the H100: bytes. K6 at 7B (8 slots, 32 kv heads, hd 128, bf16)
// reads 131 KB and writes 67 KB per layer (K11 at T = 4 four times that),
// far below a launch; K8 and K13 (b) for an admission of 8 prompts of 16
// tokens read 67 MB of strips and write 34 MB (of 512 tokens: 2.15 GB and
// 1.09 GB, 0.97 ms at 3.35 TB/s). Design of the row writers: one warp per
// (row, k or v); each lane keeps up to 8 elements in registers, the absmax
// is a warp shuffle reduction. No shared memory, no block-wide sync.
//
// Where K6, K11 and K13 (a) run: a launch of their own costs 2.0-3.4 us of
// device time for 0.06-0.24 us of bytes at 7B, so wherever the attention
// that follows them takes the int8 walk (bf16 rows at hd 48 / 64 / 128),
// the walk launch quantizes and writes the step's or chunk's rows itself:
// the CTA whose items hold a row's tile stores it before its walk copies
// it (decode_attention.cu dattn_walk, the `kn` / `vn` operands; K6's clamp
// of a finished slot's overshoot onto row S - 1 is its `clamp` rule). The
// row kernels below stay the route of every other body (fp32, other head
// dims) and the fused write's oracle on the card.
//
// K8 and K13 (b) in bf16 at hd 48 / 64 / 128 share one streaming body
// (strip_stream; kernels kv_write_strips_stream and kv_write_prefill_stream):
// their warp-a-row bodies ran at 0.29 and 0.27 of the bound with 64-bit
// divisions and a slot or table read a warp, 2-byte loads and 1-byte
// stores. One CTA takes a run of up to 64 rows of one (layer, strip) inside
// one slot or page, of one kv head or, where runs are shorter, of several
// (one slot or table read, the indices once a CTA), 16-byte loads (8 bf16 a
// lane, LPR lanes a row), every load of the thread issued before its first
// reduction (32 KB in flight a CTA at hd 128), 8-byte int8 stores (a row at
// hd 128 one 128-byte line) and the run's scales as contiguous words. fp32
// and other head dims keep the warp-a-row bodies (kv_write_strips,
// kv_write_prefill_paged), which stay the streaming body's oracle on the
// card.
#include "kv_quant.cuh"

namespace rama {

constexpr int kKvThreads = 256;       // 8 warps per CTA

// K6. Warp w of the grid: w = (b * nkv + h) * 2 + kv. rows (B, nkv, hd);
// k8/v8 point at layer l of (L, B, nkv, S, hd), ks/vs at layer l of
// (L, B, nkv, S).
template <typename T>
__global__ void __launch_bounds__(kKvThreads)
kv_write_rows(const T* __restrict__ k, const T* __restrict__ v, const int* __restrict__ pos,
              int8_t* __restrict__ k8, int8_t* __restrict__ v8, float* __restrict__ ks,
              float* __restrict__ vs, int B, int nkv, int S, int hd) {
  const int w = blockIdx.x * (kKvThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= B * nkv * 2) return;
  const int kv = w % 2, bh = w / 2, b = bh / nkv;
  // a finished slot's overshoot past the cache end writes the last row, as
  // the dense cache's _write_kv clamps
  const int p = max(0, min(pos[b], S - 1));
  const size_t row = (size_t)bh * S + p;
  quant_row(kv ? v + (size_t)bh * hd : k + (size_t)bh * hd, (kv ? v8 : k8) + row * hd,
            (kv ? vs : ks) + row, hd, lane);
}

// K8. Warp w of the grid walks (l, j, h, t, kv) with t < t_ins and
// j < n (slots): strips (L, K, nkv, T, hd) of A, K >= n; row t of strip j lands
// at [l, slots[j], h, t] of (L, B, nkv, S, hd).
template <typename A>
__global__ void __launch_bounds__(kKvThreads)
kv_write_strips(const A* __restrict__ k, const A* __restrict__ v, const int* __restrict__ slots,
                int8_t* __restrict__ k8, int8_t* __restrict__ v8, float* __restrict__ ks,
                float* __restrict__ vs, int L, int K, int n, int B, int nkv, int T, int S,
                int t_ins, int hd) {
  const size_t w = (size_t)blockIdx.x * (kKvThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (size_t)L * n * nkv * t_ins * 2) return;
  const int kv = w % 2;
  size_t r = w / 2;
  const int t = r % t_ins;
  r /= t_ins;
  const int h = r % nkv;
  r /= nkv;
  const int j = r % n;
  const int l = static_cast<int>(r / n);
  const int slot = slots[j];
  if (slot < 0 || slot >= B) return;  // never written out of the cache
  const size_t src = (((size_t)l * K + j) * nkv + h) * T + t;
  const size_t dst = (((size_t)l * B + slot) * nkv + h) * S + t;
  quant_row((kv ? v : k) + src * hd, (kv ? v8 : k8) + dst * hd, (kv ? vs : ks) + dst, hd,
            lane);
}

// K11. Warp w of the grid: w = ((b * T + t) * nkv + h) * 2 + kv. rows
// (B, T, nkv, hd); row t of slot b lands at [layer, b, h, pos0[b] + t] of
// k8/v8 (pointing at layer l); a row at or past S (or before 0) is dropped,
// as JAX's scatter drops it.
template <typename A>
__global__ void __launch_bounds__(kKvThreads)
kv_write_chunk(const A* __restrict__ k, const A* __restrict__ v, const int* __restrict__ pos0,
               int8_t* __restrict__ k8, int8_t* __restrict__ v8, float* __restrict__ ks,
               float* __restrict__ vs, int B, int T, int nkv, int S, int hd) {
  const int w = blockIdx.x * (kKvThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= B * T * nkv * 2) return;
  const int kv = w % 2, r = w / 2;           // r = (b * T + t) * nkv + h
  const int h = r % nkv, bt = r / nkv;
  const int t = bt % T, b = bt / T;
  const int p = pos0[b] + t;
  if (p < 0 || p >= S) return;               // the whole warp leaves together
  const size_t row = ((size_t)b * nkv + h) * S + p;
  quant_row((kv ? v : k) + (size_t)r * hd, (kv ? v8 : k8) + row * hd, (kv ? vs : ks) + row,
            hd, lane);
}

// K13 (a), the paged row / chunk writer. Warp w of the grid: w = ((b * T +
// t) * nkv + h) * 2 + kv. rows (B, T, nkv, hd); row t of slot b, position
// p = pos0[b] + t, lands in page clamp(tables[b, min(p / ps, mp - 1)], 0,
// npages - 1) at in-page row p % ps of k8/v8 (pointing at layer l of the
// (L, npages, nkv, ps, hd) pool). Rows past the slot's table clip into
// page mp - 1, as JAX's fused paged paths do; none is dropped.
template <typename A>
__global__ void __launch_bounds__(kKvThreads)
kv_write_paged(const A* __restrict__ k, const A* __restrict__ v, const int* __restrict__ pos0,
               const int* __restrict__ tables, int8_t* __restrict__ k8, int8_t* __restrict__ v8,
               float* __restrict__ ks, float* __restrict__ vs, int B, int T, int nkv, int mp,
               int ps, int npages, int hd) {
  const int w = blockIdx.x * (kKvThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= B * T * nkv * 2) return;
  const int kv = w % 2, r = w / 2;           // r = (b * T + t) * nkv + h
  const int h = r % nkv, bt = r / nkv;
  const int t = bt % T, b = bt / T;
  const int p = max(pos0[b] + t, 0);
  const int page = min(max(tables[(size_t)b * mp + min(p / ps, mp - 1)], 0), npages - 1);
  const size_t row = ((size_t)page * nkv + h) * ps + p % ps;
  quant_row((kv ? v : k) + (size_t)r * hd, (kv ? v8 : k8) + row * hd, (kv ? vs : ks) + row,
            hd, lane);
}

// K13 (b), the paged admission writer. Warp w of the grid walks (l, j, h,
// t, kv) with t < t_ins and j < n: strips (L, K, nkv, T, hd) of A, K >= n;
// row t of strip j lands in page clamp(tables[j, t / ps], 0, npages - 1) at
// in-page row t % ps of the whole (L, npages, nkv, ps, hd) pool
// (t_ins <= mp * ps).
template <typename A>
__global__ void __launch_bounds__(kKvThreads)
kv_write_prefill_paged(const A* __restrict__ k, const A* __restrict__ v,
                       const int* __restrict__ tables, int8_t* __restrict__ k8,
                       int8_t* __restrict__ v8, float* __restrict__ ks, float* __restrict__ vs,
                       int L, int K, int n, int nkv, int T, int t_ins, int mp, int ps,
                       int npages, int hd) {
  const size_t w = (size_t)blockIdx.x * (kKvThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (size_t)L * n * nkv * t_ins * 2) return;
  const int kv = w % 2;
  size_t r = w / 2;
  const int t = r % t_ins;
  r /= t_ins;
  const int h = r % nkv;
  r /= nkv;
  const int j = r % n;
  const int l = static_cast<int>(r / n);
  const int page = min(max(tables[(size_t)j * mp + t / ps], 0), npages - 1);
  const size_t src = (((size_t)l * K + j) * nkv + h) * T + t;
  const size_t dst = (((size_t)l * npages + page) * nkv + h) * ps + t % ps;
  quant_row((kv ? v : k) + src * hd, (kv ? v8 : k8) + dst * hd, (kv ? vs : ks) + dst, hd,
            lane);
}

constexpr int kKvWarps = kKvThreads / 32;

// The streaming strip writer of K8 and K13 (b) (bf16, HD 48 / 64 / 128).
// CTA (x, y, z) writes rows t in [x R, min(x R + R, t_ins)) (n rows: a run
// of R rows) of kv heads h0 .. h0 + nh - 1 (H a CTA, heads_per_run: more
// than one where the runs are short, so a CTA still moves up to kRunRows
// rows of K and of V) of strip j, layer l = z, with j, h0 from y. The run
// lies in one block of `rows` rows a head, for every head:
//   K13 (b): the page clamp(index[j, x R / rows], 0, nblk - 1) of the pool
//            (rows = ps; R divides the page or is the page, run_rows, so no
//            run straddles two pages);
//   K8 (DENSE): the slot index[j] of the cache (rows = S; R = kRunRows at
//            any S, a strip being contiguous over S). A slot outside [0,
//            nblk) is written nowhere: the CTA leaves before it loads.
//            Two strips for one slot (batch padding repeats an entry)
//            store into the same rows from two CTAs in any order; that is
//            safe only because such strips, and so their bytes, are
//            identical.
// The run's 2 nh n row jobs (the K rows head by head, then the V rows) go
// 32 / LPR to a warp, the lanes of a row consecutive (LPR: 16 at HD 128, 8
// at 64 and 48, of which 6 hold elements), in PASSES passes of
// kStreamThreads / LPR jobs; every pass's 16-byte load is issued before the
// first reduction. A row's bytes go out as LPR 8-byte stores, the run's
// scales through shared memory as n contiguous words a head.
constexpr int kStreamThreads = 256;
constexpr int kRunRows = 64;          // rows of K (and of V) a CTA at most

// Row r of head hh of a run, in rows of a head stride apart: in 64-bit for
// the dense cache (a head of S rows, S up to the longest cache), in 32-bit
// for the pool and the scratch strips, as K13 (b) was first built.
template <bool WIDE>
__device__ __forceinline__ auto run_row(int hh, int stride, int r) {
  if constexpr (WIDE)
    return static_cast<size_t>(hh) * stride + r;
  else
    return hh * stride + r;
}

template <int HD, bool DENSE>
__device__ __forceinline__ void strip_stream(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ index, int8_t* __restrict__ k8, int8_t* __restrict__ v8,
    float* __restrict__ ks, float* __restrict__ vs, int K, int nkv, int T, int t_ins, int mp,
    int rows, int nblk, int R, int H) {
  static_assert(HD % 8 == 0 && HD <= 128, "8 elements a lane, at most 16 lanes a row");
  constexpr int LPR = HD > 64 ? 16 : 8;                   // lanes a row (power of two)
  constexpr int JOBS = kStreamThreads / LPR;              // row jobs a pass
  constexpr int PASSES = 2 * kRunRows / JOBS;
  __shared__ float sc[2 * kRunRows];
  const int groups = (nkv + H - 1) / H;                   // head groups a strip
  const int l = blockIdx.z, j = blockIdx.y / groups, h0 = (blockIdx.y - j * groups) * H;
  const int nh = min(H, nkv - h0);
  const int t0 = blockIdx.x * R, n = min(R, t_ins - t0), m = nh * n;   // m rows of K, of V
  int blk;                                                // the slot or the page
  if constexpr (DENSE) {
    blk = index[j];
    if (blk < 0 || blk >= nblk) return;                   // never written out of the cache
  } else {
    blk = min(max(index[j * mp + t0 / rows], 0), nblk - 1);
  }
  const size_t src = (((size_t)l * K + j) * nkv + h0) * T + t0;                // first row read
  const size_t dst = (((size_t)l * nblk + blk) * nkv + h0) * rows +            // first written
                     (DENSE ? t0 : t0 % rows);
  const __nv_bfloat16* kin = k + src * HD;
  const __nv_bfloat16* vin = v + src * HD;
  int8_t* kout = k8 + dst * HD;
  int8_t* vout = v8 + dst * HD;
  const int li = threadIdx.x % LPR;                       // the lane's place in its row
  const int job0 = threadIdx.x / LPR;                     // its job in the first pass
  const bool act = li * 8 < HD;                           // the lane holds 8 elements
  // job i: V if i >= m; head hh = (i mod m) / n, row r = (i mod m) % n of the
  // run. The quotient is e * ceil(2^16 / n) >> 16, exact for e < m <= 64 and
  // n <= 64 (an integer division a job took 512-row strips from 1.12 to 1.39
  // ms on an H100: the kernel issues few instructions a byte)
  const uint32_t inv = (65536u + n - 1) / n;
  auto where = [&](int i, bool& isv, int& hh, int& r) {
    isv = i >= m;
    const int e = i - (isv ? m : 0);
    hh = static_cast<int>((static_cast<uint32_t>(e) * inv) >> 16);
    r = e - hh * n;
  };
  uint4 u[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int job = p * JOBS + job0;
    u[p] = make_uint4(0u, 0u, 0u, 0u);
    if (job < 2 * m && act) {
      bool isv;
      int hh, r;
      where(job, isv, hh, r);
      u[p] = __ldcs(reinterpret_cast<const uint4*>((isv ? vin : kin) +
                                                   run_row<DENSE>(hh, T, r) * HD) + li);
    }
  }
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    if (p * JOBS >= 2 * m) break;                         // the whole CTA
    const int job = p * JOBS + job0;
    float scale;
    const uint2 q = quant_row8<LPR>(u[p], scale);
    if (job < 2 * m) {
      bool isv;
      int hh, r;
      where(job, isv, hh, r);
      if (act)
        *reinterpret_cast<uint2*>((isv ? vout : kout) + run_row<DENSE>(hh, rows, r) * HD +
                                  li * 8) = q;
      if (li == 0) sc[job] = scale;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * m; i += kStreamThreads) {
    bool isv;
    int hh, r;
    where(i, isv, hh, r);
    if constexpr (DENSE)
      (isv ? vs : ks)[dst + run_row<true>(hh, rows, r)] = sc[i];
    else
      (isv ? vs : ks)[dst + hh * rows + r] = sc[i];
  }
}

// K13 (b)'s streaming body: the run in page clamp(tables[j, x R / ps], 0,
// npages - 1) of the (L, npages, nkv, ps, hd) pool, R = run_rows(ps).
template <int HD>
__global__ void __launch_bounds__(kStreamThreads)
kv_write_prefill_stream(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ tables, int8_t* __restrict__ k8,
                        int8_t* __restrict__ v8, float* __restrict__ ks, float* __restrict__ vs,
                        int K, int nkv, int T, int t_ins, int mp, int ps, int npages, int R,
                        int H) {
  strip_stream<HD, false>(k, v, tables, k8, v8, ks, vs, K, nkv, T, t_ins, mp, ps, npages, R, H);
}

// K8's streaming body: the run in slot slots[j] of the (L, B, nkv, S, hd)
// cache, runs of kRunRows rows at any S.
template <int HD>
__global__ void __launch_bounds__(kStreamThreads)
kv_write_strips_stream(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                       const int* __restrict__ slots, int8_t* __restrict__ k8,
                       int8_t* __restrict__ v8, float* __restrict__ ks, float* __restrict__ vs,
                       int K, int nkv, int T, int t_ins, int B, int S, int H) {
  strip_stream<HD, true>(k, v, slots, k8, v8, ks, vs, K, nkv, T, t_ins, 0, S, B, kRunRows, H);
}

// Rows of a K13 (b) run over pages of ps rows: the page, up to kRunRows;
// else the largest power of two <= kRunRows dividing ps (64 for 128-row
// pages), so that no run straddles two pages.
inline int run_rows(int ps) {
  if (ps <= kRunRows) return ps;
  int r = kRunRows;
  while (ps % r) r /= 2;
  return r;
}

// kv heads a CTA of the streaming body takes, so that its longest run
// (min(R, t_ins) rows a head) comes to at most kRunRows rows: 4 at 16-row
// strips or pages, 1 where a run is 64 rows.
inline int heads_per_run(int R, int t_ins, int nkv) {
  const int h = kRunRows / (R < t_ins ? R : t_ins);
  return h < 1 ? 1 : h > nkv ? nkv : h;
}

// the body codes of K8's and K13 (b)'s C entries (kv_write.py STRIP_BODIES)
enum StripBody : int { kStripRows = 0, kStripStream = 1 };

// The streaming body's refusals (a zero-size strip set never reaches it).
inline bool stream_takes(const void* k, const void* v, int n, int nkv, int L, int hd,
                         int dtype) {
  return dtype == kBF16 && (hd == 48 || hd == 64 || hd == 128) && n * nkv <= 65535 &&
         L <= 65535 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

}  // namespace rama

// K6: k/v (B, nkv, hd) rows; k8/v8/ks/vs point at layer l of the cache.
extern "C" int rama_kv_write_rows(const void* k, const void* v, const void* pos, void* k8,
                                  void* v8, void* ks, void* vs, int B, int nkv, int S, int hd,
                                  int dtype, void* stream) {
  using namespace rama;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B * nkv * 2 + kKvWarps - 1) / kKvWarps;
  const int* p = static_cast<const int*>(pos);
  int8_t* k8p = static_cast<int8_t*>(k8);
  int8_t* v8p = static_cast<int8_t*>(v8);
  float* ksp = static_cast<float*>(ks);
  float* vsp = static_cast<float*>(vs);
  if (hd > 32 * kKvMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    kv_write_rows<__nv_bfloat16><<<blocks, kKvThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), p, k8p,
        v8p, ksp, vsp, B, nkv, S, hd);
  else if (dtype == kF32)
    kv_write_rows<float><<<blocks, kKvThreads, 0, st>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), p, k8p, v8p, ksp, vsp, B,
        nkv, S, hd);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K11: k/v (B, T, nkv, hd) rows, pos0 (B,) int32; k8/v8/ks/vs point at
// layer l of the cache.
extern "C" int rama_kv_write_chunk(const void* k, const void* v, const void* pos0, void* k8,
                                   void* v8, void* ks, void* vs, int B, int T, int nkv, int S,
                                   int hd, int dtype, void* stream) {
  using namespace rama;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B * T * nkv * 2 + kKvWarps - 1) / kKvWarps;
  const int* p = static_cast<const int*>(pos0);
  int8_t* k8p = static_cast<int8_t*>(k8);
  int8_t* v8p = static_cast<int8_t*>(v8);
  float* ksp = static_cast<float*>(ks);
  float* vsp = static_cast<float*>(vs);
  if (hd > 32 * kKvMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    kv_write_chunk<__nv_bfloat16><<<blocks, kKvThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), p, k8p,
        v8p, ksp, vsp, B, T, nkv, S, hd);
  else if (dtype == kF32)
    kv_write_chunk<float><<<blocks, kKvThreads, 0, st>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), p, k8p, v8p, ksp, vsp, B,
        T, nkv, S, hd);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K8: k/v (L, K, nkv, T, hd) strips, slots (n,) int32 with n <= K; rows
// 0 .. t_ins-1 of strip j go to slot slots[j] of the whole (L, B, nkv, S,
// hd) cache (a slot outside [0, B) nowhere). body: kStripStream (bf16 at hd
// 48 / 64 / 128, k / v 16-byte aligned) or kStripRows (any).
extern "C" int rama_kv_write_strips(const void* k, const void* v, const void* slots, void* k8,
                                    void* v8, void* ks, void* vs, int L, int K, int n, int B,
                                    int nkv, int T, int S, int t_ins, int hd, int dtype,
                                    int body, void* stream) {
  using namespace rama;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t warps = (size_t)L * n * nkv * t_ins * 2;
  if (warps == 0) return 0;
  const size_t blocks = (warps + kKvWarps - 1) / kKvWarps;
  if (hd > 32 * kKvMaxPerLane || blocks > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* sl = static_cast<const int*>(slots);
  int8_t* k8p = static_cast<int8_t*>(k8);
  int8_t* v8p = static_cast<int8_t*>(v8);
  float* ksp = static_cast<float*>(ks);
  float* vsp = static_cast<float*>(vs);
  if (body == kStripStream) {
    if (!stream_takes(k, v, n, nkv, L, hd, dtype)) return static_cast<int>(cudaErrorInvalidValue);
    const int H = heads_per_run(kRunRows, t_ins, nkv);
    const dim3 grid((t_ins + kRunRows - 1) / kRunRows, n * ((nkv + H - 1) / H), L);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    if (hd == 128)
      kv_write_strips_stream<128><<<grid, kStreamThreads, 0, st>>>(
          kb, vb, sl, k8p, v8p, ksp, vsp, K, nkv, T, t_ins, B, S, H);
    else if (hd == 64)
      kv_write_strips_stream<64><<<grid, kStreamThreads, 0, st>>>(
          kb, vb, sl, k8p, v8p, ksp, vsp, K, nkv, T, t_ins, B, S, H);
    else
      kv_write_strips_stream<48><<<grid, kStreamThreads, 0, st>>>(
          kb, vb, sl, k8p, v8p, ksp, vsp, K, nkv, T, t_ins, B, S, H);
    return static_cast<int>(cudaGetLastError());
  }
  if (body != kStripRows) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    kv_write_strips<__nv_bfloat16><<<(unsigned)blocks, kKvThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), sl, k8p,
        v8p, ksp, vsp, L, K, n, B, nkv, T, S, t_ins, hd);
  else if (dtype == kF32)
    kv_write_strips<float><<<(unsigned)blocks, kKvThreads, 0, st>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), sl, k8p, v8p, ksp, vsp, L,
        K, n, B, nkv, T, S, t_ins, hd);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K13 (a): k/v (B, T, nkv, hd) rows, pos0 (B,) int32, tables (B, mp) int32;
// k8/v8/ks/vs point at layer l of the (L, npages, nkv, ps, hd) pool.
extern "C" int rama_kv_write_paged(const void* k, const void* v, const void* pos0,
                                   const void* tables, void* k8, void* v8, void* ks, void* vs,
                                   int B, int T, int nkv, int mp, int ps, int npages, int hd,
                                   int dtype, void* stream) {
  using namespace rama;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B * T * nkv * 2 + kKvWarps - 1) / kKvWarps;
  const int* p = static_cast<const int*>(pos0);
  const int* tb = static_cast<const int*>(tables);
  int8_t* k8p = static_cast<int8_t*>(k8);
  int8_t* v8p = static_cast<int8_t*>(v8);
  float* ksp = static_cast<float*>(ks);
  float* vsp = static_cast<float*>(vs);
  if (hd > 32 * kKvMaxPerLane || ps <= 0 || mp <= 0 || npages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    kv_write_paged<__nv_bfloat16><<<blocks, kKvThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), p, tb, k8p,
        v8p, ksp, vsp, B, T, nkv, mp, ps, npages, hd);
  else if (dtype == kF32)
    kv_write_paged<float><<<blocks, kKvThreads, 0, st>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), p, tb, k8p, v8p, ksp, vsp,
        B, T, nkv, mp, ps, npages, hd);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K13 (b): k/v (L, K, nkv, T, hd) strips, tables (n, mp) int32 with n <= K;
// rows 0 .. t_ins-1 of strip j go through table row j into the whole
// (L, npages, nkv, ps, hd) pool. body: kStripStream (bf16 at hd 48 / 64 /
// 128, k / v 16-byte aligned) or kStripRows (any).
extern "C" int rama_kv_write_prefill_paged(const void* k, const void* v, const void* tables,
                                           void* k8, void* v8, void* ks, void* vs, int L, int K,
                                           int n, int nkv, int T, int t_ins, int mp, int ps,
                                           int npages, int hd, int dtype, int body,
                                           void* stream) {
  using namespace rama;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t warps = (size_t)L * n * nkv * t_ins * 2;
  if (warps == 0) return 0;
  const size_t blocks = (warps + kKvWarps - 1) / kKvWarps;
  if (hd > 32 * kKvMaxPerLane || blocks > 0x7fffffffu || ps <= 0 || npages <= 0 ||
      t_ins > mp * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tb = static_cast<const int*>(tables);
  int8_t* k8p = static_cast<int8_t*>(k8);
  int8_t* v8p = static_cast<int8_t*>(v8);
  float* ksp = static_cast<float*>(ks);
  float* vsp = static_cast<float*>(vs);
  if (body == kStripStream) {
    if (!stream_takes(k, v, n, nkv, L, hd, dtype)) return static_cast<int>(cudaErrorInvalidValue);
    const int R = run_rows(ps), H = heads_per_run(R, t_ins, nkv);
    const dim3 grid((t_ins + R - 1) / R, n * ((nkv + H - 1) / H), L);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    if (hd == 128)
      kv_write_prefill_stream<128><<<grid, kStreamThreads, 0, st>>>(
          kb, vb, tb, k8p, v8p, ksp, vsp, K, nkv, T, t_ins, mp, ps, npages, R, H);
    else if (hd == 64)
      kv_write_prefill_stream<64><<<grid, kStreamThreads, 0, st>>>(
          kb, vb, tb, k8p, v8p, ksp, vsp, K, nkv, T, t_ins, mp, ps, npages, R, H);
    else
      kv_write_prefill_stream<48><<<grid, kStreamThreads, 0, st>>>(
          kb, vb, tb, k8p, v8p, ksp, vsp, K, nkv, T, t_ins, mp, ps, npages, R, H);
    return static_cast<int>(cudaGetLastError());
  }
  if (body != kStripRows) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    kv_write_prefill_paged<__nv_bfloat16><<<(unsigned)blocks, kKvThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), tb, k8p,
        v8p, ksp, vsp, L, K, n, nkv, T, t_ins, mp, ps, npages, hd);
  else if (dtype == kF32)
    kv_write_prefill_paged<float><<<(unsigned)blocks, kKvThreads, 0, st>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), tb, k8p, v8p, ksp, vsp, L,
        K, n, nkv, T, t_ins, mp, ps, npages, hd);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
