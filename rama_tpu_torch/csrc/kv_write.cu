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
// Bound on the H100: bytes, and far below a launch. K6 at 7B (8 slots, 32
// kv heads, hd 128, bf16) reads 131 KB and writes 67 KB per layer (K11 at
// T = 4 four times that); K8 for
// an admission of 8 prompts of 16 tokens reads 67 MB of strips and writes
// 34 MB. Design: one warp per (row, k or v); each lane keeps up to 8
// elements in registers, the absmax is a warp shuffle reduction, the
// stores are coalesced. No shared memory, no block-wide sync.
//
// Where K11 and K13 (a) run: a launch of their own costs 2.0-2.6 us of
// device time for 0.06-0.24 us of bytes at 7B, so wherever the attention
// that follows them takes the int8 walk (bf16 rows at hd 48 / 64 / 128),
// the walk launch quantizes and writes the chunk's rows itself: the CTA
// whose items hold a row's tile stores it before its walk copies it
// (decode_attention.cu dattn_walk, the `kn` / `vn` operands). The kernels below stay the route of every other body (fp32,
// other head dims) and the fused write's oracle on the card.
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
// hd) cache.
extern "C" int rama_kv_write_strips(const void* k, const void* v, const void* slots, void* k8,
                                    void* v8, void* ks, void* vs, int L, int K, int n, int B,
                                    int nkv, int T, int S, int t_ins, int hd, int dtype,
                                    void* stream) {
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
// (L, npages, nkv, ps, hd) pool.
extern "C" int rama_kv_write_prefill_paged(const void* k, const void* v, const void* tables,
                                           void* k8, void* v8, void* ks, void* vs, int L, int K,
                                           int n, int nkv, int T, int t_ins, int mp, int ps,
                                           int npages, int hd, int dtype, void* stream) {
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
