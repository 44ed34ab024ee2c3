// Kernel 4: causal flash attention for prefill over freshly written cache
// rows, masked per slot by the prompt length.
//
// Replaces rama_tpu/ops/pallas/prefill_attention.py: prefill_attention
// (_kernel). Query t of slot b (at position t) sees key s iff s <= t and
// s < plen[b]; scores in fp32, online softmax over key tiles, the
// unnormalized probabilities rounded to the cache dtype before P.V (as the
// Pallas kernel's e.astype(v.dtype)), the normalizer from the unrounded
// values. A row with no visible key (plen == 0) outputs zeros, never NaN.
//
// Bound on the H100: operations for long prompts (4 * hd flops per visible
// (query, key) pair, about T^2/2 pairs per head), bytes for short ones (q,
// k, v and out once each).
//
// Design: one CTA per (q-tile, kv head, slot); the rep query heads of the
// kv head are stacked as tile rows (64 rows = rep x 64/rep positions), so
// each K/V tile is read once for the whole GQA group. The CTA walks key
// tiles of 32 rows up to the causal diagonal and up to plen; tiles above
// either are never read. Two threads share a query row (each scores 16 of
// the tile's keys and owns half of the output dims); q, the K/V tiles, the
// probabilities and the fp32 output accumulator live in shared memory.
// fp32 FMA on the CUDA cores; tensor cores (mma/wgmma) are later work.
#include "common.cuh"

#include <math.h>

namespace rama {

constexpr int kPaRows = 64;     // query rows per CTA (rep x positions)
constexpr int kPaKeys = 32;     // keys per tile
constexpr int kPaThreads = 128; // two threads per row

template <typename T>
__global__ void __launch_bounds__(kPaThreads)
pattn_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
             const int* __restrict__ plen_arr, T* __restrict__ out, int T_, int nh, int nkv,
             int S, int hd, float scale) {
  extern __shared__ float sm[];
  const int rep = nh / nkv;
  const int bq = kPaRows / rep;  // positions per tile
  const int tile = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int t0 = tile * bq;
  const int tid = threadIdx.x;
  const int row = tid / 2, half = tid % 2;
  const int rr = row / bq;             // query head within the group
  const int t = t0 + row % bq;         // query position
  const int h = j * rep + rr;
  const int plen = plen_arr[b];
  const int ld = hd + 1;               // padded row stride (bank conflicts)

  float* Qs = sm;                        // [64][ld]
  float* Os = Qs + kPaRows * ld;         // [64][ld]
  float* Ks = Os + kPaRows * ld;         // [32][ld]
  float* Vs = Ks + kPaKeys * ld;         // [32][ld]
  float* Ps = Vs + kPaKeys * ld;         // [64][33]

  for (int i = tid; i < kPaRows * hd; i += kPaThreads) {
    const int r = i / hd, d = i - r * hd;
    const int tq = t0 + r % bq, hq = j * rep + r / bq;
    Qs[r * ld + d] = tq < T_ ? to_f(q[(((size_t)b * T_ + tq) * nh + hq) * hd + d]) : 0.f;
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
  if (t < T_) {
    const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
    T* orow = out + (((size_t)b * T_ + t) * nh + h) * hd;
    for (int d = dbeg; d < dend; ++d) orow[d] = from_f<T>(Os[row * ld + d] * inv);
  }
}

template <typename T>
cudaError_t launch_pattn(const void* q, const void* k, const void* v, const int* plen,
                         void* out, int B, int T_, int nh, int nkv, int S, int hd,
                         cudaStream_t st) {
  const int rep = nh / nkv;
  if (rep < 1 || kPaRows % rep != 0) return cudaErrorInvalidValue;
  const int bq = kPaRows / rep;
  const int ld = hd + 1;
  const size_t smem = sizeof(float) *
      ((size_t)2 * kPaRows * ld + (size_t)2 * kPaKeys * ld + (size_t)kPaRows * 33);
  auto kern = pattn_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  kern<<<dim3((T_ + bq - 1) / bq, nkv, B), kPaThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), plen,
      static_cast<T*>(out), T_, nh, nkv, S, hd, scale);
  return cudaGetLastError();
}

}  // namespace rama

// q (B, T, nh, hd); k/v (B, nkv, S, hd) with rows 0..T-1 written; plen (B,)
// int32; out (B, T, nh, hd).
extern "C" int rama_prefill_attention(const void* q, const void* k, const void* v,
                                      const void* plen, void* out, int B, int T, int nh,
                                      int nkv, int S, int hd, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pl = static_cast<const int*>(plen);
  if (dtype == rama::kBF16)
    return static_cast<int>(
        rama::launch_pattn<__nv_bfloat16>(q, k, v, pl, out, B, T, nh, nkv, S, hd, st));
  if (dtype == rama::kF32)
    return static_cast<int>(rama::launch_pattn<float>(q, k, v, pl, out, B, T, nh, nkv, S, hd, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
