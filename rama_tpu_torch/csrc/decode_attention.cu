// Kernel 3: T=1 decode attention against layer l of the stacked KV cache,
// flash-decoding style.
//
// Replaces rama_tpu/ops/pallas/decode_attention.py:
// decode_attention_layer (_kernel_layered, whole S stripe per program) and
// decode_attention_layer_tiled (_kernel_tiled, online softmax over S-tiles,
// tiles past pos skipped). Both compute softmax(q k^T / sqrt(hd)) v for the
// GQA group of each kv head, over cache rows s <= pos[b].
//
// Bound on the H100: bytes. Each (slot, kv head) reads (pos+1) rows of K and
// of V, hd * 2 bytes each for a bf16 cache; compute is ~2 flops per byte.
// At 7B (32 kv heads, hd 128) a slot at pos 1023 reads 16.8 MB per layer:
// 5 us at 3.35 TB/s.
//
// Design: the TPU grid walks S-tiles in order inside one program per
// (slot, head group) — at batch 1 that is only 32 programs, too few for 132
// SMs. Here the grid is (S-split, kv head, slot): each CTA scores its
// chunk of rows (16-byte loads of K, RG lanes per row), takes the chunk's
// max and sum in fp32, rounds the probabilities to the cache dtype before
// P.V (as decode_attention.py:75,100 do), and writes a partial (m, l,
// o); CTAs whose chunk starts past pos exit before reading anything. A
// second small kernel combines the splits. All rep query heads of a kv
// head share one read of the K/V rows.
#include "common.cuh"

#include <math.h>

namespace rama {

constexpr int kDaThreads = 128;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (nsplit, nkv, B), block 128. RG = lanes per cache row (each lane 8
// elements of hd, RG = next power of two >= hd/8); REP >= rep = nh/nkv.
template <typename T, int RG, int REP>
__global__ void __launch_bounds__(kDaThreads)
dattn_split(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
            const int* __restrict__ pos, float* __restrict__ part_o,
            float* __restrict__ part_ml, int nh, int nkv, int S, int hd, int chunk,
            float scale) {
  extern __shared__ float sm[];
  const int split = blockIdx.x, j = blockIdx.y, b = blockIdx.z, nsplit = gridDim.x;
  const int tid = threadIdx.x;
  const int rep = nh / nkv;
  const int p = max(0, min(pos[b], S - 1));
  const int s0 = split * chunk;
  if (s0 > p) return;  // the combine pass reads splits 0 .. p / chunk only
  const int s1 = min(s0 + chunk, p + 1);
  const int n = s1 - s0;
  const size_t head0 = (size_t)b * nh + (size_t)j * rep;
  const int ngrp = kDaThreads / RG;

  float* qs = sm;                   // [REP][hd]
  float* sc = qs + REP * hd;        // [REP][chunk]
  float* red = sc + REP * chunk;    // [ngrp][REP][hd]
  for (int i = tid; i < rep * hd; i += kDaThreads) qs[i] = to_f(q[head0 * hd + i]);
  __syncthreads();

  const int lane_g = tid % RG, grp = tid / RG;
  const int d0 = lane_g * 8;
  const bool active = d0 < hd;
  const size_t stripe = ((size_t)b * nkv + j) * (size_t)S * hd;

  // scores: every lane runs the same trip count (shuffles need the full warp)
  for (int base = s0; base < s1; base += ngrp) {
    const int s = base + grp;
    const bool ok = s < s1;
    float kv[8];
    if (ok && active) {
      load8(kc + stripe + (size_t)s * hd + d0, kv);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) kv[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
      float d = 0.f;
      if (active) {
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qs[r * hd + d0 + i], kv[i], d);
      }
#pragma unroll
      for (int o = RG / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane_g == 0 && ok) sc[r * chunk + (s - s0)] = d * scale;
    }
  }
  __syncthreads();

  // chunk max / sum per query row; probabilities rounded to T for P.V
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rep; r += kDaThreads / 32) {
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sc[r * chunk + i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(sc[r * chunk + i] - m);
      l += e;
      sc[r * chunk + i] = round_to<T>(e);
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_ml[((head0 + r) * nsplit + split) * 2] = m;
      part_ml[((head0 + r) * nsplit + split) * 2 + 1] = l;
    }
  }
  __syncthreads();

  float acc[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  if (active) {
    for (int s = s0 + grp; s < s1; s += ngrp) {
      float v[8];
      load8(vc + stripe + (size_t)s * hd + d0, v);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r >= rep) break;
        const float pr = sc[r * chunk + (s - s0)];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(pr, v[i], acc[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
#pragma unroll
      for (int i = 0; i < 8; ++i) red[((size_t)grp * rep + r) * hd + d0 + i] = acc[r][i];
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * hd; i += kDaThreads) {
    const int r = i / hd, d = i - r * hd;
    float v = 0.f;
    for (int g = 0; g < ngrp; ++g) {
      // groups whose lanes cover no dims (RG * 8 > hd) wrote nothing there;
      // every group covers the same dims, so all ngrp rows are written
      v += red[(size_t)g * rep * hd + i];
    }
    part_o[((head0 + r) * nsplit + split) * hd + d] = v;
  }
}

// grid (nh, B), block 128: out[b, h] = sum_i e^(m_i - M) o_i / sum_i e^(m_i - M) l_i
template <typename T>
__global__ void __launch_bounds__(kDaThreads)
dattn_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
              const int* __restrict__ pos, T* __restrict__ out, int nh, int S, int hd,
              int chunk, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t hb = (size_t)b * nh + h;
  const int p = max(0, min(pos[b], S - 1));
  const int nv = p / chunk + 1;
  float mx = -INFINITY;
  for (int i = 0; i < nv; ++i) mx = fmaxf(mx, part_ml[(hb * nsplit + i) * 2]);
  float L = 0.f;
  for (int i = 0; i < nv; ++i)
    L += expf(part_ml[(hb * nsplit + i) * 2] - mx) * part_ml[(hb * nsplit + i) * 2 + 1];
  for (int d = threadIdx.x; d < hd; d += kDaThreads) {
    float o = 0.f;
    for (int i = 0; i < nv; ++i)
      o += expf(part_ml[(hb * nsplit + i) * 2] - mx) * part_o[(hb * nsplit + i) * hd + d];
    out[hb * hd + d] = from_f<T>(o / L);
  }
}

template <typename T, int RG, int REP>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* pos,
                         float* part_o, float* part_ml, int B, int nh, int nkv, int S,
                         int hd, int chunk, int nsplit, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) *
      ((size_t)REP * hd + (size_t)REP * chunk + (size_t)(kDaThreads / RG) * REP * hd);
  auto kern = dattn_split<T, RG, REP>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(nsplit, nkv, B), kDaThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      part_o, part_ml, nh, nkv, S, hd, chunk, scale);
  return cudaGetLastError();
}

template <typename T, int RG>
cudaError_t launch_rep(int rep, const void* q, const void* k, const void* v, const int* pos,
                       float* po, float* pml, int B, int nh, int nkv, int S, int hd,
                       int chunk, int nsplit, float scale, cudaStream_t st) {
  if (rep <= 1) return launch_split<T, RG, 1>(q, k, v, pos, po, pml, B, nh, nkv, S, hd, chunk, nsplit, scale, st);
  if (rep <= 2) return launch_split<T, RG, 2>(q, k, v, pos, po, pml, B, nh, nkv, S, hd, chunk, nsplit, scale, st);
  if (rep <= 4) return launch_split<T, RG, 4>(q, k, v, pos, po, pml, B, nh, nkv, S, hd, chunk, nsplit, scale, st);
  if (rep <= 8) return launch_split<T, RG, 8>(q, k, v, pos, po, pml, B, nh, nkv, S, hd, chunk, nsplit, scale, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_all(const void* q, const void* k, const void* v, const int* pos,
                       void* out, float* po, float* pml, int B, int nh, int nkv, int S,
                       int hd, int chunk, cudaStream_t st) {
  const int nsplit = (S + chunk - 1) / chunk;
  const int rep = nh / nkv;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int lanes = hd / 8;
  cudaError_t e;
  if (lanes <= 1) e = launch_rep<T, 1>(rep, q, k, v, pos, po, pml, B, nh, nkv, S, hd, chunk, nsplit, scale, st);
  else if (lanes <= 2) e = launch_rep<T, 2>(rep, q, k, v, pos, po, pml, B, nh, nkv, S, hd, chunk, nsplit, scale, st);
  else if (lanes <= 4) e = launch_rep<T, 4>(rep, q, k, v, pos, po, pml, B, nh, nkv, S, hd, chunk, nsplit, scale, st);
  else if (lanes <= 8) e = launch_rep<T, 8>(rep, q, k, v, pos, po, pml, B, nh, nkv, S, hd, chunk, nsplit, scale, st);
  else if (lanes <= 16) e = launch_rep<T, 16>(rep, q, k, v, pos, po, pml, B, nh, nkv, S, hd, chunk, nsplit, scale, st);
  else if (lanes <= 32) e = launch_rep<T, 32>(rep, q, k, v, pos, po, pml, B, nh, nkv, S, hd, chunk, nsplit, scale, st);
  else return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  dattn_combine<T><<<dim3(nh, B), kDaThreads, 0, st>>>(po, pml, pos, static_cast<T*>(out),
                                                        nh, S, hd, chunk, nsplit);
  return cudaGetLastError();
}

}  // namespace rama

// q (B, nh, hd); k/v point at layer l of the (L, B, nkv, S, hd) cache;
// pos (B,) int32; out (B, nh * hd); part_o (B, nh, nsplit, hd) and part_ml
// (B, nh, nsplit, 2) fp32 scratch with nsplit = ceil(S / chunk).
extern "C" int rama_decode_attention(const void* q, const void* k, const void* v,
                                     const void* pos, void* out, void* part_o,
                                     void* part_ml, int B, int nh, int nkv, int S, int hd,
                                     int chunk, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (dtype == rama::kBF16)
    return static_cast<int>(rama::launch_all<__nv_bfloat16>(q, k, v, p, out, po, pml, B, nh,
                                                            nkv, S, hd, chunk, st));
  if (dtype == rama::kF32)
    return static_cast<int>(rama::launch_all<float>(q, k, v, p, out, po, pml, B, nh, nkv, S,
                                                    hd, chunk, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
