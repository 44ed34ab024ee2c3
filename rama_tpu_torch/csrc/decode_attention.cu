// Kernels 4 and 7: T=1 decode attention against layer l of the stacked KV
// cache, flash-decoding style, over a bf16 / f32 cache (K4) or an int8
// cache with one f32 scale per (token, kv head) row (K7).
//
// Replaces rama_tpu/ops/pallas/decode_attention.py:
// decode_attention_layer (_kernel_layered, whole S stripe per program) and
// decode_attention_layer_tiled (_kernel_tiled, online softmax over S-tiles,
// tiles past pos skipped) for K4; decode_attention_layer_q8 and
// decode_attention_layer_tiled_q8 (_kernel_q8, _kernel_tiled_q8) for K7.
// All compute softmax(q k^T / sqrt(hd)) v for the GQA group of each kv
// head, over cache rows s <= pos[b]; the int8 forms apply the row scales
// after the products: score = (q . k8[s]) * ks[s] / sqrt(hd), and the V
// side sums (p[s] * vs[s]) * v8[s].
//
// Bound on the H100: bytes. Each (slot, kv head) reads (pos+1) rows of K and
// of V, hd * 2 bytes each for a bf16 cache (hd bytes + a 4-byte scale for
// int8); compute is ~2 flops per byte (~4 for int8).
// At 7B (32 kv heads, hd 128) a slot at pos 1023 reads 16.8 MB per layer
// from a bf16 cache, 8.7 MB from an int8 one: 5 us / 2.6 us at 3.35 TB/s.
//
// Design: the TPU grid walks S-tiles in order inside one program per
// (slot, head group) — at batch 1 that is only 32 programs, too few for 132
// SMs. Here the grid is (S-split, kv head, slot): each CTA scores its
// chunk of rows (16-byte loads of K: 8 bf16 or 16 int8 lanes, RG lanes per
// row), takes the chunk's max and sum in fp32, rounds the probabilities
// (times the V row scale, for int8) to q's dtype before P.V (as
// decode_attention.py:75,100 and the q8 kernels' bf16 casts do), and writes
// a partial (m, l, o); CTAs whose chunk starts past pos exit before
// reading anything. A second small kernel combines the splits. All rep
// query heads of a kv head share one read of the K/V rows.
#include "common.cuh"

#include <math.h>

#include <type_traits>

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

// 16 consecutive int8 cache elements (one 16-byte load) as f32; p must be
// 16-byte aligned.
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const char4* c = reinterpret_cast<const char4*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[4 * i] = c[i].x;
    out[4 * i + 1] = c[i].y;
    out[4 * i + 2] = c[i].z;
    out[4 * i + 3] = c[i].w;
  }
}

// EPL cache elements of one lane: 8 of a bf16 / f32 cache, 16 of int8.
template <typename C> struct Lane { static constexpr int EPL = 8; };
template <> struct Lane<int8_t> { static constexpr int EPL = 16; };

template <int EPL, typename C>
__device__ __forceinline__ void load_lane(const C* p, float* out) {
  if constexpr (EPL == 16) load16(p, out);
  else load8(p, out);
}

// grid (nsplit, nkv, B), block 128. T: q's dtype; C: the cache's (T, or
// int8_t with row scales ksc / vsc, which are null otherwise). RG = lanes
// per cache row (each lane EPL elements of hd, RG = next power of two >=
// hd/EPL); REP >= rep = nh/nkv.
template <typename T, typename C, int RG, int REP>
__global__ void __launch_bounds__(kDaThreads)
dattn_split(const T* __restrict__ q, const C* __restrict__ kc, const C* __restrict__ vc,
            const float* __restrict__ ksc, const float* __restrict__ vsc,
            const int* __restrict__ pos, float* __restrict__ part_o,
            float* __restrict__ part_ml, int nh, int nkv, int S, int hd, int chunk,
            float scale) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  constexpr int EPL = Lane<C>::EPL;
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
  const int d0 = lane_g * EPL;
  const bool active = d0 < hd;
  const size_t srow = ((size_t)b * nkv + j) * (size_t)S;  // row scales of the stripe
  const size_t stripe = srow * hd;

  // scores: every lane runs the same trip count (shuffles need the full warp)
  for (int base = s0; base < s1; base += ngrp) {
    const int s = base + grp;
    const bool ok = s < s1;
    float kv[EPL];
    if (ok && active) {
      load_lane<EPL>(kc + stripe + (size_t)s * hd + d0, kv);
    } else {
#pragma unroll
      for (int i = 0; i < EPL; ++i) kv[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
      float d = 0.f;
      if (active) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) d = fmaf(qs[r * hd + d0 + i], kv[i], d);
      }
#pragma unroll
      for (int o = RG / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if constexpr (kQ8) {
        if (lane_g == 0 && ok) sc[r * chunk + (s - s0)] = d * ksc[srow + s] * scale;
      } else {
        if (lane_g == 0 && ok) sc[r * chunk + (s - s0)] = d * scale;
      }
    }
  }
  __syncthreads();

  // chunk max / sum per query row; probabilities (times the V row scale,
  // for int8) rounded to T for P.V
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rep; r += kDaThreads / 32) {
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sc[r * chunk + i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(sc[r * chunk + i] - m);
      l += e;
      if constexpr (kQ8) sc[r * chunk + i] = round_to<T>(e * vsc[srow + s0 + i]);
      else sc[r * chunk + i] = round_to<T>(e);
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_ml[((head0 + r) * nsplit + split) * 2] = m;
      part_ml[((head0 + r) * nsplit + split) * 2 + 1] = l;
    }
  }
  __syncthreads();

  float acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[r][i] = 0.f;
  if (active) {
    for (int s = s0 + grp; s < s1; s += ngrp) {
      float v[EPL];
      load_lane<EPL>(vc + stripe + (size_t)s * hd + d0, v);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r >= rep) break;
        const float pr = sc[r * chunk + (s - s0)];
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[r][i] = fmaf(pr, v[i], acc[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
#pragma unroll
      for (int i = 0; i < EPL; ++i) red[((size_t)grp * rep + r) * hd + d0 + i] = acc[r][i];
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * hd; i += kDaThreads) {
    const int r = i / hd, d = i - r * hd;
    float v = 0.f;
    for (int g = 0; g < ngrp; ++g) {
      // groups whose lanes cover no dims (RG * EPL > hd) wrote nothing there;
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

// One launch's operands (ks / vs null for a bf16 / f32 cache).
struct DaArgs {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int* pos;
  void* out;
  float *part_o, *part_ml;
  int B, nh, nkv, S, hd, chunk, nsplit;
  float scale;
  cudaStream_t st;
};

template <typename T, typename C, int RG, int REP>
cudaError_t launch_split(const DaArgs& a) {
  const size_t smem = sizeof(float) * ((size_t)REP * a.hd + (size_t)REP * a.chunk +
                                       (size_t)(kDaThreads / RG) * REP * a.hd);
  auto kern = dattn_split<T, C, RG, REP>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.nsplit, a.nkv, a.B), kDaThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k), static_cast<const C*>(a.v),
      a.ks, a.vs, a.pos, a.part_o, a.part_ml, a.nh, a.nkv, a.S, a.hd, a.chunk, a.scale);
  return cudaGetLastError();
}

template <typename T, typename C, int RG>
cudaError_t launch_rep(const DaArgs& a) {
  const int rep = a.nh / a.nkv;
  if (rep <= 1) return launch_split<T, C, RG, 1>(a);
  if (rep <= 2) return launch_split<T, C, RG, 2>(a);
  if (rep <= 4) return launch_split<T, C, RG, 4>(a);
  if (rep <= 8) return launch_split<T, C, RG, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename T, typename C>
cudaError_t launch_all(DaArgs a) {
  a.nsplit = (a.S + a.chunk - 1) / a.chunk;
  a.scale = 1.f / sqrtf(static_cast<float>(a.hd));
  const int lanes = a.hd / Lane<C>::EPL;
  cudaError_t e;
  if (lanes <= 1) e = launch_rep<T, C, 1>(a);
  else if (lanes <= 2) e = launch_rep<T, C, 2>(a);
  else if (lanes <= 4) e = launch_rep<T, C, 4>(a);
  else if (lanes <= 8) e = launch_rep<T, C, 8>(a);
  else if (lanes <= 16) e = launch_rep<T, C, 16>(a);
  else if (lanes <= 32) {
    if constexpr (Lane<C>::EPL == 8) e = launch_rep<T, C, 32>(a);
    else return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  dattn_combine<T><<<dim3(a.nh, a.B), kDaThreads, 0, a.st>>>(
      a.part_o, a.part_ml, a.pos, static_cast<T*>(a.out), a.nh, a.S, a.hd, a.chunk, a.nsplit);
  return cudaGetLastError();
}

}  // namespace rama

// K4. q (B, nh, hd); k/v point at layer l of the (L, B, nkv, S, hd) cache
// of q's dtype; pos (B,) int32; out (B, nh * hd); part_o (B, nh, nsplit,
// hd) and part_ml (B, nh, nsplit, 2) fp32 scratch with nsplit =
// ceil(S / chunk).
extern "C" int rama_decode_attention(const void* q, const void* k, const void* v,
                                     const void* pos, void* out, void* part_o,
                                     void* part_ml, int B, int nh, int nkv, int S, int hd,
                                     int chunk, int dtype, void* stream) {
  const rama::DaArgs a{q, k, v, nullptr, nullptr, static_cast<const int*>(pos), out,
                       static_cast<float*>(part_o), static_cast<float*>(part_ml),
                       B, nh, nkv, S, hd, chunk, 0, 0.f, static_cast<cudaStream_t>(stream)};
  if (dtype == rama::kBF16)
    return static_cast<int>(rama::launch_all<__nv_bfloat16, __nv_bfloat16>(a));
  if (dtype == rama::kF32) return static_cast<int>(rama::launch_all<float, float>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7. As K4 over an int8 cache: k8/v8 point at layer l of (L, B, nkv, S,
// hd) int8, ks/vs at layer l of its (L, B, nkv, S) f32 row scales; hd a
// multiple of 16.
extern "C" int rama_decode_attention_q8(const void* q, const void* k8, const void* v8,
                                        const void* ks, const void* vs, const void* pos,
                                        void* out, void* part_o, void* part_ml, int B, int nh,
                                        int nkv, int S, int hd, int chunk, int dtype,
                                        void* stream) {
  const rama::DaArgs a{q, k8, v8, static_cast<const float*>(ks), static_cast<const float*>(vs),
                       static_cast<const int*>(pos), out, static_cast<float*>(part_o),
                       static_cast<float*>(part_ml), B, nh, nkv, S, hd, chunk, 0, 0.f,
                       static_cast<cudaStream_t>(stream)};
  if (dtype == rama::kBF16) return static_cast<int>(rama::launch_all<__nv_bfloat16, int8_t>(a));
  if (dtype == rama::kF32) return static_cast<int>(rama::launch_all<float, int8_t>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}
