// Kernel 14: the fused attention block of the T = 1 decode step on a dense
// cache -- RoPE of q and of the new k row, the in-place write of the k / v
// row at pos into layer l of the stacked cache, and attention over the
// cache rows before pos plus the new row (light form, one launch); the full
// form also multiplies the attention output by the quantized wo[l] in the
// same launch.
//
// Replaces rama_tpu/ops/pallas/attn_block.py: attn_rope_write_layered
// (_kernel_aw, the light fusion) and attn_block_layered (_kernel, phase B
// then phase C over wo). For each (slot b, kv head j) with p = pos[b]:
//   q_r  = rope(q[b, j*rep + r]), k_n = rope(k_new[b, j]) in fp32
//          (interleaved pairs: out[2i] = x[2i] c_i - x[2i+1] s_i,
//          out[2i+1] = x[2i+1] c_i + x[2i] s_i);
//   att  = softmax over {cache rows s < p} + {the new row} of q_r . k / sqrt(hd),
//          times v: the new row's score and value from registers (k_n in
//          fp32, not rounded to the cache dtype; v_new as given), the cache
//          rows in fp32 -- the probabilities are NOT rounded to the cache
//          dtype before P.V (K4 rounds them; the Pallas kernels here do not);
//   cache[l, b, j, p] = (k_n in the cache dtype, v_new).
// Light: att in q's dtype. Full: att kept in fp32 in a scratch, then
// out = att @ dequant(wo[l]) (int8, or int4 in the block-split layout, group
// scales) in q's dtype. p is clamped to [0, S-1] (the port's rule for a
// finished slot's T = 1 overshoot); the Pallas kernel is not defined there.
//
// Bound on the H100: bytes -- each (slot, kv head) reads its p rows of K and
// V once (7B, bf16, 8 slots at the kernel check's positions: 47.3 MB,
// 14 us at 3.35 TB/s); the full form adds wo[l] (18.0 MB int8, 9.6 MB int4).
//
// Design. The TPU kernel walks S tiles of one (slot, head group) in grid
// order with the online softmax in VMEM scratch; phase C follows on the same
// sequential grid. Here:
//  * phase B is one CTA (256 threads) per (slot, kv head) -- 256 CTAs at 7B,
//    B = 8 -- that ropes its rep query rows and the new k row into shared
//    memory, writes row p of the cache (no other CTA touches that stripe,
//    and this one reads only rows < p: no race), folds the new row into the
//    running (m, l, acc) first, as the Pallas kernel does at t == 0, then
//    walks rows 0 .. p-1 in tiles of `chunk` rows copied into shared memory
//    with cp.async (one wait a tile), updating (m, l, acc) per tile in fp32.
//    The rows of the GQA group live in registers during P.V as in
//    decode_attention.cu (16 lanes of 8 elements a cache row at hd 128).
//    One CTA walks a whole stripe: at long context that is slower than K4's
//    64-row splits with a combine (a later PR's work, PERF.md).
//  * the full form is ONE cooperative launch of a persistent grid (resident
//    CTAs per SM x SMs): the CTAs take the phase-B items in a grid-stride
//    loop, park att in fp32 (as the Pallas kernel parks it, attn_block.py
//    :552), meet at a grid-wide barrier (an atomic counter in the tickets
//    buffer; co-residency is what the cooperative launch guarantees, and a
//    launch it refuses returns its error), then take phase C's items --
//    (column tile, K split) of qmv.cuh's split-K GEMV, the same device code
//    as kernel 1 -- in a second grid-stride loop. The last CTA out resets
//    the barrier's counters for the next launch.
#include "attention.cuh"
#include "qmv.cuh"

#include <math.h>

namespace rama {

constexpr int kAbThreads = 256;
constexpr int kAbWarps = kAbThreads / 32;
constexpr int kAbHeadDim = 128;                 // the only head_dim taken
constexpr int kAbRG = kAbHeadDim / 8;           // lanes a cache row (8 elements each)

// One launch's operands. q rows of slot b start at q + b * q_stride, the
// new k / v rows at kn / vn + b * kv_stride (the slices of one wqkv output
// row); kc / vc point at layer l of the (L, B, nkv, S, hd) cache.
struct AbArgs {
  const void *q, *kn, *vn;
  const float *cosr, *sinr;   // (B, hd / 2) RoPE rows at pos
  void *kc, *vc;
  const int* pos;
  void* att;                  // light: (B, nh * hd) in q's dtype; full: f32 scratch
  const int8_t* woq;          // full: wo[l] bytes, (D, N) int8 or (D/2, N) int4
  const float* wos;           // full: wo[l] scales (D / gs, N)
  void* out;                  // full: (B, N) in q's dtype
  float* part;                // full: (ks, B, N) split-K partials (ks > 1)
  unsigned* tickets;          // full: zeroed counters, column tiles x row chunks + 2
  int B, nh, nkv, S, hd, chunk, q_stride, kv_stride, N, gs, ks, bps;
  float scale;
};

// Dynamic shared memory of phase B, in bytes: the K and V tiles (chunk rows
// of hd T), then f32 qs [ROWS][hd], kn [hd], vn [hd], sc [ROWS][chunk],
// m / l / alpha [ROWS] and red [warps][ROWS][hd].
template <typename T, int ROWS>
__host__ __device__ __forceinline__ size_t ab_smem(int chunk, int hd) {
  return 2 * (size_t)chunk * hd * sizeof(T) +
         sizeof(float) * ((size_t)ROWS * hd + 2 * (size_t)hd + (size_t)ROWS * chunk +
                          3 * (size_t)ROWS + (size_t)kAbWarps * ROWS * hd);
}

// Phase B for (slot b, kv head j): rope, row write, attention over rows
// < p and the new row. Writes the rep output rows to att_f (f32) or, if
// att_f is null, to att_t (T).
template <typename T, int ROWS>
__device__ __forceinline__ void ab_attend(const AbArgs& a, int b, int j, float* att_f,
                                          T* att_t, unsigned char* smraw) {
  constexpr int EPL = 8, RG = kAbRG, ngrp = kAbThreads / RG;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hd = kAbHeadDim, chunk = a.chunk, rep = a.nh / a.nkv, half = hd / 2;
  const int p = min(max(a.pos[b], 0), a.S - 1);
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

  const T* qg = static_cast<const T*>(a.q) + (size_t)b * a.q_stride + (size_t)j * rep * hd;
  const T* kg = static_cast<const T*>(a.kn) + (size_t)b * a.kv_stride + (size_t)j * hd;
  const T* vg = static_cast<const T*>(a.vn) + (size_t)b * a.kv_stride + (size_t)j * hd;
  const float* cr = a.cosr + (size_t)b * half;
  const float* sr = a.sinr + (size_t)b * half;
  // RoPE in fp32: x * c2 + swap(x) * s2s with each product and the sum
  // rounded on their own (no FMA contraction), as the plain version computes
  for (int i = tid; i < (rep + 1) * half; i += kAbThreads) {
    const int r = i / half, k = i - r * half;
    const T* src = r < rep ? qg + (size_t)r * hd : kg;
    const float x0 = to_f(src[2 * k]), x1 = to_f(src[2 * k + 1]);
    const float c = cr[k], s = sr[k];
    float* dst = r < rep ? qs + r * hd : kn;
    dst[2 * k] = __fadd_rn(__fmul_rn(x0, c), __fmul_rn(x1, -s));
    dst[2 * k + 1] = __fadd_rn(__fmul_rn(x1, c), __fmul_rn(x0, s));
  }
  for (int d = tid; d < hd; d += kAbThreads) vn[d] = to_f(vg[d]);
  __syncthreads();

  // row p of this stripe: the roped k row in the cache dtype, the v row as
  // given (rows < p are all this CTA reads, so the write races nothing)
  const size_t stripe = ((size_t)b * a.nkv + j) * a.S;
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  for (int d = tid; d < hd; d += kAbThreads) {
    kc[(stripe + p) * hd + d] = from_f<T>(kn[d]);
    vc[(stripe + p) * hd + d] = vg[d];
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
    const size_t oi = (size_t)b * a.nh * hd + (size_t)j * rep * hd + i;
    const float o = v / lrow[r];
    if (att_f) att_f[oi] = o;
    else att_t[oi] = from_f<T>(o);
  }
  __syncthreads();  // smem is reused by this CTA's next item
}

// Light form: grid (nkv, B), one (slot, kv head) a CTA.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kAbThreads) attn_rope_write_kernel(const AbArgs a) {
  extern __shared__ __align__(16) unsigned char smraw[];
  ab_attend<T, ROWS>(a, blockIdx.y, blockIdx.x, nullptr, static_cast<T*>(a.att), smraw);
}

// Grid-wide barrier of a cooperative (co-resident) grid: CTA arrivals
// counted in *count; thread 0 spins with acquire loads until all arrived.
__device__ __forceinline__ void grid_barrier(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
      if (seen < gridDim.x) __nanosleep(32);
    } while (seen < gridDim.x);
    __threadfence();
  }
  __syncthreads();
}

// Full form: a persistent cooperative grid; phase B items, the barrier,
// then phase C's GEMV items (qmv_tile, MT rows of att a tile).
template <typename T, int ROWS, int MT, int BITS>
__global__ void __launch_bounds__(kAbThreads) attn_block_kernel(const AbArgs a) {
  extern __shared__ __align__(16) unsigned char smraw[];
  float* att = static_cast<float*>(a.att);
  const int items_b = a.B * a.nkv;
  for (int it = blockIdx.x; it < items_b; it += gridDim.x)
    ab_attend<T, ROWS>(a, it / a.nkv, it % a.nkv, att, nullptr, smraw);

  const int ntn = (a.N + kQmvCols - 1) / kQmvCols, ntm = (a.B + MT - 1) / MT;
  unsigned* bar = a.tickets + ntn * ntm;  // [0] arrivals, [1] departures
  grid_barrier(bar);

  const int D = a.nh * kAbHeadDim;
  const int items_c = ntn * a.ks * ntm;
  for (int it = blockIdx.x; it < items_c; it += gridDim.x) {
    const int tn = it % ntn, rest = it / ntn;
    qmv_tile<float, T, MT, BITS>(att, a.woq, a.wos, static_cast<T*>(a.out), a.part, a.tickets,
                                 a.B, D, a.N, a.gs, a.bps, tn, rest % a.ks, rest / a.ks, a.ks,
                                 ntn, reinterpret_cast<float*>(smraw));
  }
  // the last CTA out (all have passed the barrier) resets both counters
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
    bar[0] = 0u;
    bar[1] = 0u;
    __threadfence();
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int ROWS>
cudaError_t launch_light(const AbArgs& a, cudaStream_t st) {
  const size_t smem = ab_smem<T, ROWS>(a.chunk, kAbHeadDim);
  auto kern = attn_rope_write_kernel<T, ROWS>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.nkv, a.B), kAbThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// occ non-null: launch nothing; occ[0] resident CTAs per SM, occ[1]
// registers per thread, occ[2] dynamic shared bytes, occ[3] the grid.
template <typename T, int ROWS, int MT, int BITS>
cudaError_t launch_full(AbArgs a, cudaStream_t st, int* occ) {
  const size_t sb = ab_smem<T, ROWS>(a.chunk, kAbHeadDim);
  const size_t sc = sizeof(float) * qmv_smem_floats<BITS>(MT, a.bps, a.gs);
  const size_t smem = sb > sc ? sb : sc;
  auto kern = attn_block_kernel<T, ROWS, MT, BITS>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kAbThreads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int ntn = (a.N + kQmvCols - 1) / kQmvCols, ntm = (a.B + MT - 1) / MT;
  const int items = max(a.B * a.nkv, ntn * a.ks * ntm);
  const int grid = min(per_sm * sms, items);
  if (occ) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kern);
    occ[0] = per_sm;
    occ[1] = fa.numRegs;
    occ[2] = (int)smem;
    occ[3] = grid;
    return e;
  }
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kAbThreads), args, smem,
                                  st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_light(const AbArgs& a, cudaStream_t st) {
  const int rep = a.nh / a.nkv;
  if (rep == 1) return launch_light<T, 1>(a, st);
  if (rep <= 8) return launch_light<T, 8>(a, st);
  return cudaErrorInvalidValue;
}

template <typename T, int ROWS>
cudaError_t dispatch_full_rows(int bits, const AbArgs& a, cudaStream_t st, int* occ) {
  if (bits == 8)
    return a.B <= 1 ? launch_full<T, ROWS, 1, 8>(a, st, occ) : launch_full<T, ROWS, 8, 8>(a, st, occ);
  if (bits == 4)
    return a.B <= 1 ? launch_full<T, ROWS, 1, 4>(a, st, occ) : launch_full<T, ROWS, 8, 4>(a, st, occ);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_full(int bits, const AbArgs& a, cudaStream_t st, int* occ) {
  const int rep = a.nh / a.nkv;
  if (rep == 1) return dispatch_full_rows<T, 1>(bits, a, st, occ);
  if (rep <= 8) return dispatch_full_rows<T, 8>(bits, a, st, occ);
  return cudaErrorInvalidValue;
}

inline bool ab_shape_ok(const AbArgs& a) {
  return a.hd == kAbHeadDim && a.nkv > 0 && a.nh % a.nkv == 0 && a.S > 0 && a.chunk > 0 &&
         a.B > 0;
}

}  // namespace rama

// K14, light: q (B, nh, hd) rows at q + b * q_stride, k_new / v_new rows at
// kn / vn + b * kv_stride (B, nkv, hd), all of q's dtype; cos / sin (B, hd/2)
// f32; kc / vc layer l of the (L, B, nkv, S, hd) cache of q's dtype (16-byte
// aligned); pos (B,) int32; att (B, nh * hd) of q's dtype. hd must be 128.
extern "C" int rama_attn_rope_write(const void* q, const void* kn, const void* vn,
                                    const void* cosr, const void* sinr, void* kc, void* vc,
                                    const void* pos, void* att, int B, int nh, int nkv, int S,
                                    int hd, int chunk, int q_stride, int kv_stride, int dtype,
                                    void* stream) {
  rama::AbArgs a{};
  a.q = q; a.kn = kn; a.vn = vn;
  a.cosr = static_cast<const float*>(cosr);
  a.sinr = static_cast<const float*>(sinr);
  a.kc = kc; a.vc = vc;
  a.pos = static_cast<const int*>(pos);
  a.att = att;
  a.B = B; a.nh = nh; a.nkv = nkv; a.S = S; a.hd = hd; a.chunk = chunk;
  a.q_stride = q_stride; a.kv_stride = kv_stride;
  a.scale = 1.f / sqrtf(static_cast<float>(hd));
  if (!rama::ab_shape_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rama::kBF16) return static_cast<int>(rama::dispatch_light<__nv_bfloat16>(a, st));
  if (dtype == rama::kF32) return static_cast<int>(rama::dispatch_light<float>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K14, full: the light form's operands with att a (B, nh * hd) f32 scratch,
// then out (B, N) of q's dtype = att @ dequant(wo[l]): woq / wos point at
// layer l of the (L, D, N) int8 or (L, D/2, N) packed int4 weight and its
// (L, D/gs, N) f32 scales, D = nh * hd; `ks` K splits of `bps` K blocks
// (scale groups for int8, packing blocks for int4) with part (ks, B, N) f32
// when ks > 1; tickets: zeroed uint32 counters, ceil(N / 512) * ceil(B / MT)
// + 2 of them (MT = 1 for B = 1, else 8), left zeroed. occ non-null: launch
// nothing, report {CTAs per SM, registers, shared bytes, grid}.
extern "C" int rama_attn_block(const void* q, const void* kn, const void* vn, const void* cosr,
                               const void* sinr, void* kc, void* vc, const void* pos, void* att,
                               const void* woq, const void* wos, void* out, void* part,
                               void* tickets, int B, int nh, int nkv, int S, int hd, int chunk,
                               int q_stride, int kv_stride, int N, int gs, int ks, int bps,
                               int bits, int dtype, void* stream, int* occ) {
  rama::AbArgs a{};
  a.q = q; a.kn = kn; a.vn = vn;
  a.cosr = static_cast<const float*>(cosr);
  a.sinr = static_cast<const float*>(sinr);
  a.kc = kc; a.vc = vc;
  a.pos = static_cast<const int*>(pos);
  a.att = att;
  a.woq = static_cast<const int8_t*>(woq);
  a.wos = static_cast<const float*>(wos);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<unsigned*>(tickets);
  a.B = B; a.nh = nh; a.nkv = nkv; a.S = S; a.hd = hd; a.chunk = chunk;
  a.q_stride = q_stride; a.kv_stride = kv_stride;
  a.N = N; a.gs = gs; a.ks = ks; a.bps = bps;
  a.scale = 1.f / sqrtf(static_cast<float>(hd));
  if (!rama::ab_shape_ok(a) || N <= 0 || gs <= 0 || ks <= 0 || bps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rama::kBF16)
    return static_cast<int>(rama::dispatch_full<__nv_bfloat16>(bits, a, st, occ));
  if (dtype == rama::kF32) return static_cast<int>(rama::dispatch_full<float>(bits, a, st, occ));
  return static_cast<int>(cudaErrorInvalidValue);
}
