// Fused LayerNorm + AdaLN modulate for Hopper, forward and backward.
//
// Replaces the Pallas TPU kernels dfot_tpu/ops/ln_modulate.py:_fwd_kernel
// (reached through _ln_mod_fwd and ln_modulate) and :_bwd_kernel (reached
// through _ln_mod_bwd). Per token, with a scale-free, bias-free LayerNorm over
// the C channels:
//
//   forward   mu, rstd from fp32 sums (var = E[x^2] - mu^2)
//             yn = cast((x - mu) * rstd)             (x's dtype)
//             y  = yn * (1 + scale) + shift          (x's dtype, op by op)
//   backward  stats recomputed from the saved x
//             gl = float(g * (1 + scale))
//             dx = rstd * (gl - mean(gl) - yn * mean(gl * yn))   (fp32 yn)
//             dscale = g * cast(yn)                  (dshift = g: not written)
//
// The rounding points are the TPU kernel's: statistics and dx in fp32, yn
// rounded to x's dtype before the modulate and before dscale.
//
// Bound: bytes. The forward moves four (tokens, C) tensors, the backward
// five, with a handful of flops per element, so the only lever is to touch
// every byte once and keep enough of them in flight.
//
// At the model widths (bf16, C in the list of launch_exact below) both
// directions take width-exact kernels: the width is a compile-time constant
// and a group of `lanes` lanes owns a token, `lanes` the largest power of two
// up to 32 that divides C / 8, so every lane holds exactly C / (8 lanes)
// 16-byte vectors of each row (1152: 16 lanes x 9, 768: 32 x 3, 384: 16 x 3).
// A lane issues the loads of its three input rows together (forward: x,
// shift, scale; backward: x, scale, g), keeps them as raw bf16 in registers,
// reduces over its group with shuffles and writes its outputs: one round trip
// to device memory per token. The backward reduces twice, (sum x, sum x^2)
// and then (sum gl, sum gl * yn), writing dscale in between (one round of
// four sums, taking mean(gl * yn) from sum gl * x, was no faster on the card
// and moves the rounding: dfot_tpu_torch/tools/kernel_variants.py); gl is a
// bf16 value, so it takes scale's raw registers, and yn is recomputed from x
// for dx rather than kept in fp32 rows. The plan (lanes, tokens a block,
// grid) is ops/ln_modulate.py:ln_modulate_plan (ln_modulate_bwd_plan for the
// backward, the same plan); the C entries compute it again and refuse any
// other. Every other shape and fp32 take the generic kernels: one warp per
// token, the row in registers up to C = 2048 when C is a multiple of the
// 16-byte vector, else a kernel that walks the row in pairs and reads x again
// from cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // threads of every block
constexpr int kWarpsPerBlock = 4;   // generic kernels: a warp a token
constexpr int kMaxRegWidth = 2048;  // widest row the register kernels hold
constexpr int kMaxLanes = 32;       // width-exact kernel: lanes of a token, at most

// round to T and back: arithmetic "in T" is fp32 arithmetic rounded per op
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// eight bf16 (one 16-byte vector) as floats
__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T> struct Io;

template <> struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;  // elements per 16-byte access
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    unpack8(*reinterpret_cast<const uint4*>(p), out);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <> struct Io<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x, out[1] = f.y, out[2] = f.z, out[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// y = yn * (1 + scale) + shift, each op rounded to T
template <typename T>
__device__ __forceinline__ float modulate(float yn, float shift, float scale) {
  return rnd<T>(rnd<T>(yn * rnd<T>(1.f + scale)) + shift);
}

// sum over the L lanes of a group (L a power of two; the groups of a warp
// are aligned runs of L lanes, so the butterfly stays inside each)
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- width-exact forward: bf16, C a compile-time constant ---------------------

// (a, b) rounded to bf16 by one paired conversion, as floats again
__device__ __forceinline__ float2 rnd2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// The token's x, shift and scale rows are loaded together (kVec vectors of
// each, raw), the statistics reduced over the group, y written: every lane
// of the block takes part in the shuffles, so the groups past the last token
// work on the last token's rows and store nothing.
template <int C, int L>
__global__ void __launch_bounds__(kThreads)
    ln_modulate_fwd_exact_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ shift,
                                 const __nv_bfloat16* __restrict__ scale,
                                 __nv_bfloat16* __restrict__ y, long long tokens, float eps) {
  constexpr int kVec = C / (8 * L);  // 16-byte vectors of a row a lane holds
  static_assert(kVec * 8 * L == C && (L & (L - 1)) == 0 && L <= kMaxLanes, "no exact plan");
  const long long tok = static_cast<long long>(blockIdx.x) * (kThreads / L) + threadIdx.x / L;
  const bool live = tok < tokens;
  const int lane = threadIdx.x % L;
  const long long at = (live ? tok : tokens - 1) * (C / 8) + lane;  // in vectors
  const uint4* xv = reinterpret_cast<const uint4*>(x) + at;
  const uint4* shv = reinterpret_cast<const uint4*>(shift) + at;
  const uint4* scv = reinterpret_cast<const uint4*>(scale) + at;
  uint4 xr[kVec], shr[kVec], scr[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) xr[i] = __ldg(xv + i * L);
#pragma unroll
  for (int i = 0; i < kVec; ++i) shr[i] = __ldg(shv + i * L);
#pragma unroll
  for (int i = 0; i < kVec; ++i) scr[i] = __ldg(scv + i * L);

  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float f[8];
    unpack8(xr[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s += f[j];
      ss += f[j] * f[j];
    }
  }
  const float mu = group_sum<L>(s) / C;
  const float rstd = rsqrtf(group_sum<L>(ss) / C - mu * mu + eps);
  if (!live) return;
  uint4* yv = reinterpret_cast<uint4*>(y) + at;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float f[8], sh[8], sc[8];
    unpack8(xr[i], f);
    unpack8(shr[i], sh);
    unpack8(scr[i], sc);
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      // modulate<bf16> on a pair: each op rounded to bf16, two at a time
      const float2 yn = rnd2((f[j] - mu) * rstd, (f[j + 1] - mu) * rstd);
      const float2 one = rnd2(1.f + sc[j], 1.f + sc[j + 1]);
      const float2 prod = rnd2(yn.x * one.x, yn.y * one.y);
      o[j / 2] = __floats2bfloat162_rn(prod.x + sh[j], prod.y + sh[j + 1]);
    }
    yv[i * L] = out;
  }
}

// Hide raw rows from common-subexpression elimination: the floats unpacked
// from them before this point are not reused after it, so they need not stay
// live across a reduction (without it ptxas kept them, two to three times the
// raw rows' registers). Emits no instruction.
template <int N>
__device__ __forceinline__ void fence_rows(uint4 (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(r[i].x), "+r"(r[i].y), "+r"(r[i].z), "+r"(r[i].w));
}

// Blocks an SM the width-exact backward is held to, for `vec` vectors a row
// a lane: three (168 registers a thread) where the three raw rows take at
// most half of those, else no bound (held to three, ptxas spilled at C =
// 1152 and 2048, 9 and 8 vectors).
constexpr int bwd_min_blocks(int vec) { return 3 * 4 * vec <= 84 ? 3 : 1; }

// The backward on the same plan: x, scale and g loaded together, the
// statistics reduced over the group, then dscale written while the two row
// means are summed, then dx. gl = g * (1 + scale) is rounded to bf16, so it
// replaces scale in its raw registers; yn is recomputed from x. Surplus groups
// past the last token work on the last token's rows and store nothing, as in
// the forward.
template <int C, int L>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks(C / (8 * L)))
    ln_modulate_bwd_exact_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ scale,
                                 const __nv_bfloat16* __restrict__ g,
                                 __nv_bfloat16* __restrict__ dx,
                                 __nv_bfloat16* __restrict__ dscale, long long tokens, float eps) {
  constexpr int kVec = C / (8 * L);
  static_assert(kVec * 8 * L == C && (L & (L - 1)) == 0 && L <= kMaxLanes, "no exact plan");
  const long long tok = static_cast<long long>(blockIdx.x) * (kThreads / L) + threadIdx.x / L;
  const bool live = tok < tokens;
  const int lane = threadIdx.x % L;
  const long long at = (live ? tok : tokens - 1) * (C / 8) + lane;  // in vectors
  const uint4* xv = reinterpret_cast<const uint4*>(x) + at;
  const uint4* scv = reinterpret_cast<const uint4*>(scale) + at;
  const uint4* gv = reinterpret_cast<const uint4*>(g) + at;
  uint4 xr[kVec], glr[kVec], gr[kVec];  // x; scale, then gl; g
#pragma unroll
  for (int i = 0; i < kVec; ++i) xr[i] = __ldg(xv + i * L);
#pragma unroll
  for (int i = 0; i < kVec; ++i) glr[i] = __ldg(scv + i * L);
#pragma unroll
  for (int i = 0; i < kVec; ++i) gr[i] = __ldg(gv + i * L);

  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float f[8];
    unpack8(xr[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s += f[j];
      ss += f[j] * f[j];
    }
  }
  const float mu = group_sum<L>(s) / C;
  const float rstd = rsqrtf(group_sum<L>(ss) / C - mu * mu + eps);
  fence_rows(xr);

  // gl = float(g * (1 + scale)), each op rounded to bf16; yn in fp32;
  // dscale = g * cast(yn), written here, so g is free before the last pass
  uint4* dsv = reinterpret_cast<uint4*>(dscale) + at;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float f[8], sc[8], gf[8];
    unpack8(xr[i], f);
    unpack8(glr[i], sc);
    unpack8(gr[i], gf);
    __nv_bfloat162* glh = reinterpret_cast<__nv_bfloat162*>(&glr[i]);
    uint4 o_ds;
    __nv_bfloat162* pds = reinterpret_cast<__nv_bfloat162*>(&o_ds);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float2 one = rnd2(1.f + sc[j], 1.f + sc[j + 1]);
      glh[j / 2] = __floats2bfloat162_rn(gf[j] * one.x, gf[j + 1] * one.y);
      const float2 gl = __bfloat1622float2(glh[j / 2]);
      const float y0 = (f[j] - mu) * rstd, y1 = (f[j + 1] - mu) * rstd;
      const float2 yn = rnd2(y0, y1);
      pds[j / 2] = __floats2bfloat162_rn(gf[j] * yn.x, gf[j + 1] * yn.y);
      s1 += gl.x + gl.y;
      s2 += gl.x * y0 + gl.y * y1;
    }
    if (live) dsv[i * L] = o_ds;
  }
  const float m1 = group_sum<L>(s1) / C;
  const float m2 = group_sum<L>(s2) / C;
  if (!live) return;
  fence_rows(xr);
  fence_rows(glr);
  uint4* dxv = reinterpret_cast<uint4*>(dx) + at;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float f[8], gl[8];
    unpack8(xr[i], f);
    unpack8(glr[i], gl);
    uint4 o_dx;
    __nv_bfloat162* pdx = reinterpret_cast<__nv_bfloat162*>(&o_dx);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float y0 = (f[j] - mu) * rstd, y1 = (f[j + 1] - mu) * rstd;
      pdx[j / 2] = __floats2bfloat162_rn(rstd * (gl[j] - m1 - y0 * m2),
                                         rstd * (gl[j + 1] - m1 - y1 * m2));
    }
    dxv[i * L] = o_dx;
  }
}

// ---- register kernels: C a multiple of the 16-byte vector, C <= 2048 -------

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ln_modulate_fwd_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                           const T* __restrict__ scale, T* __restrict__ y, long long tokens,
                           int c, float eps) {
  constexpr int V = Io<T>::kVec;
  constexpr int kMaxVec = kMaxRegWidth / (32 * V);  // vectors per lane
  const long long tok = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (tok >= tokens) return;
  const long long base = tok * c;
  const int nvec = c / V;

  float xv[kMaxVec][V];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      Io<T>::load(x + base + v * V, xv[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s += xv[i][j];
        ss += xv[i][j] * xv[i][j];
      }
    }
  }
  const float mu = warp_sum(s) / c;
  const float rstd = rsqrtf(warp_sum(ss) / c - mu * mu + eps);
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      float sh[V], sc[V], out[V];
      Io<T>::load(shift + base + v * V, sh);
      Io<T>::load(scale + base + v * V, sc);
#pragma unroll
      for (int j = 0; j < V; ++j)
        out[j] = modulate<T>(rnd<T>((xv[i][j] - mu) * rstd), sh[j], sc[j]);
      Io<T>::store(y + base + v * V, out);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ln_modulate_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                           const T* __restrict__ g, T* __restrict__ dx, T* __restrict__ dscale,
                           long long tokens, int c, float eps) {
  constexpr int V = Io<T>::kVec;
  constexpr int kMaxVec = kMaxRegWidth / (32 * V);
  const long long tok = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (tok >= tokens) return;
  const long long base = tok * c;
  const int nvec = c / V;

  float yn[kMaxVec][V];  // x, then (x - mu) * rstd in fp32
  float gl[kMaxVec][V];  // float(g * (1 + scale))
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      Io<T>::load(x + base + v * V, yn[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s += yn[i][j];
        ss += yn[i][j] * yn[i][j];
      }
    }
  }
  const float mu = warp_sum(s) / c;
  const float rstd = rsqrtf(warp_sum(ss) / c - mu * mu + eps);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      float gv[V], sc[V], ds[V];
      Io<T>::load(g + base + v * V, gv);
      Io<T>::load(scale + base + v * V, sc);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        yn[i][j] = (yn[i][j] - mu) * rstd;
        gl[i][j] = rnd<T>(gv[j] * rnd<T>(1.f + sc[j]));
        ds[j] = rnd<T>(gv[j] * rnd<T>(yn[i][j]));
        s1 += gl[i][j];
        s2 += gl[i][j] * yn[i][j];
      }
      Io<T>::store(dscale + base + v * V, ds);
    }
  }
  const float m1 = warp_sum(s1) / c;
  const float m2 = warp_sum(s2) / c;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      float out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = rstd * (gl[i][j] - m1 - yn[i][j] * m2);
      Io<T>::store(dx + base + v * V, out);
    }
  }
}

// ---- pair kernels: any even C ------------------------------------------------

template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ row, int c, int lane, float eps,
                                          float* mu, float* rstd) {
  float s = 0.f, ss = 0.f;
  for (int p = lane; p < c / 2; p += 32) {
    const float2 f = Io<T>::load2(row + 2 * p);
    s += f.x + f.y;
    ss += f.x * f.x + f.y * f.y;
  }
  *mu = warp_sum(s) / c;
  *rstd = rsqrtf(warp_sum(ss) / c - *mu * *mu + eps);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ln_modulate_fwd_pairs_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                                 const T* __restrict__ scale, T* __restrict__ y,
                                 long long tokens, int c, float eps) {
  const long long tok = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (tok >= tokens) return;
  const long long base = tok * c;
  float mu, rstd;
  row_stats(x + base, c, lane, eps, &mu, &rstd);
  for (int p = lane; p < c / 2; p += 32) {
    const long long at = base + 2 * p;
    const float2 xf = Io<T>::load2(x + at);
    const float2 sh = Io<T>::load2(shift + at);
    const float2 sc = Io<T>::load2(scale + at);
    Io<T>::store2(y + at, modulate<T>(rnd<T>((xf.x - mu) * rstd), sh.x, sc.x),
                  modulate<T>(rnd<T>((xf.y - mu) * rstd), sh.y, sc.y));
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ln_modulate_bwd_pairs_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                                 const T* __restrict__ g, T* __restrict__ dx,
                                 T* __restrict__ dscale, long long tokens, int c, float eps) {
  const long long tok = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (tok >= tokens) return;
  const long long base = tok * c;
  float mu, rstd;
  row_stats(x + base, c, lane, eps, &mu, &rstd);
  float s1 = 0.f, s2 = 0.f;
  for (int p = lane; p < c / 2; p += 32) {
    const long long at = base + 2 * p;
    const float2 xf = Io<T>::load2(x + at);
    const float2 gv = Io<T>::load2(g + at);
    const float2 sc = Io<T>::load2(scale + at);
    const float y0 = (xf.x - mu) * rstd, y1 = (xf.y - mu) * rstd;
    const float g0 = rnd<T>(gv.x * rnd<T>(1.f + sc.x)), g1 = rnd<T>(gv.y * rnd<T>(1.f + sc.y));
    Io<T>::store2(dscale + at, rnd<T>(gv.x * rnd<T>(y0)), rnd<T>(gv.y * rnd<T>(y1)));
    s1 += g0 + g1;
    s2 += g0 * y0 + g1 * y1;
  }
  const float m1 = warp_sum(s1) / c;
  const float m2 = warp_sum(s2) / c;
  for (int p = lane; p < c / 2; p += 32) {
    const long long at = base + 2 * p;
    const float2 xf = Io<T>::load2(x + at);
    const float2 gv = Io<T>::load2(g + at);
    const float2 sc = Io<T>::load2(scale + at);
    const float y0 = (xf.x - mu) * rstd, y1 = (xf.y - mu) * rstd;
    const float g0 = rnd<T>(gv.x * rnd<T>(1.f + sc.x)), g1 = rnd<T>(gv.y * rnd<T>(1.f + sc.y));
    Io<T>::store2(dx + at, rstd * (g0 - m1 - y0 * m2), rstd * (g1 - m1 - y1 * m2));
  }
}

// lanes of a token in the width-exact kernel: the largest power of two up to
// kMaxLanes that divides the row's C / 8 vectors
constexpr int exact_lanes(int c) {
  int lanes = 1;
  while (lanes < kMaxLanes && (c / 8) % (2 * lanes) == 0) lanes *= 2;
  return lanes;
}

// a width-exact launch: rows (x, shift, scale) -> y forward, (x, scale, g)
// -> (dx, dscale) backward
struct Rows {
  const void* in[3];
  void* out[2];
};

template <int C>
int launch_exact(bool backward, const Rows& r, long long tokens, float eps, long long grid,
                 cudaStream_t stream) {
  constexpr int L = exact_lanes(C);
  using bf = __nv_bfloat16;
  const bf *a = static_cast<const bf*>(r.in[0]), *b = static_cast<const bf*>(r.in[1]),
           *c = static_cast<const bf*>(r.in[2]);
  const unsigned blocks = static_cast<unsigned>(grid);
  if (backward)
    ln_modulate_bwd_exact_kernel<C, L><<<blocks, kThreads, 0, stream>>>(
        a, b, c, static_cast<bf*>(r.out[0]), static_cast<bf*>(r.out[1]), tokens, eps);
  else
    ln_modulate_fwd_exact_kernel<C, L><<<blocks, kThreads, 0, stream>>>(
        a, b, c, static_cast<bf*>(r.out[0]), tokens, eps);
  return static_cast<int>(cudaGetLastError());
}

// the widths with a width-exact instantiation (bf16): the DiT family's hidden
// sizes (S 384, B 768, ABL 896, L 1024, XL 1152) and 2048; 0 for any other
int exact_width(int c, int is_fp32) {
  switch (is_fp32 ? 0 : c) {
    case 384: case 768: case 896: case 1024: case 1152: case 2048: return c;
    default: return 0;
  }
}

int launch_exact_width(bool backward, const Rows& r, long long tokens, int c, float eps,
                       long long grid, cudaStream_t stream) {
  switch (c) {
    case 384: return launch_exact<384>(backward, r, tokens, eps, grid, stream);
    case 768: return launch_exact<768>(backward, r, tokens, eps, grid, stream);
    case 896: return launch_exact<896>(backward, r, tokens, eps, grid, stream);
    case 1024: return launch_exact<1024>(backward, r, tokens, eps, grid, stream);
    case 1152: return launch_exact<1152>(backward, r, tokens, eps, grid, stream);
    case 2048: return launch_exact<2048>(backward, r, tokens, eps, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_fwd(const void* x, const void* shift, const void* scale, void* y, long long tokens,
               int c, float eps, long long grid, cudaStream_t stream) {
  const bool regs = c % Io<T>::kVec == 0 && c <= kMaxRegWidth;
  auto* kernel = regs ? ln_modulate_fwd_kernel<T> : ln_modulate_fwd_pairs_kernel<T>;
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(shift), static_cast<const T*>(scale),
      static_cast<T*>(y), tokens, c, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx, void* dscale,
               long long tokens, int c, float eps, long long grid, cudaStream_t stream) {
  const bool regs = c % Io<T>::kVec == 0 && c <= kMaxRegWidth;
  auto* kernel = regs ? ln_modulate_bwd_kernel<T> : ln_modulate_bwd_pairs_kernel<T>;
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<T*>(dscale), tokens, c, eps);
  return static_cast<int>(cudaGetLastError());
}

// true unless (lanes, block_tokens, grid) is the plan of ops/ln_modulate.py:
// ln_modulate_plan for this shape (or the shape is one no kernel takes)
bool not_my_plan(long long tokens, int c, int is_fp32, int lanes, int block_tokens,
                 long long grid) {
  if (tokens <= 0 || c <= 0 || c % 2 != 0 ||
      (tokens + kWarpsPerBlock - 1) / kWarpsPerBlock > 2147483647LL)
    return true;
  const int my_lanes = exact_width(c, is_fp32) ? exact_lanes(c) : 32;
  const int my_block_tokens = kThreads / my_lanes;
  return lanes != my_lanes || block_tokens != my_block_tokens ||
         grid != (tokens + my_block_tokens - 1) / my_block_tokens;
}

}  // namespace

// x, shift, scale, y: (tokens, C) contiguous, all bf16 (is_fp32 = 0) or all
// fp32 (is_fp32 = 1), 16-byte aligned; C even. ``lanes`` (of a token),
// ``block_tokens`` and ``grid``: the plan of ops/ln_modulate.py:
// ln_modulate_plan, refused unless it is this entry's own. Returns a
// cudaError_t code.
extern "C" int dfot_ln_modulate_fwd(const void* x, const void* shift, const void* scale, void* y,
                                    long long tokens, int c, float eps, int is_fp32, int lanes,
                                    int block_tokens, long long grid, void* stream) {
  if (not_my_plan(tokens, c, is_fp32, lanes, block_tokens, grid)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (exact_width(c, is_fp32))
    return launch_exact_width(false, Rows{{x, shift, scale}, {y, nullptr}}, tokens, c, eps, grid,
                              s);
  return is_fp32 ? launch_fwd<float>(x, shift, scale, y, tokens, c, eps, grid, s)
                 : launch_fwd<__nv_bfloat16>(x, shift, scale, y, tokens, c, eps, grid, s);
}

// x, scale, g in; dx, dscale out: (tokens, C) contiguous of one dtype, as
// above, with the plan of ops/ln_modulate.py:ln_modulate_bwd_plan (the
// forward's), refused unless it is this entry's own. The cotangent of shift is
// g itself and is not written.
extern "C" int dfot_ln_modulate_bwd(const void* x, const void* scale, const void* g, void* dx,
                                    void* dscale, long long tokens, int c, float eps,
                                    int is_fp32, int lanes, int block_tokens, long long grid,
                                    void* stream) {
  if (not_my_plan(tokens, c, is_fp32, lanes, block_tokens, grid)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (exact_width(c, is_fp32))
    return launch_exact_width(true, Rows{{x, scale, g}, {dx, dscale}}, tokens, c, eps, grid, s);
  return is_fp32 ? launch_bwd<float>(x, scale, g, dx, dscale, tokens, c, eps, grid, s)
                 : launch_bwd<__nv_bfloat16>(x, scale, g, dx, dscale, tokens, c, eps, grid, s);
}
