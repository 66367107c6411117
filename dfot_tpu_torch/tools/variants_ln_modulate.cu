// The rejected design of kernel B9's width-exact backward, for
// kernel_variants.py: one shuffle round of four sums instead of two rounds of
// two. With Sx = sum x, Sg = sum gl and Sgx = sum gl * x, the second mean is
// mean(gl * yn) = rstd * (Sgx / C - mu * Sg / C), so the four sums can be
// reduced together; that moves where the rounding falls (Sgx and mu * Sg
// cancel where |mu| is large against the spread of x). Built on the
// committed source, so both kernels share every helper.

#include "../csrc/ln_modulate.cu"

namespace {

template <int C, int L>
__global__ void __launch_bounds__(kThreads, bwd_min_blocks(C / (8 * L)))
    ln_modulate_bwd_one_round_kernel(const __nv_bfloat16* __restrict__ x,
                                     const __nv_bfloat16* __restrict__ scale,
                                     const __nv_bfloat16* __restrict__ g,
                                     __nv_bfloat16* __restrict__ dx,
                                     __nv_bfloat16* __restrict__ dscale, long long tokens,
                                     float eps) {
  constexpr int kVec = C / (8 * L);
  const long long tok = static_cast<long long>(blockIdx.x) * (kThreads / L) + threadIdx.x / L;
  const bool live = tok < tokens;
  const int lane = threadIdx.x % L;
  const long long at = (live ? tok : tokens - 1) * (C / 8) + lane;
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

  float s = 0.f, ss = 0.f, sg = 0.f, sgx = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float f[8], sc[8], gf[8];
    unpack8(xr[i], f);
    unpack8(glr[i], sc);
    unpack8(gr[i], gf);
    __nv_bfloat162* glh = reinterpret_cast<__nv_bfloat162*>(&glr[i]);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float2 one = rnd2(1.f + sc[j], 1.f + sc[j + 1]);
      glh[j / 2] = __floats2bfloat162_rn(gf[j] * one.x, gf[j + 1] * one.y);
      const float2 gl = __bfloat1622float2(glh[j / 2]);
      s += f[j] + f[j + 1];
      ss += f[j] * f[j] + f[j + 1] * f[j + 1];
      sg += gl.x + gl.y;
      sgx += gl.x * f[j] + gl.y * f[j + 1];
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
    sg += __shfl_xor_sync(0xffffffffu, sg, off);
    sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
  }
  const float mu = s / C;
  const float rstd = rsqrtf(ss / C - mu * mu + eps);
  const float m1 = sg / C;
  const float m2 = rstd * (sgx / C - mu * m1);
  if (!live) return;
  fence_rows(xr);
  fence_rows(glr);
  fence_rows(gr);
  uint4* dxv = reinterpret_cast<uint4*>(dx) + at;
  uint4* dsv = reinterpret_cast<uint4*>(dscale) + at;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float f[8], gl[8], gf[8];
    unpack8(xr[i], f);
    unpack8(glr[i], gl);
    unpack8(gr[i], gf);
    uint4 o_dx, o_ds;
    __nv_bfloat162* pdx = reinterpret_cast<__nv_bfloat162*>(&o_dx);
    __nv_bfloat162* pds = reinterpret_cast<__nv_bfloat162*>(&o_ds);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float y0 = (f[j] - mu) * rstd, y1 = (f[j + 1] - mu) * rstd;
      const float2 yn = rnd2(y0, y1);
      pds[j / 2] = __floats2bfloat162_rn(gf[j] * yn.x, gf[j + 1] * yn.y);
      pdx[j / 2] = __floats2bfloat162_rn(rstd * (gl[j] - m1 - y0 * m2),
                                         rstd * (gl[j + 1] - m1 - y1 * m2));
    }
    dsv[i * L] = o_ds;
    dxv[i * L] = o_dx;
  }
}

template <int C>
int launch_one_round(const void* x, const void* scale, const void* g, void* dx, void* dscale,
                     long long tokens, float eps, long long grid, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  ln_modulate_bwd_one_round_kernel<C, exact_lanes(C)>
      <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
          static_cast<const bf*>(x), static_cast<const bf*>(scale), static_cast<const bf*>(g),
          static_cast<bf*>(dx), static_cast<bf*>(dscale), tokens, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// as dfot_ln_modulate_bwd, bf16 at the DiT path widths only
extern "C" int variant_ln_modulate_bwd_one_round(const void* x, const void* scale, const void* g,
                                                 void* dx, void* dscale, long long tokens, int c,
                                                 float eps, int lanes, int block_tokens,
                                                 long long grid, void* stream) {
  if (not_my_plan(tokens, c, 0, lanes, block_tokens, grid)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 384: return launch_one_round<384>(x, scale, g, dx, dscale, tokens, eps, grid, s);
    case 768: return launch_one_round<768>(x, scale, g, dx, dscale, tokens, eps, grid, s);
    case 1152: return launch_one_round<1152>(x, scale, g, dx, dscale, tokens, eps, grid, s);
    default: return cudaErrorInvalidValue;
  }
}
