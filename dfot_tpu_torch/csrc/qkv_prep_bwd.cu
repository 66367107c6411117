// Backward of the fused qkv preparation for Hopper: head-major cotangents ->
// packed dqkv and the RoPE tables' cotangents.
//
// Replaces the Pallas TPU kernel dfot_tpu/ops/qkv_prep.py:_bwd_kernel (reached
// through _qkv_prep_bwd). Same function, the VJP of qkv_prep.cu: with
// u = bf16(x / rms(x)) (or u = x without the norm) and
// y = u * cos + swap_pairs(u) * sin the forward result,
//
//   du   = dy * cos + swap_pairs(dy * sin)
//   dx   = r * du - x * r^3 * mean(du * x)        r = 1 / rms(x), all in fp32
//   dcos = sum_{batch, heads} u * dy              dsin = sum swap_pairs(u) * dy
//
// for the q and k streams, and dv copied through; dqkv is written in the
// packed (B, N, 3*H*D) layout with the caller's row strides, the table
// cotangents as (N, D) fp32.
//
// Bound: data movement (per token read 3HD packed values and 3H*DP cotangents,
// write 3HD), about two flops per byte. The table cotangents are sums over
// batch AND heads; the TPU kernel carries them across its sequential batch
// grid axis, which has no counterpart here. One warp therefore owns one
// (token, stream) and loops over batch and heads itself, keeping the two
// sums in registers: no atomics, a fixed summation order, one table store per
// warp. As in the forward, lane l owns the adjacent pairs l, l + 32, ..., so
// both pair swaps are swaps of the lane's own registers and each row's two
// means are warp reductions. u is recomputed with the forward's rounding, so
// the table cotangents multiply the same u the forward did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPairsPerLane = 4;  // D <= 256

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    qkv_prep_bwd_kernel(const __nv_bfloat16* __restrict__ qkv, long long stride_b,
                        long long stride_n, const __nv_bfloat16* __restrict__ cq,
                        const __nv_bfloat16* __restrict__ sq, const __nv_bfloat16* __restrict__ ck,
                        const __nv_bfloat16* __restrict__ sk, const __nv_bfloat16* __restrict__ dq,
                        const __nv_bfloat16* __restrict__ dk, const __nv_bfloat16* __restrict__ dv,
                        __nv_bfloat16* __restrict__ dqkv, long long out_stride_b,
                        long long out_stride_n, float* __restrict__ dcq, float* __restrict__ dsq,
                        float* __restrict__ dck, float* __restrict__ dsk, int batch, int n,
                        int heads, int d, int dp, int norm, float eps) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= 3LL * n) return;
  const int s = static_cast<int>(row % 3);  // stream: q, k, v
  const int t = static_cast<int>(row / 3);  // token
  const int pairs = d / 2;

  if (s == 2) {
    for (int b = 0; b < batch; ++b)
      for (int h = 0; h < heads; ++h) {
        const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(
            dv + ((static_cast<long long>(b) * heads + h) * n + t) * dp);
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
            dqkv + b * out_stride_b + t * out_stride_n +
            static_cast<long long>(2 * heads + h) * d);
        for (int p = lane; p < pairs; p += 32) o[p] = g[p];
      }
    return;
  }

  const __nv_bfloat162* cos2 =
      reinterpret_cast<const __nv_bfloat162*>((s == 0 ? cq : ck) + static_cast<long long>(t) * d);
  const __nv_bfloat162* sin2 =
      reinterpret_cast<const __nv_bfloat162*>((s == 0 ? sq : sk) + static_cast<long long>(t) * d);
  const __nv_bfloat16* dy_all = s == 0 ? dq : dk;
  float2 cs[kMaxPairsPerLane], sn[kMaxPairsPerLane], dc[kMaxPairsPerLane], ds[kMaxPairsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPairsPerLane; ++i) {
    const int p = lane + 32 * i;
    cs[i] = p < pairs ? __bfloat1622float2(cos2[p]) : make_float2(0.f, 0.f);
    sn[i] = p < pairs ? __bfloat1622float2(sin2[p]) : make_float2(0.f, 0.f);
    dc[i] = ds[i] = make_float2(0.f, 0.f);
  }

  for (int b = 0; b < batch; ++b)
    for (int h = 0; h < heads; ++h) {
      const long long col = static_cast<long long>(s * heads + h) * d;
      const __nv_bfloat162* x2 =
          reinterpret_cast<const __nv_bfloat162*>(qkv + b * stride_b + t * stride_n + col);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(
          dy_all + ((static_cast<long long>(b) * heads + h) * n + t) * dp);
      __nv_bfloat162* o2 =
          reinterpret_cast<__nv_bfloat162*>(dqkv + b * out_stride_b + t * out_stride_n + col);

      float2 xv[kMaxPairsPerLane], du[kMaxPairsPerLane], dy[kMaxPairsPerLane];
      float ss = 0.f, gx = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPairsPerLane; ++i) {
        const int p = lane + 32 * i;
        xv[i] = p < pairs ? __bfloat1622float2(x2[p]) : make_float2(0.f, 0.f);
        dy[i] = p < pairs ? __bfloat1622float2(g2[p]) : make_float2(0.f, 0.f);
        // y0 = u0 c0 + u1 s0, y1 = u1 c1 + u0 s1  =>  du0 = dy0 c0 + dy1 s1, ...
        du[i].x = dy[i].x * cs[i].x + dy[i].y * sn[i].y;
        du[i].y = dy[i].y * cs[i].y + dy[i].x * sn[i].x;
        ss += xv[i].x * xv[i].x + xv[i].y * xv[i].y;
        gx += du[i].x * xv[i].x + du[i].y * xv[i].y;
      }
      float r = 1.f, coef = 0.f;
      if (norm) {
        ss = warp_sum(ss);
        gx = warp_sum(gx);
        r = rsqrtf(ss / d + eps);
        coef = r * r * r * gx / d;
      }
#pragma unroll
      for (int i = 0; i < kMaxPairsPerLane; ++i) {
        const int p = lane + 32 * i;
        if (p < pairs) {
          o2[p] = norm ? __floats2bfloat162_rn(r * du[i].x - xv[i].x * coef,
                                               r * du[i].y - xv[i].y * coef)
                       : __floats2bfloat162_rn(du[i].x, du[i].y);
        }
        float2 u = xv[i];
        if (norm) u = __bfloat1622float2(__floats2bfloat162_rn(xv[i].x * r, xv[i].y * r));
        dc[i].x += u.x * dy[i].x;
        dc[i].y += u.y * dy[i].y;
        ds[i].x += u.y * dy[i].x;
        ds[i].y += u.x * dy[i].y;
      }
    }

  float2* dc_out = reinterpret_cast<float2*>((s == 0 ? dcq : dck) + static_cast<long long>(t) * d);
  float2* ds_out = reinterpret_cast<float2*>((s == 0 ? dsq : dsk) + static_cast<long long>(t) * d);
#pragma unroll
  for (int i = 0; i < kMaxPairsPerLane; ++i) {
    const int p = lane + 32 * i;
    if (p < pairs) {
      dc_out[p] = dc[i];
      ds_out[p] = ds[i];
    }
  }
}

}  // namespace

// qkv: (B, N, 3*H*D) bf16, unit stride in the last dim (batch and token
// strides in elements), as the forward read it; tables (N, D) bf16; dq, dk,
// dv: (B, H, N, DP) bf16 contiguous; dqkv: (B, N, 3*H*D) bf16 with its own
// batch and token strides; dcq, dsq, dck, dsk: (N, D) fp32 contiguous.
// D even and <= 256, DP even and >= D. Returns a cudaError_t code.
extern "C" int dfot_qkv_prep_bwd(const void* qkv, long long stride_b, long long stride_n,
                                 const void* cq, const void* sq, const void* ck, const void* sk,
                                 const void* dq, const void* dk, const void* dv, void* dqkv,
                                 long long out_stride_b, long long out_stride_n, void* dcq,
                                 void* dsq, void* dck, void* dsk, int batch, int n, int heads,
                                 int d, int dp, int norm, float eps, void* stream) {
  if (d <= 0 || d % 2 != 0 || d > 64 * kMaxPairsPerLane || dp < d || dp % 2 != 0)
    return cudaErrorInvalidValue;
  if (stride_b % 2 != 0 || stride_n % 2 != 0 || out_stride_b % 2 != 0 || out_stride_n % 2 != 0)
    return cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0) return cudaErrorInvalidValue;
  const long long rows = 3LL * n;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks <= 0 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  qkv_prep_bwd_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), stride_b, stride_n, static_cast<const bf16*>(cq),
      static_cast<const bf16*>(sq), static_cast<const bf16*>(ck), static_cast<const bf16*>(sk),
      static_cast<const bf16*>(dq), static_cast<const bf16*>(dk), static_cast<const bf16*>(dv),
      static_cast<bf16*>(dqkv), out_stride_b, out_stride_n, static_cast<float*>(dcq),
      static_cast<float*>(dsq), static_cast<float*>(dck), static_cast<float*>(dsk), batch, n,
      heads, d, dp, norm, eps);
  return static_cast<int>(cudaGetLastError());
}
