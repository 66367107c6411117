// Fused qkv preparation for Hopper: packed projection -> head-major q, k, v.
//
// Replaces the Pallas TPU kernel dfot_tpu/ops/qkv_prep.py:_prep_kernel
// (reached through _pallas_prep and qkv_prep). Same function, in one pass
// over device memory: read the packed (B, N, 3*H*D) qkv rows, apply the
// per-head fp32 1/rms(x) to q and k (cast back to bf16 before the rotation,
// as the TPU kernel does), rotate with RoPE as
// y = x * cos + swap_pairs(x) * sin_signed, where the tables already carry
// the learned RMSNorm scale (folded by the caller), and write q, k, v as
// (B, H, N, DP) with zero lanes D..DP.
//
// Bound: pure data movement (read 3HD, write 3H*DP bf16 per token; about one
// flop per byte), so the only lever is to touch each byte once. One warp owns
// one (token, stream, head) row; lane l owns the adjacent pairs l, l + 32, ...
// so the RoPE pair swap is a swap of the lane's own two registers (the TPU
// kernel's permutation matmul is not needed), the row's sum of squares is one
// warp reduction, and every load and store is a coalesced 4-byte-per-lane
// access of a contiguous row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPairsPerLane = 4;  // D <= 256

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    qkv_prep_kernel(const __nv_bfloat16* __restrict__ qkv, long long stride_b,
                    long long stride_n, const __nv_bfloat16* __restrict__ cq,
                    const __nv_bfloat16* __restrict__ sq, const __nv_bfloat16* __restrict__ ck,
                    const __nv_bfloat16* __restrict__ sk, __nv_bfloat16* __restrict__ qo,
                    __nv_bfloat16* __restrict__ ko, __nv_bfloat16* __restrict__ vo, int batch,
                    int n, int heads, int d, int dp, int norm, float eps) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(batch) * n * 3 * heads) return;
  // rows ordered (b, n, stream, head): consecutive warps read consecutive memory
  const int h = static_cast<int>(row % heads);
  const int s = static_cast<int>((row / heads) % 3);
  const int t = static_cast<int>((row / (3 * heads)) % n);
  const int b = static_cast<int>(row / (3LL * heads * n));

  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(
      qkv + b * stride_b + t * stride_n + static_cast<long long>(s * heads + h) * d);
  __nv_bfloat16* out = (s == 0 ? qo : s == 1 ? ko : vo) +
                       ((static_cast<long long>(b) * heads + h) * n + t) * dp;
  __nv_bfloat162* out2 = reinterpret_cast<__nv_bfloat162*>(out);
  const int pairs = d / 2;

  if (s == 2) {
    for (int p = lane; p < pairs; p += 32) out2[p] = x[p];
  } else {
    float2 xv[kMaxPairsPerLane];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPairsPerLane; ++i) {
      const int p = lane + 32 * i;
      xv[i] = p < pairs ? __bfloat1622float2(x[p]) : make_float2(0.f, 0.f);
      ss += xv[i].x * xv[i].x + xv[i].y * xv[i].y;
    }
    if (norm) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      const float r = rsqrtf(ss / d + eps);
#pragma unroll
      for (int i = 0; i < kMaxPairsPerLane; ++i)
        xv[i] = __bfloat1622float2(__floats2bfloat162_rn(xv[i].x * r, xv[i].y * r));
    }
    const __nv_bfloat162* cos2 =
        reinterpret_cast<const __nv_bfloat162*>((s == 0 ? cq : ck) + static_cast<long long>(t) * d);
    const __nv_bfloat162* sin2 =
        reinterpret_cast<const __nv_bfloat162*>((s == 0 ? sq : sk) + static_cast<long long>(t) * d);
#pragma unroll
    for (int i = 0; i < kMaxPairsPerLane; ++i) {
      const int p = lane + 32 * i;
      if (p < pairs) {
        const float2 cs = __bfloat1622float2(cos2[p]);
        const float2 sn = __bfloat1622float2(sin2[p]);
        out2[p] = __floats2bfloat162_rn(xv[i].x * cs.x + xv[i].y * sn.x,
                                        xv[i].y * cs.y + xv[i].x * sn.y);
      }
    }
  }
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  for (int p = pairs + lane; p < dp / 2; p += 32) out2[p] = zero;
}

}  // namespace

// qkv: (B, N, 3*H*D) bf16 with unit stride in the last dim (batch and token
// strides given in elements); tables (N, D) bf16 contiguous; outputs
// (B, H, N, DP) bf16 contiguous. D even and <= 256, DP even and >= D.
// Returns a cudaError_t code.
extern "C" int dfot_qkv_prep(const void* qkv, long long stride_b, long long stride_n,
                             const void* cq, const void* sq, const void* ck, const void* sk,
                             void* qo, void* ko, void* vo, int batch, int n, int heads, int d,
                             int dp, int norm, float eps, void* stream) {
  if (d <= 0 || d % 2 != 0 || d > 64 * kMaxPairsPerLane || dp < d || dp % 2 != 0)
    return cudaErrorInvalidValue;
  if (stride_b % 2 != 0 || stride_n % 2 != 0) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(batch) * n * 3 * heads;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks <= 0 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  qkv_prep_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), stride_b, stride_n,
      static_cast<const __nv_bfloat16*>(cq), static_cast<const __nv_bfloat16*>(sq),
      static_cast<const __nv_bfloat16*>(ck), static_cast<const __nv_bfloat16*>(sk),
      static_cast<__nv_bfloat16*>(qo), static_cast<__nv_bfloat16*>(ko),
      static_cast<__nv_bfloat16*>(vo), batch, n, heads, d, dp, norm, eps);
  return static_cast<int>(cudaGetLastError());
}
