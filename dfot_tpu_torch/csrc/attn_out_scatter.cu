// Backward of the attention-output collect for Hopper:
// (B, N, H*D) merged-token cotangent -> (B, H, N, DP) head-major, zero pad lanes.
//
// Replaces the Pallas TPU kernel dfot_tpu/ops/qkv_prep.py:_scatter_kernel
// (reached through _collect_bwd), the VJP of attn_out_collect.cu: split the
// token rows back into heads and write zeros into the pad lanes D..DP.
//
// Bound: a pure copy, so device-memory bandwidth is the only limit. Each
// thread moves one 16-byte vector (8 bf16); threads are ordered by OUTPUT
// position, so stores are fully coalesced and each warp reads whole
// contiguous head slices of the input rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    attn_out_scatter_kernel(const uint4* __restrict__ g, uint4* __restrict__ d_o, int batch,
                            int heads, int n, int d8, int dp8) {
  const long long total = static_cast<long long>(batch) * heads * n * dp8;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int p = static_cast<int>(i % dp8);
    const int t = static_cast<int>((i / dp8) % n);
    const int h = static_cast<int>((i / (static_cast<long long>(dp8) * n)) % heads);
    const int b = static_cast<int>(i / (static_cast<long long>(dp8) * n * heads));
    d_o[i] = p < d8 ? g[((static_cast<long long>(b) * n + t) * heads + h) * d8 + p]
                    : make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace

// g: (B, N, H*D) bf16 contiguous; d_o: (B, H, N, DP) bf16 contiguous.
// D and DP multiples of 8, DP >= D. Returns a cudaError_t code.
extern "C" int dfot_attn_out_scatter(const void* g, void* d_o, int batch, int heads, int n, int d,
                                     int dp, void* stream) {
  if (d <= 0 || d % 8 != 0 || dp % 8 != 0 || dp < d) return cudaErrorInvalidValue;
  const long long vectors = static_cast<long long>(batch) * heads * n * (dp / 8);
  if (vectors <= 0) return cudaErrorInvalidValue;
  long long blocks = (vectors + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  attn_out_scatter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(g), static_cast<uint4*>(d_o), batch, heads, n, d / 8, dp / 8);
  return static_cast<int>(cudaGetLastError());
}
