// Attention-output collect for Hopper: (B, H, N, DP) -> (B, N, H*D).
//
// Replaces the Pallas TPU kernel dfot_tpu/ops/qkv_prep.py:_collect_kernel
// (reached through _collect_fwd and attn_out_collect): drop the pad lanes
// D..DP of every head and merge the heads into token rows, in one pass.
//
// Bound: a pure copy (no arithmetic), so device-memory bandwidth is the only
// limit. Each thread moves one 16-byte vector (8 bf16); threads are ordered
// by OUTPUT position, so stores are fully coalesced and each warp reads
// whole contiguous head rows of the input.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    attn_out_collect_kernel(const uint4* __restrict__ o, uint4* __restrict__ out, int batch,
                            int heads, int n, int d8, int dp8) {
  const long long total = static_cast<long long>(batch) * n * heads * d8;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int p = static_cast<int>(i % d8);
    const int h = static_cast<int>((i / d8) % heads);
    const int t = static_cast<int>((i / (static_cast<long long>(d8) * heads)) % n);
    const int b = static_cast<int>(i / (static_cast<long long>(d8) * heads * n));
    out[i] = o[((static_cast<long long>(b) * heads + h) * n + t) * dp8 + p];
  }
}

}  // namespace

// o: (B, H, N, DP) bf16 contiguous; out: (B, N, H*D) bf16 contiguous.
// D and DP multiples of 8, DP >= D. Returns a cudaError_t code.
extern "C" int dfot_attn_out_collect(const void* o, void* out, int batch, int heads, int n,
                                     int d, int dp, void* stream) {
  if (d <= 0 || d % 8 != 0 || dp % 8 != 0 || dp < d) return cudaErrorInvalidValue;
  const long long vectors = static_cast<long long>(batch) * n * heads * (d / 8);
  if (vectors <= 0) return cudaErrorInvalidValue;
  long long blocks = (vectors + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  attn_out_collect_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(o), static_cast<uint4*>(out), batch, heads, n, d / 8, dp / 8);
  return static_cast<int>(cudaGetLastError());
}
