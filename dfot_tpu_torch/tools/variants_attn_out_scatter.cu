// The rejected design of kernel B7, for kernel_variants.py: the same blocks
// and plan, but the threads walk the block's output slots in head order,
// (head, token, vector of DP), so a warp writes one head's rows in a single
// contiguous run and reads D-lane slices of token rows H * D lanes apart.
// Built on the committed source, so both kernels share the plan.

#include "../csrc/attn_out_scatter.cu"

namespace {

__global__ void __launch_bounds__(kThreads)
    attn_out_scatter_head_major_kernel(const uint4* __restrict__ g, uint4* __restrict__ d_o,
                                       int heads, int n, int d8, int dp8, int tile) {
  const int t0 = blockIdx.x * tile, b = blockIdx.y;
  const int rows = min(tile, n - t0);
  const int run = rows * dp8;  // output slots of one head in this block
  const int total = heads * run;
  const long long head_stride = static_cast<long long>(n) * dp8;
  const uint4* src = g + (static_cast<long long>(b) * n + t0) * heads * d8;
  uint4* dst = d_o + static_cast<long long>(b) * heads * head_stride +
               static_cast<long long>(t0) * dp8;
  int h = threadIdx.x / run, t = threadIdx.x % run / dp8, p = threadIdx.x % run % dp8;
  const int step_h = kThreads / run, step_t = kThreads % run / dp8, step_p = kThreads % run % dp8;
  for (int i = threadIdx.x; i < total; i += kThreads * kVecPerThread) {
    int from[kVecPerThread];
    long long to[kVecPerThread];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      from[u] = p < d8 ? (t * heads + h) * d8 + p : -1;
      to[u] = h * head_stride + t * dp8 + p;
      h += step_h;
      t += step_t;
      p += step_p;
      if (p >= dp8) p -= dp8, ++t;
      if (t >= rows) t -= rows, ++h;
    }
    uint4 v[kVecPerThread];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u)
      v[u] = i + u * kThreads < total && from[u] >= 0 ? __ldg(src + from[u])
                                                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u)
      if (i + u * kThreads < total) dst[to[u]] = v[u];
  }
}

}  // namespace

// as dfot_attn_out_scatter, on the plan that entry checks
extern "C" int variant_attn_out_scatter_head_major(const void* g, void* d_o, int batch, int heads,
                                                   int n, int d, int dp, int tile, int grid_x,
                                                   void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || dp % 8 != 0 || dp < d)
    return cudaErrorInvalidValue;
  attn_out_scatter_head_major_kernel<<<dim3(grid_x, batch), kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(g), static_cast<uint4*>(d_o), heads, n, d / 8, dp / 8, tile);
  return static_cast<int>(cudaGetLastError());
}
