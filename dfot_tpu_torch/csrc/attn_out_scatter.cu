// Backward of the attention-output collect for Hopper:
// (B, N, H*D) merged-token cotangent -> (B, H, N, DP) head-major, zero pad lanes.
//
// Replaces the Pallas TPU kernel dfot_tpu/ops/qkv_prep.py:_scatter_kernel
// (reached through _collect_bwd), the VJP of attn_out_collect.cu: split the
// token rows back into heads and write zeros into the pad lanes D..DP.
//
// Bound: a pure copy (no arithmetic), so device-memory bandwidth is the only
// limit: the input read once, the output (pad lanes included) written once.
// The design is attn_out_collect.cu's transposed. A block owns `tile` whole
// token rows of one batch entry, its grid position (token tile, batch): its
// input is one contiguous run of tile x H x D lanes, and its output H
// contiguous runs of tile x DP lanes, one a head. The threads walk the
// block's output slots in token order, (token, head, vector of DP), in steps
// of kThreads 16-byte vectors, so a warp reads whole lines of the input run
// and writes whole DP-lane head rows; a pad slot (vector >= D / 8) is a store
// of zeros with no load (head order, writing each head's run in one piece,
// was 1-3 % slower on the card: dfot_tpu_torch/tools/kernel_variants.py). The
// 64-bit bases come from blockIdx, and no index is divided per vector:
// (token, head, vector) is carried forward by a precomputed step (two
// divisions a thread, at the start), and each thread issues kVecPerThread
// loads before its first store. The plan (tile, grid) is
// ops/qkv_prep.py:scatter_plan; the C entry computes it again and refuses any
// other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;    // 16-byte output slots in flight a thread
constexpr int kSmCount = 132;       // streaming multiprocessors of an H100 SXM
constexpr int kMinBlocksPerSm = 2;  // the tile halves until the grid gives each SM this many

__global__ void __launch_bounds__(kThreads)
    attn_out_scatter_kernel(const uint4* __restrict__ g, uint4* __restrict__ d_o, int heads,
                            int n, int d8, int dp8, int tile) {
  const int t0 = blockIdx.x * tile, b = blockIdx.y;
  const int row = heads * dp8;                // output slots of a token (all heads)
  const int total = min(tile, n - t0) * row;  // slots of this block
  const long long head_stride = static_cast<long long>(n) * dp8;
  const uint4* src = g + (static_cast<long long>(b) * n + t0) * heads * d8;
  uint4* dst = d_o + static_cast<long long>(b) * heads * head_stride +
               static_cast<long long>(t0) * dp8;
  // this thread's first (token, head, vector), and the step of kThreads slots
  int t = threadIdx.x / row, h = threadIdx.x % row / dp8, p = threadIdx.x % row % dp8;
  const int step_t = kThreads / row, step_h = kThreads % row / dp8, step_p = kThreads % row % dp8;
  for (int i = threadIdx.x; i < total; i += kThreads * kVecPerThread) {
    int from[kVecPerThread];  // input vector in the block's run, -1 for a pad slot
    long long to[kVecPerThread];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      from[u] = p < d8 ? (t * heads + h) * d8 + p : -1;
      to[u] = h * head_stride + t * dp8 + p;
      t += step_t;
      h += step_h;
      p += step_p;
      if (p >= dp8) p -= dp8, ++h;
      if (h >= heads) h -= heads, ++t;
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

// g: (B, N, H*D) bf16 contiguous; d_o: (B, H, N, DP) bf16 contiguous; both
// 16-byte aligned. D and DP multiples of 8, DP >= D. ``tile`` and ``grid_x``
// (token tiles): the plan of ops/qkv_prep.py:scatter_plan, refused unless it
// is this entry's own. Returns a cudaError_t code.
extern "C" int dfot_attn_out_scatter(const void* g, void* d_o, int batch, int heads, int n, int d,
                                     int dp, int tile, int grid_x, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || dp % 8 != 0 || dp < d ||
      batch > 65535)
    return cudaErrorInvalidValue;
  int my_tile = kThreads * kVecPerThread / (heads * (dp / 8));
  if (my_tile < 1) my_tile = 1;
  if (my_tile > n) my_tile = n;
  while (my_tile > 1 && static_cast<long long>((n + my_tile - 1) / my_tile) * batch <
                            kMinBlocksPerSm * kSmCount)
    my_tile /= 2;
  if (tile != my_tile || grid_x != (n + my_tile - 1) / my_tile) return cudaErrorInvalidValue;
  attn_out_scatter_kernel<<<dim3(grid_x, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(g), static_cast<uint4*>(d_o), heads, n, d / 8, dp / 8, tile);
  return static_cast<int>(cudaGetLastError());
}
