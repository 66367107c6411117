// Attention-output collect for Hopper: (B, H, N, DP) -> (B, N, H*D).
//
// Replaces the Pallas TPU kernel dfot_tpu/ops/qkv_prep.py:_collect_kernel
// (reached through _collect_fwd and attn_out_collect): drop the pad lanes
// D..DP of every head and merge the heads into token rows, in one pass.
//
// Bound: a pure copy (no arithmetic), so device-memory bandwidth is the only
// limit: the D true lanes of every head row read once, the output written
// once. A block owns `tile` whole token rows of one batch entry, its grid
// position (token tile, batch): its output is one contiguous run of tile x H x
// D lanes, written in order in whole lines, and its input the same tokens'
// rows of the H heads, D of every DP lanes. The 64-bit bases come from
// blockIdx, and no index is divided per vector: the threads walk the run in
// steps of kThreads 16-byte vectors, carrying (token, head, vector) forward
// by a precomputed step (two divisions a thread, at the start), and each
// thread issues kVecPerThread loads before its first store. The plan (tile,
// grid) is ops/qkv_prep.py:collect_plan; the C entry computes it again and
// refuses any other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;    // 16-byte loads in flight a thread
constexpr int kSmCount = 132;       // streaming multiprocessors of an H100 SXM
constexpr int kMinBlocksPerSm = 2;  // the tile halves until the grid gives each SM this many

__global__ void __launch_bounds__(kThreads)
    attn_out_collect_kernel(const uint4* __restrict__ o, uint4* __restrict__ out, int heads,
                            int n, int d8, int dp8, int tile) {
  const int t0 = blockIdx.x * tile, b = blockIdx.y;
  const int row = heads * d8;                 // vectors of an output token row
  const int total = min(tile, n - t0) * row;  // vectors of this block's run
  const long long head_stride = static_cast<long long>(n) * dp8;
  const uint4* src = o + static_cast<long long>(b) * heads * head_stride +
                     static_cast<long long>(t0) * dp8;
  uint4* dst = out + (static_cast<long long>(b) * n + t0) * row;
  // this thread's first (token, head, vector), and the step of kThreads vectors
  int t = threadIdx.x / row, h = threadIdx.x % row / d8, p = threadIdx.x % row % d8;
  const int step_t = kThreads / row, step_h = kThreads % row / d8, step_p = kThreads % row % d8;
  for (int i = threadIdx.x; i < total; i += kThreads * kVecPerThread) {
    long long from[kVecPerThread];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      from[u] = h * head_stride + t * dp8 + p;
      t += step_t;
      h += step_h;
      p += step_p;
      if (p >= d8) p -= d8, ++h;
      if (h >= heads) h -= heads, ++t;
    }
    uint4 v[kVecPerThread];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u)
      if (i + u * kThreads < total) v[u] = __ldg(src + from[u]);
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u)
      if (i + u * kThreads < total) dst[i + u * kThreads] = v[u];
  }
}

}  // namespace

// o: (B, H, N, DP) bf16 contiguous; out: (B, N, H*D) bf16 contiguous; both
// 16-byte aligned. D and DP multiples of 8, DP >= D. ``tile`` and ``grid_x``
// (token tiles): the plan of ops/qkv_prep.py:collect_plan, refused unless it
// is this entry's own. Returns a cudaError_t code.
extern "C" int dfot_attn_out_collect(const void* o, void* out, int batch, int heads, int n,
                                     int d, int dp, int tile, int grid_x, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || dp % 8 != 0 || dp < d ||
      batch > 65535)
    return cudaErrorInvalidValue;
  int my_tile = kThreads * kVecPerThread / (heads * (d / 8));
  if (my_tile < 1) my_tile = 1;
  if (my_tile > n) my_tile = n;
  while (my_tile > 1 && static_cast<long long>((n + my_tile - 1) / my_tile) * batch <
                            kMinBlocksPerSm * kSmCount)
    my_tile /= 2;
  if (tile != my_tile || grid_x != (n + my_tile - 1) / my_tile) return cudaErrorInvalidValue;
  attn_out_collect_kernel<<<dim3(grid_x, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(o), static_cast<uint4*>(out), heads, n, d / 8, dp / 8, tile);
  return static_cast<int>(cudaGetLastError());
}
