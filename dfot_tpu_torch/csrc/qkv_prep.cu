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
// flop per byte), so the design keeps many bytes in flight and touches each
// byte once:
// - one block owns kTokens consecutive tokens of one batch item and one
//   stream (q, k or v), and loops over the heads; the stream's cos and sin
//   rows of the tile come into shared memory once, by two bulk copies, and
//   serve every head;
// - each head's kTokens packed rows (row stride: the projection's token
//   stride, 7C for the flagship's fused qkv+MLP projection) come into a ring
//   of kStages shared-memory slots by bulk copies (cp.async.bulk, one a row,
//   issued by the lanes of warp 0) that complete on the slot's mbarrier, so
//   the loads of the next heads overlap the work on this one;
// - a group of G lanes (a power of two, G 16-byte chunks cover an output
//   row) owns one (token, head) row: each lane holds 8 adjacent lanes of x,
//   so the RoPE pair swap stays in its registers, and the sum of squares is
//   a shuffle reduction over the group;
// - a head's kTokens output rows are one contiguous run of (B, H, N, DP),
//   written with 16-byte stores, pad lanes included.
// A head dim or padded width that is no multiple of 8, or rows off a 16-byte
// boundary (no model of the repository has one), takes the same kernel with
// 4-byte chunks read straight from device memory (V = 2).
// Head dims above 256 (up to kMaxHeadDim) take a wide instantiation: a warp
// owns a row and each lane holds up to 5 chunks (the norm's sum of squares
// still a shuffle reduction over the whole row), and a block's tile is 16
// tokens with 3 head slots, so the tables and the ring stay within a block's
// shared memory (160 d bytes).

#include "hopper.cuh"

namespace {

using namespace dfot;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTokens = 32;   // tokens of a block's tile
constexpr int kStages = 4;    // head slots of the ring
constexpr int kWideTokens = 16;  // the same above a head dim of 256
constexpr int kWideStages = 3;
constexpr int kMaxHeadDim = 1280;  // 5 16-byte (or 20 4-byte) chunks a lane of a warp

// V bf16 lanes a lane moves at once: 8 (16 bytes) or 2 (4 bytes)
template <int V>
struct Chunk;
template <>
struct Chunk<8> { using T = uint4; };
template <>
struct Chunk<2> { using T = uint32_t; };

template <int V>
__device__ __forceinline__ void unpack(const bf16* p, float (&x)[V]) {
  const typename Chunk<V>::T raw = *reinterpret_cast<const typename Chunk<V>::T*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void pack_store(bf16* p, const float (&y)[V]) {
  typename Chunk<V>::T raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) h[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
  *reinterpret_cast<typename Chunk<V>::T*>(p) = raw;
}

// One (token, head) row by a group of G lanes: chunk lane_g + i G of the
// row's d / V chunks for each i < KMAX; every lane of the warp calls it (the
// norm's shuffles span the warp), ``valid`` false for a row past the tile.
template <int V, int KMAX>
__device__ __forceinline__ void prep_row(const bf16* x, const bf16* cs, const bf16* sn,
                                         bf16* out, bool valid, int lane_g, int G, int d,
                                         int dp, bool norm, bool rotate, float eps) {
  constexpr int kMax = KMAX;
  const int nc = d / V;
  float xv[kMax][V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    const int c = lane_g + i * G;
    if (valid && c < nc) {
      unpack<V>(x + c * V, xv[i]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) xv[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) ss += xv[i][e] * xv[i][e];
  }
  if (norm) {
    for (int off = G / 2; off > 0; off /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss / d + eps);
#pragma unroll
    for (int i = 0; i < kMax; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) xv[i][e] = __bfloat162float(__float2bfloat16(xv[i][e] * r));
  }
  if (!valid) return;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    const int c = lane_g + i * G;
    if (c >= nc) continue;
    if (rotate) {
      float cv[V], sv[V], y[V];
      unpack<V>(cs + c * V, cv);
      unpack<V>(sn + c * V, sv);
#pragma unroll
      for (int e = 0; e < V; e += 2) {
        y[e] = xv[i][e] * cv[e] + xv[i][e + 1] * sv[e];
        y[e + 1] = xv[i][e + 1] * cv[e + 1] + xv[i][e] * sv[e + 1];
      }
      pack_store<V>(out + c * V, y);
    } else {
      pack_store<V>(out + c * V, xv[i]);
    }
  }
  float zero[V];
#pragma unroll
  for (int e = 0; e < V; ++e) zero[e] = 0.f;
  for (int c = lane_g; c < dp / V; c += G)
    if (c >= nc) pack_store<V>(out + c * V, zero);
}

// grid: (token tiles of TOKENS, 3 streams, batch); KMAX chunks a lane, a
// ring of STAGES head slots
template <int V, int KMAX, int TOKENS, int STAGES>
__global__ void __launch_bounds__(kThreads)
    qkv_prep_kernel(const bf16* __restrict__ qkv, long long stride_b, long long stride_n,
                    const bf16* __restrict__ cq, const bf16* __restrict__ sq,
                    const bf16* __restrict__ ck, const bf16* __restrict__ sk,
                    bf16* __restrict__ qo, bf16* __restrict__ ko, bf16* __restrict__ vo, int n,
                    int heads, int d, int dp, int norm, float eps) {
  constexpr int kTokens = TOKENS, kStages = STAGES;
  const int t0 = blockIdx.x * kTokens;
  const int s = blockIdx.y;  // 0 q, 1 k, 2 v
  const int b = blockIdx.z;
  const int rows = min(kTokens, n - t0);
  const bool rotate = s < 2;
  const bool normed = rotate && norm;
  const bf16* cos_g = (s == 0 ? cq : ck) + static_cast<long long>(t0) * d;
  const bf16* sin_g = (s == 0 ? sq : sk) + static_cast<long long>(t0) * d;
  // row r of head h: src + r * stride_n + h * d
  const bf16* src = qkv + b * stride_b + t0 * stride_n + static_cast<long long>(s) * heads * d;
  // head h, row r: out_b + h * n * dp + r * dp
  bf16* out_b = (s == 0 ? qo : s == 1 ? ko : vo) +
                (static_cast<long long>(b) * heads * n + t0) * dp;
  const long long head_stride = static_cast<long long>(n) * dp;

  // G lanes a row: the smallest power of two that covers the output row's
  // chunks, at most a warp
  int G = 1;
  while (G < dp / V && G < 32) G *= 2;
  const int lane_g = threadIdx.x % G;
  const int rows_per_pass = kThreads / G;

  if constexpr (V == 8) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* tabs = reinterpret_cast<bf16*>(smem_raw);  // cos, sin: kTokens x d each
    bf16* ring = tabs + 2 * kTokens * d;             // kStages slots of kTokens x d
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kTokens * d);
    uint64_t* tab_full = full + kStages;
    const uint32_t row_bytes = d * 2;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
      for (int i = 0; i <= kStages; ++i) mbar_init(&full[i], 1);
      mbar_fence_init();
    }
    __syncthreads();
    // warp 0 issues every load: a bulk copy a row, a lane a row
    auto issue = [&](int h) {
      uint64_t* bar = &full[h % kStages];
      if (lane == 0) mbar_arrive_expect_tx(bar, rows * row_bytes);
      __syncwarp();
      bf16* slot = ring + (h % kStages) * kTokens * d;
      for (int r = lane; r < rows; r += 32)
        bulk_load(slot + r * d, src + r * stride_n + h * d, row_bytes, bar);
    };
    if (warp == 0) {
      if (rotate && lane == 0) {
        mbar_arrive_expect_tx(tab_full, 2 * rows * row_bytes);
        bulk_load(tabs, cos_g, rows * row_bytes, tab_full);
        bulk_load(tabs + kTokens * d, sin_g, rows * row_bytes, tab_full);
      }
      for (int h = 0; h < min(heads, kStages); ++h) issue(h);
    }
    if (rotate) mbar_wait(tab_full, 0);
    for (int h = 0; h < heads; ++h) {
      const bf16* slot = ring + (h % kStages) * kTokens * d;
      mbar_wait(&full[h % kStages], (h / kStages) & 1);
      bf16* out_h = out_b + h * head_stride;
      for (int r0 = 0; r0 < rows; r0 += rows_per_pass) {
        const int r = r0 + threadIdx.x / G;
        const bool valid = r < rows;
        const int rr = valid ? r : 0;
        prep_row<8, KMAX>(slot + rr * d, tabs + rr * d, tabs + (kTokens + rr) * d,
                          out_h + rr * dp, valid, lane_g, G, d, dp, normed, rotate, eps);
      }
      __syncthreads();  // every thread is done with the slot
      if (warp == 0 && h + kStages < heads) issue(h + kStages);
    }
  } else {
    for (int h = 0; h < heads; ++h) {
      bf16* out_h = out_b + h * head_stride;
      for (int r0 = 0; r0 < rows; r0 += rows_per_pass) {
        const int r = r0 + threadIdx.x / G;
        const bool valid = r < rows;
        const int rr = valid ? r : 0;
        prep_row<2, KMAX>(src + rr * stride_n + h * d, cos_g + rr * d, sin_g + rr * d,
                          out_h + rr * dp, valid, lane_g, G, d, dp, normed, rotate, eps);
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int V, int KMAX, int TOKENS, int STAGES>
cudaError_t launch(const bf16* x, long long stride_b, long long stride_n, const bf16* c_q,
                   const bf16* s_q, const bf16* c_k, const bf16* s_k, bf16* q, bf16* k, bf16* v,
                   int batch, int n, int heads, int d, int dp, int norm, float eps,
                   cudaStream_t s) {
  auto kernel = qkv_prep_kernel<V, KMAX, TOKENS, STAGES>;
  const dim3 grid((n + TOKENS - 1) / TOKENS, 3, batch);
  // the bulk-copy route's tables and ring; the 4-byte route reads device
  // memory directly
  const int smem = V == 8 ? (2 + STAGES) * TOKENS * d * 2 + 8 * (STAGES + 1) : 0;
  if (smem > 0) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
  }
  kernel<<<grid, kThreads, smem, s>>>(x, stride_b, stride_n, c_q, s_q, c_k, s_k, q, k, v, n,
                                      heads, d, dp, norm, eps);
  return cudaGetLastError();
}

}  // namespace

// qkv: (B, N, 3*H*D) bf16 with unit stride in the last dim (batch and token
// strides given in elements, even); tables (N, D) bf16 contiguous; outputs
// (B, H, N, DP) bf16 contiguous; every pointer 4-byte aligned. D even and
// <= kMaxHeadDim (1280), DP even and >= D. Returns a cudaError_t code.
extern "C" int dfot_qkv_prep(const void* qkv, long long stride_b, long long stride_n,
                             const void* cq, const void* sq, const void* ck, const void* sk,
                             void* qo, void* ko, void* vo, int batch, int n, int heads, int d,
                             int dp, int norm, float eps, void* stream) {
  if (d <= 0 || d % 2 != 0 || d > kMaxHeadDim || dp < d || dp % 2 != 0 || heads <= 0)
    return cudaErrorInvalidValue;
  if (stride_b % 2 != 0 || stride_n % 2 != 0) return cudaErrorInvalidValue;
  if (batch <= 0 || batch > 65535 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 8 == 0 && dp % 8 == 0 && (batch == 1 || stride_b % 8 == 0) &&
                   stride_n % 8 == 0 && aligned16(qkv) && aligned16(cq) && aligned16(sq) &&
                   aligned16(ck) && aligned16(sk) && aligned16(qo) && aligned16(ko) &&
                   aligned16(vo);
  const bf16 *x = static_cast<const bf16*>(qkv), *c_q = static_cast<const bf16*>(cq),
             *s_q = static_cast<const bf16*>(sq), *c_k = static_cast<const bf16*>(ck),
             *s_k = static_cast<const bf16*>(sk);
  bf16 *q = static_cast<bf16*>(qo), *k = static_cast<bf16*>(ko), *v = static_cast<bf16*>(vo);
  // d <= 256: with 16-byte chunks one per lane (G >= d / 8), else up to 4;
  // above, a warp a row with up to 5 (or 20) chunks a lane
  const bool wide = d > 256;
  if (vec && !wide)
    return launch<8, 1, kTokens, kStages>(x, stride_b, stride_n, c_q, s_q, c_k, s_k, q, k, v,
                                          batch, n, heads, d, dp, norm, eps, s);
  if (vec)
    return launch<8, 5, kWideTokens, kWideStages>(x, stride_b, stride_n, c_q, s_q, c_k, s_k, q, k,
                                                  v, batch, n, heads, d, dp, norm, eps, s);
  if (!wide)
    return launch<2, 4, kTokens, kStages>(x, stride_b, stride_n, c_q, s_q, c_k, s_k, q, k, v,
                                          batch, n, heads, d, dp, norm, eps, s);
  return launch<2, 20, kTokens, kStages>(x, stride_b, stride_n, c_q, s_q, c_k, s_k, q, k, v,
                                         batch, n, heads, d, dp, norm, eps, s);
}
