// Flash-attention backward for Hopper (sm_90a): bf16 operands, fp32 accumulation.
//
// Replaces the Pallas TPU kernels of dfot_tpu/ops/attention.py reached through
// _flash_backward: _flash_bwd_dq_kernel and its K/V-streaming twin
// _flash_bwd_dq_stream_kernel (one function; here K/V tiles always stream
// through shared memory, so one kernel covers both), and _flash_bwd_dkv_kernel.
// Same functions, with p = exp(q k^T * scale - lse) recomputed from the saved
// LSE and delta = rowsum(dO * O) given by the caller:
//
//   dq = scale * sum_k ds k      ds = p * (dO v^T - delta)
//   dk = scale * sum_q ds^T q    dv = sum_q p^T dO
//
// Bound: 6 N^2 d (dq) and 8 N^2 d (dk, dv) flops per (batch, head) against
// O(N d) bytes, so the tensor cores bound both. The design keeps every N x N
// quantity in registers, as the forward does: scores come out of mma.sync
// m16n8k16 as fp32 accumulators, p and ds are rounded to bf16 in place and
// re-packed as the A operand of the next product; only (64 x d) tiles pass
// through shared memory (row pitch d + 8, conflict-free ldmatrix). The dq
// kernel gives one block a 64-row query tile and loops over 64-key K/V tiles;
// the dk/dv kernel gives one block a 64-key tile, works on the transposed
// scores (keys as rows) and loops over query tiles, so each output element is
// summed by one thread in a fixed order: no atomics, deterministic results.
// At d = 128 the dk/dv kernel's two d-wide accumulators take 128 registers,
// so its query tiles are 32 rows there. The softmax scale is applied once, to
// the fp32 sums. wgmma, TMA and warp specialisation are left for later work.

#include "mma.cuh"

namespace {

using namespace dfot;

constexpr int kTile = 64;  // rows of the block's own tile and of K/V tiles

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ d_o,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int n, float sm_scale, int causal) {
  constexpr int kPitch = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kTile * kPitch;
  __nv_bfloat16* ks = dos + kTile * kPitch;
  __nv_bfloat16* vs = ks + kTile * kPitch;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(blockIdx.y) * n * D;
  const float a2 = sm_scale * kLog2e;

  load_tile<D>(qs, q + head + static_cast<size_t>(q0) * D, kTile);
  load_tile<D>(dos, d_o + head + static_cast<size_t>(q0) * D, kTile);

  // this thread's two query rows and their statistics
  const int row_g = q0 + warp * 16 + g;
  const float* lse_h = lse + static_cast<size_t>(blockIdx.y) * n;
  const float* delta_h = delta + static_cast<size_t>(blockIdx.y) * n;
  const float l2[2] = {lse_h[row_g] * kLog2e, lse_h[row_g + 8] * kLog2e};
  const float dl[2] = {delta_h[row_g], delta_h[row_g + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  const int n_tiles = causal ? (q0 + kTile) / kTile : n / kTile;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(ks, k + head + static_cast<size_t>(j) * kTile * D, kTile);
    load_tile<D>(vs, v + head + static_cast<size_t>(j) * kTile * D, kTile);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int t = 0; t < kTile / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    warp_gemm_abt<D, kTile / 8>(s, qs + warp * 16 * kPitch, ks, lane);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] * a2 - l2[0]);
      s[nt][1] = exp2f(s[nt][1] * a2 - l2[0]);
      s[nt][2] = exp2f(s[nt][2] * a2 - l2[1]);
      s[nt][3] = exp2f(s[nt][3] * a2 - l2[1]);
    }
    if (causal && j == n_tiles - 1) {  // the diagonal tile
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const int key = j * kTile + nt * 8 + 2 * c;
        if (key > row_g) s[nt][0] = 0.f;
        if (key + 1 > row_g) s[nt][1] = 0.f;
        if (key > row_g + 8) s[nt][2] = 0.f;
        if (key + 1 > row_g + 8) s[nt][3] = 0.f;
      }
    }

    float dp[kTile / 8][4];
#pragma unroll
    for (int t = 0; t < kTile / 8; ++t) dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
    warp_gemm_abt<D, kTile / 8>(dp, dos + warp * 16 * kPitch, vs, lane);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {  // ds = p * (dp - delta), in place
      dp[nt][0] = s[nt][0] * (dp[nt][0] - dl[0]);
      dp[nt][1] = s[nt][1] * (dp[nt][1] - dl[0]);
      dp[nt][2] = s[nt][2] * (dp[nt][2] - dl[1]);
      dp[nt][3] = s[nt][3] * (dp[nt][3] - dl[1]);
    }
    uint32_t dsa[kTile / 16][4];
    pack_fragments<kTile / 8>(dsa, dp);
    warp_gemm_pb<D, kTile / 16>(acc, dsa, ks, lane);
  }

  __nv_bfloat16* o0 = dq + head + static_cast<size_t>(row_g) * D;
  __nv_bfloat16* o1 = o0 + 8 * D;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int col = t * 8 + 2 * c;
    *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
        __floats2bfloat162_rn(acc[t][0] * sm_scale, acc[t][1] * sm_scale);
    *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
        __floats2bfloat162_rn(acc[t][2] * sm_scale, acc[t][3] * sm_scale);
  }
}

// BQ: query rows per streamed tile
template <int D, int BQ>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ d_o, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int n, float sm_scale, int causal) {
  constexpr int kPitch = D + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile * kPitch;
  __nv_bfloat16* qs = vs + kTile * kPitch;
  __nv_bfloat16* dos = qs + BQ * kPitch;
  float* l2s = reinterpret_cast<float*>(dos + BQ * kPitch);  // lse * log2(e)
  float* dls = l2s + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int k0 = blockIdx.x * kTile;
  const size_t head = static_cast<size_t>(blockIdx.y) * n * D;
  const float* lse_h = lse + static_cast<size_t>(blockIdx.y) * n;
  const float* delta_h = delta + static_cast<size_t>(blockIdx.y) * n;
  const float a2 = sm_scale * kLog2e;
  const int key_g = k0 + warp * 16 + g;  // this thread's keys: key_g, key_g + 8

  load_tile<D>(ks, k + head + static_cast<size_t>(k0) * D, kTile);
  load_tile<D>(vs, v + head + static_cast<size_t>(k0) * D, kTile);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    dk_acc[t][0] = dk_acc[t][1] = dk_acc[t][2] = dk_acc[t][3] = 0.f;
    dv_acc[t][0] = dv_acc[t][1] = dv_acc[t][2] = dv_acc[t][3] = 0.f;
  }

  // causal: queries before the block's first key see none of its keys
  for (int i = causal ? k0 / BQ : 0; i < n / BQ; ++i) {
    const int qs0 = i * BQ;
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<D>(qs, q + head + static_cast<size_t>(qs0) * D, BQ);
    load_tile<D>(dos, d_o + head + static_cast<size_t>(qs0) * D, BQ);
    if (threadIdx.x < BQ) {
      l2s[threadIdx.x] = lse_h[qs0 + threadIdx.x] * kLog2e;
      dls[threadIdx.x] = delta_h[qs0 + threadIdx.x];
    }
    __syncthreads();

    // transposed scores: rows are this warp's 16 keys, columns the BQ queries
    float s[BQ / 8][4];
#pragma unroll
    for (int t = 0; t < BQ / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    warp_gemm_abt<D, BQ / 8>(s, ks + warp * 16 * kPitch, qs, lane);
    const bool diagonal = causal && qs0 < k0 + kTile;
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      const int col = nt * 8 + 2 * c;
      const float la = l2s[col], lb = l2s[col + 1];
      s[nt][0] = exp2f(s[nt][0] * a2 - la);
      s[nt][1] = exp2f(s[nt][1] * a2 - lb);
      s[nt][2] = exp2f(s[nt][2] * a2 - la);
      s[nt][3] = exp2f(s[nt][3] * a2 - lb);
      if (diagonal) {
        const int qa = qs0 + col;
        if (qa < key_g) s[nt][0] = 0.f;
        if (qa + 1 < key_g) s[nt][1] = 0.f;
        if (qa < key_g + 8) s[nt][2] = 0.f;
        if (qa + 1 < key_g + 8) s[nt][3] = 0.f;
      }
    }
    uint32_t pa[BQ / 16][4];
    pack_fragments<BQ / 8>(pa, s);
    warp_gemm_pb<D, BQ / 16>(dv_acc, pa, dos, lane);

    float dp[BQ / 8][4];
#pragma unroll
    for (int t = 0; t < BQ / 8; ++t) dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
    warp_gemm_abt<D, BQ / 8>(dp, vs + warp * 16 * kPitch, dos, lane);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {  // ds^T = p^T * (dp^T - delta), in place
      const int col = nt * 8 + 2 * c;
      const float da = dls[col], db = dls[col + 1];
      dp[nt][0] = s[nt][0] * (dp[nt][0] - da);
      dp[nt][1] = s[nt][1] * (dp[nt][1] - db);
      dp[nt][2] = s[nt][2] * (dp[nt][2] - da);
      dp[nt][3] = s[nt][3] * (dp[nt][3] - db);
    }
    pack_fragments<BQ / 8>(pa, dp);
    warp_gemm_pb<D, BQ / 16>(dk_acc, pa, qs, lane);
  }

  const size_t row = head + static_cast<size_t>(key_g) * D;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int col = t * 8 + 2 * c;
    *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
        __floats2bfloat162_rn(dk_acc[t][0] * sm_scale, dk_acc[t][1] * sm_scale);
    *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * D + col) =
        __floats2bfloat162_rn(dk_acc[t][2] * sm_scale, dk_acc[t][3] * sm_scale);
    *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
        __floats2bfloat162_rn(dv_acc[t][0], dv_acc[t][1]);
    *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * D + col) =
        __floats2bfloat162_rn(dv_acc[t][2], dv_acc[t][3]);
  }
}

using bf16 = __nv_bfloat16;

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* d_o,
                      const void* lse, const void* delta, void* dq, int bh, int n,
                      float sm_scale, int causal, cudaStream_t stream) {
  const int smem = 4 * kTile * (D + kPad) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3(n / kTile, bh), kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), n, sm_scale, causal);
  return cudaGetLastError();
}

template <int D, int BQ>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* d_o,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int n,
                       float sm_scale, int causal, cudaStream_t stream) {
  const int smem = (2 * kTile + 2 * BQ) * (D + kPad) * static_cast<int>(sizeof(bf16)) +
                   2 * BQ * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, BQ><<<dim3(n / kTile, bh), kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n,
      sm_scale, causal);
  return cudaGetLastError();
}

bool shape_ok(int bh, int n, int d) {
  return bh > 0 && bh <= 65535 && n > 0 && n % kTile == 0 && (d == 64 || d == 128);
}

}  // namespace

// q, k, v, d_o, dq: (bh, n, d) contiguous bf16; lse, delta: (bh, n) fp32.
// d in {64, 128}, n a multiple of 64. Returns a cudaError_t code.
extern "C" int dfot_flash_bwd_dq(const void* q, const void* k, const void* v, const void* d_o,
                                 const void* lse, const void* delta, void* dq, int bh, int n,
                                 int d, float sm_scale, int causal, void* stream) {
  if (!shape_ok(bh, n, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dq<64>(q, k, v, d_o, lse, delta, dq, bh, n, sm_scale, causal, s);
  return launch_dq<128>(q, k, v, d_o, lse, delta, dq, bh, n, sm_scale, causal, s);
}

// As above, with dk, dv: (bh, n, d) contiguous bf16.
extern "C" int dfot_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* d_o,
                                  const void* lse, const void* delta, void* dk, void* dv, int bh,
                                  int n, int d, float sm_scale, int causal, void* stream) {
  if (!shape_ok(bh, n, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv<64, 64>(q, k, v, d_o, lse, delta, dk, dv, bh, n, sm_scale, causal, s);
  return launch_dkv<128, 32>(q, k, v, d_o, lse, delta, dk, dv, bh, n, sm_scale, causal, s);
}
