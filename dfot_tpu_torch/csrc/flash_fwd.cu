// Flash-attention forward for Hopper (sm_90a): bf16 operands, fp32 accumulation.
//
// Replaces the Pallas TPU kernel dfot_tpu/ops/attention.py:_flash_kernel (reached
// through _flash_forward and flash_attention). Same function: for every
// (batch*head) row block, O = softmax(q k^T * scale) v and, per query row,
// LSE = m * scale + ln(l) in natural-log units of the scaled scores (the
// convention of attention.py:180 that the backward and ring attention read).
//
// Bound: at the flagship shapes (N = 8192, d = 64 and N = 2048, d = 128) the
// work is 4 N^2 d flops per (b, h) against 4 N d bytes of q/k/v, so the kernel
// is bound by the tensor cores, not memory. The design keeps every N x N
// quantity in registers: the q k^T accumulators of mma.sync m16n8k16 are
// re-packed in place as the A operand of the p v product, the softmax row
// statistics and the row sum stay in registers (the TPU kernel's ones-column
// normalizer on v is not needed), and only 64-key K/V tiles pass through
// shared memory, with a row pitch of d + 8 so ldmatrix reads are free of bank
// conflicts. One block = 4 warps = 64 query rows; K/V tiles are 64 keys.
// wgmma, TMA and warp specialisation are left for later work.

#include "mma.cuh"

namespace {

using namespace dfot;

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int n, float sm_scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kBlockM * (D + kPad);
  __nv_bfloat16* vs = ks + kBlockN * (D + kPad);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;  // fragment row group, column pair
  const int q0 = blockIdx.x * kBlockM;
  const size_t head = static_cast<size_t>(blockIdx.y) * n * D;
  const float a2 = sm_scale * kLog2e;  // exp(x * scale) = exp2(x * a2)

  load_tile<D>(qs, q + head + static_cast<size_t>(q0) * D, kBlockM);
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide slice of d
  uint32_t qa[D / 16][4];
  {
    const int row = warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qa[kk], qs + row * (D + kPad) + kk * 16 + (lane / 16) * 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  // running max of the RAW scores and this thread's partial row sums, for
  // rows g and g + 8 of the warp's 16
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};
  const int row_g = q0 + warp * 16 + g;

  const int n_tiles = causal ? (q0 + kBlockM) / kBlockN : n / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(ks, k + head + static_cast<size_t>(j) * kBlockN * D, kBlockN);
    load_tile<D>(vs, v + head + static_cast<size_t>(j) * kBlockN * D, kBlockN);
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int t = 0; t < kBlockN / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; nt += 2) {
        uint32_t b[4];
        const int key = nt * 8 + (lane % 8) + (lane / 16) * 8;
        ldmatrix_x4(b, ks + key * (D + kPad) + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[nt], qa[kk], b[0], b[1]);
        mma_bf16(s[nt + 1], qa[kk], b[2], b[3]);
      }
    }

    if (causal && j == n_tiles - 1) {  // the diagonal tile (kBlockM == kBlockN)
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const int key = j * kBlockN + nt * 8 + 2 * c;
        if (key > row_g) s[nt][0] = kNegInf;
        if (key + 1 > row_g) s[nt][1] = kNegInf;
        if (key > row_g + 8) s[nt][2] = kNegInf;
        if (key + 1 > row_g + 8) s[nt][3] = kNegInf;
      }
    }

    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the four threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m_i[r] - mx[r]) * a2);
      m_i[r] = mx[r];
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = exp2f((s[nt][0] - mx[0]) * a2);
      s[nt][1] = exp2f((s[nt][1] - mx[0]) * a2);
      s[nt][2] = exp2f((s[nt][2] - mx[1]) * a2);
      s[nt][3] = exp2f((s[nt][3] - mx[1]) * a2);
      l_i[0] += s[nt][0] + s[nt][1];
      l_i[1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      acc[t][0] *= alpha[0];
      acc[t][1] *= alpha[0];
      acc[t][2] *= alpha[1];
      acc[t][3] *= alpha[1];
    }

    // acc += p v: the score accumulators of key tiles 2kc, 2kc+1 are the A
    // fragment of the 16-key slice kc
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kc][0], s[2 * kc][1]), pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        const int key = kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        ldmatrix_x4_trans(b, vs + key * (D + kPad) + dt * 8 + (lane / 16) * 8);
        mma_bf16(acc[dt], pa, b[0], b[1]);
        mma_bf16(acc[dt + 1], pa, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  const float inv0 = 1.f / l_i[0], inv1 = 1.f / l_i[1];
  __nv_bfloat16* o0 = o + head + static_cast<size_t>(row_g) * D;
  __nv_bfloat16* o1 = o0 + 8 * D;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int col = t * 8 + 2 * c;
    *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
        __floats2bfloat162_rn(acc[t][0] * inv0, acc[t][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
        __floats2bfloat162_rn(acc[t][2] * inv1, acc[t][3] * inv1);
  }
  if (lse != nullptr && c == 0) {
    float* l = lse + static_cast<size_t>(blockIdx.y) * n;
    l[row_g] = m_i[0] * sm_scale + logf(l_i[0]);
    l[row_g + 8] = m_i[1] * sm_scale + logf(l_i[1]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int n, float sm_scale, int causal, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * kBlockN) * (D + kPad) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kBlockM, bh);
  flash_fwd_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), n, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (bh, n, d) contiguous bf16; lse: (bh, n) fp32 or null.
// d in {64, 128}, n a multiple of 64. Returns a cudaError_t code.
extern "C" int dfot_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bh, int n, int d, float sm_scale, int causal, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % kBlockM != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k, v, o, lse, bh, n, sm_scale, causal, s);
  if (d == 128) return launch<128>(q, k, v, o, lse, bh, n, sm_scale, causal, s);
  return cudaErrorInvalidValue;
}
