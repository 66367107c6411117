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
// O(N d) bytes, so the tensor cores bound both. Every N x N quantity stays in
// registers: scores come out of the products as fp32 accumulators, p and ds
// are rounded to bf16 in place and re-packed as the register A operand of the
// next product. Each output element is summed by one thread in a fixed order:
// no atomics, deterministic results. The softmax scale is applied once, to
// the fp32 sums.
//
// dq (B4): mma.sync m16n8k16 (csrc/mma.cuh); one block = 4 warps = a 64-row
// query tile, looping over 64-key K/V tiles copied into padded shared memory
// (row pitch d + 8, conflict-free ldmatrix).
//
// dk, dv (B5): wgmma, TMA and warp specialisation (csrc/hopper.cuh). One block
// owns 128 keys: a producer warpgroup (setmaxnreg down; one elected thread
// issues TMA) and two consumer warpgroups of 64 keys each. K and V are loaded
// once; 64-row Q and dO tiles with their LSE and delta slices stream through
// a ring of STAGES stages (full/empty mbarriers), so loads overlap the
// products. Per tile each consumer works on transposed scores (keys as rows):
// S^T = K Q^T and dP^T = V dO^T (shared-memory wgmma, m64 n64),
// P^T = exp2(S^T a2 - LSE log2 e), dS^T = P^T (dP^T - delta) in fp32, then
// dV += P^T dO and dK += dS^T Q (register-A wgmma, with dO and Q in their
// natural layout as the transposed B operand). Only the first DV lanes are
// computed: DV = the true head dim rounded up to 16 (80 for K600 @DiT/XL's
// heads of 72 zero-padded to 128); lanes DV..D-1 of dk, dv are written as
// zeros (the pad lanes of q and dO are zero, so they are exact).

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

// ---------------------------------------------------------------------------
// dk, dv: wgmma, a TMA ring of query tiles, warp specialisation
// ---------------------------------------------------------------------------

constexpr int kKeys = 128;       // keys of one block, 64 per consumer warpgroup
constexpr int kQRows = 64;       // query rows of a streamed tile
constexpr int kDkvThreads = 384;  // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kKeyAtomBytes = kKeys * kLineBytes;   // one 64-lane column block of K or V
constexpr int kQAtomBytes = kQRows * kLineBytes;    // ... of a Q or dO tile

template <int D>
__host__ __device__ constexpr int kv_bytes() { return D / kAtomLanes * kKeyAtomBytes; }
template <int D>
__host__ __device__ constexpr int q_bytes() { return D / kAtomLanes * kQAtomBytes; }
// dynamic shared memory: 1 KB of alignment slack, K, V, STAGES x (Q, dO, LSE,
// delta), barriers
template <int D, int STAGES>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return 1024 + 2 * kv_bytes<D>() + STAGES * (2 * q_bytes<D>() + 2 * kQRows * 4) +
         8 * (1 + 2 * STAGES);
}

template <int D, int DV, int STAGES>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int n, float sm_scale, int causal) {
  constexpr int kKV = kv_bytes<D>();
  constexpr int kQ = q_bytes<D>();
  constexpr int kAtoms = D / kAtomLanes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);
  unsigned char* vs = ks + kKV;
  unsigned char* qs = vs + kKV;
  unsigned char* dos = qs + STAGES * kQ;
  float* ls = reinterpret_cast<float*>(dos + STAGES * kQ);  // LSE of each stage's rows
  float* dls = ls + STAGES * kQRows;                         // delta of each stage's rows
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dls + STAGES * kQRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * kKeys;
  const int head = blockIdx.y;
  // causal: queries before the block's first key see none of its keys
  const int i0 = causal ? k0 / kQRows : 0;
  const int n_tiles = n / kQRows - i0;
  const size_t row_base = static_cast<size_t>(head) * n;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * kKV);
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_3d(ks + a * kKeyAtomBytes, &tm_k, kv_full, a * kAtomLanes, k0, head);
        tma_load_3d(vs + a * kKeyAtomBytes, &tm_v, kv_full, a * kAtomLanes, k0, head);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int r0 = (i0 + t) * kQRows;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kQ + 2 * kQRows * 4);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_3d(qs + s * kQ + a * kQAtomBytes, &tm_q, &full[s], a * kAtomLanes, r0, head);
          tma_load_3d(dos + s * kQ + a * kQAtomBytes, &tm_do, &full[s], a * kAtomLanes, r0,
                      head);
        }
        bulk_load(ls + s * kQRows, lse + row_base + r0, kQRows * 4, &full[s]);
        bulk_load(dls + s * kQRows, delta + row_base + r0, kQRows * 4, &full[s]);
      }
    }
  } else {
    // consumer warpgroups: 64 keys each; scores are transposed (keys as rows)
    setmaxnreg_inc<240>();
    const int w = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    const int key0 = k0 + w * 64 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
    const float a2 = sm_scale * kLog2e;
    const uint32_t k_addr = smem_u32(ks) + w * 64 * kLineBytes;
    const uint32_t v_addr = smem_u32(vs) + w * 64 * kLineBytes;

    float dk_acc[DV / 2], dv_acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int r0 = (i0 + t) * kQRows;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint32_t q_addr = smem_u32(qs + s * kQ);
      const uint32_t do_addr = smem_u32(dos + s * kQ);

      // S^T = K Q^T and dP^T = V dO^T, both (64 keys x 64 queries)
      float st[kQRows / 2], dpt[kQRows / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t key_off = (kk / 4) * kKeyAtomBytes + (kk % 4) * 32;
        const uint32_t q_off = (kk / 4) * kQAtomBytes + (kk % 4) * 32;
        WgmmaSS<kQRows>::mma(st, sw128_desc(k_addr + key_off), sw128_desc(q_addr + q_off),
                             kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t key_off = (kk / 4) * kKeyAtomBytes + (kk % 4) * 32;
        const uint32_t q_off = (kk / 4) * kQAtomBytes + (kk % 4) * 32;
        WgmmaSS<kQRows>::mma(dpt, sw128_desc(v_addr + key_off), sw128_desc(do_addr + q_off),
                             kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kQRows / 2>(st);
      fence_regs<kQRows / 2>(dpt);

      // P^T = exp2(S^T a2 - lse log2 e), the query's LSE broadcast down the
      // column; dS^T = P^T (dP^T - delta), both in place, in fp32
      const bool diagonal = causal && r0 < k0 + kKeys;
      const float* l_s = ls + s * kQRows;
      const float* d_s = dls + s * kQRows;
#pragma unroll
      for (int i = 0; i < kQRows / 8; ++i) {
        const int col = 8 * i + 2 * c;
        const float2 l2 = *reinterpret_cast<const float2*>(l_s + col);
        const float2 dl = *reinterpret_cast<const float2*>(d_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq = (e & 1) ? l2.y : l2.x;
          const float dd = (e & 1) ? dl.y : dl.x;
          float p = exp2f(fmaf(st[4 * i + e], a2, -lq * kLog2e));
          if (diagonal && r0 + col + (e & 1) < key0 + (e / 2) * 8) p = 0.f;
          st[4 * i + e] = p;
          dpt[4 * i + e] = p * (dpt[4 * i + e] - dd);
        }
      }
      uint32_t pt[kQRows / 16][4], dst[kQRows / 16][4];
      pack_a<kQRows / 16>(pt, st);
      pack_a<kQRows / 16>(dst, dpt);

      // dV += P^T dO and dK += dS^T Q, contracting over the tile's queries
      fence_regs<kQRows / 16>(pt);
      fence_regs<kQRows / 16>(dst);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kQRows / 16; ++kc) {
        wgmma_rs_wide<DV>(dv_acc, pt[kc], do_addr + kc * 16 * kLineBytes, kQAtomBytes);
        wgmma_rs_wide<DV>(dk_acc, dst[kc], q_addr + kc * 16 * kLineBytes, kQAtomBytes);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<DV / 2>(dv_acc);
      fence_regs<DV / 2>(dk_acc);
      fence_regs<kQRows / 16>(pt);
      fence_regs<kQRows / 16>(dst);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

    // the softmax scale once, on the fp32 sums; lanes DV..D-1 are zeros
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= n) continue;
      const size_t row = (row_base + key) * D;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        const int col = 8 * i + 2 * c;
        *reinterpret_cast<__nv_bfloat162*>(dk + row + col) = __floats2bfloat162_rn(
            dk_acc[4 * i + 2 * r] * sm_scale, dk_acc[4 * i + 2 * r + 1] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
            __floats2bfloat162_rn(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
      }
#pragma unroll
      for (int i = DV / 8; i < D / 8; ++i) {
        const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * i + 2 * c) = zero;
        *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * i + 2 * c) = zero;
      }
    }
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

template <int D, int DV, int STAGES>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* d_o,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int n,
                       int stages, int smem, float sm_scale, int causal, cudaStream_t stream) {
  // the caller's tile plan must be the one compiled here
  if (stages != STAGES || smem != dkv_smem_bytes<D, STAGES>()) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!make_head_map(&tm_q, q, bh, n, D, kQRows) || !make_head_map(&tm_do, d_o, bh, n, D, kQRows) ||
      !make_head_map(&tm_k, k, bh, n, D, kKeys) || !make_head_map(&tm_v, v, bh, n, D, kKeys))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_kernel<D, DV, STAGES>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3((n + kKeys - 1) / kKeys, bh), kDkvThreads, smem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, sm_scale, causal);
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

// As above, with dk, dv: (bh, n, d) contiguous bf16; every (bh, n) array
// 16-byte aligned. ``dv_lanes``: the lanes computed, the true head dim rounded
// up to a compiled width (d, or 80 at d = 128); lanes dv_lanes..d-1 of q, k,
// v, d_o must be zero and come out zero in dk, dv. ``stages`` and ``smem``:
// the caller's tile plan (dfot_tpu_torch/ops/attention.py:flash_plan),
// checked against the compiled one.
extern "C" int dfot_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* d_o,
                                  const void* lse, const void* delta, void* dk, void* dv, int bh,
                                  int n, int d, int dv_lanes, int stages, int smem,
                                  float sm_scale, int causal, void* stream) {
  if (!shape_ok(bh, n, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && dv_lanes == 64)
    return launch_dkv<64, 64, 4>(q, k, v, d_o, lse, delta, dk, dv, bh, n, stages, smem,
                                 sm_scale, causal, s);
  if (d == 128 && dv_lanes == 80)
    return launch_dkv<128, 80, 4>(q, k, v, d_o, lse, delta, dk, dv, bh, n, stages, smem,
                                  sm_scale, causal, s);
  if (d == 128 && dv_lanes == 128)
    return launch_dkv<128, 128, 4>(q, k, v, d_o, lse, delta, dk, dv, bh, n, stages, smem,
                                   sm_scale, causal, s);
  return cudaErrorInvalidValue;
}
