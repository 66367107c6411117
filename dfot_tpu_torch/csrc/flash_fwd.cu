// Flash-attention forward for Hopper (sm_90a): bf16 operands, fp32 accumulation.
//
// Replaces the Pallas TPU kernel dfot_tpu/ops/attention.py:_flash_kernel (reached
// through _flash_forward and flash_attention). Same function: for every
// (batch*head) row block, O = softmax(q k^T * scale) v and, per query row,
// LSE = m * scale + ln(l) in natural-log units of the scaled scores (the
// convention of attention.py:180 that the backward and ring attention read).
//
// Bound: 4 N^2 d flops per (b, h) against 4 N d bytes of q/k/v/o, so the
// tensor cores bound it at every shape of the paths. The design feeds them
// through wgmma and keeps every N x N quantity in registers:
// - one block is three warpgroups: a producer that gives up its registers
//   (setmaxnreg) and whose one elected thread issues TMA, and two consumers
//   of 64 query rows each (block = 128 query rows);
// - TMA brings the block's Q tile once and streams KN-key K/V tiles through
//   a ring of STAGES stages with full/empty mbarriers, so loads overlap the
//   products; a 3-D tensor map (d, n, bh) reads zeros past n. KN is 128 at
//   d = 64 and 128; at d = 256 it is 64, with 2 stages: Q (64 KB) and two
//   64 KB K/V stages fill the 227 KB a block can take, and the 64 x 256 fp32
//   O accumulator (128 registers a consumer thread) leaves room for a 64 x 64
//   score tile (32) but not for a 64 x 128 one;
// - S = Q K^T is a shared-memory wgmma (m64 nKN), the online softmax runs
//   on its fp32 accumulators (exp2, running max of the raw scores), P is
//   rounded to bf16 in registers and is the register A operand of O += P V,
//   with V in its natural (keys x d) layout as the transposed B operand;
// - FA3's schedule: a consumer issues S_j and then O += P_{j-1} V_{j-1} as
//   two wgmma groups and runs the softmax of tile j while the second one
//   runs; the two consumers take turns to issue (named barriers 1 and 2),
//   so one's softmax overlaps the other's products;
// - only the first DV lanes are computed: DV = the true head dim rounded up
//   to 16 (80 for K600 @DiT/XL's heads of 72 zero-padded to 128) and then to
//   a compiled width (192 or 256 for a head padded to 256), so QK^T
//   runs DV / 16 k-steps and PV an n of DV; lanes DV..D-1 of O are written as
//   zeros (the pad lanes of v are zero, so they are exact).
// Every batch of products starts with a wgmma.fence of its own, after the
// registers it reads are pinned (fence_regs): with one fence for both
// groups, or a conditional wait inside the loop, ptxas serializes the
// products (its warnings C7514, C7515).
//
// The ring hop (RING = true; dfot_ring_fwd) replaces one hop of
// dfot_tpu/ops/ring_attention.py's fold: _block_flash (:49) and the
// logaddexp fold after it (:99-111). It is this kernel with two changes:
// - the shard shift: a LocalRing stacks its R ranks' shards on the head axis
//   (R B H heads), so at hop s query head h attends to K/V head
//   (h - s B H) mod R B H; the producer loads K and V at that head (kv_shift
//   = s B H), and no shard is copied between hops;
// - the folding epilogue: per row, lse_b = m scale + ln l, lse = logaddexp(
//   lse_prev, lse_b) and O = O_prev exp(lse_prev - lse) + (acc / l)
//   exp(lse_b - lse), with the running O (fp32, its DV lanes) and LSE (fp32)
//   read from device memory after the first hop and written back, or, at
//   the last hop, O in bf16 (pad lanes zero) and the final LSE. The block's
//   O is folded before any bf16 rounding.
// The running state adds 8 bytes a lane a row of reads and writes a hop
// against the 4 n DV flops a row of the products, so the tensor cores still
// bound the hop.

#include "hopper.cuh"

namespace {

using namespace dfot;
using bf16 = __nv_bfloat16;

constexpr int kBlock = 128;                          // query rows of a block
constexpr int kThreads = 384;                        // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kQAtomBytes = kBlock * kLineBytes;     // one 64-lane column block of Q
constexpr float kNegInf = -1e30f;

template <int D>
__host__ __device__ constexpr int q_tile_bytes() { return D / kAtomLanes * kQAtomBytes; }
template <int D, int KN>
__host__ __device__ constexpr int kv_tile_bytes() { return D / kAtomLanes * KN * kLineBytes; }

// dynamic shared memory: 1 KB of alignment slack, Q, STAGES x (K, V), barriers
template <int D, int KN, int STAGES>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + q_tile_bytes<D>() + 2 * STAGES * kv_tile_bytes<D, KN>() + 8 * (1 + 2 * STAGES);
}

// the running state of a ring hop (RING kernels only)
struct RingFold {
  float* o_acc;   // running O, (bh, n, D) fp32, DV lanes used; read if read_prev, written if !last
  int kv_shift;   // K/V head = (query head - kv_shift) mod bh, 0 <= kv_shift < bh
  int read_prev;  // fold into the running (O, LSE); else this block starts it
  int last;       // write O in bf16 to o (and the final LSE) instead of o_acc
};

// A ring hop's epilogue for this thread's two rows (row0, row0 + 8) and its
// columns 8 i + 2 c (+ 1): the block's unnormalized O (acc), raw-score max
// m and row sum l (already summed over the quad) folded into the running
// (O, LSE). Every lane of a quad reads the row's running LSE before lane
// c == 0 overwrites it (the __syncwarp between); each O element is read and
// written by the thread that owns it.
template <int D, int DV>
__device__ __forceinline__ void fold_epilogue(const float* acc, const float* m_i,
                                              const float* l_i, int row0, int c, int head, int n,
                                              float sm_scale, bf16* __restrict__ o,
                                              float* __restrict__ lse, const RingFold& ring) {
  float lse_prev[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_prev[r] = ring.read_prev && row < n ? lse[static_cast<size_t>(head) * n + row] : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    const float lse_b = m_i[r] * sm_scale + logf(l_i[r]);
    float lse_new = lse_b, a = 0.f, b = 1.f / l_i[r];
    if (ring.read_prev) {
      const float mx = fmaxf(lse_prev[r], lse_b);
      lse_new = mx + logf(expf(lse_prev[r] - mx) + expf(lse_b - mx));
      a = expf(lse_prev[r] - lse_new);
      b = expf(lse_b - lse_new) / l_i[r];
    }
    const size_t base = static_cast<size_t>(head) * n + row;
    float* run = ring.o_acc + base * D;
    // every load before the first store (see flash_bwd.cu:ring_store_row)
    float2 prev[DV / 8];
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      prev[i] = ring.read_prev ? *reinterpret_cast<const float2*>(run + 8 * i + 2 * c)
                               : make_float2(0.f, 0.f);
    bf16* out = o + base * D;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      const float x0 = fmaf(prev[i].x, a, acc[4 * i + 2 * r] * b);
      const float x1 = fmaf(prev[i].y, a, acc[4 * i + 2 * r + 1] * b);
      if (ring.last)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * c) = __floats2bfloat162_rn(x0, x1);
      else
        *reinterpret_cast<float2*>(run + 8 * i + 2 * c) = make_float2(x0, x1);
    }
    if (ring.last) {
#pragma unroll
      for (int i = DV / 8; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * c) = __floats2bfloat162_rn(0.f, 0.f);
    }
    if (c == 0) lse[base] = lse_new;
  }
}

template <int D, int DV, int KN, int STAGES, bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                     float* __restrict__ lse, int n, float sm_scale, int causal,
                     const RingFold ring) {
  constexpr int kQTile = q_tile_bytes<D>();
  constexpr int kKVTile = kv_tile_bytes<D, KN>();
  constexpr int kKVAtomBytes = KN * kLineBytes;
  constexpr int kAtoms = D / kAtomLanes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* ks = qs + kQTile;
  unsigned char* vs = ks + STAGES * kKVTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * kKVTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // causal: the longest rows first, so the short ones fill the tail
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * kBlock;
  const int head = blockIdx.y;
  int kv_head = head;
  if constexpr (RING) {
    kv_head -= ring.kv_shift;
    if (kv_head < 0) kv_head += static_cast<int>(gridDim.y);
  }
  const int n_kv = (n + KN - 1) / KN;
  // causal: the block's last row sees keys up to q0 + 127
  const int n_tiles = causal ? min(n_kv, (q0 + kBlock + KN - 1) / KN) : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_arrive_expect_tx(q_full, kQTile);
      for (int a = 0; a < kAtoms; ++a)
        tma_load_3d(qs + a * kQAtomBytes, &tm_q, q_full, a * kAtomLanes, q0, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKVTile);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_3d(ks + s * kKVTile + a * kKVAtomBytes, &tm_k, &full[s], a * kAtomLanes,
                      j * KN, kv_head);
          tma_load_3d(vs + s * kKVTile + a * kKVAtomBytes, &tm_v, &full[s], a * kAtomLanes,
                      j * KN, kv_head);
        }
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each
    setmaxnreg_inc<240>();
    const int w = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    const int row0 = q0 + w * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
    const float a2 = sm_scale * kLog2e;             // exp(x * scale) = exp2(x * a2)
    const uint32_t q_addr = smem_u32(qs) + w * 64 * kLineBytes;

    float acc[DV / 2];  // O, DV / 8 chunks of 8 columns
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    // running max of the RAW scores and this thread's partial row sums
    float m_i[2] = {kNegInf, kNegInf};
    float l_i[2] = {0.f, 0.f};

    uint32_t pa[KN / 16][4];  // P of the tile before, the A operand of its PV product
    // S_j = Q K_j^T into sc (KN / 8 chunks of 8 keys), its own wgmma group
    auto issue_s = [&](int j, float* sc) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const uint32_t k_addr = smem_u32(ks + s * kKVTile);
      fence_regs<KN / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t q_off = (kk / 4) * kQAtomBytes + (kk % 4) * 32;
        const uint32_t k_off = (kk / 4) * kKVAtomBytes + (kk % 4) * 32;
        WgmmaSS<KN>::mma(sc, sw128_desc(q_addr + q_off), sw128_desc(k_addr + k_off), kk > 0);
      }
      wgmma_commit();
    };
    // O += P_j V_j, its own wgmma group
    auto issue_pv = [&](int j) {
      const uint32_t v_addr = smem_u32(vs + (j % STAGES) * kKVTile);
      fence_regs<DV / 2>(acc);
      fence_regs<KN / 16>(pa);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KN / 16; ++kc)
        wgmma_rs_wide<DV>(acc, pa[kc], v_addr + kc * 16 * kLineBytes, kKVAtomBytes);
      wgmma_commit();
    };
    // tile j's mask, running row max and sum; P in place of S, and the
    // factors that move O to the new row max in alpha. Masked: keys >= n
    // and (causal) the tiles that reach past the block's first row
    auto softmax = [&](int j, float* sc, float* alpha) {
      const int key0 = j * KN;
      if (key0 + KN > n || (causal && key0 + KN - 1 > q0)) {
#pragma unroll
        for (int i = 0; i < KN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * i + 2 * c + (e & 1);
            const int row = row0 + (e / 2) * 8;
            if (key >= n || (causal && key > row)) sc[4 * i + e] = kNegInf;
          }
        }
      }
      float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
      for (int i = 0; i < KN / 8; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m_i[r] - mx[r]) * a2);
        m_i[r] = mx[r];
        l_i[r] *= alpha[r];
      }
      const float mb0 = mx[0] * a2, mb1 = mx[1] * a2;
#pragma unroll
      for (int i = 0; i < KN / 8; ++i) {
        sc[4 * i + 0] = exp2f(fmaf(sc[4 * i + 0], a2, -mb0));
        sc[4 * i + 1] = exp2f(fmaf(sc[4 * i + 1], a2, -mb0));
        sc[4 * i + 2] = exp2f(fmaf(sc[4 * i + 2], a2, -mb1));
        sc[4 * i + 3] = exp2f(fmaf(sc[4 * i + 3], a2, -mb1));
        l_i[0] += sc[4 * i] + sc[4 * i + 1];
        l_i[1] += sc[4 * i + 2] + sc[4 * i + 3];
      }
    };

    // consumer w issues products only between wait_turn and pass_turn:
    // named barrier 1 + w counts its 128 threads and the other consumer's
    // 128; each consumer syncs n_tiles + 1 times and the other arrives as often
    auto wait_turn = [&] { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w)); };
    auto pass_turn = [&] { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w)); };
    if (w == 1) pass_turn();  // consumer 0 goes first
    mbar_wait(q_full, 0);
    {
      float sc[KN / 2], alpha[2];
      wait_turn();
      issue_s(0, sc);
      pass_turn();
      wgmma_wait<0>();
      fence_regs<KN / 2>(sc);
      softmax(0, sc, alpha);
      pack_a<KN / 16>(pa, sc);
    }
    for (int j = 1; j < n_tiles; ++j) {
      float sc[KN / 2], alpha[2];
      wait_turn();
      issue_s(j, sc);
      issue_pv(j - 1);
      pass_turn();
      wgmma_wait<1>();  // S_j is done, PV_{j-1} may still run
      fence_regs<KN / 2>(sc);
      softmax(j, sc, alpha);
      wgmma_wait<0>();
      fence_regs<DV / 2>(acc);
      fence_regs<KN / 16>(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);  // done with tile j - 1
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        acc[4 * i + 0] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }
      pack_a<KN / 16>(pa, sc);
    }
    wait_turn();
    issue_pv(n_tiles - 1);
    if (w == 0) pass_turn();  // consumer 1's last turn is its last sync
    wgmma_wait<0>();
    fence_regs<DV / 2>(acc);
    fence_regs<KN / 16>(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(n_tiles - 1) % STAGES]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    }
    if constexpr (RING) {
      fold_epilogue<D, DV>(acc, m_i, l_i, row0, c, head, n, sm_scale, o, lse, ring);
      return;
    }
    const float inv[2] = {1.f / l_i[0], 1.f / l_i[1]};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n) continue;
      bf16* out = o + (static_cast<size_t>(head) * n + row) * D;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * c) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv[r], acc[4 * i + 2 * r + 1] * inv[r]);
#pragma unroll
      for (int i = DV / 8; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * c) = __floats2bfloat162_rn(0.f, 0.f);
      if (lse != nullptr && c == 0)
        lse[static_cast<size_t>(head) * n + row] = m_i[r] * sm_scale + logf(l_i[r]);
    }
  }
}

template <int D, int DV, int KN, int STAGES, bool RING>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int n, int stages, int smem, float sm_scale, int causal, const RingFold& ring,
                   cudaStream_t stream) {
  // the caller's tile plan must be the one compiled here
  if (stages != STAGES || smem != smem_bytes<D, KN, STAGES>()) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_head_map(&tm_q, q, bh, n, D, kBlock) ||
      !make_head_map(&tm_k, k, bh, n, D, KN) || !make_head_map(&tm_v, v, bh, n, D, KN))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<D, DV, KN, STAGES, RING>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n + kBlock - 1) / kBlock, bh);
  kernel<<<grid, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, static_cast<bf16*>(o),
                                           static_cast<float*>(lse), n, sm_scale, causal, ring);
  return cudaGetLastError();
}

template <bool RING>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                     int n, int d, int dv, int stages, int smem, float sm_scale, int causal,
                     const RingFold& ring, cudaStream_t s) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % 64 != 0) return cudaErrorInvalidValue;
  if (d == 64 && dv == 64)
    return launch<64, 64, 128, 4, RING>(q, k, v, o, lse, bh, n, stages, smem, sm_scale, causal,
                                        ring, s);
  if (d == 128 && dv == 80)
    return launch<128, 80, 128, 3, RING>(q, k, v, o, lse, bh, n, stages, smem, sm_scale, causal,
                                         ring, s);
  if (d == 128 && dv == 128)
    return launch<128, 128, 128, 3, RING>(q, k, v, o, lse, bh, n, stages, smem, sm_scale, causal,
                                          ring, s);
  if (d == 256 && dv == 192)
    return launch<256, 192, 64, 2, RING>(q, k, v, o, lse, bh, n, stages, smem, sm_scale, causal,
                                         ring, s);
  if (d == 256 && dv == 256)
    return launch<256, 256, 64, 2, RING>(q, k, v, o, lse, bh, n, stages, smem, sm_scale, causal,
                                         ring, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: (bh, n, d) contiguous bf16, 16-byte aligned; lse: (bh, n) fp32
// or null. d in {64, 128, 256}, n a multiple of 64. ``dv``: the lanes
// computed, the true head dim rounded up to a compiled width (d, 80 at
// d = 128, 192 at d = 256); lanes dv..d-1 of q, k, v must be zero and come
// out zero in o. ``stages``
// and ``smem``: the caller's tile plan (dfot_tpu_torch/ops/attention.py:
// flash_plan), checked against the compiled one. Returns a cudaError_t code.
extern "C" int dfot_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bh, int n, int d, int dv, int stages, int smem,
                              float sm_scale, int causal, void* stream) {
  return dispatch<false>(q, k, v, o, lse, bh, n, d, dv, stages, smem, sm_scale, causal,
                         RingFold{nullptr, 0, 0, 0}, static_cast<cudaStream_t>(stream));
}

// One non-causal ring hop, arguments as dfot_flash_fwd, with ``lse`` the
// running LSE (bh, n) fp32 (read if ``read_prev``, always written) and
// ``o_acc`` the running O (bh, n, d) fp32 (its first dv lanes read if
// ``read_prev``, written unless ``last``; null if neither). ``o`` (bf16)
// receives the hop's result if ``last``, else it may be null. K/V head =
// (query head - ``kv_shift``) mod bh, 0 <= kv_shift < bh. The plan is B1's
// (flash_plan "ring_fwd").
extern "C" int dfot_ring_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             void* o_acc, int bh, int n, int d, int dv, int stages, int smem,
                             float sm_scale, int kv_shift, int read_prev, int last,
                             void* stream) {
  if (kv_shift < 0 || kv_shift >= bh || lse == nullptr || (last && o == nullptr) ||
      ((read_prev || !last) && o_acc == nullptr))
    return cudaErrorInvalidValue;
  const RingFold ring{static_cast<float*>(o_acc), kv_shift, read_prev != 0, last != 0};
  return dispatch<true>(q, k, v, o, lse, bh, n, d, dv, stages, smem, sm_scale, 0, ring,
                        static_cast<cudaStream_t>(stream));
}
