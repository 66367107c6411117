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
// dq (B4): query-stationary, the shape of B1 (csrc/flash_fwd.cu). One block
// owns 128 query rows: a producer warpgroup (setmaxnreg down; one elected
// thread issues TMA) and two consumer warpgroups of 64 rows each. Q and dO
// (128 x d) are loaded once; KN-key K and V tiles stream through a ring of
// STAGES stages (full/empty mbarriers), so loads overlap the products. Per
// tile each consumer computes S = Q K^T and dP = dO V^T (shared-memory
// wgmma, both operands K-major: B1's QK^T twice), P = exp2(S a2 - LSE log2 e)
// with the causal mask on the diagonal tiles and keys >= n masked,
// dS = P (dP - delta) in fp32, rounded to bf16 in place and packed as the
// register A operand of dQ += dS K (register-A wgmma, K as the MN-major B
// operand: B1's PV). LSE and delta of a thread's two rows are read once.
// B1's schedule: the dS of tile j is computed while the product of tile
// j - 1 runs, and the two consumers take turns to issue, so one's exp2
// overlaps the other's products. K/V tiles are 128 keys at d = 64, 64 at
// d = 128, where two 128-key score tiles, dQ and the packed dS would take
// 224 registers and spill, and 32 at d = 256 (3 stages): Q and dO take
// 128 KB there, and dQ alone 128 registers a consumer thread.
//
// dk, dv (B5): wgmma, TMA and warp specialisation (csrc/hopper.cuh). At d = 64
// and 128 one block owns 128 keys: a producer warpgroup (setmaxnreg down; one
// elected thread issues TMA) and two consumer warpgroups of 64 keys each. At
// d = 256 the dK and dV accumulators of 64 keys would take 256 registers a
// thread, so a block owns 64 keys and its two consumers split the outputs:
// both compute the block's S^T and dP^T, consumer 0 accumulates dV and
// consumer 1 dK (128 registers each); K and V take 64 KB and two Q/dO stages
// 129 KB. It stays deterministic, with no atomics. K and V are loaded
// once; 64-row Q and dO tiles with their LSE and delta slices stream through
// a ring of STAGES stages (full/empty mbarriers), so loads overlap the
// products. Per tile each consumer works on transposed scores (keys as rows):
// S^T = K Q^T and dP^T = V dO^T (shared-memory wgmma, m64 n64),
// P^T = exp2(S^T a2 - LSE log2 e), dS^T = P^T (dP^T - delta) in fp32, then
// dV += P^T dO and dK += dS^T Q (register-A wgmma, with dO and Q in their
// natural layout as the transposed B operand).
//
// Both compute only the first DV lanes: DV = the true head dim rounded up to
// 16 (80 for K600 @DiT/XL's heads of 72 zero-padded to 128) and then to a
// compiled width (192 or 256 for a head padded to 256), so the score
// products contract over DV / 16 k-steps and the output products have an n
// of DV; lanes DV..D-1 of dq, dk, dv are written as zeros (the pad lanes of
// q, k, v and dO are zero, so they are exact). The 3-D tensor maps (d, n, bh)
// read zeros past a head's last row; no row >= n is stored.
//
// Ring hops (RING = true; dfot_ring_bwd_dq, dfot_ring_bwd_dkv): the backward
// of one hop of ring attention (dfot_tpu/ops/ring_attention.py, whose JAX
// backward reaches these kernels' TPU counterparts through _block_flash's
// VJP), the same kernels with two changes:
// - the shard shift of the forward hop (csrc/flash_fwd.cu): on a LocalRing
//   the R ranks' shards are stacked on the head axis, so at hop s query head
//   h meets K/V head (h - s B H) mod R B H. dq's producer loads K and V at
//   that head; dk, dv's block owns the keys of its K/V head and walks the
//   query rows (Q, dO, LSE, delta) of head (kv head + s B H) mod R B H, the
//   rank that meets the shard at this hop. The shift is a permutation of the
//   heads, so one block still owns each output tile;
// - accumulation across hops: each thread adds its dq (or dk, dv) elements
//   into fp32 sums in device memory (read unless it is the first hop), and
//   the last hop writes the sums in bf16 instead (pad lanes zero). No
//   atomics; the sums stay in a fixed order, hop after hop.

#include "hopper.cuh"

namespace {

using namespace dfot;

// the cross-hop sums of a ring hop (RING kernels only)
struct RingSum {
  float* acc;     // fp32 (bh, n, D) sum of dq, or of dk; its first DV lanes are used
  float* acc2;    // fp32 sum of dv (dk, dv kernel only)
  int kv_shift;   // K/V head = (query head - kv_shift) mod bh, 0 <= kv_shift < bh
  int read_prev;  // add to the sums; else this hop starts them
  int last;       // write the sums in bf16 to the outputs instead of acc, acc2
};

// One row of a thread's output tile at a ring hop: its DV / 8 pairs of
// columns 8 i + 2 c (+ 1), acc[4 i + 2 r] (+ 1) times ``scale``, plus the
// running sum at ``sum`` (the row's fp32 sums) if ``read_prev``, stored into
// the sums or, at the last hop, into ``out`` (the row's bf16 output). Every
// load comes before the first store: interleaved, each load waited for
// the store before it (the sums and the output may alias as far as the
// compiler knows), which made a middle hop of dq 3-4 times as slow as B4 on
// an H100.
template <int DV>
__device__ __forceinline__ void ring_store_row(const float* acc, int r, float scale, float* sum,
                                               __nv_bfloat16* out, int c, const RingSum& ring) {
  float2 prev[DV / 8];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
    prev[i] = ring.read_prev ? *reinterpret_cast<const float2*>(sum + 8 * i + 2 * c)
                             : make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const float x0 = fmaf(acc[4 * i + 2 * r], scale, prev[i].x);
    const float x1 = fmaf(acc[4 * i + 2 * r + 1], scale, prev[i].y);
    if (ring.last)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * c) = __floats2bfloat162_rn(x0, x1);
    else
      *reinterpret_cast<float2*>(sum + 8 * i + 2 * c) = make_float2(x0, x1);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: wgmma, a TMA ring of query tiles, warp specialisation
// ---------------------------------------------------------------------------

// keys of one block, by padded head dim (the tile plan's FLASH_DKV_KEYS): 128,
// 64 per consumer warpgroup, or at d = 256 64 that both consumers share
constexpr int kKeysNarrow = 128;
constexpr int kKeysWide = 64;
constexpr int kQRows = 64;       // query rows of a streamed tile
constexpr int kThreads = 384;  // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kQAtomBytes = kQRows * kLineBytes;    // one 64-lane column block of Q or dO

template <int D, int KEYS>
__host__ __device__ constexpr int kv_bytes() { return D / kAtomLanes * KEYS * kLineBytes; }
template <int D>
__host__ __device__ constexpr int q_bytes() { return D / kAtomLanes * kQAtomBytes; }
// dynamic shared memory: 1 KB of alignment slack, K, V, STAGES x (Q, dO, LSE,
// delta), barriers
template <int D, int KEYS, int STAGES>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return 1024 + 2 * kv_bytes<D, KEYS>() + STAGES * (2 * q_bytes<D>() + 2 * kQRows * 4) +
         8 * (1 + 2 * STAGES);
}

template <int D, int DV, int KEYS, int STAGES, bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int n, float sm_scale, int causal,
                         const RingSum ring) {
  // split: the block's keys are both consumers', consumer 0 owns their dV
  // and consumer 1 their dK
  constexpr bool kSplit = KEYS == kKeysWide;
  constexpr int kKeyAtomBytes = KEYS * kLineBytes;  // one 64-lane column block of K or V
  constexpr int kKV = kv_bytes<D, KEYS>();
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

  const int k0 = blockIdx.x * KEYS;
  const int head = blockIdx.y;  // the K/V head whose keys the block owns
  // the query head it meets: itself, or on a ring hop the head kv_shift on
  int q_head = head;
  if constexpr (RING) {
    q_head += ring.kv_shift;
    if (q_head >= static_cast<int>(gridDim.y)) q_head -= static_cast<int>(gridDim.y);
  }
  // causal: queries before the block's first key see none of its keys
  const int i0 = causal ? k0 / kQRows : 0;
  const int n_tiles = n / kQRows - i0;
  const size_t row_base = static_cast<size_t>(head) * n;
  const size_t q_base = static_cast<size_t>(q_head) * n;

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
          tma_load_3d(qs + s * kQ + a * kQAtomBytes, &tm_q, &full[s], a * kAtomLanes, r0,
                      q_head);
          tma_load_3d(dos + s * kQ + a * kQAtomBytes, &tm_do, &full[s], a * kAtomLanes, r0,
                      q_head);
        }
        bulk_load(ls + s * kQRows, lse + q_base + r0, kQRows * 4, &full[s]);
        bulk_load(dls + s * kQRows, delta + q_base + r0, kQRows * 4, &full[s]);
      }
    }
  } else {
    // consumer warpgroups: 64 keys each; scores are transposed (keys as rows)
    setmaxnreg_inc<240>();
    const int w = threadIdx.x / 128 - 1;
    const int kw = kSplit ? 0 : w;  // which 64 of the block's keys
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    const int key0 = k0 + kw * 64 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
    const float a2 = sm_scale * kLog2e;
    const uint32_t k_addr = smem_u32(ks) + kw * 64 * kLineBytes;
    const uint32_t v_addr = smem_u32(vs) + kw * 64 * kLineBytes;

    // dV; split: consumer 0's dV or consumer 1's dK, and dk_acc unused
    float dv_acc[DV / 2], dk_acc[kSplit ? 1 : DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kSplit ? 1 : DV / 2); ++i) dk_acc[i] = 0.f;

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
      const bool diagonal = causal && r0 < k0 + KEYS;
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
          if constexpr (kSplit) {
            // the A operand of this consumer's product: P^T or dS^T
            dpt[4 * i + e] = w == 0 ? p : p * (dpt[4 * i + e] - dd);
          } else {
            st[4 * i + e] = p;
            dpt[4 * i + e] = p * (dpt[4 * i + e] - dd);
          }
        }
      }
      if constexpr (kSplit) {
        // consumer 0: dV += P^T dO; consumer 1: dK += dS^T Q
        uint32_t pa[kQRows / 16][4];
        pack_a<kQRows / 16>(pa, dpt);
        const uint32_t b_addr = w == 0 ? do_addr : q_addr;
        fence_regs<kQRows / 16>(pa);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kQRows / 16; ++kc)
          wgmma_rs_wide<DV>(dv_acc, pa[kc], b_addr + kc * 16 * kLineBytes, kQAtomBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<DV / 2>(dv_acc);
        fence_regs<kQRows / 16>(pa);
      } else {
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
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    }

    // the softmax scale once, on the fp32 sums; lanes DV..D-1 are zeros
    if constexpr (kSplit) {
      __nv_bfloat16* out = w == 0 ? dv : dk;
      float* sum = w == 0 ? ring.acc2 : ring.acc;
      const float scale = w == 0 ? 1.f : sm_scale;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= n) continue;
        __nv_bfloat16* row = out + (row_base + key) * D;
        if constexpr (RING) {
          ring_store_row<DV>(dv_acc, r, scale, sum + (row_base + key) * D, row, c, ring);
          if (!ring.last) continue;
        } else {
#pragma unroll
          for (int i = 0; i < DV / 8; ++i)
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + 2 * c) = __floats2bfloat162_rn(
                dv_acc[4 * i + 2 * r] * scale, dv_acc[4 * i + 2 * r + 1] * scale);
        }
#pragma unroll
        for (int i = DV / 8; i < D / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + 2 * c) = __floats2bfloat162_rn(0.f, 0.f);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= n) continue;
        const size_t row = (row_base + key) * D;
        if constexpr (RING) {
          ring_store_row<DV>(dk_acc, r, sm_scale, ring.acc + row, dk + row, c, ring);
          ring_store_row<DV>(dv_acc, r, 1.f, ring.acc2 + row, dv + row, c, ring);
          if (!ring.last) continue;
        } else {
#pragma unroll
          for (int i = 0; i < DV / 8; ++i) {
            const int col = 8 * i + 2 * c;
            *reinterpret_cast<__nv_bfloat162*>(dk + row + col) = __floats2bfloat162_rn(
                dk_acc[4 * i + 2 * r] * sm_scale, dk_acc[4 * i + 2 * r + 1] * sm_scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
                __floats2bfloat162_rn(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
          }
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
}

// ---------------------------------------------------------------------------
// dq: wgmma, a TMA ring of K/V tiles, warp specialisation
// ---------------------------------------------------------------------------

constexpr int kDqRows = 128;                         // query rows of one block
constexpr int kDqAtomBytes = kDqRows * kLineBytes;   // one 64-lane column block of Q or dO
// keys of a streamed K/V tile, by padded head dim (the tile plan's
// ``tile_rows``, ops/attention.py:FLASH_DQ_KEYS)
constexpr int kDqKeys64 = 128;
constexpr int kDqKeys128 = 64;  // 128 keys: 224 live registers a consumer thread, spills
constexpr int kDqKeys256 = 32;  // Q and dO take 128 KB: three 32 KB stages fit beside them

template <int D>
__host__ __device__ constexpr int dq_q_bytes() { return D / kAtomLanes * kDqAtomBytes; }
template <int D, int KN>
__host__ __device__ constexpr int dq_kv_bytes() { return D / kAtomLanes * KN * kLineBytes; }
// dynamic shared memory: 1 KB of alignment slack, Q, dO, STAGES x (K, V),
// barriers
template <int D, int KN, int STAGES>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 1024 + 2 * dq_q_bytes<D>() + STAGES * 2 * dq_kv_bytes<D, KN>() + 8 * (1 + 2 * STAGES);
}

template <int D, int DV, int KN, int STAGES, bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int n,
                        float sm_scale, int causal, const RingSum ring) {
  constexpr int kQ = dq_q_bytes<D>();
  constexpr int kKV = dq_kv_bytes<D, KN>();
  constexpr int kKVAtomBytes = KN * kLineBytes;
  constexpr int kAtoms = D / kAtomLanes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* dos = qs + kQ;
  unsigned char* ks = dos + kQ;
  unsigned char* vs = ks + STAGES * kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * kKV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // causal: the longest rows first, so the short ones fill the tail
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * kDqRows;
  const int head = blockIdx.y;
  int kv_head = head;
  if constexpr (RING) {
    kv_head -= ring.kv_shift;
    if (kv_head < 0) kv_head += static_cast<int>(gridDim.y);
  }
  const int n_kv = (n + KN - 1) / KN;
  // causal: the block's last row sees keys up to q0 + 127
  const int n_tiles = causal ? min(n_kv, (q0 + kDqRows + KN - 1) / KN) : n_kv;

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
      mbar_arrive_expect_tx(q_full, 2 * kQ);
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_3d(qs + a * kDqAtomBytes, &tm_q, q_full, a * kAtomLanes, q0, head);
        tma_load_3d(dos + a * kDqAtomBytes, &tm_do, q_full, a * kAtomLanes, q0, head);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKV);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_3d(ks + s * kKV + a * kKVAtomBytes, &tm_k, &full[s], a * kAtomLanes, j * KN,
                      kv_head);
          tma_load_3d(vs + s * kKV + a * kKVAtomBytes, &tm_v, &full[s], a * kAtomLanes, j * KN,
                      kv_head);
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
    const uint32_t do_addr = smem_u32(dos) + w * 64 * kLineBytes;
    const size_t row_base = static_cast<size_t>(head) * n;

    // LSE (in log2 units) and delta of the two rows; a row >= n (the second
    // consumer where n is an odd multiple of 64) reads zeros, computes on
    // the zero rows TMA filled in, and is never stored
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      l2[r] = row < n ? lse[row_base + row] * kLog2e : 0.f;
      dl[r] = row < n ? delta[row_base + row] : 0.f;
    }

    float acc[DV / 2];  // dQ, DV / 8 chunks of 8 columns
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    uint32_t dsa[KN / 16][4];  // dS of the tile before, the A operand of its dQ product

    // S_j = Q K_j^T and dP_j = dO V_j^T (64 rows x KN keys), one wgmma group
    auto issue_sdp = [&](int j, float* st, float* dp) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const uint32_t k_addr = smem_u32(ks + s * kKV);
      const uint32_t v_addr = smem_u32(vs + s * kKV);
      fence_regs<KN / 2>(st);
      fence_regs<KN / 2>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t q_off = (kk / 4) * kDqAtomBytes + (kk % 4) * 32;
        const uint32_t k_off = (kk / 4) * kKVAtomBytes + (kk % 4) * 32;
        WgmmaSS<KN>::mma(st, sw128_desc(q_addr + q_off), sw128_desc(k_addr + k_off), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t q_off = (kk / 4) * kDqAtomBytes + (kk % 4) * 32;
        const uint32_t k_off = (kk / 4) * kKVAtomBytes + (kk % 4) * 32;
        WgmmaSS<KN>::mma(dp, sw128_desc(do_addr + q_off), sw128_desc(v_addr + k_off), kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS_j K_j, contracting over the tile's keys, its own wgmma group
    auto issue_dq = [&](int j) {
      const uint32_t k_addr = smem_u32(ks + (j % STAGES) * kKV);
      fence_regs<DV / 2>(acc);
      fence_regs<KN / 16>(dsa);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KN / 16; ++kc)
        wgmma_rs_wide<DV>(acc, dsa[kc], k_addr + kc * 16 * kLineBytes, kKVAtomBytes);
      wgmma_commit();
    };
    // P = exp2(S a2 - lse log2 e), dS = P (dP - delta), in place in dp, in
    // fp32; keys >= n and (causal) keys after the row are masked
    auto ds = [&](int j, const float* st, float* dp) {
      const int key0 = j * KN;
      const bool masked = key0 + KN > n || (causal && key0 + KN - 1 > q0);
#pragma unroll
      for (int i = 0; i < KN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(st[4 * i + e], a2, -l2[e / 2]));
          const int key = key0 + 8 * i + 2 * c + (e & 1);
          if (masked && (key >= n || (causal && key > row0 + (e / 2) * 8))) p = 0.f;
          dp[4 * i + e] = p * (dp[4 * i + e] - dl[e / 2]);
        }
      }
    };
    // done with tile j's stage
    auto release = [&](int j) {
      fence_regs<DV / 2>(acc);
      fence_regs<KN / 16>(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % STAGES]);
    };

    // B1's schedule: a consumer issues S_j, dP_j and then dQ += dS_{j-1}
    // K_{j-1} as two wgmma groups and computes dS_j while the second one
    // runs; the two consumers take turns to issue (named barriers 1 and 2),
    // so one's exp2 overlaps the other's products. Each consumer syncs
    // n_tiles + 1 times and the other arrives as often.
    auto wait_turn = [&] { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w)); };
    auto pass_turn = [&] { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w)); };
    if (w == 1) pass_turn();  // consumer 0 goes first
    mbar_wait(q_full, 0);
    {
      float st[KN / 2], dp[KN / 2];
      wait_turn();
      issue_sdp(0, st, dp);
      pass_turn();
      wgmma_wait<0>();
      fence_regs<KN / 2>(st);
      fence_regs<KN / 2>(dp);
      ds(0, st, dp);
      pack_a<KN / 16>(dsa, dp);
    }
    for (int j = 1; j < n_tiles; ++j) {
      float st[KN / 2], dp[KN / 2];
      wait_turn();
      issue_sdp(j, st, dp);
      issue_dq(j - 1);
      pass_turn();
      wgmma_wait<1>();  // S_j and dP_j are done, dQ of tile j - 1 may still run
      fence_regs<KN / 2>(st);
      fence_regs<KN / 2>(dp);
      ds(j, st, dp);
      wgmma_wait<0>();
      release(j - 1);
      pack_a<KN / 16>(dsa, dp);
    }
    wait_turn();
    issue_dq(n_tiles - 1);
    if (w == 0) pass_turn();  // consumer 1's last turn is its last sync
    wgmma_wait<0>();
    release(n_tiles - 1);

    // the softmax scale once, on the fp32 sums; lanes DV..D-1 are zeros
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= n) continue;
      __nv_bfloat16* out = dq + (row_base + row) * D;
      if constexpr (RING) {
        ring_store_row<DV>(acc, r, sm_scale, ring.acc + (row_base + row) * D, out, c, ring);
        if (!ring.last) continue;
      } else {
#pragma unroll
        for (int i = 0; i < DV / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * c) = __floats2bfloat162_rn(
              acc[4 * i + 2 * r] * sm_scale, acc[4 * i + 2 * r + 1] * sm_scale);
      }
#pragma unroll
      for (int i = DV / 8; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * i + 2 * c) = __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

using bf16 = __nv_bfloat16;

template <int D, int DV, int KN, int STAGES, bool RING>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* d_o,
                      const void* lse, const void* delta, void* dq, int bh, int n, int stages,
                      int smem, float sm_scale, int causal, const RingSum& ring,
                      cudaStream_t stream) {
  // the caller's tile plan must be the one compiled here
  if (stages != STAGES || smem != dq_smem_bytes<D, KN, STAGES>()) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!make_head_map(&tm_q, q, bh, n, D, kDqRows) || !make_head_map(&tm_do, d_o, bh, n, D, kDqRows) ||
      !make_head_map(&tm_k, k, bh, n, D, KN) || !make_head_map(&tm_v, v, bh, n, D, KN))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_kernel<D, DV, KN, STAGES, RING>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3((n + kDqRows - 1) / kDqRows, bh), kThreads, smem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), n, sm_scale, causal, ring);
  return cudaGetLastError();
}

template <int D, int DV, int KEYS, int STAGES, bool RING>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* d_o,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int n,
                       int stages, int smem, float sm_scale, int causal, const RingSum& ring,
                       cudaStream_t stream) {
  // the caller's tile plan must be the one compiled here
  if (stages != STAGES || smem != dkv_smem_bytes<D, KEYS, STAGES>()) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!make_head_map(&tm_q, q, bh, n, D, kQRows) || !make_head_map(&tm_do, d_o, bh, n, D, kQRows) ||
      !make_head_map(&tm_k, k, bh, n, D, KEYS) || !make_head_map(&tm_v, v, bh, n, D, KEYS))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_kernel<D, DV, KEYS, STAGES, RING>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3((n + KEYS - 1) / KEYS, bh), kThreads, smem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, sm_scale, causal, ring);
  return cudaGetLastError();
}

bool shape_ok(int bh, int n, int d) {
  return bh > 0 && bh <= 65535 && n > 0 && n % 64 == 0 && (d == 64 || d == 128 || d == 256);
}

template <bool RING>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* d_o,
                        const void* lse, const void* delta, void* dq, int bh, int n, int d,
                        int lanes, int stages, int smem, float sm_scale, int causal,
                        const RingSum& ring, cudaStream_t s) {
  if (!shape_ok(bh, n, d)) return cudaErrorInvalidValue;
  if (d == 64 && lanes == 64)
    return launch_dq<64, 64, kDqKeys64, 4, RING>(q, k, v, d_o, lse, delta, dq, bh, n, stages,
                                                 smem, sm_scale, causal, ring, s);
  if (d == 128 && lanes == 80)
    return launch_dq<128, 80, kDqKeys128, 4, RING>(q, k, v, d_o, lse, delta, dq, bh, n, stages,
                                                   smem, sm_scale, causal, ring, s);
  if (d == 128 && lanes == 128)
    return launch_dq<128, 128, kDqKeys128, 4, RING>(q, k, v, d_o, lse, delta, dq, bh, n, stages,
                                                    smem, sm_scale, causal, ring, s);
  if (d == 256 && lanes == 192)
    return launch_dq<256, 192, kDqKeys256, 3, RING>(q, k, v, d_o, lse, delta, dq, bh, n, stages,
                                                    smem, sm_scale, causal, ring, s);
  if (d == 256 && lanes == 256)
    return launch_dq<256, 256, kDqKeys256, 3, RING>(q, k, v, d_o, lse, delta, dq, bh, n, stages,
                                                    smem, sm_scale, causal, ring, s);
  return cudaErrorInvalidValue;
}

template <bool RING>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* d_o,
                         const void* lse, const void* delta, void* dk, void* dv, int bh, int n,
                         int d, int lanes, int stages, int smem, float sm_scale, int causal,
                         const RingSum& ring, cudaStream_t s) {
  if (!shape_ok(bh, n, d)) return cudaErrorInvalidValue;
  if (d == 64 && lanes == 64)
    return launch_dkv<64, 64, kKeysNarrow, 4, RING>(q, k, v, d_o, lse, delta, dk, dv, bh, n,
                                                    stages, smem, sm_scale, causal, ring, s);
  if (d == 128 && lanes == 80)
    return launch_dkv<128, 80, kKeysNarrow, 4, RING>(q, k, v, d_o, lse, delta, dk, dv, bh, n,
                                                     stages, smem, sm_scale, causal, ring, s);
  if (d == 128 && lanes == 128)
    return launch_dkv<128, 128, kKeysNarrow, 4, RING>(q, k, v, d_o, lse, delta, dk, dv, bh, n,
                                                      stages, smem, sm_scale, causal, ring, s);
  if (d == 256 && lanes == 192)
    return launch_dkv<256, 192, kKeysWide, 2, RING>(q, k, v, d_o, lse, delta, dk, dv, bh, n,
                                                    stages, smem, sm_scale, causal, ring, s);
  if (d == 256 && lanes == 256)
    return launch_dkv<256, 256, kKeysWide, 2, RING>(q, k, v, d_o, lse, delta, dk, dv, bh, n,
                                                    stages, smem, sm_scale, causal, ring, s);
  return cudaErrorInvalidValue;
}

// a ring hop's sums: ``acc`` (and ``acc2``) are read if read_prev and
// written unless last; the outputs are written if last
bool ring_ok(int bh, int kv_shift, int read_prev, int last, const void* out, const void* acc) {
  return kv_shift >= 0 && kv_shift < bh && (!last || out != nullptr) &&
         (!(read_prev || !last) || acc != nullptr);
}

}  // namespace

// q, k, v, d_o, dq: (bh, n, d) contiguous bf16, 16-byte aligned; lse, delta:
// (bh, n) fp32. d in {64, 128, 256}, n a multiple of 64. ``lanes``: the lanes
// computed, the true head dim rounded up to a compiled width (d, 80 at
// d = 128, 192 at d = 256); lanes lanes..d-1 of q, k, v, d_o must be zero and
// come out zero
// in dq. ``stages`` and ``smem``: the caller's tile plan
// (dfot_tpu_torch/ops/attention.py:flash_plan), checked against the compiled
// one. Returns a cudaError_t code.
extern "C" int dfot_flash_bwd_dq(const void* q, const void* k, const void* v, const void* d_o,
                                 const void* lse, const void* delta, void* dq, int bh, int n,
                                 int d, int lanes, int stages, int smem, float sm_scale,
                                 int causal, void* stream) {
  return dispatch_dq<false>(q, k, v, d_o, lse, delta, dq, bh, n, d, lanes, stages, smem,
                            sm_scale, causal, RingSum{nullptr, nullptr, 0, 0, 0},
                            static_cast<cudaStream_t>(stream));
}

// As above, with dk, dv: (bh, n, d) contiguous bf16; every (bh, n) array
// 16-byte aligned. ``dv_lanes``: the lanes computed, the true head dim rounded
// up to a compiled width (d, 80 at d = 128, 192 at d = 256); lanes
// dv_lanes..d-1 of q, k,
// v, d_o must be zero and come out zero in dk, dv. ``stages`` and ``smem``:
// the caller's tile plan (dfot_tpu_torch/ops/attention.py:flash_plan),
// checked against the compiled one.
extern "C" int dfot_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* d_o,
                                  const void* lse, const void* delta, void* dk, void* dv, int bh,
                                  int n, int d, int dv_lanes, int stages, int smem,
                                  float sm_scale, int causal, void* stream) {
  return dispatch_dkv<false>(q, k, v, d_o, lse, delta, dk, dv, bh, n, d, dv_lanes, stages, smem,
                             sm_scale, causal, RingSum{nullptr, nullptr, 0, 0, 0},
                             static_cast<cudaStream_t>(stream));
}

// One non-causal ring hop of dq, arguments as dfot_flash_bwd_dq (lse and
// delta: the query rows' final LSE and rowsum(dO * O)), with ``dq_acc`` the
// fp32 (bh, n, d) sum over hops (its first lanes read if ``read_prev``,
// written unless ``last``; null if neither) and ``dq`` (bf16) written with
// the whole sum if ``last``, else it may be null. K/V head = (query head -
// ``kv_shift``) mod bh. The plan is B4's (flash_plan "ring_dq").
extern "C" int dfot_ring_bwd_dq(const void* q, const void* k, const void* v, const void* d_o,
                                const void* lse, const void* delta, void* dq, void* dq_acc,
                                int bh, int n, int d, int lanes, int stages, int smem,
                                float sm_scale, int kv_shift, int read_prev, int last,
                                void* stream) {
  if (!ring_ok(bh, kv_shift, read_prev, last, dq, dq_acc)) return cudaErrorInvalidValue;
  const RingSum ring{static_cast<float*>(dq_acc), nullptr, kv_shift, read_prev != 0, last != 0};
  return dispatch_dq<true>(q, k, v, d_o, lse, delta, dq, bh, n, d, lanes, stages, smem, sm_scale,
                           0, ring, static_cast<cudaStream_t>(stream));
}

// One non-causal ring hop of dk, dv for the keys of every K/V head against
// the query rows of head (kv head + ``kv_shift``) mod bh, arguments as
// dfot_flash_bwd_dkv, with ``dk_acc``, ``dv_acc`` the fp32 sums over hops
// and ``dk``, ``dv`` the bf16 outputs, as dfot_ring_bwd_dq's. The plan is
// B5's (flash_plan "ring_dkv").
extern "C" int dfot_ring_bwd_dkv(const void* q, const void* k, const void* v, const void* d_o,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 void* dk_acc, void* dv_acc, int bh, int n, int d, int dv_lanes,
                                 int stages, int smem, float sm_scale, int kv_shift,
                                 int read_prev, int last, void* stream) {
  if (!ring_ok(bh, kv_shift, read_prev, last, dk, dk_acc) ||
      !ring_ok(bh, kv_shift, read_prev, last, dv, dv_acc))
    return cudaErrorInvalidValue;
  const RingSum ring{static_cast<float*>(dk_acc), static_cast<float*>(dv_acc), kv_shift,
                     read_prev != 0, last != 0};
  return dispatch_dkv<true>(q, k, v, d_o, lse, delta, dk, dv, bh, n, d, dv_lanes, stages, smem,
                            sm_scale, 0, ring, static_cast<cudaStream_t>(stream));
}
