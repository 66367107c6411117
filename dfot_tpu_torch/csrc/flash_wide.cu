// Flash attention at head dims above 256 for Hopper (sm_90a): the wide family
// of B1 (forward), B4 (dq) and B5 (dk, dv) and of their ring-hop entries.
// bf16 operands, fp32 accumulation.
//
// Replaces, at the head dims dfot_tpu/ops/attention.py gives its Pallas
// kernels past 256 (any multiple of 64, ``_blocks_ok`` :914, padded at
// :1006-1012), the TPU kernels _flash_kernel (:114, reached through
// _flash_forward), _flash_bwd_dq_kernel and _flash_bwd_dq_stream_kernel
// (:378, :423) and _flash_bwd_dkv_kernel (:500), and the ring hop
// _block_flash (dfot_tpu/ops/ring_attention.py:49) with its fold. The
// functions are those of csrc/flash_fwd.cu and csrc/flash_bwd.cu: O and the
// natural-log LSE of the scaled scores; dq = scale sum_k ds k, dk = scale
// sum_q ds^T q, dv = sum_q p^T dO with p recomputed from the saved LSE and
// delta = rowsum(dO * O) given; a ring hop folds its block into the running
// fp32 (O, LSE) or adds its gradients into fp32 sums.
//
// Bound: 4 N^2 d (forward), 3 N^2 d (dq) and 4 N^2 d (dk, dv) multiply-adds
// per (batch, head) against O(N d) bytes, so the tensor cores bound them. The
// narrow kernels keep a whole head row in registers and shared memory; past
// 256 lanes that no longer fits (the O, dQ, dK or dV accumulator of 64 rows
// already takes 128 registers a consumer thread at 256 lanes, and ptxas
// serializes wgmma past about 224), so this family tiles the head dim:
// - lane slices in the grid: a block owns 64 rows (queries for B1 and B4,
//   keys for B5) and one slice of at most 256 output lanes (4 atoms of 64)
//   of one output: O, dQ, or one of dK and dV (grid z: the slices; for B5
//   the dV slices, then the dK ones). No accumulator exceeds 128 registers a
//   thread. Each slice block recomputes the scores over the whole head, so
//   at d = 512 B1 does 6 N^2 d operations where the bound counts 4 N^2 d;
// - the scores over the whole head, in 64-lane atoms: S = Q K^T (and
//   dP = dO V^T in the backward; S^T = K Q^T and dP^T = V dO^T in B5)
//   contract over the true head dim rounded up to 16, one TMA step a 64-lane
//   atom of the streamed tile (K, or K and V; Q, or Q and dO in B5), so a
//   stage is 8 or 16 KB whatever d is. The block's own rows of the other side
//   (Q, Q and dO, K and V) are loaded once where they fit beside two stages
//   ("resident"); otherwise they come with every step (the plan's choice,
//   ops/attention.py:flash_plan). After the score atoms, the slice's atoms
//   of the output product's operand (V; K for dQ; dO for dV; Q for dK)
//   stream the same way;
// - two consumer warpgroups share each 64-row tile of the streamed side,
//   32 rows each (keys in B1 and B4, queries in B5): each keeps its own
//   partial sums (B1: its own online softmax over its keys, max and sum), and
//   at the end consumer 1 hands its partials over shared memory to consumer
//   0, which merges them (a fixed order: deterministic) and stores. A
//   producer warpgroup gives up its registers (setmaxnreg) and one thread
//   issues every TMA load through a ring of stages with full/empty mbarriers;
// - the products are wgmma: the scores shared-memory x shared-memory (m64
//   n32), the output products register-A (P, dS, P^T or dS^T rounded to bf16
//   in registers) x the transposed shared-memory operand (m64 n64 an atom).
//   Each atom's batch of products is one wgmma group behind its own fence;
//   a stage is released when the group after it has been issued and it has
//   completed (wgmma.wait_group 1);
// - only the true head dim's lanes are computed: the scores contract over it
//   rounded up to 16, the slices cover its atoms, lanes past them are written
//   as zeros (lanes of the last atom past the true head dim come out zero
//   from the operands' zero pad lanes);
// - the ring hops (RING = true): on a LocalRing the K/V head at hop s is
//   (h - s B H) mod R B H (B5: its blocks own the keys of a K/V head and
//   walk the queries of head (h + s B H) mod R B H); the forward's fold reads
//   the running LSE from one buffer and writes the new one to another, so no
//   slice block can overwrite an LSE another has not read (every slice
//   computes the same new LSE from the same scores; slice 0 stores it); the
//   O slices, and the backward's sums, are disjoint by lane. No atomics.

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace dfot;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                      // rows of a block, and of a streamed tile
constexpr int kHalf = 32;                      // a consumer's rows of a streamed tile
constexpr int kSlotBytes = kRows * kLineBytes;  // one 64-lane atom of 64 rows: 8 KB
constexpr int kSliceAtoms = 4;                 // 256 lanes: an output slice
constexpr int kThreads = 384;                  // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kMaxStages = 8;
constexpr int kAcc = kSliceAtoms * 32;         // a consumer thread's accumulator registers
// consumer 1's partials for the merge: its accumulator and (B1) two maxima
// and two sums a thread
constexpr int kMergeBytes = (kAcc + 4) * 128 * 4;
constexpr int kSmemPerBlock = 232448;
constexpr int kBarrier = 8;
constexpr float kNegInf = -1e30f;

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// The tile plan, as ops/attention.py:flash_plan computes it for the wide
// family; the C entries compute it again and refuse any other.
struct Plan {
  int atoms;       // 64-lane atoms of the computed lanes
  int ks_last;     // k16 steps of the last atom
  int slices;      // output slices of 256 lanes (B5: of dK, and as many of dV)
  int resident;    // the block's own rows of the other side loaded once
  int stages, stage_bytes, resident_bytes, smem;
};

Plan make_plan(int kind, int lanes) {
  Plan p;
  p.atoms = (lanes + kAtomLanes - 1) / kAtomLanes;
  p.ks_last = (lanes - kAtomLanes * (p.atoms - 1)) / 16;
  p.slices = (p.atoms + kSliceAtoms - 1) / kSliceAtoms;
  const int slots = kind == kFwd ? 1 : 2;  // products of a contraction step: S, or S and dP
  p.resident_bytes = slots * p.atoms * kSlotBytes;
  p.stage_bytes = slots * kSlotBytes;
  p.stages = std::min(kMaxStages, (kSmemPerBlock - 1024 - p.resident_bytes - kBarrier) /
                                      (p.stage_bytes + 2 * kBarrier));
  p.resident = p.stages >= 2;
  if (!p.resident) {
    p.resident_bytes = 0;
    p.stage_bytes = 2 * slots * kSlotBytes;
    p.stages =
        std::min(kMaxStages, (kSmemPerBlock - 1024 - kBarrier) / (p.stage_bytes + 2 * kBarrier));
  }
  p.smem = 1024 + std::max(p.resident_bytes + p.stages * p.stage_bytes, kMergeBytes) +
           kBarrier * (1 + 2 * p.stages);
  return p;
}

struct Params {
  bf16* out0;             // B1: o; B4: dq; B5: dk
  bf16* out1;             // B5: dv
  float* lse;             // B1: the LSE written (a ring hop: the new running LSE); else read
  const float* lse_prev;  // ring B1: the running LSE read
  const float* delta;     // B4, B5
  float* sum0;            // ring: the running O (B1), dq (B4) or dk (B5) sums, fp32
  float* sum1;            // ring B5: the dv sums
  int n, d, atoms, ks_last, slices, resident, stages, stage_bytes, resident_bytes;
  float sm_scale;
  int causal, kv_shift, read_prev, last;
};

// one step of the ring of stages: its slot and the parity of its round
struct RingPos {
  int slot = 0, phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// One row (r: this thread's row0 + 8 r) of the merged accumulator's slice:
// its sa atoms at lanes lane0 + 64 at + 8 i + 2 c, x = prev * ka + acc * kb
// with prev the row's fp32 running values (``sum``, read if read_prev), stored
// to ``sum`` in fp32 (to_sum) or to ``out`` in bf16, then (zero_to > zero_from)
// atoms zero_from..zero_to-1 of ``out`` zeroed. Every load comes before the
// first store (see flash_bwd.cu:ring_store_row).
__device__ __forceinline__ void store_row(const float* acc, int r, int sa, float ka, float kb,
                                          int lane0, int c, bf16* __restrict__ out,
                                          float* __restrict__ sum, bool read_prev, bool to_sum,
                                          int zero_from, int zero_to) {
  float2 prev[kSliceAtoms][8];
#pragma unroll
  for (int at = 0; at < kSliceAtoms; ++at)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      prev[at][i] = read_prev && at < sa
                        ? *reinterpret_cast<const float2*>(sum + lane0 + 64 * at + 8 * i + 2 * c)
                        : make_float2(0.f, 0.f);
#pragma unroll
  for (int at = 0; at < kSliceAtoms; ++at) {
    if (at >= sa) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = lane0 + 64 * at + 8 * i + 2 * c;
      const float x0 = fmaf(prev[at][i].x, ka, acc[32 * at + 4 * i + 2 * r] * kb);
      const float x1 = fmaf(prev[at][i].y, ka, acc[32 * at + 4 * i + 2 * r + 1] * kb);
      if (to_sum)
        *reinterpret_cast<float2*>(sum + col) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(x0, x1);
    }
  }
  for (int a = zero_from; a < zero_to; ++a)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + 64 * a + 8 * i + 2 * c) =
          __floats2bfloat162_rn(0.f, 0.f);
}

// Maps: r0, r1 the block's own side (B1: Q; B4: Q, dO; B5: K, V), s0, s1 the
// streamed side (B1: K, V; B4: K, V; B5: Q, dO); every box 64 lanes x 64 rows.
template <int KIND, bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_kernel(const __grid_constant__ CUtensorMap tm_r0,
                      const __grid_constant__ CUtensorMap tm_r1,
                      const __grid_constant__ CUtensorMap tm_s0,
                      const __grid_constant__ CUtensorMap tm_s1, const Params p) {
  // slots of a step's streamed side: the resident side's atoms follow them
  // where they are not resident
  constexpr int kS = KIND == kFwd ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  unsigned char* ring = base + p.resident_bytes;
  const int region = max(p.resident_bytes + p.stages * p.stage_bytes, kMergeBytes);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(base + region);
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + p.stages;

  const int n = p.n, A = p.atoms, stages = p.stages;
  // causal B1, B4: the longest rows first, so the short ones fill the tail
  const int rb = KIND != kDkv && p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int r0 = rb * kRows;
  const int head = blockIdx.y;
  int other = head;  // the streamed side's head
  if constexpr (RING) {
    const int bh = static_cast<int>(gridDim.y);
    other = KIND == kDkv ? head + p.kv_shift : head - p.kv_shift;
    if (other < 0) other += bh;
    if (other >= bh) other -= bh;
  }
  int slice = blockIdx.z;
  bool dk_block = false;  // B5: this block's output is dK (else dV)
  if constexpr (KIND == kDkv) {
    dk_block = slice >= p.slices;
    if (dk_block) slice -= p.slices;
  }
  const int sa = min(kSliceAtoms, A - kSliceAtoms * slice);
  // the score products of a step: S (and dP)
  const int kinds = KIND == kFwd || (KIND == kDkv && !dk_block) ? 1 : 2;
  // streamed tiles: causal B1, B4 see keys up to the block's last row; a
  // causal B5 block's keys are seen by the queries from its first key on
  int t_first = 0, n_tiles = n / kRows;
  if (p.causal) {
    if constexpr (KIND == kDkv) {
      t_first = rb;
      n_tiles -= rb;
    } else {
      n_tiles = rb + 1;
    }
  }

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < stages; ++s) {
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
      if (p.resident) {
        mbar_arrive_expect_tx(res_full, kinds * A * kSlotBytes);
        for (int a = 0; a < A; ++a)
          for (int i = 0; i < kinds; ++i)
            tma_load_3d(base + (i * A + a) * kSlotBytes, i ? &tm_r1 : &tm_r0, res_full,
                        a * kAtomLanes, r0, head);
      }
      // the output product's operand: V (B1), K (B4), dO (B5 dV), Q (B5 dK)
      const CUtensorMap* out_map =
          KIND == kFwd || (KIND == kDkv && !dk_block) ? &tm_s1 : &tm_s0;
      RingPos pos;
      for (int t = 0; t < n_tiles; ++t) {
        const int row_t = (t_first + t) * kRows;
        for (int a = 0; a < A; ++a) {
          mbar_wait(&empty[pos.slot], pos.phase ^ 1);
          unsigned char* stage = ring + pos.slot * p.stage_bytes;
          mbar_arrive_expect_tx(&full[pos.slot], kinds * kSlotBytes * (p.resident ? 1 : 2));
          for (int i = 0; i < kinds; ++i) {
            tma_load_3d(stage + i * kSlotBytes, i ? &tm_s1 : &tm_s0, &full[pos.slot],
                        a * kAtomLanes, row_t, other);
            if (!p.resident)
              tma_load_3d(stage + (kS + i) * kSlotBytes, i ? &tm_r1 : &tm_r0, &full[pos.slot],
                          a * kAtomLanes, r0, head);
          }
          pos.advance(stages);
        }
        for (int at = 0; at < sa; ++at) {
          mbar_wait(&empty[pos.slot], pos.phase ^ 1);
          mbar_arrive_expect_tx(&full[pos.slot], kSlotBytes);
          tma_load_3d(ring + pos.slot * p.stage_bytes, out_map, &full[pos.slot],
                      (kSliceAtoms * slice + at) * kAtomLanes, row_t, other);
          pos.advance(stages);
        }
      }
    }
    return;
  }

  // consumer warpgroups: both own the block's 64 rows, each half of a tile
  setmaxnreg_inc<240>();
  const int w = threadIdx.x / 128 - 1;
  const int t128 = threadIdx.x % 128;
  const int warp = t128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int row0 = r0 + warp * 16 + g;  // this thread's block rows: row0, row0 + 8
  const float a2 = p.sm_scale * kLog2e;  // exp(x * scale) = exp2(x * a2)
  const uint32_t res_a = smem_u32(base), ring_a = smem_u32(ring);
  const size_t own = static_cast<size_t>(head) * n, far = static_cast<size_t>(other) * n;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};  // B1: raw-score max, partial sums
  float l2r[2] = {0.f, 0.f}, dlr[2] = {0.f, 0.f};          // B4: the rows' LSE (log2) and delta
  if constexpr (KIND == kDq) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l2r[r] = p.lse[own + row0 + 8 * r] * kLog2e;
      dlr[r] = p.delta[own + row0 + 8 * r];
    }
  }

  auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  };

  if (p.resident) mbar_wait(res_full, 0);
  RingPos pos;
  for (int t = 0; t < n_tiles; ++t) {
    const int row_t = (t_first + t) * kRows;
    const int col0 = row_t + w * kHalf;  // this consumer's first column (key, or B5 query)
    // B5: the LSE (log2) and delta of this thread's query columns
    float2 lq[4], dq4[4];
    if constexpr (KIND == kDkv) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lq[i] = *reinterpret_cast<const float2*>(p.lse + far + col0 + 8 * i + 2 * c);
        dq4[i] = *reinterpret_cast<const float2*>(p.delta + far + col0 + 8 * i + 2 * c);
      }
    }

    // the scores over the whole head, an atom a step
    float sc[16], dp[16];
    int prev = -1;
    fence_regs<16>(sc);
    fence_regs<16>(dp);
    for (int a = 0; a < A; ++a) {
      mbar_wait(&full[pos.slot], pos.phase);
      const uint32_t stg = ring_a + pos.slot * p.stage_bytes;
      const uint32_t own0 = p.resident ? res_a + a * kSlotBytes : stg + kS * kSlotBytes;
      const uint32_t own1 = p.resident ? res_a + (A + a) * kSlotBytes : stg + (kS + 1) * kSlotBytes;
      const uint32_t far0 = stg + w * kHalf * kLineBytes;
      const uint32_t far1 = far0 + kSlotBytes;
      const int ks = a == A - 1 ? p.ks_last : 4;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < ks)
          WgmmaSS<kHalf>::mma(sc, sw128_desc(own0 + kk * 32), sw128_desc(far0 + kk * 32),
                              (a | kk) != 0);
      if (kinds == 2) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks)
            WgmmaSS<kHalf>::mma(dp, sw128_desc(own1 + kk * 32), sw128_desc(far1 + kk * 32),
                                (a | kk) != 0);
      }
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = pos.slot;
      pos.advance(stages);
    }
    wgmma_wait<0>();
    fence_regs<16>(sc);
    fence_regs<16>(dp);
    release(prev);

    // the A operand of the output product, in fp32 in sc
    if constexpr (KIND == kFwd) {
      // online softmax over this consumer's keys; keys after the row masked
      const bool masked = p.causal && col0 + kHalf - 1 > r0;
      float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (masked && col0 + 8 * i + 2 * c + (e & 1) > row0 + 8 * (e / 2))
            sc[4 * i + e] = kNegInf;
          mx[e / 2] = fmaxf(mx[e / 2], sc[4 * i + e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m_i[r] - mx[r]) * a2);
        m_i[r] = mx[r];
        l_i[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score is 0 even where the row has no key yet (max -inf)
          float pv = exp2f(fmaf(sc[4 * i + e], a2, -mx[e / 2] * a2));
          if (sc[4 * i + e] == kNegInf) pv = 0.f;
          sc[4 * i + e] = pv;
          l_i[e / 2] += pv;
        }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] *= alpha[(i % 4) / 2];
    } else if constexpr (KIND == kDq) {
      const bool masked = p.causal && col0 + kHalf - 1 > r0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = exp2f(fmaf(sc[4 * i + e], a2, -l2r[e / 2]));
          if (masked && col0 + 8 * i + 2 * c + (e & 1) > row0 + 8 * (e / 2)) pv = 0.f;
          sc[4 * i + e] = pv * (dp[4 * i + e] - dlr[e / 2]);
        }
    } else {
      // rows are keys, columns queries: a query before the key is masked
      const bool masked = p.causal && col0 < r0 + kRows - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_q = (e & 1) ? lq[i].y : lq[i].x;
          const float dd = (e & 1) ? dq4[i].y : dq4[i].x;
          float pv = exp2f(fmaf(sc[4 * i + e], a2, -lse_q * kLog2e));
          if (masked && col0 + 8 * i + 2 * c + (e & 1) < row0 + 8 * (e / 2)) pv = 0.f;
          sc[4 * i + e] = dk_block ? pv * (dp[4 * i + e] - dd) : pv;
        }
    }
    uint32_t pa[2][4];
    pack_a<2>(pa, sc);
    fence_regs<2>(pa);

    // the output product, an atom of the slice a step: this consumer's 32
    // rows of the streamed operand, contracted with its 32 columns of pa
    prev = -1;
#pragma unroll
    for (int at = 0; at < kSliceAtoms; ++at) {
      if (at < sa) {
        mbar_wait(&full[pos.slot], pos.phase);
        const uint32_t b = ring_a + pos.slot * p.stage_bytes + w * kHalf * kLineBytes;
        fence_regs<32>(acc + 32 * at);
        wgmma_fence();
        WgmmaRS<64>::mma(acc + 32 * at, pa[0], sw128_desc(b), 1);
        WgmmaRS<64>::mma(acc + 32 * at, pa[1], sw128_desc(b + 16 * kLineBytes), 1);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = pos.slot;
        pos.advance(stages);
      }
    }
    wgmma_wait<0>();
    fence_regs<kAcc>(acc);
    fence_regs<2>(pa);
    release(prev);
  }

  // every product of both consumers is done and every load has landed: the
  // shared memory is free for consumer 1's partials
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float* mbuf = reinterpret_cast<float*>(base);
  if (w == 1) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      if (i / 32 < sa) mbuf[i * 128 + t128] = acc[i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mbuf[(kAcc + r) * 128 + t128] = m_i[r];
      mbuf[(kAcc + 2 + r) * 128 + t128] = l_i[r];
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (w == 1) return;

  // consumer 0 merges, in a fixed order, and stores
  if constexpr (KIND == kFwd) {
    float c0[2], c1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = mbuf[(kAcc + r) * 128 + t128];
      const float mx = fmaxf(m_i[r], m1);
      c0[r] = exp2f((m_i[r] - mx) * a2);
      c1[r] = exp2f((m1 - mx) * a2);
      l_i[r] = l_i[r] * c0[r] + mbuf[(kAcc + 2 + r) * 128 + t128] * c1[r];
      m_i[r] = mx;
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      if (i / 32 < sa) acc[i] = acc[i] * c0[(i % 4) / 2] + mbuf[i * 128 + t128] * c1[(i % 4) / 2];
  } else {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      if (i / 32 < sa) acc[i] += mbuf[i * 128 + t128];
  }

  const int D = p.d, lane0 = kSliceAtoms * kAtomLanes * slice;
  // the last slice also zeroes the atoms past the computed ones
  const bool tail = slice == p.slices - 1;
  const int zero_from = tail ? A : 0, zero_to = tail ? D / kAtomLanes : 0;
  bf16* out = KIND == kDkv && !dk_block ? p.out1 : p.out0;
  float* sums = KIND == kDkv && !dk_block ? p.sum1 : p.sum0;
  const float scale = KIND == kFwd || (KIND == kDkv && !dk_block) ? 1.f : p.sm_scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = own + row0 + 8 * r;
    if constexpr (KIND == kFwd) {
      const float lse_b = m_i[r] * p.sm_scale + logf(l_i[r]);
      float lse_new = lse_b, ka = 0.f, kb = 1.f / l_i[r];
      if (RING && p.read_prev) {
        const float lp = p.lse_prev[row];
        const float mx = fmaxf(lp, lse_b);
        lse_new = mx + logf(expf(lp - mx) + expf(lse_b - mx));
        ka = expf(lp - lse_new);
        kb = expf(lse_b - lse_new) / l_i[r];
      }
      const bool to_sum = RING && !p.last;
      store_row(acc, r, sa, ka, kb, lane0, c, out + row * D, RING ? p.sum0 + row * D : nullptr,
                RING && p.read_prev, to_sum, to_sum ? 0 : zero_from, to_sum ? 0 : zero_to);
      if (slice == 0 && c == 0 && p.lse != nullptr) p.lse[row] = lse_new;
    } else {
      const bool to_sum = RING && !p.last;
      store_row(acc, r, sa, 1.f, scale, lane0, c, out + row * D,
                RING ? sums + row * D : nullptr, RING && p.read_prev, to_sum,
                to_sum ? 0 : zero_from, to_sum ? 0 : zero_to);
    }
  }
}

template <int KIND, bool RING>
cudaError_t launch(const void* r0, const void* r1, const void* s0, const void* s1, Params p,
                   int bh, int lanes, int stages, int smem, int resident, cudaStream_t stream) {
  const int n = p.n, d = p.d;
  if (bh <= 0 || bh > 65535 || n <= 0 || n % kRows != 0 || d <= 256 || d % kAtomLanes != 0 ||
      lanes <= 0 || lanes % 16 != 0 || lanes > d)
    return cudaErrorInvalidValue;
  const Plan plan = make_plan(KIND, lanes);
  // the caller's tile plan must be the one computed here
  if (plan.stages != stages || plan.smem != smem || plan.resident != (resident != 0))
    return cudaErrorInvalidValue;
  p.atoms = plan.atoms;
  p.ks_last = plan.ks_last;
  p.slices = plan.slices;
  p.resident = plan.resident;
  p.stages = plan.stages;
  p.stage_bytes = plan.stage_bytes;
  p.resident_bytes = plan.resident_bytes;
  CUtensorMap maps[4];
  const void* ptrs[4] = {r0, r1, s0, s1};
  for (int i = 0; i < 4; ++i)
    if (!make_head_map(&maps[i], ptrs[i], bh, n, d, kRows)) return cudaErrorInvalidValue;
  auto kernel = flash_wide_kernel<KIND, RING>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n / kRows, bh, KIND == kDkv ? 2 * plan.slices : plan.slices);
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

Params params(int n, int d, float sm_scale, int causal) {
  Params p{};
  p.n = n;
  p.d = d;
  p.sm_scale = sm_scale;
  p.causal = causal;
  return p;
}

// a ring hop's sums: read if read_prev and written unless last; the outputs
// are written if last
bool ring_ok(int bh, int kv_shift, int read_prev, int last, const void* out, const void* sum) {
  return kv_shift >= 0 && kv_shift < bh && (!last || out != nullptr) &&
         (!(read_prev || !last) || sum != nullptr);
}

}  // namespace

// q, k, v, o: (bh, n, d) contiguous bf16, 16-byte aligned; lse: (bh, n) fp32
// or null. d a multiple of 64 above 256, n a multiple of 64. ``lanes``: the
// lanes computed, the true head dim rounded up to 16; lanes past it of q, k,
// v must be zero and come out zero in o. ``stages``, ``smem`` and
// ``resident``: the caller's tile plan (dfot_tpu_torch/ops/attention.py:
// flash_plan), checked against the one computed here. Returns a cudaError_t.
extern "C" int dfot_flash_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int bh, int n, int d, int lanes, int stages,
                                   int smem, int resident, float sm_scale, int causal,
                                   void* stream) {
  Params p = params(n, d, sm_scale, causal);
  p.out0 = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  return launch<kFwd, false>(q, q, k, v, p, bh, lanes, stages, smem, resident,
                             static_cast<cudaStream_t>(stream));
}

// dq of the wide family, arguments as dfot_flash_fwd_wide with lse, delta
// (bh, n) fp32 (the saved LSE and rowsum(dO * O)), d_o and dq as q.
extern "C" int dfot_flash_bwd_dq_wide(const void* q, const void* k, const void* v,
                                      const void* d_o, const void* lse, const void* delta,
                                      void* dq, int bh, int n, int d, int lanes, int stages,
                                      int smem, int resident, float sm_scale, int causal,
                                      void* stream) {
  Params p = params(n, d, sm_scale, causal);
  p.out0 = static_cast<bf16*>(dq);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  return launch<kDq, false>(q, d_o, k, v, p, bh, lanes, stages, smem, resident,
                            static_cast<cudaStream_t>(stream));
}

// dk, dv of the wide family, arguments as dfot_flash_bwd_dq_wide.
extern "C" int dfot_flash_bwd_dkv_wide(const void* q, const void* k, const void* v,
                                       const void* d_o, const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int n, int d, int lanes,
                                       int stages, int smem, int resident, float sm_scale,
                                       int causal, void* stream) {
  Params p = params(n, d, sm_scale, causal);
  p.out0 = static_cast<bf16*>(dk);
  p.out1 = static_cast<bf16*>(dv);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  return launch<kDkv, false>(k, v, q, d_o, p, bh, lanes, stages, smem, resident,
                             static_cast<cudaStream_t>(stream));
}

// One non-causal ring hop of the wide forward, arguments as dfot_flash_fwd_wide,
// with ``lse_prev`` the running LSE read (if ``read_prev``), ``lse`` the new
// one written (another buffer: the hop's slice blocks all read the old one),
// ``o_acc`` the running O (bh, n, d) fp32 (its computed lanes read if
// ``read_prev``, written unless ``last``) and ``o`` (bf16) written with the
// hop's result if ``last``. K/V head = (query head - ``kv_shift``) mod bh.
extern "C" int dfot_ring_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                  const void* lse_prev, void* lse, void* o_acc, int bh, int n,
                                  int d, int lanes, int stages, int smem, int resident,
                                  float sm_scale, int kv_shift, int read_prev, int last,
                                  void* stream) {
  if (!ring_ok(bh, kv_shift, read_prev, last, o, o_acc) || lse == nullptr ||
      (read_prev && (lse_prev == nullptr || lse_prev == lse)))
    return cudaErrorInvalidValue;
  Params p = params(n, d, sm_scale, 0);
  p.out0 = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.lse_prev = static_cast<const float*>(lse_prev);
  p.sum0 = static_cast<float*>(o_acc);
  p.kv_shift = kv_shift;
  p.read_prev = read_prev != 0;
  p.last = last != 0;
  return launch<kFwd, true>(q, q, k, v, p, bh, lanes, stages, smem, resident,
                            static_cast<cudaStream_t>(stream));
}

// One non-causal ring hop of the wide dq, arguments as dfot_flash_bwd_dq_wide,
// with ``dq_acc`` the fp32 sum over hops and ``dq`` (bf16) written with it at
// the ``last`` hop, as dfot_ring_bwd_dq's.
extern "C" int dfot_ring_bwd_dq_wide(const void* q, const void* k, const void* v,
                                     const void* d_o, const void* lse, const void* delta,
                                     void* dq, void* dq_acc, int bh, int n, int d, int lanes,
                                     int stages, int smem, int resident, float sm_scale,
                                     int kv_shift, int read_prev, int last, void* stream) {
  if (!ring_ok(bh, kv_shift, read_prev, last, dq, dq_acc)) return cudaErrorInvalidValue;
  Params p = params(n, d, sm_scale, 0);
  p.out0 = static_cast<bf16*>(dq);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.sum0 = static_cast<float*>(dq_acc);
  p.kv_shift = kv_shift;
  p.read_prev = read_prev != 0;
  p.last = last != 0;
  return launch<kDq, true>(q, d_o, k, v, p, bh, lanes, stages, smem, resident,
                           static_cast<cudaStream_t>(stream));
}

// One non-causal ring hop of the wide dk, dv for the keys of every K/V head
// against the query rows of head (kv head + ``kv_shift``) mod bh, arguments
// as dfot_flash_bwd_dkv_wide, with the sums as dfot_ring_bwd_dkv's.
extern "C" int dfot_ring_bwd_dkv_wide(const void* q, const void* k, const void* v,
                                      const void* d_o, const void* lse, const void* delta,
                                      void* dk, void* dv, void* dk_acc, void* dv_acc, int bh,
                                      int n, int d, int lanes, int stages, int smem,
                                      int resident, float sm_scale, int kv_shift,
                                      int read_prev, int last, void* stream) {
  if (!ring_ok(bh, kv_shift, read_prev, last, dk, dk_acc) ||
      !ring_ok(bh, kv_shift, read_prev, last, dv, dv_acc))
    return cudaErrorInvalidValue;
  Params p = params(n, d, sm_scale, 0);
  p.out0 = static_cast<bf16*>(dk);
  p.out1 = static_cast<bf16*>(dv);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.sum0 = static_cast<float*>(dk_acc);
  p.sum1 = static_cast<float*>(dv_acc);
  p.kv_shift = kv_shift;
  p.read_prev = read_prev != 0;
  p.last = last != 0;
  return launch<kDkv, true>(k, v, q, d_o, p, bh, lanes, stages, smem, resident,
                            static_cast<cudaStream_t>(stream));
}
