// Flash attention at head dims above 256 for Hopper (sm_90a): the wide family
// of B1 (forward), B4 (dq) and B5 (dk, dv) and of their ring-hop entries.
// bf16 operands, fp32 accumulation.
//
// Replaces, at the head dims dfot_tpu/ops/attention.py gives its Pallas
// kernels past 256 (any multiple of 64, ``_blocks_ok`` :914, padded at
// :1006-1012), the TPU kernels _flash_kernel and _flash_kernel_pvt (:114,
// :183, reached through _flash_forward :275), _flash_bwd_dq_kernel and
// _flash_bwd_dq_stream_kernel (:378, :423) and _flash_bwd_dkv_kernel (:500),
// and the ring hop _block_flash (dfot_tpu/ops/ring_attention.py:49) with its
// fold. The functions are those of csrc/flash_fwd.cu and csrc/flash_bwd.cu:
// O and the natural-log LSE of the scaled scores; dq = scale sum_k ds k,
// dk = scale sum_q ds^T q, dv = sum_q p^T dO with p recomputed from the
// saved LSE and delta = rowsum(dO * O) given; a ring hop folds its block
// into the running fp32 (O, LSE) or adds its gradients into fp32 sums.
//
// Bound: 4 N^2 d (forward), 3 N^2 d (dq) and 4 N^2 d (dk, dv) multiply-adds
// per (batch, head) against O(N d) bytes, so the tensor cores bound them. The
// narrow kernels keep a whole head row in registers and shared memory; past
// 256 lanes that no longer fits (the O, dQ, dK or dV accumulator of 64 rows
// takes 128 registers a consumer thread at 256 lanes, and ptxas serializes
// wgmma past about 224), so a block owns 64 rows and streams the whole other
// side of the head through shared memory. On the card the forward waits on
// neither its loads (a variant that loads nothing takes as long) nor L2: it
// waits on its own products. The scores read both operands from shared memory
// (m64 n64 k16: 4 KB a step, the SM's 128 bytes a clock), and the exchange of
// partial scores and the softmax leave the tensor cores idle between them. So
// its design computes each score once and keeps its products asynchronous:
//
// The forward (flash_wide_fwd_kernel; B1 and its ring entry):
// - a block owns 64 query rows and an output slice of up to 512 lanes (8
//   atoms of 64; grid z: the slices, one at every head up to 512 lanes), and
//   each of its two consumer warpgroups keeps O for its share of the slice's
//   atoms (at most 4: 128 registers a thread);
// - the scores of a 64-key tile are contracted over the head's 64-lane atoms
//   split between the consumers, each into a partial m64 n64 tile; the two
//   partials are exchanged through shared memory (2 x 16 KB) between named
//   barriers and both consumers add them as S0 + S1, so both hold the same
//   scores, maxima, sums and P bit for bit and normalise their halves of O
//   alike. The split balances the two consumers' products (an atom of either
//   product is 4 k16 steps of n64). Whole atoms, each behind a fence of its
//   own, keep every product out of a branch of its batch, where ptxas would
//   serialize them all (its note C7520); the lanes past the true head dim
//   are zeros, so the last atom's pad steps add nothing;
// - Q is loaded once where it fits beside the exchange and two one-atom
//   stages (every head up to 1408 lanes), else its atoms come with K's; each
//   key tile streams K (every computed atom), then V (the slice's atoms),
//   through a ring of stages of up to 8 atoms (64 KB) with full/empty
//   mbarriers, one producer thread issuing TMA; a tile wider than a stage
//   takes several;
// - the online softmax runs on both consumers alike (a running max of the
//   raw scores, exp2), P is rounded to bf16 in registers and is the register
//   A operand of O += P V (m64 n64 an atom, V in its natural layout as the
//   transposed B operand); only the true head dim's lanes are computed and
//   lanes past them are written as zeros;
// - a ring hop folds (O, LSE) in the epilogue, the running LSE read from one
//   buffer and the new one written to another (the slices of a row past 512
//   lanes all read the old one), O's lanes each read before being written.
//
// The backward (flash_wide_kernel; B4, B5 and their ring entries):
// - lane slices in the grid: a block owns 64 rows (queries for B4, keys for
//   B5) and one slice of at most 256 output lanes (4 atoms) of dQ, or of one
//   of dK and dV (grid z: the dV slices, then the dK ones); each slice block
//   recomputes the scores over the whole head;
// - the scores over the whole head, in 64-lane atoms: S = Q K^T and dP = dO
//   V^T (S^T = K Q^T and dP^T = V dO^T in B5) contract over the true head dim
//   rounded up to 16, one TMA step a 64-lane atom of the streamed tiles (K
//   and V; Q and dO in B5), so a stage is 16 KB whatever d is. The block's
//   own rows of the other side (Q and dO, K and V) are loaded once where they
//   fit beside two stages ("resident"), otherwise they come with every step.
//   After the score atoms, the slice's atoms of the output product's operand
//   (K for dQ; dO for dV; Q for dK) stream the same way;
// - two consumer warpgroups share each 64-row tile of the streamed side, 32
//   rows each (keys in B4, queries in B5), each keeping its own partial sums;
//   at the end consumer 1 hands its partials over shared memory to consumer
//   0, which adds them (a fixed order: deterministic) and stores;
// - the score products are wgmma shared-memory x shared-memory (m64 n32), the
//   output products register-A (dS, P^T or dS^T rounded to bf16 in registers)
//   x the transposed shared-memory operand (m64 n64 an atom); a stage is
//   released when the group after it has been issued and it has completed;
// - the ring hops: on a LocalRing the K/V head at hop s is (h - s B H) mod R B
//   H (B5: its blocks own the keys of a K/V head and walk the queries of head
//   (h + s B H) mod R B H); the sums are disjoint by lane. No atomics.

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace dfot;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                      // rows of a block, and of a streamed tile
constexpr int kHalf = 32;                      // B4, B5: a consumer's rows of a streamed tile
constexpr int kSlotBytes = kRows * kLineBytes;  // one 64-lane atom of 64 rows: 8 KB
constexpr int kSliceAtoms = 4;                 // B4, B5: 256 lanes, an output slice
constexpr int kThreads = 384;                  // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kMaxStages = 8;
constexpr int kAcc = kSliceAtoms * 32;         // a consumer thread's accumulator registers
// B4, B5: consumer 1's partials for the merge, its accumulator
constexpr int kMergeBytes = kAcc * 128 * 4;
constexpr int kSmemPerBlock = 232448;
constexpr int kBarrier = 8;
constexpr float kNegInf = -1e30f;
// the forward: 8 atoms (512 lanes) an output slice, of which a consumer owns
// at most kSliceAtoms; a stage holds at most 8 atoms; both consumers'
// partial 64 x 64 fp32 scores
constexpr int kFwdSliceAtoms = 8;
constexpr int kStageAtoms = 8;
constexpr int kExchangeBytes = 32768;  // 2 x 64 x 64 x 4

enum Kind { kDq = 1, kDkv = 2 };

// The backward's tile plan, as ops/attention.py:flash_plan computes it for
// the wide family; the C entries compute it again and refuse any other.
struct Plan {
  int atoms;       // 64-lane atoms of the computed lanes
  int ks_last;     // k16 steps of the last atom
  int slices;      // output slices of 256 lanes (B5: of dK, and as many of dV)
  int resident;    // the block's own rows of the other side loaded once
  int stages, stage_bytes, resident_bytes, smem;
};

Plan make_plan(int lanes) {
  Plan p;
  p.atoms = (lanes + kAtomLanes - 1) / kAtomLanes;
  p.ks_last = (lanes - kAtomLanes * (p.atoms - 1)) / 16;
  p.slices = (p.atoms + kSliceAtoms - 1) / kSliceAtoms;
  constexpr int slots = 2;  // products of a contraction step: S and dP
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

// The forward's tile plan (ops/attention.py:_wide_fwd_plan computes it too):
// Q resident where it fits beside the exchange and two one-atom stages,
// stages of as many atoms (of K, and of Q's where Q streams) as let two fit,
// at most kStageAtoms and the computed atoms, and as many stages as fit.
struct FwdPlan {
  int atoms;           // 64-lane atoms of the computed lanes
  int slices;          // output slices of 512 lanes
  int resident;        // Q loaded once
  int stage_atoms;     // atoms of K (with Q's alongside, where it streams) or of V a stage
  int stages, stage_bytes, resident_bytes, smem;
};

FwdPlan make_fwd_plan(int lanes) {
  FwdPlan p;
  p.atoms = (lanes + kAtomLanes - 1) / kAtomLanes;
  p.slices = (p.atoms + kFwdSliceAtoms - 1) / kFwdSliceAtoms;
  const int room = kSmemPerBlock - 1024 - kExchangeBytes - kBarrier * (1 + 2 * kMaxStages);
  p.resident = room - p.atoms * kSlotBytes >= 2 * kSlotBytes;
  p.resident_bytes = p.resident ? p.atoms * kSlotBytes : 0;
  const int unit = p.resident ? kSlotBytes : 2 * kSlotBytes;  // a stage's bytes an atom of K
  p.stage_atoms =
      std::min(std::min(kStageAtoms, p.atoms), (room - p.resident_bytes) / (2 * unit));
  p.stage_bytes = p.stage_atoms * unit;
  p.stages = std::min(kMaxStages, (room - p.resident_bytes) / p.stage_bytes);
  p.smem = 1024 + p.resident_bytes + kExchangeBytes + p.stages * p.stage_bytes +
           kBarrier * (1 + 2 * p.stages);
  return p;
}

// The forward's split of a slice's ``sa`` O atoms and the head's ``atoms``
// score atoms between the consumers: consumer 0 owns O atoms [0, a0) of the
// slice and score atoms [0, t0), consumer 1 the rest; a0 = ceil(sa / 2), and
// t0 gives both as even a count of atoms as it can (each is 4 k16 steps of
// n64 products in either product; ops/attention.py:wide_fwd_split).
__host__ __device__ inline void fwd_split(int sa, int atoms, int* a0, int* t0) {
  *a0 = (sa + 1) / 2;
  const int twice = atoms + sa - 2 * *a0;
  *t0 = twice <= 0 ? 0 : twice / 2 < atoms ? twice / 2 : atoms;
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
  int stage_atoms;        // B1: atoms a stage
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

// The backward. Maps: r0, r1 the block's own side (B4: Q, dO; B5: K, V), s0,
// s1 the streamed side (B4: K, V; B5: Q, dO); every box 64 lanes x 64 rows.
template <int KIND, bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_kernel(const __grid_constant__ CUtensorMap tm_r0,
                      const __grid_constant__ CUtensorMap tm_r1,
                      const __grid_constant__ CUtensorMap tm_s0,
                      const __grid_constant__ CUtensorMap tm_s1, const Params p) {
  // slots of a step's streamed side: the resident side's atoms follow them
  // where they are not resident
  constexpr int kS = 2;
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
  // the score products of a step: S and dP (a dV block: S alone)
  const int kinds = KIND == kDkv && !dk_block ? 1 : 2;
  // streamed tiles: a causal B4 block sees keys up to its last row; a
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
      // the output product's operand: K (B4), dO (B5 dV), Q (B5 dK)
      const CUtensorMap* out_map = KIND == kDkv && !dk_block ? &tm_s1 : &tm_s0;
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
  float l2r[2] = {0.f, 0.f}, dlr[2] = {0.f, 0.f};  // B4: the rows' LSE (log2) and delta
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
    if constexpr (KIND == kDq) {
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
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (w == 1) return;

  // consumer 0 merges, in a fixed order, and stores
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
    if (i / 32 < sa) acc[i] += mbuf[i * 128 + t128];

  const int D = p.d, lane0 = kSliceAtoms * kAtomLanes * slice;
  // the last slice also zeroes the atoms past the computed ones
  const bool tail = slice == p.slices - 1;
  const int zero_from = tail ? A : 0, zero_to = tail ? D / kAtomLanes : 0;
  bf16* out = KIND == kDkv && !dk_block ? p.out1 : p.out0;
  float* sums = KIND == kDkv && !dk_block ? p.sum1 : p.sum0;
  const float scale = KIND == kDkv && !dk_block ? 1.f : p.sm_scale;
  const bool to_sum = RING && !p.last;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = own + row0 + 8 * r;
    store_row(acc, r, sa, 1.f, scale, lane0, c, out + row * D, RING ? sums + row * D : nullptr,
              RING && p.read_prev, to_sum, to_sum ? 0 : zero_from, to_sum ? 0 : zero_to);
  }
}

// The forward: Q (where it streams, its atoms come with K's: tm_q read at
// every key tile), K, V; every box 64 lanes x 64 rows.
template <bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);  // Q where resident
  float* xchg = reinterpret_cast<float*>(base + p.resident_bytes);
  unsigned char* ring = base + p.resident_bytes + kExchangeBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + p.stages * p.stage_bytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + p.stages;

  const int n = p.n, A = p.atoms, SA = p.stage_atoms, stages = p.stages;
  // causal: the longest rows first, so the short ones fill the tail
  const int rb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int r0 = rb * kRows;
  const int head = blockIdx.y, slice = blockIdx.z;
  int kv = head;  // K/V head
  if constexpr (RING) {
    kv -= p.kv_shift;
    if (kv < 0) kv += static_cast<int>(gridDim.y);
  }
  const int sa = min(kFwdSliceAtoms, A - kFwdSliceAtoms * slice);  // the slice's atoms
  int a0, t0;
  fwd_split(sa, A, &a0, &t0);
  // causal: the block's last row sees keys up to r0 + 63
  const int n_tiles = p.causal ? rb + 1 : n / kRows;
  const int k_stages = (A + SA - 1) / SA, v_stages = (sa + SA - 1) / SA;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
        mbar_arrive_expect_tx(q_full, A * kSlotBytes);
        for (int a = 0; a < A; ++a)
          tma_load_3d(base + a * kSlotBytes, &tm_q, q_full, a * kAtomLanes, r0, head);
      }
      RingPos pos;
      for (int t = 0; t < n_tiles; ++t) {
        const int key0 = t * kRows;
        for (int st = 0; st < k_stages; ++st) {
          const int lo = st * SA, hi = min(lo + SA, A);
          mbar_wait(&empty[pos.slot], pos.phase ^ 1);
          unsigned char* stage = ring + pos.slot * p.stage_bytes;
          mbar_arrive_expect_tx(&full[pos.slot], (hi - lo) * kSlotBytes * (p.resident ? 1 : 2));
          for (int a = lo; a < hi; ++a) {
            tma_load_3d(stage + (a - lo) * kSlotBytes, &tm_k, &full[pos.slot], a * kAtomLanes,
                        key0, kv);
            if (!p.resident)
              tma_load_3d(stage + (SA + a - lo) * kSlotBytes, &tm_q, &full[pos.slot],
                          a * kAtomLanes, r0, head);
          }
          pos.advance(stages);
        }
        for (int st = 0; st < v_stages; ++st) {
          const int lo = st * SA, hi = min(lo + SA, sa);
          mbar_wait(&empty[pos.slot], pos.phase ^ 1);
          unsigned char* stage = ring + pos.slot * p.stage_bytes;
          mbar_arrive_expect_tx(&full[pos.slot], (hi - lo) * kSlotBytes);
          for (int a = lo; a < hi; ++a)
            tma_load_3d(stage + (a - lo) * kSlotBytes, &tm_v, &full[pos.slot],
                        (kFwdSliceAtoms * slice + a) * kAtomLanes, key0, kv);
          pos.advance(stages);
        }
      }
    }
    return;
  }

  // consumer warpgroups: both own the block's 64 rows; consumer w the score
  // atoms [k_lo, k_hi) and the slice's O atoms [v_lo, v_hi)
  setmaxnreg_inc<240>();
  const int w = threadIdx.x / 128 - 1;
  const int t128 = threadIdx.x % 128;
  const int warp = t128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float a2 = p.sm_scale * kLog2e;  // exp(x * scale) = exp2(x * a2)
  const int k_lo = w ? t0 : 0, k_hi = w ? A : t0;
  const int v_lo = w ? a0 : 0, v_hi = w ? sa : a0;
  const uint32_t q_a = smem_u32(base), ring_a = smem_u32(ring);
  float* mine = xchg + w * kRows * kRows;
  const float* theirs = xchg + (1 - w) * kRows * kRows;

  auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  };

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};  // raw-score max, partial sums
  uint32_t pa[4][4];

  if (p.resident) mbar_wait(q_full, 0);
  RingPos pos;
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * kRows;
    // this consumer's partial scores over its atoms of every K stage: whole
    // atoms, accumulating into a zeroed tile, each atom's 4 k16 steps behind
    // a fence of their own and committed as a group right after them, the
    // stage released once its groups are done. A group that could be empty
    // (a commit after a branch or a loop that issued nothing) makes ptxas
    // serialize every product of the kernel (its note C7520). The lanes past
    // the true head dim are zeros in Q and K, so the last atom's pad steps
    // add nothing
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs<32>(sc);
    for (int st = 0; st < k_stages; ++st) {
      const int lo = st * SA, hi = min(lo + SA, A);
      mbar_wait(&full[pos.slot], pos.phase);
      const uint32_t stg = ring_a + pos.slot * p.stage_bytes;
#pragma unroll 1
      for (int a = max(lo, k_lo); a < min(hi, k_hi); ++a) {
        const uint32_t qd = p.resident ? q_a + a * kSlotBytes : stg + (SA + a - lo) * kSlotBytes;
        const uint32_t kd = stg + (a - lo) * kSlotBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaSS<64>::mma(sc, sw128_desc(qd + kk * 32), sw128_desc(kd + kk * 32), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      release(pos.slot);
      pos.advance(stages);
    }
    fence_regs<32>(sc);

    // the exchange: S = S0 + S1 on both consumers, the same bits
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the other has read my last partial
#pragma unroll
    for (int i = 0; i < 32; ++i) mine[i * 128 + t128] = sc[i];
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float other = theirs[i * 128 + t128];
      sc[i] = w == 0 ? sc[i] + other : other + sc[i];
    }

    // online softmax; keys after the row masked (causal, the diagonal tile)
    if (p.causal && key0 + kRows - 1 > r0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * i + 2 * c + (e & 1) > row0 + 8 * (e / 2)) sc[4 * i + e] = kNegInf;
    }
    float mx[2] = {m_i[0], m_i[1]}, alpha[2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
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
    for (int i = 0; i < 8; ++i) {
      sc[4 * i + 0] = exp2f(fmaf(sc[4 * i + 0], a2, -mb0));
      sc[4 * i + 1] = exp2f(fmaf(sc[4 * i + 1], a2, -mb0));
      sc[4 * i + 2] = exp2f(fmaf(sc[4 * i + 2], a2, -mb1));
      sc[4 * i + 3] = exp2f(fmaf(sc[4 * i + 3], a2, -mb1));
      l_i[0] += sc[4 * i] + sc[4 * i + 1];
      l_i[1] += sc[4 * i + 2] + sc[4 * i + 3];
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha[(i % 4) / 2];
    pack_a<4>(pa, sc);

    // O += P V on this consumer's atoms of every V stage, each atom's
    // products behind a fence of their own in their branch and committed
    // there; the accumulator and P pinned once, before the first product
    // (pinning an atom's registers inside the stage loop would read
    // registers a product of the stage before may still write)
    fence_regs<kAcc>(acc);
    fence_regs<4>(pa);
    for (int st = 0; st < v_stages; ++st) {
      const int lo = st * SA, hi = min(lo + SA, sa);
      mbar_wait(&full[pos.slot], pos.phase);
      const uint32_t stg = ring_a + pos.slot * p.stage_bytes;
#pragma unroll
      for (int at = 0; at < kSliceAtoms; ++at) {
        const int a = v_lo + at;  // the slice's atom
        if (a < v_hi && a >= lo && a < hi) {
          const uint32_t b = stg + (a - lo) * kSlotBytes;
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < 4; ++kc)
            WgmmaRS<64>::mma(acc + 32 * at, pa[kc], sw128_desc(b + kc * 16 * kLineBytes), 1);
          wgmma_commit();
        }
      }
      wgmma_wait<0>();
      release(pos.slot);
      pos.advance(stages);
    }
    fence_regs<kAcc>(acc);
    fence_regs<4>(pa);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  const int D = p.d, lane0 = kAtomLanes * (kFwdSliceAtoms * slice + v_lo);
  // consumer 1 of the last slice also zeroes the atoms past the computed ones
  const bool tail = w == 1 && slice == p.slices - 1;
  const int zero_from = tail ? A : 0, zero_to = tail ? D / kAtomLanes : 0;
  const size_t own = static_cast<size_t>(head) * n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = own + row0 + 8 * r;
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
    store_row(acc, r, v_hi - v_lo, ka, kb, lane0, c, p.out0 + row * D,
              RING ? p.sum0 + row * D : nullptr, RING && p.read_prev, to_sum,
              to_sum ? 0 : zero_from, to_sum ? 0 : zero_to);
    if (slice == 0 && w == 0 && c == 0 && p.lse != nullptr) p.lse[row] = lse_new;
  }
}

template <int KIND, bool RING>
cudaError_t launch(const void* r0, const void* r1, const void* s0, const void* s1, Params p,
                   int bh, int lanes, int stages, int smem, int resident, cudaStream_t stream) {
  const int n = p.n, d = p.d;
  if (bh <= 0 || bh > 65535 || n <= 0 || n % kRows != 0 || d <= 256 || d % kAtomLanes != 0 ||
      lanes <= 0 || lanes % 16 != 0 || lanes > d)
    return cudaErrorInvalidValue;
  const Plan plan = make_plan(lanes);
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

template <bool RING>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, Params p, int bh, int lanes,
                       int stages, int smem, int resident, cudaStream_t stream) {
  const int n = p.n, d = p.d;
  if (bh <= 0 || bh > 65535 || n <= 0 || n % kRows != 0 || d <= 256 || d % kAtomLanes != 0 ||
      lanes <= 0 || lanes % 16 != 0 || lanes > d)
    return cudaErrorInvalidValue;
  const FwdPlan plan = make_fwd_plan(lanes);
  // the caller's tile plan must be the one computed here
  if (plan.stages != stages || plan.smem != smem || plan.resident != (resident != 0))
    return cudaErrorInvalidValue;
  p.atoms = plan.atoms;
  p.slices = plan.slices;
  p.resident = plan.resident;
  p.stage_atoms = plan.stage_atoms;
  p.stages = plan.stages;
  p.stage_bytes = plan.stage_bytes;
  p.resident_bytes = plan.resident_bytes;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!make_head_map(&maps[i], ptrs[i], bh, n, d, kRows)) return cudaErrorInvalidValue;
  auto kernel = flash_wide_fwd_kernel<RING>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n / kRows, bh, plan.slices);
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], p);
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
  return launch_fwd<false>(q, k, v, p, bh, lanes, stages, smem, resident,
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
  return launch_fwd<true>(q, k, v, p, bh, lanes, stages, smem, resident,
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
