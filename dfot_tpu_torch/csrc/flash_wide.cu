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
// neither its loads nor L2 (a version that loads nothing took as long) but
// on its own products: the scores read both operands from shared memory
// (m64 n64 k16: 4 KB a step, the SM's 128 bytes a clock), and the exchange
// of scores between the consumers leaves the tensor cores idle. So one
// design serves all of them, computing each score once and keeping its
// products asynchronous:
//
// - a block owns 64 rows (B1, B4: queries; B5: keys) and an output slice of
//   up to 512 lanes (8 atoms of 64; grid z: the slices, B5's dK slices and
//   then its dV ones), and each of its two consumer warpgroups keeps the
//   output (O, dQ, dK or dV) for its share of the slice's atoms (at most 4:
//   128 registers a thread) and stores it itself. B4 and B5 take 256-lane
//   slices where the grid of those fits one wave of the card and has more
//   blocks (B4 at the base U-ViT's level 3 and B = 1: 128 blocks where
//   512-lane slices would leave 68 of the 132 SMs idle): every block then runs
//   at once either way, and a 256-lane block does the same scores and half
//   the output product;
// - the score products of a 64-row tile of the streamed side (B1: S = Q K^T;
//   B4: S and dP = dO V^T; B5: S^T = K Q^T, and for dK dP^T = V dO^T) are
//   m64 n64 tiles contracted over the head's 64-lane atoms. With one product
//   (B1, a dV block) the consumers split its atoms (``split``) and exchange
//   their partial tiles; both add them as S0 + S1, so they hold the same
//   scores bit for bit. With two (B4, a dK block) consumer 0 contracts S and
//   consumer 1 dP, each over every atom, and they exchange their tiles: each
//   consumer then holds 32 fp32 registers of scores, not 64, beside its 128
//   of output, and nothing is added. The exchange goes through shared memory
//   (2 x 16 KB) between named barriers. Whole atoms, each behind a fence of
//   its own and committed as a group right after its products, keep every
//   product out of a branch of its batch, where ptxas would serialize them
//   all (its note C7520); the lanes past the true head dim are zeros, so the
//   last atom's pad steps add nothing;
// - the block's own rows of the score products' A operands (Q; Q and dO; K
//   and V) are loaded once where they fit beside the exchange and two
//   one-atom stages ("resident"), else their atoms come with the streamed
//   ones; each streamed tile brings the score atoms (a stage of up to 8
//   atoms of each product's operand), then the slice's atoms of the output
//   product's operand (V for O; K for dQ; dO for dV; Q for dK), through a
//   ring of stages with full/empty mbarriers, one producer thread issuing
//   TMA (``produce``);
// - the output product's A operand is formed in registers from the scores
//   (B1: the online softmax's P, a running max of the raw scores and exp2;
//   B4, B5: p = exp(s scale - lse) recomputed, ds = p (dp - delta)), rounded
//   to bf16 and multiplied with the operand's atoms in their natural layout
//   as the transposed B operand (m64 n64 an atom); only the true head dim's
//   lanes are computed and lanes past them are written as zeros;
// - the ring hops: on a LocalRing the K/V head at hop s is (h - s B H) mod R B
//   H (B5: its blocks own the keys of a K/V head and walk the queries of head
//   (h + s B H) mod R B H). The forward folds (O, LSE) in the epilogue, the
//   running LSE read from one buffer and the new one written to another (the
//   slices of a row past 512 lanes all read the old one); the backward adds
//   into fp32 sums, disjoint by lane. Every load of a row comes before its
//   first store. No atomics.

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace dfot;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                      // rows of a block, and of a streamed tile
constexpr int kSlotBytes = kRows * kLineBytes;  // one 64-lane atom of 64 rows: 8 KB
constexpr int kSliceAtoms = 8;                 // 512 lanes, an output slice
constexpr int kSmallSliceAtoms = 4;            // B4, B5: 256 lanes where those fill the card
constexpr int kOwnAtoms = 4;                   // a consumer's output atoms, at most
constexpr int kThreads = 384;                  // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kMaxStages = 8;
constexpr int kStageAtoms = 8;                 // a stage's atoms of each score product, at most
constexpr int kAcc = kOwnAtoms * 32;           // a consumer thread's accumulator registers
constexpr int kSmemPerBlock = 232448;
constexpr int kSmCount = 132;
constexpr int kBarrier = 8;
constexpr int kExchangeBytes = 32768;  // both consumers' 64 x 64 fp32 score tiles
constexpr float kNegInf = -1e30f;

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// The tile plan, as ops/attention.py:flash_plan computes it for the wide
// family; the C entries compute it again and refuse any other.
struct Plan {
  int atoms;           // 64-lane atoms of the computed lanes
  int slice_atoms;     // output atoms of a slice: 8, or 4 (B4, B5; see slice_atoms_of)
  int slices;          // output slices (B5: of dK, and as many of dV)
  int resident;        // the block's own rows loaded once
  int stage_atoms;     // atoms of each score product's streamed operand a stage
  int out_atoms;       // atoms of the output product's operand a stage
  int stages, stage_bytes, resident_bytes, smem;
};

// B4, B5: 256-lane slices where their grid fits one wave and has more blocks
// than the 512-lane one; else (and in B1) 512
int slice_atoms_of(int kind, int bh, int n, int atoms) {
  if (kind == kFwd || atoms <= kSmallSliceAtoms) return kSliceAtoms;
  const long long blocks = static_cast<long long>((n + kRows - 1) / kRows) * bh *
                           ((atoms + kSmallSliceAtoms - 1) / kSmallSliceAtoms) *
                           (kind == kDkv ? 2 : 1);
  return blocks <= kSmCount ? kSmallSliceAtoms : kSliceAtoms;
}

// ``sides``: the A operands of the score products a block keeps (B1: Q; B4:
// Q and dO; B5: K and V). They are resident where they fit beside the
// exchange and two one-atom stages; a stage holds as many atoms of each
// product's streamed operand (with the own rows' alongside where they stream)
// as let two stages fit, at most kStageAtoms and the computed atoms, and
// there are as many stages as fit; an output stage fills the same bytes with
// the output operand's atoms, at most a slice's.
Plan make_plan(int kind, int bh, int n, int lanes) {
  Plan p;
  const int sides = kind == kFwd ? 1 : 2;
  p.atoms = (lanes + kAtomLanes - 1) / kAtomLanes;
  const int room = kSmemPerBlock - 1024 - kExchangeBytes - kBarrier * (1 + 2 * kMaxStages);
  p.resident = room - sides * p.atoms * kSlotBytes >= 2 * sides * kSlotBytes;
  p.resident_bytes = p.resident ? sides * p.atoms * kSlotBytes : 0;
  const int unit = sides * kSlotBytes * (p.resident ? 1 : 2);  // a stage's bytes an atom
  p.stage_atoms =
      std::min(std::min(kStageAtoms, p.atoms), (room - p.resident_bytes) / (2 * unit));
  p.stage_bytes = p.stage_atoms * unit;
  p.stages = std::min(kMaxStages, (room - p.resident_bytes) / p.stage_bytes);
  p.slice_atoms = slice_atoms_of(kind, bh, n, p.atoms);
  p.slices = (p.atoms + p.slice_atoms - 1) / p.slice_atoms;
  p.out_atoms = std::min(p.slice_atoms, p.stage_bytes / kSlotBytes);
  p.smem = 1024 + p.resident_bytes + kExchangeBytes + p.stages * p.stage_bytes +
           kBarrier * (1 + 2 * p.stages);
  return p;
}

// How the consumers share a slice of ``sa`` output atoms and the head's
// ``atoms`` score atoms of one score product: consumer 0 owns output atoms
// [0, a0) of the slice and score atoms [0, t0), consumer 1 the rest; a0 =
// ceil(sa / 2), and t0 gives both as even a count of atoms as it can (each is
// 4 k16 steps of n64 products in either product; ops/attention.py:
// wide_split). With two score products the output atoms are shared alike
// and each consumer contracts one product over every atom.
__host__ __device__ inline void split(int sa, int atoms, int* a0, int* t0) {
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
  int n, d, atoms, slice_atoms, slices, resident, stage_atoms, out_atoms, stages, stage_bytes,
      resident_bytes;
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

// The shared memory of a block: its own rows where resident, the exchange,
// the ring of stages, then the mbarriers (the own rows' one, full, empty).
struct Smem {
  unsigned char *base, *ring;
  float* xchg;
  uint64_t *res_full, *full, *empty;
  __device__ __forceinline__ explicit Smem(const Params& p) {
    extern __shared__ unsigned char smem_raw[];
    base = align_1024(smem_raw);
    xchg = reinterpret_cast<float*>(base + p.resident_bytes);
    ring = base + p.resident_bytes + kExchangeBytes;
    res_full = reinterpret_cast<uint64_t*>(ring + p.stages * p.stage_bytes);
    full = res_full + 1;
    empty = full + p.stages;
  }
  __device__ __forceinline__ void init(int stages) const {
    if (threadIdx.x == 0) {
      mbar_init(res_full, 1);
      for (int s = 0; s < stages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumerWarps);
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
};

// What a block loads: ``kinds`` score products, each from its own rows
// (own[i], at rows r0 of head ``head``) and the streamed operand (far[i], at
// each tile's rows of head ``other``); then the output product's operand
// (``out``) at the slice's atoms from ``out_atom0``.
struct Loads {
  const CUtensorMap* own[2];
  const CUtensorMap* far[2];
  const CUtensorMap* out;
  int kinds, sides, r0, head, other, t_first, n_tiles, out_atom0, sa;
};

// A stage's slots: far[i]'s atom j at (i SA + j) slots, own[i]'s (where they
// stream) at ((sides + i) SA + j); resident own[i]'s atom a at (i A + a).
__device__ __forceinline__ int far_slot(int i, int j, int SA) { return i * SA + j; }
__device__ __forceinline__ int own_slot(int i, int j, int SA, int sides) {
  return (sides + i) * SA + j;
}

// The producer thread: every load of the block, in the consumers' order.
__device__ __forceinline__ void produce(const Params& p, const Smem& sm, const Loads& L) {
  const int A = p.atoms, SA = p.stage_atoms, OA = p.out_atoms;
  if (p.resident) {
    mbar_arrive_expect_tx(sm.res_full, L.kinds * A * kSlotBytes);
    for (int i = 0; i < L.kinds; ++i)
      for (int a = 0; a < A; ++a)
        tma_load_3d(sm.base + (i * A + a) * kSlotBytes, i ? L.own[1] : L.own[0], sm.res_full,
                    a * kAtomLanes, L.r0, L.head);
  }
  RingPos pos;
  for (int t = 0; t < L.n_tiles; ++t) {
    const int row_t = (L.t_first + t) * kRows;
    for (int lo = 0; lo < A; lo += SA) {
      const int hi = min(lo + SA, A);
      mbar_wait(&sm.empty[pos.slot], pos.phase ^ 1);
      unsigned char* stage = sm.ring + pos.slot * p.stage_bytes;
      mbar_arrive_expect_tx(&sm.full[pos.slot],
                            (hi - lo) * L.kinds * kSlotBytes * (p.resident ? 1 : 2));
      for (int i = 0; i < L.kinds; ++i)
        for (int a = lo; a < hi; ++a) {
          tma_load_3d(stage + far_slot(i, a - lo, SA) * kSlotBytes, i ? L.far[1] : L.far[0],
                      &sm.full[pos.slot], a * kAtomLanes, row_t, L.other);
          if (!p.resident)
            tma_load_3d(stage + own_slot(i, a - lo, SA, L.sides) * kSlotBytes,
                        i ? L.own[1] : L.own[0], &sm.full[pos.slot], a * kAtomLanes, L.r0,
                        L.head);
        }
      pos.advance(p.stages);
    }
    for (int lo = 0; lo < L.sa; lo += OA) {
      const int hi = min(lo + OA, L.sa);
      mbar_wait(&sm.empty[pos.slot], pos.phase ^ 1);
      unsigned char* stage = sm.ring + pos.slot * p.stage_bytes;
      mbar_arrive_expect_tx(&sm.full[pos.slot], (hi - lo) * kSlotBytes);
      for (int a = lo; a < hi; ++a)
        tma_load_3d(stage + (a - lo) * kSlotBytes, L.out, &sm.full[pos.slot],
                    (L.out_atom0 + a) * kAtomLanes, row_t, L.other);
      pos.advance(p.stages);
    }
  }
}

// A consumer's partial m64 n64 tile of score product ``prod`` over atoms
// [k_lo, k_hi) of the head, from every score stage of a tile: whole atoms,
// accumulating into a zeroed tile, each atom's 4 k16 steps behind a fence of
// their own and committed as a group right after them, the stage released
// once its groups are done. A group that could be empty (a commit after a
// branch or a loop that issued nothing) makes ptxas serialize every product
// of the kernel (its note C7520).
__device__ __forceinline__ void score_tile(float (&sc)[32], const Params& p, const Smem& sm,
                                           RingPos& pos, int prod, int sides, int k_lo, int k_hi,
                                           int lane) {
  const int A = p.atoms, SA = p.stage_atoms;
  const uint32_t res_a = smem_u32(sm.base), ring_a = smem_u32(sm.ring);
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  fence_regs<32>(sc);
  for (int lo = 0; lo < A; lo += SA) {
    const int hi = min(lo + SA, A);
    mbar_wait(&sm.full[pos.slot], pos.phase);
    const uint32_t stg = ring_a + pos.slot * p.stage_bytes;
#pragma unroll 1
    for (int a = max(lo, k_lo); a < min(hi, k_hi); ++a) {
      const uint32_t od = p.resident ? res_a + (prod * A + a) * kSlotBytes
                                     : stg + own_slot(prod, a - lo, SA, sides) * kSlotBytes;
      const uint32_t fd = stg + far_slot(prod, a - lo, SA) * kSlotBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<64>::mma(sc, sw128_desc(od + kk * 32), sw128_desc(fd + kk * 32), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[pos.slot]);
    pos.advance(p.stages);
  }
  fence_regs<32>(sc);
}

// acc (this consumer's output atoms [v_lo, v_hi) of the slice) += pa (the
// 64 x 64 A operand, bf16 in registers) x the tile's output stages, each
// atom's products behind a fence of their own in their branch and committed
// there; the accumulator and pa pinned once, before the first product
// (pinning an atom's registers inside the stage loop would read registers a
// product of the stage before may still write)
__device__ __forceinline__ void output_product(float (&acc)[kAcc], uint32_t (&pa)[4][4],
                                               const Params& p, const Smem& sm, RingPos& pos,
                                               int sa, int v_lo, int v_hi, int lane) {
  const uint32_t ring_a = smem_u32(sm.ring);
  fence_regs<kAcc>(acc);
  fence_regs<4>(pa);
  for (int lo = 0; lo < sa; lo += p.out_atoms) {
    const int hi = min(lo + p.out_atoms, sa);
    mbar_wait(&sm.full[pos.slot], pos.phase);
    const uint32_t stg = ring_a + pos.slot * p.stage_bytes;
#pragma unroll
    for (int at = 0; at < kOwnAtoms; ++at) {
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
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[pos.slot]);
    pos.advance(p.stages);
  }
  fence_regs<kAcc>(acc);
  fence_regs<4>(pa);
}

// Hands this consumer's 64 x 64 tile ``sc`` to the other through shared
// memory and returns a pointer to the other's, which this thread reads at
// [i * 128 + t128]: the first barrier waits until the other has read the
// last tile this one wrote
__device__ __forceinline__ const float* exchange(const float (&sc)[32], const Smem& sm, int w,
                                                 int t128) {
  float* mine = sm.xchg + w * kRows * kRows;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) mine[i * 128 + t128] = sc[i];
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  return sm.xchg + (1 - w) * kRows * kRows;
}

// One row (r: this thread's row0 + 8 r) of a consumer's output atoms: its sa
// atoms at lanes lane0 + 64 at + 8 i + 2 c, x = prev * ka + acc * kb with
// prev the row's fp32 running values (``sum``, read if read_prev), stored to
// ``sum`` in fp32 (to_sum) or to ``out`` in bf16, then (zero_to > zero_from)
// atoms zero_from..zero_to-1 of ``out`` zeroed. Every load comes before the
// first store (see flash_bwd.cu:ring_store_row).
__device__ __forceinline__ void store_row(const float* acc, int r, int sa, float ka, float kb,
                                          int lane0, int c, bf16* __restrict__ out,
                                          float* __restrict__ sum, bool read_prev, bool to_sum,
                                          int zero_from, int zero_to) {
  float2 prev[kOwnAtoms][8];
#pragma unroll
  for (int at = 0; at < kOwnAtoms; ++at)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      prev[at][i] = read_prev && at < sa
                        ? *reinterpret_cast<const float2*>(sum + lane0 + 64 * at + 8 * i + 2 * c)
                        : make_float2(0.f, 0.f);
#pragma unroll
  for (int at = 0; at < kOwnAtoms; ++at) {
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
    flash_wide_bwd_kernel(const __grid_constant__ CUtensorMap tm_r0,
                          const __grid_constant__ CUtensorMap tm_r1,
                          const __grid_constant__ CUtensorMap tm_s0,
                          const __grid_constant__ CUtensorMap tm_s1, const Params p) {
  const Smem sm(p);
  const int n = p.n, A = p.atoms;
  // causal B4: the longest rows first, so the short ones fill the tail (a
  // causal B5 block's first rows are its longest already)
  const int rb = KIND == kDq && p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
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
  bool dv_block = false;  // B5: this block's output is dV (else dK); the dK blocks come first
  if constexpr (KIND == kDkv) {
    dv_block = slice >= p.slices;
    if (dv_block) slice -= p.slices;
  }
  const int sa = min(p.slice_atoms, A - p.slice_atoms * slice);  // the slice's atoms
  // the score products: S and dP (a dV block: S alone)
  const int kinds = dv_block ? 1 : 2;
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
  sm.init(p.stages);

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      // the output product's operand: K (B4), Q (B5 dK), dO (B5 dV)
      const Loads L{{&tm_r0, &tm_r1}, {&tm_s0, &tm_s1}, dv_block ? &tm_s1 : &tm_s0, kinds, 2,
                    r0, head, other, t_first, n_tiles, p.slice_atoms * slice, sa};
      produce(p, sm, L);
    }
    return;
  }

  // consumer warpgroups: both own the block's 64 rows; consumer w the score
  // product ``prod`` over atoms [k_lo, k_hi) and the slice's output atoms
  // [v_lo, v_hi)
  setmaxnreg_inc<240>();
  const int w = threadIdx.x / 128 - 1;
  const int t128 = threadIdx.x % 128;
  const int warp = t128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int row0 = r0 + warp * 16 + g;  // this thread's block rows: row0, row0 + 8
  const float a2 = p.sm_scale * kLog2e;  // exp(x * scale) = exp2(x * a2)
  int a0, t0;
  split(sa, A, &a0, &t0);
  const int prod = kinds == 2 ? w : 0;
  const int k_lo = kinds == 2 || w == 0 ? 0 : t0, k_hi = kinds == 2 || w == 1 ? A : t0;
  const int v_lo = w ? a0 : 0, v_hi = w ? sa : a0;
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

  if (p.resident) mbar_wait(sm.res_full, 0);
  RingPos pos;
  for (int t = 0; t < n_tiles; ++t) {
    const int row_t = (t_first + t) * kRows;  // the tile's first column (key, or B5 query)
    // B5: the LSE and delta of this thread's query columns, loaded before the
    // score products so that their latency hides behind them
    float2 lq[8], dd[8];
    if constexpr (KIND == kDkv) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        lq[i] = *reinterpret_cast<const float2*>(p.lse + far + row_t + 8 * i + 2 * c);
        dd[i] = *reinterpret_cast<const float2*>(p.delta + far + row_t + 8 * i + 2 * c);
      }
    }
    float sc[32];
    score_tile(sc, p, sm, pos, prod, 2, k_lo, k_hi, lane);
    const float* theirs = exchange(sc, sm, w, t128);

    // the output product's A operand, in fp32 in sc: S is consumer 0's tile
    // (two products) or S0 + S1 (one), dP consumer 1's
    if constexpr (KIND == kDq) {
      const bool masked = p.causal && row_t + kRows - 1 > r0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = theirs[(4 * i + e) * 128 + t128];
          const float s = w == 0 ? sc[4 * i + e] : x, dp = w == 0 ? x : sc[4 * i + e];
          float pv = exp2f(fmaf(s, a2, -l2r[e / 2]));
          if (masked && row_t + 8 * i + 2 * c + (e & 1) > row0 + 8 * (e / 2)) pv = 0.f;
          sc[4 * i + e] = pv * (dp - dlr[e / 2]);
        }
    } else {
      // rows are keys, columns queries: a query before the key is masked
      const bool masked = p.causal && row_t < r0 + kRows - 1;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = theirs[(4 * i + e) * 128 + t128], mine = sc[4 * i + e];
          const float s = dv_block ? (w == 0 ? mine + x : x + mine) : (w == 0 ? mine : x);
          const float dp = w == 0 ? x : mine;
          float pv = exp2f(fmaf(s, a2, -((e & 1) ? lq[i].y : lq[i].x) * kLog2e));
          if (masked && row_t + 8 * i + 2 * c + (e & 1) < row0 + 8 * (e / 2)) pv = 0.f;
          sc[4 * i + e] = dv_block ? pv : pv * (dp - ((e & 1) ? dd[i].y : dd[i].x));
        }
    }
    uint32_t pa[4][4];
    pack_a<4>(pa, sc);
    output_product(acc, pa, p, sm, pos, sa, v_lo, v_hi, lane);
  }

  const int D = p.d, lane0 = kAtomLanes * (p.slice_atoms * slice + v_lo);
  // consumer 1 of the last slice also zeroes the atoms past the computed ones
  const bool tail = w == 1 && slice == p.slices - 1;
  const int zero_from = tail ? A : 0, zero_to = tail ? D / kAtomLanes : 0;
  bf16* out = dv_block ? p.out1 : p.out0;
  float* sums = dv_block ? p.sum1 : p.sum0;
  const float scale = dv_block ? 1.f : p.sm_scale;
  const bool to_sum = RING && !p.last;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = own + row0 + 8 * r;
    store_row(acc, r, v_hi - v_lo, 1.f, scale, lane0, c, out + row * D,
              RING ? sums + row * D : nullptr, RING && p.read_prev, to_sum,
              to_sum ? 0 : zero_from, to_sum ? 0 : zero_to);
  }
}

// The forward: Q (where it streams, its atoms come with K's: tm_q read at
// every key tile), K, V; every box 64 lanes x 64 rows.
template <bool RING>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  const Smem sm(p);
  const int n = p.n, A = p.atoms;
  // causal: the longest rows first, so the short ones fill the tail
  const int rb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int r0 = rb * kRows;
  const int head = blockIdx.y, slice = blockIdx.z;
  int kv = head;  // K/V head
  if constexpr (RING) {
    kv -= p.kv_shift;
    if (kv < 0) kv += static_cast<int>(gridDim.y);
  }
  const int sa = min(p.slice_atoms, A - p.slice_atoms * slice);  // the slice's atoms
  // causal: the block's last row sees keys up to r0 + 63
  const int n_tiles = p.causal ? rb + 1 : n / kRows;
  sm.init(p.stages);

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const Loads L{{&tm_q, &tm_q}, {&tm_k, &tm_k}, &tm_v, 1, 1, r0, head, kv, 0, n_tiles,
                    p.slice_atoms * slice, sa};
      produce(p, sm, L);
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
  int a0, t0;
  split(sa, A, &a0, &t0);
  const int k_lo = w ? t0 : 0, k_hi = w ? A : t0;
  const int v_lo = w ? a0 : 0, v_hi = w ? sa : a0;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};  // raw-score max, partial sums

  if (p.resident) mbar_wait(sm.res_full, 0);
  RingPos pos;
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * kRows;
    float sc[32];
    score_tile(sc, p, sm, pos, 0, 1, k_lo, k_hi, lane);
    // S = S0 + S1 on both consumers, the same bits
    const float* theirs = exchange(sc, sm, w, t128);
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
    uint32_t pa[4][4];
    pack_a<4>(pa, sc);
    // O += P V on this consumer's atoms
    output_product(acc, pa, p, sm, pos, sa, v_lo, v_hi, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  const int D = p.d, lane0 = kAtomLanes * (p.slice_atoms * slice + v_lo);
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

// Launches kernel KIND on ``plan`` (B1: maps of q, k, v; B4, B5: of the own
// side's two operands, then the streamed side's two).
template <int KIND, bool RING>
cudaError_t run(const void* const* ptrs, Params p, const Plan& plan, int bh,
                cudaStream_t stream) {
  p.atoms = plan.atoms;
  p.slice_atoms = plan.slice_atoms;
  p.slices = plan.slices;
  p.resident = plan.resident;
  p.stage_atoms = plan.stage_atoms;
  p.out_atoms = plan.out_atoms;
  p.stages = plan.stages;
  p.stage_bytes = plan.stage_bytes;
  p.resident_bytes = plan.resident_bytes;
  constexpr int kMaps = KIND == kFwd ? 3 : 4;
  CUtensorMap maps[4];
  for (int i = 0; i < kMaps; ++i)
    if (!make_head_map(&maps[i], ptrs[i], bh, p.n, p.d, kRows)) return cudaErrorInvalidValue;
  const dim3 grid(p.n / kRows, bh, KIND == kDkv ? 2 * plan.slices : plan.slices);
  if constexpr (KIND == kFwd) {
    auto kernel = flash_wide_fwd_kernel<RING>;
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, kThreads, plan.smem, stream>>>(maps[0], maps[1], maps[2], p);
  } else {
    auto kernel = flash_wide_bwd_kernel<KIND, RING>;
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, kThreads, plan.smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  }
  return cudaGetLastError();
}

// The C entries' launch: the shapes checked, and the caller's tile plan
// against the one computed here.
template <int KIND, bool RING>
cudaError_t launch(const void* const* ptrs, Params p, int bh, int lanes, int stages, int smem,
                   int resident, cudaStream_t stream) {
  const int n = p.n, d = p.d;
  if (bh <= 0 || bh > 65535 || n <= 0 || n % kRows != 0 || d <= 256 || d % kAtomLanes != 0 ||
      lanes <= 0 || lanes % 16 != 0 || lanes > d)
    return cudaErrorInvalidValue;
  const Plan plan = make_plan(KIND, bh, n, lanes);
  if (plan.stages != stages || plan.smem != smem || plan.resident != (resident != 0))
    return cudaErrorInvalidValue;
  return run<KIND, RING>(ptrs, p, plan, bh, stream);
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
  const void* ptrs[3] = {q, k, v};
  return launch<kFwd, false>(ptrs, p, bh, lanes, stages, smem, resident,
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
  const void* ptrs[4] = {q, d_o, k, v};
  return launch<kDq, false>(ptrs, p, bh, lanes, stages, smem, resident,
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
  const void* ptrs[4] = {k, v, q, d_o};
  return launch<kDkv, false>(ptrs, p, bh, lanes, stages, smem, resident,
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
  const void* ptrs[3] = {q, k, v};
  return launch<kFwd, true>(ptrs, p, bh, lanes, stages, smem, resident,
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
  const void* ptrs[4] = {q, d_o, k, v};
  return launch<kDq, true>(ptrs, p, bh, lanes, stages, smem, resident,
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
  const void* ptrs[4] = {k, v, q, d_o};
  return launch<kDkv, true>(ptrs, p, bh, lanes, stages, smem, resident,
                            static_cast<cudaStream_t>(stream));
}
