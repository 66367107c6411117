// The wide B4 and B5 (csrc/flash_wide.cu) on the slice width the grid rule
// did not pick, for kernel_variants.py: the committed kernel and plan, with
// ``slice_atoms`` output atoms a slice (4: 256 lanes, or 8: 512) whatever
// slice_atoms_of says. Built on the committed source, so both run the same
// code.

#include "../csrc/flash_wide.cu"

// kind 1: dq (out0), arguments as dfot_flash_bwd_dq_wide; kind 2: dk (out0),
// dv (out1), as dfot_flash_bwd_dkv_wide. Returns a cudaError_t.
extern "C" int variant_flash_bwd_wide_slices(int kind, const void* q, const void* k,
                                             const void* v, const void* d_o, const void* lse,
                                             const void* delta, void* out0, void* out1, int bh,
                                             int n, int d, int lanes, float sm_scale, int causal,
                                             int slice_atoms, void* stream) {
  if ((kind != kDq && kind != kDkv) || (slice_atoms != kSmallSliceAtoms &&
                                        slice_atoms != kSliceAtoms) ||
      bh <= 0 || bh > 65535 || n <= 0 || n % kRows != 0 || d <= 256 || d % kAtomLanes != 0 ||
      lanes <= 0 || lanes % 16 != 0 || lanes > d)
    return cudaErrorInvalidValue;
  Plan plan = make_plan(kind, bh, n, lanes);
  plan.slice_atoms = slice_atoms;
  plan.slices = (plan.atoms + slice_atoms - 1) / slice_atoms;
  plan.out_atoms = std::min(slice_atoms, plan.stage_bytes / kSlotBytes);
  Params p = params(n, d, sm_scale, causal);
  p.out0 = static_cast<bf16*>(out0);
  p.out1 = static_cast<bf16*>(out1);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kDq) {
    const void* ptrs[4] = {q, d_o, k, v};
    return run<kDq, false>(ptrs, p, plan, bh, s);
  }
  const void* ptrs[4] = {k, v, q, d_o};
  return run<kDkv, false>(ptrs, p, plan, bh, s);
}

namespace {

// Both score products' partial tiles over atoms [k_lo, k_hi) of the head,
// each atom's 8 products (4 of S, 4 of dP) one commit group.
__device__ __forceinline__ void score_tiles_both(float (&sc)[32], float (&dp)[32],
                                                 const Params& p, const Smem& sm, RingPos& pos,
                                                 int k_lo, int k_hi, int lane) {
  const int A = p.atoms, SA = p.stage_atoms;
  const uint32_t res_a = smem_u32(sm.base), ring_a = smem_u32(sm.ring);
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  fence_regs<32>(sc);
  fence_regs<32>(dp);
  for (int lo = 0; lo < A; lo += SA) {
    const int hi = min(lo + SA, A);
    mbar_wait(&sm.full[pos.slot], pos.phase);
    const uint32_t stg = ring_a + pos.slot * p.stage_bytes;
#pragma unroll 1
    for (int a = max(lo, k_lo); a < min(hi, k_hi); ++a) {
      uint32_t od[2], fd[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        od[i] = p.resident ? res_a + (i * A + a) * kSlotBytes
                           : stg + own_slot(i, a - lo, SA, 2) * kSlotBytes;
        fd[i] = stg + far_slot(i, a - lo, SA) * kSlotBytes;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<64>::mma(sc, sw128_desc(od[0] + kk * 32), sw128_desc(fd[0] + kk * 32), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaSS<64>::mma(dp, sw128_desc(od[1] + kk * 32), sw128_desc(fd[1] + kk * 32), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[pos.slot]);
    pos.advance(p.stages);
  }
  fence_regs<32>(sc);
  fence_regs<32>(dp);
}

// flash_wide_bwd_kernel<KIND, false> with the other split of a block's two
// score products: both consumers contract S and dP over their share of the
// atoms (a0 output atoms and 2 t0 score atoms against sa - a0 and 2 (A -
// t0)) and exchange both partial tiles, S and then dP through the same 32
// KB, adding them as S0 + S1 and dP0 + dP1.
template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wide_bwd_atoms_kernel(const __grid_constant__ CUtensorMap tm_r0,
                                const __grid_constant__ CUtensorMap tm_r1,
                                const __grid_constant__ CUtensorMap tm_s0,
                                const __grid_constant__ CUtensorMap tm_s1, const Params p) {
  const Smem sm(p);
  const int n = p.n, A = p.atoms, head = blockIdx.y, r0 = blockIdx.x * kRows;
  int slice = blockIdx.z;
  bool dv_block = false;
  if constexpr (KIND == kDkv) {
    dv_block = slice >= p.slices;
    if (dv_block) slice -= p.slices;
  }
  const int sa = min(p.slice_atoms, A - p.slice_atoms * slice);
  const int kinds = dv_block ? 1 : 2;
  const int n_tiles = n / kRows;
  sm.init(p.stages);
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const Loads L{{&tm_r0, &tm_r1}, {&tm_s0, &tm_s1}, dv_block ? &tm_s1 : &tm_s0, kinds, 2,
                    r0, head, head, 0, n_tiles, p.slice_atoms * slice, sa};
      produce(p, sm, L);
    }
    return;
  }
  setmaxnreg_inc<240>();
  const int w = threadIdx.x / 128 - 1;
  const int t128 = threadIdx.x % 128;
  const int warp = t128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int row0 = r0 + warp * 16 + g;
  const float a2 = p.sm_scale * kLog2e;
  int a0, t0;
  split(sa, A, &a0, &t0);
  if (kinds == 2) {
    const int quad = 2 * A + sa - 2 * a0;
    t0 = quad <= 0 ? 0 : min(A, quad / 4);
  }
  const int k_lo = w ? t0 : 0, k_hi = w ? A : t0;
  const int v_lo = w ? a0 : 0, v_hi = w ? sa : a0;
  const size_t own = static_cast<size_t>(head) * n;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float l2r[2] = {0.f, 0.f}, dlr[2] = {0.f, 0.f};
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
    const int row_t = t * kRows;
    float2 lq[8], dd[8];
    if constexpr (KIND == kDkv) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        lq[i] = *reinterpret_cast<const float2*>(p.lse + own + row_t + 8 * i + 2 * c);
        dd[i] = *reinterpret_cast<const float2*>(p.delta + own + row_t + 8 * i + 2 * c);
      }
    }
    float sc[32], dp[32];
    if (kinds == 2) {
      score_tiles_both(sc, dp, p, sm, pos, k_lo, k_hi, lane);
    } else {
      score_tile(sc, p, sm, pos, 0, 2, k_lo, k_hi, lane);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = 0.f;
    }
    const float* theirs = exchange(sc, sm, w, t128);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = theirs[i * 128 + t128];
      sc[i] = w == 0 ? sc[i] + x : x + sc[i];
    }
    if (kinds == 2) {
      theirs = exchange(dp, sm, w, t128);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float x = theirs[i * 128 + t128];
        dp[i] = w == 0 ? dp[i] + x : x + dp[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * i + e;
        if constexpr (KIND == kDq) {
          sc[j] = exp2f(fmaf(sc[j], a2, -l2r[e / 2])) * (dp[j] - dlr[e / 2]);
        } else {
          const float pv = exp2f(fmaf(sc[j], a2, -((e & 1) ? lq[i].y : lq[i].x) * kLog2e));
          sc[j] = dv_block ? pv : pv * (dp[j] - ((e & 1) ? dd[i].y : dd[i].x));
        }
      }
    uint32_t pa[4][4];
    pack_a<4>(pa, sc);
    output_product(acc, pa, p, sm, pos, sa, v_lo, v_hi, lane);
  }
  const int D = p.d, lane0 = kAtomLanes * (p.slice_atoms * slice + v_lo);
  const bool tail = w == 1 && slice == p.slices - 1;
  bf16* out = dv_block ? p.out1 : p.out0;
  const float scale = dv_block ? 1.f : p.sm_scale;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    store_row(acc, r, v_hi - v_lo, 1.f, scale, lane0, c, out + (own + row0 + 8 * r) * D, nullptr,
              false, false, tail ? A : 0, tail ? D / kAtomLanes : 0);
}

}  // namespace

// The wide B4 (kind 1) or B5 (kind 2), non-causal, on the committed plan but
// with flash_wide_bwd_atoms_kernel, arguments as
// variant_flash_bwd_wide_slices without the slice width.
extern "C" int variant_flash_bwd_wide_atoms(int kind, const void* q, const void* k,
                                            const void* v, const void* d_o, const void* lse,
                                            const void* delta, void* out0, void* out1, int bh,
                                            int n, int d, int lanes, float sm_scale,
                                            void* stream) {
  if ((kind != kDq && kind != kDkv) || bh <= 0 || bh > 65535 || n <= 0 || n % kRows != 0 ||
      d <= 256 || d % kAtomLanes != 0 || lanes <= 0 || lanes % 16 != 0 || lanes > d)
    return cudaErrorInvalidValue;
  const Plan plan = make_plan(kind, bh, n, lanes);
  Params p = params(n, d, sm_scale, 0);
  p.out0 = static_cast<bf16*>(out0);
  p.out1 = static_cast<bf16*>(out1);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.atoms = plan.atoms;
  p.slice_atoms = plan.slice_atoms;
  p.slices = plan.slices;
  p.resident = plan.resident;
  p.stage_atoms = plan.stage_atoms;
  p.out_atoms = plan.out_atoms;
  p.stages = plan.stages;
  p.stage_bytes = plan.stage_bytes;
  p.resident_bytes = plan.resident_bytes;
  const void* ptrs[4] = {q, d_o, k, v};
  if (kind == kDkv) {
    ptrs[0] = k;
    ptrs[1] = v;
    ptrs[2] = q;
    ptrs[3] = d_o;
  }
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!make_head_map(&maps[i], ptrs[i], bh, n, d, kRows)) return cudaErrorInvalidValue;
  auto kernel = kind == kDq ? flash_wide_bwd_atoms_kernel<kDq> : flash_wide_bwd_atoms_kernel<kDkv>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(n / kRows, bh, kind == kDkv ? 2 * plan.slices : plan.slices);
  kernel<<<grid, kThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1],
                                                                           maps[2], maps[3], p);
  return cudaGetLastError();
}

namespace {

// distributed shared memory: this block's shared address ``a`` in block
// ``rank`` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void peer_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void wait_cluster(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// The wide B4, non-causal, with the keys split between the two blocks of a
// cluster (grid x: two blocks a 64-row block, rank r walking key tiles
// [r T / 2, (r + 1) T / 2) of T) on one 512-lane slice: the pair's fp32
// partial dQ added in a fixed order (rank 0's + rank 1's) through
// distributed shared memory, block r storing consumer r's atoms and sending
// the other consumer's partials to the other block.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    flash_wide_dq_split_kernel(const __grid_constant__ CUtensorMap tm_r0,
                               const __grid_constant__ CUtensorMap tm_r1,
                               const __grid_constant__ CUtensorMap tm_s0,
                               const __grid_constant__ CUtensorMap tm_s1, const Params p) {
  const Smem sm(p);
  uint64_t* free_bar = sm.empty + p.stages;  // the other block may write my shared memory
  uint64_t* data_bar = free_bar + 1;         // the other block's partials have landed
  const int n = p.n, A = p.atoms, head = blockIdx.y;
  const int rank = blockIdx.x % 2, r0 = blockIdx.x / 2 * kRows;
  const int T = n / kRows, t_first = rank ? (T + 1) / 2 : 0;
  const int n_tiles = rank ? T - t_first : (T + 1) / 2;
  const int sa = A;  // one slice
  if (threadIdx.x == 0) {
    mbar_init(sm.res_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_init(free_bar, 1);
    mbar_init(data_bar, 128);
    mbar_fence_init();
  }
  cluster_sync();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const Loads L{{&tm_r0, &tm_r1}, {&tm_s0, &tm_s1}, &tm_s0, 2, 2, r0, head, head, t_first,
                    n_tiles, 0, sa};
      produce(p, sm, L);
    }
    return;
  }
  setmaxnreg_inc<240>();
  const int w = threadIdx.x / 128 - 1;
  const int t128 = threadIdx.x % 128;
  const int warp = t128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int row0 = r0 + warp * 16 + g;
  const float a2 = p.sm_scale * kLog2e;
  int a0, t0;
  split(sa, A, &a0, &t0);
  const int v_lo = w ? a0 : 0, v_hi = w ? sa : a0;
  const size_t own = static_cast<size_t>(head) * n;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float l2r[2], dlr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l2r[r] = p.lse[own + row0 + 8 * r] * kLog2e;
    dlr[r] = p.delta[own + row0 + 8 * r];
  }
  if (p.resident) mbar_wait(sm.res_full, 0);
  RingPos pos;
  for (int t = 0; t < n_tiles; ++t) {
    float sc[32];
    score_tile(sc, p, sm, pos, w, 2, 0, A, lane);
    const float* theirs = exchange(sc, sm, w, t128);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = theirs[i * 128 + t128];
      const float s = w == 0 ? sc[i] : x, dp = w == 0 ? x : sc[i];
      sc[i] = exp2f(fmaf(s, a2, -l2r[(i % 4) / 2])) * (dp - dlr[(i % 4) / 2]);
    }
    uint32_t pa[4][4];
    pack_a<4>(pa, sc);
    output_product(acc, pa, p, sm, pos, sa, v_lo, v_hi, lane);
  }
  // every product and load of this block is done: its shared memory may
  // take the other block's partials
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const uint32_t region = smem_u32(sm.base);
  const int mine = v_hi - v_lo;
  if (w == rank) {
    if (t128 == 0) peer_arrive(peer_addr(smem_u32(free_bar), 1 - rank));
    wait_cluster(data_bar, 0);
    const float* got = reinterpret_cast<const float*>(sm.base);
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      if (i / 32 < mine) {
        const float x = got[i * 128 + t128];
        acc[i] = rank == 0 ? acc[i] + x : x + acc[i];
      }
    const int D = p.d, lane0 = kAtomLanes * v_lo;
    const bool tail = w == 1;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      store_row(acc, r, mine, 1.f, p.sm_scale, lane0, c, p.out0 + (own + row0 + 8 * r) * D,
                nullptr, false, false, tail ? A : 0, tail ? D / kAtomLanes : 0);
  } else {
    wait_cluster(free_bar, 0);
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      if (i / 32 < mine)
        asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(
                         peer_addr(region + (i * 128 + t128) * 4, 1 - rank)),
                     "f"(acc[i])
                     : "memory");
    peer_arrive(peer_addr(smem_u32(data_bar), 1 - rank));
  }
}

}  // namespace

// The wide B4, non-causal, on one 512-lane slice with the keys split
// between the two blocks of a cluster (flash_wide_dq_split_kernel),
// arguments as dfot_flash_bwd_dq_wide without the plan.
extern "C" int variant_flash_bwd_dq_wide_key_split(const void* q, const void* k, const void* v,
                                                   const void* d_o, const void* lse,
                                                   const void* delta, void* dq, int bh, int n,
                                                   int d, int lanes, float sm_scale,
                                                   void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % kRows != 0 || d <= 256 || d % kAtomLanes != 0 ||
      lanes <= 0 || lanes % 16 != 0 || lanes > d || lanes > kSliceAtoms * kAtomLanes)
    return cudaErrorInvalidValue;
  Plan plan = make_plan(kDq, bh, n, lanes);
  plan.slice_atoms = kSliceAtoms;
  plan.slices = 1;
  plan.out_atoms = std::min(kSliceAtoms, plan.stage_bytes / kSlotBytes);
  const int smem = plan.smem + 2 * kBarrier;  // the two cluster barriers
  Params p = params(n, d, sm_scale, 0);
  p.out0 = static_cast<bf16*>(dq);
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.atoms = plan.atoms;
  p.slice_atoms = plan.slice_atoms;
  p.slices = plan.slices;
  p.resident = plan.resident;
  p.stage_atoms = plan.stage_atoms;
  p.out_atoms = plan.out_atoms;
  p.stages = plan.stages;
  p.stage_bytes = plan.stage_bytes;
  p.resident_bytes = plan.resident_bytes;
  const void* ptrs[4] = {q, d_o, k, v};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!make_head_map(&maps[i], ptrs[i], bh, n, d, kRows)) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wide_dq_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(2 * (n / kRows), bh, 1);
  flash_wide_dq_split_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}
