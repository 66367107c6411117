// Whole-row attention for short sequences (N <= 32) on Hopper.
//
// Replaces the Pallas TPU kernel dfot_tpu/ops/attention.py:_small_n_kernel
// (reached through _small_n_impl and small_n_attention): non-causal attention
// over Z = B*H independent items of N tokens, where N is so small (the 8 or
// 16 frames of an axial / factorized temporal attention, the 16 patches of a
// small latent) that a whole item fits on chip. Per item:
//
//   s = (q k^T) * scale        fp32 accumulation of the products
//   p = softmax(s)             fp32, whole row at once (no online softmax)
//   o = cast(p) v              p rounded to v's type, fp32 accumulation
//
// q, k, v, o are all bf16 or all fp32 (the TPU kernel takes either too).
//
// Bound: bytes. An item is 4 * N * D elements of traffic (q, k, v in, o out)
// against 4 * N^2 * D operations, a few per byte, and there are thousands of
// items. The design keeps the memory system busy and takes the arithmetic off
// the issue path:
// - a persistent grid (the plan: up to 4 blocks an SM) walks groups of items;
//   each group's q, k, v rows come into a ring of 2-4 shared-memory stages by
//   16-byte cp.async, issued by every thread a group ahead of the compute, so
//   the loads of the next groups overlap the products of this one. Each row
//   is padded by 16 bytes in shared memory, so the eight rows an ldmatrix
//   reads fall on different banks;
// - bf16: a warp owns 16 query rows of one item, one warp an item for
//   N <= 16, two (halves of the rows, sharing the item's k and v) for
//   N <= 32, so a block of up to 4 warps holds 4 items (or 2) a stage and an
//   item of 32 x 256 no longer runs alone. Both products run on the tensor
//   cores, mma.sync m16n8k16 with fp32 accumulators (an item has at most 32
//   rows, under wgmma's 64). Q and K fragments come by ldmatrix, V by
//   ldmatrix.trans; keys pad to 8 for the scores and to 16 for p v, pad keys
//   get -inf before the softmax, and pad rows are read from a valid row (a
//   finite value times a zero weight) and never stored. The softmax runs on
//   the score fragments (row max and sum by quad shuffles) and p is packed to
//   bf16 A fragments in registers. o is staged in the warp's own q rows (free
//   once the scores are taken) and written with 16-byte stores;
// - fp32 (TF32 stays off, so the products are exact fp32 FMAs): the 8 warps
//   of a block share the stage's items: scores by (row, 4 keys) tasks with
//   the softmax by shuffles, then p v by (4 rows, 4 channels) tasks, both
//   register-blocked over 16-byte loads; o goes out in 16-byte stores
//   straight from registers.
//
// Head dims above 256 go to the wide entry (dfot_small_n_attn_wide, at the
// end), which spreads an item's head over a block's warps; its note says why.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int kMaxN = 32;
constexpr int kMaxWarps = 4;      // bf16: warps of a block, 16 query rows each
constexpr int kWarpsFp32 = 8;     // fp32: warps of a block
constexpr int kMaxItemsFp32 = 16; // fp32: items a stage, at most
constexpr int kMaxStages = 4;
constexpr int kRowPad = 16;       // bytes after every shared-memory row
constexpr int kSmCount = 132;     // H100 SXM
constexpr int kSmemPerSm = 233472;
constexpr int kSmemPerBlock = 232448;
constexpr int kBlockReserve = 1024;  // shared memory the card keeps for each block

// The caller's plan (dfot_tpu_torch/ops/attention.py:small_n_plan), computed
// again here: warps a block, items a stage, stages, shared memory, grid; and
// for the wide entry whether a stage holds whole items.
struct Plan {
  int warps, items_per_stage, stages, smem;
  long long grid;
  bool whole;
};

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// ``item_bytes``: an item's share of a stage (its whole q, k, v rows, or on
// the wide entry's chunked ring one 64-lane chunk of two of them). ``wave``
// (the wide entry): at most as many items a stage as leave a group for
// every SM where the items allow.
bool make_plan(long long items, int n, int item_bytes, bool fp32, Plan* p, bool wave = false) {
  // bf16: a warp an item's 16 query rows, up to 4 warps; fp32: 8 warps share
  // the stage's items, as many as give the score phase 256 (row, 4-key) tasks
  const int units = n <= 16 ? 1 : 2;
  int most = fp32 ? std::min(kMaxItemsFp32, (255 + n * ((n + 3) / 4)) / (n * ((n + 3) / 4)))
                  : kMaxWarps / units;
  while (wave && most > 1 && (items + most - 1) / most < std::min<long long>(items, kSmCount))
    --most;
  for (int ipb = most; ipb >= 1; --ipb) {
    const int warps = fp32 ? kWarpsFp32 : ipb * units, stage = ipb * item_bytes;
    const int fixed = fp32 ? round16(ipb * n * (n + 1) * 4) : 0;
    for (int per_sm : {4, 2, 1}) {
      const int budget = std::min(kSmemPerBlock, (kSmemPerSm - per_sm * kBlockReserve) / per_sm);
      const int stages = std::min(kMaxStages, (budget - fixed) / stage);
      if (stages >= 2) {
        const long long groups = (items + ipb - 1) / ipb;
        *p = {warps, ipb, stages, fixed + stages * stage,
              std::min(groups, static_cast<long long>(per_sm) * kSmCount), true};
        return true;
      }
    }
  }
  return false;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most ``pending`` of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c / cpr, with a shift where cpr is a power of two (``shift`` >= 0)
__device__ __forceinline__ int div_cpr(int c, int cpr, int shift) {
  return shift >= 0 ? c >> shift : c / cpr;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One warp, 16 query rows (from ``row0``) of one bf16 item whose q, k, v rows
// are at ``qs``, ``ks``, ``vs`` in shared memory (``rb`` bytes a row); NT8
// key tiles of 8 cover the item's n keys. ``shift``: log2 of the row's
// 16-byte chunks, or -1.
template <int NT8>
__device__ __forceinline__ void item_bf16(unsigned char* qs, const unsigned char* ks,
                                          const unsigned char* vs, __nv_bfloat16* out, int n,
                                          int d, int rb, int shift, int row0, float scale,
                                          int lane) {
  constexpr int KS = (NT8 + 1) / 2;  // k16 steps of p v
  constexpr float kLog2e = 1.4426950408889634f;
  const int g = lane / 4, t4 = lane % 4;
  // scores: A = 16 q rows (pad rows read the warp's first row), B = k rows
  int qrow = row0 + lane % 16;
  if (qrow >= n) qrow = row0;
  int krow[NT8];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) {
    krow[nt] = nt * 8 + lane % 8;
    if (krow[nt] >= n) krow[nt] = 0;
  }
  const uint32_t qa = smem_u32(qs) + qrow * rb + (lane / 16) * 16;
  const uint32_t kb = smem_u32(ks) + ((lane / 8) % 2) * 16;
  float s[NT8][4];
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < d / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk * 32);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      uint32_t b[2];
      ldmatrix_x2(b, kb + krow[nt] * rb + kk * 32);
      mma_16816(s[nt], a, b[0], b[1]);
    }
  }

  // softmax of rows g (s[.][0..1]) and g + 8 (s[.][2..3]) in base 2; a row's
  // 4 lanes are a quad
  const float scale2 = scale * kLog2e;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool key = nt * 8 + 2 * t4 + e < n;
      s[nt][e] = key ? s[nt][e] * scale2 : -INFINITY;
      s[nt][2 + e] = key ? s[nt][2 + e] * scale2 : -INFINITY;
      m0 = fmaxf(m0, s[nt][e]);
      m1 = fmaxf(m1, s[nt][2 + e]);
    }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = exp2f(s[nt][e] - m0);
      s[nt][2 + e] = exp2f(s[nt][2 + e] - m1);
      l0 += s[nt][e];
      l1 += s[nt][2 + e];
    }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = 1.f / l0;
  l1 = 1.f / l1;
  // p as the A fragments of p v: key tiles 2 ks and 2 ks + 1 make k16 step ks
  uint32_t pa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    pa[ks][0] = pack_bf16x2(s[2 * ks][0] * l0, s[2 * ks][1] * l0);
    pa[ks][1] = pack_bf16x2(s[2 * ks][2] * l1, s[2 * ks][3] * l1);
    if (2 * ks + 1 < NT8) {
      pa[ks][2] = pack_bf16x2(s[2 * ks + 1][0] * l0, s[2 * ks + 1][1] * l0);
      pa[ks][3] = pack_bf16x2(s[2 * ks + 1][2] * l1, s[2 * ks + 1][3] * l1);
    } else {
      pa[ks][2] = pa[ks][3] = 0u;
    }
  }
  __syncwarp();  // every lane is done reading its q rows

  // o = p v, 16 channels at a time; V by ldmatrix.trans (keys past n read row 0)
  int vrow[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    vrow[ks] = ks * 16 + lane % 16;
    if (vrow[ks] >= n) vrow[ks] = 0;
  }
  const uint32_t vb = smem_u32(vs) + (lane / 16) * 16;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll 2
  for (int c16 = 0; c16 < d / 16; ++c16) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vb + vrow[ks] * rb + c16 * 32);
      mma_16816(acc[0], pa[ks], b[0], b[1]);
      mma_16816(acc[1], pa[ks], b[2], b[3]);
    }
    // stage in the q rows: lane holds channels 2 t4, 2 t4 + 1 of each 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int byte = (c16 * 16 + h * 8 + 2 * t4) * 2;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(qs + r0 * rb + byte) = pack_bf16x2(acc[h][0], acc[h][1]);
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(qs + r1 * rb + byte) = pack_bf16x2(acc[h][2], acc[h][3]);
    }
  }
  __syncwarp();
  // the warp's rows of o: 16-byte chunks, consecutive lanes on consecutive chunks
  const int rows = min(16, n - row0), cpr = d / 8;
  for (int c = lane; c < rows * cpr; c += 32) {
    const int r = div_cpr(c, cpr, shift), col = c - r * cpr;
    *reinterpret_cast<uint4*>(out + (row0 + r) * d + col * 8) =
        *reinterpret_cast<const uint4*>(qs + (row0 + r) * rb + col * 16);
  }
  __syncwarp();  // the q rows are the next item's slot
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// fp32, exact FMAs: the block's threads on the ``items`` items of a stage
// (q rows of all items, then k rows, then v rows; ``ipb`` items a stage), in
// phases with the scores in ``sc`` (a row of n + 1 floats): scores by (row,
// 4 keys) tasks (keys kq + j n / 4, so that neighbouring lanes read
// neighbouring k rows) with the softmax by shuffles over a row's tasks (or,
// where they are no power of two, by rows in a phase of its own), then p v
// by (4 rows, 4 channels) tasks, the products register-blocked over 16-byte
// loads.
__device__ __forceinline__ void stage_fp32(const unsigned char* stage, int items, int ipb,
                                           float* sc, float* out, int n, int d, int rb,
                                           float scale) {
  const unsigned char* qs = stage;
  const unsigned char* ks = stage + ipb * n * rb;
  const unsigned char* vs = stage + 2 * ipb * n * rb;
  const int quarts = (n + 3) / 4, quads = d / 4, sld = n + 1, rows = items * n;
  // where a row's quarts tasks are a power of two, they sit in neighbouring
  // lanes of one warp and take the softmax by shuffles; else a second phase
  const bool in_warp = (quarts & (quarts - 1)) == 0;
  for (int base = 0; base < rows * quarts; base += blockDim.x) {
    const int task = min(base + static_cast<int>(threadIdx.x), rows * quarts - 1);
    const int row = task / quarts, kq = task - row * quarts;  // row of the stage, key quarter
    const int first = row - row % n;                          // the item's row 0
    const float4* q = reinterpret_cast<const float4*>(qs + row * rb);
    const float4* k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      k[j] = reinterpret_cast<const float4*>(ks + (first + min(kq + quarts * j, n - 1)) * rb);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < quads; ++c) {
      const float4 qv = q[c];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = dot4(qv, k[j][c], acc[j]);
    }
    if (in_warp) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j] = kq + quarts * j < n ? acc[j] * scale : -INFINITY;
        m = fmaxf(m, acc[j]);
      }
      for (int off = 1; off < quarts; off *= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j] = expf(acc[j] - m);
        l += acc[j];
      }
      for (int off = 1; off < quarts; off *= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = acc[j] / l;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] *= scale;
    }
    if (base + static_cast<int>(threadIdx.x) < rows * quarts) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kq + quarts * j < n) sc[row * sld + kq + quarts * j] = acc[j];
    }
  }
  __syncthreads();
  if (!in_warp) {
    for (int row = threadIdx.x; row < rows; row += blockDim.x) {
      float* s = sc + row * sld;
      float m = s[0];
      for (int j = 1; j < n; ++j) m = fmaxf(m, s[j]);
      float l = 0.f;
      for (int j = 0; j < n; ++j) {
        s[j] = expf(s[j] - m);
        l += s[j];
      }
      for (int j = 0; j < n; ++j) s[j] = s[j] / l;
    }
    __syncthreads();
  }
  for (int task = threadIdx.x; task < items * quarts * quads; task += blockDim.x) {
    const int rq = task / quads, cq = task - rq * quads;  // 4 rows of the stage, 4 channels
    const int it = rq / quarts, r4 = 4 * (rq - it * quarts);
    const float* p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = sc + (it * n + min(r4 + r, n - 1)) * sld;
    float4 acc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    const unsigned char* v = vs + it * n * rb;
    for (int j = 0; j < n; ++j) {
      const float4 vv = reinterpret_cast<const float4*>(v + j * rb)[cq];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = p[r][j];
        acc[r].x = fmaf(pr, vv.x, acc[r].x);
        acc[r].y = fmaf(pr, vv.y, acc[r].y);
        acc[r].z = fmaf(pr, vv.z, acc[r].z);
        acc[r].w = fmaf(pr, vv.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r4 + r < n) reinterpret_cast<float4*>(out + (it * n + r4 + r) * d)[cq] = acc[r];
  }
}

template <typename T, int NT8>
__global__ void __launch_bounds__(kWarpsFp32 * 32)
    small_n_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, long long items, int n, int d,
                        float scale, int items_per_stage, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kFp32 = sizeof(T) == 4;
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int units = n <= 16 ? 1 : 2;
  const int rb = d * static_cast<int>(sizeof(T)) + kRowPad;
  const int tensor_bytes = items_per_stage * n * rb, stage_bytes = 3 * tensor_bytes;
  // fp32: the scores of a stage's items first, then the ring
  float* sc = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + (kFp32 ? round16(items_per_stage * n * (n + 1) * 4) : 0);
  const long long groups = (items + items_per_stage - 1) / items_per_stage;
  const int count =
      groups > blockIdx.x ? static_cast<int>((groups - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  const int cpr = d / kElems;  // 16-byte chunks a row
  const int shift = (cpr & (cpr - 1)) == 0 ? __ffs(cpr) - 1 : -1;

  // the i-th group of this block into stage i % stages: the q rows of its
  // items, then their k rows, then their v rows (each a contiguous run in
  // device memory), every thread copying 16-byte chunks
  auto load = [&](int i) {
    const long long first = (blockIdx.x + static_cast<long long>(i) * gridDim.x) * items_per_stage;
    const int chunks =
        static_cast<int>(min(static_cast<long long>(items_per_stage), items - first)) * n * cpr;
    unsigned char* slot = ring + (i % stages) * stage_bytes;
    const long long base = first * n * d;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const T* src = (t == 0 ? q : t == 1 ? k : v) + base;
      unsigned char* dst = slot + t * tensor_bytes;
      for (int c = tid; c < chunks; c += blockDim.x) {
        const int row = div_cpr(c, cpr, shift), col = c - row * cpr;
        cp_async16(dst + row * rb + col * 16, src + row * d + col * kElems);
      }
    }
  };

  for (int i = 0; i < stages - 1; ++i) {
    if (i < count) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    if (i + stages - 1 < count) load(i + stages - 1);
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();
    unsigned char* stage = ring + (i % stages) * stage_bytes;
    const long long first = (blockIdx.x + static_cast<long long>(i) * gridDim.x) * items_per_stage;
    if constexpr (kFp32) {
      const int here =
          static_cast<int>(min(static_cast<long long>(items_per_stage), items - first));
      stage_fp32(stage, here, items_per_stage, sc, reinterpret_cast<float*>(o) + first * n * d,
                 n, d, rb, scale);
    } else {
      const int it = warp / units;
      if (it < items_per_stage && first + it < items) {
        unsigned char* qs = stage + it * n * rb;
        item_bf16<NT8>(qs, qs + tensor_bytes, qs + 2 * tensor_bytes,
                       reinterpret_cast<__nv_bfloat16*>(o) + (first + it) * n * d, n, d, rb,
                       shift, 16 * (warp % units), scale, lane);
      }
    }
    __syncthreads();  // the stage is refilled by the next round's load
  }
  cp_async_wait(0);
}

template <typename T, int NT8>
int launch(const void* q, const void* k, const void* v, void* o, long long items, int n, int d,
           float scale, const Plan& plan, cudaStream_t stream) {
  auto kernel = small_n_attn_kernel<T, NT8>;
  // once per instantiation: the most shared memory a block can take
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(plan.grid), plan.warps * 32, plan.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), items, n, d, scale, plan.items_per_stage, plan.stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* q, const void* k, const void* v, void* o, long long items, int n, int d,
             float scale, const Plan& plan, cudaStream_t stream) {
  if (sizeof(T) == 4) return launch<T, 4>(q, k, v, o, items, n, d, scale, plan, stream);
  if (n <= 8) return launch<T, 1>(q, k, v, o, items, n, d, scale, plan, stream);
  if (n <= 16) return launch<T, 2>(q, k, v, o, items, n, d, scale, plan, stream);
  return launch<T, 4>(q, k, v, o, items, n, d, scale, plan, stream);
}

// ---------------------------------------------------------------------------
// The wide entry: head dims above 256, the head spread over the warps
// ---------------------------------------------------------------------------
//
// The same function as the narrow entry (the TPU kernel _small_n_kernel at
// d > 256, which the JAX dispatcher gives every non-causal row of N <= 32
// with d % 64 == 0), and the same bound: bytes. What holds it back is
// latency, not bytes: the paths give it few items (the factorized DiT at one
// head: 128 items of (16, 384), 4.8 MB), so a plan of several items a block
// leaves most SMs idle, and each block's items would wait on a chain of
// dependent loads. So:
// - whole-item stages where two stages of an item fit a block's share of the
//   SM (every path site: an item of (16, 384) is 37.6 KB): one item a group,
//   its q and k rows one cp.async commit group and its v rows a second, so
//   the scores start while v is still in flight; as many blocks as items, up
//   to the SM's share (4, 2 or 1 blocks an SM), so the grid covers a wave of
//   132 SMs wherever there are that many items;
// - bf16: the item's head spread over the block's warps: each 16-row unit of
//   the item takes ``parts`` warps (d / 64 chunks dealt round, at most 8
//   warps a block), each contracting its own 64-lane chunks of q and k into
//   partial scores on mma.sync; the partials are summed through shared
//   memory in one fixed order (part 0 first), so every warp of a unit holds
//   the same scores bit for bit and runs the same softmax; each warp then
//   computes o on its own chunks of v, staged in the item's q rows (free
//   once every warp has its scores) and written in 16-byte stores;
// - fp32: whole items on the narrow entry's fp32 kernel (its 8 warps share a
//   stage's items), with fewer items a stage where that gives a wave;
// - where two stages of a whole item do not fit (bf16 (32, 1152); fp32 rows
//   of 32 at 768 and more), the head streams through one cp.async ring in
//   64-lane chunks: d / 64 score steps bringing the q and k chunk of a group
//   of items, the softmax after the last, then d / 64 output steps bringing
//   v's chunk, whose 64 lanes of o are computed, cast and stored before the
//   next. A stage and the registers no longer depend on d, and q, k and v
//   are each read once. Every step is one commit group of the ring, the
//   empty ones past the block's last step too, so the wait before step i
//   always leaves the newest stages - 1 groups in flight, across the two
//   phases and across groups.

constexpr int kChunk = 64;     // lanes of a chunk
constexpr int kWideWarps = 8;  // bf16 whole items: warps of a block, at most

template <typename T>
__host__ __device__ constexpr int wide_row_bytes() {
  return kChunk * static_cast<int>(sizeof(T)) + kRowPad;
}

// key tiles of 8 for rows of n: 1, 2 or 4
__host__ __device__ inline int key_tiles(int n) { return n <= 8 ? 1 : n <= 16 ? 2 : 4; }

// bf16: the warp's 16 query rows (from ``row0``) of one item against its keys,
// on one 64-lane chunk of q (``qs``) and k (``ks``), rows ``rb`` bytes apart,
// accumulated into ``s``
template <int NT8>
__device__ __forceinline__ void wide_scores_bf16(const unsigned char* qs, const unsigned char* ks,
                                                 int rb, float (&s)[NT8][4], int n, int row0,
                                                 int lane) {
  int qrow = row0 + lane % 16;
  if (qrow >= n) qrow = row0;
  const uint32_t qa = smem_u32(qs) + qrow * rb + (lane / 16) * 16;
  const uint32_t kb = smem_u32(ks) + ((lane / 8) % 2) * 16;
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk * 32);
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      int krow = nt * 8 + lane % 8;
      if (krow >= n) krow = 0;
      uint32_t b[2];
      ldmatrix_x2(b, kb + krow * rb + kk * 32);
      mma_16816(s[nt], a, b[0], b[1]);
    }
  }
}

// bf16: the softmax of the warp's rows g and g + 8 (a quad each), in base 2,
// keys past n at -inf, packed to the A fragments of p v
template <int NT8>
__device__ __forceinline__ void wide_softmax_bf16(float (&s)[NT8][4],
                                                  uint32_t (&pa)[(NT8 + 1) / 2][4], int n,
                                                  float scale, int lane) {
  constexpr int KS = (NT8 + 1) / 2;
  const float scale2 = scale * 1.4426950408889634f;
  const int t4 = lane % 4;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool key = nt * 8 + 2 * t4 + e < n;
      s[nt][e] = key ? s[nt][e] * scale2 : -INFINITY;
      s[nt][2 + e] = key ? s[nt][2 + e] * scale2 : -INFINITY;
      m0 = fmaxf(m0, s[nt][e]);
      m1 = fmaxf(m1, s[nt][2 + e]);
    }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = exp2f(s[nt][e] - m0);
      s[nt][2 + e] = exp2f(s[nt][2 + e] - m1);
      l0 += s[nt][e];
      l1 += s[nt][2 + e];
    }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = 1.f / l0;
  l1 = 1.f / l1;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    pa[ks][0] = pack_bf16x2(s[2 * ks][0] * l0, s[2 * ks][1] * l0);
    pa[ks][1] = pack_bf16x2(s[2 * ks][2] * l1, s[2 * ks][3] * l1);
    if (2 * ks + 1 < NT8) {
      pa[ks][2] = pack_bf16x2(s[2 * ks + 1][0] * l0, s[2 * ks + 1][1] * l0);
      pa[ks][3] = pack_bf16x2(s[2 * ks + 1][2] * l1, s[2 * ks + 1][3] * l1);
    } else {
      pa[ks][2] = pa[ks][3] = 0u;
    }
  }
}

// bf16: the warp's 16 rows of one 64-lane chunk of o = p v from v's chunk at
// ``vs``, staged in the item's rows at ``os`` (``rb`` bytes apart, the chunk's
// own lanes of rows no other warp reads any more) and written to ``out`` (the
// chunk's first lane of the item's row 0) in 16-byte stores
template <int NT8>
__device__ __forceinline__ void wide_out_bf16(const unsigned char* vs, unsigned char* os, int rb,
                                              const uint32_t (&pa)[(NT8 + 1) / 2][4],
                                              __nv_bfloat16* out, int n, int d, int row0,
                                              int lane) {
  constexpr int KS = (NT8 + 1) / 2;
  const int g = lane / 4, t4 = lane % 4, r0 = row0 + g, r1 = r0 + 8;
  int vrow[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    vrow[ks] = ks * 16 + lane % 16;
    if (vrow[ks] >= n) vrow[ks] = 0;
  }
  const uint32_t vb = smem_u32(vs) + (lane / 16) * 16;
#pragma unroll
  for (int c16 = 0; c16 < kChunk / 16; ++c16) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vb + vrow[ks] * rb + c16 * 32);
      mma_16816(acc[0], pa[ks], b[0], b[1]);
      mma_16816(acc[1], pa[ks], b[2], b[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int byte = (c16 * 16 + h * 8 + 2 * t4) * 2;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(os + r0 * rb + byte) = pack_bf16x2(acc[h][0], acc[h][1]);
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(os + r1 * rb + byte) = pack_bf16x2(acc[h][2], acc[h][3]);
    }
  }
  __syncwarp();
  constexpr int cpr = kChunk / 8;  // 16-byte pieces of a chunk's row
  const int rows = min(16, n - row0);
  for (int c = lane; c < rows * cpr; c += 32) {
    const int r = row0 + c / cpr, col = c % cpr;
    *reinterpret_cast<uint4*>(out + r * d + col * 8) =
        *reinterpret_cast<const uint4*>(os + r * rb + col * 16);
  }
  __syncwarp();
}

// bf16 whole items: the block's items one at a time (one an SM's share of
// blocks, walking the items b, b + grid, ...), each in a stage of the ring as
// two commit groups (q and k, then v); warp w takes 16-row unit w / parts
// and the 64-lane chunks c = w % parts, + parts, ...
template <int NT8>
__global__ void __launch_bounds__(kWideWarps * 32)
    small_n_whole_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         long long items, int n, int d, float scale, int parts, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = (NT8 + 1) / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int unit = warp / parts, part = warp % parts, row0 = 16 * unit;
  const int chunks = d / kChunk, cpr = d / 8, rb = 2 * d + kRowPad;
  const int tensor_bytes = n * rb, item_bytes = 3 * tensor_bytes;
  // the warps' partial scores, [warp][key tile][element][lane], then the ring
  float* xs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + (blockDim.x / 32) * NT8 * 4 * 32 * 4;
  const int count =
      items > blockIdx.x ? static_cast<int>((items - 1 - blockIdx.x) / gridDim.x + 1) : 0;

  // the block's i-th item into stage i % stages, as two commit groups (empty
  // past the block's last item): its q and k rows, then its v rows
  auto issue = [&](int i) {
    const long long item = blockIdx.x + static_cast<long long>(i) * gridDim.x;
    unsigned char* slot = ring + (i % stages) * item_bytes;
    for (int h = 0; h < 2; ++h) {
      if (i < count) {
        for (int t = 2 * h; t < 2 + h; ++t) {
          const __nv_bfloat16* src = (t == 0 ? q : t == 1 ? k : v) + item * n * d;
          unsigned char* dst = slot + t * tensor_bytes;
          for (int c = tid; c < n * cpr; c += blockDim.x) {
            const int row = c / cpr, col = c - row * cpr;
            cp_async16(dst + row * rb + col * 16, src + row * d + col * 8);
          }
        }
      }
      cp_async_commit();
    }
  };

  for (int i = 0; i < stages - 1; ++i) issue(i);
  for (int i = 0; i < count; ++i) {
    issue(i + stages - 1);  // the stage item i - 1 left
    unsigned char* qs = ring + (i % stages) * item_bytes;
    unsigned char* ks = qs + tensor_bytes;
    unsigned char* vs = ks + tensor_bytes;
    // q and k of item i: its v and the later items' groups may be in flight
    cp_async_wait(2 * stages - 1);
    __syncthreads();
    float s[NT8][4];
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int c = part; c < chunks; c += parts)
      wide_scores_bf16<NT8>(qs + c * 128, ks + c * 128, rb, s, n, row0, lane);
    if (parts > 1) {
      // the unit's partials summed part 0 first, the same bits on every warp
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[((warp * NT8 + nt) * 4 + e) * 32 + lane] = s[nt][e];
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = xs[((unit * parts * NT8 + nt) * 4 + e) * 32 + lane];
          for (int j = 1; j < parts; ++j)
            sum += xs[(((unit * parts + j) * NT8 + nt) * 4 + e) * 32 + lane];
          s[nt][e] = sum;
        }
    }
    uint32_t pa[KS][4];
    wide_softmax_bf16<NT8>(s, pa, n, scale, lane);
    // v of item i; past this barrier no warp reads q or k of the item, nor
    // the partials
    cp_async_wait(2 * stages - 2);
    __syncthreads();
    __nv_bfloat16* out = o + (blockIdx.x + static_cast<long long>(i) * gridDim.x) * n * d;
    for (int c = part; c < chunks; c += parts)
      wide_out_bf16<NT8>(vs + c * 128, qs + c * 128, rb, pa, out + c * kChunk, n, d, row0, lane);
    __syncthreads();  // the stage is refilled by a later item's load
  }
  cp_async_wait(0);
}

// fp32: the scores of a stage's ``items`` items on one 64-lane chunk of q
// (``qs``) and k (``ks``), by (row, 4 keys) tasks (keys kq + j quarts), added
// to the score rows ``sc`` (n + 1 floats a row; set on the first chunk)
__device__ __forceinline__ void wide_scores_fp32(const unsigned char* qs, const unsigned char* ks,
                                                 float* sc, int items, int n, bool first) {
  constexpr int rb = wide_row_bytes<float>();
  const int quarts = (n + 3) / 4, sld = n + 1, rows = items * n;
  for (int task = threadIdx.x; task < rows * quarts; task += blockDim.x) {
    const int row = task / quarts, kq = task - row * quarts;
    const int row_0 = row - row % n;  // the item's row 0
    const float4* q = reinterpret_cast<const float4*>(qs + row * rb);
    const float4* k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      k[j] = reinterpret_cast<const float4*>(ks + (row_0 + min(kq + quarts * j, n - 1)) * rb);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < kChunk / 4; ++c) {
      const float4 qv = q[c];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = dot4(qv, k[j][c], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kq + quarts * j < n) {
        float* dst = sc + row * sld + kq + quarts * j;
        *dst = first ? acc[j] : *dst + acc[j];
      }
  }
}

// fp32: the scaled scores of each row turned into its softmax, a thread a row
__device__ __forceinline__ void wide_softmax_fp32(float* sc, int items, int n, float scale) {
  for (int row = threadIdx.x; row < items * n; row += blockDim.x) {
    float* s = sc + row * (n + 1);
    float m = -INFINITY;
    for (int j = 0; j < n; ++j) {
      s[j] *= scale;
      m = fmaxf(m, s[j]);
    }
    float l = 0.f;
    for (int j = 0; j < n; ++j) {
      s[j] = expf(s[j] - m);
      l += s[j];
    }
    for (int j = 0; j < n; ++j) s[j] = s[j] / l;
  }
}

// fp32: one 64-lane chunk of o = p v for a stage's items from v's chunk at
// ``vs``, by (4 rows, 4 lanes) tasks, stored to ``out`` (the chunk's first
// lane of the first item's row 0) straight from registers
__device__ __forceinline__ void wide_out_fp32(const unsigned char* vs, const float* sc,
                                              float* out, int items, int n, int d) {
  constexpr int rb = wide_row_bytes<float>();
  constexpr int quads = kChunk / 4;
  const int quarts = (n + 3) / 4, sld = n + 1;
  for (int task = threadIdx.x; task < items * quarts * quads; task += blockDim.x) {
    const int rq = task / quads, cq = task - rq * quads;
    const int it = rq / quarts, r4 = 4 * (rq - it * quarts);
    const float* p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = sc + (it * n + min(r4 + r, n - 1)) * sld;
    float4 acc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    const unsigned char* v = vs + it * n * rb;
    for (int j = 0; j < n; ++j) {
      const float4 vv = reinterpret_cast<const float4*>(v + j * rb)[cq];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = p[r][j];
        acc[r].x = fmaf(pr, vv.x, acc[r].x);
        acc[r].y = fmaf(pr, vv.y, acc[r].y);
        acc[r].z = fmaf(pr, vv.z, acc[r].z);
        acc[r].w = fmaf(pr, vv.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r4 + r < n)
        reinterpret_cast<float4*>(out + static_cast<long long>(it * n + r4 + r) * d)[cq] = acc[r];
  }
}

// the chunked ring: items too wide for two whole stages
template <typename T, int NT8>
__global__ void __launch_bounds__(kWarpsFp32 * 32)
    small_n_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, long long items, int n, int d,
                        float scale, int items_per_stage, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kFp32 = sizeof(T) == 4;
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte piece
  constexpr int kCpr = kChunk / kElems;                      // 16-byte pieces of a chunk's row
  constexpr int rb = wide_row_bytes<T>();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int units = n <= 16 ? 1 : 2;
  // a stage: the chunk of q (score steps) or v (output steps), then k's chunk
  const int half = items_per_stage * n * rb, stage_bytes = 2 * half;
  float* sc = reinterpret_cast<float*>(smem);  // fp32: the scores, before the ring
  unsigned char* ring = smem + (kFp32 ? round16(items_per_stage * n * (n + 1) * 4) : 0);
  const int chunks = d / kChunk, per_group = 2 * chunks;
  const long long groups = (items + items_per_stage - 1) / items_per_stage;
  const int count =
      groups > blockIdx.x ? static_cast<int>((groups - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  const long long steps = static_cast<long long>(count) * per_group;
  auto first_item = [&](int gi) {
    return (blockIdx.x + static_cast<long long>(gi) * gridDim.x) * items_per_stage;
  };

  // step j of this block into stage j % stages: of group j / per_group, the
  // q and k chunk c of its items (c = j % per_group < chunks) or v's chunk
  // c - chunks, every thread copying 16-byte pieces
  auto load = [&](long long j) {
    const int gi = static_cast<int>(j / per_group), ph = static_cast<int>(j % per_group);
    const long long first = first_item(gi);
    const int rows =
        static_cast<int>(min(static_cast<long long>(items_per_stage), items - first)) * n;
    const bool score = ph < chunks;
    const long long base = first * n * d + (score ? ph : ph - chunks) * kChunk;
    unsigned char* slot = ring + static_cast<int>(j % stages) * stage_bytes;
    for (int t = 0; t < (score ? 2 : 1); ++t) {
      const T* src = (score ? (t == 0 ? q : k) : v) + base;
      unsigned char* dst = slot + t * half;
      for (int c = tid; c < rows * kCpr; c += blockDim.x) {
        const int row = c / kCpr, col = c % kCpr;
        cp_async16(dst + row * rb + col * 16,
                   src + static_cast<long long>(row) * d + col * kElems);
      }
    }
  };

  for (int j = 0; j < stages - 1; ++j) {
    if (j < steps) load(j);
    cp_async_commit();
  }
  long long i = 0;  // this block's next step
  // step i's stage, once it has come, with step i + stages - 1 in flight
  auto arrive = [&]() {
    if (i + stages - 1 < steps) load(i + stages - 1);
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncthreads();
    return ring + static_cast<int>(i % stages) * stage_bytes;
  };

  for (int gi = 0; gi < count; ++gi) {
    const long long first = first_item(gi);
    const int here =
        static_cast<int>(min(static_cast<long long>(items_per_stage), items - first));
    if constexpr (kFp32) {
      float* out = reinterpret_cast<float*>(o) + first * n * d;
      for (int c = 0; c < chunks; ++c, ++i) {
        unsigned char* stage = arrive();
        wide_scores_fp32(stage, stage + half, sc, here, n, c == 0);
        if (c == chunks - 1) {
          __syncthreads();
          wide_softmax_fp32(sc, here, n, scale);
        }
        __syncthreads();  // the stage is refilled by a later step's load
      }
      for (int c = 0; c < chunks; ++c, ++i) {
        unsigned char* stage = arrive();
        wide_out_fp32(stage, sc, out + c * kChunk, here, n, d);
        __syncthreads();
      }
    } else {
      constexpr int KS = (NT8 + 1) / 2;
      const int it = warp / units, row0 = 16 * (warp % units);
      const bool mine = it < here;
      const int item_off = it * n * rb;
      float s[NT8][4];
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      for (int c = 0; c < chunks; ++c, ++i) {
        unsigned char* stage = arrive();
        if (mine)
          wide_scores_bf16<NT8>(stage + item_off, stage + half + item_off, rb, s, n, row0, lane);
        __syncthreads();
      }
      uint32_t pa[KS][4];
      if (mine) wide_softmax_bf16<NT8>(s, pa, n, scale, lane);
      __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(o) + (first + it) * n * d;
      for (int c = 0; c < chunks; ++c, ++i) {
        unsigned char* stage = arrive();
        if (mine)
          wide_out_bf16<NT8>(stage + item_off, stage + half + item_off, rb, pa,
                             out + c * kChunk, n, d, row0, lane);
        __syncthreads();
      }
    }
  }
  cp_async_wait(0);
}

// The wide entry's plan. Whole items where two stages of one fit a block:
// bf16, one item a group, each 16-row unit's head dealt over ``parts`` warps
// (as many as leave each warp the fewest chunks, at most kWideWarps a
// block), the warps' partial scores beside the ring, at 4, 2 or 1 blocks an
// SM, the most that fit; fp32, the narrow entry's plan with a wave of
// groups. Otherwise the chunked ring, with a wave of groups.
bool make_wide_plan(long long items, int n, int d, bool fp32, Plan* p) {
  const int whole = 3 * n * (d * (fp32 ? 4 : 2) + kRowPad);
  if (fp32) {
    if (round16(n * (n + 1) * 4) + 2 * whole <= kSmemPerBlock)
      return make_plan(items, n, whole, true, p, true);
  } else {
    const int units = n <= 16 ? 1 : 2, chunks = d / kChunk, most = kWideWarps / units;
    const int per = (chunks + most - 1) / most, warps = units * ((chunks + per - 1) / per);
    const int fixed = warps * key_tiles(n) * 4 * 32 * 4;
    for (int per_sm : {4, 2, 1}) {
      const int budget = std::min(kSmemPerBlock, (kSmemPerSm - per_sm * kBlockReserve) / per_sm);
      const int stages = std::min(kMaxStages, (budget - fixed) / whole);
      if (stages >= 2) {
        *p = {warps, 1, stages, fixed + stages * whole,
              std::min(items, static_cast<long long>(per_sm) * kSmCount), true};
        return true;
      }
    }
  }
  if (!make_plan(items, n, 2 * n * (kChunk * (fp32 ? 4 : 2) + kRowPad), fp32, p, true))
    return false;
  p->whole = false;
  return true;
}

template <typename T, int NT8>
int launch_wide(const void* q, const void* k, const void* v, void* o, long long items, int n,
                int d, float scale, const Plan& plan, cudaStream_t stream) {
  auto kernel = small_n_wide_kernel<T, NT8>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<static_cast<unsigned>(plan.grid), plan.warps * 32, plan.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), items, n, d, scale, plan.items_per_stage, plan.stages);
  return static_cast<int>(cudaGetLastError());
}

template <int NT8>
int launch_whole(const void* q, const void* k, const void* v, void* o, long long items, int n,
                 int d, float scale, const Plan& plan, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kernel = small_n_whole_kernel<NT8>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int units = n <= 16 ? 1 : 2;
  kernel<<<static_cast<unsigned>(plan.grid), plan.warps * 32, plan.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), items, n, d, scale, plan.warps / units, plan.stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (items, N, D) contiguous, all bf16 (is_fp32 = 0) or all fp32
// (is_fp32 = 1), 16-byte aligned; 1 <= N <= 32, D a multiple of 16 up to 256.
// ``warps``, ``items_per_stage``, ``stages``, ``smem`` and ``grid``: the
// caller's plan (dfot_tpu_torch/ops/attention.py:small_n_plan), refused
// unless it is the one computed here. Returns a cudaError_t code.
extern "C" int dfot_small_n_attn(const void* q, const void* k, const void* v, void* o,
                                 long long items, int n, int d, float scale, int is_fp32,
                                 int warps, int items_per_stage, int stages, int smem,
                                 long long grid, void* stream) {
  if (items <= 0 || n <= 0 || n > kMaxN || d <= 0 || d % 16 != 0 || d > 256)
    return cudaErrorInvalidValue;
  Plan plan;
  if (!make_plan(items, n, 3 * n * (d * (is_fp32 ? 4 : 2) + kRowPad), is_fp32, &plan) ||
      plan.warps != warps ||
      plan.items_per_stage != items_per_stage || plan.stages != stages || plan.smem != smem ||
      plan.grid != grid)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return is_fp32 ? launch_n<float>(q, k, v, o, items, n, d, scale, plan, s)
                 : launch_n<__nv_bfloat16>(q, k, v, o, items, n, d, scale, plan, s);
}

// The wide entry, d > 256: arguments as dfot_small_n_attn's, D a multiple of
// 64 above 256, the plan the wide entry's (make_wide_plan).
extern "C" int dfot_small_n_attn_wide(const void* q, const void* k, const void* v, void* o,
                                      long long items, int n, int d, float scale, int is_fp32,
                                      int warps, int items_per_stage, int stages, int smem,
                                      long long grid, void* stream) {
  if (items <= 0 || n <= 0 || n > kMaxN || d <= 256 || d % kChunk != 0)
    return cudaErrorInvalidValue;
  Plan plan;
  if (!make_wide_plan(items, n, d, is_fp32, &plan) || plan.warps != warps ||
      plan.items_per_stage != items_per_stage || plan.stages != stages || plan.smem != smem ||
      plan.grid != grid)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const int nt8 = key_tiles(n);
  if (plan.whole) {
    if (is_fp32) return launch<float, 4>(q, k, v, o, items, n, d, scale, plan, s);
    if (nt8 == 1) return launch_whole<1>(q, k, v, o, items, n, d, scale, plan, s);
    if (nt8 == 2) return launch_whole<2>(q, k, v, o, items, n, d, scale, plan, s);
    return launch_whole<4>(q, k, v, o, items, n, d, scale, plan, s);
  }
  if (is_fp32) return launch_wide<float, 1>(q, k, v, o, items, n, d, scale, plan, s);
  if (nt8 == 1) return launch_wide<bf16, 1>(q, k, v, o, items, n, d, scale, plan, s);
  if (nt8 == 2) return launch_wide<bf16, 2>(q, k, v, o, items, n, d, scale, plan, s);
  return launch_wide<bf16, 4>(q, k, v, o, items, n, d, scale, plan, s);
}
