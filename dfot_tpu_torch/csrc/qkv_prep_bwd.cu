// Backward of the fused qkv preparation for Hopper: head-major cotangents ->
// packed dqkv and the RoPE tables' cotangents.
//
// Replaces the Pallas TPU kernel dfot_tpu/ops/qkv_prep.py:_bwd_kernel (reached
// through _qkv_prep_bwd). Same function, the VJP of qkv_prep.cu: with
// u = bf16(x / rms(x)) (or u = x without the norm) and
// y = u * cos + swap_pairs(u) * sin the forward result,
//
//   du   = dy * cos + swap_pairs(dy * sin)
//   dx   = r * du - x * r^3 * mean(du * x)        r = 1 / rms(x), all in fp32
//   dcos = sum_{batch, heads} u * dy              dsin = sum swap_pairs(u) * dy
//
// for the q and k streams, and dv copied through; dqkv is written in the
// packed (B, N, 3*H*D) layout with the caller's row strides, the table
// cotangents as (N, D) fp32.
//
// Bound: data movement (per token read the 2HD packed q, k values and 3HD
// cotangent lanes, write 3HD), about two operations per byte. The table
// cotangents are sums over batch AND heads, which the TPU kernel carries
// across its sequential batch grid axis; Hopper's blocks run in no order, so
// the sum has to stay inside a block. The design (the plan:
// dfot_tpu_torch/ops/qkv_prep.py:prep_bwd_plan):
// - a block owns a tile of ``tile`` tokens of one stream (q or k), so the
//   grid is 2 x N / tile blocks (the largest tile of 32 tokens or fewer
//   that still gives every SM 3 blocks, as many as it holds), and its 256
//   threads form ``groups`` lane groups that take the (batch, head) items
//   of the tile in turns: item i goes to group
//   i % groups. In a group, ``lanes`` lanes (a power of two) own a token row
//   and each lane 8 adjacent lanes of it (one 16-byte chunk), so the RoPE
//   pair swaps stay in its registers and the row's two means are shuffle
//   reductions over the lanes; the lane's cos and sin stay in registers for
//   the whole tile, and its dcos and dsin partials too;
// - a lane streams the x and dy chunks of its items through a private ring
//   of 6 shared-memory stages by 16-byte cp.async, five items ahead of the
//   one it works on: the loads in flight cost no registers, and since a lane
//   reads only what it copied itself, no barrier stands between items; dx
//   goes out in 16-byte stores;
// - at the end the groups' partials meet in shared memory and are summed in
//   group order, each table element written once: no atomics, no second
//   pass, the same bits from call to call;
// - the v stream is a pure copy: the q block of a tile copies the tile's
//   rows of the even items' dv into the packed v columns, the k block those
//   of the odd ones, four 16-byte loads in flight a thread.
// Two earlier versions were slower at K600 @DiT/XL, where a group walks 32
// to 64 items: a block-wide ring of bulk copies (cp.async.bulk on mbarriers,
// as qkv_prep.cu does), whose every item waited on the block's slowest
// thread, and four items prefetched into registers, which spilled.
// A head dim or padded width that is no multiple of 8, or rows off a 16-byte
// boundary, takes the same kernel with 4-byte chunks (V = 2, up to 4 chunks
// a lane).
// Head dims above 256 (up to kMaxHeadDim) take wide instantiations: a warp
// owns a row (lanes = 32) and each lane holds KMAX chunks (2, 3 or 5 of 16
// bytes by d, or 20 of 4), the row's two means still shuffle reductions over
// the whole row; the registers that takes leave one block an SM, so the tile
// is chosen for one, and a lane's ring has 3 stages of KMAX chunks. The
// groups' partials (8 x 2 d fp32: 64 d bytes) still fit the rings' shared
// memory (at least 96 d bytes), and are summed in the same fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kStages = 6;       // a lane's ring: the chunks of 5 items in flight
constexpr int kSmCount = 132;    // H100 SXM
constexpr int kBlocksPerSm = 3;  // blocks an SM holds (registers and shared memory)
constexpr int kWideStages = 3;   // the same above a head dim of 256
constexpr int kWideBlocksPerSm = 1;
constexpr int kMaxHeadDim = 1280;

// a stage of a lane's ring: every lane's KMAX x and dy chunks of V bf16 lanes
template <int V, int KMAX>
__host__ __device__ constexpr int stage_bytes() { return 2 * KMAX * kThreads * 2 * V; }

template <int V>
struct Chunk;
template <>
struct Chunk<8> { using T = uint4; };
template <>
struct Chunk<2> { using T = uint32_t; };

template <int V>
__device__ __forceinline__ void unpack(const bf16* p, float (&x)[V]) {
  const typename Chunk<V>::T raw = *reinterpret_cast<const typename Chunk<V>::T*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void pack_store(bf16* p, const float (&y)[V]) {
  typename Chunk<V>::T raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < V / 2; ++i) h[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
  *reinterpret_cast<typename Chunk<V>::T*>(p) = raw;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one chunk of V bf16 lanes (16 or 4 bytes) from device into shared memory
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (V == 8)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The caller's plan, computed again here (dfot_tpu_torch/ops/qkv_prep.py:
// prep_bwd_plan).
struct Plan {
  int lanes, tile, groups, smem, tiles, chunks, stages;
};

Plan make_plan(int n, int d, int chunk) {
  Plan p;
  const bool wide = d > 256;
  p.lanes = 1;
  while (p.lanes * chunk < d && p.lanes < 32) p.lanes *= 2;
  p.tile = 1;
  const int per_sm = wide ? kWideBlocksPerSm : kBlocksPerSm;
  for (int t : {32, 16, 8, 4, 2})
    if (t * p.lanes <= kThreads && 2 * ((n + t - 1) / t) >= per_sm * kSmCount) {
      p.tile = t;
      break;
    }
  p.groups = kThreads / (p.tile * p.lanes);
  p.tiles = (n + p.tile - 1) / p.tile;
  // chunks a lane holds: one 16-byte chunk or four 4-byte ones up to d = 256
  p.chunks = !wide ? (chunk == 8 ? 1 : 4) : chunk == 2 ? 20 : d <= 512 ? 2 : d <= 768 ? 3 : 5;
  p.stages = wide ? kWideStages : kStages;
  // the lanes' rings, where the groups' partials (2 x 256 / lanes x d fp32:
  // at most 16 KB up to d = 256, 64 d bytes above) meet at the end
  p.smem = p.stages * 2 * p.chunks * kThreads * 2 * chunk;
  return p;
}

struct Args {
  const bf16* qkv;
  long long stride_b, stride_n;
  const bf16* tabs[4];  // cq, sq, ck, sk
  const bf16* dy[3];    // dq, dk, dv
  bf16* dqkv;
  long long out_stride_b, out_stride_n;
  float* dtabs[4];      // dcq, dsq, dck, dsk
  int batch, n, heads, d, dp, norm;
  float eps;
  int lanes, tile, groups, tiles;
};

// the tile's rows of dv (first d lanes) into the packed v columns, for the
// items of parity s: the q block of a tile copies the even items, the k block
// the odd ones; four loads in flight a thread
template <int V>
__device__ __forceinline__ void copy_v(const Args& a, int s, int t0, int rows) {
  using C = typename Chunk<V>::T;
  const int cpr = a.d / V, per_item = rows * cpr;
  const int total = (a.batch * a.heads - s + 1) / 2 * per_item;
  for (int j0 = threadIdx.x; j0 < total; j0 += 4 * kThreads) {
    C val[4];
    long long at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * kThreads;
      at[u] = -1;
      if (j < total) {
        const int item = 2 * (j / per_item) + s, rem = j % per_item;
        const int row = rem / cpr, c = rem % cpr, b = item / a.heads, h = item % a.heads;
        val[u] = *reinterpret_cast<const C*>(
            a.dy[2] + (static_cast<long long>(item) * a.n + t0 + row) * a.dp + c * V);
        at[u] = b * a.out_stride_b + (t0 + row) * a.out_stride_n +
                static_cast<long long>(2 * a.heads + h) * a.d + c * V;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0) *reinterpret_cast<C*>(a.dqkv + at[u]) = val[u];
  }
}

// grid: 2 x tiles (tile, stream) blocks; KMAX chunks a lane, a lane's ring
// of STAGES stages, BLOCKS blocks an SM
template <int V, int KMAX, int STAGES, int BLOCKS>
__global__ void __launch_bounds__(kThreads, BLOCKS) qkv_prep_bwd_kernel(const Args a) {
  using C = typename Chunk<V>::T;
  constexpr int kMax = KMAX;  // chunks a lane holds
  constexpr int kStages = STAGES;
  constexpr int kStageBytes = stage_bytes<V, KMAX>();
  const int s = blockIdx.x % 2;         // stream: q, k
  const int t0 = (blockIdx.x / 2) * a.tile;
  const int rows = min(a.tile, a.n - t0);
  const int d = a.d, G = a.lanes, nc = d / V;
  const int gi = threadIdx.x / (a.tile * G);       // lane group
  const int r = (threadIdx.x % (a.tile * G)) / G;  // token row of the tile
  const int lane_g = threadIdx.x % G;
  const bool row_ok = r < rows;
  const int bh = a.batch * a.heads;
  const int rounds = (bh + a.groups - 1) / a.groups;
  const bf16* dy_all = a.dy[s];
  const int t = t0 + (row_ok ? r : 0);
  const long long col0 = static_cast<long long>(s) * a.heads * d;

  // the lane's cos and sin chunks, for the whole tile
  C cs_raw[kMax], sn_raw[kMax];
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    const int c = lane_g + i * G;
    const bool ok = row_ok && c < nc;
    const long long at = static_cast<long long>(t) * d + c * V;
    cs_raw[i] = ok ? *reinterpret_cast<const C*>(a.tabs[2 * s] + at) : C{};
    sn_raw[i] = ok ? *reinterpret_cast<const C*>(a.tabs[2 * s + 1] + at) : C{};
  }

  float dc[kMax][V], ds[kMax][V];
#pragma unroll
  for (int i = 0; i < kMax; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) dc[i][e] = ds[i][e] = 0.f;

  // the lane's ring: stage j holds its x chunks, then its dy chunks, each
  // part [chunk i][lane] so that neighbouring lanes read neighbouring words;
  // every lane reads only what it copied itself, so no barrier is needed
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kChunkBytes = 2 * V;
  auto slot = [&](int stage, int part, int i) {
    return smem + stage * kStageBytes + ((part * kMax + i) * kThreads + threadIdx.x) * kChunkBytes;
  };
  auto issue = [&](int rr) {
    const int item = rr * a.groups + gi;
    if (rr < rounds && row_ok && item < bh) {
      const int b = item / a.heads, h = item % a.heads;
      const bf16* x_row = a.qkv + b * a.stride_b + t * a.stride_n + col0 + h * d;
      const bf16* dy_row = dy_all + (static_cast<long long>(item) * a.n + t) * a.dp;
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        const int c = lane_g + i * G;
        if (c < nc) {
          cp_async<V>(slot(rr % kStages, 0, i), x_row + c * V);
          cp_async<V>(slot(rr % kStages, 1, i), dy_row + c * V);
        }
      }
    }
    cp_async_commit();  // one group a round, empty or not
  };
  for (int rr = 0; rr < kStages - 1; ++rr) issue(rr);

  for (int rr = 0; rr < rounds; ++rr) {
    issue(rr + kStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const int item = rr * a.groups + gi;
    const bool ok = row_ok && item < bh;
    float xv[kMax][V], dy[kMax][V], du[kMax][V];
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      const int c = lane_g + i * G;
      if (ok && c < nc) {
        unpack<V>(reinterpret_cast<const bf16*>(slot(rr % kStages, 0, i)), xv[i]);
        unpack<V>(reinterpret_cast<const bf16*>(slot(rr % kStages, 1, i)), dy[i]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xv[i][e] = dy[i][e] = 0.f;
      }
      float cs[V], sn[V];
      unpack<V>(reinterpret_cast<const bf16*>(&cs_raw[i]), cs);
      unpack<V>(reinterpret_cast<const bf16*>(&sn_raw[i]), sn);
#pragma unroll
      for (int e = 0; e < V; e += 2) {
        // y0 = u0 c0 + u1 s0, y1 = u1 c1 + u0 s1  =>  du0 = dy0 c0 + dy1 s1, ...
        du[i][e] = dy[i][e] * cs[e] + dy[i][e + 1] * sn[e + 1];
        du[i][e + 1] = dy[i][e + 1] * cs[e + 1] + dy[i][e] * sn[e];
        ss += xv[i][e] * xv[i][e] + xv[i][e + 1] * xv[i][e + 1];
        gx += du[i][e] * xv[i][e] + du[i][e + 1] * xv[i][e + 1];
      }
    }
    float rs = 1.f, coef = 0.f;
    if (a.norm) {
      for (int off = G / 2; off > 0; off /= 2) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        gx += __shfl_xor_sync(0xffffffffu, gx, off);
      }
      rs = rsqrtf(ss / d + a.eps);
      coef = rs * rs * rs * gx / d;
    }
    if (ok) {
      bf16* out = a.dqkv + (item / a.heads) * a.out_stride_b + t * a.out_stride_n + col0 +
                  (item % a.heads) * d;
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        const int c = lane_g + i * G;
        if (c >= nc) continue;
        float dx[V];
#pragma unroll
        for (int e = 0; e < V; ++e) dx[e] = a.norm ? rs * du[i][e] - xv[i][e] * coef : du[i][e];
        pack_store<V>(out + c * V, dx);
      }
    }
#pragma unroll
    for (int i = 0; i < kMax; ++i)
#pragma unroll
      for (int e = 0; e < V; e += 2) {
        float u0 = xv[i][e], u1 = xv[i][e + 1];
        if (a.norm) {
          const float2 uu = __bfloat1622float2(__floats2bfloat162_rn(u0 * rs, u1 * rs));
          u0 = uu.x;
          u1 = uu.y;
        }
        dc[i][e] += u0 * dy[i][e];
        dc[i][e + 1] += u1 * dy[i][e + 1];
        ds[i][e] += u1 * dy[i][e];
        ds[i][e + 1] += u0 * dy[i][e + 1];
      }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // the v cotangent is a pure copy
  copy_v<V>(a, s, t0, rows);

  // the groups' partials, summed in group order: [group][dcos, dsin][row][lane],
  // over the rings
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int item_elems = a.tile * d;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    const int c = lane_g + i * G;
    if (!row_ok || c >= nc) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red[(gi * 2) * item_elems + r * d + c * V + e] = dc[i][e];
      red[(gi * 2 + 1) * item_elems + r * d + c * V + e] = ds[i][e];
    }
  }
  __syncthreads();
  float* dcos = a.dtabs[2 * s] + static_cast<long long>(t0) * d;
  float* dsin = a.dtabs[2 * s + 1] + static_cast<long long>(t0) * d;
  for (int idx = threadIdx.x; idx < rows * d; idx += kThreads) {
    float sc = red[idx], sg = red[item_elems + idx];
    for (int g = 1; g < a.groups; ++g) {
      sc += red[(g * 2) * item_elems + idx];
      sg += red[(g * 2 + 1) * item_elems + idx];
    }
    dcos[idx] = sc;
    dsin[idx] = sg;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int V, int KMAX, int STAGES, int BLOCKS>
cudaError_t launch(const Args& a, long long blocks, int smem, cudaStream_t s) {
  auto kernel = qkv_prep_bwd_kernel<V, KMAX, STAGES, BLOCKS>;
  if (smem > 48 * 1024) {
    const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// qkv: (B, N, 3*H*D) bf16, unit stride in the last dim (batch and token
// strides in elements, even), as the forward read it; tables (N, D) bf16; dq,
// dk, dv: (B, H, N, DP) bf16 contiguous; dqkv: (B, N, 3*H*D) bf16 with its
// own batch and token strides; dcq, dsq, dck, dsk: (N, D) fp32 contiguous.
// D even and <= kMaxHeadDim (1280), DP even and >= D. ``chunk`` (8: 16-byte chunks, where
// D, DP, the strides and the pointers allow them; else 2),
// ``tile``, ``groups``, ``stages``, ``smem`` and ``grid``: the caller's plan
// (dfot_tpu_torch/ops/qkv_prep.py:prep_bwd_plan), refused unless it is the
// one computed here. Returns a cudaError_t code.
extern "C" int dfot_qkv_prep_bwd(const void* qkv, long long stride_b, long long stride_n,
                                 const void* cq, const void* sq, const void* ck, const void* sk,
                                 const void* dq, const void* dk, const void* dv, void* dqkv,
                                 long long out_stride_b, long long out_stride_n, void* dcq,
                                 void* dsq, void* dck, void* dsk, int batch, int n, int heads,
                                 int d, int dp, int norm, float eps, int chunk, int tile,
                                 int groups, int stages, int smem, long long grid,
                                 void* stream) {
  if (d <= 0 || d % 2 != 0 || d > kMaxHeadDim || dp < d || dp % 2 != 0)
    return cudaErrorInvalidValue;
  if (stride_b % 2 != 0 || stride_n % 2 != 0 || out_stride_b % 2 != 0 || out_stride_n % 2 != 0)
    return cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0 || n <= 0) return cudaErrorInvalidValue;
  const bool vec = d % 8 == 0 && dp % 8 == 0 &&
                   (batch == 1 || (stride_b % 8 == 0 && out_stride_b % 8 == 0)) &&
                   stride_n % 8 == 0 && out_stride_n % 8 == 0 && aligned16(qkv) &&
                   aligned16(cq) && aligned16(sq) && aligned16(ck) && aligned16(sk) &&
                   aligned16(dq) && aligned16(dk) && aligned16(dv) && aligned16(dqkv);
  if (chunk != (vec ? 8 : 2)) return cudaErrorInvalidValue;
  const Plan p = make_plan(n, d, chunk);
  const long long blocks = 2LL * p.tiles;
  if (tile != p.tile || groups != p.groups || stages != p.stages || smem != p.smem ||
      grid != blocks || blocks > 2147483647LL)
    return cudaErrorInvalidValue;
  Args a;
  a.qkv = static_cast<const bf16*>(qkv);
  a.stride_b = stride_b;
  a.stride_n = stride_n;
  const void* tabs[4] = {cq, sq, ck, sk};
  const void* dys[3] = {dq, dk, dv};
  void* dtabs[4] = {dcq, dsq, dck, dsk};
  for (int i = 0; i < 4; ++i) {
    a.tabs[i] = static_cast<const bf16*>(tabs[i]);
    a.dtabs[i] = static_cast<float*>(dtabs[i]);
  }
  for (int i = 0; i < 3; ++i) a.dy[i] = static_cast<const bf16*>(dys[i]);
  a.dqkv = static_cast<bf16*>(dqkv);
  a.out_stride_b = out_stride_b;
  a.out_stride_n = out_stride_n;
  a.batch = batch;
  a.n = n;
  a.heads = heads;
  a.d = d;
  a.dp = dp;
  a.norm = norm;
  a.eps = eps;
  a.lanes = p.lanes;
  a.tile = p.tile;
  a.groups = p.groups;
  a.tiles = p.tiles;
  auto s = static_cast<cudaStream_t>(stream);
  if (!vec && p.chunks == 20)
    return launch<2, 20, kWideStages, kWideBlocksPerSm>(a, blocks, smem, s);
  if (!vec) return launch<2, 4, kStages, kBlocksPerSm>(a, blocks, smem, s);
  switch (p.chunks) {
    case 1: return launch<8, 1, kStages, kBlocksPerSm>(a, blocks, smem, s);
    case 2: return launch<8, 2, kWideStages, kWideBlocksPerSm>(a, blocks, smem, s);
    case 3: return launch<8, 3, kWideStages, kWideBlocksPerSm>(a, blocks, smem, s);
    default: return launch<8, 5, kWideStages, kWideBlocksPerSm>(a, blocks, smem, s);
  }
}
