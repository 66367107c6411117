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
// against 4 * N^2 * D flops, a few flops per byte, and there are tens of
// thousands of items. So each item's q, k, v are read from device memory
// once, with 16-byte accesses, into shared memory, and scores, softmax and
// the p v product never leave the SM. One warp owns one item and needs no
// block-wide barrier; several warps share a block so that enough loads are in
// flight. N need not be a multiple of the tensor-core tile (5, 8, 16 on the
// recipes), so the products are plain FMAs: the arithmetic is far below the
// card's fp32 rate at these sizes. Rows of q and k are padded by 16 bytes in
// shared memory so that the lanes of a quarter warp, which read different k
// rows with 16-byte loads, hit different banks. At d = 256 (the base U-ViT's
// level 3) a lane owns 8 channels of the p v product, and an item can pass
// the budget below (a bf16 item of 32 x 256 takes 54 KB, an fp32 one 102 KB):
// a block then holds that one item in dynamic shared memory, above the
// static 48 KB after the opt-in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kPadBytes = 16;  // padding of every shared-memory row
constexpr int kMaxWarps = 8;

// Per element type: elements of a 16-byte access, the dot product of two such
// accesses, channel pairs, rounding to the type, and the shared memory a block
// may take for its items (bf16 stays inside the static 48 KB; an fp32 item of
// 32 x 128 is larger, so that instantiation opts in to more).
constexpr int kMaxSmem = 232448;  // what one H100 block can take after the opt-in

template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kSmemBudget = 48 * 1024;
  static __device__ __forceinline__ float dot(const uint4& a, const uint4& b) {
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(a2[e]), fb = __bfloat1622float2(b2[e]);
      acc += fa.x * fb.x + fa.y * fb.y;
    }
    return acc;
  }
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <> struct Elem<float> {
  static constexpr int kVec = 4;
  static constexpr int kSmemBudget = 96 * 1024;
  static __device__ __forceinline__ float dot(const uint4& a, const uint4& b) {
    const float* fa = reinterpret_cast<const float*>(&a);
    const float* fb = reinterpret_cast<const float*>(&b);
    return fa[0] * fb[0] + fa[1] * fb[1] + fa[2] * fb[2] + fa[3] * fb[3];
  }
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ float rnd(float v) { return v; }
};

// shared memory of one item, rounded up so that every warp's share starts on
// a 16-byte boundary
__host__ __device__ inline int item_smem_bytes(int n, int d, int elem_bytes) {
  return (3 * n * (d * elem_bytes + kPadBytes) + n * (n + 1) * 4 + 15) / 16 * 16;
}

template <typename T>
__global__ void small_n_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, T* __restrict__ o, long long items,
                                    int n, int d, float scale) {
  constexpr int V = Elem<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long item = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (item >= items) return;  // whole warps leave; no block-wide barrier below

  const int ds = d + V;  // shared-memory row stride, elements
  unsigned char* mine = smem + static_cast<size_t>(warp) * item_smem_bytes(n, d, sizeof(T));
  T* qs = reinterpret_cast<T*>(mine);
  T* ks = qs + n * ds;
  T* vs = ks + n * ds;
  float* ps = reinterpret_cast<float*>(vs + n * ds);  // (n, n + 1) scores, then weights

  // stage q, k, v: the item is n * d contiguous elements in each
  const int dv = d / V;
  const long long base = item * n * d;
  for (int i = lane; i < n * dv; i += 32) {
    const int row = i / dv, col = i % dv;
    const int at = row * ds + col * V;
    *reinterpret_cast<uint4*>(qs + at) = *reinterpret_cast<const uint4*>(q + base + V * i);
    *reinterpret_cast<uint4*>(ks + at) = *reinterpret_cast<const uint4*>(k + base + V * i);
    *reinterpret_cast<uint4*>(vs + at) = *reinterpret_cast<const uint4*>(v + base + V * i);
  }
  __syncwarp();

  // scores: one (query, key) pair per lane and round
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n, j = idx % n;
    const uint4* qr = reinterpret_cast<const uint4*>(qs + i * ds);
    const uint4* kr = reinterpret_cast<const uint4*>(ks + j * ds);
    float acc = 0.f;
    for (int c = 0; c < dv; ++c) acc += Elem<T>::dot(qr[c], kr[c]);
    ps[i * (n + 1) + j] = acc * scale;
  }
  __syncwarp();

  // softmax: lane i owns row i; weights rounded to T as the p v product reads them
  if (lane < n) {
    float* row = ps + lane * (n + 1);
    float m = row[0];
    for (int j = 1; j < n; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < n; ++j) {
      row[j] = expf(row[j] - m);
      sum += row[j];
    }
    for (int j = 0; j < n; ++j) row[j] = Elem<T>::rnd(row[j] / sum);
  }
  __syncwarp();

  // o = p v: lane owns channel pairs, walks the query rows
  for (int i = 0; i < n; ++i) {
    const float* row = ps + i * (n + 1);
    for (int pp = lane; pp < d / 2; pp += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < n; ++j) {
        const float2 fv = Elem<T>::load2(vs + j * ds + 2 * pp);
        ax += row[j] * fv.x;
        ay += row[j] * fv.y;
      }
      Elem<T>::store2(o + base + i * d + 2 * pp, ax, ay);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, long long items, int n, int d,
           float scale, cudaStream_t stream) {
  const int per_item = item_smem_bytes(n, d, sizeof(T));
  // an item larger than the budget (d = 256, long rows) gets a block of its own
  const int budget = per_item > Elem<T>::kSmemBudget ? per_item : Elem<T>::kSmemBudget;
  if (budget > kMaxSmem) return cudaErrorInvalidValue;
  int warps = budget / per_item;
  if (warps > kMaxWarps) warps = kMaxWarps;
  const long long blocks = (items + warps - 1) / warps;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (budget > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        small_n_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  small_n_attn_kernel<T><<<static_cast<unsigned>(blocks), warps * 32, warps * per_item, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), items, n, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (items, N, D) contiguous, all bf16 (is_fp32 = 0) or all fp32
// (is_fp32 = 1), 16-byte aligned; 1 <= N <= 32, D a multiple of 8 and at most
// 256. Returns a cudaError_t code.
extern "C" int dfot_small_n_attn(const void* q, const void* k, const void* v, void* o,
                                 long long items, int n, int d, float scale, int is_fp32,
                                 void* stream) {
  if (items <= 0 || n <= 0 || n > kMaxN || d <= 0 || d % 8 != 0 || d > 256)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return is_fp32 ? launch<float>(q, k, v, o, items, n, d, scale, s)
                 : launch<__nv_bfloat16>(q, k, v, o, items, n, d, scale, s);
}
