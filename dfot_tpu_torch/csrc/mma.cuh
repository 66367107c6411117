// Warp-level building blocks of the flash-attention backward's dq kernel
// (flash_bwd.cu, B4): ldmatrix loads, the bf16 m16n8k16 mma.sync with fp32
// accumulation, the two warp-level tile products built from them, and the
// staged copy of a tile into padded shared memory. One block is kWarps warps;
// every tile row in shared memory has a pitch of d + kPad elements so
// ldmatrix reads are free of bank conflicts. kLog2e and pack_bf16x2 come from
// hopper.cuh, which the wgmma kernels share.

#pragma once

#include "hopper.cuh"

namespace dfot {

constexpr int kWarps = 4;
constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b for one m16n8k16 tile (a row-major 16x16, b column-major 16x8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (rows x D) bf16 tile from device memory (row pitch D) to shared memory
// (row pitch D + kPad), 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += kWarps * 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
  }
}

// acc (16 x NT*8) += A Y^T for one warp. A: the warp's 16 rows of a
// shared-memory tile (pointer to its first row), Y: an (NT*8 x D) tile; both
// contract over their D columns. Accumulator nt holds rows g, g + 8 and
// columns nt*8 + 2c, + 1 (g = lane / 4, c = lane % 4).
template <int D, int NT>
__device__ __forceinline__ void warp_gemm_abt(float (&acc)[NT][4], const __nv_bfloat16* a_rows,
                                              const __nv_bfloat16* y, int lane) {
  constexpr int kPitch = D + kPad;
  const int a_row = (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_rows + a_row * kPitch + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      const int row = nt * 8 + (lane % 8) + (lane / 16) * 8;
      ldmatrix_x4(b, y + row * kPitch + kk * 16 + ((lane / 8) % 2) * 8);
      mma_bf16(acc[nt], a, b[0], b[1]);
      mma_bf16(acc[nt + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += P Y for one warp. P: 16 x NK*16 as packed A fragments
// (see pack_fragments), Y: an (NK*16 x D) shared-memory tile contracted over
// its rows.
template <int D, int NK>
__device__ __forceinline__ void warp_gemm_pb(float (&acc)[D / 8][4], const uint32_t (&p)[NK][4],
                                             const __nv_bfloat16* y, int lane) {
  constexpr int kPitch = D + kPad;
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t b[4];
      const int row = kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
      ldmatrix_x4_trans(b, y + row * kPitch + dt * 8 + (lane / 16) * 8);
      mma_bf16(acc[dt], p[kc], b[0], b[1]);
      mma_bf16(acc[dt + 1], p[kc], b[2], b[3]);
    }
  }
}

// The fp32 accumulators of column tiles 2kc, 2kc + 1 (a 16 x 16 slice) are,
// rounded to bf16, the A fragment of that slice for the next product.
template <int NT>
__device__ __forceinline__ void pack_fragments(uint32_t (&p)[NT / 2][4], const float (&s)[NT][4]) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    p[kc][0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
    p[kc][1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
    p[kc][2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    p[kc][3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
  }
}

}  // namespace dfot
