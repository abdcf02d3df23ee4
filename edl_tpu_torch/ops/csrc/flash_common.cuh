// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile sizes, the mma.sync / ldmatrix wrappers for bf16 tensor-core
// products with fp32 accumulation, and the tile loader.
//
// Fragment layouts of mma.sync m16n8k16 (lane = 4 g + tg):
//   A 16x16: a0 (row g, cols 2tg, 2tg+1), a1 (row g+8, same cols),
//            a2 (row g, cols +8), a3 (row g+8, cols +8);
//   B 16x8:  b0 (k rows 2tg, 2tg+1, col g), b1 (k rows +8);
//   C 16x8:  c0, c1 (row g, cols 2tg, 2tg+1), c2, c3 (row g+8).
// So a C tile pair (two 8-column tiles) repacked to bf16 is an A fragment
// (probabilities stay in registers between two products), a B operand whose
// n index is a shared-memory row (S = Q K^T reads K rows) is two 32-bit
// loads, and a B operand stored [k][n] row-major (P V reads V) comes from
// ldmatrix.trans.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // queries per tile
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps
constexpr int LDS_PAD = 8;     // bf16 elements of row padding: conflict-free

struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows [r0, r0 + 16), columns [16 kc, 16 kc + 16) of a
// shared [rows][LDS] bf16 tile.
template <int LDS>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* s, int r0,
                                            int kc, int g, int tg) {
  const __nv_bfloat16* base = s + (r0 + g) * LDS + kc * 16 + 2 * tg;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * LDS);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * LDS + 8);
}

// The C tiles 2 kc and 2 kc + 1 of x (16 rows x 16 columns), rounded to
// bf16, as an A fragment.
template <int N>
__device__ __forceinline__ void pack_a_frag(uint32_t (&a)[4],
                                            const float (&x)[N][4], int kc) {
  a[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
  a[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
  a[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
  a[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
}

// The lane's ldmatrix.x4.trans row address for k rows [r0, r0 + 16) of a
// shared [k][LDS] bf16 tile; + 16 d gives the B fragments of output
// columns [16 d, 16 d + 16): r[0], r[1] for the first 8, r[2], r[3] for
// the next 8.
template <int LDS>
__device__ __forceinline__ const __nv_bfloat16* trans_row(
    const __nv_bfloat16* s, int r0, int lane) {
  return s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
         ((lane >> 4) & 1) * 8;
}

// rows [r0, r0 + 64) of a [T, D] bf16 slab with row stride `st` into
// shared [64][D + LDS_PAD]; rows at or past `rows` are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long st, int r0, int rows,
                                               bool vec16) {
  constexpr int LDS = D + LDS_PAD;
  if (vec16) {
    constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += NTHREADS) {
      const int row = idx / CHUNKS;
      const int ch = idx % CHUNKS;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + row < rows) {
        val = *reinterpret_cast<const uint4*>(src + (r0 + row) * st + ch * 8);
      }
      *reinterpret_cast<uint4*>(dst + row * LDS + ch * 8) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
      const int row = idx / D;
      const int d = idx % D;
      dst[row * LDS + d] = r0 + row < rows ? src[(r0 + row) * st + d]
                                           : __float2bfloat16(0.f);
    }
  }
}

// rows [r0, r0 + 64) of a [T, D] fp32 slab, transposed into shared
// [D][ld] (dst[d * ld + row]); rows at or past `rows` are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32_t(float* dst, const float* src,
                                                long long st, int r0, int rows,
                                                int ld) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
    const int row = idx / D;
    const int d = idx % D;
    dst[d * ld + row] = r0 + row < rows ? src[(r0 + row) * st + d] : 0.f;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
