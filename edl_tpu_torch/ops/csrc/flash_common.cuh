// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tiles of the fp32 bodies (CUDA cores), their tile loader, the stride
// triple of a [B, heads, T, D] tensor and the shared-memory attribute. The
// bf16 bodies build on hopper.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // queries per tile (fp32 bodies)
constexpr int BK = 64;         // keys per tile (fp32 bodies, bf16 forward)
constexpr int NTHREADS = 128;  // 4 warps

struct Strides {
  long long b, h, t;
};

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
