// Helpers shared by the attention kernels of mxnet_tpu_torch/ops/cuda.
//
// The CUDA-core kernels are templated on their element type (float or
// __nv_bfloat16), load through to_f32, accumulate in float32 and store
// through from_f32 (round to nearest even, as torch's casts). The bf16
// flash attention kernels run their products on the tensor cores through
// the mma.sync helpers at the end of this file.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mxt {

// masked score, as the JAX package's NEG_INF: finite, so exp(mask - m)
// underflows to exactly 0 without an inf - inf NaN
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// page ids come from a host-built block table; clamp like an XLA gather
// does rather than fault on a bad id
__device__ __forceinline__ int clamp_page(int page, int num_pages) {
  return page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
}

// dynamic shared memory above 48 KB needs a per-kernel opt-in
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// -- warp-level bf16 tensor-core tiles (mma.sync m16n8k16, f32 sums) -------
//
// Fragment layout (PTX ISA, "mma.m16n8k16" for .bf16), with
// g = lane / 4 and c = lane % 4:
//   A (16 x 16, row-major): a[0] = rows g,   cols 2c..2c+1
//                           a[1] = rows g+8, cols 2c..2c+1
//                           a[2] = rows g,   cols 2c+8..2c+9
//                           a[3] = rows g+8, cols 2c+8..2c+9
//   B (16 x 8):             b0 = rows 2c..2c+1,   col g
//                           b1 = rows 2c+8..2c+9, col g
//   C (16 x 8, float):      c[0..1] = row g,   cols 2c..2c+1
//                           c[2..3] = row g+8, cols 2c..2c+1
// Each 32-bit register holds two bf16, the lower column in the low half.
// Two C tiles side by side (cols 0..7 and 8..15) are, packed to bf16,
// exactly one A fragment: softmax probabilities feed the next product
// without a trip through shared memory.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment that two C tiles side by side (cols 0..7 in lo, 8..15
// in hi) make, rounded to bf16
__device__ __forceinline__ void c_to_a_frag(uint32_t (&a)[4],
                                            const float (&lo)[4],
                                            const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// two adjacent bf16 of a shared-memory row (even element offset)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the 16 x 16 block at (row0, col0) of a row-major bf16
// tile with row stride ld (elements)
__device__ __forceinline__ void ld_a_frag(uint32_t (&a)[4],
                                          const __nv_bfloat16* tile, int ld,
                                          int row0, int col0, int lane) {
  const int g = lane >> 2, c = lane & 3;
  const __nv_bfloat16* p = tile + (row0 + g) * ld + col0 + 2 * c;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// B fragment of the 16 x 8 block whose column n is row (n0 + n) of a
// row-major bf16 tile, its k-th entry column (k0 + k) of that row: the
// "B = X^T" operand of S = Q K^T
__device__ __forceinline__ void ld_bt_frag(uint32_t& b0, uint32_t& b1,
                                           const __nv_bfloat16* tile, int ld,
                                           int n0, int k0, int lane) {
  const int g = lane >> 2, c = lane & 3;
  const __nv_bfloat16* p = tile + (n0 + g) * ld + k0 + 2 * c;
  b0 = ld_pair(p);
  b1 = ld_pair(p + 8);
}

// A ROWS x D tile (from row row0) of a contiguous (rows_total, D) bf16
// matrix into shared memory, 16 bytes per thread per step; rows at or
// past rows_total read as zeros. Stored row-major at dst (row stride ld)
// and/or transposed at tr (D x ROWS, row stride ldt); either may be null.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int ld,
                                           __nv_bfloat16* tr, int ldt,
                                           const __nv_bfloat16* src,
                                           int row0, int rows_total) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c8 = (i - r * kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows_total)
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c8);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + r * ld + c8) = v;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(c8 + j) * ldt + r] = e[j];
    }
  }
}

}  // namespace mxt
