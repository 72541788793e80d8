// The int8 tensor-core tile of the mma.sync routes of int8_matmul.cu and
// int8_conv_im2col.cu (their wgmma routes are built on int8_wgmma.cuh),
// and the rescale both routes share.
//
// A block of 128 threads (4 warps, 2 x 2) computes a 64 x 64 tile of
// C[m, n] = sum_k A[m, k] * B[n, k] (int8 operands, exact int32 sums) and
// writes f32(C) * scale[n]. The K loop runs inside the block, 32 values a
// stage (one mma.sync m16n8k32 deep), where the TPU kernel walks a
// sequential k grid axis and carries the sum in VMEM scratch. Each stage
// is staged in shared memory as rows of k-contiguous bytes, A row m and B
// row n alike; the caller's loader fetches the next stage into registers
// (masked: zeros beyond M, N and K) while the warps multiply the current
// one, so the ragged edges need no padding in the wrapper.
//
// Shared rows are 48 bytes (32 + 16 of padding): the fragment reads of
// one warp (8 rows x 4 words) then fall on 32 distinct banks, and rows
// stay 16-byte aligned for vector stores.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mxt {
namespace i8 {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kLd = kBK + 16;
// one int32 sum of int8 products is exact while K * 128 * 128 < 2^31
constexpr int kMaxK = 131071;

struct Tiles {
  alignas(16) int8_t a[kBM * kLd];
  alignas(16) int8_t b[kBN * kLd];
};

// D += A * B, one m16n8k32 tile: A 16 x 32 row-major, B 32 x 8 column-
// major (a row of w is a column of B), s32 sums. Fragment layout (PTX
// ISA, mma.m16n8k32 with .s8), g = lane / 4, t = lane % 4:
//   a[0]: row g,   k 4t..4t+3     a[1]: row g+8, k 4t..4t+3
//   a[2]: row g,   k 16+4t..      a[3]: row g+8, k 16+4t..
//   b[0]: col g,   k 4t..4t+3     b[1]: col g,   k 16+4t..
//   d[0..1]: row g, cols 2t, 2t+1;  d[2..3]: row g+8, cols 2t, 2t+1
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 32-deep stage of a warp's 32 x 32 sub-tile (rows wm*32.., cols
// wn*32..): 2 x 4 mma tiles.
__device__ __forceinline__ void warp_stage(const Tiles& s, int wm, int wn,
                                           int lane, int (&acc)[2][4][4]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[2][4], b[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int8_t* p = s.a + (wm * 32 + mi * 16 + g) * kLd + 4 * t;
    a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
    a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
    a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
    a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int8_t* p = s.b + (wn * 32 + ni * 8 + g) * kLd + 4 * t;
    b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
    b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
}

// A stage of rows of a row-major (rows, K) int8 matrix with K contiguous
// (x of the matmul, the weights of both kernels): 64 rows x 32 bytes.
// VEC: K % 16 == 0 and a 16-byte-aligned base, so each thread moves one
// 16-byte chunk (wholly inside or wholly past K); else each thread packs
// 4 words byte by byte, masked.
template <bool VEC>
struct RowLoader {
  uint4 v;
  uint32_t w[4];

  __device__ __forceinline__ void fetch(const int8_t* __restrict__ base,
                                        int rows, int K, int row0, int k0,
                                        int tid) {
    if (VEC) {
      const int r = tid >> 1, c = (tid & 1) * 16;
      const int row = row0 + r, k = k0 + c;
      v = make_uint4(0, 0, 0, 0);
      if (row < rows && k < K)
        v = *reinterpret_cast<const uint4*>(base + (int64_t)row * K + k);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int word = tid + j * kThreads;
        const int r = word >> 3, kq = (word & 7) * 4;
        const int row = row0 + r;
        uint32_t packed = 0;
        if (row < rows) {
          const int8_t* p = base + (int64_t)row * K;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = k0 + kq + e;
            const uint32_t byte = k < K ? static_cast<uint8_t>(p[k]) : 0u;
            packed |= byte << (8 * e);
          }
        }
        w[j] = packed;
      }
    }
  }

  __device__ __forceinline__ void store(int8_t* tile, int tid) const {
    if (VEC) {
      const int r = tid >> 1, c = (tid & 1) * 16;
      *reinterpret_cast<uint4*>(tile + r * kLd + c) = v;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int word = tid + j * kThreads;
        const int r = word >> 3, kq = (word & 7) * 4;
        *reinterpret_cast<uint32_t*>(tile + r * kLd + kq) = w[j];
      }
    }
  }
};

// f32(acc) * scale, rounded once: __fmul_rn so that nvcc never fuses it
// with anything (the plain versions and the JAX twins multiply once).
__device__ __forceinline__ float rescale(int acc, float scale) {
  return __fmul_rn(__int2float_rn(acc), scale);
}

}  // namespace i8
}  // namespace mxt
