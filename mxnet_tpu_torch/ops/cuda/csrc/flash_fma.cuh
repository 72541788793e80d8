// The register-tiled CUDA-core tiling of the flash kernels' "fma" route
// (float32, and bfloat16 where the wgmma route does not go), shared by
// flash_attention.cu and flash_attention_bwd.cu.
//
// A CTA owns 64 "rows" (queries in the forward and the dq pass, keys in
// the dk/dv pass), staged once into shared memory as float32 (rows
// padded by 16 bytes, widened on load, q scaled there where the kernel
// says so), and streams tiles of BS rows of the other side (keys and
// values, or queries and output gradients) in their own type through a
// ring of STAGES buffers filled by 16-byte cp.async copies (rows padded
// by 16 bytes). Its 64 / RPT row groups of 16 threads each (tx = tid %
// 16, ty = tid / 16) hold rows RPT ty .. RPT ty + RPT - 1 and streamed
// rows tx + 16 j: an RPT x (BS / 16) block of every score-like product
// in registers, and for each of its RPT rows the output columns 4 tx +
// 64 c .. + 3 (c < DP / 64). A row group is half a warp, so row maxima
// and sums reduce by shuffles among its threads and a row's
// probabilities pass through shared memory with a __syncwarp only.
// Shared-memory reads are 16 (float32) or 8 (bf16) bytes: a row-side
// read is a broadcast, a streamed row read sits 16 bytes a row apart (no
// bank conflict in float32). An 8 x 4 block (RPT 8, BS 64) reads 12
// such vectors for 128 FMAs; shared-memory bandwidth and load latency
// bound these kernels more than the FMA pipes do, so the tilings the
// kernels take were picked by timing on the card (PERF.md §6): more CTAs
// an SM with a single-stage ring beat a double-buffered ring with fewer,
// and 8 x 8 blocks (8 threads a row group) were slower than 8 x 4. exp
// is ex2.approx of x * log2(e) (relative error ~2^-22). Every sum runs
// in a fixed order: the results repeat bitwise.
#pragma once

#include "common.cuh"

namespace mxt {
namespace fma_tile {

constexpr int kRows = 64;   // rows a CTA owns
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kTX = 16;     // threads a row group: half a warp

// threads of a CTA whose threads hold RPT rows each
template <int RPT>
__host__ __device__ constexpr int threads() { return kTX * kRows / RPT; }

// padded row stride (elements) of the float32 row side, and of a
// streamed tile of T: 16 bytes of padding a row
template <int DP>
__host__ __device__ constexpr int row_ld() { return DP + 4; }
template <typename T, int DP>
__host__ __device__ constexpr int stream_ld() {
  return DP + 16 / static_cast<int>(sizeof(T));
}

// four consecutive elements from shared memory, as float32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float (&y)[4]) {
  y[0] = fmaf(a, x.x, y[0]);
  y[1] = fmaf(a, x.y, y[1]);
  y[2] = fmaf(a, x.z, y[2]);
  y[3] = fmaf(a, x.w, y[3]);
}

__device__ __forceinline__ void unpack4(float4 v, float (&out)[4]) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// sum or max over the threads of a row group
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < kTX; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < kTX; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// rows [row0, row0 + kRows) of a (rows_total, hd) matrix of T into dst
// (float32, row stride LD), times scale; rows past rows_total and
// columns hd .. DP - 1 as zeros
template <typename T, int DP, int LD, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int row0, int rows_total, int hd,
                                           float scale) {
  for (int i = threadIdx.x; i < kRows * DP; i += NT) {
    const int r = i / DP;
    const int d = i - r * DP;
    float x = 0.f;
    if (row0 + r < rows_total && d < hd)
      x = to_f32(src[static_cast<size_t>(row0 + r) * hd + d]) * scale;
    dst[r * LD + d] = x;
  }
}

// rows [row0, row0 + R) of a (rows_total, hd) matrix of T into dst (T,
// row stride LD, DP columns): 16-byte cp.async chunks where `vec` (rows
// of whole chunks, 16-byte aligned storage; chunks past hd and rows past
// rows_total as zeros), else plain loads that zero rows past rows_total
// and columns hd .. hd rounded up to 4 (where the dot products stop).
// The caller commits and waits.
template <typename T, int R, int DP, int LD, int NT>
__device__ __forceinline__ void stream_rows(T* dst, const T* src, int row0,
                                            int rows_total, int hd,
                                            bool vec) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = DP / kVec;
  if (vec) {
    for (int i = threadIdx.x; i < R * kChunks; i += NT) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      const bool in = row0 + r < rows_total && c * kVec < hd;
      cp_async16(dst + r * LD + c * kVec,
                 in ? src + static_cast<size_t>(row0 + r) * hd + c * kVec
                    : src,
                 in ? 16 : 0);
    }
  } else {
    const int hd4 = (hd + 3) & ~3;
    for (int i = threadIdx.x; i < R * hd4; i += NT) {
      const int r = i / hd4;
      const int d = i - r * hd4;
      dst[r * LD + d] = row0 + r < rows_total && d < hd
                            ? src[static_cast<size_t>(row0 + r) * hd + d]
                            : from_f32<T>(0.f);
    }
  }
}

// four float32 values into dst[0 .. n) in T: one 16- (float32) or 8-byte
// (bf16) store where `vec` and all four are in range
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float (&x)[4], int n,
                                       bool vec) {
  if (vec && n >= 4) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
      __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
      __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&a);
      u.y = *reinterpret_cast<uint32_t*>(&b);
      *reinterpret_cast<uint2*>(dst) = u;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) dst[e] = from_f32<T>(x[e]);
}

// streamed tile STAGES-deep pipeline step: before tile t's compute, issue
// tile t + 1 (two stages) and wait for tile t's copies
template <int STAGES, typename Issue>
__device__ __forceinline__ void pipeline_wait(int t, int n, Issue issue) {
  if (STAGES == 2 && t + 1 < n) {
    issue(t + 1);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
}

// after tile t's compute: every thread is done with its stage; with one
// stage, the next tile is issued only now
template <int STAGES, typename Issue>
__device__ __forceinline__ void pipeline_release(int t, int n, Issue issue) {
  __syncthreads();
  if (STAGES == 1 && t + 1 < n) issue(t + 1);
}

}  // namespace fma_tile
}  // namespace mxt
