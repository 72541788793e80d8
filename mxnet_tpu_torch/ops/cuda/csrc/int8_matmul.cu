// int8_matmul: out[m, n] = f32(sum_k x[m, k] * w[n, k]) * scale[n].
//
// Replaces mxnet_tpu/ops/pallas/int8_matmul.py `int8_matmul` (the body
// `_kernel`, launched by `_int8_matmul_pallas`): int8 operands, int32
// sums, the per-output-channel rescale fused into the epilogue so the
// int32 sums never reach device memory.
//
// Bound on an H100: at the quantized serving path's FC (m <= 32, k 2048,
// n 1000) the 2 MB of weights dominate, so bytes bound it (0.6 us at
// 3.35 TB/s); at large m the 1979 TOP/s of the int8 tensor cores do.
// Design: one block per 64 x 64 output tile, the K loop inside the block
// (int8_gemm.cuh) on mma.sync m16n8k32 tensor-core tiles, the next
// 32-deep stage fetched into registers while the current one multiplies.
// Ragged m, n and k are masked in the loads and the store; x and w are
// read with 16-byte loads when k % 16 == 0, byte by byte otherwise.
// Small m leaves most SMs idle (n / 64 blocks): split-K, wgmma and TMA
// are later work.
#include "int8_gemm.cuh"

namespace mxt {
namespace i8 {

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int M, int N, int K) {
  __shared__ Tiles s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  RowLoader<VEC> la, lb;
  la.fetch(x, M, K, m0, 0, tid);
  lb.fetch(w, N, K, n0, 0, tid);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    la.store(s.a, tid);
    lb.store(s.b, tid);
    __syncthreads();
    if (k0 + kBK < K) {
      la.fetch(x, M, K, m0, k0 + kBK, tid);
      lb.fetch(w, N, K, n0, k0 + kBK, tid);
    }
    warp_stage(s, wm, wn, lane, acc);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * 32 + mi * 16 + g + (r >> 1) * 8;
        const int n = n0 + wn * 32 + ni * 8 + 2 * t + (r & 1);
        if (m < M && n < N)
          out[(int64_t)m * N + n] = rescale(acc[mi][ni][r], scale[n]);
      }
}

}  // namespace i8
}  // namespace mxt

// x (m, k), w (n, k) int8 row-major; scale (n,) f32; out (m, n) f32.
extern "C" int int8_matmul(const void* x, const void* w, const void* scale,
                           void* out, int m, int n, int k, void* stream) {
  using namespace mxt::i8;
  if (m <= 0 || n <= 0 || k <= 0 || k > kMaxK) return cudaErrorInvalidValue;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const bool vec = k % 16 == 0 && reinterpret_cast<uintptr_t>(xp) % 16 == 0
                   && reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  if (vec)
    int8_matmul_kernel<true><<<grid, kThreads, 0, st>>>(
        xp, wp, static_cast<const float*>(scale), static_cast<float*>(out),
        m, n, k);
  else
    int8_matmul_kernel<false><<<grid, kThreads, 0, st>>>(
        xp, wp, static_cast<const float*>(scale), static_cast<float*>(out),
        m, n, k);
  return static_cast<int>(cudaGetLastError());
}
