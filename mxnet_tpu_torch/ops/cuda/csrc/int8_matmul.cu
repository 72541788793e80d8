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
//
// Two routes; the wrapper (ops/cuda/int8_matmul.py `matmul_route`)
// picks one from shapes and alignment before the launch.
//
// wgmma (k % 16 == 0, x and w 16-byte aligned): A and B swapped, so the
// weights fill wgmma's 64-row A operand whatever m is: a CTA computes
// out^T for 64 rows of w (n) by BN rows of x (m; BN = 8, 16, 32, 64 or
// 128, the smallest that holds m up to 128), one consumer warpgroup on
// wgmma m64nBNk32 s8 with int32 sums in registers, fed by one producer
// thread through a four-stage ring of 128-byte K chunks loaded by TMA
// (2-D maps over (k, rows), 128-byte swizzle; rows past m or n and k
// past k read as zeros, so nothing is padded). At small m there are too
// few output tiles for 132 SMs (16 at the FC), so K is split into S
// slices (the wrapper's choice: the smallest power of two giving >= 128
// CTAs, 8 at the FC: 128 CTAs of 2 chunks, 8 k32 steps each). Every
// slice adds its int32 partials into a workspace tile with red.add; the
// last CTA of a tile to finish (a counter per tile) reads the whole sum,
// rescales it once, writes f32, and zeroes the tile and its counter for
// the next launch. int32 addition is exact in any order (|sum| < 2^31
// for k <= kMaxK), so the result is bitwise the plain version's.
//
// mma.sync (any other shape): the first design, one block of 128 threads
// per 64 x 64 output tile, the K loop inside the block (int8_gemm.cuh)
// on mma.sync m16n8k32, the next 32-deep stage fetched into registers
// while the current one multiplies; ragged m, n and k are masked in the
// loads and the store, x and w read with 16-byte loads when k % 16 == 0,
// byte by byte otherwise.
#include "common.cuh"
#include "int8_gemm.cuh"
#include "int8_wgmma.cuh"

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

// -- the wgmma route ---------------------------------------------------------

constexpr int kWgStages = 4;
constexpr int kWgBK = 128;                    // K bytes a chunk
constexpr int kWgThreads = 128 + 32;  // a consumer warpgroup, a producer

template <int BN>
constexpr size_t wg_smem() {
  return size_t(kWgStages) * kWgBK * (64 + BN) + 2 * kWgStages * 8 + 1024;
}

// grid (n tiles of 64, m tiles of BN, S slices of K); ws: S > 1 only, an
// int32 tile of 64 x BN per output tile and then a counter per output
// tile, all zero between launches
template <int BN>
__global__ void __launch_bounds__(kWgThreads)
    int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                             const __grid_constant__ CUtensorMap tx,
                             const float* __restrict__ scale,
                             float* __restrict__ out, int* __restrict__ ws,
                             int M, int N, int chunks) {
  constexpr uint32_t kA = 64 * kWgBK, kB = BN * kWgBK;
  using T = s8::KTile<kWgBK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::align_smem(smem_raw);
  unsigned char* a_s = sm;
  unsigned char* b_s = sm + kWgStages * kA;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kWgStages * kB);
  uint64_t* empty = full + kWgStages;
  __shared__ int last;

  const int nt = blockIdx.x, mt = blockIdx.y;
  const int splits = gridDim.z, sp = blockIdx.z;
  const int c0 = sp * chunks / splits;
  const int nc = (sp + 1) * chunks / splits - c0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], 128);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      for (int i = 0; i < nc; ++i) {
        const int st = i % kWgStages;
        sm90::mbar_wait(&empty[st], ((i / kWgStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], kA + kB);
        const int k0 = (c0 + i) * kWgBK;
        s8::tma_load_2d(a_s + st * kA, &tw, &full[st], k0, nt * 64);
        s8::tma_load_2d(b_s + st * kB, &tx, &full[st], k0, mt * BN);
      }
    }
    return;
  }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int i = 0; i < nc; ++i) {
    const int st = i % kWgStages;
    sm90::mbar_wait(&full[st], (i / kWgStages) & 1);
    const uint32_t a_t = sm90::smem_u32(a_s + st * kA);
    const uint32_t b_t = sm90::smem_u32(b_s + st * kB);
    s8::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 32; ++kk)
      s8::Wgmma<BN>::mma(acc, T::desc(a_t, kk), T::desc(b_t, kk), 1);
    sm90::wgmma_commit();
    // the previous chunk's products are done: free its stage
    sm90::wgmma_wait<1>();
    s8::fence_regs(acc);
    if (i > 0) sm90::mbar_arrive(&empty[(i - 1) % kWgStages]);
  }
  sm90::wgmma_wait<0>();
  s8::fence_regs(acc);

  // acc[i]: row (n) 16 warp + g + 8 ((i >> 1) & 1), column (m) 8 (i >> 2)
  // + 2 c + (i & 1)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int n0 = nt * 64, m0 = mt * BN;
  if (splits > 1) {
    const int tile = mt * gridDim.x + nt;
    int* __restrict__ part = ws + (size_t)tile * 64 * BN;
    int* __restrict__ count = ws + (size_t)gridDim.x * gridDim.y * 64 * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
      atomicAdd(&part[r * BN + 8 * (i >> 2) + 2 * c + (i & 1)], acc[i]);
    }
    __threadfence();
    s8::consumers_sync(128);
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(&count[tile], 1) == splits - 1;
    }
    s8::consumers_sync(128);
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
      int* p = &part[r * BN + 8 * (i >> 2) + 2 * c + (i & 1)];
      acc[i] = __ldcg(p);
      *p = 0;
    }
    if (threadIdx.x == 0) count[tile] = 0;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int n = n0 + 16 * warp + g + 8 * ((i >> 1) & 1);
    const int m = m0 + 8 * (i >> 2) + 2 * c + (i & 1);
    if (m < M && n < N)
      out[(int64_t)m * N + n] = rescale(acc[i], scale[n]);
  }
}

template <int BN>
static int launch_wgmma(const void* x, const void* w, const void* scale,
                        void* out, void* ws, int m, int n, int k, int splits,
                        cudaStream_t st) {
  CUtensorMap tw, tx;
  if (!s8::cached_kmajor<kWgBK>(&tw, w, n, k, k, 64) ||
      !s8::cached_kmajor<kWgBK>(&tx, x, m, k, k, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wg_smem<BN>();
  // the shared-memory opt-in, once a kernel (a driver call a launch
  // costs host microseconds); static, so the flag is this library's
  static bool opted = false;
  if (!opted) {
    cudaError_t err = allow_smem(int8_matmul_wgmma_kernel<BN>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const int chunks = (k + kWgBK - 1) / kWgBK;
  const dim3 grid((n + 63) / 64, (m + BN - 1) / BN, splits);
  int8_matmul_wgmma_kernel<BN><<<grid, kWgThreads, smem, st>>>(
      tw, tx, static_cast<const float*>(scale), static_cast<float*>(out),
      static_cast<int*>(ws), m, n, chunks);
  return static_cast<int>(cudaGetLastError());
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

// The wgmma route: x (m, k), w (n, k) int8 row-major, k % 16 == 0, both
// 16-byte aligned; bn in {8, 16, 32, 64, 128}; splits S >= 1 slices of
// K (at most the number of 128-byte chunks); ws (S > 1): the wrapper's
// zeroed workspace of ceil(n / 64) * ceil(m / bn) * (64 * bn + 1) int32,
// left zeroed.
extern "C" int int8_matmul_wgmma(const void* x, const void* w,
                                 const void* scale, void* out, void* ws,
                                 int m, int n, int k, int bn, int splits,
                                 void* stream) {
  using namespace mxt::i8;
  if (m <= 0 || n <= 0 || k <= 0 || k > kMaxK || k % 16 || splits < 1 ||
      splits > (k + kWgBK - 1) / kWgBK || (splits > 1 && ws == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8:
      return launch_wgmma<8>(x, w, scale, out, ws, m, n, k, splits, st);
    case 16:
      return launch_wgmma<16>(x, w, scale, out, ws, m, n, k, splits, st);
    case 32:
      return launch_wgmma<32>(x, w, scale, out, ws, m, n, k, splits, st);
    case 64:
      return launch_wgmma<64>(x, w, scale, out, ws, m, n, k, splits, st);
    case 128:
      return launch_wgmma<128>(x, w, scale, out, ws, m, n, k, splits, st);
  }
  return cudaErrorInvalidValue;
}
