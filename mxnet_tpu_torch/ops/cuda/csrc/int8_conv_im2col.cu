// int8_conv_im2col: a 2-D int8 convolution as an implicit GEMM,
// out[b, co, oh, ow] = f32(sum over (ci, kh, kw) of x * w) * scale[co].
//
// Replaces mxnet_tpu/ops/pallas/int8_matmul.py `int8_conv_im2col`, which
// unfolds the NCHW activations into patch rows (`_im2col`) and runs the
// `int8_matmul` Pallas kernel per group. Here no patch matrix exists in
// device memory; groups are the grid's z axis, and the epilogue writes
// NCHW f32 with the per-channel rescale, with no transpose pass.
//
// Bound on an H100: at ResNet-50's shapes (batch 32) the f32 output is
// most of every layer's bytes, and the forward's 53 convolutions move
// 0.54 ms worth at 3.35 TB/s against 0.13 ms of int8 tensor-core work.
//
// Two routes; the wrapper (ops/cuda/int8_matmul.py `conv_route`) picks
// one from shapes, memory formats and alignment before the launch.
//
// wgmma (channels-last q and weights, cin / groups % 32 == 0): wgmma
// reads 8-bit operands K-major only, and in NCHW a patch row's channels
// lie H * W apart, so this route takes the activations as NHWC and the
// weights as OHWI (torch.channels_last memory of the logical NCHW /
// OIHW tensors) and orders K as (kh, kw, ci). A and B are swapped: a CTA
// computes BM output channels (wgmma's A operand: rows of OHWI weights)
// by 128 output positions (wgmma's N: pixels of the input) with two
// consumer warpgroups, each 64 channels by 128 positions (BM 128) or
// the same 64 channels by 64 positions each (BM 64: where a group has
// 64 channels or fewer, or where 128-channel tiles would leave SMs
// idle; the wrapper picks), so the int32 tile is already
// [channel][position], the order of an NCHW row. One producer thread
// feeds a ring of as many stages as 96 KB hold (6 or 8; two CTAs an SM)
// by TMA: a K chunk is BK = 64 (or 32) channels of one tap, the weights
// by a 2-D map over (K, cout), the pixels by an im2col map over the
// NHWC tensor whose walk covers the output positions in order (b, oh,
// ow) across rows and images, at the conv's stride, each shifted by the
// tap's offset; padding, the M tail and the cout tail read as zeros.
// The epilogue rescales in registers and writes each pair of positions
// with one 8-byte store (a warp covers 32 contiguous bytes of 8 channel
// rows), or one float at a time where an image's plane is odd.
//
// mma.sync (any other shape or memory format: the 3-channel stem, narrow
// groups, NCHW callers): the first design, the tile core of
// int8_gemm.cuh over NCHW / OIHW with K in the order (cin, kh, kw); a
// stage's 32 (ci, kh, kw) offsets are decoded once per block into shared
// memory; each thread owns one output row (b, oh, ow) for the whole K
// loop and gathers its bytes along K, a warp covering 32 consecutive
// rows, and writes them as words into the k-contiguous shared rows the
// mma fragments read. The byte gather, not the tensor cores, limits it.
#include "common.cuh"
#include "int8_gemm.cuh"
#include "int8_wgmma.cuh"

namespace mxt {
namespace i8 {

struct ConvShape {
  int B, C, H, W, Cout, G, KH, KW, SH, SW, PH, PW, DH, DW, OH, OW;
};

// a decoded stage of K: input offset of (ci, kh, kw) relative to the
// row's window origin, and the row / column displacement for the bounds
constexpr int kPastK = 1 << 29;

template <bool VEC_B>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     float* __restrict__ out, ConvShape p) {
  __shared__ Tiles s;
  __shared__ int koff[kBK], kdh[kBK], kdw[kBK];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int grp = blockIdx.z;
  const int cin_g = p.C / p.G, cout_g = p.Cout / p.G;
  const int KHW = p.KH * p.KW, K = cin_g * KHW;
  const int P = p.OH * p.OW, M = p.B * P, HW = p.H * p.W;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int8_t* __restrict__ wg = w + (int64_t)grp * cout_g * K;

  // this thread's A row, fixed for the whole K loop (A word j of the
  // thread is row tid % 64, k quad tid / 64 + 2j)
  const int row = tid & (kBM - 1);
  const int m = m0 + row;
  const bool mvalid = m < M;
  int ih0 = 0, iw0 = 0;
  const int8_t* xm = x;
  if (mvalid) {
    const int b = m / P, pp = m - b * P;
    const int oh = pp / p.OW, ow = pp - oh * p.OW;
    ih0 = oh * p.SH - p.PH;
    iw0 = ow * p.SW - p.PW;
    xm = x + ((int64_t)b * p.C + (int64_t)grp * cin_g) * HW
         + (int64_t)ih0 * p.W + iw0;
  }

  auto decode = [&](int k0) {
    if (tid < kBK) {
      const int k = k0 + tid;
      if (k < K) {
        const int ci = k / KHW, rem = k - ci * KHW;
        const int kh = rem / p.KW, kw = rem - kh * p.KW;
        kdh[tid] = kh * p.DH;
        kdw[tid] = kw * p.DW;
        koff[tid] = ci * HW + kh * p.DH * p.W + kw * p.DW;
      } else {
        kdh[tid] = kPastK;
        kdw[tid] = 0;
        koff[tid] = 0;
      }
    }
  };
  uint32_t aw[4];
  auto gather = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kq = ((tid >> 6) + 2 * j) * 4;
      uint32_t packed = 0;
      if (mvalid) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ih = ih0 + kdh[kq + e], iw = iw0 + kdw[kq + e];
          if ((unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W)
            packed |= static_cast<uint32_t>(
                          static_cast<uint8_t>(xm[koff[kq + e]]))
                      << (8 * e);
        }
      }
      aw[j] = packed;
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  RowLoader<VEC_B> lb;
  decode(0);
  __syncthreads();
  gather();
  lb.fetch(wg, cout_g, K, n0, 0, tid);
  __syncthreads();   // every gather has read the table before it changes
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kq = ((tid >> 6) + 2 * j) * 4;
      *reinterpret_cast<uint32_t*>(s.a + row * kLd + kq) = aw[j];
    }
    lb.store(s.b, tid);
    if (k0 + kBK < K) decode(k0 + kBK);
    __syncthreads();
    if (k0 + kBK < K) {
      gather();
      lb.fetch(wg, cout_g, K, n0, k0 + kBK, tid);
    }
    warp_stage(s, wm, wn, lane, acc);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int mo = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (mo >= M) continue;
      const int b = mo / P, pp = mo - b * P;
      float* __restrict__ orow = out + (int64_t)b * p.Cout * P + pp;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * t + c;
          if (n < cout_g) {
            const int co = grp * cout_g + n;
            orow[(int64_t)co * P] = rescale(acc[mi][ni][half * 2 + c],
                                            scale[co]);
          }
        }
    }
}

// -- the wgmma route ---------------------------------------------------------

constexpr int kCvBN = 128;                  // output positions a CTA
constexpr int kCvThreads = 256 + 32;  // two consumer warpgroups, a producer

// the ring: as many stages as 96 KB hold, at most 8 (two CTAs an SM)
template <int BK, int BM>
struct CvRing {
  static constexpr int kStageBytes = BK * (BM + kCvBN);
  static constexpr int kStages =
      96 * 1024 / kStageBytes < 8 ? 96 * 1024 / kStageBytes : 8;
  static constexpr size_t kSmem =
      size_t(kStages) * (kStageBytes + 16) + 1024;
};

// grid (position tiles, cout / groups tiles, groups). BM output channels
// a CTA: 128 (each warpgroup 64 channels by all 128 positions) or 64
// (both warpgroups the same 64 channels, each by 64 of the positions),
// so that no warpgroup idles where a group has 64 channels or fewer, and
// the grid has twice the CTAs where positions are few.
template <int BK, int BM>
__global__ void __launch_bounds__(kCvThreads, 2)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                           const __grid_constant__ CUtensorMap tx,
                           const float* __restrict__ scale,
                           float* __restrict__ out, ConvShape p) {
  constexpr uint32_t kA = BM * BK, kB = kCvBN * BK;
  constexpr int kCvStages = CvRing<BK, BM>::kStages;
  constexpr int WN = BM == 128 ? kCvBN : kCvBN / 2;   // positions a WG
  using T = s8::KTile<BK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::align_smem(smem_raw);
  unsigned char* a_s = sm;
  unsigned char* b_s = sm + kCvStages * kA;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + kCvStages * kB);
  uint64_t* empty = full + kCvStages;

  const int grp = blockIdx.z;
  const int cin_g = p.C / p.G, cout_g = p.Cout / p.G;
  const int cchunks = cin_g / BK, nc = p.KH * p.KW * cchunks;
  const int P = p.OH * p.OW, M = p.B * P;
  const int m0 = blockIdx.x * kCvBN, n0 = blockIdx.y * BM;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kCvStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], 256);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {
      // the first position's window origin; the im2col walk goes on
      // from there
      const int b = m0 / P, pp = m0 - b * P;
      const int oh = pp / p.OW, ow = pp - oh * p.OW;
      const int w0 = ow * p.SW - p.PW, h0 = oh * p.SH - p.PH;
      int tap = 0, cc = 0;
      for (int i = 0; i < nc; ++i) {
        const int st = i % kCvStages;
        const int kh = tap / p.KW, kw = tap - kh * p.KW;
        sm90::mbar_wait(&empty[st], ((i / kCvStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], kA + kB);
        s8::tma_load_2d(a_s + st * kA, &tw, &full[st],
                        tap * cin_g + cc * BK, grp * cout_g + n0);
        s8::tma_load_im2col(b_s + st * kB, &tx, &full[st],
                            grp * cin_g + cc * BK, w0, h0, b,
                            static_cast<uint16_t>(kw * p.DW),
                            static_cast<uint16_t>(kh * p.DH));
        if (++cc == cchunks) {
          cc = 0;
          ++tap;
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int row0 = BM == 128 ? wg * 64 : 0;     // channel rows of this WG
  const int col0 = BM == 128 ? 0 : wg * WN;     // position columns
  int acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0;
  for (int i = 0; i < nc; ++i) {
    const int st = i % kCvStages;
    sm90::mbar_wait(&full[st], (i / kCvStages) & 1);
    const uint32_t a_t = sm90::smem_u32(a_s + st * kA) + row0 * BK;
    const uint32_t b_t = sm90::smem_u32(b_s + st * kB) + col0 * BK;
    s8::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      s8::Wgmma<WN>::mma(acc, T::desc(a_t, kk), T::desc(b_t, kk), 1);
    sm90::wgmma_commit();
    // the previous chunk's products are done: free its stage
    sm90::wgmma_wait<1>();
    s8::fence_regs(acc);
    if (i > 0) sm90::mbar_arrive(&empty[(i - 1) % kCvStages]);
  }
  sm90::wgmma_wait<0>();
  s8::fence_regs(acc);

  // acc[i]: channel row row0 + 16 warp + g + 8 ((i >> 1) & 1), position
  // column col0 + 8 (i >> 2) + 2 c + (i & 1)
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  int co[2];
  float sc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = n0 + row0 + 16 * warp + g + 8 * h;
    co[h] = r < cout_g ? grp * cout_g + r : -1;
    sc[h] = r < cout_g ? scale[co[h]] : 0.f;
  }
  // (image, position in its plane) of column 2 c, stepped 8 columns on
  int m = m0 + col0 + 2 * c;
  int b = m / P, pp = m - b * P;
  const bool pairs = (P & 1) == 0;
  const int64_t plane = (int64_t)p.Cout * P;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    if (m < M) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (co[h] < 0) continue;
        const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        float* o = out + b * plane + (int64_t)co[h] * P + pp;
        if (pairs) {
          // P even and m even: m + 1 is in the same plane, and valid
          *reinterpret_cast<float2*>(o) =
              make_float2(rescale(v0, sc[h]), rescale(v1, sc[h]));
        } else {
          o[0] = rescale(v0, sc[h]);
          if (m + 1 < M) {
            // m + 1 may open the next image's plane
            const int b1 = pp + 1 == P ? b + 1 : b;
            const int p1 = pp + 1 == P ? 0 : pp + 1;
            out[b1 * plane + (int64_t)co[h] * P + p1] = rescale(v1, sc[h]);
          }
        }
      }
    }
    m += 8;
    pp += 8;
    while (pp >= P) {
      pp -= P;
      ++b;
    }
  }
}

template <int BK, int BM>
static int launch_conv_wgmma(const void* x, const void* w, const void* scale,
                      void* out, const ConvShape& p, cudaStream_t st) {
  const int cin_g = p.C / p.G, cout_g = p.Cout / p.G;
  const long long K = (long long)p.KH * p.KW * cin_g;
  CUtensorMap tw, tx;
  if (!s8::cached_kmajor<BK>(&tw, w, p.Cout, K, K, BM) ||
      !s8::cached_im2col<BK>(&tx, x, p.B, p.H, p.W, p.C, p.KH, p.KW, p.SH,
                             p.SW, p.PH, p.PW, p.DH, p.DW, kCvBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = CvRing<BK, BM>::kSmem;
  // the shared-memory opt-in, once a kernel (a driver call a launch
  // costs host microseconds); static, so the flag is this library's
  static bool opted = false;
  if (!opted) {
    cudaError_t err = allow_smem(int8_conv_wgmma_kernel<BK, BM>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const long long M = (long long)p.B * p.OH * p.OW;
  const dim3 grid((unsigned)((M + kCvBN - 1) / kCvBN),
                  (cout_g + BM - 1) / BM, p.G);
  int8_conv_wgmma_kernel<BK, BM><<<grid, kCvThreads, smem, st>>>(
      tw, tx, static_cast<const float*>(scale), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i8
}  // namespace mxt

// x (b, c, h, w) int8 NCHW; w (cout, c / groups, kh, kw) int8 OIHW;
// scale (cout,) f32; out (b, cout, oh, ow) f32; symmetric padding.
extern "C" int int8_conv_im2col(const void* x, const void* w,
                                const void* scale, void* out, int b, int c,
                                int h, int wd, int cout, int groups, int kh,
                                int kw, int sh, int sw, int ph, int pw,
                                int dh, int dw, int oh, int ow,
                                void* stream) {
  using namespace mxt::i8;
  if (b <= 0 || c <= 0 || cout <= 0 || groups <= 0 || c % groups
      || cout % groups || kh <= 0 || kw <= 0 || oh <= 0 || ow <= 0
      || sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || ph < 0 || pw < 0)
    return cudaErrorInvalidValue;
  const long long K = (long long)(c / groups) * kh * kw;
  const long long M = (long long)b * oh * ow;
  if (K > kMaxK || M >= (1LL << 31) || (long long)c * h * wd >= (1LL << 31))
    return cudaErrorInvalidValue;
  const ConvShape p{b, c, h, wd, cout, groups, kh, kw, sh, sw,
                    ph, pw, dh, dw, oh, ow};
  const int cout_g = cout / groups;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (cout_g + kBN - 1) / kBN,
                  groups);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const int8_t*>(w);
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  if (vec)
    int8_conv_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(x), wp, static_cast<const float*>(scale),
        static_cast<float*>(out), p);
  else
    int8_conv_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(x), wp, static_cast<const float*>(scale),
        static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma route: x (b, c, h, w) int8 in channels-last memory (NHWC),
// w (cout, c / groups, kh, kw) int8 in channels-last memory (OHWI), both
// 16-byte aligned; (c / groups) % bk == 0 with bk 32 or 64; bm (output
// channels a CTA) 64 or 128; scale
// (cout,) f32; out (b, cout, oh, ow) f32 NCHW; symmetric padding; the
// limits of an im2col tensor map (stride <= 8, window corners within
// [-128, 127]) are the wrapper's to check, and encoding fails past them.
extern "C" int int8_conv_wgmma(const void* x, const void* w,
                               const void* scale, void* out, int b, int c,
                               int h, int wd, int cout, int groups, int kh,
                               int kw, int sh, int sw, int ph, int pw, int dh,
                               int dw, int oh, int ow, int bk, int bm,
                               void* stream) {
  using namespace mxt::i8;
  if (b <= 0 || c <= 0 || cout <= 0 || groups <= 0 || c % groups ||
      cout % groups || kh <= 0 || kw <= 0 || oh <= 0 || ow <= 0 || sh <= 0 ||
      sw <= 0 || dh <= 0 || dw <= 0 || ph < 0 || pw < 0 ||
      (bk != 32 && bk != 64) || (bm != 64 && bm != 128) ||
      (c / groups) % bk ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  const long long K = (long long)(c / groups) * kh * kw;
  const long long M = (long long)b * oh * ow;
  if (K > kMaxK || M >= (1LL << 31) || (long long)c * h * wd >= (1LL << 31))
    return cudaErrorInvalidValue;
  const ConvShape p{b, c, h, wd, cout, groups, kh, kw, sh, sw,
                    ph, pw, dh, dw, oh, ow};
  const auto st = static_cast<cudaStream_t>(stream);
  if (bk == 64)
    return bm == 128 ? launch_conv_wgmma<64, 128>(x, w, scale, out, p, st)
                     : launch_conv_wgmma<64, 64>(x, w, scale, out, p, st);
  return bm == 128 ? launch_conv_wgmma<32, 128>(x, w, scale, out, p, st)
                   : launch_conv_wgmma<32, 64>(x, w, scale, out, p, st);
}
