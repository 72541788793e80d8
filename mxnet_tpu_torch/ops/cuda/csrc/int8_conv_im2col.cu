// int8_conv_im2col: a 2-D int8 convolution as an implicit GEMM,
// out[b, co, oh, ow] = f32(sum over (ci, kh, kw) of x * w) * scale[co].
//
// Replaces mxnet_tpu/ops/pallas/int8_matmul.py `int8_conv_im2col`, which
// unfolds the NCHW activations into patch rows (`_im2col`) and runs the
// `int8_matmul` Pallas kernel per group. Here no patch matrix exists:
// per group, M = b*oh*ow rows, N = cout/groups columns, K = (cin/groups)
// *kh*kw in the order (cin, kh, kw), so B is w.reshape(cout, -1) as on
// the TPU; each block gathers its A stage straight from the NCHW int8
// activations (zeros for the padding, the K tail and rows past M),
// groups are the grid's z axis, and the epilogue writes NCHW f32 with
// the per-channel rescale, with no transpose pass.
//
// Bound on an H100: at ResNet-50's shapes (batch 32) the int8 tensor-core
// operations (1979 TOP/s) bound most layers; the byte bound counts the
// int8 input, the int8 weights and the f32 output once. Design of this
// first kernel: the tile core of int8_gemm.cuh; a stage's 32 (ci, kh, kw)
// offsets are decoded once per block into shared memory; each thread owns
// one output row (b, oh, ow) for the whole K loop and gathers its bytes
// along K, a warp covering 32 consecutive rows (coalesced along M where
// the stride is 1), and writes them as words into the k-contiguous
// shared rows the mma fragments read. The byte gather, not the tensor
// cores, limits it; an NHWC layout, cp.async/TMA and wgmma are later
// work.
#include "int8_gemm.cuh"

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
