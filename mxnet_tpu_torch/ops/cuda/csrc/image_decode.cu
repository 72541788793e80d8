// The nvJPEG backend of the image pipeline's "native" route: decode a
// batch of JPEG records on the card, then convert, resize, crop, mirror,
// normalise and lay out the whole batch in one kernel.
//
// The JAX package decodes and augments on host threads with OpenCV
// (src/native/imagedec.cc, the reference's OMP ParseChunk), whose JPEG
// decoder is libjpeg-turbo. There is no TPU kernel here: the decode was
// host work on the TPU.
//
// * Decode: a pool of host threads, each with its own nvJPEG state and
//   CUDA stream, decodes one image at a time (nvjpegDecode: Huffman on
//   the host, the rest on the card) to its component planes, Y then Cb
//   and Cr at their subsampled size (NVJPEG_OUTPUT_YUV; Y alone for a
//   grayscale JPEG or a one-channel output), in a flat device buffer the
//   caller allocated, at the offsets it gave. nvJPEG's own RGB output
//   upsamples chroma otherwise than libjpeg-turbo (2.6 levels apart on
//   average at 4:2:0); its planes differ from libjpeg-turbo's only by
//   the inverse DCT's rounding. Before writing, every pool stream waits
//   for an event recorded on the caller's stream, so the buffer's
//   previous use by that stream (the caching allocator reuses freed
//   blocks in stream order) is complete; each image is synchronised on
//   its pool stream before the thread takes the next (its state's host
//   buffers are then free), and the call returns when every image is
//   written.
// * crop_mirror_normalize_kernel: what the JAX package's decoder does
//   after the inverse DCT, with the same bits. Each image's item (the
//   plan drawn on the host by native/imagedec.cc's imgdec_plan, keyed by
//   (seed, stream position)) gives, through describe(), its source
//   (planes of a chroma subsampling, or a uint8 HWC image) and for each
//   axis a resize of n_in source samples (from `win`) to n_out, of which
//   the output reads indices from `base` on (mirrored in x). The resize
//   is OpenCV's INTER_CUBIC on 8-bit data, reproduced exactly: per
//   output index float32 coefficients (A = -0.75, no contraction)
//   rounded to 11-bit integers, taps clamped to the source (replicate),
//   an exact int32 horizontal pass, then the vertical pass in float32
//   (S3*b3, then S2*b2 + t, S1*b1 + t, S0*b0 + t, each rounded, b =
//   beta * 2^-22, rint) except in the last (n_out * channels) % 8
//   values of each row, which OpenCV's 8-lane SIMD loop leaves to its
//   integer formula ((sum beta*S + 2^21) >> 22). n_in == n_out is the
//   identity. The colour is libjpeg-turbo's: its "fancy" chroma
//   upsampling (jdsample.c: h2v1, h2v2 and h1v2 triangular filters with
//   their rounding, edges replicated; plain replication where an h2
//   plane is at most 2 samples wide, and int_upsample for 4:1:1 and
//   4:1:0) and its integer tables (jdcolor.c, 16 fraction bits). One
//   CTA takes a 32 x 32 output tile of one image; `(v - mean[c]) /
//   std[c]` comes from a 3 x 256 table built with __fsub_rn / __fdiv_rn
//   in shared memory, stored as float4 for 4 consecutive x (float32
//   NCHW). A thread computes 4 consecutive x of one row.
//   - Identity tiles (the main path: no resize, the crop inside the
//     image): each source sample feeds one output, so a thread reads
//     its samples straight from the planes into registers, all loads
//     issued before the arithmetic, 4:2:0 / 4:2:2 chroma columns shared
//     by its pixels; a batch without any resize takes the lean
//     instantiation (kIdentity). Staged through shared memory, as the
//     resize tiles are, this path ran 1.6x slower (PERF.md §6).
//   - Resize tiles: (1) each axis's taps and coefficients, and the
//     source window under the tile: the contiguous run of samples the
//     taps reach (a 4-sample slot per output where a downscale spreads
//     them wider than 4 x the tile); (2) the window's Y rows and the
//     chroma rows under them (with the fancy filters' margin) staged by
//     16-byte cp.async copies aligned on the device address (the
//     buffer's first and last bytes by plain loads; a slotted window or
//     a uint8 image by plain loads); (3) the chroma upsampled vertically
//     once a row, then RGB once a window sample, in shared memory; (4)
//     the horizontal pass into int32 rows in shared memory; (5) the
//     vertical pass per output value.
//   An image resized below its crop takes a first launch (kCrops) that
//   writes its resized crop, uint8 HWC, to a scratch buffer, from which
//   the final launch resizes it to the output. It gives the plain
//   version's bits. Bound: bytes (each source window's samples read
//   once, the output written once).
#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "common.cuh"

namespace mxt {
namespace img {

constexpr int kThreads = 256;
constexpr int kTile = 32;            // output tile: kTile x kTile
constexpr int kPerThread = 4;        // consecutive x a thread writes
constexpr int kLanesX = kTile / kPerThread;

// item columns (int64): byte offset of the image's planes in src,
// height, width, x0, y0, mirror, kind, chroma height, chroma width,
// resized height, resized width, crop height, crop width
constexpr int kItem = 13;
// kind: the layout of the image's planes (image_decode.py KINDS); kRgb a
// uint8 HWC image of `channels` samples a pixel
enum Kind { kGray = 0, k444, k422, k420, k440, k411, k410, kRgb };

// one chroma sample at full resolution (row sy, column sx) of a plane of
// ch x cw samples of colour kind K, as libjpeg-turbo upsamples it;
// at(r, c) reads the plane's sample (r, c)
template <int K, typename At>
__device__ __forceinline__ int chroma(const At& at, int ch, int cw, int sy,
                                      int sx) {
  if constexpr (K == k444) {
    return at(sy, sx);
  } else if constexpr (K == k411) {
    return at(sy, sx >> 2);
  } else if constexpr (K == k410) {
    return at(sy >> 1, sx >> 2);
  } else if constexpr (K == k440) {   // h1v2_fancy_upsample
    const int near = sy >> 1, odd = sy & 1;
    const int far = odd ? min(near + 1, ch - 1) : max(near - 1, 0);
    return (3 * at(near, sx) + at(far, sx) + (odd ? 2 : 1)) >> 2;
  } else {
    static_assert(K == k422 || K == k420, "a colour kind");
    const int cc = sx >> 1, odd = sx & 1;
    const int nb = odd ? min(cc + 1, cw - 1) : max(cc - 1, 0);
    if constexpr (K == k422) {
      if (cw <= 2) return at(sy, cc);
      return (3 * at(sy, cc) + at(sy, nb) + (odd ? 2 : 1)) >> 2;
    } else {
      const int near = sy >> 1;
      if (cw <= 2) return at(near, cc);
      const int far = (sy & 1) ? min(near + 1, ch - 1) : max(near - 1, 0);
      const int cs = 3 * at(near, cc) + at(far, cc);
      const int cn = 3 * at(near, nb) + at(far, nb);
      return (3 * cs + cn + (odd ? 7 : 8)) >> 4;
    }
  }
}

template <int K>
struct KindTag {
  static constexpr int value = K;
};

// f(KindTag<K>{}) for the colour kind `kind`, K = kGray for any other:
// each path's per-sample code is compiled once a kind
template <typename F>
__device__ __forceinline__ void with_kind(int kind, F&& f) {
  switch (kind) {
    case k444: f(KindTag<k444>{}); break;
    case k422: f(KindTag<k422>{}); break;
    case k420: f(KindTag<k420>{}); break;
    case k440: f(KindTag<k440>{}); break;
    case k411: f(KindTag<k411>{}); break;
    case k410: f(KindTag<k410>{}); break;
    default: f(KindTag<kGray>{});
  }
}

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// jdcolor.c ycc_rgb_convert: FIX(x) = x * 2^16 rounded
__device__ __forceinline__ void ycc_rgb(int y, int cb, int cr, uint8_t* o) {
  const int u = cb - 128, v = cr - 128;
  o[0] = (uint8_t)clamp255(y + ((91881 * v + 32768) >> 16));
  o[1] = (uint8_t)clamp255(y + ((-22554 * u + 32768 - 46802 * v) >> 16));
  o[2] = (uint8_t)clamp255(y + ((116130 * u + 32768) >> 16));
}

// OpenCV's resize coordinate and interpolateCubic for output index d of
// an n_in -> n_out axis: the first tap's source index s (before the
// clamp) and the four coefficients as 11-bit integers. Every operation
// is rounded on its own (no FMA), as the x86 build computes it.
__device__ __forceinline__ int cubic(int d, int n_in, int n_out,
                                     int* alpha) {
  const double scale = __ddiv_rn(1.0, __ddiv_rn((double)n_out,
                                                (double)n_in));
  const float fx = __double2float_rn(
      __dadd_rn(__dmul_rn(__dadd_rn((double)d, 0.5), scale), -0.5));
  const float sf = floorf(fx);
  const float x = __fsub_rn(fx, sf);
  const float A = -0.75f;
  const float x1 = __fadd_rn(x, 1.f);
  const float c0 = __fsub_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(__fmul_rn(A, x1), 5 * A), x1),
                          8 * A), x1), 4 * A);
  const float c1 = __fadd_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(A + 2, x), A + 3), x), x),
      1.f);
  const float omx = __fsub_rn(1.f, x);
  const float c2 = __fadd_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(__fmul_rn(A + 2, omx), A + 3), omx),
                omx), 1.f);
  const float c3 = __fsub_rn(__fsub_rn(__fsub_rn(1.f, c0), c1), c2);
  alpha[0] = __float2int_rn(__fmul_rn(c0, 2048.f));
  alpha[1] = __float2int_rn(__fmul_rn(c1, 2048.f));
  alpha[2] = __float2int_rn(__fmul_rn(c2, 2048.f));
  alpha[3] = __float2int_rn(__fmul_rn(c3, 2048.f));
  return (int)sf - 1;
}

// one axis of a tile: per output index its four taps (window-relative)
// and coefficients; the window's source indices in `src_of`
struct Axis {
  short tap[kTile][4];
  int coef[kTile][4];
  float coef_f[kTile][4];   // y: coef * 2^-22 (exact)
  int d[kTile];             // the index in the resize's output (x: tail)
  int count;                // samples in the window
  int lo;                   // a dense window's first source index, or -1
};

// Fill axis `a` of the tile whose first output index is t0 (nv valid),
// by the 32 lanes of one warp: lane i takes output index t0 + i.
__device__ void axis_setup(Axis& a, int* src_of, int cap, int lane, int t0,
                           int nv, int out_n, int mirror, int n_in,
                           int n_out, int win, int base) {
  const bool valid = lane < nv;
  const bool ident = n_in == n_out;
  const int o = mirror ? out_n - 1 - (t0 + lane) : t0 + lane;
  const int d = base + (valid ? o : (mirror ? out_n - 1 - t0 : t0));
  int alpha[4] = {0, 2048, 0, 0};
  const int s = ident ? d - 1 : cubic(d, n_in, n_out, alpha);
  int tap[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    tap[k] = ident ? d : min(max(s + k, 0), n_in - 1);
  const int lo = __reduce_min_sync(0xffffffffu, valid ? tap[0] : INT_MAX);
  const int hi = __reduce_max_sync(0xffffffffu, valid ? tap[3] : INT_MIN);
  const bool dense = hi - lo + 1 <= cap;
  if (!dense && 4 * kTile > cap) __trap();   // the host's capacity is short
  if (dense) {
    for (int j = lane; j < hi - lo + 1; j += 32) src_of[j] = win + lo + j;
  } else if (valid) {
#pragma unroll
    for (int k = 0; k < 4; ++k) src_of[4 * lane + k] = win + tap[k];
  }
  if (valid) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a.tap[lane][k] = (short)(dense ? tap[k] - lo : 4 * lane + k);
      a.coef[lane][k] = alpha[k];
      a.coef_f[lane][k] = __fmul_rn((float)alpha[k], 0x1p-22f);
    }
    a.d[lane] = d;
  }
  if (lane == 0) {
    a.count = dense ? hi - lo + 1 : 4 * nv;
    a.lo = dense ? win + lo : -1;
  }
}

// Stage rows [r0, r0 + nr) x columns [c0, c0 + nc) of a plane (row pitch
// `pitch` bytes) into `dst` (row pitch `dp`, a multiple of 16): 16-byte
// cp.async chunks aligned on the device address, so that row r's
// column c lands at dst[r * dp + shift(r) + c - c0], shift(r) the low 4
// bits of the row's address (row_shift); chunks that start before the
// buffer [lo, hi) by plain loads, the one that runs past its end by a
// partial copy.
__device__ void stage(const uint8_t* plane, long long pitch, int r0, int nr,
                      int c0, int nc, uint8_t* dst, int dp,
                      const uint8_t* lo, const uint8_t* hi) {
  const int chunks = dp / 16;
  for (int k = threadIdx.x; k < nr * chunks; k += kThreads) {
    const int r = k / chunks, q = k - r * chunks;
    const uint8_t* row = plane + (r0 + r) * pitch + c0;
    const uint8_t* g = reinterpret_cast<const uint8_t*>(
        reinterpret_cast<uintptr_t>(row) & ~(uintptr_t)15) + 16 * q;
    if (g >= row + nc) continue;
    uint8_t* s = dst + r * dp + 16 * q;
    if (g >= lo && g + 16 <= hi) {
      cp_async16(s, g);
    } else if (g >= lo) {
      cp_async16(s, g, (int)(hi - g));
    } else {
      for (int b = 0; b < 16; ++b) s[b] = g + b >= lo && g + b < hi ? g[b] : 0;
    }
  }
}

// the low 4 bits of the address of column c0 of row r: only the low
// bits of the sum matter, so 32-bit arithmetic does
__device__ __forceinline__ int row_shift(const uint8_t* plane, int pitch,
                                        int r, int c0) {
  return (int)(((uint32_t)reinterpret_cast<uintptr_t>(plane) +
                (uint32_t)r * (uint32_t)pitch + (uint32_t)c0) & 15u);
}

__host__ __device__ __forceinline__ int up16(int b) { return (b + 15) & ~15; }

// bytes of the dynamic shared memory's parts for windows of up to wy x
// wx samples (wx, wy >= 1), colour planes subsampled at least hs x vs
// (0: none): the window's source indices, its staged planes and their
// chroma upsampled vertically, its RGB samples, the horizontal pass
// (in the planes' space: they are dead once converted)
struct Layout {
  int src_y, src_x, stage_dp, chroma_dp, chroma_rows, chroma_cols;
  int raw, rgb, work, total;
  __host__ __device__ Layout(int wx, int wy, int cn, int hs, int vs) {
    src_y = up16(4 * wy);
    src_x = up16(4 * wx);
    stage_dp = up16(wx + 15);
    chroma_cols = hs ? wx / hs + 4 : 0;
    chroma_rows = vs ? wy / vs + 4 : 0;
    chroma_dp = up16(chroma_cols + 15);
    raw = up16(wy * stage_dp + 2 * chroma_rows * chroma_dp);
    rgb = up16(wx * wy * 4);     // a 32-bit word a sample: R | G | B
    const int vc = 2 * wy * chroma_cols * 2;   // int16, two planes
    const int hor = wy * kTile * cn * 4;
    work = raw + vc > hor ? raw + vc : hor;
    total = src_y + src_x + rgb + work;
  }
};

// What one launch does with one image: its source, each axis's resize
// (n_in samples from `win` to n_out, the output reading n_out indices
// from `base` on; index 0: y, 1: x), the mirror, the output's size and
// offset. Derived from the image's item (image_decode.py _ITEM) for the
// crops pass (an image resized below its crop: the resized crop, uint8
// HWC, to the scratch buffer at i * out_h * out_w * cn) or the final
// pass (float32 NCHW, normalised).
struct Desc {
  long long src, dst;
  int ph, pw, kind, chh, chw;
  int n_in[2], n_out[2], win[2], base[2];
  int mirror, out_h, out_w;
  bool skip;
};

__device__ __forceinline__ Desc describe(const long long* it, int i,
                                         bool crops, int cn, int oh,
                                         int ow) {
  Desc d;
  const int h = (int)it[1], w = (int)it[2], x0 = (int)it[3];
  const int y0 = (int)it[4], rh = (int)it[9], rw = (int)it[10];
  const int crh = (int)it[11], crw = (int)it[12];
  const bool small = crh != oh || crw != ow;
  const bool both = (rh != h || rw != w) && small;
  d.src = it[0];
  d.ph = h;
  d.pw = w;
  d.kind = (int)it[6];
  d.chh = (int)it[7];
  d.chw = (int)it[8];
  // the short side's resize, the crop at (x0, y0) of the resized image
  d.n_in[0] = h, d.n_out[0] = rh, d.win[0] = 0, d.base[0] = y0;
  d.n_in[1] = w, d.n_out[1] = rw, d.win[1] = 0, d.base[1] = x0;
  d.skip = crops && !both;
  if (crops) {
    d.mirror = 0;
    d.out_h = crh;
    d.out_w = crw;
    d.dst = (long long)i * oh * ow * cn;
    return d;
  }
  d.mirror = (int)it[5];
  d.out_h = oh;
  d.out_w = ow;
  d.dst = (long long)i * cn * oh * ow;
  if (small) {
    // the crop resized to the output: from the scratch buffer after the
    // crops pass, else the window at (x0, y0) of the planes
    d.n_in[0] = crh, d.n_out[0] = oh, d.base[0] = 0;
    d.n_in[1] = crw, d.n_out[1] = ow, d.base[1] = 0;
    d.win[0] = both ? 0 : y0;
    d.win[1] = both ? 0 : x0;
    if (both) {
      d.src = (long long)i * oh * ow * cn;
      d.kind = kRgb;
      d.ph = crh;
      d.pw = crw;
    }
  }
  return d;
}

// the chroma of column sx of a row upsampled vertically already (vc:
// the row's staged chroma columns from cc0 on), upsampled horizontally
// as jdsample.c does for colour kind K
template <int K>
__device__ __forceinline__ int hchroma(const short* vc, int cw, int cc0,
                                       int sx) {
  if constexpr (K == k444 || K == k440) {
    return vc[sx - cc0];
  } else if constexpr (K == k411 || K == k410) {
    return vc[(sx >> 2) - cc0];
  } else {
    const int cc = sx >> 1, odd = sx & 1;
    if (cw <= 2) return vc[cc - cc0];
    const int nb = odd ? min(cc + 1, cw - 1) : max(cc - 1, 0);
    const int s = 3 * vc[cc - cc0] + vc[nb - cc0];
    return K == k422 ? (s + (odd ? 2 : 1)) >> 2 : (s + (odd ? 7 : 8)) >> 4;
  }
}

// An identity tile's thread: the RGB (or Y) of its nq <= 4 pixels of
// source row sy, columns sx[q], read straight from the planes (each
// sample feeds one output), every load issued before the arithmetic.
template <int K>
__device__ __forceinline__ void ident_pixels(const uint8_t* img,
                                             const uint8_t* cb,
                                             const uint8_t* cr, int pw,
                                             int ch, int cw, int sy,
                                             const int* sx, int nq, int cn,
                                             int (*v)[4]) {
  const uint8_t* row = img + (long long)sy * pw;
  int yv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) yv[q] = q < nq ? __ldg(row + sx[q]) : 0;
  if constexpr (K == kGray) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c][q] = yv[q];
  } else {
    auto atb = [&](int r, int c) {
      return (int)__ldg(cb + (long long)r * cw + c);
    };
    auto atr = [&](int r, int c) {
      return (int)__ldg(cr + (long long)r * cw + c);
    };
    int u[4], w[4];
    bool done = false;
    if constexpr (K == k420 || K == k422) {
      if (nq == 4 && cw > 2) {
        // the 4 pixels' source columns are lo .. lo + 3, in either
        // order; their fancy filters read 4 chroma columns from c_lo on
        // (those past an edge clamped, as the filters clamp), each
        // loaded once and summed over the two rows of 4:2:0
        const int lo = min(sx[0], sx[3]);
        const int c_lo = (lo >> 1) - 1 + (lo & 1);
        int near = sy, far = sy;
        if constexpr (K == k420) {
          near = sy >> 1;
          far = (sy & 1) ? min(near + 1, ch - 1) : max(near - 1, 0);
        }
        const uint8_t* bn = cb + (long long)near * cw;
        const uint8_t* bf = cb + (long long)far * cw;
        const uint8_t* rn = cr + (long long)near * cw;
        const uint8_t* rf = cr + (long long)far * cw;
        int sb[4], sr[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int col = min(max(c_lo + k, 0), cw - 1);
          if constexpr (K == k420) {
            sb[k] = 3 * __ldg(bn + col) + __ldg(bf + col);
            sr[k] = 3 * __ldg(rn + col) + __ldg(rf + col);
          } else {
            sb[k] = __ldg(bn + col);
            sr[k] = __ldg(rn + col);
          }
        }
        auto pick = [](const int* a, int k) {
          return k == 0 ? a[0] : (k == 1 ? a[1] : (k == 2 ? a[2] : a[3]));
        };
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int odd = sx[q] & 1, cc = (sx[q] >> 1) - c_lo;
          const int nb = odd ? cc + 1 : cc - 1;
          const int ub = 3 * pick(sb, cc) + pick(sb, nb);
          const int ur = 3 * pick(sr, cc) + pick(sr, nb);
          if constexpr (K == k420) {
            u[q] = (ub + (odd ? 7 : 8)) >> 4;
            w[q] = (ur + (odd ? 7 : 8)) >> 4;
          } else {
            u[q] = (ub + (odd ? 2 : 1)) >> 2;
            w[q] = (ur + (odd ? 2 : 1)) >> 2;
          }
        }
        done = true;
      }
    }
    if (!done) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        u[q] = q < nq ? chroma<K>(atb, ch, cw, sy, sx[q]) : 128;
        w[q] = q < nq ? chroma<K>(atr, ch, cw, sy, sx[q]) : 128;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint8_t o[3];
      ycc_rgb(yv[q], u[q], w[q], o);
      v[0][q] = o[0], v[1][q] = o[1], v[2][q] = o[2];
    }
  }
}

// A staged window's RGB (or Y) samples into rgb[i * wx + j], a word
// each (R | G << 8 | B << 16):
// first each row's chroma upsampled vertically into vcb (jdsample.c:
// 4:2:0's column sums 3 * near + far, 4:4:0's h1v2 filter, 4:1:0's
// replication; the rows themselves otherwise), then the horizontal
// filters and the colour tables per sample. A warp takes a row.
template <int K>
__device__ void staged_rgb(const uint8_t* work, int sdp,
                           const uint8_t* cbuf, const uint8_t* rbuf,
                           int cdp, short* vcb, const uint8_t* img,
                           const uint8_t* cb, const uint8_t* cr, int pw,
                           int chh, int chw, int ylo, int xlo, int wy,
                           int wx, int cr0, int cc0, int ncc,
                           uint32_t* rgb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  short* vcr = vcb + wy * ncc;
  if constexpr (K != kGray) {
    for (int i = warp; i < wy; i += kThreads / 32) {
      const int sy = ylo + i;
      int near = sy, far = -1, bias = 0, shift = 0;
      if constexpr (K == k420 || K == k440 || K == k410) {
        near = sy >> 1;
        if (K == k440 || (K == k420 && chw > 2)) {
          far = (sy & 1) ? min(near + 1, chh - 1) : max(near - 1, 0);
          if (K == k440) bias = (sy & 1) ? 2 : 1, shift = 2;
        }
      }
      const uint8_t* nb =
          cbuf + (near - cr0) * cdp + row_shift(cb, chw, near, cc0);
      const uint8_t* nr =
          rbuf + (near - cr0) * cdp + row_shift(cr, chw, near, cc0);
      const uint8_t* fb = nb;
      const uint8_t* fr = nr;
      if (far >= 0) {
        fb = cbuf + (far - cr0) * cdp + row_shift(cb, chw, far, cc0);
        fr = rbuf + (far - cr0) * cdp + row_shift(cr, chw, far, cc0);
      }
      for (int j = lane; j < ncc; j += 32) {
        int vb = nb[j], vr = nr[j];
        if (far >= 0) {
          vb = (3 * vb + fb[j] + bias) >> shift;
          vr = (3 * vr + fr[j] + bias) >> shift;
        }
        vcb[i * ncc + j] = (short)vb;
        vcr[i * ncc + j] = (short)vr;
      }
    }
    __syncthreads();
  }
  for (int i = warp; i < wy; i += kThreads / 32) {
    const uint8_t* yrow = work + i * sdp + row_shift(img, pw, ylo + i, xlo);
    const short* vrow = vcb + i * ncc;
    uint32_t* orow = rgb + i * wx;
    for (int j = lane; j < wx; j += 32) {
      const uint32_t yv = yrow[j];
      if constexpr (K == kGray) {
        orow[j] = yv * 0x010101u;
      } else {
        uint8_t o[3];
        ycc_rgb(yv, hchroma<K>(vrow, chw, cc0, xlo + j),
                hchroma<K>(vrow + wy * ncc, chw, cc0, xlo + j), o);
        orow[j] = o[0] | (uint32_t)o[1] << 8 | (uint32_t)o[2] << 16;
      }
    }
  }
}

// A slotted window's (or a uint8 HWC image's) RGB (or Y) samples
// src_y[i] x src_x[j] into rgb[i * wx + j] by plain loads; `rgb_image`:
// img holds cn samples a pixel. A warp takes a row. The path is rare
// (a downscale past the dense window, the second pass of an image
// resized below its crop): one loop for every kind, switching a sample.
__device__ void gathered_rgb(const uint8_t* img, const uint8_t* cb,
                             const uint8_t* cr, int kind, bool rgb_image,
                             int cn, int pw, int chh, int chw,
                             const int* src_y, const int* src_x, int wy,
                             int wx, uint32_t* rgb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto atb = [&](int r, int c) { return (int)cb[(long long)r * chw + c]; };
  auto atr = [&](int r, int c) { return (int)cr[(long long)r * chw + c]; };
  for (int i = warp; i < wy; i += kThreads / 32)
    for (int j = lane; j < wx; j += 32) {
      uint32_t* o = rgb + i * wx + j;
      const int sy = src_y[i], sx = src_x[j];
      if (rgb_image) {
        const uint8_t* p = img + ((long long)sy * pw + sx) * cn;
        *o = cn == 3 ? p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16
                     : p[0];
        continue;
      }
      const uint32_t yv = img[(long long)sy * pw + sx];
      with_kind(kind, [&](auto k) {
        constexpr int K = decltype(k)::value;
        if constexpr (K == kGray) {
          *o = yv * 0x010101u;
        } else {
          uint8_t b[3];
          ycc_rgb(yv, chroma<K>(atb, chh, chw, sy, sx),
                  chroma<K>(atr, chh, chw, sy, sx), b);
          *o = b[0] | (uint32_t)b[1] << 8 | (uint32_t)b[2] << 16;
        }
      });
    }
}

// launch modes: the final pass of a batch no image of which is resized
// (every tile the identity: the lean kernel), the final pass of any
// other batch, the crops pass
enum Mode { kIdentity = 0, kFinal = 1, kCrops = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    crop_mirror_normalize_kernel(const uint8_t* __restrict__ src,
                                 long long src_bytes,
                                 const long long* __restrict__ items, int cn,
                                 int oh, int ow, int tiles_x, int wx_cap,
                                 int wy_cap, int hsub, int vsub, int vec,
                                 float m0, float m1, float m2, float s0,
                                 float s1, float s2, uint8_t* scratch,
                                 float* __restrict__ out) {
  __shared__ Axis axes[2];      // 0: y, 1: x
  __shared__ float lut[3][256];
  __shared__ long long item[kItem];
  extern __shared__ __align__(16) uint8_t dyn[];
  if (threadIdx.x < kItem)
    item[threadIdx.x] = items[(size_t)blockIdx.y * kItem + threadIdx.x];
  if (kMode != kCrops) {
    for (int k = threadIdx.x; k < cn * 256; k += kThreads) {
      const int c = k >> 8, v = k & 255;
      const float m = c == 0 ? m0 : (c == 1 ? m1 : m2);
      const float sd = c == 0 ? s0 : (c == 1 ? s1 : s2);
      lut[c][v] = __fdiv_rn(__fsub_rn((float)v, m), sd);
    }
  }
  __syncthreads();
  const Desc d = describe(item, blockIdx.y, kMode == kCrops, cn, oh, ow);
  const int ty0 = (int)(blockIdx.x / tiles_x) * kTile;
  const int tx0 = (int)(blockIdx.x % tiles_x) * kTile;
  if (d.skip || ty0 >= d.out_h || tx0 >= d.out_w) return;
  const int nvy = min(kTile, d.out_h - ty0), nvx = min(kTile, d.out_w - tx0);
  const int kind = d.kind, chw = d.chw, chh = d.chh, plane_w = d.pw;
  const uint8_t* img = (kind == kRgb ? scratch : src) + d.src;
  const uint8_t* cb = img + (long long)d.ph * plane_w;
  const uint8_t* cr = cb + (long long)chh * chw;
  const bool colour = cn == 3 && kind != kGray && kind != kRgb;
  const bool ident = kMode == kIdentity ||
                     (d.n_in[0] == d.n_out[0] && d.n_in[1] == d.n_out[1]);
  // a thread's outputs: 4 consecutive x of one row
  const int y = threadIdx.x / kLanesX;
  const int x0 = (threadIdx.x - y * kLanesX) * kPerThread;
  const int nq = y < nvy ? max(0, min(kPerThread, nvx - x0)) : 0;
  const long long oy = ty0 + y;
  int v[3][kPerThread];
  if (ident) {
    // both axes the identity: each source sample is one output's, read
    // once, so it goes from the L1 cache to registers without staging
    // (staged through shared memory this path ran slower: PERF.md §6)
    const int sy = d.win[0] + d.base[0] + (int)oy;
    int sx[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int ox = tx0 + x0 + q;
      sx[q] = d.win[1] + d.base[1] + (d.mirror ? d.out_w - 1 - ox : ox);
    }
    with_kind(colour ? kind : (int)kGray, [&](auto k) {
      ident_pixels<decltype(k)::value>(img, cb, cr, plane_w, chh, chw, sy,
                                       sx, nq, cn, v);
    });
  } else if (kMode != kIdentity) {
    const Layout L(wx_cap, wy_cap, cn, hsub, vsub);
    int* src_y = reinterpret_cast<int*>(dyn);
    int* src_x = reinterpret_cast<int*>(dyn + L.src_y);
    uint32_t* rgb = reinterpret_cast<uint32_t*>(dyn + L.src_y + L.src_x);
    uint8_t* work = dyn + L.src_y + L.src_x + L.rgb;
    // 1. taps, coefficients and windows (warp 0: y, warp 1: x)
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0)
      axis_setup(axes[0], src_y, wy_cap, lane, ty0, nvy, d.out_h, 0,
                 d.n_in[0], d.n_out[0], d.win[0], d.base[0]);
    else if (warp == 1)
      axis_setup(axes[1], src_x, wx_cap, lane, tx0, nvx, d.out_w, d.mirror,
                 d.n_in[1], d.n_out[1], d.win[1], d.base[1]);
    __syncthreads();
    const Axis& ay = axes[0];
    const Axis& ax = axes[1];
    const int wy = ay.count, wx = ax.count;
    const int ylo = ay.lo, xlo = ax.lo;
    const bool staged = kind != kRgb && ylo >= 0 && xlo >= 0;
    const int sdp = L.stage_dp, cdp = L.chroma_dp;
    const uint8_t* cbuf = work + wy * sdp;
    const uint8_t* rbuf = cbuf + L.chroma_rows * cdp;
    short* vcb = reinterpret_cast<short*>(work + L.raw);
    int cr0 = 0, cc0 = 0, ncc = 0;
    if (staged) {
      // 2. the window's Y rows, and the chroma rows and columns under
      // them with the fancy filters' neighbours, by cp.async
      const uint8_t* phi = src + src_bytes;
      stage(img, plane_w, ylo, wy, xlo, wx, work, sdp, src, phi);
      if (colour) {
        const int yhi = ylo + wy - 1, xhi = xlo + wx - 1;
        const int vs = (kind == k420 || kind == k440 || kind == k410) ? 1 : 0;
        const int hs = (kind == k422 || kind == k420) ? 1
                       : ((kind == k411 || kind == k410) ? 2 : 0);
        const int m = hs == 1 ? 1 : 0;
        cr0 = max((ylo >> vs) - vs, 0);
        cc0 = max((xlo >> hs) - m, 0);
        const int ncr = min((yhi >> vs) + vs, chh - 1) - cr0 + 1;
        ncc = min((xhi >> hs) + m, chw - 1) - cc0 + 1;
        stage(cb, chw, cr0, ncr, cc0, ncc, work + wy * sdp, cdp, src, phi);
        stage(cr, chw, cr0, ncr, cc0, ncc,
              work + wy * sdp + L.chroma_rows * cdp, cdp, src, phi);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    // 3. the window's RGB (or Y) samples into rgb[i * wx + j], a word each:
    // from the staged planes, or by plain loads for a slotted window or a
    // uint8 image
    if (staged) {
      with_kind(colour ? kind : (int)kGray, [&](auto k) {
        staged_rgb<decltype(k)::value>(work, sdp, cbuf, rbuf, cdp, vcb, img,
                                       cb, cr, plane_w, chh, chw, ylo, xlo,
                                       wy, wx, cr0, cc0, ncc, rgb);
      });
    } else {
      gathered_rgb(img, cb, cr, colour ? kind : (int)kGray, kind == kRgb, cn,
                   plane_w, chh, chw, src_y, src_x, wy, wx, rgb);
    }
    __syncthreads();
    // 4. the horizontal pass: hor[(i * kTile + x) * cn + c], int32,
    // exact; a thread keeps one x's taps and walks the rows
    int* hor = reinterpret_cast<int*>(work);
    const int hx = threadIdx.x & (kTile - 1);
    if (hx < nvx) {
      int tap[4], coef[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        tap[k] = ax.tap[hx][k];
        coef[k] = ax.coef[hx][k];
      }
      for (int i = threadIdx.x / kTile; i < wy; i += kThreads / kTile) {
        const uint32_t* row = rgb + i * wx;
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = row[tap[k]];
        int* h = hor + (i * kTile + hx) * cn;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (c >= cn) break;
          const int sh = 8 * c;
          h[c] = (int)(w[0] >> sh & 255) * coef[0] +
                 (int)(w[1] >> sh & 255) * coef[1] +
                 (int)(w[2] >> sh & 255) * coef[2] +
                 (int)(w[3] >> sh & 255) * coef[3];
        }
      }
    }
    __syncthreads();
    // 5. the vertical pass: float32 as OpenCV's SIMD loop, its integer
    // formula in the row's last (n_out * cn) % 8 values
    const int tail = (d.n_out[1] * cn) & ~7;
    const int yy = y < nvy ? y : 0;
    int rows[4], beta[4];
    float b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rows[k] = ay.tap[yy][k] * kTile * cn;
      beta[k] = ay.coef[yy][k];
      b[k] = ay.coef_f[yy][k];
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (q >= nq) break;
      const int xq = x0 + q;
      const int dx = ax.d[xq] * cn;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (c >= cn) break;
        const int col = xq * cn + c;
        const int S0 = hor[rows[0] + col], S1 = hor[rows[1] + col];
        const int S2 = hor[rows[2] + col], S3 = hor[rows[3] + col];
        int r;
        if (dx + c >= tail) {
          r = (S0 * beta[0] + S1 * beta[1] + S2 * beta[2] + S3 * beta[3] +
               (1 << 21)) >> 22;
        } else {
          float f = __fmul_rn(__int2float_rn(S3), b[3]);
          f = __fadd_rn(__fmul_rn(__int2float_rn(S2), b[2]), f);
          f = __fadd_rn(__fmul_rn(__int2float_rn(S1), b[1]), f);
          f = __fadd_rn(__fmul_rn(__int2float_rn(S0), b[0]), f);
          r = __float2int_rn(f);
        }
        v[c][q] = clamp255(r);
      }
    }
  }
  // 6. the stores
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c >= cn || nq == 0) break;
    if (kMode == kCrops) {
      uint8_t* o = scratch + d.dst + (oy * d.out_w + tx0 + x0) * cn + c;
#pragma unroll
      for (int q = 0; q < kPerThread; ++q)
        if (q < nq) o[q * cn] = (uint8_t)v[c][q];
    } else {
      float* o = out + d.dst + (long long)c * d.out_h * d.out_w +
                 oy * d.out_w + tx0 + x0;
      if (vec && nq == kPerThread) {
        *reinterpret_cast<float4*>(o) =
            make_float4(lut[c][v[c][0]], lut[c][v[c][1]], lut[c][v[c][2]],
                        lut[c][v[c][3]]);
      } else {
#pragma unroll
        for (int q = 0; q < kPerThread; ++q)
          if (q < nq) o[q] = lut[c][v[c][q]];
      }
    }
  }
}

struct Job {
  int n = 0;
  const uint8_t* const* bufs = nullptr;
  const int64_t* lens = nullptr;
  uint8_t* dst = nullptr;
  const int64_t* offsets = nullptr;
  const int32_t* info = nullptr;   // n x (h, w, ncomp, css, ch, cw)
};

class Pool {
 public:
  Pool(int threads, int device, int channels)
      : device_(device), channels_(channels) {
    // the calling thread's current device is restored on the way out
    int prev = 0;
    cudaGetDevice(&prev);
    struct Restore {
      int dev;
      ~Restore() { cudaSetDevice(dev); }
    } restore{prev};
    cudaError_t ce = cudaSetDevice(device);
    if (ce != cudaSuccess) throw_cuda("cudaSetDevice", ce);
    nvjpegStatus_t st = nvjpegCreateSimple(&handle_);
    if (st != NVJPEG_STATUS_SUCCESS) throw_nvjpeg("nvjpegCreateSimple", st);
    ce = cudaEventCreateWithFlags(&start_, cudaEventDisableTiming);
    if (ce != cudaSuccess) throw_cuda("cudaEventCreate", ce);
    int nt = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    states_.resize(nt, nullptr);
    streams_.resize(nt, nullptr);
    for (int t = 0; t < nt; ++t) {
      st = nvjpegJpegStateCreate(handle_, &states_[t]);
      if (st != NVJPEG_STATUS_SUCCESS)
        throw_nvjpeg("nvjpegJpegStateCreate", st);
      ce = cudaStreamCreateWithFlags(&streams_[t], cudaStreamNonBlocking);
      if (ce != cudaSuccess) throw_cuda("cudaStreamCreate", ce);
    }
    workers_.reserve(nt);
    for (int t = 0; t < nt; ++t)
      workers_.emplace_back([this, t] { WorkerLoop(t); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      quit_ = true;
    }
    cv_job_.notify_all();
    for (auto& w : workers_) w.join();
    for (auto s : states_)
      if (s) nvjpegJpegStateDestroy(s);
    for (auto s : streams_)
      if (s) cudaStreamDestroy(s);
    if (start_) cudaEventDestroy(start_);
    if (handle_) nvjpegDestroy(handle_);
  }

  // n x (height, width, components, nvjpegChromaSubsampling_t, chroma
  // height, chroma width) of n JPEG buffers, without decoding them
  int Info(int n, const uint8_t* const* bufs, const int64_t* lens,
           int32_t* info) {
    for (int i = 0; i < n; ++i) {
      int ncomp = 0;
      nvjpegChromaSubsampling_t sub;
      int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
      nvjpegStatus_t st = nvjpegGetImageInfo(handle_, bufs[i],
                                             (size_t)lens[i], &ncomp, &sub,
                                             widths, heights);
      if (st != NVJPEG_STATUS_SUCCESS || widths[0] <= 0 ||
          heights[0] <= 0) {
        set_error("image " + std::to_string(i) +
                  " of the batch: nvjpegGetImageInfo failed (status " +
                  std::to_string((int)st) + "): not a JPEG nvJPEG reads");
        return -1;
      }
      int32_t* row = info + 6 * i;
      row[0] = heights[0];
      row[1] = widths[0];
      row[2] = ncomp;
      row[3] = (int32_t)sub;
      row[4] = ncomp > 1 ? heights[1] : 0;
      row[5] = ncomp > 1 ? widths[1] : 0;
    }
    return 0;
  }

  int Decode(int n, const uint8_t* const* bufs, const int64_t* lens,
             uint8_t* dst, const int64_t* offsets, const int32_t* info,
             cudaStream_t caller) {
    if (n <= 0) return 0;
    cudaError_t ce = cudaEventRecord(start_, caller);
    if (ce != cudaSuccess) {
      set_error(std::string("cudaEventRecord: ") + cudaGetErrorString(ce));
      return -1;
    }
    {
      std::lock_guard<std::mutex> g(mu_);
      job_ = Job{n, bufs, lens, dst, offsets, info};
      next_ = 0;
      pending_.store(n, std::memory_order_relaxed);
      failed_.store(0, std::memory_order_relaxed);
      epoch_++;
    }
    cv_job_.notify_all();
    {
      std::unique_lock<std::mutex> g(mu_);
      cv_done_.wait(g, [this] {
        return pending_.load(std::memory_order_acquire) == 0 &&
               running_ == 0;
      });
    }
    return failed_.load(std::memory_order_relaxed) ? -1 : 0;
  }

  const char* Error() {
    std::lock_guard<std::mutex> g(err_mu_);
    return err_.c_str();
  }

 private:
  [[noreturn]] static void throw_cuda(const char* what, cudaError_t e) {
    throw std::runtime_error(std::string(what) + ": " +
                             cudaGetErrorString(e));
  }
  [[noreturn]] static void throw_nvjpeg(const char* what, nvjpegStatus_t s) {
    throw std::runtime_error(std::string(what) + " failed (status " +
                             std::to_string((int)s) + ")");
  }

  void set_error(const std::string& msg) {
    failed_.store(1, std::memory_order_relaxed);
    std::lock_guard<std::mutex> g(err_mu_);
    err_ = msg;
  }

  void WorkerLoop(int t) {
    cudaSetDevice(device_);
    uint64_t seen = 0;
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_job_.wait(g, [&] { return quit_ || epoch_ != seen; });
        if (quit_) return;
        seen = epoch_;
        job = job_;
        running_++;
      }
      for (;;) {
        int i;
        {
          std::lock_guard<std::mutex> g(mu_);
          if (epoch_ != seen) break;
          i = next_++;
        }
        if (i >= job.n) break;
        DecodeOne(t, job, i);
        pending_.fetch_sub(1, std::memory_order_acq_rel);
      }
      {
        std::lock_guard<std::mutex> g(mu_);
        if (--running_ == 0 &&
            pending_.load(std::memory_order_acquire) == 0)
          cv_done_.notify_all();
      }
    }
  }

  void DecodeOne(int t, const Job& job, int i) {
    cudaStream_t s = streams_[t];
    cudaError_t ce = cudaStreamWaitEvent(s, start_, 0);
    if (ce != cudaSuccess) {
      set_error(std::string("cudaStreamWaitEvent: ") +
                cudaGetErrorString(ce));
      return;
    }
    // the planes: Y, then Cb and Cr of a colour image decoded for a
    // 3-channel output
    const int32_t* row = job.info + 6 * i;
    const bool planar = channels_ == 3 && row[2] > 1;
    nvjpegImage_t out;
    std::memset(&out, 0, sizeof(out));
    uint8_t* y = job.dst + job.offsets[i];
    out.channel[0] = y;
    out.pitch[0] = (size_t)row[1];
    if (planar) {
      const size_t cplane = (size_t)row[4] * row[5];
      out.channel[1] = y + (size_t)row[0] * row[1];
      out.channel[2] = out.channel[1] + cplane;
      out.pitch[1] = out.pitch[2] = (size_t)row[5];
    }
    nvjpegStatus_t st = nvjpegDecode(
        handle_, states_[t], job.bufs[i], (size_t)job.lens[i],
        planar ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y, &out, s);
    if (st != NVJPEG_STATUS_SUCCESS) {
      set_error("image " + std::to_string(i) +
                " of the batch: nvjpegDecode failed (status " +
                std::to_string((int)st) + ")");
      cudaStreamSynchronize(s);
      return;
    }
    ce = cudaStreamSynchronize(s);
    if (ce != cudaSuccess)
      set_error(std::string("image ") + std::to_string(i) +
                " of the batch: " + cudaGetErrorString(ce));
  }

  const int device_, channels_;
  nvjpegHandle_t handle_ = nullptr;
  cudaEvent_t start_ = nullptr;
  std::vector<nvjpegJpegState_t> states_;
  std::vector<cudaStream_t> streams_;

  std::mutex mu_, err_mu_;
  std::condition_variable cv_job_, cv_done_;
  std::vector<std::thread> workers_;
  Job job_;
  uint64_t epoch_ = 0;
  int running_ = 0;
  int next_ = 0;
  bool quit_ = false;
  std::atomic<int> pending_{0}, failed_{0};
  std::string err_;
};

std::mutex g_create_mu;
std::string g_create_error;

}  // namespace img
}  // namespace mxt

using mxt::img::Pool;

// The nvJPEG decode pool: `threads` host threads (0: one a core) on
// `device`, `channels` 3 (RGB) or 1 (Y). Null on failure
// (imgdec_nv_create_error says why).
extern "C" void* imgdec_nv_create(int threads, int device, int channels) {
  try {
    if (channels != 1 && channels != 3)
      throw std::runtime_error("channels must be 1 or 3");
    return new Pool(threads, device, channels);
  } catch (const std::exception& e) {
    std::lock_guard<std::mutex> g(mxt::img::g_create_mu);
    mxt::img::g_create_error = e.what();
    return nullptr;
  }
}

extern "C" const char* imgdec_nv_create_error() {
  std::lock_guard<std::mutex> g(mxt::img::g_create_mu);
  return mxt::img::g_create_error.c_str();
}

// info: n x (height, width, components, subsampling, chroma height,
// chroma width)
extern "C" int imgdec_nv_info(void* h, int n, const uint8_t* const* bufs,
                              const int64_t* lens, int32_t* info) {
  return static_cast<Pool*>(h)->Info(n, bufs, lens, info);
}

// Decode n images into dst + offsets[i]: the Y plane (height x width),
// then for a colour image and a 3-channel pool the Cb and Cr planes
// (chroma height x chroma width each), `info` as imgdec_nv_info gave it;
// returns when all are written. 0 or -1.
extern "C" int imgdec_nv_decode(void* h, int n, const uint8_t* const* bufs,
                                const int64_t* lens, void* dst,
                                const int64_t* offsets, const int32_t* info,
                                void* stream) {
  return static_cast<Pool*>(h)->Decode(n, bufs, lens,
                                       static_cast<uint8_t*>(dst), offsets,
                                       info,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* imgdec_nv_last_error(void* h) {
  return static_cast<Pool*>(h)->Error();
}

extern "C" void imgdec_nv_destroy(void* h) { delete static_cast<Pool*>(h); }

// src: the images' planes, src_bytes long; items: n x kItem int64 on
// the card; channels 1 or 3; out: float32 (n, channels, out_h, out_w);
// crops: the crops pass first (images resized below their crop, to
// scratch: n * out_h * out_w * channels bytes); wx_cap, wy_cap: the
// window capacities of the final pass, cx_cap, cy_cap the crops pass's
// (image_decode.py); hsub, vsub: the least chroma subsampling of the
// colour planes (0: none); resizes: the final pass resizes an image;
// vec: float4 stores allowed; mean, std: `channels` floats on the host.
// Returns a cudaError_t.
extern "C" int crop_mirror_normalize(const void* src, long long src_bytes,
                                     const void* items, int n, int channels,
                                     int out_h, int out_w, int crops,
                                     int wx_cap, int wy_cap, int cx_cap,
                                     int cy_cap, int hsub, int vsub,
                                     int resizes, int vec,
                                     const float* mean, const float* stdv,
                                     void* scratch, void* out,
                                     void* stream) {
  using namespace mxt::img;
  if (n <= 0) return 0;
  const int tiles_x = (out_w + kTile - 1) / kTile;
  dim3 grid(tiles_x * ((out_h + kTile - 1) / kTile), n);
  const float m1 = channels == 3 ? mean[1] : 0.f;
  const float m2 = channels == 3 ? mean[2] : 0.f;
  const float s1 = channels == 3 ? stdv[1] : 1.f;
  const float s2 = channels == 3 ? stdv[2] : 1.f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* s8 = static_cast<const uint8_t*>(src);
  const long long* it = static_cast<const long long*>(items);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  float* o = static_cast<float*>(out);
  cudaError_t ce;
  if (crops) {
    const size_t smem =
        (size_t)Layout(cx_cap, cy_cap, channels, hsub, vsub).total;
    ce = mxt::allow_smem(crop_mirror_normalize_kernel<kCrops>, smem);
    if (ce != cudaSuccess) return (int)ce;
    crop_mirror_normalize_kernel<kCrops><<<grid, kThreads, smem, st>>>(
        s8, src_bytes, it, channels, out_h, out_w, tiles_x, cx_cap, cy_cap,
        hsub, vsub, 0, mean[0], m1, m2, stdv[0], s1, s2, sc, o);
    ce = cudaGetLastError();
    if (ce != cudaSuccess) return (int)ce;
  }
  if (!resizes) {
    crop_mirror_normalize_kernel<kIdentity><<<grid, kThreads, 0, st>>>(
        s8, src_bytes, it, channels, out_h, out_w, tiles_x, wx_cap, wy_cap,
        hsub, vsub, vec, mean[0], m1, m2, stdv[0], s1, s2, sc, o);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      (size_t)Layout(wx_cap, wy_cap, channels, hsub, vsub).total;
  ce = mxt::allow_smem(crop_mirror_normalize_kernel<kFinal>, smem);
  if (ce != cudaSuccess) return (int)ce;
  crop_mirror_normalize_kernel<kFinal><<<grid, kThreads, smem, st>>>(
      s8, src_bytes, it, channels, out_h, out_w, tiles_x, wx_cap, wy_cap,
      hsub, vsub, vec, mean[0], m1, m2, stdv[0], s1, s2, sc, o);
  return (int)cudaGetLastError();
}
