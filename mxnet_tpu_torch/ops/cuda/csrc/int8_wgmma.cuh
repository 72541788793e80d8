// Hopper (sm_90a) building blocks of the int8 GEMM kernels
// (int8_matmul.cu, int8_conv_im2col.cu): warpgroup matrix multiplies
// with int8 operands and int32 sums, TMA loads of int8 tiles (2-D tiled
// and 4-D im2col), and the host encoders of their tensor maps. The
// mbarriers, the descriptor encoding and the driver entry point lookup
// are hopper.cuh's.
//
// wgmma reads 8-bit operands K-major only (its transpose bits exist for
// 16-bit types), so every tile here is rows of contiguous K bytes: W
// rows (n, k) and x rows (m, k) of the matmul, OHWI weight rows and NHWC
// pixels of the convolution. A tile of RB-byte rows (RB = 32, 64 or 128)
// is what TMA writes with the swizzle of the same span: 16-byte chunks
// XOR-swizzled by (row % 8) within each 8-row atom of 8 RB bytes. A
// descriptor with that swizzle reads the k32 step kk of such a tile at
// byte 32 kk of row 0, with 8 RB bytes between 8-row groups (the same
// geometry as hopper.cuh's bf16 tiles of RB / 2 elements). Tiles start
// on 1024-byte boundaries, so the swizzle phase is 0.
//
// Accumulator register i of a thread (warp w of the warpgroup, lane =
// 4 g + c) holds row 16 w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) +
// 2 c + (i & 1) of the 64 x N tile, as for the float32 wgmma.
#pragma once

#include <cstring>
#include <mutex>

#include "hopper.cuh"

namespace mxt {
namespace s8 {

using sm90::make_desc;

// -- K-major tiles -----------------------------------------------------------

template <int RB>
struct KTile {
  static_assert(RB == 32 || RB == 64 || RB == 128, "32, 64 or 128 B rows");
  static constexpr uint32_t kAtom = 8 * RB;
  // wgmma descriptor swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint32_t kMode = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kTma =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B);
  // the k32 step kk of the rows from `tile` (row 0 there)
  __device__ static uint64_t desc(uint32_t tile, int kk) {
    return make_desc(tile + 32 * kk, 16, kAtom, kMode);
  }
};

// -- wgmma m64nNk32, s8 x s8 -> s32 ------------------------------------------

// d (+)= A B^T for a 64-row A and an N-row B, both K-major in shared
// memory; scale_d 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void mma(int (&d)[4], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void mma(int (&d)[8], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(int (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(int (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(int (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// keep the compiler from moving register reads and writes of an
// accumulator across the asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// -- TMA ---------------------------------------------------------------------

// box (c0, c1) of a 2-D map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)),
      "r"(c0), "r"(c1)
      : "memory");
}

// im2col load of a 4-D (C, W, H, N) map: the map's pixelsPerColumn
// pixels from (w, h, n) on, walked along W, then H, then N within the
// map's bounding box at its element strides, each shifted by the tap
// offset (ow, oh) and giving channelsPerPixel channels from c; pixels
// outside the tensor read as zeros
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c, int w,
                                                int h, int n, uint16_t ow,
                                                uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      ::"r"(sm90::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(sm90::smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n), "h"(ow),
      "h"(oh)
      : "memory");
}

// named barrier over the consumer warpgroups (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// -- host: tensor maps -------------------------------------------------------

// A (rows, k) int8 matrix with `ld` bytes between rows as a 2-D map of
// (RB, box_rows) boxes; rows past `rows` and k past `k` read as zeros.
// ld must be a multiple of 16 and base 16-byte aligned.
template <int RB>
inline bool map_kmajor(CUtensorMap* m, const void* base, long long rows,
                       long long k, long long ld, int box_rows) {
  sm90::EncodeTiledFn fn = sm90::encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(RB),
                       static_cast<cuuint32_t>(box_rows)};
  cuuint32_t estr[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            KTile<RB>::kTma, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

typedef CUresult (*EncodeIm2colFn)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const int*, const int*,
                                   cuuint32_t, cuuint32_t, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeIm2colFn encode_im2col_fn() {
  static EncodeIm2colFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeIm2col", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeIm2colFn>(p);
  }
  return fn;
}

// A (b, h, w, c) int8 NHWC tensor (dense, c % 16 == 0, base 16-byte
// aligned) as an im2col map for a (kh, kw) window at stride (sh, sw),
// dilation (dh, dw) and padding (ph, pw): the bounding box of window
// origins runs from -pad to (size - 1 + pad - (k - 1) d) along each
// axis, walked at the conv's stride, so its pixels are the output
// positions in order (b, oh, ow); RB channels a pixel, `pixels` pixels
// a load.
template <int RB>
inline bool map_im2col(CUtensorMap* m, const void* base, int b, int h, int w,
                       int c, int kh, int kw, int sh, int sw, int ph, int pw,
                       int dh, int dw, int pixels) {
  EncodeIm2colFn fn = encode_im2col_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(c),
                        static_cast<cuuint64_t>(w),
                        static_cast<cuuint64_t>(h),
                        static_cast<cuuint64_t>(b)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(c),
                           static_cast<cuuint64_t>(w) * c,
                           static_cast<cuuint64_t>(h) * w * c};
  // corners in (W, H) order
  int lower[2] = {-pw, -ph};
  int upper[2] = {pw - (kw - 1) * dw, ph - (kh - 1) * dh};
  cuuint32_t estr[4] = {1, static_cast<cuuint32_t>(sw),
                        static_cast<cuuint32_t>(sh), 1};
  if (fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims,
         strides, lower, upper, static_cast<cuuint32_t>(RB),
         static_cast<cuuint32_t>(pixels), estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, KTile<RB>::kTma,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  // CUTLASS's make_im2col_tma_copy_desc clears this bit of an im2col
  // map over fewer than 128 KB under drivers up to 13.1; done alike
  int driver = 0;
  if (cudaDriverGetVersion(&driver) == cudaSuccess && driver <= 13010 &&
      static_cast<long long>(b) * h * w * c < 131072)
    reinterpret_cast<uint64_t*>(m)[1] &= ~(1ull << 21);
  return true;
}

// Encoded maps, direct-mapped on a hash of every argument of their
// encoding: a launch whose operands were seen before (the weights always,
// the activations mostly, as the caching allocator hands the same
// buffers out again) copies the map instead of encoding it. A map
// depends on nothing but those arguments, so a hit is always right.
class MapCache {
 public:
  static constexpr int kSlots = 1024;
  typedef long long Key[16];

  template <class Encode>
  bool get(const Key& key, CUtensorMap* out, Encode encode) {
    unsigned long long h = 1469598103934665603ull;
    for (long long v : key) h = (h ^ static_cast<unsigned long long>(v)) *
                                1099511628211ull;
    const int slot = static_cast<int>(h % kSlots);
    {
      std::lock_guard<std::mutex> g(mu_);
      if (valid_[slot] && std::memcmp(keys_[slot], key, sizeof(Key)) == 0) {
        *out = maps_[slot];
        return true;
      }
    }
    if (!encode(out)) return false;
    std::lock_guard<std::mutex> g(mu_);
    std::memcpy(keys_[slot], key, sizeof(Key));
    maps_[slot] = *out;
    valid_[slot] = true;
    return true;
  }

 private:
  std::mutex mu_;
  Key keys_[kSlots];
  CUtensorMap maps_[kSlots];
  bool valid_[kSlots] = {};
};

// internal linkage: each library keeps its own (a function-local static
// of an inline function is one object across every library loaded)
static MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

template <int RB>
static bool cached_kmajor(CUtensorMap* m, const void* base, long long rows,
                          long long k, long long ld, int box_rows) {
  const MapCache::Key key = {0, reinterpret_cast<long long>(base), rows, k,
                             ld, box_rows, RB};
  return map_cache().get(key, m, [&](CUtensorMap* out) {
    return map_kmajor<RB>(out, base, rows, k, ld, box_rows);
  });
}

template <int RB>
static bool cached_im2col(CUtensorMap* m, const void* base, int b, int h,
                          int w, int c, int kh, int kw, int sh, int sw,
                          int ph, int pw, int dh, int dw, int pixels) {
  const MapCache::Key key = {1000 + RB, reinterpret_cast<long long>(base),
                             b, h, w, c, kh, kw, sh, sw, ph, pw, dh, dw,
                             pixels};
  return map_cache().get(key, m, [&](CUtensorMap* out) {
    return map_im2col<RB>(out, base, b, h, w, c, kh, kw, sh, sw, ph, pw, dh,
                          dw, pixels);
  });
}

}  // namespace s8
}  // namespace mxt
