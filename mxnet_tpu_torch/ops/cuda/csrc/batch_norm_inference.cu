// batch_norm_inference: y[n, c, i] = x[n, c, i] * a[c] + b[c] with the
// moving statistics, a = gamma / sqrt(var + eps), b = beta - mean * a.
//
// Replaces the inference branch of mxnet_tpu/ops/nn.py `_batch_norm`
// (XLA on the TPU, no Pallas kernel). Every operation is the
// correctly rounded one (__fadd_rn, __fmul_rn, __fsqrt_rn, __fdiv_rn),
// and none is contracted into an FMA, so the card gives the bits of the
// plain version, on the card and on the CPU alike. A quantized network
// needs those bits: a BatchNorm output an ulp away moves an activation
// that lies on a rounding boundary one int8 step.
//
// Bound on an H100: bytes. One read of x and one write of y (ResNet-50
// at batch 32: 7 to 103 MB a layer); a and b cost a few operations a
// thread, recomputed from four loads that stay in L1. Design: a
// grid-stride loop over the elements, 16-byte loads and stores when a
// channel's plane is a multiple of 4 floats and the pointers are
// aligned, one float at a time otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxt {
namespace bn {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float2 affine(const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         const float* __restrict__ mean,
                                         const float* __restrict__ var,
                                         int c, float eps, int fix_gamma) {
  const float g = fix_gamma ? 1.0f : __ldg(gamma + c);
  const float a = __fdiv_rn(g, __fsqrt_rn(__fadd_rn(__ldg(var + c), eps)));
  const float b = __fsub_rn(__ldg(beta + c), __fmul_rn(__ldg(mean + c), a));
  return make_float2(a, b);
}

__device__ __forceinline__ float apply(float x, float2 ab) {
  return __fadd_rn(__fmul_rn(x, ab.x), ab.y);
}

// VEC: `items` counts float4s and `inner` is a plane's length in float4s
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    bn_inference_kernel(const float* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const float* __restrict__ mean,
                        const float* __restrict__ var,
                        float* __restrict__ y, int64_t items, int channels,
                        int64_t inner, float eps, int fix_gamma) {
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < items;
       i += step) {
    const int c = (int)((i / inner) % channels);
    const float2 ab = affine(gamma, beta, mean, var, c, eps, fix_gamma);
    if (VEC) {
      float4 v = reinterpret_cast<const float4*>(x)[i];
      v.x = apply(v.x, ab);
      v.y = apply(v.y, ab);
      v.z = apply(v.z, ab);
      v.w = apply(v.w, ab);
      reinterpret_cast<float4*>(y)[i] = v;
    } else {
      y[i] = apply(x[i], ab);
    }
  }
}

}  // namespace bn
}  // namespace mxt

// x, y (n, c, inner) f32 contiguous; gamma, beta, mean, var (c,) f32.
// fix_gamma != 0 takes gamma as ones.
extern "C" int batch_norm_inference(const void* x, const void* gamma,
                                    const void* beta, const void* mean,
                                    const void* var, void* y, long long n,
                                    int c, long long inner, float eps,
                                    int fix_gamma, void* stream) {
  using namespace mxt::bn;
  if (n <= 0 || c <= 0 || inner <= 0) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const float*>(x);
  auto* yp = static_cast<float*>(y);
  const bool vec = inner % 4 == 0
                   && reinterpret_cast<uintptr_t>(xp) % 16 == 0
                   && reinterpret_cast<uintptr_t>(yp) % 16 == 0;
  const long long per = vec ? inner / 4 : inner;
  const long long items = n * c * per;
  const int blocks = (int)((items + kThreads - 1) / kThreads < kMaxBlocks
                               ? (items + kThreads - 1) / kThreads
                               : kMaxBlocks);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  const auto* m = static_cast<const float*>(mean);
  const auto* v = static_cast<const float*>(var);
  if (vec)
    bn_inference_kernel<true><<<blocks, kThreads, 0, st>>>(
        xp, g, b, m, v, yp, items, c, per, eps, fix_gamma);
  else
    bn_inference_kernel<false><<<blocks, kThreads, 0, st>>>(
        xp, g, b, m, v, yp, items, c, per, eps, fix_gamma);
  return static_cast<int>(cudaGetLastError());
}
