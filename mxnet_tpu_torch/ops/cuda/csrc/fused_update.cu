// The optimizer update of a whole parameter list in one launch:
// SGD (stateless or with momentum) and Adam, in place, float32.
//
// Replaces mxnet_tpu/ops/pallas/fused_update.py `_update_kernel` (the body
// of `sgd_fused_update` and `adam_fused_update`, launched by
// `_fused_update` once per parameter). The TPU kernel streams one
// parameter's row blocks through VMEM and evaluates the optimizer's lax
// rule on them; a ResNet-50 step issues 157 of those launches. On Hopper
// 157 small launches cost more in launch latency than the update costs
// in bytes, so this kernel walks every (tensor, chunk) pair of the list
// in one grid.
//
// Bound: bytes. SGD with momentum reads w, g and mom and writes w and mom
// (20 bytes a value); Adam reads w, g, m, v and writes w, m, v (28 bytes a
// value). At ResNet-50's 25.55M trained values that is 511 MB (0.153 ms at
// 3.35 TB/s) and 715 MB (0.213 ms). A thread moves 16 bytes per access
// where the tensor's pointers are aligned, and the operations are a few
// per value, far below the card's rate: nothing but the bytes matters.
//
// Table (built by mxnet_tpu_torch/ops/cuda/fused_update.py and uploaded
// with one host-to-device copy before each launch): the shared scalars,
// then one TensorEntry per tensor (weight, gradient and state pointers,
// element count, lr, wd), then n_tensors + 1 ints, the prefix sum of the
// tensors' chunk counts: block b updates chunk b - first[t] of the tensor
// t with first[t] <= b < first[t + 1], found by binary search. Gradient
// pointers change every step (autograd hands back new tensors), so the
// whole table is rebuilt each step; it is 52 bytes a tensor, about 8 KB
// for ResNet-50. As in the TPU kernel's packed SMEM vector, a
// learning-rate schedule and Adam's per-step bias correction change data,
// never the launch; whether the gradient is clipped is static (a template
// flag), as the presence of `clip_gradient` in the TPU kernel's hyper
// keys is.
//
// Arithmetic follows the plain rule (`_sgd_fused` / `_adam_fused` in the
// wrapper module, themselves the JAX package's optimizer rules) one
// operation at a time with explicit round-to-nearest intrinsics, so no
// multiply-add is contracted: on the card the kernel is bitwise equal to
// the plain PyTorch version, whose eager ops each round once and take
// their Python scalars as float32.
#include "common.cuh"

namespace {

enum Mode : int { kSgd = 0, kSgdMom = 1, kAdam = 2 };

struct TensorEntry {  // 48 bytes; null state pointers where unused
  float* w;
  const float* g;
  float* s0;  // momentum, or Adam's mean
  float* s1;  // Adam's variance
  long long n;
  float lr;
  float wd;
};

struct Shared {  // the step's shared scalars (8 floats)
  float rescale;  // rescale_grad
  float clip;     // clip_gradient (read only when CLIP)
  float a;        // SGD: momentum; Adam: beta1
  float b;        // Adam: 1 - beta1
  float c;        // Adam: beta2
  float d;        // Adam: 1 - beta2
  float eps;      // Adam: epsilon
  float unused;
};

constexpr int kThreads = 256;

template <int MODE, bool CLIP>
__device__ __forceinline__ void update(float& w, float g, float& s0,
                                       float& s1, float lr, float wd,
                                       const Shared& h) {
  g = __fmul_rn(g, h.rescale);
  if (CLIP) {  // jnp.clip / torch.clamp: NaN passes through
    const float lo = -h.clip;
    g = g < lo ? lo : (g > h.clip ? h.clip : g);
  }
  if (MODE == kAdam) {
    g = __fadd_rn(g, __fmul_rn(wd, w));
    s0 = __fadd_rn(__fmul_rn(h.a, s0), __fmul_rn(h.b, g));
    s1 = __fadd_rn(__fmul_rn(h.c, s1), __fmul_rn(h.d, __fmul_rn(g, g)));
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, s0),
                               __fadd_rn(__fsqrt_rn(s1), h.eps)));
  } else {
    const float step = __fmul_rn(lr, __fadd_rn(g, __fmul_rn(wd, w)));
    if (MODE == kSgdMom) {
      s0 = __fsub_rn(__fmul_rn(h.a, s0), step);
      w = __fadd_rn(w, s0);
    } else {
      w = __fsub_rn(w, step);
    }
  }
}

template <int MODE, bool CLIP>
__device__ __forceinline__ void update4(float4& w, const float4& g,
                                        float4& s0, float4& s1, float lr,
                                        float wd, const Shared& h) {
  update<MODE, CLIP>(w.x, g.x, s0.x, s1.x, lr, wd, h);
  update<MODE, CLIP>(w.y, g.y, s0.y, s1.y, lr, wd, h);
  update<MODE, CLIP>(w.z, g.z, s0.z, s1.z, lr, wd, h);
  update<MODE, CLIP>(w.w, g.w, s0.w, s1.w, lr, wd, h);
}

// One block per (tensor, chunk); chunk elements a block, a multiple of 4.
template <int MODE, bool CLIP>
__global__ void __launch_bounds__(kThreads)
    fused_update_kernel(const Shared* __restrict__ shared,
                        const TensorEntry* __restrict__ tensors,
                        const int* __restrict__ first, int n_tensors,
                        int chunk) {
  const int b = blockIdx.x;
  int lo = 0, hi = n_tensors - 1;  // the last t with first[t] <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const TensorEntry t = tensors[lo];
  const Shared h = *shared;
  const long long start = static_cast<long long>(b - first[lo]) * chunk;
  const long long end = min(t.n, start + chunk);
  const float lr = t.lr, wd = t.wd;
  float* __restrict__ w = t.w;
  const float* __restrict__ g = t.g;
  float* __restrict__ s0 = t.s0;
  float* __restrict__ s1 = t.s1;
  float dummy0 = 0.f, dummy1 = 0.f;

  long long i = start;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(s0) | reinterpret_cast<uintptr_t>(s1)) &
       15) == 0;
  if (aligned) {  // start is a multiple of 4: every float4 is aligned
    const long long n4 = (end - start) >> 2;
    for (long long k = threadIdx.x; k < n4; k += kThreads) {
      const long long e = start + 4 * k;
      float4 wv = *reinterpret_cast<const float4*>(w + e);
      const float4 gv = *reinterpret_cast<const float4*>(g + e);
      float4 m = make_float4(0.f, 0.f, 0.f, 0.f), v = m;
      if (MODE != kSgd) m = *reinterpret_cast<const float4*>(s0 + e);
      if (MODE == kAdam) v = *reinterpret_cast<const float4*>(s1 + e);
      update4<MODE, CLIP>(wv, gv, m, v, lr, wd, h);
      *reinterpret_cast<float4*>(w + e) = wv;
      if (MODE != kSgd) *reinterpret_cast<float4*>(s0 + e) = m;
      if (MODE == kAdam) *reinterpret_cast<float4*>(s1 + e) = v;
    }
    i = start + 4 * n4;  // the ragged tail, scalar
  }
  for (long long e = i + threadIdx.x; e < end; e += kThreads) {
    float wv = w[e];
    float& m = MODE != kSgd ? s0[e] : dummy0;
    float& v = MODE == kAdam ? s1[e] : dummy1;
    update<MODE, CLIP>(wv, g[e], m, v, lr, wd, h);
    w[e] = wv;
  }
}

template <int MODE, bool CLIP>
cudaError_t launch(const unsigned char* table, int n_tensors, int n_blocks,
                   int chunk, cudaStream_t stream) {
  const auto* shared = reinterpret_cast<const Shared*>(table);
  const auto* tensors =
      reinterpret_cast<const TensorEntry*>(table + sizeof(Shared));
  const auto* first = reinterpret_cast<const int*>(
      table + sizeof(Shared) + sizeof(TensorEntry) * n_tensors);
  fused_update_kernel<MODE, CLIP><<<n_blocks, kThreads, 0, stream>>>(
      shared, tensors, first, n_tensors, chunk);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 SGD, 1 SGD with momentum, 2 Adam; clip: 0 or 1.
// table: Shared, n_tensors TensorEntry, n_tensors + 1 int (block prefix;
// the last is n_blocks), on the card.
extern "C" int fused_update(int mode, int clip, const void* table,
                            int n_tensors, int n_blocks, int chunk,
                            void* stream) {
  static_assert(sizeof(Shared) == 32 && sizeof(TensorEntry) == 48,
                "table layout shared with fused_update.py");
  if (n_tensors <= 0 || n_blocks <= 0 || chunk <= 0 || chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const unsigned char*>(table);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode * 2 + (clip ? 1 : 0)) {
    case 0: err = launch<kSgd, false>(t, n_tensors, n_blocks, chunk, s); break;
    case 1: err = launch<kSgd, true>(t, n_tensors, n_blocks, chunk, s); break;
    case 2: err = launch<kSgdMom, false>(t, n_tensors, n_blocks, chunk, s); break;
    case 3: err = launch<kSgdMom, true>(t, n_tensors, n_blocks, chunk, s); break;
    case 4: err = launch<kAdam, false>(t, n_tensors, n_blocks, chunk, s); break;
    case 5: err = launch<kAdam, true>(t, n_tensors, n_blocks, chunk, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
