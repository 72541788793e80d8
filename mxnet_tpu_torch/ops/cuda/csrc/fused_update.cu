// The optimizer update of a whole parameter list in one launch, in place:
// every fused rule of the JAX package's optimizer (SGD with or without
// momentum, NAG, signSGD / Signum, Adam, AdaGrad, RMSProp plain and
// centered, AdaDelta, FTRL, FTML, Adamax, Test), over float32, bfloat16
// and float16 weights, and the master-weight mode (multi_precision: the
// rule runs on a float32 master copy and float32 states, the weight is
// written as the master rounded to its own type: float16 weights in every
// rule, float32 and bf16 weights in SGD only, as the mp_sgd ops give them).
//
// Replaces mxnet_tpu/ops/pallas/fused_update.py `_update_kernel` (the body
// of `sgd_fused_update` and `adam_fused_update`, launched by
// `_fused_update` once per parameter). The TPU kernel streams one
// parameter's row blocks through VMEM and evaluates the optimizer's lax
// rule on them; a ResNet-50 step issues 157 of those launches. On Hopper
// 157 small launches cost more in launch latency than the update costs
// in bytes, so this kernel walks every (tensor, chunk) pair of the list
// in one grid. The TPU kernel takes float32 only (its body rebuilds the
// hyperparameters from float32 SMEM scalars, which a bf16 store refuses);
// off the TPU, and so for bf16 / float16 weights, the JAX package runs the
// lax rule itself, which is what this kernel computes for those types.
//
// Bound: bytes. SGD with momentum reads w, g and mom and writes w and mom
// (20 bytes a value at float32, 10 at bf16 / float16; the master mode
// reads g, mom and the master and writes all three and the weight, 20
// bytes a value at float16); Adam reads w, g, m, v and writes w, m, v (28
// bytes a value at float32). At ResNet-50's 25.55M trained values float32
// SGD with momentum is 511 MB (0.153 ms at 3.35 TB/s). A thread moves 16
// bytes per access where a tensor's pointers are aligned, and the
// operations are a few per value, far below the card's rate: nothing but
// the bytes matters.
//
// Table (built by mxnet_tpu_torch/ops/cuda/fused_update.py and uploaded
// with one host-to-device copy before each launch): 16 shared float32
// scalars, then one TensorEntry per tensor (its type, weight, gradient,
// state and master pointers, element count, lr, wd and two more per-tensor
// scalars), then n_tensors + 1 ints, the prefix sum of the tensors' chunk
// counts: block b updates chunk b - first[t] of the tensor t with
// first[t] <= b < first[t + 1], found by binary search. Gradient pointers
// change every step (autograd hands back new tensors), so the whole table
// is rebuilt each step; it is 84 bytes a tensor, about 13 KB for
// ResNet-50. As in the TPU kernel's packed SMEM vector, a learning-rate
// schedule and the per-step bias corrections change data, never the
// launch. One launch may mix tensor types (a bf16 net keeps BatchNorm's
// gamma and beta float32): each block branches once on its tensor's type.
//
// Arithmetic follows the plain rules (`_sgd_fused`, `_adam_fused`, ... in
// the wrapper module, themselves the JAX package's optimizer rules) one
// operation at a time: each operation is evaluated in float32 with an
// explicit round-to-nearest intrinsic, so no multiply-add is contracted,
// and its result is rounded to the compute type R before the next
// operation reads it. R is the weight's own type (float32, bf16 or
// float16: the JAX rule at bf16 rounds every operation to bf16), or
// float32 in the master mode. Each hyperparameter arrives as a float32
// and is rounded to R once, at the block's start, as a Python scalar is
// rounded to the weight's type by both frameworks (through float32). On
// the card the kernel is bitwise equal to the plain PyTorch version.
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace {

enum Mode : int {
  kSgd = 0, kSgdMom = 1, kAdam = 2, kNagMom = 3, kSignSgd = 4, kSignum = 5,
  kAdaGrad = 6, kRmsProp = 7, kRmsPropAlex = 8, kAdaDelta = 9, kFtrl = 10,
  kFtml = 11, kAdamax = 12, kTest = 13
};

// a tensor's type: float32, bf16 or float16 weights, + 3 in master mode
enum Kind : int { kF32 = 0, kBf16 = 1, kF16 = 2, kMaster = 3 };
enum Flag : int { kClip = 1, kClipWeights = 2 };

__host__ __device__ constexpr int n_states(int mode) {
  return mode == kSgd || mode == kSignSgd ? 0
         : mode == kAdam || mode == kAdaDelta || mode == kFtrl ||
                 mode == kAdamax
             ? 2
         : mode == kRmsPropAlex || mode == kFtml ? 3
                                                 : 1;
}

struct TensorEntry {  // 80 bytes; null pointers where unused
  void* w;
  const void* g;
  void* s0;      // momentum, Adam's / Adamax's mean, AdaGrad's history,
                 // RMSProp's n, AdaDelta's acc_g, FTRL's z, FTML's d
  void* s1;      // Adam's variance, centered RMSProp's g, AdaDelta's
                 // acc_delta, FTRL's n, FTML's v, Adamax's u
  void* s2;      // centered RMSProp's delta, FTML's z
  float* w32;    // the float32 master copy (master mode)
  long long n;
  float lr;
  float wd;
  float p0;      // Signum: 1 - lr * wd_lh; FTML: (1 - beta1^t) / lr
  float p1;      // Signum: lr * wd;        FTML: 1 - beta2^t
  int kind;
  int pad;
};

// the launch's shared scalars, h[0] rescale_grad, h[1] clip_gradient,
// h[2..6] the rule's own (momentum; beta1, 1 - beta1, beta2, 1 - beta2,
// epsilon; ...: _SHARED_KEYS in fused_update.py), h[8] clip_weights
struct Shared {
  float h[16];
};

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T to_type(float x);
template <>
__device__ __forceinline__ float to_type<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_type<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half to_type<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to R, as a float
template <typename R>
__device__ __forceinline__ float rnd(float x) {
  return to_float(to_type<R>(x));
}

// one operation: evaluated in float32, rounded to R
template <typename R>
struct Ops {
  static __device__ __forceinline__ float mul(float a, float b) {
    return rnd<R>(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return rnd<R>(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return rnd<R>(__fsub_rn(a, b));
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return rnd<R>(__fdiv_rn(a, b));
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return rnd<R>(__fsqrt_rn(a));
  }
};

// jnp.clip: max then min, NaN passes through (lo > hi gives hi)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}
// jnp.sign: NaN stays NaN, a zero keeps its sign bit
__device__ __forceinline__ float sign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}
// jnp.maximum: NaN wins
__device__ __forceinline__ float maximum(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// the hyperparameters of one block, rounded to R
struct Hyper {
  float rescale, clip, a, b, c, d, e, clip_w, lr, wd, p0, p1;
};

template <typename R>
__device__ __forceinline__ Hyper hyper(const Shared& s, const TensorEntry& t) {
  Hyper p;
  p.rescale = rnd<R>(s.h[0]);
  p.clip = rnd<R>(s.h[1]);
  p.a = rnd<R>(s.h[2]);
  p.b = rnd<R>(s.h[3]);
  p.c = rnd<R>(s.h[4]);
  p.d = rnd<R>(s.h[5]);
  p.e = rnd<R>(s.h[6]);
  p.clip_w = rnd<R>(s.h[8]);
  p.lr = rnd<R>(t.lr);
  p.wd = rnd<R>(t.wd);
  p.p0 = rnd<R>(t.p0);
  p.p1 = rnd<R>(t.p1);
  return p;
}

// One value of the rule MODE, each operation rounded to R: w and the
// states in and out, g the gradient. Each line is the JAX rule's
// (mxnet_tpu/optimizer.py _sgd_fused ... _test_fused) in its order.
template <int MODE, typename R>
__device__ __forceinline__ void rule(float& w, float g, float& s0, float& s1,
                                     float& s2, const Hyper& p, int flags) {
  using O = Ops<R>;
  if (MODE == kTest) {  // w - lr * g * rescale; state + g
    w = O::sub(w, O::mul(O::mul(p.lr, g), p.rescale));
    s0 = O::add(s0, g);
    return;
  }
  const float g0 = g;
  if (MODE == kAdamax) {  // rescale, + wd * w, then clip
    g = O::add(O::mul(g0, p.rescale), O::mul(p.wd, w));
    if (flags & kClip) g = clip(g, -p.clip, p.clip);
  } else {
    g = O::mul(g0, p.rescale);
    if (flags & kClip) g = clip(g, -p.clip, p.clip);
  }
  if (MODE == kSgd) {
    w = O::sub(w, O::mul(p.lr, O::add(g, O::mul(p.wd, w))));
  } else if (MODE == kSgdMom) {
    s0 = O::sub(O::mul(p.a, s0), O::mul(p.lr, O::add(g, O::mul(p.wd, w))));
    w = O::add(w, s0);
  } else if (MODE == kNagMom) {
    g = O::add(g, O::mul(p.wd, w));
    s0 = O::add(O::mul(p.a, s0), g);
    w = O::sub(w, O::mul(p.lr, O::add(g, O::mul(p.a, s0))));
  } else if (MODE == kSignSgd) {
    w = O::sub(w, O::mul(p.lr, O::add(sign(g), O::mul(p.wd, w))));
  } else if (MODE == kSignum) {  // p0: 1 - lr * wd_lh, p1: lr * wd
    s0 = O::sub(O::mul(p.a, s0), O::mul(p.b, g));
    w = O::sub(O::add(O::mul(p.p0, w), O::mul(p.lr, sign(s0))),
               O::mul(p.p1, w));
  } else if (MODE == kAdam) {
    g = O::add(g, O::mul(p.wd, w));
    s0 = O::add(O::mul(p.a, s0), O::mul(p.b, g));
    s1 = O::add(O::mul(p.c, s1), O::mul(p.d, O::mul(g, g)));
    w = O::sub(w, O::div(O::mul(p.lr, s0), O::add(O::sqrt(s1), p.e)));
  } else if (MODE == kAdaGrad) {
    s0 = O::add(s0, O::mul(g, g));
    const float div = O::div(g, O::add(O::sqrt(s0), p.a));
    w = O::sub(w, O::mul(p.lr, O::add(div, O::mul(w, p.wd))));
  } else if (MODE == kRmsProp) {  // a gamma1, b 1 - gamma1, c epsilon
    g = O::add(g, O::mul(p.wd, w));
    s0 = O::add(O::mul(p.a, s0), O::mul(p.b, O::mul(g, g)));
    w = O::sub(w, O::div(O::mul(p.lr, g), O::sqrt(O::add(s0, p.c))));
    if (flags & kClipWeights) w = clip(w, -p.clip_w, p.clip_w);
  } else if (MODE == kRmsPropAlex) {  // ..., d gamma2
    g = O::add(g, O::mul(p.wd, w));
    s0 = O::add(O::mul(p.a, s0), O::mul(p.b, O::mul(g, g)));
    s1 = O::add(O::mul(p.a, s1), O::mul(p.b, g));
    s2 = O::sub(O::mul(p.d, s2),
                O::div(O::mul(p.lr, g),
                       O::sqrt(O::add(O::sub(s0, O::mul(s1, s1)), p.c))));
    w = O::add(w, s2);
    if (flags & kClipWeights) w = clip(w, -p.clip_w, p.clip_w);
  } else if (MODE == kAdaDelta) {  // a rho, b 1 - rho, c epsilon
    s0 = O::add(O::mul(p.a, s0), O::mul(O::mul(p.b, g), g));
    const float cd = O::mul(
        O::div(O::sqrt(O::add(s1, p.c)), O::sqrt(O::add(s0, p.c))), g);
    s1 = O::add(O::mul(p.a, s1), O::mul(O::mul(p.b, cd), cd));
    w = O::sub(O::sub(w, cd), O::mul(p.wd, w));
  } else if (MODE == kFtrl) {  // s0 z, s1 n; a lamda1, b beta
    const float n_new = O::add(s1, O::mul(g, g));
    const float sq = O::sqrt(n_new);
    const float sigma = O::div(O::sub(sq, O::sqrt(s1)), p.lr);
    s0 = O::sub(O::add(s0, g), O::mul(sigma, w));
    s1 = n_new;
    w = fabsf(s0) <= p.a
            ? 0.f
            : O::div(-O::sub(s0, O::mul(sign(s0), p.a)),
                     O::add(O::div(O::add(p.b, sq), p.lr), p.wd));
  } else if (MODE == kFtml) {  // s0 d, s1 v, s2 z; p0 d_coef, p1 v_coef
    g = O::add(g, O::mul(p.wd, w));
    s1 = O::add(O::mul(p.c, s1), O::mul(p.d, O::mul(g, g)));
    const float d_new =
        O::mul(p.p0, O::add(O::sqrt(O::div(s1, p.p1)), p.e));
    const float sigma = O::sub(d_new, O::mul(p.a, s0));
    s2 = O::sub(O::add(O::mul(p.a, s2), O::mul(p.b, g)), O::mul(sigma, w));
    s0 = d_new;
    w = O::div(-s2, d_new);
  } else if (MODE == kAdamax) {  // a beta1, b 1 - beta1, c beta2
    s0 = O::add(O::mul(p.a, s0), O::mul(p.b, g));
    s1 = maximum(O::mul(p.c, s1), fabsf(g));
    w = O::sub(w, O::div(O::mul(p.lr, s0), s1));
  }
}

// V values from p[e..e+V) as floats, and back; 16-byte accesses
template <typename S, int V>
__device__ __forceinline__ void load(const S* p, long long e, float* out) {
  constexpr int per = 16 / sizeof(S);
#pragma unroll
  for (int k = 0; k < V / per; ++k) {
    const uint4 raw = reinterpret_cast<const uint4*>(p + e)[k];
    const S* s = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int j = 0; j < per; ++j) out[k * per + j] = to_float(s[j]);
  }
}
template <typename S, int V>
__device__ __forceinline__ void store(S* p, long long e, const float* in) {
  constexpr int per = 16 / sizeof(S);
#pragma unroll
  for (int k = 0; k < V / per; ++k) {
    uint4 raw;
    S* s = reinterpret_cast<S*>(&raw);
#pragma unroll
    for (int j = 0; j < per; ++j) s[j] = to_type<S>(in[k * per + j]);
    reinterpret_cast<uint4*>(p + e)[k] = raw;
  }
}

// chunk [start, end) of one tensor whose weight and gradient are T: the
// states are T (or float32 with MASTER, beside the float32 master copy,
// from which the weight is written; the weight is not read)
template <int MODE, typename T, bool MASTER>
__device__ __forceinline__ void run(const TensorEntry& t, const Shared& sh,
                                    int flags, long long start,
                                    long long end) {
  using S = typename std::conditional<MASTER, float, T>::type;
  constexpr int NS = n_states(MODE);
  constexpr int V = 16 / sizeof(T);  // values a 16-byte access of T
  const Hyper p = hyper<S>(sh, t);
  T* __restrict__ w = static_cast<T*>(t.w);
  const T* __restrict__ g = static_cast<const T*>(t.g);
  S* __restrict__ s0 = static_cast<S*>(t.s0);
  S* __restrict__ s1 = static_cast<S*>(t.s1);
  S* __restrict__ s2 = static_cast<S*>(t.s2);
  float* __restrict__ m = t.w32;

  long long i = start;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(s0) | reinterpret_cast<uintptr_t>(s1) |
        reinterpret_cast<uintptr_t>(s2) | reinterpret_cast<uintptr_t>(m)) &
       15) == 0;
  if (aligned) {  // start is a multiple of 8: every access is aligned
    const long long nv = (end - start) / V;
    for (long long k = threadIdx.x; k < nv; k += kThreads) {
      const long long e = start + V * k;
      float wv[V], gv[V], a[V], b[V], c[V];
      load<T, V>(g, e, gv);
      if (MASTER) load<float, V>(m, e, wv); else load<T, V>(w, e, wv);
      if (NS > 0) load<S, V>(s0, e, a);
      if (NS > 1) load<S, V>(s1, e, b);
      if (NS > 2) load<S, V>(s2, e, c);
#pragma unroll
      for (int j = 0; j < V; ++j)
        rule<MODE, S>(wv[j], gv[j], a[j], b[j], c[j], p, flags);
      store<T, V>(w, e, wv);
      if (MASTER) store<float, V>(m, e, wv);
      if (NS > 0) store<S, V>(s0, e, a);
      if (NS > 1) store<S, V>(s1, e, b);
      if (NS > 2) store<S, V>(s2, e, c);
    }
    i = start + V * nv;  // the ragged tail, one value a thread
  }
  for (long long e = i + threadIdx.x; e < end; e += kThreads) {
    float wv = MASTER ? m[e] : to_float(w[e]);
    float a = 0.f, b = 0.f, c = 0.f;
    if (NS > 0) a = to_float(s0[e]);
    if (NS > 1) b = to_float(s1[e]);
    if (NS > 2) c = to_float(s2[e]);
    rule<MODE, S>(wv, to_float(g[e]), a, b, c, p, flags);
    w[e] = to_type<T>(wv);
    if (MASTER) m[e] = wv;
    if (NS > 0) s0[e] = to_type<S>(a);
    if (NS > 1) s1[e] = to_type<S>(b);
    if (NS > 2) s2[e] = to_type<S>(c);
  }
}

// One block per (tensor, chunk); chunk elements a block, a multiple of 8.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    fused_update_kernel(const Shared* __restrict__ shared,
                        const TensorEntry* __restrict__ tensors,
                        const int* __restrict__ first, int n_tensors,
                        int chunk, int flags) {
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
  switch (t.kind) {  // uniform across the block
    case kF32: run<MODE, float, false>(t, h, flags, start, end); break;
    case kBf16: run<MODE, __nv_bfloat16, false>(t, h, flags, start, end);
      break;
    case kF16: run<MODE, __half, false>(t, h, flags, start, end); break;
    case kMaster + kF16: run<MODE, __half, true>(t, h, flags, start, end);
      break;
    default:
      // a master beside a float32 or bf16 weight: only the mp_sgd ops
      // (SGD, SGD with momentum) give one; fused_update.py refuses the rest
      if constexpr (MODE == kSgd || MODE == kSgdMom) {
        if (t.kind == kMaster + kF32)
          run<MODE, float, true>(t, h, flags, start, end);
        else if (t.kind == kMaster + kBf16)
          run<MODE, __nv_bfloat16, true>(t, h, flags, start, end);
      }
      break;
  }
}

template <int MODE>
cudaError_t launch(const unsigned char* table, int n_tensors, int n_blocks,
                   int chunk, int flags, cudaStream_t stream) {
  const auto* shared = reinterpret_cast<const Shared*>(table);
  const auto* tensors =
      reinterpret_cast<const TensorEntry*>(table + sizeof(Shared));
  const auto* first = reinterpret_cast<const int*>(
      table + sizeof(Shared) + sizeof(TensorEntry) * n_tensors);
  fused_update_kernel<MODE><<<n_blocks, kThreads, 0, stream>>>(
      shared, tensors, first, n_tensors, chunk, flags);
  return cudaGetLastError();
}

}  // namespace

// mode: Mode above; flags: 1 clip the gradient, 2 clip the weights.
// table: Shared, n_tensors TensorEntry, n_tensors + 1 int (block prefix;
// the last is n_blocks), on the card.
extern "C" int fused_update(int mode, int flags, const void* table,
                            int n_tensors, int n_blocks, int chunk,
                            void* stream) {
  static_assert(sizeof(Shared) == 64 && sizeof(TensorEntry) == 80,
                "table layout shared with fused_update.py");
  if (n_tensors <= 0 || n_blocks <= 0 || chunk <= 0 || chunk % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const unsigned char*>(table);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define MXT_MODE(M) \
  case M: return static_cast<int>(launch<M>(t, n_tensors, n_blocks, chunk, flags, s));
    MXT_MODE(kSgd) MXT_MODE(kSgdMom) MXT_MODE(kAdam) MXT_MODE(kNagMom)
    MXT_MODE(kSignSgd) MXT_MODE(kSignum) MXT_MODE(kAdaGrad)
    MXT_MODE(kRmsProp) MXT_MODE(kRmsPropAlex) MXT_MODE(kAdaDelta)
    MXT_MODE(kFtrl) MXT_MODE(kFtml) MXT_MODE(kAdamax) MXT_MODE(kTest)
#undef MXT_MODE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
