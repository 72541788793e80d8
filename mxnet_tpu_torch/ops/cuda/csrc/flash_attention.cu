// Flash attention forward for Hopper (sm_90a).
//
// Replaces mxnet_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (launched by `_flash_fwd`, entry `flash_attention`): causal or full
// attention softmax(q k^T * sm_scale) v with an online softmax over key
// tiles, keys at or past s masked, key tiles above the causal diagonal
// skipped. Writes o in the inputs' type and the row log-sum-exp
// lse = m + log(l) in float32, which the backward recomputes from.
//
// Layouts (all contiguous):
//   q, o         (b * heads, s_q, head_dim)   T
//   k, v         (b * heads, s_k, head_dim)   T
//   lse          (b * heads, s_q)             float32
// Causal means key kpos is visible to query qpos when kpos <= qpos, both
// counted from 0, whatever s_q and s_k are (the TPU kernel's rule).
//
// Semantics kept from the TPU kernel: masked scores are -1e30 (finite,
// so exp underflows to 0 without inf - inf); the running max starts at
// -1e30 and alpha = exp(m_prev - m_new) is applied literally; a row with
// l == 0 divides by 1; the score scale multiplies in float32. Where it
// multiplies differs by dtype: the float32 kernel scales q before the
// dot, as the Pallas kernel does; the bfloat16 kernel keeps q in bf16
// for the tensor cores and scales the float32 product, as the XLA twin
// `_flash_fwd_xla` does. Both orders are float32 roundings of the same
// value: equal for a power-of-two scale (head_dim 64), about one float32
// ulp apart otherwise (head_dim 32), far below the bf16 rounding of p.
// (Scaling q in bf16 instead would add a bf16 rounding.)
//
// Bound: at the training shape (8 x 16 heads, s 1024, head_dim 64,
// causal) the call does 4 * head_dim flops per visible (query, key)
// pair, 17.2 GFLOP (17 us at 989 TFLOP/s), and must move 67 MB of bf16
// q/k/v/o plus the lse (20 us at 3.35 TB/s): the two bounds are close,
// memory slightly ahead.
//
// Design, bfloat16 (wgmma fed by a TMA ring): one CTA of 288 threads
// per (128-row q tile, b * head), two consumer warpgroups of 64 query
// rows each and one producer warp. The producer's one thread loads the
// q tile and then 64-key k and v tiles into a three-stage ring in
// shared memory by TMA (3-D tensor maps over (b * heads, s, head_dim):
// keys and rows past s read as zeros, never the next head's; 128-byte
// swizzle for head_dim 64, 64-byte for 32), each stage guarded by a
// full and an empty mbarrier, so later tiles load while this one
// computes. Each consumer warpgroup runs S = q k^T as wgmma m64n64k16
// with both operands read from shared memory (K-major), keeps the
// online softmax in registers, rounds p to bf16 in registers as the A
// operand of o += p v (wgmma m64n{head_dim}k16, v read MN-major through
// the transpose bit: nothing is transposed by hand), and keeps the
// 64 x head_dim float32 o in registers. Two CTAs share an SM (64 KB of
// shared memory each at head_dim 64; at most 112 registers a thread:
// ptxas gives 94, and 83 at head_dim 32, no spills), so one warpgroup's
// softmax overlaps another's products. Only the causal diagonal and a
// key tile past s mask; tiles above the diagonal are not loaded;
// causal CTAs are issued last-q-tile first, across all heads, so the
// longest start first. o and lse are stored from registers. exp is
// ex2.approx of x * log2(e) (relative error ~2^-22, far below the bf16
// rounding of p).
//
// Two routes, picked by the wrapper before the launch:
// "wgmma" (bfloat16, s_q == s_k, head_dim 32 or 64, 16-byte aligned
// storage) is the design above; "fma" takes every other call the TPU
// kernel takes: float32 (the exact reference path; the tensor cores
// have no full-precision float32 product), and bfloat16 at s_q != s_k or
// another head_dim up to 256. One CTA per (16-row q tile, b * head),
// scalar FMAs in float32 over tiles staged in shared memory (inputs
// widened on load, q scaled in float32 before the dot as the Pallas
// kernel does, o rounded once at the store), as in
// flash_prefill_paged.cu. Its shared memory grows with head_dim (67 KB
// at 256, within the 227 KB a CTA may take); it runs at CUDA-core
// rate, far from the bf16 bound: a simple route that is right.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// -------------------------------------------------------------------------
// bfloat16: tensor cores
// -------------------------------------------------------------------------

namespace sm90 = mxt::sm90;

constexpr int kBM = 128;          // query rows per CTA (two warpgroups)
constexpr int kBN = 64;           // keys per tile
constexpr int kStages = 3;        // k/v ring depth
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kFwdThreads = kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t fwd_smem() {
  return size_t(D) * 2 * (kBM + 2 * kStages * kBN) + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, float* __restrict__ lse, int s,
                      int causal, float sm_scale) {
  using Sw = sm90::Swz<D>;
  constexpr uint32_t kTile = kBN * D * 2;  // bytes of a k or v tile
  constexpr uint32_t kQTile = kBM * D * 2;  // bytes of the q tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::align_smem(smem_raw);
  unsigned char* q_s = sm;
  unsigned char* kv_s = sm + kQTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + kTile * 2 * kStages);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;  // longest causal CTAs first
  const int q_start = qi * kBM;
  const int n_kv = (s + kBN - 1) / kBN;
  const int n_tiles = causal ? min(n_kv, (q_start + kBM) / kBN) : n_kv;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread issues every load
    if (threadIdx.x == kConsumers) {
      sm90::mbar_expect_tx(q_full, kQTile);
      sm90::tma_load_3d(q_s, &tq, q_full, 0, q_start, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        sm90::mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], 2 * kTile);
        unsigned char* k_dst = kv_s + st * 2 * kTile;
        sm90::tma_load_3d(k_dst, &tk, &full[st], 0, t * kBN, bh);
        sm90::tma_load_3d(k_dst + kTile, &tv, &full[st], 0, t * kBN, bh);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = q_start + wg * 64 + warp * 16 + g;  // and row0 + 8
  const uint32_t q_tile = sm90::smem_u32(q_s) + wg * 64 * Sw::kRowBytes;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {mxt::kNegInf, mxt::kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  sm90::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    sm90::mbar_wait(&full[st], (t / kStages) & 1);
    const uint32_t k_tile = sm90::smem_u32(kv_s + st * 2 * kTile);
    const uint32_t v_tile = k_tile + kTile;

    // S = q k^T: 64 rows x kBN keys
    float sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64<0>(sc, Sw::kmajor(q_tile, kk),
                            Sw::kmajor(k_tile, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // scale, mask (the tiles that reach the diagonal or past s only),
    // online softmax over rows row0 and row0 + 8
    const int k_start = t * kBN;
    const bool edge =
        (causal && k_start + kBN > q_start) || k_start + kBN > s;
    float mx[2] = {mxt::kNegInf, mxt::kNegInf};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      float x = sc[i] * sm_scale;
      if (edge) {
        const int col = k_start + 8 * (i >> 2) + 2 * c + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (col >= s || (causal && col > row)) x = mxt::kNegInf;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = sm90::ex2((m[h] - m_new) * kLog2e);
      m[h] = m_new;
      mb[h] = m_new * kLog2e;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float p = sm90::ex2(fmaf(sc[i], kLog2e, -mb[h]));
      sc[i] = p;
      sum[h] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // o += p v, p rounded to bf16 in registers
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) sm90::acc_to_a(pa[kk], sc, kk);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      if constexpr (D == 64)
        sm90::wgmma_rs_n64<1>(acc, pa[kk], Sw::mnmajor(v_tile, kk), 1);
      else
        sm90::wgmma_rs_n32<1>(acc, pa[kk], Sw::mnmajor(v_tile, kk), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const int row = row0 + h * 8;
    if (row < s) {
      const float inv = 1.f / l_safe;
      bf16* orow = o + (static_cast<size_t>(bh) * s + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * c) =
            sm90::pack_bf16(acc[4 * j + 2 * h] * inv,
                            acc[4 * j + 2 * h + 1] * inv);
      if (c == 0) lse[static_cast<size_t>(bh) * s + row] =
          m[h] + logf(l_safe);
    }
  }
}

// -------------------------------------------------------------------------
// the "fma" route: float32, and bfloat16 outside the wgmma route
// -------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBQf = 16;
constexpr int kBKf = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int s_q, int s_k, int hd,
                     int causal, float sm_scale) {
  extern __shared__ float smem[];
  const int qi = gridDim.x - 1 - blockIdx.x;
  const size_t qbase = static_cast<size_t>(blockIdx.y) * s_q;
  const size_t kbase = static_cast<size_t>(blockIdx.y) * s_k;
  const int q_start = qi * kBQf;
  const int q_rows = min(kBQf, s_q - q_start);
  const int hdp = hd + 1;  // padded k row
  const int tid = threadIdx.x;

  float* q_s = smem;               // kBQf * hd, pre-scaled
  float* k_s = q_s + kBQf * hd;    // kBKf * hdp
  float* v_s = k_s + kBKf * hdp;   // kBKf * hd
  float* p_s = v_s + kBKf * hd;    // kBQf * kBKf
  float* acc = p_s + kBQf * kBKf;  // kBQf * hd
  float* m_s = acc + kBQf * hd;    // kBQf
  float* l_s = m_s + kBQf;         // kBQf
  float* a_s = l_s + kBQf;         // kBQf

  for (int i = tid; i < kBQf * hd; i += kThreads) {
    const int r = i / hd;
    q_s[i] = r < q_rows
                 ? mxt::to_f32(q[(qbase + q_start) * hd + i]) * sm_scale
                 : 0.f;
    acc[i] = 0.f;
  }
  for (int i = tid; i < kBQf; i += kThreads) {
    m_s[i] = mxt::kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  // causal: key kpos is visible to query qpos when kpos <= qpos, both
  // counted from 0 whatever s_q and s_k are
  const int k_end = causal ? min(s_k, q_start + kBQf) : s_k;
  for (int k_start = 0; k_start < k_end; k_start += kBKf) {
    const int k_rows = min(kBKf, s_k - k_start);
    for (int i = tid; i < kBKf * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      const bool in = t < k_rows;
      k_s[t * hdp + d] =
          in ? mxt::to_f32(k[(kbase + k_start) * hd + i]) : 0.f;
      v_s[i] = in ? mxt::to_f32(v[(kbase + k_start) * hd + i]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < kBQf * kBKf; i += kThreads) {
      const int r = i / kBKf;
      const int t = i - r * kBKf;
      const int kpos = k_start + t;
      const float* qv = q_s + r * hd;
      const float* kv = k_s + t * hdp;
      float sc = 0.f;
      for (int d = 0; d < hd; ++d) sc = fmaf(qv[d], kv[d], sc);
      const bool ok = kpos < s_k && (!causal || kpos <= q_start + r);
      p_s[i] = ok ? sc : mxt::kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < kBQf; r += kThreads) {
      float* pr = p_s + r * kBKf;
      float mx = mxt::kNegInf;
      for (int t = 0; t < kBKf; ++t) mx = fmaxf(mx, pr[t]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < kBKf; ++t) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < kBQf * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      const float* pr = p_s + r * kBKf;
      float pv = 0.f;
      for (int t = 0; t < kBKf; ++t) pv = fmaf(pr[t], v_s[t * hd + d], pv);
      acc[i] = acc[i] * a_s[r] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < q_rows * hd; i += kThreads) {
    const float l = l_s[i / hd];
    o[(qbase + q_start) * hd + i] =
        mxt::from_f32<T>(acc[i] / (l == 0.f ? 1.f : l));
  }
  for (int r = tid; r < q_rows; r += kThreads) {
    const float l = l_s[r];
    lse[qbase + q_start + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
  }
}

template <typename T>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int s_q, int s_k, int hd, int causal,
               float sm_scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kBQf * hd + kBKf * (2 * hd + 1) + kBQf * kBKf +
                       3 * kBQf);
  cudaError_t err = mxt::allow_smem(flash_fwd_fma_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_q + kBQf - 1) / kBQf, bh);
  flash_fwd_fma_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s_q, s_k, hd, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int s, int causal, float sm_scale,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!sm90::map_rows<D>(&tq, q, bh, s, kBM) ||
      !sm90::map_rows<D>(&tk, k, bh, s, kBN) ||
      !sm90::map_rows<D>(&tv, v, bh, s, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem<D>();
  cudaError_t err = mxt::allow_smem(flash_fwd_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s + kBM - 1) / kBM);
  flash_fwd_bf16_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), s, causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes; each returns the cudaError_t of the
// launch (0 = launched). flash_attention_bf16 is the "wgmma" route:
// s_q == s_k == s and head_dim 32 or 64 (the wrapper picks the route).
// flash_attention_fma_{f32,bf16} is the "fma" route: q (b * heads, s_q,
// hd), k and v (b * heads, s_k, hd), any head_dim up to 256.
extern "C" int flash_attention_fma_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int bh, int s_q, int s_k, int hd,
                                       int causal, float sm_scale,
                                       void* stream) {
  return launch_fma<float>(q, k, v, o, lse, bh, s_q, s_k, hd, causal,
                           sm_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_fma_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int s_q, int s_k, int hd,
                                        int causal, float sm_scale,
                                        void* stream) {
  return launch_fma<bf16>(q, k, v, o, lse, bh, s_q, s_k, hd, causal,
                          sm_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int bh,
                                    int s, int hd, int causal, float sm_scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_bf16<64>(q, k, v, o, lse, bh, s, causal,
                                       sm_scale, st);
  if (hd == 32) return launch_bf16<32>(q, k, v, o, lse, bh, s, causal,
                                       sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
