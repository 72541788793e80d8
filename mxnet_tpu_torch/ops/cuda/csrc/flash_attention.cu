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
//   q, k, v, o   (b * heads, s, head_dim)   T
//   lse          (b * heads, s)             float32
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
// Design, bfloat16: one CTA of 4 warps per (64-row q tile, b * head);
// each warp owns 16 query rows and keeps their q fragments, the running
// max/sum and the 16 x head_dim float32 output in registers. Per 64-key
// tile the CTA stages k row-major and v transposed in shared memory
// (16-byte loads, rows padded by 8 bf16 so fragment loads hit distinct
// banks); S = q k^T and o += p v run as mma.sync m16n8k16 bf16 products
// with float32 sums, and p goes from the S accumulators to the next A
// fragment in registers (rounded to bf16, as the tensor cores take it).
// Causal CTAs are issued last-q-tile first so the longest ones start
// first. No cp.async/TMA pipelining and no wgmma yet: later work.
//
// Design, float32 (the exact reference path; the tensor cores have no
// full-precision float32 product): one CTA per (16-row q tile, b *
// head), scalar FMAs over tiles staged in shared memory, as in
// flash_prefill_paged.cu.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// -------------------------------------------------------------------------
// bfloat16: tensor cores
// -------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per CTA
constexpr int kBK = 64;           // keys per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int s, int causal,
                      float sm_scale) {
  constexpr int LD = D + 8;      // row stride of q/k tiles
  constexpr int LDT = kBK + 8;   // row stride of the transposed v tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // kBK x LD (q staging)
  bf16* vt_s = k_s + kBK * LD;                    // D x LDT

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * s;
  const int q_start = qi * kBQ;
  const int row0 = q_start + warp * 16 + g;  // and row0 + 8

  // q fragments of this warp's 16 rows, staged through k_s
  mxt::stage_tile<kBQ, D, kThreads>(k_s, LD, nullptr, 0, q + base * D, q_start,
      s);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mxt::ld_a_frag(qf[kk], k_s, LD, warp * 16, kk * 16, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {mxt::kNegInf, mxt::kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  const int k_end = causal ? min(s, q_start + kBQ) : s;
  for (int k_start = 0; k_start < k_end; k_start += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    mxt::stage_tile<kBK, D, kThreads>(k_s, LD, nullptr, 0, k + base * D,
        k_start, s);
    mxt::stage_tile<kBK, D, kThreads>(nullptr, 0, vt_s, LDT, v + base * D,
        k_start, s);
    __syncthreads();

    // S = q k^T for 16 rows x kBK keys
    float sc[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        mxt::ld_bt_frag(b0, b1, k_s, LD, j * 8, kk * 16, lane);
        mxt::mma_bf16(sc[j], qf[kk], b0, b1);
      }
    }

    // scale, mask, online softmax (rows row0 and row0 + 8)
    float mx[2] = {mxt::kNegInf, mxt::kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k_start + j * 8 + 2 * c + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool ok = col < s && (!causal || col <= row);
        const float x = ok ? sc[j][e] * sm_scale : mxt::kNegInf;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - m[e >> 1]);
        sc[j][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // o += p v
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      mxt::c_to_a_frag(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        mxt::ld_bt_frag(b0, b1, vt_s, LDT, j * 8, kk * 16, lane);
        mxt::mma_bf16(acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const int row = row0 + h * 8;
    if (row < s) {
      const float inv = 1.f / l_safe;
      bf16* orow = o + (base + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * c) =
            mxt::pack_bf16(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
      if (c == 0) lse[base + row] = m[h] + logf(l_safe);
    }
  }
}

// -------------------------------------------------------------------------
// float32: CUDA cores
// -------------------------------------------------------------------------

constexpr int kBQf = 16;
constexpr int kBKf = 16;

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int s, int hd, int causal,
                     float sm_scale) {
  extern __shared__ float smem[];
  const int qi = gridDim.x - 1 - blockIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * s;
  const int q_start = qi * kBQf;
  const int q_rows = min(kBQf, s - q_start);
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
    q_s[i] = r < q_rows ? q[(base + q_start) * hd + i] * sm_scale : 0.f;
    acc[i] = 0.f;
  }
  for (int i = tid; i < kBQf; i += kThreads) {
    m_s[i] = mxt::kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int k_end = causal ? min(s, q_start + kBQf) : s;
  for (int k_start = 0; k_start < k_end; k_start += kBKf) {
    const int k_rows = min(kBKf, s - k_start);
    for (int i = tid; i < kBKf * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      const bool in = t < k_rows;
      k_s[t * hdp + d] = in ? k[(base + k_start) * hd + i] : 0.f;
      v_s[i] = in ? v[(base + k_start) * hd + i] : 0.f;
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
      const bool ok = kpos < s && (!causal || kpos <= q_start + r);
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
    o[(base + q_start) * hd + i] = acc[i] / (l == 0.f ? 1.f : l);
  }
  for (int r = tid; r < q_rows; r += kThreads) {
    const float l = l_s[r];
    lse[base + q_start + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int s, int causal, float sm_scale,
                cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (kBK * (D + 8) + D * (kBK + 8));
  cudaError_t err = mxt::allow_smem(flash_fwd_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), s, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes; each returns the cudaError_t of the
// launch (0 = launched). head_dim must be 32 or 64 (the wrapper checks).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int s, int hd, int causal, float sm_scale,
                                   void* stream) {
  const size_t smem =
      sizeof(float) * (2 * kBQf * hd + kBKf * (2 * hd + 1) + kBQf * kBKf +
                       3 * kBQf);
  cudaError_t err = mxt::allow_smem(flash_fwd_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQf - 1) / kBQf, bh);
  flash_fwd_f32_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), s, hd, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
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
