// Flash attention backward for Hopper (sm_90a), FlashAttention-2 style.
//
// Replaces the backward of mxnet_tpu/ops/pallas/flash_attention.py
// `flash_attention` (`_flash_bwd`, a lax.scan over key blocks that XLA
// fuses; on a ring of one device mxnet_tpu/parallel/ring_attention.py
// `_ring_flash_bwd_impl` computes the same): the TPU had no Pallas
// kernel for it. From the forward's saved o and row lse:
//   delta = rowsum(o * do)                (o in its own type, in f32)
//   p     = exp(s * sm_scale - lse), 0 where masked
//   dv    = p^T do
//   ds    = p * (do v^T - delta)
//   dk    = ds^T (q * sm_scale)
//   dq    = (ds k) * sm_scale
// Gradients are written in the inputs' type. Deterministic: every output
// element is summed by one thread in a fixed order, no atomics.
//
// Layouts (all contiguous): q, k, v, o, do, dq, dk, dv (b * heads, s,
// head_dim) T; lse (b * heads, s) float32; delta (b * heads, s) float32
// scratch the wrapper allocates.
//
// Three launches on the caller's stream: the delta pre-pass, then one
// CTA per (64-key tile, b * head) that walks the q tiles from the
// causal diagonal down and keeps dk/dv for its 64 keys in registers,
// then one CTA per (64-row q tile, b * head) that walks the key tiles up
// to the diagonal and keeps dq in registers. Both recompute p from lse.
//
// Bound: at the training shape (8 x 16 heads, s 1024, head_dim 64,
// causal) the five products do 10 * head_dim flops per visible (query,
// key) pair, 43 GFLOP (43 us at 989 TFLOP/s), against 134 MB of bf16
// q/k/v/o/do read and dq/dk/dv written (40 us at 3.35 TB/s): the tensor
// cores bound it, narrowly.
//
// Design, bfloat16: 4 warps, 16 keys (or 16 query rows) each, mma.sync
// m16n8k16 bf16 products with float32 sums; the A operands (k and v for
// dk/dv, q and do for dq) stay in registers across the loop, p and ds
// pass from accumulators to A fragments in registers (rounded to bf16),
// and the B operands that are needed transposed (q and do for dk/dv, k
// for dq) are staged transposed in shared memory. No cp.async/TMA
// pipelining and no wgmma yet: later work.
//
// Design, float32: the same three passes with scalar FMAs over 16 x 16
// tiles in shared memory, the exact reference path.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per tile
constexpr int kBK = 16 * kWarps;  // keys per tile (== kBQ: the causal
                                  // diagonal falls on tile boundaries)

// delta[r] = sum_d o[r, d] * do[r, d]; one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int hd) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * hd;
  const T* drow = dout + static_cast<size_t>(row) * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(mxt::to_f32(orow[d]), mxt::to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// -------------------------------------------------------------------------
// bfloat16: tensor cores
// -------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int s, int causal, float sm_scale) {
  constexpr int LD = D + 8;     // q / do tiles, row-major
  constexpr int LDT = kBQ + 8;  // q / do tiles, transposed
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // kBQ x LD
  bf16* do_s = q_s + kBQ * LD;                    // kBQ x LD
  bf16* qt_s = do_s + kBQ * LD;                   // D x LDT
  bf16* dot_s = qt_s + D * LDT;                   // D x LDT
  float* lse_s = reinterpret_cast<float*>(dot_s + D * LDT);  // kBQ
  float* dl_s = lse_s + kBQ;                                  // kBQ

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int kt = blockIdx.x;  // causal: tile 0 has the most work, first
  const size_t base = static_cast<size_t>(blockIdx.y) * s;
  const int k_start = kt * kBK;
  const int key0 = k_start + warp * 16 + g;  // and key0 + 8

  // this warp's k and v rows as A fragments, staged through q_s / do_s
  mxt::stage_tile<kBK, D, kThreads>(q_s, LD, nullptr, 0, k + base * D, k_start,
      s);
  mxt::stage_tile<kBK, D, kThreads>(do_s, LD, nullptr, 0, v + base * D, k_start,
      s);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    mxt::ld_a_frag(kf[kk], q_s, LD, warp * 16, kk * 16, lane);
    mxt::ld_a_frag(vf[kk], do_s, LD, warp * 16, kk * 16, lane);
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int q_start = causal ? k_start : 0; q_start < s; q_start += kBQ) {
    __syncthreads();  // every warp is done with the previous q tile
    mxt::stage_tile<kBQ, D, kThreads>(q_s, LD, qt_s, LDT, q + base * D, q_start,
        s);
    mxt::stage_tile<kBQ, D, kThreads>(do_s, LD, dot_s, LDT, dout + base * D,
        q_start, s);
    for (int i = threadIdx.x; i < kBQ; i += kThreads) {
      const bool in = q_start + i < s;
      lse_s[i] = in ? lse[base + q_start + i] : 0.f;
      dl_s[i] = in ? delta[base + q_start + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T: 16 keys x kBQ queries per warp
    float st[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        mxt::ld_bt_frag(b0, b1, q_s, LD, j * 8, kk * 16, lane);
        mxt::mma_bf16(st[j], kf[kk], b0, b1);
        mxt::ld_bt_frag(b0, b1, do_s, LD, j * 8, kk * 16, lane);
        mxt::mma_bf16(dpt[j], vf[kk], b0, b1);
      }
    }

    // p^T and ds^T = p^T * (dp^T - delta)
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * c + (e & 1);
        const int qrow = q_start + ql;
        const int key = key0 + (e >> 1) * 8;
        const bool ok = qrow < s && key < s && (!causal || key <= qrow);
        const float p = ok ? expf(st[j][e] * sm_scale - lse_s[ql]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl_s[ql]);
      }
    }

    // dv += p^T do and dk += ds^T q (the sm_scale of q comes at the end)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t ap[4];
      mxt::c_to_a_frag(ap, st[2 * kk], st[2 * kk + 1]);
      uint32_t ads[4];
      mxt::c_to_a_frag(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        mxt::ld_bt_frag(b0, b1, dot_s, LDT, j * 8, kk * 16, lane);
        mxt::mma_bf16(dv_acc[j], ap, b0, b1);
        mxt::ld_bt_frag(b0, b1, qt_s, LDT, j * 8, kk * 16, lane);
        mxt::mma_bf16(dk_acc[j], ads, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + h * 8;
    if (key >= s) continue;
    bf16* dkrow = dk + (base + key) * D;
    bf16* dvrow = dv + (base + key) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkrow + j * 8 + 2 * c) =
          mxt::pack_bf16(dk_acc[j][2 * h] * sm_scale,
                    dk_acc[j][2 * h + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dvrow + j * 8 + 2 * c) =
          mxt::pack_bf16(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dq, int s,
               int causal, float sm_scale) {
  constexpr int LD = D + 8;     // k / v tiles, row-major
  constexpr int LDT = kBK + 8;  // k tile, transposed
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // kBK x LD (q staging)
  bf16* v_s = k_s + kBK * LD;                     // kBK x LD (do staging)
  bf16* kt_s = v_s + kBK * LD;                    // D x LDT

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int qi = gridDim.x - 1 - blockIdx.x;  // causal: longest first
  const size_t base = static_cast<size_t>(blockIdx.y) * s;
  const int q_start = qi * kBQ;
  const int row0 = q_start + warp * 16 + g;  // and row0 + 8

  mxt::stage_tile<kBQ, D, kThreads>(k_s, LD, nullptr, 0, q + base * D, q_start,
      s);
  mxt::stage_tile<kBQ, D, kThreads>(v_s, LD, nullptr, 0, dout + base * D,
      q_start, s);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    mxt::ld_a_frag(qf[kk], k_s, LD, warp * 16, kk * 16, lane);
    mxt::ld_a_frag(dof[kk], v_s, LD, warp * 16, kk * 16, lane);
  }
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    lse_r[h] = row < s ? lse[base + row] : 0.f;
    dl_r[h] = row < s ? delta[base + row] : 0.f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  const int k_end = causal ? min(s, q_start + kBQ) : s;
  for (int k_start = 0; k_start < k_end; k_start += kBK) {
    __syncthreads();  // every warp is done with the previous key tile
    mxt::stage_tile<kBK, D, kThreads>(k_s, LD, kt_s, LDT, k + base * D, k_start,
        s);
    mxt::stage_tile<kBK, D, kThreads>(v_s, LD, nullptr, 0, v + base * D,
        k_start, s);
    __syncthreads();

    // s = q k^T and dp = do v^T: 16 rows x kBK keys per warp
    float sc[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        mxt::ld_bt_frag(b0, b1, k_s, LD, j * 8, kk * 16, lane);
        mxt::mma_bf16(sc[j], qf[kk], b0, b1);
        mxt::ld_bt_frag(b0, b1, v_s, LD, j * 8, kk * 16, lane);
        mxt::mma_bf16(dp[j], dof[kk], b0, b1);
      }
    }

    // ds = p * (dp - delta), into sc
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k_start + j * 8 + 2 * c + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool ok = col < s && (!causal || col <= row);
        const float p =
            ok ? expf(sc[j][e] * sm_scale - lse_r[e >> 1]) : 0.f;
        sc[j][e] = p * (dp[j][e] - dl_r[e >> 1]);
      }
    }

    // dq += ds k
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      mxt::c_to_a_frag(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        mxt::ld_bt_frag(b0, b1, kt_s, LDT, j * 8, kk * 16, lane);
        mxt::mma_bf16(dq_acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= s) continue;
    bf16* dqrow = dq + (base + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dqrow + j * 8 + 2 * c) =
          mxt::pack_bf16(dq_acc[j][2 * h] * sm_scale,
                    dq_acc[j][2 * h + 1] * sm_scale);
  }
}

// -------------------------------------------------------------------------
// float32: CUDA cores
// -------------------------------------------------------------------------

constexpr int kBf = 16;  // rows and keys per tile

// a 16-row tile of a (rows_total, hd) float matrix into dst (row stride
// ld), times scale; rows past rows_total read as zeros
__device__ __forceinline__ void stage_f32(float* dst, int ld,
                                          const float* src, int row0,
                                          int rows_total, int hd,
                                          float scale) {
  for (int i = threadIdx.x; i < kBf * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    dst[r * ld + d] = row0 + r < rows_total
                          ? src[static_cast<size_t>(row0 + r) * hd + d] * scale
                          : 0.f;
  }
}

__device__ __forceinline__ float dot_f32(const float* a, const float* b,
                                         int hd) {
  float acc = 0.f;
  for (int d = 0; d < hd; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int s, int hd, int causal,
                float sm_scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* k_s = smem;                // kBf * hdp
  float* v_s = k_s + kBf * hdp;     // kBf * hdp
  float* q_s = v_s + kBf * hdp;     // kBf * hdp, pre-scaled
  float* do_s = q_s + kBf * hdp;    // kBf * hdp
  float* p_s = do_s + kBf * hdp;    // kBf x kBf, [key][query]
  float* ds_s = p_s + kBf * kBf;    // kBf x kBf, [key][query]
  float* dk_a = ds_s + kBf * kBf;   // kBf * hd
  float* dv_a = dk_a + kBf * hd;    // kBf * hd
  float* lse_s = dv_a + kBf * hd;   // kBf
  float* dl_s = lse_s + kBf;        // kBf

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * s;
  const int k_start = blockIdx.x * kBf;
  stage_f32(k_s, hdp, k + base * hd, k_start, s, hd, 1.f);
  stage_f32(v_s, hdp, v + base * hd, k_start, s, hd, 1.f);
  for (int i = tid; i < kBf * hd; i += kThreads) dk_a[i] = dv_a[i] = 0.f;

  for (int q_start = causal ? k_start : 0; q_start < s; q_start += kBf) {
    __syncthreads();
    stage_f32(q_s, hdp, q + base * hd, q_start, s, hd, sm_scale);
    stage_f32(do_s, hdp, dout + base * hd, q_start, s, hd, 1.f);
    for (int i = tid; i < kBf; i += kThreads) {
      const bool in = q_start + i < s;
      lse_s[i] = in ? lse[base + q_start + i] : 0.f;
      dl_s[i] = in ? delta[base + q_start + i] : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < kBf * kBf; i += kThreads) {
      const int t = i / kBf;  // key
      const int r = i - t * kBf;  // query
      const int kpos = k_start + t, qpos = q_start + r;
      const bool ok = qpos < s && kpos < s && (!causal || kpos <= qpos);
      const float sc = dot_f32(q_s + r * hdp, k_s + t * hdp, hd);
      const float dp = dot_f32(do_s + r * hdp, v_s + t * hdp, hd);
      const float p = ok ? expf(sc - lse_s[r]) : 0.f;
      p_s[i] = p;
      ds_s[i] = p * (dp - dl_s[r]);
    }
    __syncthreads();

    for (int i = tid; i < kBf * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      float a = 0.f, b = 0.f;
      for (int r = 0; r < kBf; ++r) {
        a = fmaf(p_s[t * kBf + r], do_s[r * hdp + d], a);
        b = fmaf(ds_s[t * kBf + r], q_s[r * hdp + d], b);
      }
      dv_a[i] += a;
      dk_a[i] += b;
    }
  }

  const int k_rows = min(kBf, s - k_start);
  for (int i = tid; i < k_rows * hd; i += kThreads) {
    dk[(base + k_start) * hd + i] = dk_a[i];
    dv[(base + k_start) * hd + i] = dv_a[i];
  }
}

__global__ void __launch_bounds__(kThreads)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int s, int hd, int causal,
              float sm_scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* q_s = smem;                // kBf * hdp, pre-scaled
  float* do_s = q_s + kBf * hdp;    // kBf * hdp
  float* k_s = do_s + kBf * hdp;    // kBf * hdp
  float* v_s = k_s + kBf * hdp;     // kBf * hdp
  float* ds_s = v_s + kBf * hdp;    // kBf x kBf, [query][key]
  float* dq_a = ds_s + kBf * kBf;   // kBf * hd
  float* lse_s = dq_a + kBf * hd;   // kBf
  float* dl_s = lse_s + kBf;        // kBf

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * s;
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBf;
  stage_f32(q_s, hdp, q + base * hd, q_start, s, hd, sm_scale);
  stage_f32(do_s, hdp, dout + base * hd, q_start, s, hd, 1.f);
  for (int i = tid; i < kBf; i += kThreads) {
    const bool in = q_start + i < s;
    lse_s[i] = in ? lse[base + q_start + i] : 0.f;
    dl_s[i] = in ? delta[base + q_start + i] : 0.f;
  }
  for (int i = tid; i < kBf * hd; i += kThreads) dq_a[i] = 0.f;

  const int k_end = causal ? min(s, q_start + kBf) : s;
  for (int k_start = 0; k_start < k_end; k_start += kBf) {
    __syncthreads();
    stage_f32(k_s, hdp, k + base * hd, k_start, s, hd, 1.f);
    stage_f32(v_s, hdp, v + base * hd, k_start, s, hd, 1.f);
    __syncthreads();

    for (int i = tid; i < kBf * kBf; i += kThreads) {
      const int r = i / kBf;  // query
      const int t = i - r * kBf;  // key
      const int kpos = k_start + t, qpos = q_start + r;
      const bool ok = qpos < s && kpos < s && (!causal || kpos <= qpos);
      const float sc = dot_f32(q_s + r * hdp, k_s + t * hdp, hd);
      const float dp = dot_f32(do_s + r * hdp, v_s + t * hdp, hd);
      const float p = ok ? expf(sc - lse_s[r]) : 0.f;
      ds_s[i] = p * (dp - dl_s[r]);
    }
    __syncthreads();

    for (int i = tid; i < kBf * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      float a = 0.f;
      for (int t = 0; t < kBf; ++t)
        a = fmaf(ds_s[r * kBf + t], k_s[t * hdp + d], a);
      dq_a[i] += a;
    }
  }

  const int q_rows = min(kBf, s - q_start);
  for (int i = tid; i < q_rows * hd; i += kThreads)
    dq[(base + q_start) * hd + i] = dq_a[i] * sm_scale;
}

// -------------------------------------------------------------------------
// launches
// -------------------------------------------------------------------------

template <typename T>
int launch_delta(const void* o, const void* dout, void* delta, int rows,
                 int hd, cudaStream_t st) {
  delta_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows, hd);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* dk,
                void* dv, void* delta, int bh, int s, int causal,
                float sm_scale, cudaStream_t st) {
  int err = launch_delta<bf16>(o, dout, delta, bh * s, D, st);
  if (err != 0) return err;
  const size_t smem_kv = sizeof(bf16) * (2 * kBQ * (D + 8) +
                                         2 * D * (kBQ + 8)) +
                         sizeof(float) * 2 * kBQ;
  cudaError_t e = mxt::allow_smem(dkdv_bf16_kernel<D>, smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_k((s + kBK - 1) / kBK, bh);
  dkdv_bf16_kernel<D><<<grid_k, kThreads, smem_kv, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, causal, sm_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t smem_q =
      sizeof(bf16) * (2 * kBK * (D + 8) + D * (kBK + 8));
  e = mxt::allow_smem(dq_bf16_kernel<D>, smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_q((s + kBQ - 1) / kBQ, bh);
  dq_bf16_kernel<D><<<grid_q, kThreads, smem_q, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), s, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes: delta, dk/dv and dq launches on
// `stream`; each returns the first non-zero cudaError_t (0 = all three
// launched). head_dim must be 32 or 64 (the wrapper checks).
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int bh, int s, int hd, int causal, float sm_scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_delta<float>(o, dout, delta, bh * s, hd, st);
  if (err != 0) return err;
  const int hdp = hd + 1;
  const size_t smem_kv =
      sizeof(float) * (4 * kBf * hdp + 2 * kBf * kBf + 2 * kBf * hd +
                       2 * kBf);
  cudaError_t e = mxt::allow_smem(dkdv_f32_kernel, smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s + kBf - 1) / kBf, bh);
  dkdv_f32_kernel<<<grid, kThreads, smem_kv, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), s, hd, causal,
      sm_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t smem_q =
      sizeof(float) * (4 * kBf * hdp + kBf * kBf + kBf * hd + 2 * kBf);
  e = mxt::allow_smem(dq_f32_kernel, smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_f32_kernel<<<grid, kThreads, smem_q, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), s, hd, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int bh, int s, int hd, int causal, float sm_scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_bf16<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, s,
                           causal, sm_scale, st);
  if (hd == 32)
    return launch_bf16<32>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, s,
                           causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
