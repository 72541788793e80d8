// Flash attention backward for Hopper (sm_90a): FlashAttention-2's
// recompute from the row log-sum-exp.
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
// Bound: at the training shape (8 x 16 heads, s 1024, head_dim 64,
// causal) the five products do 10 * head_dim flops per visible (query,
// key) pair, 43 GFLOP (43 us at 989 TFLOP/s), against 134 MB of bf16
// q/k/v/o/do read and dq/dk/dv written (40 us at 3.35 TB/s): the tensor
// cores bound it, narrowly.
//
// Design, bfloat16 (wgmma fed by TMA; deterministic through a separate
// dq pass): two launches, each of CTAs of 160 threads, one consumer
// warpgroup and one producer warp whose one thread loads 64-row tiles
// by TMA (3-D tensor maps over (b * heads, s, head_dim): rows past s
// read as zeros, never the next head's; 128-byte swizzle for head_dim
// 64, 64-byte for 32) through a two-stage ring of full/empty
// mbarriers. Two CTAs share an SM, so one's loads, waits and epilogue
// overlap the other's products.
//   dq pass, one CTA per (64-row q tile, b * head), first: its q, do
//   and o tiles load once; delta = rowsum(o * do) comes from the o and
//   do tiles in shared memory (two threads a row, a fixed order) and is
//   written out for the dk/dv pass; 64-key k and v tiles stream. S =
//   q k^T and dP = do v^T run as wgmma m64n64k16 from shared memory
//   (K-major); ds = p (dP - delta), rounded to bf16 in registers, is the
//   A operand of dq += ds k (wgmma m64n{head_dim}k16, k read MN-major
//   through the transpose bit).
//   dk/dv pass, one CTA per (64-key tile, b * head), walking the q
//   tiles from the causal diagonal down: its k and v tiles load once;
//   q and do tiles with their lse and delta (1-D maps) stream. S^T =
//   k q^T and dP^T = v do^T come out directly (m64n64k16, both operands
//   from shared memory), so p^T and ds^T land in registers where,
//   rounded to bf16, they are the A operands of dv += p^T do and
//   dk += ds^T q (do and q read MN-major).
// The separate dq pass recomputes S and dP (7 products for the 5 that
// are needed) and keeps the gradients deterministic: every output
// element is summed by one thread in a fixed order, no atomics. Only
// the causal diagonal tile and a tile past s mask. exp is ex2.approx of
// x * log2(e) (relative error ~2^-22, far below the bf16 rounding of p
// and ds). Registers (ptxas, sm_90a): dk/dv 160 (head_dim 64) / 128
// (32), dq 138 / 120, no spills.
//
// Design, float32 (the exact reference path): three launches, a delta
// pre-pass, a dk/dv pass over key tiles and a dq pass over q tiles,
// with scalar FMAs over 16 x 16 tiles in shared memory.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // the float32 kernels' CTA

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
// bfloat16: wgmma
// -------------------------------------------------------------------------

namespace sm90 = mxt::sm90;

constexpr int kB = 64;            // rows of every tile (keys or queries):
                                  // the warpgroup's wgmma M
constexpr int kStages = 2;        // depth of the streamed ring
constexpr int kConsumers = 128;   // one consumer warpgroup
constexpr int kBwdThreads = kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t dkdv_smem() {
  return size_t(D) * 2 * (2 * kB + kStages * 2 * kB) +
         kStages * 2 * kB * 4 + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tlse,
                 const __grid_constant__ CUtensorMap tdelta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int s,
                 int causal, float sm_scale) {
  using Sw = sm90::Swz<D>;
  constexpr uint32_t kKV = kB * D * 2;  // bytes of the k (or v) tile
  constexpr uint32_t kQT = kB * D * 2;   // bytes of a q (or do) tile
  constexpr uint32_t kVec = kB * 4;      // bytes of an lse (or delta) tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::align_smem(smem_raw);
  unsigned char* k_s = sm;
  unsigned char* v_s = sm + kKV;
  unsigned char* qdo_s = sm + 2 * kKV;  // stage st: q at 2 st kQT, do after
  float* vec_s = reinterpret_cast<float*>(qdo_s + kStages * 2 * kQT);
  // stage st: lse at vec_s + 2 st kB, delta after
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(vec_s + kStages * 2 * kB);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int k_start = blockIdx.y * kB;  // causal: tile 0 has the most
  const int q_lo = causal ? k_start : 0;
  const int n_tiles = (s - q_lo + kB - 1) / kB;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
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
      sm90::mbar_expect_tx(kv_full, 2 * kKV);
      sm90::tma_load_3d(k_s, &tk, kv_full, 0, k_start, bh);
      sm90::tma_load_3d(v_s, &tv, kv_full, 0, k_start, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const int q0 = q_lo + t * kB;
        sm90::mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], 2 * kQT + 2 * kVec);
        unsigned char* q_dst = qdo_s + st * 2 * kQT;
        sm90::tma_load_3d(q_dst, &tq, &full[st], 0, q0, bh);
        sm90::tma_load_3d(q_dst + kQT, &tdo, &full[st], 0, q0, bh);
        float* v_dst = vec_s + st * 2 * kB;
        sm90::tma_load_1d(v_dst, &tlse, &full[st], bh * s + q0);
        sm90::tma_load_1d(v_dst + kB, &tdelta, &full[st], bh * s + q0);
      }
    }
  } else {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    const int key0 = k_start + warp * 16 + g;  // and key0 + 8
    const uint32_t k_tile = sm90::smem_u32(k_s);
    const uint32_t v_tile = sm90::smem_u32(v_s);
    const float scale_log2 = sm_scale * kLog2e;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    sm90::mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int q0 = q_lo + t * kB;
      sm90::mbar_wait(&full[st], (t / kStages) & 1);
      const uint32_t q_tile = sm90::smem_u32(qdo_s + st * 2 * kQT);
      const uint32_t do_tile = q_tile + kQT;
      const float* lse_s = vec_s + st * 2 * kB;
      const float* dl_s = lse_s + kB;

      // S^T = k q^T and dP^T = v do^T: 64 keys x kB queries
      float sacc[kB / 2], dpacc[kB / 2];
#pragma unroll
      for (int i = 0; i < kB / 2; ++i) sacc[i] = dpacc[i] = 0.f;
      sm90::fence_regs(sacc);
      sm90::fence_regs(dpacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64<0>(sacc, Sw::kmajor(k_tile, kk),
                              Sw::kmajor(q_tile, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64<0>(dpacc, Sw::kmajor(v_tile, kk),
                              Sw::kmajor(do_tile, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);
      sm90::fence_regs(dpacc);

      // p^T and ds^T = p^T (dP^T - delta); rows are keys, columns queries
      const bool edge = (causal && q0 < k_start + kB) || q0 + kB > s;
#pragma unroll
      for (int i = 0; i < kB / 2; ++i) {
        const int ql = 8 * (i >> 2) + 2 * c + (i & 1);
        bool ok = true;
        if (edge) {
          const int qrow = q0 + ql;
          const int key = key0 + 8 * ((i >> 1) & 1);
          ok = qrow < s && (!causal || key <= qrow);
        }
        const float p =
            ok ? sm90::ex2(fmaf(sacc[i], scale_log2, -lse_s[ql] * kLog2e))
               : 0.f;
        sacc[i] = p;
        dpacc[i] = p * (dpacc[i] - dl_s[ql]);
      }

      // dv += p^T do and dk += ds^T q (q's sm_scale comes at the end)
      uint32_t pa[kB / 16][4], da[kB / 16][4];
#pragma unroll
      for (int kk = 0; kk < kB / 16; ++kk) {
        sm90::acc_to_a(pa[kk], sacc, kk);
        sm90::acc_to_a(da[kk], dpacc, kk);
      }
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kB / 16; ++kk) {
        if constexpr (D == 64) {
          sm90::wgmma_rs_n64<1>(dv_acc, pa[kk], Sw::mnmajor(do_tile, kk), 1);
          sm90::wgmma_rs_n64<1>(dk_acc, da[kk], Sw::mnmajor(q_tile, kk), 1);
        } else {
          sm90::wgmma_rs_n32<1>(dv_acc, pa[kk], Sw::mnmajor(do_tile, kk), 1);
          sm90::wgmma_rs_n32<1>(dk_acc, da[kk], Sw::mnmajor(q_tile, kk), 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + h * 8;
      if (key >= s) continue;
      const size_t off = (static_cast<size_t>(bh) * s + key) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + j * 8 + 2 * c) =
            sm90::pack_bf16(dk_acc[4 * j + 2 * h] * sm_scale,
                            dk_acc[4 * j + 2 * h + 1] * sm_scale);
        *reinterpret_cast<uint32_t*>(dv + off + j * 8 + 2 * c) =
            sm90::pack_bf16(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return size_t(D) * 2 * (3 * kB + kStages * 2 * kB) + kB * 4 + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to,
               const float* __restrict__ lse, float* __restrict__ delta,
               bf16* __restrict__ dq, int s, int causal, float sm_scale) {
  using Sw = sm90::Swz<D>;
  constexpr uint32_t kQT = kB * D * 2;  // bytes of the q (or do) tile
  constexpr uint32_t kKT = kB * D * 2;  // bytes of a k (or v) tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::align_smem(smem_raw);
  unsigned char* q_s = sm;
  unsigned char* do_s = sm + kQT;
  unsigned char* o_s = sm + 2 * kQT;
  unsigned char* kv_s = sm + 3 * kQT;  // stage st: k at 2 st kKT, v after
  float* dl_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kKT);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(dl_s + kB);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;  // longest causal CTAs first
  const int q_start = qi * kB;
  const int n_kv = (s + kB - 1) / kB;
  const int n_tiles = causal ? min(n_kv, qi + 1) : n_kv;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qdo_full, 1);
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
      sm90::mbar_expect_tx(qdo_full, 3 * kQT);
      sm90::tma_load_3d(q_s, &tq, qdo_full, 0, q_start, bh);
      sm90::tma_load_3d(do_s, &tdo, qdo_full, 0, q_start, bh);
      sm90::tma_load_3d(o_s, &to, qdo_full, 0, q_start, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        sm90::mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], 2 * kKT);
        unsigned char* k_dst = kv_s + st * 2 * kKT;
        sm90::tma_load_3d(k_dst, &tk, &full[st], 0, t * kB, bh);
        sm90::tma_load_3d(k_dst + kKT, &tv, &full[st], 0, t * kB, bh);
      }
    }
  } else {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, c = lane & 3;
    const int row0 = q_start + warp * 16 + g;  // and row0 + 8
    const uint32_t q_tile = sm90::smem_u32(q_s);
    const uint32_t do_tile = sm90::smem_u32(do_s);
    const float scale_log2 = sm_scale * kLog2e;
    // delta = rowsum(o * do) of the CTA's rows from the swizzled o and
    // do tiles, two threads a row (a fixed-order sum), into shared
    // memory and out for the dk/dv pass
    sm90::mbar_wait(qdo_full, 0);
    {
      const int r = threadIdx.x >> 1;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        // chunk j of this thread's half row, through the tile's swizzle
        const uint32_t at =
            r * Sw::kRowBytes + ((threadIdx.x & 1) * (D / 16) + j) * 16;
        const uint32_t sw =
            at ^ (((at >> 7) & (Sw::kRowBytes / 16 - 1)) << 4);
        const uint4 a = *reinterpret_cast<const uint4*>(o_s + sw);
        const uint4 b = *reinterpret_cast<const uint4*>(do_s + sw);
        const bf16* x = reinterpret_cast<const bf16*>(&a);
        const bf16* y = reinterpret_cast<const bf16*>(&b);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(__bfloat162float(x[e]), __bfloat162float(y[e]), acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if ((threadIdx.x & 1) == 0) {
        dl_s[r] = acc;
        if (q_start + r < s)
          delta[static_cast<size_t>(bh) * s + q_start + r] = acc;
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    }
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      lse_r[h] =
          row < s ? lse[static_cast<size_t>(bh) * s + row] * kLog2e : 0.f;
      dl_r[h] = dl_s[row - q_start];
    }

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      sm90::mbar_wait(&full[st], (t / kStages) & 1);
      const uint32_t k_tile = sm90::smem_u32(kv_s + st * 2 * kKT);
      const uint32_t v_tile = k_tile + kKT;

      // S = q k^T and dP = do v^T: 64 rows x kB keys
      float sacc[kB / 2], dpacc[kB / 2];
#pragma unroll
      for (int i = 0; i < kB / 2; ++i) sacc[i] = dpacc[i] = 0.f;
      sm90::fence_regs(sacc);
      sm90::fence_regs(dpacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64<0>(sacc, Sw::kmajor(q_tile, kk),
                              Sw::kmajor(k_tile, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64<0>(dpacc, Sw::kmajor(do_tile, kk),
                              Sw::kmajor(v_tile, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);
      sm90::fence_regs(dpacc);

      // ds = p (dP - delta), into sacc
      const int k_start = t * kB;
      const bool edge = (causal && t == qi) || k_start + kB > s;
#pragma unroll
      for (int i = 0; i < kB / 2; ++i) {
        const int h = (i >> 1) & 1;
        bool ok = true;
        if (edge) {
          const int col = k_start + 8 * (i >> 2) + 2 * c + (i & 1);
          ok = col < s && (!causal || col <= row0 + 8 * h);
        }
        const float p =
            ok ? sm90::ex2(fmaf(sacc[i], scale_log2, -lse_r[h])) : 0.f;
        sacc[i] = p * (dpacc[i] - dl_r[h]);
      }

      // dq += ds k
      uint32_t da[kB / 16][4];
#pragma unroll
      for (int kk = 0; kk < kB / 16; ++kk) sm90::acc_to_a(da[kk], sacc, kk);
      sm90::fence_regs(dq_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kB / 16; ++kk) {
        if constexpr (D == 64)
          sm90::wgmma_rs_n64<1>(dq_acc, da[kk], Sw::mnmajor(k_tile, kk), 1);
        else
          sm90::wgmma_rs_n32<1>(dq_acc, da[kk], Sw::mnmajor(k_tile, kk), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq_acc);
      sm90::mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * 8;
      if (row >= s) continue;
      bf16* dqrow = dq + (static_cast<size_t>(bh) * s + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dqrow + j * 8 + 2 * c) =
            sm90::pack_bf16(dq_acc[4 * j + 2 * h] * sm_scale,
                            dq_acc[4 * j + 2 * h + 1] * sm_scale);
    }
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
  const int rows = bh * s;
  // every tile is kB rows, so one map a tensor serves both passes
  CUtensorMap tq, tk, tv, to, tdo, tlse, tdelta;
  if (!sm90::map_rows<D>(&tq, q, bh, s, kB) ||
      !sm90::map_rows<D>(&tk, k, bh, s, kB) ||
      !sm90::map_rows<D>(&tv, v, bh, s, kB) ||
      !sm90::map_rows<D>(&to, o, bh, s, kB) ||
      !sm90::map_rows<D>(&tdo, dout, bh, s, kB) ||
      !sm90::map_vec(&tlse, lse, rows, kB) ||
      !sm90::map_vec(&tdelta, delta, rows, kB))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(bh, (s + kB - 1) / kB);
  // the dq pass first: it also writes delta, which the dk/dv pass reads
  const size_t smem_q = dq_smem<D>();
  cudaError_t e = mxt::allow_smem(dq_bf16_kernel<D>, smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_bf16_kernel<D><<<grid, kBwdThreads, smem_q, st>>>(
      tq, tdo, tk, tv, to, static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), s, causal,
      sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem_kv = dkdv_smem<D>();
  e = mxt::allow_smem(dkdv_bf16_kernel<D>, smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv_bf16_kernel<D><<<grid, kBwdThreads, smem_kv, st>>>(
      tk, tv, tq, tdo, tlse, tdelta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes, launching on `stream` (float32: the
// delta, dk/dv and dq passes; bfloat16: the dq pass, which writes
// delta, then the dk/dv pass); each returns the first non-zero
// cudaError_t (0 = all launched). head_dim must be 32 or 64 (the
// wrapper checks).
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
