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
// Layouts (all contiguous): q, o, do, dq (b * heads, s_q, head_dim) T;
// k, v, dk, dv (b * heads, s_k, head_dim) T; lse (b * heads, s_q)
// float32; delta (b * heads, s_q) float32 scratch the wrapper allocates.
//
// Bound: at the training shape (8 x 16 heads, s 1024, head_dim 64,
// causal) the five products do 10 * head_dim flops per visible (query,
// key) pair, 43 GFLOP (43 us at 989 TFLOP/s), against 134 MB of bf16
// q/k/v/o/do read and dq/dk/dv written (40 us at 3.35 TB/s): the tensor
// cores bound it, narrowly. In float32 (the train_transformer_lm CLI) the
// same 43 GFLOP on the CUDA cores bound it at 0.64 ms.
//
// Two routes, picked by the wrapper (flash_route). Both are
// deterministic: the dq pass recomputes S and dP (7 products for the 5
// that are needed) so that every output element is summed by one thread
// in a fixed order, no atomics. Causal means kpos <= qpos with both
// counted from 0, whatever s_q and s_k are.
//
// "wgmma" (bfloat16, head_dim 32, 64 or 128, any s_q and s_k, 16-byte
// aligned storage): two launches of CTAs with a producer warp whose one
// thread loads 64-row tiles by TMA (3-D tensor maps over (b * heads,
// s_q or s_k, head_dim): rows past their length read as zeros, never the
// next head's; 128-byte swizzle at head_dim 64 and 128, 64-byte at 32; a
// head_dim-128 row is two 64-column boxes) through a two-stage ring of
// full/empty mbarriers.
//   dq pass, one CTA of one consumer warpgroup per (64-row q tile, b *
//   head), first; two CTAs an SM (113 / 128 / 164 registers at head_dim
//   32 / 64 / 128, under ptxas's 168 for ten warps an SM): its q
//   and do tiles load once; delta = rowsum(o * do) (two threads a row, a
//   fixed order: from the o and do tiles in shared memory at head_dim <=
//   64, from device memory at 128, where an o tile would not leave room
//   for two CTAs) is written out for the dk/dv pass; 64-key k and v
//   tiles stream. S = q k^T and dP = do v^T run as wgmma m64n64k16 from
//   shared memory (K-major); ds = p (dP - delta), rounded to bf16 in
//   registers, is the A operand of dq += ds k (wgmma m64n{head_dim}k16, k
//   read MN-major through the transpose bit).
//   dk/dv pass, one CTA per (key tile, b * head), walking the 64-row q
//   tiles from the causal diagonal down (a key tile from c0 sees the q
//   tiles from row c0 on): its k and v tiles load once; q and do tiles
//   with their lse and delta (1-D maps) stream. S^T = k q^T and dP^T = v
//   do^T come out directly (both operands from shared memory), so p^T and
//   ds^T land in registers where, rounded to bf16, they are the A
//   operands of dv += p^T do and dk += ds^T q (do and q read MN-major).
//   At head_dim 32 / 64: 64 keys, one consumer warpgroup, two CTAs an
//   SM. At 128 the dk and dv accumulators alone are 128 registers a
//   thread: 128 keys, two consumer warpgroups of 64 keys sharing the
//   streamed q and do tiles, one CTA of 256 threads an SM whose thread 0
//   issues the loads (a producer warp would cap the CTA at 168 registers
//   a thread: it spilled), 246 registers; a warpgroup whose keys all lie
//   above the q tile skips it. (Timed on the card: splitting each q tile
//   into 32-query halves to save registers cost 15% of this pass, and
//   the forward's ping-pong turns cost it 7%.)
// Only the causal diagonal tiles and tiles past s_q or s_k mask. exp is
// ex2.approx of x * log2(e) (relative error ~2^-22, far below the bf16
// rounding of p and ds).
//
// "fma" (float32 at every head_dim up to 256, the exact reference path;
// bfloat16 at the other head dims or unaligned storage): three launches
// on flash_fma.cuh's register-tiled CUDA-core tiling, no tensor cores: a
// delta pre-pass (a warp a row), a dk/dv pass (a CTA per 64 keys staged
// once in float32, q and do tiles streamed by cp.async; each thread
// holds an 8 x 4 block of S^T and dP^T and its keys' slice of dk and dv;
// q scaled after the dot, dk at the end) and a dq pass (a CTA per 64
// query rows, q pre-scaled and do staged in float32, k and v tiles
// streamed; an 8 x 4 block of S and dP a thread, dq in registers, scaled
// at the end). p^T and ds^T (or ds) pass through shared memory within a
// row group. Each gradient is rounded once at its store. Tilings, timed
// on the card: at head_dim <= 64 both passes take 128 threads and
// 64-row tiles in a single stage, two CTAs an SM; at 128 and 256, 32-row
// tiles, one CTA an SM (dk/dv with 4 keys a thread).
#include "common.cuh"
#include "flash_fma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kDeltaThreads = 32 * kWarps;

// delta[r] = sum_d o[r, d] * do[r, d]; one warp per row
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
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
// the "wgmma" route: bfloat16 on the tensor cores
// -------------------------------------------------------------------------

namespace sm90 = mxt::sm90;

constexpr int kB = 64;            // rows of a q tile and of a warpgroup's
                                  // keys: the warpgroup's wgmma M
constexpr int kStages = 2;        // depth of the streamed ring
// an lse or delta box: a 1-D TMA box starts on a 16-byte boundary in
// device memory, so the box for q rows [q0, q0 + kB) starts at the
// multiple of 4 below bh * s_q + q0 and is 4 floats longer; in shared
// memory each box takes a 128-float slot (a TMA destination is
// 128-byte aligned)
constexpr int kVecN = kB + 4;
constexpr int kVecSlot = 128;
constexpr float kLog2e = 1.4426950408889634f;

// the dk/dv pass per head_dim: consumer warpgroups (each 64 keys), CTAs
// an SM, and who issues the loads. At head_dim 128 the dk and dv
// accumulators take 128 registers a thread; a producer warp beside two
// warpgroups would put three warps on one of the SM's four register
// partitions (at most 168 registers a thread), so thread 0 of the first
// warpgroup issues the loads instead (256 threads: up to 255 registers)
template <int D>
struct KvCfg {
  static constexpr int kWG = D == 128 ? 2 : 1;
  static constexpr int kKeys = kB * kWG;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr bool kInline = D == 128;   // no producer warp
  static constexpr int kThreads = kConsumers + (kInline ? 0 : 32);
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;
  static constexpr int kStages = 2;   // depth of the streamed q/do ring
};

template <int D>
constexpr size_t dkdv_smem() {
  return size_t(D) * 2 * (2 * KvCfg<D>::kKeys + KvCfg<D>::kStages * 2 * kB) +
         KvCfg<D>::kStages * 2 * kVecSlot * 4 + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(KvCfg<D>::kThreads, KvCfg<D>::kMinBlocks)
dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tlse,
                 const __grid_constant__ CUtensorMap tdelta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int s_q,
                 int s_k, int causal, float sm_scale) {
  using Sw = sm90::Swz<D>;
  using Cfg = KvCfg<D>;
  constexpr int kConsumers = Cfg::kConsumers;
  constexpr int kStages = Cfg::kStages;
  constexpr uint32_t kKV = Cfg::kKeys * D * 2;  // bytes of the k (or v) tile
  constexpr uint32_t kQT = kB * D * 2;   // bytes of a q (or do) tile
  constexpr uint32_t kVec = kVecN * 4;   // bytes of an lse (or delta) box
  constexpr uint32_t kKSpan = Sw::span(Cfg::kKeys), kQSpan = Sw::span(kB);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::align_smem(smem_raw);
  unsigned char* k_s = sm;
  unsigned char* v_s = sm + kKV;
  unsigned char* qdo_s = sm + 2 * kKV;  // stage st: q at 2 st kQT, do after
  float* vec_s = reinterpret_cast<float*>(qdo_s + kStages * 2 * kQT);
  // stage st: lse at vec_s + 2 st kVecSlot, delta after
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(vec_s + kStages * 2 * kVecSlot);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int k_start = blockIdx.y * Cfg::kKeys;  // causal: tile 0 has the most
  const int q_lo = causal ? k_start : 0;
  const int n_tiles = q_lo < s_q ? (s_q - q_lo + kB - 1) / kB : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the loads of q tile t (with its lse and delta) into stage t % kStages
  auto load_tile = [&](int t) {
    const int st = t % kStages;
    const int q0 = q_lo + t * kB;
    sm90::mbar_expect_tx(&full[st], 2 * kQT + 2 * kVec);
    unsigned char* q_dst = qdo_s + st * 2 * kQT;
    sm90::tma_load_rows<D>(q_dst, &tq, &full[st], q0, bh, kQSpan);
    sm90::tma_load_rows<D>(q_dst + kQT, &tdo, &full[st], q0, bh, kQSpan);
    float* v_dst = vec_s + st * 2 * kVecSlot;
    const int a0 = (bh * s_q + q0) & ~3;
    sm90::tma_load_1d(v_dst, &tlse, &full[st], a0);
    sm90::tma_load_1d(v_dst + kVecSlot, &tdelta, &full[st], a0);
  };
  const bool loader = threadIdx.x == (Cfg::kInline ? 0 : kConsumers);
  if (loader) {
    sm90::mbar_expect_tx(kv_full, 2 * kKV);
    sm90::tma_load_rows<D>(k_s, &tk, kv_full, k_start, bh, kKSpan);
    sm90::tma_load_rows<D>(v_s, &tv, kv_full, k_start, bh, kKSpan);
  }
  if (!Cfg::kInline && threadIdx.x >= kConsumers) {
    // producer warp: one thread issues every load
    if (loader) {
      for (int t = 0; t < n_tiles; ++t) {
        sm90::mbar_wait(&empty[t % kStages], ((t / kStages) & 1) ^ 1);
        load_tile(t);
      }
    }
    return;
  }
  if (Cfg::kInline && loader)
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_tile(t);

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int key_lo = k_start + wg * kB;      // this warpgroup's 64 keys
  const int key0 = key_lo + warp * 16 + g;   // and key0 + 8
  const uint32_t k_tile = sm90::smem_u32(k_s) + wg * kB * Sw::kRowBytes;
  const uint32_t v_tile = sm90::smem_u32(v_s) + wg * kB * Sw::kRowBytes;
  const float scale_log2 = sm_scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  sm90::mbar_wait(kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int q0 = q_lo + t * kB;
    sm90::mbar_wait(&full[st], (t / kStages) & 1);
    // a warpgroup whose keys all lie above every query skips the tile
    // (only the second of two can: the first's keys start at q_lo)
    const bool skip = Cfg::kWG > 1 && causal && key_lo > q0 + kB - 1;
    const uint32_t q_tile = sm90::smem_u32(qdo_s + st * 2 * kQT);
    const uint32_t do_tile = q_tile + kQT;
    const float* lse_s = vec_s + st * 2 * kVecSlot + ((bh * s_q + q0) & 3);
    const float* dl_s = lse_s + kVecSlot;
    const bool edge = (causal && q0 < key_lo + kB) || q0 + kB > s_q;

    if (!skip) {
      // S^T = k q^T and dP^T = v do^T: 64 keys x kB queries
      float sacc[kB / 2], dpacc[kB / 2];
#pragma unroll
      for (int i = 0; i < kB / 2; ++i) sacc[i] = dpacc[i] = 0.f;
      sm90::fence_regs(sacc);
      sm90::fence_regs(dpacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64<0>(sacc, Sw::kmajor(k_tile, kk, kKSpan),
                              Sw::kmajor(q_tile, kk, kQSpan), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss_n64<0>(dpacc, Sw::kmajor(v_tile, kk, kKSpan),
                              Sw::kmajor(do_tile, kk, kQSpan), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);
      sm90::fence_regs(dpacc);

      // p^T and ds^T = p^T (dP^T - delta); rows are keys, columns queries
#pragma unroll
      for (int i = 0; i < kB / 2; ++i) {
        const int ql = 8 * (i >> 2) + 2 * c + (i & 1);
        bool ok = true;
        if (edge) {
          const int qrow = q0 + ql;
          const int key = key0 + 8 * ((i >> 1) & 1);
          ok = qrow < s_q && (!causal || key <= qrow);
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
        sm90::wgmma_rs_t<D>(dv_acc, pa[kk], Sw::mnmajor(do_tile, kk, kQSpan));
        sm90::wgmma_rs_t<D>(dk_acc, da[kk], Sw::mnmajor(q_tile, kk, kQSpan));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
    }
    sm90::mbar_arrive(&empty[st]);
    if (Cfg::kInline && loader && t + kStages < n_tiles) {
      // both warpgroups are done with stage st: refill it
      sm90::mbar_wait(&empty[st], (t / kStages) & 1);
      load_tile(t + kStages);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + h * 8;
    if (key >= s_k) continue;
    const size_t off = (static_cast<size_t>(bh) * s_k + key) * D;
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

constexpr int kDqConsumers = 128;   // one consumer warpgroup
constexpr int kDqThreads = kDqConsumers + 32;  // + the producer warp

// the o tile (for delta) only at head_dim <= 64
template <int D>
constexpr size_t dq_smem() {
  return size_t(D) * 2 * ((D == 128 ? 2 : 3) * kB + kStages * 2 * kB) +
         kB * 4 + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kDqThreads, 2)
dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to,
               const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ delta,
               bf16* __restrict__ dq, int s_q, int s_k, int causal,
               float sm_scale) {
  using Sw = sm90::Swz<D>;
  constexpr bool kOTile = D <= 64;
  constexpr uint32_t kQT = kB * D * 2;  // bytes of the q (or do) tile
  constexpr uint32_t kKT = kB * D * 2;  // bytes of a k (or v) tile
  constexpr uint32_t kSpan = Sw::span(kB);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::align_smem(smem_raw);
  unsigned char* q_s = sm;
  unsigned char* do_s = sm + kQT;
  unsigned char* o_s = sm + 2 * kQT;    // at head_dim <= 64
  unsigned char* kv_s = sm + (kOTile ? 3 : 2) * kQT;  // stage st: k, v
  float* dl_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kKT);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(dl_s + kB);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x;
  const int qi = gridDim.y - 1 - blockIdx.y;  // longest causal CTAs first
  const int q_start = qi * kB;
  const int n_kv = (s_k + kB - 1) / kB;
  const int n_tiles = causal ? min(n_kv, qi + 1) : n_kv;

  if (threadIdx.x == 0) {
    sm90::mbar_init(qdo_full, 1);
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kDqConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kDqConsumers) {
    // producer: one thread issues every load
    if (threadIdx.x == kDqConsumers) {
      sm90::mbar_expect_tx(qdo_full, (kOTile ? 3 : 2) * kQT);
      sm90::tma_load_rows<D>(q_s, &tq, qdo_full, q_start, bh, kSpan);
      sm90::tma_load_rows<D>(do_s, &tdo, qdo_full, q_start, bh, kSpan);
      if (kOTile) sm90::tma_load_rows<D>(o_s, &to, qdo_full, q_start, bh,
                                         kSpan);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        sm90::mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], 2 * kKT);
        unsigned char* k_dst = kv_s + st * 2 * kKT;
        sm90::tma_load_rows<D>(k_dst, &tk, &full[st], t * kB, bh, kSpan);
        sm90::tma_load_rows<D>(k_dst + kKT, &tv, &full[st], t * kB, bh,
                               kSpan);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int row0 = q_start + warp * 16 + g;  // and row0 + 8
  const uint32_t q_tile = sm90::smem_u32(q_s);
  const uint32_t do_tile = sm90::smem_u32(do_s);
  const float scale_log2 = sm_scale * kLog2e;
  // delta = rowsum(o * do) of the CTA's rows, two threads a row (a
  // fixed-order sum), into shared memory and out for the dk/dv pass
  {
    const int r = threadIdx.x >> 1;
    float acc = 0.f;
    if constexpr (kOTile) {
      // from the swizzled o and do tiles
      sm90::mbar_wait(qdo_full, 0);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
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
    } else {
      // from device memory: this thread's half row of o and do
      if (q_start + r < s_q) {
        const size_t off =
            (static_cast<size_t>(bh) * s_q + q_start + r) * D +
            (threadIdx.x & 1) * (D / 2);
        const uint4* a4 = reinterpret_cast<const uint4*>(o + off);
        const uint4* b4 = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          const uint4 a = a4[j], b = b4[j];
          const bf16* x = reinterpret_cast<const bf16*>(&a);
          const bf16* y = reinterpret_cast<const bf16*>(&b);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc = fmaf(__bfloat162float(x[e]), __bfloat162float(y[e]), acc);
        }
      }
      sm90::mbar_wait(qdo_full, 0);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((threadIdx.x & 1) == 0) {
      dl_s[r] = acc;
      if (q_start + r < s_q)
        delta[static_cast<size_t>(bh) * s_q + q_start + r] = acc;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kDqConsumers) : "memory");
  }
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse_r[h] =
        row < s_q ? lse[static_cast<size_t>(bh) * s_q + row] * kLog2e : 0.f;
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
      sm90::wgmma_ss_n64<0>(sacc, Sw::kmajor(q_tile, kk, kSpan),
                            Sw::kmajor(k_tile, kk, kSpan), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64<0>(dpacc, Sw::kmajor(do_tile, kk, kSpan),
                            Sw::kmajor(v_tile, kk, kSpan), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);
    sm90::fence_regs(dpacc);

    // ds = p (dP - delta), into sacc
    const int k_start = t * kB;
    const bool edge = (causal && t == qi) || k_start + kB > s_k;
#pragma unroll
    for (int i = 0; i < kB / 2; ++i) {
      const int h = (i >> 1) & 1;
      bool ok = true;
      if (edge) {
        const int col = k_start + 8 * (i >> 2) + 2 * c + (i & 1);
        ok = col < s_k && (!causal || col <= row0 + 8 * h);
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
    for (int kk = 0; kk < kB / 16; ++kk)
      sm90::wgmma_rs_t<D>(dq_acc, da[kk], Sw::mnmajor(k_tile, kk, kSpan));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq_acc);
    sm90::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    if (row >= s_q) continue;
    bf16* dqrow = dq + (static_cast<size_t>(bh) * s_q + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dqrow + j * 8 + 2 * c) =
          sm90::pack_bf16(dq_acc[4 * j + 2 * h] * sm_scale,
                          dq_acc[4 * j + 2 * h + 1] * sm_scale);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* dk,
                void* dv, void* delta, int bh, int s_q, int s_k, int causal,
                float sm_scale, cudaStream_t st) {
  constexpr int kKeys = KvCfg<D>::kKeys;
  // q-side maps over s_q in 64-row boxes; k and v over s_k in 64-row
  // boxes (the dq pass) and kKeys-row boxes (the dk/dv pass)
  CUtensorMap tq, tdo, to, tk, tv, tk2, tv2, tlse, tdelta;
  if (!sm90::map_rows<D>(&tq, q, bh, s_q, kB) ||
      !sm90::map_rows<D>(&tdo, dout, bh, s_q, kB) ||
      !sm90::map_rows<D>(&to, o, bh, s_q, kB) ||
      !sm90::map_rows<D>(&tk, k, bh, s_k, kB) ||
      !sm90::map_rows<D>(&tv, v, bh, s_k, kB) ||
      !sm90::map_rows<D>(&tk2, k, bh, s_k, kKeys) ||
      !sm90::map_rows<D>(&tv2, v, bh, s_k, kKeys) ||
      !sm90::map_vec(&tlse, lse, static_cast<long long>(bh) * s_q, kVecN) ||
      !sm90::map_vec(&tdelta, delta, static_cast<long long>(bh) * s_q,
                     kVecN))
    return static_cast<int>(cudaErrorInvalidValue);
  // the dq pass first: it also writes delta, which the dk/dv pass reads
  const size_t smem_q = dq_smem<D>();
  cudaError_t e = mxt::allow_smem(dq_bf16_kernel<D>, smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_bf16_kernel<D><<<dim3(bh, (s_q + kB - 1) / kB), kDqThreads, smem_q,
                      st>>>(
      tq, tdo, tk, tv, to, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), s_q, s_k, causal,
      sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem_kv = dkdv_smem<D>();
  e = mxt::allow_smem(dkdv_bf16_kernel<D>, smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv_bf16_kernel<D><<<dim3(bh, (s_k + kKeys - 1) / kKeys),
                        KvCfg<D>::kThreads, smem_kv, st>>>(
      tk2, tv2, tq, tdo, tlse, tdelta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s_q, s_k, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------------------
// the "fma" route: float32, and bfloat16 outside the wgmma route
// -------------------------------------------------------------------------

namespace ft = mxt::fma_tile;

// one CTA per (64 keys, b * head): dk and dv of its keys, walking the
// BS-query tiles that can see them. DP: the head_dim bucket (64, 128,
// 256); RPT: keys a thread; STAGES: the streamed ring's depth; MINB:
// CTAs an SM
template <typename T, int DP, int BS, int RPT, int STAGES, int MINB>
__global__ void __launch_bounds__(ft::threads<RPT>(), MINB)
dkdv_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int s_q, int s_k, int hd, int causal,
                float sm_scale, int vec) {
  constexpr int NT = ft::threads<RPT>();
  constexpr int TX = ft::kTX;
  constexpr int LDR = ft::row_ld<DP>();
  constexpr int LDS = ft::stream_ld<T, DP>();
  constexpr int LDP = BS + 4;
  constexpr int NS = BS / TX;   // queries a thread in a tile
  constexpr int NC = DP / (4 * TX);   // 4-column chunks of dk and dv a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);   // kRows x LDR
  float* v_s = k_s + ft::kRows * LDR;                // kRows x LDR
  float* pt_s = v_s + ft::kRows * LDR;               // p^T, kRows x LDP
  float* dst_s = pt_s + ft::kRows * LDP;             // ds^T, kRows x LDP
  T* qd_s = reinterpret_cast<T*>(dst_s + ft::kRows * LDP);  // q, do a stage

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * ft::kRows;   // causal: tile 0 has the most
  const size_t qbase = static_cast<size_t>(bh) * s_q;
  const size_t kbase = static_cast<size_t>(bh) * s_k;
  const int hd4 = (hd + 3) & ~3;
  const float scale_log2 = sm_scale * ft::kLog2e;
  // causal: no query before k0 sees these keys (kpos <= qpos)
  const int q_lo = causal ? k0 : 0;
  const int n_tiles = q_lo < s_q ? (s_q - q_lo + BS - 1) / BS : 0;

  auto issue = [&](int t) {
    T* qs = qd_s + (t % STAGES) * 2 * BS * LDS;
    ft::stream_rows<T, BS, DP, LDS, NT>(qs, q + qbase * hd, q_lo + t * BS,
                                        s_q, hd, vec);
    ft::stream_rows<T, BS, DP, LDS, NT>(qs + BS * LDS, dout + qbase * hd,
                                        q_lo + t * BS, s_q, hd, vec);
    mxt::cp_async_commit();
  };
  if (n_tiles > 0) issue(0);
  ft::stage_rows<T, DP, LDR, NT>(k_s, k + kbase * hd, k0, s_k, hd, 1.f);
  ft::stage_rows<T, DP, LDR, NT>(v_s, v + kbase * hd, k0, s_k, hd, 1.f);

  float dka[RPT][NC][4], dva[RPT][NC][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][c][e] = dva[i][c][e] = 0.f;
  const float* kr = k_s + ty * RPT * LDR;
  const float* vr = v_s + ty * RPT * LDR;
  float* ptr = pt_s + ty * RPT * LDP;
  float* dsr = dst_s + ty * RPT * LDP;

  for (int t = 0; t < n_tiles; ++t) {
    ft::pipeline_wait<STAGES>(t, n_tiles, issue);
    const T* qs = qd_s + (t % STAGES) * 2 * BS * LDS;
    const T* dos = qs + BS * LDS;
    const int qt0 = q_lo + t * BS;

    // S^T = k q^T and dP^T = v do^T: keys RPT ty + i, queries tx + TX j
    float st[RPT][NS], dpt[RPT][NS];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < hd4; d += 4) {
      float4 qc[NS], dc[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        qc[j] = ft::ld4(qs + (tx + TX * j) * LDS + d);
        dc[j] = ft::ld4(dos + (tx + TX * j) * LDS + d);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 a = ft::ld4(kr + i * LDR + d);
        const float4 b = ft::ld4(vr + i * LDR + d);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          st[i][j] = ft::dot4(a, qc[j], st[i][j]);
          dpt[i][j] = ft::dot4(b, dc[j], dpt[i][j]);
        }
      }
    }

    // p^T = exp(s * scale - lse), 0 where masked; ds^T = p^T (dP^T - delta)
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int qpos = qt0 + tx + TX * j;
      const bool in = qpos < s_q;
      const float lj = in ? lse[qbase + qpos] * ft::kLog2e : 0.f;
      const float dj = in ? delta[qbase + qpos] : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int key = k0 + ty * RPT + i;
        const bool ok = in && (!causal || key <= qpos);
        const float p = ok ? mxt::ex2(fmaf(st[i][j], scale_log2, -lj)) : 0.f;
        ptr[i * LDP + tx + TX * j] = p;
        dsr[i * LDP + tx + TX * j] = p * (dpt[i][j] - dj);
      }
    }
    __syncwarp();

    // dv += p^T do, then dk += ds^T q (q's sm_scale comes at the end)
    for (int j = 0; j < BS; j += 4) {
      float4 dov[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          dov[jj][c] = ft::ld4(dos + (j + jj) * LDS + tx * 4 + 4 * TX * c);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float p4[4];
        ft::unpack4(ft::ld4(ptr + i * LDP + j), p4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < NC; ++c) ft::axpy4(p4[jj], dov[jj][c], dva[i][c]);
      }
    }
    for (int j = 0; j < BS; j += 4) {
      float4 qv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          qv[jj][c] = ft::ld4(qs + (j + jj) * LDS + tx * 4 + 4 * TX * c);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float s4[4];
        ft::unpack4(ft::ld4(dsr + i * LDP + j), s4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < NC; ++c) ft::axpy4(s4[jj], qv[jj][c], dka[i][c]);
      }
    }
    ft::pipeline_release<STAGES>(t, n_tiles, issue);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty * RPT + i;
    if (key >= s_k) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 4 * TX * c;
      if (col >= hd) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = dka[i][c][e] * sm_scale;
      ft::store4(dk + (kbase + key) * hd + col, x, hd - col, vec);
      ft::store4(dv + (kbase + key) * hd + col, dva[i][c], hd - col, vec);
    }
  }
}

// one CTA per (64 query rows, b * head): dq of its rows, walking the
// BS-key tiles they can see
template <typename T, int DP, int BS, int RPT, int STAGES, int MINB>
__global__ void __launch_bounds__(ft::threads<RPT>(), MINB)
dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int s_q, int s_k, int hd, int causal,
              float sm_scale, int vec) {
  constexpr int NT = ft::threads<RPT>();
  constexpr int TX = ft::kTX;
  constexpr int LDR = ft::row_ld<DP>();
  constexpr int LDS = ft::stream_ld<T, DP>();
  constexpr int LDP = BS + 4;
  constexpr int NS = BS / TX;   // keys a thread in a tile
  constexpr int NC = DP / (4 * TX);   // 4-column chunks of dq a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // kRows x LDR, scaled
  float* do_s = q_s + ft::kRows * LDR;               // kRows x LDR
  float* ds_s = do_s + ft::kRows * LDR;              // ds, kRows x LDP
  T* kv_s = reinterpret_cast<T*>(ds_s + ft::kRows * LDP);  // k, v a stage

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ft::kRows;  // longest first
  const size_t qbase = static_cast<size_t>(bh) * s_q;
  const size_t kbase = static_cast<size_t>(bh) * s_k;
  const int hd4 = (hd + 3) & ~3;
  const int k_end = causal ? min(s_k, q0 + ft::kRows) : s_k;
  const int n_tiles = (k_end + BS - 1) / BS;

  auto issue = [&](int t) {
    T* ks = kv_s + (t % STAGES) * 2 * BS * LDS;
    ft::stream_rows<T, BS, DP, LDS, NT>(ks, k + kbase * hd, t * BS, s_k, hd,
                                        vec);
    ft::stream_rows<T, BS, DP, LDS, NT>(ks + BS * LDS, v + kbase * hd,
                                        t * BS, s_k, hd, vec);
    mxt::cp_async_commit();
  };
  if (n_tiles > 0) issue(0);
  ft::stage_rows<T, DP, LDR, NT>(q_s, q + qbase * hd, q0, s_q, hd, sm_scale);
  ft::stage_rows<T, DP, LDR, NT>(do_s, dout + qbase * hd, q0, s_q, hd, 1.f);

  float lse_r[RPT], dl_r[RPT];
  float dqa[RPT][NC][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    lse_r[i] = row < s_q ? lse[qbase + row] * ft::kLog2e : 0.f;
    dl_r[i] = row < s_q ? delta[qbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[i][c][e] = 0.f;
  }
  const float* qr = q_s + ty * RPT * LDR;
  const float* dor = do_s + ty * RPT * LDR;
  float* dsr = ds_s + ty * RPT * LDP;

  for (int t = 0; t < n_tiles; ++t) {
    ft::pipeline_wait<STAGES>(t, n_tiles, issue);
    const T* ks = kv_s + (t % STAGES) * 2 * BS * LDS;
    const T* vs = ks + BS * LDS;
    const int k0 = t * BS;

    // S = (q * scale) k^T and dP = do v^T: rows RPT ty + i, keys tx + TX j
    float sc[RPT][NS], dp[RPT][NS];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < hd4; d += 4) {
      {
        float4 kc[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          kc[j] = ft::ld4(ks + (tx + TX * j) * LDS + d);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float4 a = ft::ld4(qr + i * LDR + d);
#pragma unroll
          for (int j = 0; j < NS; ++j) sc[i][j] = ft::dot4(a, kc[j], sc[i][j]);
        }
      }
      {
        float4 vc[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          vc[j] = ft::ld4(vs + (tx + TX * j) * LDS + d);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float4 b = ft::ld4(dor + i * LDR + d);
#pragma unroll
          for (int j = 0; j < NS; ++j) dp[i][j] = ft::dot4(b, vc[j], dp[i][j]);
        }
      }
    }

    // ds = p (dP - delta), p = exp(s - lse), 0 where masked
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int col = k0 + tx + TX * j;
        const bool ok = col < s_k && (!causal || col <= row);
        const float p =
            ok ? mxt::ex2(fmaf(sc[i][j], ft::kLog2e, -lse_r[i])) : 0.f;
        dsr[i * LDP + tx + TX * j] = p * (dp[i][j] - dl_r[i]);
      }
    }
    __syncwarp();

    // dq += ds k
    for (int j = 0; j < BS; j += 4) {
      float4 kv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          kv[jj][c] = ft::ld4(ks + (j + jj) * LDS + tx * 4 + 4 * TX * c);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float s4[4];
        ft::unpack4(ft::ld4(dsr + i * LDP + j), s4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < NC; ++c) ft::axpy4(s4[jj], kv[jj][c], dqa[i][c]);
      }
    }
    ft::pipeline_release<STAGES>(t, n_tiles, issue);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= s_q) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 4 * TX * c;
      if (col >= hd) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = dqa[i][c][e] * sm_scale;
      ft::store4(dq + (qbase + row) * hd + col, x, hd - col, vec);
    }
  }
}

// one pass's tiling: streamed rows a tile, rows a thread, ring depth,
// CTAs an SM
template <int BS_, int RPT_, int STAGES_, int MINB_>
struct Tiles {
  static constexpr int BS = BS_, RPT = RPT_, STAGES = STAGES_, MINB = MINB_;
};

template <typename T, int DP, typename KV, typename Q>
int launch_fma_t(const void* q, const void* k, const void* v,
                 const void* lse, const void* dout, void* dq, void* dk,
                 void* dv, const void* delta, int bh, int s_q, int s_k,
                 int hd, int causal, float sm_scale, int vec,
                 cudaStream_t st) {
  // both passes: two float32 row-side tiles, one or two score tiles,
  // STAGES pairs of streamed tiles
  const size_t rows = sizeof(float) * ft::kRows * 2 * ft::row_ld<DP>();
  const size_t smem_kv =
      rows + sizeof(float) * ft::kRows * 2 * (KV::BS + 4) +
      sizeof(T) * KV::STAGES * 2 * KV::BS * ft::stream_ld<T, DP>();
  auto kv_kernel =
      dkdv_fma_kernel<T, DP, KV::BS, KV::RPT, KV::STAGES, KV::MINB>;
  cudaError_t e = mxt::allow_smem(kv_kernel, smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  kv_kernel<<<dim3(bh, (s_k + ft::kRows - 1) / ft::kRows),
              ft::threads<KV::RPT>(), smem_kv, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s_q, s_k, hd, causal,
      sm_scale, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem_q =
      rows + sizeof(float) * ft::kRows * (Q::BS + 4) +
      sizeof(T) * Q::STAGES * 2 * Q::BS * ft::stream_ld<T, DP>();
  auto q_kernel =
      dq_fma_kernel<T, DP, Q::BS, Q::RPT, Q::STAGES, Q::MINB>;
  e = mxt::allow_smem(q_kernel, smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  q_kernel<<<dim3(bh, (s_q + ft::kRows - 1) / ft::kRows),
             ft::threads<Q::RPT>(), smem_q, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), s_q, s_k, hd, causal, sm_scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fma(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dq, void* dk,
               void* dv, void* delta, int bh, int s_q, int s_k, int hd,
               int causal, float sm_scale, cudaStream_t st) {
  const int rows = bh * s_q;
  delta_kernel<T><<<(rows + kWarps - 1) / kWarps, kDeltaThreads, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows, hd);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  const int vec = ptrs % 16 == 0 && (hd * sizeof(T)) % 16 == 0;
  // Tiles<BS, RPT, STAGES, MINB> of the dk/dv pass, then the dq pass
  if (hd <= 64)
    return launch_fma_t<T, 64, Tiles<64, 8, 1, 2>, Tiles<64, 8, 1, 2>>(
        q, k, v, lse, dout, dq, dk, dv, delta, bh, s_q, s_k, hd, causal,
        sm_scale, vec, st);
  if (hd <= 128)
    return launch_fma_t<T, 128, Tiles<32, 4, 2, 1>, Tiles<32, 8, 2, 1>>(
        q, k, v, lse, dout, dq, dk, dv, delta, bh, s_q, s_k, hd, causal,
        sm_scale, vec, st);
  return launch_fma_t<T, 256, Tiles<32, 4, 1, 1>, Tiles<32, 4, 1, 1>>(
      q, k, v, lse, dout, dq, dk, dv, delta, bh, s_q, s_k, hd, causal,
      sm_scale, vec, st);
}

}  // namespace

// Plain C entry points for ctypes, launching on `stream`; each returns
// the first non-zero cudaError_t (0 = all launched). q, o, do, dq (b *
// heads, s_q, hd); k, v, dk, dv (b * heads, s_k, hd).
// flash_attention_bwd_fma_{f32,bf16}, the "fma" route: the delta, dk/dv
// and dq passes, any head_dim up to 256. flash_attention_bwd_bf16, the
// "wgmma" route: the dq pass, which writes delta, then the dk/dv pass;
// head_dim 32, 64 or 128 (the wrapper picks the route).
extern "C" int flash_attention_bwd_fma_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int bh, int s_q, int s_k, int hd, int causal,
    float sm_scale, void* stream) {
  return launch_fma<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, s_q,
                           s_k, hd, causal, sm_scale,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_fma_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int bh, int s_q, int s_k, int hd, int causal,
    float sm_scale, void* stream) {
  return launch_fma<bf16>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, s_q,
                          s_k, hd, causal, sm_scale,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int bh, int s_q, int s_k, int hd, int causal,
    float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_bf16<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh,
                            s_q, s_k, causal, sm_scale, st);
  if (hd == 64)
    return launch_bf16<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, s_q,
                           s_k, causal, sm_scale, st);
  if (hd == 32)
    return launch_bf16<32>(q, k, v, o, lse, dout, dq, dk, dv, delta, bh, s_q,
                           s_k, causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
