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
// multiplies differs by route: the fma route scales q in float32 before
// the dot, as the Pallas kernel does; the wgmma route keeps q in bf16
// for the tensor cores and applies the scale to the float32 product, as
// the XLA twin `_flash_fwd_xla` does, folded into the exponent: the
// softmax runs on the unscaled product s (masked to -1e30, running max
// m from -1e30), p = 2^(s c - m c) with c = sm_scale log2(e), and lse =
// m sm_scale + log(l). The orders are float32 roundings of the same
// value, about one float32 ulp of the score apart, far below the bf16
// rounding of p. (Scaling q in bf16 instead would add a bf16 rounding.)
//
// Bound: at the training shape (8 x 16 heads, s 1024, head_dim 64,
// causal) the call does 4 * head_dim flops per visible (query, key)
// pair, 17.2 GFLOP (17 us at 989 TFLOP/s), and must move 67 MB of bf16
// q/k/v/o plus the lse (20 us at 3.35 TB/s): the two bounds are close,
// memory slightly ahead. At 8 heads of 128 the flops are the same and
// the bytes too. In float32 (the train_transformer_lm CLI's own dtype,
// 8 x 16 heads of 64) the same 17.2 GFLOP on the CUDA cores, 67 TFLOP/s,
// bound it at 0.26 ms.
//
// Two routes, picked by the wrapper before the launch (flash_route):
//
// "wgmma": bfloat16, head_dim 32, 64 or 128, any s_q and s_k, 16-byte
// aligned storage. One CTA of 288 threads per (128-row q tile, b *
// head), two consumer warpgroups of 64 query rows each and one producer
// warp. The producer's one thread loads the q tile and then 64-key k and
// v tiles into a ring in shared memory by TMA (3-D tensor maps over (b *
// heads, s_q or s_k, head_dim): keys and rows past their length read as
// zeros, never the next head's; 128-byte swizzle for head_dim 64 and
// 128, 64-byte for 32; a head_dim-128 row is two 64-column boxes, so
// each tile is two column spans, hopper.cuh), each stage guarded by a
// full and an empty mbarrier, so later tiles load while this one
// computes. Each consumer warpgroup runs S = q k^T as wgmma m64n64k16
// with both operands read from shared memory (K-major; past column 63
// the second span), keeps the online softmax in registers, rounds p to
// bf16 in registers as the A operand of o += p v (wgmma
// m64n{head_dim}k16, v read MN-major through the transpose bit: nothing
// is transposed by hand), and keeps the 64 x head_dim float32 o in
// registers. At head_dim 32 / 64 two CTAs share an SM (a three-stage
// ring, 64 KB of shared memory at 64; at most 112 registers a thread),
// so one warpgroup's softmax overlaps another's products. At head_dim
// 128 the o accumulator alone is 64 registers a thread: one CTA an SM
// (145 registers a thread, under the 168 ptxas allows a 288-thread CTA;
// no setmaxnreg) with a four-stage ring (160 KB), and its two warpgroups
// take turns issuing S = q k^T over two named barriers (FlashAttention-
// 3's ping-pong), so that one's softmax overlaps the other's products. Only the causal
// diagonal and a key tile past s_k mask; tiles above the diagonal are
// not loaded (a q tile from row r0 visits keys below min(s_k, r0 + 128));
// causal CTAs are issued last-q-tile first, across all heads, so the
// longest start first. o and lse are stored from registers. exp is
// ex2.approx of x * log2(e) (relative error ~2^-22, far below the bf16
// rounding of p).
//
// "fma": every other call the TPU kernel takes: float32 at any head_dim
// up to 256 (the exact reference path: no TF32, no tensor cores; the
// tensor cores have no full-precision float32 product), and bfloat16 at
// the other head dims (8, 80, 256, ...) or unaligned storage. The
// register-tiled CUDA-core design of flash_fma.cuh: a CTA per (64-row q
// tile, b * head), q staged once in float32 and scaled there, k and v
// tiles streamed by cp.async in their own type; each thread holds an 8 x
// 4 block of S (4 x 2 at head_dim 256) and its rows' slice of o in
// registers, row maxima by shuffles within the row group, p through
// shared memory with a __syncwarp; o rounded once at the store. Head
// dims run in buckets of 64 / 128 / 256 columns (the dot products stop
// at head_dim). Tilings, timed on the card: at head_dim <= 64, 128
// threads, 64-key tiles in a single stage, three CTAs an SM (68 KB each
// in float32); at 128, 128 threads, 32-key tiles double-buffered, two
// CTAs an SM (108 KB); at 256, 256 threads, 32-key tiles
// double-buffered, one CTA (204 KB).
#include "common.cuh"
#include "flash_fma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// -------------------------------------------------------------------------
// the "wgmma" route: bfloat16 on the tensor cores
// -------------------------------------------------------------------------

namespace sm90 = mxt::sm90;

constexpr int kBM = 128;          // query rows per CTA (two warpgroups)
constexpr int kBN = 64;           // keys per tile
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kFwdThreads = kConsumers + 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// per head_dim: the k/v ring depth and the CTAs an SM (the register
// budget: the 64 x head_dim float32 o accumulator)
template <int D>
struct FwdCfg {
  static constexpr int kStages = D == 128 ? 4 : 3;
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;
  // the two warpgroups of the one CTA an SM take turns issuing S = q k^T
  // (named barriers 1 and 2), so one's softmax overlaps the other's
  // products
  static constexpr bool kPingPong = D == 128;
};

template <int D>
constexpr size_t fwd_smem() {
  return size_t(D) * 2 * (kBM + 2 * FwdCfg<D>::kStages * kBN) +
         8 * (1 + 2 * FwdCfg<D>::kStages) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, FwdCfg<D>::kMinBlocks)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, float* __restrict__ lse,
                      int s_q, int s_k, int causal, float sm_scale) {
  using Sw = sm90::Swz<D>;
  constexpr int kStages = FwdCfg<D>::kStages;
  constexpr uint32_t kTile = kBN * D * 2;   // bytes of a k or v tile
  constexpr uint32_t kQTile = kBM * D * 2;  // bytes of the q tile
  constexpr uint32_t kQSpan = Sw::span(kBM), kKSpan = Sw::span(kBN);
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
  const int n_kv = (s_k + kBN - 1) / kBN;
  // causal: keys below min(s_k, q_start + kBM)
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
      sm90::tma_load_rows<D>(q_s, &tq, q_full, q_start, bh, kQSpan);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        sm90::mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], 2 * kTile);
        unsigned char* k_dst = kv_s + st * 2 * kTile;
        sm90::tma_load_rows<D>(k_dst, &tk, &full[st], t * kBN, bh, kKSpan);
        sm90::tma_load_rows<D>(k_dst + kTile, &tv, &full[st], t * kBN, bh,
                               kKSpan);
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

  constexpr bool kPP = FwdCfg<D>::kPingPong;
  // the softmax works on the unscaled product s and folds the scale
  // into the exponent: p = 2^(s c2 - m c2) (the max of s and of s *
  // sm_scale pick the same key)
  const float c2 = sm_scale * kLog2e;
  if (kPP && wg == 1) sm90::bar_arrive(1, kConsumers);  // the first turn
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
    if (kPP) sm90::bar_sync(1 + wg, kConsumers);   // this warpgroup's turn
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64<0>(sc, Sw::kmajor(q_tile, kk, kQSpan),
                            Sw::kmajor(k_tile, kk, kKSpan), 1);
    sm90::wgmma_commit();
    if (kPP) sm90::bar_arrive(2 - wg, kConsumers);  // the other's turn
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // scale, mask (the tiles that reach the diagonal or past s_k only),
    // online softmax over rows row0 and row0 + 8
    const int k_start = t * kBN;
    const bool edge =
        (causal && k_start + kBN > q_start) || k_start + kBN > s_k;
    float mx[2] = {mxt::kNegInf, mxt::kNegInf};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      float x = sc[i];
      if (edge) {
        const int col = k_start + 8 * (i >> 2) + 2 * c + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (col >= s_k || (causal && col > row)) x = mxt::kNegInf;
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
      alpha[h] = sm90::ex2((m[h] - m_new) * c2);
      m[h] = m_new;
      mb[h] = m_new * c2;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float p = sm90::ex2(fmaf(sc[i], c2, -mb[h]));
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
    for (int kk = 0; kk < kBN / 16; ++kk)
      sm90::wgmma_rs_t<D>(acc, pa[kk], Sw::mnmajor(v_tile, kk, kKSpan));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    sm90::mbar_arrive(&empty[st]);
  }
  // the second warpgroup's last turn-passing arrive
  if (kPP && wg == 0) sm90::bar_sync(1, kConsumers);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const int row = row0 + h * 8;
    if (row < s_q) {
      const float inv = 1.f / l_safe;
      bf16* orow = o + (static_cast<size_t>(bh) * s_q + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * c) =
            sm90::pack_bf16(acc[4 * j + 2 * h] * inv,
                            acc[4 * j + 2 * h + 1] * inv);
      if (c == 0) lse[static_cast<size_t>(bh) * s_q + row] =
          m[h] * sm_scale + logf(l_safe);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int s_q, int s_k, int causal,
                float sm_scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!sm90::map_rows<D>(&tq, q, bh, s_q, kBM) ||
      !sm90::map_rows<D>(&tk, k, bh, s_k, kBN) ||
      !sm90::map_rows<D>(&tv, v, bh, s_k, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem<D>();
  cudaError_t err = mxt::allow_smem(flash_fwd_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s_q + kBM - 1) / kBM);
  flash_fwd_bf16_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), s_q, s_k,
      causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------------------
// the "fma" route: float32, and bfloat16 outside the wgmma route
// -------------------------------------------------------------------------

namespace ft = mxt::fma_tile;

// DP: the head_dim bucket (64, 128, 256); BS: keys a streamed tile;
// RPT: query rows a thread; STAGES: the k/v ring's depth; MINB: CTAs an
// SM
template <typename T, int DP, int BS, int RPT, int STAGES, int MINB>
__global__ void __launch_bounds__(ft::threads<RPT>(), MINB)
flash_fwd_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int s_q, int s_k, int hd,
                     int causal, float sm_scale, int vec) {
  constexpr int NT = ft::threads<RPT>();
  constexpr int TX = ft::kTX;
  constexpr int LDQ = ft::row_ld<DP>();
  constexpr int LDS = ft::stream_ld<T, DP>();
  constexpr int LDP = BS + 4;
  constexpr int NS = BS / TX;        // keys a thread in a tile
  constexpr int NC = DP / (4 * TX);  // 4-column chunks of o a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);       // kRows x LDQ
  float* p_s = q_s + ft::kRows * LDQ;                    // kRows x LDP
  T* kv_s = reinterpret_cast<T*>(p_s + ft::kRows * LDP);  // k, v a stage

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ft::kRows;  // longest first
  const size_t qbase = static_cast<size_t>(bh) * s_q;
  const size_t kbase = static_cast<size_t>(bh) * s_k;
  const int hd4 = (hd + 3) & ~3;
  // causal: key kpos is visible to query qpos when kpos <= qpos, both
  // counted from 0 whatever s_q and s_k are
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
  // q scaled in float32 before the dot, as the Pallas kernel does
  ft::stage_rows<T, DP, LDQ, NT>(q_s, q + qbase * hd, q0, s_q, hd, sm_scale);

  float acc[RPT][NC][4];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = mxt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }
  const float* qr = q_s + ty * RPT * LDQ;
  float* pr = p_s + ty * RPT * LDP;

  for (int t = 0; t < n_tiles; ++t) {
    ft::pipeline_wait<STAGES>(t, n_tiles, issue);
    const T* ks = kv_s + (t % STAGES) * 2 * BS * LDS;
    const T* vs = ks + BS * LDS;

    // S = (q * scale) k^T: rows RPT ty + i, keys tx + TX j
    float sc[RPT][NS];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd4; d += 4) {
      float4 b[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) b[j] = ft::ld4(ks + (tx + TX * j) * LDS + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 a = ft::ld4(qr + i * LDQ + d);
#pragma unroll
        for (int j = 0; j < NS; ++j) sc[i][j] = ft::dot4(a, b[j], sc[i][j]);
      }
    }

    // mask (tiles that reach the diagonal or past s_k), online softmax
    const int k0 = t * BS;
    const bool edge = (causal && k0 + BS - 1 > q0) || k0 + BS > s_k;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      float mx = mxt::kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (edge) {
          const int col = k0 + tx + TX * j;
          if (col >= s_k || (causal && col > row)) sc[i][j] = mxt::kNegInf;
        }
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], ft::group_max(mx));
      const float alpha = mxt::ex2((m[i] - m_new) * ft::kLog2e);
      const float mb = m_new * ft::kLog2e;
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p = mxt::ex2(fmaf(sc[i][j], ft::kLog2e, -mb));
        pr[i * LDP + tx + TX * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncwarp();

    // o += p v: p rows from shared memory (this row group's own)
    for (int j = 0; j < BS; j += 4) {
      float4 vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[jj][c] = ft::ld4(vs + (j + jj) * LDS + tx * 4 + 4 * TX * c);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float p4[4];
        ft::unpack4(ft::ld4(pr + i * LDP + j), p4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < NC; ++c) ft::axpy4(p4[jj], vv[jj][c], acc[i][c]);
      }
    }
    ft::pipeline_release<STAGES>(t, n_tiles, issue);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    const float lsum = ft::group_sum(l[i]);
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    if (row >= s_q) continue;
    T* orow = o + (qbase + row) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 4 * TX * c;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[i][c][e] / l_safe;
      if (col < hd) ft::store4(orow + col, x, hd - col, vec);
    }
    if (tx == 0) lse[qbase + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int DP, int BS, int RPT, int STAGES, int MINB>
int launch_fma_t(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int s_q, int s_k, int hd, int causal,
                 float sm_scale, int vec, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ft::kRows * (ft::row_ld<DP>() + BS + 4) +
      sizeof(T) * STAGES * 2 * BS * ft::stream_ld<T, DP>();
  auto kernel = flash_fwd_fma_kernel<T, DP, BS, RPT, STAGES, MINB>;
  cudaError_t err = mxt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (s_q + ft::kRows - 1) / ft::kRows);
  kernel<<<grid, ft::threads<RPT>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s_q, s_k, hd, causal, sm_scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int s_q, int s_k, int hd, int causal,
               float sm_scale, cudaStream_t stream) {
  const int vec =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
           16 == 0) &&
      (hd * sizeof(T)) % 16 == 0;
  // <T, DP, BS, RPT, STAGES, MINB>
  if (hd <= 64)
    return launch_fma_t<T, 64, 64, 8, 1, 3>(q, k, v, o, lse, bh, s_q, s_k,
                                            hd, causal, sm_scale, vec,
                                            stream);
  if (hd <= 128)
    return launch_fma_t<T, 128, 32, 8, 2, 2>(q, k, v, o, lse, bh, s_q, s_k,
                                             hd, causal, sm_scale, vec,
                                             stream);
  return launch_fma_t<T, 256, 32, 4, 2, 1>(q, k, v, o, lse, bh, s_q, s_k,
                                           hd, causal, sm_scale, vec, stream);
}

}  // namespace

// Plain C entry points for ctypes; each returns the cudaError_t of the
// launch (0 = launched); q (b * heads, s_q, hd), k and v (b * heads, s_k,
// hd). flash_attention_bf16 is the "wgmma" route: head_dim 32, 64 or 128
// (the wrapper picks the route). flash_attention_fma_{f32,bf16} is the
// "fma" route: any head_dim up to 256.
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
                                    int s_q, int s_k, int hd, int causal,
                                    float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return launch_bf16<128>(q, k, v, o, lse, bh, s_q, s_k,
                                         causal, sm_scale, st);
  if (hd == 64) return launch_bf16<64>(q, k, v, o, lse, bh, s_q, s_k, causal,
                                       sm_scale, st);
  if (hd == 32) return launch_bf16<32>(q, k, v, o, lse, bh, s_q, s_k, causal,
                                       sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
