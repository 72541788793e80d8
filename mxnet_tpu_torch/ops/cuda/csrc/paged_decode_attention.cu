// Paged decode attention for Hopper (sm_90a).
//
// Replaces mxnet_tpu/ops/pallas/flash_attention.py `_paged_kernel`
// (launched by `_paged_decode`, entry `paged_decode_attention`): one
// query token per row attends the keys < lengths[row] of a paged KV
// pool addressed through a block table, with an online softmax over
// pages.
//
// Layouts (all contiguous):
//   q            (b, kv_heads, group, head_dim)        T
//   k/v_pages    (num_pages, page_size, kv_heads, head_dim)  T
//   block_tables (b, pages_per_seq)                    int32
//   lengths      (b,)                                  int32
//   out          (b, kv_heads, group, head_dim)        T
//
// Bound: device memory. The call must read every live key and value
// once, sum(lengths) * kv_heads * head_dim * 2 * sizeof(T) bytes, and
// does 4 * group * head_dim flops per such key: ~2 flops per byte in
// bf16, far under the ~295 the card needs to be compute-bound. At the
// serving shapes (b <= 8, 4 kv heads, <= 256 keys) that is < 1 MB, so
// what costs time is latency: dependent round trips to device memory
// and too few CTAs in flight.
//
// Two routes, picked by the wrapper from the shapes before the launch:
//
// "cluster" (paged_decode_split_kernel; head_dim <= 256 and a multiple
// of 16 bytes, 16-byte aligned tensors). Each (row, kv head) is split
// over a thread-block cluster of `splits` (<= 8) CTAs; CTA rank r owns
// the contiguous live pages [r * n / splits, (r + 1) * n / splits) of
// the row's n = ceil(lengths[row] / page_size) (capped at
// pages_per_seq), so at b = 8 the grid holds 256 CTAs, not 32. A CTA
// fetches q, the row's block table and its length together, then issues
// the cp.async 16-byte copies of all its K/V rows (neighbouring lanes on
// neighbouring 16 bytes of a row) before any arithmetic, in chunks of at
// most 32 KB double-buffered when its range is longer. Each warp owns a
// query head of the group (the heads share every staged K/V row: the
// GQA saving) and each lane a token, 32 tokens a step: the lane's score
// is its K row against the head's q (converted to float32 once, while
// the K/V rows are in flight, and read by broadcast; staged rows are
// padded so that neighbouring rows hit distinct banks), the step's max
// and sum are warp shuffles, and in P V each lane takes a 16-byte
// segment of a V row, the warp 32 / (segments a row) tokens at once, p
// read by broadcast, the partial sums meeting by shuffles at the end.
// All in float32, scores in log2 units for ex2; no CTA barrier between
// the steps. head_dim 64, the serving one, is compiled in.
// The CTAs then merge in a fixed order: each rank writes its (m, l) and
// each rank's slice of its acc straight into that rank's shared memory
// (distributed shared memory) by asynchronous stores that complete on
// the receiver's mbarrier, so a rank waits for its own data and for no
// barrier of the whole cluster, and sums its slice of the output in
// rank order with weights 2^(m - max m). So a call repeats bitwise and
// stays one launch. A CTA with no live key contributes m = -1e30, l = 0
// (weight 0).
//
// "serial" (paged_decode_kernel, the first design; any other head_dim):
// one CTA per (row, kv head) walking its pages in series through
// float32 shared memory.
//
// Both mask keys at or past lengths[row], read only the pages
// lengths[row] reaches, clamp page ids (mxt::clamp_page), and give
// zeros for a row whose length is 0 (l == 0 normalises by 1), as the
// TPU kernel does.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int kvh, int group, int hd, int num_pages,
                    int page_size, int pages_per_seq, float sm_scale) {
  extern __shared__ float smem[];
  const int row = blockIdx.x / kvh;
  const int head = blockIdx.x % kvh;
  const int gh = group * hd;
  const int hdp = hd + 1;  // padded K row
  float* q_s = smem;                   // group * hd, pre-scaled
  float* k_s = q_s + gh;               // page_size * hdp
  float* v_s = k_s + page_size * hdp;  // page_size * hd
  float* p_s = v_s + page_size * hd;   // group * page_size
  float* acc = p_s + group * page_size;  // group * hd
  float* m_s = acc + gh;               // group
  float* l_s = m_s + group;            // group
  float* a_s = l_s + group;            // group: this page's rescale

  const int tid = threadIdx.x;
  const T* q_row = q + (static_cast<size_t>(row) * kvh + head) * gh;
  for (int i = tid; i < gh; i += kThreads) {
    q_s[i] = mxt::to_f32(q_row[i]) * sm_scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < group; i += kThreads) {
    m_s[i] = mxt::kNegInf;
    l_s[i] = 0.f;
  }
  const int length = lengths[row];
  const int n_pages =
      min((max(length, 0) + page_size - 1) / page_size, pages_per_seq);
  const size_t tok_stride = static_cast<size_t>(kvh) * hd;
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const int page = mxt::clamp_page(
        block_tables[static_cast<size_t>(row) * pages_per_seq + p],
        num_pages);
    const size_t base =
        static_cast<size_t>(page) * page_size * tok_stride +
        static_cast<size_t>(head) * hd;
    for (int i = tid; i < page_size * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      const size_t src = base + t * tok_stride + d;
      k_s[t * hdp + d] = mxt::to_f32(k_pages[src]);
      v_s[i] = mxt::to_f32(v_pages[src]);
    }
    __syncthreads();

    const int start = p * page_size;
    for (int i = tid; i < group * page_size; i += kThreads) {
      const int g = i / page_size;
      const int t = i - g * page_size;
      const float* qv = q_s + g * hd;
      const float* kv = k_s + t * hdp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qv[d], kv[d], s);
      p_s[i] = (start + t < length) ? s : mxt::kNegInf;
    }
    __syncthreads();

    for (int g = tid; g < group; g += kThreads) {
      float* pr = p_s + g * page_size;
      float mx = mxt::kNegInf;
      for (int t = 0; t < page_size; ++t) mx = fmaxf(mx, pr[t]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < page_size; ++t) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      l_s[g] = alpha * l_s[g] + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < gh; i += kThreads) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* pr = p_s + g * page_size;
      float pv = 0.f;
      for (int t = 0; t < page_size; ++t) pv = fmaf(pr[t], v_s[t * hd + d], pv);
      acc[i] = acc[i] * a_s[g] + pv;
    }
    __syncthreads();
  }

  T* o_row = out + (static_cast<size_t>(row) * kvh + head) * gh;
  for (int i = tid; i < gh; i += kThreads) {
    const float l = l_s[i / hd];
    o_row[i] = mxt::from_f32<T>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* lengths, void* out, int b,
           int kvh, int group, int hd, int num_pages, int page_size,
           int pages_per_seq, float sm_scale, void* stream) {
  const size_t smem =
      sizeof(float) * (2 * group * hd + page_size * (2 * hd + 1) +
                       group * page_size + 3 * group);
  cudaError_t err = mxt::allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T><<<b * kvh, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), kvh, group, hd,
      num_pages, page_size, pages_per_seq, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the "cluster" route
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kMaxSplits = 8;  // CTAs a cluster (the portable limit)
constexpr int kLaneVals = 8;   // float sums a lane keeps a head in P V
// K + V bytes of one staged chunk of tokens
constexpr int kChunkBytes = 32 * 1024;

// 16 bytes of T as floats
__device__ __forceinline__ void seg_to_f32(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void seg_to_f32(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 2^x (PTX ex2.approx, flush to zero: 2^-1e30 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a / b for a >= 0, b > 0: a shift where b is a power of two
__device__ __forceinline__ int div_fast(int a, int b) {
  return (b & (b - 1)) ? a / b : a >> (__ffs(b) - 1);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cluster barriers (PTX): arrive and wait apart, so that a wait can come
// long after its arrive
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// *dst = v in cluster rank `rank`'s copy of this CTA's shared memory, an
// asynchronous store that completes on that rank's copy of `bar`
__device__ __forceinline__ void st_async(float* dst, uint64_t* bar,
                                         int rank, float v) {
  uint32_t rd, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rd)
               : "r"(mxt::sm90::smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb)
               : "r"(mxt::sm90::smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(rd),
      "r"(__float_as_uint(v)), "r"(rb)
      : "memory");
}

// issue the cp.async copies of tokens [tok0, tok0 + n) of one row and kv
// head into k_s / v_s (rows of `ld` elements); one 16-byte segment an
// item (bulk copies of one row each, tried instead, were slower: PERF.md
// §6)
template <typename T>
__device__ __forceinline__ void stage_tokens(
    T* k_s, T* v_s, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* bt_row, int tok0, int n,
    int segs, int ld, int page_size, int num_pages, size_t tok_stride,
    size_t head_off) {
  constexpr int kVec = 16 / sizeof(T);
  // shifts where the sizes are powers of two (the serving shapes)
  const bool pow2 = !(segs & (segs - 1)) && !(page_size & (page_size - 1));
  const int seg_shift = __ffs(segs) - 1;
  const int page_shift = __ffs(page_size) - 1;
  for (int i = threadIdx.x; i < n * segs; i += kSplitThreads) {
    const int t = pow2 ? i >> seg_shift : i / segs;
    const int sg = i - t * segs;
    const int pos = tok0 + t;
    const int pi = pow2 ? pos >> page_shift : pos / page_size;
    const int page = mxt::clamp_page(bt_row[pi], num_pages);
    const size_t src =
        (static_cast<size_t>(page) * page_size + (pos - pi * page_size)) *
            tok_stride +
        head_off + sg * kVec;
    mxt::cp_async16(k_s + t * ld + sg * kVec, k_pages + src);
    mxt::cp_async16(v_s + t * ld + sg * kVec, v_pages + src);
  }
}

// Grid (splits, kv_heads, b), clusters of (splits, 1, 1): one cluster a
// (row, kv head), GB query heads of the group a pass, a warp a head. HD
// is head_dim where it is known at compile time (the serving 64), else
// 0 and head_dim is `hd_arg`.
template <typename T, int GB, int HD>
__global__ void __launch_bounds__(kSplitThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ lengths,
                          T* __restrict__ out, int kvh, int group, int hd_arg,
                          int num_pages, int page_size, int pages_per_seq,
                          int chunk, int stages, float scale_log2) {
  const int hd = HD ? HD : hd_arg;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kHpw = (GB + kSplitWarps - 1) / kSplitWarps;  // heads a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int splits = gridDim.x;
  const int rank = blockIdx.x;  // the CTA's rank in its cluster
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // phase 0: start (tools/torch_decode_phases.py stamps these lines)

  constexpr int kSpl = kLaneVals / kVec;  // V segments a lane in P V
  const int segs = hd / kVec;  // 16-byte segments of a K/V row
  int pv = 1;                  // lanes a token in P V
  while (pv < segs && pv < 32) pv <<= 1;
  const int psub = lane & (pv - 1);
  const int tq = lane / pv;
  // staged rows padded to an odd number of segments: lanes reading
  // neighbouring rows hit distinct banks
  const int ld = (segs + (segs % 2 ? 2 : 1)) * kVec;
  // the output values a rank merges (a contiguous slice of GB * hd)
  const int per_rank = (GB * hd + splits - 1) / splits;

  // shared memory: an mbarrier (16 bytes); `stages` chunks of K and V
  // rows; q of GB heads, as
  // loaded and as float32; each warp's probabilities; the CTA's (m, l,
  // acc); what the cluster's ranks send this one (their m, l and its
  // slice of acc); the row's block table and its length
  T* stage0 = reinterpret_cast<T*>(smem_raw + 16);  // after the mbarrier
  const size_t stage_elems = static_cast<size_t>(chunk) * ld;
  T* q_s = stage0 + 2 * stages * stage_elems;        // [h][hd]
  float* c_acc = reinterpret_cast<float*>(q_s + GB * hd);  // [h][hd]
  float* q_f = c_acc + GB * hd;                      // [h][hd], scaled
  float* s_p = q_f + GB * hd;                        // [warp][32]
  float* c_m = s_p + kSplitWarps * 32;               // [h]
  float* c_l = c_m + GB;
  float* r_m = c_l + GB;                             // [rank][h]
  float* r_l = r_m + kMaxSplits * GB;
  float* r_acc = r_l + kMaxSplits * GB;              // [rank][per_rank]
  int* bt_row = reinterpret_cast<int*>(r_acc + kMaxSplits * per_rank);
  int* len_s = bt_row + pages_per_seq;
  uint64_t* recv_bar = reinterpret_cast<uint64_t*>(smem_raw);

  // what this rank receives a head block: each rank's m and l of the GB
  // heads and this rank's slice of its acc. The mbarrier is set up (and
  // expects those bytes) before the cluster's start barrier, which every
  // CTA passes before its first write into another's shared memory.
  const int slice = max(0, min(per_rank, GB * hd - rank * per_rank));
  const uint32_t recv_bytes = sizeof(float) * splits * (slice + 2 * GB);
  uint32_t parity = 0;

  const T* q_kv = q + (static_cast<size_t>(row) * kvh + head) * group * hd;
  T* o_kv = out + (static_cast<size_t>(row) * kvh + head) * group * hd;
  // each warp fetches (and later converts) the q rows of its own heads,
  // so that a warp's wait and __syncwarp order them
  auto fetch_q = [&](int hb) {
    const int gb = min(GB, group - hb);
#pragma unroll
    for (int k = 0; k < kHpw; ++k) {
      const int h = warp + kSplitWarps * k;
      if (h >= gb) break;
      for (int i = lane; i < segs; i += 32)
        mxt::cp_async16(q_s + h * hd + i * kVec,
                        q_kv + (hb + h) * hd + i * kVec);
    }
    mxt::cp_async_commit();
  };
  // q, the row's block table and its length are fetched together: one
  // round trip to device memory before the K/V loads can be issued
  fetch_q(0);
  // the last thread sets up the mbarrier (its fence costs what the loads
  // of the others take) before any load of its own; thread 0 loads the
  // length, the first pages_per_seq threads the block table, all in
  // flight together
  if (tid == kSplitThreads - 1) {
    mxt::sm90::mbar_init(recv_bar, 1);
    mxt::sm90::mbar_fence_init();
    mxt::sm90::mbar_expect_tx(recv_bar, recv_bytes);
  }
  const int* bt_g = block_tables + static_cast<size_t>(row) * pages_per_seq;
  const int bt0 = tid < pages_per_seq ? bt_g[tid] : 0;
  const int len0 = tid == 0 ? lengths[row] : 0;
  cluster_arrive_relaxed();  // (after the fence: the mbarrier is visible)
  if (tid < pages_per_seq) bt_row[tid] = bt0;
  for (int i = tid + kSplitThreads; i < pages_per_seq; i += kSplitThreads)
    bt_row[i] = bt_g[i];
  if (tid == 0) *len_s = max(len0, 0);
  __syncthreads();
  const int length = *len_s;
  // phase 1: block table, length and q fetched
  const int n_live =
      min(div_fast(length + page_size - 1, page_size), pages_per_seq);
  const int p0 = div_fast(rank * n_live, splits);
  const int p1 = div_fast((rank + 1) * n_live, splits);
  const int tok0 = p0 * page_size;
  const int n_tok = max(min(p1 * page_size, length) - tok0, 0);
  const int n_chunks = div_fast(n_tok + chunk - 1, chunk);
  const size_t tok_stride = static_cast<size_t>(kvh) * hd;
  const size_t head_off = static_cast<size_t>(head) * hd;
  const bool resident = n_chunks <= 1;

  // each warp its heads' q as float32, scaled by sm_scale * log2(e)
  // (scores in log2 units, for ex2), once its lanes' copies have landed
  auto convert_q = [&]() {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kHpw; ++k) {
      const int h = warp + kSplitWarps * k;
      if (h >= GB) break;
      for (int e = lane; e < hd; e += 32)
        q_f[h * hd + e] = mxt::to_f32(q_s[h * hd + e]) * scale_log2;
    }
    __syncwarp();
  };

  // every load of the CTA's range before any arithmetic when it fits
  if (resident && n_tok > 0) {
    stage_tokens(stage0, stage0 + stage_elems, k_pages, v_pages, bt_row,
                 tok0, n_tok, segs, ld, page_size, num_pages, tok_stride,
                 head_off);
    mxt::cp_async_commit();
    mxt::cp_async_wait<1>();  // q, while the K/V rows are in flight
  } else {
    mxt::cp_async_wait<0>();
  }
  convert_q();
  // phase 2: K/V copies issued, q converted

  for (int hb = 0; hb < group; hb += GB) {
    const int gb = min(GB, group - hb);
    if (hb > 0) {
      fetch_q(hb);
      mxt::cp_async_wait<0>();
      convert_q();
    }
    float m[kHpw], l[kHpw], acc[kHpw][kLaneVals];
#pragma unroll
    for (int k = 0; k < kHpw; ++k) {
      m[k] = mxt::kNegInf;
      l[k] = 0.f;
#pragma unroll
      for (int e = 0; e < kLaneVals; ++e) acc[k][e] = 0.f;
    }
    if (!resident) {
      stage_tokens(stage0, stage0 + stage_elems, k_pages, v_pages, bt_row,
                   tok0, min(chunk, n_tok), segs, ld, page_size, num_pages,
                   tok_stride, head_off);
      mxt::cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      if (!resident && c + 1 < n_chunks) {
        T* nxt = stage0 + 2 * ((c + 1) & 1) * stage_elems;
        stage_tokens(nxt, nxt + stage_elems, k_pages, v_pages, bt_row,
                     tok0 + (c + 1) * chunk,
                     min(chunk, n_tok - (c + 1) * chunk), segs, ld,
                     page_size, num_pages, tok_stride, head_off);
        mxt::cp_async_commit();
        mxt::cp_async_wait<1>();
      } else {
        mxt::cp_async_wait<0>();
      }
      __syncthreads();
      // phase 3: K/V landed
      const T* k_c = stage0 + 2 * (resident ? 0 : (c & 1)) * stage_elems;
      const T* v_c = k_c + stage_elems;
      const int n_c = min(chunk, n_tok - c * chunk);
      // a warp a head, 32 tokens a step
      for (int t0 = 0; t0 < n_c; t0 += 32) {
        const int n = min(32, n_c - t0);
        const bool live = lane < n;
        const T* k_row = k_c + static_cast<size_t>(t0 + lane) * ld;
        const T* v_s = v_c + static_cast<size_t>(t0) * ld;
#pragma unroll
        for (int k = 0; k < kHpw; ++k) {
          const int h = warp + kSplitWarps * k;
          if (h >= GB) break;
          // a lane a token: its K row against q (a broadcast read), two
          // sums for two FMA chains
          float s = mxt::kNegInf;
          if (live) {
            float s0 = 0.f, s1 = 0.f;
            const float* qh = q_f + h * hd;
#pragma unroll 4
            for (int sg = 0; sg < segs; ++sg) {
              float kf[kVec];
              seg_to_f32(k_row + sg * kVec, kf);
#pragma unroll
              for (int e = 0; e < kVec; e += 4) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(qh + sg * kVec + e);
                s0 = fmaf(qv.x, kf[e], s0);
                s1 = fmaf(qv.y, kf[e + 1], s1);
                s0 = fmaf(qv.z, kf[e + 2], s0);
                s1 = fmaf(qv.w, kf[e + 3], s1);
              }
            }
            s = s0 + s1;
          }
          // phase 4: scores
          const float m_new = fmaxf(m[k], warp_max(s));
          const float a = ex2(m[k] - m_new);
          const float p = live ? ex2(s - m_new) : 0.f;
          l[k] = l[k] * a + warp_sum(p);
          m[k] = m_new;
          s_p[warp * 32 + lane] = p;
          __syncwarp();
          // phase 5: softmax
          // P V: `pv` lanes a token, each a 16-byte segment of its V row
          // (two in float32 past 128 values), the warp's 32 / pv tokens a
          // step in flight together; partial sums over the steps
#pragma unroll
          for (int e = 0; e < kLaneVals; ++e) acc[k][e] *= a;
#pragma unroll 8
          for (int t = tq; t < n; t += 32 / pv) {
            const float pt = s_p[warp * 32 + t];
            const T* vr = v_s + static_cast<size_t>(t) * ld;
#pragma unroll
            for (int j = 0; j < kSpl; ++j) {
              const int sg = psub + pv * j;
              if (sg < segs) {
                float vf[kVec];
                seg_to_f32(vr + sg * kVec, vf);
#pragma unroll
                for (int e = 0; e < kVec; ++e)
                  acc[k][j * kVec + e] = fmaf(pt, vf[e], acc[k][j * kVec + e]);
              }
            }
          }
          __syncwarp();  // s_p is rewritten by the next head or step
        }
      }
      if (!resident) __syncthreads();  // before the stage is refilled
    }
    // the token steps' partial sums meet by shuffles; each head's row of
    // acc, its m and l to shared memory
#pragma unroll
    for (int k = 0; k < kHpw; ++k) {
      const int h = warp + kSplitWarps * k;
      if (h >= GB) break;
      for (int off = pv; off < 32; off <<= 1) {
#pragma unroll
        for (int e = 0; e < kLaneVals; ++e)
          acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], off);
      }
      if (tq == 0) {
#pragma unroll
        for (int j = 0; j < kSpl; ++j) {
          const int sg = psub + pv * j;
          if (sg < segs) {
#pragma unroll
            for (int e = 0; e < kVec; e += 4)
              *reinterpret_cast<float4*>(c_acc + h * hd + sg * kVec + e) =
                  make_float4(acc[k][j * kVec + e], acc[k][j * kVec + e + 1],
                              acc[k][j * kVec + e + 2],
                              acc[k][j * kVec + e + 3]);
          }
        }
      }
      if (lane == 0) {
        c_m[h] = m[k];
        c_l[h] = l[k];
      }
    }

    // every rank sends each rank its (m, l) and that rank's slice of acc,
    // straight into the receiver's shared memory by asynchronous stores
    // that complete on the receiver's mbarrier; each rank waits for its
    // own data only, then merges its slice in rank order and writes it
    // phase 6: P V done
    __syncthreads();  // this CTA's (m, l, acc) are complete
    cluster_wait();           // (the start barrier: every mbarrier is set)
    for (int i = tid; i < GB * hd; i += kSplitThreads) {
      const int owner = i / per_rank;
      st_async(r_acc + rank * per_rank + (i - owner * per_rank), recv_bar,
               owner, c_acc[i]);
    }
    for (int i = tid; i < GB * splits; i += kSplitThreads) {
      const int h = i / splits;
      const int to = i - h * splits;
      st_async(r_m + rank * GB + h, recv_bar, to, c_m[h]);
      st_async(r_l + rank * GB + h, recv_bar, to, c_l[h]);
    }
    // phase 7: partials sent
    mxt::sm90::mbar_wait(recv_bar, parity);
    // phase 8: partials received
    for (int j = tid; j < per_rank; j += kSplitThreads) {
      const int i = rank * per_rank + j;
      const int h = i / hd;
      if (i >= gb * hd) break;
      float pm[kMaxSplits], pl[kMaxSplits], pa[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        const bool ok = r < splits;
        pm[r] = ok ? r_m[r * GB + h] : mxt::kNegInf;
        pl[r] = ok ? r_l[r * GB + h] : 0.f;
        pa[r] = ok ? r_acc[r * per_rank + j] : 0.f;
      }
      float mx = pm[0];
#pragma unroll
      for (int r = 1; r < kMaxSplits; ++r) mx = fmaxf(mx, pm[r]);
      float sum = 0.f, ll = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {  // (0 for ranks past splits)
        const float w = ex2(pm[r] - mx);
        sum = fmaf(w, pa[r], sum);
        ll = fmaf(w, pl[r], ll);
      }
      o_kv[static_cast<size_t>(hb) * hd + i] =
          mxt::from_f32<T>(sum / (ll == 0.f ? 1.f : ll));
    }
    // phase 9: merged and stored
    if (hb + GB < group) {
      // the next head block: the mbarrier's next phase expects as many
      // bytes; every rank has read what it was sent before anyone sends
      // again, and the next block's first wait has an arrive
      if (tid == 0) mxt::sm90::mbar_expect_tx(recv_bar, recv_bytes);
      parity ^= 1;
      cluster_arrive();
      cluster_wait();
      cluster_arrive_relaxed();
    }
  }
}

template <typename T, int GB, int HD>
int launch_split_gb(const void* q, const void* k_pages, const void* v_pages,
                    const void* block_tables, const void* lengths, void* out,
                    int b, int kvh, int group, int hd, int num_pages,
                    int page_size, int pages_per_seq, int splits,
                    float sm_scale, cudaStream_t stream) {
  const int max_tok = (pages_per_seq + splits - 1) / splits * page_size;
  const int cap = max(1, kChunkBytes / (2 * hd * static_cast<int>(sizeof(T))));
  const int chunk = max(1, min(max_tok, cap));
  const int stages = max_tok > chunk ? 2 : 1;
  const int segs = hd * static_cast<int>(sizeof(T)) / 16;
  const int ld = (segs + (segs % 2 ? 2 : 1)) * 16 / static_cast<int>(sizeof(T));
  const int per_rank = (GB * hd + splits - 1) / splits;
  const size_t smem =
      16 + sizeof(T) * (2 * static_cast<size_t>(stages) * chunk * ld +
                        GB * hd) +
      sizeof(float) * (GB * (2 * hd + 2 + 2 * kMaxSplits) +
                       kSplitWarps * 32 + kMaxSplits * per_rank) +
      sizeof(int) * (pages_per_seq + 1);
  auto kernel = paged_decode_split_kernel<T, GB, HD>;
  cudaError_t err = mxt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, kvh, b);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), kvh, group, hd,
      num_pages, page_size, pages_per_seq, chunk, stages,
      sm_scale * 1.4426950408889634f);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const void* block_tables, const void* lengths, void* out,
                 int b, int kvh, int group, int hd, int num_pages,
                 int page_size, int pages_per_seq, int splits,
                 float sm_scale, void* stream) {
  if (splits < 1 || splits > kMaxSplits || hd % (16 / sizeof(T)) ||
      hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  // the query heads a pass: 4 (a warp each), or 8 for larger groups;
  // head_dim 64 compiled in
  const auto fn = group <= 4 ? (hd == 64 ? launch_split_gb<T, 4, 64>
                                         : launch_split_gb<T, 4, 0>)
                             : (hd == 64 ? launch_split_gb<T, 8, 64>
                                         : launch_split_gb<T, 8, 0>);
  return fn(q, k_pages, v_pages, block_tables, lengths, out, b, kvh, group,
            hd, num_pages, page_size, pages_per_seq, splits, sm_scale, st);
}

}  // namespace

// Plain C entry points for ctypes; each returns the cudaError_t of the
// launch (0 = launched).
extern "C" int paged_decode_attention_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, int b, int kvh,
    int group, int hd, int num_pages, int page_size, int pages_per_seq,
    float sm_scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, b,
                       kvh, group, hd, num_pages, page_size, pages_per_seq,
                       sm_scale, stream);
}

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, int b, int kvh,
    int group, int hd, int num_pages, int page_size, int pages_per_seq,
    float sm_scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths,
                               out, b, kvh, group, hd, num_pages, page_size,
                               pages_per_seq, sm_scale, stream);
}

// the "cluster" route; `splits` CTAs a (row, kv head), 1..8
extern "C" int paged_decode_split_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, int b, int kvh,
    int group, int hd, int num_pages, int page_size, int pages_per_seq,
    int splits, float sm_scale, void* stream) {
  return launch_split<float>(q, k_pages, v_pages, block_tables, lengths, out,
                             b, kvh, group, hd, num_pages, page_size,
                             pages_per_seq, splits, sm_scale, stream);
}

extern "C" int paged_decode_split_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, int b, int kvh,
    int group, int hd, int num_pages, int page_size, int pages_per_seq,
    int splits, float sm_scale, void* stream) {
  return launch_split<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                     lengths, out, b, kvh, group, hd,
                                     num_pages, page_size, pages_per_seq,
                                     splits, sm_scale, stream);
}
