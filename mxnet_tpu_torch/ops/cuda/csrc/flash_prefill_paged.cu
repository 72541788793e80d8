// Paged flash prefill for Hopper (sm_90a).
//
// Replaces mxnet_tpu/ops/pallas/flash_attention.py `_prefill_kernel`
// (launched by `_flash_prefill`, entry `flash_prefill_paged`): causal
// GQA attention over a whole prompt bucket, scale 1/sqrt(head_dim),
// plus the epilogue that writes the prompt's K/V rows into the
// block-table pages of the KV pool, in place.
//
// Layouts (all contiguous):
//   q            (b, s, n_heads, head_dim)             T
//   kg, vg       (b, s, kv_heads, head_dim)            T
//   k/v_pages    (num_pages, page_size, kv_heads, head_dim)  T, updated
//   block_tables (b, bt_stride) int32; position p of row r goes to page
//                block_tables[r, p / page_size], offset p % page_size
//   out          (b, s, n_heads, head_dim)             T
//
// Bound: at the serving widths (s <= 256, head_dim 64) memory and
// compute are close: 2 * n_heads * head_dim * s * (s + 1) flops (the
// causal half of QK^T and PV) against reading q/kg/vg and writing out
// plus the page rows once; both are well under a microsecond, so a
// call's time is latency: the launch, the dependent loads, and the
// serial chain of products in each CTA.
//
// Two routes, picked by the wrapper from the shapes before the launch:
//
// "mma" (flash_prefill_mma_kernel; bfloat16, head_dim 32, 64 or 128,
// group = n_heads / kv_heads <= 16, 16-byte aligned tensors). One CTA
// per (q tile, kv head, row) computes every query head of the group for
// its qt positions (qt = 8, or 16 when group is 1): its qt * group
// (position, head) rows share the kv head's keys, so the causal K/V
// prefix is loaded into shared memory once for all of them, in 64-key
// blocks by cp.async (16 bytes a lane), up to four blocks in flight, all
// of them issued before the first product at s <= 256. Each warp owns
// 16 rows: QK^T and PV run on the tensor cores (mma.sync m16n8k16, bf16
// in, float32 sums; fragments by ldmatrix from rows padded by 16 bytes,
// V transposed by ldmatrix.trans), the online softmax stays in registers
// in the FA2 layout (a quad of lanes a row), and P is rounded to bf16
// for the second product. At s = 128 the grid holds 64 CTAs. The output
// leaves through shared memory in 16-byte stores, as does the page
// write. mma.sync rather than wgmma: a 64-row wgmma tile would hold 16
// positions x 4 heads per CTA, halving the grid at s = 128 and padding
// the causal diagonal, for products that take a few microseconds either
// way.
//
// "fma" (flash_prefill_kernel, the first design; float32, where tensor
// cores would mean TF32 and change the numbers, and any other bf16
// shape): one CTA per (16-row q tile, query head, row), float32 FMAs on
// the CUDA cores over 16-key tiles staged in shared memory.
//
// Page write (both routes): on the TPU it rode the sequential grid (the
// h == 0, qi == 0 visit of each k block). CUDA blocks run in no order,
// so here exactly one CTA writes each (row, position, kv head): the CTA
// of that position's q tile (on the "fma" route, the one whose query
// head is the first of its group) copies the K/V rows into the pool.
// The kernels read kg/vg and never the pages, so no read-after-write
// hazard arises; pages no row names keep their contents. When a block
// table repeats a page (only the reserved null page 0, in warmup
// batches) several CTAs write it and which write survives is
// unspecified: unlike the JAX package's interpreter and scatter (last
// write wins), these kernels promise nothing about page 0, and no served
// result reads it.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 16;  // query rows per CTA
constexpr int kBK = 16;  // keys per tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kg,
                     const T* __restrict__ vg, T* __restrict__ k_pages,
                     T* __restrict__ v_pages,
                     const int* __restrict__ block_tables,
                     T* __restrict__ out, int s, int nh, int kvh, int hd,
                     int num_pages, int page_size, int bt_stride,
                     float sm_scale) {
  extern __shared__ float smem[];
  const int qi = blockIdx.x;
  const int h = blockIdx.y;
  const int row = blockIdx.z;
  const int groups = nh / kvh;
  const int kh = h / groups;
  const int q_start = qi * kBQ;
  const int q_rows = min(kBQ, s - q_start);
  const int hdp = hd + 1;  // padded K row
  const int tid = threadIdx.x;
  const size_t kv_tok = static_cast<size_t>(kvh) * hd;
  const T* kg_row = kg + static_cast<size_t>(row) * s * kv_tok + kh * hd;
  const T* vg_row = vg + static_cast<size_t>(row) * s * kv_tok + kh * hd;

  // -- page-write epilogue (independent of the attention below) --------
  if (h % groups == 0) {
    for (int i = tid; i < q_rows * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      const int pos = q_start + r;
      const int page = mxt::clamp_page(
          block_tables[static_cast<size_t>(row) * bt_stride +
                       pos / page_size],
          num_pages);
      const size_t dst =
          (static_cast<size_t>(page) * page_size + pos % page_size) *
              kv_tok +
          kh * hd + d;
      const size_t src = pos * kv_tok + d;
      k_pages[dst] = kg_row[src];
      v_pages[dst] = vg_row[src];
    }
  }

  // -- causal online-softmax attention ---------------------------------
  float* q_s = smem;                // kBQ * hd, pre-scaled
  float* k_s = q_s + kBQ * hd;      // kBK * hdp
  float* v_s = k_s + kBK * hdp;     // kBK * hd
  float* p_s = v_s + kBK * hd;      // kBQ * kBK
  float* acc = p_s + kBQ * kBK;     // kBQ * hd
  float* m_s = acc + kBQ * hd;      // kBQ
  float* l_s = m_s + kBQ;           // kBQ
  float* a_s = l_s + kBQ;           // kBQ

  const size_t q_tok = static_cast<size_t>(nh) * hd;
  const T* q_base = q + static_cast<size_t>(row) * s * q_tok + h * hd;
  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    q_s[i] = r < q_rows
                 ? mxt::to_f32(q_base[(q_start + r) * q_tok + d]) * sm_scale
                 : 0.f;
    acc[i] = 0.f;
  }
  for (int i = tid; i < kBQ; i += kThreads) {
    m_s[i] = mxt::kNegInf;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int k_end = min(s, q_start + kBQ);  // keys <= the last query row
  for (int k_start = 0; k_start < k_end; k_start += kBK) {
    const int k_rows = min(kBK, s - k_start);
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      float kv = 0.f, vv = 0.f;
      if (t < k_rows) {
        const size_t src = (k_start + t) * kv_tok + d;
        kv = mxt::to_f32(kg_row[src]);
        vv = mxt::to_f32(vg_row[src]);
      }
      k_s[t * hdp + d] = kv;
      v_s[i] = vv;
    }
    __syncthreads();

    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK;
      const int t = i - r * kBK;
      const int kpos = k_start + t;
      const float* qv = q_s + r * hd;
      const float* kv = k_s + t * hdp;
      float sc = 0.f;
      for (int d = 0; d < hd; ++d) sc = fmaf(qv[d], kv[d], sc);
      p_s[i] = (kpos < s && kpos <= q_start + r) ? sc : mxt::kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < kBQ; r += kThreads) {
      float* pr = p_s + r * kBK;
      float mx = mxt::kNegInf;
      for (int t = 0; t < kBK; ++t) mx = fmaxf(mx, pr[t]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < kBK; ++t) {
        const float e = expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < kBQ * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      const float* pr = p_s + r * kBK;
      float pv = 0.f;
      for (int t = 0; t < kBK; ++t) pv = fmaf(pr[t], v_s[t * hd + d], pv);
      acc[i] = acc[i] * a_s[r] + pv;
    }
    __syncthreads();
  }

  T* o_base = out + static_cast<size_t>(row) * s * q_tok + h * hd;
  for (int i = tid; i < q_rows * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const float l = l_s[r];
    o_base[(q_start + r) * q_tok + d] =
        mxt::from_f32<T>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T>
int launch(const void* q, const void* kg, const void* vg, void* k_pages,
           void* v_pages, const void* block_tables, void* out, int b, int s,
           int nh, int kvh, int hd, int num_pages, int page_size,
           int bt_stride, float sm_scale, void* stream) {
  const size_t smem = sizeof(float) * (2 * kBQ * hd + kBK * (2 * hd + 1) +
                                       kBQ * kBK + 3 * kBQ);
  cudaError_t err = mxt::allow_smem(flash_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, nh, b);
  flash_prefill_kernel<T><<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(kg),
      static_cast<const T*>(vg), static_cast<T*>(k_pages),
      static_cast<T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<T*>(out), s, nh, kvh, hd, num_pages, page_size, bt_stride,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the "mma" route (bfloat16, tensor cores)
// ---------------------------------------------------------------------------

constexpr int kKB = 64;        // keys a block
constexpr int kMaxStages = 4;  // key blocks in flight
constexpr int kMaxWarps = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 float32. Lane
// l = 4 g + c holds d rows g (d[0], d[1]) and g + 8 (d[2], d[3]), columns
// 2c and 2c + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Grid (ceil(s / qt), kv_heads, b), 32 * warps threads. CTA row r (of
// qt * group, padded to 16 * warps) is position q0 + r % qt of query
// head kh * group + r / qt.
template <int HD>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kg,
                         const __nv_bfloat16* __restrict__ vg,
                         __nv_bfloat16* __restrict__ k_pages,
                         __nv_bfloat16* __restrict__ v_pages,
                         const int* __restrict__ block_tables,
                         __nv_bfloat16* __restrict__ out, int s, int nh,
                         int kvh, int num_pages, int page_size, int bt_stride,
                         int qt, int stages, float scale_log2) {
  constexpr int kLd = HD + 8;     // padded smem row (bf16), 16 B apart
  constexpr int kSegs = HD / 8;   // 16-byte segments of a row
  constexpr int kK = HD / 16;     // k steps of QK^T
  constexpr int kN = HD / 8;      // n tiles of PV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using bf16 = __nv_bfloat16;
  const int qi = blockIdx.x;
  const int kh = blockIdx.y;
  const int row = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warps = nthreads / 32;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = nh / kvh;
  const int q0 = qi * qt;
  const int q_rows = min(qt, s - q0);        // positions of this tile
  const int kend = min(s, q0 + qt);          // keys <= the last position
  const int nkb = (kend + kKB - 1) / kKB;
  const int rows = 16 * warps;
  const size_t kv_tok = static_cast<size_t>(kvh) * HD;
  const size_t q_tok = static_cast<size_t>(nh) * HD;
  const bf16* kg_row = kg + static_cast<size_t>(row) * s * kv_tok + kh * HD;
  const bf16* vg_row = vg + static_cast<size_t>(row) * s * kv_tok + kh * HD;
  const bf16* q_row = q + static_cast<size_t>(row) * s * q_tok +
                      static_cast<size_t>(kh) * group * HD;
  bf16* o_row = out + static_cast<size_t>(row) * s * q_tok +
                static_cast<size_t>(kh) * group * HD;

  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // rows x kLd
  bf16* kv_s = q_s + rows * kLd;                    // stages x (K, V)
  const int stage_elems = 2 * kKB * kLd;

  // q rows, zero-filled past the tile's positions and the group's heads
  for (int i = tid; i < rows * kSegs; i += nthreads) {
    const int r = i / kSegs;
    const int sg = i - r * kSegs;
    const int pos = q0 + r % qt;
    const int j = r / qt;
    const bool ok = j < group && pos < s;
    const bf16* src = ok ? q_row + pos * q_tok + j * HD + sg * 8 : q;
    mxt::cp_async16(q_s + r * kLd + sg * 8, src, ok ? 16 : 0);
  }
  auto stage_block = [&](int blk) {
    bf16* ks = kv_s + (blk % stages) * stage_elems;
    bf16* vs = ks + kKB * kLd;
    for (int i = tid; i < kKB * kSegs; i += nthreads) {
      const int t = i / kSegs;
      const int sg = i - t * kSegs;
      const int key = blk * kKB + t;
      const bool ok = key < kend;
      const size_t src = static_cast<size_t>(ok ? key : 0) * kv_tok + sg * 8;
      mxt::cp_async16(ks + t * kLd + sg * 8, kg_row + src, ok ? 16 : 0);
      mxt::cp_async16(vs + t * kLd + sg * 8, vg_row + src, ok ? 16 : 0);
    }
  };
  // one commit group a stage, empty ones included, so that block j is
  // always group j
  for (int blk = 0; blk < stages; ++blk) {
    if (blk < nkb) stage_block(blk);
    mxt::cp_async_commit();
  }

  // -- page write: this tile's positions of kv head kh, 16 bytes a lane
  for (int i = tid; i < q_rows * kSegs; i += nthreads) {
    const int r = i / kSegs;
    const int sg = i - r * kSegs;
    const int pos = q0 + r;
    const int page = mxt::clamp_page(
        block_tables[static_cast<size_t>(row) * bt_stride + pos / page_size],
        num_pages);
    const size_t dst =
        (static_cast<size_t>(page) * page_size + pos % page_size) * kv_tok +
        kh * HD + sg * 8;
    const size_t src = pos * kv_tok + sg * 8;
    *reinterpret_cast<uint4*>(k_pages + dst) =
        __ldg(reinterpret_cast<const uint4*>(kg_row + src));
    *reinterpret_cast<uint4*>(v_pages + dst) =
        __ldg(reinterpret_cast<const uint4*>(vg_row + src));
  }

  const int g = lane >> 2;
  const int c = lane & 3;
  const int lm = lane >> 3;  // ldmatrix: the 8x8 matrix this lane addresses
  const int lr = lane & 7;   // and its row there
  const int r0 = 16 * warp + g;
  const int pos0 = q0 + r0 % qt;
  const int pos1 = q0 + (r0 + 8) % qt;

  uint32_t qa[kK][4];
  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = mxt::kNegInf, m1 = mxt::kNegInf, l0 = 0.f, l1 = 0.f;

  for (int blk = 0; blk < nkb; ++blk) {
    switch (stages) {  // block blk is committed group blk
      case 1: mxt::cp_async_wait<0>(); break;
      case 2: mxt::cp_async_wait<1>(); break;
      case 3: mxt::cp_async_wait<2>(); break;
      default: mxt::cp_async_wait<3>(); break;
    }
    __syncthreads();
    if (blk == 0) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
        ldsm_x4(qa[kk], q_s + (16 * warp + (lm & 1) * 8 + lr) * kLd +
                            16 * kk + (lm >> 1) * 8);
    }
    const bf16* ks = kv_s + (blk % stages) * stage_elems;
    const bf16* vs = ks + kKB * kLd;

    // S = Q K^T over the block's 64 keys: 8 n tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ks + (16 * np + (lm >> 1) * 8 + lr) * kLd + 16 * kk +
                       (lm & 1) * 8);
        mma_bf16(sc[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }
    // scale (log2 units), causal mask, online softmax in registers
    float mx0 = mxt::kNegInf, mx1 = mxt::kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int key = blk * kKB + 8 * n + 2 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = key + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        const float v = kpos <= pos ? sc[n][e] * scale_log2 : mxt::kNegInf;
        sc[n][e] = v;
        if (e < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[n][0] = exp2f(sc[n][0] - mn0);
      sc[n][1] = exp2f(sc[n][1] - mn0);
      sc[n][2] = exp2f(sc[n][2] - mn1);
      sc[n][3] = exp2f(sc[n][3] - mn1);
      s0 += sc[n][0] + sc[n][1];
      s1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    // O += P V: P (bf16) from the score registers, V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kN / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + (16 * kk + (lm & 1) * 8 + lr) * kLd + 16 * dp +
                         (lm >> 1) * 8);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (blk + stages < nkb) stage_block(blk + stages);
    mxt::cp_async_commit();
  }

  // normalise; stage this warp's 16 rows in q_s, then 16-byte stores
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float i1 = 1.f / (l1 == 0.f ? 1.f : l1);
  bf16* w_s = q_s + 16 * warp * kLd;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    *reinterpret_cast<uint32_t*>(w_s + g * kLd + 8 * n + 2 * c) =
        pack_bf16x2(o[n][0] * i0, o[n][1] * i0);
    *reinterpret_cast<uint32_t*>(w_s + (g + 8) * kLd + 8 * n + 2 * c) =
        pack_bf16x2(o[n][2] * i1, o[n][3] * i1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kSegs; i += 32) {
    const int rr = i / kSegs;
    const int sg = i - rr * kSegs;
    const int r = 16 * warp + rr;
    const int pos = q0 + r % qt;
    const int j = r / qt;
    if (j < group && pos < s)
      *reinterpret_cast<uint4*>(o_row + pos * q_tok + j * HD + sg * 8) =
          *reinterpret_cast<const uint4*>(w_s + rr * kLd + sg * 8);
  }
}

template <int HD>
int launch_mma_hd(const void* q, const void* kg, const void* vg,
                  void* k_pages, void* v_pages, const void* block_tables,
                  void* out, int b, int s, int nh, int kvh, int num_pages,
                  int page_size, int bt_stride, float sm_scale,
                  cudaStream_t stream) {
  const int group = nh / kvh;
  const int qt = group == 1 ? 16 : 8;
  const int warps = (qt * group + 15) / 16;
  if (warps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const int nkb_max = (s + kKB - 1) / kKB;
  const int stages = min(nkb_max, kMaxStages);
  const size_t smem = sizeof(__nv_bfloat16) * (HD + 8) *
                      (16 * warps + 2 * kKB * static_cast<size_t>(stages));
  auto kernel = flash_prefill_mma_kernel<HD>;
  cudaError_t err = mxt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + qt - 1) / qt, kvh, b);
  // exp2 of scores in log2 units: scale * log2(e)
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kg),
      static_cast<const __nv_bfloat16*>(vg),
      static_cast<__nv_bfloat16*>(k_pages),
      static_cast<__nv_bfloat16*>(v_pages),
      static_cast<const int*>(block_tables),
      static_cast<__nv_bfloat16*>(out), s, nh, kvh, num_pages, page_size,
      bt_stride, qt, stages, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes; each returns the cudaError_t of the
// launch (0 = launched).
extern "C" int flash_prefill_paged_f32(
    const void* q, const void* kg, const void* vg, void* k_pages,
    void* v_pages, const void* block_tables, void* out, int b, int s, int nh,
    int kvh, int hd, int num_pages, int page_size, int bt_stride,
    float sm_scale, void* stream) {
  return launch<float>(q, kg, vg, k_pages, v_pages, block_tables, out, b, s,
                       nh, kvh, hd, num_pages, page_size, bt_stride, sm_scale,
                       stream);
}

extern "C" int flash_prefill_paged_bf16(
    const void* q, const void* kg, const void* vg, void* k_pages,
    void* v_pages, const void* block_tables, void* out, int b, int s, int nh,
    int kvh, int hd, int num_pages, int page_size, int bt_stride,
    float sm_scale, void* stream) {
  return launch<__nv_bfloat16>(q, kg, vg, k_pages, v_pages, block_tables,
                               out, b, s, nh, kvh, hd, num_pages, page_size,
                               bt_stride, sm_scale, stream);
}

// the "mma" route: bfloat16, head_dim 32, 64 or 128, group <= 16
extern "C" int flash_prefill_mma_bf16(
    const void* q, const void* kg, const void* vg, void* k_pages,
    void* v_pages, const void* block_tables, void* out, int b, int s, int nh,
    int kvh, int hd, int num_pages, int page_size, int bt_stride,
    float sm_scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto fn = hd == 32   ? launch_mma_hd<32>
                  : hd == 64 ? launch_mma_hd<64>
                  : hd == 128 ? launch_mma_hd<128>
                              : nullptr;
  if (fn == nullptr || kvh < 1 || nh % kvh)
    return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, kg, vg, k_pages, v_pages, block_tables, out, b, s, nh, kvh,
            num_pages, page_size, bt_stride, sm_scale, st);
}
