// The nvJPEG backend of the image pipeline's "native" route: decode a
// batch of JPEG records on the card, then convert, crop, mirror,
// normalise and lay out the whole batch in one kernel.
//
// The JAX package decodes and augments on host threads with OpenCV
// (src/native/imagedec.cc, the reference's OMP ParseChunk), whose JPEG
// decoder is libjpeg-turbo. There is no TPU kernel here: the decode was
// host work on the TPU.
//
// * Decode: a pool of host threads, each with its own nvJPEG state and
//   CUDA stream, decodes one image at a time (nvjpegDecode: Huffman on
//   the host, the rest on the card) to its component planes, Y then Cb
//   and Cr at their subsampled size (NVJPEG_OUTPUT_YUV; Y alone for a
//   grayscale JPEG or a one-channel output), in a flat device buffer the
//   caller allocated, at the offsets it gave. nvJPEG's own RGB output
//   upsamples chroma otherwise than libjpeg-turbo (2.6 levels apart on
//   average at 4:2:0); its planes differ from libjpeg-turbo's only by
//   the inverse DCT's rounding. Before writing, every pool stream waits
//   for an event recorded on the caller's stream, so the buffer's
//   previous use by that stream (the caching allocator reuses freed
//   blocks in stream order) is complete; each image is synchronised on
//   its pool stream before the thread takes the next (its state's host
//   buffers are then free), and the call returns when every image is
//   written.
// * crop_mirror_normalize_kernel: for each output pixel of each image,
//   the source pixel of its crop (the plan's x0, y0 and mirror, drawn on
//   the host by native/imagedec.cc's imgdec_plan, keyed by (seed, stream
//   position)), its chroma upsampled as libjpeg-turbo's "fancy"
//   upsampling does (jdsample.c: h2v1 and h2v2 triangular filters with
//   their rounding constants, edges replicated; plain replication where
//   a plane is at most 2 samples wide), converted to RGB with
//   libjpeg-turbo's integer tables (jdcolor.c, 16 fraction bits), then
//   `(v - mean[c]) / std[c]` (__fsub_rn, __fdiv_rn: correctly rounded)
//   in float32 NCHW, one thread a pixel, all channels. It gives the
//   plain version's bits. Bound: bytes (the crop's samples read once,
//   the output written once).
#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace mxt {
namespace img {

constexpr int kThreads = 256;

// item columns: byte offset of the image's planes in src, height,
// width, x0, y0, mirror, kind, chroma height, chroma width
constexpr int kItem = 9;
// kind: the layout of the image's planes
enum Kind { kGray = 0, k444 = 1, k422 = 2, k420 = 3 };

// one chroma sample at full resolution (row sy, column sx) of the plane
// c (ch x cw) of an image of `kind`, as libjpeg-turbo upsamples it
__device__ __forceinline__ int chroma(const uint8_t* __restrict__ c,
                                      int kind, int ch, int cw, int sy,
                                      int sx) {
  if (kind == k444) return c[(long long)sy * cw + sx];
  const int cc = sx >> 1, odd = sx & 1;
  const int nb = odd ? min(cc + 1, cw - 1) : max(cc - 1, 0);
  if (kind == k422) {
    const uint8_t* row = c + (long long)sy * cw;
    if (cw <= 2) return row[cc];
    return (3 * row[cc] + row[nb] + (odd ? 2 : 1)) >> 2;
  }
  const int near = sy >> 1;
  if (cw <= 2) return c[(long long)near * cw + cc];
  const int far = (sy & 1) ? min(near + 1, ch - 1) : max(near - 1, 0);
  const uint8_t* r0 = c + (long long)near * cw;
  const uint8_t* r1 = c + (long long)far * cw;
  const int cs = 3 * r0[cc] + r1[cc];
  const int cn = 3 * r0[nb] + r1[nb];
  return (3 * cs + cn + (odd ? 7 : 8)) >> 4;
}

__device__ __forceinline__ float norm(int v, float m, float s) {
  return __fdiv_rn(__fsub_rn((float)v, m), s);
}

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__global__ void __launch_bounds__(kThreads)
    crop_mirror_normalize_kernel(const uint8_t* __restrict__ src,
                                 const long long* __restrict__ items,
                                 int channels, int out_h, int out_w,
                                 float m0, float m1, float m2, float s0,
                                 float s1, float s2,
                                 float* __restrict__ out) {
  const int img = blockIdx.y;
  const long long* it = items + (size_t)img * kItem;
  const uint8_t* yp = src + it[0];
  const int h = (int)it[1], w = (int)it[2];
  const int x0 = (int)it[3], y0 = (int)it[4], mirror = (int)it[5];
  const int kind = (int)it[6], ch = (int)it[7], cw = (int)it[8];
  const uint8_t* cb = yp + (long long)h * w;
  const uint8_t* cr = cb + (long long)ch * cw;
  const int hw = out_h * out_w;
  float* o = out + (size_t)img * channels * hw;
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < hw;
       p += gridDim.x * kThreads) {
    const int y = p / out_w;
    const int x = p - y * out_w;
    const int sy = y0 + y;
    const int sx = x0 + (mirror ? out_w - 1 - x : x);
    const int yv = yp[(long long)sy * w + sx];
    if (channels == 1) {
      o[p] = norm(yv, m0, s0);
      continue;
    }
    int r = yv, g = yv, b = yv;
    if (kind != kGray) {
      const int u = chroma(cb, kind, ch, cw, sy, sx) - 128;
      const int v = chroma(cr, kind, ch, cw, sy, sx) - 128;
      // jdcolor.c ycc_rgb_convert: FIX(x) = x * 2^16 rounded
      r = clamp255(yv + ((91881 * v + 32768) >> 16));
      g = clamp255(yv + ((-22554 * u + 32768 - 46802 * v) >> 16));
      b = clamp255(yv + ((116130 * u + 32768) >> 16));
    }
    o[p] = norm(r, m0, s0);
    o[hw + p] = norm(g, m1, s1);
    o[2 * hw + p] = norm(b, m2, s2);
  }
}

struct Job {
  int n = 0;
  const uint8_t* const* bufs = nullptr;
  const int64_t* lens = nullptr;
  uint8_t* dst = nullptr;
  const int64_t* offsets = nullptr;
  const int32_t* info = nullptr;   // n x (h, w, ncomp, css, ch, cw)
};

class Pool {
 public:
  Pool(int threads, int device, int channels)
      : device_(device), channels_(channels) {
    // the calling thread's current device is restored on the way out
    int prev = 0;
    cudaGetDevice(&prev);
    struct Restore {
      int dev;
      ~Restore() { cudaSetDevice(dev); }
    } restore{prev};
    cudaError_t ce = cudaSetDevice(device);
    if (ce != cudaSuccess) throw_cuda("cudaSetDevice", ce);
    nvjpegStatus_t st = nvjpegCreateSimple(&handle_);
    if (st != NVJPEG_STATUS_SUCCESS) throw_nvjpeg("nvjpegCreateSimple", st);
    ce = cudaEventCreateWithFlags(&start_, cudaEventDisableTiming);
    if (ce != cudaSuccess) throw_cuda("cudaEventCreate", ce);
    int nt = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    states_.resize(nt, nullptr);
    streams_.resize(nt, nullptr);
    for (int t = 0; t < nt; ++t) {
      st = nvjpegJpegStateCreate(handle_, &states_[t]);
      if (st != NVJPEG_STATUS_SUCCESS)
        throw_nvjpeg("nvjpegJpegStateCreate", st);
      ce = cudaStreamCreateWithFlags(&streams_[t], cudaStreamNonBlocking);
      if (ce != cudaSuccess) throw_cuda("cudaStreamCreate", ce);
    }
    workers_.reserve(nt);
    for (int t = 0; t < nt; ++t)
      workers_.emplace_back([this, t] { WorkerLoop(t); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      quit_ = true;
    }
    cv_job_.notify_all();
    for (auto& w : workers_) w.join();
    for (auto s : states_)
      if (s) nvjpegJpegStateDestroy(s);
    for (auto s : streams_)
      if (s) cudaStreamDestroy(s);
    if (start_) cudaEventDestroy(start_);
    if (handle_) nvjpegDestroy(handle_);
  }

  // n x (height, width, components, nvjpegChromaSubsampling_t, chroma
  // height, chroma width) of n JPEG buffers, without decoding them
  int Info(int n, const uint8_t* const* bufs, const int64_t* lens,
           int32_t* info) {
    for (int i = 0; i < n; ++i) {
      int ncomp = 0;
      nvjpegChromaSubsampling_t sub;
      int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
      nvjpegStatus_t st = nvjpegGetImageInfo(handle_, bufs[i],
                                             (size_t)lens[i], &ncomp, &sub,
                                             widths, heights);
      if (st != NVJPEG_STATUS_SUCCESS || widths[0] <= 0 ||
          heights[0] <= 0) {
        set_error("image " + std::to_string(i) +
                  " of the batch: nvjpegGetImageInfo failed (status " +
                  std::to_string((int)st) + "): not a JPEG nvJPEG reads");
        return -1;
      }
      int32_t* row = info + 6 * i;
      row[0] = heights[0];
      row[1] = widths[0];
      row[2] = ncomp;
      row[3] = (int32_t)sub;
      row[4] = ncomp > 1 ? heights[1] : 0;
      row[5] = ncomp > 1 ? widths[1] : 0;
    }
    return 0;
  }

  int Decode(int n, const uint8_t* const* bufs, const int64_t* lens,
             uint8_t* dst, const int64_t* offsets, const int32_t* info,
             cudaStream_t caller) {
    if (n <= 0) return 0;
    cudaError_t ce = cudaEventRecord(start_, caller);
    if (ce != cudaSuccess) {
      set_error(std::string("cudaEventRecord: ") + cudaGetErrorString(ce));
      return -1;
    }
    {
      std::lock_guard<std::mutex> g(mu_);
      job_ = Job{n, bufs, lens, dst, offsets, info};
      next_ = 0;
      pending_.store(n, std::memory_order_relaxed);
      failed_.store(0, std::memory_order_relaxed);
      epoch_++;
    }
    cv_job_.notify_all();
    {
      std::unique_lock<std::mutex> g(mu_);
      cv_done_.wait(g, [this] {
        return pending_.load(std::memory_order_acquire) == 0 &&
               running_ == 0;
      });
    }
    return failed_.load(std::memory_order_relaxed) ? -1 : 0;
  }

  const char* Error() {
    std::lock_guard<std::mutex> g(err_mu_);
    return err_.c_str();
  }

 private:
  [[noreturn]] static void throw_cuda(const char* what, cudaError_t e) {
    throw std::runtime_error(std::string(what) + ": " +
                             cudaGetErrorString(e));
  }
  [[noreturn]] static void throw_nvjpeg(const char* what, nvjpegStatus_t s) {
    throw std::runtime_error(std::string(what) + " failed (status " +
                             std::to_string((int)s) + ")");
  }

  void set_error(const std::string& msg) {
    failed_.store(1, std::memory_order_relaxed);
    std::lock_guard<std::mutex> g(err_mu_);
    err_ = msg;
  }

  void WorkerLoop(int t) {
    cudaSetDevice(device_);
    uint64_t seen = 0;
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_job_.wait(g, [&] { return quit_ || epoch_ != seen; });
        if (quit_) return;
        seen = epoch_;
        job = job_;
        running_++;
      }
      for (;;) {
        int i;
        {
          std::lock_guard<std::mutex> g(mu_);
          if (epoch_ != seen) break;
          i = next_++;
        }
        if (i >= job.n) break;
        DecodeOne(t, job, i);
        pending_.fetch_sub(1, std::memory_order_acq_rel);
      }
      {
        std::lock_guard<std::mutex> g(mu_);
        if (--running_ == 0 &&
            pending_.load(std::memory_order_acquire) == 0)
          cv_done_.notify_all();
      }
    }
  }

  void DecodeOne(int t, const Job& job, int i) {
    cudaStream_t s = streams_[t];
    cudaError_t ce = cudaStreamWaitEvent(s, start_, 0);
    if (ce != cudaSuccess) {
      set_error(std::string("cudaStreamWaitEvent: ") +
                cudaGetErrorString(ce));
      return;
    }
    // the planes: Y, then Cb and Cr of a colour image decoded for a
    // 3-channel output
    const int32_t* row = job.info + 6 * i;
    const bool planar = channels_ == 3 && row[2] > 1;
    nvjpegImage_t out;
    std::memset(&out, 0, sizeof(out));
    uint8_t* y = job.dst + job.offsets[i];
    out.channel[0] = y;
    out.pitch[0] = (size_t)row[1];
    if (planar) {
      const size_t cplane = (size_t)row[4] * row[5];
      out.channel[1] = y + (size_t)row[0] * row[1];
      out.channel[2] = out.channel[1] + cplane;
      out.pitch[1] = out.pitch[2] = (size_t)row[5];
    }
    nvjpegStatus_t st = nvjpegDecode(
        handle_, states_[t], job.bufs[i], (size_t)job.lens[i],
        planar ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_Y, &out, s);
    if (st != NVJPEG_STATUS_SUCCESS) {
      set_error("image " + std::to_string(i) +
                " of the batch: nvjpegDecode failed (status " +
                std::to_string((int)st) + ")");
      cudaStreamSynchronize(s);
      return;
    }
    ce = cudaStreamSynchronize(s);
    if (ce != cudaSuccess)
      set_error(std::string("image ") + std::to_string(i) +
                " of the batch: " + cudaGetErrorString(ce));
  }

  const int device_, channels_;
  nvjpegHandle_t handle_ = nullptr;
  cudaEvent_t start_ = nullptr;
  std::vector<nvjpegJpegState_t> states_;
  std::vector<cudaStream_t> streams_;

  std::mutex mu_, err_mu_;
  std::condition_variable cv_job_, cv_done_;
  std::vector<std::thread> workers_;
  Job job_;
  uint64_t epoch_ = 0;
  int running_ = 0;
  int next_ = 0;
  bool quit_ = false;
  std::atomic<int> pending_{0}, failed_{0};
  std::string err_;
};

std::mutex g_create_mu;
std::string g_create_error;

}  // namespace img
}  // namespace mxt

using mxt::img::Pool;

// The nvJPEG decode pool: `threads` host threads (0: one a core) on
// `device`, `channels` 3 (RGB) or 1 (Y). Null on failure
// (imgdec_nv_create_error says why).
extern "C" void* imgdec_nv_create(int threads, int device, int channels) {
  try {
    if (channels != 1 && channels != 3)
      throw std::runtime_error("channels must be 1 or 3");
    return new Pool(threads, device, channels);
  } catch (const std::exception& e) {
    std::lock_guard<std::mutex> g(mxt::img::g_create_mu);
    mxt::img::g_create_error = e.what();
    return nullptr;
  }
}

extern "C" const char* imgdec_nv_create_error() {
  std::lock_guard<std::mutex> g(mxt::img::g_create_mu);
  return mxt::img::g_create_error.c_str();
}

// info: n x (height, width, components, subsampling, chroma height,
// chroma width)
extern "C" int imgdec_nv_info(void* h, int n, const uint8_t* const* bufs,
                              const int64_t* lens, int32_t* info) {
  return static_cast<Pool*>(h)->Info(n, bufs, lens, info);
}

// Decode n images into dst + offsets[i]: the Y plane (height x width),
// then for a colour image and a 3-channel pool the Cb and Cr planes
// (chroma height x chroma width each), `info` as imgdec_nv_info gave it;
// returns when all are written. 0 or -1.
extern "C" int imgdec_nv_decode(void* h, int n, const uint8_t* const* bufs,
                                const int64_t* lens, void* dst,
                                const int64_t* offsets, const int32_t* info,
                                void* stream) {
  return static_cast<Pool*>(h)->Decode(n, bufs, lens,
                                       static_cast<uint8_t*>(dst), offsets,
                                       info,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* imgdec_nv_last_error(void* h) {
  return static_cast<Pool*>(h)->Error();
}

extern "C" void imgdec_nv_destroy(void* h) { delete static_cast<Pool*>(h); }

// src: the decoded planes; items: n x kItem int64 on the card (see the
// kernel); mean, std: `channels` floats on the host; out: float32
// (n, channels, out_h, out_w). Returns a cudaError_t.
extern "C" int crop_mirror_normalize(const void* src, const void* items,
                                     int n, int channels, int out_h,
                                     int out_w, const float* mean,
                                     const float* stdv, void* out,
                                     void* stream) {
  using namespace mxt::img;
  if (n <= 0) return 0;
  const int hw = out_h * out_w;
  dim3 grid((hw + kThreads - 1) / kThreads, n);
  const float m1 = channels == 3 ? mean[1] : 0.f;
  const float m2 = channels == 3 ? mean[2] : 0.f;
  const float s1 = channels == 3 ? stdv[1] : 1.f;
  const float s2 = channels == 3 ? stdv[2] : 1.f;
  crop_mirror_normalize_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src),
      static_cast<const long long*>(items), channels, out_h, out_w, mean[0],
      m1, m2, stdv[0], s1, s2, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
