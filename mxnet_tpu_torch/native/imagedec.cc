// Image decode + augment for mxnet_tpu_torch's ImageIter "native" route.
//
// Two parts, one source:
//
// * imgdec_plan (always built, no dependency): the per-image crop and
//   mirror decisions. The generator is keyed by IMAGE, (seed, stream
//   position), not by thread, so any thread count or schedule draws the
//   same decisions. The nvJPEG backend (ops/cuda/csrc/image_decode.cu)
//   decodes on the card and takes its plan from here.
// * the OpenCV backend (built with -DMXT_IMGDEC_OPENCV): a persistent
//   std::thread pool that decodes whole batches into a float32 CHW
//   buffer; ctypes releases the GIL for the call. It is the JAX
//   package's decoder (src/native/imagedec.cc), the crop and mirror now
//   drawn through plan_one, which takes the same draws in the same
//   order: the two give the same bits.
//
// Pipeline per image (mxnet_tpu_torch/image.py CreateAugmenter
// semantics): imdecode(BGR) -> RGB -> resize short side (INTER_CUBIC)
// -> random/center crop (resize when the source is smaller) ->
// optional horizontal mirror -> (x - mean) / std -> float32 CHW.
#include <cstdint>
#include <random>

namespace {

// The crop origin and mirror of the image at stream position ``pos``
// whose (resized) size is img_w x img_h; cw/ch are the crop's size, the
// output size clipped to the image (the caller resizes a smaller crop).
inline void plan_one(uint64_t seed, uint64_t pos, int img_w, int img_h,
                     int out_w, int out_h, int rand_crop, int rand_mirror,
                     int* x0, int* y0, int* cw, int* ch, bool* mirror) {
  std::mt19937_64 rng(seed ^ (0x9E3779B97F4A7C15ULL * (pos + 1)));
  *cw = out_w < img_w ? out_w : img_w;
  *ch = out_h < img_h ? out_h : img_h;
  if (rand_crop) {
    *x0 = (int)(rng() % (uint64_t)(img_w - *cw + 1));
    *y0 = (int)(rng() % (uint64_t)(img_h - *ch + 1));
  } else {
    *x0 = (img_w - *cw) / 2;
    *y0 = (img_h - *ch) / 2;
  }
  *mirror = rand_mirror &&
      ((rng() >> 11) * 0x1.0p-53 < 0.5);   // uniform [0,1) < p
}

}  // namespace

extern "C" {

// hw: n x (height, width) of the decoded images; plan: n x (x0, y0,
// mirror). Returns the index + 1 of the first image smaller than the
// output (its crop would need a resize), else 0.
int imgdec_plan(int n, const int32_t* hw, uint64_t base, uint64_t seed,
                int out_h, int out_w, int rand_crop, int rand_mirror,
                int32_t* plan) {
  int small = 0;
  for (int i = 0; i < n; ++i) {
    int x0, y0, cw, ch;
    bool mirror;
    plan_one(seed, base + (uint64_t)i, hw[2 * i + 1], hw[2 * i], out_w,
             out_h, rand_crop, rand_mirror, &x0, &y0, &cw, &ch, &mirror);
    plan[3 * i] = x0;
    plan[3 * i + 1] = y0;
    plan[3 * i + 2] = mirror ? 1 : 0;
    if ((cw != out_w || ch != out_h) && !small) small = i + 1;
  }
  return small;
}

}  // extern "C"

#ifdef MXT_IMGDEC_OPENCV

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
  int n = 0;
  const uint8_t* const* bufs = nullptr;
  const int64_t* lens = nullptr;
  uint64_t base = 0;        // stream position of bufs[0] (RNG key part)
  float* out = nullptr;
};

class Decoder {
 public:
  Decoder(int threads, int out_h, int out_w, int channels, int resize,
          int rand_crop, int rand_mirror, const float* mean,
          const float* stdv, uint64_t seed)
      : out_h_(out_h), out_w_(out_w), channels_(channels), resize_(resize),
        rand_crop_(rand_crop), rand_mirror_(rand_mirror), seed_(seed) {
    for (int c = 0; c < 3; ++c) {
      mean_[c] = 0.f;
      std_[c] = 1.f;
    }
    // grayscale callers pass 1-element mean/std buffers: only read
    // what the channel count guarantees exists
    int nc = channels == 1 ? 1 : 3;
    for (int c = 0; c < nc; ++c) {
      if (mean) mean_[c] = mean[c];
      if (stdv) std_[c] = stdv[c];
    }
    int nt = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    workers_.reserve(nt);
    for (int t = 0; t < nt; ++t)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Decoder() {
    {
      std::lock_guard<std::mutex> g(mu_);
      quit_ = true;
    }
    cv_job_.notify_all();
    for (auto& w : workers_) w.join();
  }

  int Decode(int n, const uint8_t* const* bufs, const int64_t* lens,
             uint64_t base, float* out) {
    if (n <= 0) return 0;
    {
      std::lock_guard<std::mutex> g(mu_);
      job_ = Job{n, bufs, lens, base, out};
      next_ = 0;
      pending_.store(n, std::memory_order_relaxed);
      failed_.store(0, std::memory_order_relaxed);
      epoch_++;
    }
    cv_job_.notify_all();
    {
      // wait until every image is done AND every worker has LEFT the
      // job (a worker still in its claim loop holds stale pointers and
      // must not race the next job's reset of next_/pending_)
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
  void WorkerLoop() {
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
          // claim under the job mutex, re-validating the epoch: a
          // worker that joined a job after Decode() returned must not
          // claim indices of the next job with this job's pointers
          std::lock_guard<std::mutex> g(mu_);
          if (epoch_ != seen) break;
          i = next_++;
        }
        if (i >= job.n) break;
        try {
          DecodeOne(job.bufs[i], job.lens[i], job.base + (uint64_t)i,
                    job.out + (size_t)i * channels_ * out_h_ * out_w_);
        } catch (const std::exception& e) {
          failed_.store(1, std::memory_order_relaxed);
          std::lock_guard<std::mutex> g(err_mu_);
          err_ = e.what();
        } catch (...) {
          failed_.store(1, std::memory_order_relaxed);
          std::lock_guard<std::mutex> g(err_mu_);
          err_ = "unknown decode error";
        }
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

  void DecodeOne(const uint8_t* buf, int64_t len, uint64_t pos, float* out) {
    cv::Mat raw(1, (int)len, CV_8UC1, const_cast<uint8_t*>(buf));
    cv::Mat img = cv::imdecode(
        raw, channels_ == 3 ? cv::IMREAD_COLOR : cv::IMREAD_GRAYSCALE);
    if (img.empty()) throw std::runtime_error("cannot decode image");
    if (channels_ == 3) cv::cvtColor(img, img, cv::COLOR_BGR2RGB);

    if (resize_ > 0) {
      int h = img.rows, w = img.cols, nh, nw;
      if (h > w) { nw = resize_; nh = (int)((int64_t)resize_ * h / w); }
      else       { nh = resize_; nw = (int)((int64_t)resize_ * w / h); }
      cv::resize(img, img, cv::Size(nw, nh), 0, 0, cv::INTER_CUBIC);
    }

    int x0, y0, cw, ch;
    bool mirror;
    plan_one(seed_, pos, img.cols, img.rows, out_w_, out_h_, rand_crop_,
             rand_mirror_, &x0, &y0, &cw, &ch, &mirror);
    cv::Mat crop = img(cv::Rect(x0, y0, cw, ch));
    if (cw != out_w_ || ch != out_h_)
      cv::resize(crop, crop, cv::Size(out_w_, out_h_), 0, 0,
                 cv::INTER_CUBIC);
    if (mirror) cv::flip(crop, crop, 1);

    // HWC uint8 -> CHW float32 with per-channel normalisation
    const int hw = out_h_ * out_w_;
    if (channels_ == 3) {
      for (int y = 0; y < out_h_; ++y) {
        const uint8_t* row = crop.ptr<uint8_t>(y);
        float* o0 = out + y * out_w_;
        float* o1 = o0 + hw;
        float* o2 = o1 + hw;
        for (int x = 0; x < out_w_; ++x) {
          o0[x] = (row[3 * x + 0] - mean_[0]) / std_[0];
          o1[x] = (row[3 * x + 1] - mean_[1]) / std_[1];
          o2[x] = (row[3 * x + 2] - mean_[2]) / std_[2];
        }
      }
    } else {
      for (int y = 0; y < out_h_; ++y) {
        const uint8_t* row = crop.ptr<uint8_t>(y);
        float* o = out + y * out_w_;
        for (int x = 0; x < out_w_; ++x)
          o[x] = (row[x] - mean_[0]) / std_[0];
      }
    }
  }

  const int out_h_, out_w_, channels_, resize_, rand_crop_, rand_mirror_;
  float mean_[3], std_[3];
  const uint64_t seed_;

  std::mutex mu_, err_mu_;
  std::condition_variable cv_job_, cv_done_;
  std::vector<std::thread> workers_;
  Job job_;
  uint64_t epoch_ = 0;
  int running_ = 0;
  int next_ = 0;                // guarded by mu_ (claims re-check epoch)
  bool quit_ = false;
  std::atomic<int> pending_{0}, failed_{0};
  std::string err_;
};

}  // namespace

extern "C" {

void* imgdec_create(int threads, int out_h, int out_w, int channels,
                    int resize, int rand_crop, int rand_mirror,
                    const float* mean, const float* stdv, uint64_t seed) {
  if (channels != 1 && channels != 3) return nullptr;
  try {
    return new Decoder(threads, out_h, out_w, channels, resize, rand_crop,
                       rand_mirror, mean, stdv, seed);
  } catch (...) {
    return nullptr;
  }
}

int imgdec_decode_batch(void* h, int n, const uint8_t* const* bufs,
                        const int64_t* lens, uint64_t base, float* out) {
  if (!h) return -1;
  return static_cast<Decoder*>(h)->Decode(n, bufs, lens, base, out);
}

const char* imgdec_last_error(void* h) {
  return h ? static_cast<Decoder*>(h)->Error() : "null decoder";
}

void imgdec_destroy(void* h) { delete static_cast<Decoder*>(h); }

}  // extern "C"

#endif  // MXT_IMGDEC_OPENCV
