// cc_tpu_torch native data plane: JPEG/PNG decode + joint augmentation + collate.
// A copy of cc_tpu/native/dataplane.cpp (ABI version 4): the port imports
// nothing of cc_tpu, so it builds its own.
//
// The equivalent of the reference's torch DataLoader worker
// processes (reference train.py:228-233): the heavy pixel work (decode,
// rotate, flip, scale-crop, normalize) runs here in C++ on OpenCV mats,
// called from Python through ctypes (which releases the GIL), either
// synchronously from the Python thread pool or through the built-in
// worker pool + ticket queue (dp_pool_*).
//
// Numerics contract vs the Python pipeline in cc_tpu_torch/data/transforms.py:
// decode, flip, and integer-factor resizes are bit-identical; the rotation
// warp and non-integer upscales agree to interpolation precision (~1e-5
// relative) because the Python cv2 is a 5.x wheel while the system C++
// OpenCV is 4.6 (see the manual warp below). The random augmentation
// PARAMETERS are drawn in Python (numpy Generator, seed-deterministic) and
// passed in dp_aug, so python/native paths agree for a given seed
// (tests/test_torch_data.py).
//
// Build: see cc_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC, links
// opencv_{core,imgproc,imgcodecs}).
#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

#include <sys/stat.h>

#include <atomic>
#include <condition_variable>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <list>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// ------------------------------------------------------------ decode cache
//
// Training samples are sliding windows: sample i reads frames [i-2..i+2],
// so consecutive samples share 4 of their 5 decodes, and a whole epoch
// re-decodes every frame ~sequence_length times. On few-core hosts the
// JPEG decode dominates the sample cost (measured: the 832x256 train CLI
// is host-bound at ~3 im/s vs 22.8 device f/s on a 1-core box). An LRU of
// DECODED uint8 RGB frames (0.64 MB each at 832x256) removes the
// duplicate decodes; per-sample augmentation still runs on a fresh float
// conversion, so numerics are unchanged. Capacity: CC_TPU_DECODE_CACHE_MB
// (default 512, 0 disables).
namespace {

struct DecodeCache {
  std::mutex mu;
  std::list<std::string> order;  // front = most recent
  struct Entry {
    std::list<std::string>::iterator it;
    cv::Mat rgb8;  // uint8 RGB, read-only once inserted
  };
  std::unordered_map<std::string, Entry> map;
  size_t bytes = 0, cap;

  DecodeCache() {
    const char* e = std::getenv("CC_TPU_DECODE_CACHE_MB");
    long mb = e ? std::atol(e) : 512;
    cap = (size_t)(mb > 0 ? mb : 0) * 1024 * 1024;
  }

  // Returns true + fills rgb8 on hit (moves entry to front).
  bool get(const std::string& key, cv::Mat* rgb8) {
    if (cap == 0) return false;
    std::lock_guard<std::mutex> lk(mu);
    auto f = map.find(key);
    if (f == map.end()) return false;
    order.splice(order.begin(), order, f->second.it);
    *rgb8 = f->second.rgb8;  // refcounted share; insertions never mutate
    return true;
  }

  void put(const std::string& key, const cv::Mat& rgb8) {
    if (cap == 0) return;
    const size_t sz = rgb8.total() * rgb8.elemSize();
    if (sz > cap) return;
    std::lock_guard<std::mutex> lk(mu);
    if (map.count(key)) return;  // a racing decode already inserted it
    while (bytes + sz > cap && !order.empty()) {
      auto& victim = order.back();
      auto v = map.find(victim);
      bytes -= v->second.rgb8.total() * v->second.rgb8.elemSize();
      map.erase(v);
      order.pop_back();
    }
    order.push_front(key);
    map[key] = {order.begin(), rgb8};
    bytes += sz;
  }
};

DecodeCache g_decode_cache;

// Cache key = path + mtime(ns) + size: a file rewritten in place during
// the process lifetime (e.g. the ETL re-preparing a dataset) must miss —
// a path-only key would serve the old pixels forever while the Python
// fallback re-reads from disk (silent divergence, no error).
std::string decode_cache_key(const char* path) {
  struct stat st;
  std::string key(path);
  if (::stat(path, &st) == 0) {
    key += '|';
    key += std::to_string((long long)st.st_mtim.tv_sec * 1000000000LL +
                          st.st_mtim.tv_nsec);
    key += '|';
    key += std::to_string((long long)st.st_size);
  }
  return key;
}

}  // namespace

extern "C" {

typedef struct {
  int apply_rot;      // 1 = rotate by rot_deg about the image center
  double rot_deg;     // double: a float32 round-trip of the angle visibly
                      // perturbs warpAffine vs the Python path
  int apply_flip;     // 1 = horizontal flip
  int scaled_h;       // RandomScaleCrop resize target (0 = stage off);
  int scaled_w;       // computed in Python so int(h*scale) rounds once
  int crop_x;         // crop offset after scaling
  int crop_y;
  int out_h;          // crop size (0 = no scale-crop stage)
  int out_w;
  int resize_h;       // deterministic pre-resize (Scale transform; 0 = off)
  int resize_w;
  int normalize;      // -1 raw 0..255 floats (uint8-emit mode: no /255),
                      // 0 x/255 only, 1 global (mean/std), 2 local (joint)
  float mean, std;    // global normalization parameters
  int in_h, in_w;     // expected decode dims (0 = unchecked); the caller's
                      // crop/flip-cx math was computed from these, so a
                      // mismatch means silent numeric divergence
  int expect_h;       // dims of the caller-allocated output buffer
  int expect_w;       // (0 = unchecked) — checked before the output copy so
                      // a size surprise can never write past the buffer
} dp_aug;

// Decode + augment one joint sample (n images share one dp_aug).
// paths: n NUL-terminated strings back to back. out: [n, H, W, 3] float32
// (H, W = final size). Returns 0 on success, negative error otherwise.
static int dp_process_sample_impl(const char* paths, int n_imgs,
                                  const dp_aug* aug, float* out) {
  std::vector<cv::Mat> imgs(n_imgs);
  const char* p = paths;
  for (int i = 0; i < n_imgs; ++i) {
    const std::string key = decode_cache_key(p);
    cv::Mat rgb;
    if (!g_decode_cache.get(key, &rgb)) {
      cv::Mat bgr = cv::imread(p, cv::IMREAD_COLOR);
      if (bgr.empty()) return -1 - i;
      cv::cvtColor(bgr, rgb, cv::COLOR_BGR2RGB);
      g_decode_cache.put(key, rgb);
    }
    // Every later stage (rotation warp, local-norm stats, output copy)
    // indexes with imgs[0]'s dims; a mismatched frame would read out of
    // bounds or throw a cv::Exception across the extern "C" boundary.
    // Reject it cleanly instead (the Python fallback raises ValueError).
    if (i > 0 && (rgb.rows != imgs[0].rows || rgb.cols != imgs[0].cols))
      return -1000 - i;
    // The caller drew augmentation parameters (flip cx, scale-crop rect)
    // from its per-scene dim cache; a stale cache entry would silently
    // diverge from the Python fallback (ADVICE r2). Fail loud instead.
    if (i == 0 && aug->in_h > 0 &&
        (rgb.rows != aug->in_h || rgb.cols != aug->in_w))
      return -2000;
    // fresh float conversion per use: cached mats stay read-only
    rgb.convertTo(imgs[i], CV_32FC3);  // 0..255 float32, like load_image
    p += std::strlen(p) + 1;
  }

  if (aug->resize_h > 0) {  // Scale transform (valid/flow pipelines)
    for (auto& im : imgs)
      cv::resize(im, im, cv::Size(aug->resize_w, aug->resize_h), 0, 0,
                 cv::INTER_LINEAR);
  }
  if (aug->apply_rot) {
    // Manual inverse-mapped float bilinear warp. cv::warpAffine in OpenCV
    // 4.x quantizes interpolation coords to 1/32 px even for float images;
    // the Python pipeline's cv2 (a 5.x wheel) interpolates in full float.
    // This matches the 5.x behavior to ~1e-5 relative.
    cv::Size sz = imgs[0].size();
    cv::Mat fwd = cv::getRotationMatrix2D(
        cv::Point2f(sz.width / 2.0f, sz.height / 2.0f), aug->rot_deg, 1.0);
    cv::Mat inv;
    cv::invertAffineTransform(fwd, inv);
    const double m00 = inv.at<double>(0, 0), m01 = inv.at<double>(0, 1),
                 m02 = inv.at<double>(0, 2), m10 = inv.at<double>(1, 0),
                 m11 = inv.at<double>(1, 1), m12 = inv.at<double>(1, 2);
    const int hh = sz.height, ww = sz.width;
    for (auto& im : imgs) {
      cv::Mat r(hh, ww, CV_32FC3, cv::Scalar(0, 0, 0));
      for (int y = 0; y < hh; ++y) {
        float* dst = r.ptr<float>(y);
        for (int x = 0; x < ww; ++x) {
          const double sx = m00 * x + m01 * y + m02;
          const double sy = m10 * x + m11 * y + m12;
          const int x0 = (int)std::floor(sx), y0 = (int)std::floor(sy);
          const float wx = (float)(sx - x0), wy = (float)(sy - y0);
          float acc[3] = {0, 0, 0};
          const float wgt[4] = {(1 - wx) * (1 - wy), wx * (1 - wy),
                                (1 - wx) * wy, wx * wy};
          const int ys_[4] = {y0, y0, y0 + 1, y0 + 1};
          const int xs_[4] = {x0, x0 + 1, x0, x0 + 1};
          for (int t = 0; t < 4; ++t) {
            if (ys_[t] < 0 || ys_[t] >= hh || xs_[t] < 0 || xs_[t] >= ww)
              continue;
            const float* src = im.ptr<float>(ys_[t]) + xs_[t] * 3;
            for (int c = 0; c < 3; ++c) acc[c] += wgt[t] * src[c];
          }
          for (int c = 0; c < 3; ++c) dst[x * 3 + c] = acc[c];
        }
      }
      im = r;
    }
  }
  if (aug->apply_flip) {
    for (auto& im : imgs) {
      cv::Mat f;
      cv::flip(im, f, 1);
      im = f;
    }
  }
  if (aug->out_h > 0) {  // RandomScaleCrop: resize then crop
    int sh = aug->scaled_h;
    int sw = aug->scaled_w;
    for (auto& im : imgs) {
      cv::Mat s;
      cv::resize(im, s, cv::Size(sw, sh), 0, 0, cv::INTER_LINEAR);
      im = s(cv::Rect(aug->crop_x, aug->crop_y, aug->out_w, aug->out_h))
               .clone();
    }
  }

  const int h = imgs[0].rows, w = imgs[0].cols;
  // Never trust the pipeline stages to have produced the size the caller
  // allocated: the output copy below writes n*h*w*3 floats, and the Python
  // side sized `out` from its own expectation (ADVICE r2, medium).
  if (aug->expect_h > 0 && (h != aug->expect_h || w != aug->expect_w))
    return -2001;
  float mean[3] = {aug->mean, aug->mean, aug->mean};
  float stdv[3] = {aug->std, aug->std, aug->std};
  if (aug->normalize == 2) {  // joint per-channel stats over the image list
    double sum[3] = {0, 0, 0}, sq[3] = {0, 0, 0};
    double cnt = (double)n_imgs * h * w;
    for (auto& im : imgs)
      for (int y = 0; y < h; ++y) {
        const float* row = im.ptr<float>(y);
        for (int x = 0; x < w; ++x)
          for (int c = 0; c < 3; ++c) {
            double v = row[x * 3 + c] / 255.0;
            sum[c] += v;
            sq[c] += v * v;
          }
      }
    for (int c = 0; c < 3; ++c) {
      mean[c] = (float)(sum[c] / cnt);
      // ddof=1 like numpy std(ddof=1) in NormalizeLocally
      stdv[c] = (float)std::sqrt((sq[c] - sum[c] * sum[c] / cnt) / (cnt - 1));
    }
  }
  // Vectorized epilogue, same op ORDER as the Python path (ToFloat's
  // x/255 then Normalize's (v-mean)/std) so results stay BIT-IDENTICAL:
  // cv::divide by a Scalar performs true IEEE division (verified against
  // the scalar loop; convertTo(alpha=1/255) does NOT — it multiplies by
  // the rounded reciprocal). The scalar triple loop this replaces was the
  // native plane's own bottleneck once decodes were cached.
  for (int i = 0; i < n_imgs; ++i) {
    float* dst = out + (size_t)i * h * w * 3;
    cv::Mat view(h, w, CV_32FC3, dst);
    if (aug->normalize < 0) {
      // raw-emit mode (uint8 H2D): the caller rounds these 0..255 floats
      // straight to uint8 — dividing by 255 here only for Python to
      // multiply back would double-round pixels sitting on .5 boundaries
      imgs[i].copyTo(view);
      continue;
    }
    cv::divide(imgs[i], cv::Scalar(255.0, 255.0, 255.0), view);
    if (aug->normalize) {
      cv::subtract(view, cv::Scalar(mean[0], mean[1], mean[2]), view);
      cv::divide(view, cv::Scalar(stdv[0], stdv[1], stdv[2]), view);
    }
  }
  return 0;
}

// No C++ exception may cross the extern "C" boundary (std::terminate):
// cv:: ops can throw on degenerate inputs (e.g. a crop Rect outside a
// stale-sized image) — map everything to an error code instead.
int dp_process_sample(const char* paths, int n_imgs, const dp_aug* aug,
                      float* out) {
  try {
    return dp_process_sample_impl(paths, n_imgs, aug, out);
  } catch (...) {
    return -9999;
  }
}

// ---------------------------------------------------------------- pool

struct Job {
  int ticket;
  std::string paths;  // NUL-joined
  int n_imgs;
  dp_aug aug;
  float* out;
};

struct Pool {
  std::vector<std::thread> workers;
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv_submit, cv_done;
  std::unordered_map<int, int> done;  // ticket -> rc
  std::atomic<int> next_ticket{1};
  bool stop = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      workers.emplace_back([this] { run(); });
  }
  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_submit.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        job = std::move(queue.front());
        queue.pop_front();
      }
      int rc = dp_process_sample(job.paths.data(), job.n_imgs, &job.aug,
                                 job.out);
      {
        std::lock_guard<std::mutex> lk(mu);
        done[job.ticket] = rc;
      }
      cv_done.notify_all();
    }
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_submit.notify_all();
    for (auto& t : workers) t.join();
  }
};

void* dp_pool_create(int n_workers) { return new Pool(n_workers); }

void dp_pool_destroy(void* pool) { delete (Pool*)pool; }

// paths_blob must stay valid until dp_pool_wait returns (it is copied here,
// so actually only until submit returns). out must stay valid until wait.
int dp_pool_submit(void* pool, const char* paths, int paths_len, int n_imgs,
                   const dp_aug* aug, float* out) {
  Pool* p = (Pool*)pool;
  Job job;
  const int ticket = p->next_ticket++;
  job.ticket = ticket;
  job.paths.assign(paths, paths_len);
  job.n_imgs = n_imgs;
  job.aug = *aug;
  job.out = out;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->queue.push_back(std::move(job));
  }
  p->cv_submit.notify_one();
  return ticket;
}

// Contract: EVERY submitted ticket must be dp_pool_wait()ed before the pool
// is destroyed — done[] retains a ticket's rc until its wait erases it, so
// abandoned tickets (e.g. a Python exception between submit and wait) leak
// one map entry each for the pool's lifetime (all reclaimed on destroy).
int dp_pool_wait(void* pool, int ticket) {
  Pool* p = (Pool*)pool;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [&] { return p->done.count(ticket) > 0; });
  int rc = p->done[ticket];
  p->done.erase(ticket);
  return rc;
}

int dp_version() { return 4; }  // 4: stat-keyed cache + raw emit (3: LRU cache; 2: dims guards)

}  // extern "C"
