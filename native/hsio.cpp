// libhsio — native IO/runtime support for hsflow.
//
// The build's equivalent of the reference's C/C++ host-side IO layer
// (SURVEY.md §2a R4/R7 and the native-component ledger): the compute runtime
// is JAX/XLA/PJRT, but frame decode and flow-file IO stay on the host CPU and
// can bottleneck a streaming pipeline (driver config 4) when done in Python.
// This library provides:
//   * binary PGM/PPM decode -> float32 grayscale in [0, 1]
//   * Middlebury .flo read/write (SURVEY.md §2.5 FLO)
//   * a multi-threaded prefetching frame loader: worker threads decode
//     ahead into a bounded ring so the accelerator never waits on decode
//     (pipeline-parallel stage P6, SURVEY.md §2b)
//
// C ABI throughout: bound from Python with ctypes (no pybind11 in this
// environment). Thread-safe; all handles are opaque.

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef HSIO_WITH_OPENCV
// PNG/JPEG/BMP/TIFF decode via OpenCV imgcodecs (reference R7 used
// stb/OpenCV breadth; the Makefile enables this when pkg-config finds
// opencv4). Only imgcodecs+core are linked.
#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#endif
#ifdef HSIO_WITH_OPENCV_VIDEO
// Container/camera ingestion (mp4/avi/V4L2 -> decode ring) via OpenCV
// videoio (ffmpeg-backed). The reference class stops at still images; this
// is the config-4 streaming front end the north star asks for.
#include <opencv2/videoio.hpp>
#endif

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<float> px;  // grayscale [0,1], row-major
};

bool read_file(const char* path, std::vector<unsigned char>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) { std::fclose(f); return false; }
  out.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(out.data(), 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

// Parse PNM header tokens (magic, w, h, maxval), honoring '#' comments.
bool pnm_header(const std::vector<unsigned char>& d, std::string& magic,
                long vals[3], size_t& data_off) {
  size_t i = 0;
  int tok = 0;
  std::string cur;
  magic.clear();
  while (i < d.size() && tok < 4) {
    unsigned char c = d[i];
    if (c == '#') {
      while (i < d.size() && d[i] != '\n') ++i;
      continue;
    }
    if (std::isspace(c)) {
      if (!cur.empty()) {
        if (tok == 0) magic = cur;
        else vals[tok - 1] = std::strtol(cur.c_str(), nullptr, 10);
        ++tok;
        cur.clear();
      }
      ++i;
      continue;
    }
    cur.push_back(static_cast<char>(c));
    ++i;
  }
  if (tok < 4) return false;
  // A CRLF-terminated header (Windows-written PNM) consumes only the '\r'
  // above; skip the '\n' too or binary pixel data shifts by one byte.
  if (i > 0 && d[i - 1] == '\r' && i < d.size() && d[i] == '\n') ++i;
  data_off = i;  // whitespace after maxval fully consumed
  return true;
}

bool decode_pnm(const std::vector<unsigned char>& d, Image& img) {
  std::string magic;
  long v[3];
  size_t off;
  if (!pnm_header(d, magic, v, off)) return false;
  const long w = v[0], h = v[1], maxval = v[2];
  if (w <= 0 || h <= 0 || maxval <= 0) return false;
  const int ch = (magic == "P6" || magic == "P3") ? 3 : 1;
  const size_t count = static_cast<size_t>(w) * h * ch;
  img.w = static_cast<int>(w);
  img.h = static_cast<int>(h);
  img.px.resize(static_cast<size_t>(w) * h);
  const float maxv = static_cast<float>(maxval);
  // BT.601 luma for color inputs, matching io/images.py.
  const float wr = 0.299f, wg = 0.587f, wb = 0.114f;

  if (magic == "P5" || magic == "P6") {
    const int bytes = maxval > 255 ? 2 : 1;
    if (d.size() < off + count * bytes) return false;
    const unsigned char* p = d.data() + off;
    if (ch == 1) {
      if (bytes == 1) {
        for (size_t k = 0; k < count; ++k) img.px[k] = static_cast<float>(p[k]) / maxv;
      } else {
        for (size_t k = 0; k < count; ++k)
          img.px[k] = static_cast<float>((p[2 * k] << 8) | p[2 * k + 1]) / maxv;
      }
    } else {
      for (size_t k = 0; k < static_cast<size_t>(w) * h; ++k) {
        float r, g, b;
        if (bytes == 1) {
          r = p[3 * k] / maxv; g = p[3 * k + 1] / maxv; b = p[3 * k + 2] / maxv;
        } else {
          auto rd = [&](size_t j) {
            return static_cast<float>((p[2 * j] << 8) | p[2 * j + 1]) / maxv;
          };
          r = rd(3 * k); g = rd(3 * k + 1); b = rd(3 * k + 2);
        }
        img.px[k] = wr * r + wg * g + wb * b;
      }
    }
    return true;
  }
  if (magic == "P2" || magic == "P3") {
    const char* p = reinterpret_cast<const char*>(d.data()) + off;
    const char* end = reinterpret_cast<const char*>(d.data()) + d.size();
    std::vector<float> vals;
    vals.reserve(count);
    while (p < end && vals.size() < count) {
      char* next;
      long x = std::strtol(p, &next, 10);
      if (next == p) { ++p; continue; }
      vals.push_back(static_cast<float>(x) / maxv);
      p = next;
    }
    if (vals.size() < count) return false;
    if (ch == 1) {
      std::memcpy(img.px.data(), vals.data(), count * sizeof(float));
    } else {
      for (size_t k = 0; k < static_cast<size_t>(w) * h; ++k)
        img.px[k] = wr * vals[3 * k] + wg * vals[3 * k + 1] + wb * vals[3 * k + 2];
    }
    return true;
  }
  return false;
}

#ifdef HSIO_WITH_OPENCV
// Any 8U/16U 1/3/4-channel Mat to float32 grayscale in [0, 1], matching
// io/images.py exactly: stored grayscale is scaled by the sample max;
// color converts via BT.601 luma in float (no intermediate rounding).
// Shared by the still-image decoder and the video frame path.
void mat_to_gray(const cv::Mat& raw, Image& img) {
  img.w = raw.cols;
  img.h = raw.rows;
  img.px.resize(static_cast<size_t>(raw.cols) * raw.rows);
  const int depth = raw.depth();
  const float maxv = depth == CV_16U ? 65535.0f : 255.0f;
  const int ch = raw.channels();
  const float wr = 0.299f, wg = 0.587f, wb = 0.114f;  // BT.601, io/images.py
  for (int y = 0; y < raw.rows; ++y) {
    float* out = img.px.data() + static_cast<size_t>(y) * raw.cols;
    for (int x = 0; x < raw.cols; ++x) {
      float r, g, b;
      if (depth == CV_16U) {
        const uint16_t* p = raw.ptr<uint16_t>(y) + static_cast<size_t>(x) * ch;
        if (ch == 1) { out[x] = p[0] / maxv; continue; }
        b = p[0] / maxv; g = p[1] / maxv; r = p[2] / maxv;  // OpenCV is BGR
      } else {
        const uint8_t* p = raw.ptr<uint8_t>(y) + static_cast<size_t>(x) * ch;
        if (ch == 1) { out[x] = p[0] / maxv; continue; }
        b = p[0] / maxv; g = p[1] / maxv; r = p[2] / maxv;
      }
      out[x] = wr * r + wg * g + wb * b;  // alpha (ch==4) ignored
    }
  }
}

bool decode_cv(const std::vector<unsigned char>& d, Image& img) {
  cv::Mat buf(1, static_cast<int>(d.size()), CV_8UC1,
              const_cast<unsigned char*>(d.data()));
  cv::Mat raw = cv::imdecode(buf, cv::IMREAD_UNCHANGED);
  if (raw.empty()) return false;
  mat_to_gray(raw, img);
  return true;
}
#endif

// Dispatch: PNM fast path, then the OpenCV codecs when compiled in.
bool decode_image(const std::vector<unsigned char>& d, Image& img) {
  if (d.size() >= 2 && d[0] == 'P' && d[1] >= '1' && d[1] <= '6') {
    if (decode_pnm(d, img)) return true;
    img = Image();
  }
#ifdef HSIO_WITH_OPENCV
  return decode_cv(d, img);
#else
  return false;
#endif
}

// Big-endian u32 at offset (PNG header fields).
uint32_t be32(const unsigned char* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

constexpr float kFloMagic = 202021.25f;  // "PIEH"

}  // namespace

extern "C" {

// ---- one-shot decode --------------------------------------------------------

// Codec capability bitmask: 1 = PNM (always), 2 = OpenCV imgcodecs
// (PNG/JPEG/BMP/TIFF/...), 4 = OpenCV videoio (mp4/avi/V4L2 ingestion +
// video writer). Lets the Python side route the prefetch loader.
int hsio_codecs() {
  int c = 1;
#ifdef HSIO_WITH_OPENCV
  c |= 2;
#endif
#ifdef HSIO_WITH_OPENCV_VIDEO
  c |= 4;
#endif
  return c;
}

// Header-only probe: parses PNM/PNG dimensions without decoding pixels;
// other formats (when the OpenCV codecs are compiled in) fully decode.
int hsio_probe(const char* path, int* w, int* h) {
  std::vector<unsigned char> d;
  if (!read_file(path, d)) return -1;  // (reads the file; header parse only)
  std::string magic;
  long v[3];
  size_t off;
  const bool is_pnm = d.size() >= 2 && d[0] == 'P' && d[1] >= '1' && d[1] <= '6';
  if (is_pnm) {
    if (!pnm_header(d, magic, v, off) || v[0] <= 0 || v[1] <= 0) return -2;
    *w = static_cast<int>(v[0]);
    *h = static_cast<int>(v[1]);
    return 0;
  }
  static const unsigned char png_sig[8] = {137, 'P', 'N', 'G', 13, 10, 26, 10};
  if (d.size() >= 24 && std::memcmp(d.data(), png_sig, 8) == 0) {
    const uint32_t wi = be32(d.data() + 16);  // IHDR is always first
    const uint32_t hi = be32(d.data() + 20);
    if (wi == 0 || hi == 0 || wi > 100000 || hi > 100000) return -2;
    *w = static_cast<int>(wi);
    *h = static_cast<int>(hi);
    return 0;
  }
#ifdef HSIO_WITH_OPENCV
  Image img;
  if (decode_cv(d, img)) {
    *w = img.w;
    *h = img.h;
    return 0;
  }
#endif
  return -2;
}

// Returns 0 on success. Queries dimensions only when out == nullptr (full
// decode still runs; use hsio_probe for a cheap dimension query).
int hsio_load_gray(const char* path, float* out, int* w, int* h) {
  std::vector<unsigned char> d;
  if (!read_file(path, d)) return -1;
  Image img;
  if (!decode_image(d, img)) return -2;
  *w = img.w;
  *h = img.h;
  if (out) std::memcpy(out, img.px.data(), img.px.size() * sizeof(float));
  return 0;
}

// ---- .flo -------------------------------------------------------------------

int hsio_read_flo(const char* path, float* out, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  float magic;
  int32_t wi, hi;
  if (std::fread(&magic, 4, 1, f) != 1 || magic != kFloMagic ||
      std::fread(&wi, 4, 1, f) != 1 || std::fread(&hi, 4, 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  // Dimensions come from untrusted file contents: reject non-positive or
  // absurd values before the caller allocates from them (mirrors
  // hsio_probe's checks; 100k px/side is far beyond any real flow field).
  if (wi <= 0 || hi <= 0 || wi > 100000 || hi > 100000) {
    std::fclose(f);
    return -2;
  }
  *w = wi;
  *h = hi;
  int rc = 0;
  if (out) {
    size_t n = static_cast<size_t>(wi) * hi * 2;
    if (std::fread(out, 4, n, f) != n) rc = -3;
  }
  std::fclose(f);
  return rc;
}

int hsio_write_flo(const char* path, const float* data, int w, int h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int32_t wi = w, hi = h;
  int ok = std::fwrite(&kFloMagic, 4, 1, f) == 1 &&
           std::fwrite(&wi, 4, 1, f) == 1 && std::fwrite(&hi, 4, 1, f) == 1 &&
           std::fwrite(data, 4, static_cast<size_t>(w) * h * 2, f) ==
               static_cast<size_t>(w) * h * 2;
  std::fclose(f);
  return ok ? 0 : -2;
}

// ---- 16-bit PNG (KITTI flow maps) ------------------------------------------

// Read a 16-bit 3-channel PNG in RGB channel order (KITTI flow encoding;
// io/kitti.py). Two-phase: out == nullptr fills w/h only. Returns 0 on
// success, -1 file, -2 decode/format, -10 when built without OpenCV.
int hsio_read_png16(const char* path, uint16_t* out, int* w, int* h) {
#ifdef HSIO_WITH_OPENCV
  std::vector<unsigned char> d;
  if (!read_file(path, d)) return -1;
  cv::Mat buf(1, static_cast<int>(d.size()), CV_8UC1, d.data());
  cv::Mat raw = cv::imdecode(buf, cv::IMREAD_UNCHANGED);
  if (raw.empty() || raw.depth() != CV_16U || raw.channels() != 3) return -2;
  *w = raw.cols;
  *h = raw.rows;
  if (out) {
    for (int y = 0; y < raw.rows; ++y) {
      const uint16_t* p = raw.ptr<uint16_t>(y);
      uint16_t* o = out + static_cast<size_t>(y) * raw.cols * 3;
      for (int x = 0; x < raw.cols; ++x) {  // OpenCV is BGR; emit RGB
        o[3 * x] = p[3 * x + 2];
        o[3 * x + 1] = p[3 * x + 1];
        o[3 * x + 2] = p[3 * x];
      }
    }
  }
  return 0;
#else
  (void)path; (void)out; (void)w; (void)h;
  return -10;
#endif
}

// Write (h, w, 3) uint16 RGB as a 16-bit PNG. Same return convention.
int hsio_write_png16(const char* path, const uint16_t* rgb, int w, int h) {
#ifdef HSIO_WITH_OPENCV
  if (w <= 0 || h <= 0) return -2;
  cv::Mat bgr(h, w, CV_16UC3);
  for (int y = 0; y < h; ++y) {
    const uint16_t* p = rgb + static_cast<size_t>(y) * w * 3;
    uint16_t* o = bgr.ptr<uint16_t>(y);
    for (int x = 0; x < w; ++x) {
      o[3 * x] = p[3 * x + 2];
      o[3 * x + 1] = p[3 * x + 1];
      o[3 * x + 2] = p[3 * x];
    }
  }
  return cv::imwrite(path, bgr) ? 0 : -1;
#else
  (void)path; (void)rgb; (void)w; (void)h;
  return -10;
#endif
}

// ---- threaded prefetching frame loader -------------------------------------

struct hsio_loader {
  std::vector<std::string> paths;
  size_t next_submit = 0;     // next frame index to hand to a worker
  size_t next_emit = 0;       // next frame index the consumer receives
  size_t capacity = 0;        // ring depth
  std::deque<std::pair<size_t, Image>> done;  // decoded, possibly out of order
  std::mutex mu;
  std::condition_variable cv_worker, cv_consumer;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int> error{0};

  void work() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_worker.wait(lk, [&] {
          return stop || (next_submit < paths.size() &&
                          next_submit - next_emit < capacity);
        });
        if (stop || next_submit >= paths.size()) return;
        idx = next_submit++;
      }
      Image img;
      std::vector<unsigned char> d;
      bool ok = read_file(paths[idx].c_str(), d) && decode_image(d, img);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (!ok) {
          error = -2;
          img = Image();  // decoders may have partially filled it
        }
        done.emplace_back(idx, std::move(img));
        cv_consumer.notify_all();
      }
    }
  }
};

hsio_loader* hsio_loader_open(const char** paths, int n_paths, int n_threads,
                              int prefetch_depth) {
  auto* L = new hsio_loader();
  L->paths.assign(paths, paths + n_paths);
  L->capacity = prefetch_depth > 0 ? prefetch_depth : 4;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&hsio_loader::work, L);
  return L;
}

// Blocks until frame `next_emit` is decoded; returns 0 and fills out/w/h.
// Returns 1 when the stream is exhausted, -4 if the frame exceeds
// capacity_px (out untouched, w/h filled), <0 on decode error. A decode
// error on a prefetched-ahead frame is only reported once the stream
// actually reaches it — earlier frames that decoded fine are delivered.
int hsio_loader_next(hsio_loader* L, float* out, int* w, int* h,
                     long capacity_px) {
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_emit >= L->paths.size()) return 1;
  size_t want = L->next_emit;
  // Workers always emplace an entry for every submitted frame (empty on
  // decode failure), so waiting on presence alone cannot deadlock and a
  // sticky error flag never skips frames that are still in flight.
  L->cv_consumer.wait(lk, [&] {
    for (auto& kv : L->done)
      if (kv.first == want) return true;
    return false;
  });
  for (auto it = L->done.begin(); it != L->done.end(); ++it) {
    if (it->first == want) {
      *w = it->second.w;
      *h = it->second.h;
      const size_t n = it->second.px.size();
      if (it->second.w <= 0 || it->second.h <= 0 ||
          n != static_cast<size_t>(it->second.w) * it->second.h) {
        // decode of THIS frame failed (empty/partial px): consume + report
        L->done.erase(it);
        ++L->next_emit;
        L->cv_worker.notify_all();
        return L->error ? L->error.load() : -2;
      }
      if (static_cast<long>(n) > capacity_px) {
        // caller buffer too small: report dims, keep the frame for retry
        return -4;
      }
      if (out) std::memcpy(out, it->second.px.data(), n * sizeof(float));
      L->done.erase(it);
      ++L->next_emit;
      L->cv_worker.notify_all();
      return 0;
    }
  }
  return -5;  // unreachable: the wait guarantees `want` is present
}

void hsio_loader_close(hsio_loader* L) {
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_worker.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// ---- container / camera video ingestion (config 4 front end) ----------------
//
// One decoder thread (VideoCapture decode is internally pipelined by
// ffmpeg; a second thread on the same capture is UB) fills a bounded ring
// of grayscale float frames, so the accelerator never waits on the
// container demux/decode — the same pipeline shape as hsio_loader. Source
// is a file path, or "cam:N" for a V4L2 camera index.

struct hsio_video {
#ifdef HSIO_WITH_OPENCV_VIDEO
  cv::VideoCapture cap;
#endif
  int w = 0, h = 0;
  double fps = 0.0;
  long n_frames = -1;  // -1 = unknown (cameras, some containers)
  size_t capacity = 4;
  std::deque<Image> ring;
  std::mutex mu;
  std::condition_variable cv_worker, cv_consumer;
  std::thread worker;
  std::atomic<bool> stop{false};
  bool eof = false;

#ifdef HSIO_WITH_OPENCV_VIDEO
  void work() {
    cv::Mat frame;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_worker.wait(lk, [&] { return stop || ring.size() < capacity; });
        if (stop) return;
      }
      if (!cap.read(frame) || frame.empty()) {
        std::lock_guard<std::mutex> lk(mu);
        eof = true;
        cv_consumer.notify_all();
        return;
      }
      Image img;
      mat_to_gray(frame, img);
      std::lock_guard<std::mutex> lk(mu);
      ring.emplace_back(std::move(img));
      cv_consumer.notify_all();
    }
  }
#endif
};

hsio_video* hsio_video_open(const char* source, int prefetch_depth) {
#ifdef HSIO_WITH_OPENCV_VIDEO
  auto* V = new hsio_video();
  const char* cam = std::strncmp(source, "cam:", 4) == 0 ? source + 4 : nullptr;
  bool ok = cam ? V->cap.open(std::atoi(cam), cv::CAP_V4L2)
                : V->cap.open(source);
  if (!ok || !V->cap.isOpened()) {
    delete V;
    return nullptr;
  }
  V->w = static_cast<int>(V->cap.get(cv::CAP_PROP_FRAME_WIDTH));
  V->h = static_cast<int>(V->cap.get(cv::CAP_PROP_FRAME_HEIGHT));
  V->fps = V->cap.get(cv::CAP_PROP_FPS);
  double n = V->cap.get(cv::CAP_PROP_FRAME_COUNT);
  V->n_frames = n > 0 ? static_cast<long>(n) : -1;
  V->capacity = prefetch_depth > 0 ? prefetch_depth : 4;
  V->worker = std::thread(&hsio_video::work, V);
  return V;
#else
  (void)source; (void)prefetch_depth;
  return nullptr;
#endif
}

int hsio_video_info(hsio_video* V, int* w, int* h, double* fps,
                    long* n_frames) {
  if (!V) return -1;
  *w = V->w;
  *h = V->h;
  *fps = V->fps;
  *n_frames = V->n_frames;
  return 0;
}

// 0 = frame delivered, 1 = end of stream, -4 = caller buffer too small
// (w/h filled, frame kept for retry).
int hsio_video_next(hsio_video* V, float* out, int* w, int* h,
                    long capacity_px) {
  if (!V) return -1;
  std::unique_lock<std::mutex> lk(V->mu);
  V->cv_consumer.wait(lk, [&] { return !V->ring.empty() || V->eof; });
  if (V->ring.empty()) return 1;
  Image& img = V->ring.front();
  *w = img.w;
  *h = img.h;
  if (static_cast<long>(img.px.size()) > capacity_px) return -4;
  if (out) std::memcpy(out, img.px.data(), img.px.size() * sizeof(float));
  V->ring.pop_front();
  V->cv_worker.notify_all();
  return 0;
}

void hsio_video_close(hsio_video* V) {
  if (!V) return;
  {
    std::lock_guard<std::mutex> lk(V->mu);
    V->stop = true;
  }
  V->cv_worker.notify_all();
  if (V->worker.joinable()) V->worker.join();
  delete V;
}

// ---- video writer (flow visualizations / test fixtures) ---------------------

struct hsio_vwriter {
#ifdef HSIO_WITH_OPENCV_VIDEO
  cv::VideoWriter wr;
#endif
  int w = 0, h = 0;
};

// fourcc: 4-char codec tag ("MJPG", "mp4v", "FFV1", ...). Gray float frames
// in [0, 1] are expanded to 8-bit BGR (codecs want color).
hsio_vwriter* hsio_vwriter_open(const char* path, int w, int h, double fps,
                                const char* fourcc) {
#ifdef HSIO_WITH_OPENCV_VIDEO
  if (w <= 0 || h <= 0 || std::strlen(fourcc) != 4) return nullptr;
  auto* W = new hsio_vwriter();
  int cc = cv::VideoWriter::fourcc(fourcc[0], fourcc[1], fourcc[2], fourcc[3]);
  if (!W->wr.open(path, cc, fps > 0 ? fps : 25.0, cv::Size(w, h), true)) {
    delete W;
    return nullptr;
  }
  W->w = w;
  W->h = h;
  return W;
#else
  (void)path; (void)w; (void)h; (void)fps; (void)fourcc;
  return nullptr;
#endif
}

// gray: (h, w) float in [0, 1]. rgb: optional (h, w, 3) float RGB instead
// (pass gray == nullptr). Returns 0 on success.
int hsio_vwriter_write(hsio_vwriter* W, const float* gray, const float* rgb) {
#ifdef HSIO_WITH_OPENCV_VIDEO
  if (!W || (!gray && !rgb)) return -1;
  cv::Mat bgr(W->h, W->w, CV_8UC3);
  for (int y = 0; y < W->h; ++y) {
    uint8_t* o = bgr.ptr<uint8_t>(y);
    for (int x = 0; x < W->w; ++x) {
      auto q = [](float v) {
        v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
        return static_cast<uint8_t>(v * 255.0f + 0.5f);
      };
      if (gray) {
        uint8_t g = q(gray[static_cast<size_t>(y) * W->w + x]);
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g;
      } else {
        const float* p = rgb + (static_cast<size_t>(y) * W->w + x) * 3;
        o[3 * x] = q(p[2]);      // BGR
        o[3 * x + 1] = q(p[1]);
        o[3 * x + 2] = q(p[0]);
      }
    }
  }
  W->wr.write(bgr);
  return 0;
#else
  (void)W; (void)gray; (void)rgb;
  return -10;
#endif
}

void hsio_vwriter_close(hsio_vwriter* W) {
#ifdef HSIO_WITH_OPENCV_VIDEO
  if (W) W->wr.release();
#endif
  delete W;
}

int hsio_version() { return 10200; }  // 1.2.0: + video ingestion/writer

}  // extern "C"
