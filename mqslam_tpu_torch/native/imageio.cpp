// Native image-sequence loader: libpng/libjpeg decode + threaded prefetch.
//
// The runtime-native counterpart of the reference's C components
// (reference: Work/python_libs/triangulation_c compiled-on-import kernels,
// Work/SLAM/application/SVO/run_pipeline.cpp's image feeding loop): the
// host-side data path decodes frames off the Python thread so the
// accelerator never waits on IO. Exposed to Python via ctypes
// (mqslam_tpu_torch/native/__init__.py), built on demand with g++.
//
// API (C, all functions return 0 on success unless noted):
//   int mq_decode_gray(const char* path, float* out, int cap,
//                      int* h, int* w);
//   void* mq_seq_open(const char** paths, int n, int queue_depth,
//                     int max_h, int max_w);
//   int mq_seq_next(void* handle, float* out, int* h, int* w);
//       (returns 1 past the end)
//   void mq_seq_close(void* handle);

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

bool has_suffix(const std::string& s, const char* suf) {
  std::string lower;
  lower.reserve(s.size());
  for (char c : s) lower.push_back(static_cast<char>(::tolower(c)));
  const std::string t(suf);
  return lower.size() >= t.size() &&
         lower.compare(lower.size() - t.size(), t.size(), t) == 0;
}

// BT.601 luma weights, matching PIL's "L" conversion.
inline float luma(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}

int decode_png_gray(const char* path, float* out, int cap, int* h, int* w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  if (static_cast<int>(width * height) > cap) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -3;
  }
  std::vector<uint8_t> row(width * channels);
  for (png_uint_32 y = 0; y < height; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out + y * width;
    if (channels == 1) {
      for (png_uint_32 x = 0; x < width; ++x) dst[x] = row[x];
    } else {
      for (png_uint_32 x = 0; x < width; ++x) {
        const uint8_t* p = &row[x * channels];
        dst[x] = luma(p[0], p[1], p[2]);
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *h = static_cast<int>(height);
  *w = static_cast<int>(width);
  return 0;
}

int decode_jpeg_gray(const char* path, float* out, int cap, int* h, int* w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  int width = cinfo.output_width, height = cinfo.output_height;
  if (width * height > cap) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return -3;
  }
  std::vector<uint8_t> row(width);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rp = row.data();
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = out + y * width;
    for (int x = 0; x < width; ++x) dst[x] = row[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  *h = height;
  *w = width;
  return 0;
}

struct Frame {
  std::vector<float> data;
  int h = 0, w = 0, status = 0;
};

struct Sequence {
  std::vector<std::string> paths;
  int queue_depth;
  int max_pixels;
  size_t next_submit = 0;   // next index the worker decodes
  size_t next_emit = 0;     // next index the consumer receives
  std::deque<Frame> ready;  // decoded frames, in order
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::thread worker;
  bool stop = false;

  void run() {
    while (true) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop || (next_submit < paths.size() &&
                          ready.size() < static_cast<size_t>(queue_depth));
        });
        if (stop || next_submit >= paths.size()) return;
        idx = next_submit++;
      }
      Frame f;
      f.data.resize(max_pixels);
      const std::string& p = paths[idx];
      if (has_suffix(p, ".png"))
        f.status = decode_png_gray(p.c_str(), f.data.data(), max_pixels,
                                   &f.h, &f.w);
      else
        f.status = decode_jpeg_gray(p.c_str(), f.data.data(), max_pixels,
                                    &f.h, &f.w);
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push_back(std::move(f));
      }
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

int mq_decode_gray(const char* path, float* out, int cap, int* h, int* w) {
  std::string p(path);
  if (has_suffix(p, ".png")) return decode_png_gray(path, out, cap, h, w);
  return decode_jpeg_gray(path, out, cap, h, w);
}

void* mq_seq_open(const char** paths, int n, int queue_depth, int max_h,
                  int max_w) {
  auto* seq = new Sequence();
  seq->paths.assign(paths, paths + n);
  seq->queue_depth = queue_depth > 0 ? queue_depth : 4;
  seq->max_pixels = max_h * max_w;
  seq->worker = std::thread([seq] { seq->run(); });
  return seq;
}

int mq_seq_next(void* handle, float* out, int* h, int* w) {
  auto* seq = static_cast<Sequence*>(handle);
  std::unique_lock<std::mutex> lk(seq->mu);
  if (seq->next_emit >= seq->paths.size()) return 1;  // end of sequence
  seq->cv_ready.wait(lk, [&] { return !seq->ready.empty(); });
  Frame f = std::move(seq->ready.front());
  seq->ready.pop_front();
  seq->next_emit++;
  lk.unlock();
  seq->cv_space.notify_one();
  if (f.status != 0) return f.status;
  std::memcpy(out, f.data.data(), sizeof(float) * f.h * f.w);
  *h = f.h;
  *w = f.w;
  return 0;
}

void mq_seq_close(void* handle) {
  auto* seq = static_cast<Sequence*>(handle);
  {
    std::lock_guard<std::mutex> lk(seq->mu);
    seq->stop = true;
  }
  seq->cv_space.notify_all();
  if (seq->worker.joinable()) seq->worker.join();
  delete seq;
}

}  // extern "C"
