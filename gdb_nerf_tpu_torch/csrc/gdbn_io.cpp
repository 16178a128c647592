// gdbn_io: the port's host-side image decoder (PyTorch/CUDA package).
//
// Host C++, no CUDA: the data loaders decode on the CPU before a batch
// reaches the card.  This library provides the heavy host ops:
//   * PNG / JPEG decode straight into float32 RGB [0,1] buffers
//   * a bilinear resize (half-pixel centers)
//   * PFM depth-map reading (DTU ground truth)
//   * a thread pool with an async submit/wait API, so Python can overlap
//     the decode of a whole batch with the previous device step.
//
// The same functions and C ABI as the JAX package's decoder, consumed via
// ctypes (gdb_nerf_tpu_torch/datasets/native.py), which builds this file
// with g++ at first use into build/gdbn_io/.

#include <png.h>

#include <atomic>
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // interleaved, 8-bit
};

bool decode_png(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  out->h = (int)h;
  out->w = (int)w;
  out->c = channels;
  out->data.resize((size_t)h * w * channels);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->data.data() + (size_t)y * w * channels;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

bool decode_jpeg(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = 3;
  out->data.resize((size_t)out->h * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out->data.data() + (size_t)cinfo.output_scanline * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return true;
}

bool decode_any(const char* path, Image* out) {
  const char* dot = strrchr(path, '.');
  if (dot && (strcasecmp(dot, ".png") == 0)) return decode_png(path, out);
  if (dot && (strcasecmp(dot, ".jpg") == 0 || strcasecmp(dot, ".jpeg") == 0))
    return decode_jpeg(path, out);
  // Try png then jpeg by signature.
  return decode_png(path, out) || decode_jpeg(path, out);
}

// Bilinear resize (half-pixel centers, matching cv2.INTER_LINEAR / torch
// align_corners=False) from 8-bit interleaved to float32 RGB [0,1].
// Emits only the first 3 channels; a 4th (alpha) can be composited first.
void resize_bilinear_to_float(const Image& img, float* dst, int oh, int ow,
                              bool white_bg) {
  const int c = img.c;
  // Identity-size fast path: plain u8 -> f32 conversion, which the
  // compiler vectorizes.  This is the common DTU/LLFF case (decode at
  // native size; any rescale happens on device) and skips ~2 ms/image of
  // scalar interpolation arithmetic.
  if (oh == img.h && ow == img.w) {
    const float inv = 1.0f / 255.0f;
    const size_t n = (size_t)oh * ow;
    if (c == 3 && !white_bg) {
      const uint8_t* s = img.data.data();
      for (size_t i = 0; i < n * 3; ++i) dst[i] = s[i] * inv;
      return;
    }
    if (c == 4) {
      const uint8_t* s = img.data.data();
      for (size_t i = 0; i < n; ++i) {
        float a = s[i * 4 + 3] * inv;
        for (int k = 0; k < 3; ++k) {
          float v = s[i * 4 + k] * inv;
          dst[i * 3 + k] = white_bg ? v * a + (1.0f - a) : v;
        }
      }
      return;
    }
    if (c == 1) {
      const uint8_t* s = img.data.data();
      for (size_t i = 0; i < n; ++i) {
        float v = s[i] * inv;
        dst[i * 3] = dst[i * 3 + 1] = dst[i * 3 + 2] = v;
      }
      return;
    }
  }
  // Per-column coefficients are y-independent: hoist them out of the row
  // loop (floor/clamp per output pixel was the inner-loop hot spot).
  std::vector<int> xs0(ow), xs1(ow);
  std::vector<float> wxs(ow);
  const float sx = (float)img.w / ow;
  for (int x = 0; x < ow; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = (int)floorf(fx);
    wxs[x] = fx - x0;
    xs0[x] = std::clamp(x0, 0, img.w - 1);
    xs1[x] = std::clamp(x0 + 1, 0, img.w - 1);
  }
  const float sy = (float)img.h / oh;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = std::clamp(y0, 0, img.h - 1);
    int y1c = std::clamp(y0 + 1, 0, img.h - 1);
    for (int x = 0; x < ow; ++x) {
      float wx = wxs[x];
      int x0c = xs0[x];
      int x1c = xs1[x];
      const uint8_t* p00 = &img.data[((size_t)y0c * img.w + x0c) * c];
      const uint8_t* p01 = &img.data[((size_t)y0c * img.w + x1c) * c];
      const uint8_t* p10 = &img.data[((size_t)y1c * img.w + x0c) * c];
      const uint8_t* p11 = &img.data[((size_t)y1c * img.w + x1c) * c];
      float out_px[4];
      int cc = std::min(c, 4);
      for (int k = 0; k < cc; ++k) {
        float top = p00[k] * (1 - wx) + p01[k] * wx;
        float bot = p10[k] * (1 - wx) + p11[k] * wx;
        out_px[k] = (top * (1 - wy) + bot * wy) / 255.0f;
      }
      float* d = dst + ((size_t)y * ow + x) * 3;
      if (c == 4 && white_bg) {
        float a = out_px[3];
        for (int k = 0; k < 3; ++k) d[k] = out_px[k] * a + (1.0f - a);
      } else {
        for (int k = 0; k < 3; ++k) d[k] = out_px[std::min(k, cc - 1)];
      }
    }
  }
}

struct Pool {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> jobs;
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  std::atomic<int> in_flight{0};
  std::atomic<int> errors{0};
  bool stop = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv_job.wait(lk, [this] { return stop || !jobs.empty(); });
            if (stop && jobs.empty()) return;
            job = std::move(jobs.front());
            jobs.pop();
          }
          job();
          if (--in_flight == 0) cv_done.notify_all();
        }
      });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_job.notify_all();
    for (auto& w : workers) w.join();
  }
  void submit(std::function<void()> f) {
    ++in_flight;
    {
      std::lock_guard<std::mutex> lk(mu);
      jobs.push(std::move(f));
    }
    cv_job.notify_one();
  }
  int wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [this] { return in_flight.load() == 0; });
    return errors.exchange(0);
  }
};

}  // namespace

extern "C" {

int gdbn_image_size(const char* path, int* h, int* w) {
  Image img;  // full decode; size-only probes are rare in this pipeline
  if (!decode_any(path, &img)) return -1;
  *h = img.h;
  *w = img.w;
  return 0;
}

// Decode an image to float32 RGB [0,1] of shape (out_h, out_w, 3).
// out_h/out_w of 0 mean "native size" (caller must know it).
// white_bg: composite alpha over white (NeRF-synthetic protocol).
int gdbn_decode_image(const char* path, float* out, int out_h, int out_w,
                      int white_bg) {
  Image img;
  if (!decode_any(path, &img)) return -1;
  if (out_h <= 0) out_h = img.h;
  if (out_w <= 0) out_w = img.w;
  resize_bilinear_to_float(img, out, out_h, out_w, white_bg != 0);
  return 0;
}

int gdbn_pfm_size(const char* path, int* h, int* w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  char tag[8];
  if (fscanf(fp, "%7s", tag) != 1 || (strcmp(tag, "Pf") && strcmp(tag, "PF"))) {
    fclose(fp);
    return -1;
  }
  if (fscanf(fp, "%d %d", w, h) != 2) {
    fclose(fp);
    return -1;
  }
  fclose(fp);
  return strcmp(tag, "PF") == 0 ? 3 : 1;
}

// Read a single-channel PFM into out (h*w floats, top-down row order).
int gdbn_read_pfm(const char* path, float* out, int h, int w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  char tag[8];
  int fw, fh;
  float scale;
  if (fscanf(fp, "%7s %d %d %f", tag, &fw, &fh, &scale) != 4 ||
      strcmp(tag, "Pf") != 0 || fw != w || fh != h) {
    fclose(fp);
    return -1;
  }
  fgetc(fp);  // single whitespace after the scale line
  std::vector<float> rows((size_t)h * w);
  if (fread(rows.data(), sizeof(float), (size_t)h * w, fp) != (size_t)h * w) {
    fclose(fp);
    return -1;
  }
  fclose(fp);
  bool little = scale < 0;
  if (!little) {
    for (auto& v : rows) {
      uint32_t u;
      memcpy(&u, &v, 4);
      u = __builtin_bswap32(u);
      memcpy(&v, &u, 4);
    }
  }
  // PFM stores rows bottom-up.
  for (int y = 0; y < h; ++y)
    memcpy(out + (size_t)y * w, rows.data() + (size_t)(h - 1 - y) * w,
           (size_t)w * 4);
  return 0;
}

void* gdbn_pool_create(int num_threads) { return new Pool(num_threads); }

void gdbn_pool_destroy(void* pool) { delete (Pool*)pool; }

// Async decode into a caller-owned buffer; caller must keep path + buffer
// alive until gdbn_pool_wait returns.
void gdbn_pool_submit_image(void* pool, const char* path, float* out,
                            int out_h, int out_w, int white_bg) {
  Pool* p = (Pool*)pool;
  std::string spath(path);
  p->submit([p, spath, out, out_h, out_w, white_bg] {
    if (gdbn_decode_image(spath.c_str(), out, out_h, out_w, white_bg) != 0)
      ++p->errors;
  });
}

// Wait for all submitted jobs; returns the number of failed jobs.
int gdbn_pool_wait(void* pool) { return ((Pool*)pool)->wait(); }

}  // extern "C"
