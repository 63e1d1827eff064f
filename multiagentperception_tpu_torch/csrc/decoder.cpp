// Native batch PNG decoder of the port's input pipeline: the port's own copy
// of the repo's native/decoder.cpp (keep the two in step), built with g++
// into multiagentperception_tpu_torch/build/native/ at first use and bound
// with ctypes by multiagentperception_tpu_torch/native.py.
//
// A C++ thread pool decodes a whole multi-view frame of PNGs concurrently
// (libpng), writing straight into a caller-provided (N, H, W, C) uint8 block:
// one GIL release for the whole frame and the loader's own output layout.
//
// C ABI (ctypes-friendly):
//   map_decode_png(path, out, out_cap, w, h, c)      -> 0 ok / <0 error
//   map_decode_batch(paths, n, out, stride, w, h, c, nthreads)
//       decodes n images of identical geometry into out[i*stride]
//   map_png_info(path, w, h, c)                      -> probe geometry

#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrNotPng = -2;
constexpr int kErrDecode = -3;
constexpr int kErrTooSmall = -4;
constexpr int kErrGeometry = -5;

struct PngImage {
  std::vector<uint8_t> pixels;  // RGB or RGBA rows, tightly packed
  uint32_t width = 0;
  uint32_t height = 0;
  uint32_t channels = 0;
};

// Decode one PNG file into 8-bit RGB(A). Returns kOk or an error code.
int DecodePng(const char* path, PngImage* img) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return kErrOpen;

  uint8_t header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return kErrNotPng;
  }

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return kErrDecode;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return kErrDecode;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return kErrDecode;
  }

  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  // normalize every variant to 8-bit RGB(A)
  png_byte color_type = png_get_color_type(png, info);
  png_byte bit_depth = png_get_bit_depth(png, info);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  img->width = png_get_image_width(png, info);
  img->height = png_get_image_height(png, info);
  img->channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  img->pixels.resize(rowbytes * img->height);

  std::vector<png_bytep> rows(img->height);
  for (uint32_t y = 0; y < img->height; ++y)
    rows[y] = img->pixels.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);

  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return kOk;
}

}  // namespace

extern "C" {

// Probe geometry without a full decode of the pixel data path.
int map_png_info(const char* path, int32_t* w, int32_t* h, int32_t* c) {
  PngImage img;
  int rc = DecodePng(path, &img);  // libpng has no cheap header-only mode
  if (rc != kOk) return rc;        // worth it: used once per dataset
  *w = static_cast<int32_t>(img.width);
  *h = static_cast<int32_t>(img.height);
  *c = static_cast<int32_t>(img.channels);
  return kOk;
}

// Decode one PNG into out (capacity out_cap bytes); writes geometry.
int map_decode_png(const char* path, uint8_t* out, int64_t out_cap,
                   int32_t* w, int32_t* h, int32_t* c) {
  PngImage img;
  int rc = DecodePng(path, &img);
  if (rc != kOk) return rc;
  if (static_cast<int64_t>(img.pixels.size()) > out_cap) return kErrTooSmall;
  std::memcpy(out, img.pixels.data(), img.pixels.size());
  *w = static_cast<int32_t>(img.width);
  *h = static_cast<int32_t>(img.height);
  *c = static_cast<int32_t>(img.channels);
  return kOk;
}

// Decode n same-geometry PNGs concurrently; image i lands at out + i*stride.
// Every image must decode to exactly (h, w, c) or the batch fails.
int map_decode_batch(const char** paths, int32_t n, uint8_t* out,
                     int64_t stride, int32_t w, int32_t h, int32_t c,
                     int32_t nthreads) {
  if (n <= 0) return kOk;
  const int64_t need = static_cast<int64_t>(w) * h * c;
  if (need > stride) return kErrTooSmall;
  if (nthreads <= 0) nthreads = std::thread::hardware_concurrency();
  if (nthreads > n) nthreads = n;

  std::atomic<int32_t> next(0);
  std::atomic<int> status(kOk);
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n || status.load() != kOk) break;
      PngImage img;
      int rc = DecodePng(paths[i], &img);
      if (rc != kOk) {
        status.store(rc);
        break;
      }
      if (static_cast<int32_t>(img.width) != w ||
          static_cast<int32_t>(img.height) != h ||
          static_cast<int32_t>(img.channels) != c) {
        status.store(kErrGeometry);
        break;
      }
      std::memcpy(out + static_cast<int64_t>(i) * stride, img.pixels.data(),
                  need);
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int32_t t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return status.load();
}

}  // extern "C"
