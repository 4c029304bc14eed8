// Host JPEG decode for the port's image feed (libjpeg route): the port's
// own copy of the decoder of native/mmedema_native.cpp (decode_to_rgb,
// bilinear_at, decode_jpeg_resize_normalize, decode_jpeg_resize_u8,
// decode_jpeg_batch, decode_jpeg_batch_u8), with the same C ABI and the
// same arithmetic. Built with g++ at first use by data/native_loader.py
// (-O3 -mavx2 -mfma: the flags whose float contraction gives the JAX
// package's pixels bit for bit) and linked against libjpeg.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <setjmp.h>

extern "C" {


namespace {
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};
void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode JPEG bytes into an RGB u8 buffer; returns 0 on success and fills
// (W, H, img). Shared by the f32-normalized and u8-cache output paths.
int decode_to_rgb(const uint8_t* data, int64_t n_bytes, int* W_out,
                  int* H_out, std::vector<uint8_t>* img) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, n_bytes);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int W = cinfo.output_width, H = cinfo.output_height;
  img->resize((size_t)W * H * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp = img->data() + (size_t)cinfo.output_scanline * W * 3;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *W_out = W;
  *H_out = H;
  return 0;
}

// Bilinear sample at output pixel (x, y, c) from a W×H RGB u8 image.
inline float bilinear_at(const std::vector<uint8_t>& img, int W, int H,
                         int x, int y, int c, float sx, float sy) {
  float fy = (y + 0.5f) * sy - 0.5f;
  int y0 = std::clamp((int)std::floor(fy), 0, H - 1);
  int y1 = std::min(y0 + 1, H - 1);
  float wy = fy - y0;
  float fx = (x + 0.5f) * sx - 0.5f;
  int x0 = std::clamp((int)std::floor(fx), 0, W - 1);
  int x1 = std::min(x0 + 1, W - 1);
  float wx = fx - x0;
  float v00 = img[((size_t)y0 * W + x0) * 3 + c];
  float v01 = img[((size_t)y0 * W + x1) * 3 + c];
  float v10 = img[((size_t)y1 * W + x0) * 3 + c];
  float v11 = img[((size_t)y1 * W + x1) * 3 + c];
  return (1 - wy) * ((1 - wx) * v00 + wx * v01) +
         wy * ((1 - wx) * v10 + wx * v11);
}
}  // namespace

// Decode a JPEG, bilinear-resize to side x side, scale to [0,1] and
// normalize with (mean, std) per channel. Output HWC float32. Returns 0 on
// success, nonzero on decode failure.
int decode_jpeg_resize_normalize(const uint8_t* data, int64_t n_bytes,
                                 int32_t side, const float* mean,
                                 const float* stdv, float* out) {
  int W, H;
  std::vector<uint8_t> img;
  if (decode_to_rgb(data, n_bytes, &W, &H, &img)) return 1;
  const float sx = (float)W / side, sy = (float)H / side;
  for (int y = 0; y < side; ++y)
    for (int x = 0; x < side; ++x)
      for (int c = 0; c < 3; ++c) {
        float v = bilinear_at(img, W, H, x, y, c, sx, sy);
        out[((size_t)y * side + x) * 3 + c] =
            (v / 255.0f - mean[c]) / stdv[c];
      }
  return 0;
}

// Decode + bilinear-resize to side x side, ROUNDED uint8 (no
// normalization). Fills the decode-once uint8 cache; per-step
// normalization then happens on-device from the cached bytes — the
// recovery path when host decode can't keep up with device rate.
int decode_jpeg_resize_u8(const uint8_t* data, int64_t n_bytes, int32_t side,
                          uint8_t* out) {
  int W, H;
  std::vector<uint8_t> img;
  if (decode_to_rgb(data, n_bytes, &W, &H, &img)) return 1;
  const float sx = (float)W / side, sy = (float)H / side;
  for (int y = 0; y < side; ++y)
    for (int x = 0; x < side; ++x)
      for (int c = 0; c < 3; ++c) {
        float v = bilinear_at(img, W, H, x, y, c, sx, sy);
        out[((size_t)y * side + x) * 3 + c] =
            (uint8_t)std::lround(std::clamp(v, 0.0f, 255.0f));
      }
  return 0;
}

// Batched multithreaded JPEG decode: byte blobs are concatenated with an
// offsets array. Failed decodes leave zeros and set status[i]=1.
void decode_jpeg_batch(const uint8_t* blob, const int64_t* offsets,
                       int64_t n_images, int32_t side, const float* mean,
                       const float* stdv, float* out, int32_t* status,
                       int32_t n_threads) {
  n_threads = std::max(1, (int)n_threads);
  std::vector<std::thread> workers;
  std::atomic<int64_t> next{0};
  const int64_t px = (int64_t)side * side * 3;
  auto work = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < n_images) {
      status[i] = decode_jpeg_resize_normalize(
          blob + offsets[i], offsets[i + 1] - offsets[i], side, mean, stdv,
          out + i * px);
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work);
  for (auto& w : workers) w.join();
}

// Batched multithreaded decode to the uint8 cache layout (see
// decode_jpeg_resize_u8).
void decode_jpeg_batch_u8(const uint8_t* blob, const int64_t* offsets,
                          int64_t n_images, int32_t side, uint8_t* out,
                          int32_t* status, int32_t n_threads) {
  n_threads = std::max(1, (int)n_threads);
  std::vector<std::thread> workers;
  std::atomic<int64_t> next{0};
  const int64_t px = (int64_t)side * side * 3;
  auto work = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < n_images) {
      status[i] = decode_jpeg_resize_u8(blob + offsets[i],
                                        offsets[i + 1] - offsets[i], side,
                                        out + i * px);
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work);
  for (auto& w : workers) w.join();
}

}  // extern "C"
