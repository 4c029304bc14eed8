// JPEG decode on the card (the nvjpeg route of data/native_loader.py):
// nvJPEG decodes a file into a [H, W, C] uint8 buffer on the device
// (C = 1 for one grayscale component, else 3, RGB interleaved), then a
// hand-written kernel resizes it to [side, side, 3] as the host decoder of
// csrc/host/jpeg_decode.cpp does (bilinear_at: half-pixel centres, the
// lower neighbour clamped into the image, the upper one to its last row or
// column; a grayscale file gives three equal channels), either rounded to
// uint8 (jpeg_resize_u8) or scaled to [0, 1] and normalized per channel
// (jpeg_resize_f32). One thread an output value.
//
// The nvJPEG calls run on the caller's stream; the buffers come from the
// caller (torch). Each entry point returns 0 or the nvJPEG / CUDA error.
#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float bilinear_at(const uint8_t* __restrict__ img,
                                             int W, int H, int C, int x,
                                             int y, int c, float sx,
                                             float sy) {
  const float fy = (y + 0.5f) * sy - 0.5f;
  const int y0 = min(max((int)floorf(fy), 0), H - 1);
  const int y1 = min(y0 + 1, H - 1);
  const float wy = fy - y0;
  const float fx = (x + 0.5f) * sx - 0.5f;
  const int x0 = min(max((int)floorf(fx), 0), W - 1);
  const int x1 = min(x0 + 1, W - 1);
  const float wx = fx - x0;
  const int cc = C == 1 ? 0 : c;
  const float v00 = img[((size_t)y0 * W + x0) * C + cc];
  const float v01 = img[((size_t)y0 * W + x1) * C + cc];
  const float v10 = img[((size_t)y1 * W + x0) * C + cc];
  const float v11 = img[((size_t)y1 * W + x1) * C + cc];
  return (1 - wy) * ((1 - wx) * v00 + wx * v01) +
         wy * ((1 - wx) * v10 + wx * v11);
}

struct Norm {
  float mean[3];
  float stdv[3];
};

template <bool kU8>
__global__ void jpeg_resize_kernel(const uint8_t* __restrict__ src, int H,
                                   int W, int C, int side, float sx,
                                   float sy, Norm norm, void* out) {
  const long long n = (long long)side * side * 3;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % 3);
  const long long p = i / 3;
  const int x = (int)(p % side);
  const int y = (int)(p / side);
  const float v = bilinear_at(src, W, H, C, x, y, c, sx, sy);
  if (kU8) {
    static_cast<uint8_t*>(out)[i] =
        (uint8_t)lroundf(fminf(fmaxf(v, 0.0f), 255.0f));
  } else {
    static_cast<float*>(out)[i] = (v / 255.0f - norm.mean[c]) / norm.stdv[c];
  }
}

template <bool kU8>
int launch_resize(const void* src, int H, int W, int C, int side, Norm norm,
                  void* out, void* stream) {
  if (H <= 0 || W <= 0 || side <= 0 || (C != 1 && C != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)side * side * 3;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  // the host decoder's scale: float(W) / side
  const float sx = (float)W / side, sy = (float)H / side;
  jpeg_resize_kernel<kU8><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(src), H, W, C, side, sx, sy, norm, out);
  return (int)cudaGetLastError();
}

struct Handles {
  nvjpegHandle_t handle;
  nvjpegJpegState_t state;
};

}  // namespace

// handles: two pointers' room, filled with the nvJPEG handle and its
// decode state (kept for the life of the process)
extern "C" int jpeg_nvjpeg_open(void* handles) {
  Handles* h = static_cast<Handles*>(handles);
  int err = (int)nvjpegCreateSimple(&h->handle);
  if (err != 0) return err;
  return (int)nvjpegJpegStateCreate(h->handle, &h->state);
}

// info: [components, width, height] of the file's first component
extern "C" int jpeg_nvjpeg_info(void* handles, const void* data,
                                long long n_bytes, int* info) {
  Handles* h = static_cast<Handles*>(handles);
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t sub;
  int err = (int)nvjpegGetImageInfo(
      h->handle, static_cast<const unsigned char*>(data), (size_t)n_bytes,
      &info[0], &sub, widths, heights);
  info[1] = widths[0];
  info[2] = heights[0];
  return err;
}

// out: [H, W, channels] uint8 on the device; channels 1 (the luma of a
// one-component file) or 3 (RGB interleaved)
extern "C" int jpeg_nvjpeg_decode(void* handles, const void* data,
                                  long long n_bytes, int channels, void* out,
                                  int width, void* stream) {
  Handles* h = static_cast<Handles*>(handles);
  if (channels != 1 && channels != 3) {
    return (int)NVJPEG_STATUS_INVALID_PARAMETER;
  }
  nvjpegImage_t img = {};
  img.channel[0] = static_cast<unsigned char*>(out);
  img.pitch[0] = (unsigned)(width * channels);
  return (int)nvjpegDecode(
      h->handle, h->state, static_cast<const unsigned char*>(data),
      (size_t)n_bytes, channels == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI,
      &img, (cudaStream_t)stream);
}

extern "C" int jpeg_resize_u8(const void* src, int H, int W, int C,
                              int side, void* out, void* stream) {
  return launch_resize<true>(src, H, W, C, side, Norm{}, out, stream);
}

extern "C" int jpeg_resize_f32(const void* src, int H, int W, int C,
                               int side, float m0, float m1, float m2,
                               float s0, float s1, float s2, void* out,
                               void* stream) {
  return launch_resize<false>(src, H, W, C, side,
                              Norm{{m0, m1, m2}, {s0, s1, s2}}, out, stream);
}
