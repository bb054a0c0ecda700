// Native host-side JPEG decode + resize for the input pipeline.
//
// The reference feeds its DataLoader workers with full-size PIL decodes
// followed by a torchvision resize.  Endoscopy frames are ~1158x1008 while
// the network consumes 224x224, so most of that decode work is wasted.
// This loader uses libjpeg's DCT-domain scaling (scale_num/8) to decode
// directly at the smallest size >= target, then bilinear-resizes to the
// exact target — typically 4-8x less IDCT work — across a std::thread pool.
//
// C ABI (consumed via ctypes from ssl4polyp_tpu_torch.native):
//   decode_resize(path, out, out_h, out_w)            -> 0 on success
//   decode_resize_batch(paths, n, out, out_h, out_w, n_threads)
//       -> number of successful decodes; failed slots are zero-filled.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

// libjpeg-turbo 2.1.5's headers, kept beside this file: the runtime is the
// libjpeg that PIL has loaded (see __init__.py).
#include "third_party/libjpeg-turbo/jpeglib.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resize (H, W, 3) uint8 -> (out_h, out_w, 3).
void bilinear_resize(const uint8_t* src, int src_h, int src_w,
                     uint8_t* dst, int dst_h, int dst_w) {
  const float scale_y = static_cast<float>(src_h) / dst_h;
  const float scale_x = static_cast<float>(src_w) / dst_w;
  for (int y = 0; y < dst_h; ++y) {
    // Pixel-center convention matching PIL's bilinear resize.
    float fy = (y + 0.5f) * scale_y - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < src_h ? y0 + 1 : src_h - 1;
    float wy = fy - y0;
    for (int x = 0; x < dst_w; ++x) {
      float fx = (x + 0.5f) * scale_x - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < src_w ? x0 + 1 : src_w - 1;
      float wx = fx - x0;
      const uint8_t* p00 = src + (y0 * src_w + x0) * 3;
      const uint8_t* p01 = src + (y0 * src_w + x1) * 3;
      const uint8_t* p10 = src + (y1 * src_w + x0) * 3;
      const uint8_t* p11 = src + (y1 * src_w + x1) * 3;
      uint8_t* out = dst + (y * dst_w + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = p00[c] * (1 - wy) * (1 - wx) + p01[c] * (1 - wy) * wx +
                  p10[c] * wy * (1 - wx) + p11[c] * wy * wx;
        out[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// PIL-convention separable cubic resize (Catmull-Rom a=-0.5) with filter
// scaling on downscale: for scale > 1 the kernel support widens to
// 2*scale and weights are normalized — the same convolution resampling
// PIL/torchvision apply, so the native random-resized-crop matches the
// reference's BICUBIC quality (``main_pretrain.py:156-160``).
float cubic_kernel(float x) {
  constexpr float a = -0.5f;
  x = x < 0 ? -x : x;
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// One resampling axis: precomputed bounds + normalized weights per output
// index (mirrors PIL's precompute_coeffs).
struct ResampleAxis {
  std::vector<int> start;
  std::vector<int> count;
  std::vector<float> weights;  // row-major, max_count per output index
  int max_count = 0;

  void init(int in_size, int in_offset, int in_span, int out_size) {
    const float scale = static_cast<float>(in_span) / out_size;
    const float filterscale = scale < 1.0f ? 1.0f : scale;
    const float support = 2.0f * filterscale;
    max_count = static_cast<int>(support) * 2 + 2;
    start.resize(out_size);
    count.resize(out_size);
    weights.assign(static_cast<size_t>(out_size) * max_count, 0.0f);
    // Taps clamp to the CROP box, not the full image: PIL/torchvision crop
    // first, so their kernels never read out-of-crop pixels and renormalize
    // over in-crop taps only — edge rows/cols must match that.
    int box_lo = in_offset;
    int box_hi = in_offset + in_span;
    if (box_lo < 0) box_lo = 0;
    if (box_hi > in_size) box_hi = in_size;
    for (int i = 0; i < out_size; ++i) {
      const float center = in_offset + (i + 0.5f) * scale;
      int lo = static_cast<int>(center - support + 0.5f);
      int hi = static_cast<int>(center + support + 0.5f);
      if (lo < box_lo) lo = box_lo;
      if (hi > box_hi) hi = box_hi;
      if (hi <= lo) { lo = lo < box_hi - 1 ? lo : box_hi - 1; hi = lo + 1; }
      start[i] = lo;
      count[i] = hi - lo;
      float total = 0.0f;
      float* w = weights.data() + static_cast<size_t>(i) * max_count;
      for (int k = 0; k < hi - lo; ++k) {
        w[k] = cubic_kernel((lo + k - center + 0.5f) / filterscale);
        total += w[k];
      }
      if (total != 0.0f)
        for (int k = 0; k < hi - lo; ++k) w[k] /= total;
    }
  }
};

// Crop (sy, sx, sh, sw) out of (src_h, src_w, 3) and resize to
// (dst_h, dst_w, 3) with the scaled-support cubic filter; optional hflip.
void cubic_crop_resize(const uint8_t* src, int src_h, int src_w,
                       int sy, int sx, int sh, int sw,
                       uint8_t* dst, int dst_h, int dst_w, bool hflip) {
  ResampleAxis xaxis, yaxis;
  xaxis.init(src_w, sx, sw, dst_w);
  yaxis.init(src_h, sy, sh, dst_h);

  // Horizontal pass into a float intermediate restricted to the rows the
  // vertical pass can touch.
  int row_lo = src_h, row_hi = 0;
  for (int y = 0; y < dst_h; ++y) {
    if (yaxis.start[y] < row_lo) row_lo = yaxis.start[y];
    if (yaxis.start[y] + yaxis.count[y] > row_hi)
      row_hi = yaxis.start[y] + yaxis.count[y];
  }
  const int mid_h = row_hi - row_lo;
  std::vector<float> mid(static_cast<size_t>(mid_h) * dst_w * 3);
  for (int y = 0; y < mid_h; ++y) {
    const uint8_t* in_row = src + static_cast<size_t>(row_lo + y) * src_w * 3;
    float* out_row = mid.data() + static_cast<size_t>(y) * dst_w * 3;
    for (int x = 0; x < dst_w; ++x) {
      const float* w = xaxis.weights.data() +
                       static_cast<size_t>(x) * xaxis.max_count;
      float acc[3] = {0.0f, 0.0f, 0.0f};
      const int lo = xaxis.start[x], n = xaxis.count[x];
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = in_row + static_cast<size_t>(lo + k) * 3;
        acc[0] += w[k] * p[0];
        acc[1] += w[k] * p[1];
        acc[2] += w[k] * p[2];
      }
      float* o = out_row + static_cast<size_t>(x) * 3;
      o[0] = acc[0]; o[1] = acc[1]; o[2] = acc[2];
    }
  }
  // Vertical pass + clamp + optional horizontal flip.
  for (int y = 0; y < dst_h; ++y) {
    const float* w = yaxis.weights.data() + static_cast<size_t>(y) * yaxis.max_count;
    const int lo = yaxis.start[y] - row_lo, n = yaxis.count[y];
    uint8_t* out_row = dst + static_cast<size_t>(y) * dst_w * 3;
    for (int x = 0; x < dst_w; ++x) {
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < n; ++k) {
        const float* p = mid.data() +
                         (static_cast<size_t>(lo + k) * dst_w + x) * 3;
        acc[0] += w[k] * p[0];
        acc[1] += w[k] * p[1];
        acc[2] += w[k] * p[2];
      }
      const int out_x = hflip ? dst_w - 1 - x : x;
      uint8_t* o = out_row + static_cast<size_t>(out_x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = acc[c] + 0.5f;
        o[c] = v <= 0.0f ? 0 : (v >= 255.0f ? 255 : static_cast<uint8_t>(v));
      }
    }
  }
}

}  // namespace

extern "C" {

// Header-only read of a JPEG's dimensions (microseconds; lets the host
// sample deterministic crop boxes without decoding).  Returns 0 on success.
int jpeg_dims(const char* path, int* width, int* height) {
  FILE* file = std::fopen(path, "rb");
  if (!file) return 1;
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(file);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, file);
  jpeg_read_header(&cinfo, TRUE);
  *width = static_cast<int>(cinfo.image_width);
  *height = static_cast<int>(cinfo.image_height);
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(file);
  return 0;
}

// Random-resized-crop decode: crop box given as FRACTIONS of the full
// image (fy, fx, fh, fw), decoded at the smallest DCT scale that keeps the
// scaled crop >= (out_h, out_w), rows outside the crop skipped
// (libjpeg-turbo), then cubic-resized into `out` with optional hflip.
int decode_crop_resize(const char* path, uint8_t* out, int out_h, int out_w,
                       double fy, double fx, double fh, double fw,
                       int hflip) {
  FILE* file = std::fopen(path, "rb");
  if (!file) return 1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  std::vector<uint8_t> decoded;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(file);
    return 2;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, file);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // Smallest N/8 scale whose SCALED CROP still covers the target.
  cinfo.scale_num = 8;
  cinfo.scale_denom = 8;
  for (int num = 1; num <= 8; ++num) {
    long sw = static_cast<long>(static_cast<double>(cinfo.image_width) * num / 8 * fw);
    long sh = static_cast<long>(static_cast<double>(cinfo.image_height) * num / 8 * fh);
    if (sw >= out_w && sh >= out_h) {
      cinfo.scale_num = num;
      break;
    }
  }

  jpeg_start_decompress(&cinfo);
  const int src_w = cinfo.output_width;
  const int src_h = cinfo.output_height;
  if (cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(file);
    return 3;
  }

  // Crop box in scaled-image pixels (clamped; degenerate boxes rejected).
  int sy = static_cast<int>(fy * src_h + 0.5);
  int sx = static_cast<int>(fx * src_w + 0.5);
  int sh = static_cast<int>(fh * src_h + 0.5);
  int sw = static_cast<int>(fw * src_w + 0.5);
  if (sy < 0) sy = 0;
  if (sx < 0) sx = 0;
  if (sh < 1) sh = 1;
  if (sw < 1) sw = 1;
  if (sy + sh > src_h) sy = src_h - sh < 0 ? 0 : src_h - sh;
  if (sx + sw > src_w) sx = src_w - sw < 0 ? 0 : src_w - sw;
  if (sh > src_h) sh = src_h;
  if (sw > src_w) sw = src_w;

  // The resampler's taps clamp to the crop box (ResampleAxis::init, matching
  // PIL's crop-then-resize convention), so scanlines outside [sy, sy+sh) are
  // never read — decode exactly the crop rows and skip the rest of the IDCT
  // work.
  int row0 = sy;
  int row1 = sy + sh;

// jpeg_skip_scanlines is a libjpeg-TURBO extension (present whatever
// JPEG_LIB_VERSION emulation level turbo is built with, absent from stock
// IJG libjpeg at any version) — detect turbo via its colorspace-extension
// marker, not the version macro.
#if defined(JCS_EXTENSIONS) || defined(LIBJPEG_TURBO_VERSION)
  if (row0 > 0) {
    jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(row0));
    // jpeg_skip_scanlines may stop short at iMCU boundaries; account for
    // the actual position below via cinfo.output_scanline.
    row0 = static_cast<int>(cinfo.output_scanline);
  }
#else
  row0 = 0;
#endif

  const int kept_h = row1 - row0;
  decoded.resize(static_cast<size_t>(src_w) * kept_h * 3);
  while (static_cast<int>(cinfo.output_scanline) < row1) {
    uint8_t* row = decoded.data() +
        static_cast<size_t>(static_cast<int>(cinfo.output_scanline) - row0) * src_w * 3;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_abort_decompress(&cinfo);  // rest of the image is never needed
  jpeg_destroy_decompress(&cinfo);
  std::fclose(file);

  cubic_crop_resize(decoded.data(), kept_h, src_w,
                    sy - row0, sx, sh, sw, out, out_h, out_w, hflip != 0);
  return 0;
}

// Batched random-resized-crop decode across a thread pool.  `crops` is
// (n, 4) doubles [fy, fx, fh, fw]; `hflips` n bytes; per-frame success in
// `status` (may be null).  Returns the number of successful decodes.
int decode_crop_resize_batch_status(const char** paths, int n, uint8_t* out,
                                    int out_h, int out_w,
                                    const double* crops,
                                    const uint8_t* hflips,
                                    int n_threads, uint8_t* status) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  std::atomic<int> ok(0);
  const size_t frame_bytes = static_cast<size_t>(out_h) * out_w * 3;

  auto worker = [&]() {
    while (true) {
      int index = next.fetch_add(1);
      if (index >= n) break;
      uint8_t* slot = out + frame_bytes * index;
      const double* c = crops + static_cast<size_t>(index) * 4;
      const bool success =
          decode_crop_resize(paths[index], slot, out_h, out_w,
                             c[0], c[1], c[2], c[3],
                             hflips ? hflips[index] : 0) == 0;
      if (success) {
        ok.fetch_add(1);
      } else {
        std::memset(slot, 0, frame_bytes);
      }
      if (status) status[index] = success ? 1 : 0;
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

// Returns 0 on success, nonzero on failure.  `out` must hold out_h*out_w*3.
int decode_resize(const char* path, uint8_t* out, int out_h, int out_w) {
  FILE* file = std::fopen(path, "rb");
  if (!file) return 1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  std::vector<uint8_t> decoded;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(file);
    return 2;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, file);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain downscale: smallest N/8 scale whose output still covers the
  // target in both dimensions.
  cinfo.scale_num = 8;
  cinfo.scale_denom = 8;
  for (int num = 1; num <= 8; ++num) {
    long sw = (static_cast<long>(cinfo.image_width) * num + 7) / 8;
    long sh = (static_cast<long>(cinfo.image_height) * num + 7) / 8;
    if (sw >= out_w && sh >= out_h) {
      cinfo.scale_num = num;
      break;
    }
  }

  jpeg_start_decompress(&cinfo);
  const int src_w = cinfo.output_width;
  const int src_h = cinfo.output_height;
  const int channels = cinfo.output_components;
  if (channels != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(file);
    return 3;
  }
  decoded.resize(static_cast<size_t>(src_w) * src_h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = decoded.data() + static_cast<size_t>(cinfo.output_scanline) * src_w * 3;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(file);

  if (src_h == out_h && src_w == out_w) {
    std::memcpy(out, decoded.data(), static_cast<size_t>(out_h) * out_w * 3);
  } else {
    bilinear_resize(decoded.data(), src_h, src_w, out, out_h, out_w);
  }
  return 0;
}

// Decodes n files into a contiguous (n, out_h, out_w, 3) buffer using a
// thread pool.  Per-frame success is written to `status` (1 = decoded,
// 0 = failed; may be null).  Returns the number of successful decodes.
int decode_resize_batch_status(const char** paths, int n, uint8_t* out,
                               int out_h, int out_w, int n_threads,
                               uint8_t* status) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  std::atomic<int> ok(0);
  const size_t frame_bytes = static_cast<size_t>(out_h) * out_w * 3;

  auto worker = [&]() {
    while (true) {
      int index = next.fetch_add(1);
      if (index >= n) break;
      uint8_t* slot = out + frame_bytes * index;
      const bool success = decode_resize(paths[index], slot, out_h, out_w) == 0;
      if (success) {
        ok.fetch_add(1);
      } else {
        std::memset(slot, 0, frame_bytes);
      }
      if (status) status[index] = success ? 1 : 0;
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

int decode_resize_batch(const char** paths, int n, uint8_t* out,
                        int out_h, int out_w, int n_threads) {
  return decode_resize_batch_status(paths, n, out, out_h, out_w, n_threads,
                                    nullptr);
}

}  // extern "C"
