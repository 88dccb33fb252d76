// Native JPEG decode + CLIP geometric preprocessing (host input pipeline).
//
// Replaces the PIL decode path of `data/pipeline.py::load_pixels` /
// `data/image_ops.py::resize_crop_pil` with a C++ kernel: libjpeg(-turbo)
// decode with DCT-domain scaling, then a PIL-`Imaging`-semantics bicubic
// resize of the shortest edge to `target`, then a center crop to
// (target, target, 3) uint8 RGB.  The reference feeds its models through
// PIL + torchvision on DataLoader workers (`training/train_eval_loop.py:
// 188-189`, `dataset_creation/benchmark/benchmark_dataset.py:100-106`);
// this kernel is the native-throughput equivalent for PCIe-local
// deployments where host decode must keep up with the device (SURVEY
// §7.3).
//
// Two modes (the `fast` argument):
//   fast=0  "PIL parity": power-of-two DCT reduction exactly as
//           `Image.draft` picks it; output matches the PIL path within a
//           small per-pixel tolerance (float vs PIL's 8.8 fixed-point
//           filter arithmetic). Used by parity tests.
//   fast=1  "turbo": the smallest libjpeg-turbo M/8 IDCT scale whose
//           minimum side stays >= target (PIL only supports 1/2^k, so at
//           e.g. 640px source and 336px target it must decode ALL pixels
//           while this mode decodes 5/8-scaled = 39%). Same resampling
//           quality class — the M/8 IDCT is itself a high-quality
//           band-limited downscale; quality delta vs parity mode is
//           test-bounded.
//
// Exported C ABI:
//   int64_t decode_resize_crop(const uint8_t* buf, int64_t len,
//                              int64_t target, uint8_t* out, int64_t fast);
//       -> 0 ok / nonzero error; `out` is (target, target, 3) uint8, RGB.
//   void decode_resize_crop_batch(const uint8_t* data,
//                                 const int64_t* offsets, int64_t n,
//                                 int64_t target, uint8_t* out,
//                                 uint8_t* ok, int64_t fast,
//                                 int64_t nthreads);
//       -> flattened JPEG buffers (offsets[i]..offsets[i+1]); per-image
//          success flags; OpenMP across images.

#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// libjpeg error handling: convert error_exit into a longjmp so a corrupt
// buffer returns an error code instead of calling exit().
// ---------------------------------------------------------------------------

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void emit_message(j_common_ptr, int) {}  // silence warnings

// ---------------------------------------------------------------------------
// PIL-semantics bicubic resampling (Imaging/Resample.c, float arithmetic).
// ---------------------------------------------------------------------------

inline double bicubic_kernel(double x) {
  // Catmull-Rom-style cubic with a = -0.5 (PIL's BICUBIC).
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct FilterTable {
  std::vector<int> xmin;    // first input index per output pixel
  std::vector<int> xmax;    // count of taps per output pixel
  std::vector<float> coef;  // ksize coefficients per output pixel
  int ksize = 0;
};

// Precompute the 1-D filter for in_size -> out_size over the output range
// [out_lo, out_hi).  Mirrors PIL's precompute_coeffs: the filter support
// widens by the scale factor when downscaling ("antialias").
FilterTable precompute_coeffs(int in_size, int out_size, int out_lo,
                              int out_hi) {
  constexpr double support = 2.0;  // bicubic
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double scaled_support = support * filterscale;
  const int ksize = static_cast<int>(std::ceil(scaled_support)) * 2 + 1;

  FilterTable t;
  const int n = out_hi - out_lo;
  t.ksize = ksize;
  t.xmin.resize(n);
  t.xmax.resize(n);
  t.coef.assign(static_cast<size_t>(n) * ksize, 0.0f);

  for (int i = 0; i < n; ++i) {
    const int xx = out_lo + i;
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - scaled_support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + scaled_support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;

    float* k = &t.coef[static_cast<size_t>(i) * ksize];
    double ww = 0.0;
    std::vector<double> raw(xmax);
    for (int x = 0; x < xmax; ++x) {
      raw[x] = bicubic_kernel((x + xmin - center + 0.5) / filterscale);
      ww += raw[x];
    }
    for (int x = 0; x < xmax; ++x)
      k[x] = static_cast<float>(ww != 0.0 ? raw[x] / ww : raw[x]);
    t.xmin[i] = xmin;
    t.xmax[i] = xmax;
  }
  return t;
}

inline uint8_t clamp_u8(float v) {
  const long r = std::lrintf(v);
  if (r <= 0) return 0;
  if (r >= 255) return 255;
  return static_cast<uint8_t>(r);
}

}  // namespace

extern "C" {

// Decode one JPEG buffer and write (target, target, 3) uint8 RGB.
// Error codes: 1 decode failure (corrupt / not a JPEG), 2 unsupported
// colorspace (e.g. CMYK — caller should fall back to PIL), 3 bad args.
int64_t decode_resize_crop(const uint8_t* buf, int64_t len, int64_t target,
                           uint8_t* out, int64_t fast) {
  if (buf == nullptr || len <= 0 || target <= 0 || out == nullptr) return 3;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;

  std::vector<uint8_t> pixels;  // declared before setjmp (destructor runs)
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);

  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW;  // PIL's default IDCT

  const long w0 = static_cast<long>(cinfo.image_width);
  const long h0 = static_cast<long>(cinfo.image_height);
  const long short0 = w0 < h0 ? w0 : h0;
  if (fast) {
    // Smallest M/8 with ceil(short * M / 8) >= target * 9/8 (libjpeg-
    // turbo supports every M in 1..8; PIL draft cannot go below powers
    // of 2). The 9/8 margin keeps the final bicubic resample ratio
    // >= ~1.125 so it, not the IDCT scaling, sets the output's filter
    // character — without it a scale landing exactly on `target` skips
    // resampling entirely and drifts visibly from the PIL reference.
    const long want = target + (target + 7) / 8;
    long m = 8;
    for (long cand = 1; cand <= 8; ++cand) {
      if ((short0 * cand + 7) / 8 >= want) {
        m = cand;
        break;
      }
    }
    cinfo.scale_num = static_cast<unsigned int>(m);
    cinfo.scale_denom = 8;
  } else {
    // PIL draft semantics (JpegImagePlugin.draft): the largest
    // power-of-two denominator that keeps BOTH dimensions >= target;
    // output dims are ceil-divided (libjpeg matches PIL here).
    long denom = (w0 / target < h0 / target) ? w0 / target : h0 / target;
    if (denom >= 8) denom = 8;
    else if (denom >= 4) denom = 4;
    else if (denom >= 2) denom = 2;
    else denom = 1;
    cinfo.scale_num = 1;
    cinfo.scale_denom = static_cast<unsigned int>(denom);
  }

  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  if (w <= 0 || h <= 0 || cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }

  pixels.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels.data() + static_cast<size_t>(cinfo.output_scanline)
                                       * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // Resize shortest edge to `target` (PIL: int(round(...)) = lrint with
  // round-half-even, Python round semantics), then center crop.
  const int t = static_cast<int>(target);
  const int short_side = w < h ? w : h;
  const int new_w =
      static_cast<int>(std::lrint(static_cast<double>(w) * t / short_side));
  const int new_h =
      static_cast<int>(std::lrint(static_cast<double>(h) * t / short_side));
  const int left = (new_w - t) / 2;
  const int top = (new_h - t) / 2;

  FilterTable fx = precompute_coeffs(w, new_w, left, left + t);
  FilterTable fy = precompute_coeffs(h, new_h, top, top + t);

  // Horizontal pass only over the input rows the vertical filter reads
  // (a crop keeps ~t + filter-support of them); vertical pass over the
  // crop rows.  Separable passes commute in float arithmetic, so this
  // equals resize-then-crop.
  const int row_lo = fy.xmin[0];
  const int row_hi = fy.xmin[t - 1] + fy.xmax[t - 1];
  const int rows = row_hi - row_lo;

  std::vector<float> tmp(static_cast<size_t>(rows) * t * 3);
  for (int y = 0; y < rows; ++y) {
    const uint8_t* src = &pixels[static_cast<size_t>(row_lo + y) * w * 3];
    float* dst = &tmp[static_cast<size_t>(y) * t * 3];
    for (int x = 0; x < t; ++x) {
      const float* k = &fx.coef[static_cast<size_t>(x) * fx.ksize];
      const int xmin = fx.xmin[x];
      const int xmax = fx.xmax[x];
      float r = 0.0f, g = 0.0f, b = 0.0f;
      const uint8_t* p = src + static_cast<size_t>(xmin) * 3;
      for (int i = 0; i < xmax; ++i, p += 3) {
        const float wgt = k[i];
        r += p[0] * wgt;
        g += p[1] * wgt;
        b += p[2] * wgt;
      }
      dst[x * 3 + 0] = r;
      dst[x * 3 + 1] = g;
      dst[x * 3 + 2] = b;
    }
  }

  std::vector<float> acc(static_cast<size_t>(t) * 3);
  for (int y = 0; y < t; ++y) {
    const float* k = &fy.coef[static_cast<size_t>(y) * fy.ksize];
    const int ymin = fy.xmin[y] - row_lo;
    const int ymax = fy.xmax[y];
    uint8_t* dst = out + static_cast<size_t>(y) * t * 3;
    // Tap-outer / x-inner: each tap is one contiguous axpy over the row
    // (vectorizes fully; the x-outer form strides by t*3 per tap).
    std::memset(acc.data(), 0, acc.size() * sizeof(float));
    for (int i = 0; i < ymax; ++i) {
      const float wgt = k[i];
      const float* row = &tmp[static_cast<size_t>(ymin + i) * t * 3];
      for (int x = 0; x < t * 3; ++x) acc[x] += row[x] * wgt;
    }
    for (int x = 0; x < t * 3; ++x) dst[x] = clamp_u8(acc[x]);
  }
  return 0;
}

// Batch variant: flattened JPEG bytes + (n+1) offsets; out is
// (n, target, target, 3); ok[i] = 1 on success.  OpenMP across images
// (nthreads <= 0 -> runtime default).
void decode_resize_crop_batch(const uint8_t* data, const int64_t* offsets,
                              int64_t n, int64_t target, uint8_t* out,
                              uint8_t* ok, int64_t fast, int64_t nthreads) {
  const int64_t frame = target * target * 3;
#ifdef _OPENMP
  const int nt = nthreads > 0 ? static_cast<int>(nthreads)
                              : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic) num_threads(nt)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = offsets[i];
    const int64_t hi = offsets[i + 1];
    const int64_t rc = decode_resize_crop(data + lo, hi - lo, target,
                                          out + i * frame, fast);
    ok[i] = rc == 0 ? 1 : 0;
    if (rc != 0)
      std::memset(out + i * frame, 0, static_cast<size_t>(frame));
  }
}

}  // extern "C"
