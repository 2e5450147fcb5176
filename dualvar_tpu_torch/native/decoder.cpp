// Native data-path runtime of dualvar_tpu_torch: JPEG decode and resize.
//
// The training step's host-side cost is JPEG decode + resize of 32-48
// frames per sample (the reference pays it via PIL inside dataloader worker
// processes, dataset/local_dataset.py:150). This library does the same work
// in C++: libjpeg decode straight into an antialiased separable bicubic
// resampler (PIL-equivalent Catmull-Rom a=-0.5 kernel with support scaled
// for downsampling), fanned out over a std::thread pool, writing into a
// caller-provided contiguous uint8 batch buffer.
//
// Host code, not a device kernel: built with g++ and libjpeg, C ABI only,
// loaded with ctypes by dualvar_tpu_torch/native/__init__.py, which builds it
// at first use into build/native/ with the flags named there.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

#include <fcntl.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, error-resilient)
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode a JPEG byte buffer to tightly packed RGB. Returns false on failure.
// target_w/target_h > 0 enable DCT-domain scaled decode (the "fast" path):
// libjpeg decodes at the smallest k/8 scale that still covers the target,
// skipping most of the IDCT work — the caller's bicubic resample then does
// the final (small) reduction. Not bitwise-equal to full decode + resample;
// callers keep it opt-in.
bool decode_rgb(const uint8_t* data, size_t size, std::vector<uint8_t>& rgb,
                int* w, int* h, int target_w = 0, int target_h = 0) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (target_w > 0 && target_h > 0) {
    const int iw = static_cast<int>(cinfo.image_width);
    const int ih = static_cast<int>(cinfo.image_height);
    int k = 8;
    // smallest k/8 whose scaled dims still cover the target (never upscale)
    for (int c = 1; c <= 8; ++c) {
      if (static_cast<long>(iw) * c >= static_cast<long>(target_w) * 8 &&
          static_cast<long>(ih) * c >= static_cast<long>(target_h) * 8) {
        k = c;
        break;
      }
    }
    cinfo.scale_num = static_cast<unsigned>(k);
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb.resize(static_cast<size_t>(*w) * *h * 3);
  const size_t stride = static_cast<size_t>(*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// separable bicubic resample with downscale antialiasing (PIL-style)
// ---------------------------------------------------------------------------

inline double bicubic(double x) {
  // Catmull-Rom-family kernel, a = -0.5 (PIL BICUBIC)
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Coeffs {
  std::vector<int> bounds;      // 2 per output pixel: start, count
  std::vector<double> weights;  // ksize per output pixel
  int ksize;
};

Coeffs precompute(int in_size, int out_size) {
  constexpr double support0 = 2.0;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = support0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  Coeffs c;
  c.ksize = ksize;
  c.bounds.resize(2 * out_size);
  c.weights.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int i = 0; i < out_size; ++i) {
    // window rounding and tap positions follow PIL's ImagingResampleHorizontal
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double* w = &c.weights[static_cast<size_t>(i) * ksize];
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      const double v = bicubic((x - center + 0.5) / filterscale);
      w[x - xmin] = v;
      total += v;
    }
    if (total != 0.0)
      for (int x = 0; x < xmax - xmin; ++x) w[x] /= total;
    c.bounds[2 * i] = xmin;
    c.bounds[2 * i + 1] = xmax - xmin;
  }
  return c;
}

inline uint8_t clamp_u8(double v) {
  return static_cast<uint8_t>(v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v + 0.5));
}

// resize rgb (in_h, in_w, 3) -> out (out_h, out_w, 3)
void resize_bicubic(const uint8_t* in, int in_w, int in_h, uint8_t* out,
                    int out_w, int out_h) {
  const Coeffs cx = precompute(in_w, out_w);
  const Coeffs cy = precompute(in_h, out_h);
  // horizontal pass into double buffer (in_h, out_w, 3)
  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * in_w * 3;
    float* trow = &tmp[static_cast<size_t>(y) * out_w * 3];
    for (int x = 0; x < out_w; ++x) {
      const int x0 = cx.bounds[2 * x];
      const int n = cx.bounds[2 * x + 1];
      const double* w = &cx.weights[static_cast<size_t>(x) * cx.ksize];
      float r = 0, g = 0, b = 0;
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = row + static_cast<size_t>(x0 + k) * 3;
        r += w[k] * p[0];
        g += w[k] * p[1];
        b += w[k] * p[2];
      }
      trow[x * 3 + 0] = r;
      trow[x * 3 + 1] = g;
      trow[x * 3 + 2] = b;
    }
  }
  // vertical pass
  for (int y = 0; y < out_h; ++y) {
    const int y0 = cy.bounds[2 * y];
    const int n = cy.bounds[2 * y + 1];
    const double* w = &cy.weights[static_cast<size_t>(y) * cy.ksize];
    uint8_t* orow = out + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      float acc = 0;
      for (int k = 0; k < n; ++k)
        acc += static_cast<float>(w[k]) * tmp[static_cast<size_t>(y0 + k) * out_w * 3 + x];
      orow[x] = clamp_u8(acc);
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  buf.resize(static_cast<size_t>(n));
  const size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return got == buf.size();
}

// decode one file into out slot (short-side resize when out dims carry sign
// convention below, else fixed resize)
bool decode_one(const char* path, int out_h, int out_w, uint8_t* out,
                int fast) {
  std::vector<uint8_t> file, rgb;
  if (!read_file(path, file)) return false;
  int w = 0, h = 0;
  if (!decode_rgb(file.data(), file.size(), rgb, &w, &h,
                  fast ? out_w : 0, fast ? out_h : 0))
    return false;
  resize_bicubic(rgb.data(), w, h, out, out_w, out_h);
  return true;
}

}  // namespace

extern "C" {

// Decode `n` JPEG files, each resized to (out_h, out_w), into the contiguous
// buffer `out` of shape (n, out_h, out_w, 3) uint8, using `n_threads`
// workers. Returns the number of successfully decoded frames (== n on full
// success); failed slots are zero-filled. `fast` != 0 enables DCT-domain
// scaled decode (see decode_rgb) — ~equal pixels, not bitwise PIL parity.
int dv_decode_files(const char** paths, int n, int out_h, int out_w,
                    uint8_t* out, int n_threads, int fast) {
  const size_t frame = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<int> next(0), ok(0);
  const int workers = std::max(1, std::min(n_threads, n));
  auto work = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      uint8_t* slot = out + frame * i;
      if (decode_one(paths[i], out_h, out_w, slot, fast)) {
        ok.fetch_add(1);
      } else {
        std::memset(slot, 0, frame);
      }
    }
  };
  if (workers == 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    ts.reserve(workers);
    for (int t = 0; t < workers; ++t) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return ok.load();
}

// In-memory variant: decode `n` JPEG buffers (ptrs/sizes) to (n, H, W, 3).
int dv_decode_buffers(const uint8_t** bufs, const size_t* sizes, int n,
                      int out_h, int out_w, uint8_t* out, int n_threads,
                      int fast) {
  const size_t frame = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<int> next(0), ok(0);
  const int workers = std::max(1, std::min(n_threads, n));
  auto work = [&]() {
    std::vector<uint8_t> rgb;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      uint8_t* slot = out + frame * i;
      int w = 0, h = 0;
      if (decode_rgb(bufs[i], sizes[i], rgb, &w, &h,
                     fast ? out_w : 0, fast ? out_h : 0)) {
        resize_bicubic(rgb.data(), w, h, slot, out_w, out_h);
        ok.fetch_add(1);
      } else {
        std::memset(slot, 0, frame);
      }
    }
  };
  if (workers == 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    ts.reserve(workers);
    for (int t = 0; t < workers; ++t) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return ok.load();
}

// Ask the kernel to pull `n` files into the page cache ahead of their
// decode (posix_fadvise WILLNEED on the whole file — the kernel queues
// async readahead and returns immediately). Cold-cache frame trees are
// IO-latency-bound per frame; hinting one batch ahead overlaps the disk
// reads of batch b+1 with the decode of batch b. Best-effort: returns the
// number of files successfully advised (missing files are skipped — the
// decode path reports those properly).
int dv_readahead_files(const char** paths, int n) {
  int ok = 0;
  for (int i = 0; i < n; ++i) {
    const int fd = open(paths[i], O_RDONLY);
    if (fd < 0) continue;
#if defined(POSIX_FADV_WILLNEED)
    if (posix_fadvise(fd, 0, 0, POSIX_FADV_WILLNEED) == 0) ++ok;
#else
    ++ok;
#endif
    close(fd);
  }
  return ok;
}

// Standalone resize for testing: (in_h, in_w, 3) u8 -> (out_h, out_w, 3) u8.
void dv_resize_bicubic(const uint8_t* in, int in_h, int in_w, uint8_t* out,
                       int out_h, int out_w) {
  resize_bicubic(in, in_w, in_h, out, out_w, out_h);
}

}  // extern "C"
