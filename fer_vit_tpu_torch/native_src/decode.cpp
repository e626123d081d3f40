// fervit_decode — native batch image decoder for the data pipeline.
//
// The reference decodes per-sample with PIL inside DataLoader workers
// (reference: data/generate_latents.py:66-73, data/image_dataset.py:117-130).
// This library is the PyTorch port's host-side native equivalent, a copy of
// fer_vit_tpu/native_src/decode.cpp: a thread-pool batch decoder (JPEG via
// libjpeg, PNG via libpng), grayscale→RGB expansion, and PIL-compatible
// triangle-filter (BILINEAR, antialiased on downscale) resampling — so the
// latent production pipeline (fer_vit_tpu_torch/data/generate_latents.py)
// does not wait on Python image decode.
//
// Corrupt/undecodable files yield a black image (the reference's fallback,
// data/image_dataset.py:125-130) and count toward the returned failure total.
//
// Build (fer_vit_tpu_torch/data/native_decode.py does this on demand):
//   g++ -O3 -shared -fPIC -o libfervit_decode.so decode.cpp \
//       -ljpeg -lpng -lpthread

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode JPEG bytes to RGB8. Returns false on failure.
bool DecodeJpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void PngReadFn(png_structp png, png_bytep out, png_size_t n) {
  auto* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) png_error(png, "eof");
  memcpy(out, st->data + st->pos, n);
  st->pos += n;
}

bool DecodePng(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
               int* w, int* h) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, PngReadFn);
  png_read_info(png, info);
  // normalize everything to 8-bit RGB
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  if (png_get_rowbytes(png, info) != size_t(*w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  rgb->resize(size_t(*w) * *h * 3);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; ++y) rows[y] = rgb->data() + size_t(y) * *w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// PIL-compatible separable triangle (BILINEAR) resampling with antialiasing
// on downscale: filterscale = max(1, in/out); weights normalized per output
// pixel (Pillow's ImagingResampleHorizontal semantics, float accumulation).
struct ResampleCoeffs {
  std::vector<int> xmin, xlen;
  std::vector<float> weights;  // packed per output pixel
  int max_len = 0;
};

ResampleCoeffs BuildCoeffs(int in_size, int out_size) {
  ResampleCoeffs rc;
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // triangle support = 1
  rc.xmin.resize(out_size);
  rc.xlen.resize(out_size);
  int klen = int(ceil(support)) * 2 + 1;
  rc.weights.assign(size_t(out_size) * klen, 0.0f);
  rc.max_len = klen;
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double total = 0.0;
    std::vector<double> k(xmax - xmin);
    for (int x = xmin; x < xmax; ++x) {
      double t = (x - center + 0.5) / filterscale;
      double v = t < 0 ? -t : t;
      double wgt = v < 1.0 ? 1.0 - v : 0.0;
      k[x - xmin] = wgt;
      total += wgt;
    }
    rc.xmin[xx] = xmin;
    rc.xlen[xx] = xmax - xmin;
    for (int i = 0; i < xmax - xmin; ++i)
      rc.weights[size_t(xx) * klen + i] =
          total > 0 ? float(k[i] / total) : 0.0f;
  }
  return rc;
}

inline uint8_t ClampByte(float v) {
  int r = int(v + 0.5f);
  return r < 0 ? 0 : (r > 255 ? 255 : uint8_t(r));
}

// Resize RGB8 (in_h, in_w) → out (out_h, out_w), both HWC.
void ResizeTriangle(const uint8_t* in, int in_h, int in_w, uint8_t* out,
                    int out_h, int out_w) {
  if (in_h == out_h && in_w == out_w) {
    memcpy(out, in, size_t(in_h) * in_w * 3);
    return;
  }
  ResampleCoeffs cx = BuildCoeffs(in_w, out_w);
  ResampleCoeffs cy = BuildCoeffs(in_h, out_h);
  // horizontal pass into float temp (in_h, out_w)
  std::vector<float> tmp(size_t(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = in + size_t(y) * in_w * 3;
    float* trow = tmp.data() + size_t(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const float* wgt = &cx.weights[size_t(xx) * cx.max_len];
      int x0 = cx.xmin[xx], n = cx.xlen[xx];
      float r = 0, g = 0, b = 0;
      for (int i = 0; i < n; ++i) {
        const uint8_t* px = row + size_t(x0 + i) * 3;
        r += wgt[i] * px[0];
        g += wgt[i] * px[1];
        b += wgt[i] * px[2];
      }
      trow[xx * 3 + 0] = r;
      trow[xx * 3 + 1] = g;
      trow[xx * 3 + 2] = b;
    }
  }
  // vertical pass
  for (int yy = 0; yy < out_h; ++yy) {
    const float* wgt = &cy.weights[size_t(yy) * cy.max_len];
    int y0 = cy.xmin[yy], n = cy.xlen[yy];
    uint8_t* orow = out + size_t(yy) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      float acc = 0;
      for (int i = 0; i < n; ++i)
        acc += wgt[i] * tmp[size_t(y0 + i) * out_w * 3 + x];
      orow[x] = ClampByte(acc);
    }
  }
}

bool DecodeOne(const char* path, uint8_t* out, int out_h, int out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (len <= 0) {
    fclose(f);
    return false;
  }
  std::vector<uint8_t> buf(len);
  size_t rd = fread(buf.data(), 1, len, f);
  fclose(f);
  if (rd != size_t(len)) return false;

  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  bool ok = false;
  if (len >= 2 && buf[0] == 0xFF && buf[1] == 0xD8)
    ok = DecodeJpeg(buf.data(), len, &rgb, &w, &h);
  else if (len >= 8 && !png_sig_cmp(buf.data(), 0, 8))
    ok = DecodePng(buf.data(), len, &rgb, &w, &h);
  if (!ok || w <= 0 || h <= 0) return false;
  ResizeTriangle(rgb.data(), h, w, out, out_h, out_w);
  return true;
}

}  // namespace

extern "C" {

// Decode n images into out (n, out_h, out_w, 3) uint8. Failed files are
// left black. Returns the number of failures.
int fervit_decode_batch(const char** paths, int n, uint8_t* out, int out_h,
                        int out_w, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failures(0);
  size_t stride = size_t(out_h) * out_w * 3;
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      uint8_t* dst = out + size_t(i) * stride;
      if (!DecodeOne(paths[i], dst, out_h, out_w)) {
        memset(dst, 0, stride);
        failures.fetch_add(1);
      }
    }
  };
  if (n_threads == 1 || n == 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    int nt = n_threads < n ? n_threads : n;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

int fervit_decode_version() { return 1; }

}  // extern "C"
