// Native image decode + resize for the host input pipeline.
//
// The reference decodes with skimage.io.imread inside DataLoader worker
// processes (dp/loader.py:44, num_workers=6 at train.py:114). This host has
// ONE core (measured: nproc=1), so Python-side worker pools cannot scale
// decode; instead the decode itself is made cheap and is used primarily by
// the one-time pack step (tpuic/data/pack.py) that converts an ImageFolder
// tree into a memory-mapped uint8 cache served at memory bandwidth.
//
// - JPEG via libjpeg, using DCT scaled decode (scale_num/8): the decoder
//   emits the smallest IDCT scale that still covers the target size, so a
//   4000px photo resized to 224 decodes ~8x faster than full-resolution.
// - PNG via libpng (palette/gray/alpha all normalized to 8-bit RGB).
// - Final nearest-neighbor resize matches cv2.INTER_NEAREST semantics
//   (src index = floor(dst * src/dst), clamped) — identical to
//   tpuic/data/transforms.py:resize_nearest and dataprep.cpp.
//
// C ABI only (ctypes; no pybind11 in this image). Thread-safe: no globals;
// libjpeg/libpng error paths use setjmp per call.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// cv2.INTER_NEAREST source index map (parity with transforms.resize_nearest).
inline void nearest_map(int dst, int src, std::vector<int>& out) {
  out.resize(dst);
  const double scale = static_cast<double>(src) / dst;
  for (int i = 0; i < dst; ++i) {
    int v = static_cast<int>(i * scale);
    out[i] = v < src - 1 ? v : src - 1;
  }
}

// RGB HWC [h,w,3] -> nearest-resized [s,s,3].
void resize_nearest_rgb(const uint8_t* src, int h, int w, uint8_t* dst,
                        int s) {
  std::vector<int> rows, cols;
  nearest_map(s, h, rows);
  nearest_map(s, w, cols);
  for (int i = 0; i < s; ++i) {
    const uint8_t* rp = src + static_cast<int64_t>(rows[i]) * w * 3;
    uint8_t* dp = dst + static_cast<int64_t>(i) * s * 3;
    for (int j = 0; j < s; ++j) {
      const uint8_t* p = rp + cols[j] * 3;
      dp[j * 3 + 0] = p[0];
      dp[j * 3 + 1] = p[1];
      dp[j * 3 + 2] = p[2];
    }
  }
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode JPEG bytes -> RGB rows, DCT-scaled to the smallest size >= target
// (or full size when target <= 0). Returns 0 on success.
int decode_jpeg(const uint8_t* data, int64_t len, int target,
                std::vector<uint8_t>& pixels, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  // All C++ objects with destructors are constructed BEFORE setjmp:
  // longjmp over a live object's construction point is UB and leaks its
  // buffer. `pixels` is caller-owned; `row` lives here, resized later.
  std::vector<uint8_t> row;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_RGB;
  if (target > 0) {
    // Pick num/8 so that min(h,w)*num/8 >= target, num in 1..8.
    const int src_min = cinfo.image_height < cinfo.image_width
                            ? cinfo.image_height
                            : cinfo.image_width;
    int num = 8;
    while (num > 1 &&
           static_cast<int64_t>(src_min) * (num - 1) / 8 >= target) {
      --num;
    }
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height, w = cinfo.output_width;
  const int ch = cinfo.output_components;  // 3 for JCS_RGB
  pixels.resize(static_cast<int64_t>(h) * w * 3);
  row.resize(static_cast<int64_t>(w) * ch);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rp = row.data();
    jpeg_read_scanlines(&cinfo, &rp, 1);
    uint8_t* dp =
        pixels.data() + static_cast<int64_t>(cinfo.output_scanline - 1) * w * 3;
    if (ch == 3) {
      std::memcpy(dp, row.data(), static_cast<size_t>(w) * 3);
    } else {  // grayscale broadcast (transforms.to_rgb semantics)
      for (int j = 0; j < w; ++j) {
        dp[j * 3 + 0] = dp[j * 3 + 1] = dp[j * 3 + 2] = row[j * ch];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = h;
  *out_w = w;
  return 0;
}

struct PngReadState {
  const uint8_t* data;
  int64_t len;
  int64_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t count) {
  PngReadState* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + static_cast<int64_t>(count) > st->len) {
    png_error(png, "read past end");
  }
  std::memcpy(out, st->data + st->pos, count);
  st->pos += static_cast<int64_t>(count);
}

// Decode PNG bytes -> 8-bit RGB (palette expanded, 16-bit stripped, alpha
// dropped — reference keeps the first 3 channels, dp/loader.py:45).
int decode_png(const uint8_t* data, int64_t len, std::vector<uint8_t>& pixels,
               int* out_h, int* out_w) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 1;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 1;
  }
  // Constructed BEFORE setjmp (same rule as decode_jpeg's `row`):
  // png_error longjmps out of png_read_image, and a vector whose lifetime
  // began after setjmp never runs its destructor on that path — every
  // corrupt PNG then leaks its row-pointer block (found by the ASan
  // harness, tests/test_native_sanitize.py).
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  png_set_expand(png);          // palette->RGB, gray<8bit->8bit, tRNS->alpha
  png_set_strip_16(png);        // 16-bit -> 8-bit
  png_set_strip_alpha(png);     // drop alpha (keep first 3 channels)
  png_set_gray_to_rgb(png);     // gray -> RGB broadcast
  png_read_update_info(png, info);
  const int h = static_cast<int>(png_get_image_height(png, info));
  const int w = static_cast<int>(png_get_image_width(png, info));
  if (png_get_rowbytes(png, info) != static_cast<size_t>(w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 1;
  }
  pixels.resize(static_cast<int64_t>(h) * w * 3);
  rows.resize(h);
  for (int i = 0; i < h; ++i) {
    rows[i] = pixels.data() + static_cast<int64_t>(i) * w * 3;
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *out_h = h;
  *out_w = w;
  return 0;
}

}  // namespace

extern "C" {

// Decode (JPEG or PNG, sniffed from magic bytes) and nearest-resize to
// [size, size, 3] uint8. Returns 0 ok, nonzero on any failure (caller falls
// back to the PIL path).
int tpuic_decode_resize(const uint8_t* data, int64_t len, int size,
                        uint8_t* out) {
  if (len < 4 || size <= 0) return 1;
  std::vector<uint8_t> pixels;
  int h = 0, w = 0;
  int rc;
  if (data[0] == 0xFF && data[1] == 0xD8) {
    rc = decode_jpeg(data, len, size, pixels, &h, &w);
  } else if (data[0] == 0x89 && data[1] == 'P') {
    rc = decode_png(data, len, pixels, &h, &w);
  } else {
    return 2;  // unsupported container; caller uses PIL
  }
  if (rc != 0 || h <= 0 || w <= 0) return 1;
  resize_nearest_rgb(pixels.data(), h, w, out, size);
  return 0;
}

// Decode only (no resize): h/w returned via pointers; out must hold
// max_len bytes. Returns 0 ok, -1 buffer too small, else decode error.
int tpuic_decode(const uint8_t* data, int64_t len, uint8_t* out,
                 int64_t max_len, int* out_h, int* out_w) {
  if (len < 4) return 1;
  std::vector<uint8_t> pixels;
  int h = 0, w = 0;
  int rc;
  if (data[0] == 0xFF && data[1] == 0xD8) {
    rc = decode_jpeg(data, len, 0, pixels, &h, &w);
  } else if (data[0] == 0x89 && data[1] == 'P') {
    rc = decode_png(data, len, pixels, &h, &w);
  } else {
    return 2;
  }
  if (rc != 0) return rc;
  if (static_cast<int64_t>(pixels.size()) > max_len) return -1;
  std::memcpy(out, pixels.data(), pixels.size());
  *out_h = h;
  *out_w = w;
  return 0;
}

int tpuic_decode_abi_version() { return 1; }

}  // extern "C"
