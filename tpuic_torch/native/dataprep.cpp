// Fused image-prep kernel for the host input pipeline.
//
// The reference does resize / rot90 / flips / color jitter / normalize as
// separate full-image passes in Python workers (dp/loader.py:39-91 via
// cv2 + numpy). At TPU pod scale the input pipeline is the bottleneck
// (SURVEY.md §7 "hard parts"), so this implements the whole per-sample chain
// as ONE gather loop over destination pixels: every geometry op is an index
// permutation, so resize+rot90+vflip+hflip collapse into a single source-index
// computation, and the color op + /255 + (x-mean)/std normalize are applied
// to each gathered pixel in registers. One pass, no intermediate images.
//
// Numeric parity contract (tests/test_native.py): bitwise-equal with the
// NumPy path in tpuic/data/transforms.py for geometry+normalize; the color
// ops match to float32 rounding.
//
// C ABI only (called via ctypes; no pybind11 in this image).

#include <cstdint>
#include <cmath>
#include <vector>

namespace {

// cv2.INTER_NEAREST source index: floor(dst * (src/dst)), clamped.
inline void nearest_map(int dst, int src, std::vector<int>& out) {
  out.resize(dst);
  const double scale = static_cast<double>(src) / dst;
  for (int i = 0; i < dst; ++i) {
    int v = static_cast<int>(i * scale);
    out[i] = v < src - 1 ? v : src - 1;
  }
}

// Inverse geometry: dst (i, j) -> coords in the resized (pre-augment) image.
// Forward chain (transforms.py augment): a = rot90^k(resized);
// b = vflip ? a[::-1] : a; out = hflip ? b[:, ::-1] : b.
inline void invert_geometry(int i, int j, int s, int rot_k, int vflip,
                            int hflip, int* ri, int* rj) {
  if (hflip) j = s - 1 - j;
  if (vflip) i = s - 1 - i;
  // Invert rot90^k: rot90 maps in[r, c] -> out[? ]: out[i, j] = in[j, s-1-i].
  // So in-coords of out (i, j) are (j, s-1-i); apply k times.
  for (int t = 0; t < (rot_k & 3); ++t) {
    int ni = j, nj = s - 1 - i;
    i = ni; j = nj;
  }
  *ri = i; *rj = j;
}

}  // namespace

extern "C" {

// src: uint8 HWC [h, w, 3] (contiguous). dst: float32 [s, s, 3].
// color_op: 0 none, 1 saturation, 2 brightness, 3 contrast (factor applies).
// mean3/std3: normalize constants in 0..1 space (transforms.py:94-101).
void tpuic_prep_image(const uint8_t* src, int h, int w, float* dst, int s,
                      int rot_k, int vflip, int hflip, int color_op,
                      float factor, const float* mean3, const float* std3) {
  std::vector<int> rows, cols;
  nearest_map(s, h, rows);
  nearest_map(s, w, cols);

  float gmean = 0.0f;  // global gray mean of the resized image (contrast op)
  if (color_op == 3) {
    double acc = 0.0;
    for (int i = 0; i < s; ++i) {
      const uint8_t* rp = src + static_cast<int64_t>(rows[i]) * w * 3;
      for (int j = 0; j < s; ++j) {
        const uint8_t* p = rp + cols[j] * 3;
        acc += p[0]; acc += p[1]; acc += p[2];
      }
    }
    gmean = static_cast<float>(acc / (static_cast<double>(s) * s * 3));
  }

  const float luma[3] = {0.299f, 0.587f, 0.114f};
  for (int i = 0; i < s; ++i) {
    for (int j = 0; j < s; ++j) {
      int ri, rj;
      invert_geometry(i, j, s, rot_k, vflip, hflip, &ri, &rj);
      const uint8_t* p =
          src + (static_cast<int64_t>(rows[ri]) * w + cols[rj]) * 3;
      float rgb[3] = {static_cast<float>(p[0]), static_cast<float>(p[1]),
                      static_cast<float>(p[2])};
      switch (color_op) {
        case 1: {  // saturation: blend with per-pixel luma gray
          float gray =
              rgb[0] * luma[0] + rgb[1] * luma[1] + rgb[2] * luma[2];
          for (int c = 0; c < 3; ++c) {
            float v = gray + (rgb[c] - gray) * factor;
            rgb[c] = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
          }
          break;
        }
        case 2: {  // brightness: scale
          for (int c = 0; c < 3; ++c) {
            float v = rgb[c] * factor;
            rgb[c] = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
          }
          break;
        }
        case 3: {  // contrast: blend with global gray mean
          for (int c = 0; c < 3; ++c) {
            float v = gmean + (rgb[c] - gmean) * factor;
            rgb[c] = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
          }
          break;
        }
        default: break;
      }
      float* d = dst + (static_cast<int64_t>(i) * s + j) * 3;
      // True division (not reciprocal-multiply): bitwise parity with
      // numpy's img/255.0 (transforms.py:100).
      for (int c = 0; c < 3; ++c) {
        d[c] = (rgb[c] / 255.0f - mean3[c]) / std3[c];
      }
    }
  }
}

int tpuic_dataprep_abi_version() { return 1; }

}  // extern "C"
