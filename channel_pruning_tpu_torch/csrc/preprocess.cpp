// Native input-pipeline kernels: bicubic shorter-side resize + crop + BGR
// mean subtraction — the hot CPU path of the Caffe fork's ImageData layer
// (reference temp/vgg.prototxt:7-14 `new_dim: 256, bicubic: true`), rebuilt
// as a standalone C library driven from Python via ctypes. OpenMP across the
// batch; Keys cubic (a = -0.5, Catmull-Rom) matching jax.image.resize
// "bicubic" and OpenCV INTER_CUBIC, with half-pixel coordinate mapping.
//
// Build: make -C native   ->  libcp_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline float cubic_keys(float t) {
  // Keys kernel, a = -0.5
  const float a = -0.5f;
  t = std::fabs(t);
  if (t <= 1.0f) return ((a + 2.0f) * t - (a + 3.0f)) * t * t + 1.0f;
  if (t < 2.0f) return (((t - 5.0f) * t + 8.0f) * t - 4.0f) * a;
  return 0.0f;
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Separable bicubic resize of an interleaved HWC uint8 image to HWC float.
void resize_bicubic(const uint8_t* src, int sh, int sw, int ch, float* dst,
                    int dh, int dw) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;

  // horizontal pass: (sh, dw, ch)
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * ch);
  std::vector<int> xi(dw * 4);
  std::vector<float> xw(dw * 4);
  for (int x = 0; x < dw; ++x) {
    float sx = (x + 0.5f) * scale_x - 0.5f;
    int x0 = static_cast<int>(std::floor(sx)) - 1;
    float fsum = 0.0f;
    for (int k = 0; k < 4; ++k) {
      float wgt = cubic_keys(sx - (x0 + k));
      xi[x * 4 + k] = clampi(x0 + k, 0, sw - 1);
      xw[x * 4 + k] = wgt;
      fsum += wgt;
    }
    for (int k = 0; k < 4; ++k) xw[x * 4 + k] /= fsum;
  }
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * ch;
    float* orow = tmp.data() + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      for (int c = 0; c < ch; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < 4; ++k)
          acc += xw[x * 4 + k] * row[xi[x * 4 + k] * ch + c];
        orow[x * ch + c] = acc;
      }
    }
  }

  // vertical pass: (dh, dw, ch)
  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * scale_y - 0.5f;
    int y0 = static_cast<int>(std::floor(sy)) - 1;
    float wsum = 0.0f, wv[4];
    int yiv[4];
    for (int k = 0; k < 4; ++k) {
      wv[k] = cubic_keys(sy - (y0 + k));
      yiv[k] = clampi(y0 + k, 0, sh - 1);
      wsum += wv[k];
    }
    for (int k = 0; k < 4; ++k) wv[k] /= wsum;
    float* orow = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      for (int c = 0; c < ch; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < 4; ++k)
          acc += wv[k] * tmp[static_cast<size_t>(yiv[k]) * dw * ch + x * ch + c];
        orow[x * ch + c] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

// RGB HWC uint8 -> BGR CHW float32: shorter-side bicubic resize to new_dim,
// crop `crop` at (crop_y, crop_x) in resized coords (negative = center),
// subtract mean_bgr[3]. Returns 0 on success.
int cp_preprocess_image(const uint8_t* img, int h, int w, int ch, int new_dim,
                        int crop, int crop_y, int crop_x,
                        const float* mean_bgr, float* out_chw) {
  if (ch != 3 || h <= 0 || w <= 0) return -1;
  int nh, nw;
  if (h <= w) {
    nh = new_dim;
    nw = std::max(static_cast<int>(std::lround(
                      static_cast<double>(w) * new_dim / h)), new_dim);
  } else {
    nw = new_dim;
    nh = std::max(static_cast<int>(std::lround(
                      static_cast<double>(h) * new_dim / w)), new_dim);
  }
  if (crop > nh || crop > nw) return -2;
  std::vector<float> resized(static_cast<size_t>(nh) * nw * ch);
  resize_bicubic(img, h, w, ch, resized.data(), nh, nw);

  int y0 = crop_y >= 0 ? crop_y : (nh - crop) / 2;
  int x0 = crop_x >= 0 ? crop_x : (nw - crop) / 2;
  y0 = clampi(y0, 0, nh - crop);
  x0 = clampi(x0, 0, nw - crop);

  const size_t plane = static_cast<size_t>(crop) * crop;
  for (int y = 0; y < crop; ++y) {
    const float* row = resized.data() +
                       (static_cast<size_t>(y0 + y) * nw + x0) * ch;
    for (int x = 0; x < crop; ++x) {
      // RGB -> BGR channel swap while scattering to CHW planes
      out_chw[0 * plane + y * crop + x] = row[x * ch + 2] - mean_bgr[0];
      out_chw[1 * plane + y * crop + x] = row[x * ch + 1] - mean_bgr[1];
      out_chw[2 * plane + y * crop + x] = row[x * ch + 0] - mean_bgr[2];
    }
  }
  return 0;
}

// Batch variant over uniformly-sized images, OpenMP-parallel.
int cp_preprocess_batch(const uint8_t* imgs, int n, int h, int w, int ch,
                        int new_dim, int crop, const int* crop_yx,
                        const float* mean_bgr, float* out) {
  int rc = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < n; ++i) {
    int cy = crop_yx ? crop_yx[2 * i] : -1;
    int cx = crop_yx ? crop_yx[2 * i + 1] : -1;
    int r = cp_preprocess_image(
        imgs + static_cast<size_t>(i) * h * w * ch, h, w, ch, new_dim, crop,
        cy, cx, mean_bgr, out + static_cast<size_t>(i) * 3 * crop * crop);
    if (r != 0) rc = r;
  }
  return rc;
}

int cp_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
