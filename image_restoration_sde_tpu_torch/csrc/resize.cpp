// Native separable cubic resampler for the host-side data pipeline of the
// PyTorch port (image_restoration_sde_tpu_torch/data/native.py builds and
// loads it; data/imresize.py calls it).
//
// Same math as data/imresize.py's numpy weights (matlab-imresize a=-0.5
// symmetric / torch-bicubic a=-0.75 replicate), in C++ with OpenMP over
// rows, float64 sums; the card never runs it: it resizes on the host as
// the loader reads.  A copy of native/resize.cpp, built with the same
// flags, so both packages' native resamplers give the same bits.
//
// Layout: float32 HWC, C-contiguous.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double cubic(double x, double a) {
  double ax = std::fabs(x);
  if (ax <= 1.0) return ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0;
  if (ax < 2.0) return (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a;
  return 0.0;
}

struct Contrib {
  int P;                      // taps per output pixel
  std::vector<double> w;      // [out_len * P]
  std::vector<int> idx;       // [out_len * P]
};

// boundary: 0 = symmetric (matlab), 1 = replicate (torch)
Contrib contributions(int in_len, int out_len, double scale, double a,
                      bool antialias, int boundary) {
  const double kernel_width = 4.0;
  const bool use_aa = antialias && scale < 1.0;
  const double kw = use_aa ? kernel_width / scale : kernel_width;
  const int P = static_cast<int>(std::ceil(kw)) + 2;

  Contrib c;
  c.P = P;
  c.w.assign(static_cast<size_t>(out_len) * P, 0.0);
  c.idx.assign(static_cast<size_t>(out_len) * P, 0);

  for (int x = 0; x < out_len; ++x) {
    const double u = (x + 0.5) / scale - 0.5;
    const int left = static_cast<int>(std::floor(u - kw / 2.0));
    double sum = 0.0;
    for (int p = 0; p < P; ++p) {
      const int ix = left + p;
      const double d = u - ix;
      const double wv = use_aa ? scale * cubic(d * scale, a) : cubic(d, a);
      c.w[static_cast<size_t>(x) * P + p] = wv;
      sum += wv;
      int j = ix;
      if (boundary == 0) {  // symmetric mirror: aux[mod(ix, 2n)]
        const int n2 = 2 * in_len;
        j = ((ix % n2) + n2) % n2;
        if (j >= in_len) j = n2 - 1 - j;
      } else {  // replicate
        j = std::min(std::max(j, 0), in_len - 1);
      }
      c.idx[static_cast<size_t>(x) * P + p] = j;
    }
    for (int p = 0; p < P; ++p) c.w[static_cast<size_t>(x) * P + p] /= sum;
  }
  return c;
}

}  // namespace

extern "C" {

// Resize HWC float32 -> (OH, OW, C) with explicit scales (matlab semantics:
// the kernel is positioned by the REQUESTED scale, and out = ceil(in*scale)
// may differ from OH/H for fractional scales). Returns 0 on success.
int resize_cubic_f32(const float* src, int H, int W, int C, float* dst,
                     int OH, int OW, double sh, double sw,
                     double a, int antialias, int boundary) {
  const Contrib ch = contributions(H, OH, sh, a, antialias != 0, boundary);
  const Contrib cw = contributions(W, OW, sw, a, antialias != 0, boundary);

  // pass 1: rows (H -> OH), full width
  std::vector<double> tmp(static_cast<size_t>(OH) * W * C);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < OH; ++y) {
    double* trow = &tmp[static_cast<size_t>(y) * W * C];
    std::memset(trow, 0, sizeof(double) * W * C);
    for (int p = 0; p < ch.P; ++p) {
      const double wv = ch.w[static_cast<size_t>(y) * ch.P + p];
      if (wv == 0.0) continue;
      const float* srow = src + static_cast<size_t>(ch.idx[static_cast<size_t>(y) * ch.P + p]) * W * C;
      for (int i = 0; i < W * C; ++i) trow[i] += wv * srow[i];
    }
  }

  // pass 2: cols (W -> OW)
#pragma omp parallel for schedule(static)
  for (int y = 0; y < OH; ++y) {
    const double* trow = &tmp[static_cast<size_t>(y) * W * C];
    float* drow = dst + static_cast<size_t>(y) * OW * C;
    for (int x = 0; x < OW; ++x) {
      for (int ci = 0; ci < C; ++ci) {
        double acc = 0.0;
        for (int p = 0; p < cw.P; ++p) {
          const double wv = cw.w[static_cast<size_t>(x) * cw.P + p];
          if (wv == 0.0) continue;
          acc += wv * trow[static_cast<size_t>(cw.idx[static_cast<size_t>(x) * cw.P + p]) * C + ci];
        }
        drow[static_cast<size_t>(x) * C + ci] = static_cast<float>(acc);
      }
    }
  }
  return 0;
}

}  // extern "C"
