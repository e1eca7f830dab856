// Native data-loader core: Lanczos-3 resampling + center crop.
//
// The datasets resample every decoded image to the training size. This
// library implements the resample/crop/normalize hot path in C++ (separable
// Lanczos-3 with PIL-equal semantics: support scaled by the downsampling
// ratio, per-axis accumulation in float32, clamp), exposed through a plain C
// ABI consumed via ctypes (ivid_tpu_torch/data/native.py, which builds it
// with g++ at first use). Threaded over rows with std::thread. Depth maps are
// resized by nearest neighbour in numpy (data/base.py), as PIL indexes them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

double lanczos3(double x) {
  if (x <= -3.0 || x >= 3.0) return 0.0;
  if (x == 0.0) return 1.0;
  const double px = kPi * x;
  return 3.0 * std::sin(px) * std::sin(px / 3.0) / (px * px);
}

struct FilterBank {
  // For each output index: start source index, tap count, and `taps` weights.
  std::vector<int> starts;
  std::vector<int> counts;
  std::vector<float> weights;
  int taps = 0;
};

// PIL-style precomputed filter: support is scaled by the ratio when
// downsampling; weights are normalized per output pixel.
FilterBank build_filter(int in_size, int out_size, double scale_offset,
                        double cropped_size) {
  FilterBank fb;
  const double scale = cropped_size / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 3.0 * filterscale;
  fb.taps = static_cast<int>(std::ceil(support) * 2 + 1);
  fb.starts.resize(out_size);
  fb.counts.resize(out_size);
  fb.weights.assign(static_cast<size_t>(out_size) * fb.taps, 0.0f);
  std::vector<double> tmp(fb.taps);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = scale_offset + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    xmin = std::max(xmin, 0);
    int xmax = static_cast<int>(center + support + 0.5);
    xmax = std::min(xmax, in_size);
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      tmp[x - xmin] = lanczos3((x - center + 0.5) / filterscale);
      total += tmp[x - xmin];
    }
    float* w = &fb.weights[static_cast<size_t>(xx) * fb.taps];
    for (int k = 0; k < xmax - xmin; ++k) {
      w[k] = static_cast<float>(total != 0.0 ? tmp[k] / total : 0.0);
    }
    fb.starts[xx] = xmin;
    fb.counts[xx] = xmax - xmin;
  }
  return fb;
}

void parallel_rows(int rows, const std::function<void(int, int)>& fn) {
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  const int nthreads = std::max(1, std::min(hw, rows / 32 + 1));
  if (nthreads <= 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> pool;
  const int chunk = (rows + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int lo = t * chunk;
    const int hi = std::min(rows, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Resize-shorter-side-then-center-crop with Lanczos-3, matching
// torchvision Resize(size, LANCZOS) + CenterCrop(size) on uint8 HWC input.
// dst is float32 [size, size, ch] in [0, 1].
void ivid_lanczos_resize_center_crop(const uint8_t* src, int h, int w, int ch,
                                     int size, float* dst) {
  // Shorter side to `size` (rounded sides), then the centred `size` square.
  const double rscale = static_cast<double>(size) / std::min(h, w);
  const int nw = std::max(size, static_cast<int>(std::lround(w * rscale)));
  const int nh = std::max(size, static_cast<int>(std::lround(h * rscale)));
  const int left = (nw - size) / 2;
  const int top = (nh - size) / 2;

  // Horizontal pass: resample w -> nw but only the cropped [left, left+size).
  const double sx = static_cast<double>(w) / nw;
  FilterBank fx = build_filter(w, size, left * sx, size * sx);
  const double sy = static_cast<double>(h) / nh;
  FilterBank fy = build_filter(h, size, top * sy, size * sy);

  // Intermediate: horizontal-resampled rows (h x size x ch), float.
  std::vector<float> tmp(static_cast<size_t>(h) * size * ch);
  parallel_rows(h, [&](int lo, int hi) {
    for (int y = lo; y < hi; ++y) {
      const uint8_t* srow = src + static_cast<size_t>(y) * w * ch;
      float* trow = tmp.data() + static_cast<size_t>(y) * size * ch;
      for (int xx = 0; xx < size; ++xx) {
        const int x0 = fx.starts[xx];
        const int n = fx.counts[xx];
        const float* wts = &fx.weights[static_cast<size_t>(xx) * fx.taps];
        float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
        if (ch == 3) {
          const uint8_t* sp = srow + static_cast<size_t>(x0) * 3;
          for (int k = 0; k < n; ++k) {
            const float wv = wts[k];
            acc0 += wv * sp[0]; acc1 += wv * sp[1]; acc2 += wv * sp[2];
            sp += 3;
          }
          // PIL stores the horizontal pass in a uint8 image: quantize the
          // intermediate for parity.
          trow[xx * 3 + 0] = std::lround(std::clamp(acc0, 0.f, 255.f));
          trow[xx * 3 + 1] = std::lround(std::clamp(acc1, 0.f, 255.f));
          trow[xx * 3 + 2] = std::lround(std::clamp(acc2, 0.f, 255.f));
        } else {
          for (int c = 0; c < ch; ++c) {
            float acc = 0.f;
            for (int k = 0; k < n; ++k) acc += wts[k] * srow[(x0 + k) * ch + c];
            trow[xx * ch + c] = std::lround(std::clamp(acc, 0.f, 255.f));
          }
        }
      }
    }
  });

  // Vertical pass into the output crop.
  parallel_rows(size, [&](int lo, int hi) {
    for (int yy = lo; yy < hi; ++yy) {
      const int y0 = fy.starts[yy];
      const float* wts = &fy.weights[static_cast<size_t>(yy) * fy.taps];
      float* drow = dst + static_cast<size_t>(yy) * size * ch;
      const int n = fy.counts[yy];
      const int rowstride = size * ch;
      for (int xc = 0; xc < rowstride; ++xc) {
        float acc = 0.f;
        const float* col = tmp.data() + static_cast<size_t>(y0) * rowstride + xc;
        for (int k = 0; k < n; ++k) acc += wts[k] * col[static_cast<size_t>(k) * rowstride];
        // PIL rounds to uint8 after resampling; reproduce the quantization.
        drow[xc] = std::lround(std::clamp(acc, 0.f, 255.f)) / 255.0f;
      }
    }
  });
}

}  // extern "C"
