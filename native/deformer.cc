// Host-side data pipeline primitives for theanet_tpu.
//
// The reference ships a host-side multiprocess elastic deformer
// (extras/deformer.py: mp.Process pool + mp.Queue writing deformed batches
// into shared memory). This is its native rebuild: a pthread pool that
// (a) assembles shuffled batches out of a big dataset array and
// (b) elastically deforms batches on the host — for corpora too large to
// keep resident in device memory, where augmentation must ride the CPU while
// the device trains on the previous batch. The in-graph XLA path remains the
// default for resident datasets.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this build).
//
// Build: make -C native   (g++ -O3 -shared -fPIC -pthread)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// xorshift128+ — deterministic, fast, good enough for augmentation noise.
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed ^ 0x9e3779b97f4a7c15ull;
    s1 = (seed << 1) | 1;
    for (int i = 0; i < 8; i++) next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  // uniform in [lo, hi)
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
  // standard normal (Box-Muller)
  double normal() {
    double u1 = uniform() + 1e-12, u2 = uniform();
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
  }
};

// Runs fn over [0, n) in n_threads chunks. Returns 0 on success, 1 if any
// worker threw (bad_alloc under memory pressure, etc.) — exceptions must
// not escape a std::thread (std::terminate would kill the host Python
// process instead of surfacing through the producer-failure path).
int parallel_for(int n, int n_threads, const std::function<void(int, int)>& fn) {
  std::atomic<bool> err{false};
  auto guarded = [&](int lo, int hi) {
    try {
      fn(lo, hi);
    } catch (...) {
      err.store(true);
    }
  };
  if (n_threads <= 1 || n <= 1) {
    guarded(0, n);
    return err.load() ? 1 : 0;
  }
  std::vector<std::thread> threads;
  int chunk = (n + n_threads - 1) / n_threads;
  int spawned_hi = 0;
  for (int t = 0; t < n_threads; t++) {
    int lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    try {
      threads.emplace_back([=] { guarded(lo, hi); });
      spawned_hi = hi;
    } catch (...) {
      break;  // spawn failed: run the rest inline below
    }
  }
  if (spawned_hi < n) guarded(spawned_hi, n);
  for (auto& th : threads) th.join();
  return err.load() ? 1 : 0;
}

// Separable gaussian smoothing of a (h, w) field, 'same' zero padding —
// identical semantics to the in-graph band-matrix smoothing.
void gaussian_smooth(float* field, int h, int w, int sigma, float* tmp) {
  int k = 2 * sigma + 1;
  std::vector<float> kern(k);
  double var = double(sigma) * sigma;
  double norm = 1.0 / std::sqrt(2.0 * M_PI * var);
  for (int i = 0; i < k; i++) {
    double d = i - sigma;
    kern[i] = float(std::exp(-0.5 * d * d / var) * norm);
  }
  // rows
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      float acc = 0.f;
      for (int i = 0; i < k; i++) {
        int xx = x + i - sigma;
        if (xx >= 0 && xx < w) acc += field[y * w + xx] * kern[i];
      }
      tmp[y * w + x] = acc;
    }
  }
  // cols
  for (int y = 0; y < h; y++) {
    for (int x = 0; x < w; x++) {
      float acc = 0.f;
      for (int i = 0; i < k; i++) {
        int yy = y + i - sigma;
        if (yy >= 0 && yy < h) acc += tmp[yy * w + x] * kern[i];
      }
      field[y * w + x] = acc;
    }
  }
}

}  // namespace

extern "C" {

// Build one warp target grid (2, h, w): translation + smoothed elastic field
// + zoom/rotation about a random origin. Mirrors the in-graph pipeline order.
void theanet_make_warp(float* target,  // out, (2, h, w)
                       int h, int w, float translation, float zoom,
                       float magnitude, int sigma, float angle_deg,
                       uint64_t seed) {
  Rng rng(seed);
  std::vector<float> ty(h * w), tx(h * w);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      ty[y * w + x] = float(y);
      tx[y * w + x] = float(x);
    }

  if (translation != 0.f) {
    float dy = translation * float(rng.uniform(-1, 1));
    float dx = translation * float(rng.uniform(-1, 1));
    for (int i = 0; i < h * w; i++) {
      ty[i] += dy;
      tx[i] += dx;
    }
  }

  if (magnitude != 0.f) {
    std::vector<float> ey(h * w), ex(h * w), tmp(h * w);
    for (int i = 0; i < h * w; i++) ey[i] = magnitude * float(rng.normal());
    for (int i = 0; i < h * w; i++) ex[i] = magnitude * float(rng.normal());
    gaussian_smooth(ey.data(), h, w, sigma, tmp.data());
    gaussian_smooth(ex.data(), h, w, sigma, tmp.data());
    for (int i = 0; i < h * w; i++) {
      ty[i] += ey[i];
      tx[i] += ex[i];
    }
  }

  if (zoom != 1.f || angle_deg != 0.f) {
    float oy = float(rng.uniform(0.25, 0.75)) * h;
    float ox = float(rng.uniform(0.25, 0.75)) * w;
    float zy = 1.f, zx = 1.f;
    if (zoom != 1.f) {
      zy = float(std::exp(std::log(zoom) * rng.uniform(-1, 1)));
      zx = float(std::exp(std::log(zoom) * rng.uniform(-1, 1)));
    }
    float th = 0.f;
    if (angle_deg != 0.f)
      th = angle_deg * float(M_PI) / 180.f * float(rng.uniform(-1, 1));
    float c = std::cos(th), s = std::sin(th);
    for (int i = 0; i < h * w; i++) {
      float a = (ty[i] - oy) * zy;
      float b = (tx[i] - ox) * zx;
      // match the in-graph first-axis contraction: out0 = c*a + s*b
      ty[i] = c * a + s * b + oy;
      tx[i] = -s * a + c * b + ox;
    }
  }

  std::memcpy(target, ty.data(), sizeof(float) * h * w);
  std::memcpy(target + h * w, tx.data(), sizeof(float) * h * w);
}

// Deform a batch in place: bilinear/nearest resample at the shared warp plus
// per-pixel flip noise. x is (b, c, h, w) float32. The warp is shared by all
// b*c planes, so the per-pixel clip/floor/weight arithmetic is hoisted out
// of the plane loop: each plane pays only 4 fused multiply-adds (or one
// gather) per pixel. Returns 0 on success, nonzero if a worker failed.
int theanet_deform_batch(float* x, int b, int c, int h, int w,
                         const float* target,  // (2, h, w)
                         int nearest, float pflip, uint64_t seed,
                         int n_threads) {
  const float* ty = target;
  const float* tx = target + h * w;
  int hw = h * w;

  // per-pixel source offsets + bilinear weights, once per warp
  std::vector<int32_t> off(hw);
  std::vector<float> w00, w01, w10, w11;
  if (nearest) {
    for (int i = 0; i < hw; i++) {
      float fy = std::fmin(std::fmax(ty[i], 0.f), h - 1 - 0.001f);
      float fx = std::fmin(std::fmax(tx[i], 0.f), w - 1 - 0.001f);
      off[i] = int(fy + 0.5f) * w + int(fx + 0.5f);
    }
  } else {
    w00.resize(hw); w01.resize(hw); w10.resize(hw); w11.resize(hw);
    for (int i = 0; i < hw; i++) {
      float fy = std::fmin(std::fmax(ty[i], 0.f), h - 1 - 0.001f);
      float fx = std::fmin(std::fmax(tx[i], 0.f), w - 1 - 0.001f);
      int y0 = int(fy), x0 = int(fx);
      float ay = fy - y0, ax = fx - x0;
      off[i] = y0 * w + x0;
      w00[i] = (1 - ay) * (1 - ax);
      w01[i] = (1 - ay) * ax;
      w10[i] = ay * (1 - ax);
      w11[i] = ay * ax;
    }
  }

  return parallel_for(b * c, n_threads, [&](int lo, int hi) {
    std::vector<float> out(hw);
    for (int bc = lo; bc < hi; bc++) {
      float* img = x + size_t(bc) * hw;
      Rng rng(seed * 0x100000001b3ull + bc + 1);
      if (nearest) {
        for (int i = 0; i < hw; i++) out[i] = img[off[i]];
      } else {
        for (int i = 0; i < hw; i++) {
          const float* p = img + off[i];
          out[i] = p[0] * w00[i] + p[1] * w01[i] +
                   p[w] * w10[i] + p[w + 1] * w11[i];
        }
      }
      if (pflip > 0.f) {
        for (int i = 0; i < hw; i++)
          if (rng.uniform() < pflip) out[i] = 1.f - out[i];
      }
      std::memcpy(img, out.data(), sizeof(float) * hw);
    }
  });
}

// Gather rows: dst[i] = src[idx[i]] — shuffled batch assembly, threaded.
void theanet_gather_rows(const float* src, const int64_t* idx, float* dst,
                         int64_t n_rows, int64_t row_elems, int n_threads) {
  parallel_for(int(n_rows), n_threads, [&](int lo, int hi) {
    for (int i = lo; i < hi; i++)
      std::memcpy(dst + size_t(i) * row_elems,
                  src + size_t(idx[i]) * row_elems,
                  sizeof(float) * row_elems);
  });
}

}  // extern "C"
