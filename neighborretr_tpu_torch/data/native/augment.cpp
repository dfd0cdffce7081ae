// Native (C++) RandAugment ops on uint8 RGB frame clips.
//
// Byte-exact re-implementations of the Pillow operations the Python
// augmentation path (data/augment.py) uses, specialized for the host
// data-pipeline hot loop: contiguous uint8 [F, H, W, 3] clips, one call per
// (op, clip), LUT single-pass where the op allows it.  The Python/PIL path
// is the dominant host cost when sizing TPU-VM hosts (measured A/B at
// 12f @ 224: 19.3 vs 51.3 ms/clip/core policy-level — docs/SCALING.md);
// these kernels do the same math in one or two memory passes.
//
// Pillow semantics were probed empirically (Pillow 12.1.0) and are matched
// bit-exactly (asserted in tests/test_native_augment.py):
//   - L conversion:  (r*19595 + g*38470 + b*7471 + 0x8000) >> 16
//   - Image.blend:   float32  out = in1 + alpha*(in2-in1), clip, TRUNCATE
//   - autocontrast:  per-channel lo/hi, lut[i] = clip(trunc(i*scale+offset))
//   - equalize:      classic PIL step/n lut, per channel
//   - SMOOTH filter: float32 kernel (1,1,1,1,5,1,1,1,1)/13, +0.5 floor,
//                    1-pixel border copied from the source
//   - affine:        inverse map at pixel centers (+0.5), sample at -0.5,
//                    clamp-edge bilinear in double, clip+TRUNCATE,
//                    fill 0 where the pre-shift coords leave [0, size)
//
// Reference counterparts: dataloaders/rand_augment.py (timm vendoring) via
// the redesigned data/augment.py.  No ISA-specific compiler flags are
// used (-march is left at baseline: the library may be built on one host
// and run on another with a different CPU).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

using u8 = uint8_t;
using i64 = int64_t;

inline u8 clip8(double v) {
  // branchless clamp then truncate (Pillow's (UINT8) cast after CLIP8)
  v = v < 0.0 ? 0.0 : v;
  v = v > 255.0 ? 255.0 : v;
  return static_cast<u8>(v);
}

inline u8 clip8f(float v) {
  v = v < 0.0f ? 0.0f : v;
  v = v > 255.0f ? 255.0f : v;
  return static_cast<u8>(v);
}

// Pillow convert("L"): ITU-R 601-2 fixed point with rounding.
inline int lum(int r, int g, int b) {
  return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16;
}

inline void apply_lut_inplace(u8* p, i64 n, const u8 lut[256]) {
  for (i64 i = 0; i < n; ++i) p[i] = lut[p[i]];
}

// Per-channel LUT over one frame (H*W RGB pixels).
inline void apply_lut3(u8* p, i64 npix, const u8 lutr[256], const u8 lutg[256],
                       const u8 lutb[256]) {
  for (i64 i = 0; i < npix; ++i) {
    p[3 * i] = lutr[p[3 * i]];
    p[3 * i + 1] = lutg[p[3 * i + 1]];
    p[3 * i + 2] = lutb[p[3 * i + 2]];
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- LUT ops

void nr_invert(u8* p, i64 n) {
  for (i64 i = 0; i < n; ++i) p[i] = static_cast<u8>(255 - p[i]);
}

void nr_posterize(u8* p, i64 n, int bits) {
  bits = bits < 1 ? 1 : (bits > 8 ? 8 : bits);  // shift-count UB guard
  const u8 mask = static_cast<u8>(~((1 << (8 - bits)) - 1));
  for (i64 i = 0; i < n; ++i) p[i] = static_cast<u8>(p[i] & mask);
}

void nr_solarize(u8* p, i64 n, int thresh) {
  u8 lut[256];
  for (int i = 0; i < 256; ++i)
    lut[i] = static_cast<u8>(i < thresh ? i : 255 - i);
  apply_lut_inplace(p, n, lut);
}

void nr_solarize_add(u8* p, i64 n, int add) {
  // matches data/augment.py::_solarize_add (pure-numpy op): pixels < 128
  // get `add` added with [0,255] clipping, others unchanged
  u8 lut[256];
  for (int i = 0; i < 256; ++i)
    lut[i] = static_cast<u8>(i < 128 ? std::min(255, std::max(0, i + add)) : i);
  apply_lut_inplace(p, n, lut);
}

// Brightness enhance: blend(black, im, factor) == lut[i] = clip(trunc(f*i)).
void nr_brightness(u8* p, i64 n, float factor) {
  u8 lut[256];
  for (int i = 0; i < 256; ++i)
    lut[i] = clip8f(factor * static_cast<float>(i));
  apply_lut_inplace(p, n, lut);
}

// --------------------------------------------- per-frame histogram/LUT ops

// ImageOps.autocontrast(im), cutoff=0: per channel of each frame.
void nr_autocontrast(u8* frames, int f, int h, int w) {
  const i64 npix = static_cast<i64>(h) * w;
  for (int fi = 0; fi < f; ++fi) {
    u8* p = frames + fi * npix * 3;
    u8 luts[3][256];
    for (int c = 0; c < 3; ++c) {
      i64 hist[256] = {0};
      for (i64 i = 0; i < npix; ++i) ++hist[p[3 * i + c]];
      int lo = 0, hi = 255;
      while (lo < 256 && hist[lo] == 0) ++lo;
      while (hi >= 0 && hist[hi] == 0) --hi;
      if (hi <= lo) {
        for (int i = 0; i < 256; ++i) luts[c][i] = static_cast<u8>(i);
      } else {
        const double scale = 255.0 / (hi - lo);
        const double offset = -lo * scale;
        for (int i = 0; i < 256; ++i) {
          // Pillow: ix = int(i*scale + offset) then clipped
          int ix = static_cast<int>(i * scale + offset);
          luts[c][i] = static_cast<u8>(std::min(255, std::max(0, ix)));
        }
      }
    }
    apply_lut3(p, npix, luts[0], luts[1], luts[2]);
  }
}

// ImageOps.equalize(im): per channel of each frame.
void nr_equalize(u8* frames, int f, int h, int w) {
  const i64 npix = static_cast<i64>(h) * w;
  for (int fi = 0; fi < f; ++fi) {
    u8* p = frames + fi * npix * 3;
    u8 luts[3][256];
    for (int c = 0; c < 3; ++c) {
      i64 hist[256] = {0};
      for (i64 i = 0; i < npix; ++i) ++hist[p[3 * i + c]];
      // last nonzero bin + count of nonzero bins
      i64 total = 0, last_nz = 0;
      int nz = 0;
      for (int i = 0; i < 256; ++i) {
        total += hist[i];
        if (hist[i]) { last_nz = hist[i]; ++nz; }
      }
      const i64 step = nz <= 1 ? 0 : (total - last_nz) / 255;
      if (step == 0) {
        for (int i = 0; i < 256; ++i) luts[c][i] = static_cast<u8>(i);
      } else {
        i64 acc = step / 2;
        for (int i = 0; i < 256; ++i) {
          i64 v = acc / step;
          luts[c][i] = static_cast<u8>(std::min<i64>(255, std::max<i64>(0, v)));
          acc += hist[i];
        }
      }
    }
    apply_lut3(p, npix, luts[0], luts[1], luts[2]);
  }
}

// ImageEnhance.Contrast: blend(gray(mean), im, factor); mean is the rounded
// per-frame mean of the L channel (ImageStat mean + 0.5, truncated).
void nr_contrast(u8* frames, int f, int h, int w, float factor) {
  const i64 npix = static_cast<i64>(h) * w;
  for (int fi = 0; fi < f; ++fi) {
    u8* p = frames + fi * npix * 3;
    i64 lsum = 0;
    for (i64 i = 0; i < npix; ++i)
      lsum += lum(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
    const int mean =
        static_cast<int>(static_cast<double>(lsum) / npix + 0.5);
    u8 lut[256];
    const float m = static_cast<float>(mean);
    for (int i = 0; i < 256; ++i)
      lut[i] = clip8f(m + factor * (static_cast<float>(i) - m));
    apply_lut_inplace(p, npix * 3, lut);
  }
}

// ImageEnhance.Color: blend(L->RGB, im, factor). Needs per-pixel L, so no
// LUT — one fused pass.
void nr_color(u8* frames, int f, int h, int w, float factor) {
  // out = L + factor*(v - L).  v and L are integers ≤255, so (float)v - (float)L
  // is exactly (float)(v - L): precompute factor*d for d in [-255, 255] and
  // the loop becomes integer L + two table adds — vectorizable, byte-exact.
  float fd[511];
  for (int d = -255; d <= 255; ++d)
    fd[d + 255] = factor * static_cast<float>(d);
  const i64 npix = static_cast<i64>(f) * h * w;
  for (i64 i = 0; i < npix; ++i) {
    u8* px = frames + 3 * i;
    const int L = lum(px[0], px[1], px[2]);
    const float Lf = static_cast<float>(L);
    px[0] = clip8f(Lf + fd[px[0] - L + 255]);
    px[1] = clip8f(Lf + fd[px[1] - L + 255]);
    px[2] = clip8f(Lf + fd[px[2] - L + 255]);
  }
}

// ImageEnhance.Sharpness: blend(SMOOTH(im), im, factor).  SMOOTH is the 3x3
// kernel (1,1,1,1,5,1,1,1,1)/13, float32 accumulate, +0.5 floor, with the
// 1-pixel border copied from the source.  Fused: dst = blend(smooth, src).
void nr_sharpness(const u8* src, u8* dst, int f, int h, int w, float factor) {
  const i64 fstride = static_cast<i64>(h) * w * 3;
  const i64 rstride = static_cast<i64>(w) * 3;
  const float k1 = 1.0f / 13.0f, k5 = 5.0f / 13.0f;
  for (int fi = 0; fi < f; ++fi) {
    const u8* s = src + fi * fstride;
    u8* d = dst + fi * fstride;
    // border rows copied
    std::memcpy(d, s, rstride);
    std::memcpy(d + (h - 1) * rstride, s + (h - 1) * rstride, rstride);
    for (int y = 1; y < h - 1; ++y) {
      const u8* r0 = s + (y - 1) * rstride;
      const u8* r1 = s + y * rstride;
      const u8* r2 = s + (y + 1) * rstride;
      u8* dr = d + y * rstride;
      // border columns copied
      for (int c = 0; c < 3; ++c) {
        dr[c] = r1[c];
        dr[(w - 1) * 3 + c] = r1[(w - 1) * 3 + c];
      }
      // flat loop over the interior byte lanes (channel offsets are just
      // j-3 / j / j+3 on the interleaved row) — one branchless body
      const int jend = (w - 1) * 3;
      for (int j = 3; j < jend; ++j) {
        // Pillow Filter3x3 accumulation order: row by row, left to right
        float ss = k1 * r0[j - 3] + k1 * r0[j] + k1 * r0[j + 3] +
                   k1 * r1[j - 3] + k5 * r1[j] + k1 * r1[j + 3] +
                   k1 * r2[j - 3] + k1 * r2[j] + k1 * r2[j + 3];
        // ss is a positive combination of taps, so floor(ss+0.5) is a plain
        // int truncation (no libm floorf — a per-lane call at baseline ISA)
        float sm = static_cast<float>(static_cast<int>(ss + 0.5f));
        sm = sm > 255.0f ? 255.0f : sm;
        // blend(smooth, original, factor) in float32, truncate
        dr[j] = clip8f(sm + factor * (static_cast<float>(r1[j]) - sm));
      }
    }
  }
}

// ------------------------------------------------------------- geometric

// Image.transform(size, AFFINE, (a,b,c,d,e,ff), BILINEAR) per frame:
// inverse mapping evaluated at output pixel centers, clamp-edge bilinear,
// zero fill where the center maps outside the source rectangle.
void nr_affine_bilinear(const u8* src, u8* dst, int f, int h, int w,
                        double a, double b, double c, double d, double e,
                        double ff) {
  const i64 fstride = static_cast<i64>(h) * w * 3;
  const i64 rstride = static_cast<i64>(w) * 3;
  const i64 npix = static_cast<i64>(h) * w;

  // The SAME mapping applies to every frame of the clip, so precompute the
  // per-output-pixel sample plan once (coordinate math, floor, edge clamps)
  // and amortize it across frames — the per-frame loop is pure gather+lerp.
  struct Plan {
    int32_t o00, o01, o10, o11;  // byte offsets of the 4 taps (-1 row: fill)
    float pad;                   // keep 8-byte alignment for the doubles
    double dx, dy;
  };
  static thread_local Plan* plan = nullptr;
  static thread_local i64 plan_cap = 0;
  if (plan_cap < npix) {
    delete[] plan;
    plan = new Plan[npix];
    plan_cap = npix;
  }

  i64 pi = 0;
  for (int y = 0; y < h; ++y) {
    const double yc = y + 0.5;
    for (int x = 0; x < w; ++x, ++pi) {
      // fresh per-pixel evaluation in Pillow's exact association
      // (a*x + b*y) + c — no incremental accumulation, whose FP drift
      // could flip truncation boundaries
      const double xc = x + 0.5;
      const double xin = a * xc + b * yc + c;
      const double yin = d * xc + e * yc + ff;
      Plan& P = plan[pi];
      if (xin < 0.0 || xin >= w || yin < 0.0 || yin >= h) {
        P.o00 = -1;  // fill
        continue;
      }
      const double xs = xin - 0.5, ys = yin - 0.5;
      // floor without libm: xs/ys are > -1 here (xin/yin passed the
      // [0, size) gate), so truncation differs from floor only on the
      // (-1, 0) interval
      int x0 = static_cast<int>(xs), y0 = static_cast<int>(ys);
      x0 -= (xs < x0);
      y0 -= (ys < y0);
      P.dx = xs - x0;
      P.dy = ys - y0;
      int x1 = x0 + 1, y1 = y0 + 1;
      // clamp-edge sampling (matches Pillow's boundary handling)
      x0 = std::min(w - 1, std::max(0, x0));
      x1 = std::min(w - 1, std::max(0, x1));
      y0 = std::min(h - 1, std::max(0, y0));
      y1 = std::min(h - 1, std::max(0, y1));
      P.o00 = static_cast<int32_t>(y0 * rstride + x0 * 3);
      P.o01 = static_cast<int32_t>(y0 * rstride + x1 * 3);
      P.o10 = static_cast<int32_t>(y1 * rstride + x0 * 3);
      P.o11 = static_cast<int32_t>(y1 * rstride + x1 * 3);
    }
  }

  for (int fi = 0; fi < f; ++fi) {
    const u8* s = src + fi * fstride;
    u8* o = dst + fi * fstride;
    for (i64 i = 0; i < npix; ++i) {
      const Plan& P = plan[i];
      u8* px = o + 3 * i;
      if (P.o00 < 0) {
        px[0] = px[1] = px[2] = 0;
        continue;
      }
      const u8* p00 = s + P.o00;
      const u8* p01 = s + P.o01;
      const u8* p10 = s + P.o10;
      const u8* p11 = s + P.o11;
      const double dx = P.dx, dy = P.dy;
      for (int ch = 0; ch < 3; ++ch) {
        // Pillow's two-stage lerp (BILINEAR_BODY): along x per row, then
        // along y — byte-exact only in this association
        const double v1 = p00[ch] + (p01[ch] - p00[ch]) * dx;
        const double v2 = p10[ch] + (p11[ch] - p10[ch]) * dx;
        px[ch] = clip8(v1 + (v2 - v1) * dy);
      }
    }
  }
}

int nr_abi_version(void) { return 1; }

}  // extern "C"
