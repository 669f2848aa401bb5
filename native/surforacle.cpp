// surforacle: standalone CPU oracle of the reference SURF pipeline.
//
// Independent scalar re-derivation of the math specified by the
// reference (its surfd.cu, surf.cpp — see SURVEY.md §3.5):
// integral image (integralRow/Col, surfd.cu:129-165), box-filter
// Hessian pyramid (calcHessianMultiConst, surfd.cu:445-481; parameter
// derivations cuCalcHessianMulti surfd.cu:2844-2865), fused NMS +
// iterative subpixel interpolation (findMaximumWithInterp,
// surfd.cu:676-832; fitQuadrat surfd.cu:942-988; solveLinearSystem
// surfd.cu:835-887 — the reference's own CPU mirrors hFitQuadrat /
// hSolveLinearSystem, surfd.cu:3082-3186, define this math's host
// semantics), makePoint (surfd.cu:1001-1022), orientation
// (assignOrientationApprox, surfd.cu:1711-1960), descriptors
// (describeUR/Approx WithoutNormalization + placeInIndex,
// surfd.cu:1566-1615, 2391-2444, 1199-1317) and L2 normalize
// (surfd.cu:2447-2493).
//
// This binary exists to generate REFERENCE-TRUE golden data for the
// test suite: it shares no code with the JAX/Pallas framework (plain
// scalar loops, like the reference's host mirrors), so agreement
// between the two is a genuine cross-check of both.
//
// Usage: surforacle image.pgm [--rotated] [--extended] [--doubled]
//                            [--octaves N] [--thresh T] [--max-pts N]
// Output (stdout):
//   <num_points> <nfeatures>
//   x y scale strength laplace octave ori      (one line per point)
//   d0 d1 ... d{nfeatures-1}                   (one line per point)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

namespace {

constexpr int NBIN = 72;
constexpr double WINDOW = 1.0471975511965976;     // pi/3
constexpr double SEP_ANGLE = 0.08726646259971647; // 2*pi/NBIN
constexpr int HWN = 6;
constexpr int ORADIUS = 9;
constexpr double ORADIUS_SQ = 81.5;
const float R255 = 0.003921568627f;
const double PI = 3.14159265358979323846;

// __float2int_rn: round to nearest, ties to even.
int rn(float x) { return static_cast<int>(std::nearbyintf(x)); }
// __float2int_rz: truncate toward zero.
int rz(float x) { return static_cast<int>(std::truncf(x)); }

// ------------------------------------------------------------- image IO

struct Gray {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
};

bool read_pgm(const std::string& path, Gray* img) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::string magic;
  f >> magic;
  if (magic != "P5") return false;
  auto skip = [&f]() {
    while (f.peek() == '#' || isspace(f.peek())) {
      if (f.peek() == '#') {
        std::string line;
        std::getline(f, line);
      } else
        f.get();
    }
  };
  int w, h, maxval;
  skip(); f >> w;
  skip(); f >> h;
  skip(); f >> maxval;
  f.get();  // single whitespace after header
  if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 255) return false;
  img->w = w;
  img->h = h;
  img->px.resize(static_cast<size_t>(w) * h);
  f.read(reinterpret_cast<char*>(img->px.data()), img->px.size());
  return static_cast<bool>(f);
}

// --------------------------------------------------------------- config

struct Config {
  int noctaves = 4;
  float thresh = 4.0f;
  bool doubled = false;
  int init_mask_size = 9;
  int sampling_step = 2;
  bool upright = true;
  bool extended = false;
  int desc_wsz = 4;
  int max_pts = 10000;
  int interp_moves = 5;

  double divisor() const { return doubled ? 0.5 : 1.0; }
  int init_lobe() const { return init_mask_size / 3; }
  int max_scale() const { return init_lobe() + 2; }
  int sampling() const { return sampling_step * (doubled ? 2 : 1); }
  int mag_factor() const { return 12 / desc_wsz; }
  int orient_size() const { return extended ? 8 : 4; }
  int nfeatures() const { return desc_wsz * desc_wsz * orient_size(); }
};

// Per-scale box-filter geometry (hessian_params, surfd.cu:2846-2859).
struct ScaleParams {
  int scale_index, mask_size, border1, delta, x2, x3, x4;
  double norm;
};

struct OctaveSched {
  int octave, init_scale;
  std::vector<ScaleParams> scales;
  std::vector<int> borders;  // per-scale NMS/interp borders
};

// Mirrors the interleaved parameter updates of Surfor::detectAndCompute
// (surf.cpp:240-294) + cuCalcHessianMulti (surfd.cu:2844-2865).
std::vector<OctaveSched> hessian_schedule(const Config& cfg) {
  std::vector<OctaveSched> out;
  int mask_size = cfg.init_lobe() - 2;
  int octave = 1;
  for (int o = 0; o < cfg.noctaves; ++o) {
    OctaveSched os;
    os.octave = octave;
    int border1;
    if (o > 0) {
      border1 =
          ((3 * (mask_size + 4 * octave)) / 2) / (cfg.sampling() * octave) + 1;
      os.borders.assign(cfg.max_scale(), 0);
      os.borders[0] = os.borders[1] = border1;
      os.init_scale = 2;
    } else {
      border1 =
          ((3 * (mask_size + 6 * octave)) / 2) / (cfg.sampling() * octave) + 1;
      os.borders.assign(cfg.max_scale(), 0);
      os.init_scale = 0;
    }
    int i = 0;
    for (int s = os.init_scale; s < cfg.max_scale(); ++s, ++i) {
      os.borders[s] = border1;  // pre-update value, used by NMS/walk
      int delta = cfg.sampling() * octave;
      int msz = mask_size + 2 * octave * (i + 1);
      if (s > 2) border1 = 3 * msz / 2 / delta + 1;
      ScaleParams sp;
      sp.scale_index = s;
      sp.mask_size = msz;
      sp.border1 = border1;  // post-update value bounds the box reads
      sp.delta = delta;
      sp.norm = std::pow(9.0 / (double(msz) * msz), 2.0);
      sp.x2 = msz / 2;
      sp.x3 = 2 * (msz / 2);
      sp.x4 = 3 * (msz / 2);
      os.scales.push_back(sp);
    }
    mask_size = os.scales.back().mask_size;
    out.push_back(os);
    octave += octave;
  }
  return out;
}

// --------------------------------------------------------- integral image

// Zero-padded int32 integral image; `doubled` applies the reference's
// rounded bilinear 2x upsample first (integralDoubleRow0U2,
// surfd.cu:168-206).
struct Integral {
  int h = 0, w = 0;  // padded dims
  std::vector<int32_t> v;
  int64_t at(int y, int x) const { return v[size_t(y) * w + x]; }
};

Integral integral_image(const Gray& img, bool doubled) {
  std::vector<int64_t> src;
  int sh, sw;
  if (!doubled) {
    sh = img.h;
    sw = img.w;
    src.resize(size_t(sh) * sw);
    for (int y = 0; y < sh; ++y)
      for (int x = 0; x < sw; ++x) src[size_t(y) * sw + x] = img.px[size_t(y) * img.w + x];
  } else {
    sh = 2 * img.h - 1;
    sw = 2 * img.w - 1;
    src.assign(size_t(sh) * sw, 0);
    auto p = [&img](int y, int x) -> int64_t {
      return img.px[size_t(y) * img.w + x];
    };
    for (int y = 0; y < img.h; ++y)
      for (int x = 0; x < img.w; ++x) src[size_t(2 * y) * sw + 2 * x] = p(y, x);
    for (int y = 0; y < img.h; ++y)
      for (int x = 0; x + 1 < img.w; ++x)
        src[size_t(2 * y) * sw + 2 * x + 1] =
            rn(float(p(y, x) + p(y, x + 1)) * 0.5f);
    for (int y = 0; y + 1 < img.h; ++y)
      for (int x = 0; x < img.w; ++x)
        src[size_t(2 * y + 1) * sw + 2 * x] =
            rn(float(p(y, x) + p(y + 1, x)) * 0.5f);
    for (int y = 0; y + 1 < img.h; ++y)
      for (int x = 0; x + 1 < img.w; ++x)
        src[size_t(2 * y + 1) * sw + 2 * x + 1] = rn(
            float(p(y, x) + p(y, x + 1) + p(y + 1, x) + p(y + 1, x + 1)) *
            0.25f);
  }
  Integral ii;
  ii.h = sh + 1;
  ii.w = sw + 1;
  ii.v.assign(size_t(ii.h) * ii.w, 0);
  std::vector<int64_t> rowsum(sw + 1, 0);
  std::vector<int64_t> acc(sw, 0);
  for (int y = 0; y < sh; ++y) {
    int64_t run = 0;
    for (int x = 0; x < sw; ++x) {
      run += src[size_t(y) * sw + x];
      acc[x] += run;
      ii.v[size_t(y + 1) * ii.w + (x + 1)] = static_cast<int32_t>(acc[x]);
    }
  }
  return ii;
}

// Inclusive box sum over cols [x2..x1], rows [y2..y1] (getSum,
// surfd.cu:334-343).
int64_t box_sum(const Integral& ii, int x1, int y1, int x2, int y2) {
  return ii.at(y1 + 1, x1 + 1) + ii.at(y2, x2) - ii.at(y2, x1 + 1) -
         ii.at(y1 + 1, x2);
}

// ------------------------------------------------------- response pyramid

using Resp = std::vector<float>;  // (max_scale, oh, ow) flattened

float hessian_response(const Integral& ii, int cx, int cy,
                       const ScaleParams& sp) {
  // getHessian (surfd.cu:353-366)
  int m = sp.mask_size, x2 = sp.x2, x3 = sp.x3, x4 = sp.x4;
  float dxx =
      float(box_sum(ii, cx + m + x2, cy + x3, cx - m - x2, cy - x3) -
            3 * box_sum(ii, cx + x2, cy + x3, cx - x2, cy - x3));
  float dyy =
      float(box_sum(ii, cx + x3, cy + m + x2, cx - x3, cy - m - x2) -
            3 * box_sum(ii, cx + x3, cy + x2, cx - x3, cy - x2));
  float dxy = 0.6f * float(box_sum(ii, cx + x4, cy, cx, cy - x4) +
                           box_sum(ii, cx, cy + x4, cx - x4, cy) -
                           box_sum(ii, cx + x4, cy + x4, cx, cy) -
                           box_sum(ii, cx, cy, cx - x4, cy - x4));
  return R255 * R255 * (dxx * dyy - dxy * dxy);
}

std::vector<Resp> response_pyramid(const Integral& ii, const Config& cfg,
                                   const std::vector<OctaveSched>& sched,
                                   std::vector<std::pair<int, int>>* shapes) {
  int ih = ii.h, iw = ii.w;
  shapes->clear();
  shapes->push_back({(ih - 1) / cfg.sampling(), (iw - 1) / cfg.sampling()});
  for (int o = 1; o < cfg.noctaves; ++o)
    shapes->push_back(
        {(*shapes)[o - 1].first >> 1, (*shapes)[o - 1].second >> 1});
  int ms = cfg.max_scale();
  std::vector<Resp> pyr;
  for (int o = 0; o < cfg.noctaves; ++o) {
    auto [oh, ow] = (*shapes)[o];
    Resp resp(size_t(ms) * oh * ow, 0.0f);
    auto at = [&resp, oh, ow](int s, int r, int c) -> float& {
      return resp[(size_t(s) * oh + r) * ow + c];
    };
    if (o > 0) {
      // cross-octave decimation reuse (halfImage, surf.cpp:253-258)
      auto [ph, pw] = (*shapes)[o - 1];
      auto& prev = pyr[o - 1];
      for (int r = 0; r < oh; ++r)
        for (int c = 0; c < ow; ++c) {
          at(0, r, c) = prev[(size_t(ms - 3) * ph + 2 * r) * pw + 2 * c];
          at(1, r, c) = prev[(size_t(ms - 1) * ph + 2 * r) * pw + 2 * c];
        }
    }
    for (const auto& sp : sched[o].scales) {
      int b1 = sp.border1, d = sp.delta;
      for (int r = b1; r < oh - b1; ++r)
        for (int c = b1; c < ow - b1; ++c)
          at(sp.scale_index, r, c) =
              hessian_response(ii, d * c, d * r, sp) * float(sp.norm);
    }
    pyr.push_back(std::move(resp));
  }
  return pyr;
}

// ----------------------------------------------------------------- detect

struct Point {
  double x, y, scale, strength, ori = 0.0;
  int laplace, octave;
};

// 3D quadratic fit (fitQuadrat, surfd.cu:942-988; host mirror
// hFitQuadrat surfd.cu:3137-3186), solved in double with partial
// pivoting (hSolveLinearSystem semantics, surfd.cu:3082-3134).
bool fit_quadrat(const Resp& resp, int oh, int ow, int s, int r, int c,
                 double off[3], double* strength) {
  auto at = [&resp, oh, ow](int ss, int rr, int cc) -> double {
    return resp[(size_t(ss) * oh + rr) * ow + cc];
  };
  double g[3] = {(at(s + 1, r, c) - at(s - 1, r, c)) * 0.5,
                 (at(s, r + 1, c) - at(s, r - 1, c)) * 0.5,
                 (at(s, r, c + 1) - at(s, r, c - 1)) * 0.5};
  double t = 2.0 * at(s, r, c);
  double H[3][4];
  H[0][0] = at(s - 1, r, c) + at(s + 1, r, c) - t;
  H[1][1] = at(s, r + 1, c) + at(s, r - 1, c) - t;
  H[2][2] = at(s, r, c + 1) + at(s, r, c - 1) - t;
  H[0][1] = H[1][0] = ((at(s + 1, r + 1, c) - at(s + 1, r - 1, c)) -
                       (at(s - 1, r + 1, c) - at(s - 1, r - 1, c))) *
                      0.25;
  H[0][2] = H[2][0] = ((at(s + 1, r, c + 1) - at(s + 1, r, c - 1)) -
                       (at(s - 1, r, c + 1) - at(s - 1, r, c - 1))) *
                      0.25;
  H[1][2] = H[2][1] = ((at(s, r + 1, c + 1) - at(s, r + 1, c - 1)) -
                       (at(s, r - 1, c + 1) - at(s, r - 1, c - 1))) *
                      0.25;
  H[0][3] = -g[0];
  H[1][3] = -g[1];
  H[2][3] = -g[2];
  // Gaussian elimination with partial pivoting
  for (int col = 0; col < 3; ++col) {
    int piv = col;
    for (int row = col + 1; row < 3; ++row)
      if (std::fabs(H[row][col]) > std::fabs(H[piv][col])) piv = row;
    if (piv != col)
      for (int k = col; k < 4; ++k) std::swap(H[col][k], H[piv][k]);
    if (H[col][col] == 0.0) return false;
    for (int row = col + 1; row < 3; ++row) {
      double f = H[row][col] / H[col][col];
      for (int k = col; k < 4; ++k) H[row][k] -= f * H[col][k];
    }
  }
  off[2] = H[2][3] / H[2][2];
  off[1] = (H[1][3] - H[1][2] * off[2]) / H[1][1];
  off[0] = (H[0][3] - H[0][1] * off[1] - H[0][2] * off[2]) / H[0][0];
  *strength =
      at(s, r, c) + 0.5 * (off[0] * g[0] + off[1] * g[1] + off[2] * g[2]);
  return true;
}

int laplace_sign(const Integral& ii, int cx, int cy, int m, int x2, int x3) {
  // getTrace (surfd.cu:369-377)
  int64_t lxx = box_sum(ii, cx + m + x2, cy + x3, cx - m - x2, cy - x3) -
                3 * box_sum(ii, cx + x2, cy + x3, cx - x2, cy - x3);
  int64_t lyy = box_sum(ii, cx + x3, cy + m + x2, cx - x3, cy - m - x2) -
                3 * box_sum(ii, cx + x3, cy + x2, cx - x3, cy - x2);
  return (lxx + lyy > 0) ? 1 : -1;
}

Point make_point(const Integral& ii, const Config& cfg, double nx, double ny,
                 double ns, double strength, int o) {
  // makePoint (surfd.cu:1001-1022)
  double td = cfg.sampling() * cfg.divisor();
  int temp = rz(3.0f * float(ns) + 0.5f);
  int cx = rz(float(nx) * float(cfg.sampling()) + 0.5f);
  int cy = rz(float(ny) * float(cfg.sampling()) + 0.5f);
  int x2 = temp / 2;
  Point p;
  p.x = nx * td;
  p.y = ny * td;
  p.scale = 1.2 * ns * cfg.divisor();
  p.strength = strength;
  p.laplace = laplace_sign(ii, cx, cy, temp, x2, 2 * x2);
  p.octave = o;
  return p;
}

// NMS + iterative subpixel interpolation (findMaximumWithInterp,
// surfd.cu:676-832): 2x2x2 cells at odd scales, cell argmax in (c,r,s)
// minor order, full 3x3x3 verification, then a walk of up to
// interp_moves fit-and-step rounds.
std::vector<Point> detect(const Integral& ii, const std::vector<Resp>& pyr,
                          const Config& cfg,
                          const std::vector<OctaveSched>& sched,
                          const std::vector<std::pair<int, int>>& shapes) {
  std::vector<Point> pts;
  int ms = cfg.max_scale();
  for (int o = 0; o < cfg.noctaves; ++o) {
    const Resp& resp = pyr[o];
    auto [oh, ow] = shapes[o];
    auto at = [&resp, oh, ow](int s, int r, int c) -> float {
      return resp[(size_t(s) * oh + r) * ow + c];
    };
    const auto& os = sched[o];
    int octave = os.octave;
    for (int z = 0; 2 * z + 2 < ms; ++z) {
      int k = 2 * z + 1;
      int mb = os.borders[k + 1] + 1;  // maximum_borders (surfd.cu:3062-3071)
      for (int i = mb; i < oh - mb; i += 2)
        for (int j = mb; j < ow - mb; j += 2) {
          float best = -1e30f;
          int bs = 0, br = 0, bc = 0;
          for (int ds = 0; ds < 2; ++ds)
            for (int di = 0; di < 2; ++di)
              for (int dj = 0; dj < 2; ++dj) {
                float v = at(k + ds, i + di, j + dj);
                if (v > best) {
                  best = v;
                  bs = k + ds;
                  br = i + di;
                  bc = j + dj;
                }
              }
          if (best < 0.8f * cfg.thresh) continue;
          if (k + 1 == ms - 1 && bs == k + 1) continue;  // cas<=3 cap
          bool is_max = true;
          for (int ds = -1; ds <= 1 && is_max; ++ds)
            for (int di = -1; di <= 1 && is_max; ++di)
              for (int dj = -1; dj <= 1; ++dj)
                if (best < at(bs + ds, br + di, bc + dj)) {
                  is_max = false;
                  break;
                }
          if (!is_max) continue;
          // iterative refinement walk
          int r = br, c = bc, s = bs;
          int newr = r, newc = c;
          double off[3] = {0, 0, 0};
          double strength = 0.0;
          bool ok = true;
          for (int mv = 0; mv < cfg.interp_moves; ++mv) {
            r = newr;
            c = newc;
            ok = fit_quadrat(resp, oh, ow, s, r, c, off, &strength);
            if (!ok) break;
            if (off[1] > 0.6 && r < oh - os.borders[s]) newr += 1;
            if (off[1] < -0.6 && r > os.borders[s]) newr -= 1;
            if (off[2] > 0.6 && c < ow - os.borders[s]) newc += 1;
            if (off[2] < -0.6 && c > os.borders[s]) newc -= 1;
            if (newr == r && newc == c) break;
          }
          if (!ok || std::isnan(off[0]) || std::isnan(off[1]) ||
              std::isnan(off[2]))
            continue;
          if (std::fabs(off[0]) > 1.5 || std::fabs(off[1]) > 1.5 ||
              std::fabs(off[2]) > 1.5 || strength < cfg.thresh)
            continue;
          double ns =
              (cfg.init_lobe() + (octave - 1) * ms + (s + off[0]) * 2 * octave) /
              3.0;
          double ny = octave * (r + off[1]);
          double nx = octave * (c + off[2]);
          pts.push_back(make_point(ii, cfg, nx, ny, ns, strength, o));
          if ((int)pts.size() >= cfg.max_pts) return pts;
        }
    }
  }
  return pts;
}

// ------------------------------------------------------------ orientation

int64_t wavelet_dy(const Integral& ii, int x, int y, int size) {
  // getWavelet1 (surfd.cu:1171-1175)
  return box_sum(ii, x + size, y, x - size, y - size) -
         box_sum(ii, x + size, y + size, x - size, y);
}

int64_t wavelet_dx(const Integral& ii, int x, int y, int size) {
  // getWavelet2 (surfd.cu:1178-1182)
  return box_sum(ii, x + size, y + size, x, y - size) -
         box_sum(ii, x, y + size, x - size, y - size);
}

float fast_atan2(float y, float x) {
  // dFastAtan2 polynomial approximation (surfd.cu:114-126)
  float absx = std::fabs(x), absy = std::fabs(y);
  float mn = std::fmin(absx, absy), mx = std::fmax(absx, absy);
  float a = mn / mx;
  float s = a * a;
  float r = ((-0.0464964749f * s + 0.15931422f) * s - 0.327622764f) * s * a + a;
  if (absy > absx) r = float(PI / 2) - r;
  if (x < 0) r = float(PI) - r;
  if (y < 0) r = -r;
  return r;
}

struct Luts {
  std::vector<float> lut1, lut2;
  std::vector<float> bins;
  Luts() {
    for (int n = 0; n < 83; ++n) lut1.push_back(std::exp(-(n + 0.5) / 12.5));
    for (int n = 0; n < 40; ++n) lut2.push_back(std::exp(-(n + 0.5) / 8.0));
    bins.push_back(float(-PI));
    for (int n = 1; n < NBIN; ++n)
      bins.push_back(bins.back() + float(SEP_ANGLE));
  }
};

// Windowed 72-bin orientation (assignOrientationApprox,
// surfd.cu:1711-1960): per-bin mass/angle accumulation with +-2pi wrap
// copies, pi/3 sliding window with fractional edge bins, argmax window,
// mass-weighted mean angle.
double assign_orientation(const Integral& ii, const Config& cfg,
                          const Luts& luts, const Point& p) {
  int ih = ii.h, iw = ii.w;
  double x = p.x, y = p.y, scale = p.scale;
  if (cfg.doubled) {
    x *= 2;
    y *= 2;
    scale *= 2;
  }
  int pixsi = rz(2.0f * float(scale) + 1.6f);
  int step = rz(float(scale) + 0.8f);
  int cx = rn(float(x)), cy = rn(float(y));

  std::vector<int64_t> hist(NBIN, 0);
  std::vector<double> angsum(NBIN, 0.0), part_sums(NBIN, 0.0);
  std::vector<double> pas(NBIN + 2 * HWN, 0.0);

  for (int yi = -ORADIUS; yi <= ORADIUS; ++yi)
    for (int xi = -ORADIUS; xi <= ORADIUS; ++xi) {
      int xx = cx + xi * step, yy = cy + yi * step;
      if (!(yy + pixsi + 2 < ih && yy - pixsi > -1 && xx + pixsi + 2 < iw &&
            xx - pixsi > -1))
        continue;
      int distsq = yi * yi + xi * xi;
      if (!(distsq < ORADIUS_SQ)) continue;
      float dx = float(wavelet_dx(ii, xx, yy, pixsi)) * R255;
      float dy = float(wavelet_dy(ii, xx, yy, pixsi)) * R255;
      float mag = std::sqrt(dx * dx + dy * dy);
      if (!(mag > 0)) continue;
      float angle = fast_atan2(dy, dx);
      int hid = rz((angle + float(PI)) / float(SEP_ANGLE)) % NBIN;
      int wi = distsq < 83 ? distsq : 82;
      float psum = luts.lut1[wi] * mag;
      hist[hid] += 1;
      angsum[hid] += angle;
      part_sums[hid] += psum;
      pas[hid + HWN] += double(angle) * psum;
      if (hid < HWN)
        pas[hid + HWN + NBIN] += double(angle + 2 * float(PI)) * psum;
      if (hid + HWN >= NBIN)
        pas[hid + HWN - NBIN] += double(angle - 2 * float(PI)) * psum;
    }

  std::vector<double> avg(NBIN);
  for (int i = 0; i < NBIN; ++i)
    avg[i] = hist[i] > 0 ? angsum[i] / hist[i] : luts.bins[i];

  double best_sum = -1e300, best_asum = 0.0;
  for (int i = 0; i < NBIN; ++i) {
    double wsum = 0.0, wasum = 0.0;
    for (int j = -HWN; j <= HWN; ++j) {
      int k = i + j;
      if (j == -HWN) {
        double residual;
        if (k < 0) {
          k += NBIN;
          int k1 = (k + 1) % NBIN;
          residual = luts.bins[k1] + WINDOW / 2 - avg[i] -
                     (luts.bins[k1] < 0 ? 0.0 : 2 * PI);
        } else {
          residual = luts.bins[k + 1] + WINDOW / 2 - avg[i];
        }
        double ratio = residual / SEP_ANGLE;
        wsum += ratio * part_sums[k];
        wasum += ratio * pas[i];
      } else if (j == HWN) {
        double residual;
        if (k >= NBIN) {
          k -= NBIN;
          residual = avg[i] + WINDOW / 2 - 2 * PI - luts.bins[k];
        } else {
          residual = avg[i] + WINDOW / 2 - luts.bins[k];
        }
        double ratio = residual / SEP_ANGLE;
        wsum += ratio * part_sums[k];
        wasum += ratio * pas[i + 2 * HWN];
      } else {
        wasum += pas[k + HWN];
        wsum += part_sums[(k % NBIN + NBIN) % NBIN];
      }
    }
    if (wsum > best_sum) {
      best_sum = wsum;
      best_asum = wasum;
    }
  }
  return best_asum / best_sum;
}

// ------------------------------------------------------------- descriptor

// One keypoint's descriptor (describeURWithoutNormalization /
// describeApproxWithoutNormalization + addSample + placeInIndex,
// surfd.cu:1566-1615, 2391-2444, 1984-2015, 1199-1271), normalized
// (surfd.cu:2447-2493).
std::vector<float> describe(const Integral& ii, const Config& cfg,
                            const Luts& luts, const Point& p) {
  int ih = ii.h, iw = ii.w;
  float x, y, scale;
  if (cfg.doubled) {
    x = float(2 * p.x);
    y = float(2 * p.y);
    scale = 3.3f * float(p.scale);
  } else {
    x = float(p.x);
    y = float(p.y);
    scale = 1.65f * float(p.scale);
  }
  int step = std::max(rn(scale * 0.5f), 1);
  int ix = rn(x), iy = rn(y);
  float fracx = x - ix, fracy = y - iy;
  float spacing = scale * float(cfg.mag_factor());
  int iscale = rz(scale);
  float wofs = float(cfg.desc_wsz) * 0.5f - 0.5f;
  int wsz = cfg.desc_wsz;

  int iradius;
  float sine = 0.0f, cose = 1.0f, fracr, fracc;
  if (cfg.upright) {
    iradius = rn(spacing * float((wsz + 1) * 0.5) / float(step));
    fracr = fracy;
    fracc = fracx;
  } else {
    iradius = rn(1.4f * spacing * float((wsz + 1) * 0.5) / float(step));
    sine = std::sin(float(p.ori));
    cose = std::cos(float(p.ori));
    fracr = cose * fracy + sine * fracx;
    fracc = -sine * fracy + cose * fracx;
  }

  std::vector<double> desc(cfg.nfeatures(), 0.0);
  int osz = cfg.orient_size();
  auto place = [&](float mag1, int ori1, float mag2, int ori2, float rxv,
                   float cxv) {
    // bilinear scatter into the (wsz, wsz, orient) grid
    int ri = int(std::floor(rxv)), ci = int(std::floor(cxv));
    float rfrac = rxv - ri, cfrac = cxv - ci;
    for (int dr = 0; dr < 2; ++dr) {
      int rind = ri + dr;
      if (rind < 0 || rind >= wsz) continue;
      float rw1 = mag1 * (dr ? rfrac : 1 - rfrac);
      float rw2 = mag2 * (dr ? rfrac : 1 - rfrac);
      for (int dc = 0; dc < 2; ++dc) {
        int cind = ci + dc;
        if (cind < 0 || cind >= wsz) continue;
        float cw = dc ? cfrac : 1 - cfrac;
        size_t base = (size_t(rind) * wsz + cind) * osz;
        desc[base + ori1] += double(rw1 * cw);
        desc[base + ori2] += double(rw2 * cw);
      }
    }
  };

  for (int i = -iradius; i <= iradius; ++i)
    for (int j = -iradius; j <= iradius; ++j) {
      float stepf = float(step);
      float rpos, cpos;
      if (cfg.upright) {
        rpos = (stepf * i - fracy) / spacing;
        cpos = (stepf * j - fracx) / spacing;
      } else {
        rpos = (stepf * (cose * i + sine * j) - fracr) / spacing;
        cpos = (stepf * (-sine * i + cose * j) - fracc) / spacing;
      }
      float rx = rpos + wofs, cxp = cpos + wofs;
      if (!(rx > -1 && rx < wsz && cxp > -1 && cxp < wsz)) continue;
      int r = iy + i * step, c = ix + j * step;
      if (!(r >= 1 + iscale && r < ih - 1 - iscale && c >= 1 + iscale &&
            c < iw - 1 - iscale))
        continue;
      int widx = rz(rpos * rpos + cpos * cpos);
      float weight = luts.lut2[widx < 40 ? (widx < 0 ? 0 : widx) : 39];
      float dxx = weight * float(wavelet_dx(ii, c, r, iscale)) * R255;
      float dyy = weight * float(wavelet_dy(ii, c, r, iscale)) * R255;
      float dx, dy;
      if (cfg.upright) {
        dx = dxx;
        dy = dyy;
      } else {
        dx = cose * dxx + sine * dyy;
        dy = sine * dxx - cose * dyy;
      }
      if (!cfg.extended) {
        place(dx, dx < 0 ? 0 : 1, dy, dy < 0 ? 2 : 3, rx, cxp);
      } else {
        // SURF-128: split by the co-component's sign
        place(dx, dyy < 0 ? 0 : 1, std::fabs(dx), dyy < 0 ? 2 : 3, rx, cxp);
        place(dy, dxx < 0 ? 4 : 5, std::fabs(dy), dxx < 0 ? 6 : 7, rx, cxp);
      }
    }

  double nrm = 0.0;
  for (double v : desc) nrm += v * v;
  nrm = std::sqrt(nrm);
  std::vector<float> out(desc.size());
  for (size_t k = 0; k < desc.size(); ++k)
    out[k] = nrm > 0 ? float(desc[k] / nrm) : 0.0f;
  return out;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr,
                 "usage: %s image.pgm [--rotated] [--extended] [--doubled] "
                 "[--octaves N] [--thresh T] [--max-pts N]\n",
                 argv[0]);
    return 2;
  }
  Config cfg;
  std::string path = argv[1];
  for (int a = 2; a < argc; ++a) {
    std::string s = argv[a];
    if (s == "--rotated")
      cfg.upright = false;
    else if (s == "--extended")
      cfg.extended = true;
    else if (s == "--doubled")
      cfg.doubled = true;
    else if (s == "--octaves" && a + 1 < argc)
      cfg.noctaves = std::atoi(argv[++a]);
    else if (s == "--thresh" && a + 1 < argc)
      cfg.thresh = std::atof(argv[++a]);
    else if (s == "--max-pts" && a + 1 < argc)
      cfg.max_pts = std::atoi(argv[++a]);
    else {
      std::fprintf(stderr, "unknown arg %s\n", s.c_str());
      return 2;
    }
  }
  Gray img;
  if (!read_pgm(path, &img)) {
    std::fprintf(stderr, "cannot read %s\n", path.c_str());
    return 1;
  }
  Luts luts;
  auto sched = hessian_schedule(cfg);
  Integral ii = integral_image(img, cfg.doubled);
  std::vector<std::pair<int, int>> shapes;
  auto pyr = response_pyramid(ii, cfg, sched, &shapes);
  auto pts = detect(ii, pyr, cfg, sched, shapes);
  if (!cfg.upright)
    for (auto& p : pts) p.ori = assign_orientation(ii, cfg, luts, p);

  std::printf("%zu %d\n", pts.size(), cfg.nfeatures());
  for (const auto& p : pts)
    std::printf("%.8f %.8f %.8f %.8f %d %d %.8f\n", p.x, p.y, p.scale,
                p.strength, p.laplace, p.octave, p.ori);
  for (const auto& p : pts) {
    auto d = describe(ii, cfg, luts, p);
    for (size_t k = 0; k < d.size(); ++k)
      std::printf(k + 1 < d.size() ? "%.8f " : "%.8f\n", double(d[k]));
  }
  return 0;
}
