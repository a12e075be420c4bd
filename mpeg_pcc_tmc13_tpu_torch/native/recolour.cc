// Native recolour transfer core.
//
// Bit-exact C++ mirror of ops/recolour.py `transfer` (itself a
// faithful port of the reference recolourColour/recolourReflectance,
// pointset_processing.cpp:253-925 + the m42538 fixWeight refinement):
// identical IEEE-double operations in the same order, so the
// transferred attributes equal the numpy path exactly and the coded
// attribute streams are unchanged.  The numpy path remains the spec
// and handles the non-CTC attribute-distance caps.
//
// Inputs are the KNN results the Python side already computes (the
// forward/backward searches run in lod.cc knn_float); this entry
// replaces the accumulation + candidate-refinement stages, which
// dominate low-rate whole-CLI encode time (np.add.at scatter plus a
// 27-candidate exhaustive refinement per target).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {
static inline double clip01(double v, double hi) {
  return std::min(std::max(v, 0.0), hi);
}

// numpy's pairwise_sum over a contiguous vector (umath loops.c.src):
// sequential below 8 elements, 8 accumulators + tree combine up to a
// 128 block, recursive halving above.  w.sum(axis=1) in the numpy
// spec reduces contiguous rows, so this order must be replicated for
// bit-identical weights.
static double np_sum(const double* a, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    int64_t i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3]))
               + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  int64_t n2 = (n / 2) - ((n / 2) % 8);
  return np_sum(a, n2) + np_sum(a + n2, n - n2);
}
}  // namespace

// attrs: (S, C) int64; fwd_idx/fwd_d2: (T, kf); bwd_idx/bwd_d2: (S, kb)
// out: (T, C) int64.  flags: bit0 dist_weighted_fwd, bit1
// dist_weighted_bwd, bit2 skip_avg_if_identical_fwd.
extern "C" int recolour_core(
    const int64_t* attrs, int64_t ns, int32_t C,
    const int64_t* fwd_idx, const double* fwd_d2, int64_t nt,
    int32_t kf,
    const int64_t* bwd_idx, const double* bwd_d2, int32_t kb,
    double cap_gf, double cap_gb,
    double dist_offset_fwd, double dist_offset_bwd,
    int32_t flags, int32_t search_range, double bitdepth_max,
    int64_t* out) {
  if (C < 1 || C > 3) return -1;
  const bool wavg_f = flags & 1, wavg_b = flags & 2, skip_ident = flags & 4;
  const double r_src = 1.0 / (double)ns;
  const double r_tgt = 1.0 / (double)nt;

  // ---- forward value (refinedColors1) ----
  std::vector<double> color1(nt * C);
  for (int64_t t = 0; t < nt; ++t) {
    const double* d2 = &fwd_d2[t * kf];
    const int64_t* idx = &fwd_idx[t * kf];
    double w[128];
    for (int j = 0; j < kf; ++j) {
      bool keep = (j == 0) || (d2[j] <= cap_gf);
      double wj = wavg_f ? 1.0 / (d2[j] + dist_offset_fwd) : 1.0;
      w[j] = keep ? wj : 0.0;
    }
    double wsum = std::max(np_sum(w, kf), 1e-300);
    for (int c = 0; c < C; ++c) {
      double acc = 0.0;
      for (int j = 0; j < kf; ++j)
        acc += (double)attrs[idx[j] * C + c] * (w[j] / wsum);
      color1[t * C + c] = clip01(std::floor(acc + 0.5), bitdepth_max);
    }
    if (skip_ident && d2[0] < 0.0001)
      for (int c = 0; c < C; ++c)
        color1[t * C + c] = (double)attrs[idx[0] * C + c];
  }

  // ---- backward accumulators (Ψ₂) ----
  std::vector<double> H(nt, 0.0), wsumb(nt, 0.0), Q(nt, 0.0);
  std::vector<double> wS(nt * C, 0.0), S(nt * C, 0.0);
  for (int j = 0; j < kb; ++j) {
    for (int64_t s = 0; s < ns; ++s) {
      double d2 = bwd_d2[s * kb + j];
      bool ok = d2 <= cap_gb;
      int64_t t = bwd_idx[s * kb + j];
      double wj = wavg_b ? 1.0 / (std::sqrt(d2) + dist_offset_bwd) : 1.0;
      if (!ok) wj = 0.0;
      H[t] += ok ? 1.0 : 0.0;
      wsumb[t] += wj;
      double q = 0.0;
      for (int c = 0; c < C; ++c) {
        double v = (double)attrs[s * C + c];
        wS[t * C + c] += v * wj;
        S[t * C + c] += ok ? v : 0.0;
        q += v * v;
      }
      Q[t] += ok ? q : 0.0;
    }
  }

  // ---- final value: backward centroid + exhaustive refinement ----
  const int sr = search_range;
  for (int64_t t = 0; t < nt; ++t) {
    if (!(H[t] > 0.0)) {
      for (int c = 0; c < C; ++c)
        out[t * C + c] = (int64_t)color1[t * C + c];
      continue;
    }
    double color0[3], c1v[3];
    double ws = std::max(wsumb[t], 1e-300);
    for (int c = 0; c < C; ++c) {
      color0[c] = clip01(std::floor(wS[t * C + c] / ws + 0.5),
                         bitdepth_max);
      c1v[c] = color1[t * C + c];
    }
    double best[3], best_err = HUGE_VAL;
    for (int c = 0; c < C; ++c) best[c] = color0[c];
    for (int s1 = -sr; s1 <= sr; ++s1)
      for (int s2 = -sr; s2 <= sr; ++s2)
        for (int s3 = -sr; s3 <= sr; ++s3) {
          double cand[3];
          if (C == 1) {
            if (s2 || s3) continue;
            cand[0] = clip01(color0[0] + (double)s1, bitdepth_max);
          } else {
            const double d[3] = {(double)s1, (double)s2, (double)s3};
            for (int c = 0; c < C; ++c)
              cand[c] = clip01(color0[c] + d[c], bitdepth_max);
          }
          double e1 = 0.0, cc = 0.0, cs = 0.0;
          for (int c = 0; c < C; ++c) {
            double dd = cand[c] - c1v[c];
            e1 += dd * dd;
            cc += cand[c] * cand[c];
            cs += cand[c] * S[t * C + c];
          }
          e1 *= r_tgt;
          double e2 = (H[t] * cc - 2.0 * cs + Q[t]) * r_src;
          double err = std::max(e1, e2);
          if (err < best_err) {
            best_err = err;
            for (int c = 0; c < C; ++c) best[c] = cand[c];
          }
        }
    for (int c = 0; c < C; ++c) out[t * C + c] = (int64_t)best[c];
  }
  return 0;
}
