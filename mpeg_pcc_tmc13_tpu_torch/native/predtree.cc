// Predictive-geometry chain reconstruction (decoder hot loop).
//
// The encoder (models/geometry_predictive.py) vectorises fully because
// lossless chain prediction reads original positions; the decoder's
// recurrence p[i] = f(mode, p[i-1], p[i-2], p[i-3]) + r[i] is serial by
// nature (reference decodePredictiveGeometry walks the tree the same
// way, geometry_predictive_decoder.cpp:736) — this native loop runs it
// at memory speed.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

inline uint64_t pt_part1by2(uint64_t x) {
  x &= 0x1FFFFF;
  x = (x | (x << 32)) & 0x1F00000000FFFFull;
  x = (x | (x << 16)) & 0x1F0000FF0000FFull;
  x = (x | (x << 8)) & 0x100F00F00F00F00Full;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

inline int64_t pt_morton(int64_t x, int64_t y, int64_t z) {
  return (int64_t)((pt_part1by2((uint64_t)x) << 2)
                   | (pt_part1by2((uint64_t)y) << 1)
                   | pt_part1by2((uint64_t)z));
}

}  // namespace

extern "C" {

// modes: 0 = none (absolute), 1 = delta, 2 = linear2, 3 = linear3
// (reference GPredicter::Mode, geometry_predictive.h:54-60)
void predchain_recon(const int64_t* res, const uint8_t* modes,
                     int64_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      int64_t p = 0;
      switch (modes[i]) {
        case 1:
          p = out[(i - 1) * 3 + c];
          break;
        case 2:
          p = 2 * out[(i - 1) * 3 + c] - out[(i - 2) * 3 + c];
          break;
        case 3:
          p = out[(i - 1) * 3 + c] + out[(i - 2) * 3 + c]
              - out[(i - 3) * 3 + c];
          break;
        default:
          break;
      }
      out[i * 3 + c] = p + res[i * 3 + c];
    }
  }
}

// Inter chain reconstruction: points flagged `inter` predict from the
// compensated reference frame's nearest neighbour of the extrapolated
// position 2*p[i-1]-p[i-2] (reference predgeom inter candidates,
// geometry_predictive.h inter flag + ref node).  ref is Morton-sorted:
// ref_codes ascending, ref_xyz row-matched; lookup = +-window around
// the Morton insertion point (same rule as the python encoder side).
void predchain_recon_inter(const int64_t* res, const uint8_t* modes,
                           const uint8_t* inter, int64_t* out, int64_t n,
                           const int64_t* ref_codes,
                           const int64_t* ref_xyz, int64_t rn,
                           int32_t window) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t p[3] = {0, 0, 0};
    if (inter[i] && rn > 0 && i >= 2) {
      int64_t e[3];
      for (int c = 0; c < 3; ++c) {
        e[c] = 2 * out[(i - 1) * 3 + c] - out[(i - 2) * 3 + c];
        if (e[c] < 0) e[c] = 0;
        if (e[c] > 0x1FFFFF) e[c] = 0x1FFFFF;
      }
      int64_t qc = pt_morton(e[0], e[1], e[2]);
      int64_t lo = 0, hi = rn;
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (ref_codes[mid] < qc) lo = mid + 1; else hi = mid;
      }
      int64_t best = -1;
      long double bestd = 0;
      int64_t a = lo - window, b = lo + window;
      if (a < 0) a = 0;
      if (b > rn) b = rn;
      for (int64_t j = a; j < b; ++j) {
        long double d = 0;
        for (int c = 0; c < 3; ++c) {
          long double dd = (long double)(ref_xyz[j * 3 + c] - e[c]);
          d += dd * dd;
        }
        if (best < 0 || d < bestd) {
          best = j;
          bestd = d;
        }
      }
      for (int c = 0; c < 3; ++c) p[c] = ref_xyz[best * 3 + c];
    } else {
      for (int c = 0; c < 3; ++c) {
        switch (modes[i]) {
          case 1: p[c] = out[(i - 1) * 3 + c]; break;
          case 2:
            p[c] = 2 * out[(i - 1) * 3 + c] - out[(i - 2) * 3 + c];
            break;
          case 3:
            p[c] = out[(i - 1) * 3 + c] + out[(i - 2) * 3 + c]
                   - out[(i - 3) * 3 + c];
            break;
          default: p[c] = 0; break;
        }
      }
    }
    for (int c = 0; c < 3; ++c) out[i * 3 + c] = p[c] + res[i * 3 + c];
  }
}

// Structural (laser, phi-step) inter chain reconstruction: mirror of
// geometry_predictive._chain_decode_rpl_inter's python loop.
// ref (m,3) rows are (r, phi, laser) sorted canonically by
// (laser, phi, r); keys[j] = laser << 40 | phi precomputed here.
void predchain_recon_rpl_inter(const int64_t* res, const uint8_t* modes,
                               const uint8_t* inter, int64_t* out,
                               int64_t n, const int64_t* ref,
                               int64_t m) {
  std::vector<int64_t> keys(m);
  const int64_t kBig = (int64_t)1 << 40;
  for (int64_t j = 0; j < m; ++j)
    keys[j] = ref[j * 3 + 2] * kBig + ref[j * 3 + 1];
  for (int64_t i = 0; i < n; ++i) {
    int64_t p[3];
    if (inter[i] && i >= 1 && m > 0) {
      int64_t prev_phi = out[(i - 1) * 3 + 1];
      int64_t prev_laser = out[(i - 1) * 3 + 2];
      int64_t want = prev_laser * kBig + prev_phi + 1;
      int64_t j = (int64_t)(std::lower_bound(keys.begin(), keys.end(),
                                             want) - keys.begin());
      int64_t jc = j < m ? j : m - 1;
      bool valid = ref[jc * 3 + 2] == prev_laser;
      if (!valid && jc > 0 && ref[(jc - 1) * 3 + 2] == prev_laser)
        jc -= 1;
      for (int c = 0; c < 3; ++c) p[c] = ref[jc * 3 + c];
    } else {
      for (int c = 0; c < 3; ++c) {
        int mm = (i == 0) ? 0 : modes[i];
        switch (mm) {
          case 1: p[c] = out[(i - 1) * 3 + c]; break;
          case 2:
            p[c] = 2 * out[(i - 1) * 3 + c] - out[(i - 2) * 3 + c];
            break;
          case 3:
            p[c] = out[(i - 1) * 3 + c] + out[(i - 2) * 3 + c]
                   - out[(i - 3) * 3 + c];
            break;
          default: p[c] = 0; break;
        }
      }
    }
    for (int c = 0; c < 3; ++c) out[i * 3 + c] = p[c] + res[i * 3 + c];
  }
}

}  // extern "C"
