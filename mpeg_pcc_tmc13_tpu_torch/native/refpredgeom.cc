// Bit-exact reference-conformant G-PCC predictive-geometry codec.
//
// Conformance-oracle companion to refcodec.cc / refattr.cc: decodes
// predictive-geometry bricks produced by the MPEG reference codec
// (tmc3) to the identical reconstructed positions, and emits
// byte-identical bricks for the angular (LiDAR) tool set.  Like the
// other conformance oracles -- and unlike the rest of this repository,
// which is a TPU-first redesign -- this file intentionally reproduces,
// operation for operation, the *normative* semantics of the reference:
//   * the prediction-tree entropy layout
//     (tmc3/geometry_predictive_decoder.cpp:186-731,
//      geometry_predictive.h:54-275)
//   * the angular spherical<->cartesian fixed-point conversions
//     (geometry_predictive.h:246-393, PCCMath.h:641-860) including the
//     normative kISine table (tables.cpp:485)
//   * the encoder's RD mode decision with its 7-bit probability
//     estimates (geometry_predictive_encoder.cpp:72-77,646-1146) and
//     the per-laser chain tree builder
//     (geometry_predictive_encoder.cpp:1286-1397)
// Constant tables are normative and therefore numerically identical to
// the reference (kISine, kDivApproxDivisor, the dirac adaptation LUT).
//
// Scope: intra only (no inter prediction / global motion), geometry
// scaling off (slice QP 0), angular mode with azimuth scaling on or
// off, or non-angular decode; single entropy stream.  Encode is
// angular-only (the non-angular tree builder is a dynamic KD-tree,
// out of scope).  The arithmetic coder is shared with the geometry
// conformance engine (obuf_core.h).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

#include "obuf_core.h"
#include "angular_core.h"
#include <map>

namespace refpg {

using obufcore::ArithDec;
using obufcore::ArithEnc;

// ---------------------------------------------------------------------------
// math helpers (PCCMisc.h:147-185, PCCMath.h:641-800)
// ---------------------------------------------------------------------------

static inline int ilog2u(uint32_t x) {
  return x ? 31 - __builtin_clz(x) : -1;
}
static inline int ilog2u64(uint64_t x) {
  return x ? 63 - __builtin_clzll(x) : -1;
}
static inline int ceillog2u(uint32_t x) { return ilog2u(x - 1) + 1; }
static inline int numBitsI(int x) {
  return std::max(0, ilog2u(uint32_t(x))) + 1;
}

static inline int64_t divExp2(int64_t x, int shift) {
  return x >= 0 ? x >> shift : -(-x >> shift);
}
static inline int64_t divExp2RoundHalfUp(int64_t x, int shift) {
  if (!shift) return x;
  return (x + (1ll << (shift - 1))) >> shift;
}
static inline int64_t divExp2RoundHalfInf(int64_t s, int shift) {
  if (!shift) return s;
  int64_t s0 = 1ll << (shift - 1);
  return s >= 0 ? (s0 + s) >> shift : -((s0 - s) >> shift);
}

// kDivApproxDivisor (misc.cpp:313-336) - normative constant table
static const uint16_t kDivApproxDivisor[256] = {
  65535, 32767, 21844, 16383, 13106, 10922, 9361, 8191, 7281, 6553, 5957,
  5460, 5040, 4680, 4368, 4095, 3854, 3640, 3448, 3276, 3120, 2978, 2848,
  2730, 2620, 2520, 2426, 2340, 2259, 2184, 2113, 2047, 1985, 1927, 1871,
  1819, 1770, 1724, 1679, 1637, 1597, 1559, 1523, 1488, 1455, 1424, 1393,
  1364, 1336, 1310, 1284, 1259, 1236, 1213, 1191, 1169, 1149, 1129, 1110,
  1091, 1073, 1056, 1039, 1023, 1007, 992, 977, 963, 949, 935, 922, 909,
  897, 885, 873, 861, 850, 839, 829, 818, 808, 798, 789, 779, 770, 761,
  752, 744, 735, 727, 719, 711, 704, 696, 689, 682, 675, 668, 661, 654,
  648, 642, 635, 629, 623, 617, 611, 606, 600, 595, 589, 584, 579, 574,
  569, 564, 559, 554, 550, 545, 541, 536, 532, 528, 523, 519, 515, 511,
  507, 503, 499, 495, 492, 488, 484, 481, 477, 474, 470, 467, 464, 461,
  457, 454, 451, 448, 445, 442, 439, 436, 433, 430, 427, 425, 422, 419,
  416, 414, 411, 409, 406, 404, 401, 399, 396, 394, 391, 389, 387, 385,
  382, 380, 378, 376, 373, 371, 369, 367, 365, 363, 361, 359, 357, 355,
  353, 351, 349, 348, 346, 344, 342, 340, 339, 337, 335, 333, 332, 330,
  328, 327, 325, 323, 322, 320, 319, 317, 316, 314, 313, 311, 310, 308,
  307, 305, 304, 302, 301, 300, 298, 297, 296, 294, 293, 292, 290, 289,
  288, 286, 285, 284, 283, 281, 280, 279, 278, 277, 276, 274, 273, 272,
  271, 270, 269, 268, 266, 265, 264, 263, 262, 261, 260, 259, 258, 257,
  256, 255};

// divInvDivisorApprox + divApprox (PCCMath.h:713-736)
static inline int64_t divInvDivisorApprox(uint64_t b, int32_t& log2InvScale) {
  const int32_t lutSizeLog2 = 8;
  const int n = std::max(0, ilog2u64(b) + 1 - lutSizeLog2);
  const uint64_t index = (b + ((1ull << n) >> 1)) >> n;
  log2InvScale = n + (lutSizeLog2 << 1);
  return kDivApproxDivisor[index - 1] + 1;
}
static inline int64_t divApprox(int64_t a, uint64_t b, int32_t log2Scale) {
  int32_t log2InvScale;
  const int64_t invB = divInvDivisorApprox(b, log2InvScale);
  return (invB * a) >> (log2InvScale - log2Scale);
}

// shared entry for other translation units in this .so (refcodec's
// z-compensation needs the exact LUT-based division)
extern "C" int64_t tmc13_div_approx(int64_t a, uint64_t b,
                                    int32_t log2Scale) {
  return divApprox(a, b, log2Scale);
}

// recipApprox (PCCMath.h:742-763), NIter = 1
static inline int64_t recipApprox(int64_t b, int32_t& log2Scale) {
  int log2ScaleOffset = 0;
  int32_t log2bPlusOne = ilog2u64(uint64_t(b)) + 1;
  if (log2bPlusOne > 31) {
    b >>= log2bPlusOne - 31;
    log2ScaleOffset -= log2bPlusOne - 31;
  }
  if (log2bPlusOne < 31) {
    b <<= 31 - log2bPlusOne;
    log2ScaleOffset += 31 - log2bPlusOne;
  }
  int64_t bRecip = ((0x2d2d2d2dLL << 31) - 0x1e1e1e1eLL * b) >> 28;
  bRecip += bRecip * ((1LL << 31) - (b * bRecip >> 31)) >> 31;
  log2Scale = (31 << 1) - log2ScaleOffset;
  return bRecip;
}

// normative quarter-wave sine table, Q24 (tables.cpp:485 kISine[1026])
static const int32_t kISine[1026] = {
#include "isine_table.inc"
};

static const int kLog2ISineScale = 24;
static const int kLog2ISineAngleScale = 12;

// isin0/icos0/isin/icos (PCCMath.h:806-860)
static inline int32_t isin0(int32_t x, int32_t log2Scale) {
  const int ds = log2Scale - kLog2ISineAngleScale;
  const int b = 1 << ds;
  const int i0 = x >> ds;
  const int x0 = i0 << ds;
  const int d1 = x - x0;
  return kISine[i0]
    + ((d1 * (kISine[i0 + 1] - kISine[i0]) + (b >> 1)) >> ds);
}
static inline int32_t icos0(int32_t x, int32_t log2Scale) {
  return isin0((1 << (log2Scale - 2)) - x, log2Scale);
}
static inline int32_t isin(int32_t x, int32_t log2Scale) {
  const int L = 1 << (log2Scale - 1);
  x = std::min(std::max(x, -L), L);
  const int Q0 = 1 << (log2Scale - 2);
  if (x >= Q0) return isin0((1 << (log2Scale - 1)) - x, log2Scale);
  if (x >= 0) return isin0(x, log2Scale);
  if (x >= -Q0) return -isin0(-x, log2Scale);
  return -isin0((1 << (log2Scale - 1)) + x, log2Scale);
}
static inline int32_t icos(int32_t x, int32_t log2Scale) {
  const int Q0 = 1 << (log2Scale - 2);
  const int ax = std::min(std::abs(x), 1 << (log2Scale - 1));
  return ax <= Q0 ? icos0(ax, log2Scale)
                  : -icos0((1 << (log2Scale - 1)) - ax, log2Scale);
}

struct V3 {
  int32_t v[3];
  int32_t& operator[](int k) { return v[k]; }
  int32_t operator[](int k) const { return v[k]; }
  bool operator==(const V3& o) const {
    return v[0] == o.v[0] && v[1] == o.v[1] && v[2] == o.v[2];
  }
  bool operator!=(const V3& o) const { return !(*this == o); }
};
static inline V3 vsub(const V3& a, const V3& b) {
  return {{a[0] - b[0], a[1] - b[1], a[2] - b[2]}};
}
static inline V3 vadd(const V3& a, const V3& b) {
  return {{a[0] + b[0], a[1] + b[1], a[2] + b[2]}};
}
static inline int64_t norm1(const V3& a) {
  return std::abs(int64_t(a[0])) + std::abs(int64_t(a[1]))
    + std::abs(int64_t(a[2]));
}

// ---------------------------------------------------------------------------
// codec parameters (glue layout shared with conformance/{decoder,encoder}.py)
// ---------------------------------------------------------------------------

struct PGParams {
  int uniquePoints;
  int angular;
  int azimuthScaling;
  int residual2Disabled;
  int numLasers;
  V3 origin;                 // slice-local angular origin, stv
  int twoPiLog2;             // azimuth_scale_log2_minus11 + 12
  int azimuthSpeed;          // azimuth_speed_minus1 + 1
  int rInvLog2;              // radius_inv_scale_log2
  int maxPredIdx;
  int thObj;
  int thQphi;
  int residBits[3];          // pgeom_resid_abs_log2_bits (in / out)
  int minRadius;             // pgeom_min_radius (in / out)
  int bypassNoUpdate;
  int maxPtsPerTree;         // encode
  int maxPredIdxTested;      // encode
  int rootLog2[3];           // encode: gbh.rootNodeSizeLog2, stv
  int chunked;               // sps cabac_bypass_stream_enabled_flag

  static PGParams from(const int32_t* p) {
    PGParams g;
    g.uniquePoints = p[0];
    g.angular = p[1];
    g.azimuthScaling = p[2];
    g.residual2Disabled = p[3];
    g.numLasers = p[4];
    g.origin = {{p[5], p[6], p[7]}};
    g.twoPiLog2 = p[8];
    g.azimuthSpeed = p[9];
    g.rInvLog2 = p[10];
    g.maxPredIdx = p[11];
    g.thObj = p[12];
    g.thQphi = p[13];
    g.residBits[0] = p[14];
    g.residBits[1] = p[15];
    g.residBits[2] = p[16];
    g.minRadius = p[17];
    g.bypassNoUpdate = p[18];
    g.maxPtsPerTree = p[19];
    g.maxPredIdxTested = p[20];
    g.rootLog2[0] = p[21];
    g.rootLog2[1] = p[22];
    g.rootLog2[2] = p[23];
    g.chunked = p[24];
    return g;
  }
};

// SphericalToCartesian (geometry_predictive.h:246-274)
struct SphToCart {
  int log2ScaleRadius, log2ScalePhi;
  const int32_t *tanThetaLaser, *zLaser;
  static const int log2ScaleZ = 3;
  static const int log2ScaleTheta = 20;

  V3 operator()(const V3& sph) const {
    int64_t r = int64_t(sph[0]) << log2ScaleRadius;
    int64_t z = divExp2RoundHalfInf(
      int64_t(tanThetaLaser[sph[2]]) * r << 2, log2ScaleTheta - log2ScaleZ);
    return {{
      int32_t(divExp2RoundHalfInf(
        r * icos(sph[1], log2ScalePhi), kLog2ISineScale)),
      int32_t(divExp2RoundHalfInf(
        r * isin(sph[1], log2ScalePhi), kLog2ISineScale)),
      int32_t(divExp2RoundHalfInf(z - zLaser[sph[2]], log2ScaleZ))}};
  }
};

// CartesianToSpherical (geometry_predictive.h:278-340): double hypot /
// atan2 exactly as the reference (same libm on the parity host), then
// the +-2 integer local optimisation.
struct CartToSph {
  SphToCart s2c;
  int log2ScaleRadius, scalePhi, numLasers;
  const int32_t *tanThetaLaser, *zLaser;
  static const int log2ScaleZ = 3;
  static const int log2ScaleTheta = 20;

  V3 operator()(const V3& xyz) const {
    int64_t r0 = int64_t(std::round(
      std::hypot(double(xyz[0]), double(xyz[1]))));
    int32_t thetaIdx = 0;
    int32_t minError = std::numeric_limits<int32_t>::max();
    for (int idx = 0; idx < numLasers; ++idx) {
      int64_t z = divExp2RoundHalfInf(
        int64_t(tanThetaLaser[idx]) * r0 << 2, log2ScaleTheta - log2ScaleZ);
      int64_t z1 = divExp2RoundHalfInf(z - zLaser[idx], log2ScaleZ);
      int32_t err = std::abs(int32_t(z1 - xyz[2]));
      if (err < minError) {
        thetaIdx = idx;
        minError = err;
      }
    }
    double phi0 = std::round(
      (std::atan2(double(xyz[1]), double(xyz[0])) / (2.0 * M_PI))
      * scalePhi);
    V3 sphPos{{int32_t(divExp2RoundHalfUp(r0, log2ScaleRadius)),
               int32_t(phi0), thetaIdx}};
    int64_t minErr = norm1(vsub(s2c(sphPos), xyz));
    int32_t dt0 = 0, dr0 = 0;
    for (int32_t dt = -2; dt <= 2 && minErr; ++dt) {
      for (int32_t dr = -2; dr <= 2; ++dr) {
        V3 cand{{sphPos[0] + dr, sphPos[1] + dt, sphPos[2]}};
        int64_t err = norm1(vsub(s2c(cand), xyz));
        if (err < minErr) {
          minErr = err;
          dt0 = dt;
          dr0 = dr;
        }
      }
    }
    sphPos[0] += dr0;
    sphPos[1] += dt0;
    return sphPos;
  }
};

// CartesianToSphericalSimple (geometry_predictive.h:341-381): isqrt
// radius, iatan2 azimuth with the fixed-point affine remap, nearest
// laser by elevation error (no +-2 refinement)
struct CartToSphSimple {
  SphToCart s2c;
  int log2ScaleRadius, twoPiLog2, numLasers;
  const int32_t *tanThetaLaser, *zLaser;
  static const int log2ScaleZ = 3;
  static const int log2ScaleTheta = 20;

  V3 operator()(const V3& xyz) const {
    const int64_t xLaser = int64_t(xyz[0]) << 8;
    const int64_t yLaser = int64_t(xyz[1]) << 8;
    const int64_t r0 =
      int64_t(angularcore::isqrt(
        uint64_t(xLaser * xLaser + yLaser * yLaser))) >> 8;
    int32_t thetaIdx = 0;
    int32_t minError = std::numeric_limits<int32_t>::max();
    for (int idx = 0; idx < numLasers; ++idx) {
      int64_t z = divExp2RoundHalfInf(
        int64_t(tanThetaLaser[idx]) * r0 << 2, log2ScaleTheta - log2ScaleZ);
      int64_t z1 = divExp2RoundHalfInf(z - zLaser[idx], log2ScaleZ);
      int32_t err = int32_t(std::abs(z1 - xyz[2]));
      if (err < minError) {
        thetaIdx = idx;
        minError = err;
      }
    }
    const int azimLog2 = twoPiLog2 - 1;
    const int64_t tanElevAng =
      angularcore::iatan2(int(yLaser), int(xLaser));
    const int sh = 44 - azimLog2;
    const int64_t off = int64_t(1) << (sh - 1);
    int64_t phi0 =
      (((tanElevAng + 3294199) * 5340354 + off) >> sh) - (1 << azimLog2);
    return {{int32_t(divExp2RoundHalfUp(r0, log2ScaleRadius)),
             int32_t(phi0), thetaIdx}};
  }
};

static inline int64_t divExp2RoundHalfInfPosShift(int64_t s, unsigned shift,
                                                  int64_t s0) {
  // PCCMath.h:703-707
  return s >= 0 ? (s0 + s) >> shift : -((s0 - s) >> shift);
}

// ---------------------------------------------------------------------------
// reference-frame spherical predictor (PredGeomPredictor,
// geometry_predictive.h:398-644; single reference, no bi-prediction)
// ---------------------------------------------------------------------------

struct RefSph {
  int azimScaleLog2 = 0;
  int numLasers = 0;
  bool globalMotionEnabled = false;
  bool resampling = false;
  bool interEnabled = false;
  bool movingState = false;             // gbh.interFrameRefGmcFlag
  int thresh0 = 0, thresh1 = 0;         // gm_thresh.{first,second}
  int64_t gmMatrix[9] = {65536, 0, 0, 0, 65536, 0, 0, 0, 65536};
  int32_t gmTrans[3] = {0, 0, 0};
  // per-laser azimuth-keyed maps: previous frame, motion-compensated
  // previous frame, current frame (accumulating)
  std::vector<std::map<int, V3>> refPointVals, refPointValsGlob,
    refPointValsCur;

  void init(int azimLog2, int nLasers, bool gmEnabled, bool resamp) {
    if (numLasers) return;  // already initialised (reference :403-416)
    azimScaleLog2 = azimLog2;
    numLasers = nLasers;
    globalMotionEnabled = gmEnabled;
    resampling = resamp;
    refPointVals.resize(size_t(nLasers));
    refPointValsGlob.resize(size_t(nLasers));
    refPointValsCur.resize(size_t(nLasers));
  }

  int computePhiQuantized(int val) const {
    int offset = azimScaleLog2 ? (1 << (azimScaleLog2 - 1)) : 0;
    return val >= 0 ? (val + offset) >> azimScaleLog2
                    : -((-val + offset) >> azimScaleLog2);
  }

  void insert(const V3* pts, int n) {
    for (int i = 0; i < n; i++) {
      const V3& pt = pts[i];
      // std::map::insert keeps the FIRST entry on key collision
      refPointValsCur[size_t(pt[2])].insert(
        {computePhiQuantized(pt[1]), pt});
    }
  }

  void clearRefFrame() {
    for (auto& m : refPointVals) m.clear();
  }

  // getInterPred (:425-449): even refNodeIdx takes the first point
  // past the current azimuth, odd the second; idx > 1 reads the
  // motion-compensated map
  bool getInterPred(int currAzim, int currLaserId, int refNodeIdx,
                    V3* out) const {
    const auto& refPic =
      (refNodeIdx > 1) ? refPointValsGlob : refPointVals;
    const auto& refPoints = refPic[size_t(currLaserId)];
    const bool nextPred = !(refNodeIdx & 0x1);
    if (refPoints.empty()) return false;
    const auto quantizedPhi = computePhiQuantized(currAzim);
    auto idx = refPoints.upper_bound(quantizedPhi);
    if (idx == refPoints.end()) return false;
    if (nextPred) {
      *out = idx->second;
      return true;
    }
    idx = refPoints.upper_bound(idx->first);
    if (idx == refPoints.end()) return false;
    *out = idx->second;
    return true;
  }

  // updateFrame (:501-607): motion-compensate the accumulated current
  // frame into the global map (cartesian round trip through the
  // simple converter), optional radius resampling when moving, then
  // rotate current -> previous
  void updateFrame(const SphToCart& s2c, const CartToSphSimple& c2s) {
    if (globalMotionEnabled) {
      for (auto& m : refPointValsGlob) m.clear();
      for (int laserId = 0; laserId < numLasers; laserId++) {
        for (auto& ptIter : refPointValsCur[size_t(laserId)]) {
          V3 pt = s2c(ptIter.second);
          if (pt[2] > thresh0 || pt[2] < thresh1) {
            V3 p = pt;
            for (int k = 0; k < 3; k++) {
              int64_t x = divExp2RoundHalfInfPosShift(
                gmMatrix[3 * k + 0] * p[0] + gmMatrix[3 * k + 1] * p[1]
                  + gmMatrix[3 * k + 2] * p[2],
                16, int64_t(1) << 15) + gmTrans[k];
              pt[k] = int32_t(x);
            }
            pt = c2s(pt);
          } else
            pt = ptIter.second;
          const int phiQ = computePhiQuantized(pt[1]);
          auto& lane = refPointValsGlob[size_t(pt[2])];
          auto it = lane.find(phiQ);
          if (it == lane.end())
            lane.insert({phiQ, pt});
          else if (it->second[0] > pt[0])
            it->second = pt;
        }
      }

      if (movingState) {
        if (resampling) {
          for (int laserId = 0; laserId < numLasers; laserId++) {
            auto& ptsZero = refPointValsCur[size_t(laserId)];
            auto& ptsGlob = refPointValsGlob[size_t(laserId)];
            for (auto& ptIter : ptsZero) {
              V3 ptA{{0, 0, 0}}, ptB{{0, 0, 0}};
              auto& pt = ptIter.second;
              const int phiQ = computePhiQuantized(pt[1]);
              auto hit = ptsGlob.find(phiQ);
              if (hit != ptsGlob.end()) {
                const auto& colPt = hit->second;
                ptA = colPt;
                if (colPt[1] < pt[1]) {
                  auto idx = ptsGlob.upper_bound(phiQ);
                  ptB = (idx == ptsGlob.end()) ? ptA : idx->second;
                } else if (colPt[1] > pt[1]) {
                  auto idx = ptsGlob.lower_bound(phiQ);
                  ptB = (idx == ptsGlob.begin()) ? ptA
                                                 : std::prev(idx)->second;
                } else
                  ptB = ptA;
              } else {
                auto idx = ptsGlob.upper_bound(phiQ);
                auto idx1 = idx;
                if (idx != ptsGlob.begin()) idx1 = std::prev(idx);
                if (idx == ptsGlob.end()) idx = idx1;
                if (idx == ptsGlob.end()) continue;  // empty map guard
                ptA = idx->second;
                ptB = idx1->second;
              }
              int64_t delAzim = ptA[1] - ptB[1];
              int64_t delRad = ptA[0] - ptB[0];
              if (!delAzim || !delRad)
                pt[0] = ptA[0];
              else {
                const int64_t nr = delRad * (pt[1] - ptA[1]);
                const int64_t dr = delAzim;
                const bool sign =
                  ((nr > 0 && dr > 0) || (nr < 0 && dr < 0)) ? 0 : 1;
                pt[0] = int32_t(
                  ptA[0]
                  + (1 - 2 * int(sign))
                    * ((std::abs(nr) + (std::abs(dr) >> 1))
                       / std::abs(dr)));
              }
            }
          }
        }
      } else {
        // not moving: the compensated map is replaced by the OLD
        // previous frame (reference :597-599, a normative quirk)
        for (int laserId = 0; laserId < numLasers; laserId++)
          refPointValsGlob[size_t(laserId)] =
            std::move(refPointVals[size_t(laserId)]);
      }

      for (int laserId = 0; laserId < numLasers; laserId++)
        refPointVals[size_t(laserId)] =
          std::move(refPointValsCur[size_t(laserId)]);
      for (auto& m : refPointValsCur) m.clear();
    } else {
      for (int laserId = 0; laserId < numLasers; laserId++)
        refPointVals[size_t(laserId)] =
          std::move(refPointValsCur[size_t(laserId)]);
      for (auto& m : refPointValsCur) m.clear();
    }
  }
};

// ---------------------------------------------------------------------------
// context state (PredGeomContexts, geometry_predictive.h:84-136); all
// probabilities start at 0x8000 like AdaptiveBitModel
// ---------------------------------------------------------------------------

struct PGCtx {
  uint16_t numChildren[3];
  uint16_t predMode[3];
  uint16_t predIdx[7];                  // kPTEMaxPredictorIndex = 7
  uint16_t resGt0[2][3];
  uint16_t sign[2][3];
  uint16_t numBits[2][5][3][31];
  uint16_t numDupGt0, numDup;
  uint16_t res2GtN[2][3];
  uint16_t sign2[3];
  uint16_t eg2Pre[3][5];
  uint16_t eg2Suf[3][4];
  uint16_t phiGtN[2][2][2];
  uint16_t signPhi[2][2];
  uint16_t egPhi[2][2];
  uint16_t residualPhi[2][2][7];
  uint16_t endOfTrees;
  uint16_t resRGTZero[2][4];
  uint16_t resRGTOne[2][4];
  uint16_t resRGTTwo[2][4];
  uint16_t resRPre[2][4][10];
  uint16_t resRSuf[2][4][10];
  uint16_t resPhiGTZero[2][2];
  uint16_t resPhiSign[2][5];
  uint16_t resPhiGTOne[2][2];
  uint16_t resPhiPre[3][4];
  uint16_t resPhiSuf[3][4];
  uint16_t resRSign[3][2][8];
  uint16_t interFlag[32];
  uint16_t refNodeIdx[3];
  uint16_t refDirFlag;

  bool prevInterFlag = false;
  bool precSignR = false;
  int resPhiOldSign = 3;
  int precAzimuthStepDelta = 0;

  PGCtx() {
    uint16_t* base = reinterpret_cast<uint16_t*>(this);
    size_t n = offsetof(PGCtx, prevInterFlag) / sizeof(uint16_t);
    for (size_t i = 0; i < n; i++) base[i] = 0x8000;
  }
};

// decodeExpGolomb with prefix+suffix context arrays
// (entropyutils.h:211-239); the clamping mirrors the templates'
// NumPrefixCtx/NumSuffixCtx bounds.
// NB: the k <= 30 bound is a robustness guard absent from the
// reference (whose prefix loop spins forever on past-end garbage);
// valid streams never exceed it, so decode output is unchanged.
static unsigned decodeEgPS(ArithDec& ad, int k, uint16_t* pre, int npre,
                           uint16_t* suf, int nsuf, bool* bad) {
  const int k0 = k;
  unsigned l;
  int symbol = 0;
  int binary = 0;
  do {
    l = ad.bit(&pre[std::min(npre - 1, k - k0)]);
    if (l == 1) {
      symbol += 1 << k;
      k++;
      if (k > 30) {
        *bad = true;
        return 0;
      }
    }
  } while (l != 0);
  while (k--)
    binary |= ad.bit(&suf[std::min(nsuf - 1, k)]) << k;
  return unsigned(symbol + binary);
}

static void encodeEgPS(ArithEnc& ae, unsigned symbol, int k, uint16_t* pre,
                       int npre, uint16_t* suf, int nsuf) {
  const int k0 = k;
  while (symbol >= (1u << k)) {
    ae.bit(&pre[std::min(npre - 1, k - k0)], 1);
    symbol -= 1u << k;
    k++;
  }
  ae.bit(&pre[std::min(npre - 1, k - k0)], 0);
  while (k--)
    ae.bit(&suf[std::min(nsuf - 1, k)], (symbol >> k) & 1);
}

// ---------------------------------------------------------------------------
// decoder (PredGeomDecoder, geometry_predictive_decoder.cpp:48-731);
// intra scope: no inter flags, no QP offsets (scaling off)
// ---------------------------------------------------------------------------

struct Decoder {
  ArithDec ad;
  PGCtx c;
  PGParams g;
  SphToCart s2c;
  std::vector<int32_t> stack;
  std::vector<int32_t> parentOf;
  bool bad = false;              // corrupt-payload flag (guards only)
  RefSph* refSph = nullptr;      // inter prediction reference (may be null)

  // bounded single-context exp-Golomb (same robustness guard as
  // decodeEgPS; the shared ArithDec::exp_golomb has no bound)
  unsigned expGolomb0(uint16_t* prefixCtx) {
    unsigned l;
    int k = 0;
    int symbol = 0;
    int binary = 0;
    do {
      l = ad.bit(prefixCtx);
      if (l == 1) {
        symbol += 1 << k;
        k++;
        if (k > 30) {
          bad = true;
          return 0;
        }
      }
    } while (l != 0);
    while (k--)
      if (ad.bypass() == 1) binary |= 1 << k;
    return unsigned(symbol + binary);
  }

  int decodeNumDuplicatePoints() {
    if (!ad.bit(&c.numDupGt0)) return 0;
    return 1 + int(expGolomb0(&c.numDup));
  }

  int decodeNumChildren() {
    int val = ad.bit(&c.numChildren[0]);
    if (val == 1) {
      val += ad.bit(&c.numChildren[1]);
      if (val == 2) val += ad.bit(&c.numChildren[2]);
    }
    return val ^ 1;
  }

  int decodePredMode() {
    int mode = ad.bit(&c.predMode[0]);
    mode = (mode << 1) + ad.bit(&c.predMode[1 + mode]);
    return mode;
  }

  int decodePredIdx() {
    int predIdx = 0;
    while (predIdx < g.maxPredIdx && ad.bit(&c.predIdx[predIdx]))
      ++predIdx;
    return predIdx;
  }

  V3 decodeResidual2() {
    V3 residual;
    for (int k = 0; k < 3; ++k) {
      int value = ad.bit(&c.res2GtN[0][k]);
      if (!value) {
        residual[k] = 0;
        continue;
      }
      value += ad.bit(&c.res2GtN[1][k]);
      if (value == 1) {
        int s = ad.bit(&c.sign2[k]);
        residual[k] = s ? -1 : 1;
        continue;
      }
      value += decodeEgPS(ad, 0, c.eg2Pre[k], 5, c.eg2Suf[k], 4, &bad);
      int s = ad.bit(&c.sign2[k]);
      residual[k] = s ? -value : value;
    }
    return residual;
  }

  int32_t decodePhiMultiplier(int predIdx, bool interFlag = false,
                              int refNodeIdx = 0) {
    if (!g.angular) return 0;
    int ctxL =
      interFlag ? (refNodeIdx > 1 ? 1 : 0) : (predIdx ? 1 : 0);
    int ci = interFlag ? 1 : 0;
    if (!ad.bit(&c.phiGtN[ci][ctxL][0])) return 0;
    int value = 1;
    value += ad.bit(&c.phiGtN[ci][ctxL][1]);
    if (value == 1) {
      int s = ad.bit(&c.signPhi[ci][ctxL]);
      return s ? -1 : 1;
    }
    uint16_t* ctxs = &c.residualPhi[ci][ctxL][0] - 1;
    value = 1;
    for (int n = 3; n > 0; n--)
      value = (value << 1) | ad.bit(&ctxs[value]);
    value ^= 1 << 3;
    if (value == 7) value += int(expGolomb0(&c.egPhi[ci][ctxL]));
    int s = ad.bit(&c.signPhi[ci][ctxL]);
    return s ? -(value + 2) : (value + 2);
  }

  bool decodeInterFlag(uint8_t interFlagBuffer) {
    return ad.bit(&c.interFlag[interFlagBuffer & 0x1F]) != 0;
  }

  int decodeRefNodeIdx(bool globalMotionEnabled) {
    int refNodeIdx = 0;
    if (globalMotionEnabled) refNodeIdx = ad.bit(&c.refNodeIdx[0]);
    refNodeIdx =
      (refNodeIdx << 1) + ad.bit(&c.refNodeIdx[1 + refNodeIdx]);
    return refNodeIdx;
  }

  bool decodeEndOfTreesFlag() { return ad.bit(&c.endOfTrees); }

  int32_t decodeResPhi(int predIdx, bool interFlag = false,
                       int refNodeIdx = 0) {
    int ci = interFlag ? 1 : 0;
    int ctxL =
      interFlag ? (refNodeIdx > 1 ? 1 : 0) : (predIdx ? 1 : 0);
    if (!ad.bit(&c.resPhiGTZero[ci][ctxL])) return 0;
    int absVal = 1;
    absVal += ad.bit(&c.resPhiGTOne[ci][ctxL]);
    int egk = interFlag ? (refNodeIdx > 1 ? 2 : 1) : 0;
    if (absVal == 2)
      absVal += decodeEgPS(ad, 1, c.resPhiPre[egk], 4, c.resPhiSuf[egk], 4,
                           &bad);
    int sign = ad.bit(&c.resPhiSign[ctxL][ci ? 4 : c.resPhiOldSign]);
    c.resPhiOldSign = interFlag ? (refNodeIdx > 1 ? 3 : 2) : (sign ? 1 : 0);
    return sign ? -absVal : absVal;
  }

  int32_t decodeResR(int multiplier, int predIdx, bool interFlag = false,
                     int refNodeIdx = 0) {
    const int ci = interFlag ? 1 : 0;
    int ctxL =
      interFlag ? (refNodeIdx > 1 ? 1 : 0) : (predIdx ? 1 : 0);
    int ctxLR = ctxL
      + (interFlag ? (std::abs(multiplier) > 2 ? 2 : 0)
                   : (std::abs(multiplier) > g.thQphi ? 2 : 0));
    if (!ad.bit(&c.resRGTZero[ci][ctxLR])) return 0;
    int absVal = 1;
    absVal += ad.bit(&c.resRGTOne[ci][ctxLR]);
    if (absVal == 2) absVal += ad.bit(&c.resRGTTwo[ci][ctxLR]);
    if (absVal == 3)
      absVal += decodeEgPS(ad, 2, c.resRPre[ci][ctxLR], 10,
                           c.resRSuf[ci][ctxLR], 10, &bad);
    int ctxR = (c.precAzimuthStepDelta ? 4 : 0) + (multiplier ? 2 : 0)
      + (c.precSignR ? 1 : 0);
    int sign = ad.bit(
      &c.resRSign[ci ? 2 : (c.prevInterFlag ? 1 : 0)][ctxL][ctxR]);
    c.precSignR = sign;
    c.precAzimuthStepDelta = multiplier;
    c.prevInterFlag = interFlag;
    return sign ? -absVal : absVal;
  }

  V3 decodeResidual(int mode, int multiplier, int rPred, int* azimuthSpeed,
                    int predIdx, bool interFlag = false,
                    int refNodeIdx = 0) {
    V3 residual;
    const int ci = interFlag ? 1 : 0;
    *azimuthSpeed = g.azimuthSpeed;
    int k = 0;
    if (g.azimuthScaling) {
      residual[0] = decodeResR(multiplier, predIdx, interFlag, refNodeIdx);
      int r = (rPred + residual[0]) << 3;
      int64_t speedTimesR = int64_t(g.azimuthSpeed) * r;
      int phiBound =
        int(divExp2RoundHalfInf(speedTimesR, g.twoPiLog2 + 1));
      residual[1] = decodeResPhi(predIdx, interFlag, refNodeIdx);
      if (r && !phiBound) {
        const int32_t pi = 1 << (g.twoPiLog2 - 1);
        int32_t speedTimesR32 = int32_t(speedTimesR);
        while (speedTimesR32 < pi) {
          speedTimesR32 <<= 1;
          *azimuthSpeed <<= 1;
        }
      }
      k = 2;
    }
    for (int ctxIdx = 0; k < 3; ++k) {
      if (g.angular && g.numLasers == 1 && k == 2) {
        residual[k] = 0;
        continue;
      }
      if (!ad.bit(&c.resGt0[ci][k])) {
        residual[k] = 0;
        continue;
      }
      uint16_t* ctxs = &c.numBits[ci][ctxIdx][k][0] - 1;
      int32_t nb = 1;
      for (int n = 0; n < g.residBits[k]; n++)
        nb = (nb << 1) | ad.bit(&ctxs[nb]);
      nb ^= 1 << g.residBits[k];
      if (!k && !g.angular) ctxIdx = std::min(4, (nb + 1) >> 1);
      int32_t res = 0;
      --nb;
      if (nb <= 0) {
        res = 2 + nb;
      } else {
        res = 1 + (1 << nb);
        for (int i = 0; i < nb; ++i) res += ad.bypass() << i;
      }
      int sign = 0;
      if (mode || k) sign = ad.bit(&c.sign[ci][k]);
      residual[k] = sign ? -res : res;
    }
    return residual;
  }

  // decodeTree (geometry_predictive_decoder.cpp:496-692), intra.
  // `cap` bounds the node count so a corrupt/truncated payload fails
  // cleanly instead of overrunning the output (the reference would
  // crash here; resilience is this repo's standard, not the spec's).
  int decodeTree(V3* outA, V3* outB, int cap) {
    int nodeCount = 0;
    int prevNodeIdx = -1;
    uint8_t interFlagBuffer = 0;
    stack.push_back(-1);

    std::array<std::array<int, 2>, 8> preds = {};
    const int NPred = g.maxPredIdx + 1;
    const bool frameMoving = refSph && refSph->interEnabled
      && refSph->movingState;

    while (!stack.empty()) {
      int parentNodeIdx = stack.back();
      stack.pop_back();
      const bool isInterEnabled =
        refSph && refSph->interEnabled && prevNodeIdx >= 0;

      if (nodeCount >= cap) {
        stack.clear();
        return -1;
      }
      int curNodeIdx = nodeCount++;
      parentOf[curNodeIdx] = parentNodeIdx;

      int numDuplicatePoints = 0;
      if (!g.uniquePoints) numDuplicatePoints = decodeNumDuplicatePoints();
      if (numDuplicatePoints > cap - nodeCount) {
        stack.clear();
        return -1;
      }
      int numChildren = decodeNumChildren();
      if (bad) {
        stack.clear();
        return -1;
      }

      bool interFlag = false;
      int refNodeIdx = 0;
      if (isInterEnabled) interFlag = decodeInterFlag(interFlagBuffer);
      if (interFlag)
        refNodeIdx = decodeRefNodeIdx(refSph->globalMotionEnabled);

      int mode = 1;
      int predIdx = 0;
      if (!interFlag) {
        if (g.azimuthScaling)
          predIdx = decodePredIdx();
        else
          mode = decodePredMode();
      }
      int qphi = decodePhiMultiplier(predIdx, interFlag, refNodeIdx);

      // makePredicter + GPredicter::predict
      // (geometry_predictive.h:149-242)
      V3 pred{{0, 0, 0}};
      if (interFlag && prevNodeIdx != -1) {
        // inter branch (geometry_predictive_decoder.cpp:585-606)
        const V3 prevPos = outA[prevNodeIdx];
        const V3 parentPos =
          parentNodeIdx >= 0 ? outA[parentNodeIdx] : V3{{0, 0, 0}};
        if (!refSph->getInterPred(prevPos[1], prevPos[2], refNodeIdx,
                                  &pred)) {
          bad = true;
          stack.clear();
          return -1;
        }
        if (refNodeIdx > 1 && frameMoving) {
          const int deltaPhi = pred[1] - parentPos[1];
          pred[1] = parentPos[1];
          if (deltaPhi >= (g.azimuthSpeed >> 1)
              || deltaPhi <= -(g.azimuthSpeed >> 1)) {
            int qphi0 = int(divApprox(
              int64_t(deltaPhi) + (g.azimuthSpeed >> 1), g.azimuthSpeed,
              0));
            pred[1] += qphi0 * g.azimuthSpeed;
          }
        }
      } else {
        int m = mode == 0 ? 1 : mode;  // None treated as Delta for walk
        int32_t index[3] = {-1, -1, -1};
        int walk = curNodeIdx;
        for (int i = 0; i < m; i++) {
          if (walk < 0) break;
          index[i] = walk = parentOf[walk];
        }
        switch (mode) {
        case 0:
          pred = {{0, 0, 0}};
          if (g.angular) pred[0] = g.minRadius;
          if (index[0] >= 0 && g.angular) {
            pred[1] = outA[index[0]][1];
            pred[2] = outA[index[0]][2];
          }
          break;
        case 1:
          pred = {{0, 0, 0}};
          pred[0] = g.minRadius;
          if (index[0] >= 0) pred = outA[index[0]];
          break;
        case 2: {
          const V3& p0 = outA[index[0]];
          const V3& p1 = outA[index[1]];
          pred = {{2 * p0[0] - p1[0], 2 * p0[1] - p1[1],
                   2 * p0[2] - p1[2]}};
          break;
        }
        default: {
          const V3& p0 = outA[index[0]];
          const V3& p1 = outA[index[1]];
          const V3& p2 = outA[index[2]];
          pred = {{p0[0] + p1[0] - p2[0], p0[1] + p1[1] - p2[1],
                   p0[2] + p1[2] - p2[2]}};
          break;
        }
        }
        if (g.azimuthScaling && predIdx > 0) {
          pred[0] = preds[predIdx][0];
          int deltaPhi = pred[1] - preds[predIdx][1];
          pred[1] = preds[predIdx][1];
          if (deltaPhi >= g.azimuthSpeed || deltaPhi <= -g.azimuthSpeed) {
            int qphi0 =
              int(divApprox(int64_t(deltaPhi), g.azimuthSpeed, 0));
            pred[1] += qphi0 * g.azimuthSpeed;
          }
        }
      }

      int azimuthSpeed;
      V3 residual = decodeResidual(mode, qphi, pred[0], &azimuthSpeed,
                                   predIdx, interFlag, refNodeIdx);
      if (bad) {
        stack.clear();
        return -1;
      }

      // no in-tree scaling: quantizer.scale is identity at qp 0

      if (g.angular && !g.azimuthScaling)
        if (mode >= 0) pred[1] += qphi * g.azimuthSpeed;

      if (g.azimuthScaling) {
        int32_t r = (pred[0] + residual[0]) << 3;
        if (r)
          pred[1] += qphi * azimuthSpeed;
        else
          r = 1;
        int32_t rInvLog2Scale;
        int64_t rInv = recipApprox(r, rInvLog2Scale);
        residual[1] = int32_t(divExp2(
          int64_t(residual[1]) * rInv, rInvLog2Scale - g.twoPiLog2));
      }
      V3 pos = vadd(pred, residual);

      if (g.azimuthScaling) {
        if (pos[1] < -(1 << (g.twoPiLog2 - 1)))
          pos[1] += 1 << g.twoPiLog2;
        if (pos[1] >= 1 << (g.twoPiLog2 - 1))
          pos[1] -= 1 << g.twoPiLog2;
      }

      if (!g.angular)
        for (int k = 0; k < 3; k++) pos[k] = std::max(0, pos[k]);
      outA[curNodeIdx] = pos;

      if (g.azimuthScaling) {
        bool flagNewObject =
          (interFlag ? std::abs(pos[0] - preds[0][0])
                     : std::abs(residual[0]))
          > g.thObj;
        int predBIdx = flagNewObject ? NPred - 1 : predIdx;
        for (int i = predBIdx; i > 0; i--) preds[i] = preds[i - 1];
        preds[0][0] = pos[0];
        preds[0][1] = pos[1];
      }

      if (g.angular) {
        if (pos[2] < 0 || pos[2] >= g.numLasers) {
          bad = true;
          stack.clear();
          return -1;
        }
        if (!g.residual2Disabled)
          residual = decodeResidual2();
        else
          residual = {{0, 0, 0}};
        pred = vadd(g.origin, s2c(pos));
        outB[curNodeIdx] = vadd(pred, residual);
        for (int k = 0; k < 3; k++)
          outB[curNodeIdx][k] = std::max(0, outB[curNodeIdx][k]);
      }

      for (int i = 0; i < numDuplicatePoints; i++, nodeCount++) {
        outA[nodeCount] = outA[curNodeIdx];
        outB[nodeCount] = outB[curNodeIdx];
      }

      for (int i = 0; i < numChildren; i++) stack.push_back(curNodeIdx);

      prevNodeIdx = curNodeIdx;
      interFlagBuffer =
        uint8_t((interFlagBuffer << 1) | (interFlag ? 1 : 0));
    }
    return nodeCount;
  }
};

// ---------------------------------------------------------------------------
// encoder (PredGeomEncoder, geometry_predictive_encoder.cpp:81-1146);
// angular intra scope
// ---------------------------------------------------------------------------

// -log2 of the 7-bit approximate symbol probability
// (geometry_predictive_encoder.cpp:72-77, entropydirac.h:94-99)
static inline float estimate(int bit, uint16_t prob) {
  int p = std::max(1, prob >> 9);
  int q = bit ? 128 - p : p;
  return float(-std::log2(q / 128.));
}

struct Encoder {
  ArithEnc ae;
  PGCtx c;
  PGParams g;
  SphToCart s2c;
  std::vector<int32_t> stack;
  int maxAbsResidualMinus1Log2[3];

  void init() {
    for (int k = 0; k < 3; k++)
      maxAbsResidualMinus1Log2[k] = (1 << g.residBits[k]) - 1;
  }

  void encodeNumDuplicatePoints(int numDupPoints) {
    ae.bit(&c.numDupGt0, numDupPoints > 0);
    if (numDupPoints) ae.exp_golomb(numDupPoints - 1, 0, &c.numDup);
  }

  void encodeNumChildren(int numChildren) {
    int val = numChildren ^ 1;
    ae.bit(&c.numChildren[0], val > 0);
    if (val > 0) {
      ae.bit(&c.numChildren[1], val > 1);
      if (val > 1) ae.bit(&c.numChildren[2], val - 2);
    }
  }

  void encodePredMode(int iMode) {
    ae.bit(&c.predMode[0], (iMode >> 1) & 1);
    ae.bit(&c.predMode[1 + (iMode >> 1)], iMode & 1);
  }

  void encodePredIdx(int predIdx) {
    for (int i = 0; i < predIdx; ++i) ae.bit(&c.predIdx[i], 1);
    if (predIdx < g.maxPredIdx) ae.bit(&c.predIdx[predIdx], 0);
  }

  void encodeResR(int32_t resR, int multiplier, int predIdx) {
    int ctxL = predIdx ? 1 : 0;
    int ctxLR = ctxL + (std::abs(multiplier) > g.thQphi ? 2 : 0);
    ae.bit(&c.resRGTZero[0][ctxLR], resR != 0);
    if (!resR) return;
    int absVal = std::abs(resR);
    ae.bit(&c.resRGTOne[0][ctxLR], --absVal > 0);
    if (absVal) ae.bit(&c.resRGTTwo[0][ctxLR], --absVal > 0);
    if (absVal)
      encodeEgPS(ae, absVal - 1, 2, c.resRPre[0][ctxLR], 10,
                 c.resRSuf[0][ctxLR], 10);
    int ctxR = (c.precAzimuthStepDelta ? 4 : 0) + (multiplier ? 2 : 0)
      + (c.precSignR ? 1 : 0);
    ae.bit(&c.resRSign[c.prevInterFlag ? 1 : 0][ctxL][ctxR], resR < 0);
    c.precSignR = resR < 0;
    c.precAzimuthStepDelta = multiplier;
    c.prevInterFlag = false;
  }

  void encodeResPhi(int32_t resPhi, int predIdx) {
    int ctxL = predIdx ? 1 : 0;
    ae.bit(&c.resPhiGTZero[0][ctxL], resPhi != 0);
    if (!resPhi) return;
    int absVal = std::abs(resPhi);
    ae.bit(&c.resPhiGTOne[0][ctxL], --absVal > 0);
    if (absVal)
      encodeEgPS(ae, absVal - 1, 1, c.resPhiPre[0], 4, c.resPhiSuf[0], 4);
    ae.bit(&c.resPhiSign[ctxL][c.resPhiOldSign], resPhi < 0);
    c.resPhiOldSign = resPhi < 0 ? 1 : 0;
  }

  float estimateResPhi(int32_t resPhi, int predIdx) {
    float bits = 0.f;
    int ctxL = predIdx ? 1 : 0;
    bits += estimate(resPhi != 0, c.resPhiGTZero[0][ctxL]);
    if (!resPhi) return bits;
    int absVal = std::abs(resPhi);
    bits += estimate(--absVal > 0, c.resPhiGTOne[0][ctxL]);
    if (absVal) {
      absVal = absVal - 1;
      bits += std::max(2, (ilog2u(uint32_t(absVal + 2)) << 1));
    }
    bits += estimate(resPhi < 0, c.resPhiSign[ctxL][c.resPhiOldSign]);
    return bits;
  }

  float estimateResR(int32_t resR, int multiplier, int predIdx) {
    float bits = 0.f;
    int ctxL = predIdx ? 1 : 0;
    int ctxLR = ctxL + (std::abs(multiplier) > g.thQphi ? 2 : 0);
    bits += estimate(resR != 0, c.resRGTZero[0][ctxLR]);
    if (!resR) return bits;
    int absVal = std::abs(resR);
    bits += estimate(--absVal > 0, c.resRGTOne[0][ctxLR]);
    if (absVal) bits += estimate(--absVal > 0, c.resRGTTwo[0][ctxLR]);
    if (absVal) {
      absVal--;
      bits += std::max(3, (ilog2u(uint32_t(absVal + 4)) << 1) - 1);
    }
    int ctxR = (c.precAzimuthStepDelta ? 4 : 0) + (multiplier ? 2 : 0)
      + (c.precSignR ? 1 : 0);
    bits += estimate(resR < 0, c.resRSign[c.prevInterFlag ? 1 : 0][ctxL][ctxR]);
    return bits;
  }

  void encodeResidual(const V3& residual, int iMode, int multiplier,
                      int rPred, int predIdx) {
    int k = 0;
    if (g.azimuthScaling) {
      encodeResR(residual[0], multiplier, predIdx);
      int r = (rPred + residual[0]) << 3;
      (void)r;
      encodeResPhi(residual[1], predIdx);
      k = 2;
    }
    for (int ctxIdx = 0; k < 3; k++) {
      if (g.angular && g.numLasers == 1 && k == 2) continue;
      const int32_t res = residual[k];
      ae.bit(&c.resGt0[0][k], res != 0);
      if (!res) continue;
      int32_t value = std::abs(res) - 1;
      int32_t nb = 1 + ilog2u(uint32_t(value));
      uint16_t* ctxs = &c.numBits[0][ctxIdx][k][0] - 1;
      for (int cx = 1, n = g.residBits[k] - 1; n >= 0; n--) {
        int bin = (nb >> n) & 1;
        ae.bit(&ctxs[cx], bin);
        cx = (cx << 1) | bin;
      }
      if (!k && !g.angular) ctxIdx = std::min(4, (nb + 1) >> 1);
      --nb;
      for (int32_t i = 0; i < nb; ++i) ae.bypass((value >> i) & 1);
      if (iMode || k) ae.bit(&c.sign[0][k], res < 0);
    }
  }

  void encodeResidual2(const V3& residual) {
    for (int k = 0; k < 3; k++) {
      const int32_t res = residual[k];
      ae.bit(&c.res2GtN[0][k], res != 0);
      if (!res) continue;
      int value = std::abs(res) - 1;
      ae.bit(&c.res2GtN[1][k], value > 0);
      if (value)
        encodeEgPS(ae, value - 1, 0, c.eg2Pre[k], 5, c.eg2Suf[k], 4);
      ae.bit(&c.sign2[k], res < 0);
    }
  }

  void encodePhiMultiplier(int32_t multiplier, int predIdx) {
    int ctxL = predIdx ? 1 : 0;
    ae.bit(&c.phiGtN[0][ctxL][0], multiplier != 0);
    if (!multiplier) return;
    int32_t value = std::abs(multiplier) - 1;
    ae.bit(&c.phiGtN[0][ctxL][1], value > 0);
    if (!value) {
      ae.bit(&c.signPhi[0][ctxL], multiplier < 0);
      return;
    }
    value--;
    int valueMinus7 = value - 7;
    value = std::min(value, 7);
    ae.bit(&c.residualPhi[0][ctxL][0], (value >> 2) & 1);
    ae.bit(&c.residualPhi[0][ctxL][1 + (value >> 2)], (value >> 1) & 1);
    ae.bit(&c.residualPhi[0][ctxL][3 + (value >> 1)], (value >> 0) & 1);
    if (valueMinus7 >= 0) ae.exp_golomb(valueMinus7, 0, &c.egPhi[0][ctxL]);
    ae.bit(&c.signPhi[0][ctxL], multiplier < 0);
  }

  void encodeEndOfTreesFlag(int end) { ae.bit(&c.endOfTrees, end); }

  // estimateBits (geometry_predictive_encoder.cpp:646-780), intra
  float estimateBits(int iMode, int predIdx, const V3& residual,
                     int multiplier, int rPred, float bestKnownBits) {
    float bits = 0.f;
    if (g.azimuthScaling) {
      for (int i = 0; i < predIdx; ++i) bits += estimate(1, c.predIdx[i]);
      if (predIdx < g.maxPredIdx)
        bits += estimate(0, c.predIdx[predIdx]);
    } else {
      bits += estimate((iMode >> 1) & 1, c.predMode[0]);
      bits += estimate(iMode & 1, c.predMode[1 + (iMode >> 1)]);
    }
    if (bits > bestKnownBits) return bits;

    if (g.angular) {
      int ctxL = predIdx ? 1 : 0;
      bits += estimate(multiplier != 0, c.phiGtN[0][ctxL][0]);
      if (bits > bestKnownBits) return bits;
      if (multiplier) {
        int32_t value = std::abs(multiplier) - 1;
        bits += estimate(value > 0, c.phiGtN[0][ctxL][1]);
        bits += estimate(multiplier < 0, c.signPhi[0][ctxL]);
        if (bits > bestKnownBits) return bits;
        if (value) {
          value--;
          int valueMinus7 = value - 7;
          value = std::min(value, 7);
          bits += estimate((value >> 2) & 1, c.residualPhi[0][ctxL][0]);
          bits += estimate((value >> 1) & 1,
                           c.residualPhi[0][ctxL][1 + (value >> 2)]);
          bits += estimate((value >> 0) & 1,
                           c.residualPhi[0][ctxL][3 + (value >> 1)]);
          if (valueMinus7 >= 0)
            bits += (1 + 2.0 * std::log2(double(valueMinus7 + 1)));
          if (bits > bestKnownBits) return bits;
        }
      }
    }

    int k = 0;
    if (g.azimuthScaling) {
      bits += estimateResR(residual[0], multiplier, predIdx);
      if (bits > bestKnownBits) return bits;
      bits += estimateResPhi(residual[1], predIdx);
      if (bits > bestKnownBits) return bits;
      k = 2;
    }

    for (int ctxIdx = 0; k < 3; k++) {
      if (g.angular && g.numLasers == 1 && k == 2) continue;
      const int32_t res = residual[k];
      bits += estimate(res != 0, c.resGt0[0][k]);
      if (bits > bestKnownBits) return bits;
      if (res == 0) continue;
      if (iMode > 0 || k) {
        bits += estimate(res < 0, c.sign[0][k]);
        if (bits > bestKnownBits) return bits;
      }
      int32_t value = std::abs(res) - 1;
      int32_t nb = 1 + ilog2u(uint32_t(value));
      uint16_t* ctxs = &c.numBits[0][ctxIdx][k][0] - 1;
      for (int cx = 1, n = g.residBits[k] - 1; n >= 0; n--) {
        int bin = (nb >> n) & 1;
        bits += estimate(bin, ctxs[cx]);
        if (bits > bestKnownBits) return bits;
        cx = (cx << 1) | bin;
      }
      if (!k && !g.angular) ctxIdx = std::min(4, (nb + 1) >> 1);
      bits += std::max(0, nb - 1);
      if (bits > bestKnownBits) return bits;
    }
    return bits;
  }

  // encodeTree (geometry_predictive_encoder.cpp:785-1146), intra;
  // srcPts = spherical positions (updated in place to reconstructed),
  // reconPts = cartesian positions, nodes = prediction tree
  struct GNode {
    int numDups = 0;
    int32_t parent = -1;
    int32_t childrenCount = 0;
    int32_t children[3];
  };

  int encodeTree(V3* srcPts, V3* reconPts, const GNode* nodes, int numNodes,
                 int rootIdx) {
    int processedNodes = 0;
    int nodeCount = 0;
    (void)nodeCount;
    stack.push_back(rootIdx);

    const int NPred = g.maxPredIdx + 1;
    const int NTestedPred = g.maxPredIdxTested + 1;
    std::array<std::array<int, 2>, 8> preds = {};

    while (!stack.empty()) {
      const int nodeIdx = stack.back();
      stack.pop_back();
      nodeCount++;

      const GNode& node = nodes[nodeIdx];
      const V3& point = srcPts[nodeIdx];   // reference: tracks updates
      struct {
        float bits = std::numeric_limits<float>::max();
        int mode = 0;
        int predIdx = 0;
        V3 residual{{0, 0, 0}};
        V3 prediction{{0, 0, 0}};
        int qphi = 0;
      } best;

      int qphi = 0;
      int azimuthSpeed = g.azimuthSpeed;
      bool unusable[4] = {false, false, false, false};

      const int iModeBegin = g.azimuthScaling ? 1 : 0;
      const int iModeEnd = g.azimuthScaling ? 2 : 4;
      const int predIdxEnd = g.azimuthScaling ? NTestedPred : 1;
      bool firstCheck = true;

      for (int iMode = iModeBegin; iMode < iModeEnd; iMode++) {
        for (int predIdx = 0; predIdx < predIdxEnd; ++predIdx) {
          // makePredicter walk + validity
          int32_t index[3] = {-1, -1, -1};
          {
            int m = iMode == 0 ? 1 : iMode;
            int walk = nodeIdx;
            for (int i = 0; i < m; i++) {
              if (walk < 0) break;
              index[i] = walk = nodes[walk].parent;
            }
          }
          if (!g.azimuthScaling) {
            bool valid = true;
            for (int i = 0; i < iMode; i++)
              if (index[i] < 0) valid = false;
            if (!valid) continue;
          }

          V3 pred{{0, 0, 0}};
          switch (iMode) {
          case 0:
            pred = {{0, 0, 0}};
            if (g.angular) pred[0] = g.minRadius;
            if (index[0] >= 0 && g.angular) {
              pred[1] = srcPts[index[0]][1];
              pred[2] = srcPts[index[0]][2];
            }
            break;
          case 1:
            pred = {{0, 0, 0}};
            pred[0] = g.minRadius;
            if (index[0] >= 0) pred = srcPts[index[0]];
            break;
          case 2: {
            const V3& p0 = srcPts[index[0]];
            const V3& p1 = srcPts[index[1]];
            pred = {{2 * p0[0] - p1[0], 2 * p0[1] - p1[1],
                     2 * p0[2] - p1[2]}};
            break;
          }
          default: {
            const V3& p0 = srcPts[index[0]];
            const V3& p1 = srcPts[index[1]];
            const V3& p2 = srcPts[index[2]];
            pred = {{p0[0] + p1[0] - p2[0], p0[1] + p1[1] - p2[1],
                     p0[2] + p1[2] - p2[2]}};
            break;
          }
          }

          if (g.azimuthScaling && predIdx > 0) {
            pred[0] = preds[predIdx][0];
            int deltaPhi = pred[1] - preds[predIdx][1];
            pred[1] = preds[predIdx][1];
            if (deltaPhi >= g.azimuthSpeed || deltaPhi <= -g.azimuthSpeed) {
              int qphi0 =
                int(divApprox(int64_t(deltaPhi), g.azimuthSpeed, 0));
              pred[1] += qphi0 * g.azimuthSpeed;
            }
          }

          V3 residual = vsub(point, pred);
          // angular only in this encoder scope
          while (residual[1] < -(1 << (g.twoPiLog2 - 1)))
            residual[1] += 1 << g.twoPiLog2;
          while (residual[1] >= 1 << (g.twoPiLog2 - 1))
            residual[1] -= 1 << g.twoPiLog2;

          if (g.azimuthScaling) {
            int32_t r = (pred[0] + residual[0]) << 3;
            azimuthSpeed = g.azimuthSpeed;
            qphi = 0;
            int64_t speedTimesR = int64_t(azimuthSpeed) * r;
            int phiBound =
              int(divExp2RoundHalfInf(speedTimesR, g.twoPiLog2 + 1));
            if (r) {
              if (!phiBound) {
                const int32_t pi = 1 << (g.twoPiLog2 - 1);
                int32_t speedTimesR32 = int32_t(speedTimesR);
                while (speedTimesR32 < pi) {
                  speedTimesR32 <<= 1;
                  azimuthSpeed <<= 1;
                }
              }
              qphi = residual[1] >= 0
                ? (residual[1] + (azimuthSpeed >> 1)) / azimuthSpeed
                : -(-residual[1] + (azimuthSpeed >> 1)) / azimuthSpeed;
              pred[1] += qphi * azimuthSpeed;
              residual[1] = point[1] - pred[1];
              while (residual[1] < -(1 << (g.twoPiLog2 - 1)))
                residual[1] += 1 << g.twoPiLog2;
              while (residual[1] >= 1 << (g.twoPiLog2 - 1))
                residual[1] -= 1 << g.twoPiLog2;
            }
            int64_t arc = int64_t(residual[1]) * r;
            residual[1] =
              int32_t(divExp2RoundHalfInf(arc, g.twoPiLog2));
            if (residual[1] < -phiBound) residual[1] = -phiBound;
            if (residual[1] > phiBound) residual[1] = phiBound;
          } else {
            qphi = residual[1] >= 0
              ? (residual[1] + (g.azimuthSpeed >> 1)) / g.azimuthSpeed
              : -(-residual[1] + (g.azimuthSpeed >> 1)) / g.azimuthSpeed;
            pred[1] += qphi * g.azimuthSpeed;
            residual[1] = point[1] - pred[1];
          }

          for (int k = 0; k < 3; k++) {
            if (residual[k])
              if ((std::abs(residual[k]) - 1) >> maxAbsResidualMinus1Log2[k])
                unusable[iMode] = true;
          }
          if (unusable[iMode]) {
            if (iMode == 3 && unusable[0] && unusable[1] && unusable[2]
                && unusable[3])
              return -1;
            if (iMode > 0) continue;
          }

          float bits = estimateBits(iMode, predIdx, residual, qphi,
                                    pred[0], best.bits);
          if (unusable[iMode]) bits = std::numeric_limits<float>::max();

          if (firstCheck || bits < best.bits) {
            best.prediction = pred;
            best.predIdx = predIdx;
            best.residual = residual;
            best.mode = iMode;
            best.bits = bits;
            best.qphi = qphi;
            firstCheck = false;
          }
        }
      }

      if (!g.uniquePoints) encodeNumDuplicatePoints(node.numDups);
      encodeNumChildren(node.childrenCount);
      if (g.azimuthScaling)
        encodePredIdx(best.predIdx);
      else
        encodePredMode(best.mode);

      encodePhiMultiplier(best.qphi, best.predIdx);

      encodeResidual(best.residual, best.mode, best.qphi,
                     best.prediction[0], best.predIdx);

      // convert spherical prediction to cartesian, code residual2
      {
        if (g.azimuthScaling) {
          int32_t r = (best.prediction[0] + best.residual[0]) << 3;
          if (!r) r = 1;
          int32_t rInvScaleLog2;
          int64_t rInv = recipApprox(r, rInvScaleLog2);
          best.residual[1] = int32_t(divExp2(
            int64_t(best.residual[1]) * rInv,
            rInvScaleLog2 - g.twoPiLog2));

          srcPts[nodeIdx] = vadd(best.prediction, best.residual);
          if (srcPts[nodeIdx][1] < -(1 << (g.twoPiLog2 - 1)))
            srcPts[nodeIdx][1] += 1 << g.twoPiLog2;
          if (srcPts[nodeIdx][1] >= 1 << (g.twoPiLog2 - 1))
            srcPts[nodeIdx][1] -= 1 << g.twoPiLog2;
          for (int i = 1; i <= node.numDups; i++)
            srcPts[nodeIdx + i] = srcPts[nodeIdx];

          bool flagNewObject = std::abs(best.residual[0]) > g.thObj;
          int predIdx = flagNewObject ? NPred - 1 : best.predIdx;
          for (int i = predIdx; i > 0; i--) preds[i] = preds[i - 1];
          preds[0][0] = srcPts[nodeIdx][0];
          preds[0][1] = srcPts[nodeIdx][1];
        }

        best.prediction = vadd(g.origin, s2c(point));
        best.residual = vsub(reconPts[nodeIdx], best.prediction);
        if (!g.residual2Disabled)
          encodeResidual2(best.residual);
        else
          best.residual = {{0, 0, 0}};
      }

      reconPts[nodeIdx] = vadd(best.prediction, best.residual);
      for (int k = 0; k < 3; k++)
        reconPts[nodeIdx][k] = std::max(0, reconPts[nodeIdx][k]);

      processedNodes++;
      processedNodes += node.numDups;
      for (int i = 1; i <= node.numDups; i++)
        srcPts[nodeIdx + i] = srcPts[nodeIdx];

      for (int i = 0; i < node.childrenCount; i++)
        stack.push_back(node.children[i]);
    }
    return processedNodes;
  }
};

// generateGeomPredictionTreeAngular (geometry_predictive_encoder.cpp:
// 1286-1397), enablePartition = false: per-laser chains + the
// cross-laser root chain; fills beginSph with the spherical positions
static void buildAngularTree(const V3* begin, int pointCount,
                             const CartToSph& c2s, const V3& origin,
                             V3* beginSph,
                             std::vector<Encoder::GNode>& nodes) {
  int numLasers = c2s.numLasers;
  nodes.assign(pointCount, Encoder::GNode());
  std::vector<int32_t> prevNodes(numLasers, -1);
  std::vector<int32_t> firstNodes(numLasers, -1);

  for (int nodeIdx = 0, nodeIdxN; nodeIdx < pointCount;
       nodeIdx = nodeIdxN) {
    V3 curPoint = begin[nodeIdx];
    Encoder::GNode& node = nodes[nodeIdx];
    node.childrenCount = 0;
    node.numDups = 0;
    for (nodeIdxN = nodeIdx + 1; nodeIdxN < pointCount; nodeIdxN++) {
      if (curPoint != begin[nodeIdxN]) break;
      node.numDups++;
    }
    V3 carPos = vsub(curPoint, origin);
    V3 sphPos = c2s(carPos);
    beginSph[nodeIdx] = sphPos;
    int thetaIdx = sphPos[2];
    for (int i = nodeIdx + 1; i < nodeIdxN; i++) beginSph[i] = sphPos;

    node.parent = prevNodes[thetaIdx];
    if (node.parent != -1) {
      Encoder::GNode& pnode = nodes[prevNodes[thetaIdx]];
      pnode.children[pnode.childrenCount++] = nodeIdx;
    } else
      firstNodes[thetaIdx] = nodeIdx;
    prevNodes[thetaIdx] = nodeIdx;
  }

  int n0 = 0;
  while (firstNodes[n0] == -1) ++n0;
  for (int n = n0 + 1, parentIdx = firstNodes[n0]; n < numLasers; ++n) {
    int nodeIdx = firstNodes[n];
    if (nodeIdx < 0) continue;
    Encoder::GNode& pnode = nodes[parentIdx];
    if (pnode.childrenCount < 3) {
      nodes[nodeIdx].parent = parentIdx;
      pnode.children[pnode.childrenCount++] = nodeIdx;
    }
    parentIdx = nodeIdx;
  }
}

}  // namespace refpg

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

extern "C" {

// Decode one predictive-geometry AEC payload.  Returns the number of
// points written to out (slice-local stv, decode order), or negative
// on error.  out must hold numPoints * 3 int32.
static int decode_predgeom_impl(const uint8_t* buf, int len,
                                const int32_t* params,
                                const int32_t* theta,
                                const int32_t* zlaser, int numPoints,
                                int32_t* out, int32_t* out_sph,
                                refpg::RefSph* ref) {
  using namespace refpg;
  Decoder d;
  d.g = PGParams::from(params);
  d.ad.chunked = d.g.chunked != 0;
  d.ad.init(buf, size_t(len));
  d.ad.bypassNoUpdate = d.g.bypassNoUpdate != 0;
  d.s2c = SphToCart{d.g.rInvLog2, d.g.twoPiLog2, theta, zlaser};
  d.refSph = ref;
  d.parentOf.assign(numPoints, -1);
  d.stack.reserve(1024);

  std::vector<V3> a(numPoints), b(numPoints);
  V3* reconA = d.g.angular ? a.data() : reinterpret_cast<V3*>(out);
  V3* reconB = d.g.angular ? b.data() : a.data();  // unused non-angular

  int pointCount = 0;
  do {
    if (pointCount >= numPoints && numPoints > 0) return -2;
    int n = d.decodeTree(reconA + pointCount, reconB + pointCount,
                         numPoints - pointCount);
    if (n < 0) return -4;
    pointCount += n;
    if (pointCount > numPoints) return -3;
  } while (!d.decodeEndOfTreesFlag());

  if (d.g.angular)
    std::memcpy(out, b.data(), size_t(pointCount) * sizeof(V3));
  if (out_sph && d.g.angular)
    std::memcpy(out_sph, a.data(), size_t(pointCount) * sizeof(V3));
  return pointCount;
}

int tmc13ref_decode_predgeom(const uint8_t* buf, int len,
                             const int32_t* params, const int32_t* theta,
                             const int32_t* zlaser, int numPoints,
                             int32_t* out) {
  return decode_predgeom_impl(buf, len, params, theta, zlaser, numPoints,
                              out, nullptr, nullptr);
}

// ---------------------------------------------------------------------------
// inter prediction reference handle (PredGeomPredictor lifecycle,
// decoder.cpp:603-645 + :719-752)
// ---------------------------------------------------------------------------

void* tmc13ref_pgref_create(int azimScaleLog2, int numLasers,
                            int globalMotionEnabled, int resampling) {
  auto* r = new refpg::RefSph();
  r->init(azimScaleLog2, numLasers, globalMotionEnabled != 0,
          resampling != 0);
  return r;
}

void tmc13ref_pgref_free(void* h) {
  delete static_cast<refpg::RefSph*>(h);
}

// gbh.interFrameRefGmcFlag + gm fields (matrix already 65536-scaled)
void tmc13ref_pgref_set_motion(void* h, int movingState, int thresh0,
                               int thresh1, const int32_t* matrix9,
                               const int32_t* trans3) {
  auto* r = static_cast<refpg::RefSph*>(h);
  r->movingState = movingState != 0;
  r->thresh0 = thresh0;
  r->thresh1 = thresh1;
  for (int i = 0; i < 9; i++) r->gmMatrix[i] = matrix9[i];
  for (int i = 0; i < 3; i++) r->gmTrans[i] = trans3[i];
}

// first slice of each frame after the first (decoder.cpp:633/645)
void tmc13ref_pgref_update_frame(void* h, int rInvLog2, int twoPiLog2,
                                 int numLasers, const int32_t* theta,
                                 const int32_t* zlaser) {
  using namespace refpg;
  auto* r = static_cast<RefSph*>(h);
  SphToCart s2c{rInvLog2, twoPiLog2, theta, zlaser};
  CartToSphSimple c2s{s2c, rInvLog2, twoPiLog2, numLasers, theta, zlaser};
  r->updateFrame(s2c, c2s);
}

// per-brick: gbh.interPredictionEnabledFlag (decoder.cpp:719-723)
void tmc13ref_pgref_set_inter(void* h, int interEnabled) {
  auto* r = static_cast<refpg::RefSph*>(h);
  r->interEnabled = interEnabled != 0;
  if (!r->interEnabled) r->clearRefFrame();
}

// after each brick decode: current slice's spherical positions
// (decoder.cpp:750-752)
void tmc13ref_pgref_insert(void* h, const int32_t* pos_sph, int n) {
  static_cast<refpg::RefSph*>(h)->insert(
    reinterpret_cast<const refpg::V3*>(pos_sph), n);
}

// inter-capable decode: also returns the reconstructed spherical
// positions (for the ref chain and spherical attribute coding)
int tmc13ref_decode_predgeom_inter(const uint8_t* buf, int len,
                                   const int32_t* params,
                                   const int32_t* theta,
                                   const int32_t* zlaser, int numPoints,
                                   int32_t* out, int32_t* out_sph,
                                   void* ref) {
  return decode_predgeom_impl(buf, len, params, theta, zlaser, numPoints,
                              out, out_sph,
                              static_cast<refpg::RefSph*>(ref));
}

// Encode a predictive-geometry AEC payload for the angular tool set,
// byte-identical to the reference encoder.  pts: slice-local stv
// int32 positions (input order; the encoder Morton-sorts internally).
// params fields residBits / minRadius are outputs (for the GBH).
// Returns payload length, or negative on error.
int tmc13ref_encode_predgeom(const int32_t* pts, int n, int32_t* params,
                             const int32_t* theta, const int32_t* zlaser,
                             uint8_t* out, int cap) {
  using namespace refpg;
  Encoder e;
  e.g = PGParams::from(params);
  if (!e.g.angular) return -10;  // scope: angular encode only
  e.ae.chunked = e.g.chunked != 0;
  e.ae.init();
  e.ae.bypassNoUpdate = e.g.bypassNoUpdate != 0;
  e.s2c = SphToCart{e.g.rInvLog2, e.g.twoPiLog2, theta, zlaser};
  e.stack.reserve(1024);

  std::vector<V3> cloud(n);
  std::memcpy(cloud.data(), pts, size_t(n) * sizeof(V3));

  // residual-bit derivation (encodePredictiveGeometry,
  // geometry_predictive_encoder.cpp:1494-1522)
  {
    int maxX = (1 << e.g.rootLog2[0]) - 1;
    int maxY = (1 << e.g.rootLog2[1]) - 1;
    int maxAbsDx = std::max(std::abs(e.g.origin[0]),
                            std::abs(maxX - e.g.origin[0]));
    int maxAbsDy = std::max(std::abs(e.g.origin[1]),
                            std::abs(maxY - e.g.origin[1]));
    int64_t r = int64_t(std::round(
      std::hypot(double(maxAbsDx), double(maxAbsDy))));
    int residualBits[3];
    residualBits[0] =
      ceillog2u(uint32_t(divExp2RoundHalfUp(r, e.g.rInvLog2)));
    residualBits[2] = ceillog2u(uint32_t(e.g.numLasers - 1));
    if (!e.g.azimuthScaling)
      residualBits[1] = ceillog2u(uint32_t(e.g.azimuthSpeed >> 1));
    else {
      int maxError = (e.g.azimuthSpeed >> 1) + 1;
      residualBits[1] = ceillog2u(uint32_t(divExp2RoundHalfInf(
        int64_t(maxError) * divExp2RoundHalfUp(r << 3, e.g.rInvLog2),
        e.g.twoPiLog2)));
    }
    for (int k = 0; k < 3; k++)
      e.g.residBits[k] = ilog2u(uint32_t(residualBits[k])) + 1;
  }
  e.g.minRadius = 0;
  e.init();

  CartToSph c2s{e.s2c, e.g.rInvLog2, 1 << e.g.twoPiLog2,
                e.g.numLasers, theta, zlaser};

  int maxPtsPerTree = std::min(e.g.maxPtsPerTree, n);
  std::vector<V3> sphericalPos(n);

  for (int i = 0; i < n;) {
    int iEnd = std::min(i + maxPtsPerTree, n);

    // mortonSort (geometry_predictive_encoder.cpp:1401-1413): the
    // recursive radix sort realises a total Morton order; equal keys
    // are identical points, so a plain key sort is output-identical
    {
      int depth = std::max(
        {e.g.rootLog2[0], e.g.rootLog2[1], e.g.rootLog2[2]});
      std::vector<std::pair<uint64_t, V3>> keyed(iEnd - i);
      for (int j = i; j < iEnd; j++) {
        uint64_t key = 0;
        for (int d = depth - 1; d >= 0; d--) {
          key = (key << 3)
            | uint64_t(((cloud[j][0] >> d) & 1) << 2
                       | ((cloud[j][1] >> d) & 1) << 1
                       | ((cloud[j][2] >> d) & 1));
        }
        keyed[j - i] = {key, cloud[j]};
      }
      std::sort(keyed.begin(), keyed.end(),
                [](const std::pair<uint64_t, V3>& x,
                   const std::pair<uint64_t, V3>& y) {
                  return x.first < y.first;
                });
      for (int j = i; j < iEnd; j++) cloud[j] = keyed[j - i].second;
    }

    std::vector<Encoder::GNode> nodes;
    buildAngularTree(&cloud[i], iEnd - i, c2s, e.g.origin,
                     sphericalPos.data() + i, nodes);

    if (n <= maxPtsPerTree) {
      int mn = sphericalPos[0][0];
      for (int j = 1; j < iEnd; j++)
        mn = std::min(mn, sphericalPos[j][0]);
      e.g.minRadius = mn;
      params[17] = mn;
    }

    if (i > 0) e.encodeEndOfTreesFlag(0);

    // encode() root loop (geometry_predictive_encoder.cpp:1151-1181)
    int processedNodes = 0;
    int numNodes = iEnd - i;
    for (int rootIdx = 0; rootIdx < numNodes; rootIdx++) {
      if (nodes[rootIdx].parent >= 0) continue;
      int m = e.encodeTree(sphericalPos.data() + i, &cloud[i],
                           nodes.data(), numNodes, rootIdx);
      if (m < 0) return -11;
      processedNodes += m;
      if (processedNodes != numNodes) e.encodeEndOfTreesFlag(0);
    }
    if (processedNodes != numNodes) return -12;
    i = iEnd;
  }
  e.encodeEndOfTreesFlag(1);
  e.ae.flush();

  for (int k = 0; k < 3; k++) params[14 + k] = e.g.residBits[k];
  if (int(e.ae.out.size()) > cap) return -13;
  std::memcpy(out, e.ae.out.data(), e.ae.out.size());
  return int(e.ae.out.size());
}

}  // extern "C"
