// Predicting / lifting attribute transforms: conformance interop port.
//
// Like refcodec.cc and refattr.cc, this file intentionally reproduces,
// operation for operation, the NORMATIVE semantics of the reference
// predlift attribute path so that tmc3 bitstreams decode bit-exactly
// and our emissions are byte-identical:
//   - LoD generation (buildPredictorsFast,
//     tmc3/PCCTMC3Common.h:2300-2475): Morton sort,
//     distance/decimation/centroid subsampling, the bucketed
//     three-level bounding-box nearest-neighbour search with its
//     exact traversal order (ties resolve by visit order), the
//     distribution-aware third-neighbour replacement
//     (PCCTMC3Common.h:1833-1906), fixed-point weight normalisation
//     (PCCPredictor::computeWeights :590-635) and optional blending.
//   - Predicting transform decode (AttributeDecoder.cpp:328-527):
//     zero-run + symbol residuals, direct-mode parity signalling,
//     weighted prediction, per-point quant weights.
//   - Lifting transform decode (AttributeDecoder.cpp:679-861):
//     quant-weight derivation, inverse update/predict sweeps,
//     last-component prediction.
// The TPU-first predlift engine lives in models/attr_predlift.py +
// ops/lod.py; this port exists to exchange bitstreams with tmc3.
// Scope: intra only (no attr inter prediction), non-scalable LoD.

#include <algorithm>
#include <array>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <vector>

#include "obuf_core.h"

extern "C" uint64_t tmc13ref_irsqrt(uint64_t x);  // refattr.cc

namespace refpl {

using obufcore::ArithDec;
using obufcore::ArithEnc;

static const int kFixedPointWeightShift = 8;      // constants.h:46
static const int kFixedPointAttributeShift = 8;   // constants.h:47

// ---------------------------------------------------------------------------
// math helpers (PCCMath.h, PCCMisc.h, misc.cpp)
// ---------------------------------------------------------------------------

struct V3 {
  int32_t d[3];
  int32_t& operator[](int k) { return d[k]; }
  int32_t operator[](int k) const { return d[k]; }
};

static inline V3 sub(const V3& a, const V3& b) {
  return {{a.d[0] - b.d[0], a.d[1] - b.d[1], a.d[2] - b.d[2]}};
}

static inline int64_t norm1(const V3& a) {
  return int64_t(std::abs(a.d[0])) + std::abs(a.d[1]) + std::abs(a.d[2]);
}

static inline int64_t norm2(const V3& a) {
  return int64_t(a.d[0]) * a.d[0] + int64_t(a.d[1]) * a.d[1]
    + int64_t(a.d[2]) * a.d[2];
}

// Vec3::getDir (PCCMath.h:105-109)
static inline int getDir(const V3& a) {
  return ((a.d[0] >= 0 ? 1 : 0) << 2) + ((a.d[1] >= 0 ? 1 : 0) << 1)
    + (a.d[2] >= 0 ? 1 : 0);
}

static inline int ilog2_u64(uint64_t x) {
  int r = -1;
  while (x) { r++; x >>= 1; }
  return r;
}

static inline int64_t divExp2RoundHalfUp(int64_t x, int shift) {
  if (!shift) return x;
  return (x + (1ll << (shift - 1))) >> shift;
}

static inline int64_t divExp2RoundHalfInf(int64_t x, int shift) {
  if (!shift) return x;
  int64_t s0 = 1ll << (shift - 1);
  return x >= 0 ? (s0 + x) >> shift : -((s0 - x) >> shift);
}

static inline uint64_t divExp2RoundHalfInfU(uint64_t x, int shift) {
  if (!shift) return x;
  return ((1ull << (shift - 1)) + x) >> shift;
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
  const int n = std::max(0, ilog2_u64(b) + 1 - lutSizeLog2);
  const uint64_t index = (b + ((1ull << n) >> 1)) >> n;
  log2InvScale = n + (lutSizeLog2 << 1);
  return kDivApproxDivisor[index - 1] + 1;
}

static inline int64_t divApprox(int64_t a, uint64_t b, int32_t log2Scale) {
  int32_t log2InvScale;
  const int64_t invB = divInvDivisorApprox(b, log2InvScale);
  return (invB * a) >> (log2InvScale - log2Scale);
}

// mortonAddr (PCCMath.h:605-626): x at bit 3k+2, y at 3k+1, z at 3k
static inline int64_t mortonAddr(const V3& p) {
  // PCCMath.h:606-620: three byte-table levels interleaving bits
  // 0..23 of each axis' two's complement — for NEGATIVE coordinates
  // (spherical azimuth under inter prediction keeps minPos = 0) the
  // sign bits land in the upper fields and the int64 accumulate
  // wraps; both behaviours are normatively visible via the sort
  uint64_t a = 0;
  for (int lvl = 2; lvl >= 0; lvl--) {
    const uint32_t xb = uint32_t(p.d[0] >> (8 * lvl)) & 0xFF;
    const uint32_t yb = uint32_t(p.d[1] >> (8 * lvl)) & 0xFF;
    const uint32_t zb = uint32_t(p.d[2] >> (8 * lvl)) & 0xFF;
    uint64_t m = 0;
    for (int b = 0; b < 8; b++) {
      m |= uint64_t((xb >> b) & 1) << (3 * b + 2);
      m |= uint64_t((yb >> b) & 1) << (3 * b + 1);
      m |= uint64_t((zb >> b) & 1) << (3 * b);
    }
    a = (a << 24) | m;
  }
  return int64_t(a);
}

// morton3dAdd (PCCMisc.h:244-256)
static inline uint64_t morton3dAdd(uint64_t a, uint64_t b) {
  uint64_t mask = 0x9249249249249249llu;
  uint64_t val = 0;
  for (int i = 0; i < 3; i++) {
    val |= ((a | ~mask) + (b & mask)) & mask;
    mask <<= 1;
  }
  return val;
}

// Box3<int32> with L1 distance (PCCMath.h:444-510)
struct Box3 {
  V3 mn, mx;
  void reset() {
    mn = {{INT32_MAX, INT32_MAX, INT32_MAX}};
    mx = {{INT32_MIN, INT32_MIN, INT32_MIN}};
  }
  void insert(const V3& p) {
    for (int k = 0; k < 3; k++) {
      mn.d[k] = std::min(mn.d[k], p.d[k]);
      mx.d[k] = std::max(mx.d[k], p.d[k]);
    }
  }
  void merge(const Box3& o) {
    for (int k = 0; k < 3; k++) {
      mn.d[k] = std::min(mn.d[k], o.mn.d[k]);
      mx.d[k] = std::max(mx.d[k], o.mx.d[k]);
    }
  }
  int64_t getDist1(const V3& p) const {
    int64_t dx = std::max(std::max(mn.d[0] - p.d[0], 0), p.d[0] - mx.d[0]);
    int64_t dy = std::max(std::max(mn.d[1] - p.d[1], 0), p.d[1] - mx.d[1]);
    int64_t dz = std::max(std::max(mn.d[2] - p.d[2], 0), p.d[2] - mx.d[2]);
    return dx + dy + dz;
  }
};

// BoxHierarchy<5,3> (PCCTMC3Common.h:59-108)
struct BoxHierarchy {
  static const int kBucketLog2 = 5;
  static const int kLevels = 3;
  std::vector<Box3> bb[kLevels];
  void resize(int32_t pointCount) {
    int32_t count = pointCount;
    for (int i = 0; i < kLevels; i++) {
      count = (count + ((1 << kBucketLog2) - 1)) >> kBucketLog2;
      bb[i].clear();
      Box3 e;
      e.reset();
      bb[i].assign(size_t(count), e);
    }
  }
  void insert(const V3& p, int32_t index) {
    bb[0][size_t(index >> kBucketLog2)].insert(p);
  }
  void update() {
    for (int i = 0; i < kLevels - 1; i++)
      for (int32_t j = 0; j < int32_t(bb[i].size()); j++)
        bb[i + 1][size_t(j >> kBucketLog2)].merge(bb[i][size_t(j)]);
  }
  const Box3& box(int32_t bindex, int32_t level) const {
    return bb[level][size_t(bindex)];
  }
  int32_t bucketSizeLog2(int32_t level) const {
    return kBucketLog2 * (1 + level);
  }
};

// MortonIndexMap3d (PCCTMC3Common.h:111-175)
struct MortonIndexMap3d {
  struct Range { int32_t start, end; };
  int32_t cubeSizeLog2_ = 0;
  int64_t mask_ = 0;
  std::vector<Range> buffer_;
  std::vector<int32_t> updates_;
  void resize(int32_t cubeSizeLog2) {
    cubeSizeLog2_ = cubeSizeLog2;
    buffer_.assign(size_t(1) << (3 * cubeSizeLog2), {-1, -1});
    mask_ = int64_t(buffer_.size()) - 1;
  }
  int cubeSizeLog2() const { return cubeSizeLog2_; }
  void init() {
    for (auto& u : buffer_) u = {-1, -1};
    updates_.clear();
  }
  void clearUpdates() {
    for (const auto index : updates_) buffer_[size_t(index)] = {-1, -1};
    updates_.clear();
  }
  void set(int64_t mortonCode, int32_t index) {
    const int64_t addr = mortonCode & mask_;
    auto& unit = buffer_[size_t(addr)];
    if (unit.start == -1) unit.start = index;
    unit.end = index + 1;
    updates_.push_back(int32_t(addr));
  }
  Range get(int64_t mortonCode) const {
    return buffer_[size_t(mortonCode & mask_)];
  }
};

struct PackedVoxel {
  int64_t mortonCode;
  V3 position;
  int32_t index;
  bool operator<(const PackedVoxel& rhs) const {
    if (mortonCode == rhs.mortonCode) return index < rhs.index;
    return mortonCode < rhs.mortonCode;
  }
};

struct NeighInfo {
  uint64_t weight = 0;
  uint32_t predictorIndex = 0;
  uint32_t pointIndex = 0;
  bool interFrameRef = false;  // neighbour lives in the reference frame
};

struct Predictor {
  uint32_t neighborCount = 0;
  NeighInfo neighbors[3];
  int8_t predMode = 0;

  // PCCPredictor::computeWeights (PCCTMC3Common.h:590-635)
  void computeWeights() {
    const uint32_t shift = 1u << kFixedPointWeightShift;
    int32_t n = 0;
    while ((neighbors[0].weight >> n) >= shift) ++n;
    if (n > 0)
      for (uint32_t i = 0; i < neighborCount; ++i)
        neighbors[i].weight = (neighbors[i].weight + (1ull << (n - 1))) >> n;
    while (neighborCount > 1) {
      if (neighbors[neighborCount - 1].weight
          >= (neighbors[0].weight << kFixedPointWeightShift))
        --neighborCount;
      else
        break;
    }
    if (neighborCount <= 1) {
      neighbors[0].weight = shift;
    } else if (neighborCount == 2) {
      const uint64_t d0 = neighbors[0].weight;
      const uint64_t d1 = neighbors[1].weight;
      const uint64_t sum = d1 + d0;
      const uint64_t w1 = uint64_t(
        divApprox(int64_t(d0), sum, kFixedPointWeightShift));
      neighbors[0].weight = uint32_t(shift - w1);
      neighbors[1].weight = uint32_t(w1);
    } else {
      neighborCount = 3;
      const uint64_t d0 = neighbors[0].weight;
      const uint64_t d1 = neighbors[1].weight;
      const uint64_t d2 = neighbors[2].weight;
      const uint64_t sum = d1 * d2 + d0 * d2 + d0 * d1;
      const uint64_t w2 = uint64_t(
        divApprox(int64_t(d0 * d1), sum, kFixedPointWeightShift));
      const uint64_t w1 = uint64_t(
        divApprox(int64_t(d0 * d2), sum, kFixedPointWeightShift));
      neighbors[0].weight = uint32_t(shift - (w1 + w2));
      neighbors[1].weight = uint32_t(w1);
      neighbors[2].weight = uint32_t(w2);
    }
  }

  // PCCPredictor::blendWeights (PCCTMC3Common.h:639-695); with inter
  // prediction the neighbour positions resolve by pointIndex against
  // the current or reference cloud
  void blendWeights(const std::vector<V3>& positions,
                    const std::vector<uint32_t>& indexes,
                    bool interRef = false,
                    const std::vector<V3>* positionsRef = nullptr) {
    if (neighborCount != 3) return;
    int w0 = int(neighbors[0].weight);
    int w1 = int(neighbors[1].weight);
    int w2 = int(neighbors[2].weight);
    const V3* np[3];
    for (int i = 0; i < 3; i++)
      np[i] = interRef
        ? (neighbors[i].interFrameRef
             ? &(*positionsRef)[neighbors[i].pointIndex]
             : &positions[neighbors[i].pointIndex])
        : &positions[indexes[neighbors[i].predictorIndex]];
    const V3& n0 = *np[0];
    const V3& n1 = *np[1];
    const V3& n2 = *np[2];
    const int d = 10, bb = 1, cc = 5;
    int64_t dist01 = norm2(sub(n0, n1));
    int64_t dist02 = norm2(sub(n0, n2));
    int64_t dist12 = norm2(sub(n1, n2));
    int b1 = dist01 <= dist02 ? bb : cc;
    int b2 = dist01 <= dist12 ? cc : bb;
    int b3 = dist02 <= dist12 ? bb : cc;
    int nw0 = (w0 * d + w1 * (16 - d - b2) + w2 * b3) >> 4;
    int nw1 = (w0 * b1 + w1 * d + w2 * (16 - d - b3)) >> 4;
    int nw2 = 256 - nw0 - nw1;
    neighbors[0].weight = uint32_t(nw0);
    neighbors[1].weight = uint32_t(nw1);
    neighbors[2].weight = uint32_t(nw2);
  }

  void init() {
    neighborCount = 0;
    std::memset(neighbors, 0, sizeof(neighbors));
    predMode = 0;
  }
};

// ---------------------------------------------------------------------------
// nearest-neighbour accumulators (PCCTMC3Common.h:944-1146, intra
// forms: interRef always false here)
// ---------------------------------------------------------------------------

struct NNState {
  int32_t localIndexes[6];
  int64_t minDistances[6];
  int32_t index2;
  bool interRef;       // inter machinery active (localRef tracked)
  bool localRef[6];    // candidate came from the reference frame
  void init() {
    for (int k = 0; k < 6; k++) {
      localIndexes[k] = -1;
      minDistances[k] = std::numeric_limits<int64_t>::max();
      localRef[k] = false;
    }
    index2 = 3;
    interRef = false;
  }
};

// updateNearestNeighByDistanceAndDistribution (:944-1024)
static void updateNNDist(const V3& p0, const V3& p1, int32_t index,
                         NNState& st, bool predRef = false) {
  auto& localIndexes = st.localIndexes;
  auto& minDistances = st.minDistances;
  auto& localRef = st.localRef;
  const bool interRef = st.interRef;
  int64_t d = norm1(sub(p0, p1));
  if (d > minDistances[2]) {
    // nothing
  } else if (d < minDistances[0]) {
    if (localIndexes[2] != -1) {
      localIndexes[st.index2] = localIndexes[2];
      if (interRef) localRef[st.index2] = localRef[2];
      ++st.index2;
    }
    minDistances[2] = minDistances[1];
    minDistances[1] = minDistances[0];
    minDistances[0] = d;
    localIndexes[2] = localIndexes[1];
    localIndexes[1] = localIndexes[0];
    localIndexes[0] = index;
    if (interRef) {
      localRef[2] = localRef[1];
      localRef[1] = localRef[0];
      localRef[0] = predRef;
    }
  } else if (d < minDistances[1]) {
    if (localIndexes[2] != -1) {
      localIndexes[st.index2] = localIndexes[2];
      if (interRef) localRef[st.index2] = localRef[2];
      ++st.index2;
    }
    minDistances[2] = minDistances[1];
    minDistances[1] = d;
    localIndexes[2] = localIndexes[1];
    localIndexes[1] = index;
    if (interRef) {
      localRef[2] = localRef[1];
      localRef[1] = predRef;
    }
  } else if (d < minDistances[2]) {
    if (localIndexes[2] != -1) {
      localIndexes[st.index2] = localIndexes[2];
      if (interRef) localRef[st.index2] = localRef[2];
      ++st.index2;
    }
    minDistances[2] = d;
    localIndexes[2] = index;
    if (interRef) localRef[2] = predRef;
  } else if (localIndexes[5] == -1) {
    localIndexes[st.index2] = index;
    if (interRef) localRef[st.index2] = predRef;
    ++st.index2;
  }
  if (st.index2 == 6) st.index2 = 3;
}

// updateNearestNeigh (:1026-1077)
static void updateNN(const V3& p0, const V3& p1, int32_t index, NNState& st,
                     bool predRef = false) {
  auto& localIndexes = st.localIndexes;
  auto& minDistances = st.minDistances;
  auto& localRef = st.localRef;
  const bool interRef = st.interRef;
  int64_t d = norm1(sub(p0, p1));
  if (d >= minDistances[2]) {
    // nothing
  } else if (d < minDistances[0]) {
    minDistances[2] = minDistances[1];
    minDistances[1] = minDistances[0];
    minDistances[0] = d;
    localIndexes[2] = localIndexes[1];
    localIndexes[1] = localIndexes[0];
    localIndexes[0] = index;
    if (interRef) {
      localRef[2] = localRef[1];
      localRef[1] = localRef[0];
      localRef[0] = predRef;
    }
  } else if (d < minDistances[1]) {
    minDistances[2] = minDistances[1];
    minDistances[1] = d;
    localIndexes[2] = localIndexes[1];
    localIndexes[1] = index;
    if (interRef) {
      localRef[2] = localRef[1];
      localRef[1] = predRef;
    }
  } else {
    minDistances[2] = d;
    localIndexes[2] = index;
    if (interRef) localRef[2] = predRef;
  }
}

// ...WithCheck variants (:1079-1146)
static void updateNNDistCheck(const V3& p0, const V3& p1, int32_t index,
                              NNState& st, bool predRef = false) {
  const auto& li = st.localIndexes;
  const auto& lr = st.localRef;
  if (st.interRef) {
    if ((index == li[0] && predRef == lr[0])
        || (index == li[1] && predRef == lr[1])
        || (index == li[2] && predRef == lr[2])
        || (index == li[3] && predRef == lr[3])
        || (index == li[4] && predRef == lr[4])
        || (index == li[5] && predRef == lr[5]))
      return;
  } else if (index == li[0] || index == li[1] || index == li[2]
             || index == li[3] || index == li[4] || index == li[5])
    return;
  updateNNDist(p0, p1, index, st, predRef);
}

static void updateNNCheck(const V3& p0, const V3& p1, int32_t index,
                          NNState& st, bool predRef = false) {
  const auto& li = st.localIndexes;
  const auto& lr = st.localRef;
  if (st.interRef) {
    if ((index == li[0] && predRef == lr[0])
        || (index == li[1] && predRef == lr[1])
        || (index == li[2] && predRef == lr[2]))
      return;
  } else if (index == li[0] || index == li[1] || index == li[2])
    return;
  updateNN(p0, p1, index, st, predRef);
}

// aps/abh parameters relevant to the intra predlift path
struct PlParams {
  int dims = 1;                    // 1 refl / 3 colour
  int bitdepth = 8;
  int attrEncoding = 1;            // 1 pred, 2 lift
  int initQp = 34;                 // init_qp_minus4 + 4
  int chromaQpOffset = 0;
  int numPredNearestNeighboursMinus1 = 2;
  int interLodSearchRange = 0;
  V3 lodNeighBias = {{1, 1, 1}};
  int lastComponentPrediction = 0;
  int numDetailLevelsMinus1 = 0;
  int canonicalPointOrder = 0;
  int lodDecimationType = 0;       // 0 none 1 periodic 2 centroid
  int dist2 = 0;
  int dist2Delta = 0;              // abh.attr_dist2_delta
  int maxNumDirectPredictors = 0;
  int adaptivePredictionThreshold = 0;
  int directAvgPredictorDisabled = 0;
  int intraLodPredictionSkipLayers = 0;
  int intraLodSearchRange = 0;
  int interComponentPrediction = 0;
  int predWeightBlending = 0;
  int quantNeighWeight[3] = {16, 8, 4};
  int maxPointsPerSortLog2Plus1 = 0;
  int predictionWithDistribution = 0;
  int bypassNoUpdate = 0;
  int qpLayersCount = 0;           // layer qps follow in side arrays
  int chunked = 0;                 // sps cabac_bypass_stream
  int sliceQpDeltaLuma = 0;        // already folded by caller if present
  int sliceQpDeltaChroma = 0;
  int maxNumDetailLevels() const { return numDetailLevelsMinus1 + 1; }
};

// ---------------------------------------------------------------------------
// LoD subsampling (PCCTMC3Common.h:1993-2262)
// ---------------------------------------------------------------------------

// subsampleByDistance (:1985-2086)
static void subsampleByDistance(
  const std::vector<PackedVoxel>& packedVoxel,
  const std::vector<uint32_t>& input, int32_t shiftBits0,
  std::vector<uint32_t>& retained, std::vector<uint32_t>& indexes,
  MortonIndexMap3d& atlas) {
  if (input.size() == 1) {
    indexes.push_back(input[0]);
    return;
  }
  const int64_t radius2 = 3ll << (shiftBits0 << 1);
  const int32_t shiftBits = shiftBits0 + 1;
  const int32_t shiftBits3 = 3 * shiftBits;
  const int32_t atlasBits = 3 * atlas.cubeSizeLog2();
  const int32_t atlasBoundaryBit = std::min(63, shiftBits3 + atlasBits);
  static const uint8_t kNeighOffset[20] = {7, 3, 5, 6, 12, 10, 17, 20,
                                           34, 33, 4, 2, 1, 24, 40, 48,
                                           32, 16, 8, 0};
  int64_t curAtlasId = -1;
  int64_t lastRetainedMortonCode = -1;

  for (const auto index : input) {
    const auto& point = packedVoxel[index].position;
    const int64_t mortonCode = packedVoxel[index].mortonCode;
    const int64_t pointAtlasId = mortonCode >> atlasBoundaryBit;
    const int64_t mortonCodeShiftBits3 = mortonCode >> shiftBits3;
    if (curAtlasId != pointAtlasId) {
      atlas.clearUpdates();
      curAtlasId = pointAtlasId;
    }
    if (retained.empty()) {
      retained.push_back(index);
      lastRetainedMortonCode = mortonCodeShiftBits3;
      atlas.set(lastRetainedMortonCode, int32_t(retained.size()) - 1);
      continue;
    }
    if (lastRetainedMortonCode == mortonCodeShiftBits3) {
      indexes.push_back(index);
      continue;
    }
    const auto basePosition =
      morton3dAdd(uint64_t(mortonCodeShiftBits3), uint64_t(-1ll));
    bool found = false;
    for (int32_t n = 0; n < 20 && !found; ++n) {
      const auto neighbMortonCode =
        morton3dAdd(basePosition, kNeighOffset[n]);
      if (int64_t(neighbMortonCode >> atlasBits) != curAtlasId) continue;
      const auto unit = atlas.get(int64_t(neighbMortonCode));
      for (int32_t k = unit.start; k < unit.end; ++k) {
        if (norm2(sub(packedVoxel[retained[k]].position, point)) <= radius2) {
          found = true;
          break;
        }
      }
    }
    if (found) {
      indexes.push_back(index);
    } else {
      retained.push_back(index);
      lastRetainedMortonCode = mortonCodeShiftBits3;
      atlas.set(lastRetainedMortonCode, int32_t(retained.size()) - 1);
    }
  }
}

// subsampleByOctreeWithCentroid (:2090-2140; non-scalable variant:
// clacIntermediatePosition with enabled=true masks low bits)
static V3 maskPos(int32_t nodeSizeLog2, const V3& p) {
  if (!nodeSizeLog2) return p;
  uint32_t mask = uint32_t(-1) << nodeSizeLog2;
  return {{int32_t(uint32_t(p.d[0]) & mask), int32_t(uint32_t(p.d[1]) & mask),
           int32_t(uint32_t(p.d[2]) & mask)}};
}

static uint32_t subsampleByOctreeWithCentroid(
  const std::vector<PackedVoxel>& packedVoxel, int32_t octreeNodeSizeLog2,
  bool backward, const std::vector<uint32_t>& voxels) {
  int64_t cx = 0, cy = 0, cz = 0;
  int count = 0;
  for (const auto t : voxels) {
    V3 pos = maskPos(octreeNodeSizeLog2, packedVoxel[t].position);
    cx += pos.d[0]; cy += pos.d[1]; cz += pos.d[2];
    count++;
  }
  int32_t nnIndex = backward ? int32_t(voxels.size()) - 1 : 0;
  int64_t minNorm = std::numeric_limits<int64_t>::max();
  if (backward) {
    int num = int(voxels.size()) - 1;
    for (auto t = voxels.rbegin(); t != voxels.rend(); ++t) {
      V3 pos = maskPos(octreeNodeSizeLog2, packedVoxel[*t].position);
      int64_t m = std::abs(int64_t(pos.d[0]) * count - cx)
        + std::abs(int64_t(pos.d[1]) * count - cy)
        + std::abs(int64_t(pos.d[2]) * count - cz);
      if (minNorm > m) { minNorm = m; nnIndex = num; }
      num--;
    }
  } else {
    int num = 0;
    for (const auto t : voxels) {
      V3 pos = maskPos(octreeNodeSizeLog2, packedVoxel[t].position);
      int64_t m = std::abs(int64_t(pos.d[0]) * count - cx)
        + std::abs(int64_t(pos.d[1]) * count - cy)
        + std::abs(int64_t(pos.d[2]) * count - cz);
      if (minNorm > m) { minNorm = m; nnIndex = num; }
      num++;
    }
  }
  return voxels[size_t(nnIndex)];
}

// subsampleByOctree (:2144-2196)
static void subsampleByOctree(
  const std::vector<PackedVoxel>& packedVoxel,
  const std::vector<uint32_t>& input, int32_t octreeNodeSizeLog2,
  std::vector<uint32_t>& retained, std::vector<uint32_t>& indexes,
  bool direction, int lodSamplingPeriod) {
  const int indexCount = int(input.size());
  if (indexCount == 1) {
    indexes.push_back(input[0]);
    return;
  }
  uint64_t lodUniformQuant = uint64_t(3 * (octreeNodeSizeLog2 + 1));
  std::vector<uint32_t> voxels;
  voxels.reserve(8);
  for (int i = 0; i < indexCount; ++i) {
    uint64_t currVoxelPos =
      uint64_t(packedVoxel[input[size_t(i)]].mortonCode) >> lodUniformQuant;
    uint64_t nextVoxelPos = currVoxelPos;
    if (i < indexCount - 1)
      nextVoxelPos =
        uint64_t(packedVoxel[input[size_t(i + 1)]].mortonCode)
        >> lodUniformQuant;
    voxels.push_back(input[size_t(i)]);
    if (i == indexCount - 1 || currVoxelPos < nextVoxelPos) {
      if (int(voxels.size()) < lodSamplingPeriod && i != indexCount - 1)
        continue;
      uint32_t picked = subsampleByOctreeWithCentroid(
        packedVoxel, octreeNodeSizeLog2, direction, voxels);
      for (const auto idx : voxels) {
        if (picked == idx) retained.push_back(idx);
        else indexes.push_back(idx);
      }
      voxels.clear();
    }
  }
}

// subsampleByDecimation (:2200-2216)
static void subsampleByDecimation(
  const std::vector<uint32_t>& input, int lodSamplingPeriod,
  std::vector<uint32_t>& retained, std::vector<uint32_t>& indexes) {
  const int indexCount = int(input.size());
  for (int i = 0, j = 1; i < indexCount; ++i) {
    if (--j) indexes.push_back(input[size_t(i)]);
    else {
      retained.push_back(input[size_t(i)]);
      j = lodSamplingPeriod;
    }
  }
}

// subsample dispatcher (:2220-2253; non-scalable)
static void subsample(
  const PlParams& pp, const int32_t* samplingPeriods,
  const std::vector<PackedVoxel>& packedVoxel,
  const std::vector<uint32_t>& input, int32_t lodIndex,
  std::vector<uint32_t>& retained, std::vector<uint32_t>& indexes,
  MortonIndexMap3d& atlas) {
  if (pp.lodDecimationType == 1) {       // kPeriodic
    subsampleByDecimation(input, samplingPeriods[lodIndex], retained,
                          indexes);
  } else if (pp.lodDecimationType == 2) {  // kCentroid
    int32_t octreeNodeSizeLog2 = pp.dist2 + pp.dist2Delta + lodIndex;
    subsampleByOctree(packedVoxel, input, octreeNodeSizeLog2, retained,
                      indexes, true, samplingPeriods[lodIndex]);
  } else {
    const auto shiftBits = pp.dist2 + pp.dist2Delta + lodIndex;
    subsampleByDistance(packedVoxel, input, shiftBits, retained, indexes,
                        atlas);
  }
}

// ---------------------------------------------------------------------------
// computeNearestNeighbors (PCCTMC3Common.h:1147-1962; intra-only)
// ---------------------------------------------------------------------------

static void computeNearestNeighbors(
  const PlParams& pp,
  const std::vector<PackedVoxel>& packedVoxel,
  const std::vector<uint32_t>& retained, int32_t startIndex,
  int32_t endIndex, int32_t lodIndex, std::vector<uint32_t>& indexes,
  std::vector<Predictor>& predictors,
  std::vector<uint32_t>& pointIndexToPredictorIndex, int32_t& predIndex,
  MortonIndexMap3d& atlas, const std::vector<V3>& biasedPos,
  // attribute inter prediction (PCCTMC3Common.h:1147+ inter form):
  // the whole sorted reference cloud joins the candidate pool at
  // every LoD (the reference LoD index array is the identity)
  bool interRef = false,
  const std::vector<PackedVoxel>* packedVoxelRef = nullptr,
  const std::vector<V3>* biasedPosRefP = nullptr,
  MortonIndexMap3d* interAtlasP = nullptr,
  int32_t interSearchRange = 0) {
  constexpr int32_t searchRangeNear = 2;
  constexpr int32_t bucketSizeLog2 = 5;
  constexpr int32_t bucketSize = 1 << bucketSizeLog2;
  constexpr int32_t bucketSizeMinus1 = bucketSize - 1;

  const int32_t shiftBits = 1 + pp.dist2 + pp.dist2Delta + lodIndex;
  const int32_t shiftBits3 = 3 * shiftBits;
  const int32_t atlasBits = 3 * atlas.cubeSizeLog2();
  const int32_t atlasBoundaryBit = std::min(63, shiftBits3 + atlasBits);

  const int32_t retainedSize = int32_t(retained.size());
  const int32_t indexesSize = endIndex - startIndex;
  // with inter prediction both search ranges take the ABH value
  const auto rangeInterLod =
    interRef ? interSearchRange : pp.interLodSearchRange;
  const auto rangeIntraLod =
    interRef ? interSearchRange : pp.intraLodSearchRange;
  const bool dist = pp.predictionWithDistribution != 0;
  const int32_t interAtlasBits =
    interRef ? 3 * interAtlasP->cubeSizeLog2() : 0;
  const int32_t interAtlasBoundaryBit =
    std::min(63, shiftBits3 + interAtlasBits);

  static const uint8_t kNeighOffset[27] = {
    7, 3, 5, 6, 35, 21, 14, 28, 42, 49, 12, 10, 17, 20,
    34, 33, 4, 2, 1, 56, 24, 40, 48, 32, 16, 8, 0};

  std::vector<int32_t> neighborIndexes;
  neighborIndexes.reserve(64);

  BoxHierarchy hBBoxes;
  hBBoxes.resize(retainedSize);
  for (int32_t i = 0; i < retainedSize; ++i)
    hBBoxes.insert(biasedPos[retained[size_t(i)]], i);
  hBBoxes.update();

  BoxHierarchy hIntraBBoxes;
  if (lodIndex >= pp.intraLodPredictionSkipLayers) {
    hIntraBBoxes.resize(indexesSize);
    for (int32_t i = startIndex; i < endIndex; ++i)
      hIntraBBoxes.insert(biasedPos[indexes[size_t(i)]], i - startIndex);
    hIntraBBoxes.update();
  }

  // reference-side hierarchy over the whole sorted ref cloud
  const int32_t indexesSizeRef =
    interRef ? int32_t(packedVoxelRef->size()) : 0;
  BoxHierarchy hIntraBBoxesRef;
  if (interRef) {
    hIntraBBoxesRef.resize(indexesSizeRef);
    for (int32_t i = 0; i < indexesSizeRef; ++i)
      hIntraBBoxesRef.insert((*biasedPosRefP)[size_t(i)], i);
    hIntraBBoxesRef.update();
  }
  int jRef = 0;
  std::vector<int32_t> neighborInterIndexes;
  neighborInterIndexes.reserve(64);
  int64_t curInterAtlasId = -1;
  int64_t lastInterMortonCodeShift3 = -1;
  int64_t cubeInterIndex = 0;

  const auto bucketSize0Log2 = hBBoxes.bucketSizeLog2(0);
  const auto bucketSize1Log2 = hBBoxes.bucketSizeLog2(1);
  const auto bucketSize2Log2 = hBBoxes.bucketSizeLog2(2);

  int64_t curAtlasId = -1;
  int64_t lastMortonCodeShift3 = -1;
  int64_t cubeIndex = 0;
  const int32_t distCoefficient = 54;

  for (int32_t i = startIndex, j = 0; i < endIndex; ++i) {
    NNState st;
    st.init();
    st.interRef = interRef;
    auto& localIndexes = st.localIndexes;
    auto& minDistances = st.minDistances;

    const int32_t index = int32_t(indexes[size_t(i)]);
    const auto& pv = packedVoxel[size_t(index)];
    const int64_t mortonCode = pv.mortonCode;
    const int64_t pointAtlasId = mortonCode >> atlasBoundaryBit;
    const int64_t mortonCodeShiftBits3 = mortonCode >> shiftBits3;
    const int32_t pointIndex = pv.index;
    const auto bpoint = biasedPos[size_t(index)];
    indexes[size_t(i)] = uint32_t(pointIndex);
    auto& predictor = predictors[size_t(--predIndex)];
    pointIndexToPredictorIndex[size_t(pointIndex)] = uint32_t(predIndex);

    if (retainedSize) {
      while (j < retainedSize - 1
             && mortonCode >= packedVoxel[retained[size_t(j)]].mortonCode)
        ++j;

      if (curAtlasId != pointAtlasId) {
        atlas.clearUpdates();
        curAtlasId = pointAtlasId;
        while (cubeIndex < retainedSize
               && (packedVoxel[retained[size_t(cubeIndex)]].mortonCode
                   >> atlasBoundaryBit)
                 == curAtlasId) {
          atlas.set(
            packedVoxel[retained[size_t(cubeIndex)]].mortonCode >> shiftBits3,
            int32_t(cubeIndex));
          ++cubeIndex;
        }
      }

      if (lastMortonCodeShift3 != mortonCodeShiftBits3) {
        lastMortonCodeShift3 = mortonCodeShiftBits3;
        const auto basePosition =
          morton3dAdd(uint64_t(mortonCodeShiftBits3), uint64_t(-1ll));
        neighborIndexes.resize(0);
        for (int32_t n = 0; n < 27; ++n) {
          const auto neighbMortonCode =
            morton3dAdd(basePosition, kNeighOffset[n]);
          if (int64_t(neighbMortonCode >> atlasBits) != curAtlasId) continue;
          const auto range = atlas.get(int64_t(neighbMortonCode));
          for (int32_t k = range.start; k < range.end; ++k)
            neighborIndexes.push_back(k);
        }
      }

      for (const auto k : neighborIndexes) {
        if (dist)
          updateNNDist(bpoint, biasedPos[retained[size_t(k)]], k, st);
        else
          updateNN(bpoint, biasedPos[retained[size_t(k)]], k, st);
      }

      if (localIndexes[2] == -1) {
        const auto center = localIndexes[0] == -1 ? j : localIndexes[0];
        const auto k0 = std::max(0, center - rangeInterLod);
        const auto k1 = std::min(retainedSize - 1, center + rangeInterLod);
        if (dist)
          updateNNDistCheck(bpoint, biasedPos[retained[size_t(center)]],
                            center, st);
        else
          updateNNCheck(bpoint, biasedPos[retained[size_t(center)]], center,
                        st);
        for (int32_t n = 1; n <= searchRangeNear; ++n) {
          const int32_t kp = center + n;
          if (kp <= k1) {
            if (dist)
              updateNNDistCheck(bpoint, biasedPos[retained[size_t(kp)]], kp,
                                st);
            else
              updateNNCheck(bpoint, biasedPos[retained[size_t(kp)]], kp, st);
          }
          const int32_t kn = center - n;
          if (kn >= k0) {
            if (dist)
              updateNNDistCheck(bpoint, biasedPos[retained[size_t(kn)]], kn,
                                st);
            else
              updateNNCheck(bpoint, biasedPos[retained[size_t(kn)]], kn, st);
          }
        }

        const int32_t p1 =
          std::min(retainedSize - 1, center + searchRangeNear + 1);
        const int32_t p0 = std::max(0, center - searchRangeNear - 1);

        // search p1...k1 (forward bucket sweep)
        {
          const int32_t b21 = k1 >> bucketSize2Log2;
          const int32_t b20 = p1 >> bucketSize2Log2;
          const int32_t b11 = k1 >> bucketSize1Log2;
          const int32_t b10 = p1 >> bucketSize1Log2;
          const int32_t b01 = k1 >> bucketSize0Log2;
          const int32_t b00 = p1 >> bucketSize0Log2;
          for (int32_t b2 = b20; b2 <= b21; ++b2) {
            if (localIndexes[2] != -1
                && hBBoxes.box(b2, 2).getDist1(bpoint) >= minDistances[2])
              continue;
            const auto alignedIndex1 = b2 << bucketSizeLog2;
            const auto start1 = std::max(b10, alignedIndex1);
            const auto end1 = std::min(b11, alignedIndex1 + bucketSizeMinus1);
            for (int32_t b1 = start1; b1 <= end1; ++b1) {
              if (localIndexes[2] != -1
                  && hBBoxes.box(b1, 1).getDist1(bpoint) >= minDistances[2])
                continue;
              const auto alignedIndex0 = b1 << bucketSizeLog2;
              const auto start0 = std::max(b00, alignedIndex0);
              const auto end0 =
                std::min(b01, alignedIndex0 + bucketSizeMinus1);
              for (int32_t b0 = start0; b0 <= end0; ++b0) {
                if (localIndexes[2] != -1
                    && hBBoxes.box(b0, 0).getDist1(bpoint) >= minDistances[2])
                  continue;
                const int32_t alignedIndex = b0 << bucketSizeLog2;
                const int32_t h0 = std::max(p1, alignedIndex);
                const int32_t h1 =
                  std::min(k1, alignedIndex + bucketSizeMinus1);
                for (int32_t k = h0; k <= h1; ++k) {
                  if (dist)
                    updateNNDistCheck(bpoint, biasedPos[retained[size_t(k)]],
                                      k, st);
                  else
                    updateNNCheck(bpoint, biasedPos[retained[size_t(k)]], k,
                                  st);
                }
              }
            }
          }
        }

        // search k0...p0 (backward bucket sweep)
        {
          const int32_t c21 = p0 >> bucketSize2Log2;
          const int32_t c20 = k0 >> bucketSize2Log2;
          const int32_t c11 = p0 >> bucketSize1Log2;
          const int32_t c10 = k0 >> bucketSize1Log2;
          const int32_t c01 = p0 >> bucketSize0Log2;
          const int32_t c00 = k0 >> bucketSize0Log2;
          for (int32_t c2 = c21; c2 >= c20; --c2) {
            if (localIndexes[2] != -1
                && hBBoxes.box(c2, 2).getDist1(bpoint) >= minDistances[2])
              continue;
            const auto alignedIndex1 = c2 << bucketSizeLog2;
            const auto start1 = std::max(c10, alignedIndex1);
            const auto end1 = std::min(c11, alignedIndex1 + bucketSizeMinus1);
            for (int32_t c1 = end1; c1 >= start1; --c1) {
              if (localIndexes[2] != -1
                  && hBBoxes.box(c1, 1).getDist1(bpoint) >= minDistances[2])
                continue;
              const auto alignedIndex0 = c1 << bucketSizeLog2;
              const auto start0 = std::max(c00, alignedIndex0);
              const auto end0 =
                std::min(c01, alignedIndex0 + bucketSizeMinus1);
              for (int32_t c0 = end0; c0 >= start0; --c0) {
                if (localIndexes[2] != -1
                    && hBBoxes.box(c0, 0).getDist1(bpoint) >= minDistances[2])
                  continue;
                const int32_t alignedIndex = c0 << bucketSizeLog2;
                const int32_t h0 = std::max(k0, alignedIndex);
                const int32_t h1 =
                  std::min(p0, alignedIndex + bucketSizeMinus1);
                for (int32_t k = h1; k >= h0; --k) {
                  if (dist)
                    updateNNDistCheck(bpoint, biasedPos[retained[size_t(k)]],
                                      k, st);
                  else
                    updateNNCheck(bpoint, biasedPos[retained[size_t(k)]], k,
                                  st);
                }
              }
            }
          }
        }
      }

      predictor.neighborCount = uint32_t(
        (localIndexes[0] != -1) + (localIndexes[1] != -1)
        + (localIndexes[2] != -1));
      for (uint32_t h = 0; h < predictor.neighborCount; ++h)
        localIndexes[h] = int32_t(retained[size_t(localIndexes[h])]);
      if (dist) {
        int neighborCount2 = (localIndexes[3] != -1) + (localIndexes[4] != -1)
          + (localIndexes[5] != -1);
        for (int32_t h = 3; h < 3 + neighborCount2; ++h)
          localIndexes[h] = int32_t(retained[size_t(localIndexes[h])]);
      }
    }

    if (lodIndex >= pp.intraLodPredictionSkipLayers) {
      const int32_t k00 = i + 1;
      const int32_t k01 = std::min(endIndex - 1, k00 + searchRangeNear);
      for (int32_t k = k00; k <= k01; ++k) {
        if (dist)
          updateNNDist(bpoint, biasedPos[indexes[size_t(k)]],
                       int32_t(indexes[size_t(k)]), st);
        else
          updateNN(bpoint, biasedPos[indexes[size_t(k)]],
                   int32_t(indexes[size_t(k)]), st);
      }
      const int32_t k0 = k01 + 1 - startIndex;
      const int32_t k1 =
        std::min(endIndex - 1, k00 + rangeIntraLod) - startIndex;

      const int32_t b21 = k1 >> bucketSize2Log2;
      const int32_t b20 = k0 >> bucketSize2Log2;
      const int32_t b11 = k1 >> bucketSize1Log2;
      const int32_t b10 = k0 >> bucketSize1Log2;
      const int32_t b01 = k1 >> bucketSize0Log2;
      const int32_t b00 = k0 >> bucketSize0Log2;
      for (int32_t b2 = b20; b2 <= b21; ++b2) {
        if (localIndexes[2] != -1
            && hIntraBBoxes.box(b2, 2).getDist1(bpoint) >= minDistances[2])
          continue;
        const auto alignedIndex1 = b2 << bucketSizeLog2;
        const auto start1 = std::max(b10, alignedIndex1);
        const auto end1 = std::min(b11, alignedIndex1 + bucketSizeMinus1);
        for (int32_t b1 = start1; b1 <= end1; ++b1) {
          if (localIndexes[2] != -1
              && hIntraBBoxes.box(b1, 1).getDist1(bpoint) >= minDistances[2])
            continue;
          const auto alignedIndex0 = b1 << bucketSizeLog2;
          const auto start0 = std::max(b00, alignedIndex0);
          const auto end0 = std::min(b01, alignedIndex0 + bucketSizeMinus1);
          for (int32_t b0 = start0; b0 <= end0; ++b0) {
            if (localIndexes[2] != -1
                && hIntraBBoxes.box(b0, 0).getDist1(bpoint)
                  >= minDistances[2])
              continue;
            const int32_t alignedIndex = b0 << bucketSizeLog2;
            const int32_t h0 = std::max(k0, alignedIndex);
            const int32_t h1 = std::min(k1, alignedIndex + bucketSizeMinus1);
            for (int32_t h = h0; h <= h1; ++h) {
              const int32_t k = startIndex + h;
              if (dist)
                updateNNDist(bpoint, biasedPos[indexes[size_t(k)]],
                             int32_t(indexes[size_t(k)]), st);
              else
                updateNN(bpoint, biasedPos[indexes[size_t(k)]],
                         int32_t(indexes[size_t(k)]), st);
            }
          }
        }
      }
    }

    // inter-frame candidates (PCCTMC3Common.h:1606-1795): a 27-cube
    // atlas pass over the reference cloud, then forward/backward
    // Morton windows of attrInterPredSearchRange around the cursor
    if (interRef) {
      const auto& packedVoxelRefV = *packedVoxelRef;
      const auto& biasedPosRef = *biasedPosRefP;
      auto& interAtlas = *interAtlasP;
      const int64_t interPointAtlasId = mortonCode >> interAtlasBoundaryBit;
      if (curInterAtlasId != interPointAtlasId) {
        curInterAtlasId = interPointAtlasId;
        interAtlas.clearUpdates();
        while (cubeInterIndex < indexesSizeRef
               && (packedVoxelRefV[size_t(cubeInterIndex)].mortonCode
                   >> interAtlasBoundaryBit)
                 == curInterAtlasId) {
          interAtlas.set(
            packedVoxelRefV[size_t(cubeInterIndex)].mortonCode >> shiftBits3,
            int32_t(cubeInterIndex));
          ++cubeInterIndex;
        }
      }
      if (lastInterMortonCodeShift3 != mortonCodeShiftBits3) {
        lastInterMortonCodeShift3 = mortonCodeShiftBits3;
        const auto basePosition =
          morton3dAdd(uint64_t(mortonCodeShiftBits3), uint64_t(-1ll));
        neighborInterIndexes.resize(0);
        for (int32_t n = 0; n < 27; ++n) {
          const auto neighbMortonCode =
            morton3dAdd(basePosition, kNeighOffset[n]);
          // NB: the reference shifts by the INTRA atlas width here
          // (PCCTMC3Common.h:1629 uses atlasBits, not interAtlasBits),
          // which starves the inter atlas pass at fine LoDs — the
          // quirk is normatively visible and mirrored
          if (int64_t(neighbMortonCode >> atlasBits) != curInterAtlasId)
            continue;
          const auto range = interAtlas.get(int64_t(neighbMortonCode));
          for (int32_t k = range.start; k < range.end; ++k)
            neighborInterIndexes.push_back(k);
        }
      }
      for (const auto k : neighborInterIndexes) {
        if (dist)
          updateNNDist(bpoint, biasedPosRef[size_t(k)], k, st, true);
        else
          updateNN(bpoint, biasedPosRef[size_t(k)], k, st, true);
      }

      if (indexesSizeRef > 0) {
        while (jRef < indexesSizeRef - 1
               && mortonCode > packedVoxelRefV[size_t(jRef)].mortonCode)
          ++jRef;
        const int32_t k0_ref =
          std::min(indexesSizeRef - 1, std::max(0, jRef));
        const int32_t k1_ref = std::min(
          indexesSizeRef - 1, std::max(0, k0_ref + interSearchRange));

        // forward window k0_ref..k1_ref
        {
          const int32_t b21 = k1_ref >> bucketSize2Log2;
          const int32_t b20 = k0_ref >> bucketSize2Log2;
          const int32_t b11 = k1_ref >> bucketSize1Log2;
          const int32_t b10 = k0_ref >> bucketSize1Log2;
          const int32_t b01 = k1_ref >> bucketSize0Log2;
          const int32_t b00 = k0_ref >> bucketSize0Log2;
          for (int32_t b2 = b20; b2 <= b21; ++b2) {
            if (localIndexes[2] != -1
                && hIntraBBoxesRef.box(b2, 2).getDist1(bpoint)
                  >= minDistances[2])
              continue;
            const auto alignedIndex1 = b2 << bucketSizeLog2;
            const auto start1 = std::max(b10, alignedIndex1);
            const auto end1 = std::min(b11, alignedIndex1 + bucketSizeMinus1);
            for (int32_t b1 = start1; b1 <= end1; ++b1) {
              if (localIndexes[2] != -1
                  && hIntraBBoxesRef.box(b1, 1).getDist1(bpoint)
                    >= minDistances[2])
                continue;
              const auto alignedIndex0 = b1 << bucketSizeLog2;
              const auto start0 = std::max(b00, alignedIndex0);
              const auto end0 =
                std::min(b01, alignedIndex0 + bucketSizeMinus1);
              for (int32_t b0 = start0; b0 <= end0; ++b0) {
                if (localIndexes[2] != -1
                    && hIntraBBoxesRef.box(b0, 0).getDist1(bpoint)
                      >= minDistances[2])
                  continue;
                const int32_t alignedIndex = b0 << bucketSizeLog2;
                const int32_t h0 = std::max(k0_ref, alignedIndex);
                const int32_t h1 =
                  std::min(k1_ref, alignedIndex + bucketSizeMinus1);
                for (int32_t k = h0; k <= h1; ++k) {
                  if (dist)
                    updateNNDist(bpoint, biasedPosRef[size_t(k)], k, st,
                                 true);
                  else
                    updateNN(bpoint, biasedPosRef[size_t(k)], k, st, true);
                }
              }
            }
          }
        }

        // backward window k1_ref_left..k0_ref_left (reference iterates
        // the reversed bucket bounds ascending — mirrored exactly)
        const int32_t k0_ref_left =
          std::min(indexesSizeRef - 1, std::max(0, jRef - 1));
        const int32_t k1_ref_left = std::min(
          indexesSizeRef - 1, std::max(0, k0_ref_left - interSearchRange));
        {
          const int32_t b21 = k1_ref_left >> bucketSize2Log2;
          const int32_t b20 = k0_ref_left >> bucketSize2Log2;
          const int32_t b11 = k1_ref_left >> bucketSize1Log2;
          const int32_t b10 = k0_ref_left >> bucketSize1Log2;
          const int32_t b01 = k1_ref_left >> bucketSize0Log2;
          const int32_t b00 = k0_ref_left >> bucketSize0Log2;
          for (int32_t b2 = b21; b2 <= b20; ++b2) {
            if (localIndexes[2] != -1
                && hIntraBBoxesRef.box(b2, 2).getDist1(bpoint)
                  >= minDistances[2])
              continue;
            const auto alignedIndex1 = b2 << bucketSizeLog2;
            const auto start1 = std::max(b11, alignedIndex1);
            const auto end1 = std::min(b10, alignedIndex1 + bucketSizeMinus1);
            for (int32_t b1 = start1; b1 <= end1; ++b1) {
              if (localIndexes[2] != -1
                  && hIntraBBoxesRef.box(b1, 1).getDist1(bpoint)
                    >= minDistances[2])
                continue;
              const auto alignedIndex0 = b1 << bucketSizeLog2;
              const auto start0 = std::max(b01, alignedIndex0);
              const auto end0 =
                std::min(b00, alignedIndex0 + bucketSizeMinus1);
              for (int32_t b0 = start0; b0 <= end0; ++b0) {
                if (localIndexes[2] != -1
                    && hIntraBBoxesRef.box(b0, 0).getDist1(bpoint)
                      >= minDistances[2])
                  continue;
                const int32_t alignedIndex = b0 << bucketSizeLog2;
                const int32_t h0 = std::max(k1_ref_left, alignedIndex);
                const int32_t h1 =
                  std::min(k0_ref_left, alignedIndex + bucketSizeMinus1);
                for (int32_t k = h0; k <= h1; ++k) {
                  if (dist)
                    updateNNDist(bpoint, biasedPosRef[size_t(k)], k, st,
                                 true);
                  else
                    updateNN(bpoint, biasedPosRef[size_t(k)], k, st, true);
                }
              }
            }
          }
        }
      }
    }

    predictor.neighborCount = uint32_t(std::min(
      pp.numPredNearestNeighboursMinus1 + 1,
      (localIndexes[0] != -1) + (localIndexes[1] != -1)
        + (localIndexes[2] != -1)));

    // distribution-aware third-neighbour replacement
    // (PCCTMC3Common.h:1803-1906)
    if (dist) {
      const int neighborCount1 = 3 + (localIndexes[3] != -1)
        + (localIndexes[4] != -1) + (localIndexes[5] != -1);

      auto& localRef = st.localRef;
      for (int m = 3; m < neighborCount1; m++)
        if (minDistances[m] == std::numeric_limits<int64_t>::max())
          minDistances[m] = localRef[m]
            ? norm1(sub(bpoint, (*biasedPosRefP)[size_t(localIndexes[m])]))
            : norm1(sub(bpoint, biasedPos[size_t(localIndexes[m])]));

      for (int m = 3; m < neighborCount1; m++)
        for (int l = m + 1; l < neighborCount1; l++)
          if (minDistances[l] < minDistances[m]) {
            std::swap(localIndexes[l], localIndexes[m]);
            std::swap(minDistances[l], minDistances[m]);
            std::swap(localRef[l], localRef[m]);
          }

      bool replaceFlag = true;
      if (predictor.neighborCount >= 3) {
        int dir[6] = {-1, -1, -1, -1, -1, -1};
        const int looseDirTable[8][3] = {{3, 5, 6}, {2, 4, 7}, {1, 4, 7},
                                         {0, 5, 6}, {1, 2, 7}, {0, 3, 6},
                                         {0, 3, 5}, {1, 2, 4}};
        int numend1 = 0;
        for (numend1 = 3; numend1 < neighborCount1; ++numend1)
          if ((minDistances[numend1] << 5)
              >= minDistances[2] * distCoefficient)
            break;

        for (int h = 0; h < numend1; ++h)
          dir[h] = localRef[h]
            ? getDir(sub((*biasedPosRefP)[size_t(localIndexes[h])], bpoint))
            : getDir(sub(biasedPos[size_t(localIndexes[h])], bpoint));

        int replaceIdx = -1;
        if (dir[1] == 7 - dir[0] || dir[2] == 7 - dir[0]
            || dir[2] == 7 - dir[1])
          replaceFlag = false;
        for (int h = 3; replaceFlag && h < numend1; ++h) {
          if (dir[h] == 7 - dir[0] || dir[h] == 7 - dir[1]) {
            replaceFlag = false;
            replaceIdx = h;
          }
        }
        bool equal01 = dir[0] == dir[1];
        bool equal02 = dir[0] == dir[2];
        bool equal12 = dir[1] == dir[2];
        const auto& looseDirs0 = looseDirTable[dir[0]];
        if (replaceFlag) {
          if ((equal02 || equal12) && equal01) {
            for (int h = 3; replaceFlag && h < numend1; h++) {
              if (dir[h] == looseDirs0[0] || dir[h] == looseDirs0[1]
                  || dir[h] == looseDirs0[2]) {
                replaceFlag = false;
                replaceIdx = h;
              }
            }
          } else if ((equal02 || equal12) && !equal01) {
            if (!(dir[1] == looseDirs0[0] || dir[1] == looseDirs0[1]
                  || dir[1] == looseDirs0[2]))
              for (int h = 3; replaceFlag && h < numend1; h++)
                if (dir[h] != dir[0] && dir[h] != dir[1]) {
                  replaceFlag = false;
                  replaceIdx = h;
                }
          } else if (equal01) {
            if (!(dir[2] == looseDirs0[0] || dir[2] == looseDirs0[1]
                  || dir[2] == looseDirs0[2]))
              for (int h = 3; replaceFlag && h < numend1; h++) {
                if (dir[h] == looseDirs0[0] || dir[h] == looseDirs0[1]
                    || dir[h] == looseDirs0[2]) {
                  replaceFlag = false;
                  replaceIdx = h;
                }
              }
          }
        }
        if (replaceIdx >= 0) {
          localIndexes[2] = localIndexes[replaceIdx];
          localRef[2] = localRef[replaceIdx];
        }
      }
    }

    for (uint32_t h = 0; h < predictor.neighborCount; ++h) {
      auto& neigh = predictor.neighbors[h];
      neigh.interFrameRef = st.localRef[h];
      if (interRef && neigh.interFrameRef) {
        neigh.predictorIndex =
          uint32_t((*packedVoxelRef)[size_t(localIndexes[h])].index);
        neigh.weight = uint64_t(
          norm2(sub((*biasedPosRefP)[size_t(localIndexes[h])], bpoint)));
      } else {
        neigh.predictorIndex =
          uint32_t(packedVoxel[size_t(localIndexes[h])].index);
        neigh.weight = uint64_t(
          norm2(sub(biasedPos[size_t(localIndexes[h])], bpoint)));
      }
    }

    // (scalable-lifting neighbour pruning skipped: out of scope)

    if (predictor.neighborCount > 1) {
      if (predictor.neighbors[0].weight > predictor.neighbors[1].weight)
        std::swap(predictor.neighbors[1], predictor.neighbors[0]);
      if (predictor.neighborCount == 3) {
        if (predictor.neighbors[1].weight > predictor.neighbors[2].weight) {
          std::swap(predictor.neighbors[2], predictor.neighbors[1]);
          if (predictor.neighbors[0].weight > predictor.neighbors[1].weight)
            std::swap(predictor.neighbors[1], predictor.neighbors[0]);
        }
      }
    }
  }
}

// updatePredictors (PCCTMC3Common.h:2279-2298, intra)
static void updatePredictors(
  const std::vector<uint32_t>& pointIndexToPredictorIndex,
  std::vector<Predictor>& predictors, int frameDistance = 0) {
  for (auto& predictor : predictors) {
    if (predictor.neighborCount < 2) {
      predictor.neighbors[0].weight = 1;
    } else if (predictor.neighbors[0].weight == 0) {
      predictor.neighborCount = 1;
      predictor.neighbors[0].weight = 1;
    }
    for (uint32_t k = 0; k < predictor.neighborCount; ++k) {
      auto& neighbor = predictor.neighbors[k];
      neighbor.pointIndex = neighbor.predictorIndex;
      // inter neighbours keep the raw reference point index; their
      // distance-weight is biased by the frame distance (:2287-2294)
      if (neighbor.interFrameRef)
        neighbor.weight += uint64_t(frameDistance);
      else
        neighbor.predictorIndex =
          pointIndexToPredictorIndex[neighbor.predictorIndex];
    }
  }
}

// buildPredictorsFast (PCCTMC3Common.h:2300-2475; intra, non-scalable,
// minGeomNodeSizeLog2 = 0)
struct Lods {
  std::vector<Predictor> predictors;
  std::vector<uint32_t> numPointsInLod;
  std::vector<uint32_t> indexes;
};

static void buildPredictorsFast(
  const PlParams& pp, const int32_t* samplingPeriods,
  const std::vector<V3>& positions, Lods& lods,
  // inter prediction: the sorted reference cloud joins the candidate
  // pool at every LoD (PCCTMC3Common.h:2352-2423)
  const std::vector<V3>* positionsRef = nullptr,
  int32_t interSearchRange = 0, int frameDistance = 1,
  std::vector<PackedVoxel>* packedVoxelRefOut = nullptr) {
  const bool interRef = positionsRef != nullptr;
  const int32_t pointCount = int32_t(positions.size());

  std::vector<PackedVoxel> packedVoxel = std::vector<PackedVoxel>(size_t(pointCount));
  for (int32_t n = 0; n < pointCount; n++) {
    packedVoxel[size_t(n)].position = positions[size_t(n)];
    packedVoxel[size_t(n)].mortonCode = mortonAddr(positions[size_t(n)]);
    packedVoxel[size_t(n)].index = n;
  }
  if (!pp.canonicalPointOrder && !pp.maxPointsPerSortLog2Plus1) {
    std::sort(packedVoxel.begin(), packedVoxel.end());
  } else if (pp.maxPointsPerSortLog2Plus1 > 1) {
    int maxPtsPerSort = 1 << (pp.maxPointsPerSortLog2Plus1 - 1);
    for (int32_t i = 0; i < pointCount; i += maxPtsPerSort) {
      int32_t iEnd = std::min(i + maxPtsPerSort, pointCount);
      std::sort(packedVoxel.begin() + i, packedVoxel.begin() + iEnd);
    }
  }

  // biased positions (identity intermediate for non-scalable)
  std::vector<V3> biasedPos = std::vector<V3>(size_t(pointCount));
  for (int32_t n = 0; n < pointCount; n++) {
    const auto& p = packedVoxel[size_t(n)].position;
    biasedPos[size_t(n)] = {{p.d[0] * pp.lodNeighBias.d[0],
                             p.d[1] * pp.lodNeighBias.d[1],
                             p.d[2] * pp.lodNeighBias.d[2]}};
  }

  // reference-frame pyramid: sorted once, never subsampled
  std::vector<PackedVoxel> packedVoxelRef;
  std::vector<V3> biasedPosRef;
  if (interRef) {
    const int32_t pointCountRef = int32_t(positionsRef->size());
    packedVoxelRef.resize(size_t(pointCountRef));
    for (int32_t n = 0; n < pointCountRef; n++) {
      packedVoxelRef[size_t(n)].position = (*positionsRef)[size_t(n)];
      packedVoxelRef[size_t(n)].mortonCode =
        mortonAddr((*positionsRef)[size_t(n)]);
      packedVoxelRef[size_t(n)].index = n;
    }
    if (!pp.canonicalPointOrder && !pp.maxPointsPerSortLog2Plus1) {
      std::sort(packedVoxelRef.begin(), packedVoxelRef.end());
    } else if (pp.maxPointsPerSortLog2Plus1 > 1) {
      int maxPtsPerSort = 1 << (pp.maxPointsPerSortLog2Plus1 - 1);
      for (int32_t i = 0; i < pointCount; i += maxPtsPerSort) {
        int32_t iEnd = std::min(i + maxPtsPerSort, pointCount);
        std::sort(packedVoxelRef.begin() + i, packedVoxelRef.begin() + iEnd);
      }
    }
    biasedPosRef.resize(size_t(pointCountRef));
    for (int32_t n = 0; n < pointCountRef; n++) {
      const auto& q = packedVoxelRef[size_t(n)].position;
      biasedPosRef[size_t(n)] = {{q.d[0] * pp.lodNeighBias.d[0],
                                  q.d[1] * pp.lodNeighBias.d[1],
                                  q.d[2] * pp.lodNeighBias.d[2]}};
    }
  }

  std::vector<uint32_t> retained, input, pointIndexToPredictorIndex;
  pointIndexToPredictorIndex.resize(size_t(pointCount));
  retained.reserve(size_t(pointCount));
  input.resize(size_t(pointCount));
  for (int32_t i = 0; i < pointCount; ++i) input[size_t(i)] = uint32_t(i);

  lods.predictors.clear();
  lods.predictors.resize(size_t(pointCount));
  for (auto& p : lods.predictors) p.init();
  lods.numPointsInLod.clear();
  lods.numPointsInLod.push_back(uint32_t(pointCount));
  lods.indexes.clear();
  lods.indexes.reserve(size_t(pointCount));

  const int32_t log2CubeSize = 7;
  MortonIndexMap3d atlas;
  atlas.resize(log2CubeSize);
  atlas.init();

  // inter prediction atlas is 8x finer (interLog2CubeSize = 3)
  MortonIndexMap3d interAtlas;
  if (interRef) {
    interAtlas.resize(3);
    interAtlas.init();
  }

  const int maxNumDetailLevels = pp.maxNumDetailLevels();
  int32_t predIndex = pointCount;
  for (int32_t lodIndex = 0;
       !input.empty() && lodIndex < maxNumDetailLevels; ++lodIndex) {
    const int32_t startIndex = int32_t(lods.indexes.size());
    if (lodIndex == maxNumDetailLevels - 1) {
      for (const auto index : input) lods.indexes.push_back(index);
    } else {
      subsample(pp, samplingPeriods, packedVoxel, input, lodIndex, retained,
                lods.indexes, atlas);
    }
    const int32_t endIndex = int32_t(lods.indexes.size());

    computeNearestNeighbors(
      pp, packedVoxel, retained, startIndex, endIndex, lodIndex,
      lods.indexes, lods.predictors, pointIndexToPredictorIndex, predIndex,
      atlas, biasedPos, interRef, &packedVoxelRef, &biasedPosRef,
      &interAtlas, interSearchRange);

    if (!retained.empty())
      lods.numPointsInLod.push_back(uint32_t(retained.size()));
    input.resize(0);
    std::swap(retained, input);
  }
  std::reverse(lods.indexes.begin(), lods.indexes.end());
  updatePredictors(pointIndexToPredictorIndex, lods.predictors,
                   interRef ? frameDistance : 0);
  if (packedVoxelRefOut) packedVoxelRefOut->swap(packedVoxelRef);
  std::reverse(lods.numPointsInLod.begin(), lods.numPointsInLod.end());
}

// AttributeLods::generate tail (AttributeCommon.cpp:66-72)
static void generateLods(const PlParams& pp, const int32_t* samplingPeriods,
                         const std::vector<V3>& positions, Lods& lods,
                         const std::vector<V3>* positionsRef = nullptr,
                         int32_t interSearchRange = 0) {
  buildPredictorsFast(pp, samplingPeriods, positions, lods, positionsRef,
                      interSearchRange);
  const bool interRef = positionsRef != nullptr;
  for (auto& predictor : lods.predictors) {
    predictor.computeWeights();
    if (pp.attrEncoding == 1 && pp.predWeightBlending)
      predictor.blendWeights(positions, lods.indexes, interRef,
                             positionsRef);
  }
}

// ---------------------------------------------------------------------------
// quantisation weights + lift sweeps (PCCTMC3Common.h:717-924)
// ---------------------------------------------------------------------------

// computeQuantizationWeights with per-rank neighbour weights
// (PCCTMC3Common.h:895-924, the predicting transform's variant)
static void computeQuantWeightsPred(
  const std::vector<Predictor>& predictors, const int neighWeight[3],
  std::vector<uint64_t>& quantWeights, bool interRef = false) {
  const size_t pointCount = predictors.size();
  quantWeights.assign(pointCount, 1ull << kFixedPointWeightShift);
  for (size_t i = 0; i < pointCount; ++i) {
    const size_t predictorIndex = pointCount - i - 1;
    const auto& predictor = predictors[predictorIndex];
    const auto currentQuantWeight = quantWeights[predictorIndex];
    for (uint32_t j = 0; j < predictor.neighborCount; ++j) {
      if (interRef && predictor.neighbors[j].interFrameRef) continue;
      const size_t neighborPredIndex = predictor.neighbors[j].predictorIndex;
      quantWeights[neighborPredIndex] += divExp2RoundHalfInfU(
        uint64_t(neighWeight[j]) * currentQuantWeight,
        kFixedPointWeightShift);
    }
  }
}

// PCCComputeQuantizationWeights (PCCTMC3Common.h:828-857, lifting)
static void computeQuantWeightsLift(
  const std::vector<Predictor>& predictors,
  std::vector<uint64_t>& quantWeights, bool interRef = false) {
  const size_t pointCount = predictors.size();
  quantWeights.assign(pointCount, 1ull << kFixedPointWeightShift);
  for (size_t i = 0; i < pointCount; ++i) {
    const size_t predictorIndex = pointCount - i - 1;
    const auto& predictor = predictors[predictorIndex];
    const auto currentQuantWeight = quantWeights[predictorIndex];
    for (uint32_t j = 0; j < predictor.neighborCount; ++j) {
      if (interRef && predictor.neighbors[j].interFrameRef) continue;
      const size_t neighborPredIndex = predictor.neighbors[j].predictorIndex;
      quantWeights[neighborPredIndex] += divExp2RoundHalfInfU(
        predictor.neighbors[j].weight * currentQuantWeight,
        kFixedPointWeightShift);
    }
  }
}

// PCCLiftPredict (PCCTMC3Common.h:717-756); T = int64 x dims
static void liftPredict(
  const std::vector<Predictor>& predictors, size_t startIndex,
  size_t endIndex, bool direct, std::vector<int64_t>& attributes, int dims,
  bool interRef = false,
  const std::vector<int64_t>* attributesRef = nullptr) {
  const size_t predictorCount = endIndex - startIndex;
  for (size_t index = 0; index < predictorCount; ++index) {
    const size_t predictorIndex = predictorCount - index - 1 + startIndex;
    const auto& predictor = predictors[predictorIndex];
    for (int c = 0; c < dims; c++) {
      int64_t predicted = 0;
      for (uint32_t i = 0; i < predictor.neighborCount; ++i) {
        if (interRef && predictor.neighbors[i].interFrameRef) {
          // reference attributes indexed by raw reference point index
          const size_t refIdx = predictor.neighbors[i].pointIndex;
          predicted += int64_t(predictor.neighbors[i].weight)
            * (*attributesRef)[refIdx * size_t(dims) + size_t(c)];
          continue;
        }
        const size_t neighborPredIndex =
          predictor.neighbors[i].predictorIndex;
        predicted += int64_t(predictor.neighbors[i].weight)
          * attributes[neighborPredIndex * size_t(dims) + size_t(c)];
      }
      predicted = divExp2RoundHalfInf(predicted, kFixedPointWeightShift);
      auto& attribute = attributes[predictorIndex * size_t(dims) + size_t(c)];
      if (direct) attribute -= predicted;
      else attribute += predicted;
    }
  }
}

// PCCLiftUpdate (PCCTMC3Common.h:775-826)
static void liftUpdate(
  const std::vector<Predictor>& predictors,
  const std::vector<uint64_t>& quantizationWeights, size_t startIndex,
  size_t endIndex, bool direct, std::vector<int64_t>& attributes, int dims,
  bool interRef = false) {
  std::vector<uint64_t> updateWeights(startIndex, 0);
  std::vector<int64_t> updates(startIndex * size_t(dims), 0);
  const size_t predictorCount = endIndex - startIndex;
  for (size_t index = 0; index < predictorCount; ++index) {
    const size_t predictorIndex = predictorCount - index - 1 + startIndex;
    const auto& predictor = predictors[predictorIndex];
    const auto currentQuantWeight = quantizationWeights[predictorIndex];
    for (uint32_t i = 0; i < predictor.neighborCount; ++i) {
      if (interRef && predictor.neighbors[i].interFrameRef) continue;
      const size_t neighborPredIndex = predictor.neighbors[i].predictorIndex;
      const uint64_t weight = divExp2RoundHalfInfU(
        predictor.neighbors[i].weight * currentQuantWeight,
        kFixedPointWeightShift);
      updateWeights[neighborPredIndex] += weight;
      for (int c = 0; c < dims; c++)
        updates[neighborPredIndex * size_t(dims) + size_t(c)] +=
          int64_t(weight)
          * attributes[predictorIndex * size_t(dims) + size_t(c)];
    }
  }
  for (size_t predictorIndex = 0; predictorIndex < startIndex;
       ++predictorIndex) {
    const uint32_t sumWeights = uint32_t(updateWeights[predictorIndex]);
    if (sumWeights) {
      for (int c = 0; c < dims; c++) {
        auto& update = updates[predictorIndex * size_t(dims) + size_t(c)];
        update = divApprox(update, sumWeights, 0);
        auto& attribute =
          attributes[predictorIndex * size_t(dims) + size_t(c)];
        if (direct) attribute += update;
        else attribute -= update;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// quantiser (quantization.{h,cpp}; tables.cpp:478-481)
// ---------------------------------------------------------------------------

static const int16_t kQpStep[6] = {161, 181, 203, 228, 256, 287};
static const int32_t kQpStepRecip[6] = {416825, 370767, 330586,
                                        294337, 262144, 233829};

struct Quant {
  int stepSize_ = 0;
  int64_t stepSizeRecip_ = 0;
  Quant() = default;
  explicit Quant(int qp) {
    qp = std::max(qp, 4);
    int qpShift = qp / 6;
    stepSize_ = kQpStep[qp % 6] << qpShift;
    stepSizeRecip_ = int64_t(kQpStepRecip[qp % 6]) >> qpShift;
  }
  int64_t stepSize() const { return stepSize_; }
  int64_t scale(int64_t x) const { return x * stepSize_; }
  int64_t quantize(int64_t x) const {
    int64_t fracBits = 18 + kFixedPointAttributeShift;
    int64_t offset = (1ll << fracBits) / 3;
    if (x >= 0) return (x * stepSizeRecip_ + offset) >> fracBits;
    return -((offset - x * stepSizeRecip_) >> fracBits);
  }
};

// QpSet (quantization.cpp:144-178): lift adds fixedPointQpOffset=24
struct QpSet {
  std::vector<std::array<int, 2>> layers;
  int maxQp = 51;
  int fixedPointQpOffset = 0;
  void quantizers(int qpLayer, Quant q[2]) const {
    int qp0 = std::min(std::max(layers[size_t(qpLayer)][0], 4), maxQp);
    int qp1 =
      std::min(std::max(layers[size_t(qpLayer)][1] + qp0, 4), maxQp);
    q[0] = Quant(qp0 + fixedPointQpOffset);
    q[1] = Quant(qp1 + fixedPointQpOffset);
  }
};

// ---------------------------------------------------------------------------
// residual entropy coder (PCCResidualsDecoder/Encoder,
// AttributeDecoder.cpp:53-172, AttributeEncoder.cpp:228-307; contexts
// AttributeCommon.h:49-58) - same context layout as refattr.cc
// ---------------------------------------------------------------------------

struct AttrCtx {
  uint16_t runLen[5];
  uint16_t coeffGtN[2][7];
  uint16_t remPrefix[2][3];
  uint16_t remSuffix[2][3];
  void init() {
    for (auto& c : runLen) c = 0x8000;
    for (auto& r : coeffGtN) for (auto& c : r) c = 0x8000;
    for (auto& r : remPrefix) for (auto& c : r) c = 0x8000;
    for (auto& r : remSuffix) for (auto& c : r) c = 0x8000;
  }
};

static unsigned expGolombCtxDec(ArithDec& aec, int k, uint16_t* ctxPrefix,
                                int numPrefix, uint16_t* ctxSuffix,
                                int numSuffix) {
  const int k0 = k;
  unsigned l;
  int symbol = 0;
  int binary = 0;
  do {
    l = unsigned(aec.bit(&ctxPrefix[std::min(numPrefix - 1, k - k0)]));
    if (l == 1) {
      symbol += 1 << k;
      k++;
    }
  } while (l != 0);
  while (k--)
    binary |= aec.bit(&ctxSuffix[std::min(numSuffix - 1, k)]) << k;
  return unsigned(symbol + binary);
}

static int decodeRunLength(ArithDec& aec, AttrCtx& ctx) {
  int runLength = 0;
  uint16_t* c = ctx.runLen;
  for (; runLength < 3; runLength++, c++)
    if (!aec.bit(c)) return runLength;
  for (int i = 0; i < 4; i++) {
    if (!aec.bit(c)) {
      runLength += aec.bypass();
      return runLength;
    }
    runLength += 2;
  }
  runLength += int(aec.exp_golomb(2, ++c));
  return runLength;
}

static int decodeSymbol(ArithDec& aec, AttrCtx& ctx, int k1, int k2, int k3) {
  if (!aec.bit(&ctx.coeffGtN[0][k1])) return 0;
  if (!aec.bit(&ctx.coeffGtN[1][k2])) return 1;
  int rem = int(expGolombCtxDec(aec, 1, ctx.remPrefix[k3], 3,
                                ctx.remSuffix[k3], 3));
  return rem + 2;
}

static void decodeTriplet(ArithDec& aec, AttrCtx& ctx, int32_t value[3]) {
  value[1] = decodeSymbol(aec, ctx, 0, 0, 1);
  int b0 = value[1] == 0;
  int b1 = value[1] <= 1;
  value[2] = decodeSymbol(aec, ctx, 1 + b0, 1 + b1, 1);
  int b2 = value[2] == 0;
  int b3 = value[2] <= 1;
  value[0] =
    decodeSymbol(aec, ctx, 3 + (b0 << 1) + b2, 3 + (b1 << 1) + b3, 0);
  if (b0 && b2) value[0] += 1;
  if (value[0] && aec.bypass()) value[0] = -value[0];
  if (value[1] && aec.bypass()) value[1] = -value[1];
  if (value[2] && aec.bypass()) value[2] = -value[2];
}

static int32_t decodeScalar(ArithDec& aec, AttrCtx& ctx) {
  int32_t mag = decodeSymbol(aec, ctx, 0, 0, 0) + 1;
  return aec.bypass() ? -mag : mag;
}

// ---------------------------------------------------------------------------
// prediction (PCCPredictor::predictColor/-Reflectance :526-588,
// predModeEligible AttributeCommon.cpp:145-215, decodePredMode
// AttributeDecoder.cpp:288-322 refl / :119-161 colour)
// ---------------------------------------------------------------------------

static void predictAttr(
  const Predictor& predictor, const std::vector<int32_t>& attrs, int dims,
  const std::vector<uint32_t>& indexes, int64_t predicted[3],
  bool interRef = false,
  const std::vector<int32_t>* attrsRef = nullptr) {
  // with inter prediction both frames resolve by raw pointIndex
  // (PCCTMC3Common.h:556-586)
  for (int k = 0; k < dims; k++) predicted[k] = 0;
  if (int(predictor.predMode) > int(predictor.neighborCount)) {
    // nop: zero prediction
  } else if (predictor.predMode > 0) {
    const auto& nb = predictor.neighbors[predictor.predMode - 1];
    const std::vector<int32_t>& src =
      (interRef && nb.interFrameRef) ? *attrsRef : attrs;
    const uint32_t pi =
      interRef ? nb.pointIndex : indexes[nb.predictorIndex];
    for (int k = 0; k < dims; k++)
      predicted[k] = src[size_t(pi) * size_t(dims) + size_t(k)];
  } else {
    for (uint32_t i = 0; i < predictor.neighborCount; ++i) {
      const auto& nb = predictor.neighbors[i];
      const std::vector<int32_t>& src =
        (interRef && nb.interFrameRef) ? *attrsRef : attrs;
      const uint32_t pi =
        interRef ? nb.pointIndex : indexes[nb.predictorIndex];
      const uint32_t w = uint32_t(nb.weight);
      for (int k = 0; k < dims; k++)
        predicted[k] +=
          int64_t(w) * src[size_t(pi) * size_t(dims) + size_t(k)];
    }
    for (int k = 0; k < dims; k++)
      predicted[k] = divExp2RoundHalfInf(predicted[k],
                                         kFixedPointWeightShift);
  }
}

static bool predModeEligible(
  const PlParams& pp, const Predictor& predictor,
  const std::vector<int32_t>& attrs, int dims,
  const std::vector<uint32_t>& indexes, bool interRef = false,
  const std::vector<int32_t>* attrsRef = nullptr) {
  if (predictor.neighborCount <= 1 || !pp.maxNumDirectPredictors)
    return false;
  int64_t maxDiff = 0;
  for (int k = 0; k < dims; k++) {
    int64_t mn = 0, mx = 0;
    for (uint32_t i = 0; i < predictor.neighborCount; ++i) {
      const auto& nb = predictor.neighbors[i];
      const std::vector<int32_t>& srcA =
        (interRef && nb.interFrameRef) ? *attrsRef : attrs;
      const size_t pi =
        interRef ? nb.pointIndex : indexes[nb.predictorIndex];
      const int64_t v = srcA[pi * size_t(dims) + size_t(k)];
      if (i == 0 || v < mn) mn = v;
      if (i == 0 || v > mx) mx = v;
    }
    maxDiff = std::max(maxDiff, mx - mn);
  }
  const int threshold = pp.adaptivePredictionThreshold
    << std::max(0, pp.bitdepth - 8);
  return maxDiff >= threshold;
}

// decodePredModeRefl (AttributeDecoder.cpp:288-322)
static void decodePredModeRefl(const PlParams& pp, int32_t& coeff,
                               Predictor& predictor) {
  int coeffAbs = std::abs(coeff);
  int coeffSign = coeff < 0 ? -1 : 1;
  int mode;
  int maxcand = pp.maxNumDirectPredictors + !pp.directAvgPredictorDisabled;
  switch (maxcand) {
  case 4:
    mode = coeffAbs & 3;
    coeff = coeffSign * (coeffAbs >> 2);
    break;
  case 3:
    mode = coeffAbs & 1;
    coeffAbs >>= 1;
    if (mode > 0) {
      mode += coeffAbs & 1;
      coeffAbs >>= 1;
    }
    coeff = coeffSign * coeffAbs;
    break;
  case 2:
    mode = coeffAbs & 1;
    coeff = coeffSign * (coeffAbs >> 1);
    break;
  default:
    mode = 0;
  }
  predictor.predMode = int8_t(mode + pp.directAvgPredictorDisabled);
}

// decodePredModeColor (AttributeDecoder.cpp:119-161)
static void decodePredModeColor(const PlParams& pp, int32_t coeff[3],
                                Predictor& predictor) {
  int signk1 = coeff[1] < 0 ? -1 : 1;
  int signk2 = coeff[2] < 0 ? -1 : 1;
  int coeffAbsk1 = std::abs(coeff[1]);
  int coeffAbsk2 = std::abs(coeff[2]);
  int mode;
  int maxcand = pp.maxNumDirectPredictors + !pp.directAvgPredictorDisabled;
  switch (maxcand) {
    int parityk1, parityk2;
  case 4:
    parityk1 = coeffAbsk1 & 1;
    parityk2 = coeffAbsk2 & 1;
    coeff[1] = signk1 * (coeffAbsk1 >> 1);
    coeff[2] = signk2 * (coeffAbsk2 >> 1);
    mode = (parityk1 << 1) + parityk2;
    break;
  case 3:
    parityk1 = coeffAbsk1 & 1;
    coeff[1] = signk1 * (coeffAbsk1 >> 1);
    mode = parityk1;
    if (parityk1) {
      parityk2 = coeffAbsk2 & 1;
      coeff[2] = signk2 * (coeffAbsk2 >> 1);
      mode += parityk2;
    }
    break;
  case 2:
    parityk1 = coeffAbsk1 & 1;
    coeff[1] = signk1 * (coeffAbsk1 >> 1);
    mode = parityk1;
    break;
  default:
    mode = 0;
  }
  predictor.predMode = int8_t(mode + pp.directAvgPredictorDisabled);
}

}  // namespace refpl

// ---------------------------------------------------------------------------
// brick decode entry (AttributeDecoder::decode, AttributeDecoder.cpp:193+)
// ---------------------------------------------------------------------------

using namespace refpl;

static void plparams_from(const int32_t* p, PlParams& pp) {
  pp.dims = p[0];
  pp.bitdepth = p[1];
  pp.attrEncoding = p[2];
  pp.initQp = p[3];
  pp.chromaQpOffset = p[4];
  pp.numPredNearestNeighboursMinus1 = p[5];
  pp.interLodSearchRange = p[6];
  pp.lodNeighBias = {{p[7], p[8], p[9]}};
  pp.lastComponentPrediction = p[10];
  pp.numDetailLevelsMinus1 = p[11];
  pp.canonicalPointOrder = p[12];
  pp.lodDecimationType = p[13];
  pp.dist2 = p[14];
  pp.dist2Delta = p[15];
  pp.maxNumDirectPredictors = p[16];
  pp.adaptivePredictionThreshold = p[17];
  pp.directAvgPredictorDisabled = p[18];
  pp.intraLodPredictionSkipLayers = p[19];
  pp.intraLodSearchRange = p[20];
  pp.interComponentPrediction = p[21];
  pp.predWeightBlending = p[22];
  pp.quantNeighWeight[0] = p[23];
  pp.quantNeighWeight[1] = p[24];
  pp.quantNeighWeight[2] = p[25];
  pp.maxPointsPerSortLog2Plus1 = p[26];
  pp.predictionWithDistribution = p[27];
  pp.bypassNoUpdate = p[28];
  pp.qpLayersCount = p[29];
  pp.chunked = p[30];
}

// returns number of values written (npts*dims) or <0 on error
static int decode_predlift_impl(
  const int32_t* positions, int npts, const int32_t* params,
  const int32_t* sampling_periods, const int32_t* layer_qps,
  const int32_t* lcp_coeffs, const int32_t* icp_coeffs,
  const uint8_t* aec_buf, int aec_len, int32_t* out_attrs,
  // attribute inter prediction (abh.enableAttrInterPred): previous
  // frame's attribute-coordinate cloud, already bbox-filtered
  // (decoder.cpp:926-947); nref = 0 disables
  const int32_t* ref_positions, const int32_t* ref_attrs, int nref,
  int inter_search_range) {
  PlParams pp;
  plparams_from(params, pp);
  const int dims = pp.dims;
  const bool interRef = nref > 0;
  if (interRef && dims != 1)
    return -3;  // reference supports inter predlift for scalars only

  std::vector<V3> positionsV = std::vector<V3>(size_t(npts));
  for (int i = 0; i < npts; i++)
    positionsV[size_t(i)] = {{positions[i * 3], positions[i * 3 + 1],
                              positions[i * 3 + 2]}};

  std::vector<V3> positionsRefV = std::vector<V3>(size_t(std::max(nref, 0)));
  std::vector<int32_t> attrsRef(size_t(std::max(nref, 0)) * size_t(dims));
  for (int i = 0; i < nref; i++) {
    positionsRefV[size_t(i)] = {{ref_positions[i * 3],
                                 ref_positions[i * 3 + 1],
                                 ref_positions[i * 3 + 2]}};
    for (int k = 0; k < dims; k++)
      attrsRef[size_t(i) * size_t(dims) + size_t(k)] =
        ref_attrs[i * dims + k];
  }

  Lods lods;
  generateLods(pp, sampling_periods, positionsV, lods,
               interRef ? &positionsRefV : nullptr, inter_search_range);

  QpSet qpSet;
  qpSet.maxQp = 51 + 6 * (pp.bitdepth - 8);
  qpSet.fixedPointQpOffset =
    pp.attrEncoding == 2 ? (kFixedPointWeightShift / 2) * 6 : 0;
  for (int l = 0; l < pp.qpLayersCount; l++)
    qpSet.layers.push_back({layer_qps[2 * l], layer_qps[2 * l + 1]});

  ArithDec aec;
  aec.chunked = pp.chunked != 0;
  aec.init(aec_buf, size_t(aec_len));
  aec.bypassNoUpdate = pp.bypassNoUpdate != 0;
  AttrCtx ctx;
  ctx.init();

  const size_t pointCount = size_t(npts);
  const int64_t clipMax = (1ll << pp.bitdepth) - 1;
  const auto& numPointsInLod = lods.numPointsInLod;
  const auto& indexes = lods.indexes;
  auto& predictors = lods.predictors;

  if (pp.attrEncoding == 1) {
    // predicting transform (AttributeDecoder.cpp:328-392 refl,
    // :446-527 colour)
    std::vector<uint64_t> quantWeights;
    computeQuantWeightsPred(predictors, pp.quantNeighWeight, quantWeights,
                            interRef);

    std::vector<int32_t> attrs(pointCount * size_t(dims), 0);
    int zeroRunRem = 0;
    int quantLayer = 0;
    int lod = 0;
    int64_t icp[3] = {0, 0, 0};
    const bool icpOn = pp.interComponentPrediction && dims == 3;
    if (icpOn && icp_coeffs)
      for (int k = 0; k < 3; k++) icp[k] = icp_coeffs[k];

    for (size_t predictorIndex = 0; predictorIndex < pointCount;
         ++predictorIndex) {
      if (predictorIndex == numPointsInLod[size_t(quantLayer)])
        quantLayer = std::min(int(qpSet.layers.size()) - 1, quantLayer + 1);
      const uint32_t pointIndex = indexes[predictorIndex];
      Quant quant[2];
      qpSet.quantizers(quantLayer, quant);
      auto& predictor = predictors[predictorIndex];
      predictor.predMode = 0;

      if (--zeroRunRem < 0) zeroRunRem = decodeRunLength(aec, ctx);

      if (dims == 1) {
        int32_t attValue0 = 0;
        if (!zeroRunRem) attValue0 = decodeScalar(aec, ctx);
        if (predModeEligible(pp, predictor, attrs, dims, indexes,
                             interRef, &attrsRef))
          decodePredModeRefl(pp, attValue0, predictor);
        int64_t predicted[3];
        predictAttr(predictor, attrs, dims, indexes, predicted, interRef,
                    &attrsRef);
        int64_t qStep = quant[0].stepSize();
        int64_t weight =
          std::min(int64_t(quantWeights[predictorIndex]), qStep)
          >> kFixedPointWeightShift;
        int64_t delta = divExp2RoundHalfUp(quant[0].scale(attValue0),
                                           kFixedPointAttributeShift);
        delta /= weight;
        const int64_t recon = predicted[0] + delta;
        attrs[size_t(pointIndex)] =
          int32_t(std::min(std::max(recon, int64_t(0)), clipMax));
      } else {
        int32_t values[3] = {0, 0, 0};
        if (!zeroRunRem) decodeTriplet(aec, ctx, values);
        if (predModeEligible(pp, predictor, attrs, dims, indexes))
          decodePredModeColor(pp, values, predictor);
        int64_t predicted[3];
        predictAttr(predictor, attrs, dims, indexes, predicted);
        if (icpOn && icp_coeffs
            && predictorIndex == numPointsInLod[size_t(lod)]) {
          ++lod;
          for (int k = 0; k < 3; k++) icp[k] = icp_coeffs[3 * lod + k];
        }
        int64_t residual0 = 0;
        for (int k = 0; k < 3; ++k) {
          const auto& q = quant[std::min(k, 1)];
          int64_t qStep = q.stepSize();
          int64_t weight =
            std::min(int64_t(quantWeights[predictorIndex]), qStep)
            >> kFixedPointWeightShift;
          int64_t residual = divExp2RoundHalfUp(
            q.scale(values[k]), kFixedPointAttributeShift);
          residual /= weight;
          const int64_t recon =
            predicted[k] + residual + ((icp[k] * residual0 + 2) >> 2);
          attrs[size_t(pointIndex) * 3 + size_t(k)] =
            int32_t(std::min(std::max(recon, int64_t(0)), clipMax));
          if (!k && pp.interComponentPrediction) residual0 = residual;
        }
      }
    }
    for (size_t i = 0; i < pointCount * size_t(dims); i++)
      out_attrs[i] = attrs[i];
    return int(pointCount) * dims;
  }

  if (pp.attrEncoding == 2) {
    // lifting transform (AttributeDecoder.cpp:679-773 colour,
    // :775-861 refl)
    std::vector<uint64_t> weights;
    computeQuantWeightsLift(predictors, weights, interRef);
    const size_t lodCount = numPointsInLod.size();
    std::vector<int64_t> vals(pointCount * size_t(dims), 0);

    // reference attributes enter the lift in fixed point
    // (AttributeDecoder.cpp:803-812)
    std::vector<int64_t> valsRef(attrsRef.size());
    for (size_t i = 0; i < attrsRef.size(); i++)
      valsRef[i] = int64_t(attrsRef[i]) << kFixedPointAttributeShift;

    int lod = 0;
    int64_t lastCompPredCoeff = 0;
    const bool lcpOn = pp.lastComponentPrediction && dims == 3;
    if (lcpOn && lcp_coeffs) lastCompPredCoeff = lcp_coeffs[0];

    int zeroRunRem = 0;
    int quantLayer = 0;
    for (size_t predictorIndex = 0; predictorIndex < pointCount;
         ++predictorIndex) {
      if (predictorIndex == numPointsInLod[size_t(quantLayer)])
        quantLayer = std::min(int(qpSet.layers.size()) - 1, quantLayer + 1);
      if (lcpOn && predictorIndex == numPointsInLod[size_t(lod)]) {
        lod++;
        if (lcp_coeffs) lastCompPredCoeff = lcp_coeffs[lod];
      }
      Quant quant[2];
      qpSet.quantizers(quantLayer, quant);

      if (--zeroRunRem < 0) zeroRunRem = decodeRunLength(aec, ctx);

      if (dims == 1) {
        int64_t detail = 0;
        if (!zeroRunRem) detail = decodeScalar(aec, ctx);
        const int64_t iQuantWeight =
          int64_t(tmc13ref_irsqrt(weights[predictorIndex]));
        const int64_t reconstructedDelta = quant[0].scale(detail);
        vals[predictorIndex] =
          divExp2RoundHalfInf(reconstructedDelta * iQuantWeight, 40);
      } else {
        int32_t values[3] = {0, 0, 0};
        if (!zeroRunRem) decodeTriplet(aec, ctx, values);
        const int64_t iQuantWeight =
          int64_t(tmc13ref_irsqrt(weights[predictorIndex]));
        int64_t scaled = quant[0].scale(values[0]);
        vals[predictorIndex * 3] =
          divExp2RoundHalfInf(scaled * iQuantWeight, 40);
        scaled = quant[1].scale(values[1]);
        vals[predictorIndex * 3 + 1] =
          divExp2RoundHalfInf(scaled * iQuantWeight, 40);
        scaled *= lastCompPredCoeff;
        scaled >>= 2;
        scaled += quant[1].scale(values[2]);
        vals[predictorIndex * 3 + 2] =
          divExp2RoundHalfInf(scaled * iQuantWeight, 40);
      }
    }

    for (size_t lodIndex = 1; lodIndex < lodCount; ++lodIndex) {
      const size_t startIndex = numPointsInLod[lodIndex - 1];
      const size_t endIndex = numPointsInLod[lodIndex];
      liftUpdate(predictors, weights, startIndex, endIndex, false, vals,
                 dims, interRef);
      liftPredict(predictors, startIndex, endIndex, false, vals, dims,
                  interRef, &valsRef);
    }

    for (size_t f = 0; f < pointCount; ++f) {
      for (int k = 0; k < dims; k++) {
        const int64_t v = divExp2RoundHalfInf(
          vals[f * size_t(dims) + size_t(k)], kFixedPointAttributeShift);
        out_attrs[size_t(indexes[f]) * size_t(dims) + size_t(k)] =
          int32_t(std::min(std::max(v, int64_t(0)), clipMax));
      }
    }
    return int(pointCount) * dims;
  }

  return -2;
}

extern "C" int tmc13ref_decode_predlift(
  const int32_t* positions, int npts, const int32_t* params,
  const int32_t* sampling_periods, const int32_t* layer_qps,
  const int32_t* lcp_coeffs, const int32_t* icp_coeffs,
  const uint8_t* aec_buf, int aec_len, int32_t* out_attrs) {
  return decode_predlift_impl(
    positions, npts, params, sampling_periods, layer_qps, lcp_coeffs,
    icp_coeffs, aec_buf, aec_len, out_attrs, nullptr, nullptr, 0, 0);
}

// inter-frame form: ref cloud in attribute coordinates + its decoded
// attributes (decoder.cpp:817-947)
extern "C" int tmc13ref_decode_predlift_inter(
  const int32_t* positions, int npts, const int32_t* params,
  const int32_t* sampling_periods, const int32_t* layer_qps,
  const int32_t* lcp_coeffs, const int32_t* icp_coeffs,
  const uint8_t* aec_buf, int aec_len, int32_t* out_attrs,
  const int32_t* ref_positions, const int32_t* ref_attrs, int nref,
  int inter_search_range) {
  return decode_predlift_impl(
    positions, npts, params, sampling_periods, layer_qps, lcp_coeffs,
    icp_coeffs, aec_buf, aec_len, out_attrs, ref_positions, ref_attrs,
    nref, inter_search_range);
}

// ---------------------------------------------------------------------------
// encode direction (PCCResidualsEncoder, AttributeEncoder.cpp:60-307;
// mode RD :663-992; ICP/LCP derivation :994-1075, 1499-1542)
// ---------------------------------------------------------------------------

namespace refpl {

static void expGolombEncCtx(ArithEnc& aec, unsigned symbol, int k,
                            uint16_t* ctxPrefix, int numPrefix,
                            uint16_t* ctxSuffix, int numSuffix) {
  const int k0 = k;
  while (symbol >= (1u << k)) {
    aec.bit(&ctxPrefix[std::min(numPrefix - 1, k - k0)], 1);
    symbol -= 1u << k;
    k++;
  }
  aec.bit(&ctxPrefix[std::min(numPrefix - 1, k - k0)], 0);
  while (k--)
    aec.bit(&ctxSuffix[std::min(numSuffix - 1, k)], (symbol >> k) & 1);
}

static void encodeRunLength(ArithEnc& aec, AttrCtx& ctx, int runLength) {
  uint16_t* c = ctx.runLen;
  for (int i = 0; i < std::min(3, runLength); i++, c++) aec.bit(c, 1);
  if (runLength < 3) {
    aec.bit(c, 0);
    return;
  }
  runLength -= 3;
  auto prefix = runLength >> 1;
  for (int i = 0; i < std::min(4, prefix); i++) aec.bit(c, 1);
  if (runLength < 8) {
    aec.bit(c, 0);
    aec.bypass(runLength & 1);
    return;
  }
  runLength -= 8;
  aec.exp_golomb(unsigned(runLength), 2, ++c);
}

static void encodeSymbol(ArithEnc& aec, AttrCtx& ctx, uint32_t value,
                         int k1, int k2, int k3) {
  aec.bit(&ctx.coeffGtN[0][k1], value > 0);
  if (!value) return;
  aec.bit(&ctx.coeffGtN[1][k2], --value > 0);
  if (!value) return;
  expGolombEncCtx(aec, --value, 1, ctx.remPrefix[k3], 3,
                  ctx.remSuffix[k3], 3);
}

static void encodeTriplet(ArithEnc& aec, AttrCtx& ctx, int32_t value0,
                          int32_t value1, int32_t value2) {
  int mag0 = std::abs(value0);
  int mag1 = std::abs(value1);
  int mag2 = std::abs(value2);
  int b0 = (mag1 == 0);
  int b1 = (mag1 <= 1);
  int b2 = (mag2 == 0);
  int b3 = (mag2 <= 1);
  encodeSymbol(aec, ctx, uint32_t(mag1), 0, 0, 1);
  encodeSymbol(aec, ctx, uint32_t(mag2), 1 + b0, 1 + b1, 1);
  auto mag0minusX = (b0 && b2) ? mag0 - 1 : mag0;
  encodeSymbol(aec, ctx, uint32_t(mag0minusX), 3 + (b0 << 1) + b2,
               3 + (b1 << 1) + b3, 0);
  if (mag0) aec.bypass(value0 < 0);
  if (mag1) aec.bypass(value1 < 0);
  if (mag2) aec.bypass(value2 < 0);
}

static void encodeScalar(ArithEnc& aec, AttrCtx& ctx, int32_t value) {
  encodeSymbol(aec, ctx, uint32_t(std::abs(value) - 1), 0, 0, 0);
  aec.bypass(value < 0);
}

// residual-rate statistics (AttributeEncoder.cpp:127-160)
struct ResStat {
  static const int scaleRes = 1 << 20;
  static const int windowLog2 = 6;
  int probResGt0[3];
  int probResGt1[3];
  void reset() {
    for (int k = 0; k < 3; k++)
      probResGt0[k] = probResGt1[k] = scaleRes >> 1;
  }
  void updateColor(const int32_t v[3]) {
    for (int k = 0; k < 3; k++) {
      probResGt0[k] += v[k] ? (scaleRes - probResGt0[k]) >> windowLog2
                            : -(probResGt0[k] >> windowLog2);
      if (v[k])
        probResGt1[k] += std::abs(v[k]) > 1
          ? (scaleRes - probResGt1[k]) >> windowLog2
          : -(probResGt1[k] >> windowLog2);
    }
  }
  void updateRefl(int32_t v) {
    probResGt0[0] += v ? (scaleRes - probResGt0[0]) >> windowLog2
                       : -(probResGt0[0] >> windowLog2);
    if (v)
      probResGt1[0] += std::abs(v) > 1
        ? (scaleRes - probResGt1[0]) >> windowLog2
        : -(probResGt1[0] >> windowLog2);
  }
  double bitsPtColor(int32_t v0, int32_t v1, int32_t v2, int mode,
                     int availPredModes) const {
    int32_t value[3] = {v0, v1, v2};
    if (availPredModes == 4) {
      value[1] = 2 * std::abs(value[1]) + (mode >> 1);
      value[2] = 2 * std::abs(value[2]) + (mode & 1);
    } else if (availPredModes == 3) {
      value[1] = 2 * std::abs(value[1]) + (mode > 0);
      if (mode > 0) value[2] = 2 * std::abs(value[2]) + (mode - 1);
    } else if (availPredModes == 2) {
      value[1] = 2 * std::abs(value[1]) + (mode & 1);
    }
    const int log2scaleRes = 20;
    double bits = 0;
    for (int k = 0; k < 3; k++) {
      bits += value[k] ? log2scaleRes - std::log2(double(probResGt0[k]))
                       : log2scaleRes
                         - std::log2(double(scaleRes - probResGt0[k]));
      int mag = std::abs(value[k]);
      if (mag) {
        bits += mag > 1
          ? log2scaleRes - std::log2(double(probResGt1[k]))
          : log2scaleRes - std::log2(double(scaleRes - probResGt1[k]));
        bits += 1;
        if (mag > 1) bits += 2.0 * std::log2(double(mag) - 1.0) + 1.0;
      }
    }
    return bits;
  }
  double bitsPtRefl(int32_t v, int mode, int availPredModes) const {
    int32_t value = v;
    if (availPredModes == 4) {
      value = (std::abs(value) << 2) + mode;
    } else if (availPredModes == 3) {
      if (mode > 0) value = (std::abs(value) << 1) + (mode - 1);
      value = (std::abs(value) << 1) + (mode > 0);
    } else if (availPredModes == 2) {
      value = (std::abs(value) << 1) + (mode & 1);
    }
    const int log2scaleRes = 20;
    double bits = 0;
    bits += value ? log2scaleRes - std::log2(double(probResGt0[0]))
                  : log2scaleRes
                    - std::log2(double(scaleRes - probResGt0[0]));
    int mag = std::abs(value);
    if (mag) {
      bits += mag > 1
        ? log2scaleRes - std::log2(double(probResGt1[0]))
        : log2scaleRes - std::log2(double(scaleRes - probResGt1[0]));
      bits += 1;
      if (mag > 1) bits += 2.0 * std::log2(double(mag) - 1.0) + 1.0;
    }
    return bits;
  }
};

// encodePredModeRefl / -Color (AttributeEncoder.cpp:722-760, 952-992)
static void encodePredModeRefl(const PlParams& pp, int predMode,
                               int32_t& coeff) {
  int coeffSign = coeff < 0 ? -1 : 1;
  int coeffAbs = std::abs(coeff);
  int mode = predMode - pp.directAvgPredictorDisabled;
  int maxcand = pp.maxNumDirectPredictors + !pp.directAvgPredictorDisabled;
  switch (maxcand) {
  case 4: coeff = coeffSign * ((coeffAbs << 2) + mode); break;
  case 3:
    if (mode > 0) coeffAbs = (coeffAbs << 1) + (mode - 1);
    coeffAbs = (coeffAbs << 1) + (mode > 0);
    coeff = coeffSign * coeffAbs;
    break;
  case 2: coeff = coeffSign * ((coeffAbs << 1) + mode); break;
  default: break;
  }
}

static void encodePredModeColor(const PlParams& pp, int predMode,
                                int32_t values[3]) {
  int signk1 = values[1] < 0 ? -1 : 1;
  int signk2 = values[2] < 0 ? -1 : 1;
  int coeffAbsk1 = std::abs(values[1]);
  int coeffAbsk2 = std::abs(values[2]);
  int mode = predMode - pp.directAvgPredictorDisabled;
  int maxcand = pp.maxNumDirectPredictors + !pp.directAvgPredictorDisabled;
  // encodePredModeColor (AttributeEncoder.cpp:952-989)
  switch (maxcand) {
  case 4:
    values[1] = signk1 * ((coeffAbsk1 << 1) + (mode >> 1));
    values[2] = signk2 * ((coeffAbsk2 << 1) + (mode & 1));
    break;
  case 3: {
    int parityk1 = mode ? 1 : 0;
    values[1] = signk1 * ((coeffAbsk1 << 1) + parityk1);
    if (parityk1)
      values[2] = signk2 * ((coeffAbsk2 << 1) + (mode - parityk1));
    break;
  }
  case 2:
    values[1] = signk1 * ((coeffAbsk1 << 1) + mode);
    break;
  default: break;
  }
}

}  // namespace refpl

// ---------------------------------------------------------------------------
// brick encode entry (AttributeEncoder.cpp:750-1650)
// ---------------------------------------------------------------------------

static const double kAttrPredLambdaC = 0.14;   // AttributeEncoder.cpp:51

// returns payload length or <0; out_lcp/out_icp receive the derived
// ABH coefficient lists when applicable, recon_out (optional) the
// reconstructed attributes in cloud order
extern "C" int tmc13ref_encode_predlift(
  const int32_t* positions, int npts, const int32_t* params,
  const int32_t* sampling_periods, const int32_t* layer_qps,
  const int32_t* attrs_in, uint8_t* aec_out, int cap,
  int32_t* out_lcp, int32_t* out_icp, int32_t* recon_out) {
  PlParams pp;
  plparams_from(params, pp);
  const int dims = pp.dims;

  std::vector<V3> positionsV = std::vector<V3>(size_t(npts));
  for (int i = 0; i < npts; i++)
    positionsV[size_t(i)] = {{positions[i * 3], positions[i * 3 + 1],
                              positions[i * 3 + 2]}};

  Lods lods;
  generateLods(pp, sampling_periods, positionsV, lods);

  QpSet qpSet;
  qpSet.maxQp = 51 + 6 * (pp.bitdepth - 8);
  qpSet.fixedPointQpOffset =
    pp.attrEncoding == 2 ? (kFixedPointWeightShift / 2) * 6 : 0;
  for (int l = 0; l < pp.qpLayersCount; l++)
    qpSet.layers.push_back({layer_qps[2 * l], layer_qps[2 * l + 1]});

  ArithEnc aec;
  aec.chunked = pp.chunked != 0;
  aec.init();
  aec.bypassNoUpdate = pp.bypassNoUpdate != 0;
  AttrCtx ctx;
  ctx.init();
  ResStat rs;
  rs.reset();
  const int availPredModes =
    pp.maxNumDirectPredictors + !pp.directAvgPredictorDisabled;

  const size_t pointCount = size_t(npts);
  const int64_t clipMax = (1ll << pp.bitdepth) - 1;
  const auto& numPointsInLod = lods.numPointsInLod;
  const auto& indexes = lods.indexes;
  auto& predictors = lods.predictors;

  // working copy of the attributes (cloud order), updated in place to
  // the reconstruction as the reference does
  std::vector<int32_t> attrs(attrs_in, attrs_in + pointCount * size_t(dims));

  if (pp.attrEncoding == 1) {
    std::vector<uint64_t> quantWeights;
    computeQuantWeightsPred(predictors, pp.quantNeighWeight, quantWeights);

    const bool icpOn = pp.interComponentPrediction && dims == 3;
    std::vector<std::array<int32_t, 3>> icpCoeffs;
    if (icpOn) {
      // computeInterComponentPredictionCoeffs
      // (AttributeEncoder.cpp:994-1075)
      const int maxLvls = pp.maxNumDetailLevels();
      icpCoeffs.assign(size_t(maxLvls), {0, 1, 1});
      std::vector<std::array<int32_t, 3>> residual(pointCount);
      for (size_t predIdx = 0; predIdx < pointCount; ++predIdx) {
        const auto pointIdx = indexes[predIdx];
        auto& predictor = predictors[predIdx];
        predictor.predMode = 1;
        int64_t predAttr[3];
        predictAttr(predictor, attrs, 3, indexes, predAttr);
        for (int k = 0; k < 3; k++)
          residual[predIdx][size_t(k)] = int32_t(
            attrs[size_t(pointIdx) * 3 + size_t(k)] - predAttr[k]);
        predictor.predMode = 0;
      }
      const int nWeights = 8, nShift = 2;
      int64_t sumPredCoeff[8][3] = {};
      int64_t sumOrigCoeff[3] = {};
      int lod = 0;
      for (size_t predIdx = 0; predIdx < pointCount; ++predIdx) {
        const auto& resid = residual[predIdx];
        for (int w = 0; w < nWeights; w++)
          for (int k = 1; k < 3; k++)
            sumPredCoeff[w][k] += std::abs(
              int64_t(resid[size_t(k)])
              - int64_t(icpCoeffs[size_t(lod)][size_t(k)])
                * (((w + 1) * resid[0] + 2) >> nShift));
        for (int k = 1; k < 3; k++)
          sumOrigCoeff[k] += std::abs(int64_t(resid[size_t(k)]));
        if (predIdx != numPointsInLod[size_t(lod)] - 1) continue;
        for (int k = 1; k < 3; k++) {
          int best = 0;
          for (int w = 1; w < nWeights; w++)
            if (sumPredCoeff[w][k] < sumPredCoeff[best][k]) best = w;
          int coeff = 1 + best;
          icpCoeffs[size_t(lod)][size_t(k)] *= coeff;
          if (sumPredCoeff[best][k] > sumOrigCoeff[k])
            icpCoeffs[size_t(lod)][size_t(k)] = 0;
        }
        for (int w = 0; w < nWeights; w++)
          sumPredCoeff[w][1] = sumPredCoeff[w][2] = 0;
        sumOrigCoeff[1] = sumOrigCoeff[2] = 0;
        lod++;
      }
      for (; lod < maxLvls; lod++)
        icpCoeffs[size_t(lod)] = {0, 0, 0};
      if (out_icp)
        for (int l = 0; l < maxLvls; l++)
          for (int k = 0; k < 3; k++)
            out_icp[3 * l + k] = icpCoeffs[size_t(l)][size_t(k)];
    }

    std::vector<int32_t> residual0s(pointCount * size_t(dims));
    std::vector<int> zerorun;
    int zeroRunAcc = 0;
    int quantLayer = 0;
    int lod = 0;
    int64_t icp[3] = {0, 0, 0};
    if (icpOn) for (int k = 0; k < 3; k++) icp[k] = icpCoeffs[0][size_t(k)];

    for (size_t predictorIndex = 0; predictorIndex < pointCount;
         ++predictorIndex) {
      if (predictorIndex == numPointsInLod[size_t(quantLayer)])
        quantLayer = std::min(int(qpSet.layers.size()) - 1, quantLayer + 1);
      if (icpOn && predictorIndex == numPointsInLod[size_t(lod)]) {
        ++lod;
        for (int k = 0; k < 3; k++) icp[k] = icpCoeffs[size_t(lod)][size_t(k)];
      }
      const uint32_t pointIndex = indexes[predictorIndex];
      Quant quant[2];
      qpSet.quantizers(quantLayer, quant);
      auto& predictor = predictors[predictorIndex];
      predictor.predMode = 0;

      const bool eligible =
        predModeEligible(pp, predictor, attrs, dims, indexes);

      if (dims == 1) {
        // decidePredModeRefl (AttributeEncoder.cpp:663-718)
        const int64_t attrValue = attrs[size_t(pointIndex)];
        if (eligible) {
          int startpredIndex = pp.directAvgPredictorDisabled;
          predictor.predMode = int8_t(startpredIndex);
          int64_t attrPred[3];
          predictAttr(predictor, attrs, 1, indexes, attrPred);
          int64_t resQ = quant[0].quantize(
            (attrValue - attrPred[0]) << kFixedPointAttributeShift);
          int mode = predictor.predMode - pp.directAvgPredictorDisabled;
          // the reference stores the (double) bit estimate in an
          // int64_t, so equal-integer-part ties keep the earlier mode
          // (AttributeEncoder.cpp:689) — truncate to stay bug-compatible
          int64_t best_score = int64_t(
            rs.bitsPtRefl(int32_t(resQ), mode, availPredModes));
          for (int i = startpredIndex;
               i < int(predictor.neighborCount); i++) {
            if (i == pp.maxNumDirectPredictors) break;
            int64_t ap = attrs[size_t(
              indexes[predictor.neighbors[i].predictorIndex])];
            resQ = quant[0].quantize(
              (attrValue - ap) << kFixedPointAttributeShift);
            mode = i + !pp.directAvgPredictorDisabled;
            int64_t score = int64_t(
              rs.bitsPtRefl(int32_t(resQ), mode, availPredModes));
            if (score < best_score) {
              best_score = score;
              predictor.predMode = int8_t(i + 1);
            }
          }
        }
        int64_t attrPred[3];
        predictAttr(predictor, attrs, 1, indexes, attrPred);
        int64_t qStep = quant[0].stepSize();
        int64_t weight =
          std::min(int64_t(quantWeights[predictorIndex]), qStep)
          >> kFixedPointWeightShift;
        const int64_t delta = quant[0].quantize(
          ((attrValue - attrPred[0]) * weight)
          << kFixedPointAttributeShift);
        int32_t attValue0 = int32_t(delta);
        int64_t reconstructedDelta = divExp2RoundHalfUp(
          quant[0].scale(delta), kFixedPointAttributeShift);
        reconstructedDelta /= weight;
        if (eligible)
          encodePredModeRefl(pp, predictor.predMode, attValue0);
        const int64_t recon = attrPred[0] + reconstructedDelta;
        attrs[size_t(pointIndex)] =
          int32_t(std::min(std::max(recon, int64_t(0)), clipMax));
        if (!attValue0) ++zeroRunAcc;
        else { zerorun.push_back(zeroRunAcc); zeroRunAcc = 0; }
        residual0s[predictorIndex] = attValue0;
        rs.updateRefl(attValue0);
      } else {
        // decidePredModeColor (AttributeEncoder.cpp:897-947)
        const int32_t* attrValue = &attrs[size_t(pointIndex) * 3];
        if (eligible) {
          int startpredIndex = pp.directAvgPredictorDisabled;
          predictor.predMode = int8_t(startpredIndex);
          int64_t attrPred[3];
          predictAttr(predictor, attrs, 3, indexes, attrPred);
          auto colorResiduals = [&](const int64_t pred[3],
                                    int64_t resQ[3]) {
            // computeColorResiduals (AttributeEncoder.cpp:858-894)
            resQ[0] = quant[0].quantize(
              (int64_t(attrValue[0]) - pred[0])
              << kFixedPointAttributeShift);
            const int64_t res0 = divExp2RoundHalfUp(
              quant[0].scale(resQ[0]), kFixedPointAttributeShift);
            for (int k = 1; k < 3; k++) {
              int64_t err = int64_t(attrValue[k]) - pred[k];
              if (pp.interComponentPrediction)
                err -= (icp[k] * res0 + 2) >> 2;
              resQ[k] = quant[1].quantize(
                err << kFixedPointAttributeShift);
            }
          };
          auto colorDistortion = [&](const int64_t pred[3]) {
            // computeColorDistortions (AttributeEncoder.cpp:1653-1680)
            int64_t distortion = 0;
            for (int k = 0; k < 3; k++) {
              const Quant& q = quant[std::min(k, 1)];
              int64_t residual = int64_t(attrValue[k]) - pred[k];
              int64_t residualQ = q.quantize(
                residual << kFixedPointAttributeShift);
              int64_t residualR = divExp2RoundHalfUp(
                q.scale(residualQ), kFixedPointAttributeShift);
              int64_t recon = pred[k] + residualR;
              recon = std::min(std::max(recon, int64_t(0)), clipMax);
              distortion += std::abs(int64_t(attrValue[k]) - recon);
            }
            return double(distortion);
          };
          int64_t resQ[3];
          colorResiduals(attrPred, resQ);
          double rate = rs.bitsPtColor(int32_t(resQ[0]), int32_t(resQ[1]),
                                       int32_t(resQ[2]), 0,
                                       availPredModes);
          double best_score = colorDistortion(attrPred)
            + rate * kAttrPredLambdaC
              * double(quant[0].stepSize() >> kFixedPointAttributeShift);
          for (int i = startpredIndex;
               i < int(predictor.neighborCount); i++) {
            if (i == pp.maxNumDirectPredictors) break;
            const uint32_t pi =
              indexes[predictor.neighbors[i].predictorIndex];
            int64_t ap[3] = {attrs[size_t(pi) * 3],
                             attrs[size_t(pi) * 3 + 1],
                             attrs[size_t(pi) * 3 + 2]};
            colorResiduals(ap, resQ);
            int sigIdx = i + !pp.directAvgPredictorDisabled;
            double r2 = rs.bitsPtColor(int32_t(resQ[0]), int32_t(resQ[1]),
                                       int32_t(resQ[2]), sigIdx,
                                       availPredModes);
            double score = colorDistortion(ap)
              + r2 * kAttrPredLambdaC
                * double(quant[0].stepSize() >> kFixedPointAttributeShift);
            if (score < best_score) {
              best_score = score;
              predictor.predMode = int8_t(i + 1);
            }
          }
        }
        int64_t attrPred[3];
        predictAttr(predictor, attrs, 3, indexes, attrPred);
        int32_t values[3];
        int64_t residual0 = 0;
        for (int k = 0; k < 3; ++k) {
          const Quant& q = quant[std::min(k, 1)];
          int64_t residual = int64_t(attrValue[k]) - attrPred[k];
          int64_t qStep = q.stepSize();
          int64_t weight =
            std::min(int64_t(quantWeights[predictorIndex]), qStep)
            >> kFixedPointWeightShift;
          int64_t residualQ = q.quantize(
            (residual * weight) << kFixedPointAttributeShift);
          int64_t residualR = divExp2RoundHalfUp(
            q.scale(residualQ), kFixedPointAttributeShift);
          residualR /= weight;
          if (pp.interComponentPrediction && k > 0) {
            residual = residual - ((icp[k] * residual0 + 2) >> 2);
            residualQ = q.quantize(
              (residual * weight) << kFixedPointAttributeShift);
            residualR = divExp2RoundHalfUp(
              q.scale(residualQ), kFixedPointAttributeShift);
            residualR /= weight;
            residualR += (icp[k] * residual0 + 2) >> 2;
          }
          if (k == 0) residual0 = residualR;
          values[k] = int32_t(residualQ);
          int64_t recon = attrPred[k] + residualR;
          attrs[size_t(pointIndex) * 3 + size_t(k)] =
            int32_t(std::min(std::max(recon, int64_t(0)), clipMax));
        }
        if (eligible)
          encodePredModeColor(pp, predictor.predMode, values);
        rs.updateColor(values);
        if (!values[0] && !values[1] && !values[2]) ++zeroRunAcc;
        else { zerorun.push_back(zeroRunAcc); zeroRunAcc = 0; }
        for (int k = 0; k < 3; k++)
          residual0s[predictorIndex * 3 + size_t(k)] = values[k];
      }
    }
    if (zeroRunAcc) zerorun.push_back(zeroRunAcc);

    int runIdx = 0;
    int zeroRunRem = 0;
    for (size_t predictorIndex = 0; predictorIndex < pointCount;
         ++predictorIndex) {
      if (--zeroRunRem < 0) {
        zeroRunRem = zerorun[size_t(runIdx++)];
        encodeRunLength(aec, ctx, zeroRunRem);
      }
      if (!zeroRunRem) {
        if (dims == 1)
          encodeScalar(aec, ctx, residual0s[predictorIndex]);
        else
          encodeTriplet(aec, ctx, residual0s[predictorIndex * 3],
                        residual0s[predictorIndex * 3 + 1],
                        residual0s[predictorIndex * 3 + 2]);
      }
    }
  } else if (pp.attrEncoding == 2) {
    std::vector<uint64_t> weights;
    computeQuantWeightsLift(predictors, weights);
    const size_t lodCount = numPointsInLod.size();
    std::vector<int64_t> vals(pointCount * size_t(dims));
    for (size_t index = 0; index < pointCount; ++index)
      for (int k = 0; k < dims; k++)
        vals[index * size_t(dims) + size_t(k)] =
          int64_t(attrs[size_t(indexes[index]) * size_t(dims) + size_t(k)])
          << kFixedPointAttributeShift;

    for (size_t i = 0; i + 1 < lodCount; ++i) {
      const size_t lodIndex = lodCount - i - 1;
      const size_t startIndex = numPointsInLod[lodIndex - 1];
      const size_t endIndex = numPointsInLod[lodIndex];
      liftPredict(predictors, startIndex, endIndex, true, vals, dims);
      liftUpdate(predictors, weights, startIndex, endIndex, true, vals,
                 dims);
    }

    const bool lcpOn = pp.lastComponentPrediction && dims == 3;
    std::vector<int32_t> lcpCoeffs;
    int64_t lastCompPredCoeff = 0;
    if (lcpOn) {
      // computeLastComponentPredictionCoeff
      // (AttributeEncoder.cpp:1499-1542); NB the reference accumulates
      // the products through int (32-bit) - reproduced bug-compatibly
      const int maxLvls = pp.maxNumDetailLevels();
      lcpCoeffs.assign(size_t(maxLvls), 0);
      int64_t sumk1k2 = 0, sumk1k1 = 0;
      int lod = 0;
      for (size_t coeffIdx = 0; coeffIdx < pointCount; ++coeffIdx) {
        int mult = int(vals[coeffIdx * 3 + 1] * vals[coeffIdx * 3 + 2]);
        int mult2 = int(vals[coeffIdx * 3 + 1] * vals[coeffIdx * 3 + 1]);
        sumk1k2 += mult;
        sumk1k1 += mult2;
        if (coeffIdx != numPointsInLod[size_t(lod)] - 1) continue;
        int64_t scale = 0;
        if (sumk1k2 && sumk1k1) {
          int sign = ((sumk1k2 < 0) ^ (sumk1k1 < 0)) ? -1 : 1;
          scale = ((sumk1k2 << 2) + sign * (sumk1k1 >> 1)) / sumk1k1;
        }
        sumk1k2 = sumk1k1 = 0;
        lcpCoeffs[size_t(lod)] =
          int32_t(std::min(std::max(scale, int64_t(-8)), int64_t(8)));
        lod++;
      }
      for (; lod < maxLvls; lod++)
        lcpCoeffs[size_t(lod)] = lcpCoeffs[size_t(lod - 1)];
      if (out_lcp)
        for (int l = 0; l < maxLvls; l++) out_lcp[l] = lcpCoeffs[size_t(l)];
      lastCompPredCoeff = lcpCoeffs[0];
    }

    int zeroRun = 0;
    int quantLayer = 0;
    int lod = 0;
    for (size_t predictorIndex = 0; predictorIndex < pointCount;
         ++predictorIndex) {
      if (predictorIndex == numPointsInLod[size_t(quantLayer)])
        quantLayer = std::min(int(qpSet.layers.size()) - 1, quantLayer + 1);
      if (predictorIndex == numPointsInLod[size_t(lod)]) {
        lod++;
        if (lcpOn) lastCompPredCoeff = lcpCoeffs[size_t(lod)];
      }
      Quant quant[2];
      qpSet.quantizers(quantLayer, quant);
      const int64_t iQuantWeight =
        int64_t(tmc13ref_irsqrt(weights[predictorIndex]));
      const int64_t quantWeight = int64_t(
        (weights[predictorIndex] * uint64_t(iQuantWeight) + (1ull << 39))
        >> 40);

      if (dims == 1) {
        auto& v = vals[predictorIndex];
        const int64_t delta = quant[0].quantize(v * quantWeight);
        const int64_t reconstructedDelta = quant[0].scale(delta);
        v = divExp2RoundHalfInf(reconstructedDelta * iQuantWeight, 40);
        if (!delta) ++zeroRun;
        else {
          encodeRunLength(aec, ctx, zeroRun);
          encodeScalar(aec, ctx, int32_t(delta));
          zeroRun = 0;
        }
      } else {
        int64_t* color = &vals[predictorIndex * 3];
        int32_t values[3];
        values[0] = int32_t(quant[0].quantize(color[0] * quantWeight));
        int64_t scaled = quant[0].scale(values[0]);
        color[0] = divExp2RoundHalfInf(scaled * iQuantWeight, 40);
        values[1] = int32_t(quant[1].quantize(color[1] * quantWeight));
        scaled = quant[1].scale(values[1]);
        color[1] = divExp2RoundHalfInf(scaled * iQuantWeight, 40);
        color[2] -= (lastCompPredCoeff * color[1]) >> 2;
        scaled *= lastCompPredCoeff;
        scaled >>= 2;
        values[2] = int32_t(quant[1].quantize(color[2] * quantWeight));
        scaled += quant[1].scale(values[2]);
        color[2] = divExp2RoundHalfInf(scaled * iQuantWeight, 40);
        if (!values[0] && !values[1] && !values[2]) ++zeroRun;
        else {
          encodeRunLength(aec, ctx, zeroRun);
          encodeTriplet(aec, ctx, values[0], values[1], values[2]);
          zeroRun = 0;
        }
      }
    }
    if (zeroRun) encodeRunLength(aec, ctx, zeroRun);

    // reconstruct (for recon_out)
    for (size_t lodIndex = 1; lodIndex < lodCount; ++lodIndex) {
      const size_t startIndex = numPointsInLod[lodIndex - 1];
      const size_t endIndex = numPointsInLod[lodIndex];
      liftUpdate(predictors, weights, startIndex, endIndex, false, vals,
                 dims);
      liftPredict(predictors, startIndex, endIndex, false, vals, dims);
    }
    for (size_t f = 0; f < pointCount; ++f)
      for (int k = 0; k < dims; k++) {
        const int64_t v = divExp2RoundHalfInf(
          vals[f * size_t(dims) + size_t(k)], kFixedPointAttributeShift);
        attrs[size_t(indexes[f]) * size_t(dims) + size_t(k)] =
          int32_t(std::min(std::max(v, int64_t(0)), clipMax));
      }
  } else {
    return -2;
  }

  aec.flush();
  if (int(aec.out.size()) > cap) return -3;
  std::copy(aec.out.begin(), aec.out.end(), aec_out);
  if (recon_out)
    std::copy(attrs.begin(), attrs.end(), recon_out);
  return int(aec.out.size());
}

// ---------------------------------------------------------------------------
// inter brick encode (attribute inter prediction emission)
//
// The reference encodes non-RAHT attribute inter frames as one full
// pass with the previous frame's attribute cloud in the LoD pool
// (encodeReflectancesPred/Lift with attrInterPredParams,
// AttributeEncoder.cpp:750-854 / :1544-1648) and, when
// attrInterIntraSliceRDO is set, a complete second intra pass on a
// copy of the cloud; the cheaper stream wins and decides
// abh.enableAttrInterPred (AttributeEncoder.cpp:500-577).  Scalar
// (reflectance) only, like the reference's inter predlift scope.
// ---------------------------------------------------------------------------

// one scalar predicting-transform pass; intra when attrsRef is null.
// Returns the attrInterIntraSliceRDO distortion accumulation
// (AttributeEncoder.cpp:825-827) when trackDist.
static double encodeScalarPredPass(
  const PlParams& pp, const QpSet& qpSet, Lods& lods,
  std::vector<int32_t>& attrs, ArithEnc& aec, AttrCtx& ctx,
  bool interRef, const std::vector<int32_t>* attrsRef, bool trackDist) {
  const size_t pointCount = lods.indexes.size();
  const int64_t clipMax = (1ll << pp.bitdepth) - 1;
  const auto& numPointsInLod = lods.numPointsInLod;
  const auto& indexes = lods.indexes;
  auto& predictors = lods.predictors;
  const int availPredModes =
    pp.maxNumDirectPredictors + !pp.directAvgPredictorDisabled;
  ResStat rs;
  rs.reset();
  double dist = 0.;

  std::vector<uint64_t> quantWeights;
  computeQuantWeightsPred(predictors, pp.quantNeighWeight, quantWeights,
                          interRef);

  std::vector<int32_t> residual0s(pointCount);
  std::vector<int> zerorun;
  int zeroRunAcc = 0;
  int quantLayer = 0;
  for (size_t predictorIndex = 0; predictorIndex < pointCount;
       ++predictorIndex) {
    if (predictorIndex == numPointsInLod[size_t(quantLayer)])
      quantLayer = std::min(int(qpSet.layers.size()) - 1, quantLayer + 1);
    const uint32_t pointIndex = indexes[predictorIndex];
    Quant quant[2];
    qpSet.quantizers(quantLayer, quant);
    auto& predictor = predictors[predictorIndex];
    predictor.predMode = 0;

    const bool eligible = predModeEligible(pp, predictor, attrs, 1, indexes,
                                           interRef, attrsRef);
    const int64_t attrValue = attrs[size_t(pointIndex)];
    if (eligible) {
      // decidePredModeRefl (AttributeEncoder.cpp:663-717); under inter
      // the direct candidates resolve by raw pointIndex against the
      // current or reference cloud (:695-702)
      int startpredIndex = pp.directAvgPredictorDisabled;
      predictor.predMode = int8_t(startpredIndex);
      int64_t attrPred[3];
      predictAttr(predictor, attrs, 1, indexes, attrPred, interRef,
                  attrsRef);
      int64_t resQ = quant[0].quantize(
        (attrValue - attrPred[0]) << kFixedPointAttributeShift);
      int mode = predictor.predMode - pp.directAvgPredictorDisabled;
      // int64_t like the reference (AttributeEncoder.cpp:689): ties on
      // the integer part keep the earlier mode
      int64_t best_score = int64_t(
        rs.bitsPtRefl(int32_t(resQ), mode, availPredModes));
      for (int i = startpredIndex; i < int(predictor.neighborCount); i++) {
        if (i == pp.maxNumDirectPredictors) break;
        const auto& nb = predictor.neighbors[i];
        const int64_t ap = interRef
          ? int64_t(nb.interFrameRef ? (*attrsRef)[nb.pointIndex]
                                     : attrs[nb.pointIndex])
          : int64_t(attrs[size_t(indexes[nb.predictorIndex])]);
        resQ = quant[0].quantize(
          (attrValue - ap) << kFixedPointAttributeShift);
        mode = i + !pp.directAvgPredictorDisabled;
        int64_t score = int64_t(
          rs.bitsPtRefl(int32_t(resQ), mode, availPredModes));
        if (score < best_score) {
          best_score = score;
          predictor.predMode = int8_t(i + 1);
        }
      }
    }
    int64_t attrPred[3];
    predictAttr(predictor, attrs, 1, indexes, attrPred, interRef, attrsRef);
    int64_t qStep = quant[0].stepSize();
    int64_t weight =
      std::min(int64_t(quantWeights[predictorIndex]), qStep)
      >> kFixedPointWeightShift;
    const int64_t delta = quant[0].quantize(
      ((attrValue - attrPred[0]) * weight) << kFixedPointAttributeShift);
    int32_t attValue0 = int32_t(delta);
    int64_t reconstructedDelta = divExp2RoundHalfUp(
      quant[0].scale(delta), kFixedPointAttributeShift);
    reconstructedDelta /= weight;
    if (eligible)
      encodePredModeRefl(pp, predictor.predMode, attValue0);
    const int64_t recon = attrPred[0] + reconstructedDelta;
    const int32_t reconC =
      int32_t(std::min(std::max(recon, int64_t(0)), clipMax));
    if (trackDist)
      dist += double(std::abs(int64_t(reconC) - attrValue));
    attrs[size_t(pointIndex)] = reconC;
    if (!attValue0) ++zeroRunAcc;
    else { zerorun.push_back(zeroRunAcc); zeroRunAcc = 0; }
    residual0s[predictorIndex] = attValue0;
    rs.updateRefl(attValue0);
  }
  if (zeroRunAcc) zerorun.push_back(zeroRunAcc);

  int runIdx = 0;
  int zeroRunRem = 0;
  for (size_t predictorIndex = 0; predictorIndex < pointCount;
       ++predictorIndex) {
    if (--zeroRunRem < 0) {
      zeroRunRem = zerorun[size_t(runIdx++)];
      encodeRunLength(aec, ctx, zeroRunRem);
    }
    if (!zeroRunRem)
      encodeScalar(aec, ctx, residual0s[predictorIndex]);
  }
  return dist;
}

// one scalar lifting-transform pass (encodeReflectancesLift,
// AttributeEncoder.cpp:1544-1648); intra when attrsRef is null
static double encodeScalarLiftPass(
  const PlParams& pp, const QpSet& qpSet, Lods& lods,
  std::vector<int32_t>& attrs, ArithEnc& aec, AttrCtx& ctx,
  bool interRef, const std::vector<int32_t>* attrsRef, bool trackDist) {
  const size_t pointCount = lods.indexes.size();
  const int64_t clipMax = (1ll << pp.bitdepth) - 1;
  const auto& numPointsInLod = lods.numPointsInLod;
  const auto& indexes = lods.indexes;
  auto& predictors = lods.predictors;

  std::vector<uint64_t> weights;
  computeQuantWeightsLift(predictors, weights, interRef);
  const size_t lodCount = numPointsInLod.size();
  std::vector<int64_t> vals(pointCount);
  for (size_t index = 0; index < pointCount; ++index)
    vals[index] = int64_t(attrs[size_t(indexes[index])])
      << kFixedPointAttributeShift;
  std::vector<int64_t> valsRef;
  if (interRef) {
    valsRef.resize(attrsRef->size());
    for (size_t i = 0; i < attrsRef->size(); i++)
      valsRef[i] = int64_t((*attrsRef)[i]) << kFixedPointAttributeShift;
  }

  for (size_t i = 0; i + 1 < lodCount; ++i) {
    const size_t lodIndex = lodCount - i - 1;
    const size_t startIndex = numPointsInLod[lodIndex - 1];
    const size_t endIndex = numPointsInLod[lodIndex];
    liftPredict(predictors, startIndex, endIndex, true, vals, 1, interRef,
                interRef ? &valsRef : nullptr);
    liftUpdate(predictors, weights, startIndex, endIndex, true, vals, 1,
               interRef);
  }

  int zeroRun = 0;
  int quantLayer = 0;
  for (size_t predictorIndex = 0; predictorIndex < pointCount;
       ++predictorIndex) {
    if (predictorIndex == numPointsInLod[size_t(quantLayer)])
      quantLayer = std::min(int(qpSet.layers.size()) - 1, quantLayer + 1);
    Quant quant[2];
    qpSet.quantizers(quantLayer, quant);
    const int64_t iQuantWeight =
      int64_t(tmc13ref_irsqrt(weights[predictorIndex]));
    const int64_t quantWeight = int64_t(
      (weights[predictorIndex] * uint64_t(iQuantWeight) + (1ull << 39))
      >> 40);
    auto& v = vals[predictorIndex];
    const int64_t delta = quant[0].quantize(v * quantWeight);
    const int64_t reconstructedDelta = quant[0].scale(delta);
    v = divExp2RoundHalfInf(reconstructedDelta * iQuantWeight, 40);
    if (!delta) ++zeroRun;
    else {
      encodeRunLength(aec, ctx, zeroRun);
      encodeScalar(aec, ctx, int32_t(delta));
      zeroRun = 0;
    }
  }
  if (zeroRun) encodeRunLength(aec, ctx, zeroRun);

  // reconstruct + RDO distortion (AttributeEncoder.cpp:1627-1647)
  for (size_t lodIndex = 1; lodIndex < lodCount; ++lodIndex) {
    const size_t startIndex = numPointsInLod[lodIndex - 1];
    const size_t endIndex = numPointsInLod[lodIndex];
    liftUpdate(predictors, weights, startIndex, endIndex, false, vals, 1,
               interRef);
    liftPredict(predictors, startIndex, endIndex, false, vals, 1, interRef,
                interRef ? &valsRef : nullptr);
  }
  double dist = 0.;
  for (size_t f = 0; f < pointCount; ++f) {
    const int64_t orig = attrs[size_t(indexes[f])];
    const int64_t v =
      divExp2RoundHalfInf(vals[f], kFixedPointAttributeShift);
    const int32_t reconC =
      int32_t(std::min(std::max(v, int64_t(0)), clipMax));
    if (trackDist)
      dist += double(std::abs(int64_t(reconC) - orig));
    attrs[size_t(indexes[f])] = reconC;
  }
  return dist;
}

// Emits the winning pass; *out_enable_inter receives the final
// abh.enableAttrInterPred.  slice_rdo mirrors attrInterIntraSliceRDO.
extern "C" int tmc13ref_encode_predlift_inter(
  const int32_t* positions, int npts, const int32_t* params,
  const int32_t* sampling_periods, const int32_t* layer_qps,
  const int32_t* attrs_in,
  const int32_t* ref_positions, const int32_t* ref_attrs, int nref,
  int inter_search_range, int slice_rdo,
  uint8_t* aec_out, int cap, int32_t* recon_out,
  int32_t* out_enable_inter) {
  PlParams pp;
  plparams_from(params, pp);
  if (pp.dims != 1)
    return -3;  // reference inter predlift is scalar-only
  if (pp.attrEncoding != 1 && pp.attrEncoding != 2) return -2;

  std::vector<V3> positionsV = std::vector<V3>(size_t(npts));
  for (int i = 0; i < npts; i++)
    positionsV[size_t(i)] = {{positions[i * 3], positions[i * 3 + 1],
                              positions[i * 3 + 2]}};
  std::vector<V3> positionsRefV =
    std::vector<V3>(size_t(std::max(nref, 0)));
  std::vector<int32_t> attrsRef(size_t(std::max(nref, 0)), 0);
  for (int i = 0; i < nref; i++) {
    positionsRefV[size_t(i)] = {{ref_positions[i * 3],
                                 ref_positions[i * 3 + 1],
                                 ref_positions[i * 3 + 2]}};
    attrsRef[size_t(i)] = ref_attrs[i];
  }

  QpSet qpSet;
  qpSet.maxQp = 51 + 6 * (pp.bitdepth - 8);
  qpSet.fixedPointQpOffset =
    pp.attrEncoding == 2 ? (kFixedPointWeightShift / 2) * 6 : 0;
  for (int l = 0; l < pp.qpLayersCount; l++)
    qpSet.layers.push_back({layer_qps[2 * l], layer_qps[2 * l + 1]});

  // inter pass
  Lods lodsInter;
  generateLods(pp, sampling_periods, positionsV, lodsInter, &positionsRefV,
               inter_search_range);
  ArithEnc aecInter;
  aecInter.chunked = pp.chunked != 0;
  aecInter.init();
  aecInter.bypassNoUpdate = pp.bypassNoUpdate != 0;
  AttrCtx ctxInter;
  ctxInter.init();
  std::vector<int32_t> attrsInter(attrs_in, attrs_in + npts);
  const bool trackDist = slice_rdo != 0;
  const double distInter = pp.attrEncoding == 1
    ? encodeScalarPredPass(pp, qpSet, lodsInter, attrsInter, aecInter,
                           ctxInter, true, &attrsRef, trackDist)
    : encodeScalarLiftPass(pp, qpSet, lodsInter, attrsInter, aecInter,
                           ctxInter, true, &attrsRef, trackDist);
  aecInter.flush();

  bool useInter = true;
  ArithEnc aecIntra;
  std::vector<int32_t> attrsIntra;
  if (slice_rdo) {
    // full second intra pass on a copy of the original cloud
    // (AttributeEncoder.cpp:498-503, :517-544 pred / :550-577 lift)
    Lods lodsIntra;
    generateLods(pp, sampling_periods, positionsV, lodsIntra);
    aecIntra.chunked = pp.chunked != 0;
    aecIntra.init();
    aecIntra.bypassNoUpdate = pp.bypassNoUpdate != 0;
    AttrCtx ctxIntra;
    ctxIntra.init();
    attrsIntra.assign(attrs_in, attrs_in + npts);
    const double distIntra = pp.attrEncoding == 1
      ? encodeScalarPredPass(pp, qpSet, lodsIntra, attrsIntra, aecIntra,
                             ctxIntra, false, nullptr, true)
      : encodeScalarLiftPass(pp, qpSet, lodsIntra, attrsIntra, aecIntra,
                             ctxIntra, false, nullptr, true);
    aecIntra.flush();
    // AttributeInterPredParams::setLambda (PCCTMC3Common.h:286-289);
    // NB qpMinus4 / 3 is C++ integer division; pow(x, 0.5) exactly as
    // the reference (sqrt is correctly rounded, pow need not be — a
    // last-ulp difference could flip a near-tie pass decision)
    const int qpMinus4 = pp.initQp - 4;
    const double lambda = std::pow(0.85 * std::pow(2., qpMinus4 / 3), 0.5);
    const double costInter =
      distInter + lambda * double(aecInter.out.size());
    const double costIntra =
      distIntra + lambda * double(aecIntra.out.size());
    if (costInter > costIntra) useInter = false;
  }

  ArithEnc& aec = useInter ? aecInter : aecIntra;
  std::vector<int32_t>& attrs = useInter ? attrsInter : attrsIntra;
  if (int(aec.out.size()) > cap) return -4;
  std::copy(aec.out.begin(), aec.out.end(), aec_out);
  if (recon_out) std::copy(attrs.begin(), attrs.end(), recon_out);
  if (out_enable_inter) *out_enable_inter = useInter ? 1 : 0;
  return int(aec.out.size());
}
