// Reference-exact trisoup surface geometry for conformant bricks:
// per-node edge-vertex assembly, centroid contexts + drift
// application, face-vertex candidate judging and the ray-traced
// voxelisation.  This is the deterministic geometry between the
// entropy stages (native/trisoup_ref.cc); every integer operation
// reproduces the normative semantics of the reference
// (processTrisoupVertices tmc3/geometry_trisoup_encoder.cpp:368-798,
// decodeTrisoupCentroids geometry_trisoup_decoder.cpp:920-1054,
// decodeTrisoupFaceList :843-916, decodeTrisoupCommon :675-838,
// rayTracingAlongdirection :1360-1476, face helpers :1492-1655).
// The arithmetic-coded decisions themselves (vertex bits, drift
// residues, face flags) stay in trisoup_ref.cc.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

// dirac-exact isqrt (refattr.cc, ported from the reference misc.cpp)
extern "C" uint32_t tmc13ref_isqrt(uint64_t x);

namespace tsgeom {

constexpr int kFpBits = 8;
constexpr int kFpOne = 1 << kFpBits;
constexpr int kFpHalf = 1 << (kFpBits - 1);

struct V3 {
  int32_t v[3];
  int32_t& operator[](int i) { return v[i]; }
  int32_t operator[](int i) const { return v[i]; }
  V3 operator+(const V3& o) const {
    return {v[0] + o.v[0], v[1] + o.v[1], v[2] + o.v[2]};
  }
  V3 operator-(const V3& o) const {
    return {v[0] - o.v[0], v[1] - o.v[1], v[2] - o.v[2]};
  }
  V3 operator+(int32_t a) const { return {v[0] + a, v[1] + a, v[2] + a}; }
  V3 operator-(int32_t a) const { return {v[0] - a, v[1] - a, v[2] - a}; }
  V3 operator<<(int s) const { return {v[0] << s, v[1] << s, v[2] << s}; }
  V3 operator>>(int s) const { return {v[0] >> s, v[1] >> s, v[2] >> s}; }
  V3 operator/(int32_t a) const { return {v[0] / a, v[1] / a, v[2] / a}; }
  V3 operator*(int32_t a) const { return {v[0] * a, v[1] * a, v[2] * a}; }
  // dot product (reference Vec3::operator*)
  int64_t dot(const V3& o) const {
    return int64_t(v[0]) * o.v[0] + int64_t(v[1]) * o.v[1]
      + int64_t(v[2]) * o.v[2];
  }
  int32_t dot32(const V3& o) const {
    return v[0] * o.v[0] + v[1] * o.v[1] + v[2] * o.v[2];
  }
  bool operator==(const V3& o) const {
    return v[0] == o.v[0] && v[1] == o.v[1] && v[2] == o.v[2];
  }
  bool operator<(const V3& o) const {
    if (v[0] == o.v[0]) {
      if (v[1] == o.v[1]) return v[2] < o.v[2];
      return v[1] < o.v[1];
    }
    return v[0] < o.v[0];
  }
  int32_t maxc() const { return std::max(v[0], std::max(v[1], v[2])); }
};

struct V3l {
  int64_t v[3];
  int64_t& operator[](int i) { return v[i]; }
  int64_t operator[](int i) const { return v[i]; }
};

static V3 cross32(const V3& a, const V3& b) {
  return {a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
          a[0] * b[1] - a[1] * b[0]};
}

struct Vert {
  V3 pos;
  int32_t theta;
  int32_t tiebreaker;
};

static bool vertLess(const Vert& a, const Vert& b) {
  if (a.theta > b.theta) return true;   // decreasing theta
  if (a.theta == b.theta && a.tiebreaker < b.tiebreaker) return true;
  return false;
}

// trisoupVertexArc (decoder :467-482)
static int32_t vertexArc(int32_t x, int32_t y, int32_t Wx, int32_t Wy) {
  if (x >= Wx) return y;
  if (y >= Wy) return Wy + Wx - x;
  if (x <= 0) return Wy * 2 + Wx - y;
  return Wy * 2 + Wx + x;
}

struct CentroidCtx {
  int lowBound, highBound, ctxMinMax, lowBoundSurface, highBoundSurface;
};

struct CVert {
  bool valid = false;
  V3 pos = {{0, 0, 0}};
  int driftDQ = 0;
  bool boundaryInside = true;
};

struct FaceCand {
  int i, nei, ii;
  int eIdx00, eIdx01, eIdx10, eIdx11;
  Vert fv0, fv1;
};

struct Node6Nei {
  int idx[7] = {-1, -1, -1, -1, -1, -1, -1};
};

struct TsGeom {
  // parameters
  int n = 0;
  int blockWidth = 16;
  int bitDropped = 0;
  bool flagN = false, flagF = false;
  int32_t bbMin[3] = {0, 0, 0}, bbMax[3] = {0, 0, 0};
  int sampling = 1;
  bool halo = false, adaptiveHalo = false, fineRay = false;
  bool faceVertexActivated = false, centroidActivated = false;

  std::vector<V3> leaves;
  // per node geometry
  std::vector<V3> nodePos, nodeW;
  // eVerts
  std::vector<std::vector<Vert>> eVerts;
  std::vector<int> dominantAxis;
  // centroid stage
  std::vector<V3> gravityCenter;  // weighted (normative)
  std::vector<V3> normV;
  std::vector<CentroidCtx> cctx;
  std::vector<uint8_t> eligible;
  std::vector<int> eligIdx;       // node index per eligible row
  std::vector<CVert> cVerts;
  // faces
  std::vector<Node6Nei> nodes6nei;
  std::vector<FaceCand> cands;
  std::vector<std::vector<Vert>> fVerts;
  std::vector<std::vector<int>> fVertsEdgeIdx;
  // segments (decode-side vertex mapping)
  int nseg = 0;
  std::vector<int> segPerNodeUniq;  // 12*n -> unique index
  // reconstruction
  std::vector<V3> recon;
  // encoder side: slice-local points in octree order + leaf ranges
  std::vector<V3> pts;
  std::vector<int> leafStart, leafEnd;
};

// nonCubicNode (decoder :532-561)
static void nonCubicNode(const TsGeom& g, const V3& leafpos, V3& newp,
                         V3& neww) {
  for (int k = 0; k < 3; k++) {
    bool below = g.flagN && leafpos[k] < g.bbMin[k];
    newp[k] = below ? g.bbMin[k] : leafpos[k];
    neww[k] = below
      ? g.blockWidth - (g.bbMin[k] - leafpos[k])
      : (g.flagF ? std::min(g.bbMax[k] - leafpos[k] + 1, g.blockWidth)
                 : g.blockWidth);
  }
}

// corner offset of each local edge endpoint, scaled by neww
// (the 12 segment pushes, encoder :429-451)
static const int kEdgeCorn[12][2][3] = {
  {{0,0,0},{1,0,0}}, {{0,0,0},{0,1,0}}, {{0,1,0},{1,1,0}},
  {{1,0,0},{1,1,0}}, {{0,0,0},{0,0,1}}, {{0,1,0},{0,1,1}},
  {{1,1,0},{1,1,1}}, {{1,0,0},{1,0,1}}, {{0,0,1},{1,0,1}},
  {{0,0,1},{0,1,1}}, {{0,1,1},{1,1,1}}, {{1,0,1},{1,1,1}},
};

struct SegKey {
  uint64_t s, e;
  int index;
  bool operator<(const SegKey& o) const {
    if (s != o.s) return s < o.s;
    if (e != o.e) return e < o.e;
    return index < o.index;
  }
};

static uint64_t pack21(const V3& p) {
  return (uint64_t(p[0]) << 42) | (uint64_t(p[1]) << 21) | uint64_t(p[2]);
}

// build segmentsPerNode -> uniqueIndex with clipped geometry
// (processTrisoupVertices dedup, encoder :707-739)
static void buildSegments(TsGeom& g) {
  std::vector<SegKey> segs(size_t(g.n) * 12);
  for (int i = 0; i < g.n; i++) {
    const V3& newp = g.nodePos[i];
    const V3& neww = g.nodeW[i];
    for (int j = 0; j < 12; j++) {
      V3 s = {newp[0] + kEdgeCorn[j][0][0] * neww[0],
              newp[1] + kEdgeCorn[j][0][1] * neww[1],
              newp[2] + kEdgeCorn[j][0][2] * neww[2]};
      V3 e = {newp[0] + kEdgeCorn[j][1][0] * neww[0],
              newp[1] + kEdgeCorn[j][1][1] * neww[1],
              newp[2] + kEdgeCorn[j][1][2] * neww[2]};
      segs[size_t(i) * 12 + j] = {pack21(s), pack21(e), i * 12 + j};
    }
  }
  std::vector<SegKey> sorted(segs);
  std::sort(sorted.begin(), sorted.end());
  g.segPerNodeUniq.assign(size_t(g.n) * 12, -1);
  int uniq = -1;
  uint64_t ps = ~0ull, pe = ~0ull;
  for (const SegKey& k : sorted) {
    if (k.s != ps || k.e != pe) {
      uniq++;
      ps = k.s;
      pe = k.e;
    }
    g.segPerNodeUniq[size_t(k.index)] = uniq;
  }
  g.nseg = uniq + 1;
}

// findDominantAxis (decoder :1300-1356)
static int findDominantAxis(std::vector<Vert>& lv, const V3& bw,
                            const V3& gCenter) {
  int dominantAxis = 0;
  int triCount = int(lv.size());
  if (triCount > 3) {
    V3 Width = bw << kFpBits;
    const int sIdx1[3] = {2, 2, 1};
    const int sIdx2[3] = {1, 0, 0};
    int maxNormTri = 0;
    for (int axis = 0; axis <= 2; axis++) {
      for (int j = 0; j < triCount; j++) {
        V3 s = lv[size_t(j)].pos + kFpHalf;
        lv[size_t(j)].theta = vertexArc(s[sIdx1[axis]], s[sIdx2[axis]],
                                        Width[sIdx1[axis]],
                                        Width[sIdx2[axis]]);
        lv[size_t(j)].tiebreaker = s[axis];
      }
      std::sort(lv.begin(), lv.end(), vertLess);
      int32_t accuN = 0;
      for (int k = 0; k < triCount; k++) {
        int k2 = k + 1 >= triCount ? k + 1 - triCount : k + 1;
        V3 h = cross32(lv[size_t(k)].pos - gCenter,
                       lv[size_t(k2)].pos - gCenter);
        accuN += std::abs(h[axis]);
      }
      if (accuN > maxNormTri) {
        maxNormTri = accuN;
        dominantAxis = axis;
      }
    }
    for (size_t j = 0; j < lv.size(); j++) {
      V3 s = lv[j].pos + kFpHalf;
      lv[j].theta = vertexArc(s[sIdx1[dominantAxis]], s[sIdx2[dominantAxis]],
                              Width[sIdx1[dominantAxis]],
                              Width[sIdx2[dominantAxis]]);
      lv[j].tiebreaker = s[dominantAxis];
    }
    std::sort(lv.begin(), lv.end(), vertLess);
  }
  return dominantAxis;
}

// determineNormVandCentroidContexts (decoder :563-672)
static bool centroidContexts(const TsGeom& g, int i, V3& gCenter, V3& normalV,
                             CentroidCtx& c) {
  const std::vector<Vert>& ev = g.eVerts[size_t(i)];
  int triCount = int(ev.size());
  std::vector<int> W(size_t(triCount), 0);
  int Wtotal = 0;
  for (int k = 0; k < triCount; k++) {
    int k2 = k + 1 >= triCount ? k + 1 - triCount : k + 1;
    V3 seg = ev[size_t(k)].pos - ev[size_t(k2)].pos;
    int weight = std::abs(seg[0]) + std::abs(seg[1]) + std::abs(seg[2]);
    W[size_t(k)] += weight;
    W[size_t(k2)] += weight;
    Wtotal += 2 * weight;
  }
  V3l bc = {{0, 0, 0}};
  for (int j = 0; j < triCount; j++)
    for (int k = 0; k < 3; k++)
      bc[k] += int64_t(W[size_t(j)]) * ev[size_t(j)].pos[k];
  for (int k = 0; k < 3; k++) bc[k] /= Wtotal;
  gCenter = {int32_t(bc[0]), int32_t(bc[1]), int32_t(bc[2])};

  if (triCount <= 3) {
    normalV = {{0, 0, 0}};
    c = {0, 0, 0, 0, 0};
    return false;
  }
  int dominantAxis = g.dominantAxis[size_t(i)];
  int bitDropped2 = g.bitDropped;
  int halfDropped2 = bitDropped2 == 0 ? 0 : 1 << (bitDropped2 - 1);

  int minPos = ev[0].pos[dominantAxis];
  int maxPos = ev[0].pos[dominantAxis];
  for (int k = 1; k < triCount; k++) {
    minPos = std::min(minPos, ev[size_t(k)].pos[dominantAxis]);
    maxPos = std::max(maxPos, ev[size_t(k)].pos[dominantAxis]);
  }

  V3l accuNormal = {{0, 0, 0}};
  for (int k = 0; k < triCount; k++) {
    int k2 = k + 1 >= triCount ? k + 1 - triCount : k + 1;
    V3 cr = cross32(ev[size_t(k)].pos - gCenter, ev[size_t(k2)].pos - gCenter);
    for (int kk = 0; kk < 3; kk++) accuNormal[kk] += cr[kk];
  }
  int64_t normN = tmc13ref_isqrt(
    uint64_t(accuNormal[0] * accuNormal[0] + accuNormal[1] * accuNormal[1]
             + accuNormal[2] * accuNormal[2]));
  for (int k = 0; k < 3; k++)
    normalV[k] = int32_t((accuNormal[k] << kFpBits) / normN);

  const V3& nodeWidth = g.nodeW[size_t(i)];
  c.ctxMinMax =
    std::min(8, (maxPos - minPos) >> (kFpBits + g.bitDropped));
  int bound = (int(nodeWidth[dominantAxis]) - 1) << kFpBits;
  int bw = nodeWidth[dominantAxis];
  int m = 1;
  for (; m < bw; m++) {
    V3 temp = gCenter + normalV * m;
    if (temp[0] < 0 || temp[1] < 0 || temp[2] < 0 || temp[0] > bound
        || temp[1] > bound || temp[2] > bound)
      break;
  }
  c.highBound = ((m - 1) + halfDropped2) >> bitDropped2;
  m = 1;
  for (; m < bw; m++) {
    V3 temp = gCenter - normalV * m;
    if (temp[0] < 0 || temp[1] < 0 || temp[2] < 0 || temp[0] > bound
        || temp[1] > bound || temp[2] > bound)
      break;
  }
  c.lowBound = ((m - 1) + halfDropped2) >> bitDropped2;
  c.lowBoundSurface =
    (((gCenter[dominantAxis] - minPos + kFpHalf) >> kFpBits) + halfDropped2)
    >> bitDropped2;
  c.highBoundSurface =
    (((maxPos - gCenter[dominantAxis] + kFpHalf) >> kFpBits) + halfDropped2)
    >> bitDropped2;
  return true;
}

// determineTrisoupNodeNeighbours (decoder :213-259)
static void buildNodes6Nei(TsGeom& g) {
  struct Dup {
    uint64_t key;
    int idx;
    bool operator<(const Dup& o) const { return key < o.key; }
  };
  int bw = g.blockWidth;
  const int32_t off[7][3] = {{0, 0, -bw}, {0, 0, bw}, {0, -bw, 0},
                             {0, bw, 0},  {-bw, 0, 0}, {bw, 0, 0},
                             {0, 0, 0}};
  std::vector<Dup> dup(size_t(g.n) * 7);
  for (int i = 0; i < g.n; i++)
    for (int j = 0; j < 7; j++) {
      // +2*bw bias keeps coords non-negative for the packed compare
      V3 p = {g.leaves[size_t(i)][0] + off[j][0] + 2 * bw,
              g.leaves[size_t(i)][1] + off[j][1] + 2 * bw,
              g.leaves[size_t(i)][2] + off[j][2] + 2 * bw};
      dup[size_t(i) * 7 + size_t(j)] = {pack21(p), (i << 3) + j};
    }
  std::sort(dup.begin(), dup.end());
  std::vector<Node6Nei> all;
  Node6Nei cur;
  uint64_t curKey = dup[0].key;
  auto put = [&](int packed) {
    int ofst = packed & 7;
    int nIdx = ofst == 6 ? 6 : (ofst ^ 1);
    cur.idx[nIdx] = packed >> 3;
  };
  put(dup[0].idx);
  for (size_t t = 1; t < dup.size(); t++) {
    if (dup[t].key != curKey) {
      if (cur.idx[6] != -1) all.push_back(cur);
      cur = Node6Nei();
      curKey = dup[t].key;
    }
    put(dup[t].idx);
  }
  if (cur.idx[6] != -1) all.push_back(cur);
  std::sort(all.begin(), all.end(), [](const Node6Nei& a, const Node6Nei& b) {
    return a.idx[6] < b.idx[6];
  });
  g.nodes6nei = std::move(all);
}

// countTrisoupEdgeVerticesOnFace (decoder :1520-1533)
static int countVerticesOnFace(const std::vector<Vert>& ev, const V3& nodeWFp,
                               int axis) {
  int cnt = 0;
  for (const Vert& v : ev)
    if (nodeWFp[axis] == v.pos[axis] + kFpHalf) cnt++;
  return cnt;
}

// findTrisoupFaceVertex (decoder :1492-1517)
static void findFaceVertex(const TsGeom& g, int nodeIdx, int neiOrderIdx,
                           const Node6Nei& nn, Vert* fVert) {
  int axis = 2 - neiOrderIdx;
  int neiNodeIdx = nn.idx[neiOrderIdx * 2 + 1];
  const V3& nodew = g.nodeW[size_t(nodeIdx)];
  int32_t c0facePos = (nodew[axis] << kFpBits) - kFpHalf;
  V3 c0 = g.cVerts[size_t(nodeIdx)].pos;
  V3 c1 = g.cVerts[size_t(neiNodeIdx)].pos;
  c1[axis] += nodew[axis] << kFpBits;
  int32_t denom = c1[axis] - c0[axis];
  int32_t t = denom ? (((c0facePos - c0[axis]) << kFpBits) / denom) : 0;
  V3 d = c1 - c0;
  V3 fp = {c0[0] + ((t * d[0] + kFpHalf) >> kFpBits),
           c0[1] + ((t * d[1] + kFpHalf) >> kFpBits),
           c0[2] + ((t * d[2] + kFpHalf) >> kFpBits)};
  fVert[0] = {fp, 0, 0};
  fVert[0].pos[axis] = c0facePos;
  fVert[1] = {fp, 0, 0};
  fVert[1].pos[axis] = -kFpHalf;
}

// determineTrisoupEdgeBoundaryLine (decoder :1536-1586)
static void edgeBoundaryLine(const std::vector<Vert>& ev, const V3& nodeWFp,
                             int axis, const Vert& fvert, int* eIdx) {
  int evCnt = int(ev.size());
  int distMin = 1 << 30;
  int evIdxMin[2] = {-1, -1};
  for (int evI = 0; evI < (evCnt == 3 ? 1 : evCnt); evI++) {
    int ev0 = evI;
    int ev1 = evI + 1 >= evCnt ? evI + 1 - evCnt : evI + 1;
    V3 c0 = ev[size_t(ev0)].pos + kFpHalf;
    V3 c1 = ev[size_t(ev1)].pos + kFpHalf;
    if (nodeWFp[axis] != c0[axis] || nodeWFp[axis] != c1[axis]) continue;
    V3 mid = (c0 + c1) / 2;
    V3 dv = (mid - fvert.pos) >> kFpBits;
    int dist = dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2];
    if (distMin > dist) {
      evIdxMin[0] = ev0;
      evIdxMin[1] = ev1;
      distMin = dist;
    }
  }
  eIdx[0] = evIdxMin[0];
  eIdx[1] = evIdxMin[1];
}

// determineTrisoupDirectionOfCentroidsAndFvert (decoder :1590-1626)
static bool judgeFace(const TsGeom& g, int i, int nei, int neiNodeIdx, int e0,
                      int e1, const Vert* fVert) {
  int w = g.blockWidth;
  const int32_t ofst[6][3] = {{0, 0, -w}, {0, 0, w}, {0, -w, 0},
                              {0, w, 0},  {-w, 0, 0}, {w, 0, 0}};
  const std::vector<Vert>& ev = g.eVerts[size_t(i)];
  V3 euvd = ev[size_t(e1)].pos - ev[size_t(e0)].pos;
  V3l euv = {{euvd[0], euvd[1], euvd[2]}};
  int64_t euvNorm = tmc13ref_isqrt(
    uint64_t(euv[0] * euv[0] + euv[1] * euv[1] + euv[2] * euv[2]));
  if (euvNorm)
    for (int k = 0; k < 3; k++) euv[k] = (euv[k] << kFpBits) / euvNorm;
  else
    for (int k = 0; k < 3; k++) euv[k] = 0;
  V3 c0 = g.cVerts[size_t(i)].pos;
  V3 c1 = g.cVerts[size_t(neiNodeIdx)].pos;
  for (int k = 0; k < 3; k++) c1[k] += ofst[nei * 2 + 1][k] << kFpBits;
  V3 g0 = g.gravityCenter[size_t(i)];
  V3 g1 = g.gravityCenter[size_t(neiNodeIdx)];
  V3 ef = fVert[0].pos - ev[size_t(e0)].pos;
  int64_t en = (int64_t(ef[0]) * euv[0] + int64_t(ef[1]) * euv[1]
                + int64_t(ef[2]) * euv[2]) >> kFpBits;
  // the reference keeps the projection components in int64 and
  // truncates only the final dot product to int32
  int64_t proj[3];
  for (int k = 0; k < 3; k++)
    proj[k] = int64_t(ef[k]) - ((en * euv[k]) >> kFpBits);
  V3 d0 = c0 - g0, d1 = c1 - g1;
  int32_t dp0 = int32_t(int64_t(d0[0]) * proj[0] + int64_t(d0[1]) * proj[1]
                        + int64_t(d0[2]) * proj[2]);
  int32_t dp1 = int32_t(int64_t(d1[0]) * proj[0] + int64_t(d1[1]) * proj[1]
                        + int64_t(d1[2]) * proj[2]);
  return dp0 > 0 && dp1 > 0;
}

static bool boundaryInsideCheck(const V3& a, int bbsize) {
  return a[0] >= 0 && a[0] <= bbsize && a[1] >= 0 && a[1] <= bbsize
    && a[2] >= 0 && a[2] <= bbsize;
}

static bool nodeBoundaryInsideCheck(const V3& bw, const V3& pt) {
  return 0 <= pt[0] && pt[0] <= bw[0] && 0 <= pt[1] && pt[1] <= bw[1]
    && 0 <= pt[2] && pt[2] <= bw[2];
}

// rayIntersectsTriangle (decoder :493-530)
static bool rayIntersects(const V3& rayOrigin, const V3& v0, const V3& edge1,
                          const V3& edge2, const V3& h, int32_t a, V3& outI,
                          V3& outUp, V3& outDown, int direction,
                          int haloTriangle, int thickness) {
  V3 s = rayOrigin - v0;
  int32_t u = s.dot32(h) / a;
  V3 q = cross32(s, edge1);
  int32_t v = q[direction] / a;
  int w = kFpOne - u - v;
  int32_t t = (edge2.dot32(q >> kFpBits)) / a;
  outI[direction] += t;
  outUp = outI;
  outUp[direction] += thickness;
  outDown = outI;
  outDown[direction] -= thickness;
  return u >= -haloTriangle && v >= -haloTriangle && w >= -haloTriangle;
}

// rayTracingAlongdirection (decoder :1360-1476)
static void rayTrace(const TsGeom& g, std::vector<V3>& outBlock, int direction,
                     const V3& nodepos, const int minRange[3],
                     const int maxRange[3], const V3& edge1, const V3& edge2,
                     const V3& v0) {
  V3 rayVector = {{0, 0, 0}};
  rayVector[direction] = kFpOne;
  V3 h = cross32(rayVector, edge2) >> kFpBits;
  int32_t a = int32_t(edge1.dot32(h)) >> kFpBits;
  if (std::abs(a) <= kFpOne) return;

  const int g1pos[3] = {1, 0, 0};
  const int g2pos[3] = {2, 2, 1};
  const int32_t startposG1 = minRange[g1pos[direction]];
  const int32_t startposG2 = minRange[g2pos[direction]];
  const int32_t endposG1 = maxRange[g1pos[direction]];
  const int32_t endposG2 = maxRange[g2pos[direction]];
  const int32_t rayStart = minRange[direction] << kFpBits;
  V3 rayOrigin = {{rayStart, rayStart, rayStart}};

  int haloTriangle = 0;
  int haloBit = (((1 << g.bitDropped) - 1) << kFpBits) / g.blockWidth;
  haloBit = (haloBit * 24) / 32;
  haloBit = haloBit > 40 ? 40 : haloBit;
  if (g.halo) {
    if (g.sampling > 1) {
      haloTriangle = g.adaptiveHalo ? 50 * g.sampling : 50;
      haloTriangle = haloTriangle > 100 ? 100 : haloTriangle;
    } else {
      haloTriangle = haloBit;
    }
  }
  int thickness = g.sampling > 1 ? 16 : 32;
  const int bw1 = g.blockWidth - 1;

  for (int32_t g1 = startposG1; g1 <= endposG1; g1 += g.sampling) {
    rayOrigin[g1pos[direction]] = g1 << kFpBits;
    for (int32_t g2 = startposG2; g2 <= endposG2; g2 += g.sampling) {
      rayOrigin[g2pos[direction]] = g2 << kFpBits;
      V3 inter = rayOrigin, up = rayOrigin, down = rayOrigin;
      bool found = rayIntersects(rayOrigin, v0, edge1, edge2, h, a, inter, up,
                                 down, direction, haloTriangle, thickness);
      if (found) {
        V3 fv = (up + kFpHalf) >> kFpBits;
        if (boundaryInsideCheck(fv, bw1)) outBlock.push_back(nodepos + fv);
        fv = (down + kFpHalf) >> kFpBits;
        if (boundaryInsideCheck(fv, bw1)) outBlock.push_back(nodepos + fv);
        fv = (inter + kFpHalf) >> kFpBits;
        if (boundaryInsideCheck(fv, bw1)) {
          outBlock.push_back(nodepos + fv);
          continue;
        }
      }
      if (g.sampling == 1 && g.fineRay) {
        const int Off1[8] = {0, 0, -1, 1, -1, -1, 1, 1};
        const int Off2[8] = {-1, 1, 0, 0, -1, 1, -1, 1};
        const int offset = kFpHalf >> 2;
        for (int pos = 0; pos < 8; pos++) {
          V3 ro2 = rayOrigin;
          ro2[g1pos[direction]] += Off1[pos] * offset;
          ro2[g2pos[direction]] += Off2[pos] * offset;
          V3 inter2 = ro2, up2 = ro2, down2 = ro2;
          if (rayIntersects(ro2, v0, edge1, edge2, h, a, inter2, up2, down2,
                            direction, haloTriangle, thickness)) {
            V3 fv = (inter2 + kFpHalf) >> kFpBits;
            if (boundaryInsideCheck(fv, bw1)) {
              outBlock.push_back(nodepos + fv);
              break;
            }
          }
        }
      }
    }
  }
}

}  // namespace tsgeom

// ---------------------------------------------------------------------------
// C entries
// ---------------------------------------------------------------------------

using namespace tsgeom;

extern "C" void* tsgeom_open(
  const int32_t* leaves, int n, int block_width, int bit_dropped,
  int flag_n, int flag_f, const int32_t* bb_min, const int32_t* bb_max,
  int sampling, int halo, int adaptive_halo, int fine_ray,
  int face_vertex, int centroid_residual) {
  TsGeom* g = new TsGeom();
  g->n = n;
  g->blockWidth = block_width;
  g->bitDropped = bit_dropped;
  g->flagN = flag_n != 0;
  g->flagF = flag_f != 0;
  for (int k = 0; k < 3; k++) {
    g->bbMin[k] = bb_min[k];
    g->bbMax[k] = bb_max[k];
  }
  g->sampling = sampling;
  g->halo = halo != 0;
  g->adaptiveHalo = adaptive_halo != 0;
  g->fineRay = fine_ray != 0;
  g->faceVertexActivated = face_vertex != 0;
  g->centroidActivated = centroid_residual != 0;
  g->leaves.resize(size_t(n));
  g->nodePos.resize(size_t(n));
  g->nodeW.resize(size_t(n));
  for (int i = 0; i < n; i++) {
    V3 lp = {leaves[i * 3], leaves[i * 3 + 1], leaves[i * 3 + 2]};
    g->leaves[size_t(i)] = lp;
    nonCubicNode(*g, lp, g->nodePos[size_t(i)], g->nodeW[size_t(i)]);
  }
  buildSegments(*g);
  return g;
}

extern "C" void tsgeom_close(void* h) { delete static_cast<TsGeom*>(h); }

extern "C" int tsgeom_nseg(void* h) {
  return static_cast<TsGeom*>(h)->nseg;
}

// eVerts assembly from per-unique-edge vertex values (-1 = absent)
// (processTrisoupVertices tail, encoder :741-798); returns the number
// of drift-eligible nodes (centroid entropy rows)
extern "C" int tsgeom_set_verts(void* hh, const int32_t* uniqVert) {
  TsGeom& g = *static_cast<TsGeom*>(hh);
  g.eVerts.assign(size_t(g.n), {});
  g.dominantAxis.assign(size_t(g.n), 0);
  for (int i = 0; i < g.n; i++) {
    const V3& nodew = g.nodeW[size_t(i)];
    std::vector<Vert>& ev = g.eVerts[size_t(i)];
    for (int j = 0; j < 12; j++) {
      int uq = g.segPerNodeUniq[size_t(i) * 12 + size_t(j)];
      int vtx = uniqVert[uq];
      if (vtx < 0) continue;
      V3 rel = {kEdgeCorn[j][0][0] * nodew[0], kEdgeCorn[j][0][1] * nodew[1],
                kEdgeCorn[j][0][2] * nodew[2]};
      V3 dir = {(kEdgeCorn[j][1][0] - kEdgeCorn[j][0][0]) * nodew[0],
                (kEdgeCorn[j][1][1] - kEdgeCorn[j][0][1]) * nodew[1],
                (kEdgeCorn[j][1][2] - kEdgeCorn[j][0][2]) * nodew[2]};
      V3 point = (rel << kFpBits) - kFpHalf;
      int32_t distance = (vtx << (kFpBits + g.bitDropped))
        + (kFpHalf << g.bitDropped);
      if (dir[0])
        point[0] += distance;
      else if (dir[1])
        point[1] += distance;
      else
        point[2] += distance;
      ev.push_back({point, 0, 0});
    }
    // simple mean centre for axis selection only
    V3 gC = {{0, 0, 0}};
    for (const Vert& v : ev) gC = gC + v.pos;
    if (!ev.empty()) gC = gC / int32_t(ev.size());
    g.dominantAxis[size_t(i)] = findDominantAxis(ev, nodew, gC);
  }

  // centroid contexts (decodeTrisoupCentroids pre-entropy part)
  g.gravityCenter.assign(size_t(g.n), {{0, 0, 0}});
  g.normV.assign(size_t(g.n), {{0, 0, 0}});
  g.cctx.assign(size_t(g.n), {0, 0, 0, 0, 0});
  g.eligible.assign(size_t(g.n), 0);
  g.eligIdx.clear();
  g.cVerts.assign(size_t(g.n), CVert());
  for (int i = 0; i < g.n; i++) {
    if (g.eVerts[size_t(i)].size() < 3) continue;
    V3 gC, nV;
    CentroidCtx c;
    bool drift = centroidContexts(g, i, gC, nV, c);
    g.gravityCenter[size_t(i)] = gC;
    g.normV[size_t(i)] = nV;
    g.cctx[size_t(i)] = c;
    g.cVerts[size_t(i)].pos = gC;   // provisional; drift may move it
    if (drift && g.centroidActivated) {
      g.eligible[size_t(i)] = 1;
      g.eligIdx.push_back(i);
    }
  }
  return int(g.eligIdx.size());
}

// cctx rows for the eligible nodes, in coding order:
// (ctxMinMax, lowBound, highBound, lowBoundSurface, highBoundSurface)
// — the layout tsref_dec_centroids/tsref_enc_centroids expect
extern "C" void tsgeom_get_cctx(void* hh, int32_t* out) {
  TsGeom& g = *static_cast<TsGeom*>(hh);
  for (size_t r = 0; r < g.eligIdx.size(); r++) {
    const CentroidCtx& c = g.cctx[size_t(g.eligIdx[r])];
    out[5 * r + 0] = c.ctxMinMax;
    out[5 * r + 1] = c.lowBound;
    out[5 * r + 2] = c.highBound;
    out[5 * r + 3] = c.lowBoundSurface;
    out[5 * r + 4] = c.highBoundSurface;
  }
}

// apply decoded drift residues, build cVerts
// (decodeTrisoupCentroids :1021-1053); returns the number of judged
// face candidates (face entropy bits to decode), or 0 if the face
// tool is off
extern "C" int tsgeom_apply_drifts(void* hh, const int32_t* driftq) {
  TsGeom& g = *static_cast<TsGeom*>(hh);
  for (size_t r = 0; r < g.eligIdx.size(); r++) {
    int i = g.eligIdx[r];
    int driftQ = driftq[r];
    int bitDropped2 = g.bitDropped;
    int driftDQ = 0;
    if (driftQ) {
      driftDQ = std::abs(driftQ) << (bitDropped2 + 6);
      int half = 1 << (5 + bitDropped2);
      int DZ = 2 * half / 3;
      driftDQ += DZ - half;
      if (driftQ < 0) driftDQ = -driftDQ;
    }
    V3 bc = g.gravityCenter[size_t(i)];
    const V3& nv = g.normV[size_t(i)];
    for (int k = 0; k < 3; k++) {
      bc[k] += (driftDQ * nv[k]) >> 6;
      bc[k] = std::max(-kFpHalf, bc[k]);
      bc[k] = std::min(((g.blockWidth - 1) << kFpBits) + kFpHalf - 1, bc[k]);
    }
    CVert& cv = g.cVerts[size_t(i)];
    cv.valid = true;
    cv.pos = bc;
    cv.driftDQ = driftDQ;
    cv.boundaryInside =
      nodeBoundaryInsideCheck(g.nodeW[size_t(i)] << kFpBits, bc);
  }

  // face-vertex candidates (decodeTrisoupFaceList :860-905, judge part)
  g.cands.clear();
  g.fVerts.assign(size_t(g.n), {});
  g.fVertsEdgeIdx.assign(size_t(g.n), {});
  if (!g.faceVertexActivated) return 0;
  buildNodes6Nei(g);
  for (int i = 0; i < g.n; i++) {
    for (int j = 1, nei = 0; j < 6; j += 2, nei++) {
      if (!(g.cVerts[size_t(i)].valid && g.cVerts[size_t(i)].boundaryInside))
        continue;
      int ii = g.nodes6nei[size_t(i)].idx[j];
      if (ii == -1) continue;
      if (!(g.cVerts[size_t(ii)].valid && g.cVerts[size_t(ii)].boundaryInside))
        continue;
      int axis = 2 - nei;
      V3 nodeWFp = g.nodeW[size_t(i)] << kFpBits;
      V3 zeroWFp = {{0, 0, 0}};
      int cnt = countVerticesOnFace(g.eVerts[size_t(i)], nodeWFp, axis);
      if (cnt != 2 && cnt != 3) continue;
      Vert fVert[2];
      findFaceVertex(g, i, nei, g.nodes6nei[size_t(i)], fVert);
      int eIdx0[2], eIdx1[2];
      edgeBoundaryLine(g.eVerts[size_t(i)], nodeWFp, axis, fVert[0], eIdx0);
      edgeBoundaryLine(g.eVerts[size_t(ii)], zeroWFp, axis, fVert[1], eIdx1);
      if (eIdx0[0] == -1 || eIdx0[1] == -1) continue;
      if (!judgeFace(g, i, nei, ii, eIdx0[0], eIdx0[1], fVert)) continue;
      g.cands.push_back(
        {i, nei, ii, eIdx0[0], eIdx0[1], eIdx1[0], eIdx1[1], fVert[0],
         fVert[1]});
    }
  }
  return int(g.cands.size());
}

// apply decoded face-connect flags (decodeTrisoupFaceList pushes)
extern "C" void tsgeom_apply_faces(void* hh, const uint8_t* connect) {
  TsGeom& g = *static_cast<TsGeom*>(hh);
  for (size_t c = 0; c < g.cands.size(); c++) {
    if (!connect[c]) continue;
    const FaceCand& fc = g.cands[c];
    g.fVertsEdgeIdx[size_t(fc.i)].push_back(fc.eIdx00);
    g.fVerts[size_t(fc.i)].push_back(fc.fv0);
    g.fVertsEdgeIdx[size_t(fc.ii)].push_back(fc.eIdx10);
    g.fVerts[size_t(fc.ii)].push_back(fc.fv1);
  }
}

// surface voxelisation (decodeTrisoupCommon :675-838); returns the
// number of reconstructed points
extern "C" int tsgeom_reconstruct(void* hh) {
  TsGeom& g = *static_cast<TsGeom*>(hh);
  g.recon.clear();
  std::vector<V3> block;
  for (int i = 0; i < g.n; i++) {
    const V3& nodepos = g.nodePos[size_t(i)];
    const std::vector<Vert>& ev = g.eVerts[size_t(i)];
    block.clear();

    for (const Vert& v : ev) {
      V3 point = (v.pos + kFpHalf) >> kFpBits;
      if (g.bitDropped || g.sampling > 1) {
        if (boundaryInsideCheck(point, g.blockWidth - 1))
          block.push_back(nodepos + point);
      }
    }
    if (ev.size() < 3) {
      std::sort(block.begin(), block.end());
      block.erase(std::unique(block.begin(), block.end()), block.end());
      g.recon.insert(g.recon.end(), block.begin(), block.end());
      continue;
    }
    if (ev.size() > 3) {
      V3 fv = (g.cVerts[size_t(i)].pos + kFpHalf) >> kFpBits;
      if (boundaryInsideCheck(fv, g.blockWidth - 1))
        block.push_back(fv + nodepos);
    }

    std::vector<Vert> nodeVertices;
    for (size_t j = 0; j < ev.size(); j++) {
      nodeVertices.push_back(ev[j]);
      for (size_t k = 0; k < g.fVerts[size_t(i)].size(); k++)
        if (int(j) == g.fVertsEdgeIdx[size_t(i)][k])
          nodeVertices.push_back(g.fVerts[size_t(i)][k]);
    }

    int vtxCount = int(nodeVertices.size());
    V3 blockCentroid = g.cVerts[size_t(i)].pos;
    V3 v2 = vtxCount == 3 ? nodeVertices[2].pos : blockCentroid;
    V3 v1 = nodeVertices[0].pos;
    for (int vtxIndex = 0; vtxIndex < (vtxCount == 3 ? 1 : vtxCount);
         vtxIndex++) {
      int j1 = vtxIndex + 1 >= vtxCount ? vtxIndex + 1 - vtxCount
                                        : vtxIndex + 1;
      V3 v0 = v1;
      v1 = nodeVertices[size_t(j1)].pos;

      int minRange[3], maxRange[3];
      for (int k = 0; k < 3; k++) {
        minRange[k] = std::max(
          0, (std::min(std::min(v0[k], v1[k]), v2[k]) + kFpHalf) >> kFpBits);
        maxRange[k] = std::min(
          g.blockWidth,
          (std::max(std::max(v0[k], v1[k]), v2[k]) + kFpHalf) >> kFpBits);
      }
      V3 edge1 = v1 - v0;
      V3 edge2 = v2 - v0;
      int minDir = 1 << 28;
      int directionExcluded = 0;
      for (int k = 0; k <= 2; k++) {
        V3 rayVector = {{0, 0, 0}};
        rayVector[k] = kFpOne;
        V3 hh2 = cross32(edge1, edge2) >> kFpBits;
        int32_t a = int32_t(rayVector.dot32(hh2)) >> kFpBits;
        if (std::abs(a) < minDir) {
          minDir = std::abs(a);
          directionExcluded = k;
        }
      }
      for (int direction = 0; direction < 3; direction++) {
        if (directionExcluded == direction) continue;
        rayTrace(g, block, direction, nodepos, minRange, maxRange, edge1,
                 edge2, v0);
      }
    }

    std::sort(block.begin(), block.end());
    block.erase(std::unique(block.begin(), block.end()), block.end());
    g.recon.insert(g.recon.end(), block.begin(), block.end());
  }
  return int(g.recon.size());
}

extern "C" void tsgeom_get_points(void* hh, int32_t* out) {
  TsGeom& g = *static_cast<TsGeom*>(hh);
  for (size_t i = 0; i < g.recon.size(); i++)
    for (int k = 0; k < 3; k++) out[i * 3 + size_t(k)] = g.recon[i][k];
}

// adaptive sampling search re-runs the reconstruction per value
// (encodeGeometryTrisoup loop, encoder :215-230)
extern "C" void tsgeom_set_sampling(void* hh, int sampling) {
  static_cast<TsGeom*>(hh)->sampling = sampling;
}

// ---------------------------------------------------------------------------
// encoder side
// ---------------------------------------------------------------------------

extern "C" void tsgeom_set_points(void* hh, const int32_t* pts, int npts,
                                  const int32_t* leaf_start,
                                  const int32_t* leaf_end) {
  TsGeom& g = *static_cast<TsGeom*>(hh);
  g.pts.resize(size_t(npts));
  for (int i = 0; i < npts; i++)
    g.pts[size_t(i)] = {pts[i * 3], pts[i * 3 + 1], pts[i * 3 + 2]};
  g.leafStart.assign(leaf_start, leaf_start + g.n);
  g.leafEnd.assign(leaf_end, leaf_end + g.n);
}

namespace tsgeom {

// estimatedSampling1/2/3 (encoder :260-343)
static float estSampling1(const TsGeom& g, int i) {
  const V3& w = g.nodeW[size_t(i)];
  int s[3] = {w[0], w[1], w[2]};
  std::sort(s, s + 3);
  int cnt = g.leafEnd[size_t(i)] - g.leafStart[size_t(i)];
  return std::sqrt(float(s[2] * s[1])) / std::sqrt(float(cnt));
}

static float estSampling2(const TsGeom& g, int i) {
  int st = g.leafStart[size_t(i)], ed = g.leafEnd[size_t(i)];
  const V3& lp = g.leaves[size_t(i)];
  V3 mn = g.pts[size_t(st)] - lp, mx = mn;
  for (int j = st; j < ed; j++) {
    V3 cv = g.pts[size_t(j)] - lp;
    for (int k = 0; k < 3; k++) {
      mn[k] = std::min(mn[k], cv[k]);
      mx[k] = std::max(mx[k], cv[k]);
    }
  }
  V3 dim = mx - mn;
  int s[3] = {dim[0], dim[1], dim[2]};
  std::sort(s, s + 3);
  return std::sqrt(float(s[2] * s[1]) / float(ed - st));
}

static float estSampling3(const TsGeom& g, int i) {
  int st = g.leafStart[size_t(i)], ed = g.leafEnd[size_t(i)];
  int cnt = ed - st;
  std::vector<std::vector<float>> nn{size_t(cnt)};
  std::vector<int> one(size_t(cnt), 0);
  const int N = 4;
  int cnt1 = 0;
  float es = 0;
  const V3& lp = g.leaves[size_t(i)];
  for (int j = st; j < ed; j++) {
    V3 cur = g.pts[size_t(j)] - lp;
    int cnt2 = cnt1 + 1;
    for (int t = st + cnt2; t < ed; t++) {
      V3 d = cur - (g.pts[size_t(t)] - lp);
      float distance = std::sqrt(
        float(int64_t(d[0]) * d[0] + int64_t(d[1]) * d[1]
              + int64_t(d[2]) * d[2]));
      if (int(nn[size_t(cnt1)].size()) < N) {
        nn[size_t(cnt1)].push_back(distance);
        std::sort(nn[size_t(cnt1)].begin(), nn[size_t(cnt1)].end());
      } else if (distance < nn[size_t(cnt1)].back()
                 && one[size_t(cnt1)] < N) {
        nn[size_t(cnt1)][N - 1] = distance;
        std::sort(nn[size_t(cnt1)].begin(), nn[size_t(cnt1)].end());
      }
      if (int(nn[size_t(cnt2)].size()) < N) {
        nn[size_t(cnt2)].push_back(distance);
        std::sort(nn[size_t(cnt2)].begin(), nn[size_t(cnt2)].end());
      } else if (distance < nn[size_t(cnt2)].back()
                 && one[size_t(cnt2)] < N) {
        nn[size_t(cnt2)][N - 1] = distance;
        std::sort(nn[size_t(cnt2)].begin(), nn[size_t(cnt2)].end());
      }
      if (distance <= 1.0f) {
        ++one[size_t(cnt1)];
        ++one[size_t(cnt2)];
      }
      ++cnt2;
    }
    float s = 0;
    int nsz = int(nn[size_t(cnt1)].size());
    for (int k = 0; k < nsz; k++) s += nn[size_t(cnt1)][k];
    es += s / float(nsz);
    ++cnt1;
  }
  return es / float(cnt);
}

}  // namespace tsgeom

// encoder vertex determination: per-edge voxel votes with the two
// thresholds, accumulated over the unique-segment groups
// (determineTrisoupVertices / processTrisoupVertices encoder half,
// encoder :455-705).  Writes per-unique-segment presence and vertex
// (-1 when absent) in coding order.  estimated_sampling < 0 disables
// the improved determination (distance_search falls back to 1).
extern "C" int tsgeom_enc_verts(
  void* hh, int distance_search, int node_unique_dse,
  float estimated_sampling, uint8_t* segind_out, int32_t* vert_out,
  int32_t* dbg_dse) {
  TsGeom& g = *static_cast<TsGeom*>(hh);
  const int tmin = 1;
  struct Votes {
    int64_t count = 0, distanceSum = 0, count2 = 0, distanceSum2 = 0;
  };
  std::vector<Votes> votes(size_t(g.n) * 12);

  for (int i = 0; i < g.n; i++) {
    const V3& newp = g.nodePos[size_t(i)];
    const V3& neww = g.nodeW[size_t(i)];
    const int tmaxx = neww[0] - tmin - 1;
    const int tmaxy = neww[1] - tmin - 1;
    const int tmaxz = neww[2] - tmin - 1;

    int localDse = -1;
    if (node_unique_dse) {
      // per-node decision tree (encoder :466-492)
      float es = estimated_sampling;
      if (estimated_sampling > 1.0f) {
        es = estSampling1(g, i);
        if (std::abs(estimated_sampling - es) > 0.5f) {
          es = estSampling2(g, i);
          if (std::abs(estimated_sampling - es) > 0.5f) {
            if (g.leafEnd[size_t(i)] - g.leafStart[size_t(i)] > 1)
              es = estSampling3(g, i);
            else
              es = estimated_sampling;
            es = std::min(es, estimated_sampling + 1);
          }
        } else {
          es = estimated_sampling;
        }
      }
      es = std::min(es, float(g.blockWidth / 4));
      localDse = (1 << std::max(0, g.bitDropped - 2)) - 1;
      localDse += int(std::round(es + 0.1f));
      localDse = std::max(1, std::min(8, localDse));
    }
    const int tmin2 = node_unique_dse ? localDse : distance_search;
    if (dbg_dse) dbg_dse[i] = tmin2;
    const int tmax2x = neww[0] - tmin2 - 1;
    const int tmax2y = neww[1] - tmin2 - 1;
    const int tmax2z = neww[2] - tmin2 - 1;

    Votes* v = &votes[size_t(i) * 12];
    for (int p = g.leafStart[size_t(i)]; p < g.leafEnd[size_t(i)]; p++) {
      V3 vox = g.pts[size_t(p)] - newp;
      // threshold 1 (encoder :495-545)
      if (vox[1] < tmin && vox[2] < tmin) { v[0].count++; v[0].distanceSum += vox[0]; }
      if (vox[0] < tmin && vox[2] < tmin) { v[1].count++; v[1].distanceSum += vox[1]; }
      if (vox[1] > tmaxy && vox[2] < tmin) { v[2].count++; v[2].distanceSum += vox[0]; }
      if (vox[0] > tmaxx && vox[2] < tmin) { v[3].count++; v[3].distanceSum += vox[1]; }
      if (vox[0] < tmin && vox[1] < tmin) { v[4].count++; v[4].distanceSum += vox[2]; }
      if (vox[0] < tmin && vox[1] > tmaxy) { v[5].count++; v[5].distanceSum += vox[2]; }
      if (vox[0] > tmaxx && vox[1] > tmaxy) { v[6].count++; v[6].distanceSum += vox[2]; }
      if (vox[0] > tmaxx && vox[1] < tmin) { v[7].count++; v[7].distanceSum += vox[2]; }
      if (vox[1] < tmin && vox[2] > tmaxz) { v[8].count++; v[8].distanceSum += vox[0]; }
      if (vox[0] < tmin && vox[2] > tmaxz) { v[9].count++; v[9].distanceSum += vox[1]; }
      if (vox[1] > tmaxy && vox[2] > tmaxz) { v[10].count++; v[10].distanceSum += vox[0]; }
      if (vox[0] > tmaxx && vox[2] > tmaxz) { v[11].count++; v[11].distanceSum += vox[1]; }
      // threshold 2 (encoder :547-601)
      if (vox[1] < tmin2 && vox[2] < tmin2) { v[0].count2++; v[0].distanceSum2 += vox[0]; }
      if (vox[0] < tmin2 && vox[2] < tmin2) { v[1].count2++; v[1].distanceSum2 += vox[1]; }
      if (vox[1] > tmax2y && vox[2] < tmin2) { v[2].count2++; v[2].distanceSum2 += vox[0]; }
      if (vox[0] > tmax2x && vox[2] < tmin2) { v[3].count2++; v[3].distanceSum2 += vox[1]; }
      if (vox[0] < tmin2 && vox[1] < tmin2) { v[4].count2++; v[4].distanceSum2 += vox[2]; }
      if (vox[0] < tmin2 && vox[1] > tmax2y) { v[5].count2++; v[5].distanceSum2 += vox[2]; }
      if (vox[0] > tmax2x && vox[1] > tmax2y) { v[6].count2++; v[6].distanceSum2 += vox[2]; }
      if (vox[0] > tmax2x && vox[1] < tmin2) { v[7].count2++; v[7].distanceSum2 += vox[2]; }
      if (vox[1] < tmin2 && vox[2] > tmax2z) { v[8].count2++; v[8].distanceSum2 += vox[0]; }
      if (vox[0] < tmin2 && vox[2] > tmax2z) { v[9].count2++; v[9].distanceSum2 += vox[1]; }
      if (vox[1] > tmax2y && vox[2] > tmax2z) { v[10].count2++; v[10].distanceSum2 += vox[0]; }
      if (vox[0] > tmax2x && vox[2] > tmax2z) { v[11].count2++; v[11].distanceSum2 += vox[1]; }
    }
  }

  // accumulate per unique segment and derive presence + position
  // (encoder :670-705)
  std::vector<Votes> acc(size_t(g.nseg));
  for (size_t s = 0; s < votes.size(); s++) {
    int uq = g.segPerNodeUniq[s];
    acc[size_t(uq)].count += votes[s].count;
    acc[size_t(uq)].distanceSum += votes[s].distanceSum;
    acc[size_t(uq)].count2 += votes[s].count2;
    acc[size_t(uq)].distanceSum2 += votes[s].distanceSum2;
  }
  for (int u = 0; u < g.nseg; u++) {
    bool present = acc[size_t(u)].count > 0 || acc[size_t(u)].count2 > 1;
    segind_out[u] = uint8_t(present);
    if (present) {
      int64_t temp = ((2 * acc[size_t(u)].distanceSum
                       + acc[size_t(u)].distanceSum2)
                      << (10 - g.bitDropped))
        / (2 * acc[size_t(u)].count + acc[size_t(u)].count2);
      vert_out[u] = int32_t((temp + (1 << (9 - g.bitDropped))) >> 10);
    } else {
      vert_out[u] = -1;
    }
  }
  return g.nseg;
}

// encoder centroid drift estimation from the actual points
// (determineTrisoupCentroids, encoder :800-927); call after
// tsgeom_set_verts, fills driftq in eligible-row order
extern "C" int tsgeom_enc_drifts(void* hh, int32_t* driftq_out) {
  TsGeom& g = *static_cast<TsGeom*>(hh);
  for (size_t r = 0; r < g.eligIdx.size(); r++) {
    int i = g.eligIdx[r];
    const V3& nodepos = g.nodePos[size_t(i)];
    const V3& blockCentroid = g.gravityCenter[size_t(i)];
    const V3& normalV = g.normV[size_t(i)];
    const CentroidCtx& c = g.cctx[size_t(i)];
    int counter = 0;
    int driftQ = 0, drift = 0;
    int bitDropped2 = g.bitDropped;
    int maxD = std::max(3, bitDropped2);
    for (int p = g.leafStart[size_t(i)]; p < g.leafEnd[size_t(i)]; p++) {
      V3 point = (g.pts[size_t(p)] - nodepos) << kFpBits;
      V3 cp32 = cross32(normalV, point - blockCentroid);
      int64_t CP[3] = {cp32[0] >> kFpBits, cp32[1] >> kFpBits,
                       cp32[2] >> kFpBits};
      int64_t dist = tmc13ref_isqrt(
        uint64_t(CP[0] * CP[0] + CP[1] * CP[1] + CP[2] * CP[2]));
      dist >>= kFpBits;
      if ((dist << 10) <= 1774 * maxD) {
        int32_t w = (1 << 10) + 4 * int32_t(1774 * maxD - ((1 << 10) * dist));
        counter += w >> 10;
        drift += (w >> 10)
          * int32_t(normalV.dot32(point - blockCentroid) >> kFpBits);
      }
    }
    if (counter) drift = (drift >> (kFpBits - 6)) / counter;
    int half = 1 << (5 + bitDropped2);
    int DZ = 2 * half / 3;
    if (std::abs(drift) >= DZ) {
      driftQ = (std::abs(drift) - DZ + 2 * half + 2 * half / 3)
        >> (6 + bitDropped2);
      if (drift < 0) driftQ = -driftQ;
    }
    driftQ = std::min(std::max(driftQ, -c.lowBound), c.highBound);
    driftq_out[r] = driftQ;
  }
  return int(g.eligIdx.size());
}

// encoder face decisions: judge candidates as the decoder does, then
// connect when original points cluster near the tentative face vertex
// (determineTrisoupFaceVertices, encoder :935-1046).  Must be called
// after tsgeom_apply_drifts (which builds the candidate list); fills
// the per-candidate connect flags and replays the fVert pushes.
extern "C" int tsgeom_enc_faces(void* hh, int distance_search,
                                uint8_t* connect_out) {
  TsGeom& g = *static_cast<TsGeom*>(hh);
  const int32_t tmin1 = 2 * 4;
  const int32_t tmin2 = distance_search * 4;
  for (size_t ci = 0; ci < g.cands.size(); ci++) {
    const FaceCand& fc = g.cands[ci];
    const V3& nodepos = g.nodePos[size_t(fc.i)];
    const V3& nodew = g.nodeW[size_t(fc.i)];
    int32_t weight1 = 0, weight2 = 0;
    int st[2] = {g.leafStart[size_t(fc.i)], g.leafStart[size_t(fc.ii)]};
    int ed[2] = {g.leafEnd[size_t(fc.i)], g.leafEnd[size_t(fc.ii)]};
    V3 neiOfst[2][3] = {
      {{{0, 0, 0}}, {{0, 0, 0}}, {{0, 0, 0}}},
      {{{0, 0, nodew[2]}}, {{0, nodew[1], 0}}, {{nodew[0], 0, 0}}}};
    const Vert* fv[2] = {&fc.fv0, &fc.fv1};
    for (int nn = 0; nn < 2; nn++) {
      for (int k = st[nn]; k < ed[nn]; k++) {
        V3 dist = fv[nn]->pos
          - ((g.pts[size_t(k)] - nodepos - neiOfst[nn][fc.nei]) << kFpBits);
        int32_t mx = std::max(std::abs(dist[0]),
                              std::max(std::abs(dist[1]),
                                       std::abs(dist[2])));
        int32_t d = (mx + kFpHalf) >> kFpBits;
        if (d < tmin1) weight1++;
        if (d < tmin2) weight2++;
      }
    }
    bool conn = weight1 > 0 || weight2 > 1;
    connect_out[ci] = uint8_t(conn);
  }
  // replay the pushes in candidate order
  tsgeom_apply_faces(hh, connect_out);
  return int(g.cands.size());
}
