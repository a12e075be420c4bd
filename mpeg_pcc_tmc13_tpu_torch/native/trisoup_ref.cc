// Bit-exact trisoup entropy stages (vertex presence/position,
// centroid drift, face-connect flags) for reference-conformant
// bricks.
//
// The geometric analysis feeding these loops — edge neighbour words,
// 18-slot edge patterns, centroid drift bounds, face-vertex judge
// conditions — is computed as batched numpy passes
// (ops/trisoup_ref.py, conformance/trisoup.py); this file holds only
// the strictly-sequential normative part: per-bit context evolution +
// dirac arithmetic coding, continuing the same coder the octree phase
// used (reference decodeTrisoupVerticesSub
// tmc3/geometry_trisoup_decoder.cpp:1058-1264,
// decodeTrisoupCentroids :920-1054, decodeTrisoupFaceList :843-916
// and their encoder mirrors geometry_trisoup_encoder.cpp:1078-1345).
// Constant tables (context-map init values, 18->9 mappings) are
// normative and identical to the reference by necessity.

#include "obuf_core.h"

namespace {
using namespace obufcore;

// MapOBUFTriSoup init values (decoder :1082-1110)
const uint8_t kTsInit0[128] = {
   15,  15,  15,  15,  15,  15,  15,  15,  15,  15,  42,  96,  71,  37,  15,
   15,  22,  51,  15,  15,  30,  27,  15,  15,  64,  15,  48,  15, 224, 171,
  127,  24, 127,  34,  80,  46, 141,  44,  66,  49, 127, 116, 140, 116, 105,
   39, 127, 116, 114,  46, 172, 109,  60,  73, 181, 161, 112,  65, 240, 159,
  127, 127, 127,  87, 183, 127, 116, 116, 195,  88, 152, 141, 228, 141, 127,
   80, 127, 127, 160,  92, 224, 167, 129, 135, 240, 183, 240, 184, 240, 240,
  127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127,
  127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127,
  127, 127, 127, 127, 127, 127, 127, 127
};
const uint8_t kTsInit1[64] = {
  116, 127, 118,  15, 104,  56,  97,  15,  96,  15,  29,  15,  95,  15,  46,
   15, 196, 116, 182,  53, 210, 104, 163,  69, 169,  15, 114,  15, 121,  15,
  167,  63, 240, 127, 184,  92, 240, 163, 197,  77, 239,  73, 179,  59, 213,
   48, 185, 108, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127,
  127, 127, 127, 127
};
const uint8_t kTsInit2[128] = {
  141, 127, 127, 127, 189,  81,  36, 127, 143, 105, 103, 116, 201,  60,  38,
  116, 116, 127,  15, 127, 153,  59,  15, 116,  69, 105,  15, 127, 158,  93,
   36,  79, 141, 161, 116, 127, 197, 102,  53, 127, 177, 125,  88,  79, 209,
   75, 102,  28,  95,  74,  72,  56, 189,  62,  78,  18,  88, 116,  28,  45,
  237, 100, 152,  35, 141, 240, 127, 127, 208, 133, 101, 141, 186, 210, 168,
   98, 201, 124, 138,  15, 195, 194, 103,  94, 229,  82, 167,  23,  92, 197,
  112,  59, 185,  87, 156,  79, 127, 127, 127, 127, 127, 127, 127, 127, 127,
  127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127, 127,
  127, 127, 127, 127, 127, 127, 127, 127
};

const int kToward[18] = {0, 0, 0, 1, 1, 1, 0, 1, 0,
                         0, 0, 0, 0, 0, 0, 0, 0, 0};
const int kMap18to9[3][9] = {
  {0, 1, 2, 3, 4, 15, 14, 5, 7},
  {0, 1, 2, 3, 9, 15, 14, 7, 12},
  {0, 1, 2, 9, 10, 15, 14, 7, 12},
};

struct TsCtx {
  TsCoderHandle coder;
  ObufModel model;
  CtxMapOBUF map0, map1, map2;
  std::vector<uint8_t> leafBuf;
  int leafNumber = 0;
  uint16_t ctxTempV2[120];
  uint16_t ctxDrift0[9];
  uint16_t ctxDriftSign[3][8][8];
  uint16_t ctxDriftMag[4];
  uint16_t ctxFaces;

  explicit TsCtx(const TsCoderHandle& h) : coder(h) {
    model.init();
    map0.reset(14 + 1, 7);
    map1.reset(10 + 1, 6);
    map2.reset(10 + 1 + 3 + 1, 6 + 1);
    map0.initFrom(kTsInit0);
    map1.initFrom(kTsInit1);
    map2.initFrom(kTsInit2);
    leafBuf.assign(size_t(CtxMapOBUF::kLeafBufSize)
                   << CtxMapOBUF::kLeafDepth, 0);
    for (auto& c : ctxTempV2) c = 0x8000;
    for (auto& c : ctxDrift0) c = 0x8000;
    for (auto& r2 : ctxDriftSign)
      for (auto& r1 : r2)
        for (auto& c : r1) c = 0x8000;
    for (auto& c : ctxDriftMag) c = 0x8000;
    ctxFaces = 0x8000;
  }
};

// shared per-edge context derivation (identical between encoder and
// decoder; decoder :1119-1217)
struct EdgeCtx {
  int ctxE, ctx0, ctx1, direction;
  int pattern, patternClose, patternClosest, nclosestPattern;
  int missedCloseStart, nclosestStart;
  int neighbEdge, neighbEnd, neighbStart;
};

static void deriveEdgeCtx(
  EdgeCtx& e, uint16_t nn, const int32_t* pat,
  const uint8_t* segind, const int32_t* seg2v, const uint8_t* verts,
  int nbitsVertices, int max2bits, int mid2bits) {
  e.ctxE = !!(nn & 1) + !!(nn & 2) + !!(nn & 4) + !!(nn & 8) - 1;
  e.ctx0 = !!(nn & 16) + !!(nn & 32) + !!(nn & 64) + !!(nn & 128);
  e.ctx1 = !!(nn & 256) + !!(nn & 512) + !!(nn & 1024) + !!(nn & 2048);
  e.direction = nn >> 13;

  e.pattern = e.patternClose = e.patternClosest = 0;
  e.nclosestPattern = 0;
  for (int v = 0; v < 9; v++) {
    int v18 = kMap18to9[e.direction][v];
    int idxEdge = pat[v18];
    if (idxEdge != -1 && segind[idxEdge]) {
      e.pattern |= 1 << v;
      int p2 = verts[seg2v[idxEdge]]
        >> (nbitsVertices - 2 > 0 ? nbitsVertices - 2 : 0);
      if (kToward[v18])
        p2 = max2bits - p2;
      if (p2 >= mid2bits)
        e.patternClose |= 1 << v;
      if (p2 >= max2bits)
        e.patternClosest |= 1 << v;
      e.nclosestPattern += (p2 >= max2bits && v <= 4);
    }
  }

  e.missedCloseStart = !(e.pattern & 2) + !(e.pattern & 4);
  e.nclosestStart = !!(e.patternClosest & 1) + !!(e.patternClosest & 2)
    + !!(e.patternClosest & 4);
  if (e.direction == 0) {
    e.missedCloseStart += !(e.pattern & 8) + !(e.pattern & 16);
    e.nclosestStart += !!(e.patternClosest & 8)
      + !!(e.patternClosest & 16);
  }
  if (e.direction == 1) {
    e.missedCloseStart += !(e.pattern & 8);
    e.nclosestStart += !!(e.patternClosest & 8)
      - !!(e.patternClosest & 16);
  }
  if (e.direction == 2) {
    e.nclosestStart += -!!(e.patternClosest & 8)
      - !!(e.patternClosest & 16);
  }

  e.neighbEdge = (nn >> 0) & 15;
  e.neighbEnd = (nn >> 4) & 15;
  e.neighbStart = (nn >> 8) & 15;
  if (e.direction == 2) {
    // z edges permute the quadrant bits {0,3,1,2} (decoder :1180-1195)
    auto perm = [&](int base) {
      int r = (nn >> (base + 0)) & 1;
      r += ((nn >> (base + 3)) & 1) << 1;
      r += ((nn >> (base + 1)) & 1) << 2;
      r += ((nn >> (base + 2)) & 1) << 3;
      return r;
    };
    e.neighbEdge = perm(0);
    e.neighbEnd = perm(4);
    e.neighbStart = perm(8);
  }
}

static void flagCtxMaps(const EdgeCtx& e, int& ctxMap1, int& ctxMap2) {
  ctxMap1 = (e.nclosestPattern > 2 ? 2 : e.nclosestPattern) * 15 * 2
    + (e.neighbEdge - 1) * 2 + (e.ctx1 == 4);
  ctxMap2 = e.neighbEnd << 11;
  ctxMap2 |= (e.patternClose & 0x06) << (9 - 1);
  ctxMap2 |= e.direction << 7;
  ctxMap2 |= (e.patternClose & 0x18) << (5 - 3);
  ctxMap2 |= (e.patternClose & 0x01) << 4;
  int orderedPclosePar = (((e.pattern >> 5) & 3) << 2)
    + (!!(e.pattern & 128) << 1) + !!(e.pattern & 256);
  ctxMap2 |= orderedPclosePar;
}

struct PosCtx {
  int ctxFullNbounds;
  int ctxMap1a, ctxMap2a;   // first bit
  int ctxMap2b;             // second bit (ctxMap1 shared with a)
  int reduced1;             // third bit ctxTempV2 base
};

static void posCtxMaps(const EdgeCtx& e, PosCtx& p) {
  p.ctxFullNbounds =
    (4 * (e.ctx0 <= 1 ? 0 : (e.ctx0 >= 3 ? 2 : 1))
     + ((e.ctx1 > 1 ? e.ctx1 : 1) - 1)) * 2 + (e.ctxE == 3);
  p.ctxMap1a = p.ctxFullNbounds * 2 + (e.nclosestStart > 0);
  p.ctxMap2a = e.missedCloseStart << 8;
  p.ctxMap2a |= (e.patternClosest & 1) << 7;
  p.ctxMap2a |= e.direction << 5;
  p.ctxMap2a |= e.patternClose & 0x1f;
  int orderedPclosePar = (((e.patternClose >> 5) & 3) << 2)
    + (!!(e.patternClose & 128) << 1) + !!(e.patternClose & 256);
  int m2 = e.missedCloseStart << 8;
  m2 |= (e.patternClose & 1) << 7;
  m2 |= (e.patternClosest & 1) << 6;
  m2 |= e.direction << 4;
  m2 |= (e.patternClose & 0x1f) >> 1;
  p.ctxMap2b = (m2 << 4) + orderedPclosePar;
  p.reduced1 = (5 * (e.ctx0 >> 1) + e.missedCloseStart) * 2
    + (e.ctxE == 3);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entries
// ---------------------------------------------------------------------------

extern "C" void* tsref_open(void* coder_handle) {
  TsCoderHandle* h = static_cast<TsCoderHandle*>(coder_handle);
  TsCtx* ctx = new TsCtx(*h);
  delete h;
  return ctx;
}

extern "C" void tsref_close(void* ts) {
  delete static_cast<TsCtx*>(ts);
}

// decode segind + vertices (decodeTrisoupVerticesSub).  segind_out
// must hold nseg bytes, vert_out nseg bytes (0xff where absent),
// seg2v scratch nseg int32.  Returns the number of vertices.
extern "C" int tsref_dec_verts(
  void* ts, const uint16_t* neighb, const int32_t* pattern,
  int nseg, int nbitsVertices,
  uint8_t* segind_out, uint8_t* vert_out, int32_t* seg2v) {
  TsCtx& c = *static_cast<TsCtx*>(ts);
  ArithDec& aec = c.coder.dec;
  const int max2bits = nbitsVertices > 1 ? 3 : 1;
  const int mid2bits = nbitsVertices > 1 ? 2 : 1;
  std::vector<uint8_t> verts;
  verts.reserve(size_t(nseg));
  int iV = 0;
  for (int i = 0; i < nseg; i++) {
    EdgeCtx e;
    deriveEdgeCtx(e, neighb[i], pattern + 18 * i, segind_out, seg2v,
                  verts.data(), nbitsVertices, max2bits, mid2bits);
    int cm1, cm2;
    flagCtxMaps(e, cm1, cm2);
    int present = c.map0.decodeEvolve(&aec, c.model, cm2, cm1,
                                      &c.leafNumber, c.leafBuf.data());
    segind_out[i] = uint8_t(present);
    seg2v[i] = -1;
    vert_out[i] = 0xff;
    if (!present)
      continue;
    seg2v[i] = iV;
    PosCtx p;
    posCtxMaps(e, p);
    int b = nbitsVertices - 1;
    uint8_t v = 0;
    int bit = c.map1.decodeEvolve(&aec, c.model, p.ctxMap2a, p.ctxMap1a,
                                  &c.leafNumber, c.leafBuf.data());
    v = uint8_t((v << 1) | bit);
    b--;
    if (b >= 0) {
      bit = c.map2.decodeEvolve(&aec, c.model, p.ctxMap2b,
                                (p.ctxMap1a << 1) + v,
                                &c.leafNumber, c.leafBuf.data());
      v = uint8_t((v << 1) | bit);
      b--;
    }
    if (b >= 0) {
      bit = aec.bit(&c.ctxTempV2[4 * p.reduced1 + v]);
      v = uint8_t((v << 1) | bit);
      b--;
    }
    for (; b >= 0; b--)
      v = uint8_t((v << 1) | aec.bypass());
    verts.push_back(v);
    vert_out[i] = v;
    iV++;
  }
  return iV;
}

// encode mirror (encodeTrisoupVertices, encoder :1079-1296)
extern "C" int tsref_enc_verts(
  void* ts, const uint16_t* neighb, const int32_t* pattern,
  int nseg, int nbitsVertices,
  const uint8_t* segind, const uint8_t* vert, int32_t* seg2v) {
  TsCtx& c = *static_cast<TsCtx*>(ts);
  ArithEnc& aec = c.coder.enc;
  const int max2bits = nbitsVertices > 1 ? 3 : 1;
  const int mid2bits = nbitsVertices > 1 ? 2 : 1;
  std::vector<uint8_t> verts;
  verts.reserve(size_t(nseg));
  int iV = 0;
  for (int i = 0; i < nseg; i++) {
    EdgeCtx e;
    deriveEdgeCtx(e, neighb[i], pattern + 18 * i, segind, seg2v,
                  verts.data(), nbitsVertices, max2bits, mid2bits);
    int cm1, cm2;
    flagCtxMaps(e, cm1, cm2);
    int present = segind[i] != 0;
    uint8_t idx0 = c.map0.getEvolve(present, cm2, cm1, &c.leafNumber,
                                    c.leafBuf.data());
    aec.bit_bounded(&c.model.prob[idx0 >> 3], idx0 >> 3, c.model.bound,
                    present);
    seg2v[i] = -1;
    if (!present)
      continue;
    seg2v[i] = iV;
    uint8_t vertex = vert[i];
    PosCtx p;
    posCtxMaps(e, p);
    int b = nbitsVertices - 1;
    int v = 0;
    int bit = (vertex >> b--) & 1;
    uint8_t idx1 = c.map1.getEvolve(bit, p.ctxMap2a, p.ctxMap1a,
                                    &c.leafNumber, c.leafBuf.data());
    aec.bit_bounded(&c.model.prob[idx1 >> 3], idx1 >> 3, c.model.bound,
                    bit);
    v = bit;
    if (b >= 0) {
      bit = (vertex >> b--) & 1;
      uint8_t idx2 = c.map2.getEvolve(bit, p.ctxMap2b,
                                      (p.ctxMap1a << 1) + v,
                                      &c.leafNumber, c.leafBuf.data());
      aec.bit_bounded(&c.model.prob[idx2 >> 3], idx2 >> 3,
                      c.model.bound, bit);
      v = (v << 1) | bit;
    }
    if (b >= 0) {
      bit = (vertex >> b--) & 1;
      aec.bit(&c.ctxTempV2[4 * p.reduced1 + v], bit);
      v = (v << 1) | bit;
    }
    for (; b >= 0; b--)
      aec.bypass((vertex >> b) & 1);
    verts.push_back(vertex);
    iV++;
  }
  return iV;
}

// centroid drift residues (decodeTrisoupCentroids :981-1019).  One
// call per brick; cctx rows are the per-eligible-node
// (ctxMinMax, lowBound, highBound, lowBoundSurface, highBoundSurface)
// in leaf order.
extern "C" int tsref_dec_centroids(
  void* ts, const int32_t* cctx, int n, int32_t* driftq_out) {
  TsCtx& c = *static_cast<TsCtx*>(ts);
  ArithDec& aec = c.coder.dec;
  for (int i = 0; i < n; i++) {
    int ctxMinMax = cctx[5 * i + 0];
    int lowBound = cctx[5 * i + 1];
    int highBound = cctx[5 * i + 2];
    int lowBoundSurface = cctx[5 * i + 3];
    int highBoundSurface = cctx[5 * i + 4];
    int driftQ = aec.bit(&c.ctxDrift0[ctxMinMax]) ? 0 : 1;
    if (driftQ) {
      int lowS = lowBoundSurface > 7 ? 7 : lowBoundSurface;
      int highS = highBoundSurface > 7 ? 7 : highBoundSurface;
      int sign = 1;
      if (highBound && lowBound)
        sign = aec.bit(&c.ctxDriftSign[lowBound == highBound
                         ? 0 : 1 + (lowBound < highBound)][lowS][highS]);
      else if (!highBound)
        sign = 0;
      int magBound = (sign ? highBound : lowBound) - 1;
      int ctx = 0;
      while (magBound > 0) {
        int bit;
        if (ctx < 4)
          bit = aec.bit(&c.ctxDriftMag[ctx]);
        else
          bit = aec.bypass();
        if (bit)
          break;
        driftQ++;
        magBound--;
        ctx++;
      }
      if (!sign)
        driftQ = -driftQ;
    }
    driftq_out[i] = driftQ;
  }
  return 0;
}

// encoder mirror (encodeTrisoupCentroidResidue, encoder :1299-1345)
extern "C" int tsref_enc_centroids(
  void* ts, const int32_t* cctx, const int32_t* driftq, int n) {
  TsCtx& c = *static_cast<TsCtx*>(ts);
  ArithEnc& aec = c.coder.enc;
  for (int i = 0; i < n; i++) {
    int ctxMinMax = cctx[5 * i + 0];
    int lowBound = cctx[5 * i + 1];
    int highBound = cctx[5 * i + 2];
    int lowBoundSurface = cctx[5 * i + 3];
    int highBoundSurface = cctx[5 * i + 4];
    int driftQ = driftq[i];
    aec.bit(&c.ctxDrift0[ctxMinMax], driftQ == 0);
    if (driftQ) {
      int lowS = lowBoundSurface > 7 ? 7 : lowBoundSurface;
      int highS = highBoundSurface > 7 ? 7 : highBoundSurface;
      if (highBound && lowBound)
        aec.bit(&c.ctxDriftSign[lowBound == highBound
                  ? 0 : 1 + (lowBound < highBound)][lowS][highS],
                driftQ > 0);
      int mag = driftQ > 0 ? driftQ : -driftQ;
      int magBound = (driftQ > 0 ? highBound : lowBound) - 1;
      int ctx = 0;
      while (magBound > 0) {
        int bit = (mag == 1);
        if (ctx < 4)
          aec.bit(&c.ctxDriftMag[ctx], bit);
        else
          aec.bypass(bit);
        if (bit)
          break;
        mag--;
        magBound--;
        ctx++;
      }
    }
  }
  return 0;
}

// face-connect flags: the caller supplies only the judged candidates
// (decodeTrisoupFaceList :899; non-candidates never reach the coder)
extern "C" int tsref_dec_faces(void* ts, int n, uint8_t* out) {
  TsCtx& c = *static_cast<TsCtx*>(ts);
  for (int i = 0; i < n; i++)
    out[i] = uint8_t(c.coder.dec.bit(&c.ctxFaces));
  return 0;
}

extern "C" int tsref_enc_faces(void* ts, const uint8_t* bits, int n) {
  TsCtx& c = *static_cast<TsCtx*>(ts);
  for (int i = 0; i < n; i++)
    c.coder.enc.bit(&c.ctxFaces, bits[i] != 0);
  return 0;
}

// finish an encode-side brick: flush the shared coder and copy bytes
extern "C" int tsref_enc_finish(void* ts, uint8_t* out, int cap) {
  TsCtx& c = *static_cast<TsCtx*>(ts);
  c.coder.enc.flush();
  int n = int(c.coder.enc.out.size());
  if (n > cap)
    return -1;
  std::memcpy(out, c.coder.enc.out.data(), size_t(n));
  return n;
}
