// Level-sweep OBUF octree geometry encoder.
//
// The TPU-first restructuring of the reference's octree geometry
// engine (SURVEY.md §7 step 3): instead of the reference's per-node
// BFS with interleaved entropy coding
// (tmc3/geometry_octree_encoder.cpp:1853-2660), the
// whole tree is processed level-by-level in struct-of-arrays form:
//
//   1. points are key-sorted ONCE by the QTBT-generalised Morton code
//      (replaces the per-node counting sort,
//       geometry_octree_encoder.cpp:2210-2218);
//   2. per level, a BATCHED analysis pass computes every context
//      input for every node: occupancy words (segmented scan over the
//      sorted keys), neighbour patterns and adjacency words (gathers
//      from a cube atlas that is filled UP FRONT for the whole level
//      -- legal at encode time because every gated neighbour read
//      targets a lower-Morton in-cube node, cf. OctreeNeighMap.cpp),
//      inter predOcc (segmented scan over reference keys), planar
//      decisions, and the per-bit OBUF context indices
//      (makeGeometryAdvancedNeighPattern0..7);
//   3. the analysis pass emits a flat TOKEN STREAM; a thin serial
//      loop then replays only the normative context evolution
//      (CtxMapDynamicOBUF, geometry_octree.h:328-613) and arithmetic
//      coding -- nothing else is sequential.
//
// The emitted bytes are BYTE-IDENTICAL to the conformance oracle
// (refcodec.cc) and therefore to the reference encoder on the shared
// tool set; tests/test_obuf_ls.py asserts this.  The batched analysis
// is the part that maps onto the TPU (ops/octree_obuf.py mirrors it
// with array ops and is tested equal); the token loop is the thin
// host stage of SURVEY.md §7's two-phase entropy pipeline.

#include "obuf_core.h"

#include <algorithm>

namespace {

using namespace obufcore;

// ---------------------------------------------------------------------------
// token stream: one u32 per coded bin, produced by the batched
// analysis, consumed by the thin coding loop.
//   kind(3) | sel(5) | c1(8) | c2(13) | bit(1)
// ---------------------------------------------------------------------------
enum TokKind {
  kTokAdapt = 0,    // adaptive bit: c1 = flat context index
  kTokBypass = 1,   // bypass bit
  kTokOcc = 2,      // OBUF occupancy bit: sel = interCtx<<4|sparse<<3|i
  kTokPlanar = 3,   // OBUF planar-position bit: sel = planeId
  kTokEg = 4,       // exp-golomb(k=0) on the dup-count context;
                    //   value taken from the side queue
};

static inline uint32_t mkTok(int kind, int sel, int c1, int c2,
                             int bit) {
  return uint32_t(kind) << 29 | uint32_t(sel) << 24
    | uint32_t(c1) << 16 | uint32_t(c2) << 1 | uint32_t(bit);
}

// flat adaptive-context indices (the uint16 contexts of RefOctreeCtx)
enum FlatCtx {
  kCtxSingleChild = 0,
  kCtxDupGt0 = 1,
  kCtxDupEgl = 2,
  kCtxMultiPlanar = 3,
  kCtxPlanarMode0 = 4,                  // +ctxIdxPlanarFlag (9)
  kCtxPlaneLastIndexZ0 = 13,            // +planePosCtx[Tmp] (9)
  kCtxPlaneLastIndex0 = 22,             // +rp*108+pid*12+ppc*4+lip (324)
  kCtxPlanarCopyMode0 = 346,            // +ctxBufPCM*8+refMode (128)
  kNumFlatCtx = 474,
};

struct TokenSink {
  std::vector<uint32_t> tokBuf;
  uint32_t* tp = nullptr;
  uint32_t* tpBase = nullptr;
  std::vector<uint32_t> egVals;

  void reserve(size_t cap) {
    if (tokBuf.size() < cap)
      tokBuf.resize(cap);
    tpBase = tp = tokBuf.data();
  }
  void clear() {
    tp = tpBase = tokBuf.data();
    egVals.clear();
  }
  size_t size() const { return size_t(tp - tpBase); }
  void adapt(int flatIdx, int bit) {
    // the flat index rides the wide c2 field (13 bits) so the
    // context table can exceed 256 entries
    *tp++ = mkTok(kTokAdapt, 0, 0, flatIdx, bit);
  }
  void bypass(int bit) { *tp++ = mkTok(kTokBypass, 0, 0, 0, bit); }
  void occ(int interCtx, int sparse, int i, int c1, int c2, int bit) {
    *tp++ = mkTok(kTokOcc, interCtx << 4 | sparse << 3 | i, c1, c2,
                  bit);
  }
  void planarPos(int refPlane, int planeId, int c1, int c2, int bit) {
    *tp++ = mkTok(kTokPlanar, refPlane * 3 + planeId, c1, c2, bit);
  }
  void eg(uint32_t value) {
    *tp++ = mkTok(kTokEg, 0, 0, 0, 0);
    egVals.push_back(value);
  }
};

// ---------------------------------------------------------------------------
// coding state for the thin loop: packed OBUF maps + flat contexts
// ---------------------------------------------------------------------------
struct LsCtx {
  uint16_t flat[kNumFlatCtx];
  ObufModel obufModel;
  CtxMapOBUFPk mapOcc[2][8];        // [interCtx][bit]
  CtxMapOBUFPk mapOccSparse[2][8];
  std::vector<uint8_t> leaves;
  int leafNumber = 0;

  CtxMapOBUFPk mapPlanarPos[3][3];  // [refPlane][planeId]
  ObufModel planarModel[3];
  std::vector<uint8_t> planarLeaves;
  int planarLeafNumber = 0;

  void reset(bool enablePlanar) {
    for (int i = 0; i < kNumFlatCtx; i++) flat[i] = 0x8000;
    // GeometryOctreeContexts::resetMap (geometry_octree.cpp:877)
    const int n2 = 6;
    for (int i = 0; i < 2; i++) {
      for (int k = 0; k < 8; k++) {
        int bits1 = (k == 3 || k == 7) ? (4 + n2 + 1) : (6 + n2 + 1);
        mapOcc[i][k].reset(bits1, 18 - 6 - n2);
      }
      static const int sparseBits2[8] = {9 - 5, 12 - 5, 12 - 5, 11 - 5,
                                         9 - 5, 12 - 5, 12 - 5, 11 - 5};
      for (int k = 0; k < 8; k++)
        mapOccSparse[i][k].reset(6 + 5 + 1, sparseBits2[k]);
    }
    leaves.assign(size_t(CtxMapOBUFPk::kLeafBufSize)
                    << CtxMapOBUFPk::kLeafDepth, 0);
    leafNumber = 0;
    obufModel.init();
    if (enablePlanar) {
      for (int k = 0; k < 3; k++) {
        for (int r = 0; r < 3; r++)
          mapPlanarPos[r][k].reset(10, 8);
        planarModel[k].init();
      }
      planarLeaves.assign(size_t(CtxMapOBUFPk::kLeafBufSize)
                            << CtxMapOBUFPk::kLeafDepth, 0);
      planarLeafNumber = 0;
    }
  }
};

// thin coding loop: the ONLY serial stage.  Dispatches the token
// stream into context evolution + arithmetic coding.
__attribute__((flatten)) static void codeTokens(ArithEnc& aec, LsCtx& ctx, TokenSink& tk) {
  const uint32_t* t = tk.tpBase;
  const size_t n = tk.size();
  size_t egPos = 0;
  for (size_t k = 0; k < n; k++) {
    uint32_t v = t[k];
    int kind = v >> 29;
    int bit = v & 1;
    if (__builtin_expect(kind == kTokOcc, 1)) {
      int sel = (v >> 24) & 31;
      int c1 = (v >> 16) & 255, c2 = (v >> 1) & 0x1FFF;
      CtxMapOBUFPk& m = (sel & 8)
        ? ctx.mapOccSparse[(sel >> 4) & 1][sel & 7]
        : ctx.mapOcc[(sel >> 4) & 1][sel & 7];
      uint8_t obufIdx = m.getEvolve(bit, c2, c1, &ctx.leafNumber,
                                    ctx.leaves.data());
      aec.bit_bounded(&ctx.obufModel.prob[obufIdx >> 3], obufIdx >> 3,
                      ctx.obufModel.bound, bit);
    } else if (kind == kTokAdapt) {
      aec.bit(&ctx.flat[(v >> 1) & 0x1FFF], bit);
    } else if (kind == kTokBypass) {
      aec.bypass(bit);
    } else if (kind == kTokPlanar) {
      int sel = (v >> 24) & 31;
      int rp = sel / 3, pid = sel % 3;
      int c1 = (v >> 16) & 255, c2 = (v >> 1) & 0x1FFF;
      uint8_t obufIdx = ctx.mapPlanarPos[rp][pid].getEvolve(
        bit, c2, c1, &ctx.planarLeafNumber, ctx.planarLeaves.data());
      aec.bit_bounded(&ctx.planarModel[pid].prob[obufIdx >> 3],
                      obufIdx >> 3, ctx.planarModel[pid].bound, bit);
    } else {
      aec.exp_golomb(tk.egVals[egPos++], 0, &ctx.flat[kCtxDupEgl]);
    }
  }
}

// ---------------------------------------------------------------------------
// batched analysis: planar-mode token emission.  Mirrors
// determinePlanarIntraEnc / determinePlanarPlane /
// encodePlanarModeIntra (refcodec.cc, from
// geometry_octree_encoder.cpp) with tokens in place of coder calls.
// All decisions are occupancy-deterministic at encode time.
// ---------------------------------------------------------------------------

static void emitPlanarModeIntra(
  TokenSink& tk, bool multiplePlanar, bool dynObuf, NodePlanar& planar,
  int planeZ, int dist, int adjPlanes, int planeId,
  const bool* multiPlanarFlag, const bool* multiPlanarEligible,
  const NodePlanar adjNeighPlanar[7], bool neighAvai,
  uint32_t neighOccu, int& planeBitOut,
  const NodePlanar* planarRefArg = nullptr) {
  const int mask0 = 1 << planeId;
  static const int kMask1[3] = {6, 5, 3};
  static const NodePlanar kZeroRef;
  const NodePlanar& planarRef = planarRefArg ? *planarRefArg : kZeroRef;

  bool isPlanar = planar.planarMode & mask0;
  int planeBit = (planar.planePosBits & mask0) ? 1 : 0;

  bool isPlanarRef = (planarRef.planarMode & mask0) != 0;
  int planeBitRef = (planarRef.planePosBits & mask0) ? 1 : 0;
  int ctxIdxPlanarFlag = planeId;
  if (isPlanarRef)
    ctxIdxPlanarFlag += 3 * (planeBitRef + 1);

  if (!planar.isPCM) {
    if (multiplePlanar) {
      static const int planeId2Index[3][3] = {{0, 1, 2}, {0, 1, 3},
                                              {0, 2, 3}};
      bool multiPlanarFlagFalse = true;
      for (int i = 0; i < 3; i++)
        multiPlanarFlagFalse &= !multiPlanarFlag[
          planeId2Index[planeId][i]];
      bool inferredPlanarFalse = multiPlanarFlagFalse;
      if (multiPlanarFlagFalse) {
        if (planeId == 2) {
          if (multiPlanarEligible[0])
            inferredPlanarFalse =
              !((planar.planarMode & 2) && (planar.planarMode & 1));
          else if (multiPlanarEligible[2])
            inferredPlanarFalse = !(planar.planarMode & 1);
          else if (multiPlanarEligible[3])
            inferredPlanarFalse = !(planar.planarMode & 2);
        } else if (planeId == 1) {
          if (multiPlanarEligible[1])
            inferredPlanarFalse = !(planar.planarMode & 1);
        }
      }
      if (inferredPlanarFalse)
        tk.adapt(kCtxPlanarMode0 + ctxIdxPlanarFlag, isPlanar);
    } else {
      tk.adapt(kCtxPlanarMode0 + ctxIdxPlanarFlag, isPlanar);
    }
  }

  if (!isPlanar) {
    planar.planarPossible &= kMask1[planeId];
    planeBitOut = -1;
    return;
  }

  if (planar.isPCM) {
    planeBitOut = planeBit;
    return;
  }
  // inferred inverted bit (encoder :390-399)
  if (planeId == planar.lastDirIdx && planar.isPreDirMatch
      && planar.allowPCM && isPlanarRef) {
    planeBitOut = planeBit;
    return;
  }

  const int refPlane = isPlanarRef ? 1 + planeBitRef : 0;
  int planePosCtx = kAdjPlaneCtx[adjPlanes];
  if (dynObuf) {
    int discreteDist;
    if (planeZ < 0) {
      discreteDist = 1;
      planeZ = 0;
    } else {
      discreteDist = dist > (8 >> PlanarBuffer::kShiftAb);
    }
    int lastIndexPlane2d = planeZ + (discreteDist << 1);
    int c1, c2;
    planarPosObufCtx(planeId, lastIndexPlane2d, planePosCtx,
                     adjNeighPlanar, neighAvai, neighOccu, c1, c2);
    tk.planarPos(refPlane, planeId, c1, c2, planeBit);
  } else {
    if (planeZ < 0) {
      int planePosCtxTmp = planePosCtx;
      if (isPlanarRef)
        planePosCtxTmp += 3 * (planeBitRef + 1);
      tk.adapt(kCtxPlaneLastIndexZ0 + planePosCtxTmp, planeBit);
    } else {
      int discreteDist = dist > (8 >> PlanarBuffer::kShiftAb);
      int lastIndexPlane2d = planeZ + (discreteDist << 1);
      tk.adapt(kCtxPlaneLastIndex0 + refPlane * 108 + planeId * 12
                 + planePosCtx * 4 + lastIndexPlane2d, planeBit);
    }
  }
  planeBitOut = planeBit;
}

__attribute__((flatten)) static void emitPlanarIntra(
  TokenSink& tk, PlanarState& planarState, const GeomParams& gp,
  bool dynObuf, const bool planarEligible[3], int posInParent,
  const NeighPattern& gnp, const int32_t childPos[3],
  uint8_t siblingOccupancy, int occupancy, NodePlanar& planar,
  NodePlanar* planarRef = nullptr) {
  planesFromOccupancy(occupancy, planar);

  NodePlanar adjNeighPlanar[7];
  if (dynObuf && gnp.neighOccuValid)
    for (int idx = 0; idx < 7; ++idx)
      if (gnp.adjOcc[idx])
        planesFromOccupancy(gnp.adjOcc[idx], adjNeighPlanar[idx]);

  uint8_t mask = 0;
  mask |= planarEligible[2] << 2;
  mask |= planarEligible[1] << 1;
  mask |= planarEligible[0] << 0;
  planar.planarMode &= mask;
  planar.planePosBits &= mask;

  if (planarRef) {
    // inter: PCM copy-mode decision + flag
    // (determinePlanarMode, geometry_octree_encoder.cpp:687-725)
    planarRef->planarMode &= mask;
    planarRef->planePosBits &= mask;
    bool matchDir[3];
    for (int planeId = 0; planeId < 3; planeId++) {
      const int m0 = 1 << planeId;
      if (!planarEligible[planeId]) {
        matchDir[planeId] = true;
        continue;
      }
      bool isPlanar = (planar.planarMode & m0) != 0;
      int planeBit = (planar.planePosBits & m0) ? 1 : 0;
      bool isPlanarRef = (planarRef->planarMode & m0) != 0;
      int planeBitRef = (planarRef->planePosBits & m0) ? 1 : 0;
      matchDir[planeId] =
        isPlanar == isPlanarRef && planeBit == planeBitRef;
    }
    planar.isPCM = planar.allowPCM && matchDir[0] && matchDir[1]
      && matchDir[2];
    if (planar.allowPCM)
      derivePlanarPCMCtxBuf(planar, *planarRef, planarState, childPos);
    if (!planar.isSignaled && planar.allowPCM) {
      tk.adapt(kCtxPlanarCopyMode0 + planarRef->ctxBufPCM * 8
                 + planarRef->planarMode,
               planar.isPCM);
      planar.isSignaled = true;
    }
  }

  bool multiPlanarFlag[4] = {false, false, false, false};
  bool multiPlanarEligible[4] = {false, false, false, false};
  if (planarState.multiplePlanar && !planar.isPCM) {
    int kind = kindOfEligible(planarEligible);
    if (kind >= 0) {
      multiPlanarEligible[kind] = true;
      bool v;
      if (kind == 0)
        v = (occupancy & (occupancy - 1)) == 0;
      else if (kind == 1)
        v = (planar.planarMode & 1) && (planar.planarMode & 2);
      else if (kind == 2)
        v = (planar.planarMode & 1) && (planar.planarMode & 4);
      else
        v = (planar.planarMode & 2) && (planar.planarMode & 4);
      multiPlanarFlag[kind] = v;
      tk.adapt(kCtxMultiPlanar, v);
    }
  }

  struct Dir {
    int planeId, c1, c2, c3;
  };
  const Dir dirs[3] = {{0, childPos[1], childPos[2], childPos[0]},
                       {1, childPos[0], childPos[2], childPos[1]},
                       {2, childPos[0], childPos[1], childPos[2]}};
  static const int kAdjNeighIdxFromPlanePos[3][2] = {{1, 0}, {2, 3},
                                                     {4, 5}};
  static const uint8_t kAdjNeighIdxMask[3][2] = {{0x0f, 0xf0},
                                                 {0x33, 0xcc},
                                                 {0x55, 0xaa}};
  for (const Dir& d : dirs) {
    if (!planarEligible[d.planeId])
      continue;
    const int planeId = d.planeId;
    PlanarBuffer::Elmt* planeBuffer = planarState.bufferEnabled
      ? planarState.buffer.col(planeId) : nullptr;
    // determinePlanarPlane (refcodec.cc; decoder :556)
    PlanarBuffer::Elmt* row = nullptr;
    int closestPlanarFlag;
    int closestDist;
    int maxCoord = 0;
    int coord1 = d.c1, coord2 = d.c2, coord3 = d.c3;
    if (!planeBuffer) {
      closestPlanarFlag = -1;
      closestDist = 0;
    } else {
      coord1 =
        (coord1 & PlanarBuffer::kMaskAb) >> PlanarBuffer::kShiftAb;
      coord2 =
        (coord2 & PlanarBuffer::kMaskAb) >> PlanarBuffer::kShiftAb;
      coord3 = coord3 & PlanarBuffer::kMaskC;
      row = &planeBuffer[coord3];
      maxCoord = std::max(coord1, coord2);
      closestDist = std::abs(maxCoord - int(row[0].pos));
      closestPlanarFlag = row[0].planeIdx;
    }

    int pos = !(kAdjNeighIdxMask[planeId][0] & (1 << posInParent));
    bool lowAdj = gp.adjacentChildCtx != 0
      ? (kAdjNeighIdxMask[planeId][1] & gnp.adjOcc[planeId]) != 0
      : ((gnp.pattern >> kAdjNeighIdxFromPlanePos[planeId][0]) & 1)
        != 0;
    bool highAdj = !pos
      ? (kAdjNeighIdxMask[planeId][1] & siblingOccupancy) != 0
      : ((gnp.pattern >> kAdjNeighIdxFromPlanePos[planeId][1]) & 1)
        != 0;
    int adjPlanes = (int(highAdj) << 1) | int(lowAdj);

    int planeBit;
    emitPlanarModeIntra(tk, planarState.multiplePlanar, dynObuf,
                        planar, closestPlanarFlag, closestDist,
                        adjPlanes, planeId, multiPlanarFlag,
                        multiPlanarEligible, adjNeighPlanar,
                        gnp.neighOccuValid, gnp.neighborOccu,
                        planeBit, planarRef);
    bool isPlanar = (planar.planarMode & (1 << planeId)) != 0;
    planarState.rate[planeId] =
      (255 * planarState.rate[planeId] + (isPlanar ? 256 * 8 : 0)
       + 128) >> 8;
    if (planeBuffer)
      *row = PlanarBuffer::Elmt{uint8_t(maxCoord), int8_t(planeBit)};
    if (planarRef) {
      bool isPlanarRef =
        (planarRef->planarMode & (1 << planeId)) != 0;
      int planeBitRef =
        (planarRef->planePosBits & (1 << planeId)) ? 1 : 0;
      if (!(isPlanar == isPlanarRef && planeBit == planeBitRef))
        planar.isPreDirMatch = false;
    }
  }
}

// ---------------------------------------------------------------------------
// batched analysis: occupancy token emission.  Mirrors
// encodeOccupancy (refcodec.cc; geometry_octree_encoder.cpp:815-982)
// with tokens in place of coder calls; NeighInfo comes precomputed
// from the level pass.
// ---------------------------------------------------------------------------
__attribute__((flatten)) static void emitOccupancy(
  TokenSink& tk, const NeighPattern& gnp, NeighInfo& nf, int occupancy,
  int planarMaskX, int planarMaskY, int planarMaskZ,
  bool planarPossibleX, bool planarPossibleY, bool planarPossibleZ,
  int predOcc) {
  if (planarMaskX && planarMaskY && planarMaskZ)
    return;
  bool flagNoSingle = false;
  if (gnp.pattern == 0
      && (!predOcc || (planarMaskX | planarMaskY | planarMaskZ))) {
    int pc = occupancy & (occupancy - 1);
    bool singleChild = pc == 0;
    if (planarPossibleX && planarPossibleY && planarPossibleZ)
      tk.adapt(kCtxSingleChild, singleChild);
    if (singleChild) {
      if (!planarMaskZ) tk.bypass(!!(occupancy & 0xaa));
      if (!planarMaskY) tk.bypass(!!(occupancy & 0xcc));
      if (!planarMaskX) tk.bypass(!!(occupancy & 0xf0));
      return;
    }
    flagNoSingle = true;
    if (planarMaskX && planarMaskY) return;
    if (planarMaskY && planarMaskZ) return;
    if (planarMaskX && planarMaskZ) return;
  }

  const bool surePlanarityX = planarMaskX || !planarPossibleX;
  const bool surePlanarityY = planarMaskY || !planarPossibleY;
  const bool surePlanarityZ = planarMaskZ || !planarPossibleZ;
  const int maxPerPlaneX = (planarMaskX && flagNoSingle) ? 2 : 3;
  const int maxPerPlaneY = (planarMaskY && flagNoSingle) ? 2 : 3;
  const int maxPerPlaneZ = (planarMaskZ && flagNoSingle) ? 2 : 3;
  const int maxAll = flagNoSingle ? 6 : 7;

  int maskConfig = (!!planarMaskX) * (1 + (planarMaskX != 0x0F));
  maskConfig += (!!planarMaskY) * 3 * (1 + (planarMaskY != 0x33));
  maskConfig += (!!planarMaskZ) * 9 * (1 + (planarMaskZ != 0x55));
  int coded0[6] = {0, 0, 0, 0, 0, 0};
  if (maskConfig)
    std::memcpy(coded0, kInitCoded0[maskConfig], sizeof coded0);

  int maskedOccupancy = planarMaskX | planarMaskY | planarMaskZ;
  for (int i = 0; i < 8; i++) {
    if ((maskedOccupancy >> i) & 1)
      continue;
    int mask0X = (0xf0 >> i) & 1;
    int mask0Y = 2 + ((0xcc >> i) & 1);
    int mask0Z = 4 + ((0xaa >> i) & 1);
    bool bitIsOne = (surePlanarityX && coded0[mask0X] >= maxPerPlaneX)
      || (coded0[0] + coded0[1] >= maxAll)
      || (surePlanarityY && coded0[mask0Y] >= maxPerPlaneY)
      || (coded0[2] + coded0[3] >= maxAll)
      || (surePlanarityZ && coded0[mask0Z] >= maxPerPlaneZ)
      || (coded0[4] + coded0[5] >= maxAll);
    if (bitIsOne)
      continue;
    const int interCtx = (predOcc >> i) & 1;
    int c1, c2;
    bool sparse;
    ctxBitDispatch(i, nf, occupancy, c1, c2, sparse);
    int bitv = (occupancy >> i) & 1;
    tk.occ(interCtx, sparse ? 1 : 0, i, c1, c2, bitv);
    coded0[mask0X] += !bitv;
    coded0[mask0Y] += !bitv;
    coded0[mask0Z] += !bitv;
  }
}

// ---------------------------------------------------------------------------
// level-sweep encoder
// ---------------------------------------------------------------------------

// LSD radix sort of raw 64-bit keys over the low `bits` bits
static void radixSortKeys(std::vector<uint64_t>& keys, int bits) {
  const int kDigit = 11;
  const int kRadix = 1 << kDigit;
  std::vector<uint64_t> tmp(keys.size());
  size_t hist[kRadix];  // stack: thread-safe (slice-parallel encode)
  for (int sh = 0; sh < bits; sh += kDigit) {
    std::memset(hist, 0, sizeof hist);
    for (uint64_t k : keys) hist[(k >> sh) & (kRadix - 1)]++;
    size_t acc = 0;
    for (int d = 0; d < kRadix; d++) {
      size_t c = hist[d];
      hist[d] = acc;
      acc += c;
    }
    for (uint64_t k : keys) tmp[hist[(k >> sh) & (kRadix - 1)]++] = k;
    keys.swap(tmp);
  }
}

// per-level node metadata for the top-down sweep (node keys and
// occupancies come precomputed from the bottom-up construction)
struct Level {
  std::vector<int32_t> px, py, pz;
  std::vector<uint8_t> sibOcc, numSib, mispred;
  void resize(size_t m) {
    px.resize(m); py.resize(m); pz.resize(m);
    sibOcc.resize(m); numSib.resize(m); mispred.resize(m);
  }
};

__attribute__((flatten)) static void analyzeNeighRange(
  NeighPattern* gnpA, NeighInfo* nfA, const Level& cur, size_t g0,
  size_t g1, bool adjChildCtx, int codedAxesPrevLvl,
  const Atlas& atlas, bool dynK) {
  for (size_t n = g0; n < g1; n++) {
    int32_t pos3[3] = {cur.px[n], cur.py[n], cur.pz[n]};
    gnpA[n] = makeNeighPattern(adjChildCtx, pos3, codedAxesPrevLvl,
                               atlas, dynK);
    prepareNeighInfo(nfA[n], gnpA[n], pos3, codedAxesPrevLvl, atlas,
                     dynK);
  }
}


static int obufls_encode_impl(
  const int32_t* positions, int num_points,
  const int32_t* ref_positions, int num_ref,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr, uint8_t* out_buf, int out_cap,
  uint32_t* dbg_toks = nullptr, int dbg_cap = 0,
  int32_t* dbg_lvl_counts = nullptr) {
  long dbgPos = 0;
  GeomParams gp;
  std::memcpy(&gp, gp_arr, sizeof gp);
  if (gp.neighAvailBoundaryLog2 < 1 || gp.neighAvailBoundaryLog2 > 9)
    return -2;
  if (num_levels > 21 || num_levels < 1)
    return -3;  // key would not fit 64 bits; caller falls back
  if (gp.idcmMode)
    return -3;  // IDCM early termination: BFS oracle handles it

  // per-level child size log2s (mirrors refcodec lvlSize derivation)
  std::vector<int> lvlSize[3];
  {
    int size[3] = {0, 0, 0};
    std::vector<int> acc[3];
    for (int k = 0; k < 3; k++) acc[k].push_back(0);
    for (int i = num_levels - 1; i >= 0; i--) {
      int split = coded_axis_list[i];
      size[0] += !!(split & 4);
      size[1] += !!(split & 2);
      size[2] += !!(split & 1);
      for (int k = 0; k < 3; k++) acc[k].push_back(size[k]);
    }
    for (int k = 0; k < 3; k++) {
      lvlSize[k].assign(acc[k].rbegin(), acc[k].rend());
      lvlSize[k].push_back(lvlSize[k].back());
    }
  }
  const int L = num_levels;

  // generalised Morton keys: 3 bits per level in coding order; the
  // bucket of a point at level d is the key field at shift 3*(L-1-d)
  int32_t probeXs[24], probeYs[24], probeZs[24];
  for (int d = 0; d < L; d++) {
    int coded = coded_axis_list[d];
    probeXs[d] =
      (coded & 4) ? (int32_t(1) << lvlSize[0][d + 1]) : 0;
    probeYs[d] =
      (coded & 2) ? (int32_t(1) << lvlSize[1][d + 1]) : 0;
    probeZs[d] =
      (coded & 1) ? (int32_t(1) << lvlSize[2][d + 1]) : 0;
  }
  auto buildKeys = [&](const int32_t* pts, int n,
                       std::vector<uint64_t>& keys) {
    keys.resize(size_t(n));
    for (int p = 0; p < n; p++) {
      const int32_t x = pts[size_t(p) * 3], y = pts[size_t(p) * 3 + 1],
        z = pts[size_t(p) * 3 + 2];
      uint64_t key = 0;
      for (int d = 0; d < L; d++) {
        int b = (!!(z & probeZs[d])) | (!!(y & probeYs[d]) << 1)
          | (!!(x & probeXs[d]) << 2);
        key = (key << 3) | uint64_t(b);
      }
      keys[size_t(p)] = key;
    }
  };

  std::vector<uint64_t> keys, rkeys;
  buildKeys(positions, num_points, keys);
  radixSortKeys(keys, 3 * L);
  if (num_ref > 0) {
    buildKeys(ref_positions, num_ref, rkeys);
    radixSortKeys(rkeys, 3 * L);
  }

  // ---- bottom-up linear-octree construction -----------------------
  // lvlKey[d] holds the sorted node keys (3*d-bit prefixes) of level
  // d; lvlOcc[d] the child-occupancy words.  One O(nodes) pass per
  // level replaces the reference's per-node counting sort over points
  // (geometry_octree_encoder.cpp:2210).
  std::vector<std::vector<uint64_t>> lvlKey((size_t)L + 1);
  std::vector<std::vector<uint8_t>> lvlOcc((size_t)L);
  std::vector<int32_t> leafCnt;       // points per unique leaf key
  {
    std::vector<uint64_t>& lk = lvlKey[size_t(L)];
    lk.reserve(size_t(num_points));
    leafCnt.reserve(size_t(num_points));
    for (int p = 0; p < num_points;) {
      uint64_t k = keys[size_t(p)];
      int q = p + 1;
      while (q < num_points && keys[size_t(q)] == k)
        q++;
      lk.push_back(k);
      leafCnt.push_back(q - p);
      p = q;
    }
  }
  for (int d = L - 1; d >= 0; d--) {
    const std::vector<uint64_t>& ck = lvlKey[size_t(d) + 1];
    std::vector<uint64_t>& pk = lvlKey[size_t(d)];
    std::vector<uint8_t>& po = lvlOcc[size_t(d)];
    pk.reserve(ck.size());
    po.reserve(ck.size());
    size_t i = 0;
    while (i < ck.size()) {
      uint64_t parent = ck[i] >> 3;
      int occ = 0;
      do {
        occ |= 1 << int(ck[i] & 7);
        i++;
      } while (i < ck.size() && (ck[i] >> 3) == parent);
      pk.push_back(parent);
      po.push_back(uint8_t(occ));
    }
  }
  std::vector<std::vector<uint64_t>> refKey;
  std::vector<std::vector<uint8_t>> refOcc;
  if (num_ref > 0) {
    refKey.resize(size_t(L) + 1);
    refOcc.resize(size_t(L));
    std::vector<uint64_t>& lk = refKey[size_t(L)];
    lk.reserve(size_t(num_ref));
    for (int p = 0; p < num_ref;) {
      uint64_t k = rkeys[size_t(p)];
      int q = p + 1;
      while (q < num_ref && rkeys[size_t(q)] == k)
        q++;
      lk.push_back(k);
      p = q;
    }
    for (int d = L - 1; d >= 0; d--) {
      const std::vector<uint64_t>& ck = refKey[size_t(d) + 1];
      std::vector<uint64_t>& pk = refKey[size_t(d)];
      std::vector<uint8_t>& po = refOcc[size_t(d)];
      pk.reserve(ck.size());
      po.reserve(ck.size());
      size_t i = 0;
      while (i < ck.size()) {
        uint64_t parent = ck[i] >> 3;
        int occ = 0;
        do {
          occ |= 1 << int(ck[i] & 7);
          i++;
        } while (i < ck.size() && (ck[i] >> 3) == parent);
        pk.push_back(parent);
        po.push_back(uint8_t(occ));
      }
    }
  }

  ArithEnc aec;
  aec.chunked = gp.cabacBypassStream != 0;
  aec.init();
  aec.out.reserve(size_t(num_points) * 2 + 1024);
  aec.bypassNoUpdate = gp.bypassNoUpdate != 0;
  LsCtx ctx;
  ctx.reset(gp.planarEnabled != 0);

  PlanarState planarState;
  planarState.bufferEnabled =
    gp.planarEnabled && gp.planarBufferEnabled;
  planarState.multiplePlanar = gp.planarEnabled && gp.multiplePlanar;
  for (int k = 0; k < 3; k++)
    planarState.rateThreshold[k] = gp.planarTh[k] << 4;
  const bool dynObuf =
    gp.planarEnabled && gp.planarDynamicObufEligibility;
  const bool checkPlanarDepthEligibility =
    gp.planarEnabled && gp.depthPlanarEligibility;
  bool planarEligibleKDepth = false;
  int nodesBeforePlanarUpdate = 1;

  Atlas atlas;
  atlas.resize(gp.adjacentChildCtx != 0, gp.neighAvailBoundaryLog2);

  Level cur, nxt;
  cur.resize(1);
  cur.px[0] = cur.py[0] = cur.pz[0] = 0;
  cur.sibOcc[0] = 0;
  cur.numSib[0] = 8;
  cur.mispred[0] = 0;

  // per-level analysis buffers
  std::vector<uint8_t> predEffA;
  std::vector<NeighPattern> gnpA;
  std::vector<NeighInfo> nfA;
  TokenSink tk;

  for (int depth = 0; depth < L; depth++) {
    const std::vector<uint64_t>& ndKey = lvlKey[size_t(depth)];
    const std::vector<uint8_t>& ndOcc = lvlOcc[size_t(depth)];
    const std::vector<uint64_t>& chKey = lvlKey[size_t(depth) + 1];
    const size_t N = ndKey.size();
    int codedAxesPrevLvl = depth ? coded_axis_list[depth - 1] : 7;
    int codedAxesCurLvl = coded_axis_list[depth];
    int childSizeLog2[3] = {lvlSize[0][depth + 1],
                            lvlSize[1][depth + 1],
                            lvlSize[2][depth + 1]};
    bool childIsLeaf = !childSizeLog2[0] && !childSizeLog2[1]
      && !childSizeLog2[2];
    const int cx = !!(codedAxesCurLvl & 4);
    const int cy = !!(codedAxesCurLvl & 2);
    const int cz = !!(codedAxesCurLvl & 1);
    if (gp.planarEnabled) {
      int planarDepth[3] = {lvlSize[0][0] - lvlSize[0][depth],
                            lvlSize[1][0] - lvlSize[1][depth],
                            lvlSize[2][0] - lvlSize[2][depth]};
      planarState.initPlanes(planarDepth);
    }
    const bool dynK = dynObuf && planarEligibleKDepth;
    const long numSubnodes = long(chKey.size());

    // --- phase 1: inter predOcc via sorted-key merge ---------------
    // a node's subtree holds reference points iff its key appears in
    // the reference level array; effPredOcc additionally applies the
    // mispred<=5 gate (occupancyIsPredictable,
    // geometry_octree_encoder.cpp:2287)
    predEffA.assign(N, 0);
    if (num_ref > 0) {
      const std::vector<uint64_t>& rk = refKey[size_t(depth)];
      const std::vector<uint8_t>& ro = refOcc[size_t(depth)];
      size_t rp = 0;
      for (size_t n = 0; n < N; n++) {
        while (rp < rk.size() && rk[rp] < ndKey[n])
          rp++;
        if (rp < rk.size() && rk[rp] == ndKey[n]
            && cur.mispred[n] <= 5)
          predEffA[n] = ro[rp];
      }
    }

    // --- phase 2: atlas fill + neighbour gathers (batched) ---------
    gnpA.resize(N);
    nfA.resize(N);
    {
      const int shift = atlas.cubeSizeLog2;
      const uint32_t mask = (1u << shift) - 1;
      const int shiftX = (codedAxesPrevLvl & 4) ? 1 : 0;
      const int shiftY = (codedAxesPrevLvl & 2) ? 1 : 0;
      const int shiftZ = (codedAxesPrevLvl & 1) ? 1 : 0;
      size_t g0 = 0;
      while (g0 < N) {
        int32_t ox = cur.px[g0] >> shift, oy = cur.py[g0] >> shift,
          oz = cur.pz[g0] >> shift;
        size_t g1 = g0 + 1;
        while (g1 < N && (cur.px[g1] >> shift) == ox
               && (cur.py[g1] >> shift) == oy
               && (cur.pz[g1] >> shift) == oz)
          g1++;
        atlas.clearUpdates();
        for (size_t n = g0; n < g1; n++) {
          atlas.setByte(int((cur.px[n] & mask) >> shiftX),
                        int((cur.py[n] & mask) >> shiftY),
                        int((cur.pz[n] & mask) >> shiftZ),
                        cur.sibOcc[n]);
        }
        if (gp.adjacentChildCtx) {
          // upfront child-occupancy fill: every gated read in the
          // context derivations targets a lower-Morton in-cube node,
          // so pre-filling the whole cube is bit-identical to the
          // reference's write-as-you-code order
          for (size_t n = g0; n < g1; n++)
            atlas.setChildOcc(int(cur.px[n] & mask),
                              int(cur.py[n] & mask),
                              int(cur.pz[n] & mask), ndOcc[n]);
        }
        analyzeNeighRange(gnpA.data(), nfA.data(), cur, g0, g1,
                          gp.adjacentChildCtx != 0, codedAxesPrevLvl,
                          atlas, dynK);
        g0 = g1;
      }
    }

    // --- phase 3: planar decisions + token emission + child fill ---
    tk.reserve(N * 24 + 8);
    tk.clear();
    if (!childIsLeaf)
      nxt.resize(chKey.size());
    size_t cptr = 0;      // running child index into lvl[depth+1]
    size_t lptr = 0;      // running leaf-run index (leaf level)
    for (size_t n = 0; n < N; n++) {
      const int occupancy = ndOcc[n];
      const int numOccupied = __builtin_popcount(unsigned(occupancy));

      int posInParent = 0;
      posInParent |= (cur.px[n] & 1) << 2;
      posInParent |= (cur.py[n] & 1) << 1;
      posInParent |= (cur.pz[n] & 1) << 0;
      posInParent &= codedAxesPrevLvl;

      if (gp.planarEnabled && !gp.depthPlanarEligibility) {
        if (!nodesBeforePlanarUpdate--) {
          planarState.updateRate(cur.sibOcc[n], cur.numSib[n]);
          nodesBeforePlanarUpdate = cur.numSib[n] - 1;
        }
      }

      NodePlanar planar;
      bool planarEligible[3] = {false, false, false};
      if (gp.planarEnabled) {
        if (gp.depthPlanarEligibility) {
          if (planarEligibleKDepth)
            planarEligible[0] = planarEligible[1] =
              planarEligible[2] = true;
        } else {
          planarState.isEligible(planarEligible);
        }
        for (int k = 0; k < 3; k++)
          planarEligible[k] =
            planarEligible[k] && ((codedAxesCurLvl >> (2 - k)) & 1);
        // inter PCM eligibility (geometry_octree_encoder.cpp:2383)
        planar.allowPCM = num_ref > 0 && predEffA[n] != 0
          && (planarEligible[0] || planarEligible[1]
              || planarEligible[2]);
        planar.isPreDirMatch = true;
        for (int k = 0; k < 3; k++)
          planar.eligible[k] = planarEligible[k];
        planar.lastDirIdx =
          planarEligible[2] ? 2 : (planarEligible[1] ? 1 : 0);
        if (planarEligible[0] || planarEligible[1]
            || planarEligible[2]) {
          int32_t pos3[3] = {cur.px[n], cur.py[n], cur.pz[n]};
          NodePlanar planarRef;
          if (num_ref > 0)
            planesFromOccupancy(predEffA[n], planarRef);
          emitPlanarIntra(tk, planarState, gp, dynObuf,
                          planarEligible, posInParent, gnpA[n], pos3,
                          cur.sibOcc[n], occupancy, planar,
                          num_ref > 0 ? &planarRef : nullptr);
        }
      }

      for (int k = 0; k < 3; k++) {
        if (!(codedAxesCurLvl & (4 >> k))) {
          planar.planePosBits &= uint8_t(~(1 << k));
          planar.planarMode |= uint8_t(1 << k);
        }
      }
      int planarMask[3] = {0, 0, 0};
      if (planar.planarMode & 1)
        planarMask[0] = (planar.planePosBits & 1) ? 0x0f : 0xf0;
      if (planar.planarMode & 2)
        planarMask[1] = (planar.planePosBits & 2) ? 0x33 : 0xcc;
      if (planar.planarMode & 4)
        planarMask[2] = (planar.planePosBits & 4) ? 0x55 : 0xaa;

      emitOccupancy(tk, gnpA[n], nfA[n], occupancy, planarMask[0],
                    planarMask[1], planarMask[2],
                    planar.planarPossible & 1,
                    planar.planarPossible & 2,
                    planar.planarPossible & 4, predEffA[n]);

      if (childIsLeaf) {
        if (!gp.uniquePoints) {
          for (int ci = 0; ci < numOccupied; ci++) {
            int dupCnt = leafCnt[lptr + size_t(ci)] - 1;
            tk.adapt(kCtxDupGt0, dupCnt > 0);
            if (dupCnt > 0)
              tk.eg(unsigned(dupCnt - 1));
          }
        }
        lptr += size_t(numOccupied);
        continue;
      }

      // child metadata (mispred: occupancy-vs-prediction failures,
      // geometry_octree_encoder.cpp:2548)
      int predOccRaw = 0;
      if (num_ref > 0) {
        const std::vector<uint64_t>& rk = refKey[size_t(depth)];
        // predEffA only carries the gated word; re-derive the raw one
        // for mispred via a cheap local search when gating differs
        (void)rk;
      }
      // raw prediction for mispred: match at this level regardless of
      // the mispred gate
      predOccRaw = 0;
      if (num_ref > 0) {
        const std::vector<uint64_t>& rk = refKey[size_t(depth)];
        const std::vector<uint8_t>& ro = refOcc[size_t(depth)];
        size_t lo = 0, hi = rk.size();
        while (lo < hi) {
          size_t mid = (lo + hi) / 2;
          if (rk[mid] < ndKey[n])
            lo = mid + 1;
          else
            hi = mid;
        }
        if (lo < rk.size() && rk[lo] == ndKey[n])
          predOccRaw = ro[lo];
      }
      int mispredC;
      {
        int fail = 0;
        for (int b = 0; b < 8; b++)
          fail +=
            (!!(occupancy & (1 << b))) != (!!(predOccRaw & (1 << b)));
        mispredC = fail < 255 ? fail : 255;
      }
      for (int ci = 0; ci < numOccupied; ci++) {
        size_t c = cptr + size_t(ci);
        int b = int(chKey[c] & 7);
        nxt.px[c] = (cur.px[n] << cx) + (!!(b & 4));
        nxt.py[c] = (cur.py[n] << cy) + (!!(b & 2));
        nxt.pz[c] = (cur.pz[n] << cz) + (!!(b & 1));
        nxt.sibOcc[c] = uint8_t(occupancy);
        nxt.numSib[c] = uint8_t(numOccupied);
        nxt.mispred[c] = uint8_t(mispredC);
      }
      cptr += size_t(numOccupied);
    }

    if (dbg_toks) {
      // debug export: the raw token stream per level, for the numpy
      // mirror of the batched analysis (tests/test_obuf_mirror.py)
      long cnt = long(tk.size());
      if (dbgPos + cnt <= dbg_cap)
        std::memcpy(dbg_toks + dbgPos, tk.tpBase,
                    size_t(cnt) * sizeof(uint32_t));
      dbgPos += cnt;
      if (dbg_lvl_counts)
        dbg_lvl_counts[depth] = int32_t(cnt);
    }

    // --- phase 4: thin serial coding loop --------------------------
    codeTokens(aec, ctx, tk);

    if (checkPlanarDepthEligibility)
      planarEligibleKDepth = long(num_points) * 10 < numSubnodes * 13;

    std::swap(cur, nxt);
  }

  aec.flush();
  if (int(aec.out.size()) > out_cap)
    return -4;
  std::memcpy(out_buf, aec.out.data(), aec.out.size());
  return int(aec.out.size());
}

// ---------------------------------------------------------------------------
// level-sweep DECODER.  Mirror of the encoder above: per level, a
// BATCHED pass computes every context input that depends only on the
// PARENT level (sibOcc cube atlas prefill, 6-neighbour pattern, the
// 20-neighbour word, the 9-probe linear word, diagonal-neighbour
// existence gates, inter predOcc by sorted-key merge); the serial
// loop then performs only the causally-sequential work: gated
// child-occupancy gathers from already-decoded lower-Morton
// neighbours, planar decode, OBUF context evolution + arithmetic
// decode, and child emission.  Outputs are identical to the BFS
// oracle (refcodec.cc decode_octree_impl) by construction; the
// batched pass is the decode twin of the encoder's device-runnable
// analysis (VERDICT r2 item 9).
// ---------------------------------------------------------------------------

// batched per-node record: parent-level features only (sibOcc atlas),
// packed small so a cube group's records stay cache-resident between
// the batch and serial passes.  The 20-neighbour word is NOT here: at
// decode a large share of nodes never reach the NZ occupancy path
// (single-child / planar-inferred), so it is computed lazily in the
// serial loop (the device offload, by contrast, would compute it for
// every node as the encoder's analysis does).
struct DecNeighBatch {
  uint8_t pattern = 0;
  uint8_t diagGate = 0;     // bits 0..3: (x-1,y-1,z),(x-1,y,z-1),
                            //            (x,y-1,z-1),(x-1,y-1,z-1)
  uint16_t linWord = 0;     // 12-bit linear neighbour word (dynK)
};

static void decNeighBatch(
  DecNeighBatch& b, const int32_t pos[3], int codedAxesPrevLvl,
  const Atlas& atlas, bool dynK) {
  const int mask = atlas.cubeSize - 1;
  const int x = pos[0] & mask, y = pos[1] & mask, z = pos[2] & mask;
  const int sx = (codedAxesPrevLvl & 4) ? 1 : 0;
  const int sy = (codedAxesPrevLvl & 2) ? 1 : 0;
  const int sz = (codedAxesPrevLvl & 1) ? 1 : 0;
  const bool inner = x > 0 && x < mask && y > 0 && y < mask && z > 0
    && z < mask;
  uint8_t p;
  if (inner) {
    p = uint8_t(atlas.get(x + 1, y, z, sx, sy, sz));
    p |= atlas.get(x - 1, y, z, sx, sy, sz) << 1;
    p |= atlas.get(x, y - 1, z, sx, sy, sz) << 2;
    p |= atlas.get(x, y + 1, z, sx, sy, sz) << 3;
    p |= atlas.get(x, y, z - 1, sx, sy, sz) << 4;
    p |= atlas.get(x, y, z + 1, sx, sy, sz) << 5;
  } else {
    p = uint8_t(atlas.getWithCheck(x + 1, y, z, sx, sy, sz));
    p |= atlas.getWithCheck(x - 1, y, z, sx, sy, sz) << 1;
    p |= atlas.getWithCheck(x, y - 1, z, sx, sy, sz) << 2;
    p |= atlas.getWithCheck(x, y + 1, z, sx, sy, sz) << 3;
    p |= atlas.getWithCheck(x, y, z - 1, sx, sy, sz) << 4;
    p |= atlas.getWithCheck(x, y, z + 1, sx, sy, sz) << 5;
  }
  b.pattern = p;

  if (dynK) {
    uint8_t g;
    uint32_t no = (uint32_t(!!(p & 1)) << 11)
      | (uint32_t(!!(p & 8)) << 10) | (uint32_t(!!(p & 32)) << 9);
    if (inner) {
      g = uint8_t(atlas.get(x - 1, y - 1, z, sx, sy, sz));
      g |= atlas.get(x - 1, y, z - 1, sx, sy, sz) << 1;
      g |= atlas.get(x, y - 1, z - 1, sx, sy, sz) << 2;
      g |= atlas.get(x - 1, y - 1, z - 1, sx, sy, sz) << 3;
      for (int n = 0; n < 9; n++)
        no |= atlas.get(x + kLinDx[n], y + kLinDy[n], z + kLinDz[n],
                        sx, sy, sz) << n;
    } else {
      g = uint8_t(atlas.getWithCheck(x - 1, y - 1, z, sx, sy, sz));
      g |= atlas.getWithCheck(x - 1, y, z - 1, sx, sy, sz) << 1;
      g |= atlas.getWithCheck(x, y - 1, z - 1, sx, sy, sz) << 2;
      g |= atlas.getWithCheck(x - 1, y - 1, z - 1, sx, sy, sz) << 3;
      for (int n = 0; n < 9; n++)
        no |= atlas.getWithCheck(x + kLinDx[n], y + kLinDy[n],
                                 z + kLinDz[n], sx, sy, sz) << n;
    }
    b.diagGate = g;
    b.linWord = uint16_t(no);
  }
}

// serial: child-occupancy gathers from already-decoded lower-Morton
// neighbours (mirror of makeNeighPattern's childOcc part)
static void decNeighSerial(
  const DecNeighBatch& b, NeighPattern& gnp, const int32_t pos[3],
  const Atlas& atlas, bool adjChildCtx, bool dynK) {
  gnp.pattern = b.pattern;
  gnp.neighborOccu = b.linWord;
  const int mask = atlas.cubeSize - 1;
  const int x = pos[0] & mask, y = pos[1] & mask, z = pos[2] & mask;
  if ((gnp.pattern || dynK) && adjChildCtx) {
    if (gnp.pattern) {
      if (gnp.pattern & 2)
        gnp.adjOcc[0] = atlas.getChildOcc(x - 1, y, z);
      if (gnp.pattern & 4)
        gnp.adjOcc[1] = atlas.getChildOcc(x, y - 1, z);
      if (gnp.pattern & 16)
        gnp.adjOcc[2] = atlas.getChildOcc(x, y, z - 1);
    }
    if (dynK) {
      if (b.diagGate & 1)
        gnp.adjOcc[3] = atlas.getChildOcc(x - 1, y - 1, z);
      if (b.diagGate & 2)
        gnp.adjOcc[4] = atlas.getChildOcc(x - 1, y, z - 1);
      if (b.diagGate & 4)
        gnp.adjOcc[5] = atlas.getChildOcc(x, y - 1, z - 1);
      if (b.diagGate & 8)
        gnp.adjOcc[6] = atlas.getChildOcc(x - 1, y - 1, z - 1);
      gnp.neighOccuValid = false;
      for (int idx = 0; idx < 7 && !gnp.neighOccuValid; ++idx)
        gnp.neighOccuValid |= gnp.adjOcc[idx] != 0;
    }
  }
}

// lazy NZ-path feature assembly: the 20-neighbour word + edge bits +
// NeighInfo (prepareNeighInfo semantics), computed only for nodes that
// reach the bit-by-bit occupancy path
static void decNeighInfoLazy(
  NeighInfo& nf, const NeighPattern& gnp, const int32_t pos[3],
  int codedAxesPrevLvl, const Atlas& atlas, bool dynK) {
  const int mask = atlas.cubeSize - 1;
  const int x = pos[0] & mask, y = pos[1] & mask, z = pos[2] & mask;
  const int sx = (codedAxesPrevLvl & 4) ? 1 : 0;
  const int sy = (codedAxesPrevLvl & 2) ? 1 : 0;
  const int sz = (codedAxesPrevLvl & 1) ? 1 : 0;
  int n20 = 0;
  if (x > 0 && x < mask && y > 0 && y < mask && z > 0 && z < mask) {
    uint32_t mx[3], my[3], mz[3];
    int bx[3], by[3], bz[3];
    for (int d = -1; d <= 1; d++) {
      mx[d + 1] = atlas.mortonX[(x + d) >> sx];
      my[d + 1] = atlas.mortonY[(y + d) >> sy];
      mz[d + 1] = atlas.mortonZ[(z + d) >> sz];
      bx[d + 1] = sx ? ((x + d) & 1) : 0;
      by[d + 1] = sy ? ((y + d) & 1) : 0;
      bz[d + 1] = sz ? ((z + d) & 1) : 0;
    }
    for (int n = 0; n < 20; n++) {
      int ix = kDx20[n] + 1, iy = kDy20[n] + 1, iz = kDz20[n] + 1;
      uint32_t byteIdx = mx[ix] | my[iy] | mz[iz];
      int bit = bz[iz] + (by[iy] << 1) + (bx[ix] << 2);
      n20 |= int((atlas.buffer[byteIdx] >> bit) & 1) << n;
    }
  } else {
    for (int n = 0; n < 20; n++)
      n20 |= atlas.getWithCheck(x + kDx20[n], y + kDy20[n],
                                z + kDz20[n], sx, sy, sz) << n;
  }
  nf.neighb20 = n20;

  const int neighPattern = gnp.pattern;
  nf.occLeft = gnp.adjOcc[0];
  nf.occFront = gnp.adjOcc[1];
  nf.occBottom = gnp.adjOcc[2];
  nf.occL = nf.occLeft >> 4;
  nf.occF = ((nf.occFront >> 2) & 3) | ((nf.occFront >> 4) & 12);
  nf.occB = ((nf.occBottom >> 1) & 1) | ((nf.occBottom >> 2) & 2)
    | ((nf.occBottom >> 3) & 4) | ((nf.occBottom >> 4) & 8);
  nf.occOrLFBfb = nf.occLeft | nf.occFront | nf.occBottom;

  nf.edgeBits = 0;
  if ((n20 >> 3) & 1) {
    int occLB = dynK ? gnp.adjOcc[4]
                     : atlas.getChildOcc(x - 1, y, z - 1);
    nf.edgeBits = ((occLB & 32) >> 5) | ((occLB & 128) >> 6);
  }
  if ((n20 >> 8) & 1) {
    int occFB = dynK ? gnp.adjOcc[5]
                     : atlas.getChildOcc(x, y - 1, z - 1);
    nf.edgeBits |= ((occFB & 8) >> 1) | ((occFB & 128) >> 4);
  }
  if ((n20 >> 1) & 1) {
    int occLF = dynK ? gnp.adjOcc[3]
                     : atlas.getChildOcc(x - 1, y - 1, z);
    nf.edgeBits |= (occLF & 0xC0) >> 2;
  }

  nf.N3 = ((neighPattern >> 3) & 4) | ((neighPattern >> 2) & 2)
    | (neighPattern & 1);
  nf.N2 = nf.N3 & 3;
  nf.neighPatternLFB = ((neighPattern & 6) >> 1)
    | ((neighPattern & 16) >> 2);
}

// planar decode against the LsCtx context layout (mirror of
// emitPlanarModeIntra; normative sequence of decodePlanarModeIntra)
static int decodePlanarModeLs(
  ArithDec& aec, LsCtx& ctx, bool multiplePlanar, bool dynObuf,
  NodePlanar& planar, int planeZ, int dist, int adjPlanes, int planeId,
  const bool* multiPlanarFlag, const bool* multiPlanarEligible,
  const NodePlanar adjNeighPlanar[7], bool neighAvai,
  uint32_t neighOccu, const NodePlanar* planarRefArg = nullptr) {
  const int mask0 = 1 << planeId;
  static const int kMask1[3] = {6, 5, 3};
  static const NodePlanar kZeroRef;
  const NodePlanar& planarRef = planarRefArg ? *planarRefArg : kZeroRef;

  bool isPlanarRef = (planarRef.planarMode & mask0) != 0;
  int planeBitRef = (planarRef.planePosBits & mask0) ? 1 : 0;
  int ctxIdxPlanarFlag = planeId;
  if (isPlanarRef)
    ctxIdxPlanarFlag += 3 * (planeBitRef + 1);

  bool isPlanar = isPlanarRef;
  if (!planar.isPCM) {
    if (multiplePlanar) {
      static const int planeId2Index[3][3] = {{0, 1, 2}, {0, 1, 3},
                                              {0, 2, 3}};
      bool multiPlanarFlagFalse = true;
      for (int i = 0; i < 3; i++)
        multiPlanarFlagFalse &= !multiPlanarFlag[
          planeId2Index[planeId][i]];
      bool inferredPlanarFalse = multiPlanarFlagFalse;
      if (multiPlanarFlagFalse) {
        if (planeId == 2) {
          if (multiPlanarEligible[0])
            inferredPlanarFalse =
              !((planar.planarMode & 2) && (planar.planarMode & 1));
          else if (multiPlanarEligible[2])
            inferredPlanarFalse = !(planar.planarMode & 1);
          else if (multiPlanarEligible[3])
            inferredPlanarFalse = !(planar.planarMode & 2);
        } else if (planeId == 1) {
          if (multiPlanarEligible[1])
            inferredPlanarFalse = !(planar.planarMode & 1);
        }
      }
      if (inferredPlanarFalse)
        isPlanar =
          aec.bit(&ctx.flat[kCtxPlanarMode0 + ctxIdxPlanarFlag]) != 0;
      else if (!multiPlanarFlagFalse)
        isPlanar = true;
      else
        isPlanar = false;
    } else {
      isPlanar =
        aec.bit(&ctx.flat[kCtxPlanarMode0 + ctxIdxPlanarFlag]) != 0;
    }
  }

  planar.planarMode |= isPlanar ? mask0 : 0;
  if (!isPlanar) {
    planar.planarPossible &= kMask1[planeId];
    return -1;
  }

  int planeBit;
  if (planar.isPCM) {
    planeBit = planeBitRef;
    planar.planePosBits |= uint8_t(planeBit << planeId);
    return planeBit;
  }
  if (planeId == planar.lastDirIdx && planar.isPreDirMatch
      && planar.allowPCM && isPlanarRef) {
    planeBit = planeBitRef == 1 ? 0 : 1;
    planar.planePosBits |= uint8_t(planeBit << planeId);
    return planeBit;
  }
  const int refPlane = isPlanarRef ? 1 + planeBitRef : 0;
  int planePosCtx = kAdjPlaneCtx[adjPlanes];
  if (dynObuf) {
    int discreteDist;
    if (planeZ < 0) {
      discreteDist = 1;
      planeZ = 0;
    } else {
      discreteDist = dist > (8 >> PlanarBuffer::kShiftAb);
    }
    int lastIndexPlane2d = planeZ + (discreteDist << 1);
    int c1, c2;
    planarPosObufCtx(planeId, lastIndexPlane2d, planePosCtx,
                     adjNeighPlanar, neighAvai, neighOccu, c1, c2);
    planeBit = ctx.mapPlanarPos[refPlane][planeId].decodeEvolve(
      &aec, ctx.planarModel[planeId], c2, c1, &ctx.planarLeafNumber,
      ctx.planarLeaves.data());
  } else {
    if (planeZ < 0) {
      int planePosCtxTmp = planePosCtx;
      if (isPlanarRef)
        planePosCtxTmp += 3 * (planeBitRef + 1);
      planeBit =
        aec.bit(&ctx.flat[kCtxPlaneLastIndexZ0 + planePosCtxTmp]);
    } else {
      int discreteDist = dist > (8 >> PlanarBuffer::kShiftAb);
      int lastIndexPlane2d = planeZ + (discreteDist << 1);
      planeBit = aec.bit(&ctx.flat[kCtxPlaneLastIndex0
                                   + refPlane * 108 + planeId * 12
                                   + planePosCtx * 4
                                   + lastIndexPlane2d]);
    }
  }
  planar.planePosBits |= uint8_t(planeBit << planeId);
  return planeBit;
}

// per-node planar decode (mirror of emitPlanarIntra)
__attribute__((flatten)) static void decodePlanarLs(
  ArithDec& aec, LsCtx& ctx, PlanarState& planarState,
  const GeomParams& gp, bool dynObuf, const bool planarEligible[3],
  int posInParent, const NeighPattern& gnp, const int32_t childPos[3],
  uint8_t siblingOccupancy, NodePlanar& planar,
  NodePlanar* planarRef = nullptr) {
  NodePlanar adjNeighPlanar[7];
  if (dynObuf && gnp.neighOccuValid)
    for (int idx = 0; idx < 7; ++idx)
      if (gnp.adjOcc[idx])
        planesFromOccupancy(gnp.adjOcc[idx], adjNeighPlanar[idx]);

  if (planarRef) {
    // inter: mask reference planes, read PCM copy-mode flag
    // (determinePlanarMode, geometry_octree_decoder.cpp:679-702)
    uint8_t mask = 0;
    mask |= uint8_t(planarEligible[2]) << 2;
    mask |= uint8_t(planarEligible[1]) << 1;
    mask |= uint8_t(planarEligible[0]) << 0;
    planarRef->planarMode &= mask;
    planarRef->planePosBits &= mask;
    if (planar.allowPCM)
      derivePlanarPCMCtxBuf(planar, *planarRef, planarState, childPos);
    if (!planar.isSignaled && planar.allowPCM) {
      planar.isPCM =
        aec.bit(&ctx.flat[kCtxPlanarCopyMode0
                          + planarRef->ctxBufPCM * 8
                          + planarRef->planarMode]) != 0;
      planar.isSignaled = true;
    }
  }

  bool multiPlanarFlag[4] = {false, false, false, false};
  bool multiPlanarEligible[4] = {false, false, false, false};
  if (planarState.multiplePlanar && !planar.isPCM) {
    int kind = kindOfEligible(planarEligible);
    if (kind >= 0) {
      multiPlanarEligible[kind] = true;
      multiPlanarFlag[kind] =
        aec.bit(&ctx.flat[kCtxMultiPlanar]) != 0;
    }
  }

  struct Dir {
    int planeId, c1, c2, c3;
  };
  const Dir dirs[3] = {{0, childPos[1], childPos[2], childPos[0]},
                       {1, childPos[0], childPos[2], childPos[1]},
                       {2, childPos[0], childPos[1], childPos[2]}};
  static const int kAdjNeighIdxFromPlanePos[3][2] = {{1, 0}, {2, 3},
                                                     {4, 5}};
  static const uint8_t kAdjNeighIdxMask[3][2] = {{0x0f, 0xf0},
                                                 {0x33, 0xcc},
                                                 {0x55, 0xaa}};
  for (const Dir& d : dirs) {
    if (!planarEligible[d.planeId])
      continue;
    const int planeId = d.planeId;
    PlanarBuffer::Elmt* planeBuffer = planarState.bufferEnabled
      ? planarState.buffer.col(planeId) : nullptr;
    PlanarBuffer::Elmt* row = nullptr;
    int closestPlanarFlag;
    int closestDist;
    int maxCoord = 0;
    int coord1 = d.c1, coord2 = d.c2, coord3 = d.c3;
    if (!planeBuffer) {
      closestPlanarFlag = -1;
      closestDist = 0;
    } else {
      coord1 =
        (coord1 & PlanarBuffer::kMaskAb) >> PlanarBuffer::kShiftAb;
      coord2 =
        (coord2 & PlanarBuffer::kMaskAb) >> PlanarBuffer::kShiftAb;
      coord3 = coord3 & PlanarBuffer::kMaskC;
      row = &planeBuffer[coord3];
      maxCoord = std::max(coord1, coord2);
      closestDist = std::abs(maxCoord - int(row[0].pos));
      closestPlanarFlag = row[0].planeIdx;
    }

    int pos = !(kAdjNeighIdxMask[planeId][0] & (1 << posInParent));
    bool lowAdj = gp.adjacentChildCtx != 0
      ? (kAdjNeighIdxMask[planeId][1] & gnp.adjOcc[planeId]) != 0
      : ((gnp.pattern >> kAdjNeighIdxFromPlanePos[planeId][0]) & 1)
        != 0;
    bool highAdj = !pos
      ? (kAdjNeighIdxMask[planeId][1] & siblingOccupancy) != 0
      : ((gnp.pattern >> kAdjNeighIdxFromPlanePos[planeId][1]) & 1)
        != 0;
    int adjPlanes = (int(highAdj) << 1) | int(lowAdj);

    int planeBit = decodePlanarModeLs(
      aec, ctx, planarState.multiplePlanar, dynObuf, planar,
      closestPlanarFlag, closestDist, adjPlanes, planeId,
      multiPlanarFlag, multiPlanarEligible, adjNeighPlanar,
      gnp.neighOccuValid, gnp.neighborOccu, planarRef);
    bool isPlanar = (planar.planarMode & (1 << planeId)) != 0;
    planarState.rate[planeId] =
      (255 * planarState.rate[planeId] + (isPlanar ? 256 * 8 : 0)
       + 128) >> 8;
    if (planeBuffer)
      *row = PlanarBuffer::Elmt{uint8_t(maxCoord), int8_t(planeBit)};
    if (planarRef) {
      bool isPlanarRef =
        (planarRef->planarMode & (1 << planeId)) != 0;
      int planeBitRef =
        (planarRef->planePosBits & (1 << planeId)) ? 1 : 0;
      if (!(isPlanar == isPlanarRef && planeBit == planeBitRef))
        planar.isPreDirMatch = false;
    }
  }
}

// occupancy decode against the LsCtx layout (mirror of emitOccupancy;
// normative sequence of refcodec decodeOccupancy); the NZ-path
// features assemble lazily after the inference-only early exits
__attribute__((flatten)) static uint32_t decodeOccupancyLs(
  ArithDec& aec, LsCtx& ctx, const NeighPattern& gnp,
  const int32_t pos[3], int codedAxesPrevLvl, const Atlas& atlas,
  bool dynK,
  int planarMaskX, int planarMaskY, int planarMaskZ,
  bool planarPossibleX, bool planarPossibleY, bool planarPossibleZ,
  int predOcc) {
  if (planarMaskX && planarMaskY && planarMaskZ) {
    uint32_t cnt = planarMaskZ & 1;
    cnt |= (planarMaskY & 1) << 1;
    cnt |= (planarMaskX & 1) << 2;
    return 1u << cnt;
  }
  bool flagNoSingle = false;
  if (gnp.pattern == 0
      && (!predOcc || (planarMaskX | planarMaskY | planarMaskZ))) {
    bool singleChild = false;
    if (planarPossibleX && planarPossibleY && planarPossibleZ)
      singleChild = aec.bit(&ctx.flat[kCtxSingleChild]) == 1;
    if (singleChild) {
      uint32_t cnt;
      cnt = planarMaskZ ? uint32_t(planarMaskZ & 1)
                        : uint32_t(aec.bypass());
      cnt |= (planarMaskY ? uint32_t(planarMaskY & 1)
                          : uint32_t(aec.bypass())) << 1;
      cnt |= (planarMaskX ? uint32_t(planarMaskX & 1)
                          : uint32_t(aec.bypass())) << 2;
      return 1u << cnt;
    }
    flagNoSingle = true;
    if (planarMaskX && planarMaskY) {
      uint32_t cnt = ((planarMaskX & 1) << 2)
        | ((planarMaskY & 1) << 1);
      return (1u << cnt) | (1u << (cnt + 1));
    }
    if (planarMaskY && planarMaskZ) {
      uint32_t cnt = ((planarMaskY & 1) << 1) | (planarMaskZ & 1);
      return (1u << cnt) | (1u << (cnt + 4));
    }
    if (planarMaskX && planarMaskZ) {
      uint32_t cnt = ((planarMaskX & 1) << 2) | (planarMaskZ & 1);
      return (1u << cnt) | (1u << (cnt + 2));
    }
  }

  const bool surePlanarityX = planarMaskX || !planarPossibleX;
  const bool surePlanarityY = planarMaskY || !planarPossibleY;
  const bool surePlanarityZ = planarMaskZ || !planarPossibleZ;
  const int maxPerPlaneX = (planarMaskX && flagNoSingle) ? 2 : 3;
  const int maxPerPlaneY = (planarMaskY && flagNoSingle) ? 2 : 3;
  const int maxPerPlaneZ = (planarMaskZ && flagNoSingle) ? 2 : 3;
  const int maxAll = flagNoSingle ? 6 : 7;

  int maskConfig = (!!planarMaskX) * (1 + (planarMaskX != 0x0F));
  maskConfig += (!!planarMaskY) * 3 * (1 + (planarMaskY != 0x33));
  maskConfig += (!!planarMaskZ) * 9 * (1 + (planarMaskZ != 0x55));
  int coded0[6] = {0, 0, 0, 0, 0, 0};
  if (maskConfig)
    std::memcpy(coded0, kInitCoded0[maskConfig], sizeof coded0);

  NeighInfo nf;
  decNeighInfoLazy(nf, gnp, pos, codedAxesPrevLvl, atlas, dynK);

  uint32_t occupancy = 0;
  int maskedOccupancy = planarMaskX | planarMaskY | planarMaskZ;
  for (int i = 0; i < 8; i++) {
    if ((maskedOccupancy >> i) & 1)
      continue;
    int mask0X = (0xf0 >> i) & 1;
    int mask0Y = 2 + ((0xcc >> i) & 1);
    int mask0Z = 4 + ((0xaa >> i) & 1);
    bool bitIsOne = (surePlanarityX && coded0[mask0X] >= maxPerPlaneX)
      || (coded0[0] + coded0[1] >= maxAll)
      || (surePlanarityY && coded0[mask0Y] >= maxPerPlaneY)
      || (coded0[2] + coded0[3] >= maxAll)
      || (surePlanarityZ && coded0[mask0Z] >= maxPerPlaneZ)
      || (coded0[4] + coded0[5] >= maxAll);
    if (bitIsOne) {
      occupancy += 1u << i;
      continue;
    }
    const int interCtx = (predOcc >> i) & 1;
    int c1, c2;
    bool sparse;
    ctxBitDispatch(i, nf, int(occupancy), c1, c2, sparse);
    CtxMapOBUFPk& m = sparse ? ctx.mapOccSparse[interCtx][i]
                             : ctx.mapOcc[interCtx][i];
    int bitv = m.decodeEvolve(&aec, ctx.obufModel, c2, c1,
                              &ctx.leafNumber, ctx.leaves.data());
    occupancy += uint32_t(bitv) << i;
    coded0[mask0X] += !bitv;
    coded0[mask0Y] += !bitv;
    coded0[mask0Z] += !bitv;
  }
  return occupancy;
}

static int obufls_decode_impl(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels,
  int num_points,
  const int32_t* ref_positions, int num_ref,
  const int32_t* gp_arr, int32_t* out_pos, int out_cap) {
  GeomParams gp;
  std::memcpy(&gp, gp_arr, sizeof gp);
  if (gp.neighAvailBoundaryLog2 < 2 || gp.neighAvailBoundaryLog2 > 9)
    return -3;  // no-atlas / out-of-range: BFS oracle handles
  if (num_levels < 1 || (num_ref > 0 && num_levels > 21))
    return -3;
  if (gp.idcmMode)
    return -3;  // IDCM early termination: BFS oracle handles

  const int L = num_levels;
  std::vector<int> lvlSize[3];
  {
    int size[3] = {0, 0, 0};
    std::vector<int> acc[3];
    for (int k = 0; k < 3; k++) acc[k].push_back(0);
    for (int i = L - 1; i >= 0; i--) {
      int split = coded_axis_list[i];
      size[0] += !!(split & 4);
      size[1] += !!(split & 2);
      size[2] += !!(split & 1);
      for (int k = 0; k < 3; k++) acc[k].push_back(size[k]);
    }
    for (int k = 0; k < 3; k++) {
      lvlSize[k].assign(acc[k].rbegin(), acc[k].rend());
      lvlSize[k].push_back(lvlSize[k].back());
    }
  }

  // reference pyramid (inter): per-level sorted keys + occupancies,
  // exactly the encoder's phase-1 input
  std::vector<std::vector<uint64_t>> refKey;
  std::vector<std::vector<uint8_t>> refOcc;
  if (num_ref > 0) {
    int32_t probeXs[24], probeYs[24], probeZs[24];
    for (int d = 0; d < L; d++) {
      int coded = coded_axis_list[d];
      probeXs[d] = (coded & 4) ? (int32_t(1) << lvlSize[0][d + 1]) : 0;
      probeYs[d] = (coded & 2) ? (int32_t(1) << lvlSize[1][d + 1]) : 0;
      probeZs[d] = (coded & 1) ? (int32_t(1) << lvlSize[2][d + 1]) : 0;
    }
    std::vector<uint64_t> rkeys((size_t(num_ref)));
    for (int p = 0; p < num_ref; p++) {
      const int32_t x = ref_positions[size_t(p) * 3];
      const int32_t y = ref_positions[size_t(p) * 3 + 1];
      const int32_t z = ref_positions[size_t(p) * 3 + 2];
      uint64_t key = 0;
      for (int d = 0; d < L; d++) {
        int b = (!!(z & probeZs[d])) | (!!(y & probeYs[d]) << 1)
          | (!!(x & probeXs[d]) << 2);
        key = (key << 3) | uint64_t(b);
      }
      rkeys[size_t(p)] = key;
    }
    radixSortKeys(rkeys, 3 * L);
    refKey.resize(size_t(L) + 1);
    refOcc.resize(size_t(L));
    std::vector<uint64_t>& lk = refKey[size_t(L)];
    lk.reserve(size_t(num_ref));
    for (int p = 0; p < num_ref;) {
      uint64_t k = rkeys[size_t(p)];
      int q = p + 1;
      while (q < num_ref && rkeys[size_t(q)] == k)
        q++;
      lk.push_back(k);
      p = q;
    }
    for (int d = L - 1; d >= 0; d--) {
      const std::vector<uint64_t>& ck = refKey[size_t(d) + 1];
      std::vector<uint64_t>& pk = refKey[size_t(d)];
      std::vector<uint8_t>& po = refOcc[size_t(d)];
      pk.reserve(ck.size());
      po.reserve(ck.size());
      size_t i = 0;
      while (i < ck.size()) {
        uint64_t parent = ck[i] >> 3;
        int occ = 0;
        do {
          occ |= 1 << int(ck[i] & 7);
          i++;
        } while (i < ck.size() && (ck[i] >> 3) == parent);
        pk.push_back(parent);
        po.push_back(uint8_t(occ));
      }
    }
  }

  ArithDec aec;
  aec.chunked = gp.cabacBypassStream != 0;
  aec.init(aec_buf, size_t(aec_len));
  aec.bypassNoUpdate = gp.bypassNoUpdate != 0;
  LsCtx ctx;
  ctx.reset(gp.planarEnabled != 0);

  PlanarState planarState;
  planarState.bufferEnabled =
    gp.planarEnabled && gp.planarBufferEnabled;
  planarState.multiplePlanar = gp.planarEnabled && gp.multiplePlanar;
  for (int k = 0; k < 3; k++)
    planarState.rateThreshold[k] = gp.planarTh[k] << 4;
  const bool dynObuf =
    gp.planarEnabled && gp.planarDynamicObufEligibility;
  const bool checkPlanarDepthEligibility =
    gp.planarEnabled && gp.depthPlanarEligibility;
  bool planarEligibleKDepth = false;
  int nodesBeforePlanarUpdate = 1;

  Atlas atlas;
  atlas.resize(gp.adjacentChildCtx != 0, gp.neighAvailBoundaryLog2);

  Level cur, nxt;
  std::vector<uint64_t> curKey, nxtKey;
  cur.resize(1);
  cur.px[0] = cur.py[0] = cur.pz[0] = 0;
  cur.sibOcc[0] = 0;
  cur.numSib[0] = 8;
  cur.mispred[0] = 0;
  curKey.assign(1, 0);
  size_t curN = 1;

  std::vector<DecNeighBatch> nbA;
  std::vector<uint8_t> predEffA, predRawA;
  int processed = 0;

  for (int depth = 0; depth < L; depth++) {
    const size_t N = curN;
    int codedAxesPrevLvl = depth ? coded_axis_list[depth - 1] : 7;
    int codedAxesCurLvl = coded_axis_list[depth];
    int childSizeLog2[3] = {lvlSize[0][depth + 1],
                            lvlSize[1][depth + 1],
                            lvlSize[2][depth + 1]};
    bool childIsLeaf = !childSizeLog2[0] && !childSizeLog2[1]
      && !childSizeLog2[2];
    const int cx = !!(codedAxesCurLvl & 4);
    const int cy = !!(codedAxesCurLvl & 2);
    const int cz = !!(codedAxesCurLvl & 1);
    if (gp.planarEnabled) {
      int planarDepth[3] = {lvlSize[0][0] - lvlSize[0][depth],
                            lvlSize[1][0] - lvlSize[1][depth],
                            lvlSize[2][0] - lvlSize[2][depth]};
      planarState.initPlanes(planarDepth);
    }
    const bool dynK = dynObuf && planarEligibleKDepth;

    // --- batched phase 1: inter predOcc via sorted-key merge --------
    predEffA.assign(N, 0);
    predRawA.assign(N, 0);
    if (num_ref > 0) {
      const std::vector<uint64_t>& rk = refKey[size_t(depth)];
      const std::vector<uint8_t>& ro = refOcc[size_t(depth)];
      size_t rp = 0;
      for (size_t n = 0; n < N; n++) {
        while (rp < rk.size() && rk[rp] < curKey[n])
          rp++;
        if (rp < rk.size() && rk[rp] == curKey[n]) {
          predRawA[n] = ro[rp];
          if (cur.mispred[n] <= 5)
            predEffA[n] = ro[rp];
        }
      }
    }

    // --- fused per-cube-group sweep: batched sibOcc atlas prefill +
    // parent-level neighbour features for the whole group, then the
    // serial decode of the same (cache-hot) group -------------------
    // (a level is at most num_points wide: every node holds >=1 point)
    size_t childCap = childIsLeaf ? 0
      : std::min(N * 8, size_t(num_points) + 8);
    if (!childIsLeaf) {
      nxt.resize(childCap);
      nxtKey.resize(childCap);
    }
    size_t cptr = 0;
    long numSubnodes = 0;
    const int shift = atlas.cubeSizeLog2;
    const uint32_t mask = (1u << shift) - 1;
    const int shiftX = (codedAxesPrevLvl & 4) ? 1 : 0;
    const int shiftY = (codedAxesPrevLvl & 2) ? 1 : 0;
    const int shiftZ = (codedAxesPrevLvl & 1) ? 1 : 0;
    size_t g0 = 0;
    while (g0 < N) {
      int32_t ox = cur.px[g0] >> shift, oy = cur.py[g0] >> shift,
        oz = cur.pz[g0] >> shift;
      size_t g1 = g0 + 1;
      while (g1 < N && (cur.px[g1] >> shift) == ox
             && (cur.py[g1] >> shift) == oy
             && (cur.pz[g1] >> shift) == oz)
        g1++;
      atlas.clearUpdates();
      for (size_t n = g0; n < g1; n++)
        atlas.setByte(int((cur.px[n] & mask) >> shiftX),
                      int((cur.py[n] & mask) >> shiftY),
                      int((cur.pz[n] & mask) >> shiftZ),
                      cur.sibOcc[n]);
      if (nbA.size() < g1 - g0)
        nbA.resize(g1 - g0);
      for (size_t n = g0; n < g1; n++) {
        int32_t pos3[3] = {cur.px[n], cur.py[n], cur.pz[n]};
        decNeighBatch(nbA[n - g0], pos3, codedAxesPrevLvl, atlas,
                      dynK);
      }

      for (size_t n = g0; n < g1; n++) {
      int32_t pos3[3] = {cur.px[n], cur.py[n], cur.pz[n]};
      NeighPattern gnp;
      decNeighSerial(nbA[n - g0], gnp, pos3, atlas,
                     gp.adjacentChildCtx != 0, dynK);

      int posInParent = 0;
      posInParent |= (cur.px[n] & 1) << 2;
      posInParent |= (cur.py[n] & 1) << 1;
      posInParent |= (cur.pz[n] & 1) << 0;
      posInParent &= codedAxesPrevLvl;

      if (gp.planarEnabled && !gp.depthPlanarEligibility) {
        if (!nodesBeforePlanarUpdate--) {
          planarState.updateRate(cur.sibOcc[n], cur.numSib[n]);
          nodesBeforePlanarUpdate = cur.numSib[n] - 1;
        }
      }

      NodePlanar planar;
      bool planarEligible[3] = {false, false, false};
      if (gp.planarEnabled) {
        if (gp.depthPlanarEligibility) {
          if (planarEligibleKDepth)
            planarEligible[0] = planarEligible[1] =
              planarEligible[2] = true;
        } else {
          planarState.isEligible(planarEligible);
        }
        for (int k = 0; k < 3; k++)
          planarEligible[k] =
            planarEligible[k] && ((codedAxesCurLvl >> (2 - k)) & 1);
        // inter PCM eligibility (geometry_octree_decoder.cpp:1990)
        planar.allowPCM = num_ref > 0 && predEffA[n] != 0
          && (planarEligible[0] || planarEligible[1]
              || planarEligible[2]);
        planar.isPreDirMatch = true;
        for (int k = 0; k < 3; k++)
          planar.eligible[k] = planarEligible[k];
        planar.lastDirIdx =
          planarEligible[2] ? 2 : (planarEligible[1] ? 1 : 0);
        if (planarEligible[0] || planarEligible[1]
            || planarEligible[2]) {
          NodePlanar planarRef;
          if (num_ref > 0)
            planesFromOccupancy(predEffA[n], planarRef);
          decodePlanarLs(aec, ctx, planarState, gp, dynObuf,
                         planarEligible, posInParent, gnp, pos3,
                         cur.sibOcc[n], planar,
                         num_ref > 0 ? &planarRef : nullptr);
        }
      }

      for (int k = 0; k < 3; k++) {
        if (!(codedAxesCurLvl & (4 >> k))) {
          planar.planePosBits &= uint8_t(~(1 << k));
          planar.planarMode |= uint8_t(1 << k);
        }
      }
      int planarMask[3] = {0, 0, 0};
      if (planar.planarMode & 1)
        planarMask[0] = (planar.planePosBits & 1) ? 0x0f : 0xf0;
      if (planar.planarMode & 2)
        planarMask[1] = (planar.planePosBits & 2) ? 0x33 : 0xcc;
      if (planar.planarMode & 4)
        planarMask[2] = (planar.planePosBits & 4) ? 0x55 : 0xaa;

      uint32_t occupancy = decodeOccupancyLs(
        aec, ctx, gnp, pos3, codedAxesPrevLvl, atlas, dynK,
        planarMask[0], planarMask[1],
        planarMask[2], planar.planarPossible & 1,
        planar.planarPossible & 2, planar.planarPossible & 4,
        predEffA[n]);
      if (!occupancy)
        return -5;   // corrupt stream

      if (gp.adjacentChildCtx)
        atlas.setChildOcc(int(cur.px[n] & mask),
                          int(cur.py[n] & mask),
                          int(cur.pz[n] & mask), uint8_t(occupancy));

      int numOccupied = __builtin_popcount(occupancy);
      numSubnodes += numOccupied;

      int mispredC = 0;
      if (num_ref > 0) {
        int fail = 0;
        for (int b = 0; b < 8; b++)
          fail += (!!(occupancy & (1u << b)))
            != (!!(predRawA[n] & (1 << b)));
        mispredC = fail < 255 ? fail : 255;
      }

      for (int i = 0; i < 8; i++) {
        if (!((occupancy >> i) & 1))
          continue;
        int32_t cpx = (cur.px[n] << cx) + (!!(i & 4));
        int32_t cpy = (cur.py[n] << cy) + (!!(i & 2));
        int32_t cpz = (cur.pz[n] << cz) + (!!(i & 1));
        if (childIsLeaf) {
          int numPts = 1;
          if (!gp.uniquePoints) {
            int v = aec.bit(&ctx.flat[kCtxDupGt0]);
            if (v)
              v += int(aec.exp_golomb(0, &ctx.flat[kCtxDupEgl]));
            numPts = v + 1;
          }
          for (int j = 0; j < numPts; j++) {
            if (processed >= out_cap)
              return -4;
            out_pos[processed * 3 + 0] = cpx;
            out_pos[processed * 3 + 1] = cpy;
            out_pos[processed * 3 + 2] = cpz;
            processed++;
          }
          continue;
        }
        if (cptr >= childCap)
          return -5;   // corrupt stream: more nodes than points
        nxt.px[cptr] = cpx;
        nxt.py[cptr] = cpy;
        nxt.pz[cptr] = cpz;
        nxt.sibOcc[cptr] = uint8_t(occupancy);
        nxt.numSib[cptr] = uint8_t(numOccupied);
        nxt.mispred[cptr] = uint8_t(mispredC);
        nxtKey[cptr] = (curKey[n] << 3) | uint64_t(i);
        cptr++;
      }
      }
      g0 = g1;
    }

    if (checkPlanarDepthEligibility)
      planarEligibleKDepth = long(num_points) * 10 < numSubnodes * 13;

    std::swap(cur, nxt);
    std::swap(curKey, nxtKey);
    curN = cptr;
  }

  return processed;
}

}  // namespace

extern "C" int obufls_decode_octree(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels,
  int num_points,
  const int32_t* ref_positions, int num_ref,
  const int32_t* gp_arr, int32_t* out_pos, int out_cap) {
  return obufls_decode_impl(aec_buf, aec_len, coded_axis_list,
                            num_levels, num_points, ref_positions,
                            num_ref, gp_arr, out_pos, out_cap);
}

extern "C" int obufls_encode_octree(
  const int32_t* positions, int num_points,
  const int32_t* ref_positions, int num_ref,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr, uint8_t* out_buf, int out_cap) {
  return obufls_encode_impl(positions, num_points, ref_positions,
                            num_ref, coded_axis_list, num_levels,
                            gp_arr, out_buf, out_cap);
}

// debug variant: additionally dumps the per-level token stream (the
// complete product of the batched analysis) so the array-op mirror of
// the analysis can be tested equal (ops/octree_obuf.py)
extern "C" int obufls_encode_octree_dbg(
  const int32_t* positions, int num_points,
  const int32_t* ref_positions, int num_ref,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr, uint8_t* out_buf, int out_cap,
  uint32_t* dbg_toks, int dbg_cap, int32_t* dbg_lvl_counts) {
  return obufls_encode_impl(positions, num_points, ref_positions,
                            num_ref, coded_axis_list, num_levels,
                            gp_arr, out_buf, out_cap, dbg_toks,
                            dbg_cap, dbg_lvl_counts);
}
