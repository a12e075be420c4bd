// Bit-exact reference-conformant G-PCC octree geometry decoder.
//
// This is the conformance engine of the framework: it decodes geometry
// bricks produced by the MPEG reference codec (tmc3) to the identical
// point set.  Unlike the rest of this repository -- which is a
// TPU-first redesign -- this file intentionally reproduces, operation
// for operation, the *normative* decoding semantics of the reference:
//   * the dirac/schroedinger binary arithmetic decoder
//     (dependencies/schroedinger/schroarith.{h,c})
//   * the OBUF bounded-probability context layer and dynamic context
//     maps (tmc3/entropydirac.h:229-253,
//      geometry_octree.h:328-613)
//   * the occupancy-atlas neighbour machinery and the eight per-bit
//     context derivations (tmc3/OctreeNeighMap.cpp)
//   * the BFS octree decode loop
//     (tmc3/geometry_octree_decoder.cpp:1559-2242)
// Constant tables are normative and therefore numerically identical to
// the reference (diraclut window-16 adaptation LUT, OBUF bounds and
// deltas); everything re-derivable (interleaved decode LUT, Morton
// byte-index spread) is generated at runtime.
//
// Scope (round 2 conformance beachhead): octree geometry, intra,
// planar off, IDCM off, angular off, no in-tree scaling, single
// entropy stream, bitwise occupancy, arbitrary QTBT coded-axis lists,
// unique or duplicate points.  Unsupported tool combinations return an
// error code rather than mis-decoding.

#include "obuf_core.h"
#include "angular_core.h"

#include <cfloat>
#include <cstdio>
#include <memory>

namespace {
using namespace obufcore;
using angularcore::AngParams;
using angularcore::contextAngleForPlanar;

// occupancy decode (decodeOccupancyFullNeihbourgs + NZ,
// geometry_octree_decoder.cpp:777-982); planar masks are zero in the
// supported tool set but the mask plumbing is kept for the QTBT case
// (non-coded axes infer the low plane: maskPlanar,
// geometry_octree.cpp:541).
static uint32_t decodeOccupancy(
  ArithDec& aec, RefOctreeCtx& ctx, const NeighPattern& gnp,
  int planarMaskX, int planarMaskY, int planarMaskZ,
  bool planarPossibleX, bool planarPossibleY, bool planarPossibleZ,
  const Atlas& atlas, const int32_t pos[3], int atlasShift,
  bool planarEligibleKDepth, int predOcc = 0) {
  // single child with known position
  if (planarMaskX && planarMaskY && planarMaskZ) {
    uint32_t cnt = planarMaskZ & 1;
    cnt |= (planarMaskY & 1) << 1;
    cnt |= (planarMaskX & 1) << 2;
    return 1u << cnt;
  }

  bool flagNoSingle = false;
  if (gnp.pattern == 0
      && (!predOcc
          || (planarMaskX | planarMaskY | planarMaskZ))) {
    // predOcc == 0 (intra)
    bool singleChild = false;
    if (planarPossibleX && planarPossibleY && planarPossibleZ)
      singleChild = aec.bit(&ctx.ctxSingleChild) == 1;
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
      uint32_t cnt = ((planarMaskX & 1) << 2) | ((planarMaskY & 1) << 1);
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

  // NZ path
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
  prepareNeighInfo(nf, gnp, pos, atlasShift, atlas,
                   planarEligibleKDepth);

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
    int bitv;
    if (sparse)
      bitv = ctx.mapOccSparse[interCtx][i].decodeEvolve(
        &aec, ctx.obufModel, c2, c1, &ctx.leafNumber, ctx.leaves.data());
    else
      bitv = ctx.mapOcc[interCtx][i].decodeEvolve(
        &aec, ctx.obufModel, c2, c1, &ctx.leafNumber, ctx.leaves.data());
    occupancy += uint32_t(bitv) << i;
    coded0[mask0X] += !bitv;
    coded0[mask0Y] += !bitv;
    coded0[mask0Z] += !bitv;
  }
  return occupancy;
}

// occupancy encode (encodeOccupancyFullNeihbourgs + NZ,
// geometry_octree_encoder.cpp:815-982)
static void encodeOccupancy(
  ArithEnc& aec, RefOctreeCtx& ctx, const NeighPattern& gnp,
  int occupancy, int planarMaskX, int planarMaskY, int planarMaskZ,
  bool planarPossibleX, bool planarPossibleY, bool planarPossibleZ,
  const Atlas& atlas, const int32_t pos[3], int atlasShift,
  bool planarEligibleKDepth, int predOcc = 0) {
  if (planarMaskX && planarMaskY && planarMaskZ)
    return;
  bool flagNoSingle = false;
  if (gnp.pattern == 0
      && (!predOcc
          || (planarMaskX | planarMaskY | planarMaskZ))) {
    int pc = occupancy & (occupancy - 1);
    bool singleChild = pc == 0;
    if (planarPossibleX && planarPossibleY && planarPossibleZ)
      aec.bit(&ctx.ctxSingleChild, singleChild);
    if (singleChild) {
      if (!planarMaskZ) aec.bypass(!!(occupancy & 0xaa));
      if (!planarMaskY) aec.bypass(!!(occupancy & 0xcc));
      if (!planarMaskX) aec.bypass(!!(occupancy & 0xf0));
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

  NeighInfo nf;
  prepareNeighInfo(nf, gnp, pos, atlasShift, atlas,
                   planarEligibleKDepth);

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
    uint8_t obufIdx;
    if (sparse)
      obufIdx = ctx.mapOccSparse[interCtx][i].getEvolve(
        bitv, c2, c1, &ctx.leafNumber, ctx.leaves.data());
    else
      obufIdx = ctx.mapOcc[interCtx][i].getEvolve(
        bitv, c2, c1, &ctx.leafNumber, ctx.leaves.data());
    aec.bit_bounded(&ctx.obufModel.prob[obufIdx >> 3], obufIdx >> 3,
                    ctx.obufModel.bound, bitv);
    coded0[mask0X] += !bitv;
    coded0[mask0Y] += !bitv;
    coded0[mask0Z] += !bitv;
  }
}

// ---------------------------------------------------------------------------
// angular IDCM (decodeDirectPosition / encodeDirectPosition angular
// branches, geometry_octree_decoder.cpp:1082-1330 and the encoder
// mirrors); node qp == 0 scope (position scaling is the identity).
// ---------------------------------------------------------------------------

static int decodeThetaResRef(ArithDec& aec, IdcmContexts& ic,
                             int prev) {
  int c = prev != 0;
  if (!aec.bit(&ic.thetaRes[c][0]))
    return 0;
  int absVal = 1;
  absVal += aec.bit(&ic.thetaRes[c][1]);
  if (absVal > 1)
    absVal += aec.bit(&ic.thetaRes[c][2]);
  if (absVal == 3)
    absVal += int(aec.exp_golomb(1, &ic.thetaResExp));
  int ctxSign = (prev > 0) + 2 * (prev < 0);
  bool sign = aec.bit(&ic.thetaResSign[ctxSign]) != 0;
  return sign ? -absVal : absVal;
}

static void encodeThetaResRef(ArithEnc& aec, IdcmContexts& ic,
                              int thetaRes, int prev) {
  int c = prev != 0;
  aec.bit(&ic.thetaRes[c][0], thetaRes != 0);
  if (!thetaRes)
    return;
  int absVal = std::abs(thetaRes);
  aec.bit(&ic.thetaRes[c][1], --absVal > 0);
  if (absVal)
    aec.bit(&ic.thetaRes[c][2], --absVal > 0);
  if (absVal)
    aec.exp_golomb(unsigned(--absVal), 1, &ic.thetaResExp);
  int ctxSign = (prev > 0) + 2 * (prev < 0);
  aec.bit(&ic.thetaResSign[ctxSign], thetaRes < 0);
}

static int decodeZResRef(ArithDec& aec, IdcmContexts& ic) {
  if (!aec.bit(&ic.zRes[0]))
    return 0;
  int absVal = 1;
  absVal += aec.bit(&ic.zRes[1]);
  if (absVal > 1)
    absVal += aec.bit(&ic.zRes[2]);
  if (absVal == 3)
    absVal += int(aec.exp_golomb(1, &ic.zResExp));
  bool sign = aec.bit(&ic.zResSign) != 0;
  return sign ? -absVal : absVal;
}

static void encodeZResRef(ArithEnc& aec, IdcmContexts& ic, int zRes) {
  aec.bit(&ic.zRes[0], zRes != 0);
  if (!zRes)
    return;
  int absVal = std::abs(zRes);
  aec.bit(&ic.zRes[1], --absVal > 0);
  if (absVal)
    aec.bit(&ic.zRes[2], --absVal > 0);
  if (absVal)
    aec.exp_golomb(unsigned(--absVal), 1, &ic.zResExp);
  aec.bit(&ic.zResSign, zRes < 0);
}

// directIdcm-gated joint two-point prefixes (decodeOrdered2ptPrefix,
// geometry_octree_decoder.cpp:1013; encoder mirror)
static void decodeOrdered2ptPrefixDir(
  ArithDec& aec, IdcmContexts& ic, const bool directIdcm[3],
  int sizeRem[3], int32_t pts[2][3]) {
  for (int k = 0; k < 3; k++) {
    if (sizeRem[k] < 1 || !directIdcm[k])
      continue;
    bool samePrev = true;
    for (int j = 0; j < k; j++)
      samePrev = samePrev
        && (!directIdcm[j] || pts[0][j] == pts[1][j]);
    bool sameBit = true;
    int ctxIdx = 0;
    while (sizeRem[k] && sameBit) {
      pts[0][k] <<= 1;
      pts[1][k] <<= 1;
      sizeRem[k]--;
      sameBit = aec.bit(&ic.sameBitHi[k][ctxIdx]) != 0;
      ctxIdx = ctxIdx < 4 ? ctxIdx + 1 : 4;
      if (k == 0) {
        if (sameBit) {
          int bit = aec.bypass();
          pts[0][k] |= bit;
          pts[1][k] |= bit;
        } else {
          pts[1][k] |= 1;
        }
      } else {
        int bit = 0;
        if (!(samePrev && !sameBit))
          bit = aec.bypass();
        pts[0][k] |= bit;
        pts[1][k] |= sameBit ? bit : !bit;
      }
    }
  }
}

static void encodeOrdered2ptPrefixDir(
  ArithEnc& aec, IdcmContexts& ic, const bool directIdcm[3],
  int sizeRem[3], int32_t pts[2][3]) {
  for (int k = 0; k < 3; k++) {
    if (sizeRem[k] < 1 || !directIdcm[k])
      continue;
    bool samePrev = true;
    for (int j = 0; j < k; j++)
      samePrev = samePrev
        && (!directIdcm[j] || pts[0][j] == pts[1][j]);
    bool sameBit = true;
    int ctxIdx = 0;
    while (sizeRem[k] && sameBit) {
      sizeRem[k]--;
      int mask = 1 << sizeRem[k];
      int bit0 = !!(pts[0][k] & mask);
      int bit1 = !!(pts[1][k] & mask);
      sameBit = bit0 == bit1;
      aec.bit(&ic.sameBitHi[k][ctxIdx], sameBit);
      ctxIdx = ctxIdx < 4 ? ctxIdx + 1 : 4;
      if (k == 0) {
        if (sameBit)
          aec.bypass(bit0);
      } else {
        if (!(samePrev && !sameBit))
          aec.bypass(bit0);
      }
    }
  }
}

// decodePointPositionAngular (decoder :1082-1246); identity position
// scaling.  delta carries the planar-inferred prefix bits on entry;
// returns the final per-axis deltas (caller adds nodePosS).
static void decodePointPositionAngularRef(
  ArithDec& aec, RefOctreeCtx& ctx, AngParams& ang,
  const int sizeRem[3], const int32_t nodePosS[3],
  const int32_t posNodeLidar[3], int nodeLaserIdx, int predLaserIdx,
  int32_t delta[3], bool enableInter = false) {
  using angularcore::iatan2;
  using angularcore::irsqrt;
  using angularcore::isqrt;
  using angularcore::divExp2RoundHalfInf;
  using angularcore::ctxIndexForAngularPhiIdcm;

  const int directAxis =
    std::abs(posNodeLidar[0]) <= std::abs(posNodeLidar[1]) ? 1 : 0;
  for (int i = sizeRem[directAxis]; i > 0; i--) {
    delta[directAxis] <<= 1;
    delta[directAxis] |= aec.bypass();
  }

  int32_t posXyz[3];
  for (int k = 0; k < 3; k++)
    posXyz[k] = posNodeLidar[k] + (delta[k] << sizeRem[k]);
  posXyz[directAxis] =
    nodePosS[directAxis] + delta[directAxis] - ang.origin[directAxis];

  int resLaser = decodeThetaResRef(
    aec, ctx.idcm,
    enableInter ? ang.prevThetaResInter[nodeLaserIdx]
                : ang.prevThetaRes[nodeLaserIdx]);
  int laserIdx = predLaserIdx + resLaser;
  if (ang.extension) {
    if (enableInter)
      ang.prevThetaResInter[nodeLaserIdx] = resLaser;
    else
      ang.prevThetaRes[nodeLaserIdx] = resLaser;
  }
  if (laserIdx < 0 || laserIdx >= ang.numLasers)
    laserIdx = std::min(std::max(laserIdx, 0), ang.numLasers - 1);

  const int thInterp = 1 << 13;
  int phiNode = iatan2(posXyz[1], posXyz[0]);
  int phiTop = directAxis
    ? iatan2(posXyz[1], posXyz[0] + (1 << sizeRem[!directAxis]))
    : iatan2(posXyz[1] + (1 << sizeRem[!directAxis]), posXyz[0]);
  int phiMiddle = (phiNode + phiTop) >> 1;
  if (ang.extension && !(std::abs(phiNode - phiTop) < thInterp))
    phiMiddle = directAxis
      ? iatan2(posXyz[1], posXyz[0] + ((1 << sizeRem[!directAxis]) >> 1))
      : iatan2(posXyz[1] + ((1 << sizeRem[!directAxis]) >> 1),
               posXyz[0]);

  int predPhi = ang.phiBuffer[size_t(laserIdx)];
  int phiRef = ang.extension ? phiMiddle : phiNode;
  if (predPhi == int(0x80000000))
    predPhi = phiRef;
  {
    int nShift = int(
      ((int64_t(predPhi - phiRef) * ang.phiZi.invDelta[size_t(laserIdx)])
       + (int64_t(1) << 29)) >> 30);
    predPhi -= ang.phiZi.delta[size_t(laserIdx)] * nShift;
  }

  const int phiAxis = !directAxis;
  for (int mask = (1 << sizeRem[phiAxis]) >> 1,
           shiftBits = sizeRem[phiAxis];
       mask; mask >>= 1, shiftBits--) {
    int scaledMask = mask;
    int phiL, phiR;
    if (ang.extension) {
      const int offset = scaledMask - 1;
      const int offset2 = shiftBits > 1 ? (shiftBits > 2 ? 0 : 1) : 2;
      phiL = phiNode
        + (((offset - offset2) * (phiMiddle - phiNode)) >> shiftBits);
      phiR = phiMiddle
        + (((offset + offset2) * (phiMiddle - phiNode)) >> shiftBits);
    } else {
      phiL = phiNode;
      phiR = directAxis ? iatan2(posXyz[1], posXyz[0] + scaledMask)
                        : iatan2(posXyz[1] + scaledMask, posXyz[0]);
    }

    int angleL = phiL - predPhi;
    int angleR = phiR - predPhi;
    int contextAnglePhi =
      (angleL >= 0 && angleR >= 0) || (angleL < 0 && angleR < 0) ? 2
                                                                 : 0;
    angleL = std::abs(angleL);
    angleR = std::abs(angleR);
    if (angleL > angleR) {
      contextAnglePhi++;
      std::swap(angleL, angleR);
    }
    if (angleR > (angleL << 1))
      contextAnglePhi += 4;

    int ctxIndex = 0;
    if (ang.extension)
      ctxIndex = ctxIndexForAngularPhiIdcm(
        ang.phiZi.delta[size_t(laserIdx)], std::abs(phiL - phiR));
    int bit = aec.bit(
      &ctx.ctxPlanarPlaneLastIndexAngularPhiIdcm[contextAnglePhi]
                                                [ctxIndex]);
    delta[phiAxis] <<= 1;
    if (bit) {
      delta[phiAxis] |= 1;
      posXyz[phiAxis] += scaledMask;
      if (ang.extension) {
        phiNode = phiMiddle;
      } else {
        phiNode = phiR;
        predPhi = ang.phiBuffer[size_t(laserIdx)];
        if (predPhi == int(0x80000000))
          predPhi = phiNode;
        int nShift = int(
          ((int64_t(predPhi - phiNode)
            * ang.phiZi.invDelta[size_t(laserIdx)])
           + (int64_t(1) << 29)) >> 30);
        predPhi -= ang.phiZi.delta[size_t(laserIdx)] * nShift;
      }
    } else if (ang.extension) {
      phiTop = phiMiddle;
    }

    if (ang.extension) {
      if (std::abs(phiNode - phiTop) < thInterp)
        phiMiddle = (phiNode + phiTop) >> 1;
      else
        phiMiddle = directAxis
          ? iatan2(posXyz[1], posXyz[0] + (scaledMask >> 1))
          : iatan2(posXyz[1] + (scaledMask >> 1), posXyz[0]);
      int nShift = int(
        ((int64_t(predPhi - phiMiddle)
          * ang.phiZi.invDelta[size_t(laserIdx)])
         + (int64_t(1) << 29)) >> 30);
      predPhi -= ang.phiZi.delta[size_t(laserIdx)] * nShift;
    }
  }

  ang.phiBuffer[size_t(laserIdx)] = phiNode;

  // -- THETA --
  int maskz = (1 << sizeRem[2]) >> 1;
  if (!maskz)
    return;

  if (ang.extension) {
    uint64_t xLidar = uint64_t(int64_t(posXyz[0]) << 8);
    uint64_t yLidar = uint64_t(int64_t(posXyz[1]) << 8);
    int64_t r = isqrt(xLidar * xLidar + yLidar * yLidar);
    int64_t zRec26 = int64_t(ang.thetaLaser[laserIdx]) * r;
    zRec26 -= int64_t(ang.zLaser[laserIdx]) << 23;
    int32_t zRec = int32_t(divExp2RoundHalfInf(zRec26, 26));
    zRec = std::max(zRec, posXyz[2]);
    zRec = std::min(zRec, posXyz[2] + (2 * maskz - 1));
    int32_t zRes = decodeZResRef(aec, ctx.idcm);
    delta[2] = zRes + zRec + ang.origin[2] - nodePosS[2];
  } else {
    uint64_t xLidar = uint64_t((int64_t(posXyz[0]) << 8) - 128);
    uint64_t yLidar = uint64_t((int64_t(posXyz[1]) << 8) - 128);
    int64_t rInv = int64_t(irsqrt(xLidar * xLidar + yLidar * yLidar));
    int64_t hr = int64_t(ang.zLaser[laserIdx]) * rInv;
    int fixedThetaLaser = ang.thetaLaser[laserIdx]
      + int(hr >= 0 ? -(hr >> 17) : ((-hr) >> 17));
    int zShift = int((rInv * (1 << sizeRem[2])) >> 18);
    int deltaZ = delta[2];
    for (int bitIdxZ = sizeRem[2]; bitIdxZ > 0;
         bitIdxZ--, maskz >>= 1, zShift >>= 1) {
      int64_t zLidar = ((int64_t(posXyz[2]) + maskz) << 1) - 1;
      int64_t theta = zLidar * rInv;
      int theta32 = int(theta >= 0 ? theta >> 15 : -((-theta) >> 15));
      int thetaLaserDelta = fixedThetaLaser - theta32;
      int thetaLaserDeltaBot = thetaLaserDelta + zShift;
      int thetaLaserDeltaTop = thetaLaserDelta - zShift;
      int contextAngle = thetaLaserDelta >= 0 ? 0 : 1;
      if (thetaLaserDeltaTop >= 0)
        contextAngle += 2;
      else if (thetaLaserDeltaBot < 0)
        contextAngle += 2;
      deltaZ <<= 1;
      deltaZ |=
        aec.bit(&ctx.ctxPlanarPlaneLastIndexAngularIdcm[contextAngle]);
      if (deltaZ & 1)
        deltaZ += maskz;   // literal mirror of the reference
                           // (decodePointPositionZAngular :1289)
    }
    delta[2] = deltaZ;
  }
}

// encode mirror (encodePointPositionAngular,
// geometry_octree_encoder.cpp:1085-1262)
static void encodePointPositionAngularRef(
  ArithEnc& aec, RefOctreeCtx& ctx, AngParams& ang,
  const NodePlanar& planar, const int sizeRem[3],
  const int32_t posNodeLidarIn[3], const int32_t pos[3],
  int nodeLaserIdx, bool enableInter = false,
  const int32_t* predPoint = nullptr) {
  using angularcore::iatan2;
  using angularcore::irsqrt;
  using angularcore::isqrt;
  using angularcore::divExp2RoundHalfInf;
  using angularcore::ctxIndexForAngularPhiIdcm;
  using angularcore::findLaser;
  using angularcore::findLaserPrecise;

  int32_t posXyz[3] = {posNodeLidarIn[0], posNodeLidarIn[1],
                       posNodeLidarIn[2]};
  const int directAxis =
    std::abs(posXyz[0]) <= std::abs(posXyz[1]) ? 1 : 0;

  for (int mask = (1 << sizeRem[directAxis]) >> 1; mask; mask >>= 1)
    aec.bypass(!!(pos[directAxis] & mask));

  for (int k = 0; k < 3; k++)
    if (k != directAxis)
      if (planar.planePosBits & (1 << k))
        posXyz[k] += 1 << sizeRem[k];
  posXyz[directAxis] = pos[directAxis] - ang.origin[directAxis];

  int laserIdx;
  int predLaserIdx = nodeLaserIdx;
  if (enableInter && predPoint) {
    // inter IDCM: the laser prediction comes from the reference
    // point (encodePointPositionAngular, encoder :1536-1546)
    int32_t pr[3] = {predPoint[0] - ang.origin[0],
                     predPoint[1] - ang.origin[1],
                     predPoint[2] - ang.origin[2]};
    if (ang.extension)
      predLaserIdx = findLaserPrecise(pr, ang.thetaLaser, ang.zLaser,
                                      ang.numLasers);
    else
      predLaserIdx = findLaser(pr, ang.thetaLaser, ang.numLasers);
  }
  {
    int32_t p3[3] = {pos[0] - ang.origin[0], pos[1] - ang.origin[1],
                     pos[2] - ang.origin[2]};
    // NB: findLaser* take origin-relative points
    if (ang.extension)
      laserIdx =
        findLaserPrecise(p3, ang.thetaLaser, ang.zLaser, ang.numLasers);
    else
      laserIdx = findLaser(p3, ang.thetaLaser, ang.numLasers);
  }

  int resLaser = laserIdx - predLaserIdx;
  encodeThetaResRef(aec, ctx.idcm, resLaser,
                    enableInter
                      ? ang.prevThetaResInter[nodeLaserIdx]
                      : ang.prevThetaRes[nodeLaserIdx]);
  if (ang.extension) {
    if (enableInter)
      ang.prevThetaResInter[nodeLaserIdx] = resLaser;
    else
      ang.prevThetaRes[nodeLaserIdx] = resLaser;
  }

  const int thInterp = 1 << 13;
  int phiNode = iatan2(posXyz[1], posXyz[0]);
  int phiTop = directAxis
    ? iatan2(posXyz[1], posXyz[0] + (1 << sizeRem[!directAxis]))
    : iatan2(posXyz[1] + (1 << sizeRem[!directAxis]), posXyz[0]);
  int phiMiddle = (phiNode + phiTop) >> 1;
  if (ang.extension && !(std::abs(phiNode - phiTop) < thInterp))
    phiMiddle = directAxis
      ? iatan2(posXyz[1], posXyz[0] + ((1 << sizeRem[!directAxis]) >> 1))
      : iatan2(posXyz[1] + ((1 << sizeRem[!directAxis]) >> 1),
               posXyz[0]);

  int predPhi = ang.phiBuffer[size_t(laserIdx)];
  int phiRef = ang.extension ? phiMiddle : phiNode;
  if (predPhi == int(0x80000000))
    predPhi = phiRef;
  {
    int nShift = int(
      ((int64_t(predPhi - phiRef) * ang.phiZi.invDelta[size_t(laserIdx)])
       + (int64_t(1) << 29)) >> 30);
    predPhi -= ang.phiZi.delta[size_t(laserIdx)] * nShift;
  }

  const int phiAxis = !directAxis;
  for (int mask = (1 << sizeRem[phiAxis]) >> 1,
           shiftBits = sizeRem[phiAxis];
       mask; mask >>= 1, shiftBits--) {
    int scaledMask = mask;
    int phiL, phiR;
    if (ang.extension) {
      const int offset = scaledMask - 1;
      const int offset2 = shiftBits > 1 ? (shiftBits > 2 ? 0 : 1) : 2;
      phiL = phiNode
        + (((offset - offset2) * (phiMiddle - phiNode)) >> shiftBits);
      phiR = phiMiddle
        + (((offset + offset2) * (phiMiddle - phiNode)) >> shiftBits);
    } else {
      phiL = phiNode;
      phiR = directAxis ? iatan2(posXyz[1], posXyz[0] + scaledMask)
                        : iatan2(posXyz[1] + scaledMask, posXyz[0]);
    }

    int angleL = phiL - predPhi;
    int angleR = phiR - predPhi;
    int contextAnglePhi =
      (angleL >= 0 && angleR >= 0) || (angleL < 0 && angleR < 0) ? 2
                                                                 : 0;
    angleL = std::abs(angleL);
    angleR = std::abs(angleR);
    if (angleL > angleR) {
      contextAnglePhi++;
      std::swap(angleL, angleR);
    }
    if (angleR > (angleL << 1))
      contextAnglePhi += 4;

    int bit = !!(pos[phiAxis] & mask);
    int ctxIndex = 0;
    if (ang.extension)
      ctxIndex = ctxIndexForAngularPhiIdcm(
        ang.phiZi.delta[size_t(laserIdx)], std::abs(phiL - phiR));
    aec.bit(&ctx.ctxPlanarPlaneLastIndexAngularPhiIdcm[contextAnglePhi]
                                                      [ctxIndex],
            bit);
    if (bit) {
      posXyz[phiAxis] += scaledMask;
      if (ang.extension) {
        phiNode = phiMiddle;
      } else {
        phiNode = phiR;
        predPhi = ang.phiBuffer[size_t(laserIdx)];
        if (predPhi == int(0x80000000))
          predPhi = phiNode;
        int nShift = int(
          ((int64_t(predPhi - phiNode)
            * ang.phiZi.invDelta[size_t(laserIdx)])
           + (int64_t(1) << 29)) >> 30);
        predPhi -= ang.phiZi.delta[size_t(laserIdx)] * nShift;
      }
    } else if (ang.extension) {
      phiTop = phiMiddle;
    }

    if (ang.extension) {
      if (std::abs(phiNode - phiTop) < thInterp)
        phiMiddle = (phiNode + phiTop) >> 1;
      else
        phiMiddle = directAxis
          ? iatan2(posXyz[1], posXyz[0] + (scaledMask >> 1))
          : iatan2(posXyz[1] + (scaledMask >> 1), posXyz[0]);
      int nShift = int(
        ((int64_t(predPhi - phiMiddle)
          * ang.phiZi.invDelta[size_t(laserIdx)])
         + (int64_t(1) << 29)) >> 30);
      predPhi -= ang.phiZi.delta[size_t(laserIdx)] * nShift;
    }
  }

  ang.phiBuffer[size_t(laserIdx)] = phiNode;

  // -- THETA --
  int maskz = (1 << sizeRem[2]) >> 1;
  if (!maskz)
    return;

  if (ang.extension) {
    uint64_t xLidar = uint64_t(int64_t(posXyz[0]) << 8);
    uint64_t yLidar = uint64_t(int64_t(posXyz[1]) << 8);
    int64_t r = isqrt(xLidar * xLidar + yLidar * yLidar);
    int64_t zRec26 = int64_t(ang.thetaLaser[laserIdx]) * r;
    zRec26 -= int64_t(ang.zLaser[laserIdx]) << 23;
    int32_t zRec = int32_t(divExp2RoundHalfInf(zRec26, 26));
    zRec = std::max(zRec, posXyz[2]);
    zRec = std::min(zRec, posXyz[2] + (2 * maskz - 1));
    int32_t zRes = (pos[2] - ang.origin[2]) - zRec;
    encodeZResRef(aec, ctx.idcm, zRes);
  } else {
    uint64_t xLidar = uint64_t((int64_t(posXyz[0]) << 8) - 128);
    uint64_t yLidar = uint64_t((int64_t(posXyz[1]) << 8) - 128);
    int64_t rInv = int64_t(irsqrt(xLidar * xLidar + yLidar * yLidar));
    int64_t hr = int64_t(ang.zLaser[laserIdx]) * rInv;
    int fixedThetaLaser = ang.thetaLaser[laserIdx]
      + int(hr >= 0 ? -(hr >> 17) : ((-hr) >> 17));
    int zShift = int((rInv * (1 << sizeRem[2])) >> 18);
    for (; maskz; maskz >>= 1, zShift >>= 1) {
      int64_t zLidar = ((int64_t(posXyz[2]) + maskz) << 1) - 1;
      int64_t theta = zLidar * rInv;
      int theta32 = int(theta >= 0 ? theta >> 15 : -((-theta) >> 15));
      int thetaLaserDelta = fixedThetaLaser - theta32;
      int thetaLaserDeltaBot = thetaLaserDelta + zShift;
      int thetaLaserDeltaTop = thetaLaserDelta - zShift;
      int contextAngle = thetaLaserDelta >= 0 ? 0 : 1;
      if (thetaLaserDeltaTop >= 0)
        contextAngle += 2;
      else if (thetaLaserDeltaBot < 0)
        contextAngle += 2;
      int bit = !!(pos[2] & maskz);
      aec.bit(&ctx.ctxPlanarPlaneLastIndexAngularIdcm[contextAngle],
              bit);
      if (bit)
        posXyz[2] += maskz;
    }
  }
}

// ---------------------------------------------------------------------------
// cuboid-partition global motion (gbh.lpu_type == 1): the predictor
// is split into LPU cuboids and a per-block arithmetic flag selects
// the GM-compensated ("world") or untouched ("vehicle") window
// (motionWip.cpp:178-420; the flags ride the geometry brick's own
// arithmetic stream ahead of the octree payload,
// geometry_octree_decoder.cpp:1673-1691).
// ---------------------------------------------------------------------------

struct CuboidGm {
  const int32_t* vehicle = nullptr;  // predPointCloud, slice-global
  const int32_t* world = nullptr;    // GM-applied twin, same count
  int num = 0;
  int32_t mbs[3] = {0, 0, 0};        // gbh.motion_block_size
  int32_t boxOrigin[3] = {0, 0, 0};  // gbh.geomBoxOrigin (STV)
  // encode-only inputs (encodeCuboidGlobalMotion)
  const int32_t* cur = nullptr;      // current cloud, slice-global
  int numCur = 0;
  int windowSize = 0;                // motion_window_size
};

namespace cuboidgm {

// bbox over the vehicle predictor + LPU grid dims
// (computeBoundingBox; encode/decodeCuboidGlobalMotion)
static int lpuGrid(const CuboidGm& gm, int32_t mn[3], int lpuN[3]) {
  mn[0] = mn[1] = mn[2] = INT32_MAX;
  int32_t mx[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
  for (int i = 0; i < gm.num; i++)
    for (int k = 0; k < 3; k++) {
      int32_t v = gm.vehicle[i * 3 + k];
      if (v < mn[k]) mn[k] = v;
      if (v > mx[k]) mx[k] = v;
    }
  if (gm.num == 0)
    mn[0] = mn[1] = mn[2] = 0, mx[0] = mx[1] = mx[2] = 0;
  int blockSize = 1;
  for (int k = 0; k < 3; k++) {
    lpuN[k] = gm.mbs[k]
      ? (mx[k] - mn[k] + gm.mbs[k] - 1) / gm.mbs[k] : 1;
    blockSize *= lpuN[k];
  }
  return blockSize;
}

// per-point LPU block index, or -1 when outside the grid
// (populateWindowList, motionWip.cpp:178-205; NB C++ trunc division)
static inline int blockIdx(const int32_t* p, const int32_t mn[3],
                           const int32_t mbs[3], const int lpuN[3]) {
  int idx[3];
  for (int k = 0; k < 3; k++) {
    idx[k] = mbs[k] ? int((p[k] - mn[k]) / mbs[k]) : 0;
    if (idx[k] < 0 || idx[k] >= lpuN[k])
      return -1;
  }
  return (idx[0] * lpuN[1] + idx[1]) * lpuN[2] + idx[2];
}

// concatenate per-block windows, world or vehicle per flag
// (compensateCuboidGlobalMotion, motionWip.cpp:206-241), then shift
// to slice-local coords (updatePredictorWorld origin subtraction)
static void compensate(const CuboidGm& gm,
                       const std::vector<uint8_t>& isWorld,
                       const int32_t mn[3], const int lpuN[3],
                       std::vector<int32_t>& out) {
  const int blockSize = int(isWorld.size());
  // bucket both clouds by block (stable, original order kept)
  std::vector<int> cntW(size_t(blockSize) + 1, 0),
    cntV(size_t(blockSize) + 1, 0);
  std::vector<int> idxW(static_cast<size_t>(gm.num));
  std::vector<int> idxV(static_cast<size_t>(gm.num));
  for (int i = 0; i < gm.num; i++) {
    idxW[size_t(i)] = blockIdx(&gm.world[i * 3], mn, gm.mbs, lpuN);
    if (idxW[size_t(i)] >= 0)
      cntW[size_t(idxW[size_t(i)]) + 1]++;
    idxV[size_t(i)] = blockIdx(&gm.vehicle[i * 3], mn, gm.mbs, lpuN);
    if (idxV[size_t(i)] >= 0)
      cntV[size_t(idxV[size_t(i)]) + 1]++;
  }
  for (int b = 0; b < blockSize; b++) {
    cntW[size_t(b) + 1] += cntW[size_t(b)];
    cntV[size_t(b) + 1] += cntV[size_t(b)];
  }
  int total = 0;
  for (int b = 0; b < blockSize; b++)
    total += isWorld[size_t(b)]
      ? cntW[size_t(b) + 1] - cntW[size_t(b)]
      : cntV[size_t(b) + 1] - cntV[size_t(b)];
  // per-block scatter offsets in the output
  std::vector<int> outOff(static_cast<size_t>(blockSize));
  {
    int acc = 0;
    for (int b = 0; b < blockSize; b++) {
      outOff[size_t(b)] = acc;
      acc += isWorld[size_t(b)]
        ? cntW[size_t(b) + 1] - cntW[size_t(b)]
        : cntV[size_t(b) + 1] - cntV[size_t(b)];
    }
  }
  out.assign(size_t(total) * 3, 0);
  std::vector<int> fill(static_cast<size_t>(blockSize), 0);
  for (int i = 0; i < gm.num; i++) {
    int bW = idxW[size_t(i)];
    if (bW >= 0 && isWorld[size_t(bW)]) {
      int o = outOff[size_t(bW)] + fill[size_t(bW)]++;
      for (int k = 0; k < 3; k++)
        out[size_t(o) * 3 + size_t(k)] =
          gm.world[i * 3 + k] - gm.boxOrigin[k];
    }
    int bV = idxV[size_t(i)];
    if (bV >= 0 && !isWorld[size_t(bV)]) {
      int o = outOff[size_t(bV)] + fill[size_t(bV)]++;
      for (int k = 0; k < 3; k++)
        out[size_t(o) * 3 + size_t(k)] =
          gm.vehicle[i * 3 + k] - gm.boxOrigin[k];
    }
  }
}

// plus1log2shifted4 (motionWip.cpp:113-124)
static const int kLutLog2[64] = {
  INT32_MIN, 0,  16, 25, 32, 37, 41, 45, 48, 51, 53, 55, 57, 59, 61,
  63, 64,    65, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79,
  79, 80,    81, 81, 82, 83, 83, 84, 85, 85, 86, 86, 87, 87, 88, 88,
  89, 89,    90, 90, 91, 91, 92, 92, 93, 93, 93, 94, 94, 95, 95, 95,
  96};

static inline int plus1log2shifted4(int x) {
  x++;
  int result = 0;
  while (x >= 64) {
    x >>= 1;
    result += 16;
  }
  return result + kLutLog2[x];
}

// calcCostOfGlobalMotion (motionWip.cpp:127-176); the reference's
// scratch pointer writes are dead stores and omitted
static double windowCost(const std::vector<int32_t>& window,
                         const std::vector<int32_t>& block0,
                         int wSize) {
  size_t nw = window.size() / 3, nb = block0.size() / 3;
  if (!nw)
    return DBL_MAX;
  const int samples = 4;
  const int decimate = 6;
  if (nw > size_t(samples) * size_t(std::max(int(nb), 16)))
    wSize >>= 1;
  int maxDistance = wSize << 1;
  long dist = 0;
  size_t jumpBlock = 1 + (nb >> decimate);
  for (size_t ib = 0; ib < nb; ib += jumpBlock) {
    const int32_t* b = &block0[ib * 3];
    int min_d = maxDistance;
    for (size_t iw = 0; iw < nw; iw++) {
      const int32_t* w = &window[iw * 3];
      int a0 = std::abs(int(b[0] - w[0]));
      int a1 = std::abs(int(b[1] - w[1]));
      int a2 = std::abs(int(b[2] - w[2]));
      int d = a0 + a1 + a2;
      if (d < min_d)
        min_d = d;
    }
    dist += plus1log2shifted4(min_d);
  }
  return double(jumpBlock) * double(dist);
}

// populateCuboidBlocks (motionWip.cpp:241-282): stride-4 sampling,
// each sample contributes once to every block its +/-window-shifted
// copies land in
static void populateBlocks(std::vector<std::vector<int32_t>>& blocks,
                           const int32_t* cloud, int num,
                           const int32_t mbs[3],
                           const std::vector<int>& thDists,
                           const int32_t mn[3], const int lpuN[3]) {
  const int samples = 4;
  std::vector<int> seen;
  for (int i = 0; i < num; i += samples) {
    const int32_t* p = &cloud[i * 3];
    seen.clear();
    for (size_t m = 0; m < thDists.size(); m++) {
      int xidx = mbs[0]
        ? int((p[0] + thDists[m] - mn[0]) / mbs[0]) : 0;
      if (xidx < 0 || xidx >= lpuN[0])
        continue;
      for (size_t n = 0; n < thDists.size(); n++) {
        int yidx = mbs[1]
          ? int((p[1] + thDists[n] - mn[1]) / mbs[1]) : 0;
        if (yidx < 0 || yidx >= lpuN[1])
          continue;
        for (size_t k = 0; k < thDists.size(); k++) {
          int zidx = mbs[2]
            ? int((p[2] + thDists[k] - mn[2]) / mbs[2]) : 0;
          if (zidx < 0 || zidx >= lpuN[2])
            continue;
          int idx = (xidx * lpuN[1] + yidx) * lpuN[2] + zidx;
          bool dup = false;
          for (int s : seen)
            if (s == idx) { dup = true; break; }
          if (!dup)
            seen.push_back(idx);
        }
      }
    }
    for (int idx : seen) {
      blocks[size_t(idx)].push_back(p[0]);
      blocks[size_t(idx)].push_back(p[1]);
      blocks[size_t(idx)].push_back(p[2]);
    }
  }
}

// encoder-side isWorld decision (encodeCuboidGlobalMotion,
// motionWip.cpp:283-356)
static void decideIsWorld(const CuboidGm& gm, const int32_t mn[3],
                          const int lpuN[3], int blockSize,
                          std::vector<uint8_t>& isWorld) {
  std::vector<int> thDists;
  thDists.push_back(gm.windowSize);
  if (gm.windowSize)
    thDists.push_back(-gm.windowSize);
  std::vector<std::vector<int32_t>> b0(static_cast<size_t>(blockSize));
  std::vector<std::vector<int32_t>> bw(static_cast<size_t>(blockSize));
  std::vector<std::vector<int32_t>> bv(static_cast<size_t>(blockSize));
  populateBlocks(b0, gm.cur, gm.numCur, gm.mbs, thDists, mn, lpuN);
  populateBlocks(bw, gm.world, gm.num, gm.mbs, thDists, mn, lpuN);
  populateBlocks(bv, gm.vehicle, gm.num, gm.mbs, thDists, mn, lpuN);
  isWorld.assign(size_t(blockSize), 1);
  for (int i = 0; i < blockSize; i++) {
    if (b0[size_t(i)].empty()
        || (bw[size_t(i)].empty() && bv[size_t(i)].empty()))
      continue;
    double costWorld =
      windowCost(bw[size_t(i)], b0[size_t(i)], gm.windowSize);
    double costVehicle =
      windowCost(bv[size_t(i)], b0[size_t(i)], gm.windowSize);
    if (bw[size_t(i)].empty() || costWorld >= costVehicle)
      isWorld[size_t(i)] = 0;
  }
}

}  // namespace cuboidgm

// inter IDCM prediction mode (canInterFrameEncodeDirectPosition,
// geometry_octree.h:965-1007); may overwrite the node's IDCM
// eligibility when one_point_alone_laser_beam_flag is set
enum class DMode { kUnavailable, kTwoPoints, kAllPointSame };

template<typename NodeT>
static DMode canInterDirectPositionRef(
  AngParams& ang, NodeT& node0, const int nodeSizeLog2[3],
  const int32_t* ref_positions, const std::vector<int32_t>& rorder,
  bool uniquePoints) {
  if (ang.onePointAlone) {
    bool thetaElig = false, phiElig = false;
    angularcore::isThetaPhiEligible(ang, node0.laserIndex, node0.pos,
                                    nodeSizeLog2, thetaElig, phiElig);
    node0.idcmEligible = uint8_t(
      uniquePoints ? (thetaElig && phiElig)
                   : (thetaElig || phiElig));
  }
  int numPoints = node0.rend - node0.rstart;
  if (numPoints > 10)
    return DMode::kUnavailable;
  bool allEq = numPoints > 1 && !uniquePoints;
  const int32_t* p0 =
    allEq ? &ref_positions[rorder[size_t(node0.rstart)] * 3] : nullptr;
  for (int32_t i = node0.rstart + 1; allEq && i < node0.rend; i++) {
    const int32_t* pi = &ref_positions[rorder[size_t(i)] * 3];
    allEq &= p0[0] == pi[0] && p0[1] == pi[1] && p0[2] == pi[2];
  }
  if (allEq)
    return DMode::kAllPointSame;
  if (numPoints > 2)            // MAX_NUM_DM_LEAF_POINTS
    return DMode::kUnavailable;
  return DMode::kTwoPoints;
}


}  // namespace

// ---------------------------------------------------------------------------
// public entry: intra octree geometry brick encode
// (encodeGeometryOctree, geometry_octree_encoder.cpp:1853-2660, with
// the unsupported tools compiled out).  positions: slice-local STV
// grid coords; out buffer receives the AEC bytes; returns byte count.
// ---------------------------------------------------------------------------

static int encode_octree_impl(
  const int32_t* positions, int num_points,
  const int32_t* ref_positions, int num_ref,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr,           // GeomParams as 12 int32s
  uint8_t* out_buf, int out_cap,
  int ts_base = 0,                 // trisoup: leaf node size log2
  std::vector<int32_t>* ts_leaves = nullptr,   // origins+ranges out
  std::vector<int32_t>* ts_order = nullptr,    // point permutation out
  void** ts_coder = nullptr,       // trisoup: live coder handoff
  int stream_cnt_minus1 = 0,       // gbh.geom_stream_cnt_minus1
  AngParams* ang = nullptr,        // angular octree mode
  const CuboidGm* gm = nullptr,    // cuboid-partition global motion
  const int32_t* ref2_positions = nullptr,  // bi-prediction: 2nd ref
  int num_ref2 = 0) {
  GeomParams gp;
  std::memcpy(&gp, gp_arr, sizeof gp);
  const int neighbour_avail_boundary_log2 = gp.neighAvailBoundaryLog2;
  const int adjacent_child_ctx = gp.adjacentChildCtx;
  const int unique_points = gp.uniquePoints;
  if (neighbour_avail_boundary_log2 < 1
      || neighbour_avail_boundary_log2 > 9)
    return -2;

  ArithEnc aec;
  aec.chunked = gp.cabacBypassStream != 0;
  aec.init();
  aec.bypassNoUpdate = gp.bypassNoUpdate != 0;

  // cuboid GM: decide + signal the per-LPU isWorld flags, then
  // replace the predictor with the compensated concatenation
  // (encodeCuboidGlobalMotion, motionWip.cpp:283-356)
  std::vector<int32_t> gmPred;
  if (gm) {
    int32_t mn[3];
    int lpuN[3];
    int blockSize = cuboidgm::lpuGrid(*gm, mn, lpuN);
    std::vector<uint8_t> isWorld;
    cuboidgm::decideIsWorld(*gm, mn, lpuN, blockSize, isWorld);
    uint16_t ctxIsWorld = 0x8000;
    for (int i = 0; i < blockSize; i++)
      aec.bit(&ctxIsWorld, isWorld[size_t(i)]);
    cuboidgm::compensate(*gm, isWorld, mn, lpuN, gmPred);
    ref_positions = gmPred.data();
    num_ref = int(gmPred.size() / 3);
  }

  RefOctreeCtx ctx;
  ctx.resetMaps(gp.planarEnabled != 0);

  PlanarState planarState;
  planarState.bufferEnabled = gp.planarEnabled && gp.planarBufferEnabled;
  planarState.multiplePlanar = gp.planarEnabled && gp.multiplePlanar;
  for (int k = 0; k < 3; k++)
    planarState.rateThreshold[k] = gp.planarTh[k] << 4;
  const bool dynObuf = gp.planarEnabled
    && gp.planarDynamicObufEligibility;
  const bool checkPlanarDepthEligibility = gp.planarEnabled
    && gp.depthPlanarEligibility;
  bool planarEligibleKDepth = false;
  int nodesBeforePlanarUpdate = 1;

  // boundary_log2_minus1 == 0 disables the atlas entirely in the
  // reference (geometry_octree_decoder.cpp:1633,1895): the neighbour
  // pattern then comes from sibling occupancy only and all adjacency
  // words read as empty.  A size-1 atlas that is never refreshed
  // reproduces that (every probe lands on a zero byte).
  const bool useAtlas = neighbour_avail_boundary_log2 > 1;
  Atlas atlas;
  atlas.resize(adjacent_child_ctx != 0,
               useAtlas ? neighbour_avail_boundary_log2 : 0);

  std::vector<int> lvlSize[3];
  {
    // for trisoup bricks the smallest level is the trisoup node size,
    // not 0 (mirrors the decoder, geometry_octree_decoder.cpp:1647)
    int size[3] = {ts_base, ts_base, ts_base};
    std::vector<int> acc[3];
    for (int k = 0; k < 3; k++) acc[k].push_back(ts_base);
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
  const int maxDepth = num_levels;

  // encoder nodes carry their point range [start, end) into a shared
  // index array, partitioned by counting sort per level
  // (countingSort, geometry_octree_encoder.cpp:2210)
  struct ENode {
    int32_t pos[3];
    int32_t start, end;
    int32_t rstart, rend;        // compensated-reference point range
    int32_t rstart2 = 0, rend2 = 0;  // second reference (bi-pred)
    uint8_t siblingOccupancy;
    uint8_t numSiblingsPlus1;
    uint8_t mispred;             // parent's prediction failures
    uint8_t predDir = 0;         // bi-prediction: selected reference
    uint8_t idcmEligible = 0;
    uint8_t laserIndex = 255;    // angular: inherited laser id
  };
  const uint32_t idcmMaskInit = mkIdcmEnableMask(gp);
  long numPointsCodedByIdcm = 0;
  std::vector<int32_t> order{};
  order.resize(size_t(num_points));
  for (int i = 0; i < num_points; i++) order[size_t(i)] = i;
  std::vector<int32_t> scratch{};
  scratch.resize(size_t(num_points));

  std::vector<int32_t> rorder, rscratch;
  if (num_ref > 0) {
    rorder.resize(size_t(num_ref));
    for (int i = 0; i < num_ref; i++) rorder[size_t(i)] = i;
    rscratch.resize(size_t(num_ref));
  }
  // bi-prediction: second compensated reference, its own point-range
  // partition (pointPredictorWorld2, geometry_octree_encoder.cpp:
  // 1896-1920, 2236-2249)
  std::vector<int32_t> rorder2, rscratch2;
  if (num_ref2 > 0) {
    rorder2.resize(size_t(num_ref2));
    for (int i = 0; i < num_ref2; i++) rorder2[size_t(i)] = i;
    rscratch2.resize(size_t(num_ref2));
  }
  const bool enabledBiPred = num_ref2 > 0;

  std::vector<ENode> fifo;
  fifo.reserve(size_t(num_points) + 8);
  ENode root;
  root.idcmEligible = 0;
  root.pos[0] = root.pos[1] = root.pos[2] = 0;
  root.start = 0;
  root.end = num_points;
  root.rstart = 0;
  root.rend = num_ref;
  root.rstart2 = 0;
  root.rend2 = num_ref2;
  root.predDir = 0;
  root.siblingOccupancy = 0;
  root.numSiblingsPlus1 = 8;
  root.mispred = 0;
  fifo.push_back(root);
  size_t head = 0;

  // multi-stream bricks: fresh back-to-back coder per deep level,
  // contexts restored to the state saved before level maxDepth-1-cnt
  // (geometry_octree_encoder.cpp:2133-2142; streams concatenated as
  // encoder.cpp:1503-1511 does)
  std::unique_ptr<RefOctreeCtx> savedCtx;
  std::unique_ptr<PlanarState> savedPlanar;
  std::vector<uint8_t> catOut;

  for (int depth = 0; depth < maxDepth; depth++) {
    if (stream_cnt_minus1
        && depth == maxDepth - 1 - stream_cnt_minus1) {
      savedCtx.reset(new RefOctreeCtx(ctx));
      savedPlanar.reset(new PlanarState(planarState));
    }
    if (stream_cnt_minus1
        && depth > maxDepth - 1 - stream_cnt_minus1 && savedCtx) {
      ctx = *savedCtx;
      planarState = *savedPlanar;
      aec.flush();
      catOut.insert(catOut.end(), aec.out.begin(), aec.out.end());
      aec.init();
      aec.bypassNoUpdate = gp.bypassNoUpdate != 0;
    }
    size_t lvlEnd = fifo.size();
    int32_t atlasOrigin[3] = {-0x7fffffff, -0x7fffffff, -0x7fffffff};
    int codedAxesPrevLvl = depth ? coded_axis_list[depth - 1] : 7;
    int codedAxesCurLvl = coded_axis_list[depth];
    int childSizeLog2[3] = {lvlSize[0][depth + 1], lvlSize[1][depth + 1],
                            lvlSize[2][depth + 1]};
    bool childIsLeaf = !childSizeLog2[0] && !childSizeLog2[1]
      && !childSizeLog2[2];
    // child-bit probe masks (qtBtChildSize): 0 when the axis is not
    // coded at this level
    int32_t probe[3];
    for (int k = 0; k < 3; k++)
      probe[k] = (codedAxesCurLvl & (4 >> k))
        ? (int32_t(1) << childSizeLog2[k]) : 0;
    if (gp.planarEnabled) {
      int planarDepth[3] = {lvlSize[0][0] - lvlSize[0][depth],
                            lvlSize[1][0] - lvlSize[1][depth],
                            lvlSize[2][0] - lvlSize[2][depth]};
      planarState.initPlanes(planarDepth);
    }
    const bool dynK = dynObuf && planarEligibleKDepth;
    long numSubnodes = 0;
    uint32_t idcmEnableMask = rotr32(idcmMaskInit, depth);
    const int nodeMaxDimLog2 = std::max(
      lvlSize[0][depth], std::max(lvlSize[1][depth],
                                  lvlSize[2][depth]));

    for (; head < lvlEnd; head++) {
      ENode node0 = fifo[head];

      // counting sort of the node's points into 8 child buckets.
      // In-place cycle-swap form, exactly the reference's countingSort
      // (PCCMisc.h:271-298): it is NOT stable, and the within-bucket
      // permutation is normatively visible through the angular IDCM
      // two-point order (direct-axis ties keep "input" order).
      int counts[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int32_t p = node0.start; p < node0.end; p++) {
        const int32_t* pt = &positions[order[size_t(p)] * 3];
        int b = (!!(pt[2] & probe[2])) | (!!(pt[1] & probe[1]) << 1)
          | (!!(pt[0] & probe[0]) << 2);
        counts[b]++;
      }
      int offs[8];
      int acc = node0.start;
      for (int b = 0; b < 8; b++) {
        offs[b] = acc;
        acc += counts[b];
      }
      {
        int ptrs[8];
        std::memcpy(ptrs, offs, sizeof ptrs);
        int origLast = node0.start;
        for (int i = 0; i < 8; i++) {
          origLast += counts[i];
          while (ptrs[i] != origLast) {
            const int32_t* pt = &positions[order[size_t(ptrs[i])] * 3];
            int radix = (!!(pt[2] & probe[2]))
              | (!!(pt[1] & probe[1]) << 1)
              | (!!(pt[0] & probe[0]) << 2);
            std::swap(order[size_t(ptrs[i])],
                      order[size_t(ptrs[radix])]);
            ptrs[radix]++;
          }
        }
      }
      int occupancy = 0;
      int numOccupied = 0;
      for (int b = 0; b < 8; b++)
        if (counts[b]) {
          occupancy |= 1 << b;
          numOccupied++;
        }

      // compensated-reference partition -> child prediction
      // (reference geometry_octree_encoder.cpp:2253-2291); under
      // bi-prediction BOTH references are partitioned every node and
      // the parent's predDir selects which one contextualises this
      // node (geometry_octree_encoder.cpp:2156-2158, 2284-2285)
      int rcounts[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      int roffs[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      int rcounts2[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      int roffs2[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      int predOccRaw = 0;
      int predOccRaw2 = 0;
      int effPredOcc = 0;
      auto partRef = [&probe](const int32_t* refp,
                              std::vector<int32_t>& ord,
                              std::vector<int32_t>& scr,
                              int32_t rs, int32_t re, int* cnts,
                              int* offp) {
        for (int32_t p = rs; p < re; p++) {
          const int32_t* pt = &refp[ord[size_t(p)] * 3];
          int b = (!!(pt[2] & probe[2])) | (!!(pt[1] & probe[1]) << 1)
            | (!!(pt[0] & probe[0]) << 2);
          cnts[b]++;
        }
        int racc = rs;
        for (int b = 0; b < 8; b++) {
          offp[b] = racc;
          racc += cnts[b];
        }
        int w[8];
        std::memcpy(w, offp, sizeof w);
        for (int32_t p = rs; p < re; p++) {
          const int32_t* pt = &refp[ord[size_t(p)] * 3];
          int b = (!!(pt[2] & probe[2])) | (!!(pt[1] & probe[1]) << 1)
            | (!!(pt[0] & probe[0]) << 2);
          scr[size_t(w[b]++)] = ord[size_t(p)];
        }
        if (re > rs)
          std::memcpy(&ord[size_t(rs)], &scr[size_t(rs)],
                      sizeof(int32_t) * size_t(re - rs));
        int occ = 0;
        for (int b = 0; b < 8; b++)
          if (cnts[b]) occ |= 1 << b;
        return occ;
      };
      if (num_ref > 0 && node0.rend > node0.rstart)
        predOccRaw = partRef(ref_positions, rorder, rscratch,
                             node0.rstart, node0.rend, rcounts, roffs);
      if (enabledBiPred && node0.rend2 > node0.rstart2)
        predOccRaw2 = partRef(ref2_positions, rorder2, rscratch2,
                              node0.rstart2, node0.rend2, rcounts2,
                              roffs2);
      if (num_ref > 0) {
        // predDir selects the contextualising reference
        // (geometry_octree_encoder.cpp:2284-2285), then the
        // occupancyIsPredictable gate (:2287)
        int sel = node0.predDir ? predOccRaw2 : predOccRaw;
        if (sel && node0.mispred <= 5)
          effPredOcc = sel;
      }
      // reference planes from the (gated) predicted occupancy
      // (setPlanesFromOccupancy, geometry_octree_encoder.cpp:2291-2294)
      NodePlanar planarRef;
      if (num_ref > 0)
        planesFromOccupancy(effPredOcc, planarRef);

      // atlas refresh (mirrors the decoder exactly)
      if (useAtlas) {
        const int shift = atlas.cubeSizeLog2;
        const uint32_t mask = (1u << shift) - 1;
        const int shiftX = (codedAxesPrevLvl & 4) ? 1 : 0;
        const int shiftY = (codedAxesPrevLvl & 2) ? 1 : 0;
        const int shiftZ = (codedAxesPrevLvl & 1) ? 1 : 0;
        int32_t curOrigin[3] = {node0.pos[0] >> shift,
                                node0.pos[1] >> shift,
                                node0.pos[2] >> shift};
        if (curOrigin[0] != atlasOrigin[0]
            || curOrigin[1] != atlasOrigin[1]
            || curOrigin[2] != atlasOrigin[2]) {
          atlasOrigin[0] = curOrigin[0];
          atlasOrigin[1] = curOrigin[1];
          atlasOrigin[2] = curOrigin[2];
          atlas.clearUpdates();
          for (size_t it = head; it < lvlEnd; ++it) {
            const ENode& n = fifo[it];
            if (curOrigin[0] != (n.pos[0] >> shift)
                || curOrigin[1] != (n.pos[1] >> shift)
                || curOrigin[2] != (n.pos[2] >> shift))
              break;
            atlas.setByte(int((n.pos[0] & mask) >> shiftX),
                          int((n.pos[1] & mask) >> shiftY),
                          int((n.pos[2] & mask) >> shiftZ),
                          n.siblingOccupancy);
          }
        }
      }

      int posInParent = 0;
      posInParent |= (node0.pos[0] & 1) << 2;
      posInParent |= (node0.pos[1] & 1) << 1;
      posInParent |= (node0.pos[2] & 1) << 0;
      posInParent &= codedAxesPrevLvl;

      NeighPattern gnp;
      if (useAtlas)
        gnp = makeNeighPattern(
          adjacent_child_ctx != 0, node0.pos, codedAxesPrevLvl, atlas,
          dynK);
      else
        gnp.pattern = uint8_t(neighPatternFromOccupancy(
          posInParent, node0.siblingOccupancy));

      // inter IDCM prediction mode; with one_point_alone it also
      // overrides the node's eligibility
      // (geometry_octree_encoder.cpp:2296-2304)
      DMode predMode = DMode::kUnavailable;
      if (ang && ang->interIdcm) {
        int nszIdcm[3] = {lvlSize[0][depth], lvlSize[1][depth],
                          lvlSize[2][depth]};
        predMode = canInterDirectPositionRef(
          *ang, node0, nszIdcm, ref_positions, rorder,
          unique_points != 0);
      }

      // IDCM mode decision (canEncodeDirectPosition,
      // geometry_octree.h:995); with planar_disabled_idcm_angular the
      // flag is coded BEFORE planar and suppresses it
      // (geometry_octree_encoder.cpp:2305-2330)
      int idcmMode = 0;  // 0 unavailable, 1 two-points, 2 all-same
      bool planarEligIdcmAng = true;
      bool idcmFlagCoded = false;
      if (node0.idcmEligible) {
        int numPts = node0.end - node0.start;
        if (numPts <= 10) {
          bool allSame = numPts > 1 && !unique_points;
          for (int32_t p = node0.start + 1; allSame && p < node0.end;
               p++)
            allSame = positions[order[size_t(p)] * 3 + 0]
                == positions[order[size_t(node0.start)] * 3 + 0]
              && positions[order[size_t(p)] * 3 + 1]
                == positions[order[size_t(node0.start)] * 3 + 1]
              && positions[order[size_t(p)] * 3 + 2]
                == positions[order[size_t(node0.start)] * 3 + 2];
          if (allSame)
            idcmMode = 2;
          else if (numPts <= 2)
            idcmMode = 1;
        }
        if (ang && ang->planarDisabledIdcmAngular) {
          aec.bit(&ctx.idcm.blockSkip, idcmMode != 0);
          idcmFlagCoded = true;
          if (idcmMode != 0)
            planarEligIdcmAng = false;
        }
      }

      // angular planar context derivation (contextAngle -1 = off)
      int contextAngle = -1;
      int contextAnglePhiX = -1;
      int contextAnglePhiY = -1;
      if (ang && planarEligIdcmAng) {
        int nsz[3] = {lvlSize[0][depth], lvlSize[1][depth],
                      lvlSize[2][depth]};
        contextAngle = contextAngleForPlanar(
          *ang, node0.laserIndex, node0.pos, nsz, &contextAnglePhiX,
          &contextAnglePhiY);
      }

      if (gp.planarEnabled && planarEligIdcmAng
          && !gp.depthPlanarEligibility) {
        if (!nodesBeforePlanarUpdate--) {
          planarState.updateRate(node0.siblingOccupancy,
                                 node0.numSiblingsPlus1);
          nodesBeforePlanarUpdate = node0.numSiblingsPlus1 - 1;
        }
      }

      NodePlanar planar;
      bool planarEligible[3] = {false, false, false};
      if (gp.planarEnabled && planarEligIdcmAng) {
        if (gp.depthPlanarEligibility) {
          if (ang) {
            if (contextAngle != -1)
              planarEligible[2] = true;
            planarEligible[0] = contextAnglePhiX != -1;
            planarEligible[1] = contextAnglePhiY != -1;
          } else if (planarEligibleKDepth) {
            planarEligible[0] = planarEligible[1] = planarEligible[2] =
              true;
          }
        } else {
          planarState.isEligible(planarEligible);
          if (ang) {
            if (contextAngle != -1)
              planarEligible[2] = true;
            planarEligible[0] = contextAnglePhiX != -1;
            planarEligible[1] = contextAnglePhiY != -1;
          }
        }
        for (int k = 0; k < 3; k++)
          planarEligible[k] =
            planarEligible[k] && ((codedAxesCurLvl >> (2 - k)) & 1);
        // inter PCM eligibility (geometry_octree_encoder.cpp:2383-2391)
        planar.allowPCM = num_ref > 0 && effPredOcc != 0
          && (planarEligible[0] || planarEligible[1]
              || planarEligible[2]);
        planar.isPreDirMatch = true;
        for (int k = 0; k < 3; k++)
          planar.eligible[k] = planarEligible[k];
        planar.lastDirIdx =
          planarEligible[2] ? 2 : (planarEligible[1] ? 1 : 0);
        if (planarEligible[0] || planarEligible[1]
            || planarEligible[2])
          determinePlanarIntraEnc(
            aec, ctx, planarState, gp, dynObuf, planarEligible,
            posInParent, gnp, node0.pos, node0.siblingOccupancy,
            occupancy, planar, contextAngle, contextAnglePhiX,
            contextAnglePhiY, num_ref > 0 ? &planarRef : nullptr);
      }

      // inferred direct coding (encodeDirectPosition,
      // geometry_octree_encoder.cpp:2400-2446)
      if (node0.idcmEligible) {
        int numPts = node0.end - node0.start;
        int mode = idcmMode;
        if (!idcmFlagCoded)
          aec.bit(&ctx.idcm.blockSkip, mode != 0);
        if (mode != 0) {
          int numCoded = numPts;
          if (mode == 1) {
            aec.bit(&ctx.idcm.numPointsGt1, numPts > 1);
            if (!unique_points && numPts == 1)
              aec.bit(&ctx.ctxDupPointCntGt0, 0);
          } else {
            aec.bit(&ctx.idcm.numPointsGt1, 0);
            aec.bit(&ctx.ctxDupPointCntGt0, 1);
            aec.bit(&ctx.idcm.dupGt1, numPts - 1 > 1);
            if (numPts - 1 > 1)
              aec.exp_golomb(unsigned(numPts - 3), 0,
                             &ctx.ctxDupPointCntEgl);
            numCoded = 1;
          }
          int32_t pts[2][3];
          for (int i = 0; i < numCoded && i < 2; i++)
            for (int k = 0; k < 3; k++)
              pts[i][k] =
                positions[order[size_t(node0.start + i)] * 3 + k];
          int idcmSize[3] = {lvlSize[0][depth], lvlSize[1][depth],
                             lvlSize[2][depth]};
          int sizeRem[3];
          for (int k = 0; k < 3; k++) {
            sizeRem[k] = idcmSize[k];
            if (sizeRem[k] > 0 && (planar.planarMode & (1 << k)))
              sizeRem[k]--;
          }
          if (ang) {
            // angular IDCM (encodeDirectPosition angular branch)
            int32_t nodePosS[3], posNodeLidar[3];
            for (int k = 0; k < 3; k++) {
              nodePosS[k] = node0.pos[k] << idcmSize[k];
              posNodeLidar[k] = nodePosS[k] - ang->origin[k];
            }
            const int directAxis =
              std::abs(posNodeLidar[0]) <= std::abs(posNodeLidar[1])
              ? 1 : 0;
            bool directIdcm[3] = {directAxis == 0, directAxis == 1,
                                  false};
            if (numCoded == 2 && gp.jointTwoPointIdcm) {
              // implicit ordering over the direct axis only
              if (pts[1][directAxis] < pts[0][directAxis])
                for (int k = 0; k < 3; k++)
                  std::swap(pts[0][k], pts[1][k]);
              encodeOrdered2ptPrefixDir(aec, ctx.idcm, directIdcm,
                                        sizeRem, pts);
            }
            // laser estimate from the coded-so-far bits of point 0
            int32_t probe[3];
            for (int k = 0; k < 3; k++) {
              int32_t d = pts[0][k] - nodePosS[k];
              d = (d >> sizeRem[k]) << sizeRem[k];
              d += (1 << sizeRem[k]) >> 1;
              probe[k] = posNodeLidar[k] + d;
            }
            int estLaser = ang->extension
              ? angularcore::findLaserPrecise(
                  probe, ang->thetaLaser, ang->zLaser, ang->numLasers)
              : angularcore::findLaser(probe, ang->thetaLaser,
                                       ang->numLasers);
            // inter IDCM prediction set (encodeDirectPosition
            // :2432-2436 + :2456-2470)
            int numPredFramePoints =
              predMode == DMode::kAllPointSame
                ? 1 : node0.rend - node0.rstart;
            numPredFramePoints =
              numPredFramePoints < numCoded ? numPredFramePoints
                                            : numCoded;
            const bool canInterPred = ang->interIdcm
              && predMode != DMode::kUnavailable
              && numPredFramePoints > 0;
            for (int i = 0; i < numCoded; i++) {
              int32_t p3[3] = {pts[i][0], pts[i][1], pts[i][2]};
              const int32_t* predPt = nullptr;
              int32_t predBuf[3];
              if (canInterPred) {
                int predIdx = numPredFramePoints == 2 ? i : 0;
                const int32_t* pp = &ref_positions[
                  rorder[size_t(node0.rstart + predIdx)] * 3];
                predBuf[0] = pp[0];
                predBuf[1] = pp[1];
                predBuf[2] = pp[2];
                predPt = predBuf;
              }
              encodePointPositionAngularRef(
                aec, ctx, *ang, planar, sizeRem, posNodeLidar, p3,
                estLaser, canInterPred, predPt);
            }
          } else {
          if (numCoded == 2 && gp.jointTwoPointIdcm) {
            // implicit ordering of the two points (all axes direct)
            bool swap = false;
            for (int k = 0; k < 3; k++) {
              if (pts[1][k] != pts[0][k]) {
                swap = pts[1][k] < pts[0][k];
                break;
              }
            }
            if (swap)
              for (int k = 0; k < 3; k++)
                std::swap(pts[0][k], pts[1][k]);
            encodeOrdered2ptPrefixIntra(aec, ctx.idcm, pts, sizeRem);
          }
          for (int i = 0; i < numCoded; i++)
            for (int k = 0; k < 3; k++)
              for (int b = sizeRem[k] - 1; b >= 0; b--)
                aec.bypass((pts[i][k] >> b) & 1);
          }
          numPointsCodedByIdcm += numPts;
          if (adjacent_child_ctx) {
            const uint32_t cmask = (1u << atlas.cubeSizeLog2) - 1;
            atlas.setChildOcc(int(node0.pos[0] & cmask),
                              int(node0.pos[1] & cmask),
                              int(node0.pos[2] & cmask), 0);
          }
          continue;
        }
      }

      numSubnodes += numOccupied;
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

      encodeOccupancy(aec, ctx, gnp, occupancy, planarMask[0],
                      planarMask[1], planarMask[2],
                      planar.planarPossible & 1,
                      planar.planarPossible & 2,
                      planar.planarPossible & 4, atlas, node0.pos,
                      codedAxesPrevLvl, dynK, effPredOcc);

      if (adjacent_child_ctx) {
        const uint32_t mask = (1u << atlas.cubeSizeLog2) - 1;
        atlas.setChildOcc(int(node0.pos[0] & mask),
                          int(node0.pos[1] & mask),
                          int(node0.pos[2] & mask), uint8_t(occupancy));
      }

      // prediction-failure counts (geometry_octree_encoder.cpp:
      // 2258-2283).  NB: the reference OVERWRITES predFailureCount
      // with the parent-selected value after the first occupied
      // child (:2573-2575), so later children's predDir tie-breaks
      // see the mutated value — failCur models that exactly
      int fail1 = 0;
      int fail2 = 0;
      for (int b = 0; b < 8; b++) {
        fail1 += (!!(occupancy & (1 << b)))
          != (!!(predOccRaw & (1 << b)));
        fail2 += (!!(occupancy & (1 << b)))
          != (!!(predOccRaw2 & (1 << b)));
      }
      int failCur = fail1;
      for (int i = 0; i < 8; i++) {
        if (!counts[i])
          continue;
        int x = !!(i & 4), y = !!(i & 2), z = !!(i & 1);
        if (childIsLeaf) {
          if (!unique_points) {
            // encodePositionLeafNumPoints
            int dupCnt = counts[i] - 1;
            aec.bit(&ctx.ctxDupPointCntGt0, dupCnt > 0);
            if (dupCnt > 0)
              aec.exp_golomb(unsigned(dupCnt - 1), 0,
                             &ctx.ctxDupPointCntEgl);
          }
          continue;
        }
        ENode child;
        child.pos[0] = (node0.pos[0] << !!(codedAxesCurLvl & 4)) + x;
        child.pos[1] = (node0.pos[1] << !!(codedAxesCurLvl & 2)) + y;
        child.pos[2] = (node0.pos[2] << !!(codedAxesCurLvl & 1)) + z;
        child.start = offs[i];
        child.end = offs[i] + counts[i];
        child.rstart = roffs[i];
        child.rend = roffs[i] + rcounts[i];
        child.rstart2 = roffs2[i];
        child.rend2 = roffs2[i] + rcounts2[i];
        child.siblingOccupancy = uint8_t(occupancy);
        child.numSiblingsPlus1 = uint8_t(numOccupied);
        child.laserIndex = node0.laserIndex;
        {
          // per-child reference selection under bi-prediction
          // (geometry_octree_encoder.cpp:2562-2576): empty-side
          // fallback, otherwise the fewer-failures side with the
          // parent's direction breaking ties
          child.predDir = node0.predDir;
          if (enabledBiPred) {
            if (!rcounts2[i])
              child.predDir = 0;
            else if (!rcounts[i])
              child.predDir = 1;
            else if (failCur != fail2)
              child.predDir = uint8_t(failCur >= fail2);
          }
          failCur = node0.predDir ? fail2 : failCur;
          child.mispred = uint8_t(failCur < 255 ? failCur : 255);
        }
        child.idcmEligible = 0;
        {
          // isDirectModeEligible[_Inter]
          // (geometry_octree_encoder.cpp:2577-2590)
          bool elig;
          if (num_ref > 0 && !ang)
            elig = idcmEligibleInter(
              gp.idcmMode, nodeMaxDimLog2, gnp.pattern,
              node0.numSiblingsPlus1, numOccupied, effPredOcc != 0);
          else
            elig = idcmEligibleIntra(
              gp.idcmMode, nodeMaxDimLog2, gnp.pattern,
              node0.numSiblingsPlus1, numOccupied, effPredOcc != 0,
              ang != nullptr);
          if (elig) {
            elig = (idcmEnableMask & 1) != 0;
            idcmEnableMask = rotr32(idcmEnableMask, 1);
          }
          child.idcmEligible = uint8_t(elig);
        }
        fifo.push_back(child);
      }
    }
    if (checkPlanarDepthEligibility)
      planarEligibleKDepth =
        (long(num_points) - numPointsCodedByIdcm) * 10
        < numSubnodes * 13;
  }

  if (ts_leaves) {
    // trisoup bridge: export leaf origins at full resolution with
    // their point ranges (encodeGeometryOctree nodesRemaining,
    // geometry_octree_encoder.cpp:2623-2631), the point permutation,
    // and the live arithmetic encoder for the trisoup stages
    int rem[3] = {lvlSize[0][maxDepth], lvlSize[1][maxDepth],
                  lvlSize[2][maxDepth]};
    ts_leaves->reserve((fifo.size() - head) * 5);
    for (size_t it = head; it < fifo.size(); ++it) {
      const ENode& nd = fifo[it];
      for (int k = 0; k < 3; ++k)
        ts_leaves->push_back(nd.pos[k] << rem[k]);
      ts_leaves->push_back(nd.start);
      ts_leaves->push_back(nd.end);
    }
    *ts_order = order;
    TsCoderHandle* h = new TsCoderHandle();
    h->enc = aec;
    h->isEnc = true;
    *ts_coder = h;
    return int(fifo.size() - head);
  }

  aec.flush();
  catOut.insert(catOut.end(), aec.out.begin(), aec.out.end());
  if (int(catOut.size()) > out_cap)
    return -4;
  std::memcpy(out_buf, catOut.data(), catOut.size());
  return int(catOut.size());
}

// ---------------------------------------------------------------------------
// public entry: intra octree geometry brick decode
// (decodeGeometryOctree, geometry_octree_decoder.cpp:1559-2242, with
// the unsupported tools compiled out)
// ---------------------------------------------------------------------------

static int decode_octree_impl(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list,  // per level, 3-bit stv split masks
  int num_levels,
  int num_points,                  // footer geom_num_points_minus1 + 1
  const int32_t* ref_positions, int num_ref,
  const int32_t* gp_arr,           // GeomParams as 12 int32s
  int32_t* out_pos,                // capacity out_cap * 3 (stv order)
  int out_cap,
  int skip_levels = 0,             // scalable truncation
  int max_nodes_stop = 0,          // stop descending at this count
  int ts_base = 0,                 // trisoup: leaf node size log2
  std::vector<int32_t>* ts_leaves = nullptr,  // trisoup: origins out
  void** ts_coder = nullptr,       // trisoup: live coder handoff
  int stream_cnt_minus1 = 0,       // gbh.geom_stream_cnt_minus1
  AngParams* ang = nullptr,        // angular octree mode
  const CuboidGm* gm = nullptr,    // cuboid-partition global motion
  const int32_t* ref2_positions = nullptr,  // bi-prediction: 2nd ref
  int num_ref2 = 0) {
  GeomParams gp;
  std::memcpy(&gp, gp_arr, sizeof gp);
  const int neighbour_avail_boundary_log2 = gp.neighAvailBoundaryLog2;
  const int adjacent_child_ctx = gp.adjacentChildCtx;
  const int unique_points = gp.uniquePoints;
  if (neighbour_avail_boundary_log2 < 1
      || neighbour_avail_boundary_log2 > 9)
    return -2;

  ArithDec aec;
  aec.chunked = gp.cabacBypassStream != 0;
  aec.init(aec_buf, size_t(aec_len));
  aec.bypassNoUpdate = gp.bypassNoUpdate != 0;

  // cuboid GM: the per-LPU isWorld flags lead the arithmetic stream
  // (decodeCuboidGlobalMotion, motionWip.cpp:357-388); the
  // compensated concatenation replaces the caller's predictor
  std::vector<int32_t> gmPred;
  if (gm) {
    int32_t mn[3];
    int lpuN[3];
    int blockSize = cuboidgm::lpuGrid(*gm, mn, lpuN);
    std::vector<uint8_t> isWorld(size_t(blockSize), 0);
    uint16_t ctxIsWorld = 0x8000;
    for (int i = 0; i < blockSize; i++)
      isWorld[size_t(i)] = uint8_t(aec.bit(&ctxIsWorld));
    cuboidgm::compensate(*gm, isWorld, mn, lpuN, gmPred);
    ref_positions = gmPred.data();
    num_ref = int(gmPred.size() / 3);
  }

  RefOctreeCtx ctx;
  ctx.resetMaps(gp.planarEnabled != 0);

  PlanarState planarState;
  planarState.bufferEnabled = gp.planarEnabled && gp.planarBufferEnabled;
  planarState.multiplePlanar = gp.planarEnabled && gp.multiplePlanar;
  for (int k = 0; k < 3; k++)
    planarState.rateThreshold[k] = gp.planarTh[k] << 4;
  const bool dynObuf = gp.planarEnabled
    && gp.planarDynamicObufEligibility;
  const bool checkPlanarDepthEligibility = gp.planarEnabled
    && gp.depthPlanarEligibility;
  bool planarEligibleKDepth = false;
  int nodesBeforePlanarUpdate = 1;

  // see the encoder-side note: minus1 == 0 means "no atlas" in the
  // reference; a never-refreshed size-1 atlas reads as all-empty
  const bool useAtlas = neighbour_avail_boundary_log2 > 1;
  Atlas atlas;
  atlas.resize(adjacent_child_ctx != 0,
               useAtlas ? neighbour_avail_boundary_log2 : 0);

  // node size per level, smallest first then reversed
  // (geometry_octree_decoder.cpp:1646-1652); for trisoup bricks the
  // smallest level is the trisoup node size, not 0 (:1647)
  std::vector<int> lvlSize[3];
  {
    int size[3] = {ts_base, ts_base, ts_base};
    std::vector<int> acc[3];
    for (int k = 0; k < 3; k++) acc[k].push_back(ts_base);
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
  int skipc = skip_levels < 0 ? 0
    : (skip_levels > num_levels ? num_levels : skip_levels);
  int maxDepth = num_levels - skipc;

  std::vector<int32_t> rorder, rscratch;
  if (num_ref > 0) {
    rorder.resize(size_t(num_ref));
    for (int i = 0; i < num_ref; i++) rorder[size_t(i)] = i;
    rscratch.resize(size_t(num_ref));
  }
  // bi-prediction: second compensated reference
  // (geometry_octree_decoder.cpp:1600-1604, 1693-1705)
  std::vector<int32_t> rorder2, rscratch2;
  if (num_ref2 > 0) {
    rorder2.resize(size_t(num_ref2));
    for (int i = 0; i < num_ref2; i++) rorder2[size_t(i)] = i;
    rscratch2.resize(size_t(num_ref2));
  }
  const bool enabledBiPred = num_ref2 > 0;

  const uint32_t idcmMaskInit = mkIdcmEnableMask(gp);
  long numPointsCodedByIdcm = 0;

  std::vector<Node> fifo;
  fifo.reserve(size_t(num_points) + 8);
  Node root;
  root.idcmEligible = 0;
  root.pos[0] = root.pos[1] = root.pos[2] = 0;
  root.rstart = 0;
  root.rend = num_ref;
  root.rstart2 = 0;
  root.rend2 = num_ref2;
  root.predDir = 0;
  root.siblingOccupancy = 0;
  root.numSiblingsPlus1 = 8;
  fifo.push_back(root);
  size_t head = 0;

  int processed = 0;

  // multi-stream bricks: context state saved before level
  // maxDepth-1-cnt, restored (with a coder restart on the next
  // back-to-back sub-stream) for each of the last cnt levels
  // (geometry_octree_decoder.cpp:1782-1790)
  std::unique_ptr<RefOctreeCtx> savedCtx;
  std::unique_ptr<PlanarState> savedPlanar;

  for (int depth = 0; depth < maxDepth; depth++) {
    if (stream_cnt_minus1
        && depth == maxDepth - 1 - stream_cnt_minus1) {
      savedCtx.reset(new RefOctreeCtx(ctx));
      savedPlanar.reset(new PlanarState(planarState));
    }
    if (stream_cnt_minus1
        && depth > maxDepth - 1 - stream_cnt_minus1 && savedCtx) {
      ctx = *savedCtx;
      planarState = *savedPlanar;
      aec.flushRestart();
    }
    size_t lvlEnd = fifo.size();
    if (max_nodes_stop > 0 && depth < num_levels
        && (int64_t)(lvlEnd - head) >= max_nodes_stop) {
      // decodeMaxPoints-style truncation: this level already has
      // enough nodes; emit centres here
      skipc = num_levels - depth;
      maxDepth = depth;
      break;
    }
    int32_t atlasOrigin[3] = {-0x7fffffff, -0x7fffffff, -0x7fffffff};
    int codedAxesPrevLvl = depth ? coded_axis_list[depth - 1] : 7;
    int codedAxesCurLvl = coded_axis_list[depth];
    int childSizeLog2[3] = {lvlSize[0][depth + 1], lvlSize[1][depth + 1],
                            lvlSize[2][depth + 1]};
    bool childIsLeaf = !childSizeLog2[0] && !childSizeLog2[1]
      && !childSizeLog2[2];
    int32_t probe[3];
    for (int k = 0; k < 3; k++)
      probe[k] = (codedAxesCurLvl & (4 >> k))
        ? (int32_t(1) << childSizeLog2[k]) : 0;
    // beginOctreeLevel: planar buffer rows follow the per-axis depth
    // coded so far (planarDepth = rootSize - nodeSize)
    if (gp.planarEnabled) {
      int planarDepth[3] = {lvlSize[0][0] - lvlSize[0][depth],
                            lvlSize[1][0] - lvlSize[1][depth],
                            lvlSize[2][0] - lvlSize[2][depth]};
      planarState.initPlanes(planarDepth);
    }
    const bool dynK = dynObuf && planarEligibleKDepth;
    long numSubnodes = 0;
    uint32_t idcmEnableMask = rotr32(idcmMaskInit, depth);
    const int nodeMaxDimLog2 = std::max(
      lvlSize[0][depth], std::max(lvlSize[1][depth],
                                  lvlSize[2][depth]));

    for (; head < lvlEnd; head++) {
      Node node0 = fifo[head];

      // refresh atlas for this node's look-ahead cube
      // (updateGeometryOccupancyAtlas, OctreeNeighMap.cpp:83)
      if (useAtlas) {
        const int shift = atlas.cubeSizeLog2;
        const uint32_t mask = (1u << shift) - 1;
        const int shiftX = (codedAxesPrevLvl & 4) ? 1 : 0;
        const int shiftY = (codedAxesPrevLvl & 2) ? 1 : 0;
        const int shiftZ = (codedAxesPrevLvl & 1) ? 1 : 0;
        int32_t curOrigin[3] = {node0.pos[0] >> shift,
                                node0.pos[1] >> shift,
                                node0.pos[2] >> shift};
        if (curOrigin[0] != atlasOrigin[0]
            || curOrigin[1] != atlasOrigin[1]
            || curOrigin[2] != atlasOrigin[2]) {
          atlasOrigin[0] = curOrigin[0];
          atlasOrigin[1] = curOrigin[1];
          atlasOrigin[2] = curOrigin[2];
          atlas.clearUpdates();
          for (size_t it = head; it < lvlEnd; ++it) {
            const Node& n = fifo[it];
            if (curOrigin[0] != (n.pos[0] >> shift)
                || curOrigin[1] != (n.pos[1] >> shift)
                || curOrigin[2] != (n.pos[2] >> shift))
              break;
            atlas.setByte(int((n.pos[0] & mask) >> shiftX),
                          int((n.pos[1] & mask) >> shiftY),
                          int((n.pos[2] & mask) >> shiftZ),
                          n.siblingOccupancy);
          }
        }
      }

      int posInParent = 0;
      posInParent |= (node0.pos[0] & 1) << 2;
      posInParent |= (node0.pos[1] & 1) << 1;
      posInParent |= (node0.pos[2] & 1) << 0;
      posInParent &= codedAxesPrevLvl;

      NeighPattern gnp;
      if (useAtlas)
        gnp = makeNeighPattern(
          adjacent_child_ctx != 0, node0.pos, codedAxesPrevLvl, atlas,
          dynK);
      else
        gnp.pattern = uint8_t(neighPatternFromOccupancy(
          posInParent, node0.siblingOccupancy));

      // compensated-reference partition -> child prediction; the
      // reference performs this counting sort at the top of the node
      // (geometry_octree_decoder.cpp:1808-1861) so the predicted
      // planes can steer the planar decode below.  Under
      // bi-prediction BOTH references are partitioned and the
      // parent's predDir selects the contextualising one
      // (geometry_octree_decoder.cpp:1805-1850)
      int rcounts[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      int roffs[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      int rcounts2[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      int roffs2[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      int predOccRaw = 0;
      int predOccRaw2 = 0;
      int effPredOcc = 0;
      auto partRef = [&probe](const int32_t* refp,
                              std::vector<int32_t>& ord,
                              std::vector<int32_t>& scr,
                              int32_t rs, int32_t re, int* cnts,
                              int* offp) {
        for (int32_t p = rs; p < re; p++) {
          const int32_t* pt = &refp[ord[size_t(p)] * 3];
          int b = (!!(pt[2] & probe[2])) | (!!(pt[1] & probe[1]) << 1)
            | (!!(pt[0] & probe[0]) << 2);
          cnts[b]++;
        }
        int racc = rs;
        for (int b = 0; b < 8; b++) {
          offp[b] = racc;
          racc += cnts[b];
        }
        int w[8];
        std::memcpy(w, offp, sizeof w);
        for (int32_t p = rs; p < re; p++) {
          const int32_t* pt = &refp[ord[size_t(p)] * 3];
          int b = (!!(pt[2] & probe[2])) | (!!(pt[1] & probe[1]) << 1)
            | (!!(pt[0] & probe[0]) << 2);
          scr[size_t(w[b]++)] = ord[size_t(p)];
        }
        if (re > rs)
          std::memcpy(&ord[size_t(rs)], &scr[size_t(rs)],
                      sizeof(int32_t) * size_t(re - rs));
        int occ = 0;
        for (int b = 0; b < 8; b++)
          if (cnts[b]) occ |= 1 << b;
        return occ;
      };
      if (num_ref > 0 && node0.rend > node0.rstart)
        predOccRaw = partRef(ref_positions, rorder, rscratch,
                             node0.rstart, node0.rend, rcounts, roffs);
      if (enabledBiPred && node0.rend2 > node0.rstart2)
        predOccRaw2 = partRef(ref2_positions, rorder2, rscratch2,
                              node0.rstart2, node0.rend2, rcounts2,
                              roffs2);
      if (num_ref > 0) {
        int sel = node0.predDir ? predOccRaw2 : predOccRaw;
        if (sel && node0.mispred <= 5)
          effPredOcc = sel;
      }
      // reference planes from the (gated) predicted occupancy
      // (setPlanesFromOccupancy, geometry_octree_decoder.cpp:1870-1872)
      NodePlanar planarRef;
      if (num_ref > 0)
        planesFromOccupancy(effPredOcc, planarRef);

      // inter IDCM prediction mode; with one_point_alone it also
      // overrides the node's eligibility
      // (geometry_octree_decoder.cpp:1909-1915)
      DMode predMode = DMode::kUnavailable;
      if (ang && ang->interIdcm) {
        int nszIdcm[3] = {lvlSize[0][depth], lvlSize[1][depth],
                          lvlSize[2][depth]};
        predMode = canInterDirectPositionRef(
          *ang, node0, nszIdcm, ref_positions, rorder,
          unique_points != 0);
      }

      // planar_disabled_idcm_angular: the IDCM flag is decoded
      // BEFORE planar and suppresses it
      // (geometry_octree_decoder.cpp:1925-1932)
      bool planarEligIdcmAng = true;
      bool idcmFlagCoded = false;
      bool isDirectModeEarly = false;
      if (node0.idcmEligible && ang
          && ang->planarDisabledIdcmAngular) {
        isDirectModeEarly = aec.bit(&ctx.idcm.blockSkip) != 0;
        idcmFlagCoded = true;
        if (isDirectModeEarly)
          planarEligIdcmAng = false;
      }

      // angular planar context derivation (contextAngle -1 = off)
      int contextAngle = -1;
      int contextAnglePhiX = -1;
      int contextAnglePhiY = -1;
      if (ang && planarEligIdcmAng) {
        int nsz[3] = {lvlSize[0][depth], lvlSize[1][depth],
                      lvlSize[2][depth]};
        contextAngle = contextAngleForPlanar(
          *ang, node0.laserIndex, node0.pos, nsz, &contextAnglePhiX,
          &contextAnglePhiY);
      }

      // legacy planar rate update (only without depth eligibility)
      if (gp.planarEnabled && planarEligIdcmAng
          && !gp.depthPlanarEligibility) {
        if (!nodesBeforePlanarUpdate--) {
          planarState.updateRate(node0.siblingOccupancy,
                                 node0.numSiblingsPlus1);
          nodesBeforePlanarUpdate = node0.numSiblingsPlus1 - 1;
        }
      }

      // planar eligibility + mode decode; with angular the
      // eligibility comes from the context angles
      // (geometry_octree_decoder.cpp:1966-1986)
      NodePlanar planar;
      bool planarEligible[3] = {false, false, false};
      if (gp.planarEnabled && planarEligIdcmAng) {
        if (gp.depthPlanarEligibility) {
          if (ang) {
            if (contextAngle != -1)
              planarEligible[2] = true;
            planarEligible[0] = contextAnglePhiX != -1;
            planarEligible[1] = contextAnglePhiY != -1;
          } else if (planarEligibleKDepth) {
            planarEligible[0] = planarEligible[1] = planarEligible[2] =
              true;
          }
        } else {
          planarState.isEligible(planarEligible);
          if (ang) {
            if (contextAngle != -1)
              planarEligible[2] = true;
            planarEligible[0] = contextAnglePhiX != -1;
            planarEligible[1] = contextAnglePhiY != -1;
          }
        }
        for (int k = 0; k < 3; k++)
          planarEligible[k] =
            planarEligible[k] && ((codedAxesCurLvl >> (2 - k)) & 1);
        // inter PCM eligibility (geometry_octree_decoder.cpp:1990-1996)
        planar.allowPCM = num_ref > 0 && effPredOcc != 0
          && (planarEligible[0] || planarEligible[1]
              || planarEligible[2]);
        planar.isPreDirMatch = true;
        for (int k = 0; k < 3; k++)
          planar.eligible[k] = planarEligible[k];
        planar.lastDirIdx =
          planarEligible[2] ? 2 : (planarEligible[1] ? 1 : 0);
        if (planarEligible[0] || planarEligible[1]
            || planarEligible[2])
          determinePlanarIntraDec(
            aec, ctx, planarState, gp, dynObuf, planarEligible,
            posInParent, gnp, node0.pos, node0.siblingOccupancy,
            planar, contextAngle, contextAnglePhiX, contextAnglePhiY,
            num_ref > 0 ? &planarRef : nullptr);
      }

      // inferred direct coding (decodeDirectPosition,
      // geometry_octree_decoder.cpp:1338-1454)
      if (node0.idcmEligible) {
        bool isDirectMode = idcmFlagCoded
          ? isDirectModeEarly
          : aec.bit(&ctx.idcm.blockSkip) != 0;
        if (isDirectMode) {
          int numPts = 1 + aec.bit(&ctx.idcm.numPointsGt1);
          int numDup = 0;
          if (!unique_points && numPts == 1) {
            numDup = aec.bit(&ctx.ctxDupPointCntGt0);
            if (numDup) {
              numDup += aec.bit(&ctx.idcm.dupGt1);
              if (numDup == 2)
                numDup += int(aec.exp_golomb(0,
                                             &ctx.ctxDupPointCntEgl));
            }
          }
          int idcmSize[3] = {lvlSize[0][depth], lvlSize[1][depth],
                             lvlSize[2][depth]};
          int32_t delta[2][3] = {{0, 0, 0}, {0, 0, 0}};
          int sizeRem[3];
          for (int k = 0; k < 3; k++) {
            sizeRem[k] = idcmSize[k];
            if (sizeRem[k] > 0 && (planar.planarMode & (1 << k))) {
              int b = (planar.planePosBits & (1 << k)) ? 1 : 0;
              delta[0][k] = delta[1][k] = b;
              sizeRem[k]--;
            }
          }
          int32_t lastPos[3] = {0, 0, 0};
          if (ang) {
            // angular IDCM (decodeDirectPosition angular branch)
            int32_t nodePosS[3], posNodeLidar[3];
            for (int k = 0; k < 3; k++) {
              nodePosS[k] = node0.pos[k] << idcmSize[k];
              posNodeLidar[k] = nodePosS[k] - ang->origin[k];
            }
            const int directAxis =
              std::abs(posNodeLidar[0]) <= std::abs(posNodeLidar[1])
              ? 1 : 0;
            bool directIdcm[3] = {directAxis == 0, directAxis == 1,
                                  false};
            if (numPts == 2 && gp.jointTwoPointIdcm)
              decodeOrdered2ptPrefixDir(aec, ctx.idcm, directIdcm,
                                        sizeRem, delta);
            int32_t probe[3];
            for (int k = 0; k < 3; k++)
              probe[k] = posNodeLidar[k]
                + (delta[0][k] << sizeRem[k])
                + ((1 << sizeRem[k]) >> 1);
            int laserIdx = ang->extension
              ? angularcore::findLaserPrecise(
                  probe, ang->thetaLaser, ang->zLaser, ang->numLasers)
              : angularcore::findLaser(probe, ang->thetaLaser,
                                       ang->numLasers);
            // inter IDCM prediction set (decodeDirectPosition
            // :1370-1403)
            int numPredFramePoints =
              predMode == DMode::kAllPointSame
                ? 1 : node0.rend - node0.rstart;
            numPredFramePoints =
              numPredFramePoints < numPts ? numPredFramePoints
                                          : numPts;
            const bool canInterPred = ang->interIdcm
              && predMode != DMode::kUnavailable
              && numPredFramePoints > 0;
            for (int i = 0; i < numPts; i++) {
              int predLaserIdx = laserIdx;
              if (canInterPred) {
                int predIdx = numPredFramePoints == 2 ? i : 0;
                const int32_t* pp = &ref_positions[
                  rorder[size_t(node0.rstart + predIdx)] * 3];
                int32_t pr[3] = {pp[0] - ang->origin[0],
                                 pp[1] - ang->origin[1],
                                 pp[2] - ang->origin[2]};
                predLaserIdx = ang->extension
                  ? angularcore::findLaserPrecise(
                      pr, ang->thetaLaser, ang->zLaser,
                      ang->numLasers)
                  : angularcore::findLaser(pr, ang->thetaLaser,
                                           ang->numLasers);
              }
              decodePointPositionAngularRef(
                aec, ctx, *ang, sizeRem, nodePosS, posNodeLidar,
                laserIdx, predLaserIdx, delta[i], canInterPred);
              for (int k = 0; k < 3; k++)
                lastPos[k] = delta[i][k] + nodePosS[k];
              if (processed >= out_cap)
                return -4;
              out_pos[processed * 3 + 0] = lastPos[0];
              out_pos[processed * 3 + 1] = lastPos[1];
              out_pos[processed * 3 + 2] = lastPos[2];
              processed++;
            }
          } else {
          if (numPts == 2 && gp.jointTwoPointIdcm)
            decodeOrdered2ptPrefixIntra(aec, ctx.idcm, delta,
                                        sizeRem);
          for (int i = 0; i < numPts; i++) {
            for (int k = 0; k < 3; k++)
              for (int b = sizeRem[k]; b > 0; b--) {
                delta[i][k] <<= 1;
                delta[i][k] |= aec.bypass();
              }
            for (int k = 0; k < 3; k++)
              lastPos[k] = delta[i][k]
                + (node0.pos[k] << idcmSize[k]);
            if (processed >= out_cap)
              return -4;
            out_pos[processed * 3 + 0] = lastPos[0];
            out_pos[processed * 3 + 1] = lastPos[1];
            out_pos[processed * 3 + 2] = lastPos[2];
            processed++;
          }
          }
          for (int j = 0; j < numDup; j++) {
            if (processed >= out_cap)
              return -4;
            out_pos[processed * 3 + 0] = lastPos[0];
            out_pos[processed * 3 + 1] = lastPos[1];
            out_pos[processed * 3 + 2] = lastPos[2];
            processed++;
          }
          numPointsCodedByIdcm += numPts + numDup;
          if (adjacent_child_ctx) {
            const uint32_t cmask = (1u << atlas.cubeSizeLog2) - 1;
            atlas.setChildOcc(int(node0.pos[0] & cmask),
                              int(node0.pos[1] & cmask),
                              int(node0.pos[2] & cmask), 0);
          }
          continue;
        }
      }

      // maskPlanar: QTBT non-coded axes infer the low plane
      // (geometry_octree.cpp:541)
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

      uint32_t occupancy = decodeOccupancy(
        aec, ctx, gnp, planarMask[0], planarMask[1], planarMask[2],
        planar.planarPossible & 1, planar.planarPossible & 2,
        planar.planarPossible & 4, atlas, node0.pos, codedAxesPrevLvl,
        dynK, effPredOcc);
      if (!occupancy)
        return -3;

      if (adjacent_child_ctx) {
        const uint32_t mask = (1u << atlas.cubeSizeLog2) - 1;
        atlas.setChildOcc(int(node0.pos[0] & mask),
                          int(node0.pos[1] & mask),
                          int(node0.pos[2] & mask), uint8_t(occupancy));
      }

      int numOccupied = 0;
      for (int i = 0; i < 8; i++) numOccupied += (occupancy >> i) & 1;
      numSubnodes += numOccupied;

      // prediction-failure counts (geometry_octree_decoder.cpp:
      // 2087-2091).  The reference OVERWRITES predFailureCount with
      // the parent-selected value after the first occupied child
      // (:2169-2171) — failCur models that exactly
      int fail1 = 0;
      int fail2 = 0;
      for (int b = 0; b < 8; b++) {
        fail1 += (!!(occupancy & (1u << b)))
          != (!!(predOccRaw & (1 << b)));
        fail2 += (!!(occupancy & (1u << b)))
          != (!!(predOccRaw2 & (1 << b)));
      }
      int failCur = fail1;
      for (int i = 0; i < 8; i++) {
        if (!((occupancy >> i) & 1))
          continue;
        int x = !!(i & 4), y = !!(i & 2), z = !!(i & 1);
        int32_t cpos[3] = {
          (node0.pos[0] << !!(codedAxesCurLvl & 4)) + x,
          (node0.pos[1] << !!(codedAxesCurLvl & 2)) + y,
          (node0.pos[2] << !!(codedAxesCurLvl & 1)) + z};
        if (childIsLeaf) {
          int numPts = 1;
          if (!unique_points) {
            // decodePositionLeafNumPoints
            int v = aec.bit(&ctx.ctxDupPointCntGt0);
            if (v)
              v += int(aec.exp_golomb(0, &ctx.ctxDupPointCntEgl));
            numPts = v + 1;
          }
          for (int j = 0; j < numPts; j++) {
            if (processed >= out_cap)
              return -4;
            out_pos[processed * 3 + 0] = cpos[0];
            out_pos[processed * 3 + 1] = cpos[1];
            out_pos[processed * 3 + 2] = cpos[2];
            processed++;
          }
          continue;
        }
        Node child;
        child.pos[0] = cpos[0];
        child.pos[1] = cpos[1];
        child.pos[2] = cpos[2];
        child.rstart = roffs[i];
        child.rend = roffs[i] + rcounts[i];
        child.rstart2 = roffs2[i];
        child.rend2 = roffs2[i] + rcounts2[i];
        child.numSiblingsPlus1 = uint8_t(numOccupied);
        child.siblingOccupancy = uint8_t(occupancy);
        child.laserIndex = node0.laserIndex;
        {
          // per-child reference selection under bi-prediction
          // (geometry_octree_decoder.cpp:2158-2170)
          child.predDir = node0.predDir;
          if (enabledBiPred) {
            if (!rcounts2[i])
              child.predDir = 0;
            else if (!rcounts[i])
              child.predDir = 1;
            else if (failCur != fail2)
              child.predDir = uint8_t(failCur >= fail2);
          }
          failCur = node0.predDir ? fail2 : failCur;
          child.mispred = uint8_t(failCur);
        }
        child.idcmEligible = 0;
        {
          // isDirectModeEligible[_Inter]
          // (geometry_octree_decoder.cpp:2173-2186)
          bool elig;
          if (num_ref > 0 && !ang)
            elig = idcmEligibleInter(
              gp.idcmMode, nodeMaxDimLog2, gnp.pattern,
              node0.numSiblingsPlus1, numOccupied, effPredOcc != 0);
          else
            elig = idcmEligibleIntra(
              gp.idcmMode, nodeMaxDimLog2, gnp.pattern,
              node0.numSiblingsPlus1, numOccupied, effPredOcc != 0,
              ang != nullptr);
          if (elig) {
            elig = (idcmEnableMask & 1) != 0;
            idcmEnableMask = rotr32(idcmEnableMask, 1);
          }
          child.idcmEligible = uint8_t(elig);
        }
        fifo.push_back(child);
      }
    }
    if (checkPlanarDepthEligibility)
      planarEligibleKDepth =
        (long(num_points) - numPointsCodedByIdcm) * 10
        < numSubnodes * 13;
  }

  if (ts_leaves) {
    // trisoup bridge: export leaf-node origins at full resolution
    // (decodeGeometryOctree nodesRemaining path,
    // geometry_octree_decoder.cpp:2211-2218) and the live arithmetic
    // decoder for the vertex/centroid/face phases
    int rem[3] = {lvlSize[0][maxDepth], lvlSize[1][maxDepth],
                  lvlSize[2][maxDepth]};
    ts_leaves->reserve((fifo.size() - head) * 3);
    for (size_t it = head; it < fifo.size(); ++it) {
      const Node& nd = fifo[it];
      for (int k = 0; k < 3; ++k)
        ts_leaves->push_back(nd.pos[k] << rem[k]);
    }
    if (ts_coder) {
      TsCoderHandle* h = new TsCoderHandle();
      h->dec = aec;
      h->isEnc = false;
      *ts_coder = h;
    }
    return int(fifo.size() - head);
  }

  if (skipc > 0) {
    // scalable truncation: emit node centres at the stop level,
    // scaled to full resolution (reference
    // decodeGeometryOctreeScalable, geometry_octree_decoder.cpp:2244)
    int rem[3] = {lvlSize[0][maxDepth], lvlSize[1][maxDepth],
                  lvlSize[2][maxDepth]};
    for (size_t it = head; it < fifo.size(); ++it) {
      if (processed >= out_cap)
        return -(int)(processed + (fifo.size() - it));
      const Node& nd = fifo[it];
      for (int k = 0; k < 3; ++k) {
        int32_t v = nd.pos[k] << rem[k];
        if (rem[k] > 0) v |= int32_t(1) << (rem[k] - 1);
        out_pos[processed * 3 + k] = v;
      }
      processed++;
    }
  }

  return processed;
}

// ---------------------------------------------------------------------------
// public entries.  The *_intra names keep the original ABI; the
// *_inter variants add a motion-compensated reference cloud whose
// per-node child occupancy selects the OBUF map bank per occupancy
// bit (reference interCtx = bitPred, geometry_octree_encoder.cpp:884,
// with the occupancyIsPredictable gate :2287).  With no reference the
// inter entries reduce to the intra behaviour bit-for-bit.
// ---------------------------------------------------------------------------

extern "C" int tmc13ref_encode_octree_intra(
  const int32_t* positions, int num_points,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr, uint8_t* out_buf, int out_cap) {
  return encode_octree_impl(positions, num_points, nullptr, 0,
                            coded_axis_list, num_levels, gp_arr,
                            out_buf, out_cap);
}

// trisoup brick, phase 1 (encode): code the node octree down to the
// trisoup node size; fills out_leaves with (x, y, z, start, end)
// 5-tuples per leaf (full-resolution origins, point ranges into the
// permutation written to out_order, length num_points) and hands the
// live arithmetic encoder to tsref_open.  Returns the leaf count.
extern "C" int tmc13ref_encode_octree_trisoup(
  const int32_t* positions, int num_points,
  const int32_t* coded_axis_list, int num_levels,
  int ts_node_size_log2, const int32_t* gp_arr,
  int32_t* out_leaves, int leaves_cap, int32_t* out_order,
  void** coder_out) {
  std::vector<int32_t> leaves;
  std::vector<int32_t> order;
  void* coder = nullptr;
  int n = encode_octree_impl(positions, num_points, nullptr, 0,
                             coded_axis_list, num_levels, gp_arr,
                             nullptr, 0,
                             ts_node_size_log2, &leaves, &order, &coder);
  if (n < 0)
    return n;
  if (n > leaves_cap) {
    delete static_cast<TsCoderHandle*>(coder);
    return -5;
  }
  std::memcpy(out_leaves, leaves.data(), leaves.size() * sizeof(int32_t));
  std::memcpy(out_order, order.data(), order.size() * sizeof(int32_t));
  *coder_out = coder;
  return n;
}

extern "C" int tmc13ref_encode_octree_inter(
  const int32_t* positions, int num_points,
  const int32_t* ref_positions, int num_ref,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr, uint8_t* out_buf, int out_cap) {
  return encode_octree_impl(positions, num_points, ref_positions,
                            num_ref, coded_axis_list, num_levels,
                            gp_arr, out_buf, out_cap);
}

extern "C" int tmc13ref_decode_octree_intra(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels, int num_points,
  const int32_t* gp_arr, int32_t* out_pos, int out_cap) {
  return decode_octree_impl(aec_buf, aec_len, coded_axis_list,
                            num_levels, num_points, nullptr, 0,
                            gp_arr, out_pos, out_cap);
}

extern "C" int tmc13ref_decode_octree_inter(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels, int num_points,
  const int32_t* ref_positions, int num_ref,
  const int32_t* gp_arr, int32_t* out_pos, int out_cap) {
  return decode_octree_impl(aec_buf, aec_len, coded_axis_list,
                            num_levels, num_points, ref_positions,
                            num_ref, gp_arr, out_pos, out_cap);
}

// bi-prediction (gbh.biPredictionEnabledFlag): B-frame octree brick
// coded against TWO compensated references with per-node direction
// selection (geometry_octree_encoder.cpp:1893-1920, 2156-2176,
// 2562-2576; decoder mirror geometry_octree_decoder.cpp:1599-1604,
// 1805-1850, 2158-2170)
extern "C" int tmc13ref_encode_octree_bipred(
  const int32_t* positions, int num_points,
  const int32_t* ref_positions, int num_ref,
  const int32_t* ref2_positions, int num_ref2,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr, uint8_t* out_buf, int out_cap) {
  return encode_octree_impl(positions, num_points, ref_positions,
                            num_ref, coded_axis_list, num_levels,
                            gp_arr, out_buf, out_cap, 0, nullptr,
                            nullptr, nullptr, 0, nullptr, nullptr,
                            ref2_positions, num_ref2);
}

extern "C" int tmc13ref_decode_octree_bipred(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels, int num_points,
  const int32_t* ref_positions, int num_ref,
  const int32_t* ref2_positions, int num_ref2,
  const int32_t* gp_arr, int32_t* out_pos, int out_cap) {
  return decode_octree_impl(aec_buf, aec_len, coded_axis_list,
                            num_levels, num_points, ref_positions,
                            num_ref, gp_arr, out_pos, out_cap, 0, 0,
                            0, nullptr, nullptr, 0, nullptr, nullptr,
                            ref2_positions, num_ref2);
}

// exact LUT-based divApprox defined in refpredgeom.cc (same .so)
extern "C" int64_t tmc13_div_approx(int64_t a, uint64_t b,
                                    int32_t log2Scale);

// spherical attribute coordinates (aps.spherical_coord_flag): the
// reference converts the decoded slice-local positions to
// (radius, azimuth, laser) before attribute coding
// (convertXyzToRpl, coordinate_conversion.cpp:45-69).  Returns the
// converted positions; min/out give the pre-scale bbox minimum.
extern "C" void tmc13ref_xyz_to_rpl(
  const int32_t* positions, int n,
  const int32_t* laser_origin,
  const int32_t* theta_laser, int num_lasers,
  int32_t* out_rpl, int32_t* out_min) {
  out_min[0] = out_min[1] = out_min[2] = INT32_MAX;
  for (int i = 0; i < n; i++) {
    int32_t pos[3] = {positions[i * 3 + 0] - laser_origin[0],
                      positions[i * 3 + 1] - laser_origin[1],
                      positions[i * 3 + 2] - laser_origin[2]};
    int laser = angularcore::findLaser(pos, theta_laser, num_lasers);
    int64_t xL = int64_t(pos[0]) << 8;
    int64_t yL = int64_t(pos[1]) << 8;
    int32_t r = int32_t(
      angularcore::isqrt(uint64_t(xL * xL + yL * yL)) >> 8);
    int32_t phi = int32_t(
      (angularcore::iatan2(int(yL), int(xL)) + 3294199) >> 8);
    out_rpl[i * 3 + 0] = r;
    out_rpl[i * 3 + 1] = phi;
    out_rpl[i * 3 + 2] = laser;
    for (int k = 0; k < 3; k++)
      if (out_rpl[i * 3 + k] < out_min[k])
        out_min[k] = out_rpl[i * 3 + k];
  }
}

// z-coordinate compensation (geom_z_compensation_enabled_flag): the
// lidar ground-height revision applied to the decoded cloud at
// output (compensateZCoordinate, geometry_octree.cpp:781-850).
// positions are slice-accumulated STV ints; num/den is the ply scale
// fraction (decoder.cpp compensateZ: 1000/seqGeomScale, reduced).
extern "C" void tmc13ref_compensate_z(
  int32_t* positions, int n, int num, int den,
  const int32_t* angular_origin,
  const int32_t* theta_laser, const int32_t* z_laser,
  int num_lasers) {
  auto divApprox = [](int64_t a, uint64_t b, int32_t log2Scale)
    -> int64_t {
    return tmc13_div_approx(a, b, log2Scale);
  };
  int minDelta = INT32_MAX;
  for (int i = 1; i < num_lasers; i++)
    minDelta = std::min(
      minDelta, std::abs(theta_laser[i] - theta_laser[i - 1]));
  minDelta >>= 1;
  for (int i = 0; i < n; i++) {
    int64_t pos[3];
    for (int j = 0; j < 3; j++) {
      if (den == 1)
        pos[j] = int64_t(positions[i * 3 + j] - angular_origin[j])
          * num;
      else
        pos[j] = divApprox(
          int64_t(positions[i * 3 + j] - angular_origin[j]) * num,
          uint64_t(den), 0);
    }
    int64_t r2 = pos[0] * pos[0] + pos[1] * pos[1];
    int64_t r3 = angularcore::isqrt(
      uint64_t(r2 + pos[2] * pos[2]));
    int64_t r = angularcore::isqrt(uint64_t(r2));
    int theta32 = int((pos[2] * int64_t(angularcore::irsqrt(
      uint64_t(r2)))) >> 22);
    // upper_bound over [theta+1, theta+numLasers-1)
    const int32_t* end = theta_laser + num_lasers - 1;
    const int32_t* it = std::upper_bound(
      theta_laser + 1, end, theta32);
    if (theta32 - *(it - 1) <= *it - theta32)
      --it;
    int laserIndex = int(it - theta_laser);
    int64_t zL = den == 1
      ? int64_t(z_laser[laserIndex]) * num
      : divApprox(int64_t(z_laser[laserIndex]) * num,
                  uint64_t(den), 0);
    int64_t zC =
      ((r * theta_laser[laserIndex] - (zL << 15)) + (1 << 17)) >> 18;
    bool c1 = ((r3 * minDelta * den + (1 << 17)) >> 18) > num;
    bool c2 = std::llabs(pos[2] - zC) * den < num;
    if (c1 && c2)
      pos[2] = zC;
    for (int j = 0; j < 3; j++) {
      if (den == 1)
        positions[i * 3 + j] =
          int32_t(pos[j] + int64_t(angular_origin[j]) * num);
      else
        positions[i * 3 + j] = int32_t(
          pos[j] + divApprox(int64_t(angular_origin[j]) * num,
                             uint64_t(den), 0));
    }
  }
}

// cuboid-partition GM variants (gbh.lpu_type == 1): the caller hands
// the previous frame twice — untouched ("vehicle") and with the Q16
// global motion applied ("world"), both in slice-GLOBAL coordinates;
// the per-LPU selection flags ride the brick's arithmetic stream
extern "C" int tmc13ref_decode_octree_inter_gm(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels, int num_points,
  const int32_t* ref_vehicle, const int32_t* ref_world, int num_ref,
  const int32_t* motion_block_size, const int32_t* box_origin,
  const int32_t* gp_arr, int32_t* out_pos, int out_cap) {
  CuboidGm gm;
  gm.vehicle = ref_vehicle;
  gm.world = ref_world;
  gm.num = num_ref;
  for (int k = 0; k < 3; k++) {
    gm.mbs[k] = motion_block_size[k];
    gm.boxOrigin[k] = box_origin[k];
  }
  return decode_octree_impl(aec_buf, aec_len, coded_axis_list,
                            num_levels, num_points, nullptr, 0,
                            gp_arr, out_pos, out_cap, 0, 0, 0,
                            nullptr, nullptr, 0, nullptr, &gm);
}

extern "C" int tmc13ref_encode_octree_inter_gm(
  const int32_t* positions, int num_points,   // slice-local STV
  const int32_t* ref_vehicle, const int32_t* ref_world, int num_ref,
  const int32_t* motion_block_size, const int32_t* box_origin,
  int window_size,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr, uint8_t* out_buf, int out_cap) {
  CuboidGm gm;
  gm.vehicle = ref_vehicle;
  gm.world = ref_world;
  gm.num = num_ref;
  gm.windowSize = window_size;
  for (int k = 0; k < 3; k++) {
    gm.mbs[k] = motion_block_size[k];
    gm.boxOrigin[k] = box_origin[k];
  }
  // the block-selection cost compares against the current cloud in
  // slice-GLOBAL coordinates (encodeCuboidGlobalMotion operates
  // before the origin shift)
  std::vector<int32_t> curGlobal(size_t(num_points) * 3);
  for (int i = 0; i < num_points; i++)
    for (int k = 0; k < 3; k++)
      curGlobal[size_t(i) * 3 + size_t(k)] =
        positions[i * 3 + k] + box_origin[k];
  gm.cur = curGlobal.data();
  gm.numCur = num_points;
  return encode_octree_impl(positions, num_points, nullptr, 0,
                            coded_axis_list, num_levels, gp_arr,
                            out_buf, out_cap, 0, nullptr, nullptr,
                            nullptr, 0, nullptr, &gm);
}

// trisoup brick, phase 1: decode the node octree down to the trisoup
// node size; returns leaf count, fills out_leaves (x,y,z triplets,
// full resolution) and hands the live arithmetic decoder to
// tsref_open (trisoup_ref.cc).  The aec buffer must stay alive until
// tsref_close.
extern "C" int tmc13ref_decode_octree_trisoup(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels, int num_points,
  int ts_node_size_log2,
  const int32_t* gp_arr, int32_t* out_leaves, int leaves_cap,
  void** coder_out) {
  std::vector<int32_t> leaves;
  // the reference sizes the trisoup node fifo at a fixed 1.1M
  // (geometry_octree_decoder.cpp:1587-1588) and that constant feeds
  // the planar depth-eligibility formula (:2192), so the actual point
  // count must not be used there
  const int kRingBufferSize = 1100000;
  (void)num_points;
  // IDCM may legally fire during the octree phase of a trisoup brick;
  // the reference decodes those points and then discards them when the
  // reconstructed surface replaces the cloud (decodeGeometryTrisoup
  // :199-200).  Scratch space absorbs them here.
  std::vector<int32_t> idcm_scratch(size_t(kRingBufferSize) * 3);
  void* coder = nullptr;
  int n = decode_octree_impl(aec_buf, aec_len, coded_axis_list,
                             num_levels, kRingBufferSize, nullptr, 0,
                             gp_arr, idcm_scratch.data(),
                             kRingBufferSize, 0, 0,
                             ts_node_size_log2, &leaves, &coder);
  if (n < 0)
    return n;
  if (n > leaves_cap) {
    delete static_cast<TsCoderHandle*>(coder);
    return -5;
  }
  std::memcpy(out_leaves, leaves.data(),
              leaves.size() * sizeof(int32_t));
  *coder_out = coder;
  return n;
}

// angular octree mode (geom_angular_mode_enabled_flag): intra, IDCM
// off.  ang_origin is slice-local (gbh.geomAngularOrigin); laser
// tables are the decoded GPS arrays.
extern "C" int tmc13ref_decode_octree_intra_ang(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels, int num_points,
  const int32_t* gp_arr,
  const int32_t* ang_origin, int num_lasers,
  const int32_t* theta_laser, const int32_t* z_laser,
  const int32_t* num_phi, int ang_flags,
  int32_t* out_pos, int out_cap) {
  AngParams ang;
  ang.init(ang_origin, num_lasers, theta_laser, z_laser, num_phi);
  ang.extension = (ang_flags & 1) != 0;
  ang.planarDisabledIdcmAngular = (ang_flags & 2) != 0;
  ang.interIdcm = (ang_flags & 4) != 0;
  ang.onePointAlone = (ang_flags & 8) != 0;
  return decode_octree_impl(aec_buf, aec_len, coded_axis_list,
                            num_levels, num_points, nullptr, 0,
                            gp_arr, out_pos, out_cap, 0, 0, 0,
                            nullptr, nullptr, 0, &ang);
}

// angular octree inter: compensated predictor + laser tables; with
// motion_block_size non-null the cuboid LPU flags lead the stream
extern "C" int tmc13ref_decode_octree_inter_ang(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels, int num_points,
  const int32_t* ref_vehicle, const int32_t* ref_world, int num_ref,
  const int32_t* motion_block_size, const int32_t* box_origin,
  const int32_t* gp_arr,
  const int32_t* ang_origin, int num_lasers,
  const int32_t* theta_laser, const int32_t* z_laser,
  const int32_t* num_phi, int ang_flags,
  int32_t* out_pos, int out_cap) {
  AngParams ang;
  ang.init(ang_origin, num_lasers, theta_laser, z_laser, num_phi);
  ang.extension = (ang_flags & 1) != 0;
  ang.planarDisabledIdcmAngular = (ang_flags & 2) != 0;
  ang.interIdcm = (ang_flags & 4) != 0;
  ang.onePointAlone = (ang_flags & 8) != 0;
  if (motion_block_size) {
    CuboidGm gm;
    gm.vehicle = ref_vehicle;
    gm.world = ref_world;
    gm.num = num_ref;
    for (int k = 0; k < 3; k++) {
      gm.mbs[k] = motion_block_size[k];
      gm.boxOrigin[k] = box_origin[k];
    }
    return decode_octree_impl(aec_buf, aec_len, coded_axis_list,
                              num_levels, num_points, nullptr, 0,
                              gp_arr, out_pos, out_cap, 0, 0, 0,
                              nullptr, nullptr, 0, &ang, &gm);
  }
  return decode_octree_impl(aec_buf, aec_len, coded_axis_list,
                            num_levels, num_points, ref_vehicle,
                            num_ref, gp_arr, out_pos, out_cap, 0, 0,
                            0, nullptr, nullptr, 0, &ang);
}

extern "C" int tmc13ref_encode_octree_inter_ang(
  const int32_t* positions, int num_points,
  const int32_t* ref_vehicle, const int32_t* ref_world, int num_ref,
  const int32_t* motion_block_size, const int32_t* box_origin,
  int window_size,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr,
  const int32_t* ang_origin, int num_lasers,
  const int32_t* theta_laser, const int32_t* z_laser,
  const int32_t* num_phi, int ang_flags,
  uint8_t* out_buf, int out_cap) {
  AngParams ang;
  ang.init(ang_origin, num_lasers, theta_laser, z_laser, num_phi);
  ang.extension = (ang_flags & 1) != 0;
  ang.planarDisabledIdcmAngular = (ang_flags & 2) != 0;
  ang.interIdcm = (ang_flags & 4) != 0;
  ang.onePointAlone = (ang_flags & 8) != 0;
  if (motion_block_size) {
    CuboidGm gm;
    gm.vehicle = ref_vehicle;
    gm.world = ref_world;
    gm.num = num_ref;
    gm.windowSize = window_size;
    for (int k = 0; k < 3; k++) {
      gm.mbs[k] = motion_block_size[k];
      gm.boxOrigin[k] = box_origin[k];
    }
    std::vector<int32_t> curGlobal(size_t(num_points) * 3);
    for (int i = 0; i < num_points; i++)
      for (int k = 0; k < 3; k++)
        curGlobal[size_t(i) * 3 + size_t(k)] =
          positions[i * 3 + k] + box_origin[k];
    gm.cur = curGlobal.data();
    gm.numCur = num_points;
    return encode_octree_impl(positions, num_points, nullptr, 0,
                              coded_axis_list, num_levels, gp_arr,
                              out_buf, out_cap, 0, nullptr, nullptr,
                              nullptr, 0, &ang, &gm);
  }
  return encode_octree_impl(positions, num_points, ref_vehicle,
                            num_ref, coded_axis_list, num_levels,
                            gp_arr, out_buf, out_cap, 0, nullptr,
                            nullptr, nullptr, 0, &ang);
}

extern "C" int tmc13ref_encode_octree_intra_ang(
  const int32_t* positions, int num_points,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr,
  const int32_t* ang_origin, int num_lasers,
  const int32_t* theta_laser, const int32_t* z_laser,
  const int32_t* num_phi, int ang_flags,
  uint8_t* out_buf, int out_cap) {
  AngParams ang;
  ang.init(ang_origin, num_lasers, theta_laser, z_laser, num_phi);
  ang.extension = (ang_flags & 1) != 0;
  ang.planarDisabledIdcmAngular = (ang_flags & 2) != 0;
  ang.interIdcm = (ang_flags & 4) != 0;
  ang.onePointAlone = (ang_flags & 8) != 0;
  return encode_octree_impl(positions, num_points, nullptr, 0,
                            coded_axis_list, num_levels, gp_arr,
                            out_buf, out_cap, 0, nullptr, nullptr,
                            nullptr, 0, &ang);
}

// multi-stream brick decode (gbh.geom_stream_cnt_minus1 > 0): the
// last cnt levels live in back-to-back sub-streams, each decoded from
// the context state saved before level maxDepth-1-cnt
extern "C" int tmc13ref_decode_octree_intra_ms(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels, int num_points,
  const int32_t* gp_arr, int32_t* out_pos, int out_cap,
  int stream_cnt_minus1) {
  return decode_octree_impl(aec_buf, aec_len, coded_axis_list,
                            num_levels, num_points, nullptr, 0,
                            gp_arr, out_pos, out_cap, 0, 0, 0,
                            nullptr, nullptr, stream_cnt_minus1);
}

extern "C" int tmc13ref_encode_octree_intra_ms(
  const int32_t* positions, int num_points,
  const int32_t* coded_axis_list, int num_levels,
  const int32_t* gp_arr, uint8_t* out_buf, int out_cap,
  int stream_cnt_minus1) {
  return encode_octree_impl(positions, num_points, nullptr, 0,
                            coded_axis_list, num_levels, gp_arr,
                            out_buf, out_cap, 0, nullptr, nullptr,
                            nullptr, stream_cnt_minus1);
}

extern "C" int tmc13ref_decode_octree_scalable(
  const uint8_t* aec_buf, int aec_len,
  const int32_t* coded_axis_list, int num_levels, int num_points,
  int skip_levels, int max_nodes_stop,
  const int32_t* ref_positions, int num_ref,
  const int32_t* gp_arr, int32_t* out_pos, int out_cap) {
  return decode_octree_impl(aec_buf, aec_len, coded_axis_list,
                            num_levels, num_points, ref_positions,
                            num_ref, gp_arr, out_pos, out_cap,
                            skip_levels, max_nodes_stop);
}
