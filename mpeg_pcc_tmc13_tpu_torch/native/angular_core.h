// Angular (LiDAR) octree tool support for the conformance engine.
//
// Integer math + context derivation for the reference's angular octree
// coding mode (geom_angular_mode_enabled_flag): fixed-point inverse
// square root and arc tangent (tmc3/misc.cpp:142-310),
// the per-laser azimuthal steps (AzimuthalPhiZi,
// tmc3/PCCPointSet.h:638-657) and the planar context
// angle derivation (determineContextAngleForPlanar,
// tmc3/geometry_octree.cpp:682-800).  The LUTs are
// normative constants of the spec (identical by necessity, like the
// dirac adaptation table); the control flow is restructured for the
// no-in-tree-scaling scope of this engine (node.qp == 0).

#ifndef ANGULAR_CORE_H_
#define ANGULAR_CORE_H_

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace angularcore {

// fixed-point inverse square root (misc.cpp:191-225)
static const uint64_t kA3timesR[96] = {
  3196059648ull, 3145728000ull, 3107979264ull, 3057647616ull, 3019898880ull, 2969567232ull,
  2931818496ull, 2894069760ull, 2868903936ull, 2831155200ull, 2793406464ull, 2768240640ull,
  2730491904ull, 2705326080ull, 2667577344ull, 2642411520ull, 2617245696ull, 2592079872ull,
  2566914048ull, 2541748224ull, 2516582400ull, 2491416576ull, 2466250752ull, 2441084928ull,
  2428502016ull, 2403336192ull, 2378170368ull, 2365587456ull, 2340421632ull, 2327838720ull,
  2302672896ull, 2290089984ull, 2264924160ull, 2252341248ull, 2239758336ull, 2214592512ull,
  2202009600ull, 2189426688ull, 2164260864ull, 2151677952ull, 2139095040ull, 2126512128ull,
  2113929216ull, 2101346304ull, 2088763392ull, 2076180480ull, 2051014656ull, 2038431744ull,
  2025848832ull, 2013265920ull, 2000683008ull, 2000683008ull, 1988100096ull, 1962934272ull,
  1962934272ull, 1950351360ull, 1937768448ull, 1925185536ull, 1912602624ull, 1900019712ull,
  1900019712ull, 1887436800ull, 1874853888ull, 1862270976ull, 1849688064ull, 1849688064ull,
  1837105152ull, 1824522240ull, 1811939328ull, 1811939328ull, 1799356416ull, 1786773504ull,
  1786773504ull, 1774190592ull, 1761607680ull, 1761607680ull, 1749024768ull, 1736441856ull,
  1736441856ull, 1723858944ull, 1723858944ull, 1711276032ull, 1698693120ull, 1698693120ull,
  1686110208ull, 1686110208ull, 1673527296ull, 1660944384ull, 1660944384ull, 1648361472ull,
  1648361472ull, 1635778560ull, 1635778560ull, 1623195648ull, 1623195648ull, 1610612736ull,
};
static const uint64_t kARcubed[96] = {
  4195081216ull, 3999986688ull, 3857709056ull, 3673323520ull, 3538940928ull, 3364924416ull,
  3238224896ull, 3114735616ull, 3034196992ull, 2915990528ull, 2800922624ull, 2725880832ull,
  2615890944ull, 2544223232ull, 2439185408ull, 2370818048ull, 2303728640ull, 2237913088ull,
  2173355008ull, 2110061568ull, 2048008192ull, 1987165184ull, 1927563264ull, 1869150208ull,
  1840392192ull, 1783783424ull, 1728321536ull, 1701024768ull, 1647311872ull, 1620883456ull,
  1568898048ull, 1543306240ull, 1492993024ull, 1468236800ull, 1443762176ull, 1395656704ull,
  1372007424ull, 1348605952ull, 1302626304ull, 1280060416ull, 1257736192ull, 1235650560ull,
  1213861888ull, 1192294400ull, 1171008512ull, 1149979648ull, 1108673536ull, 1088379904ull,
  1068352512ull, 1048567808ull, 1029031936ull, 1029036032ull, 1009729536ull, 971888640ull,
  971882496ull, 953319424ull, 934993920ull, 916897792ull, 899011584ull, 881389568ull,
  881392640ull, 864009216ull, 846846976ull, 829900800ull, 813182976ull, 813201408ull,
  796721152ull, 780459008ull, 764412928ull, 764417024ull, 748601344ull, 732995584ull,
  733017088ull, 717624320ull, 702468096ull, 702466048ull, 687520768ull, 672786432ull,
  672787456ull, 658258944ull, 658256896ull, 643947520ull, 629854208ull, 629862400ull,
  615976960ull, 615952384ull, 602276864ull, 588779520ull, 588804096ull, 575512576ull,
  575526912ull, 562433024ull, 562439168ull, 549556224ull, 549564416ull, 536876032ull,
};

static inline uint64_t irsqrt(uint64_t a64) {
  if (!a64)
    return 0;
  int shift = -3;
  while (a64 & 0xffffffff00000000ull) {
    a64 >>= 2;
    shift--;
  }
  uint32_t a = uint32_t(a64);
  while (!(a & 0xc0000000u)) {
    a <<= 2;
    shift++;
  }
  int idx = int(a >> 25) - 32;
  uint64_t r = kA3timesR[idx] - ((kARcubed[idx] * a) >> 32);
  uint64_t ar = (r * a) >> 32;
  uint64_t s = 0x30000000 - ((r * ar) >> 32);
  r = (r * s) >> 32;
  return shift > 0 ? r << shift : r >> -shift;
}

// fixed-point arc tangent, 20-bit angle precision (misc.cpp:230-310)
static const int kAAsin[364] = {
  0, 2048, 4096, 6144, 8192, 10240, 12288, 14336,
  16385, 18433, 20481, 22530, 24578, 26627, 28676, 30724,
  32773, 34822, 36872, 38921, 40970, 43020, 45070, 47120,
  49170, 51220, 53271, 55322, 57373, 59424, 61475, 63527,
  65579, 67631, 69683, 71736, 73789, 75842, 77896, 79949,
  82004, 84058, 86113, 88168, 90223, 92279, 94335, 96392,
  98449, 100506, 102563, 104621, 106680, 108739, 110798, 112858,
  114918, 116978, 119040, 121101, 123163, 125225, 127288, 129352,
  131416, 133480, 135545, 137611, 139677, 141743, 143810, 145878,
  147946, 150015, 152085, 154155, 156225, 158297, 160368, 162441,
  164514, 166588, 168662, 170737, 172813, 174890, 176967, 179045,
  181123, 183203, 185283, 187363, 189445, 191527, 193610, 195694,
  197779, 199864, 201950, 204037, 206125, 208214, 210303, 212393,
  214485, 216577, 218669, 220763, 222858, 224954, 227050, 229148,
  231246, 233345, 235445, 237547, 239649, 241752, 243856, 245961,
  248068, 250175, 252283, 254392, 256502, 258614, 260726, 262840,
  264954, 267070, 269187, 271305, 273424, 275544, 277666, 279788,
  281912, 284037, 286163, 288290, 290419, 292549, 294680, 296812,
  298945, 301080, 303216, 305354, 307492, 309632, 311773, 313916,
  316060, 318206, 320352, 322500, 324650, 326801, 328953, 331107,
  333262, 335419, 337577, 339737, 341898, 344061, 346225, 348391,
  350558, 352727, 354897, 357069, 359243, 361418, 363595, 365773,
  367953, 370135, 372318, 374503, 376690, 378879, 381069, 383261,
  385455, 387650, 389847, 392046, 394247, 396450, 398655, 400861,
  403069, 405279, 407491, 409705, 411921, 414139, 416359, 418581,
  420804, 423030, 425258, 427488, 429720, 431954, 434190, 436428,
  438668, 440910, 443155, 445401, 447650, 449901, 452155, 454410,
  456668, 458928, 461190, 463455, 465722, 467991, 470262, 472536,
  474813, 477091, 479373, 481656, 483942, 486231, 488522, 490815,
  493111, 495410, 497711, 500015, 502322, 504631, 506943, 509257,
  511574, 513894, 516217, 518542, 520870, 523201, 525535, 527872,
  530211, 532553, 534899, 537247, 539598, 541952, 544310, 546670,
  549033, 551399, 553769, 556142, 558517, 560896, 563278, 565664,
  568052, 570444, 572839, 575238, 577640, 580045, 582454, 584866,
  587282, 589701, 592123, 594549, 596979, 599412, 601849, 604290,
  606734, 609183, 611634, 614090, 616549, 619013, 621480, 623951,
  626426, 628905, 631388, 633875, 636366, 638862, 641361, 643865,
  646373, 648885, 651401, 653922, 656447, 658976, 661510, 664049,
  666592, 669139, 671691, 674248, 676809, 679375, 681946, 684522,
  687103, 689688, 692278, 694874, 697474, 700080, 702690, 705306,
  707927, 710553, 713184, 715821, 718463, 721111, 723764, 726423,
  729087, 731757, 734433, 737115, 739802, 742495, 745194, 747899,
  750611, 753328, 756051, 758781, 761517, 764259, 767008, 769763,
  772525, 775294, 778069, 780850, 783639, 786435, 789237, 792047,
  794863, 797687, 800518, 803357, 806202, 809056, 811917, 814785,
  817662, 820546, 823438, 823438,
};

static inline int iatan2Core(int y, int x) {
  if (x == 0)
    return 0;
  uint64_t rinv =
    irsqrt(uint64_t(x) * uint64_t(x) + uint64_t(y) * uint64_t(y));
  int r = int((y * rinv) >> 20);
  int idx = r >> 11;
  int lambda = r - (idx << 11);
  return kAAsin[idx] + ((lambda * (kAAsin[idx + 1] - kAAsin[idx])) >> 11);
}

static inline int iatan2(int y, int x) {
  int xa = std::abs(x);
  int ya = std::abs(y);
  int t = ya <= xa ? iatan2Core(ya, xa) : 1647099 - iatan2Core(xa, ya);
  if (x < 0)
    t = 3294199 - t;
  return y < 0 ? -t : t;
}

// fixed-point square root (misc.cpp:139-147)
static inline uint32_t isqrt(uint64_t x) {
  if (x <= (uint64_t(1) << 46))
    return uint32_t(1 + ((x * irsqrt(x)) >> 40));
  uint64_t x0 = (x + 65536) >> 16;
  return uint32_t(1 + ((x0 * irsqrt(x0)) >> 32));
}

// integer divide by 2^shift rounding half away from zero
// (PCCMath.h:665)
static inline int64_t divExp2RoundHalfInf(int64_t scalar, int shift) {
  if (!shift)
    return scalar;
  int64_t s0 = int64_t(1) << (shift - 1);
  return scalar >= 0 ? (s0 + scalar) >> shift : -((s0 - scalar) >> shift);
}

// laser search (geometry_octree.cpp:856 findLaser;
// PCCPointSet.h:606 findLaserPrecise)
static inline int findLaser(const int32_t point[3],
                            const int32_t* thetaList, int numTheta) {
  if (numTheta == 1)
    return 0;
  int64_t xLidar = int64_t(point[0]) << 8;
  int64_t yLidar = int64_t(point[1]) << 8;
  int64_t rInv =
    int64_t(irsqrt(uint64_t(xLidar * xLidar + yLidar * yLidar)));
  int theta32 = int((point[2] * rInv) >> 14);
  const int32_t* end = thetaList + numTheta - 1;
  const int32_t* it = std::upper_bound(thetaList + 1, end, theta32);
  if (theta32 - *(it - 1) <= *it - theta32)
    --it;
  return int(it - thetaList);
}

static inline int findLaserPrecise(const int32_t point[3],
                                   const int32_t* thetaList,
                                   const int32_t* zList, int numTheta) {
  if (numTheta == 1)
    return 0;
  int64_t xLidar = int64_t(point[0]) << 8;
  int64_t yLidar = int64_t(point[1]) << 8;
  int64_t rInv =
    int64_t(irsqrt(uint64_t(xLidar * xLidar + yLidar * yLidar)));
  int lBest = 0;
  int dBest = INT32_MAX;
  for (int l = 0; l < numTheta; l++) {
    int64_t zS3 = (int64_t(point[2]) << 3) + zList[l];
    int theta32 = int(zS3 >= 0 ? (zS3 * rInv) >> (14 + 3)
                               : -((-zS3 * rInv) >> (14 + 3)));
    int d = std::abs(theta32 - thetaList[l]);
    if (d < dBest) {
      dBest = d;
      lBest = l;
    }
  }
  return lBest;
}

// IDCM azimuthal context index (geometry_octree.h:830)
static inline int ctxIndexForAngularPhiIdcm(int deltaPhi,
                                            int phiLRDiff) {
  return int(3 * deltaPhi < (phiLRDiff << 2))
    + int(deltaPhi < (phiLRDiff << 1));
}

// per-laser azimuthal steps (AzimuthalPhiZi)
struct PhiZi {
  std::vector<int> delta;
  std::vector<int64_t> invDelta;
  void init(int numLasers, const int32_t* numPhi) {
    delta.resize(size_t(numLasers));
    invDelta.resize(size_t(numLasers));
    for (int i = 0; i < numLasers; i++) {
      const int k2pi = 6588397;  // 2**20 * 2 * pi
      delta[size_t(i)] = k2pi / numPhi[i];
      invDelta[size_t(i)] =
        int64_t((int64_t(numPhi[i]) << 30) / k2pi);
    }
  }
};

// angular tool configuration for one brick (slice-local origin)
struct AngParams {
  bool enabled = false;
  bool extension = true;     // gps.octree_angular_extension_flag
  bool planarDisabledIdcmAngular = false;
  bool interIdcm = false;    // gps.geom_inter_idcm_enabled_flag
  bool onePointAlone = false;  // gps.one_point_alone_laser_beam_flag
  int32_t origin[3] = {0, 0, 0};
  int numLasers = 0;
  const int32_t* thetaLaser = nullptr;
  const int32_t* zLaser = nullptr;
  PhiZi phiZi;
  int deltaAngle = 128 << 18;
  std::vector<int> phiBuffer;
  std::vector<int> prevThetaRes;   // _prevLaserIndexResidual
  std::vector<int> prevThetaResInter;  // _prevLaserInterIndexResidual

  void init(const int32_t* origin3, int nl, const int32_t* theta,
            const int32_t* z, const int32_t* nphi) {
    enabled = true;
    origin[0] = origin3[0];
    origin[1] = origin3[1];
    origin[2] = origin3[2];
    numLasers = nl;
    thetaLaser = theta;
    zLaser = z;
    phiZi.init(nl, nphi);
    deltaAngle = 128 << 18;
    for (int i = 0; i < nl - 1; i++)
      deltaAngle = std::min(deltaAngle, std::abs(theta[i] - theta[i + 1]));
    phiBuffer.assign(size_t(nl), int(0x80000000));
    // index 255 is reachable only on malformed streams; size for it
    prevThetaRes.assign(256, 0);
    prevThetaResInter.assign(256, 0);
  }
};

// IsThetaPhiEligible (geometry_octree.cpp:559-635), node qp == 0
// scope: the angular IDCM-eligibility decision used when
// one_point_alone_laser_beam_flag is set; updates laserIndex like the
// planar context derivation
static inline void isThetaPhiEligible(
  AngParams& ang, uint8_t& laserIndex, const int32_t nodePosQ[3],
  const int nodeSizeLog2[3], bool& thetaEligible,
  bool& phiEligible) {
  thetaEligible = false;
  phiEligible = false;
  int32_t nodePos[3], midNode[3];
  for (int k = 0; k < 3; k++) {
    nodePos[k] = nodePosQ[k] << nodeSizeLog2[k];
    midNode[k] = (1 << nodeSizeLog2[k]) >> 1;
  }
  int32_t posLidar[3];
  for (int k = 0; k < 3; k++)
    posLidar[k] = nodePos[k] - ang.origin[k];
  uint64_t xLidar =
    uint64_t(std::abs(((int64_t(posLidar[0]) + midNode[0]) << 8) - 128));
  uint64_t yLidar =
    uint64_t(std::abs(((int64_t(posLidar[1]) + midNode[1]) << 8) - 128));
  uint64_t rL1 = (xLidar + yLidar) >> 1;
  uint64_t deltaAngleR = uint64_t(ang.deltaAngle) * rL1;
  if (ang.numLasers > 1 && deltaAngleR <= (uint64_t(midNode[2]) << 26))
    return;
  thetaEligible = true;

  uint64_t r2 = xLidar * xLidar + yLidar * yLidar;
  uint64_t rInv = irsqrt(r2);
  int64_t zLidar = ((int64_t(posLidar[2]) + midNode[2]) << 1) - 1;
  int64_t theta = zLidar * int64_t(rInv);
  int theta32 = int(theta >= 0 ? theta >> 15 : -((-theta) >> 15));

  int laser = laserIndex;
  if (ang.numLasers == 1)
    laser = 0;
  else if (laser == 255
           || deltaAngleR <= (uint64_t(midNode[2]) << 28)) {
    const int32_t* beg = ang.thetaLaser;
    const int32_t* end = beg + ang.numLasers - 1;
    const int32_t* it = std::upper_bound(beg + 1, end, theta32);
    if (theta32 - *(it - 1) <= *it - theta32)
      --it;
    laser = int(it - beg);
    laserIndex = uint8_t(laser);
  }

  int xMid = posLidar[0] + midNode[0];
  int yMid = posLidar[1] + midNode[1];
  int phiNode = iatan2(yMid, xMid);
  int phiNode0 = std::abs(xMid) < std::abs(yMid)
    ? iatan2(yMid, posLidar[0])
    : iatan2(posLidar[1], xMid);
  uint64_t deltaPhi = uint64_t(std::abs(phiNode - phiNode0)) << 1;
  if (deltaPhi > uint64_t(ang.phiZi.delta[size_t(laser)]))
    return;
  phiEligible = true;
}

// determineContextAngleForPlanar (geometry_octree.cpp:682-800), node
// qp == 0 scope.  Returns contextAngle (z) or -1; fills the azimuthal
// contexts for the dominant horizontal axis; updates laserIndex.
static inline int contextAngleForPlanar(
  AngParams& ang, uint8_t& laserIndex, const int32_t nodePosQ[3],
  const int nodeSizeLog2[3], int* contextAnglePhiX,
  int* contextAnglePhiY) {
  int32_t nodePos[3], midNode[3], nodeSize[3];
  for (int k = 0; k < 3; k++) {
    nodePos[k] = nodePosQ[k] << nodeSizeLog2[k];
    midNode[k] = (1 << nodeSizeLog2[k]) >> 1;
    nodeSize[k] = 1 << nodeSizeLog2[k];
  }

  int32_t posLidar[3];
  for (int k = 0; k < 3; k++)
    posLidar[k] = nodePos[k] - ang.origin[k];
  uint64_t xLidar =
    uint64_t(std::abs(((int64_t(posLidar[0]) + midNode[0]) << 8) - 128));
  uint64_t yLidar =
    uint64_t(std::abs(((int64_t(posLidar[1]) + midNode[1]) << 8) - 128));

  uint64_t rL1 = (xLidar + yLidar) >> 1;
  uint64_t deltaAngleR = uint64_t(ang.deltaAngle) * rL1;
  if (ang.numLasers > 1 && deltaAngleR <= (uint64_t(midNode[2]) << 26))
    return -1;

  uint64_t r2 = xLidar * xLidar + yLidar * yLidar;
  uint64_t rInv = irsqrt(r2);

  int64_t zLidar = ((int64_t(posLidar[2]) + midNode[2]) << 1) - 1;
  int64_t theta = zLidar * int64_t(rInv);
  int theta32 = int(theta >= 0 ? theta >> 15 : -((-theta) >> 15));

  int laser = laserIndex;
  if (ang.numLasers == 1)
    laser = 0;
  else if (laser == 255
           || deltaAngleR <= (uint64_t(midNode[2]) << 28)) {
    const int32_t* beg = ang.thetaLaser;
    const int32_t* end = beg + ang.numLasers - 1;
    const int32_t* it = std::upper_bound(beg + 1, end, theta32);
    if (theta32 - *(it - 1) <= *it - theta32)
      --it;
    laser = int(it - beg);
    laserIndex = uint8_t(laser);
  }

  // azimuthal (phi) contexts
  int posx = posLidar[0];
  int posy = posLidar[1];
  int phiNode = iatan2(posy + midNode[1], posx + midNode[0]);
  int phiNode0 = iatan2(posy, posx);

  int predPhi = ang.phiBuffer[size_t(laser)];
  if (predPhi == int(0x80000000))
    predPhi = phiNode;

  if (predPhi != int(0x80000000)) {
    int Nshift = int(
      ((int64_t(predPhi - phiNode) * ang.phiZi.invDelta[size_t(laser)])
       + (int64_t(1) << 29)) >> 30);
    predPhi -= ang.phiZi.delta[size_t(laser)] * Nshift;

    int angleL = phiNode0 - predPhi;
    int angleR = phiNode - predPhi;
    int contextAnglePhi =
      (angleL >= 0 && angleR >= 0) || (angleL < 0 && angleR < 0) ? 2
                                                                 : 0;
    angleL = std::abs(angleL);
    angleR = std::abs(angleR);
    if (angleL > angleR) {
      contextAnglePhi++;
      std::swap(angleL, angleR);
    }
    if (angleR > (angleL << 2))
      contextAnglePhi += 4;

    if (std::abs(posx) <= std::abs(posy))
      *contextAnglePhiX = contextAnglePhi;
    else
      *contextAnglePhiY = contextAnglePhi;
  }

  // elevation (theta) context
  int thetaLaserDelta = ang.thetaLaser[laser] - theta32;
  int64_t hr = int64_t(ang.zLaser[laser]) * int64_t(rInv);
  thetaLaserDelta += int(hr >= 0 ? -(hr >> 17) : ((-hr) >> 17));

  int64_t zShift = (int64_t(rInv) * nodeSize[2]) >> 20;
  int thetaLaserDeltaBot = thetaLaserDelta + int(zShift);
  int thetaLaserDeltaTop = thetaLaserDelta - int(zShift);
  int contextAngle = thetaLaserDelta >= 0 ? 0 : 1;
  if (thetaLaserDeltaTop >= 0)
    contextAngle += 2;
  else if (thetaLaserDeltaBot < 0)
    contextAngle += 2;
  return contextAngle;
}

}  // namespace angularcore

#endif  // ANGULAR_CORE_H_
