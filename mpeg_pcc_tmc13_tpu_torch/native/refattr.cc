// Bit-exact reference-conformant G-PCC RAHT attribute decoder.
//
// Conformance-oracle companion to refcodec.cc: decodes RAHT attribute
// bricks produced by the MPEG reference codec (tmc3) to the identical
// reconstructed attributes.  Like refcodec.cc -- and unlike the rest of
// this repository, which is a TPU-first redesign -- this file
// intentionally reproduces, operation for operation, the *normative*
// decoding semantics of the reference:
//   * the zero-run + contexted exp-Golomb residual decoder
//     (tmc3/AttributeDecoder.cpp:53-172,
//      entropyutils.h:189-239, AttributeCommon.h:49-58)
//   * the descending fixed-point RAHT inverse transform
//     uraht_process<false> (tmc3/RAHT.cpp:977-1977)
//     with its level reduce/expand machinery (RAHT.cpp:108-270),
//     19-parent + 12-child-subnode intra DC prediction
//     (RAHT.cpp:272-593) and 2x2x2 butterfly kernels
//     (RAHT.cpp:594-795)
//   * the attribute quantiser laws (quantization.{h,cpp}:46-205,
//     tables.cpp kQpStep/kQpStepRecip) and the fixed-point helpers
//     FixedPoint.h, misc.cpp isqrt/irsqrt:120-230
// Constant tables are normative and therefore numerically identical to
// the reference (QP step tables, rsqrt Newton LUTs, divisor LUT,
// neighbour masks/offsets).
//
// Scope: RAHT (raht_extension on or off), intra (no attribute inter
// prediction), integer Haar on or off, layer QPs, no region QP boxes,
// no AC-coefficient QP offsets, single attribute brick per slice
// (fresh contexts).  Decode only; the forward (encoder) direction of
// the interop lives in conformance/encoder.py scope notes.
//
// The arithmetic decoder (ArithDec) is shared with the geometry
// conformance engine (obuf_core.h).

#include <algorithm>
#include <array>
#include <cmath>
#include <cassert>
#include <cstdint>
#include <cstring>
#include <vector>

#include "obuf_core.h"

namespace refattr {

using obufcore::ArithDec;

// ---------------------------------------------------------------------------
// fixed-point helpers (FixedPoint.h; misc.cpp:120-230)
// ---------------------------------------------------------------------------

static const int kFracBits = 15;
static const int64_t kOneHalf = 1ll << (kFracBits - 1);
static const int kFixedPointAttributeShift = 8;

struct FP {
  int64_t val;
  FP() : val(0) {}
  explicit FP(int64_t v) : val(v) {}  // raw
  static FP fromInt(int64_t v) {
    FP r;
    r.val = v > 0 ? (v << kFracBits) : -((-v) << kFracBits);
    return r;
  }
  int64_t round() const {
    if (val > 0) return (kOneHalf + val) >> kFracBits;
    return -((kOneHalf - val) >> kFracBits);
  }
  void operator+=(const FP& o) { val += o.val; }
  void operator-=(const FP& o) { val -= o.val; }
  void operator*=(const FP& o) {
    val *= o.val;
    if (val < 0)
      val = -((kOneHalf - val) >> kFracBits);
    else
      val = +((kOneHalf + val) >> kFracBits);
  }
};

// Newton-iteration inverse square root (misc.cpp:150-230); the seed
// tables are normative.
namespace rsqrt {
static const uint64_t k3timesR[96] = {
  3196059648u, 3145728000u, 3107979264u, 3057647616u, 3019898880u,
  2969567232u, 2931818496u, 2894069760u, 2868903936u, 2831155200u,
  2793406464u, 2768240640u, 2730491904u, 2705326080u, 2667577344u,
  2642411520u, 2617245696u, 2592079872u, 2566914048u, 2541748224u,
  2516582400u, 2491416576u, 2466250752u, 2441084928u, 2428502016u,
  2403336192u, 2378170368u, 2365587456u, 2340421632u, 2327838720u,
  2302672896u, 2290089984u, 2264924160u, 2252341248u, 2239758336u,
  2214592512u, 2202009600u, 2189426688u, 2164260864u, 2151677952u,
  2139095040u, 2126512128u, 2113929216u, 2101346304u, 2088763392u,
  2076180480u, 2051014656u, 2038431744u, 2025848832u, 2013265920u,
  2000683008u, 2000683008u, 1988100096u, 1962934272u, 1962934272u,
  1950351360u, 1937768448u, 1925185536u, 1912602624u, 1900019712u,
  1900019712u, 1887436800u, 1874853888u, 1862270976u, 1849688064u,
  1849688064u, 1837105152u, 1824522240u, 1811939328u, 1811939328u,
  1799356416u, 1786773504u, 1786773504u, 1774190592u, 1761607680u,
  1761607680u, 1749024768u, 1736441856u, 1736441856u, 1723858944u,
  1723858944u, 1711276032u, 1698693120u, 1698693120u, 1686110208u,
  1686110208u, 1673527296u, 1660944384u, 1660944384u, 1648361472u,
  1648361472u, 1635778560u, 1635778560u, 1623195648u, 1623195648u,
  1610612736u};

static const uint64_t kRcubed[96] = {
  4195081216u, 3999986688u, 3857709056u, 3673323520u, 3538940928u,
  3364924416u, 3238224896u, 3114735616u, 3034196992u, 2915990528u,
  2800922624u, 2725880832u, 2615890944u, 2544223232u, 2439185408u,
  2370818048u, 2303728640u, 2237913088u, 2173355008u, 2110061568u,
  2048008192u, 1987165184u, 1927563264u, 1869150208u, 1840392192u,
  1783783424u, 1728321536u, 1701024768u, 1647311872u, 1620883456u,
  1568898048u, 1543306240u, 1492993024u, 1468236800u, 1443762176u,
  1395656704u, 1372007424u, 1348605952u, 1302626304u, 1280060416u,
  1257736192u, 1235650560u, 1213861888u, 1192294400u, 1171008512u,
  1149979648u, 1108673536u, 1088379904u, 1068352512u, 1048567808u,
  1029031936u, 1029036032u, 1009729536u, 971888640u,  971882496u,
  953319424u,  934993920u,  916897792u,  899011584u,  881389568u,
  881392640u,  864009216u,  846846976u,  829900800u,  813182976u,
  813201408u,  796721152u,  780459008u,  764412928u,  764417024u,
  748601344u,  732995584u,  733017088u,  717624320u,  702468096u,
  702466048u,  687520768u,  672786432u,  672787456u,  658258944u,
  658256896u,  643947520u,  629854208u,  629862400u,  615976960u,
  615952384u,  602276864u,  588779520u,  588804096u,  575512576u,
  575526912u,  562433024u,  562439168u,  549556224u,  549564416u,
  536876032u};
}  // namespace rsqrt

static uint64_t irsqrt(uint64_t a64) {
  using namespace rsqrt;
  if (!a64) return 0;
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
  uint64_t r = k3timesR[idx] - ((kRcubed[idx] * a) >> 32);
  uint64_t ar = (r * a) >> 32;
  uint64_t s = 0x30000000ull - ((r * ar) >> 32);
  r = (r * s) >> 32;
  if (shift > 0) return r << shift;
  return r >> -shift;
}

static uint32_t isqrt(uint64_t x) {
  if (x <= (uint64_t(1) << 46))
    return uint32_t(1 + ((x * irsqrt(x)) >> 40));
  uint64_t x0 = (x + 65536) >> 16;
  return uint32_t(1 + ((x0 * irsqrt(x0)) >> 32));
}

// shared with trisoup_geom.cc (same normative isqrt, misc.cpp:193)
extern "C" uint32_t tmc13ref_isqrt(uint64_t x) { return isqrt(x); }

// shared with refpredlift.cc (normative irsqrt, misc.cpp:188-230)
extern "C" uint64_t tmc13ref_irsqrt(uint64_t x) { return irsqrt(x); }

static int ilog2(uint64_t x) {
  int r = 0;
  while (x > 1) {
    x >>= 1;
    r++;
  }
  return r;
}

static int64_t divExp2RoundHalfUp(int64_t x, int shift) {
  if (!shift) return x;
  int64_t half = 1ll << (shift - 1);
  return (x + half) >> shift;
}

// Morton-domain +1 per axis (PCCMisc.h:245-256)
static uint64_t morton3dAdd(uint64_t a, uint64_t b) {
  uint64_t mask = 0x9249249249249249ull;
  uint64_t val = 0;
  for (int i = 0; i < 3; i++) {
    val |= ((a | ~mask) + (b & mask)) & mask;
    mask <<= 1;
  }
  return val;
}

// ---------------------------------------------------------------------------
// attribute quantiser (quantization.{h,cpp}; tables.cpp:478-481)
// ---------------------------------------------------------------------------

static const int16_t kQpStep[6] = {161, 181, 203, 228, 256, 287};
static const int32_t kQpStepRecip[6] = {416825, 370767, 330586,
                                        294337, 262144, 233829};

struct Quant {
  int stepSize = 0;
  int64_t stepSizeRecip = 0;
  Quant() = default;
  explicit Quant(int qp) {
    qp = std::max(qp, 4);
    int qpShift = qp / 6;
    stepSize = kQpStep[qp % 6] << qpShift;
    stepSizeRecip = int64_t(kQpStepRecip[qp % 6]) >> qpShift;
  }
  int64_t scale(int64_t x) const { return x * stepSize; }
  int64_t quantize(int64_t x) const {
    int64_t fracBits = 18 + kFixedPointAttributeShift;
    int64_t offset = (1ll << fracBits) / 3;
    if (x >= 0) return (x * stepSizeRecip + offset) >> fracBits;
    return -((offset - x * stepSizeRecip) >> fracBits);
  }
};

struct QpSet {
  // layers[l] = {lumaQp, chromaOffset}; quantizers() adds the chroma
  // offset to the derived luma QP (quantization.cpp:170-178)
  std::vector<std::array<int, 2>> layers;
  int maxQp;
  void quantizers(int qpLayer, const int nodeQp[2], Quant q[2]) const {
    int qp0 = std::min(std::max(layers[qpLayer][0] + nodeQp[0], 4), maxQp);
    int qp1 =
      std::min(std::max(layers[qpLayer][1] + nodeQp[1] + qp0, 4), maxQp);
    q[0] = Quant(qp0);
    q[1] = Quant(qp1);
  }
};

// ---------------------------------------------------------------------------
// residual entropy decoder (AttributeDecoder.cpp:53-172; contexts
// AttributeCommon.h:49-58; exp-Golomb entropyutils.h:189-239)
// ---------------------------------------------------------------------------

struct AttrCtx {
  uint16_t runLen[5];
  uint16_t coeffGtN[2][7];
  uint16_t remPrefix[2][3];
  uint16_t remSuffix[2][3];
  void init() {
    for (auto& c : runLen) c = 0x8000;
    for (auto& r : coeffGtN)
      for (auto& c : r) c = 0x8000;
    for (auto& r : remPrefix)
      for (auto& c : r) c = 0x8000;
    for (auto& r : remSuffix)
      for (auto& c : r) c = 0x8000;
  }
};

// decodeExpGolomb with bounded prefix/suffix context arrays
// (entropyutils.h:210-239)
static unsigned expGolombCtx(
  ArithDec& aec, int k, uint16_t* ctxPrefix, int numPrefix,
  uint16_t* ctxSuffix, int numSuffix) {
  const int k0 = k;
  unsigned l;
  int symbol = 0;
  int binary = 0;
  do {
    l = aec.bit(&ctxPrefix[std::min(numPrefix - 1, k - k0)]);
    if (l == 1) {
      symbol += 1 << k;
      k++;
    }
  } while (l != 0);
  while (k--)
    binary |= aec.bit(&ctxSuffix[std::min(numSuffix - 1, k)]) << k;
  return unsigned(symbol + binary);
}

// AttributeDecoder.cpp:101-123
static int decodeRunLength(ArithDec& aec, AttrCtx& ctx) {
  int runLength = 0;
  uint16_t* c = ctx.runLen;
  for (; runLength < 3; runLength++, c++) {
    if (!aec.bit(c)) return runLength;
  }
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

// AttributeDecoder.cpp:127-141
static int decodeSymbol(ArithDec& aec, AttrCtx& ctx, int k1, int k2, int k3) {
  if (!aec.bit(&ctx.coeffGtN[0][k1])) return 0;
  if (!aec.bit(&ctx.coeffGtN[1][k2])) return 1;
  int rem = int(expGolombCtx(aec, 1, ctx.remPrefix[k3], 3,
                             ctx.remSuffix[k3], 3));
  return rem + 2;
}

// AttributeDecoder.cpp:145-163 (colour triplet)
static void decodeTriplet(ArithDec& aec, AttrCtx& ctx, int32_t value[3]) {
  value[1] = decodeSymbol(aec, ctx, 0, 0, 1);
  int b0 = value[1] == 0;
  int b1 = value[1] <= 1;
  value[2] = decodeSymbol(aec, ctx, 1 + b0, 1 + b1, 1);
  int b2 = value[2] == 0;
  int b3 = value[2] <= 1;
  value[0] = decodeSymbol(aec, ctx, 3 + (b0 << 1) + b2, 3 + (b1 << 1) + b3, 0);
  if (b0 && b2) value[0] += 1;
  if (value[0] && aec.bypass()) value[0] = -value[0];
  if (value[1] && aec.bypass()) value[1] = -value[1];
  if (value[2] && aec.bypass()) value[2] = -value[2];
}

// AttributeDecoder.cpp:167-172 (scalar)
static int32_t decodeScalar(ArithDec& aec, AttrCtx& ctx) {
  int32_t mag = decodeSymbol(aec, ctx, 0, 0, 0) + 1;
  bool sign = aec.bypass();
  return sign ? -mag : mag;
}

// ---- encode direction (PCCResidualsEncoder,
//      AttributeEncoder.cpp:228-307; encodeExpGolomb
//      entropyutils.h:160-183) ------------------------------------------

static void expGolombEncCtx(
  obufcore::ArithEnc& aec, unsigned symbol, int k, uint16_t* ctxPrefix,
  int numPrefix, uint16_t* ctxSuffix, int numSuffix) {
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

// AttributeEncoder.cpp:228-252
static void encodeRunLength(obufcore::ArithEnc& aec, AttrCtx& ctx,
                            int runLength) {
  uint16_t* c = ctx.runLen;
  for (int i = 0; i < std::min(3, runLength); i++, c++) aec.bit(c, 1);
  if (runLength < 3) {
    aec.bit(c, 0);
    return;
  }
  runLength -= 3;
  int prefix = runLength >> 1;
  for (int i = 0; i < std::min(4, prefix); i++) aec.bit(c, 1);
  if (runLength < 8) {
    aec.bit(c, 0);
    aec.bypass(runLength & 1);
    return;
  }
  runLength -= 8;
  aec.exp_golomb(unsigned(runLength), 2, ++c);
}

// AttributeEncoder.cpp:257-269
static void encodeSymbol(obufcore::ArithEnc& aec, AttrCtx& ctx,
                         uint32_t value, int k1, int k2, int k3) {
  aec.bit(&ctx.coeffGtN[0][k1], value > 0);
  if (!value) return;
  aec.bit(&ctx.coeffGtN[1][k2], --value > 0);
  if (!value) return;
  expGolombEncCtx(aec, --value, 1, ctx.remPrefix[k3], 3,
                  ctx.remSuffix[k3], 3);
}

// AttributeEncoder.cpp:274-299 (colour triplet)
static void encodeTriplet(obufcore::ArithEnc& aec, AttrCtx& ctx,
                          int32_t value0, int32_t value1, int32_t value2) {
  int mag0 = value0 < 0 ? -value0 : value0;
  int mag1 = value1 < 0 ? -value1 : value1;
  int mag2 = value2 < 0 ? -value2 : value2;
  int b0 = (mag1 == 0);
  int b1 = (mag1 <= 1);
  int b2 = (mag2 == 0);
  int b3 = (mag2 <= 1);
  encodeSymbol(aec, ctx, mag1, 0, 0, 1);
  encodeSymbol(aec, ctx, mag2, 1 + b0, 1 + b1, 1);
  int mag0minusX = (b0 && b2) ? mag0 - 1 : mag0;
  encodeSymbol(aec, ctx, mag0minusX, 3 + (b0 << 1) + b2,
               3 + (b1 << 1) + b3, 0);
  if (mag0) aec.bypass(value0 < 0);
  if (mag1) aec.bypass(value1 < 0);
  if (mag2) aec.bypass(value2 < 0);
}

// AttributeEncoder.cpp:303-307 (scalar)
static void encodeScalar(obufcore::ArithEnc& aec, AttrCtx& ctx,
                         int32_t value) {
  int mag = (value < 0 ? -value : value) - 1;
  encodeSymbol(aec, ctx, mag, 0, 0, 0);
  aec.bypass(value < 0);
}

// ---------------------------------------------------------------------------
// uraht tree machinery (RAHT.cpp:95-270)
// ---------------------------------------------------------------------------

struct UNode {
  int64_t pos;
  int weight;
  int qp[2];
  uint8_t occupancy;
  int firstChild, lastChild;  // indices into the current child level
};

// RAHT.cpp:108-151
static int reduceUnique(
  int numNodes, int numAttrs, std::vector<UNode>* weightsIn,
  std::vector<UNode>* weightsOut, std::vector<int>* attrsIn,
  std::vector<int>* attrsOut, bool haar) {
  int64_t posPrev = -1;
  int wr = 0, rd = 0;
  int awr = 0, ard = 0;
  auto& w = *weightsIn;
  auto& a = *attrsIn;
  for (int i = 0; i < numNodes; i++) {
    const UNode node = w[rd++];
    if (node.pos != posPrev) {
      posPrev = node.pos;
      w[wr++] = node;
      for (int k = 0; k < numAttrs; k++) a[awr++] = a[ard++];
      continue;
    }
    w[wr - 1].weight += node.weight;
    weightsOut->push_back(node);
    for (int k = 0; k < numAttrs; k++) {
      if (haar) {
        attrsOut->push_back(a[ard++] - a[awr - numAttrs + k]);
        a[awr - numAttrs + k] += attrsOut->back() >> 1;
      } else {
        a[awr - numAttrs + k] += a[ard];
        attrsOut->push_back(a[ard++]);
      }
    }
  }
  return wr;
}

// RAHT.cpp:157-208
static int reduceLevel(
  int level, int numNodes, int numAttrs, std::vector<UNode>* weightsIn,
  std::vector<UNode>* weightsOut, std::vector<int>* attrsIn,
  std::vector<int>* attrsOut, bool haar) {
  int64_t posPrev = -1;
  int wr = 0, rd = 0;
  int awr = 0, ard = 0;
  auto& w = *weightsIn;
  auto& a = *attrsIn;
  for (int i = 0; i < numNodes; i++) {
    const UNode node = w[rd++];
    bool newPair = ((posPrev ^ node.pos) >> level) != 0;
    posPrev = node.pos;
    if (newPair) {
      w[wr++] = node;
      for (int k = 0; k < numAttrs; k++) a[awr++] = a[ard++];
    } else {
      UNode& left = w[wr - 1];
      left.weight += node.weight;
      left.qp[0] = (left.qp[0] + node.qp[0]) >> 1;
      left.qp[1] = (left.qp[1] + node.qp[1]) >> 1;
      weightsOut->push_back(node);
      for (int k = 0; k < numAttrs; k++) {
        if (haar) {
          attrsOut->push_back(a[ard++] - a[awr - numAttrs + k]);
          a[awr - numAttrs + k] += attrsOut->back() >> 1;
        } else {
          a[awr - numAttrs + k] += a[ard];
          attrsOut->push_back(a[ard++]);
        }
      }
    }
  }
  return wr;
}

// RAHT.cpp:211-270 (reverse iteration expressed with explicit indices)
static void expandLevel(
  int level, int numNodes, int numAttrs, std::vector<UNode>* weightsIn,
  std::vector<UNode>* weightsOut, std::vector<int>* attrsIn,
  std::vector<int>* attrsOut, bool haar) {
  if (numNodes == 0) return;
  auto& w = *weightsIn;
  auto& a = *attrsIn;
  // reverse-iterator positions as forward indices (one past the element)
  int wrIt = int(w.size());              // write head (moves down)
  int rdIt = int(w.size()) - numNodes;   // read head (moves down)
  int outRd = int(weightsOut->size());
  int awr = int(a.size());
  int ard = int(a.size()) - numNodes * numAttrs;
  int aout = int(attrsOut->size());

  for (int i = 0; i < numNodes;) {
    bool isPair = (((*weightsOut)[outRd - 1].pos ^ w[rdIt - 1].pos)
                   >> level) == 0;
    if (!isPair) {
      w[--wrIt] = w[--rdIt];
      for (int k = 0; k < numAttrs; k++) a[--awr] = a[--ard];
      continue;
    }
    i++;
    const UNode nodeDelta = w[--wrIt] = (*weightsOut)[--outRd];
    // NB: reverse iteration writes attrs high-to-low; the delta chunk
    // lands at [awr-numAttrs, awr) and pairs with the node chunk one
    // stride below, same component k at distance numAttrs
    for (int k = 0; k < numAttrs; k++) a[--awr] = (*attrsOut)[--aout];
    w[--wrIt] = w[--rdIt];
    w[wrIt].weight -= nodeDelta.weight;
    for (int k = numAttrs - 1; k >= 0; k--) {
      a[--awr] = a[--ard];
      int cur = awr + numAttrs;  // paired delta slot (same k)
      if (haar) {
        a[awr] -= a[cur] >> 1;
        a[cur] += a[awr];
      } else {
        a[awr] -= a[cur];
      }
    }
  }
}

// RAHT.cpp:274-297
template<typename Cmp>
static int findNeighbourIdx(
  const std::vector<UNode>& list, int first, int last, int from,
  int64_t value, int64_t distance, Cmp compare) {
  int start = first, end = last;
  if (distance >= 0) {
    start = from;
    if (distance + 1 < last - from) end = from + int(distance) + 1;
  } else {
    end = from;
    if (-distance < from - first) start = from - int(-distance);
  }
  // lower_bound
  int lo = start, hi = end;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (compare(list[mid], value))
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo == end) return last;
  return lo;
}

static const uint8_t kNeighMasks[19] = {255, 240, 204, 170, 192, 160, 136,
                                        3,   5,   15,  17,  51,  85,  10,
                                        34,  12,  68,  48,  80};
static const uint8_t kNeighOffset[19] = {0, 35, 21, 14, 49, 42, 28, 1,  2, 3,
                                         4, 5,  6,  10, 12, 17, 20, 33, 34};

// RAHT.cpp:299-418
static void findNeighbours(
  const std::vector<UNode>& parents, int first, int last, int it,
  const std::vector<UNode>& childLevel, int firstChild, int level,
  uint8_t occupancy, int parentNeighIdx[19], int childNeighIdx[12][8],
  bool subnodePrediction, int searchRange) {
  int64_t cur_pos = parents[it].pos >> level;
  int64_t base_pos = int64_t(morton3dAdd(uint64_t(cur_pos), uint64_t(-1ll)));

  parentNeighIdx[0] = it - first;

  for (int i = 1; i < 19; i++) {
    if (!(occupancy & kNeighMasks[i])) {
      parentNeighIdx[i] = -1;
      continue;
    }
    int64_t neigh_pos =
      int64_t(morton3dAdd(uint64_t(base_pos), kNeighOffset[i]));
    int64_t delta = neigh_pos - cur_pos;
    if (delta >= 0)
      delta = delta >= searchRange ? searchRange : delta;
    else
      delta = (-delta) >= searchRange ? -int64_t(searchRange) : delta;
    int found = findNeighbourIdx(
      parents, first, last, it, neigh_pos, delta,
      [=](const UNode& cand, int64_t np) { return (cand.pos >> level) < np; });
    if (found == last || (parents[found].pos >> level) != neigh_pos) {
      parentNeighIdx[i] = -1;
      continue;
    }
    parentNeighIdx[i] = found - first;
  }

  if (!subnodePrediction) return;

  for (int* p = &childNeighIdx[0][0], i = 0; i < 96; p++, i++) *p = -1;

  static const uint8_t occuMasks[12] = {3,  5,  15, 17, 51, 85,
                                        10, 34, 12, 68, 48, 80};
  static const uint8_t occuShift[12] = {6, 5, 4, 3, 2, 1, 3, 1, 2, 1, 2, 3};

  int curLevel = level - 3;
  for (int i = 0; i < 9; i++) {
    if (parentNeighIdx[7 + i] == -1) continue;
    const UNode& nei = parents[first + parentNeighIdx[7 + i]];
    uint8_t mask = (nei.occupancy >> occuShift[i]) & occupancy & occuMasks[i];
    if (!mask) continue;
    for (int c = nei.firstChild; c != nei.lastChild; c++) {
      int nodeIdx = int((childLevel[c].pos >> curLevel) & 0x7) - occuShift[i];
      if (nodeIdx >= 0 && ((mask >> nodeIdx) & 1))
        childNeighIdx[i][nodeIdx] = c - firstChild;
    }
  }
  for (int i = 9; i < 12; i++) {
    if (parentNeighIdx[7 + i] == -1) continue;
    const UNode& nei = parents[first + parentNeighIdx[7 + i]];
    uint8_t mask =
      uint8_t(nei.occupancy << occuShift[i]) & occupancy & occuMasks[i];
    if (!mask) continue;
    for (int c = nei.firstChild; c != nei.lastChild; c++) {
      int nodeIdx = int((childLevel[c].pos >> curLevel) & 0x7) + occuShift[i];
      if (nodeIdx < 8 && ((mask >> nodeIdx) & 1))
        childNeighIdx[i][nodeIdx] = c - firstChild;
    }
  }
}

// RAHT.cpp:421-593 (decoder specialisation: isEncoder=false)
struct PredParams {
  bool predictionEnabled;
  bool haar;
  int threshold0, threshold1;
  bool subnodePrediction;
  int searchRange;
  bool rahtExtension;
  int predWeightParent[19];
  int predWeightChild[12];
};

static const int kDivisors[64] = {
  32768, 16384, 10923, 8192, 6554, 5461, 4681, 4096, 3641, 3277, 2979,
  2731,  2521,  2341,  2185, 2048, 1928, 1820, 1725, 1638, 1560, 1489,
  1425,  1365,  1311,  1260, 1214, 1170, 1130, 1092, 1057, 1024, 993,
  964,   936,   910,   886,  862,  840,  819,  799,  780,  762,  745,
  728,   712,   697,   683,  669,  655,  643,  630,  618,  607,  596,
  585,   575,   565,   555,  546,  537,  529,  520,  512};

// dual-track form (RAHT.cpp:421-593): with the encoder's per-layer
// inter/intra RDO the intra track re-derives child-neighbour values
// from its own reconstruction; parent contributions are shared
static void intraDcPred(
  int numAttrs, const int parentNeighIdx[19], const int childNeighIdx[12][8],
  int occupancy, const std::vector<int64_t>& attrRecParent,
  const std::vector<int64_t>& attrRec, FP predBuf[][8],
  const PredParams& pp, int64_t& limitLow, int64_t& limitHigh,
  const std::vector<int64_t>* intraAttrRec = nullptr,
  FP (*intraPredBuf)[8] = nullptr) {
  static const uint8_t predMasks[19] = {255, 240, 204, 170, 192, 160, 136,
                                        3,   5,   15,  17,  51,  85,  10,
                                        34,  12,  68,  48,  80};
  const bool dualTrack = intraPredBuf != nullptr;
  int weightSum[8] = {-1, -1, -1, -1, -1, -1, -1, -1};
  for (int k = 0; k < numAttrs; k++)
    for (int j = 0; j < 8; j++) predBuf[k][j].val = 0;
  if (dualTrack)
    for (int k = 0; k < numAttrs; k++)
      for (int j = 0; j < 8; j++) intraPredBuf[k][j].val = 0;

  int64_t neighValue[3];
  int64_t childNeighValue[3];
  int64_t intraChildNeighValue[3];
  (void)intraChildNeighValue;

  const int parentOnlyCheckMaxIdx = pp.subnodePrediction ? 7 : 19;
  for (int i = 0; i < parentOnlyCheckMaxIdx; i++) {
    if (parentNeighIdx[i] == -1) continue;
    int base = numAttrs * parentNeighIdx[i];
    for (int k = 0; k < numAttrs; k++)
      neighValue[k] = attrRecParent[base + k];
    if (i) {
      if (10 * neighValue[0] <= limitLow || 10 * neighValue[0] >= limitHigh)
        continue;
    } else {
      limitLow = 2 * neighValue[0];
      limitHigh = 25 * neighValue[0];
    }
    for (int k = 0; k < numAttrs; k++) {
      if (pp.rahtExtension)
        neighValue[k] *= pp.predWeightParent[i];
      else
        neighValue[k] *= int64_t(pp.predWeightParent[i]) << kFracBits;
    }
    int mask = predMasks[i] & occupancy;
    for (int j = 0; mask; j++, mask >>= 1) {
      if (mask & 1) {
        weightSum[j] += pp.predWeightParent[i];
        for (int k = 0; k < numAttrs; k++) {
          predBuf[k][j].val += neighValue[k];
          if (dualTrack) intraPredBuf[k][j].val += neighValue[k];
        }
      }
    }
  }
  if (pp.subnodePrediction) {
    for (int i = 0; i < 12; i++) {
      if (parentNeighIdx[7 + i] == -1) continue;
      int base = numAttrs * parentNeighIdx[7 + i];
      for (int k = 0; k < numAttrs; k++)
        neighValue[k] = attrRecParent[base + k];
      if (10 * neighValue[0] <= limitLow || 10 * neighValue[0] >= limitHigh)
        continue;
      for (int k = 0; k < numAttrs; k++) {
        if (pp.rahtExtension)
          neighValue[k] *= pp.predWeightParent[7 + i];
        else
          neighValue[k] *= int64_t(pp.predWeightParent[7 + i]) << kFracBits;
      }
      int mask = predMasks[7 + i] & occupancy;
      for (int j = 0; mask; j++, mask >>= 1) {
        if (mask & 1) {
          if (childNeighIdx[i][j] != -1) {
            weightSum[j] += pp.predWeightChild[i];
            int cbase = numAttrs * childNeighIdx[i][j];
            for (int k = 0; k < numAttrs; k++) {
              if (pp.rahtExtension)
                childNeighValue[k] =
                  attrRec[cbase + k] * pp.predWeightChild[i];
              else
                childNeighValue[k] = attrRec[cbase + k]
                  * (int64_t(pp.predWeightChild[i]) << kFracBits);
            }
            for (int k = 0; k < numAttrs; k++)
              predBuf[k][j].val += childNeighValue[k];
            if (dualTrack) {
              int icbase = numAttrs * childNeighIdx[i][j];
              for (int k = 0; k < numAttrs; k++) {
                if (pp.rahtExtension)
                  intraChildNeighValue[k] = (*intraAttrRec)[icbase + k]
                    * pp.predWeightChild[i];
                else
                  intraChildNeighValue[k] = (*intraAttrRec)[icbase + k]
                    * (int64_t(pp.predWeightChild[i]) << kFracBits);
                intraPredBuf[k][j].val += intraChildNeighValue[k];
              }
            }
          } else {
            weightSum[j] += pp.predWeightParent[7 + i];
            for (int k = 0; k < numAttrs; k++) {
              predBuf[k][j].val += neighValue[k];
              if (dualTrack) intraPredBuf[k][j].val += neighValue[k];
            }
          }
        }
      }
    }
  }
  // normalise
  FP div;
  for (int i = 0; i < 8; i++, occupancy >>= 1) {
    if (occupancy & 1) {
      div.val = kDivisors[weightSum[i]];
      for (int k = 0; k < numAttrs; k++) {
        predBuf[k][i] *= div;
        if (dualTrack) intraPredBuf[k][i] *= div;
      }
      if (pp.haar) {
        for (int k = 0; k < numAttrs; k++) {
          predBuf[k][i].val =
            (predBuf[k][i].val >> kFracBits) << kFracBits;
          if (dualTrack)
            intraPredBuf[k][i].val =
              (intraPredBuf[k][i].val >> kFracBits) << kFracBits;
        }
      }
    }
  }
}

// RAHT.cpp:594-668 kernels
struct RahtKernel {
  FP a_, b_;
  RahtKernel(int weightLeft, int weightRight) {
    uint64_t w = uint64_t(weightLeft) + uint64_t(weightRight);
    uint64_t isqrtW = irsqrt(w);
    a_.val =
      int64_t((isqrt(uint64_t(weightLeft) << (2 * kFracBits)) * isqrtW) >> 40);
    b_.val = int64_t(
      (isqrt(uint64_t(weightRight) << (2 * kFracBits)) * isqrtW) >> 40);
  }
  void fwd(FP left, FP right, FP* lf, FP* hf) const {
    FP a = a_, b = b_;
    *lf = right;
    *lf *= b;
    *hf = right;
    *hf *= a;
    a *= left;
    b *= left;
    *lf += a;
    *hf -= b;
  }
  void inv(FP lf, FP hf, FP* left, FP* right) const {
    FP a = a_, b = b_;
    *left = lf;
    *left *= a;
    *right = lf;
    *right *= b;
    b *= hf;
    a *= hf;
    *left -= b;
    *right += a;
  }
};

struct HaarKernel {
  HaarKernel(int, int) {}
  void fwd(FP left, FP right, FP* lf, FP* hf) const {
    hf->val = right.val - left.val;
    lf->val = left.val + ((hf->val >> (1 + kFracBits)) << kFracBits);
  }
  void inv(FP lf, FP hf, FP* left, FP* right) const {
    left->val = lf.val - ((hf.val >> (1 + kFracBits)) << kFracBits);
    right->val = hf.val + left->val;
  }
};

static const int kBtfA[12] = {0, 2, 4, 6, 0, 4, 1, 5, 0, 1, 2, 3};
static const int kBtfB[12] = {1, 3, 5, 7, 2, 6, 3, 7, 4, 5, 6, 7};

template<class Kernel>
static void fwdTransformBlock222(int numBufs, FP buf[][8],
                                 const int weights[8 + 8 + 8 + 8]) {
  for (int i = 0, iw = 0; i < 12; i++, iw += 2) {
    int i0 = kBtfA[i], i1 = kBtfB[i];
    if (weights[iw] + weights[iw + 1] == 0) continue;
    if (!weights[iw] || !weights[iw + 1]) {
      if (!weights[iw])
        for (int k = 0; k < numBufs; k++) std::swap(buf[k][i0], buf[k][i1]);
      continue;
    }
    Kernel kernel(weights[iw], weights[iw + 1]);
    for (int k = 0; k < numBufs; k++)
      kernel.fwd(buf[k][i0], buf[k][i1], &buf[k][i0], &buf[k][i1]);
  }
}

template<class Kernel>
static void invTransformBlock222(int numBufs, FP buf[][8],
                                 const int weights[8 + 8 + 8 + 8]) {
  for (int i = 11, iw = 22; i >= 0; i--, iw -= 2) {
    int i0 = kBtfA[i], i1 = kBtfB[i];
    if (weights[iw] + weights[iw + 1] == 0) continue;
    if (!weights[iw] || !weights[iw + 1]) {
      if (!weights[iw])
        for (int k = 0; k < numBufs; k++) std::swap(buf[k][i0], buf[k][i1]);
      continue;
    }
    Kernel kernel(weights[iw], weights[iw + 1]);
    for (int k = 0; k < numBufs; k++)
      kernel.inv(buf[k][i0], buf[k][i1], &buf[k][i0], &buf[k][i1]);
  }
}

// RAHT.cpp:742-774
static void mkWeightTree(int weights[8 + 8 + 8 + 8]) {
  int* in = &weights[0];
  int* out = &weights[8];
  for (int pass = 0; pass < 3; pass++) {
    for (int i = 0; i < 4; i++) {
      out[0] = out[4] = in[0] + in[1];
      if (!in[0] || !in[1]) out[4] = 0;
      in += 2;
      out++;
    }
    out += 4;
  }
}

static const int8_t kRahtScanOrder[8] = {0, 4, 2, 1, 6, 5, 3, 7};

static bool isSibling(int64_t pos0, int64_t pos1, int level) {
  return ((pos0 ^ pos1) >> level) == 0;
}

// ---------------------------------------------------------------------------
// uraht (uraht_process<isEncoder>, RAHT.cpp:977-1977, intra only).
// Decoder reads quantised coefficients from coeffBuf; encoder
// quantises (with the RDOQ zero-row decision, RAHT.cpp:1576-1667) and
// writes them.  Both reconstruct attributes closed-loop.
// ---------------------------------------------------------------------------

static const int kLUTlog[16] = {0,   256, 406, 512, 594, 662, 719,  768,
                                812, 850, 886, 918, 947, 975, 1000, 1024};
static const int kLUTbins[11] = {1, 2, 3, 5, 5, 7, 7, 9, 9, 11, 11};

// inter-RAHT reference set + controls (AttributeInterPredParams
// paramsForInterRAHT, PCCTMC3Common.h:236-276): the previous frame's
// attribute cloud at coding positions builds a second tree whose
// transform-domain coefficients predict the current layer
struct InterRaht {
  const int64_t* refMorton = nullptr;  // ascending
  const int32_t* refAttrs = nullptr;   // refCount * numAttrs
  int refCount = 0;
  int treeDepthLimit = 1;       // raht_inter_prediction_depth_minus1+1
  bool enableFilterEstimation = false;  // raht_send_inter_filters
  int skipInitLayers = 0;       // raht_inter_skip_layers
  bool enableCodeLayer = false;  // raht_enable_code_layer
  const int32_t* filterTaps = nullptr;  // abh quantised residues
  int numFilterTaps = 0;
  const int32_t* layerCodeMode = nullptr;  // abh per-depth modes
  int numLayerModes = 0;
  // encoder outputs (filled by urahtProcess when isEncoder):
  std::vector<int32_t> encLayerModes;   // attr_layer_code_mode
  std::vector<int32_t> encFilterTaps;   // quantised residue taps
};

static const int64_t kFixedFilterTaps[7] = {128, 128, 128, 127,
                                            125, 121, 115};

// PCCRAHTACCoefficientEntropyEstimate (RAHT.h:71-97, RAHT.cpp:53-92):
// the encoder's layer-RDO cost model
struct CostEst {
  static const unsigned scaleRes = 1u << 20;
  static const unsigned windowLog2 = 6;
  int probResGt0[3];
  int probResGt1[3];
  double sumCostBits;
  CostEst() {
    for (int k = 0; k < 3; k++)
      probResGt0[k] = probResGt1[k] = int(scaleRes >> 1);
    sumCostBits = 0.;
  }
  void updateCostBits(int32_t value, int k) {
    int log2scaleRes = ilog2(uint64_t(scaleRes));
    double bits = 0;
    bits += value ? log2scaleRes - std::log2(double(probResGt0[k]))
                  : log2scaleRes
                    - std::log2(double(scaleRes - probResGt0[k]));
    int mag = std::abs(value);
    if (mag) {
      bits += mag > 1 ? log2scaleRes - std::log2(double(probResGt1[k]))
                      : log2scaleRes
                        - std::log2(double(scaleRes - probResGt1[k]));
      bits += 1;  // sign
      if (mag > 1) bits += 2.0 * std::log2(mag - 1.0) + 1.0;  // EG0
    }
    sumCostBits += bits;
  }
  void resStatUpdate(int32_t value, int k) {
    probResGt0[k] += value
      ? int(scaleRes - probResGt0[k]) >> windowLog2
      : -(probResGt0[k] >> windowLog2);
    if (value)
      probResGt1[k] += std::abs(value) > 1
        ? int(scaleRes - probResGt1[k]) >> windowLog2
        : -(probResGt1[k] >> windowLog2);
  }
  double costBits() const { return sumCostBits; }
  void resetCostBits() { sumCostBits = 0.; }
};

// getFilterTap (RAHT.cpp:805-847): 128*crosscorr/autocorr by repeated
// subtraction + binary search
static int getFilterTap(int64_t autocorr, int64_t crosscorr) {
  if (crosscorr == 0) return 0;
  bool isneg = crosscorr < 0;
  crosscorr = std::abs(crosscorr);
  if (crosscorr == autocorr) return isneg ? -128 : 128;
  int tapint = 0, tapfrac = 0;
  while (crosscorr >= autocorr) {
    crosscorr -= autocorr;
    tapint += 128;
  }
  if (crosscorr == 0) return isneg ? -tapint : tapint;
  int mn = 0, mx = 128;
  while (mn < mx - 1) {
    int mid = (mn + mx) >> 1;
    int64_t midval = (mid * autocorr) >> 7;
    if (crosscorr == midval) {
      tapfrac = mid;
      return isneg ? -(tapint + tapfrac) : (tapint + tapfrac);
    } else if (crosscorr < midval) {
      mx = mid;
    } else {
      mn = mid;
    }
  }
  tapfrac = mn;
  return isneg ? -(tapint + tapfrac) : (tapint + tapfrac);
}

// estimate_layer_filter (RAHT.cpp:849-975): per-layer correlation of
// transform-domain reference vs current DC-normalised coefficients
static int estimateLayerFilter(
  const std::vector<UNode>& weightsLf, const std::vector<UNode>& weightsLf_ref,
  const std::vector<int>& attrsLf, const std::vector<int>& attrsLf_ref,
  int level, int level_ref, int numAttrs, bool inheritDc,
  bool rahtExtension) {
  int64_t autocorr = 0, crosscorr = 0;
  int layerFilter = 128;
  for (int i = 0, j = 0, iLast, jLast, iEnd = int(weightsLf.size()),
           jEnd = int(weightsLf_ref.size());
       i < iEnd; i = iLast) {
    FP transformBuf[6][8] = {};
    FP transformInterPredBuf[3][8] = {};
    int weights[8 + 8 + 8 + 8] = {};
    int nodeCnt = 0;
    int weights_ref[8 + 8 + 8 + 8] = {};
    bool interNode = false;

    const int64_t cur_pos = weightsLf[i].pos >> (level + 3);
    int64_t ref_pos = j < jEnd - 1
      ? weightsLf_ref[j].pos >> (level_ref + 3)
      : 0x7FFFFFFFFFFFFFFFLL;
    while (j < jEnd - 1 && cur_pos > ref_pos) {
      j++;
      ref_pos = weightsLf_ref[j].pos >> (level_ref + 3);
    }
    if (cur_pos == ref_pos) interNode = true;

    if (interNode) {
      for (jLast = j; jLast < jEnd; jLast++) {
        if (jLast > j
            && !isSibling(weightsLf_ref[jLast].pos, weightsLf_ref[j].pos,
                          level_ref + 3))
          break;
        int nodeIdx = int((weightsLf_ref[jLast].pos >> level_ref) & 0x7);
        weights_ref[nodeIdx] = weightsLf_ref[jLast].weight;
        for (int k = 0; k < numAttrs; k++)
          transformInterPredBuf[k][nodeIdx] =
            FP::fromInt(attrsLf_ref[jLast * numAttrs + k]);
      }
    }

    for (iLast = i; iLast < iEnd; iLast++) {
      if (iLast > i
          && !isSibling(weightsLf[iLast].pos, weightsLf[i].pos, level + 3))
        break;
      int nodeIdx = int((weightsLf[iLast].pos >> level) & 0x7);
      weights[nodeIdx] = weightsLf[iLast].weight;
      if (rahtExtension) nodeCnt++;
      for (int k = 0; k < numAttrs; k++)
        transformBuf[k][nodeIdx] =
          FP::fromInt(attrsLf[iLast * numAttrs + k]);
    }

    mkWeightTree(weights);
    mkWeightTree(weights_ref);

    if (rahtExtension && nodeCnt == 1) interNode = false;

    if (interNode) {
      for (int childIdx = 0; childIdx < 8; childIdx++) {
        if (weights_ref[childIdx] <= 1) continue;
        FP rsqrtWeight;
        uint64_t w = uint64_t(weights_ref[childIdx]);
        int shift = w > 1024 ? ilog2(w - 1) >> 1 : 0;
        rsqrtWeight.val = int64_t(irsqrt(w) >> (40 - shift - kFracBits));
        for (int k = 0; k < numAttrs; k++) {
          transformInterPredBuf[k][childIdx].val >>= shift;
          transformInterPredBuf[k][childIdx] *= rsqrtWeight;
        }
      }
    }

    for (int childIdx = 0; childIdx < 8; childIdx++) {
      if (weights[childIdx] <= 1) continue;
      FP rsqrtWeight;
      uint64_t w = uint64_t(weights[childIdx]);
      int shift = w > 1024 ? ilog2(w - 1) >> 1 : 0;
      rsqrtWeight.val = int64_t(irsqrt(w) >> (40 - shift - kFracBits));
      for (int k = 0; k < numAttrs; k++) {
        transformBuf[k][childIdx].val >>= shift;
        transformBuf[k][childIdx] *= rsqrtWeight;
      }
    }

    if (interNode) {
      fwdTransformBlock222<RahtKernel>(numAttrs, transformBuf, weights);
      fwdTransformBlock222<RahtKernel>(numAttrs, transformInterPredBuf,
                                       weights_ref);
      for (int s = 0; s < 8; s++) {
        int idx = kRahtScanOrder[s];
        if (s > 0 && !weights[24 + idx]) continue;
        if (inheritDc && !idx) continue;
        int shiftbits = kFracBits;
        int64_t refVal = transformInterPredBuf[0][idx].val;
        if (refVal) {
          autocorr += (refVal * refVal) >> shiftbits;
          crosscorr += (refVal * transformBuf[0][idx].val) >> shiftbits;
        }
      }
    }
  }
  if (autocorr) layerFilter = getFilterTap(autocorr, crosscorr);
  return layerFilter;
}

static void urahtProcess(
  bool isEncoder, const PredParams& pp, const QpSet& qpset, int numPoints,
  int numAttrs, const int64_t* positions, int32_t* attributes,
  int32_t* coeffBuf, InterRaht* inter = nullptr,
  const int32_t* pointQp = nullptr) {
  int32_t* coeffBufItK[3] = {
    coeffBuf,
    coeffBuf + numPoints,
    coeffBuf + numPoints * 2,
  };

  if (numPoints == 1) {
    Quant q[2];
    // region QP offset of the lone point (RAHT.cpp:999)
    const int soloQp[2] = {pointQp ? pointQp[0] : 0,
                           pointQp ? pointQp[1] : 0};
    qpset.quantizers(0, soloQp, q);
    for (int k = 0; k < numAttrs; k++) {
      const Quant& qq = q[std::min(k, 1)];
      if (isEncoder) {
        int64_t coeff = attributes[k];
        coeff = qq.quantize(coeff << kFixedPointAttributeShift);
        *coeffBufItK[k]++ = int32_t(coeff);
        attributes[k] = int32_t(divExp2RoundHalfUp(
          qq.scale(coeff), kFixedPointAttributeShift));
      } else {
        int64_t coeff = *coeffBufItK[k]++;
        attributes[k] = int32_t(divExp2RoundHalfUp(
          qq.scale(coeff), kFixedPointAttributeShift));
      }
    }
    return;
  }

  std::vector<UNode> weightsLf, weightsHf;
  std::vector<int> attrsLf, attrsHf;
  weightsLf.reserve(numPoints);
  attrsLf.reserve(numPoints * numAttrs);

  const int regionQpShift = 4;

  for (int i = 0; i < numPoints; i++) {
    UNode n;
    n.pos = positions[i];
    n.weight = 1;
    // region QP box offsets ride the node merge in Q4
    // (RAHT.cpp:1045-1056 regionQpShift; merge at :187)
    n.qp[0] = pointQp ? pointQp[2 * i] << regionQpShift : 0;
    n.qp[1] = pointQp ? pointQp[2 * i + 1] << regionQpShift : 0;
    n.occupancy = 0;
    n.firstChild = n.lastChild = 0;
    weightsLf.push_back(n);
    for (int k = 0; k < numAttrs; k++)
      attrsLf.push_back(attributes[i * numAttrs + k]);
  }
  weightsHf.reserve(numPoints);
  attrsHf.reserve(numPoints * numAttrs);

  // inter reference tree (RAHT.cpp:1064-1115)
  bool enableACInterPred = inter != nullptr && inter->refCount > 0;
  const int treeDepthLimit = inter ? inter->treeDepthLimit : 0;
  std::vector<UNode> weightsLf_ref, weightsHf_ref;
  std::vector<int> attrsLf_ref, attrsHf_ref;
  std::vector<int> levelHfPos_ref;
  if (enableACInterPred) {
    weightsLf_ref.reserve(inter->refCount);
    attrsLf_ref.reserve(size_t(inter->refCount) * numAttrs);
    for (int i = 0; i < inter->refCount; i++) {
      UNode n;
      n.pos = inter->refMorton[i];
      n.weight = 1;
      n.qp[0] = 0;
      n.qp[1] = 0;
      n.occupancy = 0;
      n.firstChild = n.lastChild = 0;
      weightsLf_ref.push_back(n);
      for (int k = 0; k < numAttrs; k++)
        attrsLf_ref.push_back(inter->refAttrs[i * numAttrs + k]);
    }
    weightsHf_ref.reserve(inter->refCount);
    attrsHf_ref.reserve(size_t(inter->refCount) * numAttrs);
  }

  // ascend
  std::vector<int> levelHfPos;
  int numDupNodes = numPoints;
  for (int level = 0, numNodes = int(weightsLf.size()); numNodes > 1;
       level++) {
    levelHfPos.push_back(int(weightsHf.size()));
    if (level == 0) {
      numNodes = reduceUnique(numNodes, numAttrs, &weightsLf, &weightsHf,
                              &attrsLf, &attrsHf, pp.haar);
      numDupNodes -= numNodes;
    } else {
      numNodes = reduceLevel(level, numNodes, numAttrs, &weightsLf,
                             &weightsHf, &attrsLf, &attrsHf, pp.haar);
    }
  }

  if (enableACInterPred) {
    for (int level = 0, numNodes = int(weightsLf_ref.size());
         numNodes > 1; level++) {
      levelHfPos_ref.push_back(int(weightsHf_ref.size()));
      if (level == 0)
        numNodes = reduceUnique(numNodes, numAttrs, &weightsLf_ref,
                                &weightsHf_ref, &attrsLf_ref,
                                &attrsHf_ref, pp.haar);
      else
        numNodes = reduceLevel(level, numNodes, numAttrs,
                               &weightsLf_ref, &weightsHf_ref,
                               &attrsLf_ref, &attrsHf_ref, pp.haar);
    }
  }

  // reconstruction buffers
  std::vector<int64_t> attrRec(numPoints * numAttrs);
  std::vector<int64_t> attrRecParent(numPoints * numAttrs);
  std::vector<int64_t> attrRecUs(numPoints * numAttrs);
  std::vector<int64_t> attrRecParentUs(numPoints * numAttrs);
  std::vector<UNode> weightsParent;
  weightsParent.reserve(numPoints);
  std::vector<int> numParentNeigh(numPoints), numGrandParentNeigh(numPoints);

  int qpLayer = 0;
  int trainZeros = 0;  // RDOQ zero-run state (RAHT.cpp:1160)

  // encoder per-layer inter/intra RDO: a parallel intra track
  // (RAHT.cpp:1123-1164)
  const bool encRDO =
    isEncoder && inter && inter->enableCodeLayer && enableACInterPred;
  std::vector<int64_t> intraAttrRec, intraAttrRecUs;
  std::vector<int32_t> intraACCoeffcients;
  if (encRDO) {
    intraAttrRec.resize(size_t(numPoints) * numAttrs);
    intraAttrRecUs.resize(size_t(numPoints) * numAttrs);
    intraACCoeffcients.resize(size_t(numPoints) * numAttrs);
  }
  int intraTrainZeros = 0;
  CostEst curEstimate, intraEstimate;
  if (isEncoder && inter) {
    inter->encLayerModes.clear();
    inter->encFilterTaps.clear();
  }

  // descend
  weightsLf.resize(1);
  attrsLf.resize(numAttrs);
  if (enableACInterPred) {
    weightsLf_ref.resize(1);
    attrsLf_ref.resize(numAttrs);
  }

  int sumNodes = 0;
  int treeDepth = 0;
  int depth = 0;
  for (int level = int(levelHfPos.size()) - 1,
           level_ref = int(levelHfPos_ref.size()) - 1, isFirst = 1;
       level > 0;
       /*nop*/) {
    int numNodes = int(weightsHf.size()) - levelHfPos[level];
    sumNodes += numNodes;
    weightsLf.resize(weightsLf.size() + numNodes);
    attrsLf.resize(attrsLf.size() + numNodes * numAttrs);
    expandLevel(level, numNodes, numAttrs, &weightsLf, &weightsHf, &attrsLf,
                &attrsHf, pp.haar);
    weightsHf.resize(levelHfPos[level]);
    attrsHf.resize(levelHfPos[level] * numAttrs);

    // inter reference expansion tracks the current level until the
    // ref tree or the depth budget runs out (RAHT.cpp:1177-1194)
    if (level_ref <= 0)
      enableACInterPred = false;
    if (treeDepth >= treeDepthLimit)
      enableACInterPred = false;
    if (enableACInterPred) {
      int numNodes_ref =
        int(weightsHf_ref.size()) - levelHfPos_ref[level_ref];
      weightsLf_ref.resize(weightsLf_ref.size() + numNodes_ref);
      attrsLf_ref.resize(attrsLf_ref.size() + numNodes_ref * numAttrs);
      expandLevel(level_ref, numNodes_ref, numAttrs, &weightsLf_ref,
                  &weightsHf_ref, &attrsLf_ref, &attrsHf_ref, pp.haar);
      weightsHf_ref.resize(levelHfPos_ref[level_ref]);
      attrsHf_ref.resize(levelHfPos_ref[level_ref] * numAttrs);
    }
    const bool enableACRDOInterPred =
      inter && inter->enableCodeLayer && enableACInterPred;

    level--;
    level_ref--;
    if (level % 3) continue;
    if (sumNodes == 0) continue;

    bool inheritDc = !isFirst;
    bool enablePredictionInLvl = inheritDc && pp.predictionEnabled;
    isFirst = 0;

    // layer mode: the encoder RUNS BOTH tracks and decides at the
    // layer end; the decoder reads abh.attr_layer_code_mode
    // (RAHT.cpp:1254-1262)
    bool curLevelEnableACInterPred = false;
    if (isEncoder) {
      curLevelEnableACInterPred =
        enablePredictionInLvl && enableACRDOInterPred;
    } else if (enablePredictionInLvl && enableACRDOInterPred) {
      int mode = depth < (inter ? inter->numLayerModes : 0)
        ? inter->layerCodeMode[depth] : 0;
      curLevelEnableACInterPred = mode != 0;
    }

    int32_t* intraCoeffBufItK[3] = {
      intraACCoeffcients.data(),
      intraACCoeffcients.data() + sumNodes,
      intraACCoeffcients.data() + sumNodes * 2,
    };
    int32_t* intraCoeffBufItBeginK[3] = {
      intraCoeffBufItK[0], intraCoeffBufItK[1], intraCoeffBufItK[2]};
    int32_t* coeffBufItBeginK[3] = {
      coeffBufItK[0], coeffBufItK[1], coeffBufItK[2]};

    if (enablePredictionInLvl) {
      for (auto& ele : weightsParent) ele.occupancy = 0;
      const int parentCount = int(weightsParent.size());
      int it = 0;
      for (int i = 0; i < parentCount; i++) {
        weightsParent[i].firstChild = it++;
        while (it != int(weightsLf.size())
               && !((weightsLf[it].pos ^ weightsParent[i].pos)
                    >> (level + 3)))
          it++;
        weightsParent[i].lastChild = it;
      }
    }

    // select quantiser according to transform layer
    qpLayer = std::min(qpLayer + 1, int(qpset.layers.size()) - 1);

    // inter filter tap for this layer: fixed table, encoder-side
    // estimation, or the quantised residues signalled in the ABH
    // (RAHT.cpp:1268-1305)
    int64_t interFilterTap = 128;
    if (inter) {
      if (!inter->enableFilterEstimation && enableACInterPred
          && treeDepth < treeDepthLimit) {
        int fi = treeDepth < 7 ? treeDepth : 6;
        interFilterTap = kFixedFilterTaps[fi];
      }
      const bool estimateTap = isEncoder && inter->enableFilterEstimation
        && enableACInterPred && treeDepth < treeDepthLimit
        && treeDepth >= inter->skipInitLayers;
      if (estimateTap) {
        int origFilterTap = estimateLayerFilter(
          weightsLf, weightsLf_ref, attrsLf, attrsLf_ref, level,
          level_ref, numAttrs, inheritDc, pp.rahtExtension);
        int residueFilterTap = 128 - origFilterTap;
        const int zeroQp[2] = {0, 0};
        Quant q[2];
        qpset.quantizers(qpLayer, zeroQp, q);
        int64_t quantizedResFilterTap = q[0].quantize(
          int64_t(residueFilterTap) << kFixedPointAttributeShift);
        int64_t rec = divExp2RoundHalfUp(
          q[0].scale(quantizedResFilterTap), kFixedPointAttributeShift);
        inter->encFilterTaps.push_back(int32_t(quantizedResFilterTap));
        interFilterTap = 128 - rec;
      }
      const bool parseTap = !isEncoder && inter->enableFilterEstimation
        && treeDepth < inter->numFilterTaps + inter->skipInitLayers
        && treeDepth >= inter->skipInitLayers;
      if (parseTap) {
        const int zeroQp[2] = {0, 0};
        Quant q[2];
        qpset.quantizers(qpLayer, zeroQp, q);
        int idx = treeDepth - inter->skipInitLayers;
        int64_t rec = divExp2RoundHalfUp(
          q[0].scale(inter->filterTaps[idx]),
          kFixedPointAttributeShift);
        interFilterTap = 128 - rec;
      }
    }

    // previous reconstruction -> attrRecParent
    std::swap(attrRec, attrRecParent);
    std::swap(attrRecUs, attrRecParentUs);
    std::swap(numParentNeigh, numGrandParentNeigh);
    int attrRecParentUsIt = 0;
    int attrRecParentIt = 0;
    int weightsParentIt = 0;
    int numGrandParentNeighIt = 0;

    for (int i = 0, j = 0, iLast, jLast,
             iEnd = int(weightsLf.size()),
             jEnd = int(weightsLf_ref.size());
         i < iEnd; i = iLast) {
      FP transformBuf[6][8] = {};
      FP(*transformPredBuf)[8] = &transformBuf[numAttrs];
      FP transformInterPredBuf[3][8] = {};
      FP transformIntraBuf[3][8] = {};
      FP transformIntraPredBuf[3][8] = {};
      int weights[8 + 8 + 8 + 8] = {};
      int weights_ref[8 + 8 + 8 + 8] = {};
      int nodeQp[8][2] = {};
      uint8_t occupancy = 0;
      int nodeCnt = 0;

      // inter node alignment: advance the ref cursor to the sibling
      // group at the same position (RAHT.cpp:1316-1334)
      bool interNode = false;
      if (curLevelEnableACInterPred
          || (enableACInterPred && !enablePredictionInLvl)) {
        const int64_t cur_pos = weightsLf[i].pos >> (level + 3);
        int64_t ref_pos = weightsLf_ref[j].pos >> (level_ref + 3);
        while (j < jEnd - 1 && cur_pos > ref_pos) {
          j++;
          ref_pos = weightsLf_ref[j].pos >> (level_ref + 3);
        }
        if (cur_pos == ref_pos)
          interNode = true;
      }
      if (interNode) {
        for (jLast = j; jLast < jEnd; jLast++) {
          if (jLast > j
              && !isSibling(weightsLf_ref[jLast].pos,
                            weightsLf_ref[j].pos, level_ref + 3))
            break;
          int nodeIdx = int((weightsLf_ref[jLast].pos >> level_ref)
                            & 0x7);
          weights_ref[nodeIdx] = weightsLf_ref[jLast].weight;
          for (int k = 0; k < numAttrs; k++)
            transformInterPredBuf[k][nodeIdx] =
              FP::fromInt(attrsLf_ref[jLast * numAttrs + k]);
        }
      }

      for (iLast = i; iLast < iEnd; iLast++) {
        int nextNode =
          iLast > i
          && !isSibling(weightsLf[iLast].pos, weightsLf[i].pos, level + 3);
        if (nextNode) break;
        int nodeIdx = int((weightsLf[iLast].pos >> level) & 0x7);
        weights[nodeIdx] = weightsLf[iLast].weight;
        nodeQp[nodeIdx][0] = weightsLf[iLast].qp[0] >> regionQpShift;
        nodeQp[nodeIdx][1] = weightsLf[iLast].qp[1] >> regionQpShift;
        occupancy |= uint8_t(1 << nodeIdx);
        if (pp.rahtExtension) nodeCnt++;
        if (isEncoder) {
          for (int k = 0; k < numAttrs; k++)
            transformBuf[k][nodeIdx] =
              FP::fromInt(attrsLf[iLast * numAttrs + k]);
        }
      }

      mkWeightTree(weights);
      mkWeightTree(weights_ref);

      if (!inheritDc) {
        for (int jj = i, nodeIdx = 0; nodeIdx < 8; nodeIdx++) {
          if (!weights[nodeIdx]) continue;
          numParentNeigh[jj++] = 19;
        }
      }
      if (pp.rahtExtension && nodeCnt == 1)
        interNode = false;

      // intra prediction
      bool enablePrediction = enablePredictionInLvl;
      if (enablePredictionInLvl) {
        weightsParent[weightsParentIt].occupancy = occupancy;
        int parentNeighIdx[19];
        int childNeighIdx[12][8];
        int parentNeighCount = 0;
        if (pp.rahtExtension && nodeCnt == 1) {
          enablePrediction = false;
          parentNeighCount = 19;
        } else if (numGrandParentNeigh[numGrandParentNeighIt]
                   < pp.threshold0) {
          enablePrediction = false;
        } else {
          findNeighbours(weightsParent, 0, int(weightsParent.size()),
                         weightsParentIt, weightsLf, 0, level + 3, occupancy,
                         parentNeighIdx, childNeighIdx, pp.subnodePrediction,
                         pp.searchRange);
          for (int n = 0; n < 19; n++)
            parentNeighCount += (parentNeighIdx[n] != -1);
          if (parentNeighCount < pp.threshold1) {
            enablePrediction = false;
          } else {
            int64_t limitLow = 0, limitHigh = 0;
            intraDcPred(numAttrs, parentNeighIdx, childNeighIdx, occupancy,
                        attrRecParent, attrRec, transformPredBuf, pp,
                        limitLow, limitHigh,
                        (isEncoder && curLevelEnableACInterPred)
                          ? &intraAttrRec : nullptr,
                        (isEncoder && curLevelEnableACInterPred)
                          ? transformIntraPredBuf : nullptr);
          }
        }
        for (int j = i, nodeIdx = 0; nodeIdx < 8; nodeIdx++) {
          if (!weights[nodeIdx]) continue;
          numParentNeigh[j++] = parentNeighCount;
        }
      }

      if (inheritDc) {
        weightsParentIt++;
        numGrandParentNeighIt++;
      }

      const bool enableIntraPrediction =
        curLevelEnableACInterPred && enablePrediction;

      if (!pp.haar) {
        // normalise the inter reference block; the decoder drops the
        // intra prediction for inter nodes (RAHT.cpp:1448-1466)
        if (interNode) {
          for (int childIdx = 0; childIdx < 8; childIdx++) {
            if (weights_ref[childIdx] <= 1) continue;
            FP rsqrtWeight;
            uint64_t w = uint64_t(weights_ref[childIdx]);
            int shift = w > 1024 ? ilog2(w - 1) >> 1 : 0;
            rsqrtWeight.val =
              int64_t(irsqrt(w) >> (40 - shift - kFracBits));
            for (int k = 0; k < numAttrs; k++) {
              transformInterPredBuf[k][childIdx].val >>= shift;
              transformInterPredBuf[k][childIdx] *= rsqrtWeight;
            }
          }
          if (!isEncoder)
            enablePrediction = false;
        }
        // normalise summed (encoder) and predicted values
        for (int childIdx = 0; childIdx < 8; childIdx++) {
          if (weights[childIdx] <= 1) continue;
          if (isEncoder) {
            FP rsqrtWeight;
            uint64_t w = uint64_t(weights[childIdx]);
            int shift = w > 1024 ? ilog2(w - 1) >> 1 : 0;
            rsqrtWeight.val =
              int64_t(irsqrt(w) >> (40 - shift - kFracBits));
            for (int k = 0; k < numAttrs; k++) {
              transformBuf[k][childIdx].val >>= shift;
              transformBuf[k][childIdx] *= rsqrtWeight;
            }
          }
          FP sqrtWeight;
          if (enablePrediction) {
            sqrtWeight.val = int64_t(
              isqrt(uint64_t(weights[childIdx]) << (2 * kFracBits)));
            for (int k = 0; k < numAttrs; k++)
              transformPredBuf[k][childIdx] *= sqrtWeight;
          }
          if (isEncoder && enableIntraPrediction) {
            for (int k = 0; k < numAttrs; k++)
              transformIntraPredBuf[k][childIdx] *= sqrtWeight;
          }
        }
      }

      // forward transform: encoder transforms sums (and prediction);
      // decoder transforms prediction only (RAHT.cpp:1500-1549); for
      // inter nodes the (filtered) reference block replaces the
      // transform-domain prediction
      if (pp.haar) {
        if (isEncoder && enablePrediction)
          fwdTransformBlock222<HaarKernel>(2 * numAttrs, transformBuf,
                                           weights);
        else if (isEncoder)
          fwdTransformBlock222<HaarKernel>(numAttrs, transformBuf,
                                           weights);
        else if (enablePrediction)
          fwdTransformBlock222<HaarKernel>(numAttrs, transformPredBuf,
                                           weights);
        if (interNode) {
          fwdTransformBlock222<HaarKernel>(numAttrs,
                                           transformInterPredBuf,
                                           weights_ref);
          for (int childIdx = 0; childIdx < 8; childIdx++)
            for (int k = 0; k < numAttrs; k++)
              // NB: integer haar is not compatible with the filter
              transformPredBuf[k][childIdx].val =
                transformInterPredBuf[k][childIdx].val;
          enablePrediction = true;
        }
        if (isEncoder && enableIntraPrediction)
          fwdTransformBlock222<HaarKernel>(numAttrs, transformIntraPredBuf,
                                           weights);
      } else {
        if (isEncoder && enablePrediction)
          fwdTransformBlock222<RahtKernel>(2 * numAttrs, transformBuf,
                                           weights);
        else if (isEncoder)
          fwdTransformBlock222<RahtKernel>(numAttrs, transformBuf,
                                           weights);
        else if (enablePrediction)
          fwdTransformBlock222<RahtKernel>(numAttrs, transformPredBuf,
                                           weights);
        if (interNode) {
          fwdTransformBlock222<RahtKernel>(numAttrs,
                                           transformInterPredBuf,
                                           weights_ref);
          for (int childIdx = 0; childIdx < 8; childIdx++)
            for (int k = 0; k < numAttrs; k++) {
              int64_t refVal = transformInterPredBuf[k][childIdx].val;
              int64_t filteredVal =
                (inter && treeDepth < inter->skipInitLayers)
                ? refVal : (refVal * interFilterTap) >> 7;
              transformPredBuf[k][childIdx].val = filteredVal;
            }
          enablePrediction = true;
        }
        if (isEncoder && enableIntraPrediction)
          fwdTransformBlock222<RahtKernel>(numAttrs, transformIntraPredBuf,
                                           weights);
      }

      // intra track keeps the pre-subtraction coefficients
      // (RAHT.cpp:1556-1557)
      if (isEncoder && curLevelEnableACInterPred)
        std::copy_n(&transformBuf[0][0], 8 * numAttrs,
                    &transformIntraBuf[0][0]);

      // per-coefficient (scanBlock order, RAHT.cpp:776-795):
      //  - encoder: subtract prediction, RDOQ, quantise, write
      //  - decoder: read quantised coefficients
      //  - both: inverse quantise + add transform-domain prediction
      {
        // there is always the DC coefficient
        for (int s = 0; s < 8; s++) {
          int idx = kRahtScanOrder[s];
          if (s > 0 && !weights[24 + idx]) continue;
          if (inheritDc && !idx) continue;

          bool flagRDOQ = false;
          bool intraFlagRDOQ = false;
          if (isEncoder) {
            if (enablePrediction) {
              for (int k = 0; k < numAttrs; k++)
                transformBuf[k][idx] -= transformPredBuf[k][idx];
            }
            if (enableIntraPrediction) {
              for (int k = 0; k < numAttrs; k++)
                transformIntraBuf[k][idx] -= transformIntraPredBuf[k][idx];
            }
            // RDOQ zero-row decision, both tracks (RAHT.cpp:1576-1667)
            if (!pp.haar) {
              int64_t Dist2 = 0;
              int Ratecoeff = 0;
              int64_t lambda0 = 0;
              int64_t sumCoeff = 0;
              int64_t intraDist2 = 0;
              int intraRatecoeff = 0;
              int64_t intraSumCoeff = 0;
              int qoff0[2] = {nodeQp[idx][0], nodeQp[idx][1]};
              Quant q0[2];
              qpset.quantizers(qpLayer, qoff0, q0);
              for (int k = 0; k < numAttrs; k++) {
                const Quant& qq = q0[std::min(k, 1)];
                int64_t coeff = transformBuf[k][idx].round();
                Dist2 += coeff * coeff;
                int64_t Qcoeff =
                  qq.quantize(coeff << kFixedPointAttributeShift);
                int64_t a = Qcoeff < 0 ? -Qcoeff : Qcoeff;
                sumCoeff += a;
                Ratecoeff += a < 15 ? kLUTlog[a] : kLUTlog[15];
                if (!k) lambda0 = qq.scale(1);
                if (curLevelEnableACInterPred) {
                  int64_t intraCoeff = transformIntraBuf[k][idx].round();
                  intraDist2 += intraCoeff * intraCoeff;
                  int64_t iQ =
                    qq.quantize(intraCoeff << kFixedPointAttributeShift);
                  int64_t ia = iQ < 0 ? -iQ : iQ;
                  intraSumCoeff += ia;
                  intraRatecoeff += ia < 15 ? kLUTlog[ia] : kLUTlog[15];
                }
              }
              const int64_t lambda =
                lambda0 * lambda0 * (numAttrs == 1 ? 25 : 35);
              if (sumCoeff < 3) {
                int Rate = kLUTbins[trainZeros > 10 ? 10 : trainZeros];
                if (trainZeros > 10) {
                  int temp = trainZeros - 11;
                  temp += 1;
                  int a = 0;
                  while (temp) {
                    a++;
                    temp >>= 1;
                  }
                  Rate += 2 * a - 1;
                  Rate += 2;
                }
                Rate += (Ratecoeff + 128) >> 8;
                flagRDOQ = (Dist2 << 26) < lambda * Rate;
              }
              if (curLevelEnableACInterPred && intraSumCoeff < 3) {
                int intraRate =
                  kLUTbins[intraTrainZeros > 10 ? 10 : intraTrainZeros];
                if (intraTrainZeros > 10) {
                  int temp = intraTrainZeros - 11;
                  temp += 1;
                  int a = 0;
                  while (temp) {
                    a++;
                    temp >>= 1;
                  }
                  intraRate += 2 * a - 1;
                  intraRate += 2;
                }
                intraRate += (intraRatecoeff + 128) >> 8;
                intraFlagRDOQ = (intraDist2 << 26) < lambda * intraRate;
              }
              if (flagRDOQ || sumCoeff == 0)
                trainZeros++;
              else
                trainZeros = 0;
              if (curLevelEnableACInterPred) {
                if (intraFlagRDOQ || intraSumCoeff == 0)
                  intraTrainZeros++;
                else
                  intraTrainZeros = 0;
              }
            }
          }

          int qoff[2] = {nodeQp[idx][0], nodeQp[idx][1]};
          Quant q[2];
          qpset.quantizers(qpLayer, qoff, q);
          for (int k = 0; k < numAttrs; k++) {
            const Quant& qq = q[std::min(k, 1)];
            if (isEncoder) {
              if (flagRDOQ) transformBuf[k][idx].val = 0;
              if (intraFlagRDOQ) transformIntraBuf[k][idx].val = 0;
              int64_t coeff = transformBuf[k][idx].round();
              coeff = qq.quantize(coeff << kFixedPointAttributeShift);
              if (curLevelEnableACInterPred)
                curEstimate.updateCostBits(int32_t(coeff), k);
              *coeffBufItK[k]++ = int32_t(coeff);
              transformPredBuf[k][idx] += FP::fromInt(divExp2RoundHalfUp(
                qq.scale(coeff), kFixedPointAttributeShift));
              if (curLevelEnableACInterPred) {
                curEstimate.resStatUpdate(int32_t(coeff), k);
                int64_t intraCoeff = transformIntraBuf[k][idx].round();
                intraCoeff =
                  qq.quantize(intraCoeff << kFixedPointAttributeShift);
                intraEstimate.updateCostBits(int32_t(intraCoeff), k);
                *intraCoeffBufItK[k]++ = int32_t(intraCoeff);
                transformIntraPredBuf[k][idx] +=
                  FP::fromInt(divExp2RoundHalfUp(
                    qq.scale(intraCoeff), kFixedPointAttributeShift));
                intraEstimate.resStatUpdate(int32_t(intraCoeff), k);
              }
            } else {
              int64_t coeff = *coeffBufItK[k]++;
              transformPredBuf[k][idx] += FP::fromInt(divExp2RoundHalfUp(
                qq.scale(coeff), kFixedPointAttributeShift));
            }
          }
        }
      }

      // replace DC coefficient with parent if inheritable
      if (inheritDc) {
        for (int k = 0; k < numAttrs; k++) {
          attrRecParentIt++;
          int64_t val = attrRecParentUs[attrRecParentUsIt++];
          if (pp.rahtExtension)
            transformPredBuf[k][0].val = val;
          else if (val > 0)
            transformPredBuf[k][0].val = val << (15 - 2);
          else
            transformPredBuf[k][0].val = -((-val) << (15 - 2));
          if (isEncoder && curLevelEnableACInterPred)
            transformIntraPredBuf[k][0].val = transformPredBuf[k][0].val;
        }
      }

      if (pp.haar) {
        invTransformBlock222<HaarKernel>(numAttrs, transformPredBuf, weights);
        if (isEncoder && curLevelEnableACInterPred)
          invTransformBlock222<HaarKernel>(numAttrs, transformIntraPredBuf,
                                           weights);
      } else {
        invTransformBlock222<RahtKernel>(numAttrs, transformPredBuf, weights);
        if (isEncoder && curLevelEnableACInterPred)
          invTransformBlock222<RahtKernel>(numAttrs, transformIntraPredBuf,
                                           weights);
      }

      for (int j = i, nodeIdx = 0; nodeIdx < 8; nodeIdx++) {
        if (!weights[nodeIdx]) continue;
        const bool dual = isEncoder && curLevelEnableACInterPred;
        for (int k = 0; k < numAttrs; k++) {
          if (pp.rahtExtension) {
            attrRecUs[j * numAttrs + k] = transformPredBuf[k][nodeIdx].val;
            if (dual)
              intraAttrRecUs[j * numAttrs + k] =
                transformIntraPredBuf[k][nodeIdx].val;
          } else {
            FP temp = transformPredBuf[k][nodeIdx];
            temp.val <<= 2;
            attrRecUs[j * numAttrs + k] = temp.round();
            if (dual) {
              temp = transformIntraPredBuf[k][nodeIdx];
              temp.val <<= 2;
              intraAttrRecUs[j * numAttrs + k] = temp.round();
            }
          }
        }
        // scale values for next level
        if (!pp.haar) {
          if (weights[nodeIdx] > 1) {
            FP rsqrtWeight;
            uint64_t w = uint64_t(weights[nodeIdx]);
            int shift = w > 1024 ? ilog2(w - 1) >> 1 : 0;
            rsqrtWeight.val =
              int64_t(irsqrt(w) >> (40 - shift - kFracBits));
            for (int k = 0; k < numAttrs; k++) {
              transformPredBuf[k][nodeIdx].val >>= shift;
              transformPredBuf[k][nodeIdx] *= rsqrtWeight;
              if (dual) {
                transformIntraPredBuf[k][nodeIdx].val >>= shift;
                transformIntraPredBuf[k][nodeIdx] *= rsqrtWeight;
              }
            }
          }
        }
        for (int k = 0; k < numAttrs; k++) {
          attrRec[j * numAttrs + k] = pp.rahtExtension
            ? transformPredBuf[k][nodeIdx].val
            : transformPredBuf[k][nodeIdx].round();
          if (dual)
            intraAttrRec[j * numAttrs + k] = pp.rahtExtension
              ? transformIntraPredBuf[k][nodeIdx].val
              : transformIntraPredBuf[k][nodeIdx].round();
        }
        j++;
      }
    }

    // layer-end inter/intra decision (RAHT.cpp:1810-1833): pick the
    // cheaper track, copy its coefficients/reconstruction forward
    if (isEncoder && curLevelEnableACInterPred) {
      double curCost = curEstimate.costBits();
      double intraCost = intraEstimate.costBits();
      if (intraCost < curCost) {
        for (int k = 0; k < numAttrs; ++k)
          std::copy_n(intraCoeffBufItBeginK[k], sumNodes,
                      coeffBufItBeginK[k]);
        std::swap(intraAttrRec, attrRec);
        std::swap(intraAttrRecUs, attrRecUs);
        curEstimate = intraEstimate;
        inter->encLayerModes.push_back(0);
        trainZeros = intraTrainZeros;
      } else {
        intraEstimate = curEstimate;
        inter->encLayerModes.push_back(1);
        intraTrainZeros = trainZeros;
      }
      curEstimate.resetCostBits();
      intraEstimate.resetCostBits();
    }

    if (enablePredictionInLvl && enableACRDOInterPred)
      ++depth;
    sumNodes = 0;
    weightsParent = weightsLf;
    treeDepth++;
  }

  // process duplicate points at level 0 (RAHT.cpp:1839-1965)
  if (numDupNodes) {
    std::swap(attrRec, attrRecParent);
    int attrRecParentIt = 0;
    int attrsHfIt = 0;

    for (int i = 0, out = 0, iEnd = int(weightsLf.size()); i < iEnd; i++) {
      int weight = weightsLf[i].weight;
      if (weight == 1) {
        for (int k = 0; k < numAttrs; k++)
          attrRec[out++] = attrRecParent[attrRecParentIt++];
        continue;
      }
      int nodeQp[2] = {weightsLf[i].qp[0] >> regionQpShift,
                       weightsLf[i].qp[1] >> regionQpShift};

      FP attrSum[3];
      FP attrRecDc[3];
      FP sqrtWeight;
      sqrtWeight.val =
        int64_t(isqrt(uint64_t(weight) << (2 * kFracBits)));
      int64_t sumCoeff = 0;
      for (int k = 0; k < numAttrs; k++) {
        if (isEncoder) attrSum[k] = FP::fromInt(attrsLf[i * numAttrs + k]);
        if (pp.rahtExtension)
          attrRecDc[k].val = attrRecParent[attrRecParentIt++];
        else
          attrRecDc[k] = FP::fromInt(attrRecParent[attrRecParentIt++]);
        if (!pp.haar) attrRecDc[k] *= sqrtWeight;
      }

      FP rsqrtWeight;
      for (int w = weight - 1; w > 0; w--) {
        RahtKernel kernel(w, 1);
        HaarKernel haarkernel(w, 1);
        int shift = w > 1024 ? ilog2(uint64_t(w - 1)) >> 1 : 0;
        if (isEncoder)
          rsqrtWeight.val =
            int64_t(irsqrt(uint64_t(w)) >> (40 - shift - kFracBits));
        Quant q[2];
        qpset.quantizers(qpLayer, nodeQp, q);
        for (int k = 0; k < numAttrs; k++) {
          const Quant& qq = q[std::min(k, 1)];
          FP transformBuf[2];
          if (isEncoder) {
            // invert the initial reduction (RAHT.cpp:1895-1931)
            transformBuf[1] =
              FP::fromInt(attrsHf[attrsHfIt + (w - 1) * numAttrs + k]);
            if (pp.haar) {
              attrSum[k].val -= transformBuf[1].val >> 1;
              transformBuf[1].val += attrSum[k].val;
              transformBuf[0] = attrSum[k];
            } else {
              attrSum[k] -= transformBuf[1];
              transformBuf[0] = attrSum[k];
              transformBuf[0].val >>= shift;
              transformBuf[0] *= rsqrtWeight;
            }
            if (pp.haar)
              haarkernel.fwd(transformBuf[0], transformBuf[1],
                             &transformBuf[0], &transformBuf[1]);
            else
              kernel.fwd(transformBuf[0], transformBuf[1],
                         &transformBuf[0], &transformBuf[1]);
            int64_t coeff = transformBuf[1].round();
            coeff = qq.quantize(coeff << kFixedPointAttributeShift);
            *coeffBufItK[k]++ = int32_t(coeff);
            transformBuf[1] = FP::fromInt(divExp2RoundHalfUp(
              qq.scale(coeff), kFixedPointAttributeShift));
            // NB: the reference re-quantises the already-quantised
            // coefficient here; reproduced verbatim (RAHT.cpp:1926)
            int64_t rq = qq.quantize(coeff << kFixedPointAttributeShift);
            sumCoeff += rq < 0 ? -rq : rq;
          } else {
            int64_t coeff = *coeffBufItK[k]++;
            transformBuf[1] = FP::fromInt(divExp2RoundHalfUp(
              qq.scale(coeff), kFixedPointAttributeShift));
          }
          // inherit the DC value
          transformBuf[0] = attrRecDc[k];
          if (pp.haar)
            haarkernel.inv(transformBuf[0], transformBuf[1],
                           &transformBuf[0], &transformBuf[1]);
          else
            kernel.inv(transformBuf[0], transformBuf[1], &transformBuf[0],
                       &transformBuf[1]);
          attrRecDc[k] = transformBuf[0];
          attrRec[out + w * numAttrs + k] =
            pp.rahtExtension ? transformBuf[1].val : transformBuf[1].round();
          if (w == 1)
            attrRec[out + k] =
              pp.rahtExtension ? transformBuf[0].val : transformBuf[0].round();
        }
        // Track RL for RDOQ (RAHT.cpp:1955-1961)
        if (isEncoder) {
          if (sumCoeff == 0)
            trainZeros++;
          else
            trainZeros = 0;
        }
      }

      attrsHfIt += (weight - 1) * numAttrs;
      out += weight * numAttrs;
    }
  }

  // write-back reconstructed attributes (RAHT.cpp:1969-1977)
  if (pp.rahtExtension) {
    int32_t* outIt = attributes;
    for (auto& attr : attrRec) {
      attr += kOneHalf;
      *(outIt++) = int32_t(attr >> kFracBits);
    }
  } else {
    int32_t* outIt = attributes;
    for (auto& attr : attrRec) *(outIt++) = int32_t(attr);
  }
}

}  // namespace refattr

// ---------------------------------------------------------------------------
// C entry point
// ---------------------------------------------------------------------------

extern "C" {

// Decode one intra RAHT attribute brick payload (bytes after the ABH)
// to reconstructed attributes in morton-sorted order.
//
//   payload        residual AEC stream
//   mortonSorted   voxelCount morton codes, ascending (slice-global
//                  positions, mortonAddr layout: x high)
//   numAttrs       1 (reflectance) or 3 (colour)
//   qpLayers       numQpLayers*2 ints: lumaQp, chromaQpOffset per layer
//   bitdepth       attribute bitdepth for the final clip
//   params         RahtPredictionParams + flags:
//                  [0] raht_prediction_enabled  [1] integer_haar
//                  [2] threshold0  [3] threshold1
//                  [4] subnode_prediction_enabled  [5] search_range
//                  [6] raht_extension  [7] bypass_no_update
//                  [8..26] predWeightParent[19]
//                  [27..38] predWeightChild[12]
//   attrsOut       voxelCount*numAttrs int32, sorted order
//
// Returns 0 on success, negative on unsupported input.
//   pointQp        optional voxelCount*2 int32 region-QP offsets per
//                  sorted point (luma, chroma), or NULL
int tmc13ref_decode_raht_attr(
  const uint8_t* payload, int payload_len, const int64_t* mortonSorted,
  int voxelCount, int numAttrs, const int32_t* qpLayers, int numQpLayers,
  int bitdepth, const int32_t* params, int32_t* attrsOut,
  const int32_t* pointQp) {
  using namespace refattr;

  if (numAttrs != 1 && numAttrs != 3) return -1;
  if (voxelCount <= 0) return -2;

  PredParams pp;
  pp.predictionEnabled = params[0] != 0;
  pp.haar = params[1] != 0;
  pp.threshold0 = params[2];
  pp.threshold1 = params[3];
  pp.subnodePrediction = params[4] != 0;
  pp.searchRange = params[5];
  pp.rahtExtension = params[6] != 0;
  for (int i = 0; i < 19; i++) pp.predWeightParent[i] = params[8 + i];
  for (int i = 0; i < 12; i++) pp.predWeightChild[i] = params[27 + i];

  QpSet qpset;
  qpset.maxQp = 51 + 6 * (bitdepth - 8);
  for (int l = 0; l < numQpLayers; l++)
    qpset.layers.push_back({qpLayers[2 * l], qpLayers[2 * l + 1]});

  // entropy decode of the coefficient stream
  // (AttributeDecoder.cpp:554-566 refl / 637-653 colour)
  ArithDec aec;
  aec.chunked = params[39] != 0;
  aec.init(payload, size_t(payload_len));
  aec.bypassNoUpdate = params[7] != 0;
  AttrCtx ctx;
  ctx.init();

  std::vector<int32_t> coefficients(size_t(numAttrs) * voxelCount, 0);
  int zeroRunRem = 0;
  for (int n = 0; n < voxelCount; ++n) {
    if (--zeroRunRem < 0) zeroRunRem = decodeRunLength(aec, ctx);
    if (numAttrs == 1) {
      int32_t value = 0;
      if (!zeroRunRem) value = decodeScalar(aec, ctx);
      coefficients[n] = value;
    } else {
      int32_t values[3] = {};
      if (!zeroRunRem) decodeTriplet(aec, ctx, values);
      for (int d = 0; d < 3; ++d) coefficients[voxelCount * d + n] = values[d];
    }
  }

  std::vector<int32_t> attributes(size_t(numAttrs) * voxelCount, 0);
  urahtProcess(false, pp, qpset, voxelCount, numAttrs, mortonSorted,
               attributes.data(), coefficients.data(), nullptr, pointQp);

  const int32_t clipMax = (1 << bitdepth) - 1;
  for (int n = 0; n < voxelCount * numAttrs; n++)
    attrsOut[n] = std::min(std::max(attributes[n], 0), clipMax);

  return 0;
}

// Decode one INTER RAHT attribute brick: like
// tmc13ref_decode_raht_attr but with the previous frame's attribute
// cloud (morton-sorted coding positions + reconstructed values) as
// the transform-domain reference (AttributeInterPredParams
// paramsForInterRAHT; RAHT.cpp inter paths).
//   iparams: [0] raht_inter_prediction_depth_minus1+1
//            [1] raht_send_inter_filters  [2] raht_inter_skip_layers
//            [3] raht_enable_code_layer
//            [4] num filter taps          [5] num layer modes
int tmc13ref_decode_raht_attr_inter(
  const uint8_t* payload, int payload_len, const int64_t* mortonSorted,
  int voxelCount, int numAttrs, const int32_t* qpLayers, int numQpLayers,
  int bitdepth, const int32_t* params,
  const int64_t* refMorton, const int32_t* refAttrs, int refCount,
  const int32_t* iparams, const int32_t* filterTaps,
  const int32_t* layerModes, int32_t* attrsOut) {
  using namespace refattr;

  if (numAttrs != 1 && numAttrs != 3) return -1;
  if (voxelCount <= 0) return -2;

  PredParams pp;
  pp.predictionEnabled = params[0] != 0;
  pp.haar = params[1] != 0;
  pp.threshold0 = params[2];
  pp.threshold1 = params[3];
  pp.subnodePrediction = params[4] != 0;
  pp.searchRange = params[5];
  pp.rahtExtension = params[6] != 0;
  for (int i = 0; i < 19; i++) pp.predWeightParent[i] = params[8 + i];
  for (int i = 0; i < 12; i++) pp.predWeightChild[i] = params[27 + i];

  QpSet qpset;
  qpset.maxQp = 51 + 6 * (bitdepth - 8);
  for (int l = 0; l < numQpLayers; l++)
    qpset.layers.push_back({qpLayers[2 * l], qpLayers[2 * l + 1]});

  ArithDec aec;
  aec.chunked = params[39] != 0;
  aec.init(payload, size_t(payload_len));
  aec.bypassNoUpdate = params[7] != 0;
  AttrCtx ctx;
  ctx.init();

  std::vector<int32_t> coefficients(size_t(numAttrs) * voxelCount, 0);
  int zeroRunRem = 0;
  for (int n = 0; n < voxelCount; ++n) {
    if (--zeroRunRem < 0) zeroRunRem = decodeRunLength(aec, ctx);
    if (numAttrs == 1) {
      int32_t value = 0;
      if (!zeroRunRem) value = decodeScalar(aec, ctx);
      coefficients[n] = value;
    } else {
      int32_t values[3] = {};
      if (!zeroRunRem) decodeTriplet(aec, ctx, values);
      for (int d = 0; d < 3; ++d)
        coefficients[voxelCount * d + n] = values[d];
    }
  }

  InterRaht inter;
  inter.refMorton = refMorton;
  inter.refAttrs = refAttrs;
  inter.refCount = refCount;
  inter.treeDepthLimit = iparams[0];
  inter.enableFilterEstimation = iparams[1] != 0;
  inter.skipInitLayers = iparams[2];
  inter.enableCodeLayer = iparams[3] != 0;
  inter.numFilterTaps = iparams[4];
  inter.numLayerModes = iparams[5];
  inter.filterTaps = filterTaps;
  inter.layerCodeMode = layerModes;

  std::vector<int32_t> attributes(size_t(numAttrs) * voxelCount, 0);
  urahtProcess(false, pp, qpset, voxelCount, numAttrs, mortonSorted,
               attributes.data(), coefficients.data(), &inter);

  const int32_t clipMax = (1 << bitdepth) - 1;
  for (int n = 0; n < voxelCount * numAttrs; n++)
    attrsOut[n] = std::min(std::max(attributes[n], 0), clipMax);

  return 0;
}

// Encode one intra RAHT attribute brick payload (bytes after the ABH),
// byte-identical to the reference encoder for the same configuration
// (AttributeEncoder.cpp:1307-1376 encodeColorsTransformRaht /
// encodeReflectancesTransformRaht + PCCResidualsEncoder:228-307).
//
//   attrsIn   voxelCount*numAttrs int32 attributes in morton-sorted
//             order (coded colour space)
//   attrsRec  reconstructed attributes out (closed loop), sorted order
//   payloadOut / payloadCap  output AEC bytes
// Returns payload byte count, negative on error.
int tmc13ref_encode_raht_attr(
  const int64_t* mortonSorted, int voxelCount, int numAttrs,
  const int32_t* attrsIn, const int32_t* qpLayers, int numQpLayers,
  int bitdepth, const int32_t* params, int32_t* attrsRec,
  uint8_t* payloadOut, int payloadCap, const int32_t* pointQp) {
  using namespace refattr;

  if (numAttrs != 1 && numAttrs != 3) return -1;
  if (voxelCount <= 0) return -2;

  PredParams pp;
  pp.predictionEnabled = params[0] != 0;
  pp.haar = params[1] != 0;
  pp.threshold0 = params[2];
  pp.threshold1 = params[3];
  pp.subnodePrediction = params[4] != 0;
  pp.searchRange = params[5];
  pp.rahtExtension = params[6] != 0;
  for (int i = 0; i < 19; i++) pp.predWeightParent[i] = params[8 + i];
  for (int i = 0; i < 12; i++) pp.predWeightChild[i] = params[27 + i];

  QpSet qpset;
  qpset.maxQp = 51 + 6 * (bitdepth - 8);
  for (int l = 0; l < numQpLayers; l++)
    qpset.layers.push_back({qpLayers[2 * l], qpLayers[2 * l + 1]});

  std::vector<int32_t> attributes(attrsIn,
                                  attrsIn + size_t(numAttrs) * voxelCount);
  std::vector<int32_t> coefficients(size_t(numAttrs) * voxelCount, 0);
  urahtProcess(true, pp, qpset, voxelCount, numAttrs, mortonSorted,
               attributes.data(), coefficients.data(), nullptr, pointQp);

  // entropy encode (zero-run over rows,
  // AttributeEncoder.cpp:1346-1362 / :1489-1505)
  obufcore::ArithEnc aec;
  aec.chunked = params[39] != 0;
  aec.init();
  aec.bypassNoUpdate = params[7] != 0;
  AttrCtx ctx;
  ctx.init();

  int zeroRun = 0;
  for (int n = 0; n < voxelCount; ++n) {
    if (numAttrs == 1) {
      int32_t v = coefficients[n];
      if (!v) {
        ++zeroRun;
      } else {
        encodeRunLength(aec, ctx, zeroRun);
        encodeScalar(aec, ctx, v);
        zeroRun = 0;
      }
    } else {
      int32_t v0 = coefficients[n];
      int32_t v1 = coefficients[voxelCount + n];
      int32_t v2 = coefficients[2 * voxelCount + n];
      if (!v0 && !v1 && !v2) {
        ++zeroRun;
      } else {
        encodeRunLength(aec, ctx, zeroRun);
        encodeTriplet(aec, ctx, v0, v1, v2);
        zeroRun = 0;
      }
    }
  }
  if (zeroRun) encodeRunLength(aec, ctx, zeroRun);
  aec.flush();

  if (int(aec.out.size()) > payloadCap) return -3;
  std::copy(aec.out.begin(), aec.out.end(), payloadOut);

  const int32_t clipMax = (1 << bitdepth) - 1;
  for (int n = 0; n < voxelCount * numAttrs; n++)
    attrsRec[n] = std::min(std::max(attributes[n], 0), clipMax);

  return int(aec.out.size());
}

// Encode one INTER RAHT attribute brick: like tmc13ref_encode_raht_attr
// with the previous frame's reconstructed attribute cloud as the
// transform-domain reference.  The encoder's per-layer inter/intra RDO
// (raht_enable_code_layer) runs both coding tracks and keeps the
// cheaper one; with raht_send_inter_filters the per-layer taps are
// estimated and their quantised residues returned for the ABH.
//   iparams: as the decode entry ([4]/[5] ignored)
//   outModes/outTaps: caller buffers (>= 64 each); counts returned in
//   outCounts[0]/outCounts[1]
int tmc13ref_encode_raht_attr_inter(
  const int64_t* mortonSorted, int voxelCount, int numAttrs,
  const int32_t* attrsIn, const int32_t* qpLayers, int numQpLayers,
  int bitdepth, const int32_t* params,
  const int64_t* refMorton, const int32_t* refAttrs, int refCount,
  const int32_t* iparams, int32_t* outModes, int32_t* outTaps,
  int32_t* outCounts, int32_t* attrsRec,
  uint8_t* payloadOut, int payloadCap) {
  using namespace refattr;

  if (numAttrs != 1 && numAttrs != 3) return -1;
  if (voxelCount <= 0) return -2;

  PredParams pp;
  pp.predictionEnabled = params[0] != 0;
  pp.haar = params[1] != 0;
  pp.threshold0 = params[2];
  pp.threshold1 = params[3];
  pp.subnodePrediction = params[4] != 0;
  pp.searchRange = params[5];
  pp.rahtExtension = params[6] != 0;
  for (int i = 0; i < 19; i++) pp.predWeightParent[i] = params[8 + i];
  for (int i = 0; i < 12; i++) pp.predWeightChild[i] = params[27 + i];

  QpSet qpset;
  qpset.maxQp = 51 + 6 * (bitdepth - 8);
  for (int l = 0; l < numQpLayers; l++)
    qpset.layers.push_back({qpLayers[2 * l], qpLayers[2 * l + 1]});

  InterRaht inter;
  inter.refMorton = refMorton;
  inter.refAttrs = refAttrs;
  inter.refCount = refCount;
  inter.treeDepthLimit = iparams[0];
  inter.enableFilterEstimation = iparams[1] != 0;
  inter.skipInitLayers = iparams[2];
  inter.enableCodeLayer = iparams[3] != 0;

  std::vector<int32_t> attributes(attrsIn,
                                  attrsIn + size_t(numAttrs) * voxelCount);
  std::vector<int32_t> coefficients(size_t(numAttrs) * voxelCount, 0);
  urahtProcess(true, pp, qpset, voxelCount, numAttrs, mortonSorted,
               attributes.data(), coefficients.data(), &inter);

  if (int(inter.encLayerModes.size()) > 64
      || int(inter.encFilterTaps.size()) > 64)
    return -4;
  for (size_t i = 0; i < inter.encLayerModes.size(); i++)
    outModes[i] = inter.encLayerModes[i];
  for (size_t i = 0; i < inter.encFilterTaps.size(); i++)
    outTaps[i] = inter.encFilterTaps[i];
  outCounts[0] = int32_t(inter.encLayerModes.size());
  outCounts[1] = int32_t(inter.encFilterTaps.size());

  obufcore::ArithEnc aec;
  aec.chunked = params[39] != 0;
  aec.init();
  aec.bypassNoUpdate = params[7] != 0;
  AttrCtx ctx;
  ctx.init();

  int zeroRun = 0;
  for (int n = 0; n < voxelCount; ++n) {
    if (numAttrs == 1) {
      int32_t v = coefficients[n];
      if (!v) {
        ++zeroRun;
      } else {
        encodeRunLength(aec, ctx, zeroRun);
        encodeScalar(aec, ctx, v);
        zeroRun = 0;
      }
    } else {
      int32_t v0 = coefficients[n];
      int32_t v1 = coefficients[voxelCount + n];
      int32_t v2 = coefficients[2 * voxelCount + n];
      if (!v0 && !v1 && !v2) {
        ++zeroRun;
      } else {
        encodeRunLength(aec, ctx, zeroRun);
        encodeTriplet(aec, ctx, v0, v1, v2);
        zeroRun = 0;
      }
    }
  }
  if (zeroRun) encodeRunLength(aec, ctx, zeroRun);
  aec.flush();

  if (int(aec.out.size()) > payloadCap) return -3;
  std::copy(aec.out.begin(), aec.out.end(), payloadOut);

  const int32_t clipMax = (1 << bitdepth) - 1;
  for (int n = 0; n < voxelCount * numAttrs; n++)
    attrsRec[n] = std::min(std::max(attributes[n], 0), clipMax);

  return int(aec.out.size());
}

}  // extern "C"
