// obuf_core.h -- normative G-PCC octree entropy/context machinery
// shared by the conformance oracle (refcodec.cc) and the level-sweep
// OBUF engine (obuf_ls.cc).  Extracted verbatim from refcodec.cc; see
// that file's header comment for the reference citations
// (tmc3/geometry_octree.h:328-613, OctreeNeighMap.cpp,
// entropydirac.h, schroarith.{h,c}).  All semantics are normative and
// must not change; engines differ only in traversal/batching around
// this core.
#ifndef TMC13_OBUF_CORE_H
#define TMC13_OBUF_CORE_H

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace obufcore {

// ---------------------------------------------------------------------------
// dirac adaptation LUT (window = 16 @ p0=0.5 & 256 @ p=1.0) -- normative
// table shared by encoder and decoder (schroarith.c:10, entropydirac.h:53)
// ---------------------------------------------------------------------------
static const uint16_t kDiracLut[256] = {
  0,    2,    5,    8,    11,   15,   20,   24,   29,   35,   41,   47,
  53,   60,   67,   74,   82,   89,   97,   106,  114,  123,  132,  141,
  150,  160,  170,  180,  190,  201,  211,  222,  233,  244,  256,  267,
  279,  291,  303,  315,  327,  340,  353,  366,  379,  392,  405,  419,
  433,  447,  461,  475,  489,  504,  518,  533,  548,  563,  578,  593,
  609,  624,  640,  656,  672,  688,  705,  721,  738,  754,  771,  788,
  805,  822,  840,  857,  875,  892,  910,  928,  946,  964,  983,  1001,
  1020, 1038, 1057, 1076, 1095, 1114, 1133, 1153, 1172, 1192, 1211, 1231,
  1251, 1271, 1291, 1311, 1332, 1352, 1373, 1393, 1414, 1435, 1456, 1477,
  1498, 1520, 1541, 1562, 1584, 1606, 1628, 1649, 1671, 1694, 1716, 1738,
  1760, 1783, 1806, 1828, 1851, 1874, 1897, 1920, 1935, 1942, 1949, 1955,
  1961, 1968, 1974, 1980, 1985, 1991, 1996, 2001, 2006, 2011, 2016, 2021,
  2025, 2029, 2033, 2037, 2040, 2044, 2047, 2050, 2053, 2056, 2058, 2061,
  2063, 2065, 2066, 2068, 2069, 2070, 2071, 2072, 2072, 2072, 2072, 2072,
  2072, 2071, 2070, 2069, 2068, 2066, 2065, 2063, 2060, 2058, 2055, 2052,
  2049, 2045, 2042, 2038, 2033, 2029, 2024, 2019, 2013, 2008, 2002, 1996,
  1989, 1982, 1975, 1968, 1960, 1952, 1943, 1934, 1925, 1916, 1906, 1896,
  1885, 1874, 1863, 1851, 1839, 1827, 1814, 1800, 1786, 1772, 1757, 1742,
  1727, 1710, 1694, 1676, 1659, 1640, 1622, 1602, 1582, 1561, 1540, 1518,
  1495, 1471, 1447, 1422, 1396, 1369, 1341, 1312, 1282, 1251, 1219, 1186,
  1151, 1114, 1077, 1037, 995,  952,  906,  857,  805,  750,  690,  625,
  553,  471,  376,  255};

// OBUF probability bounds origin (tables.cpp:99) -- normative
static const uint16_t kObufBoundOrigin[33] = {
  65535, 65388, 64933, 64169, 63105, 61747, 60112, 58214, 56069, 53699,
  51128, 48379, 45480, 42458, 39340, 36160, 32946, 29730, 26541, 23413,
  20374, 17454, 14681, 12083, 9684,  7509,  5575,  3905,  2515,  1419,
  627,   150,   0};

// initial probabilities of the 32 shared OBUF bit models
// (geometry_octree.cpp:256) -- normative
static const int kObufInitProb[32] = {
  65461, 65160, 64551, 63637, 62426, 60929, 59163, 57141, 54884, 52413,
  49753, 46929, 43969, 40899, 37750, 34553, 31338, 28135, 24977, 21893,
  18914, 16067, 13382, 10883, 8596,  6542,  4740,  3210,  1967,  1023,
  388,   75};

// coder-index evolution steps (tables.cpp:302) -- normative
static const uint8_t kObufDelta[16] = {
  0, 1, 1, 2, 4, 7, 9, 11, 14, 16, 19, 23, 22, 22, 20, 15};

// initial coded-0 counters per planar mask configuration
// (geometry_octree_decoder.cpp LUTinitCoded0) -- normative
static const int kInitCoded0[27][6] = {
  {0, 0, 0, 0, 0, 0}, {4, 0, 2, 2, 2, 2}, {0, 4, 2, 2, 2, 2},
  {2, 2, 4, 0, 2, 2}, {4, 2, 4, 2, 3, 3}, {2, 4, 4, 2, 3, 3},
  {2, 2, 0, 4, 2, 2}, {4, 2, 2, 4, 3, 3}, {2, 4, 2, 4, 3, 3},
  {2, 2, 2, 2, 4, 0}, {4, 2, 3, 3, 4, 2}, {2, 4, 3, 3, 4, 2},
  {3, 3, 4, 2, 4, 2}, {4, 3, 4, 3, 4, 3}, {3, 4, 4, 3, 4, 3},
  {3, 3, 2, 4, 4, 2}, {4, 3, 3, 4, 4, 3}, {3, 4, 3, 4, 4, 3},
  {2, 2, 2, 2, 0, 4}, {4, 2, 3, 3, 2, 4}, {2, 4, 3, 3, 2, 4},
  {3, 3, 4, 2, 2, 4}, {4, 3, 4, 3, 3, 4}, {3, 4, 4, 3, 3, 4},
  {3, 3, 2, 4, 2, 4}, {4, 3, 3, 4, 3, 4}, {3, 4, 3, 4, 3, 4}};

// ---------------------------------------------------------------------------
// chunked AEC / bypass-bin sub-stream mux (sps cabac_bypass_stream):
// 256-byte chunks carry a 1-byte AEC length, AEC bytes growing forward
// and raw bypass bits growing backward with a 3-bit flushed-bits count
// (ChunkStreamBuilder / ChunkStreamReader, entropychunk.h:50-455)
// ---------------------------------------------------------------------------

struct ChunkWriter {
  static const int kChunkSize = 256;
  std::vector<uint8_t> buf;
  size_t outputLength = 0;
  long chunkBase = 0;
  int chunkBytesRemaining = 0;
  long aecIdx = 0;
  long bypassIdx = 0;
  int bypassBitIdx = 0;
  int bypassByteAllocCounter = 0;

  void reset() {
    buf.clear();
    outputLength = 0;
    chunkBase = -kChunkSize;
    startNextChunk();
  }

  void startNextChunk() {
    chunkBytesRemaining = kChunkSize - 1;   // one byte for the aec len
    chunkBase += kChunkSize;
    buf.resize(size_t(chunkBase) + kChunkSize, 0);
    aecIdx = chunkBase + 1;
    bypassIdx = chunkBase + kChunkSize - 1;
    bypassBitIdx = 8;
    bypassByteAllocCounter = -3;
    outputLength += kChunkSize;
  }

  void reserveChunkByte() {
    if (--chunkBytesRemaining >= 0) return;
    chunkBytesRemaining = 0;
    finaliseChunk();
    startNextChunk();
    chunkBytesRemaining--;
  }

  void finaliseChunk() {
    int aecLen = int(aecIdx - chunkBase - 1);
    int bypassLen = kChunkSize - chunkBytesRemaining - aecLen - 1;
    if (bypassLen) {
      int flushedBits = bypassBitIdx - 3;
      buf[bypassIdx] = uint8_t(buf[bypassIdx] << bypassBitIdx);
      if (flushedBits < 0) {
        buf[--bypassIdx] = 0;
        flushedBits += 8;
      }
      buf[bypassIdx] |= uint8_t(flushedBits);
      if (chunkBytesRemaining)
        std::memmove(&buf[chunkBase + aecLen + 1], &buf[bypassIdx],
                     size_t(chunkBase + kChunkSize - bypassIdx));
    }
    buf[chunkBase] = uint8_t(aecLen);
  }

  void writeAecByte(uint8_t byte) {
    reserveChunkByte();
    buf[aecIdx++] = byte;
  }

  void writeBypassBit(int bit) {
    if (bypassByteAllocCounter < 1) {
      reserveChunkByte();
      bypassByteAllocCounter += 8;
    }
    bypassByteAllocCounter--;
    if (--bypassBitIdx < 0) {
      bypassIdx--;
      bypassBitIdx = 7;
    }
    buf[bypassIdx] = uint8_t((buf[bypassIdx] << 1) | (bit & 1));
  }

  void flushChunks() {
    if (chunkBytesRemaining == kChunkSize - 1) {
      outputLength -= kChunkSize;   // empty chunk: remove it
      return;
    }
    finaliseChunk();
    outputLength -= size_t(chunkBytesRemaining);  // truncate last chunk
  }
};

struct ChunkReader {
  static const int kChunkSize = 256;
  const uint8_t* base = nullptr;
  const uint8_t* end = nullptr;
  int aecBytesRemaining = 0;
  const uint8_t* aecByte = nullptr;
  const uint8_t* aecNextChunk = nullptr;
  const uint8_t* bypassNextChunk = nullptr;
  const uint8_t* bypassByte = nullptr;
  int bypassAccumBitsRemaining = 0;
  int bypassBitsRemaining = 0;
  uint8_t bypassAccum = 0;

  void reset(const uint8_t* b, size_t n) {
    base = b;
    end = b + n;
    aecBytesRemaining = 0;
    aecByte = nullptr;
    aecNextChunk = b;
    bypassNextChunk = b;
    bypassByte = nullptr;
    bypassAccumBitsRemaining = 0;
    bypassBitsRemaining = 0;
  }

  uint8_t readAecByte() {
    if (aecBytesRemaining-- > 0) return *aecByte++;
    const uint8_t* ptr = aecNextChunk;
    int aecLen = 0;
    while (ptr < end && !(aecLen = *ptr)) ptr += kChunkSize;
    if (ptr + aecLen >= end) return 0xff;   // past-end (reference: throw)
    aecNextChunk = ptr + kChunkSize;
    aecByte = ptr + 1;
    aecBytesRemaining = aecLen;
    aecBytesRemaining--;
    return *aecByte++;
  }

  int readBypassBit() {
    if (bypassAccumBitsRemaining-- > 0) {
      int bit = (bypassAccum & 0x80) != 0;
      bypassAccum <<= 1;
      return bit;
    }
    bypassBitsRemaining -= 8;
    if (bypassBitsRemaining > 0) {
      bypassAccum = *bypassByte--;
      bypassAccumBitsRemaining = std::min(bypassBitsRemaining, 8);
      return readBypassBit();
    }
    const uint8_t* ptr = bypassNextChunk;
    int aecLen = 0;
    while (ptr < end && (aecLen = *ptr) == kChunkSize - 1)
      ptr += kChunkSize;
    int chunkSize = kChunkSize;
    chunkSize = std::max(
      0, std::min(int(end - ptr), chunkSize));
    if (ptr + chunkSize - 1 >= end)
      return 0;                              // past-end (reference: throw)
    int flushedBits = ptr[aecLen + 1] & 0x7;
    bypassNextChunk = ptr + kChunkSize;
    bypassByte = ptr + chunkSize - 1;
    bypassAccum = *bypassByte--;
    bypassBitsRemaining =
      8 * (chunkSize - aecLen) - flushedBits - 11;
    bypassAccumBitsRemaining = std::min(bypassBitsRemaining, 8);
    if (bypassAccumBitsRemaining <= 0) return 0;   // corrupt chunk
    return readBypassBit();
  }
};

// ---------------------------------------------------------------------------
// arithmetic decoder (schroarith decode side; schroarith.h:50-85, .c init)
// ---------------------------------------------------------------------------

struct ArithDec {
  const uint8_t* buf;
  size_t len, pos;
  uint32_t range;           // range[1] of the reference
  uint32_t code;            // code-minus-low
  int cntr;
  int16_t lut[512];         // interleaved adaptation LUT

  // chunked sub-stream mode (sps cabac_bypass_stream): AEC bytes come
  // from the chunk mux, bypass bins are raw bits (entropydirac.h:354)
  bool chunked = false;
  ChunkReader chunkR;

  uint8_t next_byte() {
    if (chunked) return chunkR.readAecByte();
    if (pos >= len) return 0xff;      // readByteCallback past-end value
    return buf[pos++];
  }

  void init(const uint8_t* b, size_t n) {
    buf = b; len = n; pos = 0;
    if (chunked) chunkR.reset(b, n);
    range = 0xffff0000u;
    cntr = 1;
    code = uint32_t(next_byte()) << 24;
    code |= uint32_t(next_byte()) << 16;
    // interleaved LUT: [2k] = lut[255-k] (bit=0 step), [2k+1] = -lut[k]
    for (int k = 0; k < 256; k++) {
      lut[2 * k] = int16_t(kDiracLut[255 - k]);
      lut[2 * k + 1] = int16_t(-int(kDiracLut[k]));
    }
  }

  int bit(uint16_t* prob) {
    while (range <= 0x40000000u) {
      if (!--cntr) {
        code |= uint32_t(next_byte()) << 8;
        cntr = 8;
      }
      range <<= 1;
      code <<= 1;
    }
    uint32_t rxp = ((range >> 16) * (*prob)) & 0xFFFF0000u;
    unsigned lutIdx = ((*prob) >> 7) & ~1u;
    unsigned value = code >= rxp;
    *prob = uint16_t(*prob + lut[lutIdx | value]);
    if (value) {
      code -= rxp;
      range -= rxp;
    } else {
      range = rxp;
    }
    return int(value);
  }

  // bypass_bin_coding_without_prob_update selects between a fresh
  // p=0.5 context (0) and the dedicated bypass-bit path (1)
  // (entropydirac.h:199-212; schroarith.h bypass functions)
  bool bypassNoUpdate = false;

  int bypass() {
    if (chunked)
      return chunkR.readBypassBit();
    if (bypassNoUpdate) {
      // _schro_arith_decode_bypass_bit (schroarith.h:190-210)
      if (!--cntr) {
        code |= uint32_t(next_byte()) << 8;
        cntr = 8;
      }
      code <<= 1;
      unsigned value = code >= range;
      if (value)
        code -= range;
      return int(value);
    }
    uint16_t p = 0x8000;
    return bit(&p);
  }

  // OBUF bounded decode (entropydirac.h:229-253 decode(offset, model,
  // bounds)): clamp the model probability into the evolving band.
  int bit_bounded(uint16_t* prob, int offset, uint16_t* bound) {
    uint16_t& lowTh = bound[offset + 1];
    uint16_t& highTh = bound[offset];
    if (*prob > highTh) {
      *prob = highTh;
      highTh += kDiracLut[255 - (highTh >> 8)] >> 2;
      if (offset > 0 && highTh > bound[offset - 1])
        highTh = bound[offset - 1];
    } else if (*prob < lowTh) {
      *prob = lowTh;
      lowTh -= kDiracLut[lowTh >> 8] >> 2;
      if (offset < 31 && lowTh < bound[offset + 2])
        lowTh = bound[offset + 2];
    }
    return bit(prob);
  }

  // terminate the current entropy stream and reinitialise on the next
  // one, which follows back-to-back in the same buffer (multi-stream
  // bricks: entropydirac.h:335 flushAndRestart + schroarith.c:159
  // schro_arith_decode_flush — the extra renormalisation consumes
  // exactly the bytes the encoder emitted, landing on the next
  // stream's first byte)
  void flushRestart() {
    while (range <= 0x40000000u) {
      if (!--cntr) {
        next_byte();          // value discarded (decode_flush)
        cntr = 8;
      }
      range <<= 1;
    }
    range = 0xffff0000u;
    cntr = 1;
    code = uint32_t(next_byte()) << 24;
    code |= uint32_t(next_byte()) << 16;
  }

  // decodeExpGolomb(0, ctx) (entropyutils.h:189-207)
  unsigned exp_golomb(int k, uint16_t* prefixCtx) {
    unsigned l;
    int symbol = 0;
    int binary = 0;
    do {
      l = bit(prefixCtx);
      if (l == 1) {
        symbol += (1 << k);
        k++;
      }
    } while (l != 0);
    while (k--)
      if (bypass() == 1)
        binary |= 1 << k;
    return unsigned(symbol + binary);
  }
};

// ---------------------------------------------------------------------------
// arithmetic encoder (schroarith encode side; schroarith.h:88-160,
// schro_arith_flush schroarith.c:150-196)
// ---------------------------------------------------------------------------

struct ArithEnc {
  std::vector<uint8_t> out;
  uint32_t low;             // range[0]
  uint32_t range;           // range[1]
  int cntr;
  int carry;
  uint8_t firstByte;
  uint8_t outputByte;
  int16_t ilut[512];        // interleaved adaptation LUT (as ArithDec)

  // chunked sub-stream mode (sps cabac_bypass_stream): AEC bytes are
  // muxed into 256-byte chunks, bypass bins written as raw bits
  // (entropydirac.h:181-212)
  bool chunked = false;
  ChunkWriter chunkW;

  void init() {
    out.clear();
    low = 0;
    range = 0xffff;
    cntr = 0;
    carry = 0;
    firstByte = 1;
    outputByte = 0;
    if (chunked) chunkW.reset();
    for (int k = 0; k < 256; k++) {
      ilut[2 * k] = int16_t(kDiracLut[255 - k]);
      ilut[2 * k + 1] = int16_t(-kDiracLut[k]);
    }
  }

  void push(uint8_t b) {
    if (chunked)
      chunkW.writeAecByte(b);
    else
      out.push_back(b);
  }

  void renorm_byte() {
    if (low < (1u << 24) && (low + range) >= (1u << 24)) {
      carry++;
    } else {
      if (low >= (1u << 24)) {
        outputByte++;
        while (carry) {
          push(outputByte);
          outputByte = 0x00;
          carry--;
        }
      } else {
        while (carry) {
          push(outputByte);
          outputByte = 0xff;
          carry--;
        }
      }
      if (!firstByte)
        push(outputByte);
      else
        firstByte = 0;
      outputByte = uint8_t(low >> 16);
    }
    low &= 0xffff;
    cntr = 0;
  }

  // branchless formulation of the normative bit step: the value
  // branch becomes mask selects, the adaptation uses the interleaved
  // LUT (identical to the decoder's), and renormalisation shifts in
  // bulk while still emitting bytes at exactly the same cntr==8
  // boundaries.  Bit-for-bit the same output as the branchy form
  // (schroarith.h:88-130).
  void bit(uint16_t* prob, int value) {
    uint32_t p0 = *prob;
    uint32_t rxp = (range * p0) >> 16;
    uint32_t m = uint32_t(-int32_t(value != 0));
    low += rxp & m;
    range = (rxp & ~m) | ((range - rxp) & m);
    unsigned lutIdx = ((p0 >> 7) & ~1u) | unsigned(value != 0);
    *prob = uint16_t(p0 + uint32_t(int32_t(ilut[lutIdx])));
    if (range <= 0x4000) {
      int s = __builtin_clz(range) - 17;   // align MSB to bit 14
      s += (range << s) <= 0x4000;         // exact-0x4000 case
      do {
        int step = 8 - cntr;
        if (step > s) step = s;
        low <<= step;
        range <<= step;
        cntr += step;
        s -= step;
        if (cntr == 8)
          renorm_byte();
      } while (s);
    }
  }

  bool bypassNoUpdate = false;

  void bypass(int value) {
    if (chunked) {
      chunkW.writeBypassBit(value);
      return;
    }
    if (bypassNoUpdate) {
      // _schro_arith_encode_bypass_bit (schroarith.h:213-258)
      cntr++;
      low <<= 1;
      if (value)
        low += range;
      if (cntr == 8)
        renorm_byte();
      return;
    }
    uint16_t p = 0x8000;
    bit(&p, value);
  }

  void bit_bounded(uint16_t* prob, int offset, uint16_t* bound,
                   int value) {
    uint16_t& lowTh = bound[offset + 1];
    uint16_t& highTh = bound[offset];
    if (*prob > highTh) {
      *prob = highTh;
      highTh += kDiracLut[255 - (highTh >> 8)] >> 2;
      if (offset > 0 && highTh > bound[offset - 1])
        highTh = bound[offset - 1];
    } else if (*prob < lowTh) {
      *prob = lowTh;
      lowTh -= kDiracLut[lowTh >> 8] >> 2;
      if (offset < 31 && lowTh < bound[offset + 2])
        lowTh = bound[offset + 2];
    }
    bit(prob, value);
  }

  void exp_golomb(unsigned symbol, int k, uint16_t* prefixCtx) {
    while (1) {
      if (symbol >= (1u << k)) {
        bit(prefixCtx, 1);
        symbol -= 1u << k;
        k++;
      } else {
        bit(prefixCtx, 0);
        while (k--)
          bypass((symbol >> k) & 1);
        break;
      }
    }
  }

  void flush() {
    bool extraByte = cntr > 0;
    int i;
    // NB: replicates the reference comparison verbatim
    // (schroarith.c flush: low|mask vs range-1, not low+range-1)
    for (i = 0; i < 16; i++)
      if ((low | ((1u << (i + 1)) - 1)) > range - 1)
        break;
    low |= (1u << i) - 1;
    while (cntr < 8) {
      low <<= 1;
      low |= 1;
      cntr++;
    }
    if (low >= (1u << 24)) {
      outputByte++;
      if (!firstByte)
        push(outputByte);
      while (carry) {
        push(0x00);
        carry--;
      }
    } else {
      if (!firstByte)
        push(outputByte);
      while (carry) {
        push(0xff);
        carry--;
      }
    }
    push(uint8_t(low >> 16));
    push(uint8_t(low >> 8));
    if (extraByte)
      push(uint8_t(low));
    if (chunked) {
      // finalise the chunk mux and surface it as the payload
      chunkW.flushChunks();
      out.assign(chunkW.buf.begin(),
                 chunkW.buf.begin() + long(chunkW.outputLength));
    }
  }
};

// ---------------------------------------------------------------------------
// shared OBUF bit models + bounds (CtxModelDynamicOBUF, geometry_octree.h:304)
// ---------------------------------------------------------------------------

struct ObufModel {
  uint16_t prob[32];
  uint16_t bound[33];
  void init() {
    for (int i = 0; i < 32; i++) prob[i] = uint16_t(kObufInitProb[i]);
    for (int i = 0; i < 33; i++) bound[i] = kObufBoundOrigin[i];
  }
};

// dynamic context map (CtxMapDynamicOBUF, geometry_octree.h:328-613)
struct CtxMapOBUF {
  static const int kLeafDepth = 4;
  static const int kLeafBufSize = 20000;

  int S1 = 0, S2 = 0;
  int maxTreeDepth = 0;
  std::vector<uint8_t> ctxIdx;   // tree coder indices / leaf ptr high
  std::vector<uint8_t> kDown;
  std::vector<uint8_t> nSeen;    // counters / leaf ptr low

  void reset(int bitsS1, int bitsS2) {
    S1 = 1 << bitsS1;
    S2 = 1 << bitsS2;
    maxTreeDepth = bitsS1 - kLeafDepth;
    int treeSize = (1 << maxTreeDepth) * S2;
    kDown.assign(treeSize, uint8_t(bitsS1));
    nSeen.assign(treeSize, 0);
    ctxIdx.assign(treeSize, 0);
    for (int j = 0; j < S2; j++) {
      nSeen[j] = 0;
      ctxIdx[j] = 127;
    }
  }

  int idx(int i, int j) const { return i * S2 + j; }

  // preset the S2 root contexts (CtxMapDynamicOBUF::init,
  // geometry_octree.h:401-405)
  void initFrom(const uint8_t* initValue) {
    for (int j = 0; j < S2; j++)
      ctxIdx[j] = initValue[j];
  }

  static void evolve(uint8_t* c, int bitv) {
    // branchless: delta = bitv ? +kObufDelta[15-(c>>4)] : -kObufDelta[c>>4]
    static const int8_t kEvolveLut[32] = {
      -0,  15, -1,  20, -1,  22, -2,  22, -4,  23, -7,  19, -9,  16,
      -11, 14, -14, 11, -16, 9,  -19, 7,  -23, 4,  -22, 2,  -22, 1,
      -20, 1,  -15, 0};
    *c = uint8_t(*c + kEvolveLut[((*c >> 4) << 1) | (bitv != 0)]);
  }

  void decreaseKdown(int idxTree, int kDownTree) {
    nSeen[idxTree] = 0;
    nSeen[idxTree + (S2 << (kDownTree - 1))] = 0;
    int iEnd = S2 << kDownTree;
    for (int ii = 0; ii < iEnd; ii += S2)
      kDown[idxTree + ii]--;
    uint8_t* p = &ctxIdx[idxTree];
    p[S2 << (kDownTree - 1)] = *p;
  }

  static bool createLeafElement(int leafPos, uint8_t* leaves, uint8_t ctx) {
    int first = leafPos * (1 << kLeafDepth);
    if (!leaves[first]) {
      std::memset(&leaves[first], ctx, size_t(1) << kLeafDepth);
      return true;
    }
    return false;
  }

  void createLeaf(int idxTree, int /*kDownTree*/, int* leafNumber,
                  uint8_t* leaves, int ctx, int i) {
    bool avail = createLeafElement(*leafNumber, leaves, uint8_t(ctx));
    if (avail) {
      nSeen[idxTree] = uint8_t(*leafNumber & 255);
      ctxIdx[idxTree] = uint8_t(*leafNumber >> 8);
      *leafNumber += 1;
    } else {
      int dmin = 256;
      int bmin = *leafNumber;
      const int maskI = (1 << kLeafDepth) - 1;
      for (int b = *leafNumber; b < *leafNumber + 20 && b < kLeafBufSize;
           b++) {
        int d = std::abs(
          ctx - int(leaves[b * (1 << kLeafDepth) + (i & maskI)]));
        if (d < dmin) {
          dmin = d;
          bmin = b;
        }
      }
      nSeen[idxTree] = uint8_t(bmin & 255);
      ctxIdx[idxTree] = uint8_t(bmin >> 8);
      *leafNumber = bmin + 1;
    }
    if (*leafNumber >= kLeafBufSize)
      *leafNumber = 0;
    kDown[idxTree]--;
  }

  // encoder-side mirror: returns the coder index BEFORE evolution
  // (CtxMapDynamicOBUF::getEvolve, geometry_octree.h:521)
  uint8_t getEvolve(bool bitv, int i, int j, int* leafNumber,
                    uint8_t* leaves) {
    int iTree = i >> kLeafDepth;
    int kDown0 = kDown[idx(iTree, j)];
    uint8_t outv;
    if (kDown0 >= kLeafDepth) {
      int kDownTree = kDown0 - kLeafDepth;
      int iP = (iTree >> kDownTree) << kDownTree;
      int idxTree = idx(iP, j);
      uint8_t* c = &ctxIdx[idxTree];
      outv = *c;
      evolve(c, bitv);
      int th = 3 + (std::abs(int(*c) - 127) >> 4);
      if (++nSeen[idxTree] >= th) {
        if (kDownTree > 0)
          decreaseKdown(idxTree, kDownTree);
        else
          createLeaf(idxTree, kDownTree, leafNumber, leaves, *c, i);
      }
    } else {
      int leafIdx = (int(ctxIdx[idx(iTree, j)]) << 8)
        + nSeen[idx(iTree, j)];
      const int maskI = (1 << kLeafDepth) - 1;
      uint8_t* c = &leaves[leafIdx * (1 << kLeafDepth) + (i & maskI)];
      outv = *c;
      evolve(c, bitv);
    }
    return outv;
  }

  int decodeEvolve(ArithDec* aec, ObufModel& model, int i, int j,
                   int* leafNumber, uint8_t* leaves) {
    int iTree = i >> kLeafDepth;
    int kDown0 = kDown[idx(iTree, j)];
    int bitv;
    if (kDown0 >= kLeafDepth) {
      int kDownTree = kDown0 - kLeafDepth;
      int iP = (iTree >> kDownTree) << kDownTree;
      int idxTree = idx(iP, j);
      uint8_t* c = &ctxIdx[idxTree];
      bitv = aec->bit_bounded(&model.prob[*c >> 3], *c >> 3, model.bound);
      evolve(c, bitv);
      int th = 3 + (std::abs(int(*c) - 127) >> 4);
      if (++nSeen[idxTree] >= th) {
        if (kDownTree > 0)
          decreaseKdown(idxTree, kDownTree);
        else
          createLeaf(idxTree, kDownTree, leafNumber, leaves, *c, i);
      }
    } else {
      int leafIdx = (int(ctxIdx[idx(iTree, j)]) << 8)
        + nSeen[idx(iTree, j)];
      const int maskI = (1 << kLeafDepth) - 1;
      uint8_t* c = &leaves[leafIdx * (1 << kLeafDepth) + (i & maskI)];
      bitv = aec->bit_bounded(&model.prob[*c >> 3], *c >> 3, model.bound);
      evolve(c, bitv);
    }
    return bitv;
  }
};

// ---------------------------------------------------------------------------
// cross-module coder handoff: the octree phase of a trisoup brick and
// the trisoup phases (vertices/centroids/faces) share one arithmetic
// coder (reference decodeGeometryTrisoup passes the same
// EntropyDecoder through all stages).  refcodec.cc exports the live
// coder in this POD; trisoup_ref.cc resumes from it.
// ---------------------------------------------------------------------------

struct TsCoderHandle {
  ArithDec dec;
  ArithEnc enc;
  bool isEnc = false;
};

// ---------------------------------------------------------------------------
// occupancy atlas (MortonMap3D, OctreeNeighMap.h:57)
// ---------------------------------------------------------------------------

static inline uint32_t spread3(uint32_t v, int shift) {
  // bit b of v lands at position 3*b + shift (kMortonCode256* tables)
  uint32_t r = 0;
  for (int b = 0; b < 8; b++)
    if (v & (1u << b))
      r |= 1u << (3 * b + shift);
  return r;
}

struct Atlas {
  int cubeSizeLog2 = 0;
  int cubeSize = 0;
  std::vector<uint8_t> buffer;
  std::vector<uint8_t> childOcc;
  std::vector<uint32_t> updates;
  uint32_t mortonX[256], mortonY[256], mortonZ[256];

  void resize(bool childEnabled, int log2) {
    cubeSizeLog2 = log2;
    cubeSize = 1 << log2;
    buffer.assign(size_t(1) << (3 * log2), 0);
    // byteIndex() interleaves three log2-bit coords, so indices are
    // < 1<<(3*log2); the reference allocates 8x that, needlessly
    if (childEnabled)
      childOcc.assign(size_t(1) << (3 * log2), 0);
    for (int v = 0; v < 256; v++) {
      mortonX[v] = spread3(uint32_t(v), 2);
      mortonY[v] = spread3(uint32_t(v), 1);
      mortonZ[v] = spread3(uint32_t(v), 0);
    }
    updates.reserve(1 << 16);
  }

  uint32_t byteIndex(int x, int y, int z) const {
    return mortonX[x] | mortonY[y] | mortonZ[z];
  }
  static int bitIndex(int x, int y, int z) {
    return (z & 1) + ((y & 1) << 1) + ((x & 1) << 2);
  }

  void clearUpdates() {
    for (uint32_t u : updates) buffer[u] = 0;
    updates.clear();
  }

  void setByte(int x, int y, int z, uint8_t value) {
    if (value) {
      uint32_t bi = byteIndex(x, y, z);
      buffer[bi] = value;
      updates.push_back(bi);
    }
  }

  uint32_t get(int x, int y, int z, int sx, int sy, int sz) const {
    return (buffer[byteIndex(x >> sx, y >> sy, z >> sz)]
            >> bitIndex(sx ? x : 0, sy ? y : 0, sz ? z : 0)) & 1;
  }

  uint32_t getWithCheck(int x, int y, int z, int sx, int sy,
                        int sz) const {
    if (x < 0 || x >= cubeSize || y < 0 || y >= cubeSize || z < 0
        || z >= cubeSize)
      return 0;
    return get(x, y, z, sx, sy, sz);
  }

  void setChildOcc(int x, int y, int z, uint8_t occ) {
    childOcc[byteIndex(x, y, z)] = occ;
  }
  uint8_t getChildOcc(int x, int y, int z) const {
    return childOcc[byteIndex(x, y, z)];
  }
};

// ---------------------------------------------------------------------------
// neighbour context preparation (OctreeNeighMap.cpp:137-376)
// ---------------------------------------------------------------------------

struct NeighPattern {
  uint8_t pattern = 0;
  uint8_t adjOcc[7] = {0, 0, 0, 0, 0, 0, 0};
  uint32_t neighborOccu = 0;
  bool neighOccuValid = false;
};

struct NeighInfo {
  int occLeft = 0, occFront = 0, occBottom = 0;
  int occL = 0, occF = 0, occB = 0;
  int occOrLFBfb = 0;
  int edgeBits = 0;
  int N3 = 0, N2 = 0;
  int neighPatternLFB = 0;
  int neighb20 = 0;
};

// linear-neighbour probes for the no-advanced-occupancy fallback
// (OctreeNeighMap.cpp:168-170)
static const int kLinDx[9] = {1, 1, 1, 1, 0, 0, 0, -1, -1};
static const int kLinDy[9] = {1, 0, 0, -1, 1, 1, -1, 1, 0};
static const int kLinDz[9] = {0, 1, -1, 0, 1, -1, 1, 0, 1};

// 6-neighbour pattern from the parent's occupancy alone, used when
// the atlas is disabled (geometry_octree.cpp:171-192)
static inline int neighPatternFromOccupancy(int pos, int occupancy) {
  int neighPat = 0;
  neighPat |= ((occupancy >> (pos ^ 4)) & 1) << (0 + ((pos >> 2) & 1));
  neighPat |= ((occupancy >> (pos ^ 2)) & 1) << (2 + ((~pos >> 1) & 1));
  neighPat |= ((occupancy >> (pos ^ 1)) & 1) << (4 + ((~pos >> 0) & 1));
  return neighPat;
}

static NeighPattern makeNeighPattern(
  bool adjChildCtx, const int32_t pos[3], int codedAxesPrevLvl,
  const Atlas& atlas, bool planarEligibleKDepth) {
  const int mask = atlas.cubeSize - 1;
  const int x = pos[0] & mask, y = pos[1] & mask, z = pos[2] & mask;
  const int sx = (codedAxesPrevLvl & 4) ? 1 : 0;
  const int sy = (codedAxesPrevLvl & 2) ? 1 : 0;
  const int sz = (codedAxesPrevLvl & 1) ? 1 : 0;
  NeighPattern gnp;
  uint8_t p;
  bool inner = x > 0 && x < mask && y > 0 && y < mask && z > 0
    && z < mask;
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
  gnp.pattern = p;
  if ((!gnp.pattern && !planarEligibleKDepth) || !adjChildCtx)
    return gnp;
  if (gnp.pattern) {
    if (gnp.pattern & 2)
      gnp.adjOcc[0] = atlas.getChildOcc(x - 1, y, z);
    if (gnp.pattern & 4)
      gnp.adjOcc[1] = atlas.getChildOcc(x, y - 1, z);
    if (gnp.pattern & 16)
      gnp.adjOcc[2] = atlas.getChildOcc(x, y, z - 1);
  }
  if (planarEligibleKDepth) {
    if (inner) {
      if (atlas.get(x - 1, y - 1, z, sx, sy, sz))
        gnp.adjOcc[3] = atlas.getChildOcc(x - 1, y - 1, z);
      if (atlas.get(x - 1, y, z - 1, sx, sy, sz))
        gnp.adjOcc[4] = atlas.getChildOcc(x - 1, y, z - 1);
      if (atlas.get(x, y - 1, z - 1, sx, sy, sz))
        gnp.adjOcc[5] = atlas.getChildOcc(x, y - 1, z - 1);
      if (atlas.get(x - 1, y - 1, z - 1, sx, sy, sz))
        gnp.adjOcc[6] = atlas.getChildOcc(x - 1, y - 1, z - 1);
    } else {
      if (atlas.getWithCheck(x - 1, y - 1, z, sx, sy, sz))
        gnp.adjOcc[3] = atlas.getChildOcc(x - 1, y - 1, z);
      if (atlas.getWithCheck(x - 1, y, z - 1, sx, sy, sz))
        gnp.adjOcc[4] = atlas.getChildOcc(x - 1, y, z - 1);
      if (atlas.getWithCheck(x, y - 1, z - 1, sx, sy, sz))
        gnp.adjOcc[5] = atlas.getChildOcc(x, y - 1, z - 1);
      if (atlas.getWithCheck(x - 1, y - 1, z - 1, sx, sy, sz))
        gnp.adjOcc[6] = atlas.getChildOcc(x - 1, y - 1, z - 1);
    }
    gnp.neighOccuValid = false;
    for (int idx = 0; idx < 7 && !gnp.neighOccuValid; ++idx)
      gnp.neighOccuValid |= gnp.adjOcc[idx] != 0;
    if (!gnp.neighOccuValid) {
      uint32_t no = (uint32_t(!!(gnp.pattern & 1)) << 11)
        | (uint32_t(!!(gnp.pattern & 8)) << 10)
        | (uint32_t(!!(gnp.pattern & 32)) << 9);
      if (inner)
        for (int n = 0; n < 9; n++)
          no |= atlas.get(x + kLinDx[n], y + kLinDy[n], z + kLinDz[n],
                          sx, sy, sz) << n;
      else
        for (int n = 0; n < 9; n++)
          no |= atlas.getWithCheck(x + kLinDx[n], y + kLinDy[n],
                                   z + kLinDz[n], sx, sy, sz) << n;
      gnp.neighborOccu = no;
    }
  }
  return gnp;
}

// 20-neighbour probe offsets (OctreeNeighMap.cpp:287-292)
static const int kDx20[20] =
  {-1, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1};
static const int kDy20[20] =
  {-1, -1, -1, 0, 0, 1, 1, 1, -1, -1, 1, 1, -1, -1, -1, 0, 0, 1, 1, 1};
static const int kDz20[20] =
  {-1, 0, 1, -1, 1, -1, 0, 1, -1, 1, -1, 1, -1, 0, 1, -1, 1, -1, 0, 1};

static void prepareNeighInfo(
  NeighInfo& nf, const NeighPattern& gnp, const int32_t pos[3],
  int atlasShift, const Atlas& atlas, bool planarEligibleKDepth) {
  const int neighPattern = gnp.pattern;
  const int mask = atlas.cubeSize - 1;
  const int x = pos[0] & mask, y = pos[1] & mask, z = pos[2] & mask;
  const int sx = (atlasShift & 4) ? 1 : 0;
  const int sy = (atlasShift & 2) ? 1 : 0;
  const int sz = (atlasShift & 1) ? 1 : 0;

  int n20 = 0;
  if (x > 0 && x < mask && y > 0 && y < mask && z > 0 && z < mask) {
    // interior fast path: precompute the 3 spread values and bit
    // slots per axis once instead of 20x3 table lookups
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
    int occLB = planarEligibleKDepth ? gnp.adjOcc[4]
                                     : atlas.getChildOcc(x - 1, y, z - 1);
    nf.edgeBits = ((occLB & 32) >> 5) | ((occLB & 128) >> 6);
  }
  if ((n20 >> 8) & 1) {
    int occFB = planarEligibleKDepth ? gnp.adjOcc[5]
                                     : atlas.getChildOcc(x, y - 1, z - 1);
    nf.edgeBits |= ((occFB & 8) >> 1) | ((occFB & 128) >> 4);
  }
  if ((n20 >> 1) & 1) {
    int occLF = planarEligibleKDepth ? gnp.adjOcc[3]
                                     : atlas.getChildOcc(x - 1, y - 1, z);
    nf.edgeBits |= (occLF & 0xC0) >> 2;
  }

  nf.N3 = ((neighPattern >> 3) & 4) | ((neighPattern >> 2) & 2)
    | (neighPattern & 1);
  nf.N2 = nf.N3 & 3;
  nf.neighPatternLFB = ((neighPattern & 6) >> 1)
    | ((neighPattern & 16) >> 2);
}

// bit helpers (OctreeNeighMap.cpp:380-400)
static inline int gb(int w, int n) { return (w >> n) & 1; }
static inline int gb(int w, int n1, int n2) {
  return ((w >> (n1 - 1)) & 2) | ((w >> n2) & 1);
}
static inline int gb(int w, int n1, int n2, int n3) {
  return ((w >> (n1 - 2)) & 4) | ((w >> (n2 - 1)) & 2) | ((w >> n3) & 1);
}
static inline int gb(int w, int n1, int n2, int n3, int n4) {
  return ((w >> (n1 - 3)) & 8) | ((w >> (n2 - 2)) & 4)
    | ((w >> (n3 - 1)) & 2) | ((w >> n4) & 1);
}

static const int kNN4[16] = {0, 1, 1, 2, 1, 2, 2, 3,
                             1, 2, 2, 3, 2, 3, 3, 4};

// The eight per-occupancy-bit OBUF context derivations.  These are the
// normative context-selection functions of the reference
// (makeGeometryAdvancedNeighPattern0..7, OctreeNeighMap.cpp:409-1358);
// the bit layouts must match exactly for conformance.
static void ctxBit0(NeighInfo& o, int /*occ*/, int& c1, int& c2,
                    bool& sparse) {
  int info = 0;
  const int N20 = o.neighb20;
  int NN = kNN4[o.occL] + kNN4[o.occF] + kNN4[o.occB];
  if (NN > 1) {
    int NLFB = !!o.occL + !!o.occF + !!o.occB;
    if (NLFB == 3) {
      info = 0b100 << 16;
      info |= (o.occB & 1) << 15;
      info |= (o.occF & 1) << 14;
      info |= (o.occL & 1) << 13;
      info |= (o.occB & 0b110) << (11 - 1);
      info |= (o.occF & 0b110) << (9 - 1);
      info |= (o.occL & 0b110) << (7 - 1);
      info |= o.N3 << 4;
      info |= gb(N20, 8, 3, 1, 0);
    } else {
      if (NLFB == 2) {
        if (o.occL && o.occB) {
          info = 0b101 << 16;
          info |= (o.occB & 1) << 15;
          info |= (o.occL & 1) << 14;
          info |= (o.occB & 0b110) << (12 - 1);
          info |= (o.occL & 0b110) << (10 - 1);
          info |= !(o.occB & 8) << 9;
          info |= !(o.occL & 8) << 8;
          info |= !(o.N3 & 2) << 7;
        }
        if (o.occF && o.occB) {
          info = 0b110 << 16;
          info |= (o.occB & 1) << 15;
          info |= (o.occF & 1) << 14;
          info |= (o.occB & 0b110) << (12 - 1);
          info |= (o.occF & 0b110) << (10 - 1);
          info |= !(o.occB & 8) << 9;
          info |= !(o.occF & 8) << 8;
          info |= !(o.N3 & 1) << 7;
        }
        if (o.occL && o.occF) {
          info = 0b111 << 16;
          info |= (o.occF & 1) << 15;
          info |= (o.occL & 1) << 14;
          info |= (o.occF & 0b110) << (12 - 1);
          info |= (o.occL & 0b110) << (10 - 1);
          info |= !(o.occF & 8) << 9;
          info |= !(o.occL & 8) << 8;
          info |= !(o.N3 & 4) << 7;
        }
      } else {  // NLFB == 1
        if (o.occL) {
          info = 0b000 << 16;
          info |= (o.occL & 1) << 15;
          info |= (o.occL & 0b110) << (13 - 1);
          info |= !(o.occL & 8) << 12;
          info |= (o.edgeBits & 0b001100) << (10 - 2);
        } else if (o.occF) {
          info = 0b001 << 16;
          info |= (o.occF & 1) << 15;
          info |= (o.occF & 0b110) << (13 - 1);
          info |= !(o.occF & 8) << 12;
          info |= (o.edgeBits & 0b000011) << 10;
        } else {
          info = 0b010 << 16;
          info |= (o.occB & 1) << 15;
          info |= (o.occB & 0b110) << (13 - 1);
          info |= !(o.occB & 8) << 12;
          info |= (o.edgeBits & 0b110000) << (10 - 4);
        }
        info |= o.N3 << 7;
      }
      info |= gb(N20, 8, 3, 1, 0) << 3;
      info |= gb(N20, 18, 19, 11);
    }
    sparse = false;
    c1 = info >> 13;
    c2 = info & 0x1FFF;
  } else {
    int lfb = o.neighPatternLFB;
    if (NN) {
      if (o.occL) {
        info = 1 << 14;
        info |= !(o.occL & 1) << 13;
        info |= !(lfb & 4) << 12;
        info |= !(lfb & 2) << 11;
      } else if (o.occF) {
        info = 2 << 14;
        info |= !(o.occF & 1) << 13;
        info |= !(lfb & 4) << 12;
        info |= !(lfb & 1) << 11;
      } else {
        info = 3 << 14;
        info |= !(o.occB & 1) << 13;
        info |= !(lfb & 2) << 12;
        info |= !(lfb & 1) << 11;
      }
    } else {
      info = 0 << 14;
      info |= lfb << 11;
    }
    info |= gb(N20, 1, 3) << 9;
    info |= gb(N20, 8, 0) << 7;
    if (lfb) {
      if (o.occOrLFBfb & 1) {
        info |= 1 << 6;
        info |= (o.occBottom & 1) << 5;
        info |= (o.occFront & 1) << 4;
        info |= (o.occLeft & 1) << 3;
      } else {
        info |= !o.edgeBits << 5;
        info |= ((o.occLeft & 4) || (o.occFront & 2)
                 || (o.occBottom & 4)) << 4;
        info |= ((o.occLeft & 2) || (o.occFront & 16)
                 || (o.occBottom & 16)) << 3;
      }
    } else {
      info |= !(o.edgeBits & 0b110000) << 6;
      info |= !(o.edgeBits & 0b001100) << 5;
      info |= !(o.edgeBits & 0b000011) << 4;
    }
    info |= gb(N20, 18, 19, 11);
    sparse = true;
    c1 = info >> 12;
    c2 = info & 0x0FFF;
  }
}

static void ctxBit1(NeighInfo& o, int occ, int& c1, int& c2,
                    bool& sparse) {
  int info = 0;
  const int N20 = o.neighb20;
  if (o.occF) {
    info = (occ & 1) << 18;
    info |= !(o.occF & 0b0010) << 17;
    info |= !o.occL << 16;
    if (o.occL) {
      info |= !(o.occL & 0b0010) << 15;
      info |= !(o.N3 & 4) << 14;
      info |= !(o.occF & 0b0001) << 13;
      info |= !(o.occF & 0b1000) << 12;
      info |= !(o.occL & 0b0001) << 11;
      info |= !(o.occL & 0b1000) << 10;
      info |= !(o.occF & 0b0100) << 9;
      info |= !(o.occL & 0b0100) << 8;
      info |= (o.N3 & 1) << 7;
      info |= gb(N20, 9, 4, 1, 2) << 3;
    } else {
      info |= !(o.N3 & 4) << 15;
      info |= !(o.occF & 0b0001) << 14;
      info |= !(o.occF & 0b1000) << 13;
      info |= !(o.occF & 0b0100) << 12;
      info |= gb(N20, 9, 4, 1, 2) << 8;
      info |= !(o.occBottom & 2) << 7;
      info |= !(o.occFront & 2) << 6;
      info |= !(o.occLeft & 2) << 5;
      info |= (o.N3 & 3) << 3;
    }
    info |= gb(N20, 11, 16, 19);
    sparse = false;
    c1 = info >> 13;
    c2 = info & 0x1FFF;
  } else {
    info = (occ & 1) << 18;
    info |= !(o.occL & 0b0010) << 17;
    info |= !(o.N3 & 4) << 16;
    info |= !(o.occL & 0b0001) << 15;
    info |= !(o.occL & 0b1000) << 14;
    info |= !(o.occL & 0b0100) << 13;
    info |= (o.N3 & 1) << 12;
    info |= gb(N20, 1, 4) << 10;
    info |= gb(N20, 9, 2) << 8;
    if (o.occOrLFBfb & 2) {
      info |= 1 << 7;
      info |= !(o.occBottom & 2) << 6;
      info |= !(o.occFront & 2) << 5;
      info |= !(o.occLeft & 2) << 4;
    } else {
      info |= !(o.edgeBits & 0b110101) << 6;
      info |= ((o.occLeft & 8) || (o.occFront & 32)) << 5;
      info |= ((o.occLeft & 1) || (o.occFront & 1)) << 4;
    }
    info |= !o.occB << 3;
    info |= gb(N20, 11, 16, 19);
    sparse = true;
    c1 = info >> 12;
    c2 = info & 0x0FFF;
  }
}

static void ctxBit2(NeighInfo& o, int occ, int& c1, int& c2,
                    bool& sparse) {
  int info = 0;
  const int N20 = o.neighb20;
  if (o.occB) {
    info = (occ & 1) << 18;
    info |= !(o.occB & 0b0010) << 17;
    info |= !o.occL << 16;
    if (o.occL) {
      info |= !(o.occL & 0b0100) << 15;
      info |= !(o.N3 & 2) << 14;
      info |= !(occ & 2) << 13;
      info |= !(o.occB & 0b1000) << 12;
      info |= !(o.occL & 0b1000) << 11;
      info |= !(o.occL & 0b0001) << 10;
      info |= !(o.occB & 0b0001) << 9;
      info |= gb(N20, 10, 6, 3) << 6;
      info |= !(o.occB & 0b0100) << 5;
      info |= !(o.occL & 0b0010) << 4;
    } else {
      info |= !(o.N3 & 2) << 15;
      info |= !(occ & 2) << 14;
      info |= !(o.occB & 0b0001) << 13;
      info |= !(o.occB & 0b1000) << 12;
      info |= !(o.occB & 0b0100) << 11;
      info |= gb(N20, 10, 6, 3) << 8;
      info |= !(o.N3 & 4) << 7;
      info |= !(o.occLeft & 4) << 6;
      info |= !(o.occBottom & 4) << 5;
      info |= !(o.occFront & 4) << 4;
    }
    info |= gb(N20, 0) << 3;
    info |= gb(N20, 18, 19, 11);
    sparse = false;
    c1 = info >> 13;
    c2 = info & 0x1FFF;
  } else {
    info = (occ & 1) << 18;
    info |= !(o.occL & 0b0100) << 17;
    info |= !(o.N3 & 2) << 16;
    info |= !(occ & 2) << 15;
    info |= !(o.occL & 0b1000) << 14;
    info |= !(o.occL & 0b0001) << 13;
    info |= !(o.occL & 0b0010) << 12;
    info |= gb(N20, 3, 6, 10, 5) << 8;
    if (o.occOrLFBfb & 4) {
      info |= 1 << 7;
      info |= !(o.occLeft & 4) << 6;
      info |= !(o.occBottom & 4) << 5;
      info |= !(o.occFront & 4) << 4;
    } else {
      info |= ((o.occLeft & 1) || (o.occBottom & 1)) << 6;
      info |= ((o.occLeft & 8) || (o.occBottom & 64)) << 5;
      info |= !(o.edgeBits & 0b000011) << 4;
    }
    info |= !o.occF << 3;
    info |= gb(N20, 18, 19, 11);
    sparse = true;
    c1 = info >> 12;
    c2 = info & 0x0FFF;
  }
}

static void ctxBit3(NeighInfo& o, int occ, int& c1, int& c2,
                    bool& sparse) {
  int info = 0;
  const int N20 = o.neighb20;
  int NN = kNN4[o.occL] + kNN4[occ & 7];
  if (NN > 1) {
    info = !(occ & 4) << 16;
    info |= !(occ & 2) << 15;
    info |= !(o.occL & 8) << 14;
    info |= o.N3 << 11;
    info |= !(occ & 1) << 10;
    info |= !(o.occL & 4) << 9;
    info |= !(o.occL & 2) << 8;
    info |= (o.occL & 1) << 7;
    info |= gb(N20, 11, 6, 4, 0) << 3;
    info |= gb(N20, 16, 19, 18);
    sparse = false;
    c1 = info >> 11;
    c2 = info & 0x07FF;
  } else {
    int occup = occ & 7;
    info = !occup << 17;
    if (occup)
      info |= (!!occup + !!(occup >> 1) + !!(occup >> 2)) << 15;
    else
      info |= (!!(o.occL >> 1) + !!(o.occL >> 2) + !!(o.occL >> 3)) << 15;
    info |= (o.N3 >> 1) << 13;
    info |= gb(N20, 4, 6, 11, 7) << 9;
    if (o.occOrLFBfb & 8) {
      info |= 1 << 8;
      info |= !(o.occBottom & 8) << 7;
      info |= !(o.occFront & 8) << 6;
      info |= !(o.occLeft & 8) << 5;
    } else {
      info |= (o.occLeft & 0b110) << 5;
      info |= !(o.edgeBits & 0b110010) << 5;
    }
    info |= !o.occB << 4;
    info |= !o.occF << 3;
    info |= gb(N20, 18, 19, 16);
    sparse = true;
    c1 = info >> 12;
    c2 = info & 0x0FFF;
  }
}

static void ctxBit4(NeighInfo& o, int occ, int& c1, int& c2,
                    bool& sparse) {
  int info = 0;
  const int N20 = o.neighb20;
  const int occL4 = occ & 15;
  int NN = kNN4[occL4] + kNN4[o.occF] + kNN4[o.occB];
  if (NN > 1) {
    int NLFB = !!occL4 + !!o.occF + !!o.occB;
    if (NLFB == 3) {
      info = 0b1000 << 15;
      info |= !(o.occB & 4) << 17;
      info |= !(o.occF & 4) << 16;
      info |= (occL4 & 1) << 15;
      info |= !(o.N3 & 1) << 14;
      info |= !(o.occB & 1) << 13;
      info |= !(o.occB & 8) << 12;
      info |= !(o.occF & 1) << 11;
      info |= !(o.occF & 8) << 10;
      info |= !(occL4 & 2) << 9;
      info |= !(occL4 & 4) << 8;
      info |= !(o.occB & 2) << 7;
      info |= !(o.occF & 2) << 6;
      info |= (o.N3 >> 1) << 4;
      info |= gb(N20, 15, 13, 8, 12);
    } else if (NLFB == 2) {
      if (occL4 && o.occB) {
        info = 0b0100 << 15;
        info |= !(o.occB & 4) << 14;
        info |= !(occL4 & 1) << 13;
        info |= !(o.N3 & 1) << 12;
        info |= !(o.occB & 1) << 11;
        info |= !(o.occB & 8) << 10;
        info |= !(occL4 & 2) << 9;
        info |= !(occL4 & 4) << 8;
        info |= !(o.occB & 2) << 7;
        info |= !(occL4 & 8) << 6;
      } else if (o.occF && o.occB) {
        info = 0b0101 << 15;
        info |= !(o.occB & 4) << 14;
        info |= !(o.occF & 4) << 13;
        info |= !(o.N3 & 1) << 12;
        info |= !(o.occB & 1) << 11;
        info |= !(o.occB & 8) << 10;
        info |= !(o.occF & 1) << 9;
        info |= !(o.occF & 8) << 8;
        info |= !(o.occB & 2) << 7;
        info |= !(o.occF & 2) << 6;
      } else {
        info = 0b0110 << 15;
        info |= !(o.occF & 4) << 14;
        info |= !(occL4 & 1) << 13;
        info |= !(o.N3 & 1) << 12;
        info |= !(o.occF & 1) << 11;
        info |= !(o.occF & 8) << 10;
        info |= !(occL4 & 2) << 9;
        info |= !(occL4 & 4) << 8;
        info |= !(o.occF & 2) << 7;
        info |= !(occL4 & 8) << 6;
      }
      info |= gb(N20, 15, 13, 8) << 3;
      info |= gb(N20, 12, 16, 18);
    } else {  // NLFB == 1
      if (occL4) {
        info = 0b0000 << 15;
        info |= (occL4 & 1) << 14;
        info |= !(o.N3 & 1) << 13;
        info |= (occL4 & 0b110) << (11 - 1);
        info |= !(occL4 & 8) << 10;
        info |= (o.edgeBits & 0b001100) << (8 - 2);
      } else if (o.occF) {
        info = 0b0001 << 15;
        info |= !(o.occF & 0b0100) << 14;
        info |= !(o.N3 & 1) << 13;
        info |= !(o.occF & 0b0001) << 12;
        info |= !(o.occF & 0b1000) << 11;
        info |= !(o.occF & 0b0010) << 10;
        info |= (o.edgeBits & 0b000011) << 8;
      } else {
        info = 0b0010 << 15;
        info |= !(o.occB & 0b0100) << 14;
        info |= !(o.N3 & 1) << 12;
        info |= !(o.occB & 0b0001) << 12;
        info |= !(o.occB & 0b1000) << 11;
        info |= !(o.occB & 0b0010) << 10;
        info |= (o.edgeBits & 0b110000) << (8 - 4);
      }
      info |= (o.N3 >> 1) << 6;
      info |= gb(N20, 15, 13, 8) << 3;
      info |= gb(N20, 12, 16, 18);
    }
    sparse = false;
    c1 = info >> 13;
    c2 = info & 0x1FFF;
  } else {
    int lfb = o.neighPatternLFB;
    if (NN) {
      if (occL4) {
        info = 1 << 14;
        info |= !(occL4 & 1) << 13;
        info |= !(lfb & 4) << 12;
        info |= !(lfb & 2) << 11;
      } else if (o.occF) {
        info = 2 << 14;
        info |= !(o.occF & 1) << 13;
        info |= !(lfb & 4) << 12;
        info |= !(lfb & 1) << 11;
      } else {
        info = 3 << 14;
        info |= !(o.occB & 1) << 13;
        info |= !(lfb & 2) << 12;
        info |= !(lfb & 1) << 11;
      }
    } else {
      info = 0 << 14;
      info |= lfb << 11;
    }
    info |= gb(N20, 8, 13, 15, 12) << 7;
    if (lfb) {
      if (o.occOrLFBfb & 16) {
        info |= 1 << 6;
        info |= !(o.occBottom & 16) << 5;
        info |= !(o.occFront & 16) << 4;
        info |= !(o.occLeft & 16) << 3;
      } else {
        info |= !o.edgeBits << 5;
        info |= ((o.occLeft & 64) || (o.occFront & 8)
                 || (o.occBottom & 8)) << 4;
        info |= ((o.occLeft & 32) || (o.occFront & 64)
                 || (o.occBottom & 32)) << 3;
      }
    } else {
      info |= !(o.edgeBits & 0b110000) << 6;
      info |= !(o.edgeBits & 0b001100) << 5;
      info |= !(o.edgeBits & 0b000011) << 4;
    }
    info |= gb(N20, 16, 18, 19);
    sparse = true;
    c1 = info >> 12;
    c2 = info & 0x0FFF;
  }
}

static void ctxBit5(NeighInfo& o, int occ, int& c1, int& c2,
                    bool& sparse) {
  int info = 0;
  const int N20 = o.neighb20;
  const int occL4 = occ & 15;
  if (o.occF) {
    info = ((occ >> 4) & 1) << 18;
    info |= !(o.occF & 0b1000) << 17;
    info |= !occL4 << 16;
    if (occL4) {
      info |= !(occL4 & 0b0010) << 15;
      info |= !(o.N3 & 4) << 14;
      info |= !(o.N3 & 1) << 13;
      info |= !(o.occF & 0b0010) << 12;
      info |= !(o.occF & 0b0100) << 11;
      info |= !(occL4 & 0b0001) << 10;
      info |= !(occL4 & 0b1000) << 9;
      info |= !(o.occF & 0b0001) << 8;
      info |= !(occL4 & 0b0100) << 7;
      info |= gb(N20, 16, 13, 9, 14) << 3;
    } else {
      info |= !(o.N3 & 4) << 15;
      info |= !(o.N3 & 1) << 14;
      info |= !(o.occF & 0b0010) << 13;
      info |= !(o.occF & 0b0100) << 12;
      info |= !(o.occF & 0b0001) << 11;
      info |= gb(N20, 16, 13, 9, 14) << 7;
      info |= !(o.occBottom & 32) << 6;
      info |= !(o.occFront & 32) << 5;
      info |= !(o.occLeft & 32) << 4;
      info |= !(o.N3 & 2) << 3;
    }
    info |= gb(N20, 18, 19, 11);
    sparse = false;
    c1 = info >> 13;
    c2 = info & 0x1FFF;
  } else {
    info = !((occ >> 4) & 1) << 18;
    info |= !(occL4 & 0b0010) << 17;
    info |= !(o.N3 & 4) << 16;
    info |= !(o.N3 & 1) << 15;
    info |= !(occL4 & 0b0001) << 14;
    info |= !(occL4 & 0b1000) << 13;
    info |= !(o.occL & 0b0100) << 12;
    info |= gb(N20, 9, 13, 16, 14) << 8;
    if (o.occOrLFBfb & 32) {
      info |= 1 << 7;
      info |= !(o.occBottom & 32) << 6;
      info |= !(o.occFront & 32) << 5;
      info |= !(o.occLeft & 32) << 4;
    } else {
      info |= !(o.edgeBits & 0b111100) << 6;
      info |= ((o.occLeft & 128) || (o.occFront & 2)) << 5;
      info |= ((o.occLeft & 16) || (o.occFront & 16)) << 4;
    }
    info |= !o.occB << 3;
    info |= gb(N20, 18, 19, 11);
    sparse = true;
    c1 = info >> 12;
    c2 = info & 0x0FFF;
  }
}

static void ctxBit6(NeighInfo& o, int occ, int& c1, int& c2,
                    bool& sparse) {
  int info = 0;
  const int N20 = o.neighb20;
  const int occL4 = occ & 15;
  if (o.occB) {
    info = !((occ >> 4) & 1) << 18;
    info |= !(o.occB & 0b1000) << 17;
    info |= !occL4 << 16;
    if (occL4) {
      info |= !(occL4 & 0b0100) << 15;
      info |= !(o.N3 & 1) << 14;
      info |= !(o.N3 & 2) << 13;
      info |= !((occ >> 4) & 2) << 12;
      info |= !(o.occB & 0b0010) << 11;
      info |= !(occL4 & 0b0001) << 10;
      info |= !(occL4 & 0b1000) << 9;
      info |= !(o.occB & 0b0100) << 8;
      info |= gb(N20, 18, 15, 10) << 5;
      info |= !(o.occB & 0b0001) << 4;
      info |= !(occL4 & 0b0010) << 3;
      info |= gb(N20, 17) << 2;
      info |= gb(N20, 0) << 1;
      info |= gb(N20, 11) << 0;
    } else {
      info |= !(o.N3 & 2) << 15;
      info |= !(o.N3 & 1) << 14;
      info |= !((occ >> 4) & 2) << 13;
      info |= !(o.occB & 0b0010) << 12;
      info |= !(o.occB & 0b0100) << 11;
      info |= !(o.occB & 0b0001) << 10;
      info |= !(o.occLeft & 64) << 9;
      info |= !(o.occBottom & 64) << 8;
      info |= !(o.occFront & 64) << 7;
      info |= gb(N20, 18, 15, 10, 17) << 3;
      info |= gb(N20, 0) << 2;
      info |= gb(N20, 11, 19);
    }
    sparse = false;
    c1 = info >> 13;
    c2 = info & 0x1FFF;
  } else {
    info = !((occ >> 4) & 1) << 18;
    info |= !(occL4 & 0b0100) << 17;
    info |= !(o.N3 & 1) << 16;
    info |= !((occ >> 4) & 2) << 15;
    info |= !(occL4 & 0b1000) << 14;
    info |= !(occL4 & 0b0001) << 13;
    info |= !(occL4 & 0b0010) << 12;
    info |= gb(N20, 17, 18, 15, 10) << 8;
    if (o.occOrLFBfb & 64) {
      info |= 1 << 7;
      info |= !(o.occLeft & 64) << 6;
      info |= !(o.occBottom & 64) << 5;
      info |= !(o.occFront & 64) << 4;
    } else {
      info |= ((o.occLeft & 1) || (o.occBottom & 1)) << 6;
      info |= ((o.occLeft & 8) || (o.occBottom & 64)) << 5;
      info |= !(o.edgeBits & 0b000011) << 4;
    }
    info |= !o.occF << 3;
    info |= gb(N20, 19, 16, 11);
    sparse = true;
    c1 = info >> 12;
    c2 = info & 0x0FFF;
  }
}

static void ctxBit7(NeighInfo& o, int occ, int& c1, int& c2,
                    bool& sparse) {
  int info = 0;
  const int N20 = o.neighb20;
  const int occL4 = occ & 15;
  int NN = kNN4[occL4] + kNN4[(occ >> 4) & 7];
  if (NN > 1) {
    info = !((occ >> 4) & 4) << 16;
    info |= !((occ >> 4) & 2) << 15;
    info |= !(occL4 & 8) << 14;
    info |= o.N3 << 11;
    info |= !((occ >> 4) & 1) << 10;
    info |= gb(N20, 11) << 9;
    info |= !(occL4 & 4) << 8;
    info |= gb(N20, 16) << 7;
    info |= !(occL4 & 2) << 6;
    info |= gb(N20, 18) << 5;
    info |= (occL4 & 1) << 4;
    info |= gb(N20, 19) << 3;
    info |= gb(N20, 0) << 2;
    info |= gb(N20, 17, 10);
    sparse = false;
    c1 = info >> 11;
    c2 = info & 0x07FF;
  } else {
    int occup = (occ >> 4) & 7;
    info = !occup << 17;
    if (occup) {
      info |= (!!occup + !!(occup >> 1) + !!(occup >> 2)) << 15;
      info |= !(o.N3 & 2) << 14;
    } else {
      info |= (!!(occL4 >> 1) + !!(occL4 >> 2) + !!(occL4 >> 3)) << 15;
      info |= !(o.N3 & 1) << 14;
    }
    info |= !(o.N3 & 4) << 13;
    info |= gb(N20, 11, 16, 18, 19) << 9;
    if (o.occOrLFBfb & 128) {
      info |= 1 << 8;
      info |= !(o.occLeft & 128) << 7;
      info |= !(o.occFront & 128) << 6;
      info |= !(o.occBottom & 128) << 5;
    } else {
      info |= (o.occLeft & 0b01100000) << 1;
      info |= ((o.occF & 0b0011) || (o.occB & 0b0110)) << 5;
    }
    info |= !o.occB << 4;
    info |= !o.occF << 3;
    info |= gb(N20, 7, 17, 10);
    sparse = true;
    c1 = info >> 12;
    c2 = info & 0x0FFF;
  }
}

// switch dispatch instead of a function-pointer table: lets the
// compiler inline all eight per-bit context selectors into the hot
// occupancy loops (the indirect call blocked inlining; ~20% of the
// decode profile was spent in un-inlined ctxBitN calls)
static inline void ctxBitDispatch(int i, NeighInfo& o, int occ,
                                  int& c1, int& c2, bool& sparse) {
  switch (i) {
  case 0: ctxBit0(o, occ, c1, c2, sparse); break;
  case 1: ctxBit1(o, occ, c1, c2, sparse); break;
  case 2: ctxBit2(o, occ, c1, c2, sparse); break;
  case 3: ctxBit3(o, occ, c1, c2, sparse); break;
  case 4: ctxBit4(o, occ, c1, c2, sparse); break;
  case 5: ctxBit5(o, occ, c1, c2, sparse); break;
  case 6: ctxBit6(o, occ, c1, c2, sparse); break;
  default: ctxBit7(o, occ, c1, c2, sparse); break;
  }
}

// ---------------------------------------------------------------------------
// decoder context memory (GeometryOctreeContexts subset)
// ---------------------------------------------------------------------------

// planar mode state (OctreeNodePlanar, geometry_octree.h:131)
struct NodePlanar {
  uint8_t planarPossible = 7;
  uint8_t planePosBits = 0;
  uint8_t planarMode = 0;
  bool isPCM = false;
  bool isSignaled = false;   // decoder's isRead
  bool allowPCM = false;     // intra: never
  bool isPreDirMatch = true;
  int lastDirIdx = 0;
  bool eligible[3] = {false, false, false};
  int ctxBufPCM = 0;
};

// setPlanesFromOccupancy (geometry_octree.cpp:292)
static void planesFromOccupancy(int occupancy, NodePlanar& planar) {
  uint8_t plane0 = 0;
  plane0 |= !!(occupancy & 0x0f) << 0;
  plane0 |= !!(occupancy & 0x33) << 1;
  plane0 |= !!(occupancy & 0x55) << 2;
  uint8_t plane1 = 0;
  plane1 |= !!(occupancy & 0xf0) << 0;
  plane1 |= !!(occupancy & 0xcc) << 1;
  plane1 |= !!(occupancy & 0xaa) << 2;
  planar.planarMode = plane0 ^ plane1;
  planar.planePosBits = planar.planarMode & plane1;
}

// per-axis closest-plane history (OctreePlanarBuffer,
// geometry_octree.h:725-775): rowSize=1, pos is 5 bits, planeIdx in
// {-2 unused, -1 not planar, 0, 1}
struct PlanarBuffer {
  static const int kNumBitsC = 14;
  static const int kShiftAb = 3;
  static const int kMaskAb = ((1 << 5) - 1) << kShiftAb;
  static const int kMaskC = (1 << kNumBitsC) - 1;
  struct Elmt {
    uint8_t pos;
    int8_t planeIdx;
  };
  std::vector<Elmt> buf;
  int colOff[3] = {0, 0, 0};
  bool enabled = false;

  void resize(const int depthStv[3]) {
    int rows[3];
    for (int k = 0; k < 3; k++) {
      long n = 1L << std::min(depthStv[k], 24);
      rows[k] = int(n > kMaskC ? kMaskC + 1 : n);
    }
    buf.assign(size_t(rows[0]) + rows[1] + rows[2], Elmt{0, -2});
    colOff[0] = 0;
    colOff[1] = rows[0];
    colOff[2] = rows[0] + rows[1];
    enabled = true;
  }
  Elmt* col(int dim) { return buf.data() + colOff[dim]; }
};

// planar rate/eligibility state (OctreePlanarState,
// geometry_octree.h:777-793, geometry_octree.cpp:380-460)
struct PlanarState {
  bool bufferEnabled = false;
  bool multiplePlanar = false;
  PlanarBuffer buffer;
  int rate[3] = {128 * 8, 128 * 8, 128 * 8};
  int localDensity = 1024 * 4;
  int rateThreshold[3] = {0, 0, 0};

  void initPlanes(const int depthStv[3]) {
    if (bufferEnabled)
      buffer.resize(depthStv);
  }
  void updateRate(int occupancy, int numSiblings) {
    bool px = !((occupancy & 0xf0) && (occupancy & 0x0f));
    bool py = !((occupancy & 0xcc) && (occupancy & 0x33));
    bool pz = !((occupancy & 0x55) && (occupancy & 0xaa));
    rate[0] = (255 * rate[0] + (px ? 256 * 8 : 0) + 128) >> 8;
    rate[1] = (255 * rate[1] + (py ? 256 * 8 : 0) + 128) >> 8;
    rate[2] = (255 * rate[2] + (pz ? 256 * 8 : 0) + 128) >> 8;
    localDensity = (255 * localDensity + 1024 * numSiblings) >> 8;
  }
  void isEligible(bool eligible[3]) const {
    eligible[0] = eligible[1] = eligible[2] = false;
    if (localDensity >= 3 * 1024)
      return;
    if (rate[0] >= rate[1] && rate[0] >= rate[2]) {
      eligible[0] = rate[0] >= rateThreshold[0];
      if (rate[1] >= rate[2]) {
        eligible[1] = rate[1] >= rateThreshold[1];
        eligible[2] = rate[2] >= rateThreshold[2];
      } else {
        eligible[2] = rate[2] >= rateThreshold[1];
        eligible[1] = rate[1] >= rateThreshold[2];
      }
    } else if (rate[1] >= rate[0] && rate[1] >= rate[2]) {
      eligible[1] = rate[1] >= rateThreshold[0];
      if (rate[0] >= rate[2]) {
        eligible[0] = rate[0] >= rateThreshold[1];
        eligible[2] = rate[2] >= rateThreshold[2];
      } else {
        eligible[2] = rate[2] >= rateThreshold[1];
        eligible[0] = rate[0] >= rateThreshold[2];
      }
    } else {
      eligible[2] = rate[2] >= rateThreshold[0];
      if (rate[0] >= rate[1]) {
        eligible[0] = rate[0] >= rateThreshold[1];
        eligible[1] = rate[1] >= rateThreshold[2];
      } else {
        eligible[1] = rate[1] >= rateThreshold[1];
        eligible[0] = rate[0] >= rateThreshold[2];
      }
    }
  }
};

// IDCM contexts (GeometryOctreeDecoder _ctxBlockSkipTh etc.)
struct IdcmContexts {
  uint16_t blockSkip = 0x8000;
  uint16_t numPointsGt1 = 0x8000;
  uint16_t dupGt1 = 0x8000;
  uint16_t sameBitHi[3][5];
  // angular IDCM residual contexts (_ctxThetaRes/_ctxZRes,
  // geometry_octree.h:867-874)
  uint16_t thetaRes[2][3];
  uint16_t thetaResSign[3];
  uint16_t thetaResExp = 0x8000;
  uint16_t zRes[3];
  uint16_t zResSign = 0x8000;
  uint16_t zResExp = 0x8000;
  void reset() {
    blockSkip = numPointsGt1 = dupGt1 = 0x8000;
    for (int a = 0; a < 3; a++)
      for (int i = 0; i < 5; i++)
        sameBitHi[a][i] = 0x8000;
    for (int a = 0; a < 2; a++)
      for (int i = 0; i < 3; i++)
        thetaRes[a][i] = 0x8000;
    for (int i = 0; i < 3; i++) {
      thetaResSign[i] = 0x8000;
      zRes[i] = 0x8000;
    }
    thetaResExp = zResSign = zResExp = 0x8000;
  }
};


struct RefOctreeCtx {
  uint16_t ctxSingleChild = 0x8000;
  uint16_t ctxDupPointCntGt0 = 0x8000;
  uint16_t ctxDupPointCntEgl = 0x8000;
  ObufModel obufModel;
  CtxMapOBUF mapOcc[4][8];
  CtxMapOBUF mapOccSparse[4][8];
  std::vector<uint8_t> leaves;
  int leafNumber = 0;

  // planar contexts
  uint16_t ctxPlanarMode[9];
  uint16_t ctxMultiPlanarMode = 0x8000;
  uint16_t ctxPlanarPlaneLastIndex[3][3][3][4];
  uint16_t ctxPlanarPlaneLastIndexZ[9];
  // inter planar copy mode (_ctxPlanarCopyMode[16][8],
  // geometry_octree.h:882)
  uint16_t ctxPlanarCopyMode[16][8];
  // angular planar contexts ([refPlane][ctx];
  // _ctxPlanarPlaneLastIndexAngular[Phi], geometry_octree.h:887-890)
  uint16_t ctxPlanarPlaneLastIndexAngular[3][4];
  uint16_t ctxPlanarPlaneLastIndexAngularPhi[3][8];
  uint16_t ctxPlanarPlaneLastIndexAngularIdcm[4];
  uint16_t ctxPlanarPlaneLastIndexAngularPhiIdcm[8][3];
  CtxMapOBUF mapPlanarPos[3][3];      // [refPlane][planeId]
  ObufModel planarModel[3];           // per planeId
  std::vector<uint8_t> planarLeaves;
  int planarLeafNumber = 0;
  IdcmContexts idcm;

  void resetMaps(bool enablePlanar) {
    // GeometryOctreeContexts::resetMap (geometry_octree.cpp:877)
    const int n2 = 6;
    for (int i = 0; i < 4; i++) {
      for (int k = 0; k < 8; k++) {
        int bits1 = (k == 3 || k == 7) ? (4 + n2 + 1) : (6 + n2 + 1);
        mapOcc[i][k].reset(bits1, 18 - 6 - n2);
      }
      static const int sparseBits2[8] = {9 - 5, 12 - 5, 12 - 5, 11 - 5,
                                         9 - 5, 12 - 5, 12 - 5, 11 - 5};
      for (int k = 0; k < 8; k++)
        mapOccSparse[i][k].reset(6 + 5 + 1, sparseBits2[k]);
    }
    leaves.assign(size_t(CtxMapOBUF::kLeafBufSize)
                  << CtxMapOBUF::kLeafDepth, 0);
    leafNumber = 0;
    obufModel.init();
    for (int i = 0; i < 9; i++) {
      ctxPlanarMode[i] = 0x8000;
      ctxPlanarPlaneLastIndexZ[i] = 0x8000;
    }
    for (int i = 0; i < 4; i++) {
      for (int r = 0; r < 3; r++)
        ctxPlanarPlaneLastIndexAngular[r][i] = 0x8000;
      ctxPlanarPlaneLastIndexAngularIdcm[i] = 0x8000;
    }
    for (int i = 0; i < 8; i++) {
      for (int r = 0; r < 3; r++)
        ctxPlanarPlaneLastIndexAngularPhi[r][i] = 0x8000;
      for (int j = 0; j < 3; j++)
        ctxPlanarPlaneLastIndexAngularPhiIdcm[i][j] = 0x8000;
    }
    for (int i = 0; i < 16; i++)
      for (int j = 0; j < 8; j++)
        ctxPlanarCopyMode[i][j] = 0x8000;
    idcm.reset();
    for (int a = 0; a < 3; a++)
      for (int b = 0; b < 3; b++)
        for (int c = 0; c < 3; c++)
          for (int d = 0; d < 4; d++)
            ctxPlanarPlaneLastIndex[a][b][c][d] = 0x8000;
    if (enablePlanar) {
      for (int k = 0; k < 3; k++) {
        for (int r = 0; r < 3; r++)
          mapPlanarPos[r][k].reset(10, 8);
        planarModel[k].init();
      }
      planarLeaves.assign(size_t(CtxMapOBUF::kLeafBufSize)
                          << CtxMapOBUF::kLeafDepth, 0);
      planarLeafNumber = 0;
    }
  }
};

// tool configuration shared by encode/decode entry points; mirrors the
// GPS fields (order fixed by the Python glue)
struct GeomParams {
  int neighAvailBoundaryLog2;   // minus1 + 1
  int adjacentChildCtx;
  int uniquePoints;
  int planarEnabled;
  int planarBufferEnabled;
  int multiplePlanar;
  int depthPlanarEligibility;
  int planarDynamicObufEligibility;
  int planarTh[3];
  int bypassNoUpdate;           // sps bypass_bin_coding_without_prob_update
  int idcmMode;                 // gps inferred_direct_coding_mode (0-3)
  int jointTwoPointIdcm;        // gps joint_2pt_idcm_enabled_flag
  int idcmRateMinus1;           // gps geom_idcm_rate_minus1
  int cabacBypassStream;        // sps cabac_bypass_stream_enabled_flag
};

// mkIdcmEnableMask (geometry_octree.cpp:264)
static inline uint32_t mkIdcmEnableMask(const GeomParams& gp) {
  if (!gp.idcmMode)
    return 0;
  if (gp.idcmMode != 1)
    return 0xffffffffu;
  if (!gp.planarEnabled)
    return 0xffffffffu;
  uint32_t mask = 0;
  int acc = 0;
  for (int i = 0; i < 32; i++) {
    acc += gp.idcmRateMinus1 + 1;
    mask |= uint32_t(acc >= 32) << i;
    acc &= 0x1f;
  }
  return mask;
}

static inline uint32_t rotr32(uint32_t v, int n) {
  n &= 31;
  return n ? ((v >> n) | (v << (32 - n))) : v;
}

// isDirectModeEligible (geometry_octree.h:177)
static inline bool idcmEligibleIntra(
  int intensity, int nodeMaxDimLog2, int nodeNeighPattern,
  int parentNumSiblings, int childNumSiblings,
  bool occupancyIsPredictable = false, bool isAngular = false) {
  if (!intensity)
    return false;
  if (occupancyIsPredictable && !isAngular)
    return false;
  if (intensity == 1)
    return (nodeMaxDimLog2 >= 2) && (nodeNeighPattern == 0)
      && (childNumSiblings == 1) && (parentNumSiblings <= 2);
  if (intensity == 2)
    return (nodeMaxDimLog2 >= 2) && (nodeNeighPattern == 0);
  if (intensity == 3)
    return (nodeMaxDimLog2 >= 2) && (childNumSiblings > 1);
  return false;
}

// isDirectModeEligible_Inter (geometry_octree.h:211): the inter
// (non-angular) eligibility collapses every intensity to the
// intensity-1 shape and bars predictable nodes
static inline bool idcmEligibleInter(
  int intensity, int nodeMaxDimLog2, int nodeNeighPattern,
  int parentNumSiblings, int childNumSiblings,
  bool occupancyIsPredictable) {
  if (!intensity)
    return false;
  if (occupancyIsPredictable)
    return false;
  return (nodeMaxDimLog2 >= 2) && (nodeNeighPattern == 0)
    && (childNumSiblings == 1) && (parentNumSiblings <= 2);
}

// joint two-point prefix coding (encodeOrdered2ptPrefix,
// geometry_octree_encoder.cpp:985; decoder :1013); intra: all axes
// directly coded
static inline void encodeOrdered2ptPrefixIntra(
  ArithEnc& aec, IdcmContexts& ic, int32_t pts[2][3],
  int sizeRem[3]) {
  for (int k = 0; k < 3; k++) {
    if (sizeRem[k] < 1)
      continue;
    bool samePrev = true;
    for (int j = 0; j < k; j++)
      samePrev = samePrev && pts[0][j] == pts[1][j];
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

static inline void decodeOrdered2ptPrefixIntra(
  ArithDec& aec, IdcmContexts& ic, int32_t pts[2][3],
  int sizeRem[3]) {
  for (int k = 0; k < 3; k++) {
    if (sizeRem[k] < 1)
      continue;
    bool samePrev = true;
    for (int j = 0; j < k; j++)
      samePrev = samePrev && pts[0][j] == pts[1][j];
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

struct Node {
  int32_t pos[3];
  int32_t rstart = 0, rend = 0;  // compensated-reference point range
  int32_t rstart2 = 0, rend2 = 0;  // second reference (bi-prediction)
  uint8_t idcmEligible = 0;
  uint8_t siblingOccupancy;
  uint8_t numSiblingsPlus1;
  uint8_t mispred = 0;           // parent's prediction failures
  uint8_t predDir = 0;           // bi-prediction: selected reference
  uint8_t laserIndex = 255;      // angular: inherited laser id
};

// ---------------------------------------------------------------------------
// planar mode coding, intra subset (no PCM, no angular, no inter ref)
// (decodePlanarMode geometry_octree_decoder.cpp:312-497,
//  encodePlanarMode geometry_octree_encoder.cpp, determinePlanarMode
//  both files)
// ---------------------------------------------------------------------------

static const int kAdjPlaneCtx[4] = {0, 1, 2, 0};

// shared context derivation for the plane-position bit under the
// dynamic-OBUF planar path; fills ctx1/ctx2
static void planarPosObufCtx(
  int planeId, int lastIndexPlane2d, int planePosCtx,
  const NodePlanar adjNeighPlanar[7], bool neighAvai,
  uint32_t neighOccu, int& c1, int& c2) {
  const int mask0 = 1 << planeId;
  if (neighAvai) {
    int coPlaneBits = (!!(adjNeighPlanar[0].planePosBits & mask0) << 2)
      | (!!(adjNeighPlanar[1].planePosBits & mask0) << 1)
      | !!(adjNeighPlanar[2].planePosBits & mask0);
    int coPlaneMode = (!!(adjNeighPlanar[0].planarMode & mask0) << 2)
      | (!!(adjNeighPlanar[1].planarMode & mask0) << 1)
      | !!(adjNeighPlanar[2].planarMode & mask0);
    int coPlane = (coPlaneBits << 3) | coPlaneMode;
    int coEdgeBits = (!!(adjNeighPlanar[3].planePosBits & mask0) << 2)
      | (!!(adjNeighPlanar[4].planePosBits & mask0) << 1)
      | !!(adjNeighPlanar[5].planePosBits & mask0);
    int coEdgeMode = (!!(adjNeighPlanar[3].planarMode & mask0) << 2)
      | (!!(adjNeighPlanar[4].planarMode & mask0) << 1)
      | !!(adjNeighPlanar[5].planarMode & mask0);
    int coEdge = (coEdgeBits << 3) | coEdgeMode;
    int coVertex = (!!(adjNeighPlanar[6].planePosBits & mask0) << 1)
      | !!(adjNeighPlanar[6].planarMode & mask0);
    c1 = (lastIndexPlane2d << 6) | coPlane;
    c2 = (planePosCtx << 8) | (coEdge << 2) | coVertex;
  } else {
    c1 = (1 << 7) | (lastIndexPlane2d << 5) | ((planePosCtx & 3) << 3)
      | ((neighOccu >> 9) & 7);
    c2 = (1 << 9) | (neighOccu & ((1 << 9) - 1));
  }
}

// decode one plane flag/position; returns planeBit or -1.
// contextAngle >= 0 selects the angular context branch.  planarRef
// carries the inter prediction planes (zeroed NodePlanar for intra,
// reducing every inter term to the intra behaviour)
// (decodePlanarMode, geometry_octree_decoder.cpp:313-500)
static int decodePlanarModeIntra(
  ArithDec& aec, RefOctreeCtx& ctx, bool multiplePlanar, bool dynObuf,
  NodePlanar& planar, int planeZ, int dist, int adjPlanes, int planeId,
  const bool* multiPlanarFlag, const bool* multiPlanarEligible,
  const NodePlanar adjNeighPlanar[7], bool neighAvai,
  uint32_t neighOccu, int contextAngle = -1,
  const NodePlanar* planarRefArg = nullptr) {
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
        isPlanar = aec.bit(&ctx.ctxPlanarMode[ctxIdxPlanarFlag]) != 0;
      else if (!multiPlanarFlagFalse)
        isPlanar = true;
      else
        isPlanar = false;
    } else {
      isPlanar = aec.bit(&ctx.ctxPlanarMode[ctxIdxPlanarFlag]) != 0;
    }
  }

  planar.planarMode |= isPlanar ? mask0 : 0;
  if (!isPlanar) {
    planar.planarPossible &= kMask1[planeId];
    return -1;
  }

  int planeBit;
  if (planar.isPCM) {
    // plane position copied from the reference (decoder :393-397)
    planeBit = planeBitRef;
    planar.planePosBits |= planeBit << planeId;
    return planeBit;
  }
  // inferred inverted bit when the PCM copy failed on the last
  // eligible direction (decoder :399-406)
  if (planeId == planar.lastDirIdx && planar.isPreDirMatch
      && planar.allowPCM && isPlanarRef) {
    planeBit = planeBitRef == 1 ? 0 : 1;
    planar.planePosBits |= planeBit << planeId;
    return planeBit;
  }
  const int refPlane = isPlanarRef ? 1 + planeBitRef : 0;
  if (contextAngle >= 0) {
    // angular branch (decoder :487-497)
    if (planeId == 2)
      planeBit = aec.bit(
        &ctx.ctxPlanarPlaneLastIndexAngular[refPlane][contextAngle]);
    else
      planeBit = aec.bit(
        &ctx.ctxPlanarPlaneLastIndexAngularPhi[refPlane][contextAngle]);
    planar.planePosBits |= planeBit << planeId;
    return planeBit;
  }
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
        aec.bit(&ctx.ctxPlanarPlaneLastIndexZ[planePosCtxTmp]);
    } else {
      int discreteDist = dist > (8 >> PlanarBuffer::kShiftAb);
      int lastIndexPlane2d = planeZ + (discreteDist << 1);
      planeBit = aec.bit(
        &ctx.ctxPlanarPlaneLastIndex[refPlane][planeId][planePosCtx]
                                    [lastIndexPlane2d]);
    }
  }
  planar.planePosBits |= planeBit << planeId;
  return planeBit;
}

// encode mirror of the above; planar bits are already set from the
// actual occupancy
static int encodePlanarModeIntra(
  ArithEnc& aec, RefOctreeCtx& ctx, bool multiplePlanar, bool dynObuf,
  NodePlanar& planar, int planeZ, int dist, int adjPlanes, int planeId,
  const bool* multiPlanarFlag, const bool* multiPlanarEligible,
  const NodePlanar adjNeighPlanar[7], bool neighAvai,
  uint32_t neighOccu, int contextAngle = -1,
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
        aec.bit(&ctx.ctxPlanarMode[ctxIdxPlanarFlag], isPlanar);
    } else {
      aec.bit(&ctx.ctxPlanarMode[ctxIdxPlanarFlag], isPlanar);
    }
  }

  if (!isPlanar) {
    planar.planarPossible &= kMask1[planeId];
    return -1;
  }

  if (planar.isPCM)
    return planeBit;

  // inferred inverted bit (encoder :390-399)
  if (planeId == planar.lastDirIdx && planar.isPreDirMatch
      && planar.allowPCM && isPlanarRef)
    return planeBit;

  const int refPlane = isPlanarRef ? 1 + planeBitRef : 0;
  if (contextAngle >= 0) {
    if (planeId == 2)
      aec.bit(
        &ctx.ctxPlanarPlaneLastIndexAngular[refPlane][contextAngle],
        planeBit);
    else
      aec.bit(
        &ctx.ctxPlanarPlaneLastIndexAngularPhi[refPlane][contextAngle],
        planeBit);
    return planeBit;
  }
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
    uint8_t obufIdx = ctx.mapPlanarPos[refPlane][planeId].getEvolve(
      planeBit, c2, c1, &ctx.planarLeafNumber,
      ctx.planarLeaves.data());
    aec.bit_bounded(&ctx.planarModel[planeId].prob[obufIdx >> 3],
                    obufIdx >> 3, ctx.planarModel[planeId].bound,
                    planeBit);
  } else {
    if (planeZ < 0) {
      int planePosCtxTmp = planePosCtx;
      if (isPlanarRef)
        planePosCtxTmp += 3 * (planeBitRef + 1);
      aec.bit(&ctx.ctxPlanarPlaneLastIndexZ[planePosCtxTmp], planeBit);
    } else {
      int discreteDist = dist > (8 >> PlanarBuffer::kShiftAb);
      int lastIndexPlane2d = planeZ + (discreteDist << 1);
      aec.bit(&ctx.ctxPlanarPlaneLastIndex[refPlane][planeId]
                                          [planePosCtx]
                                          [lastIndexPlane2d],
              planeBit);
    }
  }
  return planeBit;
}

// per-plane wrapper: buffer lookup, adjacent-plane context, rate
// update (determinePlanarMode single-plane overload, decoder :556)
template<typename CodePlane>
static void determinePlanarPlane(
  RefOctreeCtx& ctx, PlanarState& planarState, bool adjChildCtx,
  int planeId, NodePlanar& planar, PlanarBuffer::Elmt* planeBuffer,
  int coord1, int coord2, int coord3, int posInParent,
  const NeighPattern& gnp, uint8_t siblingOccupancy,
  CodePlane codePlane, const NodePlanar* planarRef = nullptr) {
  static const int kAdjNeighIdxFromPlanePos[3][2] = {{1, 0}, {2, 3},
                                                     {4, 5}};
  const int planeSelector = 1 << planeId;
  static const uint8_t kAdjNeighIdxMask[3][2] = {{0x0f, 0xf0},
                                                 {0x33, 0xcc},
                                                 {0x55, 0xaa}};
  PlanarBuffer::Elmt* row = nullptr;
  int closestPlanarFlag;
  int closestDist;
  int maxCoord = 0;
  if (!planeBuffer) {
    closestPlanarFlag = -1;
    closestDist = 0;
  } else {
    coord1 = (coord1 & PlanarBuffer::kMaskAb) >> PlanarBuffer::kShiftAb;
    coord2 = (coord2 & PlanarBuffer::kMaskAb) >> PlanarBuffer::kShiftAb;
    coord3 = coord3 & PlanarBuffer::kMaskC;
    row = &planeBuffer[coord3];
    maxCoord = std::max(coord1, coord2);
    closestDist = std::abs(maxCoord - int(row[0].pos));
    closestPlanarFlag = row[0].planeIdx;
  }

  int pos = !(kAdjNeighIdxMask[planeId][0] & (1 << posInParent));
  bool lowAdj = adjChildCtx
    ? (kAdjNeighIdxMask[planeId][1] & gnp.adjOcc[planeId]) != 0
    : ((gnp.pattern >> kAdjNeighIdxFromPlanePos[planeId][0]) & 1) != 0;
  bool highAdj = !pos
    ? (kAdjNeighIdxMask[planeId][1] & siblingOccupancy) != 0
    : ((gnp.pattern >> kAdjNeighIdxFromPlanePos[planeId][1]) & 1) != 0;
  int adjPlanes = (int(highAdj) << 1) | int(lowAdj);

  int planeBit = codePlane(planar, closestPlanarFlag, closestDist,
                           adjPlanes, planeId);
  bool isPlanar = (planar.planarMode & planeSelector) != 0;
  planarState.rate[planeId] =
    (255 * planarState.rate[planeId] + (isPlanar ? 256 * 8 : 0) + 128)
    >> 8;
  if (planeBuffer)
    *row = PlanarBuffer::Elmt{uint8_t(maxCoord), int8_t(planeBit)};
  if (planarRef) {
    // isPreDirMatch book-keeping (decoder :645-651, encoder :641-647)
    bool isPlanarRef = (planarRef->planarMode & planeSelector) != 0;
    int planeBitRef =
      (planarRef->planePosBits & planeSelector) == 0 ? 0 : 1;
    if (!(isPlanar == isPlanarRef && planeBit == planeBitRef))
      planar.isPreDirMatch = false;
  }
}

// inter PCM context derivation (derivePlanarPCMContextBuffer,
// geometry_octree_decoder.cpp:505-551 / encoder :508-556): counts how
// many eligible directions' closest-plane history matches the
// reference planes
static void derivePlanarPCMCtxBuf(
  NodePlanar& planar, NodePlanar& planarRef, PlanarState& planarState,
  const int32_t pos[3]) {
  int matchedDir = 0;
  planarRef.ctxBufPCM = 4
    * (int(planar.eligible[0]) + int(planar.eligible[1])
       + int(planar.eligible[2]) - 1);
  for (int planeId = 0; planeId < 3; planeId++) {
    if (!planar.eligible[planeId])
      continue;
    const int mask0 = 1 << planeId;
    bool isPlanarRef = (planarRef.planarMode & mask0) != 0;
    int planeBitRef = (planarRef.planePosBits & mask0) == 0 ? 0 : 1;
    if (planarState.bufferEnabled) {
      int coord3 = pos[planeId] & PlanarBuffer::kMaskC;
      const PlanarBuffer::Elmt& closest =
        planarState.buffer.col(planeId)[coord3];
      bool closestPL = closest.planeIdx > -1;
      int closestPlane = closestPL ? closest.planeIdx : 0;
      matchedDir +=
        int(closestPL == isPlanarRef && closestPlane == planeBitRef);
    }
  }
  planarRef.ctxBufPCM += matchedDir;
}

// 3-plane wrappers (determinePlanarMode, decoder :652 / encoder):
// the decoder reads the multi-planar flag, the encoder derives it
// from the occupancy and codes it.

static int kindOfEligible(const bool e[3]) {
  if (e[2] && e[1] && e[0]) return 0;
  if (!e[2] && e[1] && e[0]) return 1;
  if (e[2] && !e[1] && e[0]) return 2;
  if (e[2] && e[1] && !e[0]) return 3;
  return -1;
}

static void determinePlanarIntraDec(
  ArithDec& aec, RefOctreeCtx& ctx, PlanarState& planarState,
  const GeomParams& gp, bool dynObuf, const bool planarEligible[3],
  int posInParent, const NeighPattern& gnp, const int32_t childPos[3],
  uint8_t siblingOccupancy, NodePlanar& planar,
  int contextAngle = -1, int contextAnglePhiX = -1,
  int contextAnglePhiY = -1, NodePlanar* planarRef = nullptr) {
  NodePlanar adjNeighPlanar[7];
  if (dynObuf && gnp.neighOccuValid)
    for (int idx = 0; idx < 7; ++idx)
      if (gnp.adjOcc[idx])
        planesFromOccupancy(gnp.adjOcc[idx], adjNeighPlanar[idx]);

  if (planarRef) {
    // inter: mask the reference planes by eligibility, derive the
    // PCM context and read the copy-mode flag
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
        aec.bit(&ctx.ctxPlanarCopyMode[planarRef->ctxBufPCM]
                                      [planarRef->planarMode]) != 0;
      planar.isSignaled = true;
    }
  }

  bool multiPlanarFlag[4] = {false, false, false, false};
  bool multiPlanarEligible[4] = {false, false, false, false};
  if (planarState.multiplePlanar && !planar.isPCM) {
    int kind = kindOfEligible(planarEligible);
    if (kind >= 0) {
      multiPlanarEligible[kind] = true;
      multiPlanarFlag[kind] = aec.bit(&ctx.ctxMultiPlanarMode) != 0;
    }
  }

  struct Dir {
    int planeId, c1, c2, c3, ctxAngle;
  };
  const Dir dirs[3] = {
    {0, childPos[1], childPos[2], childPos[0], contextAnglePhiX},
    {1, childPos[0], childPos[2], childPos[1], contextAnglePhiY},
    {2, childPos[0], childPos[1], childPos[2], contextAngle}};
  for (const Dir& d : dirs) {
    if (!planarEligible[d.planeId])
      continue;
    PlanarBuffer::Elmt* buf = planarState.bufferEnabled
      ? planarState.buffer.col(d.planeId) : nullptr;
    determinePlanarPlane(
      ctx, planarState, gp.adjacentChildCtx != 0, d.planeId, planar,
      buf, d.c1, d.c2, d.c3, posInParent, gnp, siblingOccupancy,
      [&](NodePlanar& pl, int planeZ, int dist, int adjPlanes,
          int planeId) {
        return decodePlanarModeIntra(
          aec, ctx, planarState.multiplePlanar, dynObuf, pl, planeZ,
          dist, adjPlanes, planeId, multiPlanarFlag,
          multiPlanarEligible, adjNeighPlanar, gnp.neighOccuValid,
          gnp.neighborOccu, d.ctxAngle, planarRef);
      }, planarRef);
  }
}

static void determinePlanarIntraEnc(
  ArithEnc& aec, RefOctreeCtx& ctx, PlanarState& planarState,
  const GeomParams& gp, bool dynObuf, const bool planarEligible[3],
  int posInParent, const NeighPattern& gnp, const int32_t childPos[3],
  uint8_t siblingOccupancy, int occupancy, NodePlanar& planar,
  int contextAngle = -1, int contextAnglePhiX = -1,
  int contextAnglePhiY = -1, NodePlanar* planarRef = nullptr) {
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
    // inter: decide + signal the PCM copy mode
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
      aec.bit(&ctx.ctxPlanarCopyMode[planarRef->ctxBufPCM]
                                    [planarRef->planarMode],
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
      aec.bit(&ctx.ctxMultiPlanarMode, v);
    }
  }

  struct Dir {
    int planeId, c1, c2, c3, ctxAngle;
  };
  const Dir dirs[3] = {
    {0, childPos[1], childPos[2], childPos[0], contextAnglePhiX},
    {1, childPos[0], childPos[2], childPos[1], contextAnglePhiY},
    {2, childPos[0], childPos[1], childPos[2], contextAngle}};
  for (const Dir& d : dirs) {
    if (!planarEligible[d.planeId])
      continue;
    PlanarBuffer::Elmt* buf = planarState.bufferEnabled
      ? planarState.buffer.col(d.planeId) : nullptr;
    determinePlanarPlane(
      ctx, planarState, gp.adjacentChildCtx != 0, d.planeId, planar,
      buf, d.c1, d.c2, d.c3, posInParent, gnp, siblingOccupancy,
      [&](NodePlanar& pl, int planeZ, int dist, int adjPlanes,
          int planeId) {
        return encodePlanarModeIntra(
          aec, ctx, planarState.multiplePlanar, dynObuf, pl, planeZ,
          dist, adjPlanes, planeId, multiPlanarFlag,
          multiPlanarEligible, adjNeighPlanar, gnp.neighOccuValid,
          gnp.neighborOccu, d.ctxAngle, planarRef);
      }, planarRef);
  }
}

// ---------------------------------------------------------------------------
// cacheline-packed dynamic context map.  Semantically identical to
// CtxMapOBUF above (same values, same evolution, same leaf policy);
// the three per-entry bytes (coder index / kDown / seen counter) live
// in one 4-byte struct so a context probe touches one cache line
// instead of three.  Used by the level-sweep engine's thin bit loop.
// ---------------------------------------------------------------------------
struct CtxMapOBUFPk {
  static const int kLeafDepth = CtxMapOBUF::kLeafDepth;
  static const int kLeafBufSize = CtxMapOBUF::kLeafBufSize;

  struct Ent {
    uint8_t ctxIdx;
    uint8_t kDown;
    uint8_t nSeen;
    uint8_t pad;
  };

  int S1 = 0, S2 = 0;
  int maxTreeDepth = 0;
  std::vector<Ent> t;

  void reset(int bitsS1, int bitsS2) {
    S1 = 1 << bitsS1;
    S2 = 1 << bitsS2;
    maxTreeDepth = bitsS1 - kLeafDepth;
    int treeSize = (1 << maxTreeDepth) * S2;
    t.assign(treeSize, Ent{0, uint8_t(bitsS1), 0, 0});
    for (int j = 0; j < S2; j++) {
      t[j].nSeen = 0;
      t[j].ctxIdx = 127;
    }
  }

  int idx(int i, int j) const { return i * S2 + j; }

  void decreaseKdown(int idxTree, int kDownTree) {
    t[idxTree].nSeen = 0;
    t[idxTree + (S2 << (kDownTree - 1))].nSeen = 0;
    int iEnd = S2 << kDownTree;
    for (int ii = 0; ii < iEnd; ii += S2)
      t[idxTree + ii].kDown--;
    t[idxTree + (S2 << (kDownTree - 1))].ctxIdx = t[idxTree].ctxIdx;
  }

  void createLeaf(int idxTree, int* leafNumber, uint8_t* leaves,
                  int ctx, int i) {
    bool avail = CtxMapOBUF::createLeafElement(*leafNumber, leaves,
                                               uint8_t(ctx));
    if (avail) {
      t[idxTree].nSeen = uint8_t(*leafNumber & 255);
      t[idxTree].ctxIdx = uint8_t(*leafNumber >> 8);
      *leafNumber += 1;
    } else {
      int dmin = 256;
      int bmin = *leafNumber;
      const int maskI = (1 << kLeafDepth) - 1;
      for (int b = *leafNumber; b < *leafNumber + 20 && b < kLeafBufSize;
           b++) {
        int d = std::abs(
          ctx - int(leaves[b * (1 << kLeafDepth) + (i & maskI)]));
        if (d < dmin) {
          dmin = d;
          bmin = b;
        }
      }
      t[idxTree].nSeen = uint8_t(bmin & 255);
      t[idxTree].ctxIdx = uint8_t(bmin >> 8);
      *leafNumber = bmin + 1;
    }
    if (*leafNumber >= kLeafBufSize)
      *leafNumber = 0;
    t[idxTree].kDown--;
  }

  uint8_t getEvolve(bool bitv, int i, int j, int* leafNumber,
                    uint8_t* leaves) {
    int iTree = i >> kLeafDepth;
    int kDown0 = t[idx(iTree, j)].kDown;
    uint8_t outv;
    if (kDown0 >= kLeafDepth) {
      int kDownTree = kDown0 - kLeafDepth;
      int iP = (iTree >> kDownTree) << kDownTree;
      int idxTree = idx(iP, j);
      uint8_t* c = &t[idxTree].ctxIdx;
      outv = *c;
      CtxMapOBUF::evolve(c, bitv);
      int th = 3 + (std::abs(int(*c) - 127) >> 4);
      if (++t[idxTree].nSeen >= th) {
        if (kDownTree > 0)
          decreaseKdown(idxTree, kDownTree);
        else
          createLeaf(idxTree, leafNumber, leaves, *c, i);
      }
    } else {
      int leafIdx = (int(t[idx(iTree, j)].ctxIdx) << 8)
        + t[idx(iTree, j)].nSeen;
      const int maskI = (1 << kLeafDepth) - 1;
      uint8_t* c = &leaves[leafIdx * (1 << kLeafDepth) + (i & maskI)];
      outv = *c;
      CtxMapOBUF::evolve(c, bitv);
    }
    return outv;
  }

  int decodeEvolve(ArithDec* aec, ObufModel& model, int i, int j,
                   int* leafNumber, uint8_t* leaves) {
    int iTree = i >> kLeafDepth;
    int kDown0 = t[idx(iTree, j)].kDown;
    int bitv;
    if (kDown0 >= kLeafDepth) {
      int kDownTree = kDown0 - kLeafDepth;
      int iP = (iTree >> kDownTree) << kDownTree;
      int idxTree = idx(iP, j);
      uint8_t* c = &t[idxTree].ctxIdx;
      bitv = aec->bit_bounded(&model.prob[*c >> 3], *c >> 3, model.bound);
      CtxMapOBUF::evolve(c, bitv);
      int th = 3 + (std::abs(int(*c) - 127) >> 4);
      if (++t[idxTree].nSeen >= th) {
        if (kDownTree > 0)
          decreaseKdown(idxTree, kDownTree);
        else
          createLeaf(idxTree, leafNumber, leaves, *c, i);
      }
    } else {
      int leafIdx = (int(t[idx(iTree, j)].ctxIdx) << 8)
        + t[idx(iTree, j)].nSeen;
      const int maskI = (1 << kLeafDepth) - 1;
      uint8_t* c = &leaves[leafIdx * (1 << kLeafDepth) + (i & maskI)];
      bitv = aec->bit_bounded(&model.prob[*c >> 3], *c >> 3, model.bound);
      CtxMapOBUF::evolve(c, bitv);
    }
    return bitv;
  }
};

}  // namespace obufcore

#endif  // TMC13_OBUF_CORE_H
