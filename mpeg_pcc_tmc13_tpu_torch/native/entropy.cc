// Native host-side entropy stage for the TPU G-PCC codec.
//
// Role (SURVEY.md §7): the TPU computes per-level tensors of syntax-element
// values and context ids; this C++ stage serialises/deserialises them with a
// context-adaptive binary range coder.  It replaces the reference's
// schroedinger/dirac coder (dependencies/schroedinger/schroarith.c,
// tmc3/entropydirac.h) with a fresh LZMA-style range coder:
//   - 32-bit range, 64-bit low with carry cache (classic rc_shift_low),
//   - 11-bit adaptive probabilities, adaptation shift 5,
//   - bypass bits via range halving (exact, no probability).
// The batch API is the key design difference from the reference: instead of
// per-bit virtual calls inside a pointer-chasing tree walk, whole octree
// levels / coefficient blocks arrive as flat arrays and are coded in tight
// loops.  Context state lives in caller-owned uint16 arrays so Python/JAX
// controls allocation, snapshotting (entropy continuation, reference
// encoder.cpp:1401-1411) and parallel slice streams.
//
// Exported C ABI (used via ctypes from bitstream/entropy.py; the pure-Python
// mirror in that file is the executable spec — the two are cross-tested to be
// bit-identical).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

constexpr uint32_t kTopValue = 1u << 24;
constexpr uint16_t kProbBits = 11;
constexpr uint16_t kProbInit = 1 << (kProbBits - 1);  // 1024
constexpr uint16_t kProbMoveBits = 5;

struct RcEncoder {
  std::vector<uint8_t> out;
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  uint64_t cache_size = 1;
  bool flushed = false;

  inline void shift_low() {
    if ((uint32_t)low < 0xFF000000u || (low >> 32) != 0) {
      uint8_t carry = (uint8_t)(low >> 32);
      uint8_t temp = cache;
      do {
        out.push_back((uint8_t)(temp + carry));
        temp = 0xFF;
      } while (--cache_size != 0);
      cache = (uint8_t)(low >> 24);
    }
    cache_size++;
    low = ((uint32_t)low) << 8;
  }

  inline void encode_bit(uint16_t* prob, int bit) {
    uint32_t bound = (range >> kProbBits) * (*prob);
    if (!bit) {
      range = bound;
      *prob = (uint16_t)(*prob + (((1 << kProbBits) - *prob) >> kProbMoveBits));
    } else {
      low += bound;
      range -= bound;
      *prob = (uint16_t)(*prob - (*prob >> kProbMoveBits));
    }
    while (range < kTopValue) {
      shift_low();
      range <<= 8;
    }
  }

  inline void encode_bypass(int bit) {
    range >>= 1;
    if (bit) low += range;
    while (range < kTopValue) {
      shift_low();
      range <<= 8;
    }
  }

  inline void encode_bypass_bits(uint32_t v, int nbits) {
    for (int i = nbits - 1; i >= 0; --i) encode_bypass((v >> i) & 1);
  }

  void flush() {
    if (flushed) return;
    for (int i = 0; i < 5; ++i) shift_low();
    flushed = true;
  }
};

struct RcDecoder {
  const uint8_t* data;
  int64_t size;
  int64_t pos = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  inline uint8_t next_byte() { return pos < size ? data[pos++] : 0; }

  void init() {
    next_byte();  // first encoder byte is the initial zero cache
    code = 0;
    for (int i = 0; i < 4; ++i) code = (code << 8) | next_byte();
  }

  inline int decode_bit(uint16_t* prob) {
    uint32_t bound = (range >> kProbBits) * (*prob);
    int bit;
    if (code < bound) {
      range = bound;
      *prob = (uint16_t)(*prob + (((1 << kProbBits) - *prob) >> kProbMoveBits));
      bit = 0;
    } else {
      code -= bound;
      range -= bound;
      *prob = (uint16_t)(*prob - (*prob >> kProbMoveBits));
      bit = 1;
    }
    while (range < kTopValue) {
      range <<= 8;
      code = (code << 8) | next_byte();
    }
    return bit;
  }

  inline int decode_bypass() {
    range >>= 1;
    int bit = 0;
    if (code >= range) {
      code -= range;
      bit = 1;
    }
    while (range < kTopValue) {
      range <<= 8;
      code = (code << 8) | next_byte();
    }
    return bit;
  }

  inline uint32_t decode_bypass_bits(int nbits) {
    uint32_t v = 0;
    for (int i = 0; i < nbits; ++i) v = (v << 1) | decode_bypass();
    return v;
  }
};

// ---- shared composite codes -------------------------------------------

// Adaptive truncated-unary prefix (contexts ctx[base..base+prefix_max-1])
// followed by a bypass Exp-Golomb(k) suffix for the remainder.  Used for
// residual magnitudes, duplicate counts, run lengths.
inline void enc_ueg(RcEncoder* e, uint16_t* ctx, uint32_t v, int prefix_max,
                    int k) {
  int i = 0;
  for (; i < prefix_max; ++i) {
    int more = v > (uint32_t)i;
    e->encode_bit(&ctx[i], more);
    if (!more) return;
  }
  // remainder r = v - prefix_max with Exp-Golomb(k) in bypass
  uint32_t r = v - prefix_max;
  uint32_t m = (r >> k) + 1;
  int nb = 0;
  while ((m >> nb) > 1) nb++;
  for (int j = 0; j < nb; ++j) e->encode_bypass(1);
  e->encode_bypass(0);
  for (int j = nb - 1; j >= 0; --j) e->encode_bypass((m >> j) & 1);
  e->encode_bypass_bits(r & ((1u << k) - 1), k);
}

inline uint32_t dec_ueg(RcDecoder* d, uint16_t* ctx, int prefix_max, int k) {
  int i = 0;
  for (; i < prefix_max; ++i) {
    if (!d->decode_bit(&ctx[i])) return (uint32_t)i;
  }
  int nb = 0;
  while (d->decode_bypass()) nb++;
  uint32_t m = 1;
  for (int j = 0; j < nb; ++j) m = (m << 1) | d->decode_bypass();
  uint32_t r = ((m - 1) << k) | d->decode_bypass_bits(k);
  return prefix_max + r;
}

}  // namespace

extern "C" {

// ---- lifecycle ---------------------------------------------------------

RcEncoder* rce_new() { return new RcEncoder(); }
void rce_free(RcEncoder* e) { delete e; }

int64_t rce_size(RcEncoder* e) {
  e->flush();
  return (int64_t)e->out.size();
}

void rce_copy(RcEncoder* e, uint8_t* dst) {
  e->flush();
  std::memcpy(dst, e->out.data(), e->out.size());
}

RcDecoder* rcd_new(const uint8_t* data, int64_t size) {
  RcDecoder* d = new RcDecoder();
  d->data = data;
  d->size = size;
  d->init();
  return d;
}
void rcd_free(RcDecoder* d) { delete d; }
int64_t rcd_pos(RcDecoder* d) { return d->pos; }

void ctx_init(uint16_t* ctx, int64_t n) {
  for (int64_t i = 0; i < n; ++i) ctx[i] = kProbInit;
}

// ---- generic batches ---------------------------------------------------

void rce_bits(RcEncoder* e, uint16_t* ctx, const int32_t* ctx_ids,
              const uint8_t* bits, int64_t n) {
  for (int64_t i = 0; i < n; ++i) e->encode_bit(&ctx[ctx_ids[i]], bits[i]);
}

void rcd_bits(RcDecoder* d, uint16_t* ctx, const int32_t* ctx_ids,
              uint8_t* bits, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    bits[i] = (uint8_t)d->decode_bit(&ctx[ctx_ids[i]]);
}

// 2-bit symbols with contexts chained on the previous symbol (used by
// the predictive-geometry mode stream).
void rcd_mode_chain(RcDecoder* d, uint16_t* ctx, uint8_t* modes, int64_t n) {
  int prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    int hi = d->decode_bit(&ctx[prev * 2]);
    int lo = d->decode_bit(&ctx[prev * 2 + 1]);
    prev = (hi << 1) | lo;
    modes[i] = (uint8_t)prev;
  }
}

// Bits with the context chained on the previously coded bit (used for
// trisoup vertex presence flags and similar 1st-order binary streams).
void rcd_bits_chain(RcDecoder* d, uint16_t* ctx, uint8_t* bits, int64_t n) {
  int prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    prev = d->decode_bit(&ctx[prev]);
    bits[i] = (uint8_t)prev;
  }
}

void rce_bypass(RcEncoder* e, const uint32_t* vals, const int32_t* nbits,
                int64_t n) {
  for (int64_t i = 0; i < n; ++i) e->encode_bypass_bits(vals[i], nbits[i]);
}

void rcd_bypass(RcDecoder* d, uint32_t* vals, const int32_t* nbits,
                int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    vals[i] = d->decode_bypass_bits(nbits[i]);
}

void rce_ueg(RcEncoder* e, uint16_t* ctx, const int32_t* ctx_bases,
             const uint32_t* vals, int64_t n, int32_t prefix_max, int32_t k) {
  for (int64_t i = 0; i < n; ++i)
    enc_ueg(e, &ctx[ctx_bases[i]], vals[i], prefix_max, k);
}

void rcd_ueg(RcDecoder* d, uint16_t* ctx, const int32_t* ctx_bases,
             uint32_t* vals, int64_t n, int32_t prefix_max, int32_t k) {
  for (int64_t i = 0; i < n; ++i)
    vals[i] = dec_ueg(d, &ctx[ctx_bases[i]], prefix_max, k);
}

// ---- octree occupancy batch -------------------------------------------
//
// Per node: the 8-bit child-occupancy byte is coded bit-by-bit down a
// binary context tree (255 internal nodes) selected by the node's
// device-computed base context (neighbour pattern class).  Context id =
// base_ctx * 255 + (tree_state - 1).  The all-zero byte is impossible
// (an octree node exists because it has a point), so when the first 7
// bits are zero, the last bit is inferred = 1 and not coded — same
// invariant the reference exploits (occupancy != 0,
// geometry_octree_encoder.cpp occupancy coding).

void rce_occupancy(RcEncoder* e, uint16_t* ctx, const int32_t* base_ctx,
                   const uint8_t* occ, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint16_t* base = &ctx[(int64_t)base_ctx[i] * 255];
    uint32_t t = 1;
    uint8_t b = occ[i];
    for (int j = 7; j >= 0; --j) {
      int bit = (b >> j) & 1;
      if (j == 0 && t == 128) break;  // inferred 1
      e->encode_bit(&base[t - 1], bit);
      t = (t << 1) | bit;
    }
  }
}

void rcd_occupancy(RcDecoder* d, uint16_t* ctx, const int32_t* base_ctx,
                   uint8_t* occ, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint16_t* base = &ctx[(int64_t)base_ctx[i] * 255];
    uint32_t t = 1;
    for (int j = 7; j >= 0; --j) {
      int bit;
      if (j == 0 && t == 128)
        bit = 1;  // inferred
      else
        bit = d->decode_bit(&base[t - 1]);
      t = (t << 1) | bit;
    }
    occ[i] = (uint8_t)(t & 0xFF);
  }
}

// ---- mixed-context occupancy (OBUF-flavoured) ---------------------------
//
// Each occupancy bit is coded with the AVERAGE of two adaptive
// probabilities: a coarse context (few, fast-adapting) and a fine
// context (many, slow but specific); both update toward the coded bit.
// This is the context-mixing counterpart of the reference's OBUF
// bounded-probability scheme (entropydirac.h:229-253): the coarse
// model bounds how far a rarely-visited fine context can mislead.

static inline void enc_bit_mix(RcEncoder* e, uint16_t* p1, uint16_t* p2,
                               int bit) {
  uint32_t p = ((uint32_t)*p1 + (uint32_t)*p2) >> 1;
  uint32_t bound = (e->range >> kProbBits) * p;
  if (!bit) {
    e->range = bound;
    *p1 = (uint16_t)(*p1 + (((1 << kProbBits) - *p1) >> kProbMoveBits));
    *p2 = (uint16_t)(*p2 + (((1 << kProbBits) - *p2) >> kProbMoveBits));
  } else {
    e->low += bound;
    e->range -= bound;
    *p1 = (uint16_t)(*p1 - (*p1 >> kProbMoveBits));
    *p2 = (uint16_t)(*p2 - (*p2 >> kProbMoveBits));
  }
  while (e->range < kTopValue) {
    e->shift_low();
    e->range <<= 8;
  }
}

static inline int dec_bit_mix(RcDecoder* d, uint16_t* p1, uint16_t* p2) {
  uint32_t p = ((uint32_t)*p1 + (uint32_t)*p2) >> 1;
  uint32_t bound = (d->range >> kProbBits) * p;
  int bit;
  if (d->code < bound) {
    d->range = bound;
    *p1 = (uint16_t)(*p1 + (((1 << kProbBits) - *p1) >> kProbMoveBits));
    *p2 = (uint16_t)(*p2 + (((1 << kProbBits) - *p2) >> kProbMoveBits));
    bit = 0;
  } else {
    d->code -= bound;
    d->range -= bound;
    *p1 = (uint16_t)(*p1 - (*p1 >> kProbMoveBits));
    *p2 = (uint16_t)(*p2 - (*p2 >> kProbMoveBits));
    bit = 1;
  }
  while (d->range < kTopValue) {
    d->range <<= 8;
    d->code = (d->code << 8) | d->next_byte();
  }
  return bit;
}

void rce_occupancy_mix(RcEncoder* e, uint16_t* ctx, uint16_t* ctx_fine,
                       const int32_t* base_ctx, const int32_t* fine_ctx,
                       const uint8_t* occ, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint16_t* b1 = &ctx[(int64_t)base_ctx[i] * 255];
    uint16_t* b2 = &ctx_fine[(int64_t)fine_ctx[i] * 255];
    uint32_t t = 1;
    uint8_t b = occ[i];
    for (int j = 7; j >= 0; --j) {
      int bit = (b >> j) & 1;
      if (j == 0 && t == 128) break;
      enc_bit_mix(e, &b1[t - 1], &b2[t - 1], bit);
      t = (t << 1) | bit;
    }
  }
}

void rcd_occupancy_mix(RcDecoder* d, uint16_t* ctx, uint16_t* ctx_fine,
                       const int32_t* base_ctx, const int32_t* fine_ctx,
                       uint8_t* occ, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint16_t* b1 = &ctx[(int64_t)base_ctx[i] * 255];
    uint16_t* b2 = &ctx_fine[(int64_t)fine_ctx[i] * 255];
    uint32_t t = 1;
    for (int j = 7; j >= 0; --j) {
      int bit;
      if (j == 0 && t == 128)
        bit = 1;
      else
        bit = dec_bit_mix(d, &b1[t - 1], &b2[t - 1]);
      t = (t << 1) | bit;
    }
    occ[i] = (uint8_t)(t & 0xFF);
  }
}

// ---- attribute residual block -----------------------------------------
//
// Codes an array of signed quantised coefficients, one component stream.
// Per coefficient: zero flag (context conditioned on previous coeff
// zero-ness), sign (bypass), |v|-1 via adaptive prefix + EG(k).
// Context layout per stream: [0..1] zero flags, [2..2+prefix_max) magnitude.
// This mirrors the role of the reference's PCCResidualsEncoder
// (AttributeEncoder.cpp:57-310) with a level-batch API.

void rce_residuals(RcEncoder* e, uint16_t* ctx, const int32_t* vals,
                   int64_t n, int32_t prefix_max, int32_t k) {
  int prev_nz = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = vals[i];
    int nz = v != 0;
    e->encode_bit(&ctx[prev_nz], !nz);
    if (nz) {
      e->encode_bypass(v < 0);
      uint32_t mag = (uint32_t)(v < 0 ? -(int64_t)v : v);
      enc_ueg(e, &ctx[2], mag - 1, prefix_max, k);
    }
    prev_nz = nz;
  }
}

void rcd_residuals(RcDecoder* d, uint16_t* ctx, int32_t* vals, int64_t n,
                   int32_t prefix_max, int32_t k) {
  int prev_nz = 0;
  for (int64_t i = 0; i < n; ++i) {
    int zero = d->decode_bit(&ctx[prev_nz]);
    if (zero) {
      vals[i] = 0;
      prev_nz = 0;
    } else {
      int neg = d->decode_bypass();
      uint32_t mag = dec_ueg(d, &ctx[2], prefix_max, k) + 1;
      vals[i] = neg ? -(int32_t)mag : (int32_t)mag;
      prev_nz = 1;
    }
  }
}

// ---- zero-run attribute residual block ---------------------------------
//
// For very sparse coefficient streams (RAHT at mid/low rates) a
// per-coefficient zero flag costs ~0.02 bit per zero even when fully
// adapted — a hard floor of kilobytes over millions of zeros.  Coding
// the RUN of zeros before each nonzero (adaptive truncated-unary
// prefix + EG(2) tail) makes empty regions nearly free; this mirrors
// the reference's zeroRunLength design (AttributeEncoder.cpp
// PCCResidualsEncoder::encodeRunLength).
// Context layout: [0..19] run prefix, [20..20+prefix_max) magnitude.

static const int kZrunPrefix = 20;
static const int kZrunK = 2;

void rce_zrun(RcEncoder* e, uint16_t* ctx, const int32_t* vals,
              int64_t n, int32_t prefix_max, int32_t k) {
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && vals[j] == 0) ++j;
    enc_ueg(e, &ctx[0], (uint32_t)(j - i), kZrunPrefix, kZrunK);
    if (j >= n) return;
    int32_t v = vals[j];
    e->encode_bypass(v < 0);
    uint32_t mag = (uint32_t)(v < 0 ? -(int64_t)v : v);
    enc_ueg(e, &ctx[kZrunPrefix], mag - 1, prefix_max, k);
    i = j + 1;
  }
}

void rcd_zrun(RcDecoder* d, uint16_t* ctx, int32_t* vals, int64_t n,
              int32_t prefix_max, int32_t k) {
  int64_t i = 0;
  while (i < n) {
    uint32_t run = dec_ueg(d, &ctx[0], kZrunPrefix, kZrunK);
    for (uint32_t r = 0; r < run && i < n; ++r) vals[i++] = 0;
    if (i >= n) return;
    int neg = d->decode_bypass();
    uint32_t mag = dec_ueg(d, &ctx[kZrunPrefix], prefix_max, k) + 1;
    vals[i++] = neg ? -(int32_t)mag : (int32_t)mag;
  }
}

// ---- joint row residual block (RAHT coefficients) -----------------------
//
// Codes (M, ncomp) coefficient rows: a zero-run of all-zero rows, then
// the row's components jointly — chroma magnitudes condition the luma
// contexts, and when both chromas are zero the luma magnitude is coded
// minus one (a nonzero row guarantees it).  Run and magnitude
// escape codes use context-coded Exp-Golomb prefixes, so isolated
// nonzeros in long zero deserts cost a handful of adaptive bits
// instead of ~20 bypass bits.  Same role as the reference's
// PCCResidualsEncoder::encodeRunLength/encode (AttributeEncoder.cpp:
// 228-299); binarisation matches so the RDOQ rate model stays honest.
//
// ctx layout (kZrowCtx = 31 per attribute):
//   [0..2]  run unary    [3] run prefix4     [4] run EG2 prefix
//   [5..11] coeff gt0    [12..18] coeff gt1
//   [19..24] EG1 rem prefix (k3*3 + min(pos,2))
//   [25..30] EG1 rem suffix (k3*3 + min(bit,2))
// Positional prefix + ADAPTIVE suffix contexts: magnitudes cluster at
// 2-3 where the single EG suffix bit is heavily skewed — coding it
// bypass (the old layout) cost ~0.9 bpp on lossless RAHT.

static const int kZrowCtx = 31;

static inline void enc_egk_ctx(RcEncoder* e, uint32_t v, int k,
                               uint16_t* ctx_prefix) {
  while (v >= (1u << k)) {
    e->encode_bit(ctx_prefix, 1);
    v -= (1u << k);
    ++k;
  }
  e->encode_bit(ctx_prefix, 0);
  e->encode_bypass_bits(v, k);
}

static inline uint32_t dec_egk_ctx(RcDecoder* d, int k,
                                   uint16_t* ctx_prefix) {
  uint32_t base = 0;
  while (d->decode_bit(ctx_prefix)) {
    base += (1u << k);
    ++k;
  }
  return base + d->decode_bypass_bits(k);
}

static inline void enc_zrow_run(RcEncoder* e, uint16_t* ctx,
                                uint32_t run) {
  uint32_t u = run < 3 ? run : 3;
  for (uint32_t i = 0; i < u; ++i) e->encode_bit(&ctx[i], 1);
  if (run < 3) { e->encode_bit(&ctx[run], 0); return; }
  run -= 3;
  uint32_t prefix = run >> 1;
  for (uint32_t i = 0; i < (prefix < 4 ? prefix : 4); ++i)
    e->encode_bit(&ctx[3], 1);
  if (run < 8) {
    e->encode_bit(&ctx[3], 0);
    e->encode_bypass(run & 1);
    return;
  }
  run -= 8;
  enc_egk_ctx(e, run, 2, &ctx[4]);
}

static inline uint32_t dec_zrow_run(RcDecoder* d, uint16_t* ctx) {
  uint32_t u = 0;
  while (u < 3 && d->decode_bit(&ctx[u])) ++u;
  if (u < 3) return u;
  uint32_t prefix = 0;
  while (prefix < 4 && d->decode_bit(&ctx[3])) ++prefix;
  if (prefix < 4) return 3 + 2 * prefix + d->decode_bypass();
  return 11 + dec_egk_ctx(d, 2, &ctx[4]);
}

// EG(k) with positional prefix contexts and adaptive suffix contexts
// (the reference's contexted decodeExpGolomb, entropyutils.h:210-239)
static inline void enc_egk_rem(RcEncoder* e, uint32_t v, int k,
                               uint16_t* pre, uint16_t* suf) {
  int k0 = k;
  while (v >= (1u << k)) {
    e->encode_bit(&pre[k - k0 < 2 ? k - k0 : 2], 1);
    v -= (1u << k);
    ++k;
  }
  e->encode_bit(&pre[k - k0 < 2 ? k - k0 : 2], 0);
  while (k--)
    e->encode_bit(&suf[k < 2 ? k : 2], (v >> k) & 1);
}

static inline uint32_t dec_egk_rem(RcDecoder* d, int k, uint16_t* pre,
                                   uint16_t* suf) {
  int k0 = k;
  uint32_t base = 0;
  while (d->decode_bit(&pre[k - k0 < 2 ? k - k0 : 2])) {
    base += (1u << k);
    ++k;
  }
  uint32_t v = 0;
  while (k--)
    v |= uint32_t(d->decode_bit(&suf[k < 2 ? k : 2])) << k;
  return base + v;
}

static inline void enc_zrow_sym(RcEncoder* e, uint16_t* ctx, uint32_t v,
                                int k1, int k2, int k3) {
  e->encode_bit(&ctx[5 + k1], v > 0);
  if (!v) return;
  --v;
  e->encode_bit(&ctx[12 + k2], v > 0);
  if (!v) return;
  enc_egk_rem(e, v - 1, 1, &ctx[19 + 3 * k3], &ctx[25 + 3 * k3]);
}

static inline uint32_t dec_zrow_sym(RcDecoder* d, uint16_t* ctx,
                                    int k1, int k2, int k3) {
  if (!d->decode_bit(&ctx[5 + k1])) return 0;
  if (!d->decode_bit(&ctx[12 + k2])) return 1;
  return 2 + dec_egk_rem(d, 1, &ctx[19 + 3 * k3], &ctx[25 + 3 * k3]);
}

void rce_zrow(RcEncoder* e, uint16_t* ctx, const int32_t* vals,
              int64_t nrows, int32_t ncomp) {
  int64_t i = 0;
  while (i < nrows) {
    int64_t j = i;
    while (j < nrows) {
      bool allz = true;
      for (int c = 0; c < ncomp; ++c) allz &= vals[j * ncomp + c] == 0;
      if (!allz) break;
      ++j;
    }
    enc_zrow_run(e, ctx, (uint32_t)(j - i));
    if (j >= nrows) return;
    const int32_t* row = &vals[j * ncomp];
    if (ncomp == 1) {
      uint32_t mag = (uint32_t)(row[0] < 0 ? -row[0] : row[0]);
      enc_zrow_sym(e, ctx, mag - 1, 0, 0, 0);
      e->encode_bypass(row[0] < 0);
    } else {
      int32_t v0 = row[0], v1 = row[1], v2 = ncomp > 2 ? row[2] : 0;
      uint32_t m0 = (uint32_t)(v0 < 0 ? -v0 : v0);
      uint32_t m1 = (uint32_t)(v1 < 0 ? -v1 : v1);
      uint32_t m2 = (uint32_t)(v2 < 0 ? -v2 : v2);
      int b0 = m1 == 0, b1 = m1 <= 1, b2 = m2 == 0, b3 = m2 <= 1;
      enc_zrow_sym(e, ctx, m1, 0, 0, 1);
      enc_zrow_sym(e, ctx, m2, 1 + b0, 1 + b1, 1);
      uint32_t m0x = (b0 && b2) ? m0 - 1 : m0;
      enc_zrow_sym(e, ctx, m0x, 3 + (b0 << 1) + b2,
                   3 + (b1 << 1) + b3, 0);
      if (m0) e->encode_bypass(v0 < 0);
      if (m1) e->encode_bypass(v1 < 0);
      if (m2) e->encode_bypass(v2 < 0);
    }
    i = j + 1;
  }
}

void rcd_zrow(RcDecoder* d, uint16_t* ctx, int32_t* vals, int64_t nrows,
              int32_t ncomp) {
  int64_t i = 0;
  int64_t total = nrows * ncomp;
  for (int64_t t = 0; t < total; ++t) vals[t] = 0;
  while (i < nrows) {
    uint32_t run = dec_zrow_run(d, ctx);
    i += run;
    if (i >= nrows) return;
    int32_t* row = &vals[i * ncomp];
    if (ncomp == 1) {
      uint32_t mag = dec_zrow_sym(d, ctx, 0, 0, 0) + 1;
      row[0] = d->decode_bypass() ? -(int32_t)mag : (int32_t)mag;
    } else {
      uint32_t m1 = dec_zrow_sym(d, ctx, 0, 0, 1);
      int b0 = m1 == 0, b1 = m1 <= 1;
      uint32_t m2 = dec_zrow_sym(d, ctx, 1 + b0, 1 + b1, 1);
      int b2 = m2 == 0, b3 = m2 <= 1;
      uint32_t m0 = dec_zrow_sym(d, ctx, 3 + (b0 << 1) + b2,
                                 3 + (b1 << 1) + b3, 0);
      if (b0 && b2) m0 += 1;
      row[0] = m0 ? (d->decode_bypass() ? -(int32_t)m0 : (int32_t)m0) : 0;
      row[1] = m1 ? (d->decode_bypass() ? -(int32_t)m1 : (int32_t)m1) : 0;
      if (ncomp > 2)
        row[2] = m2 ? (d->decode_bypass() ? -(int32_t)m2 : (int32_t)m2)
                    : 0;
    }
    i += 1;
  }
}

// ---- bit-length residual block ------------------------------------
//
// For large-dynamic-range residuals (predictive geometry deltas): per
// value a zero flag (chained ctx), bypass sign, then the magnitude as
// an adaptive truncated-unary bit-length (contexts ctx[2..2+24)) plus
// bypass mantissa.  The length alphabet is small and peaky, which the
// adaptive prefix models well — unlike a fixed Exp-Golomb suffix.

void rce_resbl(RcEncoder* e, uint16_t* ctx, const int32_t* vals,
               int64_t n) {
  int prev_nz = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = vals[i];
    int nz = v != 0;
    e->encode_bit(&ctx[prev_nz], !nz);
    if (nz) {
      e->encode_bypass(v < 0);
      uint32_t mag = (uint32_t)(v < 0 ? -(int64_t)v : v);
      int nb = 0;
      while ((mag >> nb) > 1) nb++;      // nb = bit_length - 1
      for (int j = 0; j < nb; ++j) e->encode_bit(&ctx[2 + j], 1);
      if (nb < 23) e->encode_bit(&ctx[2 + nb], 0);
      if (nb > 0) e->encode_bypass_bits(mag & ((1u << nb) - 1), nb);
    }
    prev_nz = nz;
  }
}

void rcd_resbl(RcDecoder* d, uint16_t* ctx, int32_t* vals, int64_t n) {
  int prev_nz = 0;
  for (int64_t i = 0; i < n; ++i) {
    int zero = d->decode_bit(&ctx[prev_nz]);
    if (zero) {
      vals[i] = 0;
      prev_nz = 0;
    } else {
      int neg = d->decode_bypass();
      int nb = 0;
      while (nb < 23 && d->decode_bit(&ctx[2 + nb])) nb++;
      uint32_t mag = 1;
      if (nb > 0) mag = (1u << nb) | d->decode_bypass_bits(nb);
      vals[i] = neg ? -(int32_t)mag : (int32_t)mag;
      prev_nz = 1;
    }
  }
}

// ---- trisoup edge-vertex coder -----------------------------------------
//
// Counterpart of the reference's OBUF-driven vertex coding
// (geometry_trisoup_encoder.cpp:1078 encodeTrisoupVertices): the
// presence flag conditions on the number of occupied nodes sharing
// the edge, the previous edge's presence, and the states of the two
// parallel predecessor edges (absent / present-no-vertex /
// present-with-vertex); position bits condition on the bit index and
// the matching bit of the neighbour-predicted position.  Sequential
// because contexts depend on previously-decoded presence/positions —
// exactly why this lives in the native layer.
//
// ctx layout: [0,72): presence = ((nadj-1)*2 + prev)*9 + s1*3 + s2
//             [72, 72+nbits*3): position bit i, bucket b in
//                {pred-bit-0, pred-bit-1, no-pred}
// prev1/prev2: indices (into the same edge array) of the two parallel
// predecessor edges, -1 when outside; they are strictly earlier in
// the sorted-key coding order (morton is monotone per coordinate).

static inline int tri_nbr_state(int64_t j, const uint8_t* pres) {
  if (j < 0) return 0;
  return pres[j] ? 2 : 1;
}

void rce_trisoup_verts(RcEncoder* e, uint16_t* ctx,
                       const uint8_t* pres, const int32_t* vpos,
                       const int32_t* nadj, const int64_t* prev1,
                       const int64_t* prev2, int64_t ne, int nbits) {
  int prev = 0;
  for (int64_t i = 0; i < ne; ++i) {
    int s1 = tri_nbr_state(prev1[i], pres);
    int s2 = tri_nbr_state(prev2[i], pres);
    int na = nadj[i] < 1 ? 1 : (nadj[i] > 4 ? 4 : nadj[i]);
    int cid = ((na - 1) * 2 + prev) * 9 + s1 * 3 + s2;
    e->encode_bit(&ctx[cid], pres[i]);
    prev = pres[i] ? 1 : 0;
    if (!pres[i]) continue;
    // neighbour position prediction: mean of predecessor vertices
    int pv = -1;
    int cnt = 0, sum = 0;
    if (prev1[i] >= 0 && pres[prev1[i]]) { sum += vpos[prev1[i]]; ++cnt; }
    if (prev2[i] >= 0 && pres[prev2[i]]) { sum += vpos[prev2[i]]; ++cnt; }
    if (cnt) pv = (sum + (cnt >> 1)) / cnt;
    int v = vpos[i];
    for (int b = nbits - 1; b >= 0; --b) {
      int bi = nbits - 1 - b;                    // 0 = MSB
      int bucket = pv < 0 ? 2 : ((pv >> b) & 1);
      e->encode_bit(&ctx[72 + bi * 3 + bucket], (v >> b) & 1);
    }
  }
}

void rcd_trisoup_verts(RcDecoder* d, uint16_t* ctx,
                       uint8_t* pres, int32_t* vpos,
                       const int32_t* nadj, const int64_t* prev1,
                       const int64_t* prev2, int64_t ne, int nbits) {
  int prev = 0;
  for (int64_t i = 0; i < ne; ++i) {
    int s1 = tri_nbr_state(prev1[i], pres);
    int s2 = tri_nbr_state(prev2[i], pres);
    int na = nadj[i] < 1 ? 1 : (nadj[i] > 4 ? 4 : nadj[i]);
    int cid = ((na - 1) * 2 + prev) * 9 + s1 * 3 + s2;
    int p = d->decode_bit(&ctx[cid]);
    pres[i] = (uint8_t)p;
    prev = p;
    vpos[i] = 0;
    if (!p) continue;
    int pv = -1;
    int cnt = 0, sum = 0;
    if (prev1[i] >= 0 && pres[prev1[i]]) { sum += vpos[prev1[i]]; ++cnt; }
    if (prev2[i] >= 0 && pres[prev2[i]]) { sum += vpos[prev2[i]]; ++cnt; }
    if (cnt) pv = (sum + (cnt >> 1)) / cnt;
    int v = 0;
    for (int b = nbits - 1; b >= 0; --b) {
      int bi = nbits - 1 - b;
      int bucket = pv < 0 ? 2 : ((pv >> b) & 1);
      v |= d->decode_bit(&ctx[72 + bi * 3 + bucket]) << b;
    }
    vpos[i] = v;
  }
}

}  // extern "C"

// ---- trisoup edge-vertex coder v2: reference-style conditioning ----
// Presence and the top position bits are conditioned on the decoded
// state of up to 9 geometrically-neighbouring edges (the colinear
// predecessor and the 8 perpendicular edges touching the two end
// corners), their vertex-closeness classes (2-bit position, oriented
// toward the shared corner), and the containing/flanking node
// multiplicities -- the conditioning variables of the reference's
// decodeTrisoupVerticesSub (geometry_trisoup_decoder.cpp:1080-1260),
// folded onto this coder's adaptive binary contexts.  Edges are
// processed in position-major order (the `order` permutation) so all
// referenced neighbours are already decoded.
// Context layout: [0,324) presence; [324,396) pos bit0; [396,540)
// pos bit1; [540,660) pos bit2; [660,660+2*nbits) remaining bits.

static inline int tri2_gather(
  const uint8_t* pres, const int32_t* vpos, const int32_t* nbr,
  uint16_t orient, int nbits, int* nclose, int* nclosest,
  int* closestStart, int* missed) {
  int npres = 0;
  *nclose = *nclosest = *closestStart = *missed = 0;
  for (int j = 0; j < 9; ++j) {
    int idx = nbr[j];
    if (idx < 0) continue;
    if (!pres[idx]) {
      if (j <= 4) (*missed)++;
      continue;
    }
    npres++;
    int v2b = nbits >= 2 ? (vpos[idx] >> (nbits - 2)) : vpos[idx];
    if (v2b > 3) v2b = 3;
    if ((orient >> j) & 1) v2b = 3 - v2b;
    if (v2b >= 2) (*nclose)++;
    if (v2b == 3) {
      (*nclosest)++;
      if (j <= 4) *closestStart = 1;
    }
  }
  return npres;
}

static inline int tri2_pres_ctx(int nclosest, int cmult, int nafter,
                                int npres, int dir) {
  int cA = nclosest < 2 ? nclosest : 2;
  int cB = cmult - 1;
  if (cB < 0) cB = 0;
  if (cB > 3) cB = 3;
  int cC = nafter < 2 ? nafter : 2;
  int cD = npres < 2 ? npres : 2;
  return (((cA * 4 + cB) * 3 + cC) * 3 + cD) * 3 + dir;
}

extern "C" {

void rce_trisoup_verts2(
  RcEncoder* e, uint16_t* ctx, const uint8_t* pres,
  const int32_t* vpos, const int64_t* order, const int32_t* nbr,
  const uint16_t* orient, const uint8_t* cmult,
  const uint8_t* nbefore, const uint8_t* nafter, const uint8_t* dir,
  int64_t ne, int nbits) {
  for (int64_t k = 0; k < ne; ++k) {
    int64_t i = order[k];
    int nclose, nclosest, closestStart, missed;
    int npres = tri2_gather(pres, vpos, &nbr[i * 9], orient[i], nbits,
                            &nclose, &nclosest, &closestStart,
                            &missed);
    int cid = tri2_pres_ctx(nclosest, cmult[i], nafter[i], npres,
                            dir[i]);
    e->encode_bit(&ctx[cid], pres[i]);
    if (!pres[i]) continue;
    int q0 = nbefore[i] < 2 ? nbefore[i] : 2;
    int q1 = nafter[i] < 2 ? nafter[i] : 2;
    int full = cmult[i] >= 4;
    int v = vpos[i];
    int coded = 0;
    for (int b = nbits - 1; b >= 0; --b) {
      int bi = nbits - 1 - b;
      int bit = (v >> b) & 1;
      if (bi == 0) {
        int f = (q0 * 3 + q1) * 2 + full;
        e->encode_bit(
          &ctx[324 + (f * 2 + (nclosest > 0)) * 2 + closestStart],
          bit);
      } else if (bi == 1) {
        int f = (q0 * 3 + q1) * 2 + full;
        e->encode_bit(
          &ctx[396
               + ((f * 2 + (nclosest > 0)) * 2 + closestStart)
               - 0 + 72 * coded],
          bit);
      } else if (bi == 2) {
        int m = missed < 4 ? missed : 4;
        int f2 = (m * 3 + q0) * 2 + full;
        e->encode_bit(&ctx[540 + f2 * 4 + (coded & 3)], bit);
      } else {
        e->encode_bit(&ctx[660 + bi * 2 + (coded & 1)], bit);
      }
      coded = (coded << 1) | bit;
    }
  }
}

void rcd_trisoup_verts2(
  RcDecoder* d, uint16_t* ctx, uint8_t* pres, int32_t* vpos,
  const int64_t* order, const int32_t* nbr, const uint16_t* orient,
  const uint8_t* cmult, const uint8_t* nbefore,
  const uint8_t* nafter, const uint8_t* dir, int64_t ne, int nbits) {
  for (int64_t k = 0; k < ne; ++k) {
    int64_t i = order[k];
    int nclose, nclosest, closestStart, missed;
    int npres = tri2_gather(pres, vpos, &nbr[i * 9], orient[i], nbits,
                            &nclose, &nclosest, &closestStart,
                            &missed);
    int cid = tri2_pres_ctx(nclosest, cmult[i], nafter[i], npres,
                            dir[i]);
    int p = d->decode_bit(&ctx[cid]);
    pres[i] = (uint8_t)p;
    vpos[i] = 0;
    if (!p) continue;
    int q0 = nbefore[i] < 2 ? nbefore[i] : 2;
    int q1 = nafter[i] < 2 ? nafter[i] : 2;
    int full = cmult[i] >= 4;
    int v = 0;
    int coded = 0;
    for (int b = nbits - 1; b >= 0; --b) {
      int bi = nbits - 1 - b;
      int bit;
      if (bi == 0) {
        int f = (q0 * 3 + q1) * 2 + full;
        bit = d->decode_bit(
          &ctx[324 + (f * 2 + (nclosest > 0)) * 2 + closestStart]);
      } else if (bi == 1) {
        int f = (q0 * 3 + q1) * 2 + full;
        bit = d->decode_bit(
          &ctx[396
               + ((f * 2 + (nclosest > 0)) * 2 + closestStart)
               - 0 + 72 * coded]);
      } else if (bi == 2) {
        int m = missed < 4 ? missed : 4;
        int f2 = (m * 3 + q0) * 2 + full;
        bit = d->decode_bit(&ctx[540 + f2 * 4 + (coded & 3)]);
      } else {
        bit = d->decode_bit(&ctx[660 + bi * 2 + (coded & 1)]);
      }
      v = (v << 1) | bit;
      coded = (coded << 1) | bit;
    }
    vpos[i] = v;
  }
}

}  // extern "C"

// ---- bytewise adaptive occupancy (reference dual-LUT counterpart) ------
//
// One 256-symbol range-coder operation per occupancy byte instead of 8
// binary ones.  Per context base: an adaptive frequency table kept as a
// Fenwick tree (uint16[256], 1-indexed nodes stored at t[i-1]; freq of
// every symbol starts at 1, so t[i-1] = i & -i initially and the total
// lives in t[255]).  Rescale halves frequencies (min 1 preserved by
// (f+1)>>1) when the total reaches 2^13, keeping range/total division
// safe after every 8-bit renormalisation.

namespace {

constexpr int kSymN = 256;
constexpr int kSymInc = 24;
constexpr uint32_t kSymLimit = 1u << 13;

inline uint32_t fen_prefix(const uint16_t* t, int i) {
  uint32_t s = 0;
  for (; i > 0; i -= i & -i) s += t[i - 1];
  return s;
}

inline void fen_add(uint16_t* t, int sym, int d) {
  for (int j = sym + 1; j <= kSymN; j += j & -j)
    t[j - 1] = (uint16_t)(t[j - 1] + d);
}

// largest symbol s with prefix(s) <= dv; sets *cum_out = prefix(s)
inline int fen_find(const uint16_t* t, uint32_t dv, uint32_t* cum_out) {
  int pos = 0;
  uint32_t cum = 0;
  for (int b = kSymN >> 1; b; b >>= 1) {
    int nxt = pos + b;
    if (nxt <= kSymN && cum + t[nxt - 1] <= dv) {
      pos = nxt;
      cum += t[nxt - 1];
    }
  }
  if (pos >= kSymN) pos = kSymN - 1;  // safety (cannot trigger: freqs>=1)
  *cum_out = cum;
  return pos;
}

inline void sym_rescale(uint16_t* t) {
  uint16_t f[kSymN];
  uint32_t prev = 0;
  for (int i = 0; i < kSymN; ++i) {
    uint32_t cur = fen_prefix(t, i + 1);
    f[i] = (uint16_t)(((cur - prev) + 1) >> 1);
    prev = cur;
  }
  for (int i = 0; i < kSymN; ++i) t[i] = f[i];
  for (int i = 1; i <= kSymN; ++i) {
    int j = i + (i & -i);
    if (j <= kSymN) t[j - 1] = (uint16_t)(t[j - 1] + t[i - 1]);
  }
}

}  // namespace

extern "C" {

void sym_contexts_init(uint16_t* ctx, int64_t num_bases) {
  for (int64_t b = 0; b < num_bases; ++b) {
    uint16_t* t = &ctx[b * kSymN];
    for (int i = 1; i <= kSymN; ++i) t[i - 1] = (uint16_t)(i & -i);
  }
}

static inline void enc_one_sym(RcEncoder* e, uint16_t* t, int s) {
  uint32_t total = t[kSymN - 1];
  uint32_t cum = fen_prefix(t, s);
  uint32_t f = fen_prefix(t, s + 1) - cum;
  uint32_t r = e->range / total;
  e->low += (uint64_t)r * cum;
  e->range = r * f;
  while (e->range < kTopValue) {
    e->shift_low();
    e->range <<= 8;
  }
  fen_add(t, s, kSymInc);
  if (total + kSymInc >= kSymLimit) sym_rescale(t);
}

static inline int dec_one_sym(RcDecoder* d, uint16_t* t) {
  uint32_t total = t[kSymN - 1];
  uint32_t r = d->range / total;
  uint32_t dv = d->code / r;
  if (dv >= total) dv = total - 1;
  uint32_t cum;
  int s = fen_find(t, dv, &cum);
  uint32_t f = fen_prefix(t, s + 1) - cum;
  d->code -= r * cum;
  d->range = r * f;
  while (d->range < kTopValue) {
    d->range <<= 8;
    d->code = (d->code << 8) | d->next_byte();
  }
  fen_add(t, s, kSymInc);
  if (total + kSymInc >= kSymLimit) sym_rescale(t);
  return s;
}

void rce_occ_sym(RcEncoder* e, uint16_t* ctx, const int32_t* base_ctx,
                 const uint8_t* occ, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    enc_one_sym(e, &ctx[(int64_t)base_ctx[i] * kSymN], occ[i]);
}

// ---- fused occupancy-stream coding (device-pipeline host stage) ---------
//
// The TPU encoder analysis ships ONLY the per-level occupancy bytes
// (1 B per tree node, level-major, children in Morton order).  The
// PARENT-mode context base of a node — (child_octant << 8) |
// parent_occupancy — is fully derivable from earlier bytes of the same
// stream, so the whole host entropy stage is one native call with no
// per-level glue.  Mirrors models/geometry_octree.encode
// (ctx_mode=CTX_MODE_PARENT) byte for byte.

int64_t rce_occ_stream(RcEncoder* e, uint16_t* ctx, const uint8_t* occ,
                       int64_t total, int32_t depth) {
  if (total < 1 || depth < 1) return -1;
  enc_one_sym(e, &ctx[0], occ[0]);  // root: base 0
  int64_t pstart = 0, pn = 1, pos = 1;
  for (int l = 1; l < depth; ++l) {
    int64_t cur = pos;
    for (int64_t p = pstart; p < pstart + pn; ++p) {
      uint32_t P = occ[p];
      for (int b = 0; b < 8; ++b) {
        if (!((P >> b) & 1)) continue;
        if (pos >= total) return -1;
        int64_t base = ((int64_t)b << 8) | P;
        enc_one_sym(e, &ctx[base * kSymN], occ[pos++]);
      }
    }
    pstart = cur;
    pn = pos - cur;
  }
  return pos;
}

// ---- occupancy link code (device->host byte-stream compression) ---------
//
// The device link packer emits each occupancy byte as a static
// canonical prefix code (MSB-first within the bit stream, bits packed
// little-endian into uint32 words to match the XLA scatter layout).
// This is LINK compression only — the adaptive range coder above is
// what lands in the bitstream; the static code merely narrows the
// host-link bytes toward the occupancy entropy (~4.5 bits/byte).

#include "occ_code.inc"

void occ_huff_table(uint8_t* lens_out, uint16_t* codes_out) {
  for (int i = 0; i < 256; ++i) {
    lens_out[i] = kOccCodeLen[i];
    codes_out[i] = kOccCode[i];
  }
}

// decode `n` symbols from the packed little-endian-u32 bit stream
void occ_unpack(const uint8_t* packed, uint8_t* out, int64_t n) {
  // 12-bit canonical decode LUT: peek -> (symbol, length)
  static uint16_t lut[1 << 12];
  static bool init = false;
  if (!init) {
    for (int s = 0; s < 256; ++s) {
      int len = kOccCodeLen[s];
      // codes are canonical MSB-aligned within their length; the
      // packer emits the bits LSB-first (bit i of the reversed code
      // at stream position i), so the LUT indexes the next 12 stream
      // bits directly
      uint32_t rev = 0;
      for (int b = 0; b < len; ++b)
        rev |= ((kOccCode[s] >> (len - 1 - b)) & 1u) << b;
      for (uint32_t hi = 0; hi < (1u << (12 - len)); ++hi)
        lut[rev | (hi << len)] = (uint16_t)((s << 4) | len);
    }
    init = true;
  }
  uint64_t bitpos = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t byte = bitpos >> 3;
    int sh = (int)(bitpos & 7);
    uint32_t win = (uint32_t)packed[byte]
                   | ((uint32_t)packed[byte + 1] << 8)
                   | ((uint32_t)packed[byte + 2] << 16);
    uint32_t peek = (win >> sh) & 0xFFF;
    uint16_t e = lut[peek];
    out[i] = (uint8_t)(e >> 4);
    bitpos += e & 0xF;
  }
}

int64_t rcd_occ_stream(RcDecoder* d, uint16_t* ctx, uint8_t* occ,
                       int64_t cap, int32_t depth) {
  if (cap < 1 || depth < 1) return -1;
  occ[0] = (uint8_t)dec_one_sym(d, &ctx[0]);
  int64_t pstart = 0, pn = 1, pos = 1;
  for (int l = 1; l < depth; ++l) {
    int64_t cur = pos;
    for (int64_t p = pstart; p < pstart + pn; ++p) {
      uint32_t P = occ[p];
      for (int b = 0; b < 8; ++b) {
        if (!((P >> b) & 1)) continue;
        if (pos >= cap) return -1;
        int64_t base = ((int64_t)b << 8) | P;
        occ[pos++] = (uint8_t)dec_one_sym(d, &ctx[base * kSymN]);
      }
    }
    pstart = cur;
    pn = pos - cur;
  }
  return pos;
}

void rcd_occ_sym(RcDecoder* d, uint16_t* ctx, const int32_t* base_ctx,
                 uint8_t* occ, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    occ[i] = (uint8_t)dec_one_sym(d, &ctx[(int64_t)base_ctx[i] * kSymN]);
}

}  // extern "C"
