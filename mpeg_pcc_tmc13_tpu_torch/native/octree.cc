// Native octree geometry pipeline: level walk + contexts + entropy.
//
// Role: the single-core host fallback / low-latency production path of
// the geometry codec (the jax path in ops/octree.py is the device
// equivalent; both feed the same range coder and must emit identical
// streams).  Replaces the per-node BFS walk of the reference
// (tmc3/geometry_octree_encoder.cpp:1853: ringbuf + per-node counting
// sort + occupancy atlas) with flat per-level array sweeps over sorted
// Morton codes.
//
// Two context modes (GPS neighbour flag):
//   mode 0 ("parent"):   base = (child_idx << 8) | parent_occupancy
//                        — zero extra lookups, fully level-parallel.
//   mode 1 ("neighbour"): base = face_pattern | (child_idx << 6)
//                        — 6-neighbour existence via a per-level hash
//                        set (replaces the reference's MortonMap3D
//                        atlas, OctreeNeighMap.cpp:83).
// Both context-id layouts match ops/octree.py exactly (cross-tested).

#include <cstdint>
#include <cstring>
#include <vector>

// range coder internals shared with entropy.cc (same TU layout)
struct RcEncoder;
struct RcDecoder;
extern "C" {
void rce_occupancy(RcEncoder* e, uint16_t* ctx, const int32_t* base_ctx,
                   const uint8_t* occ, int64_t n);
void rcd_occupancy(RcDecoder* d, uint16_t* ctx, const int32_t* base_ctx,
                   uint8_t* occ, int64_t n);
}

namespace {

// ---- Morton helpers (match utils/morton.py bit layout: x high) --------

inline uint64_t part1by2(uint64_t x) {
  x &= 0x1FFFFF;
  x = (x | (x << 32)) & 0x1F00000000FFFFull;
  x = (x | (x << 16)) & 0x1F0000FF0000FFull;
  x = (x | (x << 8)) & 0x100F00F00F00F00Full;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

inline uint64_t compact1by2(uint64_t x) {
  x &= 0x1249249249249249ull;
  x = (x ^ (x >> 2)) & 0x10C30C30C30C30C3ull;
  x = (x ^ (x >> 4)) & 0x100F00F00F00F00Full;
  x = (x ^ (x >> 8)) & 0x1F0000FF0000FFull;
  x = (x ^ (x >> 16)) & 0x1F00000000FFFFull;
  x = (x ^ (x >> 32)) & 0x1FFFFF;
  return x;
}

inline uint64_t morton3(uint64_t x, uint64_t y, uint64_t z) {
  return (part1by2(x) << 2) | (part1by2(y) << 1) | part1by2(z);
}

// ---- open-addressing hash set of int64 codes (power-of-two table) -----

struct CodeSet {
  std::vector<uint64_t> slots;  // key+1 (0 = empty)
  uint64_t mask = 0;

  void build(const int64_t* codes, int64_t n) {
    uint64_t cap = 16;
    while (cap < (uint64_t)(n * 2)) cap <<= 1;
    slots.assign(cap, 0);
    mask = cap - 1;
    for (int64_t i = 0; i < n; ++i) insert((uint64_t)codes[i]);
  }

  inline void insert(uint64_t key) {
    uint64_t h = (key * 0x9E3779B97F4A7C15ull) >> 17;
    for (uint64_t j = h & mask;; j = (j + 1) & mask) {
      if (slots[j] == 0) { slots[j] = key + 1; return; }
      if (slots[j] == key + 1) return;
    }
  }

  inline bool contains(uint64_t key) const {
    uint64_t h = (key * 0x9E3779B97F4A7C15ull) >> 17;
    for (uint64_t j = h & mask;; j = (j + 1) & mask) {
      if (slots[j] == 0) return false;
      if (slots[j] == key + 1) return true;
    }
  }
};

// face offsets in the exact order of ops/octree._FACE_OFFSETS:
// (-x,+x,-y,+y,-z,+z) -> pattern bit 0..5
inline int32_t face_pattern(const CodeSet& set, int64_t code, int level) {
  uint64_t c = (uint64_t)code;
  int64_t x = (int64_t)compact1by2(c >> 2);
  int64_t y = (int64_t)compact1by2(c >> 1);
  int64_t z = (int64_t)compact1by2(c);
  int64_t lim = (int64_t)1 << level;
  int32_t pat = 0;
  const int64_t dx[6] = {-1, 1, 0, 0, 0, 0};
  const int64_t dy[6] = {0, 0, -1, 1, 0, 0};
  const int64_t dz[6] = {0, 0, 0, 0, -1, 1};
  for (int i = 0; i < 6; ++i) {
    int64_t qx = x + dx[i], qy = y + dy[i], qz = z + dz[i];
    if (qx < 0 || qy < 0 || qz < 0 || qx >= lim || qy >= lim || qz >= lim)
      continue;
    if (set.contains(morton3((uint64_t)qx, (uint64_t)qy, (uint64_t)qz)))
      pat |= (1 << i);
  }
  return pat;
}

struct Level {
  std::vector<int64_t> codes;
  std::vector<uint8_t> occ;
};

}  // namespace

extern "C" {
void rce_occ_sym(RcEncoder*, uint16_t*, const int32_t*,
                 const uint8_t*, int64_t);
void rcd_occ_sym(RcDecoder*, uint16_t*, const int32_t*,
                 uint8_t*, int64_t);
}

extern "C" {

// Encode the octree of `n` sorted unique leaf codes at `depth` levels.
// Streams all occupancy bytes (top-down) through the encoder.  Returns
// the total number of coded tree nodes.
int64_t oct_encode(RcEncoder* e, uint16_t* ctx, const int64_t* codes,
                   int64_t n, int32_t depth, int32_t mode,
                   int32_t use_sym) {
  if (n == 0 || depth == 0) return 0;
  // bottom-up: collapse sorted child codes into parents + occupancy
  std::vector<Level> levels(depth);  // levels[l]: nodes at level l
  {
    const int64_t* cur = codes;
    int64_t m = n;
    for (int l = depth - 1; l >= 0; --l) {
      Level& lv = levels[l];
      lv.codes.reserve(m);
      lv.occ.reserve(m);
      for (int64_t i = 0; i < m;) {
        int64_t parent = cur[i] >> 3;
        uint8_t o = 0;
        do {
          o |= (uint8_t)(1u << (cur[i] & 7));
          ++i;
        } while (i < m && (cur[i] >> 3) == parent);
        lv.codes.push_back(parent);
        lv.occ.push_back(o);
      }
      cur = lv.codes.data();  // no copy: read the built level
      m = (int64_t)lv.codes.size();
    }
  }

  // top-down: context bases + entropy, level by level (batched)
  std::vector<int32_t> bases;
  std::vector<int32_t> parent_occ_next;  // parent occ for next level
  std::vector<int32_t> parent_occ = {0};
  int64_t total = 0;
  for (int l = 0; l < depth; ++l) {
    Level& lv = levels[l];
    int64_t m = (int64_t)lv.codes.size();
    total += m;
    bases.resize(m);
    if (mode == 1) {
      CodeSet set;
      set.build(lv.codes.data(), m);
      for (int64_t i = 0; i < m; ++i) {
        int32_t child = (int32_t)(lv.codes[i] & 7);
        bases[i] = face_pattern(set, lv.codes[i], l) | (child << 6);
      }
    } else {
      for (int64_t i = 0; i < m; ++i) {
        int32_t child = (int32_t)(lv.codes[i] & 7);
        bases[i] = (child << 8) | parent_occ[i];
      }
    }
    if (use_sym)
      rce_occ_sym(e, ctx, bases.data(), lv.occ.data(), m);
    else
      rce_occupancy(e, ctx, bases.data(), lv.occ.data(), m);
    if (mode == 0 && l + 1 < depth) {
      parent_occ_next.clear();
      parent_occ_next.reserve(levels[l + 1].codes.size());
      for (int64_t i = 0; i < m; ++i) {
        uint8_t o = lv.occ[i];
        int pc = __builtin_popcount(o);
        for (int j = 0; j < pc; ++j) parent_occ_next.push_back(o);
      }
      parent_occ.swap(parent_occ_next);
    }
  }
  return total;
}

// Decode the octree: writes up to `cap` sorted unique leaf codes into
// codes_out; returns the number written (or -needed if cap too small).
int64_t oct_decode(RcDecoder* d, uint16_t* ctx, int64_t* codes_out,
                   int64_t cap, int32_t depth, int32_t mode,
                   int32_t use_sym) {
  std::vector<int64_t> cur = {0};          // root
  std::vector<int32_t> parent_occ = {0};
  std::vector<uint8_t> occ;
  std::vector<int32_t> bases;
  std::vector<int64_t> next;
  std::vector<int32_t> next_parent_occ;
  for (int l = 0; l < depth; ++l) {
    int64_t m = (int64_t)cur.size();
    bases.resize(m);
    if (mode == 1) {
      CodeSet set;
      set.build(cur.data(), m);
      for (int64_t i = 0; i < m; ++i) {
        int32_t child = (int32_t)(cur[i] & 7);
        bases[i] = face_pattern(set, cur[i], l) | (child << 6);
      }
    } else {
      for (int64_t i = 0; i < m; ++i) {
        int32_t child = (int32_t)(cur[i] & 7);
        bases[i] = (child << 8) | parent_occ[i];
      }
    }
    occ.resize(m);
    if (use_sym)
      rcd_occ_sym(d, ctx, bases.data(), occ.data(), m);
    else
      rcd_occupancy(d, ctx, bases.data(), occ.data(), m);
    next.clear();
    next_parent_occ.clear();
    for (int64_t i = 0; i < m; ++i) {
      uint8_t o = occ[i];
      for (int j = 0; j < 8; ++j) {
        if (o & (1u << j)) {
          next.push_back((cur[i] << 3) | j);
          if (mode == 0) next_parent_occ.push_back(o);
        }
      }
    }
    cur.swap(next);
    parent_occ.swap(next_parent_occ);
  }
  int64_t n = (int64_t)cur.size();
  if (n > cap) return -n;
  std::memcpy(codes_out, cur.data(), n * sizeof(int64_t));
  return n;
}

// ---- inter-coded octree (reference-keyed occupancy contexts) ----------
//
// Contexts: base = child_idx << 8 | pred_occupancy, where
// pred_occupancy is the motion-compensated reference frame's occupancy
// byte for the node (reference predOccupancy contextualisation,
// geometry_octree_encoder.cpp:1875-1918).  ref_codes: sorted unique
// slice-local Morton codes of the compensated reference cloud.

namespace {

inline uint8_t pred_occ_for(const int64_t* ref, int64_t rn, int64_t node,
                            int shift_child) {
  // bits j set iff ref contains a code with prefix ((node<<3)|j) at
  // the child level; ref child prefixes = ref >> shift_child
  uint8_t occ = 0;
  for (int j = 0; j < 8; ++j) {
    int64_t target = (node << 3) | j;
    // binary search for any ref code whose >>shift_child == target
    int64_t lo = 0, hi = rn;
    int64_t lo_code = target << shift_child;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (ref[mid] < lo_code) lo = mid + 1; else hi = mid;
    }
    if (lo < rn && (ref[lo] >> shift_child) == target)
      occ |= (uint8_t)(1u << j);
  }
  return occ;
}

}  // namespace

int64_t oct_encode_inter(RcEncoder* e, uint16_t* ctx,
                         const int64_t* codes, int64_t n, int32_t depth,
                         const int64_t* ref, int64_t rn,
                         int32_t use_sym) {
  if (n == 0 || depth == 0) return 0;
  std::vector<Level> levels(depth);
  {
    const int64_t* cur = codes;
    int64_t m = n;
    for (int l = depth - 1; l >= 0; --l) {
      Level& lv = levels[l];
      lv.codes.reserve(m);
      lv.occ.reserve(m);
      for (int64_t i = 0; i < m;) {
        int64_t parent = cur[i] >> 3;
        uint8_t o = 0;
        do {
          o |= (uint8_t)(1u << (cur[i] & 7));
          ++i;
        } while (i < m && (cur[i] >> 3) == parent);
        lv.codes.push_back(parent);
        lv.occ.push_back(o);
      }
      cur = lv.codes.data();  // no copy: read the built level
      m = (int64_t)lv.codes.size();
    }
  }
  std::vector<int32_t> bases;
  int64_t total = 0;
  for (int l = 0; l < depth; ++l) {
    Level& lv = levels[l];
    int64_t m = (int64_t)lv.codes.size();
    total += m;
    bases.resize(m);
    int shift_child = 3 * (depth - l - 1);
    for (int64_t i = 0; i < m; ++i) {
      int32_t child = (int32_t)(lv.codes[i] & 7);
      bases[i] = (child << 8)
                 | pred_occ_for(ref, rn, lv.codes[i], shift_child);
    }
    if (use_sym)
      rce_occ_sym(e, ctx, bases.data(), lv.occ.data(), m);
    else
      rce_occupancy(e, ctx, bases.data(), lv.occ.data(), m);
  }
  return total;
}

int64_t oct_decode_inter(RcDecoder* d, uint16_t* ctx, int64_t* codes_out,
                         int64_t cap, int32_t depth,
                         const int64_t* ref, int64_t rn,
                         int32_t use_sym) {
  std::vector<int64_t> cur = {0};
  std::vector<uint8_t> occ;
  std::vector<int32_t> bases;
  std::vector<int64_t> next;
  for (int l = 0; l < depth; ++l) {
    int64_t m = (int64_t)cur.size();
    bases.resize(m);
    int shift_child = 3 * (depth - l - 1);
    for (int64_t i = 0; i < m; ++i) {
      int32_t child = (int32_t)(cur[i] & 7);
      bases[i] = (child << 8)
                 | pred_occ_for(ref, rn, cur[i], shift_child);
    }
    occ.resize(m);
    if (use_sym)
      rcd_occ_sym(d, ctx, bases.data(), occ.data(), m);
    else
      rcd_occupancy(d, ctx, bases.data(), occ.data(), m);
    next.clear();
    for (int64_t i = 0; i < m; ++i) {
      uint8_t o = occ[i];
      for (int j = 0; j < 8; ++j)
        if (o & (1u << j)) next.push_back((cur[i] << 3) | j);
    }
    cur.swap(next);
  }
  int64_t n = (int64_t)cur.size();
  if (n > cap) return -n;
  std::memcpy(codes_out, cur.data(), n * sizeof(int64_t));
  return n;
}

// Fused Morton encode + radix sort: xyz (n,3) int64 -> sorted codes
// (+ optional permutation).  One pass over the hot path that Python
// would otherwise do in three (morton, argsort, gather).
void morton_sort(const int64_t* xyz, int64_t n, int64_t* codes_out,
                 int64_t* perm_out);

void morton_encode64(const int64_t* xyz, int64_t n, int64_t* codes_out) {
  for (int64_t i = 0; i < n; ++i) {
    codes_out[i] = (int64_t)((part1by2((uint64_t)xyz[i * 3 + 0]) << 2)
                             | (part1by2((uint64_t)xyz[i * 3 + 1]) << 1)
                             | part1by2((uint64_t)xyz[i * 3 + 2]));
  }
}

// Radix sort of int64 Morton codes (6 passes of 11 bits), optionally
// returning the sorting permutation for attribute alignment.  Replaces
// np.argsort on the host hot path.
void radix_sort64(int64_t* keys, int64_t* perm_out, int64_t n) {
  if (n <= 1) {
    if (perm_out && n == 1) perm_out[0] = 0;
    return;
  }
  constexpr int kBits = 16;   // 4 passes over 63-bit keys
  constexpr int kBuckets = 1 << kBits;
  bool want_perm = perm_out != nullptr;
  std::vector<int64_t> buf_k(n), buf_p;
  if (want_perm) {
    for (int64_t i = 0; i < n; ++i) perm_out[i] = i;
    buf_p.resize(n);
  }
  int64_t* src_k = keys;
  int64_t* dst_k = buf_k.data();
  int64_t* src_p = perm_out;
  int64_t* dst_p = buf_p.data();
  int64_t count[kBuckets];  // stack: thread-safe (slice-parallel encode)
  for (int pass = 0; pass < 4; ++pass) {
    int shift = pass * kBits;
    std::memset(count, 0, sizeof(count));
    for (int64_t i = 0; i < n; ++i)
      count[(src_k[i] >> shift) & (kBuckets - 1)]++;
    int64_t sum = 0;
    for (int b = 0; b < kBuckets; ++b) {
      int64_t c = count[b];
      count[b] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      int64_t b = (src_k[i] >> shift) & (kBuckets - 1);
      int64_t dst = count[b]++;
      dst_k[dst] = src_k[i];
      if (want_perm) dst_p[dst] = src_p[i];
    }
    std::swap(src_k, dst_k);
    if (want_perm) std::swap(src_p, dst_p);
  }
  // even pass count: data ended back in the caller's arrays
  if (src_k != keys) std::memcpy(keys, src_k, n * sizeof(int64_t));
  if (want_perm && src_p != perm_out)
    std::memcpy(perm_out, src_p, n * sizeof(int64_t));
}

void morton_sort(const int64_t* xyz, int64_t n, int64_t* codes_out,
                 int64_t* perm_out) {
  morton_encode64(xyz, n, codes_out);
  radix_sort64(codes_out, perm_out, n);
}

}  // extern "C"

extern "C" {

// flat Morton decode for the Python utils fast path
// (utils/morton.py); encode64 above already matches the layout.
void morton_decode64(const int64_t* codes, int64_t n, int64_t* out) {
  auto compact = [](uint64_t x) {
    x &= 0x1249249249249249ull;
    x = (x ^ (x >> 2)) & 0x10C30C30C30C30C3ull;
    x = (x ^ (x >> 4)) & 0x100F00F00F00F00Full;
    x = (x ^ (x >> 8)) & 0x1F0000FF0000FFull;
    x = (x ^ (x >> 16)) & 0x1F00000000FFFFull;
    x = (x ^ (x >> 32)) & 0x1FFFFFull;
    return x;
  };
  for (int64_t i = 0; i < n; i++) {
    uint64_t c = uint64_t(codes[i]);
    out[i * 3] = int64_t(compact(c >> 2));
    out[i * 3 + 1] = int64_t(compact(c >> 1));
    out[i * 3 + 2] = int64_t(compact(c));
  }
}

}  // extern "C"
