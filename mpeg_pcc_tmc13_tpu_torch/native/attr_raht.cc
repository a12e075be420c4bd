// Native predicted-RAHT attribute engine.
//
// Bit-exact C++ mirror of the Python spec (ops/raht.py
// forward_predicted/inverse_predicted + models/attr_raht.py quant/
// RDOQ): same IEEE-double operations in the same order, so the
// emitted zrow stream is byte-identical to the numpy path and either
// side can decode the other.  Covers the common configuration
// (prediction on, no layer QP offsets, no LCP/inter, float transform);
// the Python path remains the executable spec and the fallback for
// the feature-rich configurations.
//
// Counterpart of the reference uraht_process (RAHT.cpp:977) with the
// sweep/pair redesign documented in ops/raht.py.
//
// Performance structure (round 4): all three of a group's dyadic
// sweeps pair nodes *within one parent's 2x2x2 block* (two nodes of
// different parents never share code>>1), so the whole group
// transform — forward on the prediction, residual against the truth
// ACs, and the inverse that reconstructs the children — runs as ONE
// pass over parents with the 12-butterfly network held in registers,
// instead of six full-array sweep rewrites.  Per-sweep output order
// is preserved exactly (blocks ascend in Morton order; in-block pairs
// ascend in merged-code order), so the zrow stream is unchanged.
// The 18-neighbour search is *inherited*: the neighbour of a child at
// offset j is a child of {its parent} union {its parent's neighbours}
// (kParentDir), found by octant-mask rank instead of any search.
// Neighbour tables are stored packed (presence mask + indices of
// present neighbours only), cutting table traffic ~4x on sparse
// levels where most of the 18 slots are empty.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef RAHT_PROF
#include <chrono>
static double g_ph[8];
struct ProfT {
  int k;
  std::chrono::steady_clock::time_point t0;
  ProfT(int k) : k(k), t0(std::chrono::steady_clock::now()) {}
  ~ProfT() {
    g_ph[k] += std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0).count();
  }
};
#define PROF(k) ProfT _p(k)
extern "C" double* raht_prof() { return g_ph; }
#else
#define PROF(k)
#endif

// opaque coder handles + the zrow batch entry points (entropy.cc)
struct RcEncoder;
struct RcDecoder;
extern "C" void rce_zrow(RcEncoder* e, uint16_t* ctx,
                         const int32_t* vals, int64_t n, int32_t ncomp);
extern "C" void rcd_zrow(RcDecoder* d, uint16_t* ctx, int32_t* vals,
                         int64_t n, int32_t ncomp);

namespace {

constexpr int kMaxComp = 3;

// ---- quantisation (models/attr_raht.py) ----------------------------

static inline int32_t quant1(double v, double step_q16) {
  double s = v * 65536.0 / step_q16;
  double q = std::floor(std::abs(s) + (1.0 / 3.0));
  if (s < 0) q = -q;
  else if (s == 0.0) q = 0.0;   // sign(0) = 0
  return (int32_t)q;
}

static inline double dequant1(int32_t q, double step_q16) {
  return (double)q * step_q16 / 65536.0;
}

// ---- RDOQ (models/attr_raht.py _rdoq_zero_rows) ---------------------

static const int64_t kLutLog[16] = {0,   256, 406, 512, 594, 662,
                                    719, 768, 812, 850, 886, 918,
                                    947, 975, 1000, 1024};
static const int64_t kLutBins[11] = {1, 2, 3, 5, 5, 7, 7, 9, 9, 11, 11};

static inline int bit_length(int64_t t) {
  int a = 0;
  while (t) {
    ++a;
    t >>= 1;
  }
  return a;
}

// reusable scratch for rdoq_rows
struct RdoqScratch {
  std::vector<int64_t> sumc, ratec;
  std::vector<double> dist2;
  std::vector<uint8_t> nf;
};

// rows (m x C) doubles; returns flags + updated train
static void rdoq_rows(const std::vector<double>& rows, int64_t m, int C,
                      const double* steps_q16, int64_t& train_io,
                      std::vector<uint8_t>& flag, RdoqScratch& ws) {
  flag.assign(m, 0);
  if (m == 0) return;
  ws.sumc.resize(m);
  ws.ratec.resize(m);
  ws.dist2.resize(m);
  for (int64_t i = 0; i < m; ++i) {
    int64_t sc = 0, rc = 0;
    double d2 = 0.0;
    for (int c = 0; c < C; ++c) {
      double v = rows[i * C + c];
      double s = std::abs(v) * 65536.0 / steps_q16[c];
      int64_t aq = (int64_t)std::floor(s + (1.0 / 3.0));
      sc += aq;
      rc += kLutLog[aq < 15 ? aq : 15];
      d2 += v * v;
    }
    ws.sumc[i] = sc;
    ws.ratec[i] = rc;
    ws.dist2[i] = d2;
  }
  double step_luma = steps_q16[0] / 65536.0;
  double mult = C == 1 ? 25.0 : 35.0;
  double lam = step_luma * step_luma * mult;
  // iterate the cascade to its monotone fixpoint (max 4 rounds).
  // Jacobi like the numpy spec: each round's flags are computed from
  // the PREVIOUS round's flags only (in-place updates would see
  // this-round flags for earlier rows and converge differently).
  ws.nf.resize(m);
  for (int it = 0; it < 4; ++it) {
    bool changed = false;
    int64_t last_nz = -1;  // last non-zero row among 0..i-1 (old flags)
    for (int64_t i = 0; i < m; ++i) {
      int64_t train = (last_nz < 0) ? i + train_io + 1
                                    : (i - 1 - last_nz);
      int64_t rate = kLutBins[train < 10 ? train : 10];
      if (train > 10) {
        int a = bit_length(train - 10);
        rate += 2 * a - 1 + 2;
      }
      rate += (ws.ratec[i] + 128) >> 8;
      bool f = ws.sumc[i] > 0 && ws.sumc[i] < 3
               && ws.dist2[i] * 1024.0 < lam * (double)rate;
      ws.nf[i] = f ? 1 : 0;
      if (ws.nf[i] != flag[i]) changed = true;
      if (!(ws.sumc[i] == 0 || flag[i])) last_nz = i;
    }
    if (!changed) break;
    flag.assign(ws.nf.begin(), ws.nf.end());
  }
  // train_out = trailing zero run
  int64_t last_nz = -1;
  for (int64_t i = 0; i < m; ++i)
    if (!(ws.sumc[i] == 0 || flag[i])) last_nz = i;
  train_io = (last_nz < 0) ? train_io + m : (m - 1 - last_nz);
}

// ---- 19-neighbour prediction tables ---------------------------------

static const int kNbrOff[18][3] = {
    {+1, 0, 0}, {-1, 0, 0}, {0, +1, 0}, {0, -1, 0}, {0, 0, +1},
    {0, 0, -1}, {+1, +1, 0}, {+1, -1, 0}, {-1, +1, 0}, {-1, -1, 0},
    {+1, 0, +1}, {+1, 0, -1}, {-1, 0, +1}, {-1, 0, -1}, {0, +1, +1},
    {0, +1, -1}, {0, -1, +1}, {0, -1, -1}};

// touch[o][j]: octant o uses neighbour offset j
static bool touch_tab(int o, int j) {
  int cb[3] = {(o >> 2) & 1, (o >> 1) & 1, o & 1};
  for (int a = 0; a < 3; ++a) {
    int d = kNbrOff[j][a];
    if (d > 0 && cb[a] != 1) return false;
    if (d < 0 && cb[a] != 0) return false;
  }
  return true;
}

struct PredParams {
  int64_t t0, t1;
  double w_self, w_face, w_edge;
};

// per-octant list of touching offsets, ascending j (the numpy spec
// accumulates offset-by-offset in ascending j, so per-octant sums in
// ascending j reproduce its FP order exactly)
struct OctJTab {
  int8_t j[8][8];
  int8_t cnt[8];
  OctJTab() {
    for (int o = 0; o < 8; ++o) {
      cnt[o] = 0;
      for (int jj = 0; jj < 18; ++jj)
        if (touch_tab(o, jj)) j[o][cnt[o]++] = (int8_t)jj;
    }
  }
};
static const OctJTab kOctJ;

// kParentDir[o][j]: for a child in octant o taking neighbour offset j,
// the offset index (0..17) of the *parent-level* cell holding that
// neighbour, or 18 when it is a sibling (same parent).
// kParentDir.oct[o][j]: the octant of that neighbour within its parent.
struct ParentDirTab {
  int8_t dir[8][18];
  int8_t oct[8][18];
  ParentDirTab() {
    for (int o = 0; o < 8; ++o) {
      int cb[3] = {(o >> 2) & 1, (o >> 1) & 1, o & 1};
      for (int j = 0; j < 18; ++j) {
        int pd[3], co = 0;
        for (int a = 0; a < 3; ++a) {
          int s = cb[a] + kNbrOff[j][a];
          pd[a] = s < 0 ? -1 : (s > 1 ? 1 : 0);
          co |= (s & 1) << (2 - a);
        }
        oct[o][j] = (int8_t)co;
        if (pd[0] == 0 && pd[1] == 0 && pd[2] == 0) {
          dir[o][j] = 18;
          continue;
        }
        int found = -1;
        for (int k = 0; k < 18; ++k)
          if (kNbrOff[k][0] == pd[0] && kNbrOff[k][1] == pd[1]
              && kNbrOff[k][2] == pd[2])
            found = k;
        dir[o][j] = (int8_t)found;  // always found: <=2 nonzero comps
      }
    }
  }
};
static const ParentDirTab kParentDir;

// kCellJ[o][d]: for a child at octant o, the neighbour offsets j whose
// target lives in parent-level cell d (d = 0..17 parent neighbour
// offsets, 18 = own parent), with the target's octant.  Inverts
// kParentDir so table inheritance iterates only the parent's PRESENT
// cells (sparse levels have 2-4 of 19) instead of all 18 offsets.
struct CellJTab {
  struct Ent {
    int8_t j, to;
  };
  Ent ent[8][19][8];
  int8_t cnt[8][19];
  CellJTab() {
    std::memset(cnt, 0, sizeof(cnt));
    for (int o = 0; o < 8; ++o)
      for (int j = 0; j < 18; ++j) {
        int d = kParentDir.dir[o][j];
        ent[o][d][cnt[o][d]++] = {(int8_t)j, kParentDir.oct[o][j]};
      }
  }
};
static const CellJTab kCellJ;

// ---- level pyramid ---------------------------------------------------

// levels[k]: nodes after k octree merges (levels[0] = leaves,
// levels[depth] = roots).  cstart/occm on level k (k>=1) describe its
// children in level k-1: children of node i are rows
// [cstart[i], cstart[i+1]) and occm[i] has bit o set iff octant o is
// occupied.
struct Level {
  std::vector<int64_t> codes;
  std::vector<int32_t> w;        // subtree weights
  std::vector<int32_t> cstart;   // size m+1
  std::vector<uint8_t> occm;
};

static void build_levels(const int64_t* leaf_codes, int64_t n, int depth,
                         std::vector<Level>& levels) {
  PROF(0);
  levels.resize(depth + 1);
  levels[0].codes.assign(leaf_codes, leaf_codes + n);
  levels[0].w.assign(n, 1);
  for (int k = 1; k <= depth; ++k) {
    const Level& f = levels[k - 1];
    Level& p = levels[k];
    int64_t m = (int64_t)f.codes.size();
    p.codes.reserve(m);
    p.w.reserve(m);
    p.cstart.reserve(m + 1);
    p.occm.reserve(m);
    int64_t i = 0;
    while (i < m) {
      int64_t pc = f.codes[i] >> 3;
      int32_t wsum = 0;
      uint8_t msk = 0;
      int64_t lo = i;
      do {
        wsum += f.w[i];
        msk |= (uint8_t)(1u << (f.codes[i] & 7));
        ++i;
      } while (i < m && (f.codes[i] >> 3) == pc);
      p.codes.push_back(pc);
      p.w.push_back(wsum);
      p.cstart.push_back((int32_t)lo);
      p.occm.push_back(msk);
    }
    p.cstart.push_back((int32_t)m);
  }
}

// ---- in-block butterfly network --------------------------------------
//
// One parent's 2x2x2 block: up to 8 child rows (ascending octant).
// The three dyadic sweeps of the group act entirely inside the block:
// stage z pairs octants (o, o|1), stage y pairs the resulting (x,y)
// cells, stage x pairs the two x cells.  a/b use the exact expressions
// of the numpy spec (a = sqrt(w1)/sqrt(w1+w2) with rs computed first).
//
// BlockPlan precomputes, per occupancy mask, which cells pair at each
// stage; weights/coefficients depend on the data so they stay runtime.

struct BlockState {
  // cell values/weights at the current stage, keyed 0..7 (stage z in),
  // 0..3 (xy), 0..1 (x)
  double v[8][kMaxComp];
  int32_t w[8];
  bool occ[8];
};

// forward one block through the 3 sweeps.  cnt_out[s] = pairs emitted
// at stage s; ac rows are written to acs[s] + cur[s]*C and cur advanced.
template <int C>
static inline void block_forward(BlockState& st, double* acs[3],
                                 int64_t cur[3]) {
  // stage z: octants (o, o|1) -> xy cells
  for (int xy = 0; xy < 4; ++xy) {
    int o0 = xy * 2, o1 = xy * 2 + 1;
    bool p0 = st.occ[o0], p1 = st.occ[o1];
    if (p0 && p1) {
      double w1 = (double)st.w[o0], w2 = (double)st.w[o1];
      double rs = std::sqrt(w1 + w2);
      double a = std::sqrt(w1) / rs, b = std::sqrt(w2) / rs;
      double* out = acs[0] + cur[0] * C;
      for (int c = 0; c < C; ++c) {
        double v1 = st.v[o0][c], v2 = st.v[o1][c];
        st.v[xy][c] = a * v1 + b * v2;
        out[c] = -b * v1 + a * v2;
      }
      ++cur[0];
      st.w[xy] = st.w[o0] + st.w[o1];
      st.occ[xy] = true;
    } else if (p0 || p1) {
      int o = p0 ? o0 : o1;
      if (xy != o)
        for (int c = 0; c < C; ++c) st.v[xy][c] = st.v[o][c];
      st.w[xy] = st.w[o];
      st.occ[xy] = true;
    } else {
      st.occ[xy] = false;
    }
  }
  // stage y: xy cells (x,0),(x,1) -> x cells
  for (int x = 0; x < 2; ++x) {
    int c0 = x * 2, c1 = x * 2 + 1;
    bool p0 = st.occ[c0], p1 = st.occ[c1];
    if (p0 && p1) {
      double w1 = (double)st.w[c0], w2 = (double)st.w[c1];
      double rs = std::sqrt(w1 + w2);
      double a = std::sqrt(w1) / rs, b = std::sqrt(w2) / rs;
      double* out = acs[1] + cur[1] * C;
      for (int c = 0; c < C; ++c) {
        double v1 = st.v[c0][c], v2 = st.v[c1][c];
        st.v[x][c] = a * v1 + b * v2;
        out[c] = -b * v1 + a * v2;
      }
      ++cur[1];
      st.w[x] = st.w[c0] + st.w[c1];
      st.occ[x] = true;
    } else if (p0 || p1) {
      int o = p0 ? c0 : c1;
      if (x != o)
        for (int c = 0; c < C; ++c) st.v[x][c] = st.v[o][c];
      st.w[x] = st.w[o];
      st.occ[x] = true;
    } else {
      st.occ[x] = false;
    }
  }
  // stage x: cells 0,1 -> block DC at cell 0
  if (st.occ[0] && st.occ[1]) {
    double w1 = (double)st.w[0], w2 = (double)st.w[1];
    double rs = std::sqrt(w1 + w2);
    double a = std::sqrt(w1) / rs, b = std::sqrt(w2) / rs;
    double* out = acs[2] + cur[2] * C;
    for (int c = 0; c < C; ++c) {
      double v1 = st.v[0][c], v2 = st.v[1][c];
      double dc = a * v1 + b * v2;
      out[c] = -b * v1 + a * v2;
      st.v[0][c] = dc;
    }
    ++cur[2];
  } else if (st.occ[1]) {
    for (int c = 0; c < C; ++c) st.v[0][c] = st.v[1][c];
  }
}

// inverse one block: dc (parent recon) + per-stage AC rows -> child
// values in st.v[oct].  occm/weights describe the block's children.
template <int C>
static inline void block_inverse(const uint8_t occm, const int32_t* cw,
                                 const double* dc,
                                 const double* acs[3], int64_t cur[3],
                                 BlockState& st) {
  // rebuild cell weights bottom-up (cheap integer work)
  int32_t wz[4];
  bool oz[4];
  int32_t woct[8];
  {
    int k = 0;
    for (int o = 0; o < 8; ++o)
      woct[o] = (occm >> o) & 1 ? cw[k++] : 0;
  }
  for (int xy = 0; xy < 4; ++xy) {
    wz[xy] = woct[xy * 2] + woct[xy * 2 + 1];
    oz[xy] = wz[xy] != 0;
  }
  int32_t wx[2] = {wz[0] + wz[1], wz[2] + wz[3]};
  bool ox[2] = {wx[0] != 0, wx[1] != 0};

  // stage x inverse: dc -> x cells
  if (ox[0] && ox[1]) {
    double w1 = (double)wx[0], w2 = (double)wx[1];
    double rs = std::sqrt(w1 + w2);
    double a = std::sqrt(w1) / rs, b = std::sqrt(w2) / rs;
    const double* ac = acs[2] + cur[2] * C;
    ++cur[2];
    for (int c = 0; c < C; ++c) {
      st.v[0][c] = a * dc[c] - b * ac[c];
      st.v[1][c] = b * dc[c] + a * ac[c];
    }
  } else {
    int x = ox[0] ? 0 : 1;
    for (int c = 0; c < C; ++c) st.v[x][c] = dc[c];
  }
  // stage y inverse: x cells -> xy cells (descend x=1 first so cell 1
  // isn't clobbered; output cells 0..3 never collide with inputs 0..1
  // except xy=0/1 which are handled after reads)
  double xv[2][kMaxComp];
  for (int x = 0; x < 2; ++x)
    if (ox[x])
      for (int c = 0; c < C; ++c) xv[x][c] = st.v[x][c];
  for (int x = 0; x < 2; ++x) {
    if (!ox[x]) {
      st.occ[x * 2] = st.occ[x * 2 + 1] = false;
      continue;
    }
    int c0 = x * 2, c1 = x * 2 + 1;
    bool p0 = oz[c0], p1 = oz[c1];
    if (p0 && p1) {
      double w1 = (double)wz[c0], w2 = (double)wz[c1];
      double rs = std::sqrt(w1 + w2);
      double a = std::sqrt(w1) / rs, b = std::sqrt(w2) / rs;
      const double* ac = acs[1] + cur[1] * C;
      ++cur[1];
      for (int c = 0; c < C; ++c) {
        st.v[c0][c] = a * xv[x][c] - b * ac[c];
        st.v[c1][c] = b * xv[x][c] + a * ac[c];
      }
    } else {
      int cc = p0 ? c0 : c1;
      for (int c = 0; c < C; ++c) st.v[cc][c] = xv[x][c];
    }
    st.occ[c0] = p0;
    st.occ[c1] = p1;
  }
  // stage z inverse: xy cells -> octants (descend xy=3..0; write
  // octants 6,7 before reading cell 3 is safe as reads go first)
  double zv[4][kMaxComp];
  for (int xy = 0; xy < 4; ++xy)
    if (oz[xy])
      for (int c = 0; c < C; ++c) zv[xy][c] = st.v[xy][c];
  for (int xy = 0; xy < 4; ++xy) {
    if (!oz[xy]) continue;
    int o0 = xy * 2, o1 = xy * 2 + 1;
    bool p0 = (occm >> o0) & 1, p1 = (occm >> o1) & 1;
    if (p0 && p1) {
      double w1 = (double)woct[o0], w2 = (double)woct[o1];
      double rs = std::sqrt(w1 + w2);
      double a = std::sqrt(w1) / rs, b = std::sqrt(w2) / rs;
      const double* ac = acs[0] + cur[0] * C;
      ++cur[0];
      for (int c = 0; c < C; ++c) {
        st.v[o0][c] = a * zv[xy][c] - b * ac[c];
        st.v[o1][c] = b * zv[xy][c] + a * ac[c];
      }
    } else {
      int o = p0 ? o0 : o1;
      for (int c = 0; c < C; ++c) st.v[o][c] = zv[xy][c];
    }
  }
}

// number of AC rows a block emits per stage, from its occupancy mask
static inline void block_pair_counts(uint8_t occm, int cnt[3]) {
  int z = 0, y = 0, x = 0;
  int xym = 0;
  for (int xy = 0; xy < 4; ++xy) {
    int o0 = (occm >> (xy * 2)) & 1, o1 = (occm >> (xy * 2 + 1)) & 1;
    if (o0 && o1) ++z;
    if (o0 || o1) xym |= 1 << xy;
  }
  for (int xx = 0; xx < 2; ++xx) {
    int c0 = (xym >> (xx * 2)) & 1, c1 = (xym >> (xx * 2 + 1)) & 1;
    if (c0 && c1) ++y;
  }
  int xm0 = (xym & 3) != 0, xm1 = (xym & 12) != 0;
  if (xm0 && xm1) ++x;
  cnt[0] = z;
  cnt[1] = y;
  cnt[2] = x;
}

// ---- packed neighbour tables -----------------------------------------

struct NbrPacked {
  std::vector<uint32_t> mask;   // 18-bit presence per node
  std::vector<int32_t> idx;     // packed indices of present neighbours
};

// ---- quant + rdoq + zrow encode one batch ----------------------------

struct QuantScratch {
  std::vector<uint8_t> flag;
  std::vector<int32_t> q;
  RdoqScratch rdoq;
};

static void quant_encode_batch(RcEncoder* enc, uint16_t* zrow_ctx,
                               std::vector<double>& rows, int64_t m,
                               int C, const double* steps,
                               bool do_rdoq, int64_t& train,
                               std::vector<double>& deq,
                               QuantScratch& ws) {
  PROF(4);
  if (do_rdoq) {
    rdoq_rows(rows, m, C, steps, train, ws.flag, ws.rdoq);
    for (int64_t i = 0; i < m; ++i)
      if (ws.flag[i])
        for (int c = 0; c < C; ++c) rows[i * C + c] = 0.0;
  }
  ws.q.resize(m * C);
  deq.resize(m * C);
  for (int64_t i = 0; i < m; ++i)
    for (int c = 0; c < C; ++c) {
      int32_t qq = quant1(rows[i * C + c], steps[c]);
      ws.q[i * C + c] = qq;
      deq[i * C + c] = dequant1(qq, steps[c]);
    }
  rce_zrow(enc, zrow_ctx, ws.q.data(), m, C);
}

// ---- the top-down group engine ----------------------------------------
//
// Shared by encoder and decoder; `Residuals` supplies acs_rec rows per
// stage given acs_pred rows (encoder: quantise truth-pred; decoder:
// read stream).  The group pass:
//   pass 1 (per parent): expand packed neighbour list, counts/enable,
//     per-child prediction (child-major with a per-parent ratio-test
//     mask), forward network on the prediction -> acs_pred rows,
//     child table inheritance for the next group.
//   residual stage (per sweep): quantise+code / read+dequantise.
//   pass 2 (per parent): inverse network from parent recon + acs_rec
//     -> child recon rows.

struct GroupCtx {
  // outputs of pass 1
  std::vector<double> acs_pred[3];
  int64_t npairs[3];
  std::vector<double> pf;          // parent means
  std::vector<uint8_t> counts_c;   // child neighbourhood counts
  NbrPacked nbr_c;                 // child packed tables
  std::vector<double> recon_c;     // pass-2 output
};

template <int C>
static void group_pass1(const Level& P, const Level& Ch,
                        const std::vector<double>& recon_p,
                        const NbrPacked& nbr_p,
                        const std::vector<uint8_t>* grand,
                        const PredParams& pp, bool build_child_tab,
                        GroupCtx& g) {
  PROF(3);
  int64_t mp = (int64_t)P.codes.size();
  int64_t mc = (int64_t)Ch.codes.size();

  // parent means pf = recon / sqrt(w) (explicit division: the numpy
  // spec divides, and a reciprocal multiply differs in the last ulp)
  g.pf.resize(mp * C);
  double* pf = g.pf.data();
  for (int64_t i = 0; i < mp; ++i) {
    double sw = std::sqrt((double)P.w[i]);
    for (int c = 0; c < C; ++c) pf[i * C + c] = recon_p[i * C + c] / sw;
  }

  // AC row counts per stage (prefix over parents not needed: single
  // sequential pass with 3 cursors)
  int64_t tot[3] = {0, 0, 0};
  for (int64_t i = 0; i < mp; ++i) {
    int cnt3[3];
    block_pair_counts(P.occm[i], cnt3);
    tot[0] += cnt3[0];
    tot[1] += cnt3[1];
    tot[2] += cnt3[2];
  }
  for (int s = 0; s < 3; ++s) {
    g.acs_pred[s].resize(tot[s] * C);
    g.npairs[s] = tot[s];
  }
  g.counts_c.resize(mc);
  if (build_child_tab) {
    g.nbr_c.mask.resize(mc);
    g.nbr_c.idx.clear();
    g.nbr_c.idx.reserve(mc * 4);
  }

  double* acs[3] = {g.acs_pred[0].data(), g.acs_pred[1].data(),
                    g.acs_pred[2].data()};
  int64_t cur[3] = {0, 0, 0};
  int64_t nbr_cursor = 0;
  BlockState st;
  int32_t nb[19];
  for (int64_t i = 0; i < mp; ++i) {
    // expand packed neighbour list
    uint32_t msk = nbr_p.mask[i];
    {
      for (int j = 0; j < 18; ++j) nb[j] = -1;
      uint32_t m2 = msk;
      while (m2) {
        int j = __builtin_ctz(m2);
        m2 &= m2 - 1;
        nb[j] = nbr_p.idx[nbr_cursor++];
      }
    }
    int cnt = 1 + __builtin_popcount(msk);
    bool en = cnt >= pp.t1;
    if (grand) en = en && (*grand)[i] >= pp.t0;

    int32_t clo = P.cstart[i], chi = P.cstart[i + 1];
    uint8_t occm = P.occm[i];

    // ratio-test mask + per-offset weighted values (parent-major),
    // then child-major octant sums in ascending-j order (numpy FP
    // order: s_oct accumulated from 0 offset-by-offset, w_self term
    // added afterwards)
    if (en) {
      double pv = pf[i * C + 0];
      uint32_t keep = 0;
      {
        uint32_t m2 = msk;
        while (m2) {
          int j = __builtin_ctz(m2);
          m2 &= m2 - 1;
          double nv = pf[(int64_t)nb[j] * C + 0];
          if (10 * nv > 2 * pv && 10 * nv < 25 * pv) keep |= 1u << j;
        }
      }
      int k = 0;
      for (int32_t ci = clo; ci < chi; ++ci, ++k) {
        int o = (int)(Ch.codes[ci] & 7);
        double s[kMaxComp] = {0.0};
        double w_oct = 0.0;
        for (int t = 0; t < kOctJ.cnt[o]; ++t) {
          int j = kOctJ.j[o][t];
          if (!((keep >> j) & 1)) continue;
          double wj = j < 6 ? pp.w_face : pp.w_edge;
          const double* v = &pf[(int64_t)nb[j] * C];
          for (int c = 0; c < C; ++c) s[c] += v[c] * wj;
          w_oct += wj;
        }
        double wsum = pp.w_self + w_oct;
        double sw = std::sqrt((double)Ch.w[ci]);
        for (int c = 0; c < C; ++c) {
          double acc = pf[i * C + c] * pp.w_self + s[c];
          st.v[o][c] = (acc / wsum) * sw;
        }
      }
      for (int o = 0; o < 8; ++o) st.occ[o] = (occm >> o) & 1;
      {
        int kk = 0;
        for (int o = 0; o < 8; ++o)
          st.w[o] = st.occ[o] ? Ch.w[clo + kk++] : 0;
      }
      block_forward<C>(st, acs, cur);
    } else {
      // prediction identically zero: the butterfly of zeros is zeros
      int cnt3[3];
      block_pair_counts(occm, cnt3);
      for (int s = 0; s < 3; ++s) {
        std::memset(acs[s] + cur[s] * C, 0,
                    sizeof(double) * cnt3[s] * C);
        cur[s] += cnt3[s];
      }
    }

    // child counts + packed table inheritance.  Iterate the parent's
    // PRESENT cells only (self + its neighbours): per cell, the child
    // offsets landing in it come from the static kCellJ lists.  The
    // per-cell occupancy/base loads are hoisted out of the child loop.
    for (int32_t ci = clo; ci < chi; ++ci)
      g.counts_c[ci] = (uint8_t)(cnt < 255 ? cnt : 255);
    if (build_child_tab) {
      // present cells for this parent: self (18) + mask bits
      int cells[20];
      int32_t cell_base[20];
      uint8_t cell_occ[20];
      int ncell = 0;
      {
        uint32_t m2 = msk;
        while (m2) {
          int d = __builtin_ctz(m2);
          m2 &= m2 - 1;
          int32_t gp = nb[d];
          cells[ncell] = d;
          cell_base[ncell] = P.cstart[gp];
          cell_occ[ncell] = P.occm[gp];
          ++ncell;
        }
        cells[ncell] = 18;
        cell_base[ncell] = clo;
        cell_occ[ncell] = occm;
        ++ncell;
      }
      for (int32_t ci = clo; ci < chi; ++ci) {
        int o = (int)(Ch.codes[ci] & 7);
        uint32_t cmask = 0;
        int32_t tmp[18];
        for (int e = 0; e < ncell; ++e) {
          int d = cells[e];
          uint8_t gm = cell_occ[e];
          int32_t base = cell_base[e];
          int kc = kCellJ.cnt[o][d];
          for (int t = 0; t < kc; ++t) {
            int j = kCellJ.ent[o][d][t].j;
            int to = kCellJ.ent[o][d][t].to;
            if (!((gm >> to) & 1)) continue;
            cmask |= 1u << j;
            tmp[j] = base + __builtin_popcount(gm & ((1u << to) - 1));
          }
        }
        g.nbr_c.mask[ci] = cmask;
        uint32_t m2 = cmask;
        while (m2) {
          int j = __builtin_ctz(m2);
          m2 &= m2 - 1;
          g.nbr_c.idx.push_back(tmp[j]);
        }
      }
    }
  }
}

template <int C>
static void group_pass2(const Level& P, const Level& Ch,
                        const std::vector<double>& recon_p,
                        const std::vector<double> acs_rec[3],
                        std::vector<double>& recon_c) {
  PROF(2);
  int64_t mp = (int64_t)P.codes.size();
  int64_t mc = (int64_t)Ch.codes.size();
  recon_c.resize(mc * C);
  const double* acs[3] = {acs_rec[0].data(), acs_rec[1].data(),
                          acs_rec[2].data()};
  int64_t cur[3] = {0, 0, 0};
  BlockState st;
  for (int64_t i = 0; i < mp; ++i) {
    int32_t clo = P.cstart[i], chi = P.cstart[i + 1];
    block_inverse<C>(P.occm[i], &Ch.w[clo], &recon_p[i * C], acs, cur,
                     st);
    int k = 0;
    for (int32_t ci = clo; ci < chi; ++ci, ++k) {
      int o = (int)(Ch.codes[ci] & 7);
      for (int c = 0; c < C; ++c) recon_c[ci * C + c] = st.v[o][c];
    }
  }
}

// bottom-up truth transform (encoder): fills acs_true[3*depth] and
// returns root DCs.
template <int C>
static void truth_forward(const std::vector<Level>& levels, int depth,
                          const int64_t* values,
                          std::vector<std::vector<double>>& acs_true,
                          std::vector<double>& root) {
  PROF(1);
  int64_t n = (int64_t)levels[0].codes.size();
  std::vector<double> vals(n * C), nxt;
  for (int64_t i = 0; i < n * C; ++i) vals[i] = (double)values[i];
  for (int k = 1; k <= depth; ++k) {
    const Level& P = levels[k];
    const Level& Ch = levels[k - 1];
    int64_t mp = (int64_t)P.codes.size();
    int64_t tot[3] = {0, 0, 0};
    for (int64_t i = 0; i < mp; ++i) {
      int cnt3[3];
      block_pair_counts(P.occm[i], cnt3);
      tot[0] += cnt3[0];
      tot[1] += cnt3[1];
      tot[2] += cnt3[2];
    }
    double* acs[3];
    for (int s = 0; s < 3; ++s) {
      acs_true[3 * (k - 1) + s].resize(tot[s] * C);
      acs[s] = acs_true[3 * (k - 1) + s].data();
    }
    int64_t cur[3] = {0, 0, 0};
    nxt.resize(mp * C);
    BlockState st;
    for (int64_t i = 0; i < mp; ++i) {
      int32_t clo = P.cstart[i], chi = P.cstart[i + 1];
      uint8_t occm = P.occm[i];
      int k2 = 0;
      for (int o = 0; o < 8; ++o) {
        bool p = (occm >> o) & 1;
        st.occ[o] = p;
        if (p) {
          int32_t ci = clo + k2;
          for (int c = 0; c < C; ++c) st.v[o][c] = vals[ci * C + c];
          st.w[o] = Ch.w[ci];
          ++k2;
        } else {
          st.w[o] = 0;
        }
      }
      (void)chi;
      block_forward<C>(st, acs, cur);
      for (int c = 0; c < C; ++c) nxt[i * C + c] = st.v[0][c];
    }
    vals.swap(nxt);
  }
  root = vals;
}

template <int C>
static int encode_impl(RcEncoder* enc, uint16_t* zrow_ctx,
                       const int64_t* leaf_codes, int64_t n, int depth,
                       const int64_t* values, const double* steps,
                       const PredParams& pp) {
  std::vector<Level> levels;
  build_levels(leaf_codes, n, depth, levels);

  std::vector<std::vector<double>> acs_true(3 * depth);
  std::vector<double> root;
  truth_forward<C>(levels, depth, values, acs_true, root);

  int64_t train = 0;
  QuantScratch qws;
  std::vector<double> recon;
  {
    int64_t m = (int64_t)root.size() / C;
    quant_encode_batch(enc, zrow_ctx, root, m, C, steps,
                       /*rdoq=*/false, train, recon, qws);
  }

  GroupCtx g;
  std::vector<uint8_t> grand;
  NbrPacked nbr_p;
  nbr_p.mask.assign(levels[depth].codes.size(), 0);
  std::vector<double> res, deq;
  std::vector<double> acs_rec[3];
  for (int gi = 0; gi < depth; ++gi) {
    const Level& P = levels[depth - gi];
    const Level& Ch = levels[depth - gi - 1];
    group_pass1<C>(P, Ch, recon, nbr_p,
                   gi > 0 ? &grand : nullptr, pp,
                   /*build_child_tab=*/gi + 1 < depth, g);
    grand.swap(g.counts_c);
    nbr_p.mask.swap(g.nbr_c.mask);
    nbr_p.idx.swap(g.nbr_c.idx);

    int g_lo = 3 * (depth - 1 - gi);
    for (int s = 0; s < 3; ++s) {
      const std::vector<double>& tr = acs_true[g_lo + s];
      const std::vector<double>& pr = g.acs_pred[s];
      int64_t m = g.npairs[s];
      res.resize(m * C);
      for (int64_t i = 0; i < m * C; ++i) res[i] = tr[i] - pr[i];
      quant_encode_batch(enc, zrow_ctx, res, m, C, steps,
                         /*rdoq=*/true, train, deq, qws);
      acs_rec[s].resize(m * C);
      for (int64_t i = 0; i < m * C; ++i)
        acs_rec[s][i] = pr[i] + deq[i];
      acs_true[g_lo + s].clear();
      acs_true[g_lo + s].shrink_to_fit();
    }
    group_pass2<C>(P, Ch, recon, acs_rec, g.recon_c);
    recon.swap(g.recon_c);
  }
  return 0;
}

template <int C>
static int decode_impl(RcDecoder* dec, uint16_t* zrow_ctx,
                       const int64_t* leaf_codes, int64_t n, int depth,
                       int64_t* out_values, const double* steps,
                       const PredParams& pp) {
  std::vector<Level> levels;
  build_levels(leaf_codes, n, depth, levels);

  int64_t n_roots = (int64_t)levels[depth].codes.size();
  std::vector<double> recon(n_roots * C);
  {
    std::vector<int32_t> q(n_roots * C);
    rcd_zrow(dec, zrow_ctx, q.data(), n_roots, C);
    for (int64_t i = 0; i < n_roots * C; ++i)
      recon[i] = dequant1(q[i], steps[i % C]);
  }

  GroupCtx g;
  std::vector<uint8_t> grand;
  NbrPacked nbr_p;
  nbr_p.mask.assign(n_roots, 0);
  std::vector<int32_t> q;
  std::vector<double> acs_rec[3];
  for (int gi = 0; gi < depth; ++gi) {
    const Level& P = levels[depth - gi];
    const Level& Ch = levels[depth - gi - 1];
    group_pass1<C>(P, Ch, recon, nbr_p,
                   gi > 0 ? &grand : nullptr, pp,
                   /*build_child_tab=*/gi + 1 < depth, g);
    grand.swap(g.counts_c);
    nbr_p.mask.swap(g.nbr_c.mask);
    nbr_p.idx.swap(g.nbr_c.idx);

    for (int s = 0; s < 3; ++s) {
      int64_t m = g.npairs[s];
      q.resize(m * C);
      rcd_zrow(dec, zrow_ctx, q.data(), m, C);
      acs_rec[s].resize(m * C);
      const std::vector<double>& pr = g.acs_pred[s];
      for (int64_t i = 0; i < m; ++i)
        for (int c = 0; c < C; ++c)
          acs_rec[s][i * C + c] =
              pr[i * C + c] + dequant1(q[i * C + c], steps[c]);
    }
    group_pass2<C>(P, Ch, recon, acs_rec, g.recon_c);
    recon.swap(g.recon_c);
  }
  // round-half-even like np.round
  for (int64_t i = 0; i < n * C; ++i)
    out_values[i] = (int64_t)std::nearbyint(recon[i]);
  return 0;
}

// ---------------------------------------------------------------------------
// fixed-point mode (ops/raht_fp.py): all-integer closed loop, identical
// streams from numpy / this engine / the device kernel.  Values carry
// F=13 fractional bits (int64), butterfly and sqrt-scale coefficients
// are Q15 integer square roots.  Same block structure as the float
// engine above; no RDOQ (the fp spec omits it).
// ---------------------------------------------------------------------------

constexpr int kF = 13;
constexpr int64_t kHalfF = 1 << 12;
constexpr int kQA = 15;
constexpr int64_t kQAH = 1 << 14;

static inline int64_t fdiv(int64_t a, int64_t b) {  // floor div, b > 0
  int64_t q = a / b, r = a % b;
  return (r != 0 && r < 0) ? q - 1 : q;
}

static inline int64_t isqrt64(int64_t x) {
  // mirrors ops/raht_fp.py isqrt64: f64 seed truncated, 2 corrections
  int64_t y = (int64_t)std::sqrt((double)x);
  for (int it = 0; it < 2; ++it) {
    if ((y + 1) * (y + 1) <= x) ++y;
    if (y * y > x) --y;
  }
  return y < 0 ? 0 : y;
}

static inline int64_t sqrt_q15(int64_t w) { return isqrt64(w << 30); }

static inline void ab_q15(int64_t w1, int64_t w2, int64_t& a,
                          int64_t& b) {
  int64_t ws = w1 + w2;
  a = isqrt64((w1 << 30) / ws);
  b = isqrt64((w2 << 30) / ws);
}

struct BlockStateI {
  int64_t v[8][kMaxComp];
  int64_t w[8];
  bool occ[8];
};

template <int C>
static inline void block_forward_fp(BlockStateI& st, int64_t* acs[3],
                                    int64_t cur[3]) {
  for (int xy = 0; xy < 4; ++xy) {
    int o0 = xy * 2, o1 = xy * 2 + 1;
    bool p0 = st.occ[o0], p1 = st.occ[o1];
    if (p0 && p1) {
      int64_t a, b;
      ab_q15(st.w[o0], st.w[o1], a, b);
      int64_t* out = acs[0] + cur[0] * C;
      for (int c = 0; c < C; ++c) {
        int64_t v1 = st.v[o0][c], v2 = st.v[o1][c];
        st.v[xy][c] = (a * v1 + b * v2 + kQAH) >> kQA;
        out[c] = (a * v2 - b * v1 + kQAH) >> kQA;
      }
      ++cur[0];
      st.w[xy] = st.w[o0] + st.w[o1];
      st.occ[xy] = true;
    } else if (p0 || p1) {
      int o = p0 ? o0 : o1;
      if (xy != o)
        for (int c = 0; c < C; ++c) st.v[xy][c] = st.v[o][c];
      st.w[xy] = st.w[o];
      st.occ[xy] = true;
    } else {
      st.occ[xy] = false;
    }
  }
  for (int x = 0; x < 2; ++x) {
    int c0 = x * 2, c1 = x * 2 + 1;
    bool p0 = st.occ[c0], p1 = st.occ[c1];
    if (p0 && p1) {
      int64_t a, b;
      ab_q15(st.w[c0], st.w[c1], a, b);
      int64_t* out = acs[1] + cur[1] * C;
      for (int c = 0; c < C; ++c) {
        int64_t v1 = st.v[c0][c], v2 = st.v[c1][c];
        st.v[x][c] = (a * v1 + b * v2 + kQAH) >> kQA;
        out[c] = (a * v2 - b * v1 + kQAH) >> kQA;
      }
      ++cur[1];
      st.w[x] = st.w[c0] + st.w[c1];
      st.occ[x] = true;
    } else if (p0 || p1) {
      int o = p0 ? c0 : c1;
      if (x != o)
        for (int c = 0; c < C; ++c) st.v[x][c] = st.v[o][c];
      st.w[x] = st.w[o];
      st.occ[x] = true;
    } else {
      st.occ[x] = false;
    }
  }
  if (st.occ[0] && st.occ[1]) {
    int64_t a, b;
    ab_q15(st.w[0], st.w[1], a, b);
    int64_t* out = acs[2] + cur[2] * C;
    for (int c = 0; c < C; ++c) {
      int64_t v1 = st.v[0][c], v2 = st.v[1][c];
      int64_t dc = (a * v1 + b * v2 + kQAH) >> kQA;
      out[c] = (a * v2 - b * v1 + kQAH) >> kQA;
      st.v[0][c] = dc;
    }
    ++cur[2];
  } else if (st.occ[1]) {
    for (int c = 0; c < C; ++c) st.v[0][c] = st.v[1][c];
  }
}

template <int C>
static inline void block_inverse_fp(const uint8_t occm,
                                    const int32_t* cw,
                                    const int64_t* dc,
                                    const int64_t* acs[3],
                                    int64_t cur[3], BlockStateI& st) {
  int64_t woct[8];
  {
    int k = 0;
    for (int o = 0; o < 8; ++o)
      woct[o] = (occm >> o) & 1 ? (int64_t)cw[k++] : 0;
  }
  int64_t wz[4];
  bool oz[4];
  for (int xy = 0; xy < 4; ++xy) {
    wz[xy] = woct[xy * 2] + woct[xy * 2 + 1];
    oz[xy] = wz[xy] != 0;
  }
  int64_t wx[2] = {wz[0] + wz[1], wz[2] + wz[3]};
  bool ox[2] = {wx[0] != 0, wx[1] != 0};

  if (ox[0] && ox[1]) {
    int64_t a, b;
    ab_q15(wx[0], wx[1], a, b);
    const int64_t* ac = acs[2] + cur[2] * C;
    ++cur[2];
    for (int c = 0; c < C; ++c) {
      st.v[0][c] = (a * dc[c] - b * ac[c] + kQAH) >> kQA;
      st.v[1][c] = (b * dc[c] + a * ac[c] + kQAH) >> kQA;
    }
  } else {
    int x = ox[0] ? 0 : 1;
    for (int c = 0; c < C; ++c) st.v[x][c] = dc[c];
  }
  int64_t xv[2][kMaxComp];
  for (int x = 0; x < 2; ++x)
    if (ox[x])
      for (int c = 0; c < C; ++c) xv[x][c] = st.v[x][c];
  for (int x = 0; x < 2; ++x) {
    if (!ox[x]) continue;
    int c0 = x * 2, c1 = x * 2 + 1;
    bool p0 = oz[c0], p1 = oz[c1];
    if (p0 && p1) {
      int64_t a, b;
      ab_q15(wz[c0], wz[c1], a, b);
      const int64_t* ac = acs[1] + cur[1] * C;
      ++cur[1];
      for (int c = 0; c < C; ++c) {
        st.v[c0][c] = (a * xv[x][c] - b * ac[c] + kQAH) >> kQA;
        st.v[c1][c] = (b * xv[x][c] + a * ac[c] + kQAH) >> kQA;
      }
    } else {
      int cc = p0 ? c0 : c1;
      for (int c = 0; c < C; ++c) st.v[cc][c] = xv[x][c];
    }
  }
  int64_t zv[4][kMaxComp];
  for (int xy = 0; xy < 4; ++xy)
    if (oz[xy])
      for (int c = 0; c < C; ++c) zv[xy][c] = st.v[xy][c];
  for (int xy = 0; xy < 4; ++xy) {
    if (!oz[xy]) continue;
    int o0 = xy * 2, o1 = xy * 2 + 1;
    bool p0 = (occm >> o0) & 1, p1 = (occm >> o1) & 1;
    if (p0 && p1) {
      int64_t a, b;
      ab_q15(woct[o0], woct[o1], a, b);
      const int64_t* ac = acs[0] + cur[0] * C;
      ++cur[0];
      for (int c = 0; c < C; ++c) {
        st.v[o0][c] = (a * zv[xy][c] - b * ac[c] + kQAH) >> kQA;
        st.v[o1][c] = (b * zv[xy][c] + a * ac[c] + kQAH) >> kQA;
      }
    } else {
      int o = p0 ? o0 : o1;
      for (int c = 0; c < C; ++c) st.v[o][c] = zv[xy][c];
    }
  }
}

static inline int32_t quant_fp1(int64_t res, int64_t step) {
  int64_t a = res < 0 ? -res : res;
  int64_t q = (24 * a + step) / (3 * step);
  return (int32_t)(res < 0 ? -q : q);
}

static inline int64_t dequant_fp1(int32_t q, int64_t step) {
  int64_t a = q < 0 ? -(int64_t)q : (int64_t)q;
  int64_t d = (a * step + 4) >> 3;
  return q < 0 ? -d : d;
}

// group pass 1, fixed point: prediction + forward network on it.
// Same neighbour-table logic as the float engine.
template <int C>
struct GroupCtxI {
  std::vector<int64_t> acs_pred[3];
  int64_t npairs[3];
  std::vector<int64_t> pf;
  std::vector<uint8_t> counts_c;
  NbrPacked nbr_c;
  std::vector<int64_t> recon_c;
};

template <int C>
static void group_pass1_fp(const Level& P, const Level& Ch,
                           const std::vector<int64_t>& recon_p,
                           const NbrPacked& nbr_p,
                           const std::vector<uint8_t>* grand,
                           const PredParams& pp, bool build_child_tab,
                           GroupCtxI<C>& g) {
  PROF(3);
  int64_t mp = (int64_t)P.codes.size();
  int64_t mc = (int64_t)Ch.codes.size();

  g.pf.resize(mp * C);
  int64_t* pf = g.pf.data();
  for (int64_t i = 0; i < mp; ++i) {
    int64_t sw = sqrt_q15(P.w[i]);
    for (int c = 0; c < C; ++c)
      pf[i * C + c] = fdiv(recon_p[i * C + c] << kQA, sw);
  }

  int64_t tot[3] = {0, 0, 0};
  for (int64_t i = 0; i < mp; ++i) {
    int cnt3[3];
    block_pair_counts(P.occm[i], cnt3);
    tot[0] += cnt3[0];
    tot[1] += cnt3[1];
    tot[2] += cnt3[2];
  }
  for (int s = 0; s < 3; ++s) {
    g.acs_pred[s].resize(tot[s] * C);
    g.npairs[s] = tot[s];
  }
  g.counts_c.resize(mc);
  if (build_child_tab) {
    g.nbr_c.mask.resize(mc);
    g.nbr_c.idx.clear();
    g.nbr_c.idx.reserve(mc * 4);
  }

  const int64_t iw_self = (int64_t)pp.w_self;
  const int64_t iw_face = (int64_t)pp.w_face;
  const int64_t iw_edge = (int64_t)pp.w_edge;

  int64_t* acs[3] = {g.acs_pred[0].data(), g.acs_pred[1].data(),
                     g.acs_pred[2].data()};
  int64_t cur[3] = {0, 0, 0};
  int64_t nbr_cursor = 0;
  BlockStateI st;
  int32_t nb[19];
  for (int64_t i = 0; i < mp; ++i) {
    uint32_t msk = nbr_p.mask[i];
    {
      for (int j = 0; j < 18; ++j) nb[j] = -1;
      uint32_t m2 = msk;
      while (m2) {
        int j = __builtin_ctz(m2);
        m2 &= m2 - 1;
        nb[j] = nbr_p.idx[nbr_cursor++];
      }
    }
    int cnt = 1 + __builtin_popcount(msk);
    bool en = cnt >= pp.t1;
    if (grand) en = en && (*grand)[i] >= pp.t0;

    int32_t clo = P.cstart[i], chi = P.cstart[i + 1];
    uint8_t occm = P.occm[i];

    if (en) {
      int64_t pv = pf[i * C + 0];
      uint32_t keep = 0;
      {
        uint32_t m2 = msk;
        while (m2) {
          int j = __builtin_ctz(m2);
          m2 &= m2 - 1;
          int64_t nv = pf[(int64_t)nb[j] * C + 0];
          if (10 * nv > 2 * pv && 10 * nv < 25 * pv) keep |= 1u << j;
        }
      }
      int k = 0;
      for (int32_t ci = clo; ci < chi; ++ci, ++k) {
        int o = (int)(Ch.codes[ci] & 7);
        int64_t s[kMaxComp] = {0};
        int64_t w_oct = 0;
        for (int t = 0; t < kOctJ.cnt[o]; ++t) {
          int j = kOctJ.j[o][t];
          if (!((keep >> j) & 1)) continue;
          int64_t wj = j < 6 ? iw_face : iw_edge;
          const int64_t* v = &pf[(int64_t)nb[j] * C];
          for (int c = 0; c < C; ++c) s[c] += v[c] * wj;
          w_oct += wj;
        }
        int64_t wsum = iw_self + w_oct;
        int64_t sw = sqrt_q15(Ch.w[ci]);
        for (int c = 0; c < C; ++c) {
          int64_t pm = fdiv(pf[i * C + c] * iw_self + s[c], wsum);
          st.v[o][c] = (pm * sw + kQAH) >> kQA;
        }
      }
      for (int o = 0; o < 8; ++o) st.occ[o] = (occm >> o) & 1;
      {
        int kk = 0;
        for (int o = 0; o < 8; ++o)
          st.w[o] = st.occ[o] ? (int64_t)Ch.w[clo + kk++] : 0;
      }
      block_forward_fp<C>(st, acs, cur);
    } else {
      int cnt3[3];
      block_pair_counts(occm, cnt3);
      for (int s = 0; s < 3; ++s) {
        std::memset(acs[s] + cur[s] * C,
                    0, sizeof(int64_t) * cnt3[s] * C);
        cur[s] += cnt3[s];
      }
    }

    for (int32_t ci = clo; ci < chi; ++ci)
      g.counts_c[ci] = (uint8_t)(cnt < 255 ? cnt : 255);
    if (build_child_tab) {
      int cells[20];
      int32_t cell_base[20];
      uint8_t cell_occ[20];
      int ncell = 0;
      {
        uint32_t m2 = msk;
        while (m2) {
          int d = __builtin_ctz(m2);
          m2 &= m2 - 1;
          int32_t gp = nb[d];
          cells[ncell] = d;
          cell_base[ncell] = P.cstart[gp];
          cell_occ[ncell] = P.occm[gp];
          ++ncell;
        }
        cells[ncell] = 18;
        cell_base[ncell] = clo;
        cell_occ[ncell] = occm;
        ++ncell;
      }
      for (int32_t ci = clo; ci < chi; ++ci) {
        int o = (int)(Ch.codes[ci] & 7);
        uint32_t cmask = 0;
        int32_t tmp[18];
        for (int e = 0; e < ncell; ++e) {
          int d = cells[e];
          uint8_t gm = cell_occ[e];
          int32_t base = cell_base[e];
          int kc = kCellJ.cnt[o][d];
          for (int t = 0; t < kc; ++t) {
            int j = kCellJ.ent[o][d][t].j;
            int to = kCellJ.ent[o][d][t].to;
            if (!((gm >> to) & 1)) continue;
            cmask |= 1u << j;
            tmp[j] = base + __builtin_popcount(gm & ((1u << to) - 1));
          }
        }
        g.nbr_c.mask[ci] = cmask;
        uint32_t m2 = cmask;
        while (m2) {
          int j = __builtin_ctz(m2);
          m2 &= m2 - 1;
          g.nbr_c.idx.push_back(tmp[j]);
        }
      }
    }
  }
}

template <int C>
static void group_pass2_fp(const Level& P, const Level& Ch,
                           const std::vector<int64_t>& recon_p,
                           const std::vector<int64_t> acs_rec[3],
                           std::vector<int64_t>& recon_c) {
  PROF(2);
  int64_t mp = (int64_t)P.codes.size();
  int64_t mc = (int64_t)Ch.codes.size();
  recon_c.resize(mc * C);
  const int64_t* acs[3] = {acs_rec[0].data(), acs_rec[1].data(),
                           acs_rec[2].data()};
  int64_t cur[3] = {0, 0, 0};
  BlockStateI st;
  for (int64_t i = 0; i < mp; ++i) {
    int32_t clo = P.cstart[i], chi = P.cstart[i + 1];
    block_inverse_fp<C>(P.occm[i], &Ch.w[clo], &recon_p[i * C], acs,
                        cur, st);
    for (int32_t ci = clo; ci < chi; ++ci) {
      int o = (int)(Ch.codes[ci] & 7);
      for (int c = 0; c < C; ++c) recon_c[ci * C + c] = st.v[o][c];
    }
  }
}

template <int C>
static void truth_forward_fp(const std::vector<Level>& levels,
                             int depth, const int64_t* values,
                             std::vector<std::vector<int64_t>>& acs_true,
                             std::vector<int64_t>& root) {
  PROF(1);
  int64_t n = (int64_t)levels[0].codes.size();
  std::vector<int64_t> vals(n * C), nxt;
  for (int64_t i = 0; i < n * C; ++i) vals[i] = values[i] << kF;
  for (int k = 1; k <= depth; ++k) {
    const Level& P = levels[k];
    const Level& Ch = levels[k - 1];
    int64_t mp = (int64_t)P.codes.size();
    int64_t tot[3] = {0, 0, 0};
    for (int64_t i = 0; i < mp; ++i) {
      int cnt3[3];
      block_pair_counts(P.occm[i], cnt3);
      tot[0] += cnt3[0];
      tot[1] += cnt3[1];
      tot[2] += cnt3[2];
    }
    int64_t* acs[3];
    for (int s = 0; s < 3; ++s) {
      acs_true[3 * (k - 1) + s].resize(tot[s] * C);
      acs[s] = acs_true[3 * (k - 1) + s].data();
    }
    int64_t cur[3] = {0, 0, 0};
    nxt.resize(mp * C);
    BlockStateI st;
    for (int64_t i = 0; i < mp; ++i) {
      int32_t clo = P.cstart[i];
      uint8_t occm = P.occm[i];
      int k2 = 0;
      for (int o = 0; o < 8; ++o) {
        bool p = (occm >> o) & 1;
        st.occ[o] = p;
        if (p) {
          int32_t ci = clo + k2;
          for (int c = 0; c < C; ++c) st.v[o][c] = vals[ci * C + c];
          st.w[o] = Ch.w[ci];
          ++k2;
        } else {
          st.w[o] = 0;
        }
      }
      block_forward_fp<C>(st, acs, cur);
      for (int c = 0; c < C; ++c) nxt[i * C + c] = st.v[0][c];
    }
    vals.swap(nxt);
  }
  root = vals;
}

template <int C>
static int encode_impl_fp(RcEncoder* enc, uint16_t* zrow_ctx,
                          const int64_t* leaf_codes, int64_t n,
                          int depth, const int64_t* values,
                          const int64_t* steps, const PredParams& pp) {
  std::vector<Level> levels;
  build_levels(leaf_codes, n, depth, levels);
  std::vector<std::vector<int64_t>> acs_true(3 * depth);
  std::vector<int64_t> root;
  truth_forward_fp<C>(levels, depth, values, acs_true, root);

  std::vector<int32_t> q;
  std::vector<int64_t> recon;
  auto quant_batch = [&](std::vector<int64_t>& rows) {
    PROF(4);
    int64_t m = (int64_t)rows.size() / C;
    q.resize(m * C);
    recon.resize(m * C);
    for (int64_t i = 0; i < m; ++i)
      for (int c = 0; c < C; ++c) {
        int32_t qq = quant_fp1(rows[i * C + c], steps[c]);
        q[i * C + c] = qq;
        recon[i * C + c] = dequant_fp1(qq, steps[c]);
      }
    rce_zrow(enc, zrow_ctx, q.data(), m, C);
  };

  quant_batch(root);
  std::vector<int64_t> recon_lvl = recon;

  GroupCtxI<C> g;
  std::vector<uint8_t> grand;
  NbrPacked nbr_p;
  nbr_p.mask.assign(levels[depth].codes.size(), 0);
  std::vector<int64_t> res;
  std::vector<int64_t> acs_rec[3];
  for (int gi = 0; gi < depth; ++gi) {
    const Level& P = levels[depth - gi];
    const Level& Ch = levels[depth - gi - 1];
    group_pass1_fp<C>(P, Ch, recon_lvl, nbr_p,
                      gi > 0 ? &grand : nullptr, pp,
                      gi + 1 < depth, g);
    grand.swap(g.counts_c);
    nbr_p.mask.swap(g.nbr_c.mask);
    nbr_p.idx.swap(g.nbr_c.idx);

    int g_lo = 3 * (depth - 1 - gi);
    for (int s = 0; s < 3; ++s) {
      const std::vector<int64_t>& tr = acs_true[g_lo + s];
      const std::vector<int64_t>& pr = g.acs_pred[s];
      int64_t m = g.npairs[s];
      res.resize(m * C);
      for (int64_t i = 0; i < m * C; ++i) res[i] = tr[i] - pr[i];
      quant_batch(res);
      acs_rec[s].resize(m * C);
      for (int64_t i = 0; i < m * C; ++i)
        acs_rec[s][i] = pr[i] + recon[i];
      acs_true[g_lo + s].clear();
      acs_true[g_lo + s].shrink_to_fit();
    }
    group_pass2_fp<C>(P, Ch, recon_lvl, acs_rec, g.recon_c);
    recon_lvl.swap(g.recon_c);
  }
  return 0;
}

template <int C>
static int decode_impl_fp(RcDecoder* dec, uint16_t* zrow_ctx,
                          const int64_t* leaf_codes, int64_t n,
                          int depth, int64_t* out_values,
                          const int64_t* steps, const PredParams& pp) {
  std::vector<Level> levels;
  build_levels(leaf_codes, n, depth, levels);

  int64_t n_roots = (int64_t)levels[depth].codes.size();
  std::vector<int64_t> recon(n_roots * C);
  std::vector<int32_t> q;
  {
    q.resize(n_roots * C);
    rcd_zrow(dec, zrow_ctx, q.data(), n_roots, C);
    for (int64_t i = 0; i < n_roots * C; ++i)
      recon[i] = dequant_fp1(q[i], steps[i % C]);
  }

  GroupCtxI<C> g;
  std::vector<uint8_t> grand;
  NbrPacked nbr_p;
  nbr_p.mask.assign(n_roots, 0);
  std::vector<int64_t> acs_rec[3];
  for (int gi = 0; gi < depth; ++gi) {
    const Level& P = levels[depth - gi];
    const Level& Ch = levels[depth - gi - 1];
    group_pass1_fp<C>(P, Ch, recon, nbr_p,
                      gi > 0 ? &grand : nullptr, pp,
                      gi + 1 < depth, g);
    grand.swap(g.counts_c);
    nbr_p.mask.swap(g.nbr_c.mask);
    nbr_p.idx.swap(g.nbr_c.idx);

    for (int s = 0; s < 3; ++s) {
      int64_t m = g.npairs[s];
      q.resize(m * C);
      rcd_zrow(dec, zrow_ctx, q.data(), m, C);
      acs_rec[s].resize(m * C);
      const std::vector<int64_t>& pr = g.acs_pred[s];
      for (int64_t i = 0; i < m; ++i)
        for (int c = 0; c < C; ++c)
          acs_rec[s][i * C + c] =
              pr[i * C + c] + dequant_fp1(q[i * C + c], steps[c]);
    }
    group_pass2_fp<C>(P, Ch, recon, acs_rec, g.recon_c);
    recon.swap(g.recon_c);
  }
  for (int64_t i = 0; i < n * C; ++i)
    out_values[i] = (recon[i] + kHalfF) >> kF;
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

extern "C" int raht_encode_fp(
    RcEncoder* enc, uint16_t* zrow_ctx,
    const int64_t* leaf_codes, int64_t n, int depth,
    const int64_t* values, int ncomp,
    const int32_t* steps_q16,
    int64_t t0, int64_t t1,
    int32_t w_self, int32_t w_face, int32_t w_edge) {
  if (ncomp < 1 || ncomp > kMaxComp || n <= 0 || depth < 1) return -1;
  int64_t steps[kMaxComp];
  for (int c = 0; c < ncomp; ++c) steps[c] = steps_q16[c];
  PredParams pp{t0, t1, (double)w_self, (double)w_face, (double)w_edge};
  switch (ncomp) {
    case 1:
      return encode_impl_fp<1>(enc, zrow_ctx, leaf_codes, n, depth,
                               values, steps, pp);
    case 2:
      return encode_impl_fp<2>(enc, zrow_ctx, leaf_codes, n, depth,
                               values, steps, pp);
    default:
      return encode_impl_fp<3>(enc, zrow_ctx, leaf_codes, n, depth,
                               values, steps, pp);
  }
}

extern "C" int raht_decode_fp(
    RcDecoder* dec, uint16_t* zrow_ctx,
    const int64_t* leaf_codes, int64_t n, int depth,
    int64_t* out_values, int ncomp,
    const int32_t* steps_q16,
    int64_t t0, int64_t t1,
    int32_t w_self, int32_t w_face, int32_t w_edge) {
  if (ncomp < 1 || ncomp > kMaxComp || n <= 0 || depth < 1) return -1;
  int64_t steps[kMaxComp];
  for (int c = 0; c < ncomp; ++c) steps[c] = steps_q16[c];
  PredParams pp{t0, t1, (double)w_self, (double)w_face, (double)w_edge};
  switch (ncomp) {
    case 1:
      return decode_impl_fp<1>(dec, zrow_ctx, leaf_codes, n, depth,
                               out_values, steps, pp);
    case 2:
      return decode_impl_fp<2>(dec, zrow_ctx, leaf_codes, n, depth,
                               out_values, steps, pp);
    default:
      return decode_impl_fp<3>(dec, zrow_ctx, leaf_codes, n, depth,
                               out_values, steps, pp);
  }
}

extern "C" int raht_encode_predicted(
    RcEncoder* enc, uint16_t* zrow_ctx,
    const int64_t* leaf_codes, int64_t n, int depth,
    const int64_t* values, int ncomp,
    const int32_t* steps_q16,       // per component
    int64_t t0, int64_t t1,
    int32_t w_self, int32_t w_face, int32_t w_edge) {
  if (ncomp < 1 || ncomp > kMaxComp || n <= 0 || depth < 1) return -1;
  double steps[kMaxComp];
  for (int c = 0; c < ncomp; ++c) steps[c] = (double)steps_q16[c];
  PredParams pp{t0, t1, (double)w_self, (double)w_face, (double)w_edge};
  switch (ncomp) {
    case 1:
      return encode_impl<1>(enc, zrow_ctx, leaf_codes, n, depth, values,
                            steps, pp);
    case 2:
      return encode_impl<2>(enc, zrow_ctx, leaf_codes, n, depth, values,
                            steps, pp);
    default:
      return encode_impl<3>(enc, zrow_ctx, leaf_codes, n, depth, values,
                            steps, pp);
  }
}

extern "C" int raht_decode_predicted(
    RcDecoder* dec, uint16_t* zrow_ctx,
    const int64_t* leaf_codes, int64_t n, int depth,
    int64_t* out_values, int ncomp,
    const int32_t* steps_q16,
    int64_t t0, int64_t t1,
    int32_t w_self, int32_t w_face, int32_t w_edge) {
  if (ncomp < 1 || ncomp > kMaxComp || n <= 0 || depth < 1) return -1;
  double steps[kMaxComp];
  for (int c = 0; c < ncomp; ++c) steps[c] = (double)steps_q16[c];
  PredParams pp{t0, t1, (double)w_self, (double)w_face, (double)w_edge};
  switch (ncomp) {
    case 1:
      return decode_impl<1>(dec, zrow_ctx, leaf_codes, n, depth,
                            out_values, steps, pp);
    case 2:
      return decode_impl<2>(dec, zrow_ctx, leaf_codes, n, depth,
                            out_values, steps, pp);
    default:
      return decode_impl<3>(dec, zrow_ctx, leaf_codes, n, depth,
                            out_values, steps, pp);
  }
}
