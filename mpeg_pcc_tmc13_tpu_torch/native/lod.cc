// Distance-based LoD assignment (reference subsampleByDistance,
// PCCTMC3Common.h:2223-2252 subsample dispatch).
//
// Points (Morton order) are greedily retained into levels of detail:
// level l keeps a point iff no already-retained point of levels <= l
// lies within dist2_l = dist2_base >> (2*l).  Decoder-derivable: both
// sides run this identical serial walk over the decoded positions.
// A power-of-two hash grid with cell ~= sqrt(dist2) makes each check
// a 27-cell probe.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Grid {
  // open addressing: key = cell hash -> linked list head into `next`
  std::vector<int64_t> heads;
  std::vector<int64_t> next;
  uint64_t mask = 0;
  int shift = 0;  // cell size = 1 << shift

  void init(int64_t capacity, int cell_shift) {
    uint64_t cap = 64;
    while (cap < (uint64_t)capacity * 2) cap <<= 1;
    heads.assign(cap, -1);
    next.clear();
    mask = cap - 1;
    shift = cell_shift;
  }

  inline uint64_t slot(int64_t cx, int64_t cy, int64_t cz) const {
    uint64_t h = (uint64_t)cx * 0x8DA6B343u + (uint64_t)cy * 0xD8163841u
                 + (uint64_t)cz * 0xCB1AB31Fu;
    return (h * 0x9E3779B97F4A7C15ull >> 13) & mask;
  }

  // any stored point within dist2 of p?  `pts` is the flat (n,3) array
  inline bool near(const int64_t* pts, const int64_t* p,
                   int64_t dist2) const {
    int64_t cx = p[0] >> shift, cy = p[1] >> shift, cz = p[2] >> shift;
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          uint64_t s = slot(cx + dx, cy + dy, cz + dz);
          for (int64_t i = heads[s]; i >= 0; i = next[i]) {
            // note: hash collisions may chain foreign cells; the
            // distance test keeps the result exact
            int64_t ddx = pts[i * 3] - p[0];
            int64_t ddy = pts[i * 3 + 1] - p[1];
            int64_t ddz = pts[i * 3 + 2] - p[2];
            if (ddx * ddx + ddy * ddy + ddz * ddz < dist2) return true;
          }
        }
    return false;
  }
};

}  // namespace

extern "C" {

// xyz: (n,3) int64 in Morton order; levels_out: (n,) uint8.
// dist2_base: squared retain distance of the COARSEST level;
// each finer level quarters it.  Returns number of levels used.
int32_t lod_assign_dist2(const int64_t* xyz, int64_t n,
                         int64_t dist2_base, int32_t num_levels,
                         uint8_t* levels_out) {
  if (n == 0) return 0;
  std::memset(levels_out, 0xFF, (size_t)n);  // 0xFF = unassigned
  // retained points across levels share one array of indices; each
  // level gets a fresh grid sized to its cell width
  std::vector<int64_t> retained;
  retained.reserve(n);

  int64_t d2 = dist2_base;
  for (int32_t l = 0; l + 1 < num_levels && d2 > 0; ++l, d2 >>= 2) {
    int cell_shift = 0;
    while (((int64_t)1 << (2 * cell_shift)) < d2) cell_shift++;
    Grid grid;
    grid.init(n, cell_shift);
    grid.next.assign(n, -1);   // chain storage indexed by point id
    auto ins = [&](int64_t idx) {
      const int64_t* p = &xyz[idx * 3];
      uint64_t s = grid.slot(p[0] >> grid.shift, p[1] >> grid.shift,
                             p[2] >> grid.shift);
      grid.next[idx] = grid.heads[s];
      grid.heads[s] = idx;
    };
    // coarser retained points seed every finer grid
    for (int64_t idx : retained) ins(idx);
    for (int64_t i = 0; i < n; ++i) {
      if (levels_out[i] != 0xFF) continue;
      if (!grid.near(xyz, &xyz[i * 3], d2)) {
        levels_out[i] = (uint8_t)l;
        retained.push_back(i);
        ins(i);
      }
    }

  }
  // everything unassigned lands in the finest level
  for (int64_t i = 0; i < n; ++i)
    if (levels_out[i] == 0xFF) levels_out[i] = (uint8_t)(num_levels - 1);
  return num_levels;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// float-domain Morton-window kNN (recolouring forward/backward search,
// ops/recolour.py _knn_float): candidates come from a +-window around
// the query's insertion rank; distances in the true float domain.
// Tie order matches the numpy stable argsort: among equal distances
// the lower candidate rank wins (strict < insertion).
// ---------------------------------------------------------------------------

extern "C" {

void knn_float(const int64_t* sorted_pos,    // (ns,3) in code order
               const int64_t* sorted_codes,  // (ns)
               const double* q,              // (nq,3)
               const int64_t* q_codes,       // morton of clamped round(q)
               int64_t ns, int64_t nq, int k, int window,
               int64_t* out_idx,             // (nq,k) ranks in sorted order
               double* out_d2) {
  if (ns <= 0 || nq <= 0 || k <= 0) return;
  std::vector<double> best_d(k);
  std::vector<int64_t> best_i(k);
  for (int64_t i = 0; i < nq; ++i) {
    // lower_bound on codes
    int64_t lo = 0, hi = ns;
    const int64_t qc = q_codes[i];
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (sorted_codes[mid] < qc) lo = mid + 1; else hi = mid;
    }
    int64_t c0 = lo - window;
    int64_t c1 = lo + window;     // exclusive
    if (c0 < 0) c0 = 0;
    if (c1 > ns) c1 = ns;
    if (c1 - c0 < k) {            // widen at the edges like np.clip
      c0 = lo - window < 0 ? 0 : lo - window;
      c1 = c0 + 2 * window;
      if (c1 > ns) { c1 = ns; c0 = c1 - 2 * window; if (c0 < 0) c0 = 0; }
    }
    int filled = 0;
    const double qx = q[i * 3], qy = q[i * 3 + 1], qz = q[i * 3 + 2];
    for (int64_t c = c0; c < c1; ++c) {
      double dx = (double)sorted_pos[c * 3] - qx;
      double dy = (double)sorted_pos[c * 3 + 1] - qy;
      double dz = (double)sorted_pos[c * 3 + 2] - qz;
      double d2 = dx * dx + dy * dy + dz * dz;
      if (filled < k) {
        int j = filled++;
        while (j > 0 && best_d[j - 1] > d2) {
          best_d[j] = best_d[j - 1];
          best_i[j] = best_i[j - 1];
          --j;
        }
        best_d[j] = d2;
        best_i[j] = c;
      } else if (d2 < best_d[k - 1]) {
        int j = k - 1;
        while (j > 0 && best_d[j - 1] > d2) {
          best_d[j] = best_d[j - 1];
          best_i[j] = best_i[j - 1];
          --j;
        }
        best_d[j] = d2;
        best_i[j] = c;
      }
    }
    for (int j = 0; j < k; ++j) {
      int jj = j < filled ? j : (filled ? filled - 1 : 0);
      out_idx[i * k + j] = filled ? best_i[jj] : 0;
      out_d2[i * k + j] = filled ? best_d[jj] : 0.0;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// integer-domain LoD predictor search (ops/lod.py knn_predictors):
// per query, candidates are the Morton-window ranks
// [max(0, ins-window), min(nr, ins+window)) of the level's sorted
// candidate array (identical to the numpy clip + adjacent-duplicate
// suppression), optionally truncated at own_rank for the intra-LoD
// chain.  Top-k by squared distance, ties to the lower rank (stable).
// Weights mirror the numpy Q16 law: floor(inv/s * 65536 + 0.5) with
// inv = 1/max(d2, 0.25) and s the row sum (0 -> 1).
// ---------------------------------------------------------------------------

extern "C" {

void lod_knn_topk(const int64_t* r_codes, const int64_t* r_pos,
                  const int64_t* r_map, int64_t nr,
                  const int64_t* q_codes, const int64_t* q_pos,
                  int64_t nq, const int64_t* own_rank,
                  int k, int window,
                  int64_t* out_nbr, int64_t* out_w) {
  if (nq <= 0 || k <= 0) return;
  std::vector<int64_t> best_d(k), best_i(k);
  for (int64_t i = 0; i < nq; ++i) {
    int64_t lo = 0, hi = nr;
    const int64_t qc = q_codes[i];
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (r_codes[mid] < qc) lo = mid + 1; else hi = mid;
    }
    int64_t c0 = lo - window < 0 ? 0 : lo - window;
    int64_t c1 = lo + window > nr ? nr : lo + window;
    if (own_rank && own_rank[i] < c1) c1 = own_rank[i];
    int filled = 0;
    const int64_t qx = q_pos[i * 3], qy = q_pos[i * 3 + 1],
                  qz = q_pos[i * 3 + 2];
    for (int64_t c = c0; c < c1; ++c) {
      int64_t dx = r_pos[c * 3] - qx;
      int64_t dy = r_pos[c * 3 + 1] - qy;
      int64_t dz = r_pos[c * 3 + 2] - qz;
      int64_t d2 = dx * dx + dy * dy + dz * dz;
      if (filled < k) {
        int j = filled++;
        while (j > 0 && best_d[j - 1] > d2) {
          best_d[j] = best_d[j - 1];
          best_i[j] = best_i[j - 1];
          --j;
        }
        best_d[j] = d2;
        best_i[j] = c;
      } else if (d2 < best_d[k - 1]) {
        int j = k - 1;
        while (j > 0 && best_d[j - 1] > d2) {
          best_d[j] = best_d[j - 1];
          best_i[j] = best_i[j - 1];
          --j;
        }
        best_d[j] = d2;
        best_i[j] = c;
      }
    }
    double inv[16];
    double s = 0.0;
    for (int j = 0; j < k; ++j) {
      if (j < filled) {
        double dd = (double)best_d[j];
        inv[j] = 1.0 / (dd > 0.25 ? dd : 0.25);
      } else {
        inv[j] = 0.0;
      }
      s += inv[j];
    }
    if (s == 0.0) s = 1.0;
    for (int j = 0; j < k; ++j) {
      out_nbr[i * k + j] = j < filled ? r_map[best_i[j]] : -1;
      out_w[i * k + j] =
          (int64_t)std::floor(inv[j] / s * 65536.0 + 0.5);
    }
  }
}

}  // extern "C"
