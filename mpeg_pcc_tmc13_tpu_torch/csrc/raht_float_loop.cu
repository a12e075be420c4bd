// The float64 predicted RAHT closed loop of the colour brick, for Hopper
// (sm_90a): a truth launch, a prediction launch and an inverse launch a
// level, over the card plan of csrc/raht_fp_plan.cu.
//
// Replaces on the card the numpy passes of ops/raht.py that
// models/attr_raht.py runs for a predicted float RAHT brick (the CLI's
// default colour, last-component prediction on):
//   raht_float_truth   <- forward_predicted's bottom-up
//                         _group_sweep_forward over merge_structure's
//                         sweeps, three sweeps (z, y, x) a level: the
//                         true ACs in coded order, the blocks' DC and
//                         their integer subtree weights,
//   raht_float_predict <- predict_children (parent means, the luma-ratio
//                         test, the per-octant neighbour sums, the
//                         block-skip rule, the child's sqrt weight), the
//                         prediction's _group_sweep_forward and
//                         acs_true - acs_pred,
//   raht_float_inverse <- acs_pred + dequant(q) and _group_sweep_inverse:
//                         the children's reconstruction, the next
//                         level's parents.
// The quantiser (RDOQ, deadzone, LCP) and the zrow coder stay on the
// host between the prediction and the inverse of a level.  The plain
// PyTorch versions are ops/raht_float_device.py's truth_ref, predict_ref
// and inverse_ref.
//
// Numerics.  Every product, sum, quotient and square root is one IEEE
// round-to-nearest double operation in ops/raht.py's order, written with
// the __d*_rn intrinsics, which the compiler never contracts into a
// fused multiply-add, and __dsqrt_rn.  So the kernels equal numpy and
// their plain versions bit for bit.  Butterfly coefficients are
// a = sqrt(w0) / sqrt(w0 + w1), b = sqrt(w1) / sqrt(w0 + w1) of the
// integer weights, as merge_structure caches them.
//
// Design: a thread a parent block (its up to eight children, the seven
// butterflies z (0,1)(2,3)(4,5)(6,7), y over the z outputs, x over the y
// outputs), every channel in turn.  Each level is a few hundred
// thousand blocks at most on a ~1M-point frame, and the host quantiser
// between two launches sets the pace, so the kernels stay plain.
//
// Launcher contract (ops/raht_float_device.py): pointers from torch
// tensors on the caller's current stream, the plan as 7 pointers (gather,
// off_z, off_y, off_x, nbr_idx, nbr_ok, en_base: ops/raht_plan.py's
// float_kernel_plan()); each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long i64;

constexpr int kThreads = 128;
constexpr int kNbr = 18;

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double dsub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double ddiv(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ double dsqrtw(i64 w) {
  return __dsqrt_rn(__ll2double_rn(w));
}

// bit o of entry j: neighbour offset j (ops/raht.py _NBR_OFFSETS) touches
// octant o (its _TOUCH_TABLE)
__host__ __device__ constexpr unsigned nbr_octants(int j) {
  return j == 0 ? 240u : j == 1 ? 15u : j == 2 ? 204u : j == 3 ? 51u
       : j == 4 ? 170u : j == 5 ? 85u : j == 6 ? 192u : j == 7 ? 48u
       : j == 8 ? 12u : j == 9 ? 3u : j == 10 ? 160u : j == 11 ? 80u
       : j == 12 ? 10u : j == 13 ? 5u : j == 14 ? 136u : j == 15 ? 68u
       : j == 16 ? 34u : 17u;
}

// the card plan's tensors a float kernel reads (int64 but the masks,
// which are torch bools)
struct Plan {
  const i64* gather;     // (mp, 8) child row per octant, -1 absent
  const i64* off_z;      // (mp,) the block's first zrow row of a stage
  const i64* off_y;
  const i64* off_x;
  const i64* nbr_idx;    // (mp, 18)
  const bool* nbr_ok;    // (mp, 18)
  const bool* en_base;   // (mp,) 1 + present neighbours >= t1
};

Plan plan_from(const void* const* q) {
  Plan p;
  p.gather = (const i64*)q[0];
  p.off_z = (const i64*)q[1];
  p.off_y = (const i64*)q[2];
  p.off_x = (const i64*)q[3];
  p.nbr_idx = (const i64*)q[4];
  p.nbr_ok = (const bool*)q[5];
  p.en_base = (const bool*)q[6];
  return p;
}

// The 7 butterflies of a block from its children's weights: z as k =
// 0..3, y as 4, 5, x as 6.
struct Coef {
  double a[7], b[7];
  unsigned valid, hi;    // bit k: both present; the lone one is the second
};

__device__ __forceinline__ i64 pair_coef(Coef& cf, int k, i64 w0, i64 w1) {
  if (w0 > 0 && w1 > 0) {
    cf.valid |= 1u << k;
    const double rs = __dsqrt_rn(dadd(__ll2double_rn(w0),
                                      __ll2double_rn(w1)));
    cf.a[k] = ddiv(dsqrtw(w0), rs);
    cf.b[k] = ddiv(dsqrtw(w1), rs);
  } else {
    cf.a[k] = 0.0;
    cf.b[k] = 0.0;
    if (w0 == 0) cf.hi |= 1u << k;
  }
  return w0 + w1;
}

// children's weights w[8] -> coefficients; returns the block's weight
__device__ __forceinline__ i64 coef(const i64 w[8], Coef& cf) {
  cf.valid = 0;
  cf.hi = 0;
  i64 wz[4], wy[2];
#pragma unroll
  for (int s = 0; s < 4; ++s) wz[s] = pair_coef(cf, s, w[2 * s], w[2 * s + 1]);
#pragma unroll
  for (int s = 0; s < 2; ++s)
    wy[s] = pair_coef(cf, 4 + s, wz[2 * s], wz[2 * s + 1]);
  return pair_coef(cf, 6, wy[0], wy[1]);
}

// one forward butterfly: dc = a v0 + b v1, ac = (-b) v0 + a v1; a lone
// child passes through
__device__ __forceinline__ void pair(const Coef& cf, int k, double v0,
                                     double v1, double* out, double* ac) {
  if ((cf.valid >> k) & 1) {
    *out = dadd(dmul(cf.a[k], v0), dmul(cf.b[k], v1));
    *ac = dadd(dmul(-cf.b[k], v0), dmul(cf.a[k], v1));
  } else {
    *out = ((cf.hi >> k) & 1) ? v1 : v0;
    *ac = 0.0;
  }
}

__device__ __forceinline__ double forward(const Coef& cf, const double v[8],
                                          double ac[7]) {
  double vz[4], vy[2], dc;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    pair(cf, s, v[2 * s], v[2 * s + 1], &vz[s], &ac[s]);
#pragma unroll
  for (int s = 0; s < 2; ++s)
    pair(cf, 4 + s, vz[2 * s], vz[2 * s + 1], &vy[s], &ac[4 + s]);
  pair(cf, 6, vy[0], vy[1], &dc, &ac[6]);
  return dc;
}

// one inverse butterfly: v0 = a dc - b ac, v1 = b dc + a ac
__device__ __forceinline__ void unpair(const Coef& cf, int k, double v,
                                       double ac, double* o0, double* o1) {
  if ((cf.valid >> k) & 1) {
    *o0 = dsub(dmul(cf.a[k], v), dmul(cf.b[k], ac));
    *o1 = dadd(dmul(cf.b[k], v), dmul(cf.a[k], ac));
  } else if ((cf.hi >> k) & 1) {
    *o0 = 0.0;
    *o1 = v;
  } else {
    *o0 = v;
    *o1 = 0.0;
  }
}

__device__ __forceinline__ void inverse(const Coef& cf, double dc,
                                        const double ac[7], double v[8]) {
  double vy[2], vz[4];
  unpair(cf, 6, dc, ac[6], &vy[0], &vy[1]);
#pragma unroll
  for (int s = 0; s < 2; ++s)
    unpair(cf, 4 + s, vy[s], ac[4 + s], &vz[2 * s], &vz[2 * s + 1]);
#pragma unroll
  for (int s = 0; s < 4; ++s)
    unpair(cf, s, vz[s], ac[s], &v[2 * s], &v[2 * s + 1]);
}

// zrow row of butterfly k of block m within its stage's rows, or -1 for
// an invalid pair
__device__ __forceinline__ void pair_rows(const Plan& p, const Coef& cf,
                                          i64 m, i64 row[7]) {
  const i64 oz = p.off_z[m], oy = p.off_y[m], ox = p.off_x[m];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int lo = k < 4 ? 0 : (k < 6 ? 4 : 6);
    const i64 off = k < 4 ? oz : (k < 6 ? oy : ox);
    const unsigned before = cf.valid & ((1u << k) - 1) & ~((1u << lo) - 1);
    row[k] = ((cf.valid >> k) & 1) ? off + __popc(before) : -1;
  }
}

// the block's children: rows g[8] (-1 absent) and weights (w_c null: 1)
__device__ __forceinline__ void children(const Plan& p, i64 m,
                                         const i64* __restrict__ w_c,
                                         i64 g[8], i64 w[8]) {
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    g[o] = p.gather[m * 8 + o];
    w[o] = g[o] < 0 ? 0 : (w_c != nullptr ? w_c[g[o]] : 1);
  }
}

__global__ void __launch_bounds__(kThreads)
raht_float_truth_kernel(Plan p, i64 mp, int nc,
                        const double* __restrict__ vals,
                        const i64* __restrict__ w_c,
                        double* __restrict__ dc_out, i64* __restrict__ w_out,
                        double* __restrict__ zo, double* __restrict__ yo,
                        double* __restrict__ xo) {
  const i64 m = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (m >= mp) return;
  i64 g[8], w[8], row[7];
  Coef cf;
  children(p, m, w_c, g, w);
  w_out[m] = coef(w, cf);
  if (vals == nullptr) return;   // the weights alone (the decoder's pass)
  pair_rows(p, cf, m, row);
  double* const outs[7] = {zo, zo, zo, zo, yo, yo, xo};
  for (int c = 0; c < nc; ++c) {
    double v[8], ac[7];
#pragma unroll
    for (int o = 0; o < 8; ++o) v[o] = g[o] >= 0 ? vals[g[o] * nc + c] : 0.0;
    dc_out[m * nc + c] = forward(cf, v, ac);
#pragma unroll
    for (int k = 0; k < 7; ++k)
      if (row[k] >= 0) outs[k][row[k] * nc + c] = ac[k];
  }
}

struct PredictArgs {
  Plan p;
  i64 mp;
  int nc;
  const double* recon_p;   // (mp, nc) parents' reconstruction
  const i64* w_p;          // (mp,) parents' weights
  const i64* w_c;          // (mc,) children's weights, or null: 1
  const i64* g_cnt;        // the coarser plan's cnt_p, or null at the root
  const i64* g_pidx;       // the coarser plan's pidx
  i64 t0;
  double w_self, w_face, w_edge;
  const double* truth[3];  // z, y, x truth rows, or null (decode)
  double* res[3];          // truth - prediction rows (may be truth)
  double* pred[3];         // the prediction's AC rows
};

__global__ void __launch_bounds__(kThreads)
raht_float_predict_kernel(const PredictArgs a) {
  const Plan& p = a.p;
  const i64 m = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (m >= a.mp) return;
  const int nc = a.nc;
  i64 g[8], w[8], row[7];
  Coef cf;
  children(p, m, a.w_c, g, w);
  coef(w, cf);
  pair_rows(p, cf, m, row);
  // block-skip rule: parent count >= t1 (en_base), grandparent's >= t0
  const bool en = p.en_base[m] &&
                  (a.g_cnt == nullptr || a.g_cnt[a.g_pidx[m]] >= a.t0);
  const double sq_m = dsqrtw(a.w_p[m]);
  unsigned keep = 0;
  double ws[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) ws[o] = 0.0;
  if (en) {
    // neighbours whose luma mean v keeps 2 pv < 10 v < 25 pv
    const double pv = ddiv(a.recon_p[m * nc], sq_m);
    const double lo = dmul(2.0, pv), hi = dmul(25.0, pv);
    for (int j = 0; j < kNbr; ++j) {
      if (!p.nbr_ok[m * kNbr + j]) continue;
      const i64 nb = p.nbr_idx[m * kNbr + j];
      const double nv10 = dmul(10.0, ddiv(a.recon_p[nb * nc], dsqrtw(a.w_p[nb])));
      if (nv10 > lo && nv10 < hi) {
        keep |= 1u << j;
        const double wj = j < 6 ? a.w_face : a.w_edge;
#pragma unroll
        for (int o = 0; o < 8; ++o)
          if ((nbr_octants(j) >> o) & 1) ws[o] = dadd(ws[o], wj);
      }
    }
  }
  double sqc[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) sqc[o] = w[o] > 0 ? dsqrtw(w[o]) : 0.0;
  double* const pouts[7] = {a.pred[0], a.pred[0], a.pred[0], a.pred[0],
                            a.pred[1], a.pred[1], a.pred[2]};
  double* const routs[7] = {a.res[0], a.res[0], a.res[0], a.res[0],
                            a.res[1], a.res[1], a.res[2]};
  const double* const tins[7] = {a.truth[0], a.truth[0], a.truth[0],
                                 a.truth[0], a.truth[1], a.truth[1],
                                 a.truth[2]};
  for (int c = 0; c < nc; ++c) {
    double v[8], ac[7];
#pragma unroll
    for (int o = 0; o < 8; ++o) v[o] = 0.0;
    if (en) {
      // per-octant sums of w_j x neighbour mean, j ascending
      double s[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) s[o] = 0.0;
      for (int j = 0; j < kNbr; ++j) {
        if (!((keep >> j) & 1)) continue;
        const i64 nb = p.nbr_idx[m * kNbr + j];
        const double t = dmul(ddiv(a.recon_p[nb * nc + c], dsqrtw(a.w_p[nb])),
                              j < 6 ? a.w_face : a.w_edge);
#pragma unroll
        for (int o = 0; o < 8; ++o)
          if ((nbr_octants(j) >> o) & 1) s[o] = dadd(s[o], t);
      }
      const double base = dmul(ddiv(a.recon_p[m * nc + c], sq_m), a.w_self);
#pragma unroll
      for (int o = 0; o < 8; ++o)
        if (w[o] > 0)
          v[o] = dmul(ddiv(dadd(base, s[o]), dadd(a.w_self, ws[o])), sqc[o]);
    }
    forward(cf, v, ac);
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      if (row[k] < 0) continue;
      const i64 at = row[k] * nc + c;
      pouts[k][at] = ac[k];
      if (tins[k] != nullptr) routs[k][at] = dsub(tins[k][at], ac[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
raht_float_inverse_kernel(Plan p, i64 mp, int nc,
                          const double* __restrict__ recon_p,
                          const i64* __restrict__ w_c,
                          const double* __restrict__ pz,
                          const double* __restrict__ py,
                          const double* __restrict__ px,
                          const double* __restrict__ dz,
                          const double* __restrict__ dy,
                          const double* __restrict__ dx,
                          double* __restrict__ recon_c) {
  const i64 m = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (m >= mp) return;
  i64 g[8], w[8], row[7];
  Coef cf;
  children(p, m, w_c, g, w);
  coef(w, cf);
  pair_rows(p, cf, m, row);
  const double* const pin[7] = {pz, pz, pz, pz, py, py, px};
  const double* const din[7] = {dz, dz, dz, dz, dy, dy, dx};
  for (int c = 0; c < nc; ++c) {
    double ac[7], v[8];
#pragma unroll
    for (int k = 0; k < 7; ++k)
      ac[k] = row[k] >= 0 ? dadd(pin[k][row[k] * nc + c],
                                 din[k][row[k] * nc + c])
                          : 0.0;
    inverse(cf, recon_p[m * nc + c], ac, v);
#pragma unroll
    for (int o = 0; o < 8; ++o)
      if (g[o] >= 0) recon_c[g[o] * nc + c] = v[o];
  }
}

unsigned grid_for(i64 mp) { return (unsigned)((mp + kThreads - 1) / kThreads); }

}  // namespace

// plan: the 7 plan pointers; vals (mc, nc) float64 or null (the weights
// alone: dc, z, y, x unused); w_c (mc,) int64 or null (every weight 1);
// outputs dc (mp, nc), w_p (mp,) and the z, y, x truth rows
extern "C" int raht_float_truth_launch(const void* const* plan, long long mp,
                                       int nc, const void* vals,
                                       const void* w_c, void* dc, void* w_p,
                                       void* z, void* y, void* x,
                                       void* stream) {
  if (mp <= 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  raht_float_truth_kernel<<<grid_for(mp), kThreads, 0,
                            (cudaStream_t)stream>>>(
      plan_from(plan), mp, nc, (const double*)vals, (const i64*)w_c,
      (double*)dc, (i64*)w_p, (double*)z, (double*)y, (double*)x);
  return (int)cudaGetLastError();
}

// g_cnt / g_pidx: the coarser plan's cnt_p and pidx, both null at the
// root; weights: w_self, w_face, w_edge; truth / res / pred: 3 pointers
// each (z, y, x), truth and res null in decode; nbr_octants: 18 bytes,
// which must be the kernel's touch table
extern "C" int raht_float_predict_launch(
    const void* const* plan, long long mp, int nc, const void* recon_p,
    const void* w_p, const void* w_c, const void* g_cnt, const void* g_pidx,
    long long t0, const double* weights, const void* const* truth,
    void* const* res, void* const* pred,
    const unsigned char* nbr_octants_in, void* stream) {
  if (mp <= 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < kNbr; ++j)
    if (nbr_octants_in[j] != nbr_octants(j)) return (int)cudaErrorInvalidValue;
  if ((truth[0] == nullptr) != (res[0] == nullptr) ||
      (g_cnt == nullptr) != (g_pidx == nullptr))
    return (int)cudaErrorInvalidValue;
  PredictArgs a;
  a.p = plan_from(plan);
  a.mp = mp;
  a.nc = nc;
  a.recon_p = (const double*)recon_p;
  a.w_p = (const i64*)w_p;
  a.w_c = (const i64*)w_c;
  a.g_cnt = (const i64*)g_cnt;
  a.g_pidx = (const i64*)g_pidx;
  a.t0 = t0;
  a.w_self = weights[0];
  a.w_face = weights[1];
  a.w_edge = weights[2];
  for (int s = 0; s < 3; ++s) {
    a.truth[s] = (const double*)truth[s];
    a.res[s] = (double*)res[s];
    a.pred[s] = (double*)pred[s];
  }
  raht_float_predict_kernel<<<grid_for(mp), kThreads, 0,
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// pred / deq: 3 pointers each (z, y, x rows); recon_c (mc, nc) out
extern "C" int raht_float_inverse_launch(const void* const* plan,
                                         long long mp, int nc,
                                         const void* recon_p, const void* w_c,
                                         const void* const* pred,
                                         const void* const* deq,
                                         void* recon_c, void* stream) {
  if (mp <= 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  raht_float_inverse_kernel<<<grid_for(mp), kThreads, 0,
                              (cudaStream_t)stream>>>(
      plan_from(plan), mp, nc, (const double*)recon_p, (const i64*)w_c,
      (const double*)pred[0], (const double*)pred[1], (const double*)pred[2],
      (const double*)deq[0], (const double*)deq[1], (const double*)deq[2],
      (double*)recon_c);
  return (int)cudaGetLastError();
}
