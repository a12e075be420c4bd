// The fixed-point RAHT closed loop of the attribute codec, for Hopper
// (sm_90a): one launch a truth level and one a coded group.
//
// Replaces the jitted XLA level steps of
// mpeg_pcc_tmc13_tpu/ops/raht_fp_device.py (B6):
//   raht_fp_truth_level <- _truth_level (:335): _gather_blocks, the
//                          forward network (_fwd_block :159), _compact,
//   raht_fp_group       <- _enc_group (:342) and _dec_group (:359):
//                          _predict (:208), the prediction's forward
//                          network, _quant/_dequant (:258, :266), the
//                          inverse network (_inv_block :185) and the
//                          scatter of _inverse_group_pure (:372).
// Their plain PyTorch versions are ops/raht_fp_device.py's
// _truth_level_ref, _enc_group_ref and _dec_group_ref, which these equal
// bit for bit (every lane is int64).
//
// What bounds them on an H100: memory.  A group reads its plan (~420 B a
// parent block as the plan's int64 and bool tensors lie: gathers,
// butterfly coefficients and masks, 18 neighbour rows, scales), the
// parents' reconstruction and the truth or q rows, and writes the q rows,
// the children's reconstruction and counts; the plain version runs ~100
// launches a group over (mp, 18, C) int64 intermediates.  Here one thread
// takes one parent block through the whole step with its values in
// registers, channel by channel (the butterfly and the prediction treat
// channels independently once the keep mask, read from channel 0, is
// known), so nothing but the step's inputs and outputs touches memory:
//
// * The parents' Q13 means pf = floor((recon << 15) / sw_p) of the
//   block and its kept neighbours.  Recomputing a neighbour's mean costs
//   an int64 division (~70 instructions), 18 a channel; so a group also
//   writes its children's means (the next group's parents: plan g-1's
//   sw_p is plan g's sw_c, row for row) and the next launch reads them.
//   Only the first group, whose parents are the roots, and a group
//   called alone (the public _enc_group/_dec_group) compute them per
//   read: there is no earlier launch to take them from, and the roots
//   are few.
// * The first group also quantises (encode) or dequantises (decode) the
//   roots, and the last decode group writes (v + HALF) >> F: the device
//   loop is exactly these launches.
// * The q and truth rows are read and written in zrow order through the
//   per-block row offsets (off_z/off_y/off_x: the valid pairs of the
//   earlier blocks, ops/raht_fp_device.py:row_offsets, computed once a
//   frame), so there is no compaction pass.
//
// Numerics.  Products and sums go through uint64 (they wrap as torch's
// int64 does; signed overflow is undefined in C++), shifts of a signed
// value are arithmetic, and floordiv corrects C++'s truncating division
// toward -infinity, as torch.div(..., rounding_mode="floor") rounds.
// No floating point anywhere.
//
// Launcher contract (ops/raht_fp_device.py): pointers from torch tensors
// on the caller's current stream, the plan as an array of 22 pointers in
// the order of kernel_plan() (the Plan struct's); each launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 128;
constexpr int QA = 15;
constexpr i64 QAH = 1LL << 14;
constexpr int F = 13;
constexpr i64 HALF = 1LL << 12;
constexpr int kPlanKeys = 22;
constexpr int kNbr = 18;

__device__ __forceinline__ i64 mul(i64 a, i64 b) {
  return (i64)((u64)a * (u64)b);
}
__device__ __forceinline__ i64 add(i64 a, i64 b) {
  return (i64)((u64)a + (u64)b);
}
__device__ __forceinline__ i64 sub(i64 a, i64 b) {
  return (i64)((u64)a - (u64)b);
}
__device__ __forceinline__ i64 neg(i64 a) { return (i64)(0ULL - (u64)a); }
__device__ __forceinline__ i64 shl(i64 a, int s) {
  return (i64)((u64)a << s);
}
// (x + QAH) >> QA, arithmetic
__device__ __forceinline__ i64 rnd(i64 x) { return add(x, QAH) >> QA; }

// floor(a / b), b != 0 (torch.div(..., rounding_mode="floor"))
__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  if (b == -1) return neg(a);
  i64 q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// _quant / _dequant of one value with step st
__device__ __forceinline__ i64 quant(i64 res, i64 st) {
  i64 a = res < 0 ? neg(res) : res;
  i64 q = floordiv(add(mul(24, a), st), mul(3, st));
  return res < 0 ? neg(q) : q;
}
__device__ __forceinline__ i64 dequant(i64 q, i64 st) {
  i64 a = q < 0 ? neg(q) : q;
  i64 d = add(mul(a, st), 4) >> 3;
  return q < 0 ? neg(d) : d;
}

// The plan of a group as plans_to_torch lays it out, with the row
// offsets (int64 except the masks, which are torch bools: one byte each).
struct Plan {
  const i64* gather;        // (mp, 8) child row per octant, -1 absent
  const i64* az; const i64* bz; const bool* vz; const i64* sz;   // (mp, 4)
  const i64* ay; const i64* by; const bool* vy; const i64* sy;   // (mp, 2)
  const i64* ax; const i64* bx; const bool* vx; const i64* sx;   // (mp,)
  const i64* off_z; const i64* off_y; const i64* off_x;          // (mp,)
  const i64* sw_p;          // (mp,) Q15 sqrt of the parent weight
  const i64* sw_c;          // (mc,) Q15 sqrt of the child weight
  const i64* nbr_idx;       // (mp, 18)
  const bool* nbr_ok;       // (mp, 18)
  const bool* en_base;      // (mp,)
  const i64* cnt_p;         // (mp,)
};

// The 7 butterflies of a block: z (0,1)(2,3)(4,5)(6,7) as k = 0..3, y
// over the z outputs as k = 4, 5, x over the y outputs as k = 6.
struct Coef {
  i64 a[7], b[7];
  unsigned valid, hi;       // bit k: both present; the lone one is hi
};

__device__ __forceinline__ Coef load_coef(const Plan& p, i64 m) {
  Coef cf;
  cf.valid = 0;
  cf.hi = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    cf.a[s] = p.az[m * 4 + s];
    cf.b[s] = p.bz[m * 4 + s];
    cf.valid |= (unsigned)p.vz[m * 4 + s] << s;
    cf.hi |= (unsigned)(p.sz[m * 4 + s] == 1) << s;
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    cf.a[4 + s] = p.ay[m * 2 + s];
    cf.b[4 + s] = p.by[m * 2 + s];
    cf.valid |= (unsigned)p.vy[m * 2 + s] << (4 + s);
    cf.hi |= (unsigned)(p.sy[m * 2 + s] == 1) << (4 + s);
  }
  cf.a[6] = p.ax[m];
  cf.b[6] = p.bx[m];
  cf.valid |= (unsigned)p.vx[m] << 6;
  cf.hi |= (unsigned)(p.sx[m] == 1) << 6;
  return cf;
}

// one forward butterfly: (passed value, AC); a lone child passes through
__device__ __forceinline__ void pair(const Coef& cf, int k, i64 v0, i64 v1,
                                     i64* out, i64* ac) {
  if ((cf.valid >> k) & 1) {
    *out = rnd(add(mul(cf.a[k], v0), mul(cf.b[k], v1)));
    *ac = rnd(sub(mul(cf.a[k], v1), mul(cf.b[k], v0)));
  } else {
    *out = ((cf.hi >> k) & 1) ? v1 : v0;
    *ac = 0;
  }
}

// the forward network of one channel (_fwd_block): v[8] -> dc, ac[7]
__device__ __forceinline__ i64 forward(const Coef& cf, const i64 v[8],
                                       i64 ac[7]) {
  i64 vz[4], vy[2], dc;
#pragma unroll
  for (int s = 0; s < 4; ++s) pair(cf, s, v[2 * s], v[2 * s + 1], &vz[s],
                                   &ac[s]);
#pragma unroll
  for (int s = 0; s < 2; ++s) pair(cf, 4 + s, vz[2 * s], vz[2 * s + 1],
                                   &vy[s], &ac[4 + s]);
  pair(cf, 6, vy[0], vy[1], &dc, &ac[6]);
  return dc;
}

// one inverse butterfly (_inv_block's unstage)
__device__ __forceinline__ void unpair(const Coef& cf, int k, i64 v, i64 ac,
                                       i64* o0, i64* o1) {
  if ((cf.valid >> k) & 1) {
    *o0 = rnd(sub(mul(cf.a[k], v), mul(cf.b[k], ac)));
    *o1 = rnd(add(mul(cf.b[k], v), mul(cf.a[k], ac)));
  } else if ((cf.hi >> k) & 1) {
    *o0 = 0;
    *o1 = v;
  } else {
    *o0 = v;
    *o1 = 0;
  }
}

__device__ __forceinline__ void inverse(const Coef& cf, i64 dc,
                                        const i64 ac[7], i64 v[8]) {
  i64 vy[2], vz[4];
  unpair(cf, 6, dc, ac[6], &vy[0], &vy[1]);
#pragma unroll
  for (int s = 0; s < 2; ++s) unpair(cf, 4 + s, vy[s], ac[4 + s], &vz[2 * s],
                                     &vz[2 * s + 1]);
#pragma unroll
  for (int s = 0; s < 4; ++s) unpair(cf, s, vz[s], ac[s], &v[2 * s],
                                     &v[2 * s + 1]);
}

// zrow row of butterfly k of block m, or -1 for an invalid pair: the
// stage's row offset plus the valid pairs before k in the same stage
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

__global__ void __launch_bounds__(kThreads)
raht_fp_truth_level_kernel(Plan p, i64 mp, int nc,
                           const i64* __restrict__ vals, int shift,
                           i64* __restrict__ dc_out, i64* __restrict__ zo,
                           i64* __restrict__ yo, i64* __restrict__ xo) {
  const i64 m = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (m >= mp) return;
  const Coef cf = load_coef(p, m);
  i64 g[8], row[7];
#pragma unroll
  for (int o = 0; o < 8; ++o) g[o] = p.gather[m * 8 + o];
  pair_rows(p, cf, m, row);
  i64* const outs[7] = {zo, zo, zo, zo, yo, yo, xo};
  for (int c = 0; c < nc; ++c) {
    i64 v[8], ac[7];
#pragma unroll
    for (int o = 0; o < 8; ++o)
      v[o] = g[o] >= 0 ? shl(vals[g[o] * nc + c], shift) : 0;
    dc_out[m * nc + c] = forward(cf, v, ac);
#pragma unroll
    for (int k = 0; k < 7; ++k)
      if (row[k] >= 0) outs[k][row[k] * nc + c] = ac[k];
  }
}

enum : int {
  kDecode = 1,       // q rows in; else truth rows in, q rows out
  kRoot = 2,         // the parents are the roots: quantise / dequantise
  kFinal = 4,        // write (v + HALF) >> F
  kHaveGrand = 8,    // gate on the grandparent counts
  kQ32 = 16,         // q rows out as int32 (else int64)
};

struct GroupArgs {
  Plan p;
  i64 mp;
  int nc;
  int mode;
  // encode: the parents' reconstruction (root: the roots' DC truth);
  // decode: the same, or null at the root
  const i64* recon_p;
  const i64* pf_p;          // (mp, nc) parents' Q13 means, or null
  const i64* grand_p;       // (mp,) grandparent counts
  const i64* steps;         // (nc,)
  const i64* rows_in[3];    // z, y, x: truth (encode) or q rows (decode)
  const i64* q_root_in;     // decode at the root: the roots' q rows
  void* q_out[3];           // encode: z, y, x q rows
  void* q_root_out;         // encode at the root: the roots' q rows
  i64* recon_c;             // (mc, nc)
  i64* pf_c;                // (mc, nc) children's Q13 means, or null
  i64* cnt_c;               // (mc,) next group's grandparent counts
  i64 t0, w_self, w_face, w_edge;
  unsigned char nbr_octants[kNbr];   // bit o: offset j touches octant o
};

// the parent reconstruction of row r, channel c
__device__ __forceinline__ i64 parent_recon(const GroupArgs& a, i64 r, int c) {
  const i64 st = a.steps[c];
  if (!(a.mode & kRoot)) return a.recon_p[r * a.nc + c];
  if (a.mode & kDecode) return dequant(a.q_root_in[r * a.nc + c], st);
  return dequant(quant(a.recon_p[r * a.nc + c], st), st);
}

// the parent Q13 mean of row r, channel c
__device__ __forceinline__ i64 parent_mean(const GroupArgs& a, i64 r, int c) {
  if (a.pf_p) return a.pf_p[r * a.nc + c];
  return floordiv(shl(parent_recon(a, r, c), QA), a.p.sw_p[r]);
}

__device__ __forceinline__ void store_q(const GroupArgs& a, void* base,
                                        i64 idx, i64 q) {
  if (a.mode & kQ32)
    ((int*)base)[idx] = (int)q;
  else
    ((i64*)base)[idx] = q;
}

__global__ void __launch_bounds__(kThreads)
raht_fp_group_kernel(const GroupArgs a) {
  const i64 m = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (m >= a.mp) return;
  const Plan& p = a.p;
  const int nc = a.nc;
  const Coef cf = load_coef(p, m);
  i64 g[8], row[7];
#pragma unroll
  for (int o = 0; o < 8; ++o) g[o] = p.gather[m * 8 + o];
  pair_rows(p, cf, m, row);

  // the keep mask from channel 0 of the kept neighbours' means
  const i64 pv = parent_mean(a, m, 0);
  unsigned keep = 0;
  for (int j = 0; j < kNbr; ++j) {
    if (!p.nbr_ok[m * kNbr + j]) continue;
    const i64 nl = mul(10, parent_mean(a, p.nbr_idx[m * kNbr + j], 0));
    if (nl > mul(2, pv) && nl < mul(25, pv)) keep |= 1u << j;
  }
  bool en = p.en_base[m];
  if (a.mode & kHaveGrand) en = en && a.grand_p[m] >= a.t0;
  // per octant: w_self + the weights of the kept offsets touching it
  i64 wsum[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) wsum[o] = a.w_self;
  for (int j = 0; j < kNbr; ++j) {
    if (!((keep >> j) & 1)) continue;
    const i64 wj = j < 6 ? a.w_face : a.w_edge;
#pragma unroll
    for (int o = 0; o < 8; ++o)
      if ((a.nbr_octants[j] >> o) & 1) wsum[o] = add(wsum[o], wj);
  }

  for (int c = 0; c < nc; ++c) {
    const i64 st = a.steps[c];
    // prediction of each present child (_predict)
    i64 s[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) s[o] = 0;
    for (int j = 0; j < kNbr; ++j) {
      if (!((keep >> j) & 1)) continue;
      const i64 t = mul(parent_mean(a, p.nbr_idx[m * kNbr + j], c),
                        j < 6 ? a.w_face : a.w_edge);
#pragma unroll
      for (int o = 0; o < 8; ++o)
        if ((a.nbr_octants[j] >> o) & 1) s[o] = add(s[o], t);
    }
    const i64 self = mul(parent_mean(a, m, c), a.w_self);
    i64 pred[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      pred[o] = 0;
      if (g[o] >= 0 && en) {
        const i64 pm = floordiv(add(self, s[o]), wsum[o]);
        pred[o] = rnd(mul(pm, p.sw_c[g[o]]));
      }
    }
    // its forward network, then the coded ACs
    i64 pac[7], rec[7];
    forward(cf, pred, pac);
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      rec[k] = 0;
      if (row[k] < 0) continue;
      const int stage = k < 4 ? 0 : (k < 6 ? 1 : 2);
      const i64 idx = row[k] * nc + c;
      i64 q;
      if (a.mode & kDecode) {
        q = a.rows_in[stage][idx];
      } else {
        q = quant(sub(a.rows_in[stage][idx], pac[k]), st);
        store_q(a, a.q_out[stage], idx, q);
      }
      rec[k] = add(pac[k], dequant(q, st));
    }
    // the inverse network from the parent's reconstruction
    const i64 dc = parent_recon(a, m, c);
    if ((a.mode & (kRoot | kDecode)) == kRoot)
      store_q(a, a.q_root_out, m * nc + c, quant(a.recon_p[m * nc + c], st));
    i64 v[8];
    inverse(cf, dc, rec, v);
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      if (g[o] < 0) continue;
      const i64 i = g[o] * nc + c;
      a.recon_c[i] = (a.mode & kFinal) ? add(v[o], HALF) >> F : v[o];
      if (a.pf_c) a.pf_c[i] = floordiv(shl(v[o], QA), p.sw_c[g[o]]);
    }
  }
  const i64 cnt = p.cnt_p[m];
#pragma unroll
  for (int o = 0; o < 8; ++o)
    if (g[o] >= 0) a.cnt_c[g[o]] = cnt;
}

Plan plan_from(const void* const* ptrs) {
  Plan p;
  const void** dst = (const void**)&p;
  for (int k = 0; k < kPlanKeys; ++k) dst[k] = ptrs[k];
  return p;
}

unsigned grid_for(i64 mp) {
  return (unsigned)((mp + kThreads - 1) / kThreads);
}

}  // namespace

static_assert(sizeof(Plan) == kPlanKeys * sizeof(void*),
              "Plan holds exactly the launcher's pointer array");

// plan: kPlanKeys pointers (kernel_plan()); vals (mc, nc) shifted left
// by `shift` as they are read; outputs dc (mp, nc) and the z, y, x AC rows
extern "C" int raht_fp_truth_level_launch(const void* const* plan, long long mp,
                                          int nc, const void* vals, int shift,
                                          void* dc, void* z, void* y, void* x,
                                          void* stream) {
  if (mp <= 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  raht_fp_truth_level_kernel<<<grid_for(mp), kThreads, 0,
                               (cudaStream_t)stream>>>(
      plan_from(plan), mp, nc, (const i64*)vals, shift, (i64*)dc, (i64*)z,
      (i64*)y, (i64*)x);
  return (int)cudaGetLastError();
}

// rows_in / q_out: 3 pointers each (z, y, x); ints: t0, w_self, w_face,
// w_edge; nbr_octants: 18 bytes
extern "C" int raht_fp_group_launch(
    const void* const* plan, long long mp, int nc, int mode,
    const void* recon_p, const void* pf_p, const void* grand_p,
    const void* steps, const void* const* rows_in, const void* q_root_in,
    void* const* q_out, void* q_root_out, void* recon_c, void* pf_c,
    void* cnt_c, const long long* ints, const unsigned char* nbr_octants,
    void* stream) {
  if (mp <= 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  GroupArgs a;
  a.p = plan_from(plan);
  a.mp = mp;
  a.nc = nc;
  a.mode = mode;
  a.recon_p = (const i64*)recon_p;
  a.pf_p = (const i64*)pf_p;
  a.grand_p = (const i64*)grand_p;
  a.steps = (const i64*)steps;
  for (int k = 0; k < 3; ++k) {
    a.rows_in[k] = (const i64*)rows_in[k];
    a.q_out[k] = q_out[k];
  }
  a.q_root_in = (const i64*)q_root_in;
  a.q_root_out = q_root_out;
  a.recon_c = (i64*)recon_c;
  a.pf_c = (i64*)pf_c;
  a.cnt_c = (i64*)cnt_c;
  a.t0 = ints[0];
  a.w_self = ints[1];
  a.w_face = ints[2];
  a.w_edge = ints[3];
  for (int j = 0; j < kNbr; ++j) a.nbr_octants[j] = nbr_octants[j];
  raht_fp_group_kernel<<<grid_for(mp), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
