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
// What bounds them on an H100: memory.  A group reads its plan (442 B a
// parent block as the plan's int64 and bool tensors lie: gathers,
// butterfly coefficients and masks, 18 neighbour rows, scales), the
// parents' means and reconstruction and the truth or q rows, and writes
// the q rows, the children's reconstruction, means and counts.  The
// truth kernel takes a thread a parent block straight from global memory
// (0.50-0.52 of its byte bound).  The group kernel's first design did
// the same and stood at 0.137 of its bound: ~23 int64 divisions a
// channel through the software divide routine behind divergent tests,
// every plan load of a warp touching 32 rows, each neighbour's means
// read 1 + C times, eight int64 arrays live across the channel loop.
// This design answers each:
//
// * Divisions.  Every divisor is positive: 3 st (a channel's step), the
//   prediction's weight sum (w_self plus at most six neighbour weights),
//   the Q15 square roots sw_p and sw_c.  floor(a / d) is taken as
//   q = floor(fl(fl(a) * fl(1 / d))) (round-to-nearest FP64, no FMA),
//   then one step against the remainder a - q d.  Range argument: for
//   1 <= d <= 2^51 and |a| <= 2^51 (kFastLim) the conversions are exact,
//   fl(1 / d) and the product each err by at most 2^-53 relative, so the
//   FP64 quotient is within |a / d| 2^-52 (1 + 2^-53) < 1 of a / d; its
//   floor is floor(a / d) or one off either way, the remainder lies in
//   [-d, 2d), |q d| <= |a| + d < 2^53 does not wrap, and one step
//   (q - 1 when the remainder is negative, q + 1 when it is >= d) is
//   exact.  Negative numerators take the same path: floor, as
//   torch.div(..., rounding_mode="floor").  Every other numerator or
//   divisor (values that wrapped, custom weights) takes the general path,
//   the first design's floordiv on int64.  The reciprocals are taken once:
//   a channel's 1 / (3 st) per thread, the children's 1 / sw_c in the
//   tile prologue, 1 / wsum from a table of 1 / d for d < 64 (a weight sum
//   of the default weights is at most 21).
// * Staged plan tiles.  A persistent grid of CTAs walks tiles of kGT = 32
//   consecutive parent blocks.  The tile's rows of each plan tensor it
//   reads are one contiguous run, copied into one shared-memory plan
//   buffer with 16-byte cp.async by all threads (a ragged last tile
//   zero-fills) as soon as the tile before has been computed.  A ring of
//   two buffers, the next tile's plan copied during this tile's work,
//   measured 3-4% slower over the bench cloud's 22 groups
//   (scripts/kernel_turns.py, in turns on one H100): four CTAs share an
//   SM (registers bound them), so the others' work covers the copy, and
//   a second buffer only costs shared memory.  sw_c is indexed by child
//   and gathered with the means; sw_p is read only where a mean is
//   computed.
// * Means read once.  The tile's 18 neighbour rows and its own row of
//   parent means (neighbours the planner never marks skipped) are
//   gathered by cp.async into shared memory, W <= 4 channels at a time
//   with adjacent threads on adjacent channels of a row, together with
//   the children's sw_c and (C <= 4) the tile's input rows: one wait
//   covers them.  Every read is then from shared memory: the keep mask
//   (channel 0) once a block in the prologue, the prediction's sums per
//   channel.  With C > 4 each further window of channels gathers its
//   means again and reads its input rows from global memory.  The first
//   group and a group called alone compute each mean (one division) as
//   they gather it.
// * Registers.  A thread takes one (parent block, channel): blockDim is
//   kGT W, so the prediction's eight sums, the butterflies and the
//   outputs are one channel's, and the neighbour-to-octant sums are
//   unrolled over the fixed touch table (nbr_octants()).
//
// Numerics.  Products and sums go through uint64 (they wrap as torch's
// int64 does; signed overflow is undefined in C++), shifts of a signed
// value are arithmetic, and floordiv corrects C++'s truncating division
// toward -infinity, as torch.div(..., rounding_mode="floor") rounds.
//
// Launcher contract (ops/raht_fp_device.py): pointers from torch tensors
// on the caller's current stream, the plan as an array of 22 pointers in
// the order of ops/raht_plan.py's kernel_plan() (the Plan struct's), the group's staged plan
// tensors 16-byte aligned; each launcher returns cudaGetLastError().

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

// _dequant of one value with step st (quant_f below quantises)
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
  int win;                  // channels a window: min(nc, kGMaxW)
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
  u64* stats;               // (2,): fast and general divisions, or null
  i64 t0, w_self, w_face, w_edge;
};

// ---- the divisions -----------------------------------------------------

constexpr i64 kFastLim = 1LL << 51;   // the fast division's |a| and d

// 1 / d for the fast division when 1 <= d <= 2^51, else 0 (general path)
__device__ __forceinline__ double fast_rcp(i64 d) {
  return (d >= 1 && d <= kFastLim) ? __drcp_rn(__ll2double_rn(d)) : 0.0;
}

struct DivCount {
  unsigned fast, general;
};

// floor(a / d), d >= 1, r = fast_rcp(d): the FP64 quotient and one
// remainder step when |a| <= 2^51 (the header's range argument), else
// floordiv on int64.  kFastOnly (the instruction-count kernels only)
// compiles the fast path alone.
template <bool kFastOnly = false>
__device__ __forceinline__ i64 fdiv(i64 a, i64 d, double r, DivCount& n) {
  if (r != 0.0 && a >= -kFastLim && a <= kFastLim) {
    ++n.fast;
    i64 q = __double2ll_rd(__dmul_rn(__ll2double_rn(a), r));
    const i64 rem = a - q * d;
    if (rem < 0)
      --q;
    else if (rem >= d)
      ++q;
    return q;
  }
  if (kFastOnly) return 0;
  ++n.general;
  return floordiv(a, d);
}

template <bool kFastOnly = false>
__device__ __forceinline__ i64 quant_f(i64 res, i64 st, i64 d3, double r3,
                                       DivCount& n) {
  const i64 a = res < 0 ? neg(res) : res;
  const i64 q = fdiv<kFastOnly>(add(mul(24, a), st), d3, r3, n);
  return res < 0 ? neg(q) : q;
}

// bit o: neighbour offset j touches octant o (ops/raht_plan.py
// NBR_OCTANTS; the launcher checks the caller's table against it)
__host__ __device__ constexpr unsigned nbr_octants(int j) {
  return j == 0 ? 240u : j == 1 ? 15u : j == 2 ? 204u : j == 3 ? 51u
       : j == 4 ? 170u : j == 5 ? 85u : j == 6 ? 192u : j == 7 ? 48u
       : j == 8 ? 12u : j == 9 ? 3u : j == 10 ? 160u : j == 11 ? 80u
       : j == 12 ? 10u : j == 13 ? 5u : j == 14 ? 136u : j == 15 ? 68u
       : j == 16 ? 34u : 17u;
}

// ---- the staged plan tiles ----------------------------------------------

constexpr int kGT = 32;               // parent blocks a tile
constexpr int kGMaxW = 4;             // channels a window
constexpr int kGRows = kNbr + 1;      // the 18 neighbours, then the block
constexpr int kRcpTable = 64;         // weight sums with a tabled 1 / d

enum PlanKey : int {
  kGather, kAz, kBz, kVz, kSz, kAy, kBy, kVy, kSy, kAx, kBx, kVx, kSx,
  kOffZ, kOffY, kOffX, kSwP, kSwC, kNbrIdx, kNbrOk, kEnBase, kCntP
};

// bytes a parent block has in each plan tensor (sw_c is by child row and
// sw_p read only where a mean is computed: neither is staged)
constexpr int row_bytes(int k) {
  return k == kGather ? 64 : (k == kAz || k == kBz || k == kSz) ? 32
       : k == kVz ? 4 : (k == kAy || k == kBy || k == kSy) ? 16
       : k == kVy ? 2 : k == kVx ? 1 : (k == kSwC || k == kSwP) ? 0
       : k == kNbrIdx ? 144 : k == kNbrOk ? 18 : k == kEnBase ? 1 : 8;
}
// The staged tile comes in two parts: what the gather reads (the gather
// part: child rows, neighbour rows and their marks) and the rest (the
// compute part).
constexpr bool gather_part(int k) {
  return k == kGather || k == kNbrIdx || k == kNbrOk;
}
constexpr int part_off(int k, bool g) {
  return k == 0 ? 0
                : part_off(k - 1, g) +
                      (gather_part(k - 1) == g ? kGT * row_bytes(k - 1) : 0);
}
template <int K>
struct At {
  static constexpr int off = part_off(K, gather_part(K));
  static constexpr int rb = row_bytes(K);
};
constexpr int kGpBytes = part_off(kPlanKeys, true);
constexpr int kCpBytes = part_off(kPlanKeys, false);
static_assert(kGpBytes == kGT * 226 && kCpBytes == kGT * 208,
              "the staged plan: 434 of the 442 plan bytes a parent block");

template <int K, typename T>
__device__ __forceinline__ const T* at(const unsigned char* part) {
  return (const T*)(part + At<K>::off);
}

// A CTA's shared memory, for W channels a window: the plan tile (its
// gather part and its compute part), the gathered means (kGT, 19, W) and
// the children's sw_c (kGT, 8), the tile's input rows (its z, y, x rows,
// its parents' values and grandparent counts, when C <= kGMaxW), the
// prologue's keep masks and 1 / sw_c, and 1 / d for d < kRcpTable.
struct Smem {
  unsigned char* gp;
  unsigned char* cp;
  i64* nb;
  i64* swc;
  i64* in_rows[3];          // (4 kGT, C), (2 kGT, C), (kGT, C)
  i64* in_par;              // (kGT, C)
  i64* in_grand;            // (kGT,)
  double* rcps;             // (kGT, 8)
  double* rtab;             // (kRcpTable,)
  unsigned* keep;           // (kGT,)
};

__host__ __device__ constexpr int nb_bytes(int w) {
  return kGT * kGRows * w * 8;
}
__host__ __device__ constexpr int in_bytes(int w) {
  return (8 * kGT * w + kGT) * 8;
}
__host__ __device__ constexpr int group_smem(int w) {
  return kGpBytes + kCpBytes + nb_bytes(w) + kGT * 64 + in_bytes(w) +
         kGT * 64 + kRcpTable * 8 + kGT * 4;
}

__device__ __forceinline__ Smem smem_layout(unsigned char* s, int w) {
  Smem m;
  m.gp = s;
  m.cp = s + kGpBytes;
  s += kGpBytes + kCpBytes;
  m.nb = (i64*)s;
  s += nb_bytes(w);
  m.swc = (i64*)s;
  s += kGT * 64;
  m.in_rows[0] = (i64*)s;
  m.in_rows[1] = m.in_rows[0] + 4 * kGT * w;
  m.in_rows[2] = m.in_rows[1] + 2 * kGT * w;
  m.in_par = m.in_rows[2] + kGT * w;
  m.in_grand = m.in_par + kGT * w;
  s += in_bytes(w);
  m.rcps = (double*)s;
  s += kGT * 64;
  m.rtab = (double*)s;
  s += kRcpTable * 8;
  m.keep = (unsigned*)s;
  return m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// n <= 16 bytes from global, the rest of the 16 zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the tile's rows [b0, b0 + rows) of plan tensor K: one contiguous run
template <int K>
__device__ __forceinline__ void stage_rows(unsigned char* part,
                                           const void* src, i64 b0,
                                           int rows) {
  const int bytes = rows * At<K>::rb;
  const char* g = (const char*)src + b0 * At<K>::rb;
  const uint32_t d = smem_u32(part + At<K>::off);
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    cp_async16(d + i, g + i, min(16, bytes - i));
}

__device__ void stage_gather_part(unsigned char* gp, const Plan& p, i64 b0,
                                  int rows) {
  stage_rows<kGather>(gp, p.gather, b0, rows);
  stage_rows<kNbrIdx>(gp, p.nbr_idx, b0, rows);
  stage_rows<kNbrOk>(gp, p.nbr_ok, b0, rows);
}

__device__ void stage_compute_part(unsigned char* cp, const Plan& p, i64 b0,
                                   int rows) {
  stage_rows<kAz>(cp, p.az, b0, rows);
  stage_rows<kBz>(cp, p.bz, b0, rows);
  stage_rows<kVz>(cp, p.vz, b0, rows);
  stage_rows<kSz>(cp, p.sz, b0, rows);
  stage_rows<kAy>(cp, p.ay, b0, rows);
  stage_rows<kBy>(cp, p.by, b0, rows);
  stage_rows<kVy>(cp, p.vy, b0, rows);
  stage_rows<kSy>(cp, p.sy, b0, rows);
  stage_rows<kAx>(cp, p.ax, b0, rows);
  stage_rows<kBx>(cp, p.bx, b0, rows);
  stage_rows<kVx>(cp, p.vx, b0, rows);
  stage_rows<kSx>(cp, p.sx, b0, rows);
  stage_rows<kOffZ>(cp, p.off_z, b0, rows);
  stage_rows<kOffY>(cp, p.off_y, b0, rows);
  stage_rows<kOffX>(cp, p.off_x, b0, rows);
  stage_rows<kEnBase>(cp, p.en_base, b0, rows);
  stage_rows<kCntP>(cp, p.cnt_p, b0, rows);
}

__device__ __forceinline__ Coef tile_coef(const unsigned char* t, int b) {
  Coef cf;
  cf.valid = 0;
  cf.hi = 0;
  const i64 *az = at<kAz, i64>(t) + b * 4, *bz = at<kBz, i64>(t) + b * 4;
  const i64 *sz = at<kSz, i64>(t) + b * 4;
  const bool* vz = at<kVz, bool>(t) + b * 4;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    cf.a[s] = az[s];
    cf.b[s] = bz[s];
    cf.valid |= (unsigned)vz[s] << s;
    cf.hi |= (unsigned)(sz[s] == 1) << s;
  }
  const i64 *ay = at<kAy, i64>(t) + b * 2, *by = at<kBy, i64>(t) + b * 2;
  const i64* sy = at<kSy, i64>(t) + b * 2;
  const bool* vy = at<kVy, bool>(t) + b * 2;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    cf.a[4 + s] = ay[s];
    cf.b[4 + s] = by[s];
    cf.valid |= (unsigned)vy[s] << (4 + s);
    cf.hi |= (unsigned)(sy[s] == 1) << (4 + s);
  }
  cf.a[6] = at<kAx, i64>(t)[b];
  cf.b[6] = at<kBx, i64>(t)[b];
  cf.valid |= (unsigned)at<kVx, bool>(t)[b] << 6;
  cf.hi |= (unsigned)(at<kSx, i64>(t)[b] == 1) << 6;
  return cf;
}

// ---- raht_fp_group --------------------------------------------------------

// the parent reconstruction of row r, channel c
template <bool kFastOnly = false>
__device__ __forceinline__ i64 parent_recon(const GroupArgs& a, int mode,
                                            i64 r, int c, i64 d3, double r3,
                                            DivCount& n) {
  const i64 st = a.steps[c];
  if (!(mode & kRoot)) return a.recon_p[r * a.nc + c];
  if (mode & kDecode) return dequant(a.q_root_in[r * a.nc + c], st);
  return dequant(quant_f<kFastOnly>(a.recon_p[r * a.nc + c], st, d3, r3, n),
                 st);
}

__device__ __forceinline__ void store_q(int mode, void* base, i64 idx,
                                        i64 q) {
  if (mode & kQ32)
    ((int*)base)[idx] = (int)q;
  else
    ((i64*)base)[idx] = q;
}

// The means of window [c0, c0 + W) of the tile's 19 rows a block (the 18
// neighbours the planner marks, then the block) into nb (kGT, 19, W), and
// at the first window the children's sw_c into swc (kGT, 8), both with
// cp.async where the means are given (else computed, one division each).
// Thread (tb, cw) takes rows tb, tb + kGT, ...: adjacent threads read
// adjacent channels of a row.
__device__ __forceinline__ void gather_means(
    const GroupArgs& a, const unsigned char* gp, i64 b0, int rows, int c0,
    int w, int tb, int cw, i64* nb, i64* swc, DivCount& n) {
  const int c = c0 + cw;
  const i64* nidx = at<kNbrIdx, i64>(gp);
  const bool* nok = at<kNbrOk, bool>(gp);
  if (c < a.nc) {
    const i64 st = a.steps[c];
    const i64 d3 = mul(3, st);
    const double r3 = fast_rcp(d3);
    for (int item = tb; item < rows * kGRows; item += kGT) {
      const int b = item / kGRows, j = item - b * kGRows;
      if (j < kNbr && !nok[b * kNbr + j]) continue;    // never kept
      const i64 r = j < kNbr ? nidx[b * kNbr + j] : b0 + b;
      i64* dst = nb + item * w + cw;
      if (a.pf_p) {
        cp_async8(smem_u32(dst), a.pf_p + r * a.nc + c);
      } else {
        const i64 sw = a.p.sw_p[r];
        *dst = fdiv(shl(parent_recon(a, a.mode, r, c, d3, r3, n), QA), sw,
                    fast_rcp(sw), n);
      }
    }
  }
  if (c0 == 0) {
    const i64* g = at<kGather, i64>(gp);
    for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
      if (g[i] >= 0)
        cp_async8(smem_u32(swc + i), a.p.sw_c + g[i]);
      else
        swc[i] = 1;
    }
  }
}

// first zrow row of stage k (z, y, x) of the tile, and its rows
__device__ __forceinline__ void stage_span(const unsigned char* cp, int rows,
                                           int k, i64* first, int* count) {
  const i64* off = k == 0 ? at<kOffZ, i64>(cp)
                          : (k == 1 ? at<kOffY, i64>(cp) : at<kOffX, i64>(cp));
  const bool* v = k == 0 ? at<kVz, bool>(cp)
                         : (k == 1 ? at<kVy, bool>(cp) : at<kVx, bool>(cp));
  const int width = k == 0 ? 4 : (k == 1 ? 2 : 1);
  int last = 0;
  for (int s = 0; s < width; ++s) last += v[(rows - 1) * width + s];
  *first = off[0];
  *count = (int)(off[rows - 1] + last - off[0]);
}

// With C <= kGMaxW: the tile's input rows by cp.async, each one
// contiguous run: its z, y, x rows of q (decode) or truth (encode), its
// parents' reconstruction (or the roots' q rows), its grandparent counts.
__device__ __forceinline__ void stage_inputs(const GroupArgs& a,
                                             const unsigned char* cp, i64 b0,
                                             int rows, const Smem& m) {
  const int nc = a.nc;
  for (int k = 0; k < 3; ++k) {
    i64 first;
    int count;
    stage_span(cp, rows, k, &first, &count);
    const i64* src = a.rows_in[k] + first * nc;
    for (int i = threadIdx.x; i < count * nc; i += blockDim.x)
      cp_async8(smem_u32(m.in_rows[k] + i), src + i);
  }
  const i64* par = (a.mode & kRoot) && (a.mode & kDecode) ? a.q_root_in
                                                          : a.recon_p;
  for (int i = threadIdx.x; i < rows * nc; i += blockDim.x)
    cp_async8(smem_u32(m.in_par + i), par + b0 * nc + i);
  if (a.mode & kHaveGrand)
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      cp_async8(smem_u32(m.in_grand + i), a.grand_p + b0 + i);
}

// The tile's prologue: a thread a block takes its keep mask (channel 0 of
// the gathered means) and enable bit; every thread some of the children's
// 1 / sw_c.
__device__ __forceinline__ void tile_prologue(const GroupArgs& a,
                                              const unsigned char* gp,
                                              const unsigned char* cp,
                                              int rows, int w, bool staged,
                                              i64 b0, const Smem& m) {
  const int b = threadIdx.x;
  if (b < rows) {
    const i64* nbm = m.nb + b * kGRows * w;
    const bool* nok = at<kNbrOk, bool>(gp) + b * kNbr;
    const i64 pv = nbm[kNbr * w];
    const i64 lo = mul(2, pv), hi = mul(25, pv);
    unsigned keep = 0;
#pragma unroll
    for (int j = 0; j < kNbr; ++j) {
      const i64 nl = mul(10, nbm[j * w]);
      keep |= (unsigned)(nok[j] && nl > lo && nl < hi) << j;
    }
    bool en = at<kEnBase, bool>(cp)[b];
    if (a.mode & kHaveGrand)
      en = en && (staged ? m.in_grand[b] : a.grand_p[b0 + b]) >= a.t0;
    m.keep[b] = keep | (unsigned)en << 31;
  }
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x)
    m.rcps[i] = fast_rcp(m.swc[i]);
}

// block b0 + tb, channel c of one window; mode: a.mode (the count
// kernels pass a constant, so the other modes' branches fold away);
// staged: the tile's input rows are in m (else read from global)
template <bool kFastOnly = false>
__device__ __forceinline__ void group_block(
    const GroupArgs& a, int mode, const unsigned char* gp,
    const unsigned char* cp, const Smem& m, bool staged, i64 b0, int tb,
    int c, int cw, int w, bool first_window, DivCount& n) {
  const int nc = a.nc;
  const i64 mb = b0 + tb;
  const i64 st = a.steps[c];
  const i64 d3 = mul(3, st);
  const double r3 = fast_rcp(d3);
  const unsigned ke = m.keep[tb];
  const bool en = ke >> 31;
  const i64* nbm = m.nb + tb * kGRows * w + cw;
  const double* rs = m.rcps + tb * 8;
  const i64* swc = m.swc + tb * 8;
  const i64* g = at<kGather, i64>(gp) + tb * 8;

  // prediction of each present child (_predict): the kept neighbours'
  // weighted means, and their weights, summed onto the octants they touch
  i64 s[8], wsum[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    s[o] = 0;
    wsum[o] = a.w_self;
  }
#pragma unroll
  for (int j = 0; j < kNbr; ++j) {
    const bool k = (ke >> j) & 1;
    const i64 wj = k ? (j < 6 ? a.w_face : a.w_edge) : 0;
    const i64 t = k ? mul(nbm[j * w], wj) : 0;
#pragma unroll
    for (int o = 0; o < 8; ++o)
      if ((nbr_octants(j) >> o) & 1) {
        s[o] = add(s[o], t);
        wsum[o] = add(wsum[o], wj);
      }
  }
  const i64 self = mul(nbm[kNbr * w], a.w_self);
  i64 pred[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    pred[o] = 0;
    if (g[o] >= 0 && en) {
      const double rw = (u64)wsum[o] < (u64)kRcpTable ? m.rtab[wsum[o]]
                                                      : fast_rcp(wsum[o]);
      const i64 pm = fdiv<kFastOnly>(add(self, s[o]), wsum[o], rw, n);
      pred[o] = rnd(mul(pm, swc[o]));
    }
  }
  // its forward network, then the coded ACs
  const Coef cf = tile_coef(cp, tb);
  i64 pac[7], rec[7];
  forward(cf, pred, pac);
  const i64 offs[3] = {at<kOffZ, i64>(cp)[tb], at<kOffY, i64>(cp)[tb],
                       at<kOffX, i64>(cp)[tb]};
  const i64 first[3] = {at<kOffZ, i64>(cp)[0], at<kOffY, i64>(cp)[0],
                        at<kOffX, i64>(cp)[0]};
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    rec[k] = 0;
    if (!((cf.valid >> k) & 1)) continue;
    const int stage = k < 4 ? 0 : (k < 6 ? 1 : 2);
    const int lo = k < 4 ? 0 : (k < 6 ? 4 : 6);
    const unsigned before = cf.valid & ((1u << k) - 1) & ~((1u << lo) - 1);
    const i64 row = offs[stage] + __popc(before);
    const i64 idx = row * nc + c;
    const i64 in = staged ? m.in_rows[stage][(row - first[stage]) * nc + c]
                          : a.rows_in[stage][idx];
    i64 q;
    if (mode & kDecode) {
      q = in;
    } else {
      q = quant_f<kFastOnly>(sub(in, pac[k]), st, d3, r3, n);
      store_q(mode, a.q_out[stage], idx, q);
    }
    rec[k] = add(pac[k], dequant(q, st));
  }
  // the inverse network from the parent's reconstruction
  const i64 par = staged ? m.in_par[tb * nc + c]
                         : ((mode & kRoot) && (mode & kDecode)
                                ? a.q_root_in[mb * nc + c]
                                : a.recon_p[mb * nc + c]);
  i64 dc = par;
  if (mode & kRoot) {
    dc = (mode & kDecode) ? dequant(par, st)
                          : dequant(quant_f<kFastOnly>(par, st, d3, r3, n),
                                    st);
    if (!(mode & kDecode))
      store_q(mode, a.q_root_out, mb * nc + c,
              quant_f<kFastOnly>(par, st, d3, r3, n));
  }
  i64 v[8];
  inverse(cf, dc, rec, v);
  const i64 cnt = at<kCntP, i64>(cp)[tb];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    if (g[o] < 0) continue;
    const i64 i = g[o] * nc + c;
    a.recon_c[i] = (mode & kFinal) ? add(v[o], HALF) >> F : v[o];
    if (a.pf_c) a.pf_c[i] = fdiv<kFastOnly>(shl(v[o], QA), swc[o], rs[o], n);
    if (first_window && cw == 0) a.cnt_c[g[o]] = cnt;
  }
}

// A persistent grid over tiles of kGT parent blocks, blockDim kGT W.
// Each tile: its plan landed (staged at the end of the tile before), the
// CTA starts by cp.async the gather of the first window's means and the
// children's sw_c and the staging of its input rows, waits for them, runs
// the prologue, then each window's blocks (a window after the first,
// C > kGMaxW, gathers its means and reads its input rows from global
// memory), then stages the next tile's plan.
__global__ void __launch_bounds__(kGT* kGMaxW, 3)
raht_fp_group_kernel(const GroupArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const i64 ntiles = (a.mp + kGT - 1) / kGT;
  i64 tile = blockIdx.x;
  if (tile >= ntiles) return;
  const int w = a.win;
  const int tb = threadIdx.x / w, cw = threadIdx.x - tb * w;
  const bool staged = a.nc <= kGMaxW;
  const Smem m = smem_layout(smem, w);
  DivCount n = {0u, 0u};
  if (threadIdx.x < kRcpTable) m.rtab[threadIdx.x] = fast_rcp(threadIdx.x);
  {
    const i64 b0 = tile * kGT;
    const int rows = (int)min((i64)kGT, a.mp - b0);
    stage_gather_part(m.gp, a.p, b0, rows);
    stage_compute_part(m.cp, a.p, b0, rows);
    cp_async_commit();
  }
  const unsigned char* gp = m.gp;
  const unsigned char* cp = m.cp;
  for (; tile < ntiles; tile += gridDim.x) {
    const i64 b0 = tile * kGT;
    const int rows = (int)min((i64)kGT, a.mp - b0);
    cp_async_wait_all();              // this tile's plan
    __syncthreads();
    gather_means(a, gp, b0, rows, 0, w, tb, cw, m.nb, m.swc, n);
    if (staged) stage_inputs(a, cp, b0, rows, m);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();                  // the means and input rows landed
    tile_prologue(a, gp, cp, rows, w, staged, b0, m);
    __syncthreads();
    for (int c0 = 0; c0 < a.nc; c0 += w) {
      if (c0 > 0) {                   // C > kGMaxW: the next window
        __syncthreads();              // the last window's means are read
        gather_means(a, gp, b0, rows, c0, w, tb, cw, m.nb, m.swc, n);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
      }
      if (tb < rows && c0 + cw < a.nc)
        group_block(a, a.mode, gp, cp, m, staged, b0, tb, c0 + cw, cw, w,
                    c0 == 0, n);
    }
    __syncthreads();                  // the plan tile is read
    const i64 next = tile + gridDim.x;
    if (next < ntiles) {
      const int nrows = (int)min((i64)kGT, a.mp - next * kGT);
      stage_gather_part(m.gp, a.p, next * kGT, nrows);
      stage_compute_part(m.cp, a.p, next * kGT, nrows);
    }
    cp_async_commit();
  }
  cp_async_wait_all();
  if (a.stats && (n.fast | n.general)) {
    atomicAdd(a.stats, (u64)n.fast);
    atomicAdd(a.stats + 1, (u64)n.general);
  }
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

// Never launched: one thread through the tile prologue, and one through
// a (block, channel) of an encode group and of a decode group past the
// first (the modes of 10 of the 11 a side) on the fast divisions, at
// three channels a window, compiled so that cuobjdump -sass counts each
// one's instructions (chip_smoke (f)'s SASS issue time of raht_fp_group, a
// diagnostic beside its byte bound).
// args: a GroupArgs; smem stands for the CTA's shared memory.
extern "C" __global__ void raht_fp_group_prologue_count(const void* args,
                                                        unsigned char* smem) {
  const Smem m = smem_layout(smem, 3);
  tile_prologue(*(const GroupArgs*)args, m.gp, m.cp, kGT, 3, true, 0,
                m);
}

extern "C" __global__ void raht_fp_group_block_count_enc(const void* args,
                                                         unsigned char* smem) {
  const Smem m = smem_layout(smem, 3);
  DivCount n = {0u, 0u};
  group_block<true>(*(const GroupArgs*)args, kHaveGrand | kQ32, m.gp,
                    m.cp, m, true, 0, threadIdx.x, threadIdx.y,
                    threadIdx.y, 3, true, n);
}

extern "C" __global__ void raht_fp_group_block_count_dec(const void* args,
                                                         unsigned char* smem) {
  const Smem m = smem_layout(smem, 3);
  DivCount n = {0u, 0u};
  group_block<true>(*(const GroupArgs*)args, kDecode | kHaveGrand, m.gp,
                    m.cp, m, true, 0, threadIdx.x, threadIdx.y,
                    threadIdx.y, 3, true, n);
}

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

// the dynamic shared memory of a raht_fp_group CTA at nc channels
extern "C" int raht_fp_group_smem_bytes(int nc) {
  return group_smem(nc < kGMaxW ? nc : kGMaxW);
}

// rows_in / q_out: 3 pointers each (z, y, x); ints: t0, w_self, w_face,
// w_edge; nbr_octants: 18 bytes, which must be the kernel's touch table;
// stats: two uint64 (fast, general divisions) added to, or null
extern "C" int raht_fp_group_launch(
    const void* const* plan, long long mp, int nc, int mode,
    const void* recon_p, const void* pf_p, const void* grand_p,
    const void* steps, const void* const* rows_in, const void* q_root_in,
    void* const* q_out, void* q_root_out, void* recon_c, void* pf_c,
    void* cnt_c, const long long* ints, const unsigned char* nbr_octants_in,
    void* stats, void* stream) {
  if (mp <= 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < kNbr; ++j)
    if (nbr_octants_in[j] != nbr_octants(j)) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < kPlanKeys; ++k)
    if (k != kSwC && ((uintptr_t)plan[k] & 15u) != 0)
      return (int)cudaErrorMisalignedAddress;
  GroupArgs a;
  a.p = plan_from(plan);
  a.mp = mp;
  a.nc = nc;
  a.mode = mode;
  a.win = nc < kGMaxW ? nc : kGMaxW;
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
  a.stats = (u64*)stats;
  a.t0 = ints[0];
  a.w_self = ints[1];
  a.w_face = ints[2];
  a.w_edge = ints[3];
  const int smem = group_smem(a.win);
  cudaError_t e = cudaFuncSetAttribute(
      raht_fp_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      group_smem(kGMaxW));
  if (e != cudaSuccess) return (int)e;
  const int threads = kGT * a.win;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, raht_fp_group_kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  const i64 ntiles = (mp + kGT - 1) / kGT;
  const i64 fill = (i64)(per_sm > 0 ? per_sm : 1) * sms;
  raht_fp_group_kernel<<<(unsigned)(ntiles < fill ? ntiles : fill), threads,
                         smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
