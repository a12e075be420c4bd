// The per-frame plan of the fixed-point RAHT closed loop, built on the
// card from the frame's sorted leaf codes, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package plans on the host
// (mpeg_pcc_tmc13_tpu/ops/raht_fp_device.py: build_fp_plan, numpy) and
// uploads the plan.  The port keeps that planner (ops/raht_fp_device.py:
// build_fp_plan, plans_to_torch; ops/raht_plan.py: row_offsets) as the
// spec; the plain PyTorch version of these passes is build_plan_ref in
// ops/raht_plan.py.  Every tensor equals the spec's bit for bit.
//
// The idea.  For sorted distinct codes c, leaf i > 0 first differs from
// leaf i - 1 at bit m = msb(c[i] ^ c[i-1]), where c[i] has the 1.  So:
// * leaf i opens a node of level g (the codes c >> 3g) iff g <= m / 3
//   (leaf 0 opens one at every level): a level's nodes are the leaves with
//   h = min(m / 3, depth) >= g, in order, and a node's weight is the
//   distance from its first leaf to the next node's;
// * leaf i closes exactly one butterfly pair, at level m / 3 and stage
//   m % 3 (z, y, x): its cell (c >> m) is odd and the cell before it
//   holds leaf i - 1.  So a stage's coded (zrow) order is leaf order,
//   its pair count a level is a histogram of m, and a block's row offset
//   counts that stage's pairs at the leaves before the block's first leaf.
// Three launches a frame:
//   1. plan_count: tiles of 4096 leaves; per tile the histograms of h
//      (node counts a level) and of m below 3 depth (pairs a level and
//      stage); the last CTA to finish scans the tiles' counts (a warp a
//      value).  The host copies the totals and a fault flag (unsorted,
//      repeated or negative codes): the frame's one synchronisation,
//      which sizes every tensor.
//   2. plan_scatter: the same tiles; a leaf's rank among the leaves of a
//      level or bin comes from one ballot a value and round (as
//      octree_occ_u8's scatter ranks points), so each leaf writes its
//      nodes' parent row and octant, its blocks' first child, code and row
//      offsets, and its pair's flat index.
//   3. plan_blocks: a thread a parent block of every level (one flat
//      grid): the block's children (contiguous, in octant order), their
//      weights, gather row and Q15 square roots, the three stages'
//      coefficients, and the 18 neighbour codes (the masked Morton steps
//      of ops/raht.py:_offset_neighbor_codes) looked up by binary search
//      in the level's parent codes, which stay in L2.
//
// What bounds it on an H100: the plan's bytes, written once (~527 B a
// parent block as the plan's int64 and bool tensors lie: 170 MB on a
// ~856k-point body, 0.05 ms at 3.35 TB/s), then three launches and the
// host's one read of the counts.  The neighbour search reads ~18 log2(mp)
// codes a block, from L2.
//
// Numerics, as the spec: isqrt64 is trunc(sqrt_rn(double(x))) and two
// integer correction rounds; (w0 << 30) // ws is an FP64
// reciprocal-multiply and one remainder step when both are <= 2^51
// (raht_fp_loop.cu's fdiv and its range argument), else int64 floor
// division; explicit _rn intrinsics, so no FMA is contracted.
//
// Layout.  Each plan tensor kind holds every level, each level's rows
// starting at a multiple of 16 rows, so every level's view starts on 16
// bytes (raht_fp_group stages the plan by 16-byte copies).  The host
// gives each level's base rows and node counts (Layout).
//
// Launcher contract (ops/raht_plan.py): pointers from torch tensors
// on the caller's current stream, the buffers as an array of kBufs
// pointers in Buf's order (CARD_BUFS there), the layout as kLayoutWords
// int64; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;   // leaves a tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 21;                  // 63-bit Morton codes
constexpr int kMaxVals = 4 * kMaxDepth + 1;    // levels 0..depth, 3 depth bins
constexpr int kBThreads = 128;                 // plan_blocks
constexpr int kNbr = 18;
constexpr i64 kFastLim = 1LL << 51;

// the buffers, in the launcher's pointer order
enum Buf {
  // child rows
  kPidx, kOct, kSwC, kLs,
  // block rows
  kGather, kAz, kBz, kVz, kSz, kAy, kBy, kVy, kSy, kAx, kBx, kVx, kSx,
  kSwP, kOffZ, kOffY, kOffX, kNbrIdx, kNbrOk, kCntP, kEnBase, kCstart, kPc,
  // pair rows (z, y, x)
  kFlatZ, kFlatY, kFlatX,
  kBufs
};

struct Out {
  void* p[kBufs];
};

__device__ __forceinline__ i64* P64(const Out& o, int k) {
  return (i64*)o.p[k];
}
__device__ __forceinline__ unsigned char* P8(const Out& o, int k) {
  return (unsigned char*)o.p[k];
}

// n: node counts of levels 0..depth; per level g < depth the base rows of
// its children (cb), parent blocks (bb) and z, y, x pairs (pb); blk0: the
// first block of level g in plan_blocks' flat index (blk0[depth]: all)
struct Layout {
  i64 n[kMaxDepth + 1];
  i64 cb[kMaxDepth];
  i64 bb[kMaxDepth];
  i64 pb[3][kMaxDepth];
  i64 blk0[kMaxDepth + 1];
};
constexpr int kLayoutWords = sizeof(Layout) / sizeof(i64);

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// leaf i: h, the highest level whose node it opens, and m, the bit of its
// butterfly pair (-1 for leaf 0); h = -1 where c[i] <= c[i-1] (a fault)
__device__ __forceinline__ void leaf_bits(const i64* c, i64 i, int depth,
                                          int& h, int& m) {
  m = -1;
  if (i == 0) {
    h = depth;
    return;
  }
  const i64 a = c[i - 1], b = c[i];
  if (b <= a) {
    h = -1;
    return;
  }
  m = 63 - __clzll((i64)((u64)a ^ (u64)b));
  h = min(m / 3, depth);
}

// The one CTA that finishes a pass last (the threadFenceReduction
// pattern: no CTA ever waits).
__device__ bool last_to_finish(unsigned* ticket, unsigned ctas) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == ctas - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// scratch: [0] ticket, [1] fault, [2, 2 + nv) totals, then the tiles'
// counts and exclusive prefixes, (tiles, nv) each.  Value v <= depth: the
// leaves with h >= v (level v's nodes); v = depth + 1 + b: the leaves
// with m == b (pairs of level b / 3, stage b % 3).
struct Scratch {
  unsigned* ticket;
  i64* fault;
  i64* tot;
  i64* cnt;
  i64* excl;
};

__device__ __forceinline__ Scratch scratch_of(i64* sc, int nv, i64 tiles) {
  return Scratch{(unsigned*)sc, sc + 1, sc + 2, sc + 2 + nv,
                 sc + 2 + nv + tiles * nv};
}

__global__ void __launch_bounds__(kThreads)
plan_count_kernel(const i64* __restrict__ c, i64 n, int depth, i64* sc,
                  i64 tiles) {
  __shared__ int hist[kMaxVals];   // h at [h], m at [depth + 1 + m]
  const int nv = 4 * depth + 1;
  const Scratch s = scratch_of(sc, nv, tiles);
  for (int v = threadIdx.x; v < kMaxVals; v += kThreads) hist[v] = 0;
  __syncthreads();
  bool fault = false;
  const i64 base = (i64)blockIdx.x * kTile;
  for (int k = 0; k < kPerThread; ++k) {
    const i64 i = base + k * kThreads + threadIdx.x;
    if (i >= n) break;
    int h, m;
    leaf_bits(c, i, depth, h, m);
    if (h < 0 || (i == 0 && c[0] < 0)) {
      fault = true;
      continue;
    }
    atomicAdd(&hist[h], 1);
    if (m >= 0 && m < 3 * depth) atomicAdd(&hist[depth + 1 + m], 1);
  }
  if (fault) *s.fault = 1;
  __syncthreads();
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    int x = 0;
    if (v <= depth) {
      for (int l = v; l <= depth; ++l) x += hist[l];
    } else {
      x = hist[v];
    }
    s.cnt[blockIdx.x * (i64)nv + v] = x;
  }
  if (!last_to_finish(s.ticket, gridDim.x)) return;
  // a warp a value: the tiles' exclusive prefixes and the total, read
  // through L2 (__ldcg: other CTAs wrote the counts)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int v = warp; v < nv; v += kWarps) {
    i64 carry = 0;
    for (i64 t0 = 0; t0 < tiles; t0 += 32) {
      const i64 t = t0 + lane;
      const i64 x = t < tiles ? __ldcg(s.cnt + t * nv + v) : 0;
      i64 inc = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const i64 o = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += o;
      }
      if (t < tiles) s.excl[t * nv + v] = carry + inc - x;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) s.tot[v] = carry;
  }
}

__global__ void __launch_bounds__(kThreads)
plan_scatter_kernel(const i64* __restrict__ c, i64 n, int depth,
                    const i64* sc, i64 tiles, Out o, Layout L) {
  __shared__ unsigned bal[kMaxVals][kWarps];
  __shared__ i64 wo[kMaxVals][kWarps];
  __shared__ i64 run[kMaxVals];
  const int nv = 4 * depth + 1;
  const i64* excl = sc + 2 + nv + tiles * nv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = lanemask_lt();
  for (int v = threadIdx.x; v < nv; v += kThreads)
    run[v] = excl[blockIdx.x * (i64)nv + v];
  const i64 base = (i64)blockIdx.x * kTile;
  for (int k = 0; k < kPerThread; ++k) {
    if (base + k * kThreads >= n) break;     // the same for the whole CTA
    const i64 i = base + k * kThreads + threadIdx.x;
    int h = -1, m = -1;
    i64 ci = 0;
    if (i < n) {
      leaf_bits(c, i, depth, h, m);
      ci = c[i];
    }
    __syncthreads();                  // run is set, last round's wo read
    for (int v = 0; v < nv; ++v) {
      const bool p = v <= depth ? h >= v : m == v - depth - 1;
      const unsigned b = __ballot_sync(0xffffffffu, p);
      if (lane == 0) bal[v][warp] = b;
    }
    __syncthreads();
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      i64 r = run[v];
      for (int w = 0; w < kWarps; ++w) {
        wo[v][w] = r;
        r += __popc(bal[v][w]);
      }
      run[v] = r;
    }
    __syncthreads();
    if (h < 0) continue;
    // the leaves of value v before leaf i
#define RANK(v) (wo[v][warp] + __popc(bal[v][warp] & lt))
    for (int g = 0; g <= h; ++g) {
      const i64 j = RANK(g);            // leaf i's node: row j of level g
      if (g < depth) {
        const i64 row = L.cb[g] + j;
        P64(o, kLs)[row] = i;
        // its parent: the level g + 1 nodes opened up to leaf i, less one
        P64(o, kPidx)[row] = g < h ? RANK(g + 1) : RANK(g + 1) - 1;
        P64(o, kOct)[row] = (ci >> (3 * g)) & 7;
      }
      if (g >= 1) {                     // the node is a block of level g - 1
        const int gb = g - 1;
        const i64 row = L.bb[gb] + j;
        P64(o, kCstart)[row] = RANK(gb);
        P64(o, kPc)[row] = ci >> (3 * g);
        const int v0 = depth + 1 + 3 * gb;
        P64(o, kOffZ)[row] = RANK(v0);
        P64(o, kOffY)[row] = RANK(v0 + 1);
        P64(o, kOffX)[row] = RANK(v0 + 2);
      }
    }
    if (m >= 0 && m < 3 * depth) {      // the pair leaf i closes
      const int gp = m / 3, st = m % 3;
      const i64 par = RANK(gp + 1) - 1;   // h == gp: no node of gp + 1
      const int oc = (int)((ci >> (3 * gp)) & 7);
      const i64 flat = st == 0 ? par * 4 + (oc >> 1)
                               : (st == 1 ? par * 2 + (oc >> 2) : par);
      P64(o, kFlatZ + st)[L.pb[st][gp] + RANK(depth + 1 + m)] = flat;
    }
#undef RANK
  }
}

// ---- plan_blocks ------------------------------------------------------

__device__ __forceinline__ i64 mul(i64 a, i64 b) {
  return (i64)((u64)a * (u64)b);
}

// floor(a / b), b != 0 (numpy's //)
__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  if (b == -1) return (i64)(0ULL - (u64)a);
  i64 q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// floor(a / d) for d >= 1: raht_fp_loop.cu's fdiv
__device__ __forceinline__ i64 fdiv(i64 a, i64 d) {
  if (d <= kFastLim && a >= -kFastLim && a <= kFastLim) {
    const double r = __drcp_rn(__ll2double_rn(d));
    i64 q = __double2ll_rd(__dmul_rn(__ll2double_rn(a), r));
    const i64 rem = a - q * d;
    if (rem < 0)
      --q;
    else if (rem >= d)
      ++q;
    return q;
  }
  return floordiv(a, d);
}

// raht_fp.isqrt64: the float64 seed truncated, two correction rounds
__device__ __forceinline__ i64 isqrt64(i64 x) {
  i64 y = __double2ll_rz(__dsqrt_rn(__ll2double_rn(x)));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (mul(y + 1, y + 1) <= x) ++y;
    if (mul(y, y) > x) --y;
  }
  return y < 0 ? 0 : y;
}

__device__ __forceinline__ i64 shl30(i64 w) { return (i64)((u64)w << 30); }

// _stage_coeffs of one pair: a, b (Q15), both present, single source
__device__ __forceinline__ void pair(i64 w0, i64 w1, i64& a, i64& b,
                                     unsigned char& v, i64& s) {
  const i64 ws = max(w0 + w1, 1LL);
  a = isqrt64(fdiv(shl30(w0), ws));
  b = isqrt64(fdiv(shl30(w1), ws));
  v = w0 > 0 && w1 > 0;
  s = w0 > 0 ? 0 : (w1 > 0 ? 1 : -1);
}

// ops/raht.py's per-axis Morton masks (x at bits 2, 5, ..., y at 1, 4,
// ..., z at 0, 3, ...) and _NBR_OFFSETS as (dx, dy, dz), faces first
constexpr u64 kMZ = 0x1249249249249249ULL;
__constant__ signed char kOff[kNbr][3] = {
    {1, 0, 0},  {-1, 0, 0}, {0, 1, 0},  {0, -1, 0}, {0, 0, 1},  {0, 0, -1},
    {1, 1, 0},  {1, -1, 0}, {-1, 1, 0}, {-1, -1, 0}, {1, 0, 1}, {1, 0, -1},
    {-1, 0, 1}, {-1, 0, -1}, {0, 1, 1}, {0, 1, -1}, {0, -1, 1}, {0, -1, -1}};

__global__ void __launch_bounds__(kBThreads)
plan_blocks_kernel(i64 n, int depth, i64 t1, Out o, Layout L) {
  const i64 total = L.blk0[depth];
  for (i64 t = (i64)blockIdx.x * kBThreads + threadIdx.x; t < total;
       t += (i64)gridDim.x * kBThreads) {
    int g = 0;
    while (t >= L.blk0[g + 1]) ++g;
    const i64 b = t - L.blk0[g];
    const i64 mc = L.n[g], mp = L.n[g + 1];
    const i64 br = L.bb[g] + b, cb = L.cb[g];
    // the block's children: rows [cs, ce) of level g, in octant order
    const i64 cs = P64(o, kCstart)[br];
    const i64 ce = b + 1 < mp ? P64(o, kCstart)[br + 1] : mc;
    i64 w[8];
    i64 j = cs, lj = P64(o, kLs)[cb + cs];
#pragma unroll
    for (int oc = 0; oc < 8; ++oc) {
      i64 gat = -1;
      w[oc] = 0;
      if (j < ce && P64(o, kOct)[cb + j] == oc) {
        const i64 next = j + 1 < mc ? P64(o, kLs)[cb + j + 1] : n;
        w[oc] = next - lj;
        P64(o, kSwC)[cb + j] = isqrt64(shl30(w[oc]));
        gat = j;
        lj = next;
        ++j;
      }
      P64(o, kGather)[br * 8 + oc] = gat;
    }
    i64 wz[4], wy[2], a, bb, s;
    unsigned char v;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pair(w[2 * k], w[2 * k + 1], a, bb, v, s);
      P64(o, kAz)[br * 4 + k] = a;
      P64(o, kBz)[br * 4 + k] = bb;
      P8(o, kVz)[br * 4 + k] = v;
      P64(o, kSz)[br * 4 + k] = s;
      wz[k] = w[2 * k] + w[2 * k + 1];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      pair(wz[2 * k], wz[2 * k + 1], a, bb, v, s);
      P64(o, kAy)[br * 2 + k] = a;
      P64(o, kBy)[br * 2 + k] = bb;
      P8(o, kVy)[br * 2 + k] = v;
      P64(o, kSy)[br * 2 + k] = s;
      wy[k] = wz[2 * k] + wz[2 * k + 1];
    }
    pair(wy[0], wy[1], a, bb, v, s);
    P64(o, kAx)[br] = a;
    P64(o, kBx)[br] = bb;
    P8(o, kVx)[br] = v;
    P64(o, kSx)[br] = s;
    P64(o, kSwP)[br] = isqrt64(shl30(wy[0] + wy[1]));

    // neighbours among the level's parent codes (sorted, mp of them)
    const i64* pc = P64(o, kPc) + L.bb[g];
    const u64 code = (u64)pc[b];
    const int bits = min(3 * (depth - 1 - g), 62);
    const u64 outside = ~((1ULL << bits) - 1);
    int cnt = 1;
#pragma unroll 1
    for (int jn = 0; jn < kNbr; ++jn) {
      u64 cc = code;
      bool ok = true;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const int d = kOff[jn][ax];
        const u64 mask = kMZ << (2 - ax), unit = 1ULL << (2 - ax);
        if (d > 0) {
          cc = (((cc | ~mask) + unit) & mask) | (cc & ~mask);
          ok &= (cc & outside) == 0;       // no carry out of the level
        } else if (d < 0) {
          ok &= (cc & mask) != 0;          // not at the low edge
          cc = (((cc & mask) - unit) & mask) | (cc & ~mask);
        }
      }
      // np.searchsorted (left), clamped to mp - 1
      i64 lo = 0, len = mp;
      while (len > 0) {
        const i64 half = len >> 1;
        if (pc[lo + half] < (i64)cc) {
          lo += half + 1;
          len -= half + 1;
        } else {
          len = half;
        }
      }
      const i64 idx = min(lo, mp - 1);
      const bool hit = ok && pc[idx] == (i64)cc;
      P64(o, kNbrIdx)[br * kNbr + jn] = idx;
      P8(o, kNbrOk)[br * kNbr + jn] = hit;
      cnt += hit;
    }
    P64(o, kCntP)[br] = cnt;
    P8(o, kEnBase)[br] = cnt >= t1;
  }
}

Out out_from(const void* const* bufs) {
  Out o;
  for (int k = 0; k < kBufs; ++k) o.p[k] = (void*)bufs[k];
  return o;
}

}  // namespace

// The scratch's int64 words for n leaves at depth (the launchers' sizes)
extern "C" long long raht_fp_plan_scratch_words(long long n, int depth) {
  const long long tiles = (n + kTile - 1) / kTile;
  const long long nv = 4LL * depth + 1;
  return 2 + nv + 2 * tiles * nv;
}

// The counting pass: codes (n,) int64, sorted; the totals land in
// scratch words [1, 2 + 4 depth + 1): the fault flag, then the node counts
// of levels 0..depth and the pairs of each (level, stage).
extern "C" int raht_fp_plan_count_launch(const void* codes, long long n,
                                         int depth, void* scratch,
                                         void* stream) {
  if (n <= 0 || depth < 1 || depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = (n + kTile - 1) / kTile;
  cudaError_t e = cudaMemsetAsync(scratch, 0, 2 * sizeof(i64), st);
  if (e != cudaSuccess) return (int)e;
  plan_count_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      (const i64*)codes, n, depth, (i64*)scratch, tiles);
  return (int)cudaGetLastError();
}

// The scatter and block passes into bufs (kBufs pointers, Buf's order),
// laid out as layout (kLayoutWords int64, Layout's order) says; t1: the
// prediction's parent-count threshold (en_base).
extern "C" int raht_fp_plan_build_launch(const void* codes, long long n,
                                         int depth, long long t1,
                                         const void* scratch,
                                         const void* const* bufs,
                                         const long long* layout,
                                         void* stream) {
  if (n <= 0 || depth < 1 || depth > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = (n + kTile - 1) / kTile;
  Layout L;
  i64* lw = (i64*)&L;
  for (int k = 0; k < kLayoutWords; ++k) lw[k] = layout[k];
  const Out o = out_from(bufs);
  plan_scatter_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      (const i64*)codes, n, depth, (const i64*)scratch, tiles, o, L);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = L.blk0[depth];
  long long grid = (total + kBThreads - 1) / kBThreads;
  if (grid > (1LL << 20)) grid = 1LL << 20;
  plan_blocks_kernel<<<(unsigned)grid, kBThreads, 0, st>>>(n, depth, t1, o,
                                                           L);
  return (int)cudaGetLastError();
}
