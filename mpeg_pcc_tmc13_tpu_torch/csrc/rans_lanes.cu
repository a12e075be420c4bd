// The lane loops of the interleaved-rANS geometry engine, for Hopper
// (sm_90a).
//
// Each kernel stands in for a loop of mpeg_pcc_tmc13_tpu/ops/octree_rans.py
// that torch has no primitive for; its plain PyTorch version is in
// ops/rans_lanes.py, and the kernel is bit-identical to it:
//   rans_table_pass_kernel   <- encode_device's table scan (:234-261)
//                               with _quantize_cfull (:144-161)
//   rans_encode_emit_kernel  <- encode_device's emission (:264-290)
//   rans_decode_level_kernel <- decode_device's tile while_loop of one
//                               level (:353-391) with its refresh cond
//                               (:357-360)
//
// rANS parameters as in the reference: u32 state in [2^16, 2^32), 16-bit
// renormalisation words, probability precision M = 2^14, 2048 contexts of
// 256 cumulative-frequency entries each (c[0] = 0, c[255] = M).  A table
// row is the quantised histogram of its context row (Laplace prior), and
// tables refresh every UPD_TILES = 4 tiles of K symbols within a level;
// a window's own symbols never feed its lookups.
//
// What bounds them on an H100: none moves more than a few MB, so bytes
// and flops are far below their time; each is a serial chain.
//
// * Table pass: a context row's table depends on every earlier window
//   that touched that row, and on nothing else (quantisation is
//   row-separable).  The encoder knows every symbol in advance, so the
//   2048 rows run as independent chains, one CTA per row: the wrapper
//   sorts the symbols by context (stably, so each row stays in coding
//   order), and the CTA walks its row window by window with the row's
//   histogram and table in shared memory.  At a window's first
//   occurrence it requantises the table (the row changed in the previous
//   window it touched), looks up every occurrence of the window, and only
//   then counts them.  The floor is the busiest row's chain of windows.
// * Emission: one rANS state per lane over G dependent steps.  One
//   thread per lane keeps its state in a register for the whole chain;
//   lanes are independent.  The chain reads no global memory and holds
//   no division: f and c are staged into shared memory slabs ahead
//   (cp.async), and producer warps turn each step's f into a
//   multiply-high reciprocal, its threshold and its multiplier, nvalid
//   folded in, for a consumer warp that runs the chain alone (see there).
//   The floor is G times the dependent instructions of a step.
// * Decode: the G tiles of a decode are one chain (each lane's state,
//   and the word stream's cursor shared by all lanes), and after every
//   window of UPD_TILES tiles the rows it touched (~340 of the 2048 at
//   the bench size) must be requantised before the next tile reads them.
//   One launch per level runs a cluster of 16 CTAs.  The lead CTA
//   (K <= 1024 threads, one a lane) decodes the tiles, the states and the
//   cursor in registers: a symbol takes three dependent loads (the row's
//   4 top entries c[64b] and 8 coarse entries c[64b + 8i] from its own
//   shared memory, then 8 entries of the row from the owner's shared
//   memory), the next tile's contexts and the words a tile may pop are
//   fetched ahead, and ranking the lanes that pop a word costs one
//   barrier.  The 15 other CTAs own the rows, interleaved (row r is owner
//   r mod 15's), each holding its rows' histogram and 16-bit table in
//   shared memory for the whole launch: at a window's end the lead has
//   written the window's symbols, and each owner counts those of its rows
//   (shared atomics), lists the rows they touched and requantises them,
//   one warp a row, into its table and the lead's top and coarse entries;
//   two cluster barriers (release / acquire) a window separate the
//   writes from the reads.  On exit the owners write back the histogram
//   and the rows of the int32 table they refreshed.  The floor is the
//   chain of tiles on the lead SM, which issues the work of all K lanes
//   every tile, plus two cluster barriers and one refresh a window.
//
// Quantisation (quantize_entries) is floor(cs * (M - 255) / tot) without
// a division per entry: a float estimate of the quotient and an exact
// integer remainder that corrects it (see there).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (ops/_kernels.py does it on first use).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMBits = 14;
constexpr uint32_t kM = 1u << kMBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kCtx = 2048;          // context rows
constexpr int kUpdTiles = 4;        // tiles of a level between refreshes
constexpr int kRowThreads = 256;    // threads of a table-pass CTA (a row)
constexpr int kEmitLanes = 32;      // lanes of an emission block
constexpr int kEmitSteps = 8;       // steps of a slab of the emission
constexpr int kEmitPending = 2;     // cp.async groups a wait leaves in flight
constexpr int kEmitAhead = 3;       // slabs between a copy of f, c and its use
constexpr int kEmitRing = 4;        // slabs of f and c staged at a time
constexpr int kEmitTable = kM + 4;  // magic numbers 0..2^14, padded to 16 B
constexpr int kEmitProducers = 2;   // producer warps of a block
constexpr int kEmitThreads = (1 + kEmitProducers) * kEmitLanes;
constexpr int kEmitSlots = 4;       // prepared slabs between the warps
constexpr int kEmitFullBar = 1;     // named barriers: slot i full,
constexpr int kEmitEmptyBar = 1 + kEmitSlots;  // slot i empty
constexpr int kClusterCtas = 16;    // CTAs of the decode's cluster
constexpr unsigned kFull = 0xffffffffu;

// One warp requantises one context row: lane l holds the counts h of
// symbols 8l .. 8l+7 and gets their cumulative entries out, c[0] = 0 and
// c[s] = s + floor(cs[s] * (M - 255) / tot) for s >= 1.
//
// The quotient, without a division per entry: for rows of fewer than
// 2^23 counts (every row of a realistic cloud) x = cs * (M-255) / tot is
// estimated in float (cs and tot exact, the rounded reciprocal of tot) as
// x - 0.49, within 0.003, and rounded to the nearest integer by adding
// 1.5 * 2^23 (no conversion instruction); that gives floor(x) or
// floor(x) + 1, and the sign of the exact remainder, taken mod 2^32
// (|r| < 2^24), corrects the second.  Larger rows take a double
// reciprocal, corrected either way in int64 (chip_smoke.py's (g) holds
// both kernels to their plain versions on rows past 2^23 counts).
__device__ __forceinline__ void quantize_entries(const int32_t (&h)[8],
                                                 int32_t (&out)[8],
                                                 int lane) {
  constexpr int E = 8;
  int64_t cs[E];
  int64_t run = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int s = lane * E + j;
    run += (s == 0) ? 0 : (int64_t)h[j] + 1;  // Laplace prior, no symbol 0
    cs[j] = run;
  }
  int64_t incl = run;  // inclusive warp scan of the lanes' sums
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int64_t excl = incl - run;
  const int64_t tot = __shfl_sync(kFull, incl, 31);
  if (tot < (1 << 23)) {  // the same branch for the whole warp
    const float k = __frcp_rn((float)tot) * (float)(kM - 255);
    const uint32_t t32 = (uint32_t)tot;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int32_t x = (int32_t)(excl + cs[j]);
      const float xf = __int_as_float(0x4B000000 | x) - 8388608.0f;
      const float y = __fmaf_rn(xf, k, -0.49f) + 12582912.0f;
      int32_t q = __float_as_int(y) - 0x4B400000;
      const int32_t r =
          (int32_t)((uint32_t)x * (kM - 255) - (uint32_t)q * t32);
      q += r >> 31;
      out[j] = lane * E + j + q;
    }
  } else {
    const double rtot = 1.0 / (double)tot;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int64_t num = (excl + cs[j]) * (int64_t)(kM - 255);
      int64_t q = (int64_t)((double)num * rtot);
      if (q * tot > num) {
        --q;
      } else if ((q + 1) * tot <= num) {
        ++q;
      }
      out[j] = lane * E + j + (int32_t)q;
    }
  }
  if (lane == 0) out[0] = 0;
}

// ---------------------------------------------------------------------
// encoder table pass: one CTA per context row
// ---------------------------------------------------------------------
// sym/win/pos: the valid symbols grouped by context row (row r holds
// [row_off[r], row_off[r+1])), each row in coding order: the symbol
// (1..255), its global window index and its (step, lane) slot g*K+lane.
__global__ void __launch_bounds__(kRowThreads)
rans_table_pass_kernel(const int32_t* __restrict__ sym,
                       const int32_t* __restrict__ win,
                       const int32_t* __restrict__ pos,
                       const int32_t* __restrict__ row_off,
                       int32_t* __restrict__ fsteps,
                       int32_t* __restrict__ csteps,
                       int32_t* __restrict__ hist_out) {
  __shared__ __align__(16) int32_t h[256];
  __shared__ __align__(16) int32_t c[256];
  const int row = blockIdx.x, tid = threadIdx.x;
  h[tid] = 0;
  const int32_t end = row_off[row + 1];
  int32_t i = row_off[row];
  __syncthreads();
  while (i < end) {
    const int32_t w = win[i];  // the window of this row's next occurrence
    if (tid < 32) {  // warp 0 requantises the row
      int32_t hv[8], out[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) hv[j] = h[tid * 8 + j];
      quantize_entries(hv, out, tid);
#pragma unroll
      for (int j = 0; j < 8; ++j) c[tid * 8 + j] = out[j];
    }
    __syncthreads();
    for (;;) {  // the window's occurrences, kRowThreads at a time
      const int32_t at = i + tid;
      const bool act = at < end && win[at] == w;
      int s = 0;
      if (act) {
        s = sym[at];
        const int32_t lo = c[s - 1];
        const int64_t p = pos[at];
        fsteps[p] = c[s] - lo;
        csteps[p] = lo;
      }
      // the row is in coding order, so the window's occurrences are a
      // prefix of the chunk; the table stays frozen until the window ends
      const int n = __syncthreads_count(act);
      if (act) atomicAdd(&h[s], 1);
      i += n;
      if (n < kRowThreads) break;
    }
    __syncthreads();
  }
  hist_out[(int64_t)row * 256 + tid] = h[tid];
}

// ---------------------------------------------------------------------
// encoder emission: one thread per lane, steps g = G-1 .. 0
// ---------------------------------------------------------------------
// A lane's state is one chain of G dependent steps.  A warp issues in
// order, so whatever shares a warp with the chain and stalls, stalls the
// chain, and every instruction beside it takes an issue slot from it.
// The design therefore gives a block of kEmitLanes lanes three warps
// (the cycle counts below were read on an NVIDIA H100 80GB HBM3 at 700 W,
// 1,790 steps of 1,024 lanes):
//
// * The consumer warp runs the chain and nothing else: per step the
//   dependent instructions of emit_step (compare, select, add,
//   multiply-high, shift, multiply-add) and the two stores, per slab of
//   kEmitSteps steps one wait on a named barrier and kEmitSteps 16-byte
//   loads of prepared parameters from shared memory, taken a slab before
//   the chain needs them.  It reads no global memory, divides nothing, and
//   has no branch in its loop body.
// * kEmitProducers producer warps prepare those parameters, slabs ahead,
//   taking the slabs in turn (one producer could not keep up: its 36
//   instructions a step, with the waits between them, came to some 85
//   cycles a step, against 41 of the chain).  f and c reach a producer
//   asynchronously, with 4-byte cp.async that no register waits for:
//   kEmitAhead of its slabs ahead a thread copies its own lane's f and c of
//   a slab (and the slab's nvalid entries) into its ring in shared memory,
//   one cp.async group a slab, and waits for all but the newest
//   kEmitPending groups.  It then turns f, c and nvalid into the step's
//   parameters (emit_prep: the magic number of f from a table, below, the
//   threshold, the multiplier, nvalid folded in) in a ring of kEmitSlots
//   slabs of uint4 that the consumer reads.  Two named barriers a slot
//   (full, empty; bar.arrive on one side, bar.sync on the other) pace the
//   consumer and the slot's producer.
// * The table of magic numbers (64 KB) is copied into shared memory when
//   the block starts: gathered from global memory it cost a producer some
//   60 cycles a step (32 scattered sectors an instruction).
// * The slabs are aligned so that the last one ends at g = 0; the first
//   starts above G - 1 with steps that do not exist: they are prepared as
//   invalid (the identity), and their stores are predicated off.
// * A thread only ever reads what its own lane's threads wrote (the table
//   and nvalid apart, which __syncthreads and the producer's __syncwarp
//   cover), and no thread leaves early, so a ragged last block
//   (lanes % kEmitLanes != 0) strands no barrier: its surplus threads read
//   the last lane's column and store nothing.  Rows need no 16-byte
//   alignment (any K); a warp instruction still moves 128 contiguous bytes.
//
// The floor is G times the step's dependent latency; the launcher
// rans_emit_chain_probe_launch times that chain alone.

// The magic number of a frequency f (1..2^14): the quotient q = floor(x / f)
// of any 32-bit x is
//   q = ((m * x + (inc ? m : 0)) >> 32) >> sh          (64-bit product)
// with, for f >= 2, sh = ceil(log2 f) - 1 (so 2^sh < f <= 2^(sh+1)),
// N = 32 + sh, m_d = floor(2^N / f) in [2^31, 2^32) and e = 2^N - m_d * f
// in [0, f):
//   e = 0:         m = m_d, inc = 0.  m * x / 2^N = x / f exactly.
//   0 < e <= 2^sh: m = m_d, inc = 1 (round down, x + 1).  With x = q f + r,
//                  m (x+1) / 2^N = q + (r+1)/f - e (x+1) / (f 2^N); the last
//                  term is positive and at most 2^sh 2^32 / (f 2^N) = 1/f
//                  <= (r+1)/f, so the value lies in [q, q + 1).
//   e > 2^sh:      m = m_d + 1, inc = 0 (round up): its excess e' = f - e
//                  is below 2^(sh+1) - 2^sh = 2^sh, and m x / 2^N = q + r/f
//                  + e' x / (f 2^N) with e' x / (f 2^N) < 2^sh 2^32 /
//                  (f 2^N) = 1/f, so the value lies in [q, q + 1).
// m (x + 1) < 2^64, so nothing overflows.  f = 1 takes m = 2^32 - 1,
// inc = 1, sh = 0: floor((2^32 - 1)(x + 1) / 2^32) = x.  (The round-up and
// round-down magic numbers of Alverson and of Robison; ops/rans_lanes.py
// keeps the same formula in numpy, and a test holds it to x // f.)
//
// The step multiplies x + inc in 32 bits.  That cannot wrap: the x it
// divides is below f << 18 (a state that reaches f << 18 has emitted and
// is below 2^16), inc = 1 only for an f that is no power of two, so
// x + 1 <= (2^14 - 1) << 18 < 2^32.
//
// m_d comes from one double division: 2^N / f is either an integer below
// 2^32 (exact in double) or at least 1/f >= 2^-14 away from one, and the
// correctly rounded quotient is within 2^-53 * 2^32 = 2^-21 of it, so
// rounding down gives m_d.  That division is a call with a branch, far
// too slow for the emission's loop, so a launch first tabulates the 2^14
// magic numbers (64 KB, rans_emit_table_kernel) and the loop looks them up.
//
// Returned packed: m's top bit is always set, so inc takes its place.
__device__ __forceinline__ uint32_t emit_magic(uint32_t f) {
  if (f == 1u) return 0xFFFFFFFFu;
  const int sh = 31 - __clz((int)(f - 1u));
  const double two_n = __hiloint2double((1023 + 32 + sh) << 20, 0);
  uint32_t m = __double2uint_rd(two_n / (double)f);
  const uint32_t e = 0u - m * f;  // 2^N = 0 mod 2^32 and e < f
  const bool up = e > (1u << sh);
  const uint32_t inc = (e != 0u && !up) ? 1u : 0u;
  m += up ? 1u : 0u;
  return (m & 0x7FFFFFFFu) | (inc << 31);
}

// magic[f] for f = 1 .. 2^14 (entry 0 and the padding are unused)
__global__ void __launch_bounds__(256)
rans_emit_table_kernel(uint32_t* __restrict__ magic) {
  const uint32_t f = blockIdx.x * 256 + threadIdx.x;
  if (f < kEmitTable) magic[f] = (f && f <= kM) ? emit_magic(f) : 0u;
}

// Parameters of one (step, lane), from f (1..2^14), its magic number, c
// and whether the lane codes a symbol at the step:
//   x = m, y = f * 2^18 - 1 (a state above it emits a word first),
//   z = c - inc, w = (2^14 - f) | sh << 16 | inc << 31.
// An invalid lane gets all of them 0 but y = 2^32 - 1: it never emits and
// its step is the identity.  Masks, not selects of whole structs, so that
// no branch comes of it.
__device__ __forceinline__ uint4 emit_prep(uint32_t f, uint32_t magic,
                                           uint32_t c, bool valid) {
  const uint32_t keep = valid ? 0xFFFFFFFFu : 0u;
  const uint32_t sh = f == 1u ? 0u : 31u - __clz((int)(f - 1u));
  const uint32_t inc = magic >> 31;
  return make_uint4((magic | 0x80000000u) & keep,
                    ((f << (32 - kMBits)) - 1u) | ~keep, (c - inc) & keep,
                    ((kM - f) | (sh << 16) | (inc << 31)) & keep);
}

// One step of a lane's chain: a state above the threshold first emits its
// low 16 bits (the caller stores them), then with xi = x + inc
//   x -> ((x / f) << 14) + x % f + c = xi + (c - inc) + (x / f) * (2^14 - f).
__device__ __forceinline__ uint32_t emit_step(uint32_t s, const uint4 p,
                                              bool& emit) {
  const uint32_t mul = p.w & 0xFFFFu, sh = (p.w >> 16) & 15u;
  const uint32_t inc = p.w >> 31;
  emit = s > p.y;
  const uint32_t xi = emit ? (s >> 16) + inc : s + inc;
  const uint32_t q = __umulhi(p.x, xi) >> sh;
  return q * mul + (xi + p.z);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stores under a predicate, never a branch.
__device__ __forceinline__ void store_if(int32_t* p, int32_t v, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q st.global.u32 [%0], %1;\n}\n" ::"l"(p),
      "r"(v), "r"((uint32_t)ok)
      : "memory");
}

__device__ __forceinline__ void store_if(uint8_t* p, uint32_t v, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q st.global.u8 [%0], %1;\n}\n" ::"l"(p),
      "r"(v), "r"((uint32_t)ok)
      : "memory");
}

// Named barriers (id 0 is __syncthreads'): n threads in all, those that
// arrive and those that wait.  Prior shared-memory accesses of the
// arriving threads are performed before the waiting ones go on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

struct EmitShared {
  uint32_t table[kEmitTable];                      // magic number of each f
  struct Staged {                     // a producer's ring of slabs
    int32_t f[kEmitRing][kEmitSteps][kEmitLanes];
    int32_t c[kEmitRing][kEmitSteps][kEmitLanes];
    int32_t nv[kEmitRing][kEmitLanes];  // their nvalid, step j at [j]
  } staged[kEmitProducers];
  uint4 prm[kEmitSlots][kEmitSteps][kEmitLanes];  // prepared slabs
};

// What a producer thread needs to find its slabs: slab b holds the steps
// g = top0 - b * kEmitSteps - j, j = 0 .. kEmitSteps - 1.  Rows read ahead
// are clamped into 0 .. G-1 (a step that does not exist reads a row that
// does, and is prepared as invalid).
struct EmitWalk {
  const int32_t* fsteps;
  const int32_t* csteps;
  const int32_t* nvalid;
  int nsteps, top0, lanes;
  int clane;  // the thread's lane, or the last lane for a surplus thread

  __device__ __forceinline__ int top(int b) const {
    return top0 - b * kEmitSteps;
  }
  __device__ __forceinline__ int row(int g) const {
    return min(max(g, 0), nsteps - 1);
  }
};

// Slab b into stage i % kEmitRing of a producer's ring (i counts the
// producer's own slabs).
__device__ __forceinline__ void emit_stage_raw(EmitShared::Staged& st,
                                               const EmitWalk& w, int b,
                                               int i) {
  const int tid = threadIdx.x % kEmitLanes, stage = i % kEmitRing;
#pragma unroll
  for (int j = 0; j < kEmitSteps; ++j) {
    const int at = w.row(w.top(b) - j) * w.lanes + w.clane;
    cp_async4(&st.f[stage][j][tid], w.fsteps + at);
    cp_async4(&st.c[stage][j][tid], w.csteps + at);
  }
  cp_async4(&st.nv[stage][tid], w.nvalid + w.row(w.top(b) - tid));
  cp_async_commit();  // a group a slab
}

// Producer warp `part` of kEmitProducers: the parameters of the slabs
// b = part, part + kEmitProducers, ... into slot b % kEmitSlots.  Its
// next kEmitAhead slabs are in flight, a group each, and the wait leaves
// all but the oldest pending.
__device__ __forceinline__ void emit_produce(EmitShared& sh,
                                             const EmitWalk& w, int nslabs,
                                             int part) {
  static_assert(kEmitAhead > kEmitPending && kEmitRing > kEmitAhead,
                "the oldest slab in flight must land, and not be overwritten");
  static_assert(kEmitSlots % kEmitProducers == 0,
                "a slot must come back to the producer that filled it");
  const int tid = threadIdx.x % kEmitLanes;
  EmitShared::Staged& st = sh.staged[part];
#pragma unroll
  for (int i = 0; i < kEmitAhead; ++i)
    emit_stage_raw(st, w, part + i * kEmitProducers, i);
  for (int i = 0, b = part; b < nslabs; ++i, b += kEmitProducers) {
    // The nvalid of the slab before, which the slab staged now
    // overwrites, was read by every lane before this __syncwarp.
    cp_async_wait<kEmitPending>();
    __syncwarp();
    emit_stage_raw(st, w, b + kEmitAhead * kEmitProducers, i + kEmitAhead);
    const int stage = i % kEmitRing, slot = b % kEmitSlots;
    uint4 prm[kEmitSteps];
#pragma unroll
    for (int j = 0; j < kEmitSteps; ++j) {
      const int g = w.top(b) - j;  // >= 0; above G-1 only in slab 0
      const bool valid = g < w.nsteps && w.clane < st.nv[stage][j];
      const uint32_t f = min((uint32_t)st.f[stage][j][tid], kM);
      prm[j] = emit_prep(f, sh.table[f], (uint32_t)st.c[stage][j][tid],
                         valid);
    }
    // the consumer has read what the slot held (slab b - kEmitSlots)
    if (b >= kEmitSlots) bar_sync(kEmitEmptyBar + slot, 2 * kEmitLanes);
#pragma unroll
    for (int j = 0; j < kEmitSteps; ++j) sh.prm[slot][j][tid] = prm[j];
    bar_arrive(kEmitFullBar + slot, 2 * kEmitLanes);
  }
  cp_async_wait<0>();
}

// The consumer's next slab: wait for its slot, read it, give it back (if
// a later slab will want it).
__device__ __forceinline__ void emit_take_slab(EmitShared& sh, int b,
                                               int nslabs,
                                               uint4 (&prm)[kEmitSteps]) {
  const int tid = threadIdx.x % kEmitLanes, slot = b % kEmitSlots;
  bar_sync(kEmitFullBar + slot, 2 * kEmitLanes);
#pragma unroll
  for (int j = 0; j < kEmitSteps; ++j) prm[j] = sh.prm[slot][j][tid];
  if (b + kEmitSlots < nslabs)
    bar_arrive(kEmitEmptyBar + slot, 2 * kEmitLanes);
}

// The consumer warp: the chain and its stores.  Slab b + 1's parameters
// are read before slab b's chain runs, so their latency hides behind it.
__device__ __forceinline__ void emit_consume(
    EmitShared& sh, int64_t* __restrict__ states_out,
    int32_t* __restrict__ words, uint8_t* __restrict__ flags, int nsteps,
    int nslabs, int lanes, int lane) {
  const bool live = lane < lanes;
  uint32_t s = kRansL;
  uint4 prm[kEmitSteps], nxt_prm[kEmitSteps];
  emit_take_slab(sh, 0, nslabs, prm);
  for (int b = 0; b < nslabs; ++b) {
    if (b + 1 < nslabs) emit_take_slab(sh, b + 1, nslabs, nxt_prm);
    const int top = (nslabs - b) * kEmitSteps - 1;
    // offsets as unsigned: a row that does not exist, or a surplus lane,
    // wraps to an address that its predicate never lets through
    const uint32_t at = (uint32_t)(top * lanes + lane);
#pragma unroll
    for (int j = 0; j < kEmitSteps; ++j) {
      bool emit;
      const uint32_t nxt = emit_step(s, prm[j], emit);
      const bool ok = live && top - j < nsteps;
      const uint32_t off = at - (uint32_t)(j * lanes);
      store_if(words + off, emit ? (int32_t)(s & 0xFFFFu) : 0, ok);
      store_if(flags + off, emit ? 1u : 0u, ok);
      s = nxt;
    }
#pragma unroll
    for (int j = 0; j < kEmitSteps; ++j) prm[j] = nxt_prm[j];
  }
  if (live) states_out[lane] = (int64_t)s;
}

// nsteps and (nsteps + kEmitSteps) * lanes fit an int (the launcher
// checks), so every index is 32-bit.  magic: kEmitTable entries.
__global__ void __launch_bounds__(kEmitThreads)
rans_encode_emit_kernel(const int32_t* __restrict__ fsteps,
                        const int32_t* __restrict__ csteps,
                        const int32_t* __restrict__ nvalid,
                        const uint32_t* __restrict__ magic,
                        int64_t* __restrict__ states_out,
                        int32_t* __restrict__ words,
                        uint8_t* __restrict__ flags, int nsteps, int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  EmitShared& sh = *reinterpret_cast<EmitShared*>(smem);
  const int lane = blockIdx.x * kEmitLanes + threadIdx.x % kEmitLanes;
  const int warp = threadIdx.x / kEmitLanes;  // 0 consumes, the rest produce
  if (nsteps == 0) {  // the same for every thread
    if (warp == 0 && lane < lanes) states_out[lane] = (int64_t)kRansL;
    return;
  }
  // the table of magic numbers, which the producers look up
  for (int i = threadIdx.x; i < kEmitTable / 4; i += kEmitThreads)
    cp_async16(sh.table + 4 * i, magic + 4 * i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int nslabs = (nsteps + kEmitSteps - 1) / kEmitSteps;
  if (warp) {
    const EmitWalk w = {fsteps, csteps, nvalid, nsteps,
                        nslabs * kEmitSteps - 1, lanes, min(lane, lanes - 1)};
    emit_produce(sh, w, nslabs, warp - 1);
  } else {
    emit_consume(sh, states_out, words, flags, nsteps, nslabs, lanes, lane);
  }
}

// The emission's chain alone: one warp runs nsteps dependent emit_step
// calls on parameters held in registers and reports the SM cycles and the
// nanoseconds they took (out[0], out[1]; out[2] keeps the state alive).
__global__ void __launch_bounds__(32)
rans_emit_chain_probe_kernel(uint32_t f, uint32_t c, int64_t nsteps,
                             int64_t* __restrict__ out) {
  const uint4 p = emit_prep(f, emit_magic(f), c, true);
  uint32_t s = kRansL + threadIdx.x;
  uint32_t any = 0u;
  uint64_t n0, n1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(n0));
  const int64_t t0 = clock64();
  for (int64_t i = 0; i < nsteps; i += 16) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bool emit;
      s = emit_step(s, p, emit);
      any |= emit ? 1u : 0u;
    }
  }
  const int64_t t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(n1));
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = (int64_t)(n1 - n0);
  }
  if (s == 0x12345u) out[2] = (int64_t)(s + any);  // keeps the chain alive
}

// ---------------------------------------------------------------------
// decoder: every tile of one level, one cluster, one thread per lane
// ---------------------------------------------------------------------
constexpr int kCoarse = 32;   // coarse entries c[8k] of a row, k = 0..31
constexpr int kOwners = kClusterCtas - 1;  // CTAs that own rows
constexpr int kOwnRows = (kCtx + kOwners - 1) / kOwners;  // rows of one
constexpr int kOwnPad = (kOwnRows + 31) / 32 * 32;

struct LeadShared {                  // CTA 0, which decodes
  uint16_t coarse[kCtx * kCoarse];   // c[8k] of every row (<= M = 2^14)
  uint16_t top[kCtx * 4];            // c[64b] of every row
  int32_t wbuf[2][1024];             // the words a tile may pop, by parity
  int32_t warp_tot[2][32];           // words popped by each warp, by parity
};

struct OwnerShared {                 // CTA 1 + o owns rows o + kOwners * i
  int32_t hist[kOwnRows * 256];      // their histogram
  uint16_t tab[kOwnRows * 256];      // their table (entries <= M)
  uint8_t touched[kOwnPad];          // those the window touched
  uint8_t dirty[kOwnPad];            // those the launch refreshed
  uint16_t list[kOwnPad];            // ... compacted
  int32_t part[kOwnPad / 32];        // touched rows in each 32
};

// Candidates j + 4, j + 2, j + 1 among the 8 entries v (v[0] <= slot
// known): the largest j with v[j] <= slot, lo = v[j], hi = the last that
// failed.  Picked by the bits of j set so far (no indexed register array).
__device__ __forceinline__ int search8(const uint32_t (&v)[8], uint32_t slot,
                                       uint32_t& lo, uint32_t& hi) {
  int j = 0;
  uint32_t cand = v[4];
  if (cand <= slot) { j = 4; lo = cand; } else { hi = cand; }
  cand = (j & 4) ? v[6] : v[2];
  if (cand <= slot) { j += 2; lo = cand; } else { hi = cand; }
  cand = (j & 4) ? ((j & 2) ? v[7] : v[5]) : ((j & 2) ? v[3] : v[1]);
  if (cand <= slot) { j += 1; lo = cand; } else { hi = cand; }
  return j;
}

__device__ __forceinline__ void unpack8(const uint4 f, uint32_t (&v)[8]) {
  v[0] = f.x & 0xFFFFu;
  v[1] = f.x >> 16;
  v[2] = f.y & 0xFFFFu;
  v[3] = f.y >> 16;
  v[4] = f.z & 0xFFFFu;
  v[5] = f.z >> 16;
  v[6] = f.w & 0xFFFFu;
  v[7] = f.w >> 16;
}

// The symbol of `slot` in table row `row`: the largest s with c[s] <= slot,
// returned as s + 1, with lo = c[s] and hi = c[s + 1], in three dependent
// loads: the row's top entries c[64b] (8 bytes) and then 8 of its coarse
// entries c[64b + 8i] (16 bytes) from the lead's shared memory, then the
// 8 entries c[8k .. 8k+7] from the owner's copy of the row (16 bytes).
// lo is the last candidate that held, hi the last that failed (c[256],
// "past the row", is never hi).
__device__ __forceinline__ int search_sym(cg::cluster_group& cluster,
                                          OwnerShared* local,
                                          const LeadShared& sh, int row,
                                          uint32_t slot, uint32_t& lo,
                                          uint32_t& hi) {
  lo = 0u;
  hi = kM;
  const uint2 t = *reinterpret_cast<const uint2*>(sh.top + row * 4);
  const uint32_t t1 = t.x >> 16, t2 = t.y & 0xFFFFu, t3 = t.y >> 16;
  int b = 0;
  if (t2 <= slot) { b = 2; lo = t2; } else { hi = t2; }
  const uint32_t cand = b ? t3 : t1;
  if (cand <= slot) { b += 1; lo = cand; } else { hi = cand; }
  uint32_t v[8];
  unpack8(*reinterpret_cast<const uint4*>(sh.coarse + row * kCoarse + b * 8),
          v);
  const int k = b * 8 + search8(v, slot, lo, hi);
  const int o = row % kOwners;
  const uint16_t* tab = cluster.map_shared_rank(
      local->tab + row / kOwners * 256 + k * 8, o + 1);
  unpack8(*reinterpret_cast<const uint4*>(tab), v);
  return k * 8 + search8(v, slot, lo, hi) + 1;
}

// An owner CTA's part of a level.  Owner o holds the rows o + kOwners * i
// (interleaved, so that the rows a window touches spread evenly), their
// histogram and their table in shared memory for the whole launch: on
// entry it loads both (and gives the lead the rows' top and coarse
// entries); after each window it counts the window's symbols of its rows
// (shared atomics), lists the rows they touched, and requantises those,
// one warp a row, into its table and the lead's entries.  On exit it
// writes its rows of the histogram, and the rows it refreshed of the
// int32 table, back.
__device__ void decode_level_owner(cg::cluster_group& cluster,
                                   LeadShared* lead, OwnerShared& own,
                                   int32_t* cflat, int32_t* hist,
                                   const int32_t* wsyms, int64_t ntiles,
                                   int lanes, int o) {
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int nrows = (kCtx - o + kOwners - 1) / kOwners;
  // local row lr is row lr * kOwners + o; 64 int4 a row
  const int4* h4 = reinterpret_cast<const int4*>(hist);
  int4* own4 = reinterpret_cast<int4*>(own.hist);
  const int4* cf4 = reinterpret_cast<const int4*>(cflat);
  uint2* tab2 = reinterpret_cast<uint2*>(own.tab);
  for (int q = tid; q < nrows * 64; q += blockDim.x) {
    const int row = (q >> 6) * kOwners + o;
    const int64_t g = (int64_t)row * 64 + (q & 63);
    own4[q] = __ldcg(h4 + g);
    const int4 v = __ldcg(cf4 + g);
    tab2[q] = make_uint2((uint32_t)v.x | ((uint32_t)v.y << 16),
                         (uint32_t)v.z | ((uint32_t)v.w << 16));
    if ((q & 1) == 0)
      lead->coarse[row * kCoarse + ((q & 63) >> 1)] = (uint16_t)v.x;
    if ((q & 15) == 0) lead->top[row * 4 + ((q & 63) >> 4)] = (uint16_t)v.x;
  }
  for (int i = tid; i < kOwnPad; i += blockDim.x) {
    own.touched[i] = 0;
    own.dirty[i] = 0;
  }
  cluster.sync();  // the lead may search
  for (int64_t t0 = 0; t0 < ntiles; t0 += kUpdTiles) {
    cluster.sync();  // the lead wrote the window's symbols
    const int n = (int)min((int64_t)kUpdTiles, ntiles - t0) * lanes;
    for (int i = tid; i < n; i += 4 * blockDim.x) {
      int e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int at = i + u * blockDim.x;
        e[u] = at < n ? __ldcg(wsyms + at) : -1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int row = e[u] >> 8;
        if (e[u] >= 0 && row % kOwners == o) {
          const int lr = row / kOwners;
          atomicAdd(&own.hist[lr * 256 + (e[u] & 255)], 1);
          own.touched[lr] = 1;
        }
      }
    }
    __syncthreads();
    // the touched rows, listed: 32 rows a warp
    for (int p = warp; p < kOwnPad / 32; p += nwarps) {
      const unsigned m = __ballot_sync(kFull, own.touched[p * 32 + wl]);
      if (wl == 0) own.part[p] = __popc(m);
    }
    __syncthreads();
    const int pt = wl < kOwnPad / 32 ? own.part[wl] : 0;
    int pincl = pt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, pincl, d);
      if (wl >= d) pincl += v;
    }
    const int ntouched = __shfl_sync(kFull, pincl, 31);
    for (int p = warp; p < kOwnPad / 32; p += nwarps) {
      const bool f = own.touched[p * 32 + wl];
      const unsigned m = __ballot_sync(kFull, f);
      const int pbase = __shfl_sync(kFull, pincl - pt, p);
      if (f)
        own.list[pbase + __popc(m & ((1u << wl) - 1u))] =
            (uint16_t)(p * 32 + wl);
      own.touched[p * 32 + wl] = 0;
    }
    __syncthreads();
    for (int r = warp; r < ntouched; r += nwarps) {
      const int lr = own.list[r];
      const int32_t* hrow = own.hist + lr * 256 + wl * 8;
      const int32_t h[8] = {hrow[0], hrow[1], hrow[2], hrow[3],
                            hrow[4], hrow[5], hrow[6], hrow[7]};
      int32_t out[8];
      quantize_entries(h, out, wl);
      const int row = lr * kOwners + o;
      *reinterpret_cast<uint4*>(own.tab + lr * 256 + wl * 8) =
          make_uint4(out[0] | (out[1] << 16), out[2] | (out[3] << 16),
                     out[4] | (out[5] << 16), out[6] | (out[7] << 16));
      lead->coarse[row * kCoarse + wl] = (uint16_t)out[0];  // c[8 * wl]
      if ((wl & 7) == 0) lead->top[row * 4 + (wl >> 3)] = (uint16_t)out[0];
      if (wl == 0) own.dirty[lr] = 1;
    }
    cluster.sync();  // the table is current
  }
  __syncthreads();
  int4* hout = reinterpret_cast<int4*>(hist);
  int4* cout = reinterpret_cast<int4*>(cflat);
  for (int q = tid; q < nrows * 64; q += blockDim.x) {
    const int lr = q >> 6;
    const int64_t g = (int64_t)(lr * kOwners + o) * 64 + (q & 63);
    hout[g] = own4[q];
    if (own.dirty[lr]) {
      const uint2 v = tab2[q];
      cout[g] = make_int4(v.x & 0xFFFF, v.x >> 16, v.y & 0xFFFF, v.y >> 16);
    }
  }
}

// The table and the histogram are read and rewritten in this launch, by
// other CTAs than the lead: no const/__restrict__ on them, and cluster
// barriers separate the writes from the reads.  wsyms (UPD_TILES * 1024)
// is scratch for a window's symbols, ctx * 256 + sym or -1.
__global__ void __launch_bounds__(1024)
rans_decode_level_kernel(int32_t* cflat, int32_t* hist, int32_t* wsyms,
                         const int32_t* __restrict__ ctx_row,
                         const int32_t* __restrict__ words, int64_t wcap,
                         int64_t* __restrict__ states,
                         int64_t* __restrict__ cursor_io,
                         int32_t* __restrict__ syms, int64_t count,
                         int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  LeadShared* lead = cluster.map_shared_rank(
      reinterpret_cast<LeadShared*>(smem), 0);
  OwnerShared* local = reinterpret_cast<OwnerShared*>(smem);
  const int64_t ntiles = (count + lanes - 1) / lanes;
  cluster.sync();  // every CTA runs before any touches another's memory
  if (rank != 0) {
    decode_level_owner(cluster, lead, *local, cflat, hist, wsyms, ntiles,
                       lanes, rank - 1);
    return;
  }
  LeadShared& sh = *reinterpret_cast<LeadShared*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, wl = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const bool live = tid < lanes;
  uint32_t st = live ? (uint32_t)states[tid] : 0u;
  int64_t cursor = *cursor_io;
  int32_t ctx_next = live ? ctx_row[tid] : 0;
  cluster.sync();  // the owners loaded the table and the coarse entries
  for (int64_t t = 0; t < ntiles; ++t) {
    const int par = (int)(t & 1);
    const int64_t at = t * lanes + tid;
    const bool valid = live && at < count;
    const int32_t ctx = ctx_next;
    if (live && t + 1 < ntiles) ctx_next = ctx_row[at + lanes];
    // the words this tile may pop (at most one a lane, from the cursor
    // on, clamped to the last word), loaded while the symbol is searched
    const int64_t wi = cursor + tid;
    const int32_t word = words[wi < wcap ? wi : wcap - 1];
    int sym = 1;
    uint32_t nst = st;
    bool need = false;
    if (live) {
      const uint32_t slot = st & (kM - 1);
      uint32_t lo, hi;
      sym = search_sym(cluster, local, sh, ctx, slot, lo, hi);
      nst = (hi - lo) * (st >> kMBits) + slot - lo;
      need = valid && nst < kRansL;
    }
    // exclusive rank of this lane among the lanes that pop a word: every
    // warp scans the warp totals itself (one barrier a tile; wbuf and
    // warp_tot alternate, so the next tile cannot overwrite them early)
    const unsigned ballot = __ballot_sync(kFull, need);
    if (wl == 0) sh.warp_tot[par][warp] = __popc(ballot);
    sh.wbuf[par][tid] = word;
    __syncthreads();
    const int wt = wl < nwarps ? sh.warp_tot[par][wl] : 0;
    int incl = wt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (wl >= d) incl += v;
    }
    const int off = __shfl_sync(kFull, incl - wt, warp);
    const int popped = __shfl_sync(kFull, incl, 31);
    if (need) {
      const int rank_w = off + __popc(ballot & ((1u << wl) - 1u));
      nst = (nst << 16) | (uint32_t)sh.wbuf[par][rank_w];
    }
    if (valid) st = nst;
    if (live) {
      wsyms[(t % kUpdTiles) * lanes + tid] = valid ? ctx * 256 + sym : -1;
      syms[at] = valid ? sym : 1;
    }
    cursor += popped;
    if ((t + 1) % kUpdTiles != 0 && t + 1 != ntiles) continue;
    cluster.sync();  // the window's symbols are written
    cluster.sync();  // the owners refreshed its rows: the table is current
  }
  if (live) states[tid] = (int64_t)st;
  if (tid == 0) *cursor_io = cursor;
}

}  // namespace

// Plain C launchers for ctypes.  Pointers are device pointers of
// contiguous tensors; see ops/rans_lanes.py for the layouts.  They
// enqueue on `stream`, do not synchronise, and return cudaGetLastError()
// of the launch.

extern "C" int rans_table_pass_launch(const void* sym, const void* win,
                                      const void* pos, const void* row_off,
                                      void* fsteps, void* csteps, void* hist,
                                      void* stream) {
  rans_table_pass_kernel<<<kCtx, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sym, (const int32_t*)win, (const int32_t*)pos,
      (const int32_t*)row_off, (int32_t*)fsteps, (int32_t*)csteps,
      (int32_t*)hist);
  return (int)cudaGetLastError();
}

// magic: scratch of 2^14 + 4 uint32, which the launch fills first.
extern "C" int rans_encode_emit_launch(const void* fsteps, const void* csteps,
                                       const void* nvalid, void* magic,
                                       void* states, void* words, void* flags,
                                       int64_t nsteps, int lanes,
                                       void* stream) {
  if (lanes <= 0 || nsteps < 0 ||
      (nsteps + kEmitSteps) * (int64_t)lanes > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  // above 48 KB of shared memory a kernel must opt in (per device; a
  // cheap host call, so on every launch)
  cudaError_t rc = cudaFuncSetAttribute(
      rans_encode_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(EmitShared));
  if (rc != cudaSuccess) return (int)rc;
  rans_emit_table_kernel<<<(kEmitTable + 255) / 256, 256, 0,
                           (cudaStream_t)stream>>>((uint32_t*)magic);
  const int grid = (lanes + kEmitLanes - 1) / kEmitLanes;
  rans_encode_emit_kernel<<<grid, kEmitThreads, sizeof(EmitShared),
                            (cudaStream_t)stream>>>(
      (const int32_t*)fsteps, (const int32_t*)csteps, (const int32_t*)nvalid,
      (const uint32_t*)magic, (int64_t*)states, (int32_t*)words,
      (uint8_t*)flags, (int)nsteps, lanes);
  return (int)cudaGetLastError();
}

// The emission's table alone: magic (2^14 + 4 uint32) gets the packed
// magic number of every frequency, as rans_encode_emit_launch builds it.
extern "C" int rans_emit_table_launch(void* magic, void* stream) {
  rans_emit_table_kernel<<<(kEmitTable + 255) / 256, 256, 0,
                           (cudaStream_t)stream>>>((uint32_t*)magic);
  return (int)cudaGetLastError();
}

// Times the emission's chain alone for a symbol of frequency f and start
// c: out (3,) int64 gets the SM cycles and the nanoseconds of nsteps
// dependent steps of one warp.
extern "C" int rans_emit_chain_probe_launch(int f, int c, int64_t nsteps,
                                            void* out, void* stream) {
  if (f < 1 || f > (int)kM || nsteps < 0) return (int)cudaErrorInvalidValue;
  rans_emit_chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (uint32_t)f, (uint32_t)c, nsteps, (int64_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int rans_decode_level_launch(void* cflat, void* hist, void* wsyms,
                                        const void* ctx_row,
                                        const void* words, int64_t wcap,
                                        void* states, void* cursor,
                                        void* syms, int64_t count, int lanes,
                                        void* stream) {
  if (lanes <= 0 || lanes > 1024 || count <= 0 || wcap <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = sizeof(LeadShared) > sizeof(OwnerShared)
                           ? (int)sizeof(LeadShared)
                           : (int)sizeof(OwnerShared);
  // above 48 KB of shared memory and 8 CTAs a cluster a kernel must opt
  // in (per device; cheap host calls, so on every launch)
  cudaError_t rc = cudaFuncSetAttribute(
      rans_decode_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaFuncSetAttribute(rans_decode_level_kernel,
                            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterCtas);
  cfg.blockDim = dim3((lanes + 31) / 32 * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, rans_decode_level_kernel, (int32_t*)cflat,
                          (int32_t*)hist, (int32_t*)wsyms,
                          (const int32_t*)ctx_row, (const int32_t*)words,
                          wcap, (int64_t*)states, (int64_t*)cursor,
                          (int32_t*)syms, count, lanes);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
