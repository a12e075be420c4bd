// Octree level passes of the geometry pipeline, for Hopper (sm_90a).
//
// Replaces two jitted XLA programs of mpeg_pcc_tmc13_tpu/ops/octree.py:
//   octree_occ_u8   <- encode_occ_u8 with _min_levels (:397-481) and
//                      encode_occ_u8_hdr (:564-578): sorted leaf codes ->
//                      level-major occupancy bytes with the per-level
//                      node counts in front (B3 + B4),
//   octree_expand   <- _expand_level (:601-628), looped by
//                      decode_expand_stream (:631-659): one decoder level,
//                      node codes and occupancy bytes -> child codes (B5).
// Their plain PyTorch versions are ops/octree.py's encode_occ_u8_ref and
// _expand_level_ref, which these equal bit for bit.
//
// What bounds them on an H100: memory, and below it launch latency.
// The occupancy pass must read the N codes (8 B each) and write one byte
// per node (~2 per point): ~10 B a point, ~3 us for the bench's 889,682
// points at 3.35 TB/s.  A decoder level reads its rows' bytes and
// parents' codes and writes its children's codes (8 B each); the stream's
// 11 levels depend on each other in a chain.
//
// * The occupancy pass is two grid passes over tiles of kTile = 4096 rows
//   (256 threads, 16 rows each).  The first counts per tile (each point's
//   first level, as a histogram over the levels) and the last CTA to
//   finish (a ticket on an atomic counter, after a __threadfence: the
//   threadFenceReduction pattern, no CTA ever waits) scans the tile
//   counts into each tile's exclusive prefix and the totals.  The second
//   takes a point's first level from __clzll of c[i] ^ c[i-1] (the
//   reference's clz, which torch lacks), ranks the points of a level with
//   one __ballot_sync a level and round, and ORs each child's octant bit
//   into its node's byte with a 32-bit atomicOr on the zeroed output (the
//   bytes of a word belong to neighbouring nodes).  Octants come from the
//   int64 code, so depth 21 is exact.
// * The expansion's first design ran every level over nmax rows, each
//   thread over 16 consecutive rows, wrote INT64_MAX on every level's
//   padding rows (~11 x 7 MB nothing reads) and summed the earlier
//   levels' counts in every thread.  Here:
//   - Only real rows.  Every level's bytes are in the stream, so one
//     counting launch takes the children of every tile (kXTile = 2048
//     rows) of every level at once: a flat grid over the (level, tile)
//     pairs that hold rows, each level's span (offset, rows = min(count,
//     nmax)) from one warp's scan of the counts, each round's prefix
//     within its tile, and each level's last tile to finish scans the
//     level's tiles: every child's slot is known before any code is.
//     Then a launch a level on a resident grid striding over the level's
//     rounds (its row count read on the device; CTAs with none return at
//     once); the intermediate levels go into two ping-pong buffers with no
//     padding; only the final level writes INT64_MAX (and nmax - 1 as
//     source row) past its count.
//   - Rows to lanes.  In a round of 256 rows lane i takes row base + i
//     (its byte and its parent's code read side by side, coalesced), a
//     block scan of the popcounts places each node's children, and the
//     round's run of children is staged in shared memory and stored
//     contiguously.
//   - The level walk: a launch a level, 1 + depth launches a stream.  One
//     cooperative launch with a grid barrier between levels was measured
//     beside it and was slower (a barrier cost more than a launch in a
//     CUDA graph; PERF.md), so it is not kept.  octree_expand_chain_probe
//     times one link of the chain alone.

// Launcher contract (ops/octree.py): pointers from torch tensors on the
// caller's current stream, sizes as int64, the scratch from torch.empty;
// each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;   // rows per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDepth = 21;                  // 63-bit Morton codes
constexpr long long kI64Max = 0x7fffffffffffffffLL;

__device__ __forceinline__ unsigned lanemask_le() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_le;" : "=r"(m));
  return m;
}

// Exclusive scan of one long long per thread over the CTA; returns the
// thread's prefix and sets *total.  Uses `sh` (kWarps entries).
__device__ long long block_exclusive_scan(long long v, long long* sh,
                                          long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    long long o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  long long before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    long long s = sh[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();                     // sh is reused by the caller
  *total = all;
  return before + inc - v;
}

// The last CTA of a counting pass: `tiles` per-tile counts of `nlev`
// levels (tile-major, cnt[t * nlev + l]) -> exclusive prefixes
// excl[t * nlev + l] and totals tot[l].  Reads through L2 (__ldcg): the
// counts were written by other CTAs.
__device__ void scan_tiles(const long long* cnt, long long* excl,
                           long long* tot, long long tiles, int nlev,
                           long long* sh) {
  const long long per = (tiles + kThreads - 1) / kThreads;
  const long long t0 = threadIdx.x * per;
  const long long t1 = min(tiles, t0 + per);
  for (int l = 0; l < nlev; ++l) {
    long long s = 0;
    for (long long t = t0; t < t1; ++t) s += __ldcg(cnt + t * nlev + l);
    long long total;
    long long run = block_exclusive_scan(s, sh, &total);
    for (long long t = t0; t < t1; ++t) {
      excl[t * nlev + l] = run;
      run += __ldcg(cnt + t * nlev + l);
    }
    if (threadIdx.x == 0) tot[l] = total;
  }
}

// True in the one CTA that finishes a counting pass last.
__device__ bool last_to_finish(unsigned* ticket, unsigned ctas) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == ctas - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ---- octree_occ_u8 ----------------------------------------------------

// First level at which sorted point i opens a node: 0 for point 0,
// depth + 1 for a duplicate, else max(depth - msb(c[i] ^ c[i-1]) / 3, 1)
// (ops/octree.py:_min_levels_ref, the reference's clz formula).
__device__ __forceinline__ int first_level(const long long* c, long long i,
                                           int depth) {
  if (i == 0) return 0;
  unsigned long long x = (unsigned long long)c[i] ^
                         (unsigned long long)c[i - 1];
  if (x == 0) return depth + 1;
  int lv = depth - (63 - __clzll((long long)x)) / 3;
  return lv < 1 ? 1 : lv;
}

struct OccScratch {      // all long long, tile-major
  unsigned* ticket;      // zeroed by the launcher
  long long* cnt;        // (tiles, depth) points first at level <= l
  long long* excl;       // (tiles, depth) exclusive prefixes of cnt
  long long* tot;        // (depth,) nodes per level
};

__global__ void __launch_bounds__(kThreads)
octree_occ_count_kernel(const long long* __restrict__ c, long long n,
                        int depth, OccScratch s, unsigned* __restrict__ hdr,
                        long long tiles) {
  __shared__ int hist[kMaxDepth + 2];
  __shared__ long long sh[kWarps];
  if (threadIdx.x < kMaxDepth + 2) hist[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  for (int k = 0; k < kPerThread; ++k) {
    long long i = base + k * kThreads + threadIdx.x;
    if (i < n) {
      int lv = first_level(c, i, depth);
      if (lv < depth) atomicAdd(&hist[lv], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long run = 0;
    for (int l = 0; l < depth; ++l) {
      run += hist[l];
      s.cnt[blockIdx.x * (long long)depth + l] = run;
    }
  }
  if (!last_to_finish(s.ticket, gridDim.x)) return;
  scan_tiles(s.cnt, s.excl, s.tot, tiles, depth, sh);
  __syncthreads();
  // the counts header: uint32, little-endian as the card stores them
  if (threadIdx.x < depth) hdr[threadIdx.x] = (unsigned)s.tot[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
octree_occ_scatter_kernel(const long long* __restrict__ c, long long n,
                          int depth, OccScratch s,
                          unsigned* __restrict__ words, long long cap) {
  __shared__ unsigned bal[kMaxDepth][kWarps];
  __shared__ long long wo[kMaxDepth][kWarps];
  __shared__ long long run[kMaxDepth];
  __shared__ long long offs[kMaxDepth];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < depth) {
    long long o = 0;
    for (int l = 0; l < threadIdx.x; ++l) o += s.tot[l];
    offs[threadIdx.x] = o;
    run[threadIdx.x] = s.excl[blockIdx.x * (long long)depth + threadIdx.x];
  }
  const long long hdr_bytes = 4LL * depth;
  const long long base = (long long)blockIdx.x * kTile;
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    const bool valid = i < n;
    const int lv = valid ? first_level(c, i, depth) : depth + 2;
    const long long ci = valid ? c[i] : 0;
    __syncthreads();                  // wo/bal of the last round are read
    for (int l = 0; l < depth; ++l) {
      unsigned b = __ballot_sync(0xffffffffu, lv <= l);
      if (lane == 0) bal[l][warp] = b;
    }
    __syncthreads();
    if (threadIdx.x < depth) {
      const int l = threadIdx.x;
      long long r = run[l];
      for (int w = 0; w < kWarps; ++w) {
        wo[l][w] = r;
        r += __popc(bal[l][w]);
      }
      run[l] = r;
    }
    __syncthreads();
    // point i is the first of its child node at level l + 1 for every
    // l >= lv - 1: OR its octant into its level-l node's byte
    for (int l = lv > 0 ? lv - 1 : 0; l < depth; ++l) {
      const long long seg = wo[l][warp] + __popc(bal[l][warp] &
                                                 lanemask_le()) - 1;
      const long long dest = offs[l] + seg;
      if (dest < cap) {
        const int oct = (int)(((unsigned long long)ci >>
                               (3 * (depth - 1 - l))) & 7);
        const long long pos = hdr_bytes + dest;
        atomicOr(words + (pos >> 2), (1u << oct) << (8 * (pos & 3)));
      }
    }
  }
}

// ---- octree_expand -----------------------------------------------------

constexpr int kXThreads = 256;                 // a round: one row a lane
constexpr int kXRounds = 8;                    // rounds a counting tile
constexpr int kXTile = kXThreads * kXRounds;   // rows a counting CTA
constexpr int kXWarps = kXThreads / 32;
constexpr int kXBuf = kXThreads * 8;           // children a round, at most

// Where the levels' bytes come from: the level-major stream (counts
// given: level l's row r reads occ[min(off_l + r, cap - 1)] below
// min(counts[l], nmax), off_l the counts before l), or one whole (nmax,)
// array (counts null, one level).
struct XStream {
  const unsigned char* occ;
  long long cap;           // bytes in occ
  const int* counts;       // (levels,) node counts, or null
  long long nmax;          // output rows
  int levels;
};

struct XScratch {          // long long words
  unsigned* tickets;       // (levels,) zeroed by the launcher
  long long* off;          // (levels,) off_l
  long long* rows;         // (levels,) rows with a byte: min(count, nmax)
  long long* pre;          // (levels, rounds) a round's prefix in its tile
  long long* cnt;          // (levels, tiles) children a counting tile
  long long* excl;         // (levels, tiles) exclusive prefixes
  long long* tot;          // (levels,) children a level (not clamped)
};

long long rounds_of(long long nrows) {
  return (nrows + kXThreads - 1) / kXThreads;
}

// scratch: 3 levels + levels (rounds + 2 tiles) long longs
XScratch x_scratch(void* scratch, void* tot, int levels, long long rounds) {
  long long* sc = (long long*)scratch;
  const long long tiles = (rounds + kXRounds - 1) / kXRounds;
  long long* pre = sc + 3 * levels;
  long long* cnt = pre + levels * rounds;
  long long* excl = cnt + levels * tiles;
  return XScratch{(unsigned*)sc, sc + levels, sc + 2 * levels, pre, cnt,
                  excl, (long long*)tot};
}

// Warp 0: every level's (off_l, rows_l) at once, lane l taking level l
// (a shuffle scan of the counts), into off and rows (shared memory).
__device__ __forceinline__ void level_spans(const XStream& s, long long* off,
                                            long long* rows) {
  const int lane = threadIdx.x;
  const long long c =
      s.counts != nullptr && lane < s.levels ? s.counts[lane] : 0;
  long long inc = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane < s.levels) {
    off[lane] = s.counts != nullptr ? inc - c : 0;
    rows[lane] = s.counts != nullptr ? min(c, s.nmax) : s.nmax;
  }
}

__device__ __forceinline__ unsigned occ_byte(const XStream& s, long long off,
                                             long long rows, long long r) {
  return r < rows ? s.occ[min(off + r, s.cap - 1)] : 0u;
}

// Counting tile t of a level (kXRounds rounds): each round's children,
// their exclusive prefix within the tile into pre, the tile's sum into
// cnt[t] (rounds past the level's rows count 0).  All threads of the CTA.
__device__ void count_tile(const XStream& s, long long off, long long rows,
                           long long t, long long rounds, long long* pre,
                           long long* cnt) {
  __shared__ int part[kXRounds][kXWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned b[kXRounds];
#pragma unroll
  for (int k = 0; k < kXRounds; ++k)
    b[k] = occ_byte(s, off, rows, (t * kXRounds + k) * kXThreads +
                                      threadIdx.x);
#pragma unroll
  for (int k = 0; k < kXRounds; ++k) {
    const int c = __reduce_add_sync(0xffffffffu, (unsigned)__popc(b[k]));
    if (lane == 0) part[k][warp] = c;
  }
  __syncthreads();
  if (threadIdx.x < 32) {              // lane k: round k
    long long sum = 0;
    if (lane < kXRounds) {
#pragma unroll
      for (int w = 0; w < kXWarps; ++w) sum += part[lane][w];
    }
    long long inc = sum;
#pragma unroll
    for (int d = 1; d < kXRounds; d <<= 1) {
      const long long o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    const long long round = t * kXRounds + lane;
    if (lane < kXRounds && round < rounds) pre[round] = inc - sum;
    if (lane == kXRounds - 1) cnt[t] = inc;
  }
  __syncthreads();                     // part is reused by the next tile
}

// Round t of a level: lane i takes row 256 t + i (its byte and parent
// code read coalesced), a block scan of the popcounts places each node's
// children (its set bits, lowest first: code (node << 3) | bit) in the
// round's run, which the CTA stages in shared memory and stores
// contiguously from the round's prefix on; slots >= nmax are dropped.
// prev: the level above's codes, rows >= prev_rows INT64_MAX; null at the
// root (row 0 code 0, every other INT64_MAX).  kSrc: also each slot's
// parent row.
template <bool kSrc>
__device__ void expand_round(const XStream& s, const XScratch& x,
                             long long rounds, int l, long long off,
                             long long rows, long long t,
                             const long long* prev, long long prev_rows,
                             long long* out, long long* src,
                             unsigned long long* code_buf, int* row_buf,
                             long long* sh) {
  const long long tiles = (rounds + kXRounds - 1) / kXRounds;
  const long long base = __ldcg(x.excl + l * tiles + t / kXRounds) +
                         __ldcg(x.pre + l * rounds + t);
  const long long r = t * kXThreads + threadIdx.x;
  unsigned b = occ_byte(s, off, rows, r);
  long long node;                      // loaded beside the byte
  if (prev)
    node = r < prev_rows ? __ldcg(prev + r) : kI64Max;
  else
    node = r == 0 ? 0 : kI64Max;
  long long run;
  long long e = block_exclusive_scan(__popc(b), sh, &run);
  const unsigned long long up = (unsigned long long)node << 3;
  while (b) {
    const int bit = __ffs(b) - 1;
    b &= b - 1;
    code_buf[e] = up | (unsigned long long)bit;
    if (kSrc) row_buf[e] = (int)r;
    ++e;
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < run; i += kXThreads) {
    const long long slot = base + i;
    if (slot < s.nmax) {
      out[slot] = (long long)code_buf[i];
      if (kSrc) src[slot] = row_buf[i];
    }
  }
  __syncthreads();                     // the buffers are written again
}

// The final level's padding rows of round t's range of the output:
// INT64_MAX, and nmax - 1 as their source row.
__device__ __forceinline__ void pad_round(const XStream& s, long long total,
                                          long long t, long long* out,
                                          long long* src) {
  const long long r = t * kXThreads + threadIdx.x;
  if (r >= total && r < s.nmax) {
    out[r] = kI64Max;
    if (src) src[r] = s.nmax - 1;
  }
}

// The counting launch, a flat grid over every level's counting tiles (a
// CTA a (level, tile) pair holding rows, striding when the grid is
// short): each round's and tile's children, then the last tile of each
// level to finish scans that level's tiles.  CTA 0 writes every level's
// span, and a zero count for a level with no rows.
__global__ void __launch_bounds__(kXThreads)
octree_expand_count_kernel(XStream s, XScratch x, long long rounds) {
  __shared__ long long sh[kXWarps];
  __shared__ long long offs[kMaxDepth], rows_of[kMaxDepth];
  __shared__ long long first[kMaxDepth + 1];
  const long long tiles = (rounds + kXRounds - 1) / kXRounds;
  if (threadIdx.x < 32) {
    level_spans(s, offs, rows_of);
    __syncwarp();
    const int lane = threadIdx.x;
    const long long nt =
        lane < s.levels ? (rows_of[lane] + kXTile - 1) / kXTile : 0;
    long long inc = nt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    if (lane <= s.levels) first[lane] = inc - nt;
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x < s.levels) {
    x.off[threadIdx.x] = offs[threadIdx.x];
    x.rows[threadIdx.x] = rows_of[threadIdx.x];
    if (rows_of[threadIdx.x] <= 0) x.tot[threadIdx.x] = 0;
  }
  for (long long i = blockIdx.x; i < first[s.levels]; i += gridDim.x) {
    int l = 0;
    while (first[l + 1] <= i) ++l;
    const long long t = i - first[l];
    count_tile(s, offs[l], rows_of[l], t, rounds, x.pre + l * rounds,
               x.cnt + l * tiles);
    const long long nt = first[l + 1] - first[l];
    if (last_to_finish(x.tickets + l, (unsigned)nt))
      scan_tiles(x.cnt + l * tiles, x.excl + l * tiles, x.tot + l, nt, 1,
                 sh);
    __syncthreads();
  }
}

// One level, a launch on a resident grid striding over the level's
// rounds (read on the device: CTAs with none return at once).
// prev_rows < 0: the level above's child count, clamped to nmax (the
// stream's walk).  With `final` the CTAs then write the padding rows.
template <bool kSrc>
__global__ void __launch_bounds__(kXThreads)
octree_expand_level_kernel(XStream s, XScratch x, long long rounds, int l,
                           const long long* prev, long long prev_rows,
                           long long* out, long long* src, int final) {
  __shared__ long long sh[kXWarps];
  __shared__ unsigned long long code_buf[kXBuf];
  __shared__ int row_buf[kSrc ? kXBuf : 1];
  const long long rows = x.rows[l];
  const long long nr = (rows + kXThreads - 1) / kXThreads;
  if (blockIdx.x < nr) {
    if (prev_rows < 0) prev_rows = min(x.tot[l - 1], s.nmax);
    const long long off = x.off[l];
    for (long long t = blockIdx.x; t < nr; t += gridDim.x)
      expand_round<kSrc>(s, x, rounds, l, off, rows, t, prev, prev_rows,
                         out, src, code_buf, row_buf, sh);
  }
  if (final) {
    const long long total = x.tot[l];
    for (long long t = blockIdx.x; t < rounds; t += gridDim.x)
      pad_round(s, total, t, out, src);
  }
}

// The chain probe: an empty launch on the level launches' grid, the
// dependency between two level launches (chip_smoke (f)'s chain bound).
__global__ void __launch_bounds__(kXThreads)
octree_expand_chain_probe_kernel() {}

// The resident grid of `kernel` for `rounds` rounds: as many CTAs as fit
// on every SM, at most one a round.
template <typename K>
long long resident_grid(K kernel, long long rounds, cudaError_t* e) {
  int dev = 0, sms = 0, per_sm = 0;
  if ((*e = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*e != cudaSuccess) return 0;
  *e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                     kXThreads, 0);
  if (*e != cudaSuccess) return 0;
  if (per_sm < 1) per_sm = 1;
  const long long fill = (long long)per_sm * sms;
  return rounds < fill ? rounds : fill;
}

}  // namespace

// out_words: the (4 depth + cap) output bytes as uint32 words (rounded
// up), zeroed here; scratch: 2 * tiles * depth + depth + 1 long longs.
extern "C" int octree_occ_u8_launch(const void* codes, long long n, int depth,
                                    long long cap, void* out_words,
                                    long long out_word_count, void* scratch,
                                    void* stream) {
  if (n <= 0 || depth < 1 || depth > kMaxDepth || cap < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = (n + kTile - 1) / kTile;
  long long* sc = (long long*)scratch;
  OccScratch s{(unsigned*)sc, sc + 1, sc + 1 + tiles * depth,
               sc + 1 + 2 * tiles * depth};
  cudaError_t e = cudaMemsetAsync(out_words, 0, out_word_count * 4, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(sc, 0, sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  octree_occ_count_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      (const long long*)codes, n, depth, s, (unsigned*)out_words, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  octree_occ_scatter_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      (const long long*)codes, n, depth, s, (unsigned*)out_words, cap);
  return (int)cudaGetLastError();
}

// The counting pass of `levels` levels at once (levels = depth with
// counts, 1 for a whole array): scratch as x_scratch lays it out
// (rounds: nrows / 256 rounded up), tot (levels,) the children of each
// level.
extern "C" int octree_expand_count_launch(const void* occ, long long cap,
                                          const void* counts, int levels,
                                          long long nrows, void* scratch,
                                          void* tot, void* stream) {
  if (nrows <= 0 || nrows >= (1LL << 31) || cap <= 0 || levels < 1 ||
      levels > kMaxDepth)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long rounds = rounds_of(nrows);
  const XScratch x = x_scratch(scratch, tot, levels, rounds);
  cudaError_t e = cudaMemsetAsync(x.tickets, 0, levels * sizeof(long long),
                                  st);
  if (e != cudaSuccess) return (int)e;
  const XStream s{(const unsigned char*)occ, cap, (const int*)counts, nrows,
                  levels};
  // a CTA a counting tile of a level's rows: as many as the bytes hold
  // when the counts fit them (the grid strides otherwise)
  const long long tiles = (nrows + kXTile - 1) / kXTile;
  const long long need = (cap + kXTile - 1) / kXTile + levels;
  const long long grid = need < levels * tiles ? need : levels * tiles;
  octree_expand_count_kernel<<<(unsigned)grid, kXThreads, 0, st>>>(s, x,
                                                                   rounds);
  return (int)cudaGetLastError();
}

// Level l after the counting pass: prev the level above's codes (null at
// the root), prev_rows its valid rows (-1: its child count, clamped to
// nrows); out (nrows,) the children, src (nrows,) their parent rows or
// null; final != 0 pads out (and src) past the level's child count.
extern "C" int octree_expand_level_launch(
    const void* occ, long long cap, const void* counts, int levels, int l,
    long long nrows, void* scratch, void* tot, const void* prev,
    long long prev_rows, void* out, void* src, int final, void* stream) {
  if (nrows <= 0 || nrows >= (1LL << 31) || cap <= 0 || l < 0 ||
      l >= levels || levels > kMaxDepth || (prev_rows < 0 && l == 0))
    return (int)cudaErrorInvalidValue;
  const long long rounds = rounds_of(nrows);
  const XStream s{(const unsigned char*)occ, cap, (const int*)counts, nrows,
                  levels};
  const XScratch x = x_scratch(scratch, tot, levels, rounds);
  cudaError_t e = cudaSuccess;
  const long long grid =
      src ? resident_grid(octree_expand_level_kernel<true>, rounds, &e)
          : resident_grid(octree_expand_level_kernel<false>, rounds, &e);
  if (e != cudaSuccess) return (int)e;
  if (src)
    octree_expand_level_kernel<true><<<(unsigned)grid, kXThreads, 0,
                                       (cudaStream_t)stream>>>(
        s, x, rounds, l, (const long long*)prev, prev_rows, (long long*)out,
        (long long*)src, final);
  else
    octree_expand_level_kernel<false><<<(unsigned)grid, kXThreads, 0,
                                        (cudaStream_t)stream>>>(
        s, x, rounds, l, (const long long*)prev, prev_rows, (long long*)out,
        nullptr, final);
  return (int)cudaGetLastError();
}

// The chain probe: one empty launch on the level launches' grid for nrows
// rows.
extern "C" int octree_expand_chain_probe_launch(long long nrows,
                                                void* stream) {
  if (nrows <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  const long long grid = resident_grid(octree_expand_level_kernel<false>,
                                       rounds_of(nrows), &e);
  if (e != cudaSuccess) return (int)e;
  octree_expand_chain_probe_kernel<<<(unsigned)grid, kXThreads, 0,
                                     (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
