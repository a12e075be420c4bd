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
// What bounds them on an H100: memory, and far below it launch latency.
// The occupancy pass must read the N codes (8 B each) and write one byte
// per node (~2 per point): ~10 B a point, ~3 us for the bench's 889,682
// points at 3.35 TB/s.  A level of the expansion reads one byte and
// writes a code (8 B, plus 8 B of source row where asked) per row.  So
// the design keeps the int64 (depth, N) intermediates of the plain
// versions out of device memory altogether:
//
// * Both are two grid passes over tiles of kTile = 4096 rows (256
//   threads, 16 rows each).  The first pass counts per tile (the
//   occupancy pass: each point's first level, as a histogram over the
//   levels; the expansion: the children of the tile's nodes) and the
//   last CTA to finish (a ticket on an atomic counter, after a
//   __threadfence: the threadFenceReduction pattern, no CTA ever waits)
//   scans the tile counts into each tile's exclusive prefix and the
//   totals.  The second pass scans within its tile (warp ballots or a
//   shuffle scan, then the warps' sums in shared memory) and adds the
//   tile's prefix: every node's slot is known in closed form.
// * The occupancy pass takes a point's first level from __clzll of
//   c[i] ^ c[i-1] (the reference's clz, which torch lacks), ranks the
//   points of a level with one __ballot_sync a level and round, and ORs
//   each child's octant bit into its node's byte with a 32-bit atomicOr
//   on the zeroed output (the bytes of a word belong to neighbouring
//   nodes).  Octants come from the int64 code, so depth 21 is exact.
// * The expansion scatters: the node of row j writes its r-th child at
//   starts[j] + r, walking its set bits in order, and each tile writes
//   the padding rows (>= the child count) of its own row range, so no
//   pass fills the outputs first.  The decoder runs the counting pass of
//   every level in one launch (the bytes of all levels are known), then
//   one launch a level.
//
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

// Where a level's bytes come from: a level of the level-major stream
// (counts given: row r reads occ[min(offs[l] + r, cap - 1)] below
// counts[l], else 0), or a whole (nrows,) array (counts null).
struct OccLevel {
  const unsigned char* occ;
  long long cap;           // bytes in occ
  const int* counts;       // (depth,) node counts, or null
  long long nrows;         // rows of a level (nmax)
};

// (offset, rows with a byte) of level l
__device__ __forceinline__ void level_span(const OccLevel& s, int l,
                                           long long* off, long long* cnt) {
  if (s.counts == nullptr) {
    *off = 0;
    *cnt = s.nrows;
    return;
  }
  long long o = 0;
  for (int k = 0; k < l; ++k) o += s.counts[k];
  *off = o;
  *cnt = s.counts[l];
}

__device__ __forceinline__ unsigned occ_byte(const OccLevel& s, long long off,
                                             long long cnt, long long r) {
  if (r >= cnt) return 0;
  return s.occ[min(off + r, s.cap - 1)];
}

struct ExpandScratch {
  unsigned* tickets;     // (levels,) zeroed by the launcher
  long long* cnt;        // (levels, tiles) children per tile
  long long* excl;       // (levels, tiles) exclusive prefixes
  long long* tot;        // (levels,) children per level
};

// grid (tiles, levels): children per tile of every level, then each
// level's last CTA scans them
__global__ void __launch_bounds__(kThreads)
octree_expand_count_kernel(OccLevel src, ExpandScratch s, long long tiles) {
  __shared__ long long sh[kWarps];
  const int l = blockIdx.y;
  long long off, cnt;
  level_span(src, l, &off, &cnt);
  const long long r0 = (long long)blockIdx.x * kTile + threadIdx.x *
                       (long long)kPerThread;
  long long mine = 0;
  for (int k = 0; k < kPerThread; ++k) {
    long long r = r0 + k;
    if (r < src.nrows) mine += __popc(occ_byte(src, off, cnt, r));
  }
  long long total;
  block_exclusive_scan(mine, sh, &total);
  if (threadIdx.x == 0) s.cnt[l * tiles + blockIdx.x] = total;
  if (!last_to_finish(s.tickets + l, gridDim.x)) return;
  scan_tiles(s.cnt + l * tiles, s.excl + l * tiles, s.tot + l, tiles, 1,
             sh);
}

// One level: node codes (or the root: row 0 holds code 0, every other
// row INT64_MAX) -> child codes, padded with INT64_MAX; src (may be
// null) the parent row of each child slot, nmax - 1 on padding rows;
// new_cnt the child count (0-d int64).
__global__ void __launch_bounds__(kThreads)
octree_expand_level_kernel(OccLevel src, ExpandScratch s, long long tiles,
                           int l, const long long* __restrict__ nodes,
                           long long* __restrict__ out,
                           long long* __restrict__ src_row,
                           long long* __restrict__ new_cnt) {
  __shared__ long long sh[kWarps];
  long long off, cnt;
  level_span(src, l, &off, &cnt);
  const long long nmax = src.nrows;
  const long long total = s.tot[l];
  const long long r0 = (long long)blockIdx.x * kTile + threadIdx.x *
                       (long long)kPerThread;
  unsigned occ[kPerThread];
  long long mine = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    long long r = r0 + k;
    occ[k] = r < nmax ? occ_byte(src, off, cnt, r) : 0;
    mine += __popc(occ[k]);
  }
  long long all;
  long long start = s.excl[l * tiles + blockIdx.x] +
                    block_exclusive_scan(mine, sh, &all);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long r = r0 + k;
    unsigned b = occ[k];
    if (b) {
      const long long node = nodes ? nodes[r] : (r == 0 ? 0 : kI64Max);
      const unsigned long long up = (unsigned long long)node << 3;
      while (b) {
        const int bit = __ffs(b) - 1;
        b &= b - 1;
        if (start < nmax) {
          out[start] = (long long)(up | (unsigned long long)bit);
          if (src_row) src_row[start] = r;
        }
        ++start;
      }
    }
    if (r < nmax && r >= total) {
      out[r] = kI64Max;
      if (src_row) src_row[r] = nmax - 1;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *new_cnt = total;
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
// counts, 1 for a whole array); scratch: levels * (2 * tiles + 2) long
// longs.
extern "C" int octree_expand_count_launch(const void* occ, long long cap,
                                          const void* counts, int levels,
                                          long long nrows, void* scratch,
                                          void* stream) {
  if (nrows <= 0 || cap <= 0 || levels < 1 || levels > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = (nrows + kTile - 1) / kTile;
  long long* sc = (long long*)scratch;
  ExpandScratch s{(unsigned*)sc, sc + levels, sc + levels + levels * tiles,
                  sc + levels + 2 * levels * tiles};
  cudaError_t e = cudaMemsetAsync(sc, 0, levels * sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  OccLevel src{(const unsigned char*)occ, cap, (const int*)counts, nrows};
  octree_expand_count_kernel<<<dim3((unsigned)tiles, (unsigned)levels),
                               kThreads, 0, st>>>(src, s, tiles);
  return (int)cudaGetLastError();
}

extern "C" int octree_expand_level_launch(const void* occ, long long cap,
                                          const void* counts, int levels,
                                          int l, long long nrows,
                                          void* scratch, const void* nodes,
                                          void* out, void* src_row,
                                          void* new_cnt, void* stream) {
  if (nrows <= 0 || cap <= 0 || l < 0 || l >= levels)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = (nrows + kTile - 1) / kTile;
  long long* sc = (long long*)scratch;
  ExpandScratch s{(unsigned*)sc, sc + levels, sc + levels + levels * tiles,
                  sc + levels + 2 * levels * tiles};
  OccLevel src{(const unsigned char*)occ, cap, (const int*)counts, nrows};
  octree_expand_level_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      src, s, tiles, l, (const long long*)nodes, (long long*)out,
      (long long*)src_row, (long long*)new_cnt);
  return (int)cudaGetLastError();
}
