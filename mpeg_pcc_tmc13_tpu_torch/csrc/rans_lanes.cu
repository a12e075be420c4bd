// The lane loops of the interleaved-rANS geometry engine, for Hopper
// (sm_90a).
//
// Replace three XLA loops of mpeg_pcc_tmc13_tpu/ops/octree_rans.py that
// torch has no primitive for (their plain PyTorch versions are in
// ops/rans_lanes.py, and each kernel is bit-identical to its version):
//   rans_quantize_tables_kernel <- _quantize_cfull          (:144-161)
//   rans_encode_emit_kernel     <- encode_device emission   (:264-290)
//   rans_decode_tiles_kernel    <- decode_device tile loop  (:353-391)
//
// rANS parameters as in the reference: u32 state in [2^16, 2^32), 16-bit
// renormalisation words, probability precision M = 2^14, 2048 contexts of
// 256 cumulative-frequency entries each (c[0] = 0, c[255] = M).
//
// What bounds them on an H100: none moves much data.  The encoder's
// emission and the decoder's tiles are serial chains (one rANS state per
// lane, G ~ 1,800 dependent steps at the bench size), so they are bound by
// the latency of each step, not by bytes or flops.  The design keeps every
// state in a register for the whole chain: the encoder runs all steps of a
// lane in one thread (lanes are independent there, so there is no
// cross-thread traffic at all); the decoder runs one CTA of K <= 1024
// threads per refresh window (lanes share the word stream, so each tile
// needs a block-wide exclusive scan of the lanes that pop a word: ballots
// and popcounts per warp, one shared array of warp totals).  The table
// refresh is 2048 independent 255-long scans: one warp per context row,
// 8 symbols a lane and a warp shuffle scan, int64 arithmetic as the
// reference's.  Making them fast (a persistent decoder across windows and
// levels, the table refresh fused into it) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (ops/_kernels.py does it on first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMBits = 14;
constexpr uint32_t kM = 1u << kMBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kQuantWarps = 8;     // context rows per block of the refresh
constexpr int kEmitThreads = 64;   // lanes per block of the emission

// ---------------------------------------------------------------------
// table refresh: hist (rows, 256) int32 -> c (rows, 256) int32
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kQuantWarps * 32)
rans_quantize_tables_kernel(const int32_t* __restrict__ hist,
                            int32_t* __restrict__ out, int64_t rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kQuantWarps + warp;
  if (row >= rows) return;  // whole warps exit together
  const int32_t* h = hist + row * 256 + lane * 8;
  int64_t cs[8];
  int64_t run = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = lane * 8 + j;
    run += (s == 0) ? 0 : (int64_t)h[j] + 1;  // Laplace prior, no symbol 0
    cs[j] = run;
  }
  // inclusive warp scan of the lanes' sums
  int64_t incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const int64_t excl = incl - run;
  const int64_t tot = __shfl_sync(0xffffffffu, incl, 31);
  int32_t* o = out + row * 256 + lane * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = lane * 8 + j;
    o[j] = (s == 0) ? 0
                    : (int32_t)(s + ((excl + cs[j]) * (int64_t)(kM - 255)) /
                                        tot);
  }
}

// ---------------------------------------------------------------------
// encoder emission: one thread per lane, steps g = G-1 .. 0
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kEmitThreads)
rans_encode_emit_kernel(const int32_t* __restrict__ fsteps,
                        const int32_t* __restrict__ csteps,
                        const int32_t* __restrict__ nvalid,
                        int64_t* __restrict__ states_out,
                        int32_t* __restrict__ words,
                        uint8_t* __restrict__ flags, int64_t nsteps,
                        int lanes) {
  const int lane = blockIdx.x * kEmitThreads + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t s = kRansL;
  for (int64_t g = nsteps - 1; g >= 0; --g) {
    const int64_t at = g * lanes + lane;
    const bool valid = lane < nvalid[g];
    const uint32_t f = valid ? (uint32_t)fsteps[at] : 1u;
    const uint32_t c = (uint32_t)csteps[at];
    const bool emit = valid && s >= (f << (32 - kMBits));
    words[at] = emit ? (int32_t)(s & 0xFFFFu) : 0;
    flags[at] = emit ? 1 : 0;
    const uint32_t x = emit ? (s >> 16) : s;
    const uint32_t q = x / f;
    const uint32_t nxt = (q << kMBits) + (x - q * f) + c;
    s = valid ? nxt : x;
  }
  states_out[lane] = (int64_t)s;
}

// ---------------------------------------------------------------------
// decoder: the tiles of one refresh window, one CTA, one thread per lane
// ---------------------------------------------------------------------
__device__ __forceinline__ int search_sym(const int32_t* __restrict__ c,
                                          uint32_t slot) {
  int pos = 0;
#pragma unroll
  for (int sh = 128; sh >= 1; sh >>= 1) {
    const int cand = pos + sh;
    if (cand <= 255 && (uint32_t)c[cand] <= slot) pos = cand;
  }
  return pos + 1;
}

__global__ void __launch_bounds__(1024)
rans_decode_tiles_kernel(const int32_t* __restrict__ cflat,
                         const int32_t* __restrict__ ctx_row,
                         const int32_t* __restrict__ words, int64_t wcap,
                         int64_t* __restrict__ states,
                         int64_t* __restrict__ cursor_io,
                         int32_t* __restrict__ syms,
                         int32_t* __restrict__ hist, int64_t count,
                         int64_t t0, int ntiles, int lanes) {
  __shared__ int warp_tot[32];
  __shared__ int warp_off[32];
  const int lane = threadIdx.x;
  const int warp = lane >> 5, wl = lane & 31;
  const int nwarps = (blockDim.x + 31) >> 5;
  const bool live = lane < lanes;
  uint32_t st = live ? (uint32_t)states[lane] : 0u;
  int64_t cursor = *cursor_io;
  for (int64_t t = t0; t < t0 + ntiles; ++t) {
    const int64_t at = t * lanes + lane;
    const bool valid = live && at < count;
    int sym = 1;
    int64_t ix = 0;
    uint32_t nst = st;
    bool need = false;
    if (live) {
      const int64_t ctx = ctx_row[at];
      const uint32_t slot = st & (kM - 1);
      sym = search_sym(cflat + ctx * 256, slot);
      ix = ctx * 256 + sym;
      const uint32_t lo = (uint32_t)cflat[ix - 1];
      const uint32_t f = (uint32_t)cflat[ix] - lo;
      nst = f * (st >> kMBits) + slot - lo;
      need = valid && nst < kRansL;
    }
    // exclusive rank of this lane among the lanes that pop a word
    const unsigned ballot = __ballot_sync(0xffffffffu, need);
    const int rank_in_warp = __popc(ballot & ((1u << wl) - 1u));
    if (wl == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    if (lane == 0) {
      int acc = 0;
      for (int w = 0; w < nwarps; ++w) {
        warp_off[w] = acc;
        acc += warp_tot[w];
      }
      warp_tot[0] = acc;  // the tile's word count, read below
    }
    __syncthreads();
    if (need) {
      int64_t widx = cursor + warp_off[warp] + rank_in_warp;
      if (widx > wcap - 1) widx = wcap - 1;
      nst = (nst << 16) | (uint32_t)words[widx];
    }
    if (valid) {
      st = nst;
      atomicAdd(&hist[ix], 1);
    }
    if (live) syms[at] = valid ? sym : 1;
    cursor += warp_tot[0];
    __syncthreads();  // warp_tot/warp_off are rewritten by the next tile
  }
  if (live) states[lane] = (int64_t)st;
  if (lane == 0) *cursor_io = cursor;
}

}  // namespace

// Plain C launchers for ctypes.  Pointers are device pointers of
// contiguous tensors; see ops/rans_lanes.py for the layouts.  They
// enqueue on `stream`, do not synchronise, and return cudaGetLastError()
// of the launch.

extern "C" int rans_quantize_tables_launch(const void* hist, void* out,
                                           int64_t rows, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const int64_t grid = (rows + kQuantWarps - 1) / kQuantWarps;
  rans_quantize_tables_kernel<<<(unsigned)grid, kQuantWarps * 32, 0,
                                (cudaStream_t)stream>>>(
      (const int32_t*)hist, (int32_t*)out, rows);
  return (int)cudaGetLastError();
}

extern "C" int rans_encode_emit_launch(const void* fsteps, const void* csteps,
                                       const void* nvalid, void* states,
                                       void* words, void* flags,
                                       int64_t nsteps, int lanes,
                                       void* stream) {
  if (lanes <= 0 || nsteps < 0) return (int)cudaErrorInvalidValue;
  const int grid = (lanes + kEmitThreads - 1) / kEmitThreads;
  rans_encode_emit_kernel<<<grid, kEmitThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)fsteps, (const int32_t*)csteps, (const int32_t*)nvalid,
      (int64_t*)states, (int32_t*)words, (uint8_t*)flags, nsteps, lanes);
  return (int)cudaGetLastError();
}

extern "C" int rans_decode_tiles_launch(const void* cflat, const void* ctx_row,
                                        const void* words, int64_t wcap,
                                        void* states, void* cursor, void* syms,
                                        void* hist, int64_t count, int64_t t0,
                                        int ntiles, int lanes, void* stream) {
  if (lanes <= 0 || lanes > 1024 || ntiles <= 0 || wcap <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = (lanes + 31) / 32 * 32;
  rans_decode_tiles_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cflat, (const int32_t*)ctx_row, (const int32_t*)words,
      wcap, (int64_t*)states, (int64_t*)cursor, (int32_t*)syms,
      (int32_t*)hist, count, t0, ntiles, lanes);
  return (int)cudaGetLastError();
}
