// RAHT 2x2x2 block butterflies, forward and inverse, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of mpeg_pcc_tmc13_tpu/ops/pallas_raht.py:
//   raht_fwd_blocks_kernel <- _block_kernel      (via fwd_blocks, :48-82)
//   raht_inv_blocks_kernel <- _inv_block_kernel  (via inv_blocks, :140-174)
//
// Each block holds up to 8 children (slots 0..7, octant x<<2|y<<1|z) with
// C channel values and one weight each.  Three dyadic stages of weighted
// butterflies merge them: z (0,1)(2,3)(4,5)(6,7), y (0,2)(4,6), x (0,4):
//   dc = ( sqrt(wl) vl + sqrt(wh) vh) / sqrt(wl+wh)
//   ac = (-sqrt(wh) vl + sqrt(wl) vh) / sqrt(wl+wh)
// An empty partner passes its value through; a lone hi slot collapses
// into the lo slot.  The block DC lands in slot 0, each merged pair's AC
// stays in its hi slot.
//
// What bounds it on an H100: memory, and close behind it the issue rate.
// Per block the forward reads 8*C values and 8 weights and writes 8*C
// coefficients, 8 weights and 8 mask words: 288 bytes for a 3-channel
// block.  Its 7 pairs need 21 IEEE square roots and 14 IEEE divisions
// (the plain version's rounding has to be matched, so no rsqrt or
// reciprocal shortcuts), some 600 instructions a block: at the card's
// ~2.9e13 thread instructions a second that is about a third of the
// memory time, so the design must not multiply it.
//
// * One thread computes one block, all 7 pairs, keeping its 8 weights, 7
//   pair coefficients and 8 values per channel in registers: the least
//   arithmetic a block can take.
// * Every global access is warp-contiguous.  A thread block of 128
//   threads owns 128 consecutive blocks, whose values (128*8*C floats),
//   weights and outputs are each one contiguous run.  The threads copy a
//   run between global and shared memory with a linear loop (lane i on
//   word i, 128 contiguous bytes per warp instruction; a full tile of a
//   compile-time C issues all of a thread's loads before its first store,
//   so they are in flight together).  In shared memory block r's row
//   starts at r*(8C+1): the pad word makes the row stride odd, so when
//   thread r reads or writes its own row the 32 lanes of a warp hit 32
//   banks.
// * The channel count is a template argument, instantiated for the
//   colour (3) and reflectance (1) lanes, the counts the codec passes,
//   so the channel and copy loops unroll; the wrapper sends any other
//   count through these two in runs of 3 and 1 channels.  A ragged last tile
//   copies only its rows, and threads past the end skip the arithmetic.
//
// A first design mapped one thread to each (block, slot) and ran the
// stages as __shfl_xor_sync exchanges at distances 1, 2, 4.  Its memory
// pattern was the same, but every lane of a pair computed the pair's
// square roots and divisions, and lanes that had left the schedule
// computed them too: about 4x this kernel's instructions, which made the
// pass issue-bound, well above its memory time.  cp.async/TMA copies
// would cut the copy instructions further; they are a small share here.
//
// Numerics: the products and sums use __fmul_rn/__fadd_rn/__fsub_rn, which
// nvcc never contracts into FMAs, sqrtf and '/' are IEEE (no fast math),
// and the operations run in the plain version's order, so the kernel
// rounds exactly like ops/raht_blocks.py's fwd_blocks_ref/inv_blocks_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (ops/_kernels.py does it on first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlocks = 128;   // RAHT blocks (= threads) per thread block

// slots (lo, hi) of butterfly k, stage by stage: z (0,1)(2,3)(4,5)(6,7),
// y (0,2)(4,6), x (0,4).  Every loop over k is unrolled, so these fold to
// constants and v[lo]/v[hi] stay in registers.
__device__ __forceinline__ constexpr int pair_lo(int k) {
  return k < 4 ? 2 * k : (k < 6 ? 4 * (k - 4) : 0);
}
__device__ __forceinline__ constexpr int pair_hi(int k) {
  return k < 4 ? 2 * k + 1 : (k < 6 ? 4 * (k - 4) + 2 : 4);
}

struct Pair {
  float a, b;    // sqrt(wl)/sqrt(wl+wh), sqrt(wh)/sqrt(wl+wh)
  bool both;     // both children present: a real butterfly
  bool only_hi;  // lone hi child: collapses into lo
};

// Runs the forward weight recursion on w[8] in place and returns the
// coefficients of the 7 butterflies in stage order.
__device__ __forceinline__ void pair_schedule(float w[8], Pair p[7]) {
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int lo = pair_lo(k), hi = pair_hi(k);
    const float wl = w[lo], wh = w[hi];
    const float rs = sqrtf(fmaxf(__fadd_rn(wl, wh), 1e-30f));
    p[k].a = sqrtf(fmaxf(wl, 0.0f)) / rs;
    p[k].b = sqrtf(fmaxf(wh, 0.0f)) / rs;
    p[k].both = (wl > 0.0f) && (wh > 0.0f);
    p[k].only_hi = (wl <= 0.0f) && (wh > 0.0f);
    w[lo] = p[k].both ? __fadd_rn(wl, wh) : (p[k].only_hi ? wh : wl);
  }
}

// Copies `rows` rows of kW 4-byte words between a contiguous global run
// and a shared tile whose rows are kW + 1 words apart.
template <int kW, typename T>
__device__ __forceinline__ void load_rows(T* tile, const T* __restrict__ src,
                                          int rows) {
  if (rows == kBlocks) {
    T r[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) r[k] = src[threadIdx.x + k * kBlocks];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int i = threadIdx.x + k * kBlocks;
      tile[i + i / kW] = r[k];
    }
  } else {
    const int n = rows * kW;
    for (int i = threadIdx.x; i < n; i += kBlocks) tile[i + i / kW] = src[i];
  }
}

template <int kW, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const T* tile, int rows) {
  if (rows == kBlocks) {
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      const int i = threadIdx.x + k * kBlocks;
      dst[i] = tile[i + i / kW];
    }
  } else {
    const int n = rows * kW;
    for (int i = threadIdx.x; i < n; i += kBlocks) dst[i] = tile[i + i / kW];
  }
}

template <int kC>
__global__ void __launch_bounds__(kBlocks)
raht_fwd_blocks_kernel(const float* __restrict__ vals,
                       const float* __restrict__ weights,
                       float* __restrict__ coeffs,
                       float* __restrict__ wout,
                       int32_t* __restrict__ mask,
                       int64_t nblocks) {
  extern __shared__ float smem[];
  constexpr int C = kC, W = 8 * kC;
  float* vt = smem;                                   // kBlocks x (W + 1)
  float* wt = vt + kBlocks * (W + 1);                 // kBlocks x 9
  int32_t* mt = (int32_t*)(wt + kBlocks * 9);         // kBlocks x 9
  const int64_t blk0 = (int64_t)blockIdx.x * kBlocks;
  const int rows = (int)min((int64_t)kBlocks, nblocks - blk0);

  load_rows<W>(vt, vals + blk0 * W, rows);
  load_rows<8>(wt, weights + blk0 * 8, rows);
  __syncthreads();

  const int r = threadIdx.x;
  if (r < rows) {
    float* vrow = vt + r * (W + 1);
    float* wrow = wt + r * 9;
    int32_t* mrow = mt + r * 9;
    float w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = wrow[j];
    Pair p[7];
    pair_schedule(w, p);

#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v[8], ac[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = vrow[j * C + c];
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int lo = pair_lo(k), hi = pair_hi(k);
        const float vl = v[lo], vh = v[hi];
        const float dc =
            __fadd_rn(__fmul_rn(p[k].a, vl), __fmul_rn(p[k].b, vh));
        const float acv =
            __fadd_rn(__fmul_rn(-p[k].b, vl), __fmul_rn(p[k].a, vh));
        v[lo] = p[k].both ? dc : (p[k].only_hi ? vh : vl);
        ac[hi] = p[k].both ? acv : 0.0f;
      }
      vrow[c] = v[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) vrow[j * C + c] = ac[j];
    }

    wrow[0] = w[0];
    mrow[0] = 0;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      wrow[pair_hi(k)] = 0.0f;
      mrow[pair_hi(k)] = p[k].both ? 1 : 0;
    }
  }
  __syncthreads();

  store_rows<W>(coeffs + blk0 * W, vt, rows);
  store_rows<8>(wout + blk0 * 8, wt, rows);
  store_rows<8>(mask + blk0 * 8, mt, rows);
}

template <int kC>
__global__ void __launch_bounds__(kBlocks)
raht_inv_blocks_kernel(const float* __restrict__ coeffs,
                       const float* __restrict__ weights,
                       float* __restrict__ out,
                       int64_t nblocks) {
  extern __shared__ float smem[];
  constexpr int C = kC, W = 8 * kC;
  float* vt = smem;                                   // kBlocks x (W + 1)
  float* wt = vt + kBlocks * (W + 1);                 // kBlocks x 9
  const int64_t blk0 = (int64_t)blockIdx.x * kBlocks;
  const int rows = (int)min((int64_t)kBlocks, nblocks - blk0);

  load_rows<W>(vt, coeffs + blk0 * W, rows);
  load_rows<8>(wt, weights + blk0 * 8, rows);
  __syncthreads();

  const int r = threadIdx.x;
  if (r < rows) {
    float* vrow = vt + r * (W + 1);
    const float* wrow = wt + r * 9;
    float w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = wrow[j];
    Pair p[7];
    pair_schedule(w, p);

#pragma unroll
    for (int c = 0; c < C; ++c) {
      float ac[8], v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) ac[j] = vrow[j * C + c];
      v[0] = ac[0];
      // undo the butterflies top-down: x, then y, then z
#pragma unroll
      for (int k = 6; k >= 0; --k) {
        const int lo = pair_lo(k), hi = pair_hi(k);
        const float dc = v[lo], a = p[k].a, b = p[k].b;
        const float v1 = __fsub_rn(__fmul_rn(a, dc), __fmul_rn(b, ac[hi]));
        const float v2 = __fadd_rn(__fmul_rn(b, dc), __fmul_rn(a, ac[hi]));
        v[lo] = p[k].both ? v1 : dc;
        v[hi] = p[k].both ? v2 : (p[k].only_hi ? dc : 0.0f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) vrow[j * C + c] = v[j];
    }
  }
  __syncthreads();

  store_rows<W>(out + blk0 * W, vt, rows);
}

unsigned grid_for(int64_t nblocks) {
  return (unsigned)((nblocks + kBlocks - 1) / kBlocks);
}

// the value tile plus `word_tiles` tiles of 8 words a block (+1 pad each)
size_t tile_bytes(int nchan, int word_tiles) {
  return (size_t)kBlocks * (8 * nchan + 1 + 9 * word_tiles) * 4;
}

template <int kC>
void launch_fwd(const void* vals, const void* weights, void* coeffs,
                void* wout, void* mask, int64_t nblocks, cudaStream_t s) {
  raht_fwd_blocks_kernel<kC>
      <<<grid_for(nblocks), kBlocks, tile_bytes(kC, 2), s>>>(
          (const float*)vals, (const float*)weights, (float*)coeffs,
          (float*)wout, (int32_t*)mask, nblocks);
}

template <int kC>
void launch_inv(const void* coeffs, const void* weights, void* out,
                int64_t nblocks, cudaStream_t s) {
  raht_inv_blocks_kernel<kC>
      <<<grid_for(nblocks), kBlocks, tile_bytes(kC, 1), s>>>(
          (const float*)coeffs, (const float*)weights, (float*)out, nblocks);
}

}  // namespace

// Plain C launchers for ctypes.  Pointers are device pointers of
// contiguous tensors: vals/coeffs (B, 8, C) float32, weights/wout (B, 8)
// float32, mask (B, 8) int32, C = 1 or 3.  They enqueue on `stream`, do
// not synchronise, and return cudaGetLastError() of the launch.

extern "C" int raht_fwd_blocks_launch(const void* vals, const void* weights,
                                      void* coeffs, void* wout, void* mask,
                                      int64_t nblocks, int nchan,
                                      void* stream) {
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nchan == 1)
    launch_fwd<1>(vals, weights, coeffs, wout, mask, nblocks, s);
  else if (nchan == 3)
    launch_fwd<3>(vals, weights, coeffs, wout, mask, nblocks, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int raht_inv_blocks_launch(const void* coeffs, const void* weights,
                                      void* out, int64_t nblocks, int nchan,
                                      void* stream) {
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nchan == 1)
    launch_inv<1>(coeffs, weights, out, nblocks, s);
  else if (nchan == 3)
    launch_inv<3>(coeffs, weights, out, nblocks, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
