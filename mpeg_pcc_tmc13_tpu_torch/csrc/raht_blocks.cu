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
// What bounds it on an H100: memory.  Per block the forward reads 8*C
// values and 8 weights and writes 8*C coefficients, 8 weights and 8 mask
// words: 288 bytes for a 3-channel block against under 200 flops, under
// 1 flop/byte where the card balances at ~20 (67 TFLOP/s fp32 over
// 3.35 TB/s).  The TPU kernel laid
// the batch along the 128-lane axis in (8, C, B) tiles of 256 blocks; here
// one thread owns one block and keeps its 8 weights, 7 pair coefficients
// and 8 values per channel in registers, so nothing but the inputs and
// outputs touches memory and no shared memory or synchronisation is
// needed.  The (B, 8, C) layout of the public API is read as is (a thread
// reads its block's 8*C contiguous floats); coalescing through shared
// memory and fusing the level gather into the kernel are later work.
//
// Numerics: the products and sums use __fmul_rn/__fadd_rn/__fsub_rn, which
// nvcc never contracts into FMAs, and sqrtf and '/' are IEEE (no fast
// math), so the kernel rounds exactly like the plain PyTorch version in
// ops/raht_blocks.py.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (ops/_kernels.py does it on first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
raht_fwd_blocks_kernel(const float* __restrict__ vals,
                       const float* __restrict__ weights,
                       float* __restrict__ coeffs,
                       float* __restrict__ wout,
                       int32_t* __restrict__ mask,
                       int64_t nblocks, int nchan) {
  const int64_t blk = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (blk >= nblocks) return;

  float w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = weights[blk * 8 + j];
  Pair p[7];
  pair_schedule(w, p);

  const float* vin = vals + blk * 8 * nchan;
  float* vout = coeffs + blk * 8 * nchan;
  for (int c = 0; c < nchan; ++c) {
    float v[8], ac[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = vin[j * nchan + c];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int lo = pair_lo(k), hi = pair_hi(k);
      const float vl = v[lo], vh = v[hi];
      const float dc = __fadd_rn(__fmul_rn(p[k].a, vl), __fmul_rn(p[k].b, vh));
      const float acv =
          __fadd_rn(__fmul_rn(-p[k].b, vl), __fmul_rn(p[k].a, vh));
      v[lo] = p[k].both ? dc : (p[k].only_hi ? vh : vl);
      ac[hi] = p[k].both ? acv : 0.0f;
    }
    vout[c] = v[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) vout[j * nchan + c] = ac[j];
  }

  wout[blk * 8] = w[0];
  mask[blk * 8] = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    wout[blk * 8 + pair_hi(k)] = 0.0f;
    mask[blk * 8 + pair_hi(k)] = p[k].both ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
raht_inv_blocks_kernel(const float* __restrict__ coeffs,
                       const float* __restrict__ weights,
                       float* __restrict__ out,
                       int64_t nblocks, int nchan) {
  const int64_t blk = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (blk >= nblocks) return;

  float w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = weights[blk * 8 + j];
  Pair p[7];
  pair_schedule(w, p);

  const float* cin = coeffs + blk * 8 * nchan;
  float* vout = out + blk * 8 * nchan;
  for (int c = 0; c < nchan; ++c) {
    float ac[8], v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) ac[j] = cin[j * nchan + c];
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
    for (int j = 0; j < 8; ++j) vout[j * nchan + c] = v[j];
  }
}

}  // namespace

// Plain C launchers for ctypes.  Pointers are device pointers of
// contiguous tensors: vals/coeffs (B, 8, C) float32, weights/wout (B, 8)
// float32, mask (B, 8) int32.  They enqueue on `stream`, do not
// synchronise, and return cudaGetLastError() of the launch.

extern "C" int raht_fwd_blocks_launch(const void* vals, const void* weights,
                                      void* coeffs, void* wout, void* mask,
                                      int64_t nblocks, int nchan,
                                      void* stream) {
  if (nblocks <= 0 || nchan <= 0) return (int)cudaErrorInvalidValue;
  const int64_t grid = (nblocks + kThreads - 1) / kThreads;
  raht_fwd_blocks_kernel<<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)vals, (const float*)weights, (float*)coeffs,
      (float*)wout, (int32_t*)mask, nblocks, nchan);
  return (int)cudaGetLastError();
}

extern "C" int raht_inv_blocks_launch(const void* coeffs, const void* weights,
                                      void* out, int64_t nblocks, int nchan,
                                      void* stream) {
  if (nblocks <= 0 || nchan <= 0) return (int)cudaErrorInvalidValue;
  const int64_t grid = (nblocks + kThreads - 1) / kThreads;
  raht_inv_blocks_kernel<<<(unsigned)grid, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)coeffs, (const float*)weights, (float*)out, nblocks,
      nchan);
  return (int)cudaGetLastError();
}
