// Fixed-point RAHT 2x2x2 block butterfly with on-device coefficients, for
// Hopper (sm_90a).
//
// Replaces the XLA program of mpeg_pcc_tmc13_tpu/ops/raht_fp_device.py:
//   raht_fwd_blocks_int_kernel <- fwd_blocks_int (:303-329) with
//                                 isqrt64_dev (:292-300)
// (the integer block stage that parallel/slices.py:sharded_raht_fp_blocks
// runs on every device of the mesh).
//
// Each block holds up to 8 children (slots 0..7) with C int64 Q13 values
// and one int64 subtree weight each (0 = empty slot).  Three stages merge
// pairs (0,1)(2,3)(4,5)(6,7), then the 4 results in pairs, then the 2:
//   ws = max(w0 + w1, 1)
//   a  = isqrt((w0 << 30) / ws),  b = isqrt((w1 << 30) / ws)     (Q15)
//   dc = (a v0 + b v1 + 2^14) >> 15,  ac = (a v1 - b v0 + 2^14) >> 15
// where both weights are non-zero; otherwise the pair passes v0 (w0 > 0)
// or else v1, and its AC is 0.  The merged weight is w0 + w1.  Outputs:
// dc (B, C), acz (B, 4, C), acy (B, 2, C), acx (B, 1, C), all int64.
//
// Exactness against ops/raht_fp_device.py:fwd_blocks_int_ref: the isqrt
// seed is the correctly rounded __dsqrt_rn of the exactly converted double
// (the plain version's float64 sqrt), truncated by the (long long) cast,
// then two integer corrections, each step in the plain version's order.
// The weights are subtree counts, never negative, so the truncating
// integer division equals the plain version's floor division.  Products
// and sums wrap as torch's int64 does (unsigned arithmetic), and the
// rounding shift is arithmetic on the signed result.
//
// What bounds it on an H100: memory.  Per 3-channel block it reads 8*3
// values and 8 weights and writes 8*3 coefficients, 448 bytes.  Its 7 pairs
// need 14 emulated 64-bit divisions and 14 square roots with their integer
// corrections, a few hundred instructions a block: about the memory time
// at the card's issue rate, so the design computes each pair's
// coefficients once per block, not once per channel.
//
// * One thread computes one block: its 7 pairs' coefficients in registers,
//   then every channel through the three stages.
// * A thread block of 128 threads owns 128 consecutive blocks.  Their
//   weights and values are each one contiguous run in global memory, which
//   the threads copy into shared memory with a linear loop (neighbouring
//   lanes on neighbouring words).  In shared memory a block's weight row
//   is 9 words and its value row 8C+1: odd strides, so the 16 lanes of a
//   half warp (one 64-bit access phase) reading their own rows hit 32
//   distinct banks.  The outputs are written from registers: each warp's
//   stores cover one contiguous run per output, which L2 merges.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (ops/_kernels.py does it on first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kWRow = 9;            // 8 weights + 1 pad word
constexpr int kQA = 15;
constexpr long long kQAH = 1LL << (kQA - 1);
// 227 KB of shared memory a block: up to 27 channels a launch
constexpr int kMaxShared = 232448;

__device__ __forceinline__ long long isqrt64(long long x) {
  long long y = (long long)__dsqrt_rn((double)x);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if ((y + 1) * (y + 1) <= x) y = y + 1;
    if (y * y > x) y = y - 1;
  }
  return y > 0 ? y : 0;
}

// (a v0 + b v1 + QAH) >> QA with int64 wrap-around, arithmetic shift
__device__ __forceinline__ long long mix(long long a, long long v0,
                                         long long b, long long v1) {
  const unsigned long long s = (unsigned long long)a * (unsigned long long)v0 +
                               (unsigned long long)b * (unsigned long long)v1 +
                               (unsigned long long)kQAH;
  return ((long long)s) >> kQA;
}

struct Pair {
  long long a, b;
  bool both, lo;
};

__device__ __forceinline__ Pair pair_coeffs(long long w0, long long w1) {
  Pair p;
  long long ws = w0 + w1;
  ws = ws > 1 ? ws : 1;
  p.a = isqrt64((w0 << 30) / ws);
  p.b = isqrt64((w1 << 30) / ws);
  p.both = (w0 > 0) && (w1 > 0);
  p.lo = w0 > 0;
  return p;
}

// one pair of one channel: returns the passed value, writes the AC
__device__ __forceinline__ long long merge(const Pair& p, long long v0,
                                           long long v1, long long* ac) {
  const long long d = mix(p.a, v0, p.b, v1);
  const long long c = mix(p.a, v1, -p.b, v0);
  *ac = p.both ? c : 0;
  return p.both ? d : (p.lo ? v0 : v1);
}

__global__ void __launch_bounds__(kTile) raht_fwd_blocks_int_kernel(
    const long long* __restrict__ vals, const long long* __restrict__ weights,
    long long* __restrict__ dc, long long* __restrict__ acz,
    long long* __restrict__ acy, long long* __restrict__ acx,
    long long nblocks, int nc) {
  extern __shared__ long long smem[];
  long long* sw = smem;                       // kTile rows of kWRow
  long long* sv = smem + kTile * kWRow;       // kTile rows of 8C+1
  const int vrow = 8 * nc + 1;
  const int vlen = 8 * nc;
  const long long b0 = (long long)blockIdx.x * kTile;
  const long long left = nblocks - b0;
  const int rows = left < kTile ? (int)left : kTile;

  const long long* gw = weights + b0 * 8;
  for (int i = threadIdx.x; i < rows * 8; i += kTile)
    sw[(i >> 3) * kWRow + (i & 7)] = gw[i];
  const long long* gv = vals + b0 * vlen;
  for (int i = threadIdx.x; i < rows * vlen; i += kTile) {
    const int r = i / vlen;
    sv[r * vrow + (i - r * vlen)] = gv[i];
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;

  const long long* w = sw + r * kWRow;
  Pair pz[4], py[2];
  long long wz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pz[k] = pair_coeffs(w[2 * k], w[2 * k + 1]);
    wz[k] = w[2 * k] + w[2 * k + 1];
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) py[k] = pair_coeffs(wz[2 * k], wz[2 * k + 1]);
  const Pair px = pair_coeffs(wz[0] + wz[1], wz[2] + wz[3]);

  const long long blk = b0 + r;
  const long long* v = sv + r * vrow;
  for (int c = 0; c < nc; ++c) {
    long long vz[4], vy[2], ac;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vz[k] = merge(pz[k], v[(2 * k) * nc + c], v[(2 * k + 1) * nc + c], &ac);
      acz[(blk * 4 + k) * nc + c] = ac;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      vy[k] = merge(py[k], vz[2 * k], vz[2 * k + 1], &ac);
      acy[(blk * 2 + k) * nc + c] = ac;
    }
    dc[blk * nc + c] = merge(px, vy[0], vy[1], &ac);
    acx[blk * nc + c] = ac;
  }
}

size_t shared_bytes(int nc) {
  return sizeof(long long) * (size_t)kTile * (kWRow + 8 * (size_t)nc + 1);
}

}  // namespace

extern "C" int raht_fwd_blocks_int_launch(const void* vals, const void* weights,
                                          void* dc, void* acz, void* acy,
                                          void* acx, int64_t nblocks, int nc,
                                          void* stream) {
  if (nblocks <= 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(nc);
  if (smem > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        raht_fwd_blocks_int_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = (nblocks + kTile - 1) / kTile;
  raht_fwd_blocks_int_kernel<<<(unsigned)grid, kTile, smem,
                               (cudaStream_t)stream>>>(
      (const long long*)vals, (const long long*)weights, (long long*)dc,
      (long long*)acz, (long long*)acy, (long long*)acx, nblocks, nc);
  return (int)cudaGetLastError();
}
