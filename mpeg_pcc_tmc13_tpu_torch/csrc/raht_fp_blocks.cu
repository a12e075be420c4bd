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
// dc (B, C), acz (B, 4, C), acy (B, 2, C), acx (B, 1, C), all int64.  A
// launch takes 1 to 4 channels (kMaxRun); ops/raht_fp_device.py sends
// more in runs.  Domain: weights non-negative with every block's sum
// below 2^33, so no shifted weight wraps (the subtree counts of a cloud).
//
// Exactness against ops/raht_fp_device.py:fwd_blocks_int_ref.
// * Fast path, every block whose 8 weights sum below 2^22 (every real
//   block: a cloud's largest subtree is its point count).  Per pair
//   ws = w0 + w1 < 2^22 and num = w0 2^30 < 2^52 are exact doubles, so
//   trunc(num * rcp(ws)) with rcp correctly rounded is off the quotient
//   q_a = floor(num / ws) <= 2^30 by at most 2^-22 before truncation:
//   it is q_a or q_a -+ 1, and one integer step against the remainder
//   r = num - q ws, which lies in (-ws, 2 ws) and so is exact in 32 bits,
//   makes it exact.  Then floor(w1 2^30 / ws) = 2^30 - q_a - [r_a > 0]:
//   one division a pair, not two (both 0 when ws = 0, as the plain
//   version's isqrt(0 // 1)).  floor(sqrt(q)) for q <= 2^30: the fp32
//   square root of q rounded to fp32 is within 0.01 of sqrt(q), so its
//   truncation is floor(sqrt(q)) or one off, and the plain version's two
//   correction rounds, done in 32-bit unsigned arithmetic ((y + 1)^2 <
//   2^32 for y <= 2^15 + 1), give floor(sqrt(q)) exactly, which is what
//   isqrt64_dev's float64 seed and corrections give.  a, b <= 2^15, so
//   the channel mix is a 64x32-bit multiply, with int64's wrap-around.
// * General path, every other block: the plain version's int64 arithmetic
//   (__dsqrt_rn seed of the exact double, truncated, two int64
//   corrections; the truncating division equals floor division on
//   non-negative weights; the mix 64x64 bits).
// Products and sums wrap as torch's int64 does (unsigned arithmetic), and
// the rounding shift is arithmetic on the signed result.
//
// What bounds it on an H100: memory.  Per 3-channel block it reads 8*3
// values and 8 weights and writes 8*3 coefficients, 448 bytes; the fast
// path's instructions a block (cuobjdump's count of
// raht_fp_fast_block_count_c3, chip_smoke (m)), one warp instruction
// serving 32 blocks, take less issue time than those bytes take to move
// (PERF.md has both bounds).  A thread a block with the plain version's
// arithmetic stood at 0.37 of the byte bound: 14 emulated 64-bit
// divisions and 14 FP64 square roots a block in one thread's dependent
// chain, a synchronous staging loop, and outputs stored 8C words apart by
// neighbouring lanes.
//
// * Arithmetic: the fast path above, 7 FP64 reciprocal-multiplies and 14
//   fp32 square roots a block in place of 14 divisions and 14 FP64 roots.
//   A thread takes a block and computes its 7 pairs once for every
//   channel of the launch.
// * Streamed input: a persistent grid (as many CTAs of 128 threads as fit
//   on every SM) walks tiles of 128 consecutive blocks.  Each CTA has a
//   ring of kStages shared-memory buffers; thread 0 fills the next tile's
//   with two 1-D TMA bulk copies (cp.async.bulk: the tile's weights and
//   its values are each one contiguous run) completing on the buffer's
//   mbarrier, while the CTA computes the current tile.  No thread spends
//   an instruction on a copied word.  One copy per row into padded rows
//   (no bank conflicts) measured slower on the card: 256 small TMA copies
//   a tile held the kernel at 0.45 ms, against 0.32 ms for two; the
//   16-byte row reads' 4-way bank conflicts at C = 3 cost less.
// * Coalesced output: a tile's dc, acz, acy and acx are each one
//   contiguous run in global memory, [b0 k C, (b0 + 128) k C) words.  The
//   threads write their outputs into those runs' images in the tile's
//   value buffer (free once every row is read), and thread 0 stores each
//   run with one TMA bulk store.  A ragged last tile whose dc / acx run is
//   no multiple of 16 bytes stores those two with coalesced plain stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (ops/_kernels.py does it on first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;          // blocks a tile, a thread each
constexpr int kMaxRun = 4;          // channels a launch
constexpr int kQA = 15;
constexpr long long kQAH = 1LL << (kQA - 1);
constexpr unsigned kFastLimit = 1u << 22;   // fast path: weight sum below
constexpr int kStages = 2;          // tiles in flight a CTA (3: no faster)

template <int NC>
struct Layout {
  static constexpr int kWBytes = kTile * 64;           // 8 weights a row
  static constexpr int kBufBytes = kWBytes + kTile * 64 * NC;   // + 8C values
  static constexpr int kSmem = kStages * kBufBytes + 8 * kStages;  // mbarriers
  static constexpr int kInBytes = 64 + 64 * NC;        // a block's input
};

// ---- PTX: mbarriers, TMA bulk copies, proxy fences ----------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes become visible to the TMA unit
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- pair coefficients ------------------------------------------------

template <typename T>
struct Pair {
  T a, b;
  bool both, lo;
};

// fast path: floor(sqrt(q)) for q <= 2^30 + 1, 32-bit throughout
__device__ __forceinline__ unsigned isqrt_fast(unsigned q) {
  unsigned y = (unsigned)__fsqrt_rn(__uint2float_rn(q));
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if ((y + 1) * (y + 1) <= q) y = y + 1;
    if (y * y > q) y = y - 1;
  }
  return y;
}

// fast path, w0 + w1 < 2^22: one exact division for both coefficients
__device__ __forceinline__ Pair<unsigned> pair_coeffs(unsigned w0,
                                                      unsigned w1) {
  const unsigned ws = w0 + w1;
  const unsigned d = ws > 1u ? ws : 1u;
  const double num = __dmul_rn((double)w0, 1073741824.0);   // w0 2^30
  unsigned q = __double2uint_rz(__dmul_rn(num, __drcp_rn((double)d)));
  int r = (int)((w0 << 30) - q * d);   // exact: |r| < 2 d < 2^23
  if (r < 0) {
    q = q - 1;
    r = r + (int)d;
  } else if (r >= (int)d) {
    q = q + 1;
    r = r - (int)d;
  }
  const unsigned qb = ws == 0u ? 0u : (1u << 30) - q - (r > 0 ? 1u : 0u);
  Pair<unsigned> p;
  p.a = isqrt_fast(q);
  p.b = isqrt_fast(qb);
  p.both = (w0 > 0u) && (w1 > 0u);
  p.lo = w0 > 0u;
  return p;
}

// general path: the plain version's int64 arithmetic
__device__ __forceinline__ long long isqrt64(long long x) {
  long long y = (long long)__dsqrt_rn((double)x);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if ((y + 1) * (y + 1) <= x) y = y + 1;
    if (y * y > x) y = y - 1;
  }
  return y > 0 ? y : 0;
}

__device__ __forceinline__ Pair<long long> pair_coeffs(long long w0,
                                                       long long w1) {
  long long ws = w0 + w1;
  ws = ws > 1 ? ws : 1;
  Pair<long long> p;
  p.a = isqrt64((w0 << 30) / ws);
  p.b = isqrt64((w1 << 30) / ws);
  p.both = (w0 > 0) && (w1 > 0);
  p.lo = w0 > 0;
  return p;
}

// one pair of one channel: returns the passed value, writes the AC.  An
// unsigned coefficient widens with zero high bits, so the products are
// 64x32-bit multiplies; the sums wrap as int64 does.
template <typename T>
__device__ __forceinline__ long long merge(const Pair<T>& p, long long v0,
                                           long long v1, long long* ac) {
  const unsigned long long a = (unsigned long long)p.a;
  const unsigned long long b = (unsigned long long)p.b;
  const unsigned long long u0 = (unsigned long long)v0;
  const unsigned long long u1 = (unsigned long long)v1;
  const long long d = ((long long)(a * u0 + b * u1 + kQAH)) >> kQA;
  const long long c = ((long long)(a * u1 - b * u0 + kQAH)) >> kQA;
  *ac = p.both ? c : 0;
  return p.both ? d : (p.lo ? v0 : v1);
}

// One block: weights w[8], values v[8 NC] -> o[8 NC] = dc (NC), acz
// (4 NC), acy (2 NC), acx (NC), each slot-major as in global memory.  W is
// unsigned for the fast path, long long for the general one.
template <int NC, typename W>
__device__ __forceinline__ void butterfly(const long long (&w)[8],
                                          const long long (&v)[8 * NC],
                                          long long (&o)[8 * NC]) {
  Pair<W> pz[4], py[2];
  W wz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pz[k] = pair_coeffs((W)w[2 * k], (W)w[2 * k + 1]);
    wz[k] = (W)w[2 * k] + (W)w[2 * k + 1];
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) py[k] = pair_coeffs(wz[2 * k], wz[2 * k + 1]);
  const Pair<W> px = pair_coeffs(wz[0] + wz[1], wz[2] + wz[3]);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    long long vz[4], vy[2];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      vz[k] = merge(pz[k], v[(2 * k) * NC + c], v[(2 * k + 1) * NC + c],
                    &o[NC + k * NC + c]);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      vy[k] = merge(py[k], vz[2 * k], vz[2 * k + 1], &o[5 * NC + k * NC + c]);
    o[c] = merge(px, vy[0], vy[1], &o[7 * NC + c]);
  }
}

// every weight non-negative and their sum below 2^22
__device__ __forceinline__ bool fast_block(const long long (&w)[8]) {
  unsigned long long s = 0;
  bool small = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    small = small && (unsigned long long)w[k] < kFastLimit;
    s += (unsigned long long)w[k];
  }
  return small && s < kFastLimit;
}

// thread 0 starts the copy of tile `tile` into a buffer: its weights and
// its values are each one contiguous run, one TMA bulk copy each
template <int NC>
__device__ __forceinline__ void load_tile(
    unsigned char* buf, uint32_t bar, const long long* __restrict__ vals,
    const long long* __restrict__ weights, long long tile, long long nblocks) {
  using L = Layout<NC>;
  const long long b0 = tile * kTile;
  const int rows = nblocks - b0 < kTile ? (int)(nblocks - b0) : kTile;
  mbar_expect_tx(bar, (uint32_t)(rows * L::kInBytes));
  bulk_load(smem_u32(buf), weights + b0 * 8, rows * 64, bar);
  bulk_load(smem_u32(buf + L::kWBytes), vals + b0 * 8 * NC, rows * 64 * NC,
            bar);
}

template <int NC>
__global__ void __launch_bounds__(kTile, NC <= 3 ? 3 : 2)
raht_fwd_blocks_int_kernel(
    const long long* __restrict__ vals, const long long* __restrict__ weights,
    long long* __restrict__ dc, long long* __restrict__ acz,
    long long* __restrict__ acy, long long* __restrict__ acx,
    long long nblocks) {
  using L = Layout<NC>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar0 = smem_u32(smem + kStages * L::kBufBytes);
  const int tid = threadIdx.x;
  const long long ntiles = (nblocks + kTile - 1) / kTile;
  const long long stride = gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages; ++s) {
      const long long t = blockIdx.x + s * stride;
      if (t < ntiles)
        load_tile<NC>(smem + s * L::kBufBytes, bar0 + 8 * s, vals, weights, t,
                      nblocks);
    }
  }
  __syncthreads();

  long long tile = blockIdx.x;
  for (int it = 0; tile < ntiles; ++it, tile += stride) {
    const int s = it % kStages;
    unsigned char* buf = smem + s * L::kBufBytes;
    const long long b0 = tile * kTile;
    const int rows = nblocks - b0 < kTile ? (int)(nblocks - b0) : kTile;
    mbar_wait(bar0 + 8 * s, (it / kStages) & 1);

    long long o[8 * NC];
    if (tid < rows) {
      long long w[8], v[8 * NC];
      const longlong2* sw = (const longlong2*)(buf + tid * 64);
      const longlong2* sv = (const longlong2*)(buf + L::kWBytes + tid * 64 * NC);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const longlong2 x = sw[k];
        w[2 * k] = x.x;
        w[2 * k + 1] = x.y;
      }
#pragma unroll
      for (int k = 0; k < 4 * NC; ++k) {
        const longlong2 x = sv[k];
        v[2 * k] = x.x;
        v[2 * k + 1] = x.y;
      }
      if (fast_block(w))
        butterfly<NC, unsigned>(w, v, o);
      else
        butterfly<NC, long long>(w, v, o);
    }
    __syncthreads();  // every row is read: the value buffer takes the runs

    long long* so = (long long*)(buf + L::kWBytes);
    long long* s_dc = so;
    long long* s_acz = so + kTile * NC;
    long long* s_acy = so + 5 * kTile * NC;
    long long* s_acx = so + 7 * kTile * NC;
    if (tid < rows) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s_dc[tid * NC + c] = o[c];
        s_acx[tid * NC + c] = o[7 * NC + c];
      }
      longlong2* z = (longlong2*)(s_acz + tid * 4 * NC);
#pragma unroll
      for (int k = 0; k < 2 * NC; ++k)
        z[k] = make_longlong2(o[NC + 2 * k], o[NC + 2 * k + 1]);
      longlong2* y = (longlong2*)(s_acy + tid * 2 * NC);
#pragma unroll
      for (int k = 0; k < NC; ++k)
        y[k] = make_longlong2(o[5 * NC + 2 * k], o[5 * NC + 2 * k + 1]);
    }
    fence_proxy_async();
    __syncthreads();

    const uint32_t n1 = (uint32_t)(rows * NC);   // words of dc and of acx
    const bool whole = (n1 & 1u) == 0u;          // a multiple of 16 bytes
    if (tid == 0) {
      if (whole) {
        bulk_store(dc + b0 * NC, smem_u32(s_dc), n1 * 8);
        bulk_store(acx + b0 * NC, smem_u32(s_acx), n1 * 8);
      }
      bulk_store(acz + b0 * 4 * NC, smem_u32(s_acz), n1 * 32);
      bulk_store(acy + b0 * 2 * NC, smem_u32(s_acy), n1 * 16);
      bulk_commit();
      const long long next = tile + kStages * stride;
      if (next < ntiles) {
        bulk_wait_read();   // the stores have left the buffer
        load_tile<NC>(buf, bar0 + 8 * s, vals, weights, next, nblocks);
      }
    }
    if (!whole) {   // only the last tile can be ragged: no refill follows
      for (uint32_t i = tid; i < n1; i += kTile) {
        dc[b0 * NC + i] = s_dc[i];
        acx[b0 * NC + i] = s_acx[i];
      }
    }
  }
  if (tid == 0) bulk_wait_all();
}

// Never launched: one block a thread through the fast path, straight from
// global memory, compiled so that cuobjdump -sass can count the fast
// path's instructions a block (chip_smoke (m)'s issue bound), for the
// colour (3) and reflectance (1) channel counts.
template <int NC>
__device__ __forceinline__ void fast_block_count(
    const long long* __restrict__ vals, const long long* __restrict__ weights,
    long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long w[8], v[8 * NC], o[8 * NC];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = weights[i * 8 + k];
#pragma unroll
  for (int k = 0; k < 8 * NC; ++k) v[k] = vals[i * 8 * NC + k];
  butterfly<NC, unsigned>(w, v, o);
#pragma unroll
  for (int k = 0; k < 8 * NC; ++k) out[i * 8 * NC + k] = o[k];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int NC>
int launch(const void* vals, const void* weights, void* dc, void* acz,
           void* acy, void* acx, long long nblocks, cudaStream_t stream) {
  const int smem = Layout<NC>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      raht_fwd_blocks_int_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, raht_fwd_blocks_int_kernel<NC>, kTile, smem);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (nblocks + kTile - 1) / kTile;
  const long long fill = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long grid = ntiles < fill ? ntiles : fill;
  raht_fwd_blocks_int_kernel<NC><<<(unsigned)grid, kTile, smem, stream>>>(
      (const long long*)vals, (const long long*)weights, (long long*)dc,
      (long long*)acz, (long long*)acy, (long long*)acx, nblocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" __global__ void raht_fp_fast_block_count_c3(
    const long long* vals, const long long* weights, long long* out) {
  fast_block_count<3>(vals, weights, out);
}

extern "C" __global__ void raht_fp_fast_block_count_c1(
    const long long* vals, const long long* weights, long long* out) {
  fast_block_count<1>(vals, weights, out);
}

// nc in [1, 4]; every pointer 16-byte aligned (TMA bulk copies)
extern "C" int raht_fwd_blocks_int_launch(const void* vals, const void* weights,
                                          void* dc, void* acz, void* acy,
                                          void* acx, int64_t nblocks, int nc,
                                          void* stream) {
  if (nblocks <= 0 || nc <= 0 || nc > kMaxRun)
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(vals) && aligned16(weights) && aligned16(dc) &&
        aligned16(acz) && aligned16(acy) && aligned16(acx)))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nc) {
    case 1: return launch<1>(vals, weights, dc, acz, acy, acx, nblocks, s);
    case 2: return launch<2>(vals, weights, dc, acz, acy, acx, nblocks, s);
    case 3: return launch<3>(vals, weights, dc, acz, acy, acx, nblocks, s);
    default: return launch<4>(vals, weights, dc, acz, acy, acx, nblocks, s);
  }
}
