// The occupancy context bases of one decoder octree level, for Hopper
// (sm_90a): octree_neigh_ctx, a launch a level of the QT/BT decode walk
// (models/geometry_octree.py decode_qtbt_card).
//
// Replaces no TPU kernel: the JAX package decodes these levels in host
// numpy (mpeg_pcc_tmc13_tpu/models/geometry_octree.py decode_qtbt_np,
// its _level_base_np and ops/octree.py occ_context_base_np /
// neighbor_pattern_np).  It was added so the decoder's node codes stay on
// the card between the host range decoder's levels: the host reads one
// int32 base a node and decodes that level's occupancy bytes.  The plain
// PyTorch version is ops/octree.py's octree_neigh_ctx_ref, which this
// equals bit for bit, and both equal the numpy bases:
//   NEIGH  (mode 1): the 6-bit face pattern (bit i for -x,+x,-y,+y,-z,+z
//                    present in the level) | child index << 6,
//   PARENT (mode 0): child index << 8 | the parent's occupancy byte.
//
// What bounds it on an H100: launch latency.  A level reads 8 bytes a
// node and writes 4 (PARENT also reads the parent's row, 8 bytes, and its
// byte): ~322,600 nodes in all on a ~856,500-point body frame, ~3.9 MB,
// about a microsecond at 3.35 TB/s; the largest level is ~2.6 MB of codes,
// which stays in the 50 MB L2 for the searches.
//
// Design: a thread a node.  The six neighbours' codes come from the node's
// own code by dilated-integer arithmetic on its interleaved bits (x in bit
// 2 of each triple): -1 on an axis subtracts 1 from the axis's bits alone,
// +1 fills the other bits with ones so the carry runs through them; a
// coordinate of 0 (or 2^level - 1) has no -1 (+1) neighbour.  No Morton
// decode or encode.  Each neighbour is then a lower-bound binary search
// over the level's sorted codes; the six searches take the same sequence
// of halvings (it depends on n alone), so they run in one loop, six
// independent loads a step.

// Launcher contract (ops/octree.py octree_neigh_ctx): pointers from torch
// tensors on the caller's current stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxLevel = 21;                   // 63-bit Morton codes
constexpr u64 kAxisBits = 0x1249249249249249ULL;  // bit 0 of every triple

__global__ void __launch_bounds__(kThreads)
octree_neigh_ctx_kernel(const long long* __restrict__ codes, long long n,
                        int level, int neigh,
                        const unsigned char* __restrict__ parent_occ,
                        const long long* __restrict__ src,
                        int* __restrict__ base) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const u64 c = (u64)__ldg(codes + i);
  const int child = (int)(c & 7);
  if (!neigh) {
    const int par = parent_occ ? (int)parent_occ[__ldg(src + i)] : 0;
    base[i] = child << 8 | par;
    return;
  }
  const u64 lmask = level ? (~0ULL >> (64 - 3 * level)) : 0ULL;
  u64 q[6];
  bool ok[6];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int sh = 2 - a;                      // x, y, z: bits 2, 1, 0
    const u64 m = (kAxisBits << sh) & lmask;
    const u64 one = 1ULL << sh;
    const u64 coord = c & m, rest = c & ~m;
    ok[2 * a] = coord != 0;
    ok[2 * a + 1] = coord != m;
    q[2 * a] = ((coord - one) & m) | rest;
    q[2 * a + 1] = (((c | ~m) + one) & m) | rest;
  }
  // lower bound of each q in codes[0, n): the last index whose code is
  // below q, by the same halvings for all six
  long long lo[6] = {0, 0, 0, 0, 0, 0};
  for (long long len = n; len > 1;) {
    const long long half = len >> 1;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if ((u64)__ldg(codes + lo[k] + half) < q[k]) lo[k] += half;
    len -= half;
  }
  int pat = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    u64 v = (u64)__ldg(codes + lo[k]);
    if (v < q[k] && lo[k] + 1 < n) v = (u64)__ldg(codes + lo[k] + 1);
    pat |= (ok[k] && v == q[k]) << k;
  }
  base[i] = pat | child << 6;
}

}  // namespace

// codes (n,) the level's sorted unique node codes; neigh != 0: NEIGH
// bases, else PARENT bases from parent_occ (the level above's bytes) at
// src (n,) each node's parent row, both null at the root (byte 0); base
// (n,) int32.
extern "C" int octree_neigh_ctx_launch(const void* codes, long long n,
                                       int level, int neigh,
                                       const void* parent_occ,
                                       const void* src, void* base,
                                       void* stream) {
  if (n <= 0 || level < 0 || level > kMaxLevel ||
      (!neigh && (parent_occ == nullptr) != (src == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long grid = (n + kThreads - 1) / kThreads;
  octree_neigh_ctx_kernel<<<(unsigned)grid, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const long long*)codes, n, level, neigh,
      (const unsigned char*)parent_occ, (const long long*)src, (int*)base);
  return (int)cudaGetLastError();
}
