"""Octree occupancy passes over Morton-sorted codes: counterpart of the
device half of ``mpeg_pcc_tmc13_tpu/ops/octree.py``.

The octree is implicit in the sorted leaf codes: the nodes of level
``l`` of a depth-``d`` tree are the unique prefixes ``code >> 3*(d-l)``.

* numpy host half: ``unique_sorted``, ``level_occupancy_np``,
  ``popcount8_np`` and ``build_levels_np`` (PARENT contexts, the
  device pipeline's) — the executable spec of the byte stream,
* torch device half: ``encode_occ_u8`` / ``encode_occ_u8_hdr`` (encoder
  analysis to level-major occupancy bytes) and ``decode_expand_stream``
  (decoder expansion back to leaf codes).

The device half runs in native int64 throughout.  The reference splits
each code at bit 30 to keep its level sweep in int32, and that split
overflows at depth 21 (``ops/octree.py:471``, ``chi`` is a 33-bit value
cast to int32); here the octant is read from the int64 code directly,
so depth 21 matches ``build_levels_np``.

Every pass is sync-free: shapes are static in the number of points and
``cap``/``nmax``, as in the jitted reference, so nothing waits for the
device until the caller fetches a result.
"""

from __future__ import annotations

import numpy as np
import torch

# PARENT context mode: base = child_idx << 8 | parent occupancy
# (mpeg_pcc_tmc13_tpu/ops/octree.py:49-60)
NUM_OCC_BASES = 2048

I64_MAX = np.iinfo(np.int64).max


# =====================================================================
# numpy host half
# =====================================================================


def unique_sorted(codes: np.ndarray) -> np.ndarray:
    """Unique of an already-sorted int array (keeps order)."""
    if codes.size == 0:
        return codes
    keep = np.empty(codes.shape, dtype=bool)
    keep[0] = True
    np.not_equal(codes[1:], codes[:-1], out=keep[1:])
    return codes[keep]


def level_occupancy_np(child_codes: np.ndarray):
    """(parent_codes, occ_bytes) of sorted unique child codes: bit
    ``child & 7`` of a parent's byte is set per present child."""
    parents_all = child_codes >> 3
    keep = np.empty(parents_all.shape, dtype=bool)
    keep[0] = True
    np.not_equal(parents_all[1:], parents_all[:-1], out=keep[1:])
    parent_codes = parents_all[keep]
    seg = np.cumsum(keep) - 1
    occ = np.zeros(parent_codes.shape[0], dtype=np.int64)
    # children are unique within a parent, so add == or
    np.add.at(occ, seg, (1 << (child_codes & 7)).astype(np.int64))
    return parent_codes, occ.astype(np.uint8)


def popcount8_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.astype(np.uint8)[:, None],
                         axis=1).sum(axis=1).astype(np.int64)


def build_levels_np(leaf_codes_unique: np.ndarray, depth: int):
    """Encoder-side analysis with PARENT contexts: per level
    l = 0..depth-1 a dict of the level's node codes, the occupancy bytes
    that generate level l+1 and each node's context base
    ``child_idx << 8 | parent_occ``.  Mirrors the reference
    ``build_levels_np(..., mode=CTX_MODE_PARENT)``."""
    codes_by_level = [None] * (depth + 1)
    codes_by_level[depth] = leaf_codes_unique
    occs = [None] * depth
    for l in range(depth - 1, -1, -1):
        codes_by_level[l], occs[l] = level_occupancy_np(
            codes_by_level[l + 1])
    out = []
    for l in range(depth):
        nodes = codes_by_level[l]
        child = (nodes & 7).astype(np.int32)
        if l == 0:
            parent_occ = np.zeros(1, dtype=np.int32)
        else:
            prev = occs[l - 1]
            parent_occ = np.repeat(prev.astype(np.int32), popcount8_np(prev))
        out.append({"nodes": nodes, "occ": occs[l],
                    "ctx_base": (child << 8) | parent_occ})
    return out


# =====================================================================
# torch device half
# =====================================================================


def _min_levels(c: torch.Tensor, depth: int) -> torch.Tensor:
    """Smallest level at which point i opens a node (reference
    ``_min_levels``, ops/octree.py:397-413).

    Sorted point i opens a node at every level l with
    ``prefix(c[i], l) != prefix(c[i-1], l)``.  With ``x = c[i] ^ c[i-1]``
    and ``nz`` the number of octant triples k < depth with
    ``x >> 3k != 0``, that first level is ``depth - nz + 1`` — the
    reference's clz formula without a clz (torch has none).  A duplicate
    (x == 0) gets depth+1, first at no level; point 0 gets 0.
    """
    prev = torch.cat([c[:1] ^ -1, c[:-1]])
    x = c ^ prev
    shifts = 3 * torch.arange(depth, dtype=torch.int64, device=c.device)
    nz = ((x[None, :] >> shifts[:, None]) != 0).sum(dim=0)
    minlev = depth + 1 - nz
    minlev[:1] = 0
    return minlev


def encode_occ_u8(leaf_codes_sorted: torch.Tensor, depth: int, cap: int):
    """Level-major occupancy bytes of a sorted code tensor (duplicates
    allowed; they collapse at the leaf level).

    1. ``_min_levels`` gives each point the first level it opens a node,
    2. a (depth, N) cumsum gives per-level node ranks, whose tails are the
       per-level counts, so each node's slot in the output is known in
       closed form,
    3. one scatter-add puts each point's child-occupancy bit (masked to
       the first point of its child node, so add == or) into its node's
       slot.

    Returns ``(occ_u8 (cap,), counts (depth,) int32)``; only the first
    ``counts.sum()`` bytes are meaningful.  Slots at or past ``cap`` are
    dropped (the reference's ``segment_sum`` drops them), so an undersized
    ``cap`` shows as ``counts.sum() > cap`` and the caller retries larger.
    """
    c = leaf_codes_sorted
    dev = c.device
    minlev = _min_levels(c, depth)
    lvec = torch.arange(depth, dtype=torch.int64, device=dev)[:, None]
    first = minlev[None, :] <= lvec                          # (depth, N)
    seg = torch.cumsum(first, dim=1) - 1
    counts = seg[:, -1] + 1
    offs = torch.cumsum(counts, dim=0) - counts
    dest = offs[:, None] + seg                               # (depth, N)

    # child octant of point i at level l+1, straight from the int64 code
    octant = (c[None, :] >> (3 * (depth - 1 - lvec))) & 7
    keep = (minlev[None, :] <= lvec + 1) & (dest < cap)
    contrib = torch.where(keep, torch.bitwise_left_shift(1, octant), 0)
    dest = torch.where(keep, dest, 0)
    occ = torch.zeros(cap, dtype=torch.int64, device=dev)
    occ.index_add_(0, dest.reshape(-1), contrib.reshape(-1))
    return occ.to(torch.uint8), counts.to(torch.int32)


def _u32_le_bytes(v: torch.Tensor) -> torch.Tensor:
    """Little-endian uint32 bytes of non-negative int values (n,) ->
    (4n,) uint8, with int64 shifts (no unsigned dtypes needed)."""
    sh = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=v.device)
    return ((v.to(torch.int64)[:, None] >> sh[None, :]) & 0xFF) \
        .to(torch.uint8).reshape(-1)


def encode_occ_u8_hdr(leaf_codes_sorted: torch.Tensor, depth: int,
                      cap: int) -> torch.Tensor:
    """``encode_occ_u8`` with the per-level counts in the buffer head, so
    the host reads one buffer per slice.  Returns a (4*depth + cap,) uint8
    tensor: depth little-endian uint32 node counts, then the level-major
    occupancy bytes (reference ``encode_occ_u8_hdr``, ops/octree.py:564)."""
    occ, counts = encode_occ_u8(leaf_codes_sorted, depth, cap)
    return torch.cat([_u32_le_bytes(counts), occ])


def _nth_set_bit_table(device) -> torch.Tensor:
    """(256, 8) int64: entry [b, r] = index of the r-th set bit of byte b
    (0 past the popcount).  Built on the device from arithmetic."""
    b = torch.arange(256, dtype=torch.int64, device=device)[:, None]
    k = torch.arange(8, dtype=torch.int64, device=device)
    bits = (b >> k[None, :]) & 1
    rank = torch.cumsum(bits, dim=1) - 1
    # set bits scatter their index to their rank; clear bits go to
    # column 8, which is cut off
    col = torch.where(bits == 1, rank, 8)
    tab = torch.zeros(256, 9, dtype=torch.int64, device=device)
    tab.scatter_(1, col, k.expand(256, 8).contiguous())
    return tab[:, :8].contiguous()


def _popcount8_table(device) -> torch.Tensor:
    b = torch.arange(256, dtype=torch.int64, device=device)[:, None]
    k = torch.arange(8, dtype=torch.int64, device=device)
    return ((b >> k[None, :]) & 1).sum(dim=1)


def _expand_level(nodes: torch.Tensor, occ: torch.Tensor, nmax: int,
                  nth_bit: torch.Tensor, popcnt: torch.Tensor):
    """One decoder level: node codes + occupancy bytes -> child codes.

    Gather form (reference ``_expand_level``, ops/octree.py:601-628):
    output slot k takes its parent row j_k — the row whose inclusive
    popcount cumsum first exceeds k (``searchsorted``, the sync-free
    counterpart of ``jnp.repeat(..., total_repeat_length=nmax)``) — and
    its child bit from the nth-set-bit table at rank k - start[j_k].

    occ must be zero past the node count.  Returns (child codes (nmax,)
    int64 padded with INT64_MAX, child count as a 0-d int64 tensor).
    """
    row = torch.arange(nmax, dtype=torch.int64, device=nodes.device)
    occ64 = occ.to(torch.int64)
    pops = popcnt[occ64]
    csum = torch.cumsum(pops, dim=0)
    starts = csum - pops
    new_cnt = csum[-1]
    src = torch.searchsorted(csum, row, right=True).clamp_(max=nmax - 1)
    rank = (row - starts[src]).clamp_(0, 7)
    bit = nth_bit[occ64[src], rank]
    # padding rows hold INT64_MAX, whose shift wraps; they are masked
    out = torch.bitwise_left_shift(nodes[src], 3) | bit
    out = torch.where(row < new_cnt, out, I64_MAX)
    return out, new_cnt


def decode_expand_stream(occ_u8: torch.Tensor, counts: torch.Tensor,
                         depth: int, nmax: int):
    """Decoder expansion from the level-major occupancy byte stream (the
    layout the host entropy stage produces).

    occ_u8: (cap,) uint8 (padding past counts.sum() ignored); counts:
    (depth,) per-level node counts on the same device; nmax: leaf
    capacity.  Returns (codes (nmax,) int64 padded with INT64_MAX, leaf
    count as a 0-d tensor) — reference ``decode_expand_stream``,
    ops/octree.py:631-659.
    """
    dev = occ_u8.device
    cap = occ_u8.shape[0]
    counts = counts.to(torch.int64)
    offs = torch.cumsum(counts, dim=0) - counts
    row = torch.arange(nmax, dtype=torch.int64, device=dev)
    nth_bit = _nth_set_bit_table(dev)
    popcnt = _popcount8_table(dev)
    nodes = torch.full((nmax,), I64_MAX, dtype=torch.int64, device=dev)
    nodes[0] = 0
    cnt = torch.ones((), dtype=torch.int64, device=dev)
    for l in range(depth):
        idx = (offs[l] + row).clamp_(max=cap - 1)
        occ = torch.where(row < counts[l], occ_u8[idx], 0)
        nodes, cnt = _expand_level(nodes, occ, nmax, nth_bit, popcnt)
    return nodes, cnt
