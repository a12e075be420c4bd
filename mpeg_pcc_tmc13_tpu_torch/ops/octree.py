"""Octree passes over Morton-sorted codes: counterpart of
``mpeg_pcc_tmc13_tpu/ops/octree.py``.

The octree is implicit in the sorted leaf codes: the nodes of level
``l`` of a depth-``d`` tree are the unique prefixes ``code >> 3*(d-l)``.

* numpy host half: ``unique_sorted``, ``level_occupancy_np``,
  ``neighbor_pattern_np``, ``occ_context_base_np``, ``expand_level_np``,
  ``pred_occupancy_np``, ``popcount8_np`` and ``build_levels_np`` (NEIGH
  or PARENT contexts) — the executable spec of the byte stream,
* torch device half: ``encode_analysis`` / ``encode_analysis_packed``
  (the full per-level analysis with context bases, for
  ``models.geometry_octree`` ``engine="device"``),
  ``encode_analysis_inter`` (the same with predOcc contexts from a
  reference frame, for ``parallel.slices``), ``encode_occ_u8`` /
  ``encode_occ_u8_hdr`` (occupancy bytes only, the device pipeline's
  raw link), ``encode_occ_packed_hdr`` (the same bytes through the
  static prefix code, the packed link) and ``decode_expand_stream``
  (decoder expansion back to leaf codes).

On a CUDA tensor ``encode_occ_u8``/``encode_occ_u8_hdr`` launch the
hand-written kernel ``octree_occ_u8`` and ``_expand_level``/
``decode_expand_stream`` the kernel ``octree_expand`` of
``csrc/octree_levels.cu`` (or raise); on a CPU tensor they run their
plain versions, the ``_ref`` functions, which the kernels equal bit for
bit and which the kernels' algorithms are mirrored against in plain
torch (``first_level_mirror``, ``occ_u8_mirror``,
``expand_level_mirror``) for the tests.  ``_kernels.LAUNCHES`` counts
the kernels' launches.

The plain device half runs in native int64 throughout.  The reference
splits each code at bit 30 to keep its level sweep in int32, and that
split overflows at depth 21 (``ops/octree.py:471``, ``chi`` is a 33-bit
value cast to int32); here (plain versions and kernels) the octant is
read from the int64 code directly, so depth 21 matches
``build_levels_np``.

The occupancy passes are sync-free: shapes are static in the number of
points and ``cap``/``nmax``, as in the jitted reference, so nothing
waits for the device until the caller fetches a result.  The packed
analysis is the exception: its boolean-mask compaction sizes its output
from the data.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import morton
from . import _kernels

# 6 face neighbours, axis-major: -x,+x,-y,+y,-z,+z  (bit i of pattern).
_FACE_OFFSETS = np.array(
    [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]],
    dtype=np.int64,
)

# Context modes (reference ops/octree.py:49-60), one context memory:
#   NEIGH  (mode 1): base = 6-bit face pattern | child_idx << 6   (512)
#   PARENT (mode 0): base = child_idx << 8 | parent_occupancy    (2048)
CTX_MODE_PARENT = 0
CTX_MODE_NEIGH = 1
NUM_OCC_BASES = 2048
OCC_CTX_SIZE = NUM_OCC_BASES * 255

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


def neighbor_pattern_np(node_codes: np.ndarray, level_dims: int) -> np.ndarray:
    """6-bit face-neighbour-existence pattern per node of one level
    (sorted unique codes, coordinates in [0, 2**level_dims)), by binary
    search over the sorted codes."""
    n = node_codes.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    pos = morton.decode(node_codes)
    lim = np.int64(1) << np.int64(level_dims)
    pat = np.zeros(n, dtype=np.uint8)
    for i, off in enumerate(_FACE_OFFSETS):
        q = pos + off
        valid = np.all((q >= 0) & (q < lim), axis=-1)
        ncode = morton.encode(q)
        idx = np.minimum(np.searchsorted(node_codes, ncode), n - 1)
        hit = valid & (node_codes[idx] == ncode)
        pat |= (hit.astype(np.uint8) << i)
    return pat


def occ_context_base_np(node_codes: np.ndarray, level_dims: int) -> np.ndarray:
    """NEIGH context base per node: face pattern | child index << 6."""
    pat = neighbor_pattern_np(node_codes, level_dims).astype(np.int32)
    return pat | ((node_codes & 7).astype(np.int32) << 6)


def expand_level_np(node_codes: np.ndarray, occ: np.ndarray) -> np.ndarray:
    """Child codes (sorted unique) from node codes + occupancy bytes."""
    bits = (occ[:, None] >> np.arange(8, dtype=np.uint8)) & 1
    child = (node_codes[:, None] << 3) | np.arange(8, dtype=np.int64)
    return child[bits.astype(bool)]


def pred_occupancy_np(node_codes: np.ndarray, ref_child_codes: np.ndarray
                      ) -> np.ndarray:
    """Inter prediction: bit j of a node's byte is set iff the sorted
    unique reference codes of level l+1 hold its child j."""
    m = node_codes.shape[0]
    if m == 0 or ref_child_codes.size == 0:
        return np.zeros(m, dtype=np.int32)
    queries = (node_codes[:, None] << 3) | np.arange(8, dtype=np.int64)
    idx = np.searchsorted(ref_child_codes, queries)
    idx = np.minimum(idx, ref_child_codes.size - 1)
    hit = ref_child_codes[idx] == queries
    return np.sum(
        hit.astype(np.int32) << np.arange(8, dtype=np.int32)[None, :],
        axis=1)


def popcount8_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.astype(np.uint8)[:, None],
                         axis=1).sum(axis=1).astype(np.int64)


def build_levels_np(leaf_codes_unique: np.ndarray, depth: int,
                    mode: int = CTX_MODE_NEIGH):
    """Encoder-side analysis: per level l = 0..depth-1 a dict of the
    level's node codes, the occupancy bytes that generate level l+1 and
    each node's context base in ``mode`` (NEIGH by default, as in the
    reference)."""
    codes_by_level = [None] * (depth + 1)
    codes_by_level[depth] = leaf_codes_unique
    occs = [None] * depth
    for l in range(depth - 1, -1, -1):
        codes_by_level[l], occs[l] = level_occupancy_np(
            codes_by_level[l + 1])
    out = []
    for l in range(depth):
        nodes = codes_by_level[l]
        if mode == CTX_MODE_NEIGH:
            base = occ_context_base_np(nodes, l)
        else:
            child = (nodes & 7).astype(np.int32)
            if l == 0:
                parent_occ = np.zeros(1, dtype=np.int32)
            else:
                prev = occs[l - 1]
                parent_occ = np.repeat(prev.astype(np.int32),
                                       popcount8_np(prev))
            base = (child << 8) | parent_occ
        out.append({"nodes": nodes, "occ": occs[l], "ctx_base": base})
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


def encode_occ_u8_ref(leaf_codes_sorted: torch.Tensor, depth: int,
                      cap: int):
    """Plain version of ``encode_occ_u8``: level-major occupancy bytes
    of a sorted code tensor (duplicates allowed; they collapse at the
    leaf level).

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


def encode_occ_u8_hdr_ref(leaf_codes_sorted: torch.Tensor, depth: int,
                          cap: int) -> torch.Tensor:
    """Plain version of ``encode_occ_u8_hdr``: ``encode_occ_u8_ref`` with
    the per-level counts in the buffer head.  Returns a (4*depth + cap,)
    uint8 tensor: depth little-endian uint32 node counts, then the
    level-major occupancy bytes (reference ``encode_occ_u8_hdr``,
    ops/octree.py:564)."""
    occ, counts = encode_occ_u8_ref(leaf_codes_sorted, depth, cap)
    return torch.cat([_u32_le_bytes(counts), occ])


# ---- the hand-written kernels (csrc/octree_levels.cu) ------------------

# rows per tile of both kernels (kTile): 256 threads x 16 rows
KERNEL_TILE = 4096


def _occ_u8_words(c: torch.Tensor, depth: int, cap: int) -> torch.Tensor:
    """The kernel's output: (4 depth + cap) bytes as int32 words (the
    last word padded), the uint32 counts in words [0, depth)."""
    if c.dtype != torch.int64 or c.dim() != 1:
        raise TypeError(f"need (N,) int64 codes, got {c.dtype} "
                        f"{tuple(c.shape)}")
    if not 0 <= depth <= 21 or cap < 0:
        raise ValueError(f"depth {depth} outside [0, 21] or cap {cap} < 0")
    c = c.contiguous()
    n = c.numel()
    if n == 0:
        raise ValueError("encode_occ_u8 of an empty code tensor")
    nwords = -(-(4 * depth + cap) // 4)
    if depth == 0:       # no level: the plain version's zero bytes
        return torch.zeros(nwords, dtype=torch.int32, device=c.device)
    tiles = -(-n // KERNEL_TILE)
    words = torch.empty(nwords, dtype=torch.int32, device=c.device)
    scratch = torch.empty(2 * tiles * depth + depth + 1, dtype=torch.int64,
                          device=c.device)
    lib = _kernels.load()
    with torch.cuda.device(c.device):
        rc = lib.octree_occ_u8_launch(c.data_ptr(), n, depth, cap,
                                      words.data_ptr(), nwords,
                                      scratch.data_ptr(), _kernels.stream(c))
    _kernels.launched("octree_occ_u8", rc, 2)   # two grid passes
    return words


def encode_occ_u8(leaf_codes_sorted: torch.Tensor, depth: int, cap: int):
    """Level-major occupancy bytes of a sorted code tensor (duplicates
    allowed; they collapse at the leaf level): reference
    ``encode_occ_u8`` (ops/octree.py:417-481) with ``_min_levels``.

    Returns ``(occ_u8 (cap,), counts (depth,) int32)``; only the first
    ``counts.sum()`` bytes are meaningful.  Slots at or past ``cap`` are
    dropped while the counts stay whole, so an undersized ``cap`` shows
    as ``counts.sum() > cap`` and the caller retries larger.  At depth 21
    the octants come from the int64 code, so the bytes are
    ``build_levels_np``'s (the reference's bit-30 split overflows there).

    A CUDA tensor launches the kernel ``octree_occ_u8`` (two grid
    passes) or raises; a CPU tensor runs ``encode_occ_u8_ref``.
    """
    c = leaf_codes_sorted
    if not _kernels.on_card(c):
        return encode_occ_u8_ref(c, depth, cap)
    words = _occ_u8_words(c, depth, cap)
    occ = words.view(torch.uint8)[4 * depth:4 * depth + cap]
    return occ, words[:depth]


def encode_occ_u8_hdr(leaf_codes_sorted: torch.Tensor, depth: int,
                      cap: int) -> torch.Tensor:
    """``encode_occ_u8`` with the per-level counts in the buffer head, so
    the host reads one buffer per slice.  Returns a (4*depth + cap,) uint8
    tensor: depth little-endian uint32 node counts, then the level-major
    occupancy bytes (reference ``encode_occ_u8_hdr``, ops/octree.py:564).
    A CUDA tensor launches ``octree_occ_u8`` (which writes the counts
    itself) or raises; a CPU tensor runs ``encode_occ_u8_hdr_ref``."""
    c = leaf_codes_sorted
    if not _kernels.on_card(c):
        return encode_occ_u8_hdr_ref(c, depth, cap)
    return _occ_u8_words(c, depth, cap).view(torch.uint8)[:4 * depth + cap]


# ---- the kernel's algorithm in plain torch (tests only) ----------------

def _msb_mirror(x: torch.Tensor) -> torch.Tensor:
    """63 - __clzll(x) of int64 x read as unsigned, -1 for 0: a binary
    search over halves (torch has no clz)."""
    y = torch.where(x < 0, 0, x)
    hb = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = (y >> s) != 0
        hb = hb + torch.where(big, s, 0)
        y = torch.where(big, y >> s, y)
    hb = torch.where(x == 0, -1, hb)
    return torch.where(x < 0, 63, hb)


def first_level_mirror(c: torch.Tensor, depth: int) -> torch.Tensor:
    """The kernel's ``first_level``: 0 for point 0, depth + 1 for a
    duplicate, else max(depth - msb(c[i] ^ c[i-1]) // 3, 1)."""
    x = c ^ torch.cat([c[:1] ^ -1, c[:-1]])
    lv = torch.clamp(depth - torch.div(_msb_mirror(x), 3,
                                       rounding_mode="floor"), min=1)
    lv = torch.where(x == 0, depth + 1, lv)
    lv[:1] = 0
    return lv


def occ_u8_mirror(c: torch.Tensor, depth: int, cap: int,
                  tile: int = KERNEL_TILE):
    """``octree_occ_u8``'s two passes in plain torch: per tile the number
    of points first at a level <= l, the tiles' exclusive prefixes and
    the totals (the last CTA's scan), then each point's rank within its
    tile (the ballots) plus its tile's prefix, and the octant bit ORed
    into its node's byte where the slot is below ``cap``.  Returns
    (occ (cap,) uint8, counts (depth,) int32)."""
    n = c.shape[0]
    lv = first_level_mirror(c, depth)
    tiles = -(-n // tile)
    pad = torch.full((tiles * tile,), depth + 2, dtype=torch.int64)
    pad[:n] = lv
    lvec = torch.arange(depth, dtype=torch.int64)[:, None, None]
    first = (pad.view(tiles, tile)[None] <= lvec).to(torch.int64)
    tile_cnt = first.sum(dim=2)                          # (depth, tiles)
    tile_excl = torch.zeros_like(tile_cnt)
    for t in range(1, tiles):                            # the scan
        tile_excl[:, t] = tile_excl[:, t - 1] + tile_cnt[:, t - 1]
    total = tile_excl[:, -1] + tile_cnt[:, -1]
    offs = torch.cumsum(total, 0) - total
    seg = (tile_excl[:, :, None] + torch.cumsum(first, dim=2) - 1) \
        .reshape(depth, -1)[:, :n]
    occ = torch.zeros(cap, dtype=torch.int64)
    for l in range(depth):
        mine = lv <= l + 1
        dest = offs[l] + seg[l]
        put = mine & (dest < cap)
        octant = (c >> (3 * (depth - 1 - l))) & 7
        bits = torch.bitwise_left_shift(1, octant)
        for d, b in zip(dest[put].tolist(), bits[put].tolist()):
            occ[d] |= b
    return occ.to(torch.uint8), total.to(torch.int32)


def _analysis_buffers(depth: int, n: int, dev) -> dict:
    """The zeroed (depth, N) outputs of the encoder analyses."""
    return {"occ": torch.zeros(depth, n, dtype=torch.int32, device=dev),
            "ctx_base": torch.zeros(depth, n, dtype=torch.int32, device=dev),
            "node_mask": torch.zeros(depth, n, dtype=torch.bool, device=dev),
            "node_code": torch.zeros(depth, n, dtype=torch.int64, device=dev)}


def _level_segments(c: torch.Tensor, depth: int, l: int,
                    true1: torch.Tensor):
    """Level ``l``'s nodes over the sorted codes ``c``: (cl, first,
    occ_rows) with cl the level-l code of each point, first whether the
    point opens its node, occ_rows its node's occupancy byte (int64).  A
    node's byte is the sum of ``1 << octant`` over the first point of each
    of its children, so add == or even with duplicate points."""
    shift_node = 3 * (depth - l)
    cl = c >> shift_node                      # level-l code per point
    first = torch.cat([true1, cl[1:] != cl[:-1]])
    seg = torch.cumsum(first, dim=0) - 1      # node id per point
    cc = c >> (shift_node - 3)                # level-(l+1) code
    child_first = torch.cat([true1, cc[1:] != cc[:-1]])
    contrib = torch.where(child_first,
                          torch.bitwise_left_shift(1, cc & 7), 0)
    occ = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    occ.index_add_(0, seg, contrib)
    return cl, first, occ[seg]


def encode_analysis(leaf_codes_sorted: torch.Tensor, depth: int,
                    mode: int = CTX_MODE_NEIGH):
    """Full-depth encoder analysis (reference ``encode_analysis_jax``,
    ops/octree.py:217-295; the ``_jax`` suffix is dropped).

    Input: (N,) sorted leaf Morton codes (duplicates allowed; they
    collapse at the leaf level).  Output: dict of stacked per-level
    tensors, each (depth, N), masked by ``node_mask``:

      node_mask[l, i] — row i is the first point of a level-l node,
      occ[l, i]       — that node's occupancy byte (int32),
      ctx_base[l, i]  — its context base in ``mode`` (int32),
      node_code[l, i] — the level-l code of point i (int64).

    A Python loop over the levels of int64 torch ops (``_level_segments``).
    """
    c = leaf_codes_sorted
    n = c.shape[0]
    dev = c.device
    out = _analysis_buffers(depth, n, dev)
    if n == 0:
        return out
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    offsets = torch.as_tensor(_FACE_OFFSETS, device=dev)
    bit6 = torch.bitwise_left_shift(
        1, torch.arange(6, dtype=torch.int64, device=dev))
    prev_occ_rows = torch.zeros(n, dtype=torch.int64, device=dev)
    for l in range(depth):
        cl, first, occ_rows = _level_segments(c, depth, l, true1)
        if mode == CTX_MODE_NEIGH:
            pos = morton.decode(cl)                           # (N,3)
            q = pos[:, None, :] + offsets[None, :, :]         # (N,6,3)
            valid = ((q >= 0) & (q < (1 << l))).all(dim=-1)   # (N,6)
            ncode = morton.encode(q)                          # (N,6)
            idx = torch.searchsorted(cl, ncode.reshape(-1))
            idx = idx.clamp_(max=n - 1).reshape(n, 6)
            hit = valid & (cl[idx] == ncode)
            pat = (hit.to(torch.int64) * bit6).sum(dim=1)
            base = pat | ((cl & 7) << 6)
        else:
            base = ((cl & 7) << 8) | prev_occ_rows

        out["occ"][l] = torch.where(first, occ_rows, 0)
        out["ctx_base"][l] = torch.where(first, base, 0)
        out["node_mask"][l] = first
        out["node_code"][l] = cl
        prev_occ_rows = occ_rows
    return out


def encode_analysis_inter(leaf_codes_sorted: torch.Tensor, depth: int,
                          ref_codes_sorted: torch.Tensor, ref_count):
    """Inter-frame encoder analysis (reference
    ``encode_analysis_inter_jax``, ops/octree.py:298-365): the per-level
    occupancy of ``encode_analysis`` with predOcc contexts from a
    motion-compensated reference, ``ctx_base = (child_octant << 8) |
    pred_byte`` (``pred_occupancy_np`` is its numpy spec).

    ref_codes_sorted: (M,) sorted reference leaf codes on the same
    device, padded past ``ref_count`` (an int or a 0-d tensor) with
    INT64_MAX so padded slots never match.  Bit j of a node's pred byte
    is set iff its child j is among the reference's level-(l+1) codes,
    found by ``searchsorted`` of the 8 child queries.  Same output dict
    as ``encode_analysis``.
    """
    c = leaf_codes_sorted
    r = ref_codes_sorted
    n = c.shape[0]
    m = r.shape[0]
    dev = c.device
    out = _analysis_buffers(depth, n, dev)
    if n == 0:
        return out
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    octants = torch.arange(8, dtype=torch.int64, device=dev)
    bit8 = torch.bitwise_left_shift(1, octants)
    ref_count = torch.as_tensor(ref_count, dtype=torch.int64, device=dev)
    for l in range(depth):
        cl, first, occ_rows = _level_segments(c, depth, l, true1)
        # reference children at level l+1 (a shift keeps them sorted)
        rl = r >> (3 * (depth - l) - 3)
        queries = ((cl[:, None] << 3) | octants).reshape(-1)
        idx = torch.searchsorted(rl, queries).clamp_(max=m - 1)
        hit = ((rl[idx] == queries) & (idx < ref_count)).reshape(n, 8)
        pred = (hit.to(torch.int64) * bit8).sum(dim=1)
        base = ((cl & 7) << 8) | pred
        out["occ"][l] = torch.where(first, occ_rows, 0)
        out["ctx_base"][l] = torch.where(first, base, 0)
        out["node_mask"][l] = first
        out["node_code"][l] = cl
    return out


def encode_analysis_packed(leaf_codes_sorted: torch.Tensor, depth: int,
                           mode: int = CTX_MODE_NEIGH):
    """``encode_analysis`` compacted on the device (reference
    ``encode_analysis_packed``, ops/octree.py:368-394): each node's
    (ctx_base, occ) packed as ``base << 8 | occ`` in one int32.

    Returns (compact (total,) int32 in (level, node) order, counts
    (depth,) int32 nodes per level).  The reference's stable argsort of
    ~mask becomes a boolean-mask select in row-major (level, row) order,
    the same order; unlike the reference's (depth*N,) buffer, only the
    valid entries are returned, so the select waits for the device.
    """
    res = encode_analysis(leaf_codes_sorted, depth, mode)
    packed = (res["ctx_base"] << 8) | res["occ"]
    mask = res["node_mask"]
    compact = packed.reshape(-1)[mask.reshape(-1)]
    return compact, mask.sum(dim=1).to(torch.int32)


@functools.cache
def occ_code_tables():
    """(lens (256,) int32, rev_codes (256,) int64) of the static link
    code (reference ``_occ_code_tables``, ops/octree.py:484-506), read
    from the port's native library (native/occ_code.inc).  Codes are
    bit-reversed for LSB-first emission into little-endian uint32
    words."""
    import ctypes

    from ..bitstream import entropy
    if entropy._LIB is None:
        raise RuntimeError("the native entropy library is not loaded: the "
                           "link code table lives there")
    lens = np.zeros(256, dtype=np.uint8)
    codes = np.zeros(256, dtype=np.uint16)
    entropy._LIB.occ_huff_table(
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    rev = np.zeros(256, dtype=np.int64)
    for s in range(256):
        ln, code = int(lens[s]), int(codes[s])
        for b in range(ln):
            rev[s] |= ((code >> (ln - 1 - b)) & 1) << b
    return lens.astype(np.int32), rev


def encode_occ_packed_hdr(leaf_codes_sorted: torch.Tensor, depth: int,
                          cap: int, cap_packed: int) -> torch.Tensor:
    """``encode_occ_u8`` + on-device link compression (reference
    ``encode_occ_packed_hdr``, ops/octree.py:509-561).

    The level-major occupancy bytes go through the static prefix code
    packed LSB-first into little-endian uint32 words: per-symbol bit
    offsets by cumsum, each code added into its word as disjoint (lo, hi)
    bit halves, so ``index_add_`` on int64 is an OR.  Word slots at or
    past ``cap_packed // 4`` are dropped, as the reference's
    ``segment_sum`` drops them.

    Returns a (4*depth + 4 + 4*(cap_packed//4),) uint8 tensor:
    [depth uint32 node counts | uint32 total_bits | packed words].  If
    total_bits > 8*cap_packed - 24 the packed region is invalid (the
    native unpacker reads 2 bytes ahead) and the caller takes the raw
    link for this slice.  Built on ``encode_occ_u8``, so at depth 21 it
    follows ``build_levels_np``, not the JAX kernel.
    """
    dev = leaf_codes_sorted.device
    lens_np, rev_np = occ_code_tables()
    occ, counts = encode_occ_u8(leaf_codes_sorted, depth, cap)
    total = counts.to(torch.int64).sum()
    mask = torch.arange(cap, dtype=torch.int64, device=dev) < total
    sym = occ.to(torch.int64)
    lens = torch.where(mask, torch.as_tensor(lens_np, device=dev)
                       .to(torch.int64)[sym], 0)
    offs = torch.cumsum(lens, dim=0) - lens
    rev = torch.where(mask, torch.as_tensor(rev_np, device=dev)[sym], 0)
    word = offs >> 5
    bit = offs & 31
    lo = (rev << bit) & 0xFFFFFFFF
    hi = rev >> (32 - bit)
    nwords = cap_packed // 4
    acc = torch.zeros(nwords + 1, dtype=torch.int64, device=dev)
    keep_lo = word <= nwords
    keep_hi = word + 1 <= nwords
    acc.index_add_(0, torch.where(keep_lo, word, 0),
                   torch.where(keep_lo, lo, 0))
    acc.index_add_(0, torch.where(keep_hi, word + 1, 0),
                   torch.where(keep_hi, hi, 0))
    total_bits = lens.sum().reshape(1)
    return torch.cat([_u32_le_bytes(counts), _u32_le_bytes(total_bits),
                      _u32_le_bytes(acc[:nwords])])


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


def _expand_level_ref(nodes: torch.Tensor, occ: torch.Tensor, nmax: int,
                      nth_bit: torch.Tensor = None,
                      popcnt: torch.Tensor = None):
    """Plain version of ``_expand_level``: one decoder level, node codes
    + occupancy bytes -> child codes.

    Gather form (reference ``_expand_level``, ops/octree.py:601-628):
    output slot k takes its parent row j_k — the row whose inclusive
    popcount cumsum first exceeds k (``searchsorted``, the sync-free
    counterpart of ``jnp.repeat(..., total_repeat_length=nmax)``) — and
    its child bit from the nth-set-bit table at rank k - start[j_k].

    occ must be zero past the node count.  Returns (child codes (nmax,)
    int64 padded with INT64_MAX, child count as a 0-d int64 tensor,
    source row of each child slot (nmax,) int64 — the rANS decoder reads
    the parent's byte through it).  The tables are built here when not
    given.
    """
    if nth_bit is None:
        nth_bit = _nth_set_bit_table(nodes.device)
    if popcnt is None:
        popcnt = _popcount8_table(nodes.device)
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
    return out, new_cnt, src


def decode_expand_stream_ref(occ_u8: torch.Tensor, counts: torch.Tensor,
                             depth: int, nmax: int):
    """Plain version of ``decode_expand_stream``: decoder expansion from
    the level-major occupancy byte stream (the layout the host entropy
    stage produces).

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
        nodes, cnt, _ = _expand_level_ref(nodes, occ, nmax, nth_bit,
                                          popcnt)
    return nodes, cnt


# rows a round of the expansion, one a lane (csrc/octree_levels.cu:
# kXThreads), and the rounds a CTA of the counting launch counts
# (kXRounds)
EXPAND_ROUND = 256
EXPAND_COUNT_ROUNDS = 8


def _expand_scratch(levels: int, nrows: int, device) -> torch.Tensor:
    rounds = -(-nrows // EXPAND_ROUND)
    tiles = -(-rounds // EXPAND_COUNT_ROUNDS)
    return torch.empty(3 * levels + levels * (rounds + 2 * tiles),
                       dtype=torch.int64, device=device)


def _expand_launch(lib, occ, counts, levels, nrows, scratch, tot, stream):
    """The counting pass of ``levels`` levels (all of a stream's levels at
    once when ``counts`` is given, else the one level of ``occ``)."""
    rc = lib.octree_expand_count_launch(
        occ.data_ptr(), occ.numel(),
        counts.data_ptr() if counts is not None else None, levels, nrows,
        scratch.data_ptr(), tot.data_ptr(), stream)
    _kernels.launched("octree_expand", rc)


def _expand_level_launch(lib, occ, counts, levels, l, nrows, scratch, tot,
                         prev, prev_rows, out, src, final, stream):
    rc = lib.octree_expand_level_launch(
        occ.data_ptr(), occ.numel(),
        counts.data_ptr() if counts is not None else None, levels, l,
        nrows, scratch.data_ptr(), tot.data_ptr(),
        prev.data_ptr() if prev is not None else None, prev_rows,
        out.data_ptr(), src.data_ptr() if src is not None else None,
        int(final), stream)
    _kernels.launched("octree_expand", rc)


def _expand_level(nodes: torch.Tensor, occ: torch.Tensor, nmax: int,
                  nth_bit: torch.Tensor = None, popcnt: torch.Tensor = None):
    """One decoder level: node codes + occupancy bytes -> child codes
    (reference ``_expand_level``, ops/octree.py:601-628).

    nodes (nmax,) int64; occ (nmax,) occupancy bytes (any integer
    type, values 0-255), zero past the node count.  Returns (child codes
    (nmax,) int64 padded with INT64_MAX, child count as a 0-d int64
    tensor, source row of each child slot (nmax,) int64, nmax - 1 on
    padding rows).  A CUDA tensor launches ``octree_expand`` (its
    counting pass, then the level with its padding) or raises; a CPU
    tensor runs ``_expand_level_ref`` (which reads ``nth_bit`` and
    ``popcnt``; the kernel needs no tables).
    """
    if not _kernels.on_card(nodes):
        return _expand_level_ref(nodes, occ, nmax, nth_bit, popcnt)
    if nodes.dtype != torch.int64 or tuple(nodes.shape) != (nmax,) \
            or occ.shape != (nmax,) or occ.device != nodes.device:
        raise ValueError(f"need (nmax,) int64 nodes and (nmax,) occupancy "
                         f"bytes on one device, got {nodes.dtype} "
                         f"{tuple(nodes.shape)} and {tuple(occ.shape)} on "
                         f"{occ.device}")
    if occ.dtype != torch.uint8:       # the kernel reads bytes
        occ = occ.to(torch.uint8)
    dev = nodes.device
    nodes, occ = nodes.contiguous(), occ.contiguous()
    out = torch.empty(nmax, dtype=torch.int64, device=dev)
    src = torch.empty(nmax, dtype=torch.int64, device=dev)
    tot = torch.empty(1, dtype=torch.int64, device=dev)
    scratch = _expand_scratch(1, nmax, dev)
    lib = _kernels.load()
    stream = _kernels.stream(nodes)
    with torch.cuda.device(dev):
        _expand_launch(lib, occ, None, 1, nmax, scratch, tot, stream)
        _expand_level_launch(lib, occ, None, 1, 0, nmax, scratch, tot,
                             nodes, nmax, out, src, True, stream)
    return out, tot[0], src


def decode_expand_stream(occ_u8: torch.Tensor, counts: torch.Tensor,
                         depth: int, nmax: int):
    """Decoder expansion from the level-major occupancy byte stream (the
    layout the host entropy stage produces; reference
    ``decode_expand_stream``, ops/octree.py:631-659).

    occ_u8: (cap,) uint8 (padding past counts.sum() ignored); counts:
    (depth,) per-level node counts on the same device (the kernel reads
    int32; another type is converted); nmax: leaf capacity.  Returns
    (codes (nmax,) int64 padded with INT64_MAX, leaf count as a 0-d
    tensor).

    A CUDA tensor launches ``octree_expand`` or raises: a counting launch
    over every level's bytes, then a launch a level, each reading its
    bytes straight from ``occ_u8`` at the level's offset, the first from
    the root (code 0), the intermediate levels into two ping-pong buffers
    (the returned one and one more) with no padding, the last padding its
    buffer.  A CPU tensor runs ``decode_expand_stream_ref``.
    """
    if not _kernels.on_card(occ_u8):
        return decode_expand_stream_ref(occ_u8, counts, depth, nmax)
    dev = occ_u8.device
    if occ_u8.dtype != torch.uint8 or occ_u8.dim() != 1 \
            or counts.device != dev or counts.numel() != depth:
        raise ValueError(f"need (cap,) uint8 bytes and (depth,) counts on "
                         f"one device, got {occ_u8.dtype} "
                         f"{tuple(occ_u8.shape)} and {tuple(counts.shape)} "
                         f"on {counts.device}")
    if depth == 0:
        nodes = torch.full((nmax,), I64_MAX, dtype=torch.int64, device=dev)
        nodes[0] = 0
        return nodes, torch.ones((), dtype=torch.int64, device=dev)
    if counts.dtype != torch.int32:
        counts = counts.to(torch.int32)
    occ_u8, counts = occ_u8.contiguous(), counts.contiguous()
    scratch = _expand_scratch(depth, nmax, dev)
    tot = torch.empty(depth, dtype=torch.int64, device=dev)
    out = torch.empty(nmax, dtype=torch.int64, device=dev)
    tmp = torch.empty(nmax, dtype=torch.int64, device=dev) \
        if depth > 1 else None
    lib = _kernels.load()
    stream = _kernels.stream(occ_u8)
    with torch.cuda.device(dev):
        _expand_launch(lib, occ_u8, counts, depth, nmax, scratch, tot,
                       stream)
        for l in range(depth):
            # level l writes `out` when depth - 1 - l is even: the last
            # level does, and each reads the other buffer
            dst, prev = (out, tmp) if (depth - 1 - l) % 2 == 0 else \
                (tmp, out)
            _expand_level_launch(lib, occ_u8, counts, depth, l, nmax,
                                 scratch, tot, prev if l else None,
                                 -1 if l else 0, dst, None,
                                 l == depth - 1, stream)
    return out, tot[depth - 1]


def expand_chain_probe(nrows: int, device) -> None:
    """One link of the expansion's level chain, alone: an empty kernel on
    the level launches' grid for ``nrows`` rows (time it captured in a
    CUDA graph).  Counts nothing: a probe, not a launch of the main
    path."""
    lib = _kernels.load()
    with torch.cuda.device(device):
        rc = lib.octree_expand_chain_probe_launch(
            nrows, torch.cuda.current_stream(device).cuda_stream)
    _kernels.launched("octree_expand_chain_probe", rc, 0)


def _expand_rows_mirror(b, nodes, r0, start, nmax, out, src):
    """One round of the kernel: rows r0.. with bytes b and parent codes
    nodes, one a lane; the block scan of their popcounts places each
    node's children (lowest set bit first) in the round's run, stored
    from slot ``start`` on, slots >= nmax dropped.  Returns the next
    round's first slot."""
    pops = _popcount8_table(b.device)[b]
    e = torch.cumsum(pops, 0) - pops
    run = int(pops.sum())
    codes = torch.empty(run, dtype=torch.int64)
    rows = torch.empty(run, dtype=torch.int64)
    left = b.clone()
    up = torch.bitwise_left_shift(nodes, 3)
    r = r0 + torch.arange(b.numel(), dtype=torch.int64)
    for k in range(8):                   # the k-th set bit of each node
        has = pops > k
        low = left & -left
        codes[e[has] + k] = up[has] | _msb_mirror(low)[has]
        rows[e[has] + k] = r[has]
        left = left & (left - 1)
    slots = start + torch.arange(run, dtype=torch.int64)
    keep = slots < nmax
    out[slots[keep]] = codes[keep]
    if src is not None:
        src[slots[keep]] = rows[keep]
    return start + run


def _expand_rounds_mirror(occ_rows, node_of, nmax, out, src, threads):
    """One level over its rows' bytes ``occ_rows`` (int64): the counting
    launch (per tile of ``EXPAND_COUNT_ROUNDS`` rounds of ``threads``
    rows each round's children, their exclusive prefix within the tile,
    the tile's sum; its last CTA's exclusive scan of the tiles), then
    each round (``node_of(r)``: the parent codes of rows r) from its
    tile's prefix plus its own.  Returns the level's child count (not
    clamped)."""
    rows = occ_rows.numel()
    pops = _popcount8_table(occ_rows.device)[occ_rows]
    starts = list(range(0, rows, threads))
    sums = torch.stack([pops[r0:r0 + threads].sum() for r0 in starts]) \
        if starts else torch.zeros(0, dtype=torch.int64)
    k = EXPAND_COUNT_ROUNDS
    pre = torch.cat([torch.cumsum(sums[t:t + k], 0) - sums[t:t + k]
                     for t in range(0, sums.numel(), k)]) \
        if starts else sums
    tile_sum = torch.stack([sums[t:t + k].sum()
                            for t in range(0, sums.numel(), k)]) \
        if starts else sums
    tile_excl = torch.cumsum(tile_sum, 0) - tile_sum
    for i, r0 in enumerate(starts):
        r = torch.arange(r0, min(r0 + threads, rows), dtype=torch.int64)
        _expand_rows_mirror(occ_rows[r], node_of(r), r0,
                            int(tile_excl[i // k] + pre[i]), nmax, out, src)
    return int(sums.sum())


def _pad_mirror(out, src, total, nmax):
    out[total:] = I64_MAX
    if src is not None:
        src[total:] = nmax - 1


# what an output row holds before a kernel writes it (torch.empty): a
# value no code takes, so a mirror that read it would show
_UNWRITTEN = -0x5A5A5A5A5A5A5A5B


def expand_level_mirror(nodes: torch.Tensor, occ: torch.Tensor, nmax: int,
                        threads: int = EXPAND_ROUND):
    """``octree_expand``'s algorithm for one level (``_expand_level``'s
    form) in plain torch: the children of each round of ``threads`` rows
    and their prefixes, then each round (lane i takes row base + i), its
    children stored contiguously from its prefix, then the final padding.
    Same outputs as ``_expand_level_ref``."""
    occ64 = occ.to(torch.int64) & 0xFF
    out = torch.full((nmax,), _UNWRITTEN, dtype=torch.int64)
    src = torch.full((nmax,), _UNWRITTEN, dtype=torch.int64)
    total = _expand_rounds_mirror(occ64, lambda r: nodes[r], nmax, out, src,
                                  threads)
    _pad_mirror(out, src, total, nmax)
    return out, torch.tensor(total, dtype=torch.int64), src


def expand_stream_mirror(occ_u8: torch.Tensor, counts: torch.Tensor,
                         depth: int, nmax: int, threads: int = EXPAND_ROUND):
    """``decode_expand_stream``'s kernels in plain torch: each level's
    span (offset, rows = min(count, nmax)) of the stream, its rounds as
    ``expand_level_mirror``'s, level l writing one of two
    ping-pong buffers (the returned one when depth - 1 - l is even) and
    reading the other, rows past the level above's child count INT64_MAX
    (the root: row 0 code 0), no padding but the last level's.  The
    buffers start unwritten (``_UNWRITTEN``), so a read of a row no level
    wrote would show.  Same outputs as ``decode_expand_stream_ref``."""
    cap = occ_u8.shape[0]
    counts = [int(c) for c in counts]
    out = torch.full((nmax,), _UNWRITTEN, dtype=torch.int64)
    tmp = torch.full((nmax,), _UNWRITTEN, dtype=torch.int64)
    off, prev, prev_rows, total = 0, None, 0, 1
    for l in range(depth):
        rows = max(0, min(counts[l], nmax))
        idx = (off + torch.arange(rows, dtype=torch.int64)).clamp(max=cap - 1)
        dst = out if (depth - 1 - l) % 2 == 0 else tmp

        def node_of(r, prev=prev, prev_rows=prev_rows):
            if prev is None:
                return torch.where(r == 0, 0, I64_MAX)
            return torch.where(r < prev_rows, prev[r.clamp(max=nmax - 1)],
                               I64_MAX)
        total = _expand_rounds_mirror(occ_u8[idx].to(torch.int64), node_of,
                                      nmax, dst, None, threads)
        off += counts[l]
        prev, prev_rows = dst, min(total, nmax)
    if depth == 0:
        out[:] = I64_MAX
        out[0] = 0
        return out, torch.tensor(1, dtype=torch.int64)
    _pad_mirror(out, None, total, nmax)
    return out, torch.tensor(total, dtype=torch.int64)
