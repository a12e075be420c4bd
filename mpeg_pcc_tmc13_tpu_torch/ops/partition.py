"""Slice & tile partitioning of a frame.

Counterpart of `tmc3/partitioning.{h,cpp}`: PartitionMethod enum
(partitioning.h:49-63), `partitionByUniformGeom` (partitioning.cpp:120),
`partitionByOctreeDepth` (:400), `partitionByUniformSquare` (:176),
`partitionByNpts` (:261), `tilePartition` (:497), plus the merge/size
refinement helpers (:593-780).

Slices are the multi-chip unit (SURVEY.md §2.9): every method here
returns a list of index arrays over the frame's points; each slice is
then coded independently (and in parallel across devices).
"""

from __future__ import annotations

import enum
from typing import List

import numpy as np

from ..utils import morton


class PartitionMethod(enum.IntEnum):
    """Mirrors reference partitioning.h:49-63 / TMC3.cpp:781-788."""
    NONE = 0
    UNIFORM_GEOM = 2      # n bins along the longest bbox edge
    OCTREE_UNIFORM = 3    # octree depth d -> up to 8^d spatial cells
    UNIFORM_SQUARE = 4    # square grid in the two longest dimensions
    NPTS = 5              # equal point-count spans in Morton order


def _group_by(keys: np.ndarray) -> List[np.ndarray]:
    """Index arrays per unique key (sorted key order)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    if ks.size == 0:
        return []
    bounds = np.nonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))[0]
    return [order[a:b] for a, b in
            zip(bounds, np.append(bounds[1:], ks.size))]


def partition_none(n: int) -> List[np.ndarray]:
    return [np.arange(n)] if n else []


def partition_uniform_geom(positions: np.ndarray,
                           num_slices: int) -> List[np.ndarray]:
    """Equal-width bins along the longest bbox edge
    (reference partitionByUniformGeom, partitioning.cpp:120)."""
    p = positions.astype(np.int64)
    lo, hi = p.min(axis=0), p.max(axis=0)
    axis = int(np.argmax(hi - lo))
    span = max(int(hi[axis] - lo[axis]) + 1, 1)
    width = -(-span // max(num_slices, 1))
    keys = (p[:, axis] - lo[axis]) // width
    return _group_by(keys)


def partition_octree_depth(positions: np.ndarray,
                           depth: int) -> List[np.ndarray]:
    """Cells of the depth-d octree (reference partitionByOctreeDepth,
    partitioning.cpp:400)."""
    p = positions.astype(np.int64)
    lo = p.min(axis=0)
    span = int((p - lo).max()) + 1
    total_depth = max(int(span - 1).bit_length(), 1)
    shift = 3 * max(total_depth - depth, 0)
    keys = morton.encode(p - lo) >> shift
    return _group_by(keys)


def partition_uniform_square(positions: np.ndarray,
                             num_slices: int) -> List[np.ndarray]:
    """Square grid over the two longest axes (reference
    partitionByUniformSquare, partitioning.cpp:176)."""
    p = positions.astype(np.int64)
    lo, hi = p.min(axis=0), p.max(axis=0)
    ext = hi - lo
    axes = np.argsort(ext)[::-1][:2]
    side = max(int(np.ceil(np.sqrt(max(num_slices, 1)))), 1)
    keys = np.zeros(p.shape[0], dtype=np.int64)
    for a in axes:
        span = max(int(ext[a]) + 1, 1)
        width = -(-span // side)
        keys = keys * side + (p[:, a] - lo[a]) // width
    return _group_by(keys)


def partition_npts(positions: np.ndarray,
                   max_points: int) -> List[np.ndarray]:
    """Morton-contiguous equal spans (reference partitionByNpts,
    partitioning.cpp:261)."""
    n = positions.shape[0]
    if n == 0:
        return []
    order = np.argsort(morton.encode(positions.astype(np.int64)),
                       kind="stable")
    nslices = -(-n // max(max_points, 1))
    bounds = np.linspace(0, n, nslices + 1).astype(np.int64)
    return [order[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def enforce_slice_bounds(slices: List[np.ndarray], positions: np.ndarray,
                         max_points: int,
                         min_points: int) -> List[np.ndarray]:
    """Split oversize slices (Morton spans) and merge undersize ones
    into their predecessor (reference refinement, partitioning.cpp:
    593-780)."""
    out: List[np.ndarray] = []
    for idx in slices:
        if idx.size > max_points:
            sub = partition_npts(positions[idx], max_points)
            out.extend(idx[s] for s in sub)
        else:
            out.append(idx)
    merged: List[np.ndarray] = []
    for idx in out:
        if merged and idx.size < min_points and \
                merged[-1].size + idx.size <= max_points:
            merged[-1] = np.concatenate([merged[-1], idx])
        else:
            merged.append(idx)
    return [m for m in merged if m.size]


def partition_slices(positions: np.ndarray, method: PartitionMethod,
                     max_points: int = 1_100_000, min_points: int = 0,
                     octree_depth: int = 1,
                     num_slices: int = 0) -> List[np.ndarray]:
    n = positions.shape[0]
    if num_slices <= 0:
        num_slices = max(-(-n // max(max_points, 1)), 1)
    if method == PartitionMethod.NONE or n == 0:
        slices = partition_none(n)
    elif method == PartitionMethod.UNIFORM_GEOM:
        slices = partition_uniform_geom(positions, num_slices)
    elif method == PartitionMethod.OCTREE_UNIFORM:
        slices = partition_octree_depth(positions, octree_depth)
    elif method == PartitionMethod.UNIFORM_SQUARE:
        slices = partition_uniform_square(positions, num_slices)
    else:
        slices = partition_npts(positions, max_points)
    return enforce_slice_bounds(slices, positions, max_points, min_points)


def tile_partition(positions: np.ndarray, tile_size: int):
    """Spatial tile grid (reference tilePartition, partitioning.cpp:497).

    Returns (list of index arrays, tile inventory [(origin, size)]).
    """
    if tile_size <= 0 or positions.shape[0] == 0:
        n = positions.shape[0]
        return partition_none(n), []
    p = positions.astype(np.int64)
    lo = p.min(axis=0)
    cell = (p - lo) // tile_size
    keys = (cell[:, 0] << 42) | (cell[:, 1] << 21) | cell[:, 2]
    groups = _group_by(keys)
    inventory = []
    for g in groups:
        c = cell[g[0]]
        origin = tuple(int(v) for v in (lo + c * tile_size))
        inventory.append((origin, (tile_size,) * 3))
    return groups, inventory
