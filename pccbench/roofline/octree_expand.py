"""The decoder's expansion (``ops/octree.decode_expand_stream``: a
counting launch and one launch a level in ``csrc/octree_levels.cu``).

In: the level-major occupancy stream, one byte an occupied internal
node, and the per-level node counts (int32).  Out: the leaf codes
(int64).  The intermediate levels' codes are the implementation's and
are not counted.
"""

KERNELS = ("octree_expand_count_kernel", "octree_expand_level_kernel")


def bytes_moved(work: dict, channels: int, side: str) -> int:
    return (work["occupancy_bytes"] + 4 * work["depth"]
            + 8 * work["nodes"][0])
