"""One coded group of the fixed-point RAHT closed loop
(``ops/raht_fp_device``: ``raht_fp_group_kernel`` of
``csrc/raht_fp_loop.cu``, one launch a level, the same kernel in encode
and in decode mode).

A group turns the ``mp`` parents of one level into their ``mc``
children.  It reads the parents' reconstructed means (int64, C
channels; the neighbour means are the same rows), the parents' and the
children's Morton codes and the children's weights (int64 each: the
geometry that fixes the butterflies and the 18-neighbour prediction),
and the mc - mp coded AC rows: the truth (int64) in encode, the q rows
(int64) in decode.  It writes the children's reconstruction (int64), and
in encode the q rows (int32).  The first group also codes the roots' DC.
Plan tables, handed-on means and counts are the implementation's and
are not counted.
"""

KERNELS = ("raht_fp_group_kernel",)


def group_bytes(mp: int, mc: int, channels: int, side: str,
                first: bool) -> int:
    ac = mc - mp
    moved = 8 * mp * channels + 8 * mp + 16 * mc          # means, geometry
    moved += 8 * ac * channels + 8 * mc * channels        # rows in, recon out
    if side == "encode":
        moved += 4 * ac * channels                        # q rows out
    if first:
        moved += (4 if side == "encode" else 8) * mp * channels
    return moved


def bytes_moved(work: dict, channels: int, side: str) -> int:
    nodes = work["nodes"]
    depth = work["depth"]
    return sum(group_bytes(nodes[g + 1], nodes[g], channels, side,
                           g == depth - 1)
               for g in range(depth))
