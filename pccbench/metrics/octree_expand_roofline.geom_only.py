"""octree_expand_roofline.geom_only: ``octree_expand_roofline`` in the
geometry-only cells, where it moves ``frame_ms_p95``: the expansion's
byte bound over its device time in the decode sides
(pccbench/roofline/octree_expand.py)."""

from pccbench.roofline import octree_expand


def read(run):
    return run.roofline(octree_expand, "decode")
