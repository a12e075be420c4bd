"""octree_expand_roofline: the expansion's byte bound over its device
time in the decode sides (pccbench/roofline/octree_expand.py)."""

from pccbench.roofline import octree_expand


def read(run):
    return run.roofline(octree_expand, "decode")
