"""raht_fp_group_roofline.encode: the group kernel's byte bound over its
device time in the encode sides (pccbench/roofline/raht_fp_group.py)."""

from pccbench.roofline import raht_fp_group


def read(run):
    return run.roofline(raht_fp_group, "encode")
