"""The implicit QT/BT coded-axis schedule of the reference encoder: the
part of ``mpeg_pcc_tmc13_tpu/conformance/encoder.py`` this package uses
(``models.geometry_obuf`` derives its per-level axis masks from it).
Encoding tmc3-syntax streams is not ported yet.
"""

from __future__ import annotations


def qtbt_axis_list(root_size_log2, qtbt_enabled: bool,
                   max_num_qtbt_before_ot: int = 4,
                   min_qtbt_size_log2: int = 0,
                   stop_log2: int = 0,
                   angular_tweak: bool = False,
                   ang_max_v: int = 0,
                   ang_max_diff_z: int = 0):
    """Per-level coded-axis masks from the implicit QT/BT schedule
    (mkQtBtNodeSizeList + oneQtBtDecision + updateQtBtParameters,
    tmc3/geometry_octree.cpp:51-160).
    ``stop_log2`` truncates the list at the trisoup node size
    (geometry_octree_encoder.cpp:1984-1994).  With ``angular_tweak``
    the z axis is withheld from splitting per the angular QTBT rule
    (oneQtBtDecision :68-83; thresholds from TMC3.cpp:1957-1960)."""
    node = list(root_size_log2)
    max_q = max_num_qtbt_before_ot
    min_q = min_qtbt_size_log2
    maxd, mind = max(node), min(node)
    max_q = min(max_q, maxd - mind)
    min_q = min(min_q, mind)
    if maxd == mind:
        min_q = 0
    axes = []
    while any(v > stop_log2 for v in node):
        if not qtbt_enabled:
            nxt = [v - 1 for v in node]
        elif max_q or min(node) == min_q:
            m = max(node)
            nxt = [v - 1 if v == m else v for v in node]
        elif (angular_tweak and min_q >= 0 and node[2] <= ang_max_v
              and ang_max_v + ang_max_diff_z > 0):
            # angular: do not split z unless it dominates xy
            nxt = list(node)
            xy_max = max(nxt[0], nxt[1])
            for k in range(2):
                if nxt[k] == xy_max:
                    nxt[k] -= 1
            if ((min(node) <= ang_max_v
                 and nxt[2] >= xy_max + ang_max_diff_z)
                    or (xy_max >= ang_max_v + ang_max_diff_z
                        and nxt[2] >= xy_max)):
                nxt[2] -= 1
        else:
            nxt = [v - 1 for v in node]
        axes.append((4 if node[0] > nxt[0] else 0)
                    | (2 if node[1] > nxt[1] else 0)
                    | (1 if node[2] > nxt[2] else 0))
        if max_q:
            max_q -= 1
        if nxt[0] == min_q and nxt[0] == nxt[1] == nxt[2]:
            min_q = -1
        node = nxt
    return axes
