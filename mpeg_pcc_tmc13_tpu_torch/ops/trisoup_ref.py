"""Reference-exact trisoup edge features, vectorised.

The reference's trisoup vertex coder conditions every presence flag and
position bit on two per-edge feature sets computed from the leaf-node
set only (`determineTrisoupNeighbours`,
tmc3/geometry_trisoup_decoder.cpp:261-445):

* ``neighbNodes`` — a 16-bit word per unique edge: bits 0-3 mark which
  of the four touching nodes contain the edge, bits 4-7 the nodes one
  step towards the edge-axis end, bits 8-11 the nodes one step towards
  the start, bits 13-14 the edge axis;
* ``edgePattern`` — 18 slots of previously-coded unique-edge indices
  (the colinear predecessor plus same-node edges mapped through the
  normative ``patternIndex`` tables).

This module reproduces those features as batched numpy passes — one
lexsort over the 36 segment instances per node — so the serial part of
the vertex coder is only the per-bit context evolution + arithmetic
coding (native/trisoup_ref.cc).  The scan quirks of the reference are
reproduced exactly: the instance at sorted position 0 is never scanned
(its correspondence entry stays -1), copy-only groups do not reset the
running pattern, and ties in the segment sort are broken by instance
index.

The PyTorch + CUDA port's copy of
``mpeg_pcc_tmc13_tpu/ops/trisoup_ref.py``, imports only changed.
"""

from __future__ import annotations

import numpy as np

# local edge -> (cornerA, cornerB) with corners numbered bit0=x? no:
# POS_abc means a=x,b=y,c=z multiples of W; encode corner as (x,y,z)
# 0/1 triples (geometry_trisoup.h:479 and the segment pushes at
# geometry_trisoup_encoder.cpp:428-451).
_EDGE_CORNERS = [
    ((0, 0, 0), (1, 0, 0)),   # 0: far bottom, x
    ((0, 0, 0), (0, 1, 0)),   # 1: far left, y
    ((0, 1, 0), (1, 1, 0)),   # 2: far top, x
    ((1, 0, 0), (1, 1, 0)),   # 3: far right, y
    ((0, 0, 0), (0, 0, 1)),   # 4: bottom left, z
    ((0, 1, 0), (0, 1, 1)),   # 5: top left, z
    ((1, 1, 0), (1, 1, 1)),   # 6: top right, z
    ((1, 0, 0), (1, 0, 1)),   # 7: bottom right, z
    ((0, 0, 1), (1, 0, 1)),   # 8: near bottom, x
    ((0, 0, 1), (0, 1, 1)),   # 9: near left, y
    ((0, 1, 1), (1, 1, 1)),   # 10: near top, x
    ((1, 0, 1), (1, 1, 1)),   # 11: near right, y
]

_EDGE_AXIS = np.array([0, 1, 0, 1, 2, 2, 2, 2, 0, 1, 0, 1])

# in-node mask bit (1/2/4/8) per local edge, from the push order within
# each axis group (geometry_trisoup_decoder.cpp:295-336)
_EDGE_MASK0 = np.array([1, 1, 2, 2, 1, 2, 4, 8, 4, 4, 8, 8])

# copy mask bits: low-side copies get 16<<k, high-side 256<<k where k is
# the within-group rank (same order as the in-node pushes)
_EDGE_RANK = np.array([0, 0, 1, 1, 0, 1, 2, 3, 2, 2, 3, 3])

# direction bits on in-node instances
_DIR_BITS = np.array([0, 1 << 13, 0, 1 << 13, 1 << 14, 1 << 14,
                      1 << 14, 1 << 14, 0, 1 << 13, 0, 1 << 13])

# localEdgeindex / patternIndex tables (decoder :395-422)
_LOCAL_EDGE_INDEX = np.array([
    [4,  1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [4, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [1,  5,  4,  9,  0,  8, -1, -1, -1, -1, -1],
    [0,  7,  4,  8,  2, 10,  1,  9, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [1,  0,  9,  4, -1, -1, -1, -1, -1, -1, -1],
    [3,  2,  0, 10, 11,  9,  8,  7,  5,  4, -1],
    [0,  1,  2,  8, 10,  4,  5, -1, -1, -1, -1],
    [4,  9,  1,  0, -1, -1, -1, -1, -1, -1, -1],
    [4,  0,  1, -1, -1, -1, -1, -1, -1, -1, -1],
    [5,  9,  1,  2,  8,  0, -1, -1, -1, -1, -1],
    [7,  8,  0, 10,  5,  2,  3,  9,  1, -1, -1],
])
_PATTERN_INDEX = np.array([
    [3,  4, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [3, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [2,  3,  5,  8, 15, 17, -1, -1, -1, -1, -1],
    [2,  3,  5,  8,  9, 12, 15, 17, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [1,  7, 10, 14, -1, -1, -1, -1, -1, -1, -1],
    [1,  2,  6,  9, 10, 11, 13, 14, 15, 16, -1],
    [2,  5,  8,  9, 12, 15, 17, -1, -1, -1, -1],
    [1,  4,  7, 14, -1, -1, -1, -1, -1, -1, -1],
    [1,  7, 14, -1, -1, -1, -1, -1, -1, -1, -1],
    [1,  2,  6, 14, 15, 16, -1, -1, -1, -1, -1],
    [1,  2,  6,  9, 11, 13, 14, 15, 16, -1, -1],
])


def _pack21(p):
    """The comparator's 63-bit packing (decoder :82-111)."""
    return ((p[:, 0].astype(np.int64) << 42)
            | (p[:, 1].astype(np.int64) << 21) | p[:, 2].astype(np.int64))


def trisoup_neighbours(leaves: np.ndarray, w: int):
    """determineTrisoupNeighbours, batched.

    leaves: (N,3) int node origins (must be non-negative after the
    uniform +w shift used internally).  Returns a dict with:

    * ``neighb``  (E,) uint16  — neighbour word per unique true edge
    * ``pattern`` (E,18) int32 — previously-coded edge indices
    * ``node_edge`` (N,12) int32 — unique edge index per node local
      edge (-1 impossible: every in-node edge is a true edge)
    * ``edge_axis`` (E,) uint8 and ``edge_start`` (E,3) — geometry of
      each unique edge in coding order (start includes the +w shift)
    """
    leaves = np.asarray(leaves, dtype=np.int64)
    n = leaves.shape[0]
    corners = np.array([c for pair in _EDGE_CORNERS for c in pair],
                       dtype=np.int64).reshape(12, 2, 3)

    # instance tensors: (N, 3 groups, 12 edges)
    base_start = leaves[:, None, :] + w  # posNode
    axis_unit = np.zeros((12, 3), dtype=np.int64)
    axis_unit[np.arange(12), _EDGE_AXIS] = w

    # per local edge relative start/end
    rel_s = corners[:, 0] * w           # (12,3)
    rel_e = corners[:, 1] * w

    origins = np.stack([
        np.zeros((12, 3), dtype=np.int64),   # in-node
        -axis_unit,                          # low-side copy
        axis_unit,                           # high-side copy
    ])                                       # (3,12,3)

    inst_start = (base_start[:, :, None, :] + origins[None]
                  + rel_s[None, None])       # (N,3,12,3)
    inst_end = (base_start[:, :, None, :] + origins[None]
                + rel_e[None, None])

    masks = np.stack([
        _EDGE_MASK0 | _DIR_BITS,
        16 << _EDGE_RANK,
        256 << _EDGE_RANK,
    ]).astype(np.int64)                      # (3,12)
    masks = np.broadcast_to(masks[None], (n, 3, 12))

    # reference instance index: 36*i + 12*group + local
    node_id = np.repeat(np.arange(n, dtype=np.int64), 36)
    group_id = np.tile(np.repeat(np.arange(3, dtype=np.int64), 12), n)
    local_id = np.tile(np.arange(12, dtype=np.int64), 3 * n)
    inst_index = 36 * node_id + 12 * group_id + local_id

    s = inst_start.reshape(-1, 3)
    e = inst_end.reshape(-1, 3)
    m = masks.reshape(-1)
    ks = _pack21(s)
    ke = _pack21(e)

    order = np.lexsort((inst_index, ke, ks))
    ks_o = ks[order]
    ke_o = ke[order]
    m_o = m[order]
    idx_o = inst_index[order]
    node_o = node_id[order]
    local_o = local_id[order]

    tot = order.shape[0]
    newgrp = np.empty(tot, dtype=bool)
    newgrp[0] = True
    newgrp[1:] = (ks_o[1:] != ks_o[:-1]) | (ke_o[1:] != ke_o[:-1])
    grp = np.cumsum(newgrp) - 1              # group id per sorted pos
    ngrp = int(grp[-1]) + 1

    grp_mask = np.zeros(ngrp, dtype=np.int64)
    np.bitwise_or.at(grp_mask, grp, m_o)
    true_grp = (grp_mask & 15) != 0
    # unique (coding-order) index per true group
    true_rank = np.cumsum(true_grp) - 1
    uniq_of_grp = np.where(true_grp, true_rank, -1)
    nuniq = int(true_grp.sum())

    # correspondanceUnique: instances in true groups -> group's unique
    # rank; instance at sorted position 0 is never scanned (stays -1)
    corr_sorted = uniq_of_grp[grp]
    scanned = np.ones(tot, dtype=bool)
    scanned[0] = False
    corr = np.full(tot, -1, dtype=np.int64)   # by instance index
    corr[idx_o[scanned]] = corr_sorted[scanned]
    scanpos = np.empty(tot, dtype=np.int64)
    scanpos[idx_o] = np.arange(tot)

    # close events: a true group's (neighb, pattern) are emitted when
    # the first instance of the NEXT group is scanned (or at loop end),
    # BEFORE that instance's own pattern writes.  Writes feeding true
    # group k are those at sorted positions in [close_{k-1}, close_k).
    grp_first = np.full(ngrp, tot, dtype=np.int64)
    np.minimum.at(grp_first, grp, np.arange(tot))
    # position where group g closes = first position of next group;
    # last group closes at tot
    close_pos_all = np.append(grp_first[1:], tot)
    close_pos = close_pos_all[true_grp]      # per unique edge, sorted

    # ---- potential pattern writes -------------------------------------
    w_pos = []      # sorted position of the writing instance
    w_slot = []
    w_val = []

    # colinear predecessor: high-side copy instances read the in-node
    # instance 24 indices before (same node, same local edge)
    hi = (m_o >= 256) & (m_o <= 2048) & scanned
    tgt = idx_o[hi] - 24
    val = corr[tgt]
    ok = val >= 0
    w_pos.append(np.nonzero(hi)[0][ok])
    w_slot.append(np.zeros(int(ok.sum()), dtype=np.int64))
    w_val.append(val[ok])

    # same-node writes from in-node instances
    innode = ((m_o & 4095) <= 8) & scanned
    in_pos = np.nonzero(innode)[0]
    in_node = node_o[innode]
    in_local = local_o[innode]
    for v in range(11):
        le = _LOCAL_EDGE_INDEX[in_local, v]
        pi = _PATTERN_INDEX[in_local, v]
        has = le >= 0
        tgt_idx = 36 * in_node[has] + le[has]
        val = corr[tgt_idx]
        # visibility: target scanned strictly before this instance
        vis = (val >= 0) & (scanpos[tgt_idx] < in_pos[has])
        w_pos.append(in_pos[has][vis])
        w_slot.append(pi[has][vis])
        w_val.append(val[vis])

    w_pos = np.concatenate(w_pos)
    w_slot = np.concatenate(w_slot)
    w_val = np.concatenate(w_val)

    # segment id: number of closes at positions <= write position
    seg = np.searchsorted(close_pos, w_pos, side="right")
    keep = seg < nuniq
    seg, w_pos, w_slot, w_val = (seg[keep], w_pos[keep], w_slot[keep],
                                 w_val[keep])
    # last write per (segment, slot) wins
    key = seg * 18 + w_slot
    o2 = np.lexsort((w_pos, key))
    key_s = key[o2]
    val_s = w_val[o2]
    last = np.empty(key_s.shape[0], dtype=bool)
    last[:-1] = key_s[1:] != key_s[:-1]
    if key_s.shape[0]:
        last[-1] = True
    pattern = np.full((nuniq, 18), -1, dtype=np.int32)
    pattern.reshape(-1)[key_s[last]] = val_s[last]

    neighb = grp_mask[true_grp].astype(np.uint16)

    # per-node local-edge -> unique index (segmentsPerNode.uniqueIndex)
    node_edge = np.full((n, 12), -1, dtype=np.int32)
    sel = (m_o & 4095) <= 8   # in-node instances (incl. position 0)
    node_edge[node_o[sel], local_o[sel]] = uniq_of_grp[grp[sel]].astype(
        np.int32)

    sel_first = newgrp & true_grp[grp]
    edge_start = s[order][sel_first]
    edge_axis = np.zeros(nuniq, dtype=np.uint8)
    dirbits = (grp_mask[true_grp] >> 13)
    edge_axis = dirbits.astype(np.uint8)     # 0=x,1=y,2=z

    return dict(neighb=neighb, pattern=pattern, node_edge=node_edge,
                edge_axis=edge_axis, edge_start=edge_start)
