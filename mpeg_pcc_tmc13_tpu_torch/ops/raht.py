"""Region-Adaptive Hierarchical Transform as segmented pairwise passes.

Counterpart of the reference RAHT (`tmc3/RAHT.cpp`: bottom-up
`reduceUnique/reduceLevel` RAHT.cpp:300-420, per-2x2x2-block butterflies
`fwdTransformBlock222` RAHT.cpp:672-737, driver `uraht_process`
RAHT.cpp:977).  The reference walks 2x2x2 blocks every octree level; an
octree level is exactly three dyadic Morton steps (strip bit z, then y,
then x — our codes are x<<2|y<<1|z), so the whole transform is
``3 * depth`` vectorised pair-merge sweeps over sorted codes:

* nodes sharing a parent at the current dyadic bit are *adjacent rows*
  in the sorted code array — pairing is a single shifted compare,
* the 2-point orthonormal butterfly with subtree weights (w1, w2)
    dc = ( sqrt(w1) v1 + sqrt(w2) v2) / sqrt(w1+w2)
    ac = (-sqrt(w2) v1 + sqrt(w1) v2) / sqrt(w1+w2)
  runs on all pairs of a sweep at once,
* the integer Haar variant (reference `integerHaar`, TMC3.cpp:1284) is
  the reversible pair  ac = v1 - v2 ; dc = v2 + (ac >> 1).

The decoder knows the whole merge structure from the decoded geometry
(weights = subtree point counts), so only coefficients are coded:
[root DC] then ACs from coarsest sweep to finest (a scalable order).
"""

from __future__ import annotations

from typing import List

import numpy as np


def _pair_masks(codes: np.ndarray):
    """codes strictly increasing. Returns (first_of_pair, second_of_pair,
    keep) boolean masks for merging at the lowest bit."""
    parent = codes >> 1
    n = codes.shape[0]
    eq = np.zeros(n, dtype=bool)
    if n > 1:
        eq[:-1] = parent[:-1] == parent[1:]
    first = eq.copy()
    second = np.zeros(n, dtype=bool)
    second[1:] = eq[:-1]
    keep = ~second
    return first, second, keep


def merge_structure(leaf_codes: np.ndarray, depth: int):
    """Geometry-derived transform structure (decoder & encoder share it).

    Returns a list over sweeps s = 0..3*depth-1 (fine -> coarse) of
    dicts with the sweep's input codes, weights, and pair masks.
    """
    codes = leaf_codes.astype(np.int64)
    w = np.ones(codes.shape[0], dtype=np.int64)
    sweeps = []
    for s in range(3 * depth):
        first, second, keep = _pair_masks(codes)
        w1 = w[first].astype(np.float64)
        w2 = w[second].astype(np.float64)
        rs = np.sqrt(w1 + w2)
        sweeps.append({
            "codes": codes, "w": w,
            "first": first, "second": second, "keep": keep,
            # orthonormal butterfly coefficients, cached once (used by
            # the true pass, the prediction pass and the inverse)
            "a": (np.sqrt(w1) / rs)[:, None],
            "b": (np.sqrt(w2) / rs)[:, None],
        })
        nw = w.copy()
        nw[first] += w[second]
        codes = (codes >> 1)[keep]
        w = nw[keep]
    return sweeps


def forward(leaf_codes: np.ndarray, values: np.ndarray, depth: int,
            integer_haar: bool = False):
    """values (N, C) -> coefficient array (N, C) in coded order.

    Coded order: [root DC, sweeps from coarsest to finest, ACs in row
    order within a sweep].  Float64 path returns float coefficients
    (caller quantises); Haar path returns exact integers.
    """
    sweeps = merge_structure(leaf_codes, depth)
    vals = values.astype(np.int64 if integer_haar else np.float64)
    if vals.ndim == 1:
        vals = vals[:, None]
    acs_per_sweep: List[np.ndarray] = []
    for sw in sweeps:
        first, second, keep = sw["first"], sw["second"], sw["keep"]
        v1 = vals[first]
        v2 = vals[second]
        if integer_haar:
            ac = v1 - v2
            dc = v2 + (ac >> 1)
        else:
            a, b = sw["a"], sw["b"]
            dc = a * v1 + b * v2
            ac = -b * v1 + a * v2
        nv = vals.copy()
        nv[first] = dc
        vals = nv[keep]
        acs_per_sweep.append(ac)
    root_dc = vals  # (n_roots, C); n_roots == 1 for a full tree
    out = [root_dc] + [acs_per_sweep[s] for s in
                       range(len(acs_per_sweep) - 1, -1, -1)]
    return np.concatenate(out, axis=0)


# ---- transform-domain (intra DC) prediction -------------------------
#
# Reference intraDcPred (RAHT.cpp:423, weights hls.h:439-466): each
# child of a parent block is predicted from the reconstructed mean
# attributes of the 19-node parent neighbourhood (the parent itself,
# its 6 face neighbours and its 12 edge neighbours), each neighbour
# contributing only to the child slots that touch it.  CTC weights
# (TMC3.cpp rahtPredictionWeights {9,3,1,5,2} via
# hls.h setPredictionWeights): self 9, face 3, edge 1.  Neighbours
# whose luma mean falls outside [parent/5, 2.5*parent) are rejected
# (RAHT.cpp:487-499), and whole blocks skip prediction when the
# neighbourhood is too sparse (grandparent count < threshold0, parent
# count < threshold1; RAHT.cpp:1399-1416).  Prediction runs in the
# mean domain over *reconstructed* values (closed loop) and the
# transformed prediction is subtracted from the coded ACs.

_W_SELF = 9
_W_FACE = 3
_W_EDGE = 1
_PRED_T0 = 2   # raht_prediction_threshold0 (grandparent count)
_PRED_T1 = 6   # raht_prediction_threshold1 (parent count)


# per-axis Morton bit masks (x at bits 2,5,8..., y at 1,4,7..., z at
# 0,3,6...): neighbour codes come from masked add/subtract instead of
# decode+encode round trips
_MZ = np.int64(0x1249249249249249)
_MY = np.int64(_MZ << 1)
_MX = np.int64(_MZ << 2)
_AXIS_MASK = (_MX, _MY, _MZ)
_AXIS_UNIT = (np.int64(4), np.int64(2), np.int64(1))


def _morton_inc(c, mask, unit):
    return (((c | ~mask) + unit) & mask) | (c & ~mask)


def _morton_dec(c, mask, unit):
    return (((c & mask) - unit) & mask) | (c & ~mask)


# the 18 face+edge neighbour offsets (reference neighOffset decoded to
# (dx, dy, dz) deltas; RAHT.cpp:324-326), faces first
_NBR_OFFSETS = [
    (+1, 0, 0), (-1, 0, 0), (0, +1, 0), (0, -1, 0), (0, 0, +1),
    (0, 0, -1),
    (+1, +1, 0), (+1, -1, 0), (-1, +1, 0), (-1, -1, 0),
    (+1, 0, +1), (+1, 0, -1), (-1, 0, +1), (-1, 0, -1),
    (0, +1, +1), (0, +1, -1), (0, -1, +1), (0, -1, -1),
]


def _touch_table():
    """(8, 18) bool: octant o touches neighbour offset j iff on every
    axis with d != 0 the octant sits on that side of the parent."""
    t = np.ones((8, len(_NBR_OFFSETS)), dtype=bool)
    for o in range(8):
        cb = ((o >> 2) & 1, (o >> 1) & 1, o & 1)
        for j, off in enumerate(_NBR_OFFSETS):
            for a, d in enumerate(off):
                if d > 0 and cb[a] != 1:
                    t[o, j] = False
                elif d < 0 and cb[a] != 0:
                    t[o, j] = False
    return t


_TOUCH_TABLE = _touch_table().astype(np.float64)


def _offset_neighbor_codes(parent_codes: np.ndarray, level_dims: int):
    """(M, 18) neighbour indices + hit masks for the face+edge
    offsets, via per-axis masked Morton add/sub and one batched
    binary search."""
    m = parent_codes.shape[0]
    bits = min(3 * max(level_dims, 0), 62)
    lvl_mask = np.int64((1 << bits) - 1)
    n_off = len(_NBR_OFFSETS)
    ncodes = np.empty((m, n_off), dtype=np.int64)
    valid = np.empty((m, n_off), dtype=bool)
    for j, (dx, dy, dz) in enumerate(_NBR_OFFSETS):
        c = parent_codes
        ok = np.ones(m, dtype=bool)
        for a, d in enumerate((dx, dy, dz)):
            if d == 0:
                continue
            mask, unit = _AXIS_MASK[a], _AXIS_UNIT[a]
            if d > 0:
                c = _morton_inc(c, mask, unit)
                ok &= (c & ~lvl_mask) == 0   # no carry out of level
            else:
                ok &= (c & mask) != 0        # not at low edge
                c = _morton_dec(c, mask, unit)
        ncodes[:, j] = c
        valid[:, j] = ok
    flat = ncodes.reshape(-1)
    idx = np.searchsorted(parent_codes, flat)
    idx = np.minimum(idx, m - 1)
    hit = valid.reshape(-1) & (parent_codes[idx] == flat)
    return idx.reshape(m, n_off), hit.reshape(m, n_off)


def predict_children(parent_codes: np.ndarray, parent_dc: np.ndarray,
                     child_codes: np.ndarray, level_dims: int,
                     integer: bool, parent_w: np.ndarray = None,
                     child_w: np.ndarray = None,
                     grand_counts: np.ndarray = None,
                     thresholds=( _PRED_T0, _PRED_T1),
                     weights=(_W_SELF, _W_FACE, _W_EDGE)):
    """Prediction value per child node from parent-level recon DCs.

    Orthonormal-path DCs scale with sqrt(subtree weight), so the
    prediction is formed in the MEAN domain (dc / sqrt(w), the
    reference's upconverted-attribute domain) and rescaled to the
    child's sqrt weight.  The integer-Haar DC is already a mean.

    Returns (pred, child_counts): child_counts carries each child's
    parent-neighbourhood size, which becomes the next level's
    grandparent count for the block-skip rule.
    """
    if not integer and parent_w is not None:
        parent_dc = parent_dc / np.sqrt(
            parent_w.astype(np.float64))[:, None]
    nbr_idx, nbr_ok = _offset_neighbor_codes(parent_codes, level_dims)
    m = parent_codes.shape[0]
    n = child_codes.shape[0]

    # per-parent neighbour counts (self always present)
    parent_counts = 1 + nbr_ok.sum(axis=1).astype(np.int64)
    # block-skip rule (RAHT.cpp:1399-1416)
    enable = parent_counts >= thresholds[1]
    if grand_counts is not None:
        enable &= grand_counts >= thresholds[0]

    # value-ratio outlier rejection on the luma mean
    # (RAHT.cpp:487-499: keep iff limitLow < 10*v < limitHigh)
    pv = parent_dc[:, 0]
    nv = parent_dc[nbr_idx, 0]                           # (M,18)
    keep = nbr_ok & (10 * nv > 2 * pv[:, None]) \
        & (10 * nv < 25 * pv[:, None])

    # children are sorted, so the parent index is a run counter —
    # O(N) instead of a binary search
    pc = child_codes >> 3
    nr = np.concatenate([[0], (pc[1:] != pc[:-1]).astype(np.int64)])
    pidx = np.cumsum(nr)
    cidx = (child_codes & 7).astype(np.int64)
    # per-PARENT octant sums: S[p, o, c] = sum over neighbours j that
    # octant o touches of w_j * neighbour mean.  The touch pattern
    # only depends on the octant, so the 8 sums amortise over a
    # parent's children instead of a per-child (N, 18, C) gather.
    w_self, w_face, w_edge = weights
    wvec = np.array([w_face] * 6 + [w_edge] * 12, dtype=np.float64)
    touchw = _TOUCH_TABLE * wvec[None, :]                # (8,18)
    pf = parent_dc if parent_dc.dtype == np.float64 \
        else parent_dc.astype(np.float64)
    ncomp = pf.shape[1]
    # accumulate per-parent octant sums offset by offset — peak
    # temporaries stay at (M, C) instead of a (M, 18, C) gather that
    # thrashes the cache at millions of parents
    s_oct = np.zeros((m, 8, ncomp), dtype=np.float64)
    w_oct = np.zeros((m, 8), dtype=np.float64)
    for j in range(len(_NBR_OFFSETS)):
        kj = keep[:, j]
        if not kj.any():
            continue
        vj = pf[nbr_idx[:, j]]
        vj = vj * kj[:, None]
        wk = kj.astype(np.float64)
        for o in range(8):
            wjo = touchw[o, j]
            if wjo:
                s_oct[:, o] += vj * wjo
                w_oct[:, o] += wk * wjo
    acc = pf[pidx] * w_self + s_oct[pidx, cidx]
    wsum = w_self + w_oct[pidx, cidx]
    child_counts = parent_counts[pidx]
    en = enable[pidx]
    if integer:
        wsum_i = np.round(wsum).astype(np.int64)[:, None]
        pred = (np.round(acc).astype(np.int64) + wsum_i // 2) // wsum_i
        pred[~en] = 0
        return pred, child_counts
    pred_mean = acc / wsum[:, None].astype(np.float64)
    if child_w is not None:
        pred_mean = pred_mean * np.sqrt(
            child_w.astype(np.float64))[:, None]
    pred_mean[~en] = 0.0
    return pred_mean, child_counts


def ref_mean_pyramid(ref_codes: np.ndarray, ref_values: np.ndarray,
                     depth: int, integer: bool):
    """Reference-frame mean-attribute pyramid for RAHT inter
    prediction (reference inter prediction from the ref RAHT tree,
    RAHT.cpp:805+ filter taps; we predict in the mean domain).

    ref_codes: Morton codes (any order, dups ok) of the compensated
    reference points; ref_values (M, C).  Returns list over octree
    levels l = 0..depth of (sorted node codes, mean values)."""
    order = np.argsort(ref_codes, kind="stable")
    codes = ref_codes[order]
    vals = np.asarray(ref_values, dtype=np.float64)[order]
    if vals.ndim == 1:
        vals = vals[:, None]
    out = []
    for l in range(depth + 1):
        shift = 3 * (depth - l)
        cl = codes >> shift
        keep = np.concatenate([[True], cl[1:] != cl[:-1]]) \
            if cl.size else np.zeros(0, bool)
        seg = np.cumsum(keep) - 1
        n = int(seg[-1]) + 1 if cl.size else 0
        sums = np.zeros((n, vals.shape[1]), dtype=np.float64)
        np.add.at(sums, seg, vals)
        cnt = np.bincount(seg, minlength=n)[:, None]
        mean = sums / np.maximum(cnt, 1)
        if integer:
            mean = np.round(mean).astype(np.int64)
        out.append((cl[keep], mean))
    return out


def _apply_ref_pred(pred, child_codes, ref_level, integer,
                    child_w=None):
    """Replace intra predictions with reference means where the ref
    frame occupies the same cell."""
    ref_codes, ref_mean = ref_level
    if ref_codes.size == 0:
        return pred
    idx = np.searchsorted(ref_codes, child_codes)
    idx = np.minimum(idx, ref_codes.size - 1)
    hit = ref_codes[idx] == child_codes
    if not hit.any():
        return pred
    rv = ref_mean[idx[hit]]
    if not integer and child_w is not None:
        rv = rv * np.sqrt(child_w[hit].astype(np.float64))[:, None]
    pred = pred.copy()
    pred[hit] = rv
    return pred


def _group_sweep_forward(sweeps, g_lo, g_hi, vals, integer_haar):
    """Run sweeps [g_lo, g_hi) forward on vals; returns per-sweep ACs
    and the coarse-side values."""
    acs = []
    for s in range(g_lo, g_hi):
        sw = sweeps[s]
        first, second, keep = sw["first"], sw["second"], sw["keep"]
        v1, v2 = vals[first], vals[second]
        if integer_haar:
            ac = v1 - v2
            dc = v2 + (ac >> 1)
        else:
            a, b = sw["a"], sw["b"]
            dc = a * v1 + b * v2
            ac = -b * v1 + a * v2
        nv = vals.copy()
        nv[first] = dc
        vals = nv[keep]
        acs.append(ac)
    return acs, vals


def _group_sweep_inverse(sweeps, g_lo, g_hi, coarse_vals, acs,
                         integer_haar):
    """Inverse of _group_sweep_forward: coarse values + ACs -> fine."""
    vals = coarse_vals
    for s in range(g_hi - 1, g_lo - 1, -1):
        sw = sweeps[s]
        first, second, keep = sw["first"], sw["second"], sw["keep"]
        ac = acs[s - g_lo]
        expanded = np.zeros((sw["codes"].shape[0], vals.shape[1]),
                            dtype=vals.dtype)
        expanded[keep] = vals
        dc = expanded[first]
        if integer_haar:
            v2 = dc - (ac >> 1)
            v1 = ac + v2
        else:
            a, b = sw["a"], sw["b"]
            v1 = a * dc - b * ac
            v2 = b * dc + a * ac
        expanded[first] = v1
        expanded[second] = v2
        vals = expanded
    return vals


def forward_predicted(leaf_codes: np.ndarray, values: np.ndarray,
                      depth: int, quant, dequant,
                      integer_haar: bool = False, ref_pyramid=None,
                      thresholds=(_PRED_T0, _PRED_T1),
                      weights=(_W_SELF, _W_FACE, _W_EDGE)):
    """Closed-loop RAHT with transform-domain prediction.

    quant/dequant: callables (array (M,C), level_tag) -> array, applied
    to AC residuals per group and to the root DC (level_tag = -1).
    ref_pyramid (from ref_mean_pyramid): inter prediction — reference
    means replace the intra upconverted prediction where the reference
    occupies the cell.  Returns quantised coefficients in coded order.
    """
    sweeps = merge_structure(leaf_codes, depth)
    vals = values.astype(np.int64 if integer_haar else np.float64)
    if vals.ndim == 1:
        vals = vals[:, None]

    # bottom-up: true ACs per sweep + true node values entering each
    # group's fine side (codes arrays come from sweeps)
    acs_true, root = _group_sweep_forward(
        sweeps, 0, len(sweeps), vals, integer_haar)

    n_sweeps = len(sweeps)
    q_root = quant(root, -1)
    out = [q_root]
    recon = dequant(q_root, -1)
    grand_counts = None
    # top-down by octree level groups of 3 sweeps
    for g in range(depth):
        g_hi = n_sweeps - 3 * g          # exclusive
        g_lo = g_hi - 3
        child_codes = sweeps[g_lo]["codes"]  # group's fine-side nodes
        parent_codes = (sweeps[g_hi]["codes"] if g_hi < n_sweeps
                        else np.zeros(1, dtype=np.int64))
        # prediction from recon parent DCs; parents live at octree
        # level g (grid size 2**g per axis)
        parent_w = (sweeps[g_hi]["w"] if g_hi < n_sweeps
                    else np.array([leaf_codes.shape[0]], dtype=np.int64))
        pred, grand_counts = predict_children(
            parent_codes, recon, child_codes, g, integer_haar,
            parent_w=parent_w, child_w=sweeps[g_lo]["w"],
            grand_counts=grand_counts, thresholds=thresholds,
            weights=weights)
        if ref_pyramid is not None:
            pred = _apply_ref_pred(pred, child_codes,
                                   ref_pyramid[g + 1], integer_haar,
                                   child_w=sweeps[g_lo]["w"])
        acs_pred, _ = _group_sweep_forward(
            sweeps, g_lo, g_hi, pred, integer_haar)
        acs_rec = []
        for s in range(3):
            res = acs_true[g_lo + s] - acs_pred[s]
            q = quant(res, g)
            out.append(q)
            acs_rec.append(acs_pred[s] + dequant(q, g))
        recon = _group_sweep_inverse(sweeps, g_lo, g_hi, recon, acs_rec,
                                     integer_haar)
    # coded order: root, then coarse -> fine groups, sweeps fine-first
    # within each group?  No: we appended group ACs in s order =
    # fine-to-coarse inside the group; decoder mirrors this exact order.
    return np.concatenate(out, axis=0)


def inverse_predicted(leaf_codes: np.ndarray, depth: int, read_q,
                      dequant, ncomp: int, integer_haar: bool = False,
                      ref_pyramid=None,
                      thresholds=(_PRED_T0, _PRED_T1),
                      weights=(_W_SELF, _W_FACE, _W_EDGE)):
    """Decoder mirror of forward_predicted.

    read_q(count, level_tag) -> (count, ncomp) quantised values, called
    in the same order the encoder emitted them.
    """
    sweeps = merge_structure(leaf_codes, depth)
    n_sweeps = len(sweeps)
    n_roots = int(sweeps[-1]["keep"].sum()) if sweeps else \
        leaf_codes.shape[0]
    q_root = read_q(n_roots, -1)
    recon = dequant(q_root, -1)
    grand_counts = None
    for g in range(depth):
        g_hi = n_sweeps - 3 * g
        g_lo = g_hi - 3
        child_codes = sweeps[g_lo]["codes"]
        parent_codes = (sweeps[g_hi]["codes"] if g_hi < n_sweeps
                        else np.zeros(1, dtype=np.int64))
        parent_w = (sweeps[g_hi]["w"] if g_hi < n_sweeps
                    else np.array([leaf_codes.shape[0]], dtype=np.int64))
        pred, grand_counts = predict_children(
            parent_codes, recon, child_codes, g, integer_haar,
            parent_w=parent_w, child_w=sweeps[g_lo]["w"],
            grand_counts=grand_counts, thresholds=thresholds,
            weights=weights)
        if ref_pyramid is not None:
            pred = _apply_ref_pred(pred, child_codes,
                                   ref_pyramid[g + 1], integer_haar,
                                   child_w=sweeps[g_lo]["w"])
        acs_pred, _ = _group_sweep_forward(
            sweeps, g_lo, g_hi, pred, integer_haar)
        acs_rec = []
        for s in range(3):
            n_ac = int(sweeps[g_lo + s]["first"].sum())
            q = read_q(n_ac, g)
            acs_rec.append(acs_pred[s] + dequant(q, g))
        recon = _group_sweep_inverse(sweeps, g_lo, g_hi, recon, acs_rec,
                                     integer_haar)
    return recon


def inverse(leaf_codes: np.ndarray, coeffs: np.ndarray, depth: int,
            integer_haar: bool = False):
    """Inverse transform: coefficients (coded order) -> values (N, C)."""
    sweeps = merge_structure(leaf_codes, depth)
    if coeffs.ndim == 1:
        coeffs = coeffs[:, None]
    n_roots = sweeps[-1]["keep"].sum() if sweeps else leaf_codes.shape[0]
    pos = 0
    vals = coeffs[pos:pos + n_roots].copy()
    pos += n_roots
    for s in range(len(sweeps) - 1, -1, -1):
        sw = sweeps[s]
        first, second, keep = sw["first"], sw["second"], sw["keep"]
        n_pairs = int(first.sum())
        ac = coeffs[pos:pos + n_pairs]
        pos += n_pairs
        # vals currently lives on the post-sweep (kept) rows
        expanded = np.zeros((sw["codes"].shape[0], vals.shape[1]),
                            dtype=vals.dtype)
        expanded[keep] = vals
        dc = expanded[first]
        if integer_haar:
            v2 = dc - (ac >> 1)
            v1 = ac + v2
        else:
            a, b = sw["a"], sw["b"]
            v1 = a * dc - b * ac
            v2 = b * dc + a * ac
        expanded[first] = v1
        expanded[second] = v2
        vals = expanded
    return vals
