"""Plain fixed-point RAHT: the benchmark's reference for the attribute
closed loop (``rahtFixedPoint=1``).

A frozen copy of the port's numpy spec, ``mpeg_pcc_tmc13_tpu_torch/ops/
raht_fp.py`` (3 * depth dyadic pair-merge sweeps over sorted Morton
codes, transform-domain prediction from the 19-node parent
neighbourhood every 3 sweeps, closed-loop deadzone quantisation), with
the neighbour search and tables of ``ops/raht.py`` it uses.  Every step
is an int64 add, multiply, shift or floor division, so the q rows and
the reconstruction are exact.  Two departures from the copy:

- ``forward_predicted_fp`` returns the encoder's reconstruction (Q13,
  the leaves in code order) beside emitting the q rows;
- every floor division of values goes through ``div``, so that
  ``control.py`` can run the same loop with float32 quotients.

Plain numpy: imports nothing of the port, of ``jax`` or of the JAX
package, and builds its own structure from the leaf codes.
"""

from __future__ import annotations

import numpy as np


def floordiv(a, b):
    """Exact int64 floor division (the configuration's arithmetic)."""
    return a // b


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


F = 13          # value fractional bits (Q13)
HALF = 1 << 12  # rounding constant for the final >> F
QA = 15         # butterfly / sqrt-scale coefficient bits (Q15)
QAH = 1 << 14   # rounding constant for the >> QA


def isqrt64(x: np.ndarray) -> np.ndarray:
    """floor(sqrt(x)) for int64 arrays, exact.

    Float sqrt seed + two integer corrections: for x < 2^52 the f64
    seed is within 1 of the true floor, so one correction each way
    suffices; the second round is insurance at no cost.
    """
    x = np.asarray(x, dtype=np.int64)
    y = np.sqrt(x.astype(np.float64)).astype(np.int64)
    for _ in range(2):
        y = np.where((y + 1) * (y + 1) <= x, y + 1, y)
        y = np.where(y * y > x, y - 1, y)
    return np.maximum(y, 0)


def sqrt_q15(w: np.ndarray) -> np.ndarray:
    """round-ish Q15 sqrt: isqrt(w << 30) = floor(sqrt(w) * 2^15)."""
    return isqrt64(np.asarray(w, dtype=np.int64) << 30)


def ab_q15(w1: np.ndarray, w2: np.ndarray):
    """Butterfly coefficients a = sqrt(w1/(w1+w2)), b = sqrt(w2/..)
    in Q15 (floor of the exact value, via integer isqrt)."""
    w1 = np.asarray(w1, dtype=np.int64)
    w2 = np.asarray(w2, dtype=np.int64)
    ws = w1 + w2
    a = isqrt64((w1 << 30) // ws)
    b = isqrt64((w2 << 30) // ws)
    return a, b


def quant_fp(res: np.ndarray, step_q16: int, div=floordiv) -> np.ndarray:
    """Deadzone quantiser on Q13 residuals: floor(|r|*8/step + 1/3),
    exact in integers (models/attr_raht.py _quantize law)."""
    a = np.abs(res)
    q = div(24 * a + step_q16, np.int64(3 * step_q16))
    return np.where(res < 0, -q, q)


def dequant_fp(q: np.ndarray, step_q16: int) -> np.ndarray:
    """Q13 reconstruction: round(q * step / 8), symmetric."""
    a = np.abs(q)
    d = (a * step_q16 + 4) >> 3
    return np.where(q < 0, -d, d)


def _pairs(codes: np.ndarray):
    parent = codes >> 1
    eq = np.zeros(codes.shape[0], dtype=bool)
    if codes.shape[0] > 1:
        eq[:-1] = parent[:-1] == parent[1:]
    first = eq.copy()
    second = np.zeros_like(eq)
    second[1:] = eq[:-1]
    return first, second, ~second


def merge_structure_fp(leaf_codes: np.ndarray, depth: int):
    """Sweep structure with Q15 integer butterfly coefficients."""
    codes = leaf_codes.astype(np.int64)
    w = np.ones(codes.shape[0], dtype=np.int64)
    sweeps = []
    for s in range(3 * depth):
        first, second, keep = _pairs(codes)
        a, b = ab_q15(w[first], w[second])
        sweeps.append({
            "codes": codes, "w": w,
            "first": first, "second": second, "keep": keep,
            "a": a[:, None], "b": b[:, None],
        })
        nw = w.copy()
        nw[first] += w[second]
        codes = (codes >> 1)[keep]
        w = nw[keep]
    return sweeps


def _fwd_sweeps(sweeps, lo, hi, vals):
    acs = []
    for s in range(lo, hi):
        sw = sweeps[s]
        v1 = vals[sw["first"]]
        v2 = vals[sw["second"]]
        a, b = sw["a"], sw["b"]
        dc = (a * v1 + b * v2 + QAH) >> QA
        ac = (a * v2 - b * v1 + QAH) >> QA
        nv = vals.copy()
        nv[sw["first"]] = dc
        vals = nv[sw["keep"]]
        acs.append(ac)
    return acs, vals


def _inv_sweeps(sweeps, lo, hi, coarse, acs):
    vals = coarse
    for s in range(hi - 1, lo - 1, -1):
        sw = sweeps[s]
        ac = acs[s - lo]
        expanded = np.zeros((sw["codes"].shape[0], vals.shape[1]),
                            dtype=np.int64)
        expanded[sw["keep"]] = vals
        dc = expanded[sw["first"]]
        a, b = sw["a"], sw["b"]
        expanded[sw["first"]] = (a * dc - b * ac + QAH) >> QA
        expanded[sw["second"]] = (b * dc + a * ac + QAH) >> QA
        vals = expanded
    return vals


def predict_children_fp(parent_codes, parent_dc, child_codes,
                        level_dims, parent_w, child_w,
                        grand_counts, thresholds, weights,
                        div=floordiv):
    """Integer mirror of ops/raht.py predict_children: prediction in
    the Q13 mean domain, rescaled by the child's Q15 sqrt weight."""
    pf = div(parent_dc << QA, sqrt_q15(parent_w)[:, None])  # Q13 mean
    nbr_idx, nbr_ok = _offset_neighbor_codes(parent_codes, level_dims)
    parent_counts = 1 + nbr_ok.sum(axis=1).astype(np.int64)
    enable = parent_counts >= thresholds[1]
    if grand_counts is not None:
        enable &= grand_counts >= thresholds[0]

    pv = pf[:, 0]
    nv = pf[nbr_idx, 0]
    keep = nbr_ok & (10 * nv > 2 * pv[:, None]) \
        & (10 * nv < 25 * pv[:, None])

    pc = child_codes >> 3
    nr = np.concatenate([[0], (pc[1:] != pc[:-1]).astype(np.int64)])
    pidx = np.cumsum(nr)
    cidx = (child_codes & 7).astype(np.int64)

    w_self, w_face, w_edge = weights
    wvec = np.array([w_face] * 6 + [w_edge] * 12, dtype=np.int64)
    m = parent_codes.shape[0]
    ncomp = pf.shape[1]
    s_oct = np.zeros((m, 8, ncomp), dtype=np.int64)
    w_oct = np.zeros((m, 8), dtype=np.int64)
    for j in range(len(_NBR_OFFSETS)):
        kj = keep[:, j]
        if not kj.any():
            continue
        vj = pf[nbr_idx[:, j]] * kj[:, None]
        for o in range(8):
            wjo = int(_TOUCH_TABLE[o, j] * wvec[j])
            if wjo:
                s_oct[:, o] += vj * wjo
                w_oct[:, o] += kj * wjo
    acc = pf[pidx] * w_self + s_oct[pidx, cidx]          # Q13
    wsum = (w_self + w_oct[pidx, cidx])[:, None]
    pred_mean = div(acc, wsum)                            # Q13 floor
    pred = (pred_mean * sqrt_q15(child_w)[:, None] + QAH) >> QA
    pred[~enable[pidx]] = 0
    return pred, parent_counts[pidx]


def forward_predicted_fp(leaf_codes, values, depth, step_at,
                         thresholds=(_PRED_T0, _PRED_T1),
                         weights=(_W_SELF, _W_FACE, _W_EDGE),
                         emit=None, div=floordiv):
    """Closed-loop fixed-point RAHT encode.

    step_at(component, level_tag) -> step_q16.  emit(q_rows, tag) is
    called per quantised batch in coded order (root first, then groups
    coarse->fine, sweeps fine-first in each group) — the caller codes
    them (zrow residuals).  Returns the encoder's reconstruction, (N, C)
    int64 in Q13, the leaves in code order.
    """
    sweeps = merge_structure_fp(leaf_codes, depth)
    vals = (np.asarray(values, dtype=np.int64)
            if np.asarray(values).ndim == 2
            else np.asarray(values, dtype=np.int64)[:, None]) << F
    ncomp = vals.shape[1]
    acs_true, root = _fwd_sweeps(sweeps, 0, len(sweeps), vals)

    def quant_batch(arr, tag):
        q = np.stack([quant_fp(arr[:, c], step_at(c, tag), div)
                      for c in range(ncomp)], axis=1)
        emit(q, tag)
        return np.stack([dequant_fp(q[:, c], step_at(c, tag))
                         for c in range(ncomp)], axis=1)

    n_sweeps = len(sweeps)
    recon = quant_batch(root, -1)
    grand = None
    for g in range(depth):
        g_hi = n_sweeps - 3 * g
        g_lo = g_hi - 3
        child_codes = sweeps[g_lo]["codes"]
        parent_codes = (sweeps[g_hi]["codes"] if g_hi < n_sweeps
                        else np.zeros(1, dtype=np.int64))
        parent_w = (sweeps[g_hi]["w"] if g_hi < n_sweeps
                    else np.array([leaf_codes.shape[0]],
                                  dtype=np.int64))
        pred, grand = predict_children_fp(
            parent_codes, recon, child_codes, g, parent_w,
            sweeps[g_lo]["w"], grand, thresholds, weights, div)
        acs_pred, _ = _fwd_sweeps(sweeps, g_lo, g_hi, pred)
        acs_rec = []
        for s in range(3):
            deq = quant_batch(acs_true[g_lo + s] - acs_pred[s], g)
            acs_rec.append(acs_pred[s] + deq)
        recon = _inv_sweeps(sweeps, g_lo, g_hi, recon, acs_rec)
    return recon


def inverse_predicted_fp(leaf_codes, depth, read_q, step_at, ncomp,
                         thresholds=(_PRED_T0, _PRED_T1),
                         weights=(_W_SELF, _W_FACE, _W_EDGE),
                         div=floordiv):
    """Decoder mirror; returns (N, C) integer attribute values."""
    sweeps = merge_structure_fp(leaf_codes, depth)
    n_sweeps = len(sweeps)
    n_roots = int(sweeps[-1]["keep"].sum()) if sweeps else \
        leaf_codes.shape[0]

    def dequant_batch(q, tag):
        return np.stack([dequant_fp(q[:, c], step_at(c, tag))
                         for c in range(ncomp)], axis=1)

    recon = dequant_batch(read_q(n_roots, -1), -1)
    grand = None
    for g in range(depth):
        g_hi = n_sweeps - 3 * g
        g_lo = g_hi - 3
        child_codes = sweeps[g_lo]["codes"]
        parent_codes = (sweeps[g_hi]["codes"] if g_hi < n_sweeps
                        else np.zeros(1, dtype=np.int64))
        parent_w = (sweeps[g_hi]["w"] if g_hi < n_sweeps
                    else np.array([leaf_codes.shape[0]],
                                  dtype=np.int64))
        pred, grand = predict_children_fp(
            parent_codes, recon, child_codes, g, parent_w,
            sweeps[g_lo]["w"], grand, thresholds, weights, div)
        acs_pred, _ = _fwd_sweeps(sweeps, g_lo, g_hi, pred)
        acs_rec = []
        for s in range(3):
            n_ac = int(sweeps[g_lo + s]["first"].sum())
            q = read_q(n_ac, g)
            acs_rec.append(acs_pred[s] + dequant_batch(q, g))
        recon = _inv_sweeps(sweeps, g_lo, g_hi, recon, acs_rec)
    return (recon + HALF) >> F
